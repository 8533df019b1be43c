// Native JPEG decode + EXIF rotation + letterbox, the host-side hot path
// of the batch loader (the reference delegates this to PIL + cv2:
// megadetector/visualization/visualization_utils.py:306 load_image and
// megadetector/detection/pytorch_detector.py:1048-1062 letterbox).
// The port's copy of megadetector_tpu/native/jpeg_loader.cpp, unchanged
// in behavior; host code, built with g++ against libjpeg at first use
// (megadetector_tpu_torch/native/__init__.py).
//
// Design:
// - libjpeg decompression straight into a scanline buffer, optionally
//   using DCT scaled decode (scale_num/8) so very large images are
//   decoded near the target size instead of at full resolution
//   (performance mode; full-resolution decode is the parity default).
// - Minimal EXIF APP1 parse for the orientation tag (274); rotations
//   3 (180), 6 (90 CW), 8 (90 CCW) are applied exactly as the Python
//   loader does with PIL rotate(expand=True). Mirrored orientations
//   (2,4,5,7) return an error so the caller falls back to the Python
//   path, matching its assertion behavior.
// - Letterbox into a square canvas with the same geometry as
//   letterbox_u8 (bilinear, +-0.1 pad rounding), writing into a caller
//   -owned staging slot so a batch decodes in parallel (OpenMP) directly
//   into the pinned batch buffer.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void error_exit_handler(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

void output_message_silent(j_common_ptr) {}

// ---- Minimal EXIF orientation parse (APP1 / TIFF IFD0, tag 274) ----

uint16_t read_u16(const uint8_t* p, bool be) {
    return be ? (uint16_t)((p[0] << 8) | p[1])
              : (uint16_t)((p[1] << 8) | p[0]);
}

uint32_t read_u32(const uint8_t* p, bool be) {
    return be ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                ((uint32_t)p[2] << 8) | p[3]
              : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                ((uint32_t)p[1] << 8) | p[0];
}

int parse_exif_orientation(const uint8_t* buf, size_t len) {
    // Scan JPEG markers for APP1 "Exif\0\0"
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 0;
    size_t pos = 2;
    while (pos + 4 <= len) {
        if (buf[pos] != 0xFF) return 0;
        uint8_t marker = buf[pos + 1];
        if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
            pos += 2;
            continue;
        }
        if (marker == 0xDA) return 0;  // start of scan; no EXIF found
        size_t seg_len = ((size_t)buf[pos + 2] << 8) | buf[pos + 3];
        if (seg_len < 2 || pos + 2 + seg_len > len) return 0;
        if (marker == 0xE1 && seg_len >= 10 &&
            std::memcmp(buf + pos + 4, "Exif\0\0", 6) == 0) {
            const uint8_t* tiff = buf + pos + 10;
            size_t tiff_len = seg_len - 8;
            if (tiff_len < 8) return 0;
            bool be;
            if (tiff[0] == 'M' && tiff[1] == 'M') be = true;
            else if (tiff[0] == 'I' && tiff[1] == 'I') be = false;
            else return 0;
            uint32_t ifd0 = read_u32(tiff + 4, be);
            // Widen to size_t before adding: ifd0 comes from untrusted
            // bytes and uint32 arithmetic would wrap (0xFFFFFFFE + 2 ==
            // 0), bypassing the bounds check and reading out of bounds
            if ((size_t)ifd0 + 2 > tiff_len) return 0;
            uint16_t n_entries = read_u16(tiff + ifd0, be);
            for (uint16_t i = 0; i < n_entries; ++i) {
                size_t e = (size_t)ifd0 + 2 + (size_t)i * 12;
                if (e + 12 > tiff_len) return 0;
                uint16_t tag = read_u16(tiff + e, be);
                if (tag == 274) {
                    return read_u16(tiff + e + 8, be);
                }
            }
            return 0;
        }
        pos += 2 + seg_len;
    }
    return 0;
}

// Rotate an RGB image in place semantics: src -> dst with new dims.
void rotate_rgb(const uint8_t* src, int h, int w, int orientation,
                std::vector<uint8_t>* out, int* nh, int* nw) {
    if (orientation == 3) {  // 180
        *nh = h; *nw = w;
        out->resize((size_t)h * w * 3);
        for (int y = 0; y < h; ++y) {
            const uint8_t* s = src + (size_t)y * w * 3;
            uint8_t* d = out->data() + (size_t)(h - 1 - y) * w * 3;
            for (int x = 0; x < w; ++x) {
                const uint8_t* sp = s + (size_t)x * 3;
                uint8_t* dp = d + (size_t)(w - 1 - x) * 3;
                dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
            }
        }
    } else if (orientation == 6) {  // PIL rotate 270 (= 90 CW visually)
        *nh = w; *nw = h;
        out->resize((size_t)h * w * 3);
        for (int y = 0; y < h; ++y) {
            const uint8_t* s = src + (size_t)y * w * 3;
            for (int x = 0; x < w; ++x) {
                // dst[x][h-1-y] = src[y][x]
                uint8_t* dp = out->data() +
                    ((size_t)x * h + (h - 1 - y)) * 3;
                const uint8_t* sp = s + (size_t)x * 3;
                dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
            }
        }
    } else if (orientation == 8) {  // PIL rotate 90 (= 90 CCW visually)
        *nh = w; *nw = h;
        out->resize((size_t)h * w * 3);
        for (int y = 0; y < h; ++y) {
            const uint8_t* s = src + (size_t)y * w * 3;
            for (int x = 0; x < w; ++x) {
                // dst[w-1-x][y] = src[y][x]
                uint8_t* dp = out->data() +
                    ((size_t)(w - 1 - x) * h + y) * 3;
                const uint8_t* sp = s + (size_t)x * 3;
                dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
            }
        }
    }
}

void letterbox_into(const uint8_t* src, int h, int w,
                    uint8_t* dst, int out_h, int out_w,
                    uint8_t pad_value, int scale_target) {
    // The scale ratio derives from the SQUARE scale target when given
    // (the reference's letterbox(auto=True) computes r before padding
    // to the stride rectangle); deriving it from the rect canvas can
    // differ sub-pixel when round() shrank the non-binding side.
    const float t_h = scale_target > 0 ? (float)scale_target
                                       : (float)out_h;
    const float t_w = scale_target > 0 ? (float)scale_target
                                       : (float)out_w;
    const float r = std::min(t_h / h, t_w / w);
    // lrintf = round-half-to-even (default FP mode), matching Python's
    // int(round()) in ops/boxes.letterbox at exact .5 ties
    int new_w = (int)lrintf(w * r);
    int new_h = (int)lrintf(h * r);
    if (new_w > out_w) new_w = out_w;
    if (new_h > out_h) new_h = out_h;
    const int left =
        (int)std::floor((out_w - new_w) / 2.0f - 0.1f + 0.5f);
    const int top =
        (int)std::floor((out_h - new_h) / 2.0f - 0.1f + 0.5f);

    std::memset(dst, pad_value, (size_t)out_h * out_w * 3);

    const float sx = (float)w / new_w;
    const float sy = (float)h / new_h;

    for (int oy = 0; oy < new_h; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        fy = std::max(0.0f, std::min(fy, (float)(h - 1)));
        const int y0 = (int)fy;
        const int y1 = std::min(y0 + 1, h - 1);
        const float wy = fy - y0;
        uint8_t* out_row =
            dst + ((size_t)(top + oy) * out_w + left) * 3;
        const uint8_t* row0 = src + (size_t)y0 * w * 3;
        const uint8_t* row1 = src + (size_t)y1 * w * 3;
        for (int ox = 0; ox < new_w; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            fx = std::max(0.0f, std::min(fx, (float)(w - 1)));
            const int x0 = (int)fx;
            const int x1 = std::min(x0 + 1, w - 1);
            const float wx = fx - x0;
            for (int c = 0; c < 3; ++c) {
                const float p00 = row0[x0 * 3 + c];
                const float p01 = row0[x1 * 3 + c];
                const float p10 = row1[x0 * 3 + c];
                const float p11 = row1[x1 * 3 + c];
                const float v = p00 * (1 - wy) * (1 - wx)
                              + p01 * (1 - wy) * wx
                              + p10 * wy * (1 - wx)
                              + p11 * wy * wx;
                out_row[ox * 3 + c] = (uint8_t)(v + 0.5f);
            }
        }
    }
}

}  // namespace

extern "C" {

// Error codes
enum {
    JL_OK = 0,
    JL_DECODE_ERROR = 1,
    JL_UNSUPPORTED_ORIENTATION = 2,
    JL_NOT_RGB = 3,
};

// Decode one JPEG, apply EXIF rotation, letterbox into dst.
// dst: [canvas_h, canvas_w, 3] u8. out_dims receives the post-rotation
// (h, w) of the source (needed by scale_coords). dct_scale_target > 0
// enables scaled decode down to roughly that long side (performance
// mode; 0 = always full resolution).
int decode_jpeg_letterbox_rect(const uint8_t* buf, long len,
                               uint8_t* dst, int canvas_h, int canvas_w,
                               uint8_t pad_value, int scale_target,
                               int dct_scale_target, int* out_dims) {
    int orientation = parse_exif_orientation(buf, (size_t)len);
    if (orientation == 2 || orientation == 4 || orientation == 5 ||
        orientation == 7) {
        return JL_UNSUPPORTED_ORIENTATION;
    }

    // Buffers live before setjmp so their destructors run on the
    // error return path (declared after setjmp they would be skipped
    // by longjmp — UB plus a per-corrupt-image heap leak)
    std::vector<uint8_t> pixels;
    std::vector<uint8_t> rotated;

    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit_handler;
    jerr.pub.output_message = output_message_silent;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return JL_DECODE_ERROR;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;

    if (dct_scale_target > 0) {
        // Smallest scale_num/8 whose decode still covers the target
        int long_side = (int)std::max(cinfo.image_width,
                                      cinfo.image_height);
        for (int num = 1; num <= 8; ++num) {
            if ((long)long_side * num / 8 >= dct_scale_target) {
                cinfo.scale_num = num;
                cinfo.scale_denom = 8;
                break;
            }
        }
    }

    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return JL_NOT_RGB;
    }
    const int w = cinfo.output_width;
    const int h = cinfo.output_height;
    pixels.resize((size_t)h * w * 3);
    while ((int)cinfo.output_scanline < h) {
        uint8_t* row = pixels.data() +
            (size_t)cinfo.output_scanline * w * 3;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    const uint8_t* final_pixels = pixels.data();
    int fh = h, fw = w;
    if (orientation == 3 || orientation == 6 || orientation == 8) {
        rotate_rgb(pixels.data(), h, w, orientation, &rotated, &fh, &fw);
        final_pixels = rotated.data();
    }

    letterbox_into(final_pixels, fh, fw, dst, canvas_h, canvas_w,
                   pad_value, scale_target);
    if (out_dims != nullptr) {
        out_dims[0] = fh;
        out_dims[1] = fw;
    }
    return JL_OK;
}

// Square-canvas compatibility wrapper.
int decode_jpeg_letterbox(const uint8_t* buf, long len,
                          uint8_t* dst, int canvas, uint8_t pad_value,
                          int dct_scale_target, int* out_dims) {
    return decode_jpeg_letterbox_rect(buf, len, dst, canvas, canvas,
                                      pad_value, 0, dct_scale_target,
                                      out_dims);
}

// Decode-only variant (no letterbox): decode at the DCT scale whose
// long side covers dct_scale_target (0 = full resolution), apply EXIF
// rotation, and write the post-rotation pixels into the top-left of
// dst [buf_h, buf_w, 3] (row stride buf_w*3; remainder untouched).
// out_dims receives the post-rotation (h, w). Feeds the device-
// preprocess staging path, where the letterbox runs on the device.
int decode_jpeg_scaled(const uint8_t* buf, long len,
                       uint8_t* dst, int buf_h, int buf_w,
                       int dct_scale_target, int* out_dims) {
    int orientation = parse_exif_orientation(buf, (size_t)len);
    if (orientation == 2 || orientation == 4 || orientation == 5 ||
        orientation == 7) {
        return JL_UNSUPPORTED_ORIENTATION;
    }

    std::vector<uint8_t> pixels;
    std::vector<uint8_t> rotated;

    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit_handler;
    jerr.pub.output_message = output_message_silent;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return JL_DECODE_ERROR;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;

    if (dct_scale_target > 0) {
        int long_side = (int)std::max(cinfo.image_width,
                                      cinfo.image_height);
        for (int num = 1; num <= 8; ++num) {
            if ((long)long_side * num / 8 >= dct_scale_target) {
                cinfo.scale_num = num;
                cinfo.scale_denom = 8;
                break;
            }
        }
    }

    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return JL_NOT_RGB;
    }
    const int w = cinfo.output_width;
    const int h = cinfo.output_height;
    pixels.resize((size_t)h * w * 3);
    while ((int)cinfo.output_scanline < h) {
        uint8_t* row = pixels.data() +
            (size_t)cinfo.output_scanline * w * 3;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    const uint8_t* final_pixels = pixels.data();
    int fh = h, fw = w;
    if (orientation == 3 || orientation == 6 || orientation == 8) {
        rotate_rgb(pixels.data(), h, w, orientation, &rotated, &fh, &fw);
        final_pixels = rotated.data();
    }
    if (fh > buf_h || fw > buf_w) {
        return JL_DECODE_ERROR;  // caller sized the buffer too small
    }
    for (int y = 0; y < fh; ++y) {
        std::memcpy(dst + (size_t)y * buf_w * 3,
                    final_pixels + (size_t)y * fw * 3,
                    (size_t)fw * 3);
    }
    if (out_dims != nullptr) {
        out_dims[0] = fh;
        out_dims[1] = fw;
    }
    return JL_OK;
}

// Batch variant: decode n JPEGs in parallel straight into the staging
// buffer dst [n, canvas_h, canvas_w, 3]. bufs/lens address the encoded
// images; per-image status lands in errs[n]; per-image post-rotation
// dims in out_dims [n, 2].
void decode_jpeg_letterbox_batch_rect(
        const uint8_t** bufs, const long* lens,
        int n, uint8_t* dst, int canvas_h, int canvas_w,
        uint8_t pad_value, int scale_target, int dct_scale_target,
        int* out_dims, int* errs) {
    const size_t slot = (size_t)canvas_h * canvas_w * 3;
    #pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < n; ++i) {
        errs[i] = decode_jpeg_letterbox_rect(
            bufs[i], lens[i], dst + (size_t)i * slot, canvas_h,
            canvas_w, pad_value, scale_target, dct_scale_target,
            out_dims + (size_t)i * 2);
    }
}

void decode_jpeg_letterbox_batch(const uint8_t** bufs, const long* lens,
                                 int n, uint8_t* dst, int canvas,
                                 uint8_t pad_value, int dct_scale_target,
                                 int* out_dims, int* errs) {
    decode_jpeg_letterbox_batch_rect(bufs, lens, n, dst, canvas, canvas,
                                     pad_value, 0, dct_scale_target,
                                     out_dims, errs);
}

}  // extern "C"
