// Native host kernels of the port (its own copy of
// megadetector_tpu/native/letterbox_nms.cpp; everything from the first
// #include on is that file's, unchanged), exposed to Python via ctypes
// (see native/__init__.py):
//
//   letterbox_u8  — fused bilinear resize + gray pad + uint8 output
//                   (cv2 half-pixel convention), OpenMP-parallel rows
//   nms_xyxy      — greedy IoU suppression over score-sorted boxes
//   cluster_boxes — greedy IoU clustering (grid-hash accelerated)
//
// Host code, not a device kernel, kept for parity with the JAX package:
// no code of either package calls these functions outside native/. It
// needs only g++ and OpenMP (no libjpeg), so it builds as a library of its
// own beside the JPEG loader:
// g++ -O3 -shared -fPIC -fopenmp letterbox_nms.cpp -o libmdnative.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Fused letterbox: resize src (h x w x 3, uint8) so it fits centered in
// dst (out_h x out_w x 3, uint8), bilinear, remainder filled with
// pad_value. Geometry matches ops/boxes.letterbox(auto=False,
// scaleup=True) on a rectangular canvas.
void letterbox_u8_rect(const uint8_t* src, int h, int w,
                       uint8_t* dst, int out_h, int out_w,
                       uint8_t pad_value) {

    const float r = std::min((float)out_h / h, (float)out_w / w);
    // lrintf = round-half-to-even, matching Python's int(round())
    const int new_w = (int)lrintf(w * r);
    const int new_h = (int)lrintf(h * r);
    const int left = (int)std::floor((out_w - new_w) / 2.0f - 0.1f + 0.5f);
    const int top = (int)std::floor((out_h - new_h) / 2.0f - 0.1f + 0.5f);

    std::memset(dst, pad_value, (size_t)out_h * out_w * 3);

    const float sx = (float)w / new_w;
    const float sy = (float)h / new_h;

    #pragma omp parallel for schedule(static)
    for (int oy = 0; oy < new_h; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        if (fy > h - 1) fy = (float)(h - 1);
        const int y0 = (int)fy;
        const int y1 = std::min(y0 + 1, h - 1);
        const float wy = fy - y0;
        uint8_t* out_row = dst + ((size_t)(top + oy) * out_w + left) * 3;
        const uint8_t* row0 = src + (size_t)y0 * w * 3;
        const uint8_t* row1 = src + (size_t)y1 * w * 3;
        for (int ox = 0; ox < new_w; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            if (fx < 0) fx = 0;
            if (fx > w - 1) fx = (float)(w - 1);
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

// Square-canvas compatibility wrapper.
void letterbox_u8(const uint8_t* src, int h, int w,
                  uint8_t* dst, int out_size, uint8_t pad_value) {
    letterbox_u8_rect(src, h, w, dst, out_size, out_size, pad_value);
}

static inline float iou_xyxy(const float* a, const float* b) {
    const float ix0 = std::max(a[0], b[0]);
    const float iy0 = std::max(a[1], b[1]);
    const float ix1 = std::min(a[2], b[2]);
    const float iy1 = std::min(a[3], b[3]);
    const float iw = std::max(0.0f, ix1 - ix0);
    const float ih = std::max(0.0f, iy1 - iy0);
    const float inter = iw * ih;
    const float area_a = (a[2] - a[0]) * (a[3] - a[1]);
    const float area_b = (b[2] - b[0]) * (b[3] - b[1]);
    const float uni = area_a + area_b - inter;
    return uni > 0 ? inter / uni : 0.0f;
}

// Greedy NMS. boxes: [n,4] xyxy float32; scores: [n]. keep_out: [n]
// int32 buffer; returns the number of kept indices (score-descending).
int nms_xyxy(const float* boxes, const float* scores, int n,
             float iou_thres, int32_t* keep_out) {

    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return scores[a] > scores[b]; });

    std::vector<char> suppressed(n, 0);
    int n_keep = 0;
    for (int oi = 0; oi < n; ++oi) {
        const int i = order[oi];
        if (suppressed[i]) continue;
        keep_out[n_keep++] = i;
        const float* bi = boxes + (size_t)i * 4;
        for (int oj = oi + 1; oj < n; ++oj) {
            const int j = order[oj];
            if (suppressed[j]) continue;
            if (iou_xyxy(bi, boxes + (size_t)j * 4) > iou_thres)
                suppressed[j] = 1;
        }
    }
    return n_keep;
}

// Greedy IoU clustering for repeat-detection elimination: assigns each
// box (in input order) to the first existing cluster whose seed box
// overlaps at IoU >= threshold and shares a category (category -1 =
// agnostic); otherwise starts a new cluster seeded by this box.
// boxes: [n,4] xywh normalized; categories: [n] int32;
// cluster_out: [n] int32. Returns the number of clusters.
int cluster_boxes(const float* boxes, const int32_t* categories, int n,
                  float iou_thres, int category_agnostic,
                  int32_t* cluster_out) {

    // Grid hash over normalized space bounds the candidate set
    const float cell = 0.05f;
    const int grid_n = (int)(1.0f / cell) + 2;
    std::unordered_map<int, std::vector<int>> grid;  // cell -> seed idxs

    std::vector<float> seeds_xyxy;     // cluster seed boxes
    std::vector<int32_t> seed_cats;
    int n_clusters = 0;

    auto cell_id = [&](int cx, int cy) { return cy * grid_n + cx; };

    for (int i = 0; i < n; ++i) {
        const float x = boxes[i * 4 + 0];
        const float y = boxes[i * 4 + 1];
        const float bw = boxes[i * 4 + 2];
        const float bh = boxes[i * 4 + 3];
        float box_xyxy[4] = {x, y, x + bw, y + bh};

        const int cx0 = std::max(0, (int)(x / cell));
        const int cy0 = std::max(0, (int)(y / cell));
        const int cx1 = std::min(grid_n - 1, (int)((x + bw) / cell));
        const int cy1 = std::min(grid_n - 1, (int)((y + bh) / cell));

        int assigned = -1;
        for (int cy = cy0; cy <= cy1 && assigned < 0; ++cy) {
            for (int cx = cx0; cx <= cx1 && assigned < 0; ++cx) {
                auto it = grid.find(cell_id(cx, cy));
                if (it == grid.end()) continue;
                for (int s : it->second) {
                    if (!category_agnostic &&
                        seed_cats[s] != categories[i]) continue;
                    if (iou_xyxy(box_xyxy, seeds_xyxy.data() +
                                 (size_t)s * 4) >= iou_thres) {
                        assigned = s;
                        break;
                    }
                }
            }
        }

        if (assigned < 0) {
            assigned = n_clusters++;
            seeds_xyxy.insert(seeds_xyxy.end(), box_xyxy, box_xyxy + 4);
            seed_cats.push_back(categories[i]);
            for (int cy = cy0; cy <= cy1; ++cy)
                for (int cx = cx0; cx <= cx1; ++cx)
                    grid[cell_id(cx, cy)].push_back(assigned);
        }
        cluster_out[i] = assigned;
    }
    return n_clusters;
}

}  // extern "C"
