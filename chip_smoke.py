#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (megadetector_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: torch/CUDA versions and the card's name and power limit,
     whether cv2, pandas, tensorflow and networkx are installed; TF32 off
     so float32 is float32;
  2. build: nvcc compiles megadetector_tpu_torch/csrc/*.cu; ptxas's
     register lines, and its C7520 / C7514 lines (a kernel whose wgmma it
     serialized), are printed: the GEMM kernel must have none;
  3. kernel vs plain: the greedy-NMS kernel against its plain PyTorch
     version on the card (B=8, K in 512/2048/8192, plus a suppression
     chain, exact duplicates and invalid slots); keep masks must be
     identical; ms per call of both, and the kernel's split between its
     mask pass and its sweep (torch.profiler, by kernel name);
  4. main path: yolov5l6 (MDv5a's architecture, nc=3, full width, random
     weights from seed 0) saved as .npz, load_detector on cuda,
     load_and_run_detector_batch over 16 synthetic 4:3 and 16:9 images
     (two auto canvases, batch 8), write_results_to_file; the MD JSON is
     checked and the NMS kernel's launch count must cover every device
     batch; images/s of a timed, replayed pass;
  5. card vs CPU: the same yolov5l6 forward on a 320 px batch of 2;
     heads agree to max |d| <= 1e-3 * max |ref| (cuDNN sums in another
     order than the CPU, even with TF32 off);
  6. int8 kernels vs plain on the card, at yolov5l6 shapes of a 960x1280
     canvas, batch 8: the conv kernel on l1's 3x3 s2 64->128, a 3x3 s1
     128->128 at 120x160 and a 1x1 512->256 at 120x160 (int32 and int8
     outputs), then on the most frequent shape of each chain-conv class
     (l1; a 3x3 s1 and a 1x1 per stride level, from the model's own
     geometry), with TOP/s and the share of the bound, and every one of
     the 130 chain convs' shapes timed alone, summed per forward, under
     the tiling ops/conv_int8.conv_tiling picks and under every other
     16-byte tiling (each held to the picked one's output); the
     bottleneck kernel on every distinct bottleneck shape of a 960x1280
     and a 768x1280 batch of 8 (C 64 to 512), with and without the
     residual, against its plain version and the unfused pair of conv
     kernels (residual in torch), with kernel and unfused ms, TOP/s, the
     bound's share, the tiling bottleneck_tiling picks or 'unfused', and
     the routed sum over each canvas's 42 bottlenecks; outputs must be
     identical; ms per call of both, and of torch._int_mm on the 1x1
     int32 case (the same function: the conv kernel's library
     yardstick);
  7. int8 main path: the port's quantize_checkpoint on phase 4's
     yolov5l6 (calibrated on two 320 px uniform images from
     RandomState(1)), load_detector on cuda with conv_backend xla, then
     pallas, load_and_run_detector_batch over the same 16 images and
     write_results_to_file; the MD JSON is checked, the conv kernel must
     launch once per chain conv of each of the two batches (260) under
     xla; under pallas the bottleneck kernel once per bottleneck that
     bottleneck_tiling fuses (r = 36 of 42 a batch at both canvases) and
     the conv kernel 260 - 4 r times; the two backends' detections must
     be identical; images/s of a timed, replayed pass of each, and both
     backends' forward ms side by side;
  8. card vs CPU, int8 forward at 320 px, batch 2: decoded obj*cls
     scores p99 |d| < 0.02 and xy p99 |d| < 2 px (the bounds of the JAX
     package's int8-vs-float test);
  9. bf16 kernels vs plain on the card at yolov5l6 shapes of a 960x1280
     batch of 8: the fused stem on u8 [8,960,1280,3] -> [8,480,640,64]
     with the model's l0 weights, the bf16 epilogue (bias + SiLU) on l1's
     output [8,128,240,320] and on a [8,1024,15,20] tensor, both
     channels_last; the epilogue must be bit-identical, the stem (whose
     tensor cores sum the taps in another order) within
     ops/l0_fused.plain_bar: 1 bf16 ulp or 1e-5, on at most 1e-3 of the
     elements, with the count that differs printed; ms of kernel, plain
     version and the library yardstick (cuDNN's bf16 conv of the
     normalized batch for the stem, F.silu for the epilogue);
 10. bf16 main path: phase 4's yolov5l6 with dtype bf16 through
     load_and_run_detector_batch over the same 16 images, batch 8; the
     stem must launch once per batch and the bf16 epilogue once per
     activated conv after l0 per batch; images/s of a replayed pass and the
     forward's CUDA-event ms on one 960x1280 batch of 8;
 11. int8 with dtype bf16 under conv_backend xla and pallas: the stem once
     per batch, the int8 kernels as in phase 7, no bf16 epilogue;
 12. preprocess_mode=device, float32 and bf16: the 16 images plus one
     batch of 8 images of exactly 960x1280 (the identity path); the device
     letterbox against the host letterbox's canvas; counts (no stem: l0
     takes the letterbox's float output, so the bf16 epilogue runs for l0
     too); images/s;
 13. card vs CPU, bf16 forward at 320 px, batch 2: the int8 bounds;
 14. the int8 experiments' kernels vs plain on the card: the 3x3 conv
     (E1-E4) at batch 8 on the stride-8/16/32 levels of a 960x1280 canvas
     (120x160x128, 60x80x256, 30x40x512), every epilogue (f32,
     f32_nosilu, bf16, hybrid), in_ratio 0.8531 and 1.0, at the
     experiments' scales and at scales that spread the outputs over the
     int8 range; the GEMM (E5, E6) at 65536x1152x1152, 38400x2304x256
     and 4096x2048x2048, int32 and fused int8, with each one's tiles,
     bound and share of the bound (of its device time, replayed from a
     CUDA graph); outputs must be identical; ms of kernel, plain version
     and the yardsticks (im2col + torch._int_mm + plain epilogue, requant
     pass + B2; torch._int_mm);
 15. the six experiment entry points (megadetector_tpu_torch/experiments)
     through their main() at batch 8 with a chain of 2: every variant
     launches exactly the kernels it declares, once per step;
 16. the program cache (models/program_cache.py), after phases 4, 7 (both
     backends) and 10: on a 960x1280 batch of 8 the program eager and
     replayed from its CUDA graphs must be identical; forward and
     selection + NMS ms eager and replayed, the whole program's wall ms
     both ways, the peak device memory; after phase 4 also the host copy
     of that batch, pageable against pinned;
 17. test-time augmentation, after phase 13: augment=True over the 16
     images for float32, int8 (pallas) and bf16, launches per TTA pass
     exact, replay identical to eager, the augment program's ms against
     the plain one's, TTA on the card against the CPU at 320 px;
 18. the folder run, after phase 17: 64 JPEGs written to disk (32 at
     1536x2048, 32 at 1080x1920, quality 90) through
     load_and_run_detector_batch's loader pool with yolov5l6 at 1280 px,
     batch 8: bf16 under thread 1/4/8, process 8 and, where g++ and
     jpeglib.h exist, the native loader in thread 8 and process 8; int8
     pallas and float32 under thread 8; a capture pass, then a timed
     replayed pass per mode; images/s beside the ceiling (the replayed
     program on the letterboxed batches in memory) and the host's CPU
     count; detections identical across the PIL modes, the native
     loader's geometry equal to PIL's and its canvases within 3 levels
     (mean < 0.5) with no image handed to PIL, and a rotated, a grayscale
     and a corrupt file as on the serial path in every mode;
 19. load_and_run_detector (bf16, batch 1) on two synthetic JPEGs: results
     equal to generate_detections_one_image, a rendered file each,
     launches exact (one device program an image);
 20. run_tiled_inference on two synthetic 4000x3000 JPEGs (24 tiles of
     1280x1280 each, three full batches of 8 on the square canvas) and a
     1024x768 one run whole, bf16 and int8 pallas: launches exact, the
     JSON equal to one assembled from generate_detections_one_batch on
     tiles cut with get_patch_boundaries, remapped and deduplicated with
     in_place_nms; a run interrupted at its second image and resumed from
     its checkpoint equal to an unbroken one; tiles/s and images/s;
 21. process_videos (bf16, frame_batch_size 8) on two 1920x1080 mp4v
     videos (30 fps, 60 and 45 frames) and a corrupt file, frame_sample 4
     and time_sample 0.5: frames_processed, launches exact, each frame's
     detections equal to generate_detections_one_batch on cv2's frames,
     the corrupt video a failure record, the file valid; frames/s; then
     process_video_folder_via_frames with the same frame numbers and
     frame rates. Phases 19-21 print the reserved memory after each run.
 22. the other detector families, at full width and depth with random
     weights from seed 0 (the port's init_params, saved as .npz with the
     JAX converter's metadata): yolov8l (the MDv1000 architecture, nc 3,
     1280 px auto canvases), rfdetr_base (image_size 560) and detr_base
     (image_size 448), each in float32 and bf16 through
     load_and_run_detector_batch over the 16 images at batch 8: an eager
     and a replayed pass, each with exact launches (NMS once per selection
     program; no int8 kernel, no stem; the bias + SiLU epilogue once per
     activated conv of yolov8l in bf16, counted from its config), their
     detections identical, the MD JSON checked; images/s of a replayed
     pass; forward and program ms eager and replayed on the family's 4:3
     batch of 8, peak memory; the card against the CPU on a uint8 batch
     of 2 at 256 px (yolov8l) or 224 px, rows matched by query (RF-DETR's
     top-Q tokens): float32 every query the same, within rtol 1e-4 and
     atol 1e-4 * max|ref|; bf16 no more queries missing and no larger
     errors than the CPU's bf16 against its float32, plus that atol; the
     largest differences printed.
     Phase 22's NMS and bias + SiLU launches join those kernels' records.
 23. the species classifier and the two-stage path: EfficientNetV2-M
     (SpeciesNet's crop classifier) at full width and depth, 2000 classes,
     480 px, random weights from seed 0 (conv weights x 0.83, fc x 64, so
     the BN-free graph's logits stay O(1)); the int8 conv kernel at every
     distinct chain-conv shape of a batch of 64 (int32 sums, int8 with and
     without SiLU) and the bias + SiLU kernel at every distinct shape of
     the bf16 forward, identical to their plain versions, with the
     no-SiLU epilogue's ms against the SiLU kind's; SpeciesClassifier in
     float32, bf16 and int8 (calibrate() on 64 crops from RandomState(1)):
     eager then replayed, identical, launches exact per forward (none; 147
     bias + SiLU; 109 int8 conv + 92 bias + SiLU), two batches in flight
     equal to serial calls, forward and program ms eager and replayed,
     crops/s, peak memory; the card against the CPU on 4 crops at 224 px;
     run_md_and_classifier over 16 JPEGs and a 45-frame 1080p video with
     phase 4's yolov5l6 in bf16 and the classifier in bf16, then int8, at
     the threshold that leaves about 1,000 crops: JSON valid, results equal
     to classify_batch on the same crops, launches exact, seconds by step
     and crops/s. Its NMS, int8 conv and bias + SiLU launches join those
     kernels' records.
 24. the serving daemon: MDServer (port 0) with phase 4's yolov5l6 in
     bf16, max_batch_size 8, batch_wait_ms 15, warmed by two batches of
     8; 24 client threads post /v1/detect back to back for 15 s (every
     third request at threshold 0.2) and one /v1/detect_batch of 8
     follows: every response equal to
     generate_detections_one_batch on the decoded image, filtered at its
     threshold, the batch's order kept, /metrics adding up, launches
     exact (programs padded to 8, NMS once a selection, stem and bias +
     SiLU as in phase 10), every canvas's later programs replayed;
     latency p50 / p90 / p99 over the window's requests, images/s over
     the window, mean batch fill; client.detect_folder
     writes a valid file;
 25. the bias + SiLU backward kernel (E7 bwd) against its plain version:
     dx bit-identical over all 65,536 bf16 x (three seeded g and bias
     draws, NCHW and channels_last, 16-byte aligned and not, with and
     without a bias); at every distinct shape of phases 26 and 27's bf16
     forwards and at l1's [8,128,240,320]: dx bit-identical, db equal to
     silu_bf16_backward_bias_sum_ordered (the kernel's fixed order),
     the same bits over three calls and within one bf16 step of the
     plain version's; ms of kernel (back to back and replayed),
     plain version and aten.silu_backward, the bound, the total a
     training step; at l1's shape also the kernel without a bias (no db);
 26. detector training: yolov5l6 (nc 3, seed 0) at 1280x1280 on seeded
     uint8 images with 1-8 boxes each, bf16 at batch 8 and float32 at
     batch 8 (4 if 8 does not fit), 21 Adam steps (clip 5, lr 1e-5) on
     one batch: losses finite, every later one below the first, the last
     below half of it, E7 forward and backward once per activated conv a
     bf16 step, nothing of ours in float32; step ms over 20 steps (mean,
     median, range, sd), the optimizer's ms, images/s, peak memory; one
     float32 loss and backward at 320 px,
     batch 2, on the card against the CPU;
 27. classifier training: training/train_classifier.train() (its
     defaults: efficientnetv2_s, 224 px, batch 64) on 3 x 64 JPEG crops,
     one epoch in float32 and one in bf16: E7 launches per step as
     forward_launches counts them (forward and backward), the checkpoint
     loaded in SpeciesClassifier giving the trained module's logits, the
     steady step ms over 20 steps and the optimizer's share; then
     classification/train_classifier.main() for an
     epoch with finetune off and on (on: only the fc changes).
     Phase 24's NMS, stem and bias + SiLU launches and phases 26-27's bias
     + SiLU forward launches join those kernels' records; the backward's
     launches are its own record's.
 28. the folder workflow: BatchJob.run_all (detect, validate, RDE,
     classify, smooth, preview, report) over phase 18's 64 JPEGs in two
     camera folders, phase 4's yolov5l6 with each conv rescaled to unit
     output std and its detect head sharpened on synthetic images
     (anchor-sized boxes, a few an image above RDE's 0.1 floor; random
     weights score every box 1.0) in bf16 at 1280 px auto canvases,
     batch 8, 8 loader threads, at the confidence threshold that leaves
     about 12 detections an image, RDE at the occurrence threshold of the
     most frequent repeat, phase 23's EfficientNetV2-M in bf16 on every
     detection: the detections file equal to load_and_run_detector_batch
     + write_results_to_file, the filtered file to find_repeat_detections
     alone, the final file to classify_batch on the same crops followed
     by the job's post-classification chain, the preview and report.csv
     (its rows the final file's images), launches exact (the classifier
     147 bias + SiLU a forward), every canvas's later programs replayed,
     no child process left; seconds by stage, images/s of the detection
     stage and of the job;
 29. compare_inference_options over 8 of phase 18's 4:3 JPEGs: phase
     28's yolov5l6 at phase 28's confidence threshold and its int8
     checkpoint (calibrated on the card on the two synthetic images the
     rescale used, letterboxed to 320 px, as phase 37's B) at its own
     threshold, the one that leaves 12 detections an image, printed;
     dtype bf16 and conv_backend pallas, canvas modes auto and square,
     augmentation off and on (8 jobs: B1, B2, B3, B4 and E7): each job's
     file equal to load_and_run_detector_batch with its detector, options
     and threshold and holding at least one detection, each job's
     launches exact, comparison_summary.json with 28 pairs; each job's
     images/s. Phases 28-29's launches join those kernels' records.
 30. int8 static-scale checkpoints: quantize_checkpoint(mode='static') on
     phase 4's yolov5l6 (96 int8 convs: 46 1x1, 50 3x3; float
     activations between them), calibrated on the card on phase 7's two
     320 px images; load_detector over the 16 images at batch 8, eager
     then replayed, identical, the conv kernel in its int32 mode once per
     int8 conv a forward and NMS once a selection program
     (_expected_launches); that mode against its plain version at the
     path's 3x3 s2 and 1x1 shapes; card vs CPU at 320 px (phase 8's
     bars); forward and whole-program ms eager and replayed beside the
     chain's of phase 7;
 31. utils/validate_weights on phase 4's checkpoint with skip_export
     (convert, golden over 6 synthetic images, int8 chain drift at bound
     1.0 as --dry_run sets it for random weights, capacity; the export
     stage's artifact of eight 1280 px float32 programs is phase 35's
     work, at batch 8): status ok, each stage's numbers; then
     utils/accelerator_test on the card: platform gpu, its NMS-kernel
     smoke test ok;
 32. create_classification_dataset over phase 27's crops, then
     evaluate_model on the card with phase 27's float32 classifier: the
     written probabilities against classify_batch on the same crops, the
     metric files against a numpy recomputation;
 33. utils/profiling: xla_trace (torch.profiler, CUDA activity) around a
     replayed bf16 program inside annotate('md_program'): the trace file
     names the span and our kernels it launched (stem, bias + SiLU, NMS's
     two passes) up to the counters. Phases 30-31's NMS and conv
     launches join those kernels' records;
 34. the path kernels as custom operators: each through torch.ops.mdtorch
     on CUDA tensors at a yolov5l6 shape (NMS by value and with the
     threshold in device memory at K = 2048, the conv in its three modes,
     the bottleneck with and without its residual, the stem, bias + SiLU)
     against its plain version on the CPU under its kernel's bar; the
     device-side threshold split bit for bit threshold_split's at the
     thresholds the phases use;
 35. detection/export_detector: yolov5l6 from seed 0 at full width and
     depth, in bf16 (B1, B4, E7) and in the int8 chain under
     conv_backend=pallas (B1, B2, B3), exported for the card at batch 8
     (the square, 4:3 and 5:3 canvases, capacities 512 to 8192); the
     artifact loaded in a fresh ExportedDetector and run over the 16
     images through load_and_run_detector_batch, eager then replayed,
     beside the live detector: results identical, launches equal; export
     seconds, artifact MB, load seconds, program ms eager and replayed
     against the live detector's. The artifact's launches join the
     kernels' records;
 36. utils/integration_tests on the card: its Python tiers (single image
     against batch, batch-size invariance, augmentation, video, tiled,
     postprocessing and RDE), seconds. With --cli its CLI tier too (every
     CLI of the port as a subprocess, export -> batch from the artifact
     identical to the checkpoint's run).
 37. the detection-postprocessing tools: phase 28's 64 JPEGs through
     phase 28's yolov5l6 in bf16 (A, at phase 28's threshold) and its
     int8 chain under conv_backend pallas in bf16 (B, calibrated on the
     card on the rescale's two images; phase 29's noise-calibrated
     checkpoint scores every box 0.006; at its own threshold),
     load_and_run_detector_batch at batch 8, launches exact; merge_detections
     (A's detections kept, the file valid), compare_model_confidence_values
     and calibrate_threshold (matched pairs above 0), add_max_conf,
     categorize_detections_by_size, remap_detection_categories, JSON ->
     CSV -> JSON (A's detections back), load_api_results (64 rows),
     md_to_coco, md_to_labelme, md_to_wi, render_detection_confusion_matrix
     of B against A's COCO file, separate_detections_into_folders (each
     image in one folder) and top_folders_to_bottom, create_crop_folder
     (one crop a selected detection), the crops classified by phase 23's
     EfficientNetV2-M in bf16 (147 bias + SiLU a forward, exact) and mapped
     back by crop_results_to_image_results onto every cropped detection;
     seconds by step, and whether matplotlib is installed. Its launches
     join the B1, B2, B3, B4 and E7 records.
 38. the classifier-training workflow: a COCO Camera Traps database over
     phase 28's 64 JPEGs (four locations, deer and fox, one box an image,
     no sizes) through add_width_and_height_to_db (PIL's sizes),
     integrity_check_json_db (no error; a broken category reference
     raises), subset_json_db per camera and coco_tools.combine_cct_files
     (the database back), sample_json_db and cct_to_md (valid); a label
     spec CSV through csv_to_json and json_validator.run_validator (one
     label capped and prioritized: 56 queried images); phase 28's
     yolov5l6 in bf16 over the folder at phase 28's threshold (B1, B4,
     E7, launches exact), its results cached twice by
     cache_batchapi_outputs (overlapping halves: each image once);
     crop_detections, create_classification_dataset (location splits),
     classification/train_classifier.main for one epoch (efficientnetv2_s,
     224 px, float32) and evaluate_model; identify_mislabeled_candidates
     (files equal to the candidates recomputed from the CSV),
     save_mislabeled and filter_queried_images (exactly their images
     dropped), run_classifier, map_classification_categories of a
     two-target spec, aggregate_classifier_probs (each row sums to 1 within
     1e-5), merge_classification_detection_output (both merged files
     valid); analyze_failed_images over the crops flags exactly a planted
     truncated JPEG; nothing after the detector launches a kernel of ours;
     seconds by step, launches, crops, candidates, merged detections. Its
     launches join the B1, B4 and E7 records.
 39. the data-format converters, importers, image tools and LILA tools
     from phase 38's database and detections, a LILA subset over loopback
     through the card, three bf16 training steps from the YOLO labels
     (phase_data_formats has the list). Its launches join the B1, B4, E7
     and E7 backward records.
 40. the Wildlife Insights and SpeciesNet results layer and the WI
     download workflow: run_md_and_speciesnet over phase 28's 64 JPEGs
     with phase 28's yolov5l6 and phase 23's EfficientNetV2-M in bf16,
     the ensemble on (B1, B4, E7, launches exact); the card's results to
     predictions.json and back (instances, 4 batches merged, an ensemble
     file with geofencing through TaxonomyHandler,
     generate_md_results_from_predictions_json and the speciesnet_to_md
     CLI byte-identical, wi_predictions_to_md, find_geofence_adjustments,
     map_lila_taxonomy_to_wi); four WI payloads an image validated and
     pushed in 4 threads with an auth token to a loopback server, each
     received once; a WI download bundle from phase 38's database through
     prepare_project_downloads, its scripts run with a stub gcloud, the
     completion check, thumbnails, COCO, the visualize_db preview,
     samples, directory_listing and split_locations_into_train_val
     (phase_wildlife_insights has the list); seconds by step. Its
     launches join the B1, B4 and E7 records.
 41. the taxonomy tools, the YOLO val runner, change detection, XMP
     tagging, video rendering and the native host kernels: GBIF and iNat
     archives and sample images on loopback through species_lookup,
     taxonomy_release, the checkers and both image-search tools; the 32
     downloads through phase 28's yolov5l6 in bf16 (B1, B4, E7, launches
     exact); run_inference_with_yolo_val with a stand-in val.py running
     the same detector on the card (chunked and resumed, then the symlink
     farm; each process's launches exact; its MD files against the batch
     driver's at the golden tolerances); XMP sidecars and embedded tags
     (a stand-in pyexiv2); change detection over phase 28's cameras;
     phase 21's videos rendered; native/letterbox_nms.cpp built with g++
     and held to ops/boxes.letterbox, to B1's keep masks and to its
     clustering rule (phase_host_tools has the list); seconds by step.
     Its launches join the B1, B4 and E7 records.
 42. data parallelism on a two-replica mesh (make_data_mesh(devices=
     [cuda:0, cuda:0]), a stream each): the meshed yolov5l6 in bf16 and
     int8 pallas on the 960x1280 batch of 8 against the unsharded
     detector (eager, captured, replayed; launches exact over the
     replicas' programs; outputs and MD records at the golden
     tolerances), load_and_run_detector_batch over phase 18's 64 JPEGs and
     MDServer with the meshed detector, the sharded detector and
     classifier train steps against the unsharded ones (float32 at the
     CPU tests' bars, bf16 at the bf16 bar; E7 and E7 backward in each
     replica), dryrun_multichip on the two replicas, and the helper
     modules' new functions on the driver's output
     (phase_data_parallel has the list); seconds by step. Its launches
     join the B1, B2, B3, B4, E7 and E7 bwd records.
Phases 4, 7 and 10-12 count two passes over the images: the first runs
each program eagerly (its first call), the second captures the programs
into CUDA graphs and replays them; launches must be equal and detections
identical; images/s come from a third pass, all replays (the driver's
loader threads, whose images it takes in input order).
With --cli: phase 36's CLI tier (left out by default to keep the run
inside its time limit). With --profile: torch.profiler over one device program on a 960x1280
batch of 8 (device time by kernel, idle share), int8 under both backends
in phase 7 and bf16 after phase 13, each replayed and eager; each window
runs the program twice and reads the second, and the port's kernels
there must show exactly the launches their wrappers counted.
Then one JSON line with every kernel's record (time, plain time, bound,
library yardstick, launches on the main path; E7's backward at l1's
shape), and last the device line.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

NMS_SOURCE = 'megadetector_tpu_torch/csrc/nms.cu'
NMS_REPLACES = 'megadetector_tpu/ops/pallas_nms.py:26'
CONV_SOURCE = 'megadetector_tpu_torch/csrc/conv_int8.cu'
CONV_REPLACES = 'megadetector_tpu/ops/pallas_conv.py:90'
BOTTLENECK_SOURCE = 'megadetector_tpu_torch/csrc/bottleneck_int8.cu'
BOTTLENECK_REPLACES = 'megadetector_tpu/ops/pallas_bottleneck.py:136'
STEM_SOURCE = 'megadetector_tpu_torch/csrc/l0_fused.cu'
STEM_REPLACES = 'megadetector_tpu/ops/pallas_l0.py:80'
SILU_SOURCE = 'megadetector_tpu_torch/csrc/silu_bf16.cu'
SILU_REPLACES = 'experiments/exp_pallas_l0_retry.py:71'
GEMM_SOURCE = 'megadetector_tpu_torch/csrc/gemm_int8.cu'
# The experiments' kernels: label -> (record name, source, TPU kernel,
# the epilogue and in_ratio of the record's conv time (E1-E4), entry point)
EXPERIMENTS = {
    'E1': ('conv3x3_int8_exp_f32', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3.py:70', ('f32', 0.8531),
           'exp_conv3x3'),
    'E2': ('conv3x3_int8_exp_f32_nosilu', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3b.py:66', ('f32_nosilu', 0.8531),
           'exp_conv3x3b'),
    'E3': ('conv3x3_int8_exp_bf16', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3c.py:64', ('bf16', 0.8531),
           'exp_conv3x3c'),
    'E4': ('conv3x3_int8_exp_hybrid', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3d.py:60', ('hybrid', 1.0),
           'exp_conv3x3d'),
    'E5': ('gemm_int8', GEMM_SOURCE, 'experiments/exp_pallas_int8_chain.py:82',
           None, 'exp_int8_chain'),
    'E6': ('gemm_int8', GEMM_SOURCE,
           'experiments/exp_pallas_int8_matmul.py:73', None,
           'exp_int8_matmul'),
}

# The port's kernel functions (csrc/*.cu), for the profile's sums
PORT_KERNELS = ('nms_mask_kernel', 'nms_sweep_kernel', 'conv_int8_kernel',
                'bottleneck_int8_kernel', 'l0_fused_kernel',
                'silu_bf16_vec8_kernel', 'silu_bf16_kernel',
                'gemm_int8_kernel')

# The GEMM shapes of phase 14: E5's (M = 1024 x batch 64, K = N = 1152),
# E6's conv-as-matmul (M = 4800 x batch 8, K = 2304, N = 256) and E6's
# square-ish 4096x2048x2048
GEMM_SHAPES = ((65536, 1152, 1152), (38400, 2304, 256), (4096, 2048, 2048))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) for bound_ms
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3
BF16_OPS_PER_MS = 989e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3


def _bound(n_bytes, n_ops, ops_per_ms):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""

    t_bytes = n_bytes / HBM_BYTES_PER_MS
    t_ops = n_ops / ops_per_ms
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _gemm_bound(m, k, n, requant):
    """_bound of [M, K] s8 @ [K, N] s8: a and b read once, the int32 (or,
    with a requant, int8) output written once, 2 MKN int8 operations."""

    out_bytes = 4 if requant is None else 1
    return _bound(m * k + k * n + m * n * out_bytes, 2.0 * m * k * n,
                  INT8_OPS_PER_MS)


def _time_ms(fn, reps, warmup=2):
    """Mean ms per call of fn() on the card (CUDA events)."""

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps=10):
    """Mean device ms per call of fn(): [reps] calls captured in a CUDA
    graph and replayed (CUDA events), so the host's work per call (the
    wrapper's checks, allocations, tensor maps, launches) is not timed."""

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def _nms_case(rng, b, k, n_classes=3, canvas=1280.0):
    """Seeded score-sorted boxes [b, k, 4], class-offset like
    nms_on_candidates does, with ~10% invalid slots."""

    import numpy as np

    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(8, 240, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    classes = rng.randint(0, n_classes, (b, k)).astype(np.float32)
    boxes += classes[..., None] * np.float32(8192.0)
    valid = rng.rand(b, k) > 0.1
    return boxes, valid


def _nms_split(boxes, valid, thresh, reps=5):
    """(mask pass ms, sweep ms) per call of the NMS kernel, from
    torch.profiler's device time by kernel name; None where the profiler
    saw no device time."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from megadetector_tpu_torch.ops import cuda_nms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cuda_nms.greedy_nms_keep(boxes, valid, thresh)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        for name in ('nms_mask_kernel', 'nms_sweep_kernel'):
            if re.search(r'(^|[\s:]){}[<(]'.format(name), e.key):
                split[name] = split.get(name, 0.0) + us / 1e3 / reps
    if not split:
        return None
    return split.get('nms_mask_kernel', 0.0), split.get('nms_sweep_kernel',
                                                        0.0)


def phase_kernel(device):
    """Kernel vs plain version on the card; returns the kernel record."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops import cuda_nms

    rng = np.random.RandomState(0)
    cases = []
    for k in (512, 2048, 8192):
        cases.append(('random B=8 K={}'.format(k), k) +
                     _nms_case(rng, 8, k) + (0.45,))

    # A overlaps B, B overlaps C, A does not overlap C: A and C are kept
    chain = np.array([[[100, 100, 140, 140], [120, 100, 160, 140],
                       [140, 100, 180, 140], [500, 500, 540, 540]]],
                     np.float32)
    cases.append(('chain', 4, chain, np.ones((1, 4), bool), 0.2))

    # Exact duplicates across the 64-box word boundary, invalid slots
    dup, dup_valid = _nms_case(rng, 2, 130)
    dup[:, 1] = dup[:, 0]
    dup[:, 64] = dup[:, 0]
    dup[:, 65] = dup[:, 3]
    dup[:, 127] = dup[:, 126]
    dup_valid[:, 0] = True
    dup_valid[:, 3] = False
    dup_valid[:, 100:110] = False
    cases.append(('duplicates+invalid', 130, dup, dup_valid, 0.45))

    timings = {}
    max_err = 0.0
    for name, k, boxes_np, valid_np, thresh in cases:
        boxes = torch.from_numpy(boxes_np).to(device)
        valid = torch.from_numpy(valid_np).to(device)
        got = cuda_nms.greedy_nms_keep(boxes, valid, thresh)
        torch.cuda.synchronize()
        ref = cuda_nms.greedy_nms_keep_reference(boxes, valid, thresh)
        max_err = max(max_err, float((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(
                'NMS kernel disagrees with its plain version on {}: {} of '
                '{} slots differ'.format(name, int((got != ref).sum()),
                                         got.numel()))
        if name == 'chain' and got.cpu().numpy().tolist() != \
                [[True, False, True, True]]:
            raise AssertionError('chain case kept {}'.format(
                got.cpu().numpy().tolist()))
        line = 'kernel == plain on {}: kept {} of {} valid'.format(
            name, int(got.sum()), int(valid.sum()))
        if name.startswith('random'):
            ms = _time_ms(lambda: cuda_nms.greedy_nms_keep(
                boxes, valid, thresh), reps=20)
            plain_ms = _time_ms(lambda: cuda_nms.greedy_nms_keep_reference(
                boxes, valid, thresh), reps=2, warmup=1)
            timings[k] = (ms, plain_ms)
            line += '; kernel {:.4f} ms, plain {:.4f} ms per call'.format(
                ms, plain_ms)
            split = _nms_split(boxes, valid, thresh)
            line += ('; mask pass {:.4f} ms, sweep {:.4f} ms (profiler)'
                     .format(*split) if split else
                     '; mask / sweep split not measured (the profiler saw no '
                     'device time)')
        print(line, flush=True)
        del boxes, valid, got, ref
        torch.cuda.empty_cache()

    ms, plain_ms = timings[8192]
    # B=8, K=8192: boxes, valid in, keep out; K(K-1)/2 IoU tests per image
    # at 14 float32 operations each (intersection 9, union 2, divide and
    # max 2, compare 1), on the CUDA cores
    k = 8192
    bound_ms, bound_by = _bound(8 * k * (16 + 1 + 1),
                                8 * k * (k - 1) / 2 * 14, F32_OPS_PER_MS)
    print('greedy NMS B=8 K=8192: bound {:.4f} ms ({}); library call: none '
          '(PyTorch has no greedy NMS; torchvision is absent)'.format(
              bound_ms, bound_by), flush=True)
    return {'name': 'greedy_nms', 'route': 'cuda', 'source': NMS_SOURCE,
            'replaces': NMS_REPLACES, 'launches': None,
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def _synthetic_images(rng):
    """16 seeded uint8 images: 8 at 1536x2048 (4:3), 8 at 1080x1920
    (16:9), gradients + blocks + noise."""

    import numpy as np

    images = []
    for i in range(16):
        h, w = (1536, 2048) if i % 2 == 0 else (1080, 1920)
        yy = np.linspace(0, 255, h, dtype=np.float32)[:, None]
        xx = np.linspace(0, 255, w, dtype=np.float32)[None, :]
        img = np.empty((h, w, 3), np.float32)
        img[..., 0] = xx
        img[..., 1] = yy
        img[..., 2] = 96 + 40 * i % 160
        for _ in range(6):
            y0, x0 = rng.randint(0, h - h // 5), rng.randint(0, w - w // 5)
            img[y0:y0 + h // 6, x0:x0 + w // 6] = rng.randint(0, 255, 3)
        img += rng.randint(-20, 20, (h, w, 1))
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def _write_and_check(results, pairs, model_path, out_file):
    """write_results_to_file, then check the MD JSON; returns the number
    of detections."""

    from megadetector_tpu_torch.detection.run_detector_batch import \
        write_results_to_file

    write_results_to_file(results, out_file, detector_file=model_path)
    with open(out_file) as f:
        written = json.load(f)
    if written['info']['format_version'] != '1.6':
        raise AssertionError('format_version {}'.format(
            written['info']['format_version']))
    files = sorted(im['file'] for im in written['images'])
    if files != sorted(p[0] for p in pairs):
        raise AssertionError('images in the JSON: {}'.format(files))
    n_det = 0
    for im in written['images']:
        if 'failure' in im or im['detections'] is None:
            raise AssertionError('{} failed: {}'.format(
                im['file'], im.get('failure')))
        for det in im['detections']:
            x, y, w, h = det['bbox']
            if not all(0.0 <= v <= 1.0 for v in (x, y, w, h)) or \
                    x + w > 1.0 + 1e-6 or y + h > 1.0 + 1e-6:
                raise AssertionError('{}: bbox {} outside [0, 1]'.format(
                    im['file'], det['bbox']))
            if not 0.0 < det['conf'] <= 1.0:
                raise AssertionError('{}: conf {}'.format(im['file'],
                                                          det['conf']))
            n_det += 1
    return n_det


def phase_main_path(device, workdir, config, params):
    """The port's batch detection path on the card; returns
    (launches, images/s, detector)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    model_path = os.path.join(workdir, 'md_smoke_{}.npz'.format(config.arch))
    save_checkpoint(params, model_path, {
        'arch': config.arch, 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'], 'image_size': 1280})
    detector = load_detector(model_path, detector_options={
        'pad_batches_to': 8}, device=device)

    rng = np.random.RandomState(1)
    pairs = [('smoke/img_{:02d}.jpg'.format(i), img)
             for i, img in enumerate(_synthetic_images(rng))]

    results, counts, batches, e2e = _eager_then_replayed(
        detector, pairs, 'float32 main path')
    launches = counts[0]

    n_det = _write_and_check(results, pairs, model_path,
                             os.path.join(workdir, 'smoke_results.json'))
    if batches < 2 or launches < batches:
        raise AssertionError('{} device batches but {} NMS kernel '
                             'launches'.format(batches, launches))
    truncated = sum(1 for im in results if 'pre_nms_truncation' in im)
    print('main path: 16 images, {} detections, {} device batches, {} NMS '
          'kernel launches, {} images past the 8192 capacity'.format(
              n_det, batches, launches, truncated), flush=True)

    # The device program alone on letterboxed batches (replayed)
    infos = [detector.preprocess_image(img, image_id=name)
             for name, img in pairs]
    buckets = {}
    for info in infos:
        buckets.setdefault(tuple(info['target_shape']), []).append(info)
    torch.cuda.synchronize()
    start = time.time()
    for bucket in buckets.values():
        detector.generate_detections_one_batch(bucket,
                                               detection_threshold=0.005)
    torch.cuda.synchronize()
    device_rate = len(infos) / (time.time() - start)
    return launches, e2e, device_rate, detector, buckets, model_path, pairs


def phase_breakdown(detector, buckets):
    """CUDA-event ms of forward / selection / NMS for one 960x1280 batch
    of 8 at the capacity the main path escalated to."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops.decode import select_topk_candidates
    from megadetector_tpu_torch.ops.nms import nms_on_candidates

    batch = np.stack([info['img_processed']
                      for info in buckets[(960, 1280)]])
    out, topk = detector.run_program(batch, 0.005, 0.45)
    config = detector.config
    with torch.inference_mode():
        x = torch.from_numpy(batch).to(detector.device).float() / 255.0
        heads = detector.model(x, decode=False)
        fwd = _time_ms(lambda: detector.model(x, decode=False), reps=5)
        sel = _time_ms(lambda: select_topk_candidates(
            heads, config.anchors, config.strides, config.num_classes,
            0.005, topk), reps=10)
        cands = select_topk_candidates(heads, config.anchors, config.strides,
                                       config.num_classes, 0.005, topk)
        nms = _time_ms(lambda: nms_on_candidates(cands, 0.45), reps=10)
    print('breakdown 960x1280 batch 8 (capacity {}, max above-floor '
          'candidates {}): forward {:.3f} ms, select {:.3f} ms, '
          'nms_on_candidates {:.3f} ms'.format(
              topk, int(out['n_candidates'].max()), fwd, sel, nms),
          flush=True)
    return batch, fwd


def phase_card_vs_cpu(detector, config, params):
    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import YoloV5

    x = np.random.RandomState(2).rand(2, 320, 320, 3).astype(np.float32)
    cpu_model = YoloV5(config).load_params(params).eval()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(x), decode=False)
        got = detector.model(torch.from_numpy(x).to(detector.device),
                             decode=False)
    worst = 0.0
    for lvl, (r, g) in enumerate(zip(ref, got)):
        g = g.cpu()
        if tuple(r.shape) != tuple(g.shape) or not torch.isfinite(g).all():
            raise AssertionError('level {}: shape {} vs {} or non-finite'
                                 .format(lvl, tuple(g.shape),
                                         tuple(r.shape)))
        diff = float((g - r).abs().max())
        scale = float(r.abs().max())
        if diff > 1e-3 * scale:
            raise AssertionError('level {}: max |d| {} > 1e-3 * {}'.format(
                lvl, diff, scale))
        worst = max(worst, diff / scale)
    print('card vs CPU yolov5l6 heads at 320 px: max |d| / max |ref| = '
          '{:.3e} (limit 1e-3)'.format(worst), flush=True)


def _int8_conv_case(rng, device, cin, cout, k):
    """Seeded int8 weight [cout, k, k, cin] and a float32 scale that puts
    acc * scale at about unit std, plus a bias, on the card."""

    import numpy as np
    import torch

    w = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, cout) / (np.sqrt(cin * k * k) *
                                           127.0 * 127.0 / 3.0)
    bias = rng.uniform(-0.5, 0.5, cout)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device),
            torch.from_numpy(bias.astype(np.float32)).to(device))


def _int8_input(rng, device, shape):
    import numpy as np
    import torch

    return torch.from_numpy(rng.randint(-127, 128, shape).astype(
        np.int8)).to(device)


def _conv_key(d):
    return (d['h'], d['w'], d['cin'], d['cout'], d['k'], d['stride'],
            d['pads'])


def _conv_classes(chain):
    """The int8 main path's chain convs by class: l1 (3x3 s2), then a 3x3
    s1 and a 1x1 at each stride level; {class: most frequent shape key}
    in forward order."""

    import collections

    members = {}
    for d in chain:
        if d['name'] == 'l1':
            order, name = (0, 0), 'l1 3x3 s2'
        elif d['stride'] == 1:
            level = 960 // d['h']
            order = (level, -d['k'])
            name = '{0}x{0} s1 at stride {1}'.format(d['k'], level)
        else:
            continue
        members.setdefault((order, name), []).append(_conv_key(d))
    return collections.OrderedDict(
        (name, collections.Counter(keys).most_common(1)[0][0])
        for (_, name), keys in sorted(members.items()))


def _conv_int8_ops(key, batch=8):
    """(bytes, operations) of one chain conv: x, w, scale and bias read
    once, the int8 output written once; 2 operations per int8 MAC."""

    h, w, cin, cout, k, stride, pads = key
    ho = (h + pads[0] + pads[1] - k) // stride + 1
    wo = (w + pads[2] + pads[3] - k) // stride + 1
    macs = batch * ho * wo * cout * k * k * cin
    return (batch * h * w * cin + cout * k * k * cin + 8 * cout +
            batch * ho * wo * cout, 2 * macs)


def _sweep_tilings(x, w, scale, bias, key):
    """Every 16-byte tiling of the conv kernel on one chain conv, each
    held to the wrapper's output and timed through the C entry point (no
    Python wrapper between launches: a 1x1 at 15x20 takes ~0.02 ms):
    (conv_tiling's pick, {(bm, bn, bk): ms}), printed."""

    import itertools

    import torch

    from megadetector_tpu_torch.ops import _build, conv_int8

    h, w_, cin, cout, k, stride, pads = key
    ho = (h + pads[0] + pads[1] - k) // stride + 1
    wo = (w_ + pads[2] + pads[3] - k) // stride + 1
    want = conv_int8.conv_int8(x, w, scale, bias, (stride, stride), pads,
                               0.02)
    out = torch.empty_like(want)
    lib = _build.load_library()
    times = {}
    for bm, bn, bk in itertools.product((64, 128), (64, 128), (64, 128)):
        if cin % bk:
            continue
        code = (conv_int8.INST_VEC16 |
                (conv_int8.INST_BK128 if bk == 128 else 0) |
                (conv_int8.INST_BM128 if bm == 128 else 0) |
                (conv_int8.INST_BN128 if bn == 128 else 0))

        def call():
            _build.check_launch(lib, lib.md_conv_int8(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), 8, h, w_, cin, cout, k, k,
                stride, stride, pads[0], pads[2], ho, wo, 0.02, 1, code,
                torch.cuda.current_stream().cuda_stream), 'md_conv_int8')
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError('conv tiling {} differs on {}'.format(
                (bm, bn, bk), key))
        times[(bm, bn, bk)] = _time_ms(call, reps=20)
    pick = tuple(conv_int8.conv_tiling(8 * ho * wo, cin, cout)[:3])
    print('  tilings of [8,{},{},{}]->{} {}x{} s{} (bm/bn/bk ms): {}; '
          'conv_tiling picks {}'.format(
              h, w_, cin, cout, k, k, stride, ', '.join(
                  '{}/{}/{} {:.4f}'.format(*t, ms)
                  for t, ms in sorted(times.items())), pick), flush=True)
    return pick, times


def _bottleneck_ops(key, batch=8):
    """(bytes, operations) of one bottleneck [batch, h, w, c]: x, w1, w2
    and the four float vectors read once, out written once; 10 C^2 MACs
    a pixel, 2 operations each."""

    h, w, c = key
    pixels = batch * h * w
    return pixels * c * 2 + 10 * c * c + 16 * c, 2 * pixels * 10 * c * c


def _bottleneck_counts(config, height, width, batch=8):
    """{(h, w, c): bottlenecks of that shape} of one [batch, height,
    width] forward, from the model's own geometry (each bottleneck's cv1
    is a 1x1 C->C)."""

    import collections

    from megadetector_tpu_torch.models.yolov5 import activated_conv_shapes

    return collections.Counter(
        (d['h'], d['w'], d['cin'])
        for d in activated_conv_shapes(config, height, width, batch)
        if '.m' in d['name'] and d['name'].endswith('cv1'))


def _fused_per_batch(config, canvases, batch=8):
    """Bottlenecks that routing (bottleneck_tiling) fuses in one batch at
    each canvas: {canvas: (fused, all)}."""

    from megadetector_tpu_torch.ops import bottleneck_int8

    out = {}
    for height, width in canvases:
        counts = _bottleneck_counts(config, height, width, batch)
        out[(height, width)] = (
            sum(n for (h, w, c), n in counts.items()
                if bottleneck_int8.bottleneck_tiling(batch, h, w, c)),
            sum(counts.values()))
    return out


def _bottleneck_shapes(rng, device, config):
    """The bottleneck kernel on every distinct yolov5l6 bottleneck shape of
    a 960x1280 and a 768x1280 batch of 8, with and without the residual:
    identical to its plain version and to the unfused pair of conv kernels
    (with the residual requant in torch); ms of both, the bound, the
    tiling bottleneck_tiling picks (or 'unfused'), and over the 42
    bottlenecks of each canvas the sum of the routed times. Returns
    ({(h, w, c): (kernel ms, plain ms or None)}, max |err|)."""

    import torch

    from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8

    canvases = ((960, 1280), (768, 1280))
    counts = {hw: _bottleneck_counts(config, *hw) for hw in canvases}
    keys = sorted({k for cnt in counts.values() for k in cnt},
                  key=lambda k: (k[2], -k[0]))
    times, err = {}, 0
    for key in keys:
        h, w_, c = key
        x = _int8_input(rng, device, (8, h, w_, c))
        w1, s1, b1 = _int8_conv_case(rng, device, c, c, 1)
        w2, s2, b2 = _int8_conv_case(rng, device, c, c, 3)
        plain_h2 = bottleneck_int8.bottleneck_int8_reference(
            x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007, False)[0]

        def unfused(shortcut):
            h1 = conv_int8.conv_int8(x, w1, s1, b1, (1, 1), (0, 0, 0, 0),
                                     0.021)
            h2 = conv_int8.conv_int8(h1, w2, s2, b2, (1, 1), (1, 1, 1, 1),
                                     0.033)
            if not shortcut:
                return h2
            return bottleneck_int8.residual_requant(x, 0.007, h2, 0.033)[0]
        for shortcut in (True, False):
            args = (x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007,
                    shortcut)
            got, got_scale = bottleneck_int8.bottleneck_int8(*args)
            torch.cuda.synchronize()
            ref = plain_h2 if not shortcut else \
                bottleneck_int8.residual_requant(x, 0.007, plain_h2,
                                                 0.033)[0]
            err = max(err, int((got.long() - ref.long()).abs().max()))
            name = 'C={} [8,{},{}] shortcut={}'.format(c, h, w_, shortcut)
            if got_scale != ((0.007 + 0.033) if shortcut else 0.033) or \
                    not torch.equal(got, ref):
                raise AssertionError(
                    'bottleneck kernel disagrees with its plain version on '
                    '{}: {} of {} elements differ'.format(
                        name, int((got != ref).sum()), got.numel()))
            if not torch.equal(unfused(shortcut), got):
                raise AssertionError('fused and unfused kernels differ on '
                                     '{}'.format(name))
        args = (x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007, True)
        ms = _time_ms(lambda: bottleneck_int8.bottleneck_int8(*args),
                      reps=20)
        unfused_ms = _time_ms(lambda: unfused(True), reps=20)
        plain_ms = None
        if key == (60, 80, 256):
            plain_ms = _time_ms(
                lambda: bottleneck_int8.bottleneck_int8_reference(*args),
                reps=2, warmup=1)
        times[key] = (ms, plain_ms, unfused_ms)
        n_bytes, n_ops = _bottleneck_ops(key)
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        tiling = bottleneck_int8.bottleneck_tiling(8, h, w_, c)
        print('bottleneck kernel == plain == unfused conv pair (both '
              'residuals) on C={} [8,{},{}]: kernel {:.4f} ms ({:.1f} '
              'TOP/s, {:.3f} of the {:.4f} ms bound, {}), unfused {:.4f} ms'
              '{}; {} blocks; routed {}'.format(
                  c, h, w_, ms, n_ops / ms / 1e9, bound[0] / ms, bound[0],
                  bound[1], unfused_ms,
                  '' if plain_ms is None else
                  ', plain {:.4f} ms'.format(plain_ms),
                  bottleneck_int8.bottleneck_grid(8, h, w_),
                  'fused (bn {}, vec {})'.format(tiling.bn, tiling.vec)
                  if tiling else 'unfused'), flush=True)
        del x, w1, w2, got, ref, plain_h2
        torch.cuda.empty_cache()
    for hw, cnt in counts.items():
        routed = sum(n * (times[k][0] if bottleneck_int8.bottleneck_tiling(
            8, *k) else times[k][2]) for k, n in cnt.items())
        fused = sum(n * times[k][0] for k, n in cnt.items())
        unfused = sum(n * times[k][2] for k, n in cnt.items())
        print('bottleneck sum over the {} bottlenecks of a {}x{} batch of '
              '8, each shape timed alone: routed {:.3f} ms ({} fused), all '
              'fused {:.3f} ms, all unfused {:.3f} ms'.format(
                  sum(cnt.values()), hw[0], hw[1], routed,
                  sum(n for k, n in cnt.items()
                      if bottleneck_int8.bottleneck_tiling(8, *k)),
                  fused, unfused), flush=True)
    return {k: (v[0], v[1]) for k, v in times.items()}, err


def phase_int8_kernels(device, config):
    """Conv and bottleneck kernels vs their plain versions on the card at
    yolov5l6 shapes (960x1280 canvas, batch 8); returns their records."""

    import collections

    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import activated_conv_shapes
    from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8

    rng = np.random.RandomState(6)
    conv_cases = [
        ('l1 3x3 s2 [8,480,640,64]->128', (8, 480, 640, 64), 128, 3,
         (2, 2), (1, 1, 1, 1)),
        ('3x3 s1 [8,120,160,128]->128', (8, 120, 160, 128), 128, 3,
         (1, 1), (1, 1, 1, 1)),
        ('1x1 [8,120,160,512]->256', (8, 120, 160, 512), 256, 1,
         (1, 1), (0, 0, 0, 0)),
    ]
    conv_ms, conv_err = {}, 0
    for name, shape, cout, k, stride, pads in conv_cases:
        x = _int8_input(rng, device, shape)
        w, scale, bias = _int8_conv_case(rng, device, shape[3], cout, k)
        for y_scale in (None, 0.02):
            got = conv_int8.conv_int8(x, w, scale, bias, stride, pads,
                                      y_scale)
            torch.cuda.synchronize()
            ref = conv_int8.conv_int8_reference(x, w, scale, bias, stride,
                                                pads, y_scale)
            conv_err = max(conv_err, int((got.long() - ref.long()).abs()
                                         .max()))
            if not torch.equal(got, ref):
                raise AssertionError(
                    'conv kernel disagrees with its plain version on {} '
                    '({}): {} of {} elements differ'.format(
                        name, 'int32' if y_scale is None else 'int8',
                        int((got != ref).sum()), got.numel()))
        ms = _time_ms(lambda: conv_int8.conv_int8(
            x, w, scale, bias, stride, pads, 0.02), reps=10)
        plain_ms = _time_ms(lambda: conv_int8.conv_int8_reference(
            x, w, scale, bias, stride, pads, 0.02), reps=2, warmup=1)
        conv_ms[name] = (ms, plain_ms)
        n_bytes, n_ops = _conv_int8_ops(shape[1:3] + (shape[3], cout, k,
                                                      stride[0], pads))
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        print('conv kernel == plain (int32 and int8) on {}: kernel {:.4f} '
              'ms ({:.1f} TOP/s, {:.3f} of the {:.4f} ms bound), plain '
              '{:.4f} ms per call'.format(name, ms, n_ops / ms / 1e9,
                                          bound[0] / ms, bound[0], plain_ms),
              flush=True)
        if k == 1:
            # the 1x1 int32 case is a GEMM: torch._int_mm (cuBLASLt, int8
            # tensor cores) computes the same function
            x2d = x.view(-1, shape[3])
            w2d = w.view(cout, shape[3]).t().contiguous()
            lib = torch._int_mm(x2d, w2d)
            if not torch.equal(lib.view(got.shape[:3] + (cout,)),
                               conv_int8.conv_int8(x, w, scale, bias, stride,
                                                   pads, None)):
                raise AssertionError('torch._int_mm and the conv kernel '
                                     'differ on {} (int32)'.format(name))
            int32_ms = _time_ms(lambda: conv_int8.conv_int8(
                x, w, scale, bias, stride, pads, None), reps=10)
            lib_ms = _time_ms(lambda: torch._int_mm(x2d, w2d), reps=10)
            conv_lib = (int32_ms, lib_ms)
            # int32 out: 4 bytes an output instead of 1
            m_out = x2d.shape[0] * cout
            int32_bound = _bound(n_bytes + 3 * m_out - 8 * cout, n_ops,
                                 INT8_OPS_PER_MS)
            print('  int32 on {}: kernel {:.4f} ms ({:.1f} TOP/s, {:.3f} of '
                  'the {:.4f} ms bound, {}), torch._int_mm (same function, '
                  'identical) {:.4f} ms'.format(
                      name, int32_ms, n_ops / int32_ms / 1e9,
                      int32_bound[0] / int32_ms, int32_bound[0],
                      int32_bound[1], lib_ms), flush=True)
            del x2d, w2d, lib
        del x, w, got, ref
        torch.cuda.empty_cache()

    # Every chain conv shape of a 960x1280 batch of 8 (l0 stays float):
    # the kernel's ms per shape under every tiling, and per class TOP/s
    # and the bound's share after an identity check against the plain
    # version
    chain = activated_conv_shapes(config, 960, 1280, 8)[1:]
    counts = collections.Counter(_conv_key(d) for d in chain)
    classes = _conv_classes(chain)
    shape_ms, best_ms = {}, {}
    for key in counts:
        h, w_, cin, cout, k, stride, pads = key
        x = _int8_input(rng, device, (8, h, w_, cin))
        w, scale, bias = _int8_conv_case(rng, device, cin, cout, k)
        for name, class_key in classes.items():
            if class_key != key:
                continue
            got = conv_int8.conv_int8(x, w, scale, bias, (stride, stride),
                                      pads, 0.02)
            torch.cuda.synchronize()
            ref = conv_int8.conv_int8_reference(x, w, scale, bias,
                                                (stride, stride), pads, 0.02)
            conv_err = max(conv_err, int((got.long() - ref.long()).abs()
                                         .max()))
            if not torch.equal(got, ref):
                raise AssertionError(
                    'conv kernel disagrees with its plain version on the '
                    'class {} {}: {} of {} elements differ'.format(
                        name, key, int((got != ref).sum()), got.numel()))
        pick, times = _sweep_tilings(x, w, scale, bias, key)
        shape_ms[key] = times[pick]
        best_ms[key] = min(times.values())
        del x, w
    for name, key in classes.items():
        h, w_, cin, cout, k, stride, pads = key
        n_bytes, n_ops = _conv_int8_ops(key)
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        ms = shape_ms[key]
        print('conv kernel == plain, class {} ({} of the 130 chain convs): '
              '[8,{},{},{}]->{} {}x{} s{}: {:.4f} ms, {:.1f} TOP/s, bound '
              '{:.4f} ms ({}), {:.3f} of the bound'.format(
                  name, counts[key], h, w_, cin, cout, k, k, stride, ms,
                  n_ops / ms / 1e9, bound[0], bound[1], bound[0] / ms),
              flush=True)
    total_ms = sum(counts[key] * ms for key, ms in shape_ms.items())
    total_ops = sum(counts[key] * _conv_int8_ops(key)[1] for key in counts)
    kinds = collections.OrderedDict()
    for key, ms in shape_ms.items():
        kind = '{0}x{0} s{1}'.format(key[4], key[5])
        n, t, ops = kinds.get(kind, (0, 0.0, 0))
        kinds[kind] = (n + counts[key], t + counts[key] * ms,
                       ops + counts[key] * _conv_int8_ops(key)[1])
    print('conv kernel over the 130 chain convs of one 960x1280 batch of 8 '
          '({} shapes, each timed alone at the tiling conv_tiling picks): '
          '{:.3f} ms, {:.1f} TOP/s ({}); at the best tiling of each shape '
          '{:.3f} ms'.format(
              len(counts), total_ms, total_ops / total_ms / 1e9, ', '.join(
                  '{} {} convs {:.3f} ms, {:.1f} TOP/s'.format(
                      kind, n, t, ops / t / 1e9)
                  for kind, (n, t, ops) in kinds.items()),
              sum(counts[key] * ms for key, ms in best_ms.items())),
          flush=True)
    torch.cuda.empty_cache()

    bottleneck_ms, bottleneck_err = _bottleneck_shapes(rng, device, config)

    ms, plain_ms = conv_ms['3x3 s1 [8,120,160,128]->128']
    # int8 x, w in; scale, bias; int8 out; 2 ops per int8 MAC
    pixels = 8 * 120 * 160
    conv_bound = _bound(pixels * 128 * 2 + 128 * 9 * 128 + 128 * 8,
                        2 * pixels * 128 * 128 * 9, INT8_OPS_PER_MS)
    conv_record = {'name': 'conv_int8', 'route': 'cuda',
                   'source': CONV_SOURCE, 'replaces': CONV_REPLACES,
                   'launches': None, 'max_abs_err': float(conv_err),
                   'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': conv_bound[0], 'bound_by': conv_bound[1],
                   'library_ms': conv_lib[1]}
    ms, plain_ms = bottleneck_ms[(60, 80, 256)]
    fused_bound = _bound(*_bottleneck_ops((60, 80, 256)), INT8_OPS_PER_MS)
    bottleneck_record = {'name': 'bottleneck_int8', 'route': 'cuda',
                         'source': BOTTLENECK_SOURCE,
                         'replaces': BOTTLENECK_REPLACES, 'launches': None,
                         'max_abs_err': float(bottleneck_err), 'ms': ms,
                         'plain_ms': plain_ms, 'bound_ms': fused_bound[0],
                         'bound_by': fused_bound[1], 'library_ms': None}
    print('int8 bounds: conv 3x3 s1 [8,120,160,128]->128 {:.4f} ms ({}), '
          'bottleneck C=256 [8,60,80] {:.4f} ms ({}); library call: none '
          'for a 3x3 (PyTorch has no CUDA int8 convolution); the conv '
          'record\'s library_ms is torch._int_mm on the 1x1 512->256 int32 '
          'case ({:.4f} ms, the kernel {:.4f} ms there)'.format(
              conv_bound[0], conv_bound[1], fused_bound[0], fused_bound[1],
              conv_lib[1], conv_lib[0]), flush=True)
    return conv_record, bottleneck_record


def _int8_launches(detector, backend):
    """The exact (conv, bottleneck) kernel launches of the int8 chain over
    the main path's two batches (a 960x1280 and a 768x1280 canvas), as
    _expected_launches has them. Returns (want, a note on the routing)."""

    canvases = ((960, 1280), (768, 1280))
    want = _expected_launches(detector, {(8, h, w): 1 for h, w in canvases},
                              False, 0)[1:3]
    note = ', '.join('{}x{}: {} of {} bottlenecks fused'.format(
        h, w, r if backend != 'xla' else 0, n)
        for (h, w), (r, n) in _fused_per_batch(detector.config,
                                               canvases).items())
    return want, note


def phase_int8_main_path(device, workdir, float_path, pairs, batch,
                         profile=False):
    """The int8 chain through the port's entry points on the card, under
    both conv backends, and the forward's CUDA-event ms on [batch] (one
    960x1280 batch of 8); returns (int8 checkpoint path, {backend: (conv
    launches, bottleneck launches)}, {backend: images/s}, {backend:
    forward ms}, last detector, {backend: phase_program_cache's
    numbers})."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint

    q_path = os.path.join(workdir, 'md_smoke_int8.npz')
    start = time.time()
    calib = np.random.RandomState(1).uniform(
        0, 1, (2, 320, 320, 3)).astype(np.float32)
    quantize_checkpoint(float_path, q_path, calibration_images=calib,
                        device=device)
    print('int8 checkpoint: quantize_checkpoint calibrated on the card in '
          '{:.1f} s'.format(time.time() - start), flush=True)

    launches, rates, forward_ms, detections, programs = {}, {}, {}, {}, {}
    for backend in ('xla', 'pallas'):
        torch.cuda.reset_peak_memory_stats()
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend})
        want, routing = _int8_launches(detector, backend)

        results, counts, batches, rates[backend] = _eager_then_replayed(
            detector, pairs, 'int8 {}'.format(backend))
        got = counts[1:3]
        if batches != 2 or got != want:
            raise AssertionError(
                'int8 {}: {} batches (want 2), kernel launches (conv, '
                'bottleneck) {}, expected {} ({})'.format(
                    backend, batches, got, want, routing))
        launches[backend] = got
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_{}.json'.format(backend)))
        detections[backend] = results
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(device).float() / 255.0
            forward_ms[backend] = _time_ms(
                lambda: detector.model(x, decode=False), reps=5)
        print('int8 main path, conv_backend={}: 16 images, {} detections, '
              '{} device batches; conv kernel {} launches, bottleneck '
              'kernel {} ({}); {:.3f} images/s through '
              'load_and_run_detector_batch (third pass, replayed); forward '
              '{:.3f} ms per 960x1280 batch of 8 (eager)'.format(
                  backend, n_det, batches, got[0], got[1], routing,
                  rates[backend], forward_ms[backend]), flush=True)
        programs[backend] = phase_program_cache(detector, batch,
                                                'int8 ' + backend)
        if profile:
            _profile_both(detector, batch, 'int8 ' + backend)
    if detections['xla'] != detections['pallas']:
        raise AssertionError('int8 detections differ between the conv '
                             'backends')
    print('int8 detections identical under conv_backend xla and pallas',
          flush=True)
    return q_path, launches, rates, forward_ms, detector, programs


def phase_int8_card_vs_cpu(q_path, detector):
    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector

    x = np.random.RandomState(2).rand(2, 320, 320, 3).astype(np.float32)
    cpu = load_detector(q_path, device='cpu')
    with torch.inference_mode():
        ref = cpu.model(torch.from_numpy(x), decode=True).numpy()
        got = detector.model(torch.from_numpy(x).to(detector.device),
                             decode=True).cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError('int8 forward: shape {} vs {} or '
                             'non-finite'.format(got.shape, ref.shape))
    d_score = np.percentile(np.abs(got[..., 4:5] * got[..., 5:] -
                                   ref[..., 4:5] * ref[..., 5:]), 99)
    d_xy = np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99)
    if not (d_score < 0.02 and d_xy < 2.0):
        raise AssertionError('int8 card vs CPU: score p99 {} (limit 0.02), '
                             'xy p99 {} px (limit 2)'.format(d_score, d_xy))
    print('int8 card vs CPU yolov5l6 at 320 px: decoded score p99 |d| '
          '{:.3e} (limit 0.02), xy p99 |d| {:.3e} px (limit 2)'.format(
              d_score, d_xy), flush=True)


def _n_activated_convs(model):
    """Float convs with SiLU (every one runs the bf16 epilogue in bf16)."""

    from megadetector_tpu_torch.models.yolov5 import Conv

    return sum(1 for m in model.modules() if type(m) is Conv and m.act)


def phase_bf16_kernels(device, params):
    """Fused stem and bf16 epilogue vs their plain versions on the card at
    yolov5l6 shapes (960x1280 canvas, batch 8); returns their records."""

    import numpy as np
    import torch
    import torch.nn.functional as F

    from megadetector_tpu_torch.ops import l0_fused, silu_bf16

    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randint(0, 256, (8, 960, 1280, 3),
                                          dtype=np.uint8)).to(device)
    w, b = l0_fused.prepare_l0_weights(params['l0'])
    w, b = w.to(device), b.to(device)
    got = l0_fused.l0_fused(images, w, b)
    torch.cuda.synchronize()
    ref = l0_fused.l0_fused_reference(images, w, b)
    if tuple(got.shape) != (8, 480, 640, 64):
        raise AssertionError('stem kernel shape {}'.format(tuple(got.shape)))
    stem_differ, stem_err, stem_outside = l0_fused.plain_bar(got, ref)
    if stem_outside or stem_differ > l0_fused.DIFF_SHARE * got.numel():
        raise AssertionError(
            'stem kernel outside its bar against the plain version: {} of {} '
            'elements differ (at most {:g} allowed), {} by more than 1 bf16 '
            'ulp and {:g}; max |d| {:.3e}'.format(
                stem_differ, got.numel(), l0_fused.DIFF_SHARE * got.numel(),
                stem_outside, l0_fused.ABS_FLOOR, stem_err))
    stem_ms = _time_ms(lambda: l0_fused.l0_fused(images, w, b), reps=10)
    stem_plain_ms = _time_ms(
        lambda: l0_fused.l0_fused_reference(images, w, b), reps=2, warmup=1)
    # Yardstick: cuDNN's bf16 conv (+ bias) of the normalized batch
    x16 = (images.float() / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    w16 = torch.from_numpy(np.asarray(params['l0']['w'], np.float32)).permute(
        3, 2, 0, 1).to(torch.bfloat16).to(device).contiguous(
            memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)
    stem_lib_ms = _time_ms(lambda: F.conv2d(x16, w16, b16, 2, 2), reps=10)
    macs = 8 * 480 * 640 * 64 * 108
    stem_bound = _bound(images.numel() + got.numel() * 2 + w.numel() * 2 +
                        b.numel() * 4, 2 * macs, BF16_OPS_PER_MS)
    print('stem kernel within its bar of plain on u8 [8,960,1280,3] -> '
          '[8,480,640,64] bf16: {} of {} elements differ ({:.2e}; max |d| '
          '{:.3e}, none beyond 1 bf16 ulp or {:g}); kernel {:.4f} ms, plain '
          '{:.4f} ms, cuDNN bf16 conv of the normalized batch {:.4f} ms, '
          'bound {:.4f} ms ({}; {:.1f} G MAC)'.format(
              stem_differ, got.numel(), stem_differ / got.numel(), stem_err,
              l0_fused.ABS_FLOOR, stem_ms, stem_plain_ms, stem_lib_ms,
              stem_bound[0], stem_bound[1], macs / 1e9), flush=True)
    del images, got, ref, x16
    torch.cuda.empty_cache()

    silu_times = {}
    silu_err = 0.0
    for name, shape in (('l1 output [8,128,240,320]', (8, 128, 240, 320)),
                        ('[8,1024,15,20]', (8, 1024, 15, 20))):
        x = (torch.randn(shape, generator=torch.Generator().manual_seed(3))
             * 3).to(torch.bfloat16).to(device).contiguous(
                 memory_format=torch.channels_last)
        bias = (torch.rand(shape[1], generator=torch.Generator().manual_seed(
            4)) * 2 - 1).to(torch.bfloat16).to(device)
        for bias_arg in (bias, None):
            got = silu_bf16.silu_bf16(x, bias_arg)
            torch.cuda.synchronize()
            ref = silu_bf16.silu_bf16_reference(x, bias_arg)
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(
                    'bf16 epilogue disagrees with its plain version on {} '
                    '(bias {}): {} elements differ'.format(
                        name, bias_arg is not None, int((got != ref).sum())))
            silu_err = max(silu_err, float((got.float() - ref.float()).abs()
                                           .max()))
        ms = _time_ms(lambda: silu_bf16.silu_bf16(x, bias), reps=20)
        ms_nobias = _time_ms(lambda: silu_bf16.silu_bf16(x), reps=20)
        plain_ms = _time_ms(lambda: silu_bf16.silu_bf16_reference(x, bias),
                            reps=5, warmup=1)
        lib_ms = _time_ms(lambda: F.silu(x), reps=20)
        bound = _bound(x.numel() * 4 + bias.numel() * 2, x.numel() * 6,
                       F32_OPS_PER_MS)
        silu_times[name] = (ms, plain_ms, lib_ms, bound)
        print('bf16 epilogue == plain (bit-identical, with and without bias) '
              'on {} channels_last: kernel {:.4f} ms with bias ({:.4f} ms '
              'without), plain {:.4f} ms, F.silu {:.4f} ms, bound {:.4f} ms '
              '({})'.format(name, ms, ms_nobias, plain_ms, lib_ms, bound[0],
                            bound[1]), flush=True)
        del x, got, ref
        torch.cuda.empty_cache()

    stem_record = {'name': 'l0_fused', 'route': 'cuda',
                   'source': STEM_SOURCE, 'replaces': STEM_REPLACES,
                   'launches': None, 'max_abs_err': stem_err,
                   'ms': stem_ms, 'plain_ms': stem_plain_ms,
                   'bound_ms': stem_bound[0], 'bound_by': stem_bound[1],
                   'library_ms': stem_lib_ms}
    ms, plain_ms, lib_ms, bound = silu_times['l1 output [8,128,240,320]']
    silu_record = {'name': 'silu_bf16', 'route': 'cuda',
                   'source': SILU_SOURCE, 'replaces': SILU_REPLACES,
                   'launches': None, 'max_abs_err': silu_err, 'ms': ms,
                   'plain_ms': plain_ms, 'bound_ms': bound[0],
                   'bound_by': bound[1], 'library_ms': lib_ms}
    return stem_record, silu_record


def _reset_counts():
    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, gemm_int8, l0_fused,
                                            silu_bf16)

    for module in (bottleneck_int8, conv_int8, cuda_nms, gemm_int8,
                   l0_fused, silu_bf16):
        module.launches = 0
    conv_int8.exp_launches = 0


def _counts():
    """Launches since _reset_counts: (nms, conv, bottleneck, stem, silu)."""

    import torch

    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, l0_fused, silu_bf16)

    torch.cuda.synchronize()
    return (cuda_nms.launches, conv_int8.launches, bottleneck_int8.launches,
            l0_fused.launches, silu_bf16.launches)


def _eager_then_replayed(detector, pairs, label):
    """
    load_and_run_detector_batch over [pairs] at batch 8, three times. The
    first pass is each program's first call (eager), the second captures
    every program into a CUDA graph and replays it, and both are counted:
    their kernel launches (_counts) and device batches must be equal and
    their results identical. The third pass, all replays, is timed.
    Returns (results, launches, device batches, images/s of the third).
    """

    import torch

    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch

    passes = []
    for _ in range(2):
        detector.programs_run = 0
        _reset_counts()
        results = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                              quiet=True)
        passes.append((results, _counts(), detector.programs_run))
    (eager, eager_counts, batches), (replayed, counts, replayed_batches) = \
        passes
    if (counts, replayed_batches) != (eager_counts, batches):
        raise AssertionError(
            '{}: launches (nms, conv, bottleneck, stem, silu) and batches '
            'eager {} {}, replayed {} {}'.format(
                label, eager_counts, batches, counts, replayed_batches))
    if replayed != eager:
        raise AssertionError('{}: the replayed programs\' detections differ '
                             'from the eager programs\''.format(label))
    if detector._programs.replays == 0:
        raise AssertionError('{}: no program was replayed'.format(label))
    start = time.time()
    load_and_run_detector_batch(detector, pairs, batch_size=8, quiet=True)
    torch.cuda.synchronize()
    rate = len(pairs) / (time.time() - start)
    print('{}: replayed programs identical to eager over {} images ({} '
          'graphs captured, {} replays); launches equal in both passes'
          .format(label, len(pairs), detector._programs.captures,
                  detector._programs.replays), flush=True)
    return eager, eager_counts, batches, rate


def _copy_ms(batch):
    """(pageable, pinned) ms of the host -> device copy of [batch]."""

    import torch

    pageable = torch.from_numpy(batch)
    pinned = torch.empty(pageable.shape, dtype=pageable.dtype,
                         pin_memory=True)
    pinned.copy_(pageable)
    dst = torch.empty(pageable.shape, dtype=pageable.dtype, device='cuda')
    return (_time_ms(lambda: dst.copy_(pageable), reps=10),
            _time_ms(lambda: dst.copy_(pinned, non_blocking=True), reps=10))


def phase_program_cache(detector, batch, label):
    """
    16. The program cache on [batch] (a 960x1280 batch of 8; phase 22
    gives each family's own canvas), after the configuration's main path:
    the device program eager (_cuda_graphs off) and replayed must give
    identical outputs at the same capacity; CUDA-event ms of the forward
    and of selection + NMS at that capacity, eager and replayed (the graph
    alone); wall ms of the whole program (copy in, escalation read,
    outputs read) both ways; the peak device memory since the
    configuration's detector was loaded. Returns those numbers.
    """

    import numpy as np
    import torch

    b, h, w = batch.shape[:3]
    detector._cuda_graphs = False
    eager, topk = detector.run_program(batch, 0.005, 0.45)
    detector._cuda_graphs = True
    for _ in range(3):
        replayed, capacity = detector.run_program(batch, 0.005, 0.45)
        if capacity != topk or sorted(replayed) != sorted(eager) or any(
                not np.array_equal(replayed[k], eager[k]) for k in eager):
            raise AssertionError('{}: the replayed program differs from '
                                 'the eager one'.format(label))

    def program_ms(graphs, reps=5):
        detector._cuda_graphs = graphs
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / reps

    key = ('forward', b, h, w, detector._fused_decode)
    forward = detector._programs.entries[key]
    select = detector._programs.entries[key + ('select', topk, 0.005, 0.45)]
    x = torch.from_numpy(batch).to(detector.device)
    with torch.inference_mode():
        heads = detector._forward(x)
        numbers = {
            'forward_eager': _time_ms(lambda: detector._forward(x), reps=5),
            'forward_replay': _time_ms(forward.graph.replay, reps=5),
            'select_eager': _time_ms(lambda: detector._select_and_suppress(
                topk, 0.005, 0.45, *heads), reps=5),
            'select_replay': _time_ms(select.graph.replay, reps=5)}
    del heads, x
    numbers['program_eager'] = program_ms(False)
    numbers['program_replay'] = program_ms(True)
    numbers['peak_allocated_gb'] = torch.cuda.max_memory_allocated() / 1e9
    numbers['peak_reserved_gb'] = torch.cuda.max_memory_reserved() / 1e9
    print('program cache, {}, {}x{} batch of {} (capacity {}): replay '
          'identical to eager; forward {:.3f} ms eager, {:.3f} replayed; '
          'select + NMS {:.3f} / {:.3f}; whole program (copy in, reads) '
          '{:.3f} ms eager, {:.3f} replayed; {} graphs; peak device memory '
          '{:.2f} GB allocated, {:.2f} GB reserved'.format(
              label, h, w, b, topk, numbers['forward_eager'],
              numbers['forward_replay'], numbers['select_eager'],
              numbers['select_replay'], numbers['program_eager'],
              numbers['program_replay'], detector._programs.captures,
              numbers['peak_allocated_gb'], numbers['peak_reserved_gb']),
          flush=True)
    return numbers


def _pass_launches(detector):
    """Per-model-call launch deltas of an eager program (forward hooks on
    the network; a replay runs no hook)."""

    from megadetector_tpu_torch.models import program_cache

    calls = []
    before = []

    def pre(module, inputs):
        before.append(program_cache.read_counters())

    def post(module, inputs, output):
        calls.append([a - b for a, b in zip(program_cache.read_counters(),
                                            before.pop())])

    hooks = [detector.model.register_forward_pre_hook(pre),
             detector.model.register_forward_hook(post)]
    return calls, hooks


def phase_tta(device, workdir, float_path, q_path, pairs, batch,
              canvases=((960, 1280), (768, 1280))):
    """
    17. Test-time augmentation: augment=True through
    load_and_run_detector_batch over the 16 images, yolov5l6 at full
    width, float32, int8 under pallas and bf16: an eager pass whose model
    calls are counted pass by pass (each kernel's launches per TTA pass
    exact: NMS once a batch on the merged candidates; the int8 kernels per
    pass canvas as routing fuses; the stem on pass 1 only, the bf16
    epilogue after every activated conv but pass 1's l0), then a replayed
    pass with the same launches and identical detections; the MD JSON is
    checked; wall ms of the augment program against the plain program on
    [batch], both replayed; then TTA on the card against the CPU at 320
    px, batch 2, within phase 5's bar (float32) and phases 8 and 13's
    (int8, bf16). [canvases]: the canvases of [pairs]' two batches, in the
    order they run.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models.detector import (
        tta_concatenated_predictions, tta_passes)

    configs = (('float32', float_path, {}),
               ('int8 pallas', q_path, {'conv_backend': 'pallas'}),
               ('bf16', float_path, {'dtype': 'bfloat16'}))
    ms = {}
    for label, path, options in configs:
        torch.cuda.reset_peak_memory_stats()
        detector = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8))
        model = detector.model
        # Expected launches a model call, by pass canvas: (nms, conv,
        # bottleneck, stem, silu)
        want = {}
        for h, w in canvases:
            for i, (_, _, _, _, ph, pw) in enumerate(
                    tta_passes(h, w, detector.letterbox_stride)):
                want[(h, w, i)] = (0,) + _pass_expected(detector, 8, ph, pw,
                                                        i == 0)
        calls, hooks = _pass_launches(detector)
        detector.programs_run = 0
        _reset_counts()
        eager = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                            quiet=True, augment=True)
        eager_counts = _counts()
        for hook in hooks:
            hook.remove()
        got = [tuple(c[i] for i in (0, 1, 3, 4, 5)) for c in calls]
        expected = [want[(h, w, i)] for h, w in canvases for i in range(3)]
        if detector.programs_run != 2 or got != expected or \
                eager_counts[0] != 2:
            raise AssertionError(
                'TTA {}: {} programs; launches per pass (nms, conv, '
                'bottleneck, stem, silu) {}, expected {}; NMS {}'.format(
                    label, detector.programs_run, got, expected,
                    eager_counts[0]))
        _reset_counts()
        replayed = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                               quiet=True, augment=True)
        if _counts() != eager_counts or replayed != eager:
            raise AssertionError('TTA {}: replayed launches {} vs eager {}, '
                                 'or detections differ'.format(
                                     label, _counts(), eager_counts))
        n_det = _write_and_check(eager, pairs, path, os.path.join(
            workdir, 'smoke_tta_{}.json'.format(label.replace(' ', '_'))))

        def wall(augment, reps=3):
            detector.run_program(batch, 0.005, 0.45, augment=augment)
            detector.run_program(batch, 0.005, 0.45, augment=augment)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(reps):
                detector.run_program(batch, 0.005, 0.45, augment=augment)
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3 / reps

        ms[label] = (wall(True), wall(False))
        print('TTA {}: 16 images, {} detections, 2 augment programs; '
              'launches per pass (nms, conv, bottleneck, stem, silu) at '
              '{}x{}: {}, at {}x{}: {}, NMS once a batch; replayed identical '
              'to eager; augment program {:.3f} ms, plain program {:.3f} ms '
              '(x{:.2f}) on a {}x{} batch of {}, replayed; peak device '
              'memory {:.2f} GB allocated, {:.2f} GB reserved'.format(
                  label, n_det, *canvases[0], expected[:3], *canvases[1],
                  expected[3:], ms[label][0],
                  ms[label][1], ms[label][0] / ms[label][1],
                  *batch.shape[1:3], batch.shape[0],
                  torch.cuda.max_memory_allocated() / 1e9,
                  torch.cuda.max_memory_reserved() / 1e9), flush=True)

        # Card against the CPU at 320 px, batch 2
        x = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (2, 320, 320, 3), dtype=np.uint8))
        cpu = load_detector(path, device='cpu', detector_options=options)
        dtype = detector.compute_dtype
        with torch.inference_mode():
            ref = tta_concatenated_predictions(
                detector.config, cpu.model, x, 320, 320, 64, dtype).numpy()
            got_pred = tta_concatenated_predictions(
                detector.config, model, x.to(device), 320, 320, 64,
                dtype).cpu().numpy()
        if got_pred.shape != ref.shape or not np.isfinite(got_pred).all():
            raise AssertionError('TTA {} card vs CPU: shape {} vs {} or '
                                 'non-finite'.format(label, got_pred.shape,
                                                     ref.shape))
        score = (lambda p: p[..., 4:5] * p[..., 5:])
        d_score = np.abs(score(got_pred) - score(ref))
        d_xy = np.abs(got_pred[..., :2] - ref[..., :2])
        if label == 'float32':
            worst = max(d_score.max() / np.abs(score(ref)).max(),
                        d_xy.max() / np.abs(ref[..., :2]).max())
            if worst > 1e-3:
                raise AssertionError('TTA float32 card vs CPU: max |d| / '
                                     'max |ref| {} (limit 1e-3)'.format(worst))
            note = 'max |d| / max |ref| {:.3e} (limit 1e-3)'.format(worst)
        else:
            p_score = np.percentile(d_score, 99)
            p_xy = np.percentile(d_xy, 99)
            if not (p_score < 0.02 and p_xy < 2.0):
                raise AssertionError('TTA {} card vs CPU: score p99 {} '
                                     '(limit 0.02), xy p99 {} px (limit 2)'
                                     .format(label, p_score, p_xy))
            note = 'score p99 |d| {:.3e} (limit 0.02), xy p99 |d| {:.3e} ' \
                'px (limit 2)'.format(p_score, p_xy)
        print('TTA {} card vs CPU at 320 px, batch 2 (decoded, three '
              'passes): {}'.format(label, note), flush=True)
        del detector, model, cpu
        torch.cuda.empty_cache()


def _forward_ms(detector, batch):
    import torch

    with torch.inference_mode():
        x = torch.from_numpy(batch).to(detector.device)
        return _time_ms(lambda: detector.model(x, decode=False), reps=5)


def phase_bf16_main_path(device, workdir, float_path, pairs, batch):
    """The bf16 configuration through the port's entry points; returns
    (stem launches, epilogue launches, images/s, forward ms, detector)."""

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector

    torch.cuda.reset_peak_memory_stats()
    detector = load_detector(float_path, device=device, detector_options={
        'pad_batches_to': 8, 'dtype': 'bfloat16'})
    n_epilogue = _n_activated_convs(detector.model) - 1
    results, counts, batches, rate = _eager_then_replayed(
        detector, pairs, 'bf16 main path')
    nms, conv, fused, stem, silu = counts
    if batches < 2 or stem != batches or silu != n_epilogue * batches or \
            nms < batches or conv or fused:
        raise AssertionError(
            'bf16 main path: {} batches; launches nms {}, stem {} (want {}), '
            'bf16 epilogue {} (want {} x {}), int8 {} {}'.format(
                batches, nms, stem, batches, silu, n_epilogue, batches, conv,
                fused))
    n_det = _write_and_check(results, pairs, float_path, os.path.join(
        workdir, 'smoke_bf16.json'))
    fwd = _forward_ms(detector, batch)
    print('bf16 main path: 16 images, {} detections, {} device batches; stem '
          'kernel {} launches (1 x {}), bf16 epilogue {} ({} activated convs '
          'after l0 x {}), NMS {}; {:.3f} images/s through '
          'load_and_run_detector_batch (third pass, replayed); forward '
          '{:.3f} ms per 960x1280 batch of 8 (uint8 in, eager)'.format(
              n_det, batches, stem, batches, silu, n_epilogue, batches, nms,
              rate, fwd), flush=True)
    phase_program_cache(detector, batch, 'bf16')
    return stem, silu, rate, fwd, detector


def phase_int8_bf16_main_path(device, workdir, q_path, pairs, batch):
    """int8 with dtype bf16 (bf16 l0 and heads around the int8 chain)
    under both conv backends; returns {backend: images/s}, {backend:
    forward ms}."""

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector

    rates, forward_ms, detections = {}, {}, {}
    for backend in ('xla', 'pallas'):
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend,
            'dtype': 'bfloat16'})
        (want_conv, want_fused), routing = _int8_launches(detector,
                                                          backend)
        results, counts, batches, rates[backend] = _eager_then_replayed(
            detector, pairs, 'int8 + bf16 {}'.format(backend))
        nms, conv, fused, stem, silu = counts
        if batches != 2 or (conv, fused, stem, silu) != (
                want_conv, want_fused, batches, 0) or nms < batches:
            raise AssertionError(
                'int8 + bf16 {}: {} batches (want 2); launches conv {} (want '
                '{}), bottleneck {} (want {}; {}), stem {}, bf16 epilogue {}'
                ', nms {}'.format(backend, batches, conv, want_conv, fused,
                                  want_fused, routing, stem, silu, nms))
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_bf16_{}.json'.format(backend)))
        detections[backend] = results
        forward_ms[backend] = _forward_ms(detector, batch)
        print('int8 + bf16 main path, conv_backend={}: {} detections, {} '
              'batches; stem {} launches, conv {}, bottleneck {}, bf16 '
              'epilogue {}; {:.3f} images/s (third pass, replayed); forward '
              '{:.3f} ms per 960x1280 batch of 8 (eager)'.format(
                  backend, n_det, batches, stem, conv, fused, silu,
                  rates[backend], forward_ms[backend]), flush=True)
        del detector
        torch.cuda.empty_cache()
    if detections['xla'] != detections['pallas']:
        raise AssertionError('int8 + bf16 detections differ between the '
                             'conv backends')
    return rates, forward_ms


def _exact_canvas_images(rng, n=8):
    """n seeded uint8 images of exactly 960x1280, the auto canvas of a
    4:3 image at 1280 px: the device-preprocess identity path."""

    import numpy as np

    images = []
    for i in range(n):
        yy = np.linspace(0, 255, 960, dtype=np.float32)[:, None, None]
        img = yy + rng.randint(-30, 30, (960, 1280, 3)) + 10 * i
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def phase_device_preprocess(device, workdir, float_path, pairs,
                            image_size=1280, stride=64):
    """preprocess_mode=device for float32 and bf16; returns {dtype:
    images/s}."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.ops import boxes, preprocess_device

    # The device letterbox against the host letterbox's canvas
    worst = 0.0
    canvases = []
    for shape in sorted({img.shape[:2] for _, img in pairs}):
        imgs = [img for _, img in pairs if img.shape[:2] == shape]
        staged, sizes = preprocess_device.stage_images(imgs, multiple=256)
        canvas = boxes.auto_target_shape(shape, image_size, stride=stride)
        canvases.append('{}x{}'.format(*canvas))
        with torch.inference_mode():
            out = preprocess_device.letterbox_batch(
                torch.from_numpy(staged).to(device),
                torch.from_numpy(sizes).to(device), canvas,
                scale_target=image_size).cpu().numpy() * 255.0
        for img, got in zip(imgs, out):
            host = boxes.letterbox(img, (image_size, image_size),
                                   stride=stride, auto=True)[0]
            if host.shape != got.shape:
                raise AssertionError('device canvas {} vs host {}'.format(
                    got.shape, host.shape))
            worst = max(worst, float(np.abs(got - host).max()))
    if worst > 2.0:
        raise AssertionError('device letterbox vs host letterbox: max |d| '
                             '{} levels (limit 2)'.format(worst))
    print('device letterbox vs host letterbox canvases ({}): max |d| {:.3f} '
          'of 255 (limit 2; cv2 rounds its bilinear to uint8)'.format(
              ', '.join(canvases), worst), flush=True)

    exact = _exact_canvas_images(np.random.RandomState(7))
    all_pairs = pairs + [('smoke/exact_{:02d}.jpg'.format(i), img)
                         for i, img in enumerate(exact)]
    rates = {}
    for dtype in ('float32', 'bfloat16'):
        detector = load_detector(float_path, device=device, detector_options={
            'pad_batches_to': 8, 'preprocess_mode': 'device',
            'dtype': dtype})
        n_act = _n_activated_convs(detector.model)
        detector.identity_programs_run = 0
        results, counts, batches, rates[dtype] = _eager_then_replayed(
            detector, all_pairs, 'device preprocess {}'.format(dtype))
        nms, conv, fused, stem, silu = counts
        # The identity batch ran in both counted passes
        detector.identity_programs_run //= 2
        want_silu = n_act * batches if dtype == 'bfloat16' else 0
        if batches < 3 or detector.identity_programs_run < 1 or stem or \
                silu != want_silu or nms < batches:
            raise AssertionError(
                'device preprocess {}: {} batches ({} identity); launches '
                'stem {} (want 0), bf16 epilogue {} (want {}), nms {}'.format(
                    dtype, batches, detector.identity_programs_run, stem,
                    silu, want_silu, nms))
        n_det = _write_and_check(results, all_pairs, float_path,
                                 os.path.join(workdir, 'smoke_device_{}.json'
                                              .format(dtype)))
        print('device preprocess, {}: 24 images, {} detections, {} batches '
              '({} on the identity path); bf16 epilogue {} launches, stem {}, '
              'NMS {}; {:.3f} images/s through load_and_run_detector_batch '
              '(third pass, replayed)'.format(dtype, n_det, batches,
                                     detector.identity_programs_run, silu,
                                     stem, nms, rates[dtype]), flush=True)
        del detector
        torch.cuda.empty_cache()
    return rates


def phase_bf16_card_vs_cpu(detector, config, params):
    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import YoloV5

    x = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 320, 320, 3), dtype=np.uint8))
    cpu_model = YoloV5(config).load_params(params).set_compute_dtype(
        torch.bfloat16, fused_stem=True).eval()
    with torch.inference_mode():
        ref = cpu_model(x, decode=True).numpy()
        got = detector.model(x.to(detector.device),
                             decode=True).cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError('bf16 forward: shape {} vs {} or non-finite'
                             .format(got.shape, ref.shape))
    d_score = np.percentile(np.abs(got[..., 4:5] * got[..., 5:] -
                                   ref[..., 4:5] * ref[..., 5:]), 99)
    d_xy = np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99)
    if not (d_score < 0.02 and d_xy < 2.0):
        raise AssertionError('bf16 card vs CPU: score p99 {} (limit 0.02), '
                             'xy p99 {} px (limit 2)'.format(d_score, d_xy))
    print('bf16 card vs CPU yolov5l6 at 320 px: decoded score p99 |d| '
          '{:.3e} (limit 0.02), xy p99 |d| {:.3e} px (limit 2)'.format(
              d_score, d_xy), flush=True)


def _profile_both(detector, batch, label):
    """phase_profile of the replayed program, then of the eager one."""

    phase_profile(detector, batch, label + ' (replayed)')
    detector._cuda_graphs = False
    try:
        phase_profile(detector, batch, label + ' (eager)')
    finally:
        detector._cuda_graphs = True


def phase_profile(detector, batch, label):
    """torch.profiler over one device program (forward, selection, NMS)
    on [batch] (a 960x1280 batch of 8): device time by kernel, the idle
    share, and the port's kernels, whose profiled launches must equal the
    launches their wrappers counted in that program.

    The window holds two runs of the program and only the second is read
    (the device activities that start inside its record_function range):
    in a process that has worked for minutes, the profiler drops the
    device activities of a window's first milliseconds (a one-kernel
    window records nothing; of two programs only the second one's stem
    and host-to-device copy), which is why earlier tables lacked the
    fused stem."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, l0_fused, silu_bf16)

    modules = {'nms_mask_kernel': cuda_nms, 'nms_sweep_kernel': cuda_nms,
               'conv_int8_kernel': conv_int8,
               'bottleneck_int8_kernel': bottleneck_int8,
               'l0_fused_kernel': l0_fused, 'silu_bf16': silu_bf16}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        before = {name: m.launches for name, m in modules.items()}
        with record_function('measured program'):
            start = time.time()
            detector.run_program(batch, 0.005, 0.45)
            torch.cuda.synchronize()
            wall_ms = (time.time() - start) * 1e3
    counted = {name: m.launches - before[name] for name, m in modules.items()}

    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == 'measured program' and
                  e.device_type == DeviceType.CPU)
    # Device activities (kernels, copies) of the measured program, by
    # name; the range's own device-side annotation and the profiler's
    # buffer requests are not work of it
    by_name = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and
                window.start <= e.time_range.start <= window.end and
                e.name != 'measured program' and
                not e.name.startswith('Activity Buffer')):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print('profile, {} device program on a 960x1280 batch of 8: wall '
          '{:.3f} ms (profiler on), device busy {:.3f} ms, idle share '
          '{:.3f}'.format(label, wall_ms, busy_ms, 1.0 - busy_ms / wall_ms),
          flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :16]:
        print('  {:>9.3f} ms  {:>5d} x  {}'.format(us / 1e3, n, name[:90]),
              flush=True)
    # The port's kernels, every instance of a template summed
    sums = {}
    for key, (us, n) in by_name.items():
        for name in PORT_KERNELS:
            if re.search(r'(^|[\s:]){}[<(]'.format(name), key):
                ms, count = sums.get(name, (0.0, 0))
                sums[name] = (ms + us / 1e3, count + n)
    print('  the port\'s kernels: {}'.format(', '.join(
        '{} {:.3f} ms over {} launches'.format(name, ms, n)
        for name, (ms, n) in sorted(sums.items()))), flush=True)
    # silu_bf16 launches one of its two kernels a call
    sums['silu_bf16'] = (0.0, sum(sums.get(name, (0.0, 0))[1] for name in (
        'silu_bf16_vec8_kernel', 'silu_bf16_kernel')))
    missing = {name: (n, sums.get(name, (0.0, 0))[1])
               for name, n in counted.items()
               if sums.get(name, (0.0, 0))[1] != n}
    if missing:
        raise AssertionError('{} profile: kernel launches counted vs '
                             'profiled {}'.format(label, missing))


def _uniform(rng, device, shape, lo, hi):
    import numpy as np
    import torch

    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
        np.float32)).to(device)


def phase_exp_kernels(device):
    """The experiments' conv (E1-E4) and GEMM (E5, E6) kernels vs their
    plain versions on the card; returns {label: record} without launches."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.experiments import _harness
    from megadetector_tpu_torch.ops import conv_int8, gemm_int8

    rng = np.random.RandomState(14)
    epilogues = sorted(conv_int8.EXP_EPILOGUES)
    conv_ms, conv_err, conv_lib = {}, {}, {}
    for h, w, c in ((120, 160, 128), (60, 80, 256), (30, 40, 512)):
        x = _int8_input(rng, device, (8, h, w, c))
        w_hwio = torch.from_numpy(rng.randint(-127, 128, (3, 3, c, c))
                                  .astype(np.int8))
        wk = conv_int8.prepare_weight(w_hwio).to(device)
        w_hwio = w_hwio.to(device)
        level = '[8,{},{},{}]'.format(h, w, c)
        for scales in ((1e-6, 4e-6), (1e-4, 4e-4)):
            scale = _uniform(rng, device, (c,), *scales)
            bias = _uniform(rng, device, (c,), -0.5, 0.5)
            for ratio in (0.8531, 1.0):
                for epilogue in epilogues:
                    args = (x, wk, scale, bias, ratio, 0.043, epilogue)
                    got = conv_int8.conv3x3_int8_exp(*args)
                    torch.cuda.synchronize()
                    ref = conv_int8.conv3x3_int8_exp_reference(*args)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            'experiments\' conv kernel disagrees with its '
                            'plain version on {} {} in_ratio {} scales {}: '
                            '{} of {} elements differ'.format(
                                level, epilogue, ratio, scales,
                                int((got != ref).sum()), got.numel()))
                    conv_err[epilogue] = max(conv_err.get(epilogue, 0), int(
                        (got.int() - ref.int()).abs().max()))
                    if scales[0] == 1e-4:
                        conv_ms[(level, epilogue, ratio)] = (
                            _time_ms(lambda: conv_int8.conv3x3_int8_exp(
                                *args), reps=10),
                            _time_ms(lambda: conv_int8.
                                     conv3x3_int8_exp_reference(*args),
                                     reps=2, warmup=1))
        # yardsticks at the experiments' scales, f32 at in_ratio 0.8531
        args = (x, w_hwio, scale, bias, 0.8531, 0.043, 'f32')
        im2col_ms = _time_ms(lambda: _harness.im2col_conv_exp(*args),
                             reps=5)
        b2_ms = _time_ms(lambda: conv_int8.conv_int8(
            conv_int8.requant_input_reference(x, 0.8531), wk, scale, bias,
            (1, 1), (1, 1, 1, 1), 0.043), reps=5)
        patches = _harness.im2col_patches(x)
        w2d = w_hwio.reshape(9 * c, c)
        conv_lib[level] = _time_ms(lambda: torch._int_mm(patches, w2d),
                                   reps=10)
        for ratio in (0.8531, 1.0):
            print('exp conv kernel == plain on {} in_ratio {}: {}'.format(
                level, ratio, ', '.join(
                    '{} {:.4f} ms (plain {:.4f})'.format(
                        e, *conv_ms[(level, e, ratio)]) for e in epilogues)),
                flush=True)
        print('  yardsticks on {}: im2col + torch._int_mm + plain f32 '
              'epilogue {:.4f} ms, requant pass + B2 {:.4f} ms, torch._int_mm '
              'of the materialized patches alone {:.4f} ms'.format(
                  level, im2col_ms, b2_ms, conv_lib[level]), flush=True)
        del x, wk, w_hwio, got, ref, patches
        torch.cuda.empty_cache()

    gemm, gemm_err = {}, {}
    for m, k, n in GEMM_SHAPES:
        a = _int8_input(rng, device, (m, k))
        b = _int8_input(rng, device, (k, n))
        times, graph_ms = {}, {}
        for requant in (None, 3e-4):
            got = gemm_int8.gemm_int8(a, b, requant)
            torch.cuda.synchronize()
            ref = gemm_int8.gemm_int8_reference(a, b, requant)
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(
                    'GEMM kernel disagrees with its plain version at {}x{}x{}'
                    ' ({}): {} of {} elements differ'.format(
                        m, k, n, 'int32' if requant is None else 'int8',
                        int((got != ref).sum()), got.numel()))
            gemm_err[(m, k, n)] = max(gemm_err.get((m, k, n), 0), int(
                (got.long() - ref.long()).abs().max()))
            times[requant] = (
                _time_ms(lambda: gemm_int8.gemm_int8(a, b, requant), reps=10),
                _time_ms(lambda: gemm_int8.gemm_int8_reference(a, b, requant),
                         reps=2, warmup=1))
            graph_ms[requant] = _graph_ms(
                lambda: gemm_int8.gemm_int8(a, b, requant))
            del got, ref
        lib_ms = _time_ms(lambda: torch._int_mm(a, b), reps=10)
        gemm[(m, k, n)] = (times, lib_ms)
        bounds = {requant: _gemm_bound(m, k, n, requant)
                  for requant in (None, 3e-4)}
        tiling = gemm_int8.gemm_tiling(m, k, n)
        print('GEMM kernel == plain at {}x{}x{} ({} tiles of 128x128, grid '
              '{}), ms a call back to back (device ms replayed from a CUDA '
              'graph): int32 {:.4f} ({:.4f}; plain {:.4f}; bound {:.4f} ms '
              'of {}, share {:.3f} of the device ms), fused int8 {:.4f} '
              '({:.4f}; plain {:.4f}; bound {:.4f} ms of {}, share {:.3f}); '
              'torch._int_mm {:.4f} ms'.format(
                  m, k, n, tiling.tiles, tiling.grid, times[None][0],
                  graph_ms[None], times[None][1], *bounds[None],
                  bounds[None][0] / graph_ms[None], times[3e-4][0],
                  graph_ms[3e-4], times[3e-4][1], *bounds[3e-4],
                  bounds[3e-4][0] / graph_ms[3e-4], lib_ms), flush=True)
        del a, b
        torch.cuda.empty_cache()

    records = {}
    # conv: int8 x, w in, scale, bias; int8 out; 2 ops per int8 MAC
    pixels = 8 * 120 * 160
    conv_bound = _bound(pixels * 128 * 2 + 9 * 128 * 128 + 128 * 8,
                        2 * pixels * 128 * 128 * 9, INT8_OPS_PER_MS)
    for label in ('E1', 'E2', 'E3', 'E4'):
        name, source, replaces, (epilogue, ratio), _ = EXPERIMENTS[label]
        ms, plain_ms = conv_ms[('[8,120,160,128]', epilogue, ratio)]
        records[label] = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None,
            'max_abs_err': float(conv_err[epilogue]), 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': conv_bound[0],
            'bound_by': conv_bound[1],
            'library_ms': conv_lib['[8,120,160,128]']}
    for label, (m, k, n) in (('E5', GEMM_SHAPES[0]), ('E6', GEMM_SHAPES[1])):
        name, source, replaces, _, _ = EXPERIMENTS[label]
        times, lib_ms = gemm[(m, k, n)]
        bound = _gemm_bound(m, k, n, None)
        records[label] = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None,
            'max_abs_err': float(gemm_err[(m, k, n)]), 'ms': times[None][0], 'plain_ms': times[None][1],
            'bound_ms': bound[0], 'bound_by': bound[1], 'library_ms': lib_ms}
    fused_bound = _gemm_bound(*GEMM_SHAPES[0], 3e-4)
    print('experiment bounds: conv 3x3 [8,120,160,128]->128 {:.4f} ms ({}); '
          'GEMM 65536x1152x1152 int32 {:.4f} ms ({}), fused int8 {:.4f} ms '
          '({}); 38400x2304x256 int32 {:.4f} ms ({}); library call: '
          'torch._int_mm (for the conv: of the materialized im2col patches, '
          'no epilogue)'.format(
              conv_bound[0], conv_bound[1], records['E5']['bound_ms'],
              records['E5']['bound_by'], fused_bound[0], fused_bound[1],
              records['E6']['bound_ms'], records['E6']['bound_by']),
          flush=True)
    return records


def phase_experiments():
    """The six experiment entry points through main() at batch 8; returns
    {label: launches of its kernel}."""

    import importlib

    import torch

    from megadetector_tpu_torch.experiments import _harness
    from megadetector_tpu_torch.ops import (bottleneck_int8, cuda_nms,
                                            l0_fused, silu_bf16)

    launches = {}
    for label, (_, source, _, _, module_name) in EXPERIMENTS.items():
        module = importlib.import_module(
            'megadetector_tpu_torch.experiments.' + module_name)
        kernel = 'gemm_int8' if source == GEMM_SOURCE else 'conv3x3_int8_exp'
        _reset_counts()
        result = module.main(['--batch', '8', '--chain', '2', '--iters', '2'])
        torch.cuda.synchronize()
        totals = _harness.launch_counts()
        others = (cuda_nms.launches, bottleneck_int8.launches,
                  l0_fused.launches, silu_bf16.launches)
        for rec in result['records']:
            want = {k: rec['calls'] * rec['expect'].get(k, 0)
                    for k in _harness.KERNELS}
            if rec['launches'] != want:
                raise AssertionError('{} {}: launches {}, expected {}'.format(
                    label, rec['name'], rec['launches'], want))
        summed = {k: sum(r['launches'][k] for r in result['records'])
                  for k in _harness.KERNELS}
        if summed != totals or any(others) or totals[kernel] == 0:
            raise AssertionError(
                '{}: launches {} in the run, {} in its variants, others {}'
                .format(label, totals, summed, others))
        launches[label] = totals[kernel]
        print('{} entry point {}: {} variants, launches {} (each variant '
              'exactly its declared kernels once per step)'.format(
                  label, module_name, len(result['records']), totals),
              flush=True)
    return launches


def _write_folder(folder, images, names, quality=90):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = []
    for img, name in zip(images, names):
        path = os.path.join(folder, name)
        Image.fromarray(img).save(path, quality=quality)
        paths.append(path)
    return paths


def _extra_folder(folder, rng):
    """One JPEG with EXIF orientation 6 (stored turned; 1536x2048 once
    rotated), one grayscale 1536x2048 JPEG and one file that is no
    JPEG: the native and PIL paths' rotation and failure cases. Returns
    the folder and the (height, width) both images load at."""

    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    img = _synthetic_images(rng)[0]
    exif = Image.Exif()
    exif[274] = 6
    # PIL's orientation 6 turns the stored image by 270 degrees
    Image.fromarray(np.rot90(img, k=1).copy()).save(
        os.path.join(folder, 'rotated.jpg'), quality=90,
        exif=exif.tobytes())
    Image.fromarray(img[..., 1]).save(os.path.join(folder, 'gray.jpg'),
                                      quality=90)
    with open(os.path.join(folder, 'corrupt.jpg'), 'wb') as f:
        f.write(b'\xff\xd8 this is no jpeg')
    return folder, img.shape[:2]


def _folder_run_costs(detector, folder, buckets, infos, ceiling):
    """Where phase 18's bf16 time goes, each printed: the ceiling's batch
    against run_program alone (the rest is the host's stack and MD
    emission), thread x8 with cv2's own thread pool cut to one thread,
    the 64 decoded images as in-memory pairs (letterbox only) on one and
    eight threads, a call's fixed cost against its cost an image (the
    folder once and twice over) in thread and process mode, and
    process mode's fixed costs (a spawned pool of 8 answering 64 trivial
    calls; a worker's imports; one image's info pickled)."""

    import multiprocessing
    import pickle
    from concurrent.futures import ProcessPoolExecutor

    import cv2
    import numpy as np
    import torch

    from megadetector_tpu_torch.detection import run_detector_batch as rdb

    canvas = max(buckets)
    batch = np.stack([info['img_processed'] for info in buckets[canvas][:8]])
    detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    start = time.time()
    for _ in range(5):
        detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    program_ms = (time.time() - start) * 1e3 / 5
    print('folder run bf16: ceiling {:.3f} ms a batch of 8 through '
          'generate_detections_one_batch; run_program alone (copy in, '
          'replayed program, reads) {:.3f} ms on a {}x{} batch'.format(
              8e3 / ceiling, program_ms, *canvas), flush=True)

    def rate(items, warm=True, **kwargs):
        if warm:
            rdb.load_and_run_detector_batch(detector, items, batch_size=8,
                                            quiet=True, **kwargs)
        torch.cuda.synchronize()
        start = time.time()
        rdb.load_and_run_detector_batch(detector, items, batch_size=8,
                                        quiet=True, **kwargs)
        torch.cuda.synchronize()
        return len(items) / (time.time() - start)

    cv2_threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        one = rate(folder, loader_workers=8)
    finally:
        cv2.setNumThreads(cv2_threads)
    print('folder run bf16, thread x8 with cv2.setNumThreads(1) (default '
          '{}; torch intra-op threads {}): {:.3f} images/s'.format(
              cv2_threads, torch.get_num_threads(), one), flush=True)
    pairs = [(info['file'], info['img_original']) for info in infos]
    print('folder run bf16, the 64 images decoded in memory (letterbox '
          'only): {:.3f} images/s on one loader thread, {:.3f} on '
          'eight'.format(rate(pairs, loader_workers=1),
                         rate(pairs, loader_workers=8)), flush=True)
    del pairs

    # A call's fixed cost against its cost an image: the folder twice
    # over (128 images) beside the 64
    paths = [info['file'] for info in infos]
    for label, kwargs in (('thread x8', dict(loader_workers=8)),
                          ('process x8', dict(loader_workers=8,
                                              loader_pool_type='process'))):
        t64 = len(paths) / rate(paths, warm=False, **kwargs)
        t128 = 2 * len(paths) / rate(paths * 2, warm=False, **kwargs)
        per_image = (t128 - t64) / len(paths)
        print('folder run bf16, {}: 64 images in {:.3f} s, 128 in {:.3f} '
              's: {:.3f} ms an image ({:.3f} images/s) after a fixed {:.3f} '
              's a call'.format(label, t64, t128, per_image * 1e3,
                                1 / per_image, t64 - len(paths) * per_image),
              flush=True)
    code = ('import time; t = time.time(); import numpy, cv2, PIL.Image; '
            'import megadetector_tpu_torch.detection._loader_worker; '
            'print(time.time() - t)')
    imports_s = float(subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        check=True).stdout.strip())
    start = time.time()
    with ProcessPoolExecutor(max_workers=8, mp_context=multiprocessing
                             .get_context('spawn')) as pool:
        list(pool.map(abs, range(64)))
    pool_s = time.time() - start
    blob = pickle.dumps(('x', infos[0], False), protocol=-1)
    start = time.time()
    for _ in range(5):
        pickle.loads(pickle.dumps(('x', infos[0], False), protocol=-1))
    trip_ms = (time.time() - start) * 1e3 / 5
    print('folder run: process mode\'s fixed costs: a spawned pool of 8 '
          'answering 64 trivial calls {:.3f} s; a worker\'s imports '
          '(numpy, cv2, PIL, _loader_worker) {:.3f} s; one {}x{} image\'s '
          'info pickles to {:.1f} MB (canvas and full-size original), '
          'pickled and loaded in {:.3f} ms'.format(
              pool_s, imports_s, *infos[0]['scaling_shape'][:2],
              len(blob) / 1e6, trip_ms), flush=True)


def phase_folder_run(device, workdir, float_path, q_path, card):
    """
    18. The folder run: 64 JPEGs (quality 90; 32 at 1536x2048, 32 at
    1080x1920, from _synthetic_images with seed 18: four full batches of
    8 per canvas, so no tail bucket depends on arrival order) on disk,
    through load_and_run_detector_batch with yolov5l6 at full width (1280
    px auto canvases, batch 8). bf16 under every loader mode (thread 1, 4
    and 8; process 8; native thread 8 and native process 8), int8 pallas
    and float32 under thread 8. Each mode runs a pass that captures the
    programs, then a timed pass that replays them (their detections must
    be identical); its images/s is printed beside the ceiling: the
    replayed program's images/s on the same canvases with the letterboxed
    batches already in memory. Checks: PIL-decode detections identical
    across thread 1/4/8 and process 8 (and native thread against native
    process); the native loader's geometry (target_shape, ratio, pad)
    equal to PIL's, its canvases within 3 levels of PIL's with a mean
    under 0.5, no image handed to PIL; a rotated, a grayscale and a
    corrupt file give the serial path's failures and sizes in every mode.
    The native sub-phase runs when g++ and jpeglib.h are present, and is
    skipped with the reason otherwise.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch import native
    from megadetector_tpu_torch.detection import _loader_worker
    from megadetector_tpu_torch.detection import run_detector_batch as rdb
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    rng = np.random.RandomState(18)
    images = [img for _ in range(4) for img in _synthetic_images(rng)]
    folder = os.path.join(workdir, 'folder')
    start = time.time()
    paths = _write_folder(folder, images,
                          ['img_{:02d}.jpg'.format(i)
                           for i in range(len(images))])
    extra, (extra_h, extra_w) = _extra_folder(
        os.path.join(workdir, 'extra'), rng)
    del images
    print('folder run: wrote {} JPEGs (quality 90) in {:.1f} s'.format(
        len(paths), time.time() - start), flush=True)

    problem = native.toolchain_problem()
    if problem is None:
        start = time.time()
        native.load_library()
        print('folder run: native JPEG loader built in {:.1f} s'.format(
            time.time() - start), flush=True)
    else:
        print('folder run: native sub-phase skipped: {}'.format(problem),
              flush=True)
    host = 'os.cpu_count() {}, sched_getaffinity {}'.format(
        os.cpu_count(), len(os.sched_getaffinity(0)))

    modes = [('thread x1', dict(loader_workers=1)),
             ('thread x4', dict(loader_workers=4)),
             ('thread x8', dict(loader_workers=8)),
             ('process x8', dict(loader_workers=8,
                                 loader_pool_type='process'))]
    if problem is None:
        modes += [('native thread x8', dict(loader_workers=8,
                                            use_native_loader=True)),
                  ('native process x8', dict(loader_workers=8,
                                             loader_pool_type='process',
                                             use_native_loader=True))]
    configs = [('bf16', float_path, {'dtype': 'bfloat16'}, modes),
               ('int8 pallas', q_path, {'conv_backend': 'pallas'},
                modes[2:3]),
               ('float32', float_path, {}, modes[2:3])]

    infos = None
    numbers = {}
    for label, path, options, config_modes in configs:
        detector = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8))
        if infos is None:
            # The ceiling's letterboxed batches, and the serial host cost
            start = time.time()
            infos = [detector.preprocess_image(np.asarray(load_image(p)),
                                               image_id=p) for p in paths]
            pil_ms = (time.time() - start) * 1e3 / len(paths)
            buckets = {}
            for info in infos:
                buckets.setdefault(tuple(info['target_shape']),
                                   []).append(info)
            if sorted(len(b) for b in buckets.values()) != [32, 32]:
                raise AssertionError('canvases of the 64 JPEGs: {}'.format(
                    {k: len(b) for k, b in buckets.items()}))
        results = {}
        for mode, kwargs in config_modes:
            rdb.native_fallbacks = 0
            capture = rdb.load_and_run_detector_batch(
                detector, folder, batch_size=8, quiet=True, **kwargs)
            torch.cuda.synchronize()
            start = time.time()
            timed = rdb.load_and_run_detector_batch(
                detector, folder, batch_size=8, quiet=True, **kwargs)
            torch.cuda.synchronize()
            rate = len(paths) / (time.time() - start)
            if timed != capture:
                raise AssertionError('folder run {} {}: the timed pass\'s '
                                     'detections differ from the capture '
                                     'pass\'s'.format(label, mode))
            if any('failure' in r for r in timed) or \
                    sorted(r['file'] for r in timed) != sorted(paths):
                raise AssertionError('folder run {} {}: failures or missing '
                                     'images'.format(label, mode))
            if kwargs.get('use_native_loader') and rdb.native_fallbacks:
                raise AssertionError('folder run {} {}: {} images fell back '
                                     'to PIL'.format(label, mode,
                                                     rdb.native_fallbacks))
            results[mode] = timed
            numbers[(label, mode)] = rate

        # The ceiling: the same canvases, letterboxed, replayed
        def ceiling_pass():
            for bucket in buckets.values():
                for i in range(0, len(bucket), 8):
                    detector.generate_detections_one_batch(
                        bucket[i:i + 8], detection_threshold=0.005)
            torch.cuda.synchronize()

        ceiling_pass()
        start = time.time()
        ceiling_pass()
        ceiling = len(infos) / (time.time() - start)
        for mode, _ in config_modes:
            rate = numbers[(label, mode)]
            print('folder run {} on {}, {}: {:.3f} images/s through '
                  'load_and_run_detector_batch over 64 JPEGs; ceiling '
                  '{:.3f} images/s (the replayed program on the letterboxed '
                  'batches in memory); share {:.3f}; host {}'.format(
                      label, card, mode, rate, ceiling, rate / ceiling,
                      host), flush=True)
        numbers[(label, 'ceiling')] = ceiling

        pil_modes = [m for m, _ in config_modes if 'native' not in m]
        for mode in pil_modes[1:]:
            if results[mode] != results[pil_modes[0]]:
                raise AssertionError('folder run {}: detections under {} '
                                     'differ from {}'.format(
                                         label, mode, pil_modes[0]))
        if 'native thread x8' in results and \
                results['native thread x8'] != results['native process x8']:
            raise AssertionError('folder run {}: native thread and process '
                                 'detections differ'.format(label))

        if label == 'bf16':
            # The rotated, grayscale and corrupt files in every mode
            def sizes(res):
                return sorted((os.path.basename(r['file']), r.get('failure'),
                               r.get('height'), r.get('width')) for r in res)

            serial = sizes(rdb.load_and_run_detector_batch(
                detector, extra, batch_size=8, quiet=True, loader_workers=1,
                include_image_size=True))
            want = [('corrupt.jpg', 'image access failure', None, None),
                    ('gray.jpg', None, extra_h, extra_w),
                    ('rotated.jpg', None, extra_h, extra_w)]
            if serial != want:
                raise AssertionError('extra files, serial: {}'.format(serial))
            for mode, kwargs in config_modes:
                got = sizes(rdb.load_and_run_detector_batch(
                    detector, extra, batch_size=8, quiet=True,
                    include_image_size=True, **kwargs))
                if got != serial:
                    raise AssertionError('extra files under {}: {} against '
                                         'the serial {}'.format(mode, got,
                                                                serial))
            print('folder run: the rotated, grayscale and corrupt files give '
                  'the serial path\'s failures and sizes under every mode; '
                  'PIL-decode detections identical across {}'.format(
                      ', '.join(pil_modes)), flush=True)
            _folder_run_costs(detector, folder, buckets, infos, ceiling)
            native_args = rdb._worker_args(detector, None, True)
        del detector
        torch.cuda.empty_cache()

    if problem is None:
        # The native loader's canvases against PIL's
        worst, mean_sum = 0, 0.0
        start = time.time()
        for info in infos:
            _, got, fell_back = _loader_worker.load_and_letterbox(
                (info['file'],) + native_args)
            if fell_back or isinstance(got, str):
                raise AssertionError('native loader: {} fell back'.format(
                    info['file']))
            if tuple(got['target_shape']) != tuple(info['target_shape']) or \
                    tuple(got['letterbox_ratio']) != \
                    tuple(info['letterbox_ratio']) or \
                    tuple(got['letterbox_pad']) != \
                    tuple(info['letterbox_pad']):
                raise AssertionError(
                    'native geometry of {}: {} {} {} against PIL\'s {} {} '
                    '{}'.format(info['file'], got['target_shape'],
                                got['letterbox_ratio'], got['letterbox_pad'],
                                info['target_shape'],
                                info['letterbox_ratio'],
                                info['letterbox_pad']))
            diff = np.abs(got['img_processed'].astype(np.int16) -
                          info['img_processed'].astype(np.int16))
            worst = max(worst, int(diff.max()))
            mean_sum += float(diff.mean())
        native_ms = (time.time() - start) * 1e3 / len(infos)
        mean = mean_sum / len(infos)
        if worst > 3 or mean >= 0.5:
            raise AssertionError('native canvases against PIL\'s: max |d| '
                                 '{}, mean {:.4f} (bars 3, 0.5)'.format(
                                     worst, mean))
        print('folder run: native loader geometry equal to PIL\'s on all 64 '
              'JPEGs, canvases max |d| {} mean {:.4f} (bars 3, 0.5); host '
              'ms per image on one thread: PIL decode + letterbox {:.1f}, '
              'native {:.1f}'.format(worst, mean, pil_ms, native_ms),
              flush=True)
    else:
        print('folder run: host ms per image on one thread: PIL decode + '
              'letterbox {:.1f}'.format(pil_ms), flush=True)
    return numbers


#%% Phases 19-21: the single-image, tiled and video entry points


def _select_calls(detector):
    """Selection + NMS programs run so far (each launches the NMS kernel
    once; escalation runs a second one in the same device program)."""

    return sum(entry.calls for key, entry in
               detector._programs.entries.items() if 'select' in key)


def _memory_line(label):
    """Print the reserved memory and the peak allocated since the last
    call (or since the phase began), then reset the peak."""

    import torch

    torch.cuda.synchronize()
    print('{}: {:.2f} GB reserved, {:.2f} GB peak allocated'.format(
        label, torch.cuda.memory_reserved() / 1e9,
        torch.cuda.max_memory_allocated() / 1e9), flush=True)
    torch.cuda.reset_peak_memory_stats()


def _counted(detector, fn):
    """fn() with the launch counters at 0 just before; returns (its
    value, (nms, conv, bottleneck, stem, silu), device programs run,
    selection programs run)."""

    programs, selects = detector.programs_run, _select_calls(detector)
    _reset_counts()
    out = fn()
    return (out, _counts(), detector.programs_run - programs,
            _select_calls(detector) - selects)


def _pass_expected(detector, batch, height, width, first):
    """(conv, bottleneck, stem, silu) launches of one model call on a
    [batch, height, width] canvas. Under the int8 chain with conv_backend
    pallas the bottleneck kernel once per bottleneck that
    bottleneck_tiling fuses and the conv kernel on every other chain conv
    (under xla on every one); under dtype bf16 the stem on the [first]
    (or only) pass and the epilogue after every activated float conv but
    that pass's l0 (under the int8 chain only l0 is a float conv, which
    the scaled TTA passes run as a plain conv). A static int8 checkpoint's
    convs each launch the conv kernel once (int32 mode), fused or not."""

    import torch

    from megadetector_tpu_torch.models.yolov5 import QConv
    from megadetector_tpu_torch.ops import bottleneck_int8

    qconvs = [m for m in detector.model.modules() if isinstance(m, QConv)]
    n_qconv = len(qconvs)
    bf16 = detector.compute_dtype == torch.bfloat16
    fused = 0
    # static int8 convs (mode='static') never fuse: the chain's do
    if n_qconv and detector.conv_backend != 'xla' and \
            all(m.y_scale is not None for m in qconvs):
        fused = sum(m for (h, w, c), m in _bottleneck_counts(
            detector.config, height, width, batch).items()
            if bottleneck_int8.bottleneck_tiling(batch, h, w, c))
    return (n_qconv - 2 * fused, fused, int(bf16 and first),
            _n_activated_convs(detector.model) - first if bf16 else 0)


def _expected_launches(detector, forwards, augment, selects):
    """(nms, conv, bottleneck, stem, silu) that [forwards] ({(batch,
    height, width): device programs of that shape}) implies: each model
    call as _pass_expected has it; NMS once a selection program
    ([selects]: escalation runs a second in the same program) or, under
    test-time augmentation, once a program on the merged candidates of
    its three pass canvases (tta_passes)."""

    from megadetector_tpu_torch.models.detector import tta_passes

    want = [sum(forwards.values()) if augment else selects, 0, 0, 0, 0]
    for (b, h, w), k in forwards.items():
        passes = [(ph, pw) for _, _, _, _, ph, pw in tta_passes(
            h, w, detector.letterbox_stride)] if augment else [(h, w)]
        for i, (ph, pw) in enumerate(passes):
            for j, n in enumerate(_pass_expected(detector, b, ph, pw,
                                                 i == 0)):
                want[j + 1] += k * n
    return tuple(want)


def _check_launches(label, detector, counts, programs, selects,
                    forwards):
    """The launches [forwards] implies, exactly (_expected_launches):
    [forwards] is {(batch, height, width): device programs of that
    shape}, each a plain program."""

    nms, conv, fused, stem, silu = counts
    n = sum(forwards.values())
    want = _expected_launches(detector, forwards, False, selects)
    if programs != n or (nms, conv, fused, stem, silu) != want or \
            not n <= selects <= 2 * n:
        raise AssertionError(
            '{}: {} device programs (want {}), {} selection programs; '
            'launches (nms, conv, bottleneck, stem, silu) {}, want {}'
            .format(label, programs, n, selects, counts, want))
    print('{}: {} device programs {}, launches (nms, conv, bottleneck, '
          'stem, silu) {} as they imply ({} selection programs: NMS once '
          'each, escalation included)'.format(
              label, n, sorted(forwards.items()), counts, selects),
          flush=True)


def phase_single_image(device, workdir, float_path, card):
    """
    19. load_and_run_detector, the single-image driver, with yolov5l6 in
    bf16 (1280 px auto canvases, batch 1) on two synthetic JPEGs (1536x2048
    and 1080x1920): each image is one device program; its results equal
    generate_detections_one_image on the same decoded image, a rendered
    file exists for each, and the launches are exact.
    """

    import numpy as np

    from megadetector_tpu_torch.detection import run_detector
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    images = _synthetic_images(np.random.RandomState(19))[:2]
    files = _write_folder(os.path.join(workdir, 'single'), images,
                          ['single_{}.jpg'.format(i) for i in range(2)])
    out_dir = os.path.join(workdir, 'single_rendered')
    detector = run_detector.load_detector(float_path, device=device,
                                          detector_options={
                                              'dtype': 'bfloat16'})
    start = time.time()
    results, counts, programs, selects = _counted(
        detector, lambda: run_detector.load_and_run_detector(
            detector, files, out_dir))
    seconds = time.time() - start
    _check_launches('phase 19, load_and_run_detector', detector, counts,
                    programs, selects, {(1, 960, 1280): 1,
                                        (1, 768, 1280): 1})
    for path, r in zip(files, results):
        want = detector.generate_detections_one_image(
            load_image(path), path, detection_threshold=0.005)
        if r != want or not r['detections']:
            raise AssertionError('{}: load_and_run_detector gave {} '
                                 'detections, generate_detections_one_'
                                 'image {}'.format(
                                     path, len(r['detections'] or []),
                                     len(want['detections'] or [])))
        rendered = os.path.join(out_dir, os.path.splitext(
            os.path.basename(path))[0] + '_detections.jpg')
        if not os.path.isfile(rendered):
            raise AssertionError('no rendered file {}'.format(rendered))
    print('phase 19 on {}: load_and_run_detector (bf16, first calls, '
          'rendering included) {:.3f} s for 2 images, {} and {} '
          'detections; equal to generate_detections_one_image; 2 rendered '
          'files'.format(card, seconds, len(results[0]['detections']),
                         len(results[1]['detections'])), flush=True)
    _memory_line('phase 19')


def _large_image(rng, h, w):
    """A seeded uint8 image of [h, w]: gradients, blocks and noise, as
    _synthetic_images makes them."""

    import numpy as np

    yy = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = xx
    img[..., 1] = yy
    img[..., 2] = 96
    for _ in range(24):
        y0, x0 = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
        img[y0:y0 + h // 10, x0:x0 + w // 10] = rng.randint(0, 255, 3)
    img += rng.randint(-20, 20, (h, w, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def _tiled_reference(detector, folder, names, out_file):
    """
    What run_tiled_inference should write, assembled here: tiles cut with
    get_patch_boundaries (1280x1280, half overlap; an image smaller than a
    tile whole), generate_detections_one_batch on 8 at a time, each box
    remapped through pixels and rounded, then in_place_nms and
    write_results_to_file. Returns (the dict written, seconds spent in
    each step: decode, batches, remap, nms).
    """

    import torch

    import numpy as np

    from megadetector_tpu_torch.detection import run_detector_batch
    from megadetector_tpu_torch.detection.run_tiled_inference import (
        get_patch_boundaries, in_place_nms)
    from megadetector_tpu_torch.utils import ct_utils
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    seconds = dict.fromkeys(('decode', 'batches', 'remap', 'nms'), 0.0)
    images = []
    for name in names:
        start = time.time()
        im = np.asarray(load_image(os.path.join(folder, name)))
        seconds['decode'] += time.time() - start
        h, w = im.shape[:2]
        if w < 1280 or h < 1280:
            tiles = [((0, 0), im)]
        else:
            tiles = [((x, y), im[y:y + 1280, x:x + 1280])
                     for x, y in get_patch_boundaries((w, h), (1280, 1280))]
        results = []
        start = time.time()
        for i in range(0, len(tiles), 8):
            results += detector.generate_detections_one_batch(
                [t for _, t in tiles[i:i + 8]],
                ['{}__{}'.format(name, j) for j in range(i, i + 8)][
                    :len(tiles[i:i + 8])], detection_threshold=0.005)
        torch.cuda.synchronize()
        seconds['batches'] += time.time() - start
        start = time.time()
        detections = []
        for ((x0, y0), tile), r in zip(tiles, results):
            th, tw = tile.shape[:2]
            for d in r['detections']:
                x, y, bw, bh = d['bbox']
                detections.append({
                    'category': d['category'],
                    'conf': ct_utils.round_float(d['conf'], 3),
                    'bbox': ct_utils.round_float_array(
                        [(x0 + x * tw) / w, (y0 + y * th) / h, bw * tw / w,
                         bh * th / h], 4)})
        images.append({'file': name, 'detections': detections})
        seconds['remap'] += time.time() - start
    start = time.time()
    in_place_nms({'images': images})
    seconds['nms'] = time.time() - start
    return run_detector_batch.write_results_to_file(images,
                                                    out_file), seconds


def phase_tiled(device, workdir, float_path, q_path, card):
    """
    20. run_tiled_inference with yolov5l6 (bf16, then int8 with
    conv_backend pallas) on two synthetic 4000x3000 JPEGs and one 1024x768
    JPEG: default 1280x1280 tiles at 0.5 overlap, 6 x 4 = 24 tiles an
    image in three full batches of 8 on the square canvas; the small image
    runs whole (batch 1, 960x1280 canvas). Launches exact; the JSON equals
    _tiled_reference's; a run interrupted at its second image and resumed
    from its checkpoint writes the unbroken run's JSON; tiles/s and
    images/s of a replayed run.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_tiled_inference import \
        run_tiled_inference

    rng = np.random.RandomState(20)
    folder = os.path.join(workdir, 'tiled')
    names = ['large_0.jpg', 'large_1.jpg', 'small.jpg']
    _write_folder(folder, [_large_image(rng, 3000, 4000),
                           _large_image(rng, 3000, 4000),
                           _large_image(rng, 768, 1024)], names)
    forwards = {(8, 1280, 1280): 6, (1, 960, 1280): 1}
    n_tiles = 6 * 8 + 1
    for label, path, options in (
            ('bf16', float_path, {'dtype': 'bfloat16'}),
            ('int8 pallas', q_path, {'conv_backend': 'pallas'})):
        detector = load_detector(path, device=device,
                                 detector_options=options)

        def run(out_name, **kwargs):
            return run_tiled_inference(
                detector, folder, None, os.path.join(workdir, out_name),
                **kwargs)

        first, counts, programs, selects = _counted(
            detector, lambda: run('tiled_first.json'))
        _check_launches('phase 20, tiled {}'.format(label), detector,
                        counts, programs, selects, forwards)
        want, parts = _tiled_reference(detector, folder, names,
                                       os.path.join(workdir,
                                                    'tiled_reference.json'))
        if first['images'] != want['images']:
            raise AssertionError('tiled {}: run_tiled_inference differs '
                                 'from the assembled reference'.format(
                                     label))
        n_det = [len(im['detections']) for im in first['images']]
        if not all(n_det):
            raise AssertionError('tiled {}: detections {}'.format(label,
                                                                  n_det))

        # Interrupted at the second image's first batch, then resumed
        checkpoint = os.path.join(workdir, 'tiled_checkpoint.json')
        real = detector.generate_detections_one_batch

        def interrupt(images, ids, **kwargs):
            if ids[0].startswith('large_1.jpg'):
                raise KeyboardInterrupt('interrupted')
            return real(images, ids, **kwargs)

        detector.generate_detections_one_batch = interrupt
        try:
            run('tiled_broken.json', checkpoint_path=checkpoint,
                checkpoint_frequency=1)
            raise AssertionError('the interrupted run ran to its end')
        except KeyboardInterrupt:
            pass
        finally:
            detector.generate_detections_one_batch = real
        with open(checkpoint) as f:
            saved = [im['file'] for im in json.load(f)['checkpoint']]
        resumed = run('tiled_resumed.json', checkpoint_path=checkpoint,
                      checkpoint_frequency=1)
        if saved != ['large_0.jpg'] or os.path.isfile(checkpoint) or \
                resumed['images'] != first['images']:
            raise AssertionError('tiled {}: checkpoint held {}; the resumed '
                                 'run differs from the unbroken one'.format(
                                     label, saved))

        torch.cuda.synchronize()
        start = time.time()
        timed = run('tiled_timed.json')
        torch.cuda.synchronize()
        seconds = time.time() - start
        if timed['images'] != first['images']:
            raise AssertionError('tiled {}: the replayed run differs'.format(
                label))
        print('phase 20 on {}: tiled {} equal to the assembled reference '
              '({} detections an image after NMS across tiles); resumed '
              'from a checkpoint after 1 image = unbroken; replayed run '
              '{:.3f} s: {:.3f} tiles/s, {:.3f} images/s ({} tiles, 3 '
              'images, decode included)'.format(
                  card, label, n_det, seconds, n_tiles / seconds,
                  3 / seconds, n_tiles), flush=True)
        print('phase 20, tiled {}: where a replayed run\'s time goes (the '
              'reference\'s steps, s): JPEG decode {:.3f}, the 7 batches '
              'through generate_detections_one_batch {:.3f} ({:.1f} ms a '
              'full batch of 8 tiles), remap {:.3f}, NMS across tiles '
              '{:.3f}'.format(label, parts['decode'], parts['batches'],
                              1e3 * parts['batches'] / 7, parts['remap'],
                              parts['nms']), flush=True)
        _memory_line('phase 20, tiled {}'.format(label))
        del detector
        torch.cuda.empty_cache()


def _write_videos(folder, rng):
    """Two 1920x1080 mp4v videos at 30 fps (60 and 45 frames: a synthetic
    scene sliding 24 px a frame) and one corrupt file."""

    import cv2
    import numpy as np

    os.makedirs(folder, exist_ok=True)
    base = _large_image(rng, 1080, 1920)
    for name, n_frames in (('clip_a.mp4', 60), ('clip_b.mp4', 45)):
        out = cv2.VideoWriter(os.path.join(folder, name),
                              cv2.VideoWriter_fourcc(*'mp4v'), 30.0,
                              (1920, 1080))
        if not out.isOpened():
            raise AssertionError('cv2.VideoWriter cannot write mp4v')
        for i in range(n_frames):
            out.write(np.ascontiguousarray(np.roll(base, 24 * i,
                                                   axis=1)[..., ::-1]))
        out.release()
    with open(os.path.join(folder, 'corrupt.mp4'), 'wb') as f:
        f.write(b'not a video')


def _decoded_frames(path, every):
    import cv2

    cap = cv2.VideoCapture(path)
    frames, n = [], 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        if n % every == 0:
            frames.append((n, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
        n += 1
    cap.release()
    return frames


def phase_video(device, workdir, float_path, card):
    """
    21. process_videos with yolov5l6 in bf16 on a folder of two 1920x1080
    videos (30 fps, 60 and 45 frames) and a corrupt file, frame_batch_size
    8, under frame_sample 4 and time_sample 0.5: frames_processed as the
    sampling gives, launches exact (each video's frames in batches of 8
    and its own tail), each frame's detections equal to
    generate_detections_one_batch on the same frames decoded with cv2 in
    the same batches, the corrupt video a failure record, the file valid
    under validate_batch_results; frames/s of a replayed run. Then
    process_video_folder_via_frames (frames to JPEGs, then the batch
    driver) gives the same videos, frame numbers and frame rates.
    """

    import torch

    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise AssertionError('phase 21 needs cv2 to decode video: '
                             '{}'.format(e))
    import numpy as np

    from megadetector_tpu_torch.detection import process_video
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.workflows import manage_video_batch

    folder = os.path.join(workdir, 'videos')
    _write_videos(folder, np.random.RandomState(21))
    detector = load_detector(float_path, device=device,
                             detector_options={'dtype': 'bfloat16'})
    lengths = {'clip_a.mp4': 60, 'clip_b.mp4': 45}
    records = {}
    for sampling, value, every in (('frame_sample', 4, 4),
                                   ('time_sample', 0.5, 15)):
        options = process_video.ProcessVideoOptions()
        options.model_file = detector
        options.input_video_file = folder
        options.output_json_file = os.path.join(
            workdir, 'video_{}.json'.format(sampling))
        options.frame_batch_size = 8
        setattr(options, sampling, value)
        out, counts, programs, selects = _counted(
            detector, lambda: process_video.process_videos(options))
        forwards = {}
        for name, n in lengths.items():
            n_sampled = len(range(0, n, every))
            for i in range(0, n_sampled, 8):
                key = (min(8, n_sampled - i), 768, 1280)
                forwards[key] = forwards.get(key, 0) + 1
        _check_launches('phase 21, process_videos {} {}'.format(
            sampling, value), detector, counts, programs, selects,
            forwards)
        by_file = {im['file']: im for im in out['images']}
        corrupt = by_file.pop('corrupt.mp4')
        if corrupt['detections'] is not None or \
                corrupt['frame_rate'] != -1.0 or \
                not corrupt['failure'].startswith('Failure processing'):
            raise AssertionError('the corrupt video: {}'.format(corrupt))
        for name, n in lengths.items():
            im = by_file[name]
            if im['frames_processed'] != list(range(0, n, every)) or \
                    abs(im['frame_rate'] - 30.0) > 0.01:
                raise AssertionError('{}: frames {}, frame rate {}'.format(
                    name, im['frames_processed'], im['frame_rate']))
            frames = _decoded_frames(os.path.join(folder, name), every)
            for i in range(0, len(frames), 8):
                chunk = frames[i:i + 8]
                results = detector.generate_detections_one_batch(
                    [f for _, f in chunk], ['f'] * len(chunk),
                    detection_threshold=0.005)
                for (n_frame, _), r in zip(chunk, results):
                    got = [{k: v for k, v in d.items()
                            if k != 'frame_number'}
                           for d in im['detections']
                           if d['frame_number'] == n_frame]
                    if sorted(got, key=json.dumps) != sorted(
                            r['detections'], key=json.dumps) or not got:
                        raise AssertionError(
                            '{} frame {}: {} detections, {} from '
                            'generate_detections_one_batch'.format(
                                name, n_frame, len(got),
                                len(r['detections'])))
        errors = validate_batch_results(options.output_json_file)[
            'validation_results']['validation_errors']
        if errors:
            raise AssertionError('validate_batch_results: {}'.format(
                errors[:3]))
        records[sampling] = by_file
        n_frames = sum(len(im['frames_processed'])
                       for im in by_file.values())
        torch.cuda.synchronize()
        start = time.time()
        timed = process_video.process_videos(options)
        torch.cuda.synchronize()
        seconds = time.time() - start
        if timed['images'] != out['images']:
            raise AssertionError('process_videos: the replayed run '
                                 'differs')
        print('phase 21 on {}: process_videos {} {}: {} frames of 2 '
              'videos equal to generate_detections_one_batch on cv2\'s '
              'frames; corrupt video a failure record; valid; replayed run '
              '{:.3f} s, {:.3f} frames/s (decode included)'.format(
                  card, sampling, value, n_frames, seconds,
                  n_frames / seconds), flush=True)
        # Where the replayed run's time goes, step by step
        parts = {'decode': 0.0, 'batches': 0.0}
        for name in lengths:
            start = time.time()
            frames = _decoded_frames(os.path.join(folder, name), every)
            parts['decode'] += time.time() - start
            start = time.time()
            for i in range(0, len(frames), 8):
                detector.generate_detections_one_batch(
                    [f for _, f in frames[i:i + 8]],
                    ['f'] * len(frames[i:i + 8]), detection_threshold=0.005)
            torch.cuda.synchronize()
            parts['batches'] += time.time() - start
        print('phase 21, {}: cv2 decode of every frame of both videos '
              '{:.3f} s, the replayed batches through '
              'generate_detections_one_batch {:.3f} s'.format(
                  sampling, parts['decode'], parts['batches']), flush=True)

    options = manage_video_batch.VideoBatchOptions()
    options.model_file = float_path
    options.input_video_folder = folder
    options.frame_folder = os.path.join(workdir, 'video_frames')
    options.output_json_file = os.path.join(workdir, 'video_frames.json')
    options.every_n_frames = 4
    options.detector_options = {'dtype': 'bfloat16'}
    options.device = device
    start = time.time()
    frames_out = manage_video_batch.process_video_folder_via_frames(options)
    seconds = time.time() - start
    direct = records['frame_sample']
    got = {im['file']: (im['frame_rate'], im['frames_processed'])
           for im in frames_out['images']}
    want = {name: (im['frame_rate'], im['frames_processed'])
            for name, im in direct.items()}
    if got != want or any(im['detections'] is None
                          for im in frames_out['images']):
        raise AssertionError('process_video_folder_via_frames: {}, the '
                             'direct path {}'.format(got, want))
    print('phase 21 on {}: process_video_folder_via_frames (frames to '
          'JPEGs, then the batch driver, first calls) {:.3f} s; the same '
          'videos, frame numbers and frame rates as process_videos'.format(
              card, seconds), flush=True)
    _memory_line('phase 21')
    del detector
    torch.cuda.empty_cache()


#%% Phase 22: the other detector families


# (arch, model_type, image_size, card-vs-CPU canvas): yolov8l is the JAX
# converter's arch for a 64-channel ultralytics stem (the MDv1000 models)
FAMILY_MODELS = (('yolov8l', 'ultralytics', 1280, (256, 256)),
                 ('rfdetr_base', 'rfdetr', 560, (224, 224)),
                 ('detr_base', 'detr', 448, (224, 224)))


def _family_checkpoint(workdir, arch, model_type, image_size):
    """A full-width, full-depth [arch] model, random weights from seed 0
    through the port's init_params, saved as .npz with the metadata the
    JAX converter writes (DETR, which no converter writes: the metadata of
    the JAX package's DETR tests). Returns (path, config, params)."""

    from megadetector_tpu_torch.models import detector as detector_module
    from megadetector_tpu_torch.models import detr, rfdetr, yolov8
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    metadata = {'metadata_format_version': 1.0, 'arch': arch,
                'model_type': model_type, 'num_classes': 3,
                'class_names': ['animal', 'person', 'vehicle'],
                'image_size': image_size}
    config = detector_module.model_config(arch, model_type, metadata)
    module = {'ultralytics': yolov8, 'rfdetr': rfdetr,
              'detr': detr}[model_type]
    if model_type == 'ultralytics':
        metadata.update(model_version_string='v1000.0.0-redwood',
                        strides=list(config.strides))
    params = module.init_params(config, seed=0)
    path = os.path.join(workdir, 'md_smoke_{}.npz'.format(arch))
    save_checkpoint(params, path, metadata)
    return path, config, params


def _family_forward(model, x):
    """(decoded [B, Q, 5+nc] float32, query identity [B, Q]) of [model] on
    the uint8 batch [x]: RF-DETR's rows are its two-stage top-Q memory
    tokens (their indices), every other family's rows are fixed (their
    positions)."""

    import torch

    from megadetector_tpu_torch.models import rfdetr
    from megadetector_tpu_torch.models.yolov5 import network_input

    with torch.inference_mode():
        out = model(x).float().cpu().numpy()
        if isinstance(model, rfdetr.RFDetr):
            dtype = model.compute_dtype
            tokens, shapes = rfdetr.pyramid(
                model.config, model.params, network_input(x, dtype), dtype)
            ident = rfdetr.select_queries(model.config, model.params,
                                          tokens, shapes)[2].cpu().numpy()
        else:
            ident = torch.arange(out.shape[1]).expand(
                out.shape[0], -1).numpy()
    return out, ident


def _family_cpu_outputs(config, params, canvas):
    """The port's forward on the CPU for a seeded uint8 batch of 2 at
    [canvas]: (images, {dtype name: _family_forward's pair})."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.models.detector import NETWORKS

    x = torch.from_numpy(np.random.RandomState(22).randint(
        0, 256, (2,) + canvas + (3,), dtype=np.uint8))
    outputs = {}
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        model = NETWORKS[type(config)](config).load_params(
            params).set_compute_dtype(dtype).eval()
        outputs[name] = _family_forward(model, x)
        del model
    return x, outputs


def _matched_rows(a, b):
    """Rows of two _family_forward results with the same query identity:
    (identities of a missing from b, [|d| of the matched rows' boxes,
    scores])."""

    import numpy as np

    (out_a, id_a), (out_b, id_b) = a, b
    missing, d_box, d_score = 0, [], []
    for i in range(out_a.shape[0]):
        common, pos_a, pos_b = np.intersect1d(id_a[i], id_b[i],
                                              return_indices=True)
        missing += out_a.shape[1] - len(common)
        d = np.abs(out_a[i, pos_a] - out_b[i, pos_b])
        d_box.append(d[:, :4])
        d_score.append(d[:, 5:])
    return missing, [np.concatenate(d_box), np.concatenate(d_score)]


def _family_card_vs_cpu(detector, dtype_name, x, cpu):
    """
    The card's forward against the CPU's on the same batch, rows matched
    by query identity (_family_forward), within the CPU tests' bars:
    float32, every query the same and |d| <= 1e-4 |ref| + 1e-4 max|ref|
    (rtol 1e-4, atol 1e-4 * max|ref|); bf16, no more queries missing
    than between the CPU's bf16 and float32 (RF-DETR's top-Q can differ
    where two memory tokens score within a bf16 rounding), and box and
    score errors no larger than the CPU's bf16 against its float32 plus
    float32's atol. Returns (queries missing, max box |d| px, max score
    |d|).
    """

    import numpy as np

    got = _family_forward(detector.model, x.to(detector.device))
    ref = cpu[dtype_name]
    if got[0].shape != ref[0].shape or not np.isfinite(got[0]).all():
        raise AssertionError('card output shape {} vs CPU {}, or '
                             'non-finite'.format(got[0].shape, ref[0].shape))
    missing, diffs = _matched_rows(got, ref)
    worst = [float(d.max(initial=0.0)) for d in diffs]
    if dtype_name == 'float32':
        bar = 1e-4 * np.abs(ref[0]) + 1e-4 * np.abs(ref[0]).max()
        outside = int((np.abs(got[0] - ref[0]) > bar).sum())
        if missing or outside:
            raise AssertionError(
                'card vs CPU float32: {} queries missing, {} elements '
                'outside rtol 1e-4 / atol 1e-4 * max|ref| (max |d| boxes '
                '{:.3e}, scores {:.3e})'.format(missing, outside, *worst))
    else:
        own_missing, own = _matched_rows(ref, cpu['float32'])
        # The CPU's own bf16 error, plus float32's absolute allowance
        # (RF-DETR's random boxes are its anchors, the same in both dtypes)
        limit = [float(d.max(initial=0.0)) + 1e-4 * np.abs(ref[0]).max()
                 for d in own]
        if missing > own_missing or worst[0] > limit[0] or \
                worst[1] > limit[1]:
            raise AssertionError(
                'card vs CPU bf16: {} queries missing, max |d| boxes {:.3e} '
                'scores {:.3e}; limits (the CPU\'s own bf16 against float32 '
                '+ 1e-4 max|ref|): {}, {:.3e}, {:.3e}'.format(
                    missing, *worst, own_missing, *limit))
    return [missing] + worst


def phase_other_families(device, workdir, pairs, card):
    """
    22. The other detector families at full width: yolov8l (num_classes
    3, 1280 px auto canvases), rfdetr_base (image_size 560) and detr_base
    (image_size 448), random weights from seed 0 through the port's
    init_params, each in float32 and bf16 through
    load_and_run_detector_batch over the 16 images at batch 8: an eager
    pass and a replayed one, each counted (NMS once per selection
    program; no int8 kernel or stem; under yolov8 bf16 the bias + SiLU
    epilogue once per activated conv per program, the count from the
    config; none for the transformers), their launches equal and their
    detections identical; the MD JSON checked; a timed replayed pass
    (images/s); the program cache's eager and replayed ms on the family's
    4:3 batch of 8 (phase 16's numbers); the card against the CPU on a
    uint8 batch of 2. Returns the (NMS, bias + SiLU) launches of the eager
    passes.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models import yolov8

    nms_launches = silu_launches = 0
    for arch, model_type, image_size, canvas in FAMILY_MODELS:
        start = time.time()
        path, config, params = _family_checkpoint(workdir, arch, model_type,
                                                  image_size)
        x_cpu, cpu = _family_cpu_outputs(config, params, canvas)
        n_silu = yolov8.activated_conv_count(config) \
            if model_type == 'ultralytics' else 0
        for dtype in ('float32', 'bfloat16'):
            label = '{} {}'.format(arch, dtype)
            torch.cuda.reset_peak_memory_stats()
            detector = load_detector(path, device=device, detector_options={
                'pad_batches_to': 8, 'dtype': dtype})
            # An eager pass, then a replayed one, each counted
            passes = [_counted(detector, lambda: load_and_run_detector_batch(
                detector, pairs, batch_size=8, quiet=True))
                for _ in range(2)]
            for i, (_, counts, programs, selects) in enumerate(passes):
                want = (selects, 0, 0, 0,
                        programs * n_silu if dtype == 'bfloat16' else 0)
                if counts != want or programs != 2 or \
                        not programs <= selects <= 2 * programs:
                    raise AssertionError(
                        'phase 22, {}, pass {}: {} device programs (want '
                        '2), {} selection programs; launches (nms, conv, '
                        'bottleneck, stem, silu) {}, want {}'.format(
                            label, i + 1, programs, selects, counts, want))
            (eager, counts, programs, selects), (replayed, *rest) = passes
            if replayed != eager or tuple(rest) != (counts, programs,
                                                    selects):
                raise AssertionError('phase 22, {}: the replayed pass '
                                     'differs from the eager one'.format(
                                         label))
            if detector._programs.replays == 0:
                raise AssertionError('phase 22, {}: no program was '
                                     'replayed'.format(label))
            nms_launches += counts[0]
            silu_launches += counts[4]
            n_det = _write_and_check(eager, pairs, path, os.path.join(
                workdir, 'smoke_{}_{}.json'.format(arch, dtype)))
            torch.cuda.synchronize()
            t0 = time.time()
            load_and_run_detector_batch(detector, pairs, batch_size=8,
                                        quiet=True)
            torch.cuda.synchronize()
            rate = len(pairs) / (time.time() - t0)
            print('phase 22 on {}: {}: 16 images, {} detections; eager and '
                  'replayed passes identical, each 2 device programs, {} '
                  'selection programs, launches (nms, conv, bottleneck, '
                  'stem, silu) {} as they imply ({} bias + SiLU convs a '
                  'forward); {:.3f} images/s through '
                  'load_and_run_detector_batch (replayed)'.format(
                      card, label, n_det, selects, counts, n_silu, rate),
                  flush=True)

            infos = [detector.preprocess_image(img, image_id=name)
                     for name, img in pairs[0::2]]
            batch = np.stack([info['img_processed'] for info in infos])
            numbers = phase_program_cache(detector, batch, label)
            diffs = _family_card_vs_cpu(detector, dtype, x_cpu, cpu)
            print('phase 22 on {}: {}: {}x{} batch of 8: forward {:.3f} ms '
                  'eager, {:.3f} replayed; program {:.3f} ms eager, {:.3f} '
                  'replayed; peak {:.2f} GB allocated, {:.2f} GB reserved; '
                  'card vs CPU at {}x{}, batch 2: {} queries missing, max '
                  '|d| boxes {:.3e} px, scores {:.3e}'.format(
                      card, label, batch.shape[1], batch.shape[2],
                      numbers['forward_eager'], numbers['forward_replay'],
                      numbers['program_eager'], numbers['program_replay'],
                      numbers['peak_allocated_gb'],
                      numbers['peak_reserved_gb'], canvas[0], canvas[1],
                      *diffs), flush=True)
            del detector
            torch.cuda.empty_cache()
        del params
        print('phase 22, {}: {:.1f} s'.format(arch, time.time() - start),
              flush=True)
    return nms_launches, silu_launches


#%% Phase 23: the species classifier and the two-stage path


# SpeciesNet's crop classifier: EfficientNetV2-M at 480 px; 2000 classes,
# the JAX package's own throughput configuration
# (experiments/exp_classifier_throughput.py)
CLASSIFIER_ARCH = 'efficientnetv2_m'
CLASSIFIER_CLASSES = 2000
CLASSIFIER_SIZE = 480
CLASSIFIER_BATCH = 64
# He init explodes through the BN-free graph (logits ~1e8 at 480 px, one-hot
# probabilities); conv weights x 0.83 and the fc x 64 keep the logits
# O(1), as the JAX package's int8 classifier tests scale theirs
CLASSIFIER_CONV_SCALE = 0.83
CLASSIFIER_FC_SCALE = 64.0
# The two-stage run classifies about this many crops, and must classify
# within TWO_STAGE_RANGE
TWO_STAGE_CROPS = 1000
TWO_STAGE_RANGE = (500, 2000)


def _classifier_checkpoint(workdir):
    """EfficientNetV2-M at full width and depth, random weights from seed 0
    through the port's init_params (scaled as above), saved as .npz with
    the metadata the JAX SpeciesNet converter writes, its class names
    SpeciesNet-style taxonomy strings. Returns (path, metadata)."""

    import numpy as np

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    config = efficientnet.EfficientNetConfig(
        CLASSIFIER_ARCH, num_classes=CLASSIFIER_CLASSES)

    def scaled(node):
        return {k: scaled(v) if isinstance(v, dict) else
                v * np.float32(CLASSIFIER_CONV_SCALE) if v.ndim == 4 else v
                for k, v in node.items()}

    params = scaled(efficientnet.init_params(config, seed=0))
    params['fc']['w'] = params['fc']['w'] * np.float32(CLASSIFIER_FC_SCALE)
    names = ['{:08x};mammalia;order{};family{};genus{};species{};'
             'common name {}'.format(i, i % 7, i % 50, i, i, i)
             for i in range(CLASSIFIER_CLASSES)]
    metadata = {'arch': CLASSIFIER_ARCH, 'model_type': 'speciesnet',
                'num_classes': CLASSIFIER_CLASSES, 'class_names': names,
                'image_size': CLASSIFIER_SIZE,
                'normalization_mean': [0.0, 0.0, 0.0],
                'normalization_std': [1.0, 1.0, 1.0], 'crop_mode': 'stretch'}
    path = os.path.join(workdir, 'md_smoke_classifier.npz')
    save_checkpoint(params, path, metadata)
    return path, metadata


def _classifier_kernels(device, card):
    """
    B2 at every distinct int8 chain-conv shape of EfficientNetV2-M at 480
    px, batch 64 (int32 sums and int8 outputs, the project convs through
    the epilogue without SiLU), identical to the plain version; E7 at every
    distinct bias + SiLU shape of the bf16 forward (the [64, C, 1, 1] SE
    tensors among them), identical. Prints the no-SiLU epilogue's ms
    against the SiLU kind's at two project-conv shapes, with the bound.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.ops import conv_int8, silu_bf16

    config = efficientnet.EfficientNetConfig(
        CLASSIFIER_ARCH, num_classes=CLASSIFIER_CLASSES)
    shapes = {}
    for d in efficientnet.chain_conv_shapes(config, CLASSIFIER_SIZE,
                                            CLASSIFIER_BATCH):
        key = (d['batch'], d['h'], d['w'], d['cin'], d['cout'], d['k'],
               d['stride'])
        shapes.setdefault(key, set()).add(d['act'])
    rng = np.random.RandomState(23)
    y_scale = 4.0 / 127
    for (b, h, w, cin, cout, k, s), acts in sorted(shapes.items()):
        x = _int8_input(rng, device, (b, h, w, cin))
        wt, scale, bias = _int8_conv_case(rng, device, cin, cout, k)
        pads = (k // 2,) * 4
        acc = conv_int8.conv_int32_reference(x, wt, (s, s), pads)
        got = conv_int8.conv_int8(x, wt, None, None, (s, s), pads)
        if not torch.equal(got, acc):
            raise AssertionError('phase 23: int8 conv {} int32 sums differ '
                                 'from the plain version'.format(
                                     (b, h, w, cin, cout, k, s)))
        for act in sorted(acts):
            want = conv_int8.chain_epilogue_reference(acc, scale, bias,
                                                      y_scale, act)
            got = conv_int8.conv_int8(x, wt, scale, bias, (s, s), pads,
                                      y_scale, act=act)
            if not torch.equal(got, want):
                raise AssertionError(
                    'phase 23: int8 conv {} act={} differs from the plain '
                    'version on {} elements'.format(
                        (b, h, w, cin, cout, k, s), act,
                        int((got != want).sum())))
        del x, acc, got
    print('phase 23 on {}: the int8 conv kernel identical to its plain '
          'version at all {} distinct chain-conv shapes of {} at {} px, '
          'batch {} (int32 sums; int8 with SiLU, and without it on the {} '
          'project-conv shapes)'.format(
              card, len(shapes), CLASSIFIER_ARCH, CLASSIFIER_SIZE,
              CLASSIFIER_BATCH, sum(False in a for a in shapes.values())),
          flush=True)

    # The epilogue without SiLU against the SiLU kind at project shapes
    for b, h, cin, cout in ((CLASSIFIER_BATCH, 30, 960, 176),
                            (CLASSIFIER_BATCH, 15, 1824, 304)):
        x = _int8_input(rng, device, (b, h, h, cin))
        wt, scale, bias = _int8_conv_case(rng, device, cin, cout, 1)
        ms = {act: _graph_ms(lambda act=act: conv_int8.conv_int8(
            x, wt, scale, bias, (1, 1), (0, 0, 0, 0), y_scale, act=act),
            reps=20) for act in (False, True)}
        m = b * h * h
        bound, by = _bound(m * cin + cin * cout + m * cout,
                           2.0 * m * cin * cout, INT8_OPS_PER_MS)
        print('phase 23 on {}: int8 1x1 {}->{} at {}x{}, batch {}: '
              'without SiLU {:.4f} ms, with SiLU {:.4f} ms (device, '
              'replayed); bound {:.4f} ms ({})'.format(
                  card, cin, cout, h, h, b, ms[False], ms[True], bound, by),
              flush=True)

    # E7 at the bf16 forward's shapes, recorded from one forward
    seen = {}
    original = efficientnet.silu_bf16

    def record(x, bias=None, out=None):
        seen.setdefault((tuple(x.shape), x.stride()), None)
        return original(x, bias, out)

    model = efficientnet.EfficientNet(config).load_params(
        efficientnet.init_params(config, seed=0)).set_compute_dtype(
            torch.bfloat16).eval().to(device)
    efficientnet.silu_bf16 = record
    try:
        with torch.inference_mode():
            model(torch.zeros((CLASSIFIER_BATCH, CLASSIFIER_SIZE,
                               CLASSIFIER_SIZE, 3), device=device))
    finally:
        efficientnet.silu_bf16 = original
    del model
    for shape, stride in sorted(seen):
        x = torch.empty_strided(shape, stride, dtype=torch.bfloat16,
                                device=device)
        x.copy_(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 3).to(device))
        bias = torch.from_numpy(rng.standard_normal(shape[1]).astype(
            np.float32)).to(device).to(torch.bfloat16)
        if not torch.equal(silu_bf16.silu_bf16(x, bias),
                           silu_bf16.silu_bf16_reference(x, bias)):
            raise AssertionError('phase 23: bias + SiLU at {} differs from '
                                 'its plain version'.format(shape))
    print('phase 23 on {}: the bf16 bias + SiLU kernel bit-identical to its '
          'plain version at all {} distinct shapes of the bf16 forward '
          '({} of them [64, C, 1, 1] SE tensors)'.format(
              card, len(seen), sum(s[2:] == (1, 1) for s, _ in seen)),
          flush=True)


def _classifier_on_card(device, path, card):
    """
    SpeciesClassifier at 480 px, batch 64, in float32, bf16 and int8
    (calibrated by calibrate() on 64 crops from RandomState(1)): eager,
    then replayed from its CUDA graph, identical, each with exact
    launches (none of ours in float32; E7 147 in bf16; B2 109 and E7 92 in
    int8); two batches in flight (dispatch, dispatch, fetch, fetch) equal
    to serial calls; forward and program ms eager and replayed, crops/s,
    peak memory. Returns {dtype: numbers}.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier

    s, b = CLASSIFIER_SIZE, CLASSIFIER_BATCH
    calib = np.random.RandomState(1).randint(0, 256, (b, s, s, 3),
                                             dtype=np.uint8)
    rng = np.random.RandomState(2)
    batch = rng.randint(0, 256, (b, s, s, 3), dtype=np.uint8)
    other = rng.randint(0, 256, (b, s, s, 3), dtype=np.uint8)
    results = {}
    for label, options in (('float32', {}), ('bfloat16', {'dtype':
                                                          'bfloat16'}),
                           ('int8', {'quantize': 'int8'})):
        torch.cuda.reset_peak_memory_stats()
        clf = SpeciesClassifier(path, options, device=device)
        if label == 'int8':
            clf.calibrate(calib)
        want = efficientnet.forward_launches(
            clf.config, label == 'int8', clf.compute_dtype)
        probs = []
        for i in range(2):
            _reset_counts()
            probs.append(clf.classify_batch(list(batch)))
            counts = _counts()
            got = (counts[1], counts[4])
            if got != want:
                raise AssertionError('phase 23, {}: call {} launched (conv, '
                                     'silu) {}, want {}'.format(
                                         label, i + 1, got, want))
        if clf._programs.replays != (clf.device.type == 'cuda') or \
                not np.array_equal(probs[0], probs[1]):
            raise AssertionError('phase 23, {}: replay differs from eager '
                                 '(replays {})'.format(
                                     label, clf._programs.replays))
        if probs[0].shape != (b, CLASSIFIER_CLASSES) or \
                not np.isfinite(probs[0]).all() or \
                np.abs(probs[0].sum(1) - 1).max() > 1e-4:
            raise AssertionError('phase 23, {}: probabilities {} not finite '
                                 'rows summing to 1'.format(
                                     label, probs[0].shape))
        serial_other = clf.classify_batch(list(other))
        h1 = clf.classify_batch_async(list(batch))
        h2 = clf.classify_batch_async(list(other))
        if not (np.array_equal(clf.fetch_batch(h1), probs[0]) and
                np.array_equal(clf.fetch_batch(h2), serial_other)):
            raise AssertionError('phase 23, {}: two batches in flight '
                                 'differ from serial calls'.format(label))

        x_u8 = torch.from_numpy(batch).to(device)
        with torch.inference_mode():
            x = (x_u8.float() / 255.0).contiguous()
            fwd_eager = _time_ms(lambda: clf.model(x), 3, warmup=1)
            fwd_replay = _graph_ms(lambda: clf.model(x), reps=3)

        def wall_ms(fn, reps):
            fn()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3 / reps

        with torch.inference_mode():
            prog_eager = wall_ms(lambda: clf._program(x_u8).cpu(), 3)
        crops = list(batch)
        prog_replay = wall_ms(lambda: clf.classify_batch(crops), 5)
        results[label] = {
            'forward_eager': fwd_eager, 'forward_replay': fwd_replay,
            'program_eager': prog_eager, 'program_replay': prog_replay,
            'crops_per_s': b / (prog_replay / 1e3),
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
            'top1': probs[0].argmax(1)}
        print('phase 23 on {}: classifier {}: replay identical to eager, '
              'launches (conv, silu) {} per forward; two batches in flight '
              'equal to serial; {}x{} batch of {}: forward {:.3f} ms eager, '
              '{:.3f} replayed; program {:.3f} ms eager, {:.3f} replayed '
              '(host staging and the copy back included); {:.1f} crops/s; '
              'peak {:.2f} GB allocated'.format(
                  card, label, want, s, s, b, fwd_eager, fwd_replay,
                  prog_eager, prog_replay, results[label]['crops_per_s'],
                  results[label]['peak_gb']), flush=True)
        del clf, x, x_u8
        torch.cuda.empty_cache()
    return results


def _classifier_card_vs_cpu(device, path, metadata, workdir, card):
    """
    The card against the CPU on 4 crops at 224 px: float32 within rtol
    1e-4 and atol 1e-6; bf16 no further from the CPU's bf16 than that is
    from the CPU's float32; int8 (both on the CPU's calibration, saved and
    loaded) within the CPU's own int8-vs-float32 error, with top-1 equal
    to the CPU's int8 wherever the CPU's top-2 margin exceeds that error.
    """

    import numpy as np

    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    crops = list(np.random.RandomState(4).randint(0, 256, (4, 224, 224, 3),
                                                  dtype=np.uint8))
    small = {'image_size': 224}
    cpu, gpu = {}, {}
    for label, options in (('float32', {}), ('bfloat16', {'dtype':
                                                          'bfloat16'})):
        opts = dict(small, **options)
        cpu[label] = SpeciesClassifier(path, opts, device='cpu') \
            .classify_batch(crops)
        gpu[label] = SpeciesClassifier(path, opts, device=device) \
            .classify_batch(crops)
    clf_cpu = SpeciesClassifier(path, dict(small, quantize='int8'),
                                device='cpu')
    clf_cpu.calibrate(crops)
    q_path = os.path.join(workdir, 'md_smoke_classifier_int8.npz')
    save_checkpoint(clf_cpu.params, q_path, metadata)
    cpu['int8'] = clf_cpu.classify_batch(crops)
    gpu['int8'] = SpeciesClassifier(q_path, dict(small, quantize='int8'),
                                    device=device).classify_batch(crops)

    def err(a, b):
        return float(np.abs(a - b).max())

    f32 = cpu['float32']
    outside = np.abs(gpu['float32'] - f32) > 1e-4 * np.abs(f32) + 1e-6
    if outside.any():
        raise AssertionError('phase 23: card vs CPU float32: {} elements '
                             'outside rtol 1e-4 / atol 1e-6 (max |d| '
                             '{:.3e})'.format(int(outside.sum()),
                                              err(gpu['float32'], f32)))
    own_bf16 = err(cpu['bfloat16'], f32)
    if err(gpu['bfloat16'], cpu['bfloat16']) > own_bf16:
        raise AssertionError('phase 23: card vs CPU bf16 max |d| {:.3e} '
                             'over the CPU\'s own bf16 error {:.3e}'.format(
                                 err(gpu['bfloat16'], cpu['bfloat16']),
                                 own_bf16))
    own_int8 = err(cpu['int8'], f32)
    top2 = np.sort(cpu['int8'], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > own_int8
    if err(gpu['int8'], cpu['int8']) > own_int8 or not np.array_equal(
            gpu['int8'].argmax(1)[clear], cpu['int8'].argmax(1)[clear]):
        raise AssertionError('phase 23: card vs CPU int8 max |d| {:.3e} '
                             '(the CPU\'s own int8 error {:.3e}), or a '
                             'clear top-1 differs'.format(
                                 err(gpu['int8'], cpu['int8']), own_int8))
    print('phase 23 on {}: card vs CPU, 4 crops at 224 px, max |d| of the '
          'probabilities: float32 {:.3e}; bf16 {:.3e} (the CPU\'s own bf16 '
          'against float32 {:.3e}); int8 {:.3e} (the CPU\'s own int8 '
          'against float32 {:.3e}; top-1 equal on {} of 4 crops with a '
          'clear margin)'.format(
              card, err(gpu['float32'], f32), err(gpu['bfloat16'],
                                                  cpu['bfloat16']),
              own_bf16, err(gpu['int8'], cpu['int8']), own_int8,
              int(clear.sum())), flush=True)


def _two_stage_folder(workdir):
    """16 synthetic JPEGs (phase 18's writer) and one 1920x1080 mp4v video
    of 45 frames (phase 21's recipe) in one folder."""

    import cv2
    import numpy as np

    folder = os.path.join(workdir, 'two_stage')
    rng = np.random.RandomState(1)
    _write_folder(folder, _synthetic_images(rng),
                  ['img_{:02d}.jpg'.format(i) for i in range(16)])
    base = _large_image(rng, 1080, 1920)
    out = cv2.VideoWriter(os.path.join(folder, 'clip.mp4'),
                          cv2.VideoWriter_fourcc(*'mp4v'), 30.0,
                          (1920, 1080))
    if not out.isOpened():
        raise AssertionError('cv2.VideoWriter cannot write mp4v')
    for i in range(45):
        out.write(np.ascontiguousarray(np.roll(base, 24 * i,
                                               axis=1)[..., ::-1]))
    out.release()
    return folder


def _reference_classifications(data, folder, classifier, options):
    """SpeciesClassifier.classify_batch on the crops of [data]'s qualifying
    detections in input order (images, then the video's frames), in the
    driver's batches; returns {id(det): top-k}."""

    import numpy as np

    from megadetector_tpu_torch.detection.run_md_and_classifier import \
        _qualifying_detections
    from megadetector_tpu_torch.models.classifier import extract_crop
    from megadetector_tpu_torch.visualization import visualization_utils

    out = {}
    for videos in (False, True):
        dets, crops = [], []
        for im in data['images']:
            if ('frame_rate' in im) != videos:
                continue
            qualifying = [d for _, d in _qualifying_detections(im, options)]
            if not qualifying:
                continue
            if videos:
                frames = dict(_decoded_frames(os.path.join(folder,
                                                           im['file']), 1))
                sources = [frames[d['frame_number']] for d in qualifying]
            else:
                image = np.asarray(visualization_utils.load_image(
                    os.path.join(folder, im['file'])))
                sources = [image] * len(qualifying)
            by_frame = sorted(range(len(qualifying)), key=lambda i: (
                qualifying[i].get('frame_number', 0), i))
            for i in by_frame:
                crop = extract_crop(sources[i], qualifying[i]['bbox'])
                if crop.size:
                    dets.append(qualifying[i])
                    crops.append(classifier.preprocess_crop(crop))
        size = options.classifier_batch_size
        for start in range(0, len(crops), size):
            probs = classifier.classify_batch(crops[start:start + size],
                                              pad_to=size)
            for det, p in zip(dets[start:start + size], probs):
                out[id(det)] = classifier.top_k(
                    p, k=options.top_k_classifications)
    return out


def phase_two_stage(device, workdir, float_path, card):
    """
    23. The species classifier and the two-stage path: the kernels at the
    classifier's shapes (_classifier_kernels), SpeciesClassifier on the
    card (_classifier_on_card), the card against the CPU
    (_classifier_card_vs_cpu), then run_md_and_classifier over 16
    synthetic JPEGs and a 1080p video (frame_sample 4) with phase 4's
    yolov5l6 in bf16 at 1280 px and the classifier in bf16, then int8:
    the classification threshold set so that 500-2000 crops are
    classified, the JSON valid, every qualifying detection classified,
    the results equal to classify_batch on the same crops, launches exact
    (NMS once per selection program, the stem once per detection program,
    bias + SiLU once per activated conv after l0 per detection program and
    per classifier forward, the int8 conv 109 per int8 forward and its
    calibration forward). Returns the (nms, conv, silu) launches of the
    two-stage runs.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection import run_md_and_classifier
    from megadetector_tpu_torch.detection.process_video import \
        ProcessVideoOptions, process_videos
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import ValidateBatchResultsOptions, validate_batch_results
    from megadetector_tpu_torch.utils import path_utils

    start = time.time()
    _classifier_kernels(device, card)
    print('phase 23: kernels {:.1f} s'.format(time.time() - start),
          flush=True)
    path, metadata = _classifier_checkpoint(workdir)
    t0 = time.time()
    _classifier_on_card(device, path, card)
    _classifier_card_vs_cpu(device, path, metadata, workdir, card)
    print('phase 23: classifier {:.1f} s'.format(time.time() - t0),
          flush=True)

    folder = _two_stage_folder(workdir)
    detector = load_detector(float_path, device=device, detector_options={
        'dtype': 'bfloat16', 'pad_batches_to': 8})
    # The threshold that leaves about 1,000 animal detections to classify
    images = load_and_run_detector_batch(
        detector, path_utils.find_images(folder), batch_size=8, quiet=True)
    video_options = ProcessVideoOptions()
    video_options.model_file = detector
    video_options.input_video_file = folder
    video_options.output_json_file = os.path.join(workdir, 'v23.json')
    video_options.frame_sample = 4
    videos = process_videos(video_options)['images']
    confs = sorted((d['conf'] for im in images + videos
                    for d in im['detections'] or [] if d['category'] == '1'),
                   reverse=True)
    if len(confs) < TWO_STAGE_CROPS:
        raise AssertionError('phase 23: only {} animal detections'.format(
            len(confs)))
    threshold = confs[TWO_STAGE_CROPS - 1]

    counted = {}
    n_act = _n_activated_convs(detector.model) - 1
    for label, clf_options in (('bfloat16', {'dtype': 'bfloat16'}),
                               ('int8', {'quantize': 'int8'})):
        options = run_md_and_classifier.MDAndClassifierOptions()
        options.input_folder = folder
        options.output_file = os.path.join(workdir,
                                           'two_stage_{}.json'.format(label))
        options.detector_model = detector
        options.classifier_model = path
        options.classifier_options = clf_options
        options.classification_confidence_threshold = threshold
        options.classifier_batch_size = CLASSIFIER_BATCH
        options.frame_sample = 4
        options.device = device
        programs, selects = detector.programs_run, _select_calls(detector)
        _reset_counts()
        data = run_md_and_classifier.run_md_and_classifier(options)
        nms, conv, _, stem, silu = _counts()
        programs = detector.programs_run - programs
        selects = _select_calls(detector) - selects

        validation = ValidateBatchResultsOptions()
        validation.raise_errors = True
        validation.check_image_existence = False
        validate_batch_results(options.output_file, options=validation)
        reference = SpeciesClassifier(path, clf_options, device=device)
        want = _reference_classifications(data, folder, reference, options)
        n_img = n_vid = 0
        for im in data['images']:
            for det in im['detections'] or []:
                if id(det) in want:
                    if det.get('classifications') != want[id(det)]:
                        raise AssertionError(
                            'phase 23, {}: {} classified {}, classify_batch '
                            'gives {}'.format(label, im['file'],
                                              det.get('classifications'),
                                              want[id(det)]))
                    if 'frame_rate' in im:
                        n_vid += 1
                    else:
                        n_img += 1
                elif 'classifications' in det:
                    raise AssertionError('phase 23, {}: a detection that '
                                         'does not qualify was classified'
                                         .format(label))
        n = n_img + n_vid
        if not TWO_STAGE_RANGE[0] <= n <= TWO_STAGE_RANGE[1] or n_vid == 0:
            raise AssertionError('phase 23, {}: {} crops classified ({} from '
                                 'the video)'.format(label, n, n_vid))
        forwards = -(-n_img // CLASSIFIER_BATCH) - (-n_vid //
                                                     CLASSIFIER_BATCH)
        b2, e7 = efficientnet.forward_launches(
            reference.config, label == 'int8', torch.bfloat16)
        want_counts = (selects, b2 * (forwards + (label == 'int8')),
                       programs, programs * n_act + forwards * e7)
        if (nms, conv, stem, silu) != want_counts:
            raise AssertionError(
                'phase 23, {}: launches (nms, conv, stem, silu) {}, want {} '
                '({} detection programs, {} selection programs, {} '
                'classifier forwards)'.format(
                    label, (nms, conv, stem, silu), want_counts, programs,
                    selects, forwards))
        counted[label] = (nms, conv, silu)
        steps = options.step_seconds
        print('phase 23 on {}: run_md_and_classifier, classifier {}: 16 '
              'JPEGs and a 45-frame 1080p video (frame_sample 4), '
              'classification threshold {:.4f}: {} crops classified ({} '
              'from the video) in {} forwards of {}, equal to classify_batch '
              'on the same crops; launches (nms, conv, stem, silu) {} as '
              'they imply; seconds: detect {:.3f}, crop (the classifier '
              'waiting) {:.3f}, classify {:.3f}, total {:.3f}; {:.1f} '
              'crops/s over crop + classify'.format(
                  card, label, threshold, n, n_vid, forwards,
                  CLASSIFIER_BATCH, (nms, conv, stem, silu), steps['detect'],
                  steps['crop'], steps['classify'], steps['total'],
                  n / (steps['crop'] + steps['classify'])), flush=True)
        del reference
    del detector
    torch.cuda.empty_cache()
    return tuple(sum(c[i] for c in counted.values()) for i in range(3))


#%% 24-27: the serving daemon, E7's backward, detector and classifier
#%% training

SILU_BACKWARD_REPLACES = 'megadetector_tpu/models/yolov5.py:340'
SERVING_CLIENTS = 24
# Phase 24's clients post back to back for this many seconds
SERVING_WINDOW_S = 15.0
# Phase 26's detector (nc 3, seed 0) and canvas, and the canvas of its
# card-vs-CPU step; phase 27's classification.train_classifier.main model
DETECTOR_TRAIN_ARCH = 'yolov5l6'
DETECTOR_TRAIN_SIZE = 1280
DETECTOR_CHECK_SIZE = 320
# Phase 26's Adam steps (the first builds; the rest are timed) and
# learning rate. The yolov5l6 has random He weights and no BN: at lr 1e-3
# (and 1e-4) Adam's first steps move every weight by about lr at once and
# the loss rises by orders of magnitude before it falls; at 1e-5 it stays
# below the first step's loss and falls. No later step's loss may reach
# the first's, and the last must be below DETECTOR_LOSS_FALL of it
DETECTOR_TRAIN_STEPS = 21
DETECTOR_TRAIN_LR = 1e-5
DETECTOR_LOSS_FALL = 0.5
# Phase 27's steady-state classifier steps on one batch on the card
CLASSIFIER_TIMED_STEPS = 21
CLASSIFICATION_MODEL = 'efficientnetv2_s'
CLASSIFICATION_SIZE = 224


def _jpeg_bytes(img, quality=90):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=quality)
    return buf.getvalue()


def _forward_calls(detector):
    """{key: calls} of the forward programs (one per batch shape)."""

    return {key: entry.calls for key, entry in
            detector._programs.entries.items()
            if key[0] == 'forward' and 'select' not in key}


def phase_serving(device, workdir, float_path, card):
    """
    MDServer on port 0 with phase 4's yolov5l6 in bf16 (1280 px auto
    canvases, max_batch_size 8, batch_wait_ms 15), warmed by two batches
    of 8 (both canvases run eagerly, then are captured): 24 client
    threads post /v1/detect back to back for SERVING_WINDOW_S seconds
    (every third request at threshold 0.2), then one /v1/detect_batch of
    8. Latency percentiles and images/s are over the window's requests.
    Every response equals
    generate_detections_one_batch on the decoded image, filtered at its
    threshold; the batch keeps its order;
    /metrics adds up; launches are exact for the forward programs run (one
    padded program per canvas of a batch, NMS once a selection, stem and
    epilogue once per program and activated conv after l0) and every
    canvas's second and later programs replay. Then client.detect_folder
    on 8 JPEGs writes a valid file. Returns the serving run's launches
    (nms, conv, bottleneck, stem, silu).
    """

    import threading

    import numpy as np
    import torch

    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.serving import MDServer, ServingOptions
    from megadetector_tpu_torch.serving import client
    from megadetector_tpu_torch.serving.server import (_decode_image,
                                                       _filter_record)

    images = _synthetic_images(np.random.RandomState(1))
    jpegs = [_jpeg_bytes(im) for im in images]
    options = ServingOptions()
    options.port = 0
    options.max_batch_size = 8
    options.batch_wait_ms = 15.0
    options.device = str(device)
    options.detector_options = {'dtype': 'bfloat16'}
    torch.cuda.reset_peak_memory_stats()
    server = MDServer(float_path, options).start()
    detector = server.detector
    url = 'http://127.0.0.1:{}'.format(server.port)
    try:
        results = []
        errors = []
        lock = threading.Lock()
        stop_at = [None]

        def post_loop(i):
            # One client: requests back to back until the window closes
            k = 0
            try:
                while time.time() < stop_at[0]:
                    j = (i + k * SERVING_CLIENTS) % len(jpegs)
                    threshold = 0.2 if (i + k) % 3 == 0 else None
                    image_id = 'client_{:02d}_{:04d}.jpg'.format(i, k)
                    start = time.time()
                    response = client.detect_image_bytes(
                        url, jpegs[j], image_id=image_id,
                        detection_threshold=threshold)
                    latency = time.time() - start
                    with lock:
                        results.append((image_id, j, threshold, response,
                                        latency))
                    k += 1
            except Exception as e:
                errors.append(e)

        replays_before = detector._programs.replays
        warm = list(zip(['warm_{}.jpg'.format(i) for i in range(8)],
                        jpegs[:8]))
        for _ in range(2):
            client.detect_images(url, warm)
        metrics_before = client.server_metrics(url)
        forwards_before = _forward_calls(detector)
        programs, selects = detector.programs_run, _select_calls(detector)
        _reset_counts()
        start = time.time()
        stop_at[0] = start + SERVING_WINDOW_S
        threads = [threading.Thread(target=post_loop, args=(i,))
                   for i in range(SERVING_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - start
        batch_ids = ['batch_{}.jpg'.format(i) for i in range(8)]
        envelope = client.detect_images(
            url, list(zip(batch_ids, jpegs[8:16])))
        counts = _counts()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError('serving: client errors {}'.format(errors))
        programs = detector.programs_run - programs
        selects = _select_calls(detector) - selects
        forwards_after = _forward_calls(detector)
        forwards = {}
        for key, calls in forwards_after.items():
            n = calls - forwards_before.get(key, 0)
            if n:
                forwards[key[1:4]] = forwards.get(key[1:4], 0) + n
        if any(b != 8 for b, _, _ in forwards):
            raise AssertionError('serving: programs not padded to 8: '
                                 '{}'.format(forwards))
        _check_launches('serving', detector, counts, programs, selects,
                        forwards)
        replays = detector._programs.replays - replays_before
        want_replays = sum(max(calls - 1, 0) for calls in
                           forwards_after.values())
        if replays < want_replays or any(
                detector._programs.entries[k].graph is None
                for k, calls in forwards_after.items() if calls >= 2):
            raise AssertionError(
                'serving: {} replays; every canvas\'s second and later '
                'forward programs must replay ({})'.format(replays,
                                                           want_replays))
        if [r['file'] for r in envelope['images']] != batch_ids:
            raise AssertionError('serving: /v1/detect_batch order {}'.format(
                [r['file'] for r in envelope['images']]))
        metrics = client.server_metrics(url)
        n_window = len(results)
        n_images = n_window + 8
        batches = metrics['batches_total'] - metrics_before['batches_total']
        if (metrics['requests_total'] - metrics_before['requests_total'],
                metrics['images_total'] - metrics_before['images_total'],
                metrics['failures_total'], metrics['rejected_total']) != \
                (n_window + 1, n_images, 0, 0) or \
                abs(metrics['mean_batch_size'] - round(
                    metrics['images_total'] / metrics['batches_total'],
                    2)) > 1e-9 or \
                not batches <= programs <= 2 * batches:
            raise AssertionError('serving: metrics {} against {} programs '
                                 'and {} images'.format(metrics, programs,
                                                        n_images))

        # Each response against the detector on the decoded image: the
        # detector's record of each distinct JPEG, filtered at the
        # request's threshold
        refs = []
        for start_i in range(0, len(jpegs), 8):
            chunk = list(range(start_i, min(start_i + 8, len(jpegs))))
            refs += detector.generate_detections_one_batch(
                [_decode_image(jpegs[j]) for j in chunk],
                ['ref_{}.jpg'.format(j) for j in chunk],
                detection_threshold=options.detection_threshold)
        served = [(image_id, j, threshold, got)
                  for image_id, j, threshold, got, _ in results] + \
            [(batch_ids[i], 8 + i, None, envelope['images'][i])
             for i in range(8)]
        for image_id, j, threshold, got in served:
            ref = dict(refs[j], file=image_id)
            ref = json.loads(json.dumps(_filter_record(
                ref, threshold if threshold is not None else
                options.detection_threshold)))
            if got != ref:
                raise AssertionError(
                    'serving: {} differs from generate_detections_one_'
                    'batch: {} against {}'.format(image_id, got, ref))
        n_det = sum(len(r['detections']) for _, _, _, r in served)
        lat = np.asarray([r[4] for r in results])
        p50, p90, p99 = np.percentile(lat, [50, 90, 99])
        print('serving on {}: {} clients posting back to back for {:.1f} s '
              '({:.3f} s to the last response): {} requests of one image, '
              'then a batch of 8; {} images, {} detections, {} batches, {} '
              'device programs {} (every response equal to '
              'generate_detections_one_batch, batch order kept, metrics add '
              'up); client latency over the window\'s {} requests p50 '
              '{:.4f} s, p90 {:.4f} s, p99 {:.4f} s, max {:.4f} s; {:.3f} '
              'images/s over the window; mean batch fill {:.3f} of 8; {} '
              'replays; {:.2f} GB peak allocated'.format(
                  card, SERVING_CLIENTS, SERVING_WINDOW_S, wall, n_window,
                  n_images, n_det, batches, programs,
                  sorted(forwards.items()), n_window, p50, p90, p99,
                  float(lat.max()), n_window / wall,
                  n_images / (8 * batches), replays,
                  torch.cuda.max_memory_allocated() / 1e9), flush=True)

        # The client's folder run
        folder = os.path.join(workdir, 'serving_folder')
        os.makedirs(folder)
        for i in range(8):
            with open(os.path.join(folder, 'f{}.jpg'.format(i)), 'wb') as f:
                f.write(jpegs[i])
        out_file = os.path.join(workdir, 'serving_folder.json')
        client.detect_folder(url, image_folder=folder, output_file=out_file,
                             chunk_size=8, quiet=True)
        with open(out_file) as f:
            written = json.load(f)
        files = [im['file'] for im in written['images']]
        failed = [im for im in written['images']
                  if im.get('detections') is None]
        report = validate_batch_results(out_file)
        if written['info']['format_version'] != '1.6' or \
                files != sorted(files) or len(files) != 8 or failed or \
                report['validation_results']['validation_errors']:
            raise AssertionError('serving: detect_folder wrote {} ({} '
                                 'failed; validation {})'.format(
                                     files, len(failed), report[
                                         'validation_results']))
        print('serving: client.detect_folder wrote a valid MD file of 8 '
              'images', flush=True)
    finally:
        server.shutdown()
    del server, detector
    torch.cuda.empty_cache()
    return counts


def _training_silu_models():
    """{model: {[N, C, H, W]: launches per forward}} of the bias + SiLU
    epilogue in phase 26's bf16 yolov5l6 step (1280x1280, batch 8; l0 is a
    plain conv on float input) and phase 27's efficientnetv2_s step (224
    px, batch 64)."""

    from megadetector_tpu_torch.models import efficientnet, yolov5

    models = {'yolov5l6': {}, 'efficientnetv2_s': {}}
    for d in yolov5.activated_conv_shapes(
            yolov5.YoloV5Config('yolov5l6', 3), 1280, 1280, 8):
        key = (8, d['cout'], d['ho'], d['wo'])
        models['yolov5l6'][key] = models['yolov5l6'].get(key, 0) + 1
    for key in efficientnet.activated_conv_shapes(
            efficientnet.EfficientNetConfig('efficientnetv2_s', 3, 224),
            224, 64):
        counts = models['efficientnetv2_s']
        counts[key] = counts.get(key, 0) + 1
    return models


def _training_silu_shapes():
    """{[N, C, H, W]: launches per forward} of _training_silu_models' two
    steps together, plus l1's [8,128,240,320] at a 960x1280 canvas (the
    shape of E7's record)."""

    shapes = {(8, 128, 240, 320): 0}
    for counts in _training_silu_models().values():
        for key, n in counts.items():
            shapes[key] = shapes.get(key, 0) + n
    return shapes


def _all_bf16_pairs(gen, layout, offset, device):
    """(x, g, bias) for the exhaustive check: x holds every bf16 bit
    pattern once, as [4, 16, 32, 32] in [layout] ('nchw' or
    'channels_last'), g a seeded normal draw and bias [16] uniform in
    [-1, 1); x and g start [offset] elements into their buffers (1: not
    16-byte aligned, so the kernel takes its one-element path)."""

    import torch

    shape, nhwc = (4, 16, 32, 32), (4, 32, 32, 16)

    def place(flat):
        buf = torch.empty(flat.numel() + 8, dtype=torch.bfloat16,
                          device=device)
        buf[offset:offset + flat.numel()] = flat.to(device)
        view = buf[offset:offset + flat.numel()]
        if layout == 'nchw':
            return view.view(shape)
        return view.view(nhwc).permute(0, 3, 1, 2)

    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = place(bits.view(torch.bfloat16))
    g = place(torch.randn(65536, generator=gen).to(torch.bfloat16))
    bias = (torch.rand(16, generator=gen) * 2 - 1).to(torch.bfloat16).to(
        device)
    return x, g, bias


def phase_silu_backward(device):
    """E7's backward kernel against its plain version: dx bit-identical
    over all 65,536 bf16 x (three seeded g and bias draws, NCHW and
    channels_last, 16-byte aligned and not, with and without a bias);
    then at every distinct shape of phases 26 and 27's bf16 forwards
    (channels_last, as their convs give them): dx identical, db equal to
    silu_bf16_backward_bias_sum_ordered and the same bits over three
    calls; ms of the kernel (back to back, and replayed from a CUDA
    graph), the plain version and aten.silu_backward (no bias, one
    rounding) and the bound. Returns the record (at l1's shape)."""

    import torch

    from megadetector_tpu_torch.ops import silu_bf16

    def same_bits(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    def step(v):
        e = torch.floor(torch.log2(torch.clamp(v.abs().float(),
                                               min=2.0 ** -126)))
        return torch.pow(2.0, e - 7)

    checked = 0
    for seed in range(3):
        for layout in ('nchw', 'channels_last'):
            for offset in (0, 1):
                gen = torch.Generator().manual_seed(25 + seed)
                x, g, bias = _all_bf16_pairs(gen, layout, offset, device)
                for b in (bias, None):
                    dx, db = silu_bf16.silu_bf16_backward(g, x, b)
                    torch.cuda.synchronize()
                    ref, _ = silu_bf16.silu_bf16_backward_reference(g, x, b)
                    if not same_bits(dx, ref):
                        raise AssertionError(
                            'E7 backward: dx differs from the plain version '
                            'over all bf16 x ({}, offset {}, seed {}, {}): '
                            '{} elements'.format(
                                layout, offset, seed,
                                'bias' if b is not None else 'no bias',
                                int((dx.view(torch.int16) !=
                                     ref.view(torch.int16)).sum())))
                    if b is not None and not same_bits(
                            db, silu_bf16.silu_bf16_backward_bias_sum_ordered(
                                dx, aligned=offset == 0)):
                        raise AssertionError(
                            'E7 backward: db differs from the ordered sum '
                            '({}, offset {}, seed {})'.format(layout, offset,
                                                             seed))
                    checked += 1
    print('E7 backward == plain over all 65,536 bf16 x: dx bit-identical in '
          '{} runs (3 seeds x NCHW / channels_last x 16-byte aligned / not '
          'x bias / none; db equal to the ordered sum)'.format(checked),
          flush=True)

    record = None
    max_err = 0.0
    models = _training_silu_models()
    per_step = {name: [0.0, 0.0] for name in models}
    for shape, per_forward in sorted(_training_silu_shapes().items()):
        gen = torch.Generator().manual_seed(sum(shape))
        x = (torch.randn(shape, generator=gen) * 3).to(torch.bfloat16).to(
            device).contiguous(memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen).to(torch.bfloat16).to(
            device).contiguous(memory_format=torch.channels_last)
        bias = (torch.rand(shape[1], generator=gen) * 2 - 1).to(
            torch.bfloat16).to(device)
        dx, db = silu_bf16.silu_bf16_backward(g, x, bias)
        torch.cuda.synchronize()
        ref_dx, ref_db = silu_bf16.silu_bf16_backward_reference(g, x, bias)
        if not same_bits(dx, ref_dx):
            raise AssertionError(
                'E7 backward: dx differs from the plain version at {} ({} '
                'elements)'.format(shape, int((dx != ref_dx).sum())))
        ordered = silu_bf16.silu_bf16_backward_bias_sum_ordered(dx)
        if not same_bits(db, ordered):
            raise AssertionError(
                'E7 backward: db differs from the ordered sum at {} ({} of '
                '{} channels)'.format(shape, int((db != ordered).sum()),
                                      shape[1]))
        for _ in range(2):
            again_dx, again_db = silu_bf16.silu_bf16_backward(g, x, bias)
            if not (same_bits(again_dx, dx) and same_bits(again_db, db)):
                raise AssertionError('E7 backward: a repeated call gave '
                                     'other bits at {}'.format(shape))
        del again_dx, again_db
        d = (db.float() - ref_db.float()).abs()
        if not bool((d <= step(ref_db)).all()):
            raise AssertionError(
                'E7 backward: db beyond one bf16 step of the plain version '
                'at {}: max |d| {:.3e}'.format(shape, float(d.max())))
        n_db = int((d > 0).sum())
        max_err = max(max_err, float(d.max()))
        ms = _time_ms(lambda: silu_bf16.silu_bf16_backward(g, x, bias),
                      reps=10)
        graph_ms = _graph_ms(lambda: silu_bf16.silu_bf16_backward(g, x, bias))
        plain_ms = _time_ms(
            lambda: silu_bf16.silu_bf16_backward_reference(g, x, bias),
            reps=2, warmup=1)
        y = x + bias.view(1, -1, 1, 1)
        lib_ms = _time_ms(lambda: torch.ops.aten.silu_backward(g, y),
                          reps=10)
        n = x.numel()
        bound = _bound(6 * n + 4 * shape[1], 15 * n, F32_OPS_PER_MS)
        for name, counts in models.items():
            per_step[name][0] += counts.get(shape, 0) * ms
            per_step[name][1] += counts.get(shape, 0) * graph_ms
        print('E7 backward == plain (dx bit-identical; db equal to the '
              'ordered sum and the same over 3 calls, {} of {} channels one '
              'bf16 step from the plain version\'s) at {} (x{} a step): '
              'kernel {:.4f} ms ({:.4f} replayed), plain {:.4f} ms, '
              'aten.silu_backward {:.4f} ms, bound {:.4f} ms ({}, {:.0%} of '
              'it)'.format(n_db, shape[1], list(shape), per_forward, ms,
                           graph_ms, plain_ms, lib_ms, bound[0], bound[1],
                           bound[0] / ms), flush=True)
        if shape == (8, 128, 240, 320):
            # Without a bias: no db, so no sums and no bias pass
            nb_dx, _ = silu_bf16.silu_bf16_backward(g, x, None)
            torch.cuda.synchronize()
            nb_ref, _ = silu_bf16.silu_bf16_backward_reference(g, x, None)
            if not same_bits(nb_dx, nb_ref):
                raise AssertionError('E7 backward without a bias: dx '
                                     'differs from the plain version')
            nb_ms = _time_ms(lambda: silu_bf16.silu_bf16_backward(g, x),
                             reps=10)
            nb_bound = _bound(6 * n, 14 * n, F32_OPS_PER_MS)
            print('E7 backward == plain without a bias (dx bit-identical; '
                  'no db) at {}: kernel {:.4f} ms against {:.4f} ms with '
                  'the bias; bound {:.4f} ms ({:.0%} of it)'.format(
                      list(shape), nb_ms, ms, nb_bound[0],
                      nb_bound[0] / nb_ms), flush=True)
            del nb_dx, nb_ref
            record = {'name': 'silu_bf16_backward', 'route': 'cuda',
                      'source': SILU_SOURCE,
                      'replaces': SILU_BACKWARD_REPLACES, 'launches': None,
                      'max_abs_err': None, 'ms': ms, 'plain_ms': plain_ms,
                      'bound_ms': bound[0], 'bound_by': bound[1],
                      'library_ms': lib_ms}
        del x, g, bias, dx, db, ref_dx, ref_db, y, ordered
        torch.cuda.empty_cache()
    record['max_abs_err'] = max_err
    print('E7 backward: {:.3f} ms of kernel time per training step of the '
          'two models together (each shape x its launches per forward; '
          '{:.3f} ms replayed from CUDA graphs); {}'.format(
              sum(v[0] for v in per_step.values()),
              sum(v[1] for v in per_step.values()),
              ', '.join('{} {:.3f} / {:.3f} ms ({} launches)'.format(
                  name, v[0], v[1], sum(models[name].values()))
                  for name, v in per_step.items())), flush=True)
    return record


def _detector_targets(rng, batch):
    import numpy as np

    from megadetector_tpu_torch.training.train_detector import pad_targets

    boxes, classes = [], []
    for _ in range(batch):
        n = rng.randint(1, 9)
        xy = rng.uniform(0.15, 0.85, (n, 2))
        wh = rng.uniform(0.03, 0.3, (n, 2))
        boxes.append(np.concatenate([xy, wh], axis=1).astype(np.float32))
        classes.append(rng.randint(0, 3, n))
    return pad_targets(boxes, classes, max_targets=8)


def _step_spread(step_ms):
    """'mean M ms (median, min-max, sd) over N steps' of the timed steps
    (the first, which builds, is left out)."""

    import numpy as np

    t = np.asarray(step_ms[1:])
    return float(t.mean()), ('{:.1f} ms a step (median {:.1f}, {:.1f}-{:.1f}, '
                             'sd {:.1f}) over {} steps after the first '
                             '({:.1f} ms)'.format(
                                 t.mean(), np.median(t), t.min(), t.max(),
                                 t.std(), len(t), step_ms[0]))


def _timed_optimizer(opt):
    """Wrap opt.step with CUDA events; returns the list its device ms go
    into (read after a synchronize)."""

    import torch

    pairs = []
    inner = opt.step

    def step():
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        inner()
        end.record()
        pairs.append((begin, end))

    opt.step = step
    return pairs


def _train_detector(device, params, dtype, batch,
                    steps=DETECTOR_TRAIN_STEPS, images=None, targets=None):
    """[steps] Adam steps (clip 5, lr DETECTOR_TRAIN_LR) of yolov5l6 on
    one repeated batch at 1280x1280 ([images], uint8 [batch, 1280, 1280,
    3], and their pad_targets [targets], or seeded ones); returns (losses,
    step ms, optimizer ms, peak GB, launches, the activated convs)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.models import yolov5
    from megadetector_tpu_torch.ops import silu_bf16
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training import train_detector as td

    config = yolov5.YoloV5Config(DETECTOR_TRAIN_ARCH, num_classes=3)
    if images is None:
        rng = np.random.RandomState(5)
        side = DETECTOR_TRAIN_SIZE
        images = rng.randint(0, 256, (batch, side, side, 3)).astype(np.uint8)
        targets = _detector_targets(rng, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = yolov5.YoloV5(config).load_params(params).to(device)
    opt = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(5.0), optim.adam(DETECTOR_TRAIN_LR)))
    opt_events = _timed_optimizer(opt)
    train_step = td.make_detector_train_step(config, model, opt, dtype)
    _reset_counts()
    silu_bf16.backward_launches = 0
    losses, times = [], []
    for _ in range(steps):
        start = time.time()
        metrics = train_step(images, *targets)
        losses.append(float(metrics['loss']))
        torch.cuda.synchronize()
        times.append((time.time() - start) * 1e3)
    launches = _counts() + (silu_bf16.backward_launches,)
    opt_ms = [b.elapsed_time(e) for b, e in opt_events]
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_act = _n_activated_convs(model)
    del model, opt, train_step
    torch.cuda.empty_cache()
    return losses, times, opt_ms, peak, launches, n_act


def phase_detector_training(device, params, card):
    """
    yolov5l6 (nc 3, seed 0) at 1280x1280: bf16 at batch 8, then float32
    at batch 8 (4 if 8 does not fit), DETECTOR_TRAIN_STEPS Adam steps each
    on one repeated batch of seeded uint8 images with 1-8 boxes each:
    every loss finite, none above the first, the last below
    DETECTOR_LOSS_FALL of the first; the step's spread and the
    optimizer's share of it; bf16 launches E7 forward and backward once per
    activated conv a step (l0 included: float input, no fused stem) and
    nothing else of ours; float32 launches none. Then one float32 loss and
    backward of yolov5l6 at 320 px, batch 2, on the card against the CPU.
    Returns the E7 forward and backward launches.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.models import yolov5
    from megadetector_tpu_torch.training import train_detector as td

    out = {}
    for name, dtype, batches in (('bf16', torch.bfloat16, (8,)),
                                 ('float32', torch.float32, (8, 4))):
        for batch in batches:
            try:
                out[name] = (batch,) + _train_detector(device, params, dtype,
                                                       batch)
                break
            except torch.cuda.OutOfMemoryError:
                print('detector training: float32 at batch {} does not fit '
                      'in the card\'s memory'.format(batch), flush=True)
                torch.cuda.empty_cache()
        else:
            raise AssertionError('detector training: {} fits no '
                                 'batch'.format(name))
        batch, losses, times, opt_ms, peak, launches, n_act = out[name]
        # On one repeated batch the loss falls: no later step reaches the
        # first step's loss, and the last is below DETECTOR_LOSS_FALL of it
        if not all(np.isfinite(losses)) or max(losses[1:]) >= losses[0] or \
                not losses[-1] < DETECTOR_LOSS_FALL * losses[0]:
            raise AssertionError('detector training {}: losses {}'.format(
                name, losses))
        nms, conv, fused, stem, silu, backward = launches
        steps = len(losses)
        want = (0, 0, 0, 0, steps * n_act, steps * n_act) \
            if name == 'bf16' else (0,) * 6
        if launches != want:
            raise AssertionError(
                'detector training {}: launches (nms, conv, bottleneck, '
                'stem, E7, E7 backward) {}, want {}'.format(name, launches,
                                                              want))
        ms, spread = _step_spread(times)
        print('detector training {} on {}: {} {}x{} batch {}, lr {:g}, '
              'losses {}; eager {}, {:.2f} images/s; the optimizer (clip '
              'and Adam) {:.1f} ms of it (device time between events, mean '
              'after the first); {:.2f} GB peak allocated; E7 {} and E7 '
              'backward {} launches ({} a step each)'.format(
                  name, card, DETECTOR_TRAIN_ARCH, DETECTOR_TRAIN_SIZE,
                  DETECTOR_TRAIN_SIZE, batch, DETECTOR_TRAIN_LR,
                  ['{:.4f}'.format(v) for v in losses], spread,
                  batch * 1e3 / ms, float(np.mean(opt_ms[1:])), peak, silu,
                  backward, silu // steps), flush=True)

    # The card against the CPU: one float32 loss and backward at 320 px
    config = yolov5.YoloV5Config(DETECTOR_TRAIN_ARCH, num_classes=3)
    rng = np.random.RandomState(6)
    side = DETECTOR_CHECK_SIZE
    x = torch.from_numpy(rng.randint(0, 256, (2, side, side, 3)).astype(
        np.float32) / 255.0)
    targets = [torch.from_numpy(a) for a in _detector_targets(rng, 2)]

    def loss_and_grads(dev):
        model = yolov5.YoloV5(config).load_params(params).to(dev)
        model.set_training(torch.float32)
        loss, _ = td.detection_loss(
            config, model, x.to(dev), targets[0].to(dev),
            targets[1].long().to(dev), targets[2].to(dev))
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}

    card_loss, card_grads = loss_and_grads(device)
    cpu_loss, cpu_grads = loss_and_grads('cpu')
    errs = sorted(((float((card_grads[n] - g).abs().max()) /
                    max(float(g.abs().max()), 1e-30), n)
                   for n, g in cpu_grads.items()), reverse=True)
    if abs(card_loss - cpu_loss) > 1e-3 * abs(cpu_loss) or errs[0][0] > 1e-2:
        raise AssertionError(
            'detector training, card vs CPU: loss {} against {}; largest '
            'gradient errors (max |d| / max |ref|) {}'.format(
                card_loss, cpu_loss, errs[:3]))
    print('detector training, card vs CPU (float32, {} px, batch 2): loss '
          '{:.6f} against {:.6f}; gradient max |d| / max |ref| per tensor: '
          'largest {}, median {:.2e}'.format(
              DETECTOR_CHECK_SIZE, card_loss, cpu_loss,
              ['{} {:.2e}'.format(n, e) for e, n in errs[:3]],
              errs[len(errs) // 2][0]), flush=True)
    return out['bf16'][5][4], out['bf16'][5][5]


def _crop_folder(root, rng, n=64):
    import numpy as np
    from PIL import Image

    for cls, base in (('bear', 50), ('deer', 120), ('fox', 190)):
        folder = os.path.join(root, cls)
        os.makedirs(folder)
        for i in range(n):
            h, w = rng.randint(96, 257, 2)
            arr = np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0,
                          255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(
                folder, '{}_{:03d}.jpg'.format(cls, i)), quality=90)


def _classification_dataset(root, crops_dir):
    """classification_ds.csv, label_index.json and splits.json over the
    crop folder: locations loc0-loc2 train, loc3 validates."""

    rows = []
    for cls in sorted(os.listdir(crops_dir)):
        for i, fn in enumerate(sorted(os.listdir(os.path.join(crops_dir,
                                                              cls)))):
            rows.append([cls + '/' + fn, 'ds', 'loc{}'.format(i % 4), cls,
                         '0.9', cls])
    os.makedirs(root)
    with open(os.path.join(root, 'classification_ds.csv'), 'w') as f:
        f.write('path,dataset,location,dataset_class,confidence,label\n')
        for r in rows:
            f.write(','.join(r) + '\n')
    with open(os.path.join(root, 'label_index.json'), 'w') as f:
        json.dump({'0': 'bear', '1': 'deer', '2': 'fox'}, f)
    with open(os.path.join(root, 'splits.json'), 'w') as f:
        json.dump({'train': [['ds', 'loc0'], ['ds', 'loc1'], ['ds', 'loc2']],
                   'val': [['ds', 'loc3']], 'test': []}, f)
    return len(rows)


def phase_classifier_training(device, workdir, card):
    """
    training/train_classifier.train() on a crop folder it writes (3
    classes x 64 JPEGs) with the trainer's defaults (efficientnetv2_s,
    224 px, batch 64), one epoch in float32 and one in bf16: E7 forward
    and backward launches per bf16 step as forward_launches counts them
    (none in float32); the checkpoint loads in the port's
    SpeciesClassifier and its logits equal the trained module's. Then
    classification/train_classifier.main() for one epoch on a dataset it
    writes, with finetune off and on. Returns the E7 forward and backward
    launches.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.models.convert_weights import load_checkpoint
    from megadetector_tpu_torch.ops import silu_bf16
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training import train_classifier as tc

    rng = np.random.RandomState(8)
    crops_dir = os.path.join(workdir, 'train_crops')
    _crop_folder(crops_dir, rng)
    e7 = [0, 0]
    for dtype in ('float32', 'bf16'):
        options = tc.TrainingOptions()
        options.num_epochs = 1
        options.log_every = 1
        options.dtype = dtype
        options.device = str(device)
        ckpt = os.path.join(workdir, 'classifier_{}.npz'.format(dtype))
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        silu_bf16.backward_launches = 0
        start = time.time()
        model, history = tc.train(crops_dir, ckpt, options)
        torch.cuda.synchronize()
        wall = time.time() - start
        launches = _counts() + (silu_bf16.backward_launches,)
        steps = len(history)
        n = efficientnet.forward_launches(model.config, False,
                                          tc.DTYPES[dtype])[1]
        want = (0, 0, 0, 0, steps * n, steps * n)
        if steps != 3 or launches != want or not all(
                np.isfinite(h['loss']) for h in history):
            raise AssertionError(
                'classifier training {}: {} steps, history {}, launches '
                '(nms, conv, bottleneck, stem, E7, E7 backward) {}, want {}'
                .format(dtype, steps, history, launches, want))
        e7[0] += launches[4]
        e7[1] += launches[5]
        clf = SpeciesClassifier(ckpt, device=device)
        side = options.image_size
        x = torch.from_numpy(rng.randint(0, 256, (4, side, side, 3)).astype(
            np.float32) / 255.0).to(device)
        with torch.inference_mode():
            if not torch.equal(clf.model(x), model(x)):
                raise AssertionError('classifier training {}: the '
                                     'checkpoint\'s logits differ from the '
                                     'trained module\'s'.format(dtype))
        # Steady-state step ms: more steps of the trained module on one
        # batch already on the card (after the checkpoint check; not on the
        # main path's counts)
        opt = optim.Optimizer(model.parameters(), optim.chain(
            optim.clip_by_global_norm(1.0), optim.adamw(1e-3)))
        step = tc.make_train_step(model.config, model, opt, 0.1,
                                  tc.DTYPES[dtype])
        images = torch.from_numpy(rng.randint(
            0, 256, (options.batch_size, options.image_size,
                     options.image_size, 3)).astype(np.uint8)).to(device)
        labels = torch.from_numpy(rng.randint(0, 3, options.batch_size)).to(
            device)
        opt_events = _timed_optimizer(opt)
        step_ms = []
        for _ in range(CLASSIFIER_TIMED_STEPS):
            start = time.time()
            step(images, labels)
            torch.cuda.synchronize()
            step_ms.append((time.time() - start) * 1e3)
        ms, spread = _step_spread(step_ms)
        opt_ms = float(np.mean([b.elapsed_time(e)
                                for b, e in opt_events[1:]]))
        print('classifier training {} on {}: {} {} px batch {}, 192 crops, '
              '{} steps, losses {}; {:.2f} images/s over the epoch ({:.2f} '
              's: cv2 decode, the first steps\' set-up), then eager {} on a '
              'batch on the card ({:.1f} images/s; the optimizer (clip and '
              'AdamW) {:.1f} ms of it); {:.2f} '
              'GB peak allocated; E7 {} and E7 backward {} launches ({} a '
              'step each); the checkpoint\'s logits equal the trained '
              'module\'s'.format(
                  dtype, card, options.arch, options.image_size,
                  options.batch_size, steps,
                  ['{:.4f}'.format(h['loss']) for h in history], 192 / wall,
                  wall, spread, options.batch_size * 1e3 / ms, opt_ms,
                  torch.cuda.max_memory_allocated() / 1e9, launches[4],
                  launches[5], n), flush=True)
        del model, clf, opt, step
        torch.cuda.empty_cache()

    ds_dir = os.path.join(workdir, 'classification_ds')
    n_rows = _classification_dataset(ds_dir, crops_dir)
    initial = efficientnet.init_params(
        efficientnet.EfficientNetConfig(CLASSIFICATION_MODEL, 3),
        train_init=True)
    for finetune in (False, True):
        logdir = os.path.join(workdir, 'ctc_{}'.format(finetune))
        torch.cuda.reset_peak_memory_stats()
        start = time.time()
        best = ctc.main(ds_dir, crops_dir, model_name=CLASSIFICATION_MODEL,
                        finetune=finetune, epochs=1,
                        img_size=CLASSIFICATION_SIZE, logdir=logdir, seed=0,
                        device=str(device))
        torch.cuda.synchronize()
        wall = time.time() - start
        trained, _ = load_checkpoint(os.path.join(logdir, 'params.npz'))
        changed = sorted(
            '{}/{}'.format(k, leaf) for k in trained for leaf in (
                trained[k] if 'w' in trained[k] else {})
            if not np.array_equal(trained[k][leaf], initial[k][leaf]))
        if best is None or (finetune and changed != ['fc/b', 'fc/w']):
            raise AssertionError('classification main (finetune {}): best '
                                 '{}, changed {}'.format(finetune, best,
                                                         changed))
        print('classification train_classifier.main (finetune {}) on {}: '
              '{} crops, val acc_top1 {:.2f}, {:.2f} images/s over train + '
              'val ({:.2f} s, PIL augmentation included), {:.2f} GB peak '
              'allocated'.format(finetune, card, n_rows, best['acc_top1'],
                                 n_rows / wall, wall,
                                 torch.cuda.max_memory_allocated() / 1e9),
              flush=True)
    return e7


#%% 28-29: the folder workflow and the inference-options comparison

# Phase 28's detections an image at its confidence threshold (random
# weights emit 300), and the bounds its mean must meet
WORKFLOW_DETECTIONS = 12
WORKFLOW_DETECTION_RANGE = (5, 20)
# Phase 28's detector: phase 4's yolov5l6 with every conv rescaled in
# forward order so its output has std 1 on a synthetic image (random He
# weights without BN grow the activations until bf16 rounding drowns the
# head's signal and every box scores 1.0 at several times the image's
# size), then its detect head rescaled per channel (as
# tests/torch_port_data.py sharpens yolov5n): box outputs to std
# WORKFLOW_BOX_STD (anchor-sized boxes), class logits to std
# WORKFLOW_LOGIT_STD, objectness to that std around WORKFLOW_OBJECTNESS (a
# few boxes an image above RDE's 0.1 floor)
WORKFLOW_BOX_STD = 0.5
WORKFLOW_LOGIT_STD = 2.0
WORKFLOW_OBJECTNESS = -7.5
# Phase 29's images (the 4:3 ones of phase 18's folder: one full batch)
COMPARISON_IMAGES = 8


def _program_calls(detector):
    """{program key: calls so far} of the detector's program cache."""

    return {key: entry.calls
            for key, entry in detector._programs.entries.items()}


def _program_deltas(detector, before):
    """Programs run since [before] (_program_calls): ({(batch, height,
    width): forward or augment programs}, augment?, selection programs,
    new forward or augment keys)."""

    forwards, selects, new, augment = {}, 0, 0, False
    for key, calls in _program_calls(detector).items():
        delta = calls - before.get(key, 0)
        if not delta:
            continue
        if 'select' in key:
            selects += delta
        elif key[0] in ('forward', 'augment'):
            shape = tuple(key[1:4])
            forwards[shape] = forwards.get(shape, 0) + delta
            augment = augment or key[0] == 'augment'
            new += key not in before
    return forwards, augment, selects, new


def _children():
    """Live child processes of this one (from /proc)."""

    pid = str(os.getpid())
    out = []
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            with open(os.path.join('/proc', entry, 'stat')) as f:
                fields = f.read().rsplit(')', 1)[1].split()
        except OSError:
            continue
        if fields[1] == pid and fields[0] != 'Z':
            out.append(int(entry))
    return out


def _workflow_folder(workdir):
    """Phase 18's 64 JPEGs as a job folder of two cameras: the 4:3 ones
    under cam0, the 16:9 ones under cam1 (four full batches of 8 a
    canvas)."""

    import shutil

    source = os.path.join(workdir, 'folder')
    folder = os.path.join(workdir, 'workflow_images')
    for i in range(64):
        camera = os.path.join(folder, 'cam{}'.format(i % 2))
        os.makedirs(camera, exist_ok=True)
        shutil.copyfile(os.path.join(source, 'img_{:02d}.jpg'.format(i)),
                        os.path.join(camera, 'img_{:02d}.jpg'.format(i)))
    return folder


def _tree_bytes(root):
    """{path relative to [root]: bytes} of every file under it."""

    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _without_time(path):
    with open(path) as f:
        data = json.load(f)
    data['info'].pop('detection_completion_time', None)
    return data


def _expected_final_file(job, classifier, c_options):
    """The job's final file rebuilt from its filtered file: classify_batch
    on the qualifying crops (_reference_classifications), then the job's
    post-classification chain run by the port's own functions (non-animal
    classifications stripped, image-level smoothing, unused categories
    dropped)."""

    from megadetector_tpu_torch.postprocessing import \
        classification_postprocessing as cp

    with open(job.filtered_file) as f:
        data = json.load(f)
    want = _reference_classifications(data, job.options.input_path,
                                      classifier, c_options)
    for im in data['images']:
        for det in im['detections'] or []:
            if id(det) in want:
                det['classifications'] = want[id(det)]
    data['classification_categories'] = {
        str(i): name for i, name in enumerate(classifier.class_names)}
    cp.strip_classifications_from_nonanimal_detections(data)
    cp.smooth_classification_results_image_level(
        data, options=job._smoothing_options())
    used = {c[0] for im in data['images']
            for det in im['detections'] or []
            for c in det.get('classifications') or []}
    data['classification_categories'] = {
        k: v for k, v in data['classification_categories'].items()
        if k in used}
    return data, len(want)


def _workflow_checkpoint(device, workdir, float_path):
    """Phase 28's detector (see WORKFLOW_BOX_STD) from phase 4's
    checkpoint, in float32 on [device]: each conv but the detect head's,
    in forward order, scaled so that its output has std 1 on a 4:3
    synthetic image at 320 px; then the detect head per output channel on
    two 4:3 images at the auto canvas. Saved beside it; returns the path."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.models.convert_weights import (
        load_checkpoint, save_checkpoint)
    from megadetector_tpu_torch.models.yolov5 import (Conv, YoloV5,
                                                      YoloV5Config)
    from megadetector_tpu_torch.ops.boxes import letterbox

    params, metadata = load_checkpoint(float_path)
    config = YoloV5Config(metadata['arch'], metadata['num_classes'])
    model = YoloV5(config).load_params(params).eval().to(device)
    images = _synthetic_images(np.random.RandomState(28))[:4:2]

    def batch(size, n):
        x = np.stack([letterbox(img, (size, size), stride=64, auto=True)[0]
                      for img in images[:n]])
        return torch.from_numpy(x.astype(np.float32) / 255.0).to(device)

    small = batch(320, 1)
    convs = [(name, m) for name, m in model.named_modules()
             if type(m) is Conv]
    order, std = [], {}

    def recorder(name):
        def hook(module, inputs, output):
            order.append(name)
            std[name] = float(output.float().std())
        return hook

    with torch.inference_mode():
        hooks = [m.register_forward_hook(recorder(n)) for n, m in convs]
        model(small, decode=False)
        modules = dict(convs)
        scales = {}
        for name in list(dict.fromkeys(order)):
            model(small, decode=False)
            scale = 1.0 / max(std[name], 1e-30)
            modules[name].weight.mul_(scale)
            modules[name].bias.mul_(scale)
            scales[name] = scale
        for hook in hooks:
            hook.remove()
        heads = [h.float().cpu().numpy()
                 for h in model(batch(int(metadata['image_size']), 2),
                                decode=False)]
    del model
    for name, scale in scales.items():
        node = params
        for key in name.split('.')[1:]:
            node = node[key]
        node['w'] = node['w'] * np.float32(scale)
        node['b'] = node['b'] * np.float32(scale)
    no = config.num_outputs
    detect = params['l{}'.format(len(config.layers) - 1)]
    for level, head in enumerate(heads):
        out = head.reshape(-1, head.shape[-1])
        w = detect['m{}'.format(level)]['w']
        b = detect['m{}'.format(level)]['b']
        for channel in range(out.shape[1]):
            kind = channel % no
            std = WORKFLOW_BOX_STD if kind < 4 else WORKFLOW_LOGIT_STD
            scale = std / max(float(out[:, channel].std()), 1e-30)
            w[..., channel] *= scale
            b[channel] = -float(out[:, channel].mean()) * scale + (
                WORKFLOW_OBJECTNESS if kind == 4 else 0.0)
    path = os.path.join(workdir, 'md_smoke_workflow.npz')
    save_checkpoint(params, path, metadata)
    return path


def phase_workflow(device, workdir, float_path, card):
    """
    28. The folder workflow: BatchJob.run_all over phase 18's 64 JPEGs in
    two camera folders, with phase 4's yolov5l6 (its detect head rescaled
    by _workflow_checkpoint) in bf16 (1280 px auto canvases,
    batch 8, 8 loader threads) at the confidence threshold that
    leaves about WORKFLOW_DETECTIONS detections an image, RDE at the
    occurrence threshold of the most frequent repeat (so at least one
    location's repeats are flagged) and phase 23's EfficientNetV2-M in
    bf16 on every detection. Checks: the detections file equals
    load_and_run_detector_batch + write_results_to_file on the same files
    and options; the filtered file equals find_repeat_detections run alone
    on it; the final file equals classify_batch on the same crops followed
    by the job's post-classification chain; the preview's index.html and
    report.csv exist and the report's rows are the final file's images;
    launches exact (_expected_launches, and 147 epilogues a classifier
    forward); every canvas's later programs replayed; no child process
    that the job started left. Then, beside the detector's live CUDA
    context, RDE alone with its comparisons in a spawned process pool
    (its filtered file identical to the job's) and the preview rendered
    in a spawned pool (every file identical to the job's threaded
    preview), and no child process left. Prints each stage's seconds and
    the images/s of the detection stage and of the whole job. Returns the
    (nms, stem, silu) launches of run_all, the detector's checkpoint and
    the confidence threshold.
    """

    import collections
    import csv
    import math
    from multiprocessing import resource_tracker

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import (
        load_and_run_detector_batch, write_results_to_file)
    from megadetector_tpu_torch.detection.run_md_and_classifier import \
        MDAndClassifierOptions
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.postprocessing import \
        postprocess_batch_results as ppr
    from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
        import repeat_detections_core as rde
    from megadetector_tpu_torch.utils import path_utils
    from megadetector_tpu_torch.workflows import manage_local_batch

    start = time.time()
    folder = _workflow_folder(workdir)
    files = path_utils.find_images(folder, recursive=True)
    classifier_path = os.path.join(workdir, 'md_smoke_classifier.npz')
    if not os.path.isfile(classifier_path):
        classifier_path, _ = _classifier_checkpoint(workdir)
    workflow_path = _workflow_checkpoint(device, workdir, float_path)
    detector = load_detector(workflow_path, device=device, detector_options={
        'dtype': 'bfloat16', 'pad_batches_to': 8})

    # The threshold that leaves about WORKFLOW_DETECTIONS an image
    first = load_and_run_detector_batch(detector, files, batch_size=8,
                                        quiet=True)
    confs = sorted((d['conf'] for im in first for d in im['detections']),
                   reverse=True)
    threshold = confs[WORKFLOW_DETECTIONS * len(files) - 1]
    # The occurrence threshold of the most frequent repeat at either
    # camera
    probe = os.path.join(workdir, 'workflow_probe.json')
    write_results_to_file(
        load_and_run_detector_batch(detector, files, batch_size=8,
                                    quiet=True,
                                    confidence_threshold=threshold),
        probe, relative_path_base=folder)
    probe_options = rde.RepeatDetectionOptions()
    probe_options.occurrenceThreshold = 2
    probe_options.bWriteFilteringFolder = False
    repeats = rde.find_repeat_detections(probe, None, probe_options)
    occurrences = max(len({i['filename'] for i in c['instances']})
                      for cs in repeats.suspicious_detections.values()
                      for c in cs) if repeats.suspicious_detections else 0
    print('phase 28: setup {:.1f} s: detect head rescaled; confidences at '
          'ranks 1, 64, 768, 3072 of {}: {}; confidence threshold {:.4f}, '
          'RDE occurrence threshold {} (the most frequent repeat)'.format(
              time.time() - start,
              len(confs), [confs[min(i, len(confs) - 1)]
                           for i in (0, 63, 767, 3071)],
              threshold, occurrences), flush=True)
    if occurrences < 3:
        raise AssertionError('phase 28: no box recurs in 3 images of a '
                             'camera ({})'.format(occurrences))

    options = manage_local_batch.BatchJobOptions()
    options.input_path = folder
    options.output_base = os.path.join(workdir, 'workflow_jobs')
    options.job_name = 'smoke'
    options.model_file = detector
    options.confidence_threshold = threshold
    options.rde_occurrence_threshold = occurrences
    options.preview_sample_size = 100
    options.classifier_model = classifier_path
    options.classifier_options = {'dtype': 'bfloat16'}
    options.classification_confidence_threshold = threshold
    options.device = device
    job = manage_local_batch.BatchJob(options)
    seconds = {}

    def timed(name, method):
        def run(*args, **kwargs):
            t0 = time.time()
            out = method(*args, **kwargs)
            seconds[name] = seconds.get(name, 0.0) + time.time() - t0
            return out
        return run

    for name in ('enumerate_images', 'run_detector', 'validate', 'run_rde',
                 'run_classifier', 'build_preview', 'build_report'):
        setattr(job, name, timed(name, getattr(job, name)))

    # Earlier phases may leave children of their own. multiprocessing's
    # resource tracker, once started, lives as long as this process: it
    # is started before the baseline, so that the spawned pools below
    # are held to leaving nothing
    resource_tracker.ensure_running()
    children = set(_children())
    before = _program_calls(detector)
    replays, programs = detector._programs.replays, detector.programs_run
    _reset_counts()
    t0 = time.time()
    final = job.run_all()
    total = time.time() - t0
    nms, conv, fused, stem, silu = _counts()
    forwards, _, selects, new = _program_deltas(detector, before)
    replays = detector._programs.replays - replays
    programs = detector.programs_run - programs
    left = sorted(set(_children()) - children)
    if left:
        raise AssertionError('phase 28: the job left child processes: '
                             '{}'.format(left))

    # The detections file against the direct calls
    direct = os.path.join(workdir, 'workflow_direct.json')
    write_results_to_file(
        load_and_run_detector_batch(detector, files, batch_size=8,
                                    quiet=True,
                                    confidence_threshold=threshold),
        direct, relative_path_base=folder)
    if _without_time(job.detections_file) != _without_time(direct):
        raise AssertionError('phase 28: the job\'s detections differ from '
                             'load_and_run_detector_batch\'s')
    with open(job.detections_file) as f:
        detections = json.load(f)
    per_image = sum(len(im['detections'] or [])
                    for im in detections['images']) / len(files)
    if not WORKFLOW_DETECTION_RANGE[0] <= per_image <= \
            WORKFLOW_DETECTION_RANGE[1]:
        raise AssertionError('phase 28: {:.2f} detections an image'.format(
            per_image))

    # RDE alone on the detections file, its comparisons in a spawned
    # process pool (one worker a camera) beside the detector's live CUDA
    # context; the job's run used threads
    alone = os.path.join(workdir, 'workflow_rde_alone.json')
    rde_options = rde.RepeatDetectionOptions()
    rde_options.occurrenceThreshold = occurrences
    rde_options.imageBase = folder
    rde_options.outputBase = os.path.join(workdir, 'workflow_rde_alone')
    rde_options.parallelizationUsesThreads = False
    t0 = time.time()
    rde.find_repeat_detections(job.detections_file, alone, rde_options)
    spawned_seconds = {'run_rde': time.time() - t0}
    with open(alone, 'rb') as a, open(job.filtered_file, 'rb') as b:
        if a.read() != b.read():
            raise AssertionError('phase 28: the filtered file differs from '
                                 'find_repeat_detections run alone in '
                                 'spawned processes')

    # The preview again, rendered in a spawned process pool: the same
    # files as the job's threaded preview
    threaded = ppr.process_batch_results

    def spawned(p_options):
        p_options.parallelize_rendering_with_threads = False
        return threaded(p_options)

    ppr.process_batch_results = spawned
    try:
        t0 = time.time()
        manage_local_batch.BatchJob.build_preview(job, stage='spawned')
        spawned_seconds['build_preview'] = time.time() - t0
    finally:
        ppr.process_batch_results = threaded
    preview = _tree_bytes(job.preview_dir)
    if _tree_bytes(job.preview_dir + '_spawned') != preview or \
            'index.html' not in preview:
        raise AssertionError('phase 28: the preview rendered in spawned '
                             'processes differs from the threaded one')
    left = sorted(set(_children()) - children)
    if left:
        raise AssertionError('phase 28: the spawned pools left child '
                             'processes: {}'.format(left))
    with open(job.filtered_file) as f:
        flipped = sum(d['conf'] < 0 for im in json.load(f)['images']
                      for d in im['detections'] or [])
    if flipped < occurrences:
        raise AssertionError('phase 28: RDE flagged {} detections'.format(
            flipped))

    # The classification stage against classify_batch
    reference = SpeciesClassifier(classifier_path, {'dtype': 'bfloat16'},
                                  device=device)
    c_options = MDAndClassifierOptions()
    c_options.classification_confidence_threshold = threshold
    want, n_crops = _expected_final_file(job, reference, c_options)
    with open(final) as f:
        got = json.load(f)
    if got != want or n_crops == 0:
        raise AssertionError('phase 28: the final file differs from '
                             'classify_batch + the post-classification '
                             'chain ({} crops; categories of the filtered '
                             'file\'s detections: {})'.format(
                                 n_crops, sorted(collections.Counter(
                                     (d['category'], d['conf'] >= 0)
                                     for im in want['images']
                                     for d in im['detections'] or [])
                                     .items())))
    forwards_clf = math.ceil(n_crops / c_options.classifier_batch_size)
    _, e7 = efficientnet.forward_launches(reference.config, False,
                                          torch.bfloat16)
    del reference

    # Preview and report
    for path in (os.path.join(job.preview_dir, 'index.html'),
                 job.report_file):
        if not os.path.isfile(path):
            raise AssertionError('phase 28: {} missing'.format(path))
    with open(job.report_file) as f:
        rows = list(csv.DictReader(f))
    typical = got['info']['detector_metadata'].get(
        'typical_detection_threshold', 0.2)
    if [r['image_path'] for r in rows] != \
            [im['file'] for im in got['images']] or any(
                int(r['n_detections']) != sum(
                    d['conf'] >= typical for d in im['detections'] or [])
                for r, im in zip(rows, got['images'])):
        raise AssertionError('phase 28: report.csv\'s rows do not match '
                             'the final file')

    want_counts = _expected_launches(detector, forwards, False, selects)
    want_counts = want_counts[:4] + (want_counts[4] + forwards_clf * e7,)
    if (nms, conv, fused, stem, silu) != want_counts or \
            programs != sum(forwards.values()) or \
            replays < programs - new or any(
                entry.calls > 1 and entry.graph is None
                for key, entry in detector._programs.entries.items()
                if key[0] == 'forward'):
        raise AssertionError(
            'phase 28: launches (nms, conv, bottleneck, stem, silu) {}, '
            'want {} ({} detection programs {}, {} selection programs, {} '
            'classifier forwards); {} replays, {} new programs'.format(
                (nms, conv, fused, stem, silu), want_counts, programs,
                sorted(forwards.items()), selects, forwards_clf, replays,
                new))
    print('phase 28 on {}: BatchJob.run_all over 64 JPEGs in 2 cameras: '
          '{:.2f} detections an image at {:.4f}, {} flagged by RDE, {} '
          'crops classified in {} forwards of 64; detections, filtered '
          'and final files equal to the direct calls; launches (nms, conv, '
          'bottleneck, stem, silu) {} as they imply ({} detection programs '
          '{}, {} replayed); no child process left'.format(
              card, per_image, threshold, flipped, n_crops, forwards_clf,
              want_counts, programs, sorted(forwards.items()), replays),
          flush=True)
    print('phase 28 on {}: spawned process pools beside the live CUDA '
          'context: RDE alone (one worker a camera) {:.3f} s, its filtered '
          'file identical to the job\'s (threads, {:.3f} s); the preview '
          '{:.3f} s, {} files identical to the job\'s (threads, {:.3f} s); '
          'no child process left'.format(
              card, spawned_seconds['run_rde'], seconds['run_rde'],
              spawned_seconds['build_preview'], len(preview),
              seconds['build_preview']), flush=True)
    print('phase 28 on {}: seconds by stage: {}; total {:.3f}; detection '
          'stage {:.3f} images/s (its own measure {:.3f}), whole job '
          '{:.3f} images/s'.format(
              card, ', '.join('{} {:.3f}'.format(k, v)
                              for k, v in seconds.items()),
              total, len(files) / seconds['run_detector'],
              job.detection_images_per_second, len(files) / total),
          flush=True)
    del detector
    torch.cuda.empty_cache()
    return (nms, stem, silu), workflow_path, threshold


def _rescale_calibration():
    """The int8 calibration batch of phases 29 and 37: the two synthetic
    4:3 images that _workflow_checkpoint rescaled on, letterboxed to 320
    px, float32 in [0, 1] (uniform noise gives a chain that scores every
    box of phase 28's rescaled model 0.006)."""

    import numpy as np

    from megadetector_tpu_torch.ops.boxes import letterbox

    return np.stack([
        letterbox(img, (320, 320), stride=64, auto=False)[0]
        for img in _synthetic_images(np.random.RandomState(28))[:4:2]
    ]).astype(np.float32) / 255.0


def _detections_rank_threshold(detector, files, n):
    """The confidence of the [n]th most confident detection of [detector]
    over [files] (load_and_run_detector_batch at batch 8 and its default
    floor): the threshold that leaves [n] detections."""

    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch

    confs = sorted((d['conf'] for im in load_and_run_detector_batch(
        detector, files, batch_size=8, quiet=True)
        for d in im['detections'] or []), reverse=True)
    if len(confs) < n:
        raise AssertionError('{} detections at the floor, want at least {}'
                             .format(len(confs), n))
    return confs[n - 1]


def phase_comparison(device, workdir, float_path, threshold, card):
    """
    29. The inference-options comparison: compare_inference_options over
    COMPARISON_IMAGES of phase 18's 4:3 JPEGs with model_files phase 28's
    yolov5l6 ([float_path]) and its int8 checkpoint (quantize_checkpoint,
    calibrated on the card as phase 37 calibrates: _rescale_calibration),
    detector_options dtype bf16 and conv_backend pallas (the float model
    ignores the backend; the int8 model runs int8 + bf16 as in phase 11),
    canvas modes auto and square, augmentation off and on: 8 jobs. The
    float jobs run at phase 28's confidence threshold (random weights' 300
    boxes an image make the 28 pairs' IoU matching take about a minute),
    the int8 jobs at their own, the one that leaves as many detections
    (WORKFLOW_DETECTIONS an image) on a first auto-canvas pass, printed.
    Checks: each job's file equals load_and_run_detector_batch with that
    job's detector, options and threshold, and holds at least one
    detection; each job's launches exact (_expected_launches, counted from
    0 just before the job); comparison_summary.json valid with 28 pairs
    and every job run. Prints each job's images/s. Returns the summed
    (nms, conv, bottleneck, stem, silu) launches of the jobs.
    """

    import copy
    import shutil

    import torch

    from megadetector_tpu_torch.detection import run_detector_batch as rdb
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint
    from megadetector_tpu_torch.utils import path_utils
    from megadetector_tpu_torch.workflows import \
        compare_inference_options as cio

    start = time.time()
    q_path = os.path.join(workdir, 'md_smoke_workflow_int8.npz')
    quantize_checkpoint(float_path, q_path,
                        calibration_images=_rescale_calibration(),
                        device=device)
    print('phase 29: int8 checkpoint calibrated in {:.1f} s'.format(
        time.time() - start), flush=True)

    folder = os.path.join(workdir, 'comparison_images')
    os.makedirs(folder, exist_ok=True)
    for i in range(COMPARISON_IMAGES):
        name = 'img_{:02d}.jpg'.format(2 * i)
        shutil.copyfile(os.path.join(workdir, 'folder', name),
                        os.path.join(folder, name))
    detector = rdb.load_detector(q_path, device=device, detector_options={
        'dtype': 'bfloat16', 'conv_backend': 'pallas'})
    thresholds = {float_path: threshold, q_path: _detections_rank_threshold(
        detector, path_utils.find_images(folder),
        WORKFLOW_DETECTIONS * COMPARISON_IMAGES)}
    del detector
    torch.cuda.empty_cache()
    print('phase 29 on {}: the float jobs at phase 28\'s threshold {:.4f}, '
          'the int8 jobs at {:.4f} (the confidence ranked {} of an '
          'auto-canvas pass over the {} images)'.format(
              card, threshold, thresholds[q_path],
              WORKFLOW_DETECTIONS * COMPARISON_IMAGES, COMPARISON_IMAGES),
          flush=True)

    loaded = []
    load_detector = rdb.load_detector
    run_job = cio.run_comparison_job

    def recording_load(*args, **kwargs):
        detector = load_detector(*args, **kwargs)
        loaded.append(detector)
        return detector

    totals = [0, 0, 0, 0, 0]
    checked = []

    def counted_job(job, options, image_file_names):
        options = copy.copy(options)
        options.detection_threshold = thresholds[job['model_file']]
        del loaded[:]
        _reset_counts()
        ran = run_job(job, options, image_file_names)
        counts = _counts()
        (detector,) = loaded
        forwards, augment, selects, _ = _program_deltas(detector, {})
        want = _expected_launches(detector, forwards, augment, selects)
        if counts != want:
            raise AssertionError(
                'phase 29, {}: launches (nms, conv, bottleneck, stem, silu) '
                '{}, want {} (programs {}, {} selection programs)'.format(
                    job['job_name'], counts, want, sorted(forwards.items()),
                    selects))
        totals[:] = [a + b for a, b in zip(totals, counts)]
        direct = os.path.join(workdir, 'comparison_direct.json')
        rdb.write_results_to_file(
            rdb.load_and_run_detector_batch(
                detector, list(image_file_names),
                confidence_threshold=options.detection_threshold,
                quiet=True, batch_size=options.batch_size,
                augment=job['augment']),
            direct, relative_path_base=options.input_folder,
            detector_file=str(job['model_file']))
        written = _without_time(job['job_output_file'])
        if _without_time(direct) != written:
            raise AssertionError('phase 29, {}: the job\'s file differs '
                                 'from load_and_run_detector_batch\'s'
                                 .format(job['job_name']))
        n = sum(len(im['detections'] or []) for im in written['images'])
        if not n:
            raise AssertionError('phase 29, {}: no detection at {:.4f}'
                                 .format(job['job_name'],
                                         options.detection_threshold))
        checked.append((job['job_name'], counts, sorted(forwards.items()),
                        n, options.detection_threshold))
        del loaded[:], detector
        torch.cuda.empty_cache()
        return ran

    options = cio.InferenceComparisonOptions()
    options.input_folder = folder
    options.output_folder = os.path.join(workdir, 'comparison')
    options.model_files = [float_path, q_path]
    options.canvas_modes = ['auto', 'square']
    options.augment_states = [False, True]
    options.detector_options = {'dtype': 'bfloat16',
                                'conv_backend': 'pallas'}
    options.visualization_sample = COMPARISON_IMAGES
    options.detection_threshold = threshold
    options.device = device
    rdb.load_detector = recording_load
    cio.run_comparison_job = counted_job
    try:
        start = time.time()
        summary = cio.compare_inference_options(options)
        elapsed = time.time() - start
    finally:
        rdb.load_detector = load_detector
        cio.run_comparison_job = run_job
    with open(summary['summary_file']) as f:
        written = json.load(f)
    if len(written['jobs']) != 8 or any(j['skipped'] for j in
                                        written['jobs']) or \
            len(written.get('pairwise_agreement', [])) != 28 or \
            len(checked) != 8:
        raise AssertionError('phase 29: comparison_summary.json holds {} '
                             'jobs and {} pairs'.format(
                                 len(written['jobs']),
                                 len(written.get('pairwise_agreement', []))))
    for job, (name, counts, forwards, n, at) in zip(written['jobs'],
                                                    checked):
        print('phase 29 on {}: job {}: {:.3f} images/s ({:.3f} s); {} '
              'detections at {:.4f}; launches (nms, conv, bottleneck, stem, '
              'silu) {} as programs {} imply; equal to '
              'load_and_run_detector_batch'.format(
                  card, name, job['images_per_second'], job['elapsed'], n,
                  at, counts, forwards), flush=True)
    print('phase 29 on {}: compare_inference_options: 8 jobs over {} '
          'JPEGs, 28 pairs in comparison_summary.json, {:.1f} s in all'
          .format(card, COMPARISON_IMAGES, elapsed), flush=True)
    return tuple(totals)


#%% 30-33: static int8, the weight gate and the probe, classifier
#   evaluation, the trace

# The JAX package's quantize_params on yolov5l6 (nc 3): its int8 convs,
# 1x1 and 3x3
STATIC_INT8_CONVS = (96, 46, 50)


def phase_static_int8(device, workdir, float_path, pairs, batch, chain,
                      card):
    """
    30. int8 static-scale checkpoints: quantize_checkpoint(mode='static')
    on phase 4's yolov5l6, calibrated on the card on phase 7's two 320 px
    images; load_detector on cuda over the 16 images at batch 8, eager
    then replayed (_eager_then_replayed: identical detections, equal
    launches): the conv kernel (B2, int32 mode) once per static int8 conv
    of each of the two batches (96 a forward), NMS once a selection
    program, nothing else of ours (_expected_launches); then the same in
    bf16, where the stem (once a forward) and the bias + SiLU epilogue
    (once per activated float conv after l0) join them; B2's int32 mode
    against its plain version at the static path's 3x3 s2 (l1) and 1x1
    (l6.cv1) shapes; the card against the CPU at 320 px in both dtypes
    (phase 8's and phase 13's bars); forward and program ms eager and
    replayed beside [chain] (phase 7's program-cache numbers by backend).
    Returns the (NMS, conv, stem, epilogue) launches of both dtypes.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint
    from megadetector_tpu_torch.models.yolov5 import QConv
    from megadetector_tpu_torch.ops import conv_int8

    s_path = os.path.join(workdir, 'md_smoke_int8_static.npz')
    start = time.time()
    calib = np.random.RandomState(1).uniform(
        0, 1, (2, 320, 320, 3)).astype(np.float32)
    quantize_checkpoint(float_path, s_path, mode='static',
                        calibration_images=calib, device=device)
    calib_s = time.time() - start

    torch.cuda.reset_peak_memory_stats()
    detector = load_detector(s_path, device=device,
                             detector_options={'pad_batches_to': 8})
    qconvs = [m for m in detector.model.modules() if isinstance(m, QConv)]
    n_1x1 = sum(m.weight.shape[1] == 1 for m in qconvs)
    if (len(qconvs), n_1x1, len(qconvs) - n_1x1) != STATIC_INT8_CONVS or \
            any(m.y_scale is not None or m.x_scale is None
                for m in qconvs):
        raise AssertionError('static yolov5l6: {} int8 convs ({} 1x1), '
                             'want (int8, 1x1, 3x3) {}'.format(
                                 len(qconvs), n_1x1, STATIC_INT8_CONVS))
    results, counts, batches, rate = _eager_then_replayed(
        detector, pairs, 'int8 static')
    selects = _select_calls(detector) // 3
    want = _expected_launches(detector, {(8, 960, 1280): 1,
                                         (8, 768, 1280): 1}, False, selects)
    if batches != 2 or counts != want or want[1] != 2 * len(qconvs) or \
            any(want[2:]):
        raise AssertionError(
            'int8 static: {} batches (want 2), launches (nms, conv, '
            'bottleneck, stem, silu) {}, want {} ({} selection programs)'
            .format(batches, counts, want, selects))
    n_det = _write_and_check(results, pairs, s_path, os.path.join(
        workdir, 'smoke_int8_static.json'))
    print('int8 static main path on {}: quantize_checkpoint(mode=static) '
          'calibrated on the card in {:.1f} s; 16 images, {} detections, '
          '{} device batches; launches (nms, conv, bottleneck, stem, silu) '
          '{} as _expected_launches has them ({} int8 convs a forward: {} '
          '1x1, {} 3x3; NMS once a selection program); {:.3f} images/s '
          'through load_and_run_detector_batch (third pass, replayed)'
          .format(card, calib_s, n_det, batches, counts, len(qconvs), n_1x1,
                  len(qconvs) - n_1x1, rate), flush=True)

    # The same checkpoint in bf16: the float convs run in bf16 (the stem
    # kernel on l0, the bias + SiLU epilogue after every other activated
    # one), each static conv's epilogue casts to bf16 and its SiLU
    # follows in bf16
    detector_bf16 = load_detector(s_path, device=device, detector_options={
        'pad_batches_to': 8, 'dtype': 'bfloat16'})
    results_bf16, counts_bf16, batches_bf16, rate_bf16 = \
        _eager_then_replayed(detector_bf16, pairs, 'int8 static bf16')
    selects = _select_calls(detector_bf16) // 3
    want = _expected_launches(detector_bf16, {(8, 960, 1280): 1,
                                              (8, 768, 1280): 1}, False,
                              selects)
    if batches_bf16 != 2 or counts_bf16 != want or \
            want[1] != 2 * len(qconvs) or want[2] or want[3] != 2 or \
            not want[4]:
        raise AssertionError(
            'int8 static bf16: {} batches (want 2), launches (nms, conv, '
            'bottleneck, stem, silu) {}, want {} ({} selection programs)'
            .format(batches_bf16, counts_bf16, want, selects))
    n_det = _write_and_check(results_bf16, pairs, s_path, os.path.join(
        workdir, 'smoke_int8_static_bf16.json'))
    print('int8 static bf16 main path on {}: 16 images, {} detections, {} '
          'device batches; launches (nms, conv, bottleneck, stem, silu) {} '
          'as _expected_launches has them; {:.3f} images/s through '
          'load_and_run_detector_batch (third pass, replayed)'.format(
              card, n_det, batches_bf16, counts_bf16, rate_bf16), flush=True)

    # B2's int32 mode at the static path's shapes (l1: 3x3 s2; l6.cv1: 1x1)
    rng = np.random.RandomState(30)
    for name, shape, cout, k, stride, pads in (
            ('l1 3x3 s2 [8,480,640,64]->128', (8, 480, 640, 64), 128, 3,
             (2, 2), (1, 1, 1, 1)),
            ('l6.cv1 1x1 [8,60,80,512]->256', (8, 60, 80, 512), 256, 1,
             (1, 1), (0, 0, 0, 0))):
        x = _int8_input(rng, device, shape)
        w, scale, bias = _int8_conv_case(rng, device, shape[3], cout, k)
        got = conv_int8.conv_int8(x, w, None, None, stride, pads, None)
        torch.cuda.synchronize()
        ref = conv_int8.conv_int8_reference(x, w, None, None, stride, pads,
                                            None)
        if not torch.equal(got, ref):
            raise AssertionError('int32 conv kernel disagrees with its '
                                 'plain version on {}: {} elements differ'
                                 .format(name, int((got != ref).sum())))
        ms = _time_ms(lambda: conv_int8.conv_int8(x, w, None, None, stride,
                                                  pads, None), reps=10)
        plain_ms = _time_ms(lambda: conv_int8.conv_int8_reference(
            x, w, None, None, stride, pads, None), reps=2, warmup=1)
        print('  int32 conv kernel == plain on the static path\'s {}: '
              'kernel {:.4f} ms, plain {:.4f} ms'.format(name, ms, plain_ms),
              flush=True)
        del x, w, got, ref

    # The card against the CPU at 320 px in both dtypes, phase 8's and
    # phase 13's bars
    x = np.random.RandomState(2).rand(2, 320, 320, 3).astype(np.float32)
    for dtype, ours in (('float32', detector), ('bfloat16', detector_bf16)):
        cpu = load_detector(s_path, device='cpu',
                            detector_options={'dtype': dtype})
        with torch.inference_mode():
            ref = cpu.model(torch.from_numpy(x), decode=True).float().numpy()
            got = ours.model(torch.from_numpy(x).to(device),
                             decode=True).float().cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError('int8 static {} forward: shape {} vs {} or '
                                 'non-finite'.format(dtype, got.shape,
                                                     ref.shape))
        d_score = np.percentile(np.abs(got[..., 4:5] * got[..., 5:] -
                                       ref[..., 4:5] * ref[..., 5:]), 99)
        d_xy = np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99)
        if not (d_score < 0.02 and d_xy < 2.0):
            raise AssertionError('int8 static {} card vs CPU: score p99 {} '
                                 '(limit 0.02), xy p99 {} px (limit 2)'
                                 .format(dtype, d_score, d_xy))
        print('int8 static {} card vs CPU yolov5l6 at 320 px: decoded score '
              'p99 |d| {:.3e} (limit 0.02), xy p99 |d| {:.3e} px (limit 2)'
              .format(dtype, d_score, d_xy), flush=True)
        del cpu

    ours = phase_program_cache(detector, batch, 'int8 static')
    ours_bf16 = phase_program_cache(detector_bf16, batch, 'int8 static bf16')
    print('int8 static vs the chain on {}, 960x1280 batch of 8, eager / '
          'replayed ms: forward static {:.3f} / {:.3f}, static bf16 {:.3f} / '
          '{:.3f}, chain xla {:.3f} / {:.3f}, chain pallas {:.3f} / {:.3f}; '
          'whole program static {:.3f} / {:.3f}, static bf16 {:.3f} / '
          '{:.3f}, chain xla {:.3f} / {:.3f}, chain pallas {:.3f} / {:.3f}'
          .format(
              card, ours['forward_eager'], ours['forward_replay'],
              ours_bf16['forward_eager'], ours_bf16['forward_replay'],
              chain['xla']['forward_eager'], chain['xla']['forward_replay'],
              chain['pallas']['forward_eager'],
              chain['pallas']['forward_replay'], ours['program_eager'],
              ours['program_replay'], ours_bf16['program_eager'],
              ours_bf16['program_replay'], chain['xla']['program_eager'],
              chain['xla']['program_replay'],
              chain['pallas']['program_eager'],
              chain['pallas']['program_replay']), flush=True)
    del detector, detector_bf16
    torch.cuda.empty_cache()
    return (counts[0] + counts_bf16[0], counts[1] + counts_bf16[1],
            counts_bf16[3], counts_bf16[4])


def phase_validate_and_probe(device, workdir, float_path, card):
    """
    31. utils/validate_weights on phase 4's checkpoint with skip_export
    (the export stage's eight 1280 px float32 programs would take minutes
    and gigabytes; phase 35 exports on the card), on the card: convert (the
    .npz passes), golden (6 synthetic images at 1280 px through the batch
    driver), int8 (quantize_checkpoint mode='chain' calibrated on the card
    on those images, held to the gate's own default drift bound) and
    capacity; status ok and every stage printed; launches exact: each
    calibration forward launches the conv kernel once per int8 conv
    (dynamic scale, int32 mode), and each detector the gate loads as
    _expected_launches has it from its program cache. Then
    utils/accelerator_test on the card: platform gpu, the NMS kernel's
    smoke test ok. Returns the gate's (NMS, conv) launches.
    """

    from megadetector_tpu_torch.detection import run_detector
    from megadetector_tpu_torch.detection import run_detector_batch
    from megadetector_tpu_torch.ops import quantization
    from megadetector_tpu_torch.utils import accelerator_test
    from megadetector_tpu_torch.utils import validate_weights as vw

    options = vw.ValidateWeightsOptions()
    options.checkpoint = float_path
    options.scratch_dir = os.path.join(workdir, 'validate_weights')
    options.skip_export = True
    options.verbose = False

    # Every detector the gate loads, and every calibration forward's int8
    # convs, for the launches they imply
    detectors, calibrations = [], []
    load, calibrate = run_detector.load_detector, \
        quantization._calibration_forward

    def loading(*args, **kwargs):
        detectors.append(load(*args, **kwargs))
        return detectors[-1]

    def calibrating(*args, **kwargs):
        calibrations.append(calibrate(*args, **kwargs))
        return calibrations[-1]

    run_detector.load_detector = run_detector_batch.load_detector = loading
    quantization._calibration_forward = calibrating
    _reset_counts()
    start = time.time()
    try:
        report = vw.validate_weights(options)
        counts = _counts()
    finally:
        run_detector.load_detector = run_detector_batch.load_detector = load
        quantization._calibration_forward = calibrate
    want = [0, sum(len(convs) for convs in calibrations), 0, 0, 0]
    for detector in detectors:
        forwards, augment, selects, _ = _program_deltas(detector, {})
        for j, n in enumerate(_expected_launches(detector, forwards, augment,
                                                 selects)):
            want[j] += n
    stages = ('convert', 'golden', 'int8', 'capacity', 'export')
    if report['status'] != 'ok' or [report[s]['status'] for s in stages] \
            != ['ok'] * 4 + ['skipped'] or counts != tuple(want) or \
            len(detectors) != 3 or len(calibrations) != 1 or \
            not want[0] or not want[1]:
        raise AssertionError('validate_weights on the card: {}; {} '
                             'detectors, {} calibration forwards; launches '
                             '(nms, conv, bottleneck, stem, silu) {}, want {}'
                             .format(json.dumps(report), len(detectors),
                                     len(calibrations), counts, want))
    print('validate_weights (--skip_export) on {}: status {} in {:.1f} s; '
          'launches (nms, conv, bottleneck, stem, silu) {} as they imply '
          '(a calibration forward of {} int8 convs; {} detectors\' '
          'programs {}); int8 drift held to the gate\'s default bound {}'
          .format(card, report['status'], time.time() - start, counts,
                  len(calibrations[0]), len(detectors),
                  [sorted(_program_deltas(d, {})[0].items())
                   for d in detectors], options.int8_p99_score_drift),
          flush=True)
    del detectors
    for stage in stages:
        print('  {}: {}'.format(stage, json.dumps({
            k: v for k, v in report[stage].items() if k != 'errors'})),
            flush=True)

    result = accelerator_test.accelerator_test(verbose=False,
                                               device=str(device))
    if result['platform'] != 'gpu' or not result['smoke_test_ok'] or \
            result['error'] is not None:
        raise AssertionError('accelerator_test on the card: {}'.format(
            result))
    print('accelerator_test on {}: platform {}, {} device(s) {}, power '
          'limits {}, smoke test ({}) ok in {:.3f} s'.format(
              card, result['platform'], result['n_devices'],
              result['devices'], result['power_limits'],
              result['smoke_test'], result['smoke_test_seconds']),
          flush=True)
    return counts[0], counts[1]


def phase_classifier_evaluation(device, workdir, card):
    """
    32. classification/create_classification_dataset over phase 27's crops
    (each a ground-truth box of a queried image, 4 locations), then
    classification/evaluate_model on the card with phase 27's float32
    classifier (efficientnetv2_s, 224 px): every written probability
    within 2e-6 of classify_batch on the same crops in the same batches
    (the file holds 6 decimals), the confusion matrices, the per-label
    statistics and the overall metrics against a numpy recomputation
    from those probabilities. Returns nothing: the classifier's float32
    forward runs no kernel of ours.
    """

    import shutil

    import numpy as np

    from megadetector_tpu_torch.classification import \
        create_classification_dataset as ccd
    from megadetector_tpu_torch.classification import evaluate_model as em
    from megadetector_tpu_torch.classification.crop_detections import \
        crop_filename
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.visualization import visualization_utils

    src = os.path.join(workdir, 'train_crops')
    ckpt = os.path.join(workdir, 'classifier_float32.npz')
    crops = os.path.join(workdir, 'eval_crops')
    queried = {}
    for cls in sorted(os.listdir(src)):
        for i, fn in enumerate(sorted(os.listdir(os.path.join(src, cls)))):
            image = 'ds/loc{}/{}'.format(i % 4, fn)
            dst = os.path.join(crops, crop_filename(image, 0))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(src, cls, fn), dst)
            queried[image] = {'dataset': 'ds', 'location': 'loc{}'.format(
                i % 4), 'class': cls, 'label': [cls],
                'bbox': [[0.0, 0.0, 1.0, 1.0]]}
    queried_path = os.path.join(workdir, 'eval_queried_images.json')
    with open(queried_path, 'w') as f:
        json.dump(queried, f)
    ds_dir = os.path.join(workdir, 'eval_dataset')
    start = time.time()
    rows, label_index, splits = ccd.create_classification_dataset(
        queried_path, crops, ds_dir, split_fractions=(0.5, 0.25, 0.25))
    ds_s = time.time() - start
    out_dir = os.path.join(workdir, 'eval_out')
    start = time.time()
    overall = em.evaluate_model(ckpt, ds_dir, crops, out_dir, batch_size=32,
                                device=device)
    eval_s = time.time() - start

    names = [label_index[str(i)] for i in range(len(label_index))]
    classifier = SpeciesClassifier(ckpt, device=device)
    columns = [classifier.class_names.index(n) for n in names]
    cms = np.load(os.path.join(out_dir, 'confusion_matrices.npz'))
    with open(os.path.join(out_dir, 'label_stats.csv')) as f:
        stats = [line.strip().split(',') for line in f][1:]
    n_evaluated = 0
    for row in overall:
        split = row['split']
        with open(os.path.join(out_dir, 'outputs_{}.csv'.format(split))) \
                as f:
            f.readline()
            lines = [line.strip().split(',') for line in f]
        images = [np.asarray(visualization_utils.load_image(
            os.path.join(crops, line[0]))) for line in lines]
        probs = np.concatenate([classifier.classify_batch(images[i:i + 32])
                                for i in range(0, len(images), 32)])
        probs = probs[:, columns].astype(np.float64)
        written = np.asarray([line[3:] for line in lines], np.float64)
        labels = np.asarray([names.index(line[1]) for line in lines])
        weights = np.asarray([line[2] for line in lines], np.float64)
        err = float(np.abs(written - probs).max())
        losses = -np.log(probs[np.arange(len(labels)), labels] + 1e-12)
        top3 = np.argsort(-probs, axis=1)[:, :3]
        want = {'loss': losses.mean(),
                'acc_top1': (probs.argmax(1) == labels).mean(),
                'acc_top3': (top3 == labels[:, None]).any(1).mean()}
        cm = np.zeros((len(names), len(names)), np.int64)
        for t, p in zip(labels, probs.argmax(1)):
            cm[t, p] += 1
        recall = [cm[i, i] / max(cm[i].sum(), 1) for i in range(len(names))]
        got_recall = [float(r[3]) for r in stats if r[0] == split]
        if err > 2e-6 or not np.array_equal(cms[split], cm) or any(
                abs(row[k] - v) > 1e-5 * max(1.0, abs(v))
                for k, v in want.items()) or not np.allclose(
                    got_recall, recall, rtol=1e-9) or \
                abs(weights.sum() - len(labels)) > 1e-3:
            raise AssertionError(
                'evaluate_model split {}: probabilities max |d| {} (limit '
                '2e-6), metrics {} vs {}, confusion {} vs {}, recall {} vs '
                '{}'.format(split, err, row, want, cms[split].tolist(),
                            cm.tolist(), got_recall, recall))
        n_evaluated += len(labels)
    if n_evaluated != len(rows) or len(overall) != 3:
        raise AssertionError('evaluate_model: {} of {} crops over {} '
                             'splits'.format(n_evaluated, len(rows),
                                             len(overall)))
    print('create_classification_dataset + evaluate_model on {}: {} crops, '
          '{} labels, splits {}; dataset {:.2f} s, evaluation {:.2f} s '
          '({:.1f} crops/s, efficientnetv2_s float32 224 px, batch 32); '
          'probabilities equal classify_batch on the same crops (6 '
          'decimals), metric files equal their numpy recomputation; {}'
          .format(card, len(rows), len(names),
                  {k: len(v) for k, v in splits.items()}, ds_s, eval_s,
                  len(rows) / eval_s, [
                      {k: round(v, 4) if isinstance(v, float) else v
                       for k, v in row.items()} for row in overall]),
          flush=True)


def phase_trace(device, workdir, float_path, batch, card):
    """
    33. utils/profiling on the card: xla_trace (torch.profiler, CUDA
    activity) around three replayed bf16 programs on [batch] (phase 4's
    yolov5l6, a 960x1280 batch of 8): a lead-in (a window may drop its
    first device activities, PERF.md section 7), then two inside
    annotate('md_program'). The Chrome trace it writes must name that
    span, and the kernels of ours that it attributes to the two spans
    (each kernel's correlation id names the host call that launched it,
    the graph launch inside the span) must be exactly those the
    wrappers' counters give for the two programs: the stem, the bias +
    SiLU epilogue and NMS's two passes. Returns nothing: its launches are
    a trace's, not the main path's.
    """

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.utils import profiling

    detector = load_detector(float_path, device=device, detector_options={
        'dtype': 'bf16'})
    for _ in range(2):
        detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    log_dir = os.path.join(workdir, 'trace')
    start = time.time()
    with profiling.xla_trace(log_dir):
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(2):
            with profiling.annotate('md_program'):
                detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        counts = _counts()
    files = [f for f in os.listdir(log_dir) if f.startswith('trace_')]
    if len(files) != 1:
        raise AssertionError('xla_trace wrote {}'.format(files))
    path = os.path.join(log_dir, files[0])
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('name') == 'md_program' and
             e.get('cat') == 'user_annotation']
    launched_in_span = {
        e['args']['correlation'] for e in events
        if e.get('cat') in ('cuda_runtime', 'cuda_driver') and
        'correlation' in e.get('args', {}) and
        any(a <= e['ts'] <= b for a, b in spans)}
    kernels, attributed = {}, {}
    for e in events:
        if e.get('cat') != 'kernel':
            continue
        kernels[e['name']] = kernels.get(e['name'], 0) + 1
        if e.get('args', {}).get('correlation') in launched_in_span:
            attributed[e['name']] = attributed.get(e['name'], 0) + 1
    ours = {name: sum(n for k, n in attributed.items() if name in k)
            for name in PORT_KERNELS}
    want = {'l0_fused_kernel': counts[3],
            'silu_bf16': counts[4],
            'nms_mask_kernel': counts[0], 'nms_sweep_kernel': counts[0]}
    got = {'l0_fused_kernel': ours['l0_fused_kernel'],
           'silu_bf16': ours['silu_bf16_vec8_kernel'] +
           ours['silu_bf16_kernel'],
           'nms_mask_kernel': ours['nms_mask_kernel'],
           'nms_sweep_kernel': ours['nms_sweep_kernel']}
    if len(spans) != 2 or got != want or not all(want.values()):
        raise AssertionError('trace {}: {} md_program host spans; our '
                             'kernels launched inside them {}, the counters '
                             '{} (two programs)'.format(path, len(spans),
                                                        got, want))
    print('profiling.xla_trace on {} around a lead-in and 2 annotated '
          'replayed bf16 programs ({:.2f} s): {} ({:.1f} MB), {} '
          'md_program host spans, {} kernels in all, {} launched inside '
          'the spans; ours there {}, exactly the counters'.format(
              card, time.time() - start, os.path.relpath(path, workdir),
              os.path.getsize(path) / 1e6, len(spans),
              sum(kernels.values()), sum(attributed.values()), got),
          flush=True)
    del detector
    torch.cuda.empty_cache()


def phase_custom_ops(device):
    """
    34. Each path kernel through its custom operator on CUDA tensors
    against its plain version on the same tensors (plain PyTorch on the
    card, as phases 3, 6 and 9 hold the kernels), under its kernel's bar
    (NMS, the int8 conv and bottleneck, bias + SiLU: identical; the stem:
    l0_fused.plain_bar), and the device-side threshold split against
    threshold_split. Returns the thresholds checked.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, l0_fused, silu_bf16)

    ops = torch.ops.mdtorch
    rng = np.random.RandomState(34)
    checked = []

    def same(label, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError('torch.ops.mdtorch.{} on the card differs '
                                 'from its plain version'.format(label))
        checked.append(label)

    xy = rng.rand(8, 2048, 2).astype(np.float32) * 1200
    wh = rng.rand(8, 2048, 2).astype(np.float32) * 200 + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(device)
    valid = torch.from_numpy(rng.rand(8, 2048) > 0.1).to(device)
    for iou in (0.45, 0.6):
        want = cuda_nms.greedy_nms_keep_reference(boxes, valid, iou)
        same('greedy_nms_keep at {}'.format(iou),
             ops.greedy_nms_keep(boxes, valid, iou), want)
        same('greedy_nms_keep_t at {}'.format(iou), ops.greedy_nms_keep_t(
            boxes, valid, torch.tensor(iou, device=device)), want)

    def int8(shape):
        return torch.from_numpy(rng.randint(-127, 128, shape)
                                .astype(np.int8)).to(device)

    def f32(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(device)

    # l4's 3x3 and its C3's 1x1 at 960x1280 (160x120 at stride 8), batch 2
    x = int8((2, 120, 160, 128))
    for label, w, stride, pads, y_scale, act in (
            ('conv_int8 int32', int8((128, 3, 3, 128)), [1, 1],
             [1, 1, 1, 1], None, True),
            ('conv_int8 silu', int8((128, 3, 3, 128)), [1, 1], [1, 1, 1, 1],
             0.05, True),
            ('conv_int8 linear s2', int8((256, 3, 3, 128)), [2, 2],
             [1, 1, 1, 1], 0.05, False),
            ('conv_int8 1x1', int8((256, 1, 1, 128)), [1, 1], [0, 0, 0, 0],
             0.05, True)):
        scale = f32((w.shape[0],), 1e-5).abs()
        bias = f32((w.shape[0],), 0.1)
        args = (x, w, None if y_scale is None else scale,
                None if y_scale is None else bias, stride, pads, y_scale,
                act)
        same(label, ops.conv_int8(*args),
             conv_int8.conv_int8_reference(*args))
    for shortcut in (True, False):
        args = (x, int8((128, 1, 1, 128)), f32((128,), 1e-5).abs(),
                f32((128,), 0.1), 0.04, int8((128, 3, 3, 128)),
                f32((128,), 1e-5).abs(), f32((128,), 0.1), 0.05, 0.03,
                shortcut)
        same('bottleneck_int8 shortcut={}'.format(shortcut),
             ops.bottleneck_int8(*args),
             bottleneck_int8.bottleneck_int8_reference(*args)[0])
    images = torch.from_numpy(rng.randint(0, 256, (2, 480, 640, 3))
                              .astype(np.uint8)).to(device)
    w, b = l0_fused.prepare_l0_weights({'w': rng.randn(6, 6, 3, 64) * 0.05,
                                        'b': rng.randn(64) * 0.1})
    w, b = w.to(device), b.to(device)
    got = ops.l0_fused(images, w, b)
    n_diff, max_diff, outside = l0_fused.plain_bar(
        got, l0_fused.l0_fused_reference(images, w, b))
    if outside or n_diff > l0_fused.DIFF_SHARE * got.numel():
        raise AssertionError('torch.ops.mdtorch.l0_fused: {} elements '
                             'differ, {} outside the bar'.format(n_diff,
                                                                 outside))
    checked.append('l0_fused ({} elements differ, max {})'.format(
        n_diff, max_diff))
    x = f32((2, 128, 120, 160), 3.0).to(torch.bfloat16)
    bias = f32((128,), 1.0).to(torch.bfloat16)
    same('silu_bf16', ops.silu_bf16(x, bias),
         silu_bf16.silu_bf16_reference(x, bias))
    out = torch.empty_like(x)
    ops.silu_bf16_out(x, bias, out)
    same('silu_bf16_out', out, silu_bf16.silu_bf16_reference(x, bias))

    thresholds = (0.45, 0.6, 0.5, 0.005, 0.1, 0.2, 0.3)
    for t in thresholds:
        m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(t)
        got = cuda_nms.threshold_split_tensor(torch.tensor(
            t, dtype=torch.float32, device=device)).cpu().numpy()
        want = np.array([m, m_hi, m_lo, float(tie_up)])
        if not np.array_equal(got.view(np.int64), want.view(np.int64)):
            raise AssertionError('threshold_split_tensor({}) on the card: '
                                 '{}, threshold_split {}'.format(t, got,
                                                                 want))
    print('custom operators on the card: {}; each equal to its plain '
          'version under its bar; the device threshold split bit for bit '
          'threshold_split\'s at {}'.format('; '.join(checked),
                                              list(thresholds)), flush=True)
    return thresholds


# Phase 35's capacity ladder: random weights escalate every batch to 8192
EXPORT_LADDER = [512, 1024, 2048, 4096, 8192]


def _program_ms(detector, batch, graphs):
    """Mean ms of detector.run_program on [batch] (thresholds 0.005 and
    0.45), eager (graphs False) or replayed; the outputs read back."""

    detector._cuda_graphs = graphs
    try:
        return _time_ms(lambda: detector.run_program(batch, 0.005, 0.45),
                        reps=10 if graphs else 3)
    finally:
        detector._cuda_graphs = True


def phase_export(device, workdir, float_path, q_path, pairs, card):
    """
    35. The exported artifact on the card for bf16 and the int8 chain
    under conv_backend=pallas: results identical to the live detector's,
    eager and replayed, with equal launches. Returns the artifact's
    launches (nms, conv, bottleneck, stem, silu) over its runs.
    """

    import numpy as np

    from megadetector_tpu_torch.detection import export_detector as ed
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch

    totals = [0] * 5
    for label, path, options in (
            ('bf16', float_path, {'dtype': 'bf16'}),
            ('int8 pallas', q_path, {'conv_backend': 'pallas'})):
        artifact = os.path.join(workdir, 'export_{}.mdpkg'.format(
            label.replace(' ', '_')))
        start = time.time()
        manifest = ed.export_detector(
            path, artifact, batch_sizes=[8], aspects=['4:3', '5:3'],
            topk_ladder=EXPORT_LADDER, platforms=['cuda'],
            detector_options=options)
        export_s = time.time() - start
        artifact_mb = os.path.getsize(artifact) / 1e6
        start = time.time()
        exported = load_detector(artifact, device=device)
        load_s = time.time() - start
        live = load_detector(path, detector_options=options, device=device)
        runs = {}
        for name, detector in (('live', live), ('artifact', exported)):
            runs[name] = []
            for _ in range(2):
                _reset_counts()
                results = load_and_run_detector_batch(
                    detector, pairs, batch_size=8, quiet=True)
                runs[name].append((results, _counts()))
        for i, kind in enumerate(('eager', 'replayed')):
            if runs['artifact'][i][0] != runs['live'][i][0]:
                raise AssertionError('{} artifact: {} results differ from '
                                     'the live detector\'s'.format(label,
                                                                   kind))
            if runs['artifact'][i][1] != runs['live'][i][1]:
                raise AssertionError(
                    '{} artifact: {} launches (nms, conv, bottleneck, stem, '
                    'silu) {}, live {}'.format(label, kind,
                                               runs['artifact'][i][1],
                                               runs['live'][i][1]))
        if runs['artifact'][0][0] != runs['artifact'][1][0] or \
                exported._programs.replays == 0:
            raise AssertionError('{} artifact: replayed results differ from '
                                 'eager, or nothing replayed'.format(label))
        for i in range(2):
            totals = [a + b for a, b in zip(totals, runs['artifact'][i][1])]
        infos = [live.preprocess_image(img, image_id=name)
                 for name, img in pairs[:16:2]]
        batch = np.stack([info['img_processed'] for info in infos])
        ms = {name: (_program_ms(d, batch, False), _program_ms(d, batch,
                                                               True))
              for name, d in (('live', live), ('artifact', exported))}
        n_det = sum(len(r['detections']) for r in runs['artifact'][0][0])
        print('export {} on {}: {} programs ({} canvases, capacities {}) '
              'in {:.1f} s, artifact {:.1f} MB, loaded in {:.2f} s; 16 '
              'images through load_and_run_detector_batch, eager then '
              'replayed: {} detections identical to the live detector\'s, '
              'launches (nms, conv, bottleneck, stem, silu) {} and {} equal '
              'to its; program on a {}x{} batch of 8: artifact {:.3f} / '
              '{:.3f} ms eager / replayed, live {:.3f} / {:.3f} ms'.format(
                  label, card, len(manifest['program_sha256']),
                  manifest['canvases'], manifest['topk_ladder'], export_s,
                  artifact_mb, load_s, n_det, runs['artifact'][0][1],
                  runs['artifact'][1][1], batch.shape[1], batch.shape[2],
                  ms['artifact'][0], ms['artifact'][1], ms['live'][0],
                  ms['live'][1]), flush=True)
        del exported, live
        os.remove(artifact)
    return totals


def phase_integration(workdir, card, cli):
    """36. utils/integration_tests on the card: its Python tiers, and
    with [cli] its CLI tier."""

    from megadetector_tpu_torch.utils import integration_tests

    options = integration_tests.MDTestOptions()
    options.scratch_dir = os.path.join(workdir, 'integration')
    options.force_cpu = False
    options.verbose = False
    options.skip_cli_tests = not cli
    start = time.time()
    status = integration_tests.run_tests(options)
    expected = ['single_image', 'batch_folder', 'augmented', 'video',
                'tiled', 'postprocessing'] + (['cli'] if cli else [])
    if sorted(status) != sorted(expected) or \
            set(status.values()) != {'ok'}:
        raise AssertionError('integration tests on the card: {}'.format(
            status))
    print('integration tests on {}: {} in {:.1f} s{}'.format(
        card, json.dumps(status), time.time() - start,
        '' if cli else ' (the CLI tier runs with --cli)'), flush=True)



#%% 37: the detection-postprocessing tools


def _counted_detection(label, detector, model_file, files, folder,
                       threshold, out_file):
    """load_and_run_detector_batch (batch 8) over [files] at [threshold],
    then write_results_to_file relative to [folder] (its detector named
    [model_file]); the launches counted
    from 0 just before and held to what its programs imply
    (_check_launches). Returns the (nms, conv, bottleneck, stem, silu)
    launches and the programs run."""

    from megadetector_tpu_torch.detection.run_detector_batch import (
        load_and_run_detector_batch, write_results_to_file)

    before = _program_calls(detector)
    programs = detector.programs_run
    _reset_counts()
    results = load_and_run_detector_batch(detector, files, batch_size=8,
                                          quiet=True,
                                          confidence_threshold=threshold)
    counts = _counts()
    forwards, _, selects, _ = _program_deltas(detector, before)
    _check_launches(label, detector, counts, detector.programs_run -
                    programs, selects, forwards)
    write_results_to_file(results, out_file, relative_path_base=folder,
                          detector_file=model_file)
    return counts, sum(forwards.values())


def _detections(data):
    """{file: detections} of a results dict."""

    return {im['file']: im['detections'] for im in data['images']}


def phase_postprocessing(device, workdir, workflow_path, classifier_path,
                         threshold, card):
    """
    37. The detection-postprocessing tools on two detectors' results:
    over phase 28's workflow folder (64 JPEGs in two cameras), detector A
    ([workflow_path], phase 28's yolov5l6, bf16) at phase 28's confidence
    threshold and detector B (the int8 chain of the same checkpoint,
    quantize_checkpoint calibrated on the card on the two 320 px images
    that _workflow_checkpoint rescaled on, conv_backend pallas, bf16) at
    the threshold that leaves as many detections, each through
    load_and_run_detector_batch (batch 8) and write_results_to_file,
    launches exact (_expected_launches; the calibration one conv kernel
    launch a chain conv). Then merge_detections of B into A (A's
    detections kept, the file valid), compare_model_confidence_values
    and calibrate_threshold of A against B (matched pairs above 0);
    add_max_conf, categorize_detections_by_size, a category remap, the
    JSON -> CSV -> JSON round trip (A's detections back), load_api_results
    (64 rows), md_to_coco, md_to_labelme and md_to_wi of A;
    render_detection_confusion_matrix of B against A's COCO file;
    separate_detections_into_folders of A (each image in one folder),
    then top_folders_to_bottom; create_crop_folder of A (one crop for
    each detection its options select), the crops classified on the card
    by the EfficientNetV2-M at [classifier_path] in bf16
    (SpeciesClassifier.classify_batch, batches of 64, 147 bias + SiLU
    launches a forward, exact), their MD-format file mapped back with
    crop_results_to_image_results (each cropped detection given its
    crop's classifications). Prints each step's seconds and whether
    matplotlib is installed (the plots are held to the JAX package on the
    CPU). Returns the phase's (nms, conv, bottleneck, stem, silu)
    launches.
    """

    import importlib.util
    import math
    import shutil

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint
    from megadetector_tpu_torch.postprocessing import (
        add_max_conf, categorize_detections_by_size, convert_output_format,
        create_crop_folder, detector_calibration, load_api_results,
        md_to_coco, md_to_labelme, md_to_wi, merge_detections,
        remap_detection_categories, render_detection_confusion_matrix,
        separate_detections_into_folders, top_folders_to_bottom)
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.utils import ct_utils, path_utils
    from megadetector_tpu_torch.visualization import visualization_utils

    start = time.time()
    print('phase 37: matplotlib {} on this machine (plot_utils and the '
          'calibration plot are held to the JAX package on the CPU)'.format(
              'present' if importlib.util.find_spec('matplotlib')
              else 'absent'), flush=True)
    folder = _workflow_folder(workdir)
    files = path_utils.find_images(folder, recursive=True)
    out = os.path.join(workdir, 'postprocessing')
    os.makedirs(out, exist_ok=True)
    seconds = {}
    totals = [0, 0, 0, 0, 0]

    def step(name, fn):
        t0 = time.time()
        value = fn()
        seconds[name] = time.time() - t0
        return value

    def fail(message):
        raise AssertionError('phase 37: ' + message)

    # 1. Two detectors' results, written by the card. B is the int8 chain
    # of A's checkpoint calibrated on the two images A's rescale used
    # (_rescale_calibration, as phase 29's); it runs at its own threshold,
    # the one that leaves as many detections as A's
    q_path = os.path.join(out, 'workflow_int8_images.npz')
    _reset_counts()
    step('quantize_B', lambda: quantize_checkpoint(
        workflow_path, q_path, calibration_images=_rescale_calibration(),
        device=device))
    calibration_counts = _counts()
    thresholds = {'A': threshold}
    result_files = []
    for label, path, options in (
            ('A', workflow_path, {'dtype': 'bfloat16'}),
            ('B', q_path, {'dtype': 'bfloat16', 'conv_backend': 'pallas'})):
        result_file = os.path.join(out, 'results_{}.json'.format(label))

        def run():
            detector = load_detector(path, device=device,
                                     detector_options=options)
            if label not in thresholds:
                thresholds[label] = _detections_rank_threshold(
                    detector, files, WORKFLOW_DETECTIONS * len(files))
            counts = _counted_detection(
                'phase 37 on {}, detector {} ({}) over {} JPEGs at '
                '{:.4f}'.format(card, label, options, len(files),
                                thresholds[label]),
                detector, path, files, folder, thresholds[label],
                result_file)
            del detector
            torch.cuda.empty_cache()
            return counts

        counts, programs = step('detect_' + label, run)
        totals = [a + b for a, b in zip(totals, counts)]
        result_files.append(result_file)
    # The calibration ran the int8 chain's convs once each (B2 in its
    # int32 mode): as many as one of B's forwards runs, fused or not
    chain = (counts[1] + 2 * counts[2]) // programs
    if calibration_counts != (0, chain, 0, 0, 0):
        fail('the calibration\'s launches (nms, conv, bottleneck, stem, '
             'silu) {}, want {} conv'.format(calibration_counts, chain))
    totals[1] += calibration_counts[1]
    a_file, b_file = result_files
    with open(a_file) as f:
        a = json.load(f)
    with open(b_file) as f:
        n_b = sum(len(im['detections'] or []) for im in json.load(f)['images'])
    a_detections = _detections(a)
    n_a = sum(len(d or []) for d in a_detections.values())

    # 2. Merge B into A
    merged_file = os.path.join(out, 'merged.json')
    merged = step('merge_detections', lambda: merge_detections
                  .merge_detections([b_file], a_file, merged_file))
    transferred = 0
    for fn, dets in _detections(merged).items():
        kept = a_detections[fn] or []
        if (dets or [])[:len(kept)] != kept:
            fail('merge_detections changed A\'s detections of ' + fn)
        transferred += len(dets or []) - len(kept)
    errors = validate_batch_results(merged_file)['validation_results']
    if errors['validation_errors']:
        fail('the merged file is invalid: {}'.format(
            errors['validation_errors'][:3]))

    # 3. Calibrate A against B
    matches = step('calibration', lambda: detector_calibration
                   .compare_model_confidence_values(a_file, b_file)
                   .calibration_matches)
    calibrated = step('calibrate_threshold', lambda: detector_calibration
                      .calibrate_threshold(a_file, b_file, threshold))
    if not matches:
        fail('no detection of A matched one of B')
    print('phase 37 on {}: A {} detections, B {}; {} of B\'s merged into '
          'A (the file valid); {} matched pairs of A and B, A\'s threshold '
          '{:.4f} is B\'s {:.4f} (B ran at {:.4f})'.format(
              card, n_a, n_b, transferred, len(matches), threshold,
              calibrated, thresholds['B']), flush=True)

    # 4. A through the conversion tools
    with_max = step('add_max_conf', lambda: add_max_conf.add_max_conf(
        a_file, os.path.join(out, 'max_conf.json')))
    if any(im['max_detection_conf'] != ct_utils.get_max_conf(im)
           for im in with_max['images']):
        fail('add_max_conf')
    size_options = categorize_detections_by_size.SizeCategorizationOptions()
    size_options.size_thresholds = [0.01, 0.05]
    size_options.size_category_names = ['medium', 'large']
    sized = step('categorize_by_size', lambda: categorize_detections_by_size
                 .categorize_detections_by_size(
                     a_file, os.path.join(out, 'sized.json'), size_options))
    recategorized = sum(d['category'] not in a['detection_categories']
                        for im in sized['images']
                        for d in im['detections'] or [])
    names = a['detection_categories']
    target = {str(len(names) - i): name
              for i, name in enumerate(sorted(names.values()))}
    remapped = step('remap_categories', lambda: remap_detection_categories
                    .remap_detection_categories(
                        a_file, os.path.join(out, 'remapped.json'), target))
    if [[target[d['category']] for d in im['detections'] or []]
            for im in remapped['images']] != \
            [[names[d['category']] for d in a_detections[im['file']] or []]
             for im in remapped['images']]:
        fail('remap_detection_categories changed a category\'s name')

    def round_trip():
        csv_file = convert_output_format.convert_json_to_csv(
            a_file, os.path.join(out, 'a.csv'))
        return convert_output_format.convert_csv_to_json(
            csv_file, os.path.join(out, 'a_from_csv.json'))

    with open(step('csv_round_trip', round_trip)) as f:
        if _detections(json.load(f)) != a_detections:
            fail('the CSV round trip changed A\'s detections')
    table, _ = step('load_api_results',
                    lambda: load_api_results.load_api_results(a_file))
    if len(table) != len(files):
        fail('load_api_results read {} rows'.format(len(table)))
    coco_file = os.path.join(out, 'coco.json')
    coco = step('md_to_coco', lambda: md_to_coco.md_to_coco(
        a_file, coco_file, image_folder=folder))
    if len(coco['images']) != len(files) or \
            len(coco['annotations']) != n_a or \
            any(im['width'] is None for im in coco['images']):
        fail('md_to_coco: {} images, {} boxes'.format(
            len(coco['images']), len(coco['annotations'])))
    labelme_folder = os.path.join(out, 'labelme')
    shutil.copytree(folder, labelme_folder)
    written = step('md_to_labelme', lambda: md_to_labelme.md_to_labelme(
        a_file, labelme_folder))
    wi = step('md_to_wi', lambda: md_to_wi.md_to_wi(
        a_file, os.path.join(out, 'wi.json')))
    if len(written) != len(files) or len(wi['predictions']) != len(files):
        fail('{} labelme files, {} WI predictions'.format(
            len(written), len(wi['predictions'])))

    # 5. B against A's COCO file as ground truth
    confusion_file = os.path.join(out, 'confusion.html')
    confusion = step('confusion_matrix', lambda:
                     render_detection_confusion_matrix
                     .render_detection_confusion_matrix(
                         b_file, coco_file, confusion_file,
                         confidence_threshold=thresholds['B']))
    if not os.path.isfile(confusion_file) or \
            not confusion['per_category']:
        fail('render_detection_confusion_matrix wrote nothing')

    # 6. Folders by class, then by camera
    separate_options = \
        separate_detections_into_folders.SeparateDetectionsIntoFoldersOptions()
    separate_options.results_file = a_file
    separate_options.base_input_folder = folder
    separate_options.base_output_folder = os.path.join(out, 'separated')
    mapping = step('separate_into_folders', lambda:
                   separate_detections_into_folders
                   .separate_detections_into_folders(separate_options))
    separated = sorted(_tree_bytes(separate_options.base_output_folder))
    if sorted(mapping) != [os.path.relpath(p, folder) for p in files] or \
            separated != sorted(
            os.path.relpath(p, separate_options.base_output_folder)
            for p in mapping.values()):
        fail('separate_detections_into_folders: {} files for {} '
             'images'.format(len(separated), len(files)))
    bottom_options = top_folders_to_bottom.TopFoldersToBottomOptions(
        separate_options.base_output_folder,
        os.path.join(out, 'by_camera'))
    bottom = step('top_folders_to_bottom', lambda: top_folders_to_bottom
                  .top_folders_to_bottom(bottom_options))
    if len(bottom) != len(files):
        fail('top_folders_to_bottom moved {} files'.format(len(bottom)))

    # 7. The crop folder, its crops classified on the card, mapped back
    crop_options = create_crop_folder.CreateCropFolderOptions()
    crops_folder = os.path.join(out, 'crops')
    tagged_file = os.path.join(out, 'tagged.json')
    crops_file = os.path.join(out, 'crops.json')
    tagged = step('create_crop_folder', lambda: create_crop_folder
                  .create_crop_folder(a_file, folder, crops_folder,
                                      tagged_file, crops_file,
                                      crop_options))
    # The detections the options select; those whose box covers no pixel
    # (visualization_utils.crop_image's rounding) give no crop file
    sizes = {im['file_name']: (im['width'], im['height'])
             for im in coco['images']}
    selected, empty = 0, 0
    for fn, dets in a_detections.items():
        w, h = sizes[fn]
        for d in dets or []:
            if d['conf'] < crop_options.confidence_threshold or (
                    crop_options.categories_to_crop is not None and
                    d['category'] not in crop_options.categories_to_crop):
                continue
            x, y, bw, bh = d['bbox']
            selected += 1
            empty += min(int(round((x + bw) * w)), w) <= \
                max(int(round(x * w)), 0) or \
                min(int(round((y + bh) * h)), h) <= max(int(round(y * h)), 0)
    with open(crops_file) as f:
        crops = json.load(f)
    n_tagged = sum('crop_filename' in d for im in tagged['images']
                   for d in im['detections'] or [])
    n_written = len(_tree_bytes(crops_folder))
    if not selected == n_tagged == len(crops['images']) or \
            n_written != selected - empty or n_written == 0:
        fail('{} detections selected ({} of them empty), {} tagged, {} '
             'crop records, {} crop files'.format(
                 selected, empty, n_tagged, len(crops['images']),
                 n_written))
    crops['images'] = [im for im in crops['images'] if os.path.isfile(
        os.path.join(crops_folder, im['file']))]

    classifier = SpeciesClassifier(classifier_path, {'dtype': 'bfloat16'},
                                   device=device)

    def classify():
        arrays = [classifier.preprocess_crop(np.asarray(
            visualization_utils.load_image(os.path.join(
                crops_folder, im['file'])))) for im in crops['images']]
        _reset_counts()
        for first in range(0, len(arrays), CLASSIFIER_BATCH):
            probs = classifier.classify_batch(
                arrays[first:first + CLASSIFIER_BATCH],
                pad_to=CLASSIFIER_BATCH)
            for im, p in zip(crops['images'][first:], probs):
                im['detections'][0]['classifications'] = \
                    classifier.top_k(p, k=5)
        return _counts()

    counts = step('classify_crops', classify)
    forwards = math.ceil(len(crops['images']) / CLASSIFIER_BATCH)
    _, e7 = efficientnet.forward_launches(classifier.config, False,
                                          torch.bfloat16)
    if counts != (0, 0, 0, 0, forwards * e7):
        fail('the classifier\'s launches (nms, conv, bottleneck, stem, '
             'silu) {} over {} forwards, want {} bias + SiLU a forward'
             .format(counts, forwards, e7))
    totals = [a + b for a, b in zip(totals, counts)]
    crops['classification_categories'] = {
        str(i): name for i, name in enumerate(classifier.class_names)}
    del classifier
    torch.cuda.empty_cache()
    classified_file = os.path.join(out, 'crops_classified.json')
    ct_utils.write_json(classified_file, crops)
    final = step('crop_results_to_image_results', lambda: create_crop_folder
                 .crop_results_to_image_results(
                     tagged_file, classified_file,
                     os.path.join(out, 'final.json')))
    with open(classified_file) as f:
        by_crop = {im['file']: im['detections'][0]['classifications']
                   for im in json.load(f)['images']}
    mapped = [d.get('classifications') == by_crop[d['crop_filename']]
              for im in final['images'] for d in im['detections'] or []
              if d.get('crop_filename') in by_crop]
    if len(mapped) != n_written or not all(mapped):
        fail('{} of {} cropped detections carry their crop\'s '
             'classifications'.format(sum(mapped), n_written))
    print('phase 37 on {}: {} recategorized by size; 64 rows, {} COCO '
          'boxes, {} labelme files, {} WI predictions, {} images in {} '
          'folders and back by camera; confusion matrix of B against A '
          '{}; {} crops written ({} boxes too small to crop), classified '
          'in {} forwards of {} (launches '
          '(nms, conv, bottleneck, stem, silu) {}) and mapped back onto '
          'every cropped detection'.format(
              card, recategorized, len(coco['annotations']), len(written),
              len(wi['predictions']), len(mapping),
              len({os.path.dirname(os.path.relpath(
                  p, separate_options.base_output_folder)).split(os.sep)[0]
                   for p in mapping.values()}),
              json.dumps(confusion['per_category'], sort_keys=True),
              n_written, empty, forwards, CLASSIFIER_BATCH, counts),
          flush=True)
    print('phase 37 on {}: seconds by step: {}; total {:.3f}'.format(
        card, ', '.join('{} {:.3f}'.format(k, v)
                        for k, v in seconds.items()),
        time.time() - start), flush=True)
    return tuple(totals)


#%% 38: the classifier-training workflow

# Phase 38's label spec (output_label,type,content): two labels over the
# two cameras' datasets, canid capped and cam1 sampled first
WORKFLOW_SPEC_CSV = (
    'output_label,type,content\n'
    'cervid,row,cam0|deer\n'
    'cervid,row,cam1|deer\n'
    'canid,row,cam0|fox\n'
    'canid,row,cam1|fox\n'
    'canid,max_count,24\n'
    'canid,prioritize,"[[\'cam1\']]"\n')
# The two-target spec that map_classification_categories maps onto the
# classifier's labels
WORKFLOW_TARGETS = {
    'ungulate': {'dataset_labels': {'cam0': ['deer'], 'cam1': ['deer']}},
    'carnivore': {'dataset_labels': {'cam0': ['fox'], 'cam1': ['fox']}}}


def _workflow_database(folder):
    """A COCO Camera Traps database over phase 28's 64 JPEGs in [folder]
    (cam0, cam1): four locations (each camera's first and last 32 image
    numbers), deer or fox by the parity of the image's number within its
    camera, one box an image (seeded, in pixels of PIL's size); no width
    or height. Returns (the database, {file_name: PIL's (w, h)})."""

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(38)
    db = {'info': {'version': '1.0', 'description': 'chip_smoke phase 38'},
          'images': [], 'annotations': [],
          'categories': [{'id': 1, 'name': 'deer'}, {'id': 2,
                                                     'name': 'fox'}]}
    sizes = {}
    for i in range(64):
        name = 'cam{}/img_{:02d}.jpg'.format(i % 2, i)
        with Image.open(os.path.join(folder, name)) as im:
            sizes[name] = im.size
        w, h = sizes[name]
        x, y = rng.uniform(0.05, 0.5, 2)
        bw, bh = rng.uniform(0.1, 0.4, 2)
        db['images'].append({'id': 'im{:02d}'.format(i), 'file_name': name,
                             'location': 'cam{}_{}'.format(i % 2, i // 32),
                             'datetime': '2024-03-{:02d} 06:00:00'.format(
                                 1 + i % 28)})
        db['annotations'].append({
            'id': 'ann{:02d}'.format(i), 'image_id': 'im{:02d}'.format(i),
            'category_id': 1 + (i // 2) % 2,
            'bbox': [round(float(x * w), 1), round(float(y * h), 1),
                     round(float(bw * w), 1), round(float(bh * h), 1)]})
    return db, sizes


def phase_classifier_workflow(device, workdir, workflow_path, threshold,
                              card):
    """
    38. The classifier-training workflow's host tools, from a CCT database
    through the card's detections to a trained, evaluated and merged
    classifier, over phase 28's workflow folder (64 JPEGs in cam0, cam1).
    1. The database (_workflow_database): add_width_and_height_to_db fills
    the sizes (PIL's); integrity_check_json_db with its image checks
    reports no error and raises AssertionError on a copy with a broken
    category reference; subset_json_db per camera, then
    coco_tools.combine_cct_files of the two subsets, gives back its images
    and annotations; sample_json_db takes a seeded sample; cct_to_md
    writes the ground truth, valid (validate_batch_results).
    2. WORKFLOW_SPEC_CSV through csv_to_json, then
    json_validator.run_validator on the image source built from the
    database (canid capped at 24, cam1 first): queried_images.json of 56
    images.
    3. Phase 28's yolov5l6 (saved as md_vsmoke_workflow.npz: the cache
    reads a version after the name's last 'v') in bf16 through
    load_and_run_detector_batch at batch 8 at phase 28's threshold,
    launches exact (B1, B4, E7); cache_batchapi_outputs.cache_json of the
    first 40 images' results, then of the last 40: the cache holds each
    image once, as the card wrote it.
    4. crop_detections (square crops at the threshold),
    create_classification_dataset (location splits), then
    classification/train_classifier.main for one epoch (efficientnetv2_s,
    224 px, float32, its defaults) and evaluate_model (outputs_*.csv).
    5. identify_mislabeled_candidates on the test split at half the
    largest wrong-label margin (the files equal the candidates recomputed
    from the CSV), save_mislabeled of their images, filter_queried_images
    (exactly those images dropped); run_classifier (the merged file and
    the per-crop CSV); map_classification_categories (pair route) of
    WORKFLOW_TARGETS onto the classifier's labels;
    aggregate_classifier_probs of run_classifier's CSV (each row's targets
    sum to 1 within 1e-5); merge_classification_detection_output of the
    evaluation CSV into the card's results; both merged files valid.
    6. analyze_failed_images over the crop folder and one truncated JPEG
    planted there flags exactly that file.
    Steps 4-6 run no kernel of ours (float32): their launches are checked
    to be 0. Prints each step's seconds, the launches and the counts.
    Returns the phase's (nms, conv, bottleneck, stem, silu) launches.
    """

    import copy
    import csv

    import torch

    from megadetector_tpu_torch.classification import (
        aggregate_classifier_probs, analyze_failed_images,
        cache_batchapi_outputs, crop_detections,
        create_classification_dataset, csv_to_json, evaluate_model,
        identify_mislabeled_candidates, json_validator,
        map_classification_categories, merge_classification_detection_output,
        run_classifier, save_mislabeled)
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    from megadetector_tpu_torch.data_management import (
        add_width_and_height_to_db, cct_to_md, coco_tools,
        integrity_check_json_db, subset_json_db)
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import (
        load_checkpoint, save_checkpoint)
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.utils import ct_utils, path_utils

    start = time.time()
    folder = _workflow_folder(workdir)
    files = path_utils.find_images(folder, recursive=True)
    out = os.path.join(workdir, 'classifier_workflow')
    os.makedirs(out, exist_ok=True)
    seconds = {}

    def step(name, fn):
        t0 = time.time()
        value = fn()
        seconds[name] = time.time() - t0
        return value

    def fail(message):
        raise AssertionError('phase 38: ' + message)

    def valid(path):
        errors = validate_batch_results(path)['validation_results']
        if errors['validation_errors']:
            fail('{} is invalid: {}'.format(
                os.path.basename(path), errors['validation_errors'][:3]))

    def without_ids(db):
        """Annotations as (image, category name, bbox), sorted."""
        names = {c['id']: c['name'] for c in db['categories']}
        return sorted((a['image_id'], names[a['category_id']], a['bbox'])
                      for a in db['annotations'])

    # 1. The database
    db, sizes = _workflow_database(folder)
    db_file = os.path.join(out, 'db.json')
    db = step('add_width_and_height', lambda: add_width_and_height_to_db
              .add_width_and_height_to_db(db, folder, db_file))
    if {im['file_name']: (im.get('width'), im.get('height'))
            for im in db['images']} != sizes:
        fail('add_width_and_height_to_db\'s sizes differ from PIL\'s')
    options = integrity_check_json_db.IntegrityCheckOptions()
    options.baseDir = folder
    options.bCheckImageSizes = True
    options.bCheckImageExistence = True
    options.bFindUnusedImages = True
    options.bRequireLocation = True
    options.verbose = False
    categories, _, error_info = step(
        'integrity_check', lambda: integrity_check_json_db
        .integrity_check_json_db(db_file, options))
    if error_info['validation_errors'] or error_info['unused_images'] or \
            sorted(c['count'] for c in categories) != [32, 32]:
        fail('integrity_check_json_db: {}, categories {}'.format(
            error_info, categories))
    broken = copy.deepcopy(db)
    broken['annotations'][5]['category_id'] = 99
    try:
        integrity_check_json_db.integrity_check_json_db(broken, options)
    except AssertionError:
        pass
    else:
        fail('integrity_check_json_db accepted a broken category reference')
    parts = []
    for camera in ('cam0/', 'cam1/'):
        parts.append(os.path.join(out, 'db_{}.json'.format(camera[:-1])))
        subset_json_db.subset_json_db(db_file, camera, parts[-1])
    combined = step('subset_and_combine', lambda: coco_tools
                    .combine_cct_files(parts, os.path.join(
                        out, 'db_combined.json')))
    if sorted(combined['images'], key=lambda im: im['id']) != \
            db['images'] or without_ids(combined) != without_ids(db):
        fail('the two cameras\' subsets combined differ from the database')
    sampling = subset_json_db.DbSamplingOptions()
    sampling.category_name_to_max_count = {'default': -1, 'fox': 10}
    sampling.random_seed = 38
    sample = subset_json_db.sample_json_db(copy.deepcopy(db), sampling)
    if len(sample['images']) != 42:
        fail('sample_json_db kept {} images, want 32 deer + 10 fox'.format(
            len(sample['images'])))
    truth_file = os.path.join(out, 'ground_truth.json')
    truth = step('cct_to_md', lambda: cct_to_md.cct_to_md(db_file,
                                                          truth_file))
    valid(truth_file)
    if sum(len(im['detections']) for im in truth['images']) != 64:
        fail('cct_to_md wrote {} boxes'.format(sum(
            len(im['detections']) for im in truth['images'])))

    # 2. The label spec and the queried images
    spec_csv = os.path.join(out, 'label_spec.csv')
    with open(spec_csv, 'w') as f:
        f.write(WORKFLOW_SPEC_CSV)
    spec = {label: csv_to_json.order_spec_dict(s) for label, s in
            csv_to_json.csv_to_jsondict(spec_csv).items()}
    spec_file = os.path.join(out, 'label_spec.json')
    ct_utils.write_json(spec_file, spec)
    names = {c['id']: c['name'] for c in db['categories']}
    image_to_class = {a['image_id']: names[a['category_id']]
                      for a in db['annotations']}
    source = {im['file_name']: {'dataset': im['file_name'].split('/')[0],
                                'class': image_to_class[im['id']],
                                'location': im['location']}
              for im in db['images']}
    source_file = os.path.join(out, 'image_source.json')
    ct_utils.write_json(source_file, source)
    validator_dir = os.path.join(out, 'validator')
    queried = step('json_validator', lambda: json_validator.run_validator(
        spec_file, source_file, output_dir=validator_dir,
        images_dir=folder))
    queried_file = os.path.join(validator_dir, 'queried_images.json')
    with open(queried_file) as f:
        written = json.load(f)
    n_cam1_fox = sum(info['dataset'] == 'cam1' and info['label'] ==
                     ['canid'] for info in written.values())
    if len(queried) != 56 or written != queried or n_cam1_fox != 16:
        fail('queried_images.json holds {} images ({} canid of cam1), '
             'want 32 cervid + 24 canid with cam1 first'.format(
                 len(written), n_cam1_fox))

    # 3. Detections from the card, cached
    model_file = os.path.join(out, 'md_vsmoke_workflow.npz')
    params, metadata = load_checkpoint(workflow_path)
    save_checkpoint(params, model_file, metadata)
    results_file = os.path.join(out, 'detections.json')

    def detect():
        detector = load_detector(model_file, device=device,
                                 detector_options={'dtype': 'bfloat16'})
        counts, _ = _counted_detection(
            'phase 38 on {}, phase 28\'s yolov5l6 (bf16) over {} JPEGs at '
            '{:.4f}'.format(card, len(files), threshold), detector,
            model_file, files, folder, threshold, results_file)
        del detector
        torch.cuda.empty_cache()
        return counts

    counts = step('detect', detect)
    valid(results_file)
    with open(results_file) as f:
        results = json.load(f)
    n_detections = sum(len(im['detections'] or [])
                       for im in results['images'])
    cache = os.path.join(out, 'detection_cache')
    halves = []
    for name, images in (('first', results['images'][:40]),
                         ('last', results['images'][24:])):
        halves.append(os.path.join(out, 'detections_{}.json'.format(name)))
        ct_utils.write_json(halves[-1], dict(results, images=images))
    messages = step('cache', lambda: [cache_batchapi_outputs.cache_json(
        path, True, 'workflow', cache) for path in halves])
    with open(os.path.join(cache, 'vsmoke_workflow.npz',
                           'workflow.json')) as f:
        cached = json.load(f)
    if sorted(cached['images'], key=lambda im: im['file']) != sorted(
            results['images'], key=lambda im: im['file']) or \
            'Merging' not in messages[1]:
        fail('the cache holds {} images after the merge, want the card\'s '
             '{}'.format(len(cached['images']), len(results['images'])))

    # 4. Crops, the dataset, one epoch, the evaluation (float32: no
    # kernel of ours)
    _reset_counts()
    crops_dir = os.path.join(out, 'crops')
    n_crops, failed = step('crop_detections', lambda: crop_detections
                           .crop_detections(results_file, crops_dir, folder,
                                            threshold=threshold,
                                            square_crops=True))
    if failed or n_crops != n_detections:
        fail('{} crops of {} detections, failed {}'.format(
            n_crops, n_detections, failed))
    ds_dir = os.path.join(out, 'dataset')
    rows, label_index, splits = step(
        'dataset', lambda: create_classification_dataset
        .create_classification_dataset(
            queried_file, crops_dir, ds_dir, detections_json=results_file,
            confidence_threshold=threshold,
            split_fractions=(0.5, 0.25, 0.25)))
    if sorted(label_index.values()) != ['canid', 'cervid'] or \
            sorted(len(v) for v in splits.values()) != [1, 1, 2]:
        fail('the dataset: labels {}, splits {}'.format(label_index, splits))
    logdir = os.path.join(out, 'train')
    best = step('train', lambda: ctc.main(
        ds_dir, crops_dir, model_name=CLASSIFICATION_MODEL, epochs=1,
        img_size=CLASSIFICATION_SIZE, logdir=logdir, seed=0,
        device=str(device)))
    ckpt = os.path.join(logdir, 'params.npz')
    eval_dir = os.path.join(out, 'eval')
    step('evaluate', lambda: evaluate_model.evaluate_model(
        ckpt, ds_dir, crops_dir, eval_dir, batch_size=32, device=device))
    outputs = os.path.join(eval_dir, 'outputs_test.csv')
    with open(outputs, newline='') as f:
        eval_rows = list(csv.DictReader(f))
    labels = [label_index[str(i)] for i in range(len(label_index))]
    if not eval_rows or best is None:
        fail('evaluate_model wrote {} test rows (best {})'.format(
            len(eval_rows), best))

    # 5. Review, then merge
    gaps = {}
    for r in eval_rows:
        probs = {k: float(r[k]) for k in labels}
        pred = max(probs, key=probs.get)
        if pred != r['label']:
            gaps[r['path']] = (probs[pred] - probs[r['label']], pred)
    if not gaps:
        fail('the classifier labelled every test crop right: no candidate '
             'to review')
    margin = max(g for g, _ in gaps.values()) / 2
    candidates_dir = os.path.join(out, 'candidates')
    candidates = step('identify_mislabeled', lambda:
                      identify_mislabeled_candidates
                      .identify_mislabeled_candidates(
                          outputs, 'test', candidates_dir, margin=margin))
    want = {}
    for path, (gap, _) in gaps.items():
        if gap >= margin:
            dataset, rest = path.split('/', 1)
            want.setdefault(dataset, []).append(rest)
    listed = {}
    for name in os.listdir(candidates_dir):
        with open(os.path.join(candidates_dir, name)) as f:
            listed[name] = f.read()
    if candidates != want or listed != {
            'mislabeled_candidates_test_{}.txt'.format(ds): ''.join(
                p + '\n' for p in sorted(paths))
            for ds, paths in want.items()}:
        fail('identify_mislabeled_candidates: {} against {}'.format(
            candidates, want))
    n_candidates = sum(len(v) for v in want.values())
    row_labels = {r['path']: r['label'] for r in eval_rows}
    entries, flagged = [], set()
    for dataset, paths in want.items():
        for path in paths:
            image = path.split('___crop')[0]
            entries.append({
                'dataset': dataset, 'file': image,
                'original_label': row_labels[dataset + '/' + path],
                'corrected_label': gaps[dataset + '/' + path][1]})
            flagged.add(dataset + '/' + image)
    ledger = os.path.join(out, 'mislabeled.csv')
    step('save_mislabeled', lambda: save_mislabeled.save_mislabeled(
        ledger, entries))
    kept = step('filter_queried', lambda: save_mislabeled
                .filter_queried_images(queried_file, ledger, os.path.join(
                    out, 'queried_filtered.json')))
    if sorted(kept) != sorted(set(queried) - flagged):
        fail('filter_queried_images kept {} of {} images, {} flagged'.format(
            len(kept), len(queried), len(flagged)))
    run_file = os.path.join(out, 'run_classifier.json')
    run_csv = os.path.join(out, 'run_classifier.csv')
    merged_run = step('run_classifier', lambda: run_classifier
                      .run_classifier(results_file, crops_dir, ckpt,
                                      run_file, run_csv, batch_size=64,
                                      device=device))
    classified = sum('classifications' in d for im in merged_run['images']
                     for d in im['detections'] or [])
    if classified != n_crops:
        fail('run_classifier classified {} of {} crops'.format(classified,
                                                               n_crops))
    mapping = step('map_categories', lambda: map_classification_categories
                   .map_classification_categories(WORKFLOW_TARGETS, spec))
    if mapping != {'ungulate': ['cervid'], 'carnivore': ['canid']}:
        fail('map_classification_categories: {}'.format(mapping))
    mapping_file = os.path.join(out, 'target_mapping.json')
    ct_utils.write_json(mapping_file, mapping)
    aggregated = os.path.join(out, 'aggregated.csv')
    step('aggregate_probs', lambda: aggregate_classifier_probs
         .aggregate_classifier_probs(run_csv, mapping_file, aggregated,
                                     os.path.join(out, 'targets.json')))
    with open(aggregated, newline='') as f:
        sums = [sum(float(v) for k, v in r.items() if k != 'path')
                for r in csv.DictReader(f)]
    if len(sums) != n_crops or max(abs(x - 1) for x in sums) > 1e-5:
        fail('aggregate_classifier_probs: {} rows, sums {} to {}'.format(
            len(sums), min(sums), max(sums)))
    merged_file = os.path.join(out, 'merged.json')
    merged = step('merge', lambda: merge_classification_detection_output
                  .merge_classification_detection_output(
                      outputs, results_file, merged_file,
                      label_index_path=os.path.join(ds_dir,
                                                    'label_index.json'),
                      classifier_name=CLASSIFICATION_MODEL))
    n_merged = sum('classifications' in d for im in merged['images']
                   for d in im['detections'] or [])
    if n_merged != len(eval_rows):
        fail('merge_classification_detection_output classified {} '
             'detections, the test split holds {} crops'.format(
                 n_merged, len(eval_rows)))
    valid(run_file)
    valid(merged_file)

    # 6. A truncated JPEG among the crops
    planted = 'cam0/planted_truncated.jpg'
    first = path_utils.find_images(crops_dir, recursive=True)[0]
    with open(first, 'rb') as f:
        data = f.read()
    with open(os.path.join(crops_dir, planted), 'wb') as f:
        f.write(data[:len(data) // 2])
    crop_files = path_utils.find_images(crops_dir, recursive=True,
                                        return_relative_paths=True)
    report = step('analyze_failed', lambda: analyze_failed_images
                  .analyze_failed_images(crop_files, crops_dir, threads=8))
    bad = sorted(e['file'] for status, items in report['by_status'].items()
                 if status != 'ok' for e in items)
    if bad != [planted] or len(crop_files) != n_crops + 1:
        fail('analyze_failed_images flagged {} of {} files'.format(
            bad, len(crop_files)))
    host_counts = _counts()
    if host_counts != (0, 0, 0, 0, 0):
        fail('steps 4-6 launched {} (float32: none of ours)'.format(
            host_counts))

    print('phase 38 on {}: the database 64 images in 4 locations (32 deer, '
          '32 fox), valid, the cameras\' subsets combined back, a sample of '
          '{}; queried_images.json {} images; launches (nms, conv, '
          'bottleneck, stem, silu) {}; {} detections cached; {} crops, '
          'dataset {} rows (splits {}), val acc_top1 {:.3f}; {} test rows, '
          '{} mislabeled candidates at margin {:.4f}, {} images filtered '
          'out; run_classifier {} crops, {} targets summed to 1; {} merged '
          'detections; {} of {} files flagged'.format(
              card, len(sample['images']), len(queried), counts,
              n_detections, n_crops, len(rows),
              {k: len(v) for k, v in splits.items()}, best['acc_top1'],
              len(eval_rows), n_candidates, margin, len(flagged),
              classified, len(sums), n_merged, len(bad), len(crop_files)),
          flush=True)
    print('phase 38 on {}: seconds by step: {}; total {:.3f}'.format(
        card, ', '.join('{} {:.3f}'.format(k, v)
                        for k, v in seconds.items()),
        time.time() - start), flush=True)
    return counts


# Phase 39: the two-species taxonomy of the WI and Camtrap DP steps (WI's
# batch-upload fields) and the LILA dataset's name in the index
DATA_FORMAT_TAXONOMY = {
    'deer': {'common_name': 'White-tailed Deer',
             'wi_taxon_id': '5c7ce479-8a45-40b3-ae21-7c97dfae22f5',
             'class': 'Mammalia', 'order': 'Cetartiodactyla',
             'family': 'Cervidae', 'genus': 'Odocoileus',
             'species': 'virginianus'},
    'fox': {'common_name': 'Red Fox',
            'wi_taxon_id': '3d80f1d6-b1df-4966-9ff4-94053c7a902a',
            'class': 'Mammalia', 'order': 'Carnivora', 'family': 'Canidae',
            'genus': 'Vulpes', 'species': 'vulpes'}}
LILA_SMOKE_DATASET = 'Smoke Cameras'


def _with_exif_datetime(data, stamp):
    """JPEG bytes [data] with an EXIF block (DateTime [stamp]) spliced in
    after the start-of-image marker: the pixels' bytes untouched."""

    import struct

    from PIL import Image

    exif = Image.Exif()
    exif[306] = stamp
    block = exif.tobytes()
    return data[:2] + b'\xff\xe1' + struct.pack('>H', len(block) + 2) + \
        block + data[2:]


def _label_rows(path):
    """[[class, cx, cy, w, h(, conf)], ...] of a YOLO .txt file."""

    with open(path) as f:
        return [[float(t) for t in line.split()] for line in f
                if line.strip()]


def _coco_rows(coco, clip, minus_one=False):
    """{file_name: [[category name, cx, cy, w, h], ...]} of a COCO dict's
    boxes, normalized by each image's side (or side - 1, as
    labelme_file_to_yolo_file does: clipped to side - 1, a box outside it
    left out), in annotation order; with [clip] a box is clipped to the
    image as coco_to_yolo clips it (and left out where nothing is
    left)."""

    names = {c['id']: c['name'] for c in coco['categories']}
    images = {im['id']: im for im in coco['images']}
    rows = {im['file_name']: [] for im in coco['images']}
    for ann in coco['annotations']:
        if ann.get('bbox') is None:
            continue
        im = images[ann['image_id']]
        w_im, h_im = im['width'], im['height']
        x, y, w, h = ann['bbox']
        if minus_one:
            if x >= w_im - 1 or x + w <= 0 or y >= h_im - 1 or y + h <= 0:
                continue
            x0, y0 = max(x, 0.0), max(y, 0.0)
            x1, y1 = min(x + w, w_im - 1), min(y + h, h_im - 1)
            w_im, h_im = w_im - 1, h_im - 1
            x, y, w, h = x0, y0, x1 - x0, y1 - y0
        elif clip:
            xc, yc = max(x, 0), max(y, 0)
            w = min(w - (xc - x), w_im - xc)
            h = min(h - (yc - y), h_im - yc)
            x, y = xc, yc
            if w <= 0 or h <= 0:
                continue
        rows[im['file_name']].append([
            names[ann['category_id']], (x + w / 2.0) / w_im,
            (y + h / 2.0) / h_im, w / w_im, h / h_im])
    return rows


def _rows_close(got, want, class_names, tol):
    """Whether per-image YOLO rows [got] ({file: rows}, class indices)
    equal [want] ({file: rows}, class names) within [tol]."""

    if sorted(got) != sorted(want):
        return False
    for name, rows in want.items():
        if len(got[name]) != len(rows):
            return False
        for g, w in zip(got[name], rows):
            if class_names[int(g[0])] != w[0] or \
                    max(abs(a - b) for a, b in zip(g[1:5], w[1:])) > tol:
                return False
    return True


def _data_format_tools(folder, db_file, results_file, out, step, fail):
    """Steps 1-4 of phase 39 (see phase_data_formats) over the images in
    [folder], the CCT database [db_file] and the card's results
    [results_file]; [step](name, fn) times fn(), [fail](message) raises.
    Returns ({name: count}, the YOLO folder)."""

    import csv
    import shutil

    from PIL import Image

    from megadetector_tpu_torch.data_management import (
        animl_to_md, camtrap_dp_to_coco, cct_to_wi, coco_to_labelme,
        coco_to_yolo, image_file_tools, importers, labelme_to_coco,
        labelme_to_yolo, wi_download_csv_to_coco, yolo_output_to_md_output,
        yolo_to_coco, zamba_to_md)
    from megadetector_tpu_torch.postprocessing import md_to_coco
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.utils import ct_utils

    os.makedirs(out, exist_ok=True)
    with open(db_file) as f:
        db = json.load(f)
    with open(results_file) as f:
        results = json.load(f)
    card = _detections(results)
    files = sorted(card)
    names = {c['id']: c['name'] for c in db['categories']}
    image_label = {}
    for ann in db['annotations']:
        image_label[ann['image_id']] = names[ann['category_id']]
    label = {im['file_name']: image_label[im['id']] for im in db['images']}
    counts = {}

    def valid(path):
        errors = validate_batch_results(path)['validation_results']
        if errors['validation_errors']:
            fail('{} is invalid: {}'.format(
                os.path.basename(path), errors['validation_errors'][:3]))

    def boxes(dets):
        return [(d['category'], d['conf'], d['bbox']) for d in dets]

    # 1. YOLO and labelme from the card's detections
    coco_file = os.path.join(out, 'detections_coco.json')
    coco = step('md_to_coco', lambda: md_to_coco.md_to_coco(
        results_file, coco_file, image_folder=folder))
    yolo_dir = os.path.join(out, 'yolo')
    class_file = os.path.join(out, 'yolo_classes.txt')
    written = step('coco_to_yolo', lambda: coco_to_yolo.coco_to_yolo(
        folder, yolo_dir, coco_file, class_file_name=class_file))
    class_list = written['class_list']
    dataset_file = coco_to_yolo.write_yolo_dataset_file(
        os.path.join(out, 'dataset.yaml'), yolo_dir, class_list,
        train_folder_relative='.', val_folder_relative='.')
    views = [os.path.join(out, 'yolo_' + v) for v in ('images', 'labels')]
    step('create_yolo_symlinks', lambda: coco_to_yolo.create_yolo_symlinks(
        yolo_dir, views[0], views[1], class_list_file=class_file))
    for view, ext in zip(views, ('.jpg', '.txt')):
        linked = sorted(os.path.relpath(os.path.join(b, n), view)
                        for b, _, ns in os.walk(view) for n in ns
                        if n.endswith(ext))
        if linked != [os.path.splitext(f)[0] + ext for f in files] or any(
                os.path.realpath(os.path.join(view, n)) != os.path.realpath(
                    os.path.join(yolo_dir, n)) for n in linked):
            fail('create_yolo_symlinks: {} links in {}'.format(
                len(linked), os.path.basename(view)))
    report = step('validate_yolo_dataset', lambda: yolo_to_coco
                  .validate_yolo_dataset(yolo_dir, class_file))
    # coco_to_yolo clips each box to the image, so a bound can pass 1 by
    # its {:.6f} rounding alone
    excess = [max(-v, v - 1) for e in report['label_errors']
              for message in e['errors']
              for v in map(float, message.split(':')[1].split())]
    if report['images_without_labels'] or report['labels_without_images'] \
            or report['n_images'] != len(files) or \
            report['n_labels'] != len(files) or max(excess,
                                                    default=0) > 1e-6:
        fail('validate_yolo_dataset: {}'.format(report))
    labels = {f: _label_rows(os.path.join(
        yolo_dir, os.path.splitext(f)[0] + '.txt')) for f in files}
    clipped = _coco_rows(coco, True)
    if not _rows_close(labels, clipped, class_list, 1e-6):
        fail('coco_to_yolo\'s label files differ from the card\'s boxes')
    back = step('yolo_to_coco', lambda: yolo_to_coco.yolo_to_coco(
        yolo_dir, class_file, os.path.join(out, 'yolo_coco.json')))
    if sorted((im['file_name'], im['width'], im['height'])
              for im in back['images']) != sorted(
            (im['file_name'], im['width'], im['height'])
            for im in coco['images']) or not _rows_close(
            {k: [[class_list.index(r[0])] + r[1:] for r in v]
             for k, v in _coco_rows(back, False).items()},
            clipped, class_list, 1e-6):
        fail('yolo_to_coco gives back other images or boxes')
    counts['YOLO labels'] = sum(len(v) for v in labels.values())
    counts['YOLO label files'] = len(labels)

    labelme_dir = os.path.join(out, 'labelme')
    shutil.copytree(folder, labelme_dir)
    labelme_files = step('coco_to_labelme', lambda: coco_to_labelme
                         .coco_to_labelme(coco_file, labelme_dir))
    from_labelme = step('labelme_to_coco', lambda: labelme_to_coco
                        .labelme_to_coco(labelme_dir, os.path.join(
                            out, 'labelme_coco.json')))
    unclipped = _coco_rows(coco, False)
    if len(labelme_files) != len(files) or not _rows_close(
            {k: [[class_list.index(r[0])] + r[1:] for r in v]
             for k, v in _coco_rows(from_labelme, False).items()},
            unclipped, class_list, 1e-9):
        fail('labelme_to_coco gives back other boxes than coco_to_labelme '
             'wrote ({} files)'.format(len(labelme_files)))
    empty = step('find_empty_labelme_files', lambda: labelme_to_coco
                 .find_empty_labelme_files(labelme_dir))
    if empty != {'images_with_empty_json_files': [
            f for f in files if not card[f]],
            'images_with_no_json_files': [],
            'images_with_non_empty_json_files': [f for f in files if card[f]]}:
        fail('find_empty_labelme_files: {}'.format(
            {k: len(v) for k, v in empty.items()}))
    mapping = {name: i for i, name in enumerate(class_list)}
    txt = [os.path.join(labelme_dir, os.path.splitext(f)[0] + '.txt')
           for f in files]

    def txt_bytes():
        out = []
        for path in txt:
            with open(path, 'rb') as f:
                out.append(f.read())
        return out

    one = labelme_to_yolo.labelme_folder_to_yolo(labelme_dir, mapping)
    one_bytes = txt_bytes()
    spawned = step('labelme_to_yolo (4 processes)', lambda: labelme_to_yolo
                   .labelme_folder_to_yolo(labelme_dir, mapping, n_workers=4,
                                           use_threads=False))
    # labelme_file_to_yolo_file normalizes by side - 1, at 3 digits
    if spawned != one or txt_bytes() != one_bytes or not _rows_close(
            {f: _label_rows(p) for f, p in zip(files, txt)},
            _coco_rows(coco, False, minus_one=True), class_list,
            5e-4 + 1e-9):
        fail('labelme_folder_to_yolo in 4 processes differs from one '
             'worker or from the card\'s boxes')
    labelme_to_yolo.labelme_to_yolo(labelme_dir, class_list=list(class_list))
    if not _rows_close({f: _label_rows(p) for f, p in zip(files, txt)},
                       unclipped, class_list, 1e-6):
        fail('labelme_to_yolo\'s label files differ from coco_to_yolo\'s')
    counts['labelme files'] = len(labelme_files)

    # 2. A YOLO detector's outputs back to MD
    val_dir = os.path.join(out, 'yolo_val_txt')
    predictions, id_to_file = [], {}
    for i, f in enumerate(files):
        if not card[f]:
            continue
        id_to_file[i] = f
        with Image.open(os.path.join(folder, f)) as im:
            w_im, h_im = im.size
        path = os.path.join(val_dir, os.path.splitext(f)[0] + '.txt')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as fh:
            for d in card[f]:
                x, y, w, h = d['bbox']
                fh.write('{} {:.6f} {:.6f} {:.6f} {:.6f} {:.6f}\n'.format(
                    int(d['category']) - 1, x + w / 2, y + h / 2, w, h,
                    d['conf']))
                predictions.append({
                    'image_id': i, 'category_id': int(d['category']) - 1,
                    'bbox': [x * w_im, y * h_im, w * w_im, h * h_im],
                    'score': d['conf']})
    pred_file = os.path.join(out, 'yolo_predictions.json')
    ct_utils.write_json(pred_file, predictions)
    from_txt = os.path.join(out, 'from_yolo_txt.json')
    from_json = os.path.join(out, 'from_yolo_json.json')
    step('yolo_txt_output_to_md_output', lambda: yolo_output_to_md_output
         .yolo_txt_output_to_md_output(val_dir, folder, from_txt))
    step('yolo_json_output_to_md_output', lambda: yolo_output_to_md_output
         .yolo_json_output_to_md_output(
             pred_file, folder, from_json,
             yolo_category_id_to_name=yolo_output_to_md_output
             .read_classes_from_yolo_dataset_file(dataset_file),
             image_id_to_relative_path=id_to_file))
    for path in (from_txt, from_json):
        valid(path)
        with open(path) as f:
            data = json.load(f)
        got = {k: boxes(v) for k, v in _detections(data).items()}
        want = {f: boxes(card[f]) for f in files
                if card[f] or path == from_txt}
        used = sorted({d['category'] for v in card.values() for d in v})
        if got != want or (path == from_json and data[
                'detection_categories'] != {c: results[
                    'detection_categories'][c] for c in used}):
            fail('{} differs from the card\'s results'.format(
                os.path.basename(path)))

    # 3. WI, Camtrap DP, Animl, Zamba, MEWC
    wi_dir = os.path.join(out, 'wi')
    wi = step('cct_to_wi', lambda: cct_to_wi.cct_to_wi(
        db_file, DATA_FORMAT_TAXONOMY, wi_dir,
        project_info={'project_id': 'chip_smoke'}))
    for name, columns in (('projects', cct_to_wi.PROJECT_COLUMNS),
                          ('cameras', cct_to_wi.CAMERA_COLUMNS),
                          ('deployments', cct_to_wi.DEPLOYMENT_COLUMNS),
                          ('images', cct_to_wi.IMAGE_COLUMNS)):
        with open(wi[name], newline='') as f:
            rows = list(csv.reader(f))
        if rows[0] != columns:
            fail('cct_to_wi\'s {}.csv has columns {}'.format(name, rows[0]))
        counts['WI {} rows'.format(name)] = len(rows) - 1
    wi_coco = step('wi_download_csv_to_coco', lambda: wi_download_csv_to_coco
                   .wi_download_csv_to_coco(
                       wi['images'], os.path.join(out, 'wi_coco.json'),
                       image_flattening='none'))
    wi_names = {c['id']: c['name'] for c in wi_coco['categories']}
    if {a['image_id']: wi_names[a['category_id']]
            for a in wi_coco['annotations']} != {
            f: DATA_FORMAT_TAXONOMY[label[f]]['common_name'].lower()
            for f in files} or sorted(
            (im['file_name'], im['location'], im['datetime'])
            for im in wi_coco['images']) != sorted(
            (im['file_name'], im['location'], im['datetime'])
            for im in db['images']) or counts['WI images rows'] != len(files):
        fail('wi_download_csv_to_coco does not give back the database\'s '
             'labels')

    # Camtrap DP: an event an image, every observation an event-level
    # animal of the database's species carrying one of the card's boxes (an
    # image without one, a row without a box). The two converters read
    # filePath differently (camtrap_dp_to_coco joins it to fileName,
    # camtrap_dp_to_md takes it alone): an empty filePath and the relative
    # fileName give both the database's file name
    package = os.path.join(out, 'camtrap_dp')
    os.makedirs(package)
    science = {k: '{} {}'.format(v['genus'], v['species'])
               for k, v in DATA_FORMAT_TAXONOMY.items()}
    tables = {'deployments': [], 'events': [], 'media': [],
              'observations': []}
    for loc in sorted({im['location'] for im in db['images']}):
        tables['deployments'].append({'deploymentID': loc,
                                      'locationName': loc})
    for im in db['images']:
        f = im['file_name']
        tables['media'].append({'mediaID': im['id'],
                                'deploymentID': im['location'],
                                'timestamp': im['datetime'],
                                'filePath': '', 'fileName': f})
        event = 'event_' + im['id']
        tables['events'].append({'eventID': event, 'mediaID': im['id']})
        for k, d in enumerate(card[f] or [None]):
            row = {'observationID': '{}_{}'.format(event, k),
                   'eventID': event, 'mediaID': im['id'],
                   'observationLevel': 'event',
                   'observationType': 'animal',
                   'scientificName': science[label[f]]}
            if d is not None:
                row.update(zip(('bboxX', 'bboxY', 'bboxWidth', 'bboxHeight'),
                               map(repr, d['bbox'])))
                row['classificationProbability'] = repr(d['conf'])
            tables['observations'].append(row)
    for name, rows in tables.items():
        columns = []
        for row in rows:
            columns += [c for c in row if c not in columns]
        with open(os.path.join(package, name + '.csv'), 'w',
                  newline='') as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(rows)
    ct_utils.write_json(os.path.join(package, 'datapackage.json'), {
        'name': 'chip-smoke-phase-39',
        'profile': camtrap_dp_to_coco.CAMTRAP_DP_PROFILE,
        'resources': [{'name': name, 'path': name + '.csv'}
                      for name in tables]})
    dp_coco = step('camtrap_dp_to_coco', lambda: camtrap_dp_to_coco
                   .camtrap_dp_to_coco(package, os.path.join(
                       out, 'camtrap_coco.json')))
    dp_names = {c['id']: c['name'] for c in dp_coco['categories']}
    back_science = {v: k for k, v in science.items()}
    if sorted((im['file_name'], im['location'], im['datetime'])
              for im in dp_coco['images']) != sorted(
            (im['file_name'], im['location'], im['datetime'])
            for im in db['images']) or sorted(
            (a['image_id'], back_science[dp_names[a['category_id']]])
            for a in dp_coco['annotations']) != sorted(
            (im['id'], label[im['file_name']]) for im in db['images']):
        fail('camtrap_dp_to_coco does not give back the database\'s images '
             'and labels')
    dp_md = os.path.join(out, 'camtrap_md.json')
    data = step('camtrap_dp_to_md', lambda: importers.camtrap_dp_to_md(
        package, dp_md))
    valid(dp_md)
    full = [((0.0, 0.0, 1.0, 1.0), 1.0)]
    if {k: [(tuple(d['bbox']), d['conf']) for d in v]
            for k, v in _detections(data).items()} != {
            f: [(tuple(d['bbox']), d['conf']) for d in card[f]] or full
            for f in files} or any(
            data['classification_categories'][d['classifications'][0][0]] !=
            science[label[im['file']]] for im in data['images']
            for d in im['detections']):
        fail('camtrap_dp_to_md does not give back the card\'s boxes')
    counts['Camtrap DP observations'] = len(tables['observations'])

    # Animl (detections with the image's species), Zamba and MEWC (the
    # image's top confidence as its species' probability)
    def write_csv(name, columns, rows):
        path = os.path.join(out, name)
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(columns)
            writer.writerows(rows)
        return path

    animl = write_csv('animl.csv', [
        'file', 'category', 'detection_conf', 'bbox1', 'bbox2', 'bbox3',
        'bbox4', 'class', 'classification_conf'], [
            [f, d['category'], repr(d['conf'])] + [repr(v) for v in
                                                  d['bbox']] +
            [label[f], repr(d['conf'])] for f in files for d in card[f]])
    animl_plain = write_csv('animl_plain.csv', [
        'FilePath', 'category', 'conf', 'bbox1', 'bbox2', 'bbox3', 'bbox4'],
        [[f, d['category'], repr(d['conf'])] + [repr(v) for v in d['bbox']]
         for f in files for d in card[f]] +
        [[f, '', '', '', '', '', ''] for f in files if not card[f]])
    top = {f: max([d['conf'] for d in card[f]], default=0.0)
           for f in files}
    zamba = write_csv('zamba.csv', ['filepath', 'blank', 'deer', 'fox'], [
        [f, repr(1 - top[f])] + [repr(top[f] if label[f] == s else 0.0)
                                 for s in ('deer', 'fox')] for f in files])
    mewc = write_csv('mewc.csv', ['filename', 'class_id', 'prob'], [
        [f, label[f] if card[f] else 'blank', repr(top[f] or 1.0)]
        for f in files])
    outs = {}
    for name, module, argv in (
            ('animl', animl_to_md, [animl]),
            ('zamba', zamba_to_md, [zamba])):
        outs[name] = os.path.join(out, name + '_md.json')
        saved = sys.argv
        sys.argv = [name + '_to_md'] + argv + ['--output_file', outs[name]]
        try:
            step(name + '_to_md CLI', module.main)
        finally:
            sys.argv = saved
    outs['animl_plain'] = os.path.join(out, 'animl_plain_md.json')
    step('animl_to_md', lambda: importers.animl_to_md(
        animl_plain, outs['animl_plain']))
    outs['mewc'] = os.path.join(out, 'mewc_md.json')
    step('mewc_to_md', lambda: importers.mewc_to_md(mewc, outs['mewc']))
    frame = [0.0, 0.0, 1.0, 1.0]
    want = {
        'animl': {f: [(d['category'], d['conf'], d['bbox'], label[f])
                      for d in card[f]] for f in files if card[f]},
        'animl_plain': {f: [(d['category'], d['conf'], d['bbox'], None)
                            for d in card[f]] for f in files},
        'zamba': {f: [('1', top[f], frame, label[f])]
                  if top[f] > 1 - top[f] else [] for f in files},
        'mewc': {f: [('1', top[f], frame, label[f])] if card[f] else []
                 for f in files}}
    for name, path in outs.items():
        valid(path)
        with open(path) as f:
            data = json.load(f)
        classes = data.get('classification_categories', {})
        got = {im['file']: [(d['category'], d['conf'], d['bbox'],
                             classes[d['classifications'][0][0]]
                             if 'classifications' in d else None)
                            for d in im['detections']]
               for im in data['images']}
        if got != want[name]:
            fail('{} does not give back the card\'s detections'.format(
                os.path.basename(path)))

    # 4. Image tools
    crops_dir = os.path.join(out, 'crops')
    crops = step('generate_crops_from_cct', lambda: image_file_tools
                 .generate_crops_from_cct(db_file, folder, crops_dir))
    sizes = []
    images = {im['id']: im for im in db['images']}
    for ann in db['annotations']:
        im = images[ann['image_id']]
        x, y, w, h = ann['bbox']
        x0, y0 = max(0, int(x)), max(0, int(y))
        x1 = min(im['width'], int(x + w))
        y1 = min(im['height'], int(y + h))
        if x1 > x0 and y1 > y0:
            sizes.append((x1 - x0, y1 - y0))
    got = []
    for path in crops:
        with Image.open(path) as im:
            got.append(im.size)
    if got != sizes:
        fail('generate_crops_from_cct: {} crops of {} boxes that cover a '
             'pixel, or of other sizes'.format(len(got), len(sizes)))
    counts['crops'] = len(crops)
    stamped = os.path.join(out, 'stamped')
    for im in db['images']:
        with open(os.path.join(folder, im['file_name']), 'rb') as f:
            data = f.read()
        path = os.path.join(stamped, im['file_name'])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'wb') as f:
            f.write(_with_exif_datetime(data, im['datetime'].replace(
                '-', ':')))
    renamed = os.path.join(out, 'renamed')
    dry = step('rename_images (dry run)', lambda: image_file_tools
               .rename_images(stamped, renamed, dry_run=True))
    mapping = step('rename_images', lambda: image_file_tools.rename_images(
        stamped, renamed, n_copy_workers=4))
    want = {}
    for im in db['images']:
        camera, name = im['file_name'].split('/')
        want[im['file_name']] = '{}#{}#{}'.format(
            camera, im['datetime'].replace(':', '-').replace(' ', '_'), name)
    if dry != mapping or mapping != want or sorted(os.listdir(
            renamed)) != sorted(want.values()) or any(
            _file_bytes(os.path.join(stamped, k)) != _file_bytes(
                os.path.join(renamed, v)) for k, v in mapping.items()):
        fail('rename_images: {} names, {} unique'.format(
            len(mapping), len(set(mapping.values()))))
    # remove_exif re-encodes pixel by pixel (about 0.6-0.9 s a 2-3 MP
    # image on one core): one batch's worth, 4 a camera
    exif_dir = os.path.join(out, 'exif')
    chosen = [f for f in files if f.startswith('cam0/')][:4] + \
        [f for f in files if f.startswith('cam1/')][:4]
    before = {}
    for f in chosen:
        os.makedirs(os.path.dirname(os.path.join(exif_dir, f)),
                    exist_ok=True)
        shutil.copyfile(os.path.join(stamped, f), os.path.join(exif_dir, f))
        with Image.open(os.path.join(exif_dir, f)) as im:
            before[f] = (im.size, dict(im.getexif()))
    cleaned = step('remove_exif', lambda: image_file_tools.remove_exif(
        exif_dir, n_workers=4))
    after = {}
    for f in chosen:
        with Image.open(os.path.join(exif_dir, f)) as im:
            after[f] = (im.size, dict(im.getexif()))
    if len(cleaned) != len(chosen) or any(
            not before[f][1] or after[f] != (before[f][0], {})
            for f in chosen):
        fail('remove_exif: sizes or EXIF {} after {}'.format(after, before))
    counts['EXIF removed'] = len(cleaned)
    return counts, yolo_dir


def _file_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def _lila_subset(folder, db_file, results_file, out, step, fail):
    """Step 5 of phase 39's host half: a LILA site over loopback (the
    port's url_utils.SingletonHTTPServer on a temporary folder holding
    the index, the database zipped and the images), read and downloaded
    through the LILA tools. Returns (the downloaded folder, its files,
    {name: count})."""

    import csv
    import random
    import shutil
    import socket
    import zipfile

    from megadetector_tpu_torch.data_management.lila import (
        download_lila_subset, generate_lila_per_image_labels, lila_common,
        lila_reports)
    from megadetector_tpu_torch.utils import path_utils, url_utils

    with open(db_file) as f:
        db = json.load(f)
    site = os.path.join(out, 'lila_site')
    shutil.copytree(folder, os.path.join(site, 'images'))
    with zipfile.ZipFile(os.path.join(site, 'smoke_cameras.json.zip'),
                         'w') as zf:
        zf.write(db_file, 'smoke_cameras.json')
    shutil.copyfile(results_file, os.path.join(site, 'smoke_cameras_md.json'))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    base = url_utils.SingletonHTTPServer.start_server(site, port=port,
                                                      host='127.0.0.1')
    index_url = base + '/lila_camera_trap_datasets.csv'
    with open(os.path.join(site, 'lila_camera_trap_datasets.csv'), 'w',
              newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['name', 'short_name', 'metadata_url',
                         'image_base_url', 'md_results_url'])
        writer.writerow([LILA_SMOKE_DATASET, 'smoke_cameras',
                         base + '/smoke_cameras.json.zip',
                         base + '/images/', base + '/smoke_cameras_md.json'])
    metadata_dir = os.path.join(out, 'lila_metadata')
    subset = os.path.join(out, 'lila_subset')
    # Nothing may reach for the hosted index: its URL is the server's
    # while the tools run
    hosted = lila_common.LILA_DATASET_INDEX_URL
    lila_common.LILA_DATASET_INDEX_URL = index_url
    try:
        table = step('read_lila_metadata', lambda: lila_common
                     .read_lila_metadata(metadata_dir, index_url=index_url))
        entry = table[LILA_SMOKE_DATASET]
        json_path = step('read_metadata_file_for_dataset', lambda:
                         lila_common.read_metadata_file_for_dataset(
                             LILA_SMOKE_DATASET, metadata_dir,
                             metadata_table=table))
        with open(json_path) as f:
            if json.load(f) != db:
                fail('the unzipped LILA metadata differs from the database')
        files = step('select_lila_images_by_species', lambda: lila_common
                     .select_lila_images_by_species(json_path, ['fox']))
        fox = {c['id'] for c in db['categories'] if c['name'] == 'fox'}
        fox_images = {a['image_id'] for a in db['annotations']
                      if a['category_id'] in fox}
        if files != [im['file_name'] for im in db['images']
                     if im['id'] in fox_images]:
            fail('select_lila_images_by_species chose {} images'.format(
                len(files)))
        status = step('download_lila_subset', lambda: lila_common
                      .download_lila_subset(entry, files, subset,
                                            n_workers=8))
        cli_subset = subset + '_cli'
        saved = sys.argv
        try:
            sys.argv = ['download_lila_subset', LILA_SMOKE_DATASET,
                        cli_subset, '--species', 'fox', '--metadata_dir',
                        metadata_dir, '--n_workers', '4']
            step('download_lila_subset CLI', download_lila_subset.main)
            labels_file = os.path.join(out, 'lila_per_image_labels.json')
            sys.argv = ['generate_lila_per_image_labels', LILA_SMOKE_DATASET,
                        labels_file, '--metadata_dir', metadata_dir]
            step('generate_lila_per_image_labels CLI',
                 generate_lila_per_image_labels.main)
        finally:
            sys.argv = saved
        downloaded = path_utils.find_images(subset, recursive=True,
                                            return_relative_paths=True)
        if sorted(s['status'] for s in status.values()) != \
                ['success'] * len(files) or downloaded != sorted(files) or \
                any(_file_bytes(os.path.join(subset, f)) != _file_bytes(
                    os.path.join(folder, f)) or _file_bytes(os.path.join(
                        cli_subset, f)) != _file_bytes(os.path.join(
                            folder, f)) for f in files) or \
                path_utils.find_images(cli_subset, recursive=True,
                                       return_relative_paths=True) != \
                downloaded:
            fail('download_lila_subset fetched {} of {} images, or other '
                 'bytes'.format(len(downloaded), len(files)))
        with open(labels_file) as f:
            records = json.load(f)
        names = {c['id']: c['name'] for c in db['categories']}
        by_image = {a['image_id']: [names[a['category_id']]]
                    for a in db['annotations']}
        if [(r['file_name'], r['labels']) for r in records] != [
                (im['file_name'], by_image[im['id']]) for im in db['images']]:
            fail('generate_lila_per_image_labels: {} records'.format(
                len(records)))
        counts = step('lila_reports', lambda: (
            lila_reports.get_lila_annotation_counts(table, metadata_dir),
            lila_reports.get_lila_image_counts(table, metadata_dir)))
        want = {LILA_SMOKE_DATASET: {'deer': len(db['images']) -
                                     len(fox_images),
                                     'fox': len(fox_images)}}
        picks = [lila_reports.create_lila_test_set(
            entry, metadata_dir, n_empty_per_dataset=4,
            n_non_empty_per_dataset=8, seed=39) for _ in range(2)]
        drawn = random.Random(39).sample(db['images'], 8)
        links = lila_reports.create_links_to_md_results_files(table)
        probe = step('validate_lila_metadata_urls', lambda: lila_reports
                     .validate_lila_metadata_urls(table, check_images=True))
        if counts != (want, want) or picks[0] != picks[1] or [
                (p['file_name'], p['url'], p['is_empty'])
                for p in picks[0]] != [
                (im['file_name'], base + '/images/' + im['file_name'], False)
                for im in drawn] or links != {
                LILA_SMOKE_DATASET: base + '/smoke_cameras_md.json'} or \
                probe != {LILA_SMOKE_DATASET: {'metadata_ok': True,
                                               'image_ok': True}}:
            fail('lila_reports: counts {}, test set {}, links {}, probe '
                 '{}'.format(counts, len(picks[0]), links, probe))
    finally:
        lila_common.LILA_DATASET_INDEX_URL = hosted
        url_utils.SingletonHTTPServer.stop_server()
    return subset, [os.path.join(subset, f) for f in downloaded], {
        'LILA files downloaded': len(downloaded)}


def phase_data_formats(device, workdir, workflow_path, threshold, card):
    """
    39. The data-format converters, importers, image tools and LILA tools
    from what phase 38 leaves on disk: its CCT database over phase 28's 64
    workflow JPEGs (sizes filled) and the card's bf16 yolov5l6 results at
    phase 28's threshold. Every step is checked and raises on a failure.
    1. md_to_coco of the card's results; coco_to_yolo (copied images,
    the class list beside), write_yolo_dataset_file, create_yolo_symlinks
    (each link resolves to its file); validate_yolo_dataset finds no image
    without labels nor labels without an image (a bound past 1 only by the
    {:.6f} rounding); yolo_to_coco gives back the images and the boxes
    within 1e-6 of the image side (coco_to_yolo clips a box that the
    4-digit MD rounding pushed past the image: held to the clipped box).
    coco_to_labelme beside copies of the images, labelme_to_coco gives
    the boxes back; find_empty_labelme_files lists exactly the images
    without a detection; labelme_folder_to_yolo in a spawned pool of 4
    writes one worker's bytes (3 digits over side - 1: within 5e-4), and
    labelme_to_yolo writes coco_to_yolo's rows within 1e-6 (unclipped).
    2. The card's detections as YOLO val.py output, per-image .txt rows
    (class cx cy w h conf) and a predictions JSON (pixels), back through
    yolo_txt_output_to_md_output and yolo_json_output_to_md_output (its
    class names from the dataset YAML): both valid and equal to the
    card's results at MD rounding (bbox 4 digits, conf 3).
    3. cct_to_wi with a two-species taxonomy: the four CSVs with WI's
    column lists exactly; its images.csv read back as a WI download by
    wi_download_csv_to_coco gives the database's image labels, locations
    and times. A Camtrap DP package (datapackage.json, deployments,
    events, media, observations: an event an image, its observations the
    database's species with the card's boxes): camtrap_dp_to_coco gives
    back the database's images and labels, importers.camtrap_dp_to_md
    the card's boxes (a full frame where the card found none). Animl,
    Zamba and MEWC CSVs from the card's results through the animl_to_md
    and zamba_to_md CLIs (main with sys.argv) and importers' animl_to_md
    and mewc_to_md: valid files with the card's detections.
    4. generate_crops_from_cct: one crop per box that covers a pixel, each
    the size of its PIL crop; rename_images of an EXIF-stamped copy of
    the folder, a dry run then a copy with 4 workers: the same mapping,
    unique <camera>#<datetime>#<name> names, byte-identical copies;
    remove_exif with 4 workers on 8 of them (it re-encodes pixel by pixel,
    about 0.6-0.9 s a 2-3 MP image): no EXIF after, the sizes unchanged.
    5. A LILA site on loopback (_lila_subset): read_lila_metadata by
    index_url, read_metadata_file_for_dataset (download and unzip),
    select_lila_images_by_species for fox, download_lila_subset (and its
    CLI): the 32 images byte-identical; generate_lila_per_image_labels'
    CLI, lila_reports' counts, seeded test set, links and URL probe. The
    subset through phase 28's model in bf16 (1280 px, batch 8,
    load_and_run_detector_batch), launches exact (B1, B4, E7): its
    detections match phase 38's for the same images at the golden
    tolerances (md_tests: conf 0.005, coord 0.001).
    6. 8 images of the YOLO set with labels (4 a camera), resized to
    1280 x 1280, their label files into pad_targets: 3 Adam steps of
    phase 28's yolov5l6 (nc 3) in bf16 at batch 8 (_train_detector):
    every loss finite, launches exactly E7 and E7 backward 3 x the
    activated convs each, nothing else of ours.
    ocr_tools is left out: neither machine is promised an OCR engine, and
    without one the module raises (its CPU tests inject ocr_fn). Prints
    each step's seconds, the launches and the counts. Returns the phase's
    (nms, conv, bottleneck, stem, silu) launches and its E7 backward
    launches.
    """

    import numpy as np
    import torch
    from PIL import Image

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import load_checkpoint
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.training.train_detector import pad_targets
    from megadetector_tpu_torch.utils import md_tests

    start = time.time()
    folder = os.path.join(workdir, 'workflow_images')
    previous = os.path.join(workdir, 'classifier_workflow')
    db_file = os.path.join(previous, 'db.json')
    results_file = os.path.join(previous, 'detections.json')
    model_file = os.path.join(previous, 'md_vsmoke_workflow.npz')
    out = os.path.join(workdir, 'data_formats')
    seconds = {}

    def step(name, fn):
        t0 = time.time()
        value = fn()
        seconds[name] = time.time() - t0
        return value

    def fail(message):
        raise AssertionError('phase 39: ' + message)

    t0 = time.time()
    counts, yolo_dir = _data_format_tools(folder, db_file, results_file,
                                          out, step, fail)
    steps = {'1-4': time.time() - t0}

    # 5. A LILA subset over loopback, then through the card
    t0 = time.time()
    subset, subset_files, more = _lila_subset(folder, db_file, results_file,
                                              out, step, fail)
    counts.update(more)
    subset_results = os.path.join(out, 'lila_subset_detections.json')

    def detect():
        detector = load_detector(model_file, device=device,
                                 detector_options={'dtype': 'bfloat16'})
        launches, _ = _counted_detection(
            'phase 39 on {}, the LILA subset through phase 28\'s yolov5l6 '
            '(bf16) at {:.4f}'.format(card, threshold), detector,
            model_file, subset_files, subset, threshold, subset_results)
        del detector
        torch.cuda.empty_cache()
        return launches

    launches = step('detect (LILA subset)', detect)
    errors = validate_batch_results(subset_results)['validation_results']
    with open(results_file) as f:
        results = json.load(f)
    names = set(os.path.relpath(p, subset) for p in subset_files)
    reference = dict(results, images=[im for im in results['images']
                                      if im['file'] in names])
    parity = md_tests.compare_results(subset_results, reference)
    if errors['validation_errors'] or parity['errors'] or \
            parity['n_images_compared'] != len(subset_files):
        fail('the LILA subset\'s detections against phase 38\'s: {} images '
             'compared, {}'.format(parity['n_images_compared'],
                                   (errors['validation_errors'] +
                                    parity['errors'])[:5]))
    steps['5'] = time.time() - t0

    # 6. Three bf16 training steps from the YOLO labels
    t0 = time.time()
    chosen = []
    for camera in ('cam0', 'cam1'):
        chosen += [p for p in sorted(
            os.path.join(yolo_dir, camera, f) for f in os.listdir(
                os.path.join(yolo_dir, camera)) if f.endswith('.jpg'))
            if _label_rows(p[:-4] + '.txt')][:4]
    side = DETECTOR_TRAIN_SIZE
    images, boxes, classes = [], [], []
    for path in chosen:
        with Image.open(path) as im:
            images.append(np.asarray(im.convert('RGB').resize(
                (side, side), Image.BILINEAR)))
        rows = np.asarray(_label_rows(path[:-4] + '.txt'), np.float32)
        boxes.append(rows[:, 1:5])
        classes.append(rows[:, 0].astype(np.int64))
    targets = pad_targets(boxes, classes,
                          max_targets=max(len(b) for b in boxes))
    params, _ = load_checkpoint(workflow_path)
    losses, times, _, peak, train_launches, n_act = step(
        'train (3 bf16 steps)', lambda: _train_detector(
            device, params, torch.bfloat16, len(images), steps=3,
            images=np.stack(images), targets=targets))
    want = (0, 0, 0, 0, 3 * n_act, 3 * n_act)
    if len(images) != 8 or not all(np.isfinite(losses)) or \
            train_launches != want:
        fail('training from the YOLO labels: {} images, losses {}, launches '
             '(nms, conv, bottleneck, stem, E7, E7 backward) {}, want '
             '{}'.format(len(images), losses, train_launches, want))
    steps['6'] = time.time() - t0
    counts['training targets'] = int(targets[2].sum())

    total = tuple(a + b for a, b in zip(launches, train_launches[:5]))
    print('phase 39 on {}: launches (nms, conv, bottleneck, stem, silu) '
          'detection {}, training {}, E7 backward {}; LILA subset against '
          'phase 38 over {} images: max conf error {:.4f}, max coord error '
          '{:.4f}; training losses {}, step ms {}, {:.2f} GB peak; '
          'counts {}'.format(
              card, launches, train_launches[:5], train_launches[5],
              parity['n_images_compared'], parity['max_conf_error'],
              parity['max_coord_error'],
              ['{:.4f}'.format(v) for v in losses],
              ['{:.1f}'.format(v) for v in times], peak,
              ', '.join('{} {}'.format(k, v) for k, v in counts.items())),
          flush=True)
    print('phase 39 on {}: seconds by step: {}; steps 1-4 {:.3f}, 5 {:.3f}, '
          '6 {:.3f}; total {:.3f}'.format(
              card, ', '.join('{} {:.3f}'.format(k, v)
                              for k, v in seconds.items()),
              steps['1-4'], steps['5'], steps['6'], time.time() - start),
          flush=True)
    return total, train_launches[5]


#%% 40: the Wildlife Insights and SpeciesNet results layer and the WI
#%% download workflow

# Phase 40's WI project and its stand-in bucket
WI_PROJECT_ID = 2013431
WI_BUCKET = 'wi-smoke-bucket'
WI_API_HOST = 'https://api.wildlifeinsights.org'
# The country the phase's geofence rules are asked about
WI_COUNTRY = 'USA'

# `gcloud storage cp [-r] [--no-clobber] SRC DST` for the download
# scripts: gs://<bucket>/<path> is <root>/<bucket>/<path>; a folder is
# copied into DST under its own name; every object copied is logged, one
# line a copy (@PYTHON@ and @ROOT@ filled in by the phase)
_GCLOUD_STUB = """#!@PYTHON@
import os, shutil, sys
args = sys.argv[1:]
if args[:2] != ['storage', 'cp'] or len(args) < 4:
    sys.exit(2)
flags, (src, dst) = args[2:-2], args[-2:]
if set(flags) - {'-r', '--no-clobber'} or not src.startswith('gs://'):
    sys.exit(2)
root = '@ROOT@'
path = os.path.join(root, src[len('gs://'):])
if not os.path.exists(path):
    sys.exit(1)
if os.path.isdir(path):
    if '-r' not in flags:
        sys.exit(1)
    pairs = []
    top = os.path.join(dst, os.path.basename(os.path.normpath(path)))
    for base, _, files in os.walk(path):
        for f in files:
            full = os.path.join(base, f)
            pairs.append((full, os.path.join(top, os.path.relpath(full,
                                                                  path))))
else:
    pairs = [(path, dst)]
for source, target in pairs:
    if '--no-clobber' in flags and os.path.exists(target):
        continue
    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    shutil.copyfile(source, target)
    with open(os.path.join(root, 'copies.log'), 'a') as log:
        log.write('gs://' + os.path.relpath(source, root) + '\\n')
"""


class _WIRecordingServer:
    """A ThreadingHTTPServer on 127.0.0.1 (a free port) that records each
    POST (path, headers, JSON body): {'token': [token]} on paths ending in
    /token, {'ok': true} elsewhere. A context manager; [url] is its
    base."""

    def __init__(self, token):
        import http.server
        import threading

        self.requests = []
        lock = threading.Lock()
        requests = self.requests

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers['Content-Length']))
                with lock:
                    requests.append((self.path, dict(self.headers),
                                     json.loads(body)))
                data = json.dumps(
                    {'token': token} if self.path.endswith('/token')
                    else {'ok': True}).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0),
                                                     Handler)
        self.url = 'http://127.0.0.1:{}'.format(self.httpd.server_port)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def _wi_taxonomy(out, class_names, blocked):
    """The phase's WI taxonomy release over the classifier's class names
    (each a species-level prediction string) with a family-level string
    for each family among them, and its geofencing: a third of the
    species and those in [blocked] blocked in the USA, the first 200 of
    the next third allowed in the USA and Canada only, the rest without a
    rule. Returns (the taxonomy file, the geofence file, the country-code
    file, the family strings, the taxa allowed in the USA)."""

    families = {}
    for name in class_names:
        tokens = name.split(';')
        families.setdefault(tokens[3], 'f{:07x};{};{};{};;;{}'.format(
            len(families), tokens[1], tokens[2], tokens[3], tokens[3]))
    taxonomy_file = os.path.join(out, 'wi_taxonomy.txt')
    with open(taxonomy_file, 'w') as f:
        f.write('\n'.join(list(class_names) + list(families.values())) +
                '\n')
    rules = {}
    for i, name in enumerate(class_names):
        five = ';'.join(name.split(';')[1:6])
        if i % 3 == 0:
            rules[five] = {'block': {'USA': []}}
        elif i % 3 == 1 and i < 600:
            rules[five] = {'allow': {'USA': [], 'CAN': []}}
        if name in blocked:
            rules[five] = {'block': {'USA': []}}
    geofence_file = os.path.join(out, 'geofence.json')
    with open(geofence_file, 'w') as f:
        json.dump(rules, f)
    codes_file = os.path.join(out, 'country_codes.csv')
    with open(codes_file, 'w') as f:
        f.write('name,alpha-2,alpha-3\nUnited States of America,US,USA\n'
                'Canada,CA,CAN\nAustralia,AU,AUS\n')
    allowed = sorted(k for k, v in rules.items() if 'allow' in v)
    return taxonomy_file, geofence_file, codes_file, families, allowed


def _wi_classes(im, descriptions):
    """[(class string, score)] of the top (by confidence) classified
    detection of [im], scores descending, or None."""

    classified = [d for d in im['detections'] or []
                  if d.get('classifications')]
    if not classified:
        return None
    top = max(classified, key=lambda d: d['conf'])
    return sorted(((descriptions[c], score)
                   for c, score in top['classifications']),
                  key=lambda cs: -cs[1])


def _wi_ensemble_file(predictions, data, handler, path):
    """An ensemble-format predictions.json from the card's two-stage
    results: each image's detections ([predictions], MD -> SpeciesNet),
    its 'classifications' the top classified detection's (the ensemble's
    strings, scores descending; blank at 1.0 where no detection was
    classified), and its 'prediction' the first class allowed in
    WI_COUNTRY under [handler]'s geofencing, else the top class's parent
    (SpeciesNet's geofence rollup). Returns the file's dict."""

    from megadetector_tpu_torch.utils import ct_utils
    from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
        blank_prediction_string

    descriptions = data['classification_category_descriptions']
    out = []
    for p, im in zip(predictions['predictions'], data['images']):
        p = dict(p)
        pairs = _wi_classes(im, descriptions)
        if pairs:
            allowed = [cs for cs in pairs
                       if handler.species_allowed_in_country(cs[0],
                                                             WI_COUNTRY)]
            prediction, score = allowed[0] if allowed else (
                handler.parent_string(pairs[0][0]), pairs[0][1])
        else:
            pairs = [(blank_prediction_string, 1.0)]
            prediction, score = pairs[0]
        p['classifications'] = {'classes': [c for c, _ in pairs],
                                'scores': [s for _, s in pairs]}
        p['prediction'] = prediction
        p['prediction_score'] = score
        p['prediction_source'] = 'ensemble'
        out.append(p)
    ensemble = {'predictions': out}
    ct_utils.write_json(path, ensemble, force_str=True)
    return ensemble


def _wi_two_stage(device, folder, classifier_path, workflow_path, threshold,
                  out, card, fail):
    """run_md_and_speciesnet over [folder] with phase 28's yolov5l6 in bf16
    (pad_batches_to 8) at [threshold] for output and classification and
    the EfficientNetV2-M at [classifier_path] in bf16, the ensemble on;
    launches exact (_expected_launches, and 147 bias + SiLU launches a
    classifier forward). Returns (the results file, its dict, (nms, conv,
    bottleneck, stem, silu), classifier forwards, crops)."""

    import math

    import torch

    from megadetector_tpu_torch.detection import run_md_and_speciesnet
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import ValidateBatchResultsOptions, validate_batch_results

    detector = load_detector(workflow_path, device=device, detector_options={
        'dtype': 'bfloat16', 'pad_batches_to': 8})
    options = run_md_and_speciesnet.RunMDSpeciesNetOptions()
    options.source = folder
    options.output_file = os.path.join(out, 'speciesnet_results.json')
    options.detector_model = detector
    options.classification_model = classifier_path
    options.classifier_options = {'dtype': 'bfloat16'}
    options.detection_confidence_threshold_for_output = threshold
    options.classification_confidence_threshold = threshold
    options.apply_ensemble = True
    options.device = device
    before = _program_calls(detector)
    programs = detector.programs_run
    _reset_counts()
    data = run_md_and_speciesnet.run_md_and_speciesnet(options)
    counts = _counts()
    forwards, _, selects, _ = _program_deltas(detector, before)
    programs = detector.programs_run - programs
    validation = ValidateBatchResultsOptions()
    validation.raise_errors = True
    validate_batch_results(options.output_file, options=validation)

    crops = sum('classifications' in d for im in data['images']
                for d in im['detections'] or [])
    qualifying = sum(d['category'] == '1' and d['conf'] >= threshold
                     for im in data['images'] for d in im['detections'] or [])
    clf_forwards = math.ceil(crops / options.classifier_batch_size)
    config = efficientnet.EfficientNetConfig(CLASSIFIER_ARCH,
                                             num_classes=CLASSIFIER_CLASSES)
    _, e7 = efficientnet.forward_launches(config, False, torch.bfloat16)
    want = _expected_launches(detector, forwards, False, selects)
    want = want[:4] + (want[4] + clf_forwards * e7,)
    if counts != want or programs != sum(forwards.values()) or \
            not 0 < crops <= qualifying or len(data['images']) != 64:
        fail('run_md_and_speciesnet: launches (nms, conv, bottleneck, stem, '
             'silu) {}, want {} ({} detection programs {}, {} selection '
             'programs, {} classifier forwards); {} crops of {} qualifying '
             'detections, {} images'.format(
                 counts, want, programs, sorted(forwards.items()), selects,
                 clf_forwards, crops, qualifying, len(data['images'])))
    steps = options.step_seconds
    print('phase 40 on {}: run_md_and_speciesnet (ensemble on) over {} JPEGs '
          'at {:.4f}: {} crops classified in {} forwards of {}; launches '
          '(nms, conv, bottleneck, stem, silu) {} as they imply ({} detection '
          'programs {}, {} selection programs); seconds: detect {:.3f}, crop '
          '{:.3f}, classify {:.3f}, total {:.3f}'.format(
              card, len(data['images']), threshold, crops, clf_forwards,
              options.classifier_batch_size, counts, programs,
              sorted(forwards.items()), selects, steps['detect'],
              steps['crop'], steps['classify'], steps['total']), flush=True)
    del detector
    torch.cuda.empty_cache()
    return options.output_file, data, counts, clf_forwards, crops


def _wi_results_layer(folder, results_file, data, class_names, out, step,
                      fail):
    """The results layer on the card's two-stage results (phase 40's step
    2). Returns (the ensemble file's dict, the card's detections by
    file, {name: count})."""

    import collections
    import csv

    from megadetector_tpu_torch.data_management import speciesnet_to_md
    from megadetector_tpu_torch.taxonomy_mapping import \
        map_lila_taxonomy_to_wi_taxonomy as lila_to_wi
    from megadetector_tpu_torch.utils import wi_taxonomy_utils as wtu
    from megadetector_tpu_torch.utils import wi_utils

    counts = {}
    card = {im['file']: [(d['category'], d['conf'], d['bbox'])
                         for d in im['detections'] or []]
            for im in data['images']}

    # a. MD results -> predictions.json, validated against the folder's
    # instances; split into 4 batches and merged back
    predictions_file = os.path.join(out, 'predictions.json')
    predictions = step('predictions_from_md', lambda: (
        wtu.generate_predictions_json_from_md_results(
            results_file, predictions_file, base_folder=folder)))
    instances_file = os.path.join(out, 'instances.json')
    instances = step('instances', lambda: (
        wtu.generate_instances_json_from_folder(
            folder, country=WI_COUNTRY, admin1_region='CA',
            output_file=instances_file)))
    step('validate_predictions', lambda: wtu.validate_predictions_file(
        predictions_file, instances_file))
    want_paths = sorted(os.path.join(folder, im['file']).replace('\\', '/')
                        for im in data['images'])
    if sorted(p['filepath'] for p in predictions['predictions']) != \
            want_paths or sorted(i['filepath'] for i in instances[
                'instances']) != want_paths or any(
                [(d['category'], d['conf'], d['bbox']) for d in
                 p.get('detections', [])] != card[im['file']]
                for p, im in zip(predictions['predictions'], data['images'])):
        fail('predictions.json and instances.json do not carry the card\'s '
             'images and detections')
    batches = step('split_instances', lambda: (
        wtu.split_instances_into_n_batches(instances_file, 4)))
    by_path = {p['filepath']: p for p in predictions['predictions']}
    shards = []
    for i, batch in enumerate(batches):
        with open(batch) as f:
            paths = [inst['filepath'] for inst in json.load(f)['instances']]
        shard = os.path.join(out, 'predictions_batch_{:03d}.json'.format(i))
        with open(shard, 'w') as f:
            json.dump({'predictions': [by_path[p] for p in paths]}, f)
        shards.append(shard)
    merged_file = os.path.join(out, 'predictions_merged.json')
    merged = step('merge_predictions', lambda: (
        wtu.merge_prediction_json_files(shards, merged_file)))
    wtu.validate_predictions_file(merged_file, instances)
    if len(batches) != 4 or sorted(
            (json.dumps(p, sort_keys=True) for p in merged['predictions'])) \
            != sorted(json.dumps(p, sort_keys=True)
                      for p in predictions['predictions']):
        fail('4 batches merged do not give predictions.json back')

    # b. A taxonomy over the classifier's class names, its geofencing, and
    # an ensemble-format predictions file from the card's classifications
    # Every other species that tops an image's classifications is blocked
    # in the USA as well, so that the geofence step changes some
    tops = sorted({pairs[0][0] for pairs in (
        _wi_classes(im, data['classification_category_descriptions'])
        for im in data['images']) if pairs and pairs[0][0] in
        set(class_names)})
    taxonomy_file, geofence_file, codes_file, families, want_allowed = \
        _wi_taxonomy(out, class_names, set(tops[::2]))
    handler = step('taxonomy_handler', lambda: wtu.TaxonomyHandler(
        taxonomy_file, geofencing_file=geofence_file,
        country_code_file=codes_file))
    allowed = step('taxa_allowed_in_usa', lambda: (
        handler.find_taxa_allowed_in_region(WI_COUNTRY)))
    name = class_names[4]
    if allowed != want_allowed or handler.string_for_name(
            name.split(';')[6]) != name or handler.string_for_name(
                '{} {}'.format(*name.split(';')[4:6])) != name or \
            len(handler.ancestor_chain(name)) != 4 or \
            handler.species_allowed_in_country(class_names[3], WI_COUNTRY):
        fail('TaxonomyHandler over the class names: {} taxa allowed in {} '
             '(want {})'.format(len(allowed), WI_COUNTRY,
                                len(want_allowed)))
    ensemble_file = os.path.join(out, 'ensemble_predictions.json')
    ensemble = step('ensemble_file', lambda: _wi_ensemble_file(
        predictions, data, handler, ensemble_file))
    wtu.validate_predictions_file(ensemble_file, instances)

    # c. Back to MD results, through the function and through the CLI
    md_file = os.path.join(out, 'md_from_ensemble.json')
    md = step('md_from_predictions', lambda: (
        wtu.generate_md_results_from_predictions_json(
            ensemble_file, md_file, base_folder=folder)))
    cli_file = os.path.join(out, 'md_from_ensemble_cli.json')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.path.dirname(os.path.abspath(__file__)) + \
        os.pathsep + env.get('PYTHONPATH', '')
    cli = step('speciesnet_to_md_cli', lambda: subprocess.run(
        [sys.executable, '-m', speciesnet_to_md.__name__, ensemble_file,
         cli_file, '--base_folder', folder], env=env, capture_output=True,
        text=True, timeout=120))
    if cli.returncode != 0:
        fail('the speciesnet_to_md CLI: {}'.format(cli.stderr[-800:]))
    with open(md_file, 'rb') as a, open(cli_file, 'rb') as b:
        if a.read() != b.read():
            fail('the speciesnet_to_md CLI and '
                 'generate_md_results_from_predictions_json differ')
    fake = {k for k, v in md['detection_categories'].items()
            if v == 'unknown'}
    got = {im['file']: [(d['category'], d['conf'], d['bbox'])
                        for d in im['detections'] or []
                        if d['category'] not in fake]
           for im in md['images']}
    n_fake = sum(d['category'] in fake for im in md['images']
                 for d in im['detections'] or [])
    n_pred = sum(p['prediction'] != wtu.blank_prediction_string
                 and not p['detections'] for p in ensemble['predictions'])
    if got != card or n_fake != n_pred or any(
            d.get('classifications', [[None]])[0][0] is None
            for im in md['images'] for d in im['detections'] or []):
        fail('predictions.json -> MD results does not give the card\'s '
             'detections back ({} whole-image detections, {} non-blank '
             'images without detections)'.format(n_fake, n_pred))
    counts['whole-image detections'] = n_fake

    # d. wi_predictions_to_md, and the geofence adjustments against a
    # direct count
    wi_md = step('wi_predictions_to_md', lambda: (
        wi_utils.wi_predictions_to_md(ensemble_file)))
    names = wi_md.get('classification_categories', {})
    for p, im in zip(ensemble['predictions'], wi_md['images']):
        prediction = p['prediction']
        if im['file'] != p['filepath'] or len(im['detections']) < len(
                p['detections']):
            fail('wi_predictions_to_md lost {}'.format(p['filepath']))
        if wi_utils.is_animal_prediction(prediction) and \
                not wi_utils.is_blank_prediction(prediction):
            top = max(im['detections'], key=lambda d: d['conf'])
            common = wi_utils.taxonomy_string_to_common_name(prediction) or \
                wi_utils.taxonomy_string_to_binomial_name(prediction)
            if names[top['classifications'][0][0]] != common or \
                    top['classifications'][0][1] != round(
                        float(p['prediction_score']), 4):
                fail('wi_predictions_to_md classified {} as {}, want '
                     '{}'.format(im['file'], top['classifications'], common))
    adjustments = step('find_geofence_adjustments', lambda: (
        wtu.find_geofence_adjustments(ensemble_file)))
    direct = collections.Counter(
        '{} -> {}'.format(
            wtu.get_common_name_from_prediction_string(
                p['classifications']['classes'][0]),
            wtu.get_common_name_from_prediction_string(p['prediction']))
        for p in ensemble['predictions']
        if p['classifications']['classes'][0] != p['prediction'])
    if adjustments != dict(direct) or list(adjustments.values()) != sorted(
            adjustments.values(), reverse=True) or bool(tops) != bool(
                adjustments):
        fail('find_geofence_adjustments {} against a direct count '
             '{}'.format(adjustments, dict(direct)))
    html = wtu.generate_geofence_adjustment_html_summary(adjustments, 1)
    if adjustments and html.count('<br/>') != len(adjustments):
        fail('the geofence summary lists {} of {} changes'.format(
            html.count('<br/>'), len(adjustments)))
    counts['geofence changes'] = sum(adjustments.values())

    # e. map_lila_taxonomy_to_wi over a LILA CSV of the predicted species
    # (exact), species WI lacks under a family it has (ancestor), an
    # empty category (unmapped)
    predicted = sorted({c for p in ensemble['predictions']
                        for c in p['classifications']['classes']
                        if c in set(class_names)})
    rows = []
    for i, s in enumerate(predicted):
        tokens = s.split(';')
        rows.append({'dataset_name': 'smoke', 'query': tokens[6],
                     'taxonomy_level': 'species',
                     'scientific_name': '{} {}'.format(*tokens[4:6]),
                     'taxonomy_string': repr([
                         (i, 'species', '{} {}'.format(*tokens[4:6]), []),
                         (i, 'genus', tokens[4], []),
                         (i, 'family', tokens[3], [])])})
    for j, family in enumerate(sorted(families)[:4]):
        rows.append({'dataset_name': 'smoke', 'query': 'unknown {}'.format(j),
                     'taxonomy_level': 'species',
                     'scientific_name': 'nogenus{} nospecies'.format(j),
                     'taxonomy_string': repr([
                         (j, 'species', 'nogenus{} nospecies'.format(j), []),
                         (j, 'genus', 'nogenus{}'.format(j), []),
                         (j, 'family', family, [])])})
    rows.append({'dataset_name': 'smoke', 'query': 'empty',
                 'taxonomy_level': '', 'scientific_name': '',
                 'taxonomy_string': ''})
    lila_csv = os.path.join(out, 'lila_taxonomy.csv')
    with open(lila_csv, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    mapped = step('map_lila_taxonomy_to_wi', lambda: (
        lila_to_wi.map_lila_taxonomy_to_wi(
            lila_csv, taxonomy_file,
            output_file=os.path.join(out, 'lila_wi_mapping.csv'))))
    want = [('exact', s) for s in predicted] + [
        ('ancestor:family', families[f]) for f in sorted(families)[:4]] + [
        ('unmapped', '')]
    if [(r['mapping_method'], r['wi_prediction_string'])
            for r in mapped] != want:
        fail('map_lila_taxonomy_to_wi: {}'.format(
            collections.Counter(r['mapping_method'] for r in mapped)))
    counts['LILA rows mapped'] = len(mapped)
    counts['batches'] = len(batches)
    return ensemble, card, counts


def _wi_payloads(folder, ensemble, card, step, fail):
    """Four WI payloads an image (its prediction with the card's
    detections, replacement detections, blank, no CV result), each
    validated; get_auth_token and parallel_push_results_for_images (4
    threads) through the default urllib transport against a loopback
    server that records the requests. Returns the number of payloads
    pushed."""

    import uuid

    import numpy as np

    from megadetector_tpu_torch.utils import wi_platform_utils as wi

    rng = np.random.RandomState(40)
    payloads = []
    for p in ensemble['predictions']:
        file = os.path.relpath(p['filepath'], folder).replace('\\', '/')
        detections = [{'category': c, 'conf': conf, 'bbox': bbox}
                      for c, conf, bbox in card[file]]
        data_file_id = str(uuid.UUID(bytes=rng.bytes(16), version=4))
        tokens = p['prediction'].split(';')
        row = dict(zip(wi.WI_RESULT_FIELDS, tokens),
                   image_id=data_file_id, project_id=WI_PROJECT_ID)
        payloads += [
            wi.generate_payload_for_prediction_string(
                data_file_id, WI_PROJECT_ID, p['prediction'],
                prediction_confidence=float(p['prediction_score']),
                detections=detections),
            wi.generate_payload_with_replacement_detections(row, detections),
            wi.generate_blank_prediction_payload(data_file_id,
                                                 str(WI_PROJECT_ID)),
            wi.generate_no_cv_result_payload(data_file_id, WI_PROJECT_ID)]
        if row['image_id'] != payloads[-3]['predictions'][0]['data_file_id'] \
                or payloads[-3]['predictions'][0]['prediction'] != \
                p['prediction']:
            fail('the replacement payload of {} lost its result'.format(file))
    step('validate_payloads', lambda: [wi.validate_payload(x)
                                       for x in payloads])
    with _WIRecordingServer('tok-phase-40') as server:
        def transport(method, url, headers=None, payload=None):
            return wi._default_transport(
                method, url.replace(WI_API_HOST, server.url),
                headers=headers, payload=payload)

        token = step('get_auth_token', lambda: wi.get_auth_token(
            {'clientId': 'smoke', 'clientSecret': 'phase-40'},
            transport=transport))
        headers = wi.prepare_data_update_auth_headers(token or '')
        codes = step('parallel_push', lambda: (
            wi.parallel_push_results_for_images(
                payloads, headers, transport=transport, n_workers=4)))
    auth, pushes = server.requests[0], server.requests[1:]
    key = (lambda x: json.dumps(x, sort_keys=True))
    if token != 'tok-phase-40' or auth[2] != {
            'clientId': 'smoke', 'clientSecret': 'phase-40'} or \
            codes != [200] * len(payloads) or sorted(
                (x[2] for x in pushes), key=key) != sorted(
                    json.loads(json.dumps(payloads)), key=key) or any(
                x[0] != '/api/v1/data-file/process-CV-response' or
                x[1].get('Authorization') != 'Bearer tok-phase-40'
                for x in pushes):
        fail('the loopback server got {} pushes of {} payloads (token {}, '
             'codes {})'.format(len(pushes), len(payloads), token,
                                sorted(set(codes))))
    return len(payloads)


def _wi_download_workflow(workdir, folder, out, step, fail):
    """The WI download workflow (phase 40's step 4) over a bundle written
    from phase 38's database. Returns {name: count}."""

    import csv
    import shutil
    import uuid

    from PIL import Image

    from megadetector_tpu_torch.data_management import cct_to_wi
    from megadetector_tpu_torch.utils import (directory_listing,
                                              split_locations_into_train_val)
    from megadetector_tpu_torch.workflows import download_wi_projects as dwp

    counts = {}
    base = os.path.join(out, 'wi_projects')
    bucket = os.path.join(out, 'bucket')
    db_file = os.path.join(workdir, 'classifier_workflow', 'db.json')
    with open(db_file) as f:
        db = json.load(f)

    # The bundle: cct_to_wi's images.csv, each row's location the image's
    # gs:// object, blank flags, one image left unidentified
    taxonomy = {
        'deer': {'common_name': 'White-tailed Deer', 'wi_taxon_id': 'u1',
                 'class': 'Mammalia', 'order': 'Cetartiodactyla',
                 'family': 'Cervidae', 'genus': 'Odocoileus',
                 'species': 'virginianus'},
        'fox': {'common_name': 'Red Fox', 'wi_taxon_id': 'u2',
                'class': 'Mammalia', 'order': 'Carnivora',
                'family': 'Canidae', 'genus': 'Vulpes', 'species': 'vulpes'}}
    paths = step('cct_to_wi', lambda: cct_to_wi.cct_to_wi(
        db_file, taxonomy, os.path.join(out, 'cct_to_wi'),
        project_info={'project_id': WI_PROJECT_ID}))
    with open(paths['images'], newline='') as f:
        rows = list(csv.DictReader(f))
    bundle = os.path.join(base, 'csv_downloads',
                          'wildlife-insights_{}_project-{}_data'.format(
                              uuid.UUID(int=40, version=4), WI_PROJECT_ID))
    os.makedirs(bundle)
    file_of = {im['id']: im['file_name'] for im in db['images']}
    url_of = {}
    for i, row in enumerate(rows):
        relative = 'deployment/{}/{}.JPG'.format(row['deployment_id'],
                                                 row['image_id'])
        url_of[row['image_id']] = relative
        row['location'] = 'gs://{}/{}'.format(WI_BUCKET, relative)
        row['is_blank'] = 0
        if i == 5:
            row['identified_by'] = ''
        target = os.path.join(bucket, WI_BUCKET, relative)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copyfile(os.path.join(folder, file_of[row['image_id']]),
                        target)
    # Whole-bucket downloads bring '_500' thumbnails beside 8 originals
    thumbnails = sorted(url_of)[:8]
    for image_id in thumbnails:
        with Image.open(os.path.join(folder, file_of[image_id])) as im:
            im.convert('RGB').resize((500, 375)).save(os.path.join(
                bucket, WI_BUCKET, url_of[image_id][:-4] + '_500.JPG'))
    with open(os.path.join(bundle, 'images_{}.csv'.format(WI_PROJECT_ID)),
              'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for name in ('projects', 'deployments', 'cameras'):
        shutil.copyfile(paths[name], os.path.join(bundle, name + '.csv'))
    stub_dir = os.path.join(out, 'bin')
    os.makedirs(stub_dir)
    with open(os.path.join(stub_dir, 'gcloud'), 'w') as f:
        f.write(_GCLOUD_STUB.replace('@PYTHON@', sys.executable).replace(
            '@ROOT@', bucket))
    os.chmod(os.path.join(stub_dir, 'gcloud'), 0o755)
    env = dict(os.environ)
    env['PATH'] = stub_dir + os.pathsep + env.get('PATH', '')

    # prepare: per-image scripts in 4 workers; run the master script
    projects = step('prepare_project_downloads', lambda: (
        dwp.prepare_project_downloads(base, download_individual_images=True,
                                      n_download_workers=4)))
    project = os.path.join(base, 'images', str(WI_PROJECT_ID))
    workers = sorted(fn for fn in os.listdir(project)
                     if fn.startswith('download_wi_images.') and
                     fn != 'download_wi_images.sh')
    if len(projects) != 1 or projects[0]['id'] != WI_PROJECT_ID or \
            len(set(projects[0]['image_urls_to_download'])) != 64 or \
            len(workers) != 4:
        fail('prepare_project_downloads: {} projects, {} worker scripts'
             .format(len(projects), len(workers)))
    run = step('download (master script)', lambda: subprocess.run(
        ['sh', 'download_wi_images.sh'], cwd=project, env=env,
        capture_output=True, text=True, timeout=300))
    with open(os.path.join(bucket, 'copies.log')) as f:
        copies = f.read().split()
    if run.returncode != 0 or 'Finished downloads' not in run.stdout or \
            sorted(copies) != sorted(set(r['location'] for r in rows)):
        fail('the download scripts: rc {}, {} copies of {} objects: '
             '{}'.format(run.returncode, len(copies), len(url_of),
                         run.stderr[-500:]))
    report = step('check_download_completion', lambda: (
        dwp.check_download_completion(base)))[WI_PROJECT_ID]
    if sorted(report['matching']) != sorted(url_of.values()) or \
            report['missing'] or report['extra'] or report['n_placeholders']:
        fail('check_download_completion: {} matching, {} missing, {} extra'
             .format(len(report['matching']), len(report['missing']),
                     len(report['extra'])))
    for relative in url_of.values():
        with open(os.path.join(project, relative), 'rb') as a, \
                open(os.path.join(bucket, WI_BUCKET, relative), 'rb') as b:
            if a.read() != b.read():
                fail('{} differs from its object'.format(relative))

    # The whole-bucket prefix download next: it brings the thumbnails,
    # which find_redundant_thumbnails lists and the delete removes
    prefix_script = dwp.write_prefix_download_command(
        rows, project, download_command_file=os.path.join(
            project, 'download_images_{}.sh'.format(WI_PROJECT_ID)))
    prefix = step('download (prefix)', lambda: subprocess.run(
        ['sh', prefix_script], cwd=project, env=env, capture_output=True,
        text=True, timeout=300))
    redundant = step('find_redundant_thumbnails', lambda: (
        dwp.find_redundant_thumbnails(base)))
    want = sorted(os.path.join(project, url_of[i][:-4] + '_500.JPG')
                  for i in thumbnails)
    if prefix.returncode != 0 or sorted(redundant) != want:
        fail('the prefix download (rc {}) and find_redundant_thumbnails: '
             '{} of {} thumbnails'.format(prefix.returncode, len(redundant),
                                          len(want)))
    deleted = step('delete_redundant_thumbnails', lambda: (
        dwp.delete_redundant_thumbnails(base)))
    if sorted(deleted) != want or any(os.path.exists(p) for p in want) or \
            dwp.find_redundant_thumbnails(base):
        fail('delete_redundant_thumbnails left thumbnails')

    # COCO with sequences. Its deployment flattening names a file
    # <deployment_id>/<guid> while the downloads sit at
    # url_to_relative_path's deployment/<deployment_id>/<guid> (the JAX
    # module's layout): each deployment folder is linked beside the
    # project's for the preview
    coco_files = step('convert_projects_to_coco', lambda: (
        dwp.convert_projects_to_coco(base)))
    with open(coco_files[0]) as f:
        coco = json.load(f)
    deployments = sorted({r['deployment_id'] for r in rows})
    for deployment in deployments:
        os.symlink(os.path.join('deployment', deployment),
                   os.path.join(project, deployment))
    labels = {}
    for ann in coco['annotations']:
        labels.setdefault(ann['image_id'], set()).add(
            {c['id']: c['name'] for c in coco['categories']}[
                ann['category_id']])
    db_labels = {}
    names = {c['id']: c['name'] for c in db['categories']}
    for ann in db['annotations']:
        db_labels.setdefault(ann['image_id'], set()).add(
            taxonomy[names[ann['category_id']]]['common_name'].lower())
    want_labels = {'{}/{}.JPG'.format(r['deployment_id'], r['image_id']):
                   db_labels[r['image_id']] for r in rows}
    if len(coco_files) != 1 or labels != want_labels or \
            not all('seq_id' in im for im in coco['images']):
        fail('convert_projects_to_coco: {} images, labels equal {}'.format(
            len(coco['images']), labels == want_labels))
    preview = os.path.join(base, 'coco-preview')
    previews = step('preview_project_coco', lambda: (
        dwp.preview_project_coco(base, num_to_visualize=64)))
    rendered = os.listdir(os.path.join(preview, str(WI_PROJECT_ID),
                                       'rendered_images'))
    if previews != [os.path.join(preview, str(WI_PROJECT_ID),
                                 'index.html')] or len(rendered) != 64:
        fail('preview_project_coco: {} pages, {} images rendered'.format(
            len(previews), len(rendered)))

    # Samples, the directory listing of the preview, the location split
    sampled = step('sample_project_images', lambda: (
        dwp.sample_project_images(base, n_samples_per_project=16)))
    for path in sampled:
        image_id = os.path.basename(path)[:-4]
        with open(path, 'rb') as a, open(os.path.join(
                folder, file_of[image_id]), 'rb') as b:
            if a.read() != b.read():
                fail('the sample {} differs from its image'.format(path))
    if len(sampled) != 16:
        fail('sample_project_images copied {}'.format(len(sampled)))
    folders = [root for root, _, _ in os.walk(preview)]
    lacking = sorted(os.path.join(f, 'index.html') for f in folders
                     if not os.path.isfile(os.path.join(f, 'index.html')))
    written = step('directory_listing', lambda: (
        directory_listing.create_html_index(preview)))
    if sorted(written) != lacking or not all(
            os.path.isfile(os.path.join(f, 'index.html')) for f in folders):
        fail('create_html_index wrote {} of {} indexes'.format(
            len(written), len(lacking)))
    location_counts = {}
    by_id = {im['id']: im['location'] for im in coco['images']}
    cat = {c['id']: c['name'] for c in coco['categories']}
    for ann in coco['annotations']:
        counts_at = location_counts.setdefault(by_id[ann['image_id']], {})
        counts_at[cat[ann['category_id']]] = \
            counts_at.get(cat[ann['category_id']], 0) + 1
    val, fractions = step('split_locations_into_train_val', lambda: (
        split_locations_into_train_val.split_locations_into_train_val(
            location_counts, n_random_seeds=100, target_val_fraction=0.25)))
    want_fractions = {
        c: sum(location_counts[v].get(c, 0) for v in val) /
        sum(n.get(c, 0) for n in location_counts.values())
        for c in fractions}
    if len(location_counts) != 4 or len(val) != 1 or \
            fractions != want_fractions or \
            not all(abs(f - 0.25) < 0.1 for f in fractions.values()):
        fail('split_locations_into_train_val over {}: {} {}'.format(
            location_counts, val, fractions))
    counts.update({'bundle rows': len(rows), 'objects copied': len(copies),
                   'thumbnails deleted': len(deleted),
                   'COCO images': len(coco['images']),
                   'preview images': len(rendered),
                   'samples': len(sampled), 'indexes': len(written),
                   'val locations': len(val)})
    return counts


def phase_wildlife_insights(device, workdir, workflow_path, threshold,
                            card):
    """
    40. The Wildlife Insights and SpeciesNet results layer and the WI
    download workflow, from the card's two-stage results. Every step is
    checked and raises on a failure.
    1. run_md_and_speciesnet over phase 28's 64 workflow JPEGs (two
    cameras) with phase 28's yolov5l6 in bf16 at phase 28's threshold and
    phase 23's EfficientNetV2-M (SpeciesNet-style class names) in bf16 on
    the detections above it, the ensemble on (rollup): the file valid,
    launches exact (_expected_launches; 147 bias + SiLU launches a
    classifier forward).
    2. generate_predictions_json_from_md_results (the card's images and
    detections) validated against generate_instances_json_from_folder;
    split_instances_into_n_batches into 4 and merge_prediction_json_files
    of their predictions gives each prediction back once. A WI taxonomy
    of the class names (with family strings) and its geofencing through
    TaxonomyHandler (lookups, the taxa allowed in the USA); an
    ensemble-format predictions file from the card's classifications (the
    first class allowed in the USA, else the parent: SpeciesNet's geofence
    step); generate_md_results_from_predictions_json and the
    speciesnet_to_md CLI (a process of its own) write the same bytes, the
    card's detections at MD rounding, a whole-image detection for each
    non-blank image without one; wi_predictions_to_md classifies each
    animal image's top detection; find_geofence_adjustments equals a
    direct count; map_lila_taxonomy_to_wi maps a LILA CSV of the predicted
    species exactly, unknown species to their family, an empty row not.
    3. Four WI payloads an image (its prediction with the card's
    detections, replacement detections, blank, no CV result), each
    through validate_payload; get_auth_token and
    parallel_push_results_for_images (4 threads) over the default urllib
    transport to a loopback server: the token back, every payload
    received once as generated, status 200.
    4. A WI download bundle from phase 38's database through cct_to_wi
    (csv_downloads/wildlife-insights_<guid>_project-<id>_data, gs://
    locations in a stand-in bucket folder): prepare_project_downloads
    (individual images, 4 workers), the master script with a stub gcloud
    first on PATH (each object copied once, byte-identical);
    check_download_completion (every image, nothing missing or extra); a
    prefix download brings 8 '_500' thumbnails, which
    find_redundant_thumbnails lists and delete_redundant_thumbnails
    removes; convert_projects_to_coco (the database's labels, sequences),
    preview_project_coco (all 64 rendered through visualize_db),
    sample_project_images (16 byte-identical copies), directory_listing
    over the preview (an index in every folder) and
    split_locations_into_train_val over the COCO's location counts.
    Prints each step's seconds. Returns the phase's (nms, conv,
    bottleneck, stem, silu) launches.
    """

    start = time.time()
    folder = os.path.join(workdir, 'workflow_images')
    classifier_path = os.path.join(workdir, 'md_smoke_classifier.npz')
    out = os.path.join(workdir, 'wildlife_insights')
    os.makedirs(out, exist_ok=True)
    seconds = {}

    def step(name, fn):
        t0 = time.time()
        value = fn()
        seconds[name] = time.time() - t0
        return value

    def fail(message):
        raise AssertionError('phase 40: ' + message)

    t0 = time.time()
    results_file, data, launches, clf_forwards, crops = _wi_two_stage(
        device, folder, classifier_path, workflow_path, threshold, out, card,
        fail)
    steps = {'1': time.time() - t0}
    t0 = time.time()
    with open(os.path.splitext(classifier_path)[0] + '.metadata.json') as f:
        metadata = json.load(f)
    ensemble, detections, counts = _wi_results_layer(
        folder, results_file, data, metadata['class_names'], out, step,
        fail)
    steps['2'] = time.time() - t0
    t0 = time.time()
    counts['payloads pushed'] = _wi_payloads(folder, ensemble, detections,
                                             step, fail)
    steps['3'] = time.time() - t0
    t0 = time.time()
    counts.update(_wi_download_workflow(workdir, folder, out, step, fail))
    steps['4'] = time.time() - t0
    print('phase 40 on {}: launches (nms, conv, bottleneck, stem, silu) {}; '
          '{} crops in {} classifier forwards; counts {}'.format(
              card, launches, crops, clf_forwards,
              ', '.join('{} {}'.format(k, v) for k, v in counts.items())),
          flush=True)
    print('phase 40 on {}: seconds by step: {}; steps 1 {:.3f}, 2 {:.3f}, '
          '3 {:.3f}, 4 {:.3f}; total {:.3f}'.format(
              card, ', '.join('{} {:.3f}'.format(k, v)
                              for k, v in seconds.items()),
              steps['1'], steps['2'], steps['3'], steps['4'],
              time.time() - start), flush=True)
    return launches


#%% 41: the taxonomy tools, the YOLO val runner, change detection, XMP
#%% tagging, video rendering and the native host kernels


# Phase 41's sample images: this many of phase 28's JPEGs a camera are
# served on loopback and downloaded by each image-search tool
SAMPLE_IMAGES = 16
# The YOLO val runner's chunk: the 32 downloads in one chunk. Each chunk
# is a val.py process of its own, about 20 s on the card (torch's import
# 7-8 s, the detector's load 2 s, its cold first programs 10-11 s)
YOLO_VAL_CHUNK = 32
# Python's random seed before simple_image_download's Downloader names its
# files (a random id below 1000 each; this seed gives 16 distinct ones)
DOWNLOADER_SEED = 41
# The IoU threshold of the native clustering check (RDE's default)
CLUSTER_IOU = 0.85


def _host_tools_data():
    """tests/torch_host_tools_data.py, shared with the port's CPU tests:
    the seeded taxonomy archives and native.cluster_boxes' rule in
    Python."""

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        'torch_host_tools_data', os.path.join(
            os.path.dirname(os.path.abspath(__file__)), 'tests',
            'torch_host_tools_data.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The stand-in YOLO repository's val.py: the port's detector on the card
# over the dataset YAML's folder, YOLOv5's predictions JSON out, and a
# last line (also appended to $MD_SMOKE_VAL_LOG) with its own launches
_STAND_IN_VAL = """
import argparse, json, os, sys, time
t0 = time.time()
with open('/proc/uptime') as f, open('/proc/self/stat') as g:
    started = float(f.read().split()[0]) - int(g.read().rsplit(')', 1)[1]
        .split()[19]) / os.sysconf('SC_CLK_TCK')
sys.path.insert(0, @REPO@)
p = argparse.ArgumentParser()
for a in ('--task', '--data', '--weights', '--device', '--name',
          '--project'):
    p.add_argument(a)
for a in ('--batch-size', '--imgsz'):
    p.add_argument(a, type=int)
p.add_argument('--conf-thres', type=float)
for a in ('--save-json', '--exist-ok', '--augment'):
    p.add_argument(a, action='store_true')
args = p.parse_args()
import chip_smoke as cs
from PIL import Image
from megadetector_tpu_torch.detection.run_detector import load_detector
from megadetector_tpu_torch.detection.run_detector_batch import \\
    load_and_run_detector_batch
folder = None
for line in open(args.data):
    if line.startswith('path:'):
        folder = line.split(':', 1)[1].strip()
files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
               if os.path.splitext(f)[1].lower() in ('.jpg', '.jpeg',
                                                    '.png'))
t1 = time.time()
# YOLOv5's --device: a CUDA device's index, or 'cpu'
device = 'cuda:' + args.device if args.device.isdigit() else args.device
detector = load_detector(args.weights, device=device,
                         detector_options={'dtype': 'bfloat16'})
t2 = time.time()
before, programs = cs._program_calls(detector), detector.programs_run
cs._reset_counts()
results = load_and_run_detector_batch(
    detector, files, batch_size=args.batch_size, quiet=True,
    confidence_threshold=args.conf_thres, augment=args.augment)
counts = cs._counts()
t3 = time.time()
forwards, _, selects, _ = cs._program_deltas(detector, before)
preds = []
for r in results:
    if r.get('failure'):
        raise RuntimeError('{}: {}'.format(r['file'], r['failure']))
    with Image.open(r['file']) as im:
        w, h = im.size
    base = os.path.splitext(os.path.basename(r['file']))[0]
    for d in r['detections']:
        x, y, bw, bh = d['bbox']
        preds.append({'image_id': base,
                      'category_id': int(d['category']) - 1,
                      'bbox': [x * w, y * h, bw * w, bh * h],
                      'score': d['conf']})
out_dir = os.path.join(args.project, args.name)
os.makedirs(out_dir, exist_ok=True)
with open(os.path.join(out_dir, 'best_predictions.json'), 'w') as f:
    json.dump(preds, f)
line = json.dumps({'images': len(files), 'counts': list(counts),
                   'programs': detector.programs_run - programs,
                   'selects': selects,
                   'forwards': [list(k) + [n] for k, n in
                                sorted(forwards.items())],
                   'seconds': {'startup': round(started, 3),
                               'imports': round(t1 - t0, 3),
                               'load': round(t2 - t1, 3),
                               'detect': round(t3 - t2, 3),
                               'total': round(time.time() - t0 + started,
                                              3)}})
with open(os.environ['MD_SMOKE_VAL_LOG'], 'a') as f:
    f.write(line + '\\n')
print(line)
"""


def _sample_site(workdir, site, rng):
    """Phase 28's JPEGs on the loopback site (the first SAMPLE_IMAGES of
    each camera under images/) and two image-search answer pages in
    Bing's form (murl fields), one a query. Returns ({query: source
    paths}, {query: page name})."""

    import shutil

    folder = os.path.join(workdir, 'workflow_images')
    os.makedirs(os.path.join(site, 'images'))
    sources, pages = {}, {}
    for camera, query in (('cam0', 'red fox'), ('cam1', 'white-tailed deer')):
        names = sorted(os.listdir(os.path.join(folder, camera)))
        chosen = sorted(rng.choice(names, SAMPLE_IMAGES, replace=False))
        sources[query] = []
        urls = []
        for name in chosen:
            served = '{}_{}'.format(camera, name)
            shutil.copyfile(os.path.join(folder, camera, name),
                            os.path.join(site, 'images', served))
            sources[query].append(os.path.join(folder, camera, name))
            urls.append('@BASE@/images/' + served)
        pages[query] = 'search_{}.html'.format(
            re.sub(r'[^a-z0-9]+', '_', query.lower()))
        with open(os.path.join(site, pages[query]), 'w') as f:
            f.write('<html><body>' + ''.join(
                '<a m="{{&quot;murl&quot;:&quot;{}&quot;}}">x</a>'.format(u)
                for u in urls) + '</body></html>')
    return sources, pages


def _loopback_search(base, pages):
    """A search_fn over the site's answer pages: retrieve_sample_image's
    Bing scrape (the page's murl fields) against loopback."""

    import urllib.parse
    import urllib.request

    def search(query, limit):
        q = query.replace('+', ' ')
        url = '{}/{}?q={}&count={}'.format(base, pages[q],
                                           urllib.parse.quote(q), limit)
        with urllib.request.urlopen(url, timeout=30) as r:
            html = r.read().decode('utf-8', errors='replace')
        urls = re.findall(r'murl&quot;:&quot;(.*?)&quot;', html)
        return [u.replace('@BASE@', base) for u in urls][:limit]
    return search


def _taxonomy_and_samples(workdir, out, step, fail):
    """Step 1: the taxonomy tools over archives on loopback, and the
    sample images downloaded by both image-search tools (default urllib
    fetch). Returns (the download folder, {name: count})."""

    import csv
    import random
    import socket

    import numpy as np

    from megadetector_tpu_torch.taxonomy_mapping import (
        retrieve_sample_image, simple_image_download, species_lookup,
        taxonomy_csv_checker, taxonomy_release,
        validate_lila_category_mappings as validate)
    from megadetector_tpu_torch.utils import url_utils

    rng = np.random.RandomState(41)
    site = os.path.join(out, 'site')
    os.makedirs(site)
    commons, species, n_taxa = _host_tools_data().taxonomy_archives(
        site, rng)
    sources, pages = _sample_site(workdir, site, rng)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    base = url_utils.SingletonHTTPServer.start_server(site, port=port,
                                                      host='127.0.0.1')
    counts = {'taxa': n_taxa}
    try:
        fetched = []

        def download(url, dest):
            fetched.append(url)
            url_utils.download_url('{}/{}'.format(base, url.split('/')[-1]),
                                   dest)

        taxonomy_dir = os.path.join(out, 'taxonomy')
        lookups = step('initialize_taxonomy_lookup', lambda: species_lookup
                       .initialize_taxonomy_lookup(taxonomy_dir,
                                                   download_fn=download,
                                                   verbose=False))
        again = step('initialize_taxonomy_lookup (files in place)', lambda:
                     species_lookup.initialize_taxonomy_lookup(
                         taxonomy_dir, download_fn=download, verbose=False))
        if fetched != [species_lookup.TAXONOMY_URLS['GBIF'],
                       species_lookup.TAXONOMY_URLS['iNaturalist']] or \
                sorted(again) != ['gbif', 'inat']:
            fail('initialize_taxonomy_lookup fetched {}'.format(fetched))
        for source in ('gbif', 'inat'):
            person = lookups[source].lookup('person')
            if person is None or person.name.lower() != 'homo sapiens' or \
                    lookups[source].lookup('vehicle') is not None:
                fail('{}: person -> {}'.format(source, person))

        # The detector's categories, common names with their hyphens as
        # spaces, and scientific names: a new dataset's mapping
        picked = sorted(commons)[:12]
        queries = ['animal', 'person', 'vehicle'] + \
            [c.replace('-', ' ') for c in picked] + species[::60]
        want = {'animal': 'animalia', 'person': 'homo sapiens',
                'vehicle': ''}
        want.update({c.replace('-', ' '): commons[c].lower()
                     for c in picked})
        want.update({s.lower(): s.lower() for s in species[::60]})
        mapping_csv = os.path.join(out, 'md_smoke_mapping.csv')
        rows = step('map_new_dataset', lambda: taxonomy_release
                    .map_new_dataset('md_smoke', queries, lookups['gbif'],
                                     output_csv=mapping_csv))
        got = {r['query']: r['scientific_name'].lower() for r in rows}
        if got != {q.lower(): want[q.lower()] for q in queries}:
            fail('map_new_dataset: {}'.format(
                {q: (got.get(q), w) for q, w in want.items()
                 if got.get(q) != w}))
        checked = step('check_taxonomy_csv', lambda: taxonomy_csv_checker
                       .check_taxonomy_csv(mapping_csv, verbose=False))
        issues = taxonomy_release.check_taxonomy_consistency(
            taxonomy_release.read_taxonomy_csv(mapping_csv),
            lookup=lookups['gbif'])
        if checked['n_rows'] != len(queries) or checked['cycle'] or \
                checked['taxon_level_errors'] or \
                checked['scientific_name_errors'] or \
                checked['ambiguous_parent_nodes'] or \
                issues['null_mappings'] != ['md_smoke:vehicle'] or \
                issues['scientific_name_mismatches'] or \
                issues['level_mismatches'] or issues['stale_mappings']:
            fail('the mapping checks: {}; {}'.format(checked, issues))
        categories = os.path.join(out, 'md_smoke_categories.json')
        with open(categories, 'w') as f:
            json.dump({'md_smoke': [{'name': q} for q in queries],
                       'md_smoke_bbox': [{'name': 'animal'}]}, f)
        preview = step('preview_lila_taxonomy', lambda: taxonomy_release
                       .preview_lila_taxonomy(mapping_csv,
                                              os.path.join(out, 'preview')))
        release_csv = os.path.join(out, 'md_smoke_release.csv')
        released = step('prepare_taxonomy_release', lambda: taxonomy_release
                        .prepare_taxonomy_release(mapping_csv, release_csv,
                                                  categories))
        with open(release_csv, newline='') as f:
            read_back = list(csv.DictReader(f))
        person = [r for r in read_back if r['query'] == 'person']
        if len(released) != len(queries) or len(read_back) != len(queries) \
                or len(person) != 1 or \
                person[0]['species'] != 'homo sapiens' or \
                person[0]['kingdom'] != 'animalia' or \
                'source' in read_back[0] or not os.path.isfile(preview):
            fail('prepare_taxonomy_release: {} rows, person {}'.format(
                len(read_back), person))
        with open(categories) as f:
            dataset_to_categories = json.load(f)
        missing, unmapped = step('validate_category_mappings', lambda:
                                 validate.validate_category_mappings(
                                     dataset_to_categories,
                                     validate.load_taxonomy_queries(
                                         mapping_csv), verbose=False))
        if missing or unmapped != ['md_smoke:vehicle']:
            fail('validate_category_mappings: missing {}, unmapped '
                 '{}'.format(missing, unmapped))
        counts['mapped queries'] = len(queries) - 1

        # The sample images, through both tools' default urllib fetch
        downloads = os.path.join(out, 'downloads')
        search = _loopback_search(base, pages)
        retrieved = step('retrieve_sample_image', lambda: retrieve_sample_image
                         .download_images('red fox', os.path.join(
                             downloads, 'retrieved'), limit=SAMPLE_IMAGES,
                             search_fn=search))
        downloader = simple_image_download.Downloader(search_fn=search)
        downloader.directory = os.path.join(downloads, 'simple')
        random.seed(DOWNLOADER_SEED)
        simple = step('simple_image_download', lambda: downloader.download(
            'white-tailed deer', limit=SAMPLE_IMAGES - 1))
        by_query = {'red fox': retrieved, 'white-tailed deer': simple}
        for query, paths in by_query.items():
            got = sorted(_file_bytes(p) for p in paths)
            if len(paths) != SAMPLE_IMAGES or got != sorted(
                    _file_bytes(p) for p in sources[query]):
                fail('{}: {} images downloaded, or other bytes'.format(
                    query, len(paths)))
        counts['images downloaded'] = len(retrieved) + len(simple)
    finally:
        url_utils.SingletonHTTPServer.stop_server()
    return downloads, counts


def _python_first_on_path(workdir):
    """None when `python` on PATH is this interpreter; else a folder
    holding a `python` that execs this interpreter (to put first on
    PATH)."""

    import shutil

    found = shutil.which('python')
    if found and os.path.realpath(found) == os.path.realpath(
            sys.executable):
        return None
    shim = os.path.join(workdir, 'python_shim')
    os.makedirs(shim, exist_ok=True)
    path = os.path.join(shim, 'python')
    with open(path, 'w') as f:
        f.write('#!/bin/sh\nexec "{}" "$@"\n'.format(sys.executable))
    os.chmod(path, 0o755)
    return shim


def _yolo_val(workdir, downloads, workflow_path, threshold, results_file,
              detector, out, card, step, fail):
    """Step 3: run_inference_with_yolo_val through a stand-in YOLO
    repository whose val.py runs the port's detector on the card, at the
    runner's default device ('0'): once chunked (YOLO_VAL_CHUNK, unique
    basenames verified) and run again to show the skip, once through the
    symlink farm. The one chunk holds every download, so merging shards
    and resuming a partly done run are driven by the CPU tests only
    (tests/test_torch_misc_tools.py, chunks of 4 and 5). Each val.py
    process's launches are held exact against [detector] (the same model
    and options). Returns ((nms, conv, bottleneck, stem, silu) of the
    val.py processes, {name: count})."""

    from megadetector_tpu_torch.detection import \
        run_inference_with_yolo_val as yolo_val
    from megadetector_tpu_torch.utils import md_tests

    repo = os.path.join(out, 'yolo_repo')
    os.makedirs(repo)
    with open(os.path.join(repo, 'val.py'), 'w') as f:
        f.write(_STAND_IN_VAL.replace('@REPO@', repr(os.path.dirname(
            os.path.abspath(__file__)))))
    log = os.path.join(out, 'val_launches.jsonl')
    shim = _python_first_on_path(workdir)
    print('phase 41: `python` on PATH is {}'.format(
        'this interpreter ({})'.format(sys.executable) if shim is None else
        'not this interpreter: a shim exec-ing {} goes first on PATH for '
        'the YOLO val runner'.format(sys.executable)), flush=True)
    saved = {k: os.environ.get(k) for k in ('PATH', 'MD_SMOKE_VAL_LOG')}
    os.environ['MD_SMOKE_VAL_LOG'] = log
    if shim is not None:
        os.environ['PATH'] = shim + os.pathsep + os.environ['PATH']

    def options(name, **kwargs):
        o = yolo_val.YoloInferenceOptions()
        o.input_folder = downloads
        o.model_filename = workflow_path
        o.output_file = os.path.join(out, name)
        o.yolo_working_folder = repo
        o.image_size = 1280
        o.conf_thres = threshold
        o.batch_size = 8
        for k, v in kwargs.items():
            setattr(o, k, v)
        return o

    try:
        chunked = options('yolo_val_chunked.json', unique_id_strategy='verify',
                          checkpoint_frequency=YOLO_VAL_CHUNK,
                          checkpoint_folder=os.path.join(out, 'yolo_chunks'))
        step('run_inference_with_yolo_val (chunked)',
             lambda: yolo_val.run_inference_with_yolo_val(chunked))
        first = _file_bytes(chunked.output_file)
        os.remove(chunked.output_file)
        step('run_inference_with_yolo_val (chunked, every chunk done)',
             lambda: yolo_val.run_inference_with_yolo_val(chunked))
        with open(log) as f:
            n_chunked = len(f.readlines())
        if _file_bytes(chunked.output_file) != first or n_chunked != 1:
            fail('the chunked rerun: {} val.py runs in all, the file {}'
                 .format(n_chunked, 'changed' if os.path.isfile(
                     chunked.output_file) else 'missing'))
        links = options('yolo_val_links.json', symlink_folder=os.path.join(
            out, 'yolo_links'))
        step('run_inference_with_yolo_val (links)',
             lambda: yolo_val.run_inference_with_yolo_val(links))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(log) as f:
        runs = [json.loads(line) for line in f]
    if len(runs) != 2 or os.path.exists(links.symlink_folder):
        fail('{} val.py runs (want 2), the symlink farm {}'.format(
            len(runs), 'left' if os.path.exists(links.symlink_folder)
            else 'removed'))
    print('phase 41: val.py processes\' seconds: {}'.format(
        [run['seconds'] for run in runs]), flush=True)
    total = [0] * 5
    for i, run in enumerate(runs):
        forwards = {tuple(f[:3]): f[3] for f in run['forwards']}
        _check_launches('phase 41 on {}, val.py run {} ({} images)'.format(
            card, i + 1, run['images']), detector, tuple(run['counts']),
            run['programs'], run['selects'], forwards)
        total = [a + b for a, b in zip(total, run['counts'])]
    with open(results_file) as f:
        reference = json.load(f)
    counts = {}
    for name, o in (('chunked', chunked), ('links', links)):
        with open(o.output_file) as f:
            md = json.load(f)
        files = {im['file'] for im in md['images']}
        absent = [im['file'] for im in reference['images']
                  if im['file'] not in files and im['detections']]
        parity = md_tests.compare_results(md, dict(
            reference, images=[im for im in reference['images']
                               if im['file'] in files]))
        if absent or parity['errors'] or \
                parity['n_images_compared'] != len(files) or not files:
            fail('the YOLO val runner ({}) against the batch driver: {} '
                 'images compared, absent with detections {}, {}'.format(
                     name, parity['n_images_compared'], absent[:3],
                     parity['errors'][:5]))
        counts['YOLO {} images'.format(name)] = len(files)
        counts['YOLO {} max conf / coord error'.format(name)] = \
            '{:.4f} / {:.4f}'.format(parity['max_conf_error'],
                                     parity['max_coord_error'])
    return tuple(total), counts


class _RecordingExiv2:
    """A stand-in pyexiv2 module: Image(path).modify_xmp(tags) records
    (path, tags)."""

    def __init__(self):
        import threading
        import types

        self.calls = []
        lock = threading.Lock()
        calls = self.calls

        class Image:
            def __init__(self, path):
                self.path = path

            def modify_xmp(self, tags):
                with lock:
                    calls.append((self.path, dict(tags)))

        self.module = types.ModuleType('pyexiv2')
        self.module.Image = Image


def _xmp(downloads, results_file, threshold, out, step, fail):
    """Step 4: XMP sidecars of the card's results, and process_input_data
    (4 threads) into a recording stand-in pyexiv2. Returns {name:
    count}."""

    import importlib.util
    import shutil

    from megadetector_tpu_torch.integration import xmp_integration

    folder = os.path.join(out, 'xmp_images')
    shutil.copytree(downloads, folder)
    with open(results_file) as f:
        data = json.load(f)
    names = data['detection_categories']
    written = step('write_results_to_xmp', lambda: xmp_integration
                   .write_results_to_xmp(results_file, folder,
                                         confidence_threshold=threshold))
    above = 0
    for im in data['images']:
        tags = sorted({'MegaDetector|' + names[d['category']]
                       for d in im['detections'] if d['conf'] >= threshold})
        above += bool(tags)
        with open(os.path.splitext(os.path.join(folder, im['file']))[0] +
                  '.xmp') as f:
            text = f.read()
        if not all('<rdf:li>{}</rdf:li>'.format(t) in text
                   for t in tags or ['MegaDetector|empty']):
            fail('{}: the sidecar lacks {}'.format(im['file'], tags))
    if len(written) != len(data['images']):
        fail('{} sidecars for {} images'.format(len(written),
                                                 len(data['images'])))
    recorder = _RecordingExiv2()
    saved = sys.modules.get('pyexiv2')
    sys.modules['pyexiv2'] = recorder.module
    try:
        options = xmp_integration.xmp_integration_options()
        options.image_folder = folder
        options.input_file = results_file
        options.min_threshold = str(threshold)
        options.num_threads = 4
        step('process_input_data (stand-in pyexiv2, 4 threads)',
             lambda: xmp_integration.process_input_data(options))
    finally:
        if saved is None:
            sys.modules.pop('pyexiv2', None)
        else:
            sys.modules['pyexiv2'] = saved
    want = {}
    for im in data['images']:
        tags = []
        for d in im['detections']:
            name = names[d['category']]
            cat = xmp_integration.category_mapping.get(name, name)
            if cat not in tags and d['conf'] > threshold:
                tags.append(cat)
        want[os.path.join(folder, im['file'])] = {
            'Xmp.lr.hierarchicalSubject': tags}
    if dict(recorder.calls) != want or len(recorder.calls) != len(want):
        fail('process_input_data wrote {} images\' tags, want {}'.format(
            len(recorder.calls), len(want)))
    print('phase 41: pyexiv2 {} (the stand-in recorded the embedded '
          'writes)'.format('is installed' if importlib.util.find_spec(
              'pyexiv2') else 'is not installed'), flush=True)
    return {'XMP sidecars': len(written),
            'sidecars with a detection at the threshold': above,
            'embedded XMP writes': len(recorder.calls)}


def _change_detection(workdir, out, step, fail):
    """Step 5: process_folders and create_change_previews over phase 28's
    two-camera folder, one score held to cv2 directly. Returns {name:
    count}."""

    import cv2
    import numpy as np

    from megadetector_tpu_torch.detection import change_detection

    folder = os.path.join(workdir, 'workflow_images')
    csv_path = os.path.join(out, 'motion.csv')
    options = change_detection.ChangeDetectionOptions()
    results = step('process_folders', lambda: change_detection
                   .process_folders(folder, csv_path, options))
    previews = step('create_change_previews', lambda: change_detection
                    .create_change_previews(results, os.path.join(
                        out, 'change_previews'), num_samples=10,
                        random_seed=41))
    with open(csv_path) as f:
        rows = f.read().splitlines()
    by_camera = {}
    for r in results:
        by_camera.setdefault(os.path.dirname(r['file']), []).append(r)

    def gray(path):
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img.shape[1] > options.comparison_width:
            scale = options.comparison_width / img.shape[1]
            img = cv2.resize(img, (options.comparison_width,
                                   int(round(img.shape[0] * scale))))
        return cv2.GaussianBlur(img, (5, 5), 0)

    cam0 = by_camera[os.path.join(folder, 'cam0')]
    diff = cv2.absdiff(gray(cam0[1]['file']), gray(cam0[0]['file']))
    direct = float(np.count_nonzero(diff > options.diff_threshold)) / \
        diff.size
    candidates = sum(1 for i, r in enumerate(results)
                     if r['motion'] and i > 0)
    if len(results) != 64 or len(rows) != 65 or \
            sorted(len(v) for v in by_camera.values()) != [32, 32] or \
            any(r.get('failure') for r in results) or \
            any(v[0]['motion_fraction'] != 0.0 for v in by_camera.values()) \
            or cam0[1]['motion_fraction'] != direct or \
            len(previews) != min(10, candidates) or \
            any(cv2.imread(p).shape[1] != 2 * min(
                options.comparison_width, cv2.imread(
                    cam0[0]['file']).shape[1]) for p in previews):
        fail('change detection: {} results, {} CSV rows, {} previews of {} '
             'candidates, score {} against {}'.format(
                 len(results), len(rows), len(previews), candidates,
                 cam0[1]['motion_fraction'], direct))
    return {'motion images': sum(r['motion'] for r in results),
            'change previews': len(previews)}


def _video_render(workdir, out, step, fail):
    """Step 6: visualize_video_output over phase 21's time_sample results
    (a frame every 0.5 s) and videos: annotated mp4v videos that reopen
    with every frame, then one sampled video's annotated frames. Returns
    {name: count}."""

    import random

    import cv2

    from megadetector_tpu_torch.visualization import \
        visualize_video_output as vvo

    results_file = os.path.join(workdir, 'video_time_sample.json')
    videos = os.path.join(workdir, 'videos')
    lengths = {'clip_a.mp4': 60, 'clip_b.mp4': 45}
    rendered = step('visualize_video_output (videos)', lambda: vvo
                    .visualize_video_output(results_file, videos,
                                            os.path.join(out, 'videos')))
    frames = {}
    for path in rendered:
        cap = cv2.VideoCapture(path)
        n, shape = 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n += 1
            shape = frame.shape
        cap.release()
        frames[os.path.basename(path)] = (n, shape)
    want = {os.path.splitext(k)[0] + '_annotated.mp4': (n, (1080, 1920, 3))
            for k, n in lengths.items()}
    if frames != want:
        fail('the annotated videos: {}, want {}'.format(frames, want))
    options = vvo.VideoVisualizationOptions()
    options.render_frames_only = True
    options.sample = 1
    options.random_seed = 41
    written = step('visualize_video_output (frames of one sampled video)',
                   lambda: vvo.visualize_video_output(
                       results_file, videos, os.path.join(out, 'frames'),
                       options=options))
    with open(results_file) as f:
        data = json.load(f)
    candidates = [im for im in data['images']
                  if im.get('detections') is not None]
    chosen = random.Random(41).sample(candidates, 1)[0]
    want_frames = sorted({d['frame_number'] for d in chosen['detections']
                          if d['conf'] >= options.confidence_threshold})
    got = sorted(int(os.path.basename(p)[5:11]) for p in written)
    if got != want_frames or not got or any(
            cv2.imread(p).shape != (1080, 1920, 3) for p in written):
        fail('{}: frames {}, want {}'.format(chosen['file'], got,
                                            want_frames))
    return {'annotated videos': len(rendered),
            'annotated frames of {}'.format(chosen['file']): len(written)}


def _native_host(device, downloads, results_file, detector, step, fail):
    """Step 7: the native host library built here; letterbox_u8 against
    ops/boxes.letterbox(auto=False, scaleup=True) on the downloads;
    nms_xyxy against B1's keep mask on each image's class-offset
    candidates of step 2's selection programs (scores -rank in B1's
    order); cluster_boxes against the rule in
    tests/torch_host_tools_data.py on step 2's detections.
    Returns {name: value}."""

    import numpy as np
    import torch
    from PIL import Image

    from megadetector_tpu_torch import native
    from megadetector_tpu_torch.ops import boxes as box_ops
    from megadetector_tpu_torch.ops.cuda_nms import greedy_nms_keep
    from megadetector_tpu_torch.ops.decode import select_topk_candidates
    from megadetector_tpu_torch.ops.nms import _CLASS_OFFSET, cxcywh_to_xyxy
    from megadetector_tpu_torch.utils import path_utils

    built = step('native build', native.is_available)
    if not built:
        fail('the native host library did not build')
    print('phase 41: native host library {}'.format(os.path.relpath(
        native.host_library_path())), flush=True)
    files = path_utils.find_images(downloads, recursive=True)
    images = []
    for path in files:
        with Image.open(path) as im:
            images.append(np.asarray(im.convert('RGB')))
    worst = [0.0, 0.0]

    def letterbox():
        for img in images:
            ref = box_ops.letterbox(img, 1280, auto=False, scaleup=True)[0]
            got = native.letterbox_u8(img, 1280)
            if got.shape != ref.shape:
                fail('letterbox_u8: {} against {}'.format(got.shape,
                                                          ref.shape))
            diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
            worst[0], worst[1] = max(worst[0], mean), max(worst[1], p99)
            if mean >= 1.0 or p99 > 4:
                fail('letterbox_u8 against ops/boxes.letterbox: mean {:.3f}'
                     ', p99 {}'.format(mean, p99))
    step('letterbox_u8 x {}'.format(len(images)), letterbox)

    # Step 2's selection programs: capacity and thresholds by canvas
    selection = {}
    for key in detector._programs.entries:
        if 'select' in key and key[0] == 'forward':
            i = key.index('select')
            shape = tuple(key[2:4])
            capacity, conf, iou = key[i + 1:i + 4]
            if capacity >= selection.get(shape, (0,))[0]:
                selection[shape] = (capacity, conf, iou)
    buckets = {}
    for path, img in zip(files, images):
        info = detector.preprocess_image(img, image_id=path)
        buckets.setdefault(tuple(info['target_shape']), []).append(
            info['img_processed'])
    if not detector._fused_decode or set(buckets) != set(selection):
        fail('canvases {} against the selection programs {}'.format(
            sorted(buckets), sorted(selection)))
    config = detector.config
    stats = {'images': 0, 'candidates': 0, 'kept': 0, 'differing': 0,
             'pairs within an ulp': 0}

    def nms():
        for shape, canvases in sorted(buckets.items()):
            capacity, conf, iou = selection[shape]
            thr = np.float32(iou)
            ulp = float(np.spacing(thr))
            for start in range(0, len(canvases), 8):
                batch = torch.from_numpy(np.stack(
                    canvases[start:start + 8])).to(device)
                with torch.inference_mode():
                    heads = detector._forward(batch)
                    cands = select_topk_candidates(
                        list(heads), config.anchors, config.strides,
                        config.num_classes, conf, capacity)
                    xyxy = cxcywh_to_xyxy(cands['boxes_cxcywh'])
                    valid = cands['valid']
                    masked = torch.where(valid[..., None], xyxy, 0.0)
                    offset = torch.clamp(masked.amax(dim=(1, 2)) + 1.0,
                                         min=_CLASS_OFFSET)
                    shifted = xyxy + cands['classes'].float()[..., None] * \
                        offset[:, None, None]
                    keep = greedy_nms_keep(shifted.contiguous(),
                                           valid.contiguous(), iou)
                for b in range(batch.shape[0]):
                    v = valid[b]
                    n = int(v.sum())
                    pts = shifted[b][v]
                    b1 = set(torch.nonzero(keep[b][v]).flatten().tolist())
                    got = set(native.nms_xyxy(
                        pts.cpu().numpy(), -np.arange(n, dtype=np.float32),
                        iou).tolist())
                    # Pairs whose exact IoU lies within one float32 ulp of
                    # the threshold (the coordinates' products in float64)
                    p = pts.double()
                    area = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])
                    iw = (torch.minimum(p[:, None, 2], p[None, :, 2]) -
                          torch.maximum(p[:, None, 0], p[None, :, 0])
                          ).clamp(min=0)
                    ih = (torch.minimum(p[:, None, 3], p[None, :, 3]) -
                          torch.maximum(p[:, None, 1], p[None, :, 1])
                          ).clamp(min=0)
                    inter = iw * ih
                    exact = inter / (area[:, None] + area[None, :] - inter
                                     ).clamp(min=1e-300)
                    near = torch.triu((exact - float(thr)).abs() <= ulp,
                                      diagonal=1)
                    n_near = int(near.sum())
                    stats['pairs within an ulp'] += n_near
                    stats['images'] += 1
                    stats['candidates'] += n
                    stats['kept'] += len(b1)
                    if got != b1:
                        stats['differing'] += 1
                        # The first box the two decide differently must be
                        # within an ulp of a box both kept before it
                        j = min(got ^ b1)
                        before = sorted(i for i in b1 & got if i < j)
                        if not before or not bool(near[before, j].any()):
                            fail('native NMS against B1 on a {} canvas: '
                                 'box {} of {} decided differently, no '
                                 'kept box within an ulp of the threshold'
                                 .format(shape, j, n))
    step('nms_xyxy against B1', nms)

    with open(results_file) as f:
        data = json.load(f)
    dets = [d for im in data['images'] for d in im['detections']]
    boxes = np.array([d['bbox'] for d in dets], np.float32)
    cats = np.array([int(d['category']) for d in dets], np.int32)
    ids, n_clusters = step('cluster_boxes', lambda: native.cluster_boxes(
        boxes, cats, CLUSTER_IOU))
    want_ids, want_n = _host_tools_data().cluster_rule(boxes, cats,
                                                        CLUSTER_IOU)
    if ids.tolist() != want_ids or n_clusters != want_n:
        fail('cluster_boxes: {} clusters, the rule {}'.format(n_clusters,
                                                               want_n))
    stats.update({'letterbox worst mean |d|': round(worst[0], 4),
                  'letterbox worst p99 |d|': worst[1],
                  'clustered detections': len(dets),
                  'clusters': n_clusters})
    return stats


def phase_host_tools(device, workdir, workflow_path, threshold, card):
    """
    41. The taxonomy tools, the YOLO val runner, change detection, XMP
    tagging, video rendering and the native host kernels, from sample
    images downloaded over loopback through the card's detections. Every
    step is checked and raises on a failure.
    1. GBIF and iNat taxonomy archives (about 300 taxa naming the
    detector's categories: Animalia 'animal', Homo sapiens 'person')
    served by url_utils.SingletonHTTPServer: initialize_taxonomy_lookup
    (download_fn maps each public URL to the server by its basename; a
    second call fetches nothing); map_new_dataset of the categories, 12
    common names (hyphens as spaces) and 4 scientific names, each to its
    taxon, 'vehicle' unmapped; check_taxonomy_csv and
    check_taxonomy_consistency find nothing else; the preview, the
    release (per-level columns) and validate_category_mappings. 16 of
    phase 28's JPEGs a camera downloaded by retrieve_sample_image and by
    simple_image_download's Downloader from a loopback search answer
    (Bing's murl form) with the default urllib fetch, byte-identical.
    2. The 32 downloads through phase 28's yolov5l6 in bf16 at phase 28's
    threshold (load_and_run_detector_batch, batch 8), launches exact.
    3. run_inference_with_yolo_val with a stand-in YOLO repository whose
    val.py runs the same detector on the card (a `python` shim first on
    PATH where `python` is not this interpreter): chunked (one chunk of
    32, unique basenames verified), rerun (the chunk skipped, the same
    file), then through the symlink farm; each val.py process's own
    launches exact (its seconds printed); both MD files match step 2's at
    the golden tolerances (md_tests).
    4. write_results_to_xmp: a sidecar an image with its tags;
    process_input_data in 4 threads into a recording stand-in pyexiv2:
    each image's digiKam tags above the threshold.
    5. process_folders and create_change_previews over phase 28's two
    cameras (frame differencing): 64 scores, each camera's first 0, one
    score equal to cv2 directly, 10 side-by-side previews.
    6. visualize_video_output over phase 21's time_sample results: two
    mp4v videos that reopen with all 60 and 45 frames at 1920x1080, then
    one seeded sample's annotated frames.
    7. The native host library (letterbox_nms.cpp; g++, no libjpeg) built
    here: letterbox_u8 against ops/boxes.letterbox on the 32 downloads
    (mean |d| < 1, p99 <= 4), nms_xyxy against B1's keep mask on every
    image's class-offset candidates at step 2's capacity (equal, but
    where a pair's exact IoU is within a float32 ulp of the threshold),
    cluster_boxes against its rule in Python on step 2's detections.
    Prints each step's seconds. Returns the phase's (nms, conv,
    bottleneck, stem, silu) launches: step 2's and the val.py processes'.
    """

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.utils import path_utils

    start = time.time()
    out = os.path.join(workdir, 'host_tools')
    os.makedirs(out, exist_ok=True)
    seconds, steps = {}, {}

    def step(name, fn):
        t0 = time.time()
        value = fn()
        seconds[name] = time.time() - t0
        return value

    def fail(message):
        raise AssertionError('phase 41: ' + message)

    t0 = time.time()
    downloads, counts = _taxonomy_and_samples(workdir, out, step, fail)
    steps['1'] = time.time() - t0

    t0 = time.time()
    files = path_utils.find_images(downloads, recursive=True)
    results_file = os.path.join(out, 'detections.json')
    detector = step('load_detector', lambda: load_detector(
        workflow_path, device=device, detector_options={'dtype': 'bfloat16'}))
    launches, programs = step('detect', lambda: _counted_detection(
        'phase 41 on {}, the downloads through phase 28\'s yolov5l6 (bf16) '
        'at {:.4f}'.format(card, threshold), detector, workflow_path, files,
        downloads, threshold, results_file))
    errors = validate_batch_results(results_file)['validation_results']
    if len(files) != 2 * SAMPLE_IMAGES or errors['validation_errors']:
        fail('{} downloads detected, {}'.format(
            len(files), errors['validation_errors'][:3]))
    steps['2'] = time.time() - t0

    t0 = time.time()
    val_launches, more = _yolo_val(workdir, downloads, workflow_path,
                                   threshold, results_file, detector, out,
                                   card, step, fail)
    counts.update(more)
    steps['3'] = time.time() - t0

    for label, run in (('4', lambda: _xmp(downloads, results_file,
                                          threshold, out, step, fail)),
                       ('5', lambda: _change_detection(workdir, out, step,
                                                       fail)),
                       ('6', lambda: _video_render(workdir, out, step,
                                                   fail)),
                       ('7', lambda: _native_host(device, downloads,
                                                  results_file, detector,
                                                  step, fail))):
        t0 = time.time()
        counts.update(run())
        steps[label] = time.time() - t0
    del detector
    torch.cuda.empty_cache()

    total = tuple(a + b for a, b in zip(launches, val_launches))
    print('phase 41 on {}: launches (nms, conv, bottleneck, stem, silu) '
          'detection {} ({} programs), val.py processes {}; counts {}'
          .format(card, launches, programs, val_launches,
                  ', '.join('{} {}'.format(k, v) for k, v in counts.items())),
          flush=True)
    print('phase 41 on {}: seconds by step: {}; steps {}; total {:.3f}'
          .format(card, ', '.join('{} {:.3f}'.format(k, v)
                                  for k, v in seconds.items()),
                  ', '.join('{} {:.3f}'.format(k, v)
                            for k, v in steps.items()),
                  time.time() - start), flush=True)
    return total


#%% Phase 42: data parallelism on a two-replica mesh

# Training shapes of phase 42's sharded steps against the unsharded ones
MESH_DETECTOR_SIZE = 640
MESH_CLASSIFIER_ARCH = 'efficientnetv2_s'
MESH_CLASSIFIER_SIZE = 224
MESH_TRAIN_BATCH = 8
MESH_SERVER_REQUESTS = 16


def _replica_programs(detector):
    """({(batch, height, width): forward programs run}, selection programs
    run) over a meshed detector's replicas."""

    forwards, selects = {}, 0
    for r in detector._replicas:
        for key, entry in r.programs.entries.items():
            if 'select' in key:
                selects += entry.calls
            elif key[0] == 'forward':
                forwards[key[1:4]] = forwards.get(key[1:4], 0) + entry.calls
    return forwards, selects


def _mesh_counted(detector, fn):
    """fn() on a meshed detector with the launch counters at 0 just
    before; returns (its value, launches (nms, conv, bottleneck, stem,
    silu), the replicas' {(batch, height, width): forward programs} and
    selection programs it ran), after holding the launches to the ones
    those programs imply (_expected_launches)."""

    forwards_before, selects_before = _replica_programs(detector)
    _reset_counts()
    value = fn()
    counts = _counts()
    forwards_after, selects_after = _replica_programs(detector)
    forwards = {k: n - forwards_before.get(k, 0)
                for k, n in forwards_after.items()
                if n != forwards_before.get(k, 0)}
    selects = selects_after - selects_before
    want = _expected_launches(detector, forwards, False, selects)
    n = sum(forwards.values())
    if counts != want or not n <= selects <= 2 * n:
        raise AssertionError(
            'data parallelism: launches (nms, conv, bottleneck, stem, silu) '
            '{} over the replicas\' programs {} and {} selections, want '
            '{}'.format(counts, sorted(forwards.items()), selects, want))
    return value, counts, forwards, selects


def _golden_options():
    """md_tests at the MD-JSON golden tolerances: conf 0.005, coord
    0.001, boxes matched at IoU 0.85, every detection from md_tests'
    comparison threshold (0.1) compared. Below it a random-weight model
    ranks thousands of near-equal candidates, which any rounding
    reorders at the capacity's edge."""

    from megadetector_tpu_torch.utils import md_tests

    return md_tests.MDTestOptions()


def _md_parity(ours, ref):
    """md_tests.compare_results of two lists of MD records at the golden
    tolerances (_golden_options)."""

    from megadetector_tpu_torch.utils import md_tests

    return md_tests.compare_results({'images': ours}, {'images': ref},
                                    _golden_options())


def _golden_parity(label, ours, ref, n):
    """md_tests.compare_results of two lists of MD records at the golden
    tolerances; raises unless all [n] images match. Returns the
    comparison."""

    parity = _md_parity(ours, ref)
    if parity['errors'] or parity['n_images_compared'] != n:
        raise AssertionError('{}: {} images compared (want {}), {}'.format(
            label, parity['n_images_compared'], n, parity['errors'][:5]))
    return parity


def _train_case(kind, dtype, mesh, device, params, images, targets):
    """One step of the detector or classifier ([kind]) in [dtype], sharded
    over [mesh] or not (None): (metrics, the gradients the optimizer
    stepped with (the sharded step's summed ones) and the parameters
    after the step, each a list of float32 numpy arrays, step ms,
    launches (nms, conv, bottleneck, stem, silu, E7 backward), activated
    convs)."""

    import torch

    from megadetector_tpu_torch.models import efficientnet, yolov5
    from megadetector_tpu_torch.ops import silu_bf16
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training import train_classifier as tc
    from megadetector_tpu_torch.training import train_detector as td

    torch.cuda.empty_cache()
    if kind == 'detector':
        config = yolov5.YoloV5Config(DETECTOR_TRAIN_ARCH, num_classes=3)
        model = yolov5.YoloV5(config).load_params(params).to(device)
        opt = optim.Optimizer(model.parameters(), optim.chain(
            optim.clip_by_global_norm(5.0), optim.adam(DETECTOR_TRAIN_LR)))
    else:
        config = efficientnet.EfficientNetConfig(
            MESH_CLASSIFIER_ARCH, num_classes=4,
            image_size=MESH_CLASSIFIER_SIZE)
        model = tc.make_classifier(config, params, device, dtype)
        opt = optim.Optimizer(model.parameters(), optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(1e-3, weight_decay=1e-5)))
    grads = []
    inner = opt.step

    def step_recording_gradients():
        grads.extend(p.grad.detach().float().cpu().numpy().copy()
                     for p in opt.params)
        inner()

    opt.step = step_recording_gradients
    if kind == 'detector':
        step = td.make_detector_train_step(config, model, opt, dtype) \
            if mesh is None else td.make_sharded_detector_train_step(
                config, model, opt, mesh, compute_dtype=dtype)
        args = (images,) + tuple(targets)
    else:
        step = tc.make_train_step(config, model, opt, 0.1, dtype) \
            if mesh is None else tc.make_sharded_train_step(
                config, model, opt, mesh, label_smoothing=0.1,
                compute_dtype=dtype)
        args = (images, targets)
    _reset_counts()
    silu_bf16.backward_launches = 0
    torch.cuda.synchronize()
    start = time.time()
    metrics = step(*args)
    metrics = {k: float(v) for k, v in metrics.items()}
    launches = _counts() + (silu_bf16.backward_launches,)
    ms = (time.time() - start) * 1e3
    leaves = [p.detach().float().cpu().numpy().copy()
              for p in model.parameters()]
    n_act = _n_activated_convs(model) if kind == 'detector' else None
    del model, opt, step
    return metrics, grads, leaves, ms, launches, n_act


def _mesh_training(device, mesh, det_params, card):
    """Step 4 of phase 42: each sharded step against the unsharded one in
    float32 and in bf16; returns the sharded steps' (silu, backward)
    launches. The invariant is the gradient: the summed shard gradients
    are the whole batch's. The parameters after one Adam step are
    printed, not held: Adam moves each by about lr whatever its
    gradient's size, so a gradient near 0 that rounds otherwise (cuDNN's
    backward sums a batch of 4 in another order than a batch of 8) moves
    its parameter by up to 2 lr the other way."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.models import efficientnet

    rng = np.random.RandomState(42)
    side = MESH_DETECTOR_SIZE
    det_images = rng.randint(0, 256, (MESH_TRAIN_BATCH, side, side,
                                      3)).astype(np.uint8)
    det_targets = _detector_targets(rng, MESH_TRAIN_BATCH)
    clf_config = efficientnet.EfficientNetConfig(
        MESH_CLASSIFIER_ARCH, num_classes=4,
        image_size=MESH_CLASSIFIER_SIZE)
    clf_params = efficientnet.init_params(clf_config, seed=0,
                                          train_init=True)
    clf_images = rng.randint(0, 256, (2 * MESH_TRAIN_BATCH,
                                      MESH_CLASSIFIER_SIZE,
                                      MESH_CLASSIFIER_SIZE,
                                      3)).astype(np.uint8)
    clf_labels = rng.randint(0, 4, 2 * MESH_TRAIN_BATCH).astype(np.int32)

    def dist(xs, ys):
        return float(np.sqrt(sum(np.sum((x.astype(np.float64) - y) ** 2)
                                 for x, y in zip(xs, ys))))

    def worst(xs, ys):
        """The largest |d| of a tensor over its largest |ref|."""
        return max(float(np.abs(x - y).max()) /
                   max(float(np.abs(y).max()), 1e-30)
                   for x, y in zip(xs, ys))

    silu = backward = 0
    for kind, params, images, targets, lr in (
            ('detector', det_params, det_images, det_targets,
             DETECTOR_TRAIN_LR),
            ('classifier', clf_params, clf_images, clf_labels, 1e-3)):
        runs = {}
        for dtype_name, dtype in (('float32', torch.float32),
                                  ('bf16', torch.bfloat16)):
            for sharded in (False, True):
                runs[dtype_name, sharded] = _train_case(
                    kind, dtype, mesh if sharded else None, device, params,
                    images, targets)
        # float32: the loss within rtol 1e-6 (the CPU tests' bar), the
        # gradients within 1e-5 of the whole gradient's L2 norm. cuDNN's
        # backward sums a batch of 4 in another order than a batch of 8,
        # so a tensor whose gradient is a sum that cancels can differ by
        # far more than that against its own largest element (printed)
        m_ref, g_ref, p_ref = runs['float32', False][:3]
        m_sh, g_sh, p_sh = runs['float32', True][:3]
        loss_rel = abs(m_sh['loss'] / m_ref['loss'] - 1)
        g_rel = dist(g_sh, g_ref) / dist(g_ref, [0.0 * g for g in g_ref])
        g_worst = worst(g_sh, g_ref)
        if not loss_rel <= 1e-6 or not g_rel <= 1e-5:
            raise AssertionError(
                'data parallelism: sharded {} float32 step: loss {} against '
                '{} (relative {:.3e}, bar 1e-6), gradients L2 {:.3e} of the '
                'whole gradient\'s (bar 1e-5; the worst tensor {:.3e} of '
                'its max |ref|)'.format(kind, m_sh['loss'], m_ref['loss'],
                                        loss_rel, g_rel, g_worst))
        # bf16: the loss no further from the unsharded bf16 step's than
        # that is from float32's, or than one bf16 ulp of it (a bf16 loss
        # of shards is a sum of rounded parts); the gradients (L2) no
        # further from float32's than 1.5 times the unsharded bf16
        # step's are: each replica rounds its own partial gradient to
        # bf16 before the sum, so two replicas add about sqrt(2) times
        # one rounding's error where that rounding dominates (the
        # classifier's zero head; measured 1.17 on the CPU)
        m16, g16, p16 = runs['bf16', False][:3]
        m16s, g16s, p16s = runs['bf16', True][:3]
        own_loss = max(abs(m16['loss'] - m_ref['loss']),
                       2.0 ** (np.floor(np.log2(abs(m16['loss']))) - 7))
        own_grad = dist(g16, g_ref)
        if abs(m16s['loss'] - m16['loss']) > own_loss or \
                dist(g16s, g_ref) > 1.5 * own_grad:
            raise AssertionError(
                'data parallelism: sharded {} bf16 step: loss {} against '
                '{} (bar {:.3e}), gradients L2 from float32\'s {:.3e} (bar '
                '1.5 x {:.3e})'.format(
                    kind, m16s['loss'], m16['loss'], own_loss,
                    dist(g16s, g_ref), own_grad))
        # Launches: float32 none of ours; bf16 E7 forward and backward
        # once per activated conv in each replica (the detector's l0
        # included: float input), as in the unsharded bf16 step
        for dtype_name in ('float32', 'bf16'):
            ref_l, sh_l = runs[dtype_name, False][4], runs[dtype_name,
                                                          True][4]
            want = tuple(mesh.size * v for v in ref_l)
            if sh_l != want or (dtype_name == 'float32' and any(sh_l)) or \
                    (dtype_name == 'bf16' and not sh_l[4] == sh_l[5] > 0):
                raise AssertionError(
                    'data parallelism: sharded {} {} step launches (nms, '
                    'conv, bottleneck, stem, E7, E7 backward) {}, want {} '
                    '(the unsharded step\'s {} a replica)'.format(
                        kind, dtype_name, sh_l, want, ref_l))
        n_act = runs['bf16', True][5]
        if kind == 'detector' and runs['bf16', True][4][4] != \
                mesh.size * n_act:
            raise AssertionError('data parallelism: sharded detector bf16 '
                                 'E7 launches {} for {} activated convs in '
                                 '{} replicas'.format(
                                     runs['bf16', True][4][4], n_act,
                                     mesh.size))
        silu += runs['bf16', True][4][4]
        backward += runs['bf16', True][4][5]
        p_worst = max(float(np.abs(x - y).max()) for x, y in zip(p_sh,
                                                                p_ref))
        print('data parallelism step 4, {} training on {}: {} batch {} at '
              '{} px, one Adam step sharded over {} replicas against the '
              'unsharded step: float32 loss {:.6f} / {:.6f} (relative '
              '{:.2e}, bar 1e-6), gradients L2 {:.2e} of the whole '
              'gradient\'s (bar 1e-5; the worst tensor {:.2e} of its max '
              '|ref|), parameters after the step max |d| '
              '{:.3e} = {:.3f} lr; bf16 loss {:.6f} / {:.6f} (|d| {:.2e}, '
              'bar {:.2e}), gradients L2 from float32\'s {:.3e} (bar 1.5 x '
              '{:.3e}), parameters L2 {:.3e} (bf16 vs float32 {:.3e}); step '
              'ms float32 {:.1f} / {:.1f}, bf16 {:.1f} / {:.1f} (sharded / '
              'unsharded, eager first steps); bf16 launches (nms, conv, '
              'bottleneck, stem, E7, E7 backward) {}'.format(
                  kind, card, 'yolov5l6' if kind == 'detector' else
                  MESH_CLASSIFIER_ARCH,
                  len(images), images.shape[1], mesh.size, m_sh['loss'],
                  m_ref['loss'], loss_rel, g_rel, g_worst, p_worst,
                  p_worst / lr,
                  m16s['loss'], m16['loss'], abs(m16s['loss'] -
                                                 m16['loss']),
                  own_loss, dist(g16s, g_ref), own_grad, dist(p16s, p16),
                  dist(p16, p_ref), runs['float32', True][3],
                  runs['float32', False][3], runs['bf16', True][3],
                  runs['bf16', False][3], runs['bf16', True][4]),
              flush=True)
    return silu, backward


def phase_data_parallel(device, workdir, float_path, q_path, params, batch,
                        card):
    """
    42. Data parallelism on a two-replica mesh: make_data_mesh(devices=
    [cuda:0, cuda:0]), each replica on its own stream with its own
    program cache and CUDA graphs (the counterpart of the JAX package's
    virtual CPU mesh). Every check raises.
    1. yolov5l6 from phase 4's seed-0 checkpoint as phase 28 rescales it
    ([float_path], _workflow_checkpoint: phase 4's own random weights
    score every box 1.0, so their top 8192 candidates are near-ties that
    any rounding reorders), its int8 chain ([q_path], phase 29's) under
    conv_backend pallas, then the float model in bf16, meshed and not, on
    the 960x1280 batch of 8: run_program eager, captured and replayed
    (identical, every replica's programs replayed), launches exact over
    the replicas' programs (each a batch of 4; B1 once a selection, B2 /
    B3 / B4 / E7 as each forward implies); each shard's outputs
    bit-identical to the unsharded detector's on that shard at the
    capacity the whole batch took; against the whole batch's program the
    largest differences printed (cuDNN may pick other algorithms for 8
    images than for 4); the MD records of 8 synthetic images against the
    unsharded detector's at the golden tolerances under int8 pallas
    (float32 float layers); in bf16 they are printed beside the unsharded
    bf16 records' distance from float32's (the rescaled random model
    amplifies any rounding change; the per-shard identity holds the
    mesh); replayed program ms of both.
    2. load_and_run_detector_batch over phase 18's 64 JPEGs with the
    meshed int8 pallas detector (batch 8), launches exact, its JSON at
    the golden tolerances of the unmeshed run.
    3. MDServer with a meshed int8 pallas detector (the mesh option)
    answers 16 requests from 4 client threads, each equal to step 2's
    record of its image at the golden tolerances.
    4. One sharded step of yolov5l6 (640 px, batch 8) and of
    efficientnetv2_s (224 px, batch 16) against the unsharded step: in
    float32 the loss within rtol 1e-6 and the summed gradients within
    1e-5 of the gradient's L2 norm; in bf16 the loss within the unsharded
    bf16 loss's distance from float32's (or one bf16 ulp) and the
    gradients no further from float32's than 1.5 times the unsharded bf16
    gradients are (_mesh_training: why the gradients and not the
    parameters after Adam); launches: none in float32, in bf16 E7 and E7
    backward once per activated conv in each replica.
    5. dryrun_multichip(2, devices=[cuda:0, cuda:0]).
    6. The helper modules' newest functions on step 2's output:
    draw_bounding_boxes_on_file on four images, parallel_get_image_sizes
    of the renders (the inputs' sizes), parallel_compute_file_hashes
    (distinct, equal to compute_file_hash), zip_files_into_single_zipfile
    of the renders and JSON files (every member reads back).
    7. With more than one card, the driver's auto-mesh over the cards
    (prints the count); with one, it prints that it is not engaged.
    Returns the phase's meshed launches (nms, conv, bottleneck, stem,
    silu) and E7 backward launches.
    """

    import threading
    import zipfile

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection import run_detector_batch as rdb
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.detector import TorchDetector
    from megadetector_tpu_torch.parallel.dryrun import dryrun_multichip
    from megadetector_tpu_torch.parallel.mesh import (local_device_count,
                                                      make_data_mesh)
    from megadetector_tpu_torch.serving import MDServer, ServingOptions
    from megadetector_tpu_torch.serving import client
    from megadetector_tpu_torch.utils import path_utils
    from megadetector_tpu_torch.visualization import visualization_utils

    out_dir = os.path.join(workdir, 'data_parallel')
    os.makedirs(out_dir, exist_ok=True)
    mesh = make_data_mesh(devices=[device, device])
    total = [0, 0, 0, 0, 0]
    seconds = {}

    def add(counts):
        for i, v in enumerate(counts):
            total[i] += v

    # 1. The meshed detector against the unsharded one
    t0 = time.time()
    images = _synthetic_images(np.random.RandomState(1))[:8]
    ids = ['mesh_{}.jpg'.format(i) for i in range(8)]
    b, h, w = batch.shape[:3]
    half = b // 2
    detectors = {}
    float32_records = None
    for label, path, options in (
            ('int8 pallas', q_path, {'conv_backend': 'pallas'}),
            ('bf16', float_path, {'dtype': 'bfloat16'})):
        base = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8))
        meshed = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8, mesh=mesh))
        streams = [r.stream for r in meshed._replicas]
        if len(streams) != 2 or (device.type == 'cuda' and (
                None in streams or streams[0] is streams[1])):
            raise AssertionError('data parallelism: replicas {}'.format(
                meshed._replicas))
        ref = [base.run_program(batch, 0.005, 0.45) for _ in range(3)]
        (eager, captured, replayed), counts, forwards, selects = \
            _mesh_counted(meshed, lambda: [meshed.run_program(
                batch, 0.005, 0.45) for _ in range(3)])
        add(counts)
        for (o, topk) in (captured, replayed):
            if topk != eager[1] or any(
                    o[k].tobytes() != eager[0][k].tobytes() for k in o):
                raise AssertionError('data parallelism {}: replayed outputs '
                                     'differ from eager'.format(label))
        if device.type == 'cuda' and any(
                r.programs.replays == 0 or r.programs.captures == 0
                for r in meshed._replicas):
            raise AssertionError('data parallelism {}: a replica never '
                                 'replayed'.format(label))
        out, topk = eager
        if topk != ref[0][1]:
            raise AssertionError('data parallelism {}: capacity {} meshed, '
                                 '{} unsharded'.format(label, topk,
                                                       ref[0][1]))
        # Each shard is the unsharded detector's program on that shard at
        # the capacity the whole batch took: the same bits
        shard_ref = load_detector(path, device=device, detector_options=dict(
            options, pre_nms_topk=topk, auto_escalate_topk=False))
        shards = [shard_ref.run_program(batch[i:i + half], 0.005, 0.45)[0]
                  for i in (0, half)]
        del shard_ref
        if any(out[k].tobytes() != np.concatenate(
                [s[k] for s in shards]).tobytes() for k in out):
            raise AssertionError('data parallelism {}: the meshed outputs '
                                 'differ from the unsharded detector\'s on '
                                 'each shard'.format(label))
        # Against the whole batch's unsharded program: where cuDNN picks
        # another algorithm for a batch of 8 than of 4, float sums round
        # otherwise (printed: the largest differences where both are
        # valid)
        ref_out = ref[0][0]
        identical = all(out[k].tobytes() == ref_out[k].tobytes()
                        for k in out)
        both = out['valid'] & ref_out['valid']
        d_score = float(np.abs(out['scores'].astype(np.float64) -
                               ref_out['scores'])[both].max(initial=0))
        scale = np.array([w, h, w, h], np.float64)
        d_box = float((np.abs(out['boxes'].astype(np.float64) -
                              ref_out['boxes']) / scale)[both].max(
                                  initial=0))
        ms_meshed = _time_ms(lambda: meshed.run_program(batch, 0.005, 0.45),
                             reps=5)
        ms_base = _time_ms(lambda: base.run_program(batch, 0.005, 0.45),
                           reps=5)
        # The MD records of 8 images, meshed against unsharded: at the
        # golden tolerances where the float layers are float32 (int8
        # pallas). In bf16 the rescaled random model turns any rounding
        # change into large output changes, and cuDNN rounds a batch of 8
        # otherwise than a batch of 4: the records are printed beside the
        # unsharded bf16 records' distance from float32's, and held by the
        # per-shard identity above
        records, more, _, _ = _mesh_counted(
            meshed, lambda: meshed.generate_detections_one_batch(
                images, ids, 0.005))
        add(more)
        ref_records = base.generate_detections_one_batch(images, ids, 0.005)
        if label == 'int8 pallas':
            parity = _golden_parity('data parallelism {}: records'.format(
                label), records, ref_records, 8)
            bar = ''
        else:
            if float32_records is None:
                f32 = load_detector(path, device=device,
                                    detector_options={'pad_batches_to': 8})
                float32_records = f32.generate_detections_one_batch(
                    images, ids, 0.005)
                del f32
            parity = _md_parity(records, ref_records)
            own = _md_parity(ref_records, float32_records)
            if parity['n_images_compared'] != 8:
                raise AssertionError('data parallelism bf16: {} images '
                                     'compared'.format(
                                         parity['n_images_compared']))
            bar = ' (unsharded bf16 against float32: {} outside the ' \
                'golden tolerances, max conf error {:.4f}, coord ' \
                '{:.4f})'.format(len(own['errors']), own['max_conf_error'],
                                 own['max_coord_error'])
        n_det = sum(len(r['detections']) for r in records)
        print('data parallelism step 1, {} on {}: yolov5l6 960x1280 batch '
              '{} over 2 replicas on one card ({} programs of batch {}); '
              'eager, captured and replayed identical, launches (nms, conv, '
              'bottleneck, stem, silu) {} exact; each shard bit-identical '
              'to the unsharded detector on it (capacity {}); against the '
              'whole batch\'s program: bit-identical {}, valid equal {}, '
              'where both valid max |d| score {:.3e}, box {:.3e} of the '
              'canvas; records of 8 images ({} detections): {} outside the '
              'golden tolerances, max conf error {:.4f}, coord {:.4f}{}; '
              'replayed program {:.3f} ms meshed, {:.3f} ms '
              'unsharded'.format(
                  label, card, b, sum(forwards.values()),
                  sorted(forwards)[0][0], counts, topk, identical,
                  np.array_equal(out['valid'], ref_out['valid']), d_score,
                  d_box, n_det, len(parity['errors']),
                  parity['max_conf_error'], parity['max_coord_error'], bar,
                  ms_meshed, ms_base), flush=True)
        if label == 'int8 pallas':
            detectors = {'meshed': meshed, 'base': base}
        else:
            del meshed, base
        torch.cuda.empty_cache()
    seconds['1'] = time.time() - t0

    # 2. The batch driver with the meshed detector
    t0 = time.time()
    folder = os.path.join(workdir, 'folder')
    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.startswith('img_'))
    if len(paths) != 64:
        raise AssertionError('data parallelism: phase 18\'s folder holds '
                             '{} JPEGs'.format(len(paths)))
    meshed = detectors['meshed']
    start = time.time()
    res_meshed, counts, forwards, _ = _mesh_counted(
        meshed, lambda: rdb.load_and_run_detector_batch(
            meshed, list(paths), batch_size=8, quiet=True,
            loader_workers=8))
    meshed_s = time.time() - start
    add(counts)
    start = time.time()
    res_plain = rdb.load_and_run_detector_batch(
        detectors['base'], list(paths), batch_size=8, quiet=True,
        loader_workers=8)
    plain_s = time.time() - start
    files = {}
    for name, res in (('meshed', res_meshed), ('plain', res_plain)):
        files[name] = os.path.join(out_dir, name + '.json')
        rdb.write_results_to_file(res, files[name],
                                  relative_path_base=folder,
                                  detector_file=q_path)
    with open(files['meshed']) as f:
        written = json.load(f)
    with open(files['plain']) as f:
        written_plain = json.load(f)
    parity = _golden_parity('data parallelism: the driver\'s JSON',
                            written['images'], written_plain['images'], 64)
    if any(im.get('failure') for im in written['images']):
        raise AssertionError('data parallelism: driver failures')
    seconds['2'] = time.time() - t0
    print('data parallelism step 2 on {}: load_and_run_detector_batch over '
          'phase 18\'s 64 JPEGs with the meshed int8 pallas detector (batch '
          '8, 8 loader threads): {:.2f} s meshed, {:.2f} s unmeshed; replica '
          'programs {}, launches {} exact; the JSON at the golden '
          'tolerances of the unmeshed run (max conf error {:.4f}, coord '
          '{:.4f})'.format(card, meshed_s, plain_s, sorted(forwards.items()),
                           counts, parity['max_conf_error'],
                           parity['max_coord_error']), flush=True)
    del detectors
    torch.cuda.empty_cache()

    # 3. The server with a meshed detector
    t0 = time.time()
    options = ServingOptions()
    options.port = 0
    options.max_batch_size = 8
    options.batch_wait_ms = 15.0
    options.device = str(device)
    options.detector_options = {'conv_backend': 'pallas', 'mesh': mesh}
    server = MDServer(q_path, options).start()
    url = 'http://127.0.0.1:{}'.format(server.port)
    served, errors = {}, []
    by_file = {im['file']: im for im in written['images']}
    names = sorted(by_file)[:MESH_SERVER_REQUESTS]
    try:
        if server.detector.mesh is not mesh:
            raise AssertionError('data parallelism: the server\'s detector '
                                 'has no mesh')

        def post(chunk):
            try:
                for name in chunk:
                    with open(os.path.join(folder, name), 'rb') as f:
                        served[name] = client.detect_image_bytes(
                            url, f.read(), image_id=name)
            except Exception as e:
                errors.append(e)

        forwards_before, _ = _replica_programs(server.detector)
        _reset_counts()
        threads = [threading.Thread(target=post, args=(names[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        counts = _counts()
        forwards_after, _ = _replica_programs(server.detector)
    finally:
        server.shutdown()
    if errors or len(served) != len(names):
        raise AssertionError('data parallelism: serving errors {}'.format(
            errors))
    add(counts)
    parity = _golden_parity(
        'data parallelism: served records against the driver\'s',
        [served[n] for n in names], [by_file[n] for n in names], len(names))
    programs = {k: n - forwards_before.get(k, 0)
                for k, n in forwards_after.items()}
    if any(k[0] != 4 for k, n in programs.items() if n):
        raise AssertionError('data parallelism: served shards {}'.format(
            programs))
    seconds['3'] = time.time() - t0
    print('data parallelism step 3 on {}: MDServer with the meshed int8 '
          'pallas detector answered {} requests from 4 threads (replica '
          'programs {}; launches {}); each record equals the driver\'s at '
          'the golden tolerances (max conf error {:.4f}, coord '
          '{:.4f})'.format(
              card, len(served), sorted(programs.items()), counts,
              parity['max_conf_error'], parity['max_coord_error']),
          flush=True)
    torch.cuda.empty_cache()

    # 4. The sharded train steps
    t0 = time.time()
    silu, backward = _mesh_training(device, mesh, params, card)
    total[4] += silu
    seconds['4'] = time.time() - t0

    # 5. The dry run
    t0 = time.time()
    _reset_counts()
    dry = dryrun_multichip(2, devices=[device, device])
    counts = _counts()
    # float32: B1 once in each replica (its plain version on the CPU)
    nms_want = 2 if device.type == 'cuda' else 0
    if dry['inference']['boxes'].shape != (4, 100, 4) or counts != \
            (nms_want, 0, 0, 0, 0) or not np.isfinite(
                float(dry['detector']['loss'])) or not np.isfinite(
                float(dry['classifier']['loss'])):
        raise AssertionError('data parallelism: the dry run: boxes {}, '
                             'launches {}'.format(
                                 dry['inference']['boxes'].shape, counts))
    add(counts)
    seconds['5'] = time.time() - t0
    torch.cuda.empty_cache()

    # 6. The helper functions on step 2's output
    t0 = time.time()
    renders = []
    for im in written['images'][:4]:
        src = os.path.join(folder, im['file'])
        dst = os.path.join(out_dir, 'render', im['file'])
        renders.append(visualization_utils.draw_bounding_boxes_on_file(
            src, dst, im['detections'], confidence_threshold=0.5))
    sizes = visualization_utils.parallel_get_image_sizes(renders,
                                                         max_workers=4)
    for src_im, dst in zip(written['images'][:4], renders):
        want = visualization_utils.get_image_size(
            os.path.join(folder, src_im['file']))
        if sizes[dst] != want:
            raise AssertionError('data parallelism: render {} is {}, '
                                 'want {}'.format(dst, sizes[dst], want))
    hashes = path_utils.parallel_compute_file_hashes(renders + [
        files['meshed']], max_workers=4)
    if any(hashes[f] != path_utils.compute_file_hash(f) for f in hashes) \
            or len(set(hashes.values())) != len(hashes):
        raise AssertionError('data parallelism: hashes {}'.format(hashes))
    zip_path = path_utils.zip_files_into_single_zipfile(
        renders + list(files.values()), os.path.join(out_dir, 'out.zip'),
        arc_name_base=out_dir)
    with zipfile.ZipFile(zip_path) as zf:
        members = sorted(zf.namelist())
        if zf.testzip() is not None or len(members) != 6:
            raise AssertionError('data parallelism: zip members '
                                 '{}'.format(members))
    seconds['6'] = time.time() - t0
    print('data parallelism step 6 on {}: 4 renders of the meshed driver\'s '
          'detections ({}), their sizes {} equal to the inputs\', {} '
          'distinct sha256 hashes, a zip of {} members ({:.1f} MB)'.format(
              card, ', '.join(os.path.basename(r) for r in renders),
              sorted(set(sizes.values())), len(hashes), len(members),
              os.path.getsize(zip_path) / 1e6), flush=True)

    # 7. The auto-mesh over the machine's cards
    n_cards = local_device_count()
    if n_cards > 1:
        t0 = time.time()
        detector_log = []
        original = TorchDetector.attach_auto_mesh

        def recording(detector, batch_size, *args, **kwargs):
            out = original(detector, batch_size, *args, **kwargs)
            detector_log.append((detector.mesh, out))
            return out

        TorchDetector.attach_auto_mesh = recording
        try:
            rdb.load_and_run_detector_batch(
                float_path, list(paths[:16]), batch_size=8, quiet=True,
                detector_options={'dtype': 'bfloat16'})
        finally:
            TorchDetector.attach_auto_mesh = original
        mesh_used = detector_log[-1][0]
        if mesh_used is None or mesh_used.size != n_cards:
            raise AssertionError('data parallelism: the auto-mesh over {} '
                                 'cards attached {}'.format(n_cards,
                                                            mesh_used))
        print('data parallelism step 7: the driver\'s auto-mesh over {} '
              'cards (batch size {}) in {:.1f} s'.format(
                  n_cards, detector_log[-1][1], time.time() - t0),
              flush=True)
    else:
        print('data parallelism step 7: {} card: the driver\'s and the '
              'server\'s auto-mesh engage above one card only; not run '
              'here'.format(n_cards), flush=True)

    print('data parallelism on {}: steps {} s; meshed launches (nms, conv, '
          'bottleneck, stem, silu) {}, E7 backward {}'.format(
              card, {k: round(v, 1) for k, v in seconds.items()},
              tuple(total), backward), flush=True)
    return tuple(total), backward



def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this '
              'smoke run needs a CUDA card', file=sys.stderr)
        return 1

    from megadetector_tpu_torch.device import get_device, set_float32_exact
    from megadetector_tpu_torch.models.yolov5 import (YoloV5Config,
                                                      init_params)
    from megadetector_tpu_torch.ops import _build

    # 1. device
    device = get_device('cuda')
    set_float32_exact()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    import importlib.util
    print('device: torch {} CUDA {} python {}; {} (count {}); {}; cv2 {}; '
          'pandas {}; tensorflow {}; networkx {}'
          .format(torch.__version__, torch.version.cuda,
                  sys.version.split()[0], torch.cuda.get_device_name(0),
                  torch.cuda.device_count(), card,
                  'present' if importlib.util.find_spec('cv2')
                  else 'absent (numpy letterbox)',
                  'present' if importlib.util.find_spec('pandas')
                  else 'absent',
                  'present' if importlib.util.find_spec('tensorflow')
                  else 'absent (no .pb detector)',
                  'present' if importlib.util.find_spec('networkx')
                  else 'absent (no taxonomy graph)'), flush=True)

    # 2. build
    start = time.time()
    _build.load_library()
    print('build: {:.1f} s (nvcc {:.1f} s) -> {}'.format(
        time.time() - start, _build.build_seconds or 0.0,
        os.path.relpath(_build.library_path())), flush=True)
    serialized = []
    for line in _build.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas: ' + line.strip())
        if 'C7520' in line or 'C7514' in line:
            # ptxas serialized a kernel's wgmma (issued in divergent code,
            # or accumulators read between issue and wait)
            print('  ptxas: ' + line.strip())
            serialized.append(line)
    if any('gemm_int8' in line for line in serialized):
        raise AssertionError('ptxas serialized the GEMM kernel\'s wgmma')

    # 3. kernel vs plain
    record = phase_kernel(device)

    config = YoloV5Config('yolov5l6', num_classes=3)
    params = init_params(config, seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        # 4. main path
        torch.cuda.reset_peak_memory_stats()
        launches, e2e, device_rate, detector, buckets, float_path, pairs = \
            phase_main_path(device, workdir, config, params)
        record['launches'] = launches
        print('main path throughput on {}: {:.3f} images/s through '
              'load_and_run_detector_batch (host letterbox included), '
              '{:.3f} images/s through generate_detections_one_batch on '
              'letterboxed batches; 1280 px auto canvases, batch 8, '
              'float32'.format(card, e2e, device_rate), flush=True)
        batch, float_fwd = phase_breakdown(detector, buckets)

        # 16. the program cache (float32; the other configurations after
        # their main paths), and the host copy
        phase_program_cache(detector, batch, 'float32')
        pageable_ms, pinned_ms = _copy_ms(batch)
        print('host -> device copy of the uint8 960x1280 batch of 8 ({:.1f} '
              'MB): {:.3f} ms pageable, {:.3f} ms pinned'.format(
                  batch.nbytes / 1e6, pageable_ms, pinned_ms), flush=True)

        # 5. card vs CPU
        phase_card_vs_cpu(detector, config, params)
        del detector
        torch.cuda.empty_cache()

        # 6. int8 kernels vs plain
        conv_record, bottleneck_record = phase_int8_kernels(device, config)

        # 7. int8 main path
        q_path, counts, rates, forward_ms, detector, chain_programs = \
            phase_int8_main_path(device, workdir, float_path, pairs, batch,
                                 profile='--profile' in sys.argv[1:])
        conv_record['launches'] = counts['xla'][0]
        bottleneck_record['launches'] = counts['pallas'][1]
        print('int8 main path throughput on {}: {:.3f} images/s '
              '(conv_backend xla), {:.3f} images/s (pallas) through '
              'load_and_run_detector_batch, float32 {:.3f}; forward per '
              '960x1280 batch of 8: int8 {:.3f} ms (xla), {:.3f} ms '
              '(pallas), float32 {:.3f} ms'.format(
                  card, rates['xla'], rates['pallas'], e2e,
                  forward_ms['xla'], forward_ms['pallas'], float_fwd),
              flush=True)

        # 8. int8 card vs CPU
        phase_int8_card_vs_cpu(q_path, detector)
        del detector
        torch.cuda.empty_cache()

        # 9. bf16 kernels vs plain
        stem_record, silu_record = phase_bf16_kernels(device, params)

        # 10. bf16 main path
        stem_launches, silu_launches, bf16_rate, bf16_fwd, detector = \
            phase_bf16_main_path(device, workdir, float_path, pairs, batch)
        stem_record['launches'] = stem_launches
        silu_record['launches'] = silu_launches

        # 11. int8 + bf16 main path
        int8_bf16_rates, int8_bf16_fwd = phase_int8_bf16_main_path(
            device, workdir, q_path, pairs, batch)

        # 12. device preprocessing
        device_rates = phase_device_preprocess(device, workdir, float_path,
                                               pairs)
        print('bf16 throughput on {}: {:.3f} images/s float bf16, {:.3f} / '
              '{:.3f} int8 + bf16 (xla / pallas), device preprocess {:.3f} '
              'float32 / {:.3f} bf16; forward per 960x1280 batch of 8: bf16 '
              '{:.3f} ms, int8 + bf16 {:.3f} / {:.3f} ms'.format(
                  card, bf16_rate, int8_bf16_rates['xla'],
                  int8_bf16_rates['pallas'], device_rates['float32'],
                  device_rates['bfloat16'], bf16_fwd, int8_bf16_fwd['xla'],
                  int8_bf16_fwd['pallas']), flush=True)

        # 13. bf16 card vs CPU
        phase_bf16_card_vs_cpu(detector, config, params)
        if '--profile' in sys.argv[1:]:
            _profile_both(detector, batch, 'bf16')
        del detector
        torch.cuda.empty_cache()

        # 17. test-time augmentation
        phase_tta(device, workdir, float_path, q_path, pairs, batch)

        # 18. the folder run: JPEGs on disk through the loader pool
        start = time.time()
        phase_folder_run(device, workdir, float_path, q_path, card)
        print('folder run: phase 18 took {:.1f} s'.format(
            time.time() - start), flush=True)

        # 19-21. the single-image, tiled and video entry points
        torch.cuda.reset_peak_memory_stats()
        for label, run in (
                ('19', lambda: phase_single_image(device, workdir,
                                                  float_path, card)),
                ('20', lambda: phase_tiled(device, workdir, float_path,
                                           q_path, card)),
                ('21', lambda: phase_video(device, workdir, float_path,
                                           card))):
            start = time.time()
            run()
            print('phase {} took {:.1f} s'.format(label,
                                                  time.time() - start),
                  flush=True)

        # 22. the other detector families
        start = time.time()
        nms_launches, silu_launches = phase_other_families(
            device, workdir, pairs, card)
        record['launches'] += nms_launches
        silu_record['launches'] += silu_launches
        print('phase 22 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 23. the species classifier and the two-stage path
        start = time.time()
        nms_launches, conv_launches, silu_launches = phase_two_stage(
            device, workdir, float_path, card)
        record['launches'] += nms_launches
        conv_record['launches'] += conv_launches
        silu_record['launches'] += silu_launches
        print('phase 23 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 24. the serving daemon
        start = time.time()
        counts = phase_serving(device, workdir, float_path, card)
        record['launches'] += counts[0]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 24 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 25. E7's backward kernel vs plain
        start = time.time()
        backward_record = phase_silu_backward(device)
        print('phase 25 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 26, 27. detector and classifier training
        start = time.time()
        silu_launches, backward_launches = phase_detector_training(
            device, params, card)
        print('phase 26 took {:.1f} s'.format(time.time() - start),
              flush=True)
        start = time.time()
        more = phase_classifier_training(device, workdir, card)
        silu_record['launches'] += silu_launches + more[0]
        backward_record['launches'] = backward_launches + more[1]
        print('phase 27 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 28, 29. the folder workflow and the inference-options comparison
        start = time.time()
        (nms_launches, stem_launches, silu_launches), workflow_path, \
            threshold = phase_workflow(device, workdir, float_path, card)
        record['launches'] += nms_launches
        stem_record['launches'] += stem_launches
        silu_record['launches'] += silu_launches
        print('phase 28 took {:.1f} s'.format(time.time() - start),
              flush=True)
        start = time.time()
        counts = phase_comparison(device, workdir, workflow_path, threshold,
                                  card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 29 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 30. int8 static-scale checkpoints
        start = time.time()
        nms_launches, conv_launches, stem_launches, silu_launches = \
            phase_static_int8(device, workdir, float_path, pairs, batch,
                              chain_programs, card)
        record['launches'] += nms_launches
        conv_record['launches'] += conv_launches
        stem_record['launches'] += stem_launches
        silu_record['launches'] += silu_launches
        print('phase 30 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 31. the weight-validation gate, then the accelerator probe
        start = time.time()
        nms_launches, conv_launches = phase_validate_and_probe(
            device, workdir, float_path, card)
        record['launches'] += nms_launches
        conv_record['launches'] += conv_launches
        print('phase 31 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 32. the classifier's dataset and evaluation
        start = time.time()
        phase_classifier_evaluation(device, workdir, card)
        print('phase 32 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 33. a trace of a replayed bf16 program
        start = time.time()
        phase_trace(device, workdir, float_path, batch, card)
        print('phase 33 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 34. the path kernels as custom operators
        start = time.time()
        phase_custom_ops(device)
        print('phase 34 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 35. the exported artifact
        start = time.time()
        counts = phase_export(device, workdir, float_path, q_path, pairs,
                              card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 35 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 36. the integration harness
        start = time.time()
        phase_integration(workdir, card, '--cli' in sys.argv[1:])
        print('phase 36 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 37. the detection-postprocessing tools on two detectors' results
        start = time.time()
        counts = phase_postprocessing(
            device, workdir, workflow_path,
            os.path.join(workdir, 'md_smoke_classifier.npz'), threshold,
            card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 37 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 38. the classifier-training workflow, from a CCT database
        start = time.time()
        counts = phase_classifier_workflow(device, workdir, workflow_path,
                                           threshold, card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 38 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 39. the data-format converters, from phase 38's database and
        # detections
        start = time.time()
        counts, backward_launches = phase_data_formats(
            device, workdir, workflow_path, threshold, card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        backward_record['launches'] += backward_launches
        print('phase 39 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 40. the Wildlife Insights and SpeciesNet results layer and the
        # WI download workflow, from the card's two-stage results
        start = time.time()
        counts = phase_wildlife_insights(device, workdir, workflow_path,
                                         threshold, card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 40 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 41. the taxonomy tools, the YOLO val runner, change detection,
        # XMP tagging, video rendering and the native host kernels, from
        # sample images downloaded over loopback through the card
        start = time.time()
        counts = phase_host_tools(device, workdir, workflow_path, threshold,
                                  card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        print('phase 41 took {:.1f} s'.format(time.time() - start),
              flush=True)

        # 42. data parallelism on a two-replica mesh, with phase 28's
        # detector and phase 29's int8 chain of it
        start = time.time()
        counts, backward_launches = phase_data_parallel(
            device, workdir, workflow_path,
            os.path.join(workdir, 'md_smoke_workflow_int8.npz'), params,
            batch, card)
        record['launches'] += counts[0]
        conv_record['launches'] += counts[1]
        bottleneck_record['launches'] += counts[2]
        stem_record['launches'] += counts[3]
        silu_record['launches'] += counts[4]
        backward_record['launches'] += backward_launches
        print('phase 42 took {:.1f} s'.format(time.time() - start),
              flush=True)

    # 14. the experiments' kernels vs plain
    exp_records = phase_exp_kernels(device)

    # 15. the experiment entry points
    for label, n in phase_experiments().items():
        exp_records[label]['launches'] = n

    print(card)
    print(json.dumps({'kernels': [record, conv_record, bottleneck_record,
                                  stem_record, silu_record,
                                  backward_record] +
                      [exp_records[label] for label in sorted(EXPERIMENTS)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
