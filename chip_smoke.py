#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths once each at full width, with seeded random
weights: the serving path, the 4-pass robustness sweep (nc=6, bf16, eval
mode, 1024 canvas, 64 synthetic 768x1024 images in batches of 8), once
with YOLOv8m and once with RT-DETR-L, and the training path, ``bench.py``'s
two workloads (YOLOv8m trained at 1024 px, batch 16, and RT-DETR-L at
batch 8 with contrastive denoising; 80 ground-truth boxes per image in 600
slots, the Augmented mode with HSV + flip, bf16 convs with bf16 BatchNorm
outputs and f32 statistics); the decoder's sampling workload through
each generation of the deformable-attention op family; and the Restored
strategy: the 8-pass sweep with the restoration U-Net and the U-Net's
training; and Faster R-CNN, served through both sweeps (f32) and the
aspect-bucket eval at native resolution, and trained at ``bench.py``'s
``bench_frcnn`` configuration (batch 2, 1024 px, the Augmented mode, f32).
Phases:

  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit; exits non-zero without a CUDA card;
  2. build: compiles the kernels of csrc/ with nvcc from this checkout;
     ptxas's registers and spills of every kernel, and the count of
     tensor-core instructions (HMMA / HGMMA), async copies (LDGSTS) and
     f32 FMAs in the SASS of K3's, K2's and K4's bf16 kernels and of K3's
     and K2's split-TF32 f32 kernels (every instantiation); HMMA must be
     above 0 in each, TF32 HMMA in the f32 ones; the global loads of K5
     forward's, the deformable backward's (taps kernel and scatter) and
     K5-g1's kernels, with 128-bit value loads required in K5 forward's
     16-byte instantiations and the backward's bf16 taps kernels that read
     `values`;
  3. kernels: the eval kernels (K3-f, K2-f) against their plain PyTorch
     versions at the sweep's shapes (f32 with TF32 off: max abs err <=
     1e-4 x max|ref|; bf16: <= 1e-2 x max|ref|), with CUDA-event timings
     (median of 10 calls after 3 warm-ups) of both and the profiler's
     device ms of each K2-f sub-kernel (P1, P2; f32: the split-TF32
     kernels and no CUDA-core one); f32 K3-f's device
     ms by kernel (the split-TF32 kernel, no CUDA-core K3 kernel) and
     F.conv2d with cuDNN's TF32 off beside its default (on); K3-f, K3-f as
     dX and K3-b at odd shapes and on a misaligned x, and f32 K3-f on an
     Inf, -Inf or NaN input against float64 (conv3x3_edges); and the
     kernels' refusal of CUDA tensors they do not take;
  4. model check: YOLOv8m f32 logits on the card (kernels, TF32 off)
     against the same weights on the CPU (plain versions) at 128 px;
  5. the sweep: launch counters zeroed just before it and read just after
     (front 1, conv3x3 4 and NMS 1 per forward, x 4 passes x batches),
     finite per-variant mAPs, detections per image, images/sec;
  6. training kernels: K3-b (conv3x3 wgrad) and K3-f as dX, K2-f in train
     mode, K2-b and K1 against their plain versions at the training
     shapes, in f32 with TF32 off and in bf16, timed the same way (with the
     device ms of each K2 sub-kernel, bf16 and f32: P1, P2, finalize;
     stat cotangent, e2 prep, dA1, dk2, dk1, the chunk sums, bn chain;
     f32 K3-b's device ms by kernel and conv2d_weight with cuDNN's TF32
     off; the f32 K3 and K2 calls launch their split-TF32 kernels and no
     CUDA-core one),
     K2-b and the train statistics bit-identical on a second run, and the
     kernels' refusal of bad CUDA inputs (tolerances in
     phase_train_kernels);
  7. train-step model check: one YOLOv8m f32 train step at 128 px, batch
     2, no corruption, on the card (kernels, TF32 off) and on the CPU
     (plain versions) from the same weights and batch: loss within 1e-4
     relative, every parameter's gradient within 1e-3 x max|ref| of its
     leaf;
  8. training: 1 warm-up step, then 5 timed steps with the launch
     counters zeroed just before and read just after (per step: K1 1,
     front train forward 1, front backward 1, conv3x3 8 = 4 forward + 4
     dX, conv3x3 wgrad 4); finite loss and grad norm every step, moved
     BatchNorm running statistics and EMA; step ms (median), images/s and
     peak device memory;
  9. RT-DETR-L kernels: K4-f (the HGNetv2 stem) and K5 forward
     (multi-scale deformable attention) against their plain versions at
     the sweep's shapes and at one odd shape each, f32 with TF32 off and
     bf16 (tolerances in phase_rtdetr_kernels); K5 forward also on
     clustered samples (timed beside the uniform ones), with the queries
     permuted (the same bits), a loc and a values one element past a
     16-byte boundary, and every tap outside its map (an exact 0); timed
     as above, with the
     profiler's device ms of each bf16 K4-f launch (stem1, stem2a, stem2b,
     pool, stem3) and cuDNN's time for each conv stage of the stem beside
     it, and the refusal of bad CUDA inputs (among them five levels of
     eight points, which the kernels do not instantiate: refused before
     any launch, with and without a gradient, by all three entry points);
 10. RT-DETR-L model check: f32 at 128 px on the card (kernels, TF32 off)
     against the same weights on the CPU (plain versions): the same
     selected anchors, last-layer logits and boxes within 2e-3 x max|ref|,
     the same decoded scores;
 11. the RT-DETR-L sweep: as phase 5 with the NMS-free predict step;
     per forward K4-f 1, K5 6 and K3-f 6 launches; images/sec and peak
     memory;
 12. RT-DETR-L training kernels: K4-f in train mode, K4-b (the stem's
     backward), K5 backward and K6 (the auction matcher) against their
     plain versions at the train step's shapes and at one odd shape each,
     f32 with TF32 off and bf16 where the kernel takes it (tolerances in
     phase_rtdetr_train_kernels; K6 by equality), timed as above, with the
     profiler's device ms of each bf16 K4-f train and K4-b launch, and
     cuDNN's time for each stage of the stem's backward beside K4-b; and the
     kernels this step shares with earlier paths at its own shapes (K5
     forward at 428 queries, K3-b, K3-f as dX and K1 at batch 8, f32 K3-b
     timed there with conv2d_weight, cuDNN's TF32 on and off); K5
     backward also on clustered samples, twice for identical bits and bit
     for bit K5-g2's d(values) on the same inputs, with the profiler's
     device ms of its two launches (taps kernel, owner scatter); K6 also
     on ties (costs on a 1/64 grid), an image whose GTs are all padded, a
     column marked invalid but priced below BIG / 2, GTs that all rank the
     queries alike and more GT rows than
     shared memory holds (M 420), each by equality with and without the
     greedy completion, with each image's auction and greedy rounds, and
     the profiler's device ms on the train and the capped shape; K1 branch
     by branch at batch 16 (all clean, all noise, all blur, all lowres),
     events, device ms and the bound;
 13. RT-DETR-L train-step model check: forward, loss and backward of one
     f32 batch at 128 px on the card (kernels, TF32 off) and on the CPU
     (plain versions), same weights, batch and denoising queries; every
     assignment the card's matcher made is solved again by the plain
     version on the CPU from the same cost tensor and must be equal;
 14. RT-DETR-L training: 1 warm-up step, then 5 timed steps with the
     launch counters zeroed just before and read just after (per step: K1
     1, K4-f train 1, K4-b 1, K3-f 12 = 6 forward + 6 dX, K3-b 6, K5
     forward 6, K5 backward 6, K6 7); finite loss and grad norm, moved
     running statistics and EMA; step ms, images/s, peak memory; the
     steps' matcher_capped (which regime K6 ran in);
 15. the earlier generations' kernels: K5-g2 forward and backward (the
     sorted-tap deformable attention, both layouts of the value maps) and
     K5-g1 (``stamp_scatter``, and ``bilinear_sample``'s three gradients
     through it) against their plain versions at the RT-DETR-L decoder's
     shapes (300 and 428 queries; each of the three levels for K5-g1, on
     uniform and on clustered cells) and at one odd shape, f32 and bf16
     values (tolerances in phase_sorted_kernels), K5-g2 both ways also on
     clustered samples; K5-g2 forward equal to K5 forward bit for bit (f32;
     after one rounding in bf16), values_t to values, and under a query
     permutation; every backward twice for identical bits, K5-g1 also
     from gw in the row layout and from int64 idx; timed as above, K5-g2
     forward also by the profiler's device ms of each launch (values_t:
     the relayout, then the gather) with the peak memory a call adds, its
     values_t bound from distinct 32-byte sectors, and ``grid_sample``
     level by level on values_t's layout, forward only, beside it; K5-g1
     in both gw layouts beside the one library call (``scatter_add_`` into
     zeros) and, for the record, ``grid_sample`` forward + backward beside
     ``bilinear_sample``; the refusal of bad CUDA inputs;
 16. the generations' path: six forward + backward calls (one per decoder
     layer, 428 queries, values (8, 21504, 8, 32), bf16 then f32) of
     ``ms_deform_attn``, of ``ms_deform_attn_t`` and of the per-level
     composition over ``bilinear_sample``, launch counters zeroed just
     before and read just after (K5-g2 forward 12, K5-g2 backward 12,
     K5-g1 18 per dtype), each output and gradient held against
     ``ms_deform_attn_slots`` (K5) on the same inputs; ms per call;
 17. the U-Net model check: the f32 restoration U-Net (32, 64, 128, 256),
     seeded weights with redrawn running statistics and biases, on the
     card (cuDNN, TF32 off) against the CPU at 1x256x256 and through
     ``restore_image`` at an odd 250x333 (max abs err <= 1e-4); its u8
     apply card vs CPU (at most 1 LSB, the count that differ printed);
     SSIM and PSNR on the card with TF32 switched on against float64 on
     the CPU, on an image near 0.9 with small noise (SSIM within 1e-6),
     beside the same SSIM through an f32 cuDNN window in TF32;
 18. the 8-pass sweep (``bench.py``'s ``bench_sweep`` path): phase 5's 64
     images with the f32 U-Net restoring the three corrupted variants, launch
     counters zeroed just before and read just after (front 1, conv3x3 4 and
     NMS 1 per forward, x 8 passes x batches), finite mAPs of both
     strategies, images/s and peak memory; for one batch the restored passes
     equal the U-Net's u8 apply run alone and then detected, the restored
     Clean pass the corrupted one; the U-Net's ms for a batch of 8 at
     768x1024 by CUDA events with the process's flags and with TF32 off,
     beside its FLOP bound (2 x 122,560 MACs a pixel over 67 TFLOP/s f32 and
     494 TFLOP/s TF32);
 19. U-Net training at ``RestorationConfig``'s defaults (patch 256, batch
     8): 1 warm-up + 5 timed steps, finite loss / psnr / grad_norm, moved
     running statistics, step ms, patches/s, peak memory, the loss's own
     forward + backward ms; one step at batch 2, patch 64 on the card
     (TF32 off) and on the CPU from the same weights and draws: in float64
     loss within 1e-9 relative, every gradient within 1e-6 x max|ref| and
     the running statistics after the step within 1e-9 x max|ref| (1e-5 in
     f32); in f32 loss within 1e-4 relative and every card gradient within
     max(1e-4, 10 x its own f32 noise) x max|ref| of the float64 one
     (tolerances in phase_unet_training); and at the phase's own shape
     (patch 256, batch 8) with cuDNN on, one f32 step with TF32 off and
     one with TF32 on against the card's float64 step: the median leaf
     gradient error of the f32 step at most UNET_F32_BAR, TF32's above it;
 20. Faster R-CNN ResNet-50-FPN-v2 f32 at full width (blocks (3, 4, 6, 3),
     256-channel FPN, 512 proposals, 7 classes, every BN and bias drawn
     from the seed) on the card with TF32 off against the CPU, batch 2 at
     256x256 and 256x384: the pyramid, the RPN maps and the box head on the
     CPU's proposals within 1e-4 x max|ref|, then the detections matched by
     box; on the card against the torchvision-layout replica of
     tests/_torch_frcnn.py (pyramid, RPN maps, box head) and RoIAlign
     against a float64 RoI-by-RoI version (tolerances in
     phase_frcnn_model_check);
 21. the 4-pass sweep with Faster R-CNN (f32 under the process's flags,
     phase 5's 64 images, 1024 canvas, batch 8): NMS 2 per forward
     (proposals, detections) and no other hand kernel launched (every
     counter zeroed just before, read just after), image-passes/s,
     peak memory, the event ms a batch of backbone + FPN, RPN head,
     proposals, RoIAlign, box head and final NMS beside the FLOP bound of
     the convs and linears (counted by hooks), RoIAlign's peak memory, the
     idle share of one profiled batch; then the 8-pass sweep with the
     U-Net over 16 images;
 22. the aspect-bucket eval at native resolution: ``evaluate_bucketed``
     through ``BucketedPredict`` over 16 in-memory 750x1333 images (the
     VisDrone bucket 768x1344), batch 1: one bucket of 16, finite mAPs, ms
     an image;
 23. Faster R-CNN train-step check: one step of the full-width model at
     batch 2, 256 px, augment off, from phase 20's weights and one set of
     draws (``train/frcnn.draw_train`` on the CPU, moved), the proposals of
     the card's f32 step replayed by every other run: at trainable_layers
     5 and 3, TF32 off, the card's f32 step against the card's float64
     step (losses, grad_norm, nine named gradient leaves, every running
     statistic, each error printed beside its bar; at 3 the frozen
     parameters bit-identical and their running statistics moved), the
     card's f32 step against the CPU's printed only, and the card's float64
     step against the CPU's (tolerances in
     phase_frcnn_train_model_check);
 24. Faster R-CNN training at ``bench.py``'s ``bench_frcnn`` configuration
     (batch 2, 1024 px, 80 GT boxes an image in 600 slots, augment, f32
     under the process's flags): K1 at this shape against its plain
     version (all four branches), then 1 warm-up + 5 timed steps with the
     launch counters zeroed just before and read just after (K1 1 and
     NMS 1 a step, every other hand kernel 0); finite metrics; step ms,
     images/s, peak
     memory; the CUDA-event ms of each stage (K1, backbone + FPN + RPN
     forward, RPN targets + loss, proposals, RoI targets, RoIAlign + box
     head forward, head loss, backward, SGD); the FLOP bound of the convs
     and linears beside the step; the idle share of one profiled step; the
     peak memory RoIAlign + the box head's forward and backward add;
 25. the YOLOv8m trainer: ``train.detector.train`` at full width (nc 6,
     1024 px, batch 16, bf16, augment + HSV/flip) on an in-memory COCO
     split (32 train, 16 val images, ``load_image=``): 2 epochs (mosaic +
     affine, then plain), validation each epoch, a checkpoint each step;
     the launch counts of every step (K1 1, K2-f train 1, K2-b 1, K3-f 8,
     K3-b 4) and of the run (each validation forward K2-f eval 1, K3-f 4),
     counters zeroed just before the run; history, best and last; the EMA
     check (the validation's EMA predict step gives exactly the detections
     of ``load_checkpoint``'s EMA module, and not those of the raw
     weights); a second call with 3 epochs resumes at epoch 3 (its idle
     share under the profiler); step ms, images/s, peak memory, and the
     host ms of one batch of mosaic + affine;
 26. the RT-DETR-L trainer: ``train.rtdetr.train`` at full width (1024 px,
     batch 8, bf16, augment + HSV/flip + CDN) on 16 train and 8 val
     in-memory images: 2 epochs with the auction (per step K1 1, K4-f
     train 1, K4-b 1, K3-f 12, K3-b 6, K5 6 + 6, K6 7; per validation
     forward K4-f eval 1, K3-f 6, K5 6), then a call with 3 epochs that
     resumes at epoch 3 (``last`` keyed by epoch) with ASSIGNMENT
     "greedy" (K6 0); matcher_capped in the history; the greedy matcher's
     pairs on the epoch's first cost against an independent numpy greedy;
     ``load_checkpoint`` against the EMA predict step; step ms, images/s;
 27. the command-line pipeline, through ``cli.main`` in this process with
     PIL and cv2 made unimportable, on a BMP split from
     ``data/synthetic.make_det_split`` (32 train and 16 val images of
     540-800 x 960-1400 px, so the letterbox resizes both up and down):
     ``data/imageio`` against golden SHA-256s of PIL's BMP bytes and of
     ``cv2.resize(INTER_LINEAR)`` outputs, and the host ms of a BMP
     decode and of ``resize_linear_u8`` at 765x1360 -> 576x1024; then
     ``convert-det-coco`` / ``convert-det-yolo``, ``validate`` of each
     kind (once also as ``python -m ...cli`` in a subprocess),
     ``build-testsets`` on the card held against the same build on the
     CPU (Clean and Noise byte-equal, Blur and LowRes within 1 LSB),
     ``train-restoration`` (5 steps at ``RestorationConfig``'s defaults),
     ``restore-testsets``, ``train-detector`` at full width with 2 steps
     and one validation each (YOLOv8m batch 16 Baseline and Augmented,
     RT-DETR-L batch 8, Faster R-CNN batch 2 in bf16, the card's default,
     both Augmented), ``eval``,
     ``eval-restored`` and ``eval-vid`` over the testsets, ``eval-fused``
     with the U-Net for YOLOv8m and RT-DETR-L with and without
     ``--mt19937-parity coco6`` (16 more images at 766x1360: the fused
     sweep takes even native sizes); every command with the launch
     counters zeroed just before and read just after, each step and each
     forward launching what phases 24-26 count (Baseline: K1 0) and
     together every launch of the command; the files each eval reads
     (``eval-restored``: only the ``_restored`` layout); finite mAPs in
     every results JSON; the CLI's YOLOv8m detections identical forward
     by forward to ``evaluate_testsets`` on ``load_checkpoint``'s EMA
     module (and not all equal to the raw weights'); seconds a command
     and ms an image of each disk eval;
 28. Faster R-CNN in bf16 at ``bench_frcnn``'s bf16 configuration (batch 2,
     1024 px, augment, ``FrcnnConfig()``; bench.py:233-257): K1 at batch 2
     against its plain version; a dtype audit of one forward (every conv
     and fc6 in bf16, every BatchNorm output f32, the RPN's 1x1s and the
     box predictor in f32, as flax promotes them); phase 24's
     measurements (step ms, images/s, peak memory, stage events, idle
     share) for the bf16 model; the bf16 step against the card's f32 step
     on one batch at 256 px with the f32 step's proposals replayed
     (FRCNN_BF16_BARS, from the CPU tests' measured spread of the
     reference's own bf16 step against its f32 step); one
     ``train(dtype="bfloat16")`` with a validation on a BMP split, its
     checkpoint loaded back as f32;
 29. parallel/mesh.py on the card: a world-1 NCCL group through the
     data-parallel path (every collective, K2's and K4's statistics
     callbacks included) of a YOLOv8m and an RT-DETR-L step (bf16, full
     width, 512 px, 2 steps) against the step without a group, within
     twice the spread of two runs without one (PAR_WORLD1_FLOOR), launch
     counters zeroed just before and read just after; then two processes
     on the one card over gloo: a data-parallel YOLOv8m step and an
     RT-DETR-L step with ``mesh.model=2`` against the one-process step on
     the same global batch, in f32 (TF32 off) and in bf16 (PAR_BARS, the
     bf16 YOLOv8m weights included; the statistics K2 / K4 take through
     the data-parallel callback apart; matcher_capped by its absolute
     difference a step, PAR_COUNTS); YOLOv8m in bf16 also with the one
     process's TAL assignment replayed and with K2's plain version (TAL
     anchors that differ from the one process's counted), and beside it
     the one process with its batch rows reversed and bf16 against f32;
     the two RT-DETR-L model ranks' replicated leaves, gradients, EMA,
     AdamW moments, buffers, 7 matchings and metrics bit-equal after every
     step (PAR_TP_PARTS; a third run in which model index 1 perturbs a
     gradient and its matchings), the step's ms with and without the
     model-group broadcasts; every run printed before a failure; a gloo
     that refuses CUDA tensors is printed and the two-process part
     skipped;
 30. the host codec and the JPEG pipeline, with PIL and cv2 made
     unimportable: the fixtures of tests/fixtures/jpeg (baseline, grey,
     progressive, optimised, restart intervals, Adobe RGB) decode to the
     SHA-256s of Pillow's pixels in their manifest; the encoder's bytes for
     ``codec_image`` at 1x1, 17x300, 765x1360 and 1080x1920 and q 75, 92,
     95 equal Pillow's (JPEG_GOLDEN), and decode to Pillow's pixels; host
     ms an image of the decode and the encode at 765x1360 and 1080x1920 on
     one thread and on 8, beside phase 27's BMP decode and resize; then a
     JPEG DET split (``make_det_split``'s default ``jpg``, 16 val images
     of 540-800 x 960-1400) and a VID split (2 sequences of 4 frames at
     756x1344) through the CLI: ``convert-det-coco`` / ``-yolo``,
     ``convert-vid-yolo``, ``build-testsets`` on the card held against the
     CPU's build, ``restore-testsets`` (q 95 writes), one YOLOv8m step on
     the VID frames (``--data-layout yolo``) with its validation, ``eval``
     and ``eval-vid`` with YOLOv8m at batch 8 (phase 27's U-Net and
     checkpoint where this process holds them, else one step each), launch
     counters and finite mAPs as phase 27 checks them;
 31. the trainers' corruption route (``ops/corrupt.random_corruption_fast``)
     on f32 (16, 1024, 1024, 3), 4 images a branch: at angle 0 it launches
     K1 once and equals a direct K1 call bit for bit; at 45 and 90 degrees
     (k 9) it launches no K1, its blur and lowres images equal the CPU's
     route bit for bit and its noise images within ROUTE_NOISE_BAR, and its
     noise images equal K1's for the same seeds bit for bit; event ms of
     each route beside K1; one YOLOv8m Augmented step (batch 16, 1024 px,
     bf16, prob 1.0, angle 45): finite loss, K1 0 launches, K2 and K3 as
     at angle 0;
 32. the worker-process loader (``data/worker_pipeline``) on a JPEG DET
     split of 36 images at phase 30's sizes, batch 16, 1024 px, with 0 and
     8 spawned workers beside ``pipeline.make_batches`` (threads): the
     valid rows equal field by field (shuffled too, at 0 workers); the short
     last batch padded by its last record with image_id -1; numpy uint8;
     the parent's CUDA context intact; ms a batch each way.
 33. greedy NMS (``csrc/nms.cu``, ``ops/nms._greedy_walk``) against the
     eager loop (``_greedy_loop``) on the card, at the 8-pass sweep's
     shape (32 x 30,000 candidates, 6 classes, 300 outputs, IoU 0.7; also
     a long walk through few objects) and at Faster R-CNN's (proposals:
     8 x 4,096 over 5 levels, 512 outputs, IoU 0.7, and the train step's
     batch 2; detections: 8 x 2,048, 100 outputs, IoU 0.5), on scores
     with exact ties and on IoUs an ulp around the threshold
     (``tests/_torch_nms_cases.py``): the same positions and scores slot
     for slot, one launch a call, each image's walk length from ``stats``
     against the loop's picks, kept and suppressed second boxes in the ulp
     case; the walk's CUDA-event and device ms beside the loop's, and
     ``multilabel_nms`` (top-k included) both ways at the sweep's decode
     shape (32 x 21,504 anchors x 6 classes). The NMS launches of the
     sweeps and the Faster R-CNN train steps are counted in phases 5, 18,
     21, 24 and 28.

Every kernel's line in the summary also carries ``bound_ms``, the least
time the card could take for the same work: the larger of the bytes the
function must move (inputs once, outputs once; for the gather of K5 the
distinct rows this run's taps touch) over 3.35 TB/s and its operations
over the card's peak for the type (989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32; a row's ``float32`` key for K3, whose f32 route is
split TF32, counts its three TF32 MMAs a product at 495 TFLOP/s and gives
the f32 FFMA bound beside it as ``ffma_bound_ms``), and ``library_ms``,
the time of the one PyTorch call
that computes the same function where there is one (a cuDNN convolution
or its filter gradient; ``scatter_add_`` for K5-g1), timed here and used
nowhere in the port.

Any failed check raises, so the script exits non-zero and prints no
result. The line before the last is the kernel summary
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
IMG_SIZE = 1024
BATCH = 8
N_IMAGES = 64
NATIVE_HW = (768, 1024)
SEED = 0
TRAIN_BATCH = 16       # bench.py's train workload
MAX_BOXES = 600
GT_PER_IMAGE = 80
TRAIN_STEPS = 5
RTDETR_TRAIN_BATCH = 8  # bench.py's RT-DETR workload

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def run_cmd(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (res.stdout or res.stderr).strip()


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(fn, calls: int = 10):
    """[(device ms a call, launches a call, kernel name)] of `fn` under
    torch.profiler, after one warm-up call; largest first. A kernel's ms a
    call is its mean device ms a launch times its launches a call, so that
    records the profiler drops (seen when several sessions run in one
    process) lower neither. A session that records no device time at all
    (seen once in a whole smoke run) is taken again, up to 3 times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_time_total > 0
                    and e.device_type == torch.autograd.DeviceType.CUDA):
                n = max(1, round(e.count / calls))
                rows.append((e.device_time_total / 1e3 / e.count * n, n,
                             e.key))
        if rows:
            break
    return sorted(rows, reverse=True)


def device_ms_by_launch(fn, calls: int = 10):
    """[(device ms, kernel name)] of `fn`'s launches in launch order, each
    the mean over `calls` profiled calls after one warm-up, so that two
    launches of one kernel (stem1 and stem3 of the CUDA-core stem) stay
    apart. None when the profiler's record does not split into `calls`
    equal sequences (it may drop records in a process that ran several
    sessions)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda e: e.time_range.start)
    n = len(ev) // calls
    seqs = [ev[i * n:(i + 1) * n] for i in range(calls)]
    if not ev or len(ev) % calls or any(
            [e.name for e in s] != [e.name for e in seqs[0]] for s in seqs):
        return None
    return [(sum(s[i].time_range.elapsed_us() for s in seqs) / calls / 1e3,
             seqs[0][i].name) for i in range(n)]


def launch_parts(fn, tries: int = 3):
    """[(device ms, kernel name)] of `fn`'s launches in launch order, or by
    kernel where the profiler's record does not split into calls; [] when
    no try recorded any device time (the profiler drops records in a
    process that ran many sessions)."""
    for _ in range(tries):
        parts = device_ms_by_launch(fn) or [
            (d, k) for d, _, k in device_ms_by_kernel(fn)]
        if parts:
            return parts
    return []


def short_kernel_name(name: str) -> str:
    """A kernel's name without its namespaces and argument list."""
    for ns in ("(anonymous namespace)::", "rodt::stc::", "rodt::ftc::",
               "rodt::tc::", "rodt::", "at::native::", "void "):
        name = name.replace(ns, "")
    return name.split("(")[0].strip()


def stem_parts(fn, tag, what):
    """Prints the device ms of each launch of `fn` (a K4 call) in launch
    order, by the profiler; returns [(ms, short name)] (None when the
    record did not split into calls, then the sums by kernel name are
    printed instead)."""
    seq = device_ms_by_launch(fn)
    if seq is None:
        rows = device_ms_by_kernel(fn)
        print(f"[{tag}] {what} device ms by kernel (launch order lost): "
              + "; ".join(f"{short_kernel_name(k)} x{n} {ms}"
                          for ms, n, k in rows))
        return None
    seq = [(ms, short_kernel_name(k)) for ms, k in seq]
    print(f"[{tag}] {what} device ms by launch: " + "; ".join(
        f"{i} {k} {ms}" for i, (ms, k) in enumerate(seq))
        + f"; sum {sum(ms for ms, _ in seq)}")
    return seq


# K2's bf16 sub-kernels (csrc/front_tc.cuh and the shared reductions), by
# a substring of their names
FRONT_PARTS = (("P1", "front_p1_kernel"), ("P2", "front_p2_kernel"),
               ("P1", "front_p1_tf32_kernel"), ("P2", "front_p2_tf32_kernel"),
               ("finalize", "finalize_partials_kernel"),
               ("stat cotangent", "stat_cotangent_kernel"),
               ("e2 prep", "e2_prep_kernel"), ("e2 prep", "e2_prep_f32_kernel"),
               ("dA1", "front_da1_tc_kernel"),
               ("dA1", "front_da1_tf32_kernel"),
               ("dk2", "front_dk2_tc_kernel"), ("dk1", "front_dk1_tc_kernel"),
               ("dk2", "front_dk2_tf32_kernel"),
               ("dk1", "front_dk1_tf32_kernel"),
               ("sums", "sum_chunks_tc_kernel"),
               ("bn chain", "bn_chain_kernel"))


def front_parts(fn, tag, what):
    """Prints the device ms a call of each K2 sub-kernel that `fn`
    launches (profiler); returns {part: ms}."""
    parts = {}
    for ms, n, key in device_ms_by_kernel(fn):
        for part, sub in FRONT_PARTS:
            if sub in key:
                parts[part] = parts.get(part, 0.0) + ms
    print(f"[{tag}] {what} device ms by sub-kernel: " + ", ".join(
        f"{k} {v}" for k, v in parts.items()) + f"; sum {sum(parts.values())}")
    return parts


def work(dtype: str, nbytes: float, flops: float, library_ms=None) -> dict:
    """The bound's inputs for one kernel run: the bytes it must move, its
    operations, the type whose peak applies; and the library call's ms."""
    return dict(bytes=nbytes, flops=flops, peak=PEAK_FLOPS[dtype],
                library_ms=library_ms)


def bound(w: dict):
    """(bound_ms, bound_by) of a :func:`work` record."""
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["flops"] / w["peak"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def f32_route_numbers(r: dict, tf32x3: bool) -> dict:
    """The summary's numbers of a kernel's f32 route: events and (where
    taken) device ms, error, plain and library ms, and its bounds. The
    bound is the larger of the byte bound and the operations bound at the
    rate of the units the route computes f32 on: the f32 FFMA peak
    (67 TFLOP/s) for a CUDA-core route; for a split-TF32 route the three
    TF32 MMAs it runs for every f32 product (3 x its operations at
    495 TFLOP/s), the tighter bound the card reaches at f32 accuracy, with
    the FFMA bound beside it."""
    ffma_ms = r["flops"] / PEAK_FLOPS["float32"] * 1e3
    if tf32x3:
        r = dict(r, flops=3 * r["flops"], peak=PEAK_TF32)
    bound_ms, bound_by = bound(r)
    out = dict(ms=r["ms"], max_abs_err=r["max_abs_err"],
               plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
               bytes_bound_ms=r["bytes"] / HBM_BYTES_PER_S * 1e3,
               ffma_bound_ms=ffma_ms, library_ms=r["library_ms"])
    for key in ("device_ms", "library_tf32_off_ms", "parts", "launch_ms",
                "library_stages_ms", "library_stages_tf32_off_ms"):
        if key in r:
            out[key] = r[key]
    return out


def esize(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def max_err(out, ref):
    """(max abs error, max |ref|) of out against the f32 reference."""
    return ((out.float() - ref).abs().max().item(),
            ref.abs().max().item())


def require_refused(tag, bad, counters) -> None:
    """Every call of `bad` raises ValueError and launches no kernel."""
    before = [f.launches for f in counters]
    refused = 0
    for fn in bad:
        try:
            fn()
        except ValueError:
            refused += 1
    require(refused == len(bad), f"only {refused}/{len(bad)} bad CUDA "
            f"inputs were refused")
    require([f.launches for f in counters] == before,
            "a refused call launched a kernel")
    print(f"[{tag}] bad CUDA inputs refused: {refused}/{len(bad)}")


# K3's odd shapes (B, H, W, Cin, Cout): channel counts of 3, 5 and 8, 24 and
# 40 (multiples of 8, not of 16), 56 output channels (two output-channel
# slices), W = 17 and H = 1 (ragged tiles), B = 1
CONV3X3_EDGES = ((2, 37, 45, 5, 20), (3, 16, 16, 8, 16), (1, 9, 30, 3, 17),
                 (2, 37, 45, 24, 56), (1, 1, 17, 40, 20),
                 (2, 19, 17, 56, 24))


def misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary (so K3's
    bf16 kernels must stage element by element)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    require(out.is_contiguous() and out.data_ptr() % 16 != 0,
            "misaligned copy is aligned")
    return out


def conv3x3_edges(C, g, dev, tag):
    """K3-f forward, K3-f as dX and K3-b on CONV3X3_EDGES and on a
    misaligned x, f32 (TF32 off) and bf16 against the plain versions in f32
    on the same values: K3-f 1e-4 / 1e-2 x max|ref|, K3-b K3B_TOL x max|ref|
    (1.5e-4 / 1e-3), K3-b bit-identical on a second run."""
    import torch
    from robust_object_detection_tpu_torch import kernels
    cases = [(s, False) for s in CONV3X3_EDGES] + [((2, 37, 45, 48, 48),
                                                    True)]
    n = 0
    for (b, h, w, cin, cout), shifted in cases:
        x = torch.randn(b, h, w, cin, device=dev, generator=g)
        dy = torch.randn(b, h, w, cout, device=dev, generator=g)
        k = torch.randn(3, 3, cin, cout, device=dev, generator=g) * 0.1
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            xd, dyd, kd = x.to(dtype), dy.to(dtype), k.to(dtype)
            if shifted:
                xd, dyd = misaligned(xd), misaligned(dyd)
                sm, name = kernels.sm_count(dev), str(dtype).split(".")[-1]
                plans = (kernels.conv3x3_tc_plan(
                    name, b, h, w, cin, cout, (xd.data_ptr(), kd.data_ptr()),
                    sm), kernels.wgrad_tc_plan(
                    name, b, h, w, cin, cout,
                    (xd.data_ptr(), dyd.data_ptr()), sm))
                require(all(p["vec"] == 0 for p in plans),
                        "a misaligned x took 16-byte staging")
            log = []
            with torch.backends.cudnn.flags(allow_tf32=False):
                check(f"conv3x3 {dtype} {(b, h, w, cin, cout)}",
                      C.conv3x3(xd, kd),
                      C.conv3x3_reference(xd.float(), kd.float()), tol, log)
            check_conv3x3_backward(C, xd, dyd, kd, log)
            n += 1
    print(f"[{tag}] conv3x3 forward, dX and wgrad on {len(cases)} odd "
          f"shapes (one with a misaligned x and dy), f32 and bf16: {n} "
          f"cases passed")
    # f32 with one non-finite input value, a random filter beside one of
    # TF32 values (lo = 0): Inf, -Inf and NaN outputs exactly where the
    # float64 conv has them (the split's guard; without it Inf - Inf in lo
    # turns an Inf's outputs into NaN)
    x = torch.randn(1, 9, 17, 8, device=dev, generator=g)
    k = torch.randn(3, 3, 8, 16, device=dev, generator=g) * 0.1
    k = torch.cat([k, (k.view(torch.int32) & -8192).view(torch.float32)],
                  -1).contiguous()
    for bad in (math.inf, -math.inf, math.nan):
        xb = x.clone()
        xb[0, 4, 5, 3] = bad
        out = C.conv3x3(xb, k)
        ref = C.conv3x3_reference(xb.double(), k.double())
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            require(torch.equal(test(out), test(ref)),
                    f"conv3x3 float32 with an input {bad}: {test.__name__} "
                    f"at {int(test(out).sum())} outputs, the float64 conv "
                    f"at {int(test(ref).sum())}")
    print(f"[{tag}] conv3x3 float32 with an Inf, -Inf or NaN input: "
          f"non-finite outputs where the float64 conv has them")


# The f32 routes of K3, K2 and K4: the split-TF32 kernels of
# csrc/conv3x3_tf32.cuh, csrc/front_tf32.cuh and csrc/stem_tf32.cuh; the
# CUDA-core kernels they ran before (since removed from the sources: a
# launch of one would come from a stale build)
F32_OLD = ("conv3x3_tile_kernel", "wgrad_partial_kernel", "front_da1_kernel",
           "conv2x2_relu_kernel", "pool2x2_kernel", "assemble_train_kernel",
           "stem3_dx_kernel", "assemble_bwd_kernel", "conv2x2_dx_kernel")
K2F_TF32 = ("front_p1_tf32_kernel", "front_p2_tf32_kernel")
K2B_TF32 = ("e2_prep_f32_kernel", "front_da1_tf32_kernel",
            "front_dk2_tf32_kernel", "front_dk1_tf32_kernel")
# K4-f (eval: the pool, train: the pool + concat between stem2b and stem3)
# and K4-b
K4F_TF32 = ("front_p1_tf32_kernel", "stem2x2_tf32_kernel",
            "front_p2_tf32_kernel")
K4F_EVAL_TF32 = K4F_TF32 + ("pool2x2_f32_kernel",)
K4F_TRAIN_TF32 = K4F_TF32 + ("assemble_train_f32_kernel",)
K4B_TF32 = ("e2_prep_f32_kernel", "front_da1_tf32_kernel",
            "front_dk2_tf32_kernel", "assemble_bwd_f32_kernel",
            "stem2x2_wgrad_tf32_kernel", "stem2x2_dx_tf32_kernel",
            "front_dk1_tf32_kernel")


def f32_route(tag, what, fn, kernels, library=None):
    """The f32 call `fn` under the profiler: each of `kernels` launched,
    none of the old CUDA-core kernels (F32_OLD); the device ms of
    `kernels`, and of K2's sub-kernels by FRONT_PARTS where it launched
    any; with `library`, that call's events ms with cuDNN's TF32 off
    (PyTorch's default, on, is timed beside the kernel as library_ms)."""
    import torch
    rows = device_ms_by_kernel(fn)
    names = [short_kernel_name(k) for _, _, k in rows]
    for kernel in kernels:
        require(any(kernel in n for n in names),
                f"{what}: no {kernel} launch under the profiler ({names})")
    require(not any(o in n for n in names for o in F32_OLD),
            f"{what}: a CUDA-core kernel was launched ({names})")
    out = dict(device_ms=sum(ms for ms, _, k in rows
                             if any(n in k for n in kernels)))
    parts = {}
    for ms, _, key in rows:
        for part, sub in FRONT_PARTS:
            if sub in key:
                parts[part] = parts.get(part, 0.0) + ms
    if any("front_" in k for k in kernels):
        out["parts"] = parts
    if any("stem2x2" in k for k in kernels):
        # K4: each launch's device ms in launch order
        seq = device_ms_by_launch(fn)
        if seq is not None:
            out["launch_ms"] = [(short_kernel_name(k), ms) for ms, k in seq]
    note = ""
    if library is not None:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out["library_tf32_off_ms"] = time_ms(library)
        note = (f"; library with cuDNN's TF32 off "
                f"{out['library_tf32_off_ms']} ms")
    print(f"[{tag}] {what}: device ms by kernel "
          + "; ".join(f"{short_kernel_name(k)} x{n} {ms}"
                      for ms, n, k in rows) + note)
    return out


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    g = torch.Generator(dev).manual_seed(SEED)
    results = {}

    # K3-f: C2f_0 bottleneck conv, (8, 256, 256, 48) x (3, 3, 48, 48)
    x = torch.randn(BATCH, 256, 256, 48, device=dev, generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    conv = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        xd, kd = x.to(dtype), k.to(dtype)
        out = C.conv3x3(xd, kd)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = C.conv3x3_reference(xd.float(), kd.float())
        err, scale = max_err(out, ref)
        ms = time_ms(lambda: C.conv3x3(xd, kd))
        plain_ms = time_ms(lambda: C.conv3x3_reference(xd, kd))
        xv, kv = xd.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1)
        lib_ms = time_ms(lambda: F.conv2d(xv, kv, padding=1))
        name = str(dtype).split(".")[-1]
        print(f"[kernels] conv3x3 {name} (8,256,256,48)->48: max_abs_err "
              f"{err} (max|ref| {scale}, tol {tol * scale}) kernel {ms} ms "
              f"plain {plain_ms} ms (cuDNN, default flags, with its layout "
              f"copies) library {lib_ms} ms (F.conv2d alone)")
        require(math.isfinite(err) and err <= tol * scale,
                f"conv3x3 {name} error {err} > {tol} x {scale}")
        conv[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          **work(name, (x.numel() * 2 + k.numel())
                                 * esize(dtype),
                                 2 * k.numel() * x.numel() // 48, lib_ms))
        if dtype == torch.float32:
            conv[name].update(f32_route(
                "kernels", "conv3x3 float32 (8,256,256,48)->48",
                lambda: C.conv3x3(xd, kd), ("conv3x3_tf32_kernel",),
                lambda: F.conv2d(xv, kv, padding=1)))
    results["conv3x3"] = conv
    conv3x3_edges(C, g, dev, "kernels")

    # K2-f: front, (8, 1024, 1024, 3) -> 48 -> 96
    xf = torch.rand(BATCH, IMG_SIZE, IMG_SIZE, 3, device=dev, generator=g)
    k1 = torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2
    k2 = torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1
    sc1 = torch.rand(48, device=dev, generator=g) + 0.5
    bi1 = torch.randn(48, device=dev, generator=g) * 0.1
    means = (torch.randn(48, device=dev, generator=g) * 0.1,
             torch.zeros(96, device=dev))
    variances = (torch.rand(48, device=dev, generator=g) + 0.5,
                 torch.ones(96, device=dev))
    front = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        xd, k1d, k2d = xf.to(dtype), k1.to(dtype), k2.to(dtype)
        args = (xd, k1d, sc1, bi1, k2d, means, variances)
        out = TF.front_inference(*args)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = TF.front_inference_reference(
                xd.float(), k1d.float(), sc1, bi1, k2d.float(), means,
                variances)
        err, scale = max_err(out, ref)
        ms = time_ms(lambda: TF.front_inference(*args))
        plain_ms = time_ms(lambda: TF.front_inference_reference(*args))
        name = str(dtype).split(".")[-1]
        print(f"[kernels] yolo_front {name} (8,1024,1024,3)->48->96: "
              f"max_abs_err {err} (max|ref| {scale}, tol {tol * scale}) "
              f"kernel {ms} ms plain {plain_ms} ms (cuDNN, default flags)")
        require(math.isfinite(err) and err <= tol * scale,
                f"yolo_front {name} error {err} > {tol} x {scale}")
        front[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           **front_work(name, BATCH, esize(dtype)))
        if dtype == torch.bfloat16:
            front[name]["parts"] = front_parts(
                lambda: TF.front_inference(*args), "kernels",
                "yolo_front bfloat16 (8,1024,1024,3)")
        else:
            front[name].update(f32_route(
                "kernels", "yolo_front float32 (8,1024,1024,3)",
                lambda: TF.front_inference(*args), K2F_TF32))
    results["yolo_front"] = front

    # the kernels refuse CUDA tensors they do not take, and launch nothing
    require_refused("kernels", (
        lambda: C.conv3x3(x[:, :, ::2], k),
        lambda: C.conv3x3(x.half(), k.half()),
        lambda: TF.front_inference(xf[:, :1023], k1, sc1, bi1, k2, means,
                                   variances)),
        (C.conv3x3, TF.front_inference))
    torch.cuda.synchronize()
    return results


def front_work(dtype: str, batch: int, elt: int, backward: bool = False):
    """The YOLO front at (batch, 1024, 1024, 3) -> 48 -> 96. Forward: reads
    x, writes y2 (y1 / a1 stays inside). Backward: reads x, y1, y2 and dy2;
    dX of P2, then the two filter gradients. No one PyTorch call computes
    either."""
    px1 = batch * (IMG_SIZE // 2) ** 2
    px2 = batch * (IMG_SIZE // 4) ** 2
    f1, f2 = 2 * 27 * 48 * px1, 2 * 9 * 48 * 96 * px2
    x_b, y1_b, y2_b = batch * IMG_SIZE ** 2 * 3 * elt, px1 * 48 * elt, \
        px2 * 96 * elt
    if backward:
        return work(dtype, x_b + y1_b + 2 * y2_b, 2 * f2 + f1)
    return work(dtype, x_b + y2_b + (27 * 48 + 9 * 48 * 96) * elt, f1 + f2)


def phase_model_check(dev):
    """YOLOv8m f32 on the card (hand kernels, TF32 off) vs the same
    weights on the CPU (plain versions), 2 x 128 x 128 input."""
    import torch
    from robust_object_detection_tpu_torch.models import yolov8 as Y

    gpu = Y.create(6, "m", torch.float32, dev,
                   torch.Generator().manual_seed(SEED))
    cpu = Y.create(6, "m", torch.float32, torch.device("cpu"),
                   torch.Generator().manual_seed(SEED))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        outs = gpu(x.to(dev))
        refs = cpu(x)
    worst = 0.0
    for (ob, oc), (rb, rc) in zip(outs, refs):
        for o, r in ((ob, rb), (oc, rc)):
            require(o.shape == r.shape, "model output shapes differ")
            err, scale = max_err(o.cpu(), r)
            worst = max(worst, err / scale)
    print(f"[model] YOLOv8m f32 card vs CPU logits: max rel err {worst} "
          f"(tol 1e-3)")
    require(math.isfinite(worst) and worst <= 1e-3,
            f"card logits differ from the CPU reference by {worst}")


def synthetic_samples(n: int):
    """n in-memory 768x1024 uint8 images with 1-5 GT boxes each."""
    import numpy as np
    from robust_object_detection_tpu_torch.data.pipeline import Sample

    rng = np.random.RandomState(SEED)
    h, w = NATIVE_HW
    images, samples = {}, []
    for i in range(n):
        images[i + 1] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        m = int(rng.randint(1, 6))
        xy = rng.rand(m, 2) * [w - 64, h - 64]
        wh = rng.rand(m, 2) * 56 + 8
        samples.append(Sample(
            image_path=Path(f"synthetic/img{i:04d}.png"), image_id=i + 1,
            width=w, height=h,
            boxes_xyxy=np.concatenate([xy, xy + wh], 1).astype(np.float32),
            classes=rng.randint(0, 6, m).astype(np.int32)))
    return images, samples


def run_sweep(dev, tag, title, model, predict, counters, per_forward,
              unet=None, n_images=N_IMAGES, dtype="bf16"):
    """One sweep through the port's entry points with `predict` (4 passes,
    8 with a U-Net): warm-up batch, launch counters zeroed just before the
    sweep and read just after, finite mAPs, images/s and peak memory.
    Returns the launch counts and the detections of one more fused step
    (not counted)."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS

    images, samples = synthetic_samples(n_images)
    passes = 4 if unet is None else 8

    def loader(sample):
        return images[sample.image_id]

    # warm-up batch (cuDNN algorithm choice, allocator), off the count
    FS.run_fused_sweep(predict, model, unet, None, samples[:BATCH], IMG_SIZE,
                       BATCH, load_image=loader)
    torch.cuda.synchronize()

    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = FS.run_fused_sweep(predict, model, unet, None, samples, IMG_SIZE,
                             BATCH, seed=SEED, load_image=loader)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    forwards = passes * math.ceil(n_images / BATCH)
    expect = {k: n * forwards for k, n in per_forward.items()}
    print(f"[{tag}] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    require(out["images_evaluated"] == passes * n_images, "images_evaluated")
    strategies = ("corrupted",) if unet is None else ("corrupted", "restored")
    require(all(st in out for st in strategies)
            and ("restored" in out) == (unet is not None), "strategies")
    for st in strategies:
        for variant, summary in out[st].items():
            m50, m5095 = summary["mAP50"], summary["mAP50_95"]
            name = variant if unet is None else f"{st} {variant}"
            print(f"[{tag}] {name}: mAP50 {m50} mAP50-95 {m5095}")
            require(all(math.isfinite(v) and 0.0 <= v <= 1.0
                        for v in (m50, m5095)), f"{name} mAP not finite")
    rate = out["images_evaluated"] / elapsed
    print(f"[{tag}] {title} {dtype} 1024px, {n_images} images 768x1024 x "
          f"{passes} passes, batch {BATCH}: {elapsed} s, {rate} images/s "
          f"(host scoring included); peak memory {peak} bytes "
          f"({peak / 2 ** 30} GiB)")

    step = FS.make_fused_step(predict, unet, NATIVE_HW, IMG_SIZE)
    batch = torch.from_numpy(np.stack([images[s.image_id]
                                       for s in samples[:BATCH]])).to(dev)
    dets = step(model, None, batch, torch.Generator(dev).manual_seed(SEED))
    require(bool(torch.isfinite(dets[0]).all()
                 and torch.isfinite(dets[1]).all()), "non-finite detections")
    return launches, dets


def phase_sweep(dev):
    """The YOLOv8m sweep; returns the launch counts of its run."""
    import torch
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import nms as NM
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    launches, (_, _, _, valid) = run_sweep(
        dev, "sweep", "YOLOv8m", model, D.make_predict_step(IMG_SIZE),
        {"conv3x3": C.conv3x3, "yolo_front": TF.front_inference,
         "nms": NM._nms_core},
        {"conv3x3": 4, "yolo_front": 1, "nms": 1})
    per_img = valid.sum(-1).float().mean(-1).tolist()
    print(f"[sweep] detections per image by pass (Clean, Noise, Blur, "
          f"LowRes): {per_img}")
    return launches


def check(name, out, ref, tol, log):
    """max abs err of out vs the f32 reference within tol x max|ref|."""
    err, scale = max_err(out, ref)
    log.append(f"{name} {err} (max|ref| {scale}, tol {tol * scale})")
    require(math.isfinite(err) and err <= tol * scale,
            f"{name}: error {err} > {tol} x {scale}")
    return err


# K3-b's bar x max|ref| by dtype. f32: the split-TF32 kernel reads
# 5.4e-5 at (16, 256, 256, 48) and one-pass TF32 2.6e-4 (1M-term sums), so
# 1.5e-4 fails a filter gradient that drops the split's lo. bf16: products
# of bf16 values are exact in f32 and only the order of the f32 sums
# differs; 2e-2 would pass a kernel that drops 1% of its pixels.
K3B_TOL = {"float32": 1.5e-4, "bfloat16": 1e-3}
# K2-b's gradients (dk1, dsc1, dbi1, dk2) x max|ref| by dtype. f32: the
# split-TF32 kernels read <= 3.0e-5 at (16, 1024, 1024, 3) -> 48 -> 96
# (dk2; dk1 1.4e-5, dsc1 and dbi1 ~4e-6) and one pass of TF32 in dk2 and
# dk1 5.2e-4 (dk1), which the 1e-3 the statistics keep would pass. bf16
# 2e-2: the plain front in bf16 rounds y1, a1 and y2 where the kernels do,
# but not in the same order (phase_train_kernels).
K2B_TOL = {"float32": 1.5e-4, "bfloat16": 2e-2}
# K4-b's ten gradients x max|ref| by dtype (phase_rtdetr_train_kernels).
# f32: K4-b on a forward's saved tensors against the same function in
# float64 on them (stem_bwd_f64), which no mask flip separates from it;
# 1.5e-4, the bar of K2-b and K3-b, under one pass of TF32 in the filter
# gradients (tests/test_torch_stem_tf32.py: several percent at small
# sizes, where the BN statistics' cotangents cancel). bf16 8e-2, against
# the plain chain in bf16, which rounds the stored tensors where the
# kernels do, in another order.
K4B_TOL = {"float32": 1.5e-4, "bfloat16": 8e-2}


def check_conv3x3_backward(C, xd, dyd, kd, log):
    """K3-b (within K3B_TOL) and K3-f as dX on one (x, dy, k) against the
    plain versions in f32 on the same values, and K3-b twice for the same
    bits; returns K3-b's max abs error."""
    import torch
    name = str(xd.dtype).split(".")[-1]
    shape = tuple(xd.shape)
    with torch.backends.cudnn.flags(allow_tf32=False):
        err = check(f"conv3x3_wgrad {name} {shape}", C.conv3x3_wgrad(xd, dyd),
                    C.conv3x3_wgrad_reference(xd.float(), dyd.float()),
                    K3B_TOL[name], log)
        kflip = kd.flip(0, 1).transpose(2, 3).contiguous()
        check(f"conv3x3 dX {name} {shape}", C.conv3x3(dyd, kflip),
              C.conv3x3_reference(dyd.float(), kflip.float()),
              1e-4 if xd.dtype == torch.float32 else 1e-2, log)
    again = C.conv3x3_wgrad(xd, dyd)
    require(torch.equal(again, C.conv3x3_wgrad(xd, dyd)),
            "conv3x3_wgrad is not deterministic")
    return err


def check_corrupt(FC, g, dev, batch):
    """K1 on (batch, 1024, 1024, 3) f32, all four branches, image 1
    mid-grey: clean and blur bit-exact, lowres and noise within 1 LSB of
    the plain version, the noise's mean -0.5 +- 0.5 and std 15 +- 0.5.
    Returns (img, choice, seeds, per-branch max abs diff, noise mean,
    noise std)."""
    import torch
    img = torch.floor(torch.rand(batch, IMG_SIZE, IMG_SIZE, 3, device=dev,
                                 generator=g) * 256)
    img[1] = 128.0
    choice = torch.arange(batch, device=dev, dtype=torch.int32) % 4
    seeds = torch.randint(0, 2 ** 30, (batch,), device=dev, generator=g,
                          dtype=torch.int32)
    out, _ = FC.fused_random_corruption(img, None, choice=choice,
                                        seeds=seeds)
    ref = FC.fused_corruption_reference(img, choice, seeds)
    diff = (out - ref).abs().amax((1, 2, 3))
    per_branch = [diff[choice == c].max().item() for c in range(4)]
    noise = out[1] - 128.0
    nmean, nstd = noise.mean().item(), noise.std().item()
    require(per_branch[0] == 0 and per_branch[2] == 0,
            f"corrupt clean/blur not bit-exact: {per_branch}")
    require(per_branch[1] <= 1 and per_branch[3] <= 1,
            f"corrupt noise/lowres beyond 1 LSB: {per_branch}")
    require(abs(nmean + 0.5) <= 0.5 and abs(nstd - 15.0) <= 0.5,
            f"noise mean {nmean} std {nstd}")
    return img, choice, seeds, per_branch, nmean, nstd


def phase_train_kernels(dev):
    """Each training kernel vs its plain version at the train path's
    shapes. Tolerances: f32 outputs 1e-4 x max|ref| (f32 sums in another
    order); f32 sums over B x H x W (weight gradients, BN statistics and
    their gradients) 1e-3 x max|ref| (~1e6-term sums in another order);
    bf16 2e-2 x max|ref|, but K3-b K3B_TOL: 1.5e-4 in f32 (below one-pass
    TF32's error) and 1e-3 in bf16, and K2-b's gradients K2B_TOL: 1.5e-4
    in f32 (below one-pass TF32's error too). The bf16 K3
    kernels are held against the plain version in f32 on the same bf16
    values; the bf16 front against the
    plain front in bf16, which rounds y1, a1 and y2 where the kernels do:
    the pre-BN y1 of a 1024 px batch has channels whose spread is a few
    bf16 steps of their mean, so the gradient of k1 through BN1 is a
    different function of bf16-rounded and of exact y1 (the f32 plain
    front on bf16 inputs differs from the bf16 one by 5% of max|dk1| at
    (2, 256, 256) on the CPU and by 55% at the training shape on the
    card). K1: clean and blur bit-exact, lowres and noise within
    1 LSB (the plain version replays the kernel's noise bits; the
    transcendentals differ by ulps), noise on a mid-grey image with mean
    -0.5 +- 0.5 (the truncation to integers takes 0.5 off a symmetric
    noise) and std 15 +- 0.5. Timings as phase_kernels; the plain
    versions run under PyTorch's default flags."""
    import torch
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import yolo_front as TF

    g = torch.Generator(dev).manual_seed(SEED + 1)
    results = {}

    # K3-b and K3-f as dX: C2f_0 bottleneck convs, (16, 256, 256, 48) -> 48
    x = torch.randn(TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    dy = torch.randn(TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    wg = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        xd, dyd, kd = x.to(dtype), dy.to(dtype), k.to(dtype)
        log = []
        err = check_conv3x3_backward(C, xd, dyd, kd, log)
        ms = time_ms(lambda: C.conv3x3_wgrad(xd, dyd))
        plain_ms = time_ms(lambda: C.conv3x3_wgrad_reference(xd, dyd))
        xv, dyv = xd.permute(0, 3, 1, 2), dyd.permute(0, 3, 1, 2)
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
            xv, (48, 48, 3, 3), dyv, padding=1))
        print(f"[train-kernels] {'; '.join(log)}; wgrad kernel {ms} ms "
              f"plain {plain_ms} ms (cuDNN, with its layout copies) library "
              f"{lib_ms} ms (torch.nn.grad.conv2d_weight alone)")
        wg[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        **work(name, (x.numel() + dy.numel()) * esize(dtype)
                               + k.numel() * 4,
                               2 * k.numel() * x.numel() // 48, lib_ms))
        if dtype == torch.float32:
            wg[name].update(f32_route(
                "train-kernels", "conv3x3_wgrad float32 (16,256,256,48)",
                lambda: C.conv3x3_wgrad(xd, dyd), ("wgrad_tf32_kernel",),
                lambda: torch.nn.grad.conv2d_weight(
                    xv, (48, 48, 3, 3), dyv, padding=1)))
    results["conv3x3_wgrad"] = wg
    del x, dy

    # K2-f train + K2-b: the front, (16, 1024, 1024, 3) -> 48 -> 96
    xf = torch.rand(TRAIN_BATCH, IMG_SIZE, IMG_SIZE, 3, device=dev,
                    generator=g)
    k1 = torch.randn(3, 3, 3, 48, device=dev, generator=g) * 0.2
    k2 = torch.randn(3, 3, 48, 96, device=dev, generator=g) * 0.1
    sc1 = torch.rand(48, device=dev, generator=g) + 0.5
    bi1 = torch.randn(48, device=dev, generator=g) * 0.1
    cot = (torch.randn(TRAIN_BATCH, IMG_SIZE // 4, IMG_SIZE // 4, 96,
                       device=dev, generator=g),
           *(torch.randn(c, device=dev, generator=g) * 0.1
             for c in (48, 48, 96, 96)))
    fwd, bwd = {}, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).split(".")[-1]
        stol = 1e-3 if dtype == torch.float32 else tol
        xd = xf.to(dtype)
        params = [t.clone().requires_grad_() for t in (k1, sc1, bi1, k2)]
        rparams = [t.clone().requires_grad_() for t in (k1, sc1, bi1, k2)]
        cots = (cot[0].to(dtype), *cot[1:])
        log = []
        out = TF.front_fused(xd, *params)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref = TF.front_fused_reference(xd, *rparams)
            err = check(f"front train y2 {name}", out[0], ref[0], tol, log)
            for i, s in enumerate(("mean1", "var1", "mean2", "var2")):
                check(f"{s} {name}", out[i + 1], ref[i + 1], stol, log)
            grads = torch.autograd.grad(out, params, cots)
            rgrads = torch.autograd.grad(ref, rparams, cots)
        gerr = max(check(f"d{n} {name}", a, b, K2B_TOL[name], log)
                   for n, a, b in zip(("k1", "sc1", "bi1", "k2"), grads,
                                      rgrads))
        del out, ref, grads, rgrads
        with torch.no_grad():
            ms = time_ms(lambda: TF.front_fused(xd, *params))
            plain_ms = time_ms(lambda: TF.front_fused_reference(xd, *params))
        out = TF.front_fused(xd, *params)
        pout = TF.front_fused_reference(xd, *params)
        bms = time_ms(lambda: torch.autograd.grad(out, params, cots,
                                                  retain_graph=True))
        bplain = time_ms(lambda: torch.autograd.grad(pout, params, cots,
                                                     retain_graph=True))
        # K2-b (and the forward's statistics) twice: the same bits
        again = [torch.autograd.grad(out, params, cots, retain_graph=True)
                 for _ in range(2)]
        require(all(torch.equal(a, b) for a, b in zip(*again)),
                f"front backward {name} is not deterministic")
        with torch.no_grad():
            stats = [TF.front_fused(xd, *params)[1:] for _ in range(2)]
        require(all(torch.equal(a, b) for a, b in zip(*stats)),
                f"front train statistics {name} are not deterministic")
        log.append("K2-b and the statistics bit-identical twice")
        # K2-b called directly, on this thread (autograd runs it on its
        # own), on the tensors the forward saved for it; f32: the
        # split-TF32 kernels and none of the CUDA-core ones
        saved = out[0].grad_fn.saved_tensors
        what = f"front {{}} {name} (16,1024,1024,3)"
        parts = {}
        with torch.no_grad():
            fwd_fn = lambda: TF.front_fused(xd, *params)  # noqa: E731
            parts["forward"] = (
                front_parts(fwd_fn, "train-kernels", what.format("train"))
                if dtype == torch.bfloat16 else f32_route(
                    "train-kernels", what.format("train"), fwd_fn,
                    K2F_TF32))
        bwd_fn = lambda: TF.front_fused_backward(*saved, *cots)  # noqa: E731
        parts["backward"] = (
            front_parts(bwd_fn, "train-kernels", what.format("backward"))
            if dtype == torch.bfloat16 else f32_route(
                "train-kernels", what.format("backward"), bwd_fn, K2B_TF32))
        del saved
        del out, pout, again, stats
        print(f"[train-kernels] {'; '.join(log)}; front train forward "
              f"kernel {ms} ms plain {plain_ms} ms; backward kernel {bms} "
              f"ms plain {bplain} ms (autograd of the plain front, cuDNN)")
        fwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **front_work(name, TRAIN_BATCH, esize(dtype)))
        bwd[name] = dict(max_abs_err=gerr, ms=bms, plain_ms=bplain,
                         **front_work(name, TRAIN_BATCH, esize(dtype), True))
        for key, rec in (("forward", fwd), ("backward", bwd)):
            if dtype == torch.bfloat16:
                rec[name]["parts"] = parts[key]
            else:
                rec[name].update(parts[key])
    results["yolo_front_train"] = fwd
    results["yolo_front_bwd"] = bwd
    del xf, cot

    # K1: (16, 1024, 1024, 3) f32, all four branches, one mid-grey image
    img, choice, seeds, per_branch, nmean, nstd = check_corrupt(
        FC, g, dev, TRAIN_BATCH)
    ms = time_ms(lambda: FC.fused_random_corruption(img, None, choice=choice,
                                                    seeds=seeds))
    plain_ms = time_ms(lambda: FC.fused_corruption_reference(img, choice,
                                                             seeds))
    print(f"[train-kernels] corrupt f32 (16,1024,1024,3): max abs diff by "
          f"branch (clean, noise, blur, lowres) {per_branch}; mid-grey "
          f"noise mean {nmean} std {nstd}; kernel {ms} ms plain {plain_ms} "
          f"ms")
    # reads and writes the batch once; per element about 2 x 9 operations
    # in the blurred quarter, 10 in the noised and 8 in the low-res one
    results["corrupt"] = {"float32": dict(
        max_abs_err=max(per_branch), ms=ms, plain_ms=plain_ms,
        **work("float32", 2 * img.numel() * 4, img.numel() // 4 * 36))}
    del img

    # the new wrappers refuse CUDA tensors they do not take
    small = torch.zeros(1, 8, 8, 4, device=dev)
    counters = (C.conv3x3_wgrad, TF.front_fused, FC.fused_random_corruption)
    bad = (lambda: C.conv3x3_wgrad(small, small.half()),
           lambda: C.conv3x3_wgrad(small[:, :, ::2], small[:, :, ::2]),
           lambda: TF.front_fused(torch.zeros(1, 9, 8, 3, device=dev),
                                  k1, sc1, bi1, k2),
           lambda: FC.fused_random_corruption(
               torch.zeros(1, 9, 8, 3, device=dev), None, choice=[0],
               seeds=[0]))
    require_refused("train-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def detection_batch(rng, n: int, size: int, per_image: int, max_boxes: int):
    """uint8 images and padded GT as bench.py builds them."""
    import numpy as np
    images = rng.randint(0, 255, (n, size, size, 3), dtype=np.uint8)
    gb = np.zeros((n, max_boxes, 4), np.float32)
    gc = np.full((n, max_boxes), -1, np.int64)
    for i in range(n):
        xy = rng.rand(per_image, 2) * (size - size * 100 // 1024)
        wh = rng.rand(per_image, 2) * (size * 60 // 1024) + 8
        gb[i, :per_image] = np.concatenate([xy, xy + wh], 1)
        gc[i, :per_image] = rng.randint(0, 6, per_image)
    return images, gb, gc


def phase_train_model_check(dev):
    """One YOLOv8m f32 train step (no corruption, no HSV/flip) on the card
    (kernels, TF32 off) and on the CPU (plain versions), same weights and
    batch: loss within 1e-4 relative, each parameter's gradient within
    1e-3 x max|ref| of its leaf."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D

    images, gb, gc = detection_batch(np.random.RandomState(SEED + 2), 2, 128,
                                     8, 16)
    tx, _ = D.make_optimizer()
    step = D.make_train_step(128, CorruptionConfig(), augment=False)
    res = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Y.create(6, "m", torch.float32, device,
                         torch.Generator().manual_seed(SEED), train=True)
        state = D.init_state(model, tx)
        # the gradients as backward leaves them (the optimizer's foreach
        # nesterov update adds the momentum into .grad in place on CUDA)
        grads = {}
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(
                    lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu()))
        with torch.backends.cudnn.flags(allow_tf32=False):
            m = step(state, torch.from_numpy(images).to(device),
                     torch.from_numpy(gb).to(device),
                     torch.from_numpy(gc).to(device),
                     torch.Generator(device).manual_seed(SEED))
        res[name] = (m, grads)
    (mc, gcard), (mr, gref) = res["card"], res["cpu"]
    loss_rel = abs(mc["loss"].item() - mr["loss"].item()) / abs(
        mr["loss"].item())
    require(gcard.keys() == gref.keys(), "gradient leaves differ")
    worst, worst_name = 0.0, ""
    for n, r in gref.items():
        e = ((gcard[n] - r).abs().max() / (r.abs().max() + 1e-12)).item()
        if e > worst:
            worst, worst_name = e, n
    print(f"[train-model] YOLOv8m f32 128px train step card vs CPU: loss "
          f"{mc['loss'].item()} vs {mr['loss'].item()} (rel {loss_rel}, "
          f"tol 1e-4); num_fg {mc['num_fg'].item()} vs "
          f"{mr['num_fg'].item()}; worst gradient rel err {worst} at "
          f"{worst_name} over {len(gref)} leaves (tol 1e-3)")
    require(loss_rel <= 1e-4, f"train-step loss differs by {loss_rel}")
    require(math.isfinite(worst) and worst <= 1e-3,
            f"gradient {worst_name} differs by {worst} x max|ref|")


def phase_training(dev):
    """The training slice through the port's entry points; returns the
    launch counts of the timed steps."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED), train=True,
                     bn_dtype=torch.bfloat16)
    tx, _ = D.make_optimizer()
    state = D.init_state(model, tx)
    step = D.make_train_step(IMG_SIZE, CorruptionConfig(), augment=True,
                             base_augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED),
                                     TRAIN_BATCH, IMG_SIZE, GT_PER_IMAGE,
                                     MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))
    gen = torch.Generator(dev).manual_seed(SEED)

    m = step(state, images, gb, gc, gen)          # warm-up, off the count
    torch.cuda.synchronize()
    require(math.isfinite(m["loss"].item()), "warm-up loss not finite")
    bn = model.model[2].m[0].cv1.bn
    stats0 = (bn.running_mean.clone(), bn.running_var.clone(),
              model.model[0].bn.running_var.clone())
    ema0 = {n: e.clone() for n, e in state.ema.items()}

    counters = {"corrupt": FC.fused_random_corruption,
                "yolo_front_train": TF.front_fused,
                "yolo_front_bwd": TF.front_fused_backward,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad}
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, images, gb, gc, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: v.item() for k, v in m.items()}
        print(f"[train] step {i}: {vals}")
        require(math.isfinite(vals["loss"]) and
                math.isfinite(vals["grad_norm"]),
                f"step {i}: loss or grad_norm not finite")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    per_step = {"corrupt": 1, "yolo_front_train": 1, "yolo_front_bwd": 1,
                "conv3x3": 8, "conv3x3_wgrad": 4}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"[train] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    moved = [not torch.equal(a, b) for a, b in zip(
        stats0, (bn.running_mean, bn.running_var,
                 model.model[0].bn.running_var))]
    ema_moved = sum(not torch.equal(ema0[n], e) for n, e in state.ema.items())
    print(f"[train] BN running stats moved {moved}; EMA leaves moved "
          f"{ema_moved}/{len(ema0)}")
    require(all(moved), "BatchNorm running statistics did not move")
    require(ema_moved > 0, "the EMA did not move")
    ms = statistics.median(times)
    print(f"[train] YOLOv8m bf16 1024px batch {TRAIN_BATCH}, augment + "
          f"HSV/flip: step ms {times} median {ms} = "
          f"{TRAIN_BATCH / (ms / 1e3)} images/s; peak memory "
          f"{peak} bytes ({peak / 2 ** 30} GiB)")
    return launches


RTDETR_LEVELS = ((128, 128), (64, 64), (32, 32))   # P3, P4, P5 at 1024 px
RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS = 300, 8, 32, 4


def stem_inputs(g, b, h, w, dev):
    """Random HGStem parameters (cm 32) and an image batch in [0, 1]."""
    import torch
    cm = 32

    def rn(*shape, scale):
        return torch.randn(*shape, device=dev, generator=g) * scale

    def ru(c):
        return torch.rand(c, device=dev, generator=g) + 0.5

    x = torch.rand(b, h, w, 3, device=dev, generator=g)
    kers = [rn(3, 3, 3, cm, scale=0.2), rn(2, 2, cm, cm // 2, scale=0.2),
            rn(2, 2, cm // 2, cm, scale=0.2), rn(3, 3, 2 * cm, cm, scale=0.1)]
    sizes = (cm, cm // 2, cm)
    affine = [(ru(c), rn(c, scale=0.1)) for c in sizes]
    means = [rn(c, scale=0.1) for c in sizes]
    variances = [ru(c) for c in sizes]
    return x, kers, affine, means, variances


def stem_args(x, kers, affine, means, variances, dtype):
    k1, k2a, k2b, k3 = (k.to(dtype) for k in kers)
    (s1, b1), (s2a, b2a), (s2b, b2b) = affine
    return (x.to(dtype), k1, s1, b1, k2a, s2a, b2a, k2b, s2b, b2b, k3, means,
            variances)


CLUSTER_CENTRES = 200


def clustered_loc(g, b, q, heads, n_l, points, dev, spread=0.01):
    """Sampling locations drawn around CLUSTER_CENTRES centres per (batch,
    head), as a trained decoder's gather around its reference boxes: each
    query picks a centre, and its points at every level lie a normal
    `spread` (in map widths) around it. Many queries then read the same
    value rows, and a level's taps pile on few cells."""
    import torch
    centres = torch.rand(b, heads, CLUSTER_CENTRES, 2, device=dev,
                         generator=g)
    pick = torch.randint(0, CLUSTER_CENTRES, (b, q, heads), device=dev,
                         generator=g)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    hi = torch.arange(heads, device=dev).view(1, 1, heads)
    centre = centres[bi, hi, pick]                     # (B, Q, heads, 2)
    return centre[:, :, :, None, None] + spread * torch.randn(
        b, q, heads, n_l, points, 2, device=dev, generator=g)


def deform_inputs(g, shapes, b, q, heads, dh, points, dev,
                  clustered=False):
    """Values, sampling locations in [-0.1, 1.1] (some taps fall outside
    the maps; clustered: around CLUSTER_CENTRES centres instead) and
    softmaxed attention weights."""
    import torch
    hw = sum(h * w for h, w in shapes)
    n_l = len(shapes)
    values = torch.randn(b, hw, heads, dh, device=dev, generator=g)
    loc = clustered_loc(g, b, q, heads, n_l, points, dev) if clustered \
        else torch.rand(b, q, heads, n_l, points, 2, device=dev,
                        generator=g) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(b, q, heads, n_l * points, device=dev,
                                     generator=g), -1)
    return values, loc, attn.reshape(b, q, heads, n_l, points)


def deform_edges(DF, values, shapes, loc, attn, ref):
    """K5 forward on the same inputs with loc and values one element past a
    16-byte boundary (the kernel reads loc by element, and values by
    element in the generic instantiation), and with every tap outside its
    map (an exact 0)."""
    import torch
    from robust_object_detection_tpu_torch import kernels
    out = DF.ms_deform_attn_slots(values, shapes, loc, attn)
    mloc = misaligned(loc)
    require(torch.equal(DF.ms_deform_attn_slots(values, shapes, mloc, attn),
                        out), "K5 forward: a misaligned loc changes bits")
    mval = misaligned(values)
    require(kernels.deform_fwd_plan(len(shapes), loc.shape[4],
                                    values.shape[3], values.element_size(),
                                    mval.data_ptr())["vec"] == 1,
            "a misaligned values took 16-byte loads")
    log = []
    check("ms_deform_attn misaligned values and loc",
          DF.ms_deform_attn_slots(mval, shapes, mloc, attn), ref, 1e-2, log)
    far = DF.ms_deform_attn_slots(values, shapes, loc + 2.0, attn)
    require(torch.equal(far, torch.zeros_like(far)),
            "K5 forward: taps outside every map do not give 0")
    print(f"[rtdetr-kernels] {log[0]}; a misaligned loc gives the same "
          f"bits; all taps outside: exact 0")


def phase_rtdetr_kernels(dev):
    """K4-f and K5 forward vs their plain versions, at the RT-DETR-L
    sweep's shapes and at one odd shape each. Tolerances: f32 (TF32 off)
    1e-4 x max|ref| (f32 sums in another order); bf16 K4-f 2e-2 x max|ref|
    against the f32 chain on the same bf16 values (the kernel stores a1,
    a2a, a2b and y3 in bf16: three roundings deep); bf16 K5 1e-2 x
    max|ref| (one rounding of the f32 sum)."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST

    g = torch.Generator(dev).manual_seed(SEED + 3)
    results = {}

    # K4-f: (8, 1024, 1024, 3) -> (8, 256, 256, 32), and H != W
    stem = {}
    for shape in ((BATCH, IMG_SIZE, IMG_SIZE), (2, 36, 52)):
        raw = stem_inputs(g, *shape, dev)
        main = shape[0] == BATCH
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            args = stem_args(*raw, dtype)
            out = ST.stem_fused_inference(*args)
            with torch.backends.cudnn.flags(allow_tf32=False):
                ref = ST.stem_reference(*(a.float() if torch.is_tensor(a)
                                          else a for a in args))
            log = []
            err = check(f"hgstem {name} {shape}", out, ref, tol, log)
            if not main:
                print(f"[rtdetr-kernels] {log[0]}")
                continue
            ms = time_ms(lambda: ST.stem_fused_inference(*args))
            plain_ms = time_ms(lambda: ST.stem_reference(*args))
            if dtype == torch.bfloat16:
                stem_parts(lambda: ST.stem_fused_inference(*args),
                           "rtdetr-kernels", f"K4-f eval {shape}")
            # cuDNN's time for each conv stage alone (channels-last views,
            # default flags, and for f32 with TF32 off too): there is no
            # one call for the chain
            b, h, w = shape
            stages, stages_off = {}, {}
            for stage, cin, k, side, stride, pad in (
                    ("stem1", 3, args[1], h, 2, 1),
                    ("stem2a", 32, args[4], h // 2 + 1, 1, 0),
                    ("stem2b", 16, args[7], h // 2 + 1, 1, 0),
                    ("stem3", 64, args[10], h // 2, 2, 1)):
                xs = torch.rand(b, side, side, cin, device=dev,
                                generator=g).to(dtype).permute(0, 3, 1, 2)
                kv = k.permute(3, 2, 0, 1)
                stages[stage] = time_ms(lambda: F.conv2d(
                    xs, kv, stride=stride, padding=pad))
                if dtype == torch.float32:
                    with torch.backends.cudnn.flags(enabled=True,
                                                    allow_tf32=False):
                        stages_off[stage] = time_ms(lambda: F.conv2d(
                            xs, kv, stride=stride, padding=pad))
            print(f"[rtdetr-kernels] {log[0]}; kernel {ms} ms plain "
                  f"{plain_ms} ms (cuDNN convs + elementwise, default "
                  f"flags); cuDNN alone per conv stage {stages} (sum "
                  f"{sum(stages.values())} ms"
                  + (f"; TF32 off {stages_off} (sum "
                     f"{sum(stages_off.values())} ms)" if stages_off else "")
                  + "; no single library call computes the chain)")
            px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
            flops = 2 * (27 * 32 + 128 * 16 + 64 * 32) * px2 \
                + 2 * 576 * 32 * px4
            nbytes = (b * h * w * 3 + px4 * 32
                      + sum(k.numel() for k in raw[1])) * esize(dtype)
            stem[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **work(name, nbytes, flops))
            if dtype == torch.float32:
                stem[name].update(f32_route(
                    "rtdetr-kernels", f"K4-f eval float32 {shape}",
                    lambda: ST.stem_fused_inference(*args), K4F_EVAL_TF32),
                    library_stages_ms=sum(stages.values()),
                    library_stages_tf32_off_ms=sum(stages_off.values()))
        del raw, args, out, ref
    results["hgstem"] = stem

    # K5 forward: values (8, 21504, 8, 32), 300 queries, 3 levels x 4
    # points, uniform and clustered samples (the (3, 4) x 32-channel
    # instantiation); non-square levels with a Q that divides nothing and 2
    # points (the generic one)
    deform = {}
    for shapes, b, q, heads, dh, pts, clustered in (
            (RTDETR_LEVELS, BATCH, RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH,
             RTDETR_POINTS, False),
            (RTDETR_LEVELS, BATCH, RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH,
             RTDETR_POINTS, True),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2, False)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev, clustered)
        main = b == BATCH and not clustered
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            name = str(dtype).split(".")[-1]
            vd = values.to(dtype)
            out = DF.ms_deform_attn_slots(vd, shapes, loc, attn)
            ref = DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn)
            log = []
            what = "clustered" if clustered else "uniform"
            err = check(f"ms_deform_attn {name} levels {shapes} Q {q} "
                        f"{what}", out, ref, tol, log)
            perm = torch.randperm(q, device=dev, generator=g)
            require(torch.equal(DF.ms_deform_attn_slots(
                vd, shapes, loc[:, perm].contiguous(),
                attn[:, perm].contiguous()), out[:, perm]),
                "K5 forward changes bits with the query order")
            if b != BATCH:
                print(f"[rtdetr-kernels] {log[0]}; query order: same bits")
                continue
            ms = time_ms(lambda: DF.ms_deform_attn_slots(vd, shapes, loc,
                                                         attn))
            rows, taps = touched_rows(DF, loc, shapes, values.shape[1],
                                      heads)
            if not main:
                print(f"[rtdetr-kernels] {log[0]}; query order: same bits; "
                      f"kernel {ms} ms (uniform: "
                      f"{deform[name]['ms']}); {taps} in-map taps touch "
                      f"{rows} distinct rows")
                continue
            plain_ms = time_ms(lambda: DF.ms_deform_attn_ref(vd, shapes, loc,
                                                             attn))
            # what this run's data needs: the distinct (batch, cell, head)
            # rows its in-map taps touch, once each, and 2 operations per
            # in-map tap and channel
            nbytes = rows * dh * esize(dtype) + (loc.numel() + attn.numel()) \
                * 4 + out.numel() * esize(dtype)
            print(f"[rtdetr-kernels] {log[0]}; query order: same bits; "
                  f"kernel {ms} ms plain {plain_ms} ms (torch.gather + "
                  f"elementwise); {taps} in-map taps touch {rows} distinct "
                  f"rows of {dh * esize(dtype)} bytes; no single PyTorch "
                  f"call computes it")
            deform[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                **work(name, nbytes, 2 * taps * dh))
            if dtype == torch.bfloat16:
                deform_edges(DF, vd, shapes, loc, attn, ref)
        del values, loc, attn
    results["ms_deform_attn"] = deform

    # the wrappers refuse CUDA tensors they do not take
    raw = stem_inputs(g, 1, 8, 8, dev)
    args = stem_args(*raw, torch.float32)
    values, loc, attn = deform_inputs(g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, dev)
    shapes = ((4, 4), (2, 2))
    # five levels of eight points: the plain versions take it on the CPU,
    # as the reference does; the card's kernels do not instantiate it and
    # refuse it before any launch, with or without a gradient
    shapes5 = ((8, 8), (4, 4), (2, 2), (2, 1), (1, 1))
    v5, l5, a5 = deform_inputs(g, shapes5, 1, 3, 2, 8, 8, dev)
    v5g = v5.clone().requires_grad_()
    counters = (ST.stem_fused_inference, DF.ms_deform_attn_slots,
                DF.ms_deform_attn_sorted_forward)
    bad = (lambda: ST.stem_fused_inference(args[0][:, :6], *args[1:]),
           lambda: ST.stem_fused_inference(args[0].half(), *args[1:]),
           lambda: ST.stem_fused_inference(args[0][:, :, ::2], *args[1:]),
           lambda: DF.ms_deform_attn_slots(values.half(), shapes, loc, attn),
           lambda: DF.ms_deform_attn_slots(values, ((4, 4), (2, 3)), loc,
                                           attn),
           lambda: DF.ms_deform_attn_slots(v5, shapes5, l5, a5),
           lambda: DF.ms_deform_attn_slots(v5g, shapes5, l5, a5),
           lambda: DF.ms_deform_attn(v5g, shapes5, l5, a5),
           lambda: DF.ms_deform_attn_t(DF.values_to_t(v5), shapes5, l5, a5))
    require_refused("rtdetr-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def selected_anchors(model, x):
    """One forward of an RT-DETR; returns (outputs, the anchor index of
    every selected query (B, Q)), read off the encoder score head."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R

    seen = []
    dec = model.model[28]
    hook = dec.enc_score_head.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        outs = model(x)
    finally:
        hook.remove()
    scores = seen[0].amax(-1)
    size = x.shape[1]
    _, valid = R.build_anchors([(size // s, size // s) for s in (8, 16, 32)])
    scores = scores.masked_fill(~torch.from_numpy(valid).to(scores.device),
                                -1e4)
    return outs, R.top_k(scores, min(dec.cfg.queries, scores.shape[1]))[1]


def phase_rtdetr_model_check(dev):
    """RT-DETR-L f32 on the card (hand kernels, TF32 off) vs the same
    weights on the CPU (plain versions), 2 x 128 x 128 input (336 anchors,
    300 queries). Queries are matched by their anchor: near-tied encoder
    scores may come out in another order on the two devices, which moves
    rows and nothing else. Last-layer logits and boxes within 2e-3 x
    max|ref|; decoded scores (sorted) within 2e-3."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R

    gpu = R.create(6, torch.float32, dev, torch.Generator().manual_seed(SEED))
    cpu = R.create(6, torch.float32, torch.device("cpu"),
                   torch.Generator().manual_seed(SEED))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        outs, sel = selected_anchors(gpu, x.to(dev))
        refs, rsel = selected_anchors(cpu, x)
    sel = sel.cpu()
    worst = 0.0
    for b in range(x.shape[0]):
        require(set(sel[b].tolist()) == set(rsel[b].tolist()),
                f"image {b}: the card selected other anchors than the CPU")
        rows, rrows = torch.argsort(sel[b]), torch.argsort(rsel[b])
        for key in ("logits", "boxes"):
            o, r = outs[key][-1, b].cpu()[rows], refs[key][-1, b][rrows]
            require(o.shape == r.shape and bool(torch.isfinite(o).all()),
                    f"{key}: shape or non-finite values")
            err, scale = max_err(o, r)
            worst = max(worst, err / scale)
    s_card = R.postprocess({k: v.cpu() for k, v in outs.items()}, 128)[1]
    s_cpu = R.postprocess(refs, 128)[1]
    s_err = (s_card - s_cpu).abs().max().item()
    moved = int((sel != rsel).sum().item())
    print(f"[rtdetr-model] RT-DETR-L f32 128px card vs CPU: same anchors "
          f"selected ({moved} of {sel.numel()} in another order); "
          f"last-layer logits / boxes max rel err {worst} (tol 2e-3); top-"
          f"{s_cpu.shape[1]} decoded scores max abs err {s_err} (tol 2e-3)")
    require(math.isfinite(worst) and worst <= 2e-3,
            f"card outputs differ from the CPU reference by {worst}")
    require(s_err <= 2e-3, f"decoded scores differ by {s_err}")


def phase_rtdetr_sweep(dev):
    """The RT-DETR-L sweep (NMS-free predict step); returns the launch
    counts of its run."""
    import torch
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    model = R.create(6, torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    launches, (boxes, scores, classes, valid) = run_sweep(
        dev, "rtdetr-sweep", "RT-DETR-L", model,
        RT.make_predict_step(IMG_SIZE),
        {"hgstem": ST.stem_fused_inference,
         "ms_deform_attn": DF.ms_deform_attn_slots, "conv3x3": C.conv3x3},
        {"hgstem": 1, "ms_deform_attn": 6, "conv3x3": 6})
    require(boxes.shape == (4, BATCH, 300, 4) and bool(valid.all()),
            "the NMS-free decode returns all 300 queries, valid")
    require(bool(((scores > 0) & (scores < 1)).all()
                 and ((classes >= 0) & (classes < 6)).all()),
            "scores outside (0, 1) or classes outside 0..5")
    print(f"[rtdetr-sweep] score range by pass (Clean, Noise, Blur, LowRes): "
          f"{[(s.min().item(), s.max().item()) for s in scores]}")
    return launches


def stem_train_params(g, dev):
    """Random HGStem parameters in stem_fused's order (f32 masters)."""
    _, kers, affine, _, _ = stem_inputs(g, 1, 4, 4, dev)
    (s1, b1), (s2a, b2a), (s2b, b2b) = affine
    return [kers[0], s1, b1, kers[1], s2a, b2a, kers[2], s2b, b2b, kers[3]]


STEM_PARAMS = ("k1", "sc1", "bi1", "k2a", "sc2a", "bi2a", "k2b", "sc2b",
               "bi2b", "k3")


def stem_grads_f64(ST, x, params, cots):
    """The ten gradients of the train-mode stem's plain chain in float64 on
    the card, on x as given and the conv kernels the route computes with
    (rounded to bf16 for a bf16 x; the chain's f32 casts widened to
    float64)."""
    import torch
    bf16 = x.dtype == torch.bfloat16
    ps = [(p.bfloat16() if bf16 and p.dim() == 4 else p).double()
          .requires_grad_() for p in params]
    real_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t.double()
    try:
        y3, means, variances = ST.stem_train_reference(x.double(), *ps)
        return torch.autograd.grad((y3, *means, *variances), ps,
                                   [c.double() for c in cots])
    finally:
        torch.Tensor.float = real_float


def stem_bwd_f64(ST, saved, dy3, dmeans, dvars):
    """K4-b's function in float64 on the tensors a forward saved for it
    (stem_fused's saved tensors: x, y1, y2a, y2b, the concat, y3, k2a, k2b,
    k3, sc1, sc2a, sc2b and the statistics buffer), its ReLU masks and pool
    routing taken from those tensors: the ten gradients (dk1, dsc1, dbi1,
    dk2a, dsc2a, dbi2a, dk2b, dsc2b, dbi2b, dk3; filters HWIO). Independent
    of the kernels: torch's float64 conv gradients and the folded-BN chain
    rule, the pool's VJP by autograd of the plain version."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    x, y1, y2a, y2b, cat, y3, k2a, k2b, k3, sc1, sc2a, sc2b, fv = (
        t.double() for t in saved)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def col(v):
        return v[:, None, None]

    def hwio(k):
        return k.permute(2, 3, 1, 0).contiguous()

    def cot(v, c):
        return (torch.zeros(c, dtype=torch.float64, device=x.device)
                if v is None else v.double())
    n1 = float(y1.shape[0] * y1.shape[1] * y1.shape[2])
    n3 = float(y3.shape[0] * y3.shape[1] * y3.shape[2])
    sizes = (32, 16, 32, 32)
    dm = [cot(v, c) for v, c in zip(dmeans, sizes)]
    dv = [cot(v, c) for v, c in zip(dvars, sizes)]

    def slot(bn, which, c):
        return fv[4 * bn + which, :c]

    def chain(dg, db, sc, bn, c):
        """dsc, dbi, ds, dss of BN `bn` (bn_chain_kernel's algebra)."""
        mean, var = slot(bn, 0, c), slot(bn, 1, c)
        r = torch.rsqrt(var + 1e-3)
        dmi = -db * sc * r + dm[bn]
        dvi = (dg - db * mean) * sc * -0.5 * r ** 3 + dv[bn]
        return dg * r - db * mean * r, db, dmi / n1 - 2 * mean * dvi / n1, \
            dvi / n1

    with torch.no_grad():
        m3 = fv[12]
        ds3, dss3 = dm[3] / n3 - 2 * m3 * dv[3] / n3, dv[3] / n3
        e3 = nchw(dy3.double() + ds3 + 2 * y3 * dss3)
        cat_, k3_ = nchw(cat), k3.permute(3, 2, 0, 1)
        dk3 = conv2d_weight(cat_, k3_.shape, e3, stride=2, padding=1)
        dcat = conv2d_input(cat_.shape, k3_, e3, stride=2, padding=1)
        g = [slot(i, 2, c) for i, c in enumerate(sizes[:3])]
        b = [slot(i, 3, c) for i, c in enumerate(sizes[:3])]
        y1_, y2a_, y2b_ = nchw(y1), nchw(y2a), nchw(y2b)
        a1 = torch.relu(y1_ * col(g[0]) + col(b[0]))
        a2a = torch.relu(y2a_ * col(g[1]) + col(b[1]))
        # the concat's backward: BN2b's chain, the pool's routing
        dpre = dcat[:, 32:] * (y2b_ * col(g[2]) + col(b[2]) > 0)
        dsc2b, dbi2b, ds, dss = chain((dpre * y2b_).sum((0, 2, 3)),
                                      dpre.sum((0, 2, 3)), sc2b, 2, 32)
    with torch.enable_grad():
        a1g = a1.clone().requires_grad_()
        (da1p,) = torch.autograd.grad(ST._pool2x2(a1g), a1g, dcat[:, :32])
    with torch.no_grad():
        h, w = y1_.shape[2:]
        e2b = dpre * col(g[2]) + col(ds) + 2 * y2b_ * col(dss)
        pad2a, k2b_ = F.pad(a2a, (0, 1, 0, 1)), k2b.permute(3, 2, 0, 1)
        dk2b = conv2d_weight(pad2a, k2b_.shape, e2b)
        da = conv2d_input(pad2a.shape, k2b_, e2b)[:, :, :h, :w]
        dpre = da * (y2a_ * col(g[1]) + col(b[1]) > 0)
        dsc2a, dbi2a, ds, dss = chain((dpre * y2a_).sum((0, 2, 3)),
                                      dpre.sum((0, 2, 3)), sc2a, 1, 16)
        e2a = dpre * col(g[1]) + col(ds) + 2 * y2a_ * col(dss)
        pad1, k2a_ = F.pad(a1, (0, 1, 0, 1)), k2a.permute(3, 2, 0, 1)
        dk2a = conv2d_weight(pad1, k2a_.shape, e2a)
        da = conv2d_input(pad1.shape, k2a_, e2a)[:, :, :h, :w]
        dpre = (da + da1p) * (y1_ * col(g[0]) + col(b[0]) > 0)
        dsc1, dbi1, ds, dss = chain((dpre * y1_).sum((0, 2, 3)),
                                    dpre.sum((0, 2, 3)), sc1, 0, 32)
        e1 = dpre * col(g[0]) + col(ds) + 2 * y1_ * col(dss)
        dk1 = conv2d_weight(nchw(x), (32, 3, 3, 3), e1, stride=2, padding=1)
    return (hwio(dk1), dsc1, dbi1, hwio(dk2a), dsc2a, dbi2a, hwio(dk2b),
            dsc2b, dbi2b, hwio(dk3))


def stem_f64_witness(ST, x, params, cots, grads, plain_grads, log):
    """K4-b's bf16 gradients and the plain bf16 chain's against the float64
    chain on the same bf16-rounded inputs: each of the ten within 2x the
    plain chain's error (each error x max|f64|), a bound that bf16 noise
    does not set."""
    ref = stem_grads_f64(ST, x, params, cots)
    for name, gk, gp, r in zip(STEM_PARAMS, grads, plain_grads, ref):
        scale = r.abs().max().item()
        ek = (gk.double() - r).abs().max().item() / scale
        ep = (gp.double() - r).abs().max().item() / scale
        log.append(f"d{name} vs float64: kernel {ek:.3g} plain {ep:.3g}")
        require(ek <= 2 * ep, f"K4-b d{name} at {tuple(x.shape)}: error "
                f"{ek} against float64, more than 2x the plain chain's {ep}")


def stem_work(dtype: str, b: int, h: int, w: int, elt: int, backward: bool):
    """The train-mode stem at (b, h, w, 3) as a function: the forward reads
    x and the filters and writes y3 (and 8 statistics vectors); its VJP
    reads x, y3, the filters and dy3 and writes the f32 filter and affine
    gradients. What either keeps in between (y1, y2a, y2b, the concat) is
    this implementation's choice and no part of the bound. Operations: the
    four convs forward; backward dW of all four and dX of three (none into
    the image)."""
    px2, px4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    f1, f2 = 2 * 27 * 32 * px2, 2 * 128 * 16 * px2
    f3 = 2 * 576 * 32 * px4
    n_filters = 27 * 32 + 2 * 128 * 16 + 576 * 32
    if backward:
        nbytes = (b * h * w * 3 + 2 * px4 * 32 + n_filters) * elt \
            + (n_filters + 6 * 32) * 4
        return work(dtype, nbytes, f1 + 2 * (2 * f2 + f3))
    nbytes = (b * h * w * 3 + px4 * 32 + n_filters) * elt + 8 * 32 * 4
    return work(dtype, nbytes, f1 + 2 * f2 + f3)


def auction_inputs(g, dev, b, q, m, n_valid, quantum=None,
                   empty_image=False, cheap_invalid=False, alike=False):
    """K6's inputs: costs in [0, 4) (quantised to 1/quantum: ties), the
    first n_valid GTs of each image valid and the rest padded at BIG;
    empty_image: image 0 without a valid GT; cheap_invalid: the last column
    of every image marked invalid yet priced 2.5, below BIG / 2; alike:
    every GT ranks the queries alike (a cost per query plus 0.05 of noise),
    so that few GTs cap and the greedy takes about one pair a round."""
    import torch
    from robust_object_detection_tpu_torch.ops import assignment as AS
    cost = torch.rand(b, q, m, device=dev, generator=g) * 4
    if quantum:
        cost = torch.round(cost * quantum) / quantum
    if alike:
        cost = torch.rand(b, q, 1, device=dev, generator=g) * 4 \
            + 0.05 * cost / 4
    valid = torch.zeros(b, m, dtype=torch.bool, device=dev)
    valid[:, :n_valid] = True
    if empty_image:
        valid[0] = False
    cost = torch.where(valid[:, None, :], cost, torch.full_like(cost, AS.BIG))
    if cheap_invalid:
        cost[:, :, m - 1] = 2.5
        valid[:, m - 1] = False
    return cost, valid


def phase_rtdetr_train_kernels(dev):
    """K4-f train, K4-b, K5 backward and K6 vs their plain versions at the
    RT-DETR-L train step's shapes and at one odd shape each. Tolerances,
    each x max|ref|: K4-f train y3 1e-4 in f32 (TF32 off) and 2e-2 in bf16,
    its eight batch statistics 1e-3 and 2e-2 (sums over B x H x W); K4-b's
    ten gradients K4B_TOL: in f32 K4-b, called on the tensors its forward
    saved (the autograd gradients' bits), against the same function in
    float64 on the same tensors (stem_bwd_f64; end to end, f32 noise flips
    ReLU masks and pool routings, each a whole term of a gradient: the
    kernels' and the plain f32 chain's errors against the float64 chain,
    up to 1.7e-3 of max|ref| at the train shape for either, are printed);
    in bf16 8e-2 (0.25 at the odd bf16 shape, whose sums run over 936
    pixels only;
    its f32 check holds the edges) against the autograd of the plain chain
    in bf16, which rounds the stored tensors where the kernels do (a
    last-bit difference of a stored bf16 y flips roundings four tensors
    down the chain); at the odd bf16 shape also against the float64 chain
    on the same bf16-rounded inputs, each gradient within 2x the plain bf16
    chain's error (stem_f64_witness); K4-b twice gives identical bits. K5
    backward against the
    autograd of the plain gather version in f32 on the same values, on
    uniform and on clustered samples: d(values) 1e-4 in f32 and 2e-2 in
    bf16 (one rounding of the f32 sum), d(loc) and d(attn) 1e-4 and 1e-3,
    the same bits on a second run, the same bits for d(loc) and d(attn)
    under a permutation of the queries, and d(values) bit for bit that of
    K5-g2's backward (``ms_deform_attn_sorted_backward``) on the same
    inputs with the f32 of the same dout. K6: the same assignment
    and capped flags as the plain round loop + greedy completion, by
    equality, on costs that converge, on a batch built to hit the round
    cap (as many valid GTs as queries) and with an image without GT. The
    kernels of earlier paths that this step also launches are held at the
    shapes it gives them: K5 forward at 428 queries (1e-4 / 1e-2), K3-b and
    K3-f as dX at (8, 256, 256, 48) and K1 at (8, 1024, 1024, 3), with the
    tolerances of phase_train_kernels."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST

    g = torch.Generator(dev).manual_seed(SEED + 4)
    results = {}

    # K4-f train and K4-b: (8, 1024, 1024, 3), and H != W
    fwd, bwd = {}, {}
    params = stem_train_params(g, dev)
    for shape in ((RTDETR_TRAIN_BATCH, IMG_SIZE, IMG_SIZE), (2, 36, 52)):
        b, h, w = shape
        main = b == RTDETR_TRAIN_BATCH
        x = torch.rand(b, h, w, 3, device=dev, generator=g)
        cots = [torch.randn(b, h // 4, w // 4, 32, device=dev, generator=g)]
        cots += [torch.randn(c, device=dev, generator=g) * 0.1
                 for c in (32, 16, 32, 32) * 2]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            stol = 1e-3 if dtype == torch.float32 else tol
            gtol = K4B_TOL[name]
            if dtype == torch.bfloat16 and not main:
                gtol = 0.25      # 936 pixels: each flipped rounding shows
            xd = x.to(dtype)
            ps = [t.clone().requires_grad_() for t in params]
            rs = [t.clone().requires_grad_() for t in params]
            cd = [cots[0].to(dtype)] + cots[1:]
            log = []
            out = ST.stem_fused(xd, *ps)
            flat = (out[0], *out[1], *out[2])
            with torch.backends.cudnn.flags(allow_tf32=False):
                ref = ST.stem_train_reference(xd, *rs)
                rflat = (ref[0], *ref[1], *ref[2])
                err = check(f"hgstem train y3 {name} {shape}", flat[0],
                            rflat[0].float(), tol, log)
                for i in range(8):
                    check(f"{'mean' if i < 4 else 'var'}{i % 4} {name}",
                          flat[1 + i], rflat[1 + i], stol, log)
                grads = torch.autograd.grad(flat, ps, cd, retain_graph=True)
                rgrads = torch.autograd.grad(rflat, rs, cd)
            if dtype == torch.float32:
                # K4-b alone, called on the tensors this forward saved: the
                # autograd gradients' bits, and within the bar of the same
                # function in float64 on the same tensors (stem_bwd_f64).
                # End to end (the f32 forward and K4-b) the kernels' and
                # the plain f32 chain's gradients against the float64 chain
                # are printed: a ReLU mask or pool routing that f32 noise
                # flips moves a gradient by a whole term, up to 1.7e-3 of
                # max|ref| at the train shape for either
                saved = out[0].grad_fn.saved_tensors
                alone = ST.stem_fused_backward(*saved, cd[0], cd[1:5],
                                               cd[5:9])
                require(all(torch.equal(a, c) for a, c in zip(alone, grads)),
                        "K4-b called alone differs from its autograd run")
                ref64 = stem_bwd_f64(ST, saved, cd[0], cd[1:5], cd[5:9])
                del saved
                gerr = max(check(f"d{n} {name} alone vs float64", a, r,
                                 gtol, log)
                           for n, a, r in zip(STEM_PARAMS, alone, ref64))
                f64 = stem_grads_f64(ST, xd, params, cd)

                def rel(a, r):
                    e, scale = max_err(a, r)
                    return e / scale
                log.append("end to end vs float64, kernels / plain f32: "
                           + ", ".join(
                               f"d{n} {rel(a, d):.3g} / {rel(r, d):.3g}"
                               for n, a, r, d in zip(STEM_PARAMS, grads,
                                                     rgrads, f64)))
                del f64, alone, ref64
            else:
                gerr = max(check(f"d{n} {name}", a, r, gtol, log)
                           for n, a, r in zip(STEM_PARAMS, grads, rgrads))
            again = torch.autograd.grad(flat, ps, cd)
            require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                    "K4-b is not deterministic")
            if dtype == torch.bfloat16 and not main:
                stem_f64_witness(ST, xd, params, cd, grads, rgrads, log)
            del out, flat, ref, rflat, grads, rgrads, again
            if not main:
                print(f"[rtdetr-train-kernels] {'; '.join(log)}")
                continue
            routes = {}
            with torch.no_grad():
                ms = time_ms(lambda: ST.stem_fused(xd, *ps))
                plain_ms = time_ms(lambda: ST.stem_train_reference(xd, *ps))
                if dtype == torch.bfloat16:
                    stem_parts(lambda: ST.stem_fused(xd, *ps),
                               "rtdetr-train-kernels", f"K4-f train {shape}")
                else:
                    routes["forward"] = f32_route(
                        "rtdetr-train-kernels", f"K4-f train float32 {shape}",
                        lambda: ST.stem_fused(xd, *ps), K4F_TRAIN_TF32)
            out = ST.stem_fused(xd, *ps)
            flat = (out[0], *out[1], *out[2])
            bms = time_ms(lambda: torch.autograd.grad(flat, ps, cd,
                                                      retain_graph=True))
            if dtype == torch.bfloat16:
                stem_parts(lambda: torch.autograd.grad(flat, ps, cd,
                                                       retain_graph=True),
                           "rtdetr-train-kernels", f"K4-b {shape}")
            else:
                # K4-b called directly, on this thread, on the tensors the
                # forward saved for it: the split-TF32 kernels only
                saved = out[0].grad_fn.saved_tensors
                routes["backward"] = f32_route(
                    "rtdetr-train-kernels", f"K4-b float32 {shape}",
                    lambda: ST.stem_fused_backward(*saved, cd[0], cd[1:5],
                                                   cd[5:9]), K4B_TF32)
                del saved
            del out, flat
            pout = ST.stem_train_reference(xd, *ps)
            pflat = (pout[0], *pout[1], *pout[2])
            bplain = time_ms(lambda: torch.autograd.grad(pflat, ps, cd,
                                                         retain_graph=True))
            del pout, pflat
            # cuDNN alone, stage by stage (channels-last views, default
            # flags, and for f32 with TF32 off too): no one call computes
            # the chain's backward
            stages, stages_off = {}, {}
            for stage, cin, cout, k, side, stride, pad, need_dx in (
                    ("stem1", 3, 32, 3, h, 2, 1, False),
                    ("stem2a", 32, 16, 2, h // 2 + 1, 1, 0, True),
                    ("stem2b", 16, 32, 2, h // 2 + 1, 1, 0, True),
                    ("stem3", 64, 32, 3, h // 2, 2, 1, True)):
                xs = torch.rand(b, side, side, cin, device=dev,
                                generator=g).to(dtype).permute(0, 3, 1, 2)
                kv = torch.randn(cout, cin, k, k, device=dev,
                                 generator=g).to(dtype)
                dys = torch.randn_like(F.conv2d(xs, kv, stride=stride,
                                                padding=pad))
                def stage_ms():
                    t = time_ms(lambda: torch.nn.grad.conv2d_weight(
                        xs, kv.shape, dys, stride=stride, padding=pad))
                    if need_dx:
                        t += time_ms(lambda: torch.nn.grad.conv2d_input(
                            xs.shape, kv, dys, stride=stride, padding=pad))
                    return t
                stages[stage] = stage_ms()
                if dtype == torch.float32:
                    with torch.backends.cudnn.flags(enabled=True,
                                                    allow_tf32=False):
                        stages_off[stage] = stage_ms()
                del xs, dys
            print(f"[rtdetr-train-kernels] {'; '.join(log)}; K4-f train "
                  f"kernel {ms} ms plain {plain_ms} ms (cuDNN convs + "
                  f"elementwise); K4-b kernel {bms} ms plain {bplain} ms "
                  f"(autograd of the plain chain); cuDNN alone per stage "
                  f"(conv2d_weight + conv2d_input) {stages} (sum "
                  f"{sum(stages.values())} ms"
                  + (f"; TF32 off {stages_off} (sum "
                     f"{sum(stages_off.values())} ms)" if stages_off else "")
                  + "; no single library call computes either)")
            fwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **stem_work(name, b, h, w, esize(dtype), False))
            bwd[name] = dict(max_abs_err=gerr, ms=bms, plain_ms=bplain,
                             **stem_work(name, b, h, w, esize(dtype), True))
            if dtype == torch.float32:
                fwd[name].update(routes["forward"])
                bwd[name].update(routes["backward"],
                                 library_stages_ms=sum(stages.values()),
                                 library_stages_tf32_off_ms=sum(
                                     stages_off.values()))
        del x, cots
    results["hgstem_train"] = fwd
    results["hgstem_bwd"] = bwd
    torch.cuda.empty_cache()

    # K5 backward: values (8, 21504, 8, 32), 300 + 128 queries, 3 levels x
    # 4 points, uniform and clustered samples; and non-square levels with a
    # Q that divides nothing
    dbwd = {}
    q_train = RTDETR_QUERIES + 2 * 2 * 32
    for shapes, b, q, heads, dh, pts, clustered in (
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS, False),
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS, True),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2, False)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev, clustered)
        dout = torch.randn(b, q, heads, dh, device=dev, generator=g)
        main = b == RTDETR_TRAIN_BATCH and not clustered
        what = "clustered" if clustered else "uniform"
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = str(dtype).split(".")[-1]
            vd, dd = values.to(dtype), dout.to(dtype)
            dv, dloc, dattn = DF.ms_deform_attn_backward(vd, shapes, loc,
                                                         attn, dd)
            leaves = [t.clone().requires_grad_()
                      for t in (vd.float(), loc, attn)]
            rdv, rdloc, rdattn = torch.autograd.grad(
                DF.ms_deform_attn_ref(leaves[0], shapes, leaves[1],
                                      leaves[2]), leaves, dd.float())
            log = []
            ltol = 1e-4 if dtype == torch.float32 else 1e-3
            err = check(f"ms_deform_attn bwd d(values) {name} levels "
                        f"{shapes} Q {q} {what}", dv, rdv, tol, log)
            err = max(err, check(f"d(loc) {name}", dloc, rdloc, ltol, log),
                      check(f"d(attn) {name}", dattn, rdattn, ltol, log))
            again = DF.ms_deform_attn_backward(vd, shapes, loc, attn, dd)
            require(all(torch.equal(a, c) for a, c in
                        zip(again, (dv, dloc, dattn))),
                    f"K5 backward ({name}) is not deterministic")
            require(torch.equal(DF.ms_deform_attn_sorted_backward(
                vd, shapes, loc, attn, dd.float())[0], dv),
                f"K5 backward's d(values) ({name}) differs from K5-g2's on "
                f"the same inputs")
            perm = torch.randperm(q, device=dev, generator=g)
            _, ploc, pattn = DF.ms_deform_attn_backward(
                vd, shapes, loc[:, perm].contiguous(),
                attn[:, perm].contiguous(), dd[:, perm].contiguous())
            require(torch.equal(ploc, dloc[:, perm])
                    and torch.equal(pattn, dattn[:, perm]),
                    "d(loc) / d(attn) change bits with the query order")
            del leaves, rdv, rdloc, rdattn, ploc, pattn, again
            if not main:
                ms = time_ms(lambda: DF.ms_deform_attn_backward(
                    vd, shapes, loc, attn, dd)) if clustered else None
                print(f"[rtdetr-train-kernels] {'; '.join(log)}; a second "
                      f"run, K5-g2's d(values): identical bits"
                      + (f"; kernel {ms} ms" if clustered else ""))
                continue
            # the forward at this path's 428 queries (the sweep's 300 are
            # held in phase_rtdetr_kernels), same tolerances as there
            check(f"ms_deform_attn fwd {name} Q {q}",
                  DF.ms_deform_attn_slots(vd, shapes, loc, attn),
                  DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn),
                  1e-4 if dtype == torch.float32 else 1e-2, log)
            ms = time_ms(lambda: DF.ms_deform_attn_backward(vd, shapes, loc,
                                                            attn, dd))
            leaves = [t.clone().requires_grad_() for t in (vd, loc, attn)]
            pout = DF.ms_deform_attn_ref(leaves[0], shapes, leaves[1],
                                         leaves[2])
            plain_ms = time_ms(lambda: torch.autograd.grad(
                pout, leaves, dd, retain_graph=True))
            del leaves, pout
            # what this run's data needs: the distinct value rows its
            # in-map taps touch and dout read once, d(values), d(loc) and
            # d(attn) written once, and 4 operations per in-map tap and
            # channel
            rows, taps = touched_rows(DF, loc, shapes, values.shape[1],
                                      heads)
            elt = esize(dtype)
            nbytes = (rows * dh + values.numel() + dout.numel()) * elt \
                + 2 * (loc.numel() + attn.numel()) * 4
            # the two launches' device ms (by kernel where the profiler's
            # record does not split into calls)
            parts = device_ms_by_launch(lambda: DF.ms_deform_attn_backward(
                vd, shapes, loc, attn, dd)) or [
                    (t, k) for t, _, k in device_ms_by_kernel(
                        lambda: DF.ms_deform_attn_backward(
                            vd, shapes, loc, attn, dd))]
            print(f"[rtdetr-train-kernels] {'; '.join(log)}; a second run, "
                  f"K5-g2's d(values): identical bits; kernel {ms} ms "
                  f"(device ms: " + "; ".join(
                      f"{short_kernel_name(k)} {t}" for t, k in parts)
                  + f") plain {plain_ms} ms (autograd of torch.gather "
                  f"+ elementwise); {taps} in-map taps, {rows} distinct "
                  f"rows; no single PyTorch call computes it")
            dbwd[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **work(name, nbytes, 4 * taps * dh))
        del values, loc, attn, dout
    results["ms_deform_attn_bwd"] = dbwd
    torch.cuda.empty_cache()

    # the kernels this path shares with the YOLOv8m train step, at its own
    # batch of 8: K3-b and K3-f as dX on the stage-1 HGBlock's convs,
    # (8, 256, 256, 48) -> 48 (the forward at this shape is held in
    # phase_kernels), and K1 on (8, 1024, 1024, 3); tolerances as in
    # phase_train_kernels, no timing
    x = torch.randn(RTDETR_TRAIN_BATCH, 256, 256, 48, device=dev, generator=g)
    dy = torch.randn(RTDETR_TRAIN_BATCH, 256, 256, 48, device=dev,
                     generator=g)
    k = torch.randn(3, 3, 48, 48, device=dev, generator=g) * 0.1
    log = []
    for dtype in (torch.float32, torch.bfloat16):
        check_conv3x3_backward(C, x.to(dtype), dy.to(dtype), k.to(dtype),
                               log)
    print(f"[rtdetr-train-kernels] {'; '.join(log)}")
    xv, dyv = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    f32 = f32_route(
        "rtdetr-train-kernels", "conv3x3_wgrad float32 (8,256,256,48)",
        lambda: C.conv3x3_wgrad(x, dy), ("wgrad_tf32_kernel",),
        lambda: torch.nn.grad.conv2d_weight(xv, (48, 48, 3, 3), dyv,
                                            padding=1))
    ms = time_ms(lambda: C.conv3x3_wgrad(x, dy))
    lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
        xv, (48, 48, 3, 3), dyv, padding=1))
    print(f"[rtdetr-train-kernels] conv3x3_wgrad float32 (8,256,256,48): "
          f"kernel {ms} ms, device {f32['device_ms']} ms; library {lib_ms} "
          f"ms (cuDNN's TF32 on), {f32['library_tf32_off_ms']} ms (off)")
    del x, dy, xv, dyv
    img, _, _, per_branch, nmean, nstd = check_corrupt(FC, g, dev,
                                                       RTDETR_TRAIN_BATCH)
    print(f"[rtdetr-train-kernels] corrupt f32 {tuple(img.shape)}: max abs "
          f"diff by branch (clean, noise, blur, lowres) {per_branch}; "
          f"mid-grey noise mean {nmean} std {nstd}")
    del img
    torch.cuda.empty_cache()

    # K6: cost (8, 300, 300), 80 valid GTs an image (the train step's);
    # the same with 300 valid GTs, which hits the 16-round cap so that the
    # greedy completion runs; Q 7, M 5 with an image without GT; costs
    # quantised to 1/64 (ties), converging and capped; an image whose GTs
    # are all padded; a column marked invalid but priced below BIG / 2 (the
    # greedy may take it); GTs that all rank the queries alike (80 of them
    # cap; the greedy takes about one pair a round); and M 420, more GT
    # rows than shared memory holds
    auction = {}
    cases = (("train", 8, 300, 300, 80, {}),
             ("capped", 8, 300, 300, 300, {}),
             ("odd", 3, 7, 5, 3, dict(empty_image=True)),
             ("ties", 8, 300, 300, 80, dict(quantum=64)),
             ("ties capped", 8, 300, 300, 300, dict(quantum=64)),
             ("all padded", 4, 300, 300, 80, dict(empty_image=True)),
             ("invalid but cheap", 4, 60, 50, 50, dict(cheap_invalid=True)),
             ("alike", 8, 300, 300, 80, dict(alike=True)),
             ("past capacity", 4, 300, 420, 420, {}))
    for tag, b, q, m, n_valid, kw in cases:
        cost, valid = auction_inputs(g, dev, b, q, m, n_valid, **kw)
        owner, capped = AS.auction_assignment(cost, valid, max_rounds=16)
        powner, pcapped = AS.auction_assignment_plain(cost, valid,
                                                      max_rounds=16)
        same = bool(torch.equal(owner, powner)
                    and torch.equal(capped, pcapped))
        raw, _ = AS.auction_assignment(cost, valid, max_rounds=16,
                                       complete_greedy=False)
        same_raw = bool(torch.equal(raw, AS.auction_assignment_ref(
            cost, valid, 0.005, 16)[0]))
        rounds = AS.auction_assignment_rounds(cost, valid,
                                              max_rounds=16)[2].tolist()
        staged = kernels.auction_rows_staged(kernels.auction_plan(q, m),
                                             n_valid)
        n_capped = int(capped.sum().item())
        matched = (owner >= 0).sum(1).tolist()
        print(f"[rtdetr-train-kernels] auction {tag} (B {b}, Q {q}, M {m}, "
              f"{n_valid} valid): equal to the plain version {same}, "
              f"without the completion {same_raw}; capped images "
              f"{n_capped}; matched per image {matched}; rounds (auction, "
              f"greedy) by image {rounds}; staged rows {staged}")
        require(same and same_raw,
                f"auction {tag}: kernel and plain version differ")
        if tag in ("capped", "ties capped", "alike", "past capacity"):
            require(n_capped == b, f"the {tag} case did not hit the cap")
        if tag not in ("train", "capped"):
            continue
        ms = time_ms(lambda: AS.auction_assignment(cost, valid,
                                                   max_rounds=16))
        dev_ms = device_ms_by_kernel(lambda: AS.auction_assignment(
            cost, valid, max_rounds=16))
        print(f"[rtdetr-train-kernels] auction {tag}: kernel {ms} ms by "
              f"events; device ms by kernel "
              f"{[(short_kernel_name(k), n, d) for d, n, k in dev_ms]}")
        auction[tag] = dict(ms=ms, device_ms=dev_ms[0][0], rounds=rounds)
        if tag != "train":
            continue
        plain_ms = time_ms(lambda: AS.auction_assignment_plain(
            cost, valid, max_rounds=16), iters=3, warmup=1)
        print(f"[rtdetr-train-kernels] auction train shape: plain {plain_ms} "
              f"ms (a tensor pass and a host sync per round); no single "
              f"PyTorch call computes it")
        # reads the cost once, writes the assignment; a dozen compares per
        # (GT, query) pair and round at most
        auction["float32"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            **work("float32", cost.numel() * 4 + valid.numel() + b * q * 4,
                   16 * 4 * n_valid * q * b))
    auction["float32"]["capped_ms"] = auction.pop("capped")
    auction["float32"]["train_device"] = auction.pop("train")

    # K1 branch by branch at the YOLOv8m step's batch: all 16 images clean,
    # then all noise, all blur, all lowres (each branch's output held as in
    # check_corrupt: clean and blur bit-exact, noise and lowres within 1)
    img = torch.floor(torch.rand(TRAIN_BATCH, IMG_SIZE, IMG_SIZE, 3,
                                 device=dev, generator=g) * 256)
    seeds = torch.randint(0, 2 ** 30, (TRAIN_BATCH,), device=dev,
                          generator=g, dtype=torch.int32)
    bound_ms = bound(work("float32", 2 * img.numel() * 4, 0))[0]
    by_branch = {}
    for name, branch in (("clean", 0), ("noise", 1), ("blur", 2),
                         ("lowres", 3)):
        choice = torch.full((TRAIN_BATCH,), branch, device=dev,
                            dtype=torch.int32)
        out, _ = FC.fused_random_corruption(img, None, choice=choice,
                                            seeds=seeds)
        err = (out - FC.fused_corruption_reference(img, choice, seeds)
               ).abs().max().item()
        require(err <= (0 if branch in (0, 2) else 1),
                f"corrupt {name}: max abs diff {err}")
        del out
        ms = time_ms(lambda: FC.fused_random_corruption(
            img, None, choice=choice, seeds=seeds))
        dev_ms = device_ms_by_kernel(lambda: FC.fused_random_corruption(
            img, None, choice=choice, seeds=seeds))[0][0]
        by_branch[name] = dict(ms=ms, device_ms=dev_ms, max_abs_err=err)
        print(f"[rtdetr-train-kernels] corrupt {name} "
              f"{tuple(img.shape)}: max abs diff {err}; kernel {ms} ms by "
              f"events, {dev_ms} ms device; bound {bound_ms} ms (bytes)")
    results["corrupt_by_branch"] = by_branch
    del img
    results["auction"] = auction

    # the new wrappers refuse CUDA tensors they do not take
    x = torch.rand(1, 8, 8, 3, device=dev, generator=g)
    values, loc, attn = deform_inputs(g, ((4, 4), (2, 2)), 1, 3, 2, 8, 2, dev)
    cost = torch.zeros(1, 4, 3, device=dev)
    valid = torch.ones(1, 3, dtype=torch.bool, device=dev)
    counters = (ST.stem_fused, ST.stem_fused_backward,
                DF.ms_deform_attn_backward, AS.auction_assignment)
    bad = (lambda: ST.stem_fused(x[:, :6], *params),
           lambda: ST.stem_fused(x.half(), *params),
           lambda: ST.stem_fused(x, params[0].cpu(), *params[1:]),
           lambda: DF.ms_deform_attn_backward(values, ((4, 4), (2, 2)), loc,
                                              attn, values[:, :2]),
           lambda: AS.auction_assignment(cost.double(), valid),
           lambda: AS.auction_assignment(cost, valid[:, :2]),
           lambda: AS.auction_assignment(cost, valid.cpu()))
    require_refused("rtdetr-train-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


def phase_rtdetr_train_model_check(dev):
    """Forward, loss and backward of one RT-DETR-L f32 train batch at 128
    px, batch 2, on the card (kernels, TF32 off) and on the CPU (plain
    versions): the same weights, images, boxes and denoising queries (drawn
    once on the CPU). The encoder score kernel is zeroed, so every valid
    anchor scores exactly its bias and both devices select the same
    anchors in the same order (near-tied scores would reorder the queries,
    and the auction's eps-optimal result depends on their order).

    Card and CPU costs differ by f32 noise, which can flip a near-tied
    match and with it a tenth of the loss's gradient. So the card runs
    first with its own matcher (K6) and the CPU run takes the card's seven
    assignments instead of solving its own; every one of them is also
    solved again by the plain version on the CPU from the card's own cost
    tensor and must be equal.

    What is held: the loss within 2e-3 relative; those assignments; the
    gradients by direction and size: through ~120 train-mode BatchNorms
    f32 noise grows to ~1e-3 of
    the deep pre-activations, which flips that share of the ReLU masks and
    moves every leaf's gradient by a few per cent in L2 (card vs CPU as
    CPU vs the JAX reference, tests/test_torch_rtdetr_train_step.py), so:
    global cosine >= 0.99, and for each leaf that carries more than 1e-4
    of the gradient's norm a relative L2 error <= 0.15. This phase holds
    the wiring on the card (which wrapper gets which tensors), not the
    last digits: that no term of the gradient is missing is shown without
    the noise, in float64, by the CPU test named above (every leaf within
    1e-6 of the reference), and each kernel is held against its plain
    version at this path's shapes in phase_rtdetr_train_kernels. A control
    is printed beside it: the card once more with the plain versions in
    the wrappers' place, whose distance from the CPU run is f32 noise
    alone."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.models import layers as L
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    size, nb = 128, 2
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 5), nb, size,
                                     8, 16)
    x = torch.from_numpy(images).float() / 255.0
    gb, gc = torch.from_numpy(gb), torch.from_numpy(gc)
    gt_n = RT.to_norm_cxcywh(gb, size)
    dn, dn_gt, dn_active = RT.build_dn_queries(
        gt_n, gc, torch.Generator().manual_seed(SEED), max_gt=8)

    solved = []
    solve = RT.auction_assignment

    def recording(cost, valid, **kw):
        owner, capped = solve(cost, valid, **kw)
        solved.append((cost, valid, owner, capped, kw))
        return owner, capped

    def replaying(cost, valid, **kw):
        _, _, owner, capped, _ = solved[replaying.calls]
        replaying.calls += 1
        return owner.to(cost.device), capped.to(cost.device)

    replaying.calls = 0

    # the control: the card again with every wrapper replaced by its plain
    # version, so its distance from the CPU run is f32 noise alone
    plain = ((R, "stem_fused", ST.stem_train_reference),
             (L, "conv3x3", C.conv3x3_reference),
             (R, "ms_deform_attn_slots", DF.ms_deform_attn_ref))
    kernel_versions = [(mod, attr, getattr(mod, attr))
                       for mod, attr, _ in plain]

    res = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu")),
                         ("card-plain", dev)):
        model = R.create(6, torch.float32, device,
                         torch.Generator().manual_seed(SEED), train=True)
        with torch.no_grad():
            model.model[28].enc_score_head.weight.zero_()
        to = lambda t: t.to(device)
        RT.auction_assignment = recording if name == "card" else replaying
        replaying.calls = 0
        for mod, attr, fn in plain if name == "card-plain" else ():
            setattr(mod, attr, fn)
        try:
            with torch.backends.cudnn.flags(allow_tf32=False):
                outs = model(to(x), {k: to(v) for k, v in dn.items()})
                loss, metrics = RT.rtdetr_loss(outs, to(gb), to(gc), size)
                for li in range(outs["dn_logits"].shape[0]):
                    loss = loss + RT.dn_loss(
                        outs["dn_logits"][li], outs["dn_boxes"][li],
                        to(dn_gt), to(dn_active), to(gt_n), to(gc))
                loss.backward()
        finally:
            RT.auction_assignment = solve
            for mod, attr, fn in kernel_versions:
                setattr(mod, attr, fn)
        require(len(solved) == 7
                and replaying.calls == (0 if name == "card" else 7),
                f"{name}: {len(solved)} matchings solved, "
                f"{replaying.calls} replayed, not 7")
        res[name] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().double()
                      for n, p in model.named_parameters()})
    (lc, mc, gcard), (lr, mr, gref) = res["card"], res["cpu"]
    for i, (cost, valid, owner, capped, kw) in enumerate(solved):
        powner, pcapped = AS.auction_assignment(cost.cpu(), valid.cpu(), **kw)
        require(torch.equal(owner.cpu(), powner)
                and torch.equal(capped.cpu(), pcapped),
                f"matching {i}: K6 and the plain version differ on the "
                f"card's cost tensor")
    loss_rel = abs(lc - lr) / abs(lr)
    require(gcard.keys() == gref.keys(), "gradient leaves differ")
    norms = {n: r.norm().item() for n, r in gref.items()}
    total = math.sqrt(sum(v * v for v in norms.values()))

    def against_cpu(grads):
        """(cosine, norm, worst relative L2 error over the significant
        leaves, its name, their count) of grads against the CPU run's."""
        dot = sum((grads[n] * r).sum().item() for n, r in gref.items())
        size = math.sqrt(sum(g.norm().item() ** 2 for g in grads.values()))
        errs = {n: ((grads[n] - r).norm() / norms[n]).item()
                for n, r in gref.items() if norms[n] > 1e-4 * total}
        name = max(errs, key=errs.get)
        return dot / (total * size), size, errs[name], name, len(errs)

    cos, card_total, worst, worst_name, significant = against_cpu(gcard)
    pcos, _, pworst, pworst_name, _ = against_cpu(res["card-plain"][2])
    print(f"[rtdetr-train-model] RT-DETR-L f32 128px train batch card vs "
          f"CPU: loss {lc} vs {lr} (rel {loss_rel}, tol 2e-3); metrics {mc} "
          f"vs {mr}; 7 matchings of K6 equal to the plain version on the "
          f"card's costs (capped image-matchings {mc['matcher_capped']}); "
          f"gradient cosine {cos} (>= 0.99), norm {card_total} vs {total}; "
          f"worst relative L2 error {worst} at {worst_name} over "
          f"{significant} significant of {len(gref)} leaves (tol 0.15); "
          f"control, the card with the plain versions vs CPU: loss "
          f"{res['card-plain'][0]}, cosine {pcos}, worst relative L2 error "
          f"{pworst} at {pworst_name}")
    require(loss_rel <= 2e-3, f"train loss differs by {loss_rel}")
    require(math.isfinite(cos) and cos >= 0.99,
            f"gradient cosine {cos} < 0.99")
    require(abs(card_total - total) <= 0.05 * total, "gradient norms differ")
    require(math.isfinite(worst) and worst <= 0.15,
            f"gradient {worst_name} differs by {worst} in L2")


def phase_rtdetr_training(dev):
    """The RT-DETR-L training slice through the port's entry points;
    returns the launch counts of the timed steps."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    nb = RTDETR_TRAIN_BATCH
    model = R.create(6, torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED), train=True,
                     bn_dtype=torch.bfloat16)
    tx, _ = RT.make_optimizer()
    state = RT.init_state(model, tx)
    step = RT.make_train_step(IMG_SIZE, CorruptionConfig(), augment=True,
                              base_augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED), nb,
                                     IMG_SIZE, GT_PER_IMAGE, MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))
    gen = torch.Generator(dev).manual_seed(SEED)

    m = step(state, images, gb, gc, gen)          # warm-up, off the count
    torch.cuda.synchronize()
    require(math.isfinite(m["loss"].item()), "warm-up loss not finite")
    bns = (model.model[0].stem1.bn, model.model[0].stem3.bn,
           model.model[1].m[0].bn, model.model[28].input_proj[0][1])
    stats0 = [(bn.running_mean.clone(), bn.running_var.clone())
              for bn in bns]
    ema0 = {n: e.clone() for n, e in state.ema.items()}

    counters = {"corrupt": FC.fused_random_corruption,
                "hgstem_train": ST.stem_fused,
                "hgstem_bwd": ST.stem_fused_backward,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad,
                "ms_deform_attn": DF.ms_deform_attn_slots,
                "ms_deform_attn_bwd": DF.ms_deform_attn_backward,
                "auction": AS.auction_assignment}
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times, matcher_capped = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, images, gb, gc, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: v.item() for k, v in m.items()}
        matcher_capped.append(vals["matcher_capped"])
        print(f"[rtdetr-train] step {i}: {vals}")
        require(math.isfinite(vals["loss"]) and
                math.isfinite(vals["grad_norm"]),
                f"step {i}: loss or grad_norm not finite")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[rtdetr-train] matcher_capped of the timed steps (image-"
          f"matchings K6 completed greedily, of 7 x {nb}): {matcher_capped}")

    per_step = {"corrupt": 1, "hgstem_train": 1, "hgstem_bwd": 1,
                "conv3x3": 12, "conv3x3_wgrad": 6, "ms_deform_attn": 6,
                "ms_deform_attn_bwd": 6, "auction": 7}
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"[rtdetr-train] launches {launches} expected {expect}")
    require(launches == expect, f"launch counts {launches} != {expect}")
    moved = [not torch.equal(a, bn.running_mean)
             and not torch.equal(b, bn.running_var)
             for (a, b), bn in zip(stats0, bns)]
    ema_moved = sum(not torch.equal(ema0[n], e) for n, e in state.ema.items())
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    print(f"[rtdetr-train] BN running stats moved {moved}; EMA leaves moved "
          f"{ema_moved}/{len(ema0)}; parameters without a gradient "
          f"{len(no_grad)}")
    require(all(moved), "BatchNorm running statistics did not move")
    require(ema_moved > 0, "the EMA did not move")
    require(not no_grad, f"parameters without a gradient: {no_grad[:5]}")
    ms = statistics.median(times)
    print(f"[rtdetr-train] RT-DETR-L bf16 1024px batch {nb}, augment + "
          f"HSV/flip + CDN (428 queries): step ms {times} median {ms} = "
          f"{nb / (ms / 1e3)} images/s; peak memory {peak} bytes "
          f"({peak / 2 ** 30} GiB)")
    return launches


def touched_rows(DF, loc, shapes, hw, heads):
    """(distinct (batch, cell, head) value rows the in-map taps of `loc`
    touch, number of in-map taps): what a run's data makes a gather read."""
    import torch
    b = loc.shape[0]
    idx, wgt = DF.tap_geometry(loc, shapes)
    live = wgt != 0
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1, 1, 1)
    hi = torch.arange(heads, device=loc.device).view(1, 1, heads, 1, 1, 1)
    rows = torch.unique(((bi * hw + idx) * heads + hi)[live]).numel()
    return rows, int(live.sum().item())


def touched_sectors_t(DF, loc, shapes, hw, heads, dh, elt):
    """Distinct 32-byte sectors of values_t (B, heads, dh, HW) that hold an
    element the in-map taps of `loc` touch: what any reader of that layout
    in place must fetch."""
    import torch
    b = loc.shape[0]
    idx, wgt = DF.tap_geometry(loc, shapes)
    live = wgt != 0
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1, 1, 1)
    hi = torch.arange(heads, device=loc.device).view(1, 1, heads, 1, 1, 1)
    keys = torch.unique(((bi * heads + hi) * hw + idx)[live])
    rows, cell = keys // hw, keys % hw                 # (batch, head), cell
    ch = torch.arange(dh, device=loc.device)
    nbytes = ((rows[:, None] * dh + ch) * hw + cell[:, None]) * elt
    return torch.unique(nbytes // 32).numel()


def grid_sample_deform(F, values_t, shapes, loc, attn):
    """``ms_deform_attn_t``'s forward from ``grid_sample``: each level's map
    a (B * heads, dh, H_l, W_l) view of values_t (grid_sample's own layout),
    sampled at the level's points (grid 2 loc - 1, align_corners False:
    pixel loc * size - 0.5), weighted by attn and summed over points and
    levels. Returns (B, Q, heads, dh) in values_t's dtype."""
    b, heads, dh, hw = values_t.shape
    q, p = loc.shape[1], loc.shape[4]
    vt = values_t.reshape(b * heads, dh, hw)
    out, off = 0, 0
    for l, (h, w) in enumerate(shapes):
        vm = vt[:, :, off:off + h * w].view(b * heads, dh, h, w)
        grid = (2 * loc[:, :, :, l] - 1).permute(0, 2, 1, 3, 4).reshape(
            b * heads, q, p, 2).to(values_t.dtype)
        sampled = F.grid_sample(vm, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
        a = attn[:, :, :, l].permute(0, 2, 1, 3).reshape(b * heads, 1, q, p)
        out = out + (sampled * a.to(values_t.dtype)).sum(-1)  # (B*h, dh, Q)
        off += h * w
    return out.reshape(b, heads, dh, q).permute(0, 3, 1, 2)


def values_t_yardsticks(F, DF, row, layouts, vd, ref, shapes, loc, attn,
                        taps, dh):
    """Adds to K5-g2 forward's summary row `row` the layouts' times, the
    bound of values_t (the 32-byte sectors holding a touched element, with
    loc, attn and the f32 out) and the library's forward on values_t's
    layout (:func:`grid_sample_deform`, held against the f32 reference
    within 1e-4 x max|ref| in f32)."""
    name = str(vd.dtype).split(".")[-1]
    elt = esize(vd.dtype)
    _, hw, heads, _ = vd.shape
    vt = DF.values_to_t(vd)
    sectors = touched_sectors_t(DF, loc, shapes, hw, heads, dh, elt)
    io = (loc.numel() + attn.numel() + ref.numel()) * 4
    t_bound = bound(work(name, sectors * 32 + io, 2 * taps * dh))[0]
    log = []
    lib_out = grid_sample_deform(F, vt, shapes, loc, attn)
    if elt == 4:
        check("grid_sample composition f32 out", lib_out, ref, 1e-4, log)
    gs_ms = time_ms(lambda: grid_sample_deform(F, vt, shapes, loc, attn))
    gs_dev = sum(d for d, _ in launch_parts(
        lambda: grid_sample_deform(F, vt, shapes, loc, attn))) \
        or "not measured"
    row.update(ms_by_layout=layouts, values_t_bound_ms=t_bound,
               values_t_sectors=sectors, grid_sample_fwd_ms=gs_ms,
               grid_sample_fwd_device_ms=gs_dev)
    print(f"[sorted-kernels] {name} values_t: {sectors} distinct 32-byte "
          f"sectors hold a touched element, bound {t_bound} ms (the row "
          f"bound of values: {bound(row)[0]} ms); grid_sample level by "
          f"level on (B * heads, dh, H, W) views of values_t + the "
          f"attention-weighted sum, forward only: {gs_ms} ms by events, "
          f"{gs_dev} ms device; {'; '.join(log)}")


def grid_sample_level(F, v, sx, sy):
    """``bilinear_sample(v, sx, sy)`` as one ``grid_sample`` call: v (B, H,
    W, heads, dh) as (B * heads, dh, H, W), the samples as a (B * heads, Q,
    P, 2) grid in [-1, 1] (pixel = (g + 1) * size / 2 - 0.5). Returns (B,
    Q, heads, P, dh)."""
    import torch
    b, h, w, heads, dh = v.shape
    q, p = sx.shape[1], sx.shape[3]
    vm = v.permute(0, 3, 4, 1, 2).reshape(b * heads, dh, h, w)
    grid = torch.stack([(sx + 0.5) * (2.0 / w) - 1, (sy + 0.5) * (2.0 / h)
                        - 1], -1).permute(0, 2, 1, 3, 4).reshape(
        b * heads, q, p, 2).to(v.dtype)
    out = F.grid_sample(vm, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)           # (B*heads, dh, Q, P)
    return out.reshape(b, heads, dh, q, p).permute(0, 3, 1, 4, 2)


def phase_sorted_kernels(dev):
    """K5-g2 forward and backward (both layouts) and K5-g1 vs their plain
    versions, at the RT-DETR-L decoder's shapes and at one odd shape
    (levels (6, 10) and (3, 5), 7 queries, samples outside the maps, tap
    counts that are no multiple of 32, maps under 2048 cells). Tolerances,
    each x max|ref|. K5-g2 forward: 1e-4 for f32 and for bf16 values alike
    (the out is f32, so both are the plain version's f32 products summed in
    another order); bit for bit K5 forward's out (f32; bf16 after one
    rounding of K5-g2's), values_t's out that of values, and a query
    permutation's the permuted out. K5-g2 backward against the plain
    backward in f32 on the same values: d(values) 1e-4 in f32 and 1e-2 in
    bf16 (one rounding of the f32 sum), d(loc) and d(attn) 1e-4 and 1e-3;
    the backward also on clustered samples at the train step's shapes.
    K5-g1 against ``index_add_``: 1e-4 (f32 only; the same terms, perhaps
    in another order); ``bilinear_sample`` against the autograd of its
    plain version in f32: out 1e-4, d(v) 1e-4 in f32 and 1e-2 for a bf16
    map, d(sx) and d(sy) 1e-4 and 1e-3. Every backward runs twice and must
    return the same bits. ``grid_sample`` computes ``bilinear_sample``'s
    function and is timed beside it; its f32 output must agree within
    1e-4, as must K5-g2 forward's ``grid_sample`` composition."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import deform as DF

    g = torch.Generator(dev).manual_seed(SEED + 5)
    results = {}
    tag = "[sorted-kernels]"
    q_train = RTDETR_QUERIES + 2 * 2 * 32

    fwd, bwd, stamp_ms = {}, {}, {}
    for shapes, b, q, heads, dh, pts, clustered in (
            (RTDETR_LEVELS, BATCH, RTDETR_QUERIES, RTDETR_HEADS, RTDETR_DH,
             RTDETR_POINTS, False),
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS, False),
            (RTDETR_LEVELS, RTDETR_TRAIN_BATCH, q_train, RTDETR_HEADS,
             RTDETR_DH, RTDETR_POINTS, True),
            (((6, 10), (3, 5)), 2, 7, 3, 32, 2, False)):
        values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh, pts,
                                          dev, clustered)
        dout = torch.randn(b, q, heads, dh, device=dev, generator=g)
        hw = values.shape[1]
        timed = q == q_train
        what = "clustered" if clustered else "uniform"
        if timed:
            rows, taps = touched_rows(DF, loc, shapes, hw, heads)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            name = str(dtype).split(".")[-1]
            elt = esize(dtype)
            vd = values.to(dtype)
            ltol = 1e-4 if dtype == torch.float32 else 1e-3
            ref = DF.ms_deform_attn_ref(vd.float(), shapes, loc, attn)
            rdv, rdloc, rdattn = DF.ms_deform_attn_backward_ref(
                vd.float(), shapes, loc, attn, dout)
            # K5-g2 forward is K5's gather with an f32 out: K5's bits in
            # f32, K5's bits after one rounding in bf16; values_t is relaid
            # into rows and gathered the same way; any query order
            out = DF.ms_deform_attn(vd, shapes, loc, attn)
            require(torch.equal(out.to(dtype), DF.ms_deform_attn_slots(
                vd, shapes, loc, attn)),
                f"K5-g2 forward ({name}) is not K5's gather bit for bit")
            require(torch.equal(DF.ms_deform_attn_t(
                DF.values_to_t(vd), shapes, loc, attn), out),
                f"K5-g2 forward on values_t ({name}) does not give the "
                f"bits of values")
            perm = torch.randperm(q, device=dev, generator=g)
            require(torch.equal(DF.ms_deform_attn(
                vd, shapes, loc[:, perm].contiguous(),
                attn[:, perm].contiguous()), out[:, perm]),
                f"K5-g2 forward ({name}) changes bits with the query order")
            bits = (f"K5-g2 forward {name} {what}: K5's bits "
                    f"{'after one rounding' if elt == 2 else 'exactly'}, "
                    f"values_t = values, query order: same bits")
            del out
            layouts = {}
            for transposed in (False, True):
                layout = "values_t" if transposed else "values"
                entry = DF.ms_deform_attn_t if transposed \
                    else DF.ms_deform_attn
                given = DF.values_to_t(vd) if transposed else vd
                log = []
                out = entry(given, shapes, loc, attn)
                require(out.dtype == torch.float32, "K5-g2 out is not f32")
                ferr = check(f"ms_deform_attn_sorted {layout} {name} levels "
                             f"{shapes} Q {q}", out, ref, 1e-4, log)
                grads = DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed)
                require(grads[0].dtype == dtype
                        and grads[0].shape == given.shape,
                        "K5-g2 d(values) is not in values' dtype and layout")
                dv = DF.values_from_t(grads[0]) if transposed else grads[0]
                berr = max(check(f"bwd d(values) {name}", dv, rdv, tol, log),
                           check(f"d(loc) {name}", grads[1], rdloc, ltol,
                                 log),
                           check(f"d(attn) {name}", grads[2], rdattn, ltol,
                                 log))
                again = DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed)
                require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                        f"K5-g2 backward ({layout}, {name}) is not "
                        f"deterministic")
                del out, grads, again, dv
                if not timed:
                    print(f"{tag} {'; '.join(log)}; second backward: "
                          f"identical bits; {bits}")
                    continue
                ms = time_ms(lambda: entry(given, shapes, loc, attn))
                # device ms by launch; the peak memory a call adds: out, and
                # for values_t the workspace the relayout fills
                parts = launch_parts(lambda: entry(given, shapes, loc, attn))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                entry(given, shapes, loc, attn)
                torch.cuda.synchronize()
                added = torch.cuda.max_memory_allocated() - base
                bms = time_ms(lambda: DF.ms_deform_attn_sorted_backward(
                    given, shapes, loc, attn, dout, transposed))
                layouts[layout] = dict(
                    ms=ms, peak_bytes=added,
                    device_ms=[(short_kernel_name(k), d) for d, k in parts]
                    or "not measured")
                print(f"{tag} {'; '.join(log)}; second backward: identical "
                      f"bits; forward {ms} ms by events, device ms by "
                      f"launch {layouts[layout]['device_ms']}, the call "
                      f"adds {added} bytes of peak memory; backward {bms} "
                      f"ms (taps kernel + owner scatter, {what} samples)")
                if transposed or clustered:
                    continue
                plain_ms = time_ms(lambda: DF.ms_deform_attn_ref(
                    vd, shapes, loc, attn))
                bplain = time_ms(lambda: DF.ms_deform_attn_backward_ref(
                    vd, shapes, loc, attn, dout))
                print(f"{tag} {name} plain forward {plain_ms} ms "
                      f"(torch.gather + elementwise), plain backward "
                      f"{bplain} ms (gather + index_add_); {taps} in-map "
                      f"taps touch {rows} distinct rows of {dh * elt} bytes")
                io = (loc.numel() + attn.numel() + dout.numel()) * 4
                fwd[name] = dict(max_abs_err=ferr, ms=ms, plain_ms=plain_ms,
                                 **work(name, rows * dh * elt + io,
                                        2 * taps * dh))
                bwd[name] = dict(
                    max_abs_err=berr, ms=bms, plain_ms=bplain,
                    **work(name, (rows * dh + values.numel()) * elt + 2 * io
                           - dout.numel() * 4, 4 * taps * dh))
            if timed:
                print(f"{tag} {bits}")
                if clustered:
                    fwd[name]["clustered"] = layouts
                else:
                    values_t_yardsticks(F, DF, fwd[name], layouts, vd, ref,
                                        shapes, loc, attn, taps, dh)
            del vd, ref, rdv, rdloc, rdattn
        del values, loc, attn, dout
    results["ms_deform_attn_sorted"] = fwd
    results["ms_deform_attn_sorted_bwd"] = bwd
    torch.cuda.empty_cache()

    # K5-g1, one level at a time: the three RT-DETR-L levels at 428 and 300
    # queries (T = Q * 4 points * 4 taps), uniform samples and, at 428,
    # clustered ones; and (6, 10) with 7 queries. gw in the reference's
    # layout and in the row layout bilinear_sample's backward builds.
    stamp = {}
    cases = [(BATCH, q, RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS, h, w, False)
             for q in (q_train, RTDETR_QUERIES) for h, w in RTDETR_LEVELS]
    cases += [(BATCH, q_train, RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS, h, w,
               True) for h, w in RTDETR_LEVELS]
    for b, q, heads, dh, pts, h, w, clustered in cases + [
            (2, 7, 3, 32, 2, 6, 10, False)]:
        hw = h * w
        if clustered:
            loc = clustered_loc(g, b, q, heads, 1, pts, dev)[:, :, :, 0]
            sx, sy = loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5
        else:
            sx = torch.rand(b, q, heads, pts, device=dev, generator=g) \
                * (w * 1.2) - 0.1 * w - 0.5
            sy = torch.rand(b, q, heads, pts, device=dev, generator=g) \
                * (h * 1.2) - 0.1 * h - 0.5
        idx = DF.tap_geometry(
            torch.stack([(sx + 0.5) / w, (sy + 0.5) / h], -1)[:, :, :, None],
            ((h, w),))[0]                              # (B,Q,heads,1,P,4)
        idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(b, heads, -1).int()
        t = idx.shape[-1]
        gw = torch.randn(b, heads, dh, t, device=dev, generator=g)
        rows_gw = gw.transpose(2, 3).contiguous().transpose(2, 3)
        what = "clustered" if clustered else "uniform"
        log = []
        dv = DF.stamp_scatter(idx, gw, hw)
        ref = DF.stamp_scatter_ref(idx, gw, hw)
        err = check(f"stamp_scatter f32 hw {hw} T {t} rows {b * heads} "
                    f"{what}", dv, ref, 1e-4, log)
        require(torch.equal(DF.stamp_scatter(idx, gw, hw), dv),
                "K5-g1 is not deterministic")
        require(torch.equal(DF.stamp_scatter(idx, rows_gw, hw), dv),
                "K5-g1 in the row layout does not give the same bits")
        require(torch.equal(DF.stamp_scatter(idx.long(), gw, hw), dv),
                "K5-g1 with int64 idx does not give the same bits")
        wide = idx.long()[:, :, None, :].expand(-1, -1, dh, -1)

        def library():
            return torch.zeros(b, heads, dh, hw, device=dev).scatter_add_(
                3, wide, gw)
        check("scatter_add_", library(), dv, 1e-4, log)

        # bilinear_sample's three gradients through the kernel
        v = torch.randn(b, h, w, heads, dh, device=dev, generator=g)
        cot = torch.randn(b, q, heads, pts, dh, device=dev, generator=g)
        level_ms = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            if clustered:
                break
            name = str(dtype).split(".")[-1]
            stol = 1e-4 if dtype == torch.float32 else 1e-3
            leaves = [x.clone().requires_grad_()
                      for x in (v.to(dtype), sx, sy)]
            refs = [x.clone().requires_grad_()
                    for x in (v.to(dtype).float(), sx, sy)]
            out = DF.bilinear_sample(*leaves)
            rout = DF.bilinear_sample_ref(*refs)
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            rgrads = torch.autograd.grad(rout, refs, cot)
            check(f"bilinear_sample {name} out", out, rout.detach(), 1e-4,
                  log)
            check(f"d(v) {name}", grads[0], rgrads[0], tol, log)
            check(f"d(sx) {name}", grads[1], rgrads[1], stol, log)
            check(f"d(sy) {name}", grads[2], rgrads[2], stol, log)
            again = torch.autograd.grad(out, leaves, cot)
            require(all(torch.equal(a, c) for a, c in zip(grads, again)),
                    f"bilinear_sample's backward ({name}) is not "
                    f"deterministic")
            lib_out = grid_sample_level(F, leaves[0], sx, sy)
            if dtype == torch.float32:
                check("grid_sample f32 out", lib_out, rout.detach(), 1e-4,
                      log)
            if q == q_train:
                def ours():
                    o = DF.bilinear_sample(*leaves)
                    return torch.autograd.grad(o, leaves, cot)

                def theirs():
                    o = grid_sample_level(F, leaves[0], leaves[1], leaves[2])
                    return torch.autograd.grad(o, leaves, cot.to(o.dtype))
                level_ms[name] = (time_ms(ours), time_ms(theirs))
            del leaves, refs, out, rout, grads, rgrads, again, lib_out
        if q != q_train:
            print(f"{tag} {'; '.join(log)}; second run, row layout and "
                  f"int64 idx: identical bits")
            continue
        ms = time_ms(lambda: DF.stamp_scatter(idx, gw, hw))
        rows_ms = time_ms(lambda: DF.stamp_scatter(idx, rows_gw, hw))
        lib_ms = time_ms(library)
        if clustered:
            print(f"{tag} {'; '.join(log)}; identical bits as above; "
                  f"stamp_scatter {ms} ms (reference layout) {rows_ms} ms "
                  f"(row layout; uniform: {stamp_ms[hw]}) library {lib_ms} "
                  f"ms (zeros + scatter_add_)")
            continue
        plain_ms = time_ms(lambda: DF.stamp_scatter_ref(idx, gw, hw))
        stamp_ms[hw] = (ms, rows_ms)
        print(f"{tag} {'; '.join(log)}; second run, row layout and int64 "
              f"idx: identical bits; stamp_scatter {ms} ms (reference "
              f"layout) {rows_ms} ms (row layout) plain {plain_ms} ms "
              f"(index_add_ with its layout copies) library {lib_ms} ms "
              f"(zeros + scatter_add_); bilinear_sample forward + backward "
              f"vs grid_sample forward + backward, ms: {level_ms}")
        if hw == RTDETR_LEVELS[0][0] * RTDETR_LEVELS[0][1]:
            # the row layout is the one bilinear_sample's backward hands it
            stamp["float32"] = dict(
                max_abs_err=err, ms=rows_ms, plain_ms=plain_ms,
                ms_by_layout={"reference": ms, "rows": rows_ms},
                **work("float32", (idx.numel() + gw.numel() + dv.numel()) * 4,
                       gw.numel(), lib_ms))
        del idx, gw, rows_gw, dv, ref, wide, v, cot
    results["stamp_scatter"] = stamp
    torch.cuda.empty_cache()

    # the new wrappers refuse CUDA tensors they do not take
    shapes = ((4, 4), (2, 2))
    values, loc, attn = deform_inputs(g, shapes, 1, 3, 2, 8, 2, dev)
    idx = torch.zeros(1, 2, 5, dtype=torch.int32, device=dev)
    gw = torch.zeros(1, 2, 8, 5, device=dev)
    counters = (DF.ms_deform_attn_sorted_forward,
                DF.ms_deform_attn_sorted_backward, DF.stamp_scatter)
    bad = (lambda: DF.ms_deform_attn(values.half(), shapes, loc, attn),
           lambda: DF.ms_deform_attn_t(values, shapes, loc, attn),
           lambda: DF.ms_deform_attn_t(values.permute(0, 2, 3, 1), shapes,
                                       loc, attn),
           lambda: DF.ms_deform_attn(values, ((4, 4), (2, 3)), loc, attn),
           lambda: DF.ms_deform_attn_sorted_backward(values, shapes, loc,
                                                     attn, values[:, :2]),
           lambda: DF.stamp_scatter(idx, gw.double(), 16),
           lambda: DF.stamp_scatter(idx[:, :, :4], gw, 16),
           lambda: DF.stamp_scatter(idx.cpu(), gw, 16),
           lambda: DF.stamp_scatter(idx, torch.zeros(1, 2, 8, 10, device=dev)
                                    [..., ::2], 16),
           lambda: DF.bilinear_sample(values.reshape(1, 4, 5, 2, 8),
                                      loc[..., 0, :, 0].double(),
                                      loc[..., 0, :, 1]))
    require_refused("sorted-kernels", bad, counters)
    torch.cuda.synchronize()
    return results


DECODER_LAYERS = 6


def phase_deform_generations(dev):
    """The RT-DETR-L decoder's sampling workload (6 layers, batch 8, 428
    queries, 8 heads x 32, 3 levels x 4 points) through the public entry
    point of each earlier generation, forward and backward: ms_deform_attn,
    ms_deform_attn_t and the per-level composition over bilinear_sample.
    Every output and gradient is held against ms_deform_attn_slots (K5) on
    the same inputs: f32 within 1e-4 x max|ref|; bf16 values at K5's bf16
    bar, out 1e-2 (K5 rounds its out to bf16, these return f32), d(values)
    2e-2 (two bf16 roundings of f32 sums taken in another order), d(loc)
    and d(attn) 1e-3. Returns the launch counts of the run."""
    import torch
    from robust_object_detection_tpu_torch.ops import deform as DF

    shapes = RTDETR_LEVELS
    b, q, heads, dh, pts = (RTDETR_TRAIN_BATCH, RTDETR_QUERIES + 2 * 2 * 32,
                            RTDETR_HEADS, RTDETR_DH, RTDETR_POINTS)
    counters = {"ms_deform_attn_sorted": DF.ms_deform_attn_sorted_forward,
                "ms_deform_attn_sorted_bwd":
                    DF.ms_deform_attn_sorted_backward,
                "stamp_scatter": DF.stamp_scatter}
    total = {k: 0 for k in counters}

    def per_level(values, loc, attn):
        out, off = 0, 0
        for l, (h, w) in enumerate(shapes):
            v = values[:, off:off + h * w].reshape(b, h, w, heads, dh)
            sampled = DF.bilinear_sample(v, loc[..., l, :, 0] * w - 0.5,
                                         loc[..., l, :, 1] * h - 0.5)
            out = out + (sampled * attn[..., l, :, None]).sum(-2)
            off += h * w
        return out

    generations = (
        ("ms_deform_attn", lambda v: v, lambda d: d,
         lambda v, l, a: DF.ms_deform_attn(v, shapes, l, a)),
        ("ms_deform_attn_t", DF.values_to_t, DF.values_from_t,
         lambda v, l, a: DF.ms_deform_attn_t(v, shapes, l, a)),
        ("bilinear_sample x 3 levels", lambda v: v, lambda d: d, per_level))

    def slots(v, l, a):
        return DF.ms_deform_attn_slots(v, shapes, l, a)

    def leaves_of(values, loc, attn):
        return [t.clone().requires_grad_() for t in (values, loc, attn)]

    def run(fn, leaves, dout):
        out = fn(*leaves)
        out.backward(dout.to(out.dtype))
        return [out.detach()] + [t.grad for t in leaves]

    def timed_layers(fn, lay, layers):
        """fn forward + backward on every layer: (results, ms per call);
        the leaves are laid out and cloned before the clock starts."""
        todo = [(leaves_of(lay(v), l, a), d) for v, l, a, d in layers]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [run(fn, leaves, d) for leaves, d in todo]
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3 / len(layers)

    for dtype, tols in ((torch.bfloat16, (1e-2, 2e-2, 1e-3, 1e-3)),
                        (torch.float32, (1e-4,) * 4)):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(dev).manual_seed(SEED + 6)
        layers = []
        for _ in range(DECODER_LAYERS):
            values, loc, attn = deform_inputs(g, shapes, b, q, heads, dh,
                                              pts, dev)
            dout = torch.randn(b, q, heads, dh, device=dev,
                               generator=g).to(dtype)
            layers.append((values.to(dtype), loc, attn, dout))
        del values
        # every generation and the yardstick once at full depth, off the
        # count: the allocator then holds the blocks the counted run needs
        for _, lay, _, fn in generations + (("", lambda v: v, None, slots),):
            timed_layers(fn, lay, layers)
        # the yardstick (K5) on the same inputs, before the count starts
        refs, k5_ms = timed_layers(slots, lambda v: v, layers)

        for f in counters.values():
            f.launches = 0
        outs, ms = {}, {}
        for gen, lay, unlay, fn in generations:
            got, ms[gen] = timed_layers(fn, lay, layers)
            outs[gen] = [[o, unlay(dv), dl, da] for o, dv, dl, da in got]
            del got
        launches = {k: f.launches for k, f in counters.items()}
        expect = {"ms_deform_attn_sorted": 2 * DECODER_LAYERS,
                  "ms_deform_attn_sorted_bwd": 2 * DECODER_LAYERS,
                  "stamp_scatter": len(shapes) * DECODER_LAYERS}
        print(f"[generations] {name}: launches {launches} expected {expect}")
        require(launches == expect, f"launch counts {launches} != {expect}")
        for k, n in launches.items():
            total[k] += n

        ms["ms_deform_attn_slots (K5)"] = k5_ms
        for gen, got in outs.items():
            log = []
            for layer_out, layer_ref in zip(got, refs):
                require(layer_out[0].dtype == torch.float32
                        and layer_out[1].dtype == dtype,
                        f"{gen}: out must be f32 and d(values) {name}")
                for what, o, r, tol in zip(("out", "d(values)", "d(loc)",
                                            "d(attn)"), layer_out, layer_ref,
                                           tols):
                    require(bool(torch.isfinite(o).all()),
                            f"{gen} {what} is not finite")
                    check(f"{what}", o, r.float(), tol, log)
            print(f"[generations] {name} {gen} vs K5, layer 0: "
                  f"{'; '.join(log[:4])}; {DECODER_LAYERS} layers passed")
        print(f"[generations] {name} values {tuple(layers[0][0].shape)} Q "
              f"{q}: ms per forward + backward call (host clock over "
              f"{DECODER_LAYERS} calls): {ms}")
        del layers, refs, outs
        torch.cuda.empty_cache()
    return total


# the tensor-core kernels: K3's (csrc/conv3x3_tc.cuh for bf16,
# csrc/conv3x3_tf32.cuh for f32 in split TF32), K2's and K4's stride-2
# convs (csrc/front_tc.cuh, csrc/front_tf32.cuh, each instantiated for
# both) and K4's 2x2 convs (csrc/stem_tc.cuh, csrc/stem_tf32.cuh)
TC_KERNELS = ("conv3x3_tc_kernel", "wgrad_tc_kernel", "conv3x3_tf32_kernel",
              "wgrad_tf32_kernel", "front_p1_kernel",
              "front_p2_kernel", "front_da1_tc_kernel", "front_dk2_tc_kernel",
              "front_dk1_tc_kernel", "stem2x2_tc_kernel",
              "stem2x2_dx_tc_kernel", "stem2x2_wgrad_tc_kernel",
              "front_p1_tf32_kernel", "front_p2_tf32_kernel",
              "front_da1_tf32_kernel", "front_dk2_tf32_kernel",
              "front_dk1_tf32_kernel", "stem2x2_tf32_kernel",
              "stem2x2_dx_tf32_kernel", "stem2x2_wgrad_tf32_kernel")


# The gather's instantiations with 16-byte value loads (K5 forward and
# K5-g2 forward, bf16 8 and f32 4 channels a load, out in values' dtype or
# f32), K5-g2's relayout of values_t, and the deformable backward's bf16
# taps kernels that read `values` in 16-byte pieces (VEC 8, STRIDED false),
# by substrings of their mangled names
K5_WIDE = (("ms_deform_attn_kernelI13__nv_bfloat16", "Li8E"),
           ("ms_deform_attn_kernelIff", "Li4E"),
           ("values_t_to_rows_kernel",),
           ("deform_bwd_taps_kernelI13__nv_bfloat16", "Li8ELb0E"))


UNET_CHANNELS = (32, 64, 128, 256)  # the reference's RestorationUNet
UNET_PEAK_TF32 = 494e12            # H100 SXM dense TF32 on the tensor cores


def unet_pair(dev, train=False, channels=UNET_CHANNELS):
    """The same seeded f32 U-Net on the CPU and on the card, its running
    statistics and biases redrawn from a seed (the stock init's 0 / 1 and
    zeros would make eval BatchNorm the identity)."""
    import torch
    from robust_object_detection_tpu_torch.models import unet as U

    cpu = U.create(channels, device=torch.device("cpu"),
                   generator=torch.Generator().manual_seed(SEED), train=train)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, t in cpu.state_dict().items():
            if name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    gpu = U.create(channels, device=dev, train=train)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def ssim_float64(a, b):
    """SSIM in float64 on the CPU by F.conv2d (depthwise, zero padding 5)
    with the reference's f32 window: an implementation independent of the
    port's shifted multiply-adds."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.ops import ssim as S

    a, b = (t.double().permute(0, 3, 1, 2) for t in (a, b))
    c = a.shape[1]
    w = torch.from_numpy(S.gaussian_window()).double()
    w = w.expand(c, 1, *w.shape).contiguous()

    def win(x):
        return F.conv2d(x, w, padding=w.shape[-1] // 2, groups=c)
    mu1, mu2 = win(a), win(b)
    s1, s2 = win(a * a) - mu1 ** 2, win(b * b) - mu2 ** 2
    s12 = win(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))).mean().item()


def phase_unet_model_check(dev):
    """The f32 U-Net on the card (cuDNN, TF32 off) against the same
    weights on the CPU at 1x256x256 and through restore_image at an odd
    250x333 (max abs err <= 1e-4); the u8 apply card vs CPU (at most 1
    LSB); SSIM and PSNR on the card, under TF32 flags switched on, against
    float64 on the CPU on an image near 0.9 with small noise (SSIM within
    1e-6), with the same SSIM through an f32 cuDNN conv in TF32 beside it
    to show what the check would catch."""
    import torch
    import torch.nn.functional as F
    from robust_object_detection_tpu_torch.models import unet as U
    from robust_object_detection_tpu_torch.ops import ssim as S

    cpu, gpu = unet_pair(dev)
    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.rand(1, 256, 256, 3, generator=g)
    odd = torch.rand(250, 333, 3, generator=g)
    xu = torch.randint(0, 256, (1, 256, 256, 3), generator=g,
                       dtype=torch.uint8)
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        e256 = (gpu(x.to(dev)).cpu() - cpu(x)).abs().max().item()
        out_odd = U.restore_image(gpu, odd.to(dev)).cpu()
        e_odd = (out_odd - U.restore_image(cpu, odd)).abs().max().item()
        d = (U.apply_u8(gpu, xu.to(dev)).cpu().int()
             - U.apply_u8(cpu, xu).int()).abs()
    print(f"[unet] f32 U-Net {UNET_CHANNELS} ({U.param_count(gpu)} "
          f"parameters) card vs CPU, TF32 off: max abs err 1x256x256 "
          f"{e256}, restore_image 250x333 {e_odd} (shape "
          f"{tuple(out_odd.shape)}; tol 1e-4); u8 apply: max diff "
          f"{d.max().item()} LSB, {int((d > 0).sum())} of {d.numel()} "
          f"bytes differ (tol 1 LSB)")
    require(e256 <= 1e-4 and e_odd <= 1e-4,
            f"U-Net card vs CPU: {e256}, {e_odd} > 1e-4")
    require(tuple(out_odd.shape) == (250, 333, 3), "restore_image shape")
    require(d.max().item() <= 1, "u8 apply differs by more than 1 LSB")

    a = 0.9 + 0.02 * torch.randn(2, 256, 256, 3, generator=g)
    b = a + 0.01 * torch.randn(a.shape, generator=g)
    ref_ssim = ssim_float64(a, b)
    ref_psnr = 10 * math.log10(1 / ((a.double() - b.double()) ** 2)
                               .mean().item())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(allow_tf32=True):
            s = S.ssim(a.to(dev), b.to(dev)).item()
            p = S.psnr(a.to(dev), b.to(dev)).item()
            # the same SSIM with its window as an f32 cuDNN conv in TF32
            # (dense, block-diagonal: cuDNN's depthwise kernels do not
            # take TF32, a dense conv does)
            c = a.shape[-1]
            w = torch.zeros(c, c, 11, 11, device=dev)
            for i in range(c):
                w[i, i] = torch.from_numpy(S.gaussian_window())
            ad, bd = (t.to(dev).permute(0, 3, 1, 2) for t in (a, b))

            def win(t):
                return F.conv2d(t, w, padding=5)
            mu1, mu2 = win(ad), win(bd)
            s1, s2 = win(ad * ad) - mu1 ** 2, win(bd * bd) - mu2 ** 2
            s12 = win(ad * bd) - mu1 * mu2
            c1, c2 = 0.01 ** 2, 0.03 ** 2
            s_tf32 = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
                      ).mean().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[unet] SSIM near 0.9 (2x256x256x3, noise 0.02 / 0.01), TF32 "
          f"flags on: card {s} vs float64 {ref_ssim}, err "
          f"{abs(s - ref_ssim)} (tol 1e-6); an f32 cuDNN window in TF32 "
          f"would give {s_tf32}, err {abs(s_tf32 - ref_ssim)}; PSNR card "
          f"{p} vs float64 {ref_psnr}, rel err "
          f"{abs(p - ref_psnr) / ref_psnr}")
    require(abs(s - ref_ssim) <= 1e-6, f"SSIM off by {abs(s - ref_ssim)}")
    require(abs(p - ref_psnr) <= 1e-6 * ref_psnr, "PSNR off")


def phase_restored_sweep(dev):
    """The 8-pass YOLOv8m sweep with the f32 U-Net (bench_sweep's path);
    returns the launch counts of its run."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.eval import fused_sweep as FS
    from robust_object_detection_tpu_torch.models import unet as U
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import corrupt as CO
    from robust_object_detection_tpu_torch.ops import image as IM
    from robust_object_detection_tpu_torch.ops import nms as NM
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import detector as D

    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED))
    unet = unet_pair(dev)[1]
    predict = D.make_predict_step(IMG_SIZE)
    launches, dets = run_sweep(
        dev, "sweep8", "YOLOv8m + U-Net", model, predict,
        {"conv3x3": C.conv3x3, "yolo_front": TF.front_inference,
         "nms": NM._nms_core},
        {"conv3x3": 4, "yolo_front": 1, "nms": 1}, unet=unet)
    per_img = dets[3].sum(-1).float().mean(-1).tolist()
    print(f"[sweep8] detections per image by pass (corrupted, then "
          f"restored: Clean, Noise, Blur, LowRes): {per_img}")

    # one batch: the step's restored passes against the U-Net's u8 apply
    # run alone, then detected; restored Clean against corrupted Clean
    images, _ = synthetic_samples(BATCH)
    clean = torch.from_numpy(np.stack(list(images.values()))).to(dev)
    noise = torch.randn(clean.shape, generator=torch.Generator(
        dev).manual_seed(SEED), device=dev) * 15.0
    out = FS.make_fused_step(predict, unet, NATIVE_HW, IMG_SIZE,
                             host_noise=True)(model, None, clean, noise)
    x = clean.float()
    same = [all(torch.equal(o[4], o[0]) for o in out)]
    for p, img in enumerate((CO.add_noise(x, noise, 1.0),
                             CO.apply_motion_blur(x), CO.apply_lowres(x)),
                            start=5):
        restored = U.apply_u8(unet, img.to(torch.uint8)).float()
        alone = predict(model, IM.letterbox(restored, IMG_SIZE)[0])
        same.append(all(torch.equal(o[p], r) for o, r in zip(out, alone)))
    print(f"[sweep8] one batch: restored Clean == corrupted Clean, and the "
          f"restored Noise / Blur / LowRes == the U-Net's u8 apply alone, "
          f"then detected: {same}")
    require(all(same), f"restored passes differ from their parts: {same}")

    # the U-Net alone, a batch of 8 at 768x1024, by CUDA events
    xb = clean[:BATCH]
    flops = 2 * U.macs_per_pixel(unet) * xb.shape[0] * xb.shape[1] * \
        xb.shape[2]
    ms_flags = time_ms(lambda: U.apply_u8(unet, xb))
    with torch.backends.cudnn.flags(allow_tf32=False):
        ms_f32 = time_ms(lambda: U.apply_u8(unet, xb))
    print(f"[sweep8] U-Net f32, batch {BATCH} x 768x1024 (u8 apply): "
          f"{ms_flags} ms with the process's flags (cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}), {ms_f32} ms with TF32 off; "
          f"{U.macs_per_pixel(unet)} MACs a pixel = {flops / 1e12} TFLOP a "
          f"batch, {3 * flops / 1e12} for a batch's three variants; bound "
          f"{flops / PEAK_FLOPS['float32'] * 1e3} ms at 67 TFLOP/s f32, "
          f"{flops / UNET_PEAK_TF32 * 1e3} ms at 494 TFLOP/s TF32")
    return launches


def phase_unet_training(dev):
    """U-Net training at RestorationConfig's defaults (patch 256, batch 8,
    full widths): 1 warm-up + 5 timed steps, finite metrics, moved running
    statistics, step ms, patches/s, peak memory; then one step at batch
    2, patch 64 on the card (TF32 off) and on the CPU from the same
    weights and draws. In float64: loss within 1e-9 relative, every
    gradient within 1e-6 x max|ref| of its leaf (the same function), the
    running statistics after the step within 1e-9 x max|ref| (1e-5 in
    f32). In f32: loss within 1e-4 relative of the CPU's; the train-mode BatchNorm's
    fast variance E[y^2] - E[y]^2 cancels in f32, so the deepest leaves'
    f32 gradients carry several % of rounding noise, on the CPU as on the
    card; each leaf's card f32 gradient is held against the float64 one
    within max(1e-4, 10 x the leaf's own f32 noise) x max|ref|, the noise
    measured as the change when the batch's two images swap places (the
    same gradient in exact arithmetic, summed in another order). TF32
    would put ~1e-3 on every leaf where cuDNN takes it."""
    import torch
    from robust_object_detection_tpu_torch.core.config import (
        CorruptionConfig, RestorationConfig)
    from robust_object_detection_tpu_torch.models import unet as U
    from robust_object_detection_tpu_torch.ops import ssim as S
    from robust_object_detection_tpu_torch.train import restoration as R

    rcfg = RestorationConfig()
    model = U.create(rcfg.channels, device=dev,
                     generator=torch.Generator().manual_seed(SEED),
                     train=True)
    tx, _ = R.make_optimizer(rcfg, 100)
    state = R.init_state(model, tx)
    step = R.make_train_step(CorruptionConfig(), rcfg.ssim_weight)
    gen = torch.Generator(dev).manual_seed(SEED)
    batch = torch.randint(0, 256, (rcfg.batch_size, rcfg.patch_size,
                                   rcfg.patch_size, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
    m = step(state, batch, gen)                  # warm-up
    torch.cuda.synchronize()
    require(math.isfinite(m["loss"].item()), "warm-up loss not finite")
    bn = model.mid.bn1
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: v.item() for k, v in m.items()}
        print(f"[unet-train] step {i}: {vals}")
        require(all(math.isfinite(v) for v in vals.values()),
                f"step {i}: loss, psnr or grad_norm not finite")
    peak = torch.cuda.max_memory_allocated(dev)
    moved = [not torch.equal(a, b) for a, b in zip(
        stats0, (bn.running_mean, bn.running_var))]
    require(all(moved), "U-Net running statistics did not move")
    ms = statistics.median(times)
    print(f"[unet-train] U-Net f32 (process flags) patch {rcfg.patch_size} "
          f"batch {rcfg.batch_size}: step ms {times} median {ms} = "
          f"{rcfg.batch_size / (ms / 1e3)} patches/s; running stats moved "
          f"{moved}; peak memory {peak} bytes ({peak / 2 ** 30} GiB)")
    out = torch.rand(batch.shape, generator=gen, device=dev,
                     requires_grad=True)
    target = batch.float() / 255.0

    def loss_step():
        S.restoration_loss(out, target).backward()
    print(f"[unet-train] of which the loss alone (L1 + SSIM, forward + "
          f"backward) at the same shape: {time_ms(loss_step)} ms")

    # one step at batch 2, patch 64 from the same weights and draws, in
    # f32 and in float64, on the CPU and on the card (TF32 off); on the
    # card in f32 also with the batch's two images swapped
    small = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(SEED + 7))
    draws = R.draw_train(small.shape, torch.Generator().manual_seed(SEED))
    state_dict = unet_pair(dev, train=True)[0].state_dict()
    res = {}
    for dtype in (torch.float32, torch.float64):
        for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
            res[name, dtype] = unet_step_grads(state_dict, device, dtype,
                                               small, draws, step, tx)
    swap = [1, 0]
    res["swapped"] = unet_step_grads(
        state_dict, dev, torch.float32, small[swap],
        {k: v[swap] for k, v in draws.items()}, step, tx)
    (l64, g64, s64), (lc64, gc64, sc64) = res["cpu", torch.float64], res[
        "card", torch.float64]
    (l32, g32, s32), (lc32, gc32, sc32) = res["cpu", torch.float32], res[
        "card", torch.float32]
    gsw = res["swapped"][1]

    def worst_rel(got, ref):
        return max(((got[n] - r).abs().max() / r.abs().max()).item()
                   for n, r in ref.items())
    rel64 = abs(lc64 - l64) / abs(l64)
    worst64, stats64 = worst_rel(gc64, g64), worst_rel(sc64, s64)
    stats32 = worst_rel(sc32, s32)
    print(f"[unet-train] float64 step batch 2 patch 64 card vs CPU: loss "
          f"rel {rel64} (tol 1e-9); worst gradient rel err {worst64} over "
          f"{len(g64)} leaves (tol 1e-6); running statistics after the step "
          f"{stats64} (tol 1e-9), in f32 {stats32} (tol 1e-5)")
    require(rel64 <= 1e-9 and worst64 <= 1e-6 and stats64 <= 1e-9,
            f"float64 U-Net step card vs CPU: {rel64}, {worst64}, {stats64}")
    require(stats32 <= 1e-5, f"f32 running statistics differ by {stats32}")
    rel32 = abs(lc32 - l32) / abs(l32)
    over, errs, pair = [], [], []
    for n, r in g64.items():
        scale = r.abs().max().item()
        err = (gc32[n] - r).abs().max().item() / scale
        noise = (gc32[n] - gsw[n]).abs().max().item() / scale
        errs.append(err)
        pair.append(((gc32[n] - g32[n]).abs().max().item() / scale, n))
        if err > 1e-4:
            print(f"[unet-train]   {n}: card f32 vs float64 {err}, card f32 "
                  f"vs itself with the images swapped {noise} (x max|ref|)")
        if err > max(1e-4, 10 * noise):
            over.append(n)
    print(f"[unet-train] f32 step card vs CPU: loss {lc32} vs {l32} (rel "
          f"{rel32}, tol 1e-4); worst gradient rel err card vs CPU "
          f"{max(pair)}; card f32 vs float64: median leaf "
          f"{statistics.median(errs)}, max {max(errs)}; every leaf within "
          f"max(1e-4, 10 x its swapped-order noise) x max|ref|: {not over}")
    require(rel32 <= 1e-4, f"U-Net f32 step loss differs by {rel32}")
    require(not over, f"card f32 gradients off the float64 ones: {over}")

    # the checks above run with cuDNN switched off (cudnn.flags' default
    # enabled=False), so nothing above sees TF32 in the train convs; at
    # this phase's own shape (patch 256, batch 8), with cuDNN on: one step
    # in f32 with TF32 off and one with TF32 on, each held against the
    # card's float64 step from the same weights and draws, by the median
    # over the leaves of each leaf's largest error over its max|ref|
    big = batch.cpu()
    big_draws = R.draw_train(big.shape,
                             torch.Generator().manual_seed(SEED + 1))
    runs = {name: unet_step_grads(state_dict, dev, dtype, big, big_draws,
                                  step, tx, flags={"enabled": True,
                                                   "allow_tf32": tf32})
            for name, dtype, tf32 in (("f64", torch.float64, False),
                                      ("f32", torch.float32, False),
                                      ("tf32", torch.float32, True))}
    g_ref = runs["f64"][1]
    med = {name: statistics.median(
        ((runs[name][1][n] - r).abs().max() / r.abs().max()).item()
        for n, r in g_ref.items()) for name in ("f32", "tf32")}
    loss_rel = {name: abs(runs[name][0] - runs["f64"][0])
                / abs(runs["f64"][0]) for name in ("f32", "tf32")}
    print(f"[unet-train] one step at patch {rcfg.patch_size}, batch "
          f"{rcfg.batch_size} against the card's float64 step: median leaf "
          f"gradient error f32 (TF32 off) {med['f32']}, TF32 on "
          f"{med['tf32']} (bar {UNET_F32_BAR}: f32 below it, TF32 above); "
          f"loss rel {loss_rel}")
    require(med["f32"] <= UNET_F32_BAR,
            f"U-Net f32 step at patch {rcfg.patch_size}, batch "
            f"{rcfg.batch_size}: median leaf error {med['f32']} above "
            f"{UNET_F32_BAR} (TF32 in the train convs?)")
    require(med["tf32"] > UNET_F32_BAR,
            f"the bar {UNET_F32_BAR} does not separate f32 from TF32 "
            f"({med['tf32']})")


# the median leaf gradient error of an f32 U-Net step against float64 at
# patch 256, batch 8, cuDNN on (phase 19): above the measured f32 spread
# (2.1e-3, TF32 off) and below TF32's (2.8e-2) on an H100 80GB HBM3, 700 W
UNET_F32_BAR = 6e-3


def unet_step_grads(state_dict, device, dtype, batch, draws, step, tx,
                    flags=None):
    """(loss, gradients as float64 CPU tensors) of one U-Net train step on
    `device` in `dtype` from `state_dict` and the given draws; float64
    widens the step's .float() casts while it runs. flags: the step's
    torch.backends.cudnn.flags (default allow_tf32=False, which also
    switches cuDNN off)."""
    import torch
    from robust_object_detection_tpu_torch.models import unet as U
    from robust_object_detection_tpu_torch.train import restoration as R

    model = U.RestorationUNet(UNET_CHANNELS, dtype=dtype).train()
    model.load_state_dict(state_dict)
    model.to(device, dtype, memory_format=torch.channels_last)
    to_float = torch.Tensor.float
    if dtype == torch.float64:
        torch.Tensor.float = lambda self: self.double()
    try:
        with torch.backends.cudnn.flags(**(flags or {"allow_tf32": False})):
            m = step(R.init_state(model, tx), batch.to(device),
                     draws={k: (v.to(device, dtype) if v.is_floating_point()
                                else v.to(device)) for k, v in draws.items()})
    finally:
        torch.Tensor.float = to_float
    require(m["loss"].dtype == dtype and all(
        p.grad.dtype == dtype for p in model.parameters()),
        f"the {dtype} step computed in another dtype")
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()}
    stats = {n: b.double().cpu() for n, b in model.named_buffers()
             if "running" in n}
    return m["loss"].item(), grads, stats


# ── Faster R-CNN ResNet-50-FPN-v2 (phases 20-22) ─────────────────────────

FRCNN_PEAK_TF32 = 494e12           # H100 SXM dense TF32 on the tensor cores
FRCNN_RECT = (256, 384)            # phase 20's rectangular canvas
BUCKET_HW = (750, 1333)            # tv_target scale 1.0 -> bucket 768x1344
N_BUCKET_IMAGES = 16


def frcnn_pair(dev):
    """The full-width f32 Faster R-CNN (blocks (3, 4, 6, 3), 256-channel
    FPN, 512 proposals, 7 classes) on the CPU and on the card, every
    BatchNorm's scale, bias and running statistics and every bias drawn
    from the seed (each bottleneck's last BN scale in [0.1, 0.3], so the
    residual stream stays in range through 16 blocks), the class logits'
    weights x10 so that scores spread far above f32 noise."""
    import torch
    from torch import nn
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.models import resnet as RN

    cpu = FR.create(FR.FrcnnConfig(), device=torch.device("cpu"),
                    generator=torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)

    def draw(t, lo, span):
        t.copy_(torch.rand(t.shape, generator=g) * span + lo)
    with torch.no_grad():
        bn3 = {id(m.bn3) for m in cpu.modules()
               if isinstance(m, RN.BottleneckBlock)}
        for mod in cpu.modules():
            if isinstance(mod, nn.BatchNorm2d):
                draw(mod.weight, *((0.1, 0.2) if id(mod) in bn3
                                   else (0.75, 0.5)))
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
                mod.running_mean.copy_(
                    torch.randn(mod.running_mean.shape, generator=g) * 0.1)
                draw(mod.running_var, 0.75, 0.5)
            elif isinstance(mod, (nn.Conv2d, nn.Linear)) and \
                    mod.bias is not None:
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
        cpu.roi_heads.box_predictor.cls_score.weight.mul_(10.0)
    gpu = FR.create(FR.FrcnnConfig(), device=dev, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def roi_align_float64(features, boxes, output_size=7, strides=(4, 8, 16, 32),
                      sampling_ratio=2):
    """RoIAlign RoI by RoI and tap by tap in float64 with the reference's
    semantics (levels by Lin et al. eq. 1 with +1e-8, aligned=False, 2 x 2
    samples a bin clamped into the level, their mean): an implementation
    independent of the port's flattened gather. features: per-level (B,
    C, H, W); boxes (B, R, 4). Returns (B, R, out, out, C)."""
    import torch
    b, r = boxes.shape[:2]
    c = features[0].shape[1]
    out = torch.zeros(b, r, output_size, output_size, c, dtype=torch.float64)
    s = sampling_ratio
    for bi in range(b):
        for ri in range(r):
            x1, y1, x2, y2 = (float(v) for v in boxes[bi, ri])
            area = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
            k = math.floor(4 + math.log2(math.sqrt(area) / 224.0 + 1e-8))
            lvl = min(max(k, 2), 5) - 2
            f = features[lvl][bi].double()
            h, w = f.shape[1:]
            st = strides[lvl]
            bw = max(x2 / st - x1 / st, 1.0) / output_size
            bh = max(y2 / st - y1 / st, 1.0) / output_size
            for i in range(output_size):
                for j in range(output_size):
                    acc = torch.zeros(c, dtype=torch.float64)
                    for ti in range(s):
                        for tj in range(s):
                            sy = y1 / st + (i * s + ti + 0.5) / s * bh
                            sx = x1 / st + (j * s + tj + 0.5) / s * bw
                            sy = min(max(sy, 0.0), h - 1)
                            sx = min(max(sx, 0.0), w - 1)
                            y0, x0 = math.floor(sy), math.floor(sx)
                            ya, xa = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
                            fy, fx = sy - y0, sx - x0
                            acc += (f[:, y0, x0] * (1 - fy) * (1 - fx)
                                    + f[:, y0, xa] * (1 - fy) * fx
                                    + f[:, ya, x0] * fy * (1 - fx)
                                    + f[:, ya, xa] * fy * fx)
                    out[bi, ri, i, j] = acc / (s * s)
    return out


def match_detections(out, ref, box_atol, score_atol, max_ties=3):
    """Valid detections of two predict outputs equal as sets: each row of
    `out` matches a row of `ref` by box (box_atol px), class and score
    (score_atol); rows left over must pair up as near ties resolved the
    other way (same class, scores within score_atol, IoU above 0.5), at
    most `max_ties` an image. Returns (matched, ties, worst box err, worst
    score err)."""
    ob, os_, oc, ov = (t.cpu() for t in out)
    rb, rs, rc, rv = (t.cpu() for t in ref)
    require(bool((ov.sum(1) == rv.sum(1)).all()),
            f"detection counts differ: {ov.sum(1).tolist()} vs "
            f"{rv.sum(1).tolist()}")
    matched = ties = 0
    worst_box = worst_score = 0.0
    for b in range(rb.shape[0]):
        left = rv[b].nonzero().flatten().tolist()
        spare = []
        for i in ov[b].nonzero().flatten().tolist():
            d = [(float((rb[b, j] - ob[b, i]).abs().max()), j) for j in left]
            err, j = min(d)
            if err > box_atol:
                spare.append(i)
                continue
            require(int(rc[b, j]) == int(oc[b, i])
                    and abs(float(rs[b, j] - os_[b, i])) <= score_atol,
                    f"image {b}: detection {i} differs in class or score")
            worst_box = max(worst_box, err)
            worst_score = max(worst_score, abs(float(rs[b, j] - os_[b, i])))
            left.remove(j)
            matched += 1
        require(len(spare) == len(left) <= max_ties,
                f"image {b}: {len(spare)} detections unmatched")
        for i in spare:
            a = ob[b, i]
            pair = [j for j in left if int(rc[b, j]) == int(oc[b, i])
                    and abs(float(rs[b, j] - os_[b, i])) <= score_atol
                    and box_iou(a, rb[b, j]) > 0.5]
            require(bool(pair), f"image {b}: detection {i} unmatched")
            left.remove(pair[0])
            ties += 1
    return matched, ties, worst_box, worst_score


def box_iou(a, b) -> float:
    iw = max(min(float(a[2]), float(b[2])) - max(float(a[0]), float(b[0])),
             0.0)
    ih = max(min(float(a[3]), float(b[3])) - max(float(a[1]), float(b[1])),
             0.0)
    union = (float((a[2] - a[0]) * (a[3] - a[1]))
             + float((b[2] - b[0]) * (b[3] - b[1])) - iw * ih)
    return iw * ih / union


def phase_frcnn_model_check(dev):
    """Faster R-CNN f32 on the card (cuDNN, TF32 off) against the same
    weights on the CPU, batch 2 at 256x256 and at 256x384: the pyramid
    P2..P6, the RPN's objectness and deltas, and the box head on the CPU's
    proposals within 1e-4 x max|ref| each; then the end-to-end detections
    matched by box (0.05 px, scores within 1e-4, near ties allowed as
    match_detections says). On the card also against implementations
    independent of the port: the pyramid, the RPN maps and the box head
    (on pooled RoIs) of the torchvision-layout replica in
    tests/_torch_frcnn.py loaded with the same state_dict, within 1e-4 x
    max|ref| (TF32 off), and RoIAlign against roi_align_float64 on 12
    proposals an image and 4 set boxes (three past the border, one under a
    pixel), within 1e-5 x max|ref|."""
    import torch
    from robust_object_detection_tpu_torch.models import fpn as FP
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR
    import importlib.util
    # by path: a `tests` package installed elsewhere may shadow the
    # checkout's tests/ directory
    spec = importlib.util.spec_from_file_location(
        "_torch_frcnn", Path(__file__).resolve().parent / "tests"
        / "_torch_frcnn.py")
    replica_lib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(replica_lib)

    cpu, gpu = frcnn_pair(dev)
    print(f"[frcnn] Faster R-CNN ResNet-50-FPN-v2 f32, "
          f"{sum(p.numel() for p in gpu.parameters())} parameters, blocks "
          f"{gpu.cfg.blocks}, "
          f"{gpu.cfg.num_proposals} proposals, {gpu.cfg.num_classes} "
          f"classes")
    g = torch.Generator().manual_seed(SEED + 7)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
            for size in (256, FRCNN_RECT):
                h, w = FR._hw(size)
                x = torch.randint(0, 256, (2, h, w, 3), generator=g,
                                  dtype=torch.uint8)
                xf = x.float() / 255.0
                pyr_c, obj_c, d_c = cpu.extract(xf)
                pyr_g, obj_g, d_g = gpu.extract(xf.to(dev))
                log = []
                for i, (o, r) in enumerate(zip(pyr_g, pyr_c)):
                    check(f"P{i + 2}", o.cpu(), r, 1e-4, log)
                check("objectness", obj_g.cpu(), obj_c, 1e-4, log)
                check("rpn deltas", d_g.cpu(), d_c, 1e-4, log)
                props, valid = FR.generate_proposals(obj_c, d_c, (h, w),
                                                     cpu.cfg)
                s_c, bd_c = cpu.roi_forward(pyr_c, props)
                s_g, bd_g = gpu.roi_forward(pyr_g, props.to(dev))
                check("box scores", s_g.cpu(), s_c, 1e-4, log)
                check("box deltas", bd_g.cpu(), bd_c, 1e-4, log)
                out = TFR.make_predict_step(gpu, (h, w))(gpu, x.to(dev))
                ref = TFR.make_predict_step(cpu, (h, w))(cpu, x)
                m, ties, eb, es = match_detections(out, ref, 0.05, 1e-4)
                print(f"[frcnn] {h}x{w} card vs CPU, TF32 off: "
                      f"{'; '.join(log)}; proposals valid "
                      f"{valid.sum(1).tolist()}; detections "
                      f"{ref[3].sum(1).tolist()}: {m} matched (max box err "
                      f"{eb} px, score err {es}), {ties} near ties")

            # independent implementations: the torchvision-layout replica
            # and a float64 RoIAlign, on the card
            rep = replica_lib.FasterRCNN(num_classes=gpu.cfg.num_classes)
            rep.load_state_dict({k.replace("box_head.", "box_head.blocks.")
                                 if k.startswith("roi_heads.box_head.")
                                 else k: v
                                 for k, v in gpu.state_dict().items()})
            rep = rep.to(dev).eval()
            mean = torch.tensor(FR.IMAGENET_MEAN, device=dev)
            std = torch.tensor(FR.IMAGENET_STD, device=dev)
            xf = xf.to(dev)
            rois = torch.randn(2, 12, 7, 7, 256, generator=g).to(dev)
            pyr_r, objs_r, boxes_r, s_r, d_r = rep.forward_parts(
                ((xf - mean) / std).permute(0, 3, 1, 2),
                rois.reshape(24, 7, 7, 256).permute(0, 3, 1, 2))
            s_p, d_p = gpu.roi_forward_pooled(None, rois)
            log = []
            for i, (o, r) in enumerate(zip(pyr_g, pyr_r)):
                check(f"P{i + 2}", o, r, 1e-4, log)
            check("objectness", obj_g, torch.cat(
                [o.permute(0, 2, 3, 1).reshape(2, -1) for o in objs_r], 1),
                1e-4, log)
            check("rpn deltas", d_g, torch.cat(
                [b.permute(0, 2, 3, 1).reshape(2, -1, 4) for b in boxes_r],
                1), 1e-4, log)
            check("box scores", s_p.reshape(24, -1), s_r, 1e-4, log)
            check("box deltas", d_p.reshape(24, -1), d_r, 1e-4, log)
            print(f"[frcnn] {h}x{w} card vs the torchvision-layout replica, "
                  f"TF32 off: {'; '.join(log)}")
            boxes = torch.cat([props[:, :12].to(dev), torch.tensor(
                [[-30.0, -20.0, 60.0, 50.0], [300.0, 200.0, 420.0, 300.0],
                 [-5.0, 100.0, 20.0, 400.0], [10.0, 10.0, 10.5, 10.5]],
                device=dev).expand(2, 4, 4)], 1)
            ra = FP.roi_align(tuple(pyr_g[:4]), boxes)
            rr = roi_align_float64([p.cpu() for p in pyr_g[:4]], boxes.cpu())
            log = []
            check("RoIAlign", ra.cpu().double(), rr, 1e-5, log)
            print(f"[frcnn] RoIAlign on the card vs float64 RoI by RoI "
                  f"({boxes.shape[1]} boxes an image: 12 proposals, three "
                  f"boxes past the border, one under a pixel): "
                  f"{'; '.join(log)}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def frcnn_macs(model, fn):
    """Multiply-adds of `fn`'s convs and linears by module group (counted
    from the shapes each call sees, by forward hooks)."""
    import torch
    from torch import nn
    groups = {"backbone": "backbone.body.", "FPN": "backbone.fpn.",
              "RPN head": "rpn.", "box head": "roi_heads."}
    macs = dict.fromkeys(groups, 0)
    hooks = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        group = next(k for k, p in groups.items() if name.startswith(p))

        def hook(mod, inp, out, group=group):
            if isinstance(mod, nn.Conv2d):
                per_out = (mod.in_channels // mod.groups
                           * mod.kernel_size[0] * mod.kernel_size[1])
            else:
                per_out = mod.in_features
            macs[group] += out.numel() * per_out
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in hooks:
            h.remove()
    return macs


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_share(fn):
    """(wall ms, device busy ms, idle share) of one profiled call of `fn`
    after one warm-up (profiled_idle)."""
    fn()
    return profiled_idle(fn)


def all_kernel_counters():
    """Every hand kernel's launch counter (the fifteen wrappers)."""
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    fns = (C.conv3x3, C.conv3x3_wgrad, TF.front_inference, TF.front_fused,
           TF.front_fused_backward, FC.fused_random_corruption,
           ST.stem_fused_inference, ST.stem_fused, ST.stem_fused_backward,
           DF.ms_deform_attn_slots, DF.ms_deform_attn_backward,
           AS.auction_assignment, DF.ms_deform_attn_sorted_forward,
           DF.ms_deform_attn_sorted_backward, DF.stamp_scatter)
    return {f.__name__: f for f in fns}


def phase_frcnn_sweep(dev):
    """The 4-pass sweep with Faster R-CNN (full width, f32 under the
    process's flags, 1024 canvas, batch 8, phase 5's 64 images): two NMS
    launches a forward (proposals, detections) and no other hand kernel
    launch (every counter zeroed just before, read just after);
    image-passes/s and peak memory; the event ms a batch of each part of
    the predict step, beside the FLOP bound of its convs and linears; the
    idle share of one profiled batch; RoIAlign's peak memory. Then the
    8-pass sweep with the U-Net over 16 images. Returns both sweeps'
    launch counts, summed."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.models import fpn as FP
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.ops import image as IM
    from robust_object_detection_tpu_torch.ops import nms as NM
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    model = frcnn_pair(dev)[1]
    predict = TFR.make_predict_step(model, IMG_SIZE)
    counters = dict(all_kernel_counters(), nms=NM._nms_core)
    per_forward = dict(dict.fromkeys(counters, 0), nms=2)
    launches, dets = run_sweep(dev, "frcnn-sweep", "Faster R-CNN", model,
                               predict, counters, per_forward, dtype="f32")
    per_img = dets[3].sum(-1).float().mean(-1).tolist()
    print(f"[frcnn-sweep] detections per image by pass (Clean, Noise, "
          f"Blur, LowRes): {per_img}")

    images, _ = synthetic_samples(BATCH)
    clean = torch.from_numpy(np.stack(list(images.values()))).to(dev)
    canvas = IM.letterbox(clean.float(), IMG_SIZE)[0]
    cfg, hw = model.cfg, (IMG_SIZE, IMG_SIZE)
    with torch.inference_mode():
        x = canvas / 255.0
        pyr = model.pyramid(x)
        obj, deltas = model.rpn["head"](pyr)
        props, valid = FR.generate_proposals(obj, deltas, hw, cfg)
        rois = FP.roi_align(tuple(pyr[:4]), props)
        scores, box_deltas = model.roi_heads(rois)
        parts = {
            "backbone + FPN": lambda: model.pyramid(x),
            "RPN head": lambda: model.rpn["head"](pyr),
            "proposals (top-k + NMS)": lambda: FR.generate_proposals(
                obj, deltas, hw, cfg),
            "RoIAlign": lambda: FP.roi_align(tuple(pyr[:4]), props),
            "box head": lambda: model.roi_heads(rois),
            "final NMS (decode + NMS)": lambda: TFR.detect(
                cfg, props, valid, scores, box_deltas, hw),
            "whole predict step": lambda: predict(model, canvas)}
        ms = {k: time_ms(fn, iters=5, warmup=2) for k, fn in parts.items()}
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        FP.roi_align(tuple(pyr[:4]), props)
        roi_peak = torch.cuda.max_memory_allocated(dev) - before
    macs = frcnn_macs(model, lambda: predict(model, canvas))
    total = sum(macs.values())
    flops = 2 * total
    for k, v in ms.items():
        print(f"[frcnn-sweep] batch {BATCH} at {IMG_SIZE}: {k} {v} ms")
    print(f"[frcnn-sweep] multiply-adds an image: "
          + ", ".join(f"{k} {v / BATCH / 1e9} G" for k, v in macs.items())
          + f"; total {total / BATCH / 1e9} GMAC = {flops / BATCH / 1e12} "
          f"TFLOP an image, {flops / 1e12} a batch; bound "
          f"{flops / FRCNN_PEAK_TF32 * 1e3} ms at 494 TFLOP/s TF32, "
          f"{flops / PEAK_FLOPS['float32'] * 1e3} ms at 67 TFLOP/s f32 "
          f"(cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32})")
    print(f"[frcnn-sweep] RoIAlign at batch {BATCH}, {cfg.num_proposals} "
          f"RoIs, 14x14 taps, 256 channels: peak memory it adds {roi_peak} "
          f"bytes ({roi_peak / 2 ** 30} GiB)")
    wall, busy, idle = idle_share(lambda: predict(model, canvas))
    print(f"[frcnn-sweep] one profiled batch: wall {wall} ms, device busy "
          f"{busy} ms, idle share {idle}")

    unet = unet_pair(dev)[1]
    launches8, dets8 = run_sweep(dev, "frcnn-sweep8", "Faster R-CNN + U-Net",
                                 model, predict, counters, per_forward,
                                 unet=unet, n_images=16, dtype="f32")
    per_img = dets8[3].sum(-1).float().mean(-1).tolist()
    print(f"[frcnn-sweep8] detections per image by pass (corrupted, then "
          f"restored): {per_img}")
    return {k: n + launches8[k] for k, n in launches.items()}


def phase_frcnn_bucketed(dev):
    """evaluate_bucketed through BucketedPredict over 16 in-memory 750x1333
    images (tv_target scale 1.0: the VisDrone bucket 768x1344), batch 1 as
    the reference evaluates: one bucket of 16, finite mAPs, ms an image
    (a warm-up run over two images first)."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.data.pipeline import Sample
    from robust_object_detection_tpu_torch.eval import detector_eval as DE
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    model = frcnn_pair(dev)[1]
    rng = np.random.RandomState(SEED + 3)
    h, w = BUCKET_HW
    images, samples = {}, []
    for i in range(N_BUCKET_IMAGES):
        images[i + 1] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        m = int(rng.randint(1, 6))
        xy = rng.rand(m, 2) * [w - 64, h - 64]
        wh = rng.rand(m, 2) * 56 + 8
        samples.append(Sample(
            image_path=Path(f"synthetic/bucket{i:04d}.png"), image_id=i + 1,
            width=w, height=h,
            boxes_xyxy=np.concatenate([xy, xy + wh], 1).astype(np.float32),
            classes=rng.randint(0, 6, m).astype(np.int32)))
    factory = DE.BucketedPredict(
        lambda hw: TFR.make_predict_step(model, hw))

    def loader(sample):
        return images[sample.image_id]
    DE.evaluate_on_samples(factory, model, samples[:2], IMG_SIZE, 1,
                           load_image=loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = DE.evaluate_on_samples(factory, model, samples, IMG_SIZE, 1,
                                 load_image=loader)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[frcnn-bucket] {N_BUCKET_IMAGES} images {h}x{w}, batch 1: "
          f"buckets {out['buckets']}, mAP50 {out['mAP50']} mAP50-95 "
          f"{out['mAP50_95']}, {elapsed} s = {elapsed / N_BUCKET_IMAGES * 1e3}"
          f" ms an image (host scoring included), peak memory {peak} bytes "
          f"({peak / 2 ** 30} GiB)")
    require(out["buckets"] == {"768x1344": N_BUCKET_IMAGES},
            f"buckets {out['buckets']}")
    require(out["images"] == N_BUCKET_IMAGES, "images evaluated")
    require(all(math.isfinite(out[k]) and 0.0 <= out[k] <= 1.0
                for k in ("mAP50", "mAP50_95")), "bucketed mAP not finite")


# ── Faster R-CNN training (phases 23-24) ─────────────────────────────────

FRCNN_TRAIN_BATCH = 2              # bench.py's bench_frcnn
FRCNN_CHECK_SIZE = 256             # phase 23's canvas
FRCNN_CHECK_GT = (8, 16)           # phase 23: valid GT an image, slots
FRCNN_CHECK_LEAVES = (
    "backbone.body.conv1.weight", "backbone.body.layer4.2.conv2.weight",
    "backbone.fpn.layer_blocks.0.0.weight", "rpn.head.conv.0.0.weight",
    "rpn.head.cls_logits.weight", "rpn.head.bbox_pred.weight",
    "roi_heads.box_head.5.weight", "roi_heads.box_predictor.cls_score.weight",
    "roi_heads.box_predictor.bbox_pred.weight")
FRCNN_METRICS = ("rpn_obj", "rpn_box", "head_cls", "head_box", "loss",
                 "grad_norm")
# phase 23's bars on the card's f32 step against its float64 step: the
# losses' and grad_norm's relative error, the named gradients' relative L2
# error, the running statistics' max error over max|ref|. Measured on an
# H100 80GB HBM3 at 700 W: losses <= 2.0e-6, grad_norm 7.9e-7, gradients <= 5.2e-3
# (conv1; f32 noise through 70 train-mode BatchNorms), statistics 1.0e-7
FRCNN_F32_BARS = (1e-5, 1e-5, 1e-2, 1e-6)


def frcnn_train_step(model, device, dtype, batch, draws, proposals,
                     trainable_layers=5, compute=None):
    """One Faster R-CNN train step of a copy of `model` on `device` in
    `dtype` (float64 widens the step's .float() casts and its BatchNorm's
    f32 cast while it runs; compute: the model's compute dtype, bf16 for
    phase 28, over f32 weights), TF32 off, with the given draws. `proposals`:
    a list; the first run records the proposals it generated there, a run
    given a filled list replays them, so both sides sample RoIs from the
    same boxes. Returns (metrics, gradients, state before, state after),
    tensors as float64 on the CPU."""
    import torch
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.models import resnet as RN
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    cfg = dataclasses.replace(model.cfg, trainable_layers=trainable_layers)
    net = FR.FasterRCNN(cfg, compute or torch.float32)
    net.load_state_dict(model.state_dict())
    net.to(device, dtype, memory_format=torch.channels_last)
    before = {k: v.detach().double().cpu().clone()
              for k, v in net.state_dict().items()}
    tx, _ = TFR.make_optimizer(frozen=RN.frozen_param_labels(
        cfg.blocks, trainable_layers))
    state = TFR.init_state(net, tx)
    grads = {}
    for n, p in net.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().double()
                                             .cpu()))
    real_props, to_float, bn_train = (FR.generate_proposals,
                                      torch.Tensor.float, RN.bn_train)

    def props(obj, deltas, hw, cfg):
        if not proposals:
            proposals.extend(t.cpu() for t in real_props(obj, deltas, hw,
                                                         cfg))
        return tuple(t.to(obj.device, t.dtype if t.dtype == torch.bool
                          else obj.dtype) for t in proposals)
    FR.generate_proposals = props
    if dtype == torch.float64:
        torch.Tensor.float = lambda self: self.double()
        RN.bn_train = lambda y, bn, _, m: bn_train(y, bn, y.dtype, m)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    images, gb, gc = batch
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            step = TFR.make_train_step(net, images.shape[1], None, False)
            m = step(state, images.to(device), gb.to(device, dtype),
                     gc.to(device), SEED,
                     {k: (v.to(device, dtype) if v.is_floating_point()
                          else v.to(device)) for k, v in draws.items()})
    finally:
        FR.generate_proposals = real_props
        torch.Tensor.float = to_float
        RN.bn_train = bn_train
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    require(m["loss"].dtype == dtype and all(
        g.dtype == torch.float64 for g in grads.values()),
        f"the {dtype} step computed in another dtype")
    after = {k: v.detach().double().cpu() for k, v in net.state_dict().items()}
    return ({k: v.item() for k, v in m.items()}, grads, before, after)


def frcnn_compare(tag, card, ref, bars, log):
    """frcnn_train_step's results against a reference run's: each metric's
    relative error (bars: the losses', grad_norm's), each named leaf's
    gradient's relative L2 error, the worst running statistic's max error
    over its leaf's max; each beside its bar. bars None: printed only."""
    (mc, gc_, _, sc), (mr, gr, _, sr) = card, ref
    m_bar, n_bar, g_bar, s_bar = bars or (math.inf,) * 4
    worst = 0.0
    for k in FRCNN_METRICS:
        bar = n_bar if k == "grad_norm" else m_bar
        e = abs(mc[k] - mr[k]) / max(abs(mr[k]), 1e-30)
        log.append(f"{k} {mc[k]} vs {mr[k]} rel {e} (bar {bar})")
        require(math.isfinite(mc[k]) and e <= bar,
                f"{tag}: {k} {mc[k]} vs {mr[k]}")
    require(gc_.keys() == gr.keys(), f"{tag}: gradient leaves differ")
    for n in FRCNN_CHECK_LEAVES:
        if n not in gr:
            log.append(f"{n}: no gradient on either side")
            continue
        e = ((gc_[n] - gr[n]).norm() / gr[n].norm()).item()
        log.append(f"grad {n} rel L2 {e} (bar {g_bar})")
        require(math.isfinite(e) and e <= g_bar, f"{tag}: grad {n} {e}")
    for n, r in sr.items():
        if "running_" in n:
            worst = max(worst, ((sc[n] - r).abs().max()
                                / r.abs().max()).item())
    log.append(f"running statistics worst max err / max|ref| {worst} "
               f"(bar {s_bar})")
    require(worst <= s_bar, f"{tag}: running statistics {worst}")


def phase_frcnn_train_model_check(dev):
    """One Faster R-CNN train step at full width, batch 2 at 256 px,
    augment off, from the same weights (phase 20's, every BN and bias
    drawn from the seed) and the same draws (draw_train on the CPU, moved);
    the proposals of the card's f32 step are replayed by every other run,
    so all sample RoIs from the same boxes. At trainable_layers 5 and 3,
    TF32 off: the card's f32 step against the card's float64 step (losses,
    grad_norm, the nine named leaves' gradients by relative L2, every
    running statistic; bars in FRCNN_F32_BARS, near what was measured),
    the card's f32 step against the CPU's f32 step printed only (on the
    card's machine the CPU's f32 gradients are the noisier side), and at 3
    the frozen parameters bit-identical before and after on the card, their
    running statistics moved. float64, trainable_layers 5: card against
    CPU, metrics within 1e-9, gradients 1e-7, running statistics 1e-9 (the
    same function, so the card's float64 run is a witness for its f32
    one)."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    cpu = frcnn_pair(dev)[0]
    n_gt, slots = FRCNN_CHECK_GT
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 11),
                                     FRCNN_TRAIN_BATCH, FRCNN_CHECK_SIZE,
                                     n_gt, slots)
    batch = (torch.from_numpy(images), torch.from_numpy(gb),
             torch.from_numpy(gc))
    draws = TFR.draw_train(FRCNN_TRAIN_BATCH,
                           len(FR.anchor_boxes(FRCNN_CHECK_SIZE)),
                           cpu.cfg.num_proposals + slots,
                           torch.Generator().manual_seed(SEED + 12))
    host = torch.device("cpu")
    for tl in (5, 3):
        props = []
        t0 = time.perf_counter()
        card = frcnn_train_step(cpu, dev, torch.float32, batch, draws,
                                props, tl)
        t1 = time.perf_counter()
        card64 = frcnn_train_step(cpu, dev, torch.float64, batch, draws,
                                  props, tl)
        t2 = time.perf_counter()
        ref32 = frcnn_train_step(cpu, host, torch.float32, batch, draws,
                                 props, tl)
        t3 = time.perf_counter()
        log = []
        frcnn_compare(f"frcnn-train-check f32 tl {tl} card vs float64",
                      card, card64, FRCNN_F32_BARS, log)
        print(f"[frcnn-train-check] trainable_layers {tl}, batch "
              f"{FRCNN_TRAIN_BATCH} at {FRCNN_CHECK_SIZE} px, TF32 off: the "
              f"card's f32 step vs the card's float64 step (card f32 "
              f"{t1 - t0} s, float64 {t2 - t1} s): {'; '.join(log)}")
        log = []
        frcnn_compare(f"frcnn-train-check f32 tl {tl} card vs CPU", card,
                      ref32, None, log)
        print(f"[frcnn-train-check] trainable_layers {tl}: the card's f32 "
              f"step vs the CPU's f32 step ({t3 - t2} s), printed only: "
              f"{'; '.join(log)}")
        if tl < 5:
            _, grads, before, after = card
            frozen = [n for n in before if n.startswith(
                ("backbone.body.conv1.", "backbone.body.bn1.",
                 "backbone.body.layer1."))]
            params = [n for n in frozen if "running_" not in n
                      and not n.endswith("num_batches_tracked")]
            require(bool(params) and all(
                torch.equal(before[n], after[n]) and n not in grads
                for n in params), "a frozen parameter moved")
            moved = [n for n in frozen if "running_" in n
                     and not torch.equal(before[n], after[n])]
            require(len(moved) == 2 * sum(n.endswith("running_mean")
                                          for n in frozen),
                    "frozen BatchNorms' running statistics did not move")
            print(f"[frcnn-train-check] trainable_layers {tl}: "
                  f"{len(params)} frozen parameters bit-identical, "
                  f"{len(moved)} of their running statistics moved")
            continue
        t0 = time.perf_counter()
        ref64 = frcnn_train_step(cpu, host, torch.float64, batch, draws,
                                 props, tl)
        log = []
        frcnn_compare(f"frcnn-train-check float64 tl {tl} card vs CPU",
                      card64, ref64, (1e-9, 1e-9, 1e-7, 1e-9), log)
        print(f"[frcnn-train-check] float64 trainable_layers {tl}, card vs "
              f"CPU ({time.perf_counter() - t0} s on the CPU): "
              f"{'; '.join(log)}")


def phase_frcnn_training(dev):
    """bench_frcnn's configuration (bench.py:233: batch 2, 1024 px, 80 GT
    an image in 600 slots, augment=True) in float32 (under the process's
    flags): K1 at this step's shape against its plain version, then
    frcnn_step_timing. Returns the launch counts."""
    import torch
    check_k1_frcnn_batch(dev, "frcnn-training")
    model = frcnn_pair(dev)[1]
    require(model.dtype == torch.float32, "phase 24 holds f32")
    return frcnn_step_timing(dev, model, "frcnn-training")


def check_k1_frcnn_batch(dev, tag):
    """K1 at the Faster R-CNN step's shape (batch 2 at 1024 px), the four
    branches in two batches of two (image 1 of the first mid-grey and
    noised), against its plain version."""
    import torch
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    g = torch.Generator(dev).manual_seed(SEED + 13)
    img = torch.floor(torch.rand(FRCNN_TRAIN_BATCH, IMG_SIZE, IMG_SIZE, 3,
                                 device=dev, generator=g) * 256)
    img[1] = 128.0
    per_branch = {}
    for pair in ((FC.CLEAN, FC.NOISE), (FC.BLUR, FC.LOWRES)):
        choice = torch.tensor(pair, device=dev, dtype=torch.int32)
        seeds = torch.randint(0, 2 ** 30, (FRCNN_TRAIN_BATCH,), device=dev,
                              generator=g, dtype=torch.int32)
        out, _ = FC.fused_random_corruption(img, None, choice=choice,
                                            seeds=seeds)
        ref = FC.fused_corruption_reference(img, choice, seeds)
        for c, d in zip(pair, (out - ref).abs().amax((1, 2, 3)).tolist()):
            per_branch[c] = d
        if pair[1] == FC.NOISE:
            nmean = (out[1] - 128.0).mean().item()
            nstd = (out[1] - 128.0).std().item()
    per_branch = [per_branch[c] for c in range(4)]
    print(f"[{tag}] K1 at batch {FRCNN_TRAIN_BATCH} x {IMG_SIZE}^2 "
          f"vs its plain version: max abs diff by branch {per_branch} "
          f"(clean, noise, blur, lowres; bars 0 / 1 / 0 / 1), noise mean "
          f"{nmean} std {nstd} (bars -0.5 +- 0.5, 15 +- 0.5)")
    require(per_branch[0] == 0 and per_branch[2] == 0
            and per_branch[1] <= 1 and per_branch[3] <= 1,
            f"K1 at batch {FRCNN_TRAIN_BATCH}: {per_branch}")
    require(abs(nmean + 0.5) <= 0.5 and abs(nstd - 15.0) <= 0.5,
            f"K1 noise mean {nmean} std {nstd}")


def frcnn_step_timing(dev, model, tag):
    """1 + 5 steps of `model` (its compute dtype) on one seeded batch at
    bench_frcnn's configuration through make_train_step, draws from
    step_generator on the card. Launch counters zeroed just before the timed
    steps and read just after (K1 1 and NMS 1 a step, every other hand kernel
    0); finite metrics; step ms, images/s, peak memory; CUDA-event ms of each
    stage (wrappers around the step's own calls); the idle share of one
    profiled step; the FLOP bound beside the step; the peak memory RoIAlign +
    the box head's forward and backward add. Returns the launch counts."""
    import functools
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.ops import nms as NM
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    g = torch.Generator(dev).manual_seed(SEED + 13)
    tx, _ = TFR.make_optimizer()
    state = TFR.init_state(model, tx)
    step = TFR.make_train_step(model, IMG_SIZE, CorruptionConfig(),
                               augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 14),
                                     FRCNN_TRAIN_BATCH, IMG_SIZE,
                                     GT_PER_IMAGE, MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))

    m = step(state, images, gb, gc, SEED)          # warm-up, off the count
    torch.cuda.synchronize()
    require(all(math.isfinite(v.item()) for v in m.values()),
            "warm-up metrics not finite")

    # stage events: wrappers around the step's own calls
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def timed(fn, name):
        @functools.wraps(fn)
        def run(*a, **k):
            mark(f"{name}>")
            out = fn(*a, **k)
            mark(f"{name}<")
            return out
        return run
    real = {"extract": model.extract, "roi_forward": model.roi_forward,
            "opt": state.optimizer.step}
    patched = [(TFR, "fused_random_corruption"), (TFR, "rpn_loss"),
               (FR, "generate_proposals"), (TFR, "roi_targets"),
               (TFR, "head_loss")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in patched]
    for mod, n, fn in saved:
        setattr(mod, n, timed(fn, n))
    model.extract = timed(real["extract"], "extract")
    model.roi_forward = timed(real["roi_forward"], "roi_forward")
    state.optimizer.step = timed(real["opt"], "sgd")

    counters = dict(all_kernel_counters(), nms=NM._nms_core)
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times, events = [], []
    try:
        for i in range(TRAIN_STEPS):
            marks.clear()
            t0 = time.perf_counter()
            mark("step>")
            m = step(state, images, gb, gc, SEED)
            mark("step<")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            events.append(dict(marks))
            vals = {k: v.item() for k, v in m.items()}
            print(f"[{tag}] step {i}: {vals}")
            require(all(math.isfinite(v) for v in vals.values()),
                    f"step {i}: a metric is not finite")
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
        del model.extract, model.roi_forward
        state.optimizer.step = real["opt"]
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    expect = dict.fromkeys(counters, 0)
    expect["fused_random_corruption"] = expect["nms"] = TRAIN_STEPS
    print(f"[{tag}] launches {launches}")
    require(launches == expect, f"launch counts {launches} != {expect}")

    spans = (("K1", "fused_random_corruption>", "fused_random_corruption<"),
             ("backbone + FPN + RPN forward", "extract>", "extract<"),
             ("RPN targets + loss", "rpn_loss>", "rpn_loss<"),
             ("proposals (top-k + 512-step NMS)", "generate_proposals>",
              "generate_proposals<"),
             ("RoI targets", "roi_targets>", "roi_targets<"),
             ("RoIAlign + box head forward", "roi_forward>", "roi_forward<"),
             ("head loss", "head_loss>", "head_loss<"),
             ("backward (+ grad norm)", "head_loss<", "sgd>"),
             ("SGD", "sgd>", "sgd<"),
             ("step (events)", "step>", "step<"))
    stages = [{name: ev[a].elapsed_time(ev[b]) for name, a, b in spans}
              for ev in events]
    ms = statistics.median(times)
    print(f"[{tag}] Faster R-CNN {str(model.dtype)[6:]} {IMG_SIZE}px batch "
          f"{FRCNN_TRAIN_BATCH}, augment, {GT_PER_IMAGE} GT in {MAX_BOXES} "
          f"slots (cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}): step "
          f"ms {times} median {ms} = {FRCNN_TRAIN_BATCH / (ms / 1e3)} "
          f"images/s; peak memory {peak} bytes ({peak / 2 ** 30} GiB)")
    for k in stages[0]:
        vals = [s[k] for s in stages]
        print(f"[{tag}] stage {k}: events ms median "
              f"{statistics.median(vals)} (steps {vals})")

    # the work: forward multiply-adds of every conv and linear of one
    # train step, counted at F.conv2d / F.linear (the model calls both
    # through its modules and through resnet.conv / resnet.linear);
    # backward is twice the forward (dX and dW) less the stem's dX
    import torch.nn.functional as TF_
    macs = {"fwd": 0, "stem": 0}
    real_conv, real_linear = TF_.conv2d, TF_.linear

    def conv2d(x, w, *a, **k):
        out = real_conv(x, w, *a, **k)
        n = out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        macs["fwd"] += n
        if tuple(w.shape) == (64, 3, 7, 7):
            macs["stem"] += n
        return out

    def linear(x, w, *a, **k):
        out = real_linear(x, w, *a, **k)
        macs["fwd"] += out.numel() * w.shape[1]
        return out
    TF_.conv2d, TF_.linear = conv2d, linear
    try:
        step(state, images, gb, gc, SEED)
    finally:
        TF_.conv2d, TF_.linear = real_conv, real_linear
    flops = 2 * (3 * macs["fwd"] - macs["stem"])
    print(f"[{tag}] work: forward {macs['fwd'] / 1e9} GMAC a batch "
          f"(convs and linears, counted at F.conv2d / F.linear), forward + "
          f"backward {flops / 1e12} TFLOP; bound {flops / FRCNN_PEAK_TF32 * 1e3} ms "
          f"at 494 TFLOP/s TF32, {flops / PEAK_FLOPS['float32'] * 1e3} ms at "
          f"67 TFLOP/s f32, {flops / PEAK_FLOPS['bfloat16'] * 1e3} ms at "
          f"989 TFLOP/s bf16, against the step's {ms} ms")
    wall, busy, idle = idle_share(lambda: step(state, images, gb, gc, SEED))
    print(f"[{tag}] one profiled step: wall {wall} ms, device busy "
          f"{busy} ms, idle share {idle}")

    # RoIAlign + box head forward and backward on this step's shapes
    with torch.no_grad():
        pyr = [p.detach().requires_grad_() for p in
               model.extract(images.float() / 255.0)[0]]
        rois = torch.rand(FRCNN_TRAIN_BATCH, model.cfg.roi_batch, 4,
                          device=dev, generator=g) * (IMG_SIZE / 2)
        rois[..., 2:] += rois[..., :2] + 8.0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    s, d = model.roi_forward(pyr, rois, train=True)
    (s.sum() + d.sum()).backward()
    torch.cuda.synchronize()
    roi_peak = torch.cuda.max_memory_allocated(dev) - before
    print(f"[{tag}] RoIAlign + box head forward and backward at "
          f"batch {FRCNN_TRAIN_BATCH}, {model.cfg.roi_batch} RoIs an image: "
          f"peak memory it adds {roi_peak} bytes ({roi_peak / 2 ** 30} GiB)")
    return {"corrupt": launches["fused_random_corruption"]}


# ── The YOLOv8m and RT-DETR-L trainers (phases 25-26) ────────────────────

TRAINER_SPLITS = {"yolo": (32, 16), "rtdetr": (16, 8)}   # train, val images


def trainer_split(root, n_train: int, n_val: int, seed: int):
    """A COCO root without image files: the annotation JSONs of n_train +
    n_val IMG_SIZE x IMG_SIZE images with GT_PER_IMAGE boxes each (boxes
    and classes as detection_batch draws them), and the images themselves
    in memory, by image id, for the trainers' load_image."""
    import numpy as np
    rng = np.random.RandomState(seed)
    images = {}
    for split, ids in (("train", range(1, n_train + 1)),
                       ("val", range(n_train + 1, n_train + n_val + 1))):
        imgs, anns = [], []
        for i in ids:
            images[i] = rng.randint(0, 255, (IMG_SIZE, IMG_SIZE, 3),
                                    dtype=np.uint8)
            imgs.append({"id": i, "file_name": f"{i:06d}.jpg",
                         "width": IMG_SIZE, "height": IMG_SIZE})
            xy = rng.rand(GT_PER_IMAGE, 2) * (IMG_SIZE - 100)
            wh = rng.rand(GT_PER_IMAGE, 2) * 60 + 8
            for (x, y), (w, h), c in zip(xy, wh,
                                         rng.randint(1, 7, GT_PER_IMAGE)):
                anns.append({"id": len(anns) + 1, "image_id": i,
                             "bbox": [float(x), float(y), float(w), float(h)],
                             "area": float(w * h), "category_id": int(c),
                             "iscrowd": 0})
        path = Path(root) / "annotations" / f"instances_{split}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"images": imgs, "annotations": anns,
                                    "categories": [{"id": k, "name": str(k)}
                                                   for k in range(1, 7)]}))
    return images


def timed_steps(module, counters, records):
    """Wrap module.make_train_step so that each step synchronizes the card
    and appends (wall ms, launch counts of that step) to records; returns
    the function to restore."""
    import torch
    real = module.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def timed(*args):
            before = {n: f.launches for n, f in counters.items()}
            t0 = time.perf_counter()
            m = step(*args)
            torch.cuda.synchronize()
            records.append(((time.perf_counter() - t0) * 1e3,
                            {n: f.launches - before[n]
                             for n, f in counters.items()}, m))
            return m
        return timed
    module.make_train_step = make
    return lambda: setattr(module, "make_train_step", real)


def profiled_idle(fn):
    """(wall ms, device busy ms, idle share) of one call of `fn` under the
    profiler: busy is the union of the device's kernel and copy
    intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    require(bool(dev_ev), "the profiler recorded no device events")
    busy = union_us((e.time_range.start, e.time_range.end)
                    for e in dev_ev) / 1e3
    return wall, busy, 1 - busy / wall


def same_detections(a, b) -> bool:
    return all(torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y) -> bool:
    import torch
    return x.shape == y.shape and bool(torch.equal(x, y))


def detection_gap(a, b) -> float:
    """Largest score difference of two detection tuples (inf when their
    valid masks or classes differ)."""
    if not (torch_equal(a[3], b[3]) and torch_equal(a[2], b[2])):
        return math.inf
    return (a[1].float() - b[1].float()).abs().max().item()


def ema_check(tag, state_of, load, predict, raw_predict, images):
    """The trainer's EMA path on one val batch: the EMA predict step on
    the trained state (what every validation runs) gives exactly the
    detections of the module load_checkpoint builds with the EMA weights,
    and not those of the raw weights; the EMA differs from the
    parameters."""
    import torch
    state = state_of()
    diff = max(((state.ema[n] - p.detach()).abs().max()
                / (p.detach().abs().max() + 1e-30)).item()
               for n, p in state.model.named_parameters() if n in state.ema)
    ema_out = predict(state, images)
    loaded = load()
    ref = raw_predict(loaded, images)
    state.model.eval()
    raw = raw_predict(state.model, images)
    torch.cuda.synchronize()
    gap_ema, gap_raw = detection_gap(ema_out, ref), detection_gap(raw, ref)
    print(f"[{tag}] EMA check on a val batch: the EMA's largest relative "
          f"difference from the parameters {diff}; the trainer's EMA "
          f"predict step vs load_checkpoint's module: identical "
          f"{same_detections(ema_out, ref)} (score gap {gap_ema}); the raw "
          f"weights vs load_checkpoint's module: score gap {gap_raw}; "
          f"valid detections {int(ref[3].sum())}")
    require(diff > 0, f"{tag}: the EMA equals the parameters")
    require(same_detections(ema_out, ref),
            f"{tag}: the EMA predict step differs from load_checkpoint's "
            f"EMA module (score gap {gap_ema})")
    require(not same_detections(raw, ref),
            f"{tag}: the raw weights predict what the EMA does")
    return loaded


def trainer_state(D, create, payload):
    """A TrainState as the trainer holds it after its run: a train-mode
    module with the payload's weights and statistics, and its EMA."""
    model = create()
    model.load_state_dict(payload["model"])
    return D.TrainState(model, payload["ema"], None, None)


def phase_yolo_trainer(dev):
    """YOLOv8m (nc 6) at 1024 px, batch 16, bf16, augment + HSV/flip,
    through train.detector.train on an in-memory COCO split (32 train
    images, 16 val, images served by load_image=): 2 epochs (mosaic +
    affine, then plain; close_mosaic 1), validation every epoch, a
    checkpoint every step. Per step K1 1, K2-f train 1, K2-b 1, K3-f 8,
    K3-b 4; each validation forward K2-f eval 1, K3-f 4. History with both
    epochs and their mAPs, best and last written; a second call with 3
    epochs resumes at epoch 3. The EMA check (ema_check) and
    load_checkpoint. Step ms, images/s, peak memory, the idle share of the
    resumed run, and the host ms of a batch of mosaic + affine. Returns the
    launch counts."""
    import tempfile

    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import (
        ExperimentConfig, MeshConfig, TrainConfig)
    from robust_object_detection_tpu_torch.data import pipeline as pipe
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    from robust_object_detection_tpu_torch.train import augment as A
    from robust_object_detection_tpu_torch.train import detector as D

    torch.cuda.init()       # the phase may run first in its process
    n_train, n_val = TRAINER_SPLITS["yolo"]
    counters = {"corrupt": FC.fused_random_corruption,
                "yolo_front_train": TF.front_fused,
                "yolo_front_bwd": TF.front_fused_backward,
                "yolo_front": TF.front_inference,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad}
    per_step = {"corrupt": 1, "yolo_front_train": 1, "yolo_front_bwd": 1,
                "yolo_front": 0, "conv3x3": 8, "conv3x3_wgrad": 4}
    per_val = {"corrupt": 0, "yolo_front_train": 0, "yolo_front_bwd": 0,
               "yolo_front": 1, "conv3x3": 4, "conv3x3_wgrad": 0}
    cfg = ExperimentConfig(train=TrainConfig(seed=SEED),
                           mesh=MeshConfig(data=1, model=1))
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "coco", Path(tmp) / "run"
        images = trainer_split(root, n_train, n_val, SEED + 20)

        def load(sample):
            return images[sample.image_id]
        samples = pipe.index_coco(root, "train")
        host = []
        for _ in range(2):
            it = A.mosaic_batches(samples, TRAIN_BATCH, IMG_SIZE,
                                  max_boxes=MAX_BOXES, seed=SEED,
                                  load_image=load)
            t0 = time.perf_counter()
            next(it)
            host.append((time.perf_counter() - t0) * 1e3)
            it.close()
        kw = dict(augment=True, variant="m", img_size=IMG_SIZE,
                  batch_size=TRAIN_BATCH, max_boxes=MAX_BOXES,
                  base_augment=True, mosaic=True, close_mosaic=1,
                  val_interval=1, dtype="bfloat16", save_every_steps=1,
                  device=dev, load_image=load)
        records = []
        restore = timed_steps(D, counters, records)
        for f in counters.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            res = D.train(cfg, root, out, epochs=2, **kw)
            wall = time.perf_counter() - t0
        finally:
            restore()
        launches = {k: f.launches for k, f in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        steps = 2 * n_train // TRAIN_BATCH
        vals = 2 * -(-n_val // TRAIN_BATCH)
        for i, (ms, step_counts, m) in enumerate(records):
            vals_i = {k: v.item() for k, v in m.items()}
            print(f"[yolo-trainer] step {i}: {ms} ms, launches "
                  f"{step_counts}, {vals_i}")
            require(step_counts == per_step,
                    f"step {i} launches {step_counts} != {per_step}")
            require(all(math.isfinite(v) for v in vals_i.values()),
                    f"step {i}: a metric is not finite")
        expect = {k: per_step[k] * steps + per_val[k] * vals
                  for k in counters}
        print(f"[yolo-trainer] launches of the run {launches} expected "
              f"{expect} ({steps} steps, {vals} validation forwards)")
        require(len(records) == steps == res["steps"], "step count")
        require(launches == expect, f"launches {launches} != {expect}")
        hist = [json.loads(line) for line in
                (out / "history.jsonl").read_text().splitlines()]
        print(f"[yolo-trainer] history {hist}")
        require([h["epoch"] for h in hist] == [1, 2] and all(
            {"train_loss", "lr", "mAP50", "mAP50_95"} <= set(h)
            and math.isfinite(h["train_loss"]) for h in hist),
            "history of the two epochs")
        ckpt = out / "ckpt"
        require((ckpt / "best").exists() and (ckpt / "last" / "4").exists(),
                "best and last written")
        ms = statistics.median(r[0] for r in records)
        print(f"[yolo-trainer] YOLOv8m bf16 1024px batch {TRAIN_BATCH}, "
              f"augment + HSV/flip, through train(): step ms "
              f"{[r[0] for r in records]} median {ms} = "
              f"{TRAIN_BATCH / (ms / 1e3)} images/s; the run {wall} s; peak "
              f"memory {peak} bytes ({peak / 2 ** 30} GiB); host mosaic + "
              f"affine of one batch of {TRAIN_BATCH} at {IMG_SIZE} px: "
              f"{host} ms")

        # load_checkpoint reads `best`: hold it against the same payload
        payload = torch.load(ckpt / "best", map_location=dev,
                             weights_only=True)["state"]
        val = pipe.index_coco(root, "val")[:TRAIN_BATCH]
        batch = torch.from_numpy(np.stack(
            [images[s.image_id] for s in val])).to(dev)
        ema_check("yolo-trainer",
                  lambda: trainer_state(D, lambda: Y.create(
                      6, "m", torch.bfloat16, dev, train=True,
                      bn_dtype=torch.bfloat16), payload),
                  lambda: D.load_checkpoint(out, "m", torch.bfloat16, dev),
                  D.make_predict_step(IMG_SIZE, use_ema=True),
                  D.make_predict_step(IMG_SIZE), batch)

        for f in counters.values():
            f.launches = 0
        box = {}
        wall3, busy, idle = profiled_idle(
            lambda: box.update(D.train(cfg, root, out, epochs=3, **kw)))
        hist = [json.loads(line) for line in
                (out / "history.jsonl").read_text().splitlines()]
        resumed = {k: f.launches for k, f in counters.items()}
        expect = {k: per_step[k] * 2 + per_val[k] for k in counters}
        print(f"[yolo-trainer] resumed with epochs=3: epochs "
              f"{[h['epoch'] for h in hist]}, steps {box['steps']}, launches "
              f"{resumed} expected {expect}; under the profiler {wall3} ms, "
              f"device busy {busy} ms, idle share {idle}")
        require([h["epoch"] for h in hist] == [1, 2, 3]
                and box["steps"] == steps + 2, "the resume at epoch 3")
        require(resumed == expect, f"resumed launches {resumed}")
        for k, v in resumed.items():
            launches[k] += v
    return {k: v for k, v in launches.items()}


def greedy_np(cost):
    """The reference's greedy matcher in numpy: each round the first
    global argmin, its row and column set to BIG, for min(Q, M) rounds or
    until only costs >= BIG / 2 remain. Returns (rows, cols) (B, K)."""
    import numpy as np
    big = 1e6
    b, q, m = cost.shape
    k = min(q, m)
    rows = np.zeros((b, k), np.int64)
    cols = np.full((b, k), m, np.int64)
    for i in range(b):
        c = cost[i].copy()
        for j in range(k):
            if c.min() >= big / 2:
                break
            idx = int(np.argmin(c))
            rows[i, j], cols[i, j] = idx // m, idx % m
            c[rows[i, j], :] = big
            c[:, cols[i, j]] = big
    return rows, cols


def phase_rtdetr_trainer(dev):
    """RT-DETR-L at 1024 px, batch 8, bf16, augment + HSV/flip + CDN,
    through train.rtdetr.train on an in-memory COCO split (16 train, 8
    val): 2 epochs (close_mosaic 1), then a second call with 3 epochs that
    resumes at epoch 3 (``last`` keyed by epoch) with ASSIGNMENT "greedy".
    Per step K1 1, K4-f train 1, K4-b 1, K3-f 12, K3-b 6, K5 forward 6,
    K5 backward 6, K6 7 (0 under greedy); each validation forward K4-f
    eval 1, K5 forward 6, K3-f 6. matcher_capped in the history; the
    greedy matcher's pairs on the cost of the epoch's first matching
    against an independent numpy greedy; load_checkpoint against the EMA
    predict step. Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import (
        ExperimentConfig, MeshConfig, TrainConfig)
    from robust_object_detection_tpu_torch.data import pipeline as pipe
    from robust_object_detection_tpu_torch.models import rtdetr as R
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.train import detector as D
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    torch.cuda.init()
    nb = RTDETR_TRAIN_BATCH
    n_train, n_val = TRAINER_SPLITS["rtdetr"]
    counters = {"corrupt": FC.fused_random_corruption,
                "hgstem_train": ST.stem_fused,
                "hgstem_bwd": ST.stem_fused_backward,
                "hgstem": ST.stem_fused_inference,
                "conv3x3": C.conv3x3, "conv3x3_wgrad": C.conv3x3_wgrad,
                "ms_deform_attn": DF.ms_deform_attn_slots,
                "ms_deform_attn_bwd": DF.ms_deform_attn_backward,
                "auction": AS.auction_assignment}
    per_step = {"corrupt": 1, "hgstem_train": 1, "hgstem_bwd": 1,
                "hgstem": 0, "conv3x3": 12, "conv3x3_wgrad": 6,
                "ms_deform_attn": 6, "ms_deform_attn_bwd": 6, "auction": 7}
    per_val = {k: 0 for k in per_step}
    per_val.update(hgstem=1, conv3x3=6, ms_deform_attn=6)
    cfg = ExperimentConfig(train=TrainConfig(seed=SEED),
                           mesh=MeshConfig(data=1, model=1))
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "coco", Path(tmp) / "run"
        images = trainer_split(root, n_train, n_val, SEED + 30)

        def load(sample):
            return images[sample.image_id]
        kw = dict(augment=True, img_size=IMG_SIZE, batch_size=nb,
                  max_boxes=MAX_BOXES, base_augment=True, mosaic=True,
                  close_mosaic=1, val_interval=1, dtype="bfloat16",
                  device=dev, load_image=load)
        steps = n_train // nb
        vals = -(-n_val // nb)
        runs = {}
        for epochs, method in ((2, "auction"), (3, "greedy")):
            records, seen = [], []
            restore = timed_steps(RT, counters, records)
            solve = RT._solve_assignment

            def recording(cost, exact=False):
                out_ = solve(cost, exact)
                if not seen:
                    seen.append((cost.cpu().numpy(),
                                 tuple(t.cpu().numpy() for t in out_)))
                return out_
            RT._solve_assignment = recording
            RT.ASSIGNMENT = method
            for f in counters.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                t0 = time.perf_counter()
                res = RT.train(cfg, root, out, epochs=epochs, **kw)
                wall = time.perf_counter() - t0
            finally:
                restore()
                RT._solve_assignment = solve
                RT.ASSIGNMENT = "auction"
            launches = {k: f.launches for k, f in counters.items()}
            n_epochs = 2 if epochs == 2 else 1
            want_step = dict(per_step, auction=per_step["auction"]
                             if method == "auction" else 0)
            for i, (ms, step_counts, m) in enumerate(records):
                vals_i = {k: v.item() for k, v in m.items()}
                print(f"[rtdetr-trainer] {method} step {i}: {ms} ms, "
                      f"launches {step_counts}, {vals_i}")
                require(step_counts == want_step,
                        f"{method} step {i} launches {step_counts}")
                require(all(math.isfinite(v) for v in vals_i.values()),
                        f"{method} step {i}: a metric is not finite")
            expect = {k: want_step[k] * steps * n_epochs
                      + per_val[k] * vals * n_epochs for k in counters}
            print(f"[rtdetr-trainer] {method}, epochs={epochs}: launches "
                  f"{launches} expected {expect}; the run {wall} s, peak "
                  f"memory {torch.cuda.max_memory_allocated(dev)} bytes")
            require(launches == expect, f"{method} launches {launches}")
            require(len(records) == steps * n_epochs, f"{method} steps")
            ms = statistics.median(r[0] for r in records)
            print(f"[rtdetr-trainer] RT-DETR-L bf16 1024px batch {nb}, "
                  f"augment + HSV/flip + CDN, matcher {method}, through "
                  f"train(): step ms {[r[0] for r in records]} median {ms} "
                  f"= {nb / (ms / 1e3)} images/s")
            runs[method] = (launches, seen, res)
        hist = [json.loads(line) for line in
                (out / "history.jsonl").read_text().splitlines()]
        print(f"[rtdetr-trainer] history {hist}")
        require([h["epoch"] for h in hist] == [1, 2, 3] and all(
            {"train_loss", "lr", "mAP50", "matcher_capped"} <= set(h)
            for h in hist), "history with matcher_capped, resumed at 3")
        require(runs["greedy"][2]["steps"] == 3 * steps, "resumed steps")
        require(sorted(p.name for p in (out / "ckpt" / "last").iterdir())
                == ["2", "3"], "last keyed by epoch")
        cost, (rows, cols) = runs["greedy"][1][0]
        want = greedy_np(cost)
        pairs = int((want[1] < cost.shape[2]).sum())
        print(f"[rtdetr-trainer] greedy matcher on the first cost of epoch "
              f"3 {cost.shape}: {pairs} pairs, equal to the numpy greedy "
              f"{bool((rows == want[0]).all() and (cols == want[1]).all())}")
        require((rows == want[0]).all() and (cols == want[1]).all(),
                "the greedy matcher's pairs differ from the numpy greedy")

        payload = torch.load(out / "ckpt" / "best", map_location=dev,
                             weights_only=True)["state"]
        val = pipe.index_coco(root, "val")[:nb]
        batch = torch.from_numpy(np.stack(
            [images[s.image_id] for s in val])).to(dev)
        ema_check("rtdetr-trainer",
                  lambda: trainer_state(D, lambda: R.create(
                      6, torch.bfloat16, dev, train=True,
                      bn_dtype=torch.bfloat16), payload),
                  lambda: RT.load_checkpoint(out, torch.bfloat16, dev),
                  RT.make_predict_step(IMG_SIZE, use_ema=True),
                  RT.make_predict_step(IMG_SIZE), batch)
    total = {}
    for launches, _, _ in runs.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


# ── The CLI on the card (phase 27) ───────────────────────────────────────

CLI_SPLITS = (32, 16)                       # train, val images
CLI_SIZE_RANGE = ((540, 800), (960, 1400))  # straddles 765x1360 and 1024
CLI_EVEN_HW = (766, 1360)    # the fused sweep's split: even native dims
# cv2.resize(INTER_LINEAR) of RandomState(1700 + i).randint(0, 256, (h, w,
# 3)) as uint8 to (nw, nh): SHA-256 of the bytes, taken with cv2 5.0
RESIZE_GOLDEN = (
    ((765, 1360), (1024, 576),
     "0ac4ac43f807e9f7de71608d2afcc2d5f49edd9961adc1055ac510d45ac3eb00"),
    ((1080, 1920), (1024, 576),
     "84c45e8d16e5f132700617748f630bbf1a904f5176be2771fea31cb973254b3a"),
    ((540, 960), (1024, 576),
     "4aa69333be1c8613ff61b976d38d2c5447ddaa60478ef070b621621c61548ccc"),
    ((800, 1400), (1024, 585),
     "ad07dfddc5c428cc5fbe5a5a5fd08fe801624f68768edebf07465b92f9d1f4ca"),
    ((766, 1360), (680, 383),
     "a55d62f3b09d9ad3bfa22f743eefd87407c210a6f2d8ceef08e07bbc63541eb4"),
    ((97, 131), (1003, 611),
     "d3e1fc3e3121b04e6464c054f12c76ce37cc8cc1af2e87edb308d281ec5fc8df"),
    ((1003, 611), (97, 131),
     "33cc058b4e9c67f72bdb0eba368dceb8c70fe899cfd1dc6156acb1058887896f"))
# PIL's Image.fromarray(img).save(buf, "BMP") of RandomState(1800 + i)
# .randint(0, 256, (h, w, 3)) as uint8: SHA-256 of the file's bytes
BMP_GOLDEN = (
    ((5, 7), "dc5b4ee92b20f3b408dfe6a6b39d2696f62b50d13318b0d871778f298dc3bf39"),
    ((6, 1), "0e13b4548929a5b23fd4013601bfa96cf12f9dbc0b04c755541f052f4a9c98d3"),
    ((3, 4), "79879c237350c299cc22a356da38dc81dc4f432c957dd194bd66562c7cad252a"))


def summary_counters():
    """The fifteen wrappers' launch counters under the summary's names."""
    from robust_object_detection_tpu_torch.ops import assignment as AS
    from robust_object_detection_tpu_torch.ops import conv3x3 as C
    from robust_object_detection_tpu_torch.ops import deform as DF
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.ops import stem as ST
    from robust_object_detection_tpu_torch.ops import yolo_front as TF
    return {"conv3x3": C.conv3x3, "yolo_front": TF.front_inference,
            "conv3x3_wgrad": C.conv3x3_wgrad,
            "yolo_front_train": TF.front_fused,
            "yolo_front_bwd": TF.front_fused_backward,
            "corrupt": FC.fused_random_corruption,
            "hgstem": ST.stem_fused_inference,
            "ms_deform_attn": DF.ms_deform_attn_slots,
            "hgstem_train": ST.stem_fused,
            "hgstem_bwd": ST.stem_fused_backward,
            "ms_deform_attn_bwd": DF.ms_deform_attn_backward,
            "auction": AS.auction_assignment,
            "ms_deform_attn_sorted": DF.ms_deform_attn_sorted_forward,
            "ms_deform_attn_sorted_bwd": DF.ms_deform_attn_sorted_backward,
            "stamp_scatter": DF.stamp_scatter}


SUMMARY_NAMES = ("conv3x3", "yolo_front", "conv3x3_wgrad",
                 "yolo_front_train", "yolo_front_bwd", "corrupt", "hgstem",
                 "ms_deform_attn", "hgstem_train", "hgstem_bwd",
                 "ms_deform_attn_bwd", "auction", "ms_deform_attn_sorted",
                 "ms_deform_attn_sorted_bwd", "stamp_scatter")


def per_call(**counts):
    """A launch-count dict over the fifteen summary names."""
    out = dict.fromkeys(SUMMARY_NAMES, 0)
    out.update(counts)
    return out


# launches of one train step / one forward, as phases 24-26 count them
CLI_EXPECT = {
    "yolo_step": per_call(corrupt=1, yolo_front_train=1, yolo_front_bwd=1,
                          conv3x3=8, conv3x3_wgrad=4),
    "yolo_fwd": per_call(yolo_front=1, conv3x3=4),
    "rtdetr_step": per_call(corrupt=1, hgstem_train=1, hgstem_bwd=1,
                            conv3x3=12, conv3x3_wgrad=6, ms_deform_attn=6,
                            ms_deform_attn_bwd=6, auction=7),
    "rtdetr_fwd": per_call(hgstem=1, conv3x3=6, ms_deform_attn=6),
    "frcnn_step": per_call(corrupt=1),
    "frcnn_fwd": per_call(),
}


class CallRecorder:
    """Wraps factories (make_train_step, make_predict_step) so that every
    call of what they build synchronizes the card and records (tag, the
    launches of that call, a SHA-256 of its outputs for forwards)."""

    def __init__(self, counters):
        self.counters = counters
        self.records = []
        self._undo = []

    def wrap(self, module, attr, tag, digest=False):
        import functools
        real = getattr(module, attr)
        rec = self

        @functools.wraps(real)
        def factory(*a, **k):
            fn = real(*a, **k)

            def call(*args, **kw):
                import hashlib

                import torch
                before = {n: f.launches for n, f in rec.counters.items()}
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                h = None
                if digest:
                    h = hashlib.sha256()
                    for t in out:
                        h.update(t.detach().cpu().numpy().tobytes())
                    h = h.hexdigest()
                rec.records.append((tag, {
                    n: f.launches - before[n]
                    for n, f in rec.counters.items()}, h))
                return out
            return call
        setattr(module, attr, factory)
        self._undo.append((module, attr, real))

    def restore(self):
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo = []


def cli_runner(log, counters, rec, reads, seconds, launches):
    """run(tag, *argv, steps=, forwards=): one command through cli.main on
    the card, with the counters zeroed just before and read just after;
    every recorded step / forward launches what CLI_EXPECT says, and they
    account for every launch of the command; `reads` is emptied before it.
    Returns (the command's result, its recorded calls)."""
    import torch
    from robust_object_detection_tpu_torch import cli

    def run(tag, *argv, steps=None, forwards=None):
        for f in counters.values():
            f.launches = 0
        start = len(rec.records)
        del reads[:]
        t0 = time.perf_counter()
        out = cli.main(list(argv) + ["--device", "cuda"])
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        got = {n: f.launches for n, f in counters.items()}
        calls = rec.records[start:]
        for kind, counts, _ in calls:
            want = dict(CLI_EXPECT[kind])
            if kind == "yolo_step" and "--augment" not in argv:
                want["corrupt"] = 0      # Baseline: no K1
            require(counts == want, f"{tag}: a {kind} launched {counts}, "
                                    f"expected {want}")
        summed = {n: sum(c[n] for _, c, _ in calls) for n in counters}
        require(got == summed, f"{tag}: launches {got} outside the "
                               f"recorded steps and forwards {summed}")
        kinds = {}
        for kind, _, _ in calls:
            kinds[kind] = kinds.get(kind, 0) + 1
        for kind, n in (steps or {}).items():
            require(kinds.get(kind, 0) == n,
                    f"{tag}: {kinds.get(kind, 0)} {kind}, expected {n}")
        for kind, n in (forwards or {}).items():
            require(kinds.get(kind, 0) == n,
                    f"{tag}: {kinds.get(kind, 0)} {kind}, expected {n}")
        for n, v in got.items():
            launches[n] += v
        print(f"[{log}] {tag}: {seconds[tag]} s; calls {kinds}; launches "
              f"{ {n: v for n, v in got.items() if v} }")
        return out, calls
    return run


def hold_bmp_and_resize():
    """imageio against golden digests taken with PIL and cv2 elsewhere
    (neither is needed here): the BMP writer's bytes, resize_linear_u8's
    outputs byte for byte; a round trip; the host ms of a BMP decode and
    of the 765x1360 -> 576x1024 resize (median of 5)."""
    import hashlib
    import tempfile

    import numpy as np
    from robust_object_detection_tpu_torch.data import imageio as IO

    for i, ((h, w), want) in enumerate(BMP_GOLDEN):
        img = np.random.RandomState(1800 + i).randint(
            0, 256, (h, w, 3)).astype(np.uint8)
        got = hashlib.sha256(IO.bmp_bytes(img)).hexdigest()
        require(got == want, f"BMP bytes of a {h}x{w} image differ from "
                             f"PIL's: {got}")
    bad = []
    for i, ((h, w), (nw, nh), want) in enumerate(RESIZE_GOLDEN):
        img = np.random.RandomState(1700 + i).randint(
            0, 256, (h, w, 3)).astype(np.uint8)
        got = hashlib.sha256(IO.resize_linear_u8(img, nw, nh).tobytes())
        if got.hexdigest() != want:
            bad.append(((h, w), (nw, nh)))
    print(f"[cli] imageio: BMP bytes equal PIL's on {len(BMP_GOLDEN)} "
          f"images; resize_linear_u8 equal to cv2.resize(INTER_LINEAR) on "
          f"{len(RESIZE_GOLDEN) - len(bad)} of {len(RESIZE_GOLDEN)} shapes "
          f"(golden SHA-256)")
    require(not bad, f"resize_linear_u8 differs from cv2 at {bad}")
    img = np.random.RandomState(5).randint(0, 256, (765, 1360, 3)).astype(
        np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        p = Path(tmp) / "a.bmp"
        IO.write_rgb(p, img)
        dec, rsz = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            back = IO.read_rgb(p)
            dec.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            IO.resize_linear_u8(back, 1024, 576)
            rsz.append((time.perf_counter() - t0) * 1e3)
        require(np.array_equal(back, img), "BMP round trip")
    print(f"[cli] host ms an image, 765x1360: BMP decode {dec} median "
          f"{statistics.median(dec)}; resize_linear_u8 to 576x1024 {rsz} "
          f"median {statistics.median(rsz)}")
    return statistics.median(dec), statistics.median(rsz)


def same_testsets(card, cpu):
    """The card's build against the CPU's: the same manifest keys and
    counts, Clean and Noise byte-equal, Blur and LowRes within 1 LSB."""
    import numpy as np
    from robust_object_detection_tpu_torch.data import imageio as IO
    from robust_object_detection_tpu_torch.data import testsets as TS
    mc, mp = TS.testset_manifest(card), TS.testset_manifest(cpu)
    require(mc.keys() == mp.keys() and len(mc) == 8 and all(
        mc[k]["images"] == mp[k]["images"] == CLI_SPLITS[1] for k in mc),
        f"testset manifests: {mc} vs {mp}")
    worst = {}
    for key in mc:
        fmt, variant = key.split("/")
        dc = Path(card) / fmt / variant / "images" / "val"
        dp = Path(cpu) / fmt / variant / "images" / "val"
        names = sorted(p.name for p in dc.iterdir())
        require(names == sorted(p.name for p in dp.iterdir()),
                f"{key}: file names")
        for n in names:
            if variant in ("Test_Clean", "Test_Noise"):
                require((dc / n).read_bytes() == (dp / n).read_bytes(),
                        f"{key}/{n}: the card's bytes differ from the CPU's")
            else:
                d = int(np.abs(IO.read_rgb(dc / n).astype(int)
                               - IO.read_rgb(dp / n).astype(int)).max())
                worst[key] = max(worst.get(key, 0), d)
                require(d <= 1, f"{key}/{n}: {d} LSB from the CPU's")
    print(f"[cli] build-testsets card vs CPU: manifests alike "
          f"({len(mc)} x {CLI_SPLITS[1]} images), Clean and Noise "
          f"byte-equal, Blur / LowRes largest difference {worst} LSB (bar "
          f"1); sha256 equal in {sum(mc[k] == mp[k] for k in mc)} of "
          f"{len(mc)}")


def finite_results(path, strategies=None):
    """Every (model, variant) of a results JSON has finite mAPs."""
    res = json.loads(Path(path).read_text())
    n = 0
    for model, per in res.items():
        groups = ([per[s] for s in strategies] if strategies else [per])
        for g in groups:
            for variant, s in g.items():
                require(math.isfinite(s["mAP50"])
                        and math.isfinite(s["mAP50_95"]),
                        f"{path}: {model}/{variant} mAP not finite")
                n += 1
    return res, n


def phase_cli(dev):
    """The command-line pipeline on the card, through cli.main in this
    process, on a BMP split made by data/synthetic (32 train and 16 val
    images, sizes in CLI_SIZE_RANGE), with PIL and cv2 made unimportable
    for the phase. Returns the launch counts."""
    import shutil
    import tempfile

    import torch
    from robust_object_detection_tpu_torch import cli
    from robust_object_detection_tpu_torch.core.config import \
        RestorationConfig
    from robust_object_detection_tpu_torch.data import imageio as IO
    from robust_object_detection_tpu_torch.data import synthetic
    from robust_object_detection_tpu_torch.eval import detector_eval as DE
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.train import detector as D
    from robust_object_detection_tpu_torch.train import frcnn as FR
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    print("[cli] not run here: plot, plot-three and plot-vid need "
          "matplotlib and demo needs cv2, which this phase blocks; the CPU "
          "tests hold them (tests/test_torch_reports.py, "
          "tests/test_torch_cli.py)")
    blocked = {m: sys.modules.get(m) for m in ("PIL", "cv2")}
    for m in blocked:
        sys.modules[m] = None           # any import of them now raises
    counters = summary_counters()
    require(tuple(counters) == SUMMARY_NAMES, "summary counter names")
    rec = CallRecorder(counters)
    for module, tag in ((D, "yolo"), (RT, "rtdetr"), (FR, "frcnn")):
        rec.wrap(module, "make_train_step", f"{tag}_step")
        rec.wrap(module, "make_predict_step", f"{tag}_fwd", digest=True)
    reads = []
    real_read = IO.read_rgb

    def read_rgb(path):
        reads.append(str(path))
        return real_read(path)
    IO.read_rgb = read_rgb
    seconds, launches = {}, dict.fromkeys(counters, 0)
    n_train, n_val = CLI_SPLITS
    run = cli_runner("cli", counters, rec, reads, seconds, launches)

    try:
        decode_ms, resize_ms = hold_bmp_and_resize()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            raw = {s: synthetic.make_det_split(
                tmp / f"raw_{s}", n_images=n, seed=SEED + 30 + i,
                size_range=CLI_SIZE_RANGE, ext="bmp")
                for i, (s, n) in enumerate((("train", n_train),
                                            ("val", n_val)))}
            even = synthetic.make_det_split(
                tmp / "raw_even", n_images=n_val, seed=SEED + 32,
                size_range=tuple((v, v + 1) for v in CLI_EVEN_HW), ext="bmp")
            seconds["make splits"] = time.perf_counter() - t0
            sizes = sorted({IO.image_size(p) for p in
                            (raw["val"] / "images").iterdir()})
            print(f"[cli] BMP splits: {n_train} train + {n_val} val images, "
                  f"{len(sizes)} sizes from {sizes[0]} to {sizes[-1]} "
                  f"(W, H); {n_val} more at {CLI_EVEN_HW} for the fused "
                  f"sweep; {seconds['make splits']} s")
            proc = tmp / "processed"
            coco, yolo = proc / "visdrone_coco6", proc / "visdrone_yolo6"
            for s in ("train", "val"):
                run(f"convert-det-coco {s}", "convert-det-coco", "--src",
                    str(raw[s]), "--out", str(coco), "--split", s)
                run(f"convert-det-yolo {s}", "convert-det-yolo", "--src",
                    str(raw[s]), "--out", str(yolo), "--split", s)
            run("convert-det-coco even", "convert-det-coco", "--src",
                str(even), "--out", str(tmp / "even"), "--split", "val")
            for kind, root in (("visdrone-det", raw["val"]), ("coco", coco),
                               ("yolo", yolo)):
                run(f"validate {kind}", "validate", "--root", str(root),
                    "--kind", kind)
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "robust_object_detection_tpu_torch.cli",
                 "validate", "--root", str(coco), "--kind", "coco",
                 "--split", "train", "--device", "cuda"],
                cwd=str(Path(__file__).resolve().parent),
                env=dict(__import__("os").environ,
                         PYTHONPATH=str(Path(__file__).resolve().parent)),
                capture_output=True, text=True, timeout=300)
            seconds["validate (python -m)"] = time.perf_counter() - t0
            print(f"[cli] python -m ...cli validate: rc {res.returncode}, "
                  f"{res.stdout.strip().splitlines()[-2:]}, "
                  f"{seconds['validate (python -m)']} s")
            require(res.returncode == 0
                    and res.stdout.strip().endswith("[validate] OK"),
                    f"python -m cli validate failed: {res.stderr[-2000:]}")

            testsets, cpu_sets = tmp / "testsets", tmp / "testsets_cpu"
            run("build-testsets", "build-testsets", "--processed-root",
                str(proc), "--out", str(testsets))
            t0 = time.perf_counter()
            cli.main(["build-testsets", "--processed-root", str(proc),
                      "--out", str(cpu_sets), "--device", "cpu"])
            seconds["build-testsets (CPU)"] = time.perf_counter() - t0
            same_testsets(testsets, cpu_sets)
            shutil.rmtree(cpu_sets)

            rcfg = RestorationConfig()
            unet = tmp / "unet"
            out, _ = run("train-restoration", "train-restoration",
                         "--train-dir", str(coco / "images" / "train"),
                         "--val-dir", str(coco / "images" / "val"), "--out",
                         str(unet), "--max-steps", "5")
            print(f"[cli] U-Net at RestorationConfig's defaults (patch "
                  f"{rcfg.patch_size}, batch {rcfg.batch_size}), 5 steps: "
                  f"{out}")
            require(math.isfinite(out["best"]["psnr"]), "U-Net val PSNR")
            counts, _ = run("restore-testsets", "restore-testsets",
                            "--testset-root", str(testsets), "--unet-dir",
                            str(unet))
            want = {f"{f}/{v}": n_val for f in ("coco6", "yolo6") for v in (
                "Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")}
            require(counts == want, f"restore-testsets counts {counts}")

            ck = tmp / "ckpt"
            det_common = ["--data-root", str(coco), "--epochs", "1",
                          "--max-steps", "2", "--img-size", str(IMG_SIZE)]
            runs = (("yolo_baseline", "yolo", TRAIN_BATCH, []),
                    ("yolo_augmented", "yolo", TRAIN_BATCH, ["--augment"]),
                    ("rtdetr_augmented", "rtdetr", RTDETR_TRAIN_BATCH,
                     ["--augment"]),
                    ("frcnn_augmented", "frcnn", FRCNN_TRAIN_BATCH,
                     ["--augment", "--dtype", "float32"]))
            for name, kind, bs, extra in runs:
                out, _ = run(f"train-detector {name}", "train-detector",
                             "--model", kind, "--out", str(ck / name),
                             "--batch-size", str(bs), *det_common, *extra,
                             steps={f"{kind}_step": 2},
                             forwards={f"{kind}_fwd": -(-n_val // bs)})
                hist = json.loads((ck / name / "history.jsonl").read_text()
                                  .splitlines()[-1])
                print(f"[cli] {name}: {out}; history {hist}")
                require(out["steps"] == 2 and math.isfinite(
                    out["final_loss"]) and math.isfinite(hist["mAP50"]),
                    f"{name}: {out}, {hist}")

            models = {n: f"{n}={k}:{ck / n}" for n, k, _, _ in runs}
            exp = tmp / "experiments"
            sweep = ["--testset-root", str(testsets), "--img-size",
                     str(IMG_SIZE), "--batch-size", str(BATCH), "--out",
                     str(exp)]
            per_model = 4 * -(-n_val // BATCH)
            three = ("yolo_baseline", "rtdetr_augmented", "frcnn_augmented")
            _, calls = run("eval", "eval",
                           *(a for m in models.values()
                             for a in ("--model", m)), *sweep,
                           forwards={"yolo_fwd": 2 * per_model,
                                     "rtdetr_fwd": per_model,
                                     "frcnn_fwd": per_model})
            require(reads and all("/coco6/" in p for p in reads),
                    "eval read outside the coco6 testsets")
            cli_yolo = [h for k, _, h in calls if k == "yolo_fwd"][
                :per_model]
            run("eval-restored", "eval-restored",
                *(a for m in three for a in ("--model", models[m])), *sweep,
                forwards={"yolo_fwd": per_model, "rtdetr_fwd": per_model,
                          "frcnn_fwd": per_model})
            require(reads and all("/coco6_restored/" in p for p in reads),
                    "eval-restored read outside the coco6_restored testsets")
            run("eval-vid", "eval-vid",
                *(a for m in three for a in ("--model", models[m])), *sweep,
                forwards={"yolo_fwd": per_model, "rtdetr_fwd": per_model,
                          "frcnn_fwd": per_model})
            n_results = {}
            for name in ("eval_results", "eval_restored_results",
                         "vid_eval_results"):
                res, n_results[name] = finite_results(exp / f"{name}.json")
                require(set(res) == (set(models) if name == "eval_results"
                                     else set(three)), f"{name}: {set(res)}")
                print(f"[cli] {name}: ms an image from disk (1000 / "
                      f"images/s, batch {BATCH}) " + "; ".join(
                          f"{m} " + ", ".join(
                              f"{v[5:]} {1000 / s['images_per_sec']:.1f}"
                              for v, s in per.items())
                          for m, per in res.items()))

            fused_fwd = 8 * -(-n_val // BATCH)
            for parity in ("off", "coco6"):
                run(f"eval-fused {parity}", "eval-fused", "--model",
                    models["yolo_baseline"], "--model",
                    models["rtdetr_augmented"], "--data-root",
                    str(tmp / "even"), "--unet-dir", str(unet),
                    "--img-size", str(IMG_SIZE), "--batch-size", str(BATCH),
                    "--mt19937-parity", parity, "--out",
                    str(exp / f"fused_{parity}"),
                    forwards={"yolo_fwd": fused_fwd,
                              "rtdetr_fwd": fused_fwd})
                res, n = finite_results(
                    exp / f"fused_{parity}" / "fused_eval_results.json",
                    ("corrupted", "restored"))
                n_results[f"fused {parity}"] = n
                print(f"[cli] eval-fused {parity}: " + ", ".join(
                    f"{m} {r['images_per_sec']} image-passes/s"
                    for m, r in res.items()))
            print(f"[cli] finite mAPs: {n_results} (model, variant) cells")

            # the CLI's YOLOv8m mAPs and detections against the same sweep
            # in this process on load_checkpoint's EMA module, and against
            # the raw weights
            start = len(rec.records)
            ema = D.load_checkpoint(ck / "yolo_baseline", device=dev)
            ref = DE.evaluate_testsets(D.make_predict_step(IMG_SIZE), ema,
                                       testsets, IMG_SIZE, BATCH)
            ema_h = [h for _, _, h in rec.records[start:]]
            payload = torch.load(ck / "yolo_baseline" / "ckpt" / "best",
                                 map_location=dev, weights_only=True)[
                "state"]
            raw_model = Y.create(6, "m", device=dev)
            raw_model.load_state_dict(payload["model"])
            start = len(rec.records)
            DE.evaluate_testsets(D.make_predict_step(IMG_SIZE),
                                 raw_model.eval(), testsets, IMG_SIZE, BATCH)
            raw_h = [h for _, _, h in rec.records[start:]]
            cli_res = json.loads((exp / "eval_results.json").read_text())[
                "yolo_baseline"]
            same_maps = all(cli_res[v][k] == ref[v][k] for v in ref
                            for k in ("mAP50", "mAP50_95"))
            print(f"[cli] YOLOv8m eval through the CLI vs evaluate_testsets "
                  f"on load_checkpoint's module: mAPs equal {same_maps} "
                  f"({ {v: ref[v]['mAP50'] for v in ref} }), detections of "
                  f"all {len(ema_h)} forwards identical "
                  f"{cli_yolo == ema_h}; with the raw weights identical in "
                  f"{sum(a == b for a, b in zip(cli_yolo, raw_h))} of "
                  f"{len(raw_h)}")
            require(same_maps, "the CLI's YOLOv8m mAPs differ from "
                               "evaluate_testsets on load_checkpoint's "
                               "module")
            require(len(ema_h) == per_model and cli_yolo == ema_h,
                    "the CLI's YOLOv8m detections differ from "
                    "load_checkpoint's EMA module")
            require(any(a != b for a, b in zip(cli_yolo, raw_h)),
                    "the CLI's YOLOv8m detections are the raw weights'")
            held = Path(tempfile.mkdtemp(prefix="smoke_held_"))
            atexit.register(shutil.rmtree, held, True)
            HELD["unet"] = Path(shutil.move(str(unet), str(held / "unet")))
            HELD["yolo"] = Path(shutil.move(str(ck / "yolo_baseline"),
                                            str(held / "yolo_baseline")))
    finally:
        IO.read_rgb = real_read
        rec.restore()
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    print(f"[cli] seconds by command: {json.dumps(seconds)}")
    print(f"[cli] host ms an image: BMP decode {decode_ms}, resize "
          f"765x1360 -> 576x1024 {resize_ms}")
    return launches


# ── The host codec and the JPEG pipeline (phase 30) ─────────────────────

HELD = {}      # phase 27's U-Net directory and YOLOv8m checkpoint
JPEG_FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
VID_HW = (756, 1344)                 # a VisDrone-VID frame
VID_SEQS, VID_FRAMES = 2, 4
CODEC_TIMED = ((765, 1360), (1080, 1920))
CODEC_THREADS = 8
# Pillow 12.1's Image.fromarray(codec_image(h, w)).save(buf, "JPEG",
# quality=q): SHA-256 of the file's bytes and of the pixels Pillow decodes
# from them (tools/make_jpeg_fixtures.py's Pillow; tests/test_torch_jpeg.py
# holds these to Pillow)
JPEG_GOLDEN = (
    ((1, 1), 75,
     "3e82b3dddff440afb3534b067b31b7e9d5ef3891377175a33b81ac423d0f373f",
     "412c45d603453521684df8f679c7f68f0f22dd7697d37170385c8c7931636298"),
    ((1, 1), 92,
     "b7bc3897cbb999a8fd656d524cb0a047df04183132fa048027b09f8fdaf0edbb",
     "412c45d603453521684df8f679c7f68f0f22dd7697d37170385c8c7931636298"),
    ((1, 1), 95,
     "9a856a7f3992c7c15520fef9722a1df709ff98dda6426e2fec034e42774050b2",
     "412c45d603453521684df8f679c7f68f0f22dd7697d37170385c8c7931636298"),
    ((17, 300), 75,
     "249aeba46c7704ec1303d23bacdfed41dd38496407dab72e8e8462750f41484c",
     "15108ddde3e4fcff5839af742b67e0a3e25b72e0582518504ee0a1cc282567f0"),
    ((17, 300), 92,
     "965ad0293a5775c38b18efec3427bd42666b98566c9ed68cc867e31255f399da",
     "166e1c3974dd47f5f2c38fe16368db14577d8ca7f21c3ae17e589657db172120"),
    ((17, 300), 95,
     "d697311edbd797d17321a77de9bc94d891ffe086d55337e0a09eabb0ed247efd",
     "84f8d73f7c21d40e73a2b740193b17a01f0d0b4ca8b7f2e0897f92f4049b4a98"),
    ((765, 1360), 75,
     "ee9cfa53d45108d898baf56d9884390eecec3f70c2215dfd72cfc1ce344e8dcc",
     "68b25cb5bd2d3f754e620e03b1ec89faec8a684b492091724f44a1b280b21952"),
    ((765, 1360), 92,
     "f1706e20b821fb27bc2e40a4a579b8a5d65df180b0cba75d780ce79e94f26c05",
     "db1ce0e92df4003e0e210f9eb64c43fcd696118dc65156214d86e544d0b1e60f"),
    ((765, 1360), 95,
     "5517104dac4bf658e67d1533c29914cd63e8c83cdf1d146018a8220de19f2e51",
     "844689dd8cb2cbbfbd36e9bb2bd854c13a76cf385b601779eb8172beb48b1c77"),
    ((1080, 1920), 75,
     "696664f145790c783eebb1fde3ae431e5c4e3c8f8921e1bcc3049046a7a56e20",
     "a6e2209ead128070690bd79e2eb8c2f8047368321676c26da0f253804cf129c4"),
    ((1080, 1920), 92,
     "64eb2537cb9cb0fe716cd193d0756dd66c2a303876a8e3bbe5b2ef44bff66b7c",
     "7a16f5f6e6969430261931b50abe14d0159efe51f70f6808add0928456ab8f53"),
    ((1080, 1920), 95,
     "fedb96fbf41bde5031e1fc4a9091075192639ba1c4ecca677496a97949cfb973",
     "7b115e03c3ead70a9674484bf42e4cb8ecccef642d2645efaf12127b5fe0568d"))


def codec_image(h: int, w: int):
    """A gradient with noise seeded by the size: the codec's test image
    (AC content in every block, as a photograph has)."""
    import numpy as np
    rng = np.random.RandomState(1900 + h + w)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(w + h - 2, 1)], -1)
    return np.clip(base + rng.randint(-24, 25, (h, w, 3)), 0,
                   255).astype(np.uint8)


def hold_codec():
    """(a) the fixtures against their manifest; (b) the encoder's bytes and
    the decoder's pixels against JPEG_GOLDEN."""
    import hashlib

    from robust_object_detection_tpu_torch.data import imageio as IO

    def sha(b):
        return hashlib.sha256(b).hexdigest()
    manifest = json.loads((JPEG_FIXTURES / "MANIFEST.json").read_text())
    require(len(manifest) >= 10, f"{len(manifest)} JPEG fixtures")
    for name, entry in manifest.items():
        px = IO.read_rgb(JPEG_FIXTURES / entry["file"])
        got = sha(px.tobytes())
        require(px.shape == (entry["height"], entry["width"], 3)
                and got == entry["pixels_sha256"],
                f"fixture {name}: decoded pixels {px.shape} {got} differ "
                f"from Pillow's {entry['pixels_sha256']}")
    print(f"[codec] (a) {len(manifest)} fixtures ("
          + ", ".join(manifest) + ") decode to Pillow's pixels (SHA-256)")
    require(len(JPEG_GOLDEN) == 12, "JPEG_GOLDEN")
    for (h, w), q, file_sha, pixels_sha in JPEG_GOLDEN:
        data = IO.jpeg_bytes(codec_image(h, w), q)
        require(sha(data) == file_sha, f"JPEG bytes of a {h}x{w} image at "
                                       f"q {q} differ from Pillow's")
        px = IO.native.jpeg_decode(data)
        require(sha(px.tobytes()) == pixels_sha,
                f"decoded {h}x{w} q {q} differs from Pillow's pixels")
    print(f"[codec] (b) encoder bytes equal Pillow's and decode to its "
          f"pixels: {len(JPEG_GOLDEN)} of {len(JPEG_GOLDEN)} (sizes "
          f"{sorted({g[0] for g in JPEG_GOLDEN})}, q 75 / 92 / 95)")


def codec_timings():
    """(c) host ms an image of the decode and the encode (q 95) at the
    CODEC_TIMED sizes: one thread (median of 5), and CODEC_THREADS threads
    over 2 x CODEC_THREADS images (wall / images, median of 3)."""
    from concurrent.futures import ThreadPoolExecutor

    from robust_object_detection_tpu_torch.data import imageio as IO
    out = {}
    with ThreadPoolExecutor(CODEC_THREADS) as pool:
        for h, w in CODEC_TIMED:
            img = codec_image(h, w)
            data = IO.jpeg_bytes(img, 95)
            row = {"bytes": len(data)}
            for what, fn, arg in (
                    ("decode", IO.native.jpeg_decode, data),
                    ("encode", lambda a: IO.jpeg_bytes(a, 95), img)):
                one = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn(arg)
                    one.append((time.perf_counter() - t0) * 1e3)
                many = []
                n = 2 * CODEC_THREADS
                for _ in range(3):
                    t0 = time.perf_counter()
                    list(pool.map(fn, [arg] * n))
                    many.append((time.perf_counter() - t0) * 1e3 / n)
                row[f"{what}_ms_1_thread"] = statistics.median(one)
                row[f"{what}_ms_{CODEC_THREADS}_threads"] = \
                    statistics.median(many)
            out[f"{h}x{w}"] = row
    return out


def host_cpu() -> str:
    """lscpu's model name, with the vendor, the CPU count and the SIMD
    levels beside it (a sandboxed host may report the name as unknown)."""
    info = {}
    for ln in run_cmd(["lscpu"]).splitlines():
        k, _, v = ln.partition(":")
        info[k.strip()] = v.strip()
    flags = info.get("Flags", "").split()
    simd = [f for f in ("avx2", "avx512f", "avx512bw") if f in flags]
    return (f"{info.get('Model name', 'unknown')} ({info.get('Vendor ID', '?')}"
            f", {info.get('CPU(s)', '?')} CPUs, {' '.join(simd) or 'no avx2'})")


def phase_codec(dev):
    """The host codec with PIL and cv2 made unimportable, then a JPEG DET
    split and a VID split through the CLI. Returns the launch counts."""
    from robust_object_detection_tpu_torch import cli
    from robust_object_detection_tpu_torch.data import imageio as IO
    from robust_object_detection_tpu_torch.data import synthetic
    from robust_object_detection_tpu_torch.train import detector as D
    from robust_object_detection_tpu_torch.train import frcnn as FR
    from robust_object_detection_tpu_torch.train import rtdetr as RT

    cpu = host_cpu()
    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).strip()
    blocked = {m: sys.modules.get(m) for m in ("PIL", "cv2")}
    for m in blocked:
        sys.modules[m] = None           # any import of them now raises
    counters = summary_counters()
    rec = CallRecorder(counters)
    for module, tag in ((D, "yolo"), (RT, "rtdetr"), (FR, "frcnn")):
        rec.wrap(module, "make_train_step", f"{tag}_step")
        rec.wrap(module, "make_predict_step", f"{tag}_fwd", digest=True)
    reads = []
    real_read = IO.read_rgb

    def read_rgb(path):
        reads.append(str(path))
        return real_read(path)
    seconds, launches = {}, dict.fromkeys(counters, 0)
    run = cli_runner("jpeg", counters, rec, reads, seconds, launches)
    n_val = CLI_SPLITS[1]
    try:
        hold_codec()
        timings = codec_timings()
        bmp_ms, resize_ms = hold_bmp_and_resize()
        print(f"[codec] (c) host ms an image ({card}; host CPU {cpu}): "
              f"{json.dumps(timings)}; BMP decode 765x1360 {bmp_ms}, "
              f"resize_linear_u8 765x1360 -> 576x1024 {resize_ms}")
        IO.read_rgb = read_rgb
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            raw = synthetic.make_det_split(tmp / "raw_val", n_images=n_val,
                                           seed=SEED + 40,
                                           size_range=CLI_SIZE_RANGE)
            vid = synthetic.make_vid_split(tmp / "raw_vid", n_seqs=VID_SEQS,
                                           frames_per_seq=VID_FRAMES,
                                           seed=SEED + 41, hw=VID_HW)
            seconds["make splits"] = time.perf_counter() - t0
            names = sorted(p.name for p in (raw / "images").iterdir())
            require(len(names) == n_val
                    and all(n.endswith(".jpg") for n in names),
                    f"the DET split is not {n_val} JPEG files: {names}")
            print(f"[jpeg] splits: {n_val} JPEG DET images, {VID_SEQS} x "
                  f"{VID_FRAMES} VID frames at {VID_HW}; "
                  f"{seconds['make splits']} s")
            proc = tmp / "processed"
            coco, yolo = proc / "visdrone_coco6", proc / "visdrone_yolo6"
            vid_yolo = tmp / "visdrone_vid_yolo6"
            for s in ("train", "val"):
                run(f"convert-det-coco {s}", "convert-det-coco", "--src",
                    str(raw), "--out", str(coco), "--split", s)
                run(f"convert-vid-yolo {s}", "convert-vid-yolo", "--src",
                    str(vid), "--out", str(vid_yolo), "--split", s)
            run("convert-det-yolo val", "convert-det-yolo", "--src",
                str(raw), "--out", str(yolo), "--split", "val")
            frames = sorted((vid_yolo / "images" / "val").iterdir())
            require(len(frames) == VID_SEQS * VID_FRAMES and all(
                IO.image_size(p) == VID_HW[::-1] for p in frames),
                f"VID frames {[(p.name, IO.image_size(p)) for p in frames]}")

            testsets, cpu_sets = tmp / "testsets", tmp / "testsets_cpu"
            run("build-testsets", "build-testsets", "--processed-root",
                str(proc), "--out", str(testsets))
            t0 = time.perf_counter()
            cli.main(["build-testsets", "--processed-root", str(proc),
                      "--out", str(cpu_sets), "--device", "cpu"])
            seconds["build-testsets (CPU)"] = time.perf_counter() - t0
            same_testsets(testsets, cpu_sets)
            shutil.rmtree(cpu_sets)
            require(all(p.suffix == ".jpg" for p in
                        (testsets / "coco6").rglob("images/val/*")),
                    "the testsets are not JPEG")

            unet = HELD.get("unet")
            if unet is None:
                unet = tmp / "unet"
                run("train-restoration", "train-restoration", "--train-dir",
                    str(coco / "images" / "val"), "--val-dir",
                    str(coco / "images" / "val"), "--out", str(unet),
                    "--max-steps", "1")
            counts, _ = run("restore-testsets", "restore-testsets",
                            "--testset-root", str(testsets), "--unet-dir",
                            str(unet))
            want = {f"{f}/{v}": n_val for f in ("coco6", "yolo6") for v in (
                "Test_Clean", "Test_Noise", "Test_Blur", "Test_LowRes")}
            require(counts == want, f"restore-testsets counts {counts}")

            ck = tmp / "ckpt"
            common = ["--epochs", "1", "--max-steps", "1", "--img-size",
                      str(IMG_SIZE), "--batch-size", str(BATCH)]
            det = HELD.get("yolo")
            if det is None:
                det = ck / "yolo_det"
                run("train-detector yolo (DET)", "train-detector", "--model",
                    "yolo", "--data-root", str(coco), "--out", str(det),
                    *common, steps={"yolo_step": 1},
                    forwards={"yolo_fwd": -(-n_val // BATCH)})
            n_frames = VID_SEQS * VID_FRAMES
            out, _ = run("train-detector yolo (VID)", "train-detector",
                         "--model", "yolo", "--data-layout", "yolo",
                         "--data-root", str(vid_yolo), "--out",
                         str(ck / "yolo_vid"), *common,
                         steps={"yolo_step": 1},
                         forwards={"yolo_fwd": -(-n_frames // BATCH)})
            require(reads and all(p.endswith(".jpg") and "/images/" in p
                                  and "visdrone_vid_yolo6" in p
                                  for p in reads),
                    "the VID training read outside the VID JPEG frames")
            require(out["steps"] == 1 and math.isfinite(out["final_loss"]),
                    f"VID training: {out}")
            exp = tmp / "experiments"
            sweep = ["--testset-root", str(testsets), "--img-size",
                     str(IMG_SIZE), "--batch-size", str(BATCH), "--out",
                     str(exp)]
            per_model = 4 * -(-n_val // BATCH)
            run("eval", "eval", "--model", f"yolo_baseline=yolo:{det}",
                *sweep, forwards={"yolo_fwd": per_model})
            require(reads and all("/coco6/" in p and p.endswith(".jpg")
                                  for p in reads),
                    "eval read outside the coco6 JPEG testsets")
            run("eval-vid", "eval-vid", "--model",
                f"yolo_vid=yolo:{ck / 'yolo_vid'}", *sweep,
                forwards={"yolo_fwd": per_model})
            n_results = {}
            for name in ("eval_results", "vid_eval_results"):
                res, n_results[name] = finite_results(exp / f"{name}.json")
                print(f"[jpeg] {name}: " + "; ".join(
                    f"{m} " + ", ".join(
                        f"{v[5:]} mAP50 {s['mAP50']} "
                        f"{1000 / s['images_per_sec']:.1f} ms an image"
                        for v, s in per.items())
                    for m, per in res.items()))
            print(f"[jpeg] finite mAPs: {n_results} (model, variant) cells")
    finally:
        IO.read_rgb = real_read
        rec.restore()
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    print(f"[jpeg] seconds by command: {json.dumps(seconds)}")
    return launches


# ── Faster R-CNN in bf16 (phase 28) ──────────────────────────────────────

# phase 28's bars on the card's bf16 step against its f32 step (same batch,
# same draws, the f32 step's proposals replayed): the losses' and
# grad_norm's relative error, the named gradients' relative L2 error, the
# running statistics' max error over max|ref|. From the CPU tests'
# measured spread of the reference's own bf16 step against its f32 step
# (tests/test_torch_frcnn_bf16.py, blocks (1, 1, 1, 1) at 96 px): losses
# up to 7.4e-3, grad_norm 2.5e-3, gradient leaves 0.20-0.46 relative L2;
# the bars take 4x the losses' and about 1.3x the gradients' spread
FRCNN_BF16_BARS = (3e-2, 3e-2, 0.6, 5e-2)
FRCNN_BF16_SPLIT = (4, 2, (240, 300))   # train, val images; side range


def frcnn_dtype_audit(model, images):
    """One train-mode forward of a bf16 Faster R-CNN with its convs, fc6,
    BatchNorms and the module calls recorded: every conv and fc6 computes
    in bf16, every BatchNorm outputs f32, and the RPN's 1x1s and the box
    predictor (no dtype in the reference: flax promotes them) take f32
    inputs and weights and give f32."""
    import torch
    from robust_object_detection_tpu_torch.models import fpn as FPN_
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.models import resnet as RN

    seen = {"conv": set(), "linear": set(), "bn": set(), "f32 modules": {}}
    real = {"conv": RN.conv, "linear": RN.linear, "batch_norm": RN.batch_norm}

    def conv(x, c, d):
        y = real["conv"](x, c, d)
        seen["conv"].add((str(d), str(y.dtype)))
        return y

    def linear(x, lin, d):
        y = real["linear"](x, lin, d)
        seen["linear"].add((str(d), str(y.dtype)))
        return y

    def batch_norm(y, bn, train=False):
        out = real["batch_norm"](y, bn, train)
        seen["bn"].add(str(out.dtype))
        return out
    mods = {"rpn cls_logits": model.rpn["head"].cls_logits,
            "rpn bbox_pred": model.rpn["head"].bbox_pred,
            "cls_score": model.roi_heads.box_predictor.cls_score,
            "bbox_pred": model.roi_heads.box_predictor.bbox_pred}
    hooks = [m.register_forward_hook(
        lambda m, inp, out, name=name: seen["f32 modules"].setdefault(
            name, set()).add((str(inp[0].dtype), str(m.weight.dtype),
                              str(out.dtype))))
        for name, m in mods.items()]
    patched = [(mod, n) for mod in (RN, FPN_, FR)
               for n in ("conv", "linear", "batch_norm") if hasattr(mod, n)]
    saved = [(mod, n, getattr(mod, n)) for mod, n in patched]
    for mod, n in patched:
        setattr(mod, n, {"conv": conv, "linear": linear,
                         "batch_norm": batch_norm}[n])
    try:
        with torch.no_grad():
            pyramid, obj, d = model.extract(images, train=True)
            props = torch.tensor([[0.0, 0.0, 64.0, 64.0]], device=obj.device
                                 ).expand(images.shape[0], 16, 4)
            scores, deltas = model.roi_forward(pyramid, props, train=True)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
        for h in hooks:
            h.remove()
    bf, f32 = "torch.bfloat16", "torch.float32"
    print(f"[frcnn-bf16] dtype audit: {seen}; pyramid "
          f"{[str(p.dtype) for p in pyramid]}, objectness {obj.dtype}, "
          f"scores {scores.dtype}")
    require(seen["conv"] == {(bf, bf)}, f"a conv not in bf16: {seen}")
    require(seen["linear"] == {(bf, bf)}, f"fc6 not in bf16: {seen}")
    require(seen["bn"] == {f32}, f"a BatchNorm output not f32: {seen}")
    require(seen["f32 modules"] == {n: {(f32, f32, f32)} for n in mods},
            f"an RPN 1x1 or the predictor not in f32: {seen}")
    require(all(p.dtype == torch.float32 for p in pyramid)
            and obj.dtype == d.dtype == scores.dtype == deltas.dtype
            == torch.float32, "phase 28: an output not f32")


def phase_frcnn_bf16(dev):
    """bench_frcnn's bf16 configuration (bench.py:233-257: batch 2, 1024
    px, augment, FrcnnConfig(), 1 + 5 steps): K1 at batch 2 against its
    plain version, a dtype audit of one forward, frcnn_step_timing of the
    bf16 model from phase 24's weights; the bf16 step against the card's
    f32 step on one batch with the f32 step's proposals replayed (bars
    FRCNN_BF16_BARS); one train(dtype="bfloat16") with a validation on a
    BMP split and its checkpoint loaded back as f32. Returns the timed
    steps' launch counts."""
    import json as json_
    import tempfile

    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        ExperimentConfig
    from robust_object_detection_tpu_torch.data import convert as CV
    from robust_object_detection_tpu_torch.data import synthetic
    from robust_object_detection_tpu_torch.models import frcnn as FR
    from robust_object_detection_tpu_torch.train import frcnn as TFR

    check_k1_frcnn_batch(dev, "frcnn-bf16")
    cpu = frcnn_pair(dev)[0]
    model = FR.create(FR.FrcnnConfig(), device=dev, dtype=torch.bfloat16)
    model.load_state_dict(cpu.state_dict())
    g = torch.Generator(dev).manual_seed(SEED + 15)
    frcnn_dtype_audit(model, torch.rand(FRCNN_TRAIN_BATCH, 256, 256, 3,
                                        device=dev, generator=g))
    launches = frcnn_step_timing(dev, model, "frcnn-bf16")
    require(all(p.dtype == torch.float32 for p in model.parameters())
            and all(b.dtype == torch.float32 for n, b in
                    model.named_buffers() if "running_" in n),
            "phase 28: weights or statistics left f32")

    # the bf16 step against the f32 step: same batch, draws, proposals
    n_gt, slots = FRCNN_CHECK_GT
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 11),
                                     FRCNN_TRAIN_BATCH, FRCNN_CHECK_SIZE,
                                     n_gt, slots)
    batch = (torch.from_numpy(images), torch.from_numpy(gb),
             torch.from_numpy(gc))
    draws = TFR.draw_train(FRCNN_TRAIN_BATCH,
                           len(FR.anchor_boxes(FRCNN_CHECK_SIZE)),
                           cpu.cfg.num_proposals + slots,
                           torch.Generator().manual_seed(SEED + 12))
    props = []
    f32 = frcnn_train_step(cpu, dev, torch.float32, batch, draws, props)
    bf16 = frcnn_train_step(cpu, dev, torch.float32, batch, draws, props,
                            compute=torch.bfloat16)
    log = []
    frcnn_compare("frcnn-bf16 bf16 vs f32 step", bf16, f32, FRCNN_BF16_BARS,
                  log)
    print(f"[frcnn-bf16] batch {FRCNN_TRAIN_BATCH} at {FRCNN_CHECK_SIZE} px, "
          f"the f32 step's proposals replayed: the bf16 step vs the card's "
          f"f32 step: {'; '.join(log)}")

    # train(dtype="bfloat16") with a validation; the checkpoint loads as f32
    n_train, n_val, side = FRCNN_BF16_SPLIT
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i, (split, n) in enumerate((("train", n_train), ("val", n_val))):
            raw = synthetic.make_det_split(tmp / f"raw_{split}", n_images=n,
                                           seed=SEED + 50 + i,
                                           size_range=(side, side),
                                           ext="bmp")
            CV.convert_det_to_coco(raw, tmp / "coco", split)
        t0 = time.perf_counter()
        out = TFR.train(ExperimentConfig(), tmp / "coco", tmp / "run",
                        augment=True, epochs=1, img_size=256,
                        batch_size=FRCNN_TRAIN_BATCH, max_boxes=64,
                        val_interval=1, dtype="bfloat16")
        secs = time.perf_counter() - t0
        stamp = json_.loads((tmp / "run" / "config.json").read_text())
        hist = [json_.loads(x) for x in
                (tmp / "run" / "history.jsonl").read_text().splitlines()]
        loaded = TFR.load_checkpoint(tmp / "run")
        with torch.no_grad():
            det = TFR.make_predict_step(loaded, 256)(
                loaded, torch.randint(0, 256, (1, 256, 256, 3), device=dev,
                                      dtype=torch.uint8))
    print(f"[frcnn-bf16] train(dtype='bfloat16') on {n_train} + {n_val} BMP "
          f"images at 256 px: {out} in {secs} s; config.json dtype "
          f"{stamp['dtype']}; history {hist}; checkpoint loaded as "
          f"{loaded.dtype}")
    require(out["steps"] == n_train // FRCNN_TRAIN_BATCH
            and math.isfinite(out["final_loss"]), f"train(): {out}")
    require(stamp["dtype"] == "bfloat16" and "mAP50" in hist[-1],
            "train(): stamp or validation missing")
    require(loaded.dtype == torch.float32 and all(
        p.dtype == torch.float32 for p in loaded.parameters()),
        "load_checkpoint did not build an f32 model")
    require(all(torch.isfinite(t.float()).all() for t in det),
            "the loaded model's detections are not finite")
    return launches


# ── Parallel on the card (phase 29) ──────────────────────────────────────

PAR_SHAPES = {"yolo": (4, 512), "rtdetr": (2, 512)}   # global batch, px
PAR_STEPS = 2                  # lr 0, then lr0 (warmup_steps=1)
# two-process runs: (model, model axis, dtype, mode); bf16 is the trainers'
# default on the card, f32 (smaller noise) is where a dropped all-reduce
# stands out most. Mode "replay": every rank takes the one process's TAL
# assignment of its rows (parallel_steps' `tal`), so what is left of the
# spread is the rest of the step's; "k2plain": K2's plain version in
# place of its tensor-core route and statistics callback on every side
# (parallel_steps' `plain_front`), held against a one-process run of the
# same; "perturb": RT-DETR-L's model index 1 adds 1e-3 to a replicated
# leaf's gradient and swaps two queries of every matching it makes
# (parallel_steps' `perturb`), which the model-group broadcasts must undo
PAR_RUNS = (("yolo", 1, "float32", ""), ("yolo", 1, "bfloat16", ""),
            ("yolo", 1, "bfloat16", "replay"),
            ("yolo", 1, "bfloat16", "k2plain"),
            ("rtdetr", 2, "float32", ""), ("rtdetr", 2, "bfloat16", ""),
            ("rtdetr", 2, "bfloat16", "perturb"))
# phase 29's bars for two ranks (gloo, one card) against one process: the
# worst metric's relative error, and the distance of the state from the
# one-process state over the one-process change, relative L2 over all
# weights, over all running statistics and over the kernels' front's
# (parallel_compare). Measured in f32 (TF32 off; H100 80GB HBM3, 700 W):
# YOLOv8m 8.0e-6 / 1.3e-4 / 1.7e-6, RT-DETR-L with the decoder split
# 4.0e-5 / 6.8e-3 / 0; a rank without the gradient all-reduce gave 1.9e-2
# / 0.18, one without the statistics' all-reduce a metric 0.61 off. In
# bf16 another batch split moves the metrics by up to 9.3e-2 and the
# statistics by 8.5e-3, and YOLOv8m's weights (nesterov SGD: the update
# is linear in the gradients) by 0.700 of their change: bf16's own
# spread, neither near-tied TAL assignments nor K2's route. The one
# process's TAL replayed into both ranks gives 0.705, K2's plain version
# on every side 0.691, the one process with its batch rows reversed (no
# parallel code) 0.318, bf16 against f32 in one process 0.907; and on the
# CPU the reference's own 2-device bf16 spread is as large
# (tests/test_torch_dp_bf16.py). YOLOv8m's bf16 weights are held below
# bf16's distance from f32; RT-DETR-L's printed only (AdamW: its first
# update is about lr x sign(g), an element near 0 takes either sign; 0.798)
PAR_BARS = {"float32": {"metric": 1e-2, "weights": 5e-2, "stats": 1e-2,
                        "front": 1e-4, "capped": 0},
            "bfloat16": {"metric": 0.2, "weights": 0.85, "stats": 0.1,
                         "front": 1e-2, "capped": None}}
# the running statistics the hand kernels take through the data-parallel
# callback (parallel/mesh.kernel_sync): YOLOv8m's front (K2: BN1, BN2),
# RT-DETR-L's stem (K4). BN1 reads the first conv of each image alone, so
# another batch split only sums its statistics in another order: held
# apart from the rest ("front" in the bars)
PAR_FRONT = {"yolo": ("model.0.bn.", "model.1.bn."), "rtdetr": ("model.0.",)}
# metrics that count events, held by their absolute difference a step
# ("capped" in the bars) and not by relative error: matcher_capped, the
# image-matchings RT-DETR-L's auction left to the greedy completion at its
# 16-round cap (train/rtdetr.AUCTION_MAX_ROUNDS). At random init the costs
# are near-tied and an auction may end on either side of the cap: a bf16
# rank with the decoder split counted 1 of the 14 image-matchings a step
# where the one process counted 0 in 3 of 15 runs of this phase, then in
# 5 of 8 rank-steps of one call, its losses within 0.093 of the one
# process's (H100 80GB HBM3, 700 W). So bf16's counts are printed only,
# as its weights are; f32 counted alike in every run and is held to 0
PAR_COUNTS = ("matcher_capped",)
# the world-1 group's floor under twice the run-to-run spread: YOLOv8m's
# step is deterministic with cuDNN's deterministic algorithms (both runs
# bit-identical), RT-DETR-L's is not (PyTorch's atomic scatters in the
# gathers' backward): two runs without a group part by up to 3.5e-4 in a
# metric and 2.9e-2 in the weights' change (H100 80GB HBM3, 700 W)
PAR_WORLD1_FLOOR = {"yolo": {"metric": 1e-6, "weights": 1e-6,
                             "stats": 1e-6, "front": 1e-6, "capped": 0},
                    "rtdetr": {"metric": 2e-3, "weights": 0.15,
                               "stats": 1e-6, "front": 1e-6, "capped": 1}}
# what the model ranks of RT-DETR-L's decoder split must hold bit-equal
# after every step (the reference holds each as one replicated array), in
# the order a step makes them: the BatchNorm running statistics (every
# buffer), the 7 matchings, the replicated leaves' gradients as the clip
# reads them, their AdamW moments, the leaves, their EMA; and the metrics
PAR_TP_PARTS = ("buffers", "match", "grad", "moments", "params", "ema",
                "metrics")
PAR_TIMED = 2          # RT-DETR-L steps a rank times with each variant

PAR_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
root, rank, port, work, kind, model_axis, dtype, mode = sys.argv[1:9]
sys.path.insert(0, root)
import chip_smoke as C
from robust_object_detection_tpu_torch import kernels
from robust_object_detection_tpu_torch.core.config import MeshConfig
from robust_object_detection_tpu_torch.parallel import mesh as M
rank, model_axis = int(rank), int(model_axis)
out_file = f"{work}/{kind}-{dtype}{mode}.rank{rank}.pt"
kernels.load()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
try:
    probe = torch.ones(4, device=dev)
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    ok = bool((probe == 2).all())
except Exception as e:      # this build's gloo refuses CUDA tensors
    torch.save({"refused": repr(e)}, out_file)
    sys.exit(0)
assert ok, probe
d = torch.load(f"{work}/{kind}.in.pt", weights_only=False)
mesh = M.make_mesh(MeshConfig(data=2 // model_axis, model=model_axis))
tal = d["tal"] if mode == "replay" else ("record" if kind == "yolo" else None)
out = C.parallel_steps(kind, dev, d["init"], d["batch"], mesh, dtype,
                       tal=tal, plain_front=mode == "k2plain",
                       perturb=mode == "perturb")
torch.save(out, out_file)
dist.destroy_process_group()
"""


def par_bars(kind, dtype):
    """PAR_BARS[dtype] for a two-process run; RT-DETR-L's bf16 weights are
    printed only (PAR_BARS' comment)."""
    bars = dict(PAR_BARS[dtype])
    if dtype == "bfloat16" and kind == "rtdetr":
        bars["weights"] = None
    return bars


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (bit equality across processes)."""
    import hashlib

    import torch
    t = t.detach().contiguous().reshape(-1).cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def parallel_model(kind, dev, init=None, dtype="bfloat16"):
    """The full-width train-mode YOLOv8m or RT-DETR-L computing in `dtype`
    (seeded init, or `init`'s state), its make_optimizer(warmup_steps=1)
    and its trainer module."""
    import torch
    bf = getattr(torch, dtype)
    if kind == "yolo":
        from robust_object_detection_tpu_torch.models import yolov8 as Y
        from robust_object_detection_tpu_torch.train import detector as D
        model = Y.create(6, "m", bf, dev,
                         torch.Generator().manual_seed(SEED + 60),
                         train=True, bn_dtype=bf)
        opt = D.make_optimizer(warmup_steps=1, total_steps=10)[0]
        lib = D
    else:
        from robust_object_detection_tpu_torch.models import rtdetr as R
        from robust_object_detection_tpu_torch.train import rtdetr as RT
        model = R.create(6, bf, dev, torch.Generator().manual_seed(SEED + 61),
                         train=True, bn_dtype=bf)
        opt = RT.make_optimizer(warmup_steps=1, total_steps=10)[0]
        lib = RT
    if init is not None:
        model.load_state_dict(init)
    return model, opt, lib


def parallel_steps(kind, dev, init, batch, mesh, dtype="bfloat16",
                   steps=PAR_STEPS, tal=None, order=None,
                   plain_front=False, perturb=False):
    """PAR_STEPS data-parallel (mesh.model > 1 for RT-DETR: tensor-parallel
    decoder) steps in `dtype` (float32 with TF32 off) from `init` on this
    rank's rows of `batch` (images, boxes, classes on the CPU), augment and
    HSV / flip on, draws from a generator on the card. tal (YOLO):
    "record" keeps every TAL call's output; a list of such records, one
    per step of the global batch's images (a one-process run's), is
    replayed in place of TAL, this rank's rows. order (no mesh): the
    batch's rows in this order, each image with its own draws (the step's
    `draw_rows` then names them), so only the sums over the batch run in
    another order. plain_front (YOLO): K2's plain version
    (ops.yolo_front.front_fused_reference) in place of K2. perturb (the
    decoder split): model index 1 adds 1e-3 to a replicated decoder
    leaf's gradient as backward leaves it and swaps two queries of image
    0 in every matching the matcher returns. Returns
    (metrics by step,
    the state_dict on the CPU in the one-process layout, extra): extra
    "tal", the recorded TAL outputs by step; under the decoder split
    "digests", by step, SHA-256s of what the model ranks must hold
    bit-equal (PAR_TP_PARTS) and of the replicated gradients and the
    matchings before the model-group broadcasts ("grad_reduced",
    "matcher"), and "ms", PAR_TIMED steps' ms with the
    model-group broadcasts, without them, and of the broadcasts alone."""
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.parallel import mesh as M
    from robust_object_detection_tpu_torch.train import detection as DL
    model, opt, lib = parallel_model(kind, dev, init, dtype)
    plan = None
    if mesh is not None and mesh.n_model > 1:
        plan = M.rtdetr_decoder_tp(mesh, model)
        M.apply_tp(mesh, model, plan)
    state = lib.init_state(model, opt)
    if plan is not None:
        state.tp_plan = plan
    size = PAR_SHAPES[kind][1]
    step = lib.make_train_step(size, CorruptionConfig(), augment=True,
                               base_augment=True, mesh=mesh)
    rows = M.shard_batch(mesh, batch)
    images, gb, gc = (t.to(dev) for t in rows)
    first = M.local_rows(mesh, batch[0].shape[0]).start
    n_local = images.shape[0]
    index = list(range(first, first + n_local))
    real = {}
    if plain_front:
        from robust_object_detection_tpu_torch.models import yolov8 as Y
        from robust_object_detection_tpu_torch.ops import yolo_front as TF
        real[(Y, "front_fused")] = Y.front_fused
        Y.front_fused = TF.front_fused_reference
    if order is not None:
        index = list(order)
        perm = torch.tensor(index, device=dev)
        images, gb, gc = images[perm], gb[perm], gc[perm]
        real[(M, "draw_rows")] = M.draw_rows
        M.draw_rows = lambda n, ctx: (n, perm)
    extra = {}
    metrics = []
    # the probes: module functions the step calls by name, wrapped while
    # the recorded steps run
    calls = []
    probe = {}
    rep = []
    swap = False
    if tal is not None:
        real[(DL, "task_aligned_assign")] = DL.task_aligned_assign

        def tal_hook(*a, **k):
            s, j = divmod(len(calls), n_local)
            if isinstance(tal, list):
                out = {n: v.to(dev) for n, v in tal[s][index[j]].items()}
            else:
                out = real[(DL, "task_aligned_assign")](*a, **k)
            calls.append({n: v.detach().cpu() for n, v in out.items()})
            return out
        DL.task_aligned_assign = tal_hook
    if plan is not None:
        rep = [(n, p) for n, p in model.named_parameters()
               if plan.get(n) is None and p.requires_grad]
        real[(lib, "hungarian_match")] = lib.hungarian_match
        real[(lib, "global_grad_norm")] = lib.global_grad_norm
        real[(lib, "auction_assignment")] = lib.auction_assignment
        real[(M, "all_reduce_grads")] = M.all_reduce_grads
        swap = perturb and mesh.model_index == 1
        if swap:
            leaf = next(p for n, p in rep if ".decoder." in n)

            def bump(p):
                p.grad.add_(1e-3)
            hook = leaf.register_post_accumulate_grad_hook(bump)

        def matcher_hook(*a, **k):
            gfq, capped = real[(lib, "auction_assignment")](*a, **k)
            if swap:
                row = gfq[0]
                j = int((row != row[0]).nonzero()[0])
                row[0], row[j] = row[j].clone(), row[0].clone()
            probe["matcher"].append(digest(gfq) + digest(capped))
            return gfq, capped

        def reduce_hook(*a, **k):
            real[(M, "all_reduce_grads")](*a, **k)
            probe["grad_reduced"] = {n: digest(p.grad) for n, p in rep
                                     if p.grad is not None}

        def match_hook(*a, **k):
            out = real[(lib, "hungarian_match")](*a, **k)
            probe["match"].append(digest(out[0])
                                  + digest(out[2]["capped"]))
            return out

        def norm_hook(*a, **k):
            probe["grad"] = {n: digest(p.grad) for n, p in rep
                             if p.grad is not None}
            return real[(lib, "global_grad_norm")](*a, **k)
        lib.hungarian_match, lib.global_grad_norm = match_hook, norm_hook
        lib.auction_assignment, M.all_reduce_grads = matcher_hook, reduce_hook
        extra["digests"] = []

    # f32 in f32: TF32 off in cuDNN and the matmuls while the steps run;
    # cuDNN's deterministic algorithms in every process, so that the ranks
    # (fresh worker processes) run the convolutions the one-process
    # reference runs
    tf32 = torch.backends.cuda.matmul.allow_tf32
    f32 = dtype == "float32"
    torch.backends.cuda.matmul.allow_tf32 = tf32 and not f32

    def run(i):
        m = step(state, images, gb, gc,
                 torch.Generator(dev).manual_seed(SEED + 70 + i))
        return {k: float(v) for k, v in m.items()}
    try:
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32 and not f32):
            try:
                for i in range(steps):
                    probe.update(match=[], matcher=[])
                    metrics.append(run(i))
                    if plan is None:
                        continue
                    ostate = state.optimizer.state
                    extra["digests"].append(dict(
                        probe, metrics=metrics[-1],
                        params={n: digest(p) for n, p in rep},
                        ema={n: digest(state.ema[n]) for n, _ in rep},
                        moments={f"{n}.{k}": digest(ostate[p][k])
                                 for n, p in rep if p in ostate
                                 for k in ("exp_avg", "exp_avg_sq")},
                        buffers={n: digest(b)
                                 for n, b in model.named_buffers()}))
            finally:
                for (mod, name), fn in real.items():
                    setattr(mod, name, fn)
                if swap:
                    hook.remove()
            # a copy: the timed steps below go on changing the model
            sd = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
            if plan is not None and hasattr(M, "broadcast_over_model"):
                extra["ms"] = time_broadcasts(M, run, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if tal is not None:
        extra["tal"] = [calls[s * n_local:(s + 1) * n_local]
                        for s in range(steps)]
        extra["index"] = index
    if plan is not None:
        sd = {k: M.gather_shards(v, plan.get(k), mesh) for k, v in sd.items()}
    return metrics, sd, extra


def time_broadcasts(M, run, start):
    """ms of PAR_TIMED steps each with the model-group broadcasts
    (M.broadcast_over_model), without them (a no-op in their place), and
    with each broadcast call timed between two synchronizes, in turns;
    ms of the broadcasts alone a step."""
    import torch
    real = M.broadcast_over_model
    spent = []

    def timed(tensors, ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(tensors, ctx)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
    out = {"with": [], "without": [], "broadcasts": []}
    try:
        for i in range(3 * PAR_TIMED):
            variant = ("with", "without", "timed")[i % 3]
            M.broadcast_over_model = {"with": real, "timed": timed}.get(
                variant, lambda tensors, ctx: None)
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(start + i)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            if variant == "timed":
                out["broadcasts"].append(1e3 * sum(spent))
            else:
                out[variant].append(ms)
    finally:
        M.broadcast_over_model = real
    return out


def parallel_compare(tag, got, ref, init, bars, fails=None, front=()):
    """got's metrics and state against ref's: the worst metric's relative
    error (PAR_COUNTS apart: their largest absolute difference in a step),
    and the distance of got's state from ref's over the change ref made
    from `init` (relative L2 over all the weights together, and over all
    the running statistics: a leaf that barely moved would be noise
    alone; and over the running statistics whose names start with one of
    `front`); the three weights farthest from ref's over their own change
    printed beside. bars None: only measured; a number over its bar
    fails at once, or is added to `fails` when given. Returns the
    numbers."""
    gm, gs = got[:2]
    rm, rs = ref[:2]
    metric = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
                 for g, r in zip(gm, rm) for k in r
                 if k in g and k not in PAR_COUNTS)
    capped = max((abs(g[k] - r[k]) for g, r in zip(gm, rm)
                  for k in PAR_COUNTS if k in r and k in g), default=0.0)
    counts = {k: ([g[k] for g in gm], [r[k] for r in rm])
              for k in PAR_COUNTS if k in rm[0]}
    sq = {"weights": [0.0, 0.0], "stats": [0.0, 0.0], "front": [0.0, 0.0]}
    leaves = []
    for k, r in rs.items():
        if not r.is_floating_point():
            continue
        stat = "running_" in k
        parts = [sq["stats" if stat else "weights"]]
        if stat and k.startswith(tuple(front)):
            parts.append(sq["front"])
        e = (gs[k].double() - r.double()).norm().item()
        d = (r.double() - init[k].double().cpu()).norm().item()
        for part in parts:
            part[0] += e ** 2
            part[1] += d ** 2
        if "running_" not in k and d > 0:
            leaves.append((e / d, k))
    out = {"metric": metric}
    out.update({k: math.sqrt(e / max(d, 1e-300)) for k, (e, d) in sq.items()})
    out["capped"] = capped
    print(f"[parallel] {tag}: worst metric rel err {out['metric']}, weights' "
          f"change rel L2 {out['weights']}, running statistics' change rel "
          f"L2 {out['stats']} (of the kernels' front {out['front']}), "
          f"counts a step (got, ref) {counts}, farthest "
          f"weights {sorted(leaves)[-3:]}" + (f" (bars {bars})" if bars
                                               else ""))
    if bars:
        for k, v in out.items():
            if bars[k] is not None and v > bars[k]:
                msg = f"{tag}: {k} {v} > {bars[k]}"
                require(fails is not None, msg)
                fails.append(msg)
    return out


def tp_parting(d0, d1):
    """Where two model ranks' digests (parallel_steps' extra["digests"])
    part: ({step: {part: leaves that differ}}, the first (step, part,
    leaf) in the order a step makes them, or None)."""
    parts, first = {}, None
    for s, (a, b) in enumerate(zip(d0, d1)):
        for part in PAR_TP_PARTS:
            x, y = a[part], b[part]
            if isinstance(x, dict):
                bad = [k for k in x if x[k] != y.get(k)]
                bad += [k for k in y if k not in x]
            else:
                bad = [f"#{i}" for i in range(max(len(x), len(y)))
                       if x[i:i + 1] != y[i:i + 1]]
            if bad:
                parts.setdefault(s, {})[part] = bad
                first = first or (s, part, bad[0])
    return parts, first


def tal_flips(got, ref):
    """Anchors whose TAL assignment differs between a run's record and
    the one process's for the same images (got, ref: parallel_steps'
    extra): by step, (foreground differs, both foreground but another
    GT, anchors compared)."""
    out = []
    for gs, rs in zip(got["tal"], ref["tal"]):
        fg = other = n = 0
        for j, g in enumerate(gs):
            r = rs[got["index"][j]]
            fg += int((g["fg_mask"] != r["fg_mask"]).sum())
            both = g["fg_mask"] & r["fg_mask"]
            other += int((both & (g["target_gt"] != r["target_gt"])).sum())
            n += g["fg_mask"].numel()
        out.append((fg, other, n))
    return out


def yolo_controls(dev, init, batch, ref, ref32):
    """The one-process bf16 YOLOv8m step against itself, no parallel code
    run: with the batch's rows reversed (each image with its own draws:
    the sums over the batch in another order), also with `ref`'s TAL
    assignment replayed; and `ref` against the f32 step `ref32`.
    Printed only: the size of bf16's own spread beside the two-process
    runs'."""
    order = list(range(PAR_SHAPES["yolo"][0]))[::-1]
    rev = parallel_steps("yolo", dev, init, batch, None, tal="record",
                         order=order)
    parallel_compare("yolo bfloat16 one process, rows reversed, vs one "
                     "process", rev, ref, init, None, front=PAR_FRONT["yolo"])
    print(f"[parallel] yolo bfloat16 one process, rows reversed: TAL "
          f"anchors that differ a step (foreground, another GT, of) "
          f"{tal_flips(rev[2], ref[2])}")
    rev = parallel_steps("yolo", dev, init, batch, None, tal=ref[2]["tal"],
                         order=order)
    parallel_compare("yolo bfloat16 one process, rows reversed, TAL "
                     "replayed, vs one process", rev, ref, init, None,
                     front=PAR_FRONT["yolo"])
    parallel_compare("yolo bfloat16 one process vs float32 one process "
                     "(bf16's own spread)", ref, ref32, init, None,
                     front=PAR_FRONT["yolo"])


def phase_parallel(dev):
    """parallel/mesh.py on the card. (a) A world-1 NCCL group through the
    data-parallel code path (every collective, the K2 / K4 statistics'
    callbacks included) of a YOLOv8m and an RT-DETR-L step at full width
    in bf16 (PAR_SHAPES, PAR_STEPS): against the step without a group,
    within twice the spread of two runs without a group, at least
    PAR_WORLD1_FLOOR. Launch counters zeroed just before the group's steps
    and read just after. (b) Two processes on the one card over gloo
    (NCCL refuses two ranks on one card): a data-parallel YOLOv8m step,
    in bf16 also with the one process's TAL assignment replayed (TAL
    flips counted), and an RT-DETR-L step with mesh.model=2 (the decoder
    split over both), in f32 and bf16 (PAR_RUNS), against the one-process
    step on the same global batch (par_bars); the two RT-DETR-L model
    ranks' replicated state, matchings and metrics bit-equal after every
    step (PAR_TP_PARTS; the first parting printed, all runs printed before
    a failure), and the step's ms with and without the model-group
    broadcasts. A gloo that refuses CUDA tensors is printed and (b)
    skipped. Returns the launch counts of (a)."""
    import os
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from robust_object_detection_tpu_torch.core.config import MeshConfig
    from robust_object_detection_tpu_torch.parallel import mesh as M

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    def batch_of(kind):
        b, size = PAR_SHAPES[kind]
        images, gb, gc = detection_batch(np.random.RandomState(SEED + 62),
                                         b, size, 40, 64)
        return (torch.from_numpy(images), torch.from_numpy(gb),
                torch.from_numpy(gc))

    inits = {k: {n: v.detach().cpu().clone() for n, v in
                 parallel_model(k, dev)[0].state_dict().items()}
             for k in PAR_SHAPES}
    batches = {k: batch_of(k) for k in PAR_SHAPES}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counters = summary_counters()
    launches = dict.fromkeys(counters, 0)
    refs = {}
    try:
        for kind in PAR_SHAPES:
            a = parallel_steps(kind, dev, inits[kind], batches[kind], None,
                               tal="record" if kind == "yolo" else None)
            b = parallel_steps(kind, dev, inits[kind], batches[kind], None)
            refs[(kind, "bfloat16")] = a
            spread = parallel_compare(f"{kind} no group, run to run", b, a,
                                      inits[kind], None,
                                      front=PAR_FRONT[kind])
            dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                    f"{free_port()}", world_size=1, rank=0)
            try:
                mesh = M.make_mesh(MeshConfig())
                require(mesh.grouped and mesh.n_data == 1, "world-1 mesh")
                for f in counters.values():
                    f.launches = 0
                got = parallel_steps(kind, dev, inits[kind], batches[kind],
                                     mesh)
                for n, f in counters.items():
                    launches[n] += f.launches
            finally:
                dist.destroy_process_group()
            bars = {k: max(2 * v, PAR_WORLD1_FLOOR[kind][k])
                    for k, v in spread.items()}
            parallel_compare(f"{kind} world-1 NCCL group vs no group "
                             f"(bars: twice the run-to-run spread, at least "
                             f"{PAR_WORLD1_FLOOR[kind]})", got, a,
                             inits[kind], bars, front=PAR_FRONT[kind])
        print(f"[parallel] world-1 launches {launches}")
        require(launches["yolo_front_train"] == PAR_STEPS
                and launches["hgstem_train"] == PAR_STEPS
                and launches["corrupt"] == 2 * PAR_STEPS,
                f"world-1 launches {launches}")
    finally:
        torch.backends.cudnn.deterministic = det

    parted = []
    with tempfile.TemporaryDirectory() as work:
        for kind in PAR_SHAPES:
            torch.save({"init": inits[kind], "batch": batches[kind],
                        "tal": refs[(kind, "bfloat16")][2].get("tal")},
                       f"{work}/{kind}.in.pt")
        for kind, model_axis, dtype, mode in PAR_RUNS:
            key = (kind, dtype) + (("k2plain",) if mode == "k2plain" else ())
            if key not in refs:
                refs[key] = parallel_steps(
                    kind, dev, inits[kind], batches[kind], None, dtype,
                    tal="record" if kind == "yolo" else None,
                    plain_front=mode == "k2plain")
            ref = refs[key]
            port = free_port()
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", PAR_WORKER, str(ROOT), str(r),
                 str(port), work, kind, str(model_axis), dtype, mode],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, OMP_NUM_THREADS="1"))
                for r in range(2)]
            errs = []
            for p in procs:
                try:
                    _, err = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                errs.append(err)
            require(all(p.returncode == 0 for p in procs),
                    f"two-process {kind}: " + " | ".join(
                        e[-2000:] for e in errs))
            outs = [torch.load(f"{work}/{kind}-{dtype}{mode}.rank{r}.pt",
                               weights_only=False) for r in range(2)]
            if "refused" in outs[0]:
                print(f"[parallel] gloo refuses CUDA tensors in this build: "
                      f"{outs[0]['refused']}; the two-process phase is "
                      f"skipped, the world-1 NCCL phase stands")
                return launches
            tag = f"{kind} {dtype}" + (f" {mode}" if mode else "")
            print(f"[parallel] two processes on one card (gloo), {tag}, "
                  f"mesh.model {model_axis}: {time.perf_counter() - t0} s")
            for r in range(2):
                parallel_compare(f"{tag} rank {r} of 2 vs one process",
                                 outs[r], ref, inits[kind],
                                 par_bars(kind, dtype), parted,
                                 front=PAR_FRONT[kind])
            if kind == "yolo" and mode != "replay":
                for r in range(2):
                    flips = tal_flips(outs[r][2], ref[2])
                    print(f"[parallel] {tag} rank {r}: TAL anchors that "
                          f"differ from the one process's a step "
                          f"(foreground, another GT, of) {flips}")
            if model_axis > 1:
                d0, d1 = (o[2]["digests"] for o in outs)
                parts, first = tp_parting(d0, d1)
                counts = {s: {k: len(v) for k, v in p.items()}
                          for s, p in parts.items()}
                print(f"[parallel] {tag} model ranks: "
                      + (f"first part at step {first[0]}, {first[1]} "
                         f"{first[2]}; leaves that differ by step "
                         f"{counts}" if first else
                         f"bit-equal after each of {len(d0)} steps "
                         f"({', '.join(PAR_TP_PARTS)}: "
                         f"{len(d0[0]['params'])} replicated leaves, "
                         f"{len(d0[0]['buffers'])} buffers, "
                         f"{len(d0[0]['match'])} matchings a step)"))
                if first:
                    parted.append(f"{tag}: {first}")
                before = {}
                for s_, (a, b) in enumerate(zip(d0, d1)):
                    before[s_] = (
                        sum(a["grad_reduced"][k] != b["grad_reduced"][k]
                            for k in a["grad_reduced"]),
                        sum(x != y for x, y in zip(a["matcher"],
                                                   b["matcher"])))
                print(f"[parallel] {tag} model ranks before the broadcasts, "
                      f"by step (replicated gradients that differ of "
                      f"{len(d0[0]['grad_reduced'])}, matcher outputs that "
                      f"differ of {len(d0[0]['matcher'])}): {before}")
                if mode == "perturb" and not all(
                        g and m for g, m in before.values()):
                    parted.append(f"{tag}: the perturbation did not reach "
                                  f"both parts {before}")
                for r, o in enumerate(outs):
                    ms = o[2].get("ms")
                    if ms:
                        print(f"[parallel] {tag} rank {r}: step ms with the "
                              f"model-group broadcasts {ms['with']}, "
                              f"without {ms['without']}; the broadcasts "
                              f"alone {ms['broadcasts']} ms a step")
        yolo_controls(dev, inits["yolo"], batches["yolo"],
                      refs[("yolo", "bfloat16")], refs[("yolo", "float32")])
    require(not parted, f"two processes: {parted}")
    return launches


# ── The corruption route and the worker loader (phases 31-32) ────────────

ROUTE_ANGLES = (45.0, 90.0)         # phase 31 (b): the op-by-op route, k 9
# phase 31 (b): the card's op-by-op noise images against the CPU's. The
# route's log, cos and sqrt are PyTorch's on each device (the CPU's
# vectorised SLEEF, the card's CUDA math library), which may round g an
# ulp apart; that moves floor(x + 15 g) by 1 only where x + 15 g lies
# within ~15 ulp of an integer: at most 1 LSB on 1e-5 of the elements
ROUTE_NOISE_BAR = (1.0, 1e-5)
LOADER_SPLIT = 36                   # phase 32: batches of 16, 16 and 4
LOADER_WORKERS = 8


def phase_corrupt_route(dev):
    """ops/corrupt.random_corruption_fast on f32 (16, 1024, 1024, 3), 4
    images a branch: (a) angle 0 launches K1 once, equal bit for bit to a
    direct K1 call; (b) angles 45 and 90 (k 9) launch no K1, the card's
    blur and lowres images equal the CPU's route bit for bit and its noise
    images within ROUTE_NOISE_BAR, the noise images equal K1's for the
    same seeds bit for bit; (c) event times of each route beside K1; (d)
    one YOLOv8m Augmented step (bs 16, 1024 px, bf16, prob 1.0, angle 45):
    finite loss, no K1 launch, K2 and K3 as at angle 0. Returns the launch
    counts of the route's K1 call and the step."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.models import yolov8 as Y
    from robust_object_detection_tpu_torch.ops import corrupt as TC
    from robust_object_detection_tpu_torch.ops import fused_corrupt as FC
    from robust_object_detection_tpu_torch.train import detector as D

    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).strip()
    counters = summary_counters()
    g = torch.Generator(dev).manual_seed(SEED + 31)
    img = torch.floor(torch.rand(TRAIN_BATCH, IMG_SIZE, IMG_SIZE, 3,
                                 device=dev, generator=g) * 256)
    choice = torch.arange(TRAIN_BATCH, device=dev, dtype=torch.int32) % 4
    seeds = torch.randint(0, 2 ** 30, (TRAIN_BATCH,), device=dev,
                          generator=g, dtype=torch.int32)
    rows = {b: (choice == b).nonzero().flatten() for b in range(4)}
    cfg0 = CorruptionConfig()

    # (a) angle 0: K1, once
    for f in counters.values():
        f.launches = 0
    out0, _ = TC.random_corruption_fast(img, None, cfg0, choice, seeds)
    launches = {k: f.launches for k, f in counters.items()}
    require(launches == per_call(corrupt=1),
            f"(a) the route at angle 0 launched {launches}, not K1 once")
    k1, _ = FC.fused_random_corruption(img, None, cfg0, choice, seeds)
    require(torch.equal(out0, k1), "(a) the route at angle 0 differs from "
                                   "a direct K1 call")
    print(f"[route] (a) angle 0: K1 launched once, output equal to a direct "
          f"K1 call bit for bit")

    # (b) angles 45 and 90: op by op on the card and on the CPU
    img_cpu, choice_cpu, seeds_cpu = img.cpu(), choice.cpu(), seeds.cpu()
    for angle in ROUTE_ANGLES:
        cfg = CorruptionConfig(blur_angle_deg=angle)
        for f in counters.values():
            f.launches = 0
        out, _ = TC.random_corruption_fast(img, None, cfg, choice, seeds)
        torch.cuda.synchronize()
        n_k1 = counters["corrupt"].launches
        require(n_k1 == 0, f"(b) angle {angle}: K1 launched {n_k1} times")
        ref, _ = TC.random_corruption_fast(img_cpu, None, cfg, choice_cpu,
                                           seeds_cpu)
        diff = (out.cpu() - ref).abs()
        by_branch = {}
        for b, name in enumerate(("clean", "noise", "blur", "lowres")):
            d = diff[rows[b].cpu()]
            by_branch[name] = (d.max().item(), (d > 0).float().mean().item())
        print(f"[route] (b) angle {angle}: card vs CPU (max abs diff, share "
              f"of elements that differ) {by_branch}")
        for name in ("clean", "blur", "lowres"):
            require(by_branch[name][0] == 0,
                    f"(b) angle {angle}: {name} differs from the CPU's "
                    f"route: {by_branch[name]}")
        require(by_branch["noise"][0] <= ROUTE_NOISE_BAR[0]
                and by_branch["noise"][1] <= ROUTE_NOISE_BAR[1],
                f"(b) angle {angle}: noise beyond {ROUTE_NOISE_BAR}: "
                f"{by_branch['noise']}")
        noise = rows[1]
        require(torch.equal(out[noise], k1[noise]),
                f"(b) angle {angle}: the noise images differ from K1's for "
                f"the same seeds")
        require(not torch.equal(out[rows[2]], k1[rows[2]]),
                f"(b) angle {angle}: the blur equals K1's 0-degree blur")
    print(f"[route] (b) angles {ROUTE_ANGLES}: K1 launched 0 times; noise "
          f"images equal K1's bit for bit")

    # (c) events: each route beside K1
    ms = {"K1 direct": time_ms(lambda: FC.fused_random_corruption(
        img, None, cfg0, choice, seeds))}
    ms["route, angle 0 (K1)"] = time_ms(lambda: TC.random_corruption_fast(
        img, None, cfg0, choice, seeds))
    for angle in ROUTE_ANGLES:
        cfg = CorruptionConfig(blur_angle_deg=angle)
        ms[f"route, angle {angle} (op by op)"] = time_ms(
            lambda: TC.random_corruption_fast(img, None, cfg, choice, seeds))
        # one branch's 4 images at a time, the other 12 clean
        for b, name in ((1, "noise"), (2, "blur"), (3, "lowres")):
            only = torch.where(choice == b, choice, torch.zeros_like(choice))
            ms[f"route, angle {angle}, {name} only"] = time_ms(
                lambda: TC.random_corruption_fast(img, None, cfg, only,
                                                  seeds))
    print(f"[route] (c) ms a call at ({TRAIN_BATCH}, {IMG_SIZE}, {IMG_SIZE}, "
          f"3) f32, 4 images a branch ({card}; CUDA events, median of 10): "
          f"{json.dumps(ms)}")
    del out, ref, out0, k1, img_cpu

    # (d) one YOLOv8m Augmented step at 45 degrees
    model = Y.create(6, "m", torch.bfloat16, dev,
                     torch.Generator().manual_seed(SEED), train=True,
                     bn_dtype=torch.bfloat16)
    state = D.init_state(model, D.make_optimizer()[0])
    step = D.make_train_step(IMG_SIZE, CorruptionConfig(blur_angle_deg=45.0,
                                                        prob=1.0),
                             augment=True, base_augment=True)
    images, gb, gc = detection_batch(np.random.RandomState(SEED + 31),
                                     TRAIN_BATCH, IMG_SIZE, GT_PER_IMAGE,
                                     MAX_BOXES)
    images, gb, gc = (torch.from_numpy(a).to(dev) for a in (images, gb, gc))
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    m = step(state, images, gb, gc, torch.Generator(dev).manual_seed(SEED))
    loss = m["loss"].item()
    step_s = time.perf_counter() - t0
    step_launches = {k: f.launches for k, f in counters.items()}
    want = per_call(yolo_front_train=1, yolo_front_bwd=1, conv3x3=8,
                    conv3x3_wgrad=4)
    print(f"[route] (d) YOLOv8m bf16 {IMG_SIZE}px batch {TRAIN_BATCH}, "
          f"augment (prob 1.0, angle 45) + HSV/flip: loss {loss}, first "
          f"step {step_s} s, launches "
          f"{ {k: v for k, v in step_launches.items() if v} }")
    require(math.isfinite(loss), f"(d) loss {loss}")
    require(step_launches == want, f"(d) launches {step_launches} != {want}")
    return {k: launches[k] + step_launches[k] for k in launches}


def phase_worker_loader(dev):
    """data/worker_pipeline.make_batches_workers on a JPEG DET split
    (LOADER_SPLIT images at phase 30's sizes) at batch 16, 1024 px, with 0
    and LOADER_WORKERS spawned workers, beside pipeline.make_batches
    (threads): the valid rows equal field by field, the short last batch
    padded by its last record with image_id -1, shuffle (at 0 workers) a
    permutation equal to the threaded loader's, numpy uint8 images, the
    parent's CUDA context intact after the workers; ms a batch each way."""
    import numpy as np
    import torch
    from robust_object_detection_tpu_torch.data import convert
    from robust_object_detection_tpu_torch.data import pipeline as P
    from robust_object_detection_tpu_torch.data import synthetic
    from robust_object_detection_tpu_torch.data import worker_pipeline as W

    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).strip()
    probe = torch.arange(1024, device=dev, dtype=torch.float32)
    bs = TRAIN_BATCH
    fields = ("images", "boxes", "classes", "image_ids", "scales")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raw = synthetic.make_det_split(tmp / "raw", n_images=LOADER_SPLIT,
                                       seed=SEED + 32,
                                       size_range=CLI_SIZE_RANGE)
        require(all(p.suffix == ".jpg" for p in (raw / "images").iterdir()),
                "the loader's split is not JPEG")
        convert.convert_det_to_coco(raw, tmp / "coco", "val")
        samples = P.index_coco(tmp / "coco", "val")
        runs, ms = {}, {}
        # (name, loader, shuffles run); spawning the workers costs seconds
        # (each imports torch), so the 8-worker loader runs once, unshuffled
        for name, make, shuffles in (
                ("threads", lambda s: P.make_batches(
                    samples, bs, IMG_SIZE, MAX_BOXES, shuffle=s, seed=SEED,
                    num_threads=LOADER_WORKERS), (False, True)),
                ("workers 0", lambda s: W.make_batches_workers(
                    samples, bs, IMG_SIZE, MAX_BOXES, shuffle=s, seed=SEED),
                 (False, True)),
                (f"workers {LOADER_WORKERS}", lambda s: W.make_batches_workers(
                    samples, bs, IMG_SIZE, MAX_BOXES, shuffle=s, seed=SEED,
                    num_workers=LOADER_WORKERS), (False,))):
            for shuffle in shuffles:
                t0 = time.perf_counter()
                stamps, batches = [], []
                for b in make(shuffle):
                    batches.append(b)
                    stamps.append(time.perf_counter() - t0)
                runs[name, shuffle] = batches
                if not shuffle:
                    ms[name] = {"first batch": stamps[0] * 1e3,
                                "a batch after the first":
                                (stamps[-1] - stamps[0]) * 1e3
                                / (len(stamps) - 1),
                                "a batch": stamps[-1] * 1e3 / len(stamps)}
    ids = [s.image_id for s in samples]
    n_last = LOADER_SPLIT % bs
    for (name, shuffle), batches in runs.items():
        want = runs["threads", shuffle]
        require([b.num_valid for b in batches] == [bs, bs, n_last],
                f"{name}: num_valid {[b.num_valid for b in batches]}")
        for b, t in zip(batches, want):
            n = b.num_valid
            for f in fields:
                a = getattr(b, f)
                require(isinstance(a, np.ndarray) and a.dtype
                        == getattr(t, f).dtype
                        and np.array_equal(a[:n], getattr(t, f)[:n]),
                        f"{name} shuffle {shuffle}: {f} differs from the "
                        f"threaded loader's")
            require(b.images.dtype == np.uint8, f"{name}: images not uint8")
        got = np.concatenate([b.image_ids[:b.num_valid] for b in batches])
        require(sorted(got.tolist()) == ids and (shuffle or got.tolist()
                                                 == ids),
                f"{name} shuffle {shuffle}: image ids {got.tolist()}")
        if name != "threads":
            last = batches[-1]
            require((last.image_ids[n_last:] == -1).all() and all(
                (getattr(last, f)[n_last:] == getattr(last, f)[
                    n_last - 1]).all() for f in fields if f != "image_ids"),
                f"{name}: the padding rows do not repeat the last record")
    shuffled = np.concatenate([b.image_ids[:b.num_valid]
                               for b in runs["workers 0", True]])
    require(shuffled.tolist() != ids, "shuffle left the order as it was")
    require(torch.cuda.is_initialized() and torch.equal(
        (probe * 2).sum(), torch.tensor(1023.0 * 1024, device=dev)),
        "the parent's CUDA context after the workers")
    print(f"[loader] {LOADER_SPLIT} JPEG images at "
          f"{CLI_SIZE_RANGE}, batch {bs}, {IMG_SIZE} px: worker batches "
          f"equal the threaded loader's (valid rows, every field; shuffled "
          f"too at 0 workers), padding repeats the last record with image_id -1, numpy "
          f"uint8, the parent's CUDA context intact")
    print(f"[loader] ms ({card}; host CPU {host_cpu()}): {json.dumps(ms)}")


NMS_SHAPES = (
    # tag, B, K, classes, P, IoU, the crowd's arguments
    ("sweep", 32, 30000, 6, 300, 0.7, {}),
    ("sweep_long", 32, 30000, 6, 300, 0.7, dict(objects=8, levels=256)),
    ("frcnn_rpn_predict", 8, 4096, 5, 512, 0.7, {}),
    ("frcnn_box_predict", 8, 2048, 6, 100, 0.5, dict(levels=100)),
    ("frcnn_rpn_train", 2, 4096, 5, 512, 0.7, {}),
)


def nms_cases():
    """tests/_torch_nms_cases.py, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_torch_nms_cases", ROOT / "tests" / "_torch_nms_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nms_held(NM, tag, boxes, scores, classes, p, thr, aware):
    """One walk against the loop on the same candidates, by equality, one
    launch; returns each image's walk length (stats, held against the
    loop's picks) and the picked scores."""
    import torch
    ref_idx, ref_sval = NM._greedy_loop(boxes, scores, classes, p, thr,
                                        aware)
    stats = torch.zeros(boxes.shape[0], dtype=torch.int32,
                        device=boxes.device)
    before = NM._nms_core.launches
    idx, sval = NM._greedy_walk(boxes, scores, classes, p, thr, aware, stats)
    torch.cuda.synchronize()
    require(NM._nms_core.launches == before + 1,
            f"{tag}: {NM._nms_core.launches - before} NMS launches, not 1")
    require(torch.equal(idx, ref_idx) and torch.equal(sval, ref_sval),
            f"{tag}: the walk's picks differ from the loop's in "
            f"{int((idx != ref_idx).sum())} positions and "
            f"{int((sval != ref_sval).sum())} scores")
    require(torch.equal(stats, NM.walk_lengths(ref_idx, ref_sval, scores)),
            f"{tag}: walk lengths {stats.tolist()} against the picks' "
            f"{NM.walk_lengths(ref_idx, ref_sval, scores).tolist()}")
    return stats, sval


def phase_nms(dev):
    """Phase 33 (see the module docstring). Returns {"nms": {"float32":
    the summary's numbers at the sweep's shape}}."""
    import torch
    from robust_object_detection_tpu_torch import kernels
    from robust_object_detection_tpu_torch.ops import nms as NM
    NC = nms_cases()
    res = {}
    for seed, (tag, b, k, n_cls, p, thr, kw) in enumerate(NMS_SHAPES):
        boxes, scores, classes = NC.crowd(b, k, n_cls, seed=seed, **kw)
        if tag.startswith("frcnn_rpn"):     # sigmoid scores, int64 levels
            scores, classes = torch.sigmoid(scores * 8 - 4), classes.long()
        boxes, scores, classes = (t.to(dev) for t in (boxes, scores, classes))
        walked, sval = nms_held(NM, tag, boxes, scores, classes, p, thr,
                                True)
        picks = (sval > 0).sum(1)
        walk_ms = time_ms(lambda: NM._greedy_walk(boxes, scores, classes, p,
                                                  thr, True))
        loop_ms = time_ms(lambda: NM._greedy_loop(boxes, scores, classes, p,
                                                  thr, True), 5, 1)
        device = sum(ms for ms, _, key in device_ms_by_kernel(
            lambda: NM._greedy_walk(boxes, scores, classes, p, thr, True))
            if "nms_walk" in key)
        nbytes = float(walked.sum()) * (16 + 4 + classes.element_size()) \
            + b * p * 12
        print(f"[nms] {tag}: B {b} K {k} P {p} IoU {thr} chunk "
              f"{kernels.nms_plan(b, k, p)['threads']}: walk events "
              f"{walk_ms} ms, device {device} ms (bytes bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3} ms); loop {loop_ms} ms; "
              f"picks {picks.tolist()}; walk lengths {walked.tolist()}",
              flush=True)
        if tag == "sweep":
            res = {"nms": {"float32": dict(
                max_abs_err=0.0, ms=walk_ms, plain_ms=loop_ms,
                device_ms=device, bytes=nbytes, flops=0.0,
                peak=PEAK_FLOPS["float32"], library_ms=None,
                walk_lengths=walked.tolist())}}
    # exact ties (64 score levels) and IoUs an ulp around the threshold on
    # boxes whose products and sums round
    boxes, scores, classes = (t.to(dev) for t in NC.crowd(
        32, 30000, 6, seed=11, levels=64))
    nms_held(NM, "ties", boxes, scores, classes, 300, 0.7, True)
    boxes, scores, iou = NC.ulp_pairs(4096, seed=0)
    thr = NC.densest_iou(iou)
    _, sval = nms_held(NM, "ulp", boxes.to(dev), scores.to(dev),
                       torch.zeros(scores.shape, dtype=torch.int32,
                                   device=dev), 2, thr, False)
    kept = int((sval[:, 1] > 0).sum())
    print(f"[nms] ulp: {int((iou == thr).sum())} of 4096 IoUs at the "
          f"threshold {thr}, {kept} second boxes kept", flush=True)
    require(0 < kept < 4096, f"ulp: {kept} of 4096 second boxes kept; the "
            f"case needs both kept and suppressed ones")
    # multilabel_nms at the sweep's decode shape, top-k included, both ways
    g = torch.Generator().manual_seed(12)
    anchors, _, _ = NC.crowd(32, 21504, 1, seed=12, objects=4000)
    anchors = anchors.to(dev)
    logits = (torch.randn(32, 21504, 6, generator=g) * 2 - 3).to(dev)
    scores = torch.sigmoid(logits)
    walk = NM.multilabel_nms(anchors, scores)
    walk_ms = time_ms(lambda: NM.multilabel_nms(anchors, scores))
    real = NM._greedy_walk
    NM._greedy_walk = lambda b_, s_, c_, p_, t_, a_, st=None: \
        NM._greedy_loop(b_, s_, c_, p_, t_, a_)
    try:
        loop = NM.multilabel_nms(anchors, scores)
        loop_ms = time_ms(lambda: NM.multilabel_nms(anchors, scores), 5, 1)
    finally:
        NM._greedy_walk = real
    require(all(torch.equal(x, y) for x, y in zip(walk, loop)),
            "multilabel_nms: the walk's detections differ from the loop's")
    print(f"[nms] multilabel_nms 32 x 21504 x 6 -> 30000 -> 300: walk "
          f"{walk_ms} ms, loop {loop_ms} ms (events, top-k included); "
          f"detections an image {walk[3].sum(1).tolist()}", flush=True)
    return res


def ptxas_report(log: str):
    """(entry function, resource line) pairs from nvcc's -Xptxas=-v output:
    the stack / spill line and the registers line of each kernel."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in line or "spill" in line):
            out.append((fn, line.split(" : ", 1)[-1].strip()))
    return out


def sass_opcodes(so, names):
    """{function: {opcode: count}} of the SASS (cuobjdump -sass) of the
    kernels in the built library whose names contain one of `names`, each
    instruction counted under its opcode (``LDG``) and, where it has
    modifiers, under its full name (``LDG.E.128``)."""
    from robust_object_detection_tpu_torch import kernels
    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    require(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
            if fn:
                counts[fn] = {}
            continue
        m = fn and re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                            r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)", line)
        if m:
            for op in {m.group(1), m.group(1) + m.group(2)}:
                counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def main() -> int:
    import torch
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from robust_object_detection_tpu_torch import kernels

    print(f"[env] nvcc: {run_cmd([kernels.nvcc_path(), '--version'])}"
          .replace("\n", " | "))
    print(run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]))
    dev = torch.device("cuda", 0)
    print(f"[env] device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    print(f"[build] {so.name} in {time.perf_counter() - t0} s")
    for fn, line in ptxas_report(kernels.build_log()):
        print(f"[build] {fn}: {line}")
    sass = sass_opcodes(so, TC_KERNELS)
    for fn, ops in sass.items():
        print(f"[build] SASS of {fn}: HMMA {ops.get('HMMA', 0)} (TF32 "
              f"{ops.get('HMMA.1688.F32.TF32', 0)}) HGMMA "
              f"{ops.get('HGMMA', 0)} LDSM {ops.get('LDSM', 0)} LDGSTS "
              f"{ops.get('LDGSTS', 0)} FFMA {ops.get('FFMA', 0)}")
    for name in TC_KERNELS:
        found = [ops for fn, ops in sass.items() if name in fn]
        require(found and all(ops.get("HMMA", 0) + ops.get("HGMMA", 0) > 0
                              for ops in found),
                f"{name}: no tensor-core instruction in its SASS")
        if "tf32" in name:
            require(all(ops.get("HMMA.1688.F32.TF32", 0) > 0
                        for ops in found),
                    f"{name}: no TF32 MMA in its SASS")

    # the gather's 16-byte instantiations (K5 and K5-g2 forward, bf16 8
    # and f32 4 channels a load), K5-g2's relayout and the backward's bf16
    # taps kernels must load with 128-bit LDGs; the scatters beside them
    sass = sass_opcodes(so, ("ms_deform_attn_kernel", "values_t_to_rows",
                             "deform_bwd_", "stamp_scatter_kernel"))
    for fn, ops in sass.items():
        ldg = {k: v for k, v in ops.items() if k.startswith("LDG.")}
        print(f"[build] SASS of {fn}: LDG {ops.get('LDG', 0)} {ldg} SHFL "
              f"{ops.get('SHFL', 0)} FFMA {ops.get('FFMA', 0)} STG "
              f"{ops.get('STG', 0)} BAR {ops.get('BAR', 0)}")
    for parts in K5_WIDE:
        found = [ops for fn, ops in sass.items()
                 if all(p in fn for p in parts)]
        require(found and all(any(k.startswith("LDG.") and ".128" in k
                                  for k in ops) for ops in found),
                f"{' '.join(parts)}: no 16-byte value loads in its SASS")

    phase_s = {}

    def timed(fn):
        t0 = time.perf_counter()
        out = fn(dev)
        phase_s[fn.__name__] = time.perf_counter() - t0
        print(f"[phase] {fn.__name__}: {phase_s[fn.__name__]} s", flush=True)
        return out

    kres = timed(phase_kernels)
    timed(phase_model_check)
    launches = timed(phase_sweep)
    kres.update(timed(phase_train_kernels))
    timed(phase_train_model_check)
    train_launches = timed(phase_training)
    kres.update(timed(phase_rtdetr_kernels))
    timed(phase_rtdetr_model_check)
    rtdetr_launches = timed(phase_rtdetr_sweep)
    kres.update(timed(phase_rtdetr_train_kernels))
    timed(phase_rtdetr_train_model_check)
    rtdetr_train_launches = timed(phase_rtdetr_training)
    kres.update(timed(phase_sorted_kernels))
    generation_launches = timed(phase_deform_generations)
    timed(phase_unet_model_check)
    restored_launches = timed(phase_restored_sweep)
    timed(phase_unet_training)
    timed(phase_frcnn_model_check)
    frcnn_launches = timed(phase_frcnn_sweep)
    timed(phase_frcnn_bucketed)
    timed(phase_frcnn_train_model_check)
    frcnn_train_launches = timed(phase_frcnn_training)
    yolo_trainer_launches = timed(phase_yolo_trainer)
    rtdetr_trainer_launches = timed(phase_rtdetr_trainer)
    cli_launches = timed(phase_cli)
    frcnn_bf16_launches = timed(phase_frcnn_bf16)
    parallel_launches = timed(phase_parallel)
    codec_launches = timed(phase_codec)
    route_launches = timed(phase_corrupt_route)
    timed(phase_worker_loader)
    kres.update(timed(phase_nms))
    print(f"[phase] seconds: {json.dumps(phase_s)}")
    # a kernel may run on several paths; each count comes from its own
    # path's run, zeroed just before it
    for path in (train_launches, rtdetr_launches, rtdetr_train_launches,
                 generation_launches, restored_launches, frcnn_launches,
                 frcnn_train_launches, yolo_trainer_launches,
                 rtdetr_trainer_launches, cli_launches, frcnn_bf16_launches,
                 parallel_launches, codec_launches, route_launches):
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n

    src = "robust_object_detection_tpu_torch/csrc/"
    ref = "robust_object_detection_tpu/ops/"
    summary = []
    for name, source, replaces, dtype in (
            ("conv3x3", "conv3x3.cu", "pallas_conv.py:37", "bfloat16"),
            ("yolo_front", "yolo_front.cu", "pallas_yolo_front.py:109",
             "bfloat16"),
            ("conv3x3_wgrad", "conv3x3_wgrad.cu", "pallas_conv.py:62",
             "bfloat16"),
            ("yolo_front_train", "yolo_front.cu", "pallas_yolo_front.py:109",
             "bfloat16"),
            ("yolo_front_bwd", "yolo_front_bwd.cu",
             "pallas_yolo_front.py:200", "bfloat16"),
            ("corrupt", "corrupt.cu", "pallas_corrupt.py:52", "float32"),
            ("hgstem", "hgstem.cu", "pallas_stem.py:170", "bfloat16"),
            ("ms_deform_attn", "ms_deform_attn.cu", "deform.py:798",
             "bfloat16"),
            ("hgstem_train", "hgstem.cu", "pallas_stem.py:170", "bfloat16"),
            ("hgstem_bwd", "hgstem_bwd.cu", "pallas_stem.py:601",
             "bfloat16"),
            ("ms_deform_attn_bwd", "deform_bwd.cu", "deform.py:901",
             "bfloat16"),
            ("auction", "auction.cu", "assignment.py:113", "float32"),
            ("ms_deform_attn_sorted", "ms_deform_attn_sorted.cu",
             "deform.py:398", "bfloat16"),
            ("ms_deform_attn_sorted_bwd", "deform_bwd.cu",
             "deform.py:524", "bfloat16"),
            ("stamp_scatter", "stamp_scatter.cu", "deform.py:170",
             "float32"),
            ("nms", "nms.cu", "nms.py:50", "float32")):
        r = kres[name][dtype]
        bound_ms, bound_by = bound(r)
        summary.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": r["library_ms"]})
        # K5-g1's and K5-g2 forward's times by layout; K5-g2 forward's
        # values_t bound, library composition and clustered samples
        for key in ("ms_by_layout", "values_t_bound_ms", "values_t_sectors",
                    "grid_sample_fwd_ms", "grid_sample_fwd_device_ms",
                    "clustered"):
            if key in r:
                summary[-1][key] = r[key]
        if name == "auction":
            # the device ms and rounds of the train shape's call, and the
            # capped case's events, device ms and rounds
            summary[-1]["train_device"] = r["train_device"]
            summary[-1]["capped"] = r["capped_ms"]
        if name == "corrupt":
            summary[-1]["by_branch"] = kres["corrupt_by_branch"]
        if name == "nms":
            # the sweep's shape: device ms, each image's walk length
            summary[-1]["device_ms"] = r["device_ms"]
            summary[-1]["walk_lengths"] = r["walk_lengths"]
        if name in ("conv3x3", "conv3x3_wgrad", "yolo_front",
                    "yolo_front_train", "yolo_front_bwd", "hgstem",
                    "hgstem_train", "hgstem_bwd"):
            # K3's, K2's and K4's route by dtype: tensor cores
            # (conv3x3_tc.cuh, front_tc.cuh, stem_tc.cuh) for bf16, their
            # split-TF32 kernels (conv3x3_tf32.cuh, front_tf32.cuh,
            # stem_tf32.cuh) for f32; the f32 route's numbers beside
            summary[-1]["dtype_routes"] = {"bfloat16": "tc",
                                           "float32": "tc-3xtf32"}
            summary[-1]["float32"] = f32_route_numbers(kres[name]["float32"],
                                                       True)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
