"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each prints one line or more; any failure ends the run with a
non-zero exit):

1. device check: CUDA must be available; prints the card's name and
   `nvidia-smi` name and power limit;
2. builds the CUDA kernels from `pdm_ssd_torch/csrc/` (one `nvcc` per source,
   side by side);
3. FPS kernel against the plain PyTorch FPS on the card, exact index
   equality, at the flagship shape (8, 16384) -> 4096, on a tie-heavy cloud
   (duplicated grid points and a zero-padded tail), at an odd N and at the
   three shapes of a PointRCNN predict ((4, 4096) -> 1024 in the backbone;
   400 clouds of 512 points -> 128, some of them 512 copies of the origin,
   and the 128 picked -> 32 in the ROI stack); times both (median of 5, CUDA
   events);
4. the flagship (`configs/kitti_models/pdm_ssd_point.yaml`, seeded random
   weights and BatchNorm statistics) at B=2, N=4096: forward on CUDA against
   the same model on the CPU, TF32 off;
5. the unmodified flagship's `predict` at B=8, N=16384: output shapes,
   finite values, kernel launches counted in that run, and frames/s (median
   of 5 timed runs after warm-up);
6. the grouping kernels (`window_select`, `gather_rows`, `scatter_add_rows`)
   against their plain versions on the card, at the shapes of the flagship's
   three SA levels (B=8) and at one ragged shape (odd M, 37 channels of
   which a slice is read, three radii, cap 20, indices out of range, empty
   balls, centers out of range): selection and gather exact (the plain
   emulation of the selection's compacted walk exact too), scatter-add
   within the rounding of float32 sums in any order; times kernel, plain
   version and the one PyTorch call that computes the same function (median
   of 5, CUDA events), and reckons each kernel's bound from the bytes it
   must move; prints per SA level and in total, from the plain emulations,
   the selection's occupied slots and walk steps per center against the
   ceil(9 * cap / 32) of a walk over the uncompacted window, and the
   scatter-add's rows, runs, sums sent and atomics;
7. the flagship's training loss and every parameter's gradient at B=2,
   N=4096 on CUDA against the CPU, TF32 off;
8. five training steps of the unmodified flagship at B=8, N=16384 with 8
   boxes per cloud through `make_train_step`: finite losses, the last below
   the first, parameters changed, the kernels' launches per step, ms per
   step and the peak of allocated device memory;
9. both ball-query kernel paths (`ops/ball_query.ball_query_plan`: the grid
   path walks a sorted cell grid built on the device, the walk path every
   point) against the plain version on the card, exact index equality, at the
   shapes PointRCNN gives it (`configs/kitti_models/pointrcnn.yaml`: the
   backbone's three SA levels at B=4, which the plan sends to the grid, the
   ROI head's two at 400 clouds, which it sends to the walk), with a mask, at
   a ragged shape (odd N and M, three radii, K = 5/70/3, centers far outside
   the cloud, duplicated points) and on clouds of 512 origins; at each shape
   the row gather by the selected indices, kernel against plain version,
   exact, of xyz and of features in the widths and layouts the model gathers
   (channel slices of the (B, N, 4) cloud and of the 5-channel pooled block,
   96, 256 and 128 channels); times both paths, the grid's build and walk
   apart, and the plain version over the backbone's levels, and on a denser
   cloud that fills the balls; the bound is the bytes or the distance tests
   in a 3x3 window of radius-sized cells, counted from the run's data, and
   the tests each path walks stand beside it (the grid's from the plain
   emulation of its walk, which must equal the plain version too);
10. PointRCNN with its FP list made whole (`synthetic.pointrcnn_fp3`) at B=2,
   N=4096, `NPOINTS` cut to [1024, 256, 64]: forward on CUDA against the CPU,
   TF32 off, the same number of proposals kept per cloud, the per-ROI
   outputs compared ROI by ROI after matching the proposals by box;
11. the same model's `predict` at full width, B=4, N=16384: shapes, finite
   values, kernel launches counted in that run (the ball query's by path: 3
   grid, 2 walk), frames/s and peak memory;
   then one `predict` of the file as shipped: shapes and finite values;
12. the sparse-conv kernel against its plain version and against a float64
   evaluation (each within float32 rounding of the sum of magnitudes), two
   runs bit-equal, rows without taps exactly 0, at the twelve layers of
   SECOND's ladder (`configs/kitti_models/second_sparse.yaml`, B=4, 40000
   voxel slots) with the maps, the layer inputs and the plans of a forward
   over the full-width synthetic batch, at the TPU microbench's shape (V =
   52224, C = 64, K = 27, its `make_maps`), at a ragged row count and with
   rows whose taps are all absent; per layer and in total the taps the plan
   makes the kernel compute over the taps present (at most 1.6 over the
   twelve layers, each weighted by Cin * Cout) and each plan's build time;
   times kernel, plain version and the gather + `torch.matmul` pair (median
   of 5, CUDA events); the bound is the bytes (table, map and weights read
   once, output written once) or the multiply-adds of the taps present in
   this run's maps, and the bytes the kernel really moves stand beside it;
13. the row gather's bfloat16 entry point at (52000, 96) with repeated
   indices, and its float32 use in the model, the reorder of (4, 40000, 4)
   voxel features by `sp_perm1`: exact; kernel, plain version,
   `torch.index_select`, bound;
14. the tiny SECOND (`synthetic.tiny_second_cfg`) on CUDA against the CPU:
   voxelizer and kernel maps equal exactly, head outputs within FWD_RTOL of
   scale, the same number of boxes kept per cloud, detections matched by box
   and label as phase 10 matches its ROIs;
15. SECOND's `predict` as shipped at B=4 on LiDAR-like clouds of 50000
   points: shapes, finite values, the active and dropped sites of every
   stage, kernel launches counted in that run (12 sparse convs, 1 row
   gather), ms per batch and frames/s with and without voxelizer and map
   build, peak memory;
16. the mini-KITTI set (64 frames, 3 classes) generated by the port's own
   generator under `build/chip_smoke_kitti/` (a checkout holds no `data/`),
   then the flagship as shipped (seeded weights and BatchNorm
   statistics, N=16384) through `runtime/eval_utils.eval_one_epoch` at B=8
   over the val split: kernel launches counted over the loop, one predict's
   worth a batch; recall and KITTI AP R40 finite, printed; frames/s of
   `predict` alone and of the loop with loading; then the same loop at B=2
   with `NUM_POINTS` 4096 over 8 frames on CUDA against the CPU: the same
   number of detections in every frame, matched by box and label as phase 10
   matches its ROIs;
17. `runtime/trainer.train_model` on the mini train split at B=8, full
   width, augmentation and GT sampling on: one epoch, a checkpoint, a resume
   into a fresh model and optimizer (epoch, the schedule's iteration, the
   optimizer's moments and the weights restored exactly), a second epoch,
   the rotation down to `max_ckpt_save_num=1`; finite losses and the
   kernels' launches over both epochs (the scatter-add's 4 a step); every
   step's loss and each term's largest value (`StepLog`); a model
   loaded from the last checkpoint predicts bit for bit what the trained one
   does (deterministic algorithms on for that comparison); then
   `eval_one_epoch` of that checkpoint, AP printed, no threshold;
18. `bench_torch.py` as a subprocess: exactly one JSON line with the four
   keys and a positive value, printed with the card's name and power limit;
19. the tiny `pdm_ssd.yaml` (`synthetic.tiny_grid_cfg`: pillarize,
   GridPointBackbone, the grid PDM neck, circle NMS) on CUDA against the
   CPU at B=2, N=4096, the heatmap bias at 0 (`synthetic.open_score_gate`):
   forward outputs within FWD_RTOL of scale, detections matched by box and
   label; `ops/iou3d.circle_nms` on the card equal to the CPU's, slot order
   and keep mask, on the same candidates (a lattice with ties and pairs at
   exactly the radius, and 800 boxes a cloud at B=8);
20. `pdm_ssd.yaml` as shipped, `predict` at B=8, N=16384, the heatmap bias
   at 0: shapes, finite values, no launch of any kernel of the port (counted,
   0 expected), frames/s, peak memory, then `torch.profiler`'s device time
   and busy share, every kernel of cuDNN's FFT route, and each convolution
   stage's peak memory beyond its input (the kernels of a stage above 1 GiB
   named);
21. five training steps of `pdm_ssd.yaml` at B=8, N=16384 (as phase 8): ms
   per step and peak memory, no launch;
22. and 23. phases 16 and 17 with `pdm_ssd.yaml` (the heatmap bias at 0 in
   the eval loop): the eval loop at B=8, the 2-epoch train loop with
   checkpoint, resume and bit-equal reload (no CUDA-vs-CPU eval pass: see
   `grid_family_phases`);
24. `pdm_ssd_large.yaml` as shipped, `predict` at B=4 on clouds of 163840
   points over its +-75.2 m range (`synthetic.large_scene_points`), the
   heatmap bias at 0: frames/s, peak memory, device time, busy share;
25. five training steps of `pdm_ssd_aux.yaml` (the flagship with the
   train-only PointHeadSimple) at B=8: 1 FPS, 3 selection, 6 gather and 4
   scatter-add launches a step, ms per step;
26. the flagship with TTA_FLIP ['y']: the tiny model on CUDA against the CPU
   (detections matched by box and label), then as shipped at B=8: twice a
   predict's launches, frames/s;
27. the sparse conv's backward against its plain versions and a float64
   evaluation (each within float32 rounding of the sum of magnitudes), two
   runs bit-equal, absent taps and rows without taps exactly 0: the data
   gradient (the forward kernel through the transposed map, W flipped) and
   the weight gradient (`sparse_conv_wgrad`) at SECOND's twelve layers with
   the maps, plans, layer inputs and a seeded output gradient of a
   full-width training batch (B=4, 16000 voxel slots, ACTIVE_CAPS as
   shipped), and at the TPU microbench's shape; times kernel, plain version
   and the gather + `torch.matmul` pair (device ms per launch, host us), the
   bound from bytes or the multiply-adds of the present taps, and the weight
   gradient's scratch per layer and the largest;
28. the tiny SECOND's training loss and every gradient on CUDA (the kernels)
   against the CPU (the plain versions);
29. five training steps of `second_sparse.yaml` as shipped at B=4 with 8
   boxes a cloud: a finite and falling loss, 23 sparse-conv (12 forward, 11
   data gradient), 12 weight-gradient and 1 row-gather launches a step, ms
   per step with and without the map build, peak memory (at B=2, said so,
   where B=4 does not fit);
30. phases 16 and 17 with `second_sparse.yaml` at B=4: the eval loop (the
   anchor head's bias at 0) and the 2-epoch train loop with checkpoint,
   resume and bit-equal reload, a predict's and a train step's launches a
   batch, the detections of the trained checkpoint's eval with a non-finite
   box counted;
31. the tiny shrink of each of `pointpillar.yaml`, `centerpoint_pillar.yaml`,
   `pillarnet.yaml` and the dense `second.yaml` (`synthetic.TINY_CFGS`) on
   CUDA against the CPU, the classification bias at 0: batches equal,
   forward outputs within FWD_RTOL of scale, detections matched by box and
   label, every term of the training loss within LOSS_RTOL and every
   gradient within GRAD_RTOL relative L2;
32. each of the four as shipped, `predict` at B = 8, 8, 8 and 4 (the voxel
   models on LiDAR-like clouds of 50000 points, their 16000
   voxel slots, the point models at N=16384), the bias at 0: shapes, finite
   values, no launch of a kernel of the port (none is on these paths),
   frames/s, peak memory, the convolutions' GFLOP and rate, device time,
   busy share and cuDNN's FFT-route kernels;
33. five training steps of each at its BATCH_SIZE_PER_GPU (4, 8, 8, 4) with
   8 boxes a cloud: a falling loss, ms per step, peak memory, no launch;
34. phases 16 and 17 with `pointpillar.yaml` (the voxel data path) at B=4
   and `centerpoint_pillar.yaml` (the point data path) at B=8: the eval
   loop with the bias at 0, AP R40 and recall finite, and the 2-epoch train
   loop with an exact resume;
35. the tiny shrink of `voxelnext.yaml` and of `second_focal.yaml`
   (`synthetic.TINY_CFGS`) on CUDA against the CPU on a training batch
   prepared on each device, the classification bias at 0: every map tensor
   (the BEV slot table, the focal ladder and the transposed maps) equal, the
   forward within FWD_RTOL of scale, its integer and bool outputs (the focal
   activation bits per stage) equal, detections matched by box and label,
   every loss within LOSS_RTOL, every gradient within SECOND_GRAD_RTOL
   relative L2;
36. the sparse conv, its data gradient and its weight gradient against their
   plain versions and a float64 evaluation, two runs bit-equal, at the
   shapes only these models give them: VoxelNeXt's six 9-tap BEV layers
   (B=4, 40000 voxel slots), the focal SECOND's three importance convs (27
   output channels), three convs over its dilated tables and three down
   convs reading them (B=4 training batch, tables of 64000 and 120000
   slots); device ms, plain ms and the bound per layer and per group;
37. `predict` of both as shipped at B=4 on LiDAR-like clouds of 50000
   points (40000 voxel slots), the bias at 0: shapes, finite values, 1 row
   gather and 18 sparse-conv launches, the tables' fill, ms of the map build
   and of predict on a prepared batch, each timed inside one pass,
   frames/s, device time and busy share, peak memory;
38. five training steps of each at B=4 (phase 29's function): 35
   sparse-conv, 18 weight-gradient and 1 row-gather launches a step, ms with
   and without the map build, peak memory;
39. phases 16 and 17 with `voxelnext.yaml` at B=4: the eval loop (bias at 0,
   non-finite boxes counted) and the 2-epoch train loop with resume and
   bit-equal reload;
40. TTA_FLIP of `Detector3D` on CUDA against the CPU: the tiny
   `centerpoint_pillar.yaml` with ['x', 'y'] and the tiny sparse SECOND with
   ['x'] (its maps built once, before `predict`), detections matched by box
   and label;
41. the tiny PointRCNN (its FP list whole, its ROIs pooled 2 m wider) and
   the tiny shrinks of `pv_rcnn.yaml`, `pv_rcnn_sparse.yaml`,
   `voxel_rcnn.yaml` and `voxel_rcnn_sparse.yaml` on CUDA against the CPU,
   on a training batch whose ground truth sits on proposals and one draw of
   the ROI targets fed to both: integer and bool outputs equal (the
   keypoints, the proposals' mask and labels, PV-RCNN's grid-pool indices
   and empty balls, the targets' order, fg mask, matched ground truth),
   the rest within FWD_RTOL, detections matched, losses within LOSS_RTOL,
   gradients within SECOND_GRAD_RTOL;
42. the kernels at this slice's shapes against their plain versions on the
   files as shipped at B=4: PV-RCNN's grid-pool ball query (B * R clouds of
   64 keypoints, 216 grid points, two radii; exact), the gathers of its
   offsets and projected features (exact) and the scatter-add of their
   backward (float64 bound), the voxel pools' gathers of PV-RCNN's VSA and
   of Voxel R-CNN's ROI pool on the dense and the sparse ladder (exact);
   device ms, plain ms, library ms and the bound;
43. `predict` of the four as shipped at B=4 on LiDAR-like clouds of 16384
   points (16000 voxel slots), the anchor bias at 0: the launches of
   `two_stage_launches`, ms of the map build and of predict, frames/s,
   device time, busy share, top kernels, peak memory;
44. five training steps of PointRCNN (B=4, its FP list whole) and of the
   four (B=2), 8 boxes a cloud: finite losses, the ROI terms of every
   step, the launches a step, ms per step, peak memory;
45. phases 16 and 17 with `pv_rcnn.yaml` at B=2: the eval loop (bias at 0,
   non-finite boxes counted) and the 2-epoch train loop over the first 16
   train frames with an exact resume and a bit-equal reload;
46. to 50. SECOND-IoU, Part-A2 and PV-RCNN++ (dense and sparse): the tiny
   shrinks on CUDA against the CPU, the masked FPS at PV-RCNN++'s shape,
   predict at B=4 and five steps at B=2 as shipped, `parta2.yaml`'s loops
   (its train loop over the first 16 train frames);
51. the tiny `pdm_ssd_nuscenes.yaml` (`synthetic.tiny_nuscenes_cfg`) and its
   variant with `bevfusion.yaml`'s six head groups, 'vel' and 'iou' branches,
   IOU_REG_LOSS and PRED_VELOCITY (`synthetic.multihead_variant`) on CUDA
   against the CPU at B=2, N=4096 (forward, detections matched by box and
   label, losses, gradients), and `multi_classes_nms` and
   `class_specific_nms` on the card equal to the CPU's, slot order and keep
   mask;
52. both at full width, `predict` at B=4 on clouds of 163840 points of 5
   features, every head group's score gate open: no launch of a kernel of
   the port, frames/s, device time, busy share, GFLOP, top kernels, peak;
53. five training steps of each at B=4, 8 boxes a cloud: ms a step, peak;
54. the port's mini nuScenes set (80 frames at 10 sweeps, generated under
   `build/chip_smoke_nuscenes/`) through `eval_one_epoch` at B=4 (NDS, mAP,
   `infer_fps`, `loop_fps`) and 2 epochs of `train_model` with CBGS; the
   eval loop's seeded weights and the trained checkpoint on CUDA against
   the CPU over 4 of its frames and 4 clouds that fill the range: the
   forward within FWD_RTOL; for the seeded weights also the kept boxes
   above every tied candidate score matched by box and label, on the CPU's
   maps post-processed on the card and on each side's own maps (at least
   one such box; the trained checkpoint's top scores all tie);
55. the tiny `dsvt.yaml` and `transfusion.yaml` (`synthetic.TINY_CFGS`) on
   CUDA against the CPU at B=2, N=16384, 8 boxes a cloud: the forward within
   FWD_RTOL; DSVT's kept boxes above the tie level matched both ways, as
   phase 54 holds them; TransFusion's queries replayed from the CPU's picks
   (`QueryReplay`, its own picks above the tie level checked among them),
   its detections matched by box and label and its LAP assignment equal
   (or of equal total cost); losses and gradients;
56. `predict` of both as shipped at B=8 on clouds of 16384 points: no
   launch of a kernel of the port, frames/s, device time, busy share, the
   GFLOP of the convolutions and matrix products, top kernels, peak;
57. five training steps of each at B=8, 8 boxes a cloud: ms a step, peak,
   and TransFusion's host LAP a step;
58. phases 16 and 17 with both files at B=8: the eval loop over the val
   split and the 2-epoch train loop over the first 16 train frames, with
   resume and bit-equal reload, no launch;
59. the tiny `mppnet_mini.yaml` (`synthetic.tiny_mppnet_cfg`) on CUDA
   against the CPU on two clouds of a generated mini-Waymo set: the
   forward on the offline proposals and, the proposals matched by box and
   then replayed, on the first stage's NMS proposals; three streamed steps
   of `predict_with_state`, the memory bank equal after each; the losses
   and gradients; the crops' row gathers counted;
60. `mppnet_16frame.yaml` at full width (B=2, 16 frames of 16384 points,
   96 proposals, 64 proxies, 128 points a crop, d=256, the voxel step its
   data path lacks: `synthetic.waymo_voxel_step`), its batches from a
   generated 20-frame Waymo set through `WaymoDataset` and `collate_batch`,
   the anchor bias at 0: `predict` as shipped (NMS proposals) with its
   stages synchronized one by one (`StageTimer`), `predict` on the offline
   proposals, and `predict_with_state` streamed over 17 frames of each
   cloud: frames/s, device time, busy share, GFLOP, peak memory, one
   `gather_rows` launch a frame and a step;
61. five training steps of it, with a profiled sixth and seventh: ms a step,
   GFLOP, device time, busy share, peak memory, `gather_rows` twice a frame
   (the crops and their recomputation in the backward) and no
   `scatter_add_rows` (the crops read the input frames, which take no
   gradient);
62. `mppnet_mini.yaml` on a fresh set from `tools.make_mini_waymo`: two
   epochs of `train_model`, then `eval_one_epoch` of the trained checkpoint
   with Waymo AP and APH at both levels;
63. the tiny BEVFusion (`synthetic.tiny_bevfusion_cfg`) on CUDA against the
   CPU at B=2 with two cameras, the CPU's frustum cells replayed on CUDA
   (`GeometryReplay`, which counts the points that floor apart): forward,
   detections, losses, gradients; `bev_pool` on CUDA against float64 sums;
64. `predict` of `bevfusion.yaml` (`synthetic.bevfusion_grid`: its three
   grids made to agree, every width as shipped) at B=3 on
   `synthetic.camera_batch`es (120000 points, six cameras of 256 x 704):
   frames/s, device time, busy share, GFLOP, peak, no launch, and its
   stages synchronized one by one (`BevStageTimer`: Swin, the neck, the
   lift, the geometry, `bev_pool`, the LiDAR branch, the fuser, the BEV
   backbone, the head, post-processing);
65. five training steps of it with 8 boxes a cloud, a profiled sixth (GFLOP,
   device time, busy share) and a training forward's stages;
66. `bevfusion_mini.yaml` on a fresh mini nuScenes set with its front
   camera (`make_mini_nuscenes --cams`): `eval_one_epoch` of seeded weights
   (NDS, mAP), two epochs of `train_model`, the trained checkpoint's eval;
67-70. CaDDN (`synthetic.caddn_kitti()`): its frustum corners and the
   row gather and scatter-add at its shapes on CUDA against the CPU, its
   predict and training at full width, and its KITTI camera loops
   (`caddn_phases`);
71. the five generated mini sets of ONCE, Argoverse 2, Lyft, Pandaset and
   the custom layout (`tools.make_mini_sets`, 8 frames a split, under
   `build/chip_smoke_sets/`), and the flagship at full width (seeded
   weights, its score gate open) on each set's first val batch at B=2,
   N=4096, on CUDA against the CPU: the forward within FWD_RTOL of scale,
   the kept boxes above the tie level matched both ways;
72. for each set, the flagship as shipped on it (`synthetic.flagship_on`,
   N=16384) through `eval_one_epoch` at B=4 over its 8 val frames: the
   set's own metric (ONCE AP, Argoverse 2's CDS and mAP, the Lyft mAP of
   Lyft and Pandaset, the custom set's recall), no non-finite box,
   frames/s, and one predict's launches a batch;
73. `train_model` on the custom set at B=2, GT sampling from its own
   database and the six local augmentations in the queue, 2 epochs of 4
   steps: the last epoch's mean loss below the first's, a training step's
   launches a step, then the checkpoint through the eval loop;
74. data parallelism (`pdm_ssd_torch/parallel`): the flagship at full width
   (seeded weights, TF32 off) takes one training step on 8 clouds of 16384
   points with 8 boxes a cloud in one process, then on two gloo ranks on
   the one card (`parallel.spawn`, 4 clouds a rank, DistributedDataParallel
   with global BatchNorm statistics and loss normalisers): the ranks' loss
   within DDP_LOSS_RTOL of the one process's, their gradients within
   DDP_GRAD_REL_L2 relative L2 of it in each leaf group and their BatchNorm
   buffers likewise, both ranks' gradients equal, each rank's launches equal
   the one process's step's; each rank's ms per step and the gradient
   all-reduce's bytes and ms; the one process's step run twice, read
   against itself (the card's own spread); each of DDP_FAULTS planted in
   the ranks' BatchNorm statistics, which the gradient bound must catch;
   then one DistributedDataParallel step on a world of one under NCCL,
   with an NCCL all-reduce checked.

Every phase's line ends with the seconds since the start, and the elapsed
time is printed after phases 18, 40, 50, 54, 58, 62, 66, 70, 73 and 74.
The line before the last is the card's name and power limit; before it, one
JSON line describing each kernel, with the launches of each path of phases
20 to 73 (`launches_<path>`,
`launches_nuscenes_{predict,train,eval_loop,train_loop}`,
`launches_{dsvt,transfusion}_{predict,train,eval_loop,train_loop}`,
`launches_mppnet_{predict,predbox_predict,stream,train,eval_loop,train_loop}`,
`launches_bevfusion_{predict,train,eval_loop,train_loop}`,
`launches_caddn_{predict,train,eval_loop,train_loop}`,
`launches_{once,argo2,lyft,pandaset,custom}_eval_loop`,
`launches_custom_train_loop` and
`launches_ddp_{one_process,rank0,rank1,nccl}` among them) and the sums of phase 42
(`two_stage_*`). The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# the start of the run, for the elapsed time printed after each group of phases
T0 = time.perf_counter()
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'
# forward on CUDA vs CPU: float32 sums in another order (GEMM, cuDNN) and
# atomic adds in the PDM scatter; the measured difference on an H100 is
# about 3e-6 of the output scale, the bound leaves a wide margin
FWD_RTOL = 1e-3
# training loss on CUDA vs CPU: the same sources of difference
LOSS_RTOL = 1e-3
# every parameter's gradient on CUDA vs CPU, relative L2 per tensor: the
# same sources, plus BatchNorm on batch statistics, whose division by a
# channel's own deviation and the cancelling sums behind a bias's gradient
# enlarge float32 rounding (the CPU tests measure up to 8e-3 between the
# port's float32 and float64 gradients on a small cloud); measured on an H100:
# worst 2.3e-2, at a BatchNorm bias of SA level 2
GRAD_RTOL = 6e-2
GRAD_COSINE = 0.999
# published peaks of one H100 SXM: memory rate and float32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# predicts a phase's `torch.profiler` trace covers (after one untraced): one,
# since the profiler takes seconds to process the events of each predict on
# cuDNN's FFT route (tens of thousands of kernels a predict)
TRACE_PREDICTS = 1
# launches of one full-width training step and of one predict; FPS's are
# also counted by path (the flagship's 8 clouds of 16384 points take a
# cluster per cloud)
NO_BALL_QUERY = {'ball query grid path': 0, 'ball query walk path': 0}
TRAIN_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                  'scatter_add_rows': 4, 'ball_query': 0, 'sparse_conv': 0,
                  'sparse_conv_wgrad': 0, 'gather_rows_bf16': 0, 'fps cluster path': 1,
                  'fps block path': 0, 'fps masked': 0,
                  **NO_BALL_QUERY}
PREDICT_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                    'scatter_add_rows': 0, 'ball_query': 0, 'sparse_conv': 0,
                    'sparse_conv_wgrad': 0, 'gather_rows_bf16': 0, 'fps cluster path': 1,
                    'fps block path': 0, 'fps masked': 0,
                    **NO_BALL_QUERY}
# one PointRCNN predict. FPS: backbone level 1 is 'random' without a generator
# (a prefix), level 2 runs FPS 4096 -> 1024, level 3 is its prefix; the ROI
# stack runs FPS 512 -> 128 and 128 -> 32, all three on the block path (clouds
# under 8192 points; 400 clouds). Ball query: one launch per SA level,
# 3 in the backbone on the grid path (clouds of 16384, 4096 and 1024 points)
# and 2 in the ROI stack on the walk path (512 and 128). Row gather: xyz and features per
# radius, 3 levels x 2 radii and 2 levels x 1 radius.
POINTRCNN_CFG = 'configs/kitti_models/pointrcnn.yaml'
POINTRCNN_PREDICT_LAUNCHES = {'farthest_point_sample': 3, 'window_select': 0, 'gather_rows': 16,
                              'scatter_add_rows': 0, 'ball_query': 5, 'sparse_conv': 0,
                              'sparse_conv_wgrad': 0, 'gather_rows_bf16': 0,
                              'fps cluster path': 0,
                              'fps block path': 3, 'fps masked': 0, 'ball query grid path': 3,
                              'ball query walk path': 2}
# one SECOND predict: the reorder of the voxel features into slot order, then
# conv_input, conv1, three stages of one strided and two submanifold convs,
# conv_out
SECOND_CFG = 'configs/kitti_models/second_sparse.yaml'
SECOND_PREDICT_LAUNCHES = {'farthest_point_sample': 0, 'window_select': 0, 'gather_rows': 1,
                           'scatter_add_rows': 0, 'ball_query': 0, 'sparse_conv': 12,
                           'sparse_conv_wgrad': 0, 'gather_rows_bf16': 0, 'fps cluster path': 0,
                           'fps block path': 0, 'fps masked': 0, **NO_BALL_QUERY}
# one SECOND train step: the predict's 13, then the backward's data gradient
# through the forward kernel at every layer but conv_input (its input has no
# parameters behind it) and the weight gradient at all twelve
SECOND_TRAIN_LAUNCHES = {**SECOND_PREDICT_LAUNCHES, 'sparse_conv': 12 + 11,
                         'sparse_conv_wgrad': 12}
SECOND_POINTS = 50000
# the grid family (`pdm_ssd.yaml`, `pdm_ssd_large.yaml`) launches none of the
# port's kernels: pillarize is `index_add_`, the rest cuDNN convolutions and
# plain torch; the aux variant's train step launches the flagship's
GRID_CFG = 'configs/kitti_models/pdm_ssd.yaml'
LARGE_CFG = 'configs/kitti_models/pdm_ssd_large.yaml'
AUX_CFG = 'configs/kitti_models/pdm_ssd_aux.yaml'
NO_LAUNCHES = {k: 0 for k in PREDICT_LAUNCHES}
# a predict with TTA_FLIP ['y'] runs the forward twice
TTA_PREDICT_LAUNCHES = {k: 2 * v for k, v in PREDICT_LAUNCHES.items()}
# share of a ladder stage's sites that may fall to its capacity, and the
# least active input voxels per cloud of 40000 slots
SECOND_MAX_DROP = 0.01
SECOND_MIN_VOXELS = 30000


def log(phase: str, msg: str) -> None:
    """A phase's line, ending with the seconds since the script started."""
    print(f'[{phase}] {msg} [{time.perf_counter() - T0:.1f} s]', flush=True)


def device_check() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit('[1 device] FAILED: torch.cuda.is_available() is False')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log('1 device', f'{name}; nvidia-smi: {smi}; torch {torch.__version__} '
        f'cuda {torch.version.cuda}; devices {torch.cuda.device_count()}')
    return name, smi


def median_ms(fn, reps: int) -> float:
    """One call between two events after a synchronize, median over `reps`:
    the device idles while the call's Python runs, so the reading is host
    and device time together (the plain versions' and the `call_ms` reading)."""
    fn()                                        # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# back-to-back launches per timed run: at least 20 and a run of at least
# 1 ms, at most 500 (CUDA queues about a thousand launches before the host
# blocks, and a call here launches at most two kernels)
RUN_MIN, RUN_MAX, RUN_MIN_MS = 20, 500, 1.0
_sleep_cycles_per_ms = None


def sleep_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms on this card, measured once."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms = 20_000_000 / start.elapsed_time(end)
    return _sleep_cycles_per_ms


def device_time(fn, runs: int = 5) -> dict:
    """`ms`: device time per launch of `fn`, median over `runs` runs of n
    back-to-back calls timed by events. A sleep kernel queued first keeps the
    device busy until every call of the run is queued, so the events see the
    launches end to end and none of the host time between them; `ahead` is
    False where a run's sleep ended before its last call was queued (then
    host gaps are in the reading). `host_us`: wall time of one call's
    enqueue on an idle device, median of 11. `call_ms`: `median_ms`, one
    call with host and device time together. The inputs stay in L2 between
    launches, as the model's do (each is made just before its kernel)."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(11):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    host_us = statistics.median(host) * 1e6
    per_ms = sleep_cycles_per_ms()

    def run(n: int) -> tuple[float, bool]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(per_ms * (1.0 + 3e-3 * n * host_us)))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, ahead

    first, _ = run(RUN_MIN)
    n = min(RUN_MAX, max(RUN_MIN, int(np.ceil(RUN_MIN_MS / max(first, 1e-4)))))
    reads = [run(n) for _ in range(runs)]
    return {'ms': statistics.median(t for t, _ in reads), 'host_us': host_us,
            'call_ms': median_ms(fn, runs), 'n': n, 'ahead': all(a for _, a in reads)}


def timing_note(t: dict) -> str:
    return (f'{t["ms"]:.4f} ms device ({t["n"]} launches a run'
            f'{"" if t["ahead"] else ", HOST GAPS"}), {t["host_us"]:.1f} us host, '
            f'{t["call_ms"]:.4f} ms one call')


def tie_heavy_xyz(B: int, N: int, seed: int) -> np.ndarray:
    """Grid-rounded points padded with random duplicates, shuffled, then a
    tail of zero rows: many exact distance ties."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, N, 3), np.float32)
    n_unique, n_dup = N // 3, (3 * N) // 4
    for b in range(B):
        base = np.round(rng.uniform(0, 8, (n_unique, 3))) * 2.0
        cloud = np.concatenate([base, base[rng.randint(0, n_unique, n_dup - n_unique)]])
        rng.shuffle(cloud)
        out[b, :n_dup] = cloud
    return out


def roi_clouds(n_clouds: int, n_points: int, seed: int) -> np.ndarray:
    """Canonical ROI clouds as PointRCNN's head pools them: points of a
    car-sized box around the origin, cyclic repeats where the box held fewer
    points than slots, and every seventh cloud an empty ROI: all origin."""
    rng = np.random.RandomState(seed)
    out = rng.uniform([-2.0, -0.8, -0.8], [2.0, 0.8, 0.8],
                      (n_clouds, n_points, 3)).astype(np.float32)
    for c in range(n_clouds):
        held = int(rng.randint(1, 2 * n_points))
        if held < n_points:
            out[c] = out[c, np.arange(n_points) % held]
    out[::7] = 0.0
    return out


def fps_paths(fps_mod, B: int, N: int, npoint: int) -> dict:
    """The layouts phase 3 holds against the plain version at one shape: the
    plan's own choice, the block path, and a cluster of 16 blocks per cloud
    (launched even where the plan would not take it: where not every cluster
    is resident at once the rest wait, and the result is the same)."""
    S = fps_mod.CLUSTER_SIZES[0]
    return {'plan': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint),
            'block': fps_mod.fps_plan(B, N, npoint, 1, lambda *a: 0, path='block'),
            'cluster': fps_mod.FpsPlan('cluster', S, *fps_mod.cluster_layout(N, S))}


def fps_phase(fps_mod, plain, kitti_points) -> dict:
    # PointRCNN launches FPS three times in a predict: backbone level 2 on the
    # 4096-point prefix of a 16384-point cloud, and the ROI stack on 400
    # canonical clouds of 512 points, then on the 128 points picked there;
    # the last two cases pick more points than a cloud holds
    rng = np.random.RandomState(13)
    cases = [('flagship', torch.from_numpy(kitti_points(8, 16384, 1)[..., :3].copy()), 4096),
             ('tie-heavy', torch.from_numpy(tie_heavy_xyz(8, 16384, 2)), 4096),
             ('odd N', torch.from_numpy(kitti_points(3, 10007, 3)[..., :3].copy()), 2000),
             ('PointRCNN SA level 2',
              torch.from_numpy(kitti_points(4, 16384, 12)[:, :4096, :3].copy()), 1024),
             ('ROI stack level 1', torch.from_numpy(roi_clouds(400, 512, 4)), 128),
             ('ROI stack level 2', None, 32),
             ('npoint > N', torch.from_numpy(rng.rand(2, 300, 3).astype(np.float32) * 9), 500),
             ('npoint > N, large', torch.from_numpy(rng.rand(2, 2500, 3).astype(np.float32) * 9),
              3000)]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy = {S: fps_mod._max_active_clusters(0, S, *fps_mod.cluster_layout(16384, S))
                 for S in fps_mod.CLUSTER_SIZES if fps_mod.cluster_layout(16384, S)}
    log('3 fps', f'{sm} SMs; clusters resident at once, at the flagship cloud\'s layout of each '
        f'size: {occupancy}')
    for name, xyz, npoint in cases:
        if xyz is None:     # the points the previous case picked, in pick order
            xyz = torch.gather(x, 1, got.long()[..., None].expand(-1, -1, 3)).cpu()
        x = xyz.cuda().contiguous()
        want = plain.farthest_point_sample(x, npoint)
        torch.cuda.synchronize()
        paths = fps_paths(fps_mod, x.shape[0], x.shape[1], npoint)
        for label, plan in paths.items():
            got = fps_mod.farthest_point_sample_cuda(x, npoint, plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f'[3 fps] FAILED {name}, {label} {plan}: '
                                 f'{int((got != want).sum())} indices differ')
        log('3 fps', f'{name} {tuple(xyz.shape)} -> {npoint}: ' + ', '.join(
            f'{label} {tuple(plan)}' for label, plan in paths.items())
            + ': each == plain (exact)')
        got = fps_mod.farthest_point_sample_cuda(x, npoint)   # the plan's, for the next case
    # both paths at the flagship shape and at PointRCNN's level 2, in turns
    # (block, cluster, cluster, block), the cluster path as the plan would
    # take it (every cloud's cluster resident at once); then each path's chain
    # floor: its layout with one point a thread, so a step is the reduction alone
    x = cases[0][1].cuda().contiguous()
    res = {}
    for name, xyz, npoint in (cases[0], cases[3]):
        xyz = xyz.cuda().contiguous()
        B, N = xyz.shape[:2]
        paths = {'plan': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint),
                 'block': fps_mod.fps_plan(B, N, npoint, 1, lambda *a: 0, path='block'),
                 'cluster': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint,
                                             'cluster')}
        turns = {'block': [], 'cluster': []}
        for label in ('block', 'cluster', 'cluster', 'block'):
            turns[label].append(device_time(
                lambda: fps_mod.farthest_point_sample_cuda(xyz, npoint, paths[label])))
        res[name] = {label: min(t, key=lambda r: r['ms']) for label, t in turns.items()}
        log('3 fps', f'{name} {tuple(xyz.shape)} -> {npoint}, in turns block, cluster, cluster, '
            'block: ' + '; '.join(
                f'{label} {tuple(paths[label])} ' + ' / '.join(f'{r["ms"]:.4f}' for r in t)
                + f' ms device, {t[0]["host_us"]:.1f} us host' for label, t in turns.items())
            + f'; the plan takes {paths["plan"].path}')
    flag = fps_paths(fps_mod, 8, 16384, 4096)
    floors = {}
    for label, plan in (('block', fps_mod.FpsPlan('block', 1, 1024, 1)),
                        ('cluster', flag['plan']._replace(ppt=1))):
        n = plan.S * plan.threads
        cloud = x[:, :n].contiguous()
        floors[label] = device_time(
            lambda: fps_mod.farthest_point_sample_cuda(cloud, 4096, plan))['ms'] / 4095
        log('3 fps', f'chain floor of the {label} path, {tuple(plan)} on clouds of {n} points, '
            f'4096 picks: {floors[label] * 1e3:.4f} us a step, {floors[label] * 4095:.4f} ms for '
            '4095 steps')
    # the barrier's share: one warp a block, 4 clouds (resident at every S)
    by_size = {}
    for S in fps_mod.CLUSTER_SIZES:
        plan = fps_mod.FpsPlan('cluster', S, 32, 1)
        cloud = x[:4, :S * 32].contiguous()
        by_size[S] = device_time(
            lambda: fps_mod.farthest_point_sample_cuda(cloud, 4096, plan))['ms'] / 4095 * 1e3
    log('3 fps', 'a cluster step with one warp a block, 4 clouds of 32 points a block, us by '
        'cluster size: ' + ', '.join(f'S={S} {v:.4f}' for S, v in by_size.items()))
    if flag['plan'].path != 'cluster':
        raise SystemExit(f'[3 fps] FAILED: the flagship shape plans {flag["plan"]}, not a cluster')
    t = device_time(lambda: fps_mod.farthest_point_sample_cuda(x, 4096))
    plain_ms = median_ms(lambda: plain.farthest_point_sample(x, 4096), 5)
    # bound: the card-wide least time. Bytes: the cloud read once, the
    # indices written once. Operations: every step updates every point's
    # minimum (3 subtractions, 3 products, 2 sums, a minimum and a compare)
    B, N, npoint = 8, 16384, 4096
    t_bytes = (B * N * 12 + B * npoint * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = B * N * (npoint - 1) * 10 / FP32_FLOP_PER_S * 1e3
    block = res['flagship']['block']
    return {'max_abs_err': 0, 'ms': t['ms'], 'host_us': t['host_us'],
            'call_ms': t['call_ms'], 'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations', 'library_ms': None,
            'library_host_us': None, 'block_ms': block['ms'],
            'chain_floor_ms': floors['cluster'] * 4095,
            'block_chain_floor_ms': floors['block'] * 4095,
            'note': f'{timing_note(t)} ({flag["plan"].path} path); block path {block["ms"]:.4f} ms; '
                    f'chain floor {floors["cluster"] * 4095:.4f} ms (block path '
                    f'{floors["block"] * 4095:.4f} ms)'}


def flatten(out: dict) -> dict:
    flat = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            flat[k] = v
        elif isinstance(v, list):
            for i, x in enumerate(v):
                if isinstance(x, torch.Tensor):
                    flat[f'{k}[{i}]'] = x
                elif isinstance(x, dict):
                    flat.update({f'{k}[{i}].{n}': t for n, t in x.items()})
    return flat


ROI_KEYS = ('rois', 'roi_scores', 'roi_labels', 'roi_mask', 'rcnn_cls_preds', 'rcnn_reg_preds')
# a proposal of one run is the other's when every box parameter agrees to this
# (metres, radians); the first stage's boxes agree to about 1e-5
ROI_MATCH_ATOL = 1e-3
# share of the CPU run's proposals that must have a twin in the CUDA run, and
# the most proposals of one cloud that may lack one (measured on an H100: 199
# of 200 have a twin)
ROI_MATCH_SHARE = 0.98
ROI_UNMATCHED_PER_CLOUD = 2


def match_rois(got: dict, want: dict, phase: str) -> tuple[dict, dict, str]:
    """Bring the per-ROI outputs of two runs into one slot order.

    The proposal layer sorts thousands of near-tied scores, so float32
    rounding permutes slots between the runs and moves a few proposals across
    the cut. Both runs must keep the same number of proposals in every cloud.
    Each valid ROI of `want` is paired with the valid ROI of `got` whose box is
    nearest; pairs further apart than ROI_MATCH_ATOL are dropped, at most
    ROI_UNMATCHED_PER_CLOUD of a cloud. Returns both dicts with the ROI keys
    cut to the pairs (clouds side by side along the first axis), and a note
    for the log."""
    n_want = n_pairs = 0
    keys = [k for k in ROI_KEYS if k in want]
    g_rows, w_rows = {k: [] for k in keys}, {k: [] for k in keys}
    kept_g, kept_w = got['roi_mask'].sum(dim=1), want['roi_mask'].sum(dim=1)
    if not torch.equal(kept_g, kept_w):
        raise SystemExit(f'[{phase}] FAILED: proposals kept per cloud {kept_g.tolist()} on CUDA, '
                         f'{kept_w.tolist()} on the CPU')
    for b in range(want['rois'].shape[0]):
        w_slots = want['roi_mask'][b].nonzero()[:, 0]
        g_slots = got['roi_mask'][b].nonzero()[:, 0]
        dist = (want['rois'][b][w_slots][:, None] - got['rois'][b][g_slots][None]).abs().amax(-1)
        near, twin = dist.min(dim=1)
        paired = near <= ROI_MATCH_ATOL
        if len(set(twin[paired].tolist())) != int(paired.sum()):
            raise SystemExit(f'[{phase}] FAILED: two proposals of the CPU run match one of the '
                             'CUDA run')
        if len(w_slots) - int(paired.sum()) > ROI_UNMATCHED_PER_CLOUD:
            raise SystemExit(f'[{phase}] FAILED: cloud {b}: {len(w_slots) - int(paired.sum())} of '
                             f'{len(w_slots)} proposals of the CPU run have no twin in the CUDA '
                             f'run (at most {ROI_UNMATCHED_PER_CLOUD})')
        n_want += len(w_slots)
        n_pairs += int(paired.sum())
        for k in keys:
            w_rows[k].append(want[k][b][w_slots[paired]])
            g_rows[k].append(got[k][b][g_slots[twin[paired]]])
    if n_pairs < ROI_MATCH_SHARE * n_want:
        raise SystemExit(f'[{phase}] FAILED: {n_pairs} of {n_want} proposals of the CPU run have '
                         f'a twin among the {int(got["roi_mask"].sum())} of the CUDA run')
    got = {**got, **{k: torch.cat(v) for k, v in g_rows.items()}}
    want = {**want, **{k: torch.cat(v) for k, v in w_rows.items()}}
    return got, want, (f'; {kept_w.tolist()} proposals kept per cloud in both runs; ROIs matched '
                       f'by box, {n_pairs} of {n_want} have a twin (near-tied proposal scores '
                       'permute slots and move the cut)')


def cuda_vs_cpu_phase(cfg, dispatch, synthetic, phase: str = '4 cuda-vs-cpu',
                      fps_npoint: int | None = 4096, adjust=None, predict: bool = False) -> None:
    """Forward of one model on CUDA against the same model on the CPU at B=2,
    N=4096: float outputs within FWD_RTOL of each output's scale, integer
    and bool outputs (indices, labels, masks) equal. The per-ROI outputs of a
    two-stage model are compared ROI by ROI after `match_rois`. FPS indices
    first, unless `fps_npoint` is None; `adjust` is done to the seeded model
    on both sides; with `predict`, the detections of both runs are matched
    by box and label (`match_detections`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts = torch.from_numpy(synthetic.kitti_points(2, 4096, 4))
    note = ''
    if fps_npoint is not None:
        want_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous(), fps_npoint)
        got_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous().cuda(),
                                                 fps_npoint).cpu()
        if not torch.equal(want_idx, got_idx):
            raise SystemExit(f'[{phase}] FAILED: FPS indices differ between CUDA and CPU')
        note = '; FPS indices equal'
    cpu_net = synthetic.random_model(cfg, 'cpu')
    if adjust is not None:
        adjust(cpu_net)
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want = flatten(cpu_net({'points': pts}))
        got = {k: v.cpu() for k, v in flatten(gpu_net({'points': pts.cuda()})).items()}
    if 'rois' in want:
        got, want, roi_note = match_rois(got, want, phase)
        note += roi_note
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.dtype.is_floating_point:
            scale = max(float(w.abs().max()), 1e-6)
            rel = float((g - w).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
        elif not torch.equal(g, w):
            raise SystemExit(f'[{phase}] FAILED {k}: integer outputs differ')
    if predict:
        note += '; predict: ' + match_detections(
            {k: v.cpu() for k, v in gpu_net.predict({'points': pts.cuda()}).items()},
            cpu_net.predict({'points': pts}), phase)
    log(phase, f'{cfg.MODEL.NAME} B=2 N=4096 forward: {len(want)} outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}), integer and bool outputs '
        f'equal{note}')


def reset_launches(wrappers: dict) -> None:
    """wrappers: kernel entry point -> (wrapper, the name of its counter)."""
    for fn, counter in wrappers.values():
        setattr(fn, counter, 0)


def read_launches(wrappers: dict) -> dict:
    return {name: getattr(fn, counter) for name, (fn, counter) in wrappers.items()}


def check_detections(phase: str, det: dict, B: int, P: int = 100) -> None:
    want = {'pred_boxes': (B, P, 7), 'pred_scores': (B, P), 'pred_labels': (B, P),
            'pred_mask': (B, P)}
    for k, shape in want.items():
        if tuple(det[k].shape) != shape:
            raise SystemExit(f'[{phase}] FAILED {k}: shape {tuple(det[k].shape)} != {shape}')
        if det[k].dtype.is_floating_point and not bool(torch.isfinite(det[k]).all()):
            raise SystemExit(f'[{phase}] FAILED {k}: non-finite values')


def predict_phase(cfg, wrappers, synthetic, card: str, phase: str = '5 predict', B: int = 8,
                  expected: dict = PREDICT_LAUNCHES, N: int = 16384, points=None, adjust=None,
                  profile: bool = False) -> dict:
    """One model's `predict` at full width: shapes, finite values, the
    kernels' launches in the first run, then frames/s and peak memory.
    `points(B, N, seed)` makes the clouds (default `synthetic.kitti_points`),
    `adjust` is done to the seeded model; with `profile`, `torch.profiler`
    reads device time, the busy share and any kernel of cuDNN's FFT route,
    and each convolution stage of a grid model its memory beyond its input."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    if adjust is not None:
        adjust(net)
    pts = torch.from_numpy((points or synthetic.kitti_points)(B, N, 5)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict({'points': pts})
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B, cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    if launches != expected:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected {expected}')
    for _ in range(3):
        net.predict({'points': pts})
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.predict({'points': pts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(phase, f'{cfg.MODEL.NAME} B={B} N={N}: shapes ok, finite, '
        f'{int(det["pred_mask"].sum())} kept boxes, launches {launches}; median '
        f'{med * 1e3:.3f} ms/batch = {B / med:.2f} frames/s (5 runs), peak allocated '
        f'{peak:.3f} GiB on {card}')
    if profile:
        profile_note(phase, net, pts, med)
    return launches


# a convolution stage that allocates more than this beyond its input is named
# with the kernels it ran (cuDNN's workspace)
WORKSPACE_GIB = 1.0


def profile_note(phase: str, net, pts: torch.Tensor, wall_s: float) -> None:
    """Device time per predict, busy share and cuDNN's FFT kernels
    (`tools/profile_predict.trace`); for a grid model, each convolution
    stage's peak memory beyond its input, and the kernels of any stage above
    WORKSPACE_GIB."""
    from pdm_ssd_torch.models.backbones_3d.grid_point_backbone import GridPointBackbone
    from pdm_ssd_torch.tools.profile_predict import grid_conv_stages, peak_extra_gib, trace
    with torch.inference_mode():
        prof = trace(net, {'points': pts}, TRACE_PREDICTS)
        fft = prof['fft_kernels']
        fft_note = ('no FFT-route kernel' if not fft else 'FFT route: ' + '; '.join(
            f'{r["name"]} x{r["calls_per_predict"]:g} {r["ms_per_predict"]:.3f} ms'
            for r in fft))
        log(phase, f'device {prof["device_ms_per_predict"]:.3f} ms per predict '
            f'({prof["device_activities_per_predict"]:.0f} activities), busy '
            f'{prof["device_ms_per_predict"] / (wall_s * 1e3):.3f}; top kernels: '
            + '; '.join(f'{r["name"][:60]} {r["ms_per_predict"]:.3f} ms'
                        for r in prof['top_kernels'][:5]) + f'; {fft_note}')
        if not isinstance(net.backbone_3d, GridPointBackbone):
            return
        stages, _ = grid_conv_stages(net, pts)
        peaks = {name: peak_extra_gib(fn) for name, fn in stages}
        log(phase, 'peak GiB beyond the input per convolution stage: ' + ', '.join(
            f'{k} {v:.3f}' for k, v in peaks.items()))
        for name, fn in stages:
            if peaks[name] > WORKSPACE_GIB:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    fn()
                    torch.cuda.synchronize()
                names = sorted({e.key[:80] for e in p.key_averages()
                                if e.self_device_time_total > 0})
                log(phase, f'{name} allocates {peaks[name]:.3f} GiB: kernels {names}')


def shipped_predict_phase(cfg, synthetic, B: int = 4) -> None:
    """`pointrcnn.yaml` as shipped: its two FP modules stop one level short,
    so the heads read the raw 1-channel input features. One predict: shapes
    and finite values."""
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    width = net.backbone_3d.num_point_features
    det = net.predict({'points': torch.from_numpy(synthetic.kitti_points(B, 16384, 5)).cuda()})
    torch.cuda.synchronize()
    check_detections('11 pointrcnn predict', det, B)
    log('11 pointrcnn predict', f'the file as shipped (heads on {width}-channel features) '
        f'B={B} N=16384: shapes ok, finite, {int(det["pred_mask"].sum())} kept boxes')


def sa_level_specs(cfg) -> list:
    """(name, N, M, radii, nsamples, payload width, branch slices, cap) of the
    flagship's SA levels as `SAGroupMLP` calls the grouping: level 1 groups
    the raw intensity (every branch reads the one channel), later levels a
    payload of the branches' first-layer widths side by side."""
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    specs, n_in = [], 16384
    for k, m in enumerate(sa.NPOINTS):
        h1 = [int(mlp[0]) for mlp in sa.MLPS[k]]
        if k == 0:
            width, slices = 1, [(0, 1)] * len(h1)
        else:
            offs = np.concatenate([[0], np.cumsum(h1)]).tolist()
            width, slices = offs[-1], [(offs[i], offs[i + 1]) for i in range(len(h1))]
        specs.append((f'SA level {k + 1}', n_in, m, list(sa.RADIUS[k]), list(sa.NSAMPLE[k]),
                      width, slices, int(sa.get('BUCKET_CAP', 32))))
        n_in = m
    return specs


def group_case(name, xyz, new_xyz, radii, nsamples, width, slices, cap, pc_range, seed,
               group, sa_fused, spoil_idx=False, reps=5) -> tuple[dict, dict]:
    """One shape through the three grouping kernels and their plain
    versions. Returns per-kernel dicts of err, ms, plain_ms, library_ms,
    bound_ms summed over the shape's launches (one selection, one gather and
    one scatter-add per branch), and the counts of the plain emulations: the
    selection's walk ('walk') and the scatter-add's runs ('runs')."""
    dev = xyz.device
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    cs = float(max(radii))
    gw = sa_fused.grid_dims(pc_range, cs)
    pc_min = (float(pc_range[0]) - cs, float(pc_range[1]) - cs)
    table = sa_fused.build_slot_table(xyz, cs, gw, cap, pc_min)
    cells = sa_fused.cell_ids(new_xyz, cs, gw, pc_min).to(torch.int32)
    sel_args = (table, cells, gw[0], xyz, new_xyz, radii, nsamples)
    got = group.window_select_cuda(*sel_args)
    torch.cuda.synchronize()
    want = group.window_select_plain(*sel_args)
    torch.cuda.synchronize()
    empty = 0
    for bi, ((g_rel, g_idx, g_hit), (w_rel, w_idx, w_hit)) in enumerate(zip(got, want)):
        if not (torch.equal(g_hit, w_hit) and torch.equal(g_idx.long(), w_idx)
                and torch.equal(g_rel, w_rel)):
            raise SystemExit(f'[6 group] FAILED {name} window_select branch {bi}: '
                             f'{int((g_idx.long() != w_idx).sum())} indices, '
                             f'{int((g_hit != w_hit).sum())} hits, '
                             f'{int((g_rel != w_rel).sum())} rel values differ')
        empty += int((~g_hit).sum())
    # the plain emulation of the compacted walk, which counts its steps
    walk, occupied, steps = group.window_select_walk_plain(*sel_args)
    for g, w in zip(walk, want):
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            raise SystemExit(f'[6 group] FAILED {name} window_select: the walk emulation '
                             'differs from plain')
    sel_t = device_time(lambda: group.window_select_cuda(*sel_args), reps)
    res = {'window_select': {
        'err': 0.0, 'ms': sel_t['ms'], 'host_us': sel_t['host_us'], 'call_ms': sel_t['call_ms'],
        'plain_ms': median_ms(lambda: group.window_select_plain(*sel_args), reps),
        'library_ms': None, 'library_host_us': None,
        'bytes': (table.numel() * 4 + cells.numel() * 4 + xyz.numel() * 4 + new_xyz.numel() * 4
                  + sum(B * M * K * 16 + B * M for K in nsamples))}}
    walked = {'centers': B * M, 'occupied': int(occupied.sum()),
              'occupied_max': int(occupied.max()), 'steps': int(steps.sum()),
              'steps_max': int(steps.max()), 'uncompacted_steps': B * M * -(-9 * cap // 32)}
    counts = {'walk': walked, 'runs': {'rows': 0, 'runs': 0, 'sums': 0, 'atomics': 0}}
    log('6 group', f'{name} window_select: {sel_t["ms"]:.4f} ms device; plain emulation of the '
        f'walk: occupied slots per center {walked["occupied"] / (B * M):.2f} mean, '
        f'{walked["occupied_max"]} max; steps per center {walked["steps"] / (B * M):.3f} mean, '
        f'{walked["steps_max"]} max, against the {-(-9 * cap // 32)} of a walk over the '
        'uncompacted window')

    gen = torch.Generator(device='cpu').manual_seed(seed)
    payload = torch.randn((B, N, width), generator=gen).to(dev)
    zero = {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0,
            'library_ms': 0.0, 'library_host_us': 0.0, 'bytes': 0}
    gather, scatter = dict(zero), dict(zero)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def add(acc: dict, kern: dict, lib: dict) -> None:
        for key in ('ms', 'host_us', 'call_ms'):
            acc[key] += kern[key]
        acc['library_ms'] += lib['ms']
        acc['library_host_us'] += lib['host_us']
    for (rel, idx, hit), (s0, s1), K in zip(got, slices, nsamples):
        C = s1 - s0
        rows = torch.where(hit[..., None], idx, -1).reshape(B, M * K)
        if spoil_idx:   # indices beyond both ends
            rows = rows.clone()
            rows[:, ::7] = N + 3
            rows[:, 3::11] = -5
        rows = rows.contiguous()
        feats = payload[..., s0:s1]
        out = group.gather_rows_cuda(feats, rows)
        torch.cuda.synchronize()
        want_rows = group.gather_rows_plain(feats, rows)
        if not torch.equal(out, want_rows):
            raise SystemExit(f'[6 group] FAILED {name} gather_rows C={C}: '
                             f'{int((out != want_rows).sum())} values differ')
        safe = rows.clamp(0, N - 1).long()[..., None].expand(-1, -1, C)
        g_t = device_time(lambda: group.gather_rows_cuda(feats, rows), reps)
        lib_t = device_time(lambda: torch.gather(feats, 1, safe), reps)
        add(gather, g_t, lib_t)
        gather['plain_ms'] += median_ms(lambda: group.gather_rows_plain(feats, rows), reps)
        g_bytes = B * N * C * 4 + rows.numel() * 4 + out.numel() * 4
        gather['bytes'] += g_bytes
        log('6 group', f'{name} gather_rows (B={B}, R={M * K}, C={C}, row stride {width}, slice '
            f'start {s0}): kernel {timing_note(g_t)}; torch.gather {timing_note(lib_t)}; bound '
            f'{g_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms')

        vals = torch.randn((B, M * K, C), generator=gen).to(dev)
        back = group.scatter_add_rows_cuda(vals, rows, N)
        torch.cuda.synchronize()
        plain_back = group.scatter_add_rows_plain(vals, rows, N)
        exact = group.scatter_add_rows_plain(vals.double().cpu(), rows.cpu(), N)
        mass = group.scatter_add_rows_plain(vals.double().abs().cpu(), rows.cpu(), N)
        count = group.scatter_add_rows_plain(torch.ones((B, M * K, 1), dtype=torch.float64),
                                             rows.cpu(), N)
        # each of a row's `count` float32 additions rounds by at most 2^-24 of
        # the partial sum, itself at most the sum of magnitudes; atomics add
        # in an order that changes from run to run
        tol = 2.0 ** -23 * count * mass + 1e-30
        for label, t in (('kernel', back), ('plain', plain_back)):
            over = (t.double().cpu() - exact).abs() > tol
            if bool(over.any()):
                raise SystemExit(f'[6 group] FAILED {name} scatter_add_rows C={C}: {label} '
                                 f'differs from the float64 sum beyond rounding in '
                                 f'{int(over.sum())} values')
        scatter['err'] = max(scatter['err'], float((back - plain_back).abs().max()))
        flat = torch.where((rows >= 0) & (rows < N),
                           rows.long() + torch.arange(B, device=dev)[:, None] * N, B * N)
        flat = flat.reshape(-1)
        v2 = vals.reshape(-1, C)
        s_t = device_time(lambda: group.scatter_add_rows_cuda(vals, rows, N), reps)
        add(scatter, s_t,
            device_time(lambda: torch.zeros((B * N + 1, C), device=dev).index_add_(0, flat, v2),
                        reps))
        scatter['plain_ms'] += median_ms(lambda: group.scatter_add_rows_plain(vals, rows, N), reps)
        s_bytes = vals.numel() * 4 + rows.numel() * 4 + B * N * C * 4
        scatter['bytes'] += s_bytes
        # rows added, runs of equal indices, sums sent and the atomics they
        # take (one per unit of the row), counted by the plain emulation
        s_plan = group.scatter_plan(B, M * K, C, N, sm_count, vals.data_ptr() % 16)
        n_rows, n_runs, n_sums = group.scatter_runs(rows, N, s_plan.span)
        ran = {'rows': n_rows, 'runs': n_runs, 'sums': n_sums,
               'atomics': n_sums * C * 4 // s_plan.unit}
        for key, v in ran.items():
            counts['runs'][key] += v
        log('6 group', f'{name} scatter_add_rows (B={B}, R={M * K}, C={C}, {s_plan}): plain '
            f'emulation: rows {n_rows}, runs {n_runs}, sums sent {n_sums}, atomics '
            f'{ran["atomics"]} of {s_plan.unit // 4} floats; kernel {timing_note(s_t)}; bound '
            f'{s_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms')
    res['gather_rows'], res['scatter_add_rows'] = gather, scatter
    for r in res.values():
        r['bound_ms'] = r.pop('bytes') / HBM_BYTES_PER_S * 1e3
    log('6 group', f'{name} N={N} M={M} K={list(nsamples)} C={[b - a for a, b in slices]}: '
        f'selection and gather exact ({empty} empty balls), scatter-add within rounding '
        f'(kernel vs plain max |diff| {scatter["err"]:.2e}); kernel device ms / host us / one '
        'call ms, plain ms (one call), library device ms / host us, bound ms: '
        + '; '.join(f'{k} {r["ms"]:.4f}/{r["host_us"]:.1f}/{r["call_ms"]:.4f}, '
                    f'{r["plain_ms"]:.3f}, '
                    + ('-' if r['library_ms'] is None
                       else f'{r["library_ms"]:.4f}/{r["library_host_us"]:.1f}')
                    + f', {r["bound_ms"]:.4f}' for k, r in res.items()))
    return res, counts


def group_phase(cfg, fps_mod, group, sa_fused, synthetic) -> dict:
    """The grouping kernels at the flagship's SA levels and at a ragged shape.
    Returns per-kernel totals over the levels (the launches of one forward)."""
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    bev = (pcr[0], pcr[1], pcr[3], pcr[4])
    pts = torch.from_numpy(synthetic.kitti_points(8, 16384, 6)[..., :3].copy()).cuda()
    order = fps_mod.farthest_point_sample_cuda(pts, 4096).long()
    sampled = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))    # FPS order
    total, emulated = {}, {}
    for k, (name, n_in, m, radii, nsamples, width, slices, cap) in enumerate(sa_level_specs(cfg)):
        xyz = (pts if k == 0 else sampled[:, :n_in]).contiguous()
        new_xyz = sampled[:, :m].contiguous()
        res, counts = group_case(name, xyz, new_xyz, radii, nsamples, width, slices, cap, bev,
                                 20 + k, group, sa_fused)
        for kern, r in res.items():
            lib = None if r['library_ms'] is None else 0.0
            t = total.setdefault(kern, {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0,
                                        'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': lib,
                                        'library_host_us': lib})
            t['err'] = max(t['err'], r['err'])
            for key in ('ms', 'host_us', 'call_ms', 'plain_ms', 'bound_ms'):
                t[key] += r[key]
            if lib is not None:
                t['library_ms'] += r['library_ms']
                t['library_host_us'] += r['library_host_us']
            t.setdefault('level_ms', []).append(r['ms'])
        for key, r in counts.items():    # the selection's walk, the scatter's runs
            acc = emulated.setdefault(key, dict.fromkeys(r, 0))
            for c, v in r.items():
                acc[c] = max(acc[c], v) if c.endswith('_max') else acc[c] + v
    walk, runs = emulated['walk'], emulated['runs']
    sc_ms = total['scatter_add_rows']['level_ms']
    log('6 group', f'flagship levels in total: window_select {total["window_select"]["ms"]:.4f} '
        f'ms device ({total["window_select"]["level_ms"]}), plain emulation of its walk: '
        f'occupied slots per center {walk["occupied"] / walk["centers"]:.2f} mean, '
        f'{walk["occupied_max"]} max, steps per center {walk["steps"] / walk["centers"]:.3f} '
        f'mean, {walk["steps_max"]} max, against the '
        f'{walk["uncompacted_steps"] / walk["centers"]:.0f} of a walk over the uncompacted window; '
        f'scatter_add_rows {total["scatter_add_rows"]["ms"]:.4f} ms device ({sc_ms}; the train '
        f'step\'s 4 launches, levels 2 and 3: {sum(sc_ms[1:]):.4f}), bound '
        f'{total["scatter_add_rows"]["bound_ms"]:.4f}, plain emulation of its runs: rows '
        f'{runs["rows"]}, runs {runs["runs"]}, sums sent {runs["sums"]}, atomics '
        f'{runs["atomics"]}')
    # ragged: odd sizes, a slice of 37 channels that starts off a 16-byte
    # boundary, three radii, cap 20, points and centers outside the range
    rng = np.random.RandomState(9)
    xyz = np.stack([rng.uniform(-2, 74, (3, 3001)), rng.uniform(-43, 43, (3, 3001)),
                    rng.uniform(-3, 1, (3, 3001))], -1).astype(np.float32)
    xyz[:, :1500, :2] = xyz[:, :1500, :2] * 0.1 + 20.0             # a dense patch: full cells
    new_xyz = xyz[:, :333].copy()
    new_xyz[:, :7, 0] = 200.0                                      # centers out of range
    new_xyz[:, 7:15, 2] = 50.0                                     # in range, empty balls
    group_case('ragged', torch.from_numpy(xyz).cuda(), torch.from_numpy(new_xyz).cuda(),
               [0.5, 1.3, 0.9], [5, 70, 3], 37, [(3, 22), (0, 37), (36, 37)], 20, bev, 30,
               group, sa_fused, spoil_idx=True)
    return total


def host_breakdown(group, kernels) -> dict:
    """Host microseconds a call of the parts of `gather_rows_cuda` at SA
    level 1's shape (B=8, R=65536, C=1): mean over 300 calls in a row, the
    device left to run behind (each launch is shorter than its enqueue)."""
    feats = torch.randn((8, 16384, 1), device='cuda')
    rows = torch.randint(0, 16384, (8, 65536), dtype=torch.int32, device='cuda')
    out = torch.empty((8, 65536, 1), device='cuda')
    safe = rows.long()[..., None]
    lib = kernels.load()
    ptr = feats.data_ptr()
    plan = group._gather_plan_on(0, 8, 16384, 65536, 1, 4, 1, ptr % 16)
    args = (ptr, rows.data_ptr(), out.data_ptr(), 8, 16384, 65536, 1, 1, plan.lanes, plan.passes,
            plan.unit, int(plan.wide_index), plan.blocks, kernels.stream(0))

    def enter_exit():
        with kernels.on_device(0):
            pass

    parts = {'wrapper': lambda: group.gather_rows_cuda(feats, rows),
             'torch.gather': lambda: torch.gather(feats, 1, safe),
             'torch.empty': lambda: torch.empty((8, 65536, 1), device=feats.device),
             'plan lookup': lambda: group._gather_plan_on(0, 8, 16384, 65536, 1, 4, 1, ptr % 16),
             'device context': enter_exit, 'stream': lambda: kernels.stream(0),
             'C launch': lambda: lib.gather_rows_launch(*args)}
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            fn()
        res[name] = (time.perf_counter() - t0) / 300 * 1e6
        torch.cuda.synchronize()
    log('6 group', 'host us per call at SA level 1, mean of 300 in a row: '
        + ', '.join(f'{k} {v:.2f}' for k, v in res.items()))
    return res


def window_tests(xyz: torch.Tensor, new_xyz: torch.Tensor, cell: float) -> int:
    """The distance tests a ball query of radius at most `cell` needs on this
    data: for each center, the points in the 3x3 window of BEV cells of side
    `cell` around the center's own cell (the window the TPU kernel reads)."""
    B = xyz.shape[0]
    lo = torch.minimum(xyz[..., :2].amin((0, 1)), new_xyz[..., :2].amin((0, 1)))
    pc = ((xyz[..., :2] - lo) / cell).floor().long()
    cc = ((new_xyz[..., :2] - lo) / cell).floor().long()
    W = int(max(pc[..., 0].max(), cc[..., 0].max())) + 1
    H = int(max(pc[..., 1].max(), cc[..., 1].max())) + 1
    hist = torch.zeros((B, H * W), dtype=torch.long, device=xyz.device)
    hist.scatter_add_(1, pc[..., 1] * W + pc[..., 0], torch.ones_like(pc[..., 0]))
    pad = torch.nn.functional.pad(hist.view(B, H, W), (1, 1, 1, 1))
    window = sum(pad[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3))
    return int(window.reshape(B, -1).gather(1, cc[..., 1] * W + cc[..., 0]).sum())


def ball_query_case(name, xyz, new_xyz, radii, nsamples, bq, plain, feats=None, mask=None,
                    time_it=False):
    """One shape through both ball-query kernel paths, the grid and the walk,
    and the plain version: exact equality of the indices, then of the rows
    gathered by them from `xyz` and from `feats`, each in the layout the model
    hands to `dispatch.grouping_operation` (a contiguous tensor or a channel
    slice of a wider one), against the plain gather. With `time_it` the times
    of both paths (the grid's build and walk apart too) and the terms of the
    bound."""
    from pdm_ssd_torch.ops import dispatch
    xyz_c, new_xyz = xyz.contiguous(), new_xyz.contiguous()
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    plans = {path: bq.ball_query_plan(N, radii, path=path) for path in ('grid', 'walk')}
    chosen = bq.ball_query_plan(N, radii).path
    got = {path: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask, plan=plan)
           for path, plan in plans.items()}
    torch.cuda.synchronize()
    want = [plain.ball_query(r, k, xyz_c, new_xyz, mask=mask) for r, k in zip(radii, nsamples)]
    torch.cuda.synchronize()
    empty = 0
    sources = [('xyz', xyz)] + ([] if feats is None else [('features', feats)])
    for i, (r, w) in enumerate(zip(radii, want)):
        for path in plans:
            g = got[path][i]
            if not torch.equal(g, w):
                raise SystemExit(f'[9 ball query] FAILED {name} r={r}: {path} path: '
                                 f'{int((g != w).sum())} of {g.numel()} indices differ')
        g = got[chosen][i]
        for label, src in sources:
            rows = dispatch.grouping_operation(src, g)
            torch.cuda.synchronize()
            if not torch.equal(rows, plain.grouping_operation(src, w)):
                raise SystemExit(f'[9 ball query] FAILED {name} r={r}: {label} '
                                 f'{tuple(src.shape)} strides {src.stride()} gathered by the '
                                 'kernel differs from the plain gather')
        first_d2 = (torch.gather(xyz_c, 1, w[..., :1].long().expand(-1, -1, 3)) - new_xyz) ** 2
        empty += int((first_d2.sum(-1) >= r * r).sum())      # slot 0 outside the ball: no hit
    layouts = ', '.join(f'{label} C={src.shape[2]} row stride {src.stride(1)}'
                        for label, src in sources)
    log('9 ball query', f'{name} B={B} N={N} M={M} r={list(radii)} K={list(nsamples)}'
        f'{" masked" if mask is not None else ""}: grid and walk paths == plain (exact; the '
        f'plan takes the {chosen} path), gathered rows exact ({layouts}), {empty} empty balls')
    if not time_it:
        return None
    from pdm_ssd_torch.ops import group
    for label, src in sources:        # the row gather at this shape, largest K
        if src.stride(2) != 1 or src.stride(0) != src.shape[1] * src.stride(1):
            src = src.contiguous()    # as `dispatch.grouping_operation` hands it on
        rows = got[chosen][-1].reshape(B, -1).contiguous()
        C = src.shape[2]
        safe = rows.long()[..., None].expand(-1, -1, C)
        g_t = device_time(lambda: group.gather_rows_cuda(src, rows))
        lib_t = device_time(lambda: torch.gather(src, 1, safe))
        log('9 ball query', f'{name} gather_rows of {label} (B={B}, R={rows.shape[1]}, C={C}, row '
            f'stride {src.stride(1)}): kernel {timing_note(g_t)}; torch.gather '
            f'{timing_note(lib_t)}; bound '
            f'{(B * N * C + rows.numel() * (C + 1)) * 4 / HBM_BYTES_PER_S * 1e3:.5f} ms')
    # the walk path's test count: a center's walk ends at the K-th hit of its
    # slowest radius, or at the cloud's end where a ball stays underfull (its
    # last slot then repeats its first). The grid path's: the window's points
    # in point order up to the same hit, from the plain emulation of its walk
    walk = torch.zeros((B, M), dtype=torch.long, device=xyz.device)
    full = torch.ones((B, M), dtype=torch.bool, device=xyz.device)
    for w in want:
        filled = w[..., -1] != w[..., 0]
        walk = torch.maximum(walk, torch.where(filled, w[..., -1].long() + 1, N))
        full &= filled
    emulated, grid_tests = bq.ball_query_grid_plain(radii, nsamples, xyz_c, new_xyz, mask,
                                                    cell=plans['grid'].cell, count_tests=True)
    if not all(torch.equal(e, w) for e, w in zip(emulated, want)):
        raise SystemExit(f'[9 ball query] FAILED {name}: the plain emulation of the grid walk '
                         'differs from the plain version')
    cell = plans['grid'].cell
    grid = bq.build_grid(xyz_c, cell, mask)
    build_t = device_time(lambda: bq.build_grid(xyz_c, cell, mask))
    walk_only_t = device_time(lambda: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask,
                                                         plan=plans['grid'], grid=grid))
    t = {path: device_time(lambda: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask,
                                                      plan=plan))
         for path, plan in plans.items()}
    c = t[chosen]
    return {'ms': c['ms'], 'host_us': c['host_us'], 'call_ms': c['call_ms'],
            'grid_ms': t['grid']['ms'], 'walk_path_ms': t['walk']['ms'],
            'grid_build_ms': build_t['ms'], 'grid_walk_ms': walk_only_t['ms'],
            'plain_ms': median_ms(lambda: [plain.ball_query(r, k, xyz_c, new_xyz, mask=mask)
                                           for r, k in zip(radii, nsamples)], 5),
            'bytes': xyz.numel() * 4 + new_xyz.numel() * 4 + sum(B * M * K * 4 for K in nsamples),
            'window_tests': window_tests(xyz_c, new_xyz, float(max(radii))),
            'walk_tests': int(walk.sum()), 'grid_tests': int(grid_tests.sum()),
            'full': int(full.sum()), 'balls': B * M}


def ball_query_phase(cfg, bq, fps_mod, plain, synthetic) -> dict:
    """Returns the kernel's totals over the backbone's three SA levels at B=4
    (the launches of one backbone forward)."""
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    gen = torch.Generator().manual_seed(10)

    def features(B, N, C):
        return torch.randn((B, N, C), generator=gen).cuda()

    def fps_centers(x, npoint):
        order = fps_mod.farthest_point_sample_cuda(x.contiguous(), npoint).long()
        return torch.gather(x, 1, order[..., None].expand(-1, -1, 3))

    # the levels' inputs as the backbone makes them. Level 1 groups channel
    # slices of the (B, N, 4) cloud around its prefix; level 2 the prefix
    # around FPS picks of it; level 3 those picks around their prefix
    cloud = torch.from_numpy(synthetic.kitti_points(4, 16384, 8)).cuda()
    pts = cloud[..., :3]
    l1 = pts[:, :sa.NPOINTS[0]]
    l2 = fps_centers(l1, sa.NPOINTS[1])
    clouds = [pts, l1, l2, l2[:, :sa.NPOINTS[2]]]
    widths = [sum(mlp[-1] for mlp in level) for level in sa.MLPS]
    feats = [cloud[..., 3:], features(4, sa.NPOINTS[0], widths[0]),
             features(4, sa.NPOINTS[1], widths[1])]
    total = {'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0, 'grid_ms': 0.0,
             'walk_path_ms': 0.0, 'grid_build_ms': 0.0, 'grid_walk_ms': 0.0, 'bytes': 0,
             'window_tests': 0, 'walk_tests': 0, 'grid_tests': 0, 'full': 0, 'balls': 0}
    for k in range(3):
        r = ball_query_case(f'backbone SA level {k + 1}', clouds[k], clouds[k + 1],
                            list(sa.RADIUS[k]), list(sa.NSAMPLE[k]), bq, plain, feats=feats[k],
                            time_it=True)
        if bq.ball_query_plan(clouds[k].shape[1], sa.RADIUS[k]).path != 'grid':
            raise SystemExit(f'[9 ball query] FAILED: backbone SA level {k + 1} does not take '
                             'the grid path')
        log('9 ball query', f'backbone SA level {k + 1}: grid path {r["grid_ms"]:.4f} ms device '
            f'(build {r["grid_build_ms"]:.4f}, walk {r["grid_walk_ms"]:.4f}; {r["grid_tests"]} '
            f'tests walked), walk path {r["walk_path_ms"]:.4f} ms ({r["walk_tests"]} tests); '
            f'{r["window_tests"]} tests in the 3x3 BEV windows')
        for key in total:
            total[key] += r[key]
    # the ROI stack's input: 400 canonical clouds, xyz the first 3 of the 5
    # channels of the pooled block, features of the width `merge_down` gives
    roi = cfg.MODEL.ROI_HEAD
    width = roi.XYZ_UP_LAYER[-1]
    canon = torch.cat([torch.from_numpy(roi_clouds(400, 512, 9)).cuda(),
                       features(400, 512, 2)], dim=-1)[..., :3]
    for k in range(2):
        centers = fps_centers(canon, roi.SA_CONFIG.NPOINTS[k])
        ball_query_case(f'ROI stack level {k + 1}', canon, centers, [roi.SA_CONFIG.RADIUS[k]],
                        [roi.SA_CONFIG.NSAMPLE[k]], bq, plain,
                        feats=features(400, canon.shape[1], width))
        canon, width = centers, roi.SA_CONFIG.MLPS[k][-1]
    ball_query_case('backbone SA level 3', clouds[2], clouds[3], list(sa.RADIUS[2]),
                    list(sa.NSAMPLE[2]), bq, plain,
                    mask=(torch.rand(clouds[2].shape[:2], generator=gen) < 0.7).cuda())
    rng = np.random.RandomState(11)
    xyz = rng.uniform(0, 20, (3, 3001, 3)).astype(np.float32)
    xyz[:, 1500:2100] = xyz[:, :600]                               # duplicated points
    new_xyz = xyz[:, :333].copy()
    new_xyz[:, :9] += 500.0                                        # centers far outside
    ball_query_case('ragged', torch.from_numpy(xyz).cuda(), torch.from_numpy(new_xyz).cuda(),
                    [0.5, 1.3, 0.9], [5, 70, 3], bq, plain, feats=features(3, 3001, 37)[..., 3:22])
    zeros = torch.zeros((8, 512, 3), device='cuda')
    ball_query_case('512 origins', zeros, zeros[:, :128], [roi.SA_CONFIG.RADIUS[0]],
                    [roi.SA_CONFIG.NSAMPLE[0]], bq, plain)
    # the uniform cloud fills no ball of the smaller radius, so every walk runs
    # to the cloud's end; the same points drawn into a box of 2.1 x 2.4 x 2 m
    # fill the balls and time the early exit
    dense = pts * torch.tensor([0.03, 0.03, 0.5], device='cuda')
    d = ball_query_case('backbone SA level 1, dense box', dense, dense[:, :sa.NPOINTS[0]],
                        list(sa.RADIUS[0]), list(sa.NSAMPLE[0]), bq, plain, time_it=True)
    log('9 ball query', f'dense box, level 1: grid path {d["grid_ms"]:.4f} ms device (build '
        f'{d["grid_build_ms"]:.4f}, walk {d["grid_walk_ms"]:.4f}; {d["grid_tests"]} tests '
        f'walked), walk path {d["walk_path_ms"]:.4f} ms ({d["walk_tests"]} tests), plain torch '
        f'{d["plain_ms"]:.3f} ms, {d["full"]} of {d["balls"]} balls full at both radii, 3x3 '
        f'windows {d["window_tests"]}')
    # bound: bytes (xyz and centers read once, indices written once), or the
    # distance tests the function needs on this data, 8 operations each: those
    # of the 3x3 window of radius-sized cells around each center. The tests
    # the grid path walks, and the walk path's over the whole cloud, are
    # reported beside it
    t_bytes = total['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = total['window_tests'] * 8 / FP32_FLOP_PER_S * 1e3
    stats = {'max_abs_err': 0, 'ms': total['ms'], 'host_us': total['host_us'],
             'call_ms': total['call_ms'], 'plain_ms': total['plain_ms'],
             'bound_ms': max(t_bytes, t_ops),
             'bound_by': 'bytes' if t_bytes >= t_ops else 'operations', 'library_ms': None,
             'library_host_us': None,
             'walk_ms': total['grid_tests'] * 8 / FP32_FLOP_PER_S * 1e3,
             'grid_build_ms': total['grid_build_ms'], 'grid_walk_ms': total['grid_walk_ms'],
             'walk_path_ms': total['walk_path_ms'], 'window_tests': total['window_tests'],
             'grid_tests': total['grid_tests'], 'walk_tests': total['walk_tests']}
    log('9 ball query', f'backbone levels at B=4, as the plan takes them (grid): kernel '
        f'{stats["ms"]:.4f} ms device with the grid build ({total["grid_build_ms"]:.4f} build, '
        f'{total["grid_walk_ms"]:.4f} walk), {stats["host_us"]:.1f} us host, '
        f'{stats["call_ms"]:.4f} ms one call; the walk path {total["walk_path_ms"]:.4f} ms; plain '
        f'torch {stats["plain_ms"]:.3f} ms (one call, median of 5), bound {stats["bound_ms"]:.4f} '
        f'ms by {stats["bound_by"]} (bytes {t_bytes:.4f} ms; {total["window_tests"]} tests in the '
        f'3x3 windows {t_ops:.5f} ms); the grid path walks {total["grid_tests"]} tests, '
        f'{stats["walk_ms"]:.5f} ms at the peak rate, the walk path {total["walk_tests"]}; '
        f'{total["full"]} of {total["balls"]} balls full at both radii')
    return stats


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def grads_cuda_vs_cpu_phase(cfg, synthetic) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = synthetic.kitti_batch(2, 4096, 8, seed=4)
    cpu_net = synthetic.random_model(cfg, 'cpu')
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    out = {}
    for key, net, dev in (('cpu', cpu_net, 'cpu'), ('cuda', gpu_net, 'cuda')):
        net.train()
        loss, tb = net.forward_with_loss(to_device(batch, dev))
        loss.backward()
        out[key] = (float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()},
                    {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()})
    (c_loss, c_tb, c_grads), (g_loss, g_tb, g_grads) = out['cpu'], out['cuda']
    if not (np.isfinite(g_loss) and abs(g_loss - c_loss) <= LOSS_RTOL * abs(c_loss)):
        raise SystemExit(f'[7 grads] FAILED: loss {g_loss} on CUDA vs {c_loss} on the CPU')
    for k, v in c_tb.items():
        if abs(g_tb[k] - v) > LOSS_RTOL * max(abs(v), 1.0):
            raise SystemExit(f'[7 grads] FAILED {k}: {g_tb[k]} on CUDA vs {v} on the CPU')
    worst, worst_name = 0.0, ''
    for k, c in c_grads.items():
        g = g_grads[k]
        if not bool(torch.isfinite(g).all()):
            raise SystemExit(f'[7 grads] FAILED {k}: non-finite gradient')
        norm = float(c.norm())
        rel = float((g - c).norm()) / norm if norm > 0 else float(g.norm())
        if rel > worst:
            worst, worst_name = rel, k
        cos = float((g * c).sum() / (g.norm() * c.norm())) if norm > 0 else 1.0
        if not (rel <= GRAD_RTOL and cos >= GRAD_COSINE):
            raise SystemExit(f'[7 grads] FAILED {k}: relative L2 error {rel:.3e} '
                             f'(bound {GRAD_RTOL:g}), cosine {cos:.6f} (bound {GRAD_COSINE})')
    log('7 grads', f'B=2 N=4096, 8 boxes: loss {g_loss:.6f} on CUDA vs {c_loss:.6f} on the CPU; '
        f'{len(c_grads)} gradients agree, worst relative L2 {worst:.3e} at {worst_name} '
        f'(bound {GRAD_RTOL:g}; cosine of every pair at least {GRAD_COSINE})')


def train_phase(cfg, wrappers, synthetic, card: str, phase: str = '8 train',
                expected: dict = TRAIN_LAUNCHES) -> dict:
    """Five steps of `make_train_step` at B=8, N=16384, 8 boxes a cloud:
    finite losses, the last below the first, parameters changed, `expected`
    launches a step, ms per step and peak memory."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, N, M, steps = 8, 16384, 8, 5
    net = synthetic.random_model(cfg, seed=7)          # no device named: the card
    batch = to_device(synthetic.kitti_batch(B, N, M, seed=5), 'cuda')
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics['loss']))
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise SystemExit(f'[{phase}] FAILED: losses {losses}')
    if not losses[-1] < losses[0]:
        raise SystemExit(f'[{phase}] FAILED: the loss did not fall: {losses}')
    want = {k: v * steps for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected {want}')
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in net.parameters())
    if not finite or changed < 0.9 * len(before):
        raise SystemExit(f'[{phase}] FAILED: {changed} of {len(before)} parameter tensors '
                         f'changed, all finite: {finite}')
    med = statistics.median(times)
    log(phase, f'{cfg.MODEL.NAME} B={B} N={N}, {M} boxes per cloud, {steps} steps: losses '
        + ' '.join(f'{x:.4f}' for x in losses)
        + f'; {changed} of {len(before)} parameter tensors changed; launches per step '
        f'{expected}; median {med * 1e3:.3f} ms/step (first {times[0] * 1e3:.1f} ms); '
        f'peak allocated {peak:.3f} GiB on {card}')
    return launches


def second_inputs(cfg, synthetic, B: int, N: int, seed: int, device='cuda') -> dict:
    """A voxelized, map-prepared serving batch of a SECOND config."""
    from pdm_ssd_torch.models import get_host_prepare
    return get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(
        synthetic.voxel_batch(B, N, cfg, seed=seed, device=device))


def sparse_conv_check(name, sc, feats, nbr, w, plan=None, phase: str = '12 sparse conv') -> dict:
    """Kernel (through `plan`, or the plan it builds) and plain version each
    against float64, within the rounding of a float32 sum of K * Cin products
    (each at most 2^-24 of the sum of magnitudes); two kernel runs bit-equal;
    rows with no present tap exactly zero. Returns the taps present and the
    largest kernel-plain difference."""
    B, Vin, Cin = feats.shape
    K = nbr.shape[2]
    got = sc.sparse_conv_cuda(feats, nbr, w, plan)
    torch.cuda.synchronize()
    again = sc.sparse_conv_cuda(feats, nbr, w, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit(f'[{phase}] FAILED {name}: two runs of the kernel differ')
    want = sc.sparse_conv_plain(feats, nbr, w)
    exact = sc.sparse_conv_plain(feats.double(), nbr, w.double())
    mass = sc.sparse_conv_plain(feats.double().abs(), nbr, w.double().abs())
    tol = K * Cin * 2.0 ** -24 * mass + 1e-30
    worst = {}
    for label, t in (('kernel', got), ('plain', want)):
        ratio = (t.double() - exact).abs() / tol
        worst[label] = float(ratio.max())
        if not bool((ratio <= 1.0).all()):
            raise SystemExit(f'[{phase}] FAILED {name}: {label} differs from the float64 '
                             f'evaluation by {worst[label]:.3f} of the rounding bound')
    present = (nbr >= 0) & (nbr < Vin)
    empty = ~present.any(dim=2)
    if bool(got[empty].any()):
        raise SystemExit(f'[{phase}] FAILED {name}: a row with no present tap is not 0')
    return {'present': int(present.sum()), 'empty_rows': int(empty.sum()),
            'err': float((got - want).abs().max()), 'worst': worst}


# most operations the kernel may compute over those of the present taps,
# over the ladder's twelve layers (each weighted by its Cin * Cout)
SPARSE_WORK_LIMIT = 1.6


def sparse_conv_phase(net, inputs, sc, smi: str) -> dict:
    """Returns the kernel's totals over the ladder's twelve layers (the
    launches of one predict), each through the plan its forward built."""
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
    bb = net.backbone_3d
    calls = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.setdefault(name, args))
             for name, m in bb.named_modules() if isinstance(m, SparseConvBNReLU)]
    with torch.inference_mode():
        bb(net.vfe(dict(inputs)))
    for h in hooks:
        h.remove()
    modules = dict(bb.named_modules())
    if len(calls) != 12:
        raise SystemExit(f'[12 sparse conv] FAILED: the ladder has {len(calls)} layers, not 12')
    total = {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0, 'library_host_us': 0.0, 'bytes': 0, 'flops': 0, 'walk_bytes': 0,
             'computed_flops': 0, 'plan_ms': 0.0}
    planned = set()        # maps whose plan build is timed: each once, as a forward builds it
    with torch.inference_mode():
        for name, (feats, nbr, _, plan) in calls.items():
            w = modules[name].kernel.detach()
            feats, nbr = feats.contiguous(), nbr.contiguous()
            B, Vin, Cin = feats.shape
            Vout, K = nbr.shape[1], nbr.shape[2]
            Cout = w.shape[1]
            if not isinstance(plan, sc.SparseConvPlan) or plan.vin != Vin:
                raise SystemExit(f'[12 sparse conv] FAILED {name}: the forward handed it no plan '
                                 'of its map')
            r = sparse_conv_check(name, sc, feats, nbr, w, plan)
            computed, present = (int(x) for x in sc.plan_work(plan, nbr))
            if id(plan) not in planned:
                planned.add(id(plan))
                plan_t = device_time(lambda: sc.sparse_conv_plan(nbr, Vin))
                total['plan_ms'] += plan_t['ms']
                plan_note = (f'plan built {plan_t["ms"]:.4f} ms device, '
                             f'{plan_t["host_us"]:.1f} us host')
            else:
                plan_note = 'plan shared with the layer before'
            k_t = device_time(lambda: sc.sparse_conv_cuda(feats, nbr, w, plan))
            ms = k_t['ms']
            plain_ms = median_ms(lambda: sc.sparse_conv_plain(feats, nbr, w), 5)
            pair_t = device_time(lambda: torch.matmul(sc.gather_taps(feats, nbr), w))
            pair_ms = pair_t['ms']
            byts = (feats.numel() + nbr.numel() + w.numel() + B * Vout * Cout) * 4
            flops = 2 * r['present'] * Cin * Cout
            # what the kernel moves: the rows it gathers, its map, its outputs
            # and, per tile, the rows of W of the tile's taps
            walk = (r['present'] * Cin + nbr.numel() + B * Vout * Cout
                    + computed // sc.TILE_ROWS * Cin * Cout) * 4
            total['err'] = max(total['err'], r['err'])
            for key, v in (('ms', ms), ('host_us', k_t['host_us']), ('call_ms', k_t['call_ms']),
                           ('plain_ms', plain_ms), ('library_ms', pair_ms),
                           ('library_host_us', pair_t['host_us']), ('bytes', byts),
                           ('flops', flops), ('walk_bytes', walk),
                           ('computed_flops', 2 * computed * Cin * Cout)):
                total[key] += v
            log('12 sparse conv', f'{name} {Cin}->{Cout} K={K} Vin={Vin} Vout={Vout} B={B}: '
                f'{r["present"] / nbr.numel():.3f} of taps present, {r["empty_rows"]} rows with '
                f'none; taps computed / present {computed / max(present, 1):.3f} ({plan_note}); '
                f'kernel {r["worst"]["kernel"]:.3f} and plain {r["worst"]["plain"]:.3f} of the '
                f'rounding bound from float64, kernel vs plain max |diff| {r["err"]:.2e}, two '
                f'runs bit-equal; ms kernel/plain/gather+matmul {ms:.3f}/{plain_ms:.3f}/'
                f'{pair_ms:.3f}, {2 * computed * Cin * Cout / ms / 1e9:.2f} TFLOP/s computed; '
                f'bound bytes {byts / HBM_BYTES_PER_S * 1e3:.4f} ms, operations '
                f'{flops / FP32_FLOP_PER_S * 1e3:.4f} ms')
        work = total['computed_flops'] / total['flops']
        if work > SPARSE_WORK_LIMIT:
            raise SystemExit(f'[12 sparse conv] FAILED: the kernel computes {work:.3f} times the '
                             f'operations of the present taps, more than {SPARSE_WORK_LIMIT}')
        # the TPU microbench's layer: V = 52224, C = 64, K = 27, its make_maps
        rng = np.random.default_rng(0)
        V, C, K = 52224, 64, 27
        idx = np.clip(np.arange(V)[:, None] + rng.integers(-40, 40, size=(1, K))
                      + rng.integers(-8, 8, size=(V, K)), 0, V - 1)
        idx[rng.random((V, K)) < 0.10] = V
        feats = torch.from_numpy(rng.standard_normal((1, V, C)).astype(np.float32)).cuda()
        nbr = torch.from_numpy(idx.astype(np.int32))[None].cuda()
        w = torch.from_numpy((rng.standard_normal((K * C, C)) * 0.02).astype(np.float32)).cuda()
        plan = sc.sparse_conv_plan(nbr, V)
        r = sparse_conv_check('microbench shape', sc, feats, nbr, w, plan)
        ms = device_time(lambda: sc.sparse_conv_cuda(feats, nbr, w, plan))['ms']
        plain_ms = median_ms(lambda: sc.sparse_conv_plain(feats, nbr, w), 5)
        log('12 sparse conv', f'microbench shape V={V} C={C} K={K}: kernel {r["worst"]["kernel"]:.3f} '
            f'and plain {r["worst"]["plain"]:.3f} of the rounding bound; kernel {ms:.3f} ms, plain '
            f'{plain_ms:.3f} ms, {2 * r["present"] * C * C / ms / 1e9:.2f} TFLOP/s on {smi}')
        # ragged: a row count that is no multiple of the tile, odd widths,
        # entries on both sides of [0, Vin), whole rows absent
        for B, Vin, Vout, K, Cin, Cout in ((3, 1000, 1001, 27, 7, 100), (2, 301, 1, 3, 5, 3),
                                          (2, 5000, 4999, 27, 4, 16)):
            idx = rng.integers(0, Vin, size=(B, Vout, K))
            idx[rng.random((B, Vout, K)) < 0.5] = Vin
            idx[:, ::5] = Vin
            idx[:, -1, 0] = -1
            r = sparse_conv_check(
                'ragged', sc,
                torch.from_numpy(rng.standard_normal((B, Vin, Cin)).astype(np.float32)).cuda(),
                torch.from_numpy(idx.astype(np.int32)).cuda(),
                torch.from_numpy(rng.standard_normal((K * Cin, Cout)).astype(np.float32)).cuda())
            log('12 sparse conv', f'ragged B={B} Vin={Vin} Vout={Vout} K={K} {Cin}->{Cout}: within '
                f'the rounding bound ({r["worst"]["kernel"]:.3f}), {r["empty_rows"]} rows with no '
                'present tap exactly 0, two runs bit-equal')
    t_bytes = total['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = total['flops'] / FP32_FLOP_PER_S * 1e3
    stats = {'max_abs_err': total['err'], 'ms': total['ms'], 'host_us': total['host_us'],
             'call_ms': total['call_ms'], 'plain_ms': total['plain_ms'],
             'bound_ms': max(t_bytes, t_ops),
             'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
             'library_ms': total['library_ms'], 'library_host_us': total['library_host_us'],
             'walk_ms': total['walk_bytes'] / HBM_BYTES_PER_S * 1e3, 'plan_ms': total['plan_ms'],
             'work_ratio': total['computed_flops'] / total['flops']}
    log('12 sparse conv', f'twelve layers at B=4: kernel {stats["ms"]:.3f} ms device, '
        f'{stats["host_us"]:.1f} us host, {stats["call_ms"]:.3f} ms one call each; the 8 plans '
        f'{stats["plan_ms"]:.4f} ms device; operations computed / present '
        f'{stats["work_ratio"]:.3f} ({total["computed_flops"] / 1e9:.2f} of '
        f'{total["flops"] / 1e9:.2f} GFLOP, {total["computed_flops"] / stats["ms"] / 1e9:.2f} '
        f'TFLOP/s computed); plain torch '
        f'{stats["plain_ms"]:.3f} ms (one call), gather + torch.matmul (two calls, no single '
        f'PyTorch call computes the function) {stats["library_ms"]:.3f} ms device, bound '
        f'{stats["bound_ms"]:.4f} ms by {stats["bound_by"]} (bytes {t_bytes:.4f} ms, '
        f'{total["flops"] / 1e9:.2f} GFLOP of present taps {t_ops:.4f} ms); the rows the kernel '
        f'gathers, its maps, outputs and per-tile weights are {stats["walk_ms"]:.4f} ms of bytes')
    return stats


def gather_bf16_phase(inputs, group, smi: str) -> dict:
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((1, 52000, 96)).astype(np.float32)).cuda() \
        .to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 52000, size=(1, 52000)).astype(np.int32)).cuda()
    got = group.gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    want = group.gather_rows_plain(table, idx)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise SystemExit('[13 bf16 gather] FAILED: (52000, 96) bf16 rows differ from the plain '
                         'gather')
    repeats = 52000 - int(torch.unique(idx).numel())
    feats = inputs['voxels'][:, :, 0, :].contiguous()            # (4, 40000, 4) float32
    perm = inputs['sp_perm1']
    if not torch.equal(group.gather_rows_cuda(feats, perm), group.gather_rows_plain(feats, perm)):
        raise SystemExit('[13 bf16 gather] FAILED: the sp_perm1 reorder differs from the plain '
                         'gather')
    long_idx = idx[0].long()
    k_t = device_time(lambda: group.gather_rows_cuda(table, idx))
    lib_t = device_time(lambda: torch.index_select(table[0], 0, long_idx))
    stats = {'max_abs_err': err, 'ms': k_t['ms'], 'host_us': k_t['host_us'],
             'call_ms': k_t['call_ms'],
             'plain_ms': median_ms(lambda: group.gather_rows_plain(table, idx), 5),
             'library_ms': lib_t['ms'], 'library_host_us': lib_t['host_us'],
             'bound_ms': (2 * table.numel() * 2 + idx.numel() * 4) / HBM_BYTES_PER_S * 1e3,
             'bound_by': 'bytes'}
    perm_t = device_time(lambda: group.gather_rows_cuda(feats, perm))
    perm_lib = device_time(lambda: torch.gather(
        feats, 1, perm.long().clamp(0, feats.shape[1] - 1)[..., None].expand(-1, -1, 4)))
    log('13 bf16 gather', f'(52000, 96) bf16, {repeats} repeated indices: kernel == plain '
        f'(exact, max |diff| {err:g}); kernel {timing_note(k_t)}; torch.index_select '
        f'{timing_note(lib_t)}; plain torch {stats["plain_ms"]:.4f} ms (one call); bound '
        f'{stats["bound_ms"]:.5f} ms by bytes; the sp_perm1 reorder {tuple(feats.shape)} float32: '
        f'exact, kernel {timing_note(perm_t)}; torch.gather {timing_note(perm_lib)} on {smi}')
    return stats


def match_detections(got: dict, want: dict, phase: str) -> str:
    """Kept boxes of two runs, matched by box and label, held as the ROIs of
    phase 10 are: near-tied scores permute slots, so both runs must keep the
    same number of boxes in every cloud, each box of the CPU run is paired
    with the nearest of the CUDA run, at least ROI_MATCH_SHARE of them must
    have a twin within ROI_MATCH_ATOL with the same label, and at most
    ROI_UNMATCHED_PER_CLOUD of a cloud may lack one."""
    kept_g, kept_w = got['pred_mask'].sum(dim=1), want['pred_mask'].sum(dim=1)
    if not torch.equal(kept_g, kept_w):
        raise SystemExit(f'[{phase}] FAILED: boxes kept per cloud {kept_g.tolist()} on CUDA, '
                         f'{kept_w.tolist()} on the CPU')
    n_want = n_pairs = 0
    for b in range(want['pred_boxes'].shape[0]):
        w_slots, g_slots = want['pred_mask'][b], got['pred_mask'][b]
        w, g = want['pred_boxes'][b][w_slots], got['pred_boxes'][b][g_slots]
        if len(w) == 0:
            continue
        near, twin = (w[:, None] - g[None]).abs().amax(-1).min(dim=1)
        same = want['pred_labels'][b][w_slots] == got['pred_labels'][b][g_slots][twin]
        paired = (near <= ROI_MATCH_ATOL) & same
        if len(set(twin[paired].tolist())) != int(paired.sum()):
            raise SystemExit(f'[{phase}] FAILED: two boxes of the CPU run match one of the CUDA '
                             'run')
        if len(w) - int(paired.sum()) > ROI_UNMATCHED_PER_CLOUD:
            raise SystemExit(f'[{phase}] FAILED: cloud {b}: {len(w) - int(paired.sum())} of '
                             f'{len(w)} boxes of the CPU run have no twin in the CUDA run (at '
                             f'most {ROI_UNMATCHED_PER_CLOUD})')
        n_want += len(w)
        n_pairs += int(paired.sum())
    if n_want == 0 or n_pairs < ROI_MATCH_SHARE * n_want:
        raise SystemExit(f'[{phase}] FAILED: {n_pairs} of {n_want} boxes of the CPU run have a '
                         'twin in the CUDA run')
    return (f'{kept_w.tolist()} boxes kept per cloud in both runs, {n_pairs} of {n_want} have a '
            'twin by box and label')


def second_cuda_vs_cpu_phase(cfg, synthetic) -> None:
    from pdm_ssd_torch.ops.sparse_maps import LADDER_KEYS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '14 second cuda-vs-cpu'
    cpu_in = second_inputs(cfg, synthetic, 2, 600, seed=4, device='cpu')
    gpu_in = second_inputs(cfg, synthetic, 2, 600, seed=4, device='cuda')
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask', *LADDER_KEYS):
        if not torch.equal(gpu_in[k].cpu(), cpu_in[k]):
            raise SystemExit(f'[{phase}] FAILED: {k} built on CUDA differs from the CPU\'s')
    cpu_net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cpu'))
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want = cpu_net(cpu_in)
        got = gpu_net(gpu_in)
    worst = 0.0
    keys = ('voxel_features', 'spatial_features', 'spatial_features_2d', 'anchor_cls_preds',
            'anchor_box_preds', 'anchor_dir_preds')
    for k in keys:
        w, g = want[k], got[k].cpu()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
    note = match_detections({k: v.cpu() for k, v in gpu_net.predict(gpu_in).items()},
                            cpu_net.predict(cpu_in), phase)
    log(phase, f'tiny SECOND B=2: voxelizer and {len(LADDER_KEYS)} map tensors equal, '
        f'{len(keys)} outputs agree, worst max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); '
        f'{note}')


def second_predict_phase(cfg, net, inputs, wrappers, synthetic, card: str) -> dict:
    from pdm_ssd_torch.models import get_host_prepare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '15 second predict'
    B = inputs['voxels'].shape[0]
    caps = [inputs[k].shape[1] for k in ('sp_mask1', 'sp_mask2', 'sp_mask3', 'sp_mask4',
                                         'sp_mask_out')]
    sites = inputs['sp_sites']                                    # (B, 5), on the CPU
    dropped = (sites - torch.tensor(caps)).clamp(min=0)
    log(phase, f'caps {caps}; sites per stage and cloud {sites.tolist()}; dropped '
        f'{dropped.tolist()}')
    if int(sites[:, 0].min()) < SECOND_MIN_VOXELS:
        raise SystemExit(f'[{phase}] FAILED: a cloud fills {int(sites[:, 0].min())} of the '
                         f'{caps[0]} voxel slots, fewer than {SECOND_MIN_VOXELS}')
    if bool((dropped.float() > SECOND_MAX_DROP * sites.float()).any()):
        raise SystemExit(f'[{phase}] FAILED: a stage drops more than {SECOND_MAX_DROP:.0%} of '
                         'its sites')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict(inputs)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B)
    if launches != SECOND_PREDICT_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected '
                         f'{SECOND_PREDICT_LAUNCHES}')
    width = net.backbone_3d.num_bev_features
    if width != 256 or tuple(net.backbone_3d.shapes[4]) != (2, 200, 176):
        raise SystemExit(f'[{phase}] FAILED: BEV width {width}, shape {net.backbone_3d.shapes[4]}')
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    pts = inputs['points']
    proc = synthetic.voxel_processor(cfg)
    from pdm_ssd_torch.ops.voxelize import voxelize_batch

    def from_points() -> tuple[float, float]:
        """Seconds of voxelizer + map build, then of predict, in one pass."""
        t0 = time.perf_counter()
        batch = prepare(voxelize_batch(pts, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                       list(proc.VOXEL_SIZE), int(proc.MAX_POINTS_PER_VOXEL),
                                       int(proc.MAX_NUMBER_OF_VOXELS['test'])))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.predict(batch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    # both parts are timed inside each repetition, so their sum and their
    # difference are of one pass and not of two medians taken apart
    for _ in range(2):
        from_points()
    reps = [from_points() for _ in range(5)]
    prep = statistics.median(r[0] for r in reps)
    prepared = statistics.median(r[1] for r in reps)
    whole = statistics.median(sum(r) for r in reps)
    spread = [min(r[1] for r in reps), max(r[1] for r in reps)]
    log(phase, f'{cfg.MODEL.NAME} as shipped B={B} V={caps[0]} ({SECOND_POINTS} points per '
        f'cloud, BEV input width {width}): shapes ok, finite, {int(det["pred_mask"].sum())} kept '
        f'boxes, launches {launches}; 5 passes, each timed in two parts: voxelizer + map build '
        f'median {prep * 1e3:.3f} ms, predict on the prepared batch median {prepared * 1e3:.3f} '
        f'ms/batch = {B / prepared:.2f} frames/s (least {spread[0] * 1e3:.3f}, most '
        f'{spread[1] * 1e3:.3f} ms), from points (both) median {whole * 1e3:.3f} ms/batch = '
        f'{B / whole:.2f} frames/s; peak allocated {peak:.3f} GiB on {card}')
    return launches


def wgrad_check(name, sc, feats, nbr, dy, plan, phase: str = '27 sparse conv backward') -> dict:
    """`sparse_conv_wgrad_cuda` (through `plan`) and its plain version each
    against float64, within the rounding of a float32 sum of each tap's
    present rows (each term at most 2^-24 of the sum of magnitudes); two
    kernel runs bit-equal; the rows of a tap that no row has exactly zero.
    Returns the taps present, the largest kernel-plain difference and the
    partials' scratch that the wrapper allocated."""
    B, Vin, Cin = feats.shape
    K, Cout = nbr.shape[2], dy.shape[2]
    got = sc.sparse_conv_wgrad_cuda(feats, nbr, dy, plan)
    scratch = sc.sparse_conv_wgrad_cuda.last_scratch_bytes
    torch.cuda.synchronize()
    again = sc.sparse_conv_wgrad_cuda(feats, nbr, dy, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit(f'[{phase}] FAILED {name}: two runs of the weight gradient differ')
    want = sc.sparse_conv_wgrad_plain(feats, nbr, dy)
    exact = sc.sparse_conv_wgrad_plain(feats.double(), nbr, dy.double())
    mass = sc.sparse_conv_wgrad_plain(feats.double().abs(), nbr, dy.double().abs())
    present = (nbr >= 0) & (nbr < Vin)
    rows = present.sum(dim=(0, 1)).double().repeat_interleave(Cin)[:, None]
    tol = rows * 2.0 ** -24 * mass + 1e-30
    worst = {}
    for label, t in (('kernel', got), ('plain', want)):
        ratio = (t.double() - exact).abs() / tol
        worst[label] = float(ratio.max())
        if not bool((ratio <= 1.0).all()):
            raise SystemExit(f'[{phase}] FAILED {name}: the weight gradient\'s {label} differs '
                             f'from the float64 evaluation by {worst[label]:.3f} of the bound')
    absent = ~present.any(dim=(0, 1))
    if bool(got.view(K, Cin, Cout)[absent].any()):
        raise SystemExit(f'[{phase}] FAILED {name}: a tap no row has is not 0')
    return {'present': int(present.sum()), 'absent_taps': int(absent.sum()),
            'err': float((got - want).abs().max()), 'worst': worst, 'scratch_mb': scratch / 1e6}


def sparse_conv_backward_phase(cfg, net, synthetic, sc, smi: str) -> tuple[dict, dict]:
    """Phase 27: the sparse conv's backward on the card against its plain
    versions, at SECOND's twelve layers of a full-width training batch and at
    the TPU microbench's shape. Returns (the data gradient's totals over the
    11 layers a train step runs it at, the weight gradient's over 12)."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
    phase = '27 sparse conv backward'
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    batch = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)(
        synthetic.voxel_train_batch(B, SECOND_POINTS, cfg, 8, seed=5, device='cuda'))
    bb = net.backbone_3d
    calls = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.setdefault(name, args))
             for name, m in bb.named_modules() if isinstance(m, SparseConvBNReLU)]
    with torch.inference_mode():
        bb(net.vfe(dict(batch)))
    for h in hooks:
        h.remove()
    modules = dict(bb.named_modules())
    if len(calls) != 12 or any(len(a) != 6 for a in calls.values()):
        raise SystemExit(f'[{phase}] FAILED: {len(calls)} layers, not all handed a backward map')
    keys = ('ms', 'host_us', 'call_ms', 'plain_ms', 'library_ms', 'library_host_us', 'bytes',
            'flops')
    tot = {'dgrad': dict.fromkeys(keys, 0.0), 'wgrad': dict.fromkeys(keys, 0.0)}
    tot['dgrad']['err'] = tot['wgrad']['err'] = tot['wgrad']['scratch_mb'] = 0.0
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        for name, (feats, nbr, mask, plan, bwd, bplan) in calls.items():
            w = modules[name].kernel.detach()
            feats, nbr, bwd = feats.contiguous(), nbr.contiguous(), bwd.contiguous()
            B, Vin, Cin = feats.shape
            Vout, K = nbr.shape[1], nbr.shape[2]
            Cout = w.shape[1]
            if bwd.shape != (B, Vin, K) or bplan.vin != Vout:
                raise SystemExit(f'[{phase}] FAILED {name}: the backward map is not the '
                                 'transpose of the forward one')
            # an output gradient as a loss gives it: zero at the padding slots
            dy = torch.from_numpy(rng.standard_normal((B, Vout, Cout), np.float32)).cuda()
            dy = torch.where(mask[..., None], dy, 0.0)
            rw = wgrad_check(name, sc, feats, nbr, dy, plan)
            t = device_time(lambda: sc.sparse_conv_wgrad_cuda(feats, nbr, dy, plan))
            lib_t = device_time(lambda: sc.gather_taps(feats, nbr).reshape(-1, K * Cin).t()
                                @ dy.reshape(-1, Cout))
            plain_ms = median_ms(lambda: sc.sparse_conv_wgrad_plain(feats, nbr, dy), 5)
            byts = (feats.numel() + nbr.numel() + dy.numel() + w.numel()) * 4
            flops = 2 * rw['present'] * Cin * Cout
            for key, v in (('ms', t['ms']), ('host_us', t['host_us']), ('call_ms', t['call_ms']),
                           ('plain_ms', plain_ms), ('library_ms', lib_t['ms']),
                           ('library_host_us', lib_t['host_us']), ('bytes', byts),
                           ('flops', flops)):
                tot['wgrad'][key] += v
            tot['wgrad']['err'] = max(tot['wgrad']['err'], rw['err'])
            tot['wgrad']['scratch_mb'] = max(tot['wgrad']['scratch_mb'], rw['scratch_mb'])
            note = (f'weight gradient: kernel {rw["worst"]["kernel"]:.3f} and plain '
                    f'{rw["worst"]["plain"]:.3f} of the rounding bound, two runs bit-equal, '
                    f'{rw["absent_taps"]} taps absent (0), scratch {rw["scratch_mb"]:.3f} MB, '
                    f'{2 * rw["present"] * Cin * Cout / 1e9:.3f} GFLOP; '
                    'ms kernel/plain/gather+matmul '
                    f'{t["ms"]:.4f}/{plain_ms:.3f}/{lib_t["ms"]:.4f}, bound '
                    f'{max(byts / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3:.4f}')
            if name != 'conv_input':      # a train step skips its data gradient
                wf = sc.flip_weight(w, K).contiguous()
                rd = sparse_conv_check(name, sc, dy, bwd, wf, bplan, phase=phase)
                t = device_time(lambda: sc.sparse_conv_cuda(dy, bwd, wf, bplan))
                lib_t = device_time(lambda: torch.matmul(sc.gather_taps(dy, bwd), wf))
                plain_ms = median_ms(lambda: sc.sparse_conv_dgrad_plain(dy, bwd, w), 5)
                byts = (dy.numel() + bwd.numel() + w.numel() + B * Vin * Cin) * 4
                flops = 2 * rd['present'] * Cin * Cout
                for key, v in (('ms', t['ms']), ('host_us', t['host_us']),
                               ('call_ms', t['call_ms']), ('plain_ms', plain_ms),
                               ('library_ms', lib_t['ms']), ('library_host_us', lib_t['host_us']),
                               ('bytes', byts), ('flops', flops)):
                    tot['dgrad'][key] += v
                tot['dgrad']['err'] = max(tot['dgrad']['err'], rd['err'])
                note += (f'; data gradient: kernel {rd["worst"]["kernel"]:.3f} and plain '
                         f'{rd["worst"]["plain"]:.3f} of the bound, bit-equal, '
                         f'{rd["empty_rows"]} rows without taps 0; ms kernel/plain/'
                         f'gather+matmul {t["ms"]:.4f}/{plain_ms:.3f}/{lib_t["ms"]:.4f}, bound '
                         f'{max(byts / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3:.4f}')
            log(phase, f'{name} {Cin}->{Cout} K={K} Vin={Vin} Vout={Vout} B={B}: {note}')
        # the TPU microbench's layer, its map read as its own transpose, one
        # tap absent from every row and every 97th row without taps
        V, C, K = 52224, 64, 27
        idx = np.clip(np.arange(V)[:, None] + rng.integers(-40, 40, size=(1, K))
                      + rng.integers(-8, 8, size=(V, K)), 0, V - 1)
        idx[rng.random((V, K)) < 0.10] = V
        idx[:, 5] = V
        idx[::97] = V
        feats = torch.from_numpy(rng.standard_normal((1, V, C), np.float32)).cuda()
        dy = torch.from_numpy(rng.standard_normal((1, V, C), np.float32)).cuda()
        nbr = torch.from_numpy(idx.astype(np.int32))[None].cuda()
        w = torch.from_numpy((rng.standard_normal((K * C, C)) * 0.02).astype(np.float32)).cuda()
        plan = sc.sparse_conv_plan(nbr, V)
        rw = wgrad_check('microbench shape', sc, feats, nbr, dy, plan)
        wf = sc.flip_weight(w, K).contiguous()
        rd = sparse_conv_check('microbench shape', sc, dy, nbr, wf, plan, phase=phase)
        w_ms = device_time(lambda: sc.sparse_conv_wgrad_cuda(feats, nbr, dy, plan))['ms']
        d_ms = device_time(lambda: sc.sparse_conv_cuda(dy, nbr, wf, plan))['ms']
        log(phase, f'microbench shape V={V} C={C} K={K}: weight gradient '
            f'{rw["worst"]["kernel"]:.3f} of the rounding bound, tap 5 absent and exactly 0, {w_ms:.4f} ms, '
            f'{2 * rw["present"] * C * C / w_ms / 1e9:.2f} TFLOP/s; data gradient '
            f'{rd["worst"]["kernel"]:.3f} of the bound, {rd["empty_rows"]} rows without taps 0, '
            f'{d_ms:.4f} ms; both bit-equal twice, on {smi}')
    out = []
    for kind, n in (('dgrad', 11), ('wgrad', 12)):
        t = tot[kind]
        t_bytes, t_ops = t['bytes'] / HBM_BYTES_PER_S * 1e3, t['flops'] / FP32_FLOP_PER_S * 1e3
        stats = {'max_abs_err': t['err'], 'ms': t['ms'], 'host_us': t['host_us'],
                 'call_ms': t['call_ms'], 'plain_ms': t['plain_ms'],
                 'bound_ms': max(t_bytes, t_ops),
                 'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
                 'library_ms': t['library_ms'], 'library_host_us': t['library_host_us']}
        log(phase, f'{"data" if kind == "dgrad" else "weight"} gradient over the {n} layers of '
            f'a train step at B={B}: kernel {stats["ms"]:.3f} ms device, {stats["host_us"]:.1f} '
            f'us host, {stats["call_ms"]:.3f} ms one call each; plain torch '
            f'{stats["plain_ms"]:.3f} ms; gather + torch.matmul (no single PyTorch call '
            f'computes it) {stats["library_ms"]:.3f} ms; bound {stats["bound_ms"]:.4f} ms by '
            f'{stats["bound_by"]} ({t["flops"] / 1e9:.2f} GFLOP of present taps, '
            f'{t["bytes"] / 1e6:.1f} MB)'
            + (f'; largest scratch {t["scratch_mb"]:.3f} MB' if kind == 'wgrad' else '')
            + f' on {smi}')
        if kind == 'wgrad':
            stats['largest_scratch_mb'] = t['scratch_mb']
        out.append(stats)
    return out[0], out[1]


# the tiny SECOND's training loss and gradients on CUDA against the CPU:
# float32 sums in another order (the kernels, cuDNN's convolutions, GEMMs)
# and BatchNorm on batch statistics, which divides by a channel's own
# deviation, the only differences; relative L2 per parameter tensor
SECOND_GRAD_RTOL = 1e-2


def second_grads_cuda_vs_cpu_phase(cfg, synthetic) -> None:
    """Phase 28: one training forward and backward of the tiny SECOND on a
    voxel training batch (8 boxes a cloud), on CUDA with the kernels and on
    the CPU with the plain versions, the same weights."""
    from pdm_ssd_torch.models import get_host_prepare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '28 second grads'
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    cpu_net = synthetic.random_model(cfg, 'cpu')
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    out = {}
    for dev, net in (('cpu', cpu_net), ('cuda', gpu_net)):
        batch = prepare(synthetic.voxel_train_batch(2, 600, cfg, 8, seed=4, device=dev))
        net.train()
        loss, tb = net.forward_with_loss(batch)
        loss.backward()
        out[dev] = (float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()},
                    {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()})
    (c_loss, c_tb, c_grads), (g_loss, g_tb, g_grads) = out['cpu'], out['cuda']
    for k, v in c_tb.items():
        if not (np.isfinite(g_tb[k]) and abs(g_tb[k] - v) <= LOSS_RTOL * max(abs(v), 1.0)):
            raise SystemExit(f'[{phase}] FAILED {k}: {g_tb[k]} on CUDA vs {v} on the CPU')
    worst, worst_name = 0.0, ''
    for k, c in c_grads.items():
        g = g_grads[k]
        norm = float(c.norm())
        rel = float((g - c).norm()) / norm if norm > 0 else float(g.norm())
        if not (bool(torch.isfinite(g).all()) and rel <= SECOND_GRAD_RTOL):
            raise SystemExit(f'[{phase}] FAILED {k}: relative L2 error {rel:.3e} (bound '
                             f'{SECOND_GRAD_RTOL:g})')
        if rel > worst:
            worst, worst_name = rel, k
    log(phase, f'tiny SECOND B=2, 8 boxes: loss {g_loss:.6f} on CUDA vs {c_loss:.6f} on the CPU '
        f'(the kernels against the plain versions, backward included); {len(c_grads)} '
        f'gradients agree, worst relative L2 {worst:.3e} at {worst_name} (bound '
        f'{SECOND_GRAD_RTOL:g})')


def second_train_phase(cfg, wrappers, synthetic, card: str, phase: str = '29 second train',
                       expected: dict = SECOND_TRAIN_LAUNCHES) -> dict:
    """Phase 29 (and 38 for VoxelNeXt and the focal SECOND): five training
    steps of a config on the sparse ladder as shipped at B =
    BATCH_SIZE_PER_GPU on LiDAR-like clouds with 8 boxes each: ms per step
    with the map build and without it, both timed inside each step's pass,
    peak memory, a finite and falling loss, `expected` launches a step. Where
    B does not fit (cuDNN's float32 FFT route in the BEV backbone), the peak
    that failed is printed and the phase runs at B=2."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    steps = 5

    def run(B: int):
        net = synthetic.random_model(cfg, seed=7)          # no device named: the card
        optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                          total_epochs=1)
        train_step = make_train_step(net, optimizer, prepare)
        raw = synthetic.voxel_train_batch(B, SECOND_POINTS, cfg, 8, seed=5, device='cuda')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wrappers)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = train_step(raw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics['loss']))
        launches = read_launches(wrappers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the map build and the step on a prepared batch, timed apart in one pass
        parts = []
        for _ in range(3):
            t0 = time.perf_counter()
            with torch.no_grad():
                prepared = prepare(raw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train_step(prepared)
            torch.cuda.synchronize()
            parts.append((t1 - t0, time.perf_counter() - t1))
        return B, losses, times, launches, peak, parts

    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    try:
        B, losses, times, launches, peak, parts = run(B)
    except torch.cuda.OutOfMemoryError as err:
        failed = torch.cuda.max_memory_allocated() / 2 ** 30
        log(phase, f'B={B} does not fit: peak allocated {failed:.3f} GiB when it failed ({err}); '
            'running at B=2')
        torch.cuda.empty_cache()
        B, losses, times, launches, peak, parts = run(2)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}')
    want = {k: v * steps for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected {want}')
    med = statistics.median(times)
    build = statistics.median(p[0] for p in parts)
    step = statistics.median(p[1] for p in parts)
    log(phase, f'{cfg.MODEL.NAME} as shipped B={B}, {SECOND_POINTS} points and 8 boxes per '
        f'cloud, {steps} steps: losses ' + ' '.join(f'{x:.4f}' for x in losses)
        + f'; launches per step {expected}; median {med * 1e3:.3f} ms/step with '
        f'the map build (first {times[0] * 1e3:.1f} ms); in 3 more passes timed in two parts: '
        f'map build median {build * 1e3:.3f} ms, step on the prepared batch median '
        f'{step * 1e3:.3f} ms; peak allocated {peak:.3f} GiB on {card}')
    return launches


# the mini-KITTI set of phases 16 and 17: the port's generator's defaults
KITTI_FRAMES = 64
KITTI_DIR = REPO / 'build' / 'chip_smoke_kitti'
# train frames of the two-stage train loops (phases 45 and 50, B=2): 8 steps
# an epoch, which keeps the whole script well inside its time limit (their
# 32 steps an epoch took 58.9 and 138.8 s of a 970 s run on an H100)
TWO_STAGE_LOOP_FRAMES = 16
# frames of the CUDA-vs-CPU eval loop of phase 16
EVAL_CPU_FRAMES = 8


def kitti_cfg(root: Path, num_points: int = 16384, cfg_file: str = CFG):
    """A config as shipped (default the flagship), reading the mini set at
    `root` with `num_points` points a cloud."""
    from pdm_ssd_torch.utils.config import cfg_from_yaml_file
    cfg = cfg_from_yaml_file(str(REPO / cfg_file))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': num_points, 'test': num_points}
    return cfg


def r40_note(ret: dict) -> str:
    return ', '.join(f'{c} 3d/bev R40 mod {ret[f"{c}_3d/moderate_R40"]:.4f}/'
                     f'{ret[f"{c}_bev/moderate_R40"]:.4f}'
                     for c in ('Car', 'Pedestrian', 'Cyclist'))


def check_eval(phase: str, ret: dict) -> None:
    """Recall and every AP R40 entry present and finite."""
    keys = [k for k in ret if k.startswith('recall/') or k.endswith('_R40')]
    if len(keys) < 3 + 3 * 9 or not all(np.isfinite(float(ret[k])) for k in keys):
        raise SystemExit(f'[{phase}] FAILED: recall / AP R40 missing or not finite: '
                         f'{ {k: ret[k] for k in keys} }')


def annos_as_detections(annos: list, class_names: list) -> dict:
    """KITTI det annos of a loop -> the padded layout `match_detections` reads."""
    P = max([len(a['name']) for a in annos] + [1])
    F = len(annos)
    out = {'pred_boxes': torch.zeros(F, P, 7), 'pred_labels': torch.zeros(F, P, dtype=torch.long),
           'pred_mask': torch.zeros(F, P, dtype=torch.bool)}
    for f, a in enumerate(annos):
        n = len(a['name'])
        out['pred_boxes'][f, :n] = torch.from_numpy(np.asarray(a['boxes_lidar'], np.float32))
        out['pred_labels'][f, :n] = torch.tensor([class_names.index(c) + 1 for c in a['name']],
                                                 dtype=torch.long)
        out['pred_mask'][f, :n] = True
    return out


def mini_kitti() -> Path:
    """The mini-KITTI set of the loop phases, generated on first use."""
    from pdm_ssd_torch.tools.make_mini_kitti import make
    if not (KITTI_DIR / 'kitti_infos_val.pkl').exists():
        t0 = time.perf_counter()
        make(KITTI_DIR, frames=KITTI_FRAMES)
        log('16 kitti eval', f'mini-KITTI: {KITTI_FRAMES} frames, 3 classes, generated with its '
            f'infos and GT database in {time.perf_counter() - t0:.1f} s')
    return KITTI_DIR


def non_finite_boxes(annos: list) -> int:
    """Detections of KITTI annos whose box has a non-finite value (an
    exp-coded size can overflow; the evaluator takes them as they are)."""
    return sum(int((~np.isfinite(np.asarray(a['boxes_lidar'], np.float64).reshape(-1, 7)))
                   .any(-1).sum()) for a in annos)


def kitti_eval_phase(wrappers, synthetic, card: str, cfg_file: str = CFG,
                     phase: str = '16 kitti eval', expected: dict = PREDICT_LAUNCHES,
                     adjust=None, cpu_check: bool = True, B: int = 8) -> dict:
    """Phase 16 (and 22 for the grid config, 30 for SECOND): `eval_one_epoch`
    of a config as shipped, seeded weights (`adjust` done to the model), at
    B (8) over the val split, a voxel model's batches given their kernel
    maps on the card (`get_host_prepare`), then, with `cpu_check`, CUDA
    against the CPU at B=2 N=4096 over 8 frames. Returns the launches of the
    eval loop at B."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = mini_kitti()
    tag = Path(cfg_file).stem
    cfg = kitti_cfg(root, cfg_file=cfg_file)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                     workers=0, training=False)
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    if adjust is not None:
        adjust(net)
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / f'eval_b{B}_{tag}',
                         host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG))
    launches = read_launches(wrappers)
    want = {k: v * len(loader) for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over {len(loader)} '
                         f'batches, expected {want}')
    check_eval(phase, ret)
    annos = pickle.loads((root / f'eval_b{B}_{tag}' / 'result.pkl').read_bytes())
    n_det = sum(len(a['name']) for a in annos)
    n_inf = non_finite_boxes(annos)
    log(phase, f'{tag}.yaml as shipped, seeded weights, B={B} over {len(ds)} val frames '
        f'({len(loader)} batches): {n_det} detections ({n_inf} with a non-finite box); '
        f'recall@0.3/0.5/0.7 '
        f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; '
        f'{r40_note(ret)}; predict alone {ret["infer_fps"]:.2f} frames/s, the loop with loading '
        f'{ret["loop_fps"]:.2f} frames/s; launches {launches} on {card}')

    if not cpu_check:
        return launches
    small = kitti_cfg(root, 4096, cfg_file=cfg_file)
    ds, loader, _ = build_dataloader(small.DATA_CONFIG, small.CLASS_NAMES, 2, root_path=root,
                                     workers=0, training=False)
    ds.kitti_infos = ds.kitti_infos[:EVAL_CPU_FRAMES]
    cpu_net = synthetic.random_model(small, 'cpu', seed=7)
    gpu_net = synthetic.random_model(small, 'cuda', seed=7)
    gpu_net.load_state_dict(cpu_net.state_dict())
    annos, rets = {}, {}
    for dev, model in (('cpu', cpu_net), ('cuda', gpu_net)):
        np.random.seed(1)
        rets[dev] = eval_one_epoch(model, loader, ds, small.CLASS_NAMES, device=dev,
                                   result_dir=root / f'eval_{dev}_{tag}')
        annos[dev] = pickle.loads((root / f'eval_{dev}_{tag}' / 'result.pkl').read_bytes())
    note = match_detections(annos_as_detections(annos['cuda'], small.CLASS_NAMES),
                            annos_as_detections(annos['cpu'], small.CLASS_NAMES), phase)
    log(phase, f'B=2 N=4096 over {EVAL_CPU_FRAMES} frames, CUDA vs CPU: {note}; Car 3d R40 mod '
        f'{rets["cuda"]["Car_3d/moderate_R40"]:.4f} on CUDA, '
        f'{rets["cpu"]["Car_3d/moderate_R40"]:.4f} on the CPU')
    return launches


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: a float tensor's bits compared as integers, so a
    NaN equals the same NaN (a box decoded past float32's `exp` limit and
    rotated holds NaN, which `torch.equal` never finds equal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.float32, torch.float64):
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


class StepLog:
    """A logger for `trainer.train_model` at `log_interval=1`: keeps each
    step's learning rate and loss terms, parsed from its line."""

    def __init__(self):
        self.steps = []

    def info(self, msg: str) -> None:
        head, _, terms = msg.partition(' lr ')
        if ' iter ' not in head:
            return
        lr, *rest = terms.split()
        self.steps.append({'loss': float(head.rsplit(' ', 1)[1]), 'lr': float(lr),
                           **{k: float(v) for k, v in (t.split('=') for t in rest)}})

    def summary(self, per_epoch: int) -> str:
        """Each step's loss; each term's largest value and its step, and the
        steps on which it is 0 (an ROI term on a step without a foreground
        ROI); the terms of the step with the largest loss."""
        terms = [k for k in self.steps[0] if k not in ('loss', 'lr')]
        losses = [s['loss'] for s in self.steps]
        top = int(np.argmax(losses))
        peaks = ', '.join(f'{k} {max(s[k] for s in self.steps):.4f} at step '
                          f'{int(np.argmax([s[k] for s in self.steps]))}, 0 on '
                          f'{sum(s[k] == 0 for s in self.steps)}' for k in terms)
        at_top = ', '.join(f'{k} {self.steps[top][k]:.4f}' for k in terms)
        return (f'losses a step ({per_epoch} an epoch): {" ".join(f"{x:.4g}" for x in losses)}; '
                f'each term\'s largest and the steps it is 0 on: {peaks}; the largest step, '
                f'{top} (lr {self.steps[top]["lr"]:.3e}): {at_top}')


def train_loop_phase(wrappers, synthetic, card: str, cfg_file: str = CFG,
                     phase: str = '17 train loop', expected: dict = TRAIN_LAUNCHES,
                     B: int = 8, frames: int | None = None) -> dict:
    """Phase 17 (and 23 for the grid config, 30 for SECOND), at B (8): a
    voxel model's batches are given their kernel maps and transposed maps on
    the card (`get_host_prepare(..., training=True)`); with `frames`, the
    epochs run over the first `frames` train frames only. Returns the
    launches of the two training epochs."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = Path(cfg_file).stem
    cfg = kitti_cfg(mini_kitti(), cfg_file=cfg_file)
    epochs = 2
    train_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    eval_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=KITTI_DIR,
                                     workers=0, training=True, seed=0)
    if frames is not None:
        ds.kitti_infos = ds.kitti_infos[:frames]
    ckpt_dir = KITTI_DIR / f'ckpt_{tag}'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    steps = StepLog()
    losses = trainer.train_model(net, optimizer, sched, loader, 1, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1, host_prepare=train_prepare,
                                 logger=steps, log_interval=1)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if names != ['checkpoint_epoch_1.pth']:
        raise SystemExit(f'[{phase}] FAILED: checkpoints after epoch 1: {names}')
    fresh = synthetic.random_model(cfg, 'cuda', seed=11)
    fresh_opt, _ = trainer.create_train_state(fresh, cfg.OPTIMIZATION, len(loader), epochs)
    start = trainer.resume(ckpt_dir, fresh, fresh_opt)
    same = all(torch.equal(p, q) for p, q in zip(net.parameters(), fresh.parameters())) and all(
        torch.equal(b, c) for b, c in zip(net.buffers(), fresh.buffers())) and all(
        torch.equal(optimizer.optimizer.state[p][m], fresh_opt.optimizer.state[q][m])
        for p, q in zip(net.parameters(), fresh.parameters()) for m in ('exp_avg', 'exp_avg_sq'))
    if start != 1 or fresh_opt.count != optimizer.count or not same:
        raise SystemExit(f'[{phase}] FAILED: resume gave epoch {start}, iteration '
                         f'{fresh_opt.count} (want {optimizer.count}), state equal: {same}')
    losses += trainer.train_model(fresh, fresh_opt, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                  max_ckpt_save_num=1, start_epoch=start,
                                  host_prepare=train_prepare, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    want = {k: v * epochs * len(loader) for k, v in expected.items()}
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth']:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}, checkpoints {names}')
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over '
                         f'{epochs * len(loader)} steps, expected {want}')
    log(phase, f'{tag}.yaml B={B} over {len(ds)} train frames, {epochs} epochs of '
        f'{len(loader)} '
        f'steps (the second after a resume at epoch {start}, iteration '
        f'{fresh_opt.count - len(loader)}, moments and weights equal): mean losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; {seconds:.1f} s with loading; checkpoints '
        f'left {names}; launches {launches} on {card}')
    log(phase, steps.summary(len(loader)))

    reloaded = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(ckpt_dir / names[-1], reloaded)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=KITTI_DIR,
                                       workers=0, training=False)
    np.random.seed(0)
    points = trainer.to_device_batch(next(iter(vloader)), 'cuda', trainer.INPUT_KEYS)
    if eval_prepare is not None:
        points = eval_prepare(points)
    # the PDM neck's index_add_ sums with atomics unless deterministic
    # algorithms are asked for
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fresh.eval()
        with torch.inference_mode():
            want_fwd, got_fwd = flatten(fresh(points)), flatten(reloaded(points))
        want_det = fresh.predict(points)
        again = fresh.predict(points)
        got_det = reloaded.predict(points)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    repeat = all(bit_equal(again[k], want_det[k]) for k in want_det)
    differ = [k for k in want_fwd if not bit_equal(got_fwd[k], want_fwd[k])] + [
        k for k in want_det if not bit_equal(got_det[k], want_det[k])]
    if differ:
        raise SystemExit(f'[{phase}] FAILED: the reloaded model differs from the trained one in '
                         f'{differ} (the trained model repeats its predict bit for bit: {repeat})')
    # whether a non-finite box below comes from the weights or from a decode
    # that overflows: float32's exp overflows above 88.72
    state = {**dict(fresh.named_parameters()), **dict(fresh.named_buffers())}
    not_finite = [k for k, t in state.items()
                  if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    checksum = sum(float(p.detach().double().abs().sum()) for p in fresh.parameters())
    codes = want_fwd.get('anchor_box_preds')
    size_code = 'no anchor head' if codes is None else f'{float(codes[..., 3:6].max()):.4f}'
    np.random.seed(0)
    ret = eval_one_epoch(reloaded, vloader, vds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=KITTI_DIR / f'eval_trained_{tag}', host_prepare=eval_prepare)
    check_eval(phase, ret)
    annos = pickle.loads((KITTI_DIR / f'eval_trained_{tag}' / 'result.pkl').read_bytes())
    log(phase, f'the checkpoint of epoch {epochs} reloaded, on the first val batch: its '
        f'{len(want_fwd)} forward outputs and its predict bit-equal to the trained model\'s '
        f'({int(want_det["pred_mask"].sum())} kept boxes, '
        f'{int((~torch.isfinite(want_det["pred_boxes"]).all(-1) & want_det["pred_mask"]).sum())} '
        f'of them not finite; the trained model repeats its predict '
        f'bit for bit: {repeat}); parameters and buffers not finite: {not_finite[:4]} of '
        f'{len(state)}; sum of |parameters| {checksum!r}; the largest size code on that batch '
        f'{size_code}; its eval over {len(vds)} val frames: '
        f'{sum(len(a["name"]) for a in annos)} detections ({non_finite_boxes(annos)} with a '
        f'non-finite box); recall@0.3/0.5/0.7 '
        f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; '
        f'{r40_note(ret)} (no threshold); predict alone '
        f'{ret["infer_fps"]:.2f} frames/s, with loading {ret["loop_fps"]:.2f} frames/s')
    return launches


BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}


def bench_phase(smi: str) -> None:
    """Phase 18: bench_torch.py as a subprocess, its one JSON line."""
    phase = '18 bench'
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(REPO / 'bench_torch.py')], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise SystemExit(f'[{phase}] FAILED: rc {res.returncode}, stdout {res.stdout!r}, '
                         f'stderr {res.stderr[-2000:]!r}')
    out = json.loads(lines[0])
    if set(out) != BENCH_KEYS or not float(out['value']) > 0:
        raise SystemExit(f'[{phase}] FAILED: {lines[0]}')
    note = res.stderr.strip().splitlines()[-1] if res.stderr.strip() else ''
    log(phase, f'{lines[0]} on {smi} ({time.perf_counter() - t0:.1f} s with start-up; {note})')


def circle_nms_phase(synthetic) -> None:
    """Phase 19: `ops/iou3d.circle_nms` on the card against the CPU on the
    same candidates, slot order and keep mask equal: boxes on a 0.5 m
    lattice with repeated scores (ties, pairs at exactly the radius), and
    the flagship's candidate count at B=8 (800 boxes, PRE 256, POST 100)."""
    from pdm_ssd_torch.ops import iou3d
    rng = np.random.RandomState(9)
    cases = []
    for B, N, pre, post, radius, lattice in ((3, 60, 32, 16, 0.5, True),
                                              (3, 60, 80, 100, 1.0, True),
                                              (8, 800, 256, 100, 0.8, False)):
        boxes = np.zeros((B, N, 7), np.float32)
        if lattice:
            boxes[..., :2] = rng.randint(0, 8, (B, N, 2)) * 0.5
            scores = rng.randint(0, 6, (B, N)).astype(np.float32) / 8
        else:
            boxes[..., :2] = rng.uniform(0, 12, (B, N, 2))
            scores = rng.rand(B, N).astype(np.float32)
        valid = rng.rand(B, N) > 0.2
        args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
        want = iou3d.circle_nms(args[0], args[1], radius, pre, post, args[2])
        got = iou3d.circle_nms(args[0].cuda(), args[1].cuda(), radius, pre, post,
                               args[2].cuda())
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise SystemExit(f'[19 grid cuda-vs-cpu] FAILED: circle_nms at B={B} N={N} '
                             f'PRE {pre} POST {post} differs between CUDA and the CPU')
        cases.append(f'B={B} N={N} PRE {pre} POST {post}: {int(want[1].sum())} kept')
    log('19 grid cuda-vs-cpu', 'circle_nms on CUDA == CPU (slot order and keep mask) at '
        + '; '.join(cases))


def grid_family_phases(wrappers, dispatch, synthetic, smi: str, CfgNode,
                       cfg_from_yaml_file) -> dict:
    """Phases 19 to 26: the rest of the KITTI PDM family. Returns the kernel
    launches of each path, by name."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file), CfgNode())

    gate = synthetic.open_score_gate
    cuda_vs_cpu_phase(synthetic.tiny_grid_cfg(load(GRID_CFG)), dispatch, synthetic,
                      phase='19 grid cuda-vs-cpu', fps_npoint=None, adjust=gate, predict=True)
    circle_nms_phase(synthetic)
    grid = load(GRID_CFG)
    paths = {'grid_predict': predict_phase(grid, wrappers, synthetic, smi, '20 grid predict',
                                           expected=NO_LAUNCHES, adjust=gate, profile=True),
             'grid_train': train_phase(grid, wrappers, synthetic, smi, '21 grid train',
                                       expected=NO_LAUNCHES)}
    # no CUDA-vs-CPU pass here (phase 19 holds the model and phase 19's
    # circle NMS check the NMS): with seeded weights and the heatmap bias at
    # 0, every empty cell of the full-size map scores the same, and float32
    # rounding of cuDNN's sums reorders those exact ties among the top-100
    # candidates (measured: 57 against 58 boxes kept in a frame)
    paths['grid_eval_loop'] = kitti_eval_phase(wrappers, synthetic, smi, GRID_CFG,
                                               '22 grid eval loop', NO_LAUNCHES, adjust=gate,
                                               cpu_check=False)
    paths['grid_train_loop'] = train_loop_phase(wrappers, synthetic, smi, GRID_CFG,
                                                '23 grid train loop', NO_LAUNCHES)
    paths['large_predict'] = predict_phase(
        load(LARGE_CFG), wrappers, synthetic, smi, '24 large predict', B=4,
        expected=NO_LAUNCHES, N=163840, points=synthetic.large_scene_points, adjust=gate,
        profile=True)
    paths['aux_train'] = train_phase(load(AUX_CFG), wrappers, synthetic, smi, '25 aux train')
    tiny = synthetic.tiny_flagship_cfg(load(CFG))
    tiny.MODEL.POST_PROCESSING.TTA_FLIP = ['y']
    cuda_vs_cpu_phase(tiny, dispatch, synthetic, phase='26 tta', fps_npoint=None, adjust=gate,
                      predict=True)
    tta = load(CFG)
    tta.MODEL.POST_PROCESSING.TTA_FLIP = ['y']
    paths['tta_predict'] = predict_phase(tta, wrappers, synthetic, smi, '26 tta',
                                         expected=TTA_PREDICT_LAUNCHES)
    return paths



# phases 31 to 34: the pillar and dense-voxel family of `Detector3D`, which
# launches none of the port's kernels (PillarVFE, the scatter, pillarize and
# the densify are plain torch; the 2D and 3D convolutions cuDNN)
FAMILY = (('pointpillar', 'configs/kitti_models/pointpillar.yaml'),
          ('centerpoint_pillar', 'configs/kitti_models/centerpoint_pillar.yaml'),
          ('pillarnet', 'configs/kitti_models/pillarnet.yaml'),
          ('dense_second', 'configs/kitti_models/second.yaml'))
# points per cloud at full width: LiDAR-like clouds of SECOND_POINTS for the
# voxel models (they fill the 16000 voxel slots), the sampler's 16384 for the
# point models; and at the tiny size of phase 31
FAMILY_POINTS = {'pointpillar': SECOND_POINTS, 'centerpoint_pillar': 16384,
                 'pillarnet': 16384, 'dense_second': SECOND_POINTS}
TINY_POINTS = {'pointpillar': 3000, 'centerpoint_pillar': 16384, 'pillarnet': 16384,
               'dense_second': 3000}
# the batch of phase 32's predict (phase 33 trains at BATCH_SIZE_PER_GPU)
PREDICT_B = {'pointpillar': 8, 'centerpoint_pillar': 8, 'pillarnet': 8, 'dense_second': 4}


def family_batch(name: str, cfg, synthetic, B: int, N: int, seed: int, device,
                 train: bool = False) -> dict:
    """A batch of a family config on `device`: voxelized LiDAR-like clouds
    for a voxel model, uniform KITTI-range points for a point model; with
    `train`, 8 boxes a cloud."""
    if synthetic.voxelizes(cfg):
        if train:
            return synthetic.voxel_train_batch(B, N, cfg, 8, seed=seed, device=device)
        return synthetic.voxel_batch(B, N, cfg, seed=seed, device=device)
    if train:
        return to_device(synthetic.kitti_batch(B, N, 8, seed=seed), device)
    return {'points': torch.from_numpy(synthetic.kitti_points(B, N, seed)).to(device)}


# an attention key's bias shifts every score of a query alike, which the
# softmax cancels: its gradient is 0 in exact arithmetic, rounding alone on
# either device (2e-9 against 660 for the largest on the tiny DSVT, the CPU)
NULL_GRAD_RTOL = 1e-6
# the same holds for a bias that reaches a BatchNorm in training through
# linear maps only, which the batch mean cancels: MPPNet's `up_geometry.out`
# (into `sa_mlp`) and `cross_group`'s value and output biases (into
# `cls_trunk`), and for `cross_group`'s key bias
NULL_GRADS = ('attn.key.bias', 'cross_group.key.bias', 'cross_group.value.bias',
              'cross_group.out.bias', 'up_geometry.out.bias')


def training_cuda_vs_cpu(phase: str, name: str, nets: dict, batches: dict, grad_rtol: float,
                         cosine: float = -1.0, null_grads: tuple = NULL_GRADS) -> tuple:
    """One training forward and backward of one model on the CPU and on CUDA
    (`nets` and `batches` keyed 'cpu' and 'cuda'): every loss term within
    LOSS_RTOL of the CPU's, every gradient finite, within `grad_rtol`
    relative L2 of the CPU's and at a cosine of at least `cosine`; a
    gradient that is 0 in exact arithmetic (a name ending in one of
    `null_grads`) no larger on either device than NULL_GRAD_RTOL times the
    largest gradient's norm. Returns (the CPU's loss terms, CUDA's, the
    worst relative L2, its parameter, the number of gradients)."""
    out = {}
    for dev in ('cpu', 'cuda'):
        net = nets[dev]
        net.train()
        loss, tb = net.forward_with_loss(dict(batches[dev]))
        loss.backward()
        out[dev] = ({k: float(v.detach()) for k, v in tb.items()},
                    {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()})
        net.eval()
    (c_tb, c_grads), (g_tb, g_grads) = out['cpu'], out['cuda']
    for k, v in c_tb.items():
        if not (np.isfinite(g_tb[k]) and abs(g_tb[k] - v) <= LOSS_RTOL * abs(v)):
            raise SystemExit(f'[{phase}] FAILED {name} {k}: {g_tb[k]} on CUDA vs {v} on the CPU')
    worst, worst_k = 0.0, ''
    largest = max(float(c.norm()) for c in c_grads.values())
    for k, c in c_grads.items():
        g = g_grads[k]
        if k.endswith(null_grads):
            if not max(float(c.norm()), float(g.norm())) <= NULL_GRAD_RTOL * largest:
                raise SystemExit(f'[{phase}] FAILED {name} {k}: a null gradient of norm '
                                 f'{float(g.norm()):.3e} on CUDA, {float(c.norm()):.3e} on the '
                                 f'CPU (bound {NULL_GRAD_RTOL:g} * {largest:.3e})')
            continue
        norm = float(c.norm())
        rel = float((g - c).norm()) / norm if norm > 0 else float(g.norm())
        cos = float((g * c).sum() / (g.norm() * c.norm())) if norm > 0 else 1.0
        if not (bool(torch.isfinite(g).all()) and rel <= grad_rtol and cos >= cosine):
            raise SystemExit(f'[{phase}] FAILED {name} {k}: gradient relative L2 {rel:.3e} '
                             f'(bound {grad_rtol:g}), cosine {cos:.6f}')
        if rel > worst:
            worst, worst_k = rel, k
    return c_tb, g_tb, worst, worst_k, len(c_grads)


def family_cuda_vs_cpu_phase(name: str, cfg, synthetic) -> None:
    """Phase 31: the tiny shrink of a family config (`synthetic.TINY_CFGS`)
    on CUDA against the CPU, the classification bias at 0: the batches
    equal, every forward output within FWD_RTOL of its scale, detections
    matched by box and label, every term of the training loss within
    LOSS_RTOL and every gradient within GRAD_RTOL relative L2 (cosine
    GRAD_COSINE)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '31 family cuda-vs-cpu'
    tiny = synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    N = TINY_POINTS[name]
    cpu_in = family_batch(name, tiny, synthetic, 2, N, 4, 'cpu', train=True)
    gpu_in = family_batch(name, tiny, synthetic, 2, N, 4, 'cuda', train=True)
    for k, v in cpu_in.items():
        if not torch.equal(gpu_in[k].cpu(), v):
            raise SystemExit(f'[{phase}] FAILED: {name} {k} made on CUDA differs from the CPU\'s')
    cpu_net = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want, got = flatten(cpu_net(dict(cpu_in))), flatten(gpu_net(dict(gpu_in)))
    worst = 0.0
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        rel = float((got[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {name} {k}: max |diff| / max |cpu| = {rel:.3e}')
    note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(gpu_in)).items()},
                            cpu_net.predict(dict(cpu_in)), phase)
    c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
        phase, name, {'cpu': cpu_net, 'cuda': gpu_net}, {'cpu': cpu_in, 'cuda': gpu_in},
        GRAD_RTOL, GRAD_COSINE)
    log(phase, f'tiny {name} B=2: {len(want)} outputs agree, worst max|diff|/max|cpu| = '
        f'{worst:.3e} (bound {FWD_RTOL:g}); predict: {note}; loss {g_tb["loss"]:.6f} on CUDA vs '
        f'{c_tb["loss"]:.6f} on the CPU; {n} gradients agree, worst relative L2 '
        f'{worst_g:.3e} at {worst_k} (bound {GRAD_RTOL:g})')


def family_predict_phase(name: str, cfg, wrappers, synthetic, card: str) -> dict:
    """Phase 32: `predict` of a family config as shipped at PREDICT_B on
    FAMILY_POINTS points a cloud, the classification bias at 0
    (`measured_predict`)."""
    B, N = PREDICT_B[name], FAMILY_POINTS[name]
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = family_batch(name, cfg, synthetic, B, N, 5, 'cuda')
    filled = (f'{inputs["voxel_mask"].sum(1).tolist()} of {inputs["voxel_mask"].shape[1]} voxel '
              'slots filled' if 'voxel_mask' in inputs else f'N={N}')
    return measured_predict('32 family predict', f'{name} as shipped', cfg, net, inputs, B,
                            filled, wrappers, card)


def measured_predict(phase: str, name: str, cfg, net, inputs: dict, B: int, what: str, wrappers,
                     card: str, P: int | None = None, flops: str = 'convolutions',
                     expected: dict | None = None) -> dict:
    """One model's `predict` on `inputs` (a batch of B described by `what`):
    shapes (P boxes a cloud, default NMS_POST_MAXSIZE), finite values, the
    kernels' launches `expected` (default: none of the port's), frames/s
    (median of 5 after warm-up), peak memory, the GFLOP of the forward's
    `flops` and their rate over the device time, then `torch.profiler`'s
    device time, busy share, cuDNN's FFT-route kernels and top kernels.
    Returns the launches."""
    from torch.utils.flop_counter import FlopCounterMode
    from pdm_ssd_torch.tools.profile_predict import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict(inputs)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B, P or cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    if launches != (expected or NO_LAUNCHES):
        raise SystemExit(f'[{phase}] FAILED {name}: kernel launches {launches}, expected '
                         f'{expected or "none"}')
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        net(dict(inputs))
    gflop = counter.get_total_flops() / 1e9
    for _ in range(3):
        net.predict(inputs)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.predict(inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    with torch.inference_mode():
        prof = trace(net, inputs, TRACE_PREDICTS)
    fft = prof['fft_kernels']
    device_ms = prof['device_ms_per_predict']
    launched = ('no kernel of the port launched' if not expected else
                'launches ' + ', '.join(f'{k} {v}' for k, v in launches.items() if v))
    log(phase, f'{name} B={B} ({what}): shapes ok, finite, '
        f'{int(det["pred_mask"].sum())} kept boxes, {launched}; median '
        f'{med * 1e3:.3f} ms/batch = {B / med:.2f} frames/s (5 runs); device '
        f'{device_ms:.3f} ms per predict, busy {device_ms / (med * 1e3):.3f}; {flops} '
        f'{gflop:.1f} GFLOP a batch, {gflop / device_ms:.2f} TFLOP/s over the device time; '
        f'peak allocated {peak:.3f} GiB; FFT-route kernels: '
        + ('none' if not fft else '; '.join(f'{r["name"][:70]} x{r["calls_per_predict"]:g} '
                                            f'{r["ms_per_predict"]:.3f} ms' for r in fft))
        + '; top kernels: ' + '; '.join(f'{r["name"][:60]} {r["ms_per_predict"]:.3f} ms'
                                         for r in prof['top_kernels'][:5]) + f' on {card}')
    return launches


def family_train_phase(name: str, cfg, wrappers, synthetic, card: str) -> dict:
    """Phase 33: five training steps of a family config as shipped at
    BATCH_SIZE_PER_GPU, 8 boxes a cloud (`measured_train`)."""
    B, N = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU, FAMILY_POINTS[name]
    net = synthetic.random_model(cfg, seed=7)          # no device named: the card
    batch = family_batch(name, cfg, synthetic, B, N, 5, 'cuda', train=True)
    return measured_train('33 family train', f'{name} as shipped', cfg, net, batch,
                          f'B={B} N={N}', wrappers, card)


def measured_train(phase: str, name: str, cfg, net, batch: dict, what: str, wrappers,
                   card: str, expected: dict | None = None, steps: int = 5) -> dict:
    """`steps` (five) `make_train_step` steps of a model on one batch
    (described by `what` and its boxes a cloud): a finite and falling loss,
    parameters changed, the kernels' launches `expected` a step (default:
    none of the port's), ms per step and peak memory. Returns the launches
    of the steps."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(train_step(batch)['loss']))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f'[{phase}] FAILED {name}: losses {losses}')
    want = {k: v * steps for k, v in (expected or NO_LAUNCHES).items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED {name}: kernel launches {launches}, expected {want}')
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    if changed < 0.9 * len(before):
        raise SystemExit(f'[{phase}] FAILED {name}: {changed} of {len(before)} parameter '
                         'tensors changed')
    launched = ('no kernel of the port launched' if not expected else
                'launches ' + ', '.join(f'{k} {v}' for k, v in launches.items() if v))
    boxes = batch['gt_mask'].sum(1).tolist()
    boxes = f'{boxes[0]} boxes' if len(set(boxes)) == 1 else f'{boxes} boxes'
    med = statistics.median(times)
    log(phase, f'{name} {what}, {boxes} per cloud, {steps} steps: losses '
        + ' '.join(f'{x:.4f}' for x in losses) + f'; {changed} of {len(before)} parameter '
        f'tensors changed; {launched}; median '
        f'{med * 1e3:.3f} ms/step (first {times[0] * 1e3:.1f} ms); peak '
        f'allocated {peak:.3f} GiB on {card}')
    return launches


def device_profile(fn) -> tuple:
    """One call of `fn` under `FlopCounterMode`, then the wall time of a
    second and `torch.profiler`'s device time of a third: (GFLOP, wall ms,
    device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return counter.get_total_flops() / 1e9, wall_ms, device_ms


def profiled_train_step(phase: str, name: str, cfg, net, batch: dict, card: str) -> None:
    """`device_profile` of a `make_train_step` step (forward, backward, any
    recomputation and the update): GFLOP, device ms and busy share."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
    gflop, wall_ms, device_ms = device_profile(lambda: train_step(batch))
    log(phase, f'{name}: a step {gflop:.1f} GFLOP, {wall_ms:.3f} ms, device {device_ms:.3f} ms, '
        f'busy {device_ms / wall_ms:.3f}, {gflop / device_ms:.2f} TFLOP/s over the device '
        f'time on {card}')


def family_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 31 to 34. Returns the kernel launches of each path, by name."""
    paths = {}
    for name, cfg_file in FAMILY:
        family_cuda_vs_cpu_phase(name, cfg_from_yaml_file(str(REPO / cfg_file)), synthetic)
    for name, cfg_file in FAMILY:
        paths[f'{name}_predict'] = family_predict_phase(
            name, cfg_from_yaml_file(str(REPO / cfg_file)), wrappers, synthetic, smi)
        torch.cuda.empty_cache()
    for name, cfg_file in FAMILY:
        paths[f'{name}_train'] = family_train_phase(
            name, cfg_from_yaml_file(str(REPO / cfg_file)), wrappers, synthetic, smi)
        torch.cuda.empty_cache()
    for name, cfg_file in FAMILY[:2]:
        B = cfg_from_yaml_file(str(REPO / cfg_file)).OPTIMIZATION.BATCH_SIZE_PER_GPU
        paths[f'{name}_eval_loop'] = kitti_eval_phase(
            wrappers, synthetic, smi, cfg_file, '34 family eval loop', NO_LAUNCHES,
            adjust=synthetic.open_score_gate, cpu_check=False, B=B)
        paths[f'{name}_train_loop'] = train_loop_phase(
            wrappers, synthetic, smi, cfg_file, '34 family train loop', NO_LAUNCHES, B=B)
    return paths

# phases 35 to 40: VoxelNeXt and the focal SECOND, on the sparse ladder's
# kernels; then TTA_FLIP of `Detector3D`
VOXELNEXT_CFG = 'configs/kitti_models/voxelnext.yaml'
FOCAL_CFG = 'configs/kitti_models/second_focal.yaml'
LADDER_MODELS = (('voxelnext', VOXELNEXT_CFG), ('second_focal', FOCAL_CFG))
# one predict of either: the reorder of the voxel features, then 18 sparse
# convs (VoxelNeXt: the ladder's 12, `shared_conv` and the five branches'
# hidden layers; the focal SECOND: 12 plain layers and each focal layer's
# importance conv and conv over its dilated table); a train step adds the
# data gradient of every layer but conv_input and the weight gradient of all
LADDER_PREDICT_LAUNCHES = {**SECOND_PREDICT_LAUNCHES, 'sparse_conv': 18}
LADDER_TRAIN_LAUNCHES = {**SECOND_PREDICT_LAUNCHES, 'sparse_conv': 18 + 17,
                         'sparse_conv_wgrad': 18}
# points per cloud of phase 35's tiny batches (256 voxel slots)
TINY_LADDER_POINTS = 3000


def ladder_cuda_vs_cpu_phase(name: str, cfg, synthetic) -> None:
    """Phase 35: the tiny shrink of VoxelNeXt or the focal SECOND
    (`synthetic.TINY_CFGS`) on CUDA (the kernels) against the CPU (the plain
    versions), the classification bias at 0, on a training batch with 8
    boxes a cloud prepared on each device: every map tensor equal, the
    forward's outputs within FWD_RTOL of scale and its integer and bool
    outputs (the focal activation bits, per stage) equal, detections matched
    by box and label, each loss within LOSS_RTOL and every gradient within
    SECOND_GRAD_RTOL relative L2."""
    from pdm_ssd_torch.models import get_host_prepare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '35 ladder cuda-vs-cpu'
    tiny = synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    prepare = get_host_prepare(tiny.MODEL, tiny.DATA_CONFIG, training=True)
    ins = {dev: prepare(synthetic.voxel_train_batch(2, TINY_LADDER_POINTS, tiny, 8, seed=4,
                                                    device=dev)) for dev in ('cpu', 'cuda')}
    for k, v in ins['cpu'].items():
        if not torch.equal(ins['cuda'][k].cpu(), v):
            raise SystemExit(f'[{phase}] FAILED: {name} {k} built on CUDA differs from the CPU\'s')
    cpu_net = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    outs = {}
    with torch.inference_mode():
        for dev, net in (('cpu', cpu_net), ('cuda', gpu_net)):
            out = net(dict(ins[dev]))
            flat = flatten(out)
            for stage, (x, _, act, _) in out['multi_scale_3d_features_sparse'].items():
                flat[f'{stage} feats'], flat[f'{stage} bits'] = x, act
            x, _, act = out['encoded_sparse_out']
            flat['out feats'], flat['out bits'] = x, act
            outs[dev] = flat
    worst, n_exact = 0.0, 0
    for k, w in outs['cpu'].items():
        g = outs['cuda'][k].cpu()
        if not w.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise SystemExit(f'[{phase}] FAILED {name} {k}: differs between CUDA and the CPU')
            n_exact += 1
            continue
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {name} {k}: max |diff| / max |cpu| = {rel:.3e}')
    note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(ins['cuda'])).items()},
                            cpu_net.predict(dict(ins['cpu'])), phase)
    c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
        phase, name, {'cpu': cpu_net, 'cuda': gpu_net}, ins, SECOND_GRAD_RTOL)
    log(phase, f'tiny {name} B=2, 8 boxes: {len(ins["cpu"])} batch and map tensors equal; '
        f'{len(outs["cpu"]) - n_exact} float outputs agree, worst max|diff|/max|cpu| = '
        f'{worst:.3e} (bound {FWD_RTOL:g}), {n_exact} integer and bool outputs (activation '
        f'bits included) equal; predict: {note}; losses on CUDA / CPU '
        + ', '.join(f'{k} {g_tb[k]:.6f} / {v:.6f}' for k, v in c_tb.items())
        + f'; {n} gradients agree, worst relative L2 {worst_g:.3e} at {worst_k} '
        f'(bound {SECOND_GRAD_RTOL:g})')


def layer_capture(net, batch: dict, kinds: tuple, names=None) -> dict:
    """The arguments of each call of the modules of `kinds` (named in
    `names`, or all) in one eval-mode forward of `net` on `batch`."""
    calls = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.setdefault(name, args))
             for name, m in net.named_modules()
             if isinstance(m, kinds) and (names is None or name in names)]
    try:
        with torch.inference_mode():
            net(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return calls


def layer_kernels(phase: str, name: str, sc, feats, nbr, w, plan, bwd, bplan, mask, rng) -> dict:
    """One layer's three products on the card against their plain versions
    and float64 (`sparse_conv_check`, `wgrad_check`: within float32 rounding,
    two runs bit-equal, empty rows and absent taps 0): the forward, the data
    gradient through the transposed map `bwd` (W flipped) and the weight
    gradient, for a seeded output gradient zero outside `mask`. Returns each
    product's device ms, plain ms, bound ms, and the largest kernel-plain
    difference."""
    feats, nbr, bwd = feats.contiguous(), nbr.contiguous(), bwd.contiguous()
    B, Vin, Cin = feats.shape
    Vout, K = nbr.shape[1], nbr.shape[2]
    Cout = w.shape[1]
    rf = sparse_conv_check(name, sc, feats, nbr, w, plan, phase=phase)
    dy = torch.from_numpy(rng.standard_normal((B, Vout, Cout), np.float32)).cuda()
    if mask is not None:
        dy = torch.where(mask[..., None], dy, 0.0)
    rw = wgrad_check(name, sc, feats, nbr, dy, plan, phase=phase)
    wf = sc.flip_weight(w, K).contiguous()
    rd = sparse_conv_check(f'{name} data gradient', sc, dy, bwd, wf, bplan, phase=phase)

    def bound(byts, present):
        return max(byts / HBM_BYTES_PER_S, 2 * present * Cin * Cout / FP32_FLOP_PER_S) * 1e3

    out = {
        'fwd': (device_time(lambda: sc.sparse_conv_cuda(feats, nbr, w, plan))['ms'],
                median_ms(lambda: sc.sparse_conv_plain(feats, nbr, w), 3),
                bound((feats.numel() + nbr.numel() + w.numel() + B * Vout * Cout) * 4,
                      rf['present']), rf['err']),
        'dgrad': (device_time(lambda: sc.sparse_conv_cuda(dy, bwd, wf, bplan))['ms'],
                  median_ms(lambda: sc.sparse_conv_dgrad_plain(dy, bwd, w), 3),
                  bound((dy.numel() + bwd.numel() + w.numel() + B * Vin * Cin) * 4,
                        rd['present']), rd['err']),
        'wgrad': (device_time(lambda: sc.sparse_conv_wgrad_cuda(feats, nbr, dy, plan))['ms'],
                  median_ms(lambda: sc.sparse_conv_wgrad_plain(feats, nbr, dy), 3),
                  bound((feats.numel() + nbr.numel() + dy.numel() + w.numel()) * 4,
                        rw['present']), rw['err'])}
    log(phase, f'{name} {Cin}->{Cout} K={K} Vin={Vin} Vout={Vout} B={B}: '
        f'{rf["present"] / nbr.numel():.3f} of taps present; of the float64 rounding bound '
        f'forward {rf["worst"]["kernel"]:.3f}, data gradient {rd["worst"]["kernel"]:.3f}, '
        f'weight gradient {rw["worst"]["kernel"]:.3f} (plain {rf["worst"]["plain"]:.3f}, '
        f'{rd["worst"]["plain"]:.3f}, {rw["worst"]["plain"]:.3f}); each two runs bit-equal; '
        f'weight gradient scratch {rw["scratch_mb"]:.3f} MB; ms kernel / plain / bound: '
        + '; '.join(f'{k} {v[0]:.4f} / {v[1]:.3f} / {v[2]:.4f}' for k, v in out.items()))
    out['scratch_mb'] = rw['scratch_mb']
    return out


def ladder_kernels_phase(sc, synthetic, smi: str, cfg_from_yaml_file) -> None:
    """Phase 36: `sparse_conv`, its data gradient and `sparse_conv_wgrad` at
    the shapes only these models give them, each against its plain version
    and float64: VoxelNeXt's six 9-tap BEV layers (`shared_conv` 128 -> 64,
    the branches' 64 -> 64) on a serving batch as shipped (B=4, 40000 voxel
    slots, 35000 BEV slots), and the focal SECOND's three importance convs
    (27 output channels), three convs over the dilated tables and the three
    down convs that read them (64000 and 120000 slots) on a training batch as
    shipped (B=4, 16000 voxel slots). Prints each layer's and each group's
    device ms, plain ms and bound, and the weight gradient's largest
    scratch."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone_focal import SparseTapDense
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '36 ladder kernels'
    rng = np.random.default_rng(6)
    groups = {}
    cfg = cfg_from_yaml_file(str(REPO / VOXELNEXT_CFG))
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    batch = second_inputs(cfg, synthetic, 4, SECOND_POINTS, seed=5)
    head = {n for n, m in net.named_modules()
            if n.startswith('dense_head.') and isinstance(m, SparseConvBNReLU)}
    calls = layer_capture(net, batch, (SparseConvBNReLU,), head)
    if len(calls) != 6:
        raise SystemExit(f'[{phase}] FAILED: VoxelNeXt\'s head ran {len(calls)} sparse layers, '
                         'not 6')
    modules = dict(net.named_modules())
    with torch.inference_mode():
        groups['voxelnext BEV layers'] = [
            layer_kernels(phase, f'voxelnext {n}', sc, f, nbr, modules[n].kernel.detach(), plan,
                          bwd, bplan, mask, rng)
            for n, (f, nbr, mask, plan, bwd, bplan) in calls.items()]
    del net, batch, calls, modules
    torch.cuda.empty_cache()
    cfg = cfg_from_yaml_file(str(REPO / FOCAL_CFG))
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    batch = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)(
        synthetic.voxel_train_batch(B, SECOND_POINTS, cfg, 8, seed=5, device='cuda'))
    fills = [batch[f'fl_emask{s}'].sum(1).tolist() for s in (1, 2, 3)]
    bb = net.slots['backbone_3d']
    kinds = {f'{bb}.focal{s}.conv_imp': 'conv_imp' for s in (1, 2, 3)}
    kinds.update({f'{bb}.focal{s}.conv': 'conv' for s in (1, 2, 3)})
    kinds.update({f'{bb}.down{s}': 'down' for s in (2, 3, 4)})
    calls = layer_capture(net, batch, (SparseConvBNReLU, SparseTapDense), set(kinds))
    if len(calls) != 9:
        raise SystemExit(f'[{phase}] FAILED: the focal ladder ran {len(calls)} of its 9 layers '
                         'over dilated tables')
    modules = dict(net.named_modules())
    with torch.inference_mode():
        for kind in ('conv_imp', 'conv', 'down'):
            rows = []
            for n, args in calls.items():
                if kinds[n] != kind:
                    continue
                if kind == 'conv_imp':
                    (f, nbr, plan, bwd, bplan), mask = args, None
                else:
                    f, nbr, mask, plan, bwd, bplan = args
                rows.append(layer_kernels(phase, f'second_focal {n}', sc, f, nbr,
                                          modules[n].kernel.detach(), plan, bwd, bplan, mask,
                                          rng))
            groups[f'second_focal {kind} layers'] = rows
    for group, rows in groups.items():
        log(phase, f'{group} ({len(rows)}), summed, ms kernel / plain / bound: ' + '; '.join(
            f'{k} {sum(r[k][0] for r in rows):.4f} / {sum(r[k][1] for r in rows):.3f} / '
            f'{sum(r[k][2] for r in rows):.4f}, kernel vs plain max |diff| '
            f'{max(r[k][3] for r in rows):.2e}' for k in ('fwd', 'dgrad', 'wgrad'))
            + f' on {smi}')
    log(phase, 'the weight gradient\'s largest scratch over these layers '
        f'{max(r["scratch_mb"] for rows in groups.values() for r in rows):.3f} MB')
    log(phase, f'the focal training batch B={B}: dilated-table slots filled per stage and cloud '
        f'{fills} of {[batch[f"fl_emask{s}"].shape[1] for s in (1, 2, 3)]}')


def ladder_predict_phase(name: str, cfg, wrappers, synthetic, card: str) -> dict:
    """Phase 37: `predict` of VoxelNeXt or the focal SECOND as shipped at B=4
    on LiDAR-like clouds (40000 voxel slots), the classification bias at 0:
    shapes, finite values, LADDER_PREDICT_LAUNCHES in the first run; then 5
    passes timed in two parts (the map build, then predict on the prepared
    batch), frames/s, peak memory, and `torch.profiler`'s device time and
    busy share of a prepared predict."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.tools.profile_predict import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '37 ladder predict'
    B = 4
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    raw = synthetic.voxel_batch(B, SECOND_POINTS, cfg, seed=5, device='cuda')
    inputs = prepare(raw)
    if 'sp_sites' in inputs:
        caps = [inputs[k].shape[1] for k in ('sp_mask1', 'sp_mask2', 'sp_mask3', 'sp_mask4',
                                             'sp_mask_out')]
        fill = (f'caps {caps}, sites per stage and cloud {inputs["sp_sites"].tolist()}, BEV '
                f'slots {inputs["sp_bev_mask"].sum(1).tolist()} of '
                f'{inputs["sp_bev_mask"].shape[1]}')
    else:
        fill = '; '.join(f'stage {s}: candidates {inputs[f"fl_cmask{s}"].sum(1).tolist()} of '
                         f'{inputs[f"fl_cmask{s}"].shape[1]}, dilated '
                         f'{inputs[f"fl_emask{s}"].sum(1).tolist()} of '
                         f'{inputs[f"fl_emask{s}"].shape[1]}' for s in (1, 2, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict(inputs)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B, cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    if launches != LADDER_PREDICT_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED {name}: kernel launches {launches}, expected '
                         f'{LADDER_PREDICT_LAUNCHES}')

    def two_parts() -> tuple[float, float]:
        t0 = time.perf_counter()
        batch = prepare(raw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.predict(batch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    for _ in range(2):
        two_parts()
    reps = [two_parts() for _ in range(5)]
    build = statistics.median(r[0] for r in reps)
    pred = statistics.median(r[1] for r in reps)
    with torch.inference_mode():
        prof = trace(net, inputs, TRACE_PREDICTS)
    device_ms = prof['device_ms_per_predict']
    log(phase, f'{name} as shipped B={B} ({inputs["voxel_mask"].sum(1).tolist()} of '
        f'{inputs["voxel_mask"].shape[1]} voxel slots filled; {fill}): shapes ok, finite, '
        f'{int(det["pred_mask"].sum())} kept boxes, launches {launches}; 5 passes timed in two '
        f'parts: map build median {build * 1e3:.3f} ms, predict on the prepared batch median '
        f'{pred * 1e3:.3f} ms/batch = {B / pred:.2f} frames/s (least '
        f'{min(r[1] for r in reps) * 1e3:.3f}, most {max(r[1] for r in reps) * 1e3:.3f}); '
        f'device {device_ms:.3f} ms per predict, busy {device_ms / (pred * 1e3):.3f}; peak '
        f'allocated {peak:.3f} GiB; top kernels: '
        + '; '.join(f'{r["name"][:60]} x{r["calls_per_predict"]:g} {r["ms_per_predict"]:.3f} ms'
                    for r in prof['top_kernels'][:5]) + f' on {card}')
    return launches


# TTA_FLIP of phase 40: the tiny model, its flips, points per cloud
TTA_CASES = (('centerpoint_pillar', 'configs/kitti_models/centerpoint_pillar.yaml', ['x', 'y'],
              16384), ('second_sparse', SECOND_CFG, ['x'], TINY_LADDER_POINTS))


def tta_cuda_vs_cpu_phase(name: str, cfg, flips, N: int, synthetic) -> None:
    """Phase 40: the tiny shrink of a `Detector3D` config with TTA_FLIP, the
    classification bias at 0, on CUDA against the CPU: detections matched by
    box and label; the flips change the detections. A voxel model's batch
    gets its maps once, before `predict`, which does not rebuild them for a
    flip (as the JAX package's does not)."""
    from pdm_ssd_torch.models import get_host_prepare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '40 tta'
    tiny = synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    nets, ins = {}, {}
    for dev in ('cpu', 'cuda'):
        if synthetic.voxelizes(tiny):
            batch = synthetic.voxel_batch(2, N, tiny, seed=4, device=dev)
            prepare = get_host_prepare(tiny.MODEL, tiny.DATA_CONFIG)
            ins[dev] = batch if prepare is None else prepare(batch)
        else:
            ins[dev] = {'points': torch.from_numpy(synthetic.kitti_points(2, N, 4)).to(dev)}
    plain = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu')).predict(ins['cpu'])
    tiny.MODEL.POST_PROCESSING.TTA_FLIP = flips
    nets['cpu'] = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    nets['cuda'] = synthetic.random_model(tiny, 'cuda')
    nets['cuda'].load_state_dict(nets['cpu'].state_dict())
    want = nets['cpu'].predict(ins['cpu'])
    if torch.equal(want['pred_boxes'], plain['pred_boxes']):
        raise SystemExit(f'[{phase}] FAILED {name}: TTA_FLIP {flips} changed no detection')
    note = match_detections({k: v.cpu() for k, v in nets['cuda'].predict(ins['cuda']).items()},
                            want, phase)
    log(phase, f'tiny {name} with TTA_FLIP {flips}, B=2, CUDA vs CPU: {note}')


def ladder_phases(wrappers, sc, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 35 to 40. Returns the kernel launches of each path, by name."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file))

    for name, cfg_file in LADDER_MODELS:
        ladder_cuda_vs_cpu_phase(name, load(cfg_file), synthetic)
    ladder_kernels_phase(sc, synthetic, smi, cfg_from_yaml_file)
    torch.cuda.empty_cache()
    paths = {}
    for name, cfg_file in LADDER_MODELS:
        paths[f'{name}_predict'] = ladder_predict_phase(name, load(cfg_file), wrappers, synthetic,
                                                        smi)
        torch.cuda.empty_cache()
    for name, cfg_file in LADDER_MODELS:
        paths[f'{name}_train'] = second_train_phase(load(cfg_file), wrappers, synthetic, smi,
                                                    '38 ladder train', LADDER_TRAIN_LAUNCHES)
        torch.cuda.empty_cache()
    B = load(VOXELNEXT_CFG).OPTIMIZATION.BATCH_SIZE_PER_GPU
    paths['voxelnext_eval_loop'] = kitti_eval_phase(
        wrappers, synthetic, smi, VOXELNEXT_CFG, '39 voxelnext eval loop',
        LADDER_PREDICT_LAUNCHES, adjust=synthetic.open_score_gate, cpu_check=False, B=B)
    paths['voxelnext_train_loop'] = train_loop_phase(
        wrappers, synthetic, smi, VOXELNEXT_CFG, '39 voxelnext train loop',
        LADDER_TRAIN_LAUNCHES, B=B)
    for name, cfg_file, flips, N in TTA_CASES:
        tta_cuda_vs_cpu_phase(name, load(cfg_file), flips, N, synthetic)
    # every kernel of these paths ran on each: the row gather and the sparse
    # conv on both predicts and train steps, the weight gradient on the steps
    for path, launches in paths.items():
        need = ('gather_rows', 'sparse_conv') + (
            ('sparse_conv_wgrad',) if path.endswith('train') or path.endswith('train_loop')
            else ())
        if any(launches[k] < 1 for k in need):
            raise SystemExit(f'[kernels] FAILED: {path} launched {launches}, none of one of {need}')
    return paths


# phases 41 to 45: the two-stage family's shared core. PointRCNN's training,
# PV-RCNN and Voxel R-CNN on the dense and the sparse ladder, served and trained
TWO_STAGE_MODELS = (('pv_rcnn', 'configs/kitti_models/pv_rcnn.yaml'),
                    ('pv_rcnn_sparse', 'configs/kitti_models/pv_rcnn_sparse.yaml'),
                    ('voxel_rcnn', 'configs/kitti_models/voxel_rcnn.yaml'),
                    ('voxel_rcnn_sparse', 'configs/kitti_models/voxel_rcnn_sparse.yaml'))
PV_RCNN_CFG = TWO_STAGE_MODELS[0][1]
# points per cloud: the `sample_points` of the four files' data processor
TWO_STAGE_POINTS = 16384
# the tiny models' clouds (256 voxel slots) and PointRCNN's
TINY_TWO_STAGE_POINTS = 3000
TINY_POINTRCNN_POINTS = 2048
# one PointRCNN train step launches a predict's kernels (the ROI stack's FPS
# and ball query on its B * ROI_PER_IMAGE clouds), and in the backward one
# scatter-add for each gather of features with a gradient: SA levels 2 and 3
# of the backbone at two radii, the ROI stack's two levels at one
POINTRCNN_TRAIN_LAUNCHES = {**POINTRCNN_PREDICT_LAUNCHES, 'scatter_add_rows': 6}


def two_stage_launches(cfg, B: int, train: bool) -> dict:
    """The launches of one predict (or train step) of PV-RCNN or Voxel R-CNN
    at B clouds of TWO_STAGE_POINTS points: on the sparse ladder the reorder
    gather and 12 sparse convs (a step: 11 data gradients and 12 weight
    gradients more); one gather per voxel pool (PV-RCNN's two VSA stages,
    Voxel R-CNN's three pooled stages), a scatter-add each in the backward;
    PV-RCNN's FPS of the keypoints, one selection and a gather per radius for
    its raw points (no gradient behind them), one ball query of the grid pool
    on its B * R clouds of POOL_MAX_KEYPOINTS keypoints and a gather of the
    offsets and one of the projected features per radius, a scatter-add for
    the features in the backward. FPS and the ball query by the path their
    plans take. PV-RCNN++ runs its keypoints' FPS masked, one launch for its
    B * NUM_SECTORS sector clouds, and its raw points through VectorPool
    (one radius); the sparse UNet of Part-A2 runs 28 sparse convs (the
    ladder's 12, four UR blocks of 4), 27 data gradients and 28 weight
    gradients a step; SECOND-IoU and the dense Part-A2 launch none of the
    port's kernels."""
    from pdm_ssd_torch.ops import ball_query as bq
    from pdm_ssd_torch.ops import fps
    m = cfg.MODEL
    sparse = m.BACKBONE_3D.NAME.startswith('Sparse')
    layers = 28 if m.BACKBONE_3D.NAME == 'SparseUNetV2' else 12
    n = {k: 0 for k in PREDICT_LAUNCHES}
    if sparse:
        n['gather_rows'] += 1
        n['sparse_conv'] += layers + (layers - 1 if train else 0)
        n['sparse_conv_wgrad'] += layers if train else 0
    if m.NAME in ('PVRCNN', 'PVRCNNPlusPlus'):
        pools = sum(s.startswith('x_conv') for s in m.PFE.FEATURES_SOURCE)
        radii = m.ROI_HEAD.ROI_GRID_POOL.POOL_RADIUS
        raw = len(m.PFE.SA_LAYER.raw_points.POOL_RADIUS)
        n_key = int(m.PFE.NUM_KEYPOINTS)
        if m.PFE.get('SAMPLE_METHOD', 'FPS') == 'SPC':
            sectors = int(m.PFE.SPC_SAMPLING.get('NUM_SECTORS', 6))
            plan = fps.plan_for(0, B * sectors, TWO_STAGE_POINTS, min(n_key, TWO_STAGE_POINTS))
            n['fps masked'] = 1
        else:
            plan = fps.plan_for(0, B, TWO_STAGE_POINTS, n_key)
        n['farthest_point_sample'] = 1
        n[f'fps {plan.path} path'] = 1
        n['window_select'] = 1
        n['ball_query'] = 1
        path = bq.ball_query_plan(int(m.ROI_HEAD.POOL_MAX_KEYPOINTS), radii).path
        n[f'ball query {path} path'] = 1
        n['gather_rows'] += pools + raw + 2 * len(radii)
        n['scatter_add_rows'] += (pools + len(radii)) if train else 0
    elif m.NAME == 'VoxelRCNN':
        pools = len(m.ROI_HEAD.ROI_GRID_POOL.FEATURES_SOURCE)
        n['gather_rows'] += pools
        n['scatter_add_rows'] += pools if train else 0
    return n


def roi_draw(B: int, R: int, seed: int) -> torch.Tensor:
    """The uniform draw of the ROI targets, (B, R), made on the CPU: fed to
    both devices as 'roi_target_rand'."""
    return torch.rand((B, R), generator=torch.Generator().manual_seed(seed))


def plant_gt(net, batch: dict, shift: float = 0.0) -> dict:
    """The batch with its first 3 ground-truth boxes of each cloud moved onto
    proposals of a training forward of `net` (its first 3 valid ROIs, label
    1), so that the targets hold foreground ROIs; the other boxes stay. With
    `shift`, each moved along x by `shift` times its length and turned by
    `shift` radians (a box on its ROI exactly is a degenerate case of the
    rotated IoU, whose label SECOND-IoU regresses). The proposals do not
    depend on the ground truth; the BatchNorm statistics the forward moved
    are restored."""
    state = {k: v.clone() for k, v in net.state_dict().items()}
    net.train()
    with torch.no_grad():
        out = net(dict(batch))
    net.eval()
    net.load_state_dict(state)
    gt, mask = batch['gt_boxes'].clone(), batch['gt_mask'].clone()
    for b in range(gt.shape[0]):
        rois = out['rois'][b][out['roi_mask'][b]][:3].clone()
        rois[:, 0] += shift * rois[:, 3]
        rois[:, 6] += shift
        gt[b, :len(rois), :7] = rois
        gt[b, :len(rois), 7] = 1
        mask[b, :len(rois)] = True
    return {**batch, 'gt_boxes': gt, 'gt_mask': mask}


def two_stage_batch(name: str, cfg, synthetic, B: int, N: int, seed: int, device) -> dict:
    """A training batch of a two-stage model: PointRCNN's LiDAR-like points
    with 8 boxes a cloud, a voxel model's voxelized clouds prepared for
    training on `device`."""
    from pdm_ssd_torch.models import get_host_prepare
    if name == 'pointrcnn':
        pc = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        pts = torch.from_numpy(synthetic.lidar_points(B, N, seed, pc)).to(device)
        gt = torch.from_numpy(synthetic.gt_boxes(B, 8, pc, seed + 1)).to(device)
        return {'points': pts, 'gt_boxes': gt,
                'gt_mask': torch.ones((B, 8), dtype=torch.bool, device=device)}
    batch = synthetic.voxel_train_batch(B, N, cfg, 8, seed=seed, device=device)
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    return batch if prepare is None else prepare(batch)


class ProposalReplay:
    """While active, the CUDA model's proposal layer returns what the CPU
    model's proposal layer returned in the same call of a paired run (the
    CPU runs first): near-tied first-stage scores permute the proposals'
    slots between the devices and move a few across the cut (phase 10), and
    the targets' draw is per slot, so the second stage is compared on one
    set of proposals. `match_rois` holds the proposal layers themselves."""

    def __init__(self, cpu_net, gpu_net):
        self.heads = cpu_net.roi_head, gpu_net.roi_head
        self.queue = []

    def __enter__(self):
        cpu_head, gpu_head = self.heads
        record, keys = cpu_head.proposal_layer, ('rois', 'roi_scores', 'roi_labels', 'roi_mask')

        def recorded(batch):
            out = record(batch)
            self.queue.append({k: out[k].clone() for k in keys})
            return out

        def replayed(batch):
            batch.update({k: v.cuda() for k, v in self.queue.pop(0).items()})
            return batch

        cpu_head.proposal_layer, gpu_head.proposal_layer = recorded, replayed
        return self

    def __exit__(self, *exc):
        for head in self.heads:
            del head.proposal_layer


def serving_batch(cfg, synthetic, B: int, seed: int) -> dict:
    """A two-stage voxel model's serving batch on the card: B LiDAR-like
    clouds of TWO_STAGE_POINTS points, voxelized, with the sparse ladder's
    maps where the model has them."""
    from pdm_ssd_torch.models import get_host_prepare
    batch = synthetic.voxel_batch(B, TWO_STAGE_POINTS, cfg, seed=seed, device='cuda')
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    return batch if prepare is None else prepare(batch)


def two_stage_cuda_vs_cpu_phase(name: str, cfg, synthetic,
                                phase: str = '41 two-stage cuda-vs-cpu',
                                shift: float = 0.0) -> None:
    """Phase 41: the tiny shrink of a two-stage config (`synthetic.TINY_CFGS`;
    PointRCNN's with its FP list whole and its ROIs pooled 2 m wider, so that
    they hold points) on CUDA (the kernels) against the CPU (the plain
    versions), the anchor bias at 0, on a training batch whose ground truth
    sits on proposals, with one draw of the targets fed to both: the batches
    equal; the proposal layers on the CPU's first stage, matched by box
    (`match_rois`); then, the CUDA run given the CPU run's proposals
    (`ProposalReplay`): every integer and bool output of the eval forward
    equal (the keypoints, the proposals' mask and labels) and the float ones
    within FWD_RTOL of scale, PV-RCNN's grid-pool indices and empty balls
    equal, the targets' order, fg mask and matched ground truth equal,
    detections matched by box and label, each loss within LOSS_RTOL and
    every gradient within SECOND_GRAD_RTOL relative L2. `shift` moves the
    planted boxes off their proposals (`plant_gt`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == 'pointrcnn':
        tiny = synthetic.tiny_pointrcnn_cfg(synthetic.pointrcnn_fp3(cfg))
        tiny.MODEL.ROI_HEAD.ROI_POINT_POOL.POOL_EXTRA_WIDTH = [2.0, 2.0, 2.0]
        N = TINY_POINTRCNN_POINTS
    else:
        tiny = synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
        N = TINY_TWO_STAGE_POINTS
    ins = {dev: two_stage_batch(name, tiny, synthetic, 2, N, 4, dev) for dev in ('cpu', 'cuda')}
    for k, v in ins['cpu'].items():
        if not torch.equal(ins['cuda'][k].cpu(), v):
            raise SystemExit(f'[{phase}] FAILED: {name} {k} made on CUDA differs from the CPU\'s')
    cpu_net = synthetic.random_model(tiny, 'cpu')
    if name != 'pointrcnn':
        synthetic.open_score_gate(cpu_net)
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    planted = plant_gt(cpu_net, ins['cpu'], shift)
    R = tiny.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE
    draw = roi_draw(2, R, 9)
    ins = {'cpu': {**planted, 'roi_target_rand': draw},
           'cuda': {**ins['cuda'], 'gt_boxes': planted['gt_boxes'].cuda(),
                    'gt_mask': planted['gt_mask'].cuda(), 'roi_target_rand': draw.cuda()}}
    # the proposal layers on one first stage, the CPU's
    first = {}
    with torch.inference_mode():
        out = cpu_net(dict(ins['cpu']))
        keys = ('batch_cls_preds', 'batch_box_preds')
        for dev, net in (('cpu', cpu_net), ('cuda', gpu_net)):
            first[dev] = net.roi_head.proposal_layer({k: out[k].to(dev) for k in keys})
    _, _, roi_note = match_rois({k: v.cpu() for k, v in first['cuda'].items()
                                 if k in ROI_KEYS[:4]},
                                {k: v for k, v in first['cpu'].items() if k in ROI_KEYS[:4]},
                                phase)
    with ProposalReplay(cpu_net, gpu_net):
        outs = {}
        with torch.inference_mode():
            for dev, net in (('cpu', cpu_net), ('cuda', gpu_net)):
                outs[dev] = {k: v for k, v in flatten(net(dict(ins[dev]))).items()
                             if not k.startswith(('sp_', 'voxel'))}
        worst, n_exact = 0.0, 0
        for k, w in outs['cpu'].items():
            g = outs['cuda'][k].cpu()
            if not w.dtype.is_floating_point or k == 'point_coords':
                if not torch.equal(g, w):
                    raise SystemExit(f'[{phase}] FAILED {name} {k}: differs between CUDA and the '
                                     'CPU')
                n_exact += 1
                continue
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {name} {k}: max |diff| / max |cpu| = '
                                 f'{rel:.3e}')
        grid_note = ''
        if hasattr(cpu_net.roi_head, 'grid_select'):
            # the grid pool's selection on CUDA and on the CPU, from the CPU's inputs
            with torch.inference_mode():
                b = cpu_net.pfe(cpu_net.first_stage(dict(ins['cpu'])))
                head = cpu_net.roi_head      # its own proposal layer, not the recording
                b = {k: v for k, v in type(head).proposal_layer(head, b).items()
                     if torch.is_tensor(v)}
                sel = {dev: net.roi_head.grid_select({k: v.to(dev) for k, v in b.items()},
                                                     b['rois'].to(dev))
                       for dev, net in (('cpu', cpu_net), ('cuda', gpu_net))}
            for i, (gw, gg) in enumerate(zip(sel['cpu'][4], sel['cuda'][4])):
                if not (torch.equal(gg.cpu(), gw)
                        and torch.equal(sel['cuda'][5][i].cpu(), sel['cpu'][5][i])):
                    raise SystemExit(f'[{phase}] FAILED {name}: grid-pool indices of radius {i} '
                                     'differ between CUDA and the CPU')
            grid_note = (f'; grid-pool indices {[tuple(g.shape) for g in sel["cpu"][4]]} equal, '
                         f'{int(sum(e.sum() for e in sel["cpu"][5]))} empty balls of '
                         f'{sum(e.numel() for e in sel["cpu"][5])}')
        # the targets of a training forward
        tgts = {}
        for dev, net in (('cpu', cpu_net), ('cuda', gpu_net)):
            state = {k: v.clone() for k, v in net.state_dict().items()}
            net.train()
            with torch.no_grad():
                tgts[dev] = net(dict(ins[dev]))['roi_targets']
            net.eval()
            net.load_state_dict(state)
        for k in ('roi_mask', 'reg_valid_mask', 'gt_of_roi', 'rois'):
            if not torch.equal(tgts['cuda'][k].cpu(), tgts['cpu'][k]):
                raise SystemExit(f'[{phase}] FAILED {name}: targets {k} differ between CUDA and '
                                 'the CPU')
        for k in ('rcnn_cls_labels', 'rcnn_reg_targets'):
            w, g = tgts['cpu'][k], tgts['cuda'][k].cpu()
            if not float((g - w).abs().max()) <= FWD_RTOL * max(float(w.abs().max()), 1.0):
                raise SystemExit(f'[{phase}] FAILED {name}: targets {k} differ beyond FWD_RTOL')
        n_fg = int(tgts['cpu']['reg_valid_mask'].sum())
        want = cpu_net.predict(dict(ins['cpu']))
        note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(ins['cuda'])).items()},
                                want, phase)
        c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
            phase, name, {'cpu': cpu_net, 'cuda': gpu_net}, ins, SECOND_GRAD_RTOL)
    log(phase, f'tiny {name} B=2, ground truth on 3 proposals a cloud, one draw of the targets: '
        f'batches equal; the proposal layers on the CPU\'s first stage{roi_note}; with the CPU\'s '
        f'proposals on both: {len(outs["cpu"]) - n_exact} float outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}), {n_exact} integer, bool and '
        f'keypoint outputs equal{grid_note}; targets equal (order, masks, matched ground truth; '
        f'{n_fg} foreground ROIs); predict: {note}; losses on CUDA / CPU '
        + ', '.join(f'{k} {g_tb[k]:.6f} / {v:.6f}' for k, v in c_tb.items())
        + f'; {n} gradients agree, worst relative L2 {worst_g:.3e} at {worst_k} '
        f'(bound {SECOND_GRAD_RTOL:g})')


class _GatherRecorder:
    """Stands in for `GatherRows` in a module while it runs: records each
    call's (table, indices) and gathers as the original does."""

    def __init__(self, original):
        self.original, self.calls = original, []

    def apply(self, features, idx):
        self.calls.append((features.detach(), idx))
        return self.original.apply(features, idx)


def gather_check(phase: str, name: str, group, table, idx) -> dict:
    """The row gather at one shape against its plain version (exact), with
    its device ms, the plain version's ms, torch.gather's ms and the bound."""
    table, idx = table.contiguous(), idx.to(torch.int32).contiguous()
    B, N, C = table.shape
    got = group.gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, group.gather_rows_plain(table, idx)):
        raise SystemExit(f'[{phase}] FAILED {name}: gather_rows differs from its plain version')
    safe = idx.long().clamp(0, N - 1)[..., None].expand(-1, -1, C)
    t = device_time(lambda: group.gather_rows_cuda(table, idx))
    byts = (idx.numel() * (C + 1) + min(B * N, idx.numel()) * C) * 4
    r = {'ms': t['ms'], 'plain_ms': median_ms(lambda: group.gather_rows_plain(table, idx), 3),
         'library_ms': device_time(lambda: torch.gather(table, 1, safe))['ms'],
         'bound_ms': byts / HBM_BYTES_PER_S * 1e3}
    log(phase, f'{name} gather_rows (B={B}, N={N}, R={idx.shape[1]}, C={C}): == plain (exact); '
        f'kernel {timing_note(t)}; plain {r["plain_ms"]:.4f} ms; torch.gather '
        f'{r["library_ms"]:.4f} ms; bound {r["bound_ms"]:.5f} ms')
    return r


def scatter_check(phase: str, name: str, group, idx, C: int, N: int, seed: int) -> dict:
    """The row scatter-add at one shape, the backward of a gather with
    indices `idx` into N rows of C channels: kernel and plain version within
    float32 rounding of the float64 sum, with times and bound."""
    B, R = idx.shape
    idx = idx.to(torch.int32).contiguous()
    vals = torch.randn((B, R, C), generator=torch.Generator().manual_seed(seed)).cuda()
    back = group.scatter_add_rows_cuda(vals, idx, N)
    torch.cuda.synchronize()
    plain_back = group.scatter_add_rows_plain(vals, idx, N)
    exact = group.scatter_add_rows_plain(vals.double().cpu(), idx.cpu(), N)
    mass = group.scatter_add_rows_plain(vals.double().abs().cpu(), idx.cpu(), N)
    count = group.scatter_add_rows_plain(torch.ones((B, R, 1), dtype=torch.float64),
                                         idx.cpu(), N)
    tol = 2.0 ** -23 * count * mass + 1e-30
    for label, t in (('kernel', back), ('plain', plain_back)):
        if bool(((t.double().cpu() - exact).abs() > tol).any()):
            raise SystemExit(f'[{phase}] FAILED {name}: scatter_add_rows {label} differs from '
                             'the float64 sum beyond rounding')
    flat = (idx.long() + torch.arange(B, device='cuda')[:, None] * N).reshape(-1)
    v2 = vals.reshape(-1, C)
    t = device_time(lambda: group.scatter_add_rows_cuda(vals, idx, N))
    byts = (vals.numel() + idx.numel() + B * N * C) * 4
    r = {'ms': t['ms'], 'plain_ms': median_ms(
        lambda: group.scatter_add_rows_plain(vals, idx, N), 3),
         'library_ms': device_time(lambda: torch.zeros((B * N, C), device='cuda').index_add_(
             0, flat, v2))['ms'], 'bound_ms': byts / HBM_BYTES_PER_S * 1e3,
         'err': float((back - plain_back).abs().max())}
    log(phase, f'{name} scatter_add_rows (B={B}, R={R}, C={C}, into {N} rows): kernel and plain '
        f'within float32 rounding of float64 (kernel vs plain max |diff| {r["err"]:.2e}); kernel '
        f'{timing_note(t)}; plain {r["plain_ms"]:.4f} ms; index_add_ {r["library_ms"]:.4f} ms; '
        f'bound {r["bound_ms"]:.5f} ms')
    return r


def two_stage_kernels_phase(synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phase 42: the kernels at the shapes this slice gives them, each against
    its plain version, on the serving batches of the files as shipped (B=4,
    LiDAR-like clouds of 16384 points, the anchor bias at 0): PV-RCNN's grid
    pool, its ball query (B * R clouds of 64 preselected keypoints, 216 grid
    points, radii 0.8 and 1.6, K 16 and 16: indices exact) and the gathers
    of offsets and projected features by its indices (exact), with the
    scatter-add of the features' backward (float64 bound); the gathers of
    the voxel pools (PV-RCNN's VSA on the dense ladder's x_conv3 and
    x_conv4, Voxel R-CNN's on x_conv2 to x_conv4 of the dense and the sparse
    ladder: exact). Returns, per kernel, the sums of device ms, plain ms,
    library ms and bound over these shapes."""
    from pdm_ssd_torch.models.backbones_3d import pfe
    from pdm_ssd_torch.ops import ball_query as bq
    from pdm_ssd_torch.ops import group
    from pdm_ssd_torch.ops import pointnet2 as plain
    from pdm_ssd_torch.models.model_nms import take_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '42 two-stage kernels'
    sums = {k: {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0}
            for k in ('ball_query', 'gather_rows', 'scatter_add_rows')}

    def add(kern, r):
        for key in sums[kern]:
            sums[kern][key] += r[key] if r[key] is not None else 0.0

    cfg = cfg_from_yaml_file(str(REPO / PV_RCNN_CFG))
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = serving_batch(cfg, synthetic, 4, seed=5)
    rec = _GatherRecorder(pfe.GatherRows)
    pfe.GatherRows = rec
    try:
        with torch.inference_mode():
            b = net.pfe(net.first_stage(inputs))
    finally:
        pfe.GatherRows = rec.original
    for stage, (table, idx) in zip(('x_conv3', 'x_conv4'), rec.calls):
        add('gather_rows', gather_check(phase, f'pv_rcnn VSA {stage} window', group, table, idx))
    head = net.roi_head
    with torch.inference_mode():
        b = head.proposal_layer(b)
        idx, valid, sel_xyz, grid, gidx, empties = head.grid_select(b, b['rois'])
        BR, P = sel_xyz.shape[:2]
        mask = valid.reshape(BR, P).contiguous()
        got = bq.ball_query_cuda(head.radii, head.nsamples, sel_xyz, grid, mask)
        want = [plain.ball_query(r, k, sel_xyz, grid, mask=mask)
                for r, k in zip(head.radii, head.nsamples)]
        torch.cuda.synchronize()
        for r, g, w in zip(head.radii, got, want):
            if not torch.equal(g, w):
                raise SystemExit(f'[{phase}] FAILED grid-pool ball query r={r}: '
                                 f'{int((g != w).sum())} indices differ from the plain version')
        path = bq.ball_query_plan(P, head.radii).path
        t = device_time(lambda: bq.ball_query_cuda(head.radii, head.nsamples, sel_xyz, grid,
                                                   mask))
        M = grid.shape[1]
        # bytes: the points, their mask, the centres and the indices written;
        # operations: one distance test (8 flops) per centre, point and radius
        byts = (sel_xyz.numel() + mask.numel() / 4 + grid.numel()
                + sum(BR * M * k for k in head.nsamples)) * 4
        flops = 8 * BR * M * P * len(head.radii)
        bq_r = {'ms': t['ms'], 'plain_ms': median_ms(lambda: [
            plain.ball_query(r, k, sel_xyz, grid, mask=mask)
            for r, k in zip(head.radii, head.nsamples)], 3), 'library_ms': None,
            'bound_ms': max(byts / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3}
        add('ball_query', bq_r)
        log(phase, f'pv_rcnn grid pool ball query (B*R={BR} clouds of P={P} keypoints, '
            f'{int(mask.sum())} valid, M={M} grid points, r={head.radii}, K={head.nsamples}, '
            f'the {path} path): == plain (exact), {int(sum(e.sum() for e in empties))} empty '
            f'balls of {sum(e.numel() for e in empties)}; kernel {timing_note(t)}; plain '
            f'{bq_r["plain_ms"]:.3f} ms; bound {bq_r["bound_ms"]:.5f} ms')
        kf = take_rows(b['point_features'], idx.reshape(b['rois'].shape[0], -1).long())
        sel_feat = torch.where(valid.reshape(BR, P)[..., None], kf.reshape(BR, P, -1), 0.0)
        for i, gi in enumerate(gidx):
            rows = gi.reshape(BR, -1)
            add('gather_rows', gather_check(phase, f'pv_rcnn grid pool r={head.radii[i]} offsets',
                                            group, sel_xyz, rows))
            pre = getattr(head, f'pre_feat_{i}')(sel_feat).contiguous()
            add('gather_rows', gather_check(phase, f'pv_rcnn grid pool r={head.radii[i]} '
                                            'features', group, pre, rows))
            add('scatter_add_rows', {**scatter_check(
                phase, f'pv_rcnn grid pool r={head.radii[i]} features backward', group, rows,
                pre.shape[-1], P, 11 + i)})
    del net, inputs, b, rec
    torch.cuda.empty_cache()
    for name, cfg_file in TWO_STAGE_MODELS[2:]:
        cfg = cfg_from_yaml_file(str(REPO / cfg_file))
        net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
        inputs = serving_batch(cfg, synthetic, 4, seed=5)
        rec = _GatherRecorder(pfe.GatherRows)
        pfe.GatherRows = rec
        try:
            with torch.inference_mode():
                net(dict(inputs))
        finally:
            pfe.GatherRows = rec.original
        for stage, (table, idx) in zip(cfg.MODEL.ROI_HEAD.ROI_GRID_POOL.FEATURES_SOURCE,
                                       rec.calls):
            add('gather_rows', gather_check(phase, f'{name} ROI pool {stage} window', group,
                                            table, idx))
        del net, inputs, rec
        torch.cuda.empty_cache()
    log(phase, 'summed over these shapes, ms kernel / plain / library / bound: ' + '; '.join(
        f'{k} {v["ms"]:.4f} / {v["plain_ms"]:.3f} / {v["library_ms"]:.4f} / '
        f'{v["bound_ms"]:.4f}' for k, v in sums.items()) + f' on {smi}')
    return sums


def two_stage_predict_phase(name: str, cfg, wrappers, synthetic, card: str,
                            phase: str = '43 two-stage predict') -> dict:
    """Phase 43: `predict` of a two-stage voxel model as shipped at B=4 on
    LiDAR-like clouds of 16384 points (the data processor's sample) voxelized
    into the file's 16000 slots, the anchor bias at 0: shapes, finite values,
    `two_stage_launches` in the first run; then 5 passes timed in two parts
    (the sparse ladder's map build, then predict on the prepared batch),
    frames/s, peak memory, `torch.profiler`'s device time, busy share and top
    kernels."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.tools.profile_predict import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = 4
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    raw = synthetic.voxel_batch(B, TWO_STAGE_POINTS, cfg, seed=5, device='cuda')
    inputs = raw if prepare is None else prepare(raw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict(inputs)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B, cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    expected = two_stage_launches(cfg, B, train=False)
    if launches != expected:
        raise SystemExit(f'[{phase}] FAILED {name}: kernel launches {launches}, expected '
                         f'{expected}')

    def two_parts() -> tuple[float, float]:
        t0 = time.perf_counter()
        batch = raw if prepare is None else prepare(raw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.predict(batch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    for _ in range(2):
        two_parts()
    reps = [two_parts() for _ in range(5)]
    build = statistics.median(r[0] for r in reps)
    pred = statistics.median(r[1] for r in reps)
    with torch.inference_mode():
        prof = trace(net, inputs, TRACE_PREDICTS)
    device_ms = prof['device_ms_per_predict']
    log(phase, f'{name} as shipped B={B} N={TWO_STAGE_POINTS} '
        f'({inputs["voxel_mask"].sum(1).tolist()} of {inputs["voxel_mask"].shape[1]} voxel '
        f'slots filled): shapes ok, finite, {int(det["pred_mask"].sum())} kept boxes, launches '
        f'{launches}; 5 passes timed in two parts: map build median {build * 1e3:.3f} ms, '
        f'predict on the prepared batch median {pred * 1e3:.3f} ms/batch = {B / pred:.2f} '
        f'frames/s (least {min(r[1] for r in reps) * 1e3:.3f}, most '
        f'{max(r[1] for r in reps) * 1e3:.3f}); device {device_ms:.3f} ms per predict, busy '
        f'{device_ms / (pred * 1e3):.3f}; peak allocated {peak:.3f} GiB; top kernels: '
        + '; '.join(f'{r["name"][:60]} x{r["calls_per_predict"]:g} {r["ms_per_predict"]:.3f} ms'
                    for r in prof['top_kernels'][:5]) + f' on {card}')
    return launches


def two_stage_train_phase(name: str, cfg, wrappers, synthetic, card: str,
                          phase: str = '44 two-stage train', B: int | None = None) -> dict:
    """Phase 44: five training steps of a two-stage config as shipped at
    B = BATCH_SIZE_PER_GPU (PV-RCNN and Voxel R-CNN 2, PointRCNN 4, its FP
    list whole), LiDAR-like clouds of 16384 points with 8 boxes each, 3 of
    them on the seeded model's proposals (`plant_gt`): finite losses, the
    ROI terms of every step, parameters changed, the expected launches a
    step, ms per step (a voxel model's map build timed apart in 3 more
    passes) and peak memory. `B` overrides the config's batch."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = 5
    B = B or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    net = synthetic.random_model(cfg, seed=7)          # no device named: the card
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    if name == 'pointrcnn':
        prepare, expected = None, POINTRCNN_TRAIN_LAUNCHES
        raw = two_stage_batch(name, cfg, synthetic, B, TWO_STAGE_POINTS, 5, 'cuda')
    else:
        prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
        expected = two_stage_launches(cfg, B, train=True)
        raw = synthetic.voxel_train_batch(B, TWO_STAGE_POINTS, cfg, 8, seed=5, device='cuda')
    # 3 of the 8 boxes on proposals, so that the box and corner losses count
    planted = plant_gt(net, raw if prepare is None else prepare(raw))
    raw = {**raw, 'gt_boxes': planted['gt_boxes'], 'gt_mask': planted['gt_mask']}
    train_step = make_train_step(net, optimizer, prepare)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    losses, times, roi_terms = [], [], {}
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = train_step(raw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics['loss']))
        # the planted boxes sit on the first step's proposals; later steps
        # move the proposals away from them
        for k, v in metrics.items():
            if k.startswith('rcnn'):
                roi_terms.setdefault(k, []).append(float(v))
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise SystemExit(f'[{phase}] FAILED {name}: losses {losses}')
    want = {k: v * steps for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED {name}: kernel launches {launches}, expected {want}')
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    if changed < 0.9 * len(before):
        raise SystemExit(f'[{phase}] FAILED {name}: {changed} of {len(before)} parameter '
                         'tensors changed')
    parts = ''
    if prepare is not None:
        split = []
        for _ in range(3):
            t0 = time.perf_counter()
            with torch.no_grad():
                prepared = prepare(raw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train_step(prepared)
            torch.cuda.synchronize()
            split.append((t1 - t0, time.perf_counter() - t1))
        parts = (f'; in 3 more passes timed in two parts: map build median '
                 f'{statistics.median(p[0] for p in split) * 1e3:.3f} ms, step on the prepared '
                 f'batch median {statistics.median(p[1] for p in split) * 1e3:.3f} ms')
    log(phase, f'{name} as shipped B={B} N={TWO_STAGE_POINTS}, 8 boxes per cloud, {steps} '
        'steps: losses ' + ' '.join(f'{x:.4f}' for x in losses) + ' (the ROI terms a step: '
        + ', '.join(f'{k} {" ".join(f"{x:.4f}" for x in v)}' for k, v in roi_terms.items())
        + f'); {changed} of '
        f'{len(before)} '
        f'parameter tensors changed; launches per step {expected}; median '
        f'{statistics.median(times) * 1e3:.3f} ms/step (first {times[0] * 1e3:.1f} ms){parts}; '
        f'peak allocated {peak:.3f} GiB on {card}')
    return launches


def two_stage_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> tuple:
    """Phases 41 to 45. Returns (the kernel launches of each path, by name;
    phase 42's sums per kernel)."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file))

    two_stage_cuda_vs_cpu_phase('pointrcnn', load(POINTRCNN_CFG), synthetic)
    for name, cfg_file in TWO_STAGE_MODELS:
        two_stage_cuda_vs_cpu_phase(name, load(cfg_file), synthetic)
    sums = two_stage_kernels_phase(synthetic, smi, cfg_from_yaml_file)
    paths = {}
    for name, cfg_file in TWO_STAGE_MODELS:
        paths[f'{name}_predict'] = two_stage_predict_phase(name, load(cfg_file), wrappers,
                                                           synthetic, smi)
        torch.cuda.empty_cache()
    paths['pointrcnn_train'] = two_stage_train_phase(
        'pointrcnn', synthetic.pointrcnn_fp3(load(POINTRCNN_CFG)), wrappers, synthetic, smi)
    torch.cuda.empty_cache()
    for name, cfg_file in TWO_STAGE_MODELS:
        paths[f'{name}_train'] = two_stage_train_phase(name, load(cfg_file), wrappers, synthetic,
                                                       smi)
        torch.cuda.empty_cache()
    cfg = load(PV_RCNN_CFG)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    paths['pv_rcnn_eval_loop'] = kitti_eval_phase(
        wrappers, synthetic, smi, PV_RCNN_CFG, '45 pv_rcnn eval loop',
        two_stage_launches(cfg, B, train=False), adjust=synthetic.open_score_gate,
        cpu_check=False, B=B)
    paths['pv_rcnn_train_loop'] = train_loop_phase(
        wrappers, synthetic, smi, PV_RCNN_CFG, '45 pv_rcnn train loop',
        two_stage_launches(cfg, B, train=True), B=B, frames=TWO_STAGE_LOOP_FRAMES)
    # each kernel of the port's rows 1, 2, 3, 4, 6 and 7 ran on a path of this slice
    need = ('farthest_point_sample', 'ball_query', 'window_select', 'gather_rows',
            'scatter_add_rows', 'sparse_conv', 'sparse_conv_wgrad')
    for kern in need:
        if not any(launches[kern] > 0 for launches in paths.values()):
            raise SystemExit(f'[kernels] FAILED: {kern} was launched on no path of phases 41 to '
                             '45')
    return paths, sums


# the rest of the KITTI two-stage family (phases 46 to 50)
REST_MODELS = (('second_iou', 'configs/kitti_models/second_iou.yaml'),
               ('parta2', 'configs/kitti_models/parta2.yaml'),
               ('parta2_sparse', 'configs/kitti_models/parta2_sparse.yaml'),
               ('pv_rcnn_plusplus', 'configs/kitti_models/pv_rcnn_plusplus.yaml'),
               ('pv_rcnn_plusplus_sparse', 'configs/kitti_models/pv_rcnn_plusplus_sparse.yaml'))
PARTA2_CFG = REST_MODELS[1][1]
REST_TRAIN_B = 2
# PV-RCNN++'s keypoints: 6 sectors of each of B = 4 clouds, 2048 picks each
SECTORS, SECTOR_PICKS = 6, 2048


def masked_fps_phase(fps_mod, plain, synthetic, smi: str) -> dict:
    """Phase 47: the masked FPS at PV-RCNN++'s shape, B * 6 sector clouds of
    16384 points and 2048 picks each (B = 4), the masks those of
    `pointnet2.sector_masks` over LiDAR-like clouds, the points within 1.6 m
    of 100 box centres a cloud valid (so sectors run empty or out of points,
    which the kernel's tail picks then hold): each path and the plan's own
    choice equal to the plain masked version, index for index; device ms,
    host us, plain ms and the bound; the same for the unmasked kernel on the
    same clouds. The bound's operations count what the data needs: each
    sector's valid points updated at each of its min(picks, valid) - 1
    steps."""
    phase = '47 masked fps'
    B, N, S, npoint = 4, TWO_STAGE_POINTS, SECTORS, SECTOR_PICKS
    pc = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    xyz = torch.from_numpy(synthetic.lidar_points(B, N, 21, pc)[..., :3].copy()).cuda()
    centres = torch.from_numpy(synthetic.gt_boxes(B, 100, pc, 22)[..., :2]).cuda()
    d2 = ((xyz[:, :, None, :2] - centres[:, None]) ** 2).sum(-1).amin(-1)
    masks = plain.sector_masks(xyz, d2 < 1.6 * 1.6, S).reshape(B * S, N).contiguous()
    cnt = masks.sum(-1)
    rows = xyz.repeat_interleave(S, dim=0).contiguous()
    want = plain.farthest_point_sample(rows, npoint, mask=masks)
    plans = {'plan': fps_mod.plan_for(0, B * S, N, npoint),
             'block': fps_mod.fps_plan(B * S, N, npoint, 1, lambda *a: 0, path='block'),
             'cluster 4': fps_mod.FpsPlan('cluster', 4, *fps_mod.cluster_layout(N, 4))}
    for label, plan in plans.items():
        got = fps_mod.farthest_point_sample_cuda(xyz, npoint, plan, mask=masks)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f'[{phase}] FAILED {label} {plan}: {int((got != want).sum())} '
                             'indices differ from the plain masked version')
    if not (int(cnt.min()) == 0 and bool(((cnt > 0) & (cnt < npoint)).any())):
        raise SystemExit(f'[{phase}] FAILED: the clouds hold no empty or exhausted sector '
                         f'({cnt.tolist()})')
    unmasked_want = plain.farthest_point_sample(rows, npoint)
    if not torch.equal(fps_mod.farthest_point_sample_cuda(rows, npoint), unmasked_want):
        raise SystemExit(f'[{phase}] FAILED: the unmasked kernel differs from plain')
    t = device_time(lambda: fps_mod.farthest_point_sample_cuda(xyz, npoint, mask=masks))
    plain_ms = median_ms(lambda: plain.farthest_point_sample(rows, npoint, mask=masks), 3)
    u = device_time(lambda: fps_mod.farthest_point_sample_cuda(rows, npoint))
    u_plain = median_ms(lambda: plain.farthest_point_sample(rows, npoint), 3)
    steps = (cnt.clamp(max=npoint) - 1).clamp(min=0)
    t_bytes = (B * N * 12 + B * S * N + B * S * npoint * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = float((cnt * steps).sum()) * 10 / FP32_FLOP_PER_S * 1e3
    u_bytes = (B * S * N * 12 + B * S * npoint * 4) / HBM_BYTES_PER_S * 1e3
    u_ops = B * S * N * (npoint - 1) * 10 / FP32_FLOP_PER_S * 1e3
    log(phase, f'({B} x {S}, {N}) -> {npoint}, valid points a sector cloud {cnt.tolist()}: '
        + ', '.join(f'{k} {tuple(v)}' for k, v in plans.items()) + ' each == plain masked '
        f'(exact); masked kernel {timing_note(t)} ({plans["plan"].path} path), plain masked '
        f'{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms by '
        f'{"bytes" if t_bytes >= t_ops else "operations"}; unmasked kernel on the same clouds '
        f'{timing_note(u)}, plain {u_plain:.3f} ms, bound {max(u_bytes, u_ops):.4f} ms; on {smi}')
    return {'masked_ms': t['ms'], 'masked_host_us': t['host_us'], 'masked_call_ms': t['call_ms'],
            'masked_plain_ms': plain_ms, 'masked_bound_ms': max(t_bytes, t_ops),
            'masked_bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'masked_shape_unmasked_ms': u['ms'], 'masked_shape_unmasked_plain_ms': u_plain,
            'masked_shape_unmasked_bound_ms': max(u_bytes, u_ops)}


def rest_two_stage_phases(wrappers, fps_mod, plain, synthetic, smi: str,
                          cfg_from_yaml_file) -> tuple:
    """Phases 46 to 50: the tiny shrinks of SECOND-IoU, Part-A2 (dense and
    sparse) and PV-RCNN++ (dense and sparse) on CUDA against the CPU (the
    planted boxes 5 % off their proposals, so SECOND-IoU's IoU labels are not
    degenerate); the masked FPS; each as shipped: predict at B = 4 and five
    training steps at B = 2; `parta2.yaml`'s eval and train loops. Returns
    (the kernel launches of each path, by name; phase 47's FPS readings)."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file))

    for name, cfg_file in REST_MODELS:
        two_stage_cuda_vs_cpu_phase(name, load(cfg_file), synthetic, '46 rest cuda-vs-cpu',
                                    shift=0.05)
    masked = masked_fps_phase(fps_mod, plain, synthetic, smi)
    paths = {}
    for name, cfg_file in REST_MODELS:
        paths[f'{name}_predict'] = two_stage_predict_phase(name, load(cfg_file), wrappers,
                                                           synthetic, smi, '48 rest predict')
        torch.cuda.empty_cache()
    for name, cfg_file in REST_MODELS:
        paths[f'{name}_train'] = two_stage_train_phase(name, load(cfg_file), wrappers, synthetic,
                                                       smi, '49 rest train', B=REST_TRAIN_B)
        torch.cuda.empty_cache()
    cfg = load(PARTA2_CFG)
    paths['parta2_eval_loop'] = kitti_eval_phase(
        wrappers, synthetic, smi, PARTA2_CFG, '50 parta2 eval loop',
        two_stage_launches(cfg, REST_TRAIN_B, train=False), adjust=synthetic.open_score_gate,
        cpu_check=False, B=REST_TRAIN_B)
    paths['parta2_train_loop'] = train_loop_phase(
        wrappers, synthetic, smi, PARTA2_CFG, '50 parta2 train loop',
        two_stage_launches(cfg, REST_TRAIN_B, train=True), B=REST_TRAIN_B,
        frames=TWO_STAGE_LOOP_FRAMES)
    # the masked FPS ran on PV-RCNN++'s paths, and the sparse files' kernels
    for kern in ('fps masked', 'sparse_conv', 'sparse_conv_wgrad', 'gather_rows',
                 'scatter_add_rows', 'window_select', 'ball_query'):
        if not any(launches[kern] > 0 for launches in paths.values()):
            raise SystemExit(f'[kernels] FAILED: {kern} was launched on no path of phases 46 to '
                             '50')
    return paths, masked


# phases 51 to 54: the nuScenes half of the PDM family (`pdm_ssd_nuscenes.yaml`),
# which launches none of the port's kernels (pillarize is `index_add_`, the
# rest cuDNN convolutions and plain torch, the NMS plain torch), and its
# variant with `bevfusion.yaml`'s six head groups, 'vel' and 'iou' branches,
# IOU_REG_LOSS and PRED_VELOCITY (`synthetic.multihead_variant`)
NUSCENES_CFG = 'configs/nuscenes_models/pdm_ssd_nuscenes.yaml'
NUSCENES_MODELS = ('nuscenes', 'nuscenes_multihead')
# points a cloud at full width: 10 sweeps of a 32-beam LiDAR, as the file's
# `sample_points` keeps them
NUSCENES_POINTS = 163840
NUSCENES_DIR = REPO / 'build' / 'chip_smoke_nuscenes'
# frames of the generated mini set: CBGS keeps round(frames / 10) for its one
# class, 8 frames, 2 steps an epoch at B=4
NUSCENES_SAMPLES = 80
NUSCENES_SWEEPS = 10
# frames of the CUDA-vs-CPU passes of phase 54
NUSCENES_CPU_FRAMES = 4
# the paths of phases 52 to 54 whose counts the kernels line must carry
NUSCENES_PATHS = ('predict', 'train', 'eval_loop', 'train_loop')
# a kept box scoring within this of a tied candidate score is left out of
# that pass (float32 rounding may rank it on either side of the tie)
TIE_MARGIN = 1e-4


def nuscenes_cfg(cfg_from_yaml_file, name: str):
    """`pdm_ssd_nuscenes.yaml` as shipped, or as `synthetic.multihead_variant`
    sets it."""
    from pdm_ssd_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(REPO / NUSCENES_CFG))
    return synthetic.multihead_variant(cfg) if name == 'nuscenes_multihead' else cfg


def nuscenes_batch(cfg, synthetic, B: int, N: int, seed: int, device, train: bool) -> dict:
    """`synthetic.nuscenes_batch` on `device`: points alone, or with 8 boxes
    a cloud (with velocity where the config predicts it)."""
    batch = synthetic.nuscenes_batch(B, N, 8, seed=seed,
                                     velocity=bool(cfg.DATA_CONFIG.get('PRED_VELOCITY', False)))
    keys = ('points', 'gt_boxes', 'gt_mask') if train else ('points',)
    return {k: torch.from_numpy(batch[k]).to(device) for k in keys}


def per_class_nms_phase() -> None:
    """Phase 51: `multi_classes_nms` and `class_specific_nms` on the card
    against the CPU on the same candidates, slot order, boxes, scores,
    labels and keep mask equal: 10 classes at B=4 over 1000 candidates
    crowded into 24 m x 24 m (so NMS suppresses), with one NMS_THRESH / PRE /
    POST for every class and with a list of each."""
    from pdm_ssd_torch.models import model_nms
    from pdm_ssd_torch.utils.config import CfgNode
    phase = '51 nuscenes cuda-vs-cpu'
    rng = np.random.RandomState(12)
    B, A, C = 4, 1000, 10
    boxes = np.concatenate([rng.uniform(-12, 12, (B, A, 2)), rng.uniform(-2, 0, (B, A, 1)),
                            rng.uniform(0.5, 5, (B, A, 3)), rng.uniform(-np.pi, np.pi, (B, A, 1))],
                           -1).astype(np.float32)
    probs = rng.rand(B, A, C).astype(np.float32)
    scores, labels = probs.max(-1), probs.argmax(-1) + 1
    valid = rng.rand(B, A) > 0.1
    notes = []
    for kind in ('multi_classes_nms', 'class_specific_nms'):
        for lists in (False, True):
            cfg = CfgNode({'NMS_TYPE': kind, 'NMS_THRESH': [0.1 + 0.05 * c for c in range(C)]
                           if lists else 0.2, 'NMS_PRE_MAXSIZE': [64 + 16 * c for c in range(C)]
                           if lists else 128, 'NMS_POST_MAXSIZE': [64 + 16 * c for c in range(C)]
                           if lists else 128})
            out = {}
            for dev in ('cpu', 'cuda'):
                t = [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels, valid, probs)]
                res = model_nms.dispatch_nms(t[0], t[1], t[2], t[3], cfg, C, cls_probs=t[4],
                                             score_thresh=0.3)
                out[dev] = [r.cpu() for r in res]
            if not all(torch.equal(g, w) for g, w in zip(out['cuda'], out['cpu'])):
                raise SystemExit(f'[{phase}] FAILED: {kind} ({"lists" if lists else "scalars"}) '
                                 'differs between CUDA and the CPU')
            notes.append(f'{kind} {"per-class lists" if lists else "scalars"}: '
                         f'{int(out["cpu"][3].sum())} kept of {out["cpu"][3].numel()} slots')
    log(phase, f'per-class NMS on CUDA == CPU (slot order, boxes, scores, labels, keep mask) at '
        f'B={B}, {A} candidates of {C} classes: ' + '; '.join(notes))


def nuscenes_cuda_vs_cpu_phase(name: str, cfg, synthetic) -> None:
    """Phase 51: the tiny shrink (`synthetic.tiny_nuscenes_cfg`) on CUDA
    against the CPU at B=2, N=4096, every head group's score gate open: the
    forward within FWD_RTOL of scale, detections matched by box and label,
    every loss term within LOSS_RTOL and every gradient within GRAD_RTOL
    relative L2 (cosine GRAD_COSINE)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '51 nuscenes cuda-vs-cpu'
    tiny = synthetic.tiny_nuscenes_cfg(cfg)
    cpu_in = nuscenes_batch(tiny, synthetic, 2, 4096, 4, 'cpu', train=True)
    gpu_in = {k: v.cuda() for k, v in cpu_in.items()}
    cpu_net = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want, got = flatten(cpu_net(dict(cpu_in))), flatten(gpu_net(dict(gpu_in)))
    worst = 0.0
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        rel = float((got[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {name} {k}: max |diff| / max |cpu| = {rel:.3e}')
    note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(gpu_in)).items()},
                            cpu_net.predict(dict(cpu_in)), phase)
    c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
        phase, name, {'cpu': cpu_net, 'cuda': gpu_net}, {'cpu': cpu_in, 'cuda': gpu_in},
        GRAD_RTOL, GRAD_COSINE)
    log(phase, f'tiny {name} B=2 N=4096 ({len(gpu_net.dense_head.head_names)} head groups): '
        f'{len(want)} outputs agree, worst max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); '
        f'predict: {note}; loss {g_tb["loss"]:.6f} on CUDA vs {c_tb["loss"]:.6f} on the CPU, '
        f'{len(c_tb)} terms; {n} gradients agree, worst relative L2 {worst_g:.3e} at {worst_k} '
        f'(bound {GRAD_RTOL:g})')


def nuscenes_predict_phase(name: str, cfg, wrappers, synthetic, card: str) -> dict:
    """Phase 52: `predict` at full width, B=4 on clouds of NUSCENES_POINTS
    points of 5 features, every head group's score gate open
    (`measured_predict`)."""
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = nuscenes_batch(cfg, synthetic, 4, NUSCENES_POINTS, 5, 'cuda', train=False)
    return measured_predict('52 nuscenes predict', name, cfg, net, inputs, 4,
                            f'N={NUSCENES_POINTS}, 5 features, '
                            f'{len(net.dense_head.head_names)} head groups', wrappers, card)


def nuscenes_train_phase(name: str, cfg, wrappers, synthetic, card: str) -> dict:
    """Phase 53: five training steps at BATCH_SIZE_PER_GPU (4), full width
    (`measured_train`)."""
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    net = synthetic.random_model(cfg, seed=7)     # no device named: the card
    batch = nuscenes_batch(cfg, synthetic, B, NUSCENES_POINTS, 5, 'cuda', train=True)
    return measured_train('53 nuscenes train', name, cfg, net, batch,
                          f'B={B} N={NUSCENES_POINTS}', wrappers, card)


def nuscenes_loop_cfg(cfg_from_yaml_file, root: Path):
    """`pdm_ssd_nuscenes.yaml` as shipped, reading the generated mini set at
    `root`: no VERSION subdirectory, the train infos also the test split's
    (the set's one scene is a train scene)."""
    cfg = cfg_from_yaml_file(str(REPO / NUSCENES_CFG))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    cfg.DATA_CONFIG.VERSION = ''
    cfg.DATA_CONFIG.INFO_PATH['test'] = list(cfg.DATA_CONFIG.INFO_PATH['train'])
    return cfg


def nds_note(ret: dict) -> str:
    return (f'NDS {ret["NDS"]:.4f}, mAP {ret["mAP"]:.4f}, car AP {ret["car_AP"]:.4f}, mATE '
            f'{ret["mTRANSE"]:.4f}, mASE {ret["mSCALEE"]:.4f}, mAOE {ret["mORIENTE"]:.4f}')


def check_nds(phase: str, ret: dict) -> None:
    keys = ['NDS', 'mAP', 'mTRANSE', 'mSCALEE', 'mORIENTE'] + [k for k in ret if k.endswith('_AP')]
    if len(keys) < 15 or not all(np.isfinite(float(ret[k])) for k in keys):
        raise SystemExit(f'[{phase}] FAILED: nuScenes metrics missing or not finite: '
                         f'{ {k: ret.get(k) for k in keys} }')


def to_cuda_tree(x):
    """`x` with every tensor in it, through dicts and lists, on the card (a
    CPU forward's maps, for the card's post-processing)."""
    if isinstance(x, torch.Tensor):
        return x.cuda()
    if isinstance(x, dict):
        return {k: to_cuda_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cuda_tree(v) for v in x)
    return x


def above(det: dict, cut: torch.Tensor) -> dict:
    """`det` with the kept boxes scoring at most `cut` (B,) masked out."""
    return {**det, 'pred_mask': det['pred_mask'] & (det['pred_scores'] > cut[:, None])}


def tie_level(hm: dict) -> torch.Tensor:
    """Per cloud of a heatmap decode, the highest candidate score that two
    candidates share, or the lowest candidate score if higher (a tie may
    straddle the top-K cut), plus TIE_MARGIN: below it the order among exact
    ties, which float32 rounding of the convolutions may change, decides
    what NMS keeps."""
    cuts = []
    for s in hm['pred_scores'].cpu():
        vals, counts = torch.unique(s, return_counts=True)
        tied = vals[counts > 1]
        floor = float(s.min())
        cuts.append(max(float(tied.max()) if len(tied) else 0.0, floor) + TIE_MARGIN)
    return torch.tensor(cuts)


def twins(got: dict, want: dict, phase: str, side: str) -> None:
    """Every kept box of `want` has a kept box of `got` with its label within
    ROI_MATCH_ATOL."""
    for f in range(want['pred_mask'].shape[0]):
        wm, gm = want['pred_mask'][f], got['pred_mask'][f]
        wb, wl = want['pred_boxes'][f][wm], want['pred_labels'][f][wm]
        gb, gl = got['pred_boxes'][f][gm], got['pred_labels'][f][gm]
        for i in range(len(wb)):
            ok = ((gb - wb[i]).abs().amax(-1) <= ROI_MATCH_ATOL) & (gl == wl[i])
            if not bool(ok.any()):
                raise SystemExit(f'[{phase}] FAILED: a {side} box above the tie level has no '
                                 'twin on the other side')


def nuscenes_check_clouds(cfg, root, synthetic) -> dict:
    """The clouds of phase 54's CUDA-vs-CPU passes, B=2 a batch: the first
    NUSCENES_CPU_FRAMES frames of the mini set, and 4 clouds of
    `synthetic.nuscenes_points` that fill the range."""
    from pdm_ssd_torch.datasets import build_dataloader
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, root_path=root,
                                     workers=0, training=False)
    ds.infos = ds.infos[:NUSCENES_CPU_FRAMES]
    np.random.seed(1)
    return {'the mini set': [torch.from_numpy(b['points']) for b in loader],
            'range-filling clouds': [torch.from_numpy(synthetic.nuscenes_points(
                2, NUSCENES_POINTS, seed)) for seed in (21, 22)]}


def nuscenes_cuda_vs_cpu(phase: str, net, cfg, synthetic, sources: dict,
                         detections: bool) -> str:
    """`net` on the card against a copy of its weights on the CPU, on each
    batch of `sources`: the forward within FWD_RTOL of scale. With
    `detections`, also the kept boxes that score above every tied candidate
    score (`tie_level`), on the CPU's maps post-processed on the card and
    on each side's own maps, matched by box and label both ways, and at
    least one such box. A tie of exactly equal candidate scores, as in
    cells whose features are constant (no point in the receptive field, or
    every activation cut by a ReLU: seeded weights at full width tie all
    but one kept box a cloud, even on clouds that fill the range), is
    ordered differently by the two devices' top-K, so even on the same maps
    the two runs keep other boxes below it (255 against 256 for the 4-step
    checkpoint, whose top scores all tie). Returns the note to log."""
    cpu_net = synthetic.random_model(cfg, 'cpu')
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    notes, n_untied = [], 0
    for source, batches in sources.items():
        worst, n_cmp, n_kept, cuts = 0.0, 0, 0, []
        for pts in batches:
            with torch.inference_mode():
                out = cpu_net({'points': pts})
                gout = net({'points': pts.cuda()})
                for k, w in flatten(out).items():
                    if w.dtype.is_floating_point:
                        g = flatten(gout)[k].cpu()
                        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
                        worst = max(worst, rel)
                        if not rel <= FWD_RTOL:
                            raise SystemExit(f'[{phase}] FAILED {source} {k}: max |diff| / '
                                             f'max |cpu| = {rel:.3e}')
                if not detections:
                    continue
                want = cpu_net.post_process(out)
                moved = to_cuda_tree(out)
                shared = {k: v.cpu() for k, v in net.post_process(moved).items()}
                own = {k: v.cpu() for k, v in net.post_process(gout).items()}
                cut = tie_level(cpu_net.dense_head.generate_predicted_boxes(dict(out)))
            # a box above the cut plus the margin has a twin among the other
            # run's above the cut (rounding moves a score by far less)
            for got, kind in ((shared, 'shared maps'), (own, 'own maps')):
                twins(above(got, cut), above(want, cut + TIE_MARGIN), phase, f'CPU ({kind})')
                twins(above(want, cut), above(got, cut + TIE_MARGIN), phase, f'CUDA ({kind})')
            n_cmp += int(above(want, cut + TIE_MARGIN)['pred_mask'].sum())
            n_kept += int(want['pred_mask'].sum())
            cuts += [round(float(c), 4) for c in cut]
        note = f'{source}: forward within {worst:.3e} of scale (bound {FWD_RTOL:g})'
        if detections:
            note += (f'; {n_cmp} of {n_kept} kept boxes above the tie levels {cuts}, each with a '
                     'twin on the CPU\'s maps post-processed on the card and on its own maps')
        notes.append(note)
        n_untied += n_cmp
    if detections and n_untied == 0:
        raise SystemExit(f'[{phase}] FAILED: no kept box scores above the tie levels, so the '
                         'two runs\' detections were not compared')
    return ' | '.join(notes)


def nuscenes_loop_phases(wrappers, synthetic, card: str, cfg_from_yaml_file) -> dict:
    """Phase 54: the port's mini nuScenes set (NUSCENES_SAMPLES frames at
    NUSCENES_SWEEPS sweeps, generated under `build/chip_smoke_nuscenes/`),
    `pdm_ssd_nuscenes.yaml` as shipped: `eval_one_epoch` at B=4 of seeded
    weights with the score gate open (NDS, mAP, `infer_fps`, `loop_fps`, no
    launch) and those weights on CUDA against the CPU, forward and the
    detections above the tie level (`nuscenes_cuda_vs_cpu`), then
    `train_model` for 2 epochs (CBGS on, a checkpoint an epoch, no launch),
    then the trained checkpoint (its score gate opened) through the eval
    loop and its forward on CUDA against the CPU (its top scores all tie
    after so few steps, so no detection lies above the tie level). Returns
    the launches of the two loops, by path name."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    from pdm_ssd_torch.tools.make_mini_nuscenes import make
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    root = make(NUSCENES_DIR, samples=NUSCENES_SAMPLES, max_sweeps=NUSCENES_SWEEPS)
    cfg = nuscenes_loop_cfg(cfg_from_yaml_file, root)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    phase = '54 nuscenes eval loop'
    log(phase, f'mini-nuScenes: {NUSCENES_SAMPLES} frames at {NUSCENES_SWEEPS} sweeps generated '
        f'in {time.perf_counter() - t0:.1f} s')
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                     workers=4, training=False)
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / 'eval_seeded')
    paths = {'nuscenes_eval_loop': read_launches(wrappers)}
    if paths['nuscenes_eval_loop'] != NO_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["nuscenes_eval_loop"]}')
    check_nds(phase, ret)
    annos = pickle.loads((root / 'eval_seeded' / 'result.pkl').read_bytes())
    log(phase, f'pdm_ssd_nuscenes.yaml as shipped, seeded weights (score gate open), B={B} over '
        f'{len(ds)} frames ({len(loader)} batches): {sum(len(a["name"]) for a in annos)} '
        f'detections; {nds_note(ret)}; recall@0.3/0.5/0.7 {ret["recall/rcnn_0.3"]:.4f}/'
        f'{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; predict alone '
        f'{ret["infer_fps"]:.2f} frames/s, the loop with loading {ret["loop_fps"]:.2f} frames/s; '
        f'no kernel of the port launched, on {card}')
    sources = nuscenes_check_clouds(cfg, root, synthetic)
    log(phase, 'the same weights on CUDA vs the CPU at B=2, N='
        f'{NUSCENES_POINTS}: ' + nuscenes_cuda_vs_cpu(phase, net, cfg, synthetic, sources,
                                                      detections=True))

    phase = '54 nuscenes train loop'
    epochs = 2
    tds, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                       workers=4, training=True, seed=0)
    ckpt_dir = root / 'ckpt'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(tloader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    steps = StepLog()
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    losses = trainer.train_model(net, optimizer, sched, tloader, epochs, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths['nuscenes_train_loop'] = read_launches(wrappers)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth']:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}, checkpoints {names}')
    if paths['nuscenes_train_loop'] != NO_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["nuscenes_train_loop"]}')
    log(phase, f'pdm_ssd_nuscenes.yaml B={B}, {len(tds)} frames after CBGS, {epochs} epochs of '
        f'{len(tloader)} steps: mean losses {" ".join(f"{x:.4f}" for x in losses)}; '
        f'{seconds:.1f} s with loading; checkpoints left {names}; no kernel of the port '
        f'launched, on {card}')
    log(phase, steps.summary(len(tloader)))

    np.random.seed(0)
    trained = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(ckpt_dir / names[-1], trained)
    ret = eval_one_epoch(trained, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / 'eval_trained')
    check_nds(phase, ret)
    log(phase, f'the checkpoint of epoch {epochs} over the {len(ds)} frames: {nds_note(ret)}; '
        f'predict alone {ret["infer_fps"]:.2f} frames/s, with loading {ret["loop_fps"]:.2f} '
        'frames/s (no threshold)')
    synthetic.open_score_gate(trained)
    log(phase, 'the trained checkpoint, score gate opened, on CUDA vs the CPU at B=2, N='
        f'{NUSCENES_POINTS}: ' + nuscenes_cuda_vs_cpu(phase, trained, cfg, synthetic, sources,
                                                      detections=False))
    return paths


def nuscenes_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 51 to 54. Returns the kernel launches of each path, by name."""
    per_class_nms_phase()
    for name in NUSCENES_MODELS:
        nuscenes_cuda_vs_cpu_phase(name, nuscenes_cfg(cfg_from_yaml_file, name), synthetic)
    paths = {}
    for name in NUSCENES_MODELS:
        paths[f'{name}_predict'] = nuscenes_predict_phase(
            name, nuscenes_cfg(cfg_from_yaml_file, name), wrappers, synthetic, smi)
        torch.cuda.empty_cache()
    for name in NUSCENES_MODELS:
        paths[f'{name}_train'] = nuscenes_train_phase(
            name, nuscenes_cfg(cfg_from_yaml_file, name), wrappers, synthetic, smi)
        torch.cuda.empty_cache()
    paths.update(nuscenes_loop_phases(wrappers, synthetic, smi, cfg_from_yaml_file))
    return paths


# phases 55 to 58: DSVT (`dsvt.yaml`: the window-attention BEV backbone under
# CenterHead) and TransFusion (`transfusion.yaml`: the query decoder with its
# host LAP), which launch none of the port's kernels (pillarize is
# `index_add_`, the attention plain matmuls and softmax, the convolutions
# cuDNN's, the LAP numpy on the host)
QUERY_MODELS = (('dsvt', 'configs/kitti_models/dsvt.yaml'),
                ('transfusion', 'configs/kitti_models/transfusion.yaml'))
# points a cloud: the files' `sample_points`
QUERY_POINTS = 16384
# the paths of phases 56 to 58 whose counts the kernels line must carry
QUERY_PATHS = ('predict', 'train', 'eval_loop', 'train_loop')


def flatten_all(out: dict) -> dict:
    """`flatten`, and the tensors of the dict entries (TransFusion's
    'transfusion_preds' and 'transfusion_query') as `<entry>.<name>`."""
    flat = flatten(out)
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update({f'{k}.{n}': t for n, t in v.items() if isinstance(t, torch.Tensor)})
    return flat


class QueryReplay:
    """While active, TransFusion's query pick (`two_stage_topk` of its
    heatmap scores) records the CPU run's picks and hands each to the next
    CUDA run, which takes its own scores at the CPU's cells: a seeded
    model's heatmap ties exactly at cells of constant features (no point
    near them), and the two devices' top-K order such ties differently, so
    without the replay the two runs would decode other queries. The CUDA
    run's own picks are checked against the CPU's: every cell the CPU picks
    above the tie level of its scores (`tie_level`'s rule) is among them.
    `notes` counts those cells per pick."""

    def __init__(self):
        from pdm_ssd_torch.models.dense_heads import transfusion_head
        self.module, self.topk = transfusion_head, transfusion_head.two_stage_topk
        self.picks, self.notes = [], []

    def pick(self, x: torch.Tensor, k: int):
        vals, idx = self.topk(x, k)
        if not x.is_cuda:
            self.picks.append((x.detach(), vals.detach(), idx))
            return vals, idx
        cpu_x, cpu_vals, cpu_idx = self.picks.pop(0)
        n_above = 0
        for b in range(x.shape[0]):
            scores, counts = torch.unique(cpu_x[b], return_counts=True)
            tied = scores[counts > 1]
            cut = (float(tied.max()) if len(tied) else float('-inf')) + TIE_MARGIN
            want = set(cpu_idx[b][cpu_vals[b] > cut].tolist())
            if not want <= set(idx[b].cpu().tolist()):
                raise SystemExit('[55 query cuda-vs-cpu] FAILED: a query the CPU picks above '
                                 'the tie level is not among the CUDA run\'s own picks')
            n_above += len(want)
        self.notes.append(f'{n_above} of {cpu_idx.numel()}')
        cpu_idx = cpu_idx.to(x.device)
        return torch.gather(x, 1, cpu_idx), cpu_idx

    def __enter__(self):
        self.module.two_stage_topk = self.pick
        return self

    def __exit__(self, *exc):
        self.module.two_stage_topk = self.topk


def assignment_note(phase: str, nets: dict, batches: dict) -> str:
    """TransFusion's `assign_targets` on a training forward of each device
    (the queries replayed): the same query for every ground-truth box, or,
    where a near-tied cost lets the LAP choose another optimum, the same
    total cost on the CPU's cost matrix within 1e-5 relative."""
    outs, q = {}, {}
    with QueryReplay():
        for dev in ('cpu', 'cuda'):
            nets[dev].train()
            with torch.no_grad():
                outs[dev] = nets[dev](dict(batches[dev]))
                q[dev] = nets[dev].dense_head.assign_targets(outs[dev])['q_of_gt'].cpu()
            nets[dev].eval()
    mask = batches['cpu']['gt_mask']
    if torch.equal(q['cpu'], q['cuda']):
        return f'q_of_gt equal ({int(mask.sum())} boxes)'
    with torch.no_grad():
        cost = nets['cpu'].dense_head.matching_cost(outs['cpu']).transpose(1, 2).double()

    def total(qg):
        return float(torch.where(mask, torch.gather(cost, 2, qg.long().clamp(min=0)[..., None])
                                 [..., 0], 0.0).sum())
    want, got = total(q['cpu']), total(q['cuda'])
    if not abs(got - want) <= 1e-5 * abs(want):
        raise SystemExit(f'[{phase}] FAILED: q_of_gt {q["cuda"].tolist()} on CUDA vs '
                         f'{q["cpu"].tolist()} on the CPU, total cost {got} vs {want}')
    return (f'q_of_gt differs in {int((q["cpu"] != q["cuda"]).sum())} boxes, the same total cost '
            f'{got:.6f} vs {want:.6f} (a near tie)')


def query_cuda_vs_cpu_phase(name: str, cfg, synthetic) -> None:
    """Phase 55: the tiny shrink (`synthetic.TINY_CFGS`) on CUDA against the
    CPU at B=2 on clouds of QUERY_POINTS points with 8 boxes, the same
    seeded weights, a heatmap head's score gate open: every forward
    output within FWD_RTOL of scale; DSVT's kept boxes above the tie level
    of its heatmap decode with a twin both ways (as phase 54 holds them),
    TransFusion's detections (no NMS) matched by box and label with the
    queries replayed (`QueryReplay`) and its assignment (`assignment_note`);
    every loss term within LOSS_RTOL and every gradient within GRAD_RTOL
    relative L2 (cosine GRAD_COSINE)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '55 query cuda-vs-cpu'
    tiny = synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    cpu_in = to_device(synthetic.kitti_batch(2, QUERY_POINTS, 8, seed=4), 'cpu')
    gpu_in = {k: v.cuda() for k, v in cpu_in.items()}
    nets = {dev: synthetic.open_score_gate(synthetic.random_model(tiny, dev))
            for dev in ('cpu', 'cuda')}
    batches = {'cpu': cpu_in, 'cuda': gpu_in}
    query = name == 'transfusion'
    replay = QueryReplay() if query else contextlib.nullcontext()
    with torch.inference_mode(), replay:
        want, got = (flatten_all(nets[dev](dict(batches[dev]))) for dev in ('cpu', 'cuda'))
        if query:
            det = {dev: nets[dev].predict(dict(batches[dev])) for dev in ('cpu', 'cuda')}
    worst = 0.0
    for k, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        rel = float((got[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {name} {k}: max |diff| / max |cpu| = {rel:.3e}')
    if query:
        note = match_detections({k: v.cpu() for k, v in det['cuda'].items()}, det['cpu'], phase)
        note += (f'; the CPU\'s picks above the tie level among CUDA\'s own: '
                 f'{", ".join(replay.notes)}; ' + assignment_note(phase, nets, batches))
    else:
        note = nuscenes_cuda_vs_cpu(phase, nets['cuda'], tiny, synthetic,
                                    {'clouds': [cpu_in['points'][:1], cpu_in['points'][1:]]},
                                    detections=True)
    with QueryReplay() if query else contextlib.nullcontext():
        c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(phase, name, nets, batches,
                                                               GRAD_RTOL, GRAD_COSINE)
    log(phase, f'tiny {name} B=2 N={QUERY_POINTS}: {len(want)} outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); {note}; loss '
        f'{g_tb["loss"]:.6f} on CUDA vs {c_tb["loss"]:.6f} on the CPU, {len(c_tb)} terms; {n} '
        f'gradients agree, worst relative L2 {worst_g:.3e} at {worst_k} (bound {GRAD_RTOL:g})')


class LapTimer:
    """While active, times each host LAP of TransFusion's `assign_targets`
    (`ops/lap.lap_host`: the cost copied to the host, the Jonker-Volgenant
    solve, the assignment copied back), the device synchronized first so
    that the time is the LAP's alone."""

    def __init__(self):
        from pdm_ssd_torch.models.dense_heads import transfusion_head
        self.module, self.lap = transfusion_head, transfusion_head.lap_host
        self.seconds = []

    def timed(self, cost, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.lap(cost, mask)
        self.seconds.append(time.perf_counter() - t0)
        return out

    def __enter__(self):
        self.module.lap_host = self.timed
        return self

    def __exit__(self, *exc):
        self.module.lap_host = self.lap


def query_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 55 to 58. Returns the kernel launches of each path, by name."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file))

    for name, cfg_file in QUERY_MODELS:
        query_cuda_vs_cpu_phase(name, load(cfg_file), synthetic)
    paths = {}
    for name, cfg_file in QUERY_MODELS:
        cfg = load(cfg_file)
        B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
        net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
        inputs = {'points': torch.from_numpy(synthetic.kitti_points(B, QUERY_POINTS, 5)).cuda()}
        paths[f'{name}_predict'] = measured_predict(
            '56 query predict', f'{name} as shipped', cfg, net, inputs, B, f'N={QUERY_POINTS}',
            wrappers, smi, P=cfg.MODEL.DENSE_HEAD.get('NUM_PROPOSALS', None),
            flops='convolutions and matrix products')
        del net, inputs
        torch.cuda.empty_cache()
    for name, cfg_file in QUERY_MODELS:
        cfg = load(cfg_file)
        B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
        net = synthetic.random_model(cfg, seed=7)          # no device named: the card
        batch = to_device(synthetic.kitti_batch(B, QUERY_POINTS, 8, seed=5), 'cuda')
        with LapTimer() as lap:
            paths[f'{name}_train'] = measured_train('57 query train', f'{name} as shipped', cfg,
                                                    net, batch, f'B={B} N={QUERY_POINTS}',
                                                    wrappers, smi)
        if lap.seconds:
            log('57 query train', f'{name}: the host LAP of each step (cost to the host, '
                'Jonker-Volgenant over the 8 clouds, the assignment back) '
                + ' '.join(f'{s * 1e3:.3f}' for s in lap.seconds) + ' ms, median '
                f'{statistics.median(lap.seconds) * 1e3:.3f} ms')
        del net, batch
        torch.cuda.empty_cache()
    for name, cfg_file in QUERY_MODELS:
        B = load(cfg_file).OPTIMIZATION.BATCH_SIZE_PER_GPU
        paths[f'{name}_eval_loop'] = kitti_eval_phase(
            wrappers, synthetic, smi, cfg_file, '58 query eval loop', NO_LAUNCHES,
            adjust=synthetic.open_score_gate, cpu_check=False, B=B)
        paths[f'{name}_train_loop'] = train_loop_phase(
            wrappers, synthetic, smi, cfg_file, '58 query train loop', NO_LAUNCHES, B=B,
            frames=TWO_STAGE_LOOP_FRAMES)
    return paths


# ---- MPPNet on the Waymo sequence path: phases 59 to 62 ----------------------------

MPPNET_CFG = 'configs/waymo_models/mppnet_16frame.yaml'
MPPNET_MINI_CFG = 'configs/waymo_models/mppnet_mini.yaml'
WAYMO_DIR = REPO / 'build' / 'chip_smoke_waymo'
# the full-width set: one sequence of 20 frames (a whole 16-frame history
# from frame 15 on), 12000 background points and 480 object points a frame,
# so that 16 frames hold more than the file's 163840 points a sample
WAYMO_FRAMES = 20
WAYMO_BG = 12000
# the full-width batches' two clouds, the sequence's last two frames
WAYMO_CLOUDS = (18, 19)
# phase 61's streams: cloud b walks frames b * 3 .. b * 3 + 16, one a step
MPPNET_STREAM_STEPS = 17
MPPNET_PATHS = ('predict', 'predbox_predict', 'stream', 'train', 'eval_loop', 'train_loop')


def mppnet_launches(frames: int) -> dict:
    """The launches of one MPPNet forward over `frames` frames: one row
    gather a frame, the crop of its points (`gather_rows`). The points take
    no gradient, so a training step runs no scatter-add; its backward
    recomputes each frame's crops (`layers.checkpoint_call`), twice the
    forward's gathers."""
    return {**NO_LAUNCHES, 'gather_rows': frames}


def waymo_cfg(cfg_from_yaml_file, cfg_file: str = MPPNET_CFG, predbox: bool | None = None):
    """A Waymo config; `mppnet_16frame.yaml` with `synthetic.waymo_voxel_step`
    (its data path has no voxel step, ROADMAP Queue 3); with `predbox`,
    USE_PREDBOX set so."""
    from pdm_ssd_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(REPO / cfg_file))
    synthetic.waymo_voxel_step(cfg)
    if predbox is not None:
        cfg.DATA_CONFIG.USE_PREDBOX = predbox
    return cfg


class StageTimer:
    """While active, times MPPNet's stages in each `predict` of `net`, the
    device synchronized around each: the first stage, the proposals (the
    NMS, or the offline proposals), each frame's crops (`pool_roi_points`
    and the point gather), its point features and its aggregation onto the
    proxies (`aggregate`), and the final NMS (`post_process`); the rest
    (the motion features, the trajectory branch, the transformer) is the
    whole predict less these. `report(total_ms, n)` sums them a predict."""

    def __init__(self, net):
        from pdm_ssd_torch.models.roi_heads import mppnet_head
        from pdm_ssd_torch.ops import dispatch
        self.net, self.module, self.dispatch = net, mppnet_head, dispatch
        self.ms = {k: 0.0 for k in ('stage 1', 'proposals', 'crops', 'frame features',
                                    'aggregation', 'final NMS')}

    def timed(self, fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def __enter__(self):
        head = self.net.roi_head
        self.saved = (self.module.pool_roi_points, self.dispatch.grouping_operation)
        self.module.pool_roi_points = self.timed(self.saved[0], 'crops')
        self.dispatch.grouping_operation = self.timed(self.saved[1], 'crops')
        self.net.first_stage = self.timed(self.net.first_stage, 'stage 1')
        self.net.post_process = self.timed(self.net.post_process, 'final NMS')
        head.proposal_layer = self.timed(head.proposal_layer, 'proposals')
        head.aggregate = self.timed(head.aggregate, 'aggregation')
        head.frame_geometry = self.timed(head.frame_geometry, 'frame features')
        return self

    def __exit__(self, *exc):
        self.module.pool_roi_points, self.dispatch.grouping_operation = self.saved
        for obj, name in ((self.net, 'first_stage'), (self.net, 'post_process'),
                          (self.net.roi_head, 'proposal_layer'), (self.net.roi_head, 'aggregate'),
                          (self.net.roi_head, 'frame_geometry')):
            delattr(obj, name)

    def report(self, total_ms: float, n: int) -> str:
        ms = {k: v / n for k, v in self.ms.items()}
        ms['frame features'] -= ms['crops'] + ms['aggregation']     # frame_geometry holds both
        ms['motion, trajectory branch, transformer'] = total_ms - sum(ms.values())
        return ', '.join(f'{k} {v:.3f}' for k, v in ms.items()) + f' ms of {total_ms:.3f} ms'


def mppnet_cuda_vs_cpu_phase(synthetic, cfg_from_yaml_file) -> None:
    """Phase 59: the tiny `mppnet_mini.yaml` (`synthetic.tiny_mppnet_cfg`)
    on CUDA (the row gather's kernel) against the CPU (its plain version) on
    two clouds of a generated mini-Waymo set, one set of seeded weights:
    the forward on the offline proposals within FWD_RTOL of scale, the
    trajectories' validity equal; on the first stage's NMS proposals, the
    proposals matched by box (`match_rois`), then the CUDA run given the
    CPU's (`ProposalReplay`) within FWD_RTOL; three streamed steps of
    `predict_with_state` with the proposals' slots permuted a step, the bank
    after each (boxes and validity equal, features within FWD_RTOL) and the
    detections matched by box and label; the training loss within LOSS_RTOL
    and every gradient within GRAD_RTOL relative L2 (cosine GRAD_COSINE)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pdm_ssd_torch.ops import group
    phase = '59 mppnet cuda-vs-cpu'
    tiny = synthetic.tiny_mppnet_cfg(cfg_from_yaml_file(str(REPO / MPPNET_MINI_CFG)))
    ds = synthetic.waymo_set(tiny, WAYMO_DIR / 'tiny', 8, n_bg=1200)
    np.random.seed(0)
    ins = {'cpu': synthetic.waymo_batch(ds, (5, 7), 'cpu')}
    ins['cuda'] = {k: v.cuda() for k, v in ins['cpu'].items()}
    nets = {dev: synthetic.random_model(tiny, dev) for dev in ('cpu', 'cuda')}
    worst = [0.0]

    def close(want: dict, got: dict, what: str) -> None:
        for k, w in want.items():
            g = got[k].cpu()
            if not w.dtype.is_floating_point:
                if not torch.equal(g, w):
                    raise SystemExit(f'[{phase}] FAILED {what} {k}: differs on CUDA')
                continue
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            worst[0] = max(worst[0], rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {what} {k}: max |diff| / max |cpu| = '
                                 f'{rel:.3e}')

    launches = group.gather_rows_cuda.launches
    with torch.inference_mode():
        want, got = (flatten(nets[dev](dict(ins[dev]))) for dev in ('cpu', 'cuda'))
    if group.gather_rows_cuda.launches - launches != 4:
        raise SystemExit(f'[{phase}] FAILED: {group.gather_rows_cuda.launches - launches} '
                         'row-gather launches for 4 frames')
    close(want, got, 'offline proposals')
    n_match = int(want['trajectory_valid'][:, 1:].sum())

    nms_in = {dev: {k: v for k, v in b.items() if not k.startswith('roi_')}
              for dev, b in ins.items()}
    with torch.inference_mode():
        first = {dev: nets[dev](dict(nms_in[dev])) for dev in ('cpu', 'cuda')}
    _, _, roi_note = match_rois({k: first['cuda'][k].cpu() for k in ROI_KEYS[:4]},
                                {k: first['cpu'][k] for k in ROI_KEYS[:4]}, phase)
    with ProposalReplay(nets['cpu'], nets['cuda']), torch.inference_mode():
        want, got = (flatten(nets[dev](dict(nms_in[dev]))) for dev in ('cpu', 'cuda'))
    close(want, got, 'NMS proposals')

    R = tiny.DATA_CONFIG.SEQUENCE_CONFIG.MAX_PRED_BOXES
    mems = {dev: nets[dev].init_memory(2, R) for dev in ('cpu', 'cuda')}
    rng = np.random.RandomState(3)
    notes = []
    for s in range(3):
        np.random.seed(10 + s)
        step = synthetic.waymo_batch(ds, (5, 7), 'cpu')
        step.pop('points_multi_frame')
        perm = torch.from_numpy(rng.permutation(R))
        for k in ('roi_boxes', 'roi_scores', 'roi_labels'):
            step[k] = step[k][:, :, perm]
        dets = {}
        for dev in ('cpu', 'cuda'):
            dets[dev], mems[dev] = nets[dev].predict_with_state(
                {**{k: v.to(dev) for k, v in step.items()}, 'mppnet_memory': mems[dev]})
        close({k: mems['cpu'][k] for k in ('rois', 'valid')},
              {k: mems['cuda'][k] for k in ('rois', 'valid')}, f'bank step {s}')
        if not torch.equal(mems['cuda']['rois'].cpu(), mems['cpu']['rois']):
            raise SystemExit(f'[{phase}] FAILED: the bank\'s boxes after step {s} differ')
        close({'feat': mems['cpu']['feat']}, {'feat': mems['cuda']['feat']}, f'bank step {s}')
        notes.append(match_detections({k: v.cpu() for k, v in dets['cuda'].items()},
                                      dets['cpu'], phase))

    R_train = tiny.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE
    draw = roi_draw(2, R_train, 9)
    batches = {dev: {**ins[dev], 'roi_target_rand': draw.to(dev)} for dev in ('cpu', 'cuda')}
    c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(phase, 'mppnet', nets, batches,
                                                           GRAD_RTOL, GRAD_COSINE)
    log(phase, f'tiny mppnet_mini B=2 T=4: forward on offline proposals ({n_match} of '
        f'{int(want["roi_mask"].sum()) * 3} past frames matched) and on NMS proposals'
        f'{roi_note}, then replayed: worst max|diff|/max|cpu| = {worst[0]:.3e} (bound '
        f'{FWD_RTOL:g}), 4 row-gather launches a forward; 3 streamed steps, the bank equal '
        f'after each, detections: {"; ".join(notes)}; loss {g_tb["loss"]:.6f} on CUDA vs '
        f'{c_tb["loss"]:.6f} on the CPU, {len(c_tb)} terms; {n} gradients agree, worst '
        f'relative L2 {worst_g:.3e} at {worst_k} (bound {GRAD_RTOL:g})')


def mppnet_full_phases(wrappers, synthetic, card: str, cfg_from_yaml_file) -> dict:
    """Phases 60 and 61: `mppnet_16frame.yaml` at full width, B=2 (its
    BATCH_SIZE_PER_GPU): T=16 frames of 16384 points, 96 proposals, 64
    proxies, 128 points a crop, d=256, 3 encoder layers of 4 heads, batches
    from the generated set through `WaymoDataset.__getitem__` and
    `collate_batch`, the anchor bias at 0. 60: `predict` as shipped (the
    first stage's NMS proposals, PRE 512 POST 96; static trajectories), its
    stages (`StageTimer`), then on the offline proposals (USE_PREDBOX), then
    `predict_with_state` streamed over MPPNET_STREAM_STEPS frames of each
    cloud, its last step profiled (`device_profile`); the row gather at the
    crops' shape against its plain version (`mppnet_crop_check`). 61: five
    training steps (as shipped), then a profiled one
    (`profiled_train_step`). Returns the launches of each path
    and the crop gather's times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = WAYMO_DIR / 'full'
    cfg = waymo_cfg(cfg_from_yaml_file)
    T = cfg.MODEL.ROI_HEAD.NUM_FRAMES
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    t0 = time.perf_counter()
    ds = synthetic.waymo_set(cfg, root, WAYMO_FRAMES, n_bg=WAYMO_BG)
    np.random.seed(0)
    inputs = synthetic.waymo_batch(ds, WAYMO_CLOUDS, 'cuda')
    host_s = time.perf_counter() - t0
    filled = inputs['voxel_mask'].sum(1).tolist()
    what = (f'T={T}, {tuple(inputs["points_multi_frame"].shape)} frame stack, '
            f'{tuple(inputs["points"].shape)} points, {filled} of {inputs["voxel_mask"].shape[1]} '
            f'voxel slots; the set made and the batch loaded in {host_s:.1f} s')
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    paths = {'mppnet_predict': measured_predict(
        '60 mppnet predict', 'mppnet_16frame.yaml as shipped', cfg, net, inputs, B, what,
        wrappers, card, flops='convolutions and matrix products', expected=mppnet_launches(T))}
    with StageTimer(net) as st:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            net.predict(inputs)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / 3
    log('60 mppnet predict', f'stages of a predict, each synchronized: {st.report(total, 3)}')
    crop = mppnet_crop_check(net, inputs, T)

    pcfg = waymo_cfg(cfg_from_yaml_file, predbox=True)
    pds = synthetic.waymo_set(pcfg, root, WAYMO_FRAMES)
    np.random.seed(0)
    pin = synthetic.waymo_batch(pds, WAYMO_CLOUDS, 'cuda')
    paths['mppnet_predbox_predict'] = measured_predict(
        '60 mppnet predict', 'mppnet_16frame.yaml on offline proposals (USE_PREDBOX)', pcfg, net,
        pin, B, f'{int(pin["roi_boxes"][:, 0, :, 3].gt(0).sum())} offline proposals', wrappers,
        card, flops='convolutions and matrix products', expected=mppnet_launches(T))
    del pin

    R = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE
    mem = net.init_memory(B, R)
    times, kept, valid = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    for s in range(MPPNET_STREAM_STEPS):
        np.random.seed(s)
        step = synthetic.waymo_batch(ds, [b * 3 + s for b in range(B)], 'cuda')
        step.pop('points_multi_frame')
        t0 = time.perf_counter()
        det, mem = net.predict_with_state({**step, 'mppnet_memory': mem})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_detections('60 mppnet predict', det, B,
                         cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
        kept.append(int(det['pred_mask'].sum()))
        valid.append(int(mem['valid'].sum()))
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != {k: v * MPPNET_STREAM_STEPS for k, v in mppnet_launches(1).items()}:
        raise SystemExit(f'[60 mppnet predict] FAILED stream: launches {launches}')
    if not bool(torch.isfinite(mem['feat']).all()) or mem['feat'].shape != (B, T - 1, R, 64, 256):
        raise SystemExit('[60 mppnet predict] FAILED stream: the bank\'s features '
                         f'{tuple(mem["feat"].shape)}, finite {bool(torch.isfinite(mem["feat"]).all())}')
    med = statistics.median(times[1:])
    paths['mppnet_stream'] = launches
    gflop, wall_ms, device_ms = device_profile(
        lambda: net.predict_with_state({**step, 'mppnet_memory': mem}))
    log('60 mppnet predict', f'predict_with_state streamed over {MPPNET_STREAM_STEPS} frames of '
        f'{B} clouds (NMS proposals, the bank of {T - 1} past frames): median {med * 1e3:.3f} '
        f'ms/step = {B / med:.2f} frames/s (first {times[0] * 1e3:.1f} ms); kept boxes a step '
        f'{kept}; valid bank slots a step {valid}; peak allocated {peak:.3f} GiB; launches '
        f'{launches["gather_rows"]} row gathers, 1 a step; the last step again: '
        f'{gflop:.1f} GFLOP, {wall_ms:.3f} ms, device {device_ms:.3f} ms, busy '
        f'{device_ms / wall_ms:.3f} on {card}')
    del net, inputs, mem
    torch.cuda.empty_cache()

    # the training split keeps every fifth frame (SAMPLED_INTERVAL): its last two
    tds = synthetic.waymo_set(cfg, root, WAYMO_FRAMES, training=True)
    np.random.seed(1)
    batch = synthetic.waymo_batch(tds, (len(tds) - 2, len(tds) - 1), 'cuda')
    net = synthetic.random_model(cfg, seed=7)           # no device named: the card
    train_launches = {**mppnet_launches(2 * T)}
    paths['mppnet_train'] = measured_train(
        '61 mppnet train', 'mppnet_16frame.yaml as shipped', cfg, net, batch,
        f'B={B} T={T}', wrappers, card, expected=train_launches)
    profiled_train_step('61 mppnet train', 'mppnet_16frame.yaml as shipped', cfg, net, batch,
                        card)
    del net, batch
    torch.cuda.empty_cache()
    return paths, crop


def mppnet_crop_check(net, inputs: dict, T: int) -> dict:
    """The crops of one full-width predict recorded (each frame's table and
    indices): every frame's row gather equal to its plain version, and
    frame 0's timed against it, torch.gather and the bound (`gather_check`).
    Returns frame 0's times."""
    from pdm_ssd_torch.ops import group, sa_fused
    phase = '60 mppnet predict'
    rec = _GatherRecorder(sa_fused.GatherRows)
    sa_fused.GatherRows = rec
    try:
        with torch.inference_mode():
            net.predict(inputs)
    finally:
        sa_fused.GatherRows = rec.original
    if len(rec.calls) != T:
        raise SystemExit(f'[{phase}] FAILED: {len(rec.calls)} crops recorded for {T} frames')
    crop = gather_check(phase, 'mppnet crop, frame 0', group, *rec.calls[0])
    for t, (table, idx) in enumerate(rec.calls[1:], 1):
        idx = idx.to(torch.int32).contiguous()
        if not torch.equal(group.gather_rows_cuda(table, idx), group.gather_rows_plain(table, idx)):
            raise SystemExit(f'[{phase}] FAILED mppnet crop, frame {t}: gather_rows differs '
                             'from its plain version')
    log(phase, f'mppnet crops of frames 1 to {T - 1}: gather_rows == plain (exact)')
    return crop


def waymo_loop_phases(wrappers, synthetic, card: str, cfg_from_yaml_file) -> dict:
    """Phase 62: `mppnet_mini.yaml` on a fresh mini-Waymo set generated by
    `python -m pdm_ssd_torch.tools.make_mini_waymo` (8 frames): two epochs of
    `train_model` at its BATCH_SIZE_PER_GPU with a checkpoint each epoch,
    then `eval_one_epoch` of the trained checkpoint with Waymo AP and APH at
    both levels. Returns the launches of each loop."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    from pdm_ssd_torch.tools import make_mini_waymo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = WAYMO_DIR / 'mini'
    make_mini_waymo.main(['--root', str(root)])
    cfg = cfg_from_yaml_file(str(REPO / MPPNET_MINI_CFG))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    cfg.DATA_CONFIG.ROI_BOXES_PATH = {'train': str(root / 'pred_boxes.pkl'),
                                      'test': str(root / 'pred_boxes.pkl')}
    T = cfg.MODEL.ROI_HEAD.NUM_FRAMES
    B, epochs = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU, 2
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, workers=0,
                                     training=True, seed=0)
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    steps = StepLog()
    losses = trainer.train_model(net, optimizer, sched, loader, epochs, ckpt_dir=root / 'ckpt',
                                 max_ckpt_save_num=1, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    want = {k: v * epochs * len(loader) for k, v in mppnet_launches(2 * T).items()}
    names = [c.name for c in trainer.list_checkpoints(root / 'ckpt')]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth'] \
            or launches != want:
        raise SystemExit(f'[62 mppnet loops] FAILED train loop: losses {losses}, checkpoints '
                         f'{names}, launches {launches} (want {want})')
    paths = {'mppnet_train_loop': launches}
    log('62 mppnet loops', f'mppnet_mini.yaml train loop, B={B} over {len(ds)} frames, {epochs} '
        f'epochs of {len(loader)} steps: mean losses {" ".join(f"{x:.4f}" for x in losses)}; '
        f'{seconds:.1f} s with loading; checkpoints left {names}; launches '
        f'{launches["gather_rows"]} row gathers ({2 * T} a step) on {card}')
    log('62 mppnet loops', steps.summary(len(loader)))

    trained = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(root / 'ckpt' / names[-1], trained)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, workers=0,
                                       training=False)
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(trained, vloader, vds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / 'eval')
    launches = read_launches(wrappers)
    want = {k: v * len(vloader) for k, v in mppnet_launches(T).items()}
    keys = [f'{c}_L{lv}_{m}' for c in cfg.CLASS_NAMES for lv in (1, 2) for m in ('AP', 'APH')]
    if launches != want or not all(np.isfinite(ret[k]) and 0 <= ret[k] <= 1 + 1e-9
                                   for k in keys):
        raise SystemExit(f'[62 mppnet loops] FAILED eval loop: launches {launches} (want {want}), '
                         f'metrics {ret}')
    paths['mppnet_eval_loop'] = launches
    annos = pickle.loads((root / 'eval' / 'result.pkl').read_bytes())
    log('62 mppnet loops', f'mppnet_mini.yaml eval loop of the trained checkpoint, B={B} over '
        f'{len(vds)} frames: {sum(len(a["name"]) for a in annos)} detections; '
        + ', '.join(f'{k} {ret[k]:.4f}' for k in keys) + f'; recall@0.7 '
        f'{ret["recall/rcnn_0.7"]:.4f}; predict alone {ret["infer_fps"]:.2f} frames/s, the loop '
        f'{ret["loop_fps"]:.2f} frames/s; launches {launches["gather_rows"]} row gathers ({T} a '
        f'batch) on {card}')
    return paths


def waymo_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 59 to 62. Returns the kernel launches of each path, by name,
    and the times of the row gather at MPPNet's crops."""
    mppnet_cuda_vs_cpu_phase(synthetic, cfg_from_yaml_file)
    paths, crop = mppnet_full_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    paths.update(waymo_loop_phases(wrappers, synthetic, smi, cfg_from_yaml_file))
    return paths, crop


# ---- BEVFusion, camera and LiDAR: phases 63 to 66 ----------------------------------

BEVFUSION_CFG = 'configs/nuscenes_models/bevfusion.yaml'
BEVFUSION_MINI_CFG = 'configs/nuscenes_models/bevfusion_mini.yaml'
# the full-width batches: the file's `sample_points` a cloud, a nuScenes rig's
# six cameras (`synthetic.camera_rig`) at the file's 256 x 704 images
BEVFUSION_POINTS = 120000
BEVFUSION_CAMERAS = 6
BEVFUSION_DIR = REPO / 'build' / 'chip_smoke_bevfusion'
# frames of the loops' mini set (one camera, one sweep)
BEVFUSION_SAMPLES = 16
BEVFUSION_PATHS = ('predict', 'train', 'eval_loop', 'train_loop')
# the last Swin stage's MLP bias of the tiny shrink: a constant a channel into
# the neck's training-mode BatchNorm, which takes it away (0 in exact
# arithmetic, as in `tests/test_torch_port_bevfusion.py`)
BEVFUSION_NULL_GRADS = ('image_backbone.s3_b0.mlp2.bias',)


class GeometryReplay:
    """While active, the CUDA model's view transform takes the frustum's BEV
    cells the CPU model computed (`geometry`), moved to the card: the two
    devices' float32 inverses and products may floor a point on a cell's
    edge into different cells, which would move its features and hide the
    rest of the comparison. Counts the points whose cell differed."""

    def __init__(self, cpu_net, gpu_net, cpu_batch: dict):
        self.cpu_net, self.gpu_net, self.cpu_batch = cpu_net, gpu_net, cpu_batch

    def __enter__(self):
        vt = self.gpu_net.view_transform
        feats = self.cpu_batch['camera_imgs']
        B, N = feats.shape[:2]
        with torch.no_grad():
            want = self.cpu_net.view_transform.geometry(self.cpu_batch, B, N)
            got = vt.geometry({k: v.cuda() for k, v in self.cpu_batch.items()}, B, N).cpu()
        self.flipped = int((got != want).any(-1).sum())
        self.points = int(want[..., 0].numel())
        vt.geometry = lambda batch, B, N: want.to(batch['camera2lidar'].device)
        return self

    def __exit__(self, *exc):
        del self.gpu_net.view_transform.geometry


def bevfusion_cfg(cfg_from_yaml_file, synthetic, cfg_file: str = BEVFUSION_CFG):
    """A BEVFusion config; `bevfusion.yaml` with `synthetic.bevfusion_grid`
    (as shipped its three grids do not line up, ROADMAP Queue 3)."""
    cfg = cfg_from_yaml_file(str(REPO / cfg_file))
    return synthetic.bevfusion_grid(cfg) if cfg_file == BEVFUSION_CFG else cfg


def bevfusion_cuda_vs_cpu_phase(synthetic, cfg_from_yaml_file) -> None:
    """Phase 63: the tiny shrink (`synthetic.tiny_bevfusion_cfg`) on CUDA
    against the CPU at B=2, two cameras, the score gate open, the CPU's
    frustum cells replayed on CUDA (`GeometryReplay`, which counts the
    points that floored apart): every forward output within FWD_RTOL of its
    scale, detections matched by box and label, every loss term within
    LOSS_RTOL, every gradient within GRAD_RTOL relative L2 (cosine
    GRAD_COSINE); then `ops.bev_pool` on CUDA against float64 sums at the
    tiny model's lifted points."""
    from pdm_ssd_torch.ops.bev_pool import bev_pool
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '63 bevfusion cuda-vs-cpu'
    tiny = synthetic.tiny_bevfusion_cfg(
        bevfusion_cfg(cfg_from_yaml_file, synthetic, BEVFUSION_MINI_CFG))
    cpu_in = synthetic.camera_batch(2, 4096, tiny, seed=3, n_cam=2, M=4, mode='train',
                                    image_wh=(192, 128))
    gt = synthetic.gt_boxes(2, 4, tiny.DATA_CONFIG.POINT_CLOUD_RANGE, seed=4)
    gt[..., 7] = 1
    cpu_in['gt_boxes'] = torch.from_numpy(gt)
    gpu_in = {k: v.cuda() for k, v in cpu_in.items()}
    cpu_net = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with GeometryReplay(cpu_net, gpu_net, cpu_in) as replay:
        with torch.inference_mode():
            want, got = flatten(cpu_net(dict(cpu_in))), flatten(gpu_net(dict(gpu_in)))
        worst = 0.0
        for k, w in want.items():
            if not w.dtype.is_floating_point:
                continue
            rel = float((got[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
        note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(gpu_in)).items()},
                                cpu_net.predict(dict(cpu_in)), phase)
        c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
            phase, 'bevfusion', {'cpu': cpu_net, 'cuda': gpu_net}, {'cpu': cpu_in, 'cuda': gpu_in},
            GRAD_RTOL, GRAD_COSINE, BEVFUSION_NULL_GRADS)
    log(phase, f'tiny bevfusion B=2, 2 cameras of 64 x 96, N=4096: {replay.flipped} of '
        f'{replay.points} frustum points floor into another cell on CUDA (the CPU\'s cells '
        f'replayed); {len(want)} outputs agree, worst max|diff|/max|cpu| = {worst:.3e} (bound '
        f'{FWD_RTOL:g}); predict: {note}; loss {g_tb["loss"]:.6f} on CUDA vs {c_tb["loss"]:.6f} '
        f'on the CPU; {n} gradients agree, worst relative L2 {worst_g:.3e} at {worst_k} (bound '
        f'{GRAD_RTOL:g})')
    vt = cpu_net.view_transform
    with torch.inference_mode():
        feats = cpu_net.image_features(cpu_in['camera_imgs'])
        lifted = vt.lift(feats, cpu_in['camera_depth'])
        coords = vt.geometry(cpu_in, 2, 2)
    B, C = 2, vt.context
    flat, cells = lifted.reshape(B, -1, C), coords.reshape(B, -1, 3)
    nx = tuple(int(v) for v in vt.nx)
    exact = bev_pool(flat.double(), cells, None, nx)
    got = bev_pool(flat.cuda(), cells.cuda(), None, nx).cpu().double()
    rel = float((got - exact).abs().max()) / float(exact.abs().max())
    if not rel <= 1e-5:
        raise SystemExit(f'[{phase}] FAILED bev_pool on CUDA: max |diff| / max = {rel:.3e}')
    log(phase, f'bev_pool on CUDA (index_add_) at the tiny model\'s {flat.shape[1]} points a '
        f'cloud onto {nx}: within {rel:.3e} of float64 sums of the same points (bound 1e-5)')


class BevStageTimer(StageTimer):
    """While active, times BEVFusion's stages in each forward of `net`, the
    device synchronized around each (`StageTimer.timed`): the image backbone
    (Swin), the neck, the lift (dtransform, depthnet, the depth-weighted
    context), the geometry (the frustum into BEV cells), `bev_pool`, the
    view transform's rest (its downsample convs), the LiDAR branch
    (PillarVFE and the scatter), the fuser, the BEV backbone, the dense head
    and post-processing. `report(total_ms, n)` gives them a call."""

    def __init__(self, net):
        from pdm_ssd_torch.models.view_transforms import depth_lss
        self.net, self.module = net, depth_lss
        self.ms = {k: 0.0 for k in ('swin', 'neck', 'lift', 'geometry', 'bev_pool',
                                    'view transform', 'lidar', 'fuser', 'bev backbone', 'head',
                                    'post-process')}

    def __enter__(self):
        net, vt = self.net, self.net.view_transform
        self.saved = self.module.bev_pool
        self.module.bev_pool = self.timed(self.saved, 'bev_pool')
        self.patched = [(net.image_backbone, 'forward', 'swin'), (net.neck, 'forward', 'neck'),
                        (vt, 'lift', 'lift'), (vt, 'geometry', 'geometry'),
                        (vt, 'forward', 'view transform'), (net.vfe, 'forward', 'lidar'),
                        (net.map_to_bev, 'forward', 'lidar'), (net.fuser, 'forward', 'fuser'),
                        (net.backbone_2d, 'forward', 'bev backbone'),
                        (net.dense_head, 'forward', 'head'), (net, 'post_process', 'post-process')]
        for obj, name, key in self.patched:
            setattr(obj, name, self.timed(getattr(obj, name), key))
        return self

    def __exit__(self, *exc):
        self.module.bev_pool = self.saved
        for obj, name, _ in self.patched:
            delattr(obj, name)

    def report(self, total_ms: float, n: int) -> str:
        ms = {k: v / n for k, v in self.ms.items()}
        ms['view transform'] -= ms['lift'] + ms['geometry'] + ms['bev_pool']
        ms['rest'] = total_ms - sum(ms.values())
        return ', '.join(f'{k} {v:.3f}' for k, v in ms.items()) + f' ms of {total_ms:.3f} ms'


def bevfusion_stages(net, fn, n: int = 3) -> str:
    """`BevStageTimer`'s report over `n` calls of `fn` (each synchronized)."""
    torch.cuda.synchronize()
    with BevStageTimer(net) as timer:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / n
    return timer.report(total, n)


def bevfusion_full_phases(wrappers, synthetic, card: str, cfg_from_yaml_file) -> dict:
    """Phases 64 and 65: `bevfusion.yaml` (`synthetic.bevfusion_grid`) at its
    BATCH_SIZE_PER_GPU on `synthetic.camera_batch`es (BEVFUSION_POINTS points
    a cloud, six cameras of 256 x 704): `predict` with the score gate open
    (`measured_predict`) and its stages; five train steps with 8 boxes a
    cloud (`measured_train`), one step profiled (GFLOP, device ms, busy) and
    its forward's stages. Returns the launches of both paths."""
    cfg = bevfusion_cfg(cfg_from_yaml_file, synthetic)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    what = (f'N={BEVFUSION_POINTS}, {BEVFUSION_CAMERAS} cameras of '
            f'{" x ".join(str(v) for v in cfg.MODEL.VTRANSFORM.IMAGE_SIZE)}, '
            f'{cfg.DATA_CONFIG.POINT_CLOUD_RANGE[3]:g} m and 0.6 m pillars')
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = synthetic.camera_batch(B, BEVFUSION_POINTS, cfg, seed=5, n_cam=BEVFUSION_CAMERAS,
                                    device='cuda')
    phase = '64 bevfusion predict'
    paths = {'bevfusion_predict': measured_predict(
        phase, 'bevfusion.yaml (bevfusion_grid)', cfg, net, inputs, B, what, wrappers, card,
        flops='convolutions and matrix products')}
    log(phase, 'stages of a predict, synchronized: '
        + bevfusion_stages(net, lambda: net.predict(inputs)))
    del net, inputs
    torch.cuda.empty_cache()
    phase = '65 bevfusion train'
    net = synthetic.random_model(cfg, seed=7)           # no device named: the card
    batch = synthetic.camera_batch(B, BEVFUSION_POINTS, cfg, seed=5, n_cam=BEVFUSION_CAMERAS,
                                   M=8, device='cuda', mode='train')
    paths['bevfusion_train'] = measured_train(phase, 'bevfusion.yaml (bevfusion_grid)', cfg, net,
                                              batch, what, wrappers, card)
    profiled_train_step(phase, 'bevfusion.yaml', cfg, net, batch, card)
    net.train()
    log(phase, 'stages of a training forward and its loss, synchronized: '
        + bevfusion_stages(net, lambda: net.forward_with_loss(dict(batch))))
    net.eval()
    del net, batch
    torch.cuda.empty_cache()
    return paths


def bevfusion_loop_phases(wrappers, synthetic, card: str, cfg_from_yaml_file) -> dict:
    """Phase 66: the port's mini nuScenes set with its front camera
    (BEVFUSION_SAMPLES frames at one sweep, `make_mini_nuscenes --cams`,
    under `build/chip_smoke_bevfusion/`), `bevfusion_mini.yaml` as shipped:
    `eval_one_epoch` of seeded weights with the score gate open (NDS, mAP,
    `infer_fps`, `loop_fps`), `train_model` for 2 epochs (a checkpoint an
    epoch), the trained checkpoint through the eval loop; no kernel of the
    port launched. Returns the launches of the two loops."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    from pdm_ssd_torch.tools.make_mini_nuscenes import make
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '66 bevfusion eval loop'
    t0 = time.perf_counter()
    root = make(BEVFUSION_DIR, samples=BEVFUSION_SAMPLES, max_sweeps=1, cams=True)
    cfg = bevfusion_cfg(cfg_from_yaml_file, synthetic, BEVFUSION_MINI_CFG)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    log(phase, f'mini-nuScenes with CAM_FRONT: {BEVFUSION_SAMPLES} frames generated in '
        f'{time.perf_counter() - t0:.1f} s')

    def check(ret):
        keys = ('NDS', 'mAP', 'car_AP', 'mTRANSE', 'mSCALEE', 'mORIENTE')
        if not all(np.isfinite(float(ret[k])) for k in keys):
            raise SystemExit(f'[{phase}] FAILED: nuScenes metrics not finite: '
                             f'{ {k: ret.get(k) for k in keys} }')

    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                     workers=4, training=False)
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / 'eval_seeded')
    paths = {'bevfusion_eval_loop': read_launches(wrappers)}
    if paths['bevfusion_eval_loop'] != NO_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["bevfusion_eval_loop"]}')
    check(ret)
    annos = pickle.loads((root / 'eval_seeded' / 'result.pkl').read_bytes())
    log(phase, f'bevfusion_mini.yaml as shipped, seeded weights (score gate open), B={B} over '
        f'{len(ds)} frames: {sum(len(a["name"]) for a in annos)} detections; {nds_note(ret)}; '
        f'predict alone {ret["infer_fps"]:.2f} frames/s, the loop with loading '
        f'{ret["loop_fps"]:.2f} frames/s; no kernel of the port launched, on {card}')

    phase = '66 bevfusion train loop'
    epochs = 2
    tds, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                       workers=4, training=True, seed=0)
    ckpt_dir = root / 'ckpt'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(tloader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    steps = StepLog()
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    losses = trainer.train_model(net, optimizer, sched, tloader, epochs, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths['bevfusion_train_loop'] = read_launches(wrappers)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth']:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}, checkpoints {names}')
    if paths['bevfusion_train_loop'] != NO_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["bevfusion_train_loop"]}')
    log(phase, f'bevfusion_mini.yaml B={B}, {len(tds)} frames (imgaug and the world '
        f'augmentations on), {epochs} epochs of {len(tloader)} steps: mean losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; {seconds:.1f} s with loading; checkpoints '
        f'left {names}; no kernel of the port launched, on {card}')
    log(phase, steps.summary(len(tloader)))
    trained = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(ckpt_dir / names[-1], trained)
    np.random.seed(0)
    ret = eval_one_epoch(trained, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / 'eval_trained')
    check(ret)
    log(phase, f'the checkpoint of epoch {epochs} over the {len(ds)} frames: {nds_note(ret)}; '
        f'predict alone {ret["infer_fps"]:.2f} frames/s, with loading {ret["loop_fps"]:.2f} '
        'frames/s')
    return paths


def bevfusion_phases(wrappers, synthetic, smi: str, cfg_from_yaml_file) -> dict:
    """Phases 63 to 66, each group's seconds logged. Returns the kernel
    launches of each path, by name."""
    t0 = time.perf_counter()
    bevfusion_cuda_vs_cpu_phase(synthetic, cfg_from_yaml_file)
    t1 = time.perf_counter()
    paths = bevfusion_full_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    t2 = time.perf_counter()
    paths.update(bevfusion_loop_phases(wrappers, synthetic, smi, cfg_from_yaml_file))
    log('time', f'phase 63 {t1 - t0:.1f} s, phases 64 and 65 {t2 - t1:.1f} s, phase 66 '
        f'{time.perf_counter() - t2:.1f} s')
    return paths


# ---- CaDDN, monocular camera-only: phases 67 to 70 -------------------------------

# the full-width batches (`synthetic.caddn_kitti()`, no file holds it): two
# 375 x 1242 images of the mini KITTI camera, each with the depth map of
# 16384 LiDAR-like points in its view
CADDN_B = 2
CADDN_POINTS = 16384
# the trilinear sample gathers each voxel's 8 corners from the frustum, one
# launch a corner, and its gradient scatters them back, one launch a corner
CADDN_PREDICT_LAUNCHES = {**NO_LAUNCHES, 'gather_rows': 8}
CADDN_TRAIN_LAUNCHES = {**NO_LAUNCHES, 'gather_rows': 8, 'scatter_add_rows': 8}
# frames of the mini set's loops (B=2): the eval loop's (each batch's
# predict about 0.6 s, most of it the NMS over 4096 candidates) and the
# train loop's, which keep the four phases inside about 100 s
CADDN_EVAL_FRAMES = 8
CADDN_TRAIN_FRAMES = 16
CADDN_PATHS = ('predict', 'train', 'eval_loop', 'train_loop')
# train steps of phase 69 on its one batch: from the seeded weights the loss
# rises for a few steps before it falls, in the anchor head's box loss alone,
# for a cause not known (the first step moves the first BEV conv's output by
# under half its norm, the other BEV convs' by a few hundredths); the steps
# after the first follow the JAX package's at the tests' widths
# (`tests/test_torch_port_caddn.py::test_train_steps_track_jax`).
# `first_steps_probe` logs the first CADDN_PROBE_STEPS steps' loss terms and
# how far each step moved each BEV conv's output
CADDN_TRAIN_STEPS = 16
CADDN_PROBE_STEPS = 4


# the CUDA projection of the voxel centres against the CPU's: float32 sums in
# another order move a frustum coordinate by a few ulps of the projection's
# largest term (|x| <= 46.8 m, 2^-18 m an ulp), which the LID bin's slope, at
# most 145 bins a metre at DEPTH_MIN (80 bins over 2 to 46.8 m), turns into
# 2.2e-3 of a bin for 4 ulps: a corner weight moves by at most the sum of its
# three coordinates' moves, and a voxel takes other corners (or validity)
# only where a coordinate lies that close to a cell's (or the image's) edge
CORNER_WEIGHT_ATOL = 2.2e-3
CORNER_MOVED_SHARE = 1e-3


def corner_agreement(phase: str, got: tuple, want: tuple) -> tuple:
    """`frustum_corners` of one device (`got`) against the CPU's (`want`):
    the voxels whose validity differs or, valid on both, whose corner rows
    differ, at most CORNER_MOVED_SHARE of them; and the largest corner
    weight difference over the other voxels valid on both, at most
    CORNER_WEIGHT_ATOL (an invalid voxel's corners are masked out, and its
    projection, behind the camera or far off the image, may be any
    number). Returns (moved, voxels, weight error)."""
    got = [t.cpu() for t in got]
    both = got[2] & want[2]
    moved = (got[2] != want[2]) | (both & (got[0] != want[0]).any(0))
    err = float(((got[1] - want[1]).abs() * (both & ~moved)).max())
    n, voxels = int(moved.sum()), int(moved.numel())
    if not (n <= CORNER_MOVED_SHARE * voxels and err <= CORNER_WEIGHT_ATOL):
        raise SystemExit(f'[{phase}] FAILED frustum_corners: {n} of {voxels} voxels take other '
                         f'corners or validity than on the CPU (at most '
                         f'{CORNER_MOVED_SHARE * voxels:.0f}), weights within {err:.2e} '
                         f'(at most {CORNER_WEIGHT_ATOL:g})')
    return n, voxels, err


class CornerReplay:
    """While active, the frustum sample of both models takes the corners,
    weights and valid mask the CPU model computes (`frustum_corners`), moved
    to the model's device: the two devices' float32 projections may floor a voxel centre on a
    cell's edge into different corners, or put it on either side of the
    image's edge, which would move its features and hide the rest of the
    comparison. The CUDA corners are held to the CPU's first
    (`corner_agreement`)."""

    def __init__(self, phase: str, cpu_batch: dict, frustum_hwd: tuple, net):
        self.phase, self.cpu_batch, self.hwd, self.net = phase, cpu_batch, frustum_hwd, net

    def __enter__(self):
        from pdm_ssd_torch.models.detectors import caddn
        self.module, self.saved = caddn, caddn.frustum_corners
        net, b = self.net, self.cpu_batch
        centers = caddn.voxel_centers(net.grid_size, net.voxel_size, net.pc_range)
        args = (tuple(b['camera_imgs'].shape[2:4]), self.hwd, net.depth_range)
        want = caddn.frustum_corners(centers, b['trans_lidar_to_cam'], b['trans_cam_to_img'],
                                     *args)
        got = caddn.frustum_corners(centers.cuda(), b['trans_lidar_to_cam'].cuda(),
                                    b['trans_cam_to_img'].cuda(), *args)
        self.moved, self.voxels, self.weight_err = corner_agreement(self.phase, got, want)
        caddn.frustum_corners = lambda c, *a, **k: tuple(t.to(c.device) for t in want)
        return self

    def __exit__(self, *exc):
        self.module.frustum_corners = self.saved


def caddn_full_corners(phase: str, synthetic, cfg) -> tuple:
    """The full-width model's frustum shape and the corners of its voxels in
    `synthetic.caddn_batch`'s camera, computed on CUDA and held to the CPU's
    (`corner_agreement`): ((fH, fW, D, C), rows (8, B, V), weights, valid,
    (moved, voxels, weight error))."""
    from pdm_ssd_torch.models.detectors.caddn import frustum_corners, voxel_centers
    from pdm_ssd_torch.models.detectors.detector3d import _grid_info
    grid, voxel = _grid_info(cfg.DATA_CONFIG)
    batch = synthetic.caddn_batch(CADDN_B, CADDN_POINTS, cfg, seed=5, device='cuda')
    fr = cfg.MODEL.FRUSTUM
    iH, iW = batch['camera_imgs'].shape[2:4]
    hwd = ((iH + 7) // 8, (iW + 7) // 8, int(fr.NUM_DEPTH_BINS))
    args = ((iH, iW), hwd, (float(fr.DEPTH_MIN), float(fr.DEPTH_MAX)))
    centers = voxel_centers(grid, voxel, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, 'cuda')
    got = frustum_corners(centers, batch['trans_lidar_to_cam'], batch['trans_cam_to_img'], *args)
    want = frustum_corners(centers.cpu(), batch['trans_lidar_to_cam'].cpu(),
                           batch['trans_cam_to_img'].cpu(), *args)
    return (hwd + (int(fr.OUT_CHANNEL),),) + tuple(got) + (corner_agreement(phase, got, want),)


def caddn_cuda_vs_cpu_phase(synthetic, group) -> dict:
    """Phase 67: the tiny CaDDN (`synthetic.tiny_caddn_cfg`) on CUDA against
    the CPU at B=2, two 64 x 96 images, 4 boxes with their 2D boxes and the
    DDN loss active, the score gate open, the CPU's frustum corners replayed
    on CUDA (`CornerReplay`, after holding the CUDA corners to them): every
    forward output within FWD_RTOL of its scale, detections matched by box
    and label, every loss term within LOSS_RTOL, every gradient within
    GRAD_RTOL relative L2 (cosine GRAD_COSINE). Then the full-width corners
    (`caddn_kitti()`'s 280 x 376 x 25 voxels in a 47 x 156 x 80 x 64
    frustum, B=2) on CUDA held to the CPU's (`corner_agreement`); their
    gather on `gather_rows` equal to its plain version bit for bit, timed
    beside `torch.gather`, the 8 launches of a forward timed together beside
    one launch of all 8 corners; and the gradient of corner 0 on
    `scatter_add_rows` (`scatter_check`), with how its indices repeat.
    Returns the two kernels' numbers at the new shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '67 caddn cuda-vs-cpu'
    tiny = synthetic.tiny_caddn_cfg(synthetic.caddn_kitti())
    cpu_in = synthetic.caddn_batch(2, 2048, tiny, seed=3, M=4)
    gpu_in = {k: v.cuda() for k, v in cpu_in.items()}
    cpu_net = synthetic.open_score_gate(synthetic.random_model(tiny, 'cpu'))
    gpu_net = synthetic.random_model(tiny, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    fr = tiny.MODEL.FRUSTUM
    with CornerReplay(phase, cpu_in, (8, 12, int(fr.NUM_DEPTH_BINS)), cpu_net) as replay:
        with torch.inference_mode():
            want, got = flatten(cpu_net(dict(cpu_in))), flatten(gpu_net(dict(gpu_in)))
        worst = 0.0
        for k, w in want.items():
            if not w.dtype.is_floating_point:
                continue
            rel = float((got[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
        note = match_detections({k: v.cpu() for k, v in gpu_net.predict(dict(gpu_in)).items()},
                                cpu_net.predict(dict(cpu_in)), phase)
        c_tb, g_tb, worst_g, worst_k, n = training_cuda_vs_cpu(
            phase, 'caddn', {'cpu': cpu_net, 'cuda': gpu_net}, {'cpu': cpu_in, 'cuda': gpu_in},
            GRAD_RTOL, GRAD_COSINE)
    if not c_tb.get('ddn_loss', 0) > 0:
        raise SystemExit(f'[{phase}] FAILED: no DDN loss in {c_tb}')
    log(phase, f'tiny caddn B=2, 64 x 96 images, 32 x 32 x 4 voxels: {replay.moved} of '
        f'{replay.voxels} voxels take other corners or validity on CUDA, the others\' weights '
        f'within {replay.weight_err:.2e} (bounds {CORNER_MOVED_SHARE:g} of the voxels, '
        f'{CORNER_WEIGHT_ATOL:g}; the CPU\'s replayed); {len(want)} outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); predict: {note}; loss '
        f'{g_tb["loss"]:.6f} (ddn {g_tb["ddn_loss"]:.6f}) on CUDA vs {c_tb["loss"]:.6f} '
        f'(ddn {c_tb["ddn_loss"]:.6f}) on the CPU; {n} gradients agree, worst relative L2 '
        f'{worst_g:.3e} at {worst_k} (bound {GRAD_RTOL:g})')
    del cpu_net, gpu_net

    cfg = synthetic.caddn_kitti()
    (fH, fW, D, C), rows, weights, valid, (moved, voxels, werr) = caddn_full_corners(
        phase, synthetic, cfg)
    B, V = rows.shape[1:]
    N = fH * fW * D
    table = torch.randn((B, N, C), generator=torch.Generator('cuda').manual_seed(6),
                        device='cuda')
    gather = gather_check(phase, 'caddn corner 0', group, table, rows[0])
    for k in range(1, 8):
        if not torch.equal(group.gather_rows_cuda(table, rows[k]),
                           group.gather_rows_plain(table, rows[k])):
            raise SystemExit(f'[{phase}] FAILED gather_rows at corner {k}: differs from plain')
    eight = device_time(lambda: [group.gather_rows_cuda(table, r) for r in rows], runs=3)
    all8 = rows.permute(1, 0, 2).reshape(B, 8 * V).contiguous()
    one = device_time(lambda: group.gather_rows_cuda(table, all8), runs=3)
    gather.update(eight_launches_ms=eight['ms'], one_launch_ms=one['ms'])
    log(phase, f'the 8 corners (B={B}, V={V} voxels, {int(valid.sum())} valid, from {N} rows of '
        f'{C}): on CUDA {moved} of {voxels} voxels take other corners or validity than on the '
        f'CPU, the others\' weights within {werr:.2e} (bounds {CORNER_MOVED_SHARE:g} of the '
        f'voxels, {CORNER_WEIGHT_ATOL:g}); each gather == plain (exact); the 8 launches of '
        f'(B, V) {timing_note(eight)}; one launch of (B, 8V) {timing_note(one)} '
        f'({8 * B * V * C * 4 / 2 ** 30:.2f} GiB out)')
    scatter = scatter_check(phase, 'caddn corner 0', group, rows[0], C, N, seed=7)
    runs = sum(int(torch.unique_consecutive(r).numel()) for r in rows[0])
    distinct = sum(int(torch.unique(r).numel()) for r in rows[0])
    scatter.update(runs=runs, distinct_rows=distinct, rows=B * V)
    log(phase, f'corner 0\'s {B * V} rows: {runs} runs of equal neighbours, {distinct} distinct')
    del table, rows, weights, valid, all8
    torch.cuda.empty_cache()
    return {'gather_rows': gather, 'scatter_add_rows': scatter}


def first_steps_probe(cfg, net, batch: dict, steps: int) -> list:
    """The first `steps` train steps of `net` on `batch` with a fresh
    optimizer of `cfg`, and after each, how far it moved every BEV conv's
    output on that step's input: ||conv(x; W') - conv(x; W)|| /
    ||conv(x; W)||, with W' the weights after the step. The weights, the
    statistics and the optimizer are put back after. Returns, a step, (the
    loss terms, {conv name: the output's relative move})."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    saved = {k: v.detach().clone() for k, v in net.state_dict().items()}
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
    convs = {n: m for n, m in net.backbone_2d.named_modules() if isinstance(m, torch.nn.Conv2d)}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, (i[0].detach(), o.detach())))
        for n, m in convs.items()]
    out = []
    try:
        for _ in range(steps):
            terms = {k: float(v) for k, v in train_step(batch).items()}
            moved = {}
            with torch.no_grad():
                for n, m in convs.items():
                    x, before = seen[n]
                    moved[n] = float((m(x) - before).norm() / before.norm())
            out.append((terms, moved))
    finally:
        for h in hooks:
            h.remove()
        net.load_state_dict(saved)
    return out


def caddn_full_phases(wrappers, synthetic, card: str) -> dict:
    """Phases 68 and 69: `synthetic.caddn_kitti()` at B=2 on
    `synthetic.caddn_batch`es (375 x 1242 images, the depth maps of 16384
    points in view): `predict` with the score gate open (`measured_predict`,
    8 row gathers a predict) and its stages (`profile_predict.caddn_stage_
    times`, the NMS's share among them); CADDN_TRAIN_STEPS train steps with
    8 boxes a frame and the DDN loss (`measured_train`, 8 gathers and 8
    scatter-adds a step), one step profiled. Returns the launches of both paths."""
    from pdm_ssd_torch.tools.profile_predict import caddn_stage_times
    cfg = synthetic.caddn_kitti()
    what = (f'375 x 1242 images, {CADDN_POINTS} points in view for the depth maps, '
            '280 x 376 x 25 voxels, 80 depth bins')
    phase = '68 caddn predict'
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = synthetic.caddn_batch(CADDN_B, CADDN_POINTS, cfg, seed=5, device='cuda')
    paths = {'caddn_predict': measured_predict(
        phase, 'caddn_kitti()', cfg, net, inputs, CADDN_B, what, wrappers, card,
        expected=CADDN_PREDICT_LAUNCHES)}
    with torch.inference_mode():
        t = caddn_stage_times(net, cfg, inputs, 3)
    log(phase, 'stages, each on its own input (median of 3): ' + ', '.join(
        f'{k} {v:.3f} {"GFLOP" if k.endswith("_gflop") else "ms"}' for k, v in t.items())
        + f'; the NMS {t["nms"] / t["predict"]:.3f} of the predict, on {card}')
    del net, inputs
    torch.cuda.empty_cache()
    phase = '69 caddn train'
    net = synthetic.random_model(cfg, seed=7)           # no device named: the card
    batch = synthetic.caddn_batch(CADDN_B, CADDN_POINTS, cfg, seed=5, M=8, device='cuda')
    notes = []
    for i, (t, m) in enumerate(first_steps_probe(cfg, net, batch, CADDN_PROBE_STEPS)):
        rest = [v for k, v in m.items() if k != 'down0_conv0']
        notes.append(f'step {i + 1}: loss {t["loss"]:.4f}, anchor_loc_loss '
                     f'{t["anchor_loc_loss"]:.4f}, anchor_cls_loss {t["anchor_cls_loss"]:.4f}, '
                     f'ddn_loss {t["ddn_loss"]:.4f}; it moved the output of the first BEV conv '
                     f'(1600 x 9 inputs a filter) by {m["down0_conv0"]:.3f} of its norm, of '
                     f'the other {len(rest)} by {statistics.median(rest):.3f} (median), '
                     f'{max(rest):.3f} (largest)')
    log(phase, f'the first {CADDN_PROBE_STEPS} steps, the model put back after: '
        + '; '.join(notes))
    paths['caddn_train'] = measured_train(phase, 'caddn_kitti()', cfg, net, batch,
                                          what + ', the DDN loss on', wrappers, card,
                                          expected=CADDN_TRAIN_LAUNCHES,
                                          steps=CADDN_TRAIN_STEPS)
    profiled_train_step(phase, 'caddn_kitti()', cfg, net, batch, card)
    del net, batch
    torch.cuda.empty_cache()
    return paths


def caddn_loop_cfg(synthetic, root: Path):
    """`caddn_kitti()` reading the mini set at `root`, the GT sampler's image
    copy-paste (the dataset config's `gt_sampling` with IMG_AUG_TYPE 'kitti',
    Car only) before the image flip."""
    from pdm_ssd_torch.utils.config import CfgNode
    cfg = synthetic.caddn_kitti()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    gt = CfgNode({'NAME': 'gt_sampling', 'USE_ROAD_PLANE': False,
                  'DB_INFO_PATH': ['kitti_dbinfos_train.pkl'],
                  'PREPARE': {'filter_by_min_points': ['Car:5'], 'filter_by_difficulty': [-1]},
                  'SAMPLE_GROUPS': ['Car:6'], 'NUM_POINT_FEATURES': 4,
                  'LIMIT_WHOLE_SCENE': True, 'IMG_AUG_TYPE': 'kitti'})
    cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST.insert(0, gt)
    return cfg


def caddn_loop_phases(wrappers, synthetic, card: str) -> dict:
    """Phase 70: the mini KITTI set with its decodable images, `caddn_kitti()`
    with the image copy-paste and the image flip (`caddn_loop_cfg`), each
    batch given CaDDN's inputs by `synthetic.caddn_camera_inputs`
    (`caddn_loader`): `eval_one_epoch` of seeded weights, the score gate
    open, over CADDN_EVAL_FRAMES val frames (recall, AP R40, `infer_fps`,
    `loop_fps`); `train_model` for 2 epochs over CADDN_TRAIN_FRAMES train
    frames (a checkpoint an epoch), the DDN loss on; the trained checkpoint
    through the eval loop. Returns the launches of the two loops."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '70 caddn eval loop'
    root = mini_kitti()
    cfg = caddn_loop_cfg(synthetic, root)
    B = CADDN_B
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                     workers=4, training=False)
    ds.kitti_infos = ds.kitti_infos[:CADDN_EVAL_FRAMES]
    loader = synthetic.caddn_loader(loader)
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=KITTI_DIR / 'eval_caddn_seeded')
    paths = {'caddn_eval_loop': read_launches(wrappers)}
    want = {k: v * len(loader) for k, v in CADDN_PREDICT_LAUNCHES.items()}
    if paths['caddn_eval_loop'] != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["caddn_eval_loop"]}, '
                         f'expected {want}')
    check_eval(phase, ret)
    annos = pickle.loads((KITTI_DIR / 'eval_caddn_seeded' / 'result.pkl').read_bytes())
    log(phase, f'caddn_kitti() on the mini set, seeded weights (score gate open), B={B} over '
        f'{len(ds)} val frames: {sum(len(a["name"]) for a in annos)} detections; recall@0.3/0.5/0.7 '
        f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; '
        f'{r40_note(ret)}; predict alone {ret["infer_fps"]:.2f} frames/s, the loop with loading '
        f'{ret["loop_fps"]:.2f} frames/s; launches {paths["caddn_eval_loop"]["gather_rows"]} row '
        f'gathers on {card}')

    phase = '70 caddn train loop'
    epochs = 2
    tds, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                       workers=4, training=True, seed=0)
    tds.kitti_infos = tds.kitti_infos[:CADDN_TRAIN_FRAMES]
    tloader = synthetic.caddn_loader(tloader)
    ckpt_dir = KITTI_DIR / 'ckpt_caddn'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(tloader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    steps = StepLog()
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    losses = trainer.train_model(net, optimizer, sched, tloader, epochs, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths['caddn_train_loop'] = read_launches(wrappers)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth']:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}, checkpoints {names}')
    want = {k: v * epochs * len(tloader) for k, v in CADDN_TRAIN_LAUNCHES.items()}
    if paths['caddn_train_loop'] != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {paths["caddn_train_loop"]}, '
                         f'expected {want}')
    if not all(s.get('ddn_loss', 0) > 0 for s in steps.steps):
        raise SystemExit(f'[{phase}] FAILED: a step without the DDN loss')
    log(phase, f'caddn_kitti() B={B}, {len(tds)} train frames (the image copy-paste and the '
        f'image flip on), {epochs} epochs of {len(tloader)} steps: mean losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; {seconds:.1f} s with loading; checkpoints '
        f'left {names}; launches {paths["caddn_train_loop"]["gather_rows"]} row gathers and '
        f'{paths["caddn_train_loop"]["scatter_add_rows"]} scatter-adds on {card}')
    log(phase, steps.summary(len(tloader)))
    trained = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(ckpt_dir / names[-1], trained)
    np.random.seed(0)
    ret = eval_one_epoch(trained, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=KITTI_DIR / 'eval_caddn_trained')
    check_eval(phase, ret)
    log(phase, f'the checkpoint of epoch {epochs} over the {len(ds)} val frames: recall@0.3/0.5/'
        f'0.7 {ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/'
        f'{ret["recall/rcnn_0.7"]:.4f}; {r40_note(ret)}; predict alone {ret["infer_fps"]:.2f} '
        f'frames/s, with loading {ret["loop_fps"]:.2f} frames/s')
    return paths


def caddn_phases(wrappers, synthetic, group, smi: str) -> tuple:
    """Phases 67 to 70, each group's seconds logged. Returns the kernel
    launches of each path, by name, and the row gather's and scatter-add's
    numbers at CaDDN's shapes."""
    t0 = time.perf_counter()
    shapes = caddn_cuda_vs_cpu_phase(synthetic, group)
    t1 = time.perf_counter()
    paths = caddn_full_phases(wrappers, synthetic, smi)
    t2 = time.perf_counter()
    paths.update(caddn_loop_phases(wrappers, synthetic, smi))
    log('time', f'phase 67 {t1 - t0:.1f} s, phases 68 and 69 {t2 - t1:.1f} s, phase 70 '
        f'{time.perf_counter() - t2:.1f} s')
    return paths, shapes


MINI_SETS = ('once', 'argo2', 'lyft', 'pandaset', 'custom')
SETS_DIR = REPO / 'build' / 'chip_smoke_sets'
# frames a split of each generated set; the eval loops' and the custom
# train loop's batch sizes (8 frames at B=2: 4 steps an epoch)
SET_FRAMES = 8
SET_EVAL_B = 4
SET_TRAIN_B = 2
SET_TRAIN_EPOCHS = 2
SET_PATHS = tuple(f'{s}_eval_loop' for s in MINI_SETS) + ('custom_train_loop',)
# the entries of each set's evaluation that phase 72 prints, and that must
# be finite (a class may have no GT in 8 frames, so no per-class entry is
# among them)
SET_METRICS = {'once': ('AP_mean/overall', 'AP_mean/0-30m', 'AP_Vehicle/overall'),
               'argo2': ('mAP', 'mCDS'), 'lyft': ('mAP', 'car_AP'),
               'pandaset': ('mAP', 'Car_AP'),
               'custom': ('recall_0.3', 'recall_0.5', 'recall_0.7')}


def mini_sets() -> dict:
    """The five generated mini sets (`tools.make_mini_sets`, SET_FRAMES
    frames a split) under SETS_DIR, made anew; returns set -> root."""
    from pdm_ssd_torch.tools.make_mini_sets import make
    t0 = time.perf_counter()
    roots = {name: make(name, SETS_DIR / name, frames=SET_FRAMES) for name in MINI_SETS}
    log('71 sets cuda-vs-cpu', f'{", ".join(MINI_SETS)}: {SET_FRAMES} frames a split generated '
        f'in {time.perf_counter() - t0:.1f} s')
    return roots


def set_cfg(synthetic, name: str, root: Path, num_points: int = 16384, local: bool = False):
    """`synthetic.flagship_on(name, root)` with `num_points` a cloud."""
    cfg = synthetic.flagship_on(name, root, local_augmentations=local)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': num_points, 'test': num_points}
    return cfg


def sets_cuda_vs_cpu_phase(synthetic, roots: dict) -> None:
    """Phase 71: the flagship at full width, seeded weights and its score gate
    open, on the first val batch of each set at B=2, N=4096, on CUDA against
    the same weights on the CPU (`nuscenes_cuda_vs_cpu`): the forward within
    FWD_RTOL of scale, the kept boxes above the tie level matched by box and
    label both ways."""
    from pdm_ssd_torch.datasets import build_dataloader
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '71 sets cuda-vs-cpu'
    sources = {}
    for name, root in roots.items():
        cfg = set_cfg(synthetic, name, root, 4096)
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                        training=False)
        np.random.seed(1)
        sources[name] = [torch.from_numpy(next(iter(loader))['points'])]
    cfg = set_cfg(synthetic, 'once', roots['once'], 4096)
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    note = nuscenes_cuda_vs_cpu(phase, net, cfg, synthetic, sources, detections=True)
    log(phase, f'pdm_ssd_point.yaml on the first val batch of each set, B=2 N=4096: {note}')


def sets_loop_phases(wrappers, synthetic, card: str, roots: dict) -> dict:
    """Phase 72: for each set, `eval_one_epoch` of the flagship as shipped
    (`synthetic.flagship_on`: N=16384, seeded weights, the score gate open)
    at B=SET_EVAL_B over its SET_FRAMES val frames: the set's own metric,
    the boxes that are not finite (none allowed), `infer_fps` and
    `loop_fps`, and the launches, one predict's a batch. Phase 73: the
    custom set's `train_model` at B=SET_TRAIN_B, GT sampling from its own
    database and the six local augmentations in its queue, SET_TRAIN_EPOCHS
    epochs: finite losses, the last epoch's mean below the first's, one
    training step's launches a step, then the trained checkpoint through
    the eval loop. Returns the launches of each loop, by path name."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = {}
    for name, root in roots.items():
        phase = f'72 {name} eval loop'
        cfg = set_cfg(synthetic, name, root)
        ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, SET_EVAL_B,
                                         workers=4, training=False)
        net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
        np.random.seed(0)
        reset_launches(wrappers)
        ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                             result_dir=SETS_DIR / f'eval_{name}')
        paths[f'{name}_eval_loop'] = launches = read_launches(wrappers)
        want = {k: v * len(loader) for k, v in PREDICT_LAUNCHES.items()}
        if launches != want:
            raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over {len(loader)} '
                             f'batches, expected {want}')
        annos = pickle.loads((SETS_DIR / f'eval_{name}' / 'result.pkl').read_bytes())
        key = 'boxes_lidar' if name == 'custom' else 'boxes_3d'
        n_inf = sum(int((~np.isfinite(np.asarray(a[key], np.float64).reshape(-1, 7))).any(-1)
                        .sum()) for a in annos)
        metrics = {k: ret.get(k, float('nan')) for k in SET_METRICS[name]}
        if n_inf or not all(np.isfinite(v) for v in metrics.values()):
            raise SystemExit(f'[{phase}] FAILED: {n_inf} boxes not finite, metrics {metrics}')
        log(phase, f'{ds.__class__.__name__} ({", ".join(cfg.CLASS_NAMES)}), B={SET_EVAL_B} over '
            f'{len(ds)} val frames: {sum(len(a["name"]) for a in annos)} detections ({n_inf} not '
            f'finite); {", ".join(f"{k} {v:.4f}" for k, v in metrics.items())}; recall@0.3/0.5/0.7 '
            f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/'
            f'{ret["recall/rcnn_0.7"]:.4f}; predict alone {ret["infer_fps"]:.2f} frames/s, the '
            f'loop with loading and evaluation {ret["loop_fps"]:.2f} frames/s; launches FPS '
            f'{launches["farthest_point_sample"]}, window_select {launches["window_select"]}, '
            f'gather_rows {launches["gather_rows"]} over {len(loader)} predicts on {card}')

    phase = '73 custom train loop'
    cfg = set_cfg(synthetic, 'custom', roots['custom'], local=True)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, SET_TRAIN_B, workers=4,
                                     training=True, seed=0)
    queue = [f.func.__name__ if hasattr(f, 'func') else type(f).__name__
             for f in ds.data_augmentor.data_augmentor_queue]
    ckpt_dir = SETS_DIR / 'ckpt_custom'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    epochs = SET_TRAIN_EPOCHS
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    steps = StepLog()
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    losses = trainer.train_model(net, optimizer, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1, logger=steps, log_interval=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths['custom_train_loop'] = launches = read_launches(wrappers)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    want = {k: v * epochs * len(loader) for k, v in TRAIN_LAUNCHES.items()}
    if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or names != [f'checkpoint_epoch_{epochs}.pth']):
        raise SystemExit(f'[{phase}] FAILED: mean losses {losses} (the last must be below the '
                         f'first), checkpoints {names}')
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over '
                         f'{epochs * len(loader)} steps, expected {want}')
    log(phase, f'CustomDataset B={SET_TRAIN_B} over {len(ds)} train frames, the queue {queue}, '
        f'{epochs} epochs of {len(loader)} steps: mean losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; {seconds:.1f} s with loading; checkpoints '
        f'left {names}; launches FPS {launches["farthest_point_sample"]}, window_select '
        f'{launches["window_select"]}, gather_rows {launches["gather_rows"]}, scatter_add_rows '
        f'{launches["scatter_add_rows"]} on {card}')
    log(phase, steps.summary(len(loader)))
    trained = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=13))
    trainer.load_checkpoint(ckpt_dir / names[-1], trained)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, SET_EVAL_B, workers=4,
                                       training=False)
    np.random.seed(0)
    ret = eval_one_epoch(trained, vloader, vds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=SETS_DIR / 'eval_custom_trained')
    log(phase, f'the checkpoint of epoch {epochs} over the {len(vds)} val frames (its score '
        f'gate open): recall@0.3/0.5/0.7 {ret["recall_0.3"]:.4f}/{ret["recall_0.5"]:.4f}/'
        f'{ret["recall_0.7"]:.4f}; predict alone {ret["infer_fps"]:.2f} frames/s, with loading '
        f'{ret["loop_fps"]:.2f} frames/s')
    return paths


def sets_phases(wrappers, synthetic, smi: str) -> dict:
    """Phases 71 to 73, each group's seconds logged. Returns the kernel
    launches of each path, by name."""
    t0 = time.perf_counter()
    roots = mini_sets()
    sets_cuda_vs_cpu_phase(synthetic, roots)
    t1 = time.perf_counter()
    paths = sets_loop_phases(wrappers, synthetic, smi, roots)
    log('time', f'phase 71 {t1 - t0:.1f} s, phases 72 and 73 {time.perf_counter() - t1:.1f} s')
    return paths


DDP_B, DDP_N, DDP_M = 8, 16384, 8
DDP_RANKS = 2
DDP_DIR = REPO / 'build' / 'chip_smoke_ddp'
DDP_TIMEOUT_S = 300
# the two ranks' step against one process's on the same 8 clouds: float32
# sums in another order (the BatchNorm statistics' sums over the ranks, the
# gradients' all-reduce), and the scatter-add's atomics in the backward (the
# card does not order them). A rehearsal of this phase on the CPU (the tiny
# flagship, 512 points a cloud) read the loss equal and the leaf groups'
# gradients 2.0e-6 to 7.1e-4 apart, the PDM neck's and the BEV backbone's
# the furthest (their BatchNorm gradients are small sums of large terms),
# where one process read its own step twice bit-equal; in float64 the CPU
# tests hold the same step within 1e-9. The bound must also catch each of
# DDP_FAULTS in some leaf group: in that rehearsal the mildest, one
# layer's statistics with a rank-local backward, read 1.2e-1 to 2.1e-1 in
# its worst group. On an H100 at 700 W the two ranks read up to 1.87e-3,
# one process's step run twice 1.8e-6 (so the atomics do not account for
# the ranks' 1e-3: the sums' other order does), and the mildest fault
# 9.7e-2 in its worst group
DDP_LOSS_RTOL = 1e-4
DDP_GRAD_REL_L2 = 1e-2
DDP_PATHS = ('ddp_one_process', 'ddp_rank0', 'ddp_rank1', 'ddp_nccl')
# faults planted in the ranks' BatchNorm statistics, each of which the
# gradient bound must catch: (name, kind, layers). `kind` 'detached' takes
# the global sums with no gradient through them; 'rank_local' takes them
# forward and sends each rank's gradient back to its own sums alone, as if
# the all-reduce's backward were missing. `layers` indexes the model's
# BatchNorm layers in module order (None: every one)
DDP_FAULTS = (('detached, every layer', 'detached', None),
              ('rank-local backward, every layer', 'rank_local', None),
              ('rank-local backward, the first layer', 'rank_local', 0),
              ('rank-local backward, the middle layer', 'rank_local', 0.5),
              ('rank-local backward, the last layer', 'rank_local', 1))


def plant_fault(net, kind: str, layers) -> list:
    """Plant DDP_FAULTS' fault `kind` in the BatchNorm layers of `net` that
    `layers` picks (None: all; a fraction: that share of the way through
    them in module order): each picked layer's forward runs with
    `parallel.ddp.sync_sum` replaced. Returns the picked layers' names."""
    from pdm_ssd_torch.models.layers import _FlaxBatchStatistics
    from pdm_ssd_torch.parallel import ddp

    def faulty(t):
        if kind == 'detached':
            return ddp.global_sum(t)
        return t + (ddp.global_sum(t) - t).detach()

    bns = [(k, m) for k, m in net.named_modules() if isinstance(m, _FlaxBatchStatistics)]
    if layers is not None:
        bns = [bns[round(layers * (len(bns) - 1))]]
    for _, m in bns:
        def forward(*args, _forward=m.forward):
            real = ddp.sync_sum
            ddp.sync_sum = faulty
            try:
                return _forward(*args)
            finally:
                ddp.sync_sum = real
        m.forward = forward
    return [k for k, _ in bns]


def ddp_flagship_steps(device, steps: int, fault=None) -> dict:
    """`steps` training steps of the flagship at full width (seeded weights,
    TF32 off) on this rank's share of DDP_B seeded clouds (all of them
    without a process group), under `parallel.wrap_model`, with `fault` (a
    `plant_fault` kind and layers) planted. Returns the first step's loss,
    gradients and BatchNorm buffers (on the host), its kernel launches,
    every step's ms, the gradients' bytes and the faulted layers."""
    from pdm_ssd_torch.parallel import ddp
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_from_yaml_file(str(REPO / CFG), CfgNode())
    net = synthetic.random_model(cfg, device, seed=7)
    planted = plant_fault(net, *fault) if fault is not None else []
    b, r = DDP_B // ddp.world_size(), ddp.rank()
    full = synthetic.kitti_batch(DDP_B, DDP_N, DDP_M, seed=5)
    batch = to_device({k: v[r * b:(r + 1) * b] for k, v in full.items()}, device)
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(ddp.wrap_model(net), optimizer)
    wrappers = launch_counters()
    torch.cuda.synchronize(device)
    reset_launches(wrappers)
    out = {'ms': [], 'grad_bytes': sum(p.numel() * p.element_size() for p in net.parameters()),
           'planted': planted}
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize(device)
        out['ms'].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out.update(loss=float(metrics['loss']), launches=read_launches(wrappers),
                       grads={k: p.grad.detach().to('cpu', copy=True)
                              for k, p in net.named_parameters()},
                       buffers={k: v.detach().to('cpu', copy=True)
                                for k, v in net.named_buffers() if 'running' in k})
    return out


def ddp_allreduce_ms(device, nbytes: int, reps: int = 3) -> float:
    """Median ms of an all-reduce of `nbytes` of float32 on the card over
    the default process group."""
    import torch.distributed as dist
    flat = torch.ones(nbytes // 4, device=device)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    if not bool((flat == dist.get_world_size() ** reps).all()):
        raise RuntimeError(f'the all-reduce summed wrongly: {flat[:4].tolist()}')
    return statistics.median(times)


def ddp_rank(device, out_dir: str, faults) -> None:
    """One rank of phase 74 (spawned): three steps, then the all-reduce of
    the gradients' bytes timed, then one step from the same weights with
    each of `faults` planted; its results to `<out_dir>/rank<r>.pt`."""
    from pdm_ssd_torch.ops import kernels
    from pdm_ssd_torch.parallel import ddp
    os.chdir(REPO)
    kernels.load()
    out = ddp_flagship_steps(device, steps=3)
    out['allreduce_ms'] = ddp_allreduce_ms(device, out['grad_bytes'])
    out['faults'] = {name: ddp_flagship_steps(device, steps=1, fault=(kind, layers))
                     for name, kind, layers in faults}
    torch.save(out, Path(out_dir) / f'rank{ddp.rank()}.pt')


def leaf_groups(tensors: dict) -> dict:
    """The tensors by the model's top-level module, each group flat in
    float64."""
    groups = {}
    for k, t in tensors.items():
        groups.setdefault(k.split('.')[0], []).append(t.reshape(-1).double())
    return {k: torch.cat(v) for k, v in groups.items()}


def ddp_errors(got: dict, want: dict) -> dict:
    """A step's relative L2 from another's, each leaf group's gradients and
    all BatchNorm buffers; and the worst single leaf's gradient, by name."""
    got_g, want_g = leaf_groups(got['grads']), leaf_groups(want['grads'])
    pairs = {f'grad {k}': (got_g[k], want_g[k]) for k in want_g}
    pairs['buffers'] = tuple(torch.cat(list(leaf_groups(x['buffers']).values()))
                             for x in (got, want))
    errs = {name: float((g - w).norm() / w.norm().clamp(min=1e-30))
            for name, (g, w) in pairs.items()}
    leaf = {k: float((got['grads'][k] - w).double().norm() / w.double().norm().clamp(min=1e-30))
            for k, w in want['grads'].items()}
    worst = max(leaf, key=leaf.get)
    return {'groups': errs, 'worst_leaf': (worst, leaf[worst])}


def ddp_errors_note(e: dict) -> str:
    return ('relative L2 ' + ', '.join(f'{k} {v:.2e}' for k, v in e['groups'].items())
            + f'; worst leaf {e["worst_leaf"][0]} {e["worst_leaf"][1]:.2e}')


def ddp_agreement(phase: str, got: dict, want: dict) -> str:
    """A rank's first step against one process's: the loss, the kernel
    launches, each leaf group's gradients and all BatchNorm buffers. Returns
    the numbers."""
    rel = abs(got['loss'] - want['loss']) / abs(want['loss'])
    if not (np.isfinite(got['loss']) and rel <= DDP_LOSS_RTOL):
        raise SystemExit(f'[{phase}] FAILED: loss {got["loss"]} against {want["loss"]} in one '
                         f'process (relative {rel:.3e}, bound {DDP_LOSS_RTOL:g})')
    if got['launches'] != want['launches']:
        raise SystemExit(f'[{phase}] FAILED: launches {got["launches"]}, one process '
                         f'{want["launches"]}')
    e = ddp_errors(got, want)
    for name, err in e['groups'].items():
        if not err <= DDP_GRAD_REL_L2:
            raise SystemExit(f'[{phase}] FAILED: {name} relative L2 {err:.3e} (bound '
                             f'{DDP_GRAD_REL_L2:g})')
    return f'loss relative {rel:.2e}; ' + ddp_errors_note(e)


def ddp_phase(smi: str) -> dict:
    """Phase 74. Returns the kernel launches of each path, by name."""
    import torch.distributed as dist
    from pdm_ssd_torch.parallel import ddp
    phase = '74 ddp'
    t0 = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card with this process
    one = ddp_flagship_steps('cuda:0', steps=1)
    again = ddp_flagship_steps('cuda:0', steps=1)
    torch.cuda.empty_cache()
    log(phase, f'one process: {CFG} B={DDP_B} N={DDP_N}, {DDP_M} boxes a cloud, one step: loss '
        f'{one["loss"]:.6f}, {one["ms"][0]:.1f} ms (the first), launches {one["launches"]}')
    log(phase, f'the same step again in one process, against the first: loss '
        f'{again["loss"]:.6f}; {ddp_errors_note(ddp_errors(again, one))} (the card\'s own '
        f'spread)')
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    for old in DDP_DIR.glob('rank*.pt'):
        old.unlink()
    # NCCL refuses two ranks on one card: gloo carries their collectives
    ctx = ddp.spawn(ddp_rank, DDP_RANKS, device='cuda:0', backend='gloo',
                    args=(str(DDP_DIR), DDP_FAULTS), join=False)
    deadline = time.monotonic() + DDP_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise SystemExit(f'[{phase}] FAILED: the ranks did not end within {DDP_TIMEOUT_S} s')
    ranks = [torch.load(DDP_DIR / f'rank{r}.pt', weights_only=False) for r in range(DDP_RANKS)]
    paths = {'ddp_one_process': one['launches']}
    for r, got in enumerate(ranks):
        note = ddp_agreement(phase, got, one)
        paths[f'ddp_rank{r}'] = got['launches']
        log(phase, f'rank {r} of {DDP_RANKS} (gloo, one card), {DDP_B // DDP_RANKS} clouds: loss '
            f'{got["loss"]:.6f}; {note} (bounds {DDP_LOSS_RTOL:g}, {DDP_GRAD_REL_L2:g}); '
            f'launches {got["launches"]} as one process\'s; ms per step '
            + ' '.join(f'{t:.1f}' for t in got['ms'])
            + f'; all-reduce of the gradients ({got["grad_bytes"]} bytes) '
            f'{got["allreduce_ms"]:.2f} ms on {smi}')
    apart = max(float((ranks[0]['grads'][k] - ranks[1]['grads'][k]).abs().max())
                for k in ranks[0]['grads'])
    if apart != 0.0:
        raise SystemExit(f'[{phase}] FAILED: the ranks\' gradients differ by {apart:.3e}')
    log(phase, 'both ranks hold the same all-reduced gradients, bit for bit')
    missed = []
    for name, _, _ in DDP_FAULTS:
        got = ranks[0]['faults'][name]
        e = ddp_errors(got, one)
        caught = max(e['groups'].values()) > DDP_GRAD_REL_L2
        if not caught:
            missed.append(name)
        log(phase, f'planted fault, {name} ({", ".join(got["planted"][:2])}'
            f'{", ..." if len(got["planted"]) > 2 else ""}; {len(got["planted"])} layers): loss '
            f'{got["loss"]:.6f}; {ddp_errors_note(e)}: '
            + ('caught' if caught else 'NOT caught') + f' by the bound {DDP_GRAD_REL_L2:g}')
    if missed:
        raise SystemExit(f'[{phase}] FAILED: the gradient bound misses the planted faults '
                         f'{missed}')

    # a world of one under NCCL, in this process
    env = {k: os.environ.get(k) for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                                          'MASTER_PORT')}
    os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='localhost',
                      MASTER_PORT=str(ddp.free_port()))
    try:
        ddp.init_distributed('cuda', backend='nccl')
        backend = dist.get_backend()
        nccl = ddp_flagship_steps('cuda:0', steps=2)
        ar_ms = ddp_allreduce_ms('cuda:0', nccl['grad_bytes'])
    finally:
        ddp.shutdown()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if backend != 'nccl' or not np.isfinite(nccl['loss']) or nccl['launches'] != one['launches']:
        raise SystemExit(f'[{phase}] FAILED: NCCL ({backend}) step loss {nccl["loss"]}, launches '
                         f'{nccl["launches"]}')
    paths['ddp_nccl'] = nccl['launches']
    log(phase, f'NCCL, a world of one, DistributedDataParallel over all {DDP_B} clouds: loss '
        f'{nccl["loss"]:.6f} (one process {one["loss"]:.6f}), ms per step '
        + ' '.join(f'{t:.1f}' for t in nccl['ms'])
        + f'; NCCL all-reduce of {nccl["grad_bytes"]} bytes {ar_ms:.3f} ms on {smi}')
    log('time', f'phase 74 {time.perf_counter() - t0:.1f} s')
    return paths


KERNEL_TABLE = (
    ('farthest_point_sample', 'pdm_ssd_torch/csrc/fps.cu', 'pdm_ssd_tpu/ops/pallas/fps.py:60'),
    ('window_select', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/grid_query.py:240'),
    ('gather_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:146'),
    ('scatter_add_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:227'),
    ('ball_query', 'pdm_ssd_torch/csrc/ball_query.cu',
     'pdm_ssd_tpu/ops/pallas/retired/grid_query.py:112'),
    ('sparse_conv', 'pdm_ssd_torch/csrc/sparse_conv.cu',
     'tools/microbench_sparse_gather.py:175, tools/microbench_sparse_gather2.py:94 and :182, '
     'tools/microbench_sparse_gather3.py:156'),
    ('gather_rows_bf16', 'pdm_ssd_torch/csrc/group.cu', 'tools/microbench_pallas_gather.py:66'),
    ('sparse_conv_wgrad', 'pdm_ssd_torch/csrc/sparse_conv_wgrad.cu',
     'the backward of rows 7 to 10 (Pallas forward only): '
     'pdm_ssd_tpu/models/backbones_3d/sparse_backbone.py:354, the dot_general of _scm_bwd'),
)


def launch_counters() -> dict:
    """Each kernel wrapper of the port and the attribute that counts its
    launches, by the name the `kernels` line gives it."""
    from pdm_ssd_torch.ops import ball_query as bq
    from pdm_ssd_torch.ops import fps, group
    from pdm_ssd_torch.ops import sparse_conv as sc
    # the row gather has two entry points, float32 and bfloat16, each with
    # its own counter on the one wrapper; FPS and the ball query count their
    # launches by path too
    return {'farthest_point_sample': (fps.farthest_point_sample_cuda, 'launches'),
            'window_select': (group.window_select_cuda, 'launches'),
            'gather_rows': (group.gather_rows_cuda, 'launches'),
            'scatter_add_rows': (group.scatter_add_rows_cuda, 'launches'),
            'ball_query': (bq.ball_query_cuda, 'launches'),
            'sparse_conv': (sc.sparse_conv_cuda, 'launches'),
            'sparse_conv_wgrad': (sc.sparse_conv_wgrad_cuda, 'launches'),
            'gather_rows_bf16': (group.gather_rows_cuda, 'launches_bf16'),
            'fps cluster path': (fps.farthest_point_sample_cuda, 'launches_cluster'),
            'fps block path': (fps.farthest_point_sample_cuda, 'launches_block'),
            'fps masked': (fps.farthest_point_sample_cuda, 'launches_masked'),
            'ball query grid path': (bq.ball_query_cuda, 'launches_grid'),
            'ball query walk path': (bq.ball_query_cuda, 'launches_walk')}


def main() -> None:
    global T0
    T0 = time.perf_counter()
    name, smi = device_check()
    sys.path.insert(0, str(REPO))
    from pdm_ssd_torch.ops import ball_query as bq
    from pdm_ssd_torch.ops import dispatch, fps, group, kernels, sa_fused
    from pdm_ssd_torch.ops import pointnet2 as plain
    from pdm_ssd_torch.ops import sparse_conv as sc
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file

    t0 = time.perf_counter()
    libs = kernels.build()
    kernels.load()
    log('2 build', f'{", ".join(so.name for so in libs.values())} in '
        f'{time.perf_counter() - t0:.1f} s')
    for line in kernels.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            print(f'    {line.strip()}')
    wrappers = launch_counters()

    stats = {'farthest_point_sample': fps_phase(fps, plain, synthetic.kitti_points)}
    fps_stats = stats['farthest_point_sample']
    log('3 fps', f'(8, 16384) -> 4096: kernel {fps_stats.pop("note")}; plain torch '
        f'{fps_stats["plain_ms"]:.3f} ms (one call, median of 5), bound '
        f'{fps_stats["bound_ms"]:.4f} ms by {fps_stats["bound_by"]} on {smi}')

    os.chdir(REPO)   # the config names its base config relative to the repo
    cfg = cfg_from_yaml_file(str(REPO / CFG), CfgNode())
    cuda_vs_cpu_phase(cfg, dispatch, synthetic)
    predict_launches = predict_phase(cfg, wrappers, synthetic, smi)
    for kern, r in group_phase(cfg, fps, group, sa_fused, synthetic).items():
        stats[kern] = {'max_abs_err': r.pop('err'), **r, 'bound_by': 'bytes'}
    host_breakdown(group, kernels)
    grads_cuda_vs_cpu_phase(cfg, synthetic)
    train_launches = train_phase(cfg, wrappers, synthetic, smi)

    shipped = cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode())
    rcnn = synthetic.pointrcnn_fp3(cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode()))
    stats['ball_query'] = ball_query_phase(rcnn, bq, fps, plain, synthetic)
    small = synthetic.pointrcnn_fp3(cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode()))
    small.MODEL.BACKBONE_3D.SA_CONFIG.NPOINTS = [1024, 256, 64]
    cuda_vs_cpu_phase(small, dispatch, synthetic, phase='10 pointrcnn cuda-vs-cpu',
                      fps_npoint=256)
    rcnn_launches = predict_phase(rcnn, wrappers, synthetic, smi, phase='11 pointrcnn predict',
                                  B=rcnn.OPTIMIZATION.BATCH_SIZE_PER_GPU,
                                  expected=POINTRCNN_PREDICT_LAUNCHES)
    shipped_predict_phase(shipped, synthetic)

    second = cfg_from_yaml_file(str(REPO / SECOND_CFG), CfgNode())
    second_net = synthetic.open_score_gate(synthetic.random_model(second, 'cuda', seed=7))
    second_in = second_inputs(second, synthetic, second.OPTIMIZATION.BATCH_SIZE_PER_GPU,
                              SECOND_POINTS, seed=5)
    stats['sparse_conv'] = sparse_conv_phase(second_net, second_in, sc, smi)
    stats['gather_rows_bf16'] = gather_bf16_phase(second_in, group, smi)
    second_cuda_vs_cpu_phase(synthetic.tiny_second_cfg(
        cfg_from_yaml_file(str(REPO / SECOND_CFG), CfgNode())), synthetic)
    second_launches = second_predict_phase(second, second_net, second_in, wrappers, synthetic,
                                           smi)
    del second_net, second_in
    eval_launches = kitti_eval_phase(wrappers, synthetic, smi)
    train_loop_launches = train_loop_phase(wrappers, synthetic, smi)
    bench_phase(smi)
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 18')

    new_paths = grid_family_phases(wrappers, dispatch, synthetic, smi, CfgNode,
                                   cfg_from_yaml_file)

    # SECOND's training: the sparse conv's backward, the tiny model's
    # gradients, the train step as shipped, and the KITTI loops
    bwd_net = synthetic.random_model(second, 'cuda', seed=7)
    dgrad, stats['sparse_conv_wgrad'] = sparse_conv_backward_phase(second, bwd_net, synthetic,
                                                                   sc, smi)
    stats['sparse_conv'].update({f'dgrad_{k}': v for k, v in dgrad.items()})
    del bwd_net
    second_grads_cuda_vs_cpu_phase(synthetic.tiny_second_cfg(
        cfg_from_yaml_file(str(REPO / SECOND_CFG), CfgNode())), synthetic)
    B2 = second.OPTIMIZATION.BATCH_SIZE_PER_GPU
    new_paths['second_train'] = second_train_phase(second, wrappers, synthetic, smi)
    new_paths['second_eval_loop'] = kitti_eval_phase(
        wrappers, synthetic, smi, SECOND_CFG, '30 second eval loop', SECOND_PREDICT_LAUNCHES,
        adjust=synthetic.open_score_gate, cpu_check=False, B=B2)
    new_paths['second_train_loop'] = train_loop_phase(
        wrappers, synthetic, smi, SECOND_CFG, '30 second train loop', SECOND_TRAIN_LAUNCHES, B=B2)

    # the pillar and dense-voxel family of `Detector3D`, then VoxelNeXt, the
    # focal SECOND and TTA_FLIP
    for more in (family_phases(wrappers, synthetic, smi, cfg_from_yaml_file),
                 ladder_phases(wrappers, sc, synthetic, smi, cfg_from_yaml_file)):
        if set(more) & set(new_paths):
            raise SystemExit(f'[kernels] FAILED: path names used twice: '
                             f'{set(more) & set(new_paths)}')
        new_paths.update(more)

    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 40')

    # the two-stage family: PointRCNN's training, PV-RCNN and Voxel R-CNN
    more, two_stage_sums = two_stage_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    for kern, r in two_stage_sums.items():
        stats[kern].update({f'two_stage_{k}': v for k, v in r.items()})

    # the rest of the two-stage family: SECOND-IoU, Part-A2, PV-RCNN++
    more, masked = rest_two_stage_phases(wrappers, fps, plain, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    stats['farthest_point_sample'].update(masked)
    stats['farthest_point_sample'].update(
        {f'launches_masked_{path}': launches['fps masked'] for path, launches in more.items()})
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 50')

    # the nuScenes half of the PDM family: pdm_ssd_nuscenes.yaml and its
    # six-group variant
    more = nuscenes_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    missing = [f'launches_nuscenes_{p}' for p in NUSCENES_PATHS if f'nuscenes_{p}' not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 54')

    # DSVT and TransFusion: the window-attention backbone and the query head
    more = query_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    missing = [f'launches_{m}_{p}' for m, _ in QUERY_MODELS for p in QUERY_PATHS
               if f'{m}_{p}' not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 58')

    # MPPNet on the Waymo sequence path: the trajectory-transformer head, its
    # memory bank and the Waymo loops
    more, crop = waymo_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    stats['gather_rows'].update({f'mppnet_crop_{k}': v for k, v in crop.items()})
    missing = [f'launches_mppnet_{p}' for p in MPPNET_PATHS if f'mppnet_{p}' not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 62')

    # BEVFusion: the camera branch (Swin, the neck, the depth-aware Lift-Splat)
    # fused with the pillar branch, and the camera half of the nuScenes loops
    more = bevfusion_phases(wrappers, synthetic, smi, cfg_from_yaml_file)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    missing = [f'launches_bevfusion_{p}' for p in BEVFUSION_PATHS
               if f'bevfusion_{p}' not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 66')

    # CaDDN: the monocular depth head, the frustum sampled into voxels on the
    # row gather, and the KITTI camera data path's loops
    more, shapes = caddn_phases(wrappers, synthetic, group, smi)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    for kern, r in shapes.items():
        stats[kern].update({f'caddn_{k}': v for k, v in r.items()})
    missing = [f'launches_caddn_{p}' for p in CADDN_PATHS if f'caddn_{p}' not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 70')

    # the rest of the host data path: the flagship served on the ONCE,
    # Argoverse 2, Lyft, Pandaset and custom mini sets, and trained on the
    # custom one with GT sampling and the six local augmentations
    more = sets_phases(wrappers, synthetic, smi)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    missing = [f'launches_{p}' for p in SET_PATHS if p not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 73')

    # data parallelism: the flagship's step on two ranks against one process,
    # and a step under NCCL
    more = ddp_phase(smi)
    if set(more) & set(new_paths):
        raise SystemExit(f'[kernels] FAILED: path names used twice: {set(more) & set(new_paths)}')
    new_paths.update(more)
    missing = [f'launches_{p}' for p in DDP_PATHS if p not in new_paths]
    if missing:
        raise SystemExit(f'[kernels] FAILED: no count for {missing}')
    log('time', f'{time.perf_counter() - T0:.1f} s since the start, after phase 74')

    # `launches` is the count from the run of a main path: the flagship's five
    # training steps of phase 8 for its four kernels, PointRCNN's predict of
    # phase 11 for the ball query, SECOND's predict of phase 15 for the sparse
    # conv and for the row gather's bfloat16 entry point. Every count is of the
    # entry point it stands under: no model of the port keeps bfloat16 tables,
    # so the bfloat16 entry is launched by phase 13 alone and every path counts
    # 0 for it, while SECOND's predict launches the float32 entry once. The
    # grouping kernels' times, bounds and library times are sums over the
    # flagship's three SA levels (the launches of one forward, and of one
    # backward for the scatter-add), the ball query's over PointRCNN's three
    # backbone levels, the sparse conv's over SECOND's twelve layers; `walk_ms`
    # is the time of what a kernel's own walk does, at the peak rate, beside
    # the bound of what the function needs; `launches_eval_loop` and
    # `launches_train_loop` are the counts of phases 16 and 17, each set to 0
    # just before its loop, and the `launches_<path>` of phases 20 to 26 the
    # counts of those paths (each set to 0 just before it: the grid family's
    # predict, train step, eval and train loops and the large scene read 0 for
    # every kernel, the aux train step's 5 steps the flagship's step's four
    # kernels, TTA's predict twice the flagship's), `launches_second_train` the
    # five steps of phase 29 and `launches_second_{eval,train}_loop` the loops
    # of phase 30, `launches_<name>_{predict,train}` of phases 32 and 33 (name
    # one of pointpillar, centerpoint_pillar, pillarnet, dense_second) and
    # `launches_<name>_{eval,train}_loop` of phase 34 (0 for every kernel on
    # each), `launches_{voxelnext,second_focal}_{predict,train}` of phases 37
    # and 38 and `launches_voxelnext_{eval,train}_loop` of phase 39 (the row
    # gather once and the sparse conv 18 times a predict, 35 a step, the
    # weight gradient 18 a step); the weight gradient's `launches` are phase 29's, its times
    # and bounds sums over the twelve layers of phase 27, and the sparse conv's
    # `dgrad_*` keys the same for its data-gradient launches (11 layers); the
    # sparse conv's `library_ms` (and the backward's) is a pair of PyTorch
    # calls (gather, `torch.matmul`), since no single call computes it;
    # `max_abs_err` is kernel against plain version; the
    # `launches_nuscenes*` counts of phases 52 to 54 and the
    # `launches_{dsvt,transfusion}_*` counts of phases 56 to 58 are 0 for
    # every kernel; the `launches_mppnet_*` counts of phases 60 to 62 are
    # MPPNet's crops, `gather_rows` alone: one a frame of a forward, twice
    # that a training step; the row gather's `mppnet_crop_*` keys are its
    # times and bound at one frame's crops of phase 60 (B=2, N=16384, C=6,
    # R=96 * 128); the `launches_bevfusion_*` counts of phases 64 to 66 are 0
    # for every kernel; the `launches_caddn_*` counts of phases 68 to 70 are
    # CaDDN's frustum sample, 8 row gathers a forward and 8 scatter-adds a
    # backward; the `caddn_*` keys of the row gather and the scatter-add are
    # their numbers at one corner of phase 67 (B=2, 2632000 voxels, 586560
    # frustum rows of 64), the gather's beside the 8 launches' and the one
    # launch's ms; the `launches_{once,argo2,lyft,pandaset,custom}_eval_loop`
    # counts of phase 72 are the flagship's predict launches a batch, and
    # `launches_custom_train_loop` of phase 73 its training step's a step;
    # the `launches_ddp_*` counts of phase 74 are one training step's, in one
    # process, in each of the two ranks and under NCCL
    main_path = {kern: train_launches for kern, _, _ in KERNEL_TABLE}
    main_path.update(ball_query=rcnn_launches, sparse_conv=second_launches,
                     gather_rows_bf16=second_launches,
                     sparse_conv_wgrad=new_paths['second_train'])
    for kern in main_path:
        if kern != 'gather_rows_bf16' and main_path[kern][kern] < 1:
            raise SystemExit(f'[kernels] FAILED: {kern} was not launched on its main path')
    print(json.dumps({'kernels': [{
        'name': kern, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': main_path[kern][kern],
        'launches_per_predict': predict_launches[kern],
        'launches_per_pointrcnn_predict': rcnn_launches[kern],
        'launches_per_second_predict': second_launches[kern],
        'launches_eval_loop': eval_launches[kern],
        'launches_train_loop': train_loop_launches[kern],
        **{f'launches_{path}': launches[kern] for path, launches in new_paths.items()},
        **stats[kern]} for kern, source, replaces in KERNEL_TABLE]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
