#!/usr/bin/env python3
"""Smoke run of the PyTorch port (os2d_torch) on one NVIDIA card.

    python3 chip_smoke.py            # one card; exits non-zero on any failure
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of one eval
                                     # dispatch (fp32, fp32+fold, bf16+fold),
                                     # one train step, one served request (with
                                     # its host stages), one served batch of 8
                                     # and one pretrainer step

The model is `Os2dConfig()` at full width (ResNet50-C4, 1024 channels) with
seeded random weights. Its resample runs at the "default" tier, the bf16 hat
kernel (csrc/hat_resample.cu); the "highest" tier runs the fp32 gather kernel
(csrc/resample.cu) and the "int8" tier the int8 hat kernel
(csrc/int8_hat_resample.cu). The three share the tile skeleton
csrc/resample_tile.cuh.
Training differentiates the resample with the CUDA kernel
csrc/resample_backward.cu (the hat form's gradient under JAX's rules).
Phases, each printing one JSON line:
  1. env      the card (nvidia-smi name and power limit), torch/CUDA versions,
              the TF32 flags as the model sets them, and the kernel builds
              (one nvcc per source in os2d_torch/csrc, all started together,
              for sm_90a) with their seconds.
  2. kernel   each kernel against its plain PyTorch version: the gather at
              rtol 1e-5, atol 1e-6; the hat kernel at rtol 1e-5, atol 1e-5
              and within 4e-3 (the "default" prescreen margin) of the exact
              fp32 gather; whether each agreed to the bit. Ragged small
              shapes (a single row and column among them), every level of
              the bench protocol (B=2, C=16) and C=128 at the largest, each
              with uniform px/py (almost no corr sector read twice) and with
              near-identity px/py (a tile's rows share each sector, as on
              the main path); px/py up to 0.5 outside the map; H=300;
              B*C = 65600; half-way px/py.
     int8_kernel  the int8 kernel against its plain version, from both
              coordinate sources, at rtol 1e-5, atol 1e-6 and to the bit
              (it fails otherwise): from px/py on the same cases; from theta
              (the interior-first head's source: theta, the anchors'
              feature-map boxes and the template lattice) on the ragged
              shapes and every bench level (widths 40, 50, 80, 112 among
              them) with identity, near-identity, random and outside-the-map
              theta, and on C=128 at the largest level with identity theta;
              and in phase 8 on the main path's own theta at every level.
     group_norm_kernel  the GroupNorm kernels (csrc/group_norm_nhwc.cu)
              forward and backward at the slots of exp2's V2 training recipe
              (GN_SLOTS: the stem, layer1's and layer3's bn3 of the 4 x
              600-px scene pass, the stem and layer3's bn3 of the 16 x
              240-px class pass) against their plain versions in fp64:
              each output's error within twice F.group_norm's fp32 error
              (and its autograd's) on the same input plus 1e-6 of the
              output's largest magnitude; two calls equal to the bit; then
              each slot's CUDA-event ms of the kernels, their plain versions
              in fp32 and F.group_norm with its autograd backward, beside
              the least time by bytes.
     frozen_bn_kernel  the frozen BatchNorm kernel (csrc/frozen_bn_act_nhwc.cu)
              at FBN_SLOTS of the main path's 1.6 level (the stem's slot,
              layer3's tail with and without its downsample): output equal
              to ATen's eager chain to the bit and two calls to the bit
              (it fails otherwise), the error against the plain version in
              fp64; then each slot's CUDA-event ms of the kernel and of the
              eager chain beside the least time by bytes, and the host's
              microseconds a call of each.
  3. planted  the planted-patch scenes of tests/test_end_to_end_eval.py
              through Evaluator.detect_images at the default tier: each patch
              must be the top valid detection of its class (IoU > 0.5), and
              the card's detections must agree with the same model on the CPU
              (scores 1e-4, boxes 1e-2 px).
  4. evaluate engine.evaluate.evaluate() over the planted dataset written as
              files and read through the port's data layer, two pyramid
              levels, TTA "horflip_rotation90" (8 views per class) and a
              finite nms_score_threshold (the class prescreen runs): mAP@0.50
              must be >= 0.9 and equal to the same run on the CPU.
  5. prescreen  Evaluator.detect_images_prescreened with a one-hot class bank
              and a threshold between the classes' best scores: some but not
              all classes are pruned, the same ones as on the CPU, and the
              survivors' detections match the full path (scores 1e-4, boxes
              1e-3 px) and the CPU's.
  6. main     Evaluator.detect_images at the bench protocol (bench.py):
              B=2 images of 1280x960, the 7-level pyramid, 16 classes in one
              chunk, default tier. One warmup dispatch, then timed
              dispatches; the hat kernel must launch 7 times per dispatch.
  7. main_highest  the same protocol at resample_precision="highest": the
              gather kernel must launch 7 times per dispatch.
     tiers    both tiers in turns (default, highest, highest, default, four
              rounds): median img/s and spread of each.
  8. main_path_inputs / resample_timing  one more default-tier dispatch with
              the head's resample inputs captured at every level: both
              kernels held against their plain versions there, with their
              CUDA-event times per level; then their times per launch on
              the largest level, beside their bounds, their
              plain versions and one PyTorch call each that computes the
              same function (F.grid_sample and a masked sum; the port calls
              neither); the int8 kernel likewise from the main path's theta
              and boxes (the dispatch's calls of the head's coordinate
              function are captured too), its yardstick F.grid_sample over
              round(corr*127)/127 * mask, an approximation (its row weights
              are not quantized), its bound the bytes of the corr prefix,
              theta, boxes, lattice, mask and output.
  9. train_first_step  the training path's first TrainStep at the default
              recipe (below) but with RLL's margin_pos at 1.0, on the card and
              on the CPU from the same weights and batch: loss and gradient
              norm within rtol 2e-3 (fp32 convolutions and their backward in
              another order on the two devices, and the bf16 hat forward on
              both). Random weights score every anchor above the recipe's
              0.6, which leaves the cls gradient (the backward kernel's
              dpx/dpy) zero; at 1.0 every positive has a loss, and the step
              must show a positive loss and a non-zero cls cotangent. The
              card's backward-kernel inputs are captured for phase 11.
 10. train    engine.train.trainval_loop at the default train recipe of
              get_default_cfg() (batch 4, 600x600 patches, class_batch_size 15
              padded to 16, class images of 240 px, SGD lr 1e-4, momentum 0.9,
              weight decay 1e-4, max_grad_norm 100, RLL with remapping,
              train_features) with Os2dConfig() at full width, on a synthetic
              planted dataset of 16 classes written under build/: TRAIN_STEPS
              steps and one eval with the objective as criterion. Finite losses
              and gradient norms, parameters that moved, and one launch of the
              hat kernel and one of the backward kernel per step.
 11. train_timing  TrainStep at the same recipe: median and spread of s/step
              over timed steps after one warmup step, with both kernels
              counted per step; then the backward kernel on phase 9's
              captured inputs: held against its plain version (rtol 1e-5,
              atol 1e-6 times each part's largest magnitude; no part may be
              all zeros) and timed per launch, beside its bound, its plain
              version and one PyTorch call that computes the same gradient
              (aten.grid_sampler_2d_backward; the port calls none of it).
              --profile adds a breakdown of one train step by kernel family.
 12. nms_blocked  NMS above dense_limit (the block-sequential path), card
              against CPU on the same candidates, exact keep masks: the
              cross-class NMS over 33 rows x 256 = 8448 boxes (one 320x320
              level, pre_top_k 1024) and a per-row NMS over all 39,580
              anchors of a bench image (B=1, G=2), with its ms and fixpoint
              sweeps (one host wait each).
 13. numeric_modes  at full width: fp32 with BN folded against unfolded on
              the planted scenes (same detections, scores 1e-4); bf16, folded
              and unfolded, the card against the CPU on the CPU's own inputs
              by the bf16 rule (RMS(card - cpu_bf16) <= 0.25 RMS(cpu_bf16 -
              cpu_fp32) for every backbone convolution, 0.6 for the stem,
              each bottleneck and the head, see BF16_STAGE_RULE), with the
              dtypes of the features, class bank and scores; evaluate() with
              cfg.tpu.fold_bn, mAP@0.50 card = CPU.
 14. numeric_timing  the bench protocol with fp32, fp32+fold, bf16 and
              bf16+fold in turns in one process: median dispatch ms, spread
              and img/s of each, the hat kernel 7 times per dispatch in every
              mode. --profile adds device time by family for fp32+fold and
              bf16+fold.
 15. train_first_step_bf16  phase 9's first step with compute_dtype
              bfloat16, card against CPU: loss and gradient norm within 3x
              |CPU bf16 - CPU fp32| or phase 9's rtol, whichever is larger;
              one launch of each kernel.
 16. mining   engine.mining.mine_hard_patches at get_default_cfg()'s mining
              recipe (2 random pyramid scales, 200 negative classes: all 16
              here, 10 patches per image, NMS IoU 0.5) with Os2dConfig() at
              the default tier on phase 10's planted train set: the card
              against the CPU from the same weights and seeds on 2 images
              (image ids, record order, roles, levels, labels, anchor
              indices, crop and anchor boxes exactly; losses and scores
              within rtol 2e-3, atol 1e-6), then all 8 images on the card:
              s/image, and the hat kernel once per (batch, level, class
              chunk).
 17. train_mining  trainval_loop at the default recipe with do_mining,
              mine_hard_patches_iter 2, TRAIN_STEPS steps and
              cfg.tpu.device_class_cache "required": mining at iterations 0
              and 2, every batch cropped at mined records and holding their
              labels, class images from the cache, finite losses, one hat
              and one backward launch per step.
 18. class_cache  the device class cache of the default recipe: the
              stack's MB; its class tensor on the card equal to the host
              path's on unflipped batches for all six resample methods and
              to its CPU gather for every method and flip; TrainStep s/step
              (upload and step) and the batch build, with the cache and with
              host-built class images in turns in one process.
 19. evaluate_host_pyramid  evaluate() with cfg.tpu.device_side_pyramid
              False over phase 4's planted set at two levels: mAP@0.50 1.0
              on the card and on the CPU, the hat kernel once per (image,
              level).
 20. checkpoint  a seeded card model (seed 1) written as a reference-layout
              `.pth` (its keys renamed to the reference's, num_batches_tracked
              added) and as the port's own `utils.logger.checkpoint_model`
              `.pth` under build/; each loaded through
              `models.checkpoint.load_checkpoint_file` into a card model
              (seed 0): the state_dict equal to the source's to the bit, and
              the first request (phase 21's) answered as by the source
              (scores 1e-4, boxes 1e-2 px).
 21. serve    `api.service.DetectionService` on the model loaded from the
              reference layout, at the shipped TARGET_IMAGE_SIZE 1500, the
              default tier and a 16-class catalog (the planted patch and 15
              others): detect_from_request on a planted 1280x960 PNG/base64
              request (fm 71x94; top box on the patch, card against CPU at
              scores 1e-4, boxes 1e-2 px); detect_batch of 8 planted scenes
              of mixed sizes on the 1500x1500 canvas (B=8, fm 94x94; every
              top box on its patch); a DynamicBatcher(max_batch=8) with 8
              client threads (each result equal to detect_batch's, scores
              1e-5; the batch sizes formed); a 64-class catalog through the
              prescreen (`stats`), equal to the full path; one "highest"
              request (the gather, once); the hat kernel held against its
              plain version on the tensors the service passed it (B=1 71x94,
              B=8 94x94) and timed there beside its bound. One hat launch
              per dispatch (one level, one class chunk), the padded survivor
              chunks under the prescreen. Timed after warm-up: sequential
              requests (median, p99 ms, requests/s) and 8 clients x 8
              requests through the batcher (img/s, median, p99 ms).
 22. distributed  the mesh (os2d_torch/parallel), each rank a process of its
              own (parallel.spawn.run_local_group, a deadline on each group):
              (a) one nccl rank on cuda:0 takes DIST_STEPS data-parallel
              TrainSteps at phase 10's recipe (batch 4, default tier,
              margin_pos 1.0) from the weights of the plain TrainStep that
              this process takes on the same batches, both under the port's
              defaults (a second plain run equal to the bit): the
              loss terms within rtol 2e-5, weights within rtol 1e-4, atol
              1e-6 (the gradient norm is reported); s/step of the
              data-parallel and the plain step in turns; then phase 4's
              planted eval at "highest" sharded by classes: mAP@0.50 1.0 as
              unsharded, the packed detections of the planted batch within
              scores 1e-5, boxes 1e-2 px, valid flags equal. (b) two gloo
              ranks share cuda:0 (NCCL refuses two ranks on one device): the
              same steps at 2 images per rank, losses as in (a), the ranks'
              weights equal to the bit; the eval sharded by classes and by
              images, held as in (a); s/step per rank (two processes on one
              card: no measure of scaling). Each rank counts its launches
              and returns them: the hat kernel and the backward DIST_STEPS
              times in each rank's steps, the gather in each eval.
Then the model options, each with the main path's weights (phases 23-26):
 23. int8_tier  planted patches with resample_precision "int8", card
              against CPU (scores within INT8_SCORE_ATOL); the bench protocol
              at "int8" and "default" in turns (OPTION_ROUNDS rounds), the
              int8 kernel 7 times per int8 dispatch.
 24. int8_bank  evaluate() with cfg.tpu.quantize_class_feats over phase 4's
              planted files (no TTA, threshold 0.5): mAP@0.50 1.0 on the
              card and the CPU, the prescreen not applied; the bench bank's
              MiB as int8 against fp32, from the tensors.
 25. grid_path  corr_interior_first=False: planted detections card against
              CPU at "default" and "highest", the head's outputs at full
              width card against CPU and against the interior-first head
              (GRID_HEAD_ATOL); evaluate() as phase 4 (mAP 1.0); phase 9's
              first step card against CPU; the bench dispatch in turns with
              interior-first.
 26. group_norm  Os2dConfig(use_group_norm=True): planted detections card
              against CPU; phase 9's first step card against CPU; the
              ResNet101-C4 forward with BN and with GN on a GN_CROP crop,
              card against CPU within R101_RTOL_TO_MAX of the largest
              feature; the bench dispatch and the pyramid + backbone alone,
              GN and BN in turns. The planted run must launch the GroupNorm
              forward, the first step (counted from a reset just before it,
              eager at first sight) the forward and the backward 2 x 43
              times each.
Then evaluate()'s host side and the figures (phases 27-29):
 27. eval_prefetch  evaluate() over HOST_SCENES planted 1280x960 scenes
              written as files (batch 2, EVAL_PYRAMID, no TTA, threshold
              0.5: the prescreen runs) with the producer thread
              (cfg.tpu.eval_prefetch_depth 1, pinned uploads on a copy
              stream) and with the serial loop (depth 0) in turns
              (HOST_ROUNDS rounds): their wall times and, round by round,
              the serial wall less the prefetched one (the time the
              producer hides); detections bit-equal between the loops and
              mAP@0.50 1.0 in both. The card against the CPU on the first
              HOST_CPU_SCENES scenes: mAP@0.50 1.0 on both, the same
              detection on each planted patch (the best of its class
              overlapping it: scores HOST_SCORE_ATOL, boxes HOST_BOX_ATOL
              px) and the same number of detections per image. Then a
              serial loop timed stage by stage (StageTimer, synchronized):
              host prep (the raw iterator and the stack), upload and
              dispatch per batch.
 28. class_chunks  the bench protocol at CHUNK_CLASSES classes (one
              template's features with noise, tools/bench_classes_torch.py),
              B=1, eval_class_chunk CHUNK_SIZE: per-level chunks against
              uniform ones in turns (CHUNK_ROUNDS rounds), s/image and peak
              MiB of each; the two outputs torch.equal; the hat kernel once
              per level and chunk of each mode; one "highest" dispatch with
              per-level chunks (the gather once per level and chunk).
 29. visualization  evaluate() over phase 4's planted files with
              cfg.visualization.eval's show_detections, show_gt_boxes and
              show_class_heatmaps (the chunked per-level path), and
              trainval_loop at phase 10's recipe with no step and
              cfg.visualization.train's show_gt_boxes_dataloader and
              show_target_remapping (margin_pos 1.0), on the card and the
              CPU from the same weights: the same figures, the first of each
              kind written as a file; heatmaps and the remapping's score,
              IoU and loss maps within VIZ_ATOL, targets equal, the loss
              gradients within VIZ_GRAD_RTOL / VIZ_GRAD_ATOL.
Then the last modules of the JAX package (phases 30-32):
 30. yuv_wire  evaluate() over phase 4's planted scenes written as
              IMG_W x IMG_H files (each pixel replicated 2x2, so that
              the 0.5 level sees the patches as phase 4 does) (batch 2, WIRE_LEVELS, no TTA, threshold 0.5: the prescreen
              runs) with upload_pixel_format rgb8 and yuv420 in turns
              (WIRE_ROUNDS rounds): mAP@0.50 1.0 under both and on the CPU
              under yuv420, the card's planted hits equal to the CPU's
              (HOST_SCORE_ATOL, HOST_BOX_ATOL); the wire's decode on the card
              against the CPU's on the batch (floats within 1e-4, uint8
              equal); bytes per batch (1.5 against 3 B/px, exactly half)
              and the host encode, upload and dispatch ms per batch of each
              wire in turns (StageTimer, synchronized); the hat kernel
              counted. Then phase 9's first step (its batch, weights and
              margin) through rgb8 and yuv420 on the card and yuv420 on the
              CPU: the yuv420 loss within WIRE_LOSS_RTOL of rgb8's, loss and
              gradient norm within TRAIN_CPU_RTOL card against CPU, one hat
              and one backward launch.
 31. pretrain  the ImageNet pretrainer (os2d_torch/pretrain) at its default
              arch, crop and dtype (ResNet101, 224 px, bf16) at batch
              PRETRAIN_BATCH (a cut of its 256) on a synthetic ImageFolder
              written under build/ (PRETRAIN_CLASSES classes of
              PRETRAIN_PER_CLASS JPEGs, the last excluded): the first step's
              loss and top-1 on the card against the CPU from the same
              weights (PRETRAIN_LOSS_RTOL, PRETRAIN_TOP1_ATOL); the export
              after it through models.checkpoint.load_checkpoint_file into a
              ResNet101 Os2dModel, whose C4 features equal the classifier's
              trunk within PRETRAIN_C4_RTOL_TO_MAX; then s/step (upload and
              step, synchronized) over PRETRAIN_TIMED_STEPS steps after a
              warmup, the host's batch load time apart; then train() as a
              user calls it, PRETRAIN_TRAIN_STEPS steps from its model's
              init (crops, uploads and steps), as img/s. cuDNN and cuBLAS
              only: no hand kernel runs here.
 32. checkpoint_backend  phase 10's trained model and optimizer written
              with cfg.tpu.checkpoint_backend "orbax"
              (torch.distributed.checkpoint into a .dcp tree beside a stub)
              and with "pickle", each read back, timed: net and optimizer
              state bit-equal, and through load_checkpoint_file into a card
              model and a fresh optimizer, bit-equal.
 33. experiments  the experiment launchers' twins on a planted tree in the
              GroZi layout written under build/ (GROZI_PLANTED: scenes of
              3264x2448, GroZi's source size, read at the published 1280 px;
              its path as main's DATA_PATH): the first job of
              experiments/launcher_grozi_eval_torch.py --no-launch (grozi-val-
              new-cl at 1280 px, the default 7-level pyramid, Os2dConfig()'s
              full width) with init.model a reference-layout .pth of
              Os2dModel(Os2dConfig(), seed=1)'s weights, run through
              os2d_torch.main.main(argv) in this process, its log written as
              the launcher's job script tees it: mAP@0.50 >= 0.9 on the
              planted patches, read back by experiments/launcher_eval_
              collect_torch.py from the log, and at least one hat launch per
              level; then the first job of experiments/launcher_exp1_torch.py
              (lossCL, the simplified affine model) from a backbone-only .pth
              of the same weights, cut to EXPERIMENT_TRAIN_STEPS iterations:
              finite losses, one backward launch per step.
 34. parity_runbook  tools/parity_release_torch.py on the card at the
              published protocol (SCALE 1280, the default pyramid) with the
              reference-layout .pth and the same tree: --tol 100 prints
              "parity_gate": "PASS" and exits 0, --tol 0 "FAIL" and exits 1;
              the row's mAP and the seconds of each run.
Phase 2 also holds the resample's backward (csrc/resample_backward.cu: one
entry point that enqueues a scatter kernel, a dcorr kernel and a transpose
kernel) against its plain version: dpx, dpy and dcorr at rtol 1e-5, atol
1e-6 with channels >= T exactly zero, dpx and dpy equal to the card's plain
version to the bit, dcorr equal to the plain version on the CPU to the bit
(the card's scatter_add_ keeps no order), and two calls equal to the bit
(it fails otherwise; the CPU's at the training shape on identity inputs
only, for time), on the ragged shapes, integer and border
coordinates, collapsed planes (every sample of a plane on one point), the
training shape (B=4, C=16, 38x38, T=121 of 225) on uniform, near-identity,
exact-identity and collapsed inputs, t_full 128 and 121 (= T) and
B*C = 65600.
After phase 11:
     determinism  two backward calls on phase 9's captured inputs, and two
              DETERMINISM_STEPS-step TrainSteps from one seed on the same
              batches (the train recipe of phase 10, margin_pos 1.0), under
              the port's defaults with no flag set and under
              cudnn.deterministic: dcorr, dpx, dpy, every loss and every
              weight compared to the bit; it fails unless all are equal.
              Then the per-layer table (tools/trace_conv_determinism_torch.
              py): every convolution of one step at the default recipe's
              shapes, each distinct one's input and weight gradients twice
              under cuDNN's default algorithms and under the port's rule
              (models/resnet.py: conv2d_backward), whether each repeats to
              the bit (it fails if one does not under the port's rule) and
              its ms; and TrainStep s/step on phase 11's batch under the
              port's defaults, with cudnn.deterministic pinned for the
              whole step, and with F.conv2d's own gradients (cuDNN's
              default algorithms, not repeatable), in turns.
Launch counts are set to 0 just before each of phases 3-7, 9-11 and 13-19
(each dispatch of phase 14) and read just after it, around each step of
phase 17, each call of phase 21, in each rank of phase 22 its steps and
each eval, around each card run and each set of timed turns of phases
23-26, around phase 27's turns, each counted dispatch of phase 28 and phase
29's card runs, around phase 30's turns and its yuv420 train step, and
around each job of phase 33 and each runbook run of phase 34; a phase
whose kernel was not launched fails (phases 27-29: neither the hat nor the
gather kernel). The kernels line counts the launches of the timed
dispatches of phases 6 (hat), 7 (gather) and 23 (int8) and of phase 10's
loop (backward), with those of phases 21 and 27-29 added to the hat and the
gather, those of phase 22's ranks to all three, and those of phases 30 and
33-34 to the hat and the backward; the GroupNorm kernels' those of phase
26's planted run, first step and timed turns, with their times at the scene
stem's slot (GN_SLOTS[0]); the frozen BatchNorm kernel's those of phase 6's
timed dispatches (it fails unless 40 a level: the stem and 3 slots in each
of 13 bottlenecks), with its times at FBN_SLOTS[0].
Then one {"kernels": [...]} line, the whole run's wall time
({"phase": "wall"}), the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Without a CUDA card it prints no result and
exits 1.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import types

# H100 SXM published peaks: HBM bytes/s and fp32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per template-point sample in the gather resample: floor x2,
# fractions x2, complements x2, 8 weight products, 4 corner products summed,
# mask multiply-add
RESAMPLE_FLOPS_PER_SAMPLE = 20
# and in the banded hat form: floor x2, four hat weights (two subtracts and
# a max each), four mask products, four row products and two row sums, two
# column products and their sum, the accumulate
HAT_FLOPS_PER_SAMPLE = 28
RTOL, ATOL = 1e-5, 1e-6
# and in the int8 hat form: floor x2, four hat weights (two subtracts, an
# abs and a max each), two row weights (a multiply and a round each), four
# corner quantizations (a multiply, a round, a min and a max each), four
# integer products and two sums, two conversions and scalings, two column
# products and their sum, the mask product and the accumulate
INT8_OPS_PER_SAMPLE = 49
# and the sample coordinates from theta: the box-local x and y (two
# products and two sums each), then per axis a product and a sum (box),
# two products and a subtract (normalize), a clip (two), a sum and two
# products (to the map)
THETA_OPS_PER_SAMPLE = 28
# the hat kernel rounds at its plain version's points and so agrees with it
# to the bit; this is the gate it has had since it ran on the tensor cores
HAT_RTOL, HAT_ATOL = 1e-5, 1e-5
DEFAULT_TIER_MARGIN = 4e-3  # engine.evaluate.prescreen_margin("default")

IMG_W, IMG_H = 1280, 960
PYRAMID = [0.5, 0.625, 0.8, 1, 1.2, 1.4, 1.6]
NUM_CLASSES = 16
BATCH = 2
TIMED_DISPATCHES = 6
TIER_ROUNDS = 4  # rounds of default, highest, highest, default in phase tiers
PATCH = 240
PLANTED = {0: [(48, 48, 0)], 1: [(336, 176, 1), (48, 112, 0)]}
EVAL_PYRAMID = [0.8, 1.0]
EVAL_TTA = "horflip_rotation90"
EVAL_SCORE_THRESHOLD = 0.5
PRESCREEN_CLASSES = 8
PRESCREEN_W, PRESCREEN_H = 320, 256
# the training phases: a planted dataset of TRAIN_CLASSES 240-px class
# patches in TRAIN_IMAGES scenes of TRAIN_SIZE px, one patch in each cell of
# a 2x2 grid (so the recipe's 600-px crops keep the patches near the 240-px
# anchor size and the remapped targets hold positives); the recipe is
# get_default_cfg()'s
TRAIN_CLASSES, TRAIN_IMAGES, TRAIN_SIZE = 16, 8, 640
TRAIN_STEPS = 4
TRAIN_TIMED_STEPS = 6
TRAIN_EVAL_IMAGES = 2
TRAIN_CPU_RTOL = 2e-3
DETERMINISM_STEPS = 3  # train steps of each of the two runs compared to the bit
# rounds of (port's defaults, global pin, cuDNN's defaults and back) of
# DETERMINISM_TIMED_STEPS timed steps each in phase determinism
DETERMINISM_TIMED_ROUNDS, DETERMINISM_TIMED_STEPS = 3, 3
# random weights score every anchor far above 0.6 against every class,
# positives and negatives alike, whatever is planted; at the recipe's
# margin_pos 0.6 no positive has a loss, and the cls gradient (the backward
# kernel's dpx/dpy, the TransformNet's gradient through them) is zero. The
# first step, which holds the card against the CPU and captures the
# backward kernel's inputs, takes margin_pos 1.0: every positive has a loss
FIRST_STEP_MARGIN_POS = 1.0
# flops per template-point sample in the backward kernel: the hat weights
# and derivatives of 4 rows and 4 columns (4 each: two subtracts, an abs, a
# max), dpx (4 rows of 2 products and a sum, then 2 products and a sum each),
# dpy (2 products, then 4 of 2 products and 2 sums), the 4 dcorr products
# (2 each) and the two cotangent products
BACKWARD_FLOPS_PER_SAMPLE = 90
# phases 16-18: mining card against CPU on this many images (its CPU side
# scores them at two random scales up to 1.6 x 640 px), losses and scores
# within TRAIN_CPU_RTOL and MINING_ATOL (the hinge losses are 0 at many
# anchors); trainval_loop mining every MINE_ITER iterations; the class
# cache held against the host path on up to CACHE_CHECK_BATCHES batches and
# timed in CACHE_TIMING_ROUNDS rounds of host, cache, cache, host
MINING_CPU_IMAGES = 2
MINING_ATOL = 1e-6
MINE_ITER = 2
CACHE_CHECK_BATCHES = 8
CACHE_TIMING_ROUNDS = 4
# the serving phases 20-21: a checkpoint cascade into card models, then
# DetectionService and DynamicBatcher at the shipped 1500-px target
SERVE_CLASSES, SERVE_LARGE_CATALOG = 16, 64
SERVE_REQUEST = (1280, 960)  # detect(): resized to 1500x1125, fm 71x94
SERVE_REQUEST_PATCH = 205  # 240 px once resized by 1500/1280
# detect_batch: mixed sizes whose longer side is the canvas's, so each
# planted 240-px patch keeps its size on the 1500x1500 canvas (fm 94x94)
SERVE_BATCH_SIZES = [(1500, 1125), (1125, 1500), (1500, 1000), (1500, 1500),
                     (1500, 844), (1000, 1500), (1500, 1200), (1200, 1500)]
SERVE_BATCHER_CLIENTS, SERVE_CLIENT_REQUESTS = 8, 8
SERVE_TIMED_REQUESTS = 30
SERVE_BATCHER_ATOL = 1e-5
# the reference TransformationNet's modules for the port's (models/checkpoint.py)
REFERENCE_TRANSFORM_NET = {"conv0": "conv.0", "bn0": "conv.1", "conv1": "conv.3",
                           "bn1": "conv.4", "linear": "linear"}
# the numeric modes of phases 13-14: (name, compute_dtype, BN folded)
NUMERIC_MODES = (("fp32", "float32", False), ("fp32_fold", "float32", True),
                 ("bf16", "bfloat16", False), ("bf16_fold", "bfloat16", True))
NUMERIC_ROUNDS = 2  # rounds of the four modes there and back in phase numeric_timing
# the bf16 rule: RMS(card_bf16 - cpu_bf16) <= BF16_RULE * RMS(cpu_bf16 -
# cpu_fp32) on the same inputs (tests/test_torch_numeric_modes.py), held
# here for every backbone convolution on the CPU's own input
BF16_RULE = 0.25
# and for the stages made of several bf16 convolutions (the stem, each
# bottleneck, the head through its TransformNet's three convolutions):
# cuDNN sums each convolution's fp32 products in another order than the
# CPU, a few roundings flip, and the flips spread through the convolutions
# that follow. Measured on the card against the CPU on the CPU's inputs:
# up to 0.28 for a bottleneck and 0.38 for the head here, 0.36 and 0.47 in
# tests/test_torch_kernels_card.py; the port's CPU stages sit within 0.25
# of JAX's (tests/test_torch_numeric_modes.py)
BF16_STAGE_RULE = 0.6
# a whole train step's scalars carry decorrelated bf16 rounding noise (the
# same test module measured 0.38-1.97 of |bf16 - fp32| between the packages)
BF16_STEP_RULE = 3.0
# phase nms_blocked: the cross-class decode of ROADMAP's fault (one 320x320
# level, 33 class rows, pre_top_k 1024, top_k 256) and a per-row NMS over
# every anchor of a bench image (B=1, G=2, K=39,580)
NMS_G, NMS_ROW_G = 33, 2
# phase distributed: DIST_STEPS data-parallel steps from seed DIST_SEED on
# global batches of the train recipe, held to the plain step (losses within
# DIST_LOSS_RTOL, weights within DIST_PARAM_RTOL/ATOL); the planted eval's
# packed detections within DIST_SCORE_ATOL and DIST_BOX_ATOL px of the
# unsharded run's; s/step over DIST_TIMED_ROUNDS rounds; each group of
# ranks has DIST_TIMEOUT_S to finish
DIST_STEPS, DIST_SEED, DIST_EVAL_BATCH, DIST_TIMED_ROUNDS = 3, 2, 2, 2
DIST_LOSS_RTOL, DIST_PARAM_RTOL, DIST_PARAM_ATOL = 2e-5, 1e-4, 1e-6
DIST_SCORE_ATOL, DIST_BOX_ATOL = 1e-5, 1e-2
DIST_TIMEOUT_S = 300
# phases 23-26, the model options: OPTION_ROUNDS rounds of (a, b, b, a) at
# the bench protocol for each comparison; the int8 tier's planted scores
# card against CPU within INT8_SCORE_ATOL (corr on the two devices differs in
# its last bits, which moves a value across a 1/127 rounding point now and
# then: one corner's step moves a score by at most 1/127 * 1/121 ~ 6.5e-5);
# the grid path's head outputs card against CPU and against the
# interior-first head within GRID_HEAD_ATOL; ResNet101-C4 card against CPU
# on a GN_CROP crop within R101_RTOL_TO_MAX of the features' largest
# magnitude (random He weights under identity normalizations grow the
# residual stream of 23 blocks to ~1e4)
OPTION_ROUNDS = 2
INT8_SCORE_ATOL = 4e-4
GRID_HEAD_ATOL = 1e-4
GN_CROP = (320, 240)
R101_RTOL_TO_MAX = 1e-4
# phase group_norm_kernel: (name, N, C, H, W) of GroupNorm slots at exp2's V2
# training recipe, and the fp64 truth's margin: each output's error within
# GN_ATEN_FACTOR x F.group_norm's fp32 error plus GN_ATOL_TO_MAX of the
# output's largest magnitude (tests/test_torch_group_norm_card.py's rule)
GN_SLOTS = [("scene_stem", 4, 64, 300, 300), ("scene_layer1_bn3", 4, 256, 150, 150),
            ("scene_layer3_bn3", 4, 1024, 38, 38), ("class_stem", 16, 64, 120, 120),
            ("class_layer3_bn3", 16, 1024, 15, 15)]
GN_GROUPS, GN_EPS = 32, 1e-5
GN_ATEN_FACTOR, GN_ATOL_TO_MAX = 2.0, 1e-6
# phase frozen_bn_kernel: (name, form, (N, C, H, W)) of frozen BatchNorm
# slots at the main path's 1.6 level (B=2, 2048x1536 scenes); form 0 is
# relu(bn(x)), 1 adds the block's input, 2 the downsample's BatchNorm
FBN_SLOTS = [("stem", 0, (2, 64, 1024, 768)), ("layer3_tail", 1, (2, 1024, 96, 128)),
             ("layer3_tail_downsample", 2, (2, 1024, 96, 128))]
FBN_SLOTS_PER_PASS = 40  # ResNet50-C4: the stem and 3 slots in each of 13 bottlenecks
# what prepare_batch_arrays reads of a train batch, sent to the ranks
DIST_BATCH_KEYS = ("images", "class_images", "class_ids", "gt_boxes", "gt_labels",
                   "gt_difficult", "gt_valid", "img_size")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean CUDA-event time of fn() over iters launches, after 2 warmups."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the byte and the operation time."""
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def resample_bytes(b, c, a, t):
    """Each input read once (corr prefix, px, py, mask), the output written
    once; fp32 throughout."""
    return 4 * (3 * b * c * t * a + c * t + b * c * a)


def resample_bound(b, c, a, t):
    """The gather kernel: its fp32 operations against the fp32 rate."""
    return bound(resample_bytes(b, c, a, t), RESAMPLE_FLOPS_PER_SAMPLE * b * c * t * a,
                 FP32_FLOPS)


def hat_bound(b, c, a, t):
    """The hat kernel: the gather's bytes, its banded fp32 operations
    against the fp32 rate."""
    return bound(resample_bytes(b, c, a, t), HAT_FLOPS_PER_SAMPLE * b * c * t * a, FP32_FLOPS)


def int8_bytes(b, c, a, t, side):
    """The int8 kernel from theta: the fp32 corr prefix, theta (6 floats an
    anchor of each (b, c)), the boxes, the lattice and the mask read once,
    the output written once."""
    return 4 * (b * c * t * a + 6 * b * c * a + 4 * a + 2 * side + c * t + b * c * a)


def int8_bound(b, c, a, t, side):
    """The int8 kernel from theta: its bytes, its operations (the int8 hat
    form and the coordinates) against the fp32 rate of the CUDA cores."""
    return bound(int8_bytes(b, c, a, t, side),
                 (INT8_OPS_PER_SAMPLE + THETA_OPS_PER_SAMPLE) * b * c * t * a, FP32_FLOPS)


def backward_bytes(b, c, a, t, t_full):
    """dcorr (all t_full channels) written once, the corr prefix, px and py
    read once, dpx and dpy written once, the two cotangents and the mask
    read once; fp32 throughout."""
    return 4 * (b * c * a * t_full + b * c * a * t + 4 * b * c * t * a + 2 * b * c * a + c * t)


def backward_bound(b, c, a, t, t_full):
    return bound(backward_bytes(b, c, a, t, t_full), BACKWARD_FLOPS_PER_SAMPLE * b * c * t * a,
                 FP32_FLOPS)


def bf16_ratio(got, want16, want32):
    """RMS(got - want16) / RMS(want16 - want32), the bf16 rule's ratio; where
    bf16 and fp32 agree exactly (an output that no bf16 rounding reaches,
    such as random weights' identity transform), 0 if got agrees too."""
    diff, scale = (float((x - y).double().pow(2).mean().sqrt())
                   for x, y in ((got, want16), (want16, want32)))
    if scale == 0:
        return 0.0 if diff == 0 else float("inf")
    return diff / scale


def max_err_checked(got, want, what, rtol=RTOL, atol=ATOL):
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def random_resample_inputs(b, c, h, w, gen, kind, t_side=11):
    """corr [B, C, H, W, 225] in tanh range, px/py [B, C, T, H*W], mask_t
    [C, T]. kind "uniform": px/py spread over the map, some exactly on the
    borders; "outside": the same reaching 0.5 past each border;
    "near_identity": the anchor plus the template offset of the head's
    identity transform (15-px anchor boxes, t = tx*11 + ty), jittered by up
    to 0.25 px; "identity": the same without jitter, as the main path with
    random weights gives them; "collapsed": every sample of a (b, c) plane
    on one point; "half": "uniform" moved to half-way points (hat weights
    of 0.5, which the int8 tier's x127 rounds half to even)."""
    import torch

    dev = "cuda"
    corr = torch.tanh(torch.randn(b, c, h, w, 225, generator=gen, device=dev))
    t = t_side * t_side
    shape = (b, c, t, h * w)
    if kind in ("uniform", "outside", "half"):
        pad = 0.5 if kind == "outside" else 0.0
        px = torch.rand(shape, generator=gen, device=dev) * (w - 1 + 2 * pad) - pad
        py = torch.rand(shape, generator=gen, device=dev) * (h - 1 + 2 * pad) - pad
        px[:, :, :7] = 0.0
        px[:, :, 7:14] = w - 1
        py[:, :, 3:10] = 0.0
        py[:, :, 10:17] = h - 1
        if kind == "half":
            px = (px.floor() + 0.5).clamp(max=w - 1)
            py = (py.floor() + 0.5).clamp(max=h - 1)
    elif kind == "collapsed":
        px = (torch.rand(b, c, 1, 1, generator=gen, device=dev) * (w - 1)).expand(shape)
        py = (torch.rand(b, c, 1, 1, generator=gen, device=dev) * (h - 1)).expand(shape)
    else:
        ti = torch.arange(t, device=dev)
        off_x = ((ti // t_side) - t_side // 2).float() * (15 / 14) + 0.5
        off_y = ((ti % t_side) - t_side // 2).float() * (15 / 14) + 0.5
        ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")

        def jitter():
            if kind == "identity":
                return torch.zeros(shape, device=dev)
            return (torch.rand(shape, generator=gen, device=dev) - 0.5) * 0.5

        px = (xs.reshape(-1).float() + off_x[:, None] + jitter()).clamp(0, w - 1)
        py = (ys.reshape(-1).float() + off_y[:, None] + jitter()).clamp(0, h - 1)
    mask_t = torch.full((c, t), 1.0 / t, device=dev)
    return corr, px.contiguous(), py.contiguous(), mask_t


def random_theta_inputs(b, c, h, w, gen, kind):
    """The int8 kernel's theta source as the interior-first head builds it:
    theta [B, C, H*W, 6], the anchors' feature-map boxes [H*W, 4] and the
    template lattice [2, 11]. kind "identity" (the main path with random
    weights), "near_identity" (each entry moved by up to 0.05), "random"
    (entries in [-1, 1]) or "outside" (identity moved by up to 3 box
    half-widths, so that many samples are clipped to the map's border)."""
    import torch

    from os2d_torch.ops.sampling import linspace
    from os2d_torch.structures.boxes import strided_anchor_grid
    from os2d_torch.structures.feature_map import ALIGNER_RECEPTIVE_FIELD, ALIGNER_STRIDE

    dev = "cuda"
    a = h * w
    theta = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=dev).repeat(b, c, a, 1)
    if kind == "near_identity":
        theta += (torch.rand(b, c, a, 6, generator=gen, device=dev) - 0.5) * 0.1
    elif kind == "random":
        theta = torch.rand(b, c, a, 6, generator=gen, device=dev) * 2.0 - 1.0
    elif kind == "outside":
        theta[..., 2] += (torch.rand(b, c, a, generator=gen, device=dev) - 0.5) * 6.0
        theta[..., 5] += (torch.rand(b, c, a, generator=gen, device=dev) - 0.5) * 6.0
    boxes = strided_anchor_grid(w, h, float(ALIGNER_RECEPTIVE_FIELD.w),
                                float(ALIGNER_RECEPTIVE_FIELD.h), float(ALIGNER_STRIDE.w),
                                float(ALIGNER_STRIDE.h), device=dev)
    lattice = torch.stack([linspace(-1.0, 1.0, 15, device=dev)[2:13]] * 2)
    return theta.contiguous(), boxes, lattice


def planted_scenes():
    """The two 640x480 scenes and two class patches of
    tests/test_end_to_end_eval.py (same seed, same draws)."""
    import numpy as np

    rng = np.random.RandomState(0)
    patches = []
    for _ in range(2):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches.append(np.kron(p, np.ones((8, 8, 1), np.uint8)))
    scenes = []
    for image_id in sorted(PLANTED):
        scene = rng.randint(0, 60, (480, 640, 3), np.uint8)
        for x0, y0, cid in PLANTED[image_id]:
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
        scenes.append(scene)
    return np.stack(scenes), patches


def write_planted_dataset(root, scale=1):
    """The planted scenes as the files and CSV-schema dataframe of
    tests/test_end_to_end_eval.py:30-69 (JPEG, quality 95); with an integer
    `scale` the scenes are written `scale` times larger (pixel replication),
    the class patches as they are."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    scenes, patches = planted_scenes()
    scenes = np.kron(scenes, np.ones((1, scale, scale, 1), np.uint8))
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    for cid, patch in enumerate(patches):
        Image.fromarray(patch).save(os.path.join(root, "classes", "images", f"class{cid}.jpg"),
                                    quality=95)
    rows = []
    for image_id, plants in sorted(PLANTED.items()):
        for x0, y0, cid in plants:
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg", classid=cid,
                             classfilename=f"class{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=x0 / 640, ty=y0 / 480, rx=(x0 + PATCH) / 640,
                             by=(y0 + PATCH) / 480))
        Image.fromarray(scenes[image_id]).save(os.path.join(root, "src", f"img{image_id}.jpg"),
                                               quality=95)
    return pd.DataFrame(rows)


def write_train_dataset(root):
    """A planted training set: TRAIN_CLASSES class patches of 240 px (8-px
    blocks of seeded random colors) and TRAIN_IMAGES noise scenes of
    TRAIN_SIZE px, each holding four patches, one in each cell of a 2x2 grid,
    every class in TRAIN_IMAGES * 4 / TRAIN_CLASSES scenes. Written as JPEG
    files and a CSV-schema dataframe."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    patches = []
    for cid in range(TRAIN_CLASSES):
        p = rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8)
        patches.append(np.kron(p, np.ones((8, 8, 1), np.uint8)))
        Image.fromarray(patches[-1]).save(
            os.path.join(root, "classes", "images", f"class{cid}.jpg"), quality=95)
    cell = TRAIN_SIZE // 2
    rows = []
    for image_id in range(TRAIN_IMAGES):
        scene = rng.randint(0, 60, (TRAIN_SIZE, TRAIN_SIZE, 3), np.uint8)
        for k in range(4):
            cid = (image_id * 4 + k) % TRAIN_CLASSES
            x0 = (k % 2) * cell + rng.randint(0, cell - PATCH + 1)
            y0 = (k // 2) * cell + rng.randint(0, cell - PATCH + 1)
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg", classid=cid,
                             classfilename=f"class{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=x0 / TRAIN_SIZE, ty=y0 / TRAIN_SIZE,
                             rx=(x0 + PATCH) / TRAIN_SIZE, by=(y0 + PATCH) / TRAIN_SIZE))
        Image.fromarray(scene).save(os.path.join(root, "src", f"img{image_id}.jpg"), quality=95)
    return pd.DataFrame(rows)


def detections_agree(got, want, box_atol=1e-2, score_atol=1e-4):
    """Every valid detection of `got` has one in `want` of the same image and
    class with score within score_atol and box within box_atol px, and the
    counts match (robust to the order of near-tied scores)."""
    import numpy as np

    for b in range(got["valid"].shape[0]):
        for g in range(got["valid"].shape[1]):
            gv, wv = got["valid"][b, g], want["valid"][b, g]
            if gv.sum() != wv.sum():
                return False
            ws, wb = want["scores"][b, g][wv], want["boxes"][b, g][wv]
            for s, box in zip(got["scores"][b, g][gv], got["boxes"][b, g][gv]):
                hit = (np.abs(ws - s) <= score_atol) & (np.abs(wb - box).max(-1) <= box_atol)
                if not hit.any():
                    return False
    return True


def mined_records_disagree(got, want, rtol, atol):
    """(the first disagreement between two mining results or None, the
    largest |difference| of loss, loss_loc and score): image ids, the order
    of the records, roles, levels, labels, anchor indices and crop and
    anchor boxes exactly; loss, loss_loc and score within rtol and atol."""
    import numpy as np

    errs = {"loss": 0.0, "loss_loc": 0.0, "score": 0.0}
    if list(got) != list(want):
        return f"image ids {list(got)} against {list(want)}", errs
    for image_id, w_recs in want.items():
        g_recs = got[image_id]
        if len(g_recs) != len(w_recs):
            return f"image {image_id}: {len(g_recs)} records against {len(w_recs)}", errs
        for i, (g, w) in enumerate(zip(g_recs, w_recs)):
            where = f"image {image_id} record {i}"
            for key in ("role", "pyramid_level", "label_local", "label_global", "anchor_index"):
                if g[key] != w[key]:
                    return f"{where}: {key} {g[key]} against {w[key]}", errs
            for key in ("crop_position_xyxy", "anchor_position_xyxy"):
                if not np.array_equal(g[key], w[key]):
                    return f"{where}: {key} {g[key]} against {w[key]}", errs
            for key in errs:
                errs[key] = max(errs[key], abs(g[key] - w[key]))
                if not abs(g[key] - w[key]) <= atol + rtol * abs(w[key]):
                    return f"{where}: {key} {g[key]} against {w[key]}", errs
    return None, errs


def reference_layout(state_dict):
    """A port state_dict renamed to the reference's Os2dModel layout (the
    "net" of its checkpoints), with a num_batches_tracked beside every
    BatchNorm, on the CPU."""
    import torch

    out = {}
    for k, v in state_dict.items():
        head, rest = k.split(".", 1)
        if head == "backbone":
            name = "net_feature_maps." + rest
        elif head == "label_backbone":
            name = "net_label_features.net_class_features." + rest
        else:
            module, field = rest.split(".", 1)
            name = (f"os2d_head_creator.aligner.parameter_regressor."
                    f"{REFERENCE_TRANSFORM_NET[module]}.{field}")
        out[name] = v.detach().to("cpu", copy=True)
        if name.endswith(".running_var"):
            out[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def serve_patches(n, seed):
    """n class patches of PATCH px, 8-px blocks of seeded random colors."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [np.kron(rng.randint(0, 255, (PATCH // 8, PATCH // 8, 3), np.uint8),
                    np.ones((8, 8, 1), np.uint8)) for _ in range(n)]


def planted_scene(w, h, patch, rng, scale=1.0):
    """A dark noise scene of w x h with `patch` at a random position that
    the service's resize by `scale` puts on the 16-px anchor grid (random
    weights score every anchor within ~2e-3 of each other; the planted patch
    wins where it fills an anchor); returns (PIL image, planted box
    [x0, y0, x1, y1])."""
    import numpy as np
    from PIL import Image

    scene = rng.randint(0, 60, (h, w, 3), np.uint8)
    side = patch.shape[0]

    def position(n):
        k = rng.randint(0, int((n - side) * scale) // 16 + 1)
        return min(int(round(16 * k / scale)), n - side)

    x0, y0 = position(w), position(h)
    scene[y0:y0 + side, x0:x0 + side] = patch
    return Image.fromarray(scene), [x0, y0, x0 + side, y0 + side]


def png_b64(img):
    import base64
    from io import BytesIO

    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def top_iou(response, w, h, box):
    """IoU of a response's top box (relative coordinates) with `box` (px)."""
    import torch

    from os2d_torch.structures.boxes import box_iou

    if not response["scores"]:
        return 0.0
    top = torch.tensor([response["bboxes"][0]]) * torch.tensor([w, h, w, h])
    return float(box_iou(top, torch.tensor([box], dtype=torch.float32)))


def responses_agree(got, want, w, h, score_atol=1e-4, box_px=1e-2):
    """Equal detection counts, and each detection of `got` has one in `want`
    with its score within score_atol and its box within box_px pixels
    (robust to the order of near-tied scores)."""
    import numpy as np

    if len(got["scores"]) != len(want["scores"]):
        return False
    scale = np.array([w, h, w, h])
    ws, wb = np.array(want["scores"]), np.array(want["bboxes"]).reshape(-1, 4) * scale
    for s, b in zip(got["scores"], np.array(got["bboxes"]).reshape(-1, 4) * scale):
        if not ((np.abs(ws - s) <= score_atol) & (np.abs(wb - b).max(-1) <= box_px)).any():
            return False
    return True


def percentile_ms(times, q):
    import numpy as np

    return float(np.percentile(np.asarray(times) * 1e3, q))


def serve_request_breakdown(service, payload, rounds=10):
    """Host-clock ms of the stages of DetectionService.detect on one request,
    median over `rounds`, each stage synchronized: the decode (base64 and
    the PNGs' pixels, which PIL otherwise decodes lazily at their first
    use), the class head (query prep and the label branch), the resize to
    the base canvas, the dispatch (device work, host waits, the copy to the
    host), the response. Mirrors detect()'s steps through its helpers."""
    import numpy as np
    import torch
    from PIL import Image

    from os2d_torch.api import service as service_mod

    from os2d_torch.ops import nms

    stages = {k: [] for k in ("decode", "class_head", "resize", "dispatch", "response")}
    sweeps_before = nms.fixpoint_sweeps
    for _ in range(rounds):
        t0 = time.perf_counter()
        images, queries = service_mod.parse_request_payload(payload, "image")
        for img in images + queries:
            img.load()
        t1 = time.perf_counter()
        head, num_views = service._build_class_head(queries)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        image = images[0]
        ratio = service_mod.TARGET_IMAGE_SIZE * max(service.pyramid_scales) / max(image.size)
        base_w, base_h = (max(1, int(s * ratio)) for s in image.size)
        arr = np.array(image.resize((base_w, base_h), Image.BILINEAR), np.uint8)[None]
        t3 = time.perf_counter()
        with torch.no_grad():
            det = service._detect_packed(arr, head, *service._level_plan(base_w, base_h),
                                         num_views)
        t4 = time.perf_counter()
        service._packed_to_response(det, 0, image.size[0] / base_w, image.size[1] / base_h,
                                    *image.size)
        t5 = time.perf_counter()
        for k, (a, b) in zip(stages, ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t4, t5))):
            stages[k].append((b - a) * 1e3)
    emit({"phase": "serve_request_breakdown", "rounds": rounds,
          "median_ms": {k: float(np.median(v)) for k, v in stages.items()},
          "nms_fixpoint_sweeps_per_request": (nms.fixpoint_sweeps - sweeps_before) / rounds})


def checkpoint_and_serve(counts, device="cuda", profile=False):
    """Phases 20 (checkpoint) and 21 (serve); returns the kernels' launches
    in phase serve. `counts` holds reset(), read() and require(phase,
    counts, kernel, expected). With `profile`, adds a torch.profiler
    breakdown of one request and one batch of 8."""
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from os2d_torch.api import service as service_mod
    from os2d_torch.api.service import DetectionService, DynamicBatcher, parse_request_payload
    from os2d_torch.engine.evaluate import prescreen_margin
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.checkpoint import load_checkpoint_file
    from os2d_torch.ops import hat_resample, resample_grad
    from os2d_torch.ops.cuda import BUILD_DIR
    from os2d_torch.ops.sampling import hat_resample_reference
    from os2d_torch.utils.logger import checkpoint_model

    # ---- 20. checkpoint: the cascade into card models ----
    rng = np.random.RandomState(20)
    patches = serve_patches(SERVE_LARGE_CATALOG, seed=20)
    catalog = [Image.fromarray(p) for p in patches[:SERVE_CLASSES]]
    req_w, req_h = SERVE_REQUEST
    small = np.asarray(Image.fromarray(patches[0]).resize(
        (SERVE_REQUEST_PATCH, SERVE_REQUEST_PATCH), Image.NEAREST))
    req_scene, req_box = planted_scene(req_w, req_h, small, rng,
                                       service_mod.TARGET_IMAGE_SIZE / max(req_w, req_h))
    payload = {"image": {"content": png_b64(req_scene)},
               "query": [{"content": png_b64(q)} for q in catalog]}

    source = Os2dModel(Os2dConfig(), device=device, seed=1)
    source_state = source.state_dict()
    source_resp = DetectionService(source).detect_from_request(payload)
    loaded, ckpt = {}, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        paths = {"reference": os.path.join(root, "reference_layout.pth"),
                 "port": checkpoint_model(source, None, root, model_name="port")}
        torch.save({"net": reference_layout(source_state)}, paths["reference"])
        for name, path in paths.items():
            m = Os2dModel(Os2dConfig(), device=device, seed=0)
            t0 = time.perf_counter()
            sd, _ = load_checkpoint_file(path, m.config, m)
            m.load_state_dict(sd)
            load_s = time.perf_counter() - t0
            state = m.state_dict()
            bit_equal = (set(state) == set(source_state)
                         and all(torch.equal(state[k], source_state[k]) for k in state))
            resp = DetectionService(m).detect_from_request(payload)
            loaded[name] = m
            ckpt[name] = {"file_mb": os.path.getsize(path) / 2**20, "load_s": load_s,
                          "state_bit_equal": bit_equal,
                          "first_detect_equal": resp == source_resp,
                          "first_detect_agrees": responses_agree(resp, source_resp,
                                                                 req_w, req_h)}
    emit({"phase": "checkpoint", "source": "Os2dModel(Os2dConfig(), seed=1) on the card",
          "files": ckpt, "detections": len(source_resp["scores"])})
    for name, c in ckpt.items():
        if not (c["state_bit_equal"] and c["first_detect_agrees"]):
            raise SystemExit(f"checkpoint: the {name} file did not load as its source: {c}")
    del source

    # ---- 21. serve: DetectionService and DynamicBatcher at the 1500-px target ----
    model = loaded["reference"]
    service = DetectionService(model)
    captured = []
    original = resample_grad.FORWARD["default"]

    def capture(corr, px, py, mask_t):
        out = original(corr, px, py, mask_t)
        captured.append((corr, px, py, mask_t, out))
        return out

    # 1. one request, the card against the CPU
    resample_grad.FORWARD["default"] = capture
    try:
        counts.reset()
        resp = service.detect_from_request(payload)
        torch.cuda.synchronize()
        request_counts = counts.read()
    finally:
        resample_grad.FORWARD["default"] = original
    counts.require("serve", request_counts, "hat_resample_correlation", 1)
    cpu_model = Os2dModel(Os2dConfig(), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_resp = DetectionService(cpu_model).detect_from_request(payload)
    cpu_request_s = time.perf_counter() - t0
    del cpu_model
    request_iou = top_iou(resp, req_w, req_h, req_box)
    request_cpu_agree = responses_agree(resp, cpu_resp, req_w, req_h)

    # 2. detect_batch of 8 scenes of mixed sizes
    batch = [planted_scene(w, h, patches[0], rng) for w, h in SERVE_BATCH_SIZES]
    batch_images = [img for img, _ in batch]
    resample_grad.FORWARD["default"] = capture
    try:
        counts.reset()
        batch_resp = service.detect_batch(batch_images, catalog)
        torch.cuda.synchronize()
        batch_counts = counts.read()
    finally:
        resample_grad.FORWARD["default"] = original
    counts.require("serve", batch_counts, "hat_resample_correlation", 1)
    batch_ious = [top_iou(r, img.size[0], img.size[1], box)
                  for r, (img, box) in zip(batch_resp, batch)]

    # 3. the batcher, 8 client threads at once, against detect_batch
    sizes_formed = []
    detect_batch = service.detect_batch

    def recorded(images, queries):
        sizes_formed.append(len(images))
        return detect_batch(images, queries)

    service.detect_batch = recorded
    batcher = DynamicBatcher(service, max_batch=SERVE_BATCHER_CLIENTS, max_wait_ms=50)
    try:
        results = [None] * len(batch_images)

        def client(i):
            results[i] = batcher.detect(batch_images[i], catalog)

        counts.reset()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(batch_images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        torch.cuda.synchronize()
        batcher_counts = counts.read()
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise SystemExit("serve: a batcher client did not finish")
        counts.require("serve", batcher_counts, "hat_resample_correlation", len(sizes_formed))
        batcher_agree = all(
            responses_agree(r, w, img.size[0], img.size[1], SERVE_BATCHER_ATOL)
            for r, w, img in zip(results, batch_resp, batch_images))
        batcher_sizes = list(sizes_formed)
    finally:
        batcher.close()
        service.detect_batch = detect_batch

    # 4. a 64-class catalog: the prescreen, against the full path
    large = [Image.fromarray(p) for p in patches]
    counts.reset()
    pre_resp = service.detect(req_scene, large)
    torch.cuda.synchronize()
    pre_counts = counts.read()
    pruned = service.evaluator.prescreen_pruned
    chunk = int(service.eval_cfg.tpu.eval_class_chunk)
    kept = SERVE_LARGE_CATALOG - pruned
    n_chunks = min(1 << (max(1, -(-kept // chunk)) - 1).bit_length(),
                   -(-SERVE_LARGE_CATALOG // chunk)) if kept else 0
    counts.require("serve", pre_counts, "hat_resample_correlation", n_chunks)
    full_service = DetectionService(model, prescreen_min_classes=10**9)
    full_resp = full_service.detect(req_scene, large)
    prescreen_agree = responses_agree(pre_resp, full_resp, req_w, req_h)

    # 5. one request at the "highest" tier launches the gather
    model_highest = Os2dModel(Os2dConfig(resample_precision="highest"), device=device)
    model_highest.load_state_dict(model.state_dict())
    counts.reset()
    highest_resp = DetectionService(model_highest).detect(req_scene, catalog)
    torch.cuda.synchronize()
    highest_counts = counts.read()
    counts.require("serve", highest_counts, "resample_correlation", 1)
    del model_highest

    # 6. the hat kernel on the tensors the service passed it
    if len(captured) != 2:
        raise SystemExit(f"serve: captured {len(captured)} resample calls, expected 2")
    hat = {}
    for corr, px, py, mask_t, out in captured:
        b, c, h, w, _ = corr.shape
        name = f"B{b}_C{c}_{h}x{w}"
        want = hat_resample_reference(corr, px, py, mask_t)
        err = max_err_checked(out, want, f"hat kernel on the service's inputs at {name}",
                              HAT_RTOL, HAT_ATOL)
        ms = cuda_ms(lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t), 20)
        bound_ms, bound_by = hat_bound(b, c, h * w, px.shape[2])
        hat[name] = {"max_abs_err": err, "bit_equal": err == 0.0, "ms": ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    del captured

    # 8. timing, after the warm-up of the calls above: the host's decode of
    # a request alone, requests in sequence, batches of 8, the batcher
    decode = []
    for _ in range(SERVE_TIMED_REQUESTS):
        t0 = time.perf_counter()
        parse_request_payload(payload, "image")
        decode.append(time.perf_counter() - t0)
    counts.reset()
    seq = []
    t_all = time.perf_counter()
    for _ in range(SERVE_TIMED_REQUESTS):
        t0 = time.perf_counter()
        service.detect_from_request(payload)
        torch.cuda.synchronize()
        seq.append(time.perf_counter() - t0)
    seq_wall = time.perf_counter() - t_all
    seq_counts = counts.read()
    counts.require("serve", seq_counts, "hat_resample_correlation", SERVE_TIMED_REQUESTS)
    counts.reset()
    batch_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        service.detect_batch(batch_images, catalog)
        torch.cuda.synchronize()
        batch_times.append(time.perf_counter() - t0)
    counts.require("serve", counts.read(), "hat_resample_correlation", 3)

    sizes_formed.clear()
    service.detect_batch = recorded
    batcher = DynamicBatcher(service, max_batch=SERVE_BATCHER_CLIENTS)
    latencies = []
    lat_lock = threading.Lock()
    try:
        def stream(i):
            for j in range(SERVE_CLIENT_REQUESTS):
                img = batch_images[(i + j) % len(batch_images)]
                t0 = time.perf_counter()
                batcher.detect(img, catalog)
                with lat_lock:
                    latencies.append(time.perf_counter() - t0)

        counts.reset()
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(SERVE_BATCHER_CLIENTS)]
        t_all = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        stream_wall = time.perf_counter() - t_all
        stream_counts = counts.read()
        n_stream = SERVE_BATCHER_CLIENTS * SERVE_CLIENT_REQUESTS
        if any(t.is_alive() for t in threads) or len(latencies) != n_stream:
            raise SystemExit("serve: the batcher's timed clients did not finish")
        counts.require("serve", stream_counts, "hat_resample_correlation", len(sizes_formed))
        stream_sizes = list(sizes_formed)
    finally:
        batcher.close()
        service.detect_batch = detect_batch

    serve_launches = {k: sum(c[k] for c in (request_counts, batch_counts, batcher_counts,
                                            pre_counts, highest_counts, seq_counts,
                                            stream_counts))
                      for k in request_counts}
    serve_launches["hat_resample_correlation"] += len(batch_times)
    emit({"phase": "serve", "target_image_size": service_mod.TARGET_IMAGE_SIZE,
          "resample_precision": model.config.resample_precision, "catalog": SERVE_CLASSES,
          "request": {"image": f"{req_w}x{req_h} PNG/base64", "top_iou": request_iou,
                      "detections": len(resp["scores"]), "cuda_matches_cpu": request_cpu_agree,
                      "cpu_s": cpu_request_s, "launches": request_counts},
          "detect_batch": {"images": [f"{w}x{h}" for w, h in SERVE_BATCH_SIZES],
                           "top_ious": batch_ious, "launches": batch_counts},
          "batcher": {"clients": SERVE_BATCHER_CLIENTS, "batch_sizes": batcher_sizes,
                      "matches_detect_batch": batcher_agree, "atol": SERVE_BATCHER_ATOL,
                      "launches": batcher_counts},
          "prescreen": {"catalog": SERVE_LARGE_CATALOG, "stats": dict(service.stats),
                        "pruned": pruned, "margin": prescreen_margin("default"),
                        "matches_full_path": prescreen_agree, "hat_launches_expected": n_chunks,
                        "launches": pre_counts},
          "highest": {"detections": len(highest_resp["scores"]), "launches": highest_counts},
          "hat_at_serving_shapes": hat,
          "sequential": {"requests": SERVE_TIMED_REQUESTS,
                         "median_ms": percentile_ms(seq, 50), "p99_ms": percentile_ms(seq, 99),
                         "requests_per_s": SERVE_TIMED_REQUESTS / seq_wall,
                         "decode_median_ms": percentile_ms(decode, 50)},
          "detect_batch_ms": [t * 1e3 for t in batch_times],
          "batcher_stream": {"clients": SERVE_BATCHER_CLIENTS,
                             "requests_per_client": SERVE_CLIENT_REQUESTS,
                             "batch_sizes": stream_sizes, "img_per_s": n_stream / stream_wall,
                             "median_ms": percentile_ms(latencies, 50),
                             "p99_ms": percentile_ms(latencies, 99)},
          "launches": serve_launches})
    if not request_iou > 0.5:
        raise SystemExit(f"serve: the request's top box is not on the patch (IoU {request_iou})")
    if not request_cpu_agree:
        raise SystemExit("serve: the request's response on the card differs from the CPU's")
    if not all(iou > 0.5 for iou in batch_ious):
        raise SystemExit(f"serve: detect_batch top boxes off their patches: {batch_ious}")
    if not batcher_agree:
        raise SystemExit("serve: the batcher's results differ from detect_batch's")
    if service.stats["prescreen_dispatches"] != 1:
        raise SystemExit(f"serve: the 64-class catalog did not engage the prescreen: "
                         f"{service.stats}")
    if not prescreen_agree:
        raise SystemExit("serve: the prescreened response differs from the full path's")
    if profile:
        serve_request_breakdown(service, payload)
        profile_run("profile_serve_request", lambda: service.detect_from_request(payload),
                    float(np.median(seq)))
        profile_run("profile_serve_batch", lambda: service.detect_batch(batch_images, catalog),
                    float(np.median(batch_times)))
    return serve_launches


def _state_digest(model):
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _eval_setup(device, root, df):
    """Phase distributed's eval: phase 4's planted set and recipe at the
    "highest" tier (the gather kernel), as a loader with both scenes in one
    batch, a model of seed 0 on `device`, and the batch's detect inputs."""
    import numpy as np

    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.models import Os2dConfig, Os2dModel

    dataset = DatasetOneShotDetection(
        df, gt_path=os.path.join(root, "classes", "images"), image_path=os.path.join(root, "src"),
        name="planted", image_size=640, eval_scale=640, cache_images=True)
    loader = DataloaderOneShotDetection(dataset, batch_size=DIST_EVAL_BATCH,
                                        pyramid_scales_eval=EVAL_PYRAMID)
    _, images, sizes, inv, _ = next(iter(loader.make_raw_iterator_for_all_images(
        DIST_EVAL_BATCH)))
    model = Os2dModel(Os2dConfig(resample_precision="highest"), device=device, seed=0)
    return loader, model, (np.stack(images), sizes, inv[0])


def _dist_eval_cfg(axis):
    from os2d_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.eval.mAP_iou_thresholds = [0.5]
    cfg.eval.class_image_augmentation = EVAL_TTA
    cfg.eval.nms_score_threshold = EVAL_SCORE_THRESHOLD
    cfg.eval.batch_size = DIST_EVAL_BATCH
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 32
    cfg.tpu.eval_shard_axis = axis
    return cfg


def _detect_and_evaluate(model, loader, batch, cfg, mesh=None):
    """The planted batch through Evaluator.detect_images (packed, on the
    host) and the planted set through evaluate() (its mAP@0.50)."""
    from os2d_torch.engine.evaluate import Evaluator, evaluate

    evaluator = Evaluator(model, cfg, mesh=mesh)
    class_images, _, _ = loader.get_all_class_images()
    head, views = evaluator.build_class_heads(class_images, cfg.eval.class_image_augmentation)
    images, sizes, inv = batch
    packed = evaluator.detect_images(images, head, sizes, inv, loader.img_normalization, views)
    results = evaluate(loader, model, cfg, mesh=mesh)
    return packed.cpu().numpy(), results["mAP@0.50"]


def distributed_rank(mesh, inputs):
    """One rank of phase distributed, in a process of its own: DIST_STEPS
    data-parallel TrainSteps at the default tier from the phase's start
    weights on its global batches, then, in turns with the plain step on the
    same weights when inputs["time_plain"], the timed steps; then the eval of
    each axis in inputs["eval_axes"] at "highest". Returns the metrics, a
    digest of the weights, the packed detections and mAPs, s/step and each
    part's kernel launches (rank 0 writes its final weights to
    inputs["final_path"])."""
    import numpy as np
    import torch

    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops import hat_resample, resample, resample_grad

    kernels = {"resample_correlation": resample.KERNEL,
               "hat_resample_correlation": hat_resample.KERNEL,
               "resample_correlation_backward": resample_grad.KERNEL}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        return {name: k.launches for name, k in kernels.items()}

    device, cfg = mesh.device, inputs["train_cfg"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(device),
           "backend": torch.distributed.get_backend()}
    model = Os2dModel(Os2dConfig(), device=device)
    model.load_state_dict(torch.load(inputs["start_path"], weights_only=True))
    optimizer = create_optimizer(cfg.train.optim, trainable_parameters(model, cfg.train))
    objective = ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS)
    step = TrainStep(model, objective, optimizer, cfg.train, mesh=mesh)
    prepared = [prepare_batch_arrays(b, device) for b in inputs["batches"]]
    reset_counts()
    out["metrics"] = [step(*p) for p in prepared]
    sync()
    out["train_launches"] = read_counts()
    out["digest"] = _state_digest(model)
    if mesh.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   inputs["final_path"])

    # s/step, after the steps above warmed both up: the data-parallel step
    # and, on one rank, the plain step in turns (dp, plain, plain, dp)
    plain = TrainStep(model, objective, optimizer, cfg.train) if inputs["time_plain"] else None
    order = ["dp", "plain", "plain", "dp"] if plain is not None else ["dp", "dp"]
    times = {"dp": [], "plain": []}
    for name in order * DIST_TIMED_ROUNDS:
        sync()
        t0 = time.perf_counter()
        (step if name == "dp" else plain)(*prepared[0])
        sync()
        times[name].append(time.perf_counter() - t0)
    out["step_s"] = {k: v for k, v in times.items() if v}
    out["median_step_s"] = {k: float(np.median(v)) for k, v in times.items() if v}
    del model, step, plain, optimizer, prepared
    if device.type == "cuda":
        torch.cuda.empty_cache()

    loader, eval_model, batch = _eval_setup(device, inputs["eval_root"], inputs["eval_df"])
    out["eval"] = {}
    for axis in inputs["eval_axes"]:
        reset_counts()
        packed, map50 = _detect_and_evaluate(eval_model, loader, batch, _dist_eval_cfg(axis), mesh)
        sync()
        out["eval"][axis] = {"packed": packed, "mAP@0.50": map50, "launches": read_counts()}
    return out


def _within(got, want, rtol, atol):
    """max over elements of |got - want| - (atol + rtol |want|): <= 0 holds."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def distributed_phase(train_cfg, batches, require_launches, device="cuda"):
    """Phase 22 in a directory of its own under build/ (start and final
    weights, the planted set), removed whatever happens."""
    from os2d_torch.ops.cuda import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        return _distributed_phase(work, train_cfg, batches, require_launches, device)


def _distributed_phase(work, train_cfg, batches, require_launches, device):
    """Phase 22 (distributed); returns the kernels' launches in its ranks,
    summed. (a) one nccl rank: the data-parallel TrainStep against the plain
    step in this process from the same weights on the same global batches,
    then the class-sharded eval. (b) two ranks sharing cuda:0 over gloo: the
    same steps at 2 images per rank, then the class- and image-sharded
    evals. Any failed group, rank, check or count ends the run. With
    device="cpu" every rank runs on the CPU over gloo (the kernels' plain
    versions: no launch to count)."""
    import numpy as np
    import torch

    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.parallel.spawn import run_local_group

    # the plain single-process reference, twice from the start weights that
    # the ranks load; training repeats to the bit under the port's defaults,
    # so the second run must repeat the first to the bit. (b) runs two
    # images a rank against the reference's four: models/resnet.py:
    # wgrad_1x1_gemm makes a batch's 1x1 weight gradients the sum of its
    # halves', as the two ranks add them (with one GEMM over the batch a
    # threshold of the step-3 loss flipped, 6.195e-5 off on an H100)
    start_path = os.path.join(work, "start.pth")
    runs = []
    for _ in range(2):
        ref_model = Os2dModel(Os2dConfig(), device=device, seed=DIST_SEED)
        if not runs:
            torch.save({k: v.detach().cpu() for k, v in ref_model.state_dict().items()},
                       start_path)
        ref_opt = create_optimizer(train_cfg.train.optim,
                                   trainable_parameters(ref_model, train_cfg.train))
        ref_step = TrainStep(ref_model, ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS),
                             ref_opt, train_cfg.train)
        runs.append(([ref_step(*prepare_batch_arrays(b, device)) for b in batches], ref_model))
    (ref_metrics, ref_model), (rerun_metrics, _) = runs
    ref_final = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    del runs, ref_model, ref_step, ref_opt

    eval_root = os.path.join(work, "planted")
    eval_df = write_planted_dataset(eval_root)
    loader, eval_model, batch = _eval_setup(device, eval_root, eval_df)
    ref_packed, ref_map = _detect_and_evaluate(eval_model, loader, batch,
                                               _dist_eval_cfg("classes"))
    del loader, eval_model
    if device == "cuda":
        torch.cuda.empty_cache()
    rank_device = "cuda:0" if device == "cuda" else device

    inputs = {"train_cfg": train_cfg, "batches": batches, "start_path": start_path,
              "eval_root": eval_root, "eval_df": eval_df}
    t0 = time.perf_counter()
    ranks_a = run_local_group(distributed_rank, 1, (dict(
        inputs, final_path=os.path.join(work, "final_a.pth"), time_plain=True,
        eval_axes=["classes"]),), devices=[rank_device],
        backend="nccl" if device == "cuda" else "gloo", timeout_s=DIST_TIMEOUT_S)
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks_b = run_local_group(distributed_rank, 2, (dict(
        inputs, final_path=os.path.join(work, "final_b.pth"), time_plain=False,
        eval_axes=["classes", "images"]),), devices=[rank_device] * 2, backend="gloo",
        timeout_s=DIST_TIMEOUT_S)
    b_s = time.perf_counter() - t0

    def rel_errs(ranks, keys):
        """[(relative error, step, term)] of every rank's steps and terms."""
        return [(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12), i, k)
                for r in ranks for i, (got, want) in enumerate(zip(r["metrics"], ref_metrics))
                for k in keys]

    def rel_err(ranks, keys):
        return max(e for e, _, _ in rel_errs(ranks, keys))

    def worst(ranks, keys):
        e, i, k = max(rel_errs(ranks, keys))
        return f"{e} ({k}, step {i + 1})"

    # the loss terms are held; the gradient norm is reported (the data-parallel
    # step sums the gradients in another order)
    loss_keys = [k for k in ref_metrics[0] if k != "grad_norm"]

    def weights_err(path):
        got = torch.load(path, weights_only=True)
        return max(_within(got[k].to(device), ref_final[k], DIST_PARAM_RTOL, DIST_PARAM_ATOL)
                   for k in ref_final)

    def packed_agree(got, want):
        valid = want[..., 5] > 0.5
        return (bool(np.array_equal(got[..., 5], want[..., 5])) and bool(valid.any())
                and float(np.abs(got[valid][:, 4] - want[valid][:, 4]).max()) <= DIST_SCORE_ATOL
                and float(np.abs(got[valid][:, :4] - want[valid][:, :4]).max()) <= DIST_BOX_ATOL)

    a, b_ranks = ranks_a[0], ranks_b
    report = {
        "phase": "distributed", "steps": DIST_STEPS, "global_batch": len(batches[0]["images"]),
        "recipe": "get_default_cfg() train at the default tier, margin_pos "
                  f"{FIRST_STEP_MARGIN_POS}; eval: phase 4's planted set at highest",
        "nvidia_smi": nvidia_smi_line() if device == "cuda" else None,
        "reference_metrics": ref_metrics,
        "plain_rerun_bit_equal": rerun_metrics == ref_metrics,
        "plain_rerun_grad_norm_max_rel_err": rel_err([{"metrics": rerun_metrics}],
                                                     ["grad_norm"]),
        "plain_rerun_loss_max_rel_err": rel_err([{"metrics": rerun_metrics}], loss_keys),
        "a_nccl_1_rank": {"backend": a["backend"], "metrics": a["metrics"],
                          "loss_max_rel_err": rel_err([a], loss_keys),
                          "grad_norm_max_rel_err": rel_err([a], ["grad_norm"]),
                          "weights_excess_over_tol": weights_err(os.path.join(work,
                                                                              "final_a.pth")),
                          "mAP@0.50": a["eval"]["classes"]["mAP@0.50"],
                          "packed_agree": packed_agree(a["eval"]["classes"]["packed"],
                                                       ref_packed),
                          "step_s": a["step_s"], "median_step_s": a["median_step_s"],
                          "train_launches": a["train_launches"],
                          "eval_launches": a["eval"]["classes"]["launches"], "seconds": a_s},
        "b_gloo_2_ranks_on_cuda0": {
            "backend": b_ranks[0]["backend"], "metrics": [r["metrics"] for r in b_ranks],
            "loss_max_rel_err": rel_err(b_ranks, loss_keys),
            "grad_norm_max_rel_err": rel_err(b_ranks, ["grad_norm"]),
            "weights_bit_equal_across_ranks": len({r["digest"] for r in b_ranks}) == 1,
            "weights_excess_over_tol": weights_err(os.path.join(work, "final_b.pth")),
            "eval": {axis: {"mAP@0.50": [r["eval"][axis]["mAP@0.50"] for r in b_ranks],
                            "packed_agree": [packed_agree(r["eval"][axis]["packed"], ref_packed)
                                             for r in b_ranks],
                            "launches": [r["eval"][axis]["launches"] for r in b_ranks]}
                     for axis in ("classes", "images")},
            "median_step_s": [r["median_step_s"] for r in b_ranks],
            "train_launches": [r["train_launches"] for r in b_ranks], "seconds": b_s,
            "note": "two processes share one card: no measure of scaling"},
        "unsharded_mAP@0.50": ref_map, "loss_rtol": DIST_LOSS_RTOL,
        "weights_rtol_atol": [DIST_PARAM_RTOL, DIST_PARAM_ATOL],
        "score_atol": DIST_SCORE_ATOL, "box_atol_px": DIST_BOX_ATOL,
    }
    emit(report)

    ra, rb = report["a_nccl_1_rank"], report["b_gloo_2_ranks_on_cuda0"]
    failures = []
    if not report["plain_rerun_bit_equal"]:
        failures.append(f"the plain step's rerun differs: "
                        f"{worst([{'metrics': rerun_metrics}], list(ref_metrics[0]))}")
    if not ra["loss_max_rel_err"] <= DIST_LOSS_RTOL:
        failures.append(f"(a) losses off the plain step by {worst([a], loss_keys)}")
    if not ra["weights_excess_over_tol"] <= 0:
        failures.append(f"(a) weights off the plain step's by {ra['weights_excess_over_tol']} "
                        "over the tolerance")
    if not (ra["mAP@0.50"] == ref_map == 1.0 and ra["packed_agree"]):
        failures.append(f"(a) class-sharded eval: mAP {ra['mAP@0.50']} against {ref_map}, "
                        f"packed agree {ra['packed_agree']}")
    if not rb["loss_max_rel_err"] <= DIST_LOSS_RTOL:
        failures.append(f"(b) losses off the plain step by {worst(b_ranks, loss_keys)}")
    if not rb["weights_bit_equal_across_ranks"]:
        failures.append("(b) the ranks' weights differ")
    for axis, e in rb["eval"].items():
        if not (all(m == ref_map for m in e["mAP@0.50"]) and all(e["packed_agree"])):
            failures.append(f"(b) {axis}-sharded eval: mAP {e['mAP@0.50']} against {ref_map}, "
                            f"packed agree {e['packed_agree']}")
    if failures:
        raise SystemExit("distributed: " + "; ".join(failures))

    totals = dict.fromkeys(a["train_launches"], 0)
    for r in [a] + b_ranks:
        require_launches("distributed train", r["train_launches"], "hat_resample_correlation",
                         DIST_STEPS)
        require_launches("distributed train", r["train_launches"],
                         "resample_correlation_backward", DIST_STEPS)
        for axis, e in r["eval"].items():
            require_launches(f"distributed eval {axis}", e["launches"], "resample_correlation")
        for counts in [r["train_launches"]] + [e["launches"] for e in r["eval"].values()]:
            for k, v in counts.items():
                totals[k] += v
    return totals


def group_norm_bytes(n, c, h, w):
    """(forward, backward) least bytes of one GroupNorm slot: x read and y
    written; x and dy read and dx written; the weight, bias, statistics and
    per-channel gradients once each; fp32 (hopper_bench/counts/group_norm.py:
    slot_bytes)."""
    size = n * c * h * w
    return (4 * (2 * size + 2 * c + 2 * n * GN_GROUPS),
            4 * (3 * size + 3 * c + 2 * n * GN_GROUPS))


def group_norm_kernels(gen):
    """Phase group_norm_kernel: the GroupNorm kernels at GN_SLOTS against
    their plain versions in fp64 and F.group_norm's fp32 error, two calls to
    the bit, and each slot's times. Returns {"forward": {...}, "backward":
    {...}}, the kernels line's max_abs_err, ms, plain_ms, bound_ms, bound_by
    and library_ms (the times at GN_SLOTS[0])."""
    import torch
    import torch.nn.functional as F

    from os2d_torch.ops import group_norm as gn

    parts = ("y", "dx", "dweight", "dbias")
    errs, aten_errs, repeat, times = {}, {}, {}, {}
    for name, n, c, h, w in GN_SLOTS:
        x = (torch.randn(n, c, h, w, generator=gen, device="cuda") * 2
             + (torch.rand(1, c, 1, 1, generator=gen, device="cuda") * 2 - 1) * 3)
        x = x.contiguous(memory_format=torch.channels_last)
        dy = torch.randn(n, c, h, w, generator=gen, device="cuda").contiguous(
            memory_format=torch.channels_last)
        weight = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda") * 0.1
        y, mean, rstd = gn.group_norm_forward(x, GN_GROUPS, weight, bias, GN_EPS)
        grads = gn.group_norm_backward(dy, x, GN_GROUPS, weight, mean, rstd)
        y2, mean2, rstd2 = gn.group_norm_forward(x, GN_GROUPS, weight, bias, GN_EPS)
        grads2 = gn.group_norm_backward(dy, x, GN_GROUPS, weight, mean, rstd)
        repeat[name] = (torch.equal(y, y2) and torch.equal(mean, mean2)
                        and torch.equal(rstd, rstd2)
                        and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        del y2, mean2, rstd2, grads2
        x64, w64, b64, dy64 = (t.double() for t in (x, weight, bias, dy))
        y64, mean64, rstd64 = gn.group_norm_reference(x64, GN_GROUPS, w64, b64, GN_EPS)
        want = (y64, *gn.group_norm_backward_reference(dy64, x64, GN_GROUPS, w64, mean64,
                                                       rstd64))
        del x64, w64, b64, dy64, y64, mean64, rstd64
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, weight, bias)]
        ya = F.group_norm(leaves[0], GN_GROUPS, leaves[1], leaves[2], GN_EPS)
        aten = (ya.detach(), *torch.autograd.grad(ya, leaves, dy))
        del ya
        errs[name] = {p: float((g.double() - t).abs().max())
                      for p, g, t in zip(parts, (y, *grads), want)}
        aten_errs[name] = {p: float((g.double() - t).abs().max())
                           for p, g, t in zip(parts, aten, want)}
        scale = {p: float(t.abs().max()) for p, t in zip(parts, want)}
        del aten, want
        for p in parts:
            if not errs[name][p] <= GN_ATEN_FACTOR * aten_errs[name][p] + GN_ATOL_TO_MAX * scale[p]:
                raise SystemExit(f"group_norm_kernel: {p} at {name} is {errs[name][p]} from its "
                                 f"plain version in fp64, F.group_norm's {aten_errs[name][p]}")
        if not repeat[name]:
            raise SystemExit(f"group_norm_kernel: two calls at {name} differ")

        holder = {}

        def aten_forward():
            holder["y"] = F.group_norm(leaves[0], GN_GROUPS, leaves[1], leaves[2], GN_EPS)

        def aten_backward():
            torch.autograd.grad(holder["y"], leaves, dy, retain_graph=True)

        aten_forward()
        bound_ms = [b / HBM_BYTES_PER_S * 1e3 for b in group_norm_bytes(n, c, h, w)]
        times[name] = {
            "nchw": [n, c, h, w],
            "ms": [cuda_ms(lambda: gn.group_norm_forward(x, GN_GROUPS, weight, bias, GN_EPS),
                           20),
                   cuda_ms(lambda: gn.group_norm_backward(dy, x, GN_GROUPS, weight, mean, rstd),
                           20)],
            "plain_ms": [
                cuda_ms(lambda: gn.group_norm_reference(x, GN_GROUPS, weight, bias, GN_EPS), 5),
                cuda_ms(lambda: gn.group_norm_backward_reference(dy, x, GN_GROUPS, weight, mean,
                                                                 rstd), 5)],
            "library_ms": [cuda_ms(aten_forward, 20), cuda_ms(aten_backward, 20)],
            "bound_ms": bound_ms}
        times[name]["roofline_pct"] = [100 * b / m for b, m in zip(bound_ms, times[name]["ms"])]
        del x, dy, weight, bias, y, mean, rstd, grads, leaves, holder
    emit({"phase": "group_norm_kernel", "groups": GN_GROUPS, "eps": GN_EPS,
          "rule": f"err <= {GN_ATEN_FACTOR} x F.group_norm's + {GN_ATOL_TO_MAX} x max|want|",
          "max_abs_err": errs, "aten_max_abs_err": aten_errs, "two_calls_bit_equal": repeat,
          "order": "[forward, backward]", "library": "F.group_norm and its autograd backward",
          "times": times})
    stem = times[GN_SLOTS[0][0]]
    return {direction: {
        "max_abs_err": max(e[p] for e in errs.values() for p in direction_parts),
        "ms": stem["ms"][i], "plain_ms": stem["plain_ms"][i],
        "bound_ms": stem["bound_ms"][i], "bound_by": "bytes",
        "library_ms": stem["library_ms"][i]}
        for i, (direction, direction_parts) in enumerate(
            (("forward", parts[:1]), ("backward", parts[1:])))}


def frozen_bn_bytes(form, n, c, h, w):
    """Least bytes of one frozen BatchNorm slot: x read and y written, the
    identity read too in a tail, and the parameter vectors once, fp32."""
    return 4 * ((2 if form == 0 else 3) * n * c * h * w + (8 if form == 2 else 4) * c)


def frozen_bn_kernels(gen):
    """Phase frozen_bn_kernel: the frozen BatchNorm kernel at FBN_SLOTS
    against ATen's eager chain (to the bit) and its plain version in fp64,
    two calls to the bit, and each slot's times. Returns the kernels line's
    max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms (the times
    at FBN_SLOTS[0]; plain and library both the eager chain, which is the
    plain version's arithmetic)."""
    import copy

    import torch

    from os2d_torch.ops import frozen_bn as fb

    report = {}
    for name, form, shape in FBN_SLOTS:
        n, c, h, w = shape

        def operand():
            return torch.randn(shape, generator=gen, device="cuda").contiguous(
                memory_format=torch.channels_last)

        def norm():
            bn = fb.FrozenBatchNorm2d(c, device="cuda")
            with torch.no_grad():
                bn.weight.copy_(torch.rand(c, generator=gen, device="cuda") + 0.5)
                bn.bias.copy_(torch.randn(c, generator=gen, device="cuda") * 0.5)
                bn.running_mean.copy_(torch.randn(c, generator=gen, device="cuda"))
                bn.running_var.copy_(torch.rand(c, generator=gen, device="cuda") * 2 + 0.01)
            return bn

        x = operand() * 2
        bn = norm()
        identity = None if form == 0 else operand()
        identity_bn = norm() if form == 2 else None
        args = (x, bn, identity, identity_bn)
        with torch.no_grad():
            y = fb.frozen_bn_act(*args)
            y2 = fb.frozen_bn_act(*args)
            eager = fb.frozen_bn_act_eager(*args)
            bit_equal = torch.equal(y, eager)
            repeat = torch.equal(y, y2)
            del y2, eager
            want = fb.frozen_bn_act_reference(
                x.double(), copy.deepcopy(bn).double(),
                None if identity is None else identity.double(),
                None if identity_bn is None else copy.deepcopy(identity_bn).double())
            err = float((y.double() - want).abs().max())
            del want
            if not (bit_equal and repeat):
                raise SystemExit(f"frozen_bn_kernel: at {name} the kernel equals the eager "
                                 f"chain {bit_equal}, two calls equal {repeat}")
            host_us = {}
            for label, fn in (("kernel", fb.frozen_bn_act), ("eager", fb.frozen_bn_act_eager)):
                fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn(*args)
                host_us[label] = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
            bound_ms = frozen_bn_bytes(form, *shape) / HBM_BYTES_PER_S * 1e3
            ms = cuda_ms(lambda: fb.frozen_bn_act(*args), 20)
            eager_ms = cuda_ms(lambda: fb.frozen_bn_act_eager(*args), 20)
        report[name] = {"nchw": list(shape), "form": form, "bit_equal_eager": bit_equal,
                        "two_calls_bit_equal": repeat, "max_abs_err_fp64": err,
                        "ms": ms, "eager_ms": eager_ms, "bound_ms": bound_ms,
                        "roofline_pct": 100 * bound_ms / ms,
                        "eager_roofline_pct": 100 * bound_ms / eager_ms,
                        "host_us_per_call": host_us}
        del x, identity, y, args
    emit({"phase": "frozen_bn_kernel", "eps": fb.BN_EPS, "slots": report,
          "eager": "FrozenBatchNorm2d's ATen ops, the add and F.relu, one launch each"})
    stem = report[FBN_SLOTS[0][0]]
    return {"max_abs_err": max(r["max_abs_err_fp64"] for r in report.values()),
            "ms": stem["ms"], "plain_ms": stem["eager_ms"], "bound_ms": stem["bound_ms"],
            "bound_by": "bytes", "library_ms": stem["eager_ms"]}


def planted_found(det):
    """For each planted patch, its class's top valid detection of its scene:
    IoU with the patch's box, score, and ok (valid and IoU > 0.5)."""
    import numpy as np
    import torch

    from os2d_torch.structures.boxes import box_iou

    found = []
    for image_id, plants in PLANTED.items():
        for x0, y0, cid in plants:
            valid = det["valid"][image_id, cid]
            top = int(np.argmax(np.where(valid, det["scores"][image_id, cid], -np.inf)))
            iou = float(box_iou(torch.tensor(det["boxes"][image_id, cid, top][None]),
                                torch.tensor([[x0, y0, x0 + PATCH, y0 + PATCH]],
                                             dtype=torch.float32)))
            found.append({"image": image_id, "class": cid, "iou": iou,
                          "score": float(det["scores"][image_id, cid, top]),
                          "ok": bool(valid.any()) and iou > 0.5})
    return found


def planted_eval_loader(root):
    """The planted dataset written under `root` as files, read through the
    port's data layer at EVAL_PYRAMID (phase 4's loader)."""
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.data.dataset import DatasetOneShotDetection

    dataset = DatasetOneShotDetection(
        write_planted_dataset(root), gt_path=os.path.join(root, "classes", "images"),
        image_path=os.path.join(root, "src"), name="planted", image_size=640,
        eval_scale=640, cache_images=True)
    return DataloaderOneShotDetection(dataset, batch_size=1, pyramid_scales_eval=EVAL_PYRAMID)


def max_abs_diff(got, want):
    return float((got.cpu().float() - want.cpu().float()).abs().max())


def model_options(counts, ctx):
    """Phases 23 (int8_tier), 24 (int8_bank), 25 (grid_path) and 26
    (group_norm): the model options of Os2dConfig and cfg.tpu beside the
    default, each on the card against the CPU. `counts` holds reset(),
    read() and require(phase, counts, kernel, expected); `ctx` the main
    path's objects (the model and its weights, the planted scenes, the bench
    batches and evaluator, the train batch and recipe). Returns the int8
    kernel's launches in the timed int8 dispatches and the GroupNorm
    kernels' in phase 26's planted run, first step and timed turns, by
    kernel."""
    import numpy as np
    import torch

    from os2d_torch.engine.evaluate import Evaluator, evaluate, unpack_detections
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.head import quantize_class_head
    from os2d_torch.ops.cuda import BUILD_DIR

    def option_model(device="cuda", state=ctx.base_state, **options):
        m = Os2dModel(Os2dConfig(**options), device=device)
        m.load_state_dict({k: v.to(device) for k, v in state.items()})
        return m

    def planted_card_cpu(phase, kernel, score_atol=1e-4, **options):
        """Planted detections of a card model and its CPU twin with
        `options`: (card detections, CPU detections, agree, card launches)."""
        counts.reset()
        card = ctx.planted_detections(option_model("cuda", **options))
        torch.cuda.synchronize()
        launches = counts.read()
        cpu = ctx.planted_detections(option_model("cpu", **options))
        counts.require(phase, launches, kernel)
        return card, cpu, detections_agree(card, cpu, score_atol=score_atol), launches

    def in_turns(runs, rounds):
        """Each named (evaluator, class head) timed at the bench protocol in
        turns (a, b, b, a, ...) after one warmup each: ({name: [s]}, the
        launches of the timed dispatches)."""
        names = list(runs)
        for ev_r, head_r in runs.values():
            ev_r.detect_images(ctx.batches[-1], head_r, ctx.sizes, ctx.inv, ctx.norm)
        torch.cuda.synchronize()
        counts.reset()
        times = {n: [] for n in names}
        for i, name in enumerate((names + names[::-1]) * rounds):
            ev_r, head_r = runs[name]
            t0 = time.perf_counter()
            out = ev_r.detect_images(ctx.batches[i % TIMED_DISPATCHES], head_r, ctx.sizes,
                                     ctx.inv, ctx.norm)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            d = unpack_detections(out)
            if not (np.isfinite(d["scores"][d["valid"]]).all() and d["valid"].any()):
                raise SystemExit(f"{name}: non-finite or no detections at the bench protocol")
        return times, counts.read()

    def turns_summary(times):
        return {"dispatch_s": times,
                "median_dispatch_ms": {n: float(np.median(v)) * 1e3 for n, v in times.items()},
                "spread_ms": {n: [min(v) * 1e3, max(v) * 1e3] for n, v in times.items()}}

    def first_step_card_cpu(phase, **options):
        """Phase 9's first step (seed-1 weights, margin_pos 1.0, the train
        recipe's first batch) of a model with `options`, card against CPU."""
        card = Os2dModel(Os2dConfig(**options), seed=1)
        cpu = Os2dModel(Os2dConfig(**options), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        out = {}
        for dev, m in (("cuda", card), ("cpu", cpu)):
            opt = create_optimizer(ctx.train_cfg.train.optim,
                                   trainable_parameters(m, ctx.train_cfg.train))
            step = TrainStep(m, ctx.first_objective, opt, ctx.train_cfg.train)
            arrays, c_pad = prepare_batch_arrays(ctx.train_batch, m.device)
            if dev == "cuda":
                counts.reset()
            out[dev] = step(arrays, c_pad)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = counts.read()
        err = {k: abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
               for k in out["cpu"]}
        if not all(np.isfinite(v) for v in out["cuda"].values()):
            raise SystemExit(f"{phase}: non-finite metrics {out['cuda']}")
        if not out["cuda"]["cls_RLL_pos"] > 0:
            raise SystemExit(f"{phase}: no positive below margin_pos, the cls gradient is zero")
        for k in ("loss", "grad_norm"):
            if not err[k] <= TRAIN_CPU_RTOL:
                raise SystemExit(f"{phase}: first step {k} {out['cuda'][k]} on the card, "
                                 f"{out['cpu'][k]} on the CPU")
        counts.require(phase, launches, "hat_resample_correlation", 1)
        counts.require(phase, launches, "resample_correlation_backward", 1)
        return {"cuda": out["cuda"], "cpu": out["cpu"], "relative_err": err,
                "rtol": TRAIN_CPU_RTOL, "launches": launches}

    # ---- 23. the int8 tier ----
    t_phase = time.perf_counter()
    card, cpu, agree, planted_launches = planted_card_cpu(
        "int8_tier", "int8_hat_resample_correlation", INT8_SCORE_ATOL,
        resample_precision="int8")
    found = planted_found(card)
    int8_model = option_model(resample_precision="int8")
    ev_int8 = Evaluator(int8_model, ctx.cfg)
    head_int8, _ = ev_int8.build_class_heads(ctx.class_images)
    times, int8_counts = in_turns(
        {"default": (ctx.ev, ctx.class_head), "int8": (ev_int8, head_int8)}, OPTION_ROUNDS)
    n_timed = 2 * OPTION_ROUNDS  # dispatches of each in the turns
    emit({"phase": "int8_tier", "found": found, "cuda_matches_cpu": agree,
          "score_atol": INT8_SCORE_ATOL, "planted_launches": planted_launches,
          "images": f"{BATCH}x{IMG_W}x{IMG_H} uint8", "levels": len(PYRAMID),
          "classes": NUM_CLASSES, "order": "default, int8, int8, default, ...",
          **turns_summary(times), "launches": int8_counts,
          "seconds": time.perf_counter() - t_phase})
    if not (agree and all(f["ok"] for f in found)):
        raise SystemExit(f"int8_tier: planted detections found {found}, card = CPU {agree}")
    counts.require("int8_tier", int8_counts, "int8_hat_resample_correlation",
                   len(PYRAMID) * n_timed)
    counts.require("int8_tier", int8_counts, "hat_resample_correlation",
                   len(PYRAMID) * n_timed)
    del ev_int8, head_int8, int8_model

    # ---- 24. the int8 class bank ----
    t_phase = time.perf_counter()
    bank_cfg = ctx.eval_cfg.clone()
    bank_cfg.tpu.quantize_class_feats = True
    bank_cfg.eval.class_image_augmentation = ""
    cpu_model = option_model("cpu")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        loader = planted_eval_loader(root)
        counts.reset()
        bank_results = evaluate(loader, ctx.model, bank_cfg)
        torch.cuda.synchronize()
        bank_counts = counts.read()
        bank_cpu_results = evaluate(loader, cpu_model, bank_cfg)
    del cpu_model
    qhead = quantize_class_head(ctx.class_head)
    fp32_mb = ctx.class_head.class_feats.element_size() * ctx.class_head.class_feats.numel() / 2**20
    int8_mb = (qhead.class_feats_q.element_size() * qhead.class_feats_q.numel()
               + qhead.scales.element_size() * qhead.scales.numel()) / 2**20
    emit({"phase": "int8_bank", "levels": EVAL_PYRAMID,
          "nms_score_threshold": float(bank_cfg.eval.nms_score_threshold),
          "mAP@0.50": bank_results["mAP@0.50"], "cpu_mAP@0.50": bank_cpu_results["mAP@0.50"],
          "prescreen_applied": "prescreen_pruned" in bank_results,
          "bench_bank": {"classes": NUM_CLASSES, "fp32_mb": fp32_mb, "int8_mb": int8_mb,
                         "dtype": str(qhead.class_feats_q.dtype)},
          "launches": bank_counts, "seconds": time.perf_counter() - t_phase})
    if not bank_results["mAP@0.50"] == 1.0 == bank_cpu_results["mAP@0.50"]:
        raise SystemExit(f"int8_bank: mAP@0.50 {bank_results['mAP@0.50']} on the card, "
                         f"{bank_cpu_results['mAP@0.50']} on the CPU")
    if "prescreen_pruned" in bank_results or qhead.class_feats_q.dtype != torch.int8:
        raise SystemExit("int8_bank: the prescreen ran on an int8 bank, or the bank is not int8")
    counts.require("int8_bank", bank_counts, "hat_resample_correlation")

    # ---- 25. the grid path (corr_interior_first=False) ----
    t_phase = time.perf_counter()
    grid = {}
    scene = torch.as_tensor(ctx.scenes[:1]).float() / 255.0
    scene = (scene - torch.tensor(ctx.norm["mean"])) / torch.tensor(ctx.norm["std"])
    for tier, kernel in (("default", "hat_resample_correlation"),
                         ("highest", "resample_correlation")):
        card, cpu, agree, launches = planted_card_cpu(
            f"grid_path {tier}", kernel, corr_interior_first=False, resample_precision=tier)
        # the head's outputs at full width on the card and the CPU, and the
        # interior-first head on the card: the same function
        heads = {}
        for name, dev, first in (("cuda", "cuda", False), ("cpu", "cpu", False),
                                 ("cuda_interior_first", "cuda", True)):
            m = option_model(dev, corr_interior_first=first, resample_precision=tier)
            with torch.no_grad():
                fm = m.extract_features(scene.to(dev))
                bank, _ = Evaluator(m, ctx.cfg).build_class_heads(ctx.planted_class_images)
                heads[name] = m.apply_head(fm, bank)
        head_err = {key: {"card_vs_cpu": max_abs_diff(heads["cuda"][key], heads["cpu"][key]),
                          "vs_interior_first": max_abs_diff(heads["cuda"][key],
                                                            heads["cuda_interior_first"][key])}
                    for key in ("cls", "loc", "corners")}
        grid[tier] = {"found": planted_found(card), "cuda_matches_cpu": agree,
                      "head_max_abs_err": head_err, "launches": launches}
        if not (agree and all(f["ok"] for f in grid[tier]["found"])):
            raise SystemExit(f"grid_path {tier}: planted {grid[tier]['found']}, card = CPU {agree}")
        for key in ("cls", "loc"):
            if not max(head_err[key].values()) <= GRID_HEAD_ATOL:
                raise SystemExit(f"grid_path {tier}: {key} {head_err[key]}")
    grid_model = option_model(corr_interior_first=False)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        loader = planted_eval_loader(root)
        counts.reset()
        grid_results = evaluate(loader, grid_model, ctx.eval_cfg)
        grid_eval_counts = counts.read()
    grid_step = first_step_card_cpu("grid_path", corr_interior_first=False)
    ev_grid = Evaluator(grid_model, ctx.cfg)
    head_grid, _ = ev_grid.build_class_heads(ctx.class_images)
    times, turn_counts = in_turns(
        {"interior_first": (ctx.ev, ctx.class_head), "grid": (ev_grid, head_grid)},
        OPTION_ROUNDS)
    counts.require("grid_path turns", turn_counts, "hat_resample_correlation",
                   len(PYRAMID) * 2 * n_timed)
    emit({"phase": "grid_path", "tiers": grid, "head_atol": GRID_HEAD_ATOL,
          "evaluate": {"mAP@0.50": grid_results["mAP@0.50"],
                       "interior_first_mAP@0.50": ctx.eval_map,
                       "prescreen_pruned": grid_results.get("prescreen_pruned"),
                       "launches": grid_eval_counts},
          "train_first_step": grid_step, "order": "interior_first, grid, grid, ...",
          **turns_summary(times), "seconds": time.perf_counter() - t_phase})
    if not grid_results["mAP@0.50"] == ctx.eval_map == 1.0:
        raise SystemExit(f"grid_path: evaluate() mAP@0.50 {grid_results['mAP@0.50']}, "
                         f"interior-first {ctx.eval_map}")
    counts.require("grid_path evaluate", grid_eval_counts, "hat_resample_correlation")
    del ev_grid, head_grid, grid_model

    # ---- 26. GroupNorm backbones and ResNet101 ----
    t_phase = time.perf_counter()
    gn_state = Os2dModel(Os2dConfig(use_group_norm=True), seed=0).state_dict()
    card, cpu, gn_agree, gn_launches = planted_card_cpu(
        "group_norm", "hat_resample_correlation", state=gn_state, use_group_norm=True)
    counts.require("group_norm", gn_launches, "group_norm_forward")
    gn_step = first_step_card_cpu("group_norm", use_group_norm=True)
    # first sight: both passes eager, each of the 43 slots once a pass
    for kernel in ("group_norm_forward", "group_norm_backward"):
        counts.require("group_norm first step", gn_step["launches"], kernel, 2 * 43)
    r101 = {}
    crop = scene[:, :GN_CROP[1], :GN_CROP[0]]
    for gn in (False, True):
        m = Os2dModel(Os2dConfig(backbone_arch="resnet101", use_group_norm=gn), seed=3)
        m_cpu = option_model("cpu", m.state_dict(), backbone_arch="resnet101", use_group_norm=gn)
        with torch.no_grad():
            got, want = m.extract_features(crop.cuda()), m_cpu.extract_features(crop)
        scale = float(want.abs().max())
        r101["gn" if gn else "bn"] = {
            "shape": list(got.shape), "max_abs": scale, "max_abs_err": max_abs_diff(got, want),
            "relative_to_max": max_abs_diff(got, want) / scale}
        del m, m_cpu
    gn_model = option_model(state=gn_state, use_group_norm=True)
    ev_gn = Evaluator(gn_model, ctx.cfg)
    head_gn, _ = ev_gn.build_class_heads(ctx.class_images)
    times, turn_counts = in_turns(
        {"batch_norm": (ctx.ev, ctx.class_head), "group_norm": (ev_gn, head_gn)},
        OPTION_ROUNDS)
    counts.require("group_norm turns", turn_counts, "hat_resample_correlation",
                   len(PYRAMID) * 2 * n_timed)
    counts.require("group_norm turns", turn_counts, "group_norm_forward")
    # the backbone's share: the pyramid and backbone of a dispatch alone, in turns
    backbone = {"batch_norm": [], "group_norm": []}
    for i, (name, ev_b) in enumerate([("batch_norm", ctx.ev), ("group_norm", ev_gn),
                                      ("group_norm", ev_gn), ("batch_norm", ctx.ev)]
                                     * OPTION_ROUNDS):
        t0 = time.perf_counter()
        ev_b._pyramid_features(ctx.batches[i % TIMED_DISPATCHES], ctx.sizes, ctx.norm)
        torch.cuda.synchronize()
        backbone[name].append(time.perf_counter() - t0)
    emit({"phase": "group_norm", "found": planted_found(card), "cuda_matches_cpu": gn_agree,
          "launches": gn_launches, "train_first_step": gn_step,
          "resnet101_c4": {"input": f"1x{GN_CROP[0]}x{GN_CROP[1]}", **r101,
                           "rtol_to_max": R101_RTOL_TO_MAX},
          "order": "batch_norm, group_norm, group_norm, batch_norm, ...",
          **turns_summary(times),
          "pyramid_and_backbone_ms": {n: float(np.median(v)) * 1e3 for n, v in backbone.items()},
          "seconds": time.perf_counter() - t_phase})
    if not gn_agree:
        raise SystemExit("group_norm: planted detections differ between the card and the CPU")
    for name, r in r101.items():
        if not r["relative_to_max"] <= R101_RTOL_TO_MAX:
            raise SystemExit(f"group_norm: ResNet101-C4 ({name}) card vs CPU {r}")
    return {"int8_hat_resample_correlation": int8_counts["int8_hat_resample_correlation"],
            **{k: gn_launches[k] + gn_step["launches"][k] + turn_counts[k]
               for k in ("group_norm_forward", "group_norm_backward")}}


HOST_SCENES = 48  # planted 1280x960 scenes of phase 27 (24 batches of 2)
HOST_CPU_SCENES = 4  # of them, the ones also evaluated on the CPU
HOST_ROUNDS = 4  # rounds of the two loops in turns (phase 27)
# phase 27, card against CPU: the hit on each planted patch (readings of the
# chip runs: scores within 1.2e-7, boxes equal)
HOST_SCORE_ATOL, HOST_BOX_ATOL = 1e-4, 1.0
CHUNK_CLASSES, CHUNK_SIZE, CHUNK_ROUNDS = 256, 32, 2  # phase 28
VIZ_ATOL = 1e-4  # phase 29: score, IoU and loss maps, card against CPU
VIZ_GRAD_RTOL, VIZ_GRAD_ATOL = 1e-4, 1e-6  # phase 29: the loss gradients


def write_host_dataset(root):
    """HOST_SCENES noise scenes of IMG_W x IMG_H, each with the two class
    patches of planted_scenes() at anchor-aligned positions (x0 = 16k - 112),
    as JPEG files and a CSV-schema dataframe."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    _, patches = planted_scenes()
    rng = np.random.RandomState(2)
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    for cid, patch in enumerate(patches):
        Image.fromarray(patch).save(os.path.join(root, "classes", "images", f"class{cid}.jpg"),
                                    quality=95)
    rows = []
    for image_id in range(HOST_SCENES):
        scene = rng.randint(0, 60, (IMG_H, IMG_W, 3), np.uint8)
        k = image_id % 8
        for cid, (x0, y0) in enumerate(((48 + 64 * k, 112), (688, 432 + 32 * k))):
            scene[y0:y0 + PATCH, x0:x0 + PATCH] = patches[cid]
            rows.append(dict(imageid=image_id, imagefilename=f"img{image_id}.jpg", classid=cid,
                             classfilename=f"class{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=x0 / IMG_W, ty=y0 / IMG_H, rx=(x0 + PATCH) / IMG_W,
                             by=(y0 + PATCH) / IMG_H))
        Image.fromarray(scene).save(os.path.join(root, "src", f"img{image_id}.jpg"), quality=95)
    return pd.DataFrame(rows)


def planted_hits_agree(got, want, score_atol=HOST_SCORE_ATOL, box_atol=HOST_BOX_ATOL):
    """Two detection files of evaluate() (per image: boxes, scores, labels
    and the GT): for every GT box, the best-scoring detection of its class
    that overlaps it (IoU > 0.5) in each, within score_atol and box_atol px
    of each other. Away from the planted patches random weights score
    neighbouring anchors within ~1e-5, so which of them NMS keeps follows
    the last bits and is not compared. Returns (agree, the largest score and
    box differences of the hits)."""
    import numpy as np

    def iou(boxes, box):
        lt = np.maximum(boxes[:, :2], box[:2])
        rb = np.minimum(boxes[:, 2:], box[2:])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
        return inter / (area(boxes) + area(box) - inter)

    def hit(dets, i, gt_box, label):
        same = dets["labels"][i] == label
        boxes, scores = dets["boxes_xyxy"][i][same], dets["scores"][i][same]
        on = iou(boxes, gt_box) > 0.5 if len(boxes) else np.zeros(0, bool)
        if not on.any():
            return None
        k = int(np.argmax(np.where(on, scores, -np.inf)))
        return scores[k], boxes[k]

    worst = [0.0, 0.0]
    for i, (gt_boxes, gt_labels) in enumerate(zip(want["gt_boxes_xyxy"], want["gt_labels"])):
        for gt_box, label in zip(gt_boxes, gt_labels):
            a, b = hit(got, i, gt_box, label), hit(want, i, gt_box, label)
            if a is None or b is None:
                return False, [float("inf")] * 2
            worst = [max(worst[0], abs(float(a[0] - b[0]))),
                     max(worst[1], float(np.abs(a[1] - b[1]).max()))]
    return worst[0] <= score_atol and worst[1] <= box_atol, worst


class FigureRecorder:
    """Stands in for os2d_torch.utils.visualization while installed (a
    module of the same name in sys.modules, which the engine imports when it
    draws): keeps each call's arrays by (function, file name) and, with
    `draw`, writes the first figure of each function, with the real module
    where matplotlib is installed and else as an .npz of the figure's
    arrays beside the figure's name."""

    NAME = "os2d_torch.utils.visualization"
    FUNCTIONS = ("show_detections", "show_gt_boxes", "show_class_heatmap",
                 "show_target_remapping")

    def __init__(self, draw):
        import importlib.util

        self.draw, self.calls = draw, {}
        self.matplotlib = importlib.util.find_spec("matplotlib") is not None

    def __enter__(self):
        import importlib

        self.real = importlib.import_module(self.NAME) if self.matplotlib else None
        self.saved = sys.modules.get(self.NAME)
        stub = types.ModuleType(self.NAME)
        for name in self.FUNCTIONS:
            setattr(stub, name, self._recorder(name))
        sys.modules[self.NAME] = stub
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            del sys.modules[self.NAME]
        else:
            sys.modules[self.NAME] = self.saved

    def _recorder(self, name):
        import numpy as np

        def record(*args, **kwargs):
            path = kwargs["save_path"]
            first = not any(n == name for n, _ in self.calls)
            self.calls[(name, os.path.basename(path))] = (list(args), dict(kwargs))
            if self.draw and first:
                if self.real is not None:
                    return getattr(self.real, name)(*args, **kwargs)
                arrays = {f"arg{i}": np.asarray(a) for i, a in enumerate(args)
                          if not isinstance(a, list)}
                arrays.update({k: np.asarray(v) for k, v in kwargs.items()
                               if v is not None and k != "save_path"})
                np.savez(path + ".npz", **arrays)
            return path
        return record


def host_side(counts, ctx):
    """Phases 27 (eval_prefetch), 28 (class_chunks) and 29 (visualization):
    evaluate()'s producer thread against its serial loop, per-level class
    chunks against uniform ones at the bench protocol, and the figures of
    the visualisation flags, card against CPU. `counts` and `ctx` as for
    model_options (ctx also holds the planted train set and its recipe).
    Returns {kernel: launches} of the three phases' counted runs."""
    import pickle

    import numpy as np
    import torch

    from os2d_torch.data.dataloader import (
        DataloaderOneShotDetection,
        build_train_dataloader_from_config,
    )
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.engine import evaluate as evaluate_module
    from os2d_torch.engine.evaluate import Evaluator, evaluate, level_class_chunks
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import trainable_parameters, trainval_loop
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops.cuda import BUILD_DIR
    from os2d_torch.utils.profiling import StageTimer
    from os2d_torch.utils.upload import uploader_for
    from tools.bench_classes_torch import chunk_modes_in_turns, synthetic_bank, timed_detect

    dev = ctx.model.device
    total = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def require_some(phase, launches):
        if not (launches["hat_resample_correlation"] or launches["resample_correlation"]):
            raise SystemExit(f"{phase}: neither the hat nor the gather kernel launched")

    def cpu_twin():
        m = Os2dModel(Os2dConfig(), device="cpu")
        m.load_state_dict({k: v.cpu() for k, v in ctx.base_state.items()})
        return m

    # ---- 27. eval_prefetch: the producer thread against the serial loop ----
    t_phase = time.perf_counter()
    cfg = ctx.eval_cfg.clone()
    cfg.eval.class_image_augmentation = ""
    cfg.eval.batch_size = 2
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_host_dataset(root)

        def host_loader(frame, name):
            dataset = DatasetOneShotDetection(
                frame, gt_path=os.path.join(root, "classes", "images"),
                image_path=os.path.join(root, "src"), name=name, image_size=IMG_W,
                eval_scale=IMG_W, cache_images=True)
            return DataloaderOneShotDetection(dataset, batch_size=2,
                                              pyramid_scales_eval=EVAL_PYRAMID)

        loader = host_loader(df, "planted-host")
        small = host_loader(df[df.imageid < HOST_CPU_SCENES], "planted-host-small")

        def run(model, depth, tag, on=loader):
            run_cfg = cfg.clone()
            run_cfg.tpu.eval_prefetch_depth = depth
            run_cfg.visualization.eval.path_to_save_detections = os.path.join(root, tag)
            t0 = time.perf_counter()
            res = evaluate(on, model, run_cfg)
            sync()
            wall = time.perf_counter() - t0
            with open(os.path.join(root, tag, f"{on.dataset.name}_detections.pkl"), "rb") as f:
                dets = pickle.load(f)
            return res, dets, wall

        evaluate(loader, ctx.model, cfg)  # warm-up; reads the files into the cache
        sync()
        counts.reset()
        walls = {"prefetch_depth1": [], "serial": []}
        outs = {}
        for i_round in range(HOST_ROUNDS):
            order = [("prefetch_depth1", 1), ("serial", 0)]
            for name, depth in (order if i_round % 2 == 0 else order[::-1]):
                res, dets, wall = run(ctx.model, depth, f"{name}{i_round}")
                walls[name].append(wall)
                outs[name] = (res, dets)
        prefetch_launches = counts.read()
        small_res, small_dets, _ = run(ctx.model, 1, "small", on=small)
        cpu_res, cpu_dets, cpu_wall = run(cpu_twin(), 1, "cpu", on=small)

        # the host work that the producer moves off the loop, and the
        # dispatches, timed stage by stage in a serial loop
        timer = StageTimer()
        ev = Evaluator(ctx.model, cfg)
        class_images, _, _ = loader.get_all_class_images()
        head, _ = ev.build_class_heads(class_images)
        uploader = uploader_for(ctx.model.device)
        items = loader.make_raw_iterator_for_all_images(2)
        n_batches = 0
        while True:
            with timer.stage("host_prep"):
                item = next(items, None)
                if item is None:
                    break
                stacked = np.stack(item[1] + [item[1][-1]] * (2 - len(item[1])))
            with timer.stage("upload"):
                images = uploader.upload(stacked)
            with timer.stage("dispatch"):
                evaluate_module.unpack_detections(
                    ev.detect_images(images, head, item[2], item[3][0], loader.img_normalization))
            n_batches += 1
    stages = {k: v["total_s"] / max(n_batches, 1) * 1e3 for k, v in timer.summary().items()}
    # round by round, the serial wall less the prefetched one
    hidden = [s_ - p for s_, p in zip(walls["serial"], walls["prefetch_depth1"])]
    prefetched, serial = outs["prefetch_depth1"], outs["serial"]
    same_loops = all(np.array_equal(a, b) for key in ("boxes_xyxy", "scores", "labels")
                     for a, b in zip(prefetched[1][key], serial[1][key]))
    cpu_agree, cpu_diff = planted_hits_agree(small_dets, cpu_dets)
    emit({"phase": "eval_prefetch", "images": f"{HOST_SCENES}x{IMG_W}x{IMG_H} files",
          "batch": 2, "batches": n_batches, "levels": EVAL_PYRAMID, "rounds": HOST_ROUNDS,
          "order": "prefetch, serial, serial, prefetch, ...",
          "wall_s": walls,
          "median_wall_s": {k: float(np.median(v)) for k, v in walls.items()},
          "hidden_s_per_round": hidden, "median_hidden_s": float(np.median(hidden)),
          "median_hidden_ms_per_batch": float(np.median(hidden)) / n_batches * 1e3,
          "serial_stage_ms_per_batch": stages,
          "mAP@0.50": prefetched[0]["mAP@0.50"], "serial_mAP@0.50": serial[0]["mAP@0.50"],
          "cpu_images": HOST_CPU_SCENES, "card_small_mAP@0.50": small_res["mAP@0.50"],
          "cpu_mAP@0.50": cpu_res["mAP@0.50"], "cpu_wall_s": cpu_wall,
          "loops_bit_equal": same_loops, "card_matches_cpu": cpu_agree,
          "card_cpu_hits_max_score_and_box_diff": cpu_diff,
          "score_atol": HOST_SCORE_ATOL, "box_atol_px": HOST_BOX_ATOL,
          "card_cpu_detections": [[len(a), len(b)] for a, b in zip(small_dets["scores"],
                                                                    cpu_dets["scores"])],
          "launches": prefetch_launches, "seconds": time.perf_counter() - t_phase})
    maps = (prefetched[0]["mAP@0.50"], serial[0]["mAP@0.50"], small_res["mAP@0.50"],
            cpu_res["mAP@0.50"])
    if not all(m == 1.0 for m in maps):
        raise SystemExit(f"eval_prefetch: mAP@0.50 is not 1.0 in every loop and on the CPU: {maps}")
    if not same_loops:
        raise SystemExit("eval_prefetch: the producer's detections differ from the serial loop's")
    counts_equal = all(len(a) == len(b) for a, b in zip(small_dets["scores"],
                                                          cpu_dets["scores"]))
    if not (cpu_agree and counts_equal):
        raise SystemExit("eval_prefetch: the card's detections differ from the CPU's")
    require_some("eval_prefetch", prefetch_launches)
    add(prefetch_launches)

    # ---- 28. class_chunks: per-level against uniform chunks at 256 classes ----
    t_phase = time.perf_counter()
    chunk_cfg = ctx.cfg.clone()
    chunk_cfg.tpu.eval_class_chunk = CHUNK_SIZE
    image = torch.as_tensor(ctx.batches[0][0], device=dev)
    bank = synthetic_bank(ctx.model, CHUNK_CLASSES)
    stats, outs = chunk_modes_in_turns(ctx.model, chunk_cfg, bank, image, CHUNK_ROUNDS)
    chunk_launches = {}
    for per_level in (False, True):
        mode_cfg = chunk_cfg.clone()
        mode_cfg.tpu.eval_class_chunk_per_level = per_level
        counts.reset()
        timed_detect(Evaluator(ctx.model, mode_cfg), image, bank)
        chunk_launches["per_level" if per_level else "uniform"] = counts.read()
    highest = Os2dModel(Os2dConfig(resample_precision="highest"), device=dev)
    highest.load_state_dict(ctx.base_state)
    counts.reset()
    highest_s, highest_out = timed_detect(Evaluator(highest, chunk_cfg), image, bank)
    chunk_launches["highest_per_level"] = counts.read()
    del highest
    level_chunks = level_class_chunks(ctx.sizes, CHUNK_SIZE, CHUNK_CLASSES)
    want = {"uniform": len(ctx.sizes) * -(-CHUNK_CLASSES // CHUNK_SIZE),
            "per_level": sum(-(-CHUNK_CLASSES // c) for c in level_chunks)}
    equal = bool(torch.equal(outs["per_level"], outs["uniform"]))
    emit({"phase": "class_chunks", "classes": CHUNK_CLASSES, "chunk": CHUNK_SIZE,
          "images": f"1x{IMG_W}x{IMG_H}", "levels": len(ctx.sizes),
          "level_chunks": level_chunks, "rounds": CHUNK_ROUNDS,
          "order": "uniform, per_level, per_level, uniform, ...",
          "s_per_image": {k: v["times"] for k, v in stats.items()},
          "median_s_per_image": {k: float(np.median(v["times"])) for k, v in stats.items()},
          "peak_mib": {k: v["peak_mib"] for k, v in stats.items()},
          "outputs_equal": equal, "launches": chunk_launches,
          "expected_hat_launches": want, "highest_s": highest_s,
          "seconds": time.perf_counter() - t_phase})
    if not equal:
        raise SystemExit("class_chunks: per-level chunks' detections are not torch.equal to "
                         "uniform chunks'")
    d = evaluate_module.unpack_detections(highest_out)
    if not (np.isfinite(d["scores"][d["valid"]]).all() and d["valid"].any()):
        raise SystemExit("class_chunks: no or non-finite detections at 'highest'")
    for mode, n in want.items():
        counts.require("class_chunks", chunk_launches[mode], "hat_resample_correlation", n)
    counts.require("class_chunks", chunk_launches["highest_per_level"], "resample_correlation",
                   want["per_level"])
    for launches in chunk_launches.values():
        add(launches)
    del bank, outs

    # ---- 29. visualization: the eval and train flags, card against CPU ----
    t_phase = time.perf_counter()
    records = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        eval_loader = planted_eval_loader(os.path.join(root, "data"))
        viz_launches = {}
        for on in (dev.type, "cpu"):
            model = ctx.model if on == dev.type else cpu_twin()
            viz_cfg = cfg.clone()
            viz_cfg.eval.batch_size = 1
            viz_cfg.output.path = os.path.join(root, on)
            flags = viz_cfg.visualization.eval
            flags.show_detections = flags.show_gt_boxes = flags.show_class_heatmaps = True
            train_cfg = ctx.train_cfg.clone()
            train_cfg.train.optim.max_iter = 0
            train_cfg.output.path = os.path.join(root, on)
            train_cfg.visualization.train.show_gt_boxes_dataloader = True
            train_cfg.visualization.train.show_target_remapping = True
            train_model = Os2dModel(Os2dConfig(), device=model.device)
            train_model.load_state_dict({k: v.to(model.device)
                                         for k, v in ctx.base_state.items()})
            train_loader, _ = build_train_dataloader_from_config(train_cfg, ctx.train_set,
                                                                 seed=0)
            with FigureRecorder(draw=on == dev.type) as rec:
                if on == dev.type:
                    counts.reset()
                res = evaluate(eval_loader, model, viz_cfg)
                trainval_loop(train_loader, train_model, train_cfg, ctx.first_objective,
                              create_optimizer(train_cfg.train.optim,
                                               trainable_parameters(train_model,
                                                                    train_cfg.train)))
                if on == dev.type:
                    sync()
                    viz_launches = counts.read()
            records[on] = (res, rec.calls)
            del train_model
        files = sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, dev.type))
                       for d, _, fs in os.walk(os.path.join(root, dev.type)) for f in fs)
    card_calls, cpu_calls = records[dev.type][1], records["cpu"][1]
    diffs = {}
    for key, (args, kwargs) in card_calls.items():
        c_args, c_kwargs = cpu_calls[key]
        if key[0] == "show_class_heatmap":
            diffs.setdefault("heatmap", []).append(float(np.abs(args[1] - c_args[1]).max()))
        elif key[0] == "show_target_remapping":
            for i, name in ((1, "remap_scores"),):
                diffs.setdefault(name, []).append(float(np.abs(args[i] - c_args[i]).max()))
            diffs.setdefault("remap_targets_differing", []).append(
                int((args[2] != c_args[2]).sum()))
            diffs.setdefault("remap_remapped_differing", []).append(
                int((args[3] != c_args[3]).sum()))
            for name in ("ious_anchor", "ious_corrected", "loss_per_anchor"):
                diffs.setdefault(name, []).append(
                    float(np.abs(kwargs[name] - c_kwargs[name]).max()))
            for name in ("grad_scores", "grad_scores_detached"):
                diff, ref = np.abs(kwargs[name] - c_kwargs[name]), np.abs(c_kwargs[name])
                excess = diff - VIZ_GRAD_RTOL * ref
                diffs.setdefault(name + "_excess_over_rtol", []).append(float(excess.max()))
                diffs.setdefault(name + "_max_abs", []).append(float(diff.max()))
                # relative where rtol rules: |cpu| above atol / rtol
                big = ref > VIZ_GRAD_ATOL / VIZ_GRAD_RTOL
                diffs.setdefault(name + "_max_rel", []).append(
                    float((diff[big] / ref[big]).max()) if big.any() else 0.0)
    worst = {k: max(v) for k, v in diffs.items()}
    n_remap = sum(k[0] == "show_target_remapping" for k in card_calls)
    emit({"phase": "visualization", "figures": sorted(card_calls),
          "files_written": files, "matplotlib": rec.matplotlib, "mAP@0.50": records[dev.type][0]["mAP@0.50"],
          "cpu_mAP@0.50": records["cpu"][0]["mAP@0.50"], "max_diff": worst,
          "atol": VIZ_ATOL, "grad_rtol": VIZ_GRAD_RTOL, "grad_atol": VIZ_GRAD_ATOL,
          "launches": viz_launches, "seconds": time.perf_counter() - t_phase})
    if set(card_calls) != set(cpu_calls):
        raise SystemExit("visualization: the card and the CPU drew different figures")
    kinds = {k[0] for k in card_calls}
    if kinds != set(FigureRecorder.FUNCTIONS) or not n_remap:
        raise SystemExit(f"visualization: figures of {sorted(kinds)} only")
    for name in kinds:  # the first figure of each kind was written
        first = next(k[1] for k in card_calls if k[0] == name)
        if not any(os.path.basename(f) in (first, first + ".npz") for f in files):
            raise SystemExit(f"visualization: {first} was not written")
    for name in ("heatmap", "remap_scores", "ious_anchor", "ious_corrected", "loss_per_anchor"):
        if not worst[name] <= VIZ_ATOL:
            raise SystemExit(f"visualization: {name} differs by {worst[name]} card vs CPU")
    for name in ("grad_scores", "grad_scores_detached"):
        if not worst[name + "_excess_over_rtol"] <= VIZ_GRAD_ATOL:
            raise SystemExit(f"visualization: {name} beyond rtol {VIZ_GRAD_RTOL}, atol "
                             f"{VIZ_GRAD_ATOL}, card vs CPU")
    if worst["remap_targets_differing"]:
        raise SystemExit("visualization: the encoded targets differ card vs CPU")
    require_some("visualization", viz_launches)
    add(viz_launches)
    return total


# phases 30-32, the last modules: the yuv420 upload wire (phase 4's planted
# scenes written at IMG_W by pixel replication, batch 2, WIRE_LEVELS; rgb8 and yuv420 in turns over
# WIRE_ROUNDS rounds; the yuv420 first train step within WIRE_LOSS_RTOL of
# rgb8's, the JAX package's wire gate), the ImageNet pretrainer (the
# trainer's default arch and crop at PRETRAIN_BATCH, a cut of its 256, on a
# synthetic ImageFolder of PRETRAIN_CLASSES x PRETRAIN_PER_CLASS JPEGs, the
# last class excluded; bf16 card against bf16 CPU within PRETRAIN_LOSS_RTOL
# and PRETRAIN_TOP1_ATOL; the export's C4 within PRETRAIN_C4_RTOL_TO_MAX of
# the classifier's trunk) and the checkpoint backend "orbax"
# (torch.distributed.checkpoint)
WIRE_LEVELS = [0.5, 1.0]
WIRE_ROUNDS = 4
WIRE_LOSS_RTOL = 2e-2
PRETRAIN_ARCH, PRETRAIN_SIZE, PRETRAIN_BATCH = "resnet101", 224, 64
PRETRAIN_CLASSES, PRETRAIN_PER_CLASS = 10, 32
PRETRAIN_TIMED_STEPS = 5
PRETRAIN_TRAIN_EPOCHS = 2  # of len(dataset) // PRETRAIN_BATCH steps each
PRETRAIN_LOSS_RTOL, PRETRAIN_TOP1_ATOL = 2e-2, 4 / 64
PRETRAIN_C4_RTOL_TO_MAX = 1e-4


def write_image_folder(root):
    """PRETRAIN_CLASSES class directories of PRETRAIN_PER_CLASS 256x320
    JPEGs (a class colour under seeded noise) and an exclusion file naming
    the last class, as tests/test_pretrain.py's folder."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(4)
    for c in range(PRETRAIN_CLASSES):
        d = os.path.join(root, f"n{c:08d}")
        os.makedirs(d, exist_ok=True)
        colour = rng.randint(0, 256, 3)
        for i in range(PRETRAIN_PER_CLASS):
            img = np.clip(colour + rng.randint(-60, 61, (256, 320, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"img{i}.JPEG"), quality=90)
    exclude = os.path.join(root, "exclude.txt")
    with open(exclude, "w") as f:
        f.write(f"n{PRETRAIN_CLASSES - 1:08d}\n")
    return exclude


def last_modules(counts, ctx):
    """Phases 30 (yuv_wire), 31 (pretrain) and 32 (checkpoint_backend).
    `counts` as for model_options; ctx holds the main model and its state,
    phase 4's eval config, phase 9's train recipe, batch and objective, and
    phase 10's trained model and optimizer. Returns {kernel: launches} of
    the counted runs of phase 30."""
    import pickle
    import random

    import numpy as np
    import torch

    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.engine.evaluate import Evaluator, evaluate, unpack_detections
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.engine.train import TrainStep, prepare_batch_arrays, trainable_parameters
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models.checkpoint import load_checkpoint_file
    from os2d_torch.ops.cuda import BUILD_DIR
    from os2d_torch.ops.pixel_format import (
        PackedYuv420,
        decode_wire_to_u8,
        rgb_to_yuv420,
        yuv420_to_rgb_f32,
    )
    from os2d_torch.pretrain import train_imagenet as pretrain
    from os2d_torch.utils.logger import checkpoint_model, load_checkpoint
    from os2d_torch.utils.profiling import StageTimer
    from os2d_torch.utils.upload import uploader_for

    dev = ctx.model.device
    total = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def same(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and torch.equal(a.cpu(), b.cpu()))

    def cpu_twin(state, config=Os2dConfig()):
        m = Os2dModel(config, device="cpu")
        m.load_state_dict({k: v.cpu() for k, v in state.items()})
        return m

    # ---- 30. yuv_wire: evaluate() and a train step through the 4:2:0 wire ----
    t_phase = time.perf_counter()
    cfg = ctx.eval_cfg.clone()
    cfg.eval.class_image_augmentation = ""
    cfg.eval.batch_size = 2
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        # phase 4's scenes written at IMG_W x IMG_H, each pixel replicated
        # 2x2: the patches are 480 px, and 240 px on the anchor grid at the
        # pyramid's 0.5 level. (Phase 4's 640x480 files resized to IMG_W
        # on reading blur the patches, and the planted hits are lost.)
        dataset = DatasetOneShotDetection(
            write_planted_dataset(root, IMG_W // 640), gt_path=os.path.join(root, "classes",
                                                                            "images"),
            image_path=os.path.join(root, "src"), name="planted-wire", image_size=IMG_W,
            eval_scale=IMG_W, cache_images=True)
        loader = DataloaderOneShotDetection(dataset, batch_size=2,
                                            pyramid_scales_eval=WIRE_LEVELS)

        def run(model, fmt, tag):
            run_cfg = cfg.clone()
            run_cfg.tpu.upload_pixel_format = fmt
            run_cfg.visualization.eval.path_to_save_detections = os.path.join(root, tag)
            t0 = time.perf_counter()
            res = evaluate(loader, model, run_cfg)
            sync()
            wall = time.perf_counter() - t0
            with open(os.path.join(root, tag, "planted-wire_detections.pkl"), "rb") as f:
                return res, pickle.load(f), wall

        for fmt in ("rgb8", "yuv420"):  # warm-up; reads the files into the cache
            run(ctx.model, fmt, f"warm_{fmt}")
        counts.reset()
        walls, outs = {"rgb8": [], "yuv420": []}, {}
        for i_round in range(WIRE_ROUNDS):
            order = ["rgb8", "yuv420"] if i_round % 2 == 0 else ["yuv420", "rgb8"]
            for fmt in order:
                res, dets, wall = run(ctx.model, fmt, f"{fmt}{i_round}")
                walls[fmt].append(wall)
                outs[fmt] = (res, dets)
        wire_launches = counts.read()
        cpu_res, cpu_dets, cpu_wall = run(cpu_twin(ctx.base_state), "yuv420", "cpu")

        # the decode of this batch's wire, the card against the CPU
        item = next(loader.make_raw_iterator_for_all_images(2))
        stacked = np.stack(item[1])
        packed = rgb_to_yuv420(stacked)
        flat_cpu = torch.from_numpy(packed.data)
        flat_card = flat_cpu.to(dev)
        float_diff = float((yuv420_to_rgb_f32(flat_card, packed.shape).cpu()
                            - yuv420_to_rgb_f32(flat_cpu, packed.shape)).abs().max())
        u8_equal = bool(torch.equal(
            decode_wire_to_u8(PackedYuv420(flat_card, packed.shape)).cpu(),
            decode_wire_to_u8(PackedYuv420(flat_cpu, packed.shape))))

        # bytes and milliseconds of the two wires per batch, in turns: the
        # host encode, the upload (pinned staging, copy stream) and the
        # dispatch that decodes the wire; each stage ends synchronized
        ev = Evaluator(ctx.model, cfg)
        class_images, _, _ = loader.get_all_class_images()
        head, _ = ev.build_class_heads(class_images)
        uploader = uploader_for(dev)
        timer = StageTimer()
        wire_bytes = {}
        for i_round in range(WIRE_ROUNDS + 1):
            order = ["rgb8", "yuv420"] if i_round % 2 == 0 else ["yuv420", "rgb8"]
            for fmt in order:
                tag = fmt if i_round else "warm"  # round 0 warms up
                with timer.stage(f"{tag}_encode"):
                    wire = rgb_to_yuv420(stacked).data if fmt == "yuv420" else stacked
                with timer.stage(f"{tag}_upload"):
                    up = uploader.upload(wire)
                with timer.stage(f"{tag}_dispatch"):
                    images = PackedYuv420(up, stacked.shape) if fmt == "yuv420" else up
                    unpack_detections(ev.detect_images(images, head, item[2], item[3][0],
                                                       loader.img_normalization))
                wire_bytes[fmt] = int(wire.nbytes)
    stage_ms = {k: v["total_s"] / v["count"] * 1e3 for k, v in timer.summary().items()
                if not k.startswith("warm")}
    n_pixels = stacked.shape[0] * stacked.shape[1] * stacked.shape[2]
    cpu_agree, cpu_diff = planted_hits_agree(outs["yuv420"][1], cpu_dets)
    same_hits, wire_diff = planted_hits_agree(outs["yuv420"][1], outs["rgb8"][1],
                                              score_atol=float("inf"), box_atol=float("inf"))
    maps = {fmt: outs[fmt][0]["mAP@0.50"] for fmt in outs}

    # one train step at the default recipe (phase 9's batch, weights and
    # margin) through each wire on the card, and through yuv420 on the CPU
    train_start = Os2dModel(Os2dConfig(), device=dev, seed=1).state_dict()
    first = {}
    step_launches = {}
    for name, fmt, device in (("rgb8", "rgb8", dev), ("yuv420", "yuv420", dev),
                              ("cpu_yuv420", "yuv420", torch.device("cpu"))):
        m = Os2dModel(Os2dConfig(), device=device)
        m.load_state_dict({k: v.to(device) for k, v in train_start.items()})
        opt = create_optimizer(ctx.train_cfg.train.optim,
                               trainable_parameters(m, ctx.train_cfg.train))
        step = TrainStep(m, ctx.first_objective, opt, ctx.train_cfg.train)
        arrays, c_pad = prepare_batch_arrays(ctx.train_batch, device, pixel_format=fmt)
        if name == "yuv420":
            if not isinstance(arrays["images"], PackedYuv420):
                raise SystemExit("yuv_wire: prepare_batch_arrays did not upload the wire")
            counts.reset()
        first[name] = step(arrays, c_pad)
        if name == "yuv420":
            sync()
            step_launches = counts.read()
        del m, opt, step, arrays
    wire_loss_err = abs(first["yuv420"]["loss"] - first["rgb8"]["loss"]) / first["rgb8"]["loss"]
    step_err = {k: abs(first["yuv420"][k] - first["cpu_yuv420"][k])
                / max(abs(first["cpu_yuv420"][k]), 1e-12) for k in ("loss", "grad_norm")}
    emit({"phase": "yuv_wire", "images": f"2x{IMG_W}x{IMG_H} (phase 4's scenes, 2x2 pixels)",
          "levels": WIRE_LEVELS, "rounds": WIRE_ROUNDS,
          "order": "rgb8, yuv420, yuv420, rgb8, ...", "wall_s": walls,
          "median_wall_s": {k: float(np.median(v)) for k, v in walls.items()},
          "mAP@0.50": maps, "cpu_yuv420_mAP@0.50": cpu_res["mAP@0.50"], "cpu_wall_s": cpu_wall,
          "card_matches_cpu": cpu_agree, "card_cpu_hits_max_score_and_box_diff": cpu_diff,
          "yuv420_against_rgb8_hits_max_score_and_box_diff": wire_diff,
          "decode_card_cpu_max_abs_float": float_diff, "decode_card_cpu_u8_equal": u8_equal,
          "bytes_per_batch": wire_bytes,
          "bytes_per_pixel": {k: v / n_pixels for k, v in wire_bytes.items()},
          "stage_ms_per_batch": stage_ms, "launches": wire_launches,
          "train_first_step": first, "train_yuv420_against_rgb8_loss_rel": wire_loss_err,
          "train_card_cpu_rel": step_err, "train_launches": step_launches,
          "seconds": time.perf_counter() - t_phase})
    if not (maps["rgb8"] == maps["yuv420"] == cpu_res["mAP@0.50"] == 1.0 and same_hits):
        raise SystemExit(f"yuv_wire: planted patches not found under both wires and on the "
                         f"CPU: {maps}, cpu {cpu_res['mAP@0.50']}")
    if not cpu_agree:
        raise SystemExit(f"yuv_wire: the card's yuv420 hits differ from the CPU's {cpu_diff}")
    if not (float_diff <= 1e-4 and u8_equal):
        raise SystemExit(f"yuv_wire: the card's decode differs from the CPU's ({float_diff}, "
                         f"uint8 equal {u8_equal})")
    if wire_bytes["yuv420"] * 2 != wire_bytes["rgb8"]:
        raise SystemExit(f"yuv_wire: {wire_bytes} bytes per batch, not 1.5 against 3 B/px")
    if not wire_loss_err <= WIRE_LOSS_RTOL:
        raise SystemExit(f"yuv_wire: the yuv420 first loss is {wire_loss_err} from rgb8's")
    if not all(e <= TRAIN_CPU_RTOL for e in step_err.values()):
        raise SystemExit(f"yuv_wire: the yuv420 step on the card against the CPU {step_err}")
    if not wire_launches["hat_resample_correlation"]:
        raise SystemExit("yuv_wire: evaluate() launched no hat kernel")
    for kernel in ("hat_resample_correlation", "resample_correlation_backward"):
        if step_launches[kernel] != 1:
            raise SystemExit(f"yuv_wire: the train step launched {kernel} "
                             f"{step_launches[kernel]} times, expected 1")
    add(wire_launches)
    add(step_launches)

    # ---- 31. pretrain: the ImageNet trainer's step at its default arch ----
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        exclude = write_image_folder(os.path.join(root, "train"))
        with open(exclude) as f:
            excluded = {line.strip() for line in f if line.strip()}
        dataset = pretrain.ImageFolderDataset(os.path.join(root, "train"), excluded)
        steps_per_epoch = len(dataset) // PRETRAIN_BATCH
        batches = pretrain.batch_iterator(dataset, PRETRAIN_BATCH, PRETRAIN_SIZE, seed=0,
                                          rng=random.Random(1))
        load_s = []

        def next_batch():
            t0 = time.perf_counter()
            images, labels = next(batches)
            load_s.append(time.perf_counter() - t0)
            return torch.from_numpy(images), torch.from_numpy(labels)

        def trainer(device, state=None):
            m = pretrain.init_classifier(PRETRAIN_ARCH, dataset.num_classes, device, seed=0)
            if state is not None:
                m.load_state_dict(state)
            chain = pretrain.ChainSGD(m.parameters(), pretrain.piecewise_constant_schedule(
                0.1, {steps_per_epoch * 30: 0.1, steps_per_epoch * 60: 0.1}))
            return m, pretrain.make_train_step(m, chain)  # bf16, the trainer's default

        images, labels = next_batch()
        card_model, card_step = trainer(dev)
        start = {k: v.detach().cpu().clone() for k, v in card_model.state_dict().items()}
        t0 = time.perf_counter()
        card_first = {k: float(v) for k, v in card_step(images.to(dev), labels.to(dev)).items()}
        first_s = time.perf_counter() - t0
        cpu_model, cpu_step = trainer("cpu", start)
        t0 = time.perf_counter()
        cpu_first = {k: float(v) for k, v in cpu_step(images, labels).items()}
        cpu_first_s = time.perf_counter() - t0
        del cpu_model, cpu_step

        # the export after the first step, through the checkpoint cascade
        export_path = os.path.join(root, "backbone_torchvision.pkl")
        with open(export_path, "wb") as f:
            pickle.dump(pretrain.export_torchvision_state_dict(card_model), f)
        det_config = Os2dConfig(backbone_arch=PRETRAIN_ARCH)
        detector = Os2dModel(det_config, device=dev)
        state, _ = load_checkpoint_file(export_path, det_config, detector)
        detector.load_state_dict(state)
        x = torch.randn(1, 320, 320, 3, generator=torch.Generator().manual_seed(2)).to(dev)
        with torch.no_grad():
            c4 = detector.extract_features(x)
            trunk = card_model.stem(x.permute(0, 3, 1, 2))
            for block in card_model.blocks():
                trunk = block(trunk)
            trunk = trunk.permute(0, 2, 3, 1)
        c4_rel = float((c4 - trunk).abs().max() / trunk.abs().max())
        del detector, state

        step_s, losses = [], []
        for i in range(PRETRAIN_TIMED_STEPS + 1):  # the first one warms up
            images, labels = next_batch()
            sync()
            t0 = time.perf_counter()
            metrics = card_step(images.to(dev), labels.to(dev))
            losses.append(float(metrics["loss"]))
            sync()
            if i:
                step_s.append(time.perf_counter() - t0)
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
        if ctx.profile:
            profile_run("profile_pretrain", lambda: card_step(images.to(dev), labels.to(dev)),
                        float(np.median(step_s)))

        # train() end to end, as a user calls it: its model's init, then the
        # host's crops, the uploads and the steps of PRETRAIN_TRAIN_EPOCHS
        # epochs (no export)
        train_steps = PRETRAIN_TRAIN_EPOCHS * steps_per_epoch
        t0 = time.perf_counter()
        trained = pretrain.train(os.path.join(root, "train"), exclude, PRETRAIN_ARCH,
                                 PRETRAIN_BATCH, PRETRAIN_TRAIN_EPOCHS, output_path=None,
                                 log_every=train_steps, device=dev)
        sync()
        train_wall = time.perf_counter() - t0
        trained_finite = all(bool(torch.isfinite(p).all()) for p in trained.parameters())
        del trained
    emit({"phase": "pretrain", "arch": PRETRAIN_ARCH, "image_size": PRETRAIN_SIZE,
          "batch": PRETRAIN_BATCH, "reduced": {"batch": "256 -> 64"},
          "classes": dataset.num_classes, "images": len(dataset), "compute_dtype": "bfloat16",
          "first_step": card_first, "cpu_first_step": cpu_first, "first_step_s": first_s,
          "cpu_first_step_s": cpu_first_s, "timed_steps": PRETRAIN_TIMED_STEPS,
          "step_s": step_s, "median_step_s": float(np.median(step_s)),
          "images_per_s": PRETRAIN_BATCH / float(np.median(step_s)),
          "median_batch_load_s": float(np.median(load_s)), "losses": losses,
          "train_steps": train_steps, "train_wall_s": train_wall,
          "train_images_per_s": train_steps * PRETRAIN_BATCH / train_wall,
          "export_c4_rel_to_max": c4_rel, "peak_mb": peak_mb,
          "seconds": time.perf_counter() - t_phase})
    loss_err = abs(card_first["loss"] - cpu_first["loss"]) / cpu_first["loss"]
    if not (np.isfinite(card_first["loss"]) and loss_err <= PRETRAIN_LOSS_RTOL):
        raise SystemExit(f"pretrain: first loss {card_first['loss']} on the card, "
                         f"{cpu_first['loss']} on the CPU")
    if not abs(card_first["top1"] - cpu_first["top1"]) <= PRETRAIN_TOP1_ATOL:
        raise SystemExit(f"pretrain: first top-1 {card_first['top1']} on the card, "
                         f"{cpu_first['top1']} on the CPU")
    if not c4_rel <= PRETRAIN_C4_RTOL_TO_MAX:
        raise SystemExit(f"pretrain: the exported backbone's C4 is {c4_rel} from the trunk's")
    if not trained_finite:
        raise SystemExit("pretrain: train() left weights that are not finite")
    del card_model, card_step

    # ---- 32. checkpoint_backend: phase 10's trained model and optimizer via DCP ----
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        times = {}
        paths = {}
        for backend in ("pickle", "orbax"):
            t0 = time.perf_counter()
            paths[backend] = checkpoint_model(ctx.train_model, ctx.train_opt, root,
                                              model_name=backend, backend=backend)
            times[f"{backend}_save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            payload = load_checkpoint(paths[backend])
            times[f"{backend}_load_s"] = time.perf_counter() - t0
        dcp_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                     os.walk(os.path.join(root, "checkpoint_orbax.dcp")) for f in fs) / 2**20
        want_net = ctx.train_model.state_dict()
        want_opt = ctx.train_opt.state_dict()
        net_equal = set(payload["net"]) == set(want_net) and all(
            torch.equal(payload["net"][k], want_net[k].cpu()) for k in want_net)
        opt_equal = payload["optimizer"]["param_groups"] == want_opt["param_groups"] and all(
            same(payload["optimizer"]["state"][i][k], v)
            for i, s in want_opt["state"].items() for k, v in s.items())
        loaded = Os2dModel(Os2dConfig(), device=dev, seed=3)
        sd, opt_state = load_checkpoint_file(paths["orbax"], Os2dConfig(), loaded)
        loaded.load_state_dict(sd)
        cascade_equal = all(torch.equal(v, want_net[k]) for k, v in loaded.state_dict().items())
        restored = create_optimizer(ctx.train_cfg.train.optim,
                                    trainable_parameters(loaded, ctx.train_cfg.train))
        restored.load_state_dict(opt_state)
        restored_equal = all(same(restored.state_dict()["state"][i][k], v)
                             for i, s in want_opt["state"].items() for k, v in s.items())
        stub_keys = sorted(torch.load(paths["orbax"], weights_only=True))
    emit({"phase": "checkpoint_backend", "backend": "orbax (torch.distributed.checkpoint)",
          "tensors": len(want_net), "optimizer_states": len(want_opt["state"]),
          "dcp_mb": dcp_mb, "stub_keys": stub_keys, **times, "net_bit_equal": net_equal,
          "optimizer_bit_equal": opt_equal, "cascade_bit_equal": cascade_equal,
          "restored_optimizer_bit_equal": restored_equal,
          "seconds": time.perf_counter() - t_phase})
    if not (net_equal and opt_equal and cascade_equal and restored_equal):
        raise SystemExit("checkpoint_backend: the DCP round trip is not bit-equal")
    return total


# phases 33-34, the entry surfaces: a planted tree in the GroZi layout
# (grozi/src/3264/*.jpg, classes/grozi.csv, classes/images), its scenes at
# GroZi's source size (so the dataset reads them as they are) and read at the
# published 1280-px scale, where a source pixel is 1280/3264 of a level-1.0
# pixel: class patches of GROZI_BLOCKS x GROZI_BLOCKS colour blocks of
# GROZI_SOURCE_BLOCK px (GROZI_LEVEL_BLOCK px at level 1.0, 240 px a patch,
# the class image size), the class images the same patches, planted at
# level-1.0 positions on multiples of 80 px (the anchors' 16-px grid, whole
# source pixels) as (x0, y0, class) per image; split val-new-cl for the eval
# jobs and train for the training job
GROZI_SOURCE = (3264, 2448)
GROZI_BLOCKS, GROZI_LEVEL_BLOCK, GROZI_SOURCE_BLOCK = 12, 20, 51
GROZI_PLANTED = {
    0: ("val-new-cl", [(80, 80, 0), (720, 400, 1)]),
    1: ("val-new-cl", [(400, 160, 2), (880, 560, 3)]),
    2: ("train", [(80, 80, 0), (720, 400, 1)]),
    3: ("train", [(400, 160, 2), (880, 560, 3)]),
    4: ("train", [(160, 400, 1), (800, 80, 3)]),
    5: ("train", [(560, 480, 0), (80, 640, 2)]),
}
EXPERIMENT_TRAIN_STEPS = 3  # the training job's cut: train.optim.max_iter
EXPERIMENT_MIN_MAP = 0.9


def write_grozi_planted_tree(data_path):
    """GROZI_PLANTED written under data_path in the GroZi layout that
    os2d_torch.data.dataset.build_grozi_dataset reads."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    rng = np.random.RandomState(33)
    root = os.path.join(data_path, "grozi")
    os.makedirs(os.path.join(root, "src", str(GROZI_SOURCE[0])), exist_ok=True)
    os.makedirs(os.path.join(root, "classes", "images"), exist_ok=True)
    classes = sorted({cid for _, plants in GROZI_PLANTED.values() for _, _, cid in plants})
    patches = {}
    for cid in classes:
        blocks = rng.randint(0, 255, (GROZI_BLOCKS, GROZI_BLOCKS, 3), np.uint8)
        patches[cid] = np.kron(blocks, np.ones((GROZI_SOURCE_BLOCK, GROZI_SOURCE_BLOCK, 1),
                                               np.uint8))
        Image.fromarray(patches[cid]).save(
            os.path.join(root, "classes", "images", f"{cid}.jpg"), quality=95)
    w, h = GROZI_SOURCE
    side = GROZI_BLOCKS * GROZI_SOURCE_BLOCK
    to_source = GROZI_SOURCE_BLOCK / GROZI_LEVEL_BLOCK
    rows = []
    for image_id, (split, plants) in sorted(GROZI_PLANTED.items()):
        scene = np.kron(rng.randint(0, 60, (h // 3, w // 3, 3), np.uint8),
                        np.ones((3, 3, 1), np.uint8))
        for x0, y0, cid in plants:
            sx, sy = round(x0 * to_source), round(y0 * to_source)
            scene[sy:sy + side, sx:sx + side] = patches[cid]
            rows.append(dict(imageid=image_id, imagefilename=f"{image_id}.jpg", classid=cid,
                             classfilename=f"{cid}.jpg", gtbboxid=len(rows), difficult=0,
                             lx=sx / w, ty=sy / h, rx=(sx + side) / w, by=(sy + side) / h,
                             split=split))
        Image.fromarray(scene).save(
            os.path.join(root, "src", str(GROZI_SOURCE[0]), f"{image_id}.jpg"), quality=95)
    pd.DataFrame(rows).to_csv(os.path.join(root, "classes", "grozi.csv"), index=False)


def _load_script(relative_path):
    """A script of this checkout (experiments/, tools/) as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relative_path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _job_argv(queue_job, **overrides):
    """The argv of `python -m os2d_torch.main` in a job of a launcher twin's
    queue, with `overrides` (dotted keys) appended."""
    import shlex

    _, _, commands, _ = queue_job
    tokens = shlex.split(commands[0])
    if tokens[:3] != ["python", "-m", "os2d_torch.main"]:
        raise SystemExit(f"experiments: a job runs {tokens[:3]}, not os2d_torch.main")
    for k, v in overrides.items():
        tokens[3:] += [k, str(v)]
    return tokens[3:]


def entry_surfaces(counts, device="cuda"):
    """Phases 33 (experiments) and 34 (parity_runbook) in a directory of
    their own under build/: the planted GroZi tree, a reference-layout .pth
    of Os2dModel(Os2dConfig(), seed=1)'s weights and a backbone-only .pth of
    its torchvision-named backbone. `counts` as for model_options. Returns
    {kernel: launches} of both phases. With device="cpu" the jobs and the
    runbook run on the CPU (the kernels' plain versions: no launch to
    count)."""
    import contextlib
    import io
    import logging

    import numpy as np
    import torch

    from os2d_torch import main as port_main
    from os2d_torch.engine import train as train_module
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.ops.cuda import BUILD_DIR
    from os2d_torch.utils import launcher

    total = {}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    saved_data_path = os.environ.get("DATA_PATH")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        data_path = os.path.join(work, "data")
        write_grozi_planted_tree(data_path)
        source = Os2dModel(Os2dConfig(), device=device, seed=1)
        ref_path = os.path.join(work, "os2d_v2-train.pth")
        torch.save({"net": reference_layout(source.state_dict())}, ref_path)
        backbone_path = os.path.join(work, "backbone.pth")
        torch.save({k: v.detach().cpu() for k, v in source.backbone.state_dict().items()},
                   backbone_path)
        del source
        saved_device = os.environ.get("OS2D_DEVICE")
        os.environ["DATA_PATH"], os.environ["OS2D_DEVICE"] = data_path, device
        try:
            # ---- 33. experiments: the launcher twins' first jobs through main ----
            t_phase = time.perf_counter()
            grozi_eval = _load_script("experiments/launcher_grozi_eval_torch.py")
            eval_job = grozi_eval.build_jobs(
                grozi_eval.create_args_parser().parse_args(["--no-launch"])).jobs[0]
            dataset = "grozi-val-new-cl"
            eval_root = os.path.join(work, "output", "eval")
            log_dir = os.path.join(eval_root, dataset)
            os.makedirs(log_dir)
            eval_argv = _job_argv(eval_job, **{"init.model": ref_path, "output.path": log_dir})
            # the job's stdout as the launcher's job script tees it
            handler = logging.FileHandler(os.path.join(log_dir, f"{eval_job[3]}out.txt"))
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s: %(message)s"))
            os2d_logger = logging.getLogger("OS2D")
            os2d_logger.addHandler(handler)
            counts.reset()
            t0 = time.perf_counter()
            try:
                _, eval_meters = port_main.main(eval_argv)
            finally:
                os2d_logger.removeHandler(handler)
                handler.close()
            sync()
            eval_s = time.perf_counter() - t0
            eval_counts = counts.read()
            add(eval_counts)
            eval_map = float(eval_meters[dataset]["mAP@0.50"])
            collect = _load_script("experiments/launcher_eval_collect_torch.py")
            collected = collect.collect(eval_root, "mAP@0.50")
            table = io.StringIO()
            with contextlib.redirect_stdout(table):
                collect.main(["--log-root", eval_root])

            exp1 = _load_script("experiments/launcher_exp1_torch.py")
            train_job = exp1.build_jobs(
                launcher.create_args_parser().parse_args(["--no-launch"])).jobs[0]
            train_argv = _job_argv(train_job, **{
                "init.model": backbone_path, "output.path": os.path.join(work, "exp1"),
                "train.optim.max_iter": EXPERIMENT_TRAIN_STEPS})
            step_meters = []
            original_one_batch = train_module.train_one_batch

            def recorded_one_batch(*args, **kwargs):
                meters = original_one_batch(*args, **kwargs)
                step_meters.append({k: float(meters[k]) for k in ("loss", "grad_norm")})
                return meters

            train_module.train_one_batch = recorded_one_batch
            counts.reset()
            t0 = time.perf_counter()
            try:
                _, train_eval_meters = port_main.main(train_argv)
            finally:
                train_module.train_one_batch = original_one_batch
            sync()
            train_s = time.perf_counter() - t0
            train_counts = counts.read()
            add(train_counts)
            levels = len(port_main.parse_opts(eval_argv)[0].eval.scales_of_image_pyramid)
            emit({"phase": "experiments",
                  "eval_job": {"name": eval_job[0], "argv": eval_argv, "mAP@0.50": eval_map,
                               "collected": collected, "table": table.getvalue().splitlines(),
                               "seconds": eval_s, "launches": eval_counts, "levels": levels},
                  "train_job": {"name": train_job[0], "argv": train_argv,
                                "steps": step_meters,
                                "final_mAP@0.50": float(train_eval_meters[dataset]["mAP@0.50"]),
                                "seconds": train_s, "launches": train_counts},
                  "seconds": time.perf_counter() - t_phase})
            if not eval_map >= EXPERIMENT_MIN_MAP:
                raise SystemExit(f"experiments: the eval job's mAP@0.50 {eval_map} < "
                                 f"{EXPERIMENT_MIN_MAP}")
            if [(d, v) for d, _, v in collected] != [(dataset, float(f"{eval_map:.4f}"))]:
                raise SystemExit(f"experiments: the collect twin read {collected} from the "
                                 f"eval job's log, the job returned {eval_map}")
            counts.require("experiments", eval_counts, "hat_resample_correlation")
            if eval_counts["hat_resample_correlation"] < levels:
                raise SystemExit(f"experiments: {eval_counts['hat_resample_correlation']} hat "
                                 f"launches for {levels} levels")
            if len(step_meters) != EXPERIMENT_TRAIN_STEPS or not all(
                    np.isfinite(list(m.values())).all() for m in step_meters):
                raise SystemExit(f"experiments: the training job's steps {step_meters}")
            counts.require("experiments", train_counts, "resample_correlation_backward",
                           EXPERIMENT_TRAIN_STEPS)

            # ---- 34. parity_runbook: the runbook twin at the published protocol ----
            t_phase = time.perf_counter()
            runbook = _load_script("tools/parity_release_torch.py")
            runs = {}
            for tol in ("100", "0"):
                out = io.StringIO()
                counts.reset()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    try:
                        runbook.main(["--row", "v2-train", "--checkpoint", ref_path,
                                      "--data-path", data_path, "--tol", tol,
                                      "--device", device])
                        code = 0
                    except SystemExit as e:
                        code = e.code
                sync()
                launches = counts.read()
                add(launches)
                lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                         if ln.startswith("{")]
                runs[tol] = {"exit": code, "lines": lines, "seconds": time.perf_counter() - t0,
                             "launches": launches}
            emit({"phase": "parity_runbook", "scale": runbook.SCALE, "runs": runs,
                  "mAP@0.50": runs["100"]["lines"][0]["mAP@0.50"] if runs["100"]["lines"]
                  else None, "seconds": time.perf_counter() - t_phase})
            for tol, want_code, verdict in (("100", 0, "PASS"), ("0", 1, "FAIL")):
                run = runs[tol]
                if run["exit"] != want_code or not run["lines"] or (
                        run["lines"][-1].get("parity_gate") != verdict):
                    raise SystemExit(f"parity_runbook: --tol {tol} gave exit {run['exit']}, "
                                     f"lines {run['lines']}; expected {verdict}, "
                                     f"exit {want_code}")
                counts.require("parity_runbook", run["launches"], "hat_resample_correlation")
        finally:
            for name, saved in (("DATA_PATH", saved_data_path), ("OS2D_DEVICE", saved_device)):
                if saved is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = saved
    return total


def main(argv):
    t_run = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from os2d_torch.config import get_default_cfg
    from os2d_torch.data.dataloader import DataloaderOneShotDetection
    from os2d_torch.data.dataset import DatasetOneShotDetection
    from os2d_torch.engine.evaluate import Evaluator, evaluate, unpack_detections
    from os2d_torch.engine.decode import (
        decode_pyramid,
        decode_single_level,
        default_boxes_for_image_size,
    )
    from os2d_torch.models import Os2dConfig, Os2dModel
    from os2d_torch.models import head as head_module
    from os2d_torch.models.os2d import fold_inference_params
    from os2d_torch.models.resnet import Conv2d
    from os2d_torch.data.dataloader import build_train_dataloader_from_config
    from os2d_torch.engine.objective import ObjectiveConfig
    from os2d_torch.engine.optimization import create_optimizer
    from os2d_torch.data.class_cache import DeviceClassCache
    from os2d_torch.engine import train as train_module
    from os2d_torch.engine.mining import mine_hard_patches
    from os2d_torch.engine.train import (
        TrainStep,
        prepare_batch_arrays,
        trainable_parameters,
        trainval_loop,
    )
    from os2d_torch.ops import (
        frozen_bn,
        group_norm,
        hat_resample,
        int8_resample,
        nms,
        resample,
        resample_grad,
    )
    from os2d_torch.ops.cuda import BUILD_DIR, build_all
    from os2d_torch.ops.sampling import (
        hat_resample_operand,
        hat_resample_reference,
        int8_hat_resample_reference,
        int8_hat_resample_theta_reference,
        quantize_int8,
        resample_backward_reference,
        resample_correlation_from_pxpy_reference,
    )
    from os2d_torch.structures.feature_map import FeatureMapSize, feature_map_size_for_image

    kernels = {"resample_correlation": resample.KERNEL,
               "hat_resample_correlation": hat_resample.KERNEL,
               "int8_hat_resample_correlation": int8_resample.KERNEL,
               "resample_correlation_backward": resample_grad.KERNEL,
               "group_norm_forward": group_norm.FORWARD,
               "group_norm_backward": group_norm.BACKWARD,
               "frozen_bn_act": frozen_bn.KERNEL}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        return {name: k.launches for name, k in kernels.items()}

    def require_launches(phase, counts, kernel, expected=None):
        n = counts[kernel]
        if n == 0 or (expected is not None and n != expected):
            raise SystemExit(f"{phase}: {kernel} launched {n} times, expected "
                             f"{'at least one' if expected is None else expected}")

    # ---- 1. environment and build ----
    smi = nvidia_smi_line()
    model = Os2dModel(Os2dConfig(), seed=0)
    t0 = time.perf_counter()
    logs = build_all(sorted({k.source for k in kernels.values()}))
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "build_s": build_s, "built": sorted(logs), "ptxas": ptxas})

    # ---- 2. kernels against their plain versions ----
    # ragged small shapes (not multiples of the 8x32 anchor tile, a single
    # row, a single column), every level of the bench protocol (B=2, C=16)
    # and C=128 at the largest, each with uniform and with near-identity
    # px/py; px/py reaching 0.5 outside the map; a map taller than 256
    # rows; B*C above 65535
    sizes = [FeatureMapSize(w=int(IMG_W * s), h=int(IMG_H * s)) for s in PYRAMID]
    fms = [feature_map_size_for_image(sz) for sz in sizes]
    ragged = [(2, 3, 6, 7), (2, 3, 19, 23), (1, 2, 1, 7), (1, 2, 6, 1)]
    shapes = ragged + [(BATCH, NUM_CLASSES, fm.h, fm.w) for fm in fms]
    shapes += [(BATCH, 128, fms[-1].h, fms[-1].w)]
    cases = [(shape, kind) for shape in shapes for kind in ("uniform", "near_identity")]
    cases += [(shape, "outside") for shape in ragged]
    cases += [((1, 2, 300, 7), "uniform"), ((2, 32800, 3, 2), "uniform")]
    cases += [(shape, "half") for shape in ragged + [(BATCH, NUM_CLASSES, fms[-1].h, fms[-1].w)]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"resample_correlation": {}, "hat_resample_correlation": {},
            "int8_hat_resample_correlation": {}}
    hat_exact_errs = {}
    for (b, c, h, w), kind in cases:
        name = f"{kind}_{b}x{c}x{h}x{w}"
        corr, px, py, mask_t = random_resample_inputs(b, c, h, w, gen, kind)
        corr = corr[..., :121]
        exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        got = resample.resample_correlation(corr, px, py, mask_t)
        torch.cuda.synchronize()
        errs["resample_correlation"][name] = max_err_checked(
            got, exact, f"resample kernel at {name}")
        got = hat_resample.resample_correlation_hat(corr, px, py, mask_t)
        torch.cuda.synchronize()
        want = hat_resample_reference(corr, px, py, mask_t)
        errs["hat_resample_correlation"][name] = max_err_checked(
            got, want, f"hat kernel at {name}", HAT_RTOL, HAT_ATOL)
        got8 = int8_resample.resample_correlation_int8(corr, px, py, mask_t)
        torch.cuda.synchronize()
        errs["int8_hat_resample_correlation"][name] = max_err_checked(
            got8, int8_hat_resample_reference(corr, px, py, mask_t), f"int8 kernel at {name}")
        del got8
        if kind != "outside":  # outside the map the hat form drops, the gather clamps
            hat_exact_errs[name] = float((got - exact).abs().max())
            if not hat_exact_errs[name] <= DEFAULT_TIER_MARGIN:
                raise SystemExit(f"hat kernel is {hat_exact_errs[name]} from the exact gather "
                                 f"at {name}, above the margin {DEFAULT_TIER_MARGIN}")
        del corr, px, py, mask_t, got, want, exact
    # the int8 kernel from theta: the ragged shapes and every bench level
    # with each kind of theta, C=128 at the largest with identity theta
    theta_cases = [(shape, kind) for shape in shapes[:-1]
                   for kind in ("identity", "near_identity", "random", "outside")]
    theta_cases += [(shapes[-1], "identity")]
    int8_theta_errs = {}
    for (b, c, h, w), kind in theta_cases:
        name = f"theta_{kind}_{b}x{c}x{h}x{w}"
        corr = torch.tanh(torch.randn(b, c, h, w, 225, generator=gen, device="cuda"))[..., :121]
        theta, boxes, lattice = random_theta_inputs(b, c, h, w, gen, kind)
        mask_t = torch.rand(c, 121, generator=gen, device="cuda")
        got8 = int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t)
        torch.cuda.synchronize()
        int8_theta_errs[name] = max_err_checked(
            got8, int8_hat_resample_theta_reference(corr, theta, boxes, lattice, mask_t),
            f"int8 kernel from theta at {name}")
        del corr, theta, got8
    errs["int8_hat_resample_correlation"].update(int8_theta_errs)
    # the backward: ragged shapes with uniform (some coordinates on the
    # borders), near-identity, integer (every sample on a tie) and collapsed
    # coordinates (a plane's adds on four cells), the training shape, t_full
    # 128 and 121 (= T), and B*C above 65535; each call twice
    bwd_kinds = ("uniform", "near_identity", "identity", "collapsed")
    bwd_cases = [(shape, kind, 225) for shape in ragged
                 for kind in ("uniform", "near_identity", "integer", "collapsed")]
    bwd_cases += [((4, 16, 38, 38), kind, 225) for kind in bwd_kinds]
    bwd_cases += [((2, 3, 19, 23), "near_identity", t_full) for t_full in (128, 121)]
    bwd_cases += [((2, 32800, 3, 2), "uniform", 128)]
    errs["resample_correlation_backward"] = {}
    bwd_repeat, bwd_dcorr_cpu = {}, {}
    for (b, c, h, w), kind, t_full in bwd_cases:
        name = f"{kind}_{b}x{c}x{h}x{w}_t{t_full}"
        corr, px, py, mask_t = random_resample_inputs(
            b, c, h, w, gen, "uniform" if kind == "integer" else kind)
        corr = corr[..., :t_full].contiguous()
        if kind == "integer":
            px, py = px.floor().contiguous(), py.floor().contiguous()
        g = torch.randn(b, c, h * w, generator=gen, device="cuda")
        g_sum = g + torch.randn(b, c, h * w, generator=gen, device="cuda")
        args = (g, g_sum, corr, px, py, mask_t)
        got = resample_grad.resample_correlation_backward(*args)
        again = resample_grad.resample_correlation_backward(*args)
        torch.cuda.synchronize()
        want = resample_backward_reference(*args, px.shape[2])
        errs["resample_correlation_backward"][name] = {
            part: max_err_checked(x, y, f"backward kernel {part} at {name}")
            for part, x, y in zip(("dcorr", "dpx", "dpy"), got, want)}
        if got[0][..., px.shape[2]:].any():
            raise SystemExit(f"backward kernel wrote dcorr channels >= T at {name}")
        bwd_repeat[name] = all(torch.equal(x, y) for x, y in zip(got, again))
        # the plain version on the CPU (seconds at the training shape: there
        # on identity inputs only; tests/test_torch_kernels_card.py takes
        # every kind)
        if b * c * h * w < 4 * 16 * 38 * 38 or kind == "identity":
            bwd_dcorr_cpu[name] = torch.equal(got[0].cpu(), resample_backward_reference(
                *(x.cpu() for x in args), px.shape[2])[0])
        if not (bwd_repeat[name] and bwd_dcorr_cpu.get(name, True)
                and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise SystemExit(f"backward kernel at {name}: two calls equal {bwd_repeat[name]}, "
                             f"dcorr equal to the CPU's plain version {bwd_dcorr_cpu.get(name)}, "
                             f"dpx/dpy equal to the plain version "
                             f"{torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])}")
        del corr, px, py, mask_t, g, g_sum, args, got, again, want
    int8_bit_equal = all(e == 0.0 for e in errs["int8_hat_resample_correlation"].values())
    emit({"phase": "int8_kernel",
          "int8_hat_resample_correlation": {
              "rtol": RTOL, "atol": ATOL, "max_abs_err": errs["int8_hat_resample_correlation"],
              "bit_equal": int8_bit_equal}})
    if not int8_bit_equal:
        raise SystemExit("int8 kernel differs from its plain version in some case")
    bwd_errs = errs["resample_correlation_backward"]
    emit({"phase": "kernel",
          "resample_correlation_backward": {
              "rtol": RTOL, "atol": ATOL, "max_abs_err": bwd_errs,
              "dpx_dpy_bit_equal": all(e["dpx"] == 0.0 and e["dpy"] == 0.0
                                       for e in bwd_errs.values()),
              "dcorr_bit_equal_card_plain": all(e["dcorr"] == 0.0 for e in bwd_errs.values()),
              "dcorr_bit_equal_cpu_plain": bwd_dcorr_cpu, "two_calls_bit_equal": bwd_repeat}})
    emit({"phase": "kernel",
          "resample_correlation": {"rtol": RTOL, "atol": ATOL,
                                   "max_abs_err": errs["resample_correlation"],
                                   "bit_equal": all(
                                       e == 0.0 for e in errs["resample_correlation"].values())},
          "hat_resample_correlation": {"rtol": HAT_RTOL, "atol": HAT_ATOL,
                                       "max_abs_err": errs["hat_resample_correlation"],
                                       "bit_equal": all(
                                           e == 0.0
                                           for e in errs["hat_resample_correlation"].values()),
                                       "vs_exact_gather": hat_exact_errs,
                                       "exact_margin": DEFAULT_TIER_MARGIN}})
    gn_kernels = group_norm_kernels(gen)
    fbn_kernel = frozen_bn_kernels(gen)

    # ---- 3. planted patches at the default tier, the card against the CPU ----
    cfg = get_default_cfg()
    cfg.tpu.eval_pre_top_k = 256
    cfg.tpu.eval_top_k = 16
    scenes, patches = planted_scenes()
    norm = {"mean": model.config.normalization_mean, "std": model.config.normalization_std}
    mean, std = torch.tensor(norm["mean"]), torch.tensor(norm["std"])
    class_images = [(torch.from_numpy(p).float() / 255.0 - mean) / std for p in patches]
    level = [FeatureMapSize(w=640, h=480)]
    packed = {}
    cpu_model = Os2dModel(Os2dConfig(), device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    reset_counts()
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        ev = Evaluator(m, cfg)
        head, _ = ev.build_class_heads(class_images)
        packed[dev] = unpack_detections(ev.detect_images(scenes, head, level, [(1.0, 1.0)], norm))
    planted_counts = read_counts()
    found = planted_found(packed["cuda"])
    agree = detections_agree(packed["cuda"], packed["cpu"])
    emit({"phase": "planted", "resample_precision": model.config.resample_precision,
          "found": found, "cuda_matches_cpu": agree, "launches": planted_counts})
    if not all(f["ok"] for f in found):
        raise SystemExit("planted patches were not all found")
    if not agree:
        raise SystemExit("detections on the card differ from the CPU's")
    require_launches("planted", planted_counts, "hat_resample_correlation")

    # ---- 4. evaluate() to VOC mAP: data layer, TTA, prescreen ----
    eval_cfg = get_default_cfg()
    eval_cfg.eval.mAP_iou_thresholds = [0.5]
    eval_cfg.eval.class_image_augmentation = EVAL_TTA
    eval_cfg.eval.nms_score_threshold = EVAL_SCORE_THRESHOLD
    eval_cfg.tpu.eval_pre_top_k = 256
    eval_cfg.tpu.eval_top_k = 32
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_planted_dataset(root)
        dataset = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted", image_size=640,
            eval_scale=640, cache_images=True)
        loader = DataloaderOneShotDetection(dataset, batch_size=1,
                                            pyramid_scales_eval=EVAL_PYRAMID)
        reset_counts()
        t0 = time.perf_counter()
        results = evaluate(loader, model, eval_cfg)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = read_counts()
        t0 = time.perf_counter()
        cpu_results = evaluate(loader, cpu_model, eval_cfg)
        cpu_eval_s = time.perf_counter() - t0
    emit({"phase": "evaluate", "data": "files (PIL + pandas) through os2d_torch.data",
          "levels": EVAL_PYRAMID, "class_image_augmentation": EVAL_TTA,
          "nms_score_threshold": EVAL_SCORE_THRESHOLD,
          "mAP@0.50": results["mAP@0.50"], "recall@0.50": results["recall@0.50"],
          "prescreen_pruned": results.get("prescreen_pruned"),
          "cpu_mAP@0.50": cpu_results["mAP@0.50"],
          "cpu_prescreen_pruned": cpu_results.get("prescreen_pruned"),
          "launches": eval_counts, "seconds": eval_s, "cpu_seconds": cpu_eval_s})
    if "prescreen_pruned" not in results:
        raise SystemExit("evaluate() did not go through the class prescreen")
    if not results["mAP@0.50"] >= 0.9:
        raise SystemExit(f"evaluate() mAP@0.50 {results['mAP@0.50']} < 0.9")
    if cpu_results["mAP@0.50"] != results["mAP@0.50"]:
        raise SystemExit(f"evaluate() mAP@0.50 {results['mAP@0.50']} on the card, "
                         f"{cpu_results['mAP@0.50']} on the CPU")
    require_launches("evaluate", eval_counts, "hat_resample_correlation")

    # ---- 5. the prescreen pruning some classes, the card against the CPU ----
    # random-init features give every class of a real bank a ceiling near
    # 0.99, so the bank is one-hot as in tests/test_torch_prescreen.py: class
    # k correlates with feature channel 240 + k, its ceiling has real spread
    ps_cfg = get_default_cfg()
    ps_cfg.tpu.eval_class_chunk = 2
    ps_cfg.tpu.eval_pre_top_k = 256
    ps_cfg.tpu.eval_top_k = 32
    ps_feats = torch.zeros(PRESCREEN_CLASSES, 15, 15, 1024)
    for k in range(PRESCREEN_CLASSES):
        ps_feats[k, :, :, 240 + k] = 1.0
    ps_scene = np.random.RandomState(0).randint(0, 255, (1, PRESCREEN_H, PRESCREEN_W, 3),
                                                np.uint8)
    ps_level = [FeatureMapSize(w=PRESCREEN_W, h=PRESCREEN_H)]
    ps = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        ps_head = head_module.ClassHead(ps_feats.to(dev),
                                        head_module.make_class_pool_mask(PRESCREEN_CLASSES,
                                                                         device=dev))
        ev = Evaluator(m, ps_cfg)
        if dev == "cuda":
            # a threshold between the classes' best scores, as the tests pick it
            ps_cfg.eval.nms_score_threshold = float("-inf")
            full0 = unpack_detections(ev.detect_images(ps_scene, ps_head, ps_level,
                                                       [(1.0, 1.0)], norm))
            ps_cfg.eval.nms_score_threshold = float(np.median(full0["scores"][0].max(1)))
            ps["full"] = unpack_detections(ev.detect_images(ps_scene, ps_head, ps_level,
                                                            [(1.0, 1.0)], norm))
            reset_counts()
        pre = ev.detect_images_prescreened(ps_scene, ps_head, ps_level, [(1.0, 1.0)], norm)
        if dev == "cuda":
            torch.cuda.synchronize()
            ps_counts = read_counts()
        ps[dev] = unpack_detections(pre)
        ps[dev + "_pruned"] = ev.prescreen_pruned
    ps_match_full = detections_agree(ps["cuda"], ps["full"], box_atol=1e-3)
    ps_match_cpu = detections_agree(ps["cuda"], ps["cpu"])
    emit({"phase": "prescreen", "classes": PRESCREEN_CLASSES,
          "image": f"{PRESCREEN_W}x{PRESCREEN_H}",
          "nms_score_threshold": ps_cfg.eval.nms_score_threshold,
          "pruned": ps["cuda_pruned"], "cpu_pruned": ps["cpu_pruned"],
          "kept_rows": int((ps["cuda"]["valid"][0].sum(1) > 0).sum()),
          "matches_full_path": ps_match_full, "cuda_matches_cpu": ps_match_cpu,
          "launches": ps_counts})
    if not 0 < ps["cuda_pruned"] < PRESCREEN_CLASSES:
        raise SystemExit(f"prescreen pruned {ps['cuda_pruned']} of {PRESCREEN_CLASSES} "
                         f"classes: the partial prune was not exercised")
    if ps["cpu_pruned"] != ps["cuda_pruned"]:
        raise SystemExit(f"prescreen pruned {ps['cuda_pruned']} classes on the card, "
                         f"{ps['cpu_pruned']} on the CPU")
    if not ps_match_full:
        raise SystemExit("prescreened detections differ from the full path's on the card")
    if not ps_match_cpu:
        raise SystemExit("prescreened detections on the card differ from the CPU's")
    require_launches("prescreen", ps_counts, "hat_resample_correlation")
    del cpu_model

    # ---- 6./7. main path at the bench protocol, both tiers ----
    cfg = get_default_cfg()
    cfg.tpu.eval_class_chunk = NUM_CLASSES
    rng = np.random.RandomState(0)
    class_images = [rng.randn(240, 240, 3).astype(np.float32) for _ in range(NUM_CLASSES)]
    inv = [(IMG_W / sz.w, IMG_H / sz.h) for sz in sizes]
    anchors = sum(fm.w * fm.h for fm in fms)
    batches = [np.random.RandomState(i).randint(0, 255, (BATCH, IMG_H, IMG_W, 3), np.uint8)
               for i in range(TIMED_DISPATCHES + 1)]
    model_highest = Os2dModel(Os2dConfig(resample_precision="highest"), seed=0)
    model_highest.load_state_dict(model.state_dict())

    def run_main(phase, m, n_timed, kernel, bound_ms_per_dispatch):
        ev = Evaluator(m, cfg)
        class_head, _ = ev.build_class_heads(class_images)
        t0 = time.perf_counter()
        ev.detect_images(batches[-1], class_head, sizes, inv, norm)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, outputs = [], []
        for i in range(n_timed):
            t0 = time.perf_counter()
            out = ev.detect_images(batches[i], class_head, sizes, inv, norm)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outputs.append(out)
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for out in outputs:
            if tuple(out.shape) != (BATCH, NUM_CLASSES, int(cfg.tpu.eval_top_k), 6):
                raise SystemExit(f"{phase}: packed output has shape {tuple(out.shape)}")
            d = unpack_detections(out)
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"][d["valid"]]).all()
                    and d["valid"].any()):
                raise SystemExit(f"{phase}: non-finite or no detections")
        require_launches(phase, counts, kernel, len(PYRAMID) * n_timed)
        require_launches(phase, counts, "frozen_bn_act",
                         FBN_SLOTS_PER_PASS * len(PYRAMID) * n_timed)
        median = float(np.median(times))
        emit({"phase": phase, "resample_precision": m.config.resample_precision,
              "images": f"{BATCH}x{IMG_W}x{IMG_H} uint8", "levels": len(sizes),
              "anchors_per_image": anchors, "classes": NUM_CLASSES, "warmup_s": warmup_s,
              "dispatch_s": times, "median_dispatch_s": median, "img_per_s": BATCH / median,
              "img_per_s_spread": [BATCH / max(times), BATCH / min(times)],
              "launches": counts, "resample_bound_ms_per_dispatch": bound_ms_per_dispatch,
              "peak_gb": peak_gb})
        return ev, class_head, counts, median

    ev, class_head, main_counts, main_median = run_main(
        "main", model, TIMED_DISPATCHES, "hat_resample_correlation",
        sum(hat_bound(BATCH, NUM_CLASSES, fm.h * fm.w, 121)[0] for fm in fms))
    ev_highest, class_head_highest, highest_counts, _ = run_main(
        "main_highest", model_highest, TIMED_DISPATCHES, "resample_correlation",
        sum(resample_bound(BATCH, NUM_CLASSES, fm.w * fm.h, 121)[0] for fm in fms))

    # the two tiers in turns (default, highest, highest, default, ...), so
    # that neither gains from running later in the process
    tier_runs = {"default": (ev, class_head), "highest": (ev_highest, class_head_highest)}
    tier_times = {"default": [], "highest": []}
    for i, tier in enumerate(["default", "highest", "highest", "default"] * TIER_ROUNDS):
        tier_ev, tier_head = tier_runs[tier]
        t0 = time.perf_counter()
        tier_ev.detect_images(batches[i % TIMED_DISPATCHES], tier_head, sizes, inv, norm)
        torch.cuda.synchronize()
        tier_times[tier].append(time.perf_counter() - t0)
    tier_median = {k: float(np.median(v)) for k, v in tier_times.items()}
    emit({"phase": "tiers", "order": "default, highest, highest, default, ...",
          "dispatch_s": tier_times,
          "img_per_s": {k: BATCH / m for k, m in tier_median.items()},
          "img_per_s_spread": {k: [BATCH / max(v), BATCH / min(v)]
                               for k, v in tier_times.items()},
          "median_dispatch_ms": {k: m * 1e3 for k, m in tier_median.items()},
          "default_at_least_highest": tier_median["default"] <= tier_median["highest"]})
    del tier_runs, ev_highest, class_head_highest, model_highest

    # ---- 8. both kernels on the main path's own inputs ----
    # one more dispatch with the head's resample inputs captured at every
    # level; both kernels are held against their plain versions and timed
    # there, and on the largest level set beside their bounds, their plain
    # versions and one PyTorch call each
    # and the theta, anchor boxes and lattice of the head's coordinate
    # function at every level, for the int8 kernel's theta source
    captured, captured_theta = [], []
    original = resample_grad.FORWARD["default"]
    original_coords = head_module.interior_sample_coords

    def capture(corr, px, py, mask_t):
        out = original(corr, px, py, mask_t)
        captured.append((corr, px, py, mask_t, out))
        return out

    def capture_coords(theta, boxes, lattice, h, w):
        captured_theta.append((theta.contiguous(), boxes, lattice))
        return original_coords(theta, boxes, lattice, h, w)

    resample_grad.FORWARD["default"] = capture
    head_module.interior_sample_coords = capture_coords
    try:
        ev.detect_images(batches[0], class_head, sizes, inv, norm)
    finally:
        resample_grad.FORWARD["default"] = original
        head_module.interior_sample_coords = original_coords
    torch.cuda.synchronize()
    if not len(captured) == len(captured_theta) == len(PYRAMID):
        raise SystemExit(f"captured {len(captured)} resample and {len(captured_theta)} "
                         f"coordinate calls, expected {len(PYRAMID)}")
    main_exact_errs = {}
    level_ms = {"resample_correlation": {}, "hat_resample_correlation": {},
                "int8_hat_resample_correlation": {}}
    int8_main_bit_equal = {}
    for (corr, px, py, mask_t, hat_level), (theta, boxes, lattice) in zip(captured,
                                                                       captured_theta):
        name = f"main_path_{corr.shape[2]}x{corr.shape[3]}"
        level_ms["resample_correlation"][name] = cuda_ms(
            lambda: resample.resample_correlation(corr, px, py, mask_t), 10)
        level_ms["hat_resample_correlation"][name] = cuda_ms(
            lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t), 10)
        level_ms["int8_hat_resample_correlation"][name] = cuda_ms(
            lambda: int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice,
                                                                  mask_t), 10)
        got8 = int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t)
        errs["int8_hat_resample_correlation"][name] = max_err_checked(
            got8, int8_hat_resample_theta_reference(corr, theta, boxes, lattice, mask_t),
            f"int8 kernel on main-path theta at {name}")
        # the same samples from the px/py that the default tier took
        int8_main_bit_equal[name] = (
            errs["int8_hat_resample_correlation"][name] == 0.0
            and torch.equal(got8, int8_resample.resample_correlation_int8(corr, px, py, mask_t)))
        if not int8_main_bit_equal[name]:
            raise SystemExit(f"int8 kernel on main-path theta at {name}: not equal to its plain "
                             f"version, or to itself from the level's px/py, to the bit")
        del got8
        exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
        errs["resample_correlation"][name] = max_err_checked(
            resample.resample_correlation(corr, px, py, mask_t), exact,
            f"resample kernel on main-path inputs at {name}")
        errs["hat_resample_correlation"][name] = max_err_checked(
            hat_level, hat_resample_reference(corr, px, py, mask_t),
            f"hat kernel on main-path inputs at {name}", HAT_RTOL, HAT_ATOL)
        main_exact_errs[name] = float((hat_level - exact).abs().max())
        if not main_exact_errs[name] <= DEFAULT_TIER_MARGIN:
            raise SystemExit(f"hat kernel is {main_exact_errs[name]} from the exact gather on "
                             f"the main path's inputs at {name}, above the margin "
                             f"{DEFAULT_TIER_MARGIN}")
        del exact
    emit({"phase": "main_path_inputs", "levels": len(captured),
          "max_abs_err": {k: {n: e for n, e in v.items() if n.startswith("main_path_")}
                          for k, v in errs.items()},
          "int8_theta_bit_equal": int8_main_bit_equal,
          "hat_vs_exact_gather": main_exact_errs, "ms": level_ms,
          "ms_per_dispatch": {k: sum(v.values()) for k, v in level_ms.items()}})
    largest = max(range(len(captured)),
                  key=lambda i: captured[i][0].shape[2] * captured[i][0].shape[3])
    corr, px, py, mask_t, hat_out = captured[largest]
    theta, boxes, lattice = captured_theta[largest]
    del captured, captured_theta
    b, c, h, w, _ = corr.shape
    t, a = px.shape[2], h * w
    shape = {"B": b, "C": c, "H": h, "W": w, "T": t, "corr_row_stride": corr.stride(3)}
    largest_name = f"main_path_{h}x{w}"

    # the gather kernel
    exact = resample_correlation_from_pxpy_reference(corr, px, py, mask_t)
    gather_out = resample.resample_correlation(corr, px, py, mask_t)
    gather_ms = cuda_ms(lambda: resample.resample_correlation(corr, px, py, mask_t), 20)
    gather_plain_ms = cuda_ms(
        lambda: resample_correlation_from_pxpy_reference(corr, px, py, mask_t), 5)
    # yardstick: grid_sample (border, align_corners) on corr viewed as
    # [B*C*T, 1, H, W], then the masked sum; inputs laid out outside the timing
    planes = corr.permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def grid_sample_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return (s.view(b, c, t, a) * mask_t[None, :, :, None]).sum(2)

    gather_library_err = float((grid_sample_library().view(b, c, h, w) - gather_out).abs().max())
    gather_library_ms = cuda_ms(grid_sample_library, 5)
    del planes, grid
    gather_bound_ms, gather_bound_by = resample_bound(b, c, a, t)
    emit({"phase": "resample_timing", "kernel": "resample_correlation", "shape": shape,
          "ms": gather_ms, "plain_ms": gather_plain_ms, "library_ms": gather_library_ms,
          "library": "F.grid_sample + masked sum", "library_max_abs_err": gather_library_err,
          "bound_ms": gather_bound_ms, "bound_by": gather_bound_by,
          "max_abs_err": errs["resample_correlation"][largest_name]})

    # the hat kernel; yardstick: grid_sample (zeros padding, as the hat form
    # drops what lies outside the map, align_corners) on the planes of
    # M = bf16(corr * mask) held in fp32, then the sum over t; M laid out
    # outside the timing
    hat_ms = cuda_ms(lambda: hat_resample.resample_correlation_hat(corr, px, py, mask_t), 20)
    hat_plain_ms = cuda_ms(lambda: hat_resample_reference(corr, px, py, mask_t), 3)
    planes = hat_resample_operand(corr, mask_t).float().view(b * c * t, 1, h, w)
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def hat_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        return s.view(b, c, t, a).sum(2)

    hat_library_err = float((hat_library().view(b, c, h, w) - hat_out).abs().max())
    hat_library_ms = cuda_ms(hat_library, 5)
    del planes, grid
    hat_bound_ms, hat_bound_by = hat_bound(b, c, a, t)
    emit({"phase": "resample_timing", "kernel": "hat_resample_correlation", "shape": shape,
          "ms": hat_ms, "plain_ms": hat_plain_ms, "library_ms": hat_library_ms,
          "library": "F.grid_sample over bf16(corr * mask) + sum over t",
          "library_max_abs_err": hat_library_err, "bound_ms": hat_bound_ms,
          "bound_by": hat_bound_by,
          "max_abs_err": errs["hat_resample_correlation"][largest_name],
          "vs_exact_gather": main_exact_errs[largest_name]})

    # the int8 kernel; yardstick, an approximation (PyTorch has no call for
    # the int8 form; its row weights are not quantized here):
    # grid_sample (border, align_corners) over the planes of
    # round(corr*127)/127 * mask, then the sum over t; planes laid out
    # outside the timing
    int8_out = int8_resample.resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t)
    int8_ms = cuda_ms(lambda: int8_resample.resample_correlation_int8_theta(
        corr, theta, boxes, lattice, mask_t), 20)
    int8_plain_ms = cuda_ms(lambda: int8_hat_resample_theta_reference(
        corr, theta, boxes, lattice, mask_t), 3)
    planes = (quantize_int8(corr) / 127.0 * mask_t[None, :, None, None, :]).permute(
        0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(b * c * t, 1, a, 2)

    def int8_library():
        s = F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
        return s.view(b, c, t, a).sum(2)

    int8_library_err = float((int8_library().view(b, c, h, w) - int8_out).abs().max())
    int8_library_ms = cuda_ms(int8_library, 5)
    del planes, grid
    int8_bound_ms, int8_bound_by = int8_bound(b, c, a, t, lattice.shape[1])
    emit({"phase": "resample_timing", "kernel": "int8_hat_resample_correlation", "shape": shape,
          "source": "theta",
          "ms": int8_ms, "plain_ms": int8_plain_ms, "library_ms": int8_library_ms,
          "library": "F.grid_sample over round(corr*127)/127 * mask + sum over t "
                     "(an approximation: the row weights are not quantized)",
          "library_max_abs_err": int8_library_err, "bound_ms": int8_bound_ms,
          "bound_by": int8_bound_by,
          "max_abs_err": errs["int8_hat_resample_correlation"][largest_name],
          "vs_exact_gather": float((int8_out - exact).abs().max())})
    del corr, px, py, mask_t, exact, gather_out, hat_out, int8_out, theta

    # ---- 9.-11. the training path at the default recipe ----
    train_cfg = get_default_cfg()
    train_cfg.train.optim.max_iter = TRAIN_STEPS
    train_cfg.eval.iter = TRAIN_STEPS  # evals with the criterion before and after the steps
    train_cfg.eval.mAP_iou_thresholds = [0.5]
    train_cfg.tpu.device_class_cache = "off"
    objective = ObjectiveConfig()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_train_dataset(root)
        train_set = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted-train", image_size=TRAIN_SIZE,
            eval_scale=TRAIN_SIZE, cache_images=True)
        train_loader, _ = build_train_dataloader_from_config(train_cfg, train_set, seed=0)
        eval_loader = DataloaderOneShotDetection(train_set.copy_subset(TRAIN_EVAL_IMAGES),
                                                 batch_size=1, pyramid_scales_eval=[1.0])
        mine_subset = train_set.copy_subset(MINING_CPU_IMAGES)  # for phase 16
    train_batch = train_loader.get_batch(0)

    # 9. the first step on the card and on the CPU from the same weights, at
    # FIRST_STEP_MARGIN_POS (see its comment); the card's backward inputs are
    # captured for phase 11
    train_model = Os2dModel(Os2dConfig(), seed=1)
    cpu_train_model = Os2dModel(Os2dConfig(), device="cpu")
    cpu_train_model.load_state_dict({k: v.cpu() for k, v in train_model.state_dict().items()})
    first_objective = ObjectiveConfig(margin_pos=FIRST_STEP_MARGIN_POS)
    first, captured = {}, []
    original_backward = resample_grad.resample_correlation_backward

    def capture_backward(*args):
        captured.append(args)
        return original_backward(*args)

    for dev, m in (("cuda", train_model), ("cpu", cpu_train_model)):
        opt = create_optimizer(train_cfg.train.optim, trainable_parameters(m, train_cfg.train))
        step = TrainStep(m, first_objective, opt, train_cfg.train)
        arrays, c_pad = prepare_batch_arrays(train_batch, m.device)
        if dev == "cuda":
            reset_counts()
            resample_grad.resample_correlation_backward = capture_backward
        t0 = time.perf_counter()
        try:
            first[dev] = step(arrays, c_pad)
        finally:
            resample_grad.resample_correlation_backward = original_backward
        first[dev + "_s"] = time.perf_counter() - t0
        if dev == "cuda":
            first_counts = read_counts()
    del cpu_train_model
    if len(captured) != 1:
        raise SystemExit(f"captured {len(captured)} backward calls in one step, expected 1")
    step_bwd_inputs = tuple(x.detach() for x in captured.pop())
    first_err = {k: abs(first["cuda"][k] - first["cpu"][k]) / max(abs(first["cpu"][k]), 1e-12)
                 for k in first["cpu"]}
    emit({"phase": "train_first_step", "batch": list(arrays["images"].shape),
          "classes_padded": c_pad, "margin_pos": FIRST_STEP_MARGIN_POS,
          "cuda": first["cuda"], "cpu": first["cpu"],
          "relative_err": first_err, "rtol": TRAIN_CPU_RTOL, "cuda_s": first["cuda_s"],
          "cpu_s": first["cpu_s"], "launches": first_counts})
    if not all(np.isfinite(v) for v in first["cuda"].values()):
        raise SystemExit(f"train_first_step: non-finite metrics {first['cuda']}")
    if not first["cuda"]["cls_RLL_pos"] > 0:
        raise SystemExit("train_first_step: no positive scores below margin_pos, so the cls "
                         "gradient, and with it the backward's dpx/dpy, is zero")
    if not float(step_bwd_inputs[0].abs().max()) > 0:
        raise SystemExit("train_first_step: the captured cls cotangent is all zeros")
    for k in ("loss", "grad_norm"):
        if not first_err[k] <= TRAIN_CPU_RTOL:
            raise SystemExit(f"train_first_step: {k} {first['cuda'][k]} on the card, "
                             f"{first['cpu'][k]} on the CPU")
    require_launches("train_first_step", first_counts, "hat_resample_correlation", 1)
    require_launches("train_first_step", first_counts, "resample_correlation_backward", 1)

    # 10. trainval_loop: the train steps and the evals with the criterion
    watched = ("backbone.conv1.weight", "backbone.layer3.5.conv3.weight",
               "transform_net.linear.weight", "backbone.layer1.0.bn1.running_var")
    before = {k: train_model.state_dict()[k].clone() for k in watched}
    train_opt = create_optimizer(train_cfg.train.optim,
                                 trainable_parameters(train_model, train_cfg.train))
    reset_counts()
    t0 = time.perf_counter()
    full_log, _ = trainval_loop(train_loader, train_model, train_cfg, objective, train_opt,
                                dataloaders_eval=[eval_loader])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_counts = read_counts()
    moved = {k: float((train_model.state_dict()[k] - before[k]).abs().max()) for k in watched}
    series = {k: v for k, v in full_log.items() if k != "time"}
    emit({"phase": "train", "steps": TRAIN_STEPS, "eval_images": TRAIN_EVAL_IMAGES,
          "log": series, "param_max_change": moved, "seconds": loop_s,
          "launches": loop_counts})
    finite_keys = ["train_loss", "train_grad_norm", f"loss_{eval_loader.get_name()}"]
    for k in finite_keys:
        values = [v for v in full_log.get(k, []) if not np.isnan(v)]
        if not values or not np.isfinite(values).all():
            raise SystemExit(f"train: the log's {k} is {full_log.get(k)}")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit(f"train: parameters did not move: {moved}")
    require_launches("train", loop_counts, "resample_correlation_backward", TRAIN_STEPS)
    if loop_counts["hat_resample_correlation"] < TRAIN_STEPS:
        raise SystemExit(f"train: the hat kernel launched {loop_counts} times")

    # 11. TrainStep timing, then the backward kernel on the first step's inputs
    step = TrainStep(train_model, objective, train_opt, train_cfg.train)
    arrays, c_pad = prepare_batch_arrays(train_batch, "cuda")
    t0 = time.perf_counter()
    step(arrays, c_pad)
    torch.cuda.synchronize()
    train_warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_times, step_counts = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        metrics = step(arrays, c_pad)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        step_counts.append(read_counts())
        if not all(np.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"train_timing: non-finite metrics {metrics}")
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for counts in step_counts:
        require_launches("train_timing", counts, "hat_resample_correlation", 1)
        require_launches("train_timing", counts, "resample_correlation_backward", 1)
    train_median = float(np.median(step_times))
    emit({"phase": "train_timing", "recipe": "get_default_cfg() train: batch 4, 600x600, "
          "15 classes padded to 16, class images 240 px, SGD", "warmup_s": train_warmup_s,
          "step_s": step_times, "median_step_s": train_median,
          "step_s_spread": [min(step_times), max(step_times)],
          "launches_per_step": step_counts[0], "peak_gb": train_peak_gb})

    g, g_sum, corr, px, py, mask_t = step_bwd_inputs
    del step_bwd_inputs
    b, c, h, w, t_full = corr.shape
    t, a = px.shape[2], h * w
    got = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
    want = resample_backward_reference(g, g_sum, corr, px, py, mask_t, t)
    name = f"train_first_step_{b}x{c}x{h}x{w}"
    # the step's gradients are small: each part is held at the random cases'
    # atol taken relative to its largest magnitude; a part that is all zeros
    # would hold no kernel to anything
    want_max = {part: float(y.abs().max()) for part, y in zip(("dcorr", "dpx", "dpy"), want)}
    if not all(v > 0 for v in want_max.values()):
        raise SystemExit(f"train_timing: the first step's backward has an all-zero part "
                         f"{want_max} (max |g| {float(g.abs().max())})")
    errs["resample_correlation_backward"][name] = {
        part: max_err_checked(x, y, f"backward kernel {part} on the first step's inputs",
                              atol=ATOL * want_max[part])
        for part, x, y in zip(("dcorr", "dpx", "dpy"), got, want)}
    del got, want
    bwd_ms = cuda_ms(lambda: resample_grad.resample_correlation_backward(
        g, g_sum, corr, px, py, mask_t), 20)
    bwd_plain_ms = cuda_ms(lambda: resample_backward_reference(
        g, g_sum, corr, px, py, mask_t, t), 3)
    # yardstick: one aten.grid_sampler_2d_backward (bilinear, zeros padding as
    # the hat form drops what lies outside, align_corners) over the corr
    # planes for the cotangent g * mask; inputs laid out outside the timing
    planes = corr[..., :t].permute(0, 1, 4, 2, 3).reshape(b * c * t, 1, h, w).contiguous()
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1).reshape(
        b * c * t, 1, a, 2)
    grad_out = (g[:, :, None, :] * mask_t[None, :, :, None]).reshape(b * c * t, 1, 1, a)

    def grid_sample_backward():
        return torch.ops.aten.grid_sampler_2d_backward(grad_out, planes, grid, 0, 0, True,
                                                       [True, True])

    bwd_library_ms = cuda_ms(grid_sample_backward, 5)
    del planes, grid, grad_out
    bwd_bound_ms, bwd_bound_by = backward_bound(b, c, a, t, t_full)
    emit({"phase": "train_timing", "kernel": "resample_correlation_backward",
          "shape": {"B": b, "C": c, "H": h, "W": w, "T": t, "T_full": t_full},
          "ms": bwd_ms, "plain_ms": bwd_plain_ms, "library_ms": bwd_library_ms,
          "library": "aten.grid_sampler_2d_backward (grad of planes and grid)",
          "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
          "max_abs_err": errs["resample_correlation_backward"][name],
          "max_abs_want": want_max, "max_abs_g": float(g.abs().max()),
          "atol_relative": ATOL, "rtol": RTOL})

    # determinism: two backward calls on the first step's inputs, then two
    # short trainings from one seed on the same batches, compared to the bit
    again = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
    got = resample_grad.resample_correlation_backward(g, g_sum, corr, px, py, mask_t)
    bwd_calls = {part: torch.equal(x, y) for part, x, y in zip(("dcorr", "dpx", "dpy"), got, again)}
    del got, again
    det_batches = [prepare_batch_arrays(train_loader.get_batch(i % len(train_loader)), "cuda")
                   for i in range(DETERMINISM_STEPS)]
    saved_deterministic = torch.backends.cudnn.deterministic
    trainings = {}
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            states, losses = [], []
            for _ in range(2):
                m = Os2dModel(Os2dConfig(), seed=1)
                opt = create_optimizer(train_cfg.train.optim,
                                       trainable_parameters(m, train_cfg.train))
                step_m = TrainStep(m, first_objective, opt, train_cfg.train)
                losses.append([step_m(a, cp)["loss"] for a, cp in det_batches])
                states.append(m.state_dict())
                del m, opt, step_m
            diff = {k: float((v - states[1][k]).abs().max()) for k, v in states[0].items()}
            trainings["cudnn_deterministic" if deterministic else "default"] = {
                "losses": losses, "losses_equal": losses[0] == losses[1],
                "weights_bit_equal": all(
                    torch.equal(v, states[1][k]) for k, v in states[0].items()),
                "max_weight_diff": max(diff.values()),
                "tensors_differing": sum(d != 0 for d in diff.values())}
            del states
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
    del det_batches
    # the per-layer table: every convolution of one step at the default
    # recipe's shapes, each distinct one's gradients twice under cuDNN's
    # default algorithms and under the port's rule (models/resnet.py:
    # conv2d_backward), compared to the bit and timed
    from tools import trace_conv_determinism_torch as conv_trace

    conv_rows, conv_summary = conv_trace.trace(
        "train", conv_trace.capture_train_step(), repeats=2, settings=("default", "port"),
        kernel_names=False, emit=None)
    layer_table = [{k: r[k] for k in ("index", "layer", "branch", "w", "stride", "repeats",
                                      "ms")}
                   for r in conv_rows if r["same_as_index"] is None]
    del conv_rows
    torch.cuda.empty_cache()
    # s/step in turns on phase 11's batch: under the port's defaults, with
    # cudnn.deterministic pinned for the whole step, and with F.conv2d's own
    # gradients in place of models/resnet.py: conv2d (cuDNN's default
    # algorithms, as before the repair: not repeatable)
    from os2d_torch.models import resnet as resnet_module
    from os2d_torch.models import transform_net as transform_net_module

    port_conv2d = resnet_module.conv2d
    pin_times = {"port_defaults": [], "global_pin": [], "cudnn_defaults": []}
    try:
        for _ in range(DETERMINISM_TIMED_ROUNDS):
            for name in ("port_defaults", "global_pin", "cudnn_defaults", "cudnn_defaults",
                         "global_pin", "port_defaults"):
                torch.backends.cudnn.deterministic = name == "global_pin"
                resnet_module.conv2d = transform_net_module.conv2d = (
                    F.conv2d if name == "cudnn_defaults" else port_conv2d)
                step(arrays, c_pad)  # the first step after a switch selects algorithms
                for _ in range(DETERMINISM_TIMED_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(arrays, c_pad)
                    torch.cuda.synchronize()
                    pin_times[name].append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = saved_deterministic
        resnet_module.conv2d = transform_net_module.conv2d = port_conv2d
    emit({"phase": "determinism", "backward_shape": [b, c, h, w],
          "backward_two_calls_bit_equal": bwd_calls,
          "train_steps": DETERMINISM_STEPS, "trainings": trainings,
          "conv_layers": layer_table,
          "conv_summary": {k: conv_summary[k] for k in ("convolutions", "distinct", "parted",
                                                        "parted_kinds", "not_repeating",
                                                        "ms_sum")},
          "step_s": pin_times,
          "median_step_s": {k: float(np.median(v)) for k, v in pin_times.items()}})
    if not all(bwd_calls.values()):
        raise SystemExit(f"determinism: two backward calls differ: {bwd_calls}")
    for name, run in trainings.items():
        if not (run["weights_bit_equal"] and run["losses_equal"]):
            raise SystemExit(f"determinism: two trainings from one seed differ ({name}): "
                             f"{run}")
    if any(conv_summary["not_repeating"]["port"].values()):
        raise SystemExit(f"determinism: convolution gradients that do not repeat under the "
                         f"port's rule: {conv_summary['not_repeating']['port']}")
    del g, g_sum, corr, px, py, mask_t

    # ---- 12. NMS above dense_limit (the block-sequential path) ----
    # exact keep masks on the same candidates on the card and the CPU: the
    # cross-class NMS of ROADMAP's fault (33 rows x top_k 256 = 8448 boxes),
    # and one per-row NMS over all 39,580 anchors of a bench image
    nms_rng = np.random.default_rng(0)
    g33_level = FeatureMapSize(w=320, h=320)
    g33_a = 20 * 20
    g33_loc = torch.from_numpy(nms_rng.normal(0, 0.1, (NMS_G, 4, g33_a)).astype(np.float32))
    g33_cls = torch.from_numpy(nms_rng.uniform(-1, 1, (NMS_G, g33_a)).astype(np.float32))
    g33_kw = dict(nms_iou_threshold=0.3, pre_top_k=1024, top_k=256)
    per_row = decode_pyramid([g33_loc], [g33_cls], [g33_level], [(1.0, 1.0)], **g33_kw)
    g33_in = (per_row["boxes"].reshape(-1, 4), per_row["scores"].reshape(-1),
              per_row["valid"].reshape(-1))
    g33_decode = {}
    for dev in ("cuda", "cpu"):
        out = decode_pyramid([g33_loc.to(dev)], [g33_cls.to(dev)], [g33_level], [(1.0, 1.0)],
                             nms_across_classes=True, **g33_kw)
        g33_decode[dev] = {k: v.cpu() for k, v in out.items()}
    g33_keep = {dev: nms.nms_keep_mask(*(x.to(dev) for x in g33_in), 0.3).cpu()
                for dev in ("cuda", "cpu")}
    row_in = []
    for lvl, (sz, fm) in enumerate(zip(sizes, fms)):
        a = fm.h * fm.w
        row_loc = torch.from_numpy(nms_rng.normal(0, 0.1, (1, NMS_ROW_G, 4, a)).astype(np.float32))
        row_cls = torch.from_numpy(nms_rng.uniform(-1, 1, (1, NMS_ROW_G, a)).astype(np.float32))
        row_in.append(decode_single_level(row_loc, row_cls, default_boxes_for_image_size(sz),
                                          (sz.w, sz.h), inv[lvl], float("-inf")))
    row_in = [torch.cat(parts, dim=-2 if parts[0].dim() == 4 else -1) for parts in zip(*row_in)]
    row_keep, row_s, row_sweeps = {}, {}, {}
    for dev in ("cpu", "cuda", "cuda"):  # the second card run is the timed one
        args = [x.to(dev) for x in row_in]
        nms.fixpoint_sweeps = 0
        t0 = time.perf_counter()
        row_keep[dev] = nms.nms_keep_mask(*args, 0.3).cpu()
        row_s[dev] = time.perf_counter() - t0
        row_sweeps[dev] = nms.fixpoint_sweeps
    g33_decode_equal = (torch.equal(g33_decode["cuda"]["valid"], g33_decode["cpu"]["valid"])
                        and torch.equal(g33_decode["cuda"]["scores"], g33_decode["cpu"]["scores"]))
    g33_box_err = float((g33_decode["cuda"]["boxes"] - g33_decode["cpu"]["boxes"]).abs().max())
    emit({"phase": "nms_blocked",
          "cross_class": {"rows": NMS_G, "boxes": int(g33_in[0].shape[0]),
                          "kept": int(g33_keep["cuda"].sum()),
                          "keep_equal": torch.equal(g33_keep["cuda"], g33_keep["cpu"]),
                          "decode_valid_and_scores_equal": g33_decode_equal,
                          "decode_box_max_abs_err": g33_box_err},
          "per_row": {"shape": list(row_in[1].shape), "kept": row_keep["cuda"].sum(-1).tolist(),
                      "keep_equal": torch.equal(row_keep["cuda"], row_keep["cpu"]),
                      "ms": row_s["cuda"] * 1e3, "cpu_ms": row_s["cpu"] * 1e3,
                      "fixpoint_sweeps": row_sweeps["cuda"],
                      "host_waits": row_sweeps["cuda"], "blocks": -(-row_in[1].shape[-1] // 2048)}})
    if not torch.equal(g33_keep["cuda"], g33_keep["cpu"]):
        raise SystemExit("nms_blocked: the cross-class keep mask differs between card and CPU")
    if not torch.equal(row_keep["cuda"], row_keep["cpu"]):
        raise SystemExit("nms_blocked: the per-row keep mask differs between card and CPU")
    if not 0 < int(g33_keep["cuda"].sum()) < int(g33_in[2].sum()):
        raise SystemExit("nms_blocked: the cross-class NMS suppressed nothing or everything")

    # ---- 13. numeric modes: BN folding and bf16 compute ----
    base_state = model.state_dict()

    def mode_model(compute_dtype, folded, device="cuda", state=base_state):
        m = Os2dModel(Os2dConfig(compute_dtype=compute_dtype), device=device)
        m.load_state_dict({k: v.to(device) for k, v in state.items()})
        return fold_inference_params(m) if folded else m

    planted_cfg = get_default_cfg()
    planted_cfg.tpu.eval_pre_top_k = 256
    planted_cfg.tpu.eval_top_k = 16
    planted_class_images = [(torch.from_numpy(p).float() / 255.0 - torch.tensor(norm["mean"]))
                            / torch.tensor(norm["std"]) for p in patches]

    def planted_detections(m):
        ev_m = Evaluator(m, planted_cfg)
        head_m, _ = ev_m.build_class_heads(planted_class_images)
        return unpack_detections(ev_m.detect_images(scenes, head_m, level, [(1.0, 1.0)], norm))

    # (a) fp32 folded against fp32 unfolded on the card
    reset_counts()
    fold_dets = planted_detections(mode_model("float32", True))
    fold_counts = read_counts()
    fold_agree = detections_agree(fold_dets, planted_detections(model))

    # (b) bf16, folded and unfolded, the card against the CPU stage by stage
    # on the CPU's own inputs (the stem, each bottleneck, the class bank from
    # the C4 features, the head), by the bf16 rule; on a 256x320 crop of the
    # first scene that holds its planted patch, to bound the CPU's time
    x_cpu = ((torch.from_numpy(scenes[:1, :256, :320]).float() / 255.0
              - torch.tensor(norm["mean"])) / torch.tensor(norm["std"])).permute(0, 3, 1, 2)
    # a non-zero final TransformNet layer, so that theta, loc and corners vary
    # (random weights give the identity transform)
    stage_state = dict(base_state)
    stage_state["transform_net.linear.weight"] = 0.02 * torch.randn(
        base_state["transform_net.linear.weight"].shape, generator=torch.Generator().manual_seed(1))
    bf16_ratios, bf16_conv_ratios, bf16_dtypes = {}, {}, {}
    for folded in (False, True):
        mode = "bf16_fold" if folded else "bf16"
        card16 = mode_model("bfloat16", folded, state=stage_state)
        cpu16 = mode_model("bfloat16", folded, "cpu", stage_state)
        cpu32 = mode_model("float32", folded, "cpu", stage_state)
        ratios, conv_ratios = {}, {}

        def rule(name, got, want16, want32, into=ratios):
            if got.dtype != want16.dtype:
                raise SystemExit(f"numeric_modes {mode} {name}: dtype {got.dtype} on the card, "
                                 f"{want16.dtype} on the CPU")
            into[name] = bf16_ratio(got.cpu().float(), want16.float(), want32.float())

        with torch.no_grad():
            # every convolution of the backbone on the CPU's own input
            convs = [{n: c for n, c in m.backbone.named_modules() if isinstance(c, Conv2d)}
                     for m in (card16, cpu16, cpu32)]
            seen = []
            hooks = [c.register_forward_hook(
                lambda mod, args, out, n=n: seen.append((n, args[0], out)))
                for n, c in convs[1].items()]
            try:
                cpu16.backbone(x_cpu.permute(0, 2, 3, 1))
            finally:
                for h in hooks:
                    h.remove()
            for n, x, out16 in seen:
                rule(n, convs[0][n](x.cuda(), torch.bfloat16), out16,
                     convs[2][n](x.float(), torch.float32), conv_ratios)
            del seen
            # then the stages, each on the CPU's output of the stage before
            want16, want32 = cpu16.backbone.stem(x_cpu), cpu32.backbone.stem(x_cpu)
            rule("stem", card16.backbone.stem(x_cpu.cuda()), want16, want32)
            for i, (blk_card, blk16, blk32) in enumerate(zip(
                    card16.backbone.blocks(), cpu16.backbone.blocks(), cpu32.backbone.blocks())):
                x = want16
                want16, want32 = blk16(x, torch.bfloat16), blk32(x.float(), torch.float32)
                rule(f"block{i}", blk_card(x.cuda(), torch.bfloat16), want16, want32)
            fm = want16.permute(0, 2, 3, 1)
            bank16 = head_module.build_class_head(fm)
            bank_card = head_module.build_class_head(fm.cuda())
            if fm.dtype == torch.bfloat16:
                rule("class_feats", bank_card.class_feats, bank16.class_feats,
                     head_module.build_class_head(fm.float()).class_feats)
            bank_card = head_module.ClassHead(bank16.class_feats.cuda(), bank16.pool_mask.cuda())
            out16 = cpu16.apply_head(fm, bank16)
            out32 = cpu32.apply_head(fm.float(), head_module.ClassHead(
                bank16.class_feats.float(), bank16.pool_mask.float()))
            reset_counts()
            out_card = card16.apply_head(fm.cuda(), bank_card)
            torch.cuda.synchronize()
            if read_counts()["hat_resample_correlation"] != 1:
                raise SystemExit(f"numeric_modes {mode}: the head did not launch the hat kernel")
            for key in ("cls", "loc", "corners"):
                rule(key, out_card[key], out16[key], out32[key])
        bf16_ratios[mode] = ratios
        bf16_conv_ratios[mode] = conv_ratios
        bf16_dtypes[mode] = {"features": str(fm.dtype),
                             "class_feats": str(bank16.class_feats.dtype),
                             "pool_mask": str(bank16.pool_mask.dtype),
                             "cls": str(out16["cls"].dtype)}
        del card16, cpu16, cpu32

    # (c) evaluate() with cfg.tpu.fold_bn, the card against the CPU
    fold_eval_cfg = eval_cfg.clone()
    fold_eval_cfg.tpu.fold_bn = True
    cpu_model = mode_model("float32", False, "cpu")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_planted_dataset(root)
        dataset = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted", image_size=640,
            eval_scale=640, cache_images=True)
        loader = DataloaderOneShotDetection(dataset, batch_size=1,
                                            pyramid_scales_eval=EVAL_PYRAMID)
        reset_counts()
        fold_results = evaluate(loader, model, fold_eval_cfg)
        fold_eval_counts = read_counts()
        fold_cpu_results = evaluate(loader, cpu_model, fold_eval_cfg)
    del cpu_model
    emit({"phase": "numeric_modes",
          "fp32_fold_vs_fp32": {"detections_agree": fold_agree, "score_atol": 1e-4,
                                "box_atol": 1e-2, "valid": int(fold_dets["valid"].sum()),
                                "launches": fold_counts},
          "bf16_rule_per_conv": BF16_RULE, "bf16_rule_per_stage": BF16_STAGE_RULE,
          "bf16_conv_ratio_card_vs_cpu": {m: {"convs": len(r), "max": max(r.values()),
                                              "worst": max(r, key=r.get)}
                                          for m, r in bf16_conv_ratios.items()},
          "bf16_stage_ratio_card_vs_cpu": bf16_ratios,
          "bf16_dtypes": bf16_dtypes,
          "evaluate_fold_bn": {"mAP@0.50": fold_results["mAP@0.50"],
                               "cpu_mAP@0.50": fold_cpu_results["mAP@0.50"],
                               "launches": fold_eval_counts}})
    if not fold_agree:
        raise SystemExit("numeric_modes: fp32 folded detections differ from the unfolded ones")
    require_launches("numeric_modes", fold_counts, "hat_resample_correlation")
    for m in bf16_ratios:
        if not (max(bf16_conv_ratios[m].values()) <= BF16_RULE
                and max(bf16_ratios[m].values()) <= BF16_STAGE_RULE):
            raise SystemExit(f"numeric_modes: {m} breaks the bf16 rule on the card: "
                             f"{bf16_conv_ratios[m]} {bf16_ratios[m]}")
    if not (fold_results["mAP@0.50"] >= 0.9
            and fold_results["mAP@0.50"] == fold_cpu_results["mAP@0.50"]):
        raise SystemExit(f"numeric_modes: evaluate() with fold_bn gives mAP@0.50 "
                         f"{fold_results['mAP@0.50']} on the card, "
                         f"{fold_cpu_results['mAP@0.50']} on the CPU")
    require_launches("numeric_modes", fold_eval_counts, "hat_resample_correlation")

    # ---- 14. the modes in turns at the bench protocol ----
    mode_runs = {}
    for name, compute_dtype, folded in NUMERIC_MODES:
        ev_m = Evaluator(mode_model(compute_dtype, folded), cfg)
        head_m, _ = ev_m.build_class_heads(class_images)
        ev_m.detect_images(batches[-1], head_m, sizes, inv, norm)  # warmup
        mode_runs[name] = (ev_m, head_m)
    torch.cuda.synchronize()
    names = [n for n, _, _ in NUMERIC_MODES]
    mode_times = {n: [] for n in names}
    for i, name in enumerate((names + names[::-1]) * NUMERIC_ROUNDS):
        ev_m, head_m = mode_runs[name]
        reset_counts()
        t0 = time.perf_counter()
        out = ev_m.detect_images(batches[i % TIMED_DISPATCHES], head_m, sizes, inv, norm)
        torch.cuda.synchronize()
        mode_times[name].append(time.perf_counter() - t0)
        require_launches(f"numeric_timing {name}", read_counts(), "hat_resample_correlation",
                         len(PYRAMID))
        d = unpack_detections(out)
        if not (np.isfinite(d["scores"][d["valid"]]).all() and d["valid"].any()):
            raise SystemExit(f"numeric_timing {name}: non-finite or no detections")
    mode_median = {n: float(np.median(v)) for n, v in mode_times.items()}
    emit({"phase": "numeric_timing", "order": "fp32, fp32_fold, bf16, bf16_fold, and back",
          "images": f"{BATCH}x{IMG_W}x{IMG_H} uint8", "levels": len(PYRAMID),
          "classes": NUM_CLASSES, "resample_precision": "default", "dispatch_s": mode_times,
          "median_dispatch_ms": {n: m * 1e3 for n, m in mode_median.items()},
          "spread_ms": {n: [min(v) * 1e3, max(v) * 1e3] for n, v in mode_times.items()},
          "img_per_s": {n: BATCH / m for n, m in mode_median.items()},
          "hat_launches_per_dispatch": len(PYRAMID)})

    # ---- 15. the first train step at bf16, the card against the CPU ----
    bf16_train = Os2dModel(Os2dConfig(compute_dtype="bfloat16"), seed=1)
    cpu_bf16_train = Os2dModel(Os2dConfig(compute_dtype="bfloat16"), device="cpu")
    cpu_bf16_train.load_state_dict({k: v.cpu() for k, v in bf16_train.state_dict().items()})
    first16 = {}
    for dev, m in (("cuda", bf16_train), ("cpu", cpu_bf16_train)):
        opt = create_optimizer(train_cfg.train.optim, trainable_parameters(m, train_cfg.train))
        step16 = TrainStep(m, first_objective, opt, train_cfg.train)
        arrays16, c_pad16 = prepare_batch_arrays(train_batch, m.device)
        if dev == "cuda":
            reset_counts()
        first16[dev] = step16(arrays16, c_pad16)
        if dev == "cuda":
            torch.cuda.synchronize()
            first16_counts = read_counts()
    del bf16_train, cpu_bf16_train, step16, arrays16
    # |card - CPU| within BF16_STEP_RULE times |CPU bf16 - CPU fp32|, or
    # within phase 9's fp32 tolerance where bf16 moves a scalar less than the
    # card and the CPU differ anyway (at random weights the loss moved 3e-6)
    step_err = {k: abs(first16["cuda"][k] - first16["cpu"][k]) for k in first16["cpu"]}
    step_bound = {k: max(BF16_STEP_RULE * abs(first16["cpu"][k] - first["cpu"][k]),
                         TRAIN_CPU_RTOL * abs(first16["cpu"][k])) for k in first16["cpu"]}
    emit({"phase": "train_first_step_bf16", "margin_pos": FIRST_STEP_MARGIN_POS,
          "cuda": first16["cuda"], "cpu": first16["cpu"], "cpu_fp32": first["cpu"],
          "abs_err": step_err, "bound": step_bound, "bf16_step_rule": BF16_STEP_RULE,
          "rtol": TRAIN_CPU_RTOL, "launches": first16_counts})
    if not all(np.isfinite(v) for v in first16["cuda"].values()):
        raise SystemExit(f"train_first_step_bf16: non-finite metrics {first16['cuda']}")
    for k in ("loss", "grad_norm"):
        if not step_err[k] <= step_bound[k]:
            raise SystemExit(f"train_first_step_bf16: {k} {first16['cuda'][k]} on the card, "
                             f"{first16['cpu'][k]} on the CPU (fp32 {first['cpu'][k]})")
    require_launches("train_first_step_bf16", first16_counts, "hat_resample_correlation", 1)
    require_launches("train_first_step_bf16", first16_counts, "resample_correlation_backward", 1)

    # ---- 16. hard-patch mining at the default recipe ----
    # get_default_cfg()'s mining recipe (2 random pyramid scales, 200
    # negative classes: all of them here, 10 patches per image, NMS IoU 0.5)
    # on the planted train set at the default tier: the card against the CPU
    # from the same weights and seeds on MINING_CPU_IMAGES images, then every
    # image on the card, with the hat kernel once per (batch, level, chunk)
    mine_cfg = get_default_cfg()
    mining_recipe = {k: mine_cfg.train.mining[k] for k in (
        "num_random_pyramid_scales", "num_random_negative_classes",
        "num_hard_patches_per_image", "nms_iou_threshold_in_mining")}
    mine_model = Os2dModel(Os2dConfig(), seed=2)
    cpu_mine_model = mode_model("float32", False, "cpu", mine_model.state_dict())
    mined = {}
    for dev, m in (("cuda", mine_model), ("cpu", cpu_mine_model)):
        mine_loader, _ = build_train_dataloader_from_config(mine_cfg, mine_subset, seed=0)
        t0 = time.perf_counter()
        mined[dev] = mine_hard_patches(mine_loader, m, mine_cfg, objective)
        mined[dev + "_s"] = time.perf_counter() - t0
    del cpu_mine_model
    mine_disagree, mine_err = mined_records_disagree(mined["cuda"], mined["cpu"], TRAIN_CPU_RTOL,
                                                     MINING_ATOL)
    mine_loader, _ = build_train_dataloader_from_config(mine_cfg, train_set, seed=0)
    mine_batches = -(-TRAIN_IMAGES // int(mine_cfg.eval.batch_size))
    mine_expected = (mine_batches * int(mine_cfg.train.mining.num_random_pyramid_scales)
                     * -(-TRAIN_CLASSES // int(mine_cfg.tpu.eval_class_chunk)))
    reset_counts()
    t0 = time.perf_counter()
    mined_all = mine_hard_patches(mine_loader, mine_model, mine_cfg, objective)
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    mine_counts = read_counts()
    roles = {}
    for recs in mined_all.values():
        for r in recs:
            roles[r["role"]] = roles.get(r["role"], 0) + 1
    mine_finite = all(np.isfinite([r["loss"], r["loss_loc"], r["score"]]).all()
                      and np.isfinite(r["transform_corners"]).all()
                      for recs in mined_all.values() for r in recs)
    emit({"phase": "mining", "recipe": mining_recipe, "classes": TRAIN_CLASSES,
          "cpu_images": MINING_CPU_IMAGES,
          "cuda_matches_cpu": mine_disagree is None, "disagreement": mine_disagree,
          "max_abs_err": mine_err, "rtol": TRAIN_CPU_RTOL, "atol": MINING_ATOL,
          "cuda_s_subset": mined["cuda_s"], "cpu_s_subset": mined["cpu_s"],
          "images": len(mined_all), "seconds": mine_s, "s_per_image": mine_s / len(mined_all),
          "records_by_role": roles, "launches": mine_counts,
          "expected_hat_launches": mine_expected})
    if mine_disagree is not None:
        raise SystemExit(f"mining: the card's records differ from the CPU's: {mine_disagree}")
    if sorted(mined_all) != sorted(train_set.image_ids) or not {"neg", "pos"} <= set(roles):
        raise SystemExit(f"mining: records for {sorted(mined_all)}, roles {roles}")
    if not mine_finite:
        raise SystemExit("mining: non-finite losses, scores or corners")
    require_launches("mining", mine_counts, "hat_resample_correlation", mine_expected)

    # ---- 17. trainval_loop with mining and the device class cache ----
    tm_cfg = get_default_cfg()
    tm_cfg.train.optim.max_iter = TRAIN_STEPS
    tm_cfg.eval.iter = TRAIN_STEPS
    tm_cfg.train.mining.do_mining = True
    tm_cfg.train.mining.mine_hard_patches_iter = MINE_ITER
    tm_cfg.tpu.device_class_cache = "required"
    tm_loader, _ = build_train_dataloader_from_config(tm_cfg, train_set, seed=0)
    tm_opt = create_optimizer(tm_cfg.train.optim, trainable_parameters(mine_model, tm_cfg.train))
    mined_at, steps, batch_checks, replayed = [], [], [], []
    orig_mine, orig_one = train_module.mine_hard_patches, train_module.train_one_batch
    orig_prepare, orig_transform = tm_loader._prepare_batch, tm_loader._transform_image

    def mine_counted(*args, **kwargs):
        mined_at.append(len(steps))
        return orig_mine(*args, **kwargs)

    def one_counted(batch, *args, **kwargs):
        before = read_counts()
        meters = orig_one(batch, *args, **kwargs)
        after = read_counts()
        steps.append({"loss": meters["loss"], "grad_norm": meters["grad_norm"],
                      "class_images_from_host": batch["class_images"] is not None,
                      "launches": {k: after[k] - before[k] for k in after}})
        return meters

    def transform_replayed(image_id, boxes, mined_data=None, **kwargs):
        if mined_data is not None:
            replayed.append(mined_data["label_global"])
        return orig_transform(image_id, boxes, mined_data=mined_data, **kwargs)

    def prepare_checked(image_ids):
        replayed.clear()
        batch = orig_prepare(image_ids)
        batch_checks.append({"mined_labels": list(replayed),
                             "held": set(replayed) <= set(batch["class_ids"])})
        return batch

    train_module.mine_hard_patches, train_module.train_one_batch = mine_counted, one_counted
    tm_loader._prepare_batch, tm_loader._transform_image = prepare_checked, transform_replayed
    reset_counts()
    t0 = time.perf_counter()
    try:
        tm_log, _ = trainval_loop(tm_loader, mine_model, tm_cfg, objective, tm_opt)
    finally:
        train_module.mine_hard_patches, train_module.train_one_batch = orig_mine, orig_one
    torch.cuda.synchronize()
    tm_s = time.perf_counter() - t0
    tm_counts = read_counts()
    emit({"phase": "train_mining", "steps": TRAIN_STEPS, "mine_hard_patches_iter": MINE_ITER,
          "device_class_cache": "required", "mined_at_iterations": mined_at,
          "steps_log": steps, "batches": batch_checks, "seconds": tm_s, "launches": tm_counts})
    if mined_at != list(range(0, TRAIN_STEPS, MINE_ITER)):
        raise SystemExit(f"train_mining: mined at iterations {mined_at}")
    if tm_loader.device_class_cache is None or any(s["class_images_from_host"] for s in steps):
        raise SystemExit("train_mining: the device class cache did not serve the class images")
    if len(batch_checks) != TRAIN_STEPS or not all(
            len(b["mined_labels"]) == tm_cfg.train.batch_size and b["held"]
            for b in batch_checks):
        raise SystemExit(f"train_mining: batches without their mined labels: {batch_checks}")
    if len(steps) != TRAIN_STEPS or not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                                            for s in steps):
        raise SystemExit(f"train_mining: steps {steps}")
    for s_ in steps:
        require_launches("train_mining", s_["launches"], "hat_resample_correlation", 1)
        require_launches("train_mining", s_["launches"], "resample_correlation_backward", 1)

    # ---- 18. the device class cache: the stack, its gather, s/step ----
    cc_cfg = get_default_cfg()
    cc_loaders = {}
    for name in ("host", "cache"):
        cc_loaders[name], _ = build_train_dataloader_from_config(cc_cfg, train_set, seed=0)
    cache = DeviceClassCache.build(cc_loaders["cache"], "cuda",
                                   budget_mb=int(cc_cfg.tpu.device_class_cache_budget_mb))
    cc_loaders["cache"].attach_device_class_cache(cache)
    cpu_cache = DeviceClassCache(cache.class_ids, cache.index_of, cache.sizes, cache.stack.cpu())
    flips_equal = all(
        torch.equal(cache.gather(cache.class_ids, [m] * TRAIN_CLASSES, hf, vf, TRAIN_CLASSES).cpu(),
                    cpu_cache.gather(cache.class_ids, [m] * TRAIN_CLASSES, hf, vf, TRAIN_CLASSES))
        for m in range(6) for hf in (False, True) for vf in (False, True))
    methods_seen, cc_equal, cc_batches = set(), True, 0
    while len(methods_seen) < 6 and cc_batches < CACHE_CHECK_BATCHES:
        hb, cb = (cc_loaders[n].get_batch(cc_batches % len(train_loader)) for n in ("host", "cache"))
        g = cb["class_gather"]
        ha, h_pad = prepare_batch_arrays(hb, "cuda")
        ca, c_pad = prepare_batch_arrays(cb, "cuda")
        n_real = len(hb["class_ids"])
        cc_equal &= (hb["class_ids"] == cb["class_ids"] and h_pad == c_pad
                     and not (g["hflip"] or g["vflip"])
                     and np.array_equal(hb["images"], cb["images"])
                     and torch.equal(ha["class_images"][:n_real], ca["class_images"][:n_real])
                     and torch.equal(ha["class_valid"], ca["class_valid"]))
        methods_seen.update(g["method_idx"])
        cc_batches += 1
    cc_step = TrainStep(train_model, objective, train_opt, train_cfg.train)
    cc_times = {"host": [], "cache": []}
    cc_batch_s = {"host": [], "cache": []}
    reset_counts()
    for i, name in enumerate(["host", "cache", "cache", "host"] * CACHE_TIMING_ROUNDS):
        t0 = time.perf_counter()
        batch = cc_loaders[name].get_batch(i % len(train_loader))
        cc_batch_s[name].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        metrics = cc_step(*prepare_batch_arrays(batch, "cuda"))
        torch.cuda.synchronize()
        cc_times[name].append(time.perf_counter() - t0)
        if not np.isfinite(metrics["loss"]):
            raise SystemExit(f"class_cache: non-finite loss {metrics}")
    cc_counts = read_counts()
    emit({"phase": "class_cache", "classes": TRAIN_CLASSES, "methods": 6,
          "stack_shape": list(cache.stack.shape), "stack_mb": cache.nbytes / 2**20,
          "unflipped_batches_equal_host_path": cc_equal, "batches_checked": cc_batches,
          "methods_seen": sorted(methods_seen), "gather_card_equals_cpu_all_flips": flips_equal,
          "order": "host, cache, cache, host, ...", "step_s": cc_times,
          "median_step_s": {k: float(np.median(v)) for k, v in cc_times.items()},
          "step_s_spread": {k: [min(v), max(v)] for k, v in cc_times.items()},
          "median_batch_build_s": {k: float(np.median(v)) for k, v in cc_batch_s.items()},
          "launches": cc_counts})
    if not (cc_equal and flips_equal and len(methods_seen) == 6):
        raise SystemExit(f"class_cache: gathered class images differ (host path equal: "
                         f"{cc_equal}, methods {sorted(methods_seen)}, flips equal: {flips_equal})")
    require_launches("class_cache", cc_counts, "hat_resample_correlation", 4 * CACHE_TIMING_ROUNDS)
    require_launches("class_cache", cc_counts, "resample_correlation_backward",
                     4 * CACHE_TIMING_ROUNDS)
    del cache, cpu_cache, cc_loaders, cc_step

    # ---- 19. evaluate() through the host-built pyramid ----
    hp_cfg = get_default_cfg()
    hp_cfg.eval.mAP_iou_thresholds = [0.5]
    hp_cfg.tpu.device_side_pyramid = False
    hp_cfg.tpu.eval_pre_top_k = 256
    hp_cfg.tpu.eval_top_k = 32
    cpu_model = mode_model("float32", False, "cpu")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        df = write_planted_dataset(root)
        dataset = DatasetOneShotDetection(
            df, gt_path=os.path.join(root, "classes", "images"),
            image_path=os.path.join(root, "src"), name="planted", image_size=640,
            eval_scale=640, cache_images=True)
        loader = DataloaderOneShotDetection(dataset, batch_size=1,
                                            pyramid_scales_eval=EVAL_PYRAMID)
        reset_counts()
        t0 = time.perf_counter()
        hp_results = evaluate(loader, model, hp_cfg)
        torch.cuda.synchronize()
        hp_s = time.perf_counter() - t0
        hp_counts = read_counts()
        hp_cpu_results = evaluate(loader, cpu_model, hp_cfg)
    del cpu_model
    hp_expected = len(PLANTED) * len(EVAL_PYRAMID)  # batch 1, one class chunk
    emit({"phase": "evaluate_host_pyramid", "levels": EVAL_PYRAMID,
          "mAP@0.50": hp_results["mAP@0.50"], "recall@0.50": hp_results["recall@0.50"],
          "cpu_mAP@0.50": hp_cpu_results["mAP@0.50"], "seconds": hp_s,
          "launches": hp_counts, "expected_hat_launches": hp_expected})
    if not (hp_results["mAP@0.50"] == 1.0 == hp_cpu_results["mAP@0.50"]):
        raise SystemExit(f"evaluate_host_pyramid: mAP@0.50 {hp_results['mAP@0.50']} on the "
                         f"card, {hp_cpu_results['mAP@0.50']} on the CPU")
    require_launches("evaluate_host_pyramid", hp_counts, "hat_resample_correlation", hp_expected)

    # ---- 20./21. a checkpoint cascade into card models, then serving ----
    serve_counts = checkpoint_and_serve(types.SimpleNamespace(
        reset=reset_counts, read=read_counts, require=require_launches),
        profile="--profile" in argv)

    # ---- 22. the mesh: data-parallel steps and sharded evals in other processes ----
    dist_batches = [train_loader.get_batch(i % len(train_loader)) for i in range(DIST_STEPS)]
    dist_counts = distributed_phase(
        train_cfg, [{k: b[k] for k in DIST_BATCH_KEYS} for b in dist_batches], require_launches)

    # ---- 23.-26. the model options: int8 tier and bank, grid path, GroupNorm ----
    option_launches = model_options(
        types.SimpleNamespace(reset=reset_counts, read=read_counts, require=require_launches),
        types.SimpleNamespace(
            model=model, base_state=base_state, scenes=scenes, norm=norm, cfg=cfg,
            batches=batches, sizes=sizes, inv=inv, class_images=class_images, ev=ev,
            class_head=class_head, eval_cfg=eval_cfg, eval_map=results["mAP@0.50"],
            planted_detections=planted_detections,
            planted_class_images=planted_class_images, train_batch=train_batch,
            train_cfg=train_cfg, first_objective=first_objective))

    # ---- 27.-29. evaluate()'s host side, per-level class chunks, the figures ----
    host_launches = host_side(
        types.SimpleNamespace(reset=reset_counts, read=read_counts, require=require_launches),
        types.SimpleNamespace(model=model, base_state=base_state, eval_cfg=eval_cfg, cfg=cfg,
                              batches=batches, sizes=sizes, train_set=train_set,
                              train_cfg=train_cfg, first_objective=first_objective))

    # ---- 30.-32. the yuv420 wire, the pretrainer, the checkpoint backend ----
    last_launches = last_modules(
        types.SimpleNamespace(reset=reset_counts, read=read_counts, require=require_launches),
        types.SimpleNamespace(model=model, base_state=base_state, eval_cfg=eval_cfg,
                              train_cfg=train_cfg, train_batch=train_batch,
                              first_objective=first_objective, train_model=train_model,
                              train_opt=train_opt, profile="--profile" in argv))

    # ---- 33./34. the experiment launchers' twins and the release runbook's ----
    entry_launches = entry_surfaces(
        types.SimpleNamespace(reset=reset_counts, read=read_counts, require=require_launches))

    if "--profile" in argv:
        profile_run("profile", lambda: ev.detect_images(batches[0], class_head, sizes, inv, norm),
                    main_median)
        for name in ("fp32_fold", "bf16_fold"):
            ev_m, head_m = mode_runs[name]
            profile_run(f"profile_{name}",
                        lambda: ev_m.detect_images(batches[0], head_m, sizes, inv, norm),
                        mode_median[name])
        profile_run("profile_train", lambda: step(arrays, c_pad), train_median)

    emit({"kernels": [{
        "name": "resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/resample.cu",
        "replaces": "os2d_tpu/ops/pallas_resample.py:24",
        "launches": (highest_counts["resample_correlation"] + serve_counts["resample_correlation"]
                     + dist_counts["resample_correlation"]
                     + host_launches["resample_correlation"]),
        "max_abs_err": max(errs["resample_correlation"].values()),
        "ms": gather_ms,
        "plain_ms": gather_plain_ms,
        "bound_ms": gather_bound_ms,
        "bound_by": gather_bound_by,
        "library_ms": gather_library_ms,
    }, {
        "name": "hat_resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/hat_resample.cu",
        "replaces": "os2d_tpu/ops/pallas_hat_resample.py:42",
        "launches": (main_counts["hat_resample_correlation"]
                     + serve_counts["hat_resample_correlation"]
                     + dist_counts["hat_resample_correlation"]
                     + host_launches["hat_resample_correlation"]
                     + last_launches["hat_resample_correlation"]
                     + entry_launches["hat_resample_correlation"]),
        "max_abs_err": max(errs["hat_resample_correlation"].values()),
        "ms": hat_ms,
        "plain_ms": hat_plain_ms,
        "bound_ms": hat_bound_ms,
        "bound_by": hat_bound_by,
        "library_ms": hat_library_ms,
    }, {
        "name": "int8_hat_resample_correlation",
        "route": "cuda",
        "source": "os2d_torch/csrc/int8_hat_resample.cu",
        "replaces": "os2d_tpu/ops/sampling.py:198",
        "launches": option_launches["int8_hat_resample_correlation"],
        "max_abs_err": max(errs["int8_hat_resample_correlation"].values()),
        "ms": int8_ms,
        "plain_ms": int8_plain_ms,
        "bound_ms": int8_bound_ms,
        "bound_by": int8_bound_by,
        "library_ms": int8_library_ms,
    }, {
        "name": "resample_correlation_backward",
        "route": "cuda",
        "source": "os2d_torch/csrc/resample_backward.cu",
        "replaces": "os2d_tpu/ops/sampling.py:147",
        "launches": (loop_counts["resample_correlation_backward"]
                     + dist_counts["resample_correlation_backward"]
                     + last_launches["resample_correlation_backward"]
                     + entry_launches["resample_correlation_backward"]),
        "max_abs_err": max(max(e.values())
                           for e in errs["resample_correlation_backward"].values()),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": bwd_library_ms,
    }] + [{
        "name": f"group_norm_{direction}",
        "route": "cuda",
        "source": "os2d_torch/csrc/group_norm_nhwc.cu",
        "replaces": "os2d_tpu/models/resnet.py:70",
        "launches": option_launches[f"group_norm_{direction}"],
        **gn_kernels[direction],
    } for direction in ("forward", "backward")] + [{
        "name": "frozen_bn_act",
        "route": "cuda",
        "source": "os2d_torch/csrc/frozen_bn_act_nhwc.cu",
        "replaces": "os2d_tpu/models/resnet.py:57",
        "launches": main_counts["frozen_bn_act"],
        **fbn_kernel,
    }]})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_run})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# kernel families of a dispatch's device time, by substring of the kernel
# name, first match wins
KERNEL_FAMILIES = (
    ("resample backward kernel", ("resample_backward",)),
    ("hat resample kernel", ("HatResample",)),
    ("resample kernel", ("GatherResample",)),
    ("conv FFT", ("fft", "pointwise_mult_and_sum_complex")),
    ("conv backward (dgrad, wgrad)", ("dgrad", "wgrad")),
    ("conv implicit GEMM", ("fprop", "convolve")),
    ("GEMM", ("gemm",)),
    ("layout and copies", ("Nhwc", "Nchw", "copy")),
)


def kernel_family(name):
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return "elementwise and other"


def is_annotation(evt):
    """A record_function range (Optimizer.step#SGD.step) that the profiler
    also reports on the device timeline: its time is its kernels', counted
    under their own names. A kernel's name may hold "#" too (a lambda's
    `{lambda()#1}`, in most of at::native's elementwise and reduce kernels),
    so "#" alone does not mark a range."""
    return getattr(evt, "is_user_annotation", False) or ("#" in evt.key and "(" not in evt.key)


def profile_run(phase, fn, untraced_s):
    """Device time by kernel over one call of fn, an eval dispatch or a train
    step (torch.profiler). The idle share is taken against the untraced
    median time, since the profiler's own start-up inflates the traced wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or is_annotation(evt):
            continue
        dev_us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    families = {}
    for ms, key, _ in rows:
        families[kernel_family(key)] = families.get(kernel_family(key), 0.0) + ms
    emit({"phase": phase, "traced_wall_ms": wall_ms, "device_ms": device_ms,
          "device_launches": sum(r[2] for r in rows),
          "untraced_ms": untraced_s * 1e3,
          "device_idle_share": (1 - device_ms / (untraced_s * 1e3)) if rows else None,
          "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
          "top": [{"kernel": k[:120], "ms": ms, "calls": n} for ms, k, n in rows[:25]]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
