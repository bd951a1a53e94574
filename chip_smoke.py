#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (us_video_medsam2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions, and
   its free memory; where less than ``MEMORY_NEED_GIB`` is free (another
   process holds the rest), a wait of up to ``MEMORY_WAIT_S`` for it;
2. the build: every ``csrc/*.cu`` kernel compiled for sm_90a (timed as set-up),
   with the registers and spills that ``-Xptxas -v`` reports for the kernels
   of ``flash_dropout.cu`` (the forward and its combine must be there),
   ``layer_norm.cu``, ``ln_mlp_residual.cu`` (every
   D, with and without the hidden split, and the combine), ``cxblock.cu``,
   the two window-attention sources (both head-dim instantiations) and
   ``window_attention_v1.cu`` (a spill fails the run); every (head dim, key
   tiles) instantiation of the window-attention kernel and of its qkv
   variant, and every key-tiles and projection-tile instantiation of v1's
   two kernels, must be there, its registers printed beside those
   ``window_tiles``' and the ``plan_for``s' occupancy tables assume (phase
   3 holds the tables' blocks an SM against the card's);
3. each kernel against its plain PyTorch version at every shape the main path
   gives it, in bf16: max abs / rel error against the stated tolerance, and
   times (CUDA events over runs of back-to-back launches) of the kernel, the
   plain version and, where one PyTorch call computes the same function, that
   call (``library_ms``); the
   bound is max(bytes / 3.35 TB/s, flops / peak) from the shapes (bf16 tensor
   peak 989 TFLOP/s for products, 67 TFLOP/s f32 for LayerNorm); the
   attention checks are scaled to the output, and the flash check must reject
   the plain version run with the 24 valid pointer keys masked. LayerNorm,
   MLP and window attention are held again, untimed, at the training path's
   shapes (one encoder call over T·B = 4 frames); each kernel once more at
   shapes off the main path (ragged tiles, batch and heads above 1, a fully
   masked batch; the flash kernel at batched serving's four rows, self and
   cross), against the same tolerance. The MLP kernel splits the
   hidden axis across blocks (``mlp_splits``, as many splits as one wave of
   blocks holds) at every main-path shape but the first: the blocks an SM
   holds at each D must be those ``mlp_splits`` assumes
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its device time per
   call (both kernels) is printed at each shape, two calls at a split shape must give the same bits, the plain model
   of the split must agree with the plain version and the check must reject
   that model combined without one split's partial. The gradient of each of these
   four wrappers (the kernel forward, the plain version's vjp recomputed) is
   held against autograd of the plain version at a training shape, and its
   backward must launch no kernel. The
   dropout flash kernels are held against the plain version and autograd of
   it (out, lse, dq, dk, dv) at the training path's memory self- and
   cross-attention shapes, at rates 0.1 and 0, with a check that must reject
   the plain version run with seed + 1, at edge shapes, and where the keep
   hash's element index passes 2^31 and 2^32. The forward deals the key
   tiles out to splits in turn (``fwd_splits``, one wave of the blocks an
   SM holds, which must be the card's
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; ``fwd_split_tiles``): at both training shapes two calls must
   give bit-identical out and lse, the plain model of the split must agree
   with the plain version and the check must reject that model combined
   without split 0's partial and without the exp(m_i - m) weights; it is
   held again, and repeated bit for bit, where one split's tiles are all
   masked beside valid ones, next to a batch with none valid; its
   device time per call and SDPA's forward with dropout 0.1 are printed,
   with the keep hash's integer floor beside the bound. The backward splits the
   queries of its dk/dv blocks and the keys of its dq blocks
   (``bwd_splits``): it is held again where the last ranges are ragged and
   a query range lies past Lq, where a key range holds only masked keys
   beside a batch with none valid, and where each has one split; two calls
   on the same inputs must give bit-identical dq, dk and dv, and the check
   must reject the plain split model combined without one query range's dk
   partial. LayerNorm and the dropout forward and backward, and
   ``F.layer_norm`` and SDPA's forward and backward beside them, also print
   their device time per call from
   torch.profiler's kernel events (the CUDA-event time of back-to-back
   calls is the host's at these sizes); so do the flash kernel (beside
   SDPA's) and CXBlock. The two kernels of the fused
   configuration are held at every shape the main path gives them (CXBlock
   at [1, 32, 32, 256] with layer scale 1 +- 0.1, on out and on out - x;
   the qkv window attention at the nine windowed blocks' geometries), again
   untimed at the training shapes and at B 2 edge shapes, with a check that
   must reject the plain CXBlock without its pwconv1 bias and one that must
   reject pad tokens whose q, k, v are 0 instead of the bias; their
   gradients as those of the four kernels above. The qkv kernel cuts its
   work by ``plan_for`` (windows a group, blocks a thread-block cluster):
   at every plan it picks, its shared memory and blocks an SM are
   the card's and its clusters at once give the card's waves
   (``cudaOccupancyMaxActiveClusters``); two calls give the same bits at
   every geometry; at the ws-14 blocks of t512 and S the plain model of the
   plan's split agrees with the plain version and the check must reject it
   with one cluster rank's K and V share left out; the unfused pair
   (``F.linear`` into the bias map, then the window-attention kernel) is
   timed beside it on the device, for information. The CXBlock kernel splits
   the channels and the hidden axis over the blocks of a thread-block
   cluster by ``plan_for`` (one cluster a token tile, the most splits whose
   clusters all run at once): at every shape two calls give the same bits,
   the plan's shared memory and blocks an SM are the card's and its clusters
   all run at once on the card; the plain model of the split agrees with the
   plain version and the check must reject it with one rank's partial left
   out of the combine; its device time at the training shape and that of
   the ``CXBlock`` module's default composition (switch unset) at B 1 and 3
   are printed beside the kernel's, for information. The flash kernel splits the
   keys across blocks (``flash_splits``): it is held again, untimed, where
   the last split is ragged, where a split holds only keys past Lk, where a
   split holds only masked keys (beside a batch with none valid) and where
   B·H fills the card with one split, and the check must reject the plain
   split model combined without the exp(m_i - m) weights. The unwired
   ``window_attention_v1`` (LN, per-head qkv, window attention and the
   output projection in one call) is held at the seven windowed t512
   geometries (timed, ln_inside as the block would take it, and untimed
   with the other value; device time per call printed) and at the six
   geometries of the JAX package's v1 test at B 2 with both ln_inside
   values, with a check that must reject
   the plain version whose pad tokens' LN output is 0 instead of beta, and
   its gradient as those above. v1 cuts its work by ``plan_for`` (windows a
   group, blocks a thread-block cluster, the output projection's tile): at
   every geometry two calls give the same bits and the plan's shared memory
   and blocks an SM (both kernels) are the card's and its clusters at once
   give the card's waves; at t512's unpooled ws-14 block the plain model of
   the plan's cut agrees with the plain version and the check must reject it
   with one head left out of the output projection's sum; its device time
   (by kernel) is printed beside that of the port's own compositions of the
   same blocks (the main path's calls, and the fused configuration's), for
   information. Window attention and its qkv variant are
   held and timed at head dim 64 too, at EfficientMedSAM-S's and -Ti's ws-14
   blocks ([1, 42, 42, 3·nh·64], nh 6 and 3, Cin 384 and 192), and again
   untimed at B 2 and with q-pooling on a 28x28 map. Window attention is held
   at every geometry at B 1, at B 4 (hd 96) and B 2 (hd 64), without and,
   where the map is padded, with the last-strip cut (``real_h``, as the
   models call it): with the cut the real rows must be bit-identical to the
   uncut call and the cut rows exact zeros, also at edge shapes whose last
   real slab is partial. The blocks an SM holds of each grid that
   ``window_tiles`` picks must be those its table assumes. The check must
   reject the plain output with heads 0 and 1 swapped, with each window's
   last real query slab zeroed, and the plain version over the keys padded
   to 208 without masking the pad keys. Window attention and its qkv variant
   print their device time per call (torch.profiler) at every geometry;
4. the main path: ``sam2.1_hiera_t512`` at full width in bf16 on the card with
   weights from a seeded generator (the object-score head's output bias is
   set to +10 so the object is present on every frame and the masks are not
   all "no object"), on a seeded video of smooth moving blobs:
   ``build_sam2_video_predictor`` -> ``init_state`` ->
   ``add_new_points_or_box`` (frame 0, one click) -> ``propagate_in_video``.
   Each tracked frame is one replay of the predictor's CUDA graph of its
   frame body (``inference/graphs.py``): a warm-up run captures it (its
   seconds, pool memory and captured launches printed), then each timed run
   is a new ``init_state`` of the same shape that must capture nothing, with
   the tracking window under ``torch.cuda.set_sync_debug_mode("error")`` (a
   host sync inside it fails the phase). Launch counters (counted at
   replay: a graph adds its captured counts at every replay) are zeroed
   just before and read just after and must equal 9 window-attention, 12
   LayerNorm and 12 MLP launches per encoded frame and 8 flash launches per
   tracked frame. The same runs with the frame body run eagerly on the card
   (``EagerBodies`` in place of the graphs; the same exact counts) are held
   against the graph runs: the same bits are expected, the gate is logit
   rel-L2 <= 1e-3 and mask IoU >= 0.999 outside the bf16 band, max |d|
   printed; ms per tracked frame of graph and eager are printed side by
   side. Then the weight matrices are cast to f32 and back to bf16 (the same
   values in new memory): the next run must capture anew (the kept graph
   read the old memory) and meet the same gate against the graph runs.
   After phase 5, the predictor must keep at most ``MAX_GRAPHS`` graphs
   (``inference/graphs.py``). The first frames are run again on the host CPU (plain versions,
   f32) with the same weights and compared per frame. Then the same model
   with ``precompute_features_batch=8`` (every frame encoded before the
   window in batches of 8): exact counts of 9 window-attention, 12
   LayerNorm and 12 MLP launches per batch of 8 (and once more for the
   prompted frame), held against the same host run;
5. the fused configuration: phase 4 again with the JAX package's two opt-in
   switches set (``US_MEDSAM2_ENABLE_FUSED_CXBLOCK``,
   ``US_MEDSAM2_FUSE_QKV_WINDOW_ATTN``; a graph of its own, since the
   switches are part of a graph's key): 9 qkv-window-attention and no
   window-attention launches per encoded frame, 2 CXBlock launches per
   memory encoding, the same LayerNorm, MLP and flash counts, graph against
   eager as in phase 4, the frames held against phase 4's host reference,
   and ms per tracked frame with the switches off and on printed side by
   side;
6. EfficientMedSAM-S: phases 4 and 5 for ``efficientmedsam_s_512`` (the
   ViTDet trunk at embed 384, 6 heads of 64) through
   ``build_efficienttam_video_predictor``, with the same seeded weights rule
   (and a margin on one IoU-head output, ``VIT_IOU_MARGIN``) and video: 8
   window-attention (head dim 64), 12 LayerNorm and 12 MLP launches per
   encoded frame and 8 flash per tracked frame; fused, 8
   qkv-window-attention and no window-attention launches per encoded frame
   and 2 CXBlock launches per memory encoding; graph against eager in both
   configurations, both held against one host f32 run;
7. the training path: the ``sam2.1_hiera_t512`` training step at full width
   (T = 4 frames, B = 1 video, O = 3 objects, ``TrainSimConfig()``, temporal
   consistency loss 0.5, AdamW with layer decay) in bf16 with f32 master
   weights on a seeded batch of moving blobs and their masks: one warm-up
   step, then ``TRAIN_STEPS`` timed steps with finite loss and gradient
   norm, a non-zero gradient in every parameter group, and exact launch
   counts (9 window-attention, 12 LayerNorm and 12 MLP per step, 8 dropout
   flash forward and 8 backward per tracked frame). Then one step with a
   fixed plan and memory-attention dropout off on the card, once more on the
   card with both switches set (exact qkv-window-attention and CXBlock
   counts), and on the host CPU (plain versions, f32): loss and
   whole-gradient agreement of each card step with the host's. Then the
   same step with temporal fusion ``GFTE_FUSION`` (``tools/
   bench_train_step.py``'s default: GFTE over the top 3 FPN levels at 256
   channels; the same seeded weights, the fusion's constants at their JAX
   initial values): warm-up and timed steps with a non-zero gradient in the
   fusion group, the BatchNorm buffers bit-identical after the steps and
   exactly the launches of the step without fusion (the fusion is plain
   PyTorch and launches none of the port's kernels); ms/step and peak memory
   beside the step without fusion; the fixed-plan step on the card against
   the host under the same gate. Last, seeded GFTE weights with drawn
   running statistics written as a reference-name ``.pt`` (the fusion's
   keys, ``num_batches_tracked`` included) and loaded through
   ``ckpt_path=``: its buffers hold the statistics, and phase 4's 16-frame
   run gives the bits of the same weights without fusion (serving passes no
   frame count, so no fusion runs); phase 7's seconds are printed;
8. the predictor's long-video and editing paths, ``sam2.1_hiera_t512`` at
   full width in bf16, default switches, the seeded weights of phase 4:
   (a) the weights written as a reference-name ``.pt`` (weights under
   "model"; ``to_reference_state_dict``, this script's own inverse of the
   port's importer) and a predictor built from it through ``ckpt_path=``:
   phase 4's 16-frame run gives the seeded predictor's bits, frame by frame;
   (b) a ``LONG_FRAMES``-frame uint8 study offloaded to the host
   (``offload_video_to_host``, the raw bytes) and streamed
   ``STREAM_CHUNK`` frames a chunk through page-locked buffers, each
   chunk's window sync-free, every frame yielded in order, held against the
   same video resident on the card (graph-vs-eager gate, the same bits
   expected); peak device memory of each run, the offloaded peak at least
   ``OFFLOAD_SAVING`` below the resident; a ``REPEAT_FRAMES``-frame video in
   the same bucket with no new capture and its peak within
   ``PEAK_SPREAD``; ms per tracked frame of both, and the idle share of a
   profiled streamed run; (c) 37 and 50 frames with ``t_bucket="auto"``
   (64 slots) in one capture, each held against its exact-shape session;
   (d) three objects clicked on frames 0 and 8 of phase 4's video
   (``non_overlap_masks`` and the scrub of non-conditioning memories on):
   propagation, ``remove_object``, ``clear_all_prompts_in_frame`` on frame
   8, a re-prompt with ``prev_low_res_mask``, propagation forward and in
   reverse, every yielded frame of each object held against the same
   sequence on the host CPU (plain versions, f32). Every run's launches are
   phase 4's per encoded and per tracked frame (a capture's warm-up counts
   as one frame of each);
9. the entry points, ``sam2.1_hiera_t512`` at full width in bf16 with the
   seeded weights of phase 4: (a) the five apps (``apps/infer_video``,
   ``infer_mri`` where PIL imports, ``infer_ct_recist``, ``infer_3d_ct``,
   ``infer_luna25``) through their ``main``s on the card, from the weights
   written as a reference-name ``.pt``, on seeded NPZ data (two 32-frame
   600x800 videos with classes 1 and 2, a 16-frame video, RECIST cases of 64
   slices at 512² and 400², a 32-slice HU volume): each output's shape and
   a non-empty mask, each app's launches exactly the predictor's (9 / 12 /
   12 an encoded frame, 8 flash a tracked frame, one of each a capture),
   and ``infer_case`` on a 16-slice case against the host (plain versions,
   f32; voxel IoU outside the bf16 band of the host's logits, the plain
   IoU printed); (b) batched serving (``inference/serve.py``) at 4 videos x
   16 frames at 512², the videos resident on the card: one capture on the
   first call and none on the next ones, no host sync inside the window,
   one video's launches (9 / 12 / 12 an encoded batch, 8 flash a tracked
   frame), the graph against the eager body (same bits expected), each
   video against the interactive predictor on the card (rel-L2 held on
   every frame, the IoU outside the band printed: two bf16 runs of other
   plans), 2 videos x 9 frames against the host (past the 7 memory slots,
   so the bank's selection runs at B = N: rel-L2 on every frame, the IoU
   outside the band at 0.99 on the first ``CHECK_FRAMES``, and on each
   video no lower than the interactive predictor's against the host, capped
   at 0.99), ms a call and aggregate
   tracked frames/s beside N 1; (c) the image path on a 600x800 image
   (``build_sam2_image_predictor``): ``set_image`` (9 / 12 / 12, no flash),
   every ``predict`` mode and ``predict_batch_points`` at 64 points against
   the host (low-res logits at the card-vs-host gate, the card's
   post-processing of the host's logits at the graph-vs-eager gate), the
   automatic mask generator at 32 points a side (a mask at least) and at 8
   against the host (the same count, masks matched at IoU >= 0.99), and
   the times of ``set_image``, ``predict`` and ``generate``;
10. the training entry point: ``apps/train.py``'s ``main`` on the
   card at ``sam2.1_hiera_t512`` full width, bf16 with f32 master weights,
   default switches, from the seeded weights of phase 4 written as a
   reference-name ``.pt`` (``--init_ckpt``), on a seeded corpus of
   ``TE_VIDEOS`` NPZ videos of ``TE_FRAMES`` 600x800 frames whose
   first-frame entropies let the quantum curriculum's dense stage keep all
   but one: (a) two epochs (``TE_ARGS``: T 4, 3 objects, batch 1, temporal
   consistency loss): two finite records in ``train_stats.json``, every
   file of the out-dir, each step exactly phase 7's launches (9 / 12 / 12,
   8 + 8 dropout-flash a tracked frame), ms a step with its data and step
   ms, peak device memory, the checkpoint writes' seconds; (b) ``main``
   again with three epochs on the same out-dir: it resumes at epoch 2 with
   the saved step and best, the restored parameters and AdamW moments
   bit-identical to the file, epoch 2's batches by hash those of a fresh
   loader; (c) ``checkpoint.npz`` served through ``ckpt_path=`` (the native
   route) over phase 4's 16 frames: phase 4's launches and the bits of a
   predictor built from the trainer's final state dict; (d) one epoch with
   ``--temporal_fusion gfte``: finite loss, the same launches, the
   BatchNorm buffers bit-identical; (e) one epoch as a one-rank NCCL group
   (``parallel/distributed.py``, the environment set here, a free port):
   finite loss, the same launches; (f) the native NPZ reader
   (``UVMS2_NATIVE_NPZ=1``) built and held against numpy on the corpus,
   every array's bytes (where ``zlib.h`` is missing this is printed and
   (a)-(e) stand on the default reader);
11. the EfficientTAM training half at ``efficientmedsam_s_512`` full width
   (ViT-S: embed 384, depth 12, 6 heads of 64, ws 14 in 8 blocks), bf16
   with f32 master weights, seeded weights: the window-attention calls of
   a training forward over T·B = 4 frames read from the model (the 32x32
   map padded to 42x42), the hd-64 kernel there held against its plain
   version and its gradient (``_lib.with_plain_grad``, no launch in the
   backward) against autograd of the plain version, ``layer_norm`` and
   ``ln_mlp_residual`` at D 384 the same way; phase 7's warm-up and
   TRAIN_STEPS timed steps (median ms a step, peak reserved memory, each
   step's launches exact: 8 window / 12 LN / 12 MLP, 8 + 8 dropout-flash a
   tracked frame) and one traced step (device ms); the fixed-plan step on
   the card (traced) against the host (its FLOPs counted) at phase 7's
   gate; ``freeze_patterns=("*image_encoder*",)`` for FREEZE_STEPS steps:
   the encoder bit-identical, every other group moved; ``apps/train.py
   --cfg efficientmedsam_s_512`` for one epoch on phase 10's corpus from a
   reference-name ``.pt``, each step's launches exact, its
   ``checkpoint.npz`` served through ``build_efficienttam_video_predictor``
   bit for bit like the trainer's final weights, with phase 6's launches;
12. the measurement layer: the 16-frame propagations of both models traced
   through ``utils/profiling.trace`` and parsed by ``utils/traceparse``
   (every kernel's events in the trace equal its launch counter, graph
   replays included, a short trace taken again up to TRACE_ATTEMPTS times;
   the parsed busy time within 0.5% of ``key_averages()``'; device ms per
   tracked frame and the top kernels and modules), the trace events against
   the counters for phase 7's and 11's traced steps too; FLOPs from
   ``utils/flops`` on the host's plain
   versions for both propagations and both fixed-plan training steps, and
   the MFU of each against the card's dense bf16 peak (an unknown card
   raises), which must lie in (0, 1]; ``tools/torch_profile_propagation.py``
   (4 frames) and ``tools/torch_bench_train_step.py`` (one step of T 2) once;
13. the annotation app, sharded serving and the serving twins,
   ``sam2.1_hiera_t512`` at full width in bf16 with phase 9's seeded
   weights: (a) the annotation server (``apps/http_api.create_server``,
   port 0, a daemon thread) through real HTTP round trips: a seeded
   ``HTTP_FRAMES``-frame 480x640 video written here as an AVI of raw 'RGBA'
   frames (``write_rgba_avi``; the port decodes it without cv2) uploaded,
   a click (object 1), a box (object 2), track, ``masks.zip``,
   ``tracked.mp4`` (where cv2 imports; else its 501), DELETE and a 404
   after; the session's masks and the zip's PNGs bit for bit those of the
   same predictor driven directly on the same frames (that run first: it
   captures, the session does not), each request's launches exactly phase
   4's (9 / 12 / 12 an encoded frame, 8 flash a tracked frame), the
   upload-to-session, click and track ms printed; (b) two sessions of the
   same length tracked at once from two threads on one predictor and one
   graph key, each bit for bit its run alone; once more with the
   predictor's lock a no-op, whether the bits then differ printed, not
   held; (c) phase 9's 4 x 16 videos through ``batched_propagate(...,
   mesh=create_mesh())`` on a one-rank NCCL mesh (its own
   ``MASTER_PORT``; the group destroyed after) with a new predictor of the
   same weights: one capture, exact launches, no host sync in the window,
   phase 9's bits, ms a call and frames/s beside phase 9's; (d)
   ``tools/torch_bench_serve.py --videos 4 --frames 16 --runs 2 --json``
   and ``tools/torch_bench_longvideo.py --lengths 37,64 --chunk 64`` as
   subprocesses: their JSON lines parse, and 37 and 64 frames share one
   capture; the phase's seconds;
14. the last user-facing surfaces, ``sam2.1_hiera_t512`` at full width in
   bf16 with phase 9's seeded weights, every run's launches exact: (a)
   ``tools/torch_verify_real_ckpt.py``'s ``main`` on phase 9's infer_video
   cases from a reference-name ``.pt``: exit 0, launches equal to phase 9's
   infer_video, its CSV byte for byte phase 9's ``metrics.csv`` and its JSON
   summary that CSV's ALL rows; exit 1 under ``--expect_dice 0.999``; (b) an
   ``OFFLOAD_FRAMES``-frame 480x640 uint8 study offloaded to the host (its
   frames preprocessed into the float16 host store) and streamed in chunks
   of 64, three objects clicked on the middle frame, forward then in
   reverse, held against the resident session of the same frames (the
   store's) at phase 8 (b)'s gate; the resident session of the uint8 frames
   (preprocessed on the card) beside it, printed; the store's bytes and the
   peak device memory offloaded against resident (lower required); (c) a
   seeded 16-frame 480x640 mp4 written by ``cv2.VideoWriter`` through phase
   13 (a)'s HTTP session, bit for bit the predictor driven directly on the
   frames ``utils/video_io`` decodes, ``tracked.mp4`` served; (d)
   ``examples/torch_quickstart.py`` at 16 frames with phase 4's launches;
   (e) ``fill_holes_in_mask_scores`` with ``method="fast"`` (and
   "exact") on a seeded batch of 512² logits, bit for bit the host's; (f)
   ``scripts/torch_train_single_host.sh`` (torchrun, one process a card) for
   one epoch on phase 10's corpus with ``TE_ARGS``: each step's launches,
   counted in the trainer's process by a ``sitecustomize`` hook, exactly
   phase 10's, and its ``checkpoint.npz`` served with phase 4's launches;
15. the run's peak reserved device memory, each path's launch counts, the kernels line (launches summed over the
   runs of both models), the card line, and the device line last.

Exits non-zero without a result when no CUDA device is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# bf16 kernel vs plain. LayerNorm and MLP outputs are O(1): |a - b| <= TOL +
# TOL * |b|, as the JAX kernel tests. An attention output is a softmax average
# of N(0,1) values, with an rms of about sqrt(e / keys) (0.02 over 5,144 keys),
# so an absolute floor of TOL would pass a kernel that drops keys; attention is
# held to its output's own scale instead: max |a - b| <= TOL * max |b| and
# ||a - b|| / ||b|| <= ATTN_REL_L2_TOL.
TOL = 2e-2
ATTN_REL_L2_TOL = 1e-2
# card bf16 vs host f32, per frame. bf16 moves a logit by about 1% of the
# frame's rms logit, so pixels within 5% of rms from 0 may flip sign. With
# seeded weights the foreground after frame 0 is well under 1% of the frame
# and lies mostly in that band, so the plain IoU of such masks swings by
# tens of points (0.83-0.99 measured) and is printed for information; the
# gate is the IoU over the pixels outside the band.
LOGIT_REL_L2_TOL = 0.1
SIGN_BAND = 0.05
MASK_IOU_TOL = 0.99
# dropout flash kernels vs the plain version (bf16). out: as attention above.
# lse: the log of the same f32 sums taken in another order, |d| ~ 1e-6; an
# error of LSE_TOL would scale every recomputed probability by 1%, the size of
# a bf16 rounding. dq/dk/dv: the kernels round dS to bf16 before the dq and dk
# products (as the JAX kernel does) and take delta from the bf16 output, which
# autograd of the plain version does not: ~0.3% rel-L2 apart on random
# inputs, so GRAD_REL_L2_TOL leaves about 6x room, and GRAD_MAX_TOL bounds
# any one element against the gradient's own scale.
LSE_TOL = 1e-2
GRAD_REL_L2_TOL = 2e-2
GRAD_MAX_TOL = 0.05
# training step, card bf16 vs host f32 (one step, fixed plan, no dropout):
# bf16 end to end moves the loss by ~1% and the gradient by a few percent.
LOSS_REL_TOL = 2e-2
GRAD_VS_HOST_REL_L2_TOL = 0.1

REPLACES = {
    "layer_norm": "us_video_medsam2_tpu/kernels/fused_ln.py:54",
    "ln_mlp_residual": "us_video_medsam2_tpu/kernels/fused_mlp.py:129",
    "window_attention": "us_video_medsam2_tpu/kernels/fused_window_attention.py:314",
    "flash_attention": "us_video_medsam2_tpu/kernels/flash_attention.py:113",
    "flash_dropout_fwd": "us_video_medsam2_tpu/kernels/flash_dropout.py:276",
    "flash_dropout_bwd": "us_video_medsam2_tpu/kernels/flash_dropout.py:337",
    "cxblock": "us_video_medsam2_tpu/kernels/fused_cxblock.py:147",
    "qkv_window_attention": "us_video_medsam2_tpu/kernels/fused_window_attention.py:254",
    "window_attention_v1": "us_video_medsam2_tpu/kernels/rejected/window_attention_v1.py:165",
}
SOURCES = {k: f"us_video_medsam2_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCES["flash_dropout_fwd"] = SOURCES["flash_dropout_bwd"] = (
    "us_video_medsam2_tpu_torch/csrc/flash_dropout.cu")

# main-path shapes at 512x512 with launches per frame: sam2.1_hiera_t512's,
# plus efficientmedsam_s_512's where it runs the same shape (its 12 blocks'
# LN and MLP tail at 1024 tokens of 384, and the same memory attention), so a
# row's ms and bound cover one frame of each model, as its launches cover
# both models' runs
LN_SHAPES = [((16384, 96), 2), ((4096, 192), 2), ((1024, 384), 7 + 12), ((256, 768), 1)]
MLP_SHAPES = [((16384, 96, 384), 1), ((4096, 192, 768), 2), ((1024, 384, 1536), 7 + 12),
              ((256, 768, 3072), 2)]
FLASH_PER_FRAME = 4 + 4  # each of the self and cross shapes, per tracked frame of each model
# window attention: (Hp, ws, nh, q_pool, real map side) of each windowed block, with launches
# per frame (32 -> 42 and 16 -> 21 are the padded maps of stages 3 and 4, whose
# last strip's pad query rows the model cuts)
WIN_SHAPES = [((128, 8, 1, False, 128), 1), ((128, 8, 2, True, 128), 1), ((64, 4, 2, False, 64), 1),
              ((64, 4, 4, True, 64), 1), ((42, 14, 4, False, 32), 3), ((42, 14, 8, True, 32), 1),
              ((21, 7, 8, False, 16), 1)]
HD = 96
# EfficientMedSAM-S's ws-14 blocks at head dim 64 (32x32 tokens padded to
# 42x42, 8 launches per encoded frame) and -Ti's (embed 192, 3 heads; on no
# path this script drives), for window attention and its qkv variant
HD_VIT = 64
WIN64_SHAPES = [((42, 14, 6, False, 32), 8), ((42, 14, 3, False, 32), 0)]
QKV64_SHAPES = [((42, 14, 6, False, 384, 32), 8), ((42, 14, 3, False, 192, 32), 0)]
# the fused configuration: (Hp, ws, nh, q_pool, Cin, real map side) of each
# windowed block's in-kernel qkv projection (32 -> 42 and 16 -> 21 are the
# zero-padded maps of stages 3 and 4), and the memory encoder's CXBlock map
QKV_SHAPES = [((128, 8, 1, False, 96, 128), 1), ((128, 8, 2, True, 96, 128), 1),
              ((64, 4, 2, False, 192, 64), 1), ((64, 4, 4, True, 192, 64), 1),
              ((42, 14, 4, False, 384, 32), 3), ((42, 14, 8, True, 384, 32), 1),
              ((21, 7, 8, False, 768, 16), 1)]
CX_SIDE, CX_C = 32, 256
# window_attention_v1 (unwired): (Hp, C, nh, Co, ws, q_pool, real map side) of
# the nine windowed t512 blocks at B 1 (ln_inside = not q_pool: a q-pool
# block's norm1 output also feeds its shortcut projection), and the
# geometries (Hp = Wp, C, nh, Co, ws, q_pool) of the JAX package's v1 test
V1_SHAPES = [((128, 96, 1, 96, 8, False, 128), 1), ((128, 96, 2, 192, 8, True, 128), 1),
             ((64, 192, 2, 192, 4, False, 64), 1), ((64, 192, 4, 384, 4, True, 64), 1),
             ((42, 384, 4, 384, 14, False, 32), 3), ((42, 384, 8, 768, 14, True, 32), 1),
             ((21, 768, 8, 768, 7, False, 16), 1)]
V1_JAX_CASES = [(32, 96, 1, 96, 8, False), (32, 96, 2, 192, 8, True), (16, 192, 2, 192, 4, False),
                (42, 384, 4, 384, 14, False), (16, 384, 4, 384, 16, False), (14, 384, 8, 768, 14, True)]
FUSED_SWITCHES = ("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", "US_MEDSAM2_FUSE_QKV_WINDOW_ATTN")
FRAMES = 16  # video length of the main path
CHECK_FRAMES = 4  # frames run again on the host CPU
REPEATS = 3  # timed main-path runs, median kept
PRECOMPUTE_BATCH = 8  # phase 4's run with precompute_features_batch
# graph replay vs the same frame body run eagerly on the card: the same
# kernels on the same inputs (same bits expected; max |d| is printed)
GRAPH_REL_L2_TOL = 1e-3
GRAPH_MASK_IOU_TOL = 0.999
SEED = 0
LONG_FRAMES = 1000  # phase 8 (b): the long study, offloaded and streamed
REPEAT_FRAMES = 600  # a second length in LONG_FRAMES's bucket (1,024 slots)
STREAM_CHUNK = 64
WARM_FRAMES = 70  # the short runs that capture phase 8 (b)'s graphs outside its measured runs
PROFILE_FRAMES = 128  # the profiled streamed run (two chunks)
LONG_BUCKET = 1024
OFFLOAD_SAVING = 2.5e9  # bytes the offloaded run's peak must lie below the resident run's
PEAK_SPREAD = 64 * 2**20  # bytes the REPEAT_FRAMES run's peak may differ from the LONG_FRAMES run's
BUCKET_FRAMES = (37, 50)  # phase 8 (c): two lengths of the 64-slot bucket
# phase 9: the entry points (the apps on seeded data, batched serving, the image path)
APP_HW = (600, 800)  # infer_video's and infer_mri's frames and the image path's image: height, width
APP_FRAMES = 32  # frames of each infer_video NPZ (two videos)
MRI_FRAMES = 16
RECIST_SLICES = 64
RECIST_SIDES = (512, 400)  # one case at model resolution, one through the torch resize
RECIST_HOST_SLICES = 16  # the case run again on the host
VOLUME_SLICES = 32  # infer_3d_ct's and infer_luna25's volume
SERVE_N, SERVE_T = 4, 16  # tools/bench_serve.py's default
HTTP_FRAMES = 16  # phase 13: the uploaded video's frames
HTTP_HW = (480, 640)  # and their height, width
TWIN_TIMEOUT_S = 300
SERVE_HOST = (2, 9)  # videos, frames of the card-vs-host serving run: more frames than memory slots
BATCH_POINTS = 64  # predict_batch_points: one AMG batch
AMG_POINTS, AMG_HOST_POINTS = 32, 8  # points a side: 16 batches of 64; one batch
AMG_IOU_THRESH, AMG_STABILITY_THRESH = 0.0, 0.8
AMG_MATCH_IOU = 0.99
VOXEL_IOU_TOL = 0.99
PER_ENCODED_FRAME = {"window_attention": 9, "layer_norm": 12, "ln_mlp_residual": 12}
PER_TRACKED_FRAME = {"flash_attention": 8}
PER_ENCODED_FRAME_FUSED = {"qkv_window_attention": 9, "layer_norm": 12, "ln_mlp_residual": 12}
# efficientmedsam_s_512: the ViTDet trunk's 8 ws-14 blocks, 12 norm1 sites and 12 MLP tails
PER_ENCODED_FRAME_VIT = {"window_attention": 8, "layer_norm": 12, "ln_mlp_residual": 12}
PER_ENCODED_FRAME_VIT_FUSED = {"qkv_window_attention": 8, "layer_norm": 12, "ln_mlp_residual": 12}
# Seeded weights leave efficientmedsam_s_512's three multimask IoU predictions
# within bf16's resolution of each other (frame 3: 0.5273 / 0.4644 / 0.5274 in
# f32, 0.5273 / 0.4629 / 0.5273 in bf16, the plain versions on the host), so
# the card and the host f32 run pick different masks and the frame's logits
# differ by 0.55 rel-L2. A margin of 1 on one IoU logit (output 2: the second
# multimask mask, a third of the frame, where outputs 1 and 3 give 0.8-1.0)
# makes the pick the same on both; t512 runs without a margin.
VIT_IOU_MARGIN = (2, 1.0)
PER_MEMORY_ENCODING = {"cxblock": 2}  # fuser_layers CXBlocks
# the training path
TRAIN_T = 4
TRAIN_OBJECTS = 3
TRAIN_STEPS = 5  # timed steps after one warm-up step
HOST_T = 4  # frames of the card-vs-host step
DROPOUT = 0.1  # memory attention (MemoryAttentionConfig.dropout)
PER_TRAIN_STEP = {"window_attention": 9, "layer_norm": 12, "ln_mlp_residual": 12}  # one batched encoder call
# phase 11: the EfficientTAM training half at efficientmedsam_s_512 (8 windowed
# ViT blocks, 12 LN and MLP sites, one batched encoder call a step)
VIT = "efficientmedsam_s_512"
PER_TRAIN_STEP_VIT = {"window_attention": 8, "layer_norm": 12, "ln_mlp_residual": 12}
VIT_TRAIN_WINDOW = (42, 14, 6, False, 32)  # (Hp, ws, nh, q_pool, real_h): the 32x32 map padded to whole windows
FREEZE_STEPS = 2
# phase 12: each wrapper's one kernel a launch, by its symbol in the trace
# (demangled, or mangled where the profiler keeps it)
KERNEL_SYMBOLS = {
    "window_attention": r"(::|\d)window_attention_kernel[<(IE]",
    "qkv_window_attention": r"(::|\d)qkv_window_attention_kernel[<(IE]",
    "window_attention_v1": r"(::|\d)window_attention_v1_kernel[<(IE]",
    "layer_norm": r"(::|\d)layer_norm_kernel[<(IE]",
    "ln_mlp_residual": r"(::|\d)ln_mlp_residual_kernel[<(IE]",
    "flash_attention": r"(::|\d)flash_fwd_kernel[<(IE]",
    "flash_dropout_fwd": r"(::fwd::|3fwd6)kernel[<(IE]",
    "flash_dropout_bwd": r"(::bwd::|3bwd10)bwd_kernel[<(IE]",
    "cxblock": r"(::|\d)cxblock_kernel[<(IE]",
}
TRACE_ATTEMPTS = 3
BUSY_REL_TOL = 5e-3  # the parsed trace's busy time against key_averages()' on the same profile
PER_TRACKED_TRAIN_FRAME = {"flash_dropout_fwd": 8, "flash_dropout_bwd": 8}
PARAM_GROUPS = {"trunk": "image_encoder.trunk.", "neck": "image_encoder.neck.",
                "memory attention": "memory_attention.", "memory encoder": "memory_encoder.",
                "prompt encoder": "sam_prompt_encoder.", "mask decoder": "sam_mask_decoder.",
                "fusion": "temporal_fusion_"}
# phase 7's second step: tools/bench_train_step.py's default temporal fusion
# (variant gfte over the top 3 FPN levels at the neck's 256 channels)
GFTE_FUSION = ("gfte", 256, 3)
# phase 10: the training entry point on a seeded NPZ corpus
TE_VIDEOS, TE_FRAMES, TE_HW = 6, 12, (600, 800)
TE_ARGS = ["--num_frames", str(TRAIN_T), "--max_num_objects", str(TRAIN_OBJECTS), "--batch_size", "1",
           "--curriculum", "quantum", "--temporal_loss", "consistency", "--seed", str(SEED)]


# phase 14: the last user-facing surfaces
OFFLOAD_FRAMES = 200  # (b): a 480x640 uint8 study (so preprocessed into the float16 host store)
OFFLOAD_HW = (480, 640)
QUICKSTART_FRAMES = 16  # (d)
FAST_FILL_SHAPE = (4, 512, 512)  # (e): seeded logits; max areas below
FAST_FILL_AREAS = {"fast": (8, 16), "exact": (8,)}  # the fast filler's box count sees 2·max_area+1 px around
LAUNCHER_TIMEOUT_S = 600


# device memory the whole run needs free when it starts: its peak reserved
# (phase 11 prints it; 11.344 GiB on an H100) with room for what the CUDA
# context, NCCL and the kernels' library hold beside PyTorch's allocator; how
# long, and how often, to wait for it (the run takes 7-10 minutes of the
# 20 it is given)
MEMORY_NEED_GIB = 16
MEMORY_WAIT_S = 120
MEMORY_POLL_S = 5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    from us_video_medsam2_tpu_torch.utils.profiling import card_line as query

    return query()


def card_memory() -> str:
    """The card's memory as nvidia-smi sees it, with every compute process it
    can name (processes of other containers use memory but are not listed)."""
    try:
        used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({e})"
    return f"used, total {used}; compute processes: {apps.replace(chr(10), '; ') or 'none listed'}"


def wait_for_memory() -> None:
    """Wait until the card has MEMORY_NEED_GIB free, or MEMORY_WAIT_S have
    passed: memory that another process holds when this one starts (one still
    tearing down, or one sharing the card) would fail a phase with an
    out-of-memory error that says nothing of the port. The run goes on after
    the wait either way, and the free memory is printed."""
    import torch

    need = MEMORY_NEED_GIB * 2**30
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    log(f"  device memory: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free; {card_memory()}")
    waited, polls = 0.0, 0
    while free < need and waited < MEMORY_WAIT_S:
        if polls % 6 == 0:
            log(f"  waiting for {MEMORY_NEED_GIB} GiB free: {free / 2**30:.2f} GiB free after {waited:.0f} s; "
                f"{card_memory()}")
        time.sleep(MEMORY_POLL_S)
        polls += 1
        free, _ = torch.cuda.mem_get_info()
        waited = time.perf_counter() - t0
    if waited:
        state = "free" if free >= need else f"still short of {MEMORY_NEED_GIB} GiB; going on"
        log(f"  device memory after {waited:.0f} s: {free / 2**30:.2f} GiB {state}; {card_memory()}")


PEAK_RESERVED = [0]  # the run's most reserved device memory before the last reset of the peak


def reset_peak_memory() -> None:
    """torch.cuda.reset_peak_memory_stats, keeping the run's peak reserved."""
    import torch

    PEAK_RESERVED[0] = max(PEAK_RESERVED[0], torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()


def ptxas_report(msgs, sources=("flash_dropout.cu", "layer_norm.cu", "ln_mlp_residual.cu",
                                "window_attention.cu", "qkv_window_attention.cu", "cxblock.cu",
                                "window_attention_v1.cu")) -> dict:
    """Registers and spills of each kernel of ``sources`` from the build's
    ``-Xptxas -v`` messages; raises if one of them spills. Returns
    {source: {mangled kernel name: registers}}."""
    import re

    regs = {}
    for msg in msgs:
        src = next((x for x in sources if msg.startswith(f"[nvcc {x}]")), None)
        if src is None:
            continue
        func = None
        for line in msg.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and func:
                log(f"  {src} {func}: {line.strip()}")
                if int(m.group(2)) or int(m.group(3)):
                    raise AssertionError(f"{src}: kernel {func} spills registers")
            elif "Used" in line and "registers" in line and func:
                log(f"  {src} {func}: {line.split(':', 1)[-1].strip()}")
                regs.setdefault(src, {})[func] = int(re.search(r"Used (\d+) registers", line).group(1))
    return regs


def check_window_registers(regs) -> None:
    """Every (head dim, key tiles) instantiation of the window-attention
    kernel was compiled. Its registers are printed beside those of
    window_tiles' occupancy table: a difference fails only where it changes
    the blocks an SM holds, which phase 3 checks on the card."""
    import re

    from us_video_medsam2_tpu_torch.kernels.window_attention import REGISTERS

    got = {}
    for func, n in regs.get("window_attention.cu", {}).items():
        m = re.search(r"window_attention_kernelILi(\d+)ELi(\d+)E", func)
        if m:
            got[(int(m.group(1)), int(m.group(2)))] = n
    log(f"  window_attention.cu: registers by (hd, key tiles) {dict(sorted(got.items()))}; "
        f"window_tiles' table {dict(sorted(REGISTERS.items()))}")
    if got.keys() != REGISTERS.keys():
        raise AssertionError(f"window_attention.cu: instantiations {sorted(got)} differ from "
                             f"window_attention.REGISTERS' {sorted(REGISTERS)}")


def check_qkv_registers(regs) -> None:
    """Every (head dim, key tiles) instantiation of the qkv window-attention
    kernel was compiled; its registers are printed beside those of
    qkv_window_attention.REGISTERS, the table plan_for's occupancy model
    reads (phase 3 holds the model's blocks an SM and clusters at once against
    the card's at every plan it picks)."""
    import re

    from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import REGISTERS

    got = {}
    for func, n in regs.get("qkv_window_attention.cu", {}).items():
        m = re.search(r"qkv_window_attention_kernelILi(\d+)ELi(\d+)E", func)
        if m:
            got[(int(m.group(1)), int(m.group(2)))] = n
    log(f"  qkv_window_attention.cu: registers by (hd, key tiles) {dict(sorted(got.items()))}; "
        f"plan_for's table {dict(sorted(REGISTERS.items()))}")
    if got.keys() != REGISTERS.keys():
        raise AssertionError(f"qkv_window_attention.cu: instantiations {sorted(got)} differ from "
                             f"qkv_window_attention.REGISTERS' {sorted(REGISTERS)}")


def check_cxblock_registers(regs) -> None:
    """The CXBlock kernel was compiled (so the spill check above covered it);
    its registers are printed beside cxblock.REGISTERS, which its plan's
    occupancy model reads (phase 3 holds the model's blocks an SM and clusters
    at once against the card's at every plan it picks)."""
    from us_video_medsam2_tpu_torch.kernels.cxblock import REGISTERS

    got = [n for func, n in regs.get("cxblock.cu", {}).items() if "cxblock_kernel" in func]
    log(f"  cxblock.cu: registers {got}; plan_for's table {REGISTERS}")
    if len(got) != 1:
        raise AssertionError(f"cxblock.cu: {len(got)} kernels compiled, expected cxblock_kernel")


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def check_v1_registers(regs) -> None:
    """Every instantiation of window_attention_v1's two kernels was compiled
    (so the spill check above covered them): the attention kernel at each
    key-tiles count and the output projection at each tile. Their registers
    are printed beside window_attention_v1.REGISTERS and PROJ_REGISTERS,
    which its plan's occupancy model reads (phase 3 holds the model's
    blocks an SM and clusters at once against the card's at every pick)."""
    import re

    from us_video_medsam2_tpu_torch.kernels.rejected.window_attention_v1 import PROJ_REGISTERS, REGISTERS

    att, proj = {}, {}
    for func, n in regs.get("window_attention_v1.cu", {}).items():
        m = re.search(r"window_attention_v1_kernelILi(\d+)EE", func)
        if m:
            att[int(m.group(1))] = n
        m = re.search(r"out_proj_kernelILi(\d+)ELi(\d+)EE", func)
        if m:
            proj[(16 * int(m.group(1)), int(m.group(2)))] = n
    log(f"  window_attention_v1.cu: registers by key tiles {dict(sorted(att.items()))}, plan_for's table "
        f"{dict(sorted(REGISTERS.items()))}; output projection by (rows, 8-column tiles a warp) "
        f"{dict(sorted(proj.items()))}, table {dict(sorted(PROJ_REGISTERS.items()))}")
    if att.keys() != REGISTERS.keys() or proj.keys() != PROJ_REGISTERS.keys():
        raise AssertionError(f"window_attention_v1.cu: instantiations {sorted(att)} / {sorted(proj)} differ from "
                             "the plan's tables")


def check_dropout_fwd_registers(regs) -> None:
    """The dropout forward's kernel and its combine were compiled, so the
    spill check above covered them."""
    import re

    got = {}
    for func, n in regs.get("flash_dropout.cu", {}).items():
        m = re.search(r"fwd\d+(kernel|combine_kernel)E", func)
        if m:
            got[m.group(1)] = n
    log(f"  flash_dropout.cu forward: registers {got}")
    if sorted(got) != ["combine_kernel", "kernel"]:
        raise AssertionError(f"flash_dropout.cu: forward kernels {sorted(got)} compiled, expected the kernel "
                             "and its combine")


def time_ms(fn, launches: int = 20, batches: int = 5, warmup: int = 3) -> float:
    """Median over ``batches`` of the CUDA-event time of ``launches``
    back-to-back calls, divided by ``launches`` (inputs stay in L2)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def device_ms(fn, calls: int = 10, attempts: int = 3, by_kernel: bool = False) -> float:
    """Device time per call of ``fn``: the self device time of every kernel
    that ``calls`` calls launched, from torch.profiler's CUDA kernel events,
    after one warm-up call. At these sizes the CUDA-event time of
    back-to-back calls is the host's; this is the card's. Profiles on an
    H100 lose the device records of the kernels launched first, so each
    profile begins with ``utils/profiling.warm_up``'s launches, which are
    not counted. A profile whose kernel count is still neither a multiple
    of ``calls`` (every call launches the same kernels) nor that of the
    profile before it is taken again, up to ``attempts`` times, and the
    profile that saw the most kernels is kept. Where none saw a kernel,
    the CUDA-event time of ``calls`` back-to-back calls stands in, and the
    log says so. ``by_kernel`` also logs the kept profile's device ms per
    call of each kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from us_video_medsam2_tpu_torch.utils.profiling import warm_up
    from us_video_medsam2_tpu_torch.utils.traceparse import WARMUP_RANGE

    fn()
    torch.cuda.synchronize()
    best, last = (0, 0.0, {}), None
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_up()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, kernels, names = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and not (
                    getattr(e, "is_user_annotation", False) or e.key == WARMUP_RANGE or "spin_kernel" in e.key):
                t = getattr(e, "self_device_time_total", None)
                t = e.self_cuda_time_total if t is None else t
                us += t
                kernels += e.count
                names[e.key] = names.get(e.key, 0.0) + t
        best = max(best, (kernels, us, names), key=lambda b: b[:2])
        if kernels and (kernels % calls == 0 or kernels == last):
            break
        log(f"      the profiler saw {kernels} kernels for {calls} calls (attempt {attempt} of {attempts})")
        last = kernels
    if not best[0]:
        ms = time_ms(fn, launches=calls, batches=3, warmup=0)
        log(f"      the profiler saw no kernel in {attempts} profiles: {ms:.4f} ms a call by CUDA events "
            "stands in for the device time below")
        return ms
    if by_kernel:
        for key, t in sorted(best[2].items(), key=lambda kv: -kv[1]):
            log(f"      {t / 1e3 / calls:.4f} ms a call: {key[:100]}")
    return best[1] / 1e3 / calls


def agreement(got, want, attention: bool) -> tuple[bool, str, float]:
    """(within tolerance, message, max abs error) of ``got`` against ``want``."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return False, "output not finite", float("nan")
    err = (g - w).abs()
    max_abs = err.max().item()
    rel_l2 = (err.norm() / w.norm().clamp(min=1e-30)).item()
    if attention:
        ref_max = w.abs().max().item()
        ok = max_abs <= TOL * ref_max and rel_l2 <= ATTN_REL_L2_TOL
        tol = f"max |d| <= {TOL} max|ref| = {TOL * ref_max:.3e}, rel-L2 <= {ATTN_REL_L2_TOL}"
    else:
        ok = bool((err <= TOL + TOL * w.abs()).all())
        tol = f"|d| <= {TOL} + {TOL}|ref|"
    return ok, f"max_abs {max_abs:.3e} rel-L2 {rel_l2:.3e} (tol {tol})", max_abs


def compare(name: str, got, want, attention: bool = False) -> float:
    ok, msg, max_abs = agreement(got, want, attention)
    log(f"  {name}: {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


class Row:
    """Per-kernel totals over one frame's launches at the main-path shapes."""

    def __init__(self, name):
        self.name = name
        self.max_abs = 0.0
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = None
        self.device_ms = self.library_device_ms = None
        self.bytes_bound = 0.0
        self.ops_bound = 0.0
        self.shapes = []

    def check(self, err):
        """An untimed check's max abs error."""
        self.max_abs = max(self.max_abs, err)

    def add(self, shape, count, err, ms, plain_ms, b, by, lib_ms=None, dev=None):
        """``dev``: (kernel, library or None) device ms per call from the profiler, or None."""
        self.check(err)
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound += count * b
        if by == "bytes":
            self.bytes_bound += count * b
        else:
            self.ops_bound += count * b
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + count * lib_ms
        entry = {"shape": shape, "per_frame": count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"    {shape} x{count}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {b:.4f} ms ({by}), share of bound {b / ms:.3f}")
        if dev is not None:
            self.device_ms = (self.device_ms or 0.0) + count * dev[0]
            entry.update(device_ms=dev[0], library_device_ms=dev[1])
            if dev[1] is None:
                log(f"      device time per call (torch.profiler kernel events): kernel {dev[0]:.4f} ms; "
                    f"per frame x{count}: {count * dev[0]:.4f} ms")
            else:
                self.library_device_ms = (self.library_device_ms or 0.0) + count * dev[1]
                log(f"      device time per call (torch.profiler kernel events): kernel {dev[0]:.4f} ms, "
                    f"library {dev[1]:.4f} ms; per frame x{count}: {count * dev[0]:.4f} / "
                    f"{count * dev[1]:.4f} ms")
        self.shapes.append(entry)


def check_kernels(g) -> dict:
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_attention_split_partials,
        flash_splits,
    )
    from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
    from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import (
        BLOCKS_PER_SM,
        SUPPORTED_D as SUPPORTED_MLP_D,
        blocks_per_sm,
        ln_mlp_residual,
        ln_mlp_residual_plain,
        mlp_splits,
    )

    dev = "cuda"
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    r = rows["layer_norm"] = Row("layer_norm")
    log("layer_norm (fast variance, eps 1e-6)")
    for (n, d), cnt in LN_SHAPES:
        w = 1.0 + rn(d, scale=0.1, dtype=torch.float32)
        b = rn(d, scale=0.1, dtype=torch.float32)
        x = rn(TRAIN_T * n, d)
        r.check(compare(f"({TRAIN_T * n},{d}) training", layer_norm(x, w, b), layer_norm_plain(x, w, b)))
        x = rn(n, d)
        err = compare(f"({n},{d})", layer_norm(x, w, b), layer_norm_plain(x, w, b))
        wb, bb = w.to(bf), b.to(bf)
        bnd, by = bound_ms(4 * n * d + 8 * d, 7 * n * d, F32_FLOPS)
        r.add([n, d], cnt, err, time_ms(lambda: layer_norm(x, w, b)),
              time_ms(lambda: layer_norm_plain(x, w, b)), bnd, by,
              time_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6)),
              (device_ms(lambda: layer_norm(x, w, b)), device_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6))))

    r = rows["ln_mlp_residual"] = Row("ln_mlp_residual")
    log("ln_mlp_residual (two-pass LN eps 1e-6, exact GELU)")
    for (n, d, f), cnt in MLP_SHAPES:
        args = mlp_args(rn, TRAIN_T * n, d, f)
        r.check(compare(f"({TRAIN_T * n},{d},{f}) training", ln_mlp_residual(*args),
                        ln_mlp_residual_plain(*args)))
        args = (rn(n, d), *args[1:])
        err = compare(f"({n},{d},{f})", ln_mlp_residual(*args), ln_mlp_residual_plain(*args))
        bnd, by = bound_ms(4 * n * d + 4 * d * f + 4 * (f + 3 * d), 4 * n * d * f, BF16_FLOPS)
        log(f"    ({n},{d},{f}): {mlp_splits(n, d, f)} hidden splits")
        r.add([n, d, f], cnt, err, time_ms(lambda: ln_mlp_residual(*args)),
              time_ms(lambda: ln_mlp_residual_plain(*args)), bnd, by,
              dev=(device_ms(lambda: ln_mlp_residual(*args), by_kernel=True), None))
    for d in SUPPORTED_MLP_D:  # mlp_splits sizes its grid to one wave from this table
        held = [blocks_per_sm(d, split) for split in (False, True)]
        log(f"    D {d}: {held} blocks an SM (without, with the split; mlp_splits takes {BLOCKS_PER_SM[d]})")
        if held != [BLOCKS_PER_SM[d]] * 2:
            raise AssertionError(f"ln_mlp_residual at D {d}: an SM holds {held} blocks, BLOCKS_PER_SM says "
                                 f"{BLOCKS_PER_SM[d]}")
    check_mlp_splits(rn)

    check_window_attention(rn, rows)

    r = rows["flash_attention"] = Row("flash_attention")
    log("flash_attention (D 256, key mask)")
    # memory-attention keys of a tracked frame: 7 memory slots of 1024 tokens
    # (two invalid early in a video) + 16 object pointers x 4 tokens (some invalid)
    lk_cross = 7 * 1024 + 64
    mask = torch.ones(1, lk_cross, dtype=torch.bool, device=dev)
    mask[:, 5 * 1024: 7 * 1024] = False
    mask[:, 7 * 1024 + 24:] = False
    for (lq, lk, m), cnt in (((1024, 1024, None), FLASH_PER_FRAME), ((1024, lk_cross, mask), FLASH_PER_FRAME)):
        q, k, v = rn(1, 1, lq, 256), rn(1, 1, lk, 256), rn(1, 1, lk, 256)
        want = flash_attention_plain(q, k, v, m)
        err = compare(f"q{lq} k{lk} mask={m is not None}", flash_attention(q, k, v, m), want,
                      attention=True)
        if m is not None:
            # the check must reject a kernel that drops the 24 valid pointer keys
            m_drop = m.clone()
            m_drop[:, 7 * 1024:] = False
            ok, msg, _ = agreement(flash_attention_plain(q, k, v, m_drop), want, attention=True)
            log(f"  self-test, pointer keys dropped: {msg} {'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the flash check does not see 24 dropped keys")
            # and a combine of the key splits that drops the exp(m_i - m) weights
            splits = flash_splits(1, lq, lk)
            o_i, _, l_i = flash_attention_split_partials(q, k, v, m, splits)
            unweighted = (o_i.sum(0) / l_i.sum(0).clamp_min(1e-30)[..., None]).to(q.dtype)
            ok, msg, _ = agreement(unweighted, want, attention=True)
            log(f"  self-test, {splits} splits combined without the exp(m_i - m) weights: {msg} "
                f"{'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the flash check does not see an unweighted combine")
        valid = lk if m is None else int(m.sum().item())
        nbytes = 2 * 2 * lq * 256 + 2 * 2 * valid * 256 + (0 if m is None else lk)
        bnd, by = bound_ms(nbytes, 4 * lq * valid * 256, BF16_FLOPS)
        am = None if m is None else m[:, None, None, :]
        r.add([lq, lk, 256, m is not None], cnt, err, time_ms(lambda: flash_attention(q, k, v, m)),
              time_ms(lambda: flash_attention_plain(q, k, v, m)), bnd, by,
              time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)),
              (device_ms(lambda: flash_attention(q, k, v, m), by_kernel=True),
               device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))))

    # once more, untimed, at shapes off the main path that the wrappers take:
    # ragged last tiles, batch and heads above 1, a batch whose keys are all masked
    log("edge shapes (bf16, untimed)")
    x = rn(1005, 384)
    w, b = 1.0 + rn(384, scale=0.1, dtype=torch.float32), rn(384, scale=0.1, dtype=torch.float32)
    compare("layer_norm (1005,384)", layer_norm(x, w, b), layer_norm_plain(x, w, b))
    args = mlp_args(rn, 1000, 192, 768)
    compare(f"ln_mlp_residual (1000,192,768), {mlp_splits(1000, 192, 768)} splits", ln_mlp_residual(*args),
            ln_mlp_residual_plain(*args))
    # with real_h: a cut whose last real slab is partial (42 and 35 real query
    # rows), one at hd 64, and an odd real row count under q-pooling (no cut)
    for shape, ws, nh, pool, hd, real_h in (((2, 28, 42), 14, 2, True, HD, 26), ((2, 14, 21), 7, 3, False, HD, 12),
                                            ((2, 42, 42), 14, 6, False, HD_VIT, 30),
                                            ((2, 28, 28), 14, 2, True, HD_VIT, 25)):
        qkv = rn(*shape, 3 * nh * hd)
        hold_window(f"window_attention B{shape[0]} {shape[1]}x{shape[2]} ws{ws} nh{nh} hd{hd} pool={pool}", qkv, ws,
                    nh, pool, real_h)
    q, k, v = rn(2, 2, 1000, 256), rn(2, 2, 1100, 256), rn(2, 2, 1100, 256)
    mask = torch.rand(2, 1100, generator=g, device=dev) > 0.3
    mask[1] = False
    compare("flash_attention B2 H2 q1000 k1100, batch 1 all masked", flash_attention(q, k, v, mask),
            flash_attention_plain(q, k, v, mask), attention=True)
    # batched serving's memory attention: one row a video (SERVE_N), self and
    # cross, each row's bank at another fill (1 to 7 valid memory slots)
    q = rn(SERVE_N, 1, 1024, 256)
    k, v = rn(SERVE_N, 1, 1024, 256), rn(SERVE_N, 1, 1024, 256)
    compare(f"flash_attention B{SERVE_N} self q1024 k1024 ({flash_splits(SERVE_N, 1024, 1024)} splits)",
            flash_attention(q, k, v, None), flash_attention_plain(q, k, v, None), attention=True)
    k, v = rn(SERVE_N, 1, lk_cross, 256), rn(SERVE_N, 1, lk_cross, 256)
    mask = torch.zeros(SERVE_N, lk_cross, dtype=torch.bool, device=dev)
    for i in range(SERVE_N):
        mask[i, : (1 + 2 * i) * 1024] = True
        mask[i, 7 * 1024: 7 * 1024 + 4 * (2 + 3 * i)] = True
    compare(f"flash_attention B{SERVE_N} cross q1024 k{lk_cross}, rows at 1-7 valid slots "
            f"({flash_splits(SERVE_N, 1024, lk_cross)} splits)", flash_attention(q, k, v, mask),
            flash_attention_plain(q, k, v, mask), attention=True)
    check_flash_splits(rn, g)
    return rows


def window_cut_row(hp, ws, pool, real_h) -> int:
    """The first output row that the last-strip cut sets to zero (the map's
    output height where no cut applies)."""
    from us_video_medsam2_tpu_torch.kernels.window_attention import cut_query_rows

    wso = ws // 2 if pool else ws
    q_lq = cut_query_rows(hp, ws, pool, real_h)
    return (hp // ws - 1) * wso + q_lq // wso if q_lq else hp // ws * wso


def hold_window(name, qkv, ws, nh, pool, real_h) -> float:
    """window_attention against its plain version without the cut and, where
    real_h cuts the last strip, with it: then the real rows must be
    bit-identical to the uncut call's and the cut rows exact zeros. Returns
    the max abs error."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

    full = window_attention(qkv, ws, nh, pool)
    err = compare(f"{name}", full, window_attention_plain(qkv, ws, nh, pool), attention=True)
    cut_at = window_cut_row(qkv.shape[1], ws, pool, real_h)
    if cut_at == full.shape[1]:
        return err
    cut = window_attention(qkv, ws, nh, pool, real_h)
    err = max(err, compare(f"{name} real_h {real_h}", cut, window_attention_plain(qkv, ws, nh, pool, real_h),
                           attention=True))
    same, zero = torch.equal(cut[:, :cut_at], full[:, :cut_at]), not cut[:, cut_at:].any().item()
    log(f"    real_h {real_h}: rows 0-{cut_at - 1} bit-identical to the uncut call: {same}; rows {cut_at}-"
        f"{full.shape[1] - 1} exact zeros: {zero}")
    if not (same and zero):
        raise AssertionError(f"{name}: the last-strip cut changed a real row or left a cut row non-zero")
    return err


def plain_with_unmasked_pad_keys(qkv, ws, nh, pool):
    """The plain window attention over the keys padded with zero rows to a
    multiple of 16, the pad keys not masked (a kernel that forgets the mask
    of its key tiles)."""
    import torch
    import torch.nn.functional as F

    b, hp, wp, c = qkv.shape
    hd = c // (3 * nh)
    nwh, nww, lk = hp // ws, wp // ws, ws * ws
    wso = ws // 2 if pool else ws
    t = qkv.reshape(b, nwh, ws, nww, ws, 3, nh, hd).permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, lk, hd)
    q, k, v = t[0], t[1], t[2]
    if pool:
        q = q.reshape(-1, wso, 2, wso, 2, hd).amax(dim=(2, 4)).reshape(-1, wso * wso, hd)
    pad = -lk % 16
    k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (hd**-0.5)
    p = torch.softmax(s, -1)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    o = o.reshape(b, nwh, nww, nh, wso, wso, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, nwh * wso, nww * wso, nh * hd)


def without_last_real_slab(out, ws, nh, pool, q_lq):
    """``out`` with the last 16-row query slab holding real rows of every
    window set to zero (a grid that leaves each window's last slab out)."""
    b, hpo, wpo, c = out.shape
    wso = ws // 2 if pool else ws
    nwh, nww, lq = hpo // wso, wpo // wso, wso * wso
    o = out.clone().reshape(b, nwh, wso, nww, wso, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nwh, nww, lq, c)
    for wy in range(nwh):
        rows = q_lq if q_lq and wy == nwh - 1 else lq
        o[:, wy, :, (rows - 1) // 16 * 16: rows] = 0
    o = o.reshape(b, nwh, nww, wso, wso, c).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(out.shape)


def check_window_attention(rn, rows) -> None:
    """Window attention at every geometry the serving and training paths give
    it, with and without the last-strip cut, its rejection self-tests, its
    grid's occupancy against window_tiles' table, and its device time."""
    from us_video_medsam2_tpu_torch.kernels import window_attention as wa

    r = rows["window_attention"] = Row("window_attention")
    for hd, shapes, path in ((HD, WIN_SHAPES, "sam2.1_hiera_t512"), (HD_VIT, WIN64_SHAPES, "EfficientMedSAM-S / -Ti")):
        log(f"window_attention (hd {hd}, f32 scores, bf16 P normalised then rounded): {path}")
        for (hp, ws, nh, pool, real), cnt in shapes:
            real_h = real if real < hp else None  # the model passes its unpadded height
            geo = f"{hp}^2 ws{ws} nh{nh} hd{hd} pool={pool}"
            for b in (1, TRAIN_T) if hd == HD else (1, 2):  # the training path runs the t512 trunk
                warps = wa.window_tiles(b, hp, hp, ws, nh, hd, pool, real_h)
                q_lq = wa.cut_query_rows(hp, ws, pool, real_h)
                blocks = sum(x["blocks"] for x in wa.grid(b, hp, hp, ws, nh, pool, q_lq, warps))
                held, model = wa.card_blocks_per_sm(hd, ws, warps), wa.blocks_per_sm(hd, ws, warps)
                log(f"  B{b} {geo}: window_tiles {warps} warps a block, {blocks} blocks; "
                    f"an SM holds {held} (window_tiles' table: {model}), {blocks / (wa.SMS * held):.2f} waves")
                if held != model:
                    raise AssertionError(f"window_attention B{b} {geo}: an SM holds {held} blocks of {warps} warps, "
                                         f"window_tiles' table says {model}")
                qkv = rn(b, hp, hp, 3 * nh * hd)
                err = hold_window(f"B{b} {geo}", qkv, ws, nh, pool, real_h)
                if b != 1:
                    r.check(err)
                    continue
                want = wa.window_attention_plain(qkv, ws, nh, pool, real_h)
                if hd == HD_VIT and nh == 6:
                    # the check must reject an output whose heads 0 and 1 trade places
                    # (a wrong head offset in the gather or the scatter)
                    swapped = want.clone().reshape(*want.shape[:3], nh, hd)
                    swapped[..., [0, 1], :] = swapped[..., [1, 0], :]
                    self_test("heads 0 and 1 swapped", swapped.reshape(want.shape), want)
                if hd == HD and (ws, nh, pool) == (14, 4, False):
                    # ... each window's last real query slab left out of the grid
                    self_test("each window's last real query slab zero",
                              without_last_real_slab(want, ws, nh, pool, q_lq), want)
                    # ... and the 12 pad keys of the 208-key tiles not masked
                    self_test("pad keys to 208 unmasked", plain_with_unmasked_pad_keys(qkv, ws, nh, pool),
                              wa.window_attention_plain(qkv, ws, nh, pool))
                nwin = (hp // ws) ** 2
                wso = ws // 2 if pool else ws
                out_elems = nwin * wso * wso * nh * hd
                real_rows = nh * (nwin * wso * wso - (hp // ws) * (wso * wso - q_lq) * (q_lq > 0))
                # bytes: qkv read once but the q of the cut input rows (the function needs
                # it nowhere: those rows come back as zeros), the whole output written once
                cut_q = 2 * b * (hp - real_h) * hp * nh * hd if q_lq else 0
                bnd, by = bound_ms(2 * qkv.numel() - cut_q + 2 * out_elems, 4 * real_rows * ws * ws * hd, BF16_FLOPS)
                call = (lambda: wa.window_attention(qkv, ws, nh, pool, real_h))
                r.add([hp, hp, ws, nh, hd, pool, real_h], cnt, err, time_ms(call),
                      time_ms(lambda: wa.window_attention_plain(qkv, ws, nh, pool, real_h)), bnd, by,
                      dev=(device_ms(call), None))


def self_test(what, bad, want) -> None:
    """The attention check must reject ``bad`` as an output where ``want`` is right."""
    ok, msg, _ = agreement(bad, want, attention=True)
    log(f"  self-test, {what}: {msg} {'passed (FAIL)' if ok else 'rejected'}")
    if ok:
        raise AssertionError(f"the window-attention check does not see {what}")


def mlp_args(rn, n, d, f):
    """Seeded MLP inputs in the kernel's types, at the scale of the model's init."""
    import torch

    f32 = torch.float32
    return (rn(n, d), 1.0 + rn(d, scale=0.1, dtype=f32), rn(d, scale=0.1, dtype=f32), rn(f, d, scale=d**-0.5),
            rn(f, scale=0.1, dtype=f32), rn(d, f, scale=f**-0.5), rn(d, scale=0.1, dtype=f32))


def check_mlp_splits(rn) -> None:
    """The MLP kernel where it splits the hidden axis across blocks: two calls
    on the same inputs give the same bits (the partials are summed in a fixed
    order, with no atomics); the plain model of the split agrees with the
    plain version, and the check rejects that model combined without split
    0's partial."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import (
        combine_partials,
        ln_mlp_residual,
        ln_mlp_residual_plain,
        ln_mlp_residual_split_partials,
        mlp_splits,
    )

    log("ln_mlp_residual hidden splits (bf16, untimed)")
    for n, d, f in ((1024, 384, 1536), (256, 768, 3072)):
        splits = mlp_splits(n, d, f)
        if splits < 2:
            raise AssertionError(f"({n},{d},{f}): the split checks need hidden splits, got {splits}")
        args = mlp_args(rn, n, d, f)
        first, second = ln_mlp_residual(*args), ln_mlp_residual(*args)
        same = bool(torch.equal(first, second))
        log(f"  ({n},{d},{f}), {splits} splits: two calls bit-identical: {same}")
        if not same:
            raise AssertionError(f"({n},{d},{f}): the MLP kernel is not deterministic")
        want = ln_mlp_residual_plain(*args)
        parts = ln_mlp_residual_split_partials(*args[:6], splits)
        compare(f"split model ({splits} splits) vs plain", combine_partials(args[0], parts, args[6]), want)
        ok, msg, _ = agreement(combine_partials(args[0], parts[1:], args[6]), want, attention=False)
        log(f"  self-test, combined without split 0's partial: {msg} {'passed (FAIL)' if ok else 'rejected'}")
        if ok:
            raise AssertionError("the MLP check does not see a split left out of the combine")


def check_flash_splits(rn, g) -> None:
    """The flash kernel where its split of the keys across blocks has edges:
    a ragged last split, splits holding only keys past Lk, a split holding
    only masked keys beside a batch with no valid key, and one split."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_splits,
        split_ranges,
    )

    log("flash_attention split geometry (bf16, untimed)")
    for name, (b, h, lq, lk), masked in (("last split ragged", (1, 1, 1024, 1000), True),
                                         ("splits holding only keys past Lk", (1, 1, 1024, 576), False),
                                         ("a split of masked keys only, batch 1 all masked", (2, 1, 1024, 1024), True),
                                         ("one split", (2, 4, 1024, 1100), True)):
        splits = flash_splits(b * h, lq, lk)
        ranges = split_ranges(lk, splits)
        sizes = [hi - lo for lo, hi in ranges]
        mask = None
        if masked:
            mask = torch.rand(b, lk, generator=g, device="cuda") > 0.3
        if name == "last split ragged":
            ok = splits > 1 and 0 < sizes[-1] < sizes[0]
        elif name == "splits holding only keys past Lk":
            ok = splits > 1 and sizes[-1] == 0
        elif name.startswith("a split of masked keys only"):
            lo, hi = ranges[1]
            mask[0, lo:hi] = False
            mask[1] = False
            ok = splits > 2 and hi > lo and bool(mask[0].any())
        else:
            ok = splits == 1
        if not ok:
            raise AssertionError(f"flash split case '{name}': geometry gives {splits} splits {ranges}")
        q, k, v = rn(b, h, lq, 256), rn(b, h, lk, 256), rn(b, h, lk, 256)
        compare(f"flash_attention B{b} H{h} q{lq} k{lk}, {splits} splits {sizes}: {name}",
                flash_attention(q, k, v, mask), flash_attention_plain(q, k, v, mask), attention=True)


def cxblock_args(rn, b, h, w=None, c=CX_C):
    """Seeded CXBlock inputs in the kernel's types. γ is 1 ± 0.1: at the
    model's layer-scale init (1e-6) out equals x to bf16 and the check would
    see nothing of the block."""
    import torch

    f32 = torch.float32
    return (rn(b, h, w or h, c), rn(c, 1, 7, 7, scale=0.1, dtype=f32), rn(c, scale=0.1, dtype=f32),
            1.0 + rn(c, scale=0.1, dtype=f32), rn(c, scale=0.1, dtype=f32), rn(4 * c, c, scale=c**-0.5),
            rn(4 * c, scale=0.3, dtype=f32), rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1, dtype=f32),
            1.0 + rn(c, scale=0.1, dtype=f32))


def qkv_args(rn, b, hp, nh, cin, real, hd=HD):
    """Post-norm1 tokens zero-padded from real x real to hp x hp, the qkv weight and its f32 bias."""
    import torch

    y = torch.zeros(b, hp, hp, cin, dtype=torch.bfloat16, device="cuda")
    y[:, :real, :real] = rn(b, real, real, cin)
    return y, rn(3 * nh * hd, cin, scale=cin**-0.5), rn(3 * nh * hd, scale=0.5, dtype=torch.float32)


def same_bits(name, call) -> None:
    """Two calls on the same inputs give the same bits."""
    import torch

    a, b = call(), call()
    torch.cuda.synchronize()
    log(f"  {name}: two calls bit-identical {torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def check_fused_kernels(g, rows) -> None:
    """The two kernels of the fused configuration against their plain versions."""
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.kernels import cxblock as cx
    from us_video_medsam2_tpu_torch.kernels.cxblock import cxblock, cxblock_plain, cxblock_split_plain
    from us_video_medsam2_tpu_torch.kernels import qkv_window_attention as qwa
    from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import (
        qkv_window_attention,
        qkv_window_attention_plain,
        qkv_window_attention_split_plain,
    )
    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain
    from us_video_medsam2_tpu_torch.models.memory import CXBlock

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    held = set()

    def hold_plan(b, hp, wp, ws, nh, hd, pool, cin) -> None:
        """The plan plan_for picks here: its shared memory, blocks an SM and
        clusters at once held against the card's occupancy API (once a
        plan). The clusters table may differ from the card only where the
        plan's waves stay the same (GPC sizes can differ between cards)."""
        plan = qwa.plan_for(b, hp, wp, ws, nh, hd, pool, cin)
        if (hd, ws, pool, plan) in held:
            return
        held.add((hd, ws, pool, plan))
        smem, blocks, clusters = qwa.card_occupancy(hd, ws, pool, plan)
        model = (qwa.smem_bytes(hd, ws, pool, plan), qwa.blocks_per_sm(hd, ws, pool, plan),
                 qwa.clusters_at_once(hd, ws, pool, plan))
        kt = qwa.key_tiles(ws)
        tasks = -(-b * (hp // ws) * (wp // ws) // plan.g) * nh
        waves = (-(-tasks // clusters) if clusters else None, -(-tasks // model[2]))
        log(f"    plan {tuple(plan)} (G, C) of instantiation (hd {hd}, key tiles {kt}): {smem} B shared "
            f"memory (model {model[0]}), {qwa.REGISTERS[(hd, kt)]} registers a thread (table), {blocks} blocks "
            f"an SM (model {model[1]}), {clusters} clusters of {plan.c} at once (table {model[2]}): "
            f"{tasks} clusters in {waves[0]} waves")
        if (smem, blocks) != model[:2] or waves[0] != waves[1]:
            raise AssertionError(f"qkv_window_attention plan {plan}: the card's occupancy {smem, blocks, clusters} "
                                 f"is not the model's {model}")

    def hold_cx_plan(b, h, w) -> None:
        """The CXBlock splits plan_for picks for [b, h, w, 256]: the shared
        memory, blocks an SM and clusters at once held against the card's
        occupancy API; the clusters (one a token tile) must all run at once
        on the card, as the plan assumes."""
        splits = cx.plan_for(b, h, w)
        smem, blocks, clusters = cx.card_occupancy(splits)
        model = (cx.smem_bytes(splits), cx.blocks_per_sm(splits), cx.clusters_at_once(splits))
        tiles = cx.tiles(b, h, w)
        log(f"    {splits} splits at [{b}, {h}, {w}]: {smem} B shared memory (model {model[0]}), {cx.REGISTERS} "
            f"registers a thread (table), {blocks} blocks an SM (model {model[1]}), {clusters} clusters of "
            f"{splits} at once (table {model[2]}): {tiles} clusters")
        if (smem, blocks) != model[:2] or (splits > 1 and tiles > clusters):
            raise AssertionError(f"cxblock at {splits} splits: the card's occupancy {smem, blocks, clusters} is not "
                                 f"the model's {model}")

    def hold_cxblock(name, args) -> float:
        """out and out − x against the plain version, two calls bit-identical,
        the plan against the card; max abs error."""
        got, want = cxblock(*args), cxblock_plain(*args)
        x = args[0].float()
        err = max(compare(f"{name} out", got, want), compare(f"{name} out - x", got.float() - x, want.float() - x))
        same_bits(name, lambda: cxblock(*args))
        hold_cx_plan(*args[0].shape[:3])
        return err

    def module_device_ms(args) -> float:
        """Device ms a call of the CXBlock module's default composition (the
        switch unset: depthwise Conv2d, LayerNorm, two cuBLAS Linears, GELU,
        scale, residual) on the same inputs in bf16, for information."""
        blk = CXBlock(args[0].shape[-1]).to("cuda")
        names = ("dwconv.conv.weight", "dwconv.conv.bias", "norm.weight", "norm.bias", "pwconv1.weight",
                 "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma")
        with torch.no_grad():
            for pname, v in zip(names, args[1:]):
                blk.get_parameter(pname).copy_(v)
            blk = blk.to(torch.bfloat16)
            return device_ms(lambda: blk(args[0]))

    r = rows["cxblock"] = Row("cxblock")
    log("cxblock (depthwise 7x7 f32 taps, fast-variance LN eps 1e-6, exact GELU, gamma 1 +- 0.1)")
    train_args = cxblock_args(rn, TRAIN_OBJECTS, CX_SIDE)
    r.check(hold_cxblock(f"B{TRAIN_OBJECTS} {CX_SIDE}^2 training", train_args))
    args = cxblock_args(rn, 1, CX_SIDE)
    err = hold_cxblock(f"{CX_SIDE}^2", args)
    # the check must reject a kernel that drops the pwconv1 bias
    want = cxblock_plain(*args)
    no_b1 = cxblock_plain(*args[:6], torch.zeros_like(args[6]), *args[7:])
    ok, msg, _ = agreement(no_b1.float() - args[0].float(), want.float() - args[0].float(), attention=False)
    log(f"  self-test, plain version without b1: out - x {msg} {'passed (FAIL)' if ok else 'rejected'}")
    if ok:
        raise AssertionError("the cxblock check does not see a dropped b1")
    # the plain model of the plan's split agrees; the check must reject it with
    # one rank's partial left out of the combine
    splits = cx.plan_for(1, CX_SIDE, CX_SIDE)
    compare(f"{CX_SIDE}^2 plain split model, {splits} splits", cxblock_split_plain(*args, splits), want)
    dropped = cxblock_split_plain(*args, splits, drop_split=1)
    ok, msg, _ = agreement(dropped.float() - args[0].float(), want.float() - args[0].float(), attention=False)
    log(f"  self-test, split model without rank 1's partial: out - x {msg} {'passed (FAIL)' if ok else 'rejected'}")
    if ok:
        raise AssertionError("the cxblock check does not see a split left out of the combine")
    hw, c, f = CX_SIDE * CX_SIDE, CX_C, 4 * CX_C
    nbytes = 2 * 2 * hw * c + 2 * 2 * c * f + 4 * (49 * c + 6 * c + f)
    # products on the bf16 tensor cores, the depthwise taps as f32 FMAs
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, (4 * hw * c * f / BF16_FLOPS + 2 * hw * c * 49 / F32_FLOPS) * 1e3
    bnd, by = (tb, "bytes") if tb >= tf else (tf, "operations")
    # one memory encoding of each model: both run the same memory encoder
    r.add([1, CX_SIDE, CX_SIDE, c], 2 * PER_MEMORY_ENCODING["cxblock"], err, time_ms(lambda: cxblock(*args)),
          time_ms(lambda: cxblock_plain(*args)), bnd, by, dev=(device_ms(lambda: cxblock(*args)), None))
    r.shapes[-1]["splits"] = splits
    train_dev = device_ms(lambda: cxblock(*train_args))
    r.shapes[-1]["training_device_ms"] = train_dev
    module = {b: module_device_ms(a) for b, a in ((1, args), (TRAIN_OBJECTS, train_args))}
    r.shapes[-1]["module_device_ms"] = module
    log(f"  B{TRAIN_OBJECTS} (training): kernel {train_dev:.4f} ms a call on the device, "
        f"{cx.plan_for(TRAIN_OBJECTS, CX_SIDE, CX_SIDE)} splits")
    log(f"  the module's default composition (switch unset) on the device, for information: B1 {module[1]:.4f} ms, "
        f"B{TRAIN_OBJECTS} {module[TRAIN_OBJECTS]:.4f} ms a call, against the kernel's "
        f"{r.shapes[-1]['device_ms']:.4f} / {train_dev:.4f}")
    log(f"  {cx.tiles(1, CX_SIDE, CX_SIDE)} token tiles of 8x8 at B 1, each a cluster of {splits} blocks on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    log("  library: none (no one PyTorch call runs the depthwise conv, LN, both pointwise products, "
        "GELU, layer scale and residual)")

    r = rows["qkv_window_attention"] = Row("qkv_window_attention")
    shapes = [(HD, *s) for s in QKV_SHAPES] + [(HD_VIT, *s) for s in QKV64_SHAPES]
    for i, (hd, (hp, ws, nh, pool, cin, real), cnt) in enumerate(shapes):
        if i == 0 or hd != shapes[i - 1][0]:
            log(f"qkv_window_attention (in-kernel projection, f32 bias; hd {hd}, f32 scores, bf16 P): "
                f"{'sam2.1_hiera_t512' if hd == HD else 'EfficientMedSAM-S / -Ti'}")
        geo = f"{hp}^2 ws{ws} nh{nh} hd{hd} pool={pool} Cin{cin}"
        if hd == HD:  # the training path runs the t512 trunk
            a = qkv_args(rn, TRAIN_T, hp, nh, cin, real)
            r.check(compare(f"B{TRAIN_T} {geo} training", qkv_window_attention(*a, ws, nh, pool),
                            qkv_window_attention_plain(*a, ws, nh, pool), attention=True))
            hold_plan(TRAIN_T, hp, hp, ws, nh, hd, pool, cin)
        a = qkv_args(rn, 1, hp, nh, cin, real, hd)
        want = qkv_window_attention_plain(*a, ws, nh, pool)
        err = compare(geo, qkv_window_attention(*a, ws, nh, pool), want, attention=True)
        same_bits(geo, lambda: qkv_window_attention(*a, ws, nh, pool))
        hold_plan(1, hp, hp, ws, nh, hd, pool, cin)
        if (hp, ws, nh, pool, hd) == (42, 14, 4, False, HD):
            # the check must reject a kernel whose pad tokens' q, k, v are 0, not the bias
            y, w, b = a
            qkv = F.linear(y.float(), w.float(), b).to(y.dtype)
            qkv[:, real:] = 0
            qkv[:, :, real:] = 0
            ok, msg, _ = agreement(window_attention_plain(qkv, ws, nh, pool), want, attention=True)
            log(f"  self-test, pad tokens' qkv 0: {msg} {'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the qkv window-attention check does not see zero pad tokens")
        if ws == 14 and not pool and cnt:
            # the plain model of the plan's split agrees; the check must reject
            # it with one cluster rank's K and V share left out
            plan = qwa.plan_for(1, hp, hp, ws, nh, hd, pool, cin)
            compare(f"{geo} plain split model, plan {tuple(plan)}",
                    qkv_window_attention_split_plain(*a, ws, nh, pool, plan), want, attention=True)
            if plan.c < 2:
                raise AssertionError(f"{geo}: plan {plan} has no cluster rank to leave out")
            dropped = qkv_window_attention_split_plain(*a, ws, nh, pool, plan, drop_rank=1)
            ok, msg, _ = agreement(dropped, want, attention=True)
            log(f"  self-test, split model without rank 1's K and V share: {msg} "
                f"{'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the qkv window-attention check does not see a dropped cluster share")
        nwin = (hp // ws) ** 2
        wso = ws // 2 if pool else ws
        out_elems = nwin * wso * wso * nh * hd
        # the projection of the real tokens (a zero pad token's q, k, v is the
        # bias) and attention over every window
        flops = 2 * real * real * cin * 3 * nh * hd + 4 * nwin * nh * (wso * wso) * (ws * ws) * hd
        bnd, by = bound_ms(2 * a[0].numel() + 2 * a[1].numel() + 4 * a[2].numel() + 2 * out_elems, flops,
                           BF16_FLOPS)
        r.add([hp, hp, ws, nh, hd, pool, cin], cnt, err, time_ms(lambda: qkv_window_attention(*a, ws, nh, pool)),
              time_ms(lambda: qkv_window_attention_plain(*a, ws, nh, pool)), bnd, by,
              dev=(device_ms(lambda: qkv_window_attention(*a, ws, nh, pool)), None))
        # for information: the unfused pair at the same shape (the bias map from
        # one cuBLAS product, then the window-attention kernel without the cut)
        y, w, b = a
        bb = b.to(y.dtype)
        unfused = device_ms(lambda: window_attention(F.linear(y, w, bb), ws, nh, pool))
        r.shapes[-1]["unfused_device_ms"] = unfused
        log(f"      unfused pair (F.linear bias map + window_attention kernel): {unfused:.4f} ms a call on the "
            f"device, against {r.shapes[-1]['device_ms']:.4f}")
    log("  library: none (no one PyTorch call projects, gathers the windows, pools q and attends)")

    log("fused kernels at edge shapes (bf16, untimed)")
    hold_cxblock("cxblock B2 16^2", cxblock_args(rn, 2, 16))
    hold_cxblock("cxblock 12x20 (ragged 8x8 tiles)", cxblock_args(rn, 1, 12, 20))
    for (bsz, hp, wp), ws, nh, pool, cin, hd in (((2, 28, 42), 14, 2, True, 192, HD), ((2, 14, 21), 7, 3, False, 96, HD),
                                                ((2, 42, 42), 14, 6, False, 384, HD_VIT),
                                                ((2, 28, 28), 14, 2, True, 192, HD_VIT)):
        y, w, b = qkv_args(rn, bsz, max(hp, wp), nh, cin, max(hp, wp), hd)
        y = y[:, :hp, :wp].contiguous()
        name = f"qkv_window_attention B{bsz} {hp}x{wp} ws{ws} nh{nh} hd{hd} pool={pool} Cin{cin}"
        compare(name, qkv_window_attention(y, w, b, ws, nh, pool), qkv_window_attention_plain(y, w, b, ws, nh, pool),
                attention=True)
        same_bits(name, lambda: qkv_window_attention(y, w, b, ws, nh, pool))
        hold_plan(bsz, hp, wp, ws, nh, hd, pool, cin)


def v1_args(rn, b, hp, c, nh, co, real):
    """window_attention_v1's inputs: tokens zero-padded from real x real to
    hp x hp (LN then makes a pad token beta), LN parameters (gamma 1 +- 0.1,
    beta of scale 0.1), per-head weights in x's dtype and f32 biases."""
    import torch

    f32 = torch.float32
    x = torch.zeros(b, hp, hp, c, dtype=torch.bfloat16, device="cuda")
    x[:, :real, :real] = rn(b, real, real, c)
    return (x, 1.0 + rn(c, scale=0.1, dtype=f32), rn(c, scale=0.1, dtype=f32),
            *(rn(nh, c, HD, scale=c**-0.5) for _ in range(3)),
            *(rn(nh, HD, scale=0.1, dtype=f32) for _ in range(3)),
            rn(nh, HD, co, scale=HD**-0.5), rn(co, scale=0.1, dtype=f32))


def v1_compositions(a, ws, nh, pool, ln, eps=1e-6):
    """The port's own ways to the function window_attention_v1 computes, on
    its inputs ``a``, for the yardstick: (unfused, fused) callables. Unfused
    is the main path's calls (models/hiera.py: the layer_norm kernel, the qkv
    Linear, the window_attention kernel, the proj Linear); fused the fused
    configuration's (layer_norm, qkv_window_attention, the proj Linear). The
    weights are put in the Linear layout once, outside the calls."""
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm
    from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import qkv_window_attention
    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention

    x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo = a
    c, hd, co = x.shape[-1], wq.shape[-1], wo.shape[-1]
    w = torch.cat([t.permute(0, 2, 1).reshape(nh * hd, c) for t in (wq, wk, wv)]).contiguous()
    b = torch.cat([t.reshape(-1) for t in (bq, bk, bv)]).contiguous()
    b_dt, w_proj, bo_dt = b.to(x.dtype), wo.reshape(nh * hd, co).t().contiguous(), bo.to(x.dtype)

    def norm():
        return layer_norm(x, gamma, beta, eps) if ln else x

    def unfused():
        return F.linear(window_attention(F.linear(norm(), w, b_dt), ws, nh, pool), w_proj, bo_dt)

    def fused():
        return F.linear(qkv_window_attention(norm(), w, b, ws, nh, pool), w_proj, bo_dt)

    return unfused, fused


def check_window_attention_v1(g, rows) -> None:
    """The unwired window_attention_v1 against its plain version: two calls
    bit-identical, its plans against the card's occupancy, and its device
    time beside the port's own compositions of the same blocks."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.rejected import window_attention_v1 as v1m
    from us_video_medsam2_tpu_torch.kernels.rejected.window_attention_v1 import (
        _ln,
        window_attention_v1,
        window_attention_v1_plain,
        window_attention_v1_split_plain,
    )

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    held = set()

    def hold_plan(b, hp, c, nh, co, ws, pool, ln) -> None:
        """The plan plan_for picks here: the attention kernel's shared memory,
        blocks an SM and clusters at once, and the output projection's blocks
        an SM, held against the card's occupancy API (once a plan). The
        clusters table may differ from the card only where the waves stay
        the same."""
        plan = v1m.plan_for(b, hp, hp, ws, nh, pool, c, co, ln)
        if (ws, pool, c, ln, plan) in held:
            return
        held.add((ws, pool, c, ln, plan))
        smem, blocks, clusters, proj_blocks = v1m.card_occupancy(ws, pool, c, ln, plan)
        model = (v1m.smem_bytes(ws, pool, c, ln, plan), v1m.blocks_per_sm(ws, pool, c, ln, plan),
                 v1m.clusters_at_once(ws, pool, c, ln, plan), v1m.proj_blocks_per_sm(plan.rows, plan.nt))
        tasks = -(-b * (hp // ws) ** 2 // plan.g) * nh
        waves = (-(-tasks // clusters) if clusters else None, -(-tasks // model[2]))
        log(f"    plan {tuple(plan)} (G, C, projection rows, 8-column tiles) at ws {ws} C {c} pool={pool} "
            f"ln={ln}: {smem} B shared memory (model {model[0]}, token rows resident "
            f"{v1m.resident(ws, pool, c, ln, plan)}), {blocks} blocks an SM (model {model[1]}), {clusters} "
            f"clusters of {plan.c} at once (table {model[2]}): {tasks} clusters in {waves[0]} waves; projection "
            f"{proj_blocks} blocks an SM (model {model[3]})")
        if (smem, blocks, proj_blocks) != (model[0], model[1], model[3]) or waves[0] != waves[1]:
            raise AssertionError(f"window_attention_v1 plan {plan}: the card's occupancy "
                                 f"{smem, blocks, clusters, proj_blocks} is not the model's {model}")

    eps = 1e-6
    r = rows["window_attention_v1"] = Row("window_attention_v1")
    log(f"window_attention_v1 (unwired; LN eps {eps}, per-head qkv, hd {HD}, f32 scores, P normalised then "
        "rounded, out-projection summed over heads in f32)")
    composition = [0.0, 0.0]
    for (hp, c, nh, co, ws, pool, real), cnt in V1_SHAPES:
        ln = not pool
        geo = f"{hp}^2 (from {real}^2) C{c} nh{nh} Co{co} ws{ws} pool={pool}"
        a = v1_args(rn, 1, hp, c, nh, co, real)
        r.check(compare(f"{geo} ln_inside={not ln}", window_attention_v1(*a, ws, pool, not ln, eps),
                        window_attention_v1_plain(*a, ws, pool, not ln, eps), attention=True))
        same_bits(f"{geo} ln_inside={not ln}", lambda: window_attention_v1(*a, ws, pool, not ln, eps))
        hold_plan(1, hp, c, nh, co, ws, pool, not ln)
        want = window_attention_v1_plain(*a, ws, pool, ln, eps)
        err = compare(f"{geo} ln_inside={ln}", window_attention_v1(*a, ws, pool, ln, eps), want, attention=True)
        same_bits(f"{geo} ln_inside={ln}", lambda: window_attention_v1(*a, ws, pool, ln, eps))
        hold_plan(1, hp, c, nh, co, ws, pool, ln)
        if (hp, ws, nh, pool) == (42, 14, 4, False):
            # the check must reject a kernel that leaves the pad tokens' LN output at 0, not beta
            y = _ln(a[0], a[1], a[2], eps)
            y[:, real:] = 0
            y[:, :, real:] = 0
            ok, msg, _ = agreement(window_attention_v1_plain(y, *a[1:], ws, pool, False, eps), want, attention=True)
            log(f"  self-test, pad tokens' LN output 0: {msg} {'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the window_attention_v1 check does not see pad tokens left at 0")
            # the plain model of the plan's cut agrees; the check must reject it
            # with one head left out of the output projection's sum
            plan = v1m.plan_for(1, hp, hp, ws, nh, pool, c, co, ln)
            compare(f"{geo} plain split model, plan {tuple(plan)}",
                    window_attention_v1_split_plain(*a, ws, pool, ln, eps, plan), want, attention=True)
            dropped = window_attention_v1_split_plain(*a, ws, pool, ln, eps, plan, drop_head=1)
            ok, msg, _ = agreement(dropped, want, attention=True)
            log(f"  self-test, split model without head 1 in the projection's sum: {msg} "
                f"{'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the window_attention_v1 check does not see a head left out")
        nwin = (hp // ws) ** 2
        wso = ws // 2 if pool else ws
        rows_out = nwin * wso * wso
        # projections of every token with LN (a pad token is beta), of the real
        # tokens without (a zero token's q, k, v is the bias); attention over
        # every window; the output projection
        tokens = hp * hp if ln else real * real
        flops = (2 * tokens * c * 3 * nh * HD + 4 * nwin * nh * (wso * wso) * (ws * ws) * HD
                 + 2 * rows_out * nh * HD * co)
        nbytes = (2 * a[0].numel() + 2 * (3 * nh * c * HD + nh * HD * co) + 4 * (2 * c + 3 * nh * HD + co)
                  + 2 * rows_out * co)
        bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
        r.add([hp, hp, c, nh, co, ws, pool, ln], cnt, err, time_ms(lambda: window_attention_v1(*a, ws, pool, ln, eps)),
              time_ms(lambda: window_attention_v1_plain(*a, ws, pool, ln, eps)), bnd, by,
              dev=(device_ms(lambda: window_attention_v1(*a, ws, pool, ln, eps), by_kernel=True), None))
        r.shapes[-1]["plan"] = tuple(v1m.plan_for(1, hp, hp, ws, nh, pool, c, co, ln))
        # for information: the port's own compositions of the same block
        comp = [device_ms(f) for f in v1_compositions(a, ws, nh, pool, ln, eps)]
        composition = [t + cnt * ms for t, ms in zip(composition, comp)]
        r.shapes[-1]["composition_device_ms"] = {"unfused": comp[0], "fused": comp[1]}
        log(f"      compositions on the device: main path (layer_norm, qkv Linear, window_attention, proj Linear) "
            f"{comp[0]:.4f} ms, fused configuration (layer_norm, qkv_window_attention, proj Linear) {comp[1]:.4f} "
            f"ms a call, against v1's {r.shapes[-1]['device_ms']:.4f}")
    log(f"  over the nine blocks on the device: v1 {r.device_ms:.4f} ms, main-path composition {composition[0]:.4f}, "
        f"fused composition {composition[1]:.4f}")
    log("  library: none (no one PyTorch call runs LN, the per-head qkv projection, the window gather, "
        "the q pool, the attention and the output projection)")
    log("  the JAX package's v1 test geometries at B 2 (untimed)")
    for hp, c, nh, co, ws, pool in V1_JAX_CASES:
        a = v1_args(rn, 2, hp, c, nh, co, hp)
        for ln in (True, False):
            name = f"B2 {hp}^2 C{c} nh{nh} Co{co} ws{ws} pool={pool} ln_inside={ln}"
            r.check(compare(name, window_attention_v1(*a, ws, pool, ln, eps),
                            window_attention_v1_plain(*a, ws, pool, ln, eps), attention=True))
            same_bits(name, lambda: window_attention_v1(*a, ws, pool, ln, eps))
            hold_plan(2, hp, c, nh, co, ws, pool, ln)


def grad_agreement(got, want) -> tuple[bool, str, float]:
    """(within tolerance, message, max abs error) of a gradient against its reference."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return False, "gradient not finite", float("nan")
    err = (g - w).abs()
    max_abs, ref_max = err.max().item(), w.abs().max().item()
    rel_l2 = (err.norm() / w.norm().clamp(min=1e-30)).item()
    ok = rel_l2 <= GRAD_REL_L2_TOL and max_abs <= GRAD_MAX_TOL * ref_max
    return ok, (f"max_abs {max_abs:.3e} rel-L2 {rel_l2:.3e} (tol rel-L2 <= {GRAD_REL_L2_TOL}, "
                f"max |d| <= {GRAD_MAX_TOL} max|ref| = {GRAD_MAX_TOL * ref_max:.3e})"), max_abs


def hold_grad(name, wrapper, plain, args, wrt, g) -> None:
    """The gradient of ``wrapper(*args)`` (the kernel forward, the plain
    version's vjp recomputed in the backward) against autograd of
    ``plain(*args)`` for the arguments at indices ``wrt``, with output
    gradient drawn from ``g``. Raises on a disagreement, or if the backward
    launched a kernel."""
    import torch

    def leaves():
        return [a.detach().clone().requires_grad_(True) if i in wrt else a for i, a in enumerate(args)]

    got, want = leaves(), leaves()
    out = wrapper(*got)
    go = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    before = {k: w.launches for k, w in counters().items()}
    out.backward(go)
    torch.cuda.synchronize()
    after = {k: w.launches for k, w in counters().items()}
    if after != before:
        raise AssertionError(f"{name}: the backward launched kernels ({before} -> {after})")
    plain(*want).backward(go)
    for i in wrt:
        ok, msg, _ = grad_agreement(got[i].grad, want[i].grad)
        log(f"  {name} d(arg {i}): {msg} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: gradient of argument {i} disagrees with autograd of the plain version")


def check_kernel_grads(g) -> None:
    """The wrapper gradient of each forward-only kernel (LayerNorm, MLP,
    window and flash attention, CXBlock, qkv window attention, and the
    unwired window_attention_v1 at B 1) at one
    training-path shape (T·B = TRAIN_T frames through the trunk; the memory
    cross-attention of the fixed-plan step, which runs without dropout; the
    memory encoder over TRAIN_OBJECTS objects), every differentiable argument
    as in training (f32 LN parameters, taps and biases, bf16 weight
    matrices)."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.cxblock import cxblock, cxblock_plain
    from us_video_medsam2_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
    from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
    from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import (
        qkv_window_attention,
        qkv_window_attention_plain,
    )
    from us_video_medsam2_tpu_torch.kernels.rejected.window_attention_v1 import (
        window_attention_v1,
        window_attention_v1_plain,
    )
    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    log("gradients of the wrappers (kernel forward, plain vjp recomputed) vs autograd of the plain "
        "versions, bf16, training shapes")
    n, d = TRAIN_T * 4096, 192
    hold_grad(f"layer_norm ({n},{d})", layer_norm, layer_norm_plain,
              (rn(n, d), 1.0 + rn(d, scale=0.1, dtype=f32), rn(d, scale=0.1, dtype=f32), 1e-6), (0, 1, 2), g)
    n, d, f = TRAIN_T * 1024, 384, 1536
    hold_grad(f"ln_mlp_residual ({n},{d},{f})", ln_mlp_residual, ln_mlp_residual_plain,
              (rn(n, d), 1.0 + rn(d, scale=0.1, dtype=f32), rn(d, scale=0.1, dtype=f32),
               rn(f, d, scale=d**-0.5), rn(f, scale=0.1, dtype=f32), rn(d, f, scale=f**-0.5),
               rn(d, scale=0.1, dtype=f32), 1e-6), tuple(range(7)), g)
    for hp, ws, nh, pool in ((42, 14, 4, False), (42, 14, 8, True)):  # the 32x32 map, cut as the model calls it
        hold_grad(f"window_attention B{TRAIN_T} {hp}^2 ws{ws} nh{nh} pool={pool} real_h 32", window_attention,
                  window_attention_plain, (rn(TRAIN_T, hp, hp, 3 * nh * HD), ws, nh, pool, 32), (0,), g)
    mask = train_key_mask(dev)
    b, lk = mask.shape
    hold_grad(f"flash_attention q1024 k{lk} masked", flash_attention, flash_attention_plain,
              (rn(b, 1, 1024, 256), rn(b, 1, lk, 256), rn(b, 1, lk, 256), mask), (0, 1, 2), g)
    hold_grad(f"cxblock B{TRAIN_OBJECTS} {CX_SIDE}^2", cxblock, cxblock_plain,
              (*cxblock_args(rn, TRAIN_OBJECTS, CX_SIDE), 1e-6), tuple(range(10)), g)
    for hp, ws, nh, pool, cin, real in ((42, 14, 4, False, 384, 32), (42, 14, 8, True, 384, 32)):
        hold_grad(f"qkv_window_attention B{TRAIN_T} {hp}^2 ws{ws} nh{nh} pool={pool}", qkv_window_attention,
                  qkv_window_attention_plain, (*qkv_args(rn, TRAIN_T, hp, nh, cin, real), ws, nh, pool),
                  (0, 1, 2), g)
    # window_attention_v1 (unwired): x and every parameter; without ln_inside
    # gamma and beta have no gradient
    for (hp, c, nh, co, ws, pool, real), _ in (V1_SHAPES[4], V1_SHAPES[5]):
        hold_grad(f"window_attention_v1 {hp}^2 C{c} nh{nh} Co{co} ws{ws} pool={pool} ln_inside={not pool}",
                  window_attention_v1, window_attention_v1_plain,
                  (*v1_args(rn, 1, hp, c, nh, co, real), ws, pool, not pool, 1e-6),
                  tuple(i for i in range(11) if not (pool and i in (1, 2))), g)


def plain_with_grads(q, k, v, mask, seed, rate, g):
    """The plain dropout attention's (out, lse) and autograd (dq, dk, dv) for output gradient g."""
    from us_video_medsam2_tpu_torch.kernels.flash_dropout import flash_attention_train_plain

    qf, kf, vf = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_train_plain(qf, kf, vf, mask, seed, rate)
    out.backward(g)
    return out.detach(), lse.detach(), (qf.grad, kf.grad, vf.grad)


def hold_dropout(name, got, want) -> float:
    """The dropout kernels' (out, lse, (dq, dk, dv)) against the reference's;
    raises on a disagreement, returns the max abs error."""
    (out, lse, grads), (ref_out, ref_lse, ref_grads) = got, want
    err = compare(f"{name}: out", out, ref_out, attention=True)
    d_lse = (lse - ref_lse).abs().max().item()
    log(f"  {name}: lse max_abs {d_lse:.3e} (tol {LSE_TOL}) {'ok' if d_lse <= LSE_TOL else 'FAIL'}")
    if not d_lse <= LSE_TOL:
        raise AssertionError(f"{name}: lse disagrees with the plain version")
    for gname, g, w in zip(("dq", "dk", "dv"), grads, ref_grads):
        ok, msg, e = grad_agreement(g, w)
        log(f"  {name}: {gname} {msg} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: {gname} disagrees with autograd of the plain version")
        err = max(err, e)
    return err


def check_dropout_call(name, q, k, v, mask, seed, rate, g) -> float:
    """Both dropout flash kernels against the plain version at one shape; max abs error."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import (
        flash_attention_train_plain,
        flash_dropout_bwd,
        flash_dropout_fwd,
    )

    out, lse = flash_dropout_fwd(q, k, v, mask, seed, rate)
    grads = flash_dropout_bwd(q, k, v, mask, seed, rate, out, lse, g)
    torch.cuda.synchronize()
    ref = plain_with_grads(q, k, v, mask, seed, rate, g)
    err = hold_dropout(f"{name} rate {rate}", (out, lse, grads), ref)
    if rate > 0:
        # the check must reject a kernel that draws another dropout pattern
        other = flash_attention_train_plain(q, k, v, mask, seed + 1, rate)[0]
        ok, msg, _ = agreement(other, ref[0], attention=True)
        log(f"  self-test, plain version with seed + 1: {msg} {'passed (FAIL)' if ok else 'rejected'}")
        if ok:
            raise AssertionError("the dropout check does not see another keep mask")
    return err


def train_key_mask(dev):
    """The memory cross-attention key mask of the training path's last tracked
    frame at T = TRAIN_T (frames 0..T-2 in the bank, frame 0 conditioning), as
    ``select_memories`` / ``gather_memories`` give it: [O, Lk] bool."""
    import torch

    from us_video_medsam2_tpu_torch.core.config import resolve_config
    from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, select_memories

    c = resolve_config("sam2.1_hiera_t512")
    bank = init_memory_bank(TRAIN_OBJECTS, TRAIN_T, 1, 1, 1, device=dev)
    bank.valid[:, : TRAIN_T - 1] = True
    bank.is_cond[:, 0] = True
    sel = select_memories(bank, TRAIN_T - 1, c, TRAIN_T, is_training=True)
    tok = c.tokens_per_obj_ptr
    return torch.cat([sel.mem_valid.repeat_interleave(c.feat_size**2, 1),
                      sel.ptr_valid.repeat_interleave(tok, 1)], 1)


def check_dropout_kernels(g, rows) -> None:
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import (
        FWD_BLOCK_Q,
        FWD_BLOCKS_PER_SM,
        bwd_splits,
        flash_attention_train_plain,
        flash_dropout_bwd,
        flash_dropout_fwd,
        fwd_blocks_per_sm,
        fwd_splits,
    )

    dev = "cuda"

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    seed = 1234
    mask = train_key_mask(dev)
    lk_cross = mask.shape[1]
    log(f"flash_dropout (D 256, rate {DROPOUT} and 0): memory attention of the training path, "
        f"{TRAIN_OBJECTS} objects; cross-attention Lk = {lk_cross} at T = {TRAIN_T} "
        f"({int(mask[0].sum())} valid keys on the last tracked frame)")
    held = fwd_blocks_per_sm()  # fwd_splits sizes its grid to one wave of them
    log(f"  forward: {held} blocks an SM (fwd_splits takes {FWD_BLOCKS_PER_SM})")
    if held != FWD_BLOCKS_PER_SM:
        raise AssertionError(f"flash_dropout_fwd: an SM holds {held} blocks, FWD_BLOCKS_PER_SM says "
                             f"{FWD_BLOCKS_PER_SM}")
    clock = sm_clock_hz()
    rf = rows["flash_dropout_fwd"] = Row("flash_dropout_fwd")
    rb = rows["flash_dropout_bwd"] = Row("flash_dropout_bwd")
    b, lq, d = TRAIN_OBJECTS, 1024, 256
    for name, lk, m in (("self", 1024, None), ("cross", lk_cross, mask)):
        q, k, v, go = rn(b, 1, lq, d), rn(b, 1, lk, d), rn(b, 1, lk, d), rn(b, 1, lq, d)
        err = max(check_dropout_call(f"{name} q{lq} k{lk}", q, k, v, m, seed, rate, go)
                  for rate in (DROPOUT, 0.0))
        valid = lk if m is None else int(m[0].sum())
        mb = 0 if m is None else b * lk
        out, lse = flash_dropout_fwd(q, k, v, m, seed, DROPOUT)
        am = None if m is None else m[:, None, None, :]
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

        def plain_fb():
            flash_attention_train_plain(*leaves, m, seed, DROPOUT)[0].backward(go)

        def library_fb():
            F.scaled_dot_product_attention(*leaves, attn_mask=am, dropout_p=DROPOUT).backward(go)

        with torch.no_grad():
            plain_f = time_ms(lambda: flash_attention_train_plain(q, k, v, m, seed, DROPOUT))
            lib_f = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, dropout_p=DROPOUT))
        qkv_bytes = 2 * b * lq * d + 2 * 2 * b * valid * d
        bnd, by = bound_ms(qkv_bytes + mb + 2 * b * lq * d + 4 * b * lq, 4 * b * lq * valid * d, BF16_FLOPS)
        splits = fwd_splits(b, lq, lk)
        # the keep hash: ~12 integer operations an element of the valid keys, at the INT32 rate
        # (132 SMs x 64 lanes x the SM clock); printed beside the bound, which it does not enter
        hash_ms = 12 * b * lq * valid / (132 * 64 * clock) * 1e3
        log(f"    forward grid {-(-lq // FWD_BLOCK_Q)} query tiles x {splits} key splits x {b}; "
            f"hash floor {hash_ms:.4f} ms ({b * lq * valid} elements x 12 at {clock / 1e9:.3f} GHz) beside "
            f"the bound {bnd:.4f} ms ({by})")
        with torch.no_grad():
            dev_f = (device_ms(lambda: flash_dropout_fwd(q, k, v, m, seed, DROPOUT), by_kernel=True),
                     device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, dropout_p=DROPOUT)))
        rf.add([b, lq, lk, d, m is not None], 4, err,
               time_ms(lambda: flash_dropout_fwd(q, k, v, m, seed, DROPOUT)), plain_f, bnd, by, lib_f, dev_f)
        check_fwd_deterministic(f"{name} q{lq} k{lk}, {splits} splits", q, k, v, m, seed)
        reject_fwd_combine(f"{name} q{lq} k{lk}", q, k, v, m, seed, splits)
        check_bwd_deterministic(f"{name} q{lq} k{lk}", q, k, v, m, seed, out, lse, go)
        if m is None:
            reject_dropped_partial(q, k, v, seed, out, lse, go)
        # reads q, k, v, g, out, lse and the mask; writes dq and dk, dv over all Lk keys
        bwd_bytes = qkv_bytes + mb + 2 * 2 * b * lq * d + 4 * b * lq + 2 * b * lq * d + 2 * 2 * b * lk * d
        bnd, by = bound_ms(bwd_bytes, 10 * b * lq * valid * d, BF16_FLOPS)
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=am, dropout_p=DROPOUT)
        dev_ms = (device_ms(lambda: flash_dropout_bwd(q, k, v, m, seed, DROPOUT, out, lse, go)),
                  device_ms(lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True)))
        del lib_out
        rb.add([b, lq, lk, d, m is not None], 4, err,
               time_ms(lambda: flash_dropout_bwd(q, k, v, m, seed, DROPOUT, out, lse, go)),
               time_ms(plain_fb) - plain_f, bnd, by, time_ms(library_fb) - lib_f, dev_ms)
        qs, ks = bwd_splits(b, lq, lk)
        log(f"      backward grids: dk/dv {-(-lk // 64)} key tiles x {qs} query splits x {b}, "
            f"dq {-(-lq // 64)} query tiles x {ks} key splits x {b}")
    log("  library = F.scaled_dot_product_attention(attn_mask=bool, dropout_p=0.1): another keep mask, "
        "the same function in distribution; backward = (forward + backward) - forward; its device time "
        "per call is that of torch.autograd.grad of one forward's output, the forward's that of one call")
    log("flash_dropout edge shapes (bf16, untimed): ragged Lq/Lk, B2 H2, batch 1 all masked")
    q, k, v, go = rn(2, 2, 1000, d), rn(2, 2, 1100, d), rn(2, 2, 1100, d), rn(2, 2, 1000, d)
    m = torch.rand(2, 1100, generator=g, device=dev) > 0.3
    m[1] = False
    for rate in (DROPOUT, 0.0):
        check_dropout_call("B2 H2 q1000 k1100", q, k, v, m, seed, rate, go)
    check_dropout_splits(rn, g, seed)
    check_dropout_fwd_splits(rn, g, seed)
    check_dropout_index_wrap(rn, seed)


def check_fwd_deterministic(name, q, k, v, mask, seed) -> None:
    """Two forward calls on the same inputs give bit-identical out and lse
    (the splits are combined in a fixed order, with no atomics)."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import flash_dropout_fwd

    first = flash_dropout_fwd(q, k, v, mask, seed, DROPOUT)
    second = flash_dropout_fwd(q, k, v, mask, seed, DROPOUT)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    log(f"  {name}: two forward calls bit-identical (out, lse): {same}")
    if not all(same):
        raise AssertionError(f"{name}: the forward kernels are not deterministic")


def reject_fwd_combine(name, q, k, v, mask, seed, splits) -> None:
    """The plain model of the forward's split over key tiles against the
    plain version, then the same model combined without split 0's partial
    and without the exp(m_i - m) weights, both of which the check must
    reject."""
    from us_video_medsam2_tpu_torch.kernels.flash_dropout import (
        combine_fwd_partials,
        flash_attention_train_plain,
        flash_dropout_fwd_split_partials,
    )

    if splits < 2:
        raise AssertionError(f"{name}: the combine self-tests need key splits, got {splits}")
    want, want_lse = flash_attention_train_plain(q, k, v, mask, seed, DROPOUT)
    o, m, l = flash_dropout_fwd_split_partials(q, k, v, mask, seed, DROPOUT, splits)
    out, lse = combine_fwd_partials(o, m, l, q.dtype)
    compare(f"{name}: forward split model ({splits} splits) vs plain, out", out, want, attention=True)
    d_lse = (lse - want_lse).abs().max().item()
    log(f"  {name}: forward split model lse max_abs {d_lse:.3e} (tol {LSE_TOL}) {'ok' if d_lse <= LSE_TOL else 'FAIL'}")
    if not d_lse <= LSE_TOL:
        raise AssertionError(f"{name}: the forward split model's lse disagrees with the plain version")
    unweighted = (o.sum(0) / l.sum(0).clamp_min(1e-30)[..., None]).to(q.dtype)
    for what, bad in (("without split 0's partial", combine_fwd_partials(o[1:], m[1:], l[1:], q.dtype)[0]),
                      ("without the exp(m_i - m) weights", unweighted)):
        ok, msg, _ = agreement(bad, want, attention=True)
        log(f"  self-test, forward split model combined {what}: {msg} {'passed (FAIL)' if ok else 'rejected'}")
        if ok:
            raise AssertionError(f"the dropout forward check does not see a combine {what}")


def check_bwd_deterministic(name, q, k, v, mask, seed, out, lse, go) -> None:
    """Two backward calls on the same inputs give bit-identical dq, dk, dv
    (the splits are summed in a fixed order, with no atomics)."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import flash_dropout_bwd

    first = flash_dropout_bwd(q, k, v, mask, seed, DROPOUT, out, lse, go)
    second = flash_dropout_bwd(q, k, v, mask, seed, DROPOUT, out, lse, go)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    log(f"  {name}: two backward calls bit-identical (dq, dk, dv): {same}")
    if not all(same):
        raise AssertionError(f"{name}: the backward kernels are not deterministic")


def reject_dropped_partial(q, k, v, seed, out, lse, go) -> None:
    """The plain model of the backward's split (its every partial held against
    autograd of the plain version), then the same model with one query
    range's dk partial left out of the combine, which the check must reject."""
    from us_video_medsam2_tpu_torch.kernels.flash_dropout import (
        bwd_splits,
        flash_dropout_bwd_split_partials,
        flash_dropout_bwd_split_plain,
        sum_in_order,
    )

    b, h, lq, d = q.shape
    qs, ks = bwd_splits(b * h, lq, k.shape[2])
    if qs < 2:
        raise AssertionError(f"the dropped-partial self-test needs query splits, got {qs}")
    _, _, (_, ref_dk, _) = plain_with_grads(q, k, v, None, seed, DROPOUT, go)
    model = flash_dropout_bwd_split_plain(q, k, v, None, seed, DROPOUT, out, lse, go, qs, ks)
    ok, msg, _ = grad_agreement(model[1], ref_dk)
    log(f"  split model ({qs} query, {ks} key splits) dk: {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the plain split model disagrees with autograd of the plain version")
    _, dk_i, _ = flash_dropout_bwd_split_partials(q, k, v, None, seed, DROPOUT, out, lse, go, qs, ks)
    dropped = (sum_in_order(dk_i[1:]) * d**-0.5).to(k.dtype)
    ok, msg, _ = grad_agreement(dropped, ref_dk)
    log(f"  self-test, dk without query range 0's partial: {msg} {'passed (FAIL)' if ok else 'rejected'}")
    if ok:
        raise AssertionError("the backward check does not see a dropped dk partial")


def check_dropout_splits(rn, g, seed) -> None:
    """The backward kernels where their splits have edges: ragged last query
    and key ranges with a query range past Lq, a key range holding only masked
    keys beside a batch with no valid key, and one split of each (no
    combine); each held as ``check_dropout_call`` holds it, and repeated
    bit for bit."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_attention import split_ranges
    from us_video_medsam2_tpu_torch.kernels.flash_dropout import bwd_splits, flash_dropout_fwd

    log("flash_dropout backward split geometry (bf16, untimed)")
    for name, (b, h, lq, lk) in (("last ranges ragged, a query range past Lq", (1, 1, 1000, 1100)),
                                 ("a key range of masked keys only, batch 1 all masked", (2, 1, 1024, 1024)),
                                 ("one split of each", (2, 4, 1024, 1000))):
        qs, ks = bwd_splits(b * h, lq, lk)
        q_sizes = [hi - lo for lo, hi in split_ranges(lq, qs, 64)]
        k_ranges = split_ranges(lk, ks, 64)
        k_sizes = [hi - lo for lo, hi in k_ranges]
        mask = torch.rand(b, lk, generator=g, device="cuda") > 0.3
        if name.startswith("last ranges"):
            last_q = [x for x in q_sizes if x][-1]
            last_k = [x for x in k_sizes if x][-1]
            ok = 0 < last_q < q_sizes[0] and 0 < last_k < k_sizes[0] and 0 in q_sizes
        elif name.startswith("a key range"):
            lo, hi = k_ranges[1]
            mask[0, lo:hi] = False
            mask[1] = False
            ok = ks > 2 and hi > lo and bool(mask[0].any())
        else:
            ok = qs == ks == 1
        if not ok:
            raise AssertionError(f"dropout split case '{name}': {qs} query splits {q_sizes}, "
                                 f"{ks} key splits {k_sizes}")
        q, k, v, go = rn(b, h, lq, 256), rn(b, h, lk, 256), rn(b, h, lk, 256), rn(b, h, lq, 256)
        label = f"B{b} H{h} q{lq} k{lk}, splits {q_sizes} x {k_sizes}: {name}"
        check_dropout_call(label, q, k, v, mask, seed, DROPOUT, go)
        out, lse = flash_dropout_fwd(q, k, v, mask, seed, DROPOUT)
        check_bwd_deterministic(label, q, k, v, mask, seed, out, lse, go)


def check_dropout_fwd_splits(rn, g, seed) -> None:
    """The forward where its split of the key tiles has edges: a split whose
    tiles are all masked beside valid ones, a batch with no valid key, a
    ragged last tile; held as ``check_dropout_call`` holds it, and repeated
    bit for bit."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import fwd_split_tiles, fwd_splits

    b, h, lq, lk = 2, 1, 1024, 1100
    splits = fwd_splits(b * h, lq, lk)
    tiles = fwd_split_tiles(lk, splits)
    mask = torch.rand(b, lk, generator=g, device="cuda") > 0.3
    for t in tiles[1]:
        mask[0, t * 64: (t + 1) * 64] = False
    mask[1] = False
    if not (splits > 2 and lk % 64 and bool(mask[0].any())):
        raise AssertionError(f"dropout forward split case: {splits} splits {tiles}")
    label = (f"forward B{b} H{h} q{lq} k{lk}, {splits} splits of tiles {[len(x) for x in tiles]}: split 1's "
             "tiles all masked, batch 1 all masked")
    log("flash_dropout forward split geometry (bf16, untimed)")
    q, k, v, go = rn(b, h, lq, 256), rn(b, h, lk, 256), rn(b, h, lk, 256), rn(b, h, lq, 256)
    check_dropout_call(label, q, k, v, mask, seed, DROPOUT, go)
    check_fwd_deterministic(label, q, k, v, mask, seed)


def check_dropout_index_wrap(rn, seed) -> None:
    """260 heads of q4096 k4096 (D 256, no mask, rate 0.1): the keep hash's
    element index (bh·Lq + q)·Lk + k passes 2^31 at head 128 and 2^32 at
    head 256, where the int32 arithmetic of the JAX hash wraps. Heads 0,
    128, 200 and 259 are held against the plain math of that head alone,
    its keep mask indexed as in the full call (``keep_from_index``)."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.flash_dropout import (
        flash_dropout_bwd,
        flash_dropout_fwd,
        keep_from_index,
    )

    h, n, d = 260, 4096, 256
    q, k, v, go = (rn(1, h, n, d) for _ in range(4))
    out, lse = flash_dropout_fwd(q, k, v, None, seed, DROPOUT)
    grads = flash_dropout_bwd(q, k, v, None, seed, DROPOUT, out, lse, go)
    torch.cuda.synchronize()
    pos = torch.arange(n, device=q.device)
    for j in (0, 128, 200, 259):
        qj, kj, vj = (x[0, j].clone().requires_grad_(True) for x in (q, k, v))
        s = torch.matmul(qj.float(), kj.float().T) * d**-0.5
        keep = keep_from_index((j * n + pos[:, None]) * n + pos[None, :], seed, DROPOUT)
        p = torch.where(keep, torch.softmax(s, -1) / (1.0 - DROPOUT), 0.0)
        ref = torch.matmul(p.to(vj.dtype).float(), vj.float()).to(qj.dtype)
        ref.backward(go[0, j])
        hold_dropout(f"index wrap, head {j} (index from {j * n * n})",
                     (out[0, j], lse[0, j], [x[0, j] for x in grads]),
                     (ref.detach(), torch.logsumexp(s, -1).detach(), (qj.grad, kj.grad, vj.grad)))
    del q, k, v, go, out, lse, grads


def make_video(frames: int, size: int, seed: int, width: int | None = None):
    """uint8 [T, size, width, 3] (width = size unless given): smooth moving
    Gaussian blobs on a gradient, the (x, y) centre of blob 0 on frame 0,
    and the blobs' masks [T, 3, size, width] bool (within one radius of each
    centre)."""
    import numpy as np

    w = size if width is None else width
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:w].astype(np.float32)
    n_blobs = 3
    c0 = rng.uniform(0.25, 0.75, (n_blobs, 2)) * (size if width is None else np.array([w, size]))
    vel = rng.uniform(-3.0, 3.0, (n_blobs, 2))
    rad = rng.uniform(0.06, 0.12, n_blobs) * size
    col = rng.uniform(80, 255, (n_blobs, 3))
    base = (20 + 40 * xx / w + 30 * yy / size)[..., None] * np.ones(3, np.float32)
    video = np.empty((frames, size, w, 3), np.uint8)
    masks = np.empty((frames, n_blobs, size, w), bool)
    for t in range(frames):
        img = base.copy()
        for i in range(n_blobs):
            cx, cy = c0[i] + vel[i] * t
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            a = np.exp(-d2 / (2 * rad[i] ** 2))[..., None]
            img = img * (1 - a) + col[i] * a
            masks[t, i] = d2 < rad[i] ** 2
        video[t] = np.clip(img, 0, 255).astype(np.uint8)
    return video, (float(c0[0, 0]), float(c0[0, 1])), masks


def write_rgba_avi(path, frames, fps: int = 10) -> None:
    """An AVI of raw 32-bit 'RGBA' frames from uint8 RGB [T, H, W, 3], in
    numpy (this script needs no cv2): the layout cv2 writes for the
    'RGBA' fourcc (one ``00dc`` chunk a frame, rows top first, bytes R, G,
    B, A with A 255, an ``idx1`` index), which the port's
    ``utils/video_io.read_rgba_avi`` and cv2 both read back bit for bit
    (tests/test_torch_video_io.py)."""
    import struct

    import numpy as np

    frames = np.asarray(frames, np.uint8)
    t, h, w = frames.shape[:3]
    rgba = np.concatenate([frames, np.full((t, h, w, 1), 255, np.uint8)], axis=-1)
    size = w * h * 4

    def chunk(tag: bytes, data: bytes) -> bytes:
        return tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")

    def lst(typ: bytes, data: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(data) + 4) + typ + data

    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, 0x10, t, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = b"vids" + b"RGBA" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, t, size, 0xFFFFFFFF, 0,
                                           0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 32, b"RGBA", size, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", f.tobytes()) for f in rgba))
    # idx1 offsets count from the movi list's type field: the first chunk sits at 4
    idx1 = chunk(b"idx1", b"".join(struct.pack("<4sIII", b"00dc", 0x10, 4 + i * (8 + size), size)
                                   for i in range(t)))
    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_png_gray(data: bytes):
    """uint8 [H, W] of an 8-bit greyscale PNG whose rows all use filter 0
    (what ``utils/video_io.write_png_gray`` writes); anything else raises."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    off, idat, hdr = 8, b"", None
    while off < len(data):
        n, tag = struct.unpack(">I4s", data[off: off + 8])
        body = data[off + 8: off + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        off += 12 + n
    w, h, depth, color = hdr[:4]
    if (depth, color) != (8, 0):
        raise ValueError(f"PNG of depth {depth}, colour type {color}: not 8-bit greyscale")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError("a PNG row with a filter other than 0")
    return rows[:, 1:].copy()


# The port's names -> the reference's (sam2/modeling), the inverse of the
# port's importer (core/import_torch.py): (pattern, replacement) in order.
REFERENCE_NAMES = [
    (r"^image_encoder\.trunk\.patch_embed\.", "image_encoder.trunk.patch_embed.proj."),
    (r"^image_encoder\.neck\.convs_(\d+)_(\w+)\.", r"image_encoder.neck.convs.\1.\2."),
    (r"^image_encoder\.neck\.convs_(\d+)\.", r"image_encoder.neck.convs.\1.conv."),
    (r"^(mask_downsample|memory_encoder\.pix_feat_proj|memory_encoder\.out_proj)\.conv\.", r"\1."),
    (r"^memory_encoder\.fuser_(\d+)\.dwconv\.conv\.", r"memory_encoder.fuser.layers.\1.dwconv."),
    (r"^memory_encoder\.fuser_(\d+)\.", r"memory_encoder.fuser.layers.\1."),
    (r"^sam_prompt_encoder\.pe_gaussian$", "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^sam_prompt_encoder\.mask_down_conv1\.conv\.", "sam_prompt_encoder.mask_downscaling.0."),
    (r"^sam_prompt_encoder\.mask_down_ln1\.", "sam_prompt_encoder.mask_downscaling.1."),
    (r"^sam_prompt_encoder\.mask_down_conv2\.conv\.", "sam_prompt_encoder.mask_downscaling.3."),
    (r"^sam_prompt_encoder\.mask_down_ln2\.", "sam_prompt_encoder.mask_downscaling.4."),
    (r"^sam_prompt_encoder\.mask_down_conv3\.conv\.", "sam_prompt_encoder.mask_downscaling.6."),
    (r"^sam_prompt_encoder\.no_mask_embed$", "sam_prompt_encoder.no_mask_embed.weight"),
    (r"^sam_mask_decoder\.(iou_token|mask_tokens|obj_score_token)$", r"sam_mask_decoder.\1.weight"),
    (r"^sam_mask_decoder\.upscale_dc1\.", "sam_mask_decoder.output_upscaling.0."),
    (r"^sam_mask_decoder\.upscale_ln\.", "sam_mask_decoder.output_upscaling.1."),
    (r"^sam_mask_decoder\.upscale_dc2\.", "sam_mask_decoder.output_upscaling.3."),
    (r"^sam_mask_decoder\.hyper_mlps_(\d+)\.", r"sam_mask_decoder.output_hypernetworks_mlps.\1."),
    (r"^sam_mask_decoder\.iou_head\.", "sam_mask_decoder.iou_prediction_head."),
    (r"^sam_mask_decoder\.obj_score_head\.", "sam_mask_decoder.pred_obj_score_head."),
    (r"^conv_s([01])\.conv\.", r"sam_mask_decoder.conv_s\1."),
    (r"(blocks|layers)_(\d+)\.", r"\1.\2."),
]
# the reference's shapes of the tables that the importer flattens
REFERENCE_SHAPES = {"maskmem_tpos_enc": lambda v: v.reshape(v.shape[0], 1, 1, -1),
                    "no_mem_embed": lambda v: v.reshape(1, 1, -1), "no_mem_pos_enc": lambda v: v.reshape(1, 1, -1),
                    "no_obj_ptr": lambda v: v.reshape(1, -1), "no_obj_embed_spatial": lambda v: v.reshape(1, -1),
                    "sam_prompt_encoder.no_mask_embed.weight": lambda v: v.reshape(1, -1)}


# The temporal fusion's modules, the port's names -> the reference's
# (sam2_base.py:233-758) for each variant: (kind, reference name), where a
# BatchNorm3d also gets torch's num_batches_tracked and TCE the
# temporal_conv its forward never calls (a checkpoint holds both).
FUSION_REFERENCE_NAMES = {
    "tce": {"depthwise": ("dw", "depthwise_conv.weight"), "pointwise": ("dense", "pointwise"),
            "bn1": ("bn", "bn1"), "bn2": ("bn", "bn2"), "attn_fc1": ("dense", "attention.1"),
            "attn_fc2": ("dense", "attention.3"), "alpha": ("as_is", "alpha")},
    "gfte": {"tattn_in_proj": ("in_proj", "temporal_attention"),
             "tattn_out_proj": ("linear", "temporal_attention.out_proj"),
             "spectral_filters": ("c1", "spectral_filters"),
             **{f"msdw_{k}": ("dw", f"temporal_convs.{n}.weight") for n, k in enumerate((3, 5, 7))},
             **{f"msdw_{k}_bias": ("as_is", f"temporal_convs.{n}.bias") for n, k in enumerate((3, 5, 7))},
             "refine_fc1": ("dense", "refinement.0"), "refine_fc2": ("dense", "refinement.2"),
             "alpha": ("as_is", "alpha"), "beta": ("as_is", "beta"), "gamma": ("as_is", "gamma"),
             "gate_fc1": ("dense", "spectral_gate.1"), "gate_fc2": ("dense", "spectral_gate.3"),
             "norm1": ("bn", "norm1"), "norm2": ("bn", "norm2")},
    "atsf": {"local_dw": ("dw", "local_temp.0.weight"), "local_bn": ("bn", "local_temp.1"),
             "global_proj": ("dense", "global_temp.1"), "global_bn": ("bn", "global_temp.2"),
             "ctattn_fc1": ("dense", "cross_temp_attn.0"), "ctattn_fc2": ("dense", "cross_temp_attn.2"),
             "scale_selector": ("c111", "scale_selector"), "fgate_fc1": ("dense", "fusion_gate.1"),
             "fgate_fc2": ("dense", "fusion_gate.3"), "out_proj": ("dense", "output_proj.0"),
             "out_bn": ("bn", "output_proj.1"), "residual_weight": ("as_is", "residual_weight")},
}
BN_REFERENCE_NAMES = {"weight": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def fusion_to_reference(k, v, variant) -> dict:
    """One temporal-fusion tensor of the port (``temporal_fusion_{i}.*``) ->
    its reference entries."""
    import torch

    m = k.split(".")
    pre, (kind, name) = f"temporal_fusion.{m[0].rsplit('_', 1)[1]}", FUSION_REFERENCE_NAMES[variant][m[1]]
    if kind == "bn":
        out = {f"{pre}.{name}.{BN_REFERENCE_NAMES[m[2]]}": v}
        if m[2] == "mean":
            out[f"{pre}.{name}.num_batches_tracked"] = torch.tensor(0)
        return out
    if kind == "dw":  # [k, C] -> depthwise Conv3d [C, 1, k, 1, 1]
        out = {f"{pre}.{name}": v.t()[:, None, :, None, None].contiguous()}
        if variant == "tce":  # its unused temporal_conv, of the same shape
            out[f"{pre}.temporal_conv.weight"] = torch.zeros_like(out[f"{pre}.{name}"])
        return out
    if kind == "dense":  # Linear [out, in] -> Conv3d 1x1x1 [out, in, 1, 1, 1]
        return {f"{pre}.{name}.{m[2]}": v[..., None, None, None] if m[2] == "weight" else v}
    if kind == "in_proj":
        return {f"{pre}.{name}.in_proj_{m[2]}": v}
    if kind == "linear":
        return {f"{pre}.{name}.{m[2]}": v}
    if kind == "c1":
        return {f"{pre}.{name}": v.reshape(1, -1, 1)}
    if kind == "c111":
        return {f"{pre}.{name}": v.reshape(1, -1, 1, 1, 1)}
    return {f"{pre}.{name}": v}


def to_reference_state_dict(sd, cfg) -> dict:
    """The port's state_dict -> a state_dict in the reference's names and
    layouts (what a MedSAM2 / SAM2.1 ``.pt`` holds, the temporal fusion's
    modules and their BatchNorm running statistics included): the inverse of
    the port's importer, written here on its own so that loading it back is a
    check of that importer."""
    import re

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.ops.posenc import rope_halfsplit_perm

    down = "memory_encoder.mask_downsampler."
    n_conv = sum(1 for k in sd if re.match(rf"{re.escape(down)}encoder_\d+\.conv\.weight$", k))
    out = {}
    for k, v in sd.items():
        v = v.detach().cpu().clone()
        if k.startswith("temporal_fusion_"):
            out.update(fusion_to_reference(k, v, cfg.temporal_fusion.variant))
            continue
        if k == "sam_prompt_encoder.point_embed":  # [not-a-point, 4 point labels]
            out["sam_prompt_encoder.not_a_point_embed.weight"] = v[:1].clone()
            for i in range(4):
                out[f"sam_prompt_encoder.point_embeddings.{i}.weight"] = v[i + 1: i + 2].clone()
            continue
        if k in ("image_encoder.trunk.pos_embed", "image_encoder.trunk.pos_embed_window") and v.dim() == 4:
            v = v.permute(0, 3, 1, 2).contiguous()  # Hiera's NHWC tables -> NCHW
        m = re.match(r"memory_attention\.layers_\d+\.(self_attn|cross_attn_image)\.([qk])_proj\.", k)
        if m:  # the importer's half-split permutation of RoPE q/k, undone
            inv = np.argsort(rope_halfsplit_perm(v.shape[0], cfg.memory_attention.num_heads))
            v = v[torch.from_numpy(inv)].contiguous()
        m = re.match(rf"{re.escape(down)}encoder_(ln_)?(\d+)\.(conv\.)?", k)
        if m:  # LayerNorm2d c sits after conv c, and GELU c after it: 3c, 3c + 1
            k = f"{down}encoder.{3 * int(m.group(2)) + bool(m.group(1))}." + k[m.end():]
        k = k.replace(f"{down}encoder_out.conv.", f"{down}encoder.{3 * n_conv}.")
        for pat, rep in REFERENCE_NAMES:
            k = re.sub(pat, rep, k)
        out[k] = REFERENCE_SHAPES.get(k, lambda x: x)(v)
    return out


def run_main_path(predictor, video, click, stop_after=None, chunk_size=None, **init_kw):
    """init_state (with ``init_kw``: a bucket, host offload) ->
    add_new_points_or_box (frame 0, one positive click) -> propagate_in_video
    (frames 0 to ``stop_after`` - 1 only, when given; ``chunk_size`` frames a
    chunk). Returns ({frame: video-res logits [1, H, W]} in the order
    yielded, seconds of init_state + prompt, seconds of propagation)."""
    import torch

    sync = torch.cuda.synchronize if predictor.device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    size = video.shape[1]
    state = predictor.init_state(video, size, size, **init_kw)
    predictor.add_new_points_or_box(state, 0, 1, points=[list(click)], labels=[1])
    sync()
    t1 = time.perf_counter()
    out = {}
    track = None if stop_after is None else stop_after - 1
    for f, _, masks in predictor.propagate_in_video(state, max_frame_num_to_track=track, chunk_size=chunk_size):
        out[f] = masks[:, 0]
    sync()
    return out, t1 - t0, time.perf_counter() - t1


def profile_run(fn, label, out_dir, wall_s, host_ops: int = 0):
    """``fn()`` once under torch.profiler: device time by kernel (and with
    ``host_ops`` the host's operators of most self CPU time, inflated by the
    profiler's own cost), and a Chrome trace ``{label}_trace.json`` in
    ``out_dir`` when one is given. The idle share is taken against
    ``wall_s``, an unprofiled run's wall time (the profiler slows the host
    down); it is returned."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    wall_us = wall_s * 1e6
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{label}_trace.json"))
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile ({label}): device busy {busy / 1e3:.2f} ms, unprofiled wall "
        f"{wall_us / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{sum(r[1] for r in rows)} kernel launches")
    for us, count, key in rows[:25]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{count:<5d} {key[:110]}")
    if host_ops:
        ops = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
        host = sum(r[0] for r in ops)
        log(f"  host ({label}, profiled): {sum(r[1] for r in ops)} operator calls, self CPU {host / 1e3:.2f} ms")
        for us, count, key in ops[:host_ops]:
            log(f"    {us / 1e3:9.3f} ms {100 * us / host:5.1f}% x{count:<6d} {key[:100]}")
    return 1 - busy / wall_us


def iou(a, b) -> float:
    union = (a | b).sum()
    return 1.0 if union == 0 else float((a & b).sum() / union)


def counters():
    """Every kernel wrapper by name: the registry of ``kernels/_lib.py``
    (``COUNTED``), with every module of the kernels package imported."""
    import importlib
    import pkgutil

    from us_video_medsam2_tpu_torch import kernels
    from us_video_medsam2_tpu_torch.kernels import _lib

    for m in pkgutil.walk_packages(kernels.__path__, kernels.__name__ + "."):
        importlib.import_module(m.name)
    return dict(_lib.COUNTED)


def read_counts(fn):
    """(fn(), {kernel: launches during fn}) with every count set to 0 just before."""
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def trace_mismatch(counts: dict, events) -> dict:
    """{kernel: (launches, events in the trace)} where the trace's events of
    a wrapper's kernel (``KERNEL_SYMBOLS``) differ from its launch counter."""
    import re

    bad = {}
    for k, n in counts.items():
        seen = sum(c for name, c in events.items() if re.search(KERNEL_SYMBOLS[k], name))
        if seen != n:
            bad[k] = (n, seen)
    return bad


def traced_call(fn, what, trace_dir, modules=None, check_busy=True):
    """``fn()`` under ``utils/profiling.trace`` (module ranges of
    ``modules``) with every launch counter set to 0 just before, its trace
    parsed by ``utils/traceparse`` (which refuses a trace in which a launch
    has no device event). Each kernel's events in the trace must also equal
    its launch counter (graph replays included), and with ``check_busy`` the
    parsed busy time ``key_averages()``' on the same profile within
    BUSY_REL_TOL (``key_averages`` takes ~20 s over a training step's trace
    on the card's host: the propagations' are held). A trace short of
    events is taken again (``fn`` called again), up to TRACE_ATTEMPTS
    times, then the run fails. ``fn`` must launch the same kernels each
    call. Returns (the FIRST call's ``fn()``, so that a check of the output
    holds the first call whatever a retry changed; the complete trace's
    launches; its ``parse_trace`` tallies)."""
    import shutil

    import torch

    from us_video_medsam2_tpu_torch.utils import profiling, traceparse

    first = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        shutil.rmtree(trace_dir, ignore_errors=True)
        wrappers = counters()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with profiling.trace(trace_dir, modules=modules) as prof:
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        first = out if attempt == 1 else first
        counts = {k: w.launches for k, w in wrappers.items()}
        events = traceparse.load_events(trace_dir)
        lost = traceparse.lost_launches(events)
        if lost:
            log(f"  {what}, traced (attempt {attempt}): {len(lost)} launches have no device event, launched "
                f"{[round(e['ts'] - lost[0]['ts']) for e in lost[:10]]} us after the first of them")
            continue
        parsed = traceparse.tallies(events)
        bad = trace_mismatch(counts, traceparse.event_counts(events))
        t2 = time.perf_counter()
        ka = 0.0
        for e in (prof.key_averages() if check_busy else ()):
            # the module ranges' device-side annotations are not device work
            if e.device_type == torch.autograd.DeviceType.CUDA and not (
                    getattr(e, "is_user_annotation", False) or e.key.startswith(traceparse.MODULE_PREFIX)
                    or "spin_kernel" in e.key):  # the trace's warm-up launches (torch.cuda._sleep)
                t = getattr(e, "self_device_time_total", None)
                ka += e.self_cuda_time_total if t is None else t
        busy = sum(parsed[0].values())
        rel = abs(busy - ka) / max(ka, 1e-9)
        held = (f"{ka / 1e3:.3f} ms by key_averages() (rel {rel:.2e}, tol {BUSY_REL_TOL}, "
                f"{time.perf_counter() - t2:.1f} s)" if check_busy else "key_averages() not read")
        log(f"  {what}, traced (attempt {attempt}; run {t1 - t0:.1f} s, trace written and parsed "
            f"{t2 - t1:.1f} s): device busy {busy / 1e3:.3f} ms parsed from the trace, {held}; every kernel's "
            f"trace events {'equal' if not bad else 'differ from'} its launches "
            f"{bad or {k: n for k, n in counts.items() if n}}")
        if not bad:
            if check_busy and rel > BUSY_REL_TOL:
                raise AssertionError(f"{what}: parsed busy {busy} us vs key_averages {ka} us")
            return first, counts, parsed
    raise AssertionError(f"{what}: no complete trace, or its kernel events differ from the launch counters, "
                         f"after {TRACE_ATTEMPTS} attempts")


def log_tallies(parsed, per: str, n: int, top: int = 8) -> None:
    """The parsed trace's busy time (and per ``per`` over ``n``), and its
    kernels, modules and categories of most device time."""
    self_op, self_mod, self_cat, _ = parsed
    busy = sum(self_op.values())
    log(f"    device busy {busy / 1e3:.3f} ms = {busy / 1e3 / n:.4f} ms per {per}; by category "
        f"{ {c: round(d / 1e3, 3) for c, d in self_cat.most_common()} }")
    for title, tally in (("kernels", self_op), ("modules", self_mod)):
        for name, d in tally.most_common(top):
            log(f"    {title}: {d / 1e3:9.3f} ms {100 * d / busy:5.1f}%  {name[:100]}")


def make_train_batch(frames: int, size: int, device):
    """Seeded moving blobs (``make_video``) normalized as the predictor does,
    and the masks of the first TRAIN_OBJECTS blobs: a TrainBatch of one video."""
    import torch

    from us_video_medsam2_tpu_torch.inference.transforms import preprocess_images
    from us_video_medsam2_tpu_torch.training.train_step import TrainBatch

    video, _, masks = make_video(frames, size, SEED)
    images = preprocess_images(torch.from_numpy(video).to(device), size)[:, None]
    m = torch.from_numpy(masks[:, :TRAIN_OBJECTS]).to(device)[:, None]
    return TrainBatch(images, m, torch.ones(1, TRAIN_OBJECTS, dtype=torch.bool, device=device))


def fusion_config(fusion=None):
    """The port's TemporalFusionConfig for ``fusion`` ((variant, channels,
    levels)), or the default (none)."""
    from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig

    return TemporalFusionConfig(*fusion) if fusion else TemporalFusionConfig()


def build_train_model(state_dict=None, dropout=DROPOUT, fusion=None, name="sam2.1_hiera_t512"):
    """f32 preset ``name`` with the training config's postprocessing
    (no binarized click memories), memory-attention dropout ``dropout`` and
    temporal fusion ``fusion`` (none by default); weights from ``state_dict``
    or from SEED with the object-score head's output bias at +10, as in
    phase 4 (the fusion's leaves come last, so the others are the same with
    and without it; its constants at their JAX initial values)."""
    import dataclasses

    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.core.config import resolve_config

    base = resolve_config(name)
    model = build_sam2(base, state_dict=state_dict, seed=SEED, binarize_mask_from_pts_for_mem_enc=False,
                       memory_attention=dataclasses.replace(base.memory_attention, dropout=dropout),
                       temporal_fusion=fusion_config(fusion))
    if state_dict is None:
        with torch.no_grad():
            model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    return model


def group_norms(grads: dict) -> dict:
    """Gradient norm of each parameter group the model has."""
    return {g: sum(float(v.float().square().sum()) for n, v in grads.items() if n.startswith(pre)) ** 0.5
            for g, pre in PARAM_GROUPS.items() if any(n.startswith(pre) for n in grads)}


def train_config():
    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig

    return TrainConfig(sim=TrainSimConfig(), loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                       optim=OptimConfig(total_steps=1000))


def run_training(profile_dir=None, out_dir=None, measure_dir=None):
    """Phase 7: the step without temporal fusion (timed steps, the fixed-plan
    step on the card, fused, and on the host; with ``measure_dir``, see
    ``fixed_plan_steps``), then the same with GFTE (timed steps, card
    against host) and the GFTE checkpoint's serving check. Returns (the
    launches of the timed steps without fusion by kernel, the fixed-plan
    step's measures or None)."""
    import torch

    torch.manual_seed(SEED)  # the residual dropouts draw from torch's global generator
    model = build_train_model()
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    size = model.cfg.image_size
    total, walls, peak, plans, _ = timed_train_steps(model, "without temporal fusion", profile_dir)
    del model
    measures = fixed_plan_steps(host_sd, size, (("card", "cuda", torch.bfloat16),
                                                ("card, fused", "cuda", torch.bfloat16),
                                                ("host", "cpu", torch.float32)), measure_dir=measure_dir)
    torch.cuda.empty_cache()

    log(f"  temporal fusion {GFTE_FUSION[0]} (channels {GFTE_FUSION[1]}, top {GFTE_FUSION[2]} FPN levels), "
        "the same step otherwise")
    torch.manual_seed(SEED)
    model = build_train_model(fusion=GFTE_FUSION)
    gfte_sd = {k: v.clone() for k, v in model.state_dict().items()}
    _, gwalls, gpeak, _, _ = timed_train_steps(model, "GFTE", profile_dir, "train_step_gfte", plans)
    del model
    log(f"  GFTE step: median {1e3 * statistics.median(gwalls):.2f} ms/step, peak {gpeak / 2**30:.3f} GiB; "
        f"without fusion: median {1e3 * statistics.median(walls):.2f} ms/step, peak {peak / 2**30:.3f} GiB; "
        f"step by step (the same plans) GFTE - without: {[round(1e3 * (a - b), 2) for a, b in zip(gwalls, walls)]} ms "
        f"({card_line()})")
    fixed_plan_steps(gfte_sd, size, (("card", "cuda", torch.bfloat16), ("host", "cpu", torch.float32)),
                     fusion=GFTE_FUSION, what="GFTE ")
    torch.cuda.empty_cache()
    check_fusion_checkpoint(out_dir)
    return total, measures


def timed_train_steps(model, label, profile_dir=None, profile_label="train_step", plans=None,
                      per_step=PER_TRAIN_STEP, trace_dir=None):
    """One warm-up step and TRAIN_STEPS timed steps of ``model`` on the card
    (bf16 compute, f32 master weights): finite loss and gradient norm, a
    non-zero gradient in every parameter group, exact launch counts, the
    BatchNorm buffers bit-identical after the steps. ``plans``, the step
    generator's state before each step (and the profiled one) of an earlier
    run, gives each step that run's plan: the plan is the first draw of a
    step, the fusion's come after it. ``per_step``: the trunk kernels'
    launches a step. With ``trace_dir``, one more step runs under
    ``utils/profiling.trace`` into that directory, its trace held against
    the launch counters (``traced_call``; a retry replays the step's plan).
    Returns (launches of the timed steps, their walls, peak device memory,
    the generator's states, and the traced step's device ms, launches and
    tracked frames or None)."""
    import torch

    from us_video_medsam2_tpu_torch.training.train_step import create_train_state, make_train_step

    cfg = train_config()
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    state = create_train_state(model, cfg)  # the card, bf16 compute, f32 master weights
    size = model.cfg.image_size
    batch = make_train_batch(TRAIN_T, size, "cuda")
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(SEED)

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    total = {k: 0 for k in counters()}
    walls, states = [], []

    def next_plan(i):
        if plans is not None:
            gen.set_state(plans[i])
        states.append(gen.get_state())

    for i in range(TRAIN_STEPS + 1):  # step 0 is the warm-up
        if i == 1:
            reset_peak_memory()
        next_plan(i)
        (m, wall), counts = read_counts(timed_step)
        plan = m["plan"]
        tracked = TRAIN_T - plan.n_init
        expected = {k: 0 for k in counts}
        expected.update(per_step)
        expected.update({k: v * tracked for k, v in PER_TRACKED_TRAIN_FRAME.items()})
        loss, gnorm = float(m["core_loss"]), float(m["grad_norm"])
        norms = group_norms(m["grads"])
        log(f"  step {i}{' (warm-up)' if i == 0 else ''}: core_loss {loss:.6f}, grad_norm {gnorm:.6f}, "
            f"{1e3 * wall:.2f} ms; plan mode {('point', 'box', 'mask')[plan.mode]}, n_init {plan.n_init}, "
            f"tracked frames {tracked}; launches {counts}")
        if counts != expected:
            raise AssertionError(f"launch counts {counts} != {expected}")
        if not (torch.isfinite(torch.tensor([loss, gnorm])).all() and gnorm > 0):
            raise AssertionError(f"step {i}: core_loss {loss} or grad_norm {gnorm} not finite and positive")
        bad = {g: v for g, v in norms.items() if not (v > 0 and v < float("inf"))}
        if bad:
            raise AssertionError(f"step {i}: zero or non-finite gradient in parameter groups {bad}")
        if i > 0:
            walls.append(wall)
            total = {k: total[k] + counts[k] for k in total}
    peak = torch.cuda.max_memory_allocated()
    log(f"  gradient norm by parameter group (last step): { {g: round(v, 6) for g, v in norms.items()} }")
    log(f"  {label}: {TRAIN_STEPS} steps (T {TRAIN_T}, B 1, O {TRAIN_OBJECTS}): median "
        f"{1e3 * statistics.median(walls):.2f} ms/step (host clock around step + synchronize; "
        f"steps {[round(1e3 * w, 2) for w in walls]}), "
        f"peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated)")
    changed = [n for n, b in model.named_buffers() if not torch.equal(b.cpu(), bufs[n])]
    if changed:
        raise AssertionError(f"{label}: the training steps changed the buffers {changed[:4]}")
    if bufs:
        log(f"  {len(bufs)} BatchNorm buffers bit-identical after {TRAIN_STEPS + 1} steps")
    if profile_dir:
        def profiled():
            p = step(state, batch, gen)["plan"]
            log(f"  profiled step: plan mode {('point', 'box', 'mask')[p.mode]}, n_init {p.n_init}")

        next_plan(TRAIN_STEPS + 1)
        profile_run(profiled, profile_label, profile_dir, statistics.median(walls), host_ops=20)
    traced = None
    if trace_dir is not None:
        next_plan(TRAIN_STEPS + 1 + bool(profile_dir))
        plan_state = gen.get_state()

        def traced_step():
            gen.set_state(plan_state)  # every attempt draws the same plan
            return step(state, batch, gen)

        m, counts, parsed = traced_call(traced_step, f"{label} step", trace_dir, model, check_busy=False)
        tracked = TRAIN_T - m["plan"].n_init
        expected = {k: 0 for k in counts}
        expected.update(per_step)
        expected.update({k: v * tracked for k, v in PER_TRACKED_TRAIN_FRAME.items()})
        check_counts(f"{label}, the traced step", counts, expected)
        traced = {"device_ms": sum(parsed[0].values()) / 1e3, "launches": counts, "tracked": tracked}
        log(f"  {label}: device {traced['device_ms']:.2f} ms in the traced step (tracked frames {tracked}) "
            f"against a median {1e3 * statistics.median(walls):.2f} ms a step on the host clock; {card_line()}")
    return total, walls, peak, states, traced


def fixed_plan_steps(host_sd, size, runs, fusion=None, what="", name="sam2.1_hiera_t512", per_step=PER_TRAIN_STEP,
                     measure_dir=None):
    """One step with a fixed plan and no memory-attention dropout for each of
    ``runs`` ((label, device, dtype); "card, fused" with both fused kernels
    switched on: the same function), each card step's loss and gradient
    held against the host's. With ``measure_dir``, the "card" step runs
    under ``utils/profiling.trace`` into that directory, held against the
    launch counters (``per_step``, the flash kernel 8 a tracked frame; the
    gate holds the first traced call, taken from the seeded weights), and
    the "host" step under ``utils/flops.fn_flops``. Returns {"device_ms",
    "flops"} of the step with ``measure_dir``, else None."""
    import torch

    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig, create_train_state, make_train_step
    from us_video_medsam2_tpu_torch.utils.flops import fn_flops

    cfg = train_config()
    fixed = TrainConfig(sim=TrainSimConfig(prob_to_use_pt_input=0.0, rand_init_cond_frames=False,
                                           num_init_cond_frames=1), loss=cfg.loss, optim=cfg.optim)
    res, measures = {}, None if measure_dir is None else {}
    for label, dev, dtype in runs:
        with fused_switches(label == "card, fused"):
            st = create_train_state(build_train_model(host_sd, dropout=0.0, fusion=fusion, name=name), fixed,
                                    device=dev, dtype=dtype)
            t0 = time.perf_counter()

            def run():
                return make_train_step(fixed)(st, make_train_batch(HOST_T, size, dev),
                                              torch.Generator().manual_seed(SEED))

            if measure_dir is not None and label == "card":
                m, counts, parsed = traced_call(run, f"{what}fixed-plan step, card", measure_dir, st.model,
                                                check_busy=False)
                want = {k: 0 for k in counts}
                want.update(per_step)
                want["flash_attention"] = PER_TRACKED_FRAME["flash_attention"] * (HOST_T - 1)
                check_counts(f"{what}fixed-plan step, card, traced", counts, want)
                measures["device_ms"] = sum(parsed[0].values()) / 1e3
            elif measure_dir is not None and label == "host":
                box = {}
                measures["flops"] = fn_flops(lambda: box.update(m=run()))
                m, counts = box["m"], {}
            else:
                m, counts = read_counts(run)
        res[label] = (float(m["core_loss"]), {n: g.detach().float().cpu() for n, g in m["grads"].items()})
        log(f"  {what}fixed-plan step, {label} ({dtype}, T {HOST_T}): core_loss {res[label][0]:.6f}, "
            f"{time.perf_counter() - t0:.1f} s")
        if label == "card, fused":
            # one batched encoder call; every frame's memory encoded once
            want = {"qkv_window_attention": 9, "window_attention": 0, "cxblock": 2 * HOST_T}
            got = {k: counts[k] for k in want}
            log(f"  fused step launches {got}, expected {want}")
            if got != want:
                raise AssertionError(f"fused training step: launch counts {got} != {want}")
        del st, m
    lh, gh = res["host"]
    for label in (r[0] for r in runs if r[0] != "host"):
        lc, gc = res[label]
        loss_rel = abs(lc - lh) / abs(lh)

        def rel_l2(prefix=""):
            names = [n for n in gh if n.startswith(prefix)]
            num = sum(float((gc[n] - gh[n]).square().sum()) for n in names)
            return (num / max(sum(float(gh[n].square().sum()) for n in names), 1e-30)) ** 0.5

        grad_rel = rel_l2()
        by_group = {g: round(rel_l2(pre), 4) for g, pre in PARAM_GROUPS.items() if any(n.startswith(pre) for n in gh)}
        ok = loss_rel <= LOSS_REL_TOL and grad_rel <= GRAD_VS_HOST_REL_L2_TOL
        log(f"  {what}{label} vs host: loss rel diff {loss_rel:.4e} (tol {LOSS_REL_TOL}), whole-gradient rel-L2 "
            f"{grad_rel:.4e} (tol {GRAD_VS_HOST_REL_L2_TOL}); by group {by_group} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}training step: {label} and host disagree")
    return measures


def check_fusion_checkpoint(out_dir):
    """Phase 7's loader check: seeded ``sam2.1_hiera_t512`` weights with GFTE
    (BatchNorm running statistics drawn from SEED) written as a
    reference-name ``.pt`` with the fusion's keys, a predictor built from it
    through ``ckpt_path=``, and phase 4's 16-frame run of it against the
    same weights without fusion, bit for bit: the predictor passes no
    num_frames, so serving a fusion config computes what it computes
    without."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    fusion = fusion_config(GFTE_FUSION)
    model = build_sam2("sam2.1_hiera_t512", seed=SEED, temporal_fusion=fusion)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
        for n, b in model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) + 0.5 if n.endswith(".var")
                    else 0.1 * torch.randn(b.shape, generator=g))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ref = to_reference_state_dict(sd, model.cfg)
    out_dir = out_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"seed{SEED}_gfte_reference.pt")
    torch.save({"model": ref}, path)
    n_fusion = sum(1 for k in ref if k.startswith("temporal_fusion."))
    log(f"  wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB; {n_fusion} temporal_fusion.* keys, "
        f"num_batches_tracked included)")
    loaded = build_sam2_video_predictor("sam2.1_hiera_t512", ckpt_path=path, fill_hole_area=8, temporal_fusion=fusion)
    os.remove(path)
    bufs = dict(loaded.model.named_buffers())
    if len(bufs) != 12 or not all(torch.equal(bufs[n].cpu(), sd[n]) for n in bufs):
        raise AssertionError("the checkpoint's BatchNorm running statistics did not load into the buffers")
    plain = build_sam2_video_predictor("sam2.1_hiera_t512", fill_hole_area=8,
                                       state_dict={k: v for k, v in sd.items() if not k.startswith("temporal_fusion_")})
    video, click, _ = make_video(FRAMES, model.cfg.image_size, SEED)
    runs = {}
    for how, pred in (("GFTE from the .pt", loaded), ("without fusion", plain)):
        (masks, _, _), _ = counted_run(pred, PER_ENCODED_FRAME, f"checkpoint {how}",
                                       lambda: run_main_path(pred, video, click))
        runs[how] = masks
    a, b = runs["GFTE from the .pt"], runs["without fusion"]
    same = [f for f in b if f in a and np.array_equal(a[f], b[f])]
    log(f"  GFTE checkpoint: {len(bufs)} BatchNorm buffers loaded; {len(same)} of {len(b)} propagated frames "
        "bit-identical to the same weights without fusion")
    if len(same) != len(b) or list(a) != list(b):
        raise AssertionError("serving the GFTE checkpoint differs from serving the same weights without fusion")


@contextlib.contextmanager
def fused_switches(on: bool = True):
    """Both of the JAX package's opt-in kernel switches set inside the block
    when ``on``; unset again after it."""
    if on:
        os.environ.update({k: "1" for k in FUSED_SWITCHES})
    try:
        yield
    finally:
        for k in FUSED_SWITCHES:
            os.environ.pop(k, None)


class EagerBodies:
    """Stands in for a predictor's ``graphs`` (``inference/graphs.py``
    ``FrameGraphs``): each "replay" runs the frame body eagerly on the card,
    over buffers made as for a graph. The predictor has no switch for this;
    the check of graph against eager puts it in place of the graphs."""

    class Body:
        def __init__(self, bufs, body):
            self.bufs, self.body = bufs, body

        def replay(self):
            self.body(self.bufs)

    def __init__(self):
        self.entries = {}
        self.captures = 0

    def get(self, key, make, body, weights=()):
        if key not in self.entries:
            self.entries[key] = self.Body(make(), body)
        return self.entries[key]


def graph_report(predictor, known) -> None:
    """Capture seconds, pool memory and captured launches of each graph not in ``known``."""
    for key, g in predictor.graphs.entries.items():
        if key in known or not hasattr(g, "capture_s"):
            continue
        counts = {getattr(w, "__name__", str(w)): n for w, n in g.counts.items()}
        log(f"  graph (bank slots {key[0]}, objects {key[1]}, cond slots {key[2]}, reverse {key[3]}, "
            f"precompute {key[4]}, frames {key[5]}, fused switches {key[6]}/{key[7]}): warm-up and capture "
            f"{g.capture_s:.3f} s, pool {g.pool_bytes / 2**20:.1f} MiB, captured launches {counts}")


@contextlib.contextmanager
def window_sync_errors(predictor):
    """Inside the block, every host sync inside ``predictor``'s tracking
    window (its ``_run_window``) is an error:
    ``torch.cuda.set_sync_debug_mode("error")`` around each window."""
    import torch

    run = predictor._run_window

    def checked(*args, **kwargs):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    predictor._run_window = checked
    try:
        yield
    finally:
        del predictor._run_window


def timed_runs(predictor, video, click, expected):
    """Warm-up (where the predictor captures its frame body), then REPEATS
    main-path runs with exact launch counts, each a new state of the same
    shape that must capture nothing, with every host sync inside the
    tracking window an error; the median run's (masks, wall, init_state +
    prompt s, propagation s)."""
    import torch

    known = set(predictor.graphs.entries)
    run_main_path(predictor, video, click)  # warm-up: lazy CUDA / library initialisation, capture
    graph_report(predictor, known)
    captures = predictor.graphs.captures
    runs = []
    with window_sync_errors(predictor):
        for _ in range(REPEATS):
            (masks, t_prompt, t_prop), launches = read_counts(lambda: run_main_path(predictor, video, click))
            check_counts("run", launches, expected)
            if predictor.graphs.captures != captures:
                raise AssertionError("a second state of the same shape captured the frame body again")
            runs.append((t_prompt + t_prop, t_prompt, t_prop))
    wall, t_prompt, t_prop = sorted(runs)[len(runs) // 2]
    log(f"  walls of the {len(runs)} runs (s): {[round(r[0], 4) for r in runs]}; median below")
    n = video.shape[0]
    if sorted(masks) != list(range(n)):
        raise AssertionError(f"frames yielded {sorted(masks)}")
    for f, m in masks.items():
        if m.shape != (1, video.shape[1], video.shape[2]) or not torch.isfinite(torch.from_numpy(m)).all():
            raise AssertionError(f"frame {f}: mask logits shape {m.shape} or non-finite values")
    return masks, wall, t_prompt, t_prop


def hold_against_host(masks, ref) -> None:
    """Each host-checked frame: logit rel-L2 and mask IoU outside the bf16 sign band."""
    for f in sorted(ref):
        a, b = masks[f].astype("float64"), ref[f].astype("float64")
        rel = float(((a - b) ** 2).sum() ** 0.5 / max(((b ** 2).sum()) ** 0.5, 1e-12))
        clear = abs(b) > SIGN_BAND * float((b ** 2).mean()) ** 0.5
        iou_all = iou(a > 0, b > 0)
        iou_clear = iou((a > 0) & clear, (b > 0) & clear)
        ok = rel <= LOGIT_REL_L2_TOL and iou_clear >= MASK_IOU_TOL
        log(f"  frame {f}: logit rel-L2 {rel:.4e} (tol {LOGIT_REL_L2_TOL}), mask IoU {iou_clear:.5f} "
            f"on the {float(clear.mean()):.4f} of pixels with |logit| > {SIGN_BAND} rms "
            f"(tol {MASK_IOU_TOL}); IoU over all pixels {iou_all:.5f}, foreground "
            f"{float((b > 0).mean()):.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"frame {f}: card and host disagree")


def hold_graph_against_eager(gmasks, emasks, what, vs="graph vs eager body") -> None:
    """Each frame of a graph run against the same run with the frame body
    eager on the card (or another graph run, as ``vs`` says): the same
    kernels on the same inputs, so the same bits are expected; gated at
    logit rel-L2 and mask IoU outside the bf16 band."""
    same = worst = 0
    for f in sorted(emasks):
        a, b = gmasks[f].astype("float64"), emasks[f].astype("float64")
        same += int((gmasks[f] == emasks[f]).all())
        d = float(abs(a - b).max())
        worst = max(worst, d)
        rel = float(((a - b) ** 2).sum() ** 0.5 / max(((b ** 2).sum()) ** 0.5, 1e-12))
        clear = abs(b) > SIGN_BAND * float((b ** 2).mean()) ** 0.5
        iou_clear = iou((a > 0) & clear, (b > 0) & clear)
        if rel > GRAPH_REL_L2_TOL or iou_clear < GRAPH_MASK_IOU_TOL:
            raise AssertionError(f"{what}, frame {f}: graph and eager disagree (rel-L2 {rel:.4e}, IoU {iou_clear:.5f})")
    log(f"  {what}: {vs}, {same} of {len(emasks)} frames bit-identical, max |d| {worst:.4e} "
        f"(gates rel-L2 <= {GRAPH_REL_L2_TOL}, IoU outside the band >= {GRAPH_MASK_IOU_TOL}) ok")


def eager_runs(predictor, video, click, expected, gmasks, what):
    """The same runs with the frame body eager on the card (``EagerBodies``
    in place of the graphs), held against the graph run's masks; returns
    the median propagation seconds. The graphs are put back after."""
    graphs = predictor.graphs
    predictor.graphs = EagerBodies()
    try:
        emasks, _, _, e_prop = timed_runs(predictor, video, click, expected)
    finally:
        predictor.graphs = graphs
    hold_graph_against_eager(gmasks, emasks, what)
    return e_prop


def check_recapture_after_cast(predictor, video, click, masks, what) -> None:
    """The weight matrices cast to f32 and back to bf16 (the same values in
    new memory): the kept graph read the old memory, so the next window must
    capture anew, and give the masks of before."""
    import torch

    captures = predictor.graphs.captures
    predictor.model.set_compute_dtype(torch.float32).set_compute_dtype(torch.bfloat16)
    again, _, _ = run_main_path(predictor, video, click)
    if predictor.graphs.captures != captures + 1:
        raise AssertionError(f"{what}: weights in new memory, but {predictor.graphs.captures - captures} "
                             f"captures (1 expected)")
    hold_graph_against_eager(again, masks, what, "graph after a cast round trip of the weights vs before")


def run_propagation(name, builder, per_encoded, per_encoded_fused, label, fused_phase, card, profile_dir,
                    iou_margin=None, precompute=0):
    """Propagation of the preset ``name`` at full width in bf16 through
    ``builder`` (the preset's predictor entry point) with seeded weights (the
    object-score head's output bias at +10; ``iou_margin`` = (output, margin)
    added to one IoU-head output bias) and the seeded video: exact launch
    counts, the first CHECK_FRAMES frames held against a host f32 run; then
    the same with both opt-in switches set, held against the same host run.
    Returns the launches of one run of each configuration."""
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.inference.graphs import MAX_GRAPHS

    model = build_sam2(name, seed=SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
        if iou_margin is not None:
            model.sam_mask_decoder.iou_head.layers_2.bias[iou_margin[0]] += iou_margin[1]
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    predictor = builder(name, state_dict=host_sd, fill_hole_area=8)  # the card, bf16
    video, click, _ = make_video(FRAMES, model.cfg.image_size, SEED)

    n = FRAMES
    expected = expected_launches(per_encoded, n, n - 1)
    masks, wall, t_prompt, t_prop = timed_runs(predictor, video, click, expected)
    e_prop = eager_runs(predictor, video, click, expected, masks, f"{name}, default")
    check_recapture_after_cast(predictor, video, click, masks, f"{name}, default")
    fg = [float((masks[f] > 0).mean()) for f in range(n)]
    log(f"  foreground fraction per frame: {[round(x, 4) for x in fg]}")
    log(f"  {n} frames in {wall:.3f} s: {n / wall:.2f} frames/s, {1e3 * wall / n:.2f} ms/frame "
        f"(init_state + prompt + propagation, host clock) on {card}")
    log(f"  init_state + prompt {1e3 * t_prompt:.2f} ms; propagation {1e3 * t_prop:.2f} ms = "
        f"{1e3 * t_prop / (n - 1):.2f} ms per tracked frame ({(n - 1) / t_prop:.2f} frames/s)")
    if profile_dir:
        profile_run(lambda: run_main_path(predictor, video, click), label, profile_dir, wall)

    k = CHECK_FRAMES
    log(f"  host CPU reference (plain versions, f32) on the first {k} frames")
    cpu_pred = builder(name, state_dict=host_sd, fill_hole_area=8, device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    ref, _, _ = run_main_path(cpu_pred, video, click, stop_after=k)
    log(f"  host run {time.perf_counter() - t0:.1f} s")
    hold_against_host(masks, ref)
    del cpu_pred
    p_prop = None
    if precompute:
        # every frame encoded before the window in batches of `precompute`:
        # the encoder's launches per batch, once more for the prompted frame
        batches = -(-n // precompute)
        log(f"  precompute_features_batch={precompute}: {batches} encoder batches before the window, "
            f"plus the prompted frame's encode")
        pre = builder(name, state_dict=host_sd, fill_hole_area=8, precompute_features_batch=precompute)
        pre_expected = expected_launches(per_encoded, 1 + batches, n - 1)
        pmasks, _, _, p_prop = timed_runs(pre, video, click, pre_expected)
        hold_against_host(pmasks, ref)
        del pre

    # the fused configuration: the same model, weights and video with both
    # opt-in kernels switched on. Memory encodings per run: the prompted frame
    # once in propagate_in_video_preflight, then every tracked frame in
    # track_step (models/sam2.py), each through encode_memory's memory_encoder
    # call and its 2 CXBlocks.
    log(f"{fused_phase} fused configuration, {name}: " + " and ".join(f"{k}=1" for k in FUSED_SWITCHES))
    n_mem = 1 + (n - 1)
    fused_expected = expected_launches(per_encoded_fused, n, n - 1)
    fused_expected.update({k: v * n_mem for k, v in PER_MEMORY_ENCODING.items()})
    log(f"  {n} encoded frames, {n - 1} tracked, {n_mem} memory encodings per run")
    with fused_switches():
        fmasks, fwall, f_prompt, f_prop = timed_runs(predictor, video, click, fused_expected)
        fe_prop = eager_runs(predictor, video, click, fused_expected, fmasks, f"{name}, fused")
        if len(predictor.graphs.entries) > MAX_GRAPHS:
            raise AssertionError(f"{len(predictor.graphs.entries)} graphs kept (at most {MAX_GRAPHS})")
        if profile_dir:
            profile_run(lambda: run_main_path(predictor, video, click), f"{label}_fused", profile_dir, fwall)
    hold_against_host(fmasks, ref)

    def ms(seconds):
        return f"{1e3 * seconds / (n - 1):.2f}"

    log(f"  ms per tracked frame (host clock, median of {REPEATS}; for information), {name}: switches off "
        f"{ms(t_prop)}, on {ms(f_prop)}; init_state + prompt off {1e3 * t_prompt:.2f}, on "
        f"{1e3 * f_prompt:.2f}; on {card}")
    log(f"  ms per tracked frame, graph vs eager body (host clock, median of {REPEATS}), {name}: switches off "
        f"{ms(t_prop)} vs {ms(e_prop)}, on {ms(f_prop)} vs {ms(fe_prop)}"
        + (f"; precompute_features_batch={precompute} (graph) {ms(p_prop)}" if precompute else "")
        + f"; on {card}")
    return {"default": expected, "fused": fused_expected}


def expected_launches(per_encoded, encoded: int, tracked: int) -> dict:
    """Exact launch counts of a run that encoded ``encoded`` frames and tracked
    ``tracked`` (a capture's warm-up runs the frame body once eagerly: count
    it as one of each)."""
    expected = {k: 0 for k in counters()}
    expected.update({k: v * encoded for k, v in per_encoded.items()})
    expected.update({k: v * tracked for k, v in PER_TRACKED_FRAME.items()})
    return expected


def check_counts(what, launches, expected) -> None:
    log(f"  {what}: launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{what}: launch counts {launches} != {expected}")


def counted_run(predictor, per_encoded, what, fn):
    """``fn()`` (one prompted frame, then propagation; returns (masks, ...))
    with the counts read around it and, on the card, held against one encode
    per frame yielded and one track per frame past the first, plus one of
    each per capture it made (the host's plain versions count nothing)."""
    captures = predictor.graphs.captures
    out, launches = read_counts(fn)
    made = predictor.graphs.captures - captures
    n = len(out[0])
    if predictor.device.type == "cuda":
        check_counts(what, launches, expected_launches(per_encoded, n + made, n - 1 + made))
    return out, made


def peak_bytes(fn):
    """(fn(), the most device memory allocated while it ran)."""
    import torch

    torch.cuda.synchronize()
    reset_peak_memory()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def in_order(masks, n, what) -> None:
    if list(masks) != list(range(n)):
        raise AssertionError(f"{what}: frames yielded {list(masks)[:8]}..., not 0..{n - 1} in order")


def check_checkpoint_load(name, builder, host_sd, cfg, video, click, per_encoded, out_dir):
    """Phase 8 (a): the seeded weights written as a reference-name ``.pt``
    (weights under "model", the inverse key map ``to_reference_state_dict``),
    a predictor built from that file, and the main path's masks of both
    predictors bit for bit. Returns the loaded predictor."""
    import numpy as np
    import torch

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"seed{SEED}_{name}_reference.pt")
    torch.save({"model": to_reference_state_dict(host_sd, cfg)}, path)
    log(f"  wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB, {len(host_sd)} port tensors)")
    runs = {}
    for how, kw in (("seeded", {"state_dict": host_sd}), ("loaded", {"ckpt_path": path})):
        pred = builder(name, fill_hole_area=8, **kw)
        (masks, _, _), _ = counted_run(pred, per_encoded, f"checkpoint {how}",
                                       lambda: run_main_path(pred, video, click))
        runs[how] = (pred, masks)
    os.remove(path)
    seeded, loaded = runs["seeded"][1], runs["loaded"][1]
    same = [f for f in seeded if np.array_equal(seeded[f], loaded[f])]
    log(f"  checkpoint loaded by reference names: {len(same)} of {len(seeded)} frames bit-identical "
        f"to the seeded predictor's")
    if len(same) != len(seeded) or list(loaded) != list(seeded):
        raise AssertionError("the predictor built from the checkpoint disagrees with the seeded one")
    return runs["loaded"][0]


def check_long_video(predictor, per_encoded, size, card, profile_dir, on_card=True, frames=LONG_FRAMES,
                     repeat=REPEAT_FRAMES, chunk=STREAM_CHUNK, bucket=LONG_BUCKET, warm=WARM_FRAMES,
                     profiled=PROFILE_FRAMES):
    """Phase 8 (b): a ``frames``-frame uint8 study offloaded to the host and
    streamed ``chunk`` frames at a time, against the same video resident on
    the device; then a ``repeat``-frame video in the same bucket. On the card:
    both graphs captured beforehand by short runs of their keys; each measured
    run's windows sync-free, its launches exact and its peak device memory
    read; the offloaded peak ``OFFLOAD_SAVING`` below the resident; the repeat
    run without a capture and its peak within ``PEAK_SPREAD``; the idle share
    of a profiled streamed run. Returns the three runs' masks."""
    video, click, _ = make_video(frames, size, SEED)
    stream = {"chunk_size": chunk, "offload_video_to_host": True}
    log(f"  video: {frames} frames of {size}x{size} uint8 ({video.nbytes / 2**20:.0f} MiB on the host)")
    if on_card:
        known = set(predictor.graphs.entries)
        t0 = time.perf_counter()
        for what, kw in (("streamed", dict(t_bucket=bucket, **stream)), ("resident", dict(t_bucket=frames))):
            counted_run(predictor, per_encoded, f"{what} warm-up ({warm} frames)",
                        lambda kw=kw: run_main_path(predictor, video[:warm], click, **kw))
        graph_report(predictor, known)
        log(f"  the streamed and the resident key captured by {warm}-frame runs in "
            f"{time.perf_counter() - t0:.2f} s")
    captures = predictor.graphs.captures
    results = {}
    for what, n, kw in (("streamed", frames, stream), ("resident", frames, {}), ("repeat", repeat, stream)):
        def go(n=n, kw=kw):
            return run_main_path(predictor, video[:n], click, **kw)

        if on_card:
            with window_sync_errors(predictor):
                ((masks, t_prompt, t_prop), peak), launches = read_counts(lambda: peak_bytes(go))
            check_counts(f"{what} ({n} frames)", launches, expected_launches(per_encoded, n, n - 1))
        else:
            (masks, t_prompt, t_prop), peak = go(), None
        in_order(masks, n, what)
        if predictor.graphs.captures != captures:
            raise AssertionError(f"{what} ({n} frames): captured the frame body again")
        results[what] = (masks, t_prop / (n - 1), peak)
        log(f"  {what} ({n} frames{f', chunks of {chunk}, offloaded' if kw else ', resident'}): "
            f"init_state + prompt {1e3 * t_prompt:.2f} ms, propagation {t_prop:.3f} s = "
            f"{1e3 * t_prop / (n - 1):.3f} ms per tracked frame"
            + (f", peak device memory {peak / 2**20:.1f} MiB" if peak is not None else ""))
    hold_graph_against_eager(results["streamed"][0], results["resident"][0], f"{frames}-frame study",
                             "offloaded and streamed vs resident")
    ms = {k: 1e3 * v[1] for k, v in results.items()}
    log(f"  ms per tracked frame (host clock), streamed {ms['streamed']:.3f} vs resident {ms['resident']:.3f}; "
        f"{repeat}-frame streamed {ms['repeat']:.3f}; on {card}")
    if on_card:
        p_off, p_res, p_rep = (results[k][2] for k in ("streamed", "resident", "repeat"))
        log(f"  peak device memory: offloaded {p_off / 2**20:.1f} MiB vs resident {p_res / 2**20:.1f} MiB "
            f"({(p_res - p_off) / 2**30:.3f} GiB lower, at least {OFFLOAD_SAVING / 2**30:.3f} required); "
            f"{repeat} frames {p_rep / 2**20:.1f} MiB ({(p_rep - p_off) / 2**20:+.1f} MiB, within "
            f"{PEAK_SPREAD / 2**20:.0f}); no capture after the warm-up runs")
        if p_res - p_off < OFFLOAD_SAVING:
            raise AssertionError("the offloaded run's peak is not low enough")
        if abs(p_rep - p_off) > PEAK_SPREAD:
            raise AssertionError(f"the {repeat}-frame run's peak is not that of the {frames}-frame run")

        def short():
            return counted_run(predictor, per_encoded, f"profiled streamed run ({profiled} frames)",
                               lambda: run_main_path(predictor, video[:profiled], click, t_bucket=bucket,
                                                     **stream))[0]

        _, t_prompt, t_prop = short()
        idle = profile_run(short, "streamed", profile_dir, t_prompt + t_prop)
        log(f"  idle share of a profiled {profiled}-frame streamed run (bucket {bucket}): {idle:.3f} on {card}")
    return {k: v[0] for k, v in results.items()}


def check_buckets(predictor, per_encoded, size, on_card=True, lengths=BUCKET_FRAMES):
    """Phase 8 (c): videos of ``lengths`` frames with t_bucket="auto" share one
    capture, and each meets the graph-vs-eager gate against its exact-shape
    session."""
    video, click, _ = make_video(max(lengths), size, SEED)
    captures = predictor.graphs.captures
    bucketed = {}
    for n in lengths:
        (bucketed[n], _, _), _ = counted_run(predictor, per_encoded, f"{n} frames, t_bucket auto",
                                             lambda n=n: run_main_path(predictor, video[:n], click, t_bucket="auto"))
    made = predictor.graphs.captures - captures
    log(f"  lengths {list(lengths)} with t_bucket='auto': {made} capture(s)")
    if on_card and made != 1:
        raise AssertionError(f"lengths {list(lengths)} of one bucket made {made} captures, not 1")
    for n in lengths:
        (exact, _, _), _ = counted_run(predictor, per_encoded, f"{n} frames, exact",
                                       lambda n=n: run_main_path(predictor, video[:n], click))
        in_order(bucketed[n], n, f"{n} frames, bucketed")
        hold_graph_against_eager(bucketed[n], exact, f"{n} frames", "bucketed (64 slots) vs exact-shape session")


def editing_sequence(predictor, video, clicks) -> dict:
    """Phase 8 (d) on one predictor: three objects clicked on frames 0 and 8,
    propagation forward; the second object removed; frame 8's prompts
    cleared; frame 8 re-prompted for the first object with its earlier
    low-res logits (``prev_low_res_mask``); propagation forward, then in
    reverse from frame 8. Returns {(pass, frame): (object ids, logits [O,
    H, W] of every row)} of every frame yielded, and the frames each pass
    ran."""
    size = video.shape[1]
    state = predictor.init_state(video, size, size, max_objects=3)
    for f in (0, 8):
        for o in (1, 2, 3):
            predictor.add_new_points_or_box(state, f, o, points=[list(clicks[f][o - 1])], labels=[1])
    out, ran = {}, {}

    def propagate(label, **kw):
        ran[label] = 0
        for f, ids, masks in predictor.propagate_in_video(state, **kw):
            out[(label, f)] = (ids, masks[:, 0])
            ran[label] += f not in state.cond_low_res

    propagate("forward")
    predictor.remove_object(state, 2)
    prev = state.cond_low_res[8][0].float().cpu().numpy()
    for o in (1, 3):
        predictor.clear_all_prompts_in_frame(state, 8, o)
    if 8 in state.cond_low_res:
        raise AssertionError("frame 8 still conditioning after its prompts were cleared")
    predictor.add_new_points_or_box(state, 8, 1, points=[list(clicks[8][0])], labels=[1], prev_low_res_mask=prev)
    propagate("forward again")
    propagate("reverse", reverse=True, start_frame_idx=8)
    return out, ran


def blob_clicks(masks, frames=(0, 8)):
    """{frame: [(x, y) centre of each blob]} from ``make_video``'s masks."""
    import numpy as np

    out = {}
    for f in frames:
        pts = []
        for m in masks[f]:
            yy, xx = np.nonzero(m)
            # a blob that has left the frame: a click in the middle
            pts.append((float(xx.mean()), float(yy.mean())) if len(xx) else (m.shape[1] / 2, m.shape[0] / 2))
        out[f] = pts
    return out


def per_object(frames) -> dict:
    """{(pass, frame, object id): logits [H, W]} of the live objects."""
    return {(label, f, obj): rows[oi] for (label, f), (ids, rows) in frames.items() for oi, obj in enumerate(ids)}


def check_editing(name, builder, host_sd, per_encoded, size, on_card=True):
    """Phase 8 (d): the editing sequence on the card with ``non_overlap_masks``
    and the scrub on (for every object), again on the card without
    ``non_overlap_masks``, and on the host CPU without it (plain versions,
    f32). The card's first run must be its second constrained (per pixel
    only the row of the highest logit keeps it), bit for bit. Every yielded
    frame of each live object of the unconstrained runs is held to the
    card-vs-host gate; the constrained frames are held to it rank by rank
    (the rows' logits sorted at each pixel), since with seeded weights the
    objects' tracked logits nearly tie and which object keeps a pixel is a
    rounding. On the card the launches of the first run are exact (2
    prompted frames encoded, frame 8 once more, the frame body once a frame
    run and once more per capture)."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.video_predictor import _non_overlap

    video, _, masks = make_video(FRAMES, size, SEED)
    clicks = blob_clicks(masks)
    flags = dict(fill_hole_area=8, non_overlap_masks=True, clear_non_cond_mem_around_input=True,
                 clear_non_cond_mem_for_multi_obj=True)
    free_flags = dict(flags, non_overlap_masks=False)
    card = builder(name, state_dict=host_sd, **flags)
    captures = card.graphs.captures
    (got, ran), launches = read_counts(lambda: editing_sequence(card, video, clicks))
    made = card.graphs.captures - captures
    tracked = sum(ran.values())
    log(f"  frames run by each pass {ran}; {made} capture(s)")
    if on_card:
        check_counts("editing sequence", launches, expected_launches(per_encoded, 3 + tracked + made, tracked + made))
    del card
    free, _ = editing_sequence(builder(name, state_dict=host_sd, **free_flags), video, clicks)

    def constrained(frames):
        return {k: _non_overlap(torch.from_numpy(rows)).numpy() for k, (_, rows) in frames.items()}

    same = sum(np.array_equal(got[k][1], v) for k, v in constrained(free).items())
    log(f"  non_overlap_masks: {same} of {len(got)} frames the unconstrained run's frames so constrained, "
        f"bit for bit")
    if same != len(got) or list(free) != list(got):
        raise AssertionError("the card's non-overlapping masks are not its unconstrained masks constrained")
    host = builder(name, state_dict=host_sd, device="cpu", dtype=torch.float32, **free_flags)
    t0 = time.perf_counter()
    want, ran_host = editing_sequence(host, video, clicks)
    log(f"  host run of the sequence {time.perf_counter() - t0:.1f} s")
    if ran_host != ran or list(want) != list(got):
        raise AssertionError(f"card and host yielded other frames: {ran} vs {ran_host}")
    log("  unconstrained, each live object:")
    hold_against_host(per_object(free), per_object(want))
    log("  non_overlap_masks, each rank of the rows' logits sorted at every pixel:")

    def ranks(frames):
        return {(label, f, r): rows for (label, f), x in frames.items()
                for r, rows in enumerate(np.sort(x, axis=0)[::-1])}

    hold_against_host(ranks({k: v[1] for k, v in got.items()}), ranks(constrained(want)))
    return got


def run_long_video_and_editing(name, builder, per_encoded, card, profile_dir, out_dir, on_card=True,
                               long_video=None, bucket_lengths=BUCKET_FRAMES):
    """Phase 8 for the preset ``name`` through ``builder`` (bf16, the default
    switches): (a) a reference-name checkpoint loaded, (b) a long study
    offloaded and streamed, (c) two lengths of one bucket, (d) the editing
    sequence, each with the seeded weights of phase 4 (the object-score
    head's output bias at +10)."""
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2

    model = build_sam2(name, seed=SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    size = model.cfg.image_size
    video, click, _ = make_video(FRAMES, size, SEED)
    log(f"  (a) {name}'s seeded weights as a reference-name .pt under \"model\", loaded through ckpt_path=")
    predictor = check_checkpoint_load(name, builder, host_sd, model.cfg, video, click, per_encoded, out_dir)
    log("  (b) a long study: uint8, offloaded to the host, streamed in chunks, against the video resident")
    check_long_video(predictor, per_encoded, size, card, profile_dir, on_card, **(long_video or {}))
    log(f"  (c) lengths {list(bucket_lengths)} with t_bucket='auto' against their exact-shape sessions")
    check_buckets(predictor, per_encoded, size, on_card, bucket_lengths)
    del predictor
    log("  (d) editing, three objects: remove_object, clear_all_prompts_in_frame, prev_low_res_mask, "
        "non_overlap_masks, the scrub; card vs host")
    check_editing(name, builder, host_sd, per_encoded, size, on_card)


def gray(video):
    """uint8 [T, H, W, 3] -> [T, H, W], the channels' mean."""
    return video.mean(-1).astype("uint8")


def write_app_data(root, size) -> dict:
    """Seeded NPZ inputs of the five apps under ``root``: two infer_video
    videos (classes 1 and 2 every frame), one infer_mri video, two RECIST
    cases (RECIST_SIDES) and a host-checked RECIST_HOST_SLICES one, a CT
    volume in HU at model resolution ``size`` with its key slice, box and
    nodule point. Returns where each is and what each app prompts."""
    import numpy as np

    d = {k: os.path.join(root, k) for k in ("videos", "mri", "recist", "recist_host", "volume")}
    for p in d.values():
        os.makedirs(p, exist_ok=True)
    h, w = APP_HW
    first = []
    for i in range(2):
        video, _, masks = make_video(APP_FRAMES, h, SEED + 1 + i, width=w)
        gts = np.zeros(video.shape[:3], np.uint8)
        gts[masks[:, 0]] = 1
        gts[masks[:, 1]] = 2
        first.append(int(np.nonzero((gts > 0).any(axis=(1, 2)))[0][0]))
        np.savez_compressed(os.path.join(d["videos"], f"video_{i}.npz"), imgs=gray(video), gts=gts)
    video, _, _ = make_video(MRI_FRAMES, h, SEED + 3, width=w)
    np.savez_compressed(os.path.join(d["mri"], "mri_0.npz"), imgs=gray(video))

    def recist_case(path, slices, side, seed):
        video, _, masks = make_video(slices, side, seed)
        z = slices // 2
        ys, xs = np.nonzero(masks[z, 0])
        row = int(np.median(ys))
        recist = np.zeros(video.shape[:3], np.uint8)
        recist[z, row, xs[ys == row]] = 1  # the lesion's diameter line on its middle slice
        np.savez_compressed(path, imgs=gray(video), recist=recist, spacing=np.array([2.5, 0.8, 0.8]))

    for k, side in enumerate(RECIST_SIDES):
        recist_case(os.path.join(d["recist"], f"case_{side}.npz"), RECIST_SLICES, side, SEED + 4 + k)
    recist_case(os.path.join(d["recist_host"], "case_host.npz"), RECIST_HOST_SLICES, RECIST_SIDES[1], SEED + 6)
    video, _, masks = make_video(VOLUME_SLICES, size, SEED + 7)
    key = VOLUME_SLICES // 2
    ys, xs = np.nonzero(masks[key, 0])
    np.savez_compressed(os.path.join(d["volume"], "ct.npz"), imgs=(gray(video).astype(np.int16) * 6 - 1000))
    box = [max(float(xs.min()) - 8, 0.0), max(float(ys.min()) - 8, 0.0), min(float(xs.max()) + 8, size - 1.0),
           min(float(ys.max()) + 8, size - 1.0)]
    d.update(video_first=first, key=key, box=box, point=(key, float(ys.mean()), float(xs.mean())))
    return d


def sync(device) -> None:
    """Wait for the device's work (a CUDA device; the CPU's is done)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def counted_app(what, fn, prompts: int, tracked: int, on_card: bool = True,
                builder: str = "build_sam2_video_predictor_npz"):
    """``fn()`` (an app's ``main``) with the launches counted around it and,
    on the card, held against the predictor's: one encode per prompted and
    per tracked frame, one track per tracked frame, one of each per capture
    the app's predictor made (read through ``builder``, the function of
    ``core/build.py`` the app calls; the host's plain versions count
    nothing). Returns the launches and seconds."""
    from us_video_medsam2_tpu_torch.core import build as build_mod

    made = []
    real = getattr(build_mod, builder)

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    setattr(build_mod, builder, recording)
    t0 = time.perf_counter()
    try:
        _, launches = read_counts(fn)
    finally:
        delattr(build_mod, builder)
    secs = time.perf_counter() - t0
    captures = sum(p.graphs.captures for p in made)
    log(f"  {what}: {secs:.2f} s (the predictor built from the checkpoint, then the run); {prompts} prompted and "
        f"{tracked} tracked frames, {captures} capture(s)")
    if on_card:
        check_counts(what, launches, expected_launches(PER_ENCODED_FRAME, prompts + tracked + captures,
                                                       tracked + captures))
    return {k: v for k, v in launches.items() if v}, secs


def check_apps(name, host_sd, cfg, card, work, device="cuda"):
    """Phase 9 (a): the five apps through their ``main``s on the card, from a
    reference-name checkpoint of the seeded weights; each output's shape and
    a non-empty mask; each app's launches; infer_ct_recist's ``infer_case``
    on a 16-slice case against the host (plain versions, f32)."""
    import types

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.apps import infer_3d_ct, infer_ct_recist, infer_luna25, infer_mri, infer_video
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    size = cfg.image_size
    on_card = torch.device(device).type == "cuda"
    data = write_app_data(os.path.join(work, "data"), size)
    ckpt = os.path.join(work, f"seed{SEED}_{name}_reference.pt")
    torch.save({"model": to_reference_state_dict(host_sd, cfg)}, ckpt)
    common = ["--cfg", name, "--checkpoint", ckpt, "--device", str(device)]
    out = {k: os.path.join(work, "out", k) for k in ("video", "mri", "recist", "ct3d", "luna", "host")}
    per_app = {}

    per_app["infer_video"] = counted_app(
        "infer_video (2 videos of 32 frames, 600x800)",
        lambda: infer_video.main(["--data_dir", data["videos"], "--out_dir", out["video"], *common]),
        prompts=2, tracked=sum(APP_FRAMES - 1 - f for f in data["video_first"]), on_card=on_card)
    with open(os.path.join(out["video"], "metrics.csv")) as f:
        rows = [r.strip().split(",") for r in f]
    alls = [r for r in rows if r[0] == "ALL"]
    log(f"  metrics.csv: {len(rows) - 1} rows; ALL rows {alls}")
    if [r[1] for r in alls] != ["1", "2"] or not all(float(r[2]) > 0 for r in alls):
        raise AssertionError("infer_video: metrics.csv lacks its ALL rows, or a class has no overlap at all")

    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    if has_pil:
        per_app["infer_mri"] = counted_app(
            "infer_mri (one video of 16 frames, 600x800, PNGs)",
            lambda: infer_mri.main(["--data_dir", data["mri"], "--out_dir", out["mri"], *common]),
            prompts=1, tracked=MRI_FRAMES - 1, on_card=on_card)
        from PIL import Image

        pngs = sorted(os.listdir(os.path.join(out["mri"], "mri_0")))
        first = np.asarray(Image.open(os.path.join(out["mri"], "mri_0", "0000_mask.png")))
        log(f"  infer_mri: {len(pngs)} PNGs, frame 0 mask {first.shape}, {int((first > 0).sum())} pixels set")
        if len(pngs) != 2 * MRI_FRAMES or first.shape != APP_HW or not first.any():
            raise AssertionError("infer_mri: PNGs missing, of another size, or an empty first mask")
    else:
        log("  PIL is not installed here: infer_mri's main (it writes PNGs through PIL) not run")

    per_app["infer_ct_recist"] = counted_app(
        f"infer_ct_recist (2 cases of {RECIST_SLICES} slices, {RECIST_SIDES[0]}² and {RECIST_SIDES[1]}²)",
        lambda: infer_ct_recist.main(["--imgs_path", data["recist"], "--pred_save_dir", out["recist"], *common]),
        prompts=3 * len(RECIST_SIDES), tracked=len(RECIST_SIDES) * (RECIST_SLICES - 1), on_card=on_card)
    for side in RECIST_SIDES:
        segs = np.load(os.path.join(out["recist"], f"case_{side}.npz"))["segs"]
        log(f"  infer_ct_recist case {side}²: segs {segs.shape}, {int((segs > 0).sum())} voxels on "
            f"{int(segs.any(axis=(1, 2)).sum())} slices")
        if segs.shape != (RECIST_SLICES, side, side) or not segs[RECIST_SLICES // 2].any():
            raise AssertionError(f"infer_ct_recist case {side}²: wrong shape or an empty prompted slice")

    key, box = data["key"], data["box"]
    per_app["infer_3d_ct"] = counted_app(
        f"infer_3d_ct ({VOLUME_SLICES} slices, {size}², HU windowed)",
        lambda: infer_3d_ct.main(["--input", os.path.join(data["volume"], "ct.npz"), "--out_dir", out["ct3d"],
                                  "--key_slice", str(key), "--box", *map(str, box), "--window_level", "-400",
                                  "--window_width", "1200", *common]),
        prompts=2, tracked=VOLUME_SLICES - 1, on_card=on_card)
    per_app["infer_luna25"] = counted_app(
        f"infer_luna25 ({VOLUME_SLICES} slices, {size}², lung window)",
        lambda: infer_luna25.main(["--input", os.path.join(data["volume"], "ct.npz"), "--out_dir", out["luna"],
                                   "--coord_zyx", *map(str, data["point"]), *common]),
        prompts=2, tracked=VOLUME_SLICES - 1, on_card=on_card)
    for app, path in (("infer_3d_ct", os.path.join(out["ct3d"], "ct_seg.npz")),
                      ("infer_luna25", os.path.join(out["luna"], "ct_nodule.npz"))):
        segs = np.load(path)["segs"]
        log(f"  {app}: segs {segs.shape}, {int(segs.sum())} voxels on {int(segs.any(axis=(1, 2)).sum())} slices")
        if segs.shape != (VOLUME_SLICES, size, size) or not segs[key].any():
            raise AssertionError(f"{app}: wrong shape or an empty key slice")
    log("  launches by app: " + json.dumps({k: v[0] for k, v in per_app.items()}))

    # infer_case on the card against the host
    case = os.path.join(data["recist_host"], "case_host.npz")
    segs, logits = {}, {}
    for where, kw in (("card", {"device": device}), ("host", {"device": "cpu", "dtype": torch.float32})):
        pred = LogitRecorder(build_sam2_video_predictor(name, state_dict=host_sd, **kw))
        d = os.path.join(out["host"], where)
        os.makedirs(d, exist_ok=True)
        secs = infer_ct_recist.infer_case(pred, case, types.SimpleNamespace(pred_save_dir=d, shift=0,
                                                                            propagate_with_box=True))
        segs[where] = np.load(os.path.join(d, "case_host.npz"))["segs"] > 0
        logits[where] = pred.logits
        log(f"  infer_case, {RECIST_HOST_SLICES} slices at {RECIST_SIDES[1]}², {where}: {secs:.2f} s, "
            f"{int(segs[where].sum())} voxels, {sum(map(len, pred.logits.values()))} logit maps returned")
        del pred
    # a voxel is clear of the bf16 band when every logit map the host's run
    # thresholded on its slice (prompt, mask hand-off, both passes) is
    clear = np.stack([np.all([abs(x) > SIGN_BAND * float((x.astype("float64") ** 2).mean()) ** 0.5
                              for x in logits["host"][z]], axis=0) for z in range(RECIST_HOST_SLICES)])
    v = iou(segs["card"], segs["host"])
    v_clear = iou(segs["card"] & clear, segs["host"] & clear)
    per_slice = [round(iou(a, b), 4) for a, b in zip(segs["card"], segs["host"])]
    log(f"  infer_case card vs host: voxel IoU {v:.5f}, outside the bf16 band {v_clear:.5f} (tol {VOXEL_IOU_TOL}) "
        f"on the {float(clear.mean()):.4f} of voxels clear of it; per slice {per_slice}")
    if v_clear < VOXEL_IOU_TOL:
        raise AssertionError(f"infer_case: card and host segmentations disagree (voxel IoU outside the band "
                             f"{v_clear:.5f})")
    os.remove(ckpt)
    return {"launches": per_app, "videos": data["videos"], "first": data["video_first"],
            "metrics_csv": os.path.join(out["video"], "metrics.csv")}


class LogitRecorder:
    """A video predictor whose prompt calls' and propagation's video-res
    logits of object 0 are kept by frame ({frame: [logits, ...]}), in the
    order returned; everything else is the predictor's."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.logits = {}

    def __getattr__(self, name):
        return getattr(self.predictor, name)

    def _keep(self, out):
        self.logits.setdefault(out[0], []).append(out[2][0, 0])
        return out

    def add_new_points_or_box(self, *args, **kwargs):
        return self._keep(self.predictor.add_new_points_or_box(*args, **kwargs))

    def add_new_mask(self, *args, **kwargs):
        return self._keep(self.predictor.add_new_mask(*args, **kwargs))

    def propagate_in_video(self, *args, **kwargs):
        for out in self.predictor.propagate_in_video(*args, **kwargs):
            yield self._keep(out)


def iou_outside_band(a, b) -> float:
    """Mask IoU of logits ``a`` against ``b`` over the pixels where |b| >
    SIGN_BAND rms(b)."""
    a, b = a.astype("float64"), b.astype("float64")
    clear = abs(b) > SIGN_BAND * float((b ** 2).mean()) ** 0.5
    return iou((a > 0) & clear, (b > 0) & clear)


def hold_frames(got: dict, want: dict, what: str, rel_tol: float, iou_tol) -> tuple:
    """Each entry's logits against ``want``'s: rel-L2 and mask IoU outside
    the bf16 band (|logit| > SIGN_BAND rms), one line with the worst of each
    and of the plain IoU. With ``iou_tol`` None the IoU is printed and not
    held. Returns (max rel-L2, min IoU outside the band)."""
    rels, ious, plain, worst_d = {}, {}, {}, 0.0
    for k in want:
        a, b = got[k].astype("float64"), want[k].astype("float64")
        rels[k] = float(((a - b) ** 2).sum() ** 0.5 / max(((b ** 2).sum()) ** 0.5, 1e-12))
        ious[k] = iou_outside_band(a, b)
        plain[k] = iou(a > 0, b > 0)
        worst_d = max(worst_d, float(abs(a - b).max()))
    rel_at, iou_at = max(rels, key=rels.get), min(ious, key=ious.get)
    ok = rels[rel_at] <= rel_tol and (iou_tol is None or ious[iou_at] >= iou_tol)
    log(f"  {what}: {len(want)} compared, max logit rel-L2 {rels[rel_at]:.4e} at {rel_at} (tol {rel_tol}); min mask "
        f"IoU outside the band {ious[iou_at]:.5f} at {iou_at} ({'not held' if iou_tol is None else f'tol {iou_tol}'}); "
        f"plain IoU min {min(plain.values()):.5f}; max |d| {worst_d:.4e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: disagree (rel-L2 {rels[rel_at]:.4e} at {rel_at}, IoU {ious[iou_at]:.5f} at "
                             f"{iou_at})")
    return rels[rel_at], ious[iou_at]


@contextlib.contextmanager
def serve_window_sync_errors():
    """Inside the block, every host sync inside batched serving's tracking
    window (``inference/serve.py``'s ``_run_window``) is an error."""
    import torch

    from us_video_medsam2_tpu_torch.inference import serve

    run = serve._run_window

    def checked(*args, **kwargs):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    serve._run_window = checked
    try:
        yield
    finally:
        serve._run_window = run


def serve_calls(predictor, frames, coords, labels, what):
    """A warm-up call (on the card it captures the body once), then REPEATS
    calls that must capture nothing, with, on the card, exact launch counts
    (one video's: 9 / 12 / 12 an encoded batch of N frames, 8 flash a
    tracked frame) and no host sync inside the window. Returns (the median
    call's seconds, its low-res logits on the host)."""
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate, serve_graphs

    n, t = frames.shape[:2]
    on_card = predictor.device.type == "cuda"
    graphs = serve_graphs(predictor)

    def call():
        out = batched_propagate(predictor, frames, coords, labels)
        sync(predictor.device)
        return out

    captures = graphs.captures
    _, launches = read_counts(call)
    made = graphs.captures - captures
    if on_card:
        check_counts(f"{what}, first call ({made} capture)", launches,
                     expected_launches(PER_ENCODED_FRAME, t + made, t - 1 + made))
        if made != (0 if isinstance(graphs, EagerBodies) else 1):
            raise AssertionError(f"{what}: the first call made {made} captures")
    for key, graph in graphs.entries.items():
        if hasattr(graph, "capture_s") and key[:2] == (n, t):
            log(f"  {what}: warm-up and capture {graph.capture_s:.3f} s, pool {graph.pool_bytes / 2**20:.1f} MiB")
    runs = []
    with serve_window_sync_errors() if on_card else contextlib.nullcontext():
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out, launches = read_counts(call)
            runs.append((time.perf_counter() - t0, out))
            if on_card:
                check_counts(f"{what}, timed call", launches, expected_launches(PER_ENCODED_FRAME, t, t - 1))
    if graphs.captures != captures + made:
        raise AssertionError(f"{what}: a second call of the same shape captured the body again")
    secs, out = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    log(f"  {what}: calls {[round(r[0] * 1e3, 2) for r in runs]} ms; median {1e3 * secs:.2f} ms a call, "
        f"{n * (t - 1) / secs:.1f} tracked frames/s ({n * t / secs:.1f} frames/s)")
    return secs, out.float().cpu().numpy()


def check_serving(name, host_sd, card, device="cuda"):
    """Phase 9 (b): ``batched_propagate`` at SERVE_N videos of SERVE_T frames
    (512², one click each): exact counts, one capture, no sync in the window;
    graph against eager body; each video against the interactive predictor
    on the card; N 1 for information; the card against the host at
    SERVE_HOST."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.serve import SERVE_GRAPHS, batched_propagate, serve_graphs
    from us_video_medsam2_tpu_torch.inference.transforms import prep_frames
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor
    from us_video_medsam2_tpu_torch.ops.resize import resize2d

    pred = build_sam2_video_predictor(name, state_dict=host_sd, fill_hole_area=8, device=device)
    size = pred.cfg.image_size
    raw, clicks = [], []
    for i in range(SERVE_N):
        v, c, _ = make_video(SERVE_T, size, SEED + 10 + i)
        raw.append(v)
        clicks.append([c])
    raw = np.stack(raw)
    coords, labels = np.asarray(clicks, np.float32), np.ones((SERVE_N, 1), np.int32)
    # device-resident normalized videos, as tools/bench_serve.py times them
    frames = prep_frames(torch.from_numpy(raw).to(pred.device).reshape(-1, size, size, 3), size)
    frames = frames.reshape(SERVE_N, SERVE_T, size, size, 3)
    log(f"  {SERVE_N} videos of {SERVE_T} frames at {size}², one click each; videos resident on the device")
    secs, lows = serve_calls(pred, frames, coords, labels, f"N {SERVE_N}")
    secs1, _ = serve_calls(pred, frames[:1], coords[:1], labels[:1], "N 1")
    log(f"  batched serving, ms a call (median of {REPEATS} after a warm-up; host clock; for information): N "
        f"{SERVE_N} {1e3 * secs:.2f}, N 1 {1e3 * secs1:.2f}; aggregate tracked frames/s N {SERVE_N} "
        f"{SERVE_N * (SERVE_T - 1) / secs:.1f} vs N 1 {(SERVE_T - 1) / secs1:.1f}, on {card}")

    graphs = serve_graphs(pred)
    SERVE_GRAPHS[pred] = EagerBodies()
    try:
        _, elows = serve_calls(pred, frames, coords, labels, f"N {SERVE_N}, eager body")
    finally:
        SERVE_GRAPHS[pred] = graphs
    hold_graph_against_eager({(i, f): lows[i, f] for i in range(SERVE_N) for f in range(SERVE_T)},
                             {(i, f): elows[i, f] for i in range(SERVE_N) for f in range(SERVE_T)},
                             f"batched serving, N {SERVE_N}")

    # each video against the interactive predictor on the card (the prompted
    # frame, which batched serving hole-fills as JAX's does and the predictor
    # yields as prompted, compared unfilled): two bf16 runs whose kernels and
    # cuBLAS products take other plans at B = N than at B 1, so they round
    # apart from the first frame on (rel-L2 ~2e-2 at frame 0 in PR 17's calls
    # 2-3) and, with seeded weights' small masks near 0, flip pixels beyond
    # the band from frame 3: rel-L2 is held on every frame, the IoU outside
    # the band printed. The IoU is held against the host below, and at f32
    # the two paths agree to 1e-9 over 9 frames (tests/test_torch_serve_batch.py).
    got, want = {}, {}
    first = serve_unfilled_first_frames(pred, frames, coords, labels)
    for i in range(SERVE_N):
        masks, _, _ = run_main_path(pred, raw[i], clicks[i][0])
        up = resize2d(torch.from_numpy(np.concatenate([first[i][None], lows[i, 1:]]))[..., None],
                      (size, size))[..., 0].numpy()
        for f in range(SERVE_T):
            got[(i, f)], want[(i, f)] = up[f], masks[f][0]
    hold_frames(got, want, f"each of the {SERVE_N} videos batched vs the interactive predictor (card)",
                LOGIT_REL_L2_TOL, None)
    for i in range(SERVE_N):
        log(f"    video {i}: IoU outside the band by frame "
            f"{[round(iou_outside_band(got[(i, f)], want[(i, f)]), 4) for f in range(SERVE_T)]}, foreground "
            f"{[round(float((want[(i, f)] > 0).mean()), 4) for f in range(SERVE_T)]}")

    n, t = SERVE_HOST
    card_low = batched_propagate(pred, frames[:n, :t], coords[:n], labels[:n]).float().cpu().numpy()
    host = build_sam2_video_predictor(name, state_dict=host_sd, fill_hole_area=8, device="cpu",
                                      dtype=torch.float32)
    t0 = time.perf_counter()
    host_low = batched_propagate(host, raw[:n, :t], coords[:n], labels[:n]).numpy()
    log(f"  host run at N {n} x {t} frames {time.perf_counter() - t0:.1f} s")
    hold_frames({(i, f): card_low[i, f] for i in range(n) for f in range(t)},
                {(i, f): host_low[i, f] for i in range(n) for f in range(t)},
                f"batched serving N {n} x {t} frames, card vs host", LOGIT_REL_L2_TOL, None)
    k = min(CHECK_FRAMES, t)
    hold_frames({(i, f): card_low[i, f] for i in range(n) for f in range(k)},
                {(i, f): host_low[i, f] for i in range(n) for f in range(k)},
                f"batched serving N {n}, its first {k} frames, card vs host", LOGIT_REL_L2_TOL, MASK_IOU_TOL)
    hold_served_as_interactive(pred, host, raw[:n, :t], [c[0] for c in clicks[:n]], card_low, host_low)
    return {"ms_per_call": 1e3 * secs, "ms_per_call_n1": 1e3 * secs1, "raw": raw, "coords": coords,
            "labels": labels, "lows": lows}


def hold_served_as_interactive(card, host, raw, clicks, card_low, host_low) -> None:
    """Each served row against the host no further than the interactive
    predictor is on the same video: the rows' frames run past the memory
    slots (the bank's selection at B = N), where the seeded weights' bf16
    path drifts from the f32 host's beyond the band on the interactive
    predictor too. Per video, the served frames' min IoU outside the band
    against the host must reach min(MASK_IOU_TOL, the interactive
    predictor's min IoU outside the band against the host over the same
    frames)."""
    for i, video in enumerate(raw):
        want, _, _ = run_main_path(host, video, clicks[i])
        got, _, _ = run_main_path(card, video, clicks[i])
        inter = [iou_outside_band(got[f][0], want[f][0]) for f in range(len(video))]
        served = [iou_outside_band(card_low[i, f], host_low[i, f]) for f in range(len(video))]
        floor = min(MASK_IOU_TOL, min(inter))
        ok = min(served) >= floor
        log(f"    video {i} card vs host, IoU outside the band by frame: served {[round(x, 4) for x in served]}, "
            f"interactive {[round(x, 4) for x in inter]}; served min {min(served):.5f} (floor {floor:.5f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"batched serving: video {i} is further from the host than the interactive "
                                 f"predictor (IoU {min(served):.5f} < {floor:.5f})")


def serve_unfilled_first_frames(predictor, frames, coords, labels):
    """Batched serving's prompted frames as the interactive predictor yields
    them, holes unfilled: [N, 4fs, 4fs] on the host."""
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate

    area, predictor.fill_hole_area = predictor.fill_hole_area, 0
    try:
        out = batched_propagate(predictor, frames[:, :1], coords, labels)[:, 0]
    finally:
        predictor.fill_hole_area = area
    return out.float().cpu().numpy()


def hold_image_outputs(card_pred, got: dict, want: dict, what: str) -> None:
    """The image predictor's outputs on the card against the host's, by key
    (masks [M, H, W] post-processed logits, ious [M], low-res logits [M, h,
    w]): the model's low-res logits at the card-vs-host gate; the card's
    post-processing (hole filling, sprinkle removal, the resize) run on the
    host's low-res logits against the host's masks at the graph-vs-eager gate
    (the same function on the same input); the plain IoU of the final masks
    printed. Post-processing turns a sign flip near 0 into a jump of 10 (a
    sprinkle removed on one side only), so rel-L2 is read before it."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.transforms import postprocess_masks

    keys = [(k, m) for k in want for m in range(want[k][2].shape[0])]
    hold_frames({(k, m): got[k][2][m] for k, m in keys}, {(k, m): want[k][2][m] for k, m in keys},
                f"{what}: low-res logits, card vs host", LOGIT_REL_L2_TOL, MASK_IOU_TOL)
    pp = {}
    for k in want:
        x = postprocess_masks(torch.from_numpy(np.ascontiguousarray(want[k][2])).to(card_pred.device), APP_HW,
                              card_pred.max_hole_area, card_pred.max_sprinkle_area)
        pp[k] = x.cpu().numpy()
    hold_frames({(k, m): pp[k][m] for k, m in keys}, {(k, m): want[k][0][m] for k, m in keys},
                f"{what}: post-processing on the card of the host's logits vs the host's", GRAPH_REL_L2_TOL,
                GRAPH_MASK_IOU_TOL)
    final = [iou(got[k][0][m] > 0, want[k][0][m] > 0) for k, m in keys]
    ious = max(float(abs(np.asarray(got[k][1], np.float64) - np.asarray(want[k][1], np.float64)).max())
               for k in want)
    log(f"  {what}: final masks card vs host, plain IoU min {min(final):.5f} (for information); predicted IoU "
        f"max |d| {ious:.4e}")


def check_image_path(name, host_sd, card, device="cuda"):
    """Phase 9 (c): the image predictor on a 600x800 image (every predict
    mode, ``predict_batch_points`` with BATCH_POINTS points) against the
    host, and the automatic mask generator at AMG_POINTS a side, with
    AMG_HOST_POINTS a side against the host."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2_image_predictor
    from us_video_medsam2_tpu_torch.inference.amg import build_point_grid, calculate_stability_score
    from us_video_medsam2_tpu_torch.inference.automatic_mask_generator import SAM2AutomaticMaskGenerator

    video, (cx, cy), masks = make_video(1, APP_HW[0], SEED + 20, width=APP_HW[1])
    img = video[0]
    ys, xs = np.nonzero(masks[0, 0])
    box = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
    card_pred = build_sam2_image_predictor(name, state_dict=host_sd, device=device)
    host = build_sam2_image_predictor(name, state_dict=host_sd, device="cpu", dtype=torch.float32)

    def counts(what, launches, encoded):  # the host's plain versions count nothing
        if torch.device(device).type == "cuda":
            check_counts(what, launches, expected_launches(PER_ENCODED_FRAME, encoded, 0))

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, time.perf_counter() - t0

    times = []
    for _ in range(REPEATS):
        (_, secs), launches = read_counts(lambda: timed(lambda: card_pred.set_image(img)))
        counts("set_image", launches, 1)
        times.append(secs)
    host.set_image(img)
    point = dict(point_coords=np.array([[cx, cy]]), point_labels=np.array([1]))
    _, _, low = host.predict(**point)
    modes = {
        "point": point,
        "point, one mask": dict(point, multimask_output=False),
        "box": dict(box=box, multimask_output=False),
        "box + point": dict(box=box, point_coords=np.array([[cx, cy], [box[0], box[1]]]), point_labels=np.array([1, 0])),
        "mask input + point": dict(point, mask_input=low[0], multimask_output=False),
    }
    got, want, predict_s = {}, {}, []
    for mode, kw in modes.items():
        (out, secs), launches = read_counts(lambda kw=kw: timed(lambda: card_pred.predict(**kw, return_logits=True)))
        counts(f"predict ({mode})", launches, 0)
        predict_s.append(secs)
        ref = host.predict(**kw, return_logits=True)
        if out[0].shape != ref[0].shape or out[0].shape[1:] != APP_HW:
            raise AssertionError(f"predict ({mode}): masks {out[0].shape} vs host {ref[0].shape}")
        got[mode], want[mode] = out, ref
        log(f"  predict ({mode}): {out[0].shape[0]} mask(s), ious {np.round(out[1], 4).tolist()} (host "
            f"{np.round(ref[1], 4).tolist()}), foreground {[round(float((x > 0).mean()), 4) for x in out[0]]}")
    hold_image_outputs(card_pred, got, want, "every predict mode")

    side = int(BATCH_POINTS ** 0.5)
    gx, gy = np.meshgrid(np.linspace(40, APP_HW[1] - 40, side), np.linspace(40, APP_HW[0] - 40, side))
    pts = np.stack([gx.ravel(), gy.ravel()], -1)[:, None].astype(np.float32)
    plabels = np.ones((BATCH_POINTS, 1), np.int32)
    (bout, bsecs), launches = read_counts(lambda: timed(lambda: card_pred.predict_batch_points(pts, plabels)))
    counts(f"predict_batch_points ({BATCH_POINTS} points)", launches, 0)
    bref = host.predict_batch_points(pts, plabels)
    stab = calculate_stability_score(bout[0].reshape(-1, *APP_HW), 0.0, 1.0)
    log(f"  predict_batch_points: masks {bout[0].shape}; predicted IoU quantiles (0, .5, .9, 1) "
        f"{np.round(np.quantile(bout[1], [0, 0.5, 0.9, 1]), 4).tolist()}, stability score quantiles "
        f"{np.round(np.quantile(stab, [0, 0.5, 0.9, 1]), 4).tolist()}, "
        f"{int((stab >= AMG_STABILITY_THRESH).sum())} of {stab.size} masks at >= {AMG_STABILITY_THRESH}")
    hold_image_outputs(card_pred, {p: [x[p] for x in bout] for p in range(BATCH_POINTS)},
                       {p: [x[p] for x in bref] for p in range(BATCH_POINTS)},
                       f"predict_batch_points, {BATCH_POINTS} points")

    # the margins of the AMG's filters at AMG_HOST_POINTS a side: each mask's
    # stability score on the card and the host, nearest the threshold first
    grid = build_point_grid(AMG_HOST_POINTS) * np.array(APP_HW[::-1])
    scores = []
    for p in (card_pred, host):
        logits, _, _ = p.predict_batch_points(grid[:, None].astype(np.float32),
                                              np.ones((len(grid), 1), np.int32))
        scores.append(calculate_stability_score(logits.reshape(-1, *APP_HW), 0.0, 1.0))
    near = np.argsort(abs(scores[1] - AMG_STABILITY_THRESH))[:6]
    log(f"  AMG grid at {AMG_HOST_POINTS} a side: stability >= {AMG_STABILITY_THRESH} on the card "
        f"{int((scores[0] >= AMG_STABILITY_THRESH).sum())}, the host {int((scores[1] >= AMG_STABILITY_THRESH).sum())} "
        f"of {scores[1].size}; nearest the threshold (card, host) "
        f"{[(round(float(scores[0][j]), 4), round(float(scores[1][j]), 4)) for j in near]}")

    def amg(pred, per_side):
        return SAM2AutomaticMaskGenerator(pred, points_per_side=per_side, pred_iou_thresh=AMG_IOU_THRESH,
                                          stability_score_thresh=AMG_STABILITY_THRESH)

    (anns, gen_s), launches = read_counts(lambda: timed(lambda: amg(card_pred, AMG_POINTS).generate(img)))
    counts(f"generate ({AMG_POINTS} points a side)", launches, 1)
    log(f"  automatic mask generator, {AMG_POINTS} points a side ({AMG_POINTS ** 2 // 64} batches of 64; "
        f"pred_iou_thresh {AMG_IOU_THRESH}, stability_score_thresh {AMG_STABILITY_THRESH}): {len(anns)} masks, "
        f"areas {sorted(a['area'] for a in anns)[:8]}...")
    if not anns:
        raise AssertionError("the automatic mask generator found no mask")
    small = amg(card_pred, AMG_HOST_POINTS).generate(img)
    t0 = time.perf_counter()
    ref = amg(host, AMG_HOST_POINTS).generate(img)
    log(f"  host generate at {AMG_HOST_POINTS} a side {time.perf_counter() - t0:.1f} s")
    matched, free = [], list(range(len(ref)))
    for a in small:
        best = max(free, key=lambda j: iou(a["segmentation"], ref[j]["segmentation"]), default=None)
        v = 0.0 if best is None else iou(a["segmentation"], ref[best]["segmentation"])
        matched.append(v)
        if best is not None and v >= AMG_MATCH_IOU:
            free.remove(best)
    log(f"  generate at {AMG_HOST_POINTS} a side, card vs host: {len(small)} vs {len(ref)} masks, matched IoU min "
        f"{min(matched, default=1.0):.5f} (tol {AMG_MATCH_IOU})")
    if len(small) != len(ref) or min(matched, default=1.0) < AMG_MATCH_IOU:
        raise AssertionError("the automatic mask generator's masks on the card and the host disagree")
    ms = {"set_image": 1e3 * sorted(times)[len(times) // 2], "predict": 1e3 * sorted(predict_s)[len(predict_s) // 2],
          "predict_batch_points": 1e3 * bsecs, "generate": 1e3 * gen_s}
    log("  image path, ms (host clock around calls ending in a sync; set_image median of "
        f"{REPEATS}, predict median over the modes; for information): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f"; on {card}")
    return ms


def run_entry_points(card, work, name="sam2.1_hiera_t512", device="cuda"):
    """Phase 9 for the preset ``name`` at full width in bf16 on ``device``,
    the seeded weights of phase 4 (the object-score head's output bias at
    +10): the apps, batched serving, the image path. The host's runs are the
    plain versions in f32; the card's own gates (launches, captures, the
    sync-free window) are held on the card only. Returns the weights and
    serving's result (``check_serving``'s), which phase 13 serves again, and
    the apps' (``check_apps``'), whose infer_video cases phase 14 verifies."""
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2

    model = build_sam2(name, seed=SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    log("  (a) the apps through their mains, from a reference-name .pt of the seeded weights")
    apps = check_apps(name, host_sd, model.cfg, card, work, device)
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    log(f"  (b) batched serving: {SERVE_N} videos x {SERVE_T} frames, the video axis as the batch axis")
    served = check_serving(name, host_sd, card, device)
    log(f"  (b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    log(f"  (c) the image path: image predictor and automatic mask generator on a {APP_HW[0]}x{APP_HW[1]} image")
    check_image_path(name, host_sd, card, device)
    log(f"  (c) took {time.perf_counter() - t1:.1f} s")
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    return {"host_sd": host_sd, "serving": served, "apps": apps}


# ----------------------------------------------------------------- phase 10
def write_train_corpus(root, hw=TE_HW, frames=TE_FRAMES) -> dict:
    """Phase 10's corpus under ``root``: TE_VIDEOS NPZ videos of TE_FRAMES
    600x800 uint8 frames (``make_video``'s blobs, grey, in 8 levels) with
    ``gts`` of 1-3 classes, each visible on frame 0; the last video's low
    bits are uniform noise, which lifts its first-frame entropy above the
    quantum curriculum's dense threshold (2.5) while the others stay below
    it. Returns {video: entropy}."""
    import numpy as np

    from us_video_medsam2_tpu_torch.training.data import _first_frame_entropy

    os.makedirs(root, exist_ok=True)
    h, w = hw
    rng = np.random.default_rng(SEED + 40)
    ent = {}
    for v in range(TE_VIDEOS):
        video, _, masks = make_video(frames, h, SEED + 40 + v, width=w)
        imgs = gray(video) // 32 * 32 + 16  # 8 grey levels: an entropy of ln 8 at most
        if v == TE_VIDEOS - 1:
            imgs = rng.integers(0, 256, imgs.shape).astype(np.uint8) | (imgs & 0xE0)
        gts = np.zeros(imgs.shape, np.uint8)
        for c in range(1 + v % 3):
            gts[masks[:, c]] = c + 1
        if any(not (gts[0] == c + 1).any() for c in range(1 + v % 3)):
            raise AssertionError(f"corpus video {v}: a class is not visible on frame 0")
        name = f"video_{v}"
        np.savez_compressed(os.path.join(root, f"{name}.npz"), imgs=imgs, gts=gts)
        ent[name] = _first_frame_entropy(root, name)
    return ent


class StepRecorder:
    """Wraps the trainer's ``make_train_step`` so that each step's launches
    are read around it (every count set to 0 just before), with its plan and
    loss."""

    def __init__(self):
        self.steps = []

    def __enter__(self):
        from us_video_medsam2_tpu_torch.training import trainer

        self._orig = trainer.make_train_step
        orig, steps = self._orig, self.steps

        def make_train_step(cfg):
            step = orig(cfg)

            def counted(state, batch, gen):
                m, counts = read_counts(lambda: step(state, batch, gen))
                steps.append((m["plan"], counts, float(m["core_loss"])))
                return m

            return counted

        trainer.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        from us_video_medsam2_tpu_torch.training import trainer

        trainer.make_train_step = self._orig

    def check(self, what, on_card=True, tracked_frames=TRAIN_T, per_step=PER_TRAIN_STEP) -> None:
        """Every step's launches exactly phase 7's (``per_step`` the trunk
        kernels' of the preset; on the card: the host's plain versions count
        nothing); finite losses."""
        for i, (plan, counts, loss) in enumerate(self.steps):
            expected = {k: 0 for k in counts}
            if on_card:
                expected.update(per_step)
                expected.update({k: v * (tracked_frames - plan.n_init)
                                 for k, v in PER_TRACKED_TRAIN_FRAME.items()})
            if counts != expected:
                raise AssertionError(f"{what} step {i}: launch counts {counts} != {expected}")
            if not loss == loss or abs(loss) == float("inf"):
                raise AssertionError(f"{what} step {i}: core_loss {loss}")
        log(f"  {what}: {len(self.steps)} steps, each with exactly {'phase 7' if on_card else 'the host'}'s launches "
            f"(n_init by step {[p.n_init for p, _, _ in self.steps]}); losses "
            f"{[round(l, 4) for _, _, l in self.steps]}")


def batch_hash(batch) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in ("images", "masks", "obj_valid"):
        h.update(batch[k].tobytes())
    return h.hexdigest()[:16]


def same_arrays(a: dict, b: dict) -> list:
    """The keys of ``a`` whose arrays differ from ``b``'s in bytes, dtype or
    shape (or that ``b`` lacks)."""
    import numpy as np

    return [k for k in a if k not in b or np.asarray(a[k]).dtype != np.asarray(b[k]).dtype
            or np.asarray(a[k]).shape != np.asarray(b[k]).shape
            or np.asarray(a[k]).tobytes() != np.asarray(b[k]).tobytes()]


def run_training_entry(card, work, name="sam2.1_hiera_t512", device="cuda", hw=TE_HW, frames=TE_FRAMES):
    """Phase 10: ``apps/train.py``'s ``main`` on the card at full width, from
    the seeded weights of phase 4 written as a reference-name ``.pt``: (a) two
    epochs of the quantum curriculum; (b) the run resumed to a third epoch;
    (c) ``checkpoint.npz`` served; (d) one epoch with GFTE; (e) one epoch in
    a one-rank NCCL group; (f) the native NPZ reader against numpy. With
    ``device`` "cpu" (the tests' tiny run) the same on the host's plain
    versions, a gloo group in (e) and no launch or memory gates."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.apps import train
    from us_video_medsam2_tpu_torch.core import checkpoint
    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.core.checkpoint import _flatten as flat_tree
    from us_video_medsam2_tpu_torch.core.weights import to_jax_params
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor
    from us_video_medsam2_tpu_torch.training import data as data_mod
    from us_video_medsam2_tpu_torch.training import trainer as trainer_mod

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    corpus = os.path.join(work, "corpus")
    ent = write_train_corpus(corpus, hw, frames)
    dense = sorted(v for v, e in ent.items() if e < 2.5)
    log(f"  corpus: {TE_VIDEOS} videos x {frames} frames of {hw[0]}x{hw[1]}; first-frame entropies "
        f"{ {v: round(e, 3) for v, e in ent.items()} }; the dense stage keeps {dense}")
    if not 5 <= len(dense) < TE_VIDEOS:
        raise AssertionError("the corpus must let the dense stage keep at least 5 videos and filter one")
    model = build_sam2(name, seed=SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    ckpt = os.path.join(work, f"seed{SEED}_{name}_reference.pt")
    torch.save({"model": to_reference_state_dict(model.state_dict(), model.cfg)}, ckpt)
    size = model.cfg.image_size
    out = os.path.join(work, "run")

    def te_args(out_dir, epochs, *extra):
        return ["--data_dir", corpus, "--out_dir", out_dir, "--epochs", str(epochs), "--cfg", name, "--init_ckpt",
                ckpt, "--resolution", str(size), "--device", device, *TE_ARGS, *extra]

    def free():
        if on_card:
            torch.cuda.empty_cache()

    # (a) two epochs
    log(f"  (a) train: {' '.join(te_args('O', 2))}")
    sync(device)
    if on_card:
        reset_peak_memory()
    t0 = time.perf_counter()
    with StepRecorder() as rec:
        tr = train.main(te_args(out, 2))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rec.check("(a)", on_card)
    with open(os.path.join(out, "train_stats.json")) as f:
        records = [json.loads(line) for line in f]
    if len(records) != 2 or not all(np.isfinite(r["Losses/train_all_loss"]) for r in records):
        raise AssertionError(f"(a) train_stats.json: {records}")
    files = ["train_stats.json", "best_stats.json", "checkpoint.npz", "checkpoint.meta.json",
             "best_checkpoint.npz", "best_checkpoint.meta.json", "config_resolved.json",
             "train_config_resolved.json"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing:
        raise AssertionError(f"(a) the out-dir lacks {missing}")
    data_ms = [1e3 * d for d, _ in tr.step_times]
    step_ms = [1e3 * s for _, s in tr.step_times]
    total_ms = statistics.median([d + s for d, s in zip(data_ms, step_ms)])
    mib = os.path.getsize(os.path.join(out, "checkpoint.npz")) / 2**20
    log(f"  (a) {len(tr.step_times)} steps in {secs:.1f} s: median {total_ms:.2f} ms a step (data "
        f"{statistics.median(data_ms):.2f} ms, step {statistics.median(step_ms):.2f} ms; by step data "
        f"{[round(x, 1) for x in data_ms]}, step {[round(x, 1) for x in step_ms]}), peak device memory "
        f"{peak / 2**30:.3f} GiB, checkpoint writes {[round(x, 3) for x in tr.save_times]} s ({mib:.1f} MiB); "
        f"train_stats {[round(r['Losses/train_all_loss'], 4) for r in records]}; on {card}")
    final_sd = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    del tr
    free()

    # (b) resume to a third epoch
    saved = flat_tree(checkpoint.restore_checkpoint(os.path.join(out, "checkpoint.npz")))
    seen, hashes = {}, []
    orig_epoch, orig_loader = trainer_mod.Trainer.train_epoch, data_mod.TrainMixedVideoLoader.get_loader

    def first_epoch(self, epoch):
        if not seen:
            seen.update(epoch=epoch, step=self.state.step, best=self.best,
                        params=flat_tree({"params": to_jax_params(self.model.state_dict(), self.model_cfg)}),
                        opt=flat_tree({"opt_state": self.state.optimizer.state_dict(
                            self.model_cfg, dict(self.model.named_buffers()))}))
        return orig_epoch(self, epoch)

    def hashed(self, epoch, rngs=None):
        for b in orig_loader(self, epoch, rngs):
            hashes.append(batch_hash(b))
            yield b

    trainer_mod.Trainer.train_epoch, data_mod.TrainMixedVideoLoader.get_loader = first_epoch, hashed
    try:
        with StepRecorder() as rec:
            t0 = time.perf_counter()
            tr = train.main(te_args(out, 3))
    finally:
        trainer_mod.Trainer.train_epoch, data_mod.TrainMixedVideoLoader.get_loader = orig_epoch, orig_loader
    rec.check("(b)", on_card)
    want = {"epoch": 2, "step": int(saved["step"]), "best": float(saved["best"])}
    got = {k: seen[k] for k in want}
    bad_p = same_arrays({k: v for k, v in saved.items() if k.startswith("params/")}, seen["params"])
    bad_o = same_arrays({k: v for k, v in saved.items() if k.startswith("opt_state/")}, seen["opt"])
    loader = train.make_loader(corpus, "quantum", TRAIN_T, TRAIN_OBJECTS, 1, size, SEED)
    fresh = [batch_hash(b) for b in loader.get_loader(2)]
    log(f"  (b) resumed at {got} (saved {want}); {sum(k.startswith('params/') for k in saved)} parameter and "
        f"{sum(k.startswith('opt_state/') for k in saved)} optimizer arrays restored, differing "
        f"{len(bad_p)} / {len(bad_o)}; epoch 2's batches {hashes}, a fresh loader's {fresh}; "
        f"{time.perf_counter() - t0:.1f} s")
    if got != want or bad_p or bad_o or hashes != fresh or not hashes:
        raise AssertionError(f"(b) resume: {got} vs {want}, differing {bad_p[:3]} {bad_o[:3]}, batches "
                             f"{hashes} vs {fresh}")
    final_sd = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    del tr
    free()

    # (c) the checkpoint served
    video, click, _ = make_video(FRAMES, size, SEED)
    runs = {}
    for how, kw in (("checkpoint.npz", {"ckpt_path": os.path.join(out, "checkpoint.npz")}),
                    ("in-memory state dict", {"state_dict": final_sd})):
        pred = build_sam2_video_predictor(name, fill_hole_area=8, device=device, **kw)
        (masks, _, _), _ = counted_run(pred, PER_ENCODED_FRAME, f"(c) served from the {how}",
                                       lambda: run_main_path(pred, video, click))
        runs[how] = masks
        del pred
    a, b = runs.values()
    same = [f for f in a if np.array_equal(a[f], b[f])]
    log(f"  (c) {len(same)} of {len(a)} frames bit-identical between the two predictors")
    if len(same) != len(a) or list(a) != list(b):
        raise AssertionError("(c) the checkpoint served disagrees with the trainer's final weights")
    free()

    # (d) GFTE
    gout = os.path.join(work, "run_gfte")
    t0 = time.perf_counter()
    with StepRecorder() as rec:
        tr = train.main(te_args(gout, 1, "--temporal_fusion", "gfte"))
    rec.check("(d) GFTE", on_card)
    before = dict(train.build_model(tr.model_cfg, ckpt).named_buffers())
    after = {n: b.detach().cpu() for n, b in tr.model.named_buffers()}
    changed = [n for n in before if not torch.equal(before[n], after[n])]
    log(f"  (d) GFTE: {len(after)} BatchNorm buffers, {len(changed)} changed; {time.perf_counter() - t0:.1f} s")
    if not after or changed:
        raise AssertionError(f"(d) the GFTE epoch changed the buffers {changed[:4]}")
    del tr
    free()

    # (e) one rank of an NCCL group
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            tr = train.main(te_args(os.path.join(work, "run_rank"), 1))
        backend = dist.get_backend() if dist.is_initialized() else None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    rec.check("(e) one rank", on_card)
    want_backend = "nccl" if on_card else "gloo"
    log(f"  (e) one rank: process group backend {backend}, {time.perf_counter() - t0:.1f} s")
    if backend != want_backend:
        raise AssertionError(f"(e) the run did not go through a {want_backend} group (backend {backend})")
    del tr
    free()

    # (f) the native reader
    from us_video_medsam2_tpu_torch.training import native_npz

    if not os.path.exists("/usr/include/zlib.h"):
        log("  (f) zlib.h is missing on this machine: the native reader cannot be built; (a)-(e) ran on the "
            "default (numpy) reader")
    else:
        os.environ["UVMS2_NATIVE_NPZ"] = "1"
        try:
            t0 = time.perf_counter()
            native_npz.build()
            build_s = time.perf_counter() - t0
            diffs, n = [], 0
            for f in sorted(os.listdir(corpus)):
                got = native_npz.load_npz(os.path.join(corpus, f))
                with np.load(os.path.join(corpus, f)) as ref:
                    want = {k: ref[k] for k in ref.files}
                n += len(want)
                diffs += [f"{f}:{k}" for k in same_arrays(want, got)] + [f"{f}:{k}" for k in got if k not in want]
        finally:
            os.environ.pop("UVMS2_NATIVE_NPZ", None)
        log(f"  (f) native NPZ reader built in {build_s:.2f} s; {n} arrays of {TE_VIDEOS} files against numpy, "
            f"differing {diffs}")
        if diffs or not n:
            raise AssertionError(f"(f) the native reader disagrees with numpy: {diffs}")
    os.remove(ckpt)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- phase 11
def vit_window_calls(model, images) -> set:
    """The (qkv shape, ws, nh, q_pool, real_h) of every window-attention call
    of one forward_image of ``model`` over ``images``, recorded around the
    wrapper the ViT blocks call."""
    import torch

    from us_video_medsam2_tpu_torch.models import hiera

    calls, orig = set(), hiera.window_attention

    def recorder(qkv, ws, nh, pool, real_h=None):
        calls.add((tuple(qkv.shape), ws, nh, pool, real_h))
        return orig(qkv, ws, nh, pool, real_h)

    hiera.window_attention = recorder
    try:
        with torch.no_grad():
            model.forward_image(images.reshape(-1, *images.shape[2:]))
    finally:
        hiera.window_attention = orig
    return calls


def check_vit_training_kernels(g, model, batch) -> None:
    """The hd-64 window kernel at the ViT training shape (the shape the
    model's windowed blocks give it over T·B frames, read from a forward
    pass), forward against the plain version and its gradient
    (``_lib.with_plain_grad``, no launch in the backward) against autograd
    of the plain version; ``layer_norm`` and ``ln_mlp_residual`` at D 384
    the same way."""
    import torch

    from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
    from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

    hp, ws, nh, pool, real = VIT_TRAIN_WINDOW
    want = {((TRAIN_T, hp, hp, 3 * nh * HD_VIT), ws, nh, pool, real)}
    calls = vit_window_calls(model, batch.images)
    log(f"  window-attention calls of a training forward over T·B = {TRAIN_T} frames: {sorted(calls)}")
    if calls != want:
        raise AssertionError(f"the ViT blocks call window attention at {calls}, not {want}")
    dev, bf, f32 = "cuda", torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    qkv = rn(TRAIN_T, hp, hp, 3 * nh * HD_VIT)
    name = f"window_attention hd{HD_VIT} B{TRAIN_T} {hp}^2 ws{ws} nh{nh} real_h {real}"
    compare(f"{name} (ViT training)", window_attention(qkv, ws, nh, pool, real)[:, :real, :real],
            window_attention_plain(qkv, ws, nh, pool, real)[:, :real, :real], attention=True)
    hold_grad(name, window_attention, window_attention_plain, (qkv, ws, nh, pool, real), (0,), g)
    n, d, f = TRAIN_T * 1024, 384, 1536
    ln = (rn(n, d), 1.0 + rn(d, scale=0.1, dtype=f32), rn(d, scale=0.1, dtype=f32), 1e-6)
    compare(f"layer_norm ({n},{d}) (ViT training)", layer_norm(*ln), layer_norm_plain(*ln))
    hold_grad(f"layer_norm ({n},{d})", layer_norm, layer_norm_plain, ln, (0, 1, 2), g)
    mlp = (rn(n, d), 1.0 + rn(d, scale=0.1, dtype=f32), rn(d, scale=0.1, dtype=f32), rn(f, d, scale=d**-0.5),
           rn(f, scale=0.1, dtype=f32), rn(d, f, scale=f**-0.5), rn(d, scale=0.1, dtype=f32), 1e-6)
    compare(f"ln_mlp_residual ({n},{d},{f}) (ViT training)", ln_mlp_residual(*mlp), ln_mlp_residual_plain(*mlp))
    hold_grad(f"ln_mlp_residual ({n},{d},{f})", ln_mlp_residual, ln_mlp_residual_plain, mlp, tuple(range(7)), g)


def check_freeze(host_sd) -> None:
    """EfficientTAMTrain's freeze_image_encoder: FREEZE_STEPS steps with
    ``freeze_patterns=("*image_encoder*",)``; every image-encoder parameter
    bit-identical after them, every other parameter group moved."""
    import dataclasses

    import torch

    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig, create_train_state, make_train_step

    cfg = train_config()
    frozen = TrainConfig(sim=cfg.sim, loss=cfg.loss,
                         optim=dataclasses.replace(cfg.optim, freeze_patterns=("*image_encoder*",)))
    state = create_train_state(build_train_model(host_sd, name=VIT), frozen)
    batch = make_train_batch(TRAIN_T, state.model.cfg.image_size, "cuda")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step, gen = make_train_step(frozen), torch.Generator().manual_seed(SEED)
    for _ in range(FREEZE_STEPS):
        m = step(state, batch, gen)
    torch.cuda.synchronize()
    encoder = {n for n in before if n.startswith("image_encoder.")}
    others = set(before) - encoder
    moved = {n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])}
    still = [g for g, pre in PARAM_GROUPS.items() if any(n.startswith(pre) for n in others)
             and not any(n.startswith(pre) for n in moved)]
    log(f"  freeze_patterns ('*image_encoder*',), {FREEZE_STEPS} steps: {len(encoder)} image-encoder parameters, "
        f"{len(moved & encoder)} moved; {len(moved)} of {len(others)} others moved; core_loss "
        f"{float(m['core_loss']):.6f}")
    if moved & encoder or not encoder or still or len(moved) < 0.9 * len(others):
        raise AssertionError(f"freeze: encoder parameters moved {sorted(moved & encoder)[:4]}; groups that did "
                             f"not move {still}; {len(moved)} of {len(others)} others moved")
    del state


def run_vit_training(card, work, corpus) -> dict:
    """Phase 11: the EfficientTAM training half at ``efficientmedsam_s_512``
    full width, bf16 with f32 master weights, seeded weights (the
    object-score head's output bias at +10, as phase 6): (a) the kernels at
    the ViT training shapes; (b) TRAIN_STEPS timed steps after a warm-up
    (T 4, B 1, O 3, ``TrainSimConfig()``, consistency loss 0.5), every
    step's launches exact, then one traced step; (c) the fixed-plan step on
    the card (traced) against the host (counted): phase 7's gate; (d) the
    image encoder frozen; (e) ``apps/train.py --cfg efficientmedsam_s_512``
    for one epoch on phase 10's ``corpus`` from a reference-name ``.pt``,
    its ``checkpoint.npz`` served against the trainer's final weights, bit
    for bit, with phase 6's launches. Returns the fixed-plan step's device
    ms and FLOPs."""
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.apps import train
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_efficienttam_video_predictor

    t_phase = time.perf_counter()
    torch.manual_seed(SEED)
    model = build_train_model(name=VIT)
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    size = model.cfg.image_size
    g = torch.Generator(device="cuda").manual_seed(SEED)
    check_vit_training_kernels(g, model.to("cuda").set_compute_dtype(torch.bfloat16, cast_weights=False),
                               make_train_batch(TRAIN_T, size, "cuda"))
    model.to("cpu")

    reset_peak_memory()
    _, walls, peak, _, traced = timed_train_steps(model, "EfficientMedSAM-S", per_step=PER_TRAIN_STEP_VIT,
                                                  trace_dir=os.path.join(work, "trace_step"))
    reserved = torch.cuda.max_memory_reserved()
    log(f"  EfficientMedSAM-S step: median {1e3 * statistics.median(walls):.2f} ms/step over {TRAIN_STEPS} steps, "
        f"device {traced['device_ms']:.2f} ms (the traced step), peak allocated {peak / 2**30:.3f} GiB, peak "
        f"reserved {reserved / 2**30:.3f} GiB; launches a step {PER_TRAIN_STEP_VIT} + "
        f"{PER_TRACKED_TRAIN_FRAME} a tracked frame; {card}")
    del model
    torch.cuda.empty_cache()

    fixed = fixed_plan_steps(host_sd, size, (("card", "cuda", torch.bfloat16), ("host", "cpu", torch.float32)),
                             what="EfficientMedSAM-S ", name=VIT, per_step=PER_TRAIN_STEP_VIT,
                             measure_dir=os.path.join(work, "trace_fixed"))
    torch.cuda.empty_cache()
    check_freeze(host_sd)
    torch.cuda.empty_cache()

    # (e) the training CLI at the ViT preset, its checkpoint served
    from us_video_medsam2_tpu_torch.core.build import build_sam2

    seeded = build_sam2(VIT, state_dict=host_sd)
    ckpt = os.path.join(work, f"seed{SEED}_{VIT}_reference.pt")
    torch.save({"model": to_reference_state_dict(seeded.state_dict(), seeded.cfg)}, ckpt)
    out = os.path.join(work, "run")
    args = ["--data_dir", corpus, "--out_dir", out, "--epochs", "1", "--cfg", VIT, "--init_ckpt", ckpt,
            "--resolution", str(size), "--device", "cuda", *TE_ARGS]
    log(f"  train: {' '.join(args)}")
    t0 = time.perf_counter()
    with StepRecorder() as rec:
        tr = train.main(args)
    rec.check("apps/train.py --cfg " + VIT, per_step=PER_TRAIN_STEP_VIT)
    log(f"  one epoch of {len(tr.step_times)} steps in {time.perf_counter() - t0:.1f} s: median "
        f"{statistics.median(1e3 * (d + s) for d, s in tr.step_times):.2f} ms a step")
    final_sd = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    video, click, _ = make_video(FRAMES, size, SEED)
    runs = {}
    for how, kw in (("checkpoint.npz", {"ckpt_path": os.path.join(out, "checkpoint.npz")}),
                    ("in-memory state dict", {"state_dict": final_sd})):
        pred = build_efficienttam_video_predictor(VIT, fill_hole_area=8, **kw)
        (masks, _, _), _ = counted_run(pred, PER_ENCODED_FRAME_VIT, f"served from the {how}",
                                       lambda: run_main_path(pred, video, click))
        runs[how] = masks
        del pred
    a, b = runs.values()
    same = [f for f in a if np.array_equal(a[f], b[f])]
    log(f"  {len(same)} of {len(a)} frames bit-identical between the two predictors")
    if len(same) != len(a) or list(a) != list(b):
        raise AssertionError("the ViT checkpoint served disagrees with the trainer's final weights")
    os.remove(ckpt)
    torch.cuda.empty_cache()
    log(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return fixed


# ----------------------------------------------------------------- phase 12
def load_tool(name):
    """``tools/<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mfu(what, flops, device_ms, peak) -> float:
    share = flops / (device_ms / 1e3) / peak
    log(f"  MFU {what}: {flops / 1e9:.3f} GFLOP / {device_ms:.3f} device ms / {peak / 1e12:.0f} TFLOP/s = "
        f"{share:.4f}")
    if not 0.0 < share <= 1.0:
        raise AssertionError(f"{what}: MFU {share} outside (0, 1]")
    return share


def run_measurement(card, work, train_measures) -> None:
    """Phase 12: the measurement layer. (a) The 16-frame propagations of
    ``sam2.1_hiera_t512`` and ``efficientmedsam_s_512`` (seeded weights as
    phases 4 and 6, the frame body's graph captured by a warm-up run)
    traced through ``utils/profiling.trace`` and parsed by
    ``utils/traceparse`` (``traced_call``: every kernel's trace events equal
    its launch counter, the busy time key_averages()'); device ms per
    tracked frame, the top kernels and modules. (b) FLOPs from
    ``utils/flops`` on the host's plain versions: a propagation is linear
    in its tracked frames (``tests/test_torch_flops.py``), so a 16-frame
    run's FLOPs are those of 2 frames plus 14 times the third frame's; the
    training steps' are the fixed-plan host steps of phases 7 and 11. The
    MFU of each against ``traceparse.peak_bf16_flops`` of this card (an
    unknown card raises) must lie in (0, 1]. (c) The two tools at small
    counts."""
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.inference.video_predictor import (
        build_efficienttam_video_predictor,
        build_sam2_video_predictor,
    )
    from us_video_medsam2_tpu_torch.utils.flops import fn_flops
    from us_video_medsam2_tpu_torch.utils.traceparse import peak_bf16_flops

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    peak = peak_bf16_flops(kind)
    if peak is None:
        raise AssertionError(f"no dense bf16 peak is known for {kind!r}: no MFU can be given")
    log(f"  dense bf16 peak of {kind}: {peak / 1e12:.0f} TFLOP/s ({card})")
    for name, builder, per_encoded, margin in (
            ("sam2.1_hiera_t512", build_sam2_video_predictor, PER_ENCODED_FRAME, None),
            (VIT, build_efficienttam_video_predictor, PER_ENCODED_FRAME_VIT, VIT_IOU_MARGIN)):
        model = build_sam2(name, seed=SEED)
        with torch.no_grad():
            model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
            if margin is not None:
                model.sam_mask_decoder.iou_head.layers_2.bias[margin[0]] += margin[1]
        host_sd = {k: v.clone() for k, v in model.state_dict().items()}
        pred = builder(name, state_dict=host_sd, fill_hole_area=8)
        video, click, _ = make_video(FRAMES, model.cfg.image_size, SEED)
        run_main_path(pred, video, click)  # captures the frame body's graph
        _, counts, parsed = traced_call(lambda: run_main_path(pred, video, click), f"{name} propagation",
                                        os.path.join(work, f"trace_{name}"), pred.model)
        check_counts(f"{name}, the traced run", counts, expected_launches(per_encoded, FRAMES, FRAMES - 1))
        log_tallies(parsed, "tracked frame", FRAMES - 1)
        device_ms = sum(parsed[0].values()) / 1e3
        del pred
        torch.cuda.empty_cache()
        host = builder(name, state_dict=host_sd, fill_hole_area=8, device="cpu", dtype=torch.float32)
        t0 = time.perf_counter()
        f2, f3 = (fn_flops(lambda k=k: run_main_path(host, video, click, stop_after=k)) for k in (2, 3))
        total = f2 + (FRAMES - 2) * (f3 - f2)
        log(f"  {name}: {(f3 - f2) / 1e9:.3f} GFLOP per tracked frame, {total / 1e9:.3f} GFLOP a {FRAMES}-frame run "
            f"(counted on the host's plain versions in {time.perf_counter() - t0:.1f} s)")
        mfu(f"{name} propagation, {FRAMES} frames", total, device_ms, peak)
        del host
    for fam, m in train_measures.items():
        log(f"  {fam} fixed-plan training step (T {HOST_T}): {m['flops'] / 1e9:.3f} GFLOP (host count), "
            f"{m['device_ms']:.3f} device ms (traced)")
        mfu(f"{fam} training step", m["flops"], m["device_ms"], peak)

    t0 = time.perf_counter()
    prop = load_tool("torch_profile_propagation")
    out = os.path.join(work, "tool_profile")
    prop.main(["--frames", "4", "--out", out, "--cfg", VIT, "--top", "10"])
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    log(f"  tools/torch_profile_propagation.py --frames 4 --cfg {VIT}: {summary['total_ms']:.3f} device ms, "
        f"{summary['ms_per_tracked_frame']:.4f} per tracked frame ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bench = load_tool("torch_bench_train_step")
    rec = bench.main(["--steps", "1", "--frames", "2", "--cfg", "sam2.1_hiera_t512", "--fusion", "none"])
    log(f"  tools/torch_bench_train_step.py --steps 1 --frames 2: {json.dumps(rec)} ({time.perf_counter() - t0:.1f} s)")
    if not (rec["device_ms_per_step"] and rec["flops_per_step_gflop"] and 0 < rec["mfu_pct"] <= 100):
        raise AssertionError(f"the train-step tool's record: {rec}")
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- phase 13
def http_call(base, method, path, body=None, headers=None):
    """(status, content type, body) of one HTTP round trip, an error status included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers.get_content_type(), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read()


def http_json(base, method, path, payload=None, body=None, headers=None, want=200) -> dict:
    """The JSON body of a round trip that must answer ``want``."""
    data = json.dumps(payload).encode() if payload is not None else body
    code, ctype, out = http_call(base, method, path, data, headers)
    if code != want or ctype != "application/json":
        raise AssertionError(f"{method} {path}: {code} {ctype} {out[:300]!r} ({want} expected)")
    return json.loads(out)


def session_video(path, seed):
    """A seeded ``HTTP_FRAMES``-frame ``HTTP_HW`` video of moving blobs written
    as an AVI of raw 'RGBA' frames; returns its click (blob 0) and box (blob
    1's extent) on frame 0, in the video's pixels."""
    h, w = HTTP_HW
    video, click, blobs = make_video(HTTP_FRAMES, h, seed, width=w)
    write_rgba_avi(path, video)
    ys, xs = blobs[0, 1].nonzero()
    return list(click), [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]


def drive_directly(pred, path, click, box=None) -> dict:
    """The predictor driven as a session drives it, without the app: the
    frames of ``load_video_frames``, init_state with the app's object slots,
    a click (object 1) and a box (object 2) on frame 0, propagation;
    {frame: (obj_ids, masks [O, H, W] bool)}."""
    import numpy as np

    from us_video_medsam2_tpu_torch.apps.app import MAX_OBJECTS
    from us_video_medsam2_tpu_torch.utils.video_io import load_video_frames

    frames, vh, vw = load_video_frames(path, pred.cfg.image_size)
    state = pred.init_state(frames, vh, vw, max_objects=MAX_OBJECTS)
    pred.add_new_points_or_box(state, 0, 1, points=np.array([click], np.float32), labels=np.array([1], np.int32))
    if box is not None:
        pred.add_new_points_or_box(state, 0, 2, box=np.asarray(box, np.float32))
    return {f: (ids, logits[:, 0] > 0) for f, ids, logits in pred.propagate_in_video(state)}


def same_session_masks(got: dict, want: dict, what: str) -> int:
    """Every frame's object ids and masks bit for bit; returns the frames compared."""
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{what}: frames {list(got)} against {list(want)}")
    bad = [f for f in want if got[f][0] != want[f][0] or not np.array_equal(got[f][1], want[f][1])]
    if bad:
        f = bad[0]
        raise AssertionError(f"{what}: {len(bad)} frames differ, first {f}: ids {got[f][0]} / {want[f][0]}, "
                             f"{int((got[f][1] != want[f][1]).sum())} pixels")
    return len(want)


def run_http_session(card, pred, work, per_encoded=PER_ENCODED_FRAME, tag="(a)", upload="upload.avi",
                     writer=None) -> dict:
    """Phase 13 (a): the annotation server (``apps/http_api.create_server``,
    port 0, a daemon thread) through real HTTP round trips: upload of a
    seeded AVI of raw 'RGBA' frames (``upload``, written by ``writer``, by
    default ``session_video``; phase 14 (c) an mp4), a click, a box, track,
    ``masks.zip``, ``tracked.mp4`` (501 without cv2), DELETE and a 404 after.
    The session's masks and the zip's PNGs against the same predictor driven
    directly on the same frames, bit for bit; each request's launches exact
    (on the card). The direct run goes first and captures the frame body's
    graph, so the session's requests capture nothing. ``tag`` heads its log
    lines."""
    import threading

    import numpy as np

    from us_video_medsam2_tpu_torch.apps.app import MAX_OBJECTS
    from us_video_medsam2_tpu_torch.apps.http_api import create_server

    on_card = pred.device.type == "cuda"
    path = os.path.join(work, upload)
    click, box = (writer or session_video)(path, SEED + 30)
    n = HTTP_FRAMES
    t0 = time.perf_counter()
    captures = pred.graphs.captures
    want = drive_directly(pred, path, click, box)
    log(f"  {tag} direct run: {n} frames at {HTTP_HW[0]}x{HTTP_HW[1]}, {MAX_OBJECTS} object slots, objects 1 "
        f"(click) and 2 (box); {pred.graphs.captures - captures} capture(s), {time.perf_counter() - t0:.2f} s")
    captures = pred.graphs.captures
    os.makedirs(os.path.join(work, "http"), exist_ok=True)
    server = create_server(pred, port=0, tmp_root=os.path.join(work, "http"))
    host, port = server.server_address
    base = f"http://{host}:{port}"
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def timed(what, fn, encoded, tracked):
        t = time.perf_counter()
        out, launches = read_counts(fn)
        secs = time.perf_counter() - t
        if on_card:
            check_counts(f"{tag} {what}", launches, expected_launches(per_encoded, encoded, tracked))
        return out, secs, launches

    try:
        with open(path, "rb") as f:
            body = f.read()
        meta, up_s, _ = timed("upload", lambda: http_json(base, "POST", "/sessions", body=body,
                                                          headers={"X-Filename": upload}), 0, 0)
        if (meta["num_frames"], meta["height"], meta["width"]) != (n, *HTTP_HW):
            raise AssertionError(f"{tag} upload: {meta}")
        sid = meta["session_id"]
        clicked, click_s, click_launches = timed("click", lambda: http_json(
            base, "POST", f"/sessions/{sid}/click",
            {"frame_idx": 0, "obj_id": 1, "x": click[0], "y": click[1], "positive": True}), 1, 0)
        boxed, box_s, _ = timed("box", lambda: http_json(
            base, "POST", f"/sessions/{sid}/box", {"frame_idx": 0, "obj_id": 2, "box": box}), 0, 0)
        tracked, track_s, track_launches = timed("track", lambda: http_json(
            base, "POST", f"/sessions/{sid}/track", body=b"{}"), n - 1, n - 1)
        if clicked["obj_ids"] != [1] or boxed["obj_ids"] != [1, 2] or sorted(map(int, tracked["frames"])) != list(
                range(n)):
            raise AssertionError(f"{tag} bodies: click {clicked}, box {boxed}, frames {sorted(tracked['frames'])}")
        sess = server.RequestHandlerClass.sessions.get(sid)
        got = dict(sess.masks_by_frame)
        code, ctype, zbody = http_call(base, "GET", f"/sessions/{sid}/export/masks.zip")
        if code != 200 or ctype != "application/zip":
            raise AssertionError(f"{tag} masks.zip: {code} {ctype}")
        try:
            import cv2  # noqa: F401
            has_cv2 = True
        except ImportError:
            has_cv2 = False
        code, ctype, mp4 = http_call(base, "GET", f"/sessions/{sid}/export/tracked.mp4")
        if has_cv2 and (code, ctype) != (200, "video/mp4") or not has_cv2 and (
                code != 501 or b"cv2" not in mp4):
            raise AssertionError(f"{tag} tracked.mp4 with{'' if has_cv2 else 'out'} cv2: {code} {mp4[:200]!r}")
        log(f"  {tag} tracked.mp4: {f'{len(mp4)} bytes' if has_cv2 else 'cv2 is absent here: 501, ' + repr(mp4[:120])}")
        http_json(base, "DELETE", f"/sessions/{sid}")
        http_json(base, "POST", f"/sessions/{sid}/track", body=b"{}", want=404)
        healthz = http_json(base, "GET", "/healthz")
    finally:
        server.shutdown()
        server.server_close()
    if pred.graphs.captures != captures:
        raise AssertionError(f"{tag} the session captured {pred.graphs.captures - captures} graph(s)")
    frames = same_session_masks(got, want, f"{tag} the HTTP session vs the predictor driven directly")
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(zbody)) as z:
        names = sorted(z.namelist())
        if names != [f"{f:05d}.png" for f in range(n)]:
            raise AssertionError(f"{tag} masks.zip holds {names[:4]}...")
        for f, (ids, masks) in want.items():
            canvas = np.zeros(HTTP_HW, np.uint8)
            for oi, oid in enumerate(ids):
                canvas[masks[oi]] = oid
            if not np.array_equal(read_png_gray(z.read(f"{f:05d}.png")), canvas):
                raise AssertionError(f"{tag} masks.zip frame {f} differs from the direct run's")
    fg = [round(float(want[f][1][:2].mean()), 4) for f in (0, n // 2, n - 1)]
    per_enc = {k: track_launches[k] / (n - 1) for k in per_encoded}
    per_trk = {k: track_launches[k] / (n - 1) for k in PER_TRACKED_FRAME}
    log(f"  {tag} the HTTP session vs the predictor driven directly: {frames} of {n} frames bit-identical (ids and "
        f"masks of {MAX_OBJECTS} slots), masks.zip's {n} PNGs equal to the direct masks' canvases; foreground "
        f"of objects 1-2 at frames 0 / {n // 2} / {n - 1}: {fg}; healthz {healthz}")
    log(f"  {tag} upload-to-session {1e3 * up_s:.2f} ms ({len(body) / 1e6:.3f} MB, decoded and resized on the host), "
        f"click {1e3 * click_s:.2f} ms, box {1e3 * box_s:.2f} ms, track {1e3 * track_s:.2f} ms = "
        f"{1e3 * track_s / (n - 1):.2f} ms per tracked frame (HTTP round trips, host clock; {MAX_OBJECTS} "
        f"object slots, masks at {HTTP_HW[0]}x{HTTP_HW[1]}) on {card}")
    log(f"  {tag} launches: click {({k: v for k, v in click_launches.items() if v})} (one encoded frame); track per "
        f"encoded frame {per_enc}, per tracked frame {per_trk}")
    return {"upload_ms": 1e3 * up_s, "click_ms": 1e3 * click_s, "track_ms_per_frame": 1e3 * track_s / (n - 1)}


def track_together(sessions) -> list:
    """Each session's ``track`` in a thread of its own, started together (a
    barrier), the interpreter switching threads every 10 us; every
    session's {frame: (ids, masks)}."""
    import threading

    start = threading.Barrier(len(sessions))
    errors = []

    def run(s):
        try:
            start.wait(timeout=60)
            s.track()
        except Exception as e:  # noqa: BLE001 -- raised below, in the phase's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent tracking: {errors or 'a thread did not end'}")
    return [dict(s.masks_by_frame) for s in sessions]


def run_concurrent_sessions(card, pred, work) -> None:
    """Phase 13 (b): two sessions on one predictor and one graph key (the
    same length and object slots as (a)), tracked alone, then at once from
    two threads: each must give its own sequential bits, and on the card
    both runs launch exactly two sessions' worth (2 x (n - 1) frames encoded
    and tracked, no capture). Then once more with
    the predictor's lock replaced by a no-op (each graph launch still
    serialized, as the CUDA runtime asks of one executable graph): whether
    the bits then differ is printed, not held."""
    from us_video_medsam2_tpu_torch.apps.app import AnnotationSession
    from us_video_medsam2_tpu_torch.inference.graphs import FrameGraph

    sessions = []
    for i in range(2):
        path = os.path.join(work, f"session_{i}.avi")
        click, _ = session_video(path, SEED + 31 + i)
        s = AnnotationSession(pred, path)
        s.click(0, 1, click[0], click[1], True)
        sessions.append(s)
    captures = pred.graphs.captures
    on_card = pred.device.type == "cuda"
    tracked = 2 * (HTTP_FRAMES - 1)
    t0 = time.perf_counter()
    alone, launches = read_counts(lambda: [dict(s.track()) for s in sessions])
    t_alone = time.perf_counter() - t0
    if on_card:
        check_counts("(b) two sessions one after the other", launches,
                     expected_launches(PER_ENCODED_FRAME, tracked, tracked))
    t0 = time.perf_counter()
    together, launches = read_counts(lambda: track_together(sessions))
    t_together = time.perf_counter() - t0
    if on_card:
        check_counts("(b) two sessions at once", launches, expected_launches(PER_ENCODED_FRAME, tracked, tracked))
    for i, (got, want) in enumerate(zip(together, alone)):
        same_session_masks(got, want, f"(b) session {i} tracked beside the other vs alone")
    if pred.graphs.captures != captures:
        raise AssertionError(f"(b) {pred.graphs.captures - captures} capture(s) on a kept graph key")
    log(f"  (b) two sessions at once ({HTTP_FRAMES} frames each, one graph key): each bit-identical to its run "
        f"alone{', exact launches both ways' if on_card else ''}; {1e3 * t_alone:.1f} ms one after the other, "
        f"{1e3 * t_together:.1f} ms from two threads (the predictor's lock serializes the windows); on {card}")

    import threading

    lock, replay, launch = pred.lock, FrameGraph.replay, threading.Lock()

    def serialized_replay(self):
        with launch:
            replay(self)

    pred.lock, FrameGraph.replay = contextlib.nullcontext(), serialized_replay
    try:
        unlocked = track_together(sessions)
    finally:
        pred.lock, FrameGraph.replay = lock, replay
    differ = [sum(not (u[f][0] == a[f][0] and (u[f][1] == a[f][1]).all()) for f in a) for u, a in
              zip(unlocked, alone)]
    log(f"  (b) the same with the predictor's lock a no-op (not held): frames that differ from the sequential "
        f"bits {differ} of {HTTP_FRAMES} each; {'the check would fail' if any(differ) else 'no difference this time'}")


def run_sharded_serving(card, name, host_sd, served, device="cuda") -> None:
    """Phase 13 (c): phase 9's batched serving again, as a one-rank mesh
    (``parallel/mesh.create_mesh``: NCCL on the card, gloo on the CPU; this
    process's own ``MASTER_PORT``) through ``batched_propagate(...,
    mesh=...)`` on a new predictor of the same weights: one capture, exact
    launches and no host sync in the window (on the card), phase 9's bits,
    ms a call and frames/s beside phase 9's. The group is destroyed after."""
    import socket

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate, serve_graphs
    from us_video_medsam2_tpu_torch.inference.transforms import prep_frames
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor
    from us_video_medsam2_tpu_torch.parallel import distributed
    from us_video_medsam2_tpu_torch.parallel.mesh import create_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        mesh = create_mesh(device_type=device)
        backend = torch.distributed.get_backend()
        pred = build_sam2_video_predictor(name, state_dict=host_sd, fill_hole_area=8, device=device)
        on_card = pred.device.type == "cuda"
        raw, coords, labels = served["raw"], served["coords"], served["labels"]
        n, t, size = raw.shape[0], raw.shape[1], raw.shape[2]
        frames = prep_frames(torch.from_numpy(raw).to(pred.device).reshape(-1, size, size, 3), size)
        frames = frames.reshape(n, t, size, size, 3)
        graphs = serve_graphs(pred)

        def call():
            out = batched_propagate(pred, frames, coords, labels, mesh=mesh)
            sync(pred.device)
            return out

        out, launches = read_counts(call)
        made = graphs.captures
        if on_card:
            check_counts("(c) first sharded call", launches, expected_launches(PER_ENCODED_FRAME, t + made,
                                                                              t - 1 + made))
            if made != 1:
                raise AssertionError(f"(c) the first sharded call made {made} captures")
        runs = []
        with serve_window_sync_errors() if on_card else contextlib.nullcontext():
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out, launches = read_counts(call)
                runs.append(time.perf_counter() - t0)
                if on_card:
                    check_counts("(c) timed sharded call", launches, expected_launches(PER_ENCODED_FRAME, t, t - 1))
        if graphs.captures != made:
            raise AssertionError("(c) a second sharded call captured again")
    finally:
        distributed.destroy()
        for k in env:
            os.environ.pop(k, None)
    got = out.float().cpu().numpy()
    same = bool(np.array_equal(got, served["lows"]))
    secs = sorted(runs)[len(runs) // 2]
    log(f"  (c) one-rank {backend} mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {n} videos x {t} frames, "
        f"{made} capture{', exact launches, no sync in the window' if on_card else ''}; logits "
        f"{'bit-identical to' if same else 'DIFFER from'} phase 9's unsharded call (max |d| "
        f"{float(np.abs(got - served['lows']).max()):.3e})")
    log(f"  (c) sharded {1e3 * secs:.2f} ms a call, {n * (t - 1) / secs:.1f} tracked frames/s; phase 9 unsharded "
        f"{served['ms_per_call']:.2f} ms, {n * (t - 1) / (served['ms_per_call'] / 1e3):.1f} (host clock, median of "
        f"{REPEATS}) on {card}")
    if not same or (on_card and backend != "nccl"):
        raise AssertionError(f"(c) the sharded call: same bits {same}, backend {backend}")


def run_twins(card) -> None:
    """Phase 13 (d): ``tools/torch_bench_serve.py`` and
    ``tools/torch_bench_longvideo.py`` as subprocesses at a small size: their
    JSON lines parse, 37 and 64 frames share one capture, and the launches
    each twin counted in its own process are exact: the serving twin's over
    its timed calls (one encode and one track a frame past the first, each
    launch over the call's rows), the long-video twin's a video (one encode a
    frame, one track a frame past the first, one of each a capture's
    warm-up)."""
    import torch

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    n, t, runs = 4, 16, 2
    lines = {}
    for tool, args in (("torch_bench_serve", ["--videos", str(n), "--frames", str(t), "--runs", str(runs), "--json"]),
                       ("torch_bench_longvideo", ["--lengths", "37,64", "--chunk", "64"])):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(root, "tools", f"{tool}.py"), *args], cwd=root,
                           capture_output=True, text=True, timeout=TWIN_TIMEOUT_S)
        if p.returncode:
            raise AssertionError(f"(d) tools/{tool}.py exited {p.returncode}: {p.stderr[-2000:]}")
        lines[tool] = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
        log(f"  (d) tools/{tool}.py {' '.join(args)} ({time.perf_counter() - t0:.1f} s): "
            + "; ".join(json.dumps(x) for x in lines[tool]))
    def nonzero(counts):  # a twin lists the wrappers its process imported
        return {k: v for k, v in counts.items() if v}

    (serve,) = lines["torch_bench_serve"]
    if not (serve["value"] > 0 and serve["videos"] == n and serve["frames_per_video"] == t):
        raise AssertionError(f"(d) the serving twin's line: {serve}")
    check_counts(f"(d) the serving twin's {runs} timed calls", nonzero(serve["launches"]),
                 nonzero(expected_launches(PER_ENCODED_FRAME, runs * t, runs * (t - 1))))
    *videos, summary = lines["torch_bench_longvideo"]
    if [v["frames"] for v in videos] != [37, 64] or summary["captures_by_bucket"] != {"64": 1} or [
            v["captures"] for v in videos] != [1, 0]:
        raise AssertionError(f"(d) the long-video twin's lines: {videos}, {summary}")
    for v in videos:
        f, made = v["frames"], v["captures"]
        check_counts(f"(d) the long-video twin's {f} frames", nonzero(v["launches"]),
                     nonzero(expected_launches(PER_ENCODED_FRAME, f + made, f - 1 + made)))
    log(f"  (d) 37 and 64 frames in one capture (bucket 64), every twin's launches exact; the twins' device "
        f"{serve['device']}, card {card}")


def run_annotation(card, work, entry, name="sam2.1_hiera_t512", device="cuda") -> None:
    """Phase 13 (a)-(c) for the preset ``name`` at full width in bf16 on
    ``device`` with phase 9's weights and served videos (``entry``)."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    os.makedirs(work, exist_ok=True)
    pred = build_sam2_video_predictor(name, state_dict=entry["host_sd"], fill_hole_area=8, device=device)
    t0 = time.perf_counter()
    log(f"  (a) the annotation server: {HTTP_FRAMES}-frame {HTTP_HW[0]}x{HTTP_HW[1]} 'RGBA' AVI upload, click, "
        "box, track, masks.zip, tracked.mp4, DELETE")
    run_http_session(card, pred, work)
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    run_concurrent_sessions(card, pred, work)
    log(f"  (b) took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    run_sharded_serving(card, name, entry["host_sd"], entry["serving"], device)
    log(f"  (c) took {time.perf_counter() - t1:.1f} s")


# ----------------------------------------------------------------- phase 14
def quiet(fn, *args):
    """(fn(*args), what it printed), its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args), buf.getvalue()


def run_verifier(card, work, entry, name="sam2.1_hiera_t512", device="cuda") -> None:
    """Phase 14 (a): ``tools/torch_verify_real_ckpt.py``'s ``main`` on phase
    9's infer_video cases from a reference-name ``.pt`` of phase 9's weights:
    exit 0, its launches equal to phase 9's infer_video run (and, on the card,
    the predictor's), its ``evaluation_summary.csv`` byte for byte phase 9's
    ``metrics.csv`` (the same aggregator over the same frames) and its JSON
    summary's means that CSV's ALL rows; then on the first case under
    ``--expect_dice 0.999``: exit 1 and a FAIL line (seeded weights track far
    from the ground truth), its launches exact too."""
    import csv
    import io

    import torch

    from us_video_medsam2_tpu_torch.core.config import resolve_config

    apps = entry["apps"]
    on_card = torch.device(device).type == "cuda"
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, f"seed{SEED}_{name}_reference.pt")
    torch.save({"model": to_reference_state_dict(entry["host_sd"], resolve_config(name))}, ckpt)
    tool = load_tool("torch_verify_real_ckpt")
    firsts = apps["first"]

    def verify(out_dir, *extra):
        ran = []
        args = [ckpt, "--data_dir", apps["videos"], "--cfg", name, "--out_dir", out_dir, "--device", str(device),
                *extra]
        cases = len(firsts) if "--cases" not in extra else int(extra[extra.index("--cases") + 1])
        launches, secs = counted_app(f"(a) tools/torch_verify_real_ckpt.py {' '.join(args[3:])}",
                                     lambda: ran.append(quiet(tool.main, args)), prompts=cases,
                                     tracked=sum(APP_FRAMES - 1 - f for f in firsts[:cases]), on_card=on_card)
        (rc, out), = ran
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        if len(lines) != 1:
            raise AssertionError(f"(a) the verifier printed {len(lines)} JSON lines: {out[-2000:]}")
        log(f"  (a) exit {rc}, {secs:.2f} s; " + " | ".join(x for x in out.splitlines() if not x.startswith("{")))
        log(f"  (a) {json.dumps(lines[0])}")
        return rc, lines[0], out, launches

    rc, summary, _, launches = verify(os.path.join(work, "verify"))
    want_launches = apps["launches"]["infer_video"][0]
    with open(apps["metrics_csv"], "rb") as f:
        want_csv = f.read()
    with open(summary["csv"], "rb") as f:
        got_csv = f.read()
    alls = {row[1]: {"dice": float(row[2]), "iou": float(row[3]), "acc": float(row[4])}
            for row in csv.reader(io.StringIO(want_csv.decode())) if row[0] == "ALL"}
    log(f"  (a) launches {launches} against phase 9's infer_video {want_launches}; the CSV "
        f"{'byte for byte' if got_csv == want_csv else 'NOT'} phase 9's metrics.csv ({len(want_csv)} bytes); "
        f"global means {'equal to' if summary['global_means'] == alls else 'NOT'} its ALL rows")
    if rc != 0 or launches != want_launches or got_csv != want_csv or summary["global_means"] != alls or (
            summary["cases"] != len(firsts)):
        raise AssertionError("(a) the verifier disagrees with phase 9's infer_video on the same cases")
    rc, _, out, _ = verify(os.path.join(work, "verify_gate"), "--cases", "1", "--expect_dice", "0.999")
    if rc != 1 or "FAIL: class-1 Dice" not in out:
        raise AssertionError(f"(a) --expect_dice 0.999 exited {rc} (1 expected): {out[-500:]}")
    os.remove(ckpt)


def bidirectional(pred, frames, hw, clicks, mid, chunk=None, **init_kw):
    """Phase 14 (b)'s session: ``init_state(frames, *hw, **init_kw)`` with one
    object a click, all on frame ``mid``; propagation forward from ``mid``,
    then in reverse from it, ``chunk`` frames a chunk. Returns ({(direction,
    frame): logits [O, H, W]} in the order yielded, the state, seconds of
    propagation)."""
    state = pred.init_state(frames, *hw, max_objects=len(clicks), **init_kw)
    for o, xy in enumerate(clicks, 1):
        pred.add_new_points_or_box(state, mid, o, points=[list(xy)], labels=[1])
    out = {}
    sync(pred.device)
    t0 = time.perf_counter()
    for direction, reverse in (("forward", False), ("reverse", True)):
        for f, ids, masks in pred.propagate_in_video(state, start_frame_idx=mid, reverse=reverse,
                                                     chunk_size=chunk):
            if ids != list(range(1, len(clicks) + 1)):
                raise AssertionError(f"{direction} frame {f}: object ids {ids}")
            out[(direction, f)] = masks[:, 0]
    sync(pred.device)
    return out, state, time.perf_counter() - t0


def run_offload_study(card, pred, frames=OFFLOAD_FRAMES, hw=OFFLOAD_HW, chunk=STREAM_CHUNK) -> dict:
    """Phase 14 (b): a ``frames``-frame uint8 study at ``hw`` (not the model's
    resolution, so ``init_state`` preprocesses it on the host into the float16
    store), three objects clicked on the middle frame, streamed ``chunk``
    frames a chunk forward and then in reverse; against the resident session
    of the same frames (the store's, as f32 on the device) at phase 8 (b)'s
    graph-vs-eager gate (the same kernels on the same values); the resident
    session of the uint8 frames (preprocessed on the card in f32) beside it,
    its agreement printed, not held (the float16 store rounds the frames).
    Each session's launches exact on the card; the store's bytes and the
    peak device memory of the offloaded and the resident session (the
    offloaded lower). Returns the numbers."""
    import numpy as np
    import torch

    on_card = pred.device.type == "cuda"
    mid = frames // 2
    t0 = time.perf_counter()
    video, _, blobs = make_video(frames, hw[0], SEED + 50, width=hw[1])
    clicks = blob_clicks(blobs, frames=(mid,))[mid]
    log(f"  (b) video: {frames} frames of {hw[0]}x{hw[1]} uint8 ({video.nbytes / 2**20:.1f} MiB), "
        f"{len(clicks)} objects clicked on frame {mid}, made in {time.perf_counter() - t0:.1f} s")
    runs = {}
    store = []

    def session(what, fn):
        captures = pred.graphs.captures
        if on_card:
            torch.cuda.empty_cache()
            ((masks, state, secs), peak), launches = read_counts(lambda: peak_bytes(fn))
        else:
            (masks, state, secs), peak, launches = fn(), None, None
        made = pred.graphs.captures - captures
        tracked = sum(1 for d, f in masks if f != mid)
        if on_card:
            check_counts(f"(b) {what}", launches, expected_launches(PER_ENCODED_FRAME, 1 + tracked + made,
                                                                   tracked + made))
        order = [k for k in masks]
        want = [("forward", f) for f in range(mid, frames)] + [("reverse", f) for f in range(mid, -1, -1)]
        if order != want:
            raise AssertionError(f"(b) {what}: frames yielded {order[:4]}... not {want[:4]}...")
        runs[what] = (masks, peak)
        log(f"  (b) {what}: {tracked} tracked frames, {made} capture(s), propagation {secs:.3f} s = "
            f"{1e3 * secs / tracked:.3f} ms a tracked frame (host clock, captures included)"
            + (f", peak device memory {peak / 2**20:.1f} MiB" if peak is not None else ""))
        return state

    def offloaded():
        out = bidirectional(pred, video, hw, clicks, mid, chunk, offload_video_to_host=True)
        store.append(out[1].images_host)
        return out

    state = session(f"offloaded, chunks of {chunk}", offloaded)
    host = store[0]
    if host.dtype != np.float16 or host.shape[1:3] != (pred.cfg.image_size,) * 2 or not state.offloaded:
        raise AssertionError(f"(b) the host store is {host.dtype} {host.shape}, not float16 at model resolution")
    log(f"  (b) host store: {host.dtype} {tuple(host.shape)}, {host.nbytes} bytes ({host.nbytes / 2**20:.1f} MiB; "
        f"the uint8 video {video.nbytes} bytes, f32 frames on the device would be {2 * host.nbytes} bytes)")
    del state
    session("resident, the store's frames", lambda: bidirectional(
        pred, torch.from_numpy(host.astype(np.float32)), hw, clicks, mid))
    session("resident, the uint8 frames", lambda: bidirectional(pred, video, hw, clicks, mid))
    (off, p_off), (res, p_res), (raw, _) = (runs[k] for k in runs)
    per_object = {(d, f, o): m[o] for (d, f), m in off.items() for o in range(m.shape[0])}
    hold_graph_against_eager(per_object, {(d, f, o): m[o] for (d, f), m in res.items() for o in range(m.shape[0])},
                             f"(b) {frames}-frame study, 3 objects, both directions",
                             "offloaded (float16 store) and streamed vs resident on the same frames")
    worst, least = 0.0, 1.0
    for k, m in raw.items():
        a, b = off[k].astype("float64"), m.astype("float64")
        worst = max(worst, float(((a - b) ** 2).sum() ** 0.5 / max(((b ** 2).sum()) ** 0.5, 1e-12)))
        clear = abs(b) > SIGN_BAND * float((b ** 2).mean()) ** 0.5
        least = min(least, iou((a > 0) & clear, (b > 0) & clear))
    log(f"  (b) offloaded vs the resident session of the uint8 frames (preprocessed on the card in f32): worst "
        f"frame's logit rel-L2 {worst:.4e}, least mask IoU outside the band {least:.5f} over {len(raw)} frames "
        f"(printed, not held: the float16 store rounds the frames)")
    out = {"host_store_bytes": int(host.nbytes), "worst_rel_l2_vs_uint8": worst, "least_iou_vs_uint8": least}
    if on_card:
        log(f"  (b) peak device memory: offloaded {p_off / 2**20:.1f} MiB vs resident {p_res / 2**20:.1f} MiB "
            f"({(p_res - p_off) / 2**20:.1f} MiB lower); on {card}")
        if p_off >= p_res:
            raise AssertionError("(b) the offloaded session's peak is not below the resident session's")
        out.update(peak_offloaded=p_off, peak_resident=p_res)
    return out


def write_mp4(path, seed):
    """A seeded ``HTTP_FRAMES``-frame ``HTTP_HW`` video of moving blobs as an
    mp4 (``mp4v``, lossy) written by ``cv2.VideoWriter``; returns its click
    (blob 0) and box (blob 1's extent) on frame 0, as ``session_video``."""
    import numpy as np

    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("(c) needs cv2 to write and decode an mp4, and it does not import here") from e
    h, w = HTTP_HW
    video, click, blobs = make_video(HTTP_FRAMES, h, seed, width=w)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    if not out.isOpened():
        raise RuntimeError(f"(c) cv2.VideoWriter could not open {path} for mp4v")
    for f in video:
        out.write(np.ascontiguousarray(f[..., ::-1]))
    out.release()
    ys, xs = blobs[0, 1].nonzero()
    return list(click), [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]


def run_quickstart(card, name="sam2.1_hiera_t512", device="cuda", frames=QUICKSTART_FRAMES) -> None:
    """Phase 14 (d): ``examples/torch_quickstart.py``'s ``main`` (its own
    predictor, random weights from seed 0, one click on frame 0): exit 0,
    every frame propagated, and phase 4's launches for a run of ``frames``
    frames (one encode a frame, one track a frame past the first, one of each
    a capture)."""
    import importlib.util

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    ran = []
    launches, secs = counted_app(
        f"(d) examples/torch_quickstart.py --frames {frames}",
        lambda: ran.append(quiet(quickstart.main, ["--cfg", name, "--frames", str(frames), "--device", str(device)])),
        prompts=1, tracked=frames - 1, on_card=torch.device(device).type == "cuda",
        builder="build_sam2_video_predictor")
    (rc, out), = ran
    log("  (d) " + " | ".join(out.splitlines()) + f"; launches {launches}")
    if rc != 0 or f"propagated {frames} frames; mean Dice vs synthetic GT:" not in out:
        raise AssertionError(f"(d) the quickstart exited {rc}: {out[-500:]}")


def check_fast_fill(card, device="cuda", shape=FAST_FILL_SHAPE, areas=FAST_FILL_AREAS) -> None:
    """Phase 14 (e): ``fill_holes_in_mask_scores`` with ``method`` "fast"
    (JAX's gather-free filler: 256 masked 8-dilations from the border, a
    (2·max_area+1)² box count) and "exact" on a seeded batch of logits whose
    sign regions hold pockets of every size, on ``device`` against the host,
    bit for bit; the pixels each fills and the device's ms a call printed."""
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores

    g = torch.Generator().manual_seed(SEED + 60)
    b, h, w = shape
    noise = torch.randn(b, 1, h, w, generator=g)
    # ~4% background, in ~1,500 pockets a 512² frame, most of at most 8 px
    logits = (F.avg_pool2d(noise, 9, stride=1, padding=4) * 8 + 1.5)[:, 0]
    on_dev = logits.to(device)
    for method, max_areas in areas.items():
        for a in max_areas:
            want = fill_holes_in_mask_scores(logits, a, method=method)
            fill_holes_in_mask_scores(on_dev, a, method=method)  # warm-up
            sync(device)
            t0 = time.perf_counter()
            got = fill_holes_in_mask_scores(on_dev, a, method=method)
            sync(device)
            ms = 1e3 * (time.perf_counter() - t0)
            same = torch.equal(got.cpu(), want)
            filled = int((want != logits).sum())
            log(f"  (e) method {method!r}, max_area {a}: {filled} of {logits.numel()} pixels filled on "
                f"{b} x {h}x{w} logits; {device} {'bit for bit' if same else 'NOT equal to'} the host's; "
                f"{ms:.2f} ms a call (host clock, one call after a warm-up) on {card}")
            if not same or not filled:
                raise AssertionError(f"(e) method {method!r} at max_area {a}: the device and the host disagree, "
                                     "or nothing was filled")


# the hook (f) puts in the trainer's process: each train step's kernel
# launches, every count set to 0 just before the step, dumped as JSON at exit
STEP_HOOK = """# written by chip_smoke.py phase 14 (f): counts each train step's kernel launches
import atexit
import importlib.machinery
import importlib.util
import json
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:  # the interpreter's own sitecustomize, which this file shadows
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)

_out = os.environ.get("CHIP_SMOKE_STEP_LAUNCHES")
if _out and "LOCAL_RANK" in os.environ:  # a torchrun worker, not the agent
    from us_video_medsam2_tpu_torch.kernels import _lib
    from us_video_medsam2_tpu_torch.training import trainer

    _steps = []
    _orig = trainer.make_train_step

    def make_train_step(cfg):
        step = _orig(cfg)

        def counted(state, batch, gen):
            _lib.zero_launches()
            m = step(state, batch, gen)
            _steps.append({"n_init": m["plan"].n_init, "launches": _lib.launch_counts(),
                           "core_loss": float(m["core_loss"])})
            return m

        return counted

    trainer.make_train_step = make_train_step

    def _dump():
        with open(_out, "w") as f:
            json.dump(_steps, f)

    atexit.register(_dump)
"""


def run_launcher(card, work, entry, corpus, name="sam2.1_hiera_t512", device="cuda", epochs=1) -> None:
    """Phase 14 (f): ``scripts/torch_train_single_host.sh CORPUS OUT CKPT``
    (torchrun, one process a visible card) for ``epochs`` epoch(s) of phase
    10's corpus from a reference-name ``.pt`` of phase 9's weights, with the
    arguments cut as phase 10's (``TE_ARGS``, ``--cfg``, ``--resolution``,
    ``--device``); a ``sitecustomize`` hook on the trainer process's path
    (``STEP_HOOK``) counts each step's launches there, which must be phase
    10's exactly (on the card); its ``checkpoint.npz`` loads into the
    predictor, whose 16-frame run has phase 4's launches."""
    import shutil
    import types

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.core.config import resolve_config
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    on_card = torch.device(device).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(work, ignore_errors=True)
    hook = os.path.join(work, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(STEP_HOOK)
    cfg = resolve_config(name)
    ckpt = os.path.join(work, f"seed{SEED}_{name}_reference.pt")
    torch.save({"model": to_reference_state_dict(entry["host_sd"], cfg)}, ckpt)
    out, steps_json = os.path.join(work, "run"), os.path.join(work, "steps.json")
    cmd = ["bash", os.path.join(root, "scripts", "torch_train_single_host.sh"), corpus, out, ckpt,
           "--epochs", str(epochs), "--cfg", name, "--resolution", str(cfg.image_size), "--device", str(device),
           *TE_ARGS]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "NPROC_PER_NODE")}
    env.update(PYTHONPATH=os.pathsep.join([hook, root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])),
               PATH=os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", ""), PYTHON=sys.executable,
               CHIP_SMOKE_STEP_LAUNCHES=steps_json)
    if not on_card:
        env["NPROC_PER_NODE"] = "1"
    log(f"  (f) {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=LAUNCHER_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if p.returncode:
        raise AssertionError(f"(f) the launcher exited {p.returncode}: {p.stdout[-1500:]} {p.stderr[-3000:]}")
    with open(steps_json) as f:
        steps = json.load(f)
    with open(os.path.join(out, "train_stats.json")) as f:
        records = [json.loads(line) for line in f]
    log(f"  (f) exit 0 in {secs:.1f} s (torchrun, the trainer's start-up, {len(steps)} steps, the checkpoint); "
        f"train_stats {[round(r['Losses/train_all_loss'], 4) for r in records]}")
    if len(records) != epochs or not steps:
        raise AssertionError(f"(f) {len(records)} epochs of stats and {len(steps)} steps recorded")
    rec = StepRecorder()
    rec.steps = [(types.SimpleNamespace(n_init=s["n_init"]), s["launches"], s["core_loss"]) for s in steps]
    rec.check("(f) the launcher's steps, counted in the trainer's process", on_card)
    video, click, _ = make_video(FRAMES, cfg.image_size, SEED)
    pred = build_sam2_video_predictor(name, ckpt_path=os.path.join(out, "checkpoint.npz"), fill_hole_area=8,
                                      device=device)
    (masks, _, _), made = counted_run(pred, PER_ENCODED_FRAME, "(f) the launcher's checkpoint.npz served",
                                      lambda: run_main_path(pred, video, click))
    in_order(masks, FRAMES, "(f) served")
    if not all(np.isfinite(m).all() for m in masks.values()):
        raise AssertionError("(f) the served checkpoint gives non-finite logits")
    log(f"  (f) checkpoint.npz ({os.path.getsize(os.path.join(out, 'checkpoint.npz')) / 2**20:.1f} MiB) served "
        f"{FRAMES} frames, {made} capture(s), launches exact; on {card}")
    os.remove(ckpt)


def run_surfaces(card, work, entry, corpus, name="sam2.1_hiera_t512", device="cuda") -> dict:
    """Phase 14 (a)-(f) for the preset ``name`` at full width in bf16 on
    ``device`` with phase 9's weights (``entry``) and phase 10's corpus.
    Returns (b)'s and (c)'s numbers."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    log("  (a) tools/torch_verify_real_ckpt.py on phase 9's infer_video cases")
    run_verifier(card, os.path.join(work, "verifier"), entry, name, device)
    t1 = time.perf_counter()
    log(f"  (a) took {t1 - t0:.1f} s")
    pred = build_sam2_video_predictor(name, state_dict=entry["host_sd"], fill_hole_area=8, device=device)
    out = {"offload": run_offload_study(card, pred, OFFLOAD_FRAMES, OFFLOAD_HW, STREAM_CHUNK)}
    t2 = time.perf_counter()
    log(f"  (b) took {t2 - t1:.1f} s")
    out["mp4"] = run_http_session(card, pred, work, tag="(c)", upload="upload.mp4", writer=write_mp4)
    del pred
    t3 = time.perf_counter()
    log(f"  (c) took {t3 - t2:.1f} s")
    run_quickstart(card, name, device, QUICKSTART_FRAMES)
    t4 = time.perf_counter()
    log(f"  (d) took {t4 - t3:.1f} s")
    check_fast_fill(card, device, FAST_FILL_SHAPE, FAST_FILL_AREAS)
    t5 = time.perf_counter()
    log(f"  (e) took {t5 - t4:.1f} s")
    run_launcher(card, os.path.join(work, "launcher"), entry, corpus, name, device)
    log(f"  (f) took {time.perf_counter() - t5:.1f} s")
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile a propagation run (graph replays) of each model with the switches "
                         "off and one with them on, with each run's idle share, and one training step "
                         "without and one with temporal fusion; Chrome traces into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from us_video_medsam2_tpu_torch.inference.video_predictor import (
            build_efficienttam_video_predictor,
            build_sam2_video_predictor,
        )
        from us_video_medsam2_tpu_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    were_set = [k for k in FUSED_SWITCHES if os.environ.pop(k, None) is not None]
    if were_set:
        log(f"chip_smoke: {were_set} unset for the default phases; the fused phases set them themselves")

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/15] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    wait_for_memory()

    # 2. the build
    t0 = time.perf_counter()
    msgs = []
    lib = _lib.build(log=msgs.append)
    _lib.load()
    build_s = time.perf_counter() - t0
    log(f"[2/15] build: {lib.name} in {build_s:.2f} s (set-up)")
    if msgs:
        (lib.parent / "nvcc.log").write_text("\n".join(msgs))
        regs = ptxas_report(msgs)
        check_window_registers(regs)
        check_qkv_registers(regs)
        check_cxblock_registers(regs)
        check_v1_registers(regs)
        check_dropout_fwd_registers(regs)
    else:
        log("  (library built before this run: no compiler report)")

    # 3. each kernel against its plain version
    log("[3/15] kernels vs plain versions at the main-path shapes (bf16)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(g)
    check_kernel_grads(g)
    check_dropout_kernels(g, rows)
    check_fused_kernels(g, rows)
    check_window_attention_v1(g, rows)

    # 4-5. the main path: sam2.1_hiera_t512, switches off, then on
    log("[4/15] main path: sam2.1_hiera_t512, bf16, seeded weights and video")
    t512 = run_propagation("sam2.1_hiera_t512", build_sam2_video_predictor, PER_ENCODED_FRAME,
                           PER_ENCODED_FRAME_FUSED, "main_path", "[5/15]", card, args.profile,
                           precompute=PRECOMPUTE_BATCH)

    # 6. EfficientMedSAM-S: the same, through the EfficientTAM entry point
    log("[6/15] EfficientMedSAM-S: efficientmedsam_s_512, bf16, seeded weights and video")
    eff = run_propagation("efficientmedsam_s_512", build_efficienttam_video_predictor, PER_ENCODED_FRAME_VIT,
                          PER_ENCODED_FRAME_VIT_FUSED, "efficienttam_s", "[6/15]", card, args.profile,
                          VIT_IOU_MARGIN)
    launches = {k: t512["default"][k] + eff["default"][k] for k in t512["default"]}
    for k in ("cxblock", "qkv_window_attention"):  # the kernels of the fused configuration
        launches[k] = t512["fused"][k] + eff["fused"][k]
    log(f"  launches by path (per {FRAMES}-frame run): " + json.dumps(
        {f"{preset} {cfg}": {k: v for k, v in run[cfg].items() if v}
         for preset, run in (("sam2.1_hiera_t512", t512), ("efficientmedsam_s_512", eff))
         for cfg in ("default", "fused")}))

    # 7. the training path
    log(f"[7/15] training path: sam2.1_hiera_t512 train step, bf16 with f32 master weights, "
        f"T {TRAIN_T}, B 1, O {TRAIN_OBJECTS}, seeded weights and batch; without temporal fusion, then with "
        f"{GFTE_FUSION[0]}")
    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    train_launches, t512_fixed = run_training(args.profile, work,
                                              os.path.join(work, "measurement", "trace_t512_fixed"))
    log(f"  launches over the {TRAIN_STEPS} timed steps without fusion: {train_launches}")
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    # 8. the predictor's long-video and editing paths
    log("[8/15] long video and editing: sam2.1_hiera_t512, bf16, seeded weights; checkpoint, offload and "
        "streaming, buckets, editing")
    t0 = time.perf_counter()
    run_long_video_and_editing("sam2.1_hiera_t512", build_sam2_video_predictor, PER_ENCODED_FRAME, card,
                               args.profile, os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                                          "chip_smoke"))
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9. the entry points: the apps, batched serving, the image path
    log("[9/15] entry points: sam2.1_hiera_t512, bf16, seeded weights; the apps' mains, batched serving, "
        "the image predictor and the automatic mask generator")
    entry = run_entry_points(card, os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                                                "entry_points"))

    # 10. the training entry point: apps/train.py's main, resumed, served, GFTE, one NCCL rank, the native reader
    log("[10/15] training entry point: apps/train.py at sam2.1_hiera_t512, bf16 with f32 master weights, from a "
        "reference-name .pt of the seeded weights, on a seeded NPZ corpus")
    run_training_entry(card, os.path.join(work, "training_entry"))

    # 11. the EfficientTAM training half
    log(f"[11/15] EfficientTAM training: {VIT} train step, bf16 with f32 master weights, T {TRAIN_T}, B 1, "
        f"O {TRAIN_OBJECTS}, seeded weights and batch; the hd-64 kernels at the training shapes, the host gate, a "
        f"frozen encoder, apps/train.py --cfg {VIT} on phase 10's corpus")
    vit_fixed = run_vit_training(card, os.path.join(work, "vit_training"),
                                 os.path.join(work, "training_entry", "corpus"))

    # 12. the measurement layer: traces, FLOPs, MFU, the two tools
    log("[12/15] measurement layer: utils/profiling traces parsed by utils/traceparse, utils/flops, MFU, "
        "tools/torch_profile_propagation.py and tools/torch_bench_train_step.py")
    run_measurement(card, os.path.join(work, "measurement"),
                    {"sam2.1_hiera_t512": t512_fixed, VIT: vit_fixed})

    # 13. the annotation app over HTTP, two sessions at once, sharded serving, the two serving twins
    log("[13/15] annotation server, concurrent sessions, sharded serving and the serving twins: "
        "sam2.1_hiera_t512, bf16, phase 9's seeded weights")
    t0 = time.perf_counter()
    run_annotation(card, os.path.join(work, "annotation"), entry)
    t1 = time.perf_counter()
    run_twins(card)
    log(f"  (d) took {time.perf_counter() - t1:.1f} s")
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    # 14. the last user-facing surfaces: the checkpoint verifier, a float16 offload with three objects both
    # ways, an mp4 upload, the quickstart, the fast hole filler, the training launcher
    log("[14/15] user-facing surfaces: sam2.1_hiera_t512, bf16, phase 9's seeded weights; the checkpoint verifier, "
        f"a {OFFLOAD_FRAMES}-frame {OFFLOAD_HW[0]}x{OFFLOAD_HW[1]} study offloaded to a float16 host store and "
        "streamed with three objects both ways, an mp4 upload, the quickstart, the fast hole filler, the training "
        "launcher under torchrun")
    run_surfaces(card, os.path.join(work, "surfaces"), entry, os.path.join(work, "training_entry", "corpus"))

    # 15. the kernels line (launches of the dropout kernels from the training
    # steps, of cxblock and qkv_window_attention from the fused propagation
    # runs of both models, of the others from their default runs, where the
    # unwired window_attention_v1 launches none), the card line, the device line
    kernels = []
    for kname, r in rows.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname], "replaces": REPLACES[kname],
            "launches": train_launches[kname] if kname in PER_TRACKED_TRAIN_FRAME else launches[kname],
            "max_abs_err": r.max_abs, "ms": r.ms, "plain_ms": r.plain_ms,
            "bound_ms": r.bound, "bound_by": "bytes" if r.bytes_bound >= r.ops_bound else "operations",
            "library_ms": r.library_ms,
        })
    detail = {r.name: r.shapes for r in rows.values()}
    log("[15/15] per-shape detail " + json.dumps(detail))
    peak = max(PEAK_RESERVED[0], torch.cuda.max_memory_reserved())
    log(f"  the run's peak reserved device memory {peak / 2**30:.3f} GiB (max_memory_reserved; "
        f"{MEMORY_NEED_GIB} GiB asked free at the start)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:
        if type(e).__name__ == "OutOfMemoryError":
            print(f"chip_smoke: out of device memory; {card_memory()}", file=sys.stderr, flush=True)
        raise
