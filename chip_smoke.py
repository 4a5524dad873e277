#!/usr/bin/env python3
"""Smoke run of vpp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. the card's name and power limit;
2. build the CUDA kernels from ``vpp_tpu_torch/kernels/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (640x480, the bench clip recipe): K2 fast9 bit-equal
   in its three modes, each one launch a call (the full map; the cull at
   the tracker's 4096 slots after 6 frames; the score image of the SLAM
   frame after the 24-frame warm-up, with that warm-up's occupancy mask),
   each mode timed as below (``*_per_mode``);
   K1 flow level on every pyramid level, volume and dist within rtol 1e-5
   and flow equal wherever the best and second-best SAD differ by more
   than 1e-5 relative, the whole level (volume, flow, dist) bit-equal on
   the level buffers rounded to integers, propagation (pass by pass and
   all passes in one launch) exactly equal on equal inputs; K7 Hough
   accumulator one device kernel a call (its CUDA graph holds one kernel
   node and no memset),
   bit-identical across two launches, within 1e-4 * max of the float32
   scatter, and in every cell within its fixed-point rounding bound of a
   float64 scatter. Each is timed as called (``ms``: CUDA
   events around the Python calls, host work included) and on the device
   (``device_ms``: CUDA events around replays of a CUDA graph of the
   calls, captured after warm-up; the profiler's device time where
   capture is refused; ``device_ms_by`` names which). K1 is timed per
   level and per frame. Then K3 block top-K bit-equal at the 640x480 SLAM
   frame's score image (one launch a call), at 40000 and 82944 blocks
   (a 4K frame at 10 px) and on images of long runs of tied scores, uint8
   and int32, with its device time at each size; K4, the whole pyramid in
   one launch from the raw frame and from a bordered frame's interior, at
   640x480 and 357x493, 3 levels with border 9: bit-equal to the plain
   chain on integer-valued frames and within 1e-6 relative on float ones,
   one device kernel, timed beside the library route (``index_select``
   pads and banded ``torch.matmul`` pairs) and the parent's route (the
   frame image, a second pad of level 0 and one K4 launch a level); K5
   patches bit-equal at 1024 x 7x7 from int32
   and int64 centres in the bordered VGA frame and on a 3-channel buffer,
   one launch a call, beside the library's advanced indexing from the same
   centres (index preparation and gather, each also timed alone), and at
   the archive PnP's 512 x 9x9 from the SLAM frame's detections; K6, the
   whole window-BA
   call in one launch, on a keyframe problem of a 24-frame SLAM warm-up
   run: its trace's first-iteration S and cost within 1e-4 of the plain
   assembly relative to their largest magnitude, rhs within 1e-4 of the
   magnitude of its terms, the first pose solve's backward error within
   1e-5, two launches bit-identical (trace included), and poses within
   1e-4, every landmark's reprojections into its observing keyframes
   within 1e-3 px and costs within 1e-4 of the plain LM loop on the same
   problem; the same with every step rejected and with the pose
   factorisation failing; and ``ba_solve_tracks(iters=0)`` returning the
   problem bit-equal with empty costs and no launch. K6 is timed per
   ``ba_solve_tracks`` call. Each
   row with a library call (K3, K4, K5, K7) also carries the library's
   ``library_device_ms`` from the same CUDA-graph replays. Last, K8's
   map-vote PnP (vote rounds, pick, appearance gate, both PnP solves), one
   cluster launch for every match set, against its plain version: the
   shifts, ``j1``, ``uv1`` and ``inl`` bit-equal, T and err within 1e-4,
   ``n`` equal, two launches bit-identical, at A 1024 x Q 512 x B 2, A 37
   x Q 3, Q 4096, B 1, A 9000 (over 512 entries a CTA), with no usable
   entry and with no valid detection
   (the prior pose, err 0, n 0), with three valid detections and with a
   NaN map point; timed at 1024 x 512 x 2 (no single PyTorch call
   computes it: ``library_ms`` null; its bound
   counts the projections, each distance to a valid detection once, the
   gate of every inlier and both PnP solves over every entry);
4. the tracker main path: ``video_extruder_run`` at 640x480 with the bench
   config on 60 frames already on the card, frames/s under
   ``torch.cuda.synchronize``, launch counts of K1 (two per level and
   frame), K2 (72: a cull a frame, a score image every 5th) and K4 (61:
   one pyramid a frame and the first frame's), and the
   first 10 frames against the plain CPU path
   (alive counts within 1%);
5. the Hough path: ``hough_tracker_update`` on 30 frames of the two-line
   clip at 640x480, ms/frame, K7's launch count (one a frame), and the
   same frames on the
   plain CPU path (the same live tracks at the same (θ, ρ));
6. the SLAM tracking+BA path: ``slam_run`` at the matched 640x480
   configuration of ``benchmarks/bench_slam.py`` (2000-point cloud, lateral
   dolly, capacity 1024, ring 6, 3 LM iterations, recovery off) on 240
   frames rendered by ``vpp_tpu_torch/utils/synth.py`` (seed 1) and already
   on the card: frames/s under ``torch.cuda.synchronize``, launch counts of
   K1-K6 (K2 two a frame, K3 one a frame, K4 241, K5 and K6 one a
   keyframe),
   keyframes (60), live landmarks (> 200) and ATE (< 0.10). The
   state just before keyframe 30 is copied to the CPU and ``_do_keyframe``
   runs on both (poses within 1e-3, ``lm_valid`` agreeing on >= 99% of
   slots), the card's call under ``torch.cuda.set_sync_debug_mode("error")``
   (no host synchronisation); the first 40 frames on the plain CPU path
   give the card's keyframe count, landmark counts within 5% and ATE within
   0.02;
7. the full SLAM engine: the same clip and configuration with
   ``enable_recovery=True`` (``bench_slam.py``'s ``recovery=True`` run):
   frames/s, keyframes (60), landmarks (> 200), ATE (< 0.10), ``lc_ptr``,
   launch counts (K6 60, K8 60: one a keyframe); keyframe 30 from
   one state on both devices (poses within 1e-3, the smoothed history
   within 1e-2, ``lm_valid`` on >= 99% of slots, the same ``lc_ptr``), the
   card's call under ``set_sync_debug_mode("error")`` with exactly one
   host read, the smoother's branch flags; the pose-graph smoother at the
   run's full width (history 64, 384x384 systems) from the run's final
   state with one closure edge put in, both branches on both devices
   (within 1e-4, the history moved by more than 1e-3) and timed on the
   card; the first 40 frames against the plain CPU path on phase 6's
   fields; and K8 held to its plain version as in phase 3 on that card
   run's last archive PnP, with each set's err and its distance to the
   gate it meets (``rec_max_err``, ``lc_max_err``);
8. recovery at 120x160, on the card, with the port's copies of the scene
   recipes and the thresholds of tests/test_pose_graph_loop.py:59,83 and
   tests/test_pipeline.py:71: the out-and-back loop with a drift spike
   (at least one closure, ATE below the run without the archive; its last
   keyframe again with the smoother on, one host read; its last closure
   keyframe from one state on both devices, the ring equal and ``lc_w``,
   ``lc_T``, the history and the window poses within 1e-4), the blackout
   clip
   (the frame-16 keyframe within 0.45, ATE < 0.8), and ``relocalize`` at
   frame 24 (one K8 launch, >= ``lc_min_inliers`` inliers, error < 2.5 px,
   centre within 0.1);
9. SLAM streams: ``slam_run_streams`` at phase 6's configuration on 4
   clips (seeds 1-4; seed 1 is phase 6's) of 240 frames on the card, the
   launch counts reset just before: the launches of one stream (phase 6's
   counts); per stream 60 keyframes, > 200 landmarks, the tracker
   bit-equal to ``slam_run`` on its clip on the card, the history within
   0.05 and ATE within 0.02 of ``slam_run``'s, ATE < 0.10 on seed 1's
   clip; device operations a frame at S = 1 and 4 (CUDA-graph nodes of 8
   frames); aggregate frames/s at S = 1, 2, 4, 8 on 60 frames (median of
   3 rounds) beside the card's name and power limit; one streams keyframe
   under ``set_sync_debug_mode("error")``; K1-K6 at S = 3 (K3 also 8 and
   16) in one launch (K1 two a level), bit-equal to S separate launches
   and to their batched plain versions (K1 at both tile shapes, K1 and K4
   on integer-valued buffers and K4 within 1e-6 relative on the clip's,
   K6 within phase 3's tolerances); K6's co-resident clusters
   (``cudaOccupancyMaxActiveClusters``) and its device time at S = 1, 2,
   4, 8, 16, and each batched kernel's device time at S = 4;
10. bundle adjustment at the JAX package's production scale:
   ``ba_solve_tracks`` on the generic layout at N 10240 x M 128 x K 4, 5
   iterations, lam0 1e-4 (tests/test_slam_scale.py:13-40,78-97's recipe,
   made on the card from a numpy seed through the port's ``se3_exp`` and
   ``project``), the launch counts reset just before: one K9 launch a call
   and nothing else; for both ``linalg``, K9 held stage by stage to its
   plain version on the card (``k9_check``: S's block half-bandwidth; the
   first iteration's S, cost and rhs within 1e-4; the first pose solve's
   backward error on the system K9 solved below 1e-5 and no more than 4x
   the library's solve of that system, NaN only where the plain solve has
   one; the first candidate within 1e-4, two calls bit-identical, the
   loop's last cost within 1e-4 of the first above the plain loop's) and
   to the JAX scale test's gates (``costs[-1] < costs[0]·1e-4``, median
   landmark error < 1e-2); the same on masked slots (with
   test_slam_scale.py:128's gate), a repeated pose in a row, unseen
   landmarks, one slot a landmark, a closure pair (band 15: the dense
   factorisation) and the dense case at 512 poses (band 511; by iteration,
   whether K9's Cholesky and the library's held on the same system, whose
   float32 form is singular to working precision), masked slots
   naming a far pose (the band stays 3), NaN blocks outside the band (dp
   NaN, every step rejected), every step rejected and a failed pose
   factorisation; a ring problem down K9 within test_slam_scale.py:131's
   tolerances of K6; ``iters=0`` with no launch; ``slam_run`` with
   ``SlamConfig(ring=20)`` on 40 frames through K9 against the plain CPU
   path (phase 6's gates) and K9's device ms on its last window; device ms
   a call (CUDA-graph replays) and by stage from K9's own clock (the
   index, and per iteration the landmarks, blocks, pose solve (its system,
   panels, trailing updates and back-substitution) and step), the
   library's solve of the same pose system, as-called and plain ms, device
   operations against the plain route, the wide band (a closure pair at M
   128 and 512) beside the library's solve, and the same calls at M 16 x N
   1024 x K 4 and on the SLAM window's shape beside K6; the flat
   ``ba_solve`` on the card against the CPU (tests/test_slam.py:51) and
   timed at full width; the geometry on the card against the CPU
   (tests/test_geometry_matcher.py's inputs);
11. the Hough line path at full width, on the card against the plain CPU
   path: (a) ``hough_tracker_update`` with ``with_kalman_filter=True`` on
   phase 5's clip: ms/frame, one K7 launch a frame and nothing else, one
   step under ``set_sync_debug_mode("error")``, device operations a step
   with the filter on and off and of the UKF bank alone (CUDA-graph
   nodes); the CPU steps on the card's accumulator (K7's fixed-point sums
   flip the clip's near-tied peaks against the float32 scatter; the CPU's
   own peaks are held where their gap exceeds twice the accumulators'
   difference): ages and matches equal every frame, each step from the
   card's state within 1e-2 in theta, rho and ukf_x, the free runs' drift
   printed (the reference's filter is chaotic); (b) one-shot detection at
   1920x1080 (``hough_lines`` m 10; ``hough_adaptive_threshold`` then
   ``hough_peaks_clustered`` k 16; ``hough_sparse_revote`` along the found
   lines; ``hough_accumulator_mxu``), one K7 launch a call, each timed on
   the device and as called, the peaks bit-equal to the CPU's on the card's
   accumulator and equal to the CPU's own where the gap exceeds the
   tolerance, the revote bit-equal to K7 with its mask and within 1e-4 *
   max of the CPU, the mxu accumulator bit-equal to ``hough_accumulator``,
   K7 alone beside its bound at 1080p; (c) the painter on (a)'s final state
   (``paint_hough_video``, ``draw_line_tracks``: the same bits twice, the
   same painted pixels as the CPU within 1%, colours within one level;
   ``track_support_points`` k 64 on >= 99% of live slots); (d)
   ``semi_dense_optical_flow`` with ``epipolar_flow=True`` and with
   ``epipolar_filter=2.0`` at 640x480 (bench clip, 4096 keypoints, 3
   scales, F of a forward motion): ``matched`` agreeing on >= 99% of
   keypoints, distance within 1e-4 relative on >= 99% of those matched on
   both (K1's near ties), the filter route two K1 launches a level, the
   branch's host reads counted;
12. pyramidal LK, sparse flow, the distance transforms, Scharr, LBP, the
   matchers and the line-based pose at full width: (a) ``lucas_kanade`` at
   benchmarks/micro.py:232-243's workload (two bench-clip frames at
   640x480, border 9; 1024 keypoints from seed 0; winsize 11, 3 scales,
   21 iterations): one K10 and two K4 launches a call and nothing else;
   K10 asked for one level at a time against its plain version on the
   same inputs (flow within 1e-4 px and err within 1e-4 relative on >= 99%
   of keypoints, the kill decision differing on <= 0.5%; every template
   and gradient window sample bit-equal, the search windows where the
   flows are; the plain version sums in the kernel's lane order, so the
   run prints how many are bit-equal), and the call's one launch, every
   level in it, bit-equal to the plain level loop (each level's flow, err,
   windows and Newton steps) and to the call; the call against the plain
   CPU path on the card's pyramids (flow within 1e-2 px on >= 99% of the
   keypoints both keep; K4 and the plain chain differ in float32 ulps,
   which the coarsest level's wandering Newton iteration amplifies, so the
   CPU's run on its own pyramids is printed, not held); device and
   as-called ms, K10's bound, the plain levels' ms and device operations
   on the card, and K10's split (``k10_split``: device ms of one level by
   keypoint count and Newton-step cap); (b) ``pyrlk_match`` on 4096 FAST
   slots of the first frame with the tracker's pyramids (border 9): one
   K10 launch, alive agreeing with the CPU (on the card's pyramids) on >=
   99% of slots, positions within 1e-2 px; (c) ``sparse_optical_flow`` at
   its defaults: K2, K3, K4, K5 and K10 two, two, two, two and one
   launches, ``pos1`` and ``valid`` bit-equal to the CPU, ``pos2`` within
   1e-2 px on >= 99% of valid matches (the CPU on the card's LK pyramids;
   its own printed); (d) at 960x540 (micro.py:179-186, seeds ``rand <
   0.001`` from seed 0) the Euclidean transform in one K11 launch,
   bit-equal to its plain version on the card and to the CPU, K11 asked
   for each pass alone bit-equal to the plain pass, the chamfer ``d3_4``
   doubling bit-equal to the CPU, the ``d5_7_11`` sweeps equal where a
   seed reaches and >= 1e9 elsewhere; (e) ``scharr`` and
   ``lbp_transform`` at 1920x1080 bit-equal
   to the CPU; (f) ``bruteforce_match`` SAD (49 bytes) and Hamming (32
   bytes) at Q = T = 2048 bit-equal to the CPU, and
   ``pose_from_line_correspondences`` on tests/test_sfm.py:48's recipe
   within its gates and within 1e-3 of the CPU in R and t; each timed;
13. slice D at full width, on the card against the CPU, each part timed on
   the device (CUDA-graph replays, else the profiler's device time, named)
   and as called, with its device operations: (a) on one 1920x1080 frame
   of the bench clip recipe (border 1), a 3x3 ``pixel_wise`` stencil
   through ``relative_access``, ``block_wise`` at 16x16 (ragged at 1080),
   ``row_wise`` and a ``window_stack`` erosion over ``C8``, each bit-equal
   to the CPU; (b) an LIIE expression with ``if_``, ``sum_of`` and
   ``argmax_of`` on two such frames: the image bit-equal, ``argmax_of``
   equal, the sum within 1e-6 relative; (c) ``directional_pixel_wise
   ("left_to_right")`` as an int32 running sum over the frame's columns,
   bit-equal and equal to ``cumsum``, with its kernel launches a call (at
   least one a column: the evidence that the scan stays plain); (d) a
   64x256x256 ``image3d`` with border 1: a 6-neighbour stencil through
   ``shifted`` and ``linear_interpolate`` at 65536 seeded points, each
   within 1e-6 of the CPU relative to the largest magnitude; (e) phase 4's
   tracker fed through ``foreach_videoframe`` with and without prefetch
   over its 60 frames (12 runs alternating): final states bit-equal,
   frames/s both ways with their medians, the pump alone (a consumer that
   does nothing) both ways, and whether the states equal phase 4's
   ``video_extruder_run``;
   (f) the same run under ``Profiler`` sections (flow, lifecycle, detect,
   each stage's functions below it) with ``sync=``: the same final state,
   the report printed; (g) the native CPU baseline
   (``utils/native.py``, built here with g++) at 640x480 on 60 frames,
   three runs, beside phase 4's frames/s and live keypoints, with the
   host's CPU model and core count (``/proc/cpuinfo``); a build that fails
   fails the phase;
14. slice E, the sharded paths, on the card: (a) K1 at a column slice
   (``LevelGeometry.col0``, ``w_total``) on the extended slices of ranks 0,
   1 and 3 of 4 at every level (the pyramids by K4), against its plain
   version by phase 3's K1 rule, and rank 1's three levels timed; (b) the
   sharded tracker (``sharded_video_extruder_update``) at 640x480 with the
   bench config (halo 80) on 20 frames of the bench clip, at world size 1
   over NCCL and over 4 gloo ranks on this one card (shard width 160, the
   ring route; ranks started with ``spawn``, a ``file://`` store, rank 0
   loading the kernels before a barrier), the margin keypoints (40 px
   left, 80 right) killed each step in both runs: every step's ``age``,
   ``position`` and ``traj_len`` bit-equal to ``video_extruder_update`` on
   the card and ``sharded_semi_dense_flow`` on the final keypoints to
   ``semi_dense_optical_flow``, with ms/frame as called beside the
   single-device tracker's, K1/K2/K4 launches a frame per rank, the host
   time in collectives and each collective's backend and route (gloo's
   point-to-point staged through pinned host buffers); (c) the same at
   240x480 (shard width 60 < the halo: the all-gather route) on 6 frames;
   (d) over the 4 gloo ranks, ``ba_solve_tracks`` at phase 10's problem
   (the plain stages on the card, declared) against the plain LM loop on
   the card (tests/test_slam_scale.py:114-119's tolerances: costs rtol
   1e-3 atol 1e-5, poses and landmarks atol 1e-3) with its distance to
   K9's call, the flat ``ba_solve`` at tests/test_slam.py:82's problem,
   and ``slam_run(mesh=)`` at phase 6's configuration on 40 frames against
   phase 6's single-device card run within phase 6's gates (the same
   keyframes, landmarks within 5%, ATE within 0.02), each timed; every
   gloo rank's results the same bits as rank 0's. Four ranks on one card
   say nothing of scaling across cards;
15. the configurations the kernels once refused, on the card (every line
   beside the card's name and power limit): (a) ``lucas_kanade`` at phase
   12a's workload (two bench-clip frames at 640x480, 1024 keypoints from
   seed 0, 3 scales, 21 iterations) at winsize 21 and 31 (K10's staged
   route), at winsize 121 on a 1920x1080 pair (its global route; the CPU
   gate on the first 128 keypoints) and at 18 scales (two chained K10
   launches; K4 decimates the 2x2 levels to 2x2): each call's launches (one
   K10 a 16 levels, two K4), K10 bit-equal to the plain level loop on the
   card's pyramids (flow, err, windows, steps at every level), the call
   against the plain CPU path on those pyramids by phase 12a's gate (the
   keep decision on >= 99% of keypoints, >= 99% of those kept on both
   within 1e-2 px), the routes, device and as-called ms and K10's bound by
   phase 12a's count; (b) ``semi_dense_optical_flow`` at 640x480 on the
   tracker's pyramids at ``search_niters`` 5, 16 and 24 (121, 1089 and
   2401 displacements at the top level): every level held to its plain
   version by phase 3's K1 rule (bit-equal on the levels rounded to
   integers), each level's plan, K1's device ms by level and its bound,
   the call's device and as-called ms; then K1's global route (151 px
   windows on 40 px cells, one 640x480 level of the bench pair) held the
   same way, timed beside its bound; (c) ``slam_run_streams`` with
   ``ring = 20`` at phase 9's configuration otherwise on 4 clips (seeds
   1-4) of 40 frames: K9 launched once a stream a keyframe (4x one
   stream's count, no K6), each stream held to ``slam_run(ring=20)`` on its
   clip by phase 9's gates (the tracker bit-equal, ``hist_pose`` within
   0.05, ATE within 0.02), K9 on the last keyframe's window of the first
   S = 1, 2 and 4 streams (S launches, device and as-called ms), aggregate
   frames/s at S = 1, 2 and 4 (median of 3);
16. the back end past the kernels' old limits, on the card (every line
   beside the card's name and power limit): (a) K9 (``ba_solve_tracks``
   on the generic layout) at M 1024 x K 48 x N 4096, a closure over 2048
   poses (a full band, its panel in device memory; lam0 1), M 3072 x N
   20000 (the step in device memory) and N 600,000 x K 8 (4.8 M slots,
   past 2^22), LU and Cholesky, each by ``k9_check`` with the plain
   loop's spread from its float64-solve twin on the card, the routes
   ``k9_routes`` names, device ms beside the plain loop's and the bound;
   every route forced to device memory by a small budget at M 128 and a
   512-pose closure, bit-equal to the card's routes; ``slam_run`` with
   ``ring = 48`` on 40 frames against the CPU, its last window by
   ``k9_check``; (b) K8 at Q 20736 (``slam_run`` at 1920x1080 with
   capacity and ``detect_k`` 20736 and recovery on, 12 frames: its last
   archive PnP and a ``relocalize``) and at Q 65536 synthetic detections
   (the device route), each by ``k8_check``, timed beside the plain
   version and the bound; (c) ``semi_dense_optical_flow`` at 48
   propagation passes (launch B a chain of two launches) by phase 15b's
   rule, bit-equal on the integer levels; (d) K4 on 1x640 and 480x1
   frames, bit-equal to the plain chain on integer-valued frames, within
   1e-6 on float ones;
17. one ``{"kernels": [...]}`` line (each batched kernel with its
   ``launches_streams`` and ``device_ms_streams4``; K9's ``launches`` a
   ``ba_solve_tracks`` call of phase 10; K7's ``device_ms_1080p`` and
   ``bound_ms_1080p`` from phase 11; K10's and K11's rows from phase 12,
   one launch a lucas_kanade call and one a Euclidean transform; K10's
   device ms and bound by phase 15a's route, K1's device ms by phase 15b's
   ``search_niters``, K9's launches on phase 15c's ring-20 streams, and
   phase 16's device, plain and bound ms past the old limits), then
   ``{"ok": true,
   "device": ...}``.

Bounds use the H100 SXM data sheet (3.35 TB/s device memory, 67 TFLOP/s
float32 outside the tensor cores, applied to every scalar operation; for
K6, 34 TFLOP/s for its scalar float64 landmark algebra and 67 TFLOP/s for
its Schur products on the float64 tensor cores; K9's the same, per
iteration, with its band pose factorisation, and beside it the count with
a dense pose factorisation). K1's
bound counts its least work: both level buffers read once, flow and dist
written once, and the separable window sums (one |diff| per region pixel
and displacement, ws - 1 additions per column sum and per window). The
phase-3 line prints beside it the bound that counts every window summed in
full, six operations a pixel, as this script counted before the separable
sums; the kernels line carries only ``bound_ms``. K10's bound counts the
distinct 32-byte sectors of the template, gradient and search levels that
the windows touch (the template and gradient windows, and the search
windows at the prediction and at the final position) and 12 operations a
window sample, with the Newton steps each keypoint took (``k10_level_
bound``). K11's bound is the transform's: the bool mask read, the
distance and vectors written, and 44 operations a pixel a pass (each of
the 8 steps' two products, sum and compare, and the 12 shifts of a
displacement); the phase-12 line and the kernels line also carry the
bound of the earlier design of one launch a pass (two int32 planes read
and two written a pass).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12       # float64 outside the tensor cores
FP64_MMA_OPS_PER_S = 67e12   # float64 on the tensor cores
W, H = 640, 480
TRACK_FRAMES = 60
CPU_CHECK_FRAMES = 10
HOUGH_FRAMES = 30
SLAM_FRAMES = 240
SLAM_WARMUP = 24
SLAM_CPU_FRAMES = 40
SLAM_CHECK_KF = 30
STREAMS = 4
SLAM_INTR = (640.0, 640.0, 320.0, 240.0)
HOUGH_BIG = (1920, 1080)     # phase 11's one-shot detection frame
EPI_KEYPOINTS = 4096


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(torch, fn, calls: int = 20, replays: int = 20):
    """Device ms per call of ``fn``: CUDA events around ``replays`` replays
    of a CUDA graph of ``calls`` calls, captured after a warm-up (the
    device tables are cached by then). Where capture is refused, the
    profiler's device time of ``calls`` calls. Returns (ms, method)."""
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        print(f"chip_smoke: graph capture refused ({exc}); using the "
              "profiler's device time")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU)
        return us / 1e3 / calls, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls), "cuda_graph"


_GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_GRAPH_NODES_NO_WORK = (5, 6, 7)     # empty, event wait, event record


def graph_ops(torch, fn) -> dict:
    """The device operations one call of ``fn`` runs, by kind ("kernel",
    "memcpy", "memset"), read from a CUDA graph of that call (captured
    after a warm-up call) through the driver's graph API. Nodes that do no
    work on the device (empty, event) are left out; any other node type
    counts under ``type<n>``. This needs no device tracing: the profiler has
    been seen to return a session without any device event."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    ops: dict = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        if kind.value not in _GRAPH_NODES_NO_WORK:
            name = _GRAPH_NODE_KINDS.get(kind.value, f"type{kind.value}")
            ops[name] = ops.get(name, 0) + 1
    graph.reset()
    return ops


def bilinear_votes(torch, th_n, rho_n, w, t_theta: int, rho_bins: int):
    """The four bilinear votes of every pixel as flat cell indices and
    float32 values, computed as K7 computes them: (idx (4N,), votes (4N,))."""
    t0f, r0f = torch.floor(th_n), torch.floor(rho_n)
    ft, fr = th_n - t0f, rho_n - r0f
    t0 = t0f.long().clamp(0, t_theta - 1)
    r0 = r0f.long().clamp(0, rho_bins - 1)
    t1, r1 = (t0 + 1).clamp(max=t_theta - 1), (r0 + 1).clamp(max=rho_bins - 1)
    a0, a1 = w * (1 - ft), w * ft
    idx = torch.cat([t0 * rho_bins + r0, t0 * rho_bins + r1,
                     t1 * rho_bins + r0, t1 * rho_bins + r1])
    return idx, torch.cat([a0 * (1 - fr), a0 * fr, a1 * (1 - fr), a1 * fr])


def k7_bound_bytes(torch, th_n, rho_n, w, t_theta: int, rho_bins: int):
    """The bytes K7 must move: w in full, th and rho only in the 32-byte
    sectors that hold a voting pixel, the float32 accumulator out. Returns
    (bytes, sectors of th and rho)."""
    voters = torch.nonzero(w != 0).reshape(-1)
    sectors = sum(
        int(torch.unique((t.data_ptr() % 32 // 4 + voters) // 8).numel())
        for t in (th_n, rho_n))
    return w.numel() * 4 + sectors * 32 + t_theta * rho_bins * 4, sectors


def slam_config():
    """The matched tracking+BA configuration of benchmarks/bench_slam.py at
    640x480 (geometry vga_640x480, recovery off)."""
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    from vpp_tpu_torch.slam.pipeline import SlamConfig
    return SlamConfig(
        intrinsics=SLAM_INTR, keyframe_period=4, ring=6, ba_iters=3,
        pnp_iters=6, min_parallax=2.0, max_reproj=2.0, prune_reproj=2.5,
        history=64, lc_min_gap=60, enable_recovery=False,
        tracker=VideoExtruderConfig(capacity=1024, detect_k=512, nscales=3,
                                    winsize=9, keypoint_spacing=10,
                                    detector_period=1, detector_th=10))


def slam_clip(frames: int, seed: int = 1):
    """``frames`` frames of the SLAM clip (2000-point cloud, lateral dolly;
    seed 1 unless asked) as a numpy array, and the ground-truth poses."""
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    cloud = make_cloud(2000, seed=seed, extent=(16.0, 5.0, 3.5),
                       center=(3.2, 0.0, 5.0))
    gt_poses = camera_path(frames, step=(0.02, 0.0, 0.0))
    return render_frames(cloud, gt_poses, SLAM_INTR, (H, W), seed=seed,
                         sigma=(1.2, 2.2)), gt_poses


K8_KW = dict(r_wide=24.0, bmax=1.2, gate=0.35, rounds=2, pnp_iters=6,
             huber=4.0)   # the SLAM configuration's map_vote_pnp scalars


def pnp_inputs(torch, np, dev, a_n, q_n, b_n, kind, seed, p=7):
    """Seeded K8 operands at 640x480 (tests/test_torch_kernels_cuda.py's
    recipe): map points in front of the camera, detections at their
    projections under the true pose (rounded) and outliers, the prior pose
    off by a drift, binary descriptors that the true detection's centre
    patch repeats. ``kind``: "random", "ties" (the second half of the
    detections repeats the first: exact distance ties), "empty_base",
    "no_valid", "three_valid", "nan_row". Returns ``map_vote_pnp``'s
    operands."""
    rng = np.random.RandomState(seed)
    intr = np.asarray(SLAM_INTR, np.float32)
    z = rng.uniform(3.0, 8.0, a_n)
    X = np.stack([(rng.uniform(0, W, a_n) - W / 2) * z / intr[0],
                  (rng.uniform(0, H, a_n) - H / 2) * z / intr[1], z], 1)
    T_true = np.eye(4)
    T_true[:3, 3] = [0.05, -0.03, 0.02]
    T_prior = T_true.copy()
    T_prior[:2, 3] += [0.12, -0.08]
    xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([intr[1] * xc[:, 1] / xc[:, 2] + intr[3],
                   intr[0] * xc[:, 0] / xc[:, 2] + intr[2]], 1)
    n_src = min(q_n, a_n) if q_n <= 8 else min(q_n, a_n) * 3 // 4
    src = rng.permutation(a_n)[:n_src]
    pos = np.stack([rng.randint(0, H, q_n), rng.randint(0, W, q_n)], 1)
    pos[:len(src)] = np.round(uv[src])
    pos = np.clip(pos, 0, [H - 1, W - 1])
    if kind == "ties":
        pos[q_n // 2:] = pos[:q_n - q_n // 2]
    valid = rng.rand(q_n) > 0.1
    desc = (rng.rand(a_n, p * p) > 0.5) * 8.0
    det = (rng.rand(9, q_n, p * p) > 0.5) * 8.0
    det[4, :len(src)] = desc[src] + rng.normal(0, 0.1, (len(src), p * p))
    base = rng.rand(b_n, a_n) > np.linspace(0.1, 0.5, b_n)[:, None]
    if kind == "empty_base":
        base[:] = False
    if kind == "no_valid":
        valid[:] = False
    if kind == "three_valid":
        valid[:] = False
        valid[:3] = True
    if kind == "nan_row":
        X[5] = np.nan
    return tuple(torch.from_numpy(v).to(dev) for v in (
        X.astype(np.float32), desc.astype(np.float32), base,
        pos.astype(np.int32), valid, det.astype(np.float32),
        T_prior.astype(np.float32), intr))


def pnp_diff(torch, got, want, one_pair=False) -> float:
    """The largest difference of T and err, card against plain; inf where
    their NaN patterns differ. With ``one_pair`` (every set has a single
    pair) only where the plain version's are finite: one pair leaves four
    of the pose's six directions to the 1e-4 damping, which float32 loses
    beside the 6x6's other terms, so rounding decides whether a
    factorisation fails, the plain one as K8's."""
    worst = 0.0
    for g, w in ((got.T, want.T), (got.err, want.err)):
        if not one_pair and not torch.equal(torch.isnan(g), torch.isnan(w)):
            return float("inf")
        ok = ~torch.isnan(w)
        if bool(ok.any()):
            worst = max(worst, float((g[ok] - w[ok]).abs().max()))
    return worst


def k8_check(torch, MV, ops, kw, what, one_pair=False):
    """K8 on ``ops``: one launch for every match set; the shifts, j1, uv1
    and inl bit-equal to the plain version, T and err within 1e-4 (see
    ``pnp_diff`` for ``one_pair``), n equal; two launches bit-identical.
    Returns (largest T/err difference, the plain result)."""
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    want = MV._map_vote_pnp_plain(*ops, **kw)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        runs.append(MV.map_vote_pnp(*ops, **kw))
        torch.cuda.synchronize()
        check(launch_counts()["map_vote"] == 1,
              f"K8 ({what}) is not one launch for every match set")
    got = runs[0]
    check(same_bits(torch, got.txy, want.txy)
          and same_bits(torch, got.uv1, want.uv1)
          and torch.equal(got.j1, want.j1)
          and torch.equal(got.inl, want.inl),
          f"K8 ({what}): shifts, j1, uv1 or inl differ from the plain "
          "version")
    check(torch.equal(got.n, want.n), f"K8 ({what}): n {got.n.tolist()} "
          f"against the plain version's {want.n.tolist()}")
    if one_pair:
        check(bool((want.inl.sum(1) == 1).all()),
              f"K8 ({what}): a set without exactly one pair")
    diff = pnp_diff(torch, got, want, one_pair)
    check(diff <= 1e-4, f"K8 ({what}): T or err off the plain version by "
          f"{diff}")
    check(all(same_bits(torch, a, b) if a.dtype == torch.float32
              else torch.equal(a, b) for a, b in zip(*runs)),
          f"K8 ({what}): two launches differ")
    return diff, want


def k8_bound(torch, MV, ops, want, kw):
    """K8's least time for this call's data, the larger of its bytes and
    its operations. Bytes: X, pos, valid, base, T_prior and intr read
    once, the outputs written once, and of desc and the detection patches
    only the rows the gate needs: the desc row of every entry that is a
    pair before the gate in some match set, and the 9 patch rows of every
    distinct j1 of those pairs (from the plain version's vote and pick).
    Operations, at the float32 rate: per match set and round, every
    entry's projection (~25 operations) and its squared distance to each
    valid detection (5) with one compare to keep a top-4; the gate of
    every pair before it (9 shifts x P² x 3, and the energy, P² x 2); and
    both PnP solves over the inliers (~190 operations an inlier and
    iteration: projection, Jacobian, Huber weight, 27 normal-equation
    terms). Returns ((ms, bound by), bytes, operations)."""
    X, desc, base, pos, valid, det, T_prior, intr = ops
    a_n, p2 = desc.shape
    b_n, rounds, iters = base.shape[0], kw["rounds"], kw["pnp_iters"]
    picks = [MV._vote_pick_plain(X, base[i], pos.to(torch.float32), valid,
                                 T_prior, intr, kw["r_wide"], kw["bmax"],
                                 rounds) for i in range(b_n)]
    pre = torch.stack([pk[4] for pk in picks])
    j1 = torch.stack([pk[2] for pk in picks])
    rows = int(pre.any(0).sum()) + MV.SHIFTS * int(j1[pre].unique().numel())
    nbytes = (sum(t.numel() * t.element_size() for t in (
        X, pos, valid, base, T_prior, intr) + tuple(want))
        + rows * p2 * desc.element_size())
    n_ops = (b_n * rounds * a_n * (25 + 6 * int(valid.sum()))
             + int(pre.sum()) * (9 * p2 * 3 + 2 * p2)
             + 2 * iters * int(want.inl.sum()) * 190)
    return bound_ms(nbytes, n_ops), nbytes, n_ops


SCENE_INTR = (160.0, 160.0, 80.0, 60.0)


def keyframe_host_reads(torch, SP, state, frame, cfg):
    """``_do_keyframe`` on the card under ``set_sync_debug_mode("error")``,
    the smoother's branch read (``_smoother_branch``) exempted and counted:
    any other host synchronisation fails. Returns (state, reads)."""
    branch, reads = SP._smoother_branch, []

    def exempt(*a):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return branch(*a)
        finally:
            reads.append(a)
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize()
    SP._smoother_branch = exempt
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = SP._do_keyframe(state, frame, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        SP._smoother_branch = branch
    torch.cuda.synchronize()
    return out, len(reads)


def smoother_full_width(torch, SP, st, cfg):
    """``_smooth_history`` at the run's full width (history 64: 384x384
    systems) from the 240-frame run's final state, with one closure edge
    put in (keyframe 40 measured 0.05 off its pose along x), on the card
    and on the plain CPU path. Returns {branch: (card ms, largest pose
    difference card/CPU, largest move of the history)}."""
    kf = st.n_keyframes - 1
    lc_j, lc_T, lc_w = st.lc_j.clone(), st.lc_T.clone(), st.lc_w.clone()
    lc_j[0].fill_(40)
    lc_T[0] = st.hist_pose[40]
    lc_T[0, 0, 3].add_(0.05)
    lc_w[0].fill_(1.0)
    args = (st.hist_pose, st.pg_T, st.pg_w, lc_j, lc_T, lc_w, kf, cfg)
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    out = {}
    for branch, full in (("full", True), ("refresh", False)):
        got = SP._smooth_history(*args, full=full).cpu()
        want = SP._smooth_history(*cpu_args, full=full)
        ms = cuda_ms(torch, lambda: SP._smooth_history(*args, full=full), 5,
                     warmup=1)
        out[branch] = (ms, float((got - want).abs().max()),
                       float((want - cpu_args[0]).abs().max()))
    return out


def scenario_cfg(SP, **kw):
    """tests/test_pose_graph_loop.py's 120x160 configuration (recovery
    on)."""
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    base = dict(
        intrinsics=SCENE_INTR, keyframe_period=4, ring=6, ba_iters=3,
        min_parallax=2.0, max_reproj=2.0, history=16, lc_min_gap=10,
        lc_min_inliers=10, lc_max_err=1.5,
        tracker=VideoExtruderConfig(capacity=256, detect_k=128, nscales=3,
                                    winsize=9, keypoint_spacing=8,
                                    detector_period=1, detector_th=8))
    base.update(kw)
    return SP.SlamConfig(**base)


def scenario_run(torch, SP, frames, poses_gt, cfg):
    """``slam_run`` on the card; (state, keyframe ids, estimated poses on
    the host, ATE)."""
    st = SP.slam_run(torch.from_numpy(frames).cuda(), cfg,
                     bootstrap_poses=poses_gt[[0, cfg.keyframe_period]],
                     device="cuda")
    est, fids = SP.keyframe_trajectory(st)
    est, fids = est.cpu(), fids.cpu().numpy()
    return st, fids, est, float(SP.ate_rmse(est, torch.from_numpy(
        poses_gt[fids])))


def centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def scenario_recovery(torch, np, SP):
    """The recovery scenarios of tests/test_pose_graph_loop.py:59,83 and
    the relocalization of tests/test_pipeline.py:71, on the card, with the
    port's copies of their scene recipes, held to those tests' own
    thresholds."""
    from vpp_tpu_torch import convert
    from vpp_tpu_torch.core.image import Image2d, from_array
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    hw = (120, 160)
    # out and back along x with a blackout spike on the way out
    pts = make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                     center=(0.4, 0.0, 5.0))
    xs = list(np.arange(20) * 0.06)
    xs += list(xs[-1] - np.arange(1, 21) * 0.06)
    poses_gt = np.tile(np.eye(4, dtype=np.float32), (len(xs), 1, 1))
    poses_gt[:, 0, 3] = -np.asarray(xs)
    frames = render_frames(pts, poses_gt, SCENE_INTR, hw, seed=0,
                           sigma=(1.0, 1.8)).copy()
    frames[10:13] = 0.0
    cfg_on = scenario_cfg(SP, history=24, lc_max_err=4.5, lc_min_gap=8)
    do_kf, kept = SP._do_keyframe, {}

    def keep_last(state, frame2, cfg_, **kw):
        kept["last"] = (state, frame2)
        out = do_kf(state, frame2, cfg_, **kw)
        if int(out.lc_ptr) > int(state.lc_ptr):
            kept["closure"] = (state, frame2)
        return out

    SP._do_keyframe = keep_last
    try:
        on, _, _, ate_on = scenario_run(torch, SP, frames, poses_gt, cfg_on)
    finally:
        SP._do_keyframe = do_kf
    off, _, _, ate_off = scenario_run(torch, SP, frames, poses_gt,
                                      scenario_cfg(SP, history=24,
                                                   lc_min_inliers=10 ** 6))
    print(f"phase 8: loop with a drift spike: {int(on.lc_ptr)} closures, "
          f"ATE {ate_on:.4f} against {ate_off:.4f} without the archive")
    check(int(off.lc_ptr) == 0 and int(on.lc_ptr) >= 1,
          "the loop scenario fired no closure")
    check(ate_on < ate_off, f"closures did not lower the ATE ({ate_on} >= "
          f"{ate_off})")
    # the last keyframe again, the smoother on: its branch read only
    kst, kframe = kept["last"]
    check(bool((kst.lc_w > 0).any()), "no closure edge before the last "
          "keyframe")
    _, reads = keyframe_host_reads(torch, SP, kst, kframe, cfg_on)
    print(f"phase 8: the loop's last keyframe (smoother on) made {reads} "
          "host read, no other synchronisation")
    check(reads == 1, f"{reads} smoother reads in one keyframe")
    # the last keyframe that accepted a closure (the smoother's full
    # branch), from one state on both devices, at the CPU tests' 1e-4
    kst, kframe = kept["closure"]
    gkf, reads = keyframe_host_reads(torch, SP, kst, kframe, cfg_on)
    ckf = SP._do_keyframe(
        convert.slam_state_from_numpy(convert.slam_state_to_numpy(kst),
                                      device="cpu"),
        Image2d(data=kframe.data.cpu(), border=kframe.border), cfg_on)
    errs = {name: float((getattr(gkf, name).cpu()
                         - getattr(ckf, name)).abs().max())
            for name in ("lc_w", "lc_T", "hist_pose", "kf_pose")}
    moved = float((ckf.hist_pose - kst.hist_pose.cpu()).abs().max())
    print(f"phase 8: the loop's last closure keyframe (lc_ptr "
          f"{int(kst.lc_ptr)} -> {int(gkf.lc_ptr)}, smoother full branch, "
          f"history moved {moved:.4f}): card and plain CPU within "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; {reads} host read")
    check(reads == 1, f"{reads} smoother reads in the closure keyframe")
    check(int(gkf.lc_ptr) == int(ckf.lc_ptr) == int(kst.lc_ptr) + 1
          and torch.equal(gkf.lc_j.cpu(), ckf.lc_j),
          "the closure keyframe's ring differs between card and CPU")
    check(max(errs.values()) <= 1e-4, f"the closure keyframe differs "
          f"between card and CPU: {errs}")
    # a blackout: the keyframe after it re-localised from the archive
    pts = make_cloud(220, seed=1, extent=(6.0, 4.0, 3.0),
                     center=(0.6, 0.0, 5.0))
    poses_gt = camera_path(26, step=(0.05, 0.0, 0.0))
    frames = render_frames(pts, poses_gt, SCENE_INTR, hw, seed=1,
                           sigma=(1.0, 1.8)).copy()
    frames[13:15] = 0.0
    st, fids, est, ate = scenario_run(torch, SP, frames, poses_gt,
                                      scenario_cfg(SP, lc_min_gap=6,
                                                   min_tracked=10))
    k16 = int(np.where(fids == 16)[0][0])
    err16 = float(np.linalg.norm(centre(est[k16].numpy())
                                 - centre(poses_gt[16])))
    print(f"phase 8: blackout: keyframes at frames {fids.tolist()}, "
          f"{int(st.lm_valid.sum())} landmarks, frame-16 keyframe off by "
          f"{err16:.4f}, ATE {ate:.4f}")
    check(fids[-1] >= 20 and int(st.lm_valid.sum()) > 30,
          "the engine did not survive the blackout")
    check(err16 < 0.45, f"the frame-16 keyframe is off by {err16}")
    check(ate < 0.8, f"blackout ATE {ate}")
    # relocalize at the last keyframe of tests/test_pipeline.py's scene
    pts = make_cloud(220, seed=0, extent=(6.0, 4.0, 3.0),
                     center=(0.8, 0.0, 5.0))
    poses_gt = camera_path(25, step=(0.06, 0.0, 0.0))
    frames = render_frames(pts, poses_gt, SCENE_INTR, hw, seed=0)
    cfg = scenario_cfg(SP, lc_min_gap=12, lc_min_inliers=12)
    st, _, _, _ = scenario_run(torch, SP, frames, poses_gt, cfg)
    frame = from_array(torch.from_numpy(frames[24]).cuda(), border=9,
                       border_mode="mirror")
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    T, err, n = SP.relocalize(st, frame, cfg)
    check(launch_counts()["map_vote"] == 1,
          "relocalize is not one K8 launch")
    cerr = float(np.linalg.norm(centre(T.cpu().numpy())
                                - centre(poses_gt[24])))
    print(f"phase 8: relocalize at frame 24: {int(n)} inliers, error "
          f"{float(err):.4f} px, centre off by {cerr:.4f}")
    check(int(n) >= cfg.lc_min_inliers and float(err) < 2.5 and cerr < 0.1,
          "relocalize missed its gates")


def stream_problem(BA, p, s: int):
    """Problem ``s`` of a ``BATracks`` of streams (the intrinsics are
    shared)."""
    return BA.BATracks(*(t if i == 5 else t[s] for i, t in enumerate(p)))


def phase_streams(torch, np, mods, slam_cfg, slam_dev, gt_poses, sst,
                  slam_counts, results, smi):
    """Phase 9: ``slam_run_streams`` at the matched 640x480 configuration,
    S = 4 clips (seeds 1-4) of 240 frames on the card; each batched kernel
    against S separate calls and its batched plain version. Returns the
    numbers for the result lines."""
    F, FL, PY, IP, BA, BC, SP, KN = (mods[k] for k in (
        "F", "FL", "PY", "IP", "BA", "BC", "SP", "KN"))
    dev = slam_dev.device
    cfg = slam_cfg
    b = max(3, cfg.tracker.winsize)
    t0 = time.perf_counter()
    clips = [slam_dev] + [torch.from_numpy(slam_clip(SLAM_FRAMES, seed)[0])
                          .to(dev) for seed in range(2, STREAMS + 1)]
    clips = torch.stack(clips)                      # (4, 240, H, W)
    boots = torch.from_numpy(gt_poses[[0, cfg.keyframe_period]]).to(
        dev).expand(STREAMS, 2, 4, 4).contiguous()
    print(f"phase 9: rendered {STREAMS - 1} more clips in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path: 4 streams x 240 frames, counts reset just before
    problems = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        problems.append(prob)
        return solve(prob, **kw)

    SP.ba_solve_tracks = capture          # the warm-up keeps its problems
    try:
        SP.slam_run_streams(clips[:, :SLAM_WARMUP], cfg, boots,
                            device="cuda")
    finally:
        SP.ba_solve_tracks = solve
    torch.cuda.synchronize()
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    st4 = SP.slam_run_streams(clips, cfg, boots, device="cuda")
    torch.cuda.synchronize()
    dt4 = time.perf_counter() - t0
    counts4 = KN.launch_counts()
    fps4 = STREAMS * SLAM_FRAMES / dt4
    print(f"phase 9: slam_run_streams {STREAMS} x {SLAM_FRAMES} frames "
          f"{W}x{H}: {fps4:.2f} frames/s in all, launches {counts4} (one "
          f"stream's, phase 6: {slam_counts})")
    path = ("flow_level", "fast9", "block_topk", "pyramid_decim", "patches",
            "ba_tracks")
    for key in path:
        check(counts4[key] > 0, f"the streams path did not launch {key}")
        check(counts4[key] == slam_counts[key],
              f"{STREAMS} streams launched {key} {counts4[key]} times, one "
              f"stream {slam_counts[key]}")
    check(counts4["flow_level"] == 6 * SLAM_FRAMES
          and counts4["fast9"] == 2 * SLAM_FRAMES
          and counts4["block_topk"] == SLAM_FRAMES
          and counts4["pyramid_decim"] == SLAM_FRAMES + 1
          and counts4["patches"] == counts4["ba_tracks"] == SLAM_FRAMES // 4,
          f"streams launch counts {counts4}")
    check(st4.n_keyframes == SLAM_FRAMES // cfg.keyframe_period,
          f"{st4.n_keyframes} keyframes, expected 60")

    # per stream: the results, and the stream against slam_run on its clip
    # on the card. The ATE bound 0.10 is the matched clip's (seed 1, PERF.md
    # section 2); every stream's ATE is held to slam_run's on the same clip
    # within 0.02 (phase 6's card-against-CPU margin): the engine's own ATE
    # on the other clouds is slam_run's, not the streams' (seeds 3 and 4
    # read above 0.10 with slam_run too, PERF.md section 7)
    per_stream = []

    def ate_of(hist, fids):
        return float(SP.ate_rmse(hist.cpu(), torch.from_numpy(
            gt_poses[fids.cpu().numpy()])))

    for i in range(STREAMS):
        one = sst if i == 0 else SP.slam_run(
            clips[i], cfg, bootstrap_poses=boots[i], device="cuda")
        n = st4.n_keyframes
        ate = ate_of(st4.hist_pose[i, :n], st4.hist_frame[i, :n])
        ate1 = ate_of(one.hist_pose[:n], one.hist_frame[:n])
        lms = int(st4.lm_valid[i].sum())
        same = (torch.equal(one.tracker.keypoints.alive,
                            st4.tracker.keypoints.alive[i])
                and torch.equal(one.tracker.keypoints.position,
                                st4.tracker.keypoints.position[i]))
        pose_err = float((one.hist_pose[:n] - st4.hist_pose[i, :n]).abs()
                         .max())
        per_stream.append(dict(seed=i + 1, keyframes=n, landmarks=lms,
                               ate=ate, slam_run_ate=ate1,
                               tracker_bit_equal=same,
                               hist_pose_err_vs_slam_run=pose_err))
        print(f"phase 9: stream {i} (seed {i + 1}): {n} keyframes, {lms} "
              f"landmarks, ATE {ate:.4f} (slam_run on the clip {ate1:.4f}); "
              f"tracker bit-equal to slam_run: {same}, hist_pose within "
              f"{pose_err:.3g}")
        check(lms > 200, f"stream {i}: only {lms} landmarks")
        check(abs(ate - ate1) <= 0.02, f"stream {i}: ATE {ate} against "
              f"slam_run's {ate1}")
        check(i != 0 or ate < 0.10, f"stream {i}: ATE {ate} >= 0.10")
        check(same, f"stream {i}: the tracker differs from slam_run")
        check(pose_err <= 0.05, f"stream {i}: hist_pose differs from "
              f"slam_run by {pose_err}")

    # device operations a frame at S = 4 and S = 1 (8 frames each)
    def ops_per_frame(n):
        def run():
            SP.slam_run_streams(clips[:n, :8], cfg, boots[:n], device="cuda")
        try:
            ops = graph_ops(torch, run)
            by = "cuda_graph"
        except RuntimeError:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
            ops = {"kernel": sum(
                e.count for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU)}
            by = "profiler"
        return sum(ops.values()) / 8, ops, by
    ops1, ops4 = ops_per_frame(1), ops_per_frame(STREAMS)
    print(f"phase 9: device operations a frame (8 frames, 2 keyframes): "
          f"S = 1 {ops1[0]:.2f} {ops1[1]}, S = {STREAMS} {ops4[0]:.2f} "
          f"{ops4[1]} ({ops4[2]})")

    # aggregate frames/s at S = 1, 2, 4, 8 on 60 frames each: the median
    # of 3 rounds, the four S in turn in every round (the host's wall
    # drifts between and within calls)
    t_frames, rounds = 60, 3
    many = torch.cat([clips[:, :t_frames], clips[:, :t_frames]])
    many_boot = torch.cat([boots, boots])
    walls = {n: [] for n in (1, 2, 4, 8)}
    for n in walls:
        SP.slam_run_streams(many[:n, :8], cfg, many_boot[:n], device="cuda")
    for _ in range(rounds):
        for n in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SP.slam_run_streams(many[:n], cfg, many_boot[:n], device="cuda")
            torch.cuda.synchronize()
            walls[n].append(time.perf_counter() - t0)
    agg = {n: n * t_frames / sorted(w)[rounds // 2] for n, w in walls.items()}
    print(f"phase 9: aggregate frames/s on {t_frames} frames, median of "
          f"{rounds} ({smi}): "
          + ", ".join(f"S = {n} {v:.2f} ({v / agg[1]:.2f}x; rounds "
                      + "/".join(f"{n * t_frames / x:.1f}" for x in walls[n])
                      + ")" for n, v in agg.items()))

    # one streams keyframe at S = 4 with no host synchronisation
    lv = PY.pyramid_streams(clips[:, -1], cfg.tracker.nscales, border=b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kst = SP._keyframe_step(st4, lv[0], b, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(kst.n_keyframes == st4.n_keyframes + 1, "the streams keyframe")
    print(f"phase 9: one keyframe of {STREAMS} streams made no host "
          "synchronisation")

    # each batched kernel against S separate calls and its batched plain
    # version, at S = 3 (K3 also at 8 and 16)
    def one_launch(key, fn):
        KN.reset_launch_counts()
        out = fn()
        check(KN.launch_counts()[key] == 1,
              f"{key} on streams is not one launch")
        return out

    def bits(a, b_):
        if isinstance(a, (tuple, list)):
            return all(bits(x, y) for x, y in zip(a, b_))
        if a.dtype == torch.float32:
            return same_bits(torch, a, b_)
        return a.shape == b_.shape and torch.equal(a, b_)

    S3 = 3
    shapes = PY.level_shapes((H, W), cfg.tracker.nscales)
    mid = min(100, clips.shape[1] - 3)     # frame 100 of the 240
    fr3 = clips[:S3, mid]
    # K4
    lv3 = one_launch("pyramid_decim", lambda: PY.pyramid_streams(
        fr3, cfg.tracker.nscales, border=b))
    for i in range(S3):
        single = PY._k4(fr3[i], shapes, b, first=0)
        check(all(bits(lv3[l][i], single[l].data) for l in range(3)),
              f"K4 on streams differs from stream {i}'s own launch")
    fr3r = torch.round(fr3)
    k4r = PY.pyramid_streams(fr3r, cfg.tracker.nscales, border=b)
    check(bits(k4r, PY._plain_levels(fr3r, shapes, b)),
          "K4 on streams differs from its batched plain version on "
          "integer-valued frames")
    k4_rel = max(float(((x - y).abs() / y.abs().clamp(min=1)).max())
                 for x, y in zip(lv3, PY._plain_levels(fr3, shapes, b)))
    check(k4_rel <= 1e-6, f"K4 on streams off its plain version by {k4_rel}")
    # K1 on every level: fr3 against the frames two later
    lv3b = PY.pyramid_streams(clips[:S3, mid + 2], cfg.tracker.nscales,
                              border=b)
    radii = FL._level_radii(cfg.tracker.nscales, 5, 1)
    bounds = FL._level_bounds(cfg.tracker.nscales, radii)
    grid = PY.level_shapes((H // cfg.tracker.patchsize,
                            W // cfg.tracker.patchsize), cfg.tracker.nscales)
    rng = np.random.RandomState(9)
    k1_args = []
    for lvl in range(cfg.tracker.nscales):
        top = lvl == cfg.tracker.nscales - 1
        gh, gw = grid[lvl]
        g = FL.LevelGeometry(b=b, h=shapes[lvl][0], w=shapes[lvl][1],
                             ws=cfg.tracker.winsize,
                             patch=cfg.tracker.patchsize, gh=gh, gw=gw,
                             R=radii[lvl],
                             pred_bound=0 if top else 2 * bounds[lvl + 1])
        pb = max(g.pred_bound, 1)
        pred = torch.from_numpy(rng.randint(-pb, pb + 1, (S3, gh, gw, 2))
                                .astype(np.int32)).to(dev)
        if top:
            pred.zero_()
        k1_args.append((g, pred, lvl))
        KN.reset_launch_counts()
        got = FL.flow_level(lv3[lvl], lv3b[lvl], pred, g,
                            cfg.tracker.propagation)
        check(KN.launch_counts()["flow_level"] == 2,
              "K1 on streams is not two launches a level")
        for i in range(S3):
            one = FL.flow_level(lv3[lvl][i], lv3b[lvl][i], pred[i], g,
                                cfg.tracker.propagation)
            check(bits((got[0][i], got[1][i]), one),
                  f"K1 level {lvl} on streams differs from stream {i}'s own "
                  "launches")
        a1r, a2r = torch.round(lv3[lvl]), torch.round(lv3b[lvl])
        kr = FL.flow_level(a1r, a2r, pred, g, cfg.tracker.propagation)
        fpl, dpl, vpl = FL._match_plain(a1r, a2r, pred, g)
        for _ in range(cfg.tracker.propagation):
            fpl, dpl = FL._propagate_plain(fpl, dpl, pred, vpl, g.R)
        check(bits(kr, (fpl, dpl)), f"K1 level {lvl} on streams differs "
              "from its batched plain version on integer-valued levels")
        # both tile shapes: the plan at S = 3 against each tile's own plan
        for shape in FL._VOLUME_SHAPES:
            plan = FL._k1_plan(g, cfg.tracker.propagation,
                               FL._sm_count(dev), (shape,), S3)
            a1, a2, pr, _ = FL._level_operands(lv3[lvl], lv3b[lvl], pred, g,
                                               cfg.tracker.propagation)
            vol, part = FL._launch_volume(a1, a2, pr, g, plan)
            out = FL._launch_select(vol, pr, g.R, cfg.tracker.propagation,
                                    plan.b_tile, part,
                                    domain=(g.h, g.w, g.patch))
            check(bits(out, got), f"K1 level {lvl} differs at tile "
                  f"{shape[0]}")
    # K2: the score image with masks, and the cull
    th = cfg.tracker.detector_th
    masks = torch.from_numpy((rng.rand(S3, H, W) > 0.3).astype(np.uint8)).to(
        dev)
    img3 = one_launch("fast9", lambda: F.score_image(lv3[0], b, th, masks))
    for i in range(S3):
        check(bits(img3[i], F.score_image(lv3[0][i], b, th, masks[i])),
              f"K2's score image on streams differs from stream {i}'s")
    check(bits(img3, F._score_image_plain(lv3[0], b, th, masks)),
          "K2's score image on streams differs from its batched plain one")
    pos3 = torch.from_numpy((rng.rand(S3, cfg.tracker.capacity, 2)
                             * [H, W]).astype(np.float32)).to(dev)
    cull3 = one_launch("fast9", lambda: F.cull_scores(lv3[0], b, pos3, th))
    for i in range(S3):
        check(bits(cull3[i], F.cull_scores(lv3[0][i], b, pos3[i], th)),
              f"K2's cull on streams differs from stream {i}'s")
    check(bits(cull3, F._cull_plain(lv3[0], b, pos3, th)),
          "K2's cull on streams differs from its batched plain version")
    # K3 at S = 3, 8, 16: score images of 16 frames of the four clips
    frames16 = torch.stack([clips[i % STREAMS, (40 + 11 * i) % clips.shape[1]]
                            for i in range(16)])
    lv16 = PY.pyramid_streams(frames16, 1, border=b)[0]
    img16 = F.score_image(lv16, b, th)
    kdet, bs = cfg.tracker.detect_k, cfg.tracker.keypoint_spacing
    for n in (S3, 8, 16):
        got = one_launch("block_topk",
                         lambda: F.block_topk(img16[:n], 1, bs, kdet))
        for i in range(n):
            check(bits(tuple(t[i] for t in got),
                       F.block_topk(img16[i], 1, bs, kdet)),
                  f"K3 at S = {n} differs from stream {i}'s own launch")
        check(bits(got, F._block_topk_plain(img16[:n, 1:-1, 1:-1], bs,
                                            kdet)),
              f"K3 at S = {n} differs from its batched plain version")
    # K5
    ctr3 = torch.from_numpy(rng.randint(-4, W + 24, (
        S3, cfg.tracker.capacity, 2)).astype(np.int32)).to(dev)
    pat3 = one_launch("patches", lambda: IP.extract_patches(
        lv3[0], ctr3, cfg.desc_patch))
    for i in range(S3):
        check(bits(pat3[i], IP.extract_patches(lv3[0][i], ctr3[i],
                                               cfg.desc_patch)),
              f"K5 on streams differs from stream {i}'s own launch")
    check(bits(pat3, IP.extract_patches_plain(lv3[0], ctr3, cfg.desc_patch)),
          "K5 on streams differs from its batched plain version")
    # K6: the warm-up's last keyframe window of the first three streams
    prob4 = problems[-1]
    prob3 = BA.BATracks(*(t if i == 5 else t[:S3]
                          for i, t in enumerate(prob4)))
    iters, huber, lam0 = cfg.ba_iters, cfg.ba_huber, cfg.ba_lam0
    out3 = one_launch("ba_tracks", lambda: BC.lm_tracks(
        prob3, iters, huber, lam0, cfg.ba_linalg))
    for i in range(S3):
        one = BC.lm_tracks(stream_problem(BA, prob3, i), iters, huber, lam0,
                           cfg.ba_linalg)
        check(all(x is None and y is None or same_bits(torch, x[i], y)
                  for x, y in zip(out3[:3] + tuple(out3[3]),
                                  one[:3] + tuple(one[3]))),
              f"K6 on streams differs from problem {i}'s own launch")
    sp3, cp3 = BA._lm_tracks(prob3, iters, huber, lam0, True, cfg.ba_linalg,
                             kernel=False)
    sk3 = prob3._replace(poses=out3[0], landmarks=out3[1])
    k6_pose = float((out3[0] - sp3.poses).abs().max())
    k6_reproj = float((BA.track_residuals(sk3, True) - BA.track_residuals(
        sk3._replace(landmarks=sp3.landmarks), True)).abs().max())
    k6_cost = float(((out3[2] - cp3).abs() / cp3.abs().amax(-1,
                                                            keepdim=True))
                    .max())
    check(k6_pose <= 1e-4 and k6_reproj <= 1e-3 and k6_cost <= 1e-4,
          f"K6 on streams off its batched plain version: poses {k6_pose}, "
          f"reprojections {k6_reproj} px, costs {k6_cost}")
    print(f"phase 9: K1-K6 at S = {S3} (K3 also at 8 and 16) bit-equal to "
          f"S separate launches and to their batched plain versions (K4 "
          f"and K1 on integer-valued frames; K4 within {k4_rel:.3g} on the "
          f"clip's; K6 within poses {k6_pose:.3g}, reprojections "
          f"{k6_reproj:.3g} px, costs {k6_cost:.3g})")

    # K6's co-resident clusters, and its device time as S grows
    m_kf = prob4.poses.shape[1]
    clusters = BC.max_active_clusters(m_kf)
    k6_s = {}
    for n in (1, 2, 4, 8, 16):
        pn = BA.BATracks(*(t if i == 5 else torch.cat(
            [t] * (-(-n // STREAMS)))[:n] for i, t in enumerate(prob4)))
        k6_s[n] = device_ms(torch, lambda: BC.lm_tracks(
            pn, iters, huber, lam0, cfg.ba_linalg))[0]
    print(f"phase 9: K6 holds {clusters} clusters of 16 CTAs at once (M "
          f"{m_kf}); device ms a launch by S: "
          + ", ".join(f"{n}: {v:.4f}" for n, v in k6_s.items()))
    # the other kernels' device time at S = 4 (K3 also at S = 1)
    img4 = F.score_image(lv16[:STREAMS], b, th)
    pos4 = torch.cat([pos3, pos3[:1]])
    ctr4 = torch.cat([ctr3, ctr3[:1]])
    lv4 = PY.pyramid_streams(clips[:, mid], cfg.tracker.nscales, border=b)
    lv4b = PY.pyramid_streams(clips[:, mid + 2], cfg.tracker.nscales,
                              border=b)
    prob_s4 = prob4

    def k1_frame():
        for g, pred, lvl in k1_args:
            FL.flow_level(lv4[lvl], lv4b[lvl], torch.cat([pred, pred[:1]]),
                          g, cfg.tracker.propagation)

    s4 = {"flow_level": k1_frame,
          "pyramid_decim": lambda: PY.pyramid_streams(
              clips[:, mid], cfg.tracker.nscales, border=b),
          "fast9": lambda: F.score_image(lv4[0], b, th, torch.cat(
              [masks, masks[:1]])),
          "fast9_cull": lambda: F.cull_scores(lv4[0], b, pos4, th),
          "block_topk": lambda: F.block_topk(img4, 1, bs, kdet),
          "block_topk_s1": lambda: F.block_topk(img4[0], 1, bs, kdet),
          "patches": lambda: IP.extract_patches(lv4[0], ctr4,
                                                cfg.desc_patch),
          "ba_tracks": lambda: BC.lm_tracks(prob_s4, iters, huber, lam0,
                                            cfg.ba_linalg)}
    dev_s4 = {k: device_ms(torch, fn)[0] for k, fn in s4.items()}
    print(f"phase 9: device ms at S = {STREAMS}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in dev_s4.items()))
    for key in path:
        r = results[key]
        r["launches_streams"] = counts4[key]
        r["device_ms_streams4"] = dev_s4[key]
    results["fast9"]["device_ms_streams4_cull"] = dev_s4["fast9_cull"]
    results["block_topk"]["device_ms_streams1"] = dev_s4["block_topk_s1"]
    results["ba_tracks"]["device_ms_by_streams"] = k6_s
    results["ba_tracks"]["max_active_clusters"] = clusters
    return dict(streams=STREAMS, streams_fps=fps4, streams_launches=counts4,
                per_stream=per_stream, aggregate_fps=agg,
                device_ops_per_frame={"1": ops1[0], str(STREAMS): ops4[0],
                                      "by": ops4[2]})


GEN_N, GEN_M, GEN_K = 10240, 128, 4        # tests/test_slam_scale.py:78
GEN_ITERS, GEN_LAM0, GEN_HUBER = 5, 1e-4, 4.0
GEN_INTR = (300.0, 300.0, 160.0, 120.0)


def generic_problem(torch, np, BA, dev, n, m, k, seed, case="plain",
                    noise=0.0, rot=0.01, centre=False):
    """tests/test_slam_scale.py:13-40's recipe, made on the card from a
    numpy seed through the port's ``se3_exp`` and ``project``: m poses
    stepping 0.1 in x with ``rot`` radians of random rotation a step (the
    recipe's 0.01; a chain of thousands of poses takes less, or its
    heading wanders off the landmarks the recipe lays along x: the path's
    drift across them grows as M^1.5 times the rotation a step; with
    ``centre`` the world origin moved to the middle pose's camera centre,
    which halves the float32 coordinates of a chain hundreds of units
    long), each landmark seen by k consecutive poses,
    ``noise`` px of noise, the landmarks perturbed by 0.03 (the scale
    test's noisy start), poses 0 and 1 fixed. Cases: ``masked`` (slot 1
    of every row thrown 500 px and masked, test_slam_scale.py:122),
    ``repeated`` (slot 1 of every 3rd row names slot 0's pose),
    ``unseen`` (landmarks 10-13 with no valid slot), ``closure`` (landmark
    7 seen by poses 0 and m - 1: S's band spans the whole matrix),
    ``masked_far`` (the last slot of every 5th row masked and naming pose
    m - 1: the band stays the chain's), ``nonfinite`` (pose m - 1 NaN and
    named by masked slots only, the last slot of every 7th row from pose 8
    on, pose 0 free: S's blocks between pose 0 and those rows' poses,
    outside the band, are NaN). Returns (problem, the true landmarks)."""
    from vpp_tpu_torch.slam.se3 import se3_exp
    rng = np.random.RandomState(seed)
    xi = np.zeros((m, 6), np.float32)
    xi[1:, 3] = -0.1
    xi[1:, :3] = rng.randn(m - 1, 3) * rot
    steps = se3_exp(torch.from_numpy(xi).to(dev))
    poses = [torch.eye(4, device=dev)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = torch.stack(poses)
    start = rng.randint(0, m - k + 1, size=n)
    X = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    X[:, 0] += 0.1 * start
    X = torch.from_numpy(X.astype(np.float32)).to(dev)
    op = torch.from_numpy((start[:, None] + np.arange(k)[None]).astype(
        np.int32)).to(dev)
    if case == "closure":
        # in front of both ends of the chain, ~23 degrees off their axes
        op[7, 0], op[7, k - 1] = 0, m - 1
        X[7] = torch.tensor([0.05 * (m - 1), 0.0, 3.0 + 0.12 * (m - 1)],
                            device=dev)
    if centre:
        mid = poses[m // 2]
        c = -mid[:3, :3].T @ mid[:3, 3]
        poses[:, :3, 3] += poses[:, :3, :3] @ c
        X = X - c
    intr = torch.tensor(GEN_INTR, device=dev)
    uv = BA.project(poses[op.long()], X[:, None], intr) + torch.from_numpy(
        (rng.randn(n, k, 2) * noise).astype(np.float32)).to(dev)
    valid = torch.ones((n, k), dtype=torch.bool, device=dev)
    if case == "masked":
        uv[:, 1] += 500.0
        valid[:, 1] = False
    elif case == "repeated":
        op[::3, 1] = op[::3, 0]
    elif case == "unseen":
        valid[10:14] = False
    elif case == "masked_far":
        op[::5, k - 1] = m - 1
        valid[::5, k - 1] = False
    elif case == "nonfinite":
        poses[m - 1] = float("nan")
        valid &= op != m - 1
        far = torch.from_numpy(start >= 8).to(dev) & (
            torch.arange(n, device=dev) % 7 == 0)
        op[far, k - 1] = m - 1
        valid[far, k - 1] = False
    # with one slot a landmark the poses learn nothing from the landmarks
    # (S is lam I, dp rhs / lam: rounding noise), so K = 1 fixes every pose
    # and its step moves the landmarks alone
    fixed = torch.full((m,), k == 1, dtype=torch.bool, device=dev)
    fixed[:2] = True
    if case == "nonfinite":
        fixed[0] = False
        fixed[2] = True
    Xn = X + torch.from_numpy((rng.randn(n, 3) * 0.03).astype(
        np.float32)).to(dev)
    return BA.BATracks(poses=poses, landmarks=Xn, obs_pose=op, obs_uv=uv,
                       obs_valid=valid, intrinsics=intr,
                       fixed_poses=fixed), X


def predicted(BA, p, poses, lms):
    """Predicted minus measured uv at every valid slot of ``p`` under
    (poses, lms), 0 elsewhere."""
    return BA.track_residuals(p._replace(poses=poses, landmarks=lms))


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def band_of(torch, BA, p) -> int:
    """S's block half-bandwidth as K9 takes it: the widest span of the
    poses that one landmark's valid slots scatter to (JAX's scatter rule:
    negative from the end, dropped outside [0, M))."""
    m = p.poses.shape[0]
    idx = BA.scatter_index(p.obs_pose, m)
    ok = p.obs_valid & (idx < m)
    hi = torch.where(ok, idx, torch.full_like(idx, -1)).max(1).values
    lo = torch.where(ok, idx, torch.full_like(idx, m)).min(1).values
    return int(torch.where(hi >= 0, hi - lo, torch.zeros_like(hi)).max())


def backward_error(A, x, b) -> float:
    """||A x - b||inf / (||A||inf ||x||inf + ||b||inf) in float64; 0 where
    the residual is exactly 0."""
    A, x, b = A.double(), x.double(), b.double()
    r = float((A @ x - b).abs().max())
    if r == 0.0:
        return 0.0
    return r / (float(A.abs().sum(1).max()) * float(x.abs().max())
                + float(b.abs().max()))


def library_solve(torch, Sp, bs, linalg):
    """The library's solve of a scaled pose system (the yardstick of K9's
    pose-solve stage; the port never calls it): cuSOLVER's LU, or its
    Cholesky and two triangular solves."""
    if linalg == "chol":
        L, _ = torch.linalg.cholesky_ex(Sp)
        y = torch.linalg.solve_triangular(L, bs[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    return torch.linalg.solve_ex(Sp, bs)[0]


def k9_system(torch, p, tr, lam0):
    """The first pose system K9 solved, from its trace: S + lam0 I, identity
    rows and columns on the fixed poses, scaled by its Jacobi scales, in
    float32 in the kernel's order; and its right-hand side."""
    m = p.poses.shape[0]
    D = 6 * m
    fx = p.fixed_poses[:, None].expand(m, 6).reshape(-1)
    eye = torch.eye(D, device=p.poses.device)
    S = torch.where(fx[:, None] | fx[None, :], eye,
                    tr.S.reshape(D, D) + lam0 * eye)
    d = tr.scale
    return (S * d[:, None] * d[None, :],
            d * torch.where(fx, torch.zeros_like(d), tr.rhs.reshape(-1)))


def plain_loop_f64_solve(torch, BA, p, iters, lam0, linalg):
    """The plain LM loop with its pose solves in float64 (the same damped,
    gauge-fixed, scaled system, dp rounded to float32): how far the loop's
    poses move when only the solve's rounding changes."""
    solve = BA._tracks_solve_poses

    def f64(S, rhs, fixed, lam, linalg="lu"):
        lam = lam.double() if torch.is_tensor(lam) else lam
        return solve(S.double(), rhs.double(), fixed, lam, linalg).float()

    BA._tracks_solve_poses = f64
    try:
        return BA._lm_tracks(p, iters, GEN_HUBER, lam0, False, linalg,
                             kernel=False)
    finally:
        BA._tracks_solve_poses = solve


def library_held(torch, Sp, linalg) -> bool:
    """Whether the library's factorisation of a scaled pose system holds:
    cuSOLVER's Cholesky (every pivot positive) or LU (no zero pivot)."""
    if linalg == "chol":
        return int(torch.linalg.cholesky_ex(Sp)[1]) == 0
    return int(torch.linalg.lu_factor_ex(Sp)[2]) == 0


def k9_solve_record(torch, p, tr, lam, linalg):
    """K9's first pose solve on ``p`` (its trace ``tr``, damping ``lam``)
    beside the library's on the same system: whether each factorisation
    held, the backward error of each where it held, and the least
    eigenvalue of the scaled system (float64, from its float32 entries)."""
    Sk, bk = k9_system(torch, p, tr, lam)
    held = bool(torch.isfinite(tr.dp[0]).all())
    lib = library_held(torch, Sk, linalg)
    return dict(
        k9_held=held, library_held=lib,
        k9_backward_err=backward_error(Sk, tr.x, bk) if held else None,
        library_backward_err=backward_error(
            Sk, library_solve(torch, Sk, bk, linalg), bk) if lib else None,
        least_eigenvalue=float(torch.linalg.eigvalsh(Sk.double())[0]))


def k9_hold_record(torch, BG, p, iters, lam0, linalg, draws=8):
    """Where the scaled float32 pose system is singular to working
    precision: per iteration of K9's loop on ``p`` (a one-iteration call
    from the loop's iterate and damping, which repeats that iteration's
    dp bit for bit), ``k9_solve_record``; then over ``draws`` copies of
    ``p`` with every landmark coordinate moved one float32 ulp up or down
    at random (numpy seed 0), how often K9's first factorisation held and
    how often the library's held on the same system. Returns (rows,
    (K9's holds, the library's holds))."""
    import numpy as np
    full = BG.lm_generic(p, iters, GEN_HUBER, lam0, linalg)
    rows = []
    for it in range(iters):
        q = p
        if it:
            po, lm, _, _ = BG.lm_generic(p, it, GEN_HUBER, lam0, linalg)
            q = p._replace(poses=po, landmarks=lm)
        lam = float(full[3].lam[it])
        tr = BG.lm_generic(q, 1, GEN_HUBER, lam, linalg, trace=True)[3]
        row = k9_solve_record(torch, q, tr, lam, linalg)
        check(same_bits(torch, tr.dp[0], full[3].dp[it]),
              f"K9's iteration {it} from its iterate is not the loop's")
        row.update(lam=lam, accepted=bool(full[3].accept[it] != 0))
        rows.append(row)
    rng = np.random.RandomState(0)
    k9 = lib = 0
    for _ in range(draws):
        up = torch.from_numpy(rng.rand(*p.landmarks.shape) < 0.5).to(
            p.landmarks.device)
        lm = torch.where(up, torch.nextafter(p.landmarks, p.landmarks + 1),
                         torch.nextafter(p.landmarks, p.landmarks - 1))
        q = p._replace(landmarks=lm)
        tr = BG.lm_generic(q, 1, GEN_HUBER, lam0, linalg, trace=True)[3]
        k9 += bool(torch.isfinite(tr.dp[0]).all())
        lib += library_held(torch, k9_system(torch, q, tr, lam0)[0], linalg)
    return rows, (k9, lib)


def k9_check(torch, BA, BG, KN, p, iters, lam0, linalg, what, cpu=True):
    """K9 on ``p`` against its plain version on the card, stage by stage on
    the same inputs, then over the whole LM loop:
    - one launch a call, the same bits twice;
    - S's block half-bandwidth the widest span of a landmark's valid slots;
    - the first iteration's S and rhs (on the free poses' rows and
      columns, which the pose solve reads) and cost within 1e-4 of the
      plain assembly;
    - its first pose step NaN everywhere or nowhere, NaN only where the
      plain solve of its own system has a NaN; else d x, with a backward
      error ||Sp x - bs|| / (||Sp|| ||x|| + ||bs||) on the system it
      solved below 1e-5 and no more than 4x the library's solve of that
      system where the library's factorisation holds (at M 128 the scaled
      system's condition number is near 1e6, so two float32 solves' x
      differ along its weak directions: the solve is held by what it
      leaves of the equations, not by its x; a system positive definite
      only up to float32 rounding can fail one Cholesky and not another);
    - that step's candidate (one K9 iteration) against the plain pose
      step, back-substitution and cost from the same dp: its cost within
      1e-4 of the larger of the iterate's and the candidate's, the same
      decision (unless the two costs tie within 1e-4), and
      where accepted poses within 1e-4 (times the step's size where it
      passes 1: float32 sines of a large angle) and predicted measurements
      within 1e-3 px (times the poses' extent over 10 units where it
      passes 10);
    - the LM loop: the accepted costs as recorded; the last cost no more
      than 1e-4 of the first above the plain loop's, or 3x as far as the
      plain loop lands from itself on the CPU; where the plain loop's
      poses land within 1e-5 of themselves on the CPU (the problem
      determines them that far), poses within 1e-4 of it. Elsewhere the
      float32 pose solve of an ill-conditioned S (a weak gauge along a
      long chain, landmarks seen once) leaves the poses undetermined at
      that level: the distance is reported beside the plain loop's own,
      and beside the plain loop's with its pose solves in float64.
    With ``cpu`` False (problems whose plain loop takes minutes on the
    host) the plain loop's distance from itself is its distance from the
    same loop with float64 pose solves on the card, the rounding of the
    solve alone.
    Returns (numbers, (poses, landmarks, costs, trace))."""
    KN.reset_launch_counts()
    out = BG.lm_generic(p, iters, GEN_HUBER, lam0, linalg, trace=True)
    check(KN.launch_counts()["ba_generic"] == 1,
          f"K9 ({what}) is not one launch a call")
    again = BG.lm_generic(p, iters, GEN_HUBER, lam0, linalg, trace=True)
    check(all(same_bits(torch, a, b) for a, b in zip(
        out[:3] + tuple(out[3]), again[:3] + tuple(again[3]))),
          f"K9 ({what}) is not bit-identical across two calls")
    poses, lms, costs, tr = out
    band = int(tr.band)
    check(band == band_of(torch, BA, p),
          f"K9 ({what}): block half-bandwidth {band}, the data's "
          f"{band_of(torch, BA, p)}")
    lam = torch.full((), lam0, device=p.poses.device)
    (Sp, rp, cp), local = BA._tracks_assemble(p, lam, GEN_HUBER, False,
                                              linalg)
    finite = bool(torch.isfinite(cp))
    # S and rhs on the free poses' rows and columns, the ones the pose
    # solve reads (the gauge puts identity rows on the fixed ones)
    free = (~p.fixed_poses)[:, None].expand(-1, 6).reshape(-1)
    D = free.numel()
    s_rel = c_rel = r_rel = 0.0
    if finite:
        s_rel = (rel_err(tr.S.reshape(D, D)[free][:, free],
                         Sp.reshape(D, D)[free][:, free])
                 if bool(free.any()) else 0.0)
        c_rel = rel_err(tr.cost, cp)
        r_rel = float((tr.rhs.reshape(-1) - rp.reshape(-1))[free].abs().max(
            ) if bool(free.any()) else 0.0) / BA.rhs_term_scale(
            p, GEN_HUBER, False)
    check(s_rel <= 1e-4 and c_rel <= 1e-4 and r_rel <= 1e-4,
          f"K9 ({what}) assembly off the plain one: S {s_rel}, rhs {r_rel} "
          f"of its terms, cost {c_rel}")
    dp0 = tr.dp[0]
    want = BA._tracks_solve_poses(tr.S, tr.rhs, p.fixed_poses, lam, linalg)
    be_k9 = be_lib = None
    plain_failed = bool(torch.isnan(want).any())
    if bool(torch.isnan(dp0).any()):
        check(bool(torch.isnan(dp0).all()) and plain_failed,
              f"K9 ({what}): its pose step is NaN (in part, or where the "
              "plain solve of its system holds)")
    else:
        check(bool(torch.isfinite(dp0).all()) and same_bits(
            torch, dp0.reshape(-1), tr.scale * tr.x),
              f"K9 ({what}): its first pose step is not d x, or not finite")
        Sk, bk = k9_system(torch, p, tr, lam0)
        be_k9 = backward_error(Sk, tr.x, bk)
        # where the library's factorisation fails on a system that is
        # positive definite only up to float32 rounding and K9's holds,
        # K9's x is held to the equations alone
        if not plain_failed:
            be_lib = backward_error(Sk, library_solve(torch, Sk, bk, linalg),
                                    bk)
        check((be_lib is None or be_k9 <= 4 * be_lib) and be_k9 < 1e-5,
              f"K9 ({what}): the pose solve's backward error {be_k9} "
              f"against the library's {be_lib}")
    # the first candidate, from the same dp
    cand_p = BA.apply_pose_step(p.poses, dp0, p.fixed_poses)
    cand_l = p.landmarks + BA._tracks_backsub(local, dp0)
    new_p = BA._tracks_cost(p._replace(poses=cand_p, landmarks=cand_l),
                            GEN_HUBER)
    one = BG.lm_generic(p, 1, GEN_HUBER, lam0, linalg)
    acc_k = bool(one[3].accept[0] != 0)
    # relative to the larger of the two costs, as the loop's costs are
    # compared: a candidate at the noise floor differs by float32 rounding
    step_cost = float((one[3].cost_after[0] - new_p).abs()) / max(
        abs(float(cp)), abs(float(new_p)))
    tie = abs(float(new_p) - float(cp)) <= 1e-4 * abs(float(cp))
    step_pose = step_pred = 0.0
    if acc_k:
        step_pose = float((one[0] - cand_p).abs().max())
        step_pred = float((predicted(BA, p, one[0], one[1]) - predicted(
            BA, p, cand_p, cand_l)).abs().max())
    # float32 tolerances that grow with the step (sines of a large angle)
    # and with the scene's extent (a pose's last bit, far from the origin,
    # moves a prediction by ~4e-4 px at 51 units)
    step_tol = 1e-4 * max(1.0, float(torch.nan_to_num(dp0).abs().max()))
    pred_tol = 1e-3 * max(1.0, float(p.poses[:, :3, 3].abs().max()) / 10)
    check((not bool(torch.isfinite(new_p)) or step_cost <= 1e-4)
          and (tie or acc_k == bool(new_p < cp))
          and step_pose <= step_tol and step_pred <= pred_tol,
          f"K9 ({what}) first candidate off the plain step from its dp: "
          f"cost {step_cost}, accepted {acc_k} (plain {bool(new_p < cp)}), "
          f"poses {step_pose}, predicted measurements {step_pred} px (the "
          f"iterate's cost {float(cp)}, the candidate's "
          f"{float(one[3].cost_after[0])} / plain {float(new_p)}, |dp| "
          f"{float(torch.nan_to_num(dp0).abs().max())})")
    # the whole loop (where the iterate's cost is NaN, every cost is NaN
    # in both and nothing moves)
    sp, cpl = BA._lm_tracks(p, iters, GEN_HUBER, lam0, False, linalg,
                            kernel=False)
    if cpu:
        sc, ccpu = BA._lm_tracks(BA.BATracks(*(t.cpu() for t in p)), iters,
                                 GEN_HUBER, lam0, False, linalg,
                                 kernel=False)
    spread = f64_dist = cost_spread = pose_err = pred_err = last = float(
        "nan")
    if finite:
        check(torch.equal(costs, torch.where(tr.accept != 0, tr.cost_after,
                                             tr.cost_before)),
              f"K9 ({what}): costs are not the accepted ones")
        s64, c64 = plain_loop_f64_solve(torch, BA, p, iters, lam0, linalg)
        f64_dist = float((sp.poses - s64.poses).abs().max())
        if not cpu:
            sc, ccpu = s64, c64
        spread = float((sp.poses.cpu() - sc.poses.cpu()).abs().max())
        cost_spread = abs(float(ccpu[-1]) - float(cpl[-1])) / float(
            cpl.abs().max())
        pose_err = float((poses - sp.poses).abs().max())
        pred_err = float((predicted(BA, p, poses, lms) - predicted(
            BA, p, sp.poses, sp.landmarks)).abs().max())
        last = float(costs[-1] - cpl[-1]) / float(cpl.abs().max())
        check(last <= max(1e-4, 3 * cost_spread)
              and (spread > 1e-5 or pose_err <= 1e-4),
              f"K9 ({what}) LM loop off the plain one: last cost {last} of "
              f"the first above it, poses {pose_err} (the plain loop's own "
              f"CPU-to-card distance {spread}, its distance with float64 "
              f"pose solves {f64_dist})")
    else:
        check(torch.equal(torch.isnan(costs), torch.isnan(cpl))
              and not bool(tr.accept.any()) and same_bits(torch, poses, p.poses)
              and same_bits(torch, lms, p.landmarks),
              f"K9 ({what}): a NaN cost moved the problem")
    return dict(S_rel_err=s_rel, rhs_err_of_terms=r_rel, cost_rel_err=c_rel,
                band=band, solve_backward_err=be_k9,
                library_solve_backward_err=be_lib,
                step_cost_rel_err=step_cost, step_pose_err=step_pose,
                step_predicted_err_px=step_pred, lm_pose_err=pose_err,
                lm_predicted_err_px=pred_err, lm_last_cost_above=last,
                plain_cpu_card_pose_dist=spread, plain_f64_pose_dist=f64_dist,
                plain_cpu_card_last_cost_dist=cost_spread,
                accept=[float(a) for a in tr.accept.cpu()]), out


def band_ops(n: int, beta: int, linalg: str) -> float:
    """Operations of one band factorisation and its two triangular solves
    on the (n, n) pose system of block half-bandwidth beta (scalar
    half-bandwidth kl = 6 beta + 5): for LU with partial pivoting, per
    column the multipliers and the rank-1 update of U's widened band (kl +
    ku columns); for Cholesky, per column the lower band's update; each
    solve two operations an entry of its factor."""
    kl = min(6 * beta + 5, n - 1)
    ops = 0.0
    for j in range(n):
        km = min(kl, n - 1 - j)
        if linalg == "lu":
            ju = min(2 * kl, n - 1 - j)
            ops += km + 2.0 * km * ju + 2 * (km + ju)
        else:
            ops += km + km * (km + 1) + 4 * km
    return ops


def k9_bound(torch, p, iters, beta, linalg):
    """The least time of a K9 call on the H100 (ms, and what bounds it):
    each input read once and each output written once, against, per
    iteration, float32 Jacobians (~60 operations a slot), the scalar
    float64 landmark algebra (~486 a slot), the Schur pairs -W_k U_l^T of
    one landmark with k <= l (S is symmetric; 216 operations a pair, on
    the float64 tensor cores) and the pose solve: the band factorisation
    of this problem's block half-bandwidth (``band_ops``). Returns (ms,
    by), bytes, operations, and the operations and ms with a dense
    (6M)^3 / 3 factorisation instead."""
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    cnt = p.obs_valid.sum(1).double()
    rest = float(60 * cnt.sum()
                 + 486 * cnt.sum() * SCALAR_OPS_PER_S / FP64_OPS_PER_S
                 + 216 * (cnt * (cnt + 1) / 2).sum()
                 * SCALAR_OPS_PER_S / FP64_MMA_OPS_PER_S)
    ops = iters * (rest + band_ops(6 * m, beta, linalg))
    dense_ops = iters * (rest + (6 * m) ** 3 / 3)
    nbytes = (2 * m * 64 + 2 * n * 12 + n * k * (4 + 8 + 1) + 16 + m
              + iters * 4)
    return (bound_ms(nbytes, ops), nbytes, ops, dense_ops,
            bound_ms(nbytes, dense_ops)[0])


def k9_stages(torch, BG, p, iters, lam0, linalg, calls=5):
    """K9's device time by stage from its own clock (its stamps, decoded
    by ``BG.k9_stage_ms``), the median over ``calls`` calls: the index,
    the landmark, block, pose-solve and step stages a mean iteration
    (ms; the step with its share of the last decision), the stamps' whole
    span, and the pose solve a mean iteration split into its system,
    panels, trailing updates and back-substitution by the shares of CTA
    0's SM cycles."""
    rows = []
    stamps = torch.empty(8 * iters + 3, dtype=torch.int64,
                         device=p.poses.device)
    once = ("index", "span")
    for _ in range(calls):
        BG.lm_generic(p, iters, GEN_HUBER, lam0, linalg, stamps=stamps)
        ms = BG.k9_stage_ms(stamps, iters)
        rows.append({k: v if k in once else v / iters
                     for k, v in ms.items()})
    return {k: float(torch.tensor([r[k] for r in rows],
                                  dtype=torch.float64).median())
            for k in rows[0]}


def phase_ring20(torch, np, BA, KN, dev, ring=20, phase="10"):
    """``SlamConfig(ring=ring)`` (more poses than K6 takes) through
    ``slam_run`` on the first 40 frames of phase 6's clip on the card,
    against the plain CPU path at phase 6's gates (the same keyframes,
    landmark counts within 5%, ATE within 0.02): every window BA one K9
    launch and no K6 launch; K9's device ms on the run's last window.
    Returns its numbers and that window (problem, keyword arguments)."""
    from vpp_tpu_torch.slam import pipeline as SP
    cfg = dataclasses.replace(slam_config(), ring=ring)
    frames, gt = slam_clip(SLAM_CPU_FRAMES)
    boot = gt[[0, cfg.keyframe_period]]
    problems = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        problems.append((prob, kw))
        return solve(prob, **kw)

    SP.ba_solve_tracks = capture
    try:
        KN.reset_launch_counts()
        g = SP.slam_run(torch.from_numpy(frames).to(dev), cfg,
                        bootstrap_poses=boot, device="cuda")
        torch.cuda.synchronize()
        counts = KN.launch_counts()
    finally:
        SP.ba_solve_tracks = solve
    c = SP.slam_run(frames, cfg, bootstrap_poses=boot, device="cpu")

    def ate_of(st):
        e, f = SP.keyframe_trajectory(st)
        return float(SP.ate_rmse(e.cpu(), torch.from_numpy(
            gt[f.cpu().numpy()])))

    g_lm, c_lm = int(g.lm_valid.sum()), int(c.lm_valid.sum())
    g_ate, c_ate = ate_of(g), ate_of(c)
    check(len(problems) > 0 and counts["ba_generic"] == len(problems)
          and counts["ba_tracks"] == 0,
          f"slam_run with ring {ring} made {len(problems)} window BAs and "
          f"launched {counts}")
    check(g.n_keyframes == c.n_keyframes
          and abs(g_lm - c_lm) <= 0.05 * max(c_lm, 1)
          and abs(g_ate - c_ate) <= 0.02,
          f"slam_run with ring {ring} on the card is off the CPU's: keyframes "
          f"{g.n_keyframes}/{c.n_keyframes}, landmarks {g_lm}/{c_lm}, ATE "
          f"{g_ate}/{c_ate}")
    last, kw = problems[-1]
    t, by = device_ms(torch, lambda: BA.ba_solve_tracks(last, **kw),
                      calls=5, replays=5)
    ms = cuda_ms(torch, lambda: BA.ba_solve_tracks(last, **kw), 10)
    n, k = last.obs_valid.shape[-2:]
    print(f"phase {phase}: slam_run with ring {ring} on {SLAM_CPU_FRAMES} "
          f"frames: "
          f"card {g.n_keyframes} keyframes, {g_lm} landmarks, ATE "
          f"{g_ate:.4f}; plain CPU {c.n_keyframes}, {c_lm}, {c_ate:.4f}; "
          f"{len(problems)} window BAs, each one K9 launch ({counts}); K9 "
          f"on the last window (N {n}, M {k}, {kw['iters']} iterations, "
          f"{kw['linalg']}): {t:.4f} ms on the device ({by}), {ms:.4f} as "
          f"called")
    return dict(keyframes=g.n_keyframes, landmarks=g_lm, ate=g_ate,
                cpu_landmarks=c_lm, cpu_ate=c_ate, window_bas=len(problems),
                launches=counts, window_device_ms=t, window_ms=ms), last, kw


def phase_ba_generic(torch, np, BA, BG, KN, dev, results, smi):
    """Phase 10: bundle adjustment at the JAX package's production scale
    (N 10240, M 128, K 4) through ``ba_solve_tracks`` on the generic
    layout, K9 held to its plain version and to the JAX scale test's
    gates; the small, wide-band, dense and non-finite cases; a SLAM run
    with a ring of 20 through K9; the flat ``ba_solve`` and the geometry
    on the card against the CPU. Returns the numbers for the result
    lines."""
    from vpp_tpu_torch.algorithms import geometry as GEO
    t0 = time.perf_counter()
    p, X = generic_problem(torch, np, BA, dev, GEN_N, GEN_M, GEN_K, 2)
    out = {}
    full = {}
    for linalg in ("lu", "chol"):
        nums, (poses, lms, costs, tr) = k9_check(
            torch, BA, BG, KN, p, GEN_ITERS, GEN_LAM0, linalg,
            f"N {GEN_N}, M {GEN_M}, K {GEN_K}, {linalg}")
        c = costs.cpu().numpy()
        med = float((lms - X).abs().median())
        check(c[-1] < c[0] * 1e-4 and med < 1e-2,
              f"K9 ({linalg}) misses the JAX scale test's gates: costs "
              f"{c.tolist()}, median landmark error {med}")
        nums.update(costs=c.tolist(), median_landmark_err=med)
        full[linalg] = nums
    print(f"phase 10: K9 at N {GEN_N}, M {GEN_M}, K {GEN_K}, {GEN_ITERS} "
          f"iterations: " + "; ".join(
              f"{k}: S off by {v['S_rel_err']:.3g}, rhs "
              f"{v['rhs_err_of_terms']:.3g} of its terms, cost "
              f"{v['cost_rel_err']:.3g}; band {v['band']}, the pose "
              f"solve's backward error {v['solve_backward_err']:.3g} "
              f"(the library's on the same system "
              f"{v['library_solve_backward_err']:.3g}); the first "
              f"candidate's cost "
              f"{v['step_cost_rel_err']:.3g}, poses {v['step_pose_err']:.3g}, "
              f"predicted measurements {v['step_predicted_err_px']:.3g} px "
              f"off the plain step; the LM loop's poses "
              f"{v['lm_pose_err']:.3g} off the plain loop's (which is "
              f"{v['plain_cpu_card_pose_dist']:.3g} off itself on the CPU "
              f"and {v['plain_f64_pose_dist']:.3g} off its run with float64 "
              f"pose solves), "
              f"predicted measurements {v['lm_predicted_err_px']:.3g} px, "
              f"last cost {v['lm_last_cost_above']:.3g} of the first above "
              f"it; costs {v['costs']}, median "
              f"landmark error {v['median_landmark_err']:.3g}"
              for k, v in full.items()) + "; bit-identical twice")

    # the main path: one ba_solve_tracks call, counts reset just before
    KN.reset_launch_counts()
    solved, costs = BA.ba_solve_tracks(p, iters=GEN_ITERS, lam0=GEN_LAM0)
    torch.cuda.synchronize()
    counts = KN.launch_counts()
    check(counts["ba_generic"] == 1
          and sum(counts.values()) == counts["ba_generic"],
          f"ba_solve_tracks on the generic layout launched {counts}")
    check(bool(torch.isfinite(solved.poses).all())
          and bool(torch.isfinite(solved.landmarks).all())
          and tuple(costs.shape) == (GEN_ITERS,),
          "ba_solve_tracks' result is not finite or of the wrong shape")

    # the small cases, each against the plain loop (both linalg)
    # (closure: the band the whole matrix, the dense factorisation, at 16
    # and at 512 poses; masked_far: masked slots naming a far pose, the
    # band stays the chain's; nonfinite: S's blocks outside the band NaN)
    small, bands, berrs = {}, {}, {}
    for case, (n, m, k, lam0, iters) in {
            "masked": (64, 8, 3, 1e-3, 3), "repeated": (200, 8, 3, 1e-4, 5),
            "unseen": (200, 8, 3, 1e-4, 5),
            "one_slot": (200, 8, 1, 1e-4, 5),
            "closure": (1024, 16, 4, 1e-4, 5),
            "masked_far": (1024, 16, 4, 1e-4, 5),
            "nonfinite": (1024, 16, 4, 1e-4, 3),
            "closure_512": (4096, 512, 4, 1e-4, 5)}.items():
        pc, _ = generic_problem(torch, np, BA, dev, n, m, k, 5,
                                case.replace("_512", ""),
                                noise=0.0 if case == "masked" else 0.3)
        for linalg in ("lu", "chol"):
            nums, (po, lm, cs, tr) = k9_check(torch, BA, BG, KN, pc, iters,
                                              lam0, linalg,
                                              f"{case}, {linalg}")
            small[f"{case}_{linalg}"] = (nums["lm_pose_err"],
                                         nums["plain_cpu_card_pose_dist"],
                                         nums["plain_f64_pose_dist"])
            bands[case] = nums["band"]
            berrs[f"{case}_{linalg}"] = (nums["solve_backward_err"],
                                         nums["library_solve_backward_err"])
            if case == "nonfinite":
                b = nums["band"]
                check(not bool(torch.isfinite(tr.S.reshape(
                    m, 6, m, 6)[b + 1:, :, 0]).all())
                      and bool(torch.isnan(tr.dp).all())
                      and not bool(tr.accept.any()),
                      f"K9 ({linalg}): a NaN block outside the band did not "
                      "give a NaN, rejected step")
        if case == "masked":       # test_slam_scale.py:128's gate
            check(float(cs[-1]) < 1e-3, f"K9 masked slots: costs {cs}")
        if case == "closure_512":
            # the scaled float32 system here is singular to working
            # precision: whose Cholesky holds is decided by rounding
            hold, draws = k9_hold_record(torch, BG, pc, iters, lam0, "chol")
    check(bands["closure"] == 15 and bands["closure_512"] == 511
          and bands["masked_far"] == 3,
          f"K9's bands on the closure and masked cases: {bands}")
    # every step rejected, and the pose factorisation failing
    # (the observations of free pose 5 displaced 2000 px at lam0 1e-8:
    # each candidate costs more, in a CPU run of the plain loop; no valid
    # slot on pose 5 and no damping: S has a zero row and column)
    pc, _ = generic_problem(torch, np, BA, dev, 1024, 16, 4, 9, noise=0.3)
    rej = pc._replace(obs_uv=pc.obs_uv + 2000.0 * (pc.obs_pose == 5)[
        ..., None])
    fail = pc._replace(obs_valid=pc.obs_valid & (pc.obs_pose != 5))
    for what, pr, lam0 in (("rejected", rej, 1e-8), ("failed", fail, 0.0)):
        for linalg in ("lu", "chol"):
            _, (po, lm, _, tr) = k9_check(torch, BA, BG, KN, pr, 3, lam0,
                                          linalg, f"{what}, {linalg}")
            check(not bool((tr.accept != 0).any())
                  and same_bits(torch, po, pr.poses)
                  and same_bits(torch, lm, pr.landmarks)
                  and bool(torch.isnan(tr.dp).all()) == (what == "failed"),
                  f"K9 ({what}, {linalg}) took a step")
    # a ring problem down the generic route against K6, at
    # tests/test_slam_scale.py:131's recipe and tolerances
    from vpp_tpu_torch.slam.se3 import se3_exp
    rng = np.random.RandomState(4)
    xi = np.zeros((6, 6), np.float32)
    xi[1:, 3] = -0.2
    st = se3_exp(torch.from_numpy(xi).to(dev))
    rp = [torch.eye(4, device=dev)]
    for i in range(1, 6):
        rp.append(st[i] @ rp[-1])
    rp = torch.stack(rp)
    Xr = torch.from_numpy((rng.rand(64, 3) * 2 + [-1.0, -1.0, 3.0]).astype(
        np.float32)).to(dev)
    intr = torch.tensor(GEN_INTR, device=dev)
    ring = BA.BATracks(
        poses=rp, landmarks=Xr + torch.from_numpy((rng.randn(64, 3) * 0.02)
                                                  .astype(np.float32)).to(dev),
        obs_pose=torch.arange(6, dtype=torch.int32, device=dev)[None].expand(
            64, 6).contiguous(), obs_uv=BA.project(rp[None], Xr[:, None],
                                                   intr),
        obs_valid=torch.from_numpy(rng.rand(64, 6) > 0.3).to(dev),
        intrinsics=intr, fixed_poses=torch.tensor(
            [True, True, False, False, False, False], device=dev))
    ring_err = {}
    for linalg in ("lu", "chol"):
        s1, c1 = BA.ba_solve_tracks(ring, iters=4, lam0=1e-4, linalg=linalg)
        s2, c2 = BA.ba_solve_tracks(ring, iters=4, lam0=1e-4,
                                    ring_layout=True, linalg=linalg)
        e = (float(((c1 - c2).abs() / c2.abs()).max()),
             float((s1.poses - s2.poses).abs().max()),
             float((s1.landmarks - s2.landmarks).abs().max()))
        check(e[0] <= 1e-4 and e[1] <= 1e-5 and e[2] <= 1e-5,
              f"K9 against K6 on the ring problem ({linalg}): costs, poses, "
              f"landmarks off by {e}")
        ring_err[linalg] = e
    # no iteration: the problem back, empty costs, no launch
    KN.reset_launch_counts()
    s0, c0 = BA.ba_solve_tracks(p, iters=0)
    check(KN.launch_counts()["ba_generic"] == 0 and tuple(c0.shape) == (0,)
          and same_bits(torch, s0.poses, p.poses),
          "K9's route at iters=0 does not return its problem unchanged")
    print(f"phase 10: K9 on masked slots, a repeated pose, unseen "
          f"landmarks, one slot a landmark, a closure pair (band 15, the "
          f"dense factorisation), the same at 512 poses (band 511), masked "
          f"slots naming a far pose (band {bands['masked_far']}), NaN blocks "
          f"outside the band (dp NaN, rejected), every step rejected, a "
          f"failed pose factorisation. The LM loop's poses off the plain "
          f"loop's (the plain loop's own CPU-to-card distance, held to 1e-4 "
          f"where it is within 1e-5; the plain loop's distance with float64 "
          f"pose solves): "
          + ", ".join(f"{k} {a:.3g} ({b:.3g}; {c:.3g})"
                      for k, (a, b, c) in small.items() if a == a)
          + ". The first pose solve's backward error against the library's "
          "on the same system: "
          + ", ".join(f"{k} {a:.3g}/"
                      + ("failed" if b is None else f"{b:.3g}")
                      for k, (a, b) in berrs.items() if a is not None)
          + f". A ring problem within {ring_err} (costs, poses, landmarks) "
          f"of K6; iters=0 with no launch")
    print("phase 10: the closure pair at 512 poses, Cholesky, lam0 1e-4, "
          "by iteration of K9's loop: lam, whether K9's factorisation and "
          "the library's of the same system held (their backward errors), "
          "the scaled system's least eigenvalue (float64) and the decision: "
          + "; ".join(
              f"{i}: lam {r['lam']:.3g}, K9 {r['k9_held']} "
              f"({r['k9_backward_err']}), library {r['library_held']} "
              f"({r['library_backward_err']}), least eigenvalue "
              f"{r['least_eigenvalue']:.3g}, "
              f"{'accepted' if r['accepted'] else 'rejected'}"
              for i, r in enumerate(hold))
          + "; over 8 copies with the landmarks moved one ulp at random, "
          f"K9's first factorisation held {draws[0]} times, the library's "
          f"of the same systems {draws[1]}")
    ring20 = phase_ring20(torch, np, BA, KN, dev)[0]

    # times, both linalg; the main path's linalg ("lu") in the kernels line:
    # the call (CUDA-graph replays), its stages (K9's own clock), the
    # library's solve of the pose system K9 solved (the pose-solve stage's
    # yardstick), as called, the plain loop
    timing = {}
    for linalg in ("lu", "chol"):
        def k9_call(linalg=linalg):
            return BA.ba_solve_tracks(p, iters=GEN_ITERS, lam0=GEN_LAM0,
                                      linalg=linalg)

        def plain_call(linalg=linalg):
            return BA._lm_tracks(p, GEN_ITERS, GEN_HUBER, GEN_LAM0, False,
                                 linalg, kernel=False)

        t_call, by = device_ms(torch, k9_call, calls=5, replays=5)
        tr = BG.lm_generic(p, 1, GEN_HUBER, GEN_LAM0, linalg, trace=True)[3]
        Sk, bk = k9_system(torch, p, tr, GEN_LAM0)
        timing[linalg] = dict(
            device_ms=t_call, device_ms_by=by,
            stages_ms=k9_stages(torch, BG, p, GEN_ITERS, GEN_LAM0, linalg),
            library_solve_device_ms=device_ms(
                torch, lambda: library_solve(torch, Sk, bk, linalg),
                calls=5, replays=5)[0],
            library_solve_ms=cuda_ms(
                torch, lambda: library_solve(torch, Sk, bk, linalg), 10),
            ms=cuda_ms(torch, k9_call, 10),
            plain_ms=cuda_ms(torch, plain_call, 3, warmup=1),
            graph_ops=graph_ops(torch, k9_call),
            plain_graph_ops=graph_ops(torch, plain_call))
    # the wide band: the production recipe with a closure pair (band 127,
    # the dense 768x768 factorisation in K9), and the dense case at 512
    # poses (band 511, 3072x3072), each beside the library's solve of the
    # same system
    wide = {}
    for name, (n, m, iters, calls) in {"closure_m128": (GEN_N, GEN_M, 2, 2),
                                       "closure_m512": (4096, 512, 1, 1)
                                       }.items():
        pwd, _ = generic_problem(torch, np, BA, dev, n, m, GEN_K, 2,
                                 "closure")
        for linalg in ("lu", "chol"):
            tr = BG.lm_generic(pwd, 1, GEN_HUBER, GEN_LAM0, linalg,
                               trace=True)[3]
            check(int(tr.band) == m - 1, f"K9 {name}: band {int(tr.band)}")
            Sk, bk = k9_system(torch, pwd, tr, GEN_LAM0)
            wide[f"{name}_{linalg}"] = dict(
                device_ms=device_ms(torch, lambda: BA.ba_solve_tracks(
                    pwd, iters=iters, lam0=GEN_LAM0, linalg=linalg),
                    calls=calls, replays=1)[0], iterations=iters,
                solve_ms=k9_stages(torch, BG, pwd, iters, GEN_LAM0, linalg,
                                   calls=1)["solve"],
                library_solve_device_ms=device_ms(
                    torch, lambda: library_solve(torch, Sk, bk, linalg),
                    calls=2, replays=2)[0])
    print("phase 10: the wide band (band M - 1: K9's dense factorisation), "
          "K9's pose-solve stage against the library's solve of the same "
          "system, device ms: " + "; ".join(
              f"{k} {v['solve_ms']:.4f} against "
              f"{v['library_solve_device_ms']:.4f} (the call "
              f"{v['device_ms']:.4f}, {v['iterations']} iterations)"
              for k, v in wide.items()))
    # test_slam_scale.py:107's M 16 x N 1024 x K 4, and the SLAM window's
    # shape (K = M = 6, N 1024, 3 iterations: a ring problem) down the
    # generic route beside K6
    p16, _ = generic_problem(torch, np, BA, dev, 1024, 16, 4, 3, noise=0.3)
    pw, _ = generic_problem(torch, np, BA, dev, 1024, 6, 6, 4, noise=0.3)
    shapes = {}
    for name, pr, iters, ring in (("m16_n1024_k4", p16, 5, False),
                                  ("window_m6_n1024", pw, 3, False),
                                  ("window_m6_n1024_k6", pw, 3, True)):
        for linalg in ("lu", "chol"):
            def call(pr=pr, iters=iters, ring=ring, linalg=linalg):
                return BA.ba_solve_tracks(pr, iters=iters, lam0=GEN_LAM0,
                                          ring_layout=ring, linalg=linalg)
            t, by = device_ms(torch, call, calls=5, replays=5)
            shapes[f"{name}_{linalg}"] = dict(
                device_ms=t, device_ms_by=by, ms=cuda_ms(torch, call, 10))
    print("phase 10: device / as-called ms a call (the last two on the "
          "window's shape: K9, then K6 on the ring route): " + "; ".join(
              f"{k} {v['device_ms']:.4f} / {v['ms']:.4f}"
              for k, v in shapes.items()))
    band = full["lu"]["band"]
    bounds = {linalg: k9_bound(torch, p, GEN_ITERS, band, linalg)
              for linalg in ("lu", "chol")}
    (bms, bby), bbytes, bops, dops, dms = bounds["lu"]
    print(f"phase 10: per ba_solve_tracks call ({GEN_ITERS} iterations, "
          f"band {band}; {smi}): " + "; ".join(
              f"{k}: {v['device_ms']:.4f} ms on the device "
              f"({v['device_ms_by']}), by stage (K9's clock, median) the "
              f"index {v['stages_ms']['index']:.4f}, an iteration's "
              f"landmarks {v['stages_ms']['landmarks']:.4f}, blocks "
              f"{v['stages_ms']['blocks']:.4f}, pose solve "
              f"{v['stages_ms']['solve']:.4f} (its system "
              f"{v['stages_ms']['solve_system']:.4f}, panels "
              f"{v['stages_ms']['solve_panels']:.4f}, trailing updates "
              f"{v['stages_ms']['solve_trailing']:.4f}, back-substitution "
              f"{v['stages_ms']['solve_backsub']:.4f}; the library's solve of the "
              f"same system {v['library_solve_device_ms']:.4f} on the "
              f"device, {v['library_solve_ms']:.4f} as called), step "
              f"{v['stages_ms']['step']:.4f}; {v['ms']:.4f} as called "
              f"({v['ms'] / v['device_ms']:.3f}x the device), plain "
              f"{v['plain_ms']:.3f}; device operations {v['graph_ops']} "
              f"against the plain route's {v['plain_graph_ops']}; bound "
              f"{bounds[k][0][0]:.5f} ms ({bounds[k][0][1]}, "
              f"{bounds[k][2]:.4g} operations; with the dense "
              f"factorisation's {bounds[k][3]:.4g}: {bounds[k][4]:.5f} ms)"
              for k, v in timing.items()))

    # the flat ba_solve on the card against the CPU (tests/test_slam.py:51)
    rng = np.random.RandomState(0)
    xis = np.zeros((4, 6), np.float32)
    xis[:, 3] = -0.3 * np.arange(4)
    xis[:, :3] = rng.randn(4, 3) * 0.02
    fp = se3_exp(torch.from_numpy(xis))
    fl = torch.from_numpy((rng.rand(60, 3) * [2.0, 1.5, 1.0]
                           + [-1.0, -0.75, 3.0]).astype(np.float32))
    op = torch.arange(4, dtype=torch.int32).repeat_interleave(60)
    ol = torch.arange(60, dtype=torch.int32).repeat(4)
    fi = torch.tensor(GEN_INTR)
    rng = np.random.RandomState(1)
    dpose = torch.from_numpy(np.concatenate(
        [np.zeros((2, 6)), rng.randn(2, 6) * 0.02]).astype(np.float32))
    flat = BA.BAProblem(
        poses=se3_exp(dpose) @ fp, landmarks=fl + torch.from_numpy(
            (rng.randn(60, 3) * 0.05).astype(np.float32)),
        obs_pose=op, obs_lm=ol, obs_uv=BA.project(fp[op.long()],
                                                  fl[ol.long()], fi),
        obs_valid=torch.ones(240, dtype=torch.bool), intrinsics=fi,
        fixed_poses=torch.tensor([True, True, False, False]))
    fc, fcc = BA.ba_solve(flat, iters=12)
    fg, fgc = BA.ba_solve(BA.BAProblem(*(t.to(dev) for t in flat)),
                          iters=12)
    flat_err = (float((fg.poses.cpu() - fc.poses).abs().max()),
                float((fg.landmarks.cpu() - fc.landmarks).abs().max()),
                float(((fgc.cpu() - fcc).abs() - 1e-4 * fcc.abs()).max()
                      / fcc[0]))
    check(flat_err[0] <= 1e-4 and flat_err[1] <= 1e-3
          and flat_err[2] <= 1e-6 and float(fgc[-1]) < float(fgc[0]) * 1e-4,
          f"the flat ba_solve on the card is off the CPU's: {flat_err}")
    # and at full width, from the tracks problem, beside K9
    n, k = p.obs_valid.shape
    big = BA.BAProblem(
        poses=p.poses, landmarks=p.landmarks, obs_pose=p.obs_pose.reshape(-1),
        obs_lm=torch.arange(n, dtype=torch.int32, device=dev
                            ).repeat_interleave(k),
        obs_uv=p.obs_uv.reshape(-1, 2), obs_valid=p.obs_valid.reshape(-1),
        intrinsics=p.intrinsics, fixed_poses=p.fixed_poses)
    _, big_c = BA.ba_solve(big, iters=GEN_ITERS, lam0=GEN_LAM0)
    flat_ms = cuda_ms(torch, lambda: BA.ba_solve(
        big, iters=GEN_ITERS, lam0=GEN_LAM0), 2, warmup=1)
    print(f"phase 10: flat ba_solve on the card within {flat_err} (poses, "
          f"landmarks, costs over 1e-4 relative) of the CPU; at N {GEN_N}, "
          f"M {GEN_M}: {flat_ms:.2f} ms a call as called, costs "
          f"{big_c.cpu().tolist()}")

    # the geometry on the card against the CPU
    # (tests/test_geometry_matcher.py:18,29,44)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    P1 = torch.from_numpy(K @ np.hstack([np.eye(3), np.zeros((3, 1))]))
    P2 = torch.from_numpy(K @ np.hstack([np.eye(3), -np.array(
        [[0.5], [0.2], [1.0]])]))
    rng = np.random.RandomState(0)
    Xg = rng.rand(32, 3) * [2, 2, 2] + [-1, -1, 4]
    hom = np.hstack([Xg, np.ones((32, 1))])
    x1 = hom @ P1.numpy().T
    x1 = torch.from_numpy(x1[:, :2] / x1[:, 2:3])
    x2 = hom @ P2.numpy().T
    x2 = torch.from_numpy(x2[:, :2] / x2[:, 2:3])
    g = {}
    for where in ("cpu", "card"):
        at = "cpu" if where == "cpu" else dev
        a = [t.to(at) for t in (P1, P2, x1, x2)]
        Xt = GEO.triangulate(*a)
        F = GEO.fundamental_from_projections(a[0], a[1])
        Fc = g["cpu"]["F"].to(at) if where == "card" else F
        g[where] = dict(X=Xt, err=GEO.reprojection_error(a[0], Xt, a[2]),
                        F=F, el=GEO.epipole_left(Fc),
                        er=GEO.epipole_right(Fc),
                        line=GEO.epipolar_line(Fc, a[2]))
    geo_err = {}
    for key, v in g["card"].items():
        w = g["cpu"][key]
        v = v.cpu()
        if key == "F":
            v = v if (v - w).abs().max() <= (v + w).abs().max() else -v
        # relative to the largest magnitude; the round trip's reprojection
        # errors (float32 noise, ~1e-4 px) in px
        geo_err[key] = float((v - w).abs().max() / (1.0 if key == "err" else
                                                    max(float(w.abs().max()),
                                                        1e-30)))
    check(max(geo_err.values()) <= 1e-3
          and max(v for k, v in geo_err.items() if k != "err") <= 1e-4
          and float((g["card"]["X"].cpu() - torch.from_numpy(Xg)).abs().max())
          < 1e-2,
          f"the geometry on the card is off the CPU's: {geo_err}")
    print(f"phase 10: geometry on the card against the CPU, relative to "
          f"the largest magnitude (F up to sign; reprojection errors in "
          f"px): {geo_err}; {time.perf_counter() - t0:.1f} s in all")

    lu = timing["lu"]
    results["ba_generic"] = dict(
        name="ba_generic", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/ba_generic.cu",
        replaces="vpp_tpu/slam/ba.py:512",
        per=f"ba_solve_tracks call, generic layout, N {GEN_N}, M {GEN_M}, "
            f"K {GEN_K}, {GEN_ITERS} iterations, linalg lu (the pose solve "
            "included)",
        max_abs_err=max(v["step_pose_err"] for v in full.values()),
        ms=lu["ms"], plain_ms=lu["plain_ms"], bound_ms=bms, bound_by=bby,
        bound_bytes=bbytes, bound_operations=bops,
        library="the pose-solve stage alone: torch.linalg.solve_ex of the "
                "(6M, 6M) system K9 solved, one solve",
        library_ms=lu["library_solve_ms"],
        library_device_ms=lu["library_solve_device_ms"],
        device_ms=lu["device_ms"], device_ms_by=lu["device_ms_by"],
        stages_ms=lu["stages_ms"], band=band,
        bound_operations_dense_factorisation=dops,
        bound_ms_dense_factorisation=dms,
        graph_ops=lu["graph_ops"], plain_graph_ops=lu["plain_graph_ops"],
        chol=timing["chol"], full_width=full, ring_vs_k6=ring_err,
        other_shapes=shapes, wide_band=wide, ring20=ring20,
        solve_backward_errors=berrs, closure_512_chol_holds=hold,
        closure_512_chol_draws=draws, lm_pose_errs=small,
        launches_per_call=counts["ba_generic"])
    return dict(counts=counts, flat_ms=flat_ms, flat_err=flat_err,
                geometry_err=geo_err)


def device_ops(torch, fn):
    """``graph_ops`` of one call of ``fn``, or, where CUDA-graph capture is
    refused, the profiler's count of the call's device kernels. Returns
    (ops by kind, method)."""
    try:
        return graph_ops(torch, fn), "cuda_graph"
    except RuntimeError as exc:
        print(f"chip_smoke: graph capture refused ({exc}); counting the "
              "profiler's device kernels")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU)
    return {"kernel": n}, "profiler"


def on_cpu(state):
    """A copy of a dataclass state with its tensors on the CPU."""
    return dataclasses.replace(state, **{
        k: v.cpu() for k, v in vars(state).items() if hasattr(v, "cpu")})


def greedy_gaps(torch, acc, m: int, ext: int, exr: int):
    """For ``hough_peaks``' m greedy steps on ``acc`` (CPU): each step's
    gap between the chosen cell and the largest other cell left, the
    margin by which another accumulator could change that choice."""
    t_theta, rho_bins = acc.shape
    tt = torch.arange(t_theta)[:, None]
    rr = torch.arange(rho_bins)[None, :]
    a = acc.clone().double()
    gaps = []
    for _ in range(m):
        top2 = torch.topk(a.reshape(-1), 2).values
        gaps.append(float(top2[0] - top2[1]))
        flat = int(torch.argmax(a))
        pt, pr = flat // rho_bins, flat % rho_bins
        dt = (tt - pt).abs()
        dt = torch.minimum(dt, t_theta - dt)
        a = torch.where((dt <= ext) & ((rr - pr).abs() <= exr),
                        torch.full_like(a, -1e30), a)
    return gaps


def leading_agree(gaps, tol: float, same) -> int:
    """How many leading picks must agree (each earlier pick's gap above
    ``tol``), checked against ``same`` (per pick, bool)."""
    n = 0
    for g, s in zip(gaps, same):
        if g <= tol:
            break
        check(s, f"a pick with gap {g:.4g} > {tol:.4g} differs")
        n += 1
    return n


def phase_hough_lines(torch, np, dev, results, smi):
    """Phase 11: the Hough line path at full width, card against the plain
    CPU path. (a) the Kalman tracker on phase 5's clip; (b) one-shot
    detection at 1920x1080; (c) the painter on (a)'s final state; (d) the
    epipolar flow branch at 640x480. Returns the numbers it prints."""
    from vpp_tpu_torch.algorithms import flow as FL
    from vpp_tpu_torch.algorithms import hough as HG
    from vpp_tpu_torch.algorithms import hough_cuda as HC
    from vpp_tpu_torch.algorithms import hough_tracker as HT
    from vpp_tpu_torch.algorithms import ukf as UK
    from vpp_tpu_torch.algorithms.geometry import fundamental_from_projections
    from vpp_tpu_torch.algorithms.hough_tracker import (
        HoughTrackerConfig, hough_tracker_init, hough_tracker_update)
    from vpp_tpu_torch.algorithms.pyramid import level_shapes, pyramid
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.draw import hough_paint as HP
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip
    out = {"card": smi}

    # -- 11a. the Kalman tracker ----------------------------------------------
    kcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0,
                              with_kalman_filter=True)
    pcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    lines = synthetic_line_clip(W, H, HOUGH_FRAMES)
    lines_dev = torch.from_numpy(lines).to(dev)
    imgs = [from_array(f, border=3, border_mode="mirror") for f in lines_dev]
    cimgs = [from_array(f, border=3, border_mode="mirror") for f in lines]
    sk = hough_tracker_init(kcfg, device=dev)
    sc = hough_tracker_init(kcfg, device="cpu")
    step_dev, drift, drift_rest, picks = 0.0, 0.0, 0.0, []
    for t, (fk, fc) in enumerate(zip(imgs, cimgs)):
        prev = on_cpu(sk)
        sk, pk = hough_tracker_update(sk, fk, kcfg)
        # the CPU steps on the card's accumulator: K7's fixed-point sums and
        # the plain float32 scatter differ in their last bits, which flips
        # near-tied peaks of this clip's rotating line; the peaks of the
        # CPU's own accumulator are held apart, where their gap exceeds that
        acc_k = HG.hough_accumulator(fk, t_theta=kcfg.t_theta).cpu()
        acc_c = HG.hough_accumulator(fc, t_theta=kcfg.t_theta)
        HT.hough_accumulator = lambda *a, **kw: acc_k
        try:
            sc, pc = hough_tracker_update(sc, fc, kcfg)
            s1, _ = hough_tracker_update(prev, fc, kcfg)
        finally:
            HT.hough_accumulator = HG.hough_accumulator
        own = HG.hough_peaks(acc_c, 8, exclusion_theta=5, exclusion_rho=10,
                             acc_threshold=10.0)
        tol = 2 * float((acc_k - acc_c).abs().max()) + 1e-6
        picks.append(leading_agree(
            greedy_gaps(torch, acc_c, 8, 5, 10), tol,
            [int(pk.theta_idx[i]) == int(own.theta_idx[i])
             and int(pk.rho_idx[i]) == int(own.rho_idx[i])
             for i in range(8)]))
        check(all(torch.equal(getattr(pk, f).cpu(), getattr(pc, f))
                  for f in ("theta_idx", "rho_idx", "valid")),
              f"Kalman tracker: the card's peaks differ from the CPU's on "
              f"the same accumulator at frame {t}")
        for other in (sc, s1):
            check(torch.equal(sk.age.cpu(), other.age)
                  and torch.equal(sk.fwu.cpu(), other.fwu),
                  f"Kalman tracker: ages or matches differ from the CPU at "
                  f"frame {t}")
        live = sk.age.cpu() > 0
        for name in ("theta", "rho", "ukf_x"):
            a = getattr(sk, name).cpu()[live]
            for b, free in ((getattr(s1, name)[live], False),
                            (getattr(sc, name)[live], True)):
                # the reference's filter goes NaN where its covariance is
                # not positive definite; the card must have the same NaNs
                check(free or torch.equal(a.isnan(), b.isnan()),
                      f"Kalman tracker: {name} NaN where the CPU's is not, "
                      f"frame {t}")
                d = (a - b).nan_to_num(0.0).abs()
                if not d.numel():
                    continue
                if not free:
                    step_dev = max(step_dev, float(d.max()))
                elif name == "ukf_x":
                    drift = max(drift, float(d[:, :2].max()))
                    drift_rest = max(drift_rest, float(d[:, 2:].max()))
                else:
                    drift = max(drift, float(d.max()))
    n_live = int((sk.age > 0).sum())
    print(f"phase 11: Kalman tracker {W}x{H}, {HOUGH_FRAMES} frames on the "
          "card and the CPU (the CPU fed the card's accumulator): ages and "
          "matches equal every frame; each step from the card's state "
          f"within {step_dev:.3g} (theta, rho, ukf_x of live slots); the "
          f"free runs apart by {drift:.3g} bins in theta, rho, ukf_x[:2] "
          f"and {drift_rest:.3g} in v, yaw, yaw rate (coasting on a filter "
          f"that is chaotic in the reference); the CPU's own accumulator "
          f"gives the card's leading picks {picks}; {n_live} live tracks")
    check(n_live >= 2, "Kalman tracker: fewer than 2 live tracks")
    check(step_dev <= 1e-2, f"Kalman tracker step off the CPU by {step_dev}")

    st = hough_tracker_init(kcfg, device=dev)
    hough_tracker_update(st, imgs[0], kcfg)                  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for f in imgs:
        st, _ = hough_tracker_update(st, f, kcfg)
    torch.cuda.synchronize()
    kal_ms = (time.perf_counter() - t0) * 1e3 / HOUGH_FRAMES
    kal_counts = launch_counts()
    others = {k: v for k, v in kal_counts.items()
              if k != "hough_acc" and v}
    check(kal_counts["hough_acc"] == HOUGH_FRAMES and not others,
          f"Kalman tracker launches {kal_counts}, not one K7 a frame")
    torch.cuda.set_sync_debug_mode("error")
    try:
        hough_tracker_update(st, imgs[-1], kcfg)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    on_ops, on_by = device_ops(
        torch, lambda: hough_tracker_update(st, imgs[-1], kcfg))
    off_ops, off_by = device_ops(
        torch, lambda: hough_tracker_update(st, imgs[-1], pcfg))
    z, rm = torch.stack([st.rho, st.theta], -1), torch.eye(2, device=dev)
    ukf_ops, _ = device_ops(torch, lambda: UK.ukf_update(
        *UK.ukf_predict(UK.UKFState(st.ukf_x, st.ukf_P), 1.0), z,
        UK.rho_theta_measurement, rm))
    out["kalman"] = dict(ms_per_frame=kal_ms, launches=kal_counts,
                         device_ops_on=on_ops, device_ops_off=off_ops,
                         device_ops_by=(on_by, off_by),
                         ukf_bank_ops=ukf_ops, live=n_live,
                         step_max_dev=step_dev, free_run_drift=drift,
                         free_run_drift_unobservable=drift_rest,
                         leading_picks_equal=picks)
    print(f"phase 11: Kalman tracker {kal_ms:.3f} ms/frame over "
          f"{HOUGH_FRAMES} frames, K7 {kal_counts['hough_acc']} launches "
          f"(one a frame, nothing else), one step with no host read; device "
          f"operations a step: filter on {on_ops}, off {off_ops} ({on_by}); "
          f"the UKF bank's predict and update alone {ukf_ops}")

    # -- 11b. one-shot detection at 1920x1080 ---------------------------------
    bw, bh = HOUGH_BIG
    big = synthetic_line_clip(bw, bh, 1)[0]
    bimg = from_array(torch.from_numpy(big).to(dev), border=3,
                      border_mode="mirror")
    cimg = from_array(big, border=3, border_mode="mirror")

    def detect(img):
        acc = HG.hough_accumulator(img)
        th, n = HG.hough_adaptive_threshold(acc)
        return HG.hough_peaks_clustered(acc, 16, threshold=th), th, n, acc

    peaks, theta, rho, acc = HG.hough_lines(bimg, 10)
    calls = {
        "hough_lines": lambda: HG.hough_lines(bimg, 10),
        "adaptive_clustered": lambda: detect(bimg),
        "sparse_revote": lambda: HG.hough_sparse_revote(bimg, theta, rho,
                                                        peaks.valid),
        "accumulator_mxu": lambda: HG.hough_accumulator_mxu(bimg)}
    timing = {}
    for key, fn in calls.items():
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        check(launch_counts()["hough_acc"] == 1,
              f"{key} at {bw}x{bh} launched K7 "
              f"{launch_counts()['hough_acc']} times, not once")
        d_ms, d_by = device_ms(torch, fn, calls=5, replays=10)
        timing[key] = dict(device_ms=d_ms, device_ms_by=d_by,
                           ms=cuda_ms(torch, fn, 20))
    cacc = HG.hough_accumulator(cimg)
    acc_cpu = acc.cpu()
    acc_dev = float((acc_cpu - cacc).abs().max())
    tol = 2 * acc_dev + 1e-6
    # the peak picks on the card's own accumulator: bit-equal on the CPU
    p_same = HG.hough_peaks(acc_cpu, 10)
    check(all(torch.equal(getattr(peaks, f).cpu(), getattr(p_same, f))
              for f in peaks._fields),
          "hough_lines: the card's peaks differ from the CPU's on the same "
          "accumulator")
    p_cpu, t_cpu, r_cpu, _ = HG.hough_lines(cimg, 10)
    same = [(int(peaks.theta_idx[i]), int(peaks.rho_idx[i]))
            == (int(p_cpu.theta_idx[i]), int(p_cpu.rho_idx[i]))
            and float(theta[i]) == float(t_cpu[i])
            and float(rho[i]) == float(r_cpu[i]) for i in range(10)]
    gaps = greedy_gaps(torch, cacc, 10, 5, 10)
    n_lines = leading_agree(gaps, tol, same)
    th, n = HG.hough_adaptive_threshold(acc)
    clus = HG.hough_peaks_clustered(acc, 16, threshold=th)
    th_c, n_c = HG.hough_adaptive_threshold(acc_cpu)
    check(float(th) == float(th_c) and int(n) == int(n_c),
          "adaptive threshold differs from the CPU on the same accumulator")
    c_same = HG.hough_peaks_clustered(acc_cpu, 16, threshold=th_c)
    check(all(torch.equal(getattr(clus, f).cpu(), getattr(c_same, f))
              for f in clus._fields),
          "clustered peaks differ from the CPU on the same accumulator")
    c_cpu = HG.hough_peaks_clustered(cacc, 16, threshold=th_c)
    cv = c_cpu.votes.double()
    c_gaps = (cv[:-1] - cv[1:]).tolist() + [float(cv[-1])]
    n_clus = leading_agree(c_gaps, tol, [
        int(clus.theta_idx[i]) == int(c_cpu.theta_idx[i])
        and int(clus.rho_idx[i]) == int(c_cpu.rho_idx[i])
        for i in range(16)])
    near = HG._near_lines(bimg.shape, theta, rho, peaks.valid, 4.0)
    rev = HG.hough_sparse_revote(bimg, theta, rho, peaks.valid)
    check(same_bits(torch, rev, HG.hough_accumulator(
        bimg, vote_weight="magnitude", pixel_mask=near)),
          "sparse revote differs from K7 on the same mask")
    near_c = HG._near_lines(cimg.shape, theta.cpu(), rho.cpu(),
                            peaks.valid.cpu(), 4.0)
    rev_c = HG.hough_accumulator(cimg, vote_weight="magnitude",
                                 pixel_mask=near.cpu())
    rev_err = float((rev.cpu() - rev_c).abs().max())
    check(rev_err <= 1e-4 * float(rev_c.max()),
          f"sparse revote off the CPU by {rev_err}")
    mxu = HG.hough_accumulator_mxu(bimg)
    check(same_bits(torch, mxu, HG.hough_accumulator(bimg)),
          "hough_accumulator_mxu is not bit-equal to hough_accumulator")
    # K7 alone at 1080p beside its bound
    t0i, r0i, ft, fr, wgt, rb = HG._vote_bins(bimg, 255, None, 40.0,
                                              "binary", None)
    th_n = (t0i.float() + ft).reshape(-1)
    rho_n = (r0i.float() + fr).reshape(-1)
    wv = wgt.reshape(-1).contiguous()
    nbytes, sectors = k7_bound_bytes(torch, th_n, rho_n, wv, 255, rb)
    n_edge = int((wv != 0).sum())
    k7 = results["hough_acc"]
    k7["device_ms_1080p"], k7["device_ms_1080p_by"] = device_ms(
        torch, lambda: HC.hough_acc(th_n, rho_n, wv, 255, rb))
    k7["bound_ms_1080p"], k7["bound_by_1080p"] = bound_ms(nbytes,
                                                          n_edge * 20)
    k7["launches_1080p_call"] = 1
    stage = {
        "local_maxima_mask": device_ops(torch, lambda: HG._local_maxima_mask(
            acc, 15, 12, 50.0))[0],
        "adaptive_threshold": device_ops(
            torch, lambda: HG.hough_adaptive_threshold(acc))[0],
        "peaks_clustered": device_ops(torch, lambda: HG.hough_peaks_clustered(
            acc, 16, threshold=th))[0],
        "hough_peaks_m10": device_ops(torch, lambda: HG.hough_peaks(
            acc, 10))[0]}
    out["detect_1080p"] = dict(
        timing=timing, acc_max_abs_dev=acc_dev, lines_compared=n_lines,
        clustered_compared=n_clus, threshold=float(th), count=int(n),
        revote_err=rev_err, revote_mask_diff=int((near.cpu() != near_c).sum()),
        k7_device_ms=k7["device_ms_1080p"], k7_bound_ms=k7["bound_ms_1080p"],
        k7_bytes=nbytes, k7_sectors=sectors, voting=n_edge,
        stage_ops=stage)
    print(f"phase 11: {bw}x{bh} one-shot detection, one K7 launch a call; "
          "device / as-called ms: " + ", ".join(
              f"{k} {v['device_ms']:.4f} / {v['ms']:.4f}"
              for k, v in timing.items())
          + f"; card accumulator off the CPU's by {acc_dev:.3g} (tol "
          f"{tol:.3g}): hough_lines' first {n_lines} of 10 picks and the "
          f"first {n_clus} of 16 clustered peaks (the gap above tol) equal "
          "the CPU's, all of them on the card's accumulator; threshold "
          f"{float(th):.4g}, count {int(n)}; revote within {rev_err:.3g} "
          f"(band masks differ in {out['detect_1080p']['revote_mask_diff']} "
          "pixels, the CPU fed the card's), mxu bit-equal; K7 alone "
          f"{k7['device_ms_1080p']:.4f} ms on the device against a bound of "
          f"{k7['bound_ms_1080p']:.5f} ms ({nbytes} bytes, {n_edge} voting "
          f"pixels); device operations {stage}")

    # -- 11c. the painter on (a)'s final state --------------------------------
    acc_shape = (kcfg.t_theta, HG.default_rho_bins((H, W)))
    sc_cpu = on_cpu(st)
    paint0 = torch.zeros((H, W, 4), device=dev)
    frame3 = torch.from_numpy(np.repeat(lines[-1][..., None], 3, -1).astype(
        np.uint8)).to(dev)
    paints = {
        "paint_hough_video": (lambda s, d: HP.paint_hough_video(
            paint0.to(d), s, acc_shape)),
        "draw_line_tracks": (lambda s, d: HP.draw_line_tracks(
            frame3.to(d), s, acc_shape))}
    painter = {}
    blank = dataclasses.replace(sc_cpu, age=torch.zeros_like(sc_cpu.age))
    for key, fn in paints.items():
        a = fn(st, dev)
        check(same_bits(torch, a.float(), fn(st, dev).float()),
              f"{key} is not reproducible")
        a = a.cpu().reshape(H * W, -1).double().nan_to_num(-1.0)
        b = fn(sc_cpu, "cpu").reshape(H * W, -1).double().nan_to_num(-1.0)
        z = fn(blank, "cpu").reshape(H * W, -1).double()
        pa, pb = (a != z).any(-1), (b != z).any(-1)
        painted = int((pa | pb).sum())
        moved = int((pa != pb).sum())
        both = pa & pb
        # colours truncate to uint8 after a hue and a division that round
        # otherwise on the card (atan2, x / 60 by its reciprocal): one level
        level = float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
        check(painted > 0 and moved <= 0.01 * painted and level <= 1.0,
              f"{key}: {moved} of {painted} painted pixels painted on one "
              f"side only, values off by up to {level}")
        painter[key] = dict(painted=painted, one_side=moved, max_level=level,
                            exact=int((both & (a == b).all(-1)).sum()),
                            ms=cuda_ms(torch, lambda: fn(st, dev), 20))
    live = st.age > 0
    sp = HP.track_support_points(imgs[-1], st.theta, st.rho, live, k=64)
    sp_c = HP.track_support_points(cimgs[-1], sc_cpu.theta, sc_cpu.rho,
                                   live.cpu(), k=64)
    lc = live.cpu()
    agree = ((sp[0].cpu() == sp_c[0]).all(-1)
             & (sp[1].cpu() == sp_c[1]))[lc]
    sp_frac = float(agree.float().mean())
    check(sp_frac >= 0.99, f"support points agree on {sp_frac:.4f} only")
    painter["track_support_points"] = dict(
        agree=sp_frac, ms=cuda_ms(torch, lambda: HP.track_support_points(
            imgs[-1], st.theta, st.rho, live, k=64), 20),
        device_ops=device_ops(torch, lambda: HP.track_support_points(
            imgs[-1], st.theta, st.rho, live, k=64))[0])
    out["painter"] = painter
    print("phase 11: painter on the final Kalman state against the CPU: "
          + "; ".join(
              f"{k}: {v['painted']} pixels painted, {v['one_side']} on one "
              f"side only, {v['exact']} equal, the rest within "
              f"{v['max_level']:.3g}, {v['ms']:.4f} ms"
              for k, v in painter.items() if "painted" in v)
          + f"; support points (k 64) agree on "
          f"{sp_frac:.4f} of live slots, {painter['track_support_points']['ms']:.4f} "
          f"ms, device operations {painter['track_support_points']['device_ops']}")

    # -- 11d. the epipolar flow branch at 640x480 -----------------------------
    clip = make_clip(W, H, 2, seed=0)
    rng = np.random.RandomState(11)
    pos = np.stack([rng.uniform(8, H - 8, EPI_KEYPOINTS),
                    rng.uniform(8, W - 8, EPI_KEYPOINTS)], -1).astype(
        np.float32)
    Kc = np.array([[640.0, 0, 320], [0, 640, 240], [0, 0, 1]], np.float32)
    P1 = Kc @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = Kc @ np.hstack([np.eye(3), np.array([[0.05], [0.02], [-1.0]])])
    Fm = fundamental_from_projections(torch.from_numpy(P1.astype(np.float32)),
                                      torch.from_numpy(P2.astype(np.float32)))
    epi = {}
    kw = dict(winsize=9, nscales=3, propagation=2, patchsize=5)
    for key, extra in (("epipolar_flow", dict(epipolar_flow=True)),
                       ("epipolar_filter", dict(epipolar_filter=2.0))):
        res = []
        for d in (dev, torch.device("cpu")):
            i1, i2 = (from_array(torch.from_numpy(f).to(d), border=9,
                                 border_mode="mirror") for f in clip)
            args = (torch.from_numpy(pos).to(d),
                    torch.ones(EPI_KEYPOINTS, dtype=torch.bool, device=d),
                    i1, i2)
            fn = (lambda a=args, d=d: FL.semi_dense_optical_flow(
                *a, fundamental_matrix=Fm.to(d), **kw, **extra))
            if d == dev:
                fn()
                torch.cuda.synchronize()
                reset_launch_counts()
                got = fn()
                torch.cuda.synchronize()
                counts = launch_counts()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / 10
                res.append(tuple(x.cpu() for x in got))
            else:
                res.append(fn())
        (mk, dk, ok_k), (mc, dc, ok_c) = res
        agree = float((ok_k == ok_c).float().mean())
        both = ok_k & ok_c & (dc < 1e29)
        close = both & ((dk - dc).abs() <= 1e-4 * dc.abs())
        # K1's near ties: a coarse level that picks the other of two SADs
        # within 1e-5 moves a neighbour cell's warp, and with it the SAD
        # of a cell whose own flow is equal (phase 3 holds K1 per level)
        off = int((both & ~close).sum())
        check(agree >= 0.99, f"{key}: matched agrees on {agree:.4f} only")
        check(off <= 0.01 * max(int(both.sum()), 1),
              f"{key}: distance off the CPU by more than 1e-4 relative at "
              f"{off} of {int(both.sum())} keypoints")
        epi[key] = dict(ms=ms, launches=counts, matched_agree=agree,
                        matched=int(ok_k.sum()), both=int(both.sum()),
                        dist_off=off, same_match=int(
                            (both & (mk == mc).all(-1)).sum()))
    # K4 builds each frame's pyramid; the filter route is K1's two
    # launches a level, the line search launches no kernel
    for key, want in (("epipolar_filter", {"flow_level": 6,
                                           "pyramid_decim": 2}),
                      ("epipolar_flow", {"pyramid_decim": 2})):
        got = {n: c for n, c in epi[key]["launches"].items() if c}
        check(got == want, f"{key} launched {got}, not {want}")
    # the line search's device operations, the epipole given
    i1, i2 = (from_array(torch.from_numpy(f).to(dev), border=9,
                         border_mode="mirror") for f in clip)
    pyr1, pyr2 = pyramid(i1, 3, border=9), pyramid(i2, 3, border=9)
    e0, fs = FL._epipole_and_scales(Fm.to(dev), 3)
    grid = level_shapes((H // 5, W // 5), 3)
    pos_d = torch.from_numpy(pos).to(dev)
    val_d = torch.ones(EPI_KEYPOINTS, dtype=torch.bool, device=dev)
    search_ops = device_ops(torch, lambda: FL._epipolar_levels(
        pos_d, val_d, pyr1, pyr2, e0, fs, winsize=9, nscales=3,
        min_scale=0, patchsize=5, steps=8, grid_shapes=grid))[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            FL.semi_dense_optical_flow(pos_d, val_d, i1, i2,
                                       fundamental_matrix=Fm.to(dev),
                                       epipolar_flow=True, **kw)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reads = sum("synchroniz" in str(w.message) for w in caught)
    epi["epipolar_flow"]["host_reads"] = reads
    epi["epipolar_flow"]["search_device_ops"] = search_ops
    out["epipolar"] = epi
    print(f"phase 11: epipolar flow {W}x{H}, {EPI_KEYPOINTS} keypoints, 3 "
          "scales: " + "; ".join(
              f"{k} {v['ms']:.3f} ms a call as called, launches "
              f"{ {n: c for n, c in v['launches'].items() if c} }, matched "
              f"{v['matched']}, agreeing with the CPU on "
              f"{v['matched_agree']:.4f}; of {v['both']} matched on both, "
              f"{v['same_match']} at the same position, the distance within "
              f"1e-4 relative at all but {v['dist_off']}"
              for k, v in epi.items())
          + f"; the epipolar branch read the host {reads} times a call; its "
          f"line search (3 levels) is {search_ops} device operations")
    return out


SLICE_C_KP = 1024            # micro.py:232-243's pyrLK keypoints
PYRLK_SLOTS = 4096           # phase 12b's FAST slots
DT_SHAPE = (540, 960)        # micro.py:179-186's seed mask (1080p halved)
MATCH_N = 2048               # phase 12f's bruteforce query and train sets
LK_KW = dict(winsize=11, min_ev=1e-4, niterations=21, convergence_delta=0.1)


def lk_chain(torch, pp, pn, pg, kp, level, kw=None):
    """``lucas_kanade``'s coarse-to-fine loop on given pyramids with
    ``level`` as the LK level (``LK_KW``, or ``kw``): (flow, err, [(level
    args, level result)])."""
    tr = torch.zeros_like(kp)
    out = []
    for s in range(len(pp) - 1, -1, -1):
        tr = tr * 2.0
        args = (pp[s], pn[s], pg[s], kp / float(2 ** s), tr)
        res = level(*args, **(LK_KW if kw is None else kw))
        out.append((args, res))
        tr = res[0]
    return tr, res[1], out


def on_cpu_pyramid(PY, Image2d, pyr):
    return PY.Pyramid(levels=tuple(Image2d(data=lvl.data.cpu(),
                                           border=lvl.border)
                                   for lvl in pyr.levels), factor=pyr.factor)


def _sectors(torch, buf, rows, cols, nrows: int, ncols: int, stride: int):
    """The distinct 32-byte sectors of float32 ``buf`` that (N,) blocks of
    ``nrows`` rows of ``ncols`` floats at (rows, cols) touch (row stride
    ``stride`` floats)."""
    r = rows.long()[:, None] + torch.arange(nrows, device=rows.device)
    start = buf.data_ptr() % 32 // 4 + r * stride + cols.long()[:, None]
    s0, s1 = start // 8, (start + ncols - 1) // 8
    ids = s0[..., None] + torch.arange(int((s1 - s0).max()) + 1,
                                       device=rows.device)
    return int(torch.unique(ids[ids <= s1[..., None]]).numel())


def k10_level_bound(torch, args, res, ws: int):
    """K10's least work at one level: bytes are the 32-byte sectors of A,
    the gradient level and B that the template and gradient windows and
    the search windows at the prediction and at the final position touch
    ((ws + 1)² pixels a window), with p, tr, flow and err; operations are
    12 a window sample (two-tap rows and columns), per template sample 7
    more (the three G sums, the mean), per Newton-step sample 5 more (the
    difference, two products and sums) and per final sample 5 (the
    residual sums), over the steps each keypoint took. Returns (bytes,
    operations)."""
    A, B, G, p, tr = args
    flow, _, _, steps = res
    hws, pt = ws // 2, ws + 2
    pad = max(1, min(12, (min(B.data.shape[:2]) - ws - 2) // 2))
    pb = ws + 2 * pad + 2

    def block(img, centre, size, k):
        h, w = img.data.shape[:2]
        c = centre + img.border
        tl = torch.round(c).to(torch.int64) - size // 2
        tl = torch.stack([tl[:, 0].clamp(0, h - size),
                          tl[:, 1].clamp(0, w - size)], -1)
        return tl, c

    def start(c, tl, k):
        i = torch.clamp(torch.floor(c - tl.float() - hws), 0, k - 2)
        return tl + i.long()

    atl, ac = block(A, p, pt, 3)
    a0 = start(ac, atl, 3)
    gtl, gcen = block(G, p, pt, 3)
    g0 = start(gcen, gtl, 3)
    v0 = p + tr
    btl, bc = block(B, v0, pb, pb - ws + 1)
    nb = 0
    for v in (v0, p + flow):
        b0 = start(v + B.border, btl, pb - ws + 1)
        nb += _sectors(torch, B.data, b0[:, 0], b0[:, 1], ws + 1, ws + 1,
                       B.data.shape[1])
    na = _sectors(torch, A.data, a0[:, 0], a0[:, 1], ws + 1, ws + 1,
                  A.data.shape[1])
    ng = _sectors(torch, G.data, g0[:, 0], 2 * g0[:, 1], ws + 1,
                  2 * (ws + 1), 2 * G.data.shape[1])
    n, nw = p.shape[0], ws * ws
    nbytes = 32 * (na + nb + ng) + n * (8 + 8 + 8 + 4)
    ops = nw * (n * (3 * 12 + 7) + int(steps.sum()) * 17 + n * 17)
    return nbytes, ops


def k10_split(torch, np, dev):
    """K10's device ms at one pyramid level (``lk_level``, no windows
    output), the finest and the coarsest, by keypoint count (32, 1024,
    8192) and Newton-step cap (0, 1, 21), on phase 12a's frames and
    pyramids: the launch, set-up, per-step and occupancy costs apart.
    Returns {"level L": {"n N": {"iters I": ms, "steps": mean steps}}}."""
    import importlib
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.utils.clips import make_clip
    LK = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    i1, i2 = [from_array(torch.from_numpy(f).to(dev), border=9,
                         border_mode="mirror") for f in make_clip(W, H, 2,
                                                                  seed=0)]
    pp, pn = PY.pyramid(i1, 3, border=5), PY.pyramid(i2, 3, border=5)
    pg = LK.gradient_pyramid(pp)
    out = {}
    for s in (0, 2):
        row = {}
        for n in (32, 1024, 8192):
            rng = np.random.RandomState(n)
            kp = torch.from_numpy((rng.rand(n, 2) * [H - 20, W - 20] + 10)
                                  .astype(np.float32)).to(dev) / float(2 ** s)
            tr = torch.zeros_like(kp)
            cell = {}
            for it in (0, 1, 21):
                kw = dict(LK_KW, niterations=it)
                cell[f"iters {it}"] = device_ms(
                    torch, lambda kw=kw: LK.lk_level(pp[s], pn[s], pg[s], kp,
                                                     tr, **kw),
                    calls=10, replays=10)[0]
            steps = LK.lk_level(pp[s], pn[s], pg[s], kp, tr, windows=True,
                                **LK_KW)[3]
            cell["steps"] = float(steps.float().mean())
            row[f"n {n}"] = cell
        out[f"level {s}"] = row
    return out


def phase_slice_c(torch, np, dev, results, smi):
    """Phase 12: pyramidal LK and sparse flow (K10), the distance
    transforms (K11), Scharr and LBP, the matchers and the line-based
    pose, at full width on the card against the plain CPU path. Returns
    the numbers it prints."""
    import importlib
    from vpp_tpu_torch.algorithms import distance_transform as DT
    from vpp_tpu_torch.algorithms import lbp as LB
    from vpp_tpu_torch.algorithms import lk as LK
    from vpp_tpu_torch.algorithms import matcher as MT
    from vpp_tpu_torch.algorithms import sparse_flow as SF
    from vpp_tpu_torch.algorithms.fast import fast9
    from vpp_tpu_torch.core.image import Image2d, from_array
    from vpp_tpu_torch.core.keypoints import keypoints_from_positions
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.slam import se3 as SE
    from vpp_tpu_torch.slam import sfm as SFM
    from vpp_tpu_torch.utils.clips import make_clip
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    SC = importlib.import_module("vpp_tpu_torch.algorithms.scharr")
    cpu = torch.device("cpu")
    out = {}

    def fired():
        return {k: v for k, v in launch_counts().items() if v}

    # -- 12a. lucas_kanade at micro.py:232-243's workload ---------------------
    clip = make_clip(W, H, 2, seed=0)
    fr = {d: [from_array(torch.from_numpy(f).to(d), border=9,
                         border_mode="mirror") for f in clip]
          for d in (dev, cpu)}
    i1, i2 = fr[dev]
    rng = np.random.RandomState(0)
    kp_c = torch.from_numpy((rng.rand(SLICE_C_KP, 2) * [H - 20, W - 20]
                             + 10).astype(np.float32))
    kp = kp_c.to(dev)

    def call():
        return LK.lucas_kanade(i1, i2, kp, winsize=11, nscales=3)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    flow, dist = call()
    torch.cuda.synchronize()
    counts = fired()
    check(counts == {"lk_level": 1, "pyramid_decim": 2},
          f"lucas_kanade launched {counts}, not 1 K10 and 2 K4")
    pp, pn = PY.pyramid(i1, 3, border=5), PY.pyramid(i2, 3, border=5)
    pg = LK.gradient_pyramid(pp)
    kf, ke, klev = lk_chain(torch, pp, pn, pg, kp, lambda *a, **kw:
                            LK.lk_level(*a, windows=True, **kw))
    check(same_bits(torch, kf, flow) and same_bits(torch, ke, dist),
          "lucas_kanade differs from its own level chain")
    # the call's one launch, every level's results, against the plain loop
    k10_levels = [(pp[s], pn[s], pg[s]) for s in (2, 1, 0)]
    k10_kw = dict(LK_KW, adopt="always", factor=2.0)
    kall = LK.lk_levels(k10_levels, [2, 1, 0], kp, torch.zeros_like(kp),
                        windows=True, **k10_kw)
    pall = LK.lk_levels_plain(k10_levels, [2, 1, 0], kp,
                              torch.zeros_like(kp), windows=True, **k10_kw)
    check(all(same_bits(torch, g, x) if g.dtype == torch.float32
              else torch.equal(g, x) for g, x in zip(kall, pall)),
          "K10's one launch differs from the plain level loop (flow, err, "
          "windows or steps at some level)")
    check(same_bits(torch, kall[0], flow) and same_bits(torch, kall[1], dist),
          "K10's one launch differs from lucas_kanade")
    # K10 against its plain version on the card, level by level
    lev_rows, k10_bytes, k10_ops, k10_err = [], 0, 0, 0.0
    for (args, kr), s in zip(klev, (2, 1, 0)):
        pr = LK.lk_match_batch_plain(*args, windows=True, **LK_KW)
        d = (kr[0] - pr[0]).abs().amax(1)
        k10_err = max(k10_err, float(d.max()))
        kbig, pbig = kr[1] >= 1e38, pr[1] >= 1e38
        fin = ~kbig & ~pbig
        rel = ((kr[1] - pr[1]).abs() / pr[1].abs().clamp(min=1e-30))[fin]
        flips = int((kbig != pbig).sum())
        row = dict(level=s, keypoints=int(kp.shape[0]),
                   bit_equal_flow=int((kr[0] == pr[0]).all(1).sum()),
                   bit_equal_err=int((kr[1].view(torch.int32)
                                      == pr[1].view(torch.int32)).sum()),
                   flow_within_1e4=float((d <= 1e-4).float().mean()),
                   err_within_1e4=float((rel <= 1e-4).float().mean())
                   if bool(fin.any()) else 1.0,
                   kill_flips=flips, killed=int(kbig.sum()),
                   steps=int(kr[3].sum()),
                   steps_equal=bool(torch.equal(kr[3], pr[3])))
        check(same_bits(torch, kr[2][:, :3], pr[2][:, :3]),
              f"K10's template or gradient windows differ at level {s}")
        same_v = (kr[0] == pr[0]).all(1)
        check(same_bits(torch, kr[2][same_v, 3], pr[2][same_v, 3]),
              f"K10's search windows differ at level {s}")
        if flips:
            print(f"phase 12: level {s}: kill decision differs at "
                  f"{flips} keypoints: err {kr[1][kbig != pbig].tolist()} "
                  f"against {pr[1][kbig != pbig].tolist()}")
        check(row["flow_within_1e4"] >= 0.99 and row["err_within_1e4"]
              >= 0.99 and flips <= 0.005 * kp.shape[0],
              f"K10 against its plain version at level {s}: {row}")
        lev_rows.append(row)
        nb, no = k10_level_bound(torch, args, kr, 11)
        k10_bytes += nb
        k10_ops += no
    # the call against the plain CPU path on the card's pyramids (K4 and
    # the plain chain differ in float32 ulps, which the coarsest level's
    # wandering iteration amplifies), and on its own pyramids (printed)
    cpp = on_cpu_pyramid(PY, Image2d, pp)
    cpn = on_cpu_pyramid(PY, Image2d, pn)
    cpg = LK.gradient_pyramid(cpp)
    for a, b in zip(pg.levels, cpg.levels):
        check(same_bits(torch, a.data.cpu(), b.data),
              "the gradient pyramid differs between card and CPU")
    cf, ce, _ = lk_chain(torch, cpp, cpn, cpg, kp_c, LK.lk_match_batch)
    fc, dc = flow.cpu(), dist.cpu()
    keep = (dc < 1e30) & (ce < 1e30)
    dd = (fc - cf).abs().amax(1)
    lk_cpu = dict(both_keep=int(keep.sum()),
                  within_1e2=float((dd[keep] <= 1e-2).float().mean()),
                  bit_equal=int(((fc == cf).all(1) & (dc == ce)).sum()),
                  keep_differs=int(((dc < 1e30) != (ce < 1e30)).sum()))
    check(lk_cpu["within_1e2"] >= 0.99,
          f"lucas_kanade against the CPU on the card's pyramids: {lk_cpu}")
    ff, fe = LK.lucas_kanade(*fr[cpu], kp_c, winsize=11, nscales=3)
    keep_f = (dc < 1e30) & (fe < 1e30)
    lk_cpu["free_run_within_1e2"] = float(
        ((fc - ff).abs().amax(1)[keep_f] <= 1e-2).float().mean())
    lk_cpu["k4_max_rel"] = max(
        float(((a.data.cpu() - b.data).abs()
               / b.data.abs().clamp(min=1e-30)).max())
        for a, b in zip(pp.levels, PY.pyramid(fr[cpu][0], 3,
                                              border=5).levels))
    # times: the call, K10's one launch, the plain levels on the card
    k10_args = [a for a, _ in klev]
    tr_zero = torch.zeros_like(kp)

    def k10_call():
        LK.lk_levels(k10_levels, [2, 1, 0], kp, tr_zero, **k10_kw)

    def plain_call():
        for a in k10_args:
            LK.lk_match_batch_plain(*a, **LK_KW)

    lk_t = dict(call_ms=cuda_ms(torch, call, 20),
                call_device_ms=device_ms(torch, call)[0],
                call_device_ops=device_ops(torch, call)[0],
                gradient_pyramid_device_ops=device_ops(
                    torch, lambda: LK.gradient_pyramid(pp))[0],
                k10_ms=cuda_ms(torch, k10_call, 50),
                plain_ms=cuda_ms(torch, plain_call, 3),
                plain_device_ops=device_ops(torch, plain_call)[0])
    lk_t["k10_device_ms"], lk_t["device_ms_by"] = device_ms(torch, k10_call)
    lk_t["k10_level_device_ms"] = [
        device_ms(torch, lambda a=a: LK.lk_level(*a, **LK_KW))[0]
        for a in k10_args]
    split = k10_split(torch, np, dev)
    out["lucas_kanade"] = dict(launches=counts, levels=lev_rows,
                               cpu=lk_cpu, k10_split=split, **lk_t)
    b_ms, b_by = bound_ms(k10_bytes, k10_ops)
    results["lk_level"] = dict(
        name="lk_level", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/lk_level.cu",
        replaces="vpp_tpu/algorithms/lk.py:102",
        per=f"the one launch (levels 2, 1, 0) of one lucas_kanade call, "
            f"{SLICE_C_KP} keypoints at {W}x{H}, winsize 11, 21 iterations",
        max_abs_err=k10_err,
        ms=lk_t["k10_ms"], device_ms=lk_t["k10_device_ms"],
        device_ms_by=lk_t["device_ms_by"],
        level_device_ms=lk_t["k10_level_device_ms"],
        plain_ms=lk_t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        bound_bytes=k10_bytes, bound_ops=k10_ops, library_ms=None,
        plain_device_ops=lk_t["plain_device_ops"])
    print(f"phase 12: lucas_kanade {W}x{H}, {SLICE_C_KP} keypoints, winsize "
          f"11, 3 scales: launches {counts}; K10 against its plain version "
          "on the card: " + "; ".join(
              f"level {r['level']} flow bit-equal at {r['bit_equal_flow']}, "
              f"err at {r['bit_equal_err']}, steps equal "
              f"{r['steps_equal']} ({r['steps']}), {r['killed']} killed, "
              f"{r['kill_flips']} kill flips" for r in lev_rows)
          + f", every window sample bit-equal; the call against the plain "
          f"CPU path on the card's pyramids: {lk_cpu['bit_equal']} of "
          f"{SLICE_C_KP} bit-equal, {lk_cpu['within_1e2']:.4f} of "
          f"{lk_cpu['both_keep']} kept on both within 1e-2 px, keep "
          f"differs at {lk_cpu['keep_differs']}; on the CPU's own pyramids "
          f"(K4 within {lk_cpu['k4_max_rel']:.3g} relative of the plain "
          f"chain) {lk_cpu['free_run_within_1e2']:.4f} within 1e-2 px; "
          f"{lk_t['call_device_ms']:.4f} ms a call on the device, "
          f"{lk_t['call_ms']:.4f} as called, {lk_t['call_device_ops']} "
          f"device operations (the 2-channel gradient pyramid "
          f"{lk_t['gradient_pyramid_device_ops']}); K10 {lk_t['k10_device_ms']:.4f} ms on the "
          f"device for its one launch (the design of one launch a level, "
          f"recorded in PERF.md: 0.0841 for three launches), "
          f"{lk_t['k10_ms']:.4f} as called, "
          f"asked for one level at a time "
          + ", ".join(f"{x:.4f}" for x in lk_t["k10_level_device_ms"])
          + f"; bound {b_ms:.5f} ({b_by}: "
          f"{k10_bytes} bytes, {k10_ops} operations); the plain levels "
          f"{lk_t['plain_ms']:.2f} ms on the card in "
          f"{lk_t['plain_device_ops']} device operations")
    print("phase 12: K10's split, device ms of one level (lk_level, no "
          "windows) by keypoints and Newton-step cap, with the mean steps "
          "taken: " + "; ".join(
              f"{lv}, {nk}: " + ", ".join(
                  f"{k} {v:.4f}" if k != "steps" else f"steps {v:.2f}"
                  for k, v in cell.items())
              for lv, row in split.items() for nk, cell in row.items()))

    # -- 12b. pyrlk_match on FAST slots with the tracker's pyramids ------------
    pos, _, valid = fast9(i1, 10, k=PYRLK_SLOTS)
    kps = keypoints_from_positions(pos, valid)
    tp, tn = PY.pyramid(i1, 3, border=9), PY.pyramid(i2, 3, border=9)
    tg = LK.gradient_pyramid(tp)
    reset_launch_counts()
    moved = LK.pyrlk_match(tp, tg, tn, kps)
    torch.cuda.synchronize()
    pyr_counts = fired()
    check(pyr_counts == {"lk_level": 1},
          f"pyrlk_match launched {pyr_counts}, not 1 K10")
    ctp = on_cpu_pyramid(PY, Image2d, tp)
    cmoved = LK.pyrlk_match(ctp, LK.gradient_pyramid(ctp),
                            on_cpu_pyramid(PY, Image2d, tn),
                            keypoints_from_positions(pos.cpu(), valid.cpu()))
    alive_agree = float((moved.alive.cpu() == cmoved.alive).float().mean())
    both = moved.alive.cpu() & cmoved.alive
    pos_err = float((moved.position.cpu() - cmoved.position)[both].abs()
                    .max()) if bool(both.any()) else 0.0
    check(alive_agree >= 0.99 and pos_err <= 1e-2,
          f"pyrlk_match: alive agrees on {alive_agree}, positions within "
          f"{pos_err}")
    out["pyrlk_match"] = dict(
        slots=PYRLK_SLOTS, live_in=int(valid.sum()),
        alive=int(moved.alive.sum()), alive_agree=alive_agree,
        pos_err=pos_err, launches=pyr_counts,
        ms=cuda_ms(torch, lambda: LK.pyrlk_match(tp, tg, tn, kps), 20),
        device_ms=device_ms(torch, lambda: LK.pyrlk_match(tp, tg, tn,
                                                          kps))[0])
    r = out["pyrlk_match"]
    print(f"phase 12: pyrlk_match on {PYRLK_SLOTS} FAST slots ({r['live_in']}"
          f" live, {r['alive']} alive after), the tracker's pyramids (border "
          f"9, 3 levels): launches {pyr_counts}, alive agrees with the CPU "
          f"on {alive_agree:.4f}, positions within {pos_err:.3g}; "
          f"{r['device_ms']:.4f} ms on the device, {r['ms']:.4f} as called")

    # -- 12c. sparse_optical_flow at its defaults ------------------------------
    SF.sparse_optical_flow(i1, i2)
    torch.cuda.synchronize()
    reset_launch_counts()
    sf = SF.sparse_optical_flow(i1, i2)
    torch.cuda.synchronize()
    sf_counts = fired()
    check(sf_counts == {"fast9": 2, "block_topk": 2, "pyramid_decim": 2,
                        "patches": 2, "lk_level": 1},
          f"sparse_optical_flow launched {sf_counts}")
    real_pyramid = LK.pyramid
    c1, c2 = fr[cpu]

    def card_pyramids(img, nlevels, factor=2.0, border=3):
        if img is c1 or img is c2:
            check(nlevels == 3 and border == 5, "unexpected LK pyramid")
            return cpp if img is c1 else cpn
        return real_pyramid(img, nlevels, factor=factor, border=border)

    LK.pyramid = card_pyramids
    try:
        csf = SF.sparse_optical_flow(c1, c2)
    finally:
        LK.pyramid = real_pyramid
    fsf = SF.sparse_optical_flow(c1, c2)
    v = sf.valid.cpu()
    check(torch.equal(sf.pos1.cpu(), csf.pos1) and torch.equal(v, csf.valid),
          "sparse_optical_flow: pos1 or valid differ from the CPU")
    d2 = (sf.pos2.cpu() - csf.pos2).abs().amax(1)[v]
    d2f = (sf.pos2.cpu() - fsf.pos2).abs().amax(1)[v]
    sf_row = dict(valid=int(v.sum()), launches=sf_counts,
                  within_1e2=float((d2 <= 1e-2).float().mean()),
                  bit_equal=int((d2 == 0).sum()),
                  free_run_within_1e2=float((d2f <= 1e-2).float().mean()),
                  ms=cuda_ms(torch, lambda: SF.sparse_optical_flow(i1, i2),
                             20),
                  device_ms=device_ms(torch, lambda: SF.sparse_optical_flow(
                      i1, i2))[0])
    check(sf_row["within_1e2"] >= 0.99,
          f"sparse_optical_flow pos2 against the CPU: {sf_row}")
    out["sparse_optical_flow"] = sf_row
    print(f"phase 12: sparse_optical_flow {W}x{H} (k 512, block 10, patch "
          f"radius 3, search 30): launches {sf_counts}; pos1 and valid "
          f"bit-equal to the CPU, {sf_row['valid']} valid, pos2 on the "
          f"card's pyramids {sf_row['bit_equal']} bit-equal and "
          f"{sf_row['within_1e2']:.4f} within 1e-2 px (on the CPU's own "
          f"{sf_row['free_run_within_1e2']:.4f}); "
          f"{sf_row['device_ms']:.4f} ms on the device, {sf_row['ms']:.4f} "
          "as called")

    # -- 12d. the distance transforms at 960x540 -------------------------------
    seeds = np.random.RandomState(0).rand(*DT_SHAPE) < 0.001
    m = torch.from_numpy(seeds).to(dev)
    reset_launch_counts()
    ed, ev = DT.euclidean_distance_transform(m)
    torch.cuda.synchronize()
    dt_counts = fired()
    steps = DT._steps(*DT_SHAPE)
    check(dt_counts == {"jfa": 1},
          f"euclidean_distance_transform launched {dt_counts}, not 1 K11")
    pd, pv = DT._jump_flood(m, DT.jfa_pass_plain)
    cd, cv = DT.euclidean_distance_transform(seeds, device="cpu")
    check(torch.equal(ed, pd) and torch.equal(ev, pv),
          "K11's transform differs from its plain version on the card")
    check(torch.equal(ed.cpu(), cd) and torch.equal(ev.cpu(), cv),
          "the Euclidean transform differs between card and CPU")
    h, w = DT_SHAPE
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    none = torch.full((h, w), -(1 << 20), dtype=torch.int32, device=dev)
    br0, bc0 = torch.where(m, rr, none), torch.where(m, cc, none)
    bufs = [torch.empty_like(br0) for _ in range(4)]

    def k11_passes():
        cur = (br0, bc0)
        for i, s in enumerate(steps):
            cur = DT.jfa_pass(cur[0], cur[1], s,
                              tuple(bufs[2 * (i % 2):2 * (i % 2) + 2]))
        return cur

    # K11 asked for one pass at a time, each against the plain pass
    cur = (br0, bc0)
    for s in steps:
        nxt = DT.jfa_pass(*cur, s)
        want = DT.jfa_pass_plain(*cur, s)
        check(torch.equal(nxt[0], want[0]) and torch.equal(nxt[1], want[1]),
              f"K11's pass at stride {s} differs from its plain version")
        cur = nxt
    fin_r = k11_passes()[0]
    check(torch.equal(torch.where(fin_r <= -(1 << 20), 0, fin_r - rr),
                      ev[..., 0]), "K11's passes differ from the transform")

    def k11_call():
        return DT.euclidean_distance_transform(m)

    k11_ms = cuda_ms(torch, k11_call, 50)
    k11_dev, k11_by = device_ms(torch, k11_call)
    k11_pass_dev = device_ms(torch, k11_passes)[0]
    # the transform from the mask: the mask read, the distance and vectors
    # written; 44 operations a pixel a pass (a step's 2 products, sum and
    # compare, 8 steps, and 12 shifts of a displacement: 4 steps shift one
    # coordinate, 4 both)
    k11_bytes = h * w * (1 + 4 + 8)
    k11_ops = len(steps) * h * w * 44
    kb_ms, kb_by = bound_ms(k11_bytes, k11_ops)
    # the bound of the earlier design of one launch a pass (two int32
    # planes read and two written a pass), for the comparison with it
    k11_pass_bound = bound_ms(len(steps) * 16 * h * w, 0)[0]

    def plain_passes():
        return DT._jump_flood(m, DT.jfa_pass_plain)

    edt = dict(launches=dt_counts, seeds=int(seeds.sum()), ms=k11_ms,
               device_ms=k11_dev,
               passes_device_ms=k11_pass_dev,
               plain_ms=cuda_ms(torch, plain_passes, 3),
               plain_device_ops=device_ops(torch, plain_passes)[0])
    results["jfa"] = dict(
        name="jfa", route="cuda", source="vpp_tpu_torch/kernels/csrc/jfa.cu",
        replaces="vpp_tpu/algorithms/distance_transform.py:209",
        per=f"the one launch of one euclidean_distance_transform at {w}x{h} "
            f"({len(steps)} passes)",
        max_abs_err=0.0, ms=k11_ms, device_ms=k11_dev, device_ms_by=k11_by,
        plain_ms=edt["plain_ms"], bound_ms=kb_ms, bound_by=kb_by,
        bound_bytes=k11_bytes, bound_ops=k11_ops,
        bound_ms_per_pass_planes=k11_pass_bound, library_ms=None,
        plain_device_ops=edt["plain_device_ops"])
    cham = {}
    for metric, method in (("d3_4", "doubling"), ("d5_7_11", "sweeps")):
        fn = (lambda mm=metric, me=method: DT.chamfer_distance_transform(
            m, mm, me))
        t0 = time.perf_counter()
        g = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        c = DT.chamfer_distance_transform(seeds, metric, method,
                                          device="cpu")
        g = g.cpu()
        reached = c < 1e9
        check(torch.equal(g[reached], c[reached])
              and bool((g[~reached] >= 1e9).all()),
              f"chamfer {metric} {method} differs from the CPU")
        row = dict(bit_equal=bool(torch.equal(g, c)),
                   unreached=int((~reached).sum()), ms=first * 1e3)
        if method == "doubling":
            check(row["bit_equal"], "chamfer doubling is not bit-equal")
            row["device_ms"] = device_ms(torch, fn)[0]
            row["device_ops"] = device_ops(torch, fn)[0]
        cham[f"{metric}_{method}"] = row
    out["distance_transforms"] = dict(euclidean=edt, chamfer=cham)
    print(f"phase 12: distance transforms {w}x{h}, {edt['seeds']} seeds: "
          f"euclidean launches {dt_counts}, distances and R bit-equal to the "
          f"plain version on the card and to the CPU, each pass asked alone "
          f"bit-equal to the plain pass; K11 {edt['device_ms']:.4f} ms a "
          f"call on the device (the design of one launch a pass, recorded in "
          f"PERF.md: 0.4407 for its 11 launches), {edt['ms']:.4f} as called, "
          f"bound {kb_ms:.5f} ({kb_by}; the bound of one launch a pass, two "
          f"int32 planes read and two written a pass: {k11_pass_bound:.5f}); "
          f"the {len(steps)} passes asked one at a "
          f"time {edt['passes_device_ms']:.4f}; the plain passes "
          f"{edt['plain_ms']:.2f} ms in {edt['plain_device_ops']} device "
          "operations; chamfer " + "; ".join(
              f"{k}: bit-equal {r['bit_equal']} ({r['unreached']} unreached "
              f"pixels), {r.get('device_ms', r['ms']):.4f} ms"
              + (f" on the device in {r['device_ops']} device operations"
                 if "device_ms" in r else " (one call, host clock)")
              for k, r in cham.items()))

    # -- 12e. Scharr and LBP at 1920x1080 --------------------------------------
    big = make_clip(1920, 1080, 1, seed=0)[0]
    sl = {}
    for d in (dev, cpu):
        img = from_array(torch.from_numpy(big).to(d), border=1,
                         border_mode="mirror")
        sl[d] = (img, SC.scharr(img).data, LB.lbp_transform(img).data)
    check(same_bits(torch, sl[dev][1].cpu(), sl[cpu][1]),
          "scharr differs between card and CPU")
    check(torch.equal(sl[dev][2].cpu(), sl[cpu][2]),
          "lbp_transform differs between card and CPU")
    img = sl[dev][0]
    sc_row = dict(scharr_device_ms=device_ms(torch, lambda: SC.scharr(img))[0],
                  lbp_device_ms=device_ms(torch,
                                          lambda: LB.lbp_transform(img))[0])
    out["scharr_lbp"] = sc_row
    print("phase 12: scharr and lbp_transform at 1920x1080 bit-equal to the "
          f"CPU; {sc_row['scharr_device_ms']:.4f} and "
          f"{sc_row['lbp_device_ms']:.4f} ms on the device")

    # -- 12f. matchers and the line-based pose ----------------------------------
    rng = np.random.RandomState(1)
    mt = {}
    for dist_name, nbytes in (("sad", 49), ("hamming", 32)):
        q = rng.randint(0, 256, (MATCH_N, nbytes)).astype(np.uint8)
        t = rng.randint(0, 256, (MATCH_N, nbytes)).astype(np.uint8)
        qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
        gi, gd = MT.bruteforce_match(qd, td, distance=dist_name)
        ci, cd_ = MT.bruteforce_match(torch.from_numpy(q),
                                      torch.from_numpy(t),
                                      distance=dist_name)
        check(torch.equal(gi.cpu(), ci) and same_bits(torch, gd.cpu(), cd_),
              f"bruteforce_match {dist_name} differs from the CPU")
        fn = (lambda a=qd, b=td, n=dist_name:
              MT.bruteforce_match(a, b, distance=n))
        mt[dist_name] = device_ms(torch, fn)[0]
        mt[f"{dist_name}_device_ops"] = device_ops(torch, fn)[0]
    p1, p2 = sfm_scene(np)
    xi_gt = torch.tensor([0.1, -0.15, 0.05, 0.2, -0.1, 0.15])
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0])
    poses = {}
    for d in (dev, cpu):
        T = SE.se3_exp(xi_gt.to(d))
        a, b = torch.from_numpy(p1).to(d), torch.from_numpy(p2).to(d)
        uv1 = BA.project(T, a, intr.to(d))
        uv2 = BA.project(T, b, intr.to(d))
        poses[d] = (SFM.pose_from_line_correspondences(
            a, b, uv1, uv2, intr.to(d)), T, (a, b, uv1, uv2))
    (gR, gt, gc), T_gt, gargs = poses[dev]
    (cR, ct, cc_), _, _ = poses[cpu]
    r_err = float((gR.cpu() - cR).abs().max())
    t_err = float((gt.cpu() - ct).abs().max())
    check(float(gc) < 1e-6 and float((gR - T_gt[:3, :3]).abs().max()) < 2e-2,
          f"pose_from_line_correspondences misses its gates: cost "
          f"{float(gc)}")
    check(r_err <= 1e-3 and t_err <= 1e-3,
          f"pose_from_line_correspondences: R within {r_err}, t within "
          f"{t_err} of the CPU")
    mt["pose_ms"] = cuda_ms(torch, lambda: SFM.pose_from_line_correspondences(
        *gargs, intr.to(dev)), 3)
    mt["pose_cost"] = float(gc)
    out["matchers_sfm"] = mt
    print(f"phase 12: bruteforce_match at Q = T = {MATCH_N}: SAD (49 bytes) "
          f"and Hamming (32 bytes) bit-equal to the CPU, {mt['sad']:.4f} and "
          f"{mt['hamming']:.4f} ms on the device in {mt['sad_device_ops']} "
          f"and {mt['hamming_device_ops']} device operations; pose from 8 line "
          f"correspondences: cost {mt['pose_cost']:.3g}, R and t within "
          f"{r_err:.3g} and {t_err:.3g} of the CPU, {mt['pose_ms']:.2f} ms "
          "as called")
    out["card"] = smi
    return out


SLICE_D_FRAME = (1920, 1080)     # phase 13a-c's frame (W, H)
VOLUME = (64, 256, 256)          # phase 13d's image3d (slices, rows, cols)
INTERP_POINTS = 65536            # phase 13d's interpolation points


def tree_bits_equal(torch, a, b) -> bool:
    """Two results bit for bit: tensors by their bytes (NaN included),
    images by border and buffer, tuples, lists, dicts and dataclasses
    field by field, anything else by ``==``."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.detach().cpu().contiguous().view(
                    torch.uint8), b.detach().cpu().contiguous().view(
                        torch.uint8)))
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            tree_bits_equal(torch, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(tree_bits_equal(torch, x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            tree_bits_equal(torch, a[k], b[k]) for k in a)
    return a == b


def host_cpu():
    """The host's CPU model and logical core count, from /proc/cpuinfo: its
    model name with the architecture, vendor, family and model numbers (a
    host may name its model "unknown"; an Arm host has only an implementer
    and a part)."""
    import platform
    with open("/proc/cpuinfo") as f:
        lines = f.read().splitlines()
    fields = {}
    for ln in lines:
        key, _, val = ln.partition(":")
        fields.setdefault(key.strip().lower(), val.strip())
    cores = sum(1 for ln in lines if ln.startswith("processor"))
    ident = ", ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "cpu implementer", "cpu part")
        if k in fields)
    if "avx512f" in fields.get("flags", "").split():
        ident += ", avx512f"
    name = next((fields[k] for k in ("model name", "cpu model", "hardware")
                 if fields.get(k)), "no model name")
    return f"{name} ({platform.machine()}; {ident})", cores


def phase_slice_d(torch, np, dev, cfg, clip, track_fps, track_live,
                  track_state, smi):
    """Phase 13: slice D on the card. The loop constructs, the windows and
    an LIIE expression on a 1080p frame, the ordered scan, a 3-D image,
    the tracker fed through ``foreach_videoframe`` with and without
    prefetch and under ``Profiler`` sections, and the native CPU
    baseline. Returns the numbers it prints."""
    import importlib
    import os
    from vpp_tpu_torch import ops as O
    from vpp_tpu_torch.algorithms import video_extruder as VE
    from vpp_tpu_torch.algorithms.pyramid import pyramid
    from vpp_tpu_torch.core.image import Image2d
    from vpp_tpu_torch.io import foreach_videoframe, from_numpy
    from vpp_tpu_torch.utils import Profiler
    from vpp_tpu_torch.utils import native as NT
    from vpp_tpu_torch.utils.clips import make_clip
    ND = importlib.import_module("vpp_tpu_torch.core.imagend")
    cpu = torch.device("cpu")
    devs = (dev, cpu)
    out = {}

    def timed(name, fn, calls=20, iters=20):
        """Device ms (CUDA-graph replays, else the profiler), as-called ms
        and device operations of one call of ``fn`` on the card."""
        dms, by = device_ms(torch, fn, calls=calls)
        ms = cuda_ms(torch, fn, iters)
        ops, ops_by = device_ops(torch, fn)
        out[name] = dict(device_ms=dms, device_ms_by=by, ms=ms,
                         device_ops=ops, device_ops_by=ops_by)
        print(f"phase 13: {name}: {dms:.4f} ms on the device ({by}), "
              f"{ms:.4f} as called, device operations {ops} ({ops_by})")
        return out[name]

    def held(name, fn, args):
        """``fn`` on the card and on the CPU, bit for bit."""
        got, want = fn(*args[dev]), fn(*args[cpu])
        check(tree_bits_equal(torch, got, want),
              f"phase 13: {name} on the card differs from the CPU")
        return got

    # -- 13a. the loop constructs and a window on a 1080p frame -------------
    fw, fh = SLICE_D_FRAME
    frames = make_clip(fw, fh, 2, seed=0)
    pair = {d: tuple(from_numpy(f, border=1, border_mode="mirror", device=d)
                     for f in frames) for d in devs}
    one = {d: pair[d][:1] for d in devs}

    def stencil(im):
        return O.pixel_wise(O.relative_access(im)) | (lambda n: (
            n(-1, -1) + 2 * n(-1, 0) + n(-1, 1) + 2 * n(0, -1)
            + 4 * n.center + 2 * n(0, 1) + n(1, -1) + 2 * n(1, 0)
            + n(1, 1)) * 0.0625)

    def blocks(im):
        return O.block_wise((16, 16), im) | (lambda blk, valid: (
            blk - torch.amax(torch.where(valid, blk, -1.0)),
            torch.sum(valid, dtype=torch.int32)))

    def rows(im):
        return O.row_wise(im) | (lambda r: (r - torch.amin(r),
                                            torch.argmax(r)))

    def erosion(im):
        return torch.amin(O.window_stack(im, O.C8), 0)

    for name, fn in (("pixel_wise_3x3", stencil), ("block_wise_16", blocks),
                     ("row_wise", rows), ("window_stack_c8_erosion",
                                          erosion)):
        held(name, fn, one)
        timed(name, lambda fn=fn: fn(*one[dev]))
    bw = blocks(*one[dev])
    check(tuple(bw[1].shape) == (-(-fh // 16), -(-fw // 16))
          and int(bw[1][-1, 0]) == (fh % 16) * 16,
          "phase 13: block_wise's ragged bottom row of blocks")
    print(f"phase 13a: pixel_wise, block_wise (ragged at {fh}), row_wise "
          f"and the C8 erosion at {fw}x{fh} bit-equal to the CPU")

    # -- 13b. an LIIE expression with a select and global reductions ---------
    def liie(a, b):
        P1, P2 = O.P1, O.P2
        return (O.evaluate(O.if_(P1 > P2)(P1 - P2)(P2 * 0.5), a, b),
                O.evaluate(O.sum_of(O.if_(P1 > P2)(P1)(P2)), a, b),
                O.evaluate(O.argmax_of(P1 - P2), a, b))

    got, want = liie(*pair[dev]), liie(*pair[cpu])
    check(tree_bits_equal(torch, got[0], want[0]),
          "phase 13b: the LIIE image differs from the CPU")
    check(torch.equal(got[2].cpu(), want[2]),
          "phase 13b: argmax_of differs from the CPU")
    sum_rel = abs(float(got[1]) - float(want[1])) / abs(float(want[1]))
    check(sum_rel <= 1e-6, f"phase 13b: sum_of off by {sum_rel:.3g} relative")
    out["liie_sum_rel_err"] = sum_rel
    timed("liie", lambda: liie(*pair[dev]))
    print(f"phase 13b: LIIE image bit-equal, argmax_of "
          f"{got[2].tolist()} equal, sum_of within {sum_rel:.3g} relative")

    # -- 13c. the ordered scan: an int32 running sum along the columns -------
    ints = {d: (from_numpy(np.rint(frames[0] * 9).astype(np.int32),
                           device=d),) for d in devs}

    def run_sum(carry, col):
        s = carry + col
        return s, s

    def scan(im):
        return O.directional_pixel_wise(
            "left_to_right", run_sum,
            torch.zeros(fh, dtype=torch.int32, device=im.device), im)

    ref = held("directional_pixel_wise", scan, ints)
    check(torch.equal(ref.data.cpu(), torch.cumsum(
        ints[cpu][0].data, 1, dtype=torch.int32)),
        "phase 13c: the running sum is not the cumulative sum")
    sc = timed("directional_pixel_wise", lambda: scan(*ints[dev]),
               calls=2, iters=3)
    launches = sc["device_ops"].get("kernel", 0)
    check(launches >= fw, f"phase 13c: the scan made {launches} kernel "
          f"launches a call, fewer than its {fw} columns")
    out["scan_launches_per_call"] = launches
    print(f"phase 13c: left_to_right int32 running sum over {fw} columns "
          f"bit-equal to the CPU; {launches} kernel launches a call "
          f"({launches / fw:.3f} a column)")

    # -- 13d. a 3-D image: 6-neighbour stencil and N-linear interpolation ----
    vs, vr, vc = VOLUME
    rng = np.random.RandomState(0)
    vol = rng.rand(vs, vr, vc).astype(np.float32)
    pts = (rng.rand(INTERP_POINTS, 3) * [vs - 1, vr - 1, vc - 1]).astype(
        np.float32)
    img3 = {d: (ND.from_array_nd(vol, border=1, border_mode="closest",
                                 device=d), torch.from_numpy(pts).to(d))
            for d in devs}

    def six(im, _):
        return (im.shifted(-1, 0, 0) + im.shifted(1, 0, 0)
                + im.shifted(0, -1, 0) + im.shifted(0, 1, 0)
                + im.shifted(0, 0, -1) + im.shifted(0, 0, 1)
                - 6 * im.interior)

    def interp(im, p):
        return im.linear_interpolate(p)

    for name, fn in (("image3d_six_neighbours", six),
                     ("image3d_linear_interpolate", interp)):
        got, want = fn(*img3[dev]), fn(*img3[cpu])
        err = rel_err(got.cpu().double(), want.double())
        check(tuple(got.shape) == tuple(want.shape) and err <= 1e-6,
              f"phase 13d: {name} off by {err:.3g} relative to the largest "
              "magnitude")
        timed(name, lambda fn=fn: fn(*img3[dev]))
        out[name]["rel_err"] = err
        out[name]["bit_equal"] = tree_bits_equal(torch, got, want)
    print(f"phase 13d: {vs}x{vr}x{vc} image3d (border 1): the stencil and "
          f"{INTERP_POINTS} interpolations within 1e-6 of the CPU "
          f"(bit-equal: {out['image3d_six_neighbours']['bit_equal']}, "
          f"{out['image3d_linear_interpolate']['bit_equal']})")

    # -- 13e. the tracker fed through foreach_videoframe ---------------------
    b = max(3, cfg.winsize)

    def track(source, prefetch, prof=None):
        st = {"state": VE.video_extruder_init(cfg, device=dev), "prev": None}

        def step(frame):
            if prof is not None:
                prof.begin("frame")
                prof.begin("flow")
                prof.begin("pyramid")
            pyr = pyramid(Image2d(frame, border=0), cfg.nscales, border=b)
            if prof is not None:
                prof.end("pyramid", sync=pyr)
                prof.end("flow")
            prev = pyr if st["prev"] is None else st["prev"]
            st["state"] = VE.video_extruder_update(st["state"], prev[0],
                                                   pyr[0], cfg, prev, pyr)
            st["prev"] = pyr
            if prof is not None:
                prof.end("frame", sync=st["state"])

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = foreach_videoframe(source, step, prefetch=prefetch, device=dev)
        torch.cuda.synchronize()
        return st["state"], n / (time.perf_counter() - t0), n

    def pump(prefetch):
        """Frames/s of the frame pump alone (a consumer that does
        nothing), to the card and synchronised."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = foreach_videoframe(clip, lambda f: None, prefetch=prefetch,
                               device=dev)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    track(clip[:6], True)                                   # warm-up
    order = (True, False, False, True) * 3
    runs = {True: [], False: []}
    for prefetch in order:
        state, fps, n = track(clip, prefetch)
        check(n == len(clip), f"phase 13e: {n} frames of {len(clip)}")
        runs[prefetch].append((state, fps))
    pumps = {True: [], False: []}
    for prefetch in order:
        pumps[prefetch].append(pump(prefetch))
    base = runs[True][0][0]
    for prefetch, rr in runs.items():
        for state, _ in rr:
            check(tree_bits_equal(torch, state, base),
                  "phase 13e: the tracker's final state differs between "
                  "runs with and without prefetch")
    same_as_run = tree_bits_equal(torch, base, track_state)
    med = {}
    for key, vals in (("foreach_fps_prefetch", [f for _, f in runs[True]]),
                      ("foreach_fps_no_prefetch",
                       [f for _, f in runs[False]]),
                      ("pump_fps_prefetch", pumps[True]),
                      ("pump_fps_no_prefetch", pumps[False])):
        out[key] = vals
        med[key] = float(np.median(vals))
        out[key + "_median"] = med[key]
    out["foreach_state_equals_phase4"] = same_as_run
    print(f"phase 13e: the tracker through foreach_videoframe, {len(clip)} "
          f"frames of {W}x{H}, {len(order)} runs alternating: prefetch "
          + ", ".join(f"{f:.2f}" for f in out["foreach_fps_prefetch"])
          + f" frames/s (median {med['foreach_fps_prefetch']:.2f}), without "
          + ", ".join(f"{f:.2f}" for f in out["foreach_fps_no_prefetch"])
          + f" (median {med['foreach_fps_no_prefetch']:.2f}); the pump "
          f"alone {med['pump_fps_prefetch']:.2f} and "
          f"{med['pump_fps_no_prefetch']:.2f} frames/s (medians); final "
          f"states bit-equal; equal to phase 4's video_extruder_run: "
          f"{same_as_run}")

    # -- 13f. the same run under Profiler sections ---------------------------
    prof = Profiler()
    stages = {"semi_dense_streams": "flow", "kp_move_all": "lifecycle",
              "_merge_collided": "lifecycle", "cull_scores": "lifecycle",
              "kp_kill_where": "lifecycle", "_occupancy_mask": "detect",
              "score_image": "detect", "block_topk": "detect",
              "kp_add": "detect"}
    saved = {name: getattr(VE, name) for name in stages}

    def sectioned(stage, name, fn):
        def call(*args, **kw):
            with prof(stage):
                prof.begin(name)
                res = fn(*args, **kw)
                prof.end(name, sync=res)
            return res
        return call

    try:
        for name, stage in stages.items():
            setattr(VE, name, sectioned(stage, name, saved[name]))
        state, fps, n = track(clip, True, prof)
    finally:
        for name, fn in saved.items():
            setattr(VE, name, fn)
    check(tree_bits_equal(torch, state, base),
          "phase 13f: the profiled run's final state differs")
    frame = prof.root.children["frame"]
    check(frame.ncalls == n and set(frame.children) == {
        "flow", "lifecycle", "detect"}, "phase 13f: the profiler's tree")
    out["profiled_fps"] = fps
    out["profile_ms_per_frame"] = {
        k: v.duration * 1e3 / n for k, v in frame.children.items()}
    out["profile_ms_per_frame"]["frame"] = frame.duration * 1e3 / n
    out["profile_report"] = prof.report()
    print(f"phase 13f: the tracker under Profiler sections with sync= "
          f"({fps:.2f} frames/s, the same final state):")
    print(out["profile_report"])

    # -- 13g. the native CPU baseline beside the port's tracker --------------
    t0 = time.perf_counter()
    lib = NT.build_native()
    build_s = time.perf_counter() - t0
    check(lib is not None, "phase 13g: the native CPU baseline did not build")
    stats = [NT.cpu_tracker_fps_stats(W, H, TRACK_FRAMES) for _ in range(3)]
    check(all(f is not None for f, _ in stats),
          "phase 13g: cpu_tracker_fps_stats returned None")
    model, cores = host_cpu()
    out["cpu_baseline"] = dict(
        fps=[f for f, _ in stats], live=stats[0][1], build_s=build_s,
        cpu=model, logical_cores=cores, os_cpu_count=os.cpu_count(),
        port_fps=track_fps, port_live=track_live, card=smi)
    fps_cpu = sorted(f for f, _ in stats)[1]
    print(f"phase 13g: cpu_baseline {W}x{H}, {TRACK_FRAMES} frames: "
          + ", ".join(f"{f:.2f}" for f, _ in stats)
          + f" frames/s ({stats[0][1]} live keypoints; built in "
          f"{build_s:.1f} s) on {model}, {cores} logical cores; the port's "
          f"tracker (phase 4) {track_fps:.2f} frames/s, {track_live} live "
          f"keypoints, on {smi}: {track_fps / fps_cpu:.2f}x the median")
    return out


SHARD_RANKS = 4          # phase 14's gloo ranks on the one card
SHARD_FRAMES = 20        # phase 14b's frames of the bench clip
SHARD_MARGIN = (40, 80)  # px killed at the left and right edges each step
SHARD_AG_W = 240         # phase 14c: shard width 60 < the halo of 80
SHARD_AG_FRAMES = 6
SHARD_TIMEOUT = 300.0


def bench_tracker_config():
    """``bench.py``'s tracker configuration (phase 4's)."""
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    return VideoExtruderConfig(capacity=4096, detect_k=2048, nscales=3,
                               winsize=9, keypoint_spacing=10,
                               detector_period=5, detector_th=10)


def kill_margin(torch, st, w: int):
    """The keypoints within ``SHARD_MARGIN`` of the left and right edges
    killed: the sharded flow may differ at the right margin (the global
    grid chain's overhang column, ``parallel/sharded_tracker.py``), as
    tests/test_sharded_tracker.py:173-218 kills them."""
    from vpp_tpu_torch.core.keypoints import kp_kill_where
    col = st.keypoints.position[:, 1]
    bad = st.keypoints.alive & ((col < SHARD_MARGIN[0])
                                | (col >= w - SHARD_MARGIN[1]))
    return dataclasses.replace(st, keypoints=kp_kill_where(st.keypoints,
                                                           bad))


def tracker_steps(torch, clip, cfg, step):
    """``step(state, f1, f2)`` over a (T, H, W) clip on the card from an
    empty state, the margin killed after each step (phase 14b): the
    states' (age, position, traj_len) each step on the card, the final
    state, and ms a frame as called (host clock to a synchronise, after
    a two-frame warm-up)."""
    from vpp_tpu_torch.algorithms.video_extruder import video_extruder_init
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.parallel.mesh import comm_stats, reset_comm_stats
    w = clip.shape[-1]
    st = video_extruder_init(cfg, device="cuda")
    for i in range(2):
        st = step(st, clip[max(i - 1, 0)], clip[i])
    torch.cuda.synchronize()
    st = video_extruder_init(cfg, device="cuda")
    steps = []
    reset_launch_counts()
    reset_comm_stats()
    t0 = time.perf_counter()
    for i in range(len(clip)):
        st = kill_margin(torch, step(st, clip[max(i - 1, 0)], clip[i]), w)
        steps.append((st.keypoints.age, st.keypoints.position, st.traj_len))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(clip)
    return dict(steps=[tuple(t.cpu() for t in s) for s in steps], state=st,
                ms=ms, launches=launch_counts(), comm=comm_stats())


def flow_arrays(m, d, ok, alive):
    """The flow's outputs at the live slots, on the CPU."""
    return (m[alive].cpu(), d[alive].cpu(), ok[alive].cpu())


def shard_tracker_job(torch, np, mesh, clip, flow_kw):
    """Phase 14b/c on one rank: the sharded tracker over the clip, then the
    sharded flow on the final keypoints between the last two frames."""
    from vpp_tpu_torch.parallel.mesh import collective_routes
    from vpp_tpu_torch.parallel.sharded_tracker import (
        sharded_semi_dense_flow, sharded_video_extruder_update)
    cfg = bench_tracker_config()
    out = tracker_steps(torch, clip, cfg, lambda st, f1, f2: (
        sharded_video_extruder_update(mesh, st, f1, f2, cfg)))
    kps = out.pop("state").keypoints
    out["flow"] = flow_arrays(*sharded_semi_dense_flow(
        mesh, kps.position, kps.alive, clip[-2], clip[-1], **flow_kw),
        kps.alive)
    out["routes"] = collective_routes(mesh, "sp", torch.device("cuda"))
    return out


def flat82_problem(torch, np, BA, dev):
    """tests/test_slam.py:82's flat problem (tests/test_slam.py:25's
    recipe, m 4, n 64, the landmarks perturbed by 0.05 from seed 2) made
    through the port's ``se3_exp`` and ``project``."""
    from vpp_tpu_torch.slam.se3 import se3_exp
    m, n = 4, 64
    rng = np.random.RandomState(0)
    xi = np.zeros((m, 6), np.float32)
    xi[:, 3] = -0.3 * np.arange(m)
    xi[:, :3] = rng.randn(m, 3) * 0.02
    poses = se3_exp(torch.from_numpy(xi).to(dev))
    lms = torch.from_numpy((rng.rand(n, 3) * [2.0, 1.5, 1.0]
                            + [-1.0, -0.75, 3.0]).astype(np.float32)).to(dev)
    op = torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(n)
    ol = torch.arange(n, dtype=torch.int32, device=dev).repeat(m)
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0], device=dev)
    noise = np.random.RandomState(2).randn(n, 3) * 0.05
    return BA.BAProblem(
        poses=poses, landmarks=lms + torch.from_numpy(
            noise.astype(np.float32)).to(dev),
        obs_pose=op, obs_lm=ol,
        obs_uv=BA.project(poses[op.long()], lms[ol.long()], intr),
        obs_valid=torch.ones(m * n, dtype=torch.bool, device=dev),
        intrinsics=intr,
        fixed_poses=torch.tensor([True, True, False, False], device=dev))


def timed(torch, fn):
    """(fn's result, ms as called: host clock to a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def shard_ba_job(torch, np, world, slam_path):
    """Phase 14d on one rank: ``ba_solve_tracks`` at phase 10's problem
    over "lm", the flat ``ba_solve`` over "obs", and ``slam_run`` at phase
    6's configuration with its window BA over "lm" (each run twice, the
    second timed)."""
    from vpp_tpu_torch.parallel import make_mesh
    from vpp_tpu_torch.parallel.mesh import comm_stats, reset_comm_stats
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.slam import pipeline as SP
    dev = torch.device("cuda")
    lm = make_mesh((world,), ("lm",))
    obs = make_mesh((world,), ("obs",))
    out = {}
    p, _ = generic_problem(torch, np, BA, dev, GEN_N, GEN_M, GEN_K, 2)
    call = lambda: BA.ba_solve_tracks(  # noqa: E731
        p, iters=GEN_ITERS, lam0=GEN_LAM0, huber=GEN_HUBER, mesh=lm,
        axis="lm")
    call()
    reset_comm_stats()
    (s, c), out["tracks_ms"] = timed(torch, call)
    out["tracks_comm"] = comm_stats()
    out["tracks"] = (s.poses.cpu(), s.landmarks.cpu(), c.cpu())
    flat = flat82_problem(torch, np, BA, dev)
    call = lambda: BA.ba_solve(flat, iters=4, mesh=obs,  # noqa: E731
                               axis="obs")
    call()
    (s, c), out["flat_ms"] = timed(torch, call)
    out["flat"] = (s.poses.cpu(), s.landmarks.cpu(), c.cpu())
    frames = torch.from_numpy(np.load(slam_path)).to(dev)
    cfg = slam_config()
    boot = torch.from_numpy(np.load(slam_path.replace(".npy", "_boot.npy")))
    run = lambda: SP.slam_run(frames, cfg, bootstrap_poses=boot,  # noqa
                              mesh=lm, axis="lm", device="cuda")
    run()
    reset_comm_stats()
    st, out["slam_ms"] = timed(torch, run)
    out["slam_comm"] = comm_stats()
    est, fids = SP.keyframe_trajectory(st)
    out["slam"] = dict(n_keyframes=st.n_keyframes, est=est.cpu(),
                       fids=fids.cpu(), kf_pose=st.kf_pose.cpu(),
                       lm_X=st.lm_X.cpu(), lm_valid=st.lm_valid.cpu(),
                       position=st.tracker.keypoints.position.cpu())
    return out


def shard_rank(rank: int, world: int, backend: str, store: str,
               out_dir: str, jobs) -> None:
    """One rank of phase 14 (a process of its own, started with ``spawn``;
    it imports only ``vpp_tpu_torch``): join the group, load the kernels
    (rank 0 first, the others after a barrier), run ``jobs`` and save what
    they return, or the traceback."""
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist
    from vpp_tpu_torch.kernels import _build
    from vpp_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    torch.set_num_threads(2)     # four ranks share the host's cores
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        **({"device_id": torch.device("cuda", 0)} if backend == "nccl"
           else {}))
    if rank == 0:
        _build.load()
    dist.barrier()
    _build.load()
    res = {}
    try:
        mesh = make_mesh((world,), ("sp",))
        for job, arg in jobs:
            if job == "ba":
                res[job] = shard_ba_job(torch, np, world, arg)
                continue
            clip = torch.from_numpy(np.load(arg)).to("cuda")
            res[job] = shard_tracker_job(torch, np, mesh, clip,
                                         SHARD_FLOW_KW)
    except BaseException:  # reported by the parent, which fails the phase
        res = {"error": traceback.format_exc()}
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    if "error" not in res:
        dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, jobs, tmp: str):
    """Run ``shard_rank`` on ``world`` new processes; every rank's results,
    in rank order. Any rank that fails, hangs past ``SHARD_TIMEOUT`` or
    saves an error fails the phase; every process is ended."""
    import multiprocessing as mp
    import os
    import torch
    ctx = mp.get_context("spawn")
    out_dir = os.path.join(tmp, f"{backend}{world}")
    os.makedirs(out_dir)
    procs = [ctx.Process(target=shard_rank,
                         args=(r, world, backend,
                               os.path.join(out_dir, "store"), out_dir,
                               jobs)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    res = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pt")
        check(os.path.exists(path), f"phase 14: {backend} rank {r} of "
              f"{world} left no result (exit code {p.exitcode})")
        got = torch.load(path, weights_only=False)
        check("error" not in got, f"phase 14: {backend} rank {r} of {world} "
              f"failed:\n{got.get('error')}")
        res.append(got)
    return res


SHARD_FLOW_KW = dict(winsize=9, nscales=3, patchsize=5, search_niters=5)


TIMING_KEYS = ("ms", "comm", "tracks_ms", "tracks_comm", "flat_ms",
               "slam_ms", "slam_comm")


def untimed(res):
    """A rank's results without its clocks (each rank times its own)."""
    if isinstance(res, dict):
        return {k: untimed(v) for k, v in res.items()
                if k not in TIMING_KEYS}
    return res


def equal_bits(torch, a, b) -> bool:
    """Tensors of one dtype and shape with the same bits (floats compared
    as integers of their width, so NaN and -0.0 count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(as_int[a.element_size()])
        b = b.contiguous().view(as_int[b.element_size()])
    return torch.equal(a, b)


def same_tree(torch, a, b) -> bool:
    """Every tensor, number and string of two nested results equal, bit for
    bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(torch, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return equal_bits(torch, a, b)
    return a == b


def k1_slice_check(torch, FL, ST, clip_dev, cfg):
    """Phase 14a: K1 on the extended slices of phase 14b's ranks 0, 1 and
    3 (col0 negative, positive and past the image's middle; w_total the
    whole level's width) on frames 0 and 2 of the bench clip, every level,
    against its plain version by phase 3's K1 rule: on the level buffers
    rounded to integers the whole level bit-equal; on the float buffers
    the match's flow equal wherever best and second-best differ by more
    than 1e-5 relative, dist and volume within rtol 1e-5, and the passes
    exactly equal on the kernel's own match. The predictions are the
    plain levels' upsampled flows. Returns (cases, max relative dist
    error, device ms of rank 1's three levels a frame)."""
    cases, err = [], 0.0
    frames = torch.stack([clip_dev[0], clip_dev[2]])
    times = None
    for rank in (0, 1, SHARD_RANKS - 1):
        geo = ST._flow_geometry(SHARD_RANKS, rank, (H, W), cfg.winsize,
                                cfg.nscales, cfg.propagation, cfg.patchsize,
                                5, 1)
        fill = [ST._edge_fill(frames, geo.halo, geo.border, left)
                for left in (True, False)]
        ext = torch.cat([fill[0], frames, fill[1]], dim=-1)[
            ..., geo.g0:geo.g0 + geo.wl + 2 * geo.halo].contiguous()
        pyr = ST._ext_pyramid(ext, geo.border, geo.ext_shapes)
        for kind in ("integer", "float"):
            prev, ops = None, []
            for s in range(cfg.nscales - 1, -1, -1):
                g = geo.levels[s]
                a1, a2 = pyr[s][0], pyr[s][1]
                if kind == "integer":
                    a1, a2 = a1.round(), a2.round()
                if prev is None:
                    pred = torch.zeros((g.gh, g.gw, 2), dtype=torch.int32,
                                       device=a1.device)
                else:
                    ir = (torch.arange(g.gh, device=a1.device) // 2).clamp(
                        0, prev.shape[0] - 1)
                    ic = torch.arange(g.gw, device=a1.device) // 2
                    pred = 2 * prev[ir[:, None], ic[None, :]]
                fp, dp, vp = FL.flow_match_plain(a1, a2, pred, g)
                lf, ld = FL.flow_level(a1, a2, pred, g, cfg.propagation)
                if kind == "integer":
                    pf, pd = fp, dp
                    for _ in range(cfg.propagation):
                        pf, pd = FL.flow_propagate_plain(pf, pd, pred, vp,
                                                         g.R)
                    check(equal_bits(torch, lf, pf)
                          and equal_bits(torch, ld, pd),
                          f"phase 14a: K1 at col0 {g.col0} (level {s}, rank "
                          f"{rank}) differs from its plain version on "
                          "integer-valued buffers")
                else:
                    fk, dk, vk = FL.flow_match(a1, a2, pred, g)
                    two = torch.topk(vp, 2, dim=0, largest=False).values
                    clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(
                        min=1e-30)
                    rel = float(((dk - dp).abs() / dp.abs().clamp(
                        min=1e-30))[clear].max())
                    err = max(err, rel)
                    check(bool(((fk == fp).all(-1) | ~clear).all())
                          and rel <= 1e-5
                          and torch.allclose(vk, vp, rtol=1e-5, atol=0),
                          f"phase 14a: K1 at col0 {g.col0} (level {s}, rank "
                          f"{rank}) off its plain version beyond the near-"
                          "tie rule")
                    sf, sd = FL.flow_propagate(fk, dk, pred, vk, g.R,
                                               iters=cfg.propagation)
                    check(equal_bits(torch, lf, sf)
                          and equal_bits(torch, ld, sd),
                          "phase 14a: K1's passes at a column slice differ")
                    ops.append((a1, a2, pred, g))
                cases.append((rank, s, g.col0, g.w, g.w_total,
                              int((ld >= 1e29).sum())))
                prev = fp
            if rank == 1 and kind == "float":
                times = device_ms(torch, lambda: [
                    FL.flow_level(*o, cfg.propagation) for o in ops])[0]
    return cases, err, times


def phase_sharded(torch, np, dev, clip, cfg, slam_frames, gt_poses, ga,
                  ga_ate, results, smi):
    """Phase 14, slice E on the card: (a) K1 at a column slice; (b) the
    sharded tracker at full width on ``SHARD_FRAMES`` frames of the bench
    clip, world size 1 over NCCL and ``SHARD_RANKS`` gloo ranks on this
    one card (shard width 160, the ring route), against
    ``video_extruder_update`` on the card, then ``sharded_semi_dense_flow``
    on the final keypoints; (c) the all-gather route at width
    ``SHARD_AG_W``; (d) the sharded BA and ``slam_run(mesh=)`` over the
    gloo ranks. Every rank's results the same bits."""
    import tempfile
    from vpp_tpu_torch.algorithms import flow as FL
    from vpp_tpu_torch.algorithms.flow import semi_dense_optical_flow
    from vpp_tpu_torch.algorithms.video_extruder import video_extruder_update
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.parallel import sharded_tracker as ST
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.slam import pipeline as SP
    from vpp_tpu_torch.utils.clips import make_clip
    out = {}
    b = max(3, cfg.winsize)
    clip_dev = torch.from_numpy(clip[:SHARD_FRAMES]).to(dev)

    # (a) K1 at a column slice
    cases, err, k1_ms = k1_slice_check(torch, FL, ST, clip_dev, cfg)
    out["k1_slice"] = dict(cases=cases, max_rel_dist_err=err,
                           device_ms_rank1=k1_ms)
    print(f"phase 14a: K1 at a column slice on the extended slices of "
          f"ranks 0, 1, {SHARD_RANKS - 1} of {SHARD_RANKS} (col0, w, "
          f"w_total, rejected cells: "
          + ", ".join(f"{c[2]}/{c[3]}/{c[4]}/{c[5]}" for c in cases)
          + f"): bit-equal on integer buffers, near-tie rule on float ones "
          f"(dist within {err:.3g}); rank 1's three levels "
          f"{k1_ms:.4f} ms a frame on the device (card {smi})")

    def single(st, f1, f2):
        return video_extruder_update(
            st, from_array(f1, border=b, border_mode="mirror"),
            from_array(f2, border=b, border_mode="mirror"), cfg)

    def reference(frames):
        ref = tracker_steps(torch, frames, cfg, single)
        kps = ref.pop("state").keypoints
        ref["flow"] = flow_arrays(*semi_dense_optical_flow(
            kps.position, kps.alive,
            from_array(frames[-2], border=b, border_mode="mirror"),
            from_array(frames[-1], border=b, border_mode="mirror"),
            **SHARD_FLOW_KW), kps.alive)
        return ref

    ag_clip = make_clip(SHARD_AG_W, H, SHARD_AG_FRAMES, seed=0)
    refs = {"tracker": reference(clip_dev),
            "allgather": reference(torch.from_numpy(ag_clip).to(dev))}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, arr in (("tracker", clip[:SHARD_FRAMES]),
                          ("allgather", ag_clip),
                          ("slam", slam_frames[:SLAM_CPU_FRAMES])):
            paths[name] = f"{tmp}/{name}.npy"
            np.save(paths[name], arr)
        np.save(f"{tmp}/slam_boot.npy",
                gt_poses[[0, slam_config().keyframe_period]])
        t0 = time.perf_counter()
        one = spawn_ranks(1, "nccl", [("tracker", paths["tracker"])], tmp)
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = spawn_ranks(SHARD_RANKS, "gloo",
                           [("tracker", paths["tracker"]),
                            ("allgather", paths["allgather"]),
                            ("ba", paths["slam"])], tmp)
        t_four = time.perf_counter() - t0
    for r, res in enumerate(four[1:], 1):
        check(same_tree(torch, untimed(four[0]), untimed(res)),
              f"phase 14: gloo rank {r}'s results differ from rank 0's")

    # (b), (c): the sharded tracker against the single-device one
    for label, group, job in (("NCCL x 1", one, "tracker"),
                              (f"gloo x {SHARD_RANKS}", four, "tracker"),
                              (f"gloo x {SHARD_RANKS}, all-gather route "
                               f"({SHARD_AG_W}x{H})", four, "allgather")):
        got, ref = group[0][job], refs[job]
        n_frames = len(ref["steps"])
        for i, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
            check(all(equal_bits(torch, x, y) for x, y in zip(g, w)),
                  f"phase 14 ({label}): step {i}'s age, position or "
                  "traj_len differ from video_extruder_update on the card")
        check(all(equal_bits(torch, x, y)
                  for x, y in zip(got["flow"], ref["flow"])),
              f"phase 14 ({label}): sharded_semi_dense_flow differs from "
              "semi_dense_optical_flow on the live keypoints")
        live = int(got["steps"][-1][0].gt(0).sum())
        check(live > 100, f"phase 14 ({label}): only {live} live keypoints")
        per = {k: got["launches"][k] / n_frames
               for k in ("flow_level", "fast9", "pyramid_decim")}
        comm_s = sum(v["seconds"] for v in got["comm"].values())
        out[f"{job} {label}"] = dict(
            ms_per_frame=got["ms"], single_ms_per_frame=ref["ms"],
            launches_per_frame_per_rank=per, comm=got["comm"],
            comm_ms_per_frame=comm_s * 1e3 / n_frames,
            routes=got["routes"], live=live)
        print(f"phase 14{'c' if job == 'allgather' else 'b'}: sharded "
              f"tracker, {label}, {n_frames} frames at "
              f"{clip_dev.shape[-1] if job == 'tracker' else SHARD_AG_W}"
              f"x{H}: every step's age, position and traj_len bit-equal to "
              f"video_extruder_update on the card, the flow on {live} live "
              f"keypoints bit-equal; {got['ms']:.3f} ms/frame as called "
              f"(single-device {ref['ms']:.3f}); per rank a frame K1 "
              f"{per['flow_level']:.2f}, K2 {per['fast9']:.2f}, K4 "
              f"{per['pyramid_decim']:.2f} launches; collectives "
              f"{comm_s * 1e3 / n_frames:.3f} ms a frame of host time "
              f"({got['comm']}); routes {got['routes']}; "
              + ("one rank" if group is one else
                 f"{SHARD_RANKS} ranks share one card, so this says nothing "
                 "of scaling across cards")
              + f" (card {smi})")
    check(one[0]["tracker"]["launches"]["flow_level"]
          == 2 * cfg.nscales * SHARD_FRAMES,
          "phase 14b: K1 is not two launches a level and frame")
    check(one[0]["tracker"]["launches"]["pyramid_decim"] == SHARD_FRAMES,
          "phase 14b: K4 is not one launch a frame (both slices)")
    k2 = SHARD_FRAMES + -(-SHARD_FRAMES // cfg.detector_period)
    check(one[0]["tracker"]["launches"]["fast9"] == k2,
          f"phase 14b: K2 is not {k2} launches (a cull a frame, a score "
          "image a detection)")

    # (d) the sharded BA and slam_run(mesh=) against the card alone
    ba = four[0]["ba"]
    p, _ = generic_problem(torch, np, BA, dev, GEN_N, GEN_M, GEN_K, 2)
    plain_call = lambda: BA._lm_tracks(  # noqa: E731
        p, GEN_ITERS, GEN_HUBER, GEN_LAM0, False, "lu", kernel=False)
    plain_call()
    plain, plain_ms = timed(torch, plain_call)
    k9 = BA.ba_solve_tracks(p, iters=GEN_ITERS, lam0=GEN_LAM0,
                            huber=GEN_HUBER)

    def ba_dist(got, want):
        (poses, lms, costs), (s, c) = got, want
        return (float((poses - s.poses.cpu()).abs().max()),
                float((lms - s.landmarks.cpu()).abs().max()),
                float(((costs - c.cpu()).abs()
                       - 1e-3 * c.cpu().abs()).max()))

    d_plain = ba_dist(ba["tracks"], plain)
    d_k9 = ba_dist(ba["tracks"], k9)
    check(d_plain[0] <= 1e-3 and d_plain[1] <= 1e-3 and d_plain[2] <= 1e-5,
          f"phase 14d: sharded ba_solve_tracks off the plain loop on the "
          f"card: {d_plain}")
    flat = flat82_problem(torch, np, BA, dev)
    fs = BA.ba_solve(flat, iters=4)
    d_flat = ba_dist(ba["flat"], fs)
    check(d_flat[0] <= 1e-3 and d_flat[1] <= 1e-3 and d_flat[2] <= 1e-5,
          f"phase 14d: sharded flat ba_solve off the card's: {d_flat}")
    sl = ba["slam"]
    s_ate = float(SP.ate_rmse(sl["est"], torch.from_numpy(
        gt_poses[sl["fids"].numpy()])))
    s_lm, g_lm = int(sl["lm_valid"].sum()), int(ga.lm_valid.sum())
    check(sl["n_keyframes"] == ga.n_keyframes,
          "phase 14d: slam_run(mesh=) made another keyframe count")
    check(abs(s_lm - g_lm) <= 0.05 * max(g_lm, 1),
          "phase 14d: slam_run(mesh=) landmarks differ by more than 5%")
    check(abs(s_ate - ga_ate) <= 0.02,
          "phase 14d: slam_run(mesh=) ATE differs by more than 0.02")
    out["ba"] = dict(tracks_ms=ba["tracks_ms"], plain_ms=plain_ms,
                     tracks_comm=ba["tracks_comm"], dist_plain=d_plain,
                     dist_k9=d_k9, flat_ms=ba["flat_ms"], dist_flat=d_flat,
                     slam_ms=ba["slam_ms"], slam_comm=ba["slam_comm"],
                     slam_ate=s_ate, slam_landmarks=s_lm)
    print(f"phase 14d: gloo x {SHARD_RANKS} on the card: ba_solve_tracks at "
          f"N {GEN_N} x M {GEN_M} x K {GEN_K}, {GEN_ITERS} iterations "
          f"(plain stages on the card, declared) within {d_plain} (poses, "
          f"landmarks, costs over 1e-3 relative) of the plain loop on the "
          f"card, {d_k9} of K9's call; {ba['tracks_ms']:.2f} ms a call as "
          f"called (the plain loop alone on the card {plain_ms:.2f}), "
          "collectives "
          f"{ba['tracks_comm']}; flat ba_solve (tests/test_slam.py:82) "
          f"within {d_flat}, {ba['flat_ms']:.2f} ms; slam_run(mesh=) on "
          f"{SLAM_CPU_FRAMES} frames: {sl['n_keyframes']} keyframes, {s_lm} "
          f"landmarks, ATE {s_ate:.4f} (single-device on the card: "
          f"{ga.n_keyframes}, {g_lm}, {ga_ate:.4f}), {ba['slam_ms']:.1f} ms "
          f"as called, collectives {ba['slam_comm']} (card {smi})")
    out["spawn_s"] = dict(nccl1=t_one, gloo4=t_four)
    print(f"phase 14: world size 1 over NCCL took {t_one:.1f} s, "
          f"{SHARD_RANKS} gloo ranks {t_four:.1f} s, process start "
          "included")

    # the kernels line's sharded launches a frame per rank
    per = out[f"tracker gloo x {SHARD_RANKS}"]["launches_per_frame_per_rank"]
    results["flow_level"]["sharded_launches_per_frame_per_rank"] = \
        per["flow_level"]
    results["flow_level"]["device_ms_col0_rank1"] = k1_ms
    results["fast9"]["sharded_launches_per_frame_per_rank"] = per["fast9"]
    results["pyramid_decim"]["sharded_launches_per_frame_per_rank"] = \
        per["pyramid_decim"]
    return out



FRONT_BIG = (1920, 1080)     # phase 15a's winsize-121 frame pair (W, H)
FRONT_CPU_KP = 128           # phase 15a: keypoints held to the CPU at 121
FRONT_DEEP = 18              # phase 15a's scales past K10's 16 a launch
FRONT_NITERS = (16, 24)      # phase 15b's search_niters, beside the default 5
RING_FRAMES = 40             # phase 15c's frames a clip
RING = 20                    # phase 15c's BA window: K9, one launch a stream


def front_lk(torch, frames, kp, ws: int, nscales: int, cpu_n: int,
             smi: str) -> dict:
    """Phase 15a at one (winsize, nscales): ``lucas_kanade`` on the card,
    its launches, K10 against the plain level loop on the card's pyramids
    (every level's flow, err, windows and steps bit-equal), the call
    against the plain CPU path on those pyramids on the first ``cpu_n``
    keypoints (phase 12a's gate: >= 99% of the keypoints both keep within
    1e-2 px; here also the keep decision on >= 99%), the routes, times and
    K10's bound by phase 12a's count."""
    import importlib
    from vpp_tpu_torch.core.image import Image2d
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    LK = importlib.import_module("vpp_tpu_torch.algorithms.lk")
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    i1, i2 = frames
    n = kp.shape[0]
    kw = dict(LK_KW, winsize=ws)
    n_k10 = -(-nscales // 16)

    def call():
        return LK.lucas_kanade(i1, i2, kp, winsize=ws, nscales=nscales)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    flow, dist = call()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    check(counts == {"lk_level": n_k10, "pyramid_decim": 2},
          f"lucas_kanade at winsize {ws}, {nscales} scales launched "
          f"{counts}, not {n_k10} K10 and 2 K4")
    border = max(3, ws // 2)
    pp, pn = PY.pyramid(i1, nscales, border=border), PY.pyramid(
        i2, nscales, border=border)
    pg = LK.gradient_pyramid(pp)
    scales = list(range(nscales - 1, -1, -1))
    levels = [(pp[s], pn[s], pg[s]) for s in scales]
    lkw = dict(kw, adopt="always", factor=2.0)
    zero = torch.zeros_like(kp)
    kall = LK.lk_levels(levels, scales, kp, zero, windows=True, **lkw)
    pall = LK.lk_levels_plain(levels, scales, kp, zero, windows=True, **lkw)
    check(all(torch.equal(g, x) for g, x in zip(kall, pall)),
          f"K10 at winsize {ws}, {nscales} scales differs from the plain "
          "level loop (flow, err, windows or steps at some level)")
    check(same_bits(torch, kall[0], flow) and same_bits(torch, kall[1], dist),
          f"K10's launches differ from lucas_kanade at winsize {ws}")
    rows = [LK._level_row(A, B, G, s, ws) for (A, B, G), s in
            zip(levels, scales)]
    cuts = [0] + list(range(nscales % 16 or 16, nscales + 1, 16))
    routes = [LK._k10_plan(ws, max(r[2] for r in rows[lo:hi]),
                           all(r[3] for r in rows[lo:hi]))
              for lo, hi in zip(cuts, cuts[1:])]
    # the plain CPU path on the card's pyramids, the first cpu_n keypoints
    cpp = on_cpu_pyramid(PY, Image2d, pp)
    cpn = on_cpu_pyramid(PY, Image2d, pn)
    cpg = LK.gradient_pyramid(cpp)
    check(all(same_bits(torch, a.data.cpu(), b.data)
              for a, b in zip(pg.levels, cpg.levels)),
          "the gradient pyramid differs between card and CPU")
    cf, ce, _ = lk_chain(torch, cpp, cpn, cpg, kp[:cpu_n].cpu(),
                         LK.lk_match_batch, kw)
    fc, dc = flow[:cpu_n].cpu(), dist[:cpu_n].cpu()
    keep = (dc < 1e30) & (ce < 1e30)
    dd = (fc - cf).abs().amax(1)
    same_keep = float(((dc < 1e30) == (ce < 1e30)).float().mean())
    within = (float((dd[keep] <= 1e-2).float().mean()) if bool(keep.any())
              else 1.0)
    check(same_keep >= 0.99 and within >= 0.99,
          f"lucas_kanade at winsize {ws}, {nscales} scales against the CPU "
          f"on the card's pyramids: keep equal on {same_keep}, {within} of "
          f"{int(keep.sum())} kept within 1e-2 px")
    # K10's bound by phase 12a's count, level by level (adopt always: a
    # level's prediction is twice the last level's flow)
    nbytes = nops = 0
    tr = zero
    for i, ((A, B, G), s) in enumerate(zip(levels, scales)):
        tr = tr * 2.0
        res = (kall[2][i], kall[3][i], None, kall[5][i])
        b_, o_ = k10_level_bound(torch, (A, B, G, kp / float(2 ** s), tr),
                                 res, ws)
        nbytes += b_
        nops += o_
        tr = kall[2][i]
    b_ms, b_by = bound_ms(nbytes, nops)

    def k10_call():
        LK.lk_levels(levels, scales, kp, zero, **lkw)

    out = dict(winsize=ws, nscales=nscales, keypoints=n,
               frame=list(i1.shape)[::-1], launches=counts,
               routes=[list(r) for r in routes],
               cpu=dict(keypoints=cpu_n, both_keep=int(keep.sum()),
                        keep_equal=same_keep, within_1e2=within,
                        bit_equal=int(((fc == cf).all(1) & (dc == ce))
                                      .sum())),
               steps=int(kall[5].sum()),
               call_device_ms=device_ms(torch, call, calls=5, replays=5)[0],
               call_ms=cuda_ms(torch, call, 5),
               k10_ms=cuda_ms(torch, k10_call, 5),
               plain_ms=cuda_ms(torch, lambda: LK.lk_levels_plain(
                   levels, scales, kp, zero, **lkw), 1),
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               bound_ops=nops, card=smi)
    out["k10_device_ms"], out["device_ms_by"] = device_ms(
        torch, k10_call, calls=5, replays=5)
    print(f"phase 15a: lucas_kanade {out['frame'][0]}x{out['frame'][1]}, "
          f"{n} keypoints, winsize {ws}, {nscales} scales ({smi}): "
          f"launches {counts}, K10 route(s) {out['routes']}, every level "
          f"bit-equal to the plain level loop ({out['steps']} Newton "
          f"steps); against the CPU on the card's pyramids ({cpu_n} "
          f"keypoints): keep equal {same_keep:.4f}, {within:.4f} of "
          f"{int(keep.sum())} kept on both within 1e-2 px, "
          f"{out['cpu']['bit_equal']} bit-equal; the call "
          f"{out['call_device_ms']:.4f} ms on the device, "
          f"{out['call_ms']:.4f} as called; K10 {out['k10_device_ms']:.4f} "
          f"ms on the device ({out['device_ms_by']}), {out['k10_ms']:.4f} "
          f"as called, bound {b_ms:.5f} ({b_by}: {nbytes} bytes, {nops} "
          f"operations); the plain levels {out['plain_ms']:.2f} ms")
    return out


def k1_level_work(g, a1, props: int):
    """K1's least work at one level, phase 3's count: (bytes, operations)."""
    d2 = (2 * g.R + 1) ** 2
    lr = (g.gh - 1) * g.patch + g.ws
    lc = (g.gw - 1) * g.patch + g.ws
    nbytes = a1.numel() * 4 * 2 + g.gh * g.gw * (8 + 8 + 4)
    ops = (d2 * (lr * lc * 2 + g.gh * lc * (g.ws - 1)
                 + g.gh * g.gw * (g.ws - 1))
           + g.gh * g.gw * (d2 - 1) + props * g.gh * g.gw * 8 * 12)
    return nbytes, ops


def front_flow(torch, p1, p2, cfg, niters: int, pos, valid,
               smi: str, phase: str = "15b") -> dict:
    """Phase 15b at one ``search_niters``: ``semi_dense_optical_flow`` on
    the tracker's pyramids; every level of its coarse-to-fine loop held to
    the plain level by phase 3's K1 rule (on the float levels flow equal
    off near-ties, dist and volume within rtol 1e-5; on the levels rounded
    to integers volume, flow and dist bit-equal), the plan each level
    takes, times and K1's bound by phase 3's count. Each level is launch
    A and launch B's chain (``flow._select_links``: one launch up to 38
    passes)."""
    import importlib
    from vpp_tpu_torch.algorithms.pyramid import level_shapes
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    FL = importlib.import_module("vpp_tpu_torch.algorithms.flow")
    dev = p1[0].data.device
    props = cfg.propagation
    b = p1[0].border
    grid = level_shapes((H // cfg.patchsize, W // cfg.patchsize),
                        cfg.nscales)
    radii = FL._level_radii(cfg.nscales, max(1, niters), 1)
    bounds = FL._level_bounds(cfg.nscales, radii)
    plans, ties, nbytes, nops, lv_ms = [], 0, 0, 0, {}
    flow_k = None
    for s in range(cfg.nscales - 1, -1, -1):
        h, w = p1[s].shape
        gh, gw = grid[s]
        if flow_k is None:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)
        else:
            cgh, cgw = grid[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flow_k[ir[:, None], ic[None, :]]
        g = FL.LevelGeometry(b=b, h=h, w=w, ws=cfg.winsize,
                             patch=cfg.patchsize, gh=gh, gw=gw, R=radii[s],
                             pred_bound=0 if s == cfg.nscales - 1
                             else 2 * bounds[s + 1])
        a1, a2 = p1[s].data, p2[s].data
        plan = FL._k1_plan(g, props, FL._sm_count(dev))
        plans.append(dict(level=s, R=g.R, displacements=(2 * g.R + 1) ** 2,
                          a_tile=plan.a_tile, a_threads=plan.a_threads,
                          a_route=plan.a_route, chunk=plan.chunk,
                          batch=plan.batch, a_grid=list(plan.a_grid),
                          b_table=plan.b_table))
        fk, dk, vk = FL.flow_match(a1, a2, pred, g)
        fp, dp, vp = FL.flow_match_plain(a1, a2, pred, g)
        two = torch.topk(vp, 2, dim=0, largest=False).values
        clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
        ties += int((~clear).sum())
        fin = clear & (dp < 1e29)
        rel = ((dk - dp).abs() / dp.abs().clamp(min=1e-30))[fin]
        check(bool(((fk == fp).all(-1) | ~clear).all())
              and torch.equal((dk >= 1e29)[clear], (dp >= 1e29)[clear])
              and (rel.numel() == 0 or float(rel.max()) <= 1e-5)
              and bool(((vk - vp).abs()
                        <= 1e-5 * vp.abs().clamp(min=1e-30)).all()),
              f"K1 at search_niters {niters} differs from its plain version "
              f"at level {s}")
        i1, i2 = a1.round(), a2.round()
        fik, dik, vik = FL.flow_match(i1, i2, pred, g)
        fip, dip, vip = FL.flow_match_plain(i1, i2, pred, g)
        check(torch.equal(vik, vip) and torch.equal(fik, fip)
              and torch.equal(dik, dip), f"K1 match at search_niters "
              f"{niters} not bit-equal on integer buffers at level {s}")
        for _ in range(props):
            fip, dip = FL.flow_propagate_plain(fip, dip, pred, vip, g.R)
        fik, dik = FL.flow_level(i1, i2, pred, g, props)
        check(torch.equal(fik, fip) and torch.equal(dik, dip),
              f"K1 level at search_niters {niters} not bit-equal on integer "
              f"buffers at level {s}")
        flow_k, _ = FL.flow_level(a1, a2, pred, g, props)
        lv_ms[f"level{s}"] = device_ms(
            torch, lambda a1=a1, a2=a2, pr=pred, g=g: FL.flow_level(
                a1, a2, pr, g, props), calls=5, replays=5)[0]
        b_, o_ = k1_level_work(g, a1, props)
        nbytes += b_
        nops += o_
    b_ms, b_by = bound_ms(nbytes, nops)
    kw = dict(winsize=cfg.winsize, nscales=cfg.nscales,
              propagation=props, patchsize=cfg.patchsize,
              search_niters=niters, pyr1=p1, pyr2=p2)

    def call():
        return FL.semi_dense_optical_flow(pos, valid, p1[0], p2[0], **kw)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    per_level = 1 + len(FL._select_links(FL._SELECT_TILE, props))
    check(counts == {"flow_level": per_level * cfg.nscales},
          f"semi_dense_optical_flow at search_niters {niters}, propagation "
          f"{props} launched {counts}")
    out = dict(search_niters=niters, plans=plans, near_tie_cells=ties,
               launches=counts, level_device_ms=lv_ms,
               k1_device_ms=sum(lv_ms.values()),
               call_device_ms=device_ms(torch, call, calls=5, replays=5)[0],
               call_ms=cuda_ms(torch, call, 5), bound_ms=b_ms,
               bound_by=b_by, bound_bytes=nbytes, bound_ops=nops, card=smi)
    print(f"phase {phase}: semi_dense_optical_flow {W}x{H} at "
          f"search_niters {niters}, propagation {props} ({smi}): plans "
          + "; ".join(
              f"level {q['level']} R {q['R']} ({q['displacements']}): "
              f"{q['a_route']} tile {q['a_tile']}x{q['a_threads']}, chunk "
              f"{q['chunk']} batch {q['batch']} grid {q['a_grid']}, table "
              f"{q['b_table']}" for q in plans)
          + f"; every level held to the plain level ({ties} near-tie cells "
          f"excluded), bit-equal on integer buffers; launches {counts}; K1 "
          f"{out['k1_device_ms']:.4f} ms on the device by level "
          + ", ".join(f"{k} {v:.4f}" for k, v in lv_ms.items())
          + f", bound {b_ms:.5f} ({b_by}); the call "
          f"{out['call_device_ms']:.4f} ms on the device, "
          f"{out['call_ms']:.4f} as called")
    return out


FRONT_K1_GLOBAL = dict(ws=151, patch=40, R=5, border=75)   # phase 15b


def front_k1_global(torch, dev, smi: str) -> dict:
    """Phase 15b, K1's global route: one level of the bench pair at
    640x480 with 151 px windows on 40 px cells (no tile shape's regions fit
    227 KB), held to its plain level by phase 3's K1 rule (bit-equal on the
    level rounded to integers); device and as-called ms and its bound by
    phase 3's count."""
    import importlib
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.utils.clips import make_clip
    FL = importlib.import_module("vpp_tpu_torch.algorithms.flow")
    q = FRONT_K1_GLOBAL
    clip = make_clip(W, H, 3, seed=0)
    a1, a2 = (from_array(torch.from_numpy(clip[i]).to(dev), border=q["border"],
                         border_mode="mirror").data for i in (0, 2))
    g = FL.LevelGeometry(b=q["border"], h=H, w=W, ws=q["ws"],
                         patch=q["patch"], gh=H // q["patch"],
                         gw=W // q["patch"], R=q["R"], pred_bound=0)
    pred = torch.zeros((g.gh, g.gw, 2), dtype=torch.int32, device=dev)
    props = 2
    plan = FL._k1_plan(g, props, FL._sm_count(dev))
    check(plan.a_route == "global", f"K1 at ws {g.ws} took the {plan} plan")
    fk, dk, vk = FL.flow_match(a1, a2, pred, g)
    fp, dp, vp = FL.flow_match_plain(a1, a2, pred, g)
    two = torch.topk(vp, 2, dim=0, largest=False).values
    clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
    check(bool(((fk == fp).all(-1) | ~clear).all())
          and bool(((vk - vp).abs() <= 1e-5 * vp.abs().clamp(min=1e-30))
                   .all()), "K1's global route differs from its plain "
          "version on the float level")
    i1, i2 = a1.round(), a2.round()
    reset_launch_counts()
    fik, dik = FL.flow_level(i1, i2, pred, g, props)
    check(launch_counts()["flow_level"] == 2, "K1's global route launched "
          f"{launch_counts()['flow_level']} times, not 2")
    fip, dip, vip = FL.flow_match_plain(i1, i2, pred, g)
    for _ in range(props):
        fip, dip = FL.flow_propagate_plain(fip, dip, pred, vip, g.R)
    _, _, vik = FL.flow_match(i1, i2, pred, g)
    check(torch.equal(vik, vip) and torch.equal(fik, fip)
          and torch.equal(dik, dip), "K1's global route not bit-equal on the "
          "integer level")
    nbytes, nops = k1_level_work(g, a1, props)
    b_ms, b_by = bound_ms(nbytes, nops)

    def call():
        FL.flow_level(a1, a2, pred, g, props)

    out = dict(ws=g.ws, patch=g.patch, R=g.R, grid=[g.gh, g.gw],
               plan=dict(a_tile=plan.a_tile, a_route=plan.a_route,
                         chunk=plan.chunk, a_grid=list(plan.a_grid),
                         b_table=plan.b_table),
               near_tie_cells=int((~clear).sum()), bound_ms=b_ms,
               bound_by=b_by, ms=cuda_ms(torch, call, 3),
               plain_ms=cuda_ms(torch, lambda: FL.flow_match_plain(
                   a1, a2, pred, g), 1), card=smi)
    out["device_ms"], out["device_ms_by"] = device_ms(torch, call, calls=3,
                                                      replays=3)
    print(f"phase 15b: K1's global route, one {W}x{H} level, ws {g.ws} on "
          f"{g.patch} px cells ({g.gh}x{g.gw}), R {g.R} ({smi}): plan "
          f"{out['plan']}; held to the plain level ({out['near_tie_cells']} "
          f"near-tie cells excluded), bit-equal on the integer level; "
          f"{out['device_ms']:.4f} ms on the device ({out['device_ms_by']}), "
          f"{out['ms']:.4f} as called, bound {b_ms:.5f} ({b_by}), the plain "
          f"match {out['plain_ms']:.2f} ms")
    return out


def front_ring20(torch, SP, KN, slam_cfg, dev, smi: str) -> dict:
    """Phase 15c: ``slam_run_streams`` with ``ring = 20`` (one K9 launch a
    stream a keyframe) at phase 9's configuration otherwise, on S = 4 clips
    (seeds 1-4) of 40 frames; each stream held to ``slam_run(ring=20)`` on
    its clip on the card by phase 9's gates; K9 launches and aggregate
    frames/s at S = 1, 2 and 4."""
    cfg = dataclasses.replace(slam_cfg, ring=RING)
    clips, gts = zip(*(slam_clip(RING_FRAMES, seed)
                       for seed in range(1, STREAMS + 1)))
    gt = gts[0]
    clips = torch.stack([torch.from_numpy(c) for c in clips]).to(dev)
    boots = torch.from_numpy(gt[[0, cfg.keyframe_period]]).to(dev).expand(
        STREAMS, 2, 4, 4).contiguous()
    SP.slam_run_streams(clips[:, :8], cfg, boots, device=dev.type)
    torch.cuda.synchronize()
    KN.reset_launch_counts()
    one0 = SP.slam_run(clips[0], cfg, bootstrap_poses=boots[0],
                       device=dev.type)
    torch.cuda.synchronize()
    k9_1 = KN.launch_counts()["ba_generic"]
    captured = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        captured.append((prob, kw))
        return solve(prob, **kw)

    KN.reset_launch_counts()
    SP.ba_solve_tracks = capture          # the run keeps its BA problems
    try:
        st = SP.slam_run_streams(clips, cfg, boots, device=dev.type)
    finally:
        SP.ba_solve_tracks = solve
    torch.cuda.synchronize()
    counts = KN.launch_counts()
    check(k9_1 > 0 and counts["ba_generic"] == STREAMS * k9_1
          and counts["ba_tracks"] == 0,
          f"ring {RING} on {STREAMS} streams launched K9 "
          f"{counts['ba_generic']} times, K6 {counts['ba_tracks']}; one "
          f"stream K9 {k9_1}")

    def ate_of(hist, fids):
        return float(SP.ate_rmse(hist.cpu(), torch.from_numpy(
            gt[fids.cpu().numpy()])))

    per = []
    for i in range(STREAMS):
        one = one0 if i == 0 else SP.slam_run(
            clips[i], cfg, bootstrap_poses=boots[i], device=dev.type)
        n = st.n_keyframes
        ate = ate_of(st.hist_pose[i, :n], st.hist_frame[i, :n])
        ate1 = ate_of(one.hist_pose[:n], one.hist_frame[:n])
        same = (torch.equal(one.tracker.keypoints.alive,
                            st.tracker.keypoints.alive[i])
                and torch.equal(one.tracker.keypoints.position,
                                st.tracker.keypoints.position[i]))
        pose_err = float((one.hist_pose[:n] - st.hist_pose[i, :n]).abs()
                         .max())
        per.append(dict(seed=i + 1, keyframes=n, ate=ate, slam_run_ate=ate1,
                        tracker_bit_equal=same,
                        hist_pose_err_vs_slam_run=pose_err,
                        landmarks=int(st.lm_valid[i].sum())))
        check(same, f"ring {RING}, stream {i}: the tracker differs from "
              "slam_run")
        check(pose_err <= 0.05, f"ring {RING}, stream {i}: hist_pose "
              f"differs from slam_run by {pose_err}")
        check(abs(ate - ate1) <= 0.02, f"ring {RING}, stream {i}: ATE "
              f"{ate} against slam_run's {ate1}")
    # K9 on the last keyframe's ring-20 window of the first S streams: one
    # launch a stream, in stream order
    prob, kw = captured[-1]
    k9 = {}
    for n in (1, 2, STREAMS):
        sub = type(prob)(*(t if i == 5 else t[:n]
                           for i, t in enumerate(prob)))
        KN.reset_launch_counts()
        solve(sub, **kw)
        torch.cuda.synchronize()
        got = KN.launch_counts()["ba_generic"]
        check(got == n, f"the ring-{RING} window of {n} streams made {got} "
              "K9 launches")
        dms, by = device_ms(torch, lambda sub=sub: solve(sub, **kw),
                            calls=5, replays=5)
        k9[str(n)] = dict(launches=got, device_ms=dms, device_ms_by=by,
                          ms=cuda_ms(torch, lambda sub=sub: solve(sub, **kw),
                                     5))
    walls = {n: [] for n in (1, 2, STREAMS)}
    for n in walls:
        SP.slam_run_streams(clips[:n, :8], cfg, boots[:n], device=dev.type)
    for _ in range(3):
        for n in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SP.slam_run_streams(clips[:n], cfg, boots[:n], device=dev.type)
            torch.cuda.synchronize()
            walls[n].append(time.perf_counter() - t0)
    fps = {n: n * RING_FRAMES / sorted(w)[1] for n, w in walls.items()}
    out = dict(ring=RING, frames=RING_FRAMES, keyframes=st.n_keyframes,
               k9_launches_one_stream=k9_1,
               k9_launches_streams=counts["ba_generic"],
               k9_launches_per_keyframe=counts["ba_generic"] / max(k9_1, 1),
               streams=per, window_k9=k9,
               aggregate_fps={str(n): v for n, v in fps.items()}, card=smi)
    print(f"phase 15c: slam_run_streams ring {RING}, {STREAMS} x "
          f"{RING_FRAMES} frames {W}x{H} ({smi}): {st.n_keyframes} "
          f"keyframes, K9 {counts['ba_generic']} launches ({k9_1} for one "
          f"stream: {out['k9_launches_per_keyframe']:.0f} a keyframe), K6 "
          f"{counts['ba_tracks']}; per stream against slam_run(ring={RING}) "
          "on its clip: " + "; ".join(
              f"seed {q['seed']} tracker bit-equal {q['tracker_bit_equal']}, "
              f"hist_pose within {q['hist_pose_err_vs_slam_run']:.3g}, ATE "
              f"{q['ate']:.4f} (slam_run {q['slam_run_ate']:.4f})"
              for q in per)
          + f"; K9 on the last keyframe's window ({prob.poses.shape[-3]} "
          f"poses, {prob.landmarks.shape[-2]} landmarks a stream) by S: "
          + ", ".join(f"S = {n} {q['launches']} launches, "
                      f"{q['device_ms']:.4f} ms on the device, {q['ms']:.4f} "
                      "as called" for n, q in k9.items())
          + "; aggregate frames/s, median of 3: " + ", ".join(
              f"S = {n} {v:.2f}" for n, v in fps.items()))
    return out


def phase_front_end(torch, np, dev, slam_cfg, results, smi):
    """Phase 15: the front-end configurations past the kernels' old limits
    and ``slam_run_streams`` past ring 16, on the card. Returns the numbers
    it prints."""
    import importlib
    from vpp_tpu_torch.algorithms.pyramid import pyramid
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.utils.clips import make_clip
    SP = importlib.import_module("vpp_tpu_torch.slam.pipeline")
    KN = importlib.import_module("vpp_tpu_torch.kernels")
    out = {}
    # -- 15a. lucas_kanade at phase 12a's workload, winsize 21 and 31; 121
    #    on a 1080p pair; 18 scales ------------------------------------------
    vga = [from_array(torch.from_numpy(f).to(dev), border=9,
                      border_mode="mirror") for f in make_clip(W, H, 2,
                                                               seed=0)]
    rng = np.random.RandomState(0)
    kp = torch.from_numpy((rng.rand(SLICE_C_KP, 2) * [H - 20, W - 20]
                           + 10).astype(np.float32)).to(dev)
    bw, bh = FRONT_BIG
    big = [from_array(torch.from_numpy(f).to(dev), border=9,
                      border_mode="mirror") for f in make_clip(bw, bh, 2,
                                                               seed=0)]
    kp_big = torch.from_numpy((rng.rand(SLICE_C_KP, 2) * [bh - 20, bw - 20]
                               + 10).astype(np.float32)).to(dev)
    lk = {}
    for name, frames, pts, ws, nsc, cpu_n in (
            ("winsize 21", vga, kp, 21, 3, SLICE_C_KP),
            ("winsize 31", vga, kp, 31, 3, SLICE_C_KP),
            ("winsize 121 1080p", big, kp_big, 121, 3, FRONT_CPU_KP),
            (f"{FRONT_DEEP} scales", vga, kp, 11, FRONT_DEEP, SLICE_C_KP)):
        lk[name] = front_lk(torch, frames, pts, ws, nsc, cpu_n, smi)
    w11 = results["lk_level"]
    for name in ("winsize 21", "winsize 31"):
        lk[name]["bound_ops_vs_winsize11"] = (lk[name]["bound_ops"]
                                              / w11["bound_ops"])
    print(f"phase 15a: K10's bound operations against phase 12a's winsize "
          f"11 ({w11['bound_ops']}): winsize 21 "
          f"{lk['winsize 21']['bound_ops_vs_winsize11']:.2f}x, winsize 31 "
          f"{lk['winsize 31']['bound_ops_vs_winsize11']:.2f}x")
    out["lucas_kanade"] = lk
    # -- 15b. semi_dense_optical_flow at search_niters 16 and 24 -------------
    cfg = bench_tracker_config()
    clip = make_clip(W, H, 3, seed=0)
    b = max(3, cfg.winsize)
    p1, p2 = (pyramid(from_array(torch.from_numpy(clip[i]).to(dev), border=b,
                                 border_mode="mirror"), cfg.nscales,
                      border=b) for i in (0, 2))
    pos = torch.from_numpy((rng.rand(SLICE_C_KP, 2) * [H - 1, W - 1]).astype(
        np.float32)).to(dev)
    valid = torch.ones(SLICE_C_KP, dtype=torch.bool, device=dev)
    out["semi_dense"] = {str(n): front_flow(torch, p1, p2, cfg, n, pos,
                                            valid, smi)
                         for n in (5,) + FRONT_NITERS}
    out["k1_global"] = front_k1_global(torch, dev, smi)
    # -- 15c. slam_run_streams past ring 16 -----------------------------------
    out["ring20_streams"] = front_ring20(torch, SP, KN, slam_cfg, dev, smi)
    # the kernels line's rows
    results["lk_level"]["device_ms_by_route"] = {
        k: v["k10_device_ms"] for k, v in lk.items()}
    results["lk_level"]["bound_ms_by_route"] = {
        k: v["bound_ms"] for k, v in lk.items()}
    results["flow_level"]["device_ms_by_search_niters"] = {
        k: v["k1_device_ms"] for k, v in out["semi_dense"].items()}
    results["flow_level"]["device_ms_global_route"] = \
        out["k1_global"]["device_ms"]
    results["ba_generic"]["launches_ring20_streams4"] = \
        out["ring20_streams"]["k9_launches_streams"]
    results["ba_generic"]["device_ms_ring20_window_by_streams"] = {
        n: q["device_ms"] for n, q in out["ring20_streams"]["window_k9"]
        .items()}
    return out


# phase 16: the back-end configurations past the kernels' old limits
# name: (N, M, K, case, lam0, iterations). The closure over 2048 poses
# starts at lam0 1: at the recipe's 1e-4 its first Gauss-Newton step
# moves a pose by 10 (radians and units) along the chain's weak scale
# modes, a candidate both solves reject, whose cost two float32 solves put
# 4e-3 apart (PERF.md §6)
BACK_K9 = {
    "m1024_k48": (4096, 1024, 48, "plain", 1e-4, 3),
    "closure_m2048": (10240, 2048, 4, "closure", 1.0, 2),
    "m3072": (20000, 3072, 4, "plain", 1e-4, 3),
    "slots_4.8M": (600000, 128, 8, "plain", 1e-4, 3),
}
BACK_RING = 48               # phase 16a's slam_run window
BACK_BIG = (1920, 1080)      # phase 16b's frames (W, H)
BACK_INTR = (1920.0, 1920.0, 960.0, 540.0)   # phase 6's field of view
BACK_Q = 20736               # 192 x 108 cells of 10 px: capacity, detect_k
BACK_FRAMES = 12             # phase 16b's SLAM frames
BACK_Q_SYNTH = 65536         # phase 16b's synthetic detections
BACK_PROP = 48               # phase 16c's propagation passes


def back_k9(torch, np, BA, BG, KN, dev, smi: str) -> dict:
    """Phase 16a: K9 at the sizes past its old limits (``BACK_K9``), LU
    and Cholesky, each held to its plain version by ``k9_check`` at phase
    10's tolerances (the plain loop's own spread from its float64-solve
    twin on the card: these plain loops take minutes on the host), its
    routes those ``k9_routes`` names for the card's shared memory, timed
    on the device beside the plain loop and K9's bound. The chains turn by
    0.01 (128 / M)^1.5 radians a step and are laid out about their middle
    pose (``generic_problem``)."""
    smem = BG.smem_bytes()
    out = {}
    for name, (n, m, k, case, lam0, iters) in BACK_K9.items():
        p, _ = generic_problem(torch, np, BA, dev, n, m, k, 5, case,
                               noise=0.3, rot=0.01 * min(
                                   1.0, (GEN_M / m) ** 1.5), centre=True)
        rows = {}
        for linalg in ("lu", "chol"):
            nums, (_, _, costs, tr) = k9_check(
                torch, BA, BG, KN, p, iters, lam0, linalg,
                f"{name}, {linalg}", cpu=False)
            routes = BG.routes_of_trace(tr)
            want = BG.k9_routes(m, nums["band"], linalg, smem)
            check(routes == want, f"K9 ({name}, {linalg}) took the routes "
                  f"{routes}, k9_routes names {want}")
            big = m >= 2048 or n * k > 1 << 22

            def call(linalg=linalg):
                return BA.ba_solve_tracks(p, iters=iters, lam0=lam0,
                                          linalg=linalg)
            dms, by = device_ms(torch, call, calls=1,
                                replays=1 if big else 3)
            plain = cuda_ms(torch, lambda linalg=linalg: BA._lm_tracks(
                p, iters, GEN_HUBER, lam0, False, linalg, kernel=False), 1,
                warmup=1)
            (b_ms, b_by), nbytes, ops, _, _ = k9_bound(
                torch, p, iters, nums["band"], linalg)
            rows[linalg] = dict(
                routes=routes, band=nums["band"], device_ms=dms,
                device_ms_by=by, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, costs=costs.tolist(),
                lm_last_cost_above=nums["lm_last_cost_above"],
                lm_pose_err=nums["lm_pose_err"],
                plain_f64_pose_dist=nums["plain_f64_pose_dist"],
                solve_backward_err=nums["solve_backward_err"],
                S_rel_err=nums["S_rel_err"])
            torch.cuda.empty_cache()
        out[name] = dict(n=n, m=m, k=k, case=case, slots=n * k, lam0=lam0,
                         iters=iters, **rows)
        print(f"phase 16a: K9 {name} (N {n}, M {m}, K {k}, {n * k} slots, "
              f"{case}, {iters} iterations, lam0 {lam0}; {smi}): "
              + "; ".join(
                  f"{la}: routes {r['routes']}, band {r['band']}, "
                  f"{r['device_ms']:.3f} ms on the device "
                  f"({r['device_ms_by']}), plain loop {r['plain_ms']:.3f} "
                  f"ms, bound {r['bound_ms']:.4f} ({r['bound_by']}), last "
                  f"cost {r['lm_last_cost_above']:.3g} of the first above "
                  f"the plain loop's, poses {r['lm_pose_err']:.3g} (the "
                  f"plain loop's float64-solve twin "
                  f"{r['plain_f64_pose_dist']:.3g})"
                  for la, r in rows.items()), flush=True)
    # every stage's device-memory route, chosen for a small budget at phase
    # 10's M 128 and at a closure over 512 poses: the card's routes' bits
    for m, case in ((GEN_M, "plain"), (512, "closure")):
        p, _ = generic_problem(torch, np, BA, dev, 4096, m, 4, 3, case,
                               noise=0.3)
        for linalg in ("lu", "chol"):
            ref = BG.lm_generic(p, 3, GEN_HUBER, 1e-3, linalg, trace=True)
            for budget in (128 + 256, 128 + 4096):
                got = BG.lm_generic(p, 3, GEN_HUBER, 1e-3, linalg,
                                    trace=True, smem=budget)
                check(all(same_bits(torch, a, b) for a, b in zip(
                    got[:3] + tuple(got[3])[:-1],
                    ref[:3] + tuple(ref[3])[:-1]))
                      and BG.routes_of_trace(got[3]) == BG.k9_routes(
                          m, int(got[3].band), linalg, budget),
                      f"K9 (M {m} {case}, {linalg}) with its routes chosen "
                      f"for {budget} bytes is not the bits of the card's "
                      "routes")
    print("phase 16a: K9 with every stage's route chosen for 256 and 4096 "
          "bytes of shared memory, at M 128 and a closure over 512 poses, "
          "LU and Cholesky: the bits of the card's routes", flush=True)
    # slam_run with a ring of 48 keyframes, its last window held by k9_check
    ring, last, kw = phase_ring20(torch, np, BA, KN, dev, ring=BACK_RING,
                                  phase="16a")
    m = last.poses.shape[-3]
    if last.landmarks.dim() == 3:          # the run's one stream
        last = BA.BATracks(*(t if i == 5 else t[0]
                             for i, t in enumerate(last)))
    gp = last._replace(obs_pose=torch.arange(
        m, dtype=torch.int32, device=dev).expand(last.obs_valid.shape)
        .contiguous())
    check(kw.get("huber", GEN_HUBER) == GEN_HUBER and kw["ring_layout"],
          f"the ring-{BACK_RING} window's arguments {kw}")
    nums, _ = k9_check(torch, BA, BG, KN, gp, kw["iters"],
                       kw.get("lam0", 1e-3), kw["linalg"],
                       f"the ring-{BACK_RING} window")
    ring["window_check"] = {k_: v for k_, v in nums.items()
                            if k_ != "accept"}
    print(f"phase 16a: K9 on the last ring-{BACK_RING} window (N "
          f"{gp.landmarks.shape[0]}, M {m}) held to its plain version: "
          f"S {nums['S_rel_err']:.3g}, cost {nums['cost_rel_err']:.3g}, "
          f"last cost {nums['lm_last_cost_above']:.3g} of the first above "
          f"the plain loop's, poses {nums['lm_pose_err']:.3g}", flush=True)
    out["ring48"] = ring
    return out


def back_k8(torch, np, dev, smi: str) -> dict:
    """Phase 16b: K8 past its old 16384 detections. ``slam_run`` at
    1920x1080 with ``capacity`` and ``detect_k`` 20736 (a 10 px cell a
    detection) and recovery on, for ``BACK_FRAMES`` frames of phase 6's
    scene recipe, then ``relocalize`` on its last frame: every K8 call at
    Q 20736 (the staged route fits it on the H100), the last archive PnP
    and the relocalization held to ``_map_vote_pnp_plain`` by ``k8_check``
    (shifts, j1, uv1, inl bit-equal, T and err within 1e-4, n equal); then
    Q 65536 synthetic detections (the device route) the same way. Device
    ms, the plain version's ms and K8's bound for each."""
    import importlib
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    MV = importlib.import_module("vpp_tpu_torch.slam.map_vote")
    SP = importlib.import_module("vpp_tpu_torch.slam.pipeline")
    KN = importlib.import_module("vpp_tpu_torch.kernels")
    bw, bh = BACK_BIG
    cfg = dataclasses.replace(
        slam_config(), intrinsics=BACK_INTR, enable_recovery=True,
        tracker=VideoExtruderConfig(capacity=BACK_Q, detect_k=BACK_Q,
                                    nscales=3, winsize=9,
                                    keypoint_spacing=10, detector_period=1,
                                    detector_th=10))
    cloud = make_cloud(6000, seed=1, extent=(16.0, 5.0, 3.5),
                       center=(3.2, 0.0, 5.0))
    gt = camera_path(BACK_FRAMES, step=(0.02, 0.0, 0.0))
    frames = render_frames(cloud, gt, BACK_INTR, (bh, bw), seed=1,
                           sigma=(1.2, 2.2))
    calls = []
    vote = SP.map_vote_pnp

    def capture(*a, **kw):
        calls.append((a, kw))
        return vote(*a, **kw)

    SP.map_vote_pnp = capture
    try:
        KN.reset_launch_counts()
        st = SP.slam_run(torch.from_numpy(frames).to(dev), cfg,
                         bootstrap_poses=gt[[0, cfg.keyframe_period]],
                         device="cuda")
        frame = from_array(torch.from_numpy(frames[-1]).to(dev), border=9,
                           border_mode="mirror")
        SP.relocalize(st, frame, cfg)
        torch.cuda.synchronize()
        counts = KN.launch_counts()
    finally:
        SP.map_vote_pnp = vote
    qs = sorted({a[3].shape[0] for a, _ in calls})
    check(len(calls) >= 2 and qs == [BACK_Q]
          and counts["map_vote"] == len(calls),
          f"the 1080p run made {len(calls)} map-vote calls at Q {qs}, "
          f"{counts['map_vote']} K8 launches")
    out = {}
    synth = pnp_inputs(torch, np, dev, 1024, BACK_Q_SYNTH, 2, "random", 16)
    for name, (ops, kw) in (("archive_q20736", calls[-2]),
                            ("relocalize_q20736", calls[-1]),
                            ("synthetic_q65536", (synth, K8_KW))):
        q = ops[3].shape[0]
        route = MV.k8_route(q, MV.smem_bytes(dev))
        diff, want = k8_check(torch, MV, ops, kw, name)
        dms, by = device_ms(torch, lambda: MV.map_vote_pnp(*ops, **kw),
                            calls=3, replays=3)
        plain = cuda_ms(torch, lambda: MV._map_vote_pnp_plain(*ops, **kw), 1,
                        warmup=1)
        (b_ms, b_by), _, _ = k8_bound(torch, MV, ops, want, kw)
        out[name] = dict(q=q, a=ops[0].shape[0], b=ops[2].shape[0],
                         route=route, max_abs_err=diff, device_ms=dms,
                         device_ms_by=by, plain_ms=plain, bound_ms=b_ms,
                         bound_by=b_by, n=want.n.tolist())
        print(f"phase 16b: K8 {name} (A {ops[0].shape[0]}, Q {q}, B "
              f"{ops[2].shape[0]}; {smi}): route {route}, shifts, j1, uv1, "
              f"inl bit-equal to the plain version, T and err within "
              f"{diff:.3g}, n {want.n.tolist()}; {dms:.4f} ms on the device "
              f"({by}), plain {plain:.2f} ms, bound {b_ms:.5f} ({b_by})",
              flush=True)
    check(out["synthetic_q65536"]["route"] == "device",
          "K8 at Q 65536 did not take its device route")
    out["slam_1080p"] = dict(frames=BACK_FRAMES,
                             keyframes=st.n_keyframes,
                             map_vote_calls=len(calls), launches={
                                 k: v for k, v in counts.items() if v})
    return out


def back_k4(torch, np, dev, smi: str) -> dict:
    """Phase 16d: K4 on a 1x640 and a 480x1 frame (1-pixel levels, every
    tap folded onto the one pixel): one launch a pyramid, bit-equal to
    ``pyramid_plain`` on integer-valued frames and within 1e-6 relative on
    float ones (phase 3's K4 rule), timed on the device."""
    import importlib
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    rng = np.random.RandomState(16)
    out = {}
    for shape in ((1, 640), (480, 1)):
        shapes = PY.level_shapes(shape, 3)
        for kind in ("integer", "float"):
            a = rng.randint(0, 256, shape) if kind == "integer" else (
                rng.rand(*shape) * 255)
            a = torch.from_numpy(a.astype(np.float32)).to(dev)
            reset_launch_counts()
            got = PY.pyramid(PY.Image2d(data=a, border=0), 3, border=3)
            check(launch_counts()["pyramid_decim"] == 1,
                  f"K4 on a {shape} frame is not one launch")
            want = PY.pyramid_plain(a, shapes, 3)
            if kind == "integer":
                ok = all(same_bits(torch, g.data, w.data)
                         for g, w in zip(got.levels, want))
            else:
                ok = all(rel_err(g.data, w.data) <= 1e-6
                         for g, w in zip(got.levels, want))
            check(ok, f"K4 on a {kind} {shape} frame differs from its "
                  "plain version")
        dms, by = device_ms(torch, lambda a=a: PY._k4(a, shapes, 3, 0))
        out[f"{shape[0]}x{shape[1]}"] = dict(levels=[list(s) for s in shapes],
                                              device_ms=dms, device_ms_by=by)
    print(f"phase 16d: K4 on 1x640 and 480x1 frames ({smi}): levels "
          + "; ".join(f"{k} {v['levels']} {v['device_ms']:.4f} ms on the "
                      f"device" for k, v in out.items())
          + ", bit-equal to the plain chain on integer-valued frames, "
          "within 1e-6 relative on float ones", flush=True)
    return out


def phase_back_end(torch, np, dev, results, smi):
    """Phase 16: the back-end configurations past the kernels' old limits
    on the card: K9 (16a), K8 (16b), K1's chained select launch (16c) and
    K4's 1-pixel levels (16d). Returns the numbers it prints."""
    import importlib
    from vpp_tpu_torch.algorithms.pyramid import pyramid
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.utils.clips import make_clip
    BA = importlib.import_module("vpp_tpu_torch.slam.ba")
    BG = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
    KN = importlib.import_module("vpp_tpu_torch.kernels")
    out = {"k9": back_k9(torch, np, BA, BG, KN, dev, smi)}
    out["k8"] = back_k8(torch, np, dev, smi)
    # -- 16c. semi_dense_optical_flow at 48 propagation passes --------------
    cfg = dataclasses.replace(bench_tracker_config(), propagation=BACK_PROP)
    clip = make_clip(W, H, 3, seed=0)
    b = max(3, cfg.winsize)
    p1, p2 = (pyramid(from_array(torch.from_numpy(clip[i]).to(dev), border=b,
                                 border_mode="mirror"), cfg.nscales,
                      border=b) for i in (0, 2))
    rng = np.random.RandomState(16)
    pos = torch.from_numpy((rng.rand(SLICE_C_KP, 2) * [H - 1, W - 1]).astype(
        np.float32)).to(dev)
    valid = torch.ones(SLICE_C_KP, dtype=torch.bool, device=dev)
    out["k1"] = front_flow(torch, p1, p2, cfg, 5, pos, valid, smi,
                           phase="16c")
    out["k4"] = back_k4(torch, np, dev, smi)
    # the kernels line's rows
    k9 = {f"{name}_{la}": out["k9"][name][la] for name in BACK_K9
          for la in ("lu", "chol")}
    results["ba_generic"]["device_ms_past_old_limits"] = {
        k: v["device_ms"] for k, v in k9.items()}
    results["ba_generic"]["plain_ms_past_old_limits"] = {
        k: v["plain_ms"] for k, v in k9.items()}
    results["ba_generic"]["bound_ms_past_old_limits"] = {
        k: v["bound_ms"] for k, v in k9.items()}
    results["ba_generic"]["routes_past_old_limits"] = {
        k: v["routes"] for k, v in k9.items()}
    results["ba_generic"]["ring48_window_device_ms"] = \
        out["k9"]["ring48"]["window_device_ms"]
    results["map_vote"]["past_old_limit"] = {
        k: {q: v[q] for q in ("q", "route", "device_ms", "plain_ms",
                              "bound_ms", "bound_by", "max_abs_err")}
        for k, v in out["k8"].items() if k != "slam_1080p"}
    results["flow_level"]["device_ms_propagation48"] = \
        out["k1"]["k1_device_ms"]
    results["flow_level"]["launches_propagation48"] = out["k1"]["launches"]
    results["pyramid_decim"]["device_ms_one_pixel_levels"] = {
        k: v["device_ms"] for k, v in out["k4"].items()}
    return out


def sfm_scene(np, m: int = 8, seed: int = 0):
    """tests/test_sfm.py:39's 3-D segments in front of the camera."""
    rng = np.random.RandomState(seed)
    p1 = rng.rand(m, 3) * [2, 1.5, 1] + [-1, -0.75, 3]
    d = rng.randn(m, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p1.astype(np.float32), (p1 + d * 0.8).astype(np.float32)


def same_bits(torch, a, b) -> bool:
    """Bit-identical float32 tensors (NaN included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    import vpp_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vpp_tpu_torch.algorithms import fast as F
    from vpp_tpu_torch.algorithms import flow as FL
    from vpp_tpu_torch.algorithms import hough as HG
    from vpp_tpu_torch.algorithms import hough_cuda as HC
    from vpp_tpu_torch.algorithms.hough_tracker import (
        HoughTrackerConfig, hough_tracker_init, hough_tracker_update)
    from vpp_tpu_torch import convert
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    from vpp_tpu_torch.algorithms.pyramid import level_shapes, pyramid
    from vpp_tpu_torch.algorithms import video_extruder as VE
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig, video_extruder_run)
    from vpp_tpu_torch.core import interp as IP
    from vpp_tpu_torch.core.image import Image2d, from_array, pad_index
    from vpp_tpu_torch.kernels import (_build, launch_counts,
                                       reset_launch_counts)
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.slam import ba_cuda as BC
    from vpp_tpu_torch.slam import ba_generic_cuda as BG
    from vpp_tpu_torch.slam import map_vote as MV
    from vpp_tpu_torch.slam import pipeline as SP
    from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    _build.build()
    print(_build.build_log)
    _build.load()
    print(f"phase 2: kernels built in {_build.build_seconds:.2f} s")

    cfg = VideoExtruderConfig(capacity=4096, detect_k=2048, nscales=3,
                              winsize=9, keypoint_spacing=10,
                              detector_period=5, detector_th=10)
    b = max(3, cfg.winsize)
    clip = make_clip(W, H, TRACK_FRAMES, seed=0)
    results = {}

    # -- 3a. K2 fast9: the full map and the cull (the score image follows the
    # SLAM warm-up in 3g, with that frame's occupancy mask) ----------------
    th = cfg.detector_th
    img = from_array(torch.from_numpy(clip[3]).to(dev), border=b,
                     border_mode="mirror")
    reset_launch_counts()
    sk, dk = F.fast9_cuda(img, th, detect=True)
    check(launch_counts()["fast9"] == 1, "K2's full map is not one launch")
    sp, dp = F.fast9_plain(img, th, detect=True)
    torch.cuda.synchronize()
    k2_err = int((sk - sp).abs().max())
    check(torch.equal(sk, sp) and torch.equal(dk, dp),
          "K2 fast9 differs from its plain version")
    # the cull at the tracker's 4096 slots, after 6 frames of the clip
    cull_state, _ = video_extruder_run(clip[:6], cfg, device="cuda")
    cull_pos = cull_state.keypoints.position
    cull_img = from_array(torch.from_numpy(clip[5]).to(dev), border=b,
                          border_mode="mirror")
    reset_launch_counts()
    ck = F.fast9_cull_scores(cull_img, cull_pos, th)
    check(launch_counts()["fast9"] == 1, "K2's cull is not one launch")
    cp = F.fast9_cull_scores_plain(cull_img, cull_pos, th)
    check(torch.equal(ck, cp), "K2's cull differs from its plain version")
    k2_err = max(k2_err, int((ck - cp).abs().max()))
    n_slots = cull_pos.shape[0]
    k2_pixel_ops = H * W * (16 * 8 + 20)
    k2_modes = {
        "full": (lambda: F.fast9_cuda(img, th),
                 lambda: F.fast9_plain(img, th),
                 img.data.numel() * 4 + H * W * (4 + 1), k2_pixel_ops),
        "cull": (lambda: F.fast9_cull_scores(cull_img, cull_pos, th),
                 lambda: F.fast9_cull_scores_plain(cull_img, cull_pos, th),
                 n_slots * (8 + 17 * 4 + 4), n_slots * (16 * 8 + 30))}

    def k2_time(mode, fn, plain, nbytes, ops):
        r = results["fast9"]
        r["ms_per_mode"][mode] = cuda_ms(torch, fn, 200)
        r["plain_ms_per_mode"][mode] = cuda_ms(torch, plain, 20)
        r["bound_ms_per_mode"][mode] = bound_ms(nbytes, ops)[0]
        r["device_ms_per_mode"][mode], r["device_ms_by"] = device_ms(
            torch, fn)

    results["fast9"] = dict(
        name="fast9", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/fast9.cu",
        replaces="vpp_tpu/algorithms/fast.py:81",
        max_abs_err=float(k2_err),
        modes="ms, device_ms, plain_ms and bound_ms are the full map's; "
              "each mode's under *_per_mode",
        ms_per_mode={}, plain_ms_per_mode={}, bound_ms_per_mode={},
        device_ms_per_mode={}, library_ms=None)
    for mode, args in k2_modes.items():
        k2_time(mode, *args)
    k2 = results["fast9"]
    k2["ms"], k2["plain_ms"] = k2["ms_per_mode"]["full"], \
        k2["plain_ms_per_mode"]["full"]
    k2["device_ms"] = k2["device_ms_per_mode"]["full"]
    k2["bound_ms"], k2["bound_by"] = bound_ms(*k2_modes["full"][2:])
    print("phase 3: K2 fast9 full map and cull bit-equal, one launch each; "
          f"{int(dk.sum())} corners, {n_slots} slots; "
          + ", ".join(f"{m} {k2['ms_per_mode'][m]:.4f} ms as called, "
                      f"{k2['device_ms_per_mode'][m]:.4f} on the device "
                      f"(bound {k2['bound_ms_per_mode'][m]:.5f})"
                      for m in k2_modes))

    # -- 3b. K1 flow level, every level of a 640x480 pyramid ------------------
    p1 = pyramid(from_array(torch.from_numpy(clip[0]).to(dev), border=b,
                            border_mode="mirror"), cfg.nscales, border=b)
    p2 = pyramid(from_array(torch.from_numpy(clip[2]).to(dev), border=b,
                            border_mode="mirror"), cfg.nscales, border=b)
    grid = level_shapes((H // cfg.patchsize, W // cfg.patchsize),
                        cfg.nscales)
    radii = FL._level_radii(cfg.nscales, 5, 1)
    bounds = FL._level_bounds(cfg.nscales, radii)
    level_args, k1_err, k1_ties = [], 0.0, 0
    k1_bytes = k1_ops = k1_ops_full = 0
    props = cfg.propagation
    pred = None
    for s in range(cfg.nscales - 1, -1, -1):
        h, w = p1[s].shape
        gh, gw = grid[s]
        if pred is None:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)
        else:
            cgh, cgw = grid[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flow_k[ir[:, None], ic[None, :]]
        g = FL.LevelGeometry(b=b, h=h, w=w, ws=cfg.winsize,
                             patch=cfg.patchsize, gh=gh, gw=gw, R=radii[s],
                             pred_bound=0 if s == cfg.nscales - 1
                             else 2 * bounds[s + 1])
        a1, a2 = p1[s].data, p2[s].data
        fk, dk1, vk = FL.flow_match(a1, a2, pred, g)
        fp, dp1, vp = FL.flow_match_plain(a1, a2, pred, g)
        torch.cuda.synchronize()
        two = torch.topk(vp, 2, dim=0, largest=False).values
        clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
        k1_ties += int((~clear).sum())
        check(bool(((fk == fp).all(-1) | ~clear).all()),
              f"K1 flow differs from its plain version at level {s}")
        check(torch.equal((dk1 >= 1e29)[clear], (dp1 >= 1e29)[clear]),
              f"K1 in-domain rejection differs at level {s}")
        fin = clear & (dp1 < 1e29)
        rel = ((dk1 - dp1).abs() / dp1.abs().clamp(min=1e-30))[fin]
        check(rel.numel() == 0 or float(rel.max()) <= 1e-5,
              f"K1 dist off by rtol {float(rel.max())} at level {s}")
        check(bool(((vk - vp).abs()
                    <= 1e-5 * vp.abs().clamp(min=1e-30)).all()),
              f"K1 volume differs at level {s}")
        if fin.any():
            k1_err = max(k1_err, float((dk1 - dp1).abs()[fin].max()))
        # propagation: equal inputs must give equal outputs, pass by pass
        # and with every pass in one launch
        f_in, d_in = fp, dp1
        for _ in range(props):
            fpk, dpk = FL.flow_propagate(f_in, d_in, pred, vp, g.R)
            fpp, dpp = FL.flow_propagate_plain(f_in, d_in, pred, vp, g.R)
            check(torch.equal(fpk, fpp) and torch.equal(dpk, dpp),
                  f"K1 propagation differs at level {s}")
            f_in, d_in = fpp, dpp
        fpk, dpk = FL.flow_propagate(fp, dp1, pred, vp, g.R, iters=props)
        check(torch.equal(fpk, f_in) and torch.equal(dpk, d_in),
              f"K1 fused propagation differs at level {s}")
        # integer-valued buffers make every sum exact: the whole level must
        # be bit-equal, ties included
        i1, i2 = a1.round(), a2.round()
        fik, dik, vik = FL.flow_match(i1, i2, pred, g)
        fip, dip, vip = FL.flow_match_plain(i1, i2, pred, g)
        check(torch.equal(vik, vip) and torch.equal(fik, fip)
              and torch.equal(dik, dip),
              f"K1 match not bit-equal on integer buffers at level {s}")
        for _ in range(props):
            fip, dip = FL.flow_propagate_plain(fip, dip, pred, vip, g.R)
        fik, dik = FL.flow_level(i1, i2, pred, g, props)
        check(torch.equal(fik, fip) and torch.equal(dik, dip),
              f"K1 level not bit-equal on integer buffers at level {s}")
        flow_k, _ = FL.flow_level(a1, a2, pred, g, props)
        level_args.append((s, a1, a2, pred, g))
        d2 = (2 * g.R + 1) ** 2
        ws = cfg.winsize
        lr, lc = (gh - 1) * g.patch + ws, (gw - 1) * g.patch + ws
        k1_bytes += a1.numel() * 4 * 2 + gh * gw * (8 + 8 + 4)
        k1_ops += (d2 * (lr * lc * 2 + gh * lc * (ws - 1)
                         + gh * gw * (ws - 1))
                   + gh * gw * (d2 - 1) + props * gh * gw * 8 * 12)
        k1_ops_full += d2 * gh * gw * ws ** 2 * 6 + props * gh * gw * 8 * 12

    def k1_frame(fn):
        def run():
            for _, a1, a2, pr, g in level_args:
                fn(a1, a2, pr, g)
        return run

    def plain_level(a1, a2, pr, g):
        f, d, v = FL.flow_match_plain(a1, a2, pr, g)
        for _ in range(props):
            f, d = FL.flow_propagate_plain(f, d, pr, v, g.R)

    k1_levels = {}
    for s, a1, a2, pr, g in level_args:
        k1_levels[f"level{s}_{g.gh}x{g.gw}"], k1_by = device_ms(
            torch, lambda a1=a1, a2=a2, pr=pr, g=g: FL.flow_level(
                a1, a2, pr, g, props))
    results["flow_level"] = dict(
        name="flow_level", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/flow_level.cu",
        replaces="vpp_tpu/algorithms/flow.py:224",
        max_abs_err=k1_err,
        ms=cuda_ms(torch, k1_frame(
            lambda a1, a2, pr, g: FL.flow_level(a1, a2, pr, g, props)), 50),
        plain_ms=cuda_ms(torch, k1_frame(plain_level), 5),
        library_ms=None,
        device_ms=sum(k1_levels.values()), device_ms_by=k1_by,
        device_ms_per_level=k1_levels)
    results["flow_level"]["bound_ms"], results["flow_level"]["bound_by"] = \
        bound_ms(k1_bytes, k1_ops)
    k1_bound_full = bound_ms(k1_bytes, k1_ops_full)[0]
    print(f"phase 3: K1 flow level holds on {cfg.nscales} levels "
          f"({k1_ties} near-tie cells excluded), bit-equal on integer "
          f"buffers; per frame {results['flow_level']['ms']:.4f} ms as "
          f"called, {results['flow_level']['device_ms']:.4f} ms on the "
          f"device ({k1_by}; per level "
          + ", ".join(f"{k} {v:.4f}" for k, v in k1_levels.items())
          + f"), bound {results['flow_level']['bound_ms']:.5f} ms "
          f"({results['flow_level']['bound_by']}; every window in full: "
          f"{k1_bound_full:.5f} ms)")

    # -- 3c. K7 Hough accumulator ---------------------------------------------
    lines = synthetic_line_clip(W, H, HOUGH_FRAMES)
    hcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    himg = from_array(torch.from_numpy(lines[5]).to(dev), border=3,
                      border_mode="mirror")
    t0i, r0i, ft, fr, wgt, rho_bins = HG._vote_bins(
        himg, hcfg.t_theta, None, hcfg.grad_threshold, "binary", None)
    th_n = (t0i.float() + ft).reshape(-1)
    rho_n = (r0i.float() + fr).reshape(-1)
    wv = wgt.reshape(-1).contiguous()
    tt = hcfg.t_theta
    acc1 = HC.hough_acc(th_n, rho_n, wv, tt, rho_bins)
    acc2 = HC.hough_acc(th_n, rho_n, wv, tt, rho_bins)
    accp = HC.hough_acc_plain(th_n, rho_n, wv, tt, rho_bins)
    torch.cuda.synchronize()
    check(torch.equal(acc1, acc2), "K7 is not bit-reproducible")
    reset_launch_counts()
    k7_ops = graph_ops(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt,
                                                    rho_bins))
    # two wrapper launches: graph_ops' warm-up call and the captured one
    check(k7_ops == {"kernel": 1} and launch_counts()["hough_acc"] == 2,
          f"K7 is not one device kernel a call: {k7_ops}, "
          f"{launch_counts()['hough_acc']} launches")
    k7_err = float((acc1 - accp).abs().max())
    check(k7_err <= 1e-4 * float(accp.max()),
          f"K7 off by {k7_err} (max {float(accp.max())})")
    # per cell against a float64 sum of the same float32 votes: the fixed
    # point rounds each of the cell's n votes by at most 2^-25 and the
    # conversion to float32 by at most 2^-24 relative; any vote lost or sent
    # to another cell shows above that
    idx, vals = bilinear_votes(torch, th_n, rho_n, wv, tt, rho_bins)
    voting = (wv != 0).repeat(4)
    k7_exact = torch.zeros((tt * rho_bins,), dtype=torch.float64,
                           device=dev).index_add_(0, idx[voting],
                                                  vals[voting].double())
    k7_nvotes = torch.bincount(idx[voting], minlength=tt * rho_bins)
    k7_slack = k7_nvotes * 2.0 ** -25 + k7_exact.abs() * 2.0 ** -24 + 1e-12
    k7_dev = (acc1.double().reshape(-1) - k7_exact).abs()
    k7_over = float((k7_dev - k7_slack).max())
    check(k7_over <= 0.0,
          f"K7 exceeds its fixed-point error bound by {k7_over}")
    # the library yardstick: one index_put_ of the 4N votes
    lib_acc = torch.zeros((tt * rho_bins,), dtype=torch.float32, device=dev)
    n_edge = int((wv != 0).sum())
    results["hough_acc"] = dict(
        name="hough_acc", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/hough_acc.cu",
        replaces="vpp_tpu/algorithms/hough_pallas.py:68",
        max_abs_err=k7_err,
        ms=cuda_ms(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt,
                                               rho_bins), 200),
        plain_ms=cuda_ms(torch, lambda: HC.hough_acc_plain(
            th_n, rho_n, wv, tt, rho_bins), 50),
        library_ms=cuda_ms(torch, lambda: lib_acc.index_put_(
            (idx,), vals, accumulate=True), 50))
    k7_bytes, k7_sectors = k7_bound_bytes(torch, th_n, rho_n, wv, tt,
                                          rho_bins)
    results["hough_acc"]["bound_ms"], results["hough_acc"]["bound_by"] = \
        bound_ms(k7_bytes, n_edge * 20)
    results["hough_acc"]["device_ms"], results["hough_acc"]["device_ms_by"] = \
        device_ms(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt, rho_bins))
    results["hough_acc"]["library_device_ms"] = device_ms(
        torch, lambda: lib_acc.index_put_((idx,), vals, accumulate=True))[0]
    results["hough_acc"]["device_ops"] = k7_ops
    print(f"phase 3: K7 hough_acc one device kernel a call "
          f"(one kernel node in the call's CUDA graph, no memset), "
          f"reproducible, err "
          f"{k7_err:.3g} of max "
          f"{float(accp.max()):.1f}, {n_edge} voting pixels "
          f"({k7_sectors} sectors of th and rho; bound "
          f"{results['hough_acc']['bound_ms']:.5f} ms for {k7_bytes} "
          "bytes), "
          f"{results['hough_acc']['ms']:.4f} ms as called, "
          f"{results['hough_acc']['device_ms']:.4f} ms on the device; off "
          "the float64 scatter "
          f"by {float(k7_dev.max()):.3g}, every cell within its bound "
          f"(largest bound {float(k7_slack.max()):.3g})")

    # -- 3d-3g: the SLAM path's kernels, on the SLAM clip ---------------------
    slam_cfg = slam_config()
    t0 = time.perf_counter()
    slam_frames, gt_poses = slam_clip(SLAM_FRAMES)
    print(f"phase 3: rendered {SLAM_FRAMES} SLAM frames in "
          f"{time.perf_counter() - t0:.1f} s")
    sb = max(3, slam_cfg.tracker.winsize)
    sframe = from_array(torch.from_numpy(slam_frames[100]).to(dev), border=sb,
                        border_mode="mirror")

    # -- 3d. K3 block top-K ---------------------------------------------------
    bs, kdet = slam_cfg.tracker.keypoint_spacing, slam_cfg.tracker.detect_k
    simg = F.fast9_score_image(sframe, slam_cfg.tracker.detector_th)
    reset_launch_counts()
    k3_out = F._blockwise_keypoints(simg, bs, kdet)
    check(launch_counts()["block_topk"] == 1, "K3 is not one launch a call")
    k3_plain = F._blockwise_keypoints_plain(simg, bs, kdet)
    check(all(torch.equal(a, b) for a, b in zip(k3_out, k3_plain)),
          "K3 block top-K differs from its plain version (640x480)")
    rng = np.random.RandomState(3)

    def score_image(h, w, kind):
        if kind == "random":
            a = rng.randint(1, 256, (h, w)) * (rng.rand(h, w) > 0.5)
        else:   # three scores: long runs of ties across the CTAs' ranges
            a = rng.choice([0, 0, 7, 200], (h, w))
        return from_array(torch.from_numpy(a.astype(np.uint8)).to(dev),
                          border=1)

    k3_sizes = {}
    for h, w, b3, kind in ((400, 400, 2, "random"), (400, 400, 2, "ties"),
                           (2160, 3840, 10, "random"),
                           (2160, 3840, 10, "ties")):
        big = score_image(h, w, kind)
        nb3 = -(-h // b3) * -(-w // b3)
        for dt in (torch.uint8, torch.int32):
            img3 = from_array(big.interior.to(dt), border=1)
            check(all(torch.equal(a, b) for a, b in zip(
                F._blockwise_keypoints(img3, b3, 4096),
                F._blockwise_keypoints_plain(img3, b3, 4096))),
                  f"K3 differs from its plain version at {nb3} blocks "
                  f"({kind}, {dt})")
        if kind == "random":
            k3_sizes[f"device_ms_{nb3}_blocks"] = device_ms(
                torch, lambda big=big, b3=b3: F._blockwise_keypoints(
                    big, b3, 4096))[0]
    nbr, nbc = -(-H // bs), -(-W // bs)
    nb = nbr * nbc
    pad_scores = PY.pad2d(simg.interior.to(torch.int32), 0, nbr * bs - H, 0,
                          nbc * bs - W, "constant", -1)
    keys = torch.randint(-nb, 255 * nb, (nb,), dtype=torch.int32, device=dev)

    def k3_library():
        pad_scores.view(nbr, bs, nbc, bs).permute(0, 2, 1, 3).reshape(
            nbr, nbc, bs * bs).argmax(-1)
        torch.topk(keys, kdet, sorted=True)

    results["block_topk"] = dict(
        name="block_topk", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/block_topk.cu",
        replaces="vpp_tpu/algorithms/fast.py:185", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: F._blockwise_keypoints(simg, bs, kdet),
                   200),
        plain_ms=cuda_ms(torch, lambda: F._blockwise_keypoints_plain(
            simg, bs, kdet), 50),
        library_ms=cuda_ms(torch, k3_library, 50))
    results["block_topk"]["bound_ms"], results["block_topk"]["bound_by"] = \
        bound_ms(simg.data.numel() + kdet * 13, H * W + nb)
    results["block_topk"]["device_ms"], \
        results["block_topk"]["device_ms_by"] = device_ms(
            torch, lambda: F._blockwise_keypoints(simg, bs, kdet))
    results["block_topk"]["library_device_ms"] = device_ms(torch,
                                                           k3_library)[0]
    results["block_topk"].update(k3_sizes)
    print(f"phase 3: K3 block top-K bit-equal, one launch a call "
          f"({int(k3_out[2].sum())} valid of {kdet}; and at 40000 and 82944 "
          f"blocks, random and tied scores, uint8 and int32), "
          f"{results['block_topk']['ms']:.4f} ms as called, "
          f"{results['block_topk']['device_ms']:.4f} ms on the device at "
          f"{nb} blocks; " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in k3_sizes.items()))

    # -- 3e. K4: the whole pyramid from the raw frame in one launch -------
    shapes3 = level_shapes((H, W), 3)
    k4_err = 0.0
    rng4 = np.random.RandomState(4)
    for hh, ww in ((H, W), (357, 493)):
        shp = level_shapes((hh, ww), 3)
        for kind in ("integer", "float"):
            a = torch.from_numpy(
                rng4.randint(0, 256, (hh, ww)).astype(np.float32)
                if kind == "integer" else
                slam_frames[100] if (hh, ww) == (H, W) else
                (rng4.rand(hh, ww) * 255 + 1).astype(np.float32)).to(dev)
            want = PY.pyramid_plain(a, shp, sb)
            for src in ("raw", "bordered"):
                src_img = (Image2d(data=a, border=0) if src == "raw" else
                           from_array(a, border=sb, border_mode="mirror"))
                reset_launch_counts()
                got = pyramid(src_img, 3, border=sb)
                check(launch_counts()["pyramid_decim"] == 1,
                      f"K4 is not one launch a pyramid ({hh}x{ww}, {src})")
                for lvl, (g, wl) in enumerate(zip(got.levels, want)):
                    if kind == "integer":
                        check(torch.equal(g.data, wl.data),
                              f"K4 not bit-equal on integer frames at level "
                              f"{lvl} ({hh}x{ww}, {src})")
                        continue
                    rel = float(((g.data - wl.data).abs()
                                 / wl.data.abs().clamp(min=1e-30)).max())
                    check(rel <= 1e-6, f"K4 off by {rel} relative at level "
                          f"{lvl} ({hh}x{ww}, {src})")
                    k4_err = max(k4_err, float((g.data - wl.data).abs()
                                               .max()))
    raw = torch.from_numpy(slam_frames[100]).to(dev)
    raw_img = Image2d(data=raw, border=0)
    decim_mats = [(PY._decim_tensor(ph, oh, dev), PY._decim_tensor(pw, ow, dev))
                  for (ph, pw), (oh, ow) in zip(shapes3, shapes3[1:])]
    pad_idx = [(pad_index(oh, sb, sb, "symmetric", dev),
                pad_index(ow, sb, sb, "symmetric", dev))
               for oh, ow in shapes3]

    def k4_call():
        return pyramid(raw_img, 3, border=sb)

    def k4_library():
        """The PyTorch route: the index_select pad pair (index tensors made
        beforehand), and per level the banded matmul pair and the pad."""
        ri, ci = pad_idx[0]
        raw.index_select(0, ri).index_select(1, ci)
        cur = raw
        for (a, bm), (ri, ci) in zip(decim_mats, pad_idx[1:]):
            cur = a @ cur @ bm.T
            cur.index_select(0, ri).index_select(1, ci)

    def k4_parent_route():
        """The run loops' route before this kernel took the raw frame: the
        frame image (``from_array``), level 0 padded again, and one K4
        launch a level."""
        f = from_array(raw, border=sb, border_mode="mirror")
        lvl = Image2d(data=PY.pad2d(f.interior, sb, sb, sb, sb, "symmetric"),
                      border=sb)
        for oh, ow in shapes3[1:]:
            lvl = PY.decimate_level(lvl, oh, ow, sb)

    k4_bytes = 4 * (H * W + sum((oh + 2 * sb) * (ow + 2 * sb)
                                for oh, ow in shapes3))
    k4_ops = sum(2 * 5 * oh * (pw + ow)
                 for (ph, pw), (oh, ow) in zip(shapes3, shapes3[1:]))
    results["pyramid_decim"] = dict(
        name="pyramid_decim", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/pyramid_decim.cu",
        replaces="vpp_tpu/algorithms/pyramid.py:171",
        per="pyramid of a raw 640x480 frame, 3 levels, border 9",
        max_abs_err=k4_err, ms=cuda_ms(torch, k4_call, 200),
        plain_ms=cuda_ms(torch, lambda: PY.pyramid_plain(raw, shapes3, sb),
                         50),
        library="index_select pads and banded torch.matmul pairs",
        library_ms=cuda_ms(torch, k4_library, 50),
        parent_route="from_array, a second pad of level 0, one K4 launch a "
                     "level",
        parent_route_ms=cuda_ms(torch, k4_parent_route, 200),
        device_ops=sum(graph_ops(torch, k4_call).values()),
        parent_route_device_ops=sum(graph_ops(
            torch, k4_parent_route).values()))
    r4 = results["pyramid_decim"]
    r4["bound_ms"], r4["bound_by"] = bound_ms(k4_bytes, k4_ops)
    r4["device_ms"], r4["device_ms_by"] = device_ms(torch, k4_call)
    r4["library_device_ms"] = device_ms(torch, k4_library)[0]
    r4["parent_route_device_ms"] = device_ms(torch, k4_parent_route)[0]
    check(r4["device_ops"] == 1, f"K4's pyramid ran {r4['device_ops']} "
          "device operations, not one kernel")
    print(f"phase 3: K4 whole pyramid one launch, bit-equal on integer "
          f"frames (640x480 and 357x493, raw and bordered), float err "
          f"{k4_err:.3g}; {r4['ms']:.4f} ms as called, "
          f"{r4['device_ms']:.4f} ms on the device (bound "
          f"{r4['bound_ms']:.5f}); the library route "
          f"{r4['library_device_ms']:.4f} on the device; the parent's route "
          f"({r4['parent_route_device_ops']} device ops) "
          f"{r4['parent_route_ms']:.4f} ms as called, "
          f"{r4['parent_route_device_ms']:.4f} on the device")

    # -- 3f. K5 patches, from centres ----------------------------------------
    psize = slam_cfg.desc_patch
    ctr64 = torch.from_numpy(np.stack(
        [rng.randint(-4, H + 4, 1024), rng.randint(-4, W + 4, 1024)],
        -1)).to(dev) + sb
    ctr = ctr64.to(torch.int32)       # the SLAM path's centres are int32
    hb, wb = sframe.data.shape
    tl = IP._clamp_tl(ctr64 - psize // 2, hb, wb, psize)
    want = IP.extract_patches_at_tl_plain(sframe.data, tl, psize)
    for c in (ctr, ctr64):
        reset_launch_counts()
        got = IP.extract_patches(sframe.data, c, psize)
        check(launch_counts()["patches"] == 1,
              "K5 is not one launch a call")
        check(torch.equal(got, want) and torch.equal(
            IP.extract_patches_plain(sframe.data, c, psize), want),
              f"K5 patches differ from the plain version (1024 x 7x7, "
              f"{c.dtype} centres)")
    rgb = torch.from_numpy(rng.randint(0, 256, (hb, wb, 3)).astype(
        np.uint8)).to(dev)
    check(torch.equal(IP.extract_patches(rgb, ctr, psize),
                      IP.extract_patches_at_tl_plain(rgb, tl, psize)),
          "K5 patches differ from the plain version (3 channels)")
    ar = torch.arange(psize, device=dev)

    def k5_index():
        """The library call's index preparation from the same centres."""
        t = IP._clamp_tl(ctr.long() - psize // 2, hb, wb, psize)
        return (t[:, 0, None] + ar)[:, :, None], (t[:, 1, None] + ar)[:, None,
                                                                      :]

    rows, cols = k5_index()

    def k5_library():
        r, c = k5_index()
        return sframe.data[r, c]

    k5_call = lambda: IP.extract_patches(sframe.data, ctr, psize)  # noqa: E731
    results["patches"] = dict(
        name="patches", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/patches.cu",
        replaces="vpp_tpu/core/interp.py:61", max_abs_err=0.0,
        ms=cuda_ms(torch, k5_call, 200),
        plain_ms=cuda_ms(torch, lambda: IP.extract_patches_plain(
            sframe.data, ctr, psize), 50),
        library="advanced indexing from the same centres (index "
                "preparation and gather)",
        library_ms=cuda_ms(torch, k5_library, 200),
        library_index_ms=cuda_ms(torch, k5_index, 200),
        library_gather_ms=cuda_ms(torch, lambda: sframe.data[rows, cols],
                                  200))
    results["patches"]["bound_ms"], results["patches"]["bound_by"] = \
        bound_ms(1024 * (8 + 2 * 4 * psize * psize), 0)
    results["patches"]["device_ms"], results["patches"]["device_ms_by"] = \
        device_ms(torch, k5_call)
    results["patches"]["library_device_ms"] = device_ms(torch,
                                                        k5_library)[0]
    results["patches"]["library_gather_device_ms"] = device_ms(
        torch, lambda: sframe.data[rows, cols])[0]
    k5 = results["patches"]
    print(f"phase 3: K5 patches bit-equal from int32 and int64 centres, one "
          f"launch a call (1024 x {psize}x{psize}, and 3 channels); "
          f"{k5['ms']:.4f} ms as called, {k5['device_ms']:.4f} ms on the "
          f"device; the library from the same centres {k5['library_ms']:.4f} "
          f"ms as called (index preparation {k5['library_index_ms']:.4f}, "
          f"gather {k5['library_gather_ms']:.4f}), "
          f"{k5['library_device_ms']:.4f} ms on the device")
    # the archive PnP's shape: 512 detections of the SLAM frame, 9x9
    # (``_det_shift_patches``: desc_patch + 2)
    dpos = F.fast9(sframe, slam_cfg.tracker.detector_th, k=kdet,
                   blockwise=True, block_size=bs)[0] + sb
    dsz = psize + 2
    reset_launch_counts()
    got = IP.extract_patches(sframe.data, dpos, dsz)
    check(launch_counts()["patches"] == 1, "K5 is not one launch a call")
    check(torch.equal(got, IP.extract_patches_plain(sframe.data, dpos, dsz)),
          f"K5 patches differ from the plain version ({kdet} x {dsz}x{dsz})")
    ar9 = torch.arange(dsz, device=dev)

    def k5_library_9():
        t = IP._clamp_tl(dpos.long() - dsz // 2, hb, wb, dsz)
        return sframe.data[(t[:, 0, None] + ar9)[:, :, None],
                           (t[:, 1, None] + ar9)[:, None, :]]

    def k5_call_9():
        return IP.extract_patches(sframe.data, dpos, dsz)

    k5["shape_512x9x9"] = dict(
        ms=cuda_ms(torch, k5_call_9, 200),
        device_ms=device_ms(torch, k5_call_9)[0],
        plain_ms=cuda_ms(torch, lambda: IP.extract_patches_plain(
            sframe.data, dpos, dsz), 50),
        library_ms=cuda_ms(torch, k5_library_9, 200),
        library_device_ms=device_ms(torch, k5_library_9)[0],
        bound_ms=bound_ms(kdet * (8 + 2 * 4 * dsz * dsz), 0)[0])
    k59 = k5["shape_512x9x9"]
    print(f"phase 3: K5 bit-equal at {kdet} x {dsz}x{dsz} (the archive PnP's "
          f"detections), {k59['ms']:.4f} ms as called, "
          f"{k59['device_ms']:.4f} on the device (bound "
          f"{k59['bound_ms']:.5f}); the library {k59['library_ms']:.4f} / "
          f"{k59['library_device_ms']:.4f}")

    # -- 3g. K6 window BA, on a keyframe problem of a SLAM warm-up run --------
    slam_dev = torch.from_numpy(slam_frames).to(dev)  # upload outside timing
    boot = gt_poses[[0, slam_cfg.keyframe_period]]
    problems = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        problems.append(prob)
        return solve(prob, **kw)

    SP.ba_solve_tracks = capture
    try:
        warm = SP.slam_run(slam_dev[:SLAM_WARMUP], slam_cfg,
                           bootstrap_poses=boot, device="cuda")
    finally:
        SP.ba_solve_tracks = solve
    torch.cuda.synchronize()

    # K2's score image on the next SLAM frame, with the warm-up's occupancy
    # mask (the detection of the SLAM step)
    tcfg = slam_cfg.tracker
    occ = VE._occupancy_mask(warm.tracker.keypoints, (H, W),
                             tcfg.keypoint_spacing)
    nframe = from_array(slam_dev[SLAM_WARMUP], border=sb,
                        border_mode="mirror")
    reset_launch_counts()
    si_k = F.fast9_score_image(nframe, tcfg.detector_th, mask=occ)
    check(launch_counts()["fast9"] == 1, "K2's score image is not one launch")
    si_p = F.fast9_score_image_plain(nframe, tcfg.detector_th, mask=occ)
    check(si_k.border == 1 and torch.equal(si_k.data, si_p.data),
          "K2's score image differs from its plain version")
    # and on the textured tracker frame of 3a, with no mask and a bool mask
    rmask = torch.from_numpy(rng.rand(H, W) > 0.3).to(dev)
    for m in (None, rmask):
        check(torch.equal(F.fast9_score_image(img, th, mask=m).data,
                          F.fast9_score_image_plain(img, th, mask=m).data),
              "K2's score image differs from its plain version on the "
              "tracker frame")
    k2_time("score_image",
            lambda: F.fast9_score_image(nframe, tcfg.detector_th, mask=occ),
            lambda: F.fast9_score_image_plain(nframe, tcfg.detector_th,
                                              mask=occ),
            nframe.data.numel() * 4 + H * W + (H + 2) * (W + 2),
            k2_pixel_ops)
    print(f"phase 3: K2 score image bit-equal with the SLAM frame's "
          f"occupancy mask ({int(occ.sum())} of {H * W} pixels open, "
          f"{int(si_k.data.count_nonzero())} scores), one launch; "
          f"{k2['ms_per_mode']['score_image']:.4f} ms as called, "
          f"{k2['device_ms_per_mode']['score_image']:.4f} on the device "
          f"(bound {k2['bound_ms_per_mode']['score_image']:.5f})")
    prob = stream_problem(BA, problems[-1], 0)   # the keyframe's S = 1
    n_lm, m_kf = prob.obs_valid.shape
    iters, lam0 = slam_cfg.ba_iters, slam_cfg.ba_lam0
    huber, linalg = slam_cfg.ba_huber, slam_cfg.ba_linalg
    fixed = prob.fixed_poses

    def k6_check(pr, lam_0, what):
        """One fused call on ``pr``: one launch, the same bits twice, its
        trace's first-iteration system against the plain assembly, its
        first pose solve's backward error, and the result against the plain
        LM loop. Returns (numbers, trace)."""
        reset_launch_counts()
        out = BC.lm_tracks(pr, iters, huber, lam_0, linalg)
        check(launch_counts()["ba_tracks"] == 1,
              f"K6 ({what}) is not one launch a call")
        again = BC.lm_tracks(pr, iters, huber, lam_0, linalg)
        check(all(same_bits(torch, a, b) for a, b in zip(
            out[:3] + tuple(out[3]), again[:3] + tuple(again[3]))),
              f"K6 ({what}) is not bit-identical across two launches")
        poses, lms, costs, tr = out
        lam = torch.full((), lam_0, device=dev)
        (Sp, rp, cp), _ = BA._tracks_assemble(pr, lam, huber, True, linalg)
        s_rel = float((tr.S - Sp).abs().max()) / float(Sp.abs().max())
        c_rel = float((tr.cost - cp).abs()) / float(cp.abs())
        r_rel = float((tr.rhs - rp).abs().max()) / BA.rhs_term_scale(
            pr, huber, True)
        check(s_rel <= 1e-4 and c_rel <= 1e-4 and r_rel <= 1e-4,
              f"K6 ({what}) assembly off the plain one: S {s_rel}, rhs "
              f"{r_rel} of its terms, cost {c_rel}")
        # the first pose solve on the kernel's own system: the backward
        # error of the Jacobi-scaled solve in float64, and dp against the
        # plain solve (cuSOLVER) of the same system
        D = 6 * m_kf
        Sd = tr.S.reshape(D, D).double() + lam_0 * torch.eye(
            D, dtype=torch.float64, device=dev)
        fx = fixed[:, None].expand(m_kf, 6).reshape(-1)
        Sd = torch.where(fx[:, None] | fx[None, :], torch.eye(
            D, dtype=torch.float64, device=dev), Sd)
        rhs_g = torch.where(fx, 0.0, tr.rhs.reshape(-1).double())
        d = Sd.diagonal().clamp(min=1e-12).rsqrt()
        Sps, y = Sd * d[:, None] * d[None, :], tr.dp[0].reshape(-1) / d
        dp_plain = BA._tracks_solve_poses(tr.S, tr.rhs, fixed, lam, linalg)
        failed = bool(torch.isnan(tr.dp[0]).all())
        if failed:
            back_err = dp_err = float("nan")
            check(bool(torch.isnan(dp_plain).all()),
                  f"K6 ({what}): the kernel's pose solve failed, the plain "
                  "one did not")
        else:
            back_err = float((Sps @ y - d * rhs_g).abs().max() / (
                Sps.abs().sum(1).max() * y.abs().max()
                + (d * rhs_g).abs().max()))
            dp_err = float((tr.dp[0] - dp_plain).abs().max()
                           / dp_plain.abs().max())
            check(back_err <= 1e-5, f"K6 ({what}) pose solve backward error "
                  f"{back_err}")
        sp_, cp_ = BA._lm_tracks(pr, iters, huber, lam_0, True, linalg,
                                 kernel=False)
        sk = pr._replace(poses=poses, landmarks=lms)
        pose_err = float((poses - sp_.poses).abs().max())
        lm_err = float((lms - sp_.landmarks).abs().max())
        # landmarks in the metric of their observations: the depth of a
        # point seen with little parallax is not determined by the window,
        # and there a 1e-7 change of the poses moves it along its ray by
        # orders more without moving any of its reprojections
        reproj_err = float((BA.track_residuals(sk, True) - BA.track_residuals(
            sk._replace(landmarks=sp_.landmarks), True)).abs().max())
        cost_err = float((costs - cp_).abs().max() / cp_.abs().max())
        check(pose_err <= 1e-4 and reproj_err <= 1e-3 and cost_err <= 1e-4,
              f"K6 ({what}) LM solve off the plain one: poses {pose_err}, "
              f"landmark reprojections {reproj_err} px, costs {cost_err}")
        check(torch.equal(costs, torch.where(tr.accept != 0, tr.cost_after,
                                             tr.cost_before)),
              f"K6 ({what}): costs are not the accepted ones")
        return dict(S_rel_err=s_rel, rhs_err_of_terms=r_rel,
                    cost_rel_err=c_rel, pose_solve_backward_err=back_err,
                    dp_rel_err_vs_plain_solve=dp_err, lm_pose_err=pose_err,
                    lm_landmark_err=lm_err, lm_reprojection_err_px=reproj_err,
                    lm_cost_rel_err=cost_err,
                    accept=[float(a) for a in tr.accept.cpu()]), tr

    k6_main, tr_main = k6_check(prob, lam0, "warm-up window")
    # every step rejected: the first free pose's observations displaced
    # 2000 px, then one plain LM step; from there each candidate costs ~40%
    # more (a CPU run of this window), and lam grows
    free = int(torch.nonzero(~fixed)[0])
    uv6 = prob.obs_uv.clone()
    uv6[:, free] += 2000.0
    rej, _ = BA._lm_tracks(prob._replace(obs_uv=uv6), 1, huber, 1e-8, True,
                           linalg, kernel=False)
    k6_rej, tr_rej = k6_check(rej, 1e-8, "rejected")
    check(not bool((tr_rej.accept != 0).any())
          and bool((tr_rej.lam[1:] > tr_rej.lam[:-1]).all())
          and bool((tr_rej.cost_before == tr_rej.cost).all()),
          "K6: the rejected-step case accepted a step")
    # the pose factorisation fails: no damping and no observation of the
    # first free pose, so S has a zero row and column and dp is NaN
    valid6 = prob.obs_valid.clone()
    valid6[:, free] = False
    k6_fail, tr_fail = k6_check(prob._replace(obs_valid=valid6), 0.0,
                                "failed factorisation")
    check(not bool((tr_fail.accept != 0).any())
          and bool(torch.isnan(tr_fail.dp).all()),
          "K6: the failed-factorisation case took a step")

    # no iteration: the problem back unchanged, empty costs, no launch
    reset_launch_counts()
    s0, c0 = BA.ba_solve_tracks(prob, iters=0, huber=huber, lam0=lam0,
                                ring_layout=True, linalg=linalg)
    check(launch_counts()["ba_tracks"] == 0 and tuple(c0.shape) == (0,)
          and same_bits(torch, s0.poses, prob.poses)
          and same_bits(torch, s0.landmarks, prob.landmarks),
          "K6's route at iters=0 does not return its problem unchanged")

    def k6_call():
        return BA.ba_solve_tracks(prob, iters=iters, huber=huber, lam0=lam0,
                                  ring_layout=True, linalg=linalg)

    def k6_plain():
        return BA._lm_tracks(prob, iters, huber, lam0, True, linalg,
                             kernel=False)

    # per iteration, each part at its rate and the sum expressed in float32
    # operations: float32 Jacobians (~60 operations an observation); the
    # scalar float64 landmark algebra (~486 an observation); the Schur
    # product W_k U_l^T (216 a pair of observations of one landmark, k <= l:
    # S is symmetric) on the float64 tensor cores; the (6M)^3 / 3 of the
    # float32 pose factorisation
    cnt = prob.obs_valid.sum(1).double()
    D = 6 * m_kf
    k6_ops = iters * float(
        60 * cnt.sum() + D ** 3 / 3
        + 486 * cnt.sum() * SCALAR_OPS_PER_S / FP64_OPS_PER_S
        + 216 * (cnt * (cnt + 1) / 2).sum()
        * SCALAR_OPS_PER_S / FP64_MMA_OPS_PER_S)
    k6_bytes = (4 * (2 * m_kf * 16 + n_lm * 3 * 2 + n_lm * m_kf * 2 + 4
                     + iters + D * D + D + 1 + iters * (D + 4))
                + n_lm * m_kf + m_kf)
    results["ba_tracks"] = dict(
        name="ba_tracks", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/ba_tracks.cu",
        replaces="vpp_tpu/slam/ba.py:568", per="ba_solve_tracks call",
        max_abs_err=float(k6_main["lm_pose_err"]), **k6_main,
        rejected_case=k6_rej, failed_case=k6_fail,
        problem=dict(n=n_lm, m=m_kf, iters=iters, obs=int(cnt.sum()),
                     seen_once=int((cnt == 1).sum())),
        ms=cuda_ms(torch, k6_call, 100), plain_ms=cuda_ms(torch, k6_plain, 20),
        library_ms=None)
    results["ba_tracks"]["bound_ms"], results["ba_tracks"]["bound_by"] = \
        bound_ms(k6_bytes, k6_ops)
    results["ba_tracks"]["device_ms"], \
        results["ba_tracks"]["device_ms_by"] = device_ms(torch, k6_call)
    print(f"phase 3: K6 window BA on keyframe {len(problems)} of the warm-up "
          f"(N {n_lm}, M {m_kf}, {int(cnt.sum())} observations, {iters} "
          f"iterations in one launch): S off by {k6_main['S_rel_err']:.3g}, "
          f"rhs {k6_main['rhs_err_of_terms']:.3g} of its terms, cost "
          f"{k6_main['cost_rel_err']:.3g}; pose solve backward error "
          f"{k6_main['pose_solve_backward_err']:.3g} (dp off cuSOLVER's by "
          f"{k6_main['dp_rel_err_vs_plain_solve']:.3g}); bit-identical twice; "
          f"LM poses {k6_main['lm_pose_err']:.3g}, landmarks "
          f"{k6_main['lm_landmark_err']:.3g} "
          f"({k6_main['lm_reprojection_err_px']:.3g} px in their "
          f"observations), accepts {k6_main['accept']}; rejected-step and "
          f"failed-factorisation cases agree with the plain loop; iters=0 "
          f"returns the problem unchanged with no launch; per call "
          f"{results['ba_tracks']['ms']:.4f} ms as called, "
          f"{results['ba_tracks']['device_ms']:.4f} ms on the device, bound "
          f"{results['ba_tracks']['bound_ms']:.5f} ms")

    # -- 3h. K8 map-vote PnP, at the archive PnP's shapes --------------------
    k8_cases = [(1024, 512, 2, "random"), (37, 3, 2, "random"),
                (1024, 4096, 2, "random"), (1000, 333, 1, "random"),
                (9000, 512, 1, "random"), (7, 1, 2, "random"),
                (1024, 512, 2, "ties"), (300, 40, 2, "ties"),
                (1024, 512, 2, "empty_base"), (1024, 512, 2, "no_valid"),
                (1024, 512, 2, "three_valid"), (1000, 333, 2, "nan_row")]
    k8_diff = 0.0
    for a_n, q_n, b_n, kind in k8_cases:
        ops = pnp_inputs(torch, np, dev, a_n, q_n, b_n, kind,
                         a_n + q_n + b_n)
        diff, want = k8_check(torch, MV, ops, K8_KW,
                              f"{a_n} x {q_n} x {b_n}, {kind}", q_n == 1)
        k8_diff = max(k8_diff, diff)
        if q_n == 1:       # which factorisations failed, card and plain
            k8_one_pair = (
                torch.isnan(MV.map_vote_pnp(*ops, **K8_KW).err).tolist(),
                torch.isnan(want.err).tolist())
        if kind in ("empty_base", "no_valid"):
            check(torch.equal(want.T, ops[6].expand(b_n, 4, 4))
                  and bool((want.err == 0).all() and (want.n == 0).all()),
                  f"K8 ({kind}): the prior pose, err 0 and n 0 expected")
    k8_ops = pnp_inputs(torch, np, dev, 1024, 512, 2, "random", 1538)
    k8_want = MV._map_vote_pnp_plain(*k8_ops, **K8_KW)
    results["map_vote"] = dict(
        name="map_vote", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/map_vote.cu",
        replaces="vpp_tpu/slam/pipeline.py:325",
        per="map_vote_pnp call (2 match sets)", max_abs_err=k8_diff,
        ms=cuda_ms(torch, lambda: MV.map_vote_pnp(*k8_ops, **K8_KW), 200),
        plain_ms=cuda_ms(torch, lambda: MV._map_vote_pnp_plain(
            *k8_ops, **K8_KW), 10, warmup=1),
        library="none", library_ms=None)
    k8 = results["map_vote"]
    (k8["bound_ms"], k8["bound_by"]), k8["bound_bytes"], \
        k8["bound_operations"] = k8_bound(torch, MV, k8_ops, k8_want, K8_KW)
    k8["device_ms"], k8["device_ms_by"] = device_ms(
        torch, lambda: MV.map_vote_pnp(*k8_ops, **K8_KW))
    print(f"phase 3: K8 map-vote PnP one launch for every match set, shifts, "
          f"j1, uv1 and inl bit-equal, T and err within {k8_diff:.3g}, n "
          f"equal, bit-identical twice "
          f"({', '.join(f'{a} x {q} x {b} {k}' for a, q, b, k in k8_cases)}"
          f"; one pair a set: NaN on the card {k8_one_pair[0]}, plain "
          f"{k8_one_pair[1]}); "
          f"1024 x 512 x 2: {k8['ms']:.4f} ms as called, "
          f"{k8['device_ms']:.4f} ms on the device, bound {k8['bound_ms']:.5f} "
          f"({k8['bound_by']}: {k8['bound_bytes']} bytes, "
          f"{k8['bound_operations']:.3g} operations), "
          f"plain {k8['plain_ms']:.3f}")

    # -- 4. tracker main path -------------------------------------------------
    clip_dev = torch.from_numpy(clip).to(dev)   # upload outside the timing
    video_extruder_run(clip_dev[:6], cfg, device="cuda")     # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, (hist_pos, hist_alive) = video_extruder_run(clip_dev, cfg,
                                                       device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    track_counts = launch_counts()
    fps = TRACK_FRAMES / dt
    live = int(state.keypoints.alive.sum())
    print(f"phase 4: tracker {W}x{H}: {fps:.2f} frames/s over "
          f"{TRACK_FRAMES} frames, {live} live keypoints, launches "
          f"{track_counts}")
    check(track_counts["flow_level"] == 2 * cfg.nscales * TRACK_FRAMES,
          "the tracker did not launch K1 twice per level and frame")
    check(track_counts["pyramid_decim"] == TRACK_FRAMES + 1,
          f"the tracker launched K4 {track_counts['pyramid_decim']} times, "
          f"not {TRACK_FRAMES + 1} (one pyramid a frame, and the first's)")
    k2_track = TRACK_FRAMES + -(-TRACK_FRAMES // cfg.detector_period)
    check(track_counts["fast9"] == k2_track,
          f"the tracker launched K2 {track_counts['fast9']} times, not "
          f"{k2_track} (one cull a frame, one score image a detection)")
    check(tuple(hist_pos.shape) == (TRACK_FRAMES, cfg.capacity, 2)
          and bool(torch.isfinite(hist_pos).all()), "bad tracker output")
    check(live > 0, "no live keypoints")
    cpu_state, (_, cpu_alive) = video_extruder_run(
        clip[:CPU_CHECK_FRAMES], cfg, device="cpu")
    n_gpu = int(hist_alive[CPU_CHECK_FRAMES - 1].sum())
    n_cpu = int(cpu_alive[-1].sum())
    print(f"phase 4: alive after {CPU_CHECK_FRAMES} frames: card {n_gpu}, "
          f"plain CPU {n_cpu}")
    check(abs(n_gpu - n_cpu) <= 0.01 * max(n_cpu, 1),
          "tracker alive counts differ from the plain CPU path by > 1%")

    # -- 5. Hough path --------------------------------------------------------
    lines_dev = torch.from_numpy(lines).to(dev)  # upload outside the timing
    hst = hough_tracker_init(hcfg, device="cuda")
    hough_tracker_update(hst, from_array(lines_dev[0], border=3,
                                         border_mode="mirror"),
                         hcfg)                             # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for f in lines_dev:
        hst, _ = hough_tracker_update(
            hst, from_array(f, border=3, border_mode="mirror"), hcfg)
    torch.cuda.synchronize()
    hough_ms = (time.perf_counter() - t0) * 1e3 / HOUGH_FRAMES
    hough_counts = launch_counts()
    n_tracks = int((hst.age > 0).sum())
    print(f"phase 5: hough tracker {W}x{H}: {hough_ms:.3f} ms/frame, "
          f"{n_tracks} live tracks, launches {hough_counts}")
    check(n_tracks >= 2, "fewer than 2 live line tracks")
    check(hough_counts["hough_acc"] == HOUGH_FRAMES,
          f"the Hough path launched K7 {hough_counts['hough_acc']} times, "
          f"not once a frame")
    cst = hough_tracker_init(hcfg, device="cpu")
    for f in lines:
        cst, _ = hough_tracker_update(
            cst, from_array(f, border=3, border_mode="mirror"), hcfg)
    same = (torch.equal(hst.age.cpu(), cst.age)
            and torch.equal(hst.theta.cpu(), cst.theta)
            and torch.equal(hst.rho.cpu(), cst.rho))
    check(same, "Hough tracks differ from the plain CPU path")

    # -- 6. SLAM tracking+BA path ---------------------------------------------
    kf_states = {}
    do_kf = SP._do_keyframe

    def keep_state(state, frame2, cfg_, **kw):
        if state.n_keyframes == SLAM_CHECK_KF:
            kf_states["state"], kf_states["frame"] = state, frame2
        return do_kf(state, frame2, cfg_, **kw)

    torch.cuda.synchronize()
    SP._do_keyframe = keep_state
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        sst = SP.slam_run(slam_dev, slam_cfg, bootstrap_poses=boot,
                          device="cuda")
        torch.cuda.synchronize()
        slam_dt = time.perf_counter() - t0
        slam_counts = launch_counts()
    finally:
        SP._do_keyframe = do_kf
    slam_fps = SLAM_FRAMES / slam_dt
    est, fids = SP.keyframe_trajectory(sst)
    slam_ate = float(SP.ate_rmse(est.cpu(), torch.from_numpy(
        gt_poses[fids.cpu().numpy()])))
    slam_lms = int(sst.lm_valid.sum())
    slam_live = int(sst.tracker.keypoints.alive.sum())
    print(f"phase 6: SLAM {W}x{H}: {slam_fps:.2f} frames/s over "
          f"{SLAM_FRAMES} frames, {sst.n_keyframes} keyframes, {slam_lms} "
          f"landmarks, {slam_live} live keypoints, ATE {slam_ate:.4f}; "
          f"launches {slam_counts}")
    for key in ("flow_level", "fast9", "block_topk", "pyramid_decim",
                "patches", "ba_tracks"):
        check(slam_counts[key] > 0, f"the SLAM path did not launch {key}")
    check(sst.n_keyframes == SLAM_FRAMES // slam_cfg.keyframe_period,
          f"{sst.n_keyframes} keyframes, expected 60")
    check(slam_counts["ba_tracks"] == sst.n_keyframes,
          f"K6 launched {slam_counts['ba_tracks']} times, not once a keyframe")
    check(slam_counts["pyramid_decim"] == SLAM_FRAMES + 1,
          f"K4 launched {slam_counts['pyramid_decim']} times, not "
          f"{SLAM_FRAMES + 1} (one pyramid a frame, and the first's)")
    check(slam_counts["block_topk"] == SLAM_FRAMES,
          f"K3 launched {slam_counts['block_topk']} times, not once a frame")
    check(slam_counts["fast9"] == 2 * SLAM_FRAMES,
          f"K2 launched {slam_counts['fast9']} times, not twice a frame")
    check(slam_counts["patches"] == sst.n_keyframes,
          f"K5 launched {slam_counts['patches']} times, not once a keyframe")
    check(slam_lms > 200, f"only {slam_lms} landmarks")
    check(slam_ate < 0.10, f"SLAM ATE {slam_ate} >= 0.10")
    check(bool(torch.isfinite(est).all()), "non-finite keyframe poses")

    # the back end alone, from one state on both devices
    kst, kframe = kf_states["state"], kf_states["frame"]
    cst = convert.slam_state_from_numpy(convert.slam_state_to_numpy(kst),
                                        device="cpu")
    ckf = SP._do_keyframe(cst, Image2d(data=kframe.data.cpu(),
                                       border=kframe.border), slam_cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gkf = SP._do_keyframe(kst, kframe, slam_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kf_err = float((gkf.kf_pose.cpu() - ckf.kf_pose).abs().max())
    lm_agree = float((gkf.lm_valid.cpu() == ckf.lm_valid).double().mean())
    print(f"phase 6: keyframe {SLAM_CHECK_KF} from one state: card and plain "
          f"CPU poses within {kf_err:.3g}, lm_valid agrees on "
          f"{100 * lm_agree:.2f}% of slots; the card's call made no host "
          "synchronisation")
    check(kf_err <= 1e-3, f"keyframe poses differ by {kf_err}")
    check(lm_agree >= 0.99, f"lm_valid agrees on only {lm_agree}")

    # the whole path, card against the plain CPU path
    ga = SP.slam_run(slam_dev[:SLAM_CPU_FRAMES], slam_cfg,
                     bootstrap_poses=boot, device="cuda")
    ca = SP.slam_run(slam_frames[:SLAM_CPU_FRAMES], slam_cfg,
                     bootstrap_poses=boot, device="cpu")

    def ate_of(st):
        e, f = SP.keyframe_trajectory(st)
        return float(SP.ate_rmse(e.cpu(), torch.from_numpy(
            gt_poses[f.cpu().numpy()])))

    g_lm, c_lm = int(ga.lm_valid.sum()), int(ca.lm_valid.sum())
    g_ate, c_ate = ate_of(ga), ate_of(ca)
    print(f"phase 6: first {SLAM_CPU_FRAMES} frames: card {ga.n_keyframes} "
          f"keyframes, {g_lm} landmarks, ATE {g_ate:.4f}; plain CPU "
          f"{ca.n_keyframes}, {c_lm}, {c_ate:.4f}")
    check(ga.n_keyframes == ca.n_keyframes, "keyframe counts differ")
    check(abs(g_lm - c_lm) <= 0.05 * max(c_lm, 1),
          "landmark counts differ by more than 5%")
    check(abs(g_ate - c_ate) <= 0.02, "ATE differs by more than 0.02")

    # -- 7. the full SLAM engine (recovery, loop closure, smoother) ----------
    full_cfg = dataclasses.replace(slam_cfg, enable_recovery=True)
    full_states = {}

    def keep_full(state, frame2, cfg_, **kw):
        if state.n_keyframes == SLAM_CHECK_KF:
            full_states["state"], full_states["frame"] = state, frame2
        return do_kf(state, frame2, cfg_, **kw)

    torch.cuda.synchronize()
    SP._do_keyframe = keep_full
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        fst = SP.slam_run(slam_dev, full_cfg, bootstrap_poses=boot,
                          device="cuda")
        torch.cuda.synchronize()
        full_dt = time.perf_counter() - t0
        full_counts = launch_counts()
    finally:
        SP._do_keyframe = do_kf
    full_fps = SLAM_FRAMES / full_dt
    full_ate = ate_of(fst)
    full_lms = int(fst.lm_valid.sum())
    full_lc = int(fst.lc_ptr)
    n_lost = int((fst.pg_w < 1).sum())
    print(f"phase 7: full SLAM engine {W}x{H}: {full_fps:.2f} frames/s over "
          f"{SLAM_FRAMES} frames, {fst.n_keyframes} keyframes, {full_lms} "
          f"landmarks, ATE {full_ate:.4f}, lc_ptr {full_lc}, {n_lost} lost "
          f"keyframes in the history; launches {full_counts}")
    check(fst.n_keyframes == SLAM_FRAMES // slam_cfg.keyframe_period,
          f"{fst.n_keyframes} keyframes, expected 60")
    for key in ("flow_level", "fast9", "block_topk", "pyramid_decim",
                "patches", "ba_tracks", "map_vote"):
        check(full_counts[key] > 0, f"the full engine did not launch {key}")
    check(full_counts["ba_tracks"] == fst.n_keyframes,
          f"K6 launched {full_counts['ba_tracks']} times, not once a "
          "keyframe")
    check(full_counts["map_vote"] == fst.n_keyframes,
          f"K8 launched {full_counts['map_vote']} times, not once a "
          "keyframe")
    check(full_lms > 200, f"only {full_lms} landmarks")
    check(full_ate < 0.10, f"full engine ATE {full_ate} >= 0.10")
    check(bool(torch.isfinite(fst.hist_pose).all()),
          "non-finite keyframe poses")

    # one keyframe from one state on both devices; on the card the
    # smoother's branch flags are its only host read
    kst, kframe = full_states["state"], full_states["frame"]
    cst = convert.slam_state_from_numpy(convert.slam_state_to_numpy(kst),
                                        device="cpu")
    ckf = SP._do_keyframe(cst, Image2d(data=kframe.data.cpu(),
                                       border=kframe.border), full_cfg)
    gkf, reads = keyframe_host_reads(torch, SP, kst, kframe, full_cfg)
    kf_err = float((gkf.kf_pose.cpu() - ckf.kf_pose).abs().max())
    hist_err = float((gkf.hist_pose.cpu() - ckf.hist_pose).abs().max())
    lm_agree = float((gkf.lm_valid.cpu() == ckf.lm_valid).double().mean())
    print(f"phase 7: keyframe {SLAM_CHECK_KF} from one state: card and plain "
          f"CPU poses within {kf_err:.3g}, history within {hist_err:.3g}, "
          f"lm_valid agrees on {100 * lm_agree:.2f}% of slots, lc_ptr "
          f"{int(gkf.lc_ptr)} / {int(ckf.lc_ptr)}; {reads} host read "
          "(the smoother's branch), no other synchronisation")
    check(reads == 1, f"{reads} smoother reads in one keyframe")
    check(kf_err <= 1e-3, f"keyframe poses differ by {kf_err}")
    check(hist_err <= 1e-2, f"smoothed history differs by {hist_err}")
    check(lm_agree >= 0.99, f"lm_valid agrees on only {lm_agree}")
    check(int(gkf.lc_ptr) == int(ckf.lc_ptr), "lc_ptr differs")

    # the smoother at full width, on both devices, and its card time
    smooth = smoother_full_width(torch, SP, fst, full_cfg)
    print("phase 7: the smoother at history 64 (384x384 systems), one "
          "closure edge put in: " + "; ".join(
              f"{b} {ms:.2f} ms on the card, card and plain CPU within "
              f"{err:.3g} (history moved {mv:.4f})"
              for b, (ms, err, mv) in smooth.items()))
    for b, (_, err, mv) in smooth.items():
        check(err <= 1e-4, f"the smoother's {b} branch differs between "
              f"card and CPU by {err}")
        check(mv > 1e-3, f"the smoother's {b} branch moved nothing")

    # the first frames, card against the plain CPU path; the card run's
    # last keyframe gives K8 its real archive PnP
    k8_calls = []
    mvp = SP.map_vote_pnp

    def keep_call(*a, **kw):
        k8_calls.append((a, kw))
        return mvp(*a, **kw)

    SP.map_vote_pnp = keep_call
    try:
        gf = SP.slam_run(slam_dev[:SLAM_CPU_FRAMES], full_cfg,
                         bootstrap_poses=boot, device="cuda")
    finally:
        SP.map_vote_pnp = mvp
    cf = SP.slam_run(slam_frames[:SLAM_CPU_FRAMES], full_cfg,
                     bootstrap_poses=boot, device="cpu")
    g_lm, c_lm = int(gf.lm_valid.sum()), int(cf.lm_valid.sum())
    g_ate, c_ate = ate_of(gf), ate_of(cf)
    print(f"phase 7: first {SLAM_CPU_FRAMES} frames: card {gf.n_keyframes} "
          f"keyframes, {g_lm} landmarks, ATE {g_ate:.4f}, lc_ptr "
          f"{int(gf.lc_ptr)}; plain CPU {cf.n_keyframes}, {c_lm}, "
          f"{c_ate:.4f}, {int(cf.lc_ptr)}")
    check(gf.n_keyframes == cf.n_keyframes, "keyframe counts differ")
    check(abs(g_lm - c_lm) <= 0.05 * max(c_lm, 1),
          "landmark counts differ by more than 5%")
    check(abs(g_ate - c_ate) <= 0.02, "ATE differs by more than 0.02")
    check(len(k8_calls) == gf.n_keyframes
          and all(a[2].shape[0] == 2 for a, _ in k8_calls),
          "the archive PnP was not one K8 call of two match sets a keyframe")
    k8_kf, k8_kw = k8_calls[-1]
    k8["keyframe_max_abs_err"], kf_want = k8_check(
        torch, MV, k8_kf, k8_kw, "the last keyframe's archive PnP")
    k8["device_ms_keyframe"] = device_ms(torch, lambda: MV.map_vote_pnp(
        *k8_kf, **k8_kw))[0]
    margins = (abs(float(kf_want.err[0]) - full_cfg.rec_max_err),
               abs(float(kf_want.err[1]) - full_cfg.lc_max_err))
    print(f"phase 7: K8 on the last keyframe's archive PnP (A "
          f"{k8_kf[0].shape[0]}, Q {k8_kf[3].shape[0]}, B 2): shifts, j1, "
          f"uv1 and inl bit-equal, T and err within "
          f"{k8['keyframe_max_abs_err']:.3g}, n {kf_want.n.tolist()} equal, "
          f"err {kf_want.err.tolist()} ({margins[0]:.4g} from rec_max_err, "
          f"{margins[1]:.4g} from lc_max_err); "
          f"{k8['device_ms_keyframe']:.4f} ms on the device")

    # -- 8. recovery scenarios at 120x160 (tests/test_pose_graph_loop.py) --
    t0 = time.perf_counter()
    scenario_recovery(torch, np, SP)
    print(f"phase 8: recovery scenarios passed in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 9. SLAM streams (slam_run_streams) ----------------------------------
    t0 = time.perf_counter()
    streams = phase_streams(
        torch, np, dict(F=F, FL=FL, PY=PY, IP=IP, BA=BA, BC=BC, SP=SP,
                        KN=sys.modules["vpp_tpu_torch.kernels"]),
        slam_cfg, slam_dev, gt_poses, sst, slam_counts, results, smi)
    print(f"phase 9: streams passed in {time.perf_counter() - t0:.1f} s")

    # -- 10. bundle adjustment at production scale (the generic layout) -----
    t0 = time.perf_counter()
    gen = phase_ba_generic(torch, np, BA, BG,
                           sys.modules["vpp_tpu_torch.kernels"], dev, results,
                           smi)
    print(f"phase 10: passed in {time.perf_counter() - t0:.1f} s")

    # -- 11. the Hough line path at full width --------------------------------
    t0 = time.perf_counter()
    hough_lines = phase_hough_lines(torch, np, dev, results, smi)
    print(f"phase 11: passed in {time.perf_counter() - t0:.1f} s")

    # -- 12. pyramidal LK, sparse flow, distance transforms, matchers --------
    t0 = time.perf_counter()
    slice_c = phase_slice_c(torch, np, dev, results, smi)
    print(f"phase 12: passed in {time.perf_counter() - t0:.1f} s")

    # -- 13. slice D: ops, N-d images, video I/O, profiler, CPU baseline ------
    t0 = time.perf_counter()
    slice_d = phase_slice_d(torch, np, dev, cfg, clip, fps, live, state, smi)
    print(f"phase 13: passed in {time.perf_counter() - t0:.1f} s")

    # -- 14. slice E: the sharded tracker and BA ------------------------------
    t0 = time.perf_counter()
    sharded = phase_sharded(torch, np, dev, clip, cfg, slam_frames, gt_poses,
                            ga, g_ate, results, smi)
    print(f"phase 14: passed in {time.perf_counter() - t0:.1f} s")

    # -- 15. the front end past the kernels' old limits, ring 20 streams -----
    t0 = time.perf_counter()
    front = phase_front_end(torch, np, dev, slam_cfg, results, smi)
    print(f"phase 15: passed in {time.perf_counter() - t0:.1f} s")

    # -- 16. the back end past the kernels' old limits ------------------------
    t0 = time.perf_counter()
    back = phase_back_end(torch, np, dev, results, smi)
    print(f"phase 16: passed in {time.perf_counter() - t0:.1f} s")

    # -- results --------------------------------------------------------------
    launches = {"fast9": track_counts["fast9"],
                "flow_level": track_counts["flow_level"],
                "hough_acc": hough_counts["hough_acc"]}
    per_frame = {"fast9": track_counts["fast9"] / TRACK_FRAMES,
                 "flow_level": track_counts["flow_level"] / TRACK_FRAMES,
                 "hough_acc": hough_counts["hough_acc"] / HOUGH_FRAMES}
    for key in ("block_topk", "pyramid_decim", "patches", "ba_tracks"):
        launches[key] = slam_counts[key]
        per_frame[key] = slam_counts[key] / SLAM_FRAMES
    launches["map_vote"] = full_counts["map_vote"]
    per_frame["map_vote"] = full_counts["map_vote"] / SLAM_FRAMES
    kernels = []
    for key in ("flow_level", "fast9", "hough_acc", "block_topk",
                "pyramid_decim", "patches", "ba_tracks", "map_vote"):
        r = results[key]
        r["launches"] = launches[key]
        r["launches_per_frame"] = per_frame[key]
        kernels.append(r)
    results["ba_generic"]["launches"] = gen["counts"]["ba_generic"]
    kernels.append(results["ba_generic"])
    results["lk_level"]["launches"] = (
        slice_c["lucas_kanade"]["launches"]["lk_level"])
    results["jfa"]["launches"] = (
        slice_c["distance_transforms"]["euclidean"]["launches"]["jfa"])
    kernels += [results["lk_level"], results["jfa"]]
    print(json.dumps({"tracker_fps": fps, "tracker_live": live,
                      "hough_ms_per_frame": hough_ms, "slam_fps": slam_fps,
                      "slam_ate": slam_ate, "slam_landmarks": slam_lms,
                      "slam_keyframes": sst.n_keyframes,
                      "slam_launches": slam_counts, "full_slam_fps": full_fps,
                      "full_slam_ate": full_ate,
                      "full_slam_landmarks": full_lms,
                      "full_slam_lc_ptr": full_lc,
                      "full_slam_launches": full_counts,
                      "smoother_ms": {b: v[0] for b, v in smooth.items()},
                      "streams": streams, "ba_generic": gen,
                      "hough_lines": hough_lines, "slice_c": slice_c,
                      "slice_d": slice_d, "sharded": sharded,
                      "front_end": front, "back_end": back,
                      "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
