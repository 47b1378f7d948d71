#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (progressivex_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure:
  1. prints the card (nvidia-smi) and builds the CUDA kernels from csrc/,
     one nvcc per source, all at once; writes the synthetic 19 H + 18 F
     scene datasets under build/synth and checks their bytes against the
     files the JAX package's reference ran on;
  2. holds each scoring kernel (score_homography, score_fundamental,
     score_pnp) against its plain torch version on the card at its path's
     shapes (score_pnp at the pose fit's [3 x 1600 | 4, 2304] on T-LESS),
     and times both beside the launch floor (one one-element kernel, timed
     the same way);
     then the draws ("2 draws", `phase_draws`): every path of phases 3, 5,
     7, 8 and 10 run eagerly, each draw of its samples on the card
     (engine.draw: the JAX package's threefry keys and samplers) against
     the same draw on the CPU, element for element, and the threefry
     kernel against its plain version bit for bit at every launch shape
     those draws gave it and at the pass F gumbel shape [64 x 6 x 512, 48],
     timed beside its bound at each path's largest launch; then the
     smallest-eigenvector kernel ("2 eigvec", `phase_eigvec`) against its
     plain version at the cells' batch shapes and on degenerate matrices,
     timed beside its bound, and one launch of it captured and replayed;
     then the pose refit kernel ("2 refine", `phase_refine`) against its
     plain version at a pose fit's three launch shapes [3 x 4 | 8 | 10,
     2304], timed beside its bound, the launch floor and the plain
     version, and one launch of it captured and replayed;
  3. drives the ported paths, each with the launch counts set to 0 just
     before it and read just after: findHomographies under the
     AdelaideRMF-H protocol and findTwoViewMotions under the AdelaideRMF-F
     protocol on their bundled scenes (the path's kernel must have run),
     findLines on the synthetic 3180-point lines scene, findVanishingPoints
     on the synthetic 216-segment VP scene, and find6DPoses on the bundled
     T-LESS scene at seeds 0, 1 and 2 (these three reach no kernel in the
     JAX package; lines and VPs launch no scoring kernel here, poses
     score_pnp alone, 3 launches of 3 restarts a round); checks each scene's
     misclassification against the JAX package's, and T-LESS's mean pose
     errors against tests/test_pose6d.py's anchors or the JAX package's
     errors at the same seeds on the card, whichever is larger; then
     findEssentialMatrices on the essential gauntlet's scenes
     (tests/test_gauntlet.py: two motions at seeds 0-2, three motions at
     seed 1, three restarts), scored by the fundamental kernel, against
     the gauntlet's gates, beside the JAX package's CPU ME; every fit
     draws its samples through the threefry kernel, which must have run,
     and every H, F, E, VP and pose fit solves its weighted refits through
     the eigvec_psd kernel, which must have run, and every pose fit its
     Gauss-Newton refits through the pnp_refine kernel, which must have
     run;
  4. fits one scene of the H, F, line, VP and essential paths on the card
     and on the CPU and compares them;
  5. drives the batched front ends (findHomographiesBatched,
     findTwoViewMotionsBatched on the same scenes, findLinesBatched and
     findVanishingPointsBatched on four synthetic scenes each,
     find6DPosesBatched on [tless, tless], findEssentialMatricesBatched on
     four two-motion gauntlet scenes), the launch counts set to 0 just
     before each and read after: each scene against its limit (where
     the JAX package's result on the same draw lies above an anchor of
     another draw, that result), and each
     scene alone against the same scene listed first in a batch; then the
     throughput bench (`cli.bench_main`) at a small lane target and the
     essential bench line (`eval/extras.bench_essential`);
  6. runs every single-scene front end once with a progress callback and
     with_statistics="phases": the callback fires on the card, and
     phase_times holds the JAX package's keys with device time in it;
  7. the dataset pass (eval/adelaide.throughput_all) over the synthetic
     datasets at every bucket (H at 256 to 2304 points, F at 256 and 384,
     restarts as rows), the launch counts set to 0 just before it and
     read after: 19 and 18 scenes, mean ME under 0.08 and the JAX
     package's CPU mean + ME_SLACK; a grid neighborhood fit on the card
     against the CPU; the merge and split moves of a batched essential
     call and of the 2304 bucket under
     torch.cuda.set_sync_debug_mode("warn"), timed, with every
     synchronization printed (none may come from core/pearl.py).
  8. the device mesh (parallel/sharding): fit_batch with hyp axes of 1,
     2 and 4 on a virtual mesh that names the card that many times, on
     unihouse under the H protocol's engine (pad 2304, banded) and on
     book under the F protocol's (4 restarts), the launch counts set to 0
     just before each fit and read after: each seed-0 fit within phase
     3's ME limit, except unihouse at hyp 2 and 4, which fits seeds 0-29
     and is held over them to the JAX package's spread over seeds 0-89
     (JAX_HYP_SPREAD: the rate of six-model fits by a one-sided Fisher
     exact test, the mean ME within ME_SLACK); the samples drawn a round
     growing with the hyp axis, every launch scoring restarts x replicas
     rows, and a hyp-4 fit under torch.cuda.set_sync_debug_mode("warn")
     with no synchronization from the hyp axis's own code;
     oldclassicswing with two replicas, the second on the CPU, against
     both on the card (phase 4's rule); then findHomographiesBatched and
     findTwoViewMotionsBatched on phase 5's scenes, unsharded and over a
     (2, 1) virtual mesh of the card, and over n_devices = the card count
     when there are several, each bit for bit phase 5's unsharded result,
     with both calls' seconds and every shard's host seconds and device
     span (no synchronization inside a shard's thread);
  9. the real-image demo (examples/demo_real_images) on images rendered
     here with numpy (render_h_pair: two 640 x 480 views of three planar
     regions; render_facade: a 1024 x 768 facade of dashed lines along
     three vanishing directions), their bytes and the demo's matches held
     to REAL_IMAGES_DIGEST: the numpy detectors on the host, the demo's
     homography fit on the card through score_homography (the launch
     counts set to 0 just before it) with LiveProgress as its callback,
     K >= 2 and ME within ME_SLACK of the JAX package's CPU ME on the same
     matches, the same fit on the CPU (phase 4's rule), the line and
     vanishing-point fits on the facade (K >= 4, K >= 2), and one profiled
     H fit whose torch.profiler trace io/profiling.op_self_times reads
     back: as many score_homography entries as the fit's launches, its
     device time within 1% of the profile's; it prints each detector's
     host seconds, each fit's seconds and the ten device operations with
     the most self time and the ten most frequent (that fit eager, as
     op_self_times needs);
 10. the compiled fit (core/graphs.py): H on its three scenes, F on its
     three, E two-0, lines-0, vp-0, T-LESS, phase 5's batched H and F and
     the dataset pass's H 2304 bucket, each in its eager form and as CUDA
     graphs (cold, then warm), every FitResult and launch count bit for
     bit the eager run's, no host read before the rounds, at most two a
     round and none from the captured code, with cold, warm and eager
     seconds, warm-up and capture seconds, peak reserved memory and the
     busy share of a warm run; then cfg.unroll_rounds (rounds and tail in one graph) against
     the per-round graphs.
Phases 3-9 run the fits as CUDA graphs, the port's default on the card;
phase 6's phase times, phase 7's timed moves and phase 9's profiled fit
run eagerly (core/graphs.eager), since they time operations inside a fit.
Phase 2 also captures one launch of each kernel in a CUDA graph at a
main-path shape (H [1 x 256, 2304], F [4 x 1536, 256], PnP [3 x 1600,
2304]) and holds the
replay bit for bit to a direct launch, and its tally to one launch. It
also holds each kernel against its plain version over rows, at
the shapes the batched front ends give it, and score_fundamental at the
essential path's shapes (restarts as rows, 409 five-point samples x 10
solutions), with rows of NaN and inf descriptors among them, both
kernels at the dataset pass's shapes, and both at the hyp axis's shapes
(phase 8: H [4 x 256, 2304], four replicas of unihouse, and F [8 x 1536,
256], two replicas of book's four restarts), each row on samples of its
own.
Each phase prints its seconds. It ends with the total seconds, a
{"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. It needs a CUDA device and the package
beside it, and exits non-zero without either. It imports no JAX.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The JAX package's misclassification errors on the CPU, seed 0, from
#   JAX_PLATFORMS=cpu PROGX_COMPILE_CACHE=0 python -c "import jax;
#     jax.config.update('jax_platforms', 'cpu');
#     from progressivex_tpu.eval import adelaide;
#     adelaide.download_adelaide = lambda *a, **k: None;
#     print(adelaide.evaluate_scenes('H', seed=0))"
# (bundled scenes; the download is switched off so the run stays offline).
JAX_CPU_ME = {
    "oldclassicswing": 0.0026385224274406704,
    "unionhouse": 0.0060240963855421326,
    "unihouse": 0.06094049904030707,
}
# The same for the F protocol, from the same command with
# evaluate_scenes('F', seed=0).
JAX_CPU_ME_F = {
    "book": 0.0106952,
    "breadcube": 0.0123967,
    "cubetoy": 0.0281124,
}
# The JAX package's misclassification errors on the CPU, random_seed 0,
# on make_lines_scene(seed=s) and make_vp_scene(seed=s), s = 0..3, from
#   JAX_PLATFORMS=cpu PROGX_COMPILE_CACHE=0 python -c "import jax;
#     jax.config.update('jax_platforms', 'cpu');
#     from progressivex_tpu import findLines, findVanishingPoints;
#     from progressivex_tpu.eval.extras import make_lines_scene, make_vp_scene;
#     from progressivex_tpu.io.metrics import misclassification as me;
#     kw = dict(threshold=2.0, conf=0.9, minimum_point_number=30,
#               sampler_id=0, maximum_model_number=12);
#     kv = dict(threshold=1.5, conf=0.5, spatial_coherence_weight=0.0,
#               neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
#               max_iters=1000, minimum_point_number=15, maximum_model_number=5,
#               sampler_id=0, scoring_exponent=2);
#     L = [make_lines_scene(seed=s) for s in range(4)];
#     V = [make_vp_scene(seed=s) for s in range(4)];
#     print([me(findLines(p, **kw)[1], g) for p, g in L]);
#     print([me(findVanishingPoints(v[0], **kv)[1], v[1]) for v in V])"
JAX_CPU_ME_LINES = [0.11949685534591192, 0.11761006289308173, 0.2345911949685534,
                    0.12735849056603776]
# A line scene's ME is one draw of a spread that the seed decides, in
# both packages (`python3 tools/seed_spread.py --package jax|torch` prints
# it over random_seed 0..9). The batched front end draws each scene with
# another seed than the single-scene one, so a batched line scene is held
# to the worst of the JAX package's ten runs + ME_SLACK, from the command
# above with
#     print([max(me(findLines(p, **kw, random_seed=r)[1], g)
#                for r in range(10)) for p, g in L])
JAX_CPU_ME_LINES_WORST = [0.12012578616352199, 0.3141509433962264, 0.23867924528301887,
                          0.12893081761006286]
JAX_CPU_ME_VP = [0.03240740740740744, 0.03703703703703709, 0.04629629629629628,
                 0.02777777777777779]
# find6DPoses on T-LESS: the 3-seed mean of pose_errors at or under
# tests/test_pose6d.py:85-89's anchors, (rotation deg, translation mm) for
# each ground-truth pose; every seed at least 2 instances. One scene of
# find6DPosesBatched (one restart, no duplicate fusion) against
# tests/test_batch_api.py:178-182's gates.
TLESS_SEEDS = (0, 1, 2)
TLESS_MEAN_GATES = ((8.25, 16.0), (2.5, 12.2))
TLESS_BATCHED_GATES = ((9.9, 28.8), (2.0, 14.64))
ME_SLACK = 0.03
# The JAX package's results for the very calls of phase 3 P and phase 5 H
# and L, at the same random_seed and so on the same samples (the port
# draws the JAX package's), on an NVIDIA H100 80GB HBM3 at 700 W, from
#   python3 tools/shared_seed_gates.py --package jax
# The anchors above come from other draws: the single-scene key where a
# batched row folds in its pad, scene and restart, the worst of ten other
# seeds, or the CPU's rounding of T-LESS's float32 P3P. Where the JAX
# package's own result on the same draw lies above such an anchor, the
# port is held to that result instead (the ME ones + ME_SLACK); elsewhere
# the anchor stands: each gate takes the larger of the two.
JAX_SAME_DRAW_TLESS_MEAN = ((7.404283295107169, 16.92479557810356),
                            (1.7147464613588312, 9.776263781574665))
JAX_SAME_DRAW_BATCHED_ME = {
    "H": {"oldclassicswing": 0.0026385224274406704, "unionhouse": 0.0060240963855421326,
          "unihouse": 0.21593090211132437},
    "L": {"lines-0": 0.08522012578616356, "lines-1": 0.11572327044025155,
          "lines-2": 0.34874213836477985, "lines-3": 0.11949685534591192},
}
LABEL_DISAGREEMENT_MAX = 0.01
# findEssentialMatrices on the gauntlet's scenes (eval/extras.gauntlet_scene:
# "two-s" two motions, "three-s" three motions, scene seed s, random_seed
# s, extras.ESSENTIAL_KW). Gates, tests/test_gauntlet.py:160-215: at least
# (or exactly) that many motions and ME <= E_ME_GATE.
E_SCENES = {"two-0": (2, None), "two-1": (2, None), "two-2": (2, None),
            "three-1": (3, 3)}
E_ME_GATE = 0.12
# The JAX package's misclassification errors on the CPU at those runs, and
# how many of its runs at random_seed 0-9 on each scene miss the gate, from
#   JAX_PLATFORMS=cpu python3 tools/seed_spread.py --package jax --only essential
JAX_CPU_ME_E = {"two-0": 0.022499999999999964, "two-1": 0.022499999999999964,
                "two-2": 0.01749999999999996, "three-1": 0.026000000000000023}
JAX_E_MISSES = {"two-0": "1/10", "two-1": "0/10", "two-2": "1/10", "three-1": "4/10"}
# A three-motion scene whose gate the JAX package itself misses on at
# least 1 random seed in 5 is printed, not gated; the two-motion gates
# always hold. The JAX package misses three-1's on 4 of 10 seeds.
E_PRINTED_ONLY = ("three-1",)
# The scene of phase 4's card-against-CPU comparison.
E_CARD_VS_CPU = "two-1"
# The dataset pass (phase 7) on the synthetic full-cardinality datasets of
# eval/synth_adelaide (19 H and 18 F scenes, seed 0), written under
# build/synth beside this script; SYNTH_DIGEST is the SHA-256 of their
# files (_synth_digest), which the run checks before it compares. The JAX
# package's mean misclassification on the same files, on the CPU, at
# lane_target 1 and one timing run, from
#   JAX_PLATFORMS=cpu PROGX_COMPILE_CACHE=0 python -c "import jax;
#     jax.config.update('jax_platforms', 'cpu');
#     from progressivex_tpu_torch.eval.synth_adelaide import ensure_synth_dataset as e;
#     from progressivex_tpu.eval.adelaide import throughput_batch as t;
#     [print(p, t(p, root=e(p, root='build/synth'), n_timing_runs=1,
#                 lane_target=1).mean_me) for p in 'HF']"
# Gate: mean ME <= SYNTH_ME_GATE (tests/test_full_protocol.py:41,54) and
# <= the JAX package's + ME_SLACK.
SYNTH_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "synth")
SYNTH_DIGEST = "7842d19eb3d5e9bfd13b700f23b32ec4579f4a2110b27664fd6c593f3e0a3c47"
SYNTH_SCENES = {"H": 19, "F": 18}
JAX_CPU_ME_SYNTH = {"H": 0.003905216735107873, "F": 0.0381156596874729}
SYNTH_ME_GATE = 0.08

# Phase 9 (real images) renders its images with numpy from a fixed seed:
# the card's machine has neither PIL nor OpenCV, and no photograph is
# fetched. tests/test_torch_real_images.py loads these functions from this
# file by path. Every step is plain float64 arithmetic (no LAPACK, no
# trigonometry), and the images are quantized to 8 bits, as a photograph
# is, so that every machine renders the same bytes.
H_PAIR_SHAPE = (480, 640)  # AdelaideRMF breadcube's frames
FACADE_SHAPE = (768, 1024)  # unihouse's
# The H pair's planar regions: (x0, y0, x1, y1) in view 1, and the motion
# into view 2 about the region's center, [[c, -s, dx], [s, c, dy], [p1, p2,
# 1]] with (c, s) a scaled rotation (2, -3 and 1 degrees).
H_REGIONS = (
    ((40, 40, 300, 250), (1.02937, 0.03595, 22.0, 14.0, 1.5e-4, 0.0)),
    ((340, 60, 600, 300), (0.96867, -0.05077, -26.0, 18.0, 0.0, 2e-4)),
    ((120, 300, 520, 450), (0.99985, 0.01745, 8.0, -20.0, -1e-4, 1e-4)),
)
H_MATCH_TOL = 4.0  # px: a match farther from its region's homography is an outlier
# The facade's two walls, each the unit square (u along the wall, v down it)
# carried into the image by the homography of the corners (u, v) = (0, 0),
# (1, 0), (1, 1), (0, 1): their horizontals run to a left and a right
# vanishing point, their verticals to one far below. Each wall carries dark
# dashed lines (a width of 0.01 of the wall, dashes 0.75 of a 0.15 period)
# at u and v = 0.25, 0.5 and 0.75.
FACADE_WALLS = (
    ((70, 190), (500, 110), (506, 700), (86, 600)),
    ((500, 110), (970, 210), (952, 590), (506, 700)),
)
FACADE_LINES = (0.25, 0.5, 0.75)


def _blob_texture(rng, shape, n_blobs, box=None, sigma=3.0):
    """Random smooth blobs (tests/test_detect.py's texture) centred inside
    box (y0, y1, x0, x1), float64 in 0..255."""
    h, w = shape
    y0, y1, x0, x1 = box or (0, h, 0, w)
    img = np.zeros(shape)
    ys, xs = rng.uniform(y0, y1, n_blobs), rng.uniform(x0, x1, n_blobs)
    amp = rng.uniform(40, 200, n_blobs)
    r = int(4 * sigma)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    for y, x, a in zip(ys, xs, amp):
        cy, cx = int(y), int(x)
        blob = a * np.exp(-((yy + cy - y) ** 2 + (xx + cx - x) ** 2) / (2 * sigma ** 2))
        ya, xa = max(cy - r, 0), max(cx - r, 0)
        yb, xb = min(cy + r + 1, h), min(cx + r + 1, w)
        img[ya:yb, xa:xb] += blob[ya - cy + r:yb - cy + r, xa - cx + r:xb - cx + r]
    return np.clip(img, 0, 255)


def _inv3(m):
    """The inverse of a 3 x 3 matrix by its adjugate."""
    a, b, c, d, e, f, g, h, i = m.reshape(9)
    adj = np.array([[e * i - f * h, c * h - b * i, b * f - c * e],
                    [f * g - d * i, a * i - c * g, c * d - a * f],
                    [d * h - e * g, b * g - a * h, a * e - b * d]])
    return adj / (a * adj[0, 0] + b * adj[1, 0] + c * adj[2, 0])


def _pull(h, shape):
    """The points of view 1 that homography h carries to each pixel of a
    view of `shape`: (x, y) [H, W] each."""
    hi = _inv3(h)
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]].astype(float)
    den = hi[2, 0] * xs + hi[2, 1] * ys + hi[2, 2]
    return ((hi[0, 0] * xs + hi[0, 1] * ys + hi[0, 2]) / den,
            (hi[1, 0] * xs + hi[1, 1] * ys + hi[1, 2]) / den)


def _bilinear(img, x, y):
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def _quantize(img, rng, noise):
    return np.clip(np.round(img + rng.normal(scale=noise, size=img.shape)), 0,
                   255).astype(np.uint8)


def render_h_pair(seed=0):
    """Two 640 x 480 views of three blob-textured planar regions over a
    blob-textured background, each region carried into view 2 by its own
    homography (bilinear resampling), the background of view 2 another
    texture (its matches are outliers), with 2 grey levels of noise:
    (view 1, view 2) uint8 and the regions [((x0, y0, x1, y1), H)]."""
    rng = np.random.default_rng(seed)
    view1 = _blob_texture(rng, H_PAIR_SHAPE, 300)
    view2 = _blob_texture(rng, H_PAIR_SHAPE, 300)
    regions = []
    for (x0, y0, x1, y1), (c, s, dx, dy, p1, p2) in H_REGIONS:
        tex = _blob_texture(rng, H_PAIR_SHAPE, (x1 - x0) * (y1 - y0) // 150,
                            (y0 - 8, y1 + 8, x0 - 8, x1 + 8)) * 0.8 + 30.0
        view1[y0:y1, x0:x1] = tex[y0:y1, x0:x1]
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        to_c = np.array([[1.0, 0, -cx], [0, 1.0, -cy], [0, 0, 1.0]])
        back = np.array([[1.0, 0, cx], [0, 1.0, cy], [0, 0, 1.0]])
        h = back @ np.array([[c, -s, dx], [s, c, dy], [p1, p2, 1.0]]) @ to_c
        px, py = _pull(h, H_PAIR_SHAPE)
        inside = (px >= x0) & (px <= x1 - 1) & (py >= y0) & (py <= y1 - 1)
        view2[inside] = _bilinear(tex, px[inside], py[inside])
        regions.append(((x0, y0, x1, y1), h))
    return _quantize(view1, rng, 2.0), _quantize(view2, rng, 2.0), regions


def h_pair_labels(corrs, regions, tol=H_MATCH_TOL):
    """Each correspondence's true label: 1 + the region that holds its
    view-1 point when the region's homography carries that point within
    `tol` px of its view-2 point, else 0 (outlier)."""
    labels = np.zeros(len(corrs), np.int64)
    x1 = np.c_[corrs[:, :2], np.ones(len(corrs))]
    for k, ((x0, y0, xe, ye), h) in enumerate(regions):
        p = x1 @ h.T
        err = np.hypot(p[:, 0] / p[:, 2] - corrs[:, 2], p[:, 1] / p[:, 2] - corrs[:, 3])
        inside = ((corrs[:, 0] >= x0) & (corrs[:, 0] < xe)
                  & (corrs[:, 1] >= y0) & (corrs[:, 1] < ye))
        labels[inside & (err <= tol)] = k + 1
    return labels


def _square_to(quad):
    """The homography carrying the unit square's corners onto quad, in
    closed form (Heckbert's square-to-quad mapping)."""
    (x0, y0), (x1, y1), (x2, y2), (x3, y3) = (map(float, p) for p in quad)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    g = (dx3 * dy2 - dx2 * dy3) / den
    h = (dx1 * dy3 - dx3 * dy1) / den
    return np.array([[x1 - x0 + g * x1, x3 - x0 + h * x3, x0],
                     [y1 - y0 + g * y1, y3 - y0 + h * y3, y0], [g, h, 1.0]])


def render_facade(seed=0):
    """A 1024 x 768 uint8 image of two building walls in perspective whose
    dark dashed lines run along three vanishing directions, with one grey
    level of noise."""
    rng = np.random.default_rng(seed)
    img = np.full(FACADE_SHAPE, 190.0)
    for quad in FACADE_WALLS:
        u, v = _pull(_square_to(quad), FACADE_SHAPE)
        dark = np.zeros(FACADE_SHAPE, bool)
        for at in FACADE_LINES:
            dark |= (np.abs(u - at) < 0.005) & ((v % 0.15) < 0.1125)
            dark |= (np.abs(v - at) < 0.004) & ((u % 0.15) < 0.1125)
        img[dark & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)] = 70.0
    return _quantize(img, rng, 1.0)


def real_image_digests(view1, view2, facade, corrs):
    """SHA-256 of the H pair's bytes, the facade's and the matches' (float64)."""
    import hashlib

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    return {"h_pair": sha(view1, view2), "facade": sha(facade),
            "matches": sha(np.asarray(corrs, np.float64))}


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def _fail(msg):
    print(f"chip_smoke.py: {msg}", file=sys.stderr)
    sys.exit(2)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events_ms(run, reps, trials=5):
    """CUDA events around run(), divided by reps; median of trials."""
    import torch

    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(fn, reps=100):
    """Time of one fn() called back to back from Python: what the engine
    pays per call, host launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(reps)], reps)


def _device_ms(fn, reps=20):
    """Device time of one fn(): reps calls captured in a CUDA graph and
    replayed, so that host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


# Operations of each family's residual per (hypothesis, valid point).
# Homography, 20: projection 12 (6 mul, 6 add), the |pz| test 1, transfer
# error 7 (2 div, 2 sub, 2 mul, 1 add). Fundamental, 34: F x1 12, F^T x2
# 8, num 4, den 7, square, max and divide 3. PnP, 27: projection 18 (9
# mul, 9 add), the |qz| test 1, the error 7, the depth test 1.
RESIDUAL_OPS = {"homography": 20, "fundamental": 34, "pnp": 27}
# Bytes of a point (its coordinates, f32 compound, the mask byte) and of a
# descriptor, by family: float4 and 3 x 3 but for PnP's 5 floats and 3 x 4.
POINT_BYTES = {"pnp": 25}
DESC_BYTES = {"pnp": 48}


def _score_bound(b, n_valid, n_pts, magsac_levels, family):
    """Least time of one scoring pass over R rows on an H100 (n_valid: the
    valid points of each row): operations over the f32 peak against bytes
    over the HBM rate. Operations per (hypothesis, valid point): the
    residual's (RESIDUAL_OPS), x = r2 / tau_t^2 1, pref 2 (sub, max), five
    sums 9 (raw: add; shared: min, add; inliers: compare, add; dot: mul,
    add; norm: mul, add); with m MAGSAC levels, 4 m + 1 more (div, sub,
    max, add per level, one scale by 1/m). Masked points are skipped, so
    only valid points count. Bytes a row: 21 per point (float4 of
    coordinates, f32 compound, the bool mask as one byte; 25 for PnP's
    five floats), 36 per descriptor (48 for PnP) and 16 of outputs per
    hypothesis, and 5 of the row's threshold and compound flag."""
    flops_pair = RESIDUAL_OPS[family] + 12 + (4 * magsac_levels + 1 if magsac_levels else 0)
    flops = b * sum(n_valid) * flops_pair
    nbytes = len(n_valid) * (n_pts * POINT_BYTES.get(family, 21)
                             + b * (DESC_BYTES.get(family, 36) + 16) + 5)
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _scene_tensors(torch, dev, scene, rng):
    """A bundled scene padded as the API pads it: (data [N, 4], point
    mask [N], a random compound preference [N], valid count). The scene
    "essential-s" is the two-motion gauntlet scene of seed s in the
    calibrated coordinates findEssentialMatrices fits (400
    correspondences, pad 512); SYNTHETIC is made here: 7000 correspondences of three
    homographies near the identity (0.5 px noise) and 30% outliers in a
    1000 px square, padded to the largest pad level, 7680. "synthH:name"
    and "synthF:name" are scenes of the synthetic datasets, padded to
    their bucket of the dataset pass. "tless" is the bundled T-LESS scene
    as find6DPoses fits it: rows (x, y, X, Y, Z) normalized by K^-1
    (data [N, 5]), 1,886 of them padded to 2,304."""
    from progressivex_tpu_torch.api import _pad_to, essential_inputs, pose_inputs
    from progressivex_tpu_torch.eval.adelaide import _bucket_size
    from progressivex_tpu_torch.eval.extras import TLESS_KW, gauntlet_camera, gauntlet_scene
    from progressivex_tpu_torch.io.data import load_corr_scene, load_tless_scene

    pad = _pad_to
    if scene == SYNTHETIC:
        corrs = _synthetic_corrs(rng, 7000)
    elif scene.startswith("essential-"):
        K = gauntlet_camera()
        pixels, _ = gauntlet_scene("two", int(scene.partition("-")[2]))
        corrs = essential_inputs(pixels, K, K, 1.0)[0]
    elif scene.startswith("synth"):
        problem, _, name = scene[5:].partition(":")
        corrs, _ = load_corr_scene(name, root=_synth_roots()[problem])
        pad = _bucket_size
    elif scene == "tless":
        xy, xyz, K, _ = load_tless_scene()
        corrs = pose_inputs(xy, xyz, K, TLESS_KW["threshold"])[0]
    else:
        corrs, _ = load_corr_scene(scene)
    n, n_pad = len(corrs), pad(len(corrs))
    data = torch.zeros(n_pad, corrs.shape[1], dtype=torch.float32, device=dev)
    data[:n] = torch.as_tensor(corrs, dtype=torch.float32, device=dev)
    pmask = torch.arange(n_pad, device=dev) < n
    compound = torch.as_tensor(rng.uniform(0, 1, n_pad), dtype=torch.float32,
                               device=dev) * pmask
    return data, pmask, compound, n


SYNTHETIC = "synthetic-7680"


def _synth_roots():
    """{problem: directory} of the synthetic datasets, made once."""
    from progressivex_tpu_torch.eval.synth_adelaide import ensure_synth_dataset

    return {p: ensure_synth_dataset(p, root=SYNTH_ROOT) for p in "HF"}


def _synth_digest(roots):
    """SHA-256 over the synthetic datasets' scene names and file bytes."""
    import hashlib

    h = hashlib.sha256()
    for p in "HF":
        for name in sorted(os.listdir(roots[p])):
            h.update(name.encode())
            with open(os.path.join(roots[p], name, f"{name}.txt"), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _synth_plan():
    """[(problem, LaneBatch, scene names)] of the dataset pass at lane
    target 1 (eval/adelaide.lane_plan)."""
    from progressivex_tpu_torch.eval.adelaide import discover_scenes, lane_plan
    from progressivex_tpu_torch.io.data import load_corr_scene

    out = []
    for problem, root in _synth_roots().items():
        _, names, _ = discover_scenes(problem, root)
        sizes = [len(load_corr_scene(n, root=root)[1]) for n in names]
        for batch in lane_plan(problem, sizes, 1):
            out.append((problem, batch, [f"synth{problem}:{names[i]}" for i in batch.scenes]))
    return out


def phase_synth_data():
    """The synthetic datasets under build/synth, the same bytes as the
    files the JAX package's CPU reference ran on."""
    roots = _synth_roots()
    digest = _synth_digest(roots)
    print("synthetic datasets", json.dumps({"roots": roots, "sha256": digest}), flush=True)
    if digest != SYNTH_DIGEST:
        raise AssertionError(f"synthetic datasets differ from the reference's files: "
                             f"{digest} != {SYNTH_DIGEST}")
    return roots


def _synthetic_corrs(rng, n):
    """n correspondences (x1, y1, x2, y2): 30% outliers, the rest split
    over three homographies near the identity, with 0.5 px noise."""
    x1 = rng.uniform(0, 1000, (n, 2))
    x2 = rng.uniform(0, 1000, (n, 2))
    n_in = int(0.7 * n)
    for i, part in enumerate(np.array_split(np.arange(n_in), 3)):
        h = np.eye(3) + rng.normal(0, [[1e-2, 1e-2, 5.0], [1e-2, 1e-2, 5.0],
                                       [1e-5, 1e-5, 0.0]])
        h[:2, 2] += 40.0 * i
        p = np.c_[x1[part], np.ones(len(part))] @ h.T
        x2[part] = p[:, :2] / p[:, 2:] + rng.normal(0, 0.5, (len(part), 2))
    return np.c_[x1, x2]


def _minimal_descs(torch, family, data, n, count, rng):
    """`count` finite descriptors of valid minimal solves on random
    samples of the scene's first n points, drawn 4096 samples at a time
    (about one seven-point sample in seven survives the oriented check on
    the F scenes)."""
    found = []
    for _ in range(64):
        idx = torch.as_tensor(rng.integers(0, n, (4096, family.sample_size)),
                              device=data.device)
        descs, valid = family.minimal_solver_batched(data[idx])
        descs = descs.reshape(-1, family.desc_dim)[valid.reshape(-1)]
        found.append(descs[torch.isfinite(descs).all(1)])
        if sum(len(f) for f in found) >= count:
            return torch.cat(found)[:count].contiguous()
    raise AssertionError("too few valid minimal solves")


def _tless_threshold():
    """find6DPoses' threshold on the T-LESS scene (TLESS_KW's 4 px) over
    the mean focal length, as the front end gives it to the fit."""
    from progressivex_tpu_torch.eval.extras import TLESS_KW
    from progressivex_tpu_torch.io.data import load_tless_scene

    K = load_tless_scene()[2]
    return TLESS_KW["threshold"] / (0.5 * (K[0, 0] + K[1, 1]))


def _check_and_time(torch, name, data, descs, compound, pmask, trunc_sq, exponent,
                    has, m, n_valid, label):
    """The kernel `name` over rows (data [R, N, 4], descs [R, B, 9],
    compound and pmask [R, N], trunc_sq and has [R]) against its plain
    version on the same CUDA tensors, then timed: the C launch alone by
    graph replay, the plain version, the wrapper on the host, and the
    launch floor. n_valid: the valid points of each row. Returns the case
    dict; raises on a disagreement."""
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import scoring as ks

    cuda_fn = getattr(ks, f"{name}_cuda")
    plain_fn = getattr(ks, f"{name}_plain")
    kernel = _build.entry_point(name, ks._ARGS)
    dev = data.device
    r, n_pad = data.shape[:2]
    b = descs.shape[1]
    args = (data, descs, compound, pmask, trunc_sq, exponent, has, m)
    got = cuda_fn(*args)
    want = plain_fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name}: inliers differ at {label}")
    err = 0.0
    for g, w_, what in zip(got, want, ("scores", "inliers", "dots", "norms")):
        if what == "inliers":
            continue
        if not torch.allclose(g, w_, rtol=1e-3, atol=1e-2):
            raise AssertionError(f"{name}: {what} differ at {label}: max abs "
                                 f"{float((g - w_).abs().max())}")
        err = max(err, float((g - w_).abs().max()))
    outs = [torch.empty(r, b, device=dev) for _ in range(3)]
    inl = torch.empty(r, b, dtype=torch.int32, device=dev)
    tau = trunc_sq.contiguous()
    has_b = has.to(torch.bool).contiguous()
    tiling = ks._tiling(b, n_pad, ks._sm_count(dev), r)

    def launch():
        e = kernel(data.data_ptr(), compound.data_ptr(), pmask.data_ptr(),
                   descs.data_ptr(), r, b, n_pad, tau.data_ptr(), has_b.data_ptr(),
                   exponent, m, *tiling, outs[0].data_ptr(), inl.data_ptr(),
                   outs[1].data_ptr(), outs[2].data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"{name} {tiling}: CUDA error {e}")

    family = name.removeprefix("score_")
    bound, bound_by = _score_bound(b, n_valid, n_pad, m, family)
    floor = torch.zeros(1, device=dev)  # the launch floor: one tiny kernel
    case = {
        "kernel": name, "label": label, "rows": r, "shape": [b, n_pad],
        "n_valid": n_valid, "magsac_levels": m, "has_compound": has.tolist(),
        "tiling": tiling, "ms": _device_ms(launch),
        "launch_floor_ms": _device_ms(floor.zero_),
        "plain_ms": _device_ms(lambda: plain_fn(*args)),
        "wrapper_ms": _host_ms(lambda: cuda_fn(*args)),
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
    }
    print("kernel case", json.dumps(case), flush=True)
    return case


def _kernel_cases(torch, dev, name, scenes, sizes, trunc_sq, exponent, rng):
    """The kernel `name` against its plain version, and timed, at every
    (scene, B in sizes, magsac_levels, compound on/off), one problem a
    launch (R = 1)."""
    from progressivex_tpu_torch.models import get_family

    family = get_family(name.removeprefix("score_"))
    cases, worst_abs = [], 0.0
    tau = torch.full((1,), trunc_sq, device=dev)
    for scene in scenes:
        data, pmask, compound, n = _scene_tensors(torch, dev, scene, rng)
        n_pad = data.shape[0]
        descs = _minimal_descs(torch, family, data, n, max(sizes), rng)
        for b in sizes:
            d = descs[:b].contiguous()
            for m in (0, 4):
                for has in (False, True):
                    case = _check_and_time(
                        torch, name, data[None], d[None], compound[None], pmask[None],
                        tau, exponent, torch.tensor([has], device=dev), m, [n],
                        f"{scene} B={b} N={n_pad} m={m} has={has}")
                    case["scene"] = scene
                    cases.append(case)
                    worst_abs = max(worst_abs, case["max_abs_err"])
    _padding_independence(torch, dev, name, family)
    return cases, worst_abs


def _padding_independence(torch, dev, name, family):
    """Masked rows corrupted to 1e6 change nothing
    (tests/test_pallas_scoring.py:67-77)."""
    from progressivex_tpu_torch.kernels import scoring as ks

    cuda_fn = getattr(ks, f"{name}_cuda")
    r = np.random.default_rng(0)
    data = torch.as_tensor(r.uniform(-50, 50, (256, 4)), dtype=torch.float32, device=dev)
    descs = _minimal_descs(torch, family, data, 256, 96, r)
    compound = torch.as_tensor(r.uniform(0, 1, 256), dtype=torch.float32, device=dev)
    pmask = torch.as_tensor(r.uniform(size=256) > 0.15, device=dev)
    base = cuda_fn(data, descs, compound, pmask, 25.0, 2.0, True)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = cuda_fn(bad, descs, compound, pmask, 25.0, 2.0, True)
    for g, b_ in zip(got, base):
        if not torch.allclose(g.double(), b_.double(), rtol=1e-5):
            raise AssertionError(f"{name}: padding rows changed the kernel's result")
    print(f"kernel {name} padding independence ok", flush=True)


def _row_kernel_cases(torch, dev, name, lane_scenes, restarts, b, trunc_sq,
                      exponent, rng, family_name=None):
    """The kernel over the rows a batched front end gives it: one lane a
    scene of `lane_scenes` (one pad level), `restarts` rows a lane
    (restart-major, as api_batch lays them out), B hypotheses a row of
    the row's own scene (minimal solves of `family_name`, by default the
    kernel's family), at m in {0, 4}, compound on and off in every row."""
    from progressivex_tpu_torch.models import get_family

    family = get_family(family_name or name.removeprefix("score_"))
    lanes = [_scene_tensors(torch, dev, s, rng) for s in lane_scenes]
    descs = [_minimal_descs(torch, family, d, n, b, rng) for d, _, _, n in lanes]
    rows = [j for _ in range(restarts) for j in range(len(lanes))]
    data = torch.stack([lanes[j][0] for j in rows])
    pmask = torch.stack([lanes[j][1] for j in rows])
    compound = torch.stack([lanes[j][2] for j in rows])
    d = torch.stack([descs[j] for j in rows]).contiguous()
    n_valid = [lanes[j][3] for j in rows]
    tau = torch.full((len(rows),), trunc_sq, device=dev)
    cases = []
    for m in (0, 4):
        for has in (False, True):
            case = _check_and_time(
                torch, name, data, d, compound, pmask, tau, exponent,
                torch.full((len(rows),), has, device=dev), m, n_valid,
                f"{len(rows)} rows x [{b}, {data.shape[1]}] m={m} has={has}")
            case["scenes"] = list(lane_scenes)
            cases.append(case)
    return cases


def _nan_rows_case(torch, dev, trunc_sq, rng):
    """score_fundamental on essential descriptors [3 x 4090, 512] of
    which some rows are NaN or inf, as an invalid five-point solution can
    give: the finite rows' outputs equal the plain version's and the
    kernel's on the same rows with the bad ones replaced; the bad rows
    leave the engine's mask (valid & finite score) at the plain version's
    verdict, since the minimal solver marks a non-finite E invalid."""
    from progressivex_tpu_torch.kernels import scoring as ks
    from progressivex_tpu_torch.models import get_family

    family = get_family("essential")
    data, pmask, compound, n = _scene_tensors(torch, dev, "essential-0", rng)
    descs = _minimal_descs(torch, family, data, n, 4090, rng)
    rows = 3
    d = descs[None].repeat(rows, 1, 1).contiguous()
    bad = torch.zeros(rows, 4090, dtype=torch.bool, device=dev)
    bad[0, [7, 100, 2000]] = True
    bad[1, 4089] = True
    bad[2, :64] = True
    d_bad = d.clone()
    d_bad[0, [7, 100]] = float("nan")
    d_bad[0, 2000, 3] = float("inf")
    d_bad[1, 4089, 0] = float("-inf")
    d_bad[2, :64, 4] = float("nan")
    args = (compound[None].repeat(rows, 1), pmask[None].repeat(rows, 1),
            torch.full((rows,), trunc_sq, device=dev), 2.0,
            torch.tensor([True, False, True], device=dev), 4)
    dr = data[None].repeat(rows, 1, 1).contiguous()
    got = ks.score_fundamental_cuda(dr, d_bad, *args)
    clean = ks.score_fundamental_cuda(dr, d, *args)
    want = ks.score_fundamental_plain(dr, d_bad, *args)
    torch.cuda.synchronize()
    ok = ~bad
    err = 0.0
    for g, c, w, what in zip(got, clean, want, ("scores", "inliers", "dots", "norms")):
        if not torch.equal(g[ok], c[ok]):
            raise AssertionError(f"NaN rows changed the finite rows' {what}")
        if what == "inliers":
            if not torch.equal(g[ok], w[ok]):
                raise AssertionError("NaN rows case: inliers differ from the plain version")
            continue
        if not torch.allclose(g[ok], w[ok], rtol=1e-3, atol=1e-2):
            raise AssertionError(f"NaN rows case: {what} differ from the plain version")
        err = max(err, float((g[ok] - w[ok]).abs().max()))
    valid = ~bad  # the solver's flag: a non-finite E is never valid
    masked_kernel = valid & torch.isfinite(got[0])
    masked_plain = valid & torch.isfinite(want[0])
    if not torch.equal(masked_kernel, masked_plain):
        raise AssertionError("NaN rows case: the engine's mask differs")
    case = {"kernel": "score_fundamental", "label": "essential NaN rows",
            "rows": rows, "shape": [4090, data.shape[0]], "bad_rows": int(bad.sum()),
            "kernel_bad_scores_finite": bool(torch.isfinite(got[0][bad]).all()),
            "plain_bad_scores_nan": bool(torch.isnan(want[0][bad]).all()),
            "max_abs_err": err}
    print("kernel case", json.dumps(case), flush=True)
    return case


def phase_kernel(torch, dev):
    """Each kernel against its plain version at its path's shapes, one
    problem a launch: H at [256 | 4, 384 | 2304 | 7680] (proposal sub-batch
    | LO candidates; 7680 is the largest pad level, on a synthetic scene),
    F at [1536 | 4, 256] (512 seven-point samples x 3 roots | LO
    candidates); then over rows, at the batched front ends' shapes: H
    [2 x 256, 384] (oldclassicswing, unionhouse) and [1 x 256, 2304]
    (unihouse), F [16 x 1536, 256] (book, breadcube, cubetoy and a
    replica: 4 lanes x 4 restarts); and F's kernel at the essential
    path's shapes, [3 x 4090, 512] alone and [12 x 4090, 512] batched,
    with a case of NaN and inf descriptor rows; then both kernels at the
    dataset pass's shapes: H [8 x 256, 256], [1 x 256, 384 | 512 | 768 |
    1536] and [4 x 256, 2304] on the synthetic H buckets' scenes, F
    [64 x 1536, 256 | 384] (16 lanes x 4 restarts); then both at the hyp
    axis's shapes: H [4 x 256, 2304] (four replicas of unihouse) and F
    [8 x 1536, 256] (two replicas of book's four restarts), each row
    scoring descriptors of its own; then score_pnp at the pose fit's
    shapes on T-LESS, [3 x 1600, 2304] (the proposal's field: 3 restarts
    x 400 P3P samples x 4 roots) and [3 x 4, 2304] (the LO's candidates)."""
    from progressivex_tpu_torch.core.config import truncated_sq_threshold

    rng = np.random.default_rng(0)
    tau_f = float(truncated_sq_threshold(0.75))
    out = {"score_homography": _kernel_cases(
        torch, dev, "score_homography", ("oldclassicswing", "unihouse", SYNTHETIC),
        (256, 4), 36.0, 2.0, rng)}
    out["score_fundamental"] = _kernel_cases(
        torch, dev, "score_fundamental", ("cubetoy",), (1536, 4), tau_f, 1.0, rng)
    rows = {
        "score_homography":
            _row_kernel_cases(torch, dev, "score_homography",
                              ("oldclassicswing", "unionhouse"), 1, 256, 36.0, 2.0, rng)
            + _row_kernel_cases(torch, dev, "score_homography", ("unihouse",), 1, 256,
                                36.0, 2.0, rng),
        "score_fundamental":
            _row_kernel_cases(torch, dev, "score_fundamental",
                              ("book", "breadcube", "cubetoy", "book"), 4, 1536,
                              tau_f, 1.0, rng),
    }
    # The essential path: E in place of F on calibrated coordinates, the
    # threshold over the focal length (1.5 / 800), exponent 2; three
    # restarts as rows, B = 409 samples x 10 solutions, one scene alone
    # and four in the batched call.
    tau_e = float(truncated_sq_threshold(1.5 / 800.0))
    essential = (
        _row_kernel_cases(torch, dev, "score_fundamental", ("essential-0",), 3, 4090,
                          tau_e, 2.0, rng, "essential")
        + _row_kernel_cases(torch, dev, "score_fundamental",
                            tuple(f"essential-{s}" for s in range(4)), 3, 4090,
                            tau_e, 2.0, rng, "essential"))
    essential.append(_nan_rows_case(torch, dev, tau_e, rng))
    # The dataset pass's shapes (phase 7, lane target 1): every bucket's
    # rows of its own scenes, replicated cyclically to the lanes.
    synth = {"score_homography": [], "score_fundamental": []}
    for problem, batch, names in _synth_plan():
        lanes = tuple(names[j % len(names)] for j in range(batch.lanes))
        if problem == "H":
            synth["score_homography"] += _row_kernel_cases(
                torch, dev, "score_homography", lanes, 1, 256, 36.0, 2.0, rng)
        else:
            synth["score_fundamental"] += _row_kernel_cases(
                torch, dev, "score_fundamental", lanes, batch.n_restarts, 1536,
                tau_f, 1.0, rng)
    # The hyp axis (phase 8): a row's replicas score as rows of one launch.
    hyp = {"score_homography": _row_kernel_cases(
               torch, dev, "score_homography", ("unihouse",) * 4, 1, 256, 36.0, 2.0, rng),
           "score_fundamental": _row_kernel_cases(
               torch, dev, "score_fundamental", ("book",) * 8, 1, 1536, tau_f, 1.0, rng)}
    # The pose fit (find6DPoses, T-LESS): 3 restarts as rows, the 4 px
    # threshold over the mean focal length.
    tau_p = float(truncated_sq_threshold(_tless_threshold()))
    pose = (_row_kernel_cases(torch, dev, "score_pnp", ("tless",), 3, 1600, tau_p, 2.0, rng)
            + _row_kernel_cases(torch, dev, "score_pnp", ("tless",), 3, 4, tau_p, 2.0, rng))
    # One launch of each kernel captured in a CUDA graph (the compiled
    # fit's form, core/graphs.py) at a main-path shape, replayed.
    captured = {
        "score_homography": _captured_launch_case(
            torch, dev, "score_homography", ("unihouse",), 1, 256, 36.0, 2.0, rng),
        "score_fundamental": _captured_launch_case(
            torch, dev, "score_fundamental", ("book",), 4, 1536, tau_f, 1.0, rng),
        "score_pnp": _captured_launch_case(
            torch, dev, "score_pnp", ("tless",), 3, 1600, tau_p, 2.0, rng)}
    return out, rows, essential, synth, hyp, captured, pose


def _captured_launch_case(torch, dev, name, lane_scenes, restarts, b, trunc_sq,
                          exponent, rng):
    """One launch of the kernel `name` through its wrapper, captured in a
    CUDA graph on a side stream (after a warm-up launch) as core/graphs.py
    captures it, then replayed into outputs overwritten with NaN: every
    output bit for bit a direct launch's on the same inputs, the capture's
    tally one launch of `rows` rows, and a replay adding exactly that to
    the launch table (kernels/_build.py)."""
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import scoring as ks
    from progressivex_tpu_torch.models import get_family

    fn = getattr(ks, f"{name}_cuda")
    family = get_family(name.removeprefix("score_"))
    lanes = [_scene_tensors(torch, dev, s, rng) for s in lane_scenes]
    rows = [j for _ in range(restarts) for j in range(len(lanes))]
    data = torch.stack([lanes[j][0] for j in rows])
    pmask = torch.stack([lanes[j][1] for j in rows])
    compound = torch.stack([lanes[j][2] for j in rows])
    descs = torch.stack([_minimal_descs(torch, family, lanes[j][0], lanes[j][3], b, rng)
                         for j in rows]).contiguous()
    tau = torch.full((len(rows),), trunc_sq, device=dev)
    has = torch.ones(len(rows), dtype=torch.bool, device=dev)
    args = (data, descs, compound, pmask, tau, exponent, has, 4)
    direct = fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = fn(*args)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for t in out:
        t.fill_(-1 if t.dtype == torch.int32 else float("nan"))
    before = (dict(_build.LAUNCHES), dict(_build.UNITS))
    graph.replay()
    _build.add_counts(tally)
    torch.cuda.synchronize()
    same = [torch.equal(g.view(torch.int32), w.view(torch.int32))
            for g, w in zip(out, direct)]
    added = (_build.LAUNCHES[name] - before[0][name], _build.UNITS[name] - before[1][name])
    case = {"kernel": name, "rows": len(rows), "shape": [b, data.shape[1]],
            "bit_equal": same, "tally": list(tally), "counted": list(added)}
    print("kernel captured launch", json.dumps(case), flush=True)
    if not all(same):
        raise AssertionError(f"{name}: the replayed launch differs from a direct one: {same}")
    if tally != [(name, len(rows))] or added != (1, len(rows)):
        raise AssertionError(f"{name}: captured launch tallied {tally}, counted {added}")
    return case


# Integer operations of the threefry2x32 block a counter
# (csrc/threefry.cu): 20 rounds of add, rotate (shift, shift, or) and xor,
# 5 key injections of 3 adds, the 2 adds of the first injection and the
# key schedule's 2 xors; 1 more (the xor of the two words) for bits.
THREEFRY_OPS = 20 * 5 + 5 * 3 + 2 + 2
# The pass F P-NAPSAC gumbel field: 64 rows x 6 rounds of keys, 512
# hypotheses x 48 neighbor slots each, [64 x 6 x 512, 48] words.
GUMBEL_F_SHAPE = (64 * 6, 512 * 48, False, False)


def _threefry_bound(n_keys, count, pair, offsets):
    """Least time of one threefry launch on an H100: its integer
    operations over the card's float32 rate (the table of peak rates has
    no integer row outside the tensor cores; the int32 units issue at half
    that rate, so the bound is a low one) against its bytes over the HBM
    rate: 4 a word written, 16 a key and 8 an offset read."""
    words = n_keys * count * (2 if pair else 1)
    ops = n_keys * count * (THREEFRY_OPS + (0 if pair else 1))
    nbytes = words * 4 + n_keys * (16 + (8 if offsets else 0))
    t_ops = ops / PEAK_F32_FLOP_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _threefry_case(torch, dev, shape, label, rng, timed):
    """The threefry kernel against its plain version on the same CUDA
    tensors, bit for bit, at one launch shape (keys, counters a key,
    pair, offsets) with random keys (and offsets); with `timed`, the C
    launch alone by graph replay, the plain version, the wrapper on the
    host and the launch floor beside the bound."""
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import threefry as kt

    n_keys, count, pair, has_off = shape
    keys = torch.as_tensor(rng.integers(0, 2**32, (n_keys, 2)), dtype=torch.int64,
                           device=dev)
    offsets = (torch.as_tensor(rng.integers(0, 2**32, n_keys), dtype=torch.int64,
                               device=dev) if has_off else None)
    got = kt.threefry_cuda(keys, count, pair, offsets)
    want = kt.threefry_plain(keys, count, pair, offsets)
    torch.cuda.synchronize()
    case = {"kernel": "threefry", "label": label, "keys": n_keys, "count": count,
            "pair": pair, "offsets": has_off, "bit_equal": torch.equal(got, want),
            "max_abs_err": 0 if torch.equal(got, want) else
            float((got.double() - want.double()).abs().max())}
    if timed:
        kernel = _build.entry_point("threefry", kt._ARGS)
        out = torch.empty(n_keys * count * (2 if pair else 1), dtype=torch.int32, device=dev)

        def launch():
            e = kernel(keys.data_ptr(), None if offsets is None else offsets.data_ptr(),
                       n_keys, count, int(pair), out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"threefry: CUDA error {e}")

        bound, bound_by = _threefry_bound(n_keys, count, pair, has_off)
        floor = torch.zeros(1, device=dev)
        case.update({"ms": _device_ms(launch), "launch_floor_ms": _device_ms(floor.zero_),
                     "plain_ms": _device_ms(lambda: kt.threefry_plain(keys, count, pair,
                                                                      offsets)),
                     "wrapper_ms": _host_ms(lambda: kt.threefry_cuda(keys, count, pair,
                                                                     offsets)),
                     "bound_ms": bound, "bound_by": bound_by})
    print("kernel case", json.dumps(case), flush=True)
    if not case["bit_equal"]:
        raise AssertionError(f"threefry differs from its plain version at {label} {shape}")
    return case


# The batch shapes of the smallest-eigenvector kernel (kernels/linalg.py)
# in the benchmark's cells, n = 9 unless given: a single H fit's refits
# [1 x 20] and [4 x 10], F's rank-2 step [4 x 10] at n = 3, the pass
# cells' rows [32 | 128 x 8]; and PnP's DLT at n = 12.
EIGVEC_SHAPES = (((1, 20), 9), ((4, 10), 9), ((4, 10), 3), ((32, 8), 9), ((128, 8), 9),
                 ((4, 10), 12))
EIGVEC_ITERS = 6
# The kernel against the plain version on the same CUDA matrices: both
# unit vectors from one start and one iteration, compared entry by entry;
# the trace and the squared norms are summed in another order
# (tests/test_torch_eigvec_cuda.py's ATOL).
EIGVEC_ATOL = 2e-5


def _eigvec_ops(n, iters):
    """Floating-point operations of one matrix in csrc/eigvec_psd.cu: the
    shift (trace n + 1, shift 2, Ms 2 n^2); each of the n pivot steps (the
    column's |a| - used * 1e18 3n, the argmax n, the one-hot pivot row
    2 n^2, the guard 2, the division n, the factors 2n, the update 5 n^2,
    used n); each iteration's replay (n steps of the one-hot sum 2n, the
    division 1 and the update 6n; the permutation 2 n^2; the norm 2n + 2;
    the division n)."""
    return (2 * n * n + n + 3 + n * (7 * n * n + 8 * n + 2)
            + iters * (n * (8 * n + 1) + 2 * n * n + 3 * n + 2))


def _eigvec_bound(batch, n, iters):
    """Least time of one eigvec_psd launch on an H100: its operations over
    the f32 peak against its bytes (n^2 floats read, n written a matrix)
    over the HBM rate. Both lie far below the launch floor: the kernel is
    bound by the latency of its dependent pivot steps."""
    t_ops = batch * _eigvec_ops(n, iters) / PEAK_F32_FLOP_S * 1e3
    t_bytes = batch * (n * n + n) * 4 / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _eigvec_grams(torch, shape, n, rng):
    """Normal matrices X^T X of 3n rows a matrix, float32: one pixel-scale
    row each, and half of them with a near null vector (the last column a
    mix of the others up to 1e-4), as the weighted DLT's rows give."""
    X = rng.normal(size=(*shape, 3 * n, n))
    X[..., 0, :] *= 1e3
    near = rng.random(shape) < 0.5
    mix = X[..., :-1] @ rng.normal(size=n - 1) + 1e-4 * rng.normal(size=(*shape, 3 * n))
    X[..., -1] = np.where(near[..., None], mix, X[..., -1])
    return torch.from_numpy(np.einsum("...ki,...kj->...ij", X, X).astype(np.float32))


def _eigvec_compare(torch, got, want):
    """(non-finite entries where the plain version's are, max abs error
    over the finite ones)."""
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    return (torch.equal(torch.isfinite(got), fin),
            float(err.max()) if err.numel() else 0.0)


def phase_eigvec(torch, dev):
    """The smallest-eigenvector kernel against its plain version on the
    same CUDA matrices at EIGVEC_SHAPES, each timed (the C launch alone by
    graph replay, the plain version the same way, the wrapper on the host)
    beside its bound and the launch floor; then degenerate matrices at each
    n (rank 1, zero, a zero row and column, constant, one inf, -inf and
    NaN entry): non-finite exactly where the plain version is; then one
    launch captured in a CUDA graph, replayed bit for bit, its tally one
    launch of its matrices."""
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import linalg as kl

    rng = np.random.default_rng(0)
    cases, failures = [], []
    floor = torch.zeros(1, device=dev)
    for shape, n in EIGVEC_SHAPES:
        M = _eigvec_grams(torch, shape, n, rng).to(dev)
        batch = M.numel() // (n * n)
        got = kl.smallest_eigvec_psd_cuda(M, EIGVEC_ITERS)
        want = kl.smallest_eigvec_psd_plain(M, EIGVEC_ITERS)
        torch.cuda.synchronize()
        finite_equal, err = _eigvec_compare(torch, got, want)
        kernel = _build.entry_point("eigvec_psd", kl._ARGS)
        out = torch.empty(batch, n, device=dev)

        def launch(M=M, batch=batch, n=n, out=out):
            e = kernel(M.data_ptr(), batch, n, EIGVEC_ITERS, out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"eigvec_psd: CUDA error {e}")

        bound, bound_by = _eigvec_bound(batch, n, EIGVEC_ITERS)
        case = {"kernel": "eigvec_psd", "shape": [*shape, n, n], "matrices": batch,
                "finite_equal": finite_equal, "max_abs_err": err,
                "ms": _device_ms(launch), "launch_floor_ms": _device_ms(floor.zero_),
                "plain_ms": _device_ms(lambda M=M: kl.smallest_eigvec_psd_plain(
                    M, EIGVEC_ITERS)),
                "wrapper_ms": _host_ms(lambda M=M: kl.smallest_eigvec_psd_cuda(
                    M, EIGVEC_ITERS)),
                "bound_ms": bound, "bound_by": bound_by}
        print("kernel case", json.dumps(case), flush=True)
        cases.append(case)
        if not finite_equal or err > EIGVEC_ATOL:
            failures.append(f"eigvec_psd at {case['shape']}: finite where the plain "
                            f"version is {finite_equal}, max abs error {err}")
    for n in kl.SIZES:
        M = _eigvec_grams(torch, (10,), n, rng)
        low = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
        M[0] = low @ low.T
        M[1] = 0.0
        M[2, :, 0] = 0.0
        M[2, 0, :] = 0.0
        M[3] = 1.0
        M[4, 1, 2] = float("inf")
        M[5, n - 1, n - 1] = -float("inf")
        M[6, 0, 1] = float("nan")
        M = M.to(dev)
        got = kl.smallest_eigvec_psd_cuda(M)
        finite_equal, err = _eigvec_compare(torch, got, kl.smallest_eigvec_psd_plain(M))
        row = {"kernel": "eigvec_psd", "degenerate": n, "finite_equal": finite_equal,
               "non_finite_matrices": int((~torch.isfinite(got).all(-1)).sum()),
               "max_abs_err": err}
        print("kernel degenerate", json.dumps(row), flush=True)
        cases.append(row)
        if not finite_equal or err > EIGVEC_ATOL or row["non_finite_matrices"] != 3:
            failures.append(f"eigvec_psd degenerate n = {n}: {row}")
    M = _eigvec_grams(torch, (4, 10), 9, rng).to(dev)
    direct = kl.smallest_eigvec_psd(M)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        kl.smallest_eigvec_psd(M)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = kl.smallest_eigvec_psd(M)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    captured = {"kernel": "eigvec_psd", "captured": [4, 10, 9, 9],
                "bit_equal": torch.equal(out.view(torch.int32), direct.view(torch.int32)),
                "tally": list(tally)}
    print("kernel captured launch", json.dumps(captured), flush=True)
    if not captured["bit_equal"] or tally != [("eigvec_psd", 40)]:
        failures.append(f"eigvec_psd captured launch: {captured}")
    if failures:
        raise AssertionError("; ".join(failures))
    return cases, captured


def _eigvec_line(eigvec_phase, results):
    """The eigvec_psd kernel's entry of the {"kernels": ...} line: its
    launches in phase 3's timed fits, its time beside its bound at the
    single H fit's [1 x 20, 9, 9], and every timed shape."""
    cases, captured = eigvec_phase
    timed = [c for c in cases if "ms" in c]
    main_case = next(c for c in timed if c["shape"] == [1, 20, 9, 9])
    return {
        "name": "eigvec_psd", "route": "cuda",
        "source": "progressivex_tpu_torch/csrc/eigvec_psd.cu",
        "replaces": "progressivex_tpu/ops/linalg.py:405",
        "replaces_note": "smallest_eigvec_psd, lowered by XLA inside the compiled fit; "
                         "no Pallas kernel",
        "launches": sum(r.get("eigvec_launches", 0) for p in results.values()
                        for r in p.values()),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "shape": main_case["shape"],
        "wrapper_ms": main_case["wrapper_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "captured_launch_bit_equal": captured["bit_equal"],
        "timed": [{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "launch_floor_ms", "max_abs_err")} for c in timed],
    }


# The refit kernel's (kernels/pnp.py) launch shapes in a pose fit:
# 3 restarts as rows x P = 4 (the proposals' LO), 8 (the final polishes)
# and 10 (the PEARL rounds) instances over the cell's 2,304 padded points.
REFINE_SHAPES = ((3, 4, 2304), (3, 8, 2304), (3, 10, 2304))
REFINE_ITERS = 6
# The kernel against the plain version on the same CUDA tensors: `ok`
# equal, a returned start bit for bit, a refitted pose within these on R's
# entries and on |t| (tests/test_torch_pnp_refine_cuda.py's R_ATOL, T_RTOL).
REFINE_R_ATOL = 1e-4
REFINE_T_RTOL = 1e-4
# Floating-point operations of one point in one Gauss-Newton step of
# csrc/pnp_refine.cu: q = R X + t 18, 1 / z 1, the residual 4, d proj /
# d q_z 4, q - t 3, J 10, the weight factor 2, Jw 12, H's 21 entries (two
# products and two sums each) 84, g's 6 entries 24.
REFINE_OPS = 162


def _refine_bound(rows, p, n, iters):
    """Least time of one pnp_refine launch on an H100: its operations over
    the f32 peak against its bytes (a row's points and each problem's
    weights read once, 12 floats read and written and a byte written a
    problem) over the HBM rate. Both lie under the launch floor: the
    kernel is bound by its six dependent steps."""
    t_ops = rows * p * n * iters * REFINE_OPS / PEAK_F32_FLOP_S * 1e3
    t_bytes = (rows * n * 5 * 4 + rows * p * (n * 4 + 2 * 12 * 4 + 1)) / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _refine_problem(torch, rows, p, n, rng):
    """float32 (data [rows, n, 5], weights [rows, p, n], starts [rows, p,
    12]) like a pose fit's refits: object points (mm) about 700 mm before
    the camera seen through a pose with noise in normalized coordinates, a
    fifth of them outliers, PEARL-like weights (1 - r^2 / tau^2 at the
    pose, a tenth of them zero), starts off by up to 3 degrees and ~5 mm."""
    data = np.empty((rows, n, 5))
    weights = np.empty((rows, p, n))
    inits = np.empty((rows, p, 12))

    def rotation(angle):
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K

    for i in range(rows):
        R, t = rotation(rng.uniform(0, np.pi)), np.array([0.0, 0.0, 700.0])
        X = rng.normal(scale=40.0, size=(n, 3))
        cam = X @ R.T + t
        xy = cam[:, :2] / cam[:, 2:] + rng.normal(scale=1e-3, size=(n, 2))
        out = rng.random(n) < 0.2
        xy[out] = rng.uniform(-0.1, 0.1, size=(out.sum(), 2))
        data[i] = np.concatenate([xy, X], 1)
        r2 = ((xy - cam[:, :2] / cam[:, 2:]) ** 2).sum(1) / (4e-3) ** 2
        for k in range(p):
            weights[i, k] = np.maximum(1.0 - r2, 0.0) * (rng.random(n) < 0.9)
            R0 = rotation(rng.uniform(0, np.radians(3))) @ R
            inits[i, k] = np.concatenate([R0, (t + rng.normal(scale=5.0, size=3))[:, None]],
                                         1).reshape(12)
    return tuple(torch.from_numpy(x.astype(np.float32)) for x in (data, weights, inits))


def _refine_compare(torch, got, want):
    """(ok equal, non-finite entries and returned starts equal, max error
    on R's entries, max error on t over |t|) of the kernel's (descs, ok)
    against the plain version's."""
    (gd, gok), (wd, wok) = got, want
    ok_equal = torch.equal(gok, wok)
    same = (torch.equal(torch.isfinite(gd), torch.isfinite(wd))
            and torch.equal(gd[~wok].nan_to_num().view(torch.int32),
                            wd[~wok].nan_to_num().view(torch.int32)))
    both = (gok & wok).reshape(-1)
    g = gd.reshape(-1, 3, 4)[both].double()
    w = wd.reshape(-1, 3, 4)[both].double()
    if not len(g):
        return ok_equal, same, 0.0, 0.0
    r_err = float((g[..., :3] - w[..., :3]).abs().max())
    t_err = float(((g[..., 3] - w[..., 3]).norm(dim=-1) / w[..., 3].norm(dim=-1)).max())
    return ok_equal, same, r_err, t_err


def phase_refine(torch, dev):
    """The pose refit kernel against its plain version on the same CUDA
    tensors at REFINE_SHAPES, each timed (the C launch alone by graph
    replay, the plain version the same way, the wrapper on the host)
    beside its bound and the launch floor; then one launch captured in a
    CUDA graph, replayed bit for bit, its tally one launch of its
    problems."""
    from progressivex_tpu_torch.kernels import _build
    from progressivex_tpu_torch.kernels import pnp as kpnp

    rng = np.random.default_rng(0)
    cases, failures = [], []
    floor = torch.zeros(1, device=dev)
    for rows, p, n in REFINE_SHAPES:
        data, weights, inits = (x.to(dev) for x in _refine_problem(torch, rows, p, n, rng))
        got = kpnp.refine_cuda(data, weights, inits, REFINE_ITERS)
        want = kpnp.refine_plain(data, weights, inits, REFINE_ITERS)
        torch.cuda.synchronize()
        ok_equal, same, r_err, t_err = _refine_compare(torch, got, want)
        kernel = _build.entry_point("pnp_refine", kpnp._ARGS)
        out = torch.empty_like(inits)
        ok = torch.empty(rows, p, dtype=torch.bool, device=dev)

        def launch(data=data, weights=weights, inits=inits, p=p, out=out, ok=ok):
            e = kernel(data.data_ptr(), weights.data_ptr(), inits.data_ptr(), data.shape[0],
                       p, data.shape[1], REFINE_ITERS, out.data_ptr(), ok.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"pnp_refine: CUDA error {e}")

        bound, bound_by = _refine_bound(rows, p, n, REFINE_ITERS)
        case = {"kernel": "pnp_refine", "shape": [rows, p, n], "problems": rows * p,
                "ok_equal": ok_equal, "non_finite_and_starts_equal": same,
                "valid": int(got[1].sum()), "r_max_abs_err": r_err, "t_max_rel_err": t_err,
                "ms": _device_ms(launch), "launch_floor_ms": _device_ms(floor.zero_),
                "plain_ms": _device_ms(lambda d=data, w=weights, i=inits: kpnp.refine_plain(
                    d, w, i, REFINE_ITERS)),
                "wrapper_ms": _host_ms(lambda d=data, w=weights, i=inits: kpnp.refine_cuda(
                    d, w, i, REFINE_ITERS)),
                "bound_ms": bound, "bound_by": bound_by}
        print("kernel case", json.dumps(case), flush=True)
        cases.append(case)
        if not (ok_equal and same and r_err <= REFINE_R_ATOL and t_err <= REFINE_T_RTOL):
            failures.append(f"pnp_refine at {case['shape']}: {case}")
    data, weights, inits = (x.to(dev) for x in _refine_problem(torch, 3, 10, 2304, rng))
    direct = kpnp.refine(data, weights, inits)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), _build.recording():
        kpnp.refine(data, weights, inits)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as tally, torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out, ok = kpnp.refine(data, weights, inits)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    out.fill_(float("nan"))
    ok.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    captured = {"kernel": "pnp_refine", "captured": [3, 10, 2304],
                "bit_equal": (torch.equal(out.view(torch.int32), direct[0].view(torch.int32))
                              and torch.equal(ok, direct[1])),
                "tally": list(tally)}
    print("kernel captured launch", json.dumps(captured), flush=True)
    if not captured["bit_equal"] or tally != [("pnp_refine", 30)]:
        failures.append(f"pnp_refine captured launch: {captured}")
    if failures:
        raise AssertionError("; ".join(failures))
    return cases, captured


def _refine_line(refine_phase, launches):
    """The pnp_refine kernel's entry of the {"kernels": ...} line: its
    launches in phase 3 P's fits, its time beside its bound at the PEARL
    rounds' [3 x 10, 2304], and every timed shape."""
    cases, captured = refine_phase
    main_case = next(c for c in cases if c["shape"] == [3, 10, 2304])
    return {
        "name": "pnp_refine", "route": "cuda",
        "source": "progressivex_tpu_torch/csrc/pnp_refine.cu",
        "replaces": "progressivex_tpu/models/pnp.py:187-241",
        "replaces_note": "the pose refit's lax.scan of six Gauss-Newton steps, lowered by "
                         "XLA inside the compiled fit; no Pallas kernel",
        "launches": launches,
        "r_max_abs_err": max(c["r_max_abs_err"] for c in cases),
        "t_max_rel_err": max(c["t_max_rel_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "shape": main_case["shape"],
        "wrapper_ms": main_case["wrapper_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "captured_launch_bit_equal": captured["bit_equal"],
        "timed": [{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "launch_floor_ms", "r_max_abs_err", "t_max_rel_err")}
                  for c in cases],
    }


def _pnp_line(pose_cases, captured, launches):
    """The score_pnp kernel's entry of the {"kernels": ...} line: its
    launches in phase 3 P's fits, its time beside its bound and the plain
    version's at the proposal's [3 x 1600, 2304] (m = 0, the pose path's),
    and every timed case."""
    main_case = next(c for c in pose_cases if c["shape"] == [1600, 2304]
                     and c["magsac_levels"] == 0 and all(c["has_compound"]))
    return {
        "name": "score_pnp", "route": "cuda",
        "source": "progressivex_tpu_torch/csrc/score_pnp.cu",
        "replaces": "progressivex_tpu/core/engine.py:189-195",
        "replaces_note": "compound_penalized_scores over the pose family's vmapped "
                         "squared_residual, fused by XLA; no Pallas kernel",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in pose_cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "shape": main_case["shape"], "rows": main_case["rows"],
        "tiling": main_case["tiling"], "wrapper_ms": main_case["wrapper_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "captured_launch_bit_equal": all(captured["bit_equal"]),
        "timed": [{k: c[k] for k in ("rows", "shape", "magsac_levels", "has_compound",
                                      "tiling", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "launch_floor_ms", "max_abs_err")}
                  for c in pose_cases],
    }


def _draw_paths(torch):
    """(label, call) of phase 2's draws: phase 10's paths (the single-scene
    paths of phase 3, phase 5's batched H and F, the dataset pass's H 2304
    bucket), the dataset pass's F bucket (16 lanes x 4 restarts, whose
    P-NAPSAC gumbel field is a fit's largest threefry launch) and phase
    8's hyp axis (unihouse H at hyp 4, book F at hyp 2)."""
    from progressivex_tpu_torch.eval import adelaide
    from progressivex_tpu_torch.parallel.sharding import make_mesh

    prep = adelaide._prepare("F", _synth_roots()["F"], 1, None, None)
    bucket = max(prep.plan, key=lambda b: b.rows)
    card = torch.device("cuda", 0)
    paths = _compiled_paths()
    paths.append((f"F pass bucket {bucket.n_pad} x {bucket.rows} rows",
                  lambda: adelaide._run(prep, bucket, 0, "cuda", None)))
    for problem, scene, hyp in (("H", "unihouse", 4), ("F", "book", 2)):
        paths.append((f"{problem} {scene} hyp {hyp}", lambda p=problem, s=scene, h=hyp:
                      _mesh_fit(torch, p, s, make_mesh(1, h, devices=[card] * h))))
    return paths


def phase_draws(torch, dev):
    """The draw of the samples on the card, path by path (`_draw_paths`,
    each fit eager, core/graphs.eager): every engine.draw on the card
    against the same draw on the CPU (the same keys, counts and kNN
    tables, copied) element for element, and the threefry kernel against
    its plain version bit for bit at every launch shape those draws gave
    it, and at GUMBEL_F_SHAPE; timed at each path's largest launch and at
    GUMBEL_F_SHAPE. Returns (draw rows, kernel cases)."""
    from progressivex_tpu_torch.core import engine, graphs
    from progressivex_tpu_torch.kernels import threefry as kt

    orig_draw, orig_cuda = engine.draw, kt.threefry_cuda
    label, shapes, draws, failures = [None], {}, [], []

    def seen(keys, count, pair, offsets=None):
        shapes.setdefault((keys.shape[0], int(count), bool(pair), offsets is not None),
                          label[0])
        return orig_cuda(keys, count, pair, offsets)

    def both(family, cfg, n_valid, keys, prep):
        card = orig_draw(family, cfg, n_valid, keys, prep)
        host = orig_draw(family, cfg, n_valid.cpu(), keys.cpu(), prep._replace(
            samp_idx=prep.samp_idx.cpu(), samp_mask=prep.samp_mask.cpu()))
        same = [torch.equal(a.cpu(), b) for a, b in zip(card, host)]
        row = {"path": label[0], "keys": list(keys.shape), "sampler_id": cfg.sampler_id,
               "samples": list(card[0].shape), "extension": list(card[2].shape),
               "equal": same}
        print("draw card against CPU", json.dumps(row), flush=True)
        draws.append(row)
        if not all(same):
            failures.append(f"{label[0]}: the card's draw differs from the CPU's {same}")
        return card

    engine.draw, kt.threefry_cuda = both, seen
    try:
        with graphs.eager():
            for name, call in _draw_paths(torch):
                label[0] = name
                call()
    finally:
        engine.draw, kt.threefry_cuda = orig_draw, orig_cuda
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    largest = {}
    for shape, name in shapes.items():
        if shape[0] * shape[1] > largest.get(name, (0, 0, 0, 0))[0] * largest.get(
                name, (0, 0, 0, 0))[1]:
            largest[name] = shape
    timed = set(largest.values()) | {GUMBEL_F_SHAPE}
    cases = [_threefry_case(torch, dev, shape, name, rng, shape in timed)
             for shape, name in sorted(shapes.items())]
    if GUMBEL_F_SHAPE not in shapes:
        cases.append(_threefry_case(torch, dev, GUMBEL_F_SHAPE, "pass F gumbel", rng, True))
    if failures:
        raise AssertionError("; ".join(failures))
    return draws, cases



PATHS = {
    # problem: (entry point, kernel, scenes, JAX CPU ME)
    "H": ("findHomographies", "score_homography",
          ("oldclassicswing", "unionhouse", "unihouse"), JAX_CPU_ME),
    "F": ("findTwoViewMotions", "score_fundamental",
          ("book", "breadcube", "cubetoy"), JAX_CPU_ME_F),
}


def _fit(problem, corrs, **kw):
    import progressivex_tpu_torch
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs

    fn = getattr(progressivex_tpu_torch, PATHS[problem][0])
    return fn(corrs, **scene_kwargs(len(corrs), problem), random_seed=0,
              with_statistics=True, **kw)


def phase_main_path(torch, problem):
    """One ported path under its AdelaideRMF protocol on its bundled
    scenes, after one untimed warm-up fit on its first scene, the launch
    counts set to 0 just before each timed scene and read after."""
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    _, kernel, scenes, jax_me = PATHS[problem]
    _fit(problem, load_corr_scene(scenes[0])[0])  # warm-up
    torch.cuda.synchronize()
    results = {}
    for scene in scenes:
        corrs, gt = load_corr_scene(scene)
        _zero_launches()
        t0 = time.perf_counter()
        models, labels, stats = _fit(problem, corrs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        me = float(misclassification(labels, gt))
        res = {"problem": problem, "scene": scene, "points": len(gt), "me": me,
               "jax_cpu_me": jax_me[scene], "wall_s": wall,
               "n_models": models.shape[0] // 3, "launches": launches[kernel],
               "other_launches": {k: v for k, v in launches.items() if k != kernel},
               "threefry_launches": _threefry_launches(scene),
               "eigvec_launches": _eigvec_launches(scene),
               "restart": stats.restart, "restart_energies": stats.restart_energies}
        print("main path", json.dumps(res), flush=True)
        if launches[kernel] <= 0:
            raise AssertionError(f"{scene}: {kernel} never launched")
        if not (models.shape[1] == 3 and models.shape[0] % 3 == 0
                and labels.shape == gt.shape):
            raise AssertionError(f"{scene}: output shapes {models.shape}, {labels.shape}")
        if not np.isfinite(models).all():
            raise AssertionError(f"{scene}: non-finite models")
        if me > jax_me[scene] + ME_SLACK:
            raise AssertionError(f"{scene}: ME {me} above the JAX package's "
                                 f"{jax_me[scene]} + {ME_SLACK}")
        results[scene] = dict(res, labels=labels)
    return results


def phase_card_vs_cpu(results, problem, scene):
    """The same scene through the port on the CPU, against the card."""
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification

    corrs, gt = load_corr_scene(scene)
    models, labels, stats = _fit(problem, corrs, device="cpu")
    cuda = results[scene]
    disagreement = float(np.mean(labels != cuda["labels"]))
    res = {"problem": problem, "scene": scene, "n_models_cuda": cuda["n_models"],
           "n_models_cpu": models.shape[0] // 3, "restart_cuda": cuda["restart"],
           "restart_cpu": stats.restart, "label_disagreement": disagreement,
           "me_cuda": cuda["me"], "me_cpu": float(misclassification(labels, gt))}
    print("card vs cpu", json.dumps(res), flush=True)
    if res["n_models_cpu"] != res["n_models_cuda"]:
        raise AssertionError(f"n_models differ: card {res['n_models_cuda']}, "
                             f"CPU {res['n_models_cpu']}")
    if res["restart_cpu"] != res["restart_cuda"]:
        raise AssertionError(f"winning restarts differ: card {res['restart_cuda']}, "
                             f"CPU {res['restart_cpu']}")
    if disagreement > LABEL_DISAGREEMENT_MAX:
        raise AssertionError(f"labels disagree on {disagreement:.4f} of points")


BATCHED = {"H": "findHomographiesBatched", "F": "findTwoViewMotionsBatched"}


def _batched(problem, names, **kw):
    """The batched front end of `problem` over the bundled scenes `names`,
    one call for each protocol variant among them (the H protocol splits
    only scenes padded to 512 or more, as the JAX harness gates it per
    pad level). Returns {name: (models, labels)}."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene

    corrs = {n: load_corr_scene(n)[0] for n in names}
    groups: dict = {}
    for n in names:
        pkw = scene_kwargs(len(corrs[n]), problem)
        groups.setdefault(json.dumps(pkw, sort_keys=True), (pkw, []))[1].append(n)
    fn = getattr(progressivex_tpu_torch, BATCHED[problem])
    out = {}
    for pkw, group in groups.values():
        res = fn([corrs[n] for n in group], **pkw, random_seed=0, **kw)
        out.update(zip(group, res))
    return out


# Phase 5's batched outputs of H and F, which phase 8's sharded calls must
# equal bit for bit (kept even when a phase 5 gate fails).
BATCHED_OUTPUTS = {}


def phase_batched(torch, problem):
    """The batched front end of `problem` on its bundled scenes, on the
    card, with the launch counts set to 0 just before it and read just
    after: each scene's ME against the JAX package's CPU ME, or its ME on
    the same draw where that is larger (JAX_SAME_DRAW_BATCHED_ME), +
    ME_SLACK; then each scene alone through the same front end against
    the same scene inside the batch, put first in the list so that its
    rows draw from the same keys as alone (api_batch folds a row's key
    from its scene's index): the same number of models, labels apart on at most
    LABEL_DISAGREEMENT_MAX of the points, instances matched one to one.
    Every scene is checked and printed before a failure raises."""
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    _, kernel, scenes, jax_me = PATHS[problem]
    _zero_launches()
    t0 = time.perf_counter()
    batch = _batched(problem, scenes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    BATCHED_OUTPUTS[problem] = batch  # phase 8's reference, whatever the gates say
    launches = dict(LAUNCHES)
    res = {"problem": problem, "entry": BATCHED[problem], "scenes": list(scenes),
           "wall_s": wall, "launches": launches[kernel],
           "other_launches": {k: v for k, v in launches.items() if k != kernel},
           "per_scene": {}}
    failures = [] if launches[kernel] > 0 else [f"batched {problem}: {kernel} never launched"]
    for scene in scenes:
        _, gt = load_corr_scene(scene)
        models, labels = batch[scene]
        if not (models.shape[1] == 3 and models.shape[0] % 3 == 0
                and labels.shape == gt.shape and np.isfinite(models).all()):
            raise AssertionError(f"batched {scene}: outputs {models.shape}, {labels.shape}")
        me = float(misclassification(labels, gt))
        limit = max(jax_me[scene], JAX_SAME_DRAW_BATCHED_ME.get(problem, {}).get(scene, 0.0))
        # A row's seed comes from its scene's index in the list, so the
        # batch it is held against puts the scene first, as alone.
        i = scenes.index(scene)
        first = batch if i == 0 else _batched(problem, scenes[i:] + scenes[:i])
        models, labels = first[scene]
        alone_models, alone_labels = _batched(problem, (scene,))[scene]
        k = models.shape[0] // 3
        same_k = alone_models.shape == models.shape
        disagreement = _label_disagreement(alone_labels, labels, k) if same_k else 1.0
        res["per_scene"][scene] = {
            "me": me, "jax_cpu_me": jax_me[scene], "limit": limit, "n_models": k,
            "n_models_alone": alone_models.shape[0] // 3,
            "me_alone": float(misclassification(alone_labels, gt)),
            "alone_label_disagreement": disagreement}
        if me > limit + ME_SLACK:
            failures.append(f"batched {scene}: ME {me} above the JAX package's "
                            f"{limit} + {ME_SLACK}")
        if not same_k:
            failures.append(f"batched {scene}: {k} models in the batch, "
                            f"{alone_models.shape[0] // 3} alone")
        elif disagreement > LABEL_DISAGREEMENT_MAX:
            failures.append(f"batched {scene}: alone and in the batch, labels "
                            f"disagree on {disagreement:.4f} of points")
    print("batched path", json.dumps(res), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(res, outputs=batch)


def _label_disagreement(a, b, k):
    """The share of points whose labels differ between two labelings of
    k instances (label k = outlier), under the one-to-one renumbering of
    the instances that agrees best: an instance's number is the order in
    which its slot was filled, which says nothing of the segmentation."""
    from scipy.optimize import linear_sum_assignment

    agree = np.zeros((k, k), np.int64)
    np.add.at(agree, (a[(a < k) & (b < k)], b[(a < k) & (b < k)]), 1)
    ri, ci = linear_sum_assignment(-agree)
    same = int(agree[ri, ci].sum()) + int(((a == k) & (b == k)).sum())
    return 1.0 - same / len(a)


def phase_bench():
    """`cli.bench_main` at a small lane target and one timing run: the
    port's throughput line on the bundled scenes, its mean ME (other seeds
    than phase 3's) within ME_SLACK of the JAX package's mean CPU ME."""
    from progressivex_tpu_torch.cli import bench_main

    t0 = time.perf_counter()
    out = bench_main(["--timing-runs", "1", "--lane-target", "4"])
    print(f"bench seconds {time.perf_counter() - t0:.3f}", flush=True)
    for problem, jax_me in (("H", JAX_CPU_ME), ("F", JAX_CPU_ME_F)):
        limit = float(np.mean(list(jax_me.values()))) + ME_SLACK
        if not out[f"adelaide{problem}_mean_me"] <= limit:
            raise AssertionError(f"bench adelaide{problem}_mean_me "
                                 f"{out[f'adelaide{problem}_mean_me']} above {limit}")
    return out


def _new_path(problem):
    """(entry point, batched entry point, keywords) of a new path, at the
    JAX package's keywords (eval/extras: bench_lines', bench_vps',
    tests/test_pose6d.py's)."""
    from progressivex_tpu_torch.eval import extras

    return {"L": ("findLines", "findLinesBatched", extras.LINES_KW),
            "V": ("findVanishingPoints", "findVanishingPointsBatched", extras.VP_KW),
            "P": ("find6DPoses", "find6DPosesBatched", extras.TLESS_KW)}[problem]


def _zero_launches():
    """Set every count of the launch table (kernels/_build.py) to 0."""
    from progressivex_tpu_torch.kernels import _build

    for counts in (_build.LAUNCHES, _build.UNITS):
        for k in counts:
            counts[k] = 0


def _threefry_launches(label):
    """threefry's launches since `_zero_launches`: every fit draws its
    samples on the card through it, so a path without one fails."""
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    n = LAUNCHES["threefry"]
    if n <= 0:
        raise AssertionError(f"{label}: threefry never launched")
    return n


def _eigvec_launches(label, required=True):
    """eigvec_psd's launches since `_zero_launches`: every weighted refit
    of the homography, fundamental, essential, vanishing-point and PnP
    paths solves through it, so such a path without one fails."""
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    n = LAUNCHES["eigvec_psd"]
    if required and n <= 0:
        raise AssertionError(f"{label}: eigvec_psd never launched")
    return n


def _refine_launches(label):
    """pnp_refine's launches since `_zero_launches`: every refit of a pose
    fit (LO, PEARL, the merges, the final polishes) runs through it, so a
    pose path without one fails."""
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    n = LAUNCHES["pnp_refine"]
    if n <= 0:
        raise AssertionError(f"{label}: pnp_refine never launched")
    return n


def _no_launches(label, own=None):
    """The scoring kernels' launch counts after a path: every kernel but
    the path's own (`own`: score_pnp on a pose path) must show 0, and the
    path's own must have run."""
    from progressivex_tpu_torch.kernels._build import LAUNCHES
    from progressivex_tpu_torch.kernels.scoring import KERNELS

    launches = {k: LAUNCHES[k] for k in KERNELS}
    if any(v for k, v in launches.items() if k != own):
        raise AssertionError(f"{label}: a scoring kernel ran on a path that has "
                             f"{own or 'none'}: {launches}")
    if own is not None and launches[own] <= 0:
        raise AssertionError(f"{label}: {own} never launched")
    return launches


def _pnp_launches(label, spans):
    """score_pnp's launches and rows since `_zero_launches` against the
    rounds the recorded `spans` show (one `progx.read.any_pearl` a round,
    in the graph and the eager form): a pose fit's proposal scores its
    field once and its LO candidates once a step (EngineConfig.lo_steps,
    2), each launch over the fit's 3 restarts as rows."""
    import dataclasses

    from progressivex_tpu_torch.core.config import EngineConfig
    from progressivex_tpu_torch.kernels._build import LAUNCHES, UNITS

    rounds = sum(sp.name == "progx.read.any_pearl" for sp in spans)
    lo_steps = {f.name: f.default for f in dataclasses.fields(EngineConfig)}["lo_steps"]
    per_round = 1 + lo_steps
    got = {"rounds": rounds, "launches": LAUNCHES["score_pnp"], "rows": UNITS["score_pnp"]}
    if rounds < 1 or got["launches"] != per_round * rounds or got["rows"] != 3 * got["launches"]:
        raise AssertionError(f"{label}: score_pnp {got}, not {per_round} launches of "
                             "3 rows a round")
    return got


def _new_scene(name):
    """A scene of the new paths by name: "lines-s" and "vp-s" are
    make_lines_scene(seed=s) and make_vp_scene(seed=s), "tless" the bundled
    T-LESS scene. Returns (inputs of the entry point, ground truth, limit):
    the ground-truth labels and the JAX package's CPU ME, or for T-LESS
    the ground-truth poses and K."""
    from progressivex_tpu_torch.eval.extras import make_lines_scene, make_vp_scene
    from progressivex_tpu_torch.io.data import load_tless_scene

    kind, _, seed = name.partition("-")
    if kind == "lines":
        pts, gt = make_lines_scene(seed=int(seed))
        return (pts,), gt, JAX_CPU_ME_LINES[int(seed)]
    if kind == "vp":
        segs, gt, _ = make_vp_scene(seed=int(seed))
        return (segs,), gt, JAX_CPU_ME_VP[int(seed)]
    xy, xyz, K, poses = load_tless_scene()
    return (xy, xyz), poses, K


def _n_models(problem, models):
    return models.shape[0] // 3 if problem == "P" else models.shape[0]


def _check_outputs(problem, name, models, labels, n_points):
    width = {"L": 3, "V": 3, "P": 4}[problem]
    if not (models.ndim == 2 and models.shape[1] == width and labels.shape == (n_points,)
            and np.isfinite(models).all()):
        raise AssertionError(f"{name}: outputs {models.shape}, {labels.shape}")


def _tless_errors(models, poses):
    from progressivex_tpu_torch.io.metrics import pose_errors

    k = models.shape[0] // 3
    return pose_errors([models[3 * i:3 * i + 3] for i in range(k)], poses)


def phase_new_path(torch, problem):
    """findLines or findVanishingPoints on its seed-0 scene, after one
    untimed warm-up fit of it, the launch counts set to 0 just before the
    timed fit and read after (the path reaches no kernel): ME against the
    JAX package's CPU ME + ME_SLACK."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.io.metrics import misclassification

    entry, _, kw = _new_path(problem)
    fn = getattr(progressivex_tpu_torch, entry)
    name = {"L": "lines-0", "V": "vp-0"}[problem]
    (data,), gt, jax_me = _new_scene(name)
    fn(data, **kw, random_seed=0)  # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    models, labels, stats = fn(data, **kw, random_seed=0, with_statistics=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"problem": problem, "entry": entry, "scene": name, "points": len(gt),
           "me": float(misclassification(labels, gt)), "jax_cpu_me": jax_me,
           "wall_s": wall, "n_models": _n_models(problem, models),
           "rounds": stats.rounds_run, "launches": _no_launches(name),
           "threefry_launches": _threefry_launches(name),
           "eigvec_launches": _eigvec_launches(name, problem == "V")}
    print("main path", json.dumps(res), flush=True)
    _check_outputs(problem, name, models, labels, len(gt))
    if res["me"] > jax_me + ME_SLACK:
        raise AssertionError(f"{name}: ME {res['me']} above the JAX package's "
                             f"{jax_me} + {ME_SLACK}")
    return dict(res, labels=labels)


def phase_tless(torch):
    """find6DPoses on T-LESS at TLESS_SEEDS, the launch counts set to 0
    just before each seed and read after (the path's one scoring kernel,
    score_pnp, 3 launches of 3 rows a round, and threefry, eigvec_psd and
    pnp_refine must have run; no other scoring kernel): every seed
    at least 2 instances, the mean pose errors at or under
    TLESS_MEAN_GATES or the JAX package's on the same seeds
    (JAX_SAME_DRAW_TLESS_MEAN), whichever is larger. The first seed's
    wall time holds the card's first SVD and solve calls."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.io import profiling

    (xy, xyz), poses, K = _new_scene("tless")
    kw = _new_path("P")[2]
    per_seed, failures, launches, pnp_launches = [], [], 0, 0
    for seed in TLESS_SEEDS:
        _zero_launches()
        t0 = time.perf_counter()
        with profiling.recording() as spans:
            models, labels, stats = progressivex_tpu_torch.find6DPoses(
                xy, xyz, K, **kw, random_seed=seed, with_statistics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_outputs("P", "tless", models, labels, len(xy))
        errs = _tless_errors(models, poses)
        res = {"problem": "P", "entry": "find6DPoses", "scene": "tless", "seed": seed,
               "points": len(xy), "wall_s": wall, "n_models": models.shape[0] // 3,
               "pose_errors": errs, "restart": stats.restart,
               "restart_energies": stats.restart_energies,
               "launches": _no_launches("tless", "score_pnp"),
               "score_pnp": _pnp_launches("tless", spans),
               "threefry_launches": _threefry_launches("tless"),
               "eigvec_launches": _eigvec_launches("tless"),
               "refine_launches": _refine_launches("tless")}
        print("main path", json.dumps(res), flush=True)
        if res["n_models"] < 2:
            failures.append(f"tless seed {seed}: {res['n_models']} instances")
        per_seed.append(errs)
        launches += res["refine_launches"]
        pnp_launches += res["score_pnp"]["launches"]
    mean = np.array(per_seed).mean(0)  # [pose, (rot, tr)]
    gates = [tuple(max(a, j) for a, j in zip(anchor, same))
             for anchor, same in zip(TLESS_MEAN_GATES, JAX_SAME_DRAW_TLESS_MEAN)]
    print("tless mean pose errors", json.dumps(
        {"seeds": list(TLESS_SEEDS), "mean": mean.tolist(), "anchors": TLESS_MEAN_GATES,
         "jax_same_draw": JAX_SAME_DRAW_TLESS_MEAN, "gates": gates}), flush=True)
    for gi, ((rot, tr), (rg, tg)) in enumerate(zip(mean, gates)):
        if not (rot <= rg and tr <= tg):
            failures.append(f"tless pose {gi}: mean errors {rot:.3f} deg, {tr:.3f} mm "
                            f"above {rg} deg, {tg} mm")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"mean": mean.tolist(), "refine_launches": launches,
            "score_pnp_launches": pnp_launches}


def phase_card_vs_cpu_new(result, problem):
    """The seed-0 scene of the line or VP path on the CPU, against the
    card's fit of phase 3."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.io.metrics import misclassification

    entry, _, kw = _new_path(problem)
    (data,), gt, _ = _new_scene(result["scene"])
    models, labels = getattr(progressivex_tpu_torch, entry)(data, **kw, random_seed=0,
                                                            device="cpu")
    disagreement = float(np.mean(labels != result["labels"]))
    res = {"problem": problem, "scene": result["scene"],
           "n_models_cuda": result["n_models"], "n_models_cpu": _n_models(problem, models),
           "label_disagreement": disagreement, "me_cuda": result["me"],
           "me_cpu": float(misclassification(labels, gt))}
    print("card vs cpu", json.dumps(res), flush=True)
    if res["n_models_cpu"] != res["n_models_cuda"]:
        raise AssertionError(f"n_models differ: card {res['n_models_cuda']}, "
                             f"CPU {res['n_models_cpu']}")
    if disagreement > LABEL_DISAGREEMENT_MAX:
        raise AssertionError(f"labels disagree on {disagreement:.4f} of points")


def _batched_new(problem, names, memo):
    """The batched front end of `problem` on the scenes `names`, random
    seed 0, once for each distinct list (memo). Returns the list of
    (models, labels)."""
    import progressivex_tpu_torch

    key = (problem, tuple(names))
    if key not in memo:
        _, entry, kw = _new_path(problem)
        inputs = [_new_scene(n)[0] for n in names]
        fn = getattr(progressivex_tpu_torch, entry)
        if problem == "P":
            K = _new_scene("tless")[2]
            memo[key] = fn([i[0] for i in inputs], [i[1] for i in inputs], K, **kw,
                           random_seed=0)
        else:
            memo[key] = fn([i[0] for i in inputs], **kw, random_seed=0)
    return memo[key]


def phase_batched_new(torch, problem, names):
    """The batched front end of `problem` on `names`, the launch counts
    set to 0 just before the batch and read after (lines and VPs reach no
    scoring kernel, poses score_pnp alone): each scene against its limit (lines and VPs: the JAX
    package's CPU ME, for lines the larger of the worst of ten seeds and
    the ME on the same draw, + ME_SLACK; T-LESS: at least 2 instances within
    TLESS_BATCHED_GATES); then each scene alone against the same scene
    listed first in a batch (phase 5's rule): the same number of models,
    labels apart on at most LABEL_DISAGREEMENT_MAX, instances matched one
    to one."""
    from progressivex_tpu_torch.io.metrics import misclassification

    memo = {}
    _zero_launches()
    t0 = time.perf_counter()
    batch = _batched_new(problem, names, memo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"problem": problem, "entry": _new_path(problem)[1], "scenes": list(names),
           "wall_s": wall, "per_scene": [],
           "launches": _no_launches(f"batched {problem}",
                                    "score_pnp" if problem == "P" else None)}
    failures = []
    for i, name in enumerate(names):
        inputs, truth, limit = _new_scene(name)
        models, labels = batch[i]
        _check_outputs(problem, name, models, labels, len(inputs[0]))
        k = _n_models(problem, models)
        row = {"scene": name, "n_models": k}
        if problem == "P":
            row["pose_errors"] = errs = _tless_errors(models, truth)
            if k < 2 or any(not (r <= rg and t <= tg) for (r, t), (rg, tg)
                            in zip(errs, TLESS_BATCHED_GATES)):
                failures.append(f"batched {name}: {k} instances, errors {errs} against "
                                f"{TLESS_BATCHED_GATES}")
        else:
            if problem == "L":
                limit = max(JAX_CPU_ME_LINES_WORST[int(name.partition("-")[2])],
                            JAX_SAME_DRAW_BATCHED_ME["L"][name])
            row["me"] = me = float(misclassification(labels, truth))
            row["limit"] = limit
            if me > limit + ME_SLACK:
                failures.append(f"batched {name}: ME {me} above the JAX package's "
                                f"{limit} + {ME_SLACK}")
        first = _batched_new(problem, list(names[i:]) + list(names[:i]), memo)[0]
        alone = _batched_new(problem, [name], memo)[0]
        k_first = _n_models(problem, first[0])
        same_k = _n_models(problem, alone[0]) == k_first
        row["n_models_first"] = k_first
        row["n_models_alone"] = _n_models(problem, alone[0])
        row["alone_label_disagreement"] = disagreement = (
            _label_disagreement(alone[1], first[1], k_first) if same_k else 1.0)
        if not same_k:
            failures.append(f"batched {name}: {k_first} models listed first, "
                            f"{row['n_models_alone']} alone")
        elif disagreement > LABEL_DISAGREEMENT_MAX:
            failures.append(f"batched {name}: alone and listed first, labels "
                            f"disagree on {disagreement:.4f} of points")
        res["per_scene"].append(row)
    print("batched path", json.dumps(res), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def _essential_fit(name, **kw):
    """findEssentialMatrices on gauntlet scene `name` ("two-s" or
    "three-s") at the gauntlet's keywords, random_seed s. Returns (models,
    labels, stats, gt)."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.eval import extras

    kind, _, seed = name.partition("-")
    corrs, gt = extras.gauntlet_scene(kind, int(seed))
    K = extras.gauntlet_camera()
    models, labels, stats = progressivex_tpu_torch.findEssentialMatrices(
        corrs, K, K, **extras.ESSENTIAL_KW, random_seed=int(seed), with_statistics=True,
        **kw)
    return models, labels, stats, gt


def _essential_gate(name, k, me):
    """The gauntlet's gate of scene `name`, or None where it is only
    printed (E_PRINTED_ONLY)."""
    k_min, k_max = E_SCENES[name]
    ok = k >= k_min and (k_max is None or k <= k_max) and me <= E_ME_GATE
    return None if name in E_PRINTED_ONLY else ok


def phase_essential(torch):
    """findEssentialMatrices on the gauntlet's scenes E_SCENES, after one
    untimed warm-up fit of the first, the launch counts set to 0 just
    before each scene and read after: score_fundamental must have run, and
    each scene meets its gate (K and ME), beside the JAX package's CPU
    ME at the same seed."""
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    names = list(E_SCENES)
    _essential_fit(names[0])  # warm-up
    torch.cuda.synchronize()
    results, failures = {}, []
    for name in names:
        _zero_launches()
        t0 = time.perf_counter()
        models, labels, stats, gt = _essential_fit(name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        k = models.shape[0] // 3
        me = float(misclassification(labels, gt))
        gate = _essential_gate(name, k, me)
        res = {"problem": "E", "entry": "findEssentialMatrices", "scene": name,
               "points": len(gt), "me": me, "jax_cpu_me": JAX_CPU_ME_E[name],
               "jax_cpu_gate_misses": JAX_E_MISSES[name], "n_models": k,
               "rounds": stats.rounds_run, "wall_s": wall,
               "launches": launches["score_fundamental"],
               "other_launches": {n: v for n, v in launches.items()
                                  if n != "score_fundamental"},
               "threefry_launches": _threefry_launches(name),
               "eigvec_launches": _eigvec_launches(name),
               "restart": stats.restart, "restart_energies": stats.restart_energies,
               "gate": "printed only" if gate is None else gate}
        print("main path", json.dumps(res), flush=True)
        if launches["score_fundamental"] <= 0:
            failures.append(f"{name}: score_fundamental never launched")
        if not (models.shape == (3 * k, 3) and labels.shape == gt.shape
                and np.isfinite(models).all()):
            failures.append(f"{name}: outputs {models.shape}, {labels.shape}")
        if gate is False:
            failures.append(f"{name}: {k} motions, ME {me} against the gate "
                            f"{E_SCENES[name]}, ME <= {E_ME_GATE}")
        results[name] = dict(res, labels=labels)
    if failures:
        raise AssertionError("; ".join(failures))
    return results


def phase_card_vs_cpu_essential(results, name):
    """The essential scene `name` through the port on the CPU, against the
    card's fit of phase 3 (phase 4's rule)."""
    from progressivex_tpu_torch.io.metrics import misclassification

    models, labels, stats, gt = _essential_fit(name, device="cpu")
    cuda = results[name]
    disagreement = float(np.mean(labels != cuda["labels"]))
    res = {"problem": "E", "scene": name, "n_models_cuda": cuda["n_models"],
           "n_models_cpu": models.shape[0] // 3, "restart_cuda": cuda["restart"],
           "restart_cpu": stats.restart, "label_disagreement": disagreement,
           "me_cuda": cuda["me"], "me_cpu": float(misclassification(labels, gt))}
    print("card vs cpu", json.dumps(res), flush=True)
    if res["n_models_cpu"] != res["n_models_cuda"]:
        raise AssertionError(f"n_models differ: card {res['n_models_cuda']}, "
                             f"CPU {res['n_models_cpu']}")
    if res["restart_cpu"] != res["restart_cuda"]:
        raise AssertionError(f"winning restarts differ: card {res['restart_cuda']}, "
                             f"CPU {res['restart_cpu']}")
    if disagreement > LABEL_DISAGREEMENT_MAX:
        raise AssertionError(f"labels disagree on {disagreement:.4f} of points")


# findEssentialMatricesBatched at the gauntlet's keywords and the
# single-scene front end's engine defaults (two split rounds, MAGSAC
# ranking), which the batched front ends leave at the engine's.
E_BATCHED_KW = {"split_pass": 2, "magsac_levels": 4}


def phase_batched_essential(torch, seeds):
    """findEssentialMatricesBatched on the two-motion gauntlet scenes of
    `seeds`, the launch counts set to 0 just before the batch and read
    after (score_fundamental must have run): each scene's model count and
    ME printed, and each scene alone against the same scene listed first
    in a batch (phase 5's rule)."""
    import progressivex_tpu_torch
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    K = extras.gauntlet_camera()
    scenes = [extras.gauntlet_scene("two", s) for s in seeds]

    def batch(order):
        return progressivex_tpu_torch.findEssentialMatricesBatched(
            [scenes[i][0] for i in order], K, K, **extras.ESSENTIAL_KW, **E_BATCHED_KW,
            random_seed=0)

    _zero_launches()
    t0 = time.perf_counter()
    out = batch(range(len(seeds)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    res = {"problem": "E", "entry": "findEssentialMatricesBatched",
           "scenes": [f"two-{s}" for s in seeds], "wall_s": wall,
           "launches": launches["score_fundamental"], "per_scene": []}
    failures = [] if launches["score_fundamental"] > 0 else [
        "batched E: score_fundamental never launched"]
    for i, seed in enumerate(seeds):
        models, labels = out[i]
        gt = scenes[i][1]
        if not (models.shape[1] == 3 and models.shape[0] % 3 == 0
                and labels.shape == gt.shape and np.isfinite(models).all()):
            raise AssertionError(f"batched two-{seed}: outputs {models.shape}, {labels.shape}")
        order = list(range(i, len(seeds))) + list(range(i))
        first = out[i] if i == 0 else batch(order)[0]
        alone = batch([i])[0]
        k_first = first[0].shape[0] // 3
        same_k = alone[0].shape == first[0].shape
        disagreement = _label_disagreement(alone[1], first[1], k_first) if same_k else 1.0
        res["per_scene"].append({
            "scene": f"two-{seed}", "n_models": models.shape[0] // 3,
            "me": float(misclassification(labels, gt)), "n_models_first": k_first,
            "n_models_alone": alone[0].shape[0] // 3,
            "alone_label_disagreement": disagreement})
        if not same_k:
            failures.append(f"batched two-{seed}: {k_first} models listed first, "
                            f"{alone[0].shape[0] // 3} alone")
        elif disagreement > LABEL_DISAGREEMENT_MAX:
            failures.append(f"batched two-{seed}: alone and listed first, labels "
                            f"disagree on {disagreement:.4f} of points")
    print("batched path", json.dumps(res), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def phase_bench_essential():
    """The port's `eval/extras.bench_essential` line (the JAX package's
    keys): the two-motion gauntlet at seeds 0-2 and a best-of-2 latency."""
    from progressivex_tpu_torch.eval.extras import bench_essential

    out = bench_essential()
    print("bench essential", json.dumps(out), flush=True)
    return out


def _phase6_calls():
    """(entry point, inputs, keywords) of one scene of every single-scene
    front end, at phase 3's keywords."""
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene, load_tless_scene

    oc, book = load_corr_scene("oldclassicswing")[0], load_corr_scene("book")[0]
    K = extras.gauntlet_camera()
    return [
        ("findHomographies", (oc,), scene_kwargs(len(oc), "H")),
        ("findTwoViewMotions", (book,), scene_kwargs(len(book), "F")),
        ("findEssentialMatrices", (extras.gauntlet_scene("two", 0)[0], K, K),
         extras.ESSENTIAL_KW),
        ("findLines", (extras.make_lines_scene(seed=0)[0],), extras.LINES_KW),
        ("findVanishingPoints", (extras.make_vp_scene(seed=0)[0],), extras.VP_KW),
        ("find6DPoses", load_tless_scene()[:3], extras.TLESS_KW),
    ]


def phase_progress_and_phases(torch):
    """Every single-scene front end once on the card with a progress
    callback and with_statistics="phases": at least one event a round run
    and restart, each with the JAX package's keys, and phase_times with
    the JAX package's keys, its parts adding up to a total above 0."""
    import progressivex_tpu_torch

    keys = {"round", "accepted", "inliers", "tanimoto", "score", "energy", "n_active",
            "labels"}
    phase_keys = {"progx_proposal_ms", "progx_sampling_ms", "progx_graph_ms",
                  "progx_labeling_ms", "progx_refit_ms", "other_ms", "total_device_ms"}
    out, failures = {}, []
    for entry, inputs, kw in _phase6_calls():
        events = []
        t0 = time.perf_counter()
        _, _, stats = getattr(progressivex_tpu_torch, entry)(
            *inputs, **kw, random_seed=0, progress_callback=events.append,
            with_statistics="phases")
        torch.cuda.synchronize()
        pt = stats.phase_times
        restarts = len(stats.restart_energies)
        res = {"entry": entry, "events": len(events), "rounds": stats.rounds_run,
               "restarts": restarts, "phase_times": pt,
               "seconds": time.perf_counter() - t0}
        print("progress and phases", json.dumps(res), flush=True)
        if len(events) < stats.rounds_run * restarts or any(set(e) != keys for e in events):
            failures.append(f"{entry}: {len(events)} events for {stats.rounds_run} rounds "
                            f"x {restarts} restarts")
        if pt is None or set(pt) != phase_keys or not pt["total_device_ms"] > 0.0:
            failures.append(f"{entry}: phase_times {pt}")
        elif abs(sum(v for k, v in pt.items() if k != "total_device_ms")
                 - pt["total_device_ms"]) > 0.02 * pt["total_device_ms"] + 0.01:
            failures.append(f"{entry}: phase_times parts do not add up: {pt}")
        out[entry] = res
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_dataset_pass(torch):
    """`eval/adelaide.throughput_all` over the synthetic 19 H and 18 F
    scene datasets on the card (lane target 1, two timing runs), the
    launch counts set to 0 just before it and read just after: every
    scene covered, full_dataset true, each bucket printed with its pad
    level, lanes, rows, best seconds and kernel launches (both kernels
    must have run), mean ME at or under SYNTH_ME_GATE and the JAX
    package's CPU mean + ME_SLACK."""
    from progressivex_tpu_torch.eval.adelaide import throughput_all
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    _zero_launches()
    t0 = time.perf_counter()
    out, warm_s = throughput_all("HF", root=_synth_roots(), n_timing_runs=2,
                                 lane_target=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    failures, res = [], {"wall_s": wall, "warm_up_s": warm_s, "launches": launches}
    for problem, r in out.items():
        kernel = PATHS[problem][1]
        for b in r.buckets:
            print("dataset pass bucket", json.dumps(dict(b, problem=problem)), flush=True)
            if b["launches"] <= 0:
                failures.append(f"{problem} bucket {b['n_pad']}: no kernel launch")
        limit = min(SYNTH_ME_GATE, JAX_CPU_ME_SYNTH[problem] + ME_SLACK)
        res[problem] = {
            "n_distinct": r.n_distinct, "n_scenes": r.n_scenes,
            "full_dataset": r.full_dataset, "mean_me": r.mean_me,
            "jax_cpu_mean_me": JAX_CPU_ME_SYNTH[problem], "limit": limit,
            "pass_seconds": r.pass_seconds, "scenes_per_sec": r.scenes_per_sec}
        if launches[kernel] <= 0:
            failures.append(f"dataset pass {problem}: {kernel} never launched")
        if r.n_distinct != SYNTH_SCENES[problem] or not r.full_dataset:
            failures.append(f"dataset pass {problem}: {r.n_distinct} scenes, "
                            f"full_dataset {r.full_dataset}")
        if not r.mean_me <= limit:
            failures.append(f"dataset pass {problem}: mean ME {r.mean_me} above {limit}")
    print("dataset pass", json.dumps(res), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def phase_grid(torch):
    """One H scene (oldclassicswing, padded to 384) through engine.fit with
    neighborhood="grid" (the H protocol's radius, 200, as the cell width)
    on the card and on the CPU from the same key: the kernel
    ran on the card, the same number of models, labels apart on at most
    LABEL_DISAGREEMENT_MAX of the points."""
    from progressivex_tpu_torch.api import _pad_to
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.core.config import EngineConfig, make_params
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES
    from progressivex_tpu_torch.models import get_family
    from progressivex_tpu_torch.ops import prng

    corrs, gt = load_corr_scene("oldclassicswing")
    n, n_pad = len(corrs), _pad_to(len(corrs))
    data = np.zeros((n_pad, 4), np.float32)
    data[:n] = corrs
    cfg = EngineConfig(family="homography", n_hypotheses=256, sampler_id=3,
                       magsac_levels=4, final_relabel=2, pearl_iters=2,
                       neighborhood="grid")
    params = make_params(threshold=4.0, confidence=0.5, spatial_weight=0.05,
                         neighborhood_radius=200.0, max_tanimoto=0.4, min_inliers=10,
                         max_models=6, scoring_exponent=2.0, n_valid=n)
    out = {}
    for dev in ("cuda", "cpu"):
        _zero_launches()
        fit = engine.fit(get_family("homography"), cfg, params,
                         torch.from_numpy(data).to(dev),
                         (torch.arange(n_pad) < n).to(dev),
                         (torch.arange(n_pad) < n).float().to(dev),
                         key=prng.key(0, dev))
        descs, labels = engine.compact_result(fit, n)
        out[dev] = (descs.shape[0], labels, dict(LAUNCHES))
    k = out["cuda"][0]
    same_k = out["cpu"][0] == k
    disagreement = _label_disagreement(out["cpu"][1], out["cuda"][1], k) if same_k else 1.0
    res = {"scene": "oldclassicswing", "n_models_cuda": k, "n_models_cpu": out["cpu"][0],
           "me_cuda": float(misclassification(out["cuda"][1], gt)),
           "me_cpu": float(misclassification(out["cpu"][1], gt)),
           "label_disagreement": disagreement,
           "launches": out["cuda"][2]["score_homography"]}
    print("grid neighborhood", json.dumps(res), flush=True)
    if res["launches"] <= 0:
        raise AssertionError("grid fit: score_homography never launched")
    if not same_k or disagreement > LABEL_DISAGREEMENT_MAX:
        raise AssertionError(f"grid fit: card and CPU differ: {res}")
    return res


def phase_moves_sync(torch):
    """The row-axis split and merge moves of two batched calls, each move
    run under torch.cuda.set_sync_debug_mode("warn") and timed on the card
    (synchronized before and after, so the calls run eagerly, inside
    core/graphs.eager()): findEssentialMatricesBatched on the two-motion
    gauntlet scenes 0-3 (12 rows at 512 points, dense adjacency, two split
    rounds) and findHomographiesBatched on the synthetic 2304 bucket
    (banded adjacency, one split round). Then the same two calls as CUDA
    graphs, the moves inside the captured tail, under the same mode.
    Prints every synchronization with its source line; fails if one comes
    from core/pearl.py, the moves' own code."""
    import warnings

    import progressivex_tpu_torch
    from progressivex_tpu_torch.core import engine, graphs
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene

    syncs, times = {}, []
    moves = {"split_instances": engine.split_instances,
             "merge_instances": engine.merge_instances}

    def watched(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            times.append({"move": name, "rows": int(args[3].shape[0]),
                          "points": int(args[3].shape[1]),
                          "seconds": time.perf_counter() - t0})
            for w in caught:
                if "synchroniz" in str(w.message):
                    site = f"{os.path.relpath(w.filename)}:{w.lineno}"
                    syncs[site] = syncs.get(site, 0) + 1
            return out
        return run

    K = extras.gauntlet_camera()
    gauntlet = [extras.gauntlet_scene("two", s)[0] for s in range(4)]
    synth = _synth_roots()["H"]
    big = [load_corr_scene(n, root=synth)[0] for n in ("bonhall", "johnssonb", "unihouse")]
    def calls():
        progressivex_tpu_torch.findEssentialMatricesBatched(
            gauntlet, K, K, **extras.ESSENTIAL_KW, **E_BATCHED_KW, random_seed=0)
        progressivex_tpu_torch.findHomographiesBatched(
            big, **scene_kwargs(2084, "H"), random_seed=0)

    try:
        for name, fn in moves.items():
            setattr(engine, name, watched(name, fn))
        with graphs.eager():
            calls()
    finally:
        for name, fn in moves.items():
            setattr(engine, name, fn)
    _, graph_syncs = _sync_sites(torch, calls)
    res = {"moves": times, "synchronizations": syncs,
           "graph_form_synchronizations": graph_syncs}
    print("moves sync", json.dumps(res), flush=True)
    own = {k: v for src in (syncs, graph_syncs) for k, v in src.items()
           if "core/pearl.py" in k}
    if own:
        raise AssertionError(f"the moves synchronize with the host: {own}")
    return res


MESH_FAMILIES = {"H": "homography", "F": "fundamental"}
# Phase 8's fit_batch scenes, each at every hyp axis size of MESH_HYP.
MESH_SCENES = (("H", "unihouse"), ("F", "book"))
MESH_HYP = (1, 2, 4)
# unihouse's ME at hyp 2 and 4 is one draw of a wide spread in both
# packages: a fit that ends on six or more models lands at 0.16-0.42. The
# JAX package's spread over random seeds 0-89 (seeds, mean ME, fits with
# six or more models), from
#   python3 tools/hyp_spread.py --package jax --scene unihouse --hyp 4,2,1 --seeds 30
#   python3 tools/hyp_spread.py --package jax --scene unihouse --hyp 2 \
#       --first-seed 30 --seeds 60        (and the same with --hyp 4)
# (its named-vmap emulation of a (1, H) mesh, JAX 0.9.0 on an H100): 0, 8
# and 2 such fits in the three blocks of 30 seeds at hyp 2, 3, 12 and 8 at
# hyp 4, so 30 seeds alone do not pin the rate down. At
# these sizes phase 8 fits seeds 0..MESH_SEEDS-1 and fails when the port
# ends on six or more models more often than the JAX package (one-sided
# Fisher exact test, p < MESH_FISHER_P) or when its mean ME is above the
# JAX package's mean + ME_SLACK; a single fit is held to phase 3's limit
# at every other (scene, hyp).
JAX_HYP_SPREAD = {("unihouse", 2): (90, 0.07845489443378119, 10),
                  ("unihouse", 4): (90, 0.1006771166560034, 23)}
MESH_SEEDS = 30
MESH_FISHER_P = 0.01


def _fisher_greater(a, n_a, b, n_b):
    """One-sided Fisher exact p: the chance that group A (a events in n_a
    trials) holds a or more of the a + b events, were both groups drawn
    alike (group B: b in n_b)."""
    from math import comb

    k, n = a + b, n_a + n_b
    return sum(comb(n_a, x) * comb(n_b, k - x)
               for x in range(a, min(k, n_a) + 1)) / comb(n, k)


def _mesh_fit(torch, problem, scene, mesh, seed=0):
    """parallel/sharding.fit_batch of one bundled scene under `problem`'s
    protocol (its engine: restarts as the engine's, B, sub-batches,
    MAGSAC, split) over `mesh`, the launch counts set to 0 just before it
    and read just after."""
    from progressivex_tpu_torch import api_batch
    from progressivex_tpu_torch.api import _pad_to
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.kernels._build import LAUNCHES, UNITS
    from progressivex_tpu_torch.ops import prng
    from progressivex_tpu_torch.parallel.sharding import fit_batch

    corrs, gt = load_corr_scene(scene)
    n, n_pad = len(corrs), _pad_to(len(corrs))
    cfg, params = api_batch.engine_setup(MESH_FAMILIES[problem],
                                         **scene_kwargs(n, problem))
    home = mesh.devices[0, 0]
    data = torch.zeros(1, n_pad, 4, device=home)
    data[0, :n] = torch.as_tensor(corrs, dtype=torch.float32, device=home)
    mask = torch.arange(n_pad, device=home)[None] < n
    weights = torch.ones(1, n_pad, device=home)
    kernel = PATHS[problem][1]
    _zero_launches()
    t0 = time.perf_counter()
    res = fit_batch(MESH_FAMILIES[problem], cfg, params._replace(n_valid=n), data, mask,
                    weights, prng.key(seed, home)[None], mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, rows = LAUNCHES[kernel], UNITS[kernel]
    one = engine.row_result(res, 0)
    models, labels = engine.compact_result(one, n)
    on_card = sum(d == home for d in mesh.devices[0])
    return {"problem": problem, "scene": scene, "mesh": repr(mesh),
            "hyp": mesh.shape["hyp"], "restarts": cfg.n_restarts,
            "me": float(misclassification(labels, gt)), "n_models": len(models),
            "rounds": one.rounds_run, "samples_drawn": one.samples_drawn,
            "samples_a_round": one.samples_drawn / max(one.rounds_run, 1),
            "restart": res.restart[0], "launches": launches, "rows_scored": rows,
            "rows_a_launch_expected": cfg.n_restarts * on_card, "wall_s": wall,
            "labels": labels}


def _sync_sites(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    {source line: synchronizations} of every synchronization it made."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, sites


def _hyp_code_sites(sites):
    """The entries of `sites` on a line of the hyp axis's own code
    (core/engine: `_Replicas`, `_make_propose`)."""
    import inspect

    from progressivex_tpu_torch.core import engine

    own = set()
    for obj in (engine._Replicas, engine._make_propose):
        src, first = inspect.getsourcelines(obj)
        own.update(range(first, first + len(src)))
    path = os.path.relpath(inspect.getsourcefile(engine))
    return {site: n for site, n in sites.items()
            if site.rsplit(":", 1)[0] == path and int(site.rsplit(":", 1)[1]) in own}


def phase_mesh(torch):
    """The device mesh on the card (module docstring, phase 8)."""
    from progressivex_tpu_torch.parallel import sharding
    from progressivex_tpu_torch.parallel.sharding import make_mesh

    card = torch.device("cuda", 0)
    failures, fits, spreads = [], {}, {}
    for problem, scene in MESH_SCENES:
        phase3_limit = PATHS[problem][3][scene] + ME_SLACK
        for h in MESH_HYP:
            mesh = make_mesh(1, h, devices=[card] * h)
            r = _mesh_fit(torch, problem, scene, mesh)
            fits[(scene, h)] = r
            print("mesh fit", json.dumps({k: v for k, v in r.items() if k != "labels"}),
                  flush=True)
            if r["launches"] <= 0 or r["rows_scored"] != (
                    r["launches"] * r["rows_a_launch_expected"]):
                failures.append(f"{scene} hyp {h}: {r['rows_scored']} rows in "
                                f"{r['launches']} launches, expected "
                                f"{r['rows_a_launch_expected']} a launch")
            if (scene, h) not in JAX_HYP_SPREAD:
                if r["me"] > phase3_limit:
                    failures.append(f"{scene} hyp {h}: ME {r['me']} above {phase3_limit}")
                continue
            runs = [r] + [_mesh_fit(torch, problem, scene, mesh, seed=s)
                          for s in range(1, MESH_SEEDS)]
            jax_seeds, jax_mean, jax_six = JAX_HYP_SPREAD[(scene, h)]
            six = sum(x["n_models"] >= 6 for x in runs)
            mean = float(np.mean([x["me"] for x in runs]))
            p = _fisher_greater(six, len(runs), jax_six, jax_seeds)
            spreads[(scene, h)] = sp = {
                "scene": scene, "hyp": h, "seeds": len(runs), "mean_me": mean,
                "six_or_more": six, "jax_seeds": jax_seeds, "jax_mean_me": jax_mean,
                "jax_six_or_more": jax_six, "fisher_p": p,
                "me": [x["me"] for x in runs], "n_models": [x["n_models"] for x in runs],
                "wall_s": sum(x["wall_s"] for x in runs)}
            print("mesh spread", json.dumps(sp), flush=True)
            if p < MESH_FISHER_P:
                failures.append(f"{scene} hyp {h}: six or more models on {six} of "
                                f"{len(runs)} seeds against the JAX package's {jax_six} "
                                f"of {jax_seeds} (Fisher p {p:.4g})")
            if mean > jax_mean + ME_SLACK:
                failures.append(f"{scene} hyp {h}: mean ME {mean} over {len(runs)} seeds "
                                f"above the JAX package's {jax_mean} + {ME_SLACK}")
        per_round = [fits[(scene, h)]["samples_a_round"] for h in MESH_HYP]
        if per_round != sorted(set(per_round)):
            failures.append(f"{scene}: samples a round {per_round} do not grow with hyp")
    # The hyp axis's own code makes no host read: one fit watched.
    h = MESH_HYP[-1]
    _, sites = _sync_sites(torch, lambda: _mesh_fit(
        torch, "H", "unihouse", make_mesh(1, h, devices=[card] * h)))
    hyp_sites = _hyp_code_sites(sites)
    print("mesh sync", json.dumps({"hyp": h, "synchronizations": sites,
                                   "in_hyp_code": hyp_sites}), flush=True)
    if hyp_sites:
        failures.append(f"the hyp axis's code synchronizes with the host: {hyp_sites}")
    # A replica on another device: its inputs copied there, its winner back.
    both = _mesh_fit(torch, "H", "oldclassicswing", make_mesh(1, 2, devices=[card] * 2))
    split = _mesh_fit(torch, "H", "oldclassicswing", make_mesh(1, 2, devices=[card, "cpu"]))
    k = both["n_models"]
    disagreement = (_label_disagreement(both["labels"], split["labels"], k)
                    if split["n_models"] == k else 1.0)
    cross = {"scene": "oldclassicswing", "n_models_card": k,
             "n_models_card_cpu": split["n_models"], "me_card": both["me"],
             "me_card_cpu": split["me"], "label_disagreement": disagreement,
             "launches_card_cpu": split["launches"],
             "rows_scored_card_cpu": split["rows_scored"],
             "wall_s": [both["wall_s"], split["wall_s"]]}
    print("mesh replica on the cpu", json.dumps(cross), flush=True)
    if disagreement > LABEL_DISAGREEMENT_MAX:
        failures.append(f"replica on the CPU: {split['n_models']} models against {k}, "
                        f"labels apart on {disagreement:.4f}")
    if split["rows_scored"] != split["launches"]:
        failures.append("replica on the CPU: the card scored other rows than its own")

    meshes = [("virtual (2, 1) mesh of cuda:0", {"mesh": make_mesh(2, 1, devices=[card] * 2)})]
    count = torch.cuda.device_count()
    if count > 1:
        meshes.append((f"n_devices={count}", {"n_devices": count}))
    shards = []
    fit_shard = sharding._fit_shard

    def timed(family, cfg, params, dev, *rest):
        # No synchronization in a shard's thread: its host seconds, and one
        # event pair on its stream, read once the whole call is over.
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = fit_shard(family, cfg, params, dev, *rest)
        end.record()
        shards.append({"device": str(dev), "rows": int(out.labels.shape[0]),
                       "host_s": time.perf_counter() - t0, "events": (start, end)})
        return out

    calls = []
    sharding._fit_shard = timed
    try:
        for label, kw in meshes:
            for problem in ("H", "F"):
                ref = BATCHED_OUTPUTS.get(problem)
                if ref is None:
                    raise AssertionError(f"phase 5 {problem} gave no result to hold against")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _batched(problem, PATHS[problem][2])
                torch.cuda.synchronize()
                unsharded = time.perf_counter() - t0
                shards.clear()
                t0 = time.perf_counter()
                got = _batched(problem, PATHS[problem][2], **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for sh in shards:
                    start, end = sh.pop("events")
                    sh["device_span_ms"] = start.elapsed_time(end)
                same = {n: bool(np.array_equal(got[n][0], ref[n][0])
                                and np.array_equal(got[n][1], ref[n][1])) for n in ref}
                call = {"mesh": label, "problem": problem, "same_bits": same,
                        "wall_s": wall, "unsharded_wall_s": unsharded,
                        "shards": list(shards)}
                calls.append(call)
                print("mesh batched", json.dumps(call), flush=True)
                if not all(same.values()):
                    failures.append(f"{label} {problem}: sharded result differs from "
                                    f"phase 5's: {same}")
    finally:
        sharding._fit_shard = fit_shard
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": {kern: sum(r["launches"] for r in fits.values()
                                   if PATHS[r["problem"]][1] == kern)
                         for kern in ("score_homography", "score_fundamental")},
            "cross": cross, "calls": calls, "spreads": list(spreads.values())}


# Phase 9's inputs: SHA-256 of the rendered images and of the demo's matches
# on them (real_image_digests), which tests/test_torch_real_images.py
# computes too, and the JAX package's misclassification of the demo's
# homography fit on the same matches (the demo's keywords, random_seed 0) on
# the CPU, against the rendered labels, from
#   JAX_PLATFORMS=cpu PROGX_COMPILE_CACHE=0 python -c "import jax;
#     jax.config.update('jax_platforms', 'cpu');
#     import importlib.util, numpy as np;
#     spec = importlib.util.spec_from_file_location('smoke', 'chip_smoke.py');
#     cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs);
#     from progressivex_tpu.io.detect import harris_keypoints as hk, \
#       patch_descriptors as pd, match_descriptors as md;
#     from progressivex_tpu import findHomographies;
#     from progressivex_tpu.io.metrics import misclassification;
#     v1, v2, regions = cs.render_h_pair();
#     im1, im2 = v1.astype(np.float32), v2.astype(np.float32);
#     k1, k2 = hk(im1), hk(im2); m = md(pd(im1, k1), pd(im2, k2));
#     corrs = np.concatenate([k1[m[:, 0]], k2[m[:, 1]]], axis=1);
#     hs, labels = findHomographies(corrs, threshold=4.0, conf=0.5,
#       spatial_coherence_weight=0.05, neighborhood_ball_radius=200.0,
#       maximum_tanimoto_similarity=0.4, max_iters=1000, minimum_point_number=12,
#       maximum_model_number=8, sampler_id=3, random_seed=0);
#     print(len(corrs), hs.shape[0] // 3,
#           misclassification(labels, cs.h_pair_labels(corrs, regions)))"
# (431 matches, 3 planes). Gates: the H fit K >= 2 and ME <= JAX_CPU_ME_REAL_H
# + ME_SLACK, lines K >= 4, vanishing points K >= 2 (the JAX demo's asserts),
# the card against the CPU as phase 4.
REAL_IMAGES_DIGEST = {
    "h_pair": "2ec8b41738aa96b84c10cbe8e3c837c119c00f85237f7d03bdf81941faffc140",
    "facade": "69a6005ad3cdcaf6a901ec0c1e8f6059c6f4a20df40cfa0893d24c01cf7db260",
    "matches": "0b2fbff2586cae46fa210c189441ce76ddc46cfe9e33a6fc025065dcf2b3c331",
}
JAX_CPU_ME_REAL_H = 0.002320185614849146
REAL_MIN_MODELS = {"H": 2, "L": 4, "V": 2}
DETECTORS = ("canny", "hough_segments", "harris_keypoints", "patch_descriptors",
             "match_descriptors")


@contextlib.contextmanager
def _detector_clock(detect):
    """io/detect's detectors (the demo imports them when it runs) wrapped so
    that each call adds its host seconds to the dict this yields."""
    seconds = dict.fromkeys(DETECTORS, 0.0)
    originals = {name: getattr(detect, name) for name in DETECTORS}

    def clocked(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return originals[name](*args, **kw)
            finally:
                seconds[name] += time.perf_counter() - t0
        return call

    for name in DETECTORS:
        setattr(detect, name, clocked(name))
    try:
        yield seconds
    finally:
        for name, fn in originals.items():
            setattr(detect, name, fn)


def _top_operations(ops, n=10):
    """The n device operations (match text: name and annotations) with the
    most self time, and the n most frequent: [(text, microseconds, count)]."""
    by = {}
    for text, us in ops:
        t, c = by.get(text, (0.0, 0))
        by[text] = (t + us, c + 1)
    rows = [(text[:200], t, c) for text, (t, c) in by.items()]
    return (sorted(rows, key=lambda r: -r[1])[:n], sorted(rows, key=lambda r: -r[2])[:n])


def phase_real_images(torch):
    """The real-image demo's own code (examples/demo_real_images) on the
    rendered images: detection on the host, the H fit on the card through
    score_homography with LiveProgress as its callback, the same fit on the
    CPU, lines and vanishing points on the facade, and one profiled H fit
    read back by io/profiling.op_self_times."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from progressivex_tpu_torch.core import graphs
    from progressivex_tpu_torch.examples import demo_real_images as demo
    from progressivex_tpu_torch.io import detect
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.io.profiling import device_operations, op_self_times
    from progressivex_tpu_torch.io.visualizer import LiveProgress
    from progressivex_tpu_torch.kernels._build import LAUNCHES

    failures = []
    t0 = time.perf_counter()
    view1, view2, regions = render_h_pair()
    facade = render_facade()
    render_s = time.perf_counter() - t0
    # as io/detect.load_grayscale reads an 8-bit photograph
    im1, im2, fac = (x.astype(np.float32) for x in (view1, view2, facade))
    with _detector_clock(detect) as seconds:
        corrs, source = demo.homography_inputs(im1, im2)
        pts = demo.line_inputs(fac)
        segs, weights = demo.vp_inputs(fac)
    digests = real_image_digests(view1, view2, facade, corrs)
    for name, want in REAL_IMAGES_DIGEST.items():
        if digests[name] != want:
            failures.append(f"{name} digest {digests[name]} is not {want}")
    gt = h_pair_labels(corrs, regions)

    def card(fit, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fit(*args, "cuda", **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    live = LiveProgress(log=True)
    _zero_launches()
    (hs, labels, stats), h_s = card(demo.fit_homographies, corrs, progress_callback=live,
                                    with_statistics=True)
    launches = LAUNCHES["score_homography"]
    k = hs.shape[0] // 3
    me = float(misclassification(labels, gt))
    t = time.perf_counter()
    hs_cpu, labels_cpu = demo.fit_homographies(corrs, "cpu")
    cpu_s = time.perf_counter() - t
    k_cpu = hs_cpu.shape[0] // 3
    disagreement = _label_disagreement(labels, labels_cpu, k) if k_cpu == k else 1.0
    _zero_launches()
    (lines, _), lines_s = card(demo.fit_lines, pts)
    _no_launches("real-image lines")
    (vps, _), vps_s = card(demo.fit_vanishing_points, segs, weights)
    _no_launches("real-image vanishing points")

    # one profiled H fit, read back from its trace; eager, since the
    # trace's annotations come from the host calls that a graph's replay
    # does not make (io/profiling.op_self_times)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        _zero_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     on_trace_ready=tensorboard_trace_handler(tmp)) as prof, graphs.eager():
            demo.fit_homographies(corrs, "cuda")
            torch.cuda.synchronize()
        prof_launches = LAUNCHES["score_homography"]
        ops = op_self_times(tmp)
    kineto_us = sum(e.duration_ns() for e in device_operations(
        prof.profiler.kineto_results.events())) / 1e3
    trace_us = sum(us for _, us in ops)
    trace_launches = sum("score_homography" in text for text, _ in ops)
    by_time, by_count = _top_operations(ops)
    untagged = [us for text, us in ops if "progx_" not in text]

    out = {
        "digests": digests, "source": source, "render_s": render_s,
        "detector_host_s": seconds, "matches": len(corrs),
        "true_labels": np.bincount(gt).tolist(), "line_points": len(pts),
        "segments": len(segs),
        "H": {"models": k, "me": me, "jax_cpu_me": JAX_CPU_ME_REAL_H,
              "launches": launches, "rounds": stats.rounds_run,
              "progress_events": len(live.events), "card_s": h_s,
              "cpu_models": k_cpu, "cpu_me": float(misclassification(labels_cpu, gt)),
              "label_disagreement": disagreement, "cpu_s": cpu_s},
        "L": {"models": lines.shape[0], "card_s": lines_s},
        "V": {"models": vps.shape[0], "card_s": vps_s},
        "profile": {"launches": prof_launches, "trace_launches": trace_launches,
                    "trace_device_us": trace_us, "kineto_device_us": kineto_us,
                    "device_ops": len(ops), "outside_phase_scopes_ops": len(untagged),
                    "outside_phase_scopes_us": sum(untagged)},
    }
    print("real images", json.dumps(out), flush=True)
    for label, rows in (("self time", by_time), ("count", by_count)):
        for text, us, count in rows:
            print(f"real images top by {label}: {us:.1f} us {count} x {text}", flush=True)
    for p, got in (("H", k), ("L", lines.shape[0]), ("V", vps.shape[0])):
        if got < REAL_MIN_MODELS[p]:
            failures.append(f"{p}: {got} models, fewer than {REAL_MIN_MODELS[p]}")
    if me > JAX_CPU_ME_REAL_H + ME_SLACK:
        failures.append(f"H: ME {me} above the JAX package's {JAX_CPU_ME_REAL_H} + {ME_SLACK}")
    if launches <= 0:
        failures.append("H: score_homography was not launched")
    if k_cpu != k or disagreement > LABEL_DISAGREEMENT_MAX:
        failures.append(f"H: {k} models on the card, {k_cpu} on the CPU, labels apart "
                        f"on {disagreement:.4f}")
    if len(live.events) != stats.rounds_run:
        failures.append(f"LiveProgress saw {len(live.events)} events in "
                        f"{stats.rounds_run} rounds")
    if trace_launches != prof_launches or prof_launches <= 0:
        failures.append(f"op_self_times holds {trace_launches} score_homography "
                        f"launches, the fit made {prof_launches}")
    if abs(trace_us - kineto_us) > 0.01 * kineto_us:
        failures.append(f"op_self_times totals {trace_us} us of device time, the "
                        f"profile {kineto_us} us")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def _fit_fields(res):
    """The bytes of every tensor of a FitResult (round log included), for
    a bit-for-bit comparison."""
    out = {}
    for f in res._fields:
        v = getattr(res, f)
        if f == "round_log":
            for name, col in zip(v._fields, v):
                out[f"round_log.{name}"] = col.cpu().numpy().tobytes()
        elif hasattr(v, "cpu"):
            out[f] = v.cpu().numpy().tobytes()
    return out


def _compiled_paths():
    """Phase 10's paths: (label, call) with call() running the front end
    as phases 3, 5 and 7 run it."""
    import progressivex_tpu_torch as px
    from progressivex_tpu_torch.eval import adelaide, extras
    from progressivex_tpu_torch.io.data import load_corr_scene

    def single(problem, scene):
        corrs = load_corr_scene(scene)[0]
        return lambda: _fit(problem, corrs)

    def new(problem, name):
        entry, _, kw = _new_path(problem)
        inputs, _, extra = _new_scene(name)
        if problem == "P":
            return lambda: getattr(px, entry)(*inputs, extra, **kw, random_seed=0)
        return lambda: getattr(px, entry)(*inputs, **kw, random_seed=0)

    prep = adelaide._prepare("H", _synth_roots()["H"], 1, None, None)
    bucket = max(prep.plan, key=lambda b: b.n_pad)
    paths = [(f"H {s}", single("H", s)) for s in PATHS["H"][2]]
    paths += [(f"F {s}", single("F", s)) for s in PATHS["F"][2]]
    paths += [("E two-0", lambda: _essential_fit("two-0")),
              ("L lines-0", new("L", "lines-0")), ("V vp-0", new("V", "vp-0")),
              ("P tless", new("P", "tless")),
              ("H batched", lambda: _batched("H", PATHS["H"][2])),
              ("F batched", lambda: _batched("F", PATHS["F"][2])),
              (f"H pass bucket {bucket.n_pad}",
               lambda: adelaide._run(prep, bucket, 0, "cuda", None))]
    return paths


def _record_fits(engine):
    """Patch engine.fit_rows to keep every FitResult it returns; returns
    (the list, a function that undoes the patch)."""
    orig, seen = engine.fit_rows, []

    def recording(*a, **k):
        res = orig(*a, **k)
        seen.append(res)
        return res

    engine.fit_rows = recording
    return seen, lambda: setattr(engine, "fit_rows", orig)


_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
          "numpy")


def _host_reads(torch, call):
    """call() with every host read of a CUDA tensor (torch.Tensor's
    __bool__, __int__, __float__, __index__, item, tolist, cpu, numpy)
    counted by where its fit stood: "before" its rounds (from
    engine.fit_rows' call to its first round graph, the graph runner's
    stage "propose" or "rounds"), in its "rounds" (to its "finish"
    graph), or "after".
    Returns {where: reads}."""
    from progressivex_tpu_torch.core import engine, graphs

    counts = {"before": 0, "rounds": 0, "after": 0, "outside": 0}
    where = ["outside"]
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def counting(name):
        fn = saved[name]

        def read(self, *a, **k):
            if self.is_cuda:
                counts[where[0]] += 1
            return fn(self, *a, **k)
        return read

    fit_rows, stage = engine.fit_rows, graphs._Graphs.stage

    def watched_fit_rows(*a, **k):
        where[0] = "before"
        try:
            return fit_rows(*a, **k)
        finally:
            where[0] = "outside"

    def watched_stage(self, name, fn, outs=None):
        if name in ("propose", "rounds") and where[0] == "before":
            where[0] = "rounds"
        elif name == "finish":
            where[0] = "after"
        return stage(self, name, fn, outs)

    engine.fit_rows, graphs._Graphs.stage = watched_fit_rows, watched_stage
    for name in _READS:
        setattr(torch.Tensor, name, counting(name))
    try:
        call()
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        engine.fit_rows, graphs._Graphs.stage = fit_rows, stage
    return counts


def _round_read_sites(sites):
    """The entries of `sites` at the round loop's two host reads in
    core/engine.py (the lines that read a flag with bool())."""
    import linecache

    out = {}
    for site, n in sites.items():
        path, _, line = site.rpartition(":")
        if path.endswith("core/engine.py") and "bool(" in linecache.getline(path, int(line)):
            out[site] = n
    return out


def phase_compiled_fit(torch):
    """The compiled fit (core/graphs.py) against the eager fit on the card,
    path by path (`_compiled_paths`), the launch counts set to 0 just
    before each run and read after: the eager form (inside graphs.eager())
    once, then the graph form cold (every graph dropped first: warm-up +
    capture + replay) and warm three times. Every FitResult of the graph
    form's runs (descriptors, labels, energy, round log, samples drawn,
    models, every field) and the launch table (kernels/_build.py: every
    kernel's launches and the rows, keys, matrices or problems they
    covered) must equal the eager run's bit for bit. One more warm run under
    torch.cuda.set_sync_debug_mode("warn") counts the synchronizations:
    at most two a round, at the round loop's reads in core/engine.py, and
    none from core/pearl.py, ops/labeling.py or kernels/scoring.py; one
    with every host read of a CUDA tensor counted (`_host_reads`): none
    before the rounds (the draw of the samples runs in the start graph),
    at most two a round; one warm run under torch.profiler gives the device's busy share (device
    operations' time over the wall time, as tools/profile_torch_fit.py
    takes it). Prints, a path: eager, cold (and of it warm-up and
    capture) and warm (median) seconds, host reads before the rounds and a
    round, peak reserved memory of each form and the busy share. Then H on
    oldclassicswing with cfg.unroll_rounds (all rounds and the tail in one
    graph) against the per-round graphs, bit for bit."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from progressivex_tpu_torch.core import engine, graphs
    from progressivex_tpu_torch.io.data import load_corr_scene
    from progressivex_tpu_torch.io.profiling import device_operations
    from progressivex_tpu_torch.kernels._build import LAUNCHES, UNITS

    def run(call):
        """(seconds, FitResults' bytes, launches, units) of one call."""
        seen, undo = _record_fits(engine)
        _zero_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            undo()
        passes = sum(int(r.rounds_run.max()) for r in seen)
        return (wall, [_fit_fields(r) for r in seen], dict(LAUNCHES), dict(UNITS),
                passes)

    failures, table = [], []
    total = {}
    for label, call in _compiled_paths():
        graphs.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with graphs.eager():
            eager_s, want, want_l, want_r, passes = run(call)
        eager_mem = torch.cuda.max_memory_reserved()
        graphs.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in graphs.BUILDS:
            graphs.BUILDS[k] = 0
        runs = [run(call) for _ in range(4)]
        builds = dict(graphs.BUILDS)
        graph_mem = torch.cuda.max_memory_reserved()
        _, sites = _sync_sites(torch, lambda: run(call))
        round_reads = _round_read_sites(sites)
        reads = _host_reads(torch, lambda: run(call))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        busy = sum(e.duration_ns() for e in device_operations(
            prof.profiler.kineto_results.events())) / 1e9
        row = {"path": label, "eager_s": eager_s, "cold_s": runs[0][0],
               "warmup_s": builds["warmup_s"], "capture_s": builds["capture_s"],
               "graphs": builds["graphs"],
               "warm_s": statistics.median(r[0] for r in runs[1:]),
               "round_passes": passes,
               "host_reads_before_rounds": reads["before"],
               "host_reads_a_round": reads["rounds"] / max(passes, 1),
               "host_reads_per_round": sum(round_reads.values()) / max(passes, 1),
               "sync_sites": sites, "reserved_eager_bytes": eager_mem,
               "reserved_graph_bytes": graph_mem, "busy_share_warm": busy / wall_prof,
               "launches": want_l, "rows": want_r,
               "bit_equal": [r[1] == want for r in runs],
               "counts_equal": [r[2] == want_l and r[3] == want_r for r in runs]}
        print("compiled fit", json.dumps(row), flush=True)
        table.append(row)
        for k, v in want_l.items():
            total[k] = total.get(k, 0) + v
        if not all(row["bit_equal"]):
            bad = sorted({f for r in runs for a, b in zip(r[1], want) for f in a
                          if a[f] != b.get(f)})
            failures.append(f"{label}: the graph fit differs from the eager fit in {bad}")
        if not all(row["counts_equal"]):
            failures.append(f"{label}: launches {[r[2] for r in runs]} rows "
                            f"{[r[3] for r in runs]}, eager {want_l} {want_r}")
        if row["host_reads_per_round"] > 2 or row["host_reads_a_round"] > 2:
            failures.append(f"{label}: {row['host_reads_per_round']} synchronizing and "
                            f"{row['host_reads_a_round']} host reads a round")
        if row["host_reads_before_rounds"] != 0:
            failures.append(f"{label}: {row['host_reads_before_rounds']} host reads "
                            "before the rounds")
        own = {k: v for k, v in sites.items() if any(
            m in k for m in ("core/pearl.py", "ops/labeling.py", "kernels/scoring.py"))}
        if own:
            failures.append(f"{label}: host reads from the captured code: {own}")
    # cfg.unroll_rounds: one graph for the rounds and the tail
    corrs = load_corr_scene("oldclassicswing")[0]
    orig = engine.fit_rows

    def unrolled(family, cfg, *a, **k):
        return orig(family, dataclasses.replace(cfg, unroll_rounds=True), *a, **k)

    per_round = run(lambda: _fit("H", corrs))
    engine.fit_rows = unrolled
    try:
        unroll = [run(lambda: _fit("H", corrs)) for _ in range(2)]
    finally:
        engine.fit_rows = orig
    row = {"path": "H oldclassicswing unroll_rounds", "per_round_s": per_round[0],
           "unrolled_s": [u[0] for u in unroll],
           "bit_equal": [u[1] == per_round[1] for u in unroll],
           "launches_per_round_form": per_round[2],
           "launches_unrolled": [u[2] for u in unroll]}
    print("compiled fit", json.dumps(row), flush=True)
    if not all(row["bit_equal"]):
        failures.append("unroll_rounds: the one-graph fit differs from the per-round graphs")
    res = {"paths": table, "unroll_rounds": row, "launches": total}
    if failures:
        raise AssertionError("; ".join(failures))
    return res


FAILURES = []


def _timed(label, fn, *args):
    """fn(*args), printing its seconds. A phase that raises is recorded in
    FAILURES and the next phase runs; the script fails at its end."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - reported, and the run fails
        FAILURES.append(f"phase {label}: {type(e).__name__}: {e}")
        print(f"phase {label} FAILED: {e}", file=sys.stderr, flush=True)
        return None
    finally:
        print(f"phase {label} seconds {time.perf_counter() - t0:.3f}", flush=True)


def _kernel_line(name, cases, worst_abs, results, main_shape, pallas_lines,
                 row_cases, batched):
    main_case = next(c for c in cases if c["shape"] == main_shape
                     and c["magsac_levels"] == 4 and c["has_compound"] == [True])
    return {
        "name": name, "route": "cuda",
        "source": f"progressivex_tpu_torch/csrc/{name}.cu",
        "replaces": "progressivex_tpu/ops/pallas_scoring.py:155",
        "pallas_body": pallas_lines,
        "launches": sum(r["launches"] for r in results.values()),
        "max_abs_err": max([worst_abs] + [c["max_abs_err"] for c in row_cases]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "shape": main_case["shape"], "wrapper_ms": main_case["wrapper_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "launches_batched": batched["launches"],
        "rows": [{k: c[k] for k in ("rows", "shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "launch_floor_ms", "max_abs_err")}
                 for c in row_cases if c["magsac_levels"] == 4
                 and all(c["has_compound"])],
    }


def _threefry_line(draw_phase, results):
    """The threefry kernel's entry of the {"kernels": ...} line: its
    launches in phase 3's timed fits (H, F, E, lines, VPs), its time
    beside its bound at GUMBEL_F_SHAPE, and every timed launch shape of
    phase 2's draws."""
    draws, cases = draw_phase
    main_case = next(c for c in cases if "ms" in c and (
        c["keys"], c["count"], c["pair"], c["offsets"]) == GUMBEL_F_SHAPE)
    return {
        "name": "threefry", "route": "cuda",
        "source": "progressivex_tpu_torch/csrc/threefry.cu",
        "replaces": "progressivex_tpu/core/engine.py:850",
        "replaces_note": "jax.random's threefry2x32 under progx_sampling, lowered by "
                         "XLA (engine.py:850-885); no Pallas kernel",
        "launches": sum(r["threefry_launches"] for p in results.values()
                        for r in p.values()),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
        "shape": [main_case["keys"], main_case["count"]],
        "wrapper_ms": main_case["wrapper_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "shapes_checked": len(cases),
        "draws_card_equal_cpu": all(all(d["equal"]) for d in draws),
        "timed": [{k: c[k] for k in ("label", "keys", "count", "pair", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "launch_floor_ms")}
                  for c in cases if "ms" in c],
    }


def main():
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("no CUDA device is available; this script runs the port on a GPU")
    try:
        import progressivex_tpu_torch  # noqa: F401
        from progressivex_tpu_torch.kernels import _build
    except ImportError as e:
        _fail(f"the progressivex_tpu_torch package must sit beside this script ({e})")

    t_start = time.perf_counter()
    smi = _smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    dev = torch.device("cuda")

    _timed("1 synth data", phase_synth_data)
    kernel_phase = _timed("2 kernels", phase_kernel, torch, dev)
    draw_phase = _timed("2 draws", phase_draws, torch, dev)
    eigvec_phase = _timed("2 eigvec", phase_eigvec, torch, dev)
    refine_phase = _timed("2 refine", phase_refine, torch, dev)
    results = {p: _timed(f"3 {p}", phase_main_path, torch, p) for p in ("H", "F")}
    new = {p: _timed(f"3 {p}", phase_new_path, torch, p) for p in ("L", "V")}
    tless = _timed("3 P", phase_tless, torch)
    results["E"] = _timed("3 E", phase_essential, torch)
    _timed("4 H", phase_card_vs_cpu, results["H"], "H", "oldclassicswing")
    _timed("4 F", phase_card_vs_cpu, results["F"], "F", "book")
    for p in ("L", "V"):
        _timed(f"4 {p}", phase_card_vs_cpu_new, new[p], p)
    if results["E"]:
        _timed("4 E", phase_card_vs_cpu_essential, results["E"], E_CARD_VS_CPU)
    batched = {p: _timed(f"5 {p}", phase_batched, torch, p) for p in ("H", "F")}
    _timed("5 L", phase_batched_new, torch, "L", [f"lines-{s}" for s in range(4)])
    _timed("5 V", phase_batched_new, torch, "V", [f"vp-{s}" for s in range(4)])
    _timed("5 P", phase_batched_new, torch, "P", ["tless", "tless"])
    batched["E"] = _timed("5 E", phase_batched_essential, torch, (0, 1, 2, 3))
    bench = _timed("5 bench", phase_bench)
    bench_e = _timed("5 bench E", phase_bench_essential)
    _timed("6", phase_progress_and_phases, torch)
    dataset_pass = _timed("7 pass", phase_dataset_pass, torch)
    _timed("7 grid", phase_grid, torch)
    _timed("7 sync", phase_moves_sync, torch)
    mesh = _timed("8 mesh", phase_mesh, torch)
    real = _timed("9 real images", phase_real_images, torch)
    compiled = _timed("10 compiled fit", phase_compiled_fit, torch)
    print(f"total seconds {time.perf_counter() - t_start:.3f}", flush=True)
    if FAILURES:
        _fail("; ".join(FAILURES))

    (kernel_cases, row_cases, essential_cases, synth_cases, hyp_cases, captured,
     pose_cases) = kernel_phase
    kernels = [
        _kernel_line("score_homography", *kernel_cases["score_homography"],
                     results["H"], [256, 2304],
                     "_score_kernel :91-126 + _homography_r2 :70-85",
                     row_cases["score_homography"] + synth_cases["score_homography"]
                     + hyp_cases["score_homography"], batched["H"]),
        _kernel_line("score_fundamental", *kernel_cases["score_fundamental"],
                     {**results["F"], **results["E"]}, [1536, 256],
                     "_score_kernel :91-126 + _sampson_r2 :51-67",
                     row_cases["score_fundamental"] + essential_cases[:-1]
                     + synth_cases["score_fundamental"] + hyp_cases["score_fundamental"],
                     batched["F"]),
    ]
    kernels[1].update({
        "launches_essential": sum(r["launches"] for r in results["E"].values()),
        "launches_essential_batched": batched["E"]["launches"],
        "max_abs_err": max(kernels[1]["max_abs_err"],
                           max(c["max_abs_err"] for c in essential_cases))})
    for k in kernels:
        k["launches_dataset_pass"] = dataset_pass["launches"][k["name"]]
        k["launches_mesh"] = mesh["launches"][k["name"]]
    kernels[0]["launches_real_images"] = real["launches"]
    for k in kernels:
        k["captured_launch_bit_equal"] = all(captured[k["name"]]["bit_equal"])
    kernels.append(_threefry_line(draw_phase, {**results, "L": {"lines-0": new["L"]},
                                               "V": {"vp-0": new["V"]}}))
    kernels.append(_eigvec_line(eigvec_phase, {**results, "V": {"vp-0": new["V"]}}))
    kernels.append(_refine_line(refine_phase, tless["refine_launches"]))
    kernels.append(_pnp_line(pose_cases, captured["score_pnp"], tless["score_pnp_launches"]))
    for k in kernels:
        k["launches_compiled_fit"] = compiled["launches"][k["name"]]
    print("bench", json.dumps(bench), flush=True)
    print("bench essential", json.dumps(bench_e), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
