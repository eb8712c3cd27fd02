"""On-card smoke run of the PyTorch port (dupl_tpu_torch): the serving path,
the pseudo-label path, the training step, the evaluation path, the four
kernel-experiment tools, the training run, the recipe's COCO inputs
(packed records, a DeiT checkpoint, COCO training and evaluation),
training across processes, the sealed serving artifacts, tensor
parallelism, the run operations (CAM grids, FLOP counts, MFU), a whole
training run held to the CPU's in lockstep, the measurement programs
(``bench_torch.py`` and the three dissection tools), the exact GELU and
the int8 inference path, and float16 compute (G's and K4's f16 modes).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the CUDA toolkit) and this checkout; imports no
JAX.  Phases, each printing one result line:

1. device: the card, its power limit, TF32 off for matmuls and convolutions;
2. build: every CUDA kernel compiled from dupl_tpu_torch/csrc for sm_90a,
   one nvcc per source, all at once;
3. K1 (exp-attention) against its plain twin on the card, bf16, at the
   token counts and batch sizes of the serving, pseudo-label and training
   paths and one case with logits past the clamp (1 bf16 ulp of the row at
   the maximum, 1e-3 on average), against three wrong twins
   (``exp_attn_wrong``), which must fall outside those bounds, and at the
   edges of its tiles (N 127-129, 255-257, 2045-2047) for every head dim on
   strided views; one call, back to back and the host's time to enqueue one;
4. K5 (CRF kernel-apply) against its plain twin at the fast CRF's
   full-resolution slice (2 images of 448^2, 3,136 pivots, V = 22 and 1);
5. the serving slice: a ViT-B/16 dual student (VOC, 21 classes, crop 448,
   weights from seed 0) behind the batched HTTP server; 16 concurrent
   clients POST JPEG/PNG images of varied sizes, twice (the second round is
   measured); every answer must be a 200 label map of the input's size, and
   both kernels must have launched in the measured round, and kernel G (the
   exact GELU) once a block and pass, as often as K1;
6. the same model at crop 224, batch 1, on the card and on the CPU (plain
   paths): ensemble logits before the CRF, and the CRF labels, must agree;
6b. COCO serving: ``make_serving_fn(coco_config())`` (81 classes) at batch
   2, crop 448, sum merge: well-formed labels, and K5 launched at V 82;
7. K3 (PAR affinity) against its plain twin at (16, 224, 224, 3): smooth,
   noisy and uint8-quantised images, and a ragged small case; the same bits
   from call to call; four wrong twins (``par_affinity_wrong``) outside the
   bound on the smooth and uint8 images; one call and back to back; K3's
   global-memory instantiation (dilation sets past the shared-memory ones:
   ``P7_PAST_CAP``, (1, 2, 4, 8, 12, 24, 48) and (2, 64)) on the uint8
   image at the same bound, the same bits twice, timed;
8. K4 (PAR propagation) against its plain twin at 16 x 224^2, 10 rounds:
   C = 40 in fp32 and bf16, C = 84 in fp32, and a ragged case; its
   global-memory instantiation at C 40, fp32 and bf16, on phase 7's
   affinities of ``P7_PAST_CAP``, at the same bounds, timed;
9. the pseudo-label slice: ``make_pseudo_label_fn`` with the same model at
   batch 16, crop 448 (multi-scale CAM of both students, PAR, fast CRF):
   two warm-up calls, five timed calls; well-formed labels, and K1, K3, K4
   and K5 launched in the timed calls; then one call past the class budget,
   which must launch K4 at full width and match the timed call's labels on
   the images it shares with it;
10. the pseudo-label path at crop 224, batch 2, on the card and on the CPU,
   within the class budget and past it: refined and CRF labels must agree;
11. K2 (exp-attention backward) against its plain twin at the training
   step's shapes (B 4, H 12, D 64, N 785 and 442), one case per other head
   dim and one with scores past the clamp, k and v strided as the model
   passes them, the same bits from call to call, three wrong twins
   (``exp_attn_bwd_wrong``) outside the bounds, the edges of its tiles (N
   127-129, 255-257, 895-897) for every head dim; timed (one call, back to
   back, host) beside autograd's backward through
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   replayed as a CUDA graph so that its device time is read;
12. the training slice: ``Trainer.train_step`` of the production recipe
   (ViT-B/16 dual student, crop 448, batch 4, bf16 compute, fp32 stream in
   the differentiated pass, bf16 stream in the no-grad CAM passes) in the
   ``warmup``, ``seg`` and ``full`` phases, one untimed and three timed
   steps each: finite losses, every trainable parameter moved (but the
   decoder in warm-up, and never ``pos_embed``), the launches of K1-K4 a
   step as counted from the code, G's as K1's and G's backward's as K2's,
   no plain twin run on a CUDA tensor, and
   no host sync inside a step (``torch.cuda.set_sync_debug_mode("error")``);
   then K3 and K4 against their twins on the operands one of those steps
   handed them (4 images at 224^2, the compacted class axis, fp32);
13. one full-phase ``grad_step`` at crop 224, batch 2, with the same
   augmentation draws, on the card and on the CPU, on a batch and a
   confidence threshold that keep every loss term live: each side's labels
   must agree; on the card's labels, losses and gradient directions must
   agree; and the strong view's backward must change the gradient;
13b. the COCO training step: ``Trainer.train_step`` of
   ``production_config("coco")`` (81 classes, aux CAMs from layer 9, PAR
   class budget 16) in the ``seg_static`` and ``full`` phases at batch 4,
   crop 448: finite losses, the launches of K1-K4 a step (K4 at C 64), no
   twin on a CUDA tensor; K1, K2 and K4 against their twins on the full
   step's own operands;
14. L1f (flash-attention forward) against its plain twin at the evaluation
   path's shape (B 16, N 2117, H 12, D 64: eight 500 x 500 images and their
   flips at scale 1.5) and at (B 2, N 5185) (a 768 crop at scale 1.5), k and
   v strided as the model passes them, and against two wrong twins (p left
   in fp32; p rounded against the row's global maximum), which must fall
   outside the bounds; timed beside ``F.scaled_dot_product_attention``; then
   L1f and L1b at the edges of their tiles (N 127-129, 2047-2049) for every
   head dim (16, 32, 64, 80);
15. L1b (flash-attention backward) against its plain twin at (B 2, N 2305,
   H 12, D 64) (a 768 crop and its flip) on the forward kernel's out and
   log-sum-exp, bit-equal from call to call, and against three wrong twins,
   which must fall outside the bounds; timed beside autograd's backward
   through the library call, replayed as a CUDA graph;
16. the evaluation path: a synthetic VOC-structured tree written here (24
   JPEGs with masks: 8 each of 500 x 375, 375 x 500 and 500 x 500),
   ``SegEvaluator`` of the VOC protocol (native resolution, scales 1.0 /
   1.5 / 1.25 x flip, max merge, both passes, device CRF) at batch 8, twice
   (the second run is measured and its forwards run under
   ``torch.cuda.set_sync_debug_mode("error")``): three buckets of one batch,
   the launches of K1, L1f and K5 a batch as counted from the code, no twin
   on a CUDA tensor, K5 against its twin on a batch's own operands (N
   189,504, 2,961 pivots, V 21), histograms that sum to the labelled
   pixels; then ``Validator.run`` on the same tree at crop 448, batch 8;
17. the differentiated flash attention on a path: one warm-up
   ``Trainer.grad_step`` at crop 768, batch 1, full width and depth (2305
   tokens with grad, 5185 without): launches of L1f and L1b as counted from
   the code, a finite loss, a finite gradient for every parameter of the
   phase's graph; then, at depth 2 and full width, card against CPU: one
   500 x 500 image through ``msc_seg_logits`` (every pixel whose label
   differs must be a near tie of its two top logits on the CPU side) and one
   such ``grad_step``.

18. P1 (exp attention with the row sum taken by the second product) and
19. P2 (exp attention with the q scale in the kernel), both on K1's design
   (``csrc/attention_fwd.cuh``), each through its experiment tool's ``run``
   at the tool's full shapes (BH 768 / B 64, H 12, D 64, N 197, 785, 1765)
   beside K1, then against its twin in bf16 ulps of the row and against two
   wrong twins each (``exp_attn_ones_wrong``: the fp32 row sum, keys past N
   counted; ``exp_attn_bnhd_wrong`` at scale 0.11: the scale left in fp32,
   the scale on the scores) that must fall outside; P2 bit-equal to K1 on
   the scaled q at scales 0.125 and 0.11; one call, back to back and the
   share of the bound, beside ``F.scaled_dot_product_attention``;
20. P3 (CRF kernel-apply with the exp taken in bf16) through its tool at
   (16, 200,704, 11) x (16, 11, 3,136) x (16, 3,136, 22) beside K5 and the
   plain tile loop, then against its twin and the fp32-exp twin (outside),
   with pivots of logc = -inf, which give exactly 0; then on the fast CRF's
   own operands (phase 4's two 448^2 images) at V 22 and 82, every 32-column
   slice bit-equal to a call on it alone, beside K5; its share of the bound
   and the tool's K5 / P3 ratio;
21. P4 (the instruction-rate probe) through its tool: six functions in fp32, five
   in bf16, (512, 1024) x 4096 passes: ms, Gop/s, each against its twin and
   beside the bound of the unit that binds it;
22. the training run: ``tools/train_torch.py`` in-process on a synthetic VOC
   tree of 40 train and 8 val JPEGs at full width and depth (crop 448, batch
   4, uint8 wire format): 12 steps through warm-up, seg and full with
   validation, checkpoint and weight export at steps 6 and 12, every step
   that is neither a log nor an eval boundary nor the process's first in
   its phase under the sync debug mode, the
   launches of K1-K4 in every step as in phase 12, no twin on a CUDA tensor;
   then ``--resume`` to step 14, which must start at step 12 on batch 12 of
   the loader's index stream; s/it per phase beside phase 12's bare step,
   the feeder's wait, the host-to-device copy, validation and checkpoint
   times;
23. COCO inputs, at full width and depth (ViT-B/16, crop 448, bf16): (a) a
   ``write_synthetic_coco`` tree (24 train and 16 ``val_part`` JPEGs of
   281-640 px, one grayscale) packed by ``pack_coco`` into two ``.duplrec``
   shards a split and read back through a glob, every val sample equal to
   the tree's, and a synthetic DeiT-B/16 ``.pth`` (seeded timm-named
   tensors under ``{"model": ...}`` with a 1000-row head and a
   distillation token, both dropped on load); (b) ``tools/train_torch.py
   --dataset coco --train-records --val-records --pretrained`` in-process,
   batch 4, 6 steps through ``seg_static`` and ``full``, validation and
   weight export at 6: both students' encoders equal the ``.pth`` bit for
   bit before step 0, finite losses every step, the launches of K1-K4 a
   step as in phase 13b, no twin on a CUDA tensor; the run twice, fed
   from the shards and from the tree (s/it beside s/it); (c)
   ``tools/eval_seg_torch.py
   --dataset coco --records`` on (b)'s ``weights.npz``, batch 8, device CRF
   (fixed crop, scales 1.0 / 1.25 / 1.5 x flip summed at the decoder grid,
   the full mean-field CRF: 1 + 10 K5 applies a batch at V 1 and V 81):
   K1 72 a forward, K5 11 a CRF batch, K5 against its twin on a batch's
   own V 81 operands within phase 4's bounds, histograms that sum to the
   labelled pixels and equal those of the same run from the tree; one run
   from the shards (it takes the first calls at these shapes), then one
   from the tree; (d)
   ``tools/crf_width_probe_torch.py``: the fast CRF at B 16, 448^2, C 21 /
   32 / 81, ``pos_w`` 1 and 0, one K5 launch a call;
24. data-parallel and fully-sharded training (``dupl_tpu_torch/parallel``)
   at full width on the first ``P24_DEPTH`` (4) of ViT-B/16's 12 blocks
   (as phases 25 and 26; ``production_config("voc")``, crop 448, batch
   4), three steps at the start of each phase, each phase's from the same
   seeded weights and a fresh optimizer: (a) the bare ``Trainer``,
   then a process group of one over NCCL, plain and FSDP, and the bare
   ``Trainer`` again, K1-K4 launches a step as phase 12 in every arm, each
   arm against the first bare run (``P24_FIRST_REL``, ``P24_LATER_REL``,
   ``P24_GRAD_COS``, ``P24_LEAF_REL``); (b) two spawned ranks sharing the
   card over gloo at batch 2 each, against the bare run at batch 4 the same
   way; (c) ``torchrun --nproc_per_node 1 tools/train_torch.py --multihost
   --sync-debug`` on phase 22's tree, 5 steps with validation and a
   checkpoint at 4, then ``--resume`` to 7.  Step ms of every arm, peak
   memory of every rank;
25. the sealed artifacts (``dupl_tpu_torch/engine/export.py``), ViT-B/16 at
   full width and depth ``P24_DEPTH``, seeded weights, crop 448: (a) ``export_serving`` at
   batch 8 (MSC 1.0/1.5/1.25 x flip, ensemble, fast CRF), ``save_artifact``,
   then ``load_artifact`` in a fresh process (``sealed_child``) on phase
   5's 16 images: labels equal to the live ``make_serving_fn``'s on at
   least ``P25_AGREE`` of the pixels, K1 and K5 launched as live (72 and 1 a
   dispatch); (b) ``export_pseudo_labeler`` at batch 16, one call within
   the class budget and one past it: both outputs as (a), K1 / K3 / K4 / K5
   72 / 1 / 10 / 1 a call; (c) one HTTP round of 8 requests through
   ``tools/serve_torch.py --artifact``; (d) the live and sealed dispatch ms
   (``utils/timing.py:dispatch_ms``), the artifacts' size and export, save
   and load seconds, K1's and K2's host us through their ops;
26. tensor parallelism (``dupl_tpu_torch/parallel/tensor_parallel.py``) at
   full width and depth ``P24_DEPTH``: (a) two spawned ranks sharing the card over gloo as one
   model group (data 1 x model 2), each on the whole batch of 4 and its 6
   of each block's 12 heads, phase 24's steps from phase 24's seeded
   weights, each rank held on the gradient gathered to the one-device
   layout to three references: the bare ``Trainer`` computing as the
   model group does (``p26_split_model``, plain PyTorch: the fp32 partial
   sums in rank order, in one process) at phase 24's bounds; the plain
   bare run at the looser ``P26_BARE_*`` bounds (a sum's order moves bf16
   results), which must catch the planted faults ``P26_FAULTS``, beside a
   one-process order witness (the split on fp32 casts' products); each
   phase's first step in fp32 against the bare ``Trainer`` in fp32 at the
   looser bounds; ``tensor_parallel._mm_fp32``'s card branch against fp32
   casts at the layers' shapes; K1-K4 launches a step as phase 12, no twin on a
   CUDA tensor, the two ranks' logged metrics equal; K1 and K2 on each rank's own block-0 operands ((4, 785, 6, 64),
   k and v strided at row stride 1152) against their twins at phases 3
   and 11's bounds; (b) the run's checkpoint restored into the bare
   ``Trainer`` equals its gathered weights bit for bit; (c) ms a step, peak
   memory and parameter bytes of each rank beside the bare run's (a rank
   holds half of the tensor-parallel leaves); (d) after their steps the two
   ranks run the int8 CAM stage (``p26_int8``: bench_config's int8 model at
   depth ``P24_DEPTH``, ``cam_only`` and both students'
   ``multi_scale_cam_with_outputs`` on 2 images of 448^2), each row-parallel
   product's maxima and int32 sums all-reduced over gloo (MAX on fp32 and
   SUM on int32 CUDA tensors, checked on their own): CAMs, aux CAMs and
   class scores bit-equal to the parent's one-process run, seg within
   ``P26_INT8_SEG``, the launches of Q1's and Q2's entries and K1 as
   ``p26_int8_expected`` counts them, no twin on a CUDA tensor;
27. the run operations at full width: (a) ``utils/tb.cam_grids``, the
   training run's CAM-grid pass (``production_config("voc")``, seeded
   weights, a uint8 batch of 4 at crop 448): three uint8 grids of (896,
   896, 3), K1 launched 72 times and nothing else (one no-grad multi-scale
   CAM pass of both students), its CAMs bit-equal to
   ``Trainer._multi_scale_cams`` on the same inputs, its grids equal to
   ``cam_overlay_grid`` recomputed on the host, and whether ``TbWriter``
   finds a backend on the machine; (b) ``utils/flops.count_flops`` of one
   ``train_step`` a phase at crop 448, batch 1, and of phase 17's warm-up
   ``grad_step`` at crop 768, at depth 2, full width: the card route (K1 /
   K2, and L1f / L1b at 768, by their ops' flop formulas) and the CPU route
   (exact softmax attention) must count the same FLOPs; (c)
   ``tools/bench_train_torch.py --phase {warmup,seg,full} --iters 3`` at
   full depth: FLOPs a step, TF an image, ms a step and MFU beside the
   card's name and power limit;
28. the co-run on the card: the port's ``Trainer`` on ``corun_config``
   and a ``write_corun_tree`` tree (32 train JPEGs), on the card and on
   the CPU from the same seeded weights, batches and strong-view op
   indices, in lockstep: (a) 60 steps at crop 64 through warm-up, seg and
   full (K3 and K4 launch; K1 and K2 do not, every sequence being under
   ``_EXP_MIN_SEQ`` tokens); (b) 12 steps at crop 192 (145 and 325 tokens:
   K1-K4 launch, the CPU side routing ``models/vit.py``'s attention through
   ``exp_attention``'s twins from the same threshold); each arm's per-step
   gap, first step past ``P28_FIRST`` and phase means held to its bounds
   in ``P28_ARMS``, K1-K4 launches a step as ``p28_expected`` counts them,
   no twin on a CUDA tensor, and the GMM filter skipped on the card for two
   steps from the first full step, which must break the bounds;
29. the JAX side's measurement programs in bench.py's configuration
   (``config.bench_config``: tanh GELU, bf16 residual stream, PAR in bf16)
   at full width and depth, in-process through their ``run``: (a)
   ``bench_torch.py`` (batch 16, crop 448, blob scenes; one warm-up call,
   one counted by ``count_flops``, 3 windows of 10): its line carries
   bench.py's keys, img/s above 0 and 0 < mfu <= 1, K1 / K3 / K4 / K5
   launch 72 / 1 / 10 / 1 times a call, and its refined and CRF labels
   equal ``make_pseudo_label_fn``'s bit for bit on the same inputs; (b)
   ``tools/bench_components_torch.py`` VOC, batch 16, ``--iters 2``; (c)
   the same at COCO width with 20 classes an image (``--dataset coco
   --density dense``, ``--iters 1``): PAR past the class budget runs K4 at
   C 324 and the CRF labels on 32 classes run K5 at V 33, and the first
   launch at each width is held to its twin on its own operands (2 bf16
   ulps of each element; phase 4's bounds), timed beside it; (d)
   ``tools/encoder_dissect_torch.py`` at 64 sequences of 448^2, ``--iters
   3``; (e) ``tools/train_dissect_torch.py`` at batch 8, ``--iters 2``;
   every tool's rows, no twin on a CUDA tensor;
30. the exact GELU and the int8 inference path: (a) kernel G
   (``csrc/gelu_erf.cu``) forward and backward against its twins on all
   65,536 bf16 bit patterns (the cotangent with ±0, ±inf and NaN) and
   2^20 fp32 values and at lengths 1 and 7, 0 unequal elements, and the
   wrong twins of ``gelu_wrong`` (F.gelu, the formula without XLA's FMAs,
   one FMA more; the bf16 table read at -x, the packed factors swapped,
   the exp of the unrounded z^2) and F.gelu's backward unequal; G, its
   twin and F.gelu timed at the MLP's hidden activations (16 x 785 x 3072
   bf16; one call, and back to back), by erfc branch, and in fp32, and
   G held to its twins there
   (0 unequal) in bf16 and fp32: the whole tensor, a length off the vector
   width, a view off 16-byte alignment; (b) Q1
   (``csrc/quantize_rows.cu``: both operands of a product in one launch)
   and Q2 (``csrc/int8_gemm.cu``) against their twins bit for bit at
   ViT-B's four products (qkv, proj, fc1 in bf16, fc2 in fp32, each with
   its fp32 weight, M 12,560), a ragged M and Q2's edges (M 1, M 63, N
   1000, K 96), with and without the bias, the wrong twins of
   ``quant_wrong`` and Q1's of ``q1_wrong`` unequal, timed beside
   ``torch._int_mm`` + rescale and the twins; Q1's GELU entry (fc1's fp32
   output through the tanh or the erf GELU with fc2's weight) bit for bit
   at 12,560, 1 and 63 rows of 3072 and at K 96, its wrong twins (tanhf,
   the scale one ulp off, the maximum over half the row) unequal, timed
   beside the former nine-op torch.tanh chain and G in fp32 (one call,
   back to back, and Q1's device time in a CUDA graph); the bf16 tanh GELU
   on the card against the CPU on the same values (a reading); (b2)
   ``p30_two_pass``: Q1's two-pass entries (``row_absmax_pair``,
   ``quantize_pair_given``), ``int8_matmul_i32`` and ``int8_rescale``
   against their twins bit for bit at K 8192 in fp32 (with and without
   each GELU) and 16,384 in bf16 and at a model rank's shares of ViT-B/16's
   proj and fc2 at TP 2, one wrong twin each unequal, timed at the shares
   beside their bounds, ``torch._int_mm`` and the one-process product; (c)
   ``tools/bench_components_torch.py --int8`` at batch 16 with every
   kernel's count zeroed before and read after (Q1's two entries, Q2, K1,
   K3, K4, K5 launched; one Q1 launch a product, one GELU entry a block's
   fc2, no fp32 GELU call and no G launch; no twin on a CUDA tensor), its
   rows beside phase 29's bf16 rows, the int8 multi-scale CAMs against the
   bf16 ones on the same weights and images (argmax agreement,
   correlation), a quantized forward's FLOPs equal on the card and on the
   CPU, and the same forward with the exact GELU (its GELU entry, no G);
31. float16 where the JAX package takes it: (a) kernel G's f16 mode
   forward and backward against its twins on all 65,536 f16 bit patterns
   (a cotangent from 2^-24 to 2^15 with ±0, ±inf and NaN), at lengths 1
   and 7 and at the MLP's hidden shape (whole, a tail, a view off 16-byte
   alignment), 0 unequal, the wrong twins of ``gelu_f16_wrong`` (one
   rounding, the erfc of the unrounded z, the backward without its f16
   FMA) unequal; timed (one call, back to back, a CUDA graph) beside its
   bf16 mode, ``F.gelu`` on f16 and the twins; (b) K4's f16 mode against
   its twin, 0 unequal, at 16 x 224^2, C 40, 10 rounds, at the recipe's
   dilations and at (1, 2, 4, 8, 12, 24, 48) (its global-memory
   instantiation), and a ragged case, unequal to the bf16 twin, timed
   beside its bf16 and fp32 modes; (c) the f16 path at full width (exact
   GELU, PAR in f16): a serving dispatch of 8 from
   ``InferenceSession.from_weights`` and a pseudo-label call of 16, the
   counts zeroed before and read after (G 12 launches a student forward,
   as K1, all in f16; K4 10, all in f16), timed in turns beside the
   recipe's bf16; the same calls at crop 224 and 4 of 12 blocks on the
   card and on the CPU (labels at least 98% equal).

Then a JSON line with every kernel's launches, error, times and bound (the
least time the card could take: operations over its peak rate or bytes over
its memory rate, whichever is larger; kernel times are medians of one call
between two CUDA events, and the attention entries, G, Q1 and Q2 add
``ms_back_to_back``, rounds of back-to-back calls, K1 and K2 also
``host_us``; K1, K3, K4 and
K5 also ``launches_bench``, their launches a ``bench_torch.py`` call; Q1's
two-pass entries, ``int8_matmul_i32`` and ``int8_rescale`` their launches
on a rank of phase 26's int8 run and their times at its fc2 share; K3 and
K4 also ``past_cap``; G's and K4's f16 modes as ``gelu_erf_f16`` and
``par_propagate_f16``), and last ``{"ok": true, "device": {...}}``.
Any failed phase raises: the script exits non-zero and prints no result.
Without a CUDA device it exits 2.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor


def bf16_ulp(x):
    """The bf16 ulp at |x| (elementwise)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(
        x.clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def row_ulps(got, want):
    """(max, mean) of |got - want| in bf16 ulps of each row's scale (max
    |want| over the head dim)."""
    want = want.float()
    u = (got.float() - want).abs() / bf16_ulp(
        want.abs().amax(-1, keepdim=True))
    return u.max().item(), u.mean().item()


def bwd_ulps(got, want):
    """(max, mean) over dq, dk, dv ((B, N, H, D) each) of the row-ulp error
    against the twin's (BH, N, D)."""
    from dupl_tpu_torch.ops import attention

    worst = mean = 0.0
    for x, w in zip(got, want):
        a_, m_ = row_ulps(attention._to_bhnd(x), w)
        worst, mean = max(worst, a_), max(mean, m_)
    return worst, mean


def check(cond: bool, msg: str) -> None:
    """Fail the phase (asserts vanish under ``python -O``; this does not)."""
    if not cond:
        raise RuntimeError(msg)


def flash_fwd_wrong(q, k, v, scale, kind):
    """L1f's twin with p rounded wrongly, on bf16 (..., N, D) operands:
    ``p_fp32`` contracts the unrounded fp32 p with v, ``global_max`` rounds
    p = exp(s - the whole row's maximum) in place of the running maximum of
    the 128-key tiles.  Phase 14 and the card-only tests hold L1f's bounds
    against both."""
    import torch

    qf, kf, vf = (x.float() for x in (q, k, v))
    s = scale * (qf @ kf.transpose(-1, -2))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    num = (p if kind == "p_fp32" else p.to(torch.bfloat16).float()) @ vf
    return (num / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def exp_attn_wrong(q, k, v, kind):
    """K1's twin with one rounding or reduction changed, on (..., N, D)
    operands with q pre-scaled: ``running_max`` is L1f's online softmax at
    scale 1 over 128-key tiles (what K1 would compute if it took the flash
    kernel's per-tile step), ``p_fp32`` contracts the unrounded fp32 e with
    v, ``denom_bf16`` sums the bf16-rounded e for the denominator (P1's row
    sum through the tensor cores).  Phase 3 and the CPU and card tests hold
    K1's bounds against each."""
    import torch

    from dupl_tpu_torch.ops import attention

    if kind == "running_max":
        return attention.flash_attention_ref(q, k, v, 1.0)[0]
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    e = torch.exp(torch.clamp(qf @ kf.transpose(-1, -2), max=60.0))
    eb = e.to(torch.bfloat16).float()
    num = (e if kind == "p_fp32" else eb) @ vf
    den = (eb if kind == "denom_bf16" else e).sum(-1, keepdim=True)
    return (num / den).to(torch.bfloat16)


def exp_attn_ones_wrong(q, k, v, kind):
    """P1's twin with one step changed, on (..., N, D) operands with q
    pre-scaled: ``fp32_row_sum`` divides by the sum of the fp32 e (K1's
    denominator), ``pad_counted`` adds 1 for each key past N up to the next
    multiple of the 128-key tile (a constant ones tile meeting e = exp(0) of
    the zero key rows that TMA fills in, had the step not masked them).
    Phase 18 and the CPU and card tests hold P1's mean bound against each."""
    import torch

    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    e = torch.exp(torch.clamp(qf @ kf.transpose(-1, -2), max=60.0))
    eb = e.to(torch.bfloat16).float()
    den = (e if kind == "fp32_row_sum" else eb).sum(-1, keepdim=True)
    if kind == "pad_counted":
        den = den + (-q.shape[-2] % 128)
    return ((eb @ vf) / den).to(torch.bfloat16)


def exp_attn_bnhd_wrong(q, k, v, scale, kind):
    """P2's twin with the scale applied wrongly, on unscaled (B, N, H, D)
    operands: ``fp32_scale`` rounds q * scale to bf16 once with the scale
    left in fp32, ``scale_on_scores`` multiplies the fp32 scores by the fp32
    scale (the exact softmax's way) in place of scaling q in bf16.  At a
    scale bf16 holds (1/8) both are P2's function; at 0.11 phase 19 and the
    CPU and card tests hold P2's mean bound against each."""
    import torch

    from dupl_tpu_torch.ops import attention

    qf, kf, vf = (attention._to_bhnd(x).to(torch.bfloat16).float()
                  for x in (q, k, v))
    if kind == "fp32_scale":
        qf = (qf * scale).to(torch.bfloat16).float()
    s = qf @ kf.transpose(-1, -2)
    if kind == "scale_on_scores":
        s = s * scale
    e = torch.exp(torch.clamp(s, max=60.0))
    out = (e.to(torch.bfloat16).float() @ vf) / e.sum(-1, keepdim=True)
    return attention._from_bhnd(out.to(torch.bfloat16), q.shape[0])


def exp_attn_bwd_wrong(q, k, v, g, kind):
    """K2's twin with one step left out, on (..., N, D) operands with q
    pre-scaled: ``no_delta`` drops delta, ``ds_fp32`` leaves ds unrounded,
    ``no_clamp_mask`` passes gradient where a score reached the clamp;
    ``none`` changes nothing.  Phase 11 and the CPU and card tests hold K2's
    bounds against each."""
    import torch

    qf, kf, vf, gf = (x.to(torch.bfloat16).float() for x in (q, k, v, g))
    s = qf @ kf.transpose(-1, -2)
    e = torch.exp(s.clamp(max=60.0))
    p = e / e.sum(-1, keepdim=True)
    t = gf @ vf.transpose(-1, -2)
    delta = (p * t).sum(-1, keepdim=True)
    if kind == "no_delta":
        delta = torch.zeros_like(delta)
    ds = p * (t - delta)
    if kind != "no_clamp_mask":
        ds = torch.where(s < 60.0, ds, torch.zeros_like(ds))
    if kind != "ds_fp32":
        ds = ds.to(torch.bfloat16).float()
    dq, dk = ds @ kf, ds.transpose(-1, -2) @ qf
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ gf
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def crf_apply_wrong(basis, coef, logc, vals, kind, block_rows=25088):
    """K5's twin with one rounding changed: ``k_fp32`` leaves the kernel
    entries in fp32, ``vals_fp32`` leaves the values in fp32, ``exp_bf16``
    takes the exp of the clamped score rounded to bf16 (P3's roundings).
    Each is a mistake a tensor-core rewrite can make (fp32 operands through
    TF32, say).  Phase 4 and the CPU and card tests hold K5's bounds
    (:func:`crf_apply_err`) against each."""
    import torch

    vb = vals if kind == "vals_fp32" else vals.to(torch.bfloat16).float()
    out = []
    for lo in range(0, basis.shape[1], block_rows):
        s = torch.minimum(basis[:, lo:lo + block_rows] @ coef,
                          logc[:, None, :])
        if kind == "exp_bf16":
            s = s.to(torch.bfloat16).float()
        k = torch.exp(s)
        if kind != "k_fp32":
            k = k.to(torch.bfloat16).float()
        out.append(k @ vb)
    return torch.cat(out, dim=1)


# K5's bounds, each against a column's scale (max |want| over the batch and
# pixels): the largest error at most 2e-3 of it (an entry's bf16 rounding,
# 2^-8, can flip when the 11-wide fp32 score is summed in another order),
# the mean error at most 2e-5 of it (a right kernel 4.5e-6 on the CPU, the
# nearest wrong twin of crf_apply_wrong 1.1e-4).
K5_MAX, K5_MEAN = 2e-3, 2e-5


def crf_apply_err(got, want):
    """(max, mean) over K5's output columns of the largest and of the mean
    absolute error, each over the column's scale.  Inside K5's bounds iff
    max <= K5_MAX and mean <= K5_MEAN."""
    import torch

    err = (got - want).abs().flatten(0, 1)
    scale = want.abs().flatten(0, 1).amax(0).clamp_min(
        torch.finfo(torch.float32).tiny)
    return ((err.amax(0) / scale).max().item(),
            (err.mean(0) / scale).max().item())


def crf_images(g, dev, size=448):
    """Two smooth (size, size, 3) images in [0, 1] with noise from ``g``,
    the second the first upside down: the fast CRF's test scenes (phases 4
    and 20)."""
    import torch

    yy, xx = torch.meshgrid(torch.linspace(0, 1, size, device=dev),
                            torch.linspace(0, 1, size, device=dev),
                            indexing="ij")
    img = torch.stack([torch.sin(6 * xx) * 0.5 + 0.5, yy, xx * yy], -1)
    img = torch.stack([img, img.flip(0)])
    return (img + 0.03 * torch.randn(img.shape, generator=g, device=dev)
            ).clamp(0, 1)


def par_affinity_wrong(img, kind, dilations=(1, 2, 4, 8, 12, 24), w1=0.3,
                       w2=0.01):
    """K3's twin (``par_cuda.affinity_ref``) with one change: ``w2_half``
    the position term at half its w2, ``reflect_pad`` reflect padding in
    place of replicate (images larger than the largest dilation),
    ``biased_std`` the variance over K and not K - 1, ``fma_var`` sum x^2
    accumulated by fused multiply-add (emulated in float64, rounded to fp32
    once a tap).  Each is a mistake a rewrite of the kernel can make; phase
    7 and the CPU and card tests hold K3's 1e-5 bound against each."""
    import torch

    from dupl_tpu_torch.ops.image import shift_clamped
    from dupl_tpu_torch.ops.par import position_affinity, tap_offsets

    x = img.float().permute(0, 3, 1, 2)                        # (B, 3, H, W)
    h, w = x.shape[2:]

    def tap(dy, dx):
        if kind != "reflect_pad":
            return shift_clamped(x, dy, dx, axis=2)
        iy = (torch.arange(h, device=x.device) + dy).abs()
        ix = (torch.arange(w, device=x.device) + dx).abs()
        iy = torch.where(iy > h - 1, 2 * (h - 1) - iy, iy)
        ix = torch.where(ix > w - 1, 2 * (w - 1) - ix, ix)
        return x.index_select(2, iy).index_select(3, ix)

    offs = tap_offsets(dilations)
    k = len(offs)
    s1 = torch.zeros_like(x)
    s2 = torch.zeros_like(x)
    for dy, dx in offs:
        t = tap(dy, dx)
        s1 = s1 + t
        s2 = ((s2.double() + t.double() * t.double()).float()
              if kind == "fma_var" else s2 + t * t)
    mean = s1 * (1.0 / k)
    var = torch.clamp(s2 - k * mean * mean, min=0.0) * (
        1.0 / (k if kind == "biased_std" else k - 1))
    inv_w1 = torch.tensor(1.0 / w1, dtype=torch.float32, device=x.device)
    inv = inv_w1 / (torch.sqrt(var) + 1e-8)
    sc = torch.stack([-((tap(dy, dx) - x).abs() * inv).square().mean(dim=1)
                      for dy, dx in offs], dim=1)              # (B, K, H, W)
    e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
    pos = torch.tensor(position_affinity(
        dilations, w1, w2 / 2 if kind == "w2_half" else w2),
        dtype=torch.float32, device=x.device)
    return e / e.sum(dim=1, keepdim=True) + pos[None, :, None, None]


# The co-run: a whole training run at a tiny size, the port held step by
# step to the JAX package on the CPU (tests/test_torch_corun*.py) and the
# card to the CPU (phase 28).  Its settings and its tree live here, where
# both packages' tests and the card's run read them and nothing imports JAX.
CORUN_FG = 20          # VOC's foreground classes


def corun_config(mod, n_steps, crop=64, **over):
    """The co-run's recipe from either package's config module ``mod``
    (``dupl_tpu.config`` or ``dupl_tpu_torch.config``) for a run of
    ``n_steps``: ViT ``test_tiny_patch16`` in float32 (no bf16 CAM stream),
    crop ``crop``, batch 2; the warm-up of the learning rate over the first
    twelfth of the run (from a tenth of the rate), the seg phase from a fifth
    and the full phase from two fifths of it; a consistency threshold and
    GMM gates low enough that at random-ish weights every full step has
    consistency pixels and the GMM marks noise; two PAR rounds; CAMs merged
    at half size.  ``over`` replaces any field."""
    import dataclasses

    base = mod.voc_config()
    kw = dict(
        model=dataclasses.replace(base.model, backbone="test_tiny_patch16",
                                  compute_dtype="float32",
                                  cam_stream_dtype=None),
        data=dataclasses.replace(base.data, crop_size=crop),
        optim=mod.OptimConfig(lr=1e-4, warmup_iters=max(1, n_steps // 12),
                              warmup_ratio=0.1),
        par=dataclasses.replace(base.par, num_iter=2),
        gmm=mod.GmmConfig(min_pixels=10, valid_thre=0.05),
        cam_iters=n_steps // 5, gmm_iters=2 * n_steps // 5,
        max_iters=n_steps, reg_conf_thre=0.02, cam_merge_downscale=2,
        samples_per_device=2)
    kw.update(over)
    return mod.voc_config(**kw)


def corun_colours(num_fg=CORUN_FG):
    """The co-run tree's colour of each foreground class, (num_fg + 1, 3)
    uint8 (row 0, the background, is unused): hues round the wheel, two
    brightness levels, the same for every seed."""
    import colorsys

    import numpy as np

    out = np.zeros((num_fg + 1, 3), np.uint8)
    for c in range(1, num_fg + 1):
        rgb = colorsys.hsv_to_rgb((c - 1) / num_fg, 0.85,
                                  0.95 if c % 2 else 0.6)
        out[c] = np.round(255 * np.asarray(rgb))
    return out


def _corun_scene(rs, h, w, colours):
    """Two objects of random classes, one in each half of the image, on a
    grey textured background: each class its own colour and stripe
    texture, noise on every pixel, four ignore pixels.  (uint8 image, uint8
    mask)."""
    import numpy as np

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.full((h, w, 3), rs.randint(70, 180), np.float32)
    img += 12 * np.sin(xx / rs.uniform(3, 9) + yy / rs.uniform(3, 9))[..., None]
    mask = np.zeros((h, w), np.uint8)
    half = w // 2
    for i in range(2):
        c = rs.randint(1, len(colours))
        y0 = rs.randint(0, h // 4)
        y1 = y0 + rs.randint(h // 2, h - y0 + 1)
        x0 = i * half + rs.randint(0, half // 4)
        x1 = x0 + rs.randint(half // 2, (i + 1) * half - x0 + 1)
        angle = np.pi * c / len(colours)
        stripes = np.sin((xx * np.cos(angle) + yy * np.sin(angle))
                         / (1.5 + 0.25 * (c % 5)))
        obj = colours[c][None, None].astype(np.float32) + 25 * stripes[..., None]
        img[y0:y1, x0:x1] = obj[y0:y1, x0:x1]
        mask[y0:y1, x0:x1] = c
    mask[0, :4] = 255
    img = np.clip(img + rs.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
    return img, mask


def write_corun_tree(root, n_train=32, n_val=16, seed=0, num_fg=CORUN_FG):
    """A VOC-layout tree whose labels can be learned: every foreground class
    has the colour of ``corun_colours`` and a texture of its own.  JPEGs
    under ``JPEGImages``, masks under ``SegmentationClassAug``, the lists
    ``lists/train_aug.txt`` and ``lists/val.txt`` and
    ``lists/cls_labels_onehot.npy``, as both packages' ``VocClsDataset`` and
    ``VocSegDataset`` read them; sides of 64-100 pixels.  Returns (root,
    list folder)."""
    import os

    import numpy as np
    from PIL import Image

    colours = corun_colours(num_fg)
    img_dir = os.path.join(root, "JPEGImages")
    seg_dir = os.path.join(root, "SegmentationClassAug")
    lists = os.path.join(root, "lists")
    for d in (img_dir, seg_dir, lists):
        os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    labels, i = {}, 0
    for split, n in (("train_aug", n_train), ("val", n_val)):
        names = []
        for _ in range(n):
            name = f"2007_{i:06d}"
            i += 1
            img, mask = _corun_scene(rs, rs.randint(64, 101),
                                     rs.randint(64, 101), colours)
            Image.fromarray(img).save(os.path.join(img_dir, name + ".jpg"),
                                      quality=95)
            Image.fromarray(mask).save(os.path.join(seg_dir, name + ".png"))
            onehot = np.zeros(num_fg, np.float32)
            onehot[[c - 1 for c in np.unique(mask) if 0 < c <= num_fg]] = 1
            labels[name] = onehot
            names.append(name)
        with open(os.path.join(lists, split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    np.save(os.path.join(lists, "cls_labels_onehot.npy"), labels,
            allow_pickle=True)
    return root, lists


# Phase 24: data parallel and FSDP.  In every arm each phase's steps
# start from the same seeded weights and a fresh optimizer, so that the
# phase's first step compares two runs on equal weights.  Bounds: the first
# step of each phase within P24_FIRST_REL of the bare run on every logged
# loss term (relative, absolute below 1) and P24_GRAD_COS on the cosine of
# the whole gradient; the later steps within P24_LATER_REL on the loss
# terms, since their weights already differ by Adam steps taken on the
# card's run-to-run noise.  A cosine does not see a gradient scaled by a
# constant (a reduction that averaged, or a loss constant counted on every
# rank), so the worst leaf's relative L2 gap of the first steps is held to
# P24_LEAF_REL: sound runs read 0.38-0.61% there (the bare run against
# itself 0.41-0.51%), a factor of 2 reads 50%.
# Phases 7 and 8: dilation sets past K3's and K4's shared-memory
# instantiations (more than 6, or one over 40), which take their
# global-memory ones.
P7_PAST_CAP = ((1, 2, 4, 8, 12, 24, 48), (2, 64))
P24_FIRST_REL, P24_LATER_REL, P24_GRAD_COS = 1e-3, 1e-2, 0.999
P24_LEAF_REL = 2e-2
# Phases 24-26 run at full width on the first P24_DEPTH of ViT-B/16's 12
# blocks (``shallow``; the aux CAMs' block, -3, is block 1 there), so that
# the script has room for phase 28.  The bounds above were set at depth 12;
# a shallower stack sums fewer bf16 products, and they stay as they are.
P24_DEPTH = 4
P24_STEPS_A_PHASE = 3
P24_LOSSES = ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
              "reg_loss")


def p24_steps(cfg):
    """The first steps of each phase: warm-up, seg and full."""
    from dupl_tpu_torch.engine.train import phase_start

    return [phase_start(cfg, ph) + i for ph in ("warmup", "seg", "full")
            for i in range(P24_STEPS_A_PHASE)]


def p24_batches(n):
    """Global batches of 4 at crop 448, one a step."""
    from dupl_tpu_torch.data.pipeline import synthetic_batch

    return [synthetic_batch(4, crop=448, num_fg=20, seed=2400 + i)
            for i in range(n)]


def p24_weights(cfg, depth=None):
    """The seeded initial weights, on the host; ``depth``: the first blocks
    of each encoder only (``shallow``)."""
    import torch

    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent

    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if depth is not None:
        shallow(model, depth)
    return model.state_dict()


def p24_expected(expected, depth=P24_DEPTH):
    """Phase 12's launches a step (12 blocks) at ``depth`` blocks: K1 and K2
    launch once a block and pass."""
    return {ph: {k: n * depth // 12 if k.startswith("exp_attention") else n
                 for k, n in e.items()} for ph, e in expected.items()}


def p24_run(trainer, state, d, step, batch):
    """One step on this rank's slice of a global batch (its data rank's):
    its host ms to a synchronize, the launches of K1-K4 in it, and the
    logged metrics (summed over the data ranks)."""
    import torch

    from dupl_tpu_torch.ops import attention, par_cuda
    from dupl_tpu_torch.parallel.data_parallel import (METRIC_KEYS,
                                                       reduce_window)
    from dupl_tpu_torch.utils.logging import AverageMeter

    counters = {"exp_attention": attention.exp_attention_cuda,
                "exp_attention_bwd": attention.exp_attention_bwd_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda}
    b = len(batch["image"]) // d.n_data
    dev_batch = trainer.put({k: v[d.batch_slice(b)] for k, v in batch.items()})
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t = time.perf_counter()
    state, m = trainer.train_step(state, dev_batch, step=step)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    meter = AverageMeter()
    meter.add(m)
    return {"step": step, "ms": ms,
            "launches": {k: f.launches for k, f in counters.items()},
            "metrics": reduce_window(meter, d, METRIC_KEYS)}


def p24_grad_gap(want, got):
    """(cosine of the whole gradient, worst leaf's relative L2 gap, that
    leaf's name)."""
    check(sorted(got) == sorted(want),
          "the gradients are not on the bare run's parameters")
    dot = na = nb = 0.0
    leaf = (0.0, "")
    for n, w in want.items():
        g, w = got[n].double(), w.double()
        dot += float((g * w).sum())
        na += float(w.square().sum())
        nb += float(g.square().sum())
        leaf = max(leaf, (float((g - w).norm() / w.norm().clamp_min(1e-30)),
                          n))
    return dot / (na * nb) ** 0.5, *leaf


def p24_arm(dev, cfg, weights, expected, d, fsdp=False, ref=None,
            save_dir=None, prepare=None, per_phase=P24_STEPS_A_PHASE,
            phases=None):
    """The phase-24 steps on this rank: per phase (of ``phases``, all by
    default) a fresh state from ``weights``, placed by ``shard_state``
    (plain, ``fsdp``, or this rank's share under tensor parallelism), and
    its first ``per_phase`` steps.  Returns the step
    records, the peak memory, the memory already allocated before the arm,
    the bytes of the rank's parameters (all, and of the tensor-parallel
    leaves), and the first step's full gradients of each phase (``ref``
    None) or their gaps to ``ref``'s.  ``save_dir``: after the last
    phase's steps, ``save_state`` there (every rank) and return the
    gathered weights on the host.  ``prepare``: called on each fresh model
    before its steps."""
    import torch

    from dupl_tpu_torch.engine import checkpoint as ckpt
    from dupl_tpu_torch.engine.train import Trainer, phase_of
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.parallel.mesh import shard_state
    from dupl_tpu_torch.parallel.tensor_parallel import spec_of

    steps = p24_steps(cfg)
    batches = p24_batches(len(steps))
    recs, grads, peak, saved = [], {}, 0.0, None
    gc.collect()     # what earlier arms left (FSDP's units hold cycles)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev) / 2 ** 30
    for i in range(0, len(steps), P24_STEPS_A_PHASE):
        if phases is not None and phase_of(cfg, steps[i]) not in phases:
            continue
        last = i + per_phase
        with torch.device("meta"):       # no host init: the weights follow
            model = shallow(DualStudent(cfg.model), P24_DEPTH)
        model = model.to_empty(device=dev)
        model.load_state_dict(weights)
        if prepare is not None:
            prepare(model)
        trainer = Trainer(cfg, model=model, device=dev, dist=d)
        state = shard_state(trainer.init_state(init=False), d, fsdp=fsdp)
        param_bytes = {"all": 0, "tp_leaves": 0}
        for n, p in state.model.named_parameters():
            t = p.to_local() if hasattr(p, "to_local") else p
            nb = t.numel() * t.element_size()
            param_bytes["all"] += nb
            param_bytes["tp_leaves"] += nb if spec_of(n) else 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        recs.append(p24_run(trainer, state, d, steps[i], batches[i])
                    | {"first": True})
        g = {n: t.float().cpu() for n, t in ckpt.full_state(
            {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}, state.model).items()}
        phase = phase_of(cfg, steps[i])
        grads[phase] = g if ref is None else p24_grad_gap(ref[phase], g)
        del g
        for j in range(i + 1, last):
            recs.append(p24_run(trainer, state, d, steps[j], batches[j])
                        | {"first": False})
        peak = max(peak, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        if save_dir and i + P24_STEPS_A_PHASE == len(steps):
            ckpt.save_state(save_dir, state)
            saved = {k: v.cpu() for k, v in
                     ckpt.full_model_state(state.model).items()}
        del trainer, state, model
        gc.collect()
        torch.cuda.empty_cache()
    for r in recs:
        phase = phase_of(cfg, r["step"])
        check(r["launches"] == expected[phase],
              f"step {r['step']} ({phase}): launches {r['launches']}, "
              f"expected {expected[phase]}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"step {r['step']}: non-finite metrics {r['metrics']}")
    return {"recs": recs, "peak_gib": peak, "base_gib": base, "grads": grads,
            "param_bytes": param_bytes, "saved": saved}


def p24_gaps(ref, run):
    """An arm against the bare run ``ref``: the largest relative gap of a
    logged loss term over the first and over the later steps of the
    phases (None where the arm ran no later step), and the smallest
    gradient cosine and worst leaf gap of the first steps."""
    want = {r["step"]: r["metrics"] for r in ref["recs"]}

    def loss(first):
        return max((abs(want[r["step"]][k] - r["metrics"][k])
                    / max(1.0, abs(want[r["step"]][k]))
                    for r in run["recs"] if r["first"] == first
                    for k in P24_LOSSES), default=None)
    return {"first_loss_rel": loss(True), "later_loss_rel": loss(False),
            "grad_cos": min(g[0] for g in run["grads"].values()),
            "grad_leaf_rel": max(g[1] for g in run["grads"].values())}


def p24_within(g, first=P24_FIRST_REL, later=P24_LATER_REL,
               cos=P24_GRAD_COS, leaf=P24_LEAF_REL):
    """``p24_gaps``' reading within the bounds (phase 24's by default)."""
    return (g["first_loss_rel"] <= first
            and (g["later_loss_rel"] is None or g["later_loss_rel"] <= later)
            and g["grad_cos"] >= cos and g["grad_leaf_rel"] <= leaf)


def p24_fmt(g):
    """``p24_gaps``' reading for a log line."""
    return json.dumps({k: None if v is None else float(f"{v:.4g}")
                       for k, v in g.items()})


def p24_gloo_rank(rank, world, port, results, ref_path, expected):
    """A rank of phase 24(b): the two ranks share card 0 and reduce over
    gloo, which copies CUDA tensors through the host."""
    import torch

    from dupl_tpu_torch.engine.train import production_config
    from dupl_tpu_torch.parallel.mesh import init_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    d = init_group(rank, world, dev, backend="gloo",
                   init_method=f"tcp://127.0.0.1:{port}")
    try:
        cfg = production_config("voc")
        ref = torch.load(ref_path, weights_only=False)
        run = p24_arm(dev, cfg, ref["weights"], expected, d,
                      ref=ref["grads"])
        results.put((rank, {"gaps": p24_gaps(ref, run), "recs": run["recs"],
                            "peak_gib": run["peak_gib"],
                            "base_gib": run["base_gib"]}))
    finally:
        d.close()


def phase24(dev, expected):
    """Phase 24, data-parallel and fully-sharded training: (a) the steps of
    ``p24_steps`` at full width through a process group of one over NCCL,
    plain and FSDP, against the bare Trainer; (b) two ranks sharing the card
    over gloo at batch 2 each against one process at batch 4; (c) the
    training tool under ``torchrun``.  Returns (a)'s launches per phase,
    the bare run and the seeded weights (phase 26 holds its ranks to
    them)."""
    import os
    import tempfile

    import torch

    from dupl_tpu_torch.data.voc import write_synthetic_voc
    from dupl_tpu_torch.engine.train import phase_of, production_config
    from dupl_tpu_torch.parallel.dryrun import free_port, spawn_ranks
    from dupl_tpu_torch.parallel.mesh import Dist, init_group

    cfg = production_config("voc")
    steps = p24_steps(cfg)
    weights = p24_weights(cfg, P24_DEPTH)
    bare = p24_arm(dev, cfg, weights, expected, Dist())
    runs, gaps = {"bare": bare}, {}
    for name, group, fsdp in (("data parallel", True, False),
                              ("fsdp", True, True),
                              ("bare again", False, False)):
        d = (init_group(0, 1, dev,
                        init_method=f"tcp://127.0.0.1:{free_port()}")
             if group else Dist())
        try:
            runs[name] = p24_arm(dev, cfg, weights, expected, d, fsdp,
                                 ref=bare["grads"])
        finally:
            d.close()
        gaps[name] = p24_gaps(bare, runs[name])

    def ms(run):
        return [round(r["ms"], 1) for r in run["recs"]]

    def later_ms(run):
        """Per phase, the median ms of the steps after its first."""
        return json.dumps({
            phase_of(cfg, steps[i]): round(statistics.median(
                r["ms"] for r in run["recs"][i + 1:i + P24_STEPS_A_PHASE]), 1)
            for i in range(0, len(steps), P24_STEPS_A_PHASE)})

    print(f"[data parallel, NCCL world 1] production_config('voc'), "
          f"ViT-B/16 dual student at depth {P24_DEPTH} of 12, crop 448, "
          f"batch 4, steps {steps} (each "
          f"phase's from the seeded weights) | ms a step: " + "; ".join(
              f"{n} {ms(r)}" for n, r in runs.items()) + " | median ms of "
          f"a phase's later steps: " + "; ".join(
              f"{n} {later_ms(r)}" for n, r in runs.items()) + " | peak GiB "
          "[of it allocated before the arm] " + json.dumps(
              {n: [round(r["peak_gib"], 3), round(r["base_gib"], 3)]
               for n, r in runs.items()})
          + f" | against the bare Trainer (bounds: first steps' loss terms "
          f"{P24_FIRST_REL}, later steps' {P24_LATER_REL}, first steps' "
          f"gradient cosine {P24_GRAD_COS} and worst leaf {P24_LEAF_REL}): "
          + "; ".join(
              f"{n} {p24_fmt(g)}" for n, g in gaps.items())
          + " | K1-K4 launches a step as phase 12 in every arm", flush=True)
    for name in ("data parallel", "fsdp"):
        check(p24_within(gaps[name]), f"{name} at NCCL world 1 against the "
              f"bare Trainer: {gaps[name]}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) two processes on card 0 over gloo, batch 2 each
        ref_path = os.path.join(tmp, "bare.pt")
        torch.save({"recs": bare["recs"], "grads": bare["grads"],
                    "weights": weights}, ref_path)
        ranks = spawn_ranks(p24_gloo_rank, 2, (ref_path, expected),
                            timeout=900)
        print(f"[data parallel, 2 ranks over gloo on one card] batch 2 a "
              f"rank against one process at batch 4, the same steps | ms a "
              f"step (rank 0) {ms(ranks[0])}, one process {ms(bare)} | median "
              f"of the later steps {later_ms(ranks[0])}, one process "
              f"{later_ms(bare)} | peak GiB a rank [of it allocated before "
              f"the steps] {[[round(r['peak_gib'], 3), round(r['base_gib'], 3)] for r in ranks]} | "
              f"against the bare Trainer (bounds as above) "
              f"{p24_fmt(ranks[0]['gaps'])} | K1-K4 launches a step as phase "
              f"12 on both ranks | FSDP over gloo on CUDA tensors is not run "
              f"(its ranks died with SIGSEGV in a trial under torch 2.11): "
              f"FSDP's multi-rank check stays on the CPU tests", flush=True)
        check(p24_within(ranks[0]["gaps"]),
              f"two gloo ranks against one process: {ranks[0]['gaps']}")

        # (c) the training tool under torchrun: one process, NCCL
        sizes = [(375, 500), (500, 375), (500, 500), (333, 500), (500, 334),
                 (281, 500), (366, 500), (480, 360)]      # phase 22's tree
        root, lists = write_synthetic_voc(os.path.join(tmp, "voc"), sizes,
                                          seed=22, train_sizes=sizes * 5)
        tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tools", "train_torch.py")
        work = os.path.join(tmp, "run")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", tool, "--multihost", "--data-folder",
                root, "--list-folder", lists, "--cam-iters", "1",
                "--gmm-iters", "2", "--eval-iters", "4", "--log-iters", "2",
                "--num-workers", "4", "--sync-debug"]
        times = []
        # guarded by the sync debug mode: steps 0, 2 and 4, then 4 and 6
        # after the resume (the log and eval boundaries are not); each
        # process's first step in a phase among them
        for more in (["--work-dir", work, "--max-iters", "5"],
                     ["--resume", "--max-iters", "7"]):
            if more[0] == "--resume":
                more = more + ["--work-dir", os.path.join(
                    work, os.listdir(work)[0])]
            t = time.perf_counter()
            proc = subprocess.run(argv + more, capture_output=True, text=True,
                                  timeout=600)
            times.append(time.perf_counter() - t)
            check(proc.returncode == 0, f"torchrun train_torch.py {more}: "
                  f"exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}")
        run = os.path.join(work, os.listdir(work)[0])
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(run, "train.log")) as f:
            log = f.read()
        train = [r for r in recs if r["event"] == "train"]
        val = [r for r in recs if r["event"] == "val"]
        done = [r for r in recs if r["event"] == "done"]
        check([(r["step"], r["phase"]) for r in train]
              == [(2, "seg"), (4, "full"), (6, "full")]
              and all(math.isfinite(r[k]) for r in train for k in P24_LOSSES),
              f"torchrun run's train records {train}")
        check([r["step"] for r in val] == [4] and [r["step"] for r in done]
              == [7], f"torchrun run's records {recs}")
        check(log.count("validating at iter") == 1
              and "resumed from step 4" in log and "rank 0 of 1" in log,
              "torchrun run's train.log")
        print(f"[torchrun train_torch.py] --nproc_per_node 1 --multihost "
              f"(NCCL group of one), phase 22's tree, crop 448, batch 4, "
              f"--sync-debug: steps 0-4 with validation and checkpoint at 4, "
              f"then --resume to 7 | {times[0]:.1f} s and {times[1]:.1f} s "
              f"end to end | s/it {[r['s_per_iter'] for r in train]} | val "
              f"{val[0]['val_s']} s, checkpoint {val[0]['ckpt_s']} s | peak "
              f"GiB {[r['peak_gib'] for r in done]}", flush=True)
    return ({name: {phase_of(cfg, r["step"]): r["launches"]
                    for r in runs[name]["recs"]}
             for name in ("data parallel", "fsdp")}, bare, weights)


# Phase 25: the sealed artifacts.  A sealed program runs the live one's
# kernels through the same ops, so its labels are expected bit-equal to the
# live labels on the same card; P25_AGREE is the least share accepted.
# Launches of one call: P25_SERVING a serving dispatch of 8 (K1: 2 students
# x P24_DEPTH blocks x 3 scales), P25_LABELER a pseudo-label call of 16
# (PERF.md section 6, columns S and P, at 12 blocks).
P25_AGREE = 0.999
P25_SERVING = {"exp_attention": 6 * P24_DEPTH, "crf_apply": 1,
               "par_affinity": 0, "par_propagate": 0}
P25_LABELER = {"exp_attention": 6 * P24_DEPTH, "crf_apply": 1,
               "par_affinity": 1, "par_propagate": 10}
P25_ITERS = 5          # dispatches timed back to back (dispatch_ms)


def p25_counters():
    """The launch counters of the kernels a sealed program reaches."""
    from dupl_tpu_torch.ops import attention, crf_cuda, par_cuda

    return {"exp_attention": attention.exp_attention_cuda,
            "crf_apply": crf_cuda.kernel_apply_cuda,
            "par_affinity": par_cuda.affinity_cuda,
            "par_propagate": par_cuda.propagate_cuda}


def p25_calls(program, calls, dev):
    """Run ``program`` on each argument tuple of ``calls`` (numpy arrays):
    -> (outputs as numpy tuples, launches of each call, counted from 0)."""
    import torch

    counters = p25_counters()
    outs, launches = [], []
    for args in calls:
        for c in counters.values():
            c.launches = 0
        out = program(*(torch.from_numpy(a).to(dev) for a in args))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches.append({k: c.launches for k, c in counters.items()})
        out = out if isinstance(out, tuple) else (out,)
        outs.append(tuple(o.cpu().numpy() for o in out))
    return outs, launches


def sealed_child(request: str) -> int:
    """Phase 25's fresh process: load each artifact of the request with
    ``load_artifact``, run its calls (launches counted per call), time the
    serving program's dispatch, and write the outputs and a JSON record."""
    import numpy as np
    import torch

    from dupl_tpu_torch.engine.export import load_artifact
    from dupl_tpu_torch.utils.timing import dispatch_ms

    torch.backends.cuda.matmul.allow_tf32 = False   # as phase 1
    torch.backends.cudnn.allow_tf32 = False
    with open(request) as f:
        jobs = json.load(f)
    record = {}
    for job in jobs:
        dev = torch.device(job["device"])
        t = time.perf_counter()
        program = load_artifact(job["artifact"])[0].module()
        load_s = time.perf_counter() - t
        with np.load(job["inputs"]) as data:
            calls = [tuple(data[f"{i}_{j}"] for j in range(job["nargs"]))
                     for i in range(job["ncalls"])]
        with torch.inference_mode():
            outs, launches = p25_calls(program, calls, dev)
            rec = {"load_s": load_s, "launches": launches}
            if job["time"]:
                x = tuple(torch.from_numpy(a).to(dev) for a in calls[0])
                rec["dispatch_ms"] = dispatch_ms(lambda: program(*x), dev,
                                                 P25_ITERS)
        np.savez(job["outputs"], **{f"{i}_{j}": o for i, out in
                                    enumerate(outs) for j, o in enumerate(out)})
        record[job["name"]] = rec
        del program
        torch.cuda.empty_cache()
    with open(request + ".out.json", "w") as f:
        json.dump(record, f)
    return 0


def phase25(dev, bodies):
    """Phase 25, the sealed artifacts, on ``voc_config()`` (ViT-B/16 at full
    width and depth, seeded weights, crop 448): (a) ``export_serving`` at
    batch 8 (ensemble, CRF), written with ``save_artifact`` and run in a
    fresh process on phase 5's images, against the live ``make_serving_fn``;
    (b) ``export_pseudo_labeler`` at batch 16, one call within the class
    budget and one past it, against the live ``make_pseudo_label_fn``; (c)
    one HTTP round of 8 requests through ``tools/serve_torch.py
    --artifact``.  Returns the launches of a sealed call (serving, labeler)
    and the line's record."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.engine.export import (export_pseudo_labeler,
                                              export_serving,
                                              make_pseudo_label_fn,
                                              make_serving_fn, save_artifact)
    from dupl_tpu_torch.engine.profile import pseudo_label_inputs
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.utils.timing import dispatch_ms

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = voc_config()
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    model = shallow(model, P24_DEPTH).to(dev).eval()
    # phase 5's request images, resized as InferenceSession.predict does
    crop = cfg.data.crop_size
    images = np.stack([np.asarray(Image.open(io.BytesIO(body)).convert(
        "RGB").resize((crop, crop), Image.BILINEAR)) for body, _, _ in bodies])
    serve_calls = [(images[:8],), (images[8:16],)]
    img9, cls9, box9 = pseudo_label_inputs(16, crop, seed=1)
    cls_past = cls9.copy()
    cls_past[3, :12] = 1                  # past the class budget of 10
    label_calls = [(img9, cls9, box9), (img9, cls_past, box9)]

    kw = dict(scales=(1.0, 1.5, 1.25), merge="max", branch="ensemble",
              crf=True)
    serve_fn = make_serving_fn(cfg, model, **kw)
    live_serve, live_serve_n = p25_calls(serve_fn, serve_calls, dev)
    x8 = torch.from_numpy(images[:8]).to(dev)
    live_ms = dispatch_ms(lambda: serve_fn(x8), dev, P25_ITERS)
    del x8
    pl_fn = make_pseudo_label_fn(cfg, model)
    live_label, live_label_n = p25_calls(pl_fn, label_calls, dev)
    for n_ in live_serve_n:
        check(n_ == P25_SERVING, f"live serving launches {n_}")
    for n_ in live_label_n:
        check(n_ == P25_LABELER, f"live pseudo-label launches {n_}")

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for name, export_fn, bsz, calls in (
                ("serving", lambda: export_serving(
                    cfg, model, batch_size=8, device=dev, **kw), 8,
                 serve_calls),
                ("pseudo_label", lambda: export_pseudo_labeler(
                    cfg, model, batch_size=16, device=dev), 16, label_calls)):
            art = os.path.join(tmp, f"{name}.duplsrv")
            t0 = time.perf_counter()
            exported, meta = export_fn()
            t1 = time.perf_counter()
            save_artifact(art, exported, meta)
            t2 = time.perf_counter()
            del exported
            check(meta["batch_size"] == bsz
                  and meta["platforms"] == [dev.type],
                  f"{name} artifact metadata {meta}")
            rec[name] = {"export_s": t1 - t0, "save_s": t2 - t1,
                         "mb": os.path.getsize(art) / 1e6}
            inputs = os.path.join(tmp, f"{name}_in.npz")
            np.savez(inputs, **{f"{i}_{j}": a for i, args in enumerate(calls)
                                for j, a in enumerate(args)})
            jobs.append({"name": name, "artifact": art, "inputs": inputs,
                         "outputs": os.path.join(tmp, f"{name}_out.npz"),
                         "nargs": len(calls[0]), "ncalls": len(calls),
                         "time": name == "serving", "device": str(dev)})
        gc.collect()
        torch.cuda.empty_cache()
        request = os.path.join(tmp, "request.json")
        with open(request, "w") as f:
            json.dump(jobs, f)
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.sealed_child(sys.argv[1]))", request],
            cwd=repo, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"the sealed programs' process failed:\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        with open(request + ".out.json") as f:
            child = json.load(f)
        for job, live, live_n in ((jobs[0], live_serve, live_serve_n),
                                  (jobs[1], live_label, live_label_n)):
            name = job["name"]
            with np.load(job["outputs"]) as data:
                sealed = [tuple(data[f"{i}_{j}"] for j in range(len(out)))
                          for i, out in enumerate(live)]
            shares = [float((s_ == l_).mean()) for s_out, l_out in
                      zip(sealed, live) for s_, l_ in zip(s_out, l_out)]
            check(all(s_.shape == l_.shape and s_.dtype == l_.dtype
                      for s_out, l_out in zip(sealed, live)
                      for s_, l_ in zip(s_out, l_out)),
                  f"{name}: sealed outputs' shapes or types differ")
            check(min(shares) >= P25_AGREE,
                  f"{name}: sealed labels equal to live on {shares}")
            check(child[name]["launches"] == live_n,
                  f"{name}: sealed launches {child[name]['launches']}, live "
                  f"{live_n}")
            rec[name].update(shares=shares, load_s=child[name]["load_s"],
                             launches=child[name]["launches"][0])
        rec["serving"]["sealed_ms"] = child["serving"]["dispatch_ms"]
        rec["serving"]["live_ms"] = live_ms

        # (c) one HTTP round through the daemon serving the artifact
        t0 = time.perf_counter()
        log = open(os.path.join(tmp, "server.log"), "w+")
        server = subprocess.Popen(
            [sys.executable, os.path.join(repo, "tools", "serve_torch.py"),
             "--artifact", jobs[0]["artifact"], "--port", "0",
             "--device", dev.type],
            stdout=subprocess.PIPE, stderr=log, text=True, cwd=repo)
        try:
            line = ""
            while time.perf_counter() - t0 < 600:
                line = server.stdout.readline()
                if "serving on" in line or server.poll() is not None:
                    break
            log.seek(0)
            check("serving on" in line, f"tools/serve_torch.py --artifact "
                  f"never served: {log.read()[-3000:]}")
            start_s = time.perf_counter() - t0
            url = line.split("serving on ")[1].split()[0] + "/v1/segment"

            def post(item):
                body, ctype, hw = item
                req = urllib.request.Request(url, data=body, method="POST",
                                             headers={"Content-Type": ctype,
                                                      "Accept": "application/x-npy"})
                with urllib.request.urlopen(req, timeout=600) as r:
                    return r.status, np.load(io.BytesIO(r.read())), hw

            t1 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                answers = list(pool.map(post, bodies[:8]))
            round_s = time.perf_counter() - t1
            for status, lab, hw in answers:
                check(status == 200 and lab.shape == hw
                      and lab.dtype == np.uint8 and int(lab.max()) <= 20,
                      f"sealed HTTP answer {status} {lab.shape} for {hw}")
            server.terminate()
            check(server.wait(timeout=60) == 0,
                  f"tools/serve_torch.py exited {server.returncode}")
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=30)
            log.close()
        rec["http"] = {"requests": len(answers), "start_s": start_s,
                       "round_s": round_s}
    return rec


# Phase 26: tensor parallelism.  Two ranks share card 0 over gloo as one
# model group (data 1 x model 2; NCCL refuses two ranks on one card), each on
# the whole batch of 4 and its 6 of each block's 12 heads.  In bf16 the model
# group's sums run in another order than the one-device layers', and a
# flipped rounding grows through the blocks: any change of an fp32 sum's last
# bit (even fp32 casts before a product in place of the 16-bit product
# accumulated in fp32) moves the first step's loss terms by up to ~1e-3 and a
# norm weight's gradient by 8-11%.  Three references hold the ranks: (1) the
# bare Trainer computing as the model group does, products and sums as its
# ranks' (``p26_split_model``, plain PyTorch), at phase 24's bounds; (2) the
# plain bare run of phase 24 at the looser P26_BARE_* bounds, set between
# what sound runs read there (first-step loss terms 1.43e-3, gradient cosine
# 0.9986, worst leaf 9.8%; in fp32 3.95e-4, 0.9996, 4.8%) and what planted
# faults read (``P26_FAULTS``, run each time: the bounds must catch them;
# loss 4.5e-2, cosine 0.50, leaf 230%; cosine 0.82, leaf 96%); beside it a
# one-process order witness (``p26_split_model(fp32_casts=True)``, no
# collective) reads the size of the ranks' gap; (3) each phase's first step
# in fp32 (``p26_fp32``) against the bare Trainer in fp32, at (2)'s bounds.
# The ranks' fp32-accumulated 16-bit products (``tensor_parallel._mm_fp32``,
# whose branch for 16-bit CUDA tensors only the card runs) are held to fp32
# casts' products at the layers' shapes (``P26_MM_REL`` of the sum of the
# terms' magnitudes).  K1 and K2 are then held to their twins on a rank's own
# block-0 operands at phases 3 and 11's bounds (row ulps: K1 1 at the maximum
# and 1e-3 on average, K2 2 and 0.01).
# After their steps the two ranks run the int8 CAM stage (``p26_int8``):
# bench_config's int8 model at ViT-B/16 width, depth P24_DEPTH, sharded over
# the model group, whose row-parallel products all-reduce their maxima and
# then their exact int32 sums over gloo (which copies the CUDA tensors
# through the host), so that its CAMs, aux CAMs and class scores equal the
# parent's one-process run bit for bit; its seg, whose decoder convolutions
# sum bf16 products' fp32 partials over the ranks, within P26_INT8_SEG (max,
# mean of the output's largest magnitude: tests/test_torch_quant.py's bf16
# INT8_REL).  A rank's launches: each of its P26_INT8_FORWARDS encoder
# passes runs, a block, quantize_pair and int8_linear for qkv and fc1 and
# row_absmax_pair, quantize_pair_given, int8_matmul_i32 and int8_rescale
# for proj and fc2 (two collectives each), K1 once.
P26_INT8_BATCH = 2
P26_INT8_FORWARDS = 8    # cam_only of 2 students + 3 scales x 2 students
P26_INT8_SEG = (5e-2, 1e-2)
P26_N_MODEL = 2
P26_BARE_FIRST_REL, P26_BARE_LATER_REL = 1e-2, 5e-2
P26_BARE_GRAD_COS, P26_BARE_LEAF_REL = 0.99, 0.3
P26_FAULTS = ("forward", "backward")
P26_MM_REL = 1e-5
K1_ULPS, K2_ULPS = (1.0, 1e-3), (2.0, 0.01)


def p26_fp32(cfg):
    """``cfg`` with every product and residual stream in fp32."""
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", stream_dtype="float32",
        cam_stream_dtype="float32"))


def p26_split_model(model, n=P26_N_MODEL, fault=None, fp32_casts=False):
    """Make a plain ``DualStudent`` compute as a model group of ``n`` ranks
    does, in one process: each column-parallel layer (qkv by head, fc1,
    conv6) as ``n`` products on the shares of its weight, its input
    gradient as the fp32 sum of the shares' partials rounded once; each
    row-parallel layer (proj, fc2, conv7) as the fp32 sum of the shares'
    partial products, rounded once; sums in rank order.  Plain PyTorch of
    its own (``torch.chunk`` shares; a 16-bit linear partial accumulated
    in fp32 by ``torch.mm(out_dtype=float32)``, as the ranks' are, or with
    ``fp32_casts`` as the product of the fp32 casts; convolutions' partials
    on fp32 casts): of the port's tensor parallelism it reads only the
    layout (``tensor_parallel.spec_of`` / ``role_of``: which layer splits
    along which dim, in how many blocks), not its arithmetic.  ``fault``
    plants one, to show what the bounds catch: "forward" keeps only the
    first share's partial product of each row-parallel layer (its forward
    sum left out), "backward" only the first share's partial input
    gradient of each column-parallel layer (its backward sum left out).
    Overrides the layers' forward; returns ``model``."""
    import torch
    import torch.nn.functional as F

    from dupl_tpu_torch.parallel.tensor_parallel import role_of, spec_of

    def mm32(a, b):
        """``a @ b`` of two 2-d tensors of one dtype, in fp32."""
        if fp32_casts or a.dtype == torch.float32:
            return a.float() @ b.float()
        return torch.mm(a, b, out_dtype=torch.float32)

    def shares(t, dim, blocks=1):
        """The ranks' shares of ``t`` along ``dim``: the r-th of ``n`` equal
        parts of each of its ``blocks`` equal blocks."""
        parts = [b.chunk(n, dim) for b in t.chunk(blocks, dim)]
        return [torch.cat([p[r] for p in parts], dim) for r in range(n)]

    def joined(ys, dim, blocks=1):
        """The full tensor from the ranks' shares (``shares``' inverse)."""
        per = [y.chunk(blocks, dim) for y in ys]
        return torch.cat([per[r][b] for b in range(blocks)
                          for r in range(n)], dim)

    def summed(parts, dropped):
        """fp32 partials summed in rank order; the first alone where the
        planted fault leaves the sum out."""
        if dropped:
            return parts[0]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    class SplitColumn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, conv, blocks):
            xc = x.to(w.dtype)
            ctx.save_for_backward(xc, w)
            ctx.conv, ctx.blocks, ctx.x_dtype = conv, blocks, x.dtype
            ys = [F.conv2d(xc, wr, **conv) if conv else F.linear(xc, wr)
                  for wr in shares(w, 0, blocks)]
            return joined(ys, 1 if conv else -1, blocks)

        @staticmethod
        def backward(ctx, g):
            xc, w = ctx.saved_tensors
            conv, blocks = ctx.conv, ctx.blocks
            gs = shares(g, 1 if conv else -1, blocks)
            ws = shares(w, 0, blocks)
            if conv:
                parts = [torch.nn.grad.conv2d_input(
                    xc.shape, wr.float(), gr.float(), **conv)
                    for gr, wr in zip(gs, ws)]
                gw = [torch.nn.grad.conv2d_weight(xc, wr.shape, gr, **conv)
                      for gr, wr in zip(gs, ws)]
            else:
                parts = [mm32(flat(gr), wr).reshape(xc.shape)
                         for gr, wr in zip(gs, ws)]
                gw = [flat(gr).t() @ flat(xc) for gr in gs]
            gx = summed(parts, fault == "backward")
            return (gx.to(w.dtype).to(ctx.x_dtype), joined(gw, 0, blocks),
                    None, None)

    class SplitRow(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, conv):
            ctx.save_for_backward(x, w)
            ctx.conv = conv
            xs, ws = shares(x, 1 if conv else -1), shares(w, 1)
            parts = [F.conv2d(xr.float(), wr.float(), **conv) if conv else
                     mm32(flat(xr), wr.t()) for xr, wr in zip(xs, ws)]
            y = summed(parts, fault == "forward")
            if not conv:
                y = y.reshape(*x.shape[:-1], w.shape[0])
            return y.to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            conv = ctx.conv
            xs, ws = shares(x, 1 if conv else -1), shares(w, 1)
            if conv:
                gx = [torch.nn.grad.conv2d_input(xr.shape, wr, g, **conv)
                      for xr, wr in zip(xs, ws)]
                gw = [torch.nn.grad.conv2d_weight(xr, wr.shape, g, **conv)
                      for xr, wr in zip(xs, ws)]
                return joined(gx, 1), joined(gw, 1), None
            gx = [(flat(g) @ wr).reshape(xr.shape) for xr, wr in zip(xs, ws)]
            gw = [flat(g).t() @ flat(xr) for xr in xs]
            return joined(gx, -1), joined(gw, 1), None

    def split(x, w, conv, role, blocks):
        if role == "column":
            return SplitColumn.apply(x, w, conv, blocks)
        return SplitRow.apply(x.to(w.dtype), w, conv)

    def linear(m, role, blocks):
        def forward(x):
            y = split(x, m.weight.to(m.compute_dtype), None, role, blocks)
            return y + m.bias.to(y.dtype)
        m.forward = forward

    def decoder(m, layers):
        plain = m._conv

        def conv_(conv, x):
            if conv not in layers:
                return plain(conv, x)
            kw = {"padding": conv.padding, "dilation": conv.dilation}
            return split(x, conv.weight.to(m.compute_dtype), kw,
                         *layers[conv])
        m._conv = conv_

    convs = {}
    for name, m in model.named_modules():
        role = role_of(name)
        if role is None:
            continue
        blocks = spec_of(name + ".weight")[1]
        if isinstance(m, torch.nn.Conv2d):
            convs.setdefault(name.rsplit(".", 1)[0], {})[m] = (role, blocks)
        else:
            linear(m, role, blocks)
    for name, layers in convs.items():
        decoder(model.get_submodule(name), layers)
    return model


def p26_mm_check(dev):
    """``tensor_parallel._mm_fp32`` on bf16 CUDA tensors (its branch that
    only the card runs) against the product of their fp32 casts, at the
    shapes of a rank's linear partials in a training step (4 x 785 tokens,
    ViT-B/16 at TP 2): per product the largest |difference| over the sum of
    the terms' magnitudes (``|a| @ |b|``)."""
    import torch

    from dupl_tpu_torch.parallel import tensor_parallel

    m, c, n = 4 * 785, 768, P26_N_MODEL
    shapes = {"proj": c // n, "fc2": 4 * c // n, "qkv input gradient":
              3 * c // n, "fc1 input gradient": 4 * c // n}   # inner dims
    gen = torch.Generator(device=dev).manual_seed(26)
    out = {}
    for name, k in shapes.items():
        a = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        b = torch.randn(k, c, device=dev, generator=gen).bfloat16()
        got = tensor_parallel._mm_fp32(a, b)
        check(got.dtype == torch.float32, f"_mm_fp32 gave {got.dtype}")
        want = a.float() @ b.float()
        out[name] = float(((got - want).abs()
                           / (a.float().abs() @ b.float().abs())).max())
    return out


P26_INT8_COUNTERS = ("quantize_pair", "gelu_quantize_pair", "int8_linear",
                     "row_absmax_pair", "quantize_pair_given",
                     "int8_matmul_i32", "int8_rescale", "exp_attention",
                     "gelu_erf")


def p26_int8(dev, weights, d=None):
    """The int8 CAM stage at ViT-B/16 width and depth P24_DEPTH
    (``bench_config("voc", quantized_inference=True)``, ``weights`` of
    phase 24): ``cam_only`` and each student's
    ``multi_scale_cam_with_outputs`` at the recipe's scales on
    P26_INT8_BATCH seeded images of 448^2, twice (the second run is read
    and timed); with ``d`` the model sharded over its model group.  Returns
    the outputs on the host, the launches of the second run (the counts
    zeroed just before it) and its ms."""
    import torch

    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import attention, gelu, quant
    from dupl_tpu_torch.ops import cam as cam_ops
    from dupl_tpu_torch.parallel import tensor_parallel

    cfg = bench_config("voc", quantized_inference=True)
    with torch.device("meta"):
        model = shallow(DualStudent(cfg.model), P24_DEPTH)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights)
    model.eval()
    if d is not None:
        tensor_parallel.shard_model(model, d)
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(P26_INT8_BATCH, 448, 448, 3, generator=g, device=dev)
    home = {"exp_attention": attention, "gelu_erf": gelu}
    counters = {name: getattr(home.get(name, quant), f"{name}_cuda")
                for name in P26_INT8_COUNTERS}

    def run():
        with torch.no_grad():
            cam, cam_aux = model.cam_only(x)
            msc = [cam_ops.multi_scale_cam_with_outputs(
                s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                merge_size=(224, 224)) for s in (model.branch1, model.branch2)]
        return {"cam": cam, "cam_aux": cam_aux,
                "msc_cam": torch.stack([m[0] for m in msc]),
                "msc_aux": torch.stack([m[1] for m in msc]),
                "cls": torch.stack([m[2].cls for m in msc]),
                "seg": torch.stack([m[2].seg for m in msc])}

    run()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t = time.perf_counter()
    with twin_guard() as twin_calls:
        out = run()
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    check(not twin_calls, f"the int8 CAM stage ran plain twins on CUDA "
          f"tensors: {twin_calls}")
    launches = {k: f.launches for k, f in counters.items()}
    del model
    return {k: v.float().cpu() for k, v in out.items()}, launches, ms


def p26_int8_expected(tp: bool):
    """:func:`p26_int8`'s launches, one process or a rank of the model
    group."""
    n = P26_INT8_FORWARDS * P24_DEPTH
    row = {"row_absmax_pair": 2 * n, "quantize_pair_given": 2 * n,
           "int8_matmul_i32": 2 * n, "int8_rescale": 2 * n}
    return {"quantize_pair": (2 if tp else 3) * n,
            "gelu_quantize_pair": 0 if tp else n,
            "int8_linear": (2 if tp else 4) * n,
            **{k: (v if tp else 0) for k, v in row.items()},
            "exp_attention": n, "gelu_erf": 0}


def p26_int8_gaps(ref, got):
    """Elements unequal to the one-process run, a key each, and seg's gap
    (max, mean) over its largest magnitude."""
    import torch

    unequal = {k: int((got[k] != ref[k]).sum()) for k in ref if k != "seg"}
    gap = (got["seg"] - ref["seg"]).abs() / ref["seg"].abs().max()
    return unequal, [float(gap.max()), float(gap.mean())], bool(
        torch.isfinite(got["cam"]).all())


def p26_collectives(dev, d):
    """gloo's all-reduce on CUDA tensors over the model group, as the int8
    products run it: MAX on fp32, SUM on int32 (values that fill its
    range); whether both gave the right values on the card."""
    import torch
    import torch.distributed as dist

    r = d.model_rank
    mx = torch.tensor([1.5 * r, -float(r), 2.0], device=dev)
    sm = torch.tensor([r + 1, -(1 << 30), 7], dtype=torch.int32, device=dev)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=d.model_group)
    dist.all_reduce(sm, group=d.model_group)
    return (mx.is_cuda and sm.is_cuda and sm.dtype == torch.int32
            and mx.tolist() == [1.5, 0.0, 2.0]
            and sm.tolist() == [3, -(1 << 31), 14])


def p26_kernels(grabbed):
    """K1 and K2 on a rank's own operands (its block-0 q, k and v of the
    first differentiated pass, k and v strided views of its local qkv, and
    the cotangent autograd handed K2 there) against their twins: row-ulp
    errors, the largest absolute error, and the operands' shape and row
    stride."""
    import torch

    from dupl_tpu_torch.ops import attention

    q, k, v, g = (grabbed[x] for x in "qkvg")
    check(not k.is_contiguous() and not v.is_contiguous(),
          "phase 26: k and v should be strided views of the local qkv")
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=torch.bfloat16).item()
    qs = q.to(torch.bfloat16) * scale        # as attention.exp_attention
    ops = tuple(attention._to_bhnd(x) for x in (qs, k, v))
    got = attention.exp_attention_cuda(qs, k, v)
    want = attention.exp_attention_ref(*ops).to(torch.bfloat16)
    k1 = row_ulps(attention._to_bhnd(got), want)
    k1_err = (attention._to_bhnd(got).float() - want.float()).abs().max()
    gb = g.to(torch.bfloat16).contiguous()
    got2 = attention.exp_attention_bwd_cuda(qs, k, v, gb)
    want2 = attention.exp_attention_bwd_ref(*ops, attention._to_bhnd(gb))
    k2 = bwd_ulps(got2, want2)
    k2_err = max((attention._to_bhnd(x).float() - w.float()).abs().max()
                 for x, w in zip(got2, want2))
    torch.cuda.synchronize()
    return {"shape": list(q.shape), "row_stride": k.stride(1),
            "k1_ulps": list(k1), "k2_ulps": list(k2),
            "k1_err": float(k1_err), "k2_err": float(k2_err)}


def p26_rank(rank, world, port, results, ref_path, expected, ckpt_dir):
    """A rank of phase 26: one of the model group's two ranks on card 0,
    reducing over gloo (which copies CUDA tensors through the host): phase
    24's steps in bf16, then each phase's first step in fp32."""
    import torch

    from dupl_tpu_torch.engine.train import production_config
    from dupl_tpu_torch.models import vit
    from dupl_tpu_torch.ops import attention, par_cuda
    from dupl_tpu_torch.parallel.mesh import init_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    d = init_group(rank, world, dev, backend="gloo",
                   init_method=f"tcp://127.0.0.1:{port}", n_model=P26_N_MODEL)
    plain = vit.dot_attention
    grabbed, twin_calls = {}, []
    shape = (4, 785, 12 // P26_N_MODEL, 64)

    def grab(q, k, v, *, scale):
        out = plain(q, k, v, scale=scale)
        if not grabbed and tuple(q.shape) == shape and out.requires_grad:
            grabbed.update(q=q.detach(), k=k.detach(), v=v.detach())
            out.register_hook(lambda g: grabbed.setdefault("g", g.detach()))
        return out

    twins = [(attention, "exp_attention_ref"),
             (attention, "exp_attention_bwd_ref"),
             (par_cuda, "affinity_ref"), (par_cuda, "propagate_ref")]
    originals = [(m, n, getattr(m, n)) for m, n in twins]

    def counting(name, fn):
        def wrapped(*a, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                twin_calls.append(name)
            return fn(*a, **kw)
        return wrapped

    try:
        cfg = production_config("voc")
        ref = torch.load(ref_path, weights_only=False)
        vit.dot_attention = grab
        for m, n, fn in originals:
            setattr(m, n, counting(n, fn))
        try:
            run = p24_arm(dev, cfg, ref["weights"], expected, d,
                          save_dir=ckpt_dir)
            run32 = p24_arm(dev, p26_fp32(cfg), ref["weights"], expected, d,
                            ref=ref["bare32"]["grads"], per_phase=1)
        finally:
            vit.dot_attention = plain
            for m, n, fn in originals:
                setattr(m, n, fn)
        check(not twin_calls, f"rank {rank}: plain twins ran on CUDA "
              f"tensors: {twin_calls}")
        check(len(grabbed) == 4, f"rank {rank}: no block-0 operands of "
              f"shape {shape} with a cotangent")
        kern = p26_kernels(grabbed)
        # the int8 CAM stage, sharded, against the parent's one process
        collectives_ok = p26_collectives(dev, d)
        int8_out, int8_launches, int8_ms = p26_int8(dev, ref["weights"], d)
        unequal, seg_gap, finite = p26_int8_gaps(ref["int8"], int8_out)
        del int8_out
        if rank == 0:     # through a file: a queue would share 0.7 GB
            torch.save(run["saved"], ckpt_dir + ".gathered.pt")
        gaps, grad_gaps = {}, {}
        for name in ("split", "bare"):    # the references (phase26)
            grad_gaps[name] = {ph: p24_grad_gap(ref[name]["grads"][ph], g)
                               for ph, g in run["grads"].items()}
            gaps[name] = p24_gaps(ref[name], {"recs": run["recs"],
                                              "grads": grad_gaps[name]})
        gaps["bare32"] = p24_gaps(ref["bare32"], run32)
        grad_gaps["bare32"] = run32["grads"]
        results.put((rank, {
            "gaps": gaps, "recs": run["recs"], "recs32": run32["recs"],
            "grad_gaps": grad_gaps, "peak_gib": run["peak_gib"],
            "base_gib": run["base_gib"], "param_bytes": run["param_bytes"],
            "kernels": kern, "int8": {
                "unequal": unequal, "seg_gap": seg_gap, "finite": finite,
                "launches": int8_launches, "ms": int8_ms,
                "collectives_ok": collectives_ok}}))
    finally:
        d.close()


def phase26(dev, expected, bare, weights):
    """Phase 26, tensor parallelism at full width on the one card: (a) two
    ranks as one model group over gloo, phase 24's steps, each held to the
    bare Trainer computing as the model group does (``p26_split_model``,
    one process) at phase 24's bounds and to the plain bare run ``bare``
    (phase 24's, from ``weights``) at the ``P26_BARE_*`` bounds, which must
    catch each of ``P26_FAULTS``, beside the order witness; each phase's
    first step in fp32 against the bare Trainer in fp32 at those bounds;
    ``_mm_fp32``'s card branch against fp32 casts; K1 and K2 on each rank's
    own operands; (b) the run's checkpoint restored into the bare Trainer
    equals its gathered weights bit for bit; (c) ms a step, peak memory
    and parameter bytes beside the bare run's.  Returns a rank's launches
    per phase and K1's and K2's largest errors."""
    import functools
    import os
    import tempfile

    import torch

    from dupl_tpu_torch.engine import checkpoint as ckpt
    from dupl_tpu_torch.engine.train import Trainer, phase_of, production_config
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.parallel.dryrun import spawn_ranks
    from dupl_tpu_torch.parallel.mesh import Dist

    cfg = production_config("voc")
    t26 = time.perf_counter()
    mm = p26_mm_check(dev)
    split = p24_arm(dev, cfg, weights, expected, Dist(),
                    prepare=p26_split_model)
    split_gaps = {ph: p24_grad_gap(bare["grads"][ph], g)
                  for ph, g in split["grads"].items()}

    def one_step(**split_kw):
        """The full phase's first step of the split model against the
        plain bare run."""
        return p24_gaps(bare, p24_arm(
            dev, cfg, weights, expected, Dist(), ref=bare["grads"],
            per_phase=1, phases=("full",), prepare=functools.partial(
                p26_split_model, **split_kw)))
    witness = one_step(fp32_casts=True)
    faults = {f: one_step(fault=f) for f in P26_FAULTS}
    bare32 = p24_arm(dev, p26_fp32(cfg), weights, expected, Dist(),
                     per_phase=1)
    int8_one, int8_launches, int8_ms = p26_int8(dev, weights)
    check(int8_launches == p26_int8_expected(False),
          f"phase 26: the one-process int8 CAM stage's launches "
          f"{int8_launches}, want {p26_int8_expected(False)}")
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "refs.pt")
        torch.save({name: {"recs": run["recs"], "grads": run["grads"]}
                    for name, run in (("bare", bare), ("split", split),
                                      ("bare32", bare32))}
                   | {"weights": weights, "int8": int8_one}, ref_path)
        del split["grads"], bare32["grads"]
        ckpt_dir = os.path.join(tmp, "ckpt")
        ranks = spawn_ranks(p26_rank, P26_N_MODEL,
                            (ref_path, expected, ckpt_dir), timeout=900)
        # (b) the TP run's checkpoint in the bare Trainer, on the card
        with torch.device("meta"):
            model = shallow(DualStudent(cfg.model), P24_DEPTH)
        model = model.to_empty(device=dev)
        model.load_state_dict(weights)
        state = Trainer(cfg, model=model, device=dev).init_state(init=False)
        state = ckpt.restore_state(ckpt_dir, state)
        restored = state.model.state_dict()
        saved = torch.load(ckpt_dir + ".gathered.pt", weights_only=True)
        check(restored.keys() == saved.keys() and all(
            torch.equal(restored[k].cpu(), v) for k, v in saved.items()),
            "phase 26: the TP checkpoint restored into the bare Trainer "
            "differs from the TP run's gathered weights")
        step_restored = state.step
        del model, state, restored, saved
        gc.collect()
        torch.cuda.empty_cache()
    share = [res["param_bytes"]["tp_leaves"] / bare["param_bytes"]["tp_leaves"]
             for res in ranks]
    steps = p24_steps(cfg)

    def ms(run):
        return [round(r["ms"], 1) for r in run["recs"]]

    def later_ms(run):
        return json.dumps({
            phase_of(cfg, steps[i]): round(statistics.median(
                r["ms"] for r in run["recs"][i + 1:i + P24_STEPS_A_PHASE]), 1)
            for i in range(0, len(steps), P24_STEPS_A_PHASE)})

    def terms(run):
        """Each step's loss terms, for the record."""
        return [{k: round(r["metrics"][k], 5) for k in P24_LOSSES}
                for r in run["recs"]]

    gib = 2 ** 30
    print(f"[tensor parallel, 2 ranks over gloo on one card] "
          f"production_config('voc'), ViT-B/16 dual student at depth "
          f"{P24_DEPTH} of 12, crop 448, data "
          f"1 x model {P26_N_MODEL} (6 of 12 heads a rank), the whole batch "
          f"of 4 on each rank, steps {steps} | ms a step: rank 0 "
          f"{ms(ranks[0])}, rank 1 {ms(ranks[1])}, bare {ms(bare)} | median "
          f"of the later steps: rank 0 {later_ms(ranks[0])}, bare "
          f"{later_ms(bare)} | peak GiB [of it allocated before the steps] "
          f"ranks {[[round(x['peak_gib'], 3), round(x['base_gib'], 3)] for x in ranks]}, "
          f"bare {[round(bare['peak_gib'], 3), round(bare['base_gib'], 3)]} "
          f"| parameter GiB a rank: all "
          f"{[round(x['param_bytes']['all'] / gib, 4) for x in ranks]}, "
          f"tensor-parallel leaves "
          f"{[round(x['param_bytes']['tp_leaves'] / gib, 4) for x in ranks]}"
          f" (bare {round(bare['param_bytes']['all'] / gib, 4)} and "
          f"{round(bare['param_bytes']['tp_leaves'] / gib, 4)}; share "
          f"{share}) | K1-K4 launches a step as phase 12 on both ranks, no "
          f"twin on a CUDA tensor, the ranks' logged metrics equal", flush=True)

    def per_phase(g):
        return json.dumps({ph: [round(x[0], 6), round(x[1], 5), x[2]]
                           for ph, x in g.items()})

    def by_rank(name):
        return "; ".join(f"rank {r} {p24_fmt(x['gaps'][name])}"
                         for r, x in enumerate(ranks))

    print(f"[tensor parallel against one process] on the gradient gathered "
          f"to the one-device layout | (1) against the bare Trainer "
          f"computing as the model group does (p26_split_model; bounds as "
          f"phase 24: first steps' loss terms {P24_FIRST_REL}, later steps' "
          f"{P24_LATER_REL}, gradient cosine {P24_GRAD_COS}, worst leaf "
          f"{P24_LEAF_REL}): {by_rank('split')} | (2) against the plain bare "
          f"run (phase 24's; bounds {P26_BARE_FIRST_REL}, "
          f"{P26_BARE_LATER_REL}, {P26_BARE_GRAD_COS}, {P26_BARE_LEAF_REL}): "
          f"{by_rank('bare')}; the one-process split against it "
          f"{p24_fmt(p24_gaps(bare, {'recs': split['recs'], 'grads': split_gaps}))}"
          f"; the full phase's first step against it of the order witness "
          f"(the split on fp32 casts' products) {p24_fmt(witness)} and of "
          f"the planted faults (outside the bounds): " + "; ".join(
              f"{f} sum left out {p24_fmt(g)}" for f, g in faults.items())
          + f" | (3) fp32, each phase's first step, against the bare Trainer "
          f"in fp32 (bounds as (2)): {by_rank('bare32')} | _mm_fp32 on bf16 "
          f"against fp32 casts, largest |difference| over the terms' "
          f"magnitudes (bound {P26_MM_REL}): {json.dumps(mm)} | per phase "
          f"(cosine, worst leaf, its name): rank 0 against the split "
          f"{per_phase(ranks[0]['grad_gaps']['split'])}, against the bare "
          f"{per_phase(ranks[0]['grad_gaps']['bare'])}, fp32 "
          f"{per_phase(ranks[0]['grad_gaps']['bare32'])}; split against bare "
          f"{per_phase(split_gaps)} | loss terms a step: bare "
          f"{json.dumps(terms(bare))}; split {json.dumps(terms(split))}; "
          f"rank 0 {json.dumps(terms(ranks[0]))}", flush=True)
    print(f"[tensor parallel kernels] K1 and K2 on each rank's own block-0 "
          f"operands, (B, N, H, D) {ranks[0]['kernels']['shape']}, k and v "
          f"at row stride {ranks[0]['kernels']['row_stride']} | " + "; ".join(
              f"rank {r}: K1 row ulps {x['kernels']['k1_ulps']} (bounds "
              f"{list(K1_ULPS)}), max_abs_err {x['kernels']['k1_err']:.4g}; "
              f"K2 {x['kernels']['k2_ulps']} (bounds {list(K2_ULPS)}), "
              f"max_abs_err {x['kernels']['k2_err']:.4g}"
              for r, x in enumerate(ranks))
          + f" | checkpoint of step {step_restored} restored into the bare "
          f"Trainer equals the gathered weights bit for bit | phase 26 took "
          f"{time.perf_counter() - t26:.1f} s", flush=True)
    i8 = [x["int8"] for x in ranks]
    print(f"[tensor parallel int8] bench_config's int8 model (tanh GELU, bf16 "
          f"stream), ViT-B/16 at depth {P24_DEPTH}, {P26_INT8_BATCH} images "
          f"of 448^2: cam_only and both students' multi_scale_cam_with_outputs "
          f"(1.0 / 0.5 / 1.5 x flip) on the two ranks, each row-parallel "
          f"product's maxima (fp32, MAX) and int32 sums (SUM) all-reduced "
          f"over gloo, which copies the CUDA tensors through the host "
          f"(both checked on the card: {[x['collectives_ok'] for x in i8]}) "
          f"| elements unequal to the parent's one-process run (bound 0): "
          + "; ".join(f"rank {r} {json.dumps(x['unequal'])}"
                      for r, x in enumerate(i8))
          + f" | seg gap (max, mean of its largest magnitude; bound "
          f"{list(P26_INT8_SEG)}) {[x['seg_gap'] for x in i8]} | launches a "
          f"rank {json.dumps(i8[0]['launches'])}, one process "
          f"{json.dumps(int8_launches)} | ms (the second run) one process "
          f"{int8_ms:.1f}, ranks {[round(x['ms'], 1) for x in i8]}",
          flush=True)
    want_tp = p26_int8_expected(True)
    for r, x in enumerate(i8):
        check(x["collectives_ok"], f"TP rank {r}: gloo's MAX on fp32 or SUM "
              f"on int32 CUDA tensors gave wrong values")
        check(x["finite"] and all(v == 0 for v in x["unequal"].values()),
              f"TP rank {r}: the int8 CAM stage differs from one process "
              f"{x['unequal']}")
        check(x["seg_gap"][0] <= P26_INT8_SEG[0]
              and x["seg_gap"][1] <= P26_INT8_SEG[1],
              f"TP rank {r}: int8 seg gap {x['seg_gap']}")
        check(x["launches"] == want_tp, f"TP rank {r}: int8 launches "
              f"{x['launches']}, want {want_tp}")
    loose = dict(first=P26_BARE_FIRST_REL, later=P26_BARE_LATER_REL,
                 cos=P26_BARE_GRAD_COS, leaf=P26_BARE_LEAF_REL)
    for f, g in faults.items():
        check(not p24_within(g, **loose), f"phase 26: the bounds against the "
              f"plain bare run miss the planted fault '{f}': {g}")
    check(p24_within(witness, **loose), f"phase 26: the order witness "
          f"against the plain bare run: {witness}")
    check(all(v <= P26_MM_REL for v in mm.values()),
          f"phase 26: _mm_fp32 against fp32 casts: {mm}")
    for r, res in enumerate(ranks):
        for name, bounds in (("split", {}), ("bare", loose),
                             ("bare32", loose)):
            check(p24_within(res["gaps"][name], **bounds),
                  f"TP rank {r} against {name}: {res['gaps'][name]}")
        kern = res["kernels"]
        check(kern["k1_ulps"][0] <= K1_ULPS[0]
              and kern["k1_ulps"][1] <= K1_ULPS[1],
              f"TP rank {r}: K1 on its own operands {kern}")
        check(kern["k2_ulps"][0] <= K2_ULPS[0]
              and kern["k2_ulps"][1] <= K2_ULPS[1],
              f"TP rank {r}: K2 on its own operands {kern}")
    check(all(a["metrics"] == b["metrics"] for key in ("recs", "recs32")
              for a, b in zip(ranks[0][key], ranks[1][key])),
          "phase 26: the two ranks of the model group logged different "
          "metrics (their replicated activations differ)")
    check(all(abs(x - 1 / P26_N_MODEL) < 1e-9 for x in share),
          f"phase 26: a rank's share of the tensor-parallel leaves' bytes "
          f"{share}")
    return ({phase_of(cfg, r["step"]): r["launches"]
             for r in ranks[0]["recs"]},
            max(x["kernels"]["k1_err"] for x in ranks),
            max(x["kernels"]["k2_err"] for x in ranks), i8[0]["launches"])


@contextlib.contextmanager
def fp32_gelu_calls():
    """Within: the calls of the encoder's GELUs (``models/vit.py``'s
    ``gelu_tanh`` and ``gelu_erf``), counted by input dtype in the dict
    yielded; an int8 ``Mlp`` takes its GELU inside fc2's quantization and
    makes none."""
    from collections import Counter

    from dupl_tpu_torch.models import vit

    calls = Counter()
    originals = vit.gelu_tanh, vit.gelu_erf

    def counting(fn):
        def wrapped(x):
            calls[str(x.dtype).removeprefix("torch.")] += 1
            return fn(x)
        return wrapped

    vit.gelu_tanh, vit.gelu_erf = map(counting, originals)
    try:
        yield calls
    finally:
        vit.gelu_tanh, vit.gelu_erf = originals


@contextlib.contextmanager
def twin_guard():
    """Within: the plain twins of the kernels note each call that is handed
    a CUDA tensor (a twin must never see one) in the list yielded."""
    import torch

    from dupl_tpu_torch.ops import attention, crf_cuda, gelu, par_cuda, quant

    calls = []
    twins = [(attention, "exp_attention_ref"),
             (attention, "exp_attention_bwd_ref"),
             (attention, "flash_attention_ref"),
             (attention, "flash_attention_bwd_ref"),
             (par_cuda, "affinity_ref"), (par_cuda, "propagate_ref"),
             (crf_cuda, "kernel_apply_ref"), (gelu, "gelu_erf_ref"),
             (gelu, "gelu_erf_bwd_ref"), (quant, "quantize_rows_ref"),
             (quant, "quantize_pair_ref"), (quant, "gelu_quantize_pair_ref"),
             (quant, "int8_linear_ref"), (quant, "row_absmax_pair_ref"),
             (quant, "quantize_pair_given_ref"),
             (quant, "int8_matmul_i32_ref"), (quant, "int8_rescale_ref")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in twins]

    def counting(name, fn):
        def wrapped(*a, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for mod, name, fn in originals:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def shallow(model, depth):
    """The first ``depth`` blocks of each student's encoder."""
    import dataclasses

    for i in range(2):
        enc = model.student(i).encoder
        enc.blocks = enc.blocks[:depth]
        enc.spec = dataclasses.replace(enc.spec, depth=depth)
    return model


# Phase 27: the run operations.  (a) The training run's CAM-grid pass at a
# log boundary: one no-grad multi-scale CAM pass of both students, scales
# 1.0 / 0.5 / 1.5 each with its flip in one batch of 2B, 12 blocks: K1 72
# times (785, 197 and 1765 tokens), nothing else.
P27_GRID_LAUNCHES = {"exp_attention": 72, "exp_attention_bwd": 0,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "par_affinity": 0, "par_propagate": 0}


def phase27(dev, smi, flops768):
    """The run operations of ``tools/train_torch.py`` and
    ``tools/bench_train_torch.py`` at full width: (a) ``utils/tb.cam_grids``
    on a uint8 batch of 4 at crop 448; (b) ``utils/flops.count_flops`` of
    one step a phase (crop 448, batch 1), at depth 2, on the card and on
    the CPU, and ``flops768``, phase 17's counts of its warm-up
    ``grad_step`` at crop 768 on both sides (side -> (FLOPs, launches)):
    the counts must be equal; (c) the train bench's MFU line of each phase
    at full depth.  Returns K1's launches in (a)."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import bench_train_torch

    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import (Trainer, phase_start,
                                             production_config)
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import attention, augment, par_cuda
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils.tb import (TbWriter, cam_grids,
                                         cam_overlay_grid, image_grid)

    counters = {"exp_attention": attention.exp_attention_cuda,
                "exp_attention_bwd": attention.exp_attention_bwd_cuda,
                "flash_attention": attention.flash_attention_cuda,
                "flash_attention_bwd": attention.flash_attention_bwd_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda}

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    with twin_guard() as twin_calls:
        # -- (a) the CAM grids ---------------------------------------------------
        cfg = production_config("voc")
        trainer = Trainer(cfg, device=dev)
        trainer.init_state()
        b27 = synthetic_batch(4, crop=448, num_fg=cfg.model.num_fg, seed=27)
        mean = np.asarray((0.485, 0.456, 0.406), np.float32)
        std = np.asarray((0.229, 0.224, 0.225), np.float32)
        u8 = np.clip(np.round((b27["image"] * std + mean) * 255), 0,
                     255).astype(np.uint8)       # the run's uint8 wire
        images = torch.from_numpy(u8).to(dev)
        cls_label = b27["cls_label"]
        seen = []
        multi_scale_cams = trainer._multi_scale_cams

        def keeping(x):
            seen.append(multi_scale_cams(x))
            return seen[-1]

        trainer._multi_scale_cams = keeping
        try:
            cam_grids(trainer, images, cls_label)         # the first call builds
            torch.cuda.synchronize()
            zero()
            seen.clear()
            t = time.perf_counter()
            grids = cam_grids(trainer, images, cls_label)
            grid_ms = 1e3 * (time.perf_counter() - t)
            grid_launches = read()
        finally:
            del trainer._multi_scale_cams
        check(grid_launches == P27_GRID_LAUNCHES,
              f"cam_grids: launches {grid_launches}, expected "
              f"{P27_GRID_LAUNCHES}")
        check(sorted(grids) == ["CAM/cams_1", "CAM/cams_2", "CAM/inputs"]
              and all(g.dtype == np.uint8 and g.shape == (896, 896, 3)
                      for g in grids.values()),
              f"cam_grids: {[(k, g.dtype, g.shape) for k, g in grids.items()]}")
        norm, images01 = image_ops.prepare_inputs(images)
        want = multi_scale_cams(norm)[0]
        check(len(seen) == 1 and torch.equal(seen[0][0], want),
              "cam_grids: its CAMs differ from Trainer._multi_scale_cams on "
              "the same inputs")
        cams = want.float().cpu().numpy() * cls_label[None, :, None, None, :]
        host01 = images01.float().cpu().numpy()
        check(np.array_equal(grids["CAM/inputs"], image_grid(host01))
              and all(np.array_equal(grids[f"CAM/cams_{i + 1}"],
                                     cam_overlay_grid(host01, cams[i]))
                      for i in range(2)),
              "cam_grids: a grid differs from cam_overlay_grid on the host")
        with tempfile.TemporaryDirectory() as tmp:
            tb = TbWriter(tmp)
            tb_enabled = tb.enabled
            tb.close()
        print(f"[CAM grids] utils/tb.cam_grids, ViT-B/16 dual student, crop "
              f"448, a uint8 batch of 4 | grids "
              f"{json.dumps({k: [str(g.dtype), *g.shape] for k, g in grids.items()})} "
              f"| launches {json.dumps(grid_launches)} (one no-grad "
              f"multi-scale CAM pass of both students) | CAMs bit-equal to "
              f"Trainer._multi_scale_cams, grids equal to cam_overlay_grid "
              f"on the host | {grid_ms:.1f} ms | TbWriter enabled on this "
              f"machine: {tb_enabled}", flush=True)
        del trainer, seen, want
        torch.cuda.empty_cache()

        # -- (b) FLOPs: the card route against the CPU route -------------------------
        model = DualStudent(cfg.model)
        init_weights(model, torch.Generator().manual_seed(27))
        shallow(model, 2)
        aug = augment.draw_ops(torch.Generator().manual_seed(27), cfg.aug_n, 1)
        batch = synthetic_batch(1, crop=448, num_fg=cfg.model.num_fg,
                                seed=27)
        counts = {}
        for phase in ("warmup", "seg", "full"):
            key = f"train_step {phase} crop 448"
            counts[key] = {}
            for side in ("card", "cpu"):
                d = dev if side == "card" else torch.device("cpu")
                tr = Trainer(cfg, model=copy.deepcopy(model), device=d)
                st = tr.init_state(init=False)
                step = phase_start(cfg, phase)
                st.step = st.optimizer.global_step = step
                zero()
                n = flops_utils.count_flops(tr.train_step, st, batch,
                                            step=step, aug_ops=aug.to(d))
                counts[key][side] = (n, read())
                del tr, st
        counts["grad_step warmup crop 768 (phase 17)"] = flops768
        for key, sides in counts.items():
            (n_card, l_card), (n_cpu, l_cpu) = sides["card"], sides["cpu"]
            kernels = (("flash_attention", "flash_attention_bwd")
                       if "768" in key
                       else ("exp_attention", "exp_attention_bwd"))
            check(all(l_card[k] > 0 for k in kernels)
                  and not any(l_cpu.values()),
                  f"{key}: launches card {l_card}, cpu {l_cpu}")
            check(n_card == n_cpu and n_card > 0,
                  f"{key}: count_flops on the card {n_card} != on the CPU "
                  f"{n_cpu}")
        torch.cuda.empty_cache()
        print(f"[FLOPs card vs cpu] utils/flops.count_flops, depth 2, full "
              f"width, batch 1, the same weights and strong-view draws | "
              + " | ".join(f"{k}: {v['card'][0]:.6e} on both (card launches "
                           f"{json.dumps({n_: c for n_, c in v['card'][1].items() if c})})"
                           for k, v in counts.items()), flush=True)
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")

    # -- (c) the MFU line of the train bench, full depth ---------------------------
    rows = {}
    for phase in ("warmup", "seg", "full"):
        rows[phase] = bench_train_torch.run(["--phase", phase, "--iters", "3"])
        check(rows[phase] is not None and rows[phase]["mfu"] is not None
              and rows[phase]["flops_per_step"] > 0,
              f"bench_train_torch --phase {phase}: {rows[phase]}")
        torch.cuda.empty_cache()
    print(f"[MFU] tools/bench_train_torch.py --iters 3, ViT-B/16, batch 4, "
          f"crop 448 | {smi} | " + " | ".join(
              f"{ph}: {r['flops_per_step']:.6e} FLOPs a step, "
              f"{r['tf_per_img']:.4f} TF/img, {r['ms_per_step']:.1f} ms/step, "
              f"mfu {r['mfu']:.4f}" for ph, r in rows.items()), flush=True)
    return grid_launches["exp_attention"]


# Phase 28: the co-run on the card.  The port's Trainer on corun_config and a
# write_corun_tree tree, on the card and on the CPU from the same seeded
# weights, on the same batches and the same strong-view op indices (drawn
# once from a CPU generator), in lockstep.  Gaps are relative: |card - cpu| /
# max(|cpu|, P28_FLOOR), the largest over the logged loss terms.  Arm (a)
# crosses the whole curriculum at crop 64 (sequences of 17-37 tokens: K1 and
# K2 stay off, attention is exact softmax on both sides); arm (b) runs at
# crop 192, where scales 1.0 and 1.5 give 145 and 325 tokens and K1 / K2
# launch, and its CPU side routes models/vit.py's attention through
# exp_attention's twins at the card's threshold (the CPU alone would take
# exact softmax), so that both sides compute one function.  The bounds were
# set from the first card call's reading (PERF.md section 6, PR 16; NVIDIA
# H100 80GB HBM3, 700 W): (a) 2.29e-5 at most before the full phase, 5.2e-4
# a full step, 1.01e-4 on the full phase's mean, inside the CPU co-run's own
# spread against JAX (tests/test_torch_corun.py: 3e-5, 3e-2, 4e-3); (b),
# where the kernels round in bf16, 8.9e-4, 9.7e-3 and 5.5e-3.  Each bound is
# 3-10 times its reading, and the GMM filter skipped read 0.054 / 0.14 (a)
# and 0.038 / 0.076 (b) on its two steps, outside.
P28_FLOOR = 1e-3
P28_FIRST = 1e-4      # the first step past this gap is printed
P28_ARMS = {
    # name: (crop, steps, cam_iters, gmm_iters, bound before the full
    # phase, bound of a full step, bound of the full phase's mean)
    "a": (64, 60, 12, 24, 1e-4, 5e-3, 1e-3),
    "b": (192, 12, 4, 8, 5e-3, 3e-2, 1.5e-2),
}


def p28_batches(cfg, root, lists, n):
    """The first ``n`` batches of the port's loader on the co-run tree, on
    the host (float32 wire)."""
    from dupl_tpu_torch.data.pipeline import PrefetchLoader
    from dupl_tpu_torch.data.voc import VocClsDataset

    ds = VocClsDataset(root, lists, crop_size=cfg.data.crop_size,
                       transfer_dtype="float32")
    loader = PrefetchLoader(ds, cfg.samples_per_device, seed=cfg.seed,
                            num_workers=2)
    try:
        return [{k: b[k] for k in ("image", "cls_label", "img_box")}
                for _, b in zip(range(n), loader)]
    finally:
        loader.stop()


def p28_expected(cfg, depth):
    """K1-K4 launches a step of each phase: K1 once a block for every
    pass of at least ``_EXP_MIN_SEQ`` tokens (per student scale 1.0 with
    grad, its flip, scale 0.5 and 1.5 each with its flip in one batch, and
    in the full phase the strong view), K2 once a block for each such pass
    with grad; K3 once and K4 once a PAR round in a seg or full step."""
    from dupl_tpu_torch.ops.attention import _EXP_MIN_SEQ

    crop, p = cfg.data.crop_size, cfg.model.patch_size

    def on(size):
        return (size // p) ** 2 + 1 >= _EXP_MIN_SEQ

    out = {}
    for phase in ("warmup", "seg", "full"):
        passes = [(1.0, True), (1.0, False), (0.5, False), (1.5, False)]
        if phase == "full":
            passes.append((cfg.aug_downscale, True))
        k1 = sum(on(int(crop * s)) for s, _ in passes)
        k2 = sum(on(int(crop * s)) for s, g in passes if g)
        par = phase != "warmup"
        out[phase] = {"exp_attention": 2 * depth * k1,
                      "exp_attention_bwd": 2 * depth * k2,
                      "par_affinity": int(par),
                      "par_propagate": cfg.par.num_iter * par}
    return out


def p28_run(cfg, weights, batches, ops, device, counters=None, steps=None,
            snapshot_at=None, start=None):
    """The port's Trainer on ``batches`` (step i on batch i, the full steps
    on ``ops[i]``): per step the logged loss terms and, with ``counters``,
    the launches.  ``steps``: the steps to run (all by default);
    ``snapshot_at``: the step before which the model and optimizer state
    are kept on the host (returned); ``start``: such a snapshot to start
    from in place of ``weights``."""
    import copy

    import torch

    from dupl_tpu_torch.engine.train import Trainer
    from dupl_tpu_torch.models.network import DualStudent

    model = DualStudent(cfg.model)
    model.load_state_dict(weights if start is None else start[0])
    trainer = Trainer(cfg, model=model, device=device)
    state = trainer.init_state(init=False)
    if start is not None:
        state.optimizer.load_state_dict(start[1])
    recs, snap = {}, None
    for step in (range(len(batches)) if steps is None else steps):
        if step == snapshot_at:
            snap = copy.deepcopy((
                {k: v.cpu() for k, v in state.model.state_dict().items()},
                state.optimizer.state_dict()))
        if counters:
            for f in counters.values():
                f.launches = 0
        op = None if ops[step] is None else ops[step].to(device)
        state, m = trainer.train_step(state, batches[step], step=step,
                                      aug_ops=op)
        recs[step] = {"metrics": {k: float(m[k]) for k in P24_LOSSES}}
        if counters:
            recs[step]["launches"] = {k: f.launches
                                      for k, f in counters.items()}
    return recs, snap


def p28_gaps(cpu, card):
    """Per step of ``card``, the largest relative gap of a loss term to
    ``cpu``, and per step the terms' gaps."""
    terms = {s: {k: abs(r["metrics"][k] - cpu[s]["metrics"][k])
                 / max(abs(cpu[s]["metrics"][k]), P28_FLOOR)
                 for k in P24_LOSSES} for s, r in card.items()}
    return {s: max(g.values()) for s, g in terms.items()}, terms


def p28_within(cfg, gaps, terms, bounds):
    """The breaches of an arm's bounds: (step or "mean", gap)."""
    from dupl_tpu_torch.engine.train import phase_of

    before, step_b, mean_b = bounds
    out = [(s, g) for s, g in gaps.items()
           if g > (step_b if phase_of(cfg, s) == "full" else before)]
    full = [s for s in terms if phase_of(cfg, s) == "full"]
    for k in P24_LOSSES:
        if full:
            mean = statistics.mean(terms[s][k] for s in full)
            if mean > mean_b:
                out.append(("mean " + k, mean))
    return out


def phase28(dev):
    """Phase 28, the co-run on the card: arms (a) and (b) of ``P28_ARMS``,
    each card run against the CPU run in lockstep, then the GMM filter
    skipped on the card from the first full step for two steps, which must
    break the arm's bounds.  Returns per arm the launches of each phase."""
    import os
    import tempfile

    import torch

    from dupl_tpu_torch import config as tconfig
    from dupl_tpu_torch.engine.train import Trainer, phase_of
    from dupl_tpu_torch.models import vit
    from dupl_tpu_torch.ops import attention, augment, par_cuda

    counters = {"exp_attention": attention.exp_attention_cuda,
                "exp_attention_bwd": attention.exp_attention_bwd_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda}

    def card_attention(q, k, v, *, scale):
        """The card's route of ``dot_attention`` on CPU tensors: the
        max-free exp attention's twins from ``_EXP_MIN_SEQ`` tokens on."""
        if q.shape[1] >= attention._EXP_MIN_SEQ:
            return attention.exp_attention(q, k, v, scale=scale)
        return attention.softmax_attention(q, k, v, scale=scale)

    out = {}
    with twin_guard() as twin_calls:
        with tempfile.TemporaryDirectory() as tmp:
            root, lists = write_corun_tree(os.path.join(tmp, "tree"), 32, 16,
                                           seed=28)
            for arm, (crop, n, cam, gmm, *bounds) in P28_ARMS.items():
                t0 = time.perf_counter()
                cfg = corun_config(tconfig, n, crop=crop, cam_iters=cam,
                                   gmm_iters=gmm)
                weights = p24_weights(cfg)
                batches = p28_batches(cfg, root, lists, n)
                gen = torch.Generator().manual_seed(28)
                ops = [augment.draw_ops(gen, cfg.aug_n, len(b["image"]))
                       if phase_of(cfg, s) == "full" else None
                       for s, b in enumerate(batches)]
                real = vit.dot_attention
                if arm == "b":
                    vit.dot_attention = card_attention
                try:
                    t_cpu = time.perf_counter()
                    cpu, _ = p28_run(cfg, weights, batches, ops, "cpu")
                    t_cpu = time.perf_counter() - t_cpu
                finally:
                    vit.dot_attention = real
                t_card = time.perf_counter()
                card, snap = p28_run(cfg, weights, batches, ops, dev,
                                     counters, snapshot_at=gmm)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t_card
                check(all(math.isfinite(v) for r in card.values()
                          for v in r["metrics"].values()),
                      f"co-run arm ({arm}): non-finite losses on the card")
                check(all(card[s]["metrics"]["reg_loss"] > 0
                          for s in range(gmm, n)),
                      f"co-run arm ({arm}): a full step without "
                      "consistency pixels")
                depth = vit.VIT_CONFIGS[cfg.model.backbone].depth
                expected = p28_expected(cfg, depth)
                for s, r in card.items():
                    ph = phase_of(cfg, s)
                    check(r["launches"] == expected[ph],
                          f"co-run arm ({arm}) step {s} ({ph}): launches "
                          f"{r['launches']}, expected {expected[ph]}")
                gaps, terms = p28_gaps(cpu, card)
                breaches = p28_within(cfg, gaps, terms, bounds)
                # the planted fault: the GMM filter skipped on the card
                real_filter = Trainer._gmm_filter
                Trainer._gmm_filter = lambda self, segs, refined: refined
                try:
                    fault, _ = p28_run(cfg, weights, batches, ops, dev,
                                       steps=range(gmm, gmm + 2), start=snap)
                finally:
                    Trainer._gmm_filter = real_filter
                f_gaps, f_terms = p28_gaps(cpu, fault)
                f_breaches = p28_within(cfg, f_gaps, f_terms, bounds)
                first = next((s for s in sorted(gaps) if gaps[s] > P28_FIRST),
                             None)
                means = {ph: statistics.mean(
                    g for s, g in gaps.items() if phase_of(cfg, s) == ph)
                    for ph in ("warmup", "seg", "full")}
                attn = ("K1 and K2 off: every sequence is under "
                        f"_EXP_MIN_SEQ {attention._EXP_MIN_SEQ} tokens"
                        if arm == "a" else "K1 / K2 at 145 and 325 tokens, "
                        "the CPU through exp_attention's twins")
                print(f"[co-run ({arm})] corun_config at crop {crop}, "
                      f"{n} steps (warm-up {cam}, seg {gmm - cam}, full "
                      f"{n - gmm}), depth {depth}, batch 2, write_corun_tree "
                      f"(32 train JPEGs), seeded weights, card against CPU "
                      f"in lockstep; {attn} | launches a step "
                      f"{json.dumps(expected)} | gap a step "
                      + " ".join(f"{gaps[s]:.3g}" for s in sorted(gaps))
                      + f" | first step past {P28_FIRST}: {first} | mean gap "
                      f"a phase {json.dumps({k: float(f'{v:.4g}') for k, v in means.items()})} | "
                      f"bounds (before full, full step, full mean) {bounds} "
                      f"breached: {breaches} | GMM skipped on the card from "
                      f"step {gmm}: gaps "
                      + " ".join(f"{f_gaps[s]:.3g}" for s in sorted(f_gaps))
                      + f", breaches {len(f_breaches)} | s: CPU {t_cpu:.1f}, "
                      f"card {t_card:.1f}, arm {time.perf_counter() - t0:.1f}"
                      f" | no twin on a CUDA tensor", flush=True)
                check(not breaches, f"co-run arm ({arm}): the card left the "
                      f"CPU run's bounds: {breaches}")
                check(f_breaches, f"co-run arm ({arm}): the GMM-skip fault "
                      f"stayed inside the bounds: {f_gaps}")
                out[arm] = expected
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    return out


# Phase 29: the JAX side's measurement programs on the port, in bench.py's
# configuration (config.bench_config: tanh GELU, bf16 residual stream, PAR
# in bf16 on a class budget), at full width and depth, each through its
# run().  (a) bench_torch.py: a pipeline call of 16 launches K1 72 times
# (scales 1.0 / 0.5 / 1.5, each with its flip, 12 blocks, 2 students), K3
# once, K4 once a PAR round and K5 once (the fast CRF's last apply).
P29_BENCH_LAUNCHES = {"exp_attention": 72, "par_affinity": 1,
                      "par_propagate": 10, "crf_apply": 1}
# bench_torch.run's calls: one warm-up, one under count_flops, 3 x 10 timed
P29_BENCH_CALLS = 32
P29_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu",
                 "tflops_per_img"}


def phase29(dev, smi):
    """The four measurement tools in-process on the card: (a)
    ``bench_torch.run``, its line and its launches a call, then its
    pipeline's labels against ``make_pseudo_label_fn``'s on the same model
    and inputs; (b)
    ``bench_components_torch`` VOC at batch 16, ``--iters 2``; (c) COCO with
    20 classes an image at batch 16, ``--iters 1``: PAR past the class
    budget (K4 at C 324) and the CRF labels on 32 classes (K5 at V 33), the
    first launch at each width held to its twin at phase 8's bf16 and phase
    4's bounds; (d) ``encoder_dissect_torch`` at 64 sequences of 448^2,
    ``--iters 3``; (e) ``train_dissect_torch`` at batch 8, ``--iters 2``.
    Returns K1 / K3 / K4 / K5 launches a bench call and the wide launches'
    record (operand shapes, errors, kernel and plain ms)."""
    import os

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import bench_components_torch
    import bench_torch
    import encoder_dissect_torch
    import train_dissect_torch

    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.ops import attention, crf_cuda, par_cuda
    from dupl_tpu_torch.utils.timing import time_ms

    counters = {"exp_attention": attention.exp_attention_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda,
                "crf_apply": crf_cuda.kernel_apply_cuda}

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    secs = {}
    with twin_guard() as twin_calls:
        # -- (a) bench_torch --------------------------------------------------------
        t = time.perf_counter()
        zero()
        line = bench_torch.run([])
        per_call = {k: n / P29_BENCH_CALLS for k, n in read().items()}
        # the same model and inputs through both programs
        cfg = bench_config("voc")
        trainer = bench_torch.build(cfg, 0, dev)
        batch = trainer.put(synthetic_batch(16, crop=448))
        with torch.inference_mode():
            refined, labels = bench_torch.cam_par_pipeline(trainer, batch)
        live = make_pseudo_label_fn(cfg, trainer.model)(
            batch["image"], batch["cls_label"], batch["img_box"])
        equal = (torch.equal(refined.to(torch.uint8), live[0])
                 and torch.equal(labels.to(torch.uint8), live[1]))
        has_ignore = bool((live[0] == cfg.ignore_index).any())
        del trainer, batch, refined, labels, live
        secs["a"] = time.perf_counter() - t
        print(f"[bench_torch] {json.dumps(line)}", flush=True)
        check(set(line) == P29_LINE_KEYS and line["value"] > 0
              and 0 < line["mfu"] <= 1 and line["tflops_per_img"] > 0,
              f"bench_torch: line {line}")
        check(per_call == P29_BENCH_LAUNCHES,
              f"bench_torch: launches a call {per_call}, expected "
              f"{P29_BENCH_LAUNCHES}")
        check(equal and has_ignore,
              "bench_torch: its labels differ from make_pseudo_label_fn's "
              "on the same inputs")
        print(f"[bench_torch] ViT-B/16 dual student, bench_config('voc') "
              f"(tanh GELU, bf16 stream, bf16 PAR, budget 10), batch 16, "
              f"crop 448, blob | {smi} | launches a call "
              f"{json.dumps(per_call)} | refined and CRF labels bit-equal "
              f"to make_pseudo_label_fn's | {secs['a']:.1f} s", flush=True)
        torch.cuda.empty_cache()

        # -- (b) bench_components_torch, VOC ----------------------------------------
        t = time.perf_counter()
        voc = bench_components_torch.run(["--batch", "16", "--iters", "2"])
        secs["b"] = time.perf_counter() - t
        check(all(math.isfinite(v) and v > 0 for r in voc.values()
                  for v in (r if isinstance(r, (list, tuple)) else [r])),
              f"bench_components_torch voc: {voc}")
        torch.cuda.empty_cache()

        # -- (c) bench_components_torch, COCO, 20 classes an image ------------------
        wide = {}
        prop, apply_ = par_cuda.propagate, crf_cuda.kernel_apply

        def propagating(masks, aff, dilations, num_iter, compute_dtype):
            out = prop(masks, aff, dilations, num_iter, compute_dtype)
            wide.setdefault("par_c", []).append(masks.shape[-1])
            if masks.shape[-1] == 324 and "k4" not in wide:
                wide["k4"] = (masks, aff, tuple(dilations), num_iter,
                              compute_dtype, out)
            return out

        def applying(basis, coef, logc, vals, block_rows=25088):
            out = apply_(basis, coef, logc, vals, block_rows)
            wide.setdefault("crf_v", []).append(vals.shape[-1])
            if vals.shape[-1] == 33 and "k5" not in wide:
                wide["k5"] = (basis, coef, logc, vals, out)
            return out

        par_cuda.propagate, crf_cuda.kernel_apply = propagating, applying
        t = time.perf_counter()
        zero()
        try:
            coco = bench_components_torch.run(
                ["--batch", "16", "--iters", "1", "--dataset", "coco",
                 "--density", "dense"])
        finally:
            par_cuda.propagate, crf_cuda.kernel_apply = prop, apply_
        coco_launches = read()
        secs["c"] = time.perf_counter() - t
        check(all(math.isfinite(v) and v > 0 for r in coco.values()
                  for v in (r if isinstance(r, (list, tuple)) else [r])),
              f"bench_components_torch coco dense: {coco}")
        check("k4" in wide and "k5" in wide,
              f"coco dense: PAR widths {sorted(set(wide.get('par_c', [])))}, "
              f"CRF value columns {sorted(set(wide.get('crf_v', [])))}: no "
              f"K4 at C 324 or no K5 at V 33")
        torch.cuda.empty_cache()

        # -- (d) encoder_dissect_torch, (e) train_dissect_torch ----------------------
        t = time.perf_counter()
        enc = encoder_dissect_torch.run(["--seqs", "64", "--size", "448",
                                         "--iters", "3"])
        secs["d"] = time.perf_counter() - t
        check(all(v is not None and math.isfinite(v) and v > 0
                  for v in enc.values()), f"encoder_dissect_torch: {enc}")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        trd = train_dissect_torch.run(["--batch", "8", "--iters", "2"])
        secs["e"] = time.perf_counter() - t
        check(all(math.isfinite(v) and v > 0 for v in trd.values()),
              f"train_dissect_torch: {trd}")
        torch.cuda.empty_cache()
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")

    # K4 at C 324 and K5 at V 33 against their twins, on the operands of
    # their first launch at that width (outside the guard: the twins run on
    # the card's tensors here on purpose)
    masks, aff, dil, n_iter, cdt, got = wide.pop("k4")
    want = par_cuda.propagate_ref(masks, aff, dil, n_iter, cdt)
    err = (got - want).abs()
    k4_ulps = (err / bf16_ulp(want.abs())).max().item()
    check(cdt == "bfloat16" and bool(torch.isfinite(got).all())
          and k4_ulps <= 2.0,
          f"K4 at C 324 ({cdt}): {k4_ulps:.3g} bf16 ulps of its element "
          f"(bound 2)")
    m_in = masks.float().permute(0, 3, 1, 2).contiguous()
    a_in = aff.to(torch.bfloat16).contiguous()
    k4 = {"shape": list(masks.shape), "compute_dtype": cdt,
          "launches": coco_launches["par_propagate"],
          "max_abs_err": err.max().item(), "ulps": k4_ulps,
          "ms": time_ms(lambda: par_cuda.propagate_cuda(m_in, a_in, dil,
                                                         n_iter), dev),
          "plain_ms": time_ms(lambda: par_cuda.propagate_ref(
              masks, aff, dil, n_iter, cdt), dev, iters=1, warmup=0)}
    del masks, aff, got, want, err, m_in, a_in
    basis, coef, logc, vals, got = wide.pop("k5")
    want = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
    worst, mean = crf_apply_err(got, want)
    check(bool(torch.isfinite(got).all()) and worst <= K5_MAX
          and mean <= K5_MEAN,
          f"K5 at V 33: error {worst:.3g} / {mean:.3g} of the column scale "
          f"(max / mean; bounds {K5_MAX} / {K5_MEAN})")
    v_in = vals.float().contiguous()
    k5 = {"shape": [basis.shape[0], basis.shape[1], coef.shape[2],
                    vals.shape[2]],
          "launches": coco_launches["crf_apply"],
          "max_abs_err": (got - want).abs().max().item(),
          "err_rel": [worst, mean],
          "ms": time_ms(lambda: crf_cuda.kernel_apply_cuda(
              basis, coef, logc, v_in), dev),
          "plain_ms": time_ms(lambda: crf_cuda.kernel_apply_ref(
              basis, coef, logc, vals), dev, iters=3, warmup=1)}
    del basis, coef, logc, vals, got, want, v_in
    torch.cuda.empty_cache()
    for name, rep in (("voc", voc), ("coco dense", coco)):
        print(f"[bench_components_torch {name}] batch 16 | {smi} | ms "
              + ", ".join(f"{k} {1e3 * (v[0] if isinstance(v, (list, tuple)) else v):.2f}"
                          for k, v in rep.items())
              + f" | img/s pipeline {16 / rep['pipeline']:.3f}, eval "
              f"{16 / rep['eval_protocol']:.3f}", flush=True)
    print(f"[wide K4, K5] coco dense: PAR widths "
          f"{sorted(set(wide['par_c']))}, CRF value columns "
          f"{sorted(set(wide['crf_v']))} | launches {json.dumps(coco_launches)}"
          f" | K4 {json.dumps(k4)} | K5 {json.dumps(k5)}", flush=True)
    print(f"[encoder_dissect_torch] 64 seqs, 448^2 | {smi} | ms "
          f"{json.dumps({k: round(v, 3) for k, v in enc.items()})}", flush=True)
    print(f"[train_dissect_torch] batch 8, crop 448 | {smi} | ms "
          f"{json.dumps({k: round(v, 3) for k, v in trd.items()})}", flush=True)
    print(f"[measurement tools] s {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f" | phase 29 {sum(secs.values()):.1f} s of the kernels' and "
          f"tools' work (budget 100)", flush=True)
    return {"launches_bench": per_call, "k4_c324": k4, "k5_v33": k5,
            "voc_rows": voc}


# Phase 30: the exact GELU (kernel G) and the int8 inference path (kernels
# Q1 and Q2).  Each kernel is held to its twin bit for bit: 0 unequal
# elements (NaN equal to NaN, every other bit pattern compared).
P30_MLP_ROWS = 16 * 785        # bench_config's 16 images at scale 1.0
# ViT-B's four products a block: name -> (N, K, activation dtype)
P30_PRODUCTS = {"qkv": (2304, 768, "bfloat16"), "proj": (768, 768, "bfloat16"),
                "fc1": (3072, 768, "bfloat16"), "fc2": (768, 3072, "float32")}
# Q1's two passes, Q2's int32 product and the rescale (phase 30 (b2)):
# rows past the one-launch entries' cap (K 8192 in fp32, 16,384 in bf16,
# M 1001, N 768) and a model rank's shares of ViT-B/16's row-parallel
# products at TP 2 (proj: K 384 of bf16 attention output; fc2: K 1536 of
# fc1's fp32 output through the GELU), each quantized by the maxima of the
# whole K, as the model group's all-reduce gives them.  name -> (M, N, K of
# the whole row, K of the share, x dtype, GELU)
P30_TWO_PASS = {"k8192": (1001, 768, 8192, 8192, "float32", None),
                "k8192_tanh": (1001, 768, 8192, 8192, "float32", "tanh"),
                "k8192_erf": (1001, 768, 8192, 8192, "float32", "erf"),
                "k16384": (1001, 768, 16384, 16384, "bfloat16", None),
                "proj_tp2": (P30_MLP_ROWS, 768, 768, 384, "bfloat16", None),
                "fc2_tp2": (P30_MLP_ROWS, 768, 3072, 1536, "float32", "tanh"),
                "fc2_tp2_erf": (P30_MLP_ROWS, 768, 3072, 1536, "float32",
                                "erf")}
# fp32 instructions an element of G's fp32 forward: about 12 below |z| = 1
# (the 7-step Horner scheme, 1 - z P, two products), about 30 beyond (the
# exp's 12, two reciprocals counted as one each, the 8- or 9-step scheme,
# the reflection); the backward adds the exp of the derivative and 8
# products.  bf16 reads tables: its bound is the bytes.
P30_G_INSTR = {"small": 12, "large": 30, "bwd_extra": 20}


def bits_unequal(got, want):
    """Elements of two same-dtype tensors whose bits differ, NaNs equal."""
    import torch

    it = {2: torch.int16, 4: torch.int32}[got.element_size()]
    same = got.view(it) == want.view(it)
    return int((~(same | (torch.isnan(got) & torch.isnan(want)))).sum())


def gelu_wrong(x, kind, g=None):
    """Wrong twins of kernel G's forward: ``one_rounding`` (F.gelu, the
    port's former GELU), ``no_fma`` (every product and sum of XLA's HLO
    rounded on its own, where XLA's CPU code fuses the Horner steps) and
    ``fma_reflect`` (2 - q P as one FMA, a contraction XLA does not make);
    and of its bf16 table design: ``table_negated_index`` (the forward
    table read at the bits of -x), and, backward on the cotangent ``g``,
    ``bwd_factors_swapped`` (erfc(z) and exp(-z^2) exchanged in the packed
    word) and ``bwd_e_unrounded_z`` (the exp of -z^2 without the bf16
    roundings of z and z^2)."""
    import torch
    import torch.nn.functional as F

    from dupl_tpu_torch.ops import gelu

    if kind == "one_rounding":
        return F.gelu(x)
    if kind in ("table_negated_index", "bwd_factors_swapped",
                "bwd_e_unrounded_z"):
        assert x.dtype == torch.bfloat16, "the tables are G's bf16 design"
        fwd_tab, ec_tab, e_tab = gelu._bf16_tables(x.device)
        i = gelu._table_index(x)
        if kind == "table_negated_index":
            return fwd_tab[i ^ 0x8000]
        ec, e = ec_tab[i], e_tab[i]
        if kind == "bwd_factors_swapped":
            ec, e = e, ec
        else:
            z = (-x).float() * gelu._SQRT_HALF[torch.bfloat16]
            e = gelu._bf(gelu._exp_xla(-(z * z)))
        # the backward's products that mix x and g, as the kernel takes them
        xf, gf = x.float(), g.float()
        t = gelu._bf(gelu._bf(gelu._bf(xf * 0.5) * gf) * -1.125)
        left = -gelu._bf(gelu._bf(t * e) * 0.70703125)
        right = gelu._bf(gelu._bf(gf * ec) * 0.5)
        return (left + right).to(torch.bfloat16)

    def erfc_reflect(z, e=None):
        az, z2 = z.abs(), z * z
        e = gelu._exp_xla(-z2) if e is None else e
        one = torch.ones_like(z)
        v = torch.where(az < 1.0, z2, torch.div(one, z2))
        branch = (az >= 1.0).long() + (az >= 2.0).long()
        c = gelu._erfc_coefs(z.device)[:, branch]
        acc = gelu.fma_f32(v, c[0], c[1])
        for i in range(2, 9):
            acc = gelu.fma_f32(acc, v, c[i])
        q = e * torch.div(one, az)
        y = torch.where(-z2 < gelu._ERFC_UNDERFLOW, torch.zeros_like(z),
                        q * acc)
        fused = torch.where(-z2 < gelu._ERFC_UNDERFLOW, 2.0 - y,
                            gelu.fma_f32(-q, acc, 2.0))
        y = torch.where(z < 0, fused, y)
        return torch.where(az < 1.0, gelu.fma_f32(-z, acc, 1.0), y)

    keep = gelu.fma_f32, gelu._erfc_xla
    if kind == "no_fma":
        gelu.fma_f32 = lambda a, b, c: (torch.as_tensor(a, device=x.device)
                                        * b) + c
    else:
        assert kind == "fma_reflect"
        gelu._erfc_xla = erfc_reflect
    try:
        if x.dtype == torch.bfloat16:       # the formula, not the table
            z = (-x).float() * gelu._SQRT_HALF[torch.bfloat16]
            half = gelu._bf(x.float() * 0.5)
            return (half * gelu._bf(gelu._erfc_xla(z))).to(torch.bfloat16)
        return gelu.gelu_erf_ref(x)
    finally:
        gelu.fma_f32, gelu._erfc_xla = keep


def g_registers():
    """ptxas's registers of each of kernel G's instantiations, by dtype,
    direction and vector width (``csrc/gelu_erf.cu``'s mangled names)."""
    from dupl_tpu_torch.kernels import build

    regs = {}
    for e_, r_, _, _ in build.ptxas_usage("gelu_erf"):
        m_ = re.search(r"gelu_kernelI(\w)Lb(\d)ELi(\d+)ELb(\d)E", e_)
        regs[("build_tables_f16" if "f16" in e_ else "build_tables")
             if m_ is None else " ".join((
                 "fp32" if m_[1] == "f" else "f16" if m_[4] == "1" else "bf16",
                 "bwd" if m_[2] == "1" else "fwd", f"vec{m_[3]}"))] = r_
    return regs


def gelu_edge_values(n):
    """n f32 values at the edges of the f32 GELUs (CPU): subnormals and the
    normal boundary, ±0, x on both sides of the tanh GELU's branch at |v| =
    0x1.a36e2ep-12, of its clamp at ±0x1.ffec88p+2 and of |v| = 20, of the
    erf GELU's |z| = 1 and 2, and magnitudes over the exponent range up to
    2^20."""
    import numpy as np
    import torch

    from dupl_tpu_torch.ops import gelu

    rs = np.random.RandomState(20)
    tiny = 2.0 ** -126
    vals = [0.0, -0.0, tiny, -tiny, 2 * tiny, -3 * tiny]
    vals += list(rs.uniform(-tiny, tiny, 200))
    for target in (gelu._TANH_SMALL, gelu._TANH_CLAMP, 20.0):
        r = np.roots([gelu._TANH_S * gelu._TANH_C3, 0, gelu._TANH_S, -target])
        x0 = float(r[np.isreal(r)].real[0])
        vals += [sgn * x0 * (1 + d * 2.0 ** -23) for sgn in (1, -1)
                 for d in range(-40, 41)]
    for z in (1.0, 2.0):    # |z| = |x| sqrt(1/2)
        x0 = z / gelu._SQRT_HALF[torch.float32]
        vals += [sgn * x0 * (1 + d * 2.0 ** -23) for sgn in (1, -1)
                 for d in range(-40, 41)]
    mags = np.exp2(rs.uniform(-149, 20, n))
    out = np.array(vals + list(mags * np.where(rs.rand(n) < 0.5, -1, 1)),
                   np.float32)[:n]
    return torch.from_numpy(out)


Q1_WRONG = ("scale_one_ulp_off", "max_over_half_row", "tanhf")


def q1_wrong(x, kind):
    """Wrong twins of Q1 on one operand x (R, K) -> (q, s): the scale one
    ulp above the recipe's (``scale_one_ulp_off``), the maximum taken over
    the first half of the row (``max_over_half_row``, a reduction that
    stops at one warp of a row's two), and, for the fused fc2 entry, x
    through the tanh GELU with the framework's tanh (``tanhf``: torch.tanh,
    tanhf on the card) in place of XLA's."""
    import torch

    from dupl_tpu_torch.ops import quant

    xf = x.float()
    if kind == "tanhf":
        def c(v):
            return torch.tensor(v, dtype=xf.dtype, device=xf.device)

        inner = c(math.sqrt(2 / math.pi)) * (xf + c(0.044715) * (xf * (xf * xf)))
        return quant.quantize_rows_ref(xf * (c(0.5) * (c(1.0) + torch.tanh(inner))))
    if kind == "scale_one_ulp_off":
        _, s = quant.quantize_rows_ref(xf)
        s = torch.nextafter(s, torch.full_like(s, math.inf))
    else:
        assert kind == "max_over_half_row"
        _, s = quant.quantize_rows_ref(xf[:, :xf.shape[1] // 2].contiguous())
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quant_wrong(x, w, kind):
    """Wrong twins of Q1 + Q2, without the bias: the scale as max|x| / 127
    (``divide_by_127``), the rescale as y * (s_a * s_w) (``rescale_once``),
    the last 32 columns of k left out (``last_k_tile_dropped``); faults
    of Q2's design: the first 32-column K slice read again in place of the
    second (``k_stage_read_twice``, a ring stage read in the wrong phase),
    the row scales of the two 8-row halves of each 16-row group exchanged
    (``row_scale_shifted``), columns 0-127 and 128-255 of the output
    exchanged (``n_tiles_swapped``); and x quantized by a wrong twin of Q1
    (:data:`Q1_WRONG`; with ``tanhf``, the product of the GELU of x)."""
    import torch

    from dupl_tpu_torch.ops import quant

    if kind in Q1_WRONG:
        return quant.int8_linear_ref(*q1_wrong(x, kind),
                                     *quant.quantize_rows_ref(w))
    if kind == "divide_by_127":
        def qrows(t):
            t = t.float()
            amax = t.abs().amax(1, keepdim=True)
            # a true division (a CUDA tensor divided by a Python number is
            # multiplied by its reciprocal, which is the right recipe)
            s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
            return (torch.clamp(torch.round(t / s), -127, 127)
                    .to(torch.int8), s)
        (qa, sa), (qw, sw) = qrows(x), qrows(w)
        return quant.int8_linear_ref(qa, sa, qw, sw)
    (qa, sa), (qw, sw) = quant.quantize_rows_ref(x), quant.quantize_rows_ref(w)
    if kind == "rescale_once":
        acc = (qa.double() @ qw.double().t()).float()
        return acc * (sa * sw.reshape(1, -1))
    if kind == "last_k_tile_dropped":
        return quant.int8_linear_ref(qa[:, :-32], sa, qw[:, :-32], sw)
    if kind == "k_stage_read_twice":
        qa, qw = qa.clone(), qw.clone()
        qa[:, 32:64], qw[:, 32:64] = qa[:, :32], qw[:, :32]
        return quant.int8_linear_ref(qa, sa, qw, sw)
    if kind == "row_scale_shifted":
        rows = torch.arange(sa.shape[0], device=sa.device)
        swap = rows ^ 8
        return quant.int8_linear_ref(
            qa, sa[torch.where(swap < sa.shape[0], swap, rows)], qw, sw)
    assert kind == "n_tiles_swapped"
    y = quant.int8_linear_ref(qa, sa, qw, sw)
    return torch.cat([y[:, 128:256], y[:, :128], y[:, 256:]], dim=1)


def p30_two_pass(dev, g, bound, times, time_ms, unequal):
    """Phase 30 (b2): at each shape of :data:`P30_TWO_PASS`, Q1's two
    passes (``row_absmax_pair``; ``quantize_pair_given`` on the whole K's
    maxima), ``int8_matmul_i32`` and ``int8_rescale`` (with and without the
    bias) against their twins bit for bit, one wrong twin each unequal (the
    maxima over half the row, the wrong maxima, the last 32 columns of
    K left out, the rescale as acc * (sa * sw); the wrong maxima: the
    share's own, or on the whole K the weight's 1/128 high); at the
    tensor-parallel
    shapes each timed (one call, back to back) beside its bound, the
    library's ``torch._int_mm`` for the int32 product and the one-process
    ``quantize_pair`` + ``int8_linear`` on the whole K."""
    import torch

    from dupl_tpu_torch.ops import quant

    out = {}
    for name, (m, n, k_all, k, dt, gelu) in P30_TWO_PASS.items():
        x_all = (torch.randn(m, k_all, generator=g, device=dev)
                 * torch.rand(m, 1, generator=g, device=dev) * 4)
        x_all[min(7, m - 1)] = 0
        x_all = x_all.to(getattr(torch, dt))
        w_all = torch.randn(n, k_all, generator=g, device=dev) * 0.02
        bias = torch.randn(n, generator=g, device=dev) * 0.02
        # the whole K's maxima (the model group's all-reduce), the share
        # the first k columns
        ax, aw = quant.row_absmax_pair_ref(x_all, w_all, gelu)
        x, w = x_all[:, :k].contiguous(), w_all[:, :k].contiguous()
        del x_all, w_all
        bad = {}
        got_a = quant.row_absmax_pair_cuda(x, w, gelu)
        want_a = quant.row_absmax_pair_ref(x, w, gelu)
        bad["row_absmax_pair"] = unequal(got_a, want_a)
        got_q = quant.quantize_pair_given_cuda(x, w, ax, aw, gelu)
        want_q = quant.quantize_pair_given_ref(x, w, ax, aw, gelu)
        bad["quantize_pair_given"] = unequal(got_q, want_q)
        qa, sa, qw, sw = want_q
        acc = quant.int8_matmul_i32_cuda(qa, qw)
        want_acc = quant.int8_matmul_i32_ref(qa, qw)
        bad["int8_matmul_i32"] = int((acc != want_acc).sum())
        bad["int8_rescale"] = sum(
            bits_unequal(quant.int8_rescale_cuda(want_acc, sa, sw, b_),
                         quant.int8_rescale_ref(want_acc, sa, sw, b_))
            for b_ in (bias, None))
        # one wrong twin each
        half = quant.row_absmax_pair_ref(x[:, :k // 2].contiguous(), w, gelu)
        # a share quantized by its own maxima (no all-reduce); on the whole
        # K, the weight's maxima 1/128 high
        own = quant.quantize_pair_given_ref(
            x, w, *(want_a if k < k_all else (ax, aw * (1 + 2 ** -7))), gelu)
        wrong = {
            "row_absmax_pair": unequal(got_a, half),
            "quantize_pair_given": unequal(got_q, own),
            "int8_matmul_i32": int((acc != quant.int8_matmul_i32_ref(
                qa[:, :-32], qw[:, :-32])).sum()),
            "int8_rescale": bits_unequal(
                quant.int8_rescale_cuda(want_acc, sa, sw),
                want_acc.float() * (sa * sw.reshape(1, -1)))}
        torch.cuda.synchronize()
        check(all(v == 0 for v in bad.values()),
              f"phase 30 (b2) {name}: elements unequal to the twins (bound "
              f"0) {bad}")
        check(all(v > 0 for v in wrong.values()),
              f"phase 30 (b2) {name}: a wrong twin is bit-equal {wrong}")
        r = {"shape": [m, n, k], "k_whole": k_all, "dtype": dt, "gelu": gelu,
             "unequal": bad, "wrong_unequal": wrong}
        if "tp2" in name and (gelu != "erf"):
            ex, ew = x.element_size(), w.element_size()
            r["absmax_ms"] = times(lambda: quant.row_absmax_pair_cuda(
                x, w, gelu))
            r["absmax_plain_ms"] = time_ms(
                lambda: quant.row_absmax_pair_ref(x, w, gelu), dev, iters=3)
            r["absmax_bound_ms"], r["absmax_bound_by"] = bound(
                0, "fp32", m * k * ex + n * k * ew + 4 * (m + n))
            r["given_ms"] = times(lambda: quant.quantize_pair_given_cuda(
                x, w, ax, aw, gelu))
            r["given_plain_ms"] = time_ms(
                lambda: quant.quantize_pair_given_ref(x, w, ax, aw, gelu),
                dev, iters=3)
            r["given_bound_ms"], r["given_bound_by"] = bound(
                0, "fp32", m * k * (ex + 1) + n * k * (ew + 1) + 8 * (m + n))
            r["i32_ms"] = times(lambda: quant.int8_matmul_i32_cuda(qa, qw))
            r["i32_plain_ms"] = time_ms(
                lambda: quant.int8_matmul_i32_ref(qa, qw), dev, iters=3)
            r["i32_bound_ms"], r["i32_bound_by"] = bound(
                2 * m * n * k, "int8", m * k + n * k + 4 * m * n)
            try:   # the library yardstick: cuBLASLt's int32 product
                r["i32_library_ms"] = times(lambda: torch._int_mm(qa, qw.t()))
            except RuntimeError as e:
                r["i32_library_ms"] = None
                print(f"[phase 30 (b2)] torch._int_mm at {name}: {e}",
                      flush=True)
            r["rescale_ms"] = times(lambda: quant.int8_rescale_cuda(
                acc, sa, sw, bias))
            r["rescale_plain_ms"] = time_ms(
                lambda: quant.int8_rescale_ref(acc, sa, sw, bias), dev,
                iters=3)
            r["rescale_bound_ms"], r["rescale_bound_by"] = bound(
                0, "fp32", 8 * m * n + 4 * m + 8 * n)
            # the one-process product on the whole K (the same bytes of a
            # share's twice): quantize_pair + int8_linear
            xw, ww = torch.cat([x, x], 1), torch.cat([w, w], 1)
            if gelu is None:
                r["one_launch_ms"] = times(lambda: quant.int8_linear_cuda(
                    *quant.quantize_pair_cuda(xw, ww), bias))
            else:
                r["one_launch_ms"] = times(lambda: quant.int8_linear_cuda(
                    *quant.gelu_quantize_pair_cuda(xw, ww, gelu == "tanh"),
                    bias))
            del xw, ww
        out[name] = r
        del x, w, bias, ax, aw, got_a, want_a, got_q, want_q, qa, sa, qw, sw
        del acc, want_acc, half, own
        torch.cuda.empty_cache()
    return out


def phase30(dev, smi, voc29):
    """(a) Kernel G against its twins on all 65,536 bf16 bit patterns, 2^20
    fp32 values and lengths 1 and 7, forward and backward, and the wrong
    twins of :func:`gelu_wrong` outside (> 0 unequal); G timed at the MLP's
    hidden shape (12,560 x 3072 bf16; one call, and back to back), by
    erfc branch and in fp32, and held to its twins there in
    bf16 and fp32, whole, at a length off the vector width and on a view
    off 16-byte alignment; (b) Q1's pair and Q2 against their twins bit
    for bit at ViT-B's four products (M 12,560), a ragged M and Q2's
    edges, the wrong twins of :func:`quant_wrong` and :func:`q1_wrong`
    outside, timed beside ``torch._int_mm`` + rescale; Q1's GELU entry
    (tanh and erf) at fc2's shape, its edges and one value a row, its
    wrong twins outside, timed beside the former f32 tanh chain; the bf16
    tanh GELU, card against CPU (a reading); (b2) :func:`p30_two_pass`;
    (c) ``tools/bench_components_torch.py --int8`` at batch 16 with the
    counts of every kernel zeroed before and read after, its rows beside
    phase 29's bf16 ones, the int8 CAMs against the bf16 ones on the same
    weights and images (argmax agreement, correlation), one Q1 launch a
    product and no fp32 GELU call, one quantized forward's FLOPs on the
    card and on the CPU, and the same forward with the exact GELU.
    Returns the records of the kernels line."""
    import os

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import bench_components_torch
    import bench_torch

    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import attention, crf_cuda, gelu, par_cuda, quant
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils.timing import time_ms

    rates = (flops_utils.device_rates(torch.cuda.get_device_name(0))
             or flops_utils.H100_SXM)

    def bound(ops, rate, nbytes):
        o, b = 1e3 * ops / rates[rate], 1e3 * nbytes / rates["hbm_bytes_per_s"]
        return (o, "operations") if o >= b else (b, "bytes")

    t30 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(30)
    rec = {}

    # -- (a) G -----------------------------------------------------------------
    bf = torch.bfloat16
    x16 = torch.arange(65536, dtype=torch.int32, device=dev).to(
        torch.int16).view(bf)
    n32 = 1 << 20
    x32 = torch.cat([torch.randn(n32 // 2, generator=g, device=dev) * 3,
                     (torch.rand(n32 // 2, generator=g, device=dev) - 0.5)
                     * 24])
    g16 = torch.randn(65536, generator=g, device=dev).to(bf)
    g16[:6] = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0],
                           device=dev).to(bf)
    g32 = torch.randn(n32, generator=g, device=dev)
    ga = {}
    for name, x, gg in (("bf16", x16, g16), ("fp32", x32, g32)):
        ga[name] = {"fwd_unequal": bits_unequal(gelu.gelu_erf_cuda(x),
                                                gelu.gelu_erf_ref(x)),
                    "bwd_unequal": bits_unequal(gelu.gelu_erf_bwd_cuda(x, gg),
                                                gelu.gelu_erf_bwd_ref(x, gg))}
        # lengths 1 and 7: from a 16-byte aligned start (the vector loop's
        # tail alone) and ending at the last element (off alignment)
        for n_ in (1, 7):
            for at, sl in (("start", slice(0, n_)), ("end", slice(-n_, None))):
                xv, gv = x[sl], gg[sl]
                ga[f"{name} n{n_} {at}"] = {
                    "fwd_unequal": bits_unequal(gelu.gelu_erf_cuda(xv),
                                                gelu.gelu_erf_ref(xv)),
                    "bwd_unequal": bits_unequal(gelu.gelu_erf_bwd_cuda(xv, gv),
                                                gelu.gelu_erf_bwd_ref(xv, gv))}
    torch.cuda.synchronize()
    check(all(v["fwd_unequal"] == 0 and v["bwd_unequal"] == 0
              for v in ga.values()),
          f"G: elements unequal to the twins (forward / backward; bound 0) "
          f"{ga}")
    wrong = {}
    for kind in ("one_rounding", "no_fma", "fma_reflect"):
        wrong[kind] = sum(bits_unequal(gelu_wrong(x, kind), gelu.gelu_erf_ref(x))
                          for x in (x16, x32))
    wrong["table_negated_index"] = bits_unequal(
        gelu_wrong(x16, "table_negated_index"), gelu.gelu_erf_ref(x16))
    for kind in ("bwd_factors_swapped", "bwd_e_unrounded_z"):
        wrong[kind] = bits_unequal(gelu_wrong(x16, kind, g16),
                                   gelu.gelu_erf_bwd_ref(x16, g16))
    xw = x32.clone().requires_grad_(True)
    torch.nn.functional.gelu(xw).backward(g32)
    wrong["bwd_one_rounding"] = bits_unequal(xw.grad,
                                             gelu.gelu_erf_bwd_ref(x32, g32))
    keep = gelu.fma_f32
    gelu.fma_f32 = lambda a, b, c: (torch.as_tensor(a, device=dev) * b) + c
    try:
        wrong["bwd_no_fma"] = bits_unequal(gelu.gelu_erf_bwd_ref(x32, g32),
                                           gelu.gelu_erf_bwd_cuda(x32, g32))
    finally:
        gelu.fma_f32 = keep
    check(all(n > 0 for n in wrong.values()),
          f"G: a wrong twin is bit-equal to the twin {wrong}")
    # the MLP's hidden activations of bench_config's batch (16 x 785 rows,
    # 3072 wide, bf16) and their cotangent
    h = (torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev) * 1.5).to(bf)
    gh = torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev).to(bf)
    large = int((h.float().abs() * gelu._SQRT_HALF[bf] >= 1.0).sum())
    n_el = h.numel()
    instr = (n_el - large) * P30_G_INSTR["small"] + large * P30_G_INSTR["large"]
    gb, gbb = bound(0, "fp32", 4 * n_el), bound(0, "fp32", 6 * n_el)
    gb32 = bound(instr, "fp32_instr", 8 * n_el)
    gbb32 = bound(instr + n_el * P30_G_INSTR["bwd_extra"], "fp32_instr",
                  12 * n_el)
    hr = h.clone().requires_grad_(True)
    out_lib = torch.nn.functional.gelu(hr)

    def times(fn):
        """(ms of one call on an idle device, ms a call back to back)"""
        return time_ms(fn, dev), time_ms(fn, dev, back_to_back=True)

    fwd_ms = times(lambda: gelu.gelu_erf_cuda(h))
    lib_ms = times(lambda: torch.nn.functional.gelu(h))
    bwd_ms = times(lambda: gelu.gelu_erf_bwd_cuda(h, gh))
    lib_bwd_ms = times(lambda: torch.autograd.grad(out_lib, hr, gh,
                                                   retain_graph=True))
    rec["gelu_erf"] = {
        "unequal": ga, "wrong_unequal": wrong,
        "shape": [P30_MLP_ROWS, 3072], "dtype": "bfloat16",
        "ms": fwd_ms[0], "ms_back_to_back": fwd_ms[1],
        "plain_ms": time_ms(lambda: gelu.gelu_erf_ref(h), dev),
        "library_ms": lib_ms[0], "library_ms_back_to_back": lib_ms[1],
        "bound_ms": gb[0], "bound_by": gb[1],
        "ms_bwd": bwd_ms[0], "ms_bwd_back_to_back": bwd_ms[1],
        "plain_ms_bwd": time_ms(lambda: gelu.gelu_erf_bwd_ref(h, gh), dev,
                                iters=3, warmup=1),
        "library_ms_bwd": lib_bwd_ms[0],
        "library_ms_bwd_back_to_back": lib_bwd_ms[1],
        "bound_ms_bwd": gbb[0], "bound_by_bwd": gbb[1]}
    del hr, out_lib
    g30 = rec["gelu_erf"]
    # inputs of one erfc branch each (|z| < 1, |z| >= 2) beside the mixed
    # draws: with the tables, the same time
    u = torch.rand(P30_MLP_ROWS, 3072, generator=g, device=dev)
    branch_x = {"small": ((u * 2 - 1) * 1.4).to(bf),
                "large": (torch.where(u < 0.5, -1.0, 1.0)
                          * (2.9 + 5 * torch.rand_like(u))).to(bf)}
    g30["ms_by_branch"] = {k_: times(lambda: gelu.gelu_erf_cuda(v_))
                           for k_, v_ in branch_x.items()}
    g30["ms_by_branch"]["mixed"] = fwd_ms
    g30["ms_bwd_by_branch"] = {
        k_: times(lambda: gelu.gelu_erf_bwd_cuda(v_, gh))
        for k_, v_ in branch_x.items()}
    g30["ms_bwd_by_branch"]["mixed"] = bwd_ms
    g30["large_share"] = large / n_el
    del u, branch_x
    # fp32 (the int8 path's GELU on fc1's fp32 output): the expansion
    hf, ghf = h.float(), gh.float()
    f32_ms = times(lambda: gelu.gelu_erf_cuda(hf))
    f32_lib_ms = times(lambda: torch.nn.functional.gelu(hf))
    f32_bwd_ms = times(lambda: gelu.gelu_erf_bwd_cuda(hf, ghf))
    g30["fp32"] = {
        "ms": f32_ms[0], "ms_back_to_back": f32_ms[1],
        "bound_ms": gb32[0], "bound_by": gb32[1],
        "library_ms": f32_lib_ms[0],
        "library_ms_back_to_back": f32_lib_ms[1],
        "ms_bwd": f32_bwd_ms[0], "ms_bwd_back_to_back": f32_bwd_ms[1],
        "bound_ms_bwd": gbb32[0], "bound_by_bwd": gbb32[1]}
    del hf, ghf
    g30["registers"] = g_registers()
    # the same at the main path's size: the whole tensors, a length with
    # n % 8 != 0 (the scalar tail) and a view 2 or 4 bytes past 16-byte
    # alignment (the elementwise instantiation), in bf16 and in fp32
    big = {}
    for name, (xm, gm) in (("bf16", (h, gh)),
                           ("fp32", (h.float(), gh.float()))):
        xf, gf = xm.view(-1), gm.view(-1)
        for cut, (xv, gv) in (("whole", (xm, gm)), ("tail", (xf[:-3], gf[:-3])),
                              ("unaligned", (xf[1:], gf[1:]))):
            big[f"{name} {cut}"] = [
                bits_unequal(gelu.gelu_erf_cuda(xv), gelu.gelu_erf_ref(xv)),
                bits_unequal(gelu.gelu_erf_bwd_cuda(xv, gv),
                             gelu.gelu_erf_bwd_ref(xv, gv))]
        del xm, gm, xf, gf, xv, gv
    torch.cuda.synchronize()
    g30["unequal_main_shape"] = big
    check(all(n == 0 for pair in big.values() for n in pair),
          f"G at the MLP's hidden shape: elements unequal to the twins "
          f"(forward, backward; bound 0) {big}")
    del h, gh, x32, g32, xw
    torch.cuda.empty_cache()
    secs = {"a": time.perf_counter() - t30}
    f32 = g30["fp32"]
    print(f"[G gelu_erf] {smi} | every bf16 bit pattern (cotangent with ±0, "
          f"±inf, NaN), 2^20 fp32 values, lengths 1 and 7: unequal to the "
          f"twins {json.dumps(ga)} (bound 0) | wrong twins unequal "
          f"{json.dumps(wrong)} | MLP hidden (12560 x 3072), [forward, "
          f"backward] unequal {json.dumps(big)} (bound 0)", flush=True)
    def pair(t):
        return f"{t[0]:.4f} / {t[1]:.4f}"

    def share(bound_, t):
        return f"{bound_ / t[0]:.0%} / {bound_ / t[1]:.0%}"

    def by_branch(d):
        return json.dumps({k_: [round(v_, 4) for v_ in t_]
                           for k_, t_ in d.items()})

    print(f"[G gelu_erf times] {smi} | ms one call on an idle device / a "
          f"call back to back | bf16 forward {pair(fwd_ms)} (bound "
          f"{gb[0]:.4f}, {gb[1]}; {share(gb[0], fwd_ms)}; F.gelu "
          f"{pair(lib_ms)}; twin {g30['plain_ms']:.3f}), backward "
          f"{pair(bwd_ms)} (bound {gbb[0]:.4f}, {share(gbb[0], bwd_ms)}; "
          f"F.gelu's {pair(lib_bwd_ms)}) | by erfc branch, forward "
          f"{by_branch(g30['ms_by_branch'])}, backward "
          f"{by_branch(g30['ms_bwd_by_branch'])} (mixed: {large / n_el:.3f} "
          f"of |z| >= 1) | fp32 forward {pair(f32_ms)} (bound "
          f"{f32['bound_ms']:.4f}, {f32['bound_by']}; F.gelu "
          f"{pair(f32_lib_ms)}), backward {pair(f32_bwd_ms)} (bound "
          f"{f32['bound_ms_bwd']:.4f}, {f32['bound_by_bwd']}) | ptxas "
          f"registers {json.dumps(g30['registers'])}", flush=True)

    # -- (b) Q1, Q2 --------------------------------------------------------------
    t = time.perf_counter()
    shapes = {name: (P30_MLP_ROWS, *nkd) for name, nkd in P30_PRODUCTS.items()}
    shapes["fc1_ragged"] = (1001, 3072, 768, "bfloat16")
    # Q2's edges: one row, a single 64-row half, a ragged 128-column tile
    # (N 1000), a K inside one 128-column slice (K 96)
    shapes.update({"m1": (1, 3072, 768, "bfloat16"),
                   "m63": (63, 3072, 768, "bfloat16"),
                   "n1000": (1001, 1000, 768, "bfloat16"),
                   "k96": (1001, 768, 96, "bfloat16")})

    def operands(m, n, k, dt):
        x = (torch.randn(m, k, generator=g, device=dev)
             * torch.rand(m, 1, generator=g, device=dev) * 4).to(
                 getattr(torch, dt))
        x[min(7, m - 1)] = 0
        return (x, torch.randn(n, k, generator=g, device=dev) * 0.02,
                torch.randn(n, generator=g, device=dev) * 0.02)

    def unequal(got, want):
        """Unequal elements of two (q, s, ...) tuples of Q1's outputs."""
        return sum(bits_unequal(a_.to(torch.int16) if a_.dtype == torch.int8
                                else a_, b_.to(torch.int16)
                                if b_.dtype == torch.int8 else b_)
                   for a_, b_ in zip(got, want))

    def pair_bound(m, n, k, ex, ew):
        return bound(0, "fp32", m * k * (ex + 1) + n * k * (ew + 1)
                     + 4 * (m + n))

    def device_ms(calls, reps=24):
        """Median device time of a call: ``reps`` calls, taken from
        ``calls`` in turn (each on its own inputs, so that a call finds
        them out of L2), captured in one CUDA graph and replayed; the
        host's time to issue them is not in it."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for fn in calls:
                fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(reps):
                calls[i % len(calls)]()
        torch.cuda.current_stream(dev).wait_stream(side)
        ms = time_ms(graph.replay, dev, iters=5) / reps
        del graph
        return ms

    qrec = {}
    for name, (m, n, k, dt) in shapes.items():
        x, w, bias = operands(m, n, k, dt)
        qa, sa, qw, sw = quant.quantize_pair_cuda(x, w)
        ra, rsa, rw, rsw = quant.quantize_pair_ref(x, w)
        q1_bad = unequal((qa, sa, qw, sw), (ra, rsa, rw, rsw))
        y = quant.int8_linear_cuda(qa, sa, qw, sw, bias)
        y0 = quant.int8_linear_cuda(qa, sa, qw, sw)
        q2_bad = (bits_unequal(y, quant.int8_linear_ref(ra, rsa, rw, rsw, bias))
                  + bits_unequal(y0, quant.int8_linear_ref(ra, rsa, rw, rsw)))
        torch.cuda.synchronize()
        check(q1_bad == 0 and q2_bad == 0,
              f"Q1 / Q2 at {name} (M {m}, N {n}, K {k}, {dt}): {q1_bad} / "
              f"{q2_bad} elements unequal to the twins (bound 0)")
        r = {"shape": [m, n, k], "dtype": dt, "q1_unequal": q1_bad,
             "q2_unequal": q2_bad}
        if name == "fc1":
            r["wrong_unequal"] = {kind: bits_unequal(quant_wrong(x, w, kind), y0)
                                  for kind in ("divide_by_127", "rescale_once",
                                               "last_k_tile_dropped",
                                               "k_stage_read_twice",
                                               "row_scale_shifted",
                                               "n_tiles_swapped")}
            check(all(v > 0 for v in r["wrong_unequal"].values()),
                  f"Q2: a wrong twin is bit-equal {r['wrong_unequal']}")
            r["q1_wrong_unequal"] = {
                kind: unequal(q1_wrong(x, kind), (qa, sa))
                for kind in ("scale_one_ulp_off", "max_over_half_row")}
            check(all(v > 0 for v in r["q1_wrong_unequal"].values()),
                  f"Q1: a wrong twin is bit-equal {r['q1_wrong_unequal']}")
        if name in P30_PRODUCTS and name != "fc2":
            # fc2's operands are quantized by the GELU entry below
            r["q1_ms"], r["q1_ms_back_to_back"] = times(
                lambda: quant.quantize_pair_cuda(x, w))
            r["q1_plain_ms"] = time_ms(lambda: quant.quantize_pair_ref(x, w),
                                       dev)
            # three sets of operands (79 MB at qkv): past the 50 MB L2
            sets = [(x, w)] + [operands(m, n, k, dt)[:2] for _ in range(2)]
            r["q1_device_ms"] = device_ms([
                lambda a_=a_, b_=b_: quant.quantize_pair_cuda(a_, b_)
                for a_, b_ in sets])
            del sets
            r["q1_bound_ms"], r["q1_bound_by"] = pair_bound(
                m, n, k, x.element_size(), w.element_size())
        if name in P30_PRODUCTS:
            r["q2_ms"], r["q2_ms_back_to_back"] = times(
                lambda: quant.int8_linear_cuda(qa, sa, qw, sw, bias))
            r["q2_plain_ms"] = time_ms(lambda: quant.int8_linear_ref(
                qa, sa, qw, sw, bias), dev, iters=3)
            r["q2_bound_ms"], r["q2_bound_by"] = bound(
                2 * m * n * k, "int8",
                m * k + n * k + 4 * m + 8 * n + 4 * m * n)
            try:   # the library yardstick: cuBLASLt's int8 product + rescale
                def lib():
                    acc = torch._int_mm(qa, qw.t())
                    return torch.addcmul(bias, acc.float() * sa, sw.t())
                r["library_ms"], r["library_ms_back_to_back"] = times(lib)
            except RuntimeError as e:
                r["library_ms"] = r["library_ms_back_to_back"] = None
                print(f"[Q2] torch._int_mm at {name}: {e}", flush=True)
        qrec[name] = r
        del x, w, bias, qa, sa, qw, sw, ra, rsa, rw, rsw, y, y0
    # Q1's GELU entry: fc1's fp32 output h through either GELU with fc2's
    # weight, at the main path's shape and at one row, 63 rows and K 96
    fused = {}
    for name, (m, k) in (("fc2", (P30_MLP_ROWS, 3072)), ("m1", (1, 3072)),
                         ("m63", (63, 3072)), ("k96", (1001, 96))):
        h, w, _ = operands(m, 768, k, "float32")
        for approximate in (True, False):
            got = quant.gelu_quantize_pair_cuda(h, w, approximate)
            fused[f"{name} {'tanh' if approximate else 'erf'}"] = unequal(
                got, quant.gelu_quantize_pair_ref(h, w, approximate))
        if name != "fc2":
            continue
        # one value a row, the rest 0 (K 96): the row's scale carries
        # |gelu(value)|, so that the GELU itself is held nearly bit for bit
        # on 2^16 values, half of them at its edges (subnormals, ±0, both
        # sides of the small-|v| branch and of the clamp, |v| = 20, large)
        probe = torch.zeros(1 << 16, 96, device=dev)
        vals = torch.cat([torch.randn(1 << 15, generator=g, device=dev) * 3,
                          gelu_edge_values(1 << 15).to(dev)])
        probe[torch.arange(1 << 16, device=dev),
              torch.randint(0, 96, (1 << 16,), generator=g, device=dev)] = vals
        for approximate in (True, False):
            got = quant.gelu_quantize_pair_cuda(probe, w[:, :96].contiguous(),
                                                approximate)
            fused[f"one value a row {'tanh' if approximate else 'erf'}"] = (
                unequal(got, quant.gelu_quantize_pair_ref(
                    probe, w[:, :96].contiguous(), approximate)))
        del probe, vals
        got = quant.gelu_quantize_pair_cuda(h, w, True)[:2]
        wrong_fused = {"tanhf": unequal(q1_wrong(h, "tanhf"), got)}
        gh_ = gelu.gelu_tanh(h)
        for kind in ("scale_one_ulp_off", "max_over_half_row"):
            wrong_fused[kind] = unequal(q1_wrong(gh_, kind), got)
        del gh_, got
        fb = pair_bound(m, 768, k, 4, 4)
        f_ms = {a_: times(lambda a_=a_: quant.gelu_quantize_pair_cuda(h, w, a_))
                for a_ in (True, False)}
        f_dev = {a_: device_ms([lambda a_=a_: quant.gelu_quantize_pair_cuda(
            h, w, a_)], reps=8) for a_ in (True, False)}

        def tanhf_chain():
            """The int8 path's former f32 GELU: nine ops with torch.tanh."""
            c_ = {v_: torch.tensor(v_, device=dev) for v_ in
                  (math.sqrt(2 / math.pi), 0.044715, 0.5, 1.0)}
            inner = c_[math.sqrt(2 / math.pi)] * (
                h + c_[0.044715] * (h * (h * h)))
            return h * (c_[0.5] * (c_[1.0] + torch.tanh(inner)))
        fc2 = {"shape": [m, 768, k], "dtype": "float32",
               "ms_tanh": f_ms[True][0], "ms_tanh_back_to_back": f_ms[True][1],
               "ms_erf": f_ms[False][0], "ms_erf_back_to_back": f_ms[False][1],
               "device_ms_tanh": f_dev[True], "device_ms_erf": f_dev[False],
               "bound_ms": fb[0], "bound_by": fb[1],
               "plain_ms": time_ms(lambda: quant.gelu_quantize_pair_ref(
                   h, w, True), dev, iters=3),
               "plain_ms_erf": time_ms(lambda: quant.gelu_quantize_pair_ref(
                   h, w, False), dev, iters=3),
               "tanhf_chain_ms": times(tanhf_chain),
               "gelu_erf_ms": times(lambda: gelu.gelu_erf_cuda(h)),
               "wrong_unequal": wrong_fused}
        del h, w
    torch.cuda.synchronize()
    fc2["unequal"] = fused
    check(all(v == 0 for v in fused.values()),
          f"Q1's GELU entry: elements unequal to the twins (bound 0) {fused}")
    check(all(v > 0 for v in fc2["wrong_unequal"].values()),
          f"Q1's GELU entry: a wrong twin is bit-equal {fc2['wrong_unequal']}")
    # bf16 gelu_tanh (bench's main path: nine bf16 operations) on the card
    # against the same inputs on the CPU: a reading, not a gate
    xb = torch.cat([x16, (torch.randn(1 << 20, generator=g, device=dev)
                          * 3).to(bf)])
    fc2["bf16_gelu_tanh_card_vs_cpu"] = bits_unequal(
        gelu.gelu_tanh(xb).cpu(), gelu.gelu_tanh(xb.cpu())) / xb.numel()
    del xb
    torch.cuda.empty_cache()
    secs["b"] = time.perf_counter() - t
    q2_regs = build.ptxas_usage("int8_gemm")
    q1_regs = build.ptxas_usage("quantize_rows")
    print(f"[Q1 quantize_pair, Q2 int8_linear] {smi} | bit for bit, with and "
          f"without the bias, at "
          + ", ".join(f"{k_} {v_['shape']} {v_['dtype']}" for k_, v_ in qrec.items())
          + f" | wrong twins unequal {json.dumps(qrec['fc1']['wrong_unequal'])}"
          f", Q1's {json.dumps(qrec['fc1']['q1_wrong_unequal'])}"
          + " | ms one call on an idle device / a call back to back (Q1; "
          "its bound, share; Q2; Q2 bound, its share; library; twin) "
          + ", ".join(
              f"{k_} " + (f"{pair(q1_)}, device {v_['q1_device_ms']:.4f}; "
                          f"{v_['q1_bound_ms']:.4f}, "
                          f"{share(v_['q1_bound_ms'], q1_)}, device "
                          f"{v_['q1_bound_ms'] / v_['q1_device_ms']:.0%}; "
                          if "q1_ms" in v_ else "(GELU entry); ")
              + f"{pair(q2_)}; {v_['q2_bound_ms']:.4f} ({v_['q2_bound_by']}), "
              f"{share(v_['q2_bound_ms'], q2_)}; "
              + (pair((v_['library_ms'], v_['library_ms_back_to_back']))
                 if v_['library_ms'] is not None else "None")
              + f"; {v_['q2_plain_ms']:.3f}"
              for k_, v_ in qrec.items() if "q2_ms" in v_
              for q1_ in [(v_.get('q1_ms'), v_.get('q1_ms_back_to_back'))]
              for q2_ in [(v_['q2_ms'], v_['q2_ms_back_to_back'])])
          + f" | Q2 ptxas (registers, spills) "
          f"{[(r_, st_, ld_) for _, r_, st_, ld_ in q2_regs]}, Q1 "
          f"{[(r_, st_, ld_) for _, r_, st_, ld_ in q1_regs]}", flush=True)
    print(f"[Q1 gelu_quantize_pair] {smi} | fc1's fp32 output through the "
          f"GELU with fc2's weight: unequal to the twins {json.dumps(fused)} "
          f"(bound 0); wrong twins unequal {json.dumps(fc2['wrong_unequal'])}"
          f" | 12560 x 3072 fp32 + 768 x 3072 fp32, "
          f"ms one call / back to back: tanh "
          f"{pair((fc2['ms_tanh'], fc2['ms_tanh_back_to_back']))}, erf "
          f"{pair((fc2['ms_erf'], fc2['ms_erf_back_to_back']))}, device "
          f"time tanh {f_dev[True]:.4f}, erf {f_dev[False]:.4f} (bound "
          f"{fb[0]:.4f}, {fb[1]}; tanh {share(fb[0], f_ms[True])}, device "
          f"{fb[0] / f_dev[True]:.0%}; erf {share(fb[0], f_ms[False])}, "
          f"device {fb[0] / f_dev[False]:.0%}) | beside: the former nine-op "
          f"torch.tanh chain {pair(fc2['tanhf_chain_ms'])}, G fp32 "
          f"{pair(fc2['gelu_erf_ms'])}, the twins {fc2['plain_ms']:.3f} / "
          f"{fc2['plain_ms_erf']:.3f} | bf16 gelu_tanh, card against CPU on "
          f"all bf16 values and 2^20 draws: "
          f"{fc2['bf16_gelu_tanh_card_vs_cpu']:.6f} of elements unequal "
          f"(a reading)", flush=True)

    # -- (b2) Q1's two passes, the int32 product, the rescale --------------
    t = time.perf_counter()
    rec["two_pass"] = two = p30_two_pass(dev, g, bound, times, time_ms,
                                         unequal)
    secs["b2"] = time.perf_counter() - t
    tp_keys = [k_ for k_, v_ in two.items() if "absmax_ms" in v_]
    print(f"[Q1 two passes, int8_matmul_i32, int8_rescale] {smi} | each "
          f"against its twin, bound 0 (the given maxima: the whole K's, the "
          f"operand a share of it, as TP all-reduces them): unequal "
          + json.dumps({k_: v_["unequal"] for k_, v_ in two.items()})
          + " | wrong twins unequal "
          + json.dumps({k_: v_["wrong_unequal"] for k_, v_ in two.items()})
          + " | ms one call / back to back (bound, share of one call) at "
          + "; ".join(
              f"{k_} {two[k_]['shape']}: absmax {pair(two[k_]['absmax_ms'])}"
              f" ({two[k_]['absmax_bound_ms']:.4f}), given "
              f"{pair(two[k_]['given_ms'])} ({two[k_]['given_bound_ms']:.4f})"
              f", i32 {pair(two[k_]['i32_ms'])} ({two[k_]['i32_bound_ms']:.4f}"
              f", {two[k_]['i32_bound_by']}; torch._int_mm "
              + (pair(two[k_]['i32_library_ms'])
                 if two[k_]['i32_library_ms'] else "None")
              + f"), rescale {pair(two[k_]['rescale_ms'])} "
              f"({two[k_]['rescale_bound_ms']:.4f}); one-process "
              f"quantize_pair + int8_linear {pair(two[k_]['one_launch_ms'])}"
              for k_ in tp_keys)
          + f" | {secs['b2']:.1f} s", flush=True)

    # -- (c) the int8 path ----------------------------------------------------
    t = time.perf_counter()
    counters = {"quantize_pair": quant.quantize_pair_cuda,
                "gelu_quantize_pair": quant.gelu_quantize_pair_cuda,
                "int8_linear": quant.int8_linear_cuda,
                "gelu_erf": gelu.gelu_erf_cuda,
                "exp_attention": attention.exp_attention_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda,
                "crf_apply": crf_cuda.kernel_apply_cuda}
    with twin_guard() as twin_calls, fp32_gelu_calls() as gelu_calls:
        for f in counters.values():
            f.launches = 0
        int8 = bench_components_torch.run(["--batch", "16", "--iters", "1",
                                           "--int8"])
        path_launches = {k_: f.launches for k_, f in counters.items()}
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    check(all(math.isfinite(v) and v > 0 for r_ in int8.values()
              for v in (r_ if isinstance(r_, (list, tuple)) else [r_])),
          f"bench_components_torch --int8: {int8}")
    check(all(path_launches[k_] > 0 for k_ in counters if k_ != "gelu_erf"),
          f"the int8 path did not launch every kernel: {path_launches}")
    # one Q1 launch a product, a GELU entry a block's fc2, and no fp32
    # GELU between fc1 and fc2 (neither the ops of the tanh one nor G)
    q1_launches = (path_launches["quantize_pair"]
                   + path_launches["gelu_quantize_pair"])
    path_launches["fp32_gelu_calls"] = gelu_calls["float32"]
    check(q1_launches == path_launches["int8_linear"]
          == 4 * path_launches["gelu_quantize_pair"]
          and gelu_calls["float32"] == 0 and path_launches["gelu_erf"] == 0,
          f"the int8 path: Q1 {q1_launches} launches for "
          f"{path_launches['int8_linear']} products; fp32 GELU calls "
          f"{gelu_calls}; {path_launches}")
    secs["c"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    # int8 CAMs against bf16 ones: the same seeded weights and images
    t = time.perf_counter()
    inputs = None
    cams = {}
    for q in (False, True):
        trainer = bench_torch.build(bench_config("voc", quantized_inference=q),
                                    0, dev)
        if inputs is None:
            inputs = trainer.put(synthetic_batch(16, crop=448))["image"]
        with torch.inference_mode():
            cams[q] = bench_torch.msc_cams(trainer, inputs)[0].float()
        del trainer
    a, b = cams[False], cams[True]
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    corr = float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])
    check(math.isfinite(corr) and agree > 0.5,
          f"int8 CAMs against bf16: argmax agreement {agree}, corr {corr}")
    del cams, a, b, inputs
    torch.cuda.empty_cache()
    # one quantized forward's FLOPs, card and CPU (depth 2, crop 224)
    from dupl_tpu_torch.models.network import DualStudent

    cfgq = bench_config("voc", quantized_inference=True)
    model = shallow(DualStudent(cfgq.model), 2)
    xq = torch.zeros(1, 224, 224, 3)
    with torch.no_grad():
        cpu_flops = flops_utils.count_flops(model.cam_only, xq)
        model.to(dev)
        card_flops = flops_utils.count_flops(model.cam_only, xq.to(dev))
    check(card_flops == cpu_flops > 0,
          f"quantized forward FLOPs: card {card_flops}, CPU {cpu_flops}")
    # the same forward with the exact GELU: fc2's quantization takes it
    from dupl_tpu_torch.models.vit import Mlp

    for mod in model.modules():
        if isinstance(mod, Mlp):
            mod.gelu_approximate = False
    for f in counters.values():
        f.launches = 0
    with torch.no_grad(), twin_guard() as twin_calls, \
            fp32_gelu_calls() as gelu_calls:
        cam_e = model.cam_only(xq.to(dev))[0]
        erf_launches = {k_: f.launches for k_, f in counters.items()}
    erf_launches["fp32_gelu_calls"] = gelu_calls["float32"]
    check(not twin_calls and bool(torch.isfinite(cam_e).all())
          and erf_launches["gelu_quantize_pair"] == 2 * 2
          and erf_launches["gelu_erf"] == gelu_calls["float32"] == 0,
          f"the int8 forward with the exact GELU (depth 2, both students): "
          f"{erf_launches}, twins {twin_calls}")
    del model, cam_e
    secs["c2"] = time.perf_counter() - t
    print(f"[int8 path] tools/bench_components_torch.py --int8, VOC, batch 16 "
          f"| {smi} | launches {json.dumps(path_launches)} | ms "
          + ", ".join(f"{k_} {1e3 * (v_[0] if isinstance(v_, (list, tuple)) else v_):.2f}"
                      for k_, v_ in int8.items())
          + f" | img/s pipeline {16 / int8['pipeline']:.3f}, eval "
          f"{16 / int8['eval_protocol']:.3f}", flush=True)
    print(f"[bf16 path, phase 29] ms " + ", ".join(
        f"{k_} {1e3 * (v_[0] if isinstance(v_, (list, tuple)) else v_):.2f}"
        for k_, v_ in voc29.items()), flush=True)
    print(f"[int8 vs bf16] multi-scale CAMs of both students, batch 16, the "
          f"same seeded weights and images: argmax agreement {agree:.6f}, "
          f"correlation {corr:.6f} | a quantized cam_only at depth 2, crop "
          f"224: {card_flops} FLOPs on the card, {cpu_flops} on the CPU; "
          f"with the exact GELU, launches {json.dumps(erf_launches)}",
          flush=True)
    print(f"[phase 30] s {json.dumps({k_: round(v_, 1) for k_, v_ in secs.items()})}"
          f" | {time.perf_counter() - t30:.1f} s (budget 60)", flush=True)
    rec["quant"] = qrec
    rec["path"] = {"launches": path_launches, "rows": int8,
                   "cam_agreement": agree, "cam_correlation": corr,
                   "flops_card": card_flops, "flops_cpu": cpu_flops,
                   "launches_erf_depth2": erf_launches}
    rec["gelu_quantize_pair"] = fc2
    return rec


# Phase 31: float16 where the JAX package takes it.  Kernel G's f16 mode and
# K4's are held to their twins bit for bit (0 unequal elements, NaN equal to
# NaN), and the f16 serving dispatch and pseudo-label call run at full width
# beside the recipe's bf16 ones.
P31_G_WRONG = ("one_rounding", "z_unrounded", "bwd_no_fma")
P31_K4_DILATIONS = ((1, 2, 4, 8, 12, 24), (1, 2, 4, 8, 12, 24, 48))
P31_CPU_DEPTH = 4      # blocks of the card-against-CPU calls, as phase 24's
P31_TANH_CPU_ROWS = 2048   # rows of the MLP's hidden shape the CPU recomputes


def gelu_tanh_f16_nine_ops(x):
    """The f16 tanh GELU as the port computed it before its f16 recipe:
    nine f16 operations with ``torch.tanh``, the eager JAX function's
    recipe."""
    import torch

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * (x * x)))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def gelu_f16_wrong(x, kind, g=None):
    """Wrong twins of kernel G's f16 mode: ``one_rounding`` (the f32 GELU
    rounded once to f16), ``z_unrounded`` (the erfc of the unrounded f32
    ``-x s``, bf16's recipe) and, backward on the cotangent ``g``,
    ``bwd_no_fma`` (the last product and the sum rounded on their own,
    where XLA's CPU code makes one f16 FMA)."""
    import torch
    import torch.nn.functional as F

    from dupl_tpu_torch.ops import gelu

    f16 = torch.float16
    if kind == "one_rounding":
        return F.gelu(x.float()).half()
    if kind == "z_unrounded":
        z = (-x).float() * gelu._SQRT_HALF[f16]
        return (x * 0.5) * gelu._erfc_xla(z).half()
    assert kind == "bwd_no_fma"
    _, ec, e = gelu._f16_tables(x.device)
    i = gelu._table_index(x)
    t = (((x * 0.5) * g) * gelu._NEG_TWO_OVER_SQRT_PI[f16]) * e[i]
    return -(t * gelu._SQRT_HALF[f16]) + (g * ec[i]) * 0.5


def phase31(dev, smi):
    """(a) Kernel G's f16 mode against its twins on all 65,536 f16 bit
    patterns (a cotangent of magnitudes 2^-24 to 2^15 with ±0, ±inf, NaN),
    at lengths 1 and 7, and at the MLP's hidden shape (12,560 x 3072:
    whole, a length off the vector width, a view off 16-byte alignment),
    forward and backward, 0 unequal; the wrong twins of
    :func:`gelu_f16_wrong` unequal; timed there (one call, back to back, a
    CUDA graph) beside its bf16 mode, ``F.gelu`` on f16 and the twins.
    (b) K4's f16 mode against its twin, 0 unequal, at 16 x 224^2, C 40, 10
    rounds on K3's affinity of phase 7's uint8 image, in both
    instantiations (``P31_K4_DILATIONS``: the recipe's, and one past the
    cap), and on a ragged case; unequal to the bf16 twin; timed beside its
    bf16 and fp32 modes.  (c) The f16 path at full width (ViT-B/16 dual
    student, crop 448, exact GELU, PAR in f16) through its entry points: a
    serving dispatch of 8 (``InferenceSession.from_weights``) and a
    pseudo-label call of 16 (``make_pseudo_label_fn``), each with the
    counts zeroed before and read after (G launches 12 a student forward,
    as K1, all in f16; K4 10 times, all in f16), timed in turns beside the
    recipe's bf16 (PAR fp32; for pseudo-labels also PAR bf16); then the
    same calls at crop 224 and ``P31_CPU_DEPTH`` blocks on the card and on
    the CPU (the twins): labels at least 98% equal.  (e) The f16 tanh GELU
    (``gelu_tanh``: torch operations, no kernel), forward and its autograd
    backward, on the card against the CPU on all 65,536 f16 patterns and on
    ``P31_TANH_CPU_ROWS`` rows of a call at the MLP's hidden shape, 0
    unequal; the former nine-operation chain unequal; both timed there.
    Returns the records of the kernels line."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from dupl_tpu_torch.config import (DataConfig, ModelConfig, ParConfig,
                                       voc_config)
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.engine.profile import pseudo_label_inputs
    from dupl_tpu_torch.engine.serve import InferenceSession
    from dupl_tpu_torch.models.convert import (init_weights, load_model,
                                               state_dict_to_jax)
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import attention, crf_cuda, gelu, par_cuda
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils.timing import time_ms

    rates = (flops_utils.device_rates(torch.cuda.get_device_name(0))
             or flops_utils.H100_SXM)

    def bound(ops, rate, nbytes):
        o, b = 1e3 * ops / rates[rate], 1e3 * nbytes / rates["hbm_bytes_per_s"]
        return (o, "operations") if o >= b else (b, "bytes")

    def times(fn):
        """(ms of one call on an idle device, ms a call back to back)"""
        return time_ms(fn, dev), time_ms(fn, dev, back_to_back=True)

    def graph_ms(fn, reps=24):
        """Median device time of a call: ``reps`` calls captured in one
        CUDA graph and replayed (the host's time to issue them left out)."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        ms = time_ms(graph.replay, dev, iters=5) / reps
        del graph
        return ms

    def max_err(got, want):
        d = (got.float() - want.float()).abs()
        return float(d[torch.isfinite(d)].max()) if d.numel() else 0.0

    t31 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(31)
    f16, bf16 = torch.float16, torch.bfloat16
    rec, secs = {}, {}

    # -- (a) G's f16 mode ------------------------------------------------------
    x = torch.arange(65536, dtype=torch.int32, device=dev).to(
        torch.int16).view(f16)
    sign = torch.where(torch.rand(65536, generator=g, device=dev) < 0.5,
                       -1.0, 1.0)
    gx = (torch.exp2(torch.rand(65536, generator=g, device=dev) * 39 - 24)
          * sign).to(f16)
    gx[:5] = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan],
                          device=dev).to(f16)
    ga = {"all": [bits_unequal(gelu.gelu_erf_cuda(x), gelu.gelu_erf_ref(x)),
                  bits_unequal(gelu.gelu_erf_bwd_cuda(x, gx),
                               gelu.gelu_erf_bwd_ref(x, gx))]}
    for n_ in (1, 7):
        for at, sl in (("start", slice(0, n_)), ("end", slice(-n_, None))):
            xv, gv = x[sl], gx[sl]
            ga[f"n{n_} {at}"] = [
                bits_unequal(gelu.gelu_erf_cuda(xv), gelu.gelu_erf_ref(xv)),
                bits_unequal(gelu.gelu_erf_bwd_cuda(xv, gv),
                             gelu.gelu_erf_bwd_ref(xv, gv))]
    wrong = {k_: bits_unequal(gelu_f16_wrong(x, k_, gx),
                              gelu.gelu_erf_bwd_cuda(x, gx)
                              if k_.startswith("bwd") else
                              gelu.gelu_erf_cuda(x))
             for k_ in P31_G_WRONG}
    torch.cuda.synchronize()
    check(all(n == 0 for v in ga.values() for n in v),
          f"G f16: elements unequal to the twins (forward, backward; bound "
          f"0) {ga}")
    check(all(n > 0 for n in wrong.values()),
          f"G f16: a wrong twin is bit-equal to the kernel {wrong}")
    h = (torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev) * 1.5).to(f16)
    gh = torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev).to(f16)
    big = {}
    hf, ghf = h.view(-1), gh.view(-1)
    for cut, (xv, gv) in (("whole", (h, gh)), ("tail", (hf[:-3], ghf[:-3])),
                          ("unaligned", (hf[1:], ghf[1:]))):
        big[cut] = [bits_unequal(gelu.gelu_erf_cuda(xv), gelu.gelu_erf_ref(xv)),
                    bits_unequal(gelu.gelu_erf_bwd_cuda(xv, gv),
                                 gelu.gelu_erf_bwd_ref(xv, gv))]
    check(all(n == 0 for v in big.values() for n in v),
          f"G f16 at the MLP's hidden shape: unequal to the twins {big}")
    n_el = h.numel()
    gb, gbb = bound(0, "fp32", 4 * n_el), bound(0, "fp32", 6 * n_el)
    hr = h.clone().requires_grad_(True)
    out_lib = F.gelu(hr)
    hb, ghb = h.to(bf16), gh.to(bf16)
    g16 = {
        "unequal": ga, "unequal_main_shape": big, "wrong_unequal": wrong,
        "shape": [P30_MLP_ROWS, 3072], "dtype": "float16",
        "max_abs_err": max_err(gelu.gelu_erf_cuda(h), gelu.gelu_erf_ref(h)),
        "times": times(lambda: gelu.gelu_erf_cuda(h)),
        "graph_ms": graph_ms(lambda: gelu.gelu_erf_cuda(h)),
        "bwd_times": times(lambda: gelu.gelu_erf_bwd_cuda(h, gh)),
        "bwd_graph_ms": graph_ms(lambda: gelu.gelu_erf_bwd_cuda(h, gh)),
        "bf16_times": times(lambda: gelu.gelu_erf_cuda(hb)),
        "bf16_bwd_times": times(lambda: gelu.gelu_erf_bwd_cuda(hb, ghb)),
        "library_times": times(lambda: F.gelu(h)),
        "library_graph_ms": graph_ms(lambda: F.gelu(h)),
        "library_bwd_times": times(lambda: torch.autograd.grad(
            out_lib, hr, gh, retain_graph=True)),
        "plain_ms": time_ms(lambda: gelu.gelu_erf_ref(h), dev),
        "plain_ms_bwd": time_ms(lambda: gelu.gelu_erf_bwd_ref(h, gh), dev,
                                iters=3, warmup=1),
        "bound_ms": gb[0], "bound_by": gb[1],
        "bound_ms_bwd": gbb[0], "bound_by_bwd": gbb[1], "registers": {}}
    g16["registers"] = {k_: v_ for k_, v_ in g_registers().items()
                        if "f16" in k_}
    del hr, out_lib, h, gh, hf, ghf, xv, gv, hb, ghb
    torch.cuda.empty_cache()
    secs["a"] = time.perf_counter() - t31

    def pair(t):
        return f"{t[0]:.4f} / {t[1]:.4f}"

    print(f"[G gelu_erf f16] {smi} | every f16 bit pattern (cotangent "
          f"2^-24..2^15 with ±0, ±inf, NaN), lengths 1 and 7: [forward, "
          f"backward] unequal to the twins {json.dumps(ga)} (bound 0) | MLP "
          f"hidden (12560 x 3072) {json.dumps(big)} | wrong twins unequal "
          f"{json.dumps(wrong)} | ms one call / back to back: forward "
          f"{pair(g16['times'])}, graph {g16['graph_ms']:.4f} (bound "
          f"{gb[0]:.4f}, {gb[1]}); backward {pair(g16['bwd_times'])}, graph "
          f"{g16['bwd_graph_ms']:.4f} (bound {gbb[0]:.4f}) | bf16 mode "
          f"{pair(g16['bf16_times'])}, backward {pair(g16['bf16_bwd_times'])}"
          f" | F.gelu on f16 {pair(g16['library_times'])}, graph "
          f"{g16['library_graph_ms']:.4f}, its autograd backward "
          f"{pair(g16['library_bwd_times'])} | twins {g16['plain_ms']:.3f}, "
          f"backward {g16['plain_ms_bwd']:.3f} | ptxas registers "
          f"{json.dumps(g16['registers'])}", flush=True)

    # -- (b) K4's f16 mode -----------------------------------------------------
    t = time.perf_counter()
    b4, s4, c4 = 16, 224, 40
    yy, xx = torch.meshgrid(torch.linspace(0, 1, s4, device=dev),
                            torch.linspace(0, 1, s4, device=dev), indexing="ij")
    smooth = torch.stack([0.5 + 0.4 * torch.sin(5 * xx + 3 * yy), yy,
                          0.3 + 0.5 * xx * yy], -1).expand(b4, s4, s4, 3)
    img = ((smooth + 0.002 * torch.randn(b4, s4, s4, 3, generator=g,
                                         device=dev)).clamp(0, 1)
           * 255).round() / 255
    masks = torch.softmax(3 * torch.randn(b4, s4, s4, c4, generator=g,
                                          device=dev), -1)
    m_in = masks.permute(0, 3, 1, 2).contiguous()
    k4 = {"unequal": {}, "unequal_bf16_twin": {}, "max_abs_err": 0.0,
          "ms": {}, "ms_back_to_back": {}, "plain_ms": {}, "bound": {},
          "bf16": {}, "fp32": {}}
    for dil in P31_K4_DILATIONS:
        aff = par_cuda.affinity_cuda(img.contiguous(), dil)
        a16 = aff.to(f16)
        got = par_cuda.propagate_cuda(m_in, a16, dil)
        want = par_cuda.propagate_ref(masks, aff, dil,
                                      compute_dtype="float16").permute(
                                          0, 3, 1, 2)
        twin16 = par_cuda.propagate_ref(masks, aff, dil,
                                        compute_dtype="bfloat16").permute(
                                            0, 3, 1, 2)
        key = f"({','.join(map(str, dil))}),B={b4},{s4}x{s4},C={c4}"
        k4["unequal"][key] = bits_unequal(got, want.contiguous())
        k4["unequal_bf16_twin"][key] = bits_unequal(got, twin16.contiguous())
        k4["max_abs_err"] = max(k4["max_abs_err"], max_err(got, want))
        check(bool(torch.isfinite(got).all()) and k4["unequal"][key] == 0
              and k4["unequal_bf16_twin"][key] > 0,
              f"K4 f16 {key}: {k4['unequal'][key]} elements unequal to the "
              f"twin (bound 0), {k4['unequal_bf16_twin'][key]} to the bf16 "
              f"twin (must be > 0)")
        k4["ms"][key], k4["ms_back_to_back"][key] = times(
            lambda: par_cuda.propagate_cuda(m_in, a16, dil))
        for name, dt in (("bf16", bf16), ("fp32", torch.float32)):
            a_ = aff.to(dt)
            k4[name][key] = times(lambda: par_cuda.propagate_cuda(m_in, a_,
                                                                  dil))
        k4["plain_ms"][key] = time_ms(lambda: par_cuda.propagate_ref(
            masks, aff, dil, compute_dtype="float16"), dev, iters=1, warmup=0)
        taps, pix = 8 * len(dil), b4 * s4 * s4
        # 10 rounds of a product and a sum a tap and pixel-channel on f16x2
        # (counted at twice the fp32 rate, as phase 29 counts bf16x2); the
        # fp32 masks read and written once, the f16 affinity read once
        k4["bound"][key] = bound(10 * 2 * taps * pix * c4 / 2, "fp32",
                                 4 * pix * 2 * c4 + 2 * pix * taps)
        del aff, a16, a_, got, want, twin16
    rimg = torch.rand(3, 37, 53, 3, generator=g, device=dev)
    raff = par_cuda.affinity_cuda(rimg)
    rm = torch.softmax(3 * torch.randn(3, 37, 53, 5, generator=g, device=dev),
                       -1)
    k4["unequal"]["ragged B=3,37x53,C=5"] = bits_unequal(
        par_cuda.propagate_cuda(rm.permute(0, 3, 1, 2).contiguous(),
                                raff.to(f16)),
        par_cuda.propagate_ref(rm, raff, compute_dtype="float16").permute(
            0, 3, 1, 2).contiguous())
    check(k4["unequal"]["ragged B=3,37x53,C=5"] == 0,
          f"K4 f16 ragged case: {k4['unequal']} unequal")
    del masks, m_in, img, smooth, rimg, raff, rm
    torch.cuda.empty_cache()
    secs["b"] = time.perf_counter() - t
    print(f"[K4 par_propagate f16] {smi} | 10 rounds, phase 7's uint8 image"
          f"'s affinity: unequal to the twin {json.dumps(k4['unequal'])} "
          f"(bound 0), to the bf16 twin {json.dumps(k4['unequal_bf16_twin'])}"
          f" (> 0) | ms one call / back to back (bound): " + "; ".join(
              f"{k_} f16 {pair((k4['ms'][k_], k4['ms_back_to_back'][k_]))} "
              f"({k4['bound'][k_][0]:.3f}, {k4['bound'][k_][1]}), bf16 "
              f"{pair(k4['bf16'][k_])}, fp32 {pair(k4['fp32'][k_])}, twin "
              f"{k4['plain_ms'][k_]:.1f}" for k_ in k4["ms"]), flush=True)

    # -- (c) the f16 path at full width ----------------------------------------
    t = time.perf_counter()
    cfgs = {"float16": voc_config(model=ModelConfig(compute_dtype="float16"),
                                  par=ParConfig(compute_dtype="float16")),
            "bfloat16": voc_config()}
    check(all(c_.model.backbone == "deit_base_patch16"
              and not c_.model.gelu_approximate
              and c_.data.crop_size == 448 for c_ in cfgs.values()),
          "phase 31: not the ViT-B/16 VOC recipe with the exact GELU")
    counters = {"exp_attention": attention.exp_attention_cuda,
                "gelu_erf": gelu.gelu_erf_cuda,
                "crf_apply": crf_cuda.kernel_apply_cuda,
                "par_affinity": par_cuda.affinity_cuda,
                "par_propagate": par_cuda.propagate_cuda}

    def zero():
        for f in counters.values():
            f.launches = 0
        gelu.gelu_erf_cuda.launches_f16 = par_cuda.propagate_cuda.launches_f16 = 0

    def read():
        out = {k_: f.launches for k_, f in counters.items()}
        out["gelu_erf_f16"] = gelu.gelu_erf_cuda.launches_f16
        out["par_propagate_f16"] = par_cuda.propagate_cuda.launches_f16
        return out

    with tempfile.TemporaryDirectory() as tmp:
        net = DualStudent(cfgs["bfloat16"].model)
        init_weights(net, torch.Generator().manual_seed(0))
        path = os.path.join(tmp, "weights.npz")
        np.savez(path, **state_dict_to_jax(net.state_dict()))
        del net
        sessions = {k_: InferenceSession.from_weights(c_, path, device=dev,
                                                      batch_size=8)
                    for k_, c_ in cfgs.items()}
        images8 = pseudo_label_inputs(8, 448, seed=31)[0]
        labels = {k_: s_._run(images8) for k_, s_ in sessions.items()}
        torch.cuda.synchronize()
        zero()
        with twin_guard() as twin_calls:
            lab16 = sessions["float16"]._run(images8)
        serve_launches = read()
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
        k1_ = serve_launches["exp_attention"]
        check(k1_ > 0 and k1_ % 12 == 0
              and serve_launches["gelu_erf"] == k1_
              == serve_launches["gelu_erf_f16"]
              and serve_launches["crf_apply"] > 0,
              f"f16 serving dispatch: G not 12 launches a student forward "
              f"in f16, as K1: {serve_launches}")
        check(lab16.shape == (8, 448, 448) and lab16.dtype == np.uint8
              and int(lab16.max()) <= 20 and np.array_equal(lab16,
                                                            labels["float16"]),
              f"f16 serving labels {lab16.shape} {lab16.dtype}, the same "
              f"call twice unequal")
        serve_ms = {k_: [] for k_ in sessions}
        for _ in range(5):
            for k_, s_ in sessions.items():
                t0 = time.perf_counter()
                s_._run(images8)
                serve_ms[k_].append(1e3 * (time.perf_counter() - t0))
        serve_agree = float((labels["float16"] == labels["bfloat16"]).mean())
        del sessions
        torch.cuda.empty_cache()
        models = {k_: load_model(c_, path, dev) for k_, c_ in cfgs.items()}
        pl_cfgs = {"float16": cfgs["float16"],
                   "bfloat16": cfgs["bfloat16"],
                   "bfloat16_par_bf16": voc_config(
                       par=ParConfig(compute_dtype="bfloat16"))}
        fns = {k_: make_pseudo_label_fn(c_, models[
            "float16" if k_ == "float16" else "bfloat16"])
            for k_, c_ in pl_cfgs.items()}
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in pseudo_label_inputs(16, 448, seed=1))
        outs = {k_: fn(*args) for k_, fn in fns.items()}
        torch.cuda.synchronize()
        zero()
        with twin_guard() as twin_calls:
            ref16, crf16 = fns["float16"](*args)
            torch.cuda.synchronize()
        pl_launches = read()
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
        k1_ = pl_launches["exp_attention"]
        check(k1_ > 0 and k1_ % 12 == 0 and pl_launches["gelu_erf"] == k1_
              == pl_launches["gelu_erf_f16"]
              and pl_launches["par_propagate"] == 10
              == pl_launches["par_propagate_f16"]
              and pl_launches["par_affinity"] == 1
              and pl_launches["crf_apply"] > 0,
              f"f16 pseudo-label call: {pl_launches}")
        check(ref16.shape == (2, 16, 448, 448) and crf16.shape == (16, 448, 448)
              and torch.equal(ref16, outs["float16"][0])
              and torch.equal(crf16, outs["float16"][1]),
              "f16 pseudo-labels: malformed, or the same call twice unequal")
        vals = set(torch.unique(ref16).tolist())
        check(vals <= set(range(21)) | {255} and 255 in vals
              and int(crf16.max()) <= 20, f"f16 refined labels {sorted(vals)}")
        pl_ms = {k_: [] for k_ in fns}
        for _ in range(3):
            for k_, fn in fns.items():
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                pl_ms[k_].append(1e3 * (time.perf_counter() - t0))
        pl_agree = {k_: [float((o_[0] == ref16).float().mean()),
                         float((o_[1] == crf16).float().mean())]
                    for k_, o_ in outs.items() if k_ != "float16"}
        del fns, outs, args, ref16, crf16
        secs["c"] = time.perf_counter() - t
        # the same calls at crop 224 on the card and on the CPU (the twins),
        # the first P31_CPU_DEPTH blocks of each student
        t = time.perf_counter()
        del models
        cfg224 = voc_config(model=ModelConfig(compute_dtype="float16"),
                            data=DataConfig(crop_size=224),
                            par=ParConfig(compute_dtype="float16"))
        img224 = pseudo_label_inputs(1, 224, seed=32)[0]
        args224 = pseudo_label_inputs(2, 224, seed=2)
        serve224, pl224 = [], []
        for d_ in (dev, torch.device("cpu")):
            m_ = shallow(load_model(cfg224, path, d_), P31_CPU_DEPTH)
            serve224.append(InferenceSession.from_model(
                cfg224, m_, device=d_, batch_size=1)._run(img224))
            pl224.append(tuple(o_.cpu() for o_ in make_pseudo_label_fn(
                cfg224, m_)(*(torch.from_numpy(a).to(d_) for a in args224))))
            del m_
        serve_cpu = float((serve224[0] == serve224[1]).mean())
        pl_cpu = [float((pl224[0][i] == pl224[1][i]).float().mean())
                  for i in range(2)]
    check(serve_cpu >= 0.98 and min(pl_cpu) >= 0.98,
          f"f16 card vs CPU at crop 224: serving labels agree "
          f"{serve_cpu:.4f}, pseudo-labels refined / CRF {pl_cpu} (bound "
          f"0.98)")
    secs["d"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    # -- (e) the f16 tanh GELU -------------------------------------------------
    t = time.perf_counter()

    def tanh_fwd_bwd(x_, g_, fn=gelu.gelu_tanh):
        xr = x_.detach().clone().requires_grad_(True)
        y_ = fn(xr)
        return y_.detach(), torch.autograd.grad(y_, xr, g_)[0]

    card = tanh_fwd_bwd(x, gx)
    tanh_un = {"all": [bits_unequal(a_.cpu(), b_) for a_, b_ in zip(
        card, tanh_fwd_bwd(x.cpu(), gx.cpu()))]}
    nine = [bits_unequal(a_, b_) for a_, b_ in zip(
        tanh_fwd_bwd(x, gx, gelu_tanh_f16_nine_ops), card)]
    h = (torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev) * 1.5).to(f16)
    gh = torch.randn(P30_MLP_ROWS, 3072, generator=g, device=dev).to(f16)
    rows = slice(0, P31_TANH_CPU_ROWS)
    tanh_un["main_shape_rows"] = [
        bits_unequal(a_[rows].cpu(), b_) for a_, b_ in zip(
            tanh_fwd_bwd(h, gh), tanh_fwd_bwd(h[rows].cpu(), gh[rows].cpu()))]
    check(all(n == 0 for v in tanh_un.values() for n in v)
          and all(n > 0 for n in nine),
          f"f16 tanh GELU [forward, backward]: card unequal to the CPU "
          f"{tanh_un} (bound 0), the nine-operation chain unequal {nine} "
          f"(must be > 0)")
    tanh_t = {}
    for name, fn in (("recipe", gelu.gelu_tanh),
                     ("nine_ops", gelu_tanh_f16_nine_ops)):
        hr = h.clone().requires_grad_(True)
        y_ = fn(hr)
        tanh_t[name] = {
            "forward": times(lambda: fn(h)),
            "backward": times(lambda: torch.autograd.grad(
                y_, hr, gh, retain_graph=True))}
        del hr, y_
    # each input read once, each output written once: 2 bytes a value
    tb = bound(0, "fp32", 4 * h.numel())
    tanh16 = {"unequal": tanh_un, "nine_ops_unequal": nine,
              "shape": [P30_MLP_ROWS, 3072], "times": tanh_t,
              "bound_ms": tb[0], "bound_ms_bwd": 1.5 * tb[0]}
    del h, gh, card
    torch.cuda.empty_cache()
    secs["e"] = time.perf_counter() - t
    print(f"[gelu_tanh f16] {smi} | torch operations, no kernel | card "
          f"against CPU [forward, backward] {json.dumps(tanh_un)} (all "
          f"65,536 patterns; {P31_TANH_CPU_ROWS} rows of 12560 x 3072; bound "
          f"0) | the nine-operation chain unequal {nine} | ms one call / "
          f"back to back at 12560 x 3072: recipe forward "
          f"{pair(tanh_t['recipe']['forward'])}, backward "
          f"{pair(tanh_t['recipe']['backward'])}; nine operations forward "
          f"{pair(tanh_t['nine_ops']['forward'])}, backward "
          f"{pair(tanh_t['nine_ops']['backward'])} (bytes bound "
          f"{tb[0]:.4f} / {1.5 * tb[0]:.4f})", flush=True)

    def med(v):
        return statistics.median(v)

    print(f"[f16 path] {smi} | ViT-B/16 dual student, crop 448, exact GELU | "
          f"serving dispatch of 8 (InferenceSession.from_weights; MSC "
          f"1.0/1.5/1.25 x flip, ensemble, fast CRF): launches "
          f"{json.dumps(serve_launches)}; ms median of 5 in turns f16 "
          f"{med(serve_ms['float16']):.1f}, bf16 {med(serve_ms['bfloat16']):.1f}"
          f" ({json.dumps({k_: [round(v, 1) for v in v_] for k_, v_ in serve_ms.items()})})"
          f"; labels f16 = bf16 on {serve_agree:.4f} | pseudo-label call of "
          f"16 (PAR f16): launches {json.dumps(pl_launches)}; ms median of 3 "
          f"in turns " + ", ".join(f"{k_} {med(v_):.1f}"
                                   for k_, v_ in pl_ms.items())
          + f" ({json.dumps({k_: [round(v, 1) for v in v_] for k_, v_ in pl_ms.items()})})"
          f"; refined / CRF labels equal to f16's {json.dumps(pl_agree)} | "
          f"card vs CPU at crop 224, {P31_CPU_DEPTH} blocks: serving "
          f"labels {serve_cpu:.4f}, "
          f"pseudo-labels refined / CRF {pl_cpu[0]:.4f} / {pl_cpu[1]:.4f} "
          f"(bound 0.98)", flush=True)
    print(f"[phase 31] s {json.dumps({k_: round(v_, 1) for k_, v_ in secs.items()})}"
          f" | {time.perf_counter() - t31:.1f} s", flush=True)
    rec.update(gelu_erf_f16=g16, par_propagate_f16=k4, gelu_tanh_f16=tanh16,
               serve_launches=serve_launches, pl_launches=pl_launches,
               serve_ms=serve_ms, pl_ms=pl_ms, card_vs_cpu=[serve_cpu, *pl_cpu])
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2

    t_main = time.perf_counter()
    import numpy as np
    import torch.nn.functional as F

    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import attention, crf, crf_cuda, gelu, par_cuda
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils import timing

    dev = torch.device("cuda:0")

    # -- 1. device -------------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 off",
          flush=True)

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all(verbose=True)
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.perf_counter() - t0:.2f} s | ptxas serialised no "
          f"wgmma (a build that it does fails)", flush=True)
    # K5's, K4's, the attention forward's (K1, L1f, P1, P2), K3's and P3's
    # registers and spills per instantiation (ptxas -v): a spill would put a
    # pass's accumulators, a pixel's affinities or logits or a score tile in
    # local memory, so it fails the build phase.
    for name in ("crf_apply", "par_propagate", "exp_attention",
                 "flash_attention", "exp_attention_ones",
                 "exp_attention_bnhd", "par_affinity", "crf_apply_bf16",
                 "int8_gemm", "quantize_rows", "gelu_erf"):
        usage = build.ptxas_usage(name)
        check(bool(usage), f"{name}: no ptxas -v lines in its build log")
        for fn, regs, st, ld in usage:
            print(f"[build] {name} {fn}: {regs} registers, spill stores {st} "
                  f"bytes, spill loads {ld} bytes", flush=True)
        check(all(st == ld == 0 for _, _, st, ld in usage),
              f"{name}: ptxas spilled registers {usage}")

    def time_ms(fn, **kw):
        """Median ms a call of ``fn`` on the card: one call, or with
        ``back_to_back`` rounds of calls back to back
        (``utils/timing.time_ms``)."""
        return timing.time_ms(fn, dev, **kw)

    def graph_ms(fn, stream):
        """Median device time of ``fn`` captured once in a CUDA graph on
        ``stream`` (where its operands were made) and replayed: its kernels
        alone, without the host's time to issue them.  For autograd's
        backward of a library call, whose host side outlasts its kernels."""
        with torch.cuda.stream(stream):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        ms = time_ms(graph.replay)
        del graph
        return ms

    # NVIDIA's published peaks of the card (utils/flops.py's table): dense
    # bf16 on the tensor cores, fp32 outside them, fp32 and special-function
    # instructions, device memory; the SXM part's for a card not in it.
    rates = flops_utils.device_rates(torch.cuda.get_device_name(0))
    if rates is None:
        print(f"[device] {torch.cuda.get_device_name(0)} is not in "
              f"utils/flops.py's table: bounds from the H100 SXM's peaks",
              flush=True)
        rates = flops_utils.H100_SXM
    peak_flops = {k: rates[k] for k in ("bf16", "fp32", "sfu", "fp32_instr")}
    hbm_bytes_per_s = rates["hbm_bytes_per_s"]

    def bound_ms(flops, kind, nbytes):
        """The least time the card could take: (ms, what bounds it)."""
        ops_ms = 1e3 * flops / peak_flops[kind]
        bytes_ms = 1e3 * nbytes / hbm_bytes_per_s
        return ((ops_ms, "operations") if ops_ms >= bytes_ms
                else (bytes_ms, "bytes"))

    def k5_bound(b, n, ns, v):
        """K5's and P3's least time: per (pixel, pivot) entry the 11-wide
        score's 22 fp32 FLOPs outside the tensor cores, one exp on the
        special-function unit, and the value product's 2 VP FLOPs (VP = V
        rounded up to 8) at its own precision, bf16 x bf16 -> fp32, on the
        tensor cores: the largest of the three, or of the bytes (basis, coef,
        logc, values in, (N, V) out, fp32).  P3's bf16 roundings of the
        score and the entry are no FLOPs."""
        entries = b * n * ns
        vp = -(-v // 8) * 8
        ops_ms = max(1e3 * 22 * entries / peak_flops["fp32"],
                     1e3 * entries / (peak_flops["fp32"] / 2 / 8),
                     1e3 * 2 * vp * entries / peak_flops["bf16"])
        bytes_ms = 1e3 * 4 * b * (n * 11 + 11 * ns + ns + ns * v + n * v) / \
            hbm_bytes_per_s
        return ((ops_ms, "operations") if ops_ms >= bytes_ms
                else (bytes_ms, "bytes"))

    def host_us(fn, reps=21):
        """Median host time (us) to enqueue one call while the device is
        busy: a spin kernel holds the stream, so each call returns as soon as
        its host work (checks, allocation, tensor maps, launch) is done."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)   # ~30 ms of device time
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return 1e6 * statistics.median(ts)

    def qkvg(b, n, h, d, mult):
        """q (scaled by mult / sqrt(d), bf16), k, v as column slices of one
        (B, N, 3C) projection, as the ViT hands them to the kernels, and a
        cotangent."""
        c = h * d
        qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(
            torch.bfloat16)
        q_, k_, v_ = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
                      for i in range(3))
        qs_ = (q_.float() * mult * d ** -0.5).to(torch.bfloat16)
        go_ = torch.randn(b, n, h, d, generator=g, device=dev).to(
            torch.bfloat16)
        return qs_, k_, v_, go_

    # -- 3. K1 against its twin ----------------------------------------------------
    # Error in bf16 ulps at the scale of each output row (max |out| over the
    # head dim).  Kernel and twin round the same fp32 quantities to bf16 (e
    # before the value product, the result once); their exps and fp32 sums
    # run in different orders, which can flip the rounding of a bf16(e)
    # entry, and an element that nearly cancels carries that error at its
    # row's scale.  Bounds: 1 ulp at the maximum, 1e-3 on average.  Three
    # wrong twins (chip_smoke.exp_attn_wrong: the flash kernel's running
    # maximum, e left in fp32, the denominator summed from bf16(e)) must fall
    # outside them.  Then the edges of the 128-key tiles and 128-row blocks
    # (N 127-129, 255-257, 2045-2047) for every head dim on strided views.
    g = torch.Generator(device=dev).manual_seed(0)
    k1 = {"err": 0.0, "ulps": {}, "wrong": {}, "edges": {}, "ms": {},
          "ms_back_to_back": {}, "host_us": {}, "plain_ms": {},
          "library_ms": {}}
    cases = [(2, 197, 1.0), (2, 785, 1.0), (2, 1226, 1.0), (2, 1765, 1.0),
             (2, 785, 40.0),               # logits far past the clamp at 60
             (16, 785, 1.0), (16, 1226, 1.0), (16, 1765, 1.0),  # batch-8 x flip
             # the training step at batch 4: scale 1.0, scales 0.5 and 1.5
             # with their flips, the strong view
             (4, 785, 1.0), (8, 197, 1.0), (8, 1765, 1.0), (4, 442, 1.0)]
    for b, n, mult in cases:
        q, k, v = (torch.randn(b, n, 12, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = (q.float() * mult).to(torch.bfloat16)
        qs = (q * torch.tensor(0.125, dtype=torch.bfloat16, device=dev))

        def bhnd(x):
            return x.permute(0, 2, 1, 3).reshape(b * 12, n, 64)

        got = attention.exp_attention_cuda(qs, k, v)
        torch.cuda.synchronize()
        want = attention.exp_attention_ref(bhnd(qs), bhnd(k), bhnd(v)).to(
            torch.bfloat16)
        key = f"BH={b * 12},N={n}" + ("" if mult == 1.0 else f",q x{mult}")
        check(bool(torch.isfinite(got.float()).all()), f"K1 {key}: non-finite")
        worst, mean = row_ulps(bhnd(got), want)
        k1["ulps"][key] = [worst, mean]
        check(worst <= 1.0 and mean <= 1e-3,
              f"K1 {key}: {worst:.3g} bf16 ulps of the row at the maximum, "
              f"{mean:.3g} on average (bounds 1, 1e-3)")
        k1["err"] = max(k1["err"],
                        (bhnd(got).float() - want.float()).abs().max().item())
        if b == 2 and n in (785, 1765) and mult == 1.0:
            for kind in ("running_max", "p_fp32", "denom_bf16"):
                w_max, w_mean = row_ulps(bhnd(got), exp_attn_wrong(
                    bhnd(qs), bhnd(k), bhnd(v), kind))
                k1["wrong"][f"{kind},N={n}"] = [w_max, w_mean]
                check(w_max > 1.0 or w_mean > 1e-3,
                      f"K1: the bounds do not tell the wrong twin {kind!r} at "
                      f"N {n} ({w_max:.3g} at the maximum, {w_mean:.3g} on "
                      f"average)")
        if mult == 1.0:
            k1["ms"][key] = time_ms(lambda: attention.exp_attention_cuda(qs, k, v))
            if b == 16:
                k1["ms_back_to_back"][key] = time_ms(
                    lambda: attention.exp_attention_cuda(qs, k, v),
                    back_to_back=True)
                k1["host_us"][key] = host_us(
                    lambda: attention.exp_attention_cuda(qs, k, v))
            k1["plain_ms"][key] = time_ms(lambda: attention.exp_attention_ref(
                bhnd(qs), bhnd(k), bhnd(v)).to(torch.bfloat16))
            if b == 16:  # the yardstick: one library call, same operands
                ql, kl, vl = (x.permute(0, 2, 1, 3).contiguous()
                              for x in (qs, k, v))
                k1["library_ms"][key] = time_ms(
                    lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                           scale=1.0))
                del ql, kl, vl
        del q, k, v, qs, got, want
    for d in (16, 32, 64, 80):
        for n in (127, 128, 129, 255, 256, 257, 2045, 2046, 2047):
            qs, k, v, _ = qkvg(1, n, 2, d, 1.0)
            got = attention.exp_attention_cuda(qs, k, v)
            torch.cuda.synchronize()
            ops = tuple(attention._to_bhnd(x) for x in (qs, k, v))
            worst, mean = row_ulps(attention._to_bhnd(got),
                                   attention.exp_attention_ref(*ops).to(
                                       torch.bfloat16))
            k1["edges"][f"D={d},N={n}"] = [round(worst, 3), round(mean, 6)]
            check(worst <= 1.0 and mean <= 1e-3,
                  f"K1 at the tile edge D {d}, N {n}: {worst:.3g} bf16 ulps "
                  f"of the row at the maximum, {mean:.3g} on average")
    del k, v, qs, got, ops
    print(f"[K1 exp_attention] max_abs_err {k1['err']:.4g} | bf16 ulps of the "
          f"row [max, mean] {json.dumps(k1['ulps'])} (bounds 1 and 1e-3) | "
          f"wrong twins {json.dumps(k1['wrong'])} (each outside) | tile edges "
          f"{json.dumps(k1['edges'])} | kernel ms {json.dumps(k1['ms'])}, back "
          f"to back {json.dumps(k1['ms_back_to_back'])}, host us a call "
          f"{json.dumps(k1['host_us'])} | plain ms "
          f"{json.dumps(k1['plain_ms'])} | library (F.scaled_dot_product_"
          f"attention) ms {json.dumps(k1['library_ms'])}", flush=True)

    # -- 4. K5 against its twin ----------------------------------------------------
    # Inputs are the fast CRF's own: the pivot lattice of two smooth 448^2
    # images and value columns like the final slice's (21 class columns plus
    # the cell count).  Bounds (crf_apply_err): per column, the largest error
    # 2e-3 of the column's scale and the mean error 2e-5 of it; kernel
    # entries are rounded to bf16 (2^-8), and a different fp32 summation order
    # of the 11-wide score can flip that rounding for an entry.  The three
    # wrong twins of crf_apply_wrong (entries in fp32, values in fp32, the
    # exp of the bf16 score) must fall outside them, at V 22 and 82.
    img = crf_images(g, dev)
    # V 82 is COCO's fast mode (81 classes and the cell count): every
    # 32-column slice of the call must be bit-equal to a call on that slice
    # of the values alone.
    basis, coef, logc, _, _ = crf.pivot_lattice(img, 8, 121.0, 5.0)
    k5 = {"err": 0.0, "err_rel": {}, "wrong_rel": {}, "ms": {},
          "ms_back_to_back": {}, "plain_ms": {}}
    for nv in (22, 1, 82):
        vals = torch.rand(2, coef.shape[2], nv, generator=g, device=dev) * 2.0
        vals[..., -1] = 64.0
        got = crf_cuda.kernel_apply_cuda(basis, coef, logc, vals)
        torch.cuda.synchronize()
        want = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
        key = f"B=2,N={basis.shape[1]},Ns={coef.shape[2]},V={nv}"
        worst, mean = crf_apply_err(got, want)
        check(bool(torch.isfinite(got).all()), f"K5 V={nv}: non-finite")
        check(worst <= K5_MAX and mean <= K5_MEAN,
              f"K5 V={nv}: error {worst:.3g} / {mean:.3g} of the column scale "
              f"(max / mean; bounds {K5_MAX} / {K5_MEAN})")
        for c0 in range(0, nv, 32):
            part = crf_cuda.kernel_apply_cuda(
                basis, coef, logc, vals[..., c0:c0 + 32].contiguous())
            check(torch.equal(got[..., c0:c0 + 32], part),
                  f"K5 V={nv}: columns {c0}.. differ from a call on them alone")
        if nv > 1:
            for kind in ("k_fp32", "vals_fp32", "exp_bf16"):
                w_max, w_mean = crf_apply_err(
                    got, crf_apply_wrong(basis, coef, logc, vals, kind))
                check(w_max > K5_MAX or w_mean > K5_MEAN,
                      f"K5 V={nv}: the wrong twin {kind} lies inside the "
                      f"bounds ({w_max:.3g} / {w_mean:.3g})")
                k5["wrong_rel"][f"V={nv},{kind}"] = [w_max, w_mean]
        k5["err"] = max(k5["err"], (got - want).abs().max().item())
        k5["err_rel"][key] = [worst, mean]
        k5["ms"][key] = time_ms(
            lambda: crf_cuda.kernel_apply_cuda(basis, coef, logc, vals))
        k5["ms_back_to_back"][key] = time_ms(
            lambda: crf_cuda.kernel_apply_cuda(basis, coef, logc, vals),
            back_to_back=True)
        k5["plain_ms"][key] = time_ms(
            lambda: crf_cuda.kernel_apply_ref(basis, coef, logc, vals))
    del basis, coef, logc, vals, got, want, part
    print(f"[K5 crf_apply] max_abs_err {k5['err']:.4g} | error over the "
          f"column scale (max, mean; bounds {K5_MAX}, {K5_MEAN}) "
          f"{json.dumps(k5['err_rel'])} | wrong twins, each outside "
          f"{json.dumps(k5['wrong_rel'])} | every 32-column slice bit-equal "
          f"to a call on it alone | kernel ms {json.dumps(k5['ms'])} | back "
          f"to back {json.dumps(k5['ms_back_to_back'])} | plain ms "
          f"{json.dumps(k5['plain_ms'])}", flush=True)

    # -- 5. the slice ------------------------------------------------------------
    from PIL import Image

    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.engine.serve import (Batcher, InferenceSession,
                                             make_http_server)
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent

    cfg = voc_config()   # deit_base_patch16, 21 classes, crop 448, bf16 compute
    check(cfg.model.backbone == "deit_base_patch16"
          and cfg.data.crop_size == 448 and cfg.num_classes == 21,
          "voc_config() is not the ViT-B/16 VOC recipe")
    t0 = time.perf_counter()
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    session = InferenceSession.from_model(
        cfg, model, device=dev, batch_size=8, scales=(1.0, 1.5, 1.25),
        merge="max", branch="ensemble", crf=True)
    batcher = Batcher(session, max_delay_s=0.05)
    batcher.submit(np.zeros((64, 64, 3), np.uint8)).result(timeout=600)
    setup_s = time.perf_counter() - t0

    rs = np.random.RandomState(0)
    sizes = [(375, 500), (500, 333), (281, 500), (448, 448), (333, 500),
             (500, 375), (120, 160), (480, 640), (366, 500), (500, 400),
             (224, 300), (375, 500), (400, 300), (500, 500), (260, 390),
             (338, 450)]
    bodies = []
    for i, (h, w) in enumerate(sizes):
        yy_, xx_ = np.mgrid[0:h, 0:w]
        arr = np.stack([(xx_ * (1 + i)) % 256, (yy_ * 3) % 256,
                        ((xx_ + yy_) // 4) % 256], -1).astype(np.float32)
        arr[h // 4:h // 2, w // 3:2 * w // 3] = rs.randint(0, 256, 3)
        arr = np.clip(arr + rs.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        fmt = "JPEG" if i % 2 == 0 else "PNG"
        Image.fromarray(arr).save(buf, format=fmt)
        bodies.append((buf.getvalue(), f"image/{fmt.lower()}", (h, w)))

    server = make_http_server(batcher, "127.0.0.1", 0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/segment"

    def post(item):
        body, ctype, hw = item
        req = urllib.request.Request(url, data=body, method="POST", headers={
            "Content-Type": ctype, "Accept": "application/x-npy"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, blob = r.status, r.read()
        return status, np.load(io.BytesIO(blob)), hw, time.perf_counter() - t

    def http_round():
        """All requests at once from concurrent clients; every answer must
        be a 200 label map of its input's size with VOC labels."""
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            results = list(pool.map(post, bodies))
        wall = time.perf_counter() - t
        for status, lab, hw, _ in results:
            check(status == 200, f"HTTP {status}")
            check(lab.shape == hw, f"label map {lab.shape} for an image of {hw}")
            check(lab.dtype == np.uint8 and int(lab.max()) <= 20,
                  f"labels out of range: max {lab.max()}")
        return sorted(r[3] for r in results), wall

    try:
        # the first round through the HTTP stack pays one-time host costs
        # (~0.5 s before the first decode finishes); the second is measured
        http_round()
        before = batcher.stats()
        attention.exp_attention_cuda.launches = 0
        crf_cuda.kernel_apply_cuda.launches = 0
        gelu.gelu_erf_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        lat, wall = http_round()
        launches = {"exp_attention": attention.exp_attention_cuda.launches,
                    "crf_apply": crf_cuda.kernel_apply_cuda.launches,
                    "gelu_erf": gelu.gelu_erf_cuda.launches}
        after = batcher.stats()
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        srv_thread.join(timeout=10)
    check(launches["exp_attention"] > 0 and launches["crf_apply"] > 0
          and launches["gelu_erf"] == launches["exp_attention"],
          f"a kernel of the path never launched, or G not once a block: "
          f"{launches}")
    dispatches = after["dispatches"] - before["dispatches"]
    dispatch_ms = 1e3 * (after["dispatch_seconds"]
                         - before["dispatch_seconds"]) / dispatches
    print(f"[slice] ViT-B/16 dual student, crop 448, batch 8, MSC 1.0/1.5/1.25 "
          f"x flip, ensemble, fast CRF | {len(lat)} requests all 200 (second "
          f"round) | {len(lat) / wall:.3f} img/s | p50 latency "
          f"{1e3 * statistics.median(lat):.1f} ms | max latency "
          f"{1e3 * lat[-1]:.1f} ms | dispatches {dispatches}, "
          f"{dispatch_ms:.1f} ms each | peak memory {peak / 2**30:.3f} GiB | "
          f"launches {json.dumps(launches)} | setup {setup_s:.1f} s",
          flush=True)

    # -- 6. card against CPU -------------------------------------------------------
    # Same weights, crop 224, batch 1.  The card runs K1 (max-free exp softmax,
    # bf16 probabilities) and K5; the CPU runs exact softmax and the plain CRF
    # tile loop; both compute in bf16 as the recipe says, rounding at slightly
    # different places.  Bounds: ensemble logits within 5e-2 of their scale;
    # labels before and after the CRF at least 98% equal.
    from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
    from dupl_tpu_torch.ops import image as image_ops

    img224 = np.array(Image.open(io.BytesIO(bodies[0][0])).convert("RGB")
                      .resize((224, 224), Image.BILINEAR))[None]

    def forward(device):
        m = model.to(device)
        x, image01 = image_ops.prepare_inputs(torch.from_numpy(img224).to(device))
        with torch.inference_mode():
            seg = msc_seg_logits(lambda z: m(z).seg, x, (224, 224),
                                 (1.0, 1.5, 1.25), "max", batch_dims=2)
            logits = seg.mean(0)
            lab = crf.crf_from_config(image01, torch.softmax(logits, -1),
                                      cfg.crf, fast=True,
                                      return_logits=True).argmax(-1)
        return logits.float().cpu(), lab.cpu()

    attention.exp_attention_cuda.launches = 0
    g_logits, g_lab = forward(dev)
    check(attention.exp_attention_cuda.launches > 0,
          "the card forward did not run K1")
    c_logits, c_lab = forward(torch.device("cpu"))
    err = (g_logits - c_logits).abs().max().item()
    scale = c_logits.abs().max().item()
    raw_agree = (g_logits.argmax(-1) == c_logits.argmax(-1)).float().mean().item()
    crf_agree = (g_lab == c_lab).float().mean().item()
    check(bool(torch.isfinite(g_logits).all()), "non-finite logits on the card")
    check(err <= 5e-2 * scale, f"card vs CPU logits: {err:.4g} > 5e-2 x {scale:.4g}")
    check(raw_agree >= 0.98 and crf_agree >= 0.98,
          f"card vs CPU label agreement {raw_agree:.4f} / CRF {crf_agree:.4f}")
    print(f"[card vs cpu] crop 224 batch 1 | logits max abs err {err:.4g} "
          f"(scale {scale:.4g}, bound 5e-2 of it) | argmax agreement "
          f"{raw_agree:.4f} | CRF label agreement {crf_agree:.4f}", flush=True)

    # -- 6b. COCO serving --------------------------------------------------------------
    # ``make_serving_fn`` of the COCO recipe (81 classes, ViT-B/16 dual
    # student, weights from seed 6) at full width: batch 2, crop 448, scales
    # 1.0 / 1.5 / 1.25 x flip, sum merge as tools/serve_torch.py sets it for
    # COCO, the fast CRF on the card, whose value columns are the 81 class
    # probabilities and the cell count: K5 at V 82.  Passes if the labels are
    # well formed and K5 launched at V 82.
    from dupl_tpu_torch.config import coco_config
    from dupl_tpu_torch.engine.export import make_serving_fn

    ccfg = coco_config()
    check(ccfg.model.backbone == "deit_base_patch16" and ccfg.num_classes == 81
          and ccfg.data.crop_size == 448, "coco_config() is not the ViT-B/16 "
          "COCO recipe")
    cmodel = DualStudent(ccfg.model)
    init_weights(cmodel, torch.Generator().manual_seed(6))
    coco_fn = make_serving_fn(ccfg, cmodel.to(dev).eval(), merge="sum")
    imgs6 = torch.from_numpy(np.stack([np.asarray(
        Image.open(io.BytesIO(bodies[i][0])).convert("RGB").resize(
            (448, 448), Image.BILINEAR)) for i in (0, 3)])).to(dev)
    # the dispatcher ops/crf.py calls, wrapped to record the width it hands
    # the kernel; the kernel's own counter counts the launches
    plain_apply, widths6 = crf_cuda.kernel_apply, []

    def width_apply(*a, **kw):
        widths6.append(a[3].shape[2])
        return plain_apply(*a, **kw)

    coco_fn(imgs6)                     # first use
    torch.cuda.synchronize()
    crf_cuda.kernel_apply = width_apply
    crf_cuda.kernel_apply_cuda.launches = 0
    attention.exp_attention_cuda.launches = 0
    try:
        t = time.perf_counter()
        labels6 = coco_fn(imgs6)
        torch.cuda.synchronize()
        coco_s = time.perf_counter() - t
    finally:
        crf_cuda.kernel_apply = plain_apply
    k5_coco = crf_cuda.kernel_apply_cuda.launches
    k1_coco = attention.exp_attention_cuda.launches
    check(labels6.shape == (2, 448, 448) and labels6.dtype == torch.uint8
          and int(labels6.max()) < 81, f"COCO labels {tuple(labels6.shape)} "
          f"{labels6.dtype} max {int(labels6.max())}")
    check(k5_coco == len(widths6) > 0 and set(widths6) == {82},
          f"COCO serving: K5 launches {k5_coco} at V {widths6}")
    print(f"[COCO serving] make_serving_fn(coco_config()), ViT-B/16, 81 "
          f"classes, batch 2, crop 448, MSC 1.0/1.5/1.25 x flip, sum merge, "
          f"fast CRF | {1e3 * coco_s:.1f} ms | labels (2, 448, 448) uint8, "
          f"{len(torch.unique(labels6))} classes present | K5 launches "
          f"{k5_coco} at V {sorted(set(widths6))}, K1 {k1_coco}", flush=True)
    del cmodel, coco_fn, imgs6, labels6
    torch.cuda.empty_cache()

    # -- 7. K3 against its twin ------------------------------------------------------
    # Tolerance: 1e-5 absolute on values in [0, 1.01].  Kernel and twin run
    # the same fp32 operations in the same order (the kernel's sums use
    # __fmul_rn/__fadd_rn, so nvcc cannot contract them), so even where var =
    # sum x^2 - K mean^2 cancels on a flat neighbourhood they round alike;
    # only exp, the order of the softmax sum and the reciprocals (1/3,
    # 1/sum) differ, by ulps.  The bound sits well below the position term
    # (up to ~8e-4 a tap), and on the smooth and uint8 images each wrong
    # twin of par_affinity_wrong (w2 halved, reflect padding, the biased
    # std, sum x^2 by FMA) must fall outside it; two calls give the same
    # bits.
    b7, h7 = 16, 224
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h7, device=dev),
                            torch.linspace(0, 1, h7, device=dev), indexing="ij")
    smooth = torch.stack([0.5 + 0.4 * torch.sin(5 * xx + 3 * yy), yy,
                          0.3 + 0.5 * xx * yy], -1).expand(b7, h7, h7, 3)
    smooth = (smooth + 0.002 * torch.randn(b7, h7, h7, 3, generator=g,
                                           device=dev)).clamp(0, 1)
    images7 = {
        "smooth": smooth.contiguous(),
        "noisy": torch.rand(b7, h7, h7, 3, generator=g, device=dev),
        "uint8": (smooth * 255).round() / 255,
        "ragged": torch.rand(3, 37, 53, 3, generator=g, device=dev),
    }
    k3 = {"err": 0.0, "ms": {}, "ms_back_to_back": {}, "plain_ms": {},
          "wrong_err": {}}
    for name, img in images7.items():
        got = par_cuda.affinity_cuda(img)
        torch.cuda.synchronize()
        want = par_cuda.affinity_ref(img)
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        check(err <= 1e-5, f"K3 {name}: error {err:.3g} exceeds 1e-5")
        check(bool(torch.equal(got, par_cuda.affinity_cuda(img))),
              f"K3 {name}: two calls differ")
        k3["err"] = max(k3["err"], err)
        if name in ("smooth", "uint8"):
            for kind in ("w2_half", "reflect_pad", "biased_std", "fma_var"):
                werr = (par_affinity_wrong(img, kind) - got).abs().max().item()
                check(werr > 1e-5, f"K3 {name}: the wrong twin {kind} lies "
                      f"within 1e-5 ({werr:.3g})")
                k3["wrong_err"][f"{name},{kind}"] = werr
        if name != "ragged":
            k3["ms"][name] = time_ms(lambda: par_cuda.affinity_cuda(img))
            k3["ms_back_to_back"][name] = time_ms(
                lambda: par_cuda.affinity_cuda(img), back_to_back=True)
            k3["plain_ms"][name] = time_ms(lambda: par_cuda.affinity_ref(img))
    aff40 = par_cuda.affinity_cuda(images7["uint8"])    # feeds phase 8
    # past the cap: K3's global-memory instantiation at each set of
    # P7_PAST_CAP on the uint8 image, at the same bound, the same bits twice
    k3["past_cap"], aff_wide = {}, {}
    for dil in P7_PAST_CAP:
        img = images7["uint8"]
        got = par_cuda.affinity_cuda(img, dil)
        torch.cuda.synchronize()
        err = (got - par_cuda.affinity_ref(img, dil)).abs().max().item()
        key = ",".join(map(str, dil))
        check(bool(torch.isfinite(got).all()) and err <= 1e-5,
              f"K3 past the cap, dilations ({key}): error {err:.3g} (bound "
              f"1e-5)")
        check(bool(torch.equal(got, par_cuda.affinity_cuda(img, dil))),
              f"K3 past the cap ({key}): two calls differ")
        taps = 8 * len(dil)
        k3["past_cap"][key] = {
            "err": err,
            "ms": time_ms(lambda: par_cuda.affinity_cuda(img, dil)),
            "ms_back_to_back": time_ms(lambda: par_cuda.affinity_cuda(
                img, dil), back_to_back=True),
            "plain_ms": time_ms(lambda: par_cuda.affinity_ref(img, dil),
                                iters=3),
            "bound_ms": bound_ms(20 * taps * b7 * h7 * h7, "fp32",
                                 b7 * h7 * h7 * (12 + 4 * taps))}
        aff_wide[dil] = got
    del images7, smooth, got, want
    k3_share = bound_ms(0, "fp32", 16 * 224 * 224 * (12 + 4 * 48))[0] / \
        k3["ms"]["uint8"]
    print(f"[K3 par_affinity] max_abs_err {k3['err']:.4g} (bound 1e-5), the "
          f"same bits twice | wrong twins, each outside "
          f"{json.dumps(k3['wrong_err'])} | B=16, 224^2, 48 taps | kernel ms "
          f"{json.dumps(k3['ms'])} | back to back "
          f"{json.dumps(k3['ms_back_to_back'])} | share of the bound (uint8, "
          f"one call) {k3_share:.3f} | plain ms "
          f"{json.dumps(k3['plain_ms'])} | past the cap (global-memory "
          f"instantiation, uint8 image; err, ms one call / back to back, "
          f"bound, twin) " + "; ".join(
              f"({k_}): {v_['err']:.3g}, {v_['ms']:.3f} / "
              f"{v_['ms_back_to_back']:.3f}, {v_['bound_ms'][0]:.3f}, "
              f"{v_['plain_ms']:.2f}" for k_, v_ in k3["past_cap"].items()),
          flush=True)

    # -- 8. K4 against its twin ------------------------------------------------------
    # Peaked posteriors (softmax of 3x Gaussian logits) over the uint8 image's
    # affinity, 10 rounds.  fp32: within 1e-5 of the output's scale (kernel
    # FMAs against the twin's separate multiply and add).  bf16: within two
    # bf16 ulps of each element.  Kernel and twin round every product and
    # partial sum to bf16 alike; a kernel that skips the rounding of the
    # staged mask, of the products or of the group sums lands 3-17 ulps
    # away after 10 rounds (simulated on the CPU twin).
    k4 = {"err": {}, "ms": {}, "ms_back_to_back": {}, "plain_ms": {}}
    ragged_img = torch.rand(3, 37, 53, 3, generator=g, device=dev)
    for c, cdt, img_aff in ((40, "float32", aff40), (40, "bfloat16", aff40),
                            (84, "float32", aff40),
                            (5, "float32", par_cuda.affinity_cuda(ragged_img))):
        shape = (img_aff.shape[0], img_aff.shape[2], img_aff.shape[3], c)
        masks = torch.softmax(3 * torch.randn(shape, generator=g, device=dev), -1)
        m_in = masks.permute(0, 3, 1, 2).contiguous()
        a_in = img_aff.to(getattr(torch, cdt))
        got = par_cuda.propagate_cuda(m_in, a_in).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        want = par_cuda.propagate_ref(masks, img_aff, compute_dtype=cdt)
        err = (got - want).abs()
        key = f"B={shape[0]},{shape[1]}x{shape[2]},C={c},{cdt}"
        check(bool(torch.isfinite(got).all()), f"K4 {key}: non-finite")
        if cdt == "float32":
            bound = 1e-5 * want.abs().max().item()
            check(err.max().item() <= bound,
                  f"K4 {key}: error {err.max().item():.3g} > {bound:.3g}")
        else:
            ulps = (err / bf16_ulp(want.abs())).max().item()
            check(ulps <= 2.0, f"K4 {key}: error {err.max().item():.3g}, "
                  f"{ulps:.2f} bf16 ulps of its element (bound 2)")
        k4["err"][key] = err.max().item()
        if shape[0] == 16:
            k4["ms"][key] = time_ms(lambda: par_cuda.propagate_cuda(m_in, a_in))
            k4["ms_back_to_back"][key] = time_ms(
                lambda: par_cuda.propagate_cuda(m_in, a_in), back_to_back=True)
            k4["plain_ms"][key] = time_ms(
                lambda: par_cuda.propagate_ref(masks, img_aff,
                                               compute_dtype=cdt), iters=3,
                warmup=1)
        del masks, m_in, a_in, got, want, err
    del aff40
    # past the cap: K4's global-memory instantiation on K3's affinities of
    # each set, C 40, fp32 and bf16, 10 rounds, at the bounds above
    k4["past_cap"] = {}
    for dil, img_aff in aff_wide.items():
        shape = (img_aff.shape[0], img_aff.shape[2], img_aff.shape[3], 40)
        masks = torch.softmax(3 * torch.randn(shape, generator=g, device=dev),
                              -1)
        m_in = masks.permute(0, 3, 1, 2).contiguous()
        for cdt in ("float32", "bfloat16"):
            a_in = img_aff.to(getattr(torch, cdt))
            n0 = par_cuda.propagate_cuda.launches
            got = par_cuda.propagate_cuda(m_in, a_in, dil).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            want = par_cuda.propagate_ref(masks, img_aff, dil,
                                          compute_dtype=cdt)
            err = (got - want).abs()
            key = f"({','.join(map(str, dil))}),C=40,{cdt}"
            if cdt == "float32":
                ok = err.max().item() <= 1e-5 * want.abs().max().item()
            else:
                ok = (err / bf16_ulp(want.abs())).max().item() <= 2.0
            check(ok and par_cuda.propagate_cuda.launches == n0 + 10,
                  f"K4 past the cap {key}: error {err.max().item():.3g}")
            taps = 8 * len(dil)
            pix = shape[0] * shape[1] * shape[2]
            k4["past_cap"][key] = {
                "err": err.max().item(),
                "ms": time_ms(lambda: par_cuda.propagate_cuda(m_in, a_in,
                                                               dil)),
                "plain_ms": time_ms(lambda: par_cuda.propagate_ref(
                    masks, img_aff, dil, compute_dtype=cdt), iters=1,
                    warmup=0),
                "bound_ms": bound_ms(
                    10 * 2 * taps * pix * 40 / (2 if cdt == "bfloat16" else 1),
                    "fp32", 10 * (4 * pix * 2 * 40
                                  + pix * taps * a_in.element_size()))}
            del a_in, got, want, err
        del masks, m_in
    del aff_wide
    print(f"[K4 par_propagate] max_abs_err {json.dumps(k4['err'])} | 10 rounds "
          f"| kernel ms {json.dumps(k4['ms'])} | back to back "
          f"{json.dumps(k4['ms_back_to_back'])} | plain ms "
          f"{json.dumps(k4['plain_ms'])} | past the cap (global-memory "
          f"instantiation, 10 rounds; err, ms, bound, twin) " + "; ".join(
              f"{k_}: {v_['err']:.3g}, {v_['ms']:.3f}, "
              f"{v_['bound_ms'][0]:.3f}, {v_['plain_ms']:.1f}"
              for k_, v_ in k4["past_cap"].items()), flush=True)

    # -- 9. the pseudo-label slice ---------------------------------------------------
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.engine.profile import pseudo_label_inputs

    def on(device, *arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    model.to(dev)
    pl_fn = make_pseudo_label_fn(cfg, model)
    args9 = on(dev, *pseudo_label_inputs(16, 448, seed=1))
    for _ in range(2):
        pl_fn(*args9)
    torch.cuda.synchronize()
    counters = (attention.exp_attention_cuda, crf_cuda.kernel_apply_cuda,
                par_cuda.affinity_cuda, par_cuda.propagate_cuda)
    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        refined, crf_labels = pl_fn(*args9)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    pl_launches = dict(zip(("exp_attention", "crf_apply", "par_affinity",
                            "par_propagate"), (f.launches for f in counters)))
    peak9 = torch.cuda.max_memory_allocated()
    check(all(n > 0 for n in pl_launches.values()),
          f"a kernel of the pseudo-label path never launched: {pl_launches}")

    def check_labels(refined, crf_labels, b, size, what):
        check(refined.shape == (2, b, size, size) and refined.dtype == torch.uint8,
              f"{what}: refined {tuple(refined.shape)} {refined.dtype}")
        vals = set(torch.unique(refined).tolist())
        check(vals <= set(range(21)) | {cfg.ignore_index},
              f"{what}: refined values {sorted(vals)}")
        check(cfg.ignore_index in vals, f"{what}: no ignore band")
        check(crf_labels.shape == (b, size, size)
              and crf_labels.dtype == torch.uint8
              and int(crf_labels.max()) <= 20,
              f"{what}: crf labels {tuple(crf_labels.shape)} max "
              f"{int(crf_labels.max())}")

    check_labels(refined, crf_labels, 16, 448, "pseudo-label slice")
    # The fallback: image 3 gets 12 present classes, so the whole batch runs
    # PAR on the full class axis (C = 84).  Every channel propagates on its
    # own and the compaction is exact, so the other images' labels must
    # match the compact call's, and the CRF labels (which ignore the class
    # labels) all of them.
    img9, cls9, box9 = pseudo_label_inputs(16, 448, seed=1)
    cls9[3, :12] = 1
    for f in counters:
        f.launches = 0
    fb_refined, fb_crf = pl_fn(*on(dev, img9, cls9, box9))
    fb_launches = par_cuda.propagate_cuda.launches
    check(fb_launches == cfg.par.num_iter,
          f"fallback call: K4 launched {fb_launches} times")
    check_labels(fb_refined, fb_crf, 16, 448, "fallback call")
    others = [i for i in range(16) if i != 3]
    fb_agree = (fb_refined[:, others] == refined[:, others]).float().mean().item()
    check(fb_agree >= 0.999 and bool((fb_crf == crf_labels).all()),
          f"fallback call: refined labels of the other images agree with the "
          f"compact call on {fb_agree:.5f}")
    del args9, refined, crf_labels, fb_refined, fb_crf
    med9 = statistics.median(times)
    print(f"[pseudo-label slice] ViT-B/16 dual student, crop 448, batch 16, CAM "
          f"scales {tuple(cfg.cam_scales)} x flip, PAR 224^2 x 10 rounds "
          f"(class budget {cfg.par.class_budget}, fp32), fast CRF | median "
          f"{1e3 * med9:.1f} ms of 5 ({', '.join(f'{1e3 * t:.1f}' for t in times)}) "
          f"| {16 / med9:.3f} img/s | peak memory {peak9 / 2**30:.3f} GiB | "
          f"launches {json.dumps(pl_launches)} | fallback call: K4 "
          f"{fb_launches} launches at C = 84, other images' labels agree "
          f"{fb_agree:.5f}", flush=True)

    # -- 10. pseudo-label path, card against CPU -----------------------------------------
    # Same weights, crop 224, batch 2, once within the class budget and once
    # past it (image 1 with 12 present classes: the full class axis).  The
    # card runs K1 (max-free exp softmax, bf16 probabilities), K3, K4 and K5;
    # the CPU runs exact softmax and the plain twins; both compute in bf16 as
    # the recipe says.  Bound: refined and CRF labels at least 98% equal.
    args10 = pseudo_label_inputs(2, 224, seed=2)
    fb10 = tuple(a.copy() for a in args10)
    fb10[1][1, :12] = 1
    on_card = [tuple(t.cpu() for t in pl_fn(*on(dev, *a)))
               for a in (args10, fb10)]
    model.to("cpu")
    cpu_fn = make_pseudo_label_fn(cfg, model)
    agree10 = {}
    for name, a, (g_ref, g_crf) in zip(("compact", "fallback"),
                                       (args10, fb10), on_card):
        c_ref, c_crf = cpu_fn(*on("cpu", *a))
        agree10[name] = ((g_ref == c_ref).float().mean().item(),
                         (g_crf == c_crf).float().mean().item())
        check(min(agree10[name]) >= 0.98,
              f"card vs CPU ({name}): refined agreement "
              f"{agree10[name][0]:.4f}, CRF {agree10[name][1]:.4f}")
    print("[pseudo-label card vs cpu] crop 224 batch 2 | " + " | ".join(
        f"{name}: refined label agreement {r:.4f}, CRF label agreement {c:.4f}"
        for name, (r, c) in agree10.items()), flush=True)

    # -- 11. K2 against its twin ------------------------------------------------------
    # Error in bf16 ulps of each output row's scale (max |row| over the head
    # dim).  Kernel and twin round the same fp32 quantities to bf16 (ds before
    # both of its products, p for dv, the results once) and sum in different
    # orders.  Bounds: 2 ulps at the maximum and 0.01 ulp on average.  With
    # scores past the clamp the rows are nearly one-hot, t - delta cancels
    # and the two summation orders differ by more (bound 64 at the maximum).
    # Three wrong twins (chip_smoke.exp_attn_bwd_wrong: no delta, ds left in
    # fp32, no clamp mask) must fall outside the bounds, and two calls on the
    # same operands must give the same bits.  Then the edges of the 64-row
    # tiles and 128-row blocks (N 127-129, 255-257, 895-897) for every head
    # dim.
    k2 = {"err": 0.0, "ulps": {}, "wrong": {}, "edges": {}, "ms": {},
          "ms_back_to_back": {}, "host_us": {}, "plain_ms": {},
          "library_ms": {}}
    for b, n, h, d, mult in [(4, 785, 12, 64, 1.0), (4, 442, 12, 64, 1.0),
                             (2, 300, 4, 16, 1.0), (2, 257, 4, 32, 1.0),
                             (2, 200, 2, 80, 1.0), (2, 442, 12, 64, 24.0)]:
        qs, k, v, go = qkvg(b, n, h, d, mult)
        check(not k.is_contiguous(), "K2: k should be a strided view")
        got = attention.exp_attention_bwd_cuda(qs, k, v, go)
        again = attention.exp_attention_bwd_cuda(qs, k, v, go)
        torch.cuda.synchronize()
        key = f"B={b},N={n},H={h},D={d}" + ("" if mult == 1.0 else f",q x{mult}")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"K2 {key}: two calls on the same operands differ")
        del again
        ops = tuple(attention._to_bhnd(x) for x in (qs, k, v, go))
        want = attention.exp_attention_bwd_ref(*ops)
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            check(bool(torch.isfinite(x.float()).all()),
                  f"K2 {key}: non-finite {name}")
            k2["err"] = max(k2["err"], (attention._to_bhnd(x).float()
                                        - w.float()).abs().max().item())
        worst, mean = bwd_ulps(got, want)
        k2["ulps"][key] = [worst, mean]
        check(worst <= (2.0 if mult == 1.0 else 64.0) and mean <= 0.01,
              f"K2 {key}: {worst:.3g} bf16 ulps of the row at the maximum, "
              f"{mean:.3g} on average")
        kinds = (("no_delta", "ds_fp32") if (n, mult) == (785, 1.0) else
                 ("no_clamp_mask",) if mult != 1.0 else ())
        for kind in kinds:
            w_max, w_mean = bwd_ulps(got, exp_attn_bwd_wrong(*ops, kind))
            k2["wrong"][kind] = [w_max, w_mean]
            check(w_max > (2.0 if mult == 1.0 else 64.0) or w_mean > 0.01,
                  f"K2: the bounds do not tell the wrong twin {kind!r} "
                  f"({w_max:.3g} at the maximum, {w_mean:.3g} on average)")
        if d == 64 and mult == 1.0:
            k2["ms"][key] = time_ms(
                lambda: attention.exp_attention_bwd_cuda(qs, k, v, go))
            k2["ms_back_to_back"][key] = time_ms(
                lambda: attention.exp_attention_bwd_cuda(qs, k, v, go),
                back_to_back=True)
            k2["host_us"][key] = host_us(
                lambda: attention.exp_attention_bwd_cuda(qs, k, v, go))
            k2["plain_ms"][key] = time_ms(
                lambda: attention.exp_attention_bwd_ref(*ops))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):   # backward runs on this stream
                ql, kl, vl = (x.permute(0, 2, 1, 3).detach().clone()
                              .requires_grad_() for x in (qs, k, v))
                out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0)
                gl = go.permute(0, 2, 1, 3).contiguous()
            k2["library_ms"][key] = graph_ms(lambda: torch.autograd.grad(
                out, (ql, kl, vl), gl, retain_graph=True), side)
            del ql, kl, vl, out, gl, side
        del qs, k, v, go, got, want, ops
    for d in (16, 32, 64, 80):
        for n in (127, 128, 129, 255, 256, 257, 895, 896, 897):
            qs, k, v, go = qkvg(1, n, 2, d, 1.0)
            got = attention.exp_attention_bwd_cuda(qs, k, v, go)
            torch.cuda.synchronize()
            worst, mean = bwd_ulps(got, attention.exp_attention_bwd_ref(
                *(attention._to_bhnd(x) for x in (qs, k, v, go))))
            k2["edges"][f"D={d},N={n}"] = [round(worst, 3), round(mean, 6)]
            check(worst <= 2.0 and mean <= 0.01,
                  f"K2 at the tile edge D {d}, N {n}: {worst:.3g} bf16 ulps "
                  f"of the row at the maximum, {mean:.3g} on average")
    del qs, k, v, go, got
    print(f"[K2 exp_attention_bwd] max_abs_err {k2['err']:.4g} | bf16 ulps of "
          f"the row [max, mean] {json.dumps(k2['ulps'])} (bounds 2, or 64 "
          f"past the clamp, and 0.01) | wrong twins {json.dumps(k2['wrong'])} "
          f"(each outside) | bit-equal from call to call | tile edges "
          f"{json.dumps(k2['edges'])} | kernel ms {json.dumps(k2['ms'])}, back "
          f"to back {json.dumps(k2['ms_back_to_back'])}, host us a call "
          f"{json.dumps(k2['host_us'])} | plain ms {json.dumps(k2['plain_ms'])} "
          f"| library (backward of F.scaled_dot_product_attention, replayed as "
          f"a CUDA graph) ms {json.dumps(k2['library_ms'])}", flush=True)

    # -- 12. the training slice ------------------------------------------------------
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import (Trainer, phase_of, phase_start,
                                             production_config)

    del model, pl_fn, cpu_fn, session
    torch.cuda.empty_cache()
    tcfg = production_config("voc")
    check(tcfg.model.backbone == "deit_base_patch16"
          and tcfg.data.crop_size == 448
          and tcfg.model.cam_stream_dtype == "bfloat16"
          and tcfg.cam_merge_downscale == 2,
          "production_config() is not the ViT-B/16 training recipe")
    trainer = Trainer(tcfg, device=dev)
    state = trainer.init_state()
    batch12 = trainer.put(synthetic_batch(4, crop=448,
                                          num_fg=tcfg.model.num_fg))

    # A plain twin must never see a CUDA tensor: count such calls.
    twins = [(attention, "exp_attention_ref"),
             (attention, "exp_attention_bwd_ref"),
             (par_cuda, "affinity_ref"), (par_cuda, "propagate_ref"),
             (crf_cuda, "kernel_apply_ref"), (gelu, "gelu_erf_ref"),
             (gelu, "gelu_erf_bwd_ref")]
    twin_calls = []

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                twin_calls.append(name)
            return fn(*a, **kw)
        return fn, wrapped

    train_counters = {"exp_attention": attention.exp_attention_cuda,
                      "exp_attention_bwd": attention.exp_attention_bwd_cuda,
                      "par_affinity": par_cuda.affinity_cuda,
                      "par_propagate": par_cuda.propagate_cuda}
    # per student: scale 1.0 with grad and its flip without, scales 0.5 and
    # 1.5 with their flips in one batch, and in the full phase the strong
    # view with grad; 12 blocks each, two students
    expected = {
        "warmup": {"exp_attention": 96, "exp_attention_bwd": 24,
                   "par_affinity": 0, "par_propagate": 0},
        "seg": {"exp_attention": 96, "exp_attention_bwd": 24,
                "par_affinity": 1, "par_propagate": tcfg.par.num_iter},
        "full": {"exp_attention": 120, "exp_attention_bwd": 48,
                 "par_affinity": 1, "par_propagate": tcfg.par.num_iter},
    }
    originals = []
    for mod, name in twins:
        fn, wrapped = counting(mod, name)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)

    # The operands PAR hands K3 and K4 in a training step, kept from the seg
    # phase's untimed step and held against the twins below.
    par_operands = {}

    def keeping(name):
        fn = getattr(par_cuda, name)

        def wrapped(*a):
            par_operands[name] = tuple(
                x.detach().clone() if isinstance(x, torch.Tensor) else x
                for x in a)
            return fn(*a)
        return fn, wrapped

    train12 = {}
    try:
        for phase in ("warmup", "seg", "full"):
            state.step = state.optimizer.global_step = phase_start(tcfg, phase)
            check(phase_of(tcfg, state.step) == phase, f"step is not in {phase}")
            before12 = {n_: p_.detach().clone()
                        for n_, p_ in state.model.named_parameters()}
            kept = [("affinity",) + keeping("affinity"),
                    ("propagate",) + keeping("propagate")] if phase == "seg" else []
            for name, _, wrapped in kept:
                setattr(par_cuda, name, wrapped)
            try:
                trainer.train_step(state, batch12)
            finally:
                for name, fn, _ in kept:
                    setattr(par_cuda, name, fn)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times12 = []
            for _ in range(3):
                for f in train_counters.values():
                    f.launches = 0
                gelu.gelu_erf_cuda.launches = 0
                gelu.gelu_erf_bwd_cuda.launches = 0
                t = time.perf_counter()
                # no host sync inside a step: PyTorch raises on any of its
                # own calls that would wait for the device
                torch.cuda.set_sync_debug_mode("error")
                try:
                    _, metrics12 = trainer.train_step(state, batch12)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                times12.append(time.perf_counter() - t)
                step_launches = {k_: f.launches
                                 for k_, f in train_counters.items()}
                check(step_launches == expected[phase],
                      f"{phase}: launches a step {step_launches}, expected "
                      f"{expected[phase]}")
                # G once a block and forward pass (every pass here has 128
                # tokens or more, so as K1), its backward as K2
                g_launches = {"gelu_erf": gelu.gelu_erf_cuda.launches,
                              "gelu_erf_bwd": gelu.gelu_erf_bwd_cuda.launches}
                check(g_launches == {
                    "gelu_erf": expected[phase]["exp_attention"],
                    "gelu_erf_bwd": expected[phase]["exp_attention_bwd"]},
                      f"{phase}: G launches a step {g_launches}")
            losses12 = {k_: v_.item() for k_, v_ in metrics12.items()}
            check(all(np.isfinite(v_) for v_ in losses12.values()),
                  f"{phase}: non-finite loss {losses12}")
            for n_, p_ in state.model.named_parameters():
                moved = not torch.equal(p_.detach(), before12[n_])
                frozen = "pos_embed" in n_ or (phase == "warmup"
                                               and ".decoder." in n_)
                check(moved != frozen, f"{phase}: parameter {n_} "
                      f"{'moved' if moved else 'did not move'}")
            med12 = statistics.median(times12)
            train12[phase] = {
                "ms": 1e3 * med12, "launches": step_launches,
                "launches_g": g_launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            print(f"[training slice] {phase}: ViT-B/16 dual student, crop 448, "
                  f"batch 4 | median {1e3 * med12:.1f} ms/step of 3 "
                  f"({', '.join(f'{1e3 * t:.1f}' for t in times12)}) | "
                  f"{4 / med12:.3f} img/s | peak memory "
                  f"{train12[phase]['peak_gib']:.3f} GiB | launches a step "
                  f"{json.dumps(step_launches)} | loss {losses12['loss']:.4f}",
                  flush=True)
            del before12
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")

        # -- 13. training step, card against CPU -----------------------------------
        # One full-phase grad_step from the same weights, batch and
        # augmentation draws, crop 224, batch 2, bf16 compute on both sides.
        # The card runs K1 + K2 (max-free exp softmax, bf16 probabilities and
        # ds), K3 and K4; the CPU runs exact softmax under plain autograd and
        # the PAR twins.  bf16 rounds at different places, bilinear-resize
        # backward on the card sums with atomics, and a pseudo-label pixel
        # that flips moves the seg and consistency terms; so the bounds are:
        # refined and filtered labels at least 98% equal, every loss term
        # within 2e-2 of the larger side plus 5e-3, and the gradients of each
        # group at a cosine of 0.98 (encoder) or 0.99 (heads, decoder) or
        # more.
        #
        # Two things are set so that every term is live, and each is checked
        # below.  (a) The synthetic batch's crop box starts at row 16, and the
        # PTC targets apply the box's full-resolution coordinates to the
        # 14 x 14 patch map (the reference's slice clamping), which leaves no
        # labelled patch: no pair, and a PTC term of exactly 1.  Here image 0
        # gets the whole image as its box and image 1 a box that starts
        # inside the patch map.  (b) Seeded random weights are 0.06-0.14
        # confident, never the recipe's ``reg_conf_thre`` of 0.9, which leaves
        # the consistency term at exactly 0; here the threshold is 0.08, near
        # the median, so the term has pixels and the threshold still masks.
        #
        # The labels are compared first, each side's own (at least 98%
        # equal).  Losses and gradients are then compared on shared discrete
        # intermediates: the CPU step takes the card step's PTC targets and
        # its refined and filtered labels.  These weights label 0.3-3% of
        # the pixels foreground, and the GMM filter drops the foreground
        # pixels of highest loss, so on each side's own labels the seg
        # term's foreground mean follows the ~150 pixels that differ: gaps
        # of 0.003 to 0.6 over runs and seeds with labels 99.8% equal, which
        # says nothing about the kernels.  Measured on an H100: labels 0.9980
        # equal; on shared labels the largest loss gap 0.00053 (the
        # classification term), cosines 0.99846, 1.00000 and 0.99986, the
        # strong view's backward 3.1% of the gradient's norm.
        # At this crop the scale-0.5 views (50 tokens) and the strong view
        # (168^2, 101 tokens) are below the kernels' 128 tokens and take
        # plain softmax on both sides: K1 and K2 run at 197 and 442 tokens.
        import copy

        from dupl_tpu_torch.engine.optimizer import group_of
        from dupl_tpu_torch.ops import augment

        tcfg13 = production_config("voc", reg_conf_thre=0.08)
        batch13 = synthetic_batch(2, crop=224, num_fg=tcfg.model.num_fg)
        batch13["img_box"] = np.array([[0, 224, 0, 224], [4, 224, 2, 216]],
                                      batch13["img_box"].dtype)
        step13 = phase_start(tcfg13, "full")
        ops13 = augment.draw_ops(torch.Generator().manual_seed(13),
                                 tcfg13.aug_n, 2)
        card_trainer = Trainer(tcfg13, model=state.model, device=dev)
        card_state = card_trainer.init_state(init=False)
        cpu_model = copy.deepcopy(state.model).to("cpu")
        cpu_trainer = Trainer(tcfg13, model=cpu_model, device="cpu")
        cpu_state = cpu_trainer.init_state(init=False)
        sides, shared13 = {}, {}

        def share(tr, stage, give):
            """Keep what a stage of the card's step returns, or hand it to
            the CPU's step in place of its own."""
            fn = getattr(tr, stage)

            def wrapped(*a, **kw):
                if give:
                    return shared13[stage].to(tr.device)
                shared13[stage] = fn(*a, **kw)
                return shared13[stage]
            setattr(tr, stage, wrapped)

        for name, tr, st in (("card", card_trainer, card_state),
                             ("cpu", cpu_trainer, cpu_state)):
            labels = tr.full_phase_labels(batch13, step13)
            for stage in ("_ptc_targets", "_refine", "_gmm_filter"):
                share(tr, stage, give=name == "cpu")
            for f in train_counters.values():
                f.launches = 0
            grads, metrics = tr.grad_step(st, batch13, step=step13,
                                          aug_ops=ops13.to(tr.device))
            sides[name] = ([x.cpu() for x in labels],
                           {k_: v_.float().cpu() for k_, v_ in grads.items()},
                           {k_: v_.item() for k_, v_ in metrics.items()},
                           {k_: f.launches for k_, f in train_counters.items()})
        check(sides["card"][3] == {"exp_attention": 72, "exp_attention_bwd": 24,
                                   "par_affinity": 1,
                                   "par_propagate": tcfg13.par.num_iter}
              and not any(sides["cpu"][3].values()),
              f"card vs CPU grad_step launches: card {sides['card'][3]}, "
              f"CPU {sides['cpu'][3]}")
        # The strong view's forward and backward add a gradient of their own:
        # the same step on the card without the consistency term (its only
        # consumer) must give another gradient.
        noreg_trainer = Trainer(
            production_config("voc", reg_conf_thre=0.08, w_reg=0.0),
            model=state.model, device=dev)
        noreg_grads, _ = noreg_trainer.grad_step(
            noreg_trainer.init_state(init=False), batch13, step=step13,
            aug_ops=ops13.to(dev))
        num = sum((sides["card"][1][n_].double() - g_.double().cpu())
                  .square().sum() for n_, g_ in noreg_grads.items())
        den = sum(g_.double().square().sum()
                  for g_ in sides["card"][1].values())
        strong_share = (num.sqrt() / den.sqrt()).item()
        del noreg_grads, noreg_trainer
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    # K3 and K4 against their twins on the operands of that training step:
    # 4 images at 224^2 (the 448^2 crop halved by a bilinear resize, so not
    # on the uint8 grid) and the compacted class axis in fp32.  Bounds as in
    # phases 7 and 8.
    img_t, *aff_args = par_operands["affinity"]
    masks_t, aff_t, *prop_args = par_operands["propagate"]
    check(img_t.shape == (4, 224, 224, 3) and masks_t.shape[:3] == (4, 224, 224)
          and aff_t.shape == (4, 8 * len(tcfg.par.dilations), 224, 224),
          f"training PAR operands: image {tuple(img_t.shape)}, masks "
          f"{tuple(masks_t.shape)}, affinity {tuple(aff_t.shape)}")
    got = par_cuda.affinity(img_t, *aff_args)
    want = par_cuda.affinity_ref(img_t, *aff_args)
    err3 = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and err3 <= 1e-5,
          f"K3 on the training step's image: error {err3:.3g} exceeds 1e-5")
    check(bool(torch.equal(got, aff_t)), "K3 is not repeatable on the "
          "training step's image")
    k3["err"] = max(k3["err"], err3)
    k3["ms"]["train"] = time_ms(lambda: par_cuda.affinity(img_t, *aff_args))
    k3["ms_back_to_back"]["train"] = time_ms(
        lambda: par_cuda.affinity(img_t, *aff_args), back_to_back=True)
    k3["plain_ms"]["train"] = time_ms(
        lambda: par_cuda.affinity_ref(img_t, *aff_args))
    got = par_cuda.propagate(masks_t, aff_t, *prop_args)
    want = par_cuda.propagate_ref(masks_t, aff_t, *prop_args)
    err4 = (got - want).abs().max().item()
    bound4 = 1e-5 * want.abs().max().item()
    check(prop_args[-1] == "float32", f"training PAR runs in {prop_args[-1]}")
    check(bool(torch.isfinite(got).all()) and err4 <= bound4,
          f"K4 on the training step's masks: error {err4:.3g} > {bound4:.3g}")
    key4t = f"train B=4,224x224,C={masks_t.shape[3]},float32"
    k4["err"][key4t] = err4
    k4["ms"][key4t] = time_ms(
        lambda: par_cuda.propagate(masks_t, aff_t, *prop_args))
    k4["ms_back_to_back"][key4t] = time_ms(
        lambda: par_cuda.propagate(masks_t, aff_t, *prop_args),
        back_to_back=True)
    k4["plain_ms"][key4t] = time_ms(
        lambda: par_cuda.propagate_ref(masks_t, aff_t, *prop_args), iters=3,
        warmup=1)
    print(f"[K3, K4 on a training step's operands] image {tuple(img_t.shape)}, "
          f"masks {tuple(masks_t.shape)}, {prop_args[1]} rounds | K3 "
          f"max_abs_err {err3:.4g} (bound 1e-5), kernel ms "
          f"{k3['ms']['train']:.4f}, plain ms {k3['plain_ms']['train']:.4f} | "
          f"K4 max_abs_err {err4:.4g} (bound {bound4:.4g}), kernel ms "
          f"{k4['ms'][key4t]:.4f}, plain ms {k4['plain_ms'][key4t]:.4f}",
          flush=True)
    del par_operands, img_t, masks_t, aff_t, got, want

    (g_lab, g_grads, g_m, _), (c_lab, c_grads, c_m, _) = (sides["card"],
                                                          sides["cpu"])
    agree13 = [(a == b_).float().mean().item() for a, b_ in zip(g_lab, c_lab)]
    check(min(agree13) >= 0.98, f"card vs CPU training labels: refined "
          f"{agree13[0]:.4f}, filtered {agree13[1]:.4f}")
    noise13 = ((g_lab[1] == tcfg13.ignore_index)
               & (g_lab[0] != tcfg13.ignore_index)).float().mean().item()
    fg13 = ((g_lab[1] != tcfg13.ignore_index)
            & (g_lab[1] != 0)).float().mean().item()
    pairs13 = int(((shared13["_ptc_targets"] == 0)
                   | (shared13["_ptc_targets"] == 1)).sum().item())
    check(fg13 > 0 and pairs13 > 0, f"no foreground label ({fg13:.4f} of the "
          f"pixels) or no PTC pair ({pairs13})")
    terms13 = ("cls_loss", "ptc_loss", "seg_loss", "sim_loss", "reg_loss",
               "loss")
    loss_gap = {}
    for k_ in terms13:
        check(np.isfinite(g_m[k_]), f"card {k_} is not finite")
        loss_gap[k_] = abs(g_m[k_] - c_m[k_])
        check(loss_gap[k_] <= 5e-3 + 2e-2 * max(abs(g_m[k_]), abs(c_m[k_])),
              f"card vs CPU {k_}: {g_m[k_]:.5g} vs {c_m[k_]:.5g}")
    # every term is live: PTC has pairs (it is exactly 1 without any), the
    # consistency term has pixels (0 without), and the strong view's
    # backward moves the gradient (two runs of one step differ by ~1e-6 of
    # it through the resize backward's atomics)
    for m_ in (g_m, c_m):
        check(m_["ptc_loss"] != 1.0 and m_["reg_loss"] > 0.1
              and m_["seg_loss"] > 0.1,
              f"a loss term of the card-vs-CPU step is constant: {m_}")
    check(strong_share > 1e-3, f"the strong view's backward changes the "
          f"gradient by {strong_share:.3g} of its norm")
    check(g_grads.keys() == c_grads.keys(), "card and CPU gradients differ "
          "in which parameters have one")
    cos13 = {}
    for grp, cos_bound in (("base", 0.98), ("head", 0.99), ("decoder", 0.99)):
        # float64: a float32 dot product over 86 M entries is itself
        # several percent off
        a = torch.cat([g_grads[n_].flatten() for n_ in g_grads
                       if group_of(n_) == grp]).double()
        b_ = torch.cat([c_grads[n_].flatten() for n_ in g_grads
                        if group_of(n_) == grp]).double()
        check(bool(torch.isfinite(a).all()), f"non-finite {grp} gradient")
        cos13[grp] = F.cosine_similarity(a, b_, dim=0).item()
        check(cos13[grp] >= cos_bound, f"card vs CPU gradient cosine of the "
              f"{grp} group: {cos13[grp]:.4f} < {cos_bound}")
    print(f"[training card vs cpu] crop 224 batch 2, full phase | labels equal: "
          f"refined {agree13[0]:.4f}, filtered {agree13[1]:.4f} (bound 0.98; "
          f"the GMM filter marks {noise13:.4f} of the pixels, {fg13:.4f} are "
          f"foreground, {pairs13} PTC pairs) | on the card's labels: losses "
          f"card "
          f"{json.dumps({k_: round(g_m[k_], 6) for k_ in terms13})} | cpu "
          f"{json.dumps({k_: round(c_m[k_], 6) for k_ in terms13})} | gaps "
          f"{json.dumps({k_: round(v_, 6) for k_, v_ in loss_gap.items()})} "
          f"(bound 5e-3 + 2e-2 relative) | gradient cosine "
          f"{json.dumps({k_: round(v_, 5) for k_, v_ in cos13.items()})} "
          f"(bounds 0.98, 0.99, 0.99) | the strong view's backward is "
          f"{strong_share:.4f} of the gradient's norm (bound 1e-3) | launches "
          f"of the card's step {json.dumps(sides['card'][3])}", flush=True)

    # -- 13b. the COCO training step --------------------------------------------------
    # Trainer.train_step of production_config("coco") (81 classes, aux CAMs
    # from layer 9, PAR class budget 16, weights from seed 0) at batch 4,
    # crop 448, in the seg_static phase (PAR on the aux CAMs at static
    # thresholds) and the full phase: one untimed and two timed steps each;
    # finite losses, the launches of K1-K4 a step as counted from the code
    # (phase 12's: the same CAM passes and views; K4 at C = 4 x 16 = 64, every
    # synthetic image having fewer than 16 classes), no twin on a CUDA tensor;
    # then K1, K2 and K4 against their twins on operands that the full step
    # handed them (K1's and K4's first launch, K2's launch with the largest
    # cotangent), at phases 3, 11 and 12's bounds.
    ccfg13 = production_config("coco")
    check(ccfg13.model.backbone == "deit_base_patch16"
          and ccfg13.num_classes == 81 and ccfg13.model.aux_layer == 9
          and ccfg13.par.class_budget == 16 and ccfg13.data.crop_size == 448,
          "production_config('coco') is not the ViT-B/16 COCO recipe")
    ctrainer = Trainer(ccfg13, device=dev)
    cstate = ctrainer.init_state()
    cbatch = ctrainer.put(synthetic_batch(4, crop=448,
                                          num_fg=ccfg13.model.num_fg))
    check(bool(cbatch["fits_budget"]), "the synthetic COCO batch is past the "
          "class budget")
    n_prop = ccfg13.par.num_iter
    cexpected = {
        "seg_static": {"exp_attention": 96, "exp_attention_bwd": 24,
                       "par_affinity": 1, "par_propagate": n_prop},
        "full": {"exp_attention": 120, "exp_attention_bwd": 48,
                 "par_affinity": 1, "par_propagate": n_prop},
    }
    coco_ops = {}

    def keep_operands(name, fn, operands, score):
        """``fn`` wrapped to keep in ``coco_ops[name]`` a copy of the
        tensors that ``operands`` picks from the arguments of the call that
        ``score`` ranks highest so far (ties: the first)."""
        def wrapped(*a):
            ops_ = operands(*a)
            rank = score(ops_)
            if name not in coco_ops or rank > coco_ops[name][0]:
                coco_ops[name] = (rank, tuple(
                    x.detach().clone() if isinstance(x, torch.Tensor) else x
                    for x in ops_))
            return fn(*a)
        return wrapped

    # K1 and K2 are reached through the autograd Function that pairs them
    # (their wrappers count their own launches by name, so they stay as
    # they are), PAR through the module function that dispatches K4.  K2
    # keeps the call with the largest cotangent: at random weights no pixel
    # passes the consistency loss's confidence threshold, so the strong
    # view's backward, the first K2 call of a full step, gets g = 0.
    exp_fn = attention._ExpAttention
    capture13 = [
        (exp_fn, "forward", staticmethod, lambda ctx, qs, k_, v_: (qs, k_, v_),
         lambda ops_: 0.0),
        (exp_fn, "backward", staticmethod,
         lambda ctx, g_: (*ctx.saved_tensors,
                          g_.to(torch.bfloat16).contiguous()),
         lambda ops_: ops_[3].abs().amax().item()),
        (par_cuda, "propagate", lambda f: f, lambda *a: a, lambda ops_: 0.0)]

    coco13 = {}
    twin_calls.clear()
    patched = [(mod, name) + counting(mod, name) for mod, name in twins]
    for mod, name, _, wrapped in patched:
        setattr(mod, name, wrapped)
    try:
        for phase in ("seg_static", "full"):
            cstate.step = cstate.optimizer.global_step = phase_start(ccfg13,
                                                                     phase)
            check(phase_of(ccfg13, cstate.step) == phase,
                  f"COCO: step is not in {phase}")
            kept = [(owner, n_, getattr(owner, n_), bind)
                    for owner, n_, bind, _, _ in capture13
                    ] if phase == "full" else []
            for (owner, n_, fn, bind), (*_, pick, score) in zip(kept,
                                                               capture13):
                setattr(owner, n_, bind(keep_operands(n_, fn, pick, score)))
            try:
                ctrainer.train_step(cstate, cbatch)
            finally:
                for owner, n_, fn, bind in kept:
                    setattr(owner, n_, bind(fn))
            torch.cuda.synchronize()
            times13 = []
            for _ in range(2):
                for f in train_counters.values():
                    f.launches = 0
                t = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    _, cmetrics = ctrainer.train_step(cstate, cbatch)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                times13.append(time.perf_counter() - t)
                claunches = {k_: f.launches for k_, f in train_counters.items()}
                check(claunches == cexpected[phase],
                      f"COCO {phase}: launches a step {claunches}, expected "
                      f"{cexpected[phase]}")
            closses = {k_: v_.item() for k_, v_ in cmetrics.items()}
            check(all(np.isfinite(v_) for v_ in closses.values()),
                  f"COCO {phase}: non-finite loss {closses}")
            coco13[phase] = {"ms": [1e3 * t for t in times13],
                             "launches": claunches,
                             "loss": closses["loss"],
                             "seg_loss": closses["seg_loss"]}
        check(coco13["seg_static"]["seg_loss"] > 0
              and coco13["full"]["seg_loss"] > 0,
              f"COCO: a seg phase has no seg loss {coco13}")
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    finally:
        for mod, name, fn, _ in patched:
            setattr(mod, name, fn)
    # the kernels against their twins on those operands
    cq, ck, cv = coco_ops["forward"][1]
    got = attention.exp_attention_cuda(cq, ck, cv)
    ops = tuple(attention._to_bhnd(x) for x in (cq, ck, cv))
    c1 = row_ulps(attention._to_bhnd(got),
                  attention.exp_attention_ref(*ops).to(torch.bfloat16))
    check(c1[0] <= 1.0 and c1[1] <= 1e-3, f"K1 on the COCO step's operands "
          f"{tuple(cq.shape)}: {c1[0]:.3g} bf16 ulps at the maximum, "
          f"{c1[1]:.3g} on average (bounds 1, 1e-3)")
    cq, ck, cv, cg = coco_ops["backward"][1]
    check(cg.abs().amax().item() > 0, "COCO: every K2 call had g = 0")
    got = attention.exp_attention_bwd_cuda(cq, ck, cv, cg)
    c2 = bwd_ulps(got, attention.exp_attention_bwd_ref(
        *(attention._to_bhnd(x) for x in (cq, ck, cv, cg))))
    check(c2[0] <= 2.0 and c2[1] <= 0.01, f"K2 on the COCO step's operands "
          f"{tuple(cq.shape)}: {c2[0]:.3g} bf16 ulps at the maximum, "
          f"{c2[1]:.3g} on average (bounds 2, 0.01)")
    cm, ca, *cargs = coco_ops["propagate"][1]
    check(cm.shape == (4, 224, 224, 64) and cargs[-1] == "float32",
          f"COCO PAR masks {tuple(cm.shape)} in {cargs[-1]}: want C 64, fp32")
    got = par_cuda.propagate(cm, ca, *cargs)
    want = par_cuda.propagate_ref(cm, ca, *cargs)
    c4 = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all())
          and c4 <= 1e-5 * want.abs().max().item(),
          f"K4 on the COCO step's masks: error {c4:.3g}")
    print(f"[COCO training step] production_config('coco'): ViT-B/16, 81 "
          f"classes, aux layer 9, crop 448, batch 4 | ms a step (2 timed) "
          f"{json.dumps({k_: [round(t, 1) for t in v_['ms']] for k_, v_ in coco13.items()})} "
          f"| loss {json.dumps({k_: round(v_['loss'], 4) for k_, v_ in coco13.items()})} "
          f"| launches a step {json.dumps({k_: v_['launches'] for k_, v_ in coco13.items()})} "
          f"| on the full step's operands: K1 {tuple(coco_ops['forward'][1][0].shape)} "
          f"{c1[0]:.3g} / {c1[1]:.3g} ulps (max / mean), K2 {c2[0]:.3g} / "
          f"{c2[1]:.3g}, K4 at C {cm.shape[3]} max_abs_err {c4:.3g}",
          flush=True)
    del ctrainer, cstate, cbatch, coco_ops, cq, ck, cv, cg, cm, ca, got, want
    torch.cuda.empty_cache()

    # -- 14. L1f against its twin -----------------------------------------------------
    # Error in bf16 ulps of each output row's scale.  Kernel and twin walk the
    # same 128-key tiles with the same running maximum and round the same
    # fp32 quantities to bf16 (p before p.v, the result once); their exps and
    # sum orders differ.  Bounds: 1 ulp at the maximum, 0.01 on average; the
    # log-sum-exp within 1e-5.  Two wrong twins must fall outside them: p left
    # in fp32 before p.v, and p rounded against the row's global maximum in
    # place of the running one.  Then the edges of the tiles (N 127-129 and
    # 2047-2049 at B 1, H 2) for every head dim, forward and backward.
    def flash_ops(b, n, h=12, d=64):
        c = h * d
        qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(
            torch.bfloat16)
        q_, k_, v_ = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
                      for i in range(3))     # column slices, as the ViT's
        go_ = torch.randn(b, n, h, d, generator=g, device=dev).to(
            torch.bfloat16)
        return q_, k_, v_, go_

    bhn = attention._to_bhn
    l1f = {"err": 0.0, "ulps": {}, "ms": {}, "ms_back_to_back": {},
           "plain_ms": {}, "library_ms": {}, "wrong": {}, "edges": {}}
    for b, n in ((16, 2117), (2, 5185)):
        q, k, v, _ = flash_ops(b, n)
        check(not k.is_contiguous(), "L1f: k should be a strided view")
        out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
        torch.cuda.synchronize()
        want, want_lse = attention.flash_attention_ref(bhn(q), bhn(k), bhn(v),
                                                       0.125)
        key = f"B={b},N={n},H=12,D=64"
        check(bool(torch.isfinite(out.float()).all()), f"L1f {key}: non-finite")
        worst, mean = row_ulps(bhn(out), want)
        lse_err = (lse - want_lse).abs().max().item()
        l1f["ulps"][key] = [worst, mean]
        l1f["err"] = max(l1f["err"],
                         (bhn(out).float() - want.float()).abs().max().item())
        check(worst <= 1.0 and mean <= 0.01 and lse_err <= 1e-5,
              f"L1f {key}: {worst:.3g} bf16 ulps of the row at the maximum, "
              f"{mean:.3g} on average, lse off by {lse_err:.3g}")
        if b == 16:   # the wrong twins on four of the sixteen images
            for kind in ("p_fp32", "global_max"):
                wrong = [row_ulps(bhn(out[i:i + 1]), flash_fwd_wrong(
                    *(bhn(x[i:i + 1]) for x in (q, k, v)), 0.125, kind))
                    for i in range(4)]
                worst_w = max(w_[0] for w_ in wrong)
                mean_w = max(w_[1] for w_ in wrong)
                l1f["wrong"][kind] = [worst_w, mean_w]
                check(worst_w > 1.0 or mean_w > 0.01,
                      f"L1f: the bounds do not tell the wrong twin {kind!r} "
                      f"({worst_w:.3g} at the maximum, {mean_w:.3g} on "
                      f"average)")
        l1f["ms"][key] = time_ms(
            lambda: attention.flash_attention_cuda(q, k, v, 0.125))
        l1f["ms_back_to_back"][key] = time_ms(
            lambda: attention.flash_attention_cuda(q, k, v, 0.125),
            back_to_back=True)
        l1f["plain_ms"][key] = time_ms(lambda: attention.flash_attention_ref(
            bhn(q), bhn(k), bhn(v), 0.125), iters=3, warmup=1)
        ql, kl, vl = (bhn(x).contiguous() for x in (q, k, v))
        l1f["library_ms"][key] = time_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125))
        del q, k, v, out, lse, want, want_lse, ql, kl, vl
    for d in (16, 32, 64, 80):
        for n in (127, 128, 129, 2047, 2048, 2049):
            q, k, v, go = flash_ops(1, n, 2, d)
            out, lse = attention.flash_attention_cuda(q, k, v, d ** -0.5)
            grads = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go,
                                                       d ** -0.5)
            torch.cuda.synchronize()
            want, want_lse = attention.flash_attention_ref(
                bhn(q), bhn(k), bhn(v), d ** -0.5)
            wf = row_ulps(bhn(out), want)
            lse_err = (lse - want_lse).abs().max().item()
            wb = [row_ulps(bhn(x), w) for x, w in zip(
                grads, attention.flash_attention_bwd_ref(
                    *(bhn(x) for x in (q, k, v, out)), lse, bhn(go),
                    d ** -0.5))]
            key = f"D={d},N={n}"
            l1f["edges"][key] = [round(wf[0], 3), round(wf[1], 5),
                                 round(max(a for a, _ in wb), 3),
                                 round(max(m for _, m in wb), 5)]
            check(wf[0] <= 1.0 and wf[1] <= 0.01 and lse_err <= 1e-5
                  and all(a <= 2.0 and m <= 0.01 for a, m in wb),
                  f"flash attention at the tile edge {key}: forward {wf}, "
                  f"lse off by {lse_err:.3g}, backward {wb}")
    del q, k, v, go, out, lse, grads, want, want_lse
    print(f"[L1f flash_attention] max_abs_err {l1f['err']:.4g} | bf16 ulps of "
          f"the row [max, mean] {json.dumps(l1f['ulps'])} (bounds 1 and 0.01) "
          f"| wrong twins {json.dumps(l1f['wrong'])} (each outside) | tile "
          f"edges [L1f max, mean, L1b max, mean] {json.dumps(l1f['edges'])} "
          f"(bounds 1, 0.01, 2, 0.01) | kernel ms {json.dumps(l1f['ms'])}, "
          f"back to back {json.dumps(l1f['ms_back_to_back'])} | plain ms "
          f"{json.dumps(l1f['plain_ms'])} | library (F.scaled_dot_product_"
          f"attention) ms {json.dumps(l1f['library_ms'])}", flush=True)

    # -- 15. L1b against its twin -----------------------------------------------------
    # On the forward kernel's own out and lse.  Kernel and twin round the same
    # fp32 quantities to bf16 (ds before both of its products, p for dv, the
    # results once) and sum in different orders.  Bounds: 2 bf16 ulps of the
    # row at the maximum and 0.01 on average (measured on an H100: 1.0 and
    # <= 8.1e-4).  A wrong twin must fall outside them: without delta
    # (110-450 ulps at the maximum), with ds left in fp32 (0.09-0.13 ulp on
    # average; its maximum, 1-2 ulps, does not show it), with the row maximum
    # in place of the log-sum-exp (230-255 ulps).
    def flash_bwd_wrong(q_, k_, v_, o_, lse_, g_, scale, kind):
        qf, kf, vf, of, gf = (x.float() for x in (q_, k_, v_, o_, g_))
        s_ = scale * (qf @ kf.transpose(-1, -2))
        if kind == "lse_is_max":
            lse_ = s_.amax(-1)
        p_ = torch.exp(s_ - lse_[..., None])
        del s_
        t_ = gf @ vf.transpose(-1, -2)
        delta = (of * gf).sum(-1, keepdim=True)
        if kind == "no_delta":
            delta = torch.zeros_like(delta)
        ds = p_ * (t_ - delta)
        del t_
        if kind != "ds_fp32":
            ds = ds.to(torch.bfloat16).float()
        dq_, dk_ = scale * (ds @ kf), scale * (ds.transpose(-1, -2) @ qf)
        dv_ = p_.to(torch.bfloat16).float().transpose(-1, -2) @ gf
        return tuple(x.to(torch.bfloat16) for x in (dq_, dk_, dv_))

    l1b = {"err": 0.0, "ulps": {}, "ms": {}, "ms_back_to_back": {},
           "plain_ms": {}, "library_ms": {}, "wrong": {}}
    b, n = 2, 2305
    l1b_key = f"B={b},N={n},H=12,D=64"
    q, k, v, go = flash_ops(b, n)
    out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
    got = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    again = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "L1b: two calls on the same operands differ")
    del again
    ops15 = (bhn(q), bhn(k), bhn(v), bhn(out), lse, bhn(go))
    want = attention.flash_attention_bwd_ref(*ops15, 0.125)
    worst = mean = 0.0
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(x.float()).all()), f"L1b: non-finite {name}")
        a_, m_ = row_ulps(bhn(x), w)
        worst, mean = max(worst, a_), max(mean, m_)
        l1b["err"] = max(l1b["err"],
                         (bhn(x).float() - w.float()).abs().max().item())
    l1b["ulps"][l1b_key] = [worst, mean]
    check(worst <= 2.0 and mean <= 0.01,
          f"L1b {l1b_key}: {worst:.3g} bf16 ulps of the row at the maximum, "
          f"{mean:.3g} on average")
    for kind in ("no_delta", "ds_fp32", "lse_is_max"):
        worst = mean = 0.0
        for x, w in zip(got, flash_bwd_wrong(*ops15, 0.125, kind)):
            a_, m_ = row_ulps(bhn(x), w)
            worst, mean = max(worst, a_), max(mean, m_)
        l1b["wrong"][kind] = [worst, mean]
        check(worst > 2.0 or mean > 0.01,
              f"L1b: the bounds do not tell the wrong twin {kind!r} "
              f"({worst:.3g} at the maximum, {mean:.3g} on average)")
    l1b["ms"][l1b_key] = time_ms(lambda: attention.flash_attention_bwd_cuda(
        q, k, v, out, lse, go, 0.125))
    l1b["ms_back_to_back"][l1b_key] = time_ms(
        lambda: attention.flash_attention_bwd_cuda(q, k, v, out, lse, go,
                                                   0.125), back_to_back=True)
    l1b["plain_ms"][l1b_key] = time_ms(
        lambda: attention.flash_attention_bwd_ref(*ops15, 0.125), iters=3,
        warmup=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # backward runs on this stream
        ql, kl, vl = (bhn(x).detach().clone().requires_grad_()
                      for x in (q, k, v))
        out_l = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125)
        gl = bhn(go).contiguous()
    l1b["library_ms"][l1b_key] = graph_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), gl, retain_graph=True), side)
    del q, k, v, go, out, lse, got, want, ops15, ql, kl, vl, out_l, gl, side
    print(f"[L1b flash_attention_bwd] max_abs_err {l1b['err']:.4g} | bf16 ulps "
          f"of the row [max, mean] {json.dumps(l1b['ulps'])} (bounds 2 and "
          f"0.01) | wrong twins {json.dumps(l1b['wrong'])} (each outside) | "
          f"bit-equal from call to call | kernel ms {json.dumps(l1b['ms'])}, "
          f"back to back {json.dumps(l1b['ms_back_to_back'])} | plain ms "
          f"{json.dumps(l1b['plain_ms'])} | library (backward of F.scaled_dot_"
          f"product_attention, replayed as a CUDA graph) ms "
          f"{json.dumps(l1b['library_ms'])}", flush=True)

    # -- 16. the evaluation path ------------------------------------------------------
    import tempfile

    from dupl_tpu_torch.data.voc import VocSegDataset, write_synthetic_voc
    from dupl_tpu_torch.engine.eval_seg import SegEvaluator
    from dupl_tpu_torch.engine.validate import Validator
    from dupl_tpu_torch.utils.metrics import format_score_table

    del trainer, state, card_trainer, card_state, cpu_trainer, cpu_state
    del cpu_model, sides
    torch.cuda.empty_cache()
    twins += [(attention, "flash_attention_ref"),
              (attention, "flash_attention_bwd_ref")]
    eval_counters = {"exp_attention": attention.exp_attention_cuda,
                     "flash_attention": attention.flash_attention_cuda,
                     "crf_apply": crf_cuda.kernel_apply_cuda}
    sizes16 = [(375, 500), (500, 375), (500, 500)] * 8     # (height, width)
    emodel = DualStudent(cfg.model)
    init_weights(emodel, torch.Generator().manual_seed(0))
    emodel.to(dev).eval()
    k5_eval = {}
    k5_twin = crf_cuda.kernel_apply_ref   # unwrapped: the comparison below
    originals = []
    for mod, name in twins:
        fn, wrapped = counting(mod, name)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        with tempfile.TemporaryDirectory() as tmp16:
            root16, lists16 = write_synthetic_voc(tmp16, sizes16, seed=16)
            ds16 = VocSegDataset(root16, lists16, "val",
                                 transfer_dtype="uint8")
            ev = SegEvaluator(cfg, emodel, scales=(1.0, 1.5, 1.25),
                              merge="max", input_mode="native")
            chunks16 = ev._chunks(ds16, list(range(len(ds16))), 8)
            check([len(c) for c in chunks16] == [8, 8, 8]
                  and len({ds16.image_size(c[0]) for c in chunks16}) == 3,
                  f"evaluation buckets: {chunks16}")
            res16 = ev.run(ds16, batch_size=8, crf="device")   # builds, caches
            torch.cuda.synchronize()

            # The second run: every forward under the sync debug mode (the
            # run's one synchronous copy a batch, the labels, comes after
            # it), the launches of each forward and of the CRF after it, and
            # the operands of one K5 launch at V = 21.
            forwards = []
            plain_msc, plain_k5 = ev.msc_logits, crf_cuda.kernel_apply_cuda

            def counted_msc(x):
                before = {k_: f.launches for k_, f in eval_counters.items()}
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out_ = plain_msc(x)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                forwards.append((tuple(x.shape[1:3]), before, {
                    k_: f.launches for k_, f in eval_counters.items()}))
                return out_

            def keeping_k5(*a):
                if not k5_eval and a[3].shape[2] == 21:
                    k5_eval["operands"] = tuple(x.detach().clone() for x in a)
                return plain_k5(*a)
            keeping_k5.launches = plain_k5.launches

            ev.msc_logits = counted_msc
            crf_cuda.kernel_apply_cuda = keeping_k5
            eval_counters["crf_apply"] = keeping_k5
            for f in eval_counters.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            try:
                t = time.perf_counter()
                res16 = ev.run(ds16, batch_size=8, crf="device")
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t
            finally:
                crf_cuda.kernel_apply_cuda = plain_k5
                plain_k5.launches = keeping_k5.launches
                del ev.msc_logits
            eval_launches = {k_: f.launches for k_, f in eval_counters.items()}
            peak16 = torch.cuda.max_memory_allocated()

            # per forward: K1 and L1f by the bucket's token counts (12 blocks
            # x 2 students a scale: 1611 / 1611 / 2117 tokens at scale 1.5);
            # per CRF pass 1 + iter_max K5 launches
            check(len(forwards) == 6, f"{len(forwards)} forwards in two passes")
            end_k5 = eval_launches["crf_apply"]
            for i, (hw, before, after) in enumerate(forwards):
                d_ = {k_: after[k_] - before[k_] for k_ in after}
                square = hw == (500, 500)
                check(d_["exp_attention"] == (48 if square else 72)
                      and d_["flash_attention"] == (24 if square else 0)
                      and d_["crf_apply"] == 0,
                      f"forward {i} at {hw}: launches {d_}")
                nxt = (forwards[i + 1][1]["crf_apply"] if i + 1 < 6 else end_k5)
                check(nxt - after["crf_apply"]
                      == (0 if i < 3 else 1 + cfg.crf.iter_max),
                      f"K5 launches after forward {i}: "
                      f"{nxt - after['crf_apply']}")
            labelled = sum(h * w - 4 for h, w in sizes16)
            for k_ in ("hist_1", "hist_2", "crf_hist"):
                check(res16[k_].sum() == labelled,
                      f"{k_} sums to {res16[k_].sum()}, labelled {labelled}")
            check(res16["crf_branch"] == res16["branch"] in (1, 2)
                  and all(np.isfinite(res16[k_]["miou"]) for k_ in
                          ("seg_score_1", "seg_score_2", "crf_score")),
                  "evaluation scores")
            print(format_score_table(
                [res16["seg_score_1"], res16["seg_score_2"],
                 res16["crf_score"]],
                ["Seg_1", "Seg_2", f"branch{res16['branch']}+CRF"],
                cfg.class_list).splitlines()[-1], flush=True)

            # K5 on a batch's own operands against its twin (bound as in
            # phase 4): the padded 504 x 376 (or 376 x 504) lattice
            kb, kc, kl_, kv = k5_eval["operands"]
            check(kb.shape == (8, 189504, 11) and kc.shape == (8, 11, 2961)
                  and kv.shape == (8, 2961, 21),
                  f"evaluation K5 operands: {tuple(kb.shape)} "
                  f"{tuple(kc.shape)} {tuple(kv.shape)}")
            got = crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv)
            torch.cuda.synchronize()
            rows16 = 47 * 504      # row_chunk = _auto_tile(376, 56) = 47
            want = k5_twin(kb[:2], kc[:2], kl_[:2], kv[:2], block_rows=rows16)
            err = (got[:2] - want).abs()
            worst, mean = crf_apply_err(got[:2], want)
            check(bool(torch.isfinite(got).all()) and worst <= K5_MAX
                  and mean <= K5_MEAN,
                  f"K5 on the evaluation's operands: error {worst:.3g} / "
                  f"{mean:.3g} of the column scale (max / mean; bounds "
                  f"{K5_MAX} / {K5_MEAN})")
            k5["err"] = max(k5["err"], err.max().item())
            k5_eval["err"] = err.max().item()
            k5_eval["err_rel"] = [worst, mean]
            k5_eval["key"] = "eval B=8,N=189504,Ns=2961,V=21"
            k5_eval["ms"] = time_ms(
                lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv))
            k5_eval["ms_back_to_back"] = time_ms(
                lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv),
                back_to_back=True)
            # the same operands at COCO's fast-mode width, V 82
            kv82 = torch.rand(8, 2961, 82, generator=g, device=dev) * 2.0
            k5_eval["ms_v82"] = time_ms(
                lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv82))
            k5_eval["ms_back_to_back_v82"] = time_ms(
                lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv82),
                back_to_back=True)
            k5_eval["plain_ms"] = time_ms(
                lambda: k5_twin(kb, kc, kl_, kv, block_rows=rows16), iters=3,
                warmup=1)
            del kb, kc, kl_, kv, kv82, got, want, err, k5_eval["operands"]
            print(f"[evaluation slice] ViT-B/16 dual student, VOC protocol "
                  f"(native resolution, MSC 1.0/1.5/1.25 x flip, max merge, "
                  f"two passes, device CRF), 24 images in 3 buckets of 8 | "
                  f"second run {eval_s:.3f} s | {24 / eval_s:.3f} img/s | peak "
                  f"memory {peak16 / 2**30:.3f} GiB | launches of the run "
                  f"{json.dumps(eval_launches)} (a forward: K1 72 / 72 / 48, "
                  f"L1f 0 / 0 / 24; K5 {1 + cfg.crf.iter_max} a CRF batch) | "
                  f"K5 on a batch's operands: max_abs_err "
                  f"{k5_eval['err']:.4g}, over the column scale "
                  f"{k5_eval['err_rel'][0]:.3g} / {k5_eval['err_rel'][1]:.3g} "
                  f"(max / mean; bounds {K5_MAX} / {K5_MEAN}), kernel ms "
                  f"{k5_eval['ms']:.4f} (back to back "
                  f"{k5_eval['ms_back_to_back']:.4f}), plain ms "
                  f"{k5_eval['plain_ms']:.4f}; at V 82 kernel ms "
                  f"{k5_eval['ms_v82']:.4f} (back to back "
                  f"{k5_eval['ms_back_to_back_v82']:.4f})", flush=True)

            # in-training validation on the same tree
            val = Validator(cfg, emodel)
            val.run(ds16, batch_size=8)
            torch.cuda.synchronize()
            for f in eval_counters.values():
                f.launches = 0
            t = time.perf_counter()
            res_val = val.run(ds16, batch_size=8)
            torch.cuda.synchronize()
            val_s = time.perf_counter() - t
            # per student and batch: scales 1.0, 0.5, 1.5 x flip at crop 448
            check(attention.exp_attention_cuda.launches == 3 * 3 * 24
                  and attention.flash_attention_cuda.launches == 0,
                  f"validation launches: K1 "
                  f"{attention.exp_attention_cuda.launches}")
            check(all(np.isfinite(res_val[k_]) for k_ in res_val
                      if k_.endswith("_miou") or k_.startswith("cls_f1")),
                  "validation scores")
            print(f"[validation] Validator.run, crop 448, batch 8, 24 images | "
                  f"{val_s:.3f} s | {24 / val_s:.3f} img/s | seg mIoU "
                  f"{res_val['seg_1_miou']:.4f} / {res_val['seg_2_miou']:.4f} "
                  f"| CAM mIoU {res_val['cam_1_miou']:.4f} / "
                  f"{res_val['cam_2_miou']:.4f}", flush=True)
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")

        # -- 17. the differentiated flash attention on a path ---------------------
        # Warm-up phase, crop 768, batch 1.  Per student: scale 1.0 with grad
        # (2305 tokens: L1f and L1b in each of 12 blocks), its flip without,
        # scale 1.5 and its flip (5185 tokens) through L1f, scale 0.5 and its
        # flip (577 tokens) through K1.
        del emodel, ev, val
        torch.cuda.empty_cache()
        counters17 = {"exp_attention": attention.exp_attention_cuda,
                      "exp_attention_bwd": attention.exp_attention_bwd_cuda,
                      "flash_attention": attention.flash_attention_cuda,
                      "flash_attention_bwd": attention.flash_attention_bwd_cuda}
        tcfg17 = production_config("voc")
        batch17 = synthetic_batch(1, crop=768, num_fg=tcfg17.model.num_fg)
        trainer17 = Trainer(tcfg17, device=dev)
        state17 = trainer17.init_state()
        step17 = phase_start(tcfg17, "warmup")
        trainer17.grad_step(state17, batch17, step=step17)    # caches
        torch.cuda.synchronize()
        for f in counters17.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        grads17, metrics17 = trainer17.grad_step(state17, batch17, step=step17)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t
        launches17 = {k_: f.launches for k_, f in counters17.items()}
        peak17 = torch.cuda.max_memory_allocated()
        check(launches17 == {"exp_attention": 24, "exp_attention_bwd": 0,
                             "flash_attention": 72, "flash_attention_bwd": 24},
              f"grad_step at crop 768: launches {launches17}")
        loss17 = metrics17["loss"].item()
        check(np.isfinite(loss17), f"grad_step at crop 768: loss {loss17}")
        for n_, p_ in state17.model.named_parameters():
            in_graph = p_.requires_grad and ".decoder." not in n_
            check((n_ in grads17) == in_graph, f"gradient of {n_}: "
                  f"{'present' if n_ in grads17 else 'missing'}")
            if in_graph:
                check(bool(torch.isfinite(grads17[n_]).all()),
                      f"non-finite gradient of {n_}")
        check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
        print(f"[grad_step at crop 768] warm-up, batch 1, full depth | "
              f"{1e3 * grad_s:.1f} ms | peak memory {peak17 / 2**30:.3f} GiB | "
              f"launches {json.dumps(launches17)} | loss {loss17:.4f}",
              flush=True)
        del grads17, trainer17, state17
        torch.cuda.empty_cache()
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    # Card against CPU at depth 2, full width, the same seeded weights.  The
    # card runs K1 below 2048 tokens and L1f / L1b from there, the CPU exact
    # softmax under plain autograd; both compute in bf16 as the recipe says,
    # rounding at slightly different places, and seeded weights leave many
    # pixels with two classes nearly tied.  Bounds: merged logits within
    # 5e-2 of their scale, as in phase 6; every pixel whose label differs
    # (merged, and each scale alone: 1.5 is the one through L1f) has, on the
    # CPU side, a margin between its two largest logits of at most
    # MARGIN_ULPS bf16 ulps of the larger, so every flip is a near tie that
    # bf16 rounding decides (measured on an H100: at most 3 ulps over the
    # four label maps); gradient cosine of each group at least 0.98.
    MARGIN_ULPS = 8
    import dataclasses

    smodel = DualStudent(tcfg17.model)
    init_weights(smodel, torch.Generator().manual_seed(17))
    shallow(smodel, 2)
    img17 = np.asarray(Image.open(io.BytesIO(bodies[13][0])).convert("RGB"))
    check(img17.shape == (500, 500, 3), f"image of {img17.shape}")
    labels17, logits17, grads_cc, flops17 = {}, {}, {}, {}
    for side in ("card", "cpu"):
        m_ = copy.deepcopy(smodel).to(dev if side == "card" else "cpu").eval()
        x17, _ = image_ops.prepare_inputs(
            torch.tensor(img17[None], device=next(m_.parameters()).device))
        for f in counters17.values():
            f.launches = 0
        with torch.inference_mode():
            logits17[side] = [msc_seg_logits(
                lambda z: m_(z).seg, x17, (500, 500), (1.0, 1.5, 1.25), "max",
                batch_dims=2).float().cpu()]
            msc_launches = {k_: f.launches for k_, f in counters17.items()}
            logits17[side] += [
                msc_seg_logits(lambda z: m_(z).seg, x17, (500, 500), (sc,),
                               "max", batch_dims=2).float().cpu()
                for sc in (1.0, 1.25, 1.5)]
            labels17[side] = [x.argmax(-1) for x in logits17[side]]
        check(msc_launches == ({"exp_attention": 8, "exp_attention_bwd": 0,
                                "flash_attention": 4, "flash_attention_bwd": 0}
                               if side == "card" else dict.fromkeys(
                                   counters17, 0)),
              f"{side} msc launches at depth 2: {msc_launches}")
        tr_ = Trainer(tcfg17, model=m_.train(), device=next(
            m_.parameters()).device)
        # the step's FLOPs on each route, held equal in phase 27 (b)
        for f in counters17.values():
            f.launches = 0
        out17 = []
        n17 = flops_utils.count_flops(lambda: out17.append(tr_.grad_step(
            tr_.init_state(init=False), batch17, step=step17)))
        flops17[side] = (n17, {k_: f.launches for k_, f in counters17.items()})
        g_, mt_ = out17.pop()
        grads_cc[side] = ({k_: v_.float().cpu() for k_, v_ in g_.items()},
                          mt_["loss"].item())
        del m_, tr_, g_
    # [merged, scale 1.0, 1.25, 1.5] x [student 1, student 2]
    agree17 = [[(a[i] == b_[i]).float().mean().item() for i in range(2)]
               for a, b_ in zip(labels17["card"], labels17["cpu"])]
    # CPU-side margin of every flipped pixel, in bf16 ulps of its top logit
    margins17 = []
    for lc, lg, lab_card, lab_cpu in zip(logits17["cpu"], logits17["card"],
                                         labels17["card"], labels17["cpu"]):
        check(bool(torch.isfinite(lg).all()), "non-finite card logits")
        top2 = lc.topk(2, dim=-1).values
        ulps = (top2[..., 0] - top2[..., 1]) / bf16_ulp(top2[..., 0].abs())
        flips = ulps[lab_card != lab_cpu]
        margins17.append(sorted(round(x, 2) for x in flips.tolist()))
    err17 = (logits17["card"][0] - logits17["cpu"][0]).abs().max().item()
    scale17 = logits17["cpu"][0].abs().max().item()
    check(err17 <= 5e-2 * scale17,
          f"card vs CPU logits of a 500 x 500 image at depth 2: {err17:.4g} > "
          f"5e-2 x {scale17:.4g}")
    worst17 = max((m[-1] for m in margins17 if m), default=0.0)

    def hist17(margins):
        edges = [0, 1, 2, 4, 8, float("inf")]
        return [sum(lo <= x < hi for x in margins)
                for lo, hi in zip(edges, edges[1:])]
    cos17 = {}
    for grp in ("base", "head"):
        a = torch.cat([grads_cc["card"][0][n_].flatten()
                       for n_ in grads_cc["card"][0]
                       if group_of(n_) == grp]).double()
        b_ = torch.cat([grads_cc["cpu"][0][n_].flatten()
                        for n_ in grads_cc["card"][0]
                        if group_of(n_) == grp]).double()
        check(bool(torch.isfinite(a).all()), f"non-finite {grp} gradient")
        cos17[grp] = F.cosine_similarity(a, b_, dim=0).item()
        check(cos17[grp] >= 0.98, f"card vs CPU gradient cosine of the {grp} "
              f"group at crop 768: {cos17[grp]:.4f} < 0.98")
    print(f"[flash path card vs cpu] depth 2, full width | 500 x 500 image, "
          f"MSC 1.0/1.5/1.25 x flip: logits max abs err {err17:.4g} (scale "
          f"{scale17:.4g}, bound 5e-2 of it), labels equal "
          f"{agree17[0][0]:.4f} / {agree17[0][1]:.4f}, scales "
          f"1.0, 1.25 (K1) and 1.5 (L1f) alone "
          f"{json.dumps([[round(v_, 4) for v_ in a] for a in agree17[1:]])} | "
          f"flipped pixels [merged, 1.0, 1.25, 1.5] "
          f"{json.dumps([len(m) for m in margins17])}, their CPU-side top-2 "
          f"margins in bf16 ulps of the top logit: largest {worst17} (bound "
          f"{MARGIN_ULPS}), counts by [0,1) [1,2) [2,4) [4,8) [8,inf) ulps "
          f"{json.dumps([hist17(m) for m in margins17])} | "
          f"warm-up grad_step at crop 768: "
          f"loss card {grads_cc['card'][1]:.5f} cpu {grads_cc['cpu'][1]:.5f}, "
          f"gradient cosine "
          f"{json.dumps({k_: round(v_, 5) for k_, v_ in cos17.items()})} "
          f"(bound 0.98)", flush=True)
    check(worst17 <= MARGIN_ULPS, f"card vs CPU labels of a 500 x 500 image "
          f"at depth 2: a pixel flipped at a margin of {worst17} bf16 ulps of "
          f"its top logit (bound {MARGIN_ULPS}); labels equal {agree17}")

    # -- 18-21. the experiment kernels, through their tools -------------------------
    # Each tool's ``run`` is the main path of its kernel: the counts are set
    # to 0 just before it and read just after.  Then the kernel is held
    # against its twin at the tool's full shapes.
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tools"))
    import crf_apply_experiment_torch as crf_tool
    import exp_attn_experiment_torch as ones_tool
    import exp_attn_layout_experiment_torch as bnhd_tool
    import exp_rate_experiment_torch as rate_tool

    from dupl_tpu_torch.ops import experiments

    torch.cuda.empty_cache()
    exp_counters = {"exp_attention_ones": experiments.exp_attention_ones_cuda,
                    "exp_attention_bnhd": experiments.exp_attention_bnhd_cuda,
                    "crf_apply_bf16": experiments.kernel_apply_bf16_cuda,
                    "exp_rate": experiments.exp_rate_cuda}

    def tool_run(name, run, **kw):
        for f in exp_counters.values():
            f.launches = 0
        records = run(dev, **kw)
        torch.cuda.synchronize()
        return records, exp_counters[name].launches

    def by_heads(fn, ops, chunk=96):
        """A twin over (BH, N, D) operands in chunks of heads: its fp32
        score matrix at 768 heads and 1765 tokens would take 9.6 GB."""
        return torch.cat([fn(*(x[i:i + chunk] for x in ops)).to(torch.bfloat16)
                          for i in range(0, ops[0].shape[0], chunk)])

    def p12_share(heads, n, ms, ones):
        """The least time of P1 (``ones``: K1's products and the ones
        column) or P2 (K1's products) at D 64 over a measured time."""
        flops = heads * n ** 2 * (4 * 64 + (2 if ones else 0))
        return bound_ms(flops, "bf16", 4 * heads * n * 64 * 2)[0] / ms

    # -- 18. P1 against its twin ---------------------------------------------------
    # Bounds, written before the run: within 2 bf16 ulps of the row at the
    # maximum (kernel and twin sum in fp32 in different orders; that can flip
    # the bf16 rounding of an e entry, which a small element of the row
    # carries at the row's scale) and 1e-3 ulp on average.  The wrong twins
    # of exp_attn_ones_wrong (the fp32 row sum: the exp-attention twin; keys
    # past N counted by the ones column: N 197, 785 and 1765 are all ragged
    # against 128) must exceed the mean bound.
    p1_records, p1_launches = tool_run("exp_attention_ones", ones_tool.run)
    p1 = {"err": 0.0, "ulps": {}, "wrong_mean": {}, "ms": {},
          "ms_back_to_back": {}, "bound_share": {}, "k1_ms": {},
          "k1_ms_back_to_back": {}, "plain_ms": {}, "library_ms": {},
          "rel_k1": {}}
    for rec in p1_records:
        n, key = rec["n"], f"BH={rec['bh']},N={rec['n']}"
        ops18 = ones_tool.make_inputs(rec["bh"], n, dev)
        got = experiments.exp_attention_ones(*ops18)
        torch.cuda.synchronize()
        want = by_heads(experiments.exp_attention_ones_ref, ops18).float()
        mx, mean = row_ulps(got, want)
        check(bool(torch.isfinite(got.float()).all()), f"P1 N={n}: non-finite")
        check(mx <= 2.0 and mean <= 1e-3,
              f"P1 {key}: {mx:.2f} ulp max, {mean:.2e} mean vs its twin "
              f"(bounds 2, 1e-3)")
        for kind in ("fp32_row_sum", "pad_counted"):
            wmean = row_ulps(got, by_heads(
                lambda *o: exp_attn_ones_wrong(*o, kind), ops18).float())[1]
            check(wmean > 1e-3, f"P1 {key}: the wrong twin {kind} is inside "
                  f"the mean bound ({wmean:.2e} ulp)")
            p1["wrong_mean"][f"{kind},{key}"] = wmean
        p1["err"] = max(p1["err"], (got.float() - want).abs().max().item())
        p1["ulps"][key] = (mx, mean)
        p1["ms"][key], p1["k1_ms"][key] = rec["ones_ms"], rec["current_ms"]
        p1["ms_back_to_back"][key] = time_ms(
            lambda: experiments.exp_attention_ones(*ops18), back_to_back=True)
        p1["k1_ms_back_to_back"][key] = time_ms(
            lambda: ones_tool.current(*ops18), back_to_back=True)
        p1["bound_share"][key] = p12_share(rec["bh"], n, rec["ones_ms"], True)
        p1["rel_k1"][key] = rec["max_rel_diff"]
        p1["plain_ms"][key] = time_ms(lambda: by_heads(
            experiments.exp_attention_ones_ref, ops18), iters=2, warmup=1)
        ql, kl, vl = (x[None] for x in ops18)
        p1["library_ms"][key] = time_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=1.0))
        del ops18, got, want, ql, kl, vl
    print(f"[P1 exp_attention_ones] max_abs_err {p1['err']:.4g} | bf16 ulps of "
          f"the row (max, mean) {json.dumps(p1['ulps'])} (bounds 2, 1e-3) | "
          f"wrong twins mean ulps {json.dumps(p1['wrong_mean'])} (each "
          f"outside 1e-3) | kernel ms {json.dumps(p1['ms'])}, back to back "
          f"{json.dumps(p1['ms_back_to_back'])}, share of the bound "
          f"{json.dumps(p1['bound_share'])} | K1 ms {json.dumps(p1['k1_ms'])}, "
          f"back to back {json.dumps(p1['k1_ms_back_to_back'])} | "
          f"max-rel-diff vs K1 {json.dumps(p1['rel_k1'])} | plain ms "
          f"{json.dumps(p1['plain_ms'])} | library ms "
          f"{json.dumps(p1['library_ms'])} | launches of the tool's run "
          f"{p1_launches}", flush=True)

    # -- 19. P2 against its twin ---------------------------------------------------
    # Same bounds as P1, and the bits of K1 on bf16(q * bf16(scale)): P2 runs
    # K1's step on its scaled q tile.  At the tool's scale of 1/8 a twin that
    # leaves the scale in fp32 is the same function (bf16 holds 1/8), so the
    # wrong twins of exp_attn_bnhd_wrong are checked at scale 0.11, which
    # bf16 rounds to 0.10986.
    p2_records, p2_launches = tool_run("exp_attention_bnhd", bnhd_tool.run)
    p2 = {"err": 0.0, "ulps": {}, "wrong_mean": {}, "ms": {},
          "ms_back_to_back": {}, "bound_share": {}, "k1_ms": {},
          "k1_ms_back_to_back": {}, "k1_alone_ms": {}, "plain_ms": {},
          "library_ms": {}, "rel_k1": {}}

    def by_batch(fn, ops, scale, chunk=8):
        return torch.cat([fn(*(x[i:i + chunk] for x in ops), scale).to(
            torch.bfloat16) for i in range(0, ops[0].shape[0], chunk)])

    for rec in p2_records:
        n, key = rec["n"], f"B={rec['b']},N={rec['n']},H=12,D=64"
        ops19 = bnhd_tool.make_inputs(rec["b"], n, dev)
        for scale in (0.125, 0.11):
            got = experiments.exp_attention_bnhd(*ops19, scale)
            k1_got = attention.exp_attention_cuda(
                ops19[0] * experiments.bf16_scale(scale), *ops19[1:])
            torch.cuda.synchronize()
            check(torch.equal(got, k1_got), f"P2 {key} scale {scale}: not the "
                  f"bits of K1 on the scaled q")
            want = by_batch(experiments.exp_attention_bnhd_ref, ops19,
                            scale).float()
            mx, mean = row_ulps(got, want)
            check(bool(torch.isfinite(got.float()).all()),
                  f"P2 N={n}: non-finite")
            check(mx <= 2.0 and mean <= 1e-3,
                  f"P2 {key} scale {scale}: {mx:.2f} ulp max, {mean:.2e} mean "
                  f"vs its twin (bounds 2, 1e-3)")
            p2["err"] = max(p2["err"], (got.float() - want).abs().max().item())
            if scale == 0.125:
                p2["ulps"][key] = (mx, mean)
            else:
                for kind in ("fp32_scale", "scale_on_scores"):
                    wmean = row_ulps(got, by_batch(
                        lambda *o: exp_attn_bnhd_wrong(*o, kind), ops19,
                        scale).float())[1]
                    check(wmean > 1e-3, f"P2 {key}: the wrong twin {kind} is "
                          f"inside the mean bound ({wmean:.2e} ulp)")
                    p2["wrong_mean"][f"{kind},{key}"] = wmean
            del got, k1_got, want
        p2["ms"][key], p2["k1_ms"][key] = rec["bnhd_ms"], rec["current_ms"]
        p2["ms_back_to_back"][key] = time_ms(
            lambda: experiments.exp_attention_bnhd(*ops19), back_to_back=True)
        p2["k1_ms_back_to_back"][key] = time_ms(
            lambda: bnhd_tool.current(*ops19), back_to_back=True)
        qs19 = ops19[0] * experiments.bf16_scale(0.125)
        p2["k1_alone_ms"][key] = time_ms(   # without the scale pass
            lambda: attention.exp_attention_cuda(qs19, *ops19[1:]))
        p2["bound_share"][key] = p12_share(12 * rec["b"], n, rec["bnhd_ms"],
                                           False)
        p2["rel_k1"][key] = rec["max_rel_diff"]
        p2["plain_ms"][key] = time_ms(lambda: by_batch(
            experiments.exp_attention_bnhd_ref, ops19, 0.125), iters=2,
            warmup=1)
        ql, kl, vl = (x.permute(0, 2, 1, 3) for x in ops19)
        p2["library_ms"][key] = time_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125))
        del ops19, qs19, ql, kl, vl
    print(f"[P2 exp_attention_bnhd] max_abs_err {p2['err']:.4g} | bf16 ulps of "
          f"the row (max, mean) {json.dumps(p2['ulps'])} (bounds 2, 1e-3) | "
          f"bit-equal to K1 on the scaled q at scales 0.125 and 0.11 | wrong "
          f"twins at scale 0.11 mean ulps {json.dumps(p2['wrong_mean'])} "
          f"(each outside 1e-3) | kernel ms {json.dumps(p2['ms'])}, back to "
          f"back {json.dumps(p2['ms_back_to_back'])}, share of the bound "
          f"{json.dumps(p2['bound_share'])} | scale pass + K1 ms "
          f"{json.dumps(p2['k1_ms'])}, back to back "
          f"{json.dumps(p2['k1_ms_back_to_back'])} | K1 alone on the scaled q "
          f"ms {json.dumps(p2['k1_alone_ms'])} | max-rel-diff vs scale pass + K1 "
          f"{json.dumps(p2['rel_k1'])} | plain ms {json.dumps(p2['plain_ms'])} "
          f"| library ms {json.dumps(p2['library_ms'])} | launches of the "
          f"tool's run {p2_launches}", flush=True)
    torch.cuda.empty_cache()

    # -- 20. P3 against its twin ---------------------------------------------------
    # Bounds, written before the run: at most 5e-4 of a column's largest
    # output and 1e-4 of it on average (kernel and twin differ where a
    # score's fp32 sum crosses a bf16 rounding boundary, or the exp of a bf16
    # value rounds the other way: rare, and small in a sum over 3,136
    # pivots).  The wrong twin (exp of the fp32 score: K5's roundings) must
    # exceed both.  Every seventh pivot has logc = -inf; with all of them
    # -inf the output is exactly 0.  Then the same bounds on the fast CRF's
    # own operands (phase 4's two 448^2 images, whose colour terms reach
    # ~2,600 and cancel) at V 22 and 82, where every 32-column slice of the
    # call is bit-equal to a call on that slice alone, beside K5.
    def p3_err(got, want, wrong):
        """(max, mean) over columns of |got - want| over the column's scale,
        and the same of the wrong twin, whose mean takes the smallest
        column."""
        scale = want.abs().amax(dim=(0, 1))
        e, w = (got - want).abs(), (got - wrong).abs()
        return ((e.amax(dim=(0, 1)) / scale).max().item(),
                (e.mean(dim=(0, 1)) / scale).max().item(),
                (w.amax(dim=(0, 1)) / scale).max().item(),
                (w.mean(dim=(0, 1)) / scale).min().item())

    p3_records, p3_launches = tool_run("crf_apply_bf16", crf_tool.run)
    rec20 = p3_records[0]
    ops20 = list(crf_tool.make_inputs(rec20["batch"], rec20["n"], rec20["ns"],
                                      dev))
    ops20[2][:, ::7] = float("-inf")
    got = experiments.kernel_apply_bf16(*ops20)
    torch.cuda.synchronize()
    rows20 = rec20["n"] // 16
    want = experiments.kernel_apply_bf16_ref(*ops20, block_rows=rows20)
    errs = p3_err(got, want, crf_cuda.kernel_apply_ref(*ops20,
                                                       block_rows=rows20))
    p3 = {"err": (got - want).abs().max().item(), "max_rel": errs[0],
          "mean_rel": errs[1], "wrong_max_rel": errs[2],
          "wrong_mean_rel": errs[3]}
    check(bool(torch.isfinite(got).all()), "P3: non-finite")
    check(p3["max_rel"] <= 5e-4 and p3["mean_rel"] <= 1e-4,
          f"P3 vs its twin: {p3['max_rel']:.2e} max, {p3['mean_rel']:.2e} mean "
          f"of the column (bounds 5e-4, 1e-4)")
    check(p3["wrong_max_rel"] > 5e-4 and p3["wrong_mean_rel"] > 1e-4,
          f"P3: the fp32-exp twin is inside the bounds "
          f"({p3['wrong_max_rel']:.2e}, {p3['wrong_mean_rel']:.2e})")
    del want
    ops20[2].fill_(float("-inf"))
    check(experiments.kernel_apply_bf16(*ops20).abs().max().item() == 0.0,
          "P3: pivots with logc = -inf do not give exactly 0")
    key20 = f"B={rec20['batch']},N={rec20['n']},Ns={rec20['ns']},V={rec20['v']}"
    ops20 = crf_tool.make_inputs(rec20["batch"], rec20["n"], rec20["ns"], dev)
    p3["plain_ms"] = time_ms(lambda: experiments.kernel_apply_bf16_ref(
        *ops20, block_rows=rows20), iters=2, warmup=1)
    del ops20, got
    torch.cuda.empty_cache()
    img = crf_images(g, dev)
    crf20 = list(crf.pivot_lattice(img, 8, 121.0, 5.0)[:3])
    p3["crf"] = {}
    for nv in (22, 82):
        vals = torch.rand(2, crf20[1].shape[2], nv, generator=g, device=dev) * 2.0
        vals[..., -1] = 64.0
        got = experiments.kernel_apply_bf16(*crf20, vals)
        torch.cuda.synchronize()
        errs = p3_err(got, experiments.kernel_apply_bf16_ref(*crf20, vals),
                      crf_cuda.kernel_apply_ref(*crf20, vals))
        check(bool(torch.isfinite(got).all()) and errs[0] <= 5e-4
              and errs[1] <= 1e-4,
              f"P3 on the CRF's operands, V {nv}: {errs[0]:.2e} max, "
              f"{errs[1]:.2e} mean of the column (bounds 5e-4, 1e-4)")
        check(errs[2] > 5e-4 and errs[3] > 1e-4,
              f"P3 on the CRF's operands, V {nv}: the fp32-exp twin is inside "
              f"the bounds ({errs[2]:.2e}, {errs[3]:.2e})")
        for c0 in range(0, nv, 32):
            part = experiments.kernel_apply_bf16(
                *crf20, vals[..., c0:c0 + 32].contiguous())
            check(torch.equal(got[..., c0:c0 + 32], part),
                  f"P3 V={nv}: columns {c0}.. differ from a call on them alone")
        key = f"B=2,N={crf20[0].shape[1]},Ns={crf20[1].shape[2]},V={nv}"
        p3["crf"][key] = {
            "err_rel": errs[:2], "wrong_rel": errs[2:],
            "ms": time_ms(lambda: experiments.kernel_apply_bf16(*crf20, vals)),
            "k5_ms": time_ms(lambda: crf_cuda.kernel_apply(*crf20, vals))}
    del crf20, img, vals, got, part
    torch.cuda.empty_cache()
    p3_bound = k5_bound(rec20["batch"], rec20["n"], rec20["ns"], rec20["v"])
    p3["share"] = p3_bound[0] / rec20["bf16_ms"]
    print(f"[P3 crf_apply_bf16] {key20} | max_abs_err {p3['err']:.4g}, of the "
          f"column {p3['max_rel']:.2e} max / {p3['mean_rel']:.2e} mean (bounds "
          f"5e-4, 1e-4) | wrong twin (fp32 exp) {p3['wrong_max_rel']:.2e} / "
          f"{p3['wrong_mean_rel']:.2e} (outside) | -inf pivots give 0 | kernel "
          f"{rec20['bf16_ms']:.3f} ms | K5 {rec20['fp32_ms']:.3f} ms | max-rel "
          f"vs the fp32-exp tile loop {rec20['bf16_max_rel']:.2e} (K5 "
          f"{rec20['fp32_max_rel']:.2e}) | plain: its twin "
          f"{p3['plain_ms']:.1f} ms, the tool's tile loop "
          f"{rec20['plain_ms']:.1f} ms | launches of the tool's run "
          f"{p3_launches} | share of the bound ({p3_bound[0]:.3f} ms, "
          f"{p3_bound[1]}) {p3['share']:.3f} | K5 / P3 "
          f"{rec20['fp32_ms'] / rec20['bf16_ms']:.3f} | the CRF's operands "
          f"(error over the column: max, mean; the fp32-exp twin's; ms; K5 "
          f"ms), every 32-column slice bit-equal {json.dumps(p3['crf'])}",
          flush=True)

    # -- 21. P4 against its twin ---------------------------------------------------
    # Tolerances, written before the run.  fp32: 1e-5 * iters of the largest
    # result (4096 roundings accumulate; tanh.approx.f32 is good to 2^-11).
    # bf16 mul, exp, exp_min: the packed instructions round as the twin's
    # operations do (h2exp is the fp32 exp rounded to bf16), so within 2 bf16
    # ulps of the largest result.  bf16 exp2 and tanh are the card's packed
    # approximations, good to about a bf16 ulp, and an accumulator that
    # stagnates at a power of two depends on them discontinuously: 99% of the
    # elements within 2 bf16 ulps, all within a factor of 2.
    # Bounds: n = 512 * 1024 * 4096 element-passes.  The special-function
    # unit has 16 lanes an SM against 128 for fp32 arithmetic: 67e12 / 2 / 8
    # = 4.19e12 instructions a second; every variant but mul executes one MUFU
    # an element-pass (h2exp: two fp32 MUFU a pair) and is bound by that
    # unit; the packed ex2 / tanh forms are bounded as if the unit took a
    # pair a lane-slot (half of it).  mul is bound by the fp32 instruction rate (two FFMA an
    # element-pass) or the packed bf16 one (HMUL2, HADD2, HMUL2, HADD2 a pair).
    p4_records, p4_launches = tool_run("exp_rate", rate_tool.run)
    n21 = 512 * 1024 * 4096
    p4 = {"err": 0.0, "variants": {}}
    for rec in p4_records:
        dtype = getattr(torch, rec["dtype"])
        name = rec["name"]
        x21 = rate_tool.make_input(512, 1024, dtype, dev)
        got = experiments.exp_rate(x21, name, 4096).float()
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: experiments.exp_rate_ref(x21, name, 4096),
                           iters=1, warmup=0)
        want = experiments.exp_rate_ref(x21, name, 4096).float()
        err = (got - want).abs()
        top = want.abs().max()
        check(bool(torch.isfinite(got).all()), f"P4 {rec['dtype']} {name}: "
              f"non-finite")
        if dtype == torch.float32:
            ok = bool(err.max() <= 1e-5 * 4096 * top)
        elif name in ("exp2", "tanh"):
            close = err <= 2.0 ** -7 * want.abs().clamp_min(1e-3)
            ok = (close.float().mean().item() >= 0.99
                  and bool((err <= want.abs() + 1e-3).all()))
        else:
            ok = bool(err.max() <= 2.0 ** -7 * top)
        check(ok, f"P4 {rec['dtype']} {name}: error {err.max().item():.4g} of "
              f"{top.item():.4g} outside its tolerance")
        if name == "mul":
            b21 = bound_ms(2 * n21, "fp32_instr", 0)
            unit = "fp32 instruction rate" if dtype == torch.float32 else "packed bf16 instruction rate"
        elif dtype == torch.bfloat16 and name in ("exp2", "tanh"):
            b21, unit = bound_ms(n21 / 2, "sfu", 0), "special-function unit"
        else:
            b21, unit = bound_ms(n21, "sfu", 0), "special-function unit"
        p4["err"] = max(p4["err"], err.max().item())
        p4["variants"][f"{rec['dtype']} {name}"] = {
            "ms": rec["ms"], "gops": rec["gops"], "plain_ms": plain_ms,
            "bound_ms": b21[0], "binds": unit,
            "rel_err": (err.max() / top).item()}
        del x21, got, want, err
    print(f"[P4 exp_rate] (512, 1024) x 4096 passes | "
          f"{json.dumps({k_: {a: (round(b_, 4) if isinstance(b_, float) else b_) for a, b_ in v_.items()} for k_, v_ in p4['variants'].items()})} "
          f"| launches of the tool's run {p4_launches}", flush=True)

    # -- 22. the training run ------------------------------------------------------
    # tools/train_torch.py in-process on a synthetic VOC tree (40 train and 8
    # val JPEGs of VOC-like sizes), full width and depth: 12 steps through
    # warm-up, seg and full with validation at 6 and 12, then --resume to 14.
    import train_torch

    from dupl_tpu_torch.data.pipeline import PrefetchLoader
    from dupl_tpu_torch.data.voc import VocClsDataset
    from dupl_tpu_torch.engine import train as train_mod
    from dupl_tpu_torch.models.convert import load_model

    all_counters = {**train_counters, **eval_counters, **exp_counters,
                    "flash_attention_bwd": attention.flash_attention_bwd_cuda}
    twins += [(experiments, n_) for n_ in (
        "exp_attention_ones_ref", "exp_attention_bnhd_ref",
        "kernel_apply_bf16_ref", "exp_rate_ref")]
    twin_calls.clear()
    originals = []
    for mod, name in twins:
        fn, wrapped = counting(mod, name)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)
    steps22 = []          # (step, launches of that train_step, its image batch)
    plain_step = train_mod.Trainer.train_step

    def counted_step(self, state_, batch_, step=None, aug_ops=None):
        before = {k_: f.launches for k_, f in train_counters.items()}
        out_ = plain_step(self, state_, batch_, step, aug_ops)
        steps22.append((step, {k_: f.launches - before[k_]
                               for k_, f in train_counters.items()},
                        batch_["image"].clone() if step == 12 else None))
        return out_

    sizes22 = [(375, 500), (500, 375), (500, 500), (333, 500), (500, 334),
               (281, 500), (366, 500), (480, 360)]
    train_mod.Trainer.train_step = counted_step
    try:
        with tempfile.TemporaryDirectory() as tmp22:
            root22, lists22 = write_synthetic_voc(
                os.path.join(tmp22, "voc"), sizes22, seed=22,
                train_sizes=sizes22 * 5)
            work22 = os.path.join(tmp22, "run")
            argv22 = ["--data-folder", root22, "--list-folder", lists22,
                      "--cam-iters", "4", "--gmm-iters", "8", "--eval-iters",
                      "6", "--log-iters", "2", "--sync-debug"]
            for f in all_counters.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t22 = time.perf_counter()
            check(train_torch.main(argv22 + ["--work-dir", work22,
                                             "--max-iters", "12"]) == 0,
                  "the training run did not exit 0")
            run_s = time.perf_counter() - t22
            run_launches = {k_: f.launches for k_, f in all_counters.items()}
            run22 = os.path.join(work22, os.listdir(work22)[0])
            ck22 = os.path.join(run22, "checkpoints")
            recs22 = train_torch.read_metrics(os.path.join(run22,
                                                           "metrics.jsonl"))
            train22 = [r for r in recs22 if r["event"] == "train"]
            val22 = [r for r in recs22 if r["event"] == "val"]
            done22 = [r for r in recs22 if r["event"] == "done"][-1]
            check([r["step"] for r in train22] == [2, 4, 6, 8, 10, 12]
                  and [r["phase"] for r in train22]
                  == ["warmup"] * 2 + ["seg"] * 2 + ["full"] * 2,
                  f"train records: {[(r['step'], r['phase']) for r in train22]}")
            check(all(np.isfinite(r[k_]) for r in train22 for k_ in
                      ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
                       "reg_loss")), "non-finite loss in the training run")
            check(train22[2]["seg_loss"] > 0, "the seg phase has no seg loss")
            check([r["step"] for r in val22] == [6, 12]
                  and all(0.0 <= r["seg_1_miou"] <= 1.0 for r in val22),
                  f"val records: {val22}")
            saved = sorted(e for e in os.listdir(ck22) if e.endswith(".pt"))
            check(saved == ["step_12.pt", "step_6.pt"] and len(saved) <= 3,
                  f"checkpoints: {os.listdir(ck22)}")
            lm = load_model(tcfg, os.path.join(ck22, "weights.npz"), dev)
            check(all(bool(torch.isfinite(p_).all()) for p_ in lm.parameters()),
                  "exported weights are not finite")
            del lm
            for step, got_l, _ in steps22:
                phase = phase_of(dataclasses.replace(
                    tcfg, cam_iters=4, gmm_iters=8), step)
                check(got_l == expected[phase], f"training run step {step} "
                      f"({phase}): launches {got_l}, expected {expected[phase]}")
            check([s_ for s_, _, _ in steps22] == list(range(12)),
                  f"steps of the run: {[s_ for s_, _, _ in steps22]}")

            # resume: two more steps from the step-12 checkpoint
            del steps22[:]
            check(train_torch.main(argv22 + ["--work-dir", run22, "--resume",
                                             "--max-iters", "14"]) == 0,
                  "the resumed run did not exit 0")
            check([s_ for s_, _, _ in steps22] == [12, 13],
                  f"the resumed run's steps: {[s_ for s_, _, _ in steps22]}")
            ds22 = VocClsDataset(root22, lists22, tcfg.data.train_split,
                                 crop_size=448, rescale_range=tcfg.data.rescale_range,
                                 num_classes=tcfg.num_classes,
                                 ignore_index=tcfg.ignore_index,
                                 transfer_dtype="uint8")
            loader22 = PrefetchLoader(ds22, 4, seed=0, num_workers=2,
                                      start_step=12)
            batch_12 = next(iter(loader22))
            loader22.stop()
            check(torch.equal(steps22[0][2].cpu(),
                              torch.from_numpy(batch_12["image"])),
                  "the resumed run's first batch is not batch 12 of the stream")
            recs22b = train_torch.read_metrics(os.path.join(run22,
                                                            "metrics.jsonl"))
            check([r["step"] for r in recs22b if r["event"] == "train"]
                  == [2, 4, 6, 8, 10, 12, 14], "metrics after the resume")
    finally:
        train_mod.Trainer.train_step = plain_step
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    check(all(run_launches[k_] > 0 for k_ in train_counters),
          f"a kernel of the training run never launched: {run_launches}")
    by_phase = {"warmup": [train22[1]], "seg": train22[2:4],
                "full": train22[4:6]}   # the first record pays the start-up
    loop22 = {}
    for phase, rs_ in by_phase.items():
        s_it = statistics.median(r["s_per_iter"] for r in rs_)
        loop22[phase] = {
            "s_per_iter": s_it, "bare_step_ms": train12[phase]["ms"],
            "overhead_ms": 1e3 * s_it - train12[phase]["ms"],
            "feeder_wait_ms": statistics.median(r["feeder_wait_ms"]
                                                for r in rs_)}
    print(f"[training run] tools/train_torch.py, ViT-B/16 dual student, crop "
          f"448, batch 4, uint8 wire format, 12 steps + resume to 14 | "
          f"{run_s:.1f} s for the 12 steps with 2 validations and checkpoints "
          f"| a step, the loop beside phase 12's bare train_step: "
          f"{json.dumps({k_: {a: round(b_, 3) for a, b_ in v_.items()} for k_, v_ in loop22.items()})} "
          f"| H2D copy {done22['h2d_copy_ms']:.3f} ms a batch, done before "
          f"the step asked for it in {done22['h2d_ready_share']:.2f} of the "
          f"batches | validation {json.dumps([r['val_s'] for r in val22])} s "
          f"| checkpoint {json.dumps([r['ckpt_s'] for r in val22])} s, "
          f"{val22[0]['ckpt_mb']:.0f} MB; export "
          f"{json.dumps([r['export_s'] for r in val22])} s | peak memory "
          f"{done22['peak_gib']:.3f} GiB | launches of the 12-step run "
          f"{json.dumps({k_: v_ for k_, v_ in run_launches.items() if v_})} | "
          f"resumed at step 12 on batch 12 of the index stream", flush=True)

    # -- 23. COCO inputs -----------------------------------------------------------
    # The recipe's real inputs at full width and depth (ViT-B/16, crop 448,
    # bf16 compute).  (a) A synthetic COCO tree (24 train and 16 val_part
    # JPEGs of 281-640 px, val image 0 grayscale) packed by pack_coco into
    # two shards a split and read back through a glob, every val sample
    # equal to the tree's; a synthetic DeiT-B/16 .pth (seeded tensors in timm
    # names under {"model": ...}, with the 1000-row head and the
    # distillation token that must be dropped).  (b) tools/train_torch.py
    # --dataset coco from the shards and from the .pth, batch 4, 6 steps
    # (seg_static 0-2, full 3-5), validation and weight export at 6: both
    # students' encoders equal the .pth's tensors before step 0, finite
    # losses at every step, K1-K4 launches a step as phase 13b counts them,
    # no twin on a CUDA tensor; two runs, from the shards and from the tree
    # (s/it beside s/it).  (c) tools/eval_seg_torch.py --dataset coco on
    # (b)'s weights.npz from the val shards, then from the tree, batch 8,
    # device CRF:
    # the COCO protocol (fixed crop 448, scales 1.0 / 1.25 / 1.5 x flip
    # summed at the decoder grid), the full mean-field CRF (1 + 10 K5 applies
    # a batch: V 1 for the degree, V 81 a round); the launches of K1 and K5
    # as counted from the code; K5 against its twin on a batch's own V 81
    # operands within phase 4's bounds; histograms that sum to the labelled
    # pixels and equal between the runs.  (d) tools/crf_width_probe_torch
    # .py: the fast CRF at B 16, 448^2, C 21 / 32 / 81, pos_w 1 and 0.
    import crf_width_probe_torch
    import eval_seg_torch

    from dupl_tpu_torch.data import records as records_mod
    from dupl_tpu_torch.data.coco import CocoSegDataset, write_synthetic_coco
    from dupl_tpu_torch.data.voc import load_name_list
    from dupl_tpu_torch.engine import eval_seg as eval_mod
    from dupl_tpu_torch.models.vit import VIT_CONFIGS, ViT
    from dupl_tpu_torch.utils import metrics as plain_metrics

    ccfg23 = production_config("coco")
    nc23 = ccfg23.num_classes
    sizes23 = [(427, 640), (640, 480), (480, 640), (375, 500), (500, 375),
               (281, 500), (612, 612), (360, 640)]          # (height, width)
    twin_calls.clear()
    originals = []
    for mod, name in twins:
        fn, wrapped = counting(mod, name)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)
    plain_step = train_mod.Trainer.train_step
    plain_msc23 = eval_mod.SegEvaluator.msc_logits
    plain_apply23 = crf_cuda.kernel_apply
    try:
        with tempfile.TemporaryDirectory() as tmp23:
            # (a) the inputs
            t = time.perf_counter()
            root23, lists23 = write_synthetic_coco(
                os.path.join(tmp23, "coco"), sizes23 * 2, sizes23 * 3, seed=23)
            globs23 = {}
            for split, n_want in (("train", 24), ("val_part", 16)):
                n_ = records_mod.pack_coco(
                    root23, lists23, split,
                    os.path.join(tmp23, f"{split}.duplrec"), shards=2)
                globs23[split] = os.path.join(tmp23, f"{split}-*.duplrec")
                store = records_mod.RecordStore(globs23[split])
                check(n_ == len(store) == n_want
                      and store.path.endswith("(+1)")
                      and store.names == load_name_list(
                          os.path.join(lists23, split + ".txt")),
                      f"COCO {split} shards: {n_} packed, {store.path}")
                store.close()
            rec_va = records_mod.RecordCocoSegDataset(globs23["val_part"],
                                                      transfer_dtype="uint8")
            dir_va = CocoSegDataset(root23, lists23, "val_part",
                                    transfer_dtype="uint8")
            for i in range(len(dir_va)):
                a_, b_ = rec_va[i], dir_va[i]
                check(a_["name"] == b_["name"] and all(
                    np.array_equal(a_[k_], b_[k_])
                    for k_ in ("image", "raw_image", "label", "cls_label")),
                      f"COCO val sample {i}: records differ from the tree")
            gray = dir_va[0]["raw_image"]
            check(gray.shape[2] == 3 and np.array_equal(gray[..., 0],
                                                        gray[..., 2]),
                  "val image 0 is not the grayscale one")
            labelled23 = sum(h * w - 4 for h, w in sizes23 * 2)
            g23 = torch.Generator().manual_seed(23)
            deit = {}
            for k_, v_ in ViT(VIT_CONFIGS[ccfg23.model.backbone]
                              ).state_dict().items():
                r_ = torch.randn(v_.shape, generator=g23) * 0.02
                deit[k_] = (1.0 + r_ if "norm" in k_ and k_.endswith("weight")
                            else r_)
            d23 = deit["cls_token"].shape[-1]
            pth23 = os.path.join(tmp23, "deit_base_patch16_224.pth")
            torch.save({"model": {
                **deit, "head.weight": torch.randn(1000, d23, generator=g23),
                "head.bias": torch.zeros(1000),
                "dist_token": torch.randn(1, 1, d23, generator=g23)}}, pth23)
            inputs_s = time.perf_counter() - t
            shard_mb = sum(os.path.getsize(os.path.join(tmp23, e))
                           for e in os.listdir(tmp23)
                           if e.endswith(".duplrec")) / 1e6
            print(f"[COCO inputs] write_synthetic_coco: 24 train, 16 val_part "
                  f"JPEGs of 281-640 px (val 0 grayscale), packed in 2 shards "
                  f"a split ({shard_mb:.1f} MB), "
                  f"read back through a glob, every val sample equal to the "
                  f"tree's | DeiT-B/16 .pth of {len(deit)} encoder tensors "
                  f"+ head + dist_token, {os.path.getsize(pth23) / 1e6:.0f} MB "
                  f"| {inputs_s:.1f} s", flush=True)

            # (b) the training run, from the shards and from the tree
            run_cfg = dataclasses.replace(ccfg23, cam_iters=0,
                                          refine_switch_iters=3, gmm_iters=3)
            steps23, starts23 = [], []

            def counted_step23(self, state_, batch_, step=None, aug_ops=None):
                if step == 0:
                    starts23.append(all(
                        sd_.keys() == deit.keys() and all(
                            torch.equal(sd_[k_].cpu(), v_)
                            for k_, v_ in deit.items())
                        for sd_ in (state_.model.branch1.encoder.state_dict(),
                                    state_.model.branch2.encoder.state_dict())))
                before = {k_: f.launches for k_, f in train_counters.items()}
                out_ = plain_step(self, state_, batch_, step, aug_ops)
                steps23.append((step, {k_: f.launches - before[k_]
                                       for k_, f in train_counters.items()}))
                return out_

            train_mod.Trainer.train_step = counted_step23
            argv23 = ["--dataset", "coco", "--pretrained", pth23,
                      "--samples-per-device", "4", "--max-iters", "6",
                      "--cam-iters", "0", "--refine-switch-iters", "3",
                      "--gmm-iters", "3", "--eval-iters", "6",
                      "--log-iters", "1"]
            feeds23 = {
                "records": ["--train-records", globs23["train"],
                            "--val-records", globs23["val_part"]],
                "tree": ["--data-folder", root23, "--list-folder", lists23]}
            # one run a feed (phase 13b has taken the first calls at the
            # COCO training shapes)
            train23 = {"records": [], "tree": []}
            for i23, feed in enumerate(("records", "tree")):
                more = feeds23[feed]
                del steps23[:], starts23[:]
                work = os.path.join(tmp23, f"run{i23}_{feed}")
                for f in train_counters.values():
                    f.launches = 0
                t = time.perf_counter()
                check(train_torch.main(argv23 + more + ["--work-dir", work])
                      == 0, f"the COCO training run ({feed}) did not exit 0")
                run_s = time.perf_counter() - t
                run_dir = os.path.join(work, os.listdir(work)[0])
                recs = train_torch.read_metrics(os.path.join(run_dir,
                                                             "metrics.jsonl"))
                tr_ = [r for r in recs if r["event"] == "train"]
                va_ = [r for r in recs if r["event"] == "val"]
                check(starts23 == [True], f"{feed}: the students' encoders "
                      f"are not the .pth's before step 0")
                check([r["step"] for r in tr_] == [1, 2, 3, 4, 5, 6]
                      and [r["phase"] for r in tr_]
                      == ["seg_static"] * 3 + ["full"] * 3,
                      f"{feed}: train records "
                      f"{[(r['step'], r['phase']) for r in tr_]}")
                check(all(np.isfinite(r[k_]) for r in tr_ for k_ in
                          ("loss", "cls_loss", "ptc_loss", "seg_loss",
                           "sim_loss", "reg_loss")),
                      f"{feed}: a non-finite loss {tr_}")
                check([r["step"] for r in va_] == [6], f"{feed}: val {va_}")
                check([s_ for s_, _ in steps23] == list(range(6)),
                      f"{feed}: steps {[s_ for s_, _ in steps23]}")
                for step, got_l in steps23:
                    want_l = cexpected[phase_of(run_cfg, step)]
                    check(got_l == want_l, f"{feed} step {step}: launches "
                          f"{got_l}, expected {want_l}")
                train23[feed].append({
                    "dir": run_dir, "run_s": run_s,
                    "s_per_iter": statistics.median(r["s_per_iter"]
                                                    for r in tr_[1:]),
                    "feeder_wait_ms": statistics.median(r["feeder_wait_ms"]
                                                        for r in tr_[1:]),
                    "loss": [r["loss"] for r in tr_], "val_s": va_[0]["val_s"],
                    "launches": {k_: f.launches
                                 for k_, f in train_counters.items()}})
            train_mod.Trainer.train_step = plain_step
            check(not twin_calls, f"plain twins ran on CUDA tensors: "
                  f"{twin_calls}")
            print(f"[COCO training run] tools/train_torch.py --dataset coco "
                  f"--pretrained, ViT-B/16, crop 448, batch 4, 6 steps "
                  f"(seg_static 3, full 3), validation and export at 6 | "
                  f"encoders equal the .pth before step 0 | launches a step "
                  f"as phase 13b | runs records, tree | "
                  + " | ".join(
                      f"{feed}: " + " / ".join(
                          f"{v_['run_s']:.1f} s" for v_ in runs_) + ", "
                      + " / ".join(f"{v_['s_per_iter']:.3f}" for v_ in runs_)
                      + " s/it (median of steps 2-6), feeder wait "
                      + " / ".join(f"{v_['feeder_wait_ms']:.1f}"
                                   for v_ in runs_)
                      + " ms, validation "
                      + " / ".join(f"{v_['val_s']:.2f}" for v_ in runs_)
                      + f" s, loss {[round(x, 4) for x in runs_[0]['loss']]}"
                      for feed, runs_ in train23.items()), flush=True)

            # (c) the evaluation, from the shards and from the tree
            weights23 = os.path.join(train23["records"][0]["dir"], "checkpoints",
                                     "weights.npz")
            coco_counters = {"exp_attention": attention.exp_attention_cuda,
                             "flash_attention": attention.flash_attention_cuda,
                             "crf_apply": crf_cuda.kernel_apply_cuda}
            forwards23, widths23, k5_23 = [], [], {}

            def counted_msc23(self, x):
                before = {k_: f.launches for k_, f in coco_counters.items()}
                out_ = plain_msc23(self, x)
                forwards23.append((tuple(x.shape), before, {
                    k_: f.launches for k_, f in coco_counters.items()}))
                return out_

            def keeping_apply23(basis, coef, logc, vals, block_rows=25088):
                widths23.append(vals.shape[-1])
                if "operands" not in k5_23 and vals.shape[-1] == nc23:
                    k5_23["operands"] = tuple(
                        x.detach().float().contiguous().clone()
                        for x in (basis, coef, logc, vals))
                    k5_23["block_rows"] = block_rows
                return plain_apply23(basis, coef, logc, vals, block_rows)

            # the host's share: the COCO protocol resizes every class plane
            # of the logits to the label's size on the host, in PIL
            plain_resize23 = eval_mod.resize_logits_host
            resize_s = [0.0]

            def timed_resize23(logits, size):
                t_ = time.perf_counter()
                out_ = plain_resize23(logits, size)
                resize_s[0] += time.perf_counter() - t_
                return out_

            eval_mod.SegEvaluator.msc_logits = counted_msc23
            eval_mod.resize_logits_host = timed_resize23
            crf_cuda.kernel_apply = keeping_apply23
            # one run a feed; the first takes the first calls at the COCO
            # evaluation's shapes (a warm-up run took 1-3 s more than a
            # later run, and the 1200 s limit has no room for it)
            eval_feeds23 = {"tree": ["--data-folder", root23,
                                     "--list-folder", lists23],
                            "records": ["--records", globs23["val_part"]]}
            eval23 = {"records": [], "tree": []}
            for feed in ("records", "tree"):
                more = eval_feeds23[feed]
                del forwards23[:], widths23[:]
                resize_s[0] = 0.0
                for f in coco_counters.values():
                    f.launches = 0
                t = time.perf_counter()
                res = eval_seg_torch.main(
                    ["--dataset", "coco", "--weights", weights23, "--crf",
                     "device", "--batch-size", "8"] + more)
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t
                launches23 = {k_: f.launches for k_, f in coco_counters.items()}
                check(len(forwards23) == 4, f"{feed}: {len(forwards23)} "
                      f"forwards in two passes of two batches")
                for i, (shape, before, after) in enumerate(forwards23):
                    d_ = {k_: after[k_] - before[k_] for k_ in after}
                    check(shape == (8, 448, 448, 3)
                          and d_ == {"exp_attention": 72,
                                     "flash_attention": 0, "crf_apply": 0},
                          f"{feed} forward {i} {shape}: launches {d_}")
                    nxt = (forwards23[i + 1][1]["crf_apply"] if i < 3
                           else launches23["crf_apply"])
                    check(nxt - after["crf_apply"]
                          == (0 if i < 2 else 1 + ccfg23.crf.iter_max),
                          f"{feed}: K5 launches after forward {i}: "
                          f"{nxt - after['crf_apply']}")
                check(widths23 == ([1] + [nc23] * ccfg23.crf.iter_max) * 2,
                      f"{feed}: K5 widths {widths23}")
                for k_ in ("hist_1", "hist_2", "crf_hist"):
                    check(res[k_].shape == (nc23, nc23)
                          and res[k_].sum() == labelled23,
                          f"{feed} {k_} sums to {res[k_].sum()}, labelled "
                          f"{labelled23}")
                check(res["crf_branch"] == res["branch"] in (1, 2)
                      and all(np.isfinite(res[k_]["miou"]) for k_ in
                              ("seg_score_1", "seg_score_2", "crf_score")),
                      f"{feed}: evaluation scores")
                run_ = {"res": res, "s": eval_s, "launches": launches23,
                        "resize_s": resize_s[0]}
                eval23[feed].append(run_)
            eval_mod.SegEvaluator.msc_logits = plain_msc23
            eval_mod.resize_logits_host = plain_resize23
            crf_cuda.kernel_apply = plain_apply23
            for k_ in ("hist_1", "hist_2", "crf_hist"):
                first = eval23["records"][0]
                for run_ in eval23["tree"]:
                    check(np.array_equal(first["res"][k_], run_["res"][k_]),
                          f"{k_}: the tree run's histogram differs from the "
                          f"records run's by {np.abs(first['res'][k_] - run_['res'][k_]).sum() / 2:.0f} pixels")
    finally:
        train_mod.Trainer.train_step = plain_step
        eval_mod.SegEvaluator.msc_logits = plain_msc23
        eval_mod.resize_logits_host = plain_metrics.resize_logits_host
        crf_cuda.kernel_apply = plain_apply23
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")

    # K5 against its twin on the evaluation's own operands (bounds as in
    # phase 4): a batch of eight 448^2 images, 3,136 pivots, V 81
    kb, kc, kl_, kv = k5_23["operands"]
    check(kb.shape == (8, 448 * 448, 11) and kc.shape == (8, 11, 3136)
          and kv.shape == (8, 3136, nc23),
          f"COCO evaluation K5 operands: {tuple(kb.shape)} {tuple(kc.shape)} "
          f"{tuple(kv.shape)}")
    got = crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv)
    want = crf_cuda.kernel_apply_ref(kb[:2], kc[:2], kl_[:2], kv[:2],
                                     block_rows=k5_23["block_rows"])
    worst, mean = crf_apply_err(got[:2], want)
    k5_23["err"] = (got[:2] - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and worst <= K5_MAX
          and mean <= K5_MEAN,
          f"K5 on the COCO evaluation's operands: error {worst:.3g} / "
          f"{mean:.3g} of the column scale (max / mean; bounds {K5_MAX} / "
          f"{K5_MEAN})")
    k5_23["err_rel"] = [worst, mean]
    ones23 = torch.full((*kv.shape[:2], 1), 64.0, device=dev)  # the degree's
    k5_23["ms_v81"] = time_ms(lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_,
                                                                 kv))
    k5_23["ms_back_to_back_v81"] = time_ms(
        lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_, kv), back_to_back=True)
    k5_23["ms_v1"] = time_ms(lambda: crf_cuda.kernel_apply_cuda(kb, kc, kl_,
                                                                ones23))
    k5_23["plain_ms_v81"] = time_ms(
        lambda: crf_cuda.kernel_apply_ref(kb, kc, kl_, kv,
                                          block_rows=k5_23["block_rows"]),
        iters=3, warmup=1)
    k5_23["bound_v81"] = k5_bound(8, 448 * 448, 3136, nc23)
    ev_r = eval23["records"][0]

    def rates23(runs_):
        return (" / ".join(f"{r_['s']:.3f}" for r_ in runs_) + " s, "
                + " / ".join(f"{16 / r_['s']:.3f}" for r_ in runs_)
                + " img/s, "
                + " / ".join(f"{1e3 * r_['s'] / 2:.1f}" for r_ in runs_)
                + " ms a batch (both passes), of it "
                + " / ".join(f"{r_['resize_s']:.3f}" for r_ in runs_)
                + " s in the host's per-class logit resizes")
    print(format_score_table(
        [ev_r["res"]["seg_score_1"], ev_r["res"]["seg_score_2"],
         ev_r["res"]["crf_score"]],
        ["Seg_1", "Seg_2", f"branch{ev_r['res']['branch']}+CRF"],
        ccfg23.class_list).splitlines()[-1], flush=True)
    print(f"[COCO evaluation] tools/eval_seg_torch.py --dataset coco on the "
          f"run's weights.npz, 16 val_part images, batch 8, fixed crop 448, "
          f"scales 1.0/1.25/1.5 x flip summed at the decoder grid, full CRF "
          f"(K5 V 1 + {ccfg23.crf.iter_max} x V {nc23} a batch) | a "
          f"run from the records (the first calls at these shapes), then "
          f"from the tree | records {rates23(eval23['records'])}"
          f"; tree {rates23(eval23['tree'])} | launches of a run "
          f"{json.dumps(ev_r['launches'])} (a "
          f"forward: K1 72; K5 {1 + ccfg23.crf.iter_max} a CRF batch) | "
          f"histograms sum to the {labelled23} labelled pixels and equal "
          f"between the feeds | K5 on a batch's V {nc23} operands: "
          f"max_abs_err {k5_23['err']:.4g}, over the column scale "
          f"{worst:.3g} / {mean:.3g} (max / mean; bounds {K5_MAX} / "
          f"{K5_MEAN}); kernel ms V {nc23} {k5_23['ms_v81']:.4f} (back to "
          f"back {k5_23['ms_back_to_back_v81']:.4f}), V 1 "
          f"{k5_23['ms_v1']:.4f}, plain ms V {nc23} "
          f"{k5_23['plain_ms_v81']:.4f}; bound "
          f"{k5_23['bound_v81'][0]:.4f} ({k5_23['bound_v81'][1]})",
          flush=True)
    del kb, kc, kl_, kv, got, want, ones23, k5_23["operands"]
    torch.cuda.empty_cache()

    # (d) the width probe: one K5 launch a fast-CRF call
    originals = []
    for mod, name in twins:
        fn, wrapped = counting(mod, name)
        originals.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        crf_cuda.kernel_apply_cuda.launches = 0
        rows23 = crf_width_probe_torch.main([])
        probe_launches = crf_cuda.kernel_apply_cuda.launches
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    check(not twin_calls, f"plain twins ran on CUDA tensors: {twin_calls}")
    check(probe_launches == len(rows23) * 6 and len(rows23) == 6
          and all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows23),
          f"width probe: {probe_launches} K5 launches, rows {rows23}")
    print(f"[COCO CRF width probe] tools/crf_width_probe_torch.py, fast CRF "
          f"at B 16, 448^2 (K5 at V C + 1, one launch a call; "
          f"{probe_launches} launches) | ms a call " + ", ".join(
              f"C {r_['classes']} pos_w {r_['pos_w']:g}: {r_['ms']:.3f}"
              for r_ in rows23), flush=True)

    # -- 24. data-parallel and fully-sharded training ---------------------------
    expected24 = p24_expected(expected)
    t24 = time.perf_counter()
    launches24, bare24, weights24 = phase24(dev, expected24)
    print(f"[data parallel] phase 24 took {time.perf_counter() - t24:.1f} s",
          flush=True)

    # -- 25. the sealed artifacts ------------------------------------------------
    t25 = time.perf_counter()
    rec25 = phase25(dev, bodies)
    srv25, lab25, http25 = rec25["serving"], rec25["pseudo_label"], rec25["http"]
    print(f"[sealed serving] export_serving, ViT-B/16 dual student at depth "
          f"{P24_DEPTH} of 12, crop 448, "
          f"batch 8, MSC 1.0/1.5/1.25 x flip, ensemble, fast CRF; "
          f"load_artifact in a fresh process, phase 5's 16 images | labels "
          f"equal to live {json.dumps(srv25['shares'])} (bound {P25_AGREE}) | "
          f"launches a dispatch {json.dumps(srv25['launches'])} sealed, as "
          f"live | dispatch ms live {srv25['live_ms']:.2f} sealed "
          f"{srv25['sealed_ms']:.2f} (bench_serve_torch.py's method, "
          f"{P25_ITERS} back to back) | artifact {srv25['mb']:.1f} MB, export "
          f"{srv25['export_s']:.1f} s, save {srv25['save_s']:.1f} s, load "
          f"{srv25['load_s']:.1f} s", flush=True)
    print(f"[sealed pseudo-labels] export_pseudo_labeler, batch 16, both "
          f"class-budget routes in one program (torch.cond) | within budget, "
          f"past it: refined and CRF labels equal to live "
          f"{json.dumps(lab25['shares'])} | launches a call "
          f"{json.dumps(lab25['launches'])} sealed, as live | artifact "
          f"{lab25['mb']:.1f} MB, export {lab25['export_s']:.1f} s, save "
          f"{lab25['save_s']:.1f} s, load {lab25['load_s']:.1f} s", flush=True)
    print(f"[sealed HTTP] tools/serve_torch.py --artifact: {http25['requests']} "
          f"requests all 200 | up in {http25['start_s']:.1f} s, round "
          f"{http25['round_s']:.2f} s", flush=True)
    print(f"[ops host] host us a call through the op: K1 "
          f"{json.dumps(k1['host_us'])} | K2 {json.dumps(k2['host_us'])} | "
          f"phase 25 took {time.perf_counter() - t25:.1f} s", flush=True)

    # -- 26. tensor parallelism ----------------------------------------------------
    launches26, k1_err26, k2_err26, int8_tp26 = phase26(
        dev, expected24, bare24, weights24)
    del bare24, weights24

    # -- 27. the run operations: CAM grids, FLOP counts, the MFU line -------------
    t27 = time.perf_counter()
    grid_launches27 = phase27(dev, smi, flops17)
    print(f"[run operations] phase 27 took {time.perf_counter() - t27:.1f} s",
          flush=True)

    # -- 28. the co-run: the card against the CPU in lockstep ---------------------
    t28 = time.perf_counter()
    launches28 = phase28(dev)
    print(f"[co-run] phase 28 took {time.perf_counter() - t28:.1f} s",
          flush=True)

    # -- 29. the JAX side's measurement programs on the port ----------------------
    t29 = time.perf_counter()
    rec29 = phase29(dev, smi)
    print(f"[measurement tools] phase 29 took {time.perf_counter() - t29:.1f}"
          f" s", flush=True)

    # -- 30. the exact GELU and the int8 inference path -------------------------
    t30 = time.perf_counter()
    rec30 = phase30(dev, smi, rec29["voc_rows"])
    print(f"[GELU and int8] phase 30 took {time.perf_counter() - t30:.1f} s",
          flush=True)

    # -- 31. float16: G's and K4's f16 modes, the f16 serving and labels ----------
    t31 = time.perf_counter()
    rec31 = phase31(dev, smi)
    print(f"[float16] phase 31 took {time.perf_counter() - t31:.1f} s",
          flush=True)

    # The kernels line.  ``launches``: the count of one run of the main path
    # that uses the kernel (the serving round for K1 and K5, the timed
    # pseudo-label calls for K3 and K4, one full-phase training step for K2,
    # the measured evaluation run for L1f, the grad_step at crop 768 for
    # L1b), each read with the counts set to 0 just before; the
    # ``*_coco_*`` keys are phase 23's runs, counted the same way.  ``bound_ms``: from the
    # shapes timed here; each input read once, each output written once.
    k1_key, k2_key = "BH=192,N=1765", "B=4,N=785,H=12,D=64"
    k3_key, k4_key = "uint8", "B=16,224x224,C=40,float32"
    k5_key = "B=2,N=200704,Ns=3136,V=22"
    l1f_key = "B=16,N=2117,H=12,D=64"
    p1_key, p2_key = "BH=768,N=1765", "B=64,N=1765,H=12,D=64"
    taps = 8 * len(cfg.par.dilations)
    pix = 16 * 224 * 224
    bounds = {
        # 2 products of 2 N^2 D FLOPs a head; q, k, v in, out written, bf16
        "exp_attention": bound_ms(4 * 192 * 1765 ** 2 * 64, "bf16",
                                  4 * 192 * 1765 * 64 * 2),
        # 5 products a head; q, k, v, g in, dq, dk, dv out, bf16
        "exp_attention_bwd": bound_ms(10 * 48 * 785 ** 2 * 64, "bf16",
                                      7 * 48 * 785 * 64 * 2),
        "crf_apply": k5_bound(2, 200704, 3136, 22),
        # per pixel ~20 fp32 operations a tap; 12 bytes in, 4 a tap out
        "par_affinity": bound_ms(20 * taps * pix, "fp32", pix * (12 + 4 * taps)),
        # 10 rounds of one fp32 FMA a tap and pixel-channel; masks in and
        # out, the affinity in, fp32
        "par_propagate": bound_ms(cfg.par.num_iter * 2 * taps * pix * 40,
                                  "fp32", 4 * pix * (2 * 40 + taps)),
        # 2 products of 2 N^2 D FLOPs a head; q, k, v in, out written, bf16,
        # and the fp32 log-sum-exp
        "flash_attention": bound_ms(4 * 192 * 2117 ** 2 * 64, "bf16",
                                    192 * 2117 * (4 * 64 * 2 + 4)),
        # 5 products a head; q, k, v, out, g and lse in, dq, dk, dv out
        "flash_attention_bwd": bound_ms(10 * 24 * 2305 ** 2 * 64, "bf16",
                                        24 * 2305 * (8 * 64 * 2 + 4)),
        # P1: K1's two products plus the ones column (2 N^2 FLOPs a head)
        "exp_attention_ones": bound_ms(768 * 1765 ** 2 * (4 * 64 + 2), "bf16",
                                       4 * 768 * 1765 * 64 * 2),
        # P2: K1's work; the scale is N D multiplies a head
        "exp_attention_bnhd": bound_ms(4 * 768 * 1765 ** 2 * 64, "bf16",
                                       4 * 768 * 1765 * 64 * 2),
        # P3 as K5 counts it: the fp32 score is the design's largest term
        # (the 2 VP FLOPs on the tensor cores take 0.49 ms at their peak,
        # the exps 2.4 ms at the special-function unit's rate)
        "crf_apply_bf16": p3_bound,
        # P4, the fp32 exp variant: one MUFU an element-pass
        "exp_rate": bound_ms(n21, "sfu", 2 * 4 * 512 * 1024),
    }
    # K5 at the evaluation's shape, beside its entry's serving shape; the
    # same bound at V 82 (the score and the exp are the same work)
    k5_eval_bound = k5_bound(8, 189504, 2961, 21)
    k5_v82_bound = k5_bound(8, 189504, 2961, 82)

    def entry(name, source, replaces, launches_, err, ms, plain, library,
              **more):
        b_ms, b_by = bounds[name]
        return {"name": name, "route": "cuda",
                "source": f"dupl_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
                **more}

    def per_phase(name):
        return {ph: train12[ph]["launches"][name] for ph in train12}

    kernels = [
        entry("exp_attention", "exp_attention.cu",
              "dupl_tpu/ops/attention.py:98", launches["exp_attention"],
              k1["err"], k1["ms"][k1_key], k1["plain_ms"][k1_key],
              k1["library_ms"][k1_key],
              ms_back_to_back=k1["ms_back_to_back"][k1_key],
              host_us=k1["host_us"][k1_key], ms_by_shape=k1["ms"],
              ms_back_to_back_by_shape=k1["ms_back_to_back"],
              host_us_by_shape=k1["host_us"],
              library_ms_by_shape=k1["library_ms"],
              launches_pseudo_label=pl_launches["exp_attention"],
              launches_eval=eval_launches["exp_attention"],
              launches_coco_eval=ev_r["launches"]["exp_attention"],
              launches_train=per_phase("exp_attention"),
              max_abs_err_tensor_parallel=k1_err26,
              launches_cam_grids=grid_launches27),
        entry("exp_attention_bwd", "exp_attention_bwd.cu",
              "dupl_tpu/ops/attention.py:164",
              train12["full"]["launches"]["exp_attention_bwd"], k2["err"],
              k2["ms"][k2_key], k2["plain_ms"][k2_key],
              k2["library_ms"][k2_key],
              ms_back_to_back=k2["ms_back_to_back"][k2_key],
              host_us=k2["host_us"][k2_key], ms_by_shape=k2["ms"],
              ms_back_to_back_by_shape=k2["ms_back_to_back"],
              host_us_by_shape=k2["host_us"],
              library_ms_by_shape=k2["library_ms"],
              launches_train=per_phase("exp_attention_bwd"),
              max_abs_err_tensor_parallel=k2_err26),
        entry("crf_apply", "crf_apply.cu", "dupl_tpu/ops/crf_pallas.py:30",
              launches["crf_apply"], k5["err"], k5["ms"][k5_key],
              k5["plain_ms"][k5_key], None,
              launches_pseudo_label=pl_launches["crf_apply"],
              launches_eval=eval_launches["crf_apply"],
              ms_back_to_back=k5["ms_back_to_back"][k5_key],
              ms_by_shape=k5["ms"],
              ms_back_to_back_by_shape=k5["ms_back_to_back"],
              err_rel_by_shape=k5["err_rel"], wrong_twins_rel=k5["wrong_rel"],
              eval_shape=k5_eval["key"], ms_eval=k5_eval["ms"],
              ms_back_to_back_eval=k5_eval["ms_back_to_back"],
              plain_ms_eval=k5_eval["plain_ms"], err_rel_eval=k5_eval["err_rel"],
              bound_ms_eval=k5_eval_bound[0], bound_by_eval=k5_eval_bound[1],
              ms_v82=k5["ms"]["B=2,N=200704,Ns=3136,V=82"],
              plain_ms_v82=k5["plain_ms"]["B=2,N=200704,Ns=3136,V=82"],
              bound_ms_v82=k5_bound(2, 200704, 3136, 82)[0],
              ms_eval_v82=k5_eval["ms_v82"],
              ms_back_to_back_eval_v82=k5_eval["ms_back_to_back_v82"],
              bound_ms_eval_v82=k5_v82_bound[0],
              launches_coco_serving=k5_coco,
              launches_coco_eval=ev_r["launches"]["crf_apply"],
              coco_eval_shape=f"B=8,N=200704,Ns=3136,V={nc23}",
              ms_coco_eval=k5_23["ms_v81"],
              ms_back_to_back_coco_eval=k5_23["ms_back_to_back_v81"],
              ms_coco_eval_v1=k5_23["ms_v1"],
              plain_ms_coco_eval=k5_23["plain_ms_v81"],
              err_rel_coco_eval=k5_23["err_rel"],
              bound_ms_coco_eval=k5_23["bound_v81"][0],
              launches_width_probe=probe_launches),
        entry("par_affinity", "par_affinity.cu",
              "dupl_tpu/ops/par_pallas.py:141", pl_launches["par_affinity"],
              k3["err"], k3["ms"][k3_key], k3["plain_ms"][k3_key], None,
              launches_train=per_phase("par_affinity"),
              ms_back_to_back=k3["ms_back_to_back"][k3_key],
              ms_by_shape=k3["ms"],
              ms_back_to_back_by_shape=k3["ms_back_to_back"],
              plain_ms_by_shape=k3["plain_ms"],
              wrong_twins_err=k3["wrong_err"]),
        entry("par_propagate", "par_propagate.cu",
              "dupl_tpu/ops/par_pallas.py:37", pl_launches["par_propagate"],
              k4["err"][k4_key], k4["ms"][k4_key], k4["plain_ms"][k4_key],
              None, launches_train=per_phase("par_propagate"),
              ms_back_to_back=k4["ms_back_to_back"][k4_key],
              ms_by_shape=k4["ms"],
              ms_back_to_back_by_shape=k4["ms_back_to_back"],
              plain_ms_by_shape=k4["plain_ms"]),
        entry("flash_attention", "flash_attention.cu",
              "dupl_tpu/ops/attention.py:295",
              eval_launches["flash_attention"], l1f["err"],
              l1f["ms"][l1f_key], l1f["plain_ms"][l1f_key],
              l1f["library_ms"][l1f_key],
              launches_grad_step_768=launches17["flash_attention"],
              ms_by_shape=l1f["ms"], library_ms_by_shape=l1f["library_ms"],
              ms_back_to_back_by_shape=l1f["ms_back_to_back"]),
        entry("flash_attention_bwd", "flash_attention_bwd.cu",
              "dupl_tpu/ops/attention.py:295",
              launches17["flash_attention_bwd"], l1b["err"],
              l1b["ms"][l1b_key], l1b["plain_ms"][l1b_key],
              l1b["library_ms"][l1b_key],
              ms_back_to_back=l1b["ms_back_to_back"][l1b_key]),
        entry("exp_attention_ones", "exp_attention_ones.cu",
              "tools/exp_attn_experiment.py:33", p1_launches, p1["err"],
              p1["ms"][p1_key], p1["plain_ms"][p1_key],
              p1["library_ms"][p1_key], k1_ms=p1["k1_ms"][p1_key],
              ms_back_to_back=p1["ms_back_to_back"][p1_key],
              ms_by_shape=p1["ms"],
              ms_back_to_back_by_shape=p1["ms_back_to_back"],
              k1_ms_by_shape=p1["k1_ms"]),
        entry("exp_attention_bnhd", "exp_attention_bnhd.cu",
              "tools/exp_attn_layout_experiment.py:34", p2_launches, p2["err"],
              p2["ms"][p2_key], p2["plain_ms"][p2_key],
              p2["library_ms"][p2_key], scale_pass_and_k1_ms=p2["k1_ms"][p2_key],
              ms_back_to_back=p2["ms_back_to_back"][p2_key],
              ms_by_shape=p2["ms"],
              ms_back_to_back_by_shape=p2["ms_back_to_back"],
              scale_pass_and_k1_ms_by_shape=p2["k1_ms"]),
        entry("crf_apply_bf16", "crf_apply_bf16.cu",
              "tools/crf_apply_experiment.py:53", p3_launches, p3["err"],
              rec20["bf16_ms"], p3["plain_ms"], None, k5_ms=rec20["fp32_ms"],
              err_rel=[p3["max_rel"], p3["mean_rel"]],
              wrong_rel=[p3["wrong_max_rel"], p3["wrong_mean_rel"]],
              share_of_bound=p3["share"], crf_operands=p3["crf"]),
        entry("exp_rate", "exp_rate.cu", "tools/exp_rate_experiment.py:28",
              p4_launches, p4["err"], p4["variants"]["float32 exp"]["ms"],
              p4["variants"]["float32 exp"]["plain_ms"], None,
              variant="float32 exp", variants=p4["variants"]),
    ]
    for e in kernels[:5]:   # K1-K4 in the training runs
        if e["name"] in run_launches and e["name"] != "crf_apply":
            e["launches_train_run"] = run_launches[e["name"]]
            e["launches_coco_train_run"] = train23["records"][0]["launches"][
                e["name"]]
            for arm, by_phase in launches24.items():
                e[f"launches_train_{arm.replace(' ', '_')}"] = {
                    ph: n_[e["name"]] for ph, n_ in by_phase.items()}
            e["launches_train_tensor_parallel"] = {
                ph: n_[e["name"]] for ph, n_ in launches26.items()}
            e["launches_corun"] = {
                arm: {ph: n_[e["name"]] for ph, n_ in by_phase.items()}
                for arm, by_phase in launches28.items()}
    for e in kernels[:5]:   # K1, K3, K4, K5 in the sealed programs' calls
        if e["name"] in P25_SERVING:
            e["launches_sealed_serving"] = srv25["launches"][e["name"]]
            e["launches_sealed_pseudo_label"] = lab25["launches"][e["name"]]
    # Phase 29: K1 / K3 / K4 / K5 launches a bench_torch call; K4 at C 324
    # (bf16: the products run as bf16x2 FMAs, twice the fp32 rate) and K5
    # at V 33 with the bounds of their operands
    k4w, k5w = rec29["k4_c324"], rec29["k5_v33"]
    b4, h4, w4, c4 = k4w["shape"]
    pix4 = b4 * h4 * w4
    k4w["bound_ms"], k4w["bound_by"] = bound_ms(
        cfg.par.num_iter * 2 * taps * pix4 * c4 / 2, "fp32",
        4 * pix4 * 2 * c4 + 2 * pix4 * taps)
    k5w["bound_ms"], k5w["bound_by"] = k5_bound(*k5w["shape"])
    by_name = {e["name"]: e for e in kernels}
    for name, n_ in rec29["launches_bench"].items():
        by_name[name]["launches_bench"] = n_
    by_name["par_propagate"]["c324"] = k4w
    by_name["crf_apply"]["v33"] = k5w
    # Phase 30: G (its launches: the serving round's; the backward's: a
    # full-phase training step of phase 12), Q1's two entries and Q2 (their
    # launches: the int8 path's run); times at the MLP's hidden width, the
    # pair at qkv's shape, the GELU entry at fc2's and Q2 at fc1's
    g30, fc1 = rec30["gelu_erf"], rec30["quant"]["fc1"]
    qkv30, f30 = rec30["quant"]["qkv"], rec30["gelu_quantize_pair"]
    kernels += [
        {"name": "gelu_erf", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/gelu_erf.cu",
         "replaces": "dupl_tpu/models/vit.py:90 (nn.gelu, an XLA fusion; no "
                     "Pallas kernel)",
         "launches": launches["gelu_erf"], "max_abs_err": 0.0,
         "ms": g30["ms"], "plain_ms": g30["plain_ms"],
         "bound_ms": g30["bound_ms"], "bound_by": g30["bound_by"],
         "library_ms": g30["library_ms"],
         "launches_train": {ph: train12[ph]["launches_g"]["gelu_erf"]
                            for ph in train12},
         "launches_bwd_train": {ph: train12[ph]["launches_g"]["gelu_erf_bwd"]
                                for ph in train12},
         **{k_: g30[k_] for k_ in ("unequal", "wrong_unequal", "shape",
                                   "ms_bwd", "plain_ms_bwd", "bound_ms_bwd",
                                   "bound_by_bwd", "library_ms_bwd",
                                   "ms_back_to_back", "library_ms_back_to_back",
                                   "ms_bwd_back_to_back",
                                   "library_ms_bwd_back_to_back",
                                   "ms_by_branch", "ms_bwd_by_branch", "fp32",
                                   "registers")}},
        {"name": "quantize_pair", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/quantize_rows.cu",
         "replaces": "dupl_tpu/ops/quant.py:36-43 (an XLA fusion; no Pallas "
                     "kernel)",
         "launches": rec30["path"]["launches"]["quantize_pair"],
         "max_abs_err": 0.0, "ms": qkv30["q1_ms"],
         "ms_back_to_back": qkv30["q1_ms_back_to_back"],
         "plain_ms": qkv30["q1_plain_ms"], "bound_ms": qkv30["q1_bound_ms"],
         "bound_by": qkv30["q1_bound_by"], "library_ms": None,
         "wrong_unequal": fc1["q1_wrong_unequal"],
         "unequal_by_shape": {k_: v_["q1_unequal"]
                              for k_, v_ in rec30["quant"].items()},
         "device_ms": qkv30["q1_device_ms"],
         "by_product": {k_: {f: v_[f] for f in ("shape", "dtype", "q1_ms",
                                                "q1_ms_back_to_back",
                                                "q1_device_ms",
                                                "q1_plain_ms", "q1_bound_ms")}
                        for k_, v_ in rec30["quant"].items() if "q1_ms" in v_}},
        {"name": "gelu_quantize_pair", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/quantize_rows.cu",
         "replaces": "dupl_tpu/models/vit.py:90-91 (nn.gelu and fc2's "
                     "quantization, dupl_tpu/ops/quant.py:36-43: XLA "
                     "fusions; no Pallas kernel)",
         "launches": rec30["path"]["launches"]["gelu_quantize_pair"],
         "max_abs_err": 0.0, "ms": f30["ms_tanh"],
         "ms_back_to_back": f30["ms_tanh_back_to_back"],
         "plain_ms": f30["plain_ms"], "bound_ms": f30["bound_ms"],
         "bound_by": f30["bound_by"], "library_ms": None,
         **{k_: f30[k_] for k_ in ("shape", "ms_erf", "ms_erf_back_to_back",
                                   "device_ms_tanh", "device_ms_erf",
                                   "plain_ms_erf", "tanhf_chain_ms",
                                   "gelu_erf_ms",
                                   "wrong_unequal", "unequal",
                                   "bf16_gelu_tanh_card_vs_cpu")}},
        {"name": "int8_linear", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "dupl_tpu/ops/quant.py:45-48 (an XLA int8 dot; no "
                     "Pallas kernel)",
         "launches": rec30["path"]["launches"]["int8_linear"],
         "max_abs_err": 0.0, "ms": fc1["q2_ms"],
         "ms_back_to_back": fc1["q2_ms_back_to_back"],
         "library_ms_back_to_back": fc1["library_ms_back_to_back"],
         "plain_ms": fc1["q2_plain_ms"], "bound_ms": fc1["q2_bound_ms"],
         "bound_by": fc1["q2_bound_by"], "library_ms": fc1["library_ms"],
         "wrong_unequal": fc1["wrong_unequal"],
         "unequal_by_shape": {k_: v_["q2_unequal"]
                              for k_, v_ in rec30["quant"].items()},
         "by_product": {k_: {f: v_[f] for f in ("shape", "dtype", "q2_ms",
                                                "q2_ms_back_to_back",
                                                "q2_plain_ms", "q2_bound_ms",
                                                "library_ms",
                                                "library_ms_back_to_back")}
                        for k_, v_ in rec30["quant"].items() if "q2_ms" in v_}},
    ]
    # Phase 30 (b2) and phase 26: Q1's two passes, Q2's int32 product and
    # the rescale (their launches: a rank's int8 CAM stage under tensor
    # parallelism), timed at a rank's fc2 share (K 1536 of fc1's fp32
    # output through the tanh GELU; proj's share beside it)
    two = rec30["two_pass"]
    fc2s, projs = two["fc2_tp2"], two["proj_tp2"]
    split_replaces = ("dupl_tpu/ops/quant.py:36-48 under GSPMD (a "
                      "row-parallel QDense: XLA's reduce, all-reduce, s32 "
                      "dot and rescale fusion; no Pallas kernel)")

    def split_entry(name, source, key, library=None):
        return {"name": name, "route": "cuda",
                "source": f"dupl_tpu_torch/csrc/{source}",
                "replaces": split_replaces,
                "launches": int8_tp26[name], "max_abs_err": 0.0,
                "ms": fc2s[f"{key}_ms"][0],
                "ms_back_to_back": fc2s[f"{key}_ms"][1],
                "plain_ms": fc2s[f"{key}_plain_ms"],
                "bound_ms": fc2s[f"{key}_bound_ms"],
                "bound_by": fc2s[f"{key}_bound_by"],
                "library_ms": None if library is None else library[0],
                "library_ms_back_to_back": (None if library is None
                                            else library[1]),
                "shape": fc2s["shape"],
                "proj_share": {f: projs.get(f"{key}_{f}") for f in (
                    "ms", "plain_ms", "bound_ms")},
                "unequal_by_shape": {k_: v_["unequal"][name]
                                     for k_, v_ in two.items()},
                "wrong_unequal": {k_: v_["wrong_unequal"][name]
                                  for k_, v_ in two.items()}}
    kernels += [
        split_entry("row_absmax_pair", "quantize_rows.cu", "absmax"),
        split_entry("quantize_pair_given", "quantize_rows.cu", "given"),
        split_entry("int8_matmul_i32", "int8_gemm.cu", "i32",
                    fc2s["i32_library_ms"]),
        split_entry("int8_rescale", "int8_gemm.cu", "rescale"),
    ]
    by_name = {e["name"]: e for e in kernels}
    for name in ("quantize_pair", "int8_linear"):
        by_name[name]["launches_tensor_parallel"] = int8_tp26[name]
    by_name["par_affinity"]["past_cap"] = k3["past_cap"]
    by_name["par_propagate"]["past_cap"] = k4["past_cap"]
    # Phase 31: G's and K4's f16 modes (their launches: the f16 serving
    # dispatch's for G, the f16 pseudo-label call's for K4; times at the
    # MLP's hidden shape and at 16 x 224^2, C 40, the recipe's dilations)
    g31, k31 = rec31["gelu_erf_f16"], rec31["par_propagate_f16"]
    k31_key = next(iter(k31["ms"]))
    kernels += [
        {"name": "gelu_erf_f16", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/gelu_erf.cu",
         "replaces": "dupl_tpu/models/vit.py:90 (nn.gelu on float16, an XLA "
                     "fusion; no Pallas kernel)",
         "launches": rec31["serve_launches"]["gelu_erf_f16"],
         "launches_pseudo_label": rec31["pl_launches"]["gelu_erf_f16"],
         "max_abs_err": g31["max_abs_err"], "ms": g31["times"][0],
         "ms_back_to_back": g31["times"][1], "graph_ms": g31["graph_ms"],
         "plain_ms": g31["plain_ms"], "bound_ms": g31["bound_ms"],
         "bound_by": g31["bound_by"], "library_ms": g31["library_times"][0],
         "library_ms_back_to_back": g31["library_times"][1],
         "library_graph_ms": g31["library_graph_ms"],
         **{k_: g31[k_] for k_ in ("unequal", "unequal_main_shape",
                                   "wrong_unequal", "shape", "bwd_times",
                                   "bwd_graph_ms", "bf16_times",
                                   "bf16_bwd_times", "library_bwd_times",
                                   "plain_ms_bwd", "bound_ms_bwd",
                                   "bound_by_bwd", "registers")}},
        {"name": "par_propagate_f16", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/par_propagate.cu",
         "replaces": "dupl_tpu/ops/par_pallas.py:37 (propagate_pallas's "
                     "_kernel at compute_dtype float16)",
         "launches": rec31["pl_launches"]["par_propagate_f16"],
         "max_abs_err": k31["max_abs_err"], "ms": k31["ms"][k31_key],
         "ms_back_to_back": k31["ms_back_to_back"][k31_key],
         "plain_ms": k31["plain_ms"][k31_key],
         "bound_ms": k31["bound"][k31_key][0],
         "bound_by": k31["bound"][k31_key][1], "library_ms": None,
         "shape": k31_key, "unequal": k31["unequal"],
         "unequal_bf16_twin": k31["unequal_bf16_twin"],
         "ms_by_shape": k31["ms"],
         "ms_back_to_back_by_shape": k31["ms_back_to_back"],
         "plain_ms_by_shape": k31["plain_ms"], "bound_by_shape": k31["bound"],
         "bf16_ms_by_shape": k31["bf16"], "fp32_ms_by_shape": k31["fp32"]},
    ]
    check(all(e["launches"] > 0 for e in kernels) and len(kernels) == 21,
          "a kernel of a main path never launched")
    check(all(isinstance(e[k_], (int, float))
              for e in kernels for k_ in ("launches", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms"))
          and all(isinstance(e["library_ms"], (int, float, type(None)))
                  for e in kernels),
          "the kernels line holds a non-number where a number belongs")
    print(f"[chip_smoke] phases 1-31 took {time.perf_counter() - t_main:.1f} s"
          f" (limit 1200)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
