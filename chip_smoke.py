#!/usr/bin/env python3
"""Smoke run of the torch port (sav_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py [--seed 0] [--batch 32] [--profile]

1. Refuses to run without a CUDA device; prints the card's name and power
   limit (nvidia-smi) and builds every kernel from csrc/ with nvcc.
2. Holds each hand-written kernel against its plain PyTorch twin on the
   card, in bf16, and times kernel, twin and one library call computing
   the same function (timed only; the port never calls it): K1 and K4 at
   the serving shapes (for K1 also the sublayer on the 'flash' core, the
   route ``fused_layer.auto_core`` weighs it against), K4 also at the
   ``fused_ff`` training shape (B=192, L=197); K1's training variant, K2
   and K3 at the training shapes (K2 and K3 both at L = 197 and at 200
   over 190 keys, so ``flash_attention.fused_bwd_fits`` routes by a
   measured threshold; K3 also as the pair against SDPA's backward; K2 and K3 each
   two calls bit-identical); K4 and K2 through their C entries into
   NaN-sentinel buffers one image longer than the call, at L = 197, 200
   over 190 keys, 577 (K4), a 1-row tail (129) and q_len != kv_len; each
   flash kernel's ptxas line (registers, spills, any wgmma warning), and
   K1's (its LN and projection GEMMs); each K1 and K5a launch's device
   time (torch.profiler) on a line of its own.
3. Serves ViT-B/16 bf16 through ``sav_tpu_torch.predict.serve``: @224 with
   use_kernel='auto' (the K1 port, 12 launches per forward), @384 with
   use_kernel='fused_layer' (the K4 port, 12 launches) and @384 with 'auto'
   (K1 again), with launch counts set to 0 just before each forward and
   read just after, logits checked against the plain cores
   (use_kernel=False) on the same weights, img/s.
4. Trains ViT-B/16 bf16 through ``sav_tpu_torch.train.Trainer`` (what
   ``python -m sav_tpu_torch.train`` builds) on its synthetic source: @224
   bs192 (12 K1-train + 12 K2 launches per step) and @384 bs48 (12 K1-train
   + 12 K3a + 12 K3b), counts set to 0 just before one step and read just
   after; loss finite; every parameter's gradient on one batch against the
   plain core (use_kernel='fused_layer_xla', same boundary), with the f32
   per-op path as the reference that sets the bf16 noise floor; train
   img/s over 10 steps after warm-up; one eval batch.
5. CaiT-S/24 (slice 3): the talking-heads kernels against their twins at
   the paths' shapes (K5a serve B=32 and train B=128 at L=196, B=32 and
   B=48 at L=576, K5b B=128; K5a and K5b also at cait_xxs_24's four heads
   and D = 192, B=32 and B=128 at L=196; K6a and K6b, the blocked route's
   entries, at four heads, B=32 and B=128 at L=196, and at L=576 with
   eight), outputs, lse, dq/dk/dv and
   dM_pre/dM_post, K6a's and the backward's two calls bit-identical and
   their ptxas lines, the ragged last tile on its own at L = 196, 197, 576
   and 577; serving CaiT-S/24 @224 and @384 (24 K5a launches per forward)
   and cait_xxs_24 @224 (24 K5a) at batch 32 with logits against the
   per-op path; training through the Trainer CaiT-S/24 @224 bs128 and
   @384 bs48 (24 K5a-train + 24 K5b per step) and cait_xxs_24 @224 bs128
   (the same) at stochastic depth 0.1, gradients against the plain
   core (use_kernel='fused_th_xla') with the f32 per-op path as the noise
   floor on the step's whole batch, train img/s and peak memory.
6. Mixer-B/16 and the FF backward (slice 4): K8a (token mixing forward;
   the Hopper band kernel of mixer_bwd_sm90.cuh at both factory widths,
   with its launches' split) against its twin at the factory's token-mix
   shapes (L/K/D 196/98/768 at B=32 and B=192, 49/24/512, 196/98/1024),
   K8b (its backward) at B=192
   with all seven gradients, K16 (the FF-sublayer backward) at ViT-B/16
   @224 bs192's M = 37,824 rows and at ragged M = 1003 and 129 (weight
   gradients of both at WGRAD_TOL; K8b's and K16's two calls
   bit-identical);
   NaN-sentinel buffers past the last token row and
   past M, with an odd batch; serving Mixer-B/16 @224 bs32 (12 K8a
   launches per forward, logits against the per-op path); training it
   @224 bs192 (12 K8a + 12 K8b per step, gradients against
   use_kernel=False); training ViT-B/16 @224 bs192 under
   use_kernel='fused_ff' (12 K4 + 12 K2 + 12 K16 per step, gradients
   against use_kernel='kernel': the same K4/K2 attention with the library
   FF backward).
7. TNT-S/16 and TNT-B/16 (slice 5): K1 without the residual (both
   variants) against its twin at the outer sublayer's shapes (B=32,
   L=197, D/H 384/6 and 640/10); K7a (the whole inner layer) at TNT-S's
   serving and training shapes (B*P = 32 x 196 and 64 x 196, D=24) and
   TNT-B's (32 x 196, D=40), K7b (its backward: dx and 12 parameter
   gradients from per-block partials, two calls bit-identical, with its
   launches' split) at TNT-S bs64 and TNT-B bs32, the ragged tail (an odd
   B*P, at both widths) on NaN-sentinel buffers, K7a's last 4-patch unit
   holding 1, 2 and 3 patches (both widths, sentinel buffers) and the
   warp-a-patch route at two other widths; serving TNT-S @224
   bs32 (12 K7a + 12 K1 launches per forward, logits against the per-op
   path); training TNT-S @224 bs64 and TNT-B @224 bs32 (12 K7a + 12 K7b +
   12 K1-train + 12 K2 per step, gradients against the plain core on the
   outer sublayer's boundary, use_kernel='fused_layer_xla', with the f32
   per-op path as the noise floor), and TNT-S under
   use_kernel='fused_inner' (K7 inner, K4/K2 outer) beside it.
8. BoTNet-T3 (slice 6): K9a (the relative-position attention forward)
   against its twin at the BoT stage's serving and training shapes (B=32
   and B=64, L=196 on a 14 x 14 grid, 4 heads of d=128, f32 rel logits),
   K9b (its backward: the dq and the dkv kernel, dq/dk/dv and drel_h/
   drel_w, two calls bit-identical) at B=64, three ragged grids (g = 5,
   13 and 20: ragged against 64-row tiles and K9a's key tiles) on
   NaN-sentinel buffers, twice; serving @224 bs32 under
   use_kernel='botnet_fused' (6 K9a launches per forward) and 'auto' (the
   per-op path, no K9), logits against use_kernel=False with filled
   BatchNorms and running statistics; training through the Trainer @224
   bs64 under 'botnet_fused' (6 K9a-train + 6 K9b dq + 6 K9b dkv per step,
   gradients against the same boundary on the K9 twins with the f32 per-op
   path as the noise floor, every running statistic finite and moved by
   the timed steps, eval in eval mode) and under 'auto' beside it.
9. int8 (slice 7): K15 (``csrc/int8_matmul.cu``), K12 and K13 serving and
   ``save_hpre`` variants (``csrc/int8_ff.cu``, ``csrc/int8_ff_sm90.cuh``)
   and K10 (``csrc/fused_attention_q8.cu``) against their twins at the
   paths' shapes (K15 M = 6304 K = 768 N = 3072 and K = 3072 N = 768, its
   C entry timed alone too; K12 M = 32 x 196 and 192
   x 196, and save_hpre at CaiT-S/24 bs128's 128 x 196 rows, D = 384, F =
   1536; K13 M = 32 x 197 and 192 x 197; K10 B = 32, L = 197, its C
   entry timed alone too), outputs
   within INT8_TOL and INT8_SHARE bit-identical (K12 and K13 also two
   calls bit-identical), timed beside a library chain
   (LayerNorm, ``torch._int_mm`` per product with the dequant in torch,
   SDPA for K10's core); ragged M and K on NaN-sentinel buffers; serving
   @224 bs32 ViT-B/16 ``quantized='ff'`` (12 K1 + 12 K13 per forward),
   ``'all'`` (12 K10 + 12 K13), ``'int8'`` at depth 4 (4 K1, no int8 kernel),
   ``'int8'`` with QuantizedDense(fused=True) (12 K1 + 24 K15), Mixer-B/16
   ``'ff'`` (12 K8a + 12 K12), logits against the same model on the int8
   twins (``set_int8_core``; 'int8' against use_kernel=False), and each
   route's distance from its bf16 model printed for information; training
   @224 bs192 ViT-B/16 ``'ff'`` (12 K1-train + 12 K2 + 12 K13-train per
   step) and Mixer-B/16 ``'ff'`` (12 K8a + 12 K8b + 12 K12-train),
   gradients against the same boundaries on the twins with the f32 path
   as the noise floor, train img/s.
10. The factory names that ``auto`` routes on the card and no path above
   builds (vit_l_patch16 @224 and @384, vit_ti_patch16, ceit_t,
   vit_s_patch16, cait_xxs_24 @224 and @384, mixer_s/l_patch16, cvt-w24
   @384 at stage sizes (1, 1, 2)) at depth 2: the kernels
   a forward launches, logits against use_kernel=False, gradients against
   the plain core by the same rule.
11. Prints one JSON line of every ported kernel, then the result line
   ``{"ok": true, "device": {...}}``. Any failed check exits non-zero and
   prints no result line.
12. int8 (slice 8; runs after 10, before the print of 11): K11
   (``csrc/th_attention_q8.cu``) against its twin at CaiT-S/24 @224 bs32
   (L = 196, D = 384, H = 8) and at cait_xxs's widths (D = 192, H = 4),
   timed through its wrapper and its C entry alone beside a library chain
   (LayerNorm, torch codes, ``torch._int_mm`` with the dequant for the
   four projections, the per-op TH core), each launch's device time; the
   quantiser K11 and K15 share (``q8::quantize_exact``) against the IEEE
   division for every bf16 value and row absmax; K14
   (``csrc/int8_ff.cu``) at ViT-B/16 bs192's M = 37,824 and CaiT-S/24
   bs128's 25,088 rows, dy2 and dh, two calls bit-identical, beside
   codes, ``_int_mm``, torch's
   gelu backward, codes, ``_int_mm``; both on NaN-sentinel buffers at a
   ragged M (K11 also at L = 250); serving CaiT-S/24
   @224 bs32 ``quantized='all'`` (24 K11 + 24 K12 per forward), @384 at
   depth 2 (th_supported fails: 2 K5a + 2 K12, no K11) and cait_xxs_24
   @224 at depth 2 (2 K11 + 2 K12), logits against the int8 twins;
   training @224 ViT-B/16 bs192 ``'ff_sb'`` (12 K1-train + 12 K2 + 12
   K13-train + 12 K14 per step) and CaiT-S/24 bs128 ``'ff_sb'`` (24
   K5a-train + 24 K5b + 24 K12-train + 24 K14), gradients against the same
   boundaries on the int8 twins, and CaiT-S/24 ``'ff'`` beside them for
   its train img/s.
13. CeiT (slice 9; after 12, before the print of 11): K1's post-LN route
   (``pre_ln=False``: three launches, the QKV GEMM reading x) against its
   twin at CeiT-S's widths (B = 32 and 64, L = 197, D = 384, H = 6), both
   variants; K1 at D = 192, H = 3 (the projection GEMM's 192-wide tile:
   ceit_t's post-LN and vit_ti's pre-LN route; each launched by the
   sweep, whose ceit_t entry is this slice's); ViT-B/16's K1 outputs
   against the digests the GEMM gave before it took D = 192
   (``scripts/k1_digest.py``'s ``K1_VITB_DIGESTS``); serving CeiT-S @224
   bs32 on ``'auto'`` and ``'fused_layer_full'`` (12 post-LN K1 launches
   per forward, none pre-LN), logits against use_kernel=False with the
   head filled and the BatchNorms calibrated; training CeiT-S @224 bs64 (12 post-LN K1
   train + 12 K2 per step), gradients against the plain core
   (use_kernel='fused_layer_xla') with the f32 per-op path as the noise
   floor, every running statistic finite and moved, train img/s.
14. CvT (slice 10; after 13, before the print of 11): K4 at cvt-13's three
   stage shapes @224 (one head at 3136 queries over 784 keys, three at 784
   over 196, six at the padded 225 over 64) at B = 32 and 64, and the K3
   pair at B = 64, against their twins (K3 two calls bit-identical), timed
   beside SDPA and its backward and the bound; K13 at cvt-13's stage 3 (D
   = 384, F = 1536, the ragged B x 225 rows, both variants) and cvt-w24's
   (D = 1024, 16 x 625 rows); serving cvt-13 @224 bs32 on 'auto' (13 K4
   launches per forward and nothing else), logits against use_kernel=False
   with the head and cls filled and the BatchNorms calibrated; training it
   @224 bs64 (13 K4 + 13 K3a + 13 K3b per step, no K2), gradients against
   the same ``flash_attention.mha`` boundary on the K4 and K3 twins
   (``models.cvt.set_attention_core``) with the f32 per-op path as the
   noise floor; serving ``quantized='ff'`` and ``'all'`` (+ 10 K13 per
   forward, stage 3 only) and training ``'ff'`` (+ 10 K13-train per step)
   against the int8 twins. With ``--profile`` each CvT path also prints
   its device time by module kind (``print_module_split``). cvt-w24 @384
   (stage sizes (1, 1, 2), bs2) is in the sweep: K4 and K3 at 9216
   over 2304 keys in 3 heads, 2304 over 576 in 12 and 625 over 169 in 16.
15. CaiT-M (slice 11; after 14, before the print of 11): the TH kernels at
   16 heads of 48 (D = 768) at cait_m_48 @224's shapes: K5a (both
   variants) and K6a at B = 16, L = 196 (the forward core in two head
   groups, a group a block at this batch), K5b and K6b (the staged
   backward, ``csrc/th_bwd_staged.cuh``) at B = 16, K11 at the int8
   serving B = 32, against their twins and timed beside the per-op
   chains and the bound; K6a, K5b/K6b and K5a at L = 197 and 577 into
   NaN-sentinel buffers; K11 at B = 3, L = 197 and 250 into sentinels;
   K11's codes and row scales against the twin's quantiser on K6a's
   bands, bit for bit. Then serving cait_m_48 @224 bs16 on 'auto' (48 K5a
   per forward), logits against use_kernel=False; training it bs16 (48
   K5a-train + 48 K5b per step), gradients against 'fused_th_xla' with
   the f32 per-op path as the noise floor; serving ``quantized='all'``
   bs32 (48 K11 + 48 K12 per forward) against the int8 twins. cait_m_24
   @384 (K5 at L = 576) is in the sweep at depth 2.
16. CaiT-XS (slice 12; after 15, before the print of 11): the TH kernels
   at 6 heads of 48 (D = 288: 4.5 boxes of 64 columns, read as 5) and the
   int8 FF kernels at D = 288, F = 1152 (a 32-wide last OUT tile, a
   half-zero last slot over D) at cait_xs_24 @224's shapes: K6a at B = 32
   and 128 (L = 196) and B = 32 at L = 576, K6b through both entries at
   B = 128, K11 at B = 32, K12 at the serving rows (32 x 196) and its
   training variant at 128 x 196, K13 at the serving rows, K14 at 128 x
   196, against their twins and timed beside the library chains and the
   bound, the last 32 columns of each output also on their own; K6a and
   K5b/K6b at L = 197 and 577 into NaN-sentinel buffers; K11 at B = 3, L
   = 197 and 250, and K12, K13 and K14 at the odd M = 1003 into
   sentinels; K11's codes and row scales against the twin's quantiser on
   K6a's bands, bit for bit; the ptxas line of each H = 6 instantiation;
   K5a (its LN and its projection GEMMs, whose last column tile and
   64-deep step are ragged at 288, around the core) at B = 32 and 128 (L
   = 196) and B = 32 at L = 576, each output's last 32 columns also on
   their own, and at L = 197 and 577 into NaN sentinels. Then serving
   cait_xs_24 @224 bs32 on 'auto' (24 K5a per forward), training it
   bs128 (24 K5a-train + 24 K5b per step, gradients against
   'fused_th_xla'), serving ``quantized='all'`` bs32 (24 K11 + 24 K12)
   and training ``'ff_sb'`` bs128 (+ 24 K12-train + 24 K14 per step)
   against the int8 twins; and the blocked route's own path, which no
   factory CaiT takes on the card any more: 24 sublayers chained through
   ``th_attention_sublayer(route='blocked')`` at bs128 (24 K6a + 24 K6b
   in a forward and backward), against route 'xla'. cait_xs_24 @384 (K5
   at L = 576) is in the sweep at depth 2.
17. Real data (slice 13; after 16, before the print of 11): a JPEG
   ImageFolder tree (10 classes, 640 images at 256-512 px, made by
   ``scripts/make_jpeg_dataset.py`` in parallel subprocesses) and a tar
   of it in a temporary directory. Trains ViT-B/16 @224 bs192 (bf16,
   'auto', ``cutmix_mixup_randaugment_405``) through the Trainer on the
   folder with a 5% holdout and min(8, cores) loader workers: 12 K1-train
   + 12 K2 launches in one step and in each of 10 timed steps after 3,
   loss finite; eval over the holdout counts exactly its 32 images (the
   padded rows masked). One augmentation draw at bs192 on the 256-px
   frames, applied on the card and on the CPU, held to
   ``tests/test_torch_data_augment.py``'s jit tolerance (labels, mix
   labels and ratios equal). One step each through the tar source and the
   ``.npz`` route (frames resident on the card). Prints train img/s, the
   step's wall ms, the host's wait for the next batch, the augmentation's
   device ms (CUDA events behind a sleep kernel) and host ms a batch,
   decode ms a batch (summed over its records, in the workers) and the
   decode tier, with the card's name and power limit.
18. Checkpoints (slice 14; after 17, before the print of 11): ViT-B/16
   @224 bs192 with an EMA through the Trainer on the synthetic source, a
   checkpoint every 2 steps: 4 steps straight, and 2 steps then a new
   Trainer on the same directory that restores step 2 and runs 2 more (12
   K1-train + 12 K2 launches a resumed step); the losses of steps 3-4 and
   every parameter, both moments, the EMA and count bit for bit equal;
   the step-4 state saved and restored again, timed, and still equal.
   Fine-tunes ViT-B/16 @384 bs48 10-way ``finetune_from`` that directory:
   the pos-embed interpolated 197 -> 577 against ``interpolate_pos_embed``
   on the CPU at 1e-6, the head zero, one step of 12 K1-train + 12 K3a +
   12 K3b with a finite loss, then 5 more and its checkpoint. Scores that
   checkpoint with ``evaluate.run_eval`` @384 on a fresh JPEG folder's 25%
   holdout (12 K1 launches a forward, exactly the holdout's images
   counted, finite metrics) and runs ``predict --ema`` from it. Prints
   save, write and restore ms, the checkpoint's bytes, fine-tune and eval
   img/s, with the card's name and power limit.
19. Imported checkpoints (slice 15; after 18, before the print of 11):
   from one seeded ViT-B/16 draw (D = 768, 12 heads, F = 3072, patch 16,
   erf gelu, every projection biased, no leaf zero) writes (a) an HF
   ``ViTForImageClassification`` directory (12 layers, 1000 classes,
   ``model.safetensors`` f32), (b) a headless ``ViTModel`` directory of
   the same weights in three safetensors shards and their index, (c) a
   timm ``.pth`` and (d) an AugReg ``.npz`` of the first two blocks, and
   imports all four with ``python -m sav_tpu_torch.import_checkpoint``;
   the trees of (c) and (d) equal (a)'s leaves bit for bit, (b)'s its
   trunk (with a zero 10-way head), and (a)'s ``model.json`` the expected
   spec. Serves (a) through ``predict``'s restore and ``serve`` @224 bs32
   (12 K4 launches a forward, no K1: 'auto' keeps a biased block's
   attention per-op), logits against use_kernel=False, img/s, device ms
   (CUDA events behind a sleep kernel) and the idle share. Fine-tunes (b)
   through the Trainer (``finetune_from``) @384 bs48 10-way: the pos-embed
   197 -> 577 against ``interpolate_pos_embed`` at 1e-6, one step of 12
   K4 + 12 K3a + 12 K3b, gradients against the same per-op ``mha``
   boundary on the K4 and K3 twins (``models.vit.set_attention_core``)
   with the f32 per-op path as the noise floor, 5 more steps and its
   checkpoint, train img/s. Scores that checkpoint with
   ``evaluate.run_eval`` @384 on the real-data phase's JPEG holdout (its
   5%, exactly counted; 12 K4 a forward). K4 is also timed at the
   fine-tune's B = 48, L = 577. Prints the phase's seconds; with
   ``--profile``, device time by kernel of a serving batch and of the
   fine-tune's steps.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sav_tpu_torch import _build
from sav_tpu_torch import native
from sav_tpu_torch.data import pipeline as data_pipeline
from sav_tpu_torch.data.preprocess import eval_preprocess
from sav_tpu_torch.models import create_model, set_int8_core, set_use_kernel
from sav_tpu_torch.models.botnet import set_attention_core
from sav_tpu_torch.models.cvt import set_attention_core as cvt_attention_core
from sav_tpu_torch.models.vit import set_attention_core as vit_attention_core
from sav_tpu_torch.nn.cvt_attention import CvTAttentionBlock
from sav_tpu_torch.nn.feedforward import FFBlock
from sav_tpu_torch.nn.layers import Conv, LayerNorm
from sav_tpu_torch.nn.normalization import BatchNorm, LayerScaleBlock
from sav_tpu_torch.nn.quantized_dense import QuantizedDense
from sav_tpu_torch.nn.regularization import set_stochastic_depth_generator
from sav_tpu_torch.ops import botnet_attention as bot
from sav_tpu_torch.ops import flash_attention as fa
from sav_tpu_torch.ops import fused_layer
from sav_tpu_torch.ops import int8_ff
from sav_tpu_torch.ops import int8_matmul_kernel as k15
from sav_tpu_torch.ops import mixer_token as mt
from sav_tpu_torch.ops import th_attention as th
from sav_tpu_torch.ops import tnt_inner
from sav_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
from sav_tpu_torch.ops.quantized import quantize_symmetric
from sav_tpu_torch.predict import decode_size_for, serve
from sav_tpu_torch.train import MetricLogger, TrainConfig, Trainer
from sav_tpu_torch.train.steps import loss_and_logits
from sav_tpu_torch.utils.timing import launch_ms, time_ms

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_INT8_OPS = 1979e12         # dense int8 tensor-core operations
PEAK_BYTES = 3.35e12

# Tolerances. Outputs: max |kernel - twin| over max |twin| (K1: over max
# |twin - x|, the sublayer's own contribution, so the residual cannot hide
# an error in it). Kernel and twin round to bf16 at the same points but
# sum in other orders, so a few one-ulp bf16 flips (2^-8 relative) in
# q/k/v/attn are expected, each moving the result by well under 1%; a
# wrong tile, mask or fragment layout moves it by O(1).
OUT_TOL = 2e-2
# lse is f32 from the same bf16 logits in both: only summation order and
# exp2 vs exp differ (~1e-6 at lse ~ 6); 1e-3 absolute leaves room for that
# and still catches a masked-key or max error (>= 1e-2).
LSE_TOL = 1e-3
# Logits of the kernel path vs the plain per-op path (use_kernel=False) of
# the same weights: the per-op path keeps the residual stream in f32 (flax's
# promotion of the f32 cls token), the fused sublayer rounds it to bf16 at
# each of 12 layers, so they differ by bf16 rounding compounded over the
# depth; 5e-2 of max |logit| bounds that and still catches a broken layer.
LOGIT_TOL = 5e-2
# dq, dk, dv of K2/K3 vs the backward twin: max |kernel - twin| over max
# |twin|. Both round p and ds to bf16 at the same points, from logits
# summed in another order (and exp2 vs exp), so single one-ulp flips of a
# bf16 p or ds (2^-8 relative) are expected; summed over L rows they stay
# well under 1%. A wrong tile, mask or fragment moves a gradient by O(1).
BWD_TOL = 2e-2
# dM_pre and dM_post of K5b/K6b vs the twin, max |kernel - twin| over max
# |twin|: both sum the same f32 products over B x L x L positions in other
# orders, and agree to 9.3e-6 of max (H100 80GB HBM3, 700 W, at K5b's and
# K6b's shapes). They are sums of B x ceil(L / 16) per-block partials (1728
# at B = 48, L = 576): one dropped or mis-masked partial (a ragged last
# query tile, one image) moves them by ~1/1728 = 6e-4 of max or more, which
# BWD_TOL would pass; 1e-4 catches it and leaves 10x room over the noise.
DM_TOL = 1e-4
# The weight, bias and LN-parameter gradients of K8b and K16 vs the twin,
# max |kernel - twin| over max |twin|: fixed-order sums of many per-block
# partials (db1, db2 of K8b: one per (image, 64-channel band), 2304 at
# bs192; db1 of K16: one per 128-row tile, 296 at M = 37,824), against the
# same sums in the twin. This script reads them at <= 1.5e-4 of max at the
# paths' shapes and up to 5.2e-4 at the ragged M = 1003 (H100 80GB HBM3,
# 700 W): the twin's and the kernel's bf16 dh/gelu differ by single one-ulp
# flips, which weigh more in a sum over fewer rows. With random-signed
# partials one dropped or mis-indexed partial of 2304 moves a sum by
# ~1/sqrt(2304) = 2% of max, which BWD_TOL would pass; 2e-3 catches it with
# 10x room and leaves ~4x over the ragged-M reading. dx (K8b) and dy (K16)
# stay at BWD_TOL.
WGRAD_TOL = 2e-3
# Each parameter's gradient of the kernel path vs the plain core on the same
# sublayer boundary (use_kernel='fused_layer_xla'), as |g_kernel - g_plain|
# / |g_plain| (L2 over the parameter), must be within max(GRAD_TOL,
# GRAD_NOISE * the plain core's own L2 distance from an f32 reference of
# the same weights and batch). Where the gradient is well conditioned
# (v, out, FF, LN, embeddings, head), GRAD_TOL holds: the kernels' one-ulp
# flips compound over 12 layers as the logits' do (LOGIT_TOL), and a
# broken layer is off by O(1). The q/k weight gradients of deeper layers
# at random init nearly cancel over the tokens, so the bf16 rounding at
# the sublayer boundary (bf16 residual stream, delta = rowsum(o * do)
# from bf16 o) leaves EITHER bf16 path up to ~1.5 |g| from f32 there (this
# script prints the farthest parameter: plain core 1.06 @224 and 1.49 @384
# on an H100 80GB HBM3, 700 W, kernels 0.87 and 1.33); a kernel path as
# close to f32 as the plain core is within 2x that distance of the plain
# core.
GRAD_TOL = 5e-2
GRAD_NOISE = 3.0
# drel_h and drel_w of K9b vs the twin, max |kernel - twin| over max |twin|:
# each is a row-local f32 sum of g values of the f32 ds, from logits summed
# in another order than the twin's (and exp2 vs exp), so they agree to f32
# rounding of p and dp; a dropped or mis-binned key column moves a bin by
# O(1/g) of max, which BWD_TOL might pass at g = 14.
BOT_REL_TOL = 1e-3
K9_GRADS = ('dq', 'dk', 'dv', 'drel_h', 'drel_w')
# the plain_core of train_path for BoTNet: the same 'botnet_fused' autograd
# boundary with bot_core on the K9 twins (models.botnet.set_attention_core)
BOT_PLAIN = 'botnet_fused on the K9 twins'
# The int8 kernels (K10, K12, K13, K15) vs their twins: both make the same
# codes by the same IEEE divisions and sum int32 exactly, but the twins'
# LayerNorm (K13, K10) and softmax sums (K10) and the kernels' run in
# other orders, and an f32 ulp there moves a code that sits at .5 by one
# step (1/127 of its row's scale). Held: max |kernel - twin| within
# INT8_TOL of max |twin| (K13, K10: of max |twin - x|, the sublayer's own
# part), and at least INT8_SHARE of the bf16 outputs (and of the bf16
# hpre) bit-identical to the twin's. A wrong tile, scale, mask or code
# moves most outputs by O(1).
INT8_TOL = 2e-2
INT8_SHARE = 0.9
# the plain_core of the int8 train paths: the same autograd boundaries with
# every int8 block on its twin (models.set_int8_core)
INT8_PLAIN = 'int8 blocks on the twins'
# the plain_core of CvT: the same flash_attention.mha boundary (bf16 out and
# f32 lse saved) with K4 and K3 on their twins (models.cvt.
# set_attention_core)
CVT_PLAIN = 'mha on the flash twins'
# the plain_core of an imported (biased) ViT, whose attention 'auto' keeps
# per-op: the same flash_attention.mha boundary with K4 and K2/K3 on their
# twins (models.vit.set_attention_core)
VIT_PLAIN = 'per-op mha on the flash twins'


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, f32_flops: float = 0.0,
             int8_ops: float = 0.0):
    """The least time for ``flops`` bf16 tensor-core operations plus
    ``f32_flops`` scalar f32 operations (the talking-heads mixes) plus
    ``int8_ops`` int8 tensor-core operations, and ``nbytes`` of device
    memory traffic: the larger of the two times."""
    t_ops = (flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
             + int8_ops / PEAK_INT8_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


class Checks:
    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str) -> None:
        print(f'{"PASS" if ok else "FAIL"} {what}', flush=True)
        if not ok:
            self.failed.append(what)


def _bf16(rng, shape, std=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).cuda().bfloat16()


def launch_split(fn) -> str:
    """Device time of each kernel one call of ``fn`` launches
    (``timing.launch_ms`` over 10 calls; the wrapper's own small torch
    launches included): which of a C entry's kernels costs what. Late in
    this long process the profiler keeps only part of the records (K8a's
    and K7b's splits summed to ~40% of their CUDA-event times over 5 calls
    on the card, 73-77% over 10): read the shares, and take the times from
    ``scripts/torch_ablate.py``, whose split in a fresh process matches
    the events."""
    short = lambda name: name.split('(')[0].replace('void ', '')[-40:]
    return '; '.join(f'{short(name)} {ms:.4f} ms'
                     for name, ms in launch_ms([fn], 10))


def _k1_case(rng, batch, seq, dim, heads):
    """Random K1 inputs at [batch, seq, dim], the library chain computing
    the same sublayer (LN + matmuls + SDPA; timed only) and its operation
    count."""
    hd = heads * 64
    x = _bf16(rng, (batch, seq, dim))
    scale = (1.0 + 0.1 * _bf16(rng, (dim,))).float()
    bias = (0.1 * _bf16(rng, (dim,))).float()
    # wq 4x wider than lecun so the softmax is peaked and the attention term
    # is not a near-uniform average of v
    wq = _bf16(rng, (dim, hd), 4.0 / math.sqrt(dim))
    wk, wv = (_bf16(rng, (dim, hd), 1.0 / math.sqrt(dim)) for _ in range(2))
    wo = _bf16(rng, (hd, dim), 1.0 / math.sqrt(hd))

    def library():
        y = F.layer_norm(x, (dim,), scale.bfloat16(), bias.bfloat16(), 1e-6)
        split = lambda a: a.view(batch, seq, heads, 64).transpose(1, 2)
        a = F.scaled_dot_product_attention(*(split(y @ w) for w in (wq, wk, wv)))
        return x + a.transpose(1, 2).reshape(batch, seq, hd) @ wo

    m = batch * seq
    flops = 2 * m * dim * 3 * hd + 4 * batch * heads * seq * seq * 64 \
        + 2 * m * hd * dim
    return (x, scale, bias, wq, wk, wv, wo, heads), library, flops


def check_k1(rng, checks, batch, seq, dim=768, heads=12):
    """K1 port vs its twin at [batch, seq, dim]; returns the kernel record."""
    hd = heads * 64
    args, library, flops = _k1_case(rng, batch, seq, dim, heads)
    x, scale, bias, wq, wk, wv, wo, _ = args
    out = fused_layer.fused_attention_fwd(*args)
    plain = fused_layer.fused_attention_fwd_plain(*args, fused_layer.LN_EPS)
    torch.cuda.synchronize()
    delta = (plain.float() - x.float()).abs().max().item()
    err = (out.float() - plain.float()).abs().max().item()
    rel = err / delta
    finite = bool(torch.isfinite(out).all())
    checks.expect(finite and rel <= OUT_TOL,
                  f'K1 fused_attention_fwd B={batch} L={seq}: max err {err:.4g} '
                  f'= {rel:.3g} of max|out-x| (tol {OUT_TOL})')

    def flash_core():
        """The same sublayer on the port's other route (auto_core's choice)."""
        heads3 = lambda w: w.view(dim, heads, 64)
        return fused_layer.attention_sublayer(
            x, scale, bias, heads3(wq), heads3(wk), heads3(wv),
            wo.view(heads, 64, dim), heads, 'flash')

    m = batch * seq
    nbytes = 2 * m * dim * 2 + 4 * dim * hd * 2 + 2 * dim * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: fused_layer.fused_attention_fwd(*args)),
               plain_ms=time_ms(lambda: fused_layer.fused_attention_fwd_plain(
                   *args, fused_layer.LN_EPS), iters=5),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err)
    print(f'  K1 L={seq}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}, '
          f'{flops / 1e9:.2f} GFLOP)  flash core {time_ms(flash_core):.4f} ms',
          flush=True)
    print(f'  K1 L={seq} launches: ' + launch_split(
        lambda: fused_layer.fused_attention_fwd(*args)), flush=True)
    return rec


def check_k4(rng, checks, batch, seq, heads=12, kv_seq=None):
    """K4 port vs its twin on [batch, seq, heads*64] queries over
    ``kv_seq`` keys (default seq; CvT's stride-2 key grids are shorter);
    returns the record."""
    hd = heads * 64
    kv_seq = kv_seq or seq
    q = _bf16(rng, (batch, seq, hd), 0.5)      # pre-scaled, peaked softmax
    k = _bf16(rng, (batch, kv_seq, hd))
    v = _bf16(rng, (batch, kv_seq, hd))
    out, lse = flash_fwd(q, k, v, heads, kv_seq)
    p_out, p_lse = flash_fwd_plain(q, k, v, heads, kv_seq)
    torch.cuda.synchronize()
    err = (out.float() - p_out.float()).abs().max().item()
    rel = err / p_out.float().abs().max().item()
    lse_err = (lse - p_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    shape = f'L={seq}' + ('' if kv_seq == seq else f' over {kv_seq} keys')
    checks.expect(finite and rel <= OUT_TOL and lse_err <= LSE_TOL,
                  f'K4 flash_fwd B={batch} {shape} H={heads}: out err '
                  f'{rel:.3g} of max (tol {OUT_TOL}), lse abs err '
                  f'{lse_err:.3g} (tol {LSE_TOL})')

    def library():
        split = lambda a: a.view(batch, -1, heads, 64).transpose(1, 2)
        return F.scaled_dot_product_attention(split(q), split(k), split(v),
                                              scale=1.0)

    flops = 4 * batch * heads * seq * kv_seq * 64
    nbytes = 2 * batch * (seq + kv_seq) * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: flash_fwd(q, k, v, heads, kv_seq)),
               plain_ms=time_ms(lambda: flash_fwd_plain(q, k, v, heads,
                                                        kv_seq), iters=5),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(err, lse_err))
    print(f'  K4 B={batch} {shape} H={heads}: kernel {rec["ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library {rec["library_ms"]:.4f} ms  '
          f'bound {b_ms:.4f} ms ({b_by})', flush=True)
    return rec


def fill_head(model, seed: int) -> None:
    """The head and cls token are zero-initialised, which makes every
    random-init logit 0; fill them from the seed so logits can be compared.
    CaiT's LayerScale starts at 1e-6 (cait_s_24), which would hide every
    attention sublayer from the logits and the gradients downstream of it:
    raise it to 0.1. BoTNet's BatchNorms: ``fill_batchnorm``."""
    gen = torch.Generator().manual_seed(seed + 1)
    head = model.Dense_0.kernel
    # ViT's, CaiT's and CeiT's cls, CvT's Stage_2.cls; the Mixer has none
    cls = [p for n, p in model.named_parameters() if n.split('.')[-1] == 'cls']
    with torch.no_grad():
        head.copy_(torch.randn(head.shape, generator=gen)
                   / math.sqrt(head.shape[0]))
        for token in cls:
            token.copy_(torch.randn(token.shape, generator=gen) * 0.02)
        for sub in model.modules():
            if isinstance(sub, LayerScaleBlock):
                sub.layerscale.fill_(0.1)
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        fill_batchnorm(model, seed)


def serve_path(checks, name, img_size, use_kernel, want, seed, batch,
               profile=False, model_name='vit_b_patch16', quantized=False,
               dense_fused=False, **overrides):
    """Drives ``serve`` once with the counts at 0 (want: the exact counts
    per forward), then compares logits with the plain cores and measures
    img/s. Returns the counts. ``quantized`` builds an int8 route; with
    ``dense_fused`` every QuantizedDense runs K15 (``fused=True``, the JAX
    package's direct-use opt-in). A route through int8 kernels is held
    against the same model on their twins (``set_int8_core``), and its
    distance from the bf16 model of the same weights is printed.
    ``overrides`` go to ``create_model`` (e.g. a cut depth)."""
    t_path = time.perf_counter()
    model = create_model(model_name, num_classes=1000,
                         dtype=torch.bfloat16, img_size=img_size, seed=seed,
                         device='cuda', use_kernel=use_kernel, **overrides,
                         **({'quantized': quantized} if quantized else {}))
    for sub in model.modules():
        if dense_fused and isinstance(sub, QuantizedDense):
            sub.fused = True
    fill_head(model, seed)
    model.eval()
    size = decode_size_for(img_size)
    frames = np.random.RandomState(seed).randint(
        0, 256, (batch, size, size, 3), dtype=np.uint8)

    _build.reset_launches()
    probs, idx = serve(model, frames, img_size, 5)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    checks.expect(counts == want,
                  f'{name}: launches per forward {counts} (want {want})')
    checks.expect(tuple(idx.shape) == (batch, 5)
                  and bool(torch.isfinite(probs).all()),
                  f'{name}: top-5 of shape {tuple(idx.shape)}, finite')

    int8_kernels = quantized in ('ff', 'all') or dense_fused
    with torch.inference_mode():
        x = eval_preprocess(torch.from_numpy(frames).cuda().float(),
                            img_size).bfloat16()
        logits = model(x).float()
        if int8_kernels:
            set_int8_core(model, 'plain')
            plain = model(x).float()
            set_int8_core(model, 'kernel')
        else:
            set_use_kernel(model, False)
            plain = model(x).float()
            set_use_kernel(model, use_kernel)
    err = (logits - plain).abs().max().item() / plain.abs().max().item()
    top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    ref = 'the int8 twins' if int8_kernels else 'use_kernel=False'
    checks.expect(tuple(logits.shape) == (batch, 1000)
                  and bool(torch.isfinite(logits).all()) and err <= LOGIT_TOL,
                  f'{name}: logits vs {ref}: max err {err:.3g} of '
                  f'max|logit| (tol {LOGIT_TOL}), top-1 agreement {top1:.3f}')
    if quantized:
        bf16 = create_model(model_name, num_classes=1000, dtype=torch.bfloat16,
                            img_size=img_size, device='cuda',
                            use_kernel=use_kernel, **overrides)
        bf16.load_state_dict(model.state_dict())
        with torch.inference_mode():
            full = bf16.eval()(x).float()
        del bf16
        print(f'  {name}: vs the bf16 model of the same weights (information '
              f'only): max err {_rel(logits, full):.3g} of max|logit|, top-1 '
              f'agreement {(logits.argmax(-1) == full.argmax(-1)).float().mean().item():.3f}',
              flush=True)
    if use_kernel == 'botnet_fused':
        botnet_logit_floor(checks, name, model, model_name, img_size, x,
                           logits, plain)

    iters = 10
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        serve(model, frames, img_size, 5)
    torch.cuda.synchronize()
    ips = iters * batch / (time.perf_counter() - start)
    fwd_ms = time_ms(lambda: serve(model, frames, img_size, 5), iters=5)
    print(f'  {name}: {ips:.1f} img/s (serve incl. H2D of uint8 frames, '
          f'batch {batch}), {fwd_ms:.3f} ms/batch between CUDA events '
          f'(includes host waits); the path took '
          f'{time.perf_counter() - t_path:.1f} s', flush=True)
    if profile:
        print_profile(lambda: serve(model, frames, img_size, 5))
        if model_name.startswith('cvt'):
            print_module_split(model, lambda: serve(model, frames, img_size,
                                                    5))
    del model
    torch.cuda.empty_cache()
    return counts


def botnet_logit_floor(checks, name, model, model_name, img_size, x, logits,
                       plain) -> None:
    """What the BoTNet logits check can see: the kernel route's logits
    against its twins on the same boundary (core='plain', LOGIT_TOL), both
    bf16 routes against the f32 per-op model of the same weights and
    running statistics, and how far the logits move with every BoT block's
    value kernel zeroed, which must be at least 5x LOGIT_TOL (the fill
    leaves the attention in view)."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    with torch.no_grad():
        set_attention_core(model, 'plain')
        twin = model(x).float()
        set_attention_core(model, 'kernel')
        ref = create_model(model_name, num_classes=1000, dtype=torch.float32,
                           img_size=img_size, device='cuda', use_kernel=False)
        ref.load_state_dict(model.state_dict())
        f32 = ref.eval()(x.float()).float()
        del ref
        values = [p for n, p in model.named_parameters()
                  if n.endswith('value.kernel')]
        saved = [p.clone() for p in values]
        for p in values:
            p.zero_()
        blind = model(x).float()
        for p, s in zip(values, saved):
            p.copy_(s)
    twin_err, moved = rel(logits, twin), rel(blind, logits)
    checks.expect(twin_err <= LOGIT_TOL and moved >= 5 * LOGIT_TOL,
                  f'{name}: logits vs the K9 twins on the same boundary '
                  f'{twin_err:.3g} of max (tol {LOGIT_TOL}); vs f32 per-op: '
                  f'kernel route {rel(logits, f32):.3g}, per-op bf16 '
                  f'{rel(plain, f32):.3g}; the {len(values)} BoT value '
                  f'kernels zeroed move the logits by {moved:.3g} of max '
                  f'(at least {5 * LOGIT_TOL})')
    torch.cuda.empty_cache()


def _abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel(a, b) -> float:
    return _abs(a, b) / float(b.float().abs().max())


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def check_k1_train(rng, checks, batch, seq, dim=768, heads=12):
    """K1's training variant vs its twin: out, q, k, v, attn; lse against
    the logsumexp of the kernel's own q and k (the twin's q and k may differ
    from the kernel's by single bf16 roundings, which move a peaked lse by
    ~1e-2). Returns the kernel record."""
    hd = heads * 64
    args, library, flops = _k1_case(rng, batch, seq, dim, heads)
    x = args[0]
    out, (q, k, v, attn, lse) = fused_layer.fused_attention_fwd(
        *args, save_residuals=True)
    plain, res = fused_layer.fused_attention_fwd_plain(
        *args, fused_layer.LN_EPS, save_residuals=True)
    torch.cuda.synchronize()
    err_out = (out.float() - plain.float()).abs().max().item() / \
        (plain.float() - x.float()).abs().max().item()
    errs = [_rel(a, b) for a, b in zip((q, k, v, attn), res[:4])]
    abs_err = max(_abs(a, b) for a, b in zip((out, q, k, v, attn),
                                             (plain, *res[:4])))
    split = lambda a: a.float().view(batch, seq, heads, 64)
    own = torch.logsumexp(torch.einsum('bqhd,bkhd->bhqk', split(q), split(k)),
                          dim=-1)
    lse_err = (lse - own).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (out, q, k, v, attn, lse))
    checks.expect(finite and max([err_out] + errs) <= OUT_TOL
                  and lse_err <= LSE_TOL,
                  f'K1 train B={batch} L={seq}: out {err_out:.3g} of max|out-x|, '
                  f'q/k/v/attn {", ".join(f"{e:.3g}" for e in errs)} of max '
                  f'(tol {OUT_TOL}); lse vs its own q,k {lse_err:.3g} '
                  f'(tol {LSE_TOL})')

    m = batch * seq
    nbytes = (2 * m * dim * 2 + 4 * dim * hd * 2 + 2 * dim * 4
              + 4 * m * hd * 2 + batch * heads * seq * 4)
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: fused_layer.fused_attention_fwd(
                   *args, save_residuals=True)),
               plain_ms=time_ms(lambda: fused_layer.fused_attention_fwd_plain(
                   *args, fused_layer.LN_EPS, save_residuals=True), iters=3),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(abs_err, lse_err))
    print(f'  K1 train B={batch} L={seq}: kernel {rec["ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library {rec["library_ms"]:.4f} ms  '
          f'bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP)', flush=True)
    print(f'  K1 train B={batch} L={seq} launches: ' + launch_split(
        lambda: fused_layer.fused_attention_fwd(*args, save_residuals=True)),
        flush=True)
    return rec


def _bwd_bound(batch, q_len, kv_len, heads, matmuls, q_tensors, kv_tensors,
               stats):
    """bound_ms of a backward pass: ``matmuls`` Lq x Lkv x 64 products per
    (image, head), ``q_tensors`` [B, Lq, H*64] and ``kv_tensors`` [B, Lkv,
    H*64] bf16 moved once, ``stats`` [B, H, Lq] f32 rows moved once."""
    flops = matmuls * 2 * batch * heads * q_len * kv_len * 64
    nbytes = ((q_tensors * q_len + kv_tensors * kv_len) * batch * heads * 64 * 2
              + stats * batch * heads * q_len * 4)
    return bound_ms(flops, nbytes)


def check_bwd(rng, checks, batch, seq, kv_len=None, heads=12, routes=(),
              q_len=None):
    """Each backward route ('fused': K2, 'split': K3a + K3b) vs the twin,
    random do, ``q_len`` queries (default seq) over ``seq`` key rows; each
    route's dq, dk, dv must also come out bit-identical from two calls (no
    atomics). Returns the records of each kernel timed
    alone ({'fused': .., 'dq': .., 'dkv': ..}); K3's also carry the pair's
    time (pair_ms), the function's bound (pair_bound_ms) and SDPA's
    backward (pair_library_ms, also their library_ms: one call for one
    function)."""
    kv_len = kv_len or seq
    q_len = q_len or seq
    hd = heads * 64
    q = _bf16(rng, (batch, q_len, hd), 0.5)
    k, v = (_bf16(rng, (batch, seq, hd)) for _ in range(2))
    do = _bf16(rng, (batch, q_len, hd))
    shape = f'L={seq}' if q_len == seq else f'{q_len} over {seq} keys H={heads}'
    out, lse = flash_fwd(q, k, v, heads, kv_len)
    twin = fa.flash_bwd_plain(q, k, v, out, lse, do, heads, kv_len)
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, heads,
                                                  kv_len), iters=3)
    recs = {}
    for route in routes:
        bwd = fa.bwd_fused if route == 'fused' else fa.bwd_split
        grads = bwd(q, k, v, out, lse, do, heads, kv_len)
        torch.cuda.synchronize()
        errs = [_rel(g, t) for g, t in zip(grads, twin)]
        abs_errs = [_abs(g, t) for g, t in zip(grads, twin)]
        tails = max(float(g[:, kv_len:].abs().max()) if kv_len < seq else 0.0
                    for g in grads[1:])
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        name = 'K2' if route == 'fused' else 'K3'
        checks.expect(finite and max(errs) <= BWD_TOL and tails == 0.0,
                      f'{name} flash_bwd B={batch} {shape} kv_len={kv_len}: '
                      f'dq/dk/dv err {", ".join(f"{e:.3g}" for e in errs)} of '
                      f'max (tol {BWD_TOL}), masked key rows {tails}')
        again = bwd(q, k, v, out, lse, do, heads, kv_len)
        checks.expect(all(torch.equal(a, g) for a, g in zip(again, grads)),
                      f'{name} flash_bwd B={batch} {shape}: two calls give '
                      f'bit-identical dq, dk, dv')
        if route == 'fused':
            b_ms, b_by = _bwd_bound(batch, q_len, seq, heads, 5, 4, 4, 1)
            recs['fused'] = dict(
                ms=time_ms(lambda: fa.bwd_fused(q, k, v, out, lse, do, heads,
                                                kv_len)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(abs_errs))
        else:
            dq, delta = fa.bwd_dq(q, k, v, out, lse, do, heads, kv_len)
            b_ms, b_by = _bwd_bound(batch, q_len, seq, heads, 3, 4, 2, 2)
            recs['dq'] = dict(
                ms=time_ms(lambda: fa.bwd_dq(q, k, v, out, lse, do, heads,
                                             kv_len)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=abs_errs[0])
            b_ms, b_by = _bwd_bound(batch, q_len, seq, heads, 4, 2, 4, 2)
            recs['dkv'] = dict(
                ms=time_ms(lambda: fa.bwd_dkv(q, k, v, do, lse, delta, heads,
                                              kv_len)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(abs_errs[1:]))
        total = time_ms(lambda: bwd(q, k, v, out, lse, do, heads, kv_len))
        if route == 'split':
            for n in ('dq', 'dkv'):
                recs[n]['pair_ms'] = total
        print(f'  {name} route={route} B={batch} {shape}: backward '
              f'{total:.4f} ms  ' + '  '.join(
                  f'{n} {r["ms"]:.4f} ms (bound {r["bound_ms"]:.4f})'
                  for n, r in recs.items() if (n == 'fused') == (route == 'fused'))
              + f'  plain {plain_ms:.4f} ms', flush=True)

    # library yardstick: SDPA's backward, timed as forward+backward minus
    # forward on the same (head-major) inputs
    split = lambda a: a[:, :kv_len].reshape(batch, -1, heads, 64).transpose(1, 2)
    qs = q.view(batch, q_len, heads, 64).transpose(1, 2).detach().requires_grad_()
    ks, vs = (split(a).detach().requires_grad_() for a in (k, v))
    dos = do.view(batch, q_len, heads, 64).transpose(1, 2)
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0))
    both = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), (qs, ks, vs),
        dos))
    lib = max(both - fwd, 0.0)
    b_ms, _ = _bwd_bound(batch, q_len, seq, heads, 5, 4, 4, 1)
    pair = recs.get('dq', {}).get('pair_ms')
    print(f'  flash backward B={batch} {shape}: SDPA backward {lib:.4f} ms '
          f'(fwd+bwd {both:.4f} - fwd {fwd:.4f}); bound of the function '
          f'{b_ms:.4f} ms' + (f'; K3 pair {pair:.4f} ms = {pair / lib:.2f}x '
                              f'SDPA, {pair / b_ms:.2f}x the bound'
                              if pair else ''), flush=True)
    for n, r in recs.items():
        r['library_ms'] = lib
        if n != 'fused':
            r['pair_library_ms'] = lib
            r['pair_bound_ms'] = b_ms
    return recs


def check_flash_sentinels(rng, checks, heads=2):
    """K4 and K2 through their C entries into buffers one image longer than
    the call, filled with NaN: every output row of the call's images is
    written and within tolerance of the twin (masked dk/dv rows exactly 0,
    K2 twice bit-identical), and nothing lands in the extra image. Cases:
    the ViT lengths 197 and 577 (K4 only: K2 holds 208 rows), 200 over 190
    keys, a 1-row tail past two tiles (129), and q_len != kv_len."""
    hd = heads * 64
    nan = lambda b, rows, *more: torch.full((b + 1, rows, *more), float('nan'),
                                            device='cuda', dtype=torch.bfloat16)
    for b, q_len, kv_rows, kv_len in ((3, 197, 197, 197), (3, 200, 200, 190),
                                      (2, 577, 577, 577), (3, 129, 129, 129),
                                      (2, 300, 100, 90), (2, 150, 100, 90)):
        q = _bf16(rng, (b, q_len, hd), 0.5)
        k, v = (_bf16(rng, (b, kv_rows, hd)) for _ in range(2))
        do = _bf16(rng, (b, q_len, hd))
        k[:, kv_len:] = 1e4                 # masked keys must not leak in
        v[:, kv_len:] = float('nan')
        out = nan(b, q_len, hd)
        lse = torch.full((b + 1, heads, q_len), float('nan'), device='cuda')
        err = fa._lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, q_len, kv_rows,
                        kv_len, heads, fa.stream_of(q.device))
        torch.cuda.synchronize()
        p_out, p_lse = flash_fwd_plain(q, k, v, heads, kv_len)
        o_err = _rel(out[:b], p_out)
        l_err = float((lse[:b] - p_lse).abs().max())
        untouched = bool(torch.isnan(out[b]).all() and torch.isnan(lse[b]).all())
        checks.expect(err == 0 and o_err <= OUT_TOL and l_err <= LSE_TOL
                      and untouched,
                      f'K4 sentinels B={b} q_len={q_len} kv={kv_rows}/{kv_len}: '
                      f'out {o_err:.3g} (tol {OUT_TOL}), lse {l_err:.3g} (tol '
                      f'{LSE_TOL}), extra image untouched {untouched}')
        if not fa.fused_bwd_fits(q_len, kv_rows):
            continue
        v[:, kv_len:] = 0.0                 # the forward's own rows
        o_in, lse_in = out[:b].contiguous(), lse[:b].contiguous()
        twin = fa.flash_bwd_plain(q, k, v, o_in, lse_in, do, heads, kv_len)
        runs = []
        for _ in range(2):
            grads = [nan(b, q_len, hd), nan(b, kv_rows, hd), nan(b, kv_rows, hd)]
            err = fa._bwd_fn('sav_flash_bwd_fused')(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o_in.data_ptr(),
                do.data_ptr(), lse_in.data_ptr(),
                *[g.data_ptr() for g in grads], b, q_len, kv_rows, kv_len,
                heads, fa.stream_of(q.device))
            torch.cuda.synchronize()
            runs.append((err, grads))
        (err, grads), (err2, again) = runs
        errs = [_rel(g[:b], t) for g, t in zip(grads, twin)]
        tails = max(float(g[:b, kv_len:].float().abs().max())
                    if kv_len < kv_rows else 0.0 for g in grads[1:])
        untouched = all(bool(torch.isnan(g[b]).all()) for g in grads)
        same = all(torch.equal(a[:b], g[:b]) for a, g in zip(again, grads))
        checks.expect(err == 0 and err2 == 0 and max(errs) <= BWD_TOL
                      and tails == 0.0 and untouched and same,
                      f'K2 sentinels B={b} q_len={q_len} kv={kv_rows}/{kv_len}: '
                      f'dq/dk/dv {", ".join(f"{e:.3g}" for e in errs)} (tol '
                      f'{BWD_TOL}), masked key rows {tails}, extra image '
                      f'untouched {untouched}, two calls identical {same}')


# ---- talking-heads kernels (K5a, K6a: csrc/th_attention.cu; K5b, K6b:
# csrc/th_bwd.cu)

def _th_mixes(rng, heads):
    """Two [H, H] f32 mixes near the identity."""
    return [(torch.eye(heads) + 0.3 * torch.from_numpy(rng.standard_normal(
        (heads, heads)).astype(np.float32))).cuda() for _ in range(2)]


def _th_work(batch, seq, heads, products, mixes):
    """(tensor-core operations, f32 operations) of a TH core pass:
    ``products`` L x L x 48 products per (image, head), and ``mixes``
    [H, H] mixes or H^2-wide sums per (image, query, key), 2 H^2 f32
    operations each on the CUDA cores."""
    pos = batch * seq * seq
    return (products * 2 * pos * heads * th.HEAD_CH,
            mixes * 2 * heads * heads * pos)


def _th_library(q, k, v, m_pre, m_post, heads):
    """The TH core as a per-op torch chain in bf16 (timed only): no single
    PyTorch call computes talking-heads attention."""
    b, l, hd = q.shape
    split = lambda a: a.view(b, l, heads, th.HEAD_CH).transpose(1, 2)
    s = split(q) @ split(k).transpose(-1, -2)
    s = torch.einsum('hi,bhqk->biqk', m_pre.bfloat16(), s)
    p = torch.einsum('hi,bhqk->biqk', m_post.bfloat16(), s.softmax(-1))
    return (p @ split(v)).transpose(1, 2).reshape(b, l, hd)


def check_k5a(rng, checks, batch, seq, save_residuals, dim=384, heads=8):
    """K5a (the whole span, no residual) vs its twin at [batch, seq, dim]:
    out, and with ``save_residuals`` q, k, v, attn and the lse (against the
    lse of the kernel's own q and k). Returns the kernel record."""
    hd = heads * th.HEAD_CH
    x = _bf16(rng, (batch, seq, dim))
    scale = (1.0 + 0.1 * _bf16(rng, (dim,))).float()
    bias = (0.1 * _bf16(rng, (dim,))).float()
    wq = _bf16(rng, (dim, hd), 4.0 / math.sqrt(dim))
    wk, wv = (_bf16(rng, (dim, hd), 1.0 / math.sqrt(dim)) for _ in range(2))
    wo = _bf16(rng, (hd, dim), 1.0 / math.sqrt(hd))
    m = _th_mixes(rng, heads)
    args = (x, scale, bias, wq, wk, wv, wo, *m, heads)
    run = lambda: th.th_attention_fwd(*args, save_residuals=save_residuals)
    plain = lambda: th.th_attention_fwd_plain(*args,
                                              save_residuals=save_residuals)
    got, want = run(), plain()
    torch.cuda.synchronize()
    name = f'K5a th_attention_fwd{" train" if save_residuals else ""}'
    if save_residuals:
        (out, res), (p_out, p_res) = got, want
        errs = [_rel(a, b) for a, b in zip(res[:4], p_res[:4])]
        abs_err = max(_abs(a, b) for a, b in zip((out, *res[:4]),
                                                 (p_out, *p_res[:4])))
        _, own_lse = th.th_core_fwd_plain(*res[:3], *m, heads)
        lse_err = _abs(res[4], own_lse)
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *res))
        extra = (f', q/k/v/attn {", ".join(f"{e:.3g}" for e in errs)} of max; '
                 f'lse vs its own q,k {lse_err:.3g} (tol {LSE_TOL})')
    else:
        out, p_out, errs, lse_err = got, want, [], 0.0
        abs_err = _abs(out, p_out)
        finite, extra = bool(torch.isfinite(out).all()), ''
    err_out = _rel(out, p_out)
    checks.expect(finite and max([err_out] + errs) <= OUT_TOL
                  and lse_err <= LSE_TOL,
                  f'{name} B={batch} L={seq} D={dim} H={heads}: out '
                  f'{err_out:.3g} of max (tol {OUT_TOL}){extra}')
    tails = [('out', out, p_out)]
    if save_residuals:
        tails += list(zip(('q', 'k', 'v', 'attn'), res[:4], p_res[:4]))
    for what, ours, twin in tails:
        check_tail(checks, f'{name} B={batch} L={seq} D={dim} H={heads}: '
                           f'{what}', ours, twin)

    def library():
        y = F.layer_norm(x, (dim,), scale.bfloat16(), bias.bfloat16(), 1e-6)
        q = (y @ wq) * (1.0 / math.sqrt(th.HEAD_CH))
        return _th_library(q, y @ wk, y @ wv, *m, heads) @ wo

    mrows = batch * seq
    ops, f32_ops = _th_work(batch, seq, heads, 2, 2)
    ops += 2 * mrows * dim * 3 * hd + 2 * mrows * hd * dim
    nbytes = 2 * mrows * dim * 2 + 4 * dim * hd * 2 + 2 * dim * 4
    if save_residuals:
        nbytes += 4 * mrows * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(ops, nbytes, f32_ops)
    rec = dict(ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(abs_err, lse_err))
    print(f'  {name} B={batch} L={seq} D={dim} H={heads}: kernel '
          f'{rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} ms  library '
          f'{rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}; '
          f'{ops / 1e9:.2f} GFLOP tensor, {f32_ops / 1e9:.2f} GFLOP f32 '
          f'mixes)', flush=True)
    print(f'  {name} B={batch} L={seq} D={dim} H={heads} launches: '
          + launch_split(run), flush=True)
    return rec


def _th_core_inputs(rng, batch, seq, heads=8):
    """q (pre-scaled, a peaked softmax), k, v, do as [B, L, H*48] bf16 and
    the two mixes."""
    hd = heads * th.HEAD_CH
    q = _bf16(rng, (batch, seq, hd), 0.4)
    k, v, do = (_bf16(rng, (batch, seq, hd)) for _ in range(3))
    return q, k, v, do, _th_mixes(rng, heads)


def check_k6a(rng, checks, batch, seq, heads=8):
    """K6a (the TH core, two sweeps over the keys) vs its twin, and two
    calls bit-identical; returns the kernel record."""
    q, k, v, _, m = _th_core_inputs(rng, batch, seq, heads)
    run = lambda: th.th_core_fwd(q, k, v, *m, heads)
    plain = lambda: th.th_core_fwd_plain(q, k, v, *m, heads)
    (attn, lse), again, (p_attn, p_lse) = run(), run(), plain()
    torch.cuda.synchronize()
    err, lse_err = _rel(attn, p_attn), _abs(lse, p_lse)
    finite = bool(torch.isfinite(attn).all() and torch.isfinite(lse).all())
    same = torch.equal(attn, again[0]) and torch.equal(lse, again[1])
    checks.expect(finite and same and err <= OUT_TOL and lse_err <= LSE_TOL,
                  f'K6a th_core_fwd B={batch} L={seq} H={heads}: attn err '
                  f'{err:.3g} of max (tol {OUT_TOL}), lse abs err '
                  f'{lse_err:.3g} (tol {LSE_TOL}); two calls identical {same}')
    check_tail(checks, f'K6a B={batch} L={seq} H={heads}: attn', attn,
               p_attn)
    ops, f32_ops = _th_work(batch, seq, heads, 2, 2)
    hd = heads * th.HEAD_CH
    nbytes = 4 * batch * seq * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(ops, nbytes, f32_ops)
    rec = dict(ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(lambda: _th_library(q, k, v, *m, heads)),
               bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(_abs(attn, p_attn), lse_err))
    print(f'  K6a B={batch} L={seq}: kernel {rec["ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library {rec["library_ms"]:.4f} ms  '
          f'bound {b_ms:.4f} ms ({b_by})', flush=True)
    return rec


def check_th_bwd(rng, checks, batch, seq, entry, heads=8, timed=True):
    """K5b (``th_attention_bwd``) or K6b (``th_core_bwd``; both run the three
    kernels of ``csrc/th_bwd.cu``) vs the backward twin: dq, dk, dv and
    dM_pre, dM_post, each as max |kernel - twin| over max |twin|, and two
    calls bit-identical (no float atomics). With ``timed``, returns the
    kernel record; the per-op chain's backward is its library time."""
    q, k, v, do, m = _th_core_inputs(rng, batch, seq, heads)
    _, lse = th.th_core_fwd_plain(q, k, v, *m, heads)
    fn = getattr(th, entry)
    run = lambda: fn(q, k, v, do, lse, *m, heads)
    plain = lambda: th.th_core_bwd_plain(q, k, v, do, lse, *m, heads)
    grads, again, twin = run(), run(), plain()
    torch.cuda.synchronize()
    errs = [_rel(g, t) for g, t in zip(grads, twin)]
    same = all(torch.equal(g, a) for g, a in zip(grads, again))
    shapes = all(g.shape == t.shape for g, t in zip(grads, twin))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    name = 'K5b' if entry == 'th_attention_bwd' else 'K6b'
    checks.expect(shapes and finite and same and max(errs[:3]) <= BWD_TOL
                  and max(errs[3:]) <= DM_TOL,
                  f'{name} {entry} B={batch} L={seq} H={heads}: dq/dk/dv err '
                  f'{", ".join(f"{e:.3g}" for e in errs[:3])} of max (tol '
                  f'{BWD_TOL}); dM_pre/dM_post err '
                  f'{", ".join(f"{e:.3g}" for e in errs[3:])} of max (tol '
                  f'{DM_TOL}); two calls identical {same}')
    for what, g, t in zip(('dq', 'dk', 'dv'), grads, twin):
        check_tail(checks, f'{name} B={batch} L={seq} H={heads}: {what}', g, t,
                   BWD_TOL)
    if not timed:
        return None
    del again
    # library yardstick: the per-op chain's backward (fwd+bwd minus fwd)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd = time_ms(lambda: _th_library(*leaves, *m, heads))
    both = time_ms(lambda: torch.autograd.grad(
        _th_library(*leaves, *m, heads), leaves, do))
    ops, f32_ops = _th_work(batch, seq, heads, 5, 6)
    hd = heads * th.HEAD_CH
    nbytes = 7 * batch * seq * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(ops, nbytes, f32_ops)
    rec = dict(ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=max(both - fwd, 0.0), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(_abs(g, t) for g, t in zip(grads, twin)))
    print(f'  {name} B={batch} L={seq}: kernel {rec["ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library (per-op backward) '
          f'{rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by})',
          flush=True)
    return rec


def check_tail(checks, what, got, want, tol=OUT_TOL, base=None):
    """Where the last dimension is not a whole number of 64-column boxes
    or tiles (cait_xs: H*48 = D = 288, 4.5 of them), its ragged last
    columns held against the twin's on their own (bf16 outputs: over their
    own max |twin|, at ``tol``; int8 outputs: ``_int8_expect``'s rule), so
    that a half box or tile dropped, zeroed or read from the next band
    cannot hide in a max over the other columns. Nothing where the width
    is whole."""
    ragged = got.shape[-1] % 64
    if not ragged:
        return
    tail = lambda t: None if t is None else t[..., -ragged:]
    if tol is None:
        _int8_expect(checks, f'{what}: its last {ragged} columns', tail(got),
                     tail(want), tail(base))
        return
    err = _rel(tail(got), tail(want))
    checks.expect(bool(torch.isfinite(tail(got)).all()) and err <= tol,
                  f'{what}: its last {ragged} columns alone: err {err:.3g} '
                  f'of their max (tol {tol})')


def check_th_tails(rng, checks, seq, heads=8):
    """The ragged last tile on its own (L = 196, 197, 576 and 577 are not
    multiples of the forwards' 32-row tiles or the backward's 64-row work
    tiles; 197 and 577 leave one row): every output of the TH kernels goes
    into a buffer of 64 more rows holding a NaN sentinel; the L rows must
    match the twins and the rows past L must keep the sentinel (nothing is
    padded, no row is dropped, none is written past the length)."""
    hd = heads * th.HEAD_CH
    dim = hd
    q, k, v, do, m = _th_core_inputs(rng, 1, seq, heads)
    big = lambda w: torch.full((1, seq + 64, w), float('nan'),
                               device='cuda', dtype=torch.bfloat16)
    ptr = lambda t: t.data_ptr()
    stream = fa.stream_of(q.device)
    attn, dq, dk, dv = big(hd), big(hd), big(hd), big(hd)
    lse = torch.empty(1, heads, seq, device='cuda')
    mix = th._mix_bank(*m, heads, q.device)
    errs = [th._fn('sav_th_core_fwd', 6, 3)(
        ptr(q), ptr(k), ptr(v), ptr(mix), ptr(attn), ptr(lse), 1, seq, heads,
        stream)]
    # the backward (csrc/th_bwd.cu) with its scratch as _core_bwd makes it:
    # delta, or at H = 16 the staged workspace
    if heads == 16:
        scratch = torch.empty(th.th_bwd_staged_plan(1, seq)['workspace'],
                              dtype=torch.uint8, device='cuda')
        entry = 'sav_th_core_bwd_staged'
    else:
        scratch, entry = torch.empty_like(lse), 'sav_th_core_bwd'
    dm = th._dm_partials(1, seq, heads, q.device)
    errs.append(th._fn(entry, 11, 3, lib='th_bwd')(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(mix), ptr(scratch),
        ptr(dm), ptr(dq), ptr(dk), ptr(dv), 1, seq, heads, stream))
    # K5a's span where it takes the length: its attn scratch and out in
    # sentinel buffers
    spans = []
    if th.fused_fits(seq, heads, dim):
        x = _bf16(rng, (1, seq, dim))
        ones, zeros = torch.ones(dim, device='cuda'), torch.zeros(dim,
                                                                   device='cuda')
        ws = [_bf16(rng, (dim, dim), 1.0 / math.sqrt(dim)) for _ in range(4)]
        scratch = [torch.empty(1, seq, hd, device='cuda', dtype=torch.bfloat16)
                   for _ in range(3)]
        y = torch.empty(seq, dim, device='cuda', dtype=torch.bfloat16)
        attn5, out5 = big(hd), big(dim)
        errs.append(th._fn('sav_th_attention_fwd', 15, 5, 2)(
            ptr(x), ptr(ones), ptr(zeros), *map(ptr, ws), ptr(mix),
            ptr(y), *map(ptr, scratch), ptr(attn5), ptr(out5),
            None, 1, seq, dim, heads, 0, fused_layer.LN_EPS,
            1.0 / math.sqrt(th.HEAD_CH), stream))
        spans = [(attn5, None), (out5, th.th_attention_fwd_plain(
            x, ones, zeros, *ws, *m, heads))]
    torch.cuda.synchronize()
    p_attn, _ = th.th_core_fwd_plain(q, k, v, *m, heads)
    twin = th.th_core_bwd_plain(q, k, v, do, lse, *m, heads)
    pairs = [(attn, p_attn), (dq, twin[0]), (dk, twin[1]), (dv, twin[2])]
    pairs += spans
    rel = max(_rel(t[:, :seq], want) for t, want in pairs if want is not None)
    kept = all(bool(torch.isnan(t[:, seq:]).all()) for t, _ in pairs)
    what = 'K6a, K5b/K6b' + (' and K5a' if spans else '')
    checks.expect(all(e == 0 for e in errs) and rel <= OUT_TOL and kept,
                  f'{what} H={heads} at L={seq} into sentinel buffers: rows < L err '
                  f'{rel:.3g} of max (tol {OUT_TOL}), rows past L untouched '
                  f'{kept}, launch codes {errs}')


# ---- token mixing (K8a, K8b; csrc/mixer_token.cu) and the FF backward (K16;
# csrc/ff_bwd.cu)

def _k8_case(rng, batch, l, k, d):
    """x [batch, l, d] bf16 and the token-mix parameters as the kernels read
    them: LN scale/bias, b1, b2 f32; W1 [l, k], W2 [k, l] bf16 at lecun
    scale (so the token mix is not a near-zero term next to x)."""
    x = _bf16(rng, (batch, l, d))
    ls = (1.0 + 0.1 * _bf16(rng, (d,))).float()
    lb = (0.1 * _bf16(rng, (d,))).float()
    w1 = _bf16(rng, (l, k), 1.0 / math.sqrt(l))
    b1 = (0.1 * _bf16(rng, (k,))).float()
    w2 = _bf16(rng, (k, l), 1.0 / math.sqrt(k))
    b2 = (0.1 * _bf16(rng, (l,))).float()
    return x, ls, lb, w1, b1, w2, b2


def _k8_library(x, ls, lb, w1, b1, w2, b2):
    """The token-mixing sublayer as the per-op bf16 chain (timed only): no
    single PyTorch call computes it."""
    d = x.shape[-1]
    y = F.layer_norm(x, (d,), ls.bfloat16(), lb.bfloat16(), mt.LN_EPS)
    h = F.gelu(y.transpose(1, 2) @ w1 + b1.bfloat16(), approximate='tanh')
    return x + (h @ w2 + b2.bfloat16()).transpose(1, 2)


def check_k8a(rng, checks, batch, l, k, d):
    """K8a vs its twin: the token mix out - x (its own contribution) as max
    |kernel - twin| over max |twin - x|. Returns the kernel record."""
    args = _k8_case(rng, batch, l, k, d)
    x = args[0]
    out = mt.token_mix_fwd(*args)
    plain = mt.token_mix_fwd_plain(*args)
    torch.cuda.synchronize()
    err = _abs(out, plain)
    rel = err / float((plain.float() - x.float()).abs().max())
    checks.expect(bool(torch.isfinite(out).all()) and rel <= OUT_TOL,
                  f'K8a token_mix_fwd B={batch} L={l} K={k} D={d}: max err '
                  f'{err:.4g} = {rel:.3g} of max|out-x| (tol {OUT_TOL})')
    flops = 4 * batch * l * k * d
    nbytes = 2 * batch * l * d * 2 + 2 * l * k * 2 + (2 * d + k + l) * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: mt.token_mix_fwd(*args)),
               plain_ms=time_ms(lambda: mt.token_mix_fwd_plain(*args), iters=3),
               library_ms=time_ms(lambda: _k8_library(*args)), bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err)
    print(f'  K8a B={batch} L={l} K={k} D={d}: kernel {rec["ms"]:.4f} ms  '
          f'plain {rec["plain_ms"]:.4f} ms  library {rec["library_ms"]:.4f} ms'
          f'  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, '
          f'{nbytes / 1e6:.1f} MB)', flush=True)
    print(f'  K8a B={batch} L={l} D={d} launches (route '
          f'{mt.mixer_fwd_plan(batch, l, k, d)["route"]}): '
          + launch_split(lambda: mt.token_mix_fwd(*args)), flush=True)
    return rec


K8_GRADS = ('dx', 'dln_scale', 'dln_bias', 'dw1', 'db1', 'dw2', 'db2')


def check_k8b(rng, checks, batch, l=196, k=98, d=768):
    """K8b vs its twin: each of the seven gradients as max |kernel - twin|
    over max |twin|, and two calls bit-identical (fixed-order sums, no
    float atomics). Returns the kernel record."""
    args = _k8_case(rng, batch, l, k, d)
    g = _bf16(rng, (batch, l, d))
    grads = mt.token_mix_bwd(*args, g)
    again = mt.token_mix_bwd(*args, g)
    twin = mt.token_mix_bwd_plain(*args, g)
    torch.cuda.synchronize()
    errs = [_rel(a, b) for a, b in zip(grads, twin)]
    shapes = all(a.shape == b.shape for a, b in zip(grads, twin))
    finite = all(bool(torch.isfinite(a).all()) for a in grads)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    checks.expect(shapes and finite and same and errs[0] <= BWD_TOL
                  and max(errs[1:]) <= WGRAD_TOL,
                  f'K8b token_mix_bwd B={batch} L={l} K={k} D={d}: '
                  + ', '.join(f'{n} {e:.3g}' for n, e in zip(K8_GRADS, errs))
                  + f' of max (tol dx {BWD_TOL}, the others {WGRAD_TOL}); '
                  f'two calls identical {same}')
    leaves = [t.detach().requires_grad_() for t in args]
    fwd = time_ms(lambda: _k8_library(*leaves))
    both = time_ms(lambda: torch.autograd.grad(_k8_library(*leaves), leaves, g))
    # the backward's own products: hp recomputed, dgact, dW2, dW1, dy
    flops = 10 * batch * l * k * d
    nbytes = 3 * batch * l * d * 2 + 2 * l * k * 2 + 2 * l * k * 4 \
        + (2 * d + k + l) * 4 * 2
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: mt.token_mix_bwd(*args, g)),
               plain_ms=time_ms(lambda: mt.token_mix_bwd_plain(*args, g),
                                iters=3),
               library_ms=max(both - fwd, 0.0), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(_abs(a, b) for a, b in zip(grads, twin)))
    print(f'  K8b B={batch} L={l}: kernel {rec["ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library (per-op backward) '
          f'{rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}; '
          f'{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)', flush=True)
    return rec


def _k16_case(rng, m, d=768, f=3072):
    g = _bf16(rng, (m, d))
    y = _bf16(rng, (m, d))
    hpre = _bf16(rng, (m, f))
    w1 = _bf16(rng, (d, f), 1.0 / math.sqrt(d))
    w2 = _bf16(rng, (f, d), 1.0 / math.sqrt(f))
    return g, hpre, y, w1, w2


K16_GRADS = ('dy', 'dw1', 'dw2', 'db1')


def check_k16(rng, checks, m, d=768, f=3072, timed=True):
    """K16 vs its twin at M rows: dy, dW1, dW2, db1 as max |kernel - twin|
    over max |twin|, and two calls bit-identical (split-K partials summed
    in a fixed order, no float atomics). Returns the kernel record
    (``timed``) or None."""
    args = _k16_case(rng, m, d, f)
    got = fused_layer.ff_bwd(*args)
    again = fused_layer.ff_bwd(*args)
    twin = fused_layer.ff_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [_rel(a, b) for a, b in zip(got, twin)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    checks.expect(finite and same and errs[0] <= BWD_TOL
                  and max(errs[1:]) <= WGRAD_TOL,
                  f'K16 ff_bwd M={m} D={d} F={f}: '
                  + ', '.join(f'{n} {e:.3g}' for n, e in zip(K16_GRADS, errs))
                  + f' of max (tol dy {BWD_TOL}, the others {WGRAD_TOL}); '
                  f'two calls identical {same}')
    if not timed:
        return None
    g, hpre, y, w1, w2 = args
    leaves = [t.detach().requires_grad_() for t in (hpre, y, w1, w2)]

    def library_fwd():
        hp, yy, ww1, ww2 = leaves
        return F.gelu(hp, approximate='tanh') @ ww2, yy @ ww1

    def library():
        """The same function through autograd: dh and dW2 from
        gelu(hpre) @ W2 given g, then dy and dW1 from y @ W1 given dh."""
        hp, yy, ww1, ww2 = leaves
        out, z = library_fwd()
        dh, dw2 = torch.autograd.grad(out, (hp, ww2), g)
        dy, dw1 = torch.autograd.grad(z, (yy, ww1), dh)
        return dy, dw1, dw2, dh.float().sum(0)

    flops = 8 * m * d * f
    nbytes = (3 * m * d + m * f + 2 * d * f) * 2 + (2 * d * f + f) * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(lambda: fused_layer.ff_bwd(*args)),
               plain_ms=time_ms(lambda: fused_layer.ff_bwd_plain(*args), iters=3),
               library_ms=max(time_ms(library) - time_ms(library_fwd), 0.0),
               bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(_abs(a, b) for a, b in zip(got, twin)))
    print(f'  K16 M={m}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f}'
          f' ms  library (autograd backward) {rec["library_ms"]:.4f} ms  bound '
          f'{b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, '
          f'{nbytes / 1e6:.1f} MB)', flush=True)
    return rec


def check_ff_sentinels(rng, checks, batch=65, l=196, k=98, d=768, m=1003):
    """Ragged edges on NaN-sentinel buffers: K8a's out and K8b's dx for an
    odd batch (65 images: the dW GEMMs' last image chunk is partial) written
    into buffers 64 token rows longer than B x L, and K16's dy for a ragged
    M (1003 rows, not a multiple of its 128-row tiles) into a buffer 64 rows
    longer. The B x L (M) rows must match the twins and the rows past them
    keep the sentinel: nothing padded, no row dropped, none written past."""
    stream = fa.stream_of(torch.device('cuda'))
    ptr = lambda t: t.data_ptr()
    x, ls, lb, w1, b1, w2, b2 = _k8_case(rng, batch, l, k, d)
    g = _bf16(rng, (batch, l, d))
    nan_rows = lambda rows, w: torch.full((rows + 64, w), float('nan'),
                                          device='cuda', dtype=torch.bfloat16)
    out, dx = nan_rows(batch * l, d), nan_rows(batch * l, d)
    stats = torch.empty(batch * l, 2, device='cuda')
    codes = [mt._fn('sav_mixer_fwd', 9, 4, 1)(
        ptr(x), ptr(ls), ptr(lb), ptr(w1), ptr(b1), ptr(w2), ptr(b2),
        ptr(stats), ptr(out), batch, l, k, d, mt.LN_EPS, stream)]
    f32 = lambda *s: torch.empty(*s, device='cuda')
    grads = [f32(d), f32(d), f32(l, k), f32(k), f32(k, l), f32(l)]
    ws = torch.empty(mt._fn('sav_mixer_bwd_workspace', 0, 4,
                            restype=ctypes.c_longlong)(batch, l, k, d),
                     dtype=torch.uint8, device='cuda')
    codes.append(mt._fn('sav_mixer_bwd', 15, 4, 1)(
        ptr(x), ptr(g), ptr(ls), ptr(lb), ptr(w1), ptr(b1), ptr(w2), ptr(dx),
        *map(ptr, grads), ptr(ws), batch, l, k, d, mt.LN_EPS, stream))
    gk, hpre, y, w1f, w2f = _k16_case(rng, m)
    dy = nan_rows(m, 768)
    kgrads = list(fused_layer._ff_bwd_into(gk, hpre, y, w1f, w2f, dy[:m]))
    torch.cuda.synchronize()
    want_out = mt.token_mix_fwd_plain(x, ls, lb, w1, b1, w2, b2)
    twin = mt.token_mix_bwd_plain(x, ls, lb, w1, b1, w2, b2, g)
    k_twin = fused_layer.ff_bwd_plain(gk, hpre, y, w1f, w2f)
    n = batch * l
    rows = [_abs(out[:n], want_out.reshape(n, d))
            / float((want_out.float() - x.float()).abs().max()),
            _rel(dx[:n], twin[0].reshape(n, d)), _rel(dy[:m], k_twin[0])]
    wgrads = [_rel(a, b) for a, b in zip(grads + kgrads,
                                         list(twin[1:]) + list(k_twin[1:]))]
    kept = all(bool(torch.isnan(t[r:]).all())
               for t, r in ((out, n), (dx, n), (dy, m)))
    checks.expect(all(c == 0 for c in codes) and max(rows) <= BWD_TOL
                  and max(wgrads) <= WGRAD_TOL and kept,
                  f'K8a/K8b at B={batch} (L={l}) and K16 at M={m} into '
                  f'sentinel buffers: out/dx/dy rows in range err '
                  f'{max(rows):.3g} of max (tol {BWD_TOL}), weight gradients '
                  f'{max(wgrads):.3g} (tol {WGRAD_TOL}), rows past untouched '
                  f'{kept}, launch codes {codes}')


# ---- TNT (slice 5): K1 without the residual (csrc/fused_attention.cu) and
# the inner layer K7a/K7b (csrc/tnt_inner.cu)

def check_k1_route(rng, checks, batch, seq, dim, heads, train, pre_ln=True,
                   residual=True):
    """K1 on one of its routes vs its twin, inference or residual-writing
    variant: pre-LN (here at D = 192, vit_ti's) or post-LN
    (``pre_ln=False``, CeiT's blocks), with the residual or without it
    (TNT's outer sublayer). out as max |kernel - twin| over max |twin - x|
    (the sublayer's own part; over max |twin| without the residual, there
    being no x to subtract); with ``train`` q, k, v, attn over max |twin|
    and lse against the logsumexp of the kernel's own q and k. Timed beside
    the twin and the library chain computing the same function ((LN,) three
    matmuls, SDPA, the out matmul, (+ x)). Returns the record."""
    hd = heads * 64
    args, _, flops = _k1_case(rng, batch, seq, dim, heads)
    x, scale, bias, wq, wk, wv, wo, _ = args
    run = lambda: fused_layer.fused_attention_fwd(
        *args, save_residuals=train, residual=residual, pre_ln=pre_ln)
    plain = lambda: fused_layer.fused_attention_fwd_plain(
        *args, fused_layer.LN_EPS, save_residuals=train, residual=residual,
        pre_ln=pre_ln)
    got, want = run(), plain()
    torch.cuda.synchronize()
    (out, res), (p_out, p_res) = (got, want) if train else ((got, ()),
                                                           (want, ()))
    own_part = p_out.float() - (x.float() if residual else 0.0)
    err_out = _abs(out, p_out) / float(own_part.abs().max())
    errs = [_rel(a, b) for a, b in zip(res[:4], p_res[:4])]
    abs_err = max(_abs(a, b) for a, b in zip((out, *res[:4]),
                                             (p_out, *p_res[:4])))
    lse_err = 0.0
    if train:
        split = lambda a: a.float().view(batch, seq, heads, 64)
        own = torch.logsumexp(torch.einsum('bqhd,bkhd->bhqk', split(res[0]),
                                           split(res[1])), dim=-1)
        lse_err = _abs(res[4], own)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *res))
    name = (f'K1 {"pre-LN" if pre_ln else "post-LN"}'
            f'{"" if residual else " residual=False"}'
            f'{" train" if train else ""} B={batch} L={seq} D={dim} H={heads}')
    checks.expect(finite and max([err_out] + errs) <= OUT_TOL
                  and lse_err <= LSE_TOL,
                  f'{name}: out {err_out:.3g} of max|out{"-x" if residual else ""}|'
                  + (f', q/k/v/attn {", ".join(f"{e:.3g}" for e in errs)} '
                     f'of max; lse vs its own q,k {lse_err:.3g} (tol '
                     f'{LSE_TOL})' if train else '') + f' (tol {OUT_TOL})')

    def library():
        y = (F.layer_norm(x, (dim,), scale.bfloat16(), bias.bfloat16(), 1e-6)
             if pre_ln else x)
        split = lambda a: a.view(batch, seq, heads, 64).transpose(1, 2)
        a = F.scaled_dot_product_attention(*(split(y @ w)
                                             for w in (wq, wk, wv)))
        a = a.transpose(1, 2).reshape(batch, seq, hd) @ wo
        return x + a if residual else a

    m = batch * seq
    nbytes = 2 * m * dim * 2 + 4 * dim * hd * 2 + (2 * dim * 4 if pre_ln
                                                    else 0)
    if train:
        nbytes += 4 * m * hd * 2 + batch * heads * seq * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    rec = dict(ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(abs_err, lse_err))
    print(f'  {name}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms '
          f'({b_by}, {flops / 1e9:.2f} GFLOP)', flush=True)
    print(f'  {name} launches: ' + launch_split(run), flush=True)
    return rec


K7_GRADS = ('dx', 'dln1s', 'dln1b', 'dwq', 'dwk', 'dwv', 'dwo', 'dln2s',
            'dln2b', 'dw1', 'db1', 'dw2', 'db2')


def _k7_case(rng, n, d, heads=4):
    """x [n, 16, d] bf16 and the inner layer's parameters in checkpoint
    layout, f32 as the model holds them (the kernels read the weights in
    bf16): wq 2x lecun so the softmax over the 16 tokens is not flat."""
    hd, f = d // heads, 4 * d
    w = lambda *s, std=1.0: _bf16(rng, s, std / math.sqrt(s[0])).float()
    ln = lambda: ((1.0 + 0.1 * _bf16(rng, (d,))).float(),
                  (0.1 * _bf16(rng, (d,))).float())
    x = _bf16(rng, (n, 16, d))
    (ln1s, ln1b), (ln2s, ln2b) = ln(), ln()
    return (x, ln1s, ln1b, w(d, heads, hd, std=2.0), w(d, heads, hd),
            w(d, heads, hd), w(heads, hd, d), ln2s, ln2b, w(d, f),
            (0.1 * _bf16(rng, (f,))).float(), w(f, d),
            (0.1 * _bf16(rng, (d,))).float())


def _k7_library(x, ln1s, ln1b, wq, wk, wv, wo, ln2s, ln2b, w1, b1, w2, b2,
                heads=4):
    """The inner layer as the per-op bf16 chain (LN, matmuls, SDPA, gelu;
    bf16 parameters; timed only): no single PyTorch call computes it."""
    n, l, d = x.shape
    split = lambda a: a.view(n, l, heads, d // heads).transpose(1, 2)
    y = F.layer_norm(x, (d,), ln1s, ln1b, 1e-6)
    a = F.scaled_dot_product_attention(*(split(y @ w.view(d, d))
                                         for w in (wq, wk, wv)))
    x2 = x + a.transpose(1, 2).reshape(n, l, d) @ wo.view(d, d)
    h = F.gelu(F.layer_norm(x2, (d,), ln2s, ln2b, 1e-6) @ w1 + b1,
               approximate='tanh')
    return x2 + h @ w2 + b2


def _k7_work(n, d, backward):
    """(tensor-core operations, f32 operations, bytes) of K7a or K7b on n
    patches: the four projections and the FF products (the backward's
    recompute and its eight products), the per-head attention in f32
    (q k^T and a v: 4 L D a row; the backward recomputes them and adds da,
    dq, dk, dv: 12 L D), x (and g, dx) moved once, the weights read once
    in bf16 and, in the backward, their gradients written in f32."""
    rows, f = n * 16, 4 * d
    weights = 4 * d * d + 2 * d * f
    if backward:
        return (rows * (24 * d * d + 12 * d * f), rows * 12 * 16 * d,
                3 * rows * d * 2 + weights * 2 + weights * 4
                + (5 * d + f) * 4 * 2)
    return (rows * (8 * d * d + 4 * d * f), rows * 4 * 16 * d,
            2 * rows * d * 2 + weights * 2 + (5 * d + f) * 4)


def _k7_raw(args, g=None, out=None):
    """(launch, outputs) of the C entry of K7a (``g`` None) or K7b alone on
    the parameters as the model holds them (f32: the kernels cast the
    weights as they stage them) and, for K7b, a workspace allocated once:
    the kernels' own time, without the wrapper's checks. Outputs: (out,)
    or (dx, dW f32, LN/bias gradients f32); ``out`` may supply the buffer
    of out or dx."""
    x = args[0]
    n, _, d = x.shape
    f = 4 * d
    raw = tnt_inner._check(x, args[1:], 4)
    stream = fa.stream_of(x.device)
    qs = 1.0 / math.sqrt(d // 4)
    ptrs = [t.data_ptr() for t in raw]
    out = torch.empty_like(x) if out is None else out
    if g is None:
        fn = tnt_inner._fn('sav_tnt_fwd', 14, 4, 2)
        return (lambda: fn(x.data_ptr(), *ptrs, out.data_ptr(), n, d, f, 4,
                           fused_layer.LN_EPS, qs, stream)), (out,)
    gw = torch.empty(4 * d * d + 2 * d * f, device='cuda')
    gvec = torch.empty(5 * d + f, device='cuda')
    ws = torch.empty(tnt_inner._fn('sav_tnt_bwd_workspace', 0, 4,
                                   restype=ctypes.c_longlong)(n, d, f, 4),
                     dtype=torch.uint8, device='cuda')
    fn = tnt_inner._fn('sav_tnt_bwd', 18, 4, 2)
    return (lambda: fn(x.data_ptr(), g.data_ptr(), *ptrs, out.data_ptr(),
                       gw.data_ptr(), gvec.data_ptr(), ws.data_ptr(), n, d, f,
                       4, fused_layer.LN_EPS, qs, stream)), (out, gw, gvec)


def check_k7a(rng, checks, n, d):
    """K7a vs its twin on n patches of width d: the layer's own part, out -
    x, as max |kernel - twin| over max |twin - x|. Returns the record: ms
    of the kernel alone (its C entry), wrapper_ms of ``inner_layer_fwd``
    (its checks and launch, as the model's path calls it)."""
    args = _k7_case(rng, n, d)
    x = args[0]
    run = lambda: tnt_inner.inner_layer_fwd(*args, 4)
    plain = lambda: tnt_inner.inner_layer_fwd_plain(*args, 4)
    out, p_out = run(), plain()
    torch.cuda.synchronize()
    err = _abs(out, p_out)
    rel = err / float((p_out.float() - x.float()).abs().max())
    checks.expect(bool(torch.isfinite(out).all()) and rel <= OUT_TOL,
                  f'K7a tnt_inner_fwd B*P={n} D={d}: max err {err:.4g} = '
                  f'{rel:.3g} of max|out-x| (tol {OUT_TOL})')
    lib = [x] + [t.bfloat16() for t in args[1:]]
    ops, f32_ops, nbytes = _k7_work(n, d, False)
    b_ms, b_by = bound_ms(ops, nbytes, f32_ops)
    rec = dict(ms=time_ms(_k7_raw(args)[0]), wrapper_ms=time_ms(run),
               plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(lambda: _k7_library(*lib)), bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err)
    print(f'  K7a B*P={n} D={d}: kernel {rec["ms"]:.4f} ms (wrapper '
          f'{rec["wrapper_ms"]:.4f})  plain {rec["plain_ms"]:.4f} ms  library '
          f'{rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}; '
          f'{ops / 1e9:.2f} GFLOP tensor, {f32_ops / 1e9:.2f} GFLOP f32, '
          f'{nbytes / 1e6:.1f} MB)', flush=True)
    # a wrapper call launches K7a alone: no preparation of the weights
    names = [name for name, _ in launch_ms([run], 20)]
    checks.expect(len(names) > 0 and all('tnt_fwd_sm90_kernel' in name
                                         for name in names),
                  f'K7a B*P={n} D={d}: a wrapper call launches '
                  f'{[name.split("(")[0][-40:] for name in names]} (the '
                  f'Hopper K7a alone)')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tnt_inner.tnt_fwd_plan(n, d, 4 * d, 4, sms)
    print(f'  K7a B*P={n} D={d} plan: route {plan["route"]}, '
          f'{plan["wgs"]} warpgroups x {plan["blocks"]} blocks, '
          f'{plan["units"]} units of 4 patches, {plan["smem"]} B shared',
          flush=True)
    return rec


def check_k7a_units(rng, checks, base=4 * 331):
    """K7a's 4-patch units at B*P = 1, 2 and 3 (mod 4), both Hopper
    widths, through the C entry into buffers 64 patches longer holding a
    NaN sentinel: the n patches match the twin (OUT_TOL of max |twin -
    x|) and the rest keep the sentinel, so the last unit's patches past
    B*P are neither read nor written; then widths outside the Hopper
    kernel's instantiations (tnt_fwd_plan's route 0, the warp-a-patch
    kernel) through the wrapper against their twins."""
    for d in (24, 40):
        for n in (base + 1, base + 2, base + 3):
            args = _k7_case(rng, n, d)
            x = args[0]
            out = torch.full((n + 64, 16, d), float('nan'), device='cuda',
                             dtype=torch.bfloat16)
            code = _k7_raw(args, out=out)[0]()
            torch.cuda.synchronize()
            want = tnt_inner.inner_layer_fwd_plain(*args, 4)
            rel = _abs(out[:n], want) / float((want.float()
                                               - x.float()).abs().max())
            kept = bool(torch.isnan(out[n:]).all())
            checks.expect(code == 0 and rel <= OUT_TOL and kept,
                          f'K7a B*P={n} ({n % 4} mod 4) D={d} into sentinel '
                          f'buffers: err {rel:.3g} of max|out-x| (tol '
                          f'{OUT_TOL}), patches past untouched {kept}, '
                          f'launch code {code}')
    for n, d, heads in ((37, 16, 2), (29, 48, 4)):
        args = _k7_case(rng, n, d, heads)
        x = args[0]
        plan = tnt_inner.tnt_fwd_plan(n, d, 4 * d, heads)
        out = tnt_inner.inner_layer_fwd(*args, heads)
        want = tnt_inner.inner_layer_fwd_plain(*args, heads)
        torch.cuda.synchronize()
        rel = _abs(out, want) / float((want.float() - x.float()).abs().max())
        checks.expect(plan['route'] == 0 and rel <= OUT_TOL,
                      f'K7a route {plan["route"]} (warp a patch) B*P={n} '
                      f'D={d} H={heads}: err {rel:.3g} of max|out-x| (tol '
                      f'{OUT_TOL})')


def check_k7b(rng, checks, n, d):
    """K7b vs its twin: dx and the 12 parameter gradients as max |kernel -
    twin| over max |twin|, and two calls giving identical bits (no float
    atomics). Returns the kernel record (ms and wrapper_ms as K7a's)."""
    args = _k7_case(rng, n, d)
    g = _bf16(rng, (n, 16, d))
    run = lambda: tnt_inner.inner_layer_bwd(*args, g, 4)
    plain = lambda: tnt_inner.inner_layer_bwd_plain(*args, g, 4)
    grads, twin, again = run(), plain(), run()
    torch.cuda.synchronize()
    errs = [_rel(a, b) for a, b in zip(grads, twin)]
    shapes = all(a.shape == b.shape for a, b in zip(grads, twin))
    finite = all(bool(torch.isfinite(a).all()) for a in grads)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    checks.expect(shapes and finite and same and errs[0] <= BWD_TOL
                  and max(errs[1:]) <= WGRAD_TOL,
                  f'K7b tnt_inner_bwd B*P={n} D={d}: '
                  + ', '.join(f'{k} {e:.3g}' for k, e in zip(K7_GRADS, errs))
                  + f' of max (tol dx {BWD_TOL}, the others {WGRAD_TOL}); '
                  f'two calls identical {same}')
    leaves = [args[0].detach().requires_grad_()] + [
        t.bfloat16().requires_grad_() for t in args[1:]]
    fwd = time_ms(lambda: _k7_library(*leaves))
    both = time_ms(lambda: torch.autograd.grad(_k7_library(*leaves), leaves,
                                               g))
    ops, f32_ops, nbytes = _k7_work(n, d, True)
    b_ms, b_by = bound_ms(ops, nbytes, f32_ops)
    rec = dict(ms=time_ms(_k7_raw(args, g)[0]), wrapper_ms=time_ms(run),
               plain_ms=time_ms(plain, iters=3),
               library_ms=max(both - fwd, 0.0), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(_abs(a, b) for a, b in zip(grads, twin)))
    print(f'  K7b B*P={n} D={d}: kernels {rec["ms"]:.4f} ms (wrapper '
          f'{rec["wrapper_ms"]:.4f})  plain {rec["plain_ms"]:.4f} ms  library '
          f'(per-op backward) {rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms '
          f'({b_by}; {ops / 1e9:.2f} GFLOP tensor, {f32_ops / 1e9:.2f} GFLOP '
          f'f32, {nbytes / 1e6:.1f} MB)', flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tnt_inner.tnt_bwd_plan(n, d, 4 * d, 4, sms)
    print(f'  K7b B*P={n} D={d} launches ({plan["warps"]} warps x '
          f'{plan["blocks"]} blocks, workspace {plan["workspace"]} B): '
          + launch_split(_k7_raw(args, g)[0]), flush=True)
    return rec


def check_k7_sentinels(rng, checks, n, d):
    """The ragged tail: K7a's out and K7b's dx for n patches (odd, so not a
    multiple of a block's warps: K7b's last round is part-filled) written
    into buffers 64 patches longer holding a NaN sentinel. The n
    patches must match the twins and the rest keep the sentinel: nothing
    padded, no patch dropped, none written past; the weight gradients of
    that call at WGRAD_TOL."""
    args = _k7_case(rng, n, d)
    x = args[0]
    g = _bf16(rng, (n, 16, d))
    f = 4 * d
    nan = lambda: torch.full((n + 64, 16, d), float('nan'), device='cuda',
                             dtype=torch.bfloat16)
    fwd, (out,) = _k7_raw(args, out=nan())
    bwd, (dx, gw, gvec) = _k7_raw(args, g, out=nan())
    codes = [fwd(), bwd()]
    torch.cuda.synchronize()
    want = tnt_inner.inner_layer_fwd_plain(*args, 4)
    twin = tnt_inner.inner_layer_bwd_plain(*args, g, 4)
    rows = [_abs(out[:n], want) / float((want.float() - x.float()).abs().max()),
            _rel(dx[:n], twin[0])]
    flat = torch.cat([twin[3].reshape(d, d), twin[4].reshape(d, d),
                      twin[5].reshape(d, d)], dim=1)
    wgrads = [_rel(gw[:3 * d * d].view(d, 3 * d), flat),
              _rel(gw[4 * d * d:4 * d * d + d * f].view(d, f), twin[9]),
              _rel(gvec[:d], twin[1]), _rel(gvec[5 * d:], twin[10])]
    kept = all(bool(torch.isnan(t[n:]).all()) for t in (out, dx))
    checks.expect(all(c == 0 for c in codes) and max(rows) <= BWD_TOL
                  and max(wgrads) <= WGRAD_TOL and kept,
                  f'K7a/K7b at B*P={n} D={d} into sentinel buffers: out/dx '
                  f'err {max(rows):.3g} of max (tol {BWD_TOL}), dWqkv/dW1/'
                  f'dln1s/db1 {max(wgrads):.3g} (tol {WGRAD_TOL}), patches '
                  f'past untouched {kept}, launch codes {codes}')


# ---- BoTNet relative-position attention (K9a, K9b; csrc/botnet_attention.cu)

def _k9_case(rng, batch, g=14, heads=4, d=128):
    """botnet_t3's BoT-stage core inputs at @224: qs (pre-scaled, a peaked
    softmax), k, v [B, g*g, h*d] bf16; rel_h, rel_w [B, h, L, g] f32 at the
    size qs . emb gives them (emb normal with std d^-0.5)."""
    length, hd = g * g, heads * d
    qs = _bf16(rng, (batch, length, hd), 2 / math.sqrt(d))
    k, v = (_bf16(rng, (batch, length, hd)) for _ in range(2))
    rel = [_bf16(rng, (batch, heads, length, g), 0.5).float() for _ in range(2)]
    return qs, k, v, rel[0], rel[1]


def _k9_library(qs, k, v, rel_h, rel_w, heads, g):
    """The same function as one SDPA call with the bias expanded to
    [B, h, L, L] (the expansion included; timed only)."""
    b, length, hd = qs.shape
    split = lambda a: a.view(b, length, heads, hd // heads).transpose(1, 2)
    bias_h, bias_w = bot.expand_bias(rel_h, rel_w, g)
    out = F.scaled_dot_product_attention(
        split(qs), split(k), split(v), attn_mask=(bias_h + bias_w).to(qs.dtype),
        scale=1.0)
    return out.transpose(1, 2).reshape(b, length, hd)


def _k9_bytes(batch, heads, length, g, d, bands, rels, stats):
    """Bytes of ``bands`` [B, L, h*d] bf16 tensors, ``rels`` [B, h, L, g]
    and ``stats`` [B, h, L] f32 rows, each moved once."""
    return (bands * batch * length * heads * d * 2
            + rels * batch * heads * length * g * 4
            + stats * batch * heads * length * 4)


def check_k9a(rng, checks, batch, train, g=14, heads=4, d=128):
    """K9a vs its twin: out over max |twin|, lse (the training forward's)
    absolute; returns the record: ms of its C entry alone, wrapper_ms of
    ``bot_fwd`` (its checks and launch)."""
    args = _k9_case(rng, batch, g, heads, d)
    out, lse = bot.bot_fwd(*args, heads, g, save_lse=True)
    p_out, p_lse = bot.bot_fwd_plain(*args, heads, g)
    torch.cuda.synchronize()
    err, lse_err = _abs(out, p_out), _abs(lse, p_lse)
    rel = err / float(p_out.float().abs().max())
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    checks.expect(finite and rel <= OUT_TOL and lse_err <= LSE_TOL,
                  f'K9a bot_fwd B={batch} g={g} h={heads} d={d}: out err '
                  f'{rel:.3g} of max (tol {OUT_TOL}), lse abs err '
                  f'{lse_err:.3g} (tol {LSE_TOL})')
    length = g * g
    flops = 4 * batch * heads * length * length * d
    nbytes = _k9_bytes(batch, heads, length, g, d, 4, 2, 1 if train else 0)
    b_ms, b_by = bound_ms(flops, nbytes)
    raw_out = torch.empty_like(out)
    raw_lse = torch.empty_like(lse) if train else None
    rec = dict(ms=time_ms(_k9_raw(args, heads, g, raw_out, raw_lse)),
               wrapper_ms=time_ms(lambda: bot.bot_fwd(*args, heads, g,
                                                      save_lse=train)),
               plain_ms=time_ms(lambda: bot.bot_fwd_plain(*args, heads, g),
                                iters=5),
               library_ms=time_ms(lambda: _k9_library(*args, heads, g)),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=max(err, lse_err))
    plan = bot.bot_fwd_plan(g, d)
    print(f'  K9a B={batch} g={g}{" train" if train else ""}: kernel '
          f'{rec["ms"]:.4f} ms (wrapper {rec["wrapper_ms"]:.4f})  plain '
          f'{rec["plain_ms"]:.4f} ms  library '
          f'{rec["library_ms"]:.4f} ms  bound {b_ms:.4f} ms ({b_by}; '
          f'{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); plan: '
          f'{plan["tiles"]} key tiles of {plan["width"]}, {plan["qbufs"]} '
          f'Q buffers, {plan["stages"]} ring slots, {plan["smem"]} B shared, '
          f'{-(-g * g // 128) * heads * batch} units', flush=True)
    return rec


def _k9_raw(args, heads, g, out, lse, do=None, bufs=None):
    """Launch of the C entry of K9a (``do`` None) or of K9b's two kernels
    into caller-given buffers (``bufs``: delta, dq, dk, dv, drel_h, drel_w),
    without the wrapper: the kernels' own time, and the ragged check's
    sentinel buffers. Returns the launch, which returns its codes."""
    qs, k, v, rel_h, rel_w = args
    b, length, hd = qs.shape
    dims = (b, length, heads, g, hd // heads, fa.stream_of(qs.device))
    p = lambda *ts: [None if t is None else t.data_ptr() for t in ts]
    if do is None:
        fn = bot._fn('sav_bot_fwd', 7, 5)
        return lambda: [fn(*p(qs, k, v, rel_h, rel_w, out, lse), *dims)]
    delta, dq, dk, dv, drh, drw = bufs
    fdq = bot._fn('sav_bot_bwd_dq', 12, 5)
    fdkv = bot._fn('sav_bot_bwd_dkv', 10, 5)
    dq_launch = lambda: fdq(*p(qs, k, v, out, do, rel_h, rel_w, lse, delta, dq,
                               drh, drw), *dims)
    dkv_launch = lambda: fdkv(*p(qs, k, v, do, rel_h, rel_w, lse, delta, dk,
                                 dv), *dims)
    return lambda: [dq_launch(), dkv_launch()], dq_launch, dkv_launch


def _k9_bufs(qs, rel_h, lse, fill=None):
    """delta, dq, dk, dv, drel_h, drel_w for K9b (NaN-filled when ``fill``)."""
    new = (lambda t: torch.empty_like(t)) if fill is None else (
        lambda t: torch.full_like(t, fill))
    return (torch.empty_like(lse), new(qs), new(qs), new(qs), new(rel_h),
            new(rel_h))


def check_k9b(rng, checks, batch, g=14, heads=4, d=128):
    """K9b vs its twin at the forward's out and lse: dq, dk, dv over max
    |twin| (BWD_TOL), drel_h and drel_w (BOT_REL_TOL), two calls giving
    identical bits. Returns the records of the dq and the dkv kernel, each
    timed alone."""
    args = _k9_case(rng, batch, g, heads, d)
    out, lse = bot.bot_fwd_plain(*args, heads, g)
    do = _bf16(rng, out.shape)
    grads = bot.bot_bwd(*args, out, lse, do, heads, g)
    twin = bot.bot_bwd_plain(*args, out, lse, do, heads, g)
    again = bot.bot_bwd(*args, out, lse, do, heads, g)
    torch.cuda.synchronize()
    errs = [_rel(a, t) for a, t in zip(grads, twin)]
    same = all(torch.equal(a, t) for a, t in zip(grads, again))
    finite = all(bool(torch.isfinite(a).all()) for a in grads)
    checks.expect(finite and same and max(errs[:3]) <= BWD_TOL
                  and max(errs[3:]) <= BOT_REL_TOL,
                  f'K9b bot_bwd B={batch} g={g} h={heads} d={d}: ' + ', '.join(
                      f'{n} {e:.3g}' for n, e in zip(K9_GRADS, errs))
                  + f' of max (tol dq/dk/dv {BWD_TOL}, drel {BOT_REL_TOL}); '
                  f'two calls identical {same}')
    _, dq_launch, dkv_launch = _k9_raw(args, heads, g, out, lse, do,
                                       _k9_bufs(args[0], args[3], lse))
    leaves = [a.detach().requires_grad_() for a in args]
    fwd = time_ms(lambda: _k9_library(*leaves, heads, g))
    both = time_ms(lambda: torch.autograd.grad(
        _k9_library(*leaves, heads, g), leaves, do))
    library = max(both - fwd, 0.0)
    plain_ms = time_ms(lambda: bot.bot_bwd_plain(*args, out, lse, do, heads,
                                                 g), iters=3)
    whole_ms = time_ms(lambda: bot.bot_bwd(*args, out, lse, do, heads, g))
    length = g * g
    mm = 2 * batch * heads * length * length * d
    abs_errs = [_abs(a, t) for a, t in zip(grads, twin)]
    recs = {}
    for name, launch, products, bands, rels, stats, err in (
            ('dq', dq_launch, 3, 6, 4, 2, max(abs_errs[0], *abs_errs[3:])),
            ('dkv', dkv_launch, 4, 6, 2, 2, max(abs_errs[1:3]))):
        b_ms, b_by = bound_ms(products * mm, _k9_bytes(
            batch, heads, length, g, d, bands, rels, stats))
        recs[name] = dict(ms=time_ms(launch), plain_ms=plain_ms,
                          library_ms=None, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, whole_ms=whole_ms,
                          library_bwd_ms=library)
    whole_bound, whole_by = bound_ms(5 * mm, _k9_bytes(batch, heads, length, g,
                                                       d, 8, 4, 1))
    for r in recs.values():
        r['whole_bound_ms'] = whole_bound
    print(f'  K9b B={batch} g={g}: dq kernel {recs["dq"]["ms"]:.4f} ms '
          f'(bound {recs["dq"]["bound_ms"]:.4f}), dkv kernel '
          f'{recs["dkv"]["ms"]:.4f} ms (bound {recs["dkv"]["bound_ms"]:.4f}); '
          f'wrapper {whole_ms:.4f} ms  plain {plain_ms:.4f} ms  library '
          f'(autograd of the SDPA chain) {library:.4f} ms  bound of the '
          f'function {whole_bound:.4f} ms ({whole_by}; {5 * mm / 1e9:.2f} '
          f'GFLOP)', flush=True)
    return recs


def check_k9_ragged(rng, checks, batch, g, heads=4, d=128):
    """A grid whose L = g*g is ragged against the 64-row tiles, K9a and K9b
    through their C entries into buffers 64 rows longer holding a NaN
    sentinel (the rel gradients 64 rows past the last head's), twice: the
    live rows match the twins, every sentinel stays, and the two calls give
    identical bits."""
    args = _k9_case(rng, batch, g, heads, d)
    qs, _, _, rel_h, _ = args
    b, length, hd = qs.shape
    p_out, p_lse = bot.bot_fwd_plain(*args, heads, g)
    do = _bf16(rng, p_out.shape)
    twin = bot.bot_bwd_plain(*args, p_out, p_lse, do, heads, g)

    def run():
        nan = lambda n: torch.full((n,), float('nan'), device='cuda',
                                   dtype=torch.bfloat16)
        band = lambda: nan((b * length + 64) * hd)
        rel = lambda: torch.full((rel_h.numel() + 64 * g,), float('nan'),
                                 device='cuda')
        out, bufs = band(), (torch.empty_like(p_lse), band(), band(), band(),
                             rel(), rel())
        lse = torch.empty_like(p_lse)
        view = lambda t, like: t[:like.numel()].view(like.shape)
        codes = _k9_raw(args, heads, g, view(out, p_out), lse)()
        codes += _k9_raw(args, heads, g, p_out, p_lse, do, [
            bufs[0], *(view(t, qs) for t in bufs[1:4]),
            *(view(t, rel_h) for t in bufs[4:])])[0]()
        torch.cuda.synchronize()
        return codes, out, bufs[1:]

    codes, out, grads = run()
    codes2, out2, grads2 = run()
    live = lambda t, like: t[:like.numel()].view(like.shape)
    errs = [_rel(live(out, p_out), p_out)] + [
        _rel(live(t, w), w) for t, w in zip(grads[:3], twin[:3])]
    rel_errs = [_rel(live(t, w), w) for t, w in zip(grads[3:], twin[3:])]
    kept = all(bool(torch.isnan(t[n:]).all()) for t, n in zip(
        (out, *grads), [p_out.numel()] + [qs.numel()] * 3
        + [rel_h.numel()] * 2))
    same = all(torch.equal(live(a, w), live(c, w)) for a, c, w in zip(
        (out, *grads), (out2, *grads2), (p_out, *twin)))
    checks.expect(all(c == 0 for c in codes + codes2) and max(errs) <= BWD_TOL
                  and max(rel_errs) <= BOT_REL_TOL and kept and same,
                  f'K9a/K9b ragged g={g} (L={length}) B={batch} into sentinel '
                  f'buffers: out/dq/dk/dv err {max(errs):.3g} of max (tol '
                  f'{BWD_TOL}), drel {max(rel_errs):.3g} (tol {BOT_REL_TOL}), '
                  f'rows past untouched {kept}, two calls identical {same}, '
                  f'launch codes {codes + codes2}')


def fill_batchnorm(model, seed: int) -> None:
    """BoTNet: every BatchNorm's bias from N(0, 0.1^2) and its scale from
    U(0.5, 1.5), except the last BN of each bottleneck, which starts at 0
    (hiding the whole branch, attention included, from the logits and the
    gradients): its scale from U(0.02, 0.1), so each block stays near the
    identity it starts as. Filled like the others, the 16 blocks of a
    random net amplify bf16 rounding until even the kernel route and its
    twins on the same boundary disagree beyond LOGIT_TOL (``serve_path``
    prints how far the attention moves the logits at this fill). Then the
    running statistics from one training-mode forward at momentum 0 on 16
    normal images, so that eval mode normalises (mean != 0 and var != 1
    from the data, not the initial 0 and 1)."""
    gen = torch.Generator().manual_seed(seed + 2)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    was_training = model.training
    momenta = [bn.momentum for bn in norms]
    with torch.no_grad():
        for bn in norms:
            lo, hi = (0.02, 0.1) if bn.zero_scale else (0.5, 1.5)
            bn.scale.copy_(lo + (hi - lo) * torch.rand(bn.scale.shape,
                                                       generator=gen))
            bn.bias.copy_(0.1 * torch.randn(bn.bias.shape, generator=gen))
            bn.momentum = 0.0
        size = model.img_size
        model.train()(torch.randn((16, size, size, 3), generator=gen).cuda()
                      .to(model.dtype))
    for bn, momentum in zip(norms, momenta):
        bn.momentum = momentum
    model.train(was_training)


def running_stats(model):
    """A copy of every running statistic (BatchNorm buffers) by name."""
    return {n: t.detach().clone() for n, t in model.named_buffers()}


def load_running_stats(model, stats) -> None:
    with torch.no_grad():
        for n, t in model.named_buffers():
            t.copy_(stats[n])


def _grads(model, batch, seed, num_classes=1000):
    """Loss and gradients of one batch in training mode; the stochastic-depth
    masks come from a generator seeded from ``seed``, so every path that
    this is called on draws the same masks, and the running statistics
    (BatchNorm) are restored after the forward."""
    model.train()
    model.zero_grad(set_to_none=True)
    stats = running_stats(model)
    set_stochastic_depth_generator(
        model, torch.Generator(device='cuda').manual_seed(seed))
    loss, _ = loss_and_logits(model, batch, num_classes, 0.1)
    loss.backward()
    set_stochastic_depth_generator(model, None)
    # the forward in training mode moved the BatchNorm running statistics:
    # put them back, so every path compared sees the same state
    load_running_stats(model, stats)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _grad_rule(g_kernel, g_plain, g_32):
    """(worst, noisiest): the parameter farthest from the rule
    max(GRAD_TOL, GRAD_NOISE * plain vs f32) as (err / tol, name, err,
    tol, plain vs f32, kernel vs f32), and the one whose plain gradient is
    farthest from f32 as (plain vs f32, name, kernel vs f32)."""
    worst = (0.0, '', 0.0, 0.0, 0.0, 0.0)
    noisiest = (0.0, '', 0.0)
    for n, g in g_plain.items():
        err = _rel_l2(g_kernel[n], g)
        noise = _rel_l2(g, g_32[n])
        tol = max(GRAD_TOL, GRAD_NOISE * noise)
        if err / tol > worst[0]:
            worst = (err / tol, n, err, tol, noise,
                     _rel_l2(g_kernel[n], g_32[n]))
        if noise > noisiest[0]:
            noisiest = (noise, n, _rel_l2(g_kernel[n], g_32[n]))
    return worst, noisiest


def check_grads(checks, name, model, batch, seed, model_name, img_size,
                plain_core, use_kernel, num_classes=1000, **overrides):
    """Gradients on one batch: the kernel path, the plain core on the same
    boundary, and the f32 per-op path as the reference, held to
    ``_grad_rule`` (the head filled so the encoder's gradients are not all
    zero). ``overrides`` rebuild the reference as the model was built
    (e.g. a cut depth). Returns the launches of the kernel path's forward
    and backward, counted from 0."""
    fill_head(model, seed)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    loss_k, g_kernel = _grads(model, batch, seed, num_classes)
    counts = dict(_build.launches)
    _reroute(model, plain_core, use_kernel, True)
    loss_x, g_plain = _grads(model, batch, seed, num_classes)
    _reroute(model, plain_core, use_kernel, False)
    ref = create_model(model_name, num_classes=num_classes,
                       dtype=torch.float32, img_size=img_size, device='cuda',
                       use_kernel=False, **overrides)
    ref.load_state_dict(model.state_dict())
    if plain_core == INT8_PLAIN:
        set_int8_core(ref, 'plain')       # f32 activations: the twins
    loss_32, g_32 = _grads(ref, batch, seed, num_classes)
    grad_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del ref
    torch.cuda.empty_cache()
    worst, noisiest = _grad_rule(g_kernel, g_plain, g_32)
    finite = all(bool(torch.isfinite(g).all()) for g in g_kernel.values())
    checks.expect(finite and worst[0] <= 1.0,
                  f'{name}: gradients vs {plain_core!r} on '
                  f'{len(batch["labels"])} images, {len(g_plain)} '
                  f'parameters, worst {worst[2]:.3g} (L2, tol {worst[3]:.3g}) '
                  f'at {worst[1]} (there plain core vs f32 {worst[4]:.3g}, '
                  f'kernels vs f32 {worst[5]:.3g}); loss {loss_k:.5f} vs '
                  f'{loss_x:.5f} (f32 '
                  f'{loss_32:.5f}); farthest from f32: {noisiest[1]}, plain '
                  f'core {noisiest[0]:.3g}, kernels {noisiest[2]:.3g}; peak '
                  f'{grad_peak:.2f} GiB allocated')
    return counts


def _reroute(model, plain_core, use_kernel, plain: bool) -> None:
    """Puts ``model`` on the plain core of its boundary (``plain``) or back
    on ``use_kernel``: a use_kernel mode, BOT_PLAIN (BoTNet's attention
    core on the K9 twins at the same 'botnet_fused' boundary), CVT_PLAIN
    (CvT's flash route on the K4 and K3 twins at the same boundary) or
    INT8_PLAIN (every int8 block on its twin at the same boundary)."""
    if plain_core == BOT_PLAIN:
        set_attention_core(model, 'plain' if plain else 'kernel')
    elif plain_core == CVT_PLAIN:
        cvt_attention_core(model, 'plain' if plain else 'kernel')
    elif plain_core == VIT_PLAIN:
        vit_attention_core(model, 'plain' if plain else 'kernel')
    elif plain_core == INT8_PLAIN:
        set_int8_core(model, 'plain' if plain else 'kernel')
    else:
        set_use_kernel(model, plain_core if plain else use_kernel)


def blocked_path(checks, label, batch, seq, heads, layers, seed):
    """The blocked route's own path: ``layers`` talking-heads sublayers
    chained as CaiT's body chains them (x + 0.1 span(x)) through the op's
    entry ``th_attention_sublayer(..., route='blocked')`` (library LN and
    projections around the K6a port, the K6b port in the backward): the
    route of a width K5a's GEMMs do not take, which no factory CaiT has
    on the card. The counts are set to 0 just before one forward and
    backward and read just after (want: ``layers`` of K6a and of K6b); the
    output by relative L2 (5e-2) and every gradient (x and the eight
    tensors of each sublayer, f32 parameters as a model holds them) by
    ``_grad_rule`` against the same chain on route 'xla' (the plain core),
    with the chain of f32 per-op sublayers (``th_sublayer_reference``) as
    the noise floor, as the model paths' gradients are held. Returns the
    counts."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    dim = heads * th.HEAD_CH
    rnd = lambda shape, std: (torch.randn(shape, generator=gen) * std).cuda()
    x0 = rnd((batch, seq, dim), 1.0).bfloat16()
    params = [[1.0 + rnd((dim,), 0.1), rnd((dim,), 0.1),
               rnd((dim, heads, th.HEAD_CH), 4.0 / math.sqrt(dim)),
               rnd((dim, heads, th.HEAD_CH), 1.0 / math.sqrt(dim)),
               rnd((dim, heads, th.HEAD_CH), 1.0 / math.sqrt(dim)),
               rnd((heads, th.HEAD_CH, dim), 1.0 / math.sqrt(dim)),
               torch.eye(heads, device='cuda') + rnd((heads, heads), 0.3),
               torch.eye(heads, device='cuda') + rnd((heads, heads), 0.3)]
              for _ in range(layers)]

    names = ['x'] + [f'{i}.{n}' for i in range(layers)
                     for n in ('scale', 'bias', 'wq', 'wk', 'wv', 'wo',
                               'm_pre', 'm_post')]

    def run(route):
        leaves = [(x0.float() if route is None else x0).clone()
                  .requires_grad_()] + [
            t.clone().requires_grad_() for p in params for t in p]
        y = leaves[0]
        for i in range(layers):
            p = leaves[1 + 8 * i:9 + 8 * i]
            y = y + 0.1 * (
                th.th_sublayer_reference(y, *p, th.LN_EPS) if route is None
                else th.th_attention_sublayer(y, *p, heads, th.LN_EPS, False,
                                              route))
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        return y.detach(), dict(zip(names, [t.grad for t in leaves]))

    _build.reset_launches()
    out, grads = run('blocked')
    counts = dict(_build.launches)
    want_out, want = run('xla')
    _, ref = run(None)
    (ratio, name, g_err, tol, noise, far), _ = _grad_rule(grads, want, ref)
    err = _rel_l2(out, want_out)
    finite = all(bool(torch.isfinite(g).all())
                 for g in [out, *grads.values()])
    expected = {'th_core_fwd': layers, 'th_core_bwd': layers}
    checks.expect(counts == expected and finite and err <= GRAD_TOL
                  and ratio <= 1.0,
                  f'{label}: launches {counts} (want {expected}); out '
                  f'{err:.3g} relative L2 from route xla (tol {GRAD_TOL}); '
                  f'{len(grads)} gradients, worst {g_err:.3g} (L2, tol '
                  f'{tol:.3g}) at {name} (there plain core vs f32 '
                  f'{noise:.3g}, kernels vs f32 {far:.3g})')
    print(f'  {label}: the path took {time.perf_counter() - t0:.1f} s',
          flush=True)
    return counts


def train_path(checks, name, img_size, batch, want, seed, steps=10,
               profile=False, model_name='vit_b_patch16',
               plain_core='fused_layer_xla', use_kernel='auto',
               quantized=False):
    """One Trainer step with the counts at 0 (want: the exact counts), then
    gradients vs the plain core (``plain_core``: a use_kernel mode,
    BOT_PLAIN or INT8_PLAIN; None skips the check) on that batch, img/s and
    one eval batch; with BatchNorm, every running statistic finite and moved
    by the timed steps. ``use_kernel`` other than 'auto' re-routes the
    Trainer's model first (the JAX package reaches 'fused_ff' and
    'botnet_fused' only through create_model, so the Trainer has no flag
    for them); ``quantized`` is the Trainer's own field. Returns the
    counts."""
    t_path = time.perf_counter()
    trainer = Trainer(TrainConfig(model_name=model_name,
                                  img_size=img_size, batch_size=batch,
                                  seed=seed, dtype='bfloat16',
                                  quantized=quantized), device='cuda')
    if use_kernel != 'auto':
        set_use_kernel(trainer.model, use_kernel)
    data = trainer.dataset()
    first = data.batch(0)
    _build.reset_launches()
    metrics = trainer.train_step(first)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    loss = float(metrics['loss'])
    checks.expect(counts == want, f'{name}: launches per train step {counts} '
                                  f'(want {want})')
    checks.expect(math.isfinite(loss), f'{name}: loss {loss:.5g} finite')

    if plain_core is not None:
        check_grads(checks, name, trainer.model, first, seed, model_name,
                    img_size, plain_core, use_kernel,
                    **({'quantized': quantized} if quantized else {}))

    stats = running_stats(trainer.model)
    for i in range(2):                       # warm-up
        trainer.train_step(data.batch(1 + i))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(steps):
        metrics = trainer.train_step(data.batch(3 + i))
    loss = float(metrics['loss'])
    secs = time.perf_counter() - start
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(data.batch(3 + steps))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if stats:
        after = dict(trainer.model.named_buffers())
        finite = all(bool(torch.isfinite(t).all()) for t in after.values())
        moved = sum(bool((after[n] != t).all()) for n, t in stats.items())
        checks.expect(finite and moved == len(stats),
                      f'{name}: running statistics after {steps + 3} steps: '
                      f'finite {finite}, {moved} of {len(stats)} moved in '
                      f'every channel')
    ev = trainer.evaluate(trainer.dataset(seed_offset=1), 1)
    checks.expect(math.isfinite(loss) and math.isfinite(ev['eval_loss'])
                  and not trainer.model.training,
                  f'{name}: loss after {steps + 4} steps {loss:.5g}, eval loss '
                  f'{ev["eval_loss"]:.5g} (eval mode), finite')
    print(f'  {name}: {steps * batch / secs:.1f} train img/s over {steps} '
          f'steps ({1e3 * secs / steps:.2f} ms/step incl. host), peak '
          f'{peak:.2f} GiB allocated; the path took '
          f'{time.perf_counter() - t_path:.1f} s', flush=True)
    if profile:
        print_profile(lambda: trainer.train_step(data.batch(0)), iters=2)
        if model_name.startswith('cvt'):
            print_module_split(trainer.model,
                               lambda: trainer.train_step(data.batch(0)), 2)
    del trainer
    torch.cuda.empty_cache()
    return counts


# (name, img_size, batch, the plain core on the same autograd boundary):
# the distinct dispatch shapes that ``auto`` takes on the card among the
# factory names the paths above do not build (H = 16 at L = 197 and 577 on
# K1/K2/K3; D = 192 on K1's 192-wide GEMM tile, pre-LN (vit_ti) and
# post-LN (ceit_t); D = 384, H = 6; CaiT's H = 4 on K5 at L = 196 and 576,
# H = 16 on K5 at L = 576 (cait_m_24 @384) and H = 6 on K5 at L = 576
# (cait_xs_24 @384);
# the Mixer's S and L widths on K8; cvt-w24 @384 on K4 + K3 at 9216 over
# 2304 keys in 3 heads, 2304 over 576 in 12, the padded 625 over 169 in 16)
SWEEP = (
    ('vit_l_patch16', 224, 4, 'fused_layer_xla'),
    ('vit_l_patch16', 384, 2, 'fused_layer_xla'),
    ('vit_ti_patch16', 224, 4, 'fused_layer_xla'),
    ('ceit_t', 224, 4, 'fused_layer_xla'),
    ('vit_s_patch16', 224, 4, 'fused_layer_xla'),
    ('cait_xxs_24', 224, 4, 'fused_th_xla'),
    ('cait_xxs_24', 384, 2, 'fused_th_xla'),
    ('cait_m_24', 384, 2, 'fused_th_xla'),
    ('cait_xs_24', 384, 2, 'fused_th_xla'),
    ('mixer_s_patch16', 224, 4, False),
    ('mixer_l_patch16', 224, 4, False),
    ('cvt-w24', 384, 2, CVT_PLAIN),
)


def depth_cut(name: str, depth: int) -> dict:
    """``create_model`` overrides that cut a factory name to ``depth``
    blocks: ``num_layers``, or for CvT one block in each of its first two
    stages and ``depth`` in the last."""
    if name.startswith('cvt'):
        return {'stage_sizes': (1, 1, depth)}
    return {'num_layers': depth}


def sweep_factory(checks, seed: int, depth: int = 2) -> None:
    """Each SWEEP entry at full width and ``depth`` layers under
    use_kernel='auto': the kernels one forward launches, logits against
    use_kernel=False on the same weights (LOGIT_TOL), and every parameter's
    gradient by ``_grad_rule`` against the plain core with the f32 per-op
    path as the noise floor. A shape that ``auto`` refuses on the card
    prints its refusal, and use_kernel=False must run it. Returns each
    entry's launches per forward by its name and size, and those of its
    gradient step by (name, size, 'grad')."""
    launched = {}
    for name, img_size, batch, plain_core in SWEEP:
        t_entry = time.perf_counter()
        label = f'sweep {name} @{img_size} depth {depth} bs{batch}'
        cut = depth_cut(name, depth)
        model = create_model(name, num_classes=1000, dtype=torch.bfloat16,
                             img_size=img_size, seed=seed, device='cuda', **cut)
        fill_head(model, seed)
        gen = torch.Generator().manual_seed(seed + 3)
        images = torch.randn((batch, img_size, img_size, 3), generator=gen)
        data = {'images': images.cuda(),
                'labels': torch.randint(0, 1000, (batch,),
                                        generator=gen).cuda()}
        x = data['images'].bfloat16()
        model.eval()
        with torch.no_grad():
            set_use_kernel(model, False)
            plain = model(x).float()
            set_use_kernel(model, 'auto')
            _build.reset_launches()
            try:
                logits = model(x).float()
            except NotImplementedError as refusal:
                checks.expect(bool(torch.isfinite(plain).all()),
                              f'{label}: auto refuses on the card ({refusal}); '
                              'use_kernel=False runs, logits finite')
                continue
        counts = dict(_build.launches)
        launched[(name, img_size)] = counts
        err = _abs(logits, plain) / float(plain.abs().max())
        checks.expect(bool(counts) and bool(torch.isfinite(logits).all())
                      and err <= LOGIT_TOL,
                      f'{label}: launches per forward {counts}; logits vs '
                      f'use_kernel=False: max err {err:.3g} of max|logit| '
                      f'(tol {LOGIT_TOL})')
        grad = launched[(name, img_size, 'grad')] = check_grads(
            checks, label, model, data, seed, name, img_size, plain_core,
            'auto', **cut)
        print(f'  {label}: launches per gradient step {grad}; the entry took '
              f'{time.perf_counter() - t_entry:.1f} s', flush=True)
        del model
        torch.cuda.empty_cache()
    return launched


# ---- int8 (slice 7): K15 (csrc/int8_matmul.cu), K12/K13 (csrc/int8_ff.cu),
# K10 (csrc/fused_attention_q8.cu)

def _int8_expect(checks, what, got, want, base=None) -> float:
    """Holds a kernel's output against its twin's (INT8_TOL, INT8_SHARE);
    returns max |kernel - twin|."""
    got, want = got.float(), want.float()
    ref = want if base is None else want - base.float()
    err = float((got - want).abs().max())
    rel = err / float(ref.abs().max())
    same = float((got == want).float().mean())
    checks.expect(bool(torch.isfinite(got).all()) and rel <= INT8_TOL
                  and same >= INT8_SHARE,
                  f'{what}: max err {rel:.3g} of max|twin'
                  f'{"" if base is None else " - x"}| (tol {INT8_TOL}), '
                  f'{same:.5f} of the values bit-identical (at least '
                  f'{INT8_SHARE})')
    return err


def _time_int8(kernel, plain, library, int8_ops, nbytes, err, flops=0.0,
               f32_flops=0.0):
    """The kernel record: times of the kernel, its twin and the library
    chain, and the bound of the same work."""
    b_ms, b_by = bound_ms(flops, nbytes, f32_flops, int8_ops=int8_ops)
    return dict(ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def check_k15(rng, checks, m=6304, k=768, n=3072):
    """K15 vs its twin at one of ViT-B's FF products (bs32 @224: FF1 K =
    768 N = 3072, FF2 K = 3072 N = 768); the library chain: per-block codes
    in torch, one ``_int_mm`` per 256-wide k-block, the fold and the column
    scales in torch. Also times its C entry alone (``entry_ms``: the
    wrapper's host work is most of a small call) and prints each
    launch's device time."""
    a = _bf16(rng, (m, k))
    b_q, b_s = quantize_symmetric(_bf16(rng, (k, n), 1.0 / math.sqrt(k)), 0)
    got = k15.int8_matmul_fused(a, b_q, b_s)
    twin = k15.blockwise_int8_matmul_reference(a, b_q, b_s)
    torch.cuda.synchronize()
    err = _int8_expect(checks, f'K15 int8_matmul_fused M={m} K={k} N={n}',
                       got, twin)

    def library():
        acc = 0.0
        for j in range(0, k, k15.BLOCK_K):
            q, s = k15._quantize_tile(a[:, j:j + k15.BLOCK_K])
            acc = acc + torch._int_mm(q, b_q[j:j + k15.BLOCK_K]).float() * s
        return (acc * b_s).bfloat16()

    rec = _time_int8(lambda: k15.int8_matmul_fused(a, b_q, b_s),
                     lambda: k15.blockwise_int8_matmul_reference(a, b_q, b_s),
                     library, 2 * m * k * n,
                     m * k * 2 + k * n + n * 4 + m * n * 2, err)
    plan = k15.int8_matmul_plan(m, k, n)
    ws = torch.empty(plan['workspace'], dtype=torch.uint8, device='cuda')
    out = torch.empty(m, plan['ldo'], dtype=torch.bfloat16, device='cuda')
    ptrs = [t.data_ptr() for t in (a, b_q, b_s.reshape(n).contiguous(), ws,
                                   out)]
    stream, fn = fa.stream_of(torch.device('cuda')), k15._k15_lib()
    entry = lambda: fn(*ptrs, m, k, n, stream)
    rec['entry_ms'] = time_ms(entry)
    print(f'  K15 M={m} K={k} N={n}: kernel {rec["ms"]:.4f} ms  C entry '
          f'{rec["entry_ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} ms  library '
          f'{rec["library_ms"]:.4f} ms  bound {rec["bound_ms"]:.4f} ms '
          f'({rec["bound_by"]})', flush=True)
    print(f'  K15 M={m} K={k} N={n} launches: {launch_split(entry)}',
          flush=True)
    return rec


def _int8_ff_case(rng, m, d=768, f=3072):
    x = _bf16(rng, (m, d))
    vec = lambda shape, std, mean=0.0: (mean + std * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).cuda()
    w1_q, s1, w2_q, s2 = int8_ff._quantized_weights(
        vec((d, f), 1.0 / math.sqrt(d)), vec((f, d), 1.0 / math.sqrt(f)))
    return x, (vec(d, 0.1, 1.0), vec(d, 0.1)), (w1_q, s1, vec(f, 0.1), w2_q,
                                                s2, vec(d, 0.1))


def check_int8_ff(rng, checks, m, ln, save_hpre, d=768, f=3072):
    """K13 (``ln``) or K12 vs its twin at M rows, with or without
    ``save_hpre``, and two calls bit-identical; the library chain:
    LayerNorm (K13), codes in torch, two ``_int_mm`` with the dequant, bias
    and gelu in torch (+ x for K13)."""
    x, lnp, w = _int8_ff_case(rng, m, d, f)
    args = (x, *lnp, *w) if ln else (x, *w)
    raw = int8_ff.int8_ff_ln_raw if ln else int8_ff.int8_ff_raw
    twin = int8_ff.int8_ff_ln_reference if ln else int8_ff.int8_ff_reference
    got, want = raw(*args, save_hpre=save_hpre), twin(*args, save_hpre=save_hpre)
    again = raw(*args, save_hpre=save_hpre)
    torch.cuda.synchronize()
    name = f'K13 int8_ff_ln_raw' if ln else 'K12 int8_ff_raw'
    name += f' M={m}{"" if d == 768 else f" D={d} F={f}"}'
    name += " save_hpre" if save_hpre else ""
    pairs = zip(got, again) if save_hpre else [(got, again)]
    same = all(torch.equal(a, b) for a, b in pairs)
    del again
    checks.expect(same, f'{name}: two calls identical {same}')
    errs = []
    if save_hpre:
        errs.append(_int8_expect(checks, f'{name}: hpre', got[1], want[1]))
        got, want = got[0], want[0]
    errs.append(_int8_expect(checks, name, got, want, x if ln else None))
    check_tail(checks, name, got, want, None, x if ln else None)
    w1_q, s1, b1, w2_q, s2, b2 = w

    def library():
        y = F.layer_norm(x.float(), (d,), lnp[0], lnp[1], 1e-6) if ln else x
        q, s = k15._quantize_tile(y)
        hp = torch._int_mm(q, w1_q).float() * (s * s1) + b1
        hq, hs = k15._quantize_tile(F.gelu(hp, approximate='tanh'))
        out = torch._int_mm(hq, w2_q).float() * (hs * s2) + b2
        out = (x.float() + out if ln else out).bfloat16()
        return (out, hp.bfloat16()) if save_hpre else out

    nbytes = 2 * m * d * 2 + 2 * d * f + 4 * (3 * d + 2 * f) \
        + (2 * m * f if save_hpre else 0)
    rec = _time_int8(lambda: raw(*args, save_hpre=save_hpre),
                     lambda: twin(*args, save_hpre=save_hpre), library,
                     4 * m * d * f, nbytes, max(errs))
    print(f'  {name}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound '
          f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})', flush=True)
    return rec


def _k10_case(rng, batch, seq, dim=768, heads=12):
    x = _bf16(rng, (batch, seq, dim))
    w = lambda shape, std: (std * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).cuda()
    scale, bias = 1.0 + w((dim,), 0.1), w((dim,), 0.1)
    # wq 4x wider than lecun: a peaked softmax (as _k1_case)
    ws = [w((dim, heads, 64), 4.0 / math.sqrt(dim))] + [
        w((dim, heads, 64), 1.0 / math.sqrt(dim)) for _ in range(2)] + [
        w((heads, 64, dim), 1.0 / math.sqrt(dim))]
    codes = fused_layer._q8_weights(*ws, dim, heads * 64)
    return x, scale, bias, [t for pair in codes for t in pair]


def check_k10(rng, checks, batch, seq, dim=768, heads=12):
    """K10 vs its twin at [batch, seq, dim]; the library chain: LayerNorm,
    codes, three ``_int_mm`` with the dequant, SDPA, codes, ``_int_mm``,
    + x."""
    x, scale, bias, flat = _k10_case(rng, batch, seq, dim, heads)
    hd = heads * 64
    with torch.no_grad():
        got = fused_layer.fused_attention_q8(x, scale, bias, *flat, heads)
        want = fused_layer.fused_attention_q8_plain(x, scale, bias, *flat,
                                                    heads)
    torch.cuda.synchronize()
    err = _int8_expect(checks, f'K10 fused_attention_q8 B={batch} L={seq}',
                       got, want, x)
    wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so = flat
    m = batch * seq

    def library():
        y = F.layer_norm(x.float(), (dim,), scale, bias, 1e-6).view(m, dim)
        q, s = k15._quantize_tile(y)
        split = lambda t: t.bfloat16().view(batch, seq, heads, 64).transpose(1, 2)
        proj = lambda wc, sc: torch._int_mm(q, wc).float() * (s * sc)
        a = F.scaled_dot_product_attention(
            split(proj(wq_q, sq) * 0.125), split(proj(wk_q, sk)),
            split(proj(wv_q, sv)), scale=1.0)
        aq, a_s = k15._quantize_tile(a.transpose(1, 2).reshape(m, hd))
        out = torch._int_mm(aq, wo_q).float() * (a_s * so)
        return (x.float() + out.view(batch, seq, dim)).bfloat16()

    def kernel():
        with torch.no_grad():
            fused_layer.fused_attention_q8(x, scale, bias, *flat, heads)

    def plain():
        with torch.no_grad():
            fused_layer.fused_attention_q8_plain(x, scale, bias, *flat, heads)

    rec = _time_int8(kernel, plain, library, 2 * m * dim * 4 * hd,
                     2 * m * dim * 2 + 4 * dim * hd + (3 * hd + 3 * dim) * 4,
                     err, flops=4 * batch * heads * seq * seq * 64)
    # the C entry alone, on buffers made once (the wrapper's host work is
    # part of a bs32 call)
    vec = lambda t, n: t.reshape(n).float().contiguous()
    ws = torch.empty(fused_layer.fused_q8_plan(batch, seq, dim, heads)[
        'workspace'], dtype=torch.uint8, device='cuda')
    out = torch.empty_like(x)
    bufs = [x, scale, bias, *flat[0::2],
            *[vec(t, n) for t, n in zip(flat[1::2], (hd, hd, hd, dim))],
            ws, out]
    ptrs = [t.data_ptr() for t in bufs]
    stream, fn = fa.stream_of(x.device), fused_layer._k10_lib()
    entry = lambda: fn(*ptrs, batch, seq, dim, heads, 1, fused_layer.LN_EPS,
                       0.125, stream)
    rec['entry_ms'] = time_ms(entry)
    print(f'  K10 L={seq}: kernel {rec["ms"]:.4f} ms  C entry '
          f'{rec["entry_ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} ms  '
          f'library {rec["library_ms"]:.4f} ms  bound {rec["bound_ms"]:.4f} '
          f'ms ({rec["bound_by"]})', flush=True)
    print(f'  K10 B={batch} L={seq} launches: {launch_split(entry)}',
          flush=True)
    return rec


def check_int8_sentinels(rng, checks, m=1003, batch=3, seq=197):
    """Ragged edges on NaN-sentinel buffers 64 rows longer than the rows in
    range: K12 and K13 (with hpre) and K14 at M = 1003 (not a multiple of
    their 128-row tiles; ``check_ff_sentinels_at``), K15 at M = 1003 with a
    ragged last k-block (K = 700), K10 at B = 3, L = 197. Rows in range
    match the twins; rows past them keep the sentinel: nothing padded, no
    row dropped, none written past."""
    nan = lambda rows, w: torch.full((rows + 64, w), float('nan'),
                                     device='cuda', dtype=torch.bfloat16)
    kept = check_ff_sentinels_at(rng, checks, m, 768, 3072)
    k, n = 700, 256
    a = _bf16(rng, (m, k))
    b_q, b_s = quantize_symmetric(_bf16(rng, (k, n), 1.0 / math.sqrt(k)), 0)
    out = nan(m, n)
    # the C entry into the first M rows (it raises on a failed launch)
    k15._int8_matmul_into(a, b_q, b_s, out[:m])
    torch.cuda.synchronize()
    _int8_expect(checks, f'K15 M={m} K={k} into sentinels', out[:m],
                 k15.blockwise_int8_matmul_reference(a, b_q, b_s))
    kept.append(out[m:])
    xk, scale, bias, flat = _k10_case(rng, batch, seq)
    rows = batch * seq
    out = nan(rows, 768)
    # the C entry into the first B*L rows (it raises on a failed launch)
    fused_layer._fused_q8_into(xk, scale, bias, flat[0::2], flat[1::2], 12,
                               fused_layer.LN_EPS, True, out[:rows])
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_layer.fused_attention_q8_plain(xk, scale, bias, *flat, 12)
    _int8_expect(checks, f'K10 B={batch} L={seq} into sentinels',
                 out[:rows], want.reshape(rows, 768), xk.reshape(rows, 768))
    kept.append(out[rows:])
    untouched = all(bool(torch.isnan(t).all()) for t in kept)
    checks.expect(untouched, f'int8 kernels into sentinel buffers: rows past '
                             f'M untouched {untouched}')


# ---- int8 (slice 8): K11 (csrc/th_attention_q8.cu), K14 (csrc/int8_ff.cu)

def _k11_case(rng, batch, seq, dim, heads):
    hd = heads * th.HEAD_CH
    x = _bf16(rng, (batch, seq, dim))
    w = lambda shape, std: (std * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).cuda()
    scale, bias = 1.0 + w((dim,), 0.1), w((dim,), 0.1)
    # wq 4x wider than lecun: a peaked softmax (as _k1_case)
    ws = [w((dim, heads, th.HEAD_CH), 4.0 / math.sqrt(dim))] + [
        w((dim, heads, th.HEAD_CH), 1.0 / math.sqrt(dim)) for _ in range(2)] + [
        w((heads, th.HEAD_CH, dim), 1.0 / math.sqrt(hd))]
    codes = fused_layer._q8_weights(*ws, dim, hd)
    return x, scale, bias, [t for pair in codes for t in pair], _th_mixes(
        rng, heads)


def check_k11(rng, checks, batch, seq, dim, heads):
    """K11 vs its twin at [batch, seq, dim] (no residual, as CaiT calls
    it); the library chain: LayerNorm, codes, three ``_int_mm`` with the
    dequant, the per-op TH core in bf16, codes, ``_int_mm``."""
    x, scale, bias, flat, mixes = _k11_case(rng, batch, seq, dim, heads)
    hd = heads * th.HEAD_CH
    args = (x, scale, bias, *flat, *mixes, heads)
    with torch.no_grad():
        got, want = th.th_attention_q8(*args), th.th_q8_reference(*args)
    torch.cuda.synchronize()
    err = _int8_expect(checks, f'K11 th_attention_q8 B={batch} L={seq} '
                               f'D={dim} H={heads}', got, want)
    check_tail(checks, f'K11 B={batch} L={seq} D={dim} H={heads}', got, want,
               None)
    wq_q, sq, wk_q, sk, wv_q, sv, wo_q, so = flat
    m = batch * seq

    def library():
        y = F.layer_norm(x.float(), (dim,), scale, bias, 1e-6).view(m, dim)
        q, s = k15._quantize_tile(y)
        proj = lambda wc, sc: (torch._int_mm(q, wc).float() * (s * sc)
                               ).bfloat16().view(batch, seq, hd)
        a = _th_library(proj(wq_q, sq * (1.0 / math.sqrt(th.HEAD_CH))),
                        proj(wk_q, sk), proj(wv_q, sv), *mixes, heads)
        aq, a_s = k15._quantize_tile(a.reshape(m, hd))
        return (torch._int_mm(aq, wo_q).float() * (a_s * so)).bfloat16()

    def kernel():
        with torch.no_grad():
            th.th_attention_q8(*args)

    def plain():
        with torch.no_grad():
            th.th_q8_reference(*args)

    ops, f32_ops = _th_work(batch, seq, heads, 2, 2)
    rec = _time_int8(kernel, plain, library, 2 * m * dim * 4 * hd,
                     2 * m * dim * 2 + 4 * dim * hd + (3 * hd + 3 * dim) * 4
                     + 2 * heads * heads * 4, err, flops=ops,
                     f32_flops=f32_ops)
    # the C entry alone, on buffers made once (the wrapper's host work is
    # most of a bs32 call)
    vec = lambda t, n: t.reshape(n).float().contiguous()
    ws = torch.empty(th.th_q8_plan(batch, seq, dim, heads)['workspace'],
                     dtype=torch.uint8, device='cuda')
    out = torch.empty_like(x)
    bufs = [x, scale, bias, *flat[0::2],
            *[vec(t, n) for t, n in zip(flat[1::2], (hd, hd, hd, dim))],
            th._mix_bank(*mixes, heads, x.device), ws, out]
    ptrs = [t.data_ptr() for t in bufs]
    stream, fn = fa.stream_of(x.device), th._k11_lib()
    entry = lambda: fn(*ptrs, batch, seq, dim, heads, 0, fused_layer.LN_EPS,
                       1.0 / math.sqrt(th.HEAD_CH), stream)
    rec['entry_ms'] = time_ms(entry)
    print(f'  K11 B={batch} L={seq} D={dim} H={heads}: kernel '
          f'{rec["ms"]:.4f} ms  C entry {rec["entry_ms"]:.4f} ms  plain '
          f'{rec["plain_ms"]:.4f} ms  library {rec["library_ms"]:.4f} ms  '
          f'bound {rec["bound_ms"]:.4f} ms ({rec["bound_by"]})', flush=True)
    print(f'  K11 B={batch} L={seq} D={dim} H={heads} launches: '
          f'{launch_split(entry)}', flush=True)
    return rec


def _k14_case(rng, m, d, f):
    g = _bf16(rng, (m, d), 0.02)
    hpre = _bf16(rng, (m, f))
    w = lambda shape, std: (std * torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))).cuda()
    w1t_q, s1t = int8_ff._dx_quantized(w((d, f), 1.0 / math.sqrt(d)))
    w2t_q, s2t = int8_ff._dx_quantized(w((f, d), 1.0 / math.sqrt(f)))
    return g, hpre, (w1t_q, s1t, w2t_q, s2t)


def check_k14(rng, checks, m, d=768, f=3072):
    """K14 vs its twin at M rows, dy2 and dh; the library chain: codes of
    g, ``_int_mm`` with the dequant, torch's gelu backward, codes of dh,
    ``_int_mm`` with the dequant."""
    g, hpre, w = _k14_case(rng, m, d, f)
    got = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    again = int8_ff.int8_ff_dx_raw(g, hpre, *w)
    want = int8_ff.int8_ff_dx_reference(g, hpre, *w)
    torch.cuda.synchronize()
    name = f'K14 int8_ff_dx_raw M={m} D={d} F={f}'
    errs = [_int8_expect(checks, f'{name}: dy2', got[0], want[0]),
            _int8_expect(checks, f'{name}: dh', got[1], want[1])]
    check_tail(checks, f'{name}: dy2', got[0], want[0], None)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    checks.expect(same, f'{name}: two calls identical {same}')
    w1t_q, s1t, w2t_q, s2t = w
    w1c, w2c = w1t_q.contiguous(), w2t_q.contiguous()

    def library():
        q, s = k15._quantize_tile(g)
        dgact = torch._int_mm(q, w2c).float() * (s * s2t)
        dh = torch.ops.aten.gelu_backward(dgact, hpre.float(),
                                          approximate='tanh')
        hq, hs = k15._quantize_tile(dh)
        dy2 = torch._int_mm(hq, w1c).float() * (hs * s1t)
        return dy2.bfloat16(), dh.bfloat16()

    nbytes = 2 * m * d * 2 + 2 * m * f * 2 + 2 * d * f + 4 * (d + f)
    rec = _time_int8(lambda: int8_ff.int8_ff_dx_raw(g, hpre, *w),
                     lambda: int8_ff.int8_ff_dx_reference(g, hpre, *w),
                     library, 4 * m * d * f, nbytes, max(errs))
    print(f'  {name}: kernel {rec["ms"]:.4f} ms  plain {rec["plain_ms"]:.4f} '
          f'ms  library {rec["library_ms"]:.4f} ms  bound '
          f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})', flush=True)
    return rec


def check_slice8_sentinels(rng, checks, batch=3, seq=197):
    """Ragged edges on NaN-sentinel buffers 64 rows longer than the rows in
    range: K11 at B = 3, L = 197 and 250 (CaiT-S widths; K14's are in
    ``check_int8_sentinels``). Rows in range match the twin; rows past them
    keep the sentinel."""
    kept = check_k11_sentinels(rng, checks, batch, (seq, 250), 384, 8)
    untouched = all(bool(torch.isnan(t).all()) for t in kept)
    checks.expect(untouched, f'K11 into sentinel buffers: rows past B*L '
                             f'untouched {untouched}')


def check_ff_sentinels_at(rng, checks, m, d, f):
    """K12 and K13 (with hpre) and K14 at D, F (cait_xs's 288 and 1152: a
    32-wide last OUT and DY tile) over an odd M (not a multiple of their
    128-row tiles) into NaN-sentinel buffers 64 rows longer: rows in range
    against the twins (the last 32 columns also on their own), rows past
    them keep the sentinel. Returns the rows past M."""
    nan = lambda rows, w: torch.full((rows + 64, w), float('nan'),
                                     device='cuda', dtype=torch.bfloat16)
    x, (ls, lb), (w1_q, s1, b1, w2_q, s2, b2) = _int8_ff_case(rng, m, d, f)
    kept = []
    for ln in (0, 1):
        out, hpre = nan(m, d), nan(m, f)
        # the C entry into the first M rows (it raises on a failed launch)
        int8_ff._int8_ff_into(x, (ls, lb) if ln else None, w1_q, s1, b1,
                              w2_q, s2, b2, 1e-6, out[:m], hpre[:m])
        torch.cuda.synchronize()
        want = (int8_ff.int8_ff_ln_reference(x, ls, lb, w1_q, s1, b1, w2_q,
                                             s2, b2, save_hpre=True) if ln
                else int8_ff.int8_ff_reference(x, w1_q, s1, b1, w2_q, s2, b2,
                                               save_hpre=True))
        what = f'K13 M={m} D={d} F={f}' if ln else f'K12 M={m} D={d} F={f}'
        base = x if ln else None
        _int8_expect(checks, f'{what} into sentinels: out', out[:m], want[0],
                     base)
        check_tail(checks, f'{what} into sentinels: out', out[:m], want[0],
                   None, base)
        _int8_expect(checks, f'{what} into sentinels: hpre', hpre[:m],
                     want[1])
        kept += [out[m:], hpre[m:]]
    g, hp, (w1t_q, s1t, w2t_q, s2t) = _k14_case(rng, m, d, f)
    dy, dh = nan(m, d), nan(m, f)
    int8_ff._int8_dx_into(g, hp, w1t_q, s1t, w2t_q, s2t, dy[:m], dh[:m])
    torch.cuda.synchronize()
    want = int8_ff.int8_ff_dx_reference(g, hp, w1t_q, s1t, w2t_q, s2t)
    what = f'K14 M={m} D={d} F={f} into sentinels'
    _int8_expect(checks, f'{what}: dy2', dy[:m], want[0])
    check_tail(checks, f'{what}: dy2', dy[:m], want[0], None)
    _int8_expect(checks, f'{what}: dh', dh[:m], want[1])
    kept += [dy[m:], dh[m:]]
    return kept


def check_k11_sentinels(rng, checks, batch, seqs, dim, heads):
    """K11 at B = ``batch`` and each length of ``seqs`` into a NaN-sentinel
    buffer 64 rows longer than B*L: rows in range against the twin; returns
    the rows past them, which must keep the sentinel."""
    kept = []
    for seq_i in seqs:
        x, scale, bias, flat, mixes = _k11_case(rng, batch, seq_i, dim, heads)
        rows = batch * seq_i
        out = torch.full((rows + 64, dim), float('nan'), device='cuda',
                         dtype=torch.bfloat16)
        # the C entry into the first B*L rows (it raises on a failed launch)
        th._th_q8_into(x, scale, bias, flat[0::2], flat[1::2], *mixes, heads,
                       fused_layer.LN_EPS, False, out[:rows])
        torch.cuda.synchronize()
        with torch.no_grad():
            want = th.th_q8_reference(x, scale, bias, *flat, *mixes, heads)
        _int8_expect(checks, f'K11 B={batch} L={seq_i} D={dim} H={heads} into '
                             f'sentinels', out[:rows], want.reshape(rows, dim))
        check_tail(checks, f'K11 B={batch} L={seq_i} D={dim} H={heads} into '
                           f'sentinels', out[:rows], want.reshape(rows, dim),
                   None)
        kept.append(out[rows:])
    return kept


def check_k11_codes(rng, checks, batch, seq, dim, heads):
    """K11's core takes the bands' codes in its store (at H = 16 over two
    passes of 8 heads, the row's absmax combined first): its codes and row
    scales, read from the workspace, against the twin's quantiser
    (``_quantize_tile``) on the bands K6a's kernel computes from the same
    q, k, v (the same core without the codes): bit for bit."""
    x, scale, bias, flat, mixes = _k11_case(rng, batch, seq, dim, heads)
    hd, m = heads * th.HEAD_CH, batch * seq
    plan = th.th_q8_plan(batch, seq, dim, heads)
    ws = torch.empty(plan['workspace'], dtype=torch.uint8, device='cuda')
    vec = lambda t, n: t.reshape(n).float().contiguous()
    out = torch.empty_like(x)
    bufs = [x, scale, bias, *flat[0::2],
            *[vec(t, n) for t, n in zip(flat[1::2], (hd, hd, hd, dim))],
            th._mix_bank(*mixes, heads, x.device), ws, out]
    err = th._k11_lib()(*[t.data_ptr() for t in bufs], batch, seq, dim,
                        heads, 0, fused_layer.LN_EPS, 1.0 / th.HEAD_CH ** 0.5,
                        fa.stream_of(x.device))
    torch.cuda.synchronize()

    def region(name, dtype, shape):
        at, nbytes = plan['scratch'][name]
        return ws[at:at + nbytes].view(dtype).view(shape)

    q, k, v = (region(n, torch.bfloat16, (batch, seq, hd))
               for n in ('q', 'k', 'v'))
    attn, _ = th.th_core_fwd(q, k, v, *mixes, heads)
    codes, scales = k15._quantize_tile(attn.reshape(m, hd))
    aq, a_s = region('aq', torch.int8, (m, hd)), region('as', torch.float32,
                                                         (m,))
    same_codes = float((aq == codes).float().mean())
    same_scales = bool(torch.equal(a_s, scales.reshape(m)))
    checks.expect(err == 0 and same_codes == 1.0 and same_scales,
                  f'K11 B={batch} L={seq} D={dim} H={heads}: codes of the '
                  f'core\'s store vs the twin\'s quantiser on K6a\'s bands: '
                  f'{same_codes:.6f} identical, row scales identical '
                  f'{same_scales} (launch code {err})')


def check_quantizer(checks):
    """``q8::quantize_exact`` (K11's band codes, K15's a codes) against
    the IEEE division's codes for every bf16 value against every bf16 row
    absmax (``sav_q8_quantizer_check``); the product with the reciprocal
    alone, counted beside it, must differ somewhere, or the check did not
    reach the ties."""
    fn = _build.library('int8_matmul').sav_q8_quantizer_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    counts = torch.zeros(2, dtype=torch.int64, device='cuda')
    code = fn(counts.data_ptr(), fa.stream_of(torch.device('cuda')))
    torch.cuda.synchronize()
    exact, naive = counts.tolist()
    checks.expect(code == 0 and exact == 0 and naive > 0,
                  f'K11/K15 quantiser: {exact} codes of quantize_exact differ '
                  f'from the IEEE division over every bf16 value and row '
                  f'absmax (the reciprocal alone: {naive})')


# ---- CeiT (slice 9): K1's post-LN route (csrc/fused_attention.cu with
# pre_ln 0; check_k1_route above) and its projection GEMM at D = 192
# (csrc/proj_sm90.cuh), the widths it took before unchanged

def ptxas_of(lib: str, kernel: str, heads: int) -> str:
    """The ptxas lines (registers, spills) of each instantiation of
    ``kernel`` at ``heads`` heads (its first template argument) in
    ``lib``'s build log, one 'entry: ...' a line, joined by '; '."""
    lines = _build.build_log.get(lib, '').splitlines()
    out = []
    tag = f'ILi{heads}E'
    for i, line in enumerate(lines):
        if 'Compiling entry' in line and kernel in line and tag in line:
            entry = line.split("'")[1] if "'" in line else line
            info = [t.strip() for t in lines[i + 1:i + 4]
                    if 'spill' in t or 'registers' in t]
            out.append(f'{entry}: ' + ' '.join(info))
    return '; '.join(out)


def k1_digest_module():
    """``scripts/k1_digest.py`` of this checkout, loaded by its path."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'scripts', 'k1_digest.py')
    spec = importlib.util.spec_from_file_location('k1_digest', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_k1_bits(checks) -> None:
    """ViT-B/16's K1 outputs bit-identical to what the projection GEMM gave
    before it took D = 192 (``scripts/k1_digest.py``, which also says when
    the pin goes)."""
    mod = k1_digest_module()
    got = mod.k1_digests(fused_layer)
    for key, want in mod.K1_VITB_DIGESTS.items():
        checks.expect(got[key] == want,
                      f'K1 ViT-B/16 {key}: outputs digest {got[key]}, the '
                      f'128-multiple GEMM gave {want} (bit-identical)')


def print_profile(fn, iters: int = 5) -> None:
    """Device time by kernel over ``iters`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=15,
                                    max_name_column_width=60), flush=True)


# CvT's module kinds, by the forward ranges print_module_split opens
CVT_SPLIT = ('BatchNorm', 'depthwise conv', 'pointwise conv',
             'token-embed conv', 'LayerNorm', 'FF', 'attention block')


def _cvt_kind(name: str, module) -> str:
    if isinstance(module, BatchNorm):
        return 'BatchNorm'
    if isinstance(module, Conv):
        if module.groups > 1:
            return 'depthwise conv'
        return ('token-embed conv' if 'ConvTokenEmbedBlock' in name
                else 'pointwise conv')
    if isinstance(module, LayerNorm):
        return 'LayerNorm'
    if isinstance(module, FFBlock):
        return 'FF'
    if isinstance(module, CvTAttentionBlock):
        return 'attention block'
    return ''


def print_module_split(model, fn, iters: int = 3) -> None:
    """Device time a call of ``fn`` by the CvT module kinds whose forwards
    launched it: forward hooks open a torch.profiler range per module,
    named by its kind (``CVT_SPLIT``), which the profiler also marks on the
    card's timeline; each kernel counts for the innermost range whose span
    holds its start (the attention block's own kernels are its core, the
    output projection and their reshapes and casts). Kernels in no range
    (the backward, the optimizer, the int8 FF span, the residual adds, the
    head, serving's preprocessing) count as outside. Then every kernel by
    name: the port's own (``sav::``), convolutions, GEMMs, elementwise and
    reductions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    stack, handles = [], []

    def enter(kind):
        def hook(module, args):
            rng = record_function(kind)
            rng.__enter__()
            stack.append(rng)
        return hook

    def leave(module, args, out):
        stack.pop().__exit__(None, None, None)

    for name, module in model.named_modules():
        kind = _cvt_kind(name, module)
        if kind:
            handles += [module.register_forward_pre_hook(enter(kind)),
                        module.register_forward_hook(leave)]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for h in handles:
        h.remove()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in device
             if e.name in CVT_SPLIT]
    kernels = [e for e in device if e.name not in CVT_SPLIT
               and not e.name.startswith(('Memcpy', 'Memset'))]
    ms = dict.fromkeys(CVT_SPLIT + ('outside',), 0.0)
    for e in kernels:
        start = e.time_range.start
        inner = min((s for s in spans if s[0] <= start < s[1]),
                    key=lambda s: s[1] - s[0], default=None)
        ms[inner[2] if inner else 'outside'] += (e.time_range.elapsed_us()
                                                 / iters / 1e3)
    print(f'  device ms a call ({iters} calls, {len(spans)} module spans on '
          f'the timeline): {sum(ms.values()):.3f} in kernels; '
          + ', '.join(f'{k} {v:.3f}' for k, v in ms.items()), flush=True)
    # (kind, words of its kernel names), the first that matches wins
    rules = (('sav::', ('sav::',)),
             ('conv', ('conv', 'fprop', 'dgrad', 'wgrad', 'depthwise')),
             ('gemm', ('gemm', 'xmma', 'cutlass', 'sm90_')),
             ('elementwise', ('elementwise',)), ('reduce', ('reduce',)))
    kinds = dict.fromkeys([k for k, _ in rules] + ['other'], 0.0)
    for e in kernels:
        name = e.name.lower()
        kind = next((k for k, words in rules
                     if any(w in name for w in words)), 'other')
        kinds[kind] += e.time_range.elapsed_us() / iters / 1e3
    print('  device ms a call by kernel name: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in kinds.items()), flush=True)


# the card's augmentation against its CPU run on the same draws:
# tests/test_torch_data_augment.py's tolerance for a run whose sums are
# ordered apart (its jitted JAX): share of values within 2e-3 and mean
# difference on the 0-255 scale
AUG_SHARE, AUG_MEAN, AUG_TOL = 0.9, 0.25, 2e-3


def make_jpeg_tree(workdir: str, classes: int = 10, per_class: int = 64,
                   procs: int = 8) -> str:
    """An ImageFolder tree of ``classes`` x ``per_class`` JPEGs at 256-512
    px under ``workdir/jpegs``: ``scripts/make_jpeg_dataset.py`` run in
    ``procs`` subprocesses at once (seeds 0..procs-1), their files merged
    class by class."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'scripts', 'make_jpeg_dataset.py')
    parts = [os.path.join(workdir, f'part{k}') for k in range(procs)]
    running = [subprocess.Popen(
        [sys.executable, script, '--out', part, '--classes', str(classes),
         '--per-class', str(per_class // procs), '--seed', str(k)],
        stdout=subprocess.DEVNULL) for k, part in enumerate(parts)]
    codes = [p.wait(timeout=300) for p in running]
    if any(codes):
        raise RuntimeError(f'make_jpeg_dataset.py exited {codes}')
    root = os.path.join(workdir, 'jpegs')
    for k, part in enumerate(parts):
        for cls in sorted(os.listdir(part)):
            os.makedirs(os.path.join(root, cls), exist_ok=True)
            for fname in os.listdir(os.path.join(part, cls)):
                os.replace(os.path.join(part, cls, fname),
                           os.path.join(root, cls, f'p{k}_{fname}'))
        shutil.rmtree(part)
    return root


def tar_tree(root: str, path: str) -> str:
    with tarfile.open(path, 'w') as tar:
        for cls in sorted(os.listdir(root)):
            for fname in sorted(os.listdir(os.path.join(root, cls))):
                tar.add(os.path.join(root, cls, fname),
                        arcname=f'{cls}/{fname}')
    return path


def device_ms(fn, iters: int = 3) -> float:
    """Median device ms of ``fn``'s launches: a sleep kernel holds the
    stream while the host queues them, so the events time the card's work
    and not the host's gaps between launches."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_augment_on_card(checks, frames, labels, config, seed,
                          profile=False) -> dict:
    """One draw at the frames' batch, applied on the card and on the CPU;
    returns the card's device and host ms a batch (with ``profile``, also
    prints its device time by kernel)."""
    batch, frame = frames.shape[0], frames.shape[1]
    x_gpu, y_gpu = frames.cuda(), labels.cuda()
    draws = data_pipeline.draw(data_pipeline.step_generator(seed, 0), batch,
                               frame, config, 224, device='cuda')
    got = data_pipeline.apply(x_gpu, y_gpu, draws, config, 224)
    want = data_pipeline.apply(frames, labels,
                               data_pipeline.to_device(draws, 'cpu'),
                               config, 224)
    scale = 255.0 * torch.tensor((0.232, 0.228, 0.229))
    diff = (got['images'].cpu() - want['images']).abs() * scale
    share = float((diff <= AUG_TOL).float().mean())
    same = all(torch.equal(got[k].cpu(), want[k])
               for k in ('labels', 'mix_labels', 'ratio'))
    checks.expect(
        share >= AUG_SHARE and float(diff.mean()) <= AUG_MEAN and same
        and bool(torch.isfinite(got['images']).all()),
        f'augmentation at bs{batch} on {frame}-px frames, card vs CPU on one '
        f'draw: {share:.5f} of values within {AUG_TOL} (want >= '
        f'{AUG_SHARE}), mean difference {float(diff.mean()):.4g} (<= '
        f'{AUG_MEAN}), max {float(diff.max()):.4g} on the 0-255 scale; '
        f'labels, mix labels and ratios equal {same}')

    def augment():
        d = data_pipeline.draw(data_pipeline.step_generator(seed, 1), batch,
                               frame, config, 224, device='cuda')
        return data_pipeline.apply(x_gpu, y_gpu, d, config, 224)

    augment()                                   # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        augment()
    host = (time.perf_counter() - start) / 3 * 1e3
    torch.cuda.synchronize()
    if profile:
        print_profile(augment, iters=2)
    return {'device_ms': device_ms(augment), 'host_ms': host}


def one_step(checks, trainer, data, what) -> None:
    """One train step on ``data``'s first batch: K1-train + K2 counts and a
    finite loss."""
    batch = data.batch(0)
    _build.reset_launches()
    loss = float(trainer.train_step(batch)['loss'])
    counts = dict(_build.launches)
    checks.expect(counts == {'fused_attention_fwd_train': 12,
                             'flash_bwd_fused': 12} and math.isfinite(loss),
                  f'{what}: one step, launches {counts}, loss {loss:.5g}')


def data_phase(checks, seed: int, smi: str, workdir: str, steps: int = 10,
               profile: bool = False) -> dict:
    """Real-data training on the card (item 17 of the module docstring),
    its JPEG tree made in ``workdir/jpegs`` and left there for the import
    phase's holdout; returns the phase's numbers."""
    from sav_tpu_torch.train import steps as train_steps
    from sav_tpu_torch.train.loop import TrainConfig, Trainer

    t_phase = time.perf_counter()
    trainer = data = None
    try:
        root = make_jpeg_tree(workdir)
        tar_path = tar_tree(root, os.path.join(workdir, 'jpegs.tar'))
        n = sum(len(os.listdir(os.path.join(root, c)))
                for c in os.listdir(root))
        t_made = time.perf_counter() - t_phase
        workers = min(8, os.cpu_count() or 1)
        config = TrainConfig(model_name='vit_b_patch16', img_size=224,
                             batch_size=192, seed=seed, dtype='bfloat16',
                             num_classes=10, dataset=root,
                             holdout_fraction=0.05, data_workers=workers)
        trainer = Trainer(config, device='cuda')
        data = trainer.dataset()
        want = {'fused_attention_fwd_train': 12, 'flash_bwd_fused': 12}
        first = data.batch(0)
        _build.reset_launches()
        loss = float(trainer.train_step(first)['loss'])
        counts = dict(_build.launches)
        checks.expect(counts == want and math.isfinite(loss),
                      f'real data ViT-B/16 @224 bs192: launches per step '
                      f'{counts} (want {want}), loss {loss:.5g} finite')
        for step in (1, 2):                               # warm-up
            trainer.train_step(data.batch(step))
        torch.cuda.synchronize()
        for key in data.stats:
            data.stats[key] = 0
        _build.reset_launches()
        start = time.perf_counter()
        for step in range(3, 3 + steps):
            metrics = trainer.train_step(data.batch(step))
        loss = float(metrics['loss'])
        secs = time.perf_counter() - start
        counts = dict(_build.launches)
        timed = {k: v * steps for k, v in want.items()}
        checks.expect(counts == timed and math.isfinite(loss),
                      f'real data: {steps} timed steps launched {counts} '
                      f'(want {timed}), loss {loss:.5g} finite')
        stats = dict(data.stats)
        native_share = stats['native'] / max(stats['decoded'], 1)
        if profile:
            following = iter(range(3 + steps, 10 ** 6))
            print_profile(lambda: trainer.train_step(
                data.batch(next(following))), iters=2)

        eval_data = trainer.dataset(seed_offset=1, training=False)
        held = len(data_pipeline.split_indices(n, 0.95, 1.0))
        count, padded = 0.0, 0.0
        try:
            for step in range(eval_data.num_batches):
                batch = eval_data.batch(step)
                padded += float((batch['mask'] == 0).sum())
                out = train_steps.eval_step(trainer.state, batch,
                                            num_classes=10)
                count += float(out['eval_count'])
            ev = trainer.evaluate(eval_data)
        finally:
            eval_data.close()
        checks.expect(count == held and padded == 192 * eval_data.num_batches
                      - held and math.isfinite(ev['eval_loss']),
                      f'real data: holdout eval counted {count:.0f} of the '
                      f'{held} held-out images ({padded:.0f} padded rows '
                      f'masked), eval loss {ev["eval_loss"]:.5g}')

        frames = torch.from_numpy(np.stack(
            [data.source[i]['image'] for i in range(192)]))
        labels = torch.from_numpy(np.asarray(
            [data.source[i]['label'] for i in range(192)], np.int64))
        aug = check_augment_on_card(checks, frames, labels, data.config,
                                    seed, profile)
        data.close()

        tar_data = data_pipeline.create_dataset(
            tar_path, 192, 224, num_classes=10, seed=seed, device='cuda',
            augmentation=config.augmentation, num_workers=workers,
            split=('train', 0.0, 0.95))
        try:
            one_step(checks, trainer, tar_data,
                     'real data, the tar source (JpegTarSource)')
        finally:
            tar_data.close()
        npz_path = os.path.join(workdir, 'frames.npz')
        np.savez(npz_path, images=frames.numpy(), labels=labels.numpy())
        npz_data = data_pipeline.create_dataset(
            npz_path, 192, 224, num_classes=10, seed=seed, device='cuda',
            augmentation=config.augmentation)
        one_step(checks, trainer, npz_data, 'real data, the .npz route '
                 '(AugmentedArrayDataset, frames on the card)')
    finally:
        if data is not None:
            data.close()
        del trainer
        torch.cuda.empty_cache()
        for name in ('jpegs.tar', 'frames.npz'):
            if os.path.exists(os.path.join(workdir, name)):
                os.remove(os.path.join(workdir, name))
    record = {
        'images': n, 'made_s': t_made, 'workers': workers,
        'img_per_s': steps * 192 / secs, 'step_ms': secs / steps * 1e3,
        'wait_ms': stats['wait_s'] / steps * 1e3,
        'decode_ms': stats['decode_s'] / max(stats['batches'], 1) * 1e3,
        'native_share': native_share, 'tier': native.status(),
        'augment_device_ms': aug['device_ms'], 'augment_host_ms': aug['host_ms'],
    }
    print(f'  {smi}: real data ViT-B/16 @224 bs192 on {n} JPEGs ({workers} '
          f'workers): {record["img_per_s"]:.1f} train img/s, '
          f'{record["step_ms"]:.2f} ms a step (wall), host wait for the '
          f'next batch {record["wait_ms"]:.2f} ms a step; augmentation '
          f'{record["augment_device_ms"]:.2f} device ms and '
          f'{record["augment_host_ms"]:.2f} host ms a batch; decode '
          f'{record["decode_ms"]:.1f} ms a batch (summed over its records, '
          f'in the workers); decode tier {record["tier"]} '
          f'({100 * native_share:.1f}% of records native)', flush=True)
    print(f'  the data phase took {time.perf_counter() - t_phase:.1f} s '
          f'(the JPEGs made in {t_made:.1f} s)', flush=True)
    print('  data: ' + json.dumps(record), flush=True)
    return record


class StepLog(MetricLogger):
    """The Trainer's logger, keeping each logged row instead of printing."""

    def __init__(self):
        super().__init__()
        self.rows = {}

    def log(self, metrics, step):
        self.rows.setdefault(step, {}).update(metrics)


def state_mismatches(a, b) -> list:
    """The leaves of two TrainStates that differ in any bit (on the card):
    parameters and running statistics, the EMA, both Adam moments, count
    and step."""
    bad = []
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    bad += [f'ema/{k}' for k in a.ema_params
            if not torch.equal(a.ema_params[k], b.ema_params[k])]
    pb = dict(b.model.named_parameters())
    for name, p in a.model.named_parameters():
        for key in ('mu', 'nu'):
            if not torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[pb[name]][key]):
                bad.append(f'{key}/{name}')
    if (a.optimizer.count, a.step) != (b.optimizer.count, b.step):
        bad.append(f'count/step {a.optimizer.count}/{a.step} vs '
                   f'{b.optimizer.count}/{b.step}')
    return bad


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def checkpoint_phase(checks, seed: int, smi: str) -> dict:
    """Resume, fine-tuning and scoring on the card (item 18 of the module
    docstring); returns the phase's numbers."""
    import contextlib
    import io

    from sav_tpu_torch import evaluate as evaluate_cli
    from sav_tpu_torch import predict as predict_cli
    from sav_tpu_torch.train import finetune
    from sav_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix='sav_ckpt_')
    want_step = {'fused_attention_fwd_train': 12, 'flash_bwd_fused': 12}
    try:
        def pretrain(directory, total):
            """ViT-B/16 @224 bs192 with an EMA, a checkpoint every 2 steps
            (an epoch of one step)."""
            trainer = Trainer(TrainConfig(
                model_name='vit_b_patch16', img_size=224, batch_size=192,
                seed=seed, dtype='bfloat16', total_steps=total,
                images_per_epoch=192, checkpoint_every_epochs=2,
                eval_every_epochs=10**6, eval_batches=1, log_every=1,
                ema_decay=0.999, checkpoint_dir=directory), device='cuda')
            trainer.logger = StepLog()
            return trainer

        # (a) 4 steps straight; 2 steps, then a new Trainer on the same -c
        # that restores step 2 and runs 2 more
        resume_dir = os.path.join(workdir, 'pretrain')
        straight = pretrain(None, 4)
        straight.run()
        first = pretrain(resume_dir, 2)
        first.run()
        del first
        resumed = pretrain(resume_dir, 4)
        checks.expect(resumed.state.step == 2,
                      f'resume: the new Trainer restored step '
                      f'{resumed.state.step} (want 2)')
        _build.reset_launches()
        resumed.run()
        counts = dict(_build.launches)
        want = {k: 2 * v for k, v in want_step.items()}
        want['fused_attention_fwd'] = 12            # the one eval batch
        checks.expect(counts == want,
                      f'resume: 2 resumed steps and one eval batch launched '
                      f'{counts} (want {want}: 12 K1-train + 12 K2 a step)')
        losses = {k: (straight.logger.rows[k]['loss'],
                      resumed.logger.rows[k]['loss']) for k in (2, 3)}
        bad = state_mismatches(resumed.state, straight.state)
        checks.expect(all(a == b for a, b in losses.values()) and not bad,
                      f'resume: losses of steps 3-4 {losses} bit-equal, and '
                      f'every parameter, both moments, the EMA and count bit '
                      f'for bit ({len(bad)} leaves differ: {bad[:3]})')
        checks.expect(CheckpointManager(resume_dir).steps() == [2, 4],
                      f'resume: steps {CheckpointManager(resume_dir).steps()} '
                      'in the directory (want [2, 4])')

        timed = CheckpointManager(os.path.join(workdir, 'timed'))
        torch.cuda.synchronize()
        start = time.perf_counter()
        timed.save(resumed.state.step, resumed.state)
        saved = time.perf_counter()
        timed.wait()
        written = time.perf_counter()
        nbytes = dir_bytes(os.path.join(workdir, 'timed'))
        start_restore = time.perf_counter()
        timed.restore(resumed.state)
        torch.cuda.synchronize()
        restored = time.perf_counter()
        timed.close()
        shutil.rmtree(os.path.join(workdir, 'timed'))
        bad = state_mismatches(resumed.state, straight.state)
        checks.expect(not bad, f'checkpoint save and restore of the step-4 '
                               f'state: {len(bad)} leaves differ {bad[:3]}')
        pos = resumed.model.Encoder_0.AddAbsPosEmbed_0.pos_embed.detach()
        pos = pos.float().cpu().numpy()
        del straight, resumed
        torch.cuda.empty_cache()

        # (b) fine-tune @384 bs48, 10-way, from the pretraining directory
        ft_dir = os.path.join(workdir, 'finetune')
        ft = Trainer(TrainConfig(
            model_name='vit_b_patch16', img_size=384, batch_size=48,
            seed=seed, dtype='bfloat16', num_classes=10,
            finetune_from=resume_dir, total_steps=6,
            eval_every_epochs=10**6, eval_batches=1, log_every=1,
            ema_decay=0.999, checkpoint_dir=ft_dir), device='cuda')
        ft.logger = StepLog()
        got = ft.model.Encoder_0.AddAbsPosEmbed_0.pos_embed.detach()
        want_pos = finetune.interpolate_pos_embed(pos, got.shape[1])
        err = float(np.abs(got.float().cpu().numpy() - want_pos).max())
        head = ft.model.Dense_0
        zero = not (bool(head.kernel.any()) or bool(head.bias.any()))
        checks.expect(tuple(got.shape) == (1, 577, 768) and err <= 1e-6
                      and zero and ft.state.step == 0,
                      f'fine-tune: pos-embed 197 -> {got.shape[1]} tokens, '
                      f'{err:.3g} from interpolate_pos_embed on the CPU '
                      f'(<= 1e-6), head zero {zero}, step {ft.state.step}')
        want_ft = {'fused_attention_fwd_train': 12, 'flash_bwd_dq': 12,
                   'flash_bwd_dkv': 12}
        _build.reset_launches()
        loss = float(ft.train_step(ft.dataset().batch(0))['loss'])
        counts = dict(_build.launches)
        checks.expect(counts == want_ft and math.isfinite(loss),
                      f'fine-tune @384 bs48: one step launched {counts} '
                      f'(want {want_ft}), loss {loss:.5g} finite')
        ft.run()                # steps 1-5, then its checkpoint at step 6
        rates = [ft.logger.rows[k]['images_per_sec'] for k in range(2, 6)]
        del ft
        torch.cuda.empty_cache()

        # (c) score the fine-tuned checkpoint @384 on a JPEG folder's
        # 25% holdout (40 of 160 images: two batches of 32, one padded;
        # decoded in this process, as 40 images do not repay starting the
        # loader's workers), then predict with --ema from the same
        # directory
        root = make_jpeg_tree(workdir, classes=10, per_class=16)
        held = len(data_pipeline.split_indices(160, 0.75, 1.0))
        _build.reset_launches()
        metrics = evaluate_cli.run_eval(
            'vit_b_patch16', ft_dir, root, img_size=384, batch_size=32,
            num_classes=10, holdout_fraction=0.25, seed=seed, device='cuda')
        counts = dict(_build.launches)
        checks.expect(
            counts == {'fused_attention_fwd': 24} and metrics['eval_images']
            == held and metrics['eval_step'] == 6
            and all(math.isfinite(metrics[k]) for k in (
                'eval_loss', 'eval_top_1_acc', 'eval_top_5_acc')),
            f'evaluate @384: {metrics["eval_images"]:.0f} of the {held} '
            f'held-out images scored at step {metrics["eval_step"]}, '
            f'launches {counts} (12 K1 a forward, 2 forwards), eval loss '
            f'{metrics["eval_loss"]:.5g}')
        images = os.path.join(root, sorted(os.listdir(root))[0])
        out, err_text = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                err_text):
            predict_cli.main(['-m', 'vit_b_patch16', '-c', ft_dir, '--images',
                              images, '-s', '384', '--num_classes', '10',
                              '--ema'])
        rows = [json.loads(line) for line in out.getvalue().splitlines()]
        n_images = len(os.listdir(images))
        checks.expect(len(rows) == n_images and 'EMA params' in
                      err_text.getvalue() and 'step 6' in err_text.getvalue()
                      and all(math.isfinite(c['prob']) for r in rows
                              for c in r['top_k']),
                      f'predict --ema @384: {len(rows)} of {n_images} images, '
                      f'{err_text.getvalue().splitlines()[0]}')
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = {
        'save_ms': (saved - start) * 1e3, 'write_ms': (written - start) * 1e3,
        'restore_ms': (restored - start_restore) * 1e3,
        'checkpoint_bytes': nbytes,
        'finetune_img_per_s': float(np.median(rates)),
        'eval_img_per_s': metrics['images_per_sec'],
    }
    print(f'  {smi}: checkpoint of ViT-B/16 @224 (params, EMA, both '
          f'moments) {nbytes / 2 ** 20:.1f} MiB: save returned in '
          f'{record["save_ms"]:.1f} ms (host copies), written in '
          f'{record["write_ms"]:.1f} ms, restored in '
          f'{record["restore_ms"]:.1f} ms; fine-tune @384 bs48 '
          f'{record["finetune_img_per_s"]:.1f} train img/s (median of steps '
          f'3-6, wall); evaluate @384 {record["eval_img_per_s"]:.1f} img/s '
          f'(JPEG decode included)', flush=True)
    print(f'  the checkpoint phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    print('  checkpoint: ' + json.dumps(record), flush=True)
    return record


# ViT-B/16's widths, which phase 19 writes its checkpoints at
VIT_B = dict(dim=768, heads=12, hidden=3072, patch=16, tokens=197)


def vit_b_hf_state(seed: int, layers: int = 12, classes: int = 1000) -> dict:
    """A ``ViTForImageClassification`` state dict (HF's names and layouts,
    numpy f32) at ViT-B/16 width from seeded draws: matrices N(0, 1/fan_in),
    biases N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2), the cls token and
    position embedding N(0, 0.02^2). No leaf is zero, so a dropped or
    swapped one shows in the logits."""
    rng = np.random.default_rng(seed)
    d, f, p = VIT_B['dim'], VIT_B['hidden'], VIT_B['patch']

    def n(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    e = 'vit.embeddings.'
    sd = {e + 'cls_token': n(1, 1, d, std=0.02),
          e + 'position_embeddings': n(1, VIT_B['tokens'], d, std=0.02),
          e + 'patch_embeddings.projection.weight': n(d, 3, p, p,
                                                      std=(3 * p * p) ** -0.5),
          e + 'patch_embeddings.projection.bias': n(d, std=0.1),
          'vit.layernorm.weight': 1 + n(d, std=0.1),
          'vit.layernorm.bias': n(d, std=0.1),
          'classifier.weight': n(classes, d, std=d ** -0.5),
          'classifier.bias': n(classes, std=0.1)}
    for i in range(layers):
        b = f'vit.encoder.layer.{i}.'
        for ln in ('layernorm_before', 'layernorm_after'):
            sd[b + ln + '.weight'] = 1 + n(d, std=0.1)
            sd[b + ln + '.bias'] = n(d, std=0.1)
        for name, (out, fan) in (('attention.attention.query', (d, d)),
                                 ('attention.attention.key', (d, d)),
                                 ('attention.attention.value', (d, d)),
                                 ('attention.output.dense', (d, d)),
                                 ('intermediate.dense', (f, d)),
                                 ('output.dense', (d, f))):
            sd[b + name + '.weight'] = n(out, fan, std=fan ** -0.5)
            sd[b + name + '.bias'] = n(out, std=0.1)
    return sd


def write_hf_dir(path: str, state: dict, architecture: str, layers: int,
                 shards: int = 1) -> str:
    """A ``save_pretrained``-style directory: ``config.json`` (ViT-B/16's
    fields, erf gelu) and the weights in safetensors, one file or
    ``shards`` files and their index."""
    from sav_tpu_torch.utils import safetensors
    os.makedirs(path, exist_ok=True)
    config = {'architectures': [architecture], 'model_type': 'vit',
              'hidden_size': VIT_B['dim'], 'num_hidden_layers': layers,
              'num_attention_heads': VIT_B['heads'],
              'intermediate_size': VIT_B['hidden'], 'hidden_act': 'gelu',
              'patch_size': VIT_B['patch'], 'image_size': 224,
              'num_channels': 3, 'qkv_bias': True, 'layer_norm_eps': 1e-12}
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(config, f, indent=1)
    if shards == 1:
        safetensors.save_file(state, os.path.join(path, 'model.safetensors'),
                              metadata={'format': 'pt'})
    else:
        safetensors.save_sharded(state, path, shards)
    return path


def timm_state(hf: dict, layers: int) -> dict:
    """The first ``layers`` blocks of an HF state dict in timm's layout
    (q, k and v fused row-wise into ``qkv``), as torch tensors."""
    t = {'cls_token': hf['vit.embeddings.cls_token'],
         'pos_embed': hf['vit.embeddings.position_embeddings'],
         'patch_embed.proj.weight':
             hf['vit.embeddings.patch_embeddings.projection.weight'],
         'patch_embed.proj.bias':
             hf['vit.embeddings.patch_embeddings.projection.bias'],
         'norm.weight': hf['vit.layernorm.weight'],
         'norm.bias': hf['vit.layernorm.bias'],
         'head.weight': hf['classifier.weight'],
         'head.bias': hf['classifier.bias']}
    for i in range(layers):
        b, o = f'vit.encoder.layer.{i}.', f'blocks.{i}.'
        qkv = [b + f'attention.attention.{w}' for w in ('query', 'key',
                                                         'value')]
        t.update({
            o + 'norm1.weight': hf[b + 'layernorm_before.weight'],
            o + 'norm1.bias': hf[b + 'layernorm_before.bias'],
            o + 'attn.qkv.weight': np.concatenate(
                [hf[k + '.weight'] for k in qkv]),
            o + 'attn.qkv.bias': np.concatenate([hf[k + '.bias'] for k in qkv]),
            o + 'attn.proj.weight': hf[b + 'attention.output.dense.weight'],
            o + 'attn.proj.bias': hf[b + 'attention.output.dense.bias'],
            o + 'norm2.weight': hf[b + 'layernorm_after.weight'],
            o + 'norm2.bias': hf[b + 'layernorm_after.bias'],
            o + 'mlp.fc1.weight': hf[b + 'intermediate.dense.weight'],
            o + 'mlp.fc1.bias': hf[b + 'intermediate.dense.bias'],
            o + 'mlp.fc2.weight': hf[b + 'output.dense.weight'],
            o + 'mlp.fc2.bias': hf[b + 'output.dense.bias']})
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t.items()}


def augreg_npz(hf: dict, layers: int) -> dict:
    """The first ``layers`` blocks of an HF state dict in the flat
    ``vision_transformer`` (AugReg) npz layout: flax-native kernels."""
    d, h = VIT_B['dim'], VIT_B['heads']
    head = d // h
    z = {'embedding/kernel': hf['vit.embeddings.patch_embeddings.projection'
                                '.weight'].transpose(2, 3, 1, 0),
         'embedding/bias': hf['vit.embeddings.patch_embeddings.projection.bias'],
         'cls': hf['vit.embeddings.cls_token'],
         'Transformer/posembed_input/pos_embedding':
             hf['vit.embeddings.position_embeddings'],
         'Transformer/encoder_norm/scale': hf['vit.layernorm.weight'],
         'Transformer/encoder_norm/bias': hf['vit.layernorm.bias'],
         'head/kernel': hf['classifier.weight'].T,
         'head/bias': hf['classifier.bias']}
    for i in range(layers):
        b = f'vit.encoder.layer.{i}.'
        o = f'Transformer/encoderblock_{i}/'
        a = o + 'MultiHeadDotProductAttention_1/'
        for ours, theirs in (('LayerNorm_0', 'layernorm_before'),
                             ('LayerNorm_2', 'layernorm_after')):
            z[o + ours + '/scale'] = hf[b + theirs + '.weight']
            z[o + ours + '/bias'] = hf[b + theirs + '.bias']
        for w in ('query', 'key', 'value'):
            z[a + w + '/kernel'] = hf[b + f'attention.attention.{w}.weight'
                                      ].T.reshape(d, h, head)
            z[a + w + '/bias'] = hf[b + f'attention.attention.{w}.bias'
                                    ].reshape(h, head)
        z[a + 'out/kernel'] = hf[b + 'attention.output.dense.weight'
                                 ].T.reshape(h, head, d)
        z[a + 'out/bias'] = hf[b + 'attention.output.dense.bias']
        for k, theirs in ((0, 'intermediate.dense'), (1, 'output.dense')):
            z[o + f'MlpBlock_3/Dense_{k}/kernel'] = hf[b + theirs + '.weight'].T
            z[o + f'MlpBlock_3/Dense_{k}/bias'] = hf[b + theirs + '.bias']
    return z


def import_phase(checks, seed: int, smi: str, jpeg_root: str,
                 profile: bool = False) -> dict:
    """Public checkpoints imported and used on the card (item 19 of the
    module docstring); with ``profile``, device time by kernel of a serving
    batch and of two fine-tune steps after the run. Returns the phase's
    numbers."""
    import contextlib
    import io

    from sav_tpu_torch import evaluate as evaluate_cli
    from sav_tpu_torch import import_checkpoint
    from sav_tpu_torch.predict import restore_weights
    from sav_tpu_torch.train import finetune
    from sav_tpu_torch.train.checkpoint import CheckpointManager
    from sav_tpu_torch.utils.flax_bridge import flatten_tree

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix='sav_import_')
    try:
        # (a)-(d): the sources, written from one seeded ViT-B/16 draw
        hf = vit_b_hf_state(seed)
        src = {
            'a': write_hf_dir(os.path.join(workdir, 'hf_cls'), hf,
                              'ViTForImageClassification', 12),
            'b': write_hf_dir(os.path.join(workdir, 'hf_trunk'),
                              {k[len('vit.'):]: v for k, v in hf.items()
                               if k.startswith('vit.')}, 'ViTModel', 12,
                              shards=3),
            'c': os.path.join(workdir, 'deit.pth'),
            'd': os.path.join(workdir, 'augreg.npz'),
        }
        torch.save({'model': timm_state(hf, 2)}, src['c'])
        np.savez(src['d'], **augreg_npz(hf, 2))
        del hf
        out = {k: os.path.join(workdir, f'out_{k}') for k in src}
        t_import = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            import_checkpoint.main(['hf', src['a'], out['a']])
            import_checkpoint.main(['hf', src['b'], out['b'],
                                    '--num-classes', '10'])
            import_checkpoint.main(['timm', src['c'], out['c']])
            import_checkpoint.main(['npz', src['d'], out['d']])
        import_s = time.perf_counter() - t_import

        def tree(key):
            manager = CheckpointManager(out[key])
            try:
                return flatten_tree(manager.restore_for_inference()['params'])
            finally:
                manager.close()

        ta = tree('a')
        for key, what in (('c', 'timm .pth'), ('d', 'AugReg .npz')):
            other = tree(key)
            bad = [k for k in other if k not in ta
                   or not np.array_equal(other[k], ta[k])]
            checks.expect(len(other) == 7 + 2 * 16 and not bad,
                          f'import: the {what} at depth 2 gives {len(other)} '
                          f'leaves, each bit for bit the HF checkpoint\'s '
                          f'({len(bad)} differ: {bad[:3]})')
        tb = tree('b')
        bad = [k for k in ta if not k.startswith('Dense_0/')
               and not np.array_equal(ta[k], tb[k])]
        checks.expect(sorted(tb) == sorted(ta) and not bad
                      and tb['Dense_0/kernel'].shape == (768, 10)
                      and not tb['Dense_0/kernel'].any(),
                      f'import: the headless ViTModel (3 safetensors shards) '
                      f'gives the trunk of the classifier checkpoint bit for '
                      f'bit ({len(bad)} leaves differ) and a zero 10-way head')
        spec = json.load(open(os.path.join(out['a'], 'model.json')))
        checks.expect(spec == {'model': 'vit', 'kwargs': {
            'num_classes': 1000, 'num_layers': 12, 'num_heads': 12,
            'embed_dim': 768, 'patch_shape': [16, 16], 'expand_ratio': 4.0,
            'attn_bias': True, 'activation': 'gelu_exact'}},
                      f'import: model.json {spec}')
        pos_b = tb['Encoder_0/AddAbsPosEmbed_0/pos_embed']
        del ta, tb

        # serve (a) @224 bs32 as predict does: the spec, the restore, serve
        batch = 32
        model = create_model(out['a'], dtype=torch.bfloat16, img_size=224,
                             device='cuda')
        with contextlib.redirect_stderr(io.StringIO()):
            restore_weights(model, out['a'], out['a'], 224, True)
        model.eval()
        frames = np.random.RandomState(seed).randint(
            0, 256, (batch, 256, 256, 3), dtype=np.uint8)
        _build.reset_launches()
        probs, idx = serve(model, frames, 224, 5)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        want = {'flash_fwd': 12}
        checks.expect(counts == want and tuple(idx.shape) == (batch, 5)
                      and bool(torch.isfinite(probs).all()),
                      f'imported ViT-B/16 @224 bs{batch}: launches per '
                      f'forward {counts} (want {want}: per-op attention on K4, '
                      f'no K1), top-5 finite')
        serve_counts = counts
        with torch.inference_mode():
            x = eval_preprocess(torch.from_numpy(frames).cuda().float(),
                                224).bfloat16()
            logits = model(x).float()
            set_use_kernel(model, False)
            plain = model(x).float()
            set_use_kernel(model, 'auto')
        err = _rel(logits, plain)
        checks.expect(tuple(logits.shape) == (batch, 1000)
                      and bool(torch.isfinite(logits).all())
                      and err <= LOGIT_TOL,
                      f'imported ViT-B/16 @224: logits vs use_kernel=False: '
                      f'max err {err:.3g} of max|logit| (tol {LOGIT_TOL}), '
                      f'top-1 agreement '
                      f'{(logits.argmax(-1) == plain.argmax(-1)).float().mean().item():.3f}')
        iters = 10
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            serve(model, frames, 224, 5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) / iters * 1e3
        dev_ms = device_ms(lambda: serve(model, frames, 224, 5))
        serve_rec = {'img_per_s': batch / wall_ms * 1e3, 'wall_ms': wall_ms,
                     'device_ms': dev_ms, 'idle': 1 - dev_ms / wall_ms}
        print(f'  imported ViT-B/16 @224 bs{batch}: '
              f'{serve_rec["img_per_s"]:.1f} img/s, {wall_ms:.2f} ms a batch '
              f'(wall), {dev_ms:.3f} device ms a batch, idle '
              f'{100 * serve_rec["idle"]:.1f}%', flush=True)
        if profile:
            print_profile(lambda: serve(model, frames, 224, 5))
        del model, logits, plain, x
        torch.cuda.empty_cache()

        # fine-tune (b) @384 bs48 10-way through the Trainer
        ft_dir = os.path.join(workdir, 'finetune')
        ft = Trainer(TrainConfig(
            model_name=out['b'], img_size=384, batch_size=48, seed=seed,
            dtype='bfloat16', num_classes=10, finetune_from=out['b'],
            total_steps=6, eval_every_epochs=10**6, eval_batches=1,
            log_every=1, checkpoint_dir=ft_dir), device='cuda')
        ft.logger = StepLog()
        got = ft.model.Encoder_0.AddAbsPosEmbed_0.pos_embed.detach()
        want_pos = finetune.interpolate_pos_embed(pos_b, got.shape[1])
        perr = float(np.abs(got.float().cpu().numpy() - want_pos).max())
        checks.expect(tuple(got.shape) == (1, 577, 768) and perr <= 1e-6
                      and ft.state.step == 0,
                      f'imported fine-tune: pos-embed 197 -> {got.shape[1]} '
                      f'tokens, {perr:.3g} from interpolate_pos_embed on the '
                      f'CPU (<= 1e-6), step {ft.state.step}')
        data = ft.dataset()
        first = data.batch(0)
        want_ft = {'flash_fwd': 12, 'flash_bwd_dq': 12, 'flash_bwd_dkv': 12}
        _build.reset_launches()
        loss = float(ft.train_step(first)['loss'])
        torch.cuda.synchronize()
        ft_counts = dict(_build.launches)
        checks.expect(ft_counts == want_ft and math.isfinite(loss),
                      f'imported fine-tune @384 bs48: one step launched '
                      f'{ft_counts} (want {want_ft}), loss {loss:.5g} finite')
        check_grads(checks, 'imported fine-tune @384 bs48', ft.model, first,
                    seed, out['b'], 384, VIT_PLAIN, 'auto', num_classes=10)
        ft.run()                # steps 1-5, then its checkpoint at step 6
        rates = [ft.logger.rows[k]['images_per_sec'] for k in range(2, 6)]
        if profile:             # after the run: its checkpoint is written
            print_profile(lambda: ft.train_step(first), iters=2)
        del ft, data, first
        torch.cuda.empty_cache()

        # score the fine-tuned checkpoint @384 on the real-data phase's
        # JPEG holdout (its 5%, as that Trainer held it out)
        n = sum(len(os.listdir(os.path.join(jpeg_root, c)))
                for c in os.listdir(jpeg_root))
        held = len(data_pipeline.split_indices(n, 0.95, 1.0))
        _build.reset_launches()
        with contextlib.redirect_stderr(io.StringIO()):
            metrics = evaluate_cli.run_eval(
                os.path.join(out['b'], 'model.json'), ft_dir, jpeg_root,
                img_size=384, batch_size=32, holdout_fraction=0.05, seed=seed,
                device='cuda')
        counts = dict(_build.launches)
        forwards = -(-held // 32)
        checks.expect(
            counts == {'flash_fwd': 12 * forwards}
            and metrics['eval_images'] == held and metrics['eval_step'] == 6
            and all(math.isfinite(metrics[k]) for k in (
                'eval_loss', 'eval_top_1_acc', 'eval_top_5_acc')),
            f'imported evaluate @384: {metrics["eval_images"]:.0f} of the '
            f'{held} held-out images scored at step {metrics["eval_step"]}, '
            f'launches {counts} (12 K4 a forward, {forwards} forwards), '
            f'eval loss {metrics["eval_loss"]:.5g}')
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = {
        'import_s': import_s, 'serve_img_per_s': serve_rec['img_per_s'],
        'serve_wall_ms': serve_rec['wall_ms'],
        'serve_device_ms': serve_rec['device_ms'],
        'serve_idle': serve_rec['idle'],
        'finetune_img_per_s': float(np.median(rates)),
        'eval_img_per_s': metrics['images_per_sec'],
        'serve_launches': serve_counts.get('flash_fwd', 0),
        'finetune_launches': ft_counts,
    }
    print(f'  {smi}: imported ViT-B/16 (four sources written and imported in '
          f'{import_s:.1f} s): serving @224 bs32 {record["serve_img_per_s"]:.1f} '
          f'img/s, {record["serve_device_ms"]:.3f} device ms of '
          f'{record["serve_wall_ms"]:.2f} wall ms a batch (idle '
          f'{100 * record["serve_idle"]:.1f}%); fine-tune @384 bs48 '
          f'{record["finetune_img_per_s"]:.1f} train img/s (median of steps '
          f'3-6, wall); evaluate @384 {record["eval_img_per_s"]:.1f} img/s '
          f'(JPEG decode included)', flush=True)
    print(f'  the import phase took {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    print('  import: ' + json.dumps(record), flush=True)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--profile', action='store_true',
                        help='also print device time by kernel of each serve '
                             'and of the @224 train steps, CaiT @384 and the '
                             'imported ViT-B/16')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    secs = _build.build_all()
    print(f'kernels built in {secs:.1f} s', flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)
    # the wgmma kernels (K4 and K1's attention, K1's and K5a's projection
    # GEMM (proj_gemm_kernel), K2, K3, K5b/K6b, K6a (also K5a's core), K16,
    # K8a, K8b, K12, K13 and K14 (ff_gemm_kernel, dx_gemm_kernel), K10, K11
    # and K15 (q8_gemm_kernel; K10's core k10_core_kernel, K11's
    # th_fwd_sm90_kernel<H, true>), K9b (bot_bwd_dq_kernel,
    # bot_bwd_dkv_kernel); their files' mma.sync kernels beside them, K7a,
    # K7b and K9a among them):
    # each kernel's registers, spills and any wgmma warning (C7510-C7515:
    # serialized)
    for lib, label in (('flash_fwd', 'K4'), ('fused_attention', 'K1'),
                       ('flash_bwd', 'K2'),
                       ('flash_bwd_split', 'K3'), ('th_bwd', 'K5b/K6b'),
                       ('th_attention', 'K5a/K6a'), ('ff_bwd', 'K16'),
                       ('mixer_token', 'K8a/K8b'), ('tnt_inner', 'K7a/K7b'),
                       ('int8_ff', 'K12/K13/K14'), ('th_attention_q8', 'K11'),
                       ('int8_matmul', 'K15'), ('fused_attention_q8', 'K10'),
                       ('botnet_attention', 'K9a/K9b')):
        for line in _build.build_log.get(lib, '').splitlines():
            if any(w in line for w in ('entry function', 'registers', 'spill',
                                       'wgmma', 'arning')):
                print(f'  {label} ptxas: {line.strip()}', flush=True)

    checks = Checks()
    rng = np.random.RandomState(args.seed)
    k1 = {seq: check_k1(rng, checks, args.batch, seq) for seq in (197, 577)}
    k4 = {seq: check_k4(rng, checks, args.batch, seq) for seq in (197, 577, 200)}
    k4_train = check_k4(rng, checks, 192, 197)      # fused_ff's attention
    # the training path's shapes: @224 bs192 (L=197), @384 bs48 (L=577)
    k1t = {seq: check_k1_train(rng, checks, b, seq)
           for b, seq in ((192, 197), (48, 577))}
    bwd197 = check_bwd(rng, checks, 192, 197, routes=('fused', 'split'))
    bwd200 = check_bwd(rng, checks, 192, 200, kv_len=190,
                       routes=('fused', 'split'))
    bwd577 = check_bwd(rng, checks, 48, 577, routes=('split',))
    check_flash_sentinels(rng, checks)

    k1_serve = serve_path(checks, 'ViT-B/16 @224 auto', 224, 'auto',
                             {'fused_attention_fwd': 12}, args.seed,
                             args.batch, args.profile)
    k4_serve = serve_path(checks, 'ViT-B/16 @384 fused_layer', 384,
                             'fused_layer', {'flash_fwd': 12}, args.seed,
                             args.batch, args.profile)
    serve_path(checks, 'ViT-B/16 @384 auto', 384, 'auto',
               {'fused_attention_fwd': 12}, args.seed, args.batch,
               args.profile)
    t224 = train_path(checks, 'train ViT-B/16 @224 bs192', 224, 192,
                      {'fused_attention_fwd_train': 12, 'flash_bwd_fused': 12},
                      args.seed, profile=args.profile)
    t384 = train_path(checks, 'train ViT-B/16 @384 bs48', 384, 48,
                      {'fused_attention_fwd_train': 12, 'flash_bwd_dq': 12,
                       'flash_bwd_dkv': 12}, args.seed)

    # CaiT-S/24: the TH kernels at the path's shapes, then the paths
    k5a = {train: check_k5a(rng, checks, 128 if train else args.batch, 196,
                            save_residuals=train) for train in (False, True)}
    # K5a at CaiT-S/24 @384's shapes (serving B=32, training B=48, L=576)
    k5a384 = {train: check_k5a(rng, checks, 48 if train else args.batch, 576,
                               save_residuals=train)
              for train in (False, True)}
    k5b = check_th_bwd(rng, checks, 128, 196, 'th_attention_bwd')
    # K5a at cait_xxs_24 @224's (D = 192, H = 4: one 192-wide GEMM tile)
    k5a_xxs = {train: check_k5a(rng, checks, 128 if train else args.batch,
                                196, save_residuals=train, dim=192, heads=4)
               for train in (False, True)}
    # K6a and K6b, the blocked route's entries (K5a's core and K5b's
    # launches), at cait_xxs's heads and at L = 576
    k6a = {train: check_k6a(rng, checks, 128 if train else args.batch, 196,
                            heads=4) for train in (False, True)}
    k6a576 = {train: check_k6a(rng, checks, 48 if train else args.batch, 576)
              for train in (False, True)}
    k6b = check_th_bwd(rng, checks, 128, 196, 'th_core_bwd', heads=4)
    k6b576 = check_th_bwd(rng, checks, 48, 576, 'th_core_bwd')
    # cait_xxs's four heads through both backward entries
    check_th_bwd(rng, checks, 8, 577, 'th_core_bwd', heads=4, timed=False)
    k5b_xxs = check_th_bwd(rng, checks, 128, 196, 'th_attention_bwd',
                           heads=4)
    for seq in (196, 197, 576, 577):
        check_th_tails(rng, checks, seq)
    k5a_serve = serve_path(checks, 'CaiT-S/24 @224 auto', 224, 'auto',
                              {'th_attention_fwd': 24}, args.seed, args.batch,
                              args.profile, model_name='cait_s_24')
    k5a_serve384 = serve_path(checks, 'CaiT-S/24 @384 auto', 384, 'auto',
                              {'th_attention_fwd': 24}, args.seed, args.batch,
                              args.profile, model_name='cait_s_24')
    xxs_serve = serve_path(checks, 'cait_xxs_24 @224 auto', 224, 'auto',
                           {'th_attention_fwd': 24}, args.seed, args.batch,
                           args.profile, model_name='cait_xxs_24')
    c224 = train_path(checks, 'train CaiT-S/24 @224 bs128', 224, 128,
                      {'th_attention_fwd_train': 24, 'th_attention_bwd': 24},
                      args.seed, profile=args.profile, model_name='cait_s_24',
                      plain_core='fused_th_xla')
    c384 = train_path(checks, 'train CaiT-S/24 @384 bs48', 384, 48,
                      {'th_attention_fwd_train': 24, 'th_attention_bwd': 24},
                      args.seed, profile=args.profile, model_name='cait_s_24',
                      plain_core='fused_th_xla')
    cxxs = train_path(checks, 'train cait_xxs_24 @224 bs128', 224, 128,
                      {'th_attention_fwd_train': 24, 'th_attention_bwd': 24},
                      args.seed,
                      profile=args.profile, model_name='cait_xxs_24',
                      plain_core='fused_th_xla')

    # Mixer-B/16 (slice 4): K8a at the factory's token-mix shapes, K8b at
    # bs192, K16 at ViT-B/16 @224 bs192's rows, the ragged edges, then the
    # paths
    k8a = {(b, l, d): check_k8a(rng, checks, b, l, k, d)
           for b, l, k, d in ((args.batch, 196, 98, 768), (192, 196, 98, 768),
                              (args.batch, 49, 24, 512),
                              (args.batch, 196, 98, 1024))}
    k8b = check_k8b(rng, checks, 192)
    k16 = check_k16(rng, checks, 192 * 197)
    for m in (1003, 129):
        check_k16(rng, checks, m, timed=False)
    check_ff_sentinels(rng, checks)
    k8a_serve = serve_path(checks, 'Mixer-B/16 @224 auto', 224, 'auto',
                              {'token_mix_fwd': 12}, args.seed, args.batch,
                              args.profile, model_name='mixer_b_patch16')
    m224 = train_path(checks, 'train Mixer-B/16 @224 bs192', 224, 192,
                      {'token_mix_fwd': 12, 'token_mix_bwd': 12}, args.seed,
                      profile=args.profile, model_name='mixer_b_patch16',
                      plain_core=False)
    ff224 = train_path(checks, 'train ViT-B/16 @224 bs192 fused_ff', 224, 192,
                       {'flash_fwd': 12, 'flash_bwd_fused': 12, 'ff_bwd': 12},
                       args.seed, profile=args.profile, plain_core='kernel',
                       use_kernel='fused_ff')

    # TNT-S/16 and TNT-B/16 (slice 5): K1 without the residual at the outer
    # sublayer's shapes (both variants), K7a at the inner layer's serving
    # and training shapes, K7b at both training shapes, the ragged tail,
    # then the paths ('fused_inner' timed beside 'auto' on TNT-S)
    k1n = {(dim, train): check_k1_route(rng, checks, args.batch, 197, dim,
                                        heads, train, residual=False)
           for dim, heads in ((384, 6), (640, 10)) for train in (False, True)}
    k7a = {(n, d): check_k7a(rng, checks, n, d)
           for n, d in ((args.batch * 196, 24), (64 * 196, 24),
                        (args.batch * 196, 40))}
    k7b = {(n, d): check_k7b(rng, checks, n, d)
           for n, d in ((64 * 196, 24), (32 * 196, 40))}
    check_k7_sentinels(rng, checks, 65 * 196 - 1, 24)
    check_k7_sentinels(rng, checks, 33 * 196 - 1, 40)
    check_k7a_units(rng, checks)
    tnt_serve = serve_path(checks, 'TNT-S/16 @224 auto', 224, 'auto',
                           {'tnt_inner_fwd': 12, 'fused_attention_fwd': 12},
                           args.seed, args.batch, args.profile,
                           model_name='tnt_s_patch16')
    # gradients against the plain core on the outer sublayer's boundary
    # (use_kernel='fused_layer_xla': the same autograd Function with bf16
    # flash-style residuals, no kernel in it; the inner layer per-op), as
    # ViT's are: the outer q/k weight gradients of every path through that
    # boundary, kernels or none, sit 0.10-0.22 from f32 at TNT-B bs32, the
    # per-op path (use_kernel=False) 0.02-0.03 (PERF.md, TNT findings)
    tnt_step = {'tnt_inner_fwd': 12, 'tnt_inner_bwd': 12,
                'fused_attention_fwd_train': 12, 'flash_bwd_fused': 12}
    ts224 = train_path(checks, 'train TNT-S/16 @224 bs64', 224, 64, tnt_step,
                       args.seed, profile=args.profile,
                       model_name='tnt_s_patch16',
                       plain_core='fused_layer_xla')
    train_path(checks, 'train TNT-S/16 @224 bs64 fused_inner', 224, 64,
               {'tnt_inner_fwd': 12, 'tnt_inner_bwd': 12, 'flash_fwd': 12,
                'flash_bwd_fused': 12}, args.seed, model_name='tnt_s_patch16',
               plain_core='fused_layer_xla', use_kernel='fused_inner')
    tb224 = train_path(checks, 'train TNT-B/16 @224 bs32', 224, 32, tnt_step,
                       args.seed, profile=args.profile,
                       model_name='tnt_b_patch16',
                       plain_core='fused_layer_xla')

    # BoTNet-T3 (slice 6): K9a at the serving (B=32) and training (B=64)
    # shapes, K9b at B=64, two ragged grids into sentinel buffers, then the
    # paths: serving and training on 'botnet_fused', and the per-op route
    # ('auto', which runs no K9) beside each
    k9a = {train: check_k9a(rng, checks, 64 if train else args.batch, train)
           for train in (False, True)}
    k9b = check_k9b(rng, checks, 64)
    # ragged against 64-row tiles and the plan's key tiles: g = 5 (one
    # 64-key tile, 25 keys), 13 (three, the last 41), 20 (four 104-key
    # steps, the last 88)
    for g in (5, 13, 20):
        check_k9_ragged(rng, checks, 3, g)
    bot_serve = serve_path(checks, 'BoTNet-T3 @224 botnet_fused', 224,
                           'botnet_fused', {'bot_fwd': 6}, args.seed,
                           args.batch, args.profile, model_name='botnet_t3')
    serve_path(checks, 'BoTNet-T3 @224 auto (per-op)', 224, 'auto', {},
               args.seed, args.batch, args.profile, model_name='botnet_t3')
    bot_train = train_path(checks, 'train BoTNet-T3 @224 bs64 botnet_fused',
                           224, 64, {'bot_fwd_train': 6, 'bot_bwd_dq': 6,
                                     'bot_bwd_dkv': 6}, args.seed,
                           profile=args.profile, model_name='botnet_t3',
                           plain_core=BOT_PLAIN, use_kernel='botnet_fused')
    train_path(checks, 'train BoTNet-T3 @224 bs64 auto (per-op)', 224, 64,
               {}, args.seed, model_name='botnet_t3', plain_core=None)

    # int8 (slice 7): K15, K12 and K13 (serve and save_hpre) and K10 at the
    # paths' shapes, the ragged edges, then the int8 routes: serving ViT-B/16
    # 'ff', 'all', 'int8' and 'int8' with QuantizedDense(fused=True), Mixer-B
    # 'ff'; training ViT-B/16 'ff' and Mixer-B/16 'ff'
    k15_rec = check_k15(rng, checks)
    k15_ff2 = check_k15(rng, checks, 6304, 3072, 768)
    k12 = {hp: check_int8_ff(rng, checks, (192 if hp else args.batch) * 196,
                             False, hp) for hp in (False, True)}
    k13 = {hp: check_int8_ff(rng, checks, (192 if hp else args.batch) * 197,
                             True, hp) for hp in (False, True)}
    # K12 save_hpre at CaiT-S/24 bs128's FF rows ('ff' and 'ff_sb' training)
    k12_cait = check_int8_ff(rng, checks, 128 * 196, False, True, 384, 1536)
    k10 = check_k10(rng, checks, args.batch, 197)
    check_int8_sentinels(rng, checks)
    q_ff = serve_path(checks, 'ViT-B/16 @224 quantized=ff', 224, 'auto',
                      {'fused_attention_fwd': 12, 'int8_ff_ln': 12}, args.seed,
                      args.batch, args.profile, quantized='ff')
    q_all = serve_path(checks, 'ViT-B/16 @224 quantized=all', 224, 'auto',
                       {'fused_attention_q8': 12, 'int8_ff_ln': 12}, args.seed,
                       args.batch, args.profile, quantized='all')
    serve_path(checks, 'ViT-B/16 @224 quantized=int8 depth 4', 224, 'auto',
               {'fused_attention_fwd': 4}, args.seed, args.batch,
               args.profile, quantized=True, num_layers=4)
    q_dense = serve_path(checks, 'ViT-B/16 @224 quantized=int8 fused=True',
                         224, 'auto', {'fused_attention_fwd': 12,
                                       'int8_matmul': 24}, args.seed,
                         args.batch, args.profile, quantized=True,
                         dense_fused=True)
    q_mix = serve_path(checks, 'Mixer-B/16 @224 quantized=ff', 224, 'auto',
                       {'token_mix_fwd': 12, 'int8_ff': 12}, args.seed,
                       args.batch, args.profile, model_name='mixer_b_patch16',
                       quantized='ff')
    q_train = train_path(checks, 'train ViT-B/16 @224 bs192 quantized=ff', 224,
                         192, {'fused_attention_fwd_train': 12,
                               'flash_bwd_fused': 12, 'int8_ff_ln_train': 12},
                         args.seed, profile=args.profile,
                         plain_core=INT8_PLAIN, quantized='ff')
    q_mix_train = train_path(checks, 'train Mixer-B/16 @224 bs192 quantized=ff',
                             224, 192, {'token_mix_fwd': 12,
                                        'token_mix_bwd': 12,
                                        'int8_ff_train': 12}, args.seed,
                             steps=3, model_name='mixer_b_patch16',
                             plain_core=INT8_PLAIN, quantized='ff')

    # the factory names that `auto` routes on the card and no path above
    # builds, at depth 2
    swept = sweep_factory(checks, args.seed)

    # int8 (slice 8): K11 at CaiT-S's and cait_xxs's widths, K14 at ViT-B
    # bs192's and CaiT-S bs128's FF rows, the ragged edges, then the paths:
    # serving CaiT-S/24 'all' (and @384 and cait_xxs at depth 2), training
    # ViT-B/16 and CaiT-S/24 'ff_sb', and CaiT-S/24 'ff' beside them
    k11 = {(dim, heads): check_k11(rng, checks, args.batch, 196, dim, heads)
           for dim, heads in ((384, 8), (192, 4))}
    k14 = {m: check_k14(rng, checks, m, d, f)
           for m, d, f in ((192 * 197, 768, 3072), (128 * 196, 384, 1536))}
    check_slice8_sentinels(rng, checks)
    check_quantizer(checks)
    q_cait = serve_path(checks, 'CaiT-S/24 @224 quantized=all', 224, 'auto',
                        {'th_attention_q8': 24, 'int8_ff': 24}, args.seed,
                        args.batch, args.profile, model_name='cait_s_24',
                        quantized='all')
    serve_path(checks, 'CaiT-S/24 @384 quantized=all depth 2', 384, 'auto',
               {'th_attention_fwd': 2, 'int8_ff': 2}, args.seed, args.batch,
               model_name='cait_s_24', quantized='all', num_layers=2)
    serve_path(checks, 'cait_xxs_24 @224 quantized=all depth 2', 224, 'auto',
               {'th_attention_q8': 2, 'int8_ff': 2}, args.seed, args.batch,
               model_name='cait_xxs_24', quantized='all', num_layers=2)
    sb_vit = train_path(checks, 'train ViT-B/16 @224 bs192 quantized=ff_sb',
                        224, 192, {'fused_attention_fwd_train': 12,
                                   'flash_bwd_fused': 12,
                                   'int8_ff_ln_train': 12, 'int8_ff_dx': 12},
                        args.seed, profile=args.profile,
                        plain_core=INT8_PLAIN, quantized='ff_sb')
    cait_step = {'th_attention_fwd_train': 24, 'th_attention_bwd': 24,
                 'int8_ff_train': 24}
    sb_cait = train_path(checks, 'train CaiT-S/24 @224 bs128 quantized=ff_sb',
                         224, 128, dict(cait_step, int8_ff_dx=24), args.seed,
                         profile=args.profile, model_name='cait_s_24',
                         plain_core=INT8_PLAIN, quantized='ff_sb')
    train_path(checks, 'train CaiT-S/24 @224 bs128 quantized=ff', 224, 128,
               cait_step, args.seed, model_name='cait_s_24', plain_core=None,
               quantized='ff')

    # CeiT (slice 9): K1's post-LN route at CeiT-S's widths (D = 384, H =
    # 6, L = 197), both variants at the serving and training batches; K1 at
    # D = 192 (H = 3: ceit_t's post-LN and vit_ti's pre-LN, their launches
    # from the sweep above); ViT-B/16's K1 outputs against the pinned
    # digests; then the paths: serving CeiT-S @224 bs32 on 'auto' and
    # 'fused_layer_full' (12 K1 post-LN launches per forward, no pre-LN one),
    # training CeiT-S @224 bs64 (12 K1 post-LN train + 12 K2 per step)
    k1c = {(b, train): check_k1_route(rng, checks, b, 197, 384, 6, train,
                                      False)
           for b in (args.batch, 64) for train in (False, True)}
    k1_192 = {(pre_ln, train): check_k1_route(
                  rng, checks, 64 if train else args.batch, 197, 192, 3, train,
                  pre_ln)
              for pre_ln in (False, True) for train in (False, True)}
    check_k1_bits(checks)
    ceit_serve = serve_path(checks, 'CeiT-S @224 auto', 224, 'auto',
                            {'fused_attention_fwd_noln': 12}, args.seed,
                            args.batch, args.profile, model_name='ceit_s')
    serve_path(checks, 'CeiT-S @224 fused_layer_full', 224, 'fused_layer_full',
               {'fused_attention_fwd_noln': 12}, args.seed, args.batch,
               args.profile, model_name='ceit_s')
    # K1 at D = 192 on counted paths: the sweep's depth-2 vit_ti (pre-LN)
    # and ceit_t (post-LN), a forward and a gradient step each
    d192_runs = {}
    for pre_ln, name in ((True, 'vit_ti_patch16'), (False, 'ceit_t')):
        for train in (False, True):
            kernel = ('fused_attention_fwd' + ('' if pre_ln else '_noln')
                      + ('_train' if train else ''))
            run = swept.get((name, 224, 'grad') if train else (name, 224), {})
            got = d192_runs[(pre_ln, train)] = run.get(kernel, 0)
            step = 'gradient step' if train else 'forward'
            checks.expect(got > 0, f'K1 at D = 192: {got} {kernel} launches '
                                   f'on the sweep\'s {name} depth-2 {step}')
    ceit_train = train_path(checks, 'train CeiT-S @224 bs64', 224, 64,
                            {'fused_attention_fwd_noln_train': 12,
                             'flash_bwd_fused': 12}, args.seed,
                            profile=args.profile, model_name='ceit_s')

    # CvT (slice 10): K4 and the K3 pair at cvt-13's three stage shapes @224
    # (one head at 3136 queries over 784 keys, three at 784 over 196, six at
    # the padded 225 over 64), K4 at the serving (B=32) and training (B=64)
    # batches, K3 at B=64 (every CvT length is past K2's 208 rows); K13 at
    # cvt-13's stage-3 width (D = 384) over its ragged B x 225 rows, both
    # variants, and at cvt-w24's last stage (D = 1024, 16 x 625 rows @384,
    # bench.py:91's batch); then the paths: serving cvt-13 @224 (13 K4 a
    # forward), training it @224 bs64 (13 K4 + 13 K3a + 13 K3b a step, no K2),
    # and under quantized 'ff' (+ 10 K13 a forward, 10 K13-train a step: the
    # 384-wide stage 3 only) and 'all' (the same kernels). cvt-w24 @384 runs
    # in the sweep above.
    t_cvt = time.perf_counter()
    cvt_shapes = ((1, 3136, 784), (3, 784, 196), (6, 225, 64))
    k4c = {(b, shape): check_k4(rng, checks, b, shape[1], heads=shape[0],
                                kv_seq=shape[2])
           for b in (args.batch, 64) for shape in cvt_shapes}
    k3c = {shape: check_bwd(rng, checks, 64, shape[2], heads=shape[0],
                            routes=('split',), q_len=shape[1])
           for shape in cvt_shapes}
    k13c = {hp: check_int8_ff(rng, checks, (64 if hp else args.batch) * 225,
                              True, hp, 384, 1536) for hp in (False, True)}
    k13w = check_int8_ff(rng, checks, 16 * 625, True, False, 1024, 4096)
    print(f'  CvT kernel checks took {time.perf_counter() - t_cvt:.1f} s',
          flush=True)
    cvt_step = {'flash_fwd': 13, 'flash_bwd_dq': 13, 'flash_bwd_dkv': 13}
    cvt_serve = serve_path(checks, 'CvT-13 @224 auto', 224, 'auto',
                           {'flash_fwd': 13}, args.seed, args.batch,
                           args.profile, model_name='cvt-13')
    cvt_train = train_path(checks, 'train CvT-13 @224 bs64', 224, 64,
                           cvt_step, args.seed, profile=args.profile,
                           model_name='cvt-13', plain_core=CVT_PLAIN)
    cvt_q_serve = serve_path(checks, 'CvT-13 @224 quantized=ff', 224, 'auto',
                             {'flash_fwd': 13, 'int8_ff_ln': 10}, args.seed,
                             args.batch, args.profile, model_name='cvt-13',
                             quantized='ff')
    serve_path(checks, 'CvT-13 @224 quantized=all', 224, 'auto',
               {'flash_fwd': 13, 'int8_ff_ln': 10}, args.seed, args.batch,
               model_name='cvt-13', quantized='all')
    cvt_q_train = train_path(checks, 'train CvT-13 @224 bs64 quantized=ff',
                             224, 64, dict(cvt_step, int8_ff_ln_train=10),
                             args.seed, steps=3, profile=args.profile,
                             model_name='cvt-13', plain_core=INT8_PLAIN,
                             quantized='ff')
    print(f'  the CvT phase took {time.perf_counter() - t_cvt:.1f} s',
          flush=True)

    # CaiT-M (slice 11): the TH kernels at H = 16 (cait_m's 16 heads of 48,
    # D = 768) at cait_m_48 @224's shapes (L = 196: serving and training
    # B = 16, K11 at the int8 serving B = 32), the blocked route's entries
    # (K6a, K6b) on the same kernels, ragged lengths on NaN sentinels and
    # K11's codes bit for bit; then the paths: serving cait_m_48 @224 bs16
    # (48 K5a a forward), training it bs16 (48 K5a-train + 48 K5b a step),
    # serving it quantized='all' bs32 (48 K11 + 48 K12). cait_m_24 @384 (K5
    # at L = 576) runs in the sweep above.
    t_m = time.perf_counter()
    k5a_m = {train: check_k5a(rng, checks, 16, 196, save_residuals=train,
                              dim=768, heads=16) for train in (False, True)}
    k6a_m = {train: check_k6a(rng, checks, 16, 196, heads=16)
             for train in (False, True)}
    k5b_m = check_th_bwd(rng, checks, 16, 196, 'th_attention_bwd', heads=16)
    k6b_m = check_th_bwd(rng, checks, 16, 196, 'th_core_bwd', heads=16)
    for seq in (197, 577):
        check_th_tails(rng, checks, seq, heads=16)
    k11_m = check_k11(rng, checks, 32, 196, 768, 16)
    check_k11_codes(rng, checks, 2, 197, 768, 16)
    kept = check_k11_sentinels(rng, checks, 3, (197, 250), 768, 16)
    untouched = all(bool(torch.isnan(t).all()) for t in kept)
    checks.expect(untouched, f'K11 H=16 into sentinel buffers: rows past '
                             f'B*L untouched {untouched}')
    print(f'  CaiT-M kernel checks took {time.perf_counter() - t_m:.1f} s',
          flush=True)
    m_serve = serve_path(checks, 'CaiT-M/48 @224 auto', 224, 'auto',
                         {'th_attention_fwd': 48}, args.seed, 16,
                         args.profile, model_name='cait_m_48')
    m_train = train_path(checks, 'train CaiT-M/48 @224 bs16', 224, 16,
                         {'th_attention_fwd_train': 48,
                          'th_attention_bwd': 48}, args.seed,
                         profile=args.profile, model_name='cait_m_48',
                         plain_core='fused_th_xla')
    m_q = serve_path(checks, 'CaiT-M/48 @224 quantized=all', 224, 'auto',
                     {'th_attention_q8': 48, 'int8_ff': 48}, args.seed,
                     args.batch, args.profile, model_name='cait_m_48',
                     quantized='all')
    print(f'  the CaiT-M phase took {time.perf_counter() - t_m:.1f} s',
          flush=True)

    # CaiT-XS (slice 12): the TH kernels at H = 6 (cait_xs's 6 heads of 48,
    # D = 288: 4.5 boxes of 64 columns, read as 5) at cait_xs_24 @224's
    # shapes (L = 196: serving B = 32, training B = 128) and L = 576, the
    # int8 FF kernels at D = 288, F = 1152 (a 32-wide last tile), each
    # output's last 32 columns also on their own, ragged lengths and rows
    # on NaN sentinels, K11's codes bit for bit; K5a (its LN and its
    # projection GEMMs at a ragged last tile and step around the core) at
    # @224's serving and training shapes and L = 576; then the paths:
    # serving cait_xs_24 @224 bs32 (24 K5a a forward), training it bs128
    # (24 K5a-train + 24 K5b a step), serving it quantized='all' bs32 (24
    # K11 + 24 K12) and training it 'ff_sb' bs128 (+ 24 K12-train + 24
    # K14), then the blocked route's own path. cait_xs_24 @384 (K5 at L =
    # 576) runs in the sweep above.
    t_xs = time.perf_counter()
    k5a_xs = {train: check_k5a(rng, checks, 128 if train else args.batch, 196,
                               save_residuals=train, dim=288, heads=6)
              for train in (False, True)}
    k5a_xs576 = check_k5a(rng, checks, args.batch, 576, False, dim=288,
                          heads=6)
    k6a_xs = {(b, seq): check_k6a(rng, checks, b, seq, heads=6)
              for b, seq in ((args.batch, 196), (128, 196), (args.batch, 576))}
    k6b_xs = check_th_bwd(rng, checks, 128, 196, 'th_core_bwd', heads=6)
    k5b_xs = check_th_bwd(rng, checks, 128, 196, 'th_attention_bwd', heads=6)
    for seq in (197, 577):
        check_th_tails(rng, checks, seq, heads=6)
    k11_xs = check_k11(rng, checks, args.batch, 196, 288, 6)
    check_k11_codes(rng, checks, args.batch, 196, 288, 6)
    check_k11_codes(rng, checks, 2, 197, 288, 6)
    kept = check_k11_sentinels(rng, checks, 3, (197, 250), 288, 6)
    k12_xs = {hp: check_int8_ff(rng, checks, (128 if hp else args.batch) * 196,
                                False, hp, 288, 1152) for hp in (False, True)}
    k13_xs = check_int8_ff(rng, checks, args.batch * 196, True, False, 288,
                           1152)
    k14_xs = check_k14(rng, checks, 128 * 196, 288, 1152)
    kept += check_ff_sentinels_at(rng, checks, 1003, 288, 1152)
    untouched = all(bool(torch.isnan(t).all()) for t in kept)
    checks.expect(untouched, f'K11, K12, K13, K14 at D = 288 into sentinel '
                             f'buffers: rows past B*L or M untouched '
                             f'{untouched}')
    print(f'  CaiT-XS kernel checks took {time.perf_counter() - t_xs:.1f} s',
          flush=True)
    xs_serve = serve_path(checks, 'cait_xs_24 @224 auto', 224, 'auto',
                          {'th_attention_fwd': 24}, args.seed, args.batch,
                          args.profile, model_name='cait_xs_24')
    xs_train = train_path(checks, 'train cait_xs_24 @224 bs128', 224, 128,
                          {'th_attention_fwd_train': 24,
                           'th_attention_bwd': 24}, args.seed,
                          profile=args.profile, model_name='cait_xs_24',
                          plain_core='fused_th_xla')
    xs_q = serve_path(checks, 'cait_xs_24 @224 quantized=all', 224, 'auto',
                      {'th_attention_q8': 24, 'int8_ff': 24}, args.seed,
                      args.batch, args.profile, model_name='cait_xs_24',
                      quantized='all')
    xs_sb = train_path(checks, 'train cait_xs_24 @224 bs128 quantized=ff_sb',
                       224, 128, {'th_attention_fwd_train': 24,
                                  'th_attention_bwd': 24,
                                  'int8_ff_train': 24, 'int8_ff_dx': 24},
                       args.seed, profile=args.profile,
                       model_name='cait_xs_24', plain_core=INT8_PLAIN,
                       quantized='ff_sb')
    # the blocked route's own path (K6a and K6b through their entries):
    # 24 sublayers at cait_xs_24 @224 bs128's shapes
    k6_path = blocked_path(checks, 'blocked route, 24 sublayers at cait_xs '
                           '@224 bs128', 128, 196, 6, 24, args.seed)
    print(f'  the CaiT-XS phase took {time.perf_counter() - t_xs:.1f} s',
          flush=True)
    jpeg_dir = tempfile.mkdtemp(prefix='sav_data_')
    try:
        data_phase(checks, args.seed, smi, jpeg_dir, profile=args.profile)
        checkpoint_phase(checks, args.seed, smi)
        # the imported checkpoints' paths: K4 at the fine-tune's B = 48,
        # L = 577 beside the serving shape k4[197]
        k4_ft = check_k4(rng, checks, 48, 577)
        imported = import_phase(checks, args.seed, smi,
                                os.path.join(jpeg_dir, 'jpegs'), args.profile)
    finally:
        shutil.rmtree(jpeg_dir, ignore_errors=True)
    import_ft = imported['finetune_launches']

    def cvt_fields(prefix, recs, keys=('ms', 'bound_ms', 'bound_by',
                                       'plain_ms', 'library_ms')):
        """CvT's per-stage records (cvt-13 @224's stages 1-3) under
        ``prefix``_s1_* .. _s3_*, and their largest error."""
        return {f'{prefix}_max_abs_err': max(r['max_abs_err'] for r in recs),
                **{f'{prefix}_s{i}_{k}': r[k] for i, r in enumerate(recs, 1)
                   for k in keys}}

    def th_entry(name, replaces, launches, rec, train=None,
                 source='th_attention.cu', **extra):
        """A TH kernel's line: ``rec`` at its serving (or only) shape;
        ``train``, the record at the training shape, adds train_* keys."""
        if train is not None:
            rec = dict(rec, max_abs_err=max(rec['max_abs_err'],
                                            train['max_abs_err']),
                       train_ms=train['ms'], train_bound_ms=train['bound_ms'])
        return dict(name=name, route='cuda',
                    source=f'sav_tpu_torch/csrc/{source}',
                    replaces=f'sav_tpu/ops/th_attention.py:{replaces}',
                    launches=launches, **rec, **extra)

    def heads_fields(prefix, launches, rec, train_launches=None, train=None,
                     **extra):
        """A kernel at another model's head count or width (cait_m's H =
        16, cait_xs's H = 6 / D = 288, cait_xxs's H = 4 / D = 192) under
        ``prefix``_*: its launches on that model's path (a forward or a
        step, read from that path's counts: 0 where the path reaches the
        same kernel through another entry), ``rec`` at the path's shape,
        ``train`` (the training shape's record) under ``prefix``_train_*,
        and ``extra`` (e.g. the instantiation's ptxas line) as given."""
        keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
                'max_abs_err')
        out = {f'{prefix}_launches': launches,
               **{f'{prefix}_{k}': rec[k] for k in keys}}
        if train is not None:
            out[f'{prefix}_train_launches'] = train_launches
            out.update({f'{prefix}_train_{k}': train[k] for k in keys})
        out.update({f'{prefix}_{k}': v for k, v in extra.items()})
        return out

    def nores(train, launches):
        """K1 without the residual (TNT's outer sublayer), under nores_*:
        TNT-S's shape (D=384) and TNT-B's (D=640) at B=32, L=197."""
        s, b = k1n[(384, train)], k1n[(640, train)]
        return dict(nores_launches=launches, nores_ms=s['ms'],
                    nores_plain_ms=s['plain_ms'],
                    nores_library_ms=s['library_ms'],
                    nores_bound_ms=s['bound_ms'], nores_bound_by=s['bound_by'],
                    nores_max_abs_err=max(s['max_abs_err'], b['max_abs_err']),
                    nores_tntb_ms=b['ms'], nores_tntb_plain_ms=b['plain_ms'],
                    nores_tntb_library_ms=b['library_ms'],
                    nores_tntb_bound_ms=b['bound_ms'])

    def d192(rec, launches):
        """K1 at D = 192, H = 3 (vit_ti's pre-LN, ceit_t's post-LN) under
        d192_*; ``launches`` from the sweep's depth-2 run of vit_ti or
        ceit_t (a forward, or a gradient step for a train variant)."""
        return dict(d192_launches=launches,
                    **{f'd192_{k}': v for k, v in rec.items()})

    def noln_entry(name, launches, rec, other, tag, extra):
        """K1's post-LN route: ``rec`` at its path's batch, ``other`` (the
        other batch) under ``tag``_*, ``extra`` (d192_*) beside them."""
        return dict(name=name, route='cuda',
                    source='sav_tpu_torch/csrc/fused_attention.cu',
                    replaces='sav_tpu/ops/fused_layer.py:127',
                    launches=launches, **rec,
                    **{f'{tag}_{k}': v for k, v in other.items()}, **extra)

    def tnt_entry(name, replaces, launches, rec, tntb, **extra):
        """A K7 line: ``rec`` at TNT-S's shape, ``tntb`` at TNT-B's."""
        return dict(name=name, route='cuda',
                    source='sav_tpu_torch/csrc/tnt_inner.cu',
                    replaces=f'sav_tpu/ops/tnt_inner.py:{replaces}',
                    launches=launches, **dict(
                        rec, max_abs_err=max(rec['max_abs_err'],
                                             tntb['max_abs_err'])),
                    tntb_ms=tntb['ms'], tntb_wrapper_ms=tntb['wrapper_ms'],
                    tntb_plain_ms=tntb['plain_ms'],
                    tntb_library_ms=tntb['library_ms'],
                    tntb_bound_ms=tntb['bound_ms'], **extra)

    def bot_entry(name, replaces, launches, rec, **extra):
        """A K9 line: ``rec`` at botnet_t3's BoT-stage shape."""
        return dict(name=name, route='cuda',
                    source='sav_tpu_torch/csrc/botnet_attention.cu',
                    replaces=f'sav_tpu/ops/botnet_attention.py:{replaces}',
                    launches=launches, **rec, **extra)

    kernels = [
        dict(name='fused_attention_fwd', route='cuda',
             source='sav_tpu_torch/csrc/fused_attention.cu',
             replaces='sav_tpu/ops/fused_layer.py:127',
             launches=k1_serve.get('fused_attention_fwd', 0),
             max_abs_err=max(r['max_abs_err'] for r in k1.values()),
             **{k: v for k, v in k1[197].items() if k != 'max_abs_err'},
             **nores(False, tnt_serve.get('fused_attention_fwd', 0)),
             **d192(k1_192[(True, False)], d192_runs[(True, False)])),
        # K4: ViT-B/16 @384 serving (B=32, L=577) launches and timing; the
        # fused_ff training shape (B=192, L=197) under train_*
        dict(name='flash_fwd', route='cuda',
             source='sav_tpu_torch/csrc/flash_fwd_sm90.cuh',
             replaces='sav_tpu/ops/flash_attention.py:228',
             launches=k4_serve.get('flash_fwd', 0),
             max_abs_err=max(r['max_abs_err']
                             for r in (*k4.values(), k4_train)),
             **{k: v for k, v in k4[577].items() if k != 'max_abs_err'},
             train_launches=ff224.get('flash_fwd', 0),
             **{f'train_{k}': v for k, v in k4_train.items()
                if k != 'max_abs_err'},
             # CvT-13 @224: serving (B=32) and training (B=64) launches,
             # each stage's shape timed at both batches
             cvt_launches=cvt_serve.get('flash_fwd', 0),
             cvt_train_launches=cvt_train.get('flash_fwd', 0),
             **cvt_fields('cvt', [k4c[(args.batch, c)] for c in cvt_shapes]),
             **cvt_fields('cvt_train', [k4c[(64, c)] for c in cvt_shapes]),
             # the imported (biased) ViT-B/16: serving @224 (B = 32, L =
             # 197) and a fine-tune step @384 (B = 48, L = 577)
             import_launches=imported['serve_launches'],
             **{f'import_{k}': v for k, v in k4[197].items()},
             import_train_launches=import_ft.get('flash_fwd', 0),
             **{f'import_train_{k}': v for k, v in k4_ft.items()}),
        dict(name='fused_attention_fwd_train', route='cuda',
             source='sav_tpu_torch/csrc/fused_attention.cu',
             replaces='sav_tpu/ops/fused_layer.py:127',
             launches=t224.get('fused_attention_fwd_train', 0),
             max_abs_err=max(r['max_abs_err'] for r in k1t.values()),
             **{k: v for k, v in k1t[197].items() if k != 'max_abs_err'},
             **nores(True, ts224.get('fused_attention_fwd_train', 0)),
             **d192(k1_192[(True, True)], d192_runs[(True, True)])),
        # K1's post-LN route (CeiT): CeiT-S serving (B=32) and training
        # (B=64) launches and timing, the other batch under b64_*/b32_*,
        # ceit_t's D = 192 under d192_*
        noln_entry('fused_attention_fwd_noln',
                   ceit_serve.get('fused_attention_fwd_noln', 0),
                   k1c[(args.batch, False)], k1c[(64, False)], 'b64',
                   d192(k1_192[(False, False)], d192_runs[(False, False)])),
        noln_entry('fused_attention_fwd_noln_train',
                   ceit_train.get('fused_attention_fwd_noln_train', 0),
                   k1c[(64, True)], k1c[(args.batch, True)], 'b32',
                   d192(k1_192[(False, True)], d192_runs[(False, True)])),
        # K2 at @224 bs192 (L = 197) beside the K3 pair on the same inputs
        # (k3_pair_ms), and at 200 over 190 keys under l200_*
        dict(name='flash_bwd_fused', route='cuda',
             source='sav_tpu_torch/csrc/flash_bwd.cu',
             replaces='sav_tpu/ops/flash_attention.py:330',
             launches=t224.get('flash_bwd_fused', 0),
             **bwd197['fused'], k3_pair_ms=bwd197['dq']['pair_ms'],
             l200_ms=bwd200['fused']['ms'],
             l200_library_ms=bwd200['fused']['library_ms'],
             l200_k3_pair_ms=bwd200['dq']['pair_ms']),
        # K3a/K3b: timed at @384 bs48 (L = 577, the main path), the @224
        # bs192 shape (L = 197, where K2 runs on the path) under l197_*
        # and CvT-13 @224 bs64's three stages under cvt_s1_* .. cvt_s3_*
        # (library_ms: SDPA's backward, the whole function)
        *(dict(name=f'flash_bwd_{n}', route='cuda',
               source='sav_tpu_torch/csrc/flash_bwd_split.cu',
               replaces=f'sav_tpu/ops/flash_attention.py:{line}',
               launches=t384.get(f'flash_bwd_{n}', 0), **bwd577[n],
               **{f'l197_{key}': bwd197[n][key] for key in (
                   'ms', 'bound_ms', 'pair_ms', 'pair_library_ms',
                   'pair_bound_ms')},
               import_launches=import_ft.get(f'flash_bwd_{n}', 0),
               cvt_launches=cvt_train.get(f'flash_bwd_{n}', 0),
               **cvt_fields('cvt', [k3c[c][n] for c in cvt_shapes],
                            ('ms', 'bound_ms', 'bound_by', 'plain_ms',
                             'library_ms', 'pair_ms', 'pair_bound_ms')))
          for n, line in (('dq', 363), ('dkv', 392))),
        # K5a: the serving launches and timing @224; its residual-writing
        # variant (train @224) under train_*, @384 (L = 576) under l576_*,
        # cait_m_48's H = 16 under m48_*, cait_xxs's D = 192 under xxs_*,
        # cait_xs's H = 6 / D = 288 (ragged GEMM tiles) under h6_*
        th_entry('th_attention_fwd', 158,
                 k5a_serve.get('th_attention_fwd', 0), k5a[False], k5a[True],
                 train_launches=c224.get('th_attention_fwd_train', 0),
                 l576_launches=k5a_serve384.get('th_attention_fwd', 0),
                 l576_train_launches=c384.get('th_attention_fwd_train', 0),
                 l576_ms=k5a384[False]['ms'],
                 l576_train_ms=k5a384[True]['ms'],
                 l576_bound_ms=k5a384[False]['bound_ms'],
                 l576_train_bound_ms=k5a384[True]['bound_ms'],
                 **heads_fields('m48', m_serve.get('th_attention_fwd', 0),
                                k5a_m[False],
                                m_train.get('th_attention_fwd_train', 0),
                                k5a_m[True]),
                 **heads_fields('xxs', xxs_serve.get('th_attention_fwd', 0),
                                k5a_xxs[False],
                                cxxs.get('th_attention_fwd_train', 0),
                                k5a_xxs[True]),
                 **heads_fields('h6', xs_serve.get('th_attention_fwd', 0),
                                k5a_xs[False],
                                xs_train.get('th_attention_fwd_train', 0),
                                k5a_xs[True], l576_ms=k5a_xs576['ms'],
                                l576_bound_ms=k5a_xs576['bound_ms'])),
        th_entry('th_attention_bwd', 274, c224.get('th_attention_bwd', 0), k5b,
                 source='th_bwd.cu',
                 l576_launches=c384.get('th_attention_bwd', 0),
                 **heads_fields('m48', m_train.get('th_attention_bwd', 0),
                                k5b_m),
                 **heads_fields('xxs', cxxs.get('th_attention_bwd', 0),
                                k5b_xxs),
                 **heads_fields('h6', xs_train.get('th_attention_bwd', 0),
                                k5b_xs)),
        # K6a and K6b, the blocked route's entries: no factory CaiT takes
        # that route on the card (K5a's GEMMs take every CaiT width), so
        # their launches are those of the route's own path (24 sublayers at
        # cait_xs_24 @224 bs128's shapes, a forward and backward) and their
        # top-level timing is at that shape (H = 6); core_* are the
        # launches of the same kernels through K5a's and K5b's entries on
        # the cait_xs training step; the cait_xxs paths' counts (0) and
        # timing (H = 4) under xxs_*, H = 16 under h16_*, cait_xs serving's
        # B = 32 and L = 576 under h6_*, H = 8 at L = 576 under l576_*
        th_entry('th_core_fwd', 362, k6_path.get('th_core_fwd', 0),
                 k6a_xs[(128, 196)], source='th_fwd_sm90.cuh',
                 core_launches=xs_train.get('th_attention_fwd_train', 0),
                 l576_ms=k6a576[False]['ms'], l576_train_ms=k6a576[True]['ms'],
                 l576_bound_ms=k6a576[False]['bound_ms'],
                 **heads_fields('xxs', xxs_serve.get('th_core_fwd', 0),
                                k6a[False], cxxs.get('th_core_fwd', 0),
                                k6a[True]),
                 **heads_fields('h16', m_serve.get('th_core_fwd', 0),
                                k6a_m[False], m_train.get('th_core_fwd', 0),
                                k6a_m[True]),
                 **heads_fields('h6', xs_serve.get('th_core_fwd', 0),
                                k6a_xs[(args.batch, 196)],
                                l576_ms=k6a_xs[(args.batch, 576)]['ms'],
                                l576_bound_ms=k6a_xs[(args.batch,
                                                      576)]['bound_ms'],
                                ptxas=ptxas_of('th_attention',
                                               'th_fwd_sm90_kernel', 6))),
        th_entry('th_core_bwd', 387, k6_path.get('th_core_bwd', 0), k6b_xs,
                 source='th_bwd.cu',
                 core_launches=xs_train.get('th_attention_bwd', 0),
                 l576_ms=k6b576['ms'], l576_bound_ms=k6b576['bound_ms'],
                 **heads_fields('xxs', cxxs.get('th_core_bwd', 0), k6b),
                 **heads_fields('h16', m_train.get('th_core_bwd', 0), k6b_m),
                 h6_ptxas=ptxas_of('th_bwd', 'th_bwd_kernel', 6)),
        # K8a: Mixer-B/16 serving (B=32) launches and timing; the training
        # shape (B=192) under train_*
        dict(name='token_mix_fwd', route='cuda',
             source='sav_tpu_torch/csrc/mixer_token.cu',
             replaces='sav_tpu/ops/mixer_token.py:86',
             launches=k8a_serve.get('token_mix_fwd', 0),
             **{k: v for k, v in k8a[(args.batch, 196, 768)].items()
                if k != 'max_abs_err'},
             max_abs_err=max(r['max_abs_err'] for r in k8a.values()),
             train_launches=m224.get('token_mix_fwd', 0),
             train_ms=k8a[(192, 196, 768)]['ms'],
             train_bound_ms=k8a[(192, 196, 768)]['bound_ms']),
        dict(name='token_mix_bwd', route='cuda',
             source='sav_tpu_torch/csrc/mixer_token.cu',
             replaces='sav_tpu/ops/mixer_token.py:99',
             launches=m224.get('token_mix_bwd', 0), **k8b),
        dict(name='ff_bwd', route='cuda', source='sav_tpu_torch/csrc/ff_bwd.cu',
             replaces='sav_tpu/ops/fused_layer.py:543',
             launches=ff224.get('ff_bwd', 0), **k16),
        # K7a: TNT-S serving (B*P = 32 x 196) launches and timing; TNT-S's
        # training shape (64 x 196) under train_*, TNT-B's (32 x 196) under
        # tntb_*
        tnt_entry('tnt_inner_fwd', 148, tnt_serve.get('tnt_inner_fwd', 0),
                  dict(k7a[(args.batch * 196, 24)], max_abs_err=max(
                      r['max_abs_err'] for r in k7a.values())),
                  k7a[(args.batch * 196, 40)],
                  train_launches=ts224.get('tnt_inner_fwd', 0),
                  tntb_train_launches=tb224.get('tnt_inner_fwd', 0),
                  train_ms=k7a[(64 * 196, 24)]['ms'],
                  train_wrapper_ms=k7a[(64 * 196, 24)]['wrapper_ms'],
                  train_bound_ms=k7a[(64 * 196, 24)]['bound_ms']),
        tnt_entry('tnt_inner_bwd', 169, ts224.get('tnt_inner_bwd', 0),
                  k7b[(64 * 196, 24)], k7b[(32 * 196, 40)],
                  tntb_launches=tb224.get('tnt_inner_bwd', 0)),
        # K9a: BoTNet-T3 serving (B=32) launches and timing; the training
        # forward (B=64, lse saved) under train_*. K9b is two kernels, each
        # timed alone; library_bwd_ms and whole_ms are the whole backward's
        bot_entry('bot_fwd', 123, bot_serve.get('bot_fwd', 0), dict(
                      k9a[False], max_abs_err=max(r['max_abs_err']
                                                  for r in k9a.values())),
                  train_launches=bot_train.get('bot_fwd_train', 0),
                  train_ms=k9a[True]['ms'],
                  train_wrapper_ms=k9a[True]['wrapper_ms'],
                  train_plain_ms=k9a[True]['plain_ms'],
                  train_library_ms=k9a[True]['library_ms'],
                  train_bound_ms=k9a[True]['bound_ms']),
        bot_entry('bot_bwd_dq', 147, bot_train.get('bot_bwd_dq', 0),
                  k9b['dq']),
        bot_entry('bot_bwd_dkv', 147, bot_train.get('bot_bwd_dkv', 0),
                  k9b['dkv']),
        # int8 (slice 7): K15 at ViT-B's first FF product (bs32), the
        # second under ff2_*, its launches from ViT-B 'int8' with
        # QuantizedDense(fused=True); K12 at
        # Mixer-B bs32 (serve) and bs192 (save_hpre, Mixer 'ff' training),
        # CaiT-S bs128 (save_hpre, CaiT 'ff_sb' training) under cait_*;
        # K13 at ViT-B bs32 (serve) and bs192 (save_hpre, ViT 'ff'
        # training); K10 at ViT-B bs32 (ViT 'all')
        dict(name='int8_matmul', route='cuda',
             source='sav_tpu_torch/csrc/int8_matmul.cu',
             replaces='sav_tpu/ops/int8_matmul_kernel.py:67',
             launches=q_dense.get('int8_matmul', 0),
             **dict(k15_rec, max_abs_err=max(k15_rec['max_abs_err'],
                                             k15_ff2['max_abs_err'])),
             ff2_ms=k15_ff2['ms'], ff2_entry_ms=k15_ff2['entry_ms'],
             ff2_plain_ms=k15_ff2['plain_ms'],
             ff2_library_ms=k15_ff2['library_ms'],
             ff2_bound_ms=k15_ff2['bound_ms'],
             ff2_bound_by=k15_ff2['bound_by']),
        dict(name='int8_ff', route='cuda', source='sav_tpu_torch/csrc/int8_ff.cu',
             replaces='sav_tpu/ops/int8_ff.py:49',
             launches=q_mix.get('int8_ff', 0), **k12[False],
             **heads_fields('h6', xs_q.get('int8_ff', 0), k12_xs[False])),
        dict(name='int8_ff_train', route='cuda',
             source='sav_tpu_torch/csrc/int8_ff.cu',
             replaces='sav_tpu/ops/int8_ff.py:49',
             launches=q_mix_train.get('int8_ff_train', 0),
             **dict(k12[True], max_abs_err=max(k12[True]['max_abs_err'],
                                               k12_cait['max_abs_err'])),
             cait_launches=sb_cait.get('int8_ff_train', 0),
             cait_ms=k12_cait['ms'], cait_plain_ms=k12_cait['plain_ms'],
             cait_library_ms=k12_cait['library_ms'],
             cait_bound_ms=k12_cait['bound_ms'],
             cait_bound_by=k12_cait['bound_by'],
             **heads_fields('h6', xs_sb.get('int8_ff_train', 0), k12_xs[True])),
        # K13 also at CvT-13's stage 3 (D = 384, B x 225 rows: bs32 serving,
        # bs64 training) under cvt_*, and at cvt-w24's (D = 1024, 16 x 625
        # rows) under w24_*
        dict(name='int8_ff_ln', route='cuda',
             source='sav_tpu_torch/csrc/int8_ff.cu',
             replaces='sav_tpu/ops/int8_ff.py:211',
             launches=q_ff.get('int8_ff_ln', 0), **k13[False],
             cvt_launches=cvt_q_serve.get('int8_ff_ln', 0),
             **{f'cvt_{k}': v for k, v in k13c[False].items()},
             **{f'w24_{k}': v for k, v in k13w.items()},
             **heads_fields('h6', xs_q.get('int8_ff_ln', 0), k13_xs)),
        dict(name='int8_ff_ln_train', route='cuda',
             source='sav_tpu_torch/csrc/int8_ff.cu',
             replaces='sav_tpu/ops/int8_ff.py:211',
             launches=q_train.get('int8_ff_ln_train', 0), **k13[True],
             cvt_launches=cvt_q_train.get('int8_ff_ln_train', 0),
             **{f'cvt_{k}': v for k, v in k13c[True].items()}),
        dict(name='fused_attention_q8', route='cuda',
             source='sav_tpu_torch/csrc/fused_attention_q8.cu',
             replaces='sav_tpu/ops/fused_layer.py:764',
             launches=q_all.get('fused_attention_q8', 0), **k10),
        # int8 (slice 8): K11 at CaiT-S/24 bs32 (CaiT 'all' serving), the
        # cait_xxs widths (D = 192, H = 4) under xxs_*; K14 at ViT-B/16
        # bs192 (ViT 'ff_sb' training), CaiT-S/24 bs128 under cait_*
        dict(name='th_attention_q8', route='cuda',
             source='sav_tpu_torch/csrc/th_attention_q8.cu',
             replaces='sav_tpu/ops/th_attention.py:717',
             launches=q_cait.get('th_attention_q8', 0),
             **dict(k11[(384, 8)], max_abs_err=max(
                 r['max_abs_err'] for r in k11.values())),
             xxs_ms=k11[(192, 4)]['ms'],
             xxs_entry_ms=k11[(192, 4)]['entry_ms'],
             xxs_plain_ms=k11[(192, 4)]['plain_ms'],
             xxs_library_ms=k11[(192, 4)]['library_ms'],
             xxs_bound_ms=k11[(192, 4)]['bound_ms'],
             **heads_fields('m48', m_q.get('th_attention_q8', 0), k11_m),
             **heads_fields('h6', xs_q.get('th_attention_q8', 0), k11_xs,
                  entry_ms=k11_xs['entry_ms'],
                  ptxas=ptxas_of('th_attention_q8', 'th_fwd_sm90_kernel', 6))),
        dict(name='int8_ff_dx', route='cuda',
             source='sav_tpu_torch/csrc/int8_ff.cu',
             replaces='sav_tpu/ops/int8_ff.py:378',
             launches=sb_vit.get('int8_ff_dx', 0),
             **dict(k14[192 * 197], max_abs_err=max(
                 r['max_abs_err'] for r in k14.values())),
             cait_launches=sb_cait.get('int8_ff_dx', 0),
             cait_ms=k14[128 * 196]['ms'],
             cait_plain_ms=k14[128 * 196]['plain_ms'],
             cait_library_ms=k14[128 * 196]['library_ms'],
             cait_bound_ms=k14[128 * 196]['bound_ms'],
             cait_bound_by=k14[128 * 196]['bound_by'],
             **heads_fields('h6', xs_sb.get('int8_ff_dx', 0), k14_xs)),
    ]
    print(f'chip_smoke: {time.perf_counter() - t0:.1f} s in all', flush=True)
    if checks.failed:
        print(f'chip_smoke: {len(checks.failed)} check(s) failed:',
              file=sys.stderr)
        for what in checks.failed:
            print(f'  {what}', file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
