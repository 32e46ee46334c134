"""Smoke run of the PyTorch/CUDA port on one GPU: build every kernel, hold
each against its plain PyTorch version, drive the ported trainers at full
width through the kernels, and time kernels and training steps.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi-gpu-only   # phases 1, 2, 4, 7 and 18 alone

`--multi-gpu-only` is for a machine of several cards: the device, the
build, the two one-rank CLI phases (main, main_dino: `--devices 1` keeps
them in this process however many cards there are) and phase 18; it
prints no kernels line.

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device      nvidia-smi name and power limit, torch.version.cuda
  2. build       nvcc of cerebra_torch/csrc/{lstm_stack,lstm_scan,vit_attn,
                 vit_mlp,sos_scan}.cu, all started together, seconds each
  3. parity      K3, K1, K2 and K2's two pieces (each layer's reverse scan
                 and its products) against their plain versions, f32 and
                 bf16, at B = 1024, 16 and 13 (T = 460, C = H = 96, L = 2),
                 K3 at B = 960 in bf16, and K2 on K1's own residuals; in
                 bf16 K1 and K3 run the wavefront forward (`fwd_wave`
                 launches counted)
  4. main        `cerebra_torch.cli.lstm_distill_from_dinov2_train.main` on
                 the synthetic corpus (40 classes x 30 trials of (96, 512)),
                 bf16, batch 16, 6 epochs; launch counts cover every step,
                 K1 and the validation's K3 through the wavefront forward
  5. timing      each LSTM kernel against its plain version and the cuDNN
                 call that computes the same function at the main path's
                 shapes (K2 also split into its scans and its products; K1
                 and K3 beside `lstm_fwd_kernel` at the same shape), the
                 reverse scan's rows per block, and bench.py's step (filter,
                 crop, LSTM fwd/bwd, RMSprop) at B = 1024, kernels and plain
                 versions
  6. vit parity  K5/K6 (attention) and K7/K8 (MLP) against their plain
                 versions at the main_dino shapes (B = 16, N = 785; B = 32,
                 N = 145) and a ragged N = 37, f32 and f32-stream/bf16-compute,
                 with and without the drop-path scale (one sample dropped);
                 the value and every gradient
  7. main_dino   `cerebra_torch.cli.main_dino.main` at the full-width
                 defaults (ViT-S/8, out_dim 65536, 2 x 224 + 4 x 96 views,
                 batch 8, drop path 0.1, bf16) on 40 classes x 2 trials for
                 2 epochs (10 steps each); finite losses, log.txt, and every
                 step through K5-K8 in all 12 blocks
  8. vit timing  each ViT kernel against its plain version at the globals'
                 and the locals' shapes; `[mlp pieces]`: K7 and K8 split by
                 launch (torch.profiler) with their launches a call, each
                 product's device ms against its bound and cuBLAS torch.mm
                 on the same operands (a yardstick), K8's fused dh kernel
                 alone against its plain piece; `[vit pieces]`: K5 and K6 split by
                 launch (torch.profiler), each attention core alone (K5's
                 forward core, K6's dq and dk/dv cores) against its plain
                 piece (parity, time, bound), the dk/dv core's scores against
                 the forward's bit for bit, and SDPA's flash kernels on the
                 same q, k, v as a yardstick; ms/step and views/s of the
                 main_dino step through the kernels and the plain versions
                 (median of three windows), and `[dino profile]`: its device
                 time by half-block, the attention cores apart, the idle
                 share and the host's time by op
  9. ae parity   K4 and K2g (cotangent at T-1 or at every t, with and
                 without dx) against their plain versions at the recurrent
                 autoencoder's encoder (C 96, H 384) and decoder (C 384,
                 H 96) widths, B = 16 and 13, f32 and bf16; and every
                 gradient of RecurrentAutoencoder(460, 96, 384) for a loss on
                 both outputs, through the kernels and the plain versions
 10. ae train    10 RMSprop steps of `feature_distill_step` on that model
                 with `feature_matching_loss`, bf16, batch 16, on synthetic
                 (96, 512) trials cropped to [20, 480) against 384-d teacher
                 features, then one no-grad forward: finite losses, K1 twice
                 a step and K2g once (the loss reads only the encoded latent,
                 so only the encoder's backward runs: a cotangent at every
                 t, no dx), K4 twice in the forward, each K1 and K4 as one
                 input product and one cluster scan; ms/step, and K1, K4 and
                 K2g (its scan and products apart) against their plain
                 versions and cuDNN at both widths
 11. fwd paths   K1/K4's layer-by-layer path (the input product, then the
                 recurrence on a thread-block cluster) at the autoencoder's
                 widths, B = 16 and 13, f32 and bf16: K1 against its plain
                 version, and each piece alone at every cluster size the
                 width fits; `[fwd paths]`: K1, K3, K4 and K10 through
                 `lstm_fwd_kernel`, K1 and K4 through the layer-by-layer
                 path at each cluster size, and all four through the
                 wavefront forward and its split layer where they fit (K1
                 and K3 on the split: a record, not routed), at the shapes
                 that set `fwd_path` (both autoencoder widths and the CLI's
                 B = 16, bf16 and f32, the bench step's B = 1024 and the
                 validation's B = 960, bf16, and the DINO-LSTM's widths at
                 B = 1024 and 16, T = 300); the two pieces
                 alone against plain and the
                 library call at the encoder's width
 12. rc          K10/K11 (`lstm_stack_rc`, the recompute backward) and K4
                 against their plain versions, f32 and bf16, every output,
                 at C = H = 96, L = 2, T = 460 (B = 1024 and 13; in bf16
                 K10 and K4 on the wavefront forward) and the DINO-LSTM
                 backbone's C 96, H 128, L 4, T = 300 (B = 1024, 16 and 13;
                 in bf16 K10 and K4 on its split layer); K11's three
                 pieces (gate products, scans that form the residuals and
                 hand on carries, products) alone against their plain
                 versions over every
                 time chunk and layer at B = 1024; the lab's rcstack at
                 B = 1024, bf16, both shapes: ms and peak memory of the
                 gradient of sum h_top[T-1]^2 in x and the weights through
                 the shipped stack (K1 + K2g, K2g's scans and products
                 apart), the recompute stack and cuDNN; K10, K11 and K11's
                 pieces alone against plain and cuDNN; K11's ms and peak at
                 each time chunk (`[rc chunks]`); K10 and K4 beside
                 `lstm_fwd_kernel`; at both widths one grad call launches
                 K10 and K11 once (each piece once a chunk and layer), a
                 no-grad call K4, K10 and K4 on the wavefront forward
                 (`fwd_wave`, headline) or its split layer
                 (`fwd_wave_split`, DINO)
 13. scan        K12-K14 (`lstm_scan`, one layer over a precomputed x_proj)
                 and its two gradients against the plain versions at T =
                 460, H = 96, B = 1024, 16 and 13, f32 and bf16 (in bf16 K12
                 and K13 on the scan's wavefront forward, in f32 on
                 scan_fwd_kernel), and the library call (cuDNN nn.LSTM(4H,
                 H) with weight_ih = I over x_proj) against them in f32; in
                 bf16 the wavefront forward with one and with two CTAs a
                 tile against its plain composition (`_scan_wave_ref`) and
                 the plain versions, and K14 on its residuals; the lab's
                 baseline (forward, forward + backward of sum h_all) through
                 kernels and plain versions; each kernel alone against plain
                 and cuDNN; `[scan paths]`: K12 and K13 through
                 scan_fwd_kernel and the wavefront forward with one and two
                 CTAs a tile at B = 1024, 16 and 2048, bf16; in bf16 and in f32
                 one grad call launches K13 and K14 once, a no-grad call
                 K12, in bf16 both on the wavefront forward
                 (`scan_fwd_wave` or `scan_fwd_wave_split`)
 14. lstm family K1, K2 and K3 against their plain versions, f32 and bf16, at
                 the LSTM CLI family's shapes: the DINO-LSTM backbone (C 96,
                 H 128, L 4) over its crops, B = 16, T = 300 and B = 32,
                 T = 200; `lstm_distill`'s C = H = 96, L = 4 and the
                 Spampinato rig's C = H = 128, L = 4, B = 16, T = 460; K3
                 also at the eval's gallery (B = 320, C 96, H 128) and at
                 `lstm_distill`'s validation gallery; `lstm_distillation.main`
                 at its full-width defaults (Model(96, 128, 4) + DINOHead
                 128 -> 384, 2 x 300 + 4 x 200 crops, batch 8, bf16) on 40
                 classes x 10 trials for 2 epochs: finite losses,
                 checkpoint.pth, log.txt, and every step 2 K1, 2 K2 and 1 K3;
                 the eval CLI on that checkpoint (its teacher's backbone, K3
                 on h[T-1]) and on phase 4's weights: the three score files,
                 finite R/P, K3 for the gallery and the query; `lstm_distill`
                 and the Spampinato trainer for 2 epochs; `[lstm dino step]`
                 (ms/step, windows/s), `[lstm dino profile]` (device time by
                 part, the teacher's K3 apart, the idle share) and `[lstm
                 family timing]` (each kernel at each shape against plain,
                 bound and cuDNN)
 15. analysis    `[analysis greedy]`: discover_channels at the Spampinato
                 scale (40 x 300 trials of 128 channels, 460 samples: 9600
                 gallery and 2400 query trials, D 11.8 GB), 4 channels, D
                 resident and in 16-channel chunks: the same channels and
                 recalls, seconds per iteration, peak memory; `[analysis
                 sweep]`: the best-window sweep (width 1) at the Perils size
                 (40 x 50 trials, 96 channels), brain_map and
                 save_channelwise_outputs on it; `[dino retrieval]`: K5 and
                 K7 against plain at ViT-Ti/16's shapes, DinoModel on the
                 card against the CPU, eeg_retrieval_dino at its defaults
                 (ViT-Ti/16, DINOHead to 65536, 40 x 10 trials) with random
                 weights and a vit_small/8 checkpoint, 24 K5 and 24 K7 each;
                 `[attention maps]`: visualize_attention --threshold 0.6;
                 `[flash]`: K15 (`flash_mha` on K5/K6's attention cores)
                 against plain and `Attention`'s softmax path at main_dino's
                 globals, f32 and bf16, its time against SDPA's flash
                 kernels and by device time, and two main_dino steps with
                 --use_flash true --use_fused_attn false (12 core launches
                 a global view forward)
 16. teacher     `[teacher kernels]`: K5 and K7 with LayerScale (gammas
                 U(0.5, 1.5) folded into proj and fc2), f32, against their
                 plain versions and timed at the DINOv2 ViT-S/14's shapes
                 (B 64, N 257 at 224 px; B 40, N 1370 at 518 px) and at
                 noise_probe's ViT-Ti/16 (B 16, N 17); `[teacher features]`:
                 extract_features --teacher dinov2_jax from a random hub dict
                 written to a local .pth, 40 x 8 images at 224 px (5 batches
                 of 64) and 40 x 1 at 518 px: finite (N, 384) features in
                 label order, 12 K5 and 12 K7 a batch, one batch at each size
                 against the unfused model on the card; --teacher dino_ckpt
                 (vit_small/8, export_dino_pth) and random_vit; `[noise
                 probe]`: noise_probe at its defaults, a finite JSON, 24 K5
                 and 24 K7; `[hub]`: every hub name with random weights on 8
                 images at 224 px (the feature widths; the 5 ViTs through
                 K5/K7), a ViT and an XCiT from the local cache directory
                 equal to the model of the same dict, XCiT-S12/16 and
                 DINOv2 ViT-S/14 timed at B = 64; `[dino images]`: two
                 dino_vit_train steps with stimulus-image local crops at
                 main_dino's defaults (36 K5/K7 and 24 K6/K8 a step), the
                 crops on the card against the CPU
 17. trainers    stock PyTorch, no kernel of this repo: `[barlow]`:
                 `barlow_train.main` at its defaults (2 x ResNet-50,
                 projector 8192-8192-8192, n_mels 224, 224 px, B 16, f32,
                 cuDNN TF32 on) on 40 x 4 synthetic trials for 2 epochs of
                 10 steps: finite losses, ms/step and pairs/s, the corpus
                 spectrogram's seconds and peak, checkpoint.pt reloaded and
                 forwarding as the trained model, one step on the card
                 against the CPU (loss 1e-4, TF32 off; gradients against
                 the CPU's f64 step no worse than twice the CPU's f32);
                 `[barlow remat]`: one step at B = 64 with and without the
                 nested remat (loss and statistics within 1e-5, the peaks);
                 `[barlow profile]`: 5 steps under torch.profiler (device
                 time by part, top kernels, idle share, host ops);
                 `[conformer]`: `conformer_train.main --synthetic` at its
                 defaults (emb 40, depth 6, out 384, batch 72, 22 x 1000,
                 bf16) for 50 epochs: finite losses, best accuracy above
                 chance, its three files, ms/epoch, one f32 step on the
                 card against the CPU (likewise)
 18. multi-gpu   torch.distributed on the card. `[nccl]`: `cerebra_torch.cli.launch
                 --nproc 1` of a script that brings up init_distributed's
                 NCCL group (a world of one: this machine has one card),
                 all-reduces, all-gathers and barriers CUDA tensors, then
                 runs lstm_distill_from_dinov2_train's main for one epoch.
                 One world of two ranks, gloo on cuda:0 for both (NCCL
                 refuses two ranks on one GPU; on a machine of W > 1
                 cards, W ranks over NCCL, one a card): `[mg trainer]`:
                 lstm_distill_from_dinov2_train at full width (40 x 30
                 trials of (96, 512), C = H = 96, L = 2, F = 384, global
                 batch 16, bf16) for 6 epochs (the CLI validates at epoch
                 5): K1/K2 at every step and K3 at the validation on both
                 ranks, one loss stream, bit-identical weights, f32
                 gradients; `[mg steps]`: one f32 step over the two ranks
                 against one process on the same 16 rows, TF32 off, for
                 the feature-distill step, the Barlow step (SyncBN) and the
                 Conformer step (dropout masks replayed): the loss within
                 1e-5 relative, every gradient within 1e-5 relative
                 Frobenius (Barlow's f32 gradients within 1e-2, as f32
                 rounds up to ~1e-2 of them on either side, and all within
                 1e-5 in f64); `[mg main_dino]`: main_dino at its full-width
                 defaults over the two ranks (4 a rank), 4 steps (2 at W =
                 4): K5-K8 in
                 all 12 blocks on both ranks, finite losses, one center;
                 `[mg head]`: the DINO head (out_dim 65536, f32) sharded
                 over a model axis of 2 (W) against the unsharded head: the
                 loss, the replicated parameters' gradients and the
                 gathered last-layer gradient within 1e-5 relative. On W >=
                 4 cards (W even), `[mg tp+ddp]`: one DINO-LSTM step over a
                 (2, W/2) mesh (DDP over data, prototypes over model)
                 against one process, loss and gradients within 1e-5. Each
                 part prints its ms/step; two ranks on one card are no
                 scaling figure.
 19. remainder   `[sos scan]`: the IIR cascade kernel (csrc/sos_scan.cu)
                 against its plain loop on the card in f32, forward and
                 reversed, at remove_noise's lanes (64 x 96 trials, 512
                 samples + padding, Butterworth 1-50 Hz at 1000 Hz) and at
                 T = 4096; filtfilt in f64 against scipy's sosfiltfilt on
                 the host over (137, 152 k); ms against the plain loop,
                 the bound (bytes and the serial chain), scipy's host time,
                 2 launches a filtfilt. `[ingest]`: convert_to_pth on the
                 card over a 137-channel (128 EEG + 8 EXG + Status) 4096 Hz
                 BDF of 200 stimulus events (~125 MB) written by the
                 port: the native and numpy readers bit-equal, the .pth
                 loaded back (200 x 128 x 512), filtfilt_fft against the
                 exact filtfilt's payload, seconds a stage. `[denoise]`:
                 remove_noise, remove_noise_with_ica (n = 20; three trials
                 against a host f64 projection) and band_powers over a
                 (2000, 512, 96) f32 corpus: ms and peak memory.
                 `[transforms]`: lstm_features (K3), autoencoder_reconstruct
                 (K4) and dino_features (K5/K7 in every block) on 40 x 30
                 trials, each against its model's plain path on the CPU.
                 `[tsne]`: get_tsne_for_raw_eeg --synthetic on the card
                 (40 x 30 trials of 460 x 96): its PNG, KL, seconds
Every timing line gives the kernel's ms, its plain version's, its bound (the
larger of its matrix-product operations over the H100's peak and its bytes,
each input read and each output written once, over 3.35 TB/s) and the ms of
the one PyTorch call that computes the same function, or none (the cuDNN
calls: the median of five windows, each logged with its spread). A `[phases]`
line after each phase gives its seconds. The line before the last is a JSON
object of per-kernel results; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# phases 1-17 run each training CLI as one rank on cuda:0: its --devices 0
# default means every local card, and on a machine of several a CLI's main
# would run itself as that many ranks and return None
ONE_CARD = ["--devices", "1"]
T_RAW, T_LO, T_HI, C, H, L, F, N_CLASSES = 512, 20, 480, 96, 96, 2, 384, 40
T = T_HI - T_LO
SOURCE = "cerebra_torch/csrc/lstm_stack.cu"
REPLACES = {
    "fwd_train": "cerebra/models/pallas_lstm_stack.py:121",
    "bwd": "cerebra/models/pallas_lstm_stack.py:239",
    "fwd_infer_last": "cerebra/models/pallas_lstm_stack.py:755",
    "stack_bwd_scan": "cerebra/models/pallas_lstm_stack.py:282",
    "stack_bwd_products": "cerebra/models/pallas_lstm_stack.py:305",
}
# Tolerances of the LSTM kernels. f32 values by max-abs: both sides run the
# same f32 algebra and differ only in the order of the dot products. f32
# weight gradients and dx by relative Frobenius: sums of T*B terms in another
# order. Every bf16 output by relative Frobenius: a sum that lands the other
# side of a bf16 rounding moves that element by an ulp (2^-8 relative) and
# the recurrence carries it on. First set at 1e-4, 1e-4 and 2e-2, then
# tightened to 20x over what K1-K3 showed on an H100 (C = H = 96, L = 2: at
# most 2.4e-7, 4.3e-7, 1.5e-4). K4 and K2g at the autoencoder's widths show
# more (at most 1.2e-6, K4 at C 384 / H 96; 6.8e-7 and 1.3e-3, K2g's dx at
# C 96 / H 384): margins of 8x, 15x and 3.9x.
TOL_F32_ABS = 1e-5
TOL_F32_GRAD_REL = 1e-5
TOL_BF16_REL = 5e-3

VIT_SOURCES = {"vit_attn_fwd": "cerebra_torch/csrc/vit_attn.cu",
               "vit_attn_bwd": "cerebra_torch/csrc/vit_attn.cu",
               "vit_mlp_fwd": "cerebra_torch/csrc/vit_mlp.cu",
               "vit_mlp_bwd": "cerebra_torch/csrc/vit_mlp.cu"}
REPLACES.update({
    "vit_attn_fwd": "cerebra/models/pallas_vit_attn.py:80",
    "vit_attn_bwd": "cerebra/models/pallas_vit_attn.py:106",
    "vit_mlp_fwd": "cerebra/models/pallas_vit_mlp.py:118",
    "vit_mlp_bwd": "cerebra/models/pallas_vit_mlp.py:135",
})
D_VIT, H_VIT, F_VIT = 384, 6, 1536  # ViT-S
VIT_SHAPES = ((16, 785), (32, 145), (3, 37))  # (sequences, tokens): globals, locals, ragged
# Tolerances of the ViT kernels, for the reasons of the LSTM limits above: the
# same formulas and rounding points on both sides, sums in another order (dW
# sums over up to 12,560 rows; the bf16 products on the tensor cores), and a
# bf16 rounding that can land on the other side for one element. First set
# at 1e-4 / 1e-4 / 2e-2; an H100 showed at most 1.5e-5 (f32 values, K7,
# whose outputs reach ~10), 1.1e-6 (f32 gradients) and 6.3e-4 (bf16, K6
# dWqkv). f32 values keep 1e-4 (6.8x); the others were tightened to ~20x.
# With K5/K6's attention cores on mma.sync (ex2 and a per-row 1/l in the
# softmax) the worst case read 1.2e-6 (f32 values, K5), 1.1e-6 (f32
# gradients, K6 dg) and 6.3e-4 (bf16, K6 dWqkv); the cores alone at most
# 1.1e-4 (bf16, relative).
TOL_VIT = (1e-4, 2e-5, 1.5e-2)

# The recurrent autoencoder: 1-layer LSTMs at its encoder and decoder widths
# (C, H), L = 1, over T = 460; the LSTM tolerances hold for K4 and K2g.
AE_SHAPES = {"encoder": (96, 384), "decoder": (384, 96)}
E_AE, B_AE = 384, 16
# Tolerances of the full-width RecurrentAutoencoder(460, 96, 384), every
# gradient of a loss on both outputs, kernels against plain. Its bf16 chain
# (the decoder's dx over 460 repeated latents, summed, then 460 encoder
# steps) carries flipped roundings further than one kernel. On an H100 over
# five seeds the sound run read at most 6.7e-7 (f32) and 3.4e-3 (bf16);
# planted faults read, in bf16: one step of the decoder's dx dropped
# 2.7e-2, one batch row's dx dropped 0.23, the cotangent's first step
# dropped 2.3e-2; a half-ulp low bias on dx 7.2e-3, on dW_ih 5.2e-3;
# against the f32 plain versions (a precision control) 6.7e-3. In f32 every
# fault read 3.9e-3 or more. 5e-3 lies between the sound bf16 drift and the
# faults; the f32 check is the sharp one.
TOL_AE = (TOL_F32_ABS, 1e-5, 5e-3)
REPLACES.update({
    "fwd_infer": "cerebra/models/pallas_lstm_stack.py:196",
    "bwd_general": "cerebra/models/pallas_lstm_stack.py:239",
    # K1/K4's layer-by-layer path: the input's product and the recurrence
    # (h·W_hh and the cell) of the bodies at :121 and :196
    "fwd_in_product": "cerebra/models/pallas_lstm_stack.py:140",
    "fwd_cluster_scan": "cerebra/models/pallas_lstm_stack.py:141",
    # the wavefront forward: K1's body (:121) and, without residuals, K3's
    # (:755, the fwd_infer_last entry)
    "fwd_wave": "cerebra/models/pallas_lstm_stack.py:121",
})
# The shapes whose timings set fwd_path, (B, C, H, L, T): both autoencoder
# widths, the LSTM CLI's step, bench.py's step and the CLI's validation, and
# the DINO-LSTM backbone's widths (C 96, H 128, L 4) over its 300-sample
# crops at the bench batch and the CLI's 16.
FWD_SHAPES = ((B_AE, *AE_SHAPES["encoder"], 1, T), (B_AE, *AE_SHAPES["decoder"], 1, T),
              (16, C, H, L, T), (1024, C, H, L, T), (960, C, H, L, T), (1024, 96, 128, 4, 300),
              (16, 96, 128, 4, 300))

# The recompute-backward stack (K10, K11) at the headline Perils widths and
# at the DINO-LSTM backbone's depth and width (lstm_distillation's
# Model(96, 128, 4) over 300-sample global crops): (T, C, H, L).
RC_SHAPES = {"headline": (460, 96, 96, 2), "dino": (300, 96, 128, 4)}
# The per-layer scan (K12-K14) at the Perils width, T = 460, B = 1024.
H_SCAN, B_BIG = 96, 1024
SCAN_SOURCE = "cerebra_torch/csrc/lstm_scan.cu"
# Limits for holding the scan's library call (nn.LSTM(4H, H) with weight_ih =
# I) against the plain versions in f32: it only has to show that the call
# computes the same function, and cuDNN sums in its own order, so they are
# ten times the kernels' f32 limits.
TOL_CUDNN_SCAN = (1e-4, 1e-4, TOL_BF16_REL)
REPLACES.update({
    "fwd_train_rc": "cerebra/models/pallas_lstm_stack.py:154",
    # K10 and K4 on the wavefront forward (K4 at the headline widths) and
    # its split layer (both at the DINO widths)
    "fwd_infer_wave": "cerebra/models/pallas_lstm_stack.py:196",
    "fwd_train_rc_split": "cerebra/models/pallas_lstm_stack.py:154",
    "fwd_infer_split": "cerebra/models/pallas_lstm_stack.py:196",
    "bwd_rc": "cerebra/models/pallas_lstm_stack.py:318",
    "rc_gates": "cerebra/models/pallas_lstm_stack.py:361",
    "rc_scan": "cerebra/models/pallas_lstm_stack.py:366",
    "rc_products": "cerebra/models/pallas_lstm_stack.py:392",
    "scan_fwd_infer": "cerebra/models/pallas_lstm.py:99",
    "scan_fwd_train": "cerebra/models/pallas_lstm.py:126",
    "scan_bwd": "cerebra/models/pallas_lstm.py:167",
    # K12 and K13 on the scan's wavefront forward (bf16); the rows above are
    # scan_fwd_kernel's (f32)
    "scan_fwd_infer_wave": "cerebra/models/pallas_lstm.py:99",
    "scan_fwd_train_wave": "cerebra/models/pallas_lstm.py:126",
})
SCAN_KERNELS = ("scan_fwd_infer", "scan_fwd_train", "scan_bwd", "scan_fwd_infer_wave",
                "scan_fwd_train_wave")

# The least time the card could take for a kernel's work: the larger of its
# operations over the H100 SXM's published peak (989 TFLOP/s on the bf16
# tensor cores, 67 TFLOP/s in f32 outside them) and its bytes (each input
# read once, each output written once) over 3.35 TB/s.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(gpu)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")
    return gpu


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from cerebra_torch.kernels import _build

    names = ("lstm_stack", "lstm_scan", "vit_attn", "vit_mlp", "sos_scan")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(_build.build, names))
    for so, seconds in built:
        log(f"[build] {os.path.relpath(so, ROOT)} in {seconds:.2f} s")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")


def make_stack(B: int, dtype: torch.dtype, seed: int, C: int = C, H: int = H, L: int = L,
               T: int = T):
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).to("cuda", dtype)

    x = torch.randn(T, B, C, generator=gen).to("cuda", dtype)
    layers = [(u(C if l == 0 else H, 4 * H), u(H, 4 * H), u(4 * H)) for l in range(L)]
    g = torch.randn(B, H, generator=gen).to("cuda", dtype)
    return x, layers, g


def compare(what: str, got: torch.Tensor, want: torch.Tensor, dtype, grad: bool,
            tols=(TOL_F32_ABS, TOL_F32_GRAD_REL, TOL_BF16_REL), quiet: bool = False) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    max_abs = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    f32_abs, f32_grad_rel, bf16_rel = tols
    if dtype == torch.float32 and not grad:
        ok, limit = max_abs <= f32_abs, f"max_abs <= {f32_abs}"
    elif dtype == torch.float32:
        ok, limit = rel <= f32_grad_rel, f"rel_frob <= {f32_grad_rel}"
    else:
        ok, limit = rel <= bf16_rel, f"rel_frob <= {bf16_rel}"
    if not (quiet and ok):
        log(f"[parity] {what}: max_abs {max_abs:.3e} rel_frob {rel:.3e} ({limit}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({limit})")
    return max_abs


def check_bwd_pieces(g, x, layers, res, tag: str, dtype) -> tuple:
    """K2's two pieces alone against their plain versions, each layer on
    the plain pieces' inputs: the reverse scan (the top layer under g at
    T-1, the one below under the f32 chain) and the products (the chain
    `gup` above layer 0, dx at layer 0). → (scan error, products error)."""
    from cerebra_torch.models import lstm_stack as ls

    h_all, prefac, qf = res
    cot, es, ep = g, 0.0, 0.0
    for l in reversed(range(len(layers))):
        w_ih, w_hh, _ = layers[l]
        dg = ls._scan_bwd_ref(cot, prefac[l], qf[l], w_hh)
        es = max(es, compare(f"K2 scan[{l}] {tag}", ls.bwd_scan(cot, prefac[l], qf[l], w_hh), dg,
                             dtype, True))
        chain = "gup" if l > 0 else "dx"
        args = (dg, x if l == 0 else h_all[l - 1], h_all[l], w_ih, chain)
        want = ls._products_ref(*args)
        ep = max(ep, max(compare(f"K2 products[{l}] {n} {tag}", a, b, dtype, True)
                         for n, a, b in zip(("dW_ih", "dW_hh", "db", chain),
                                            ls.bwd_products(*args), want)))
        cot = want[3]
    return es, ep


def phase_parity() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[parity] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    errs, e_wave = {}, 0.0
    ls.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1024, 16, 13):
            tag = f"{str(dtype).split('.')[-1]} B={B}"
            x, layers, g = make_stack(B, dtype, seed=B)
            e3 = compare(f"K3 h[T-1] {tag}", ls.fwd_infer_last(x, layers),
                         ls._fwd_infer_last_ref(x, layers), dtype, False)
            want = ls._fwd_train_ref(x, layers)
            got = ls.fwd_train(x, layers)
            torch.cuda.synchronize()
            e1 = max(compare(f"K1 {name} {tag}", a, b, dtype, False)
                     for name, a, b in zip(("h_all", "prefac", "qf"), got, want))
            # K2 on the plain forward's residuals, so it is checked alone
            _, got_g = ls.bwd(g, x, layers, *want)
            _, want_g = ls._bwd_ref(g, x, layers, *want)
            e2 = max(compare(f"K2 {name}[{l}] {tag}", a, b, dtype, True)
                     for l in range(L)
                     for name, a, b in zip(("dW_ih", "dW_hh", "db"), got_g[l], want_g[l]))
            # and on K1's own residuals, against the plain K2 on the plain ones
            _, own_g = ls.bwd(g, x, layers, *got)
            for l in range(L):
                for name, a, b in zip(("dW_ih", "dW_hh", "db"), own_g[l], want_g[l]):
                    compare(f"K2 on K1's residuals {name}[{l}] {tag}", a, b, dtype, True)
            es, ep = check_bwd_pieces(g, x, layers, want, tag, dtype)
            if dtype == torch.bfloat16:
                e_wave = max(e_wave, e1, e3)
            if dtype == torch.bfloat16 and B == 16:
                errs = {"fwd_train": e1, "bwd": e2, "fwd_infer_last": e3,
                        "stack_bwd_scan": es, "stack_bwd_products": ep}
            del x, layers, g, want, got, got_g, want_g, own_g
    x, layers, _ = make_stack(960, torch.bfloat16, seed=960)
    e_wave = max(e_wave, compare("K3 h[T-1] bfloat16 B=960", ls.fwd_infer_last(x, layers),
                                 ls._fwd_infer_last_ref(x, layers), torch.bfloat16, False))
    torch.cuda.synchronize()
    # the bf16 K1 and K3 calls above (3 batches, and K3 at 960) run the
    # wavefront forward, one launch each; f32 keeps lstm_fwd_kernel
    want_wave = sum(2 for B in (1024, 16, 13)
                    if ls.fwd_path(B, C, H, L, torch.bfloat16, "fwd_train") == "wave") + 1
    log(f"[parity] fwd_wave launches {ls.LAUNCHES['fwd_wave']} (expected {want_wave}); "
        f"wavefront clusters the card holds at once at C = H = {H}, L = {L}: "
        f"{ls.wave_clusters(C, H, L)}")
    if ls.LAUNCHES["fwd_wave"] != want_wave:
        raise AssertionError(f"bf16 K1/K3 bypassed the wavefront forward: {ls.LAUNCHES}")
    errs["fwd_wave"] = e_wave
    return errs


def phase_main() -> dict:
    from cerebra_torch.cli.lstm_distill_from_dinov2_train import main
    from cerebra_torch.models import Model
    from cerebra_torch.models import lstm_stack as ls

    log_dir = os.path.join(ROOT, "build", "chip_smoke", "cli")
    pth = os.path.join(log_dir, "lstm_dinov2_best_loss.pth")
    if os.path.exists(pth):
        os.remove(pth)
    argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "30",
            "--feature_dim", "384", "--num_epochs", "6", "--batch_size", "16",
            "--device", "cuda", "--log_dir", log_dir] + ONE_CARD
    ls.reset_launches()
    t0 = time.perf_counter()
    _, hist = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ls.LAUNCHES)
    n_train = int(40 * 30 * 0.8)
    steps = 6 * -(-n_train // 16)
    log(f"[main] {seconds:.1f} s, {steps} train steps, launches {launches}")
    losses = hist["train_loss"]
    if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses not all finite: {losses}")
    if [e for e, _ in hist["recall"]] != [5] or [e for e, _ in hist["precision"]] != [5]:
        raise AssertionError(f"no epoch-5 validation: {hist['recall']}")
    log(f"[main] epoch-5 R {hist['recall'][0][1]:.2f} P {hist['precision'][0][1]:.2f}; "
        f"windows/s per epoch {[round(w, 1) for w in hist['windows_per_s']]}")
    model = Model(C, H, L, F, n_classes=N_CLASSES)
    model.load_state_dict(torch.load(pth, map_location="cpu"), strict=True)
    log(f"[main] {os.path.relpath(pth, ROOT)} reloads with strict=True")
    if (launches["fwd_train"] < steps or launches["bwd"] < steps
            or min(launches["stack_bwd_scan"], launches["stack_bwd_products"]) < L * steps):
        raise AssertionError(f"train steps bypassed the kernels: {launches} for {steps} steps")
    if launches["fwd_infer_last"] == 0:
        raise AssertionError("kernel fwd_infer_last never launched on the main path")
    path = ls.fwd_path(16, C, H, L, torch.bfloat16, "fwd_train")
    if path == "cluster" and min(
            launches["fwd_in_product"], launches["fwd_cluster_scan"]) < L * steps:
        raise AssertionError(f"K1 bypassed its layer-by-layer pieces: {launches}")
    # K1 at every step and K3 at every validation run the wavefront forward
    if (path == "wave" and ls.fwd_path(960, C, H, L, torch.bfloat16, "fwd_infer_last") == "wave"
            and launches["fwd_wave"] < launches["fwd_train"] + launches["fwd_infer_last"]):
        raise AssertionError(f"K1/K3 bypassed the wavefront forward: {launches}")
    return launches


def time_windows(fn, reps: int, windows: int, warmup: int) -> tuple:
    """(median, least, most) ms per call over `windows` windows of `reps`
    calls each, by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    per_call.sort()
    return per_call[len(per_call) // 2], per_call[0], per_call[-1]


def time_ms(fn, reps: int) -> float:
    """ms per call over one window of `reps` calls after one warm-up call."""
    return time_windows(fn, reps, 1, 1)[0]


def nbytes(*tensors) -> int:
    """Bytes of the tensors in possibly nested tuples and lists (None: 0)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def stack_flops(T: int, B: int, C: int, H: int, L: int, fwd: bool = True, bwd: bool = False,
                need_dx: bool = False) -> int:
    """Matrix-product operations of an LSTM stack over (T, B): the forward's
    x·W_ih + h·W_hh; the backward's dW_ih and dW_hh, dh = dgates·W_hhᵀ and
    the chain dgates·W_ihᵀ to each layer below (and to dx). The cell math is
    a few elementwise operations a value and is not counted."""
    G = 4 * H
    ins = [C] + [H] * (L - 1)
    gates = 2 * T * B * sum((n + H) * G for n in ins)
    flops = gates if fwd else 0
    if bwd:
        flops += gates + 2 * T * B * G * (H * L + H * (L - 1) + (C if need_dx else 0))
    return flops


def timing_row(kern, plain, inputs, flops: int, dtype, reps: int = 5, plain_reps: int = 2,
               library=None) -> dict:
    """ms of the kernel's wrapper and of its plain version (CUDA events after a
    warm-up call), the bound from `flops` and the bytes of `inputs` and of
    the kernel's outputs, and `library`, the ms of one PyTorch call that
    computes the same function, or None where there is none."""
    out = kern()
    moved = nbytes(inputs) + nbytes(out)
    del out
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], moved / HBM_BYTES_PER_S
    return {"ms": time_ms(kern, reps), "plain_ms": time_ms(plain, plain_reps),
            "bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops > t_mem else "bytes", "library_ms": library}


def bwd_pieces(g, x, layers, res, need_dx: bool) -> dict:
    """K2/K2g's two sides as `bwd` runs them, each over every layer: the
    reverse scans (each under the cotangent it gets there: g at the top,
    the f32 chain below) and the products, with those cotangents and dgates
    computed once beforehand. → {"scan" | "products": (kernel call, plain
    call, inputs, matrix-product operations)}."""
    from cerebra_torch.models import lstm_stack as ls

    h_all, prefac, qf = res
    T_, B, C_ = x.shape
    L_, H_ = len(layers), layers[0][1].shape[0]
    cots, dgs, chains = [None] * L_, [None] * L_, [None] * L_
    cot = g
    for l in reversed(range(L_)):
        cots[l] = cot
        dgs[l] = ls.bwd_scan(cot, prefac[l], qf[l], layers[l][1])
        chains[l] = "gup" if l > 0 else ("dx" if need_dx else None)
        cot = ls.bwd_products(dgs[l], x if l == 0 else h_all[l - 1], h_all[l], layers[l][0],
                              chains[l])[3]

    def scans(fn):
        return lambda: [fn(cots[l], prefac[l], qf[l], layers[l][1]) for l in range(L_)]

    def products(fn):
        return lambda: [fn(dgs[l], x if l == 0 else h_all[l - 1], h_all[l], layers[l][0],
                           chains[l]) for l in range(L_)]

    G, ins = 4 * H_, [C_] + [H_] * (L_ - 1)
    # the scan's dh = dgates·W_hhᵀ; the products' dW_ih, dW_hh and chain
    scan_ops = 2 * T_ * B * G * H_ * L_
    prod_ops = sum(2 * T_ * B * G * (n + H_ + (n if chains[l] else 0)) for l, n in enumerate(ins))
    return {"scan": (scans(ls.bwd_scan), scans(ls._scan_bwd_ref),
                     (cots, prefac, qf, [w[1] for w in layers]), scan_ops),
            "products": (products(ls.bwd_products), products(ls._products_ref),
                         (dgs, x, h_all, [w[0] for w in layers]), prod_ops)}


def bwd_piece_rows(g, x, layers, res, need_dx: bool, reps: int = 5,
                   plain_reps: int = 2) -> dict:
    """Timing rows of `bwd_pieces`' two sides; library none: no one
    PyTorch call computes L scans chained through the products, or the
    products."""
    return {k: timing_row(kern, plain, inputs, ops, x.dtype, reps, plain_reps)
            for k, (kern, plain, inputs, ops) in bwd_pieces(g, x, layers, res, need_dx).items()}


def fmt_row(row: dict) -> str:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
    return (f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library {lib}")


@functools.lru_cache(maxsize=None)
def cudnn_dtype() -> torch.dtype:
    """bf16 where torch.nn.LSTM runs cuDNN (aten::_cudnn_rnn) in bf16, else
    fp16: PyTorch's RNN takes the cuDNN path only for dtypes cuDNN accepts,
    and otherwise loops over time itself."""
    from torch.profiler import ProfilerActivity, profile

    lstm = torch.nn.LSTM(8, 8).to("cuda", torch.bfloat16)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        lstm(torch.zeros(3, 2, 8, device="cuda", dtype=torch.bfloat16))
    bf16 = any("cudnn_rnn" in e.key for e in prof.key_averages())
    dt = torch.bfloat16 if bf16 else torch.float16
    log(f"[cudnn] torch.nn.LSTM in bf16 runs cuDNN: {bf16}; the library column times "
        f"{str(dt).split('.')[-1]} (cuDNN {torch.backends.cudnn.version()})")
    return dt


def cudnn_lstm(C: int, H: int, L: int, dtype: torch.dtype, scan: bool) -> torch.nn.LSTM:
    """torch.nn.LSTM(C, H, L) on the card. scan: one layer whose input is
    lstm_scan's x_proj (C = 4H) itself, weight_ih = I (4H x 4H) and zero
    biases, so that its output is lstm_scan's h_all, its input gradient the
    dgates stream and its weight_hh gradient dW_hh transposed (gate order
    [i, f, g, o] in both; phase_scan holds it against the plain versions)."""
    lstm = torch.nn.LSTM(C, H, num_layers=L).to("cuda", dtype)
    if scan:
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(torch.eye(4 * H))
            lstm.bias_ih_l0.zero_()
            lstm.bias_hh_l0.zero_()
    return lstm


def cudnn_ms(T: int, B: int, C: int, H: int, L: int, which: str, reps: int = 5,
             scan: bool = False, dtype=None) -> float:
    """ms of the one PyTorch call that computes what an LSTM kernel computes:
    torch.nn.LSTM (cuDNN) at the same T, B, C, H, L, in `dtype` (default
    `cudnn_dtype()`); `scan` as `cudnn_lstm`. which: "infer" the no-grad
    forward (K3 reads h_n, K4 and K12 the output, one call gives both);
    "train" the forward under grad (K1, K10, K13); "bwd_last" the backward of
    a loss on h_n (K2); "bwd_seq" the backward of a loss on the output, with
    dx (K2g, K11, K14; cuDNN computes dx in every backward). The median of
    five windows of `reps` calls after three warm-up calls, with cuDNN's
    autotuner off (one plan for a shape in every run); the spread is logged."""
    dt = dtype or cudnn_dtype()
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator().manual_seed(T + B + H)
    lstm = cudnn_lstm(C, H, L, dt, scan)
    x = torch.randn(T, B, C, generator=gen).to("cuda", dt).requires_grad_(which == "bwd_seq")
    params = list(lstm.parameters())
    if which == "infer":
        def call():
            with torch.no_grad():
                return lstm(x)
    elif which == "train":
        def call():
            return lstm(x)
    else:
        y, (h_n, _) = lstm(x)
        out, inputs = (h_n[-1], params) if which == "bwd_last" else (y, [x] + params)
        g = torch.randn(out.shape, generator=gen).to("cuda", dt)

        def call():
            return torch.autograd.grad(out, inputs, g, retain_graph=True)
    ms, least, most = time_windows(call, reps, 5, 3)
    log(f"[cudnn] {which}{' scan' if scan else ''} T={T} B={B} C={C} H={H} L={L} "
        f"{str(dt).split('.')[-1]}: {ms:.3f} ms, the median of 5 windows of {reps} "
        f"(spread {least:.3f}-{most:.3f} ms)")
    return ms


def phase_kernel_timing() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    out = {}
    bf16 = torch.bfloat16
    for B_train, B_val in ((16, 960), (1024, 1024)):
        x, layers, g = make_stack(B_train, bf16, seed=1)
        res = ls._fwd_train_ref(x, layers)
        xv, layers_v, _ = make_stack(B_val, bf16, seed=2)
        # name: (kernel, plain, inputs, operations, their dtype, library call ms, B)
        rows = {
            "fwd_train": (lambda: ls.fwd_train(x, layers), lambda: ls._fwd_train_ref(x, layers),
                          (x, layers), stack_flops(T, B_train, C, H, L), bf16,
                          cudnn_ms(T, B_train, C, H, L, "train"), B_train),
            "bwd": (lambda: ls.bwd(g, x, layers, *res), lambda: ls._bwd_ref(g, x, layers, *res),
                    (g, x, layers, res), stack_flops(T, B_train, C, H, L, fwd=False, bwd=True),
                    bf16, cudnn_ms(T, B_train, C, H, L, "bwd_last"), B_train),
            "fwd_infer_last": (lambda: ls.fwd_infer_last(xv, layers_v),
                               lambda: ls._fwd_infer_last_ref(xv, layers_v), (xv, layers_v),
                               stack_flops(T, B_val, C, H, L), bf16,
                               cudnn_ms(T, B_val, C, H, L, "infer"), B_val),
        }
        pieces = bwd_piece_rows(g, x, layers, res, False)
        for name, (kern, plain, inputs, flops, dt, lib, B) in rows.items():
            row = timing_row(kern, plain, inputs, flops, dt, 5, 2, lib)
            split = (f"; its {L} scans {pieces['scan']['ms']:.3f} ms, its products "
                     f"{pieces['products']['ms']:.3f} ms" if name == "bwd" else "")
            if name != "bwd":  # K1 and K3: the path taken, and lstm_fwd_kernel alone
                xs, ws = (x, layers) if name == "fwd_train" else (xv, layers_v)
                old = time_ms(lambda: ls._fwd_cuda(xs, ws, name), 5)
                split = (f"; path {ls.fwd_path(B, C, H, L, bf16, name)}, lstm_fwd_kernel "
                         f"{old:.3f} ms")
            log(f"[timing] {name} B={B} T={T} bf16: {fmt_row(row)}{split}")
            if B_train == 16:  # the CLI's shapes (train batch 16, gallery 960)
                out[name] = row
            elif name == "fwd_train":  # the bench step's K1 on the wavefront forward
                out["fwd_wave"] = row
        for side, row in pieces.items():
            log(f"[timing] stack_bwd_{side} B={B_train} T={T} bf16 (K2's {L} layers): "
                f"{fmt_row(row)}")
            if B_train == 16:
                out[f"stack_bwd_{side}"] = row
        del x, layers, g, res, xv, layers_v, pieces
    scan_tile_sweep()
    return out


def scan_tile_sweep() -> None:
    """ms of one reverse scan (`bwd_scan`, T = 460, a cotangent at every t)
    at each rows-per-block, at the shapes K2, K2g and K14 give it and at the
    DINO-LSTM's H = 128 (K2g's and K11's there), beside the tile
    `scan_tile` picks."""
    from cerebra_torch.models import lstm_scan as sc
    from cerebra_torch.models import lstm_stack as ls

    for B, h, dtype in ((16, H, torch.bfloat16), (1024, H, torch.bfloat16),
                        (1024, H, torch.float32), (16, 384, torch.bfloat16),
                        (1024, 128, torch.bfloat16)):
        gen = torch.Generator().manual_seed(B + h)
        x_proj = (torch.randn(T, B, 4 * h, generator=gen) * 0.5).to("cuda", dtype)
        w_hh = ((torch.rand(h, 4 * h, generator=gen) * 2 - 1) / math.sqrt(h)).to("cuda", dtype)
        g = torch.randn(T, B, h, generator=gen).to("cuda", dtype)
        _, prefac, qf = sc.scan_fwd_train(x_proj, w_hh)
        ms = {bt: round(time_ms(lambda: ls.bwd_scan(g, prefac, qf, w_hh, tile=bt), 3), 3)
              for bt in (1, 2, 4, 8, 16)}
        log(f"[scan tiles] B={B} H={h} T={T} {str(dtype).split('.')[-1]}: ms by rows per block "
            f"{ms}; scan_tile picks {ls.scan_tile(B, h, dtype)}")
        del x_proj, w_hh, g, prefac, qf


# kernel name fragments → the part of a step they belong to, for the
# profiler's split (first match wins)
KERNEL_PARTS = (("scan_bwd_kernel", "K2/K2g scans"), ("cluster_scan", "K1/K4 cluster scans"),
                ("gemm_tc<false, false, vit::EpiF32>", "K1/K4 input products"),
                ("gemm", "K2/K2g products"),
                ("sum_partials", "K2/K2g products"), ("col_sum_part", "K2/K2g products"),
                ("lstm_fwd_kernel", "K1 forward"), ("wave_fwd_kernel", "K1 wavefront forward"))


def device_kernels(call, n: int, check=None) -> tuple:
    """The CUDA kernels of `n` calls of `call` in launch order, each (name,
    device ms) from torch.profiler, and the host-clock ms per call to a
    synchronise (the profiler's own overhead inside it). A trace can lose
    its first kernels, so 64 small kernels and one call run ahead of the
    `n`, then a marker kernel (torch.cuda._sleep's `spin_kernel`); only the
    kernels after the marker are kept. Also the host's ops, (name, self CPU ms per call) from
    the largest, over all n + 1 calls. A trace that lost its marker, or
    whose kernel names `check` rejects (AssertionError), is taken again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.empty(1, device="cuda")
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):  # kernels for the trace to lose first
                pad.zero_()
            call()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
        try:
            if not marks:
                raise AssertionError(f"the trace holds no marker kernel among its {len(kernels)}"
                                     f" kernels, first {[e.name[:30] for e in kernels[:3]]}")
            kernels = [(e.name, e.time_range.elapsed_us() / 1e3) for e in kernels[marks[-1] + 1:]]
            if check is not None:
                check([k for k, _ in kernels])
        except AssertionError as e:
            if attempt == 2:
                raise
            log(f"[profile] trace {attempt + 1} rejected ({str(e)[:200]}); tracing again")
            continue
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / (n + 1))
                       for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda kv: -kv[1])
        return kernels, wall_ms, host


def profile_steps(step, n: int, what: str, gpu: str) -> None:
    """Device time of `n` calls of `step` by kernel (`device_kernels`),
    grouped by KERNEL_PARTS, and the device's idle share of the profiled
    wall time (host clock to a synchronise; the profiler's own overhead is
    inside it)."""
    kernels, wall_ms, _ = device_kernels(step, n)
    parts, names = {}, {}
    for name, ms in kernels:
        part = next((p for frag, p in KERNEL_PARTS if frag in name), "other")
        parts[part] = parts.get(part, 0.0) + ms / n
        names[name[:60]] = names.get(name[:60], 0.0) + ms / n
    busy = sum(parts.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] {what}: {wall_ms:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %); by part "
        f"{ {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} }; "
        f"top kernels {[(k, round(v, 3)) for k, v in top]} on {gpu}")


def phase_step_timing(gpu: str) -> None:
    from cerebra_torch.losses import feature_distribution_loss_v1
    from cerebra_torch.models import Model
    from cerebra_torch.models.lstm_stack import lstm_stack_last_ref
    from cerebra_torch.signal.filters import design_bandpass, filtfilt_matmul, zero_phase_matrix
    from cerebra_torch.train.optim import make_optimizer

    B = 1024
    dev = torch.device("cuda")
    fir = zero_phase_matrix(design_bandpass(14.0, 71.0, fs=1000.0, order=4), T_RAW,
                            num_taps=257, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.normal(size=(B, C, T_RAW)).astype(np.float32)).to(dev)
    teacher = torch.from_numpy(rng.normal(size=(B, F)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, size=B)).to(dev)

    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        model = Model(C, H, L, F, n_classes=N_CLASSES, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0))
        opt = make_optimizer("rmsprop", model.parameters(), 1e-3)

        def step():
            filtered = filtfilt_matmul(fir, raw, out_dtype=torch.bfloat16)  # (B, C, T_RAW)
            eeg = filtered.transpose(1, 2)[:, T_LO:T_HI, :]
            opt.zero_grad(set_to_none=True)
            if kind == "kernels":
                feats, cls = model(eeg)
            else:
                feats, cls = model.top(lstm_stack_last_ref(*model.lstm.prepare(eeg)))
            loss = feature_distribution_loss_v1(feats.float(), teacher, labels, cls.float(), 0.5)
            loss.backward()
            opt.step()
            return loss

        n = 5 if kind == "kernels" else 2
        loss = step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{kind} step loss is {loss.item()}")
        log(f"[step] {kind}: {dt * 1e3:.2f} ms/step, {B / dt:.1f} windows/s at B={B} "
            f"(filter + crop + LSTM fwd/bwd + RMSprop, bf16) on {gpu}")
        if kind == "kernels" and not profiled:
            profile_steps(step, 3, f"bench step B={B}", gpu)
            profiled = True


def vit_inputs(B: int, N: int, cdt, scaled: bool, seed: int):
    """f32-stream inputs of one ViT-S half-block: x and dout (B, N, D), the
    attention and MLP parameters prepared in `cdt`, and the drop-path scale
    per sequence and per row (sample 0 dropped) or None."""
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    gen = torch.Generator().manual_seed(seed)
    D, F = D_VIT, F_VIT

    def r(*shape, sc=0.05, base=0.0):
        return (torch.randn(*shape, generator=gen) * sc + base).to("cuda")

    x, dout = r(B, N, D, sc=1.0), r(B, N, D, sc=1.0)
    pa = va._prep(r(D, base=1.0), r(D), r(D, 3 * D), r(3 * D), r(D, D), r(D), H_VIT, cdt)
    pm = vm._prep(r(D, base=1.0), r(D), r(D, F), r(F), r(F, D), r(D), cdt)
    s_seq = s_rows = None
    if scaled:
        s_seq = torch.full((B,), 1 / 0.9, device="cuda")
        s_seq[0] = 0.0
        s_rows = s_seq.repeat_interleave(N).contiguous()
    return x, dout, pa, pm, s_seq, s_rows


def phase_vit_parity() -> dict:
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        for B, N in VIT_SHAPES:
            for scaled in (False, True):
                tag = f"f32/{str(cdt).split('.')[-1]} B={B} N={N}{' s' if scaled else ''}"
                x, dout, pa, pm, s_seq, s_rows = vit_inputs(B, N, cdt, scaled, seed=N)
                out, saved = va.attn_fwd(x, s_seq, pa, H_VIT)
                e5 = compare(f"K5 out {tag}", out, va._attn_fwd_ref(x, s_seq, pa, H_VIT)[0],
                             cdt, False, TOL_VIT)
                got = va.attn_bwd(dout, x, s_seq, pa, H_VIT, saved)
                want = va._attn_bwd_ref(dout, x, s_seq, pa, H_VIT)
                e6 = max(compare(f"K6 {name} {tag}", a, b, cdt, True, TOL_VIT) for name, a, b in
                         zip(("dx", "dg", "db", "dWqkv", "dbqkv", "dWp", "dbp"), got, want))
                xm, dm = x.reshape(B * N, D_VIT), dout.reshape(B * N, D_VIT)
                out, saved = vm.mlp_fwd(xm, s_rows, pm)
                e7 = compare(f"K7 out {tag}", out, vm._mlp_fwd_ref(xm, s_rows, pm)[0], cdt,
                             False, TOL_VIT)
                got = vm.mlp_bwd(dm, xm, s_rows, pm, saved)
                want = vm._mlp_bwd_ref(dm, xm, s_rows, pm)
                e8 = max(compare(f"K8 {name} {tag}", a, b, cdt, True, TOL_VIT) for name, a, b in
                         zip(("dx", "dg", "db", "dW1", "db1", "dW2", "db2"), got, want))
                if cdt == torch.bfloat16 and (B, N) == VIT_SHAPES[0] and scaled:
                    errs = {"vit_attn_fwd": e5, "vit_attn_bwd": e6, "vit_mlp_fwd": e7,
                            "vit_mlp_bwd": e8}
                del x, dout, pa, pm, out, saved, got, want
    torch.cuda.synchronize()
    return errs


def phase_main_dino() -> dict:
    from cerebra_torch.cli.main_dino import main
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    log_dir = os.path.join(ROOT, "build", "chip_smoke", "main_dino")
    log_txt = os.path.join(log_dir, "log.txt")
    if os.path.exists(log_txt):
        os.remove(log_txt)
    epochs, steps_per_epoch = 2, 10  # 40 classes x 2 trials at batch 8
    argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "2",
            "--epochs", str(epochs), "--warmup_epochs", "1", "--device", "cuda",
            "--log_dir", log_dir] + ONE_CARD
    reset_launches()
    t0 = time.perf_counter()
    state, hist = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = epochs * steps_per_epoch
    log(f"[main_dino] {seconds:.1f} s, {steps} steps, launches {launches}")
    losses = hist["loss"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"main_dino losses not all finite: {losses}")
    with open(log_txt) as f:
        lines = [json.loads(line) for line in f]
    if [row["epoch"] for row in lines] != list(range(epochs)):
        raise AssertionError(f"log.txt holds {lines}")
    if state.step != steps or tuple(state.center.shape) != (1, 65536):
        raise AssertionError(f"state after {state.step} steps, center {tuple(state.center.shape)}")
    if not torch.isfinite(state.center).all() or not all(
            torch.isfinite(p).all() for p in state.student.parameters()):
        raise AssertionError("non-finite center or student parameters")
    log(f"[main_dino] losses {[round(v, 4) for v in losses]}; windows/s per epoch "
        f"{[round(w, 2) for w in hist['windows_per_s']]}")
    # 12 blocks x (2 student view groups + 1 teacher group) forwards, 12 x 2 backwards
    for name, per_step in (("vit_attn_fwd", 36), ("vit_mlp_fwd", 36),
                           ("vit_attn_bwd", 24), ("vit_mlp_bwd", 24)):
        if launches[name] < per_step * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in {steps} steps, "
                                 f"fewer than {per_step} per step")
    del state
    torch.cuda.empty_cache()
    return launches


def label_vit(names) -> list:
    """(half-block, piece) of each kernel of the ViT half-blocks, by name in
    launch order, None for the others. K5 launches LN, the qkv product
    (`EpiBiasRound`), its attention core and the proj (`EpiResidual`); K6
    from `scale_round` to `ln_bwd_rows`, its two attention cores in the
    middle; K7 LN, fc1 (`EpiGelu`) and fc2 (`EpiResidual`); K8 from
    `mlp_bwd_dn` to `ln_bwd_rows`: dn/db2, the fused dh kernel, the dW
    contractions (`EpiPartial`), dy (`EpiF32`), the LN column partials, the
    sums of partials (`sum_jobs`) and the LN rows."""
    labels = [None] * len(names)

    def expect(i: int, frag: str) -> None:
        if not (0 <= i < len(names) and frag in names[i]):
            raise AssertionError(f"launch {i} of a ViT half-block is not {frag}: {names}")

    def nearest(i: int, frag: str, step: int) -> int:
        while 0 <= i < len(names) and frag not in names[i]:
            i += step
        expect(i, frag)
        return i

    for i, name in enumerate(names):
        if "attn_fwd" in name:
            expect(i - 2, "ln_fwd_rows")
            expect(i - 1, "EpiBiasRound")
            expect(i + 1, "EpiResidual")
            labels[i - 2:i + 2] = [("K5", "LN"), ("K5", "qkv product"),
                                   ("K5", "attention core"), ("K5", "proj")]
        elif "attn_bwd_dq" in name:
            expect(i + 1, "attn_bwd_dkdv")
            piece = "scale/dbp"
            for j in range(nearest(i, "scale_round", -1), nearest(i, "ln_bwd_rows", 1) + 1):
                for frag, p in (("attn_bwd_dq", "dq core"), ("attn_bwd_dkdv", "dk/dv core"),
                                ("EpiPartial", "dWp" if j < i else "dWqkv/dbqkv"),
                                ("EpiBiasRound", "do product"), ("EpiF32", "dy product"),
                                ("ln_bwd", "LN backward")):
                    if frag in names[j]:
                        piece = p
                        break
                labels[j] = ("K6", piece)
        elif "EpiGelu" in name and i + 1 < len(names) and "EpiResidual" in names[i + 1]:
            expect(i - 1, "ln_fwd_rows")
            labels[i - 1:i + 2] = [("K7", "LN"), ("K7", "fc1"), ("K7", "fc2")]
        elif "mlp_bwd_dn" in name:
            end = nearest(i, "ln_bwd_rows", 1)
            for j in range(i, end + 1):
                piece = next((p for frag, p in K8_PIECES if frag in names[j]), None)
                if piece is None:
                    raise AssertionError(f"launch {j} of K8 is none of its pieces: {names}")
                labels[j] = ("K8", piece)
    return labels


# K8's launches by kernel name fragment, in launch order
K8_PIECES = (("mlp_bwd_dn", "dn/db2"), ("mlp_bwd_dh", "dh"), ("EpiPartial", "dW1/dW2"),
             ("EpiF32", "dy"), ("ln_bwd_cols", "LN columns"), ("sum_jobs", "sums"),
             ("ln_bwd_rows", "LN rows"))


def split_ms(kernels, labels, n: int, key) -> dict:
    """Device ms per call of `kernels` summed by key(label)."""
    out = {}
    for (_, ms), lab in zip(kernels, labels):
        k = key(lab)
        out[k] = out.get(k, 0.0) + ms / n
    return out


def sdpa_ms(qkv, dob, B: int, N: int) -> tuple:
    """The yardstick: F.scaled_dot_product_attention at (B, H, N, dh) bf16,
    scale 1 (q carries the scale), on the flash backend, forward and forward
    + backward under the cotangent do; ms, median of three windows. The port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from cerebra_torch.models import vit_attn as va

    q, k, v = (t.contiguous() for t in va._qkv_heads(qkv, B, N, H_VIT))
    do = va._heads(dob.reshape(B, N, D_VIT), B, N, H_VIT).contiguous()
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, scale=1.0), (qg, kg, vg), do)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = time_windows(lambda: sdpa(q, k, v, scale=1.0), 10, 3, 2)[0]
        both = time_windows(fwd_bwd, 10, 3, 2)[0]
    return fwd, both


def vit_pieces(B: int, N: int, x, dout, s_seq, pa, sa, gpu: str) -> dict:
    """`[vit pieces]`: K5 and K6 split by launch, each attention core alone
    against its plain piece (parity, time, bound) and the SDPA yardstick.
    → the cores' ms for the kernels line."""
    from cerebra_torch.models import vit_attn as va

    n, D = 5, D_VIT
    for what, call in (("K5", lambda: va.attn_fwd(x, s_seq, pa, H_VIT)),
                       ("K6", lambda: va.attn_bwd(dout, x, s_seq, pa, H_VIT, sa))):
        kernels, _, _ = device_kernels(call, n, label_vit)
        parts = split_ms(kernels, label_vit([k for k, _ in kernels]), n,
                         lambda lab: lab[1] if lab else "not a half-block's")
        log(f"[vit pieces] {what} B={B} N={N} device ms per call by piece: "
            f"{ {k: round(v, 4) for k, v in parts.items()} } (sum {sum(parts.values()):.4f}) "
            f"on {gpu}")
    qkv, stats = sa[3], sa[5]
    dob = (dout.reshape(B * N, D) @ pa[4].float().t()).to(torch.bfloat16)
    tag = f"B={B} N={N} bf16"
    o_k, st_k = va.attn_core_fwd(qkv, B, N, H_VIT)
    o_r, st_r = va.attn_core_fwd_ref(qkv, B, N, H_VIT)
    err_f = max(compare(f"core fwd {name} {tag}", a, b, torch.bfloat16, False, TOL_VIT)
                for name, a, b in (("o", o_k, o_r), ("m", st_k[..., 0], st_r[..., 0]),
                                   ("l", st_k[..., 1], st_r[..., 1])))
    got = va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT)
    want = va.attn_core_bwd_ref(qkv, dob, st_k, B, N, H_VIT)
    err_b = max(compare(f"core bwd {name} {tag}", a, b, torch.bfloat16, True, TOL_VIT)
                for name, a, b in zip(("dqkv32", "dqkvn", "delta"), got, want))
    # dk/dv forms S^T = K Q^T with the key rows as the A operand; p there is
    # the forward's only if every score equals the forward's bit for bit
    S, St = va.attn_scores_cuda(qkv, B, N, H_VIT)
    if not torch.equal(S, St.transpose(-1, -2)) or not torch.equal(st_k[..., 0], S.amax(-1)):
        raise AssertionError(f"dk/dv's scores differ from the forward's at {tag}")
    log(f"[parity] scores {tag}: dk/dv's S^T equals the forward's S bit for bit, and the "
        f"forward's row max is their max")
    del S, St
    sdpa_f, sdpa_fb = sdpa_ms(qkv, dob, B, N)
    rows = {
        "fwd": timing_row(lambda: va.attn_core_fwd(qkv, B, N, H_VIT),
                          lambda: va.attn_core_fwd_ref(qkv, B, N, H_VIT), (qkv,),
                          4 * B * N * N * D, torch.bfloat16, 10, 3),
        "bwd": timing_row(lambda: va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT),
                          lambda: va.attn_core_bwd_ref(qkv, dob, st_k, B, N, H_VIT),
                          (qkv, dob, st_k), 10 * B * N * N * D, torch.bfloat16, 10, 3),
    }
    kernels, _, _ = device_kernels(lambda: va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT), n)
    split = {core: sum(ms for k, ms in kernels if frag in k) / n
             for core, frag in (("dq core", "attn_bwd_dq"), ("dk/dv core", "attn_bwd_dkdv"))}
    log(f"[vit pieces] core fwd {tag}: {fmt_row(rows['fwd'])}; max_abs {err_f:.3e}; SDPA "
        f"flash forward {sdpa_f:.4f} ms (kernel / SDPA {rows['fwd']['ms'] / sdpa_f:.2f}) on {gpu}")
    log(f"[vit pieces] core bwd {tag}: {fmt_row(rows['bwd'])}; dq {split['dq core']:.4f} ms, "
        f"dk/dv {split['dk/dv core']:.4f} ms (device); max_abs {err_b:.3e}; SDPA flash forward "
        f"+ backward {sdpa_fb:.4f} ms, backward {sdpa_fb - sdpa_f:.4f} ms (kernel / SDPA "
        f"backward {rows['bwd']['ms'] / (sdpa_fb - sdpa_f):.2f}) on {gpu}")
    return {"fwd_core_ms": rows["fwd"]["ms"], "fwd_core_bound_ms": rows["fwd"]["bound_ms"],
            "sdpa_fwd_ms": sdpa_f, "bwd_core_ms": rows["bwd"]["ms"],
            "bwd_core_bound_ms": rows["bwd"]["bound_ms"], "dq_core_ms": split["dq core"],
            "dkdv_core_ms": split["dk/dv core"], "sdpa_bwd_ms": sdpa_fb - sdpa_f}


def mlp_pieces(B: int, N: int, xm, dm, s_rows, pm, sm, gpu: str) -> dict:
    """`[mlp pieces]`: K7 and K8 split by launch (torch.profiler), their
    launches a call, each product's device ms against its bound and against
    cuBLAS `torch.mm` on the same bf16 operands (a yardstick the port never
    calls), and K8's fused dh kernel alone against its plain piece (parity,
    time, bound). → the pieces' numbers for the kernels line."""
    from cerebra_torch.models import vit_mlp as vm

    n, M, D, F = 5, B * N, D_VIT, F_VIT
    bf = torch.bfloat16
    parts, launches = {}, {}
    for what, call in (("K7", lambda: vm.mlp_fwd(xm, s_rows, pm)),
                       ("K8", lambda: vm.mlp_bwd(dm, xm, s_rows, pm, sm))):
        kernels, _, _ = device_kernels(call, n, label_vit)
        labels = label_vit([k for k, _ in kernels])
        mine = [lab for lab in labels if lab and lab[0] == what]
        if len(mine) % n:
            raise AssertionError(f"{what}: {len(mine)} launches in {n} calls")
        launches[what] = len(mine) // n
        parts[what] = split_ms(kernels, labels, n,
                               lambda lab: lab[1] if lab and lab[0] == what else "other")
        parts[what].pop("other", None)
        log(f"[mlp pieces] {what} B={B} N={N} device ms per call by piece: "
            f"{ {k: round(v, 4) for k, v in parts[what].items()} } (sum "
            f"{sum(parts[what].values()):.4f}); {launches[what]} launches a call on {gpu}")
    g, b, w1, b1, w2, b2 = pm
    y = sm[0]
    dn = (dm * s_rows[:, None]).to(bf)
    tag = f"B={B} N={N} bf16"
    got = vm.mlp_dh(y, dn, w1, b1, w2)
    want = vm.mlp_dh_ref(y, dn, w1, b1, w2)
    err = max(compare(f"dh {name} {tag}", a, c, dt, True, TOL_VIT)
              for name, a, c, dt in zip(("gh", "dhn", "db1 partials"), got, want,
                                        (bf, bf, torch.float32)))
    gh, dhn, dparts = got
    splits = vm.contraction_splits(M, D, F)
    row = timing_row(lambda: vm.mlp_dh(y, dn, w1, b1, w2), lambda: vm.mlp_dh_ref(y, dn, w1, b1, w2),
                     (y, dn, w1, b1, w2), 4 * M * D * F, bf, 10, 3)
    log(f"[mlp pieces] dh kernel alone {tag}: {fmt_row(row)}; max_abs {err:.3e} on {gpu}")
    mmd = 2 * M * D * F
    f32 = 4
    # (half-block, piece) → (operations, bytes each input read and each
    # output written once, the cuBLAS yardstick)
    products = {
        ("K7", "fc1"): (mmd, nbytes(y, w1, b1) + M * F * 2, lambda: torch.mm(y, w1)),
        ("K7", "fc2"): (mmd, nbytes(gh, w2, b2, xm, s_rows) + M * D * f32,
                        lambda: torch.mm(gh, w2)),
        ("K8", "dh"): (2 * mmd, nbytes(y, dn, w1, b1, w2, gh, dhn, dparts),
                       lambda: (torch.mm(y, w1), torch.mm(dn, w2.t()))),
        ("K8", "dW1/dW2"): (2 * mmd, nbytes(gh, dn, y, dhn) + 2 * D * F * f32,
                            lambda: (torch.mm(gh.t(), dn), torch.mm(y.t(), dhn))),
        ("K8", "dy"): (mmd, nbytes(dhn, w1) + M * D * f32, lambda: torch.mm(dhn, w1.t())),
    }
    out = {"vit_mlp_fwd": {"launches_per_call": launches["K7"]},
           "vit_mlp_bwd": {"launches_per_call": launches["K8"], "dh_alone_ms": row["ms"],
                           "dh_plain_ms": row["plain_ms"], "contraction_splits": splits}}
    for (what, piece), (ops, moved, mm_call) in products.items():
        ms = parts[what][piece]
        bound = max(ops / PEAK_FLOPS[bf], moved / HBM_BYTES_PER_S) * 1e3
        mm_ms = time_windows(mm_call, 10, 3, 2)[0]
        log(f"[mlp pieces] {what} {piece} {tag}: device {ms:.4f} ms ({ops / ms / 1e9:.0f} "
            f"TFLOP/s), bound {bound:.4f} ms, torch.mm {mm_ms:.4f} ms (kernel / mm "
            f"{ms / mm_ms:.2f}) on {gpu}")
        key = "vit_mlp_fwd" if what == "K7" else "vit_mlp_bwd"
        name = piece.replace("/", "_")
        out[key].update({f"{name}_ms": ms, f"{name}_bound_ms": bound, f"{name}_mm_ms": mm_ms})
    return out


def phase_vit_timing(gpu: str) -> dict:
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    out = {}
    for B, N in VIT_SHAPES[:2]:
        x, dout, pa, pm, s_seq, s_rows = vit_inputs(B, N, torch.bfloat16, True, seed=1)
        xm, dm = x.reshape(B * N, D_VIT), dout.reshape(B * N, D_VIT)
        _, sa = va.attn_fwd(x, s_seq, pa, H_VIT)
        _, sm = vm.mlp_fwd(xm, s_rows, pm)
        # operations of the products on the bf16 tensor cores, M = B·N rows:
        # K5 qkv, proj and two attention products (QKᵀ, PV) over all heads;
        # K6 from the saved qkv: dWp and do, five attention products (S again,
        # dV, dP, dQ, dK), dWqkv and dy; K7 fc1 and fc2; K8 fc1 again, dW2,
        # dgh, dW1 and dy
        M, D, Fv = B * N, D_VIT, F_VIT
        rows = {
            "vit_attn_fwd": (lambda: va.attn_fwd(x, s_seq, pa, H_VIT),
                             lambda: va._attn_fwd_ref(x, s_seq, pa, H_VIT), (x, s_seq, pa),
                             8 * M * D * D + 4 * B * N * N * D),
            "vit_attn_bwd": (lambda: va.attn_bwd(dout, x, s_seq, pa, H_VIT, sa),
                             lambda: va._attn_bwd_ref(dout, x, s_seq, pa, H_VIT),
                             (dout, x, s_seq, pa, sa), 16 * M * D * D + 10 * B * N * N * D),
            "vit_mlp_fwd": (lambda: vm.mlp_fwd(xm, s_rows, pm),
                            lambda: vm._mlp_fwd_ref(xm, s_rows, pm), (xm, s_rows, pm),
                            4 * M * D * Fv),
            "vit_mlp_bwd": (lambda: vm.mlp_bwd(dm, xm, s_rows, pm, sm),
                            lambda: vm._mlp_bwd_ref(dm, xm, s_rows, pm), (dm, xm, s_rows, pm, sm),
                            10 * M * D * Fv),
        }
        for name, (kern, plain, inputs, flops) in rows.items():
            # no one PyTorch call computes LN + products + attention or GELU +
            # residual as one fused half-block: library none
            row = timing_row(kern, plain, inputs, flops, torch.bfloat16, 5, 5)
            log(f"[vit timing] {name} B={B} N={N} f32 stream/bf16: {fmt_row(row)}")
            if (B, N) == VIT_SHAPES[0]:
                out[name] = row
        cores = vit_pieces(B, N, x, dout, s_seq, pa, sa, gpu)
        mlp = mlp_pieces(B, N, xm, dm, s_rows, pm, sm, gpu)
        if (B, N) == VIT_SHAPES[0]:
            out["vit_attn_fwd"].update({k: v for k, v in cores.items() if "fwd" in k})
            out["vit_attn_bwd"].update({k: v for k, v in cores.items() if "fwd" not in k})
            for k, v in mlp.items():
                out[k].update(v)
        del x, dout, pa, pm, sa, sm, xm, dm
    return out


def phase_dino_step_timing(gpu: str) -> None:
    from contextlib import ExitStack
    from unittest import mock

    from cerebra_torch.models import vit, vit_attn, vit_mlp
    from cerebra_torch.train.dino_vit import DinoVitConfig, make_dino_vit

    cfg = DinoVitConfig(dtype=torch.bfloat16, epochs=2, warmup_epochs=1)
    B, views = cfg.batch_size_per_device, 2 + cfg.local_crops_number
    rng = np.random.default_rng(0)
    eeg = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).to("cuda")
    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        state, step, gen, _ = make_dino_vit(cfg, 80, torch.device("cuda"))
        with ExitStack() as stack:
            if kind == "plain":  # the blocks' fused calls through the plain versions
                stack.enter_context(mock.patch.object(
                    vit, "fused_attn_residual", vit_attn.fused_attn_residual_ref))
                stack.enter_context(mock.patch.object(
                    vit, "fused_mlp_residual", vit_mlp.fused_mlp_residual_ref))
            state, metrics = step(state, eeg, gen)
            torch.cuda.synchronize()
            # host clock over windows of 3 steps, each ended by reading the loss
            windows = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    state, metrics = step(state, eeg, gen)
                loss = metrics["loss"].item()
                windows.append((time.perf_counter() - t0) / 3)
                if not math.isfinite(loss):
                    raise AssertionError(f"{kind} main_dino step loss is {loss}")
            if kind == "kernels" and not profiled:
                box = [state]

                def one_step():
                    box[0], _ = step(box[0], eeg, gen)

                profile_dino(one_step, 3, gpu)
                profiled = True
        windows.sort()
        dt = windows[1]
        log(f"[dino step] {kind}: {dt * 1e3:.2f} ms/step (median of 3 windows of 3 steps; "
            f"{windows[0] * 1e3:.2f}-{windows[-1] * 1e3:.2f}), {B / dt:.2f} samples/s, "
            f"{B * views / dt:.2f} views/s (ViT-S/8, 2x224 + 4x96, batch {B}, bf16) on {gpu}")
        del state, step
        torch.cuda.empty_cache()


def profile_dino(step, n: int, gpu: str) -> None:
    """`[dino profile]`: device ms per main_dino step of K5 and K6 (their
    attention cores apart), K7, K8 and the rest, and the device's idle share
    of the profiled wall time."""
    kernels, wall_ms, host = device_kernels(step, n, label_vit)

    def key(lab):
        if lab is None:
            return "rest"
        if lab[0] in ("K7", "K8"):
            return lab[0]
        return f"{lab[0]} {lab[1]}" if "core" in lab[1] else f"{lab[0]} other"

    parts = split_ms(kernels, label_vit([k for k, _ in kernels]), n, key)
    busy = sum(parts.values())
    log(f"[dino profile] {wall_ms:.2f} ms/step under the profiler, device busy {busy:.2f} ms "
        f"(idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %); by part "
        f"{ {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} } on {gpu}")
    log(f"[dino profile] host ms per step by op, self time under the profiler (top 10 of "
        f"{sum(ms for _, ms in host):.1f}): {[(k[:40], round(ms, 2)) for k, ms in host[:10]]}")


def phase_ae_parity() -> dict:
    from unittest import mock

    from cerebra_torch.models import RecurrentAutoencoder
    from cerebra_torch.models import lstm as lstm_mod
    from cerebra_torch.models import lstm_stack as ls

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (c, h) in AE_SHAPES.items():
            for B in (16, 13):
                tag = f"{str(dtype).split('.')[-1]} {name} B={B}"
                x, layers, g_last = make_stack(B, dtype, seed=B, C=c, H=h, L=1)
                g_full = torch.randn(T, B, h, generator=torch.Generator().manual_seed(B))
                e4 = compare(f"K4 h {tag}", ls.fwd_infer(x, layers), ls._fwd_infer_ref(x, layers),
                             dtype, False)
                res = ls._fwd_train_ref(x, layers)
                e2 = 0.0  # over the K2g forms; K2's (g at T-1, no dx) is checked, not counted
                for g, g_name in ((g_last, "g T-1"), (g_full.to("cuda", dtype), "g all t")):
                    for need_dx in (False, True):
                        form = f"{g_name}{' dx' if need_dx else ''}"
                        dx, got = ls.bwd(g, x, layers, *res, need_dx=need_dx)
                        want_dx, want = ls._bwd_ref(g, x, layers, *res, need_dx=need_dx)
                        pairs = list(zip(("dW_ih", "dW_hh", "db"), got[0], want[0]))
                        if need_dx:
                            pairs.append(("dx", dx, want_dx))
                        e = max(compare(f"K2 {form} {n} {tag}", a, b, dtype, True)
                                for n, a, b in pairs)
                        if g is not g_last or need_dx:
                            e2 = max(e2, e)
                if dtype == torch.bfloat16 and name == "encoder" and B == B_AE:
                    errs = {"fwd_infer": e4, "bwd_general": e2}
                del x, layers, g_last, g_full, res
        # the full-width model: every gradient of a loss on both outputs
        tag = f"{str(dtype).split('.')[-1]} RecurrentAutoencoder(460, 96, 384) B={B_AE}"
        gen = torch.Generator().manual_seed(3)
        eeg = torch.randn(B_AE, T, C, generator=gen).cuda()
        w_enc = torch.randn(B_AE, E_AE, generator=gen).cuda()
        w_dec = torch.randn(B_AE, T, C, generator=gen).cuda()
        outs = []
        for stack_fn in (ls.lstm_stack, ls.lstm_stack_ref):
            model = RecurrentAutoencoder(T, C, E_AE, dtype=dtype, device="cuda",
                                         generator=torch.Generator().manual_seed(0))
            with mock.patch.object(lstm_mod, "lstm_stack", stack_fn):
                enc, dec = model(eeg)
                ((enc.float() * w_enc).sum() + (dec.float() * w_dec).sum()).backward()
            outs.append([enc, dec] + [p.grad for p in model.parameters()])
        names = ["encoded", "decoded"] + [n for n, _ in model.named_parameters()]
        for n, a, b in zip(names, *outs):
            compare(f"AE {n} {tag}", a, b, dtype, n not in ("encoded", "decoded"), TOL_AE)
        del model, outs, eeg
    torch.cuda.synchronize()
    return errs


def phase_ae_train(gpu: str) -> tuple:
    from unittest import mock

    from cerebra_torch.data import make_synthetic_corpus
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import RecurrentAutoencoder, feature_matching_loss
    from cerebra_torch.models import lstm as lstm_mod
    from cerebra_torch.models import lstm_stack as ls
    from cerebra_torch.train.optim import make_optimizer
    from cerebra_torch.train.steps import feature_distill_step

    steps = 10
    corpus = make_synthetic_corpus(seed=0, n_per_class=4, n_classes=N_CLASSES, n_channels=C,
                                   n_samples=T_RAW, feature_dim=E_AE).window(T_LO, T_HI)
    dev = torch.device("cuda")
    eeg = torch.from_numpy(corpus.eeg).to(dev)  # (N, T, C)
    feats = torch.from_numpy(corpus.image_features).to(dev)
    labels = torch.from_numpy(corpus.labels).to(dev)
    order = np.random.default_rng(0).permutation(len(labels))

    def loss_fn(f, c, t, y, e):
        return feature_matching_loss(f.float(), t)

    def make():
        model = RecurrentAutoencoder(T, C, E_AE, dtype=torch.bfloat16, device=dev,
                                     generator=torch.Generator().manual_seed(0))
        return model, make_optimizer("rmsprop", model.parameters(), 1e-3)

    model, opt = make()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        idx = torch.from_numpy(order[i * B_AE:(i + 1) * B_AE]).to(dev)
        losses.append(feature_distill_step(model, opt, loss_fn, eeg[idx], feats[idx],
                                           labels[idx], 0))
    with torch.no_grad():
        enc, dec = model(eeg[:B_AE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    losses = [v.item() for v in losses]
    log(f"[ae train] {steps} steps + 1 forward in {seconds:.2f} s, losses "
        f"{[round(v, 5) for v in losses]}, launches {launches}")
    if not all(math.isfinite(v) for v in losses) or not torch.isfinite(dec.float()).all():
        raise AssertionError(f"non-finite losses or reconstruction: {losses}")
    if tuple(enc.shape) != (B_AE, E_AE) or tuple(dec.shape) != (B_AE, T, C):
        raise AssertionError(f"encoded {tuple(enc.shape)}, decoded {tuple(dec.shape)}")
    # every K1 and K4 of the model (1 layer each) is one input product and
    # one cluster scan (pick_fwd takes both widths at B = 16)
    want = {"fwd_train": 2 * steps, "bwd_general": steps, "stack_bwd_scan": steps,
            "stack_bwd_products": steps, "fwd_infer": 2, "bwd": 0, "fwd_infer_last": 0,
            "bwd_rc": 0, "rc_scan": 0, "fwd_in_product": 2 * steps + 2,
            "fwd_cluster_scan": 2 * steps + 2, "fwd_wave": 0, "fwd_wave_split": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    batch = (eeg[:B_AE], feats[:B_AE], labels[:B_AE], 0)
    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        model, opt = make()
        with mock.patch.object(lstm_mod, "lstm_stack",
                               ls.lstm_stack if kind == "kernels" else ls.lstm_stack_ref):
            loss = feature_distill_step(model, opt, loss_fn, *batch)
            torch.cuda.synchronize()
            n = 5 if kind == "kernels" else 2
            t0 = time.perf_counter()
            for _ in range(n):
                loss = feature_distill_step(model, opt, loss_fn, *batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / n
            if kind == "kernels" and not profiled:
                profile_steps(lambda: feature_distill_step(model, opt, loss_fn, *batch), 3,
                              f"ae step B={B_AE}", gpu)
                profiled = True
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{kind} ae step loss is {loss.item()}")
        log(f"[ae step] {kind}: {dt * 1e3:.2f} ms/step, {B_AE / dt:.1f} trials/s "
            f"(RecurrentAutoencoder(460, 96, 384) fwd/bwd + RMSprop, bf16, batch {B_AE}) on {gpu}")

    times = {}
    for name, (c, h) in AE_SHAPES.items():
        x, layers, _ = make_stack(B_AE, torch.bfloat16, seed=5, C=c, H=h, L=1)
        res = ls.fwd_train(x, layers)
        g = torch.randn(T, B_AE, h, device=dev).to(torch.bfloat16)
        dx = name == "decoder"  # the decoder's input (the repeated latent) needs dx
        rows = {
            "fwd_train": (lambda: ls.fwd_train(x, layers), lambda: ls._fwd_train_ref(x, layers),
                          (x, layers), stack_flops(T, B_AE, c, h, 1),
                          cudnn_ms(T, B_AE, c, h, 1, "train")),
            "fwd_infer": (lambda: ls.fwd_infer(x, layers), lambda: ls._fwd_infer_ref(x, layers),
                          (x, layers), stack_flops(T, B_AE, c, h, 1),
                          cudnn_ms(T, B_AE, c, h, 1, "infer")),
            "bwd_general": (lambda: ls.bwd(g, x, layers, *res, need_dx=dx),
                            lambda: ls._bwd_ref(g, x, layers, *res, need_dx=dx),
                            (g, x, layers, res),
                            stack_flops(T, B_AE, c, h, 1, fwd=False, bwd=True, need_dx=dx),
                            cudnn_ms(T, B_AE, c, h, 1, "bwd_seq")),
        }
        pieces = {k: time_ms(v[0], 5) for k, v in bwd_pieces(g, x, layers, res, dx).items()}
        for kname, (kern, plain, inputs, flops, lib) in rows.items():
            row = timing_row(kern, plain, inputs, flops, torch.bfloat16, 5, 2, lib)
            split = (f"; its scan {pieces['scan']:.3f} ms, its products "
                     f"{pieces['products']:.3f} ms" if kname == "bwd_general" else "")
            n = ls.pick_fwd(B_AE, c, h, 1, torch.bfloat16) if kname.startswith("fwd") else 0
            log(f"[ae timing] {kname} {name} C={c} H={h} B={B_AE} T={T} bf16"
                f"{' (g all t, dx)' if kname == 'bwd_general' and dx else ''}"
                f"{' (g all t)' if kname == 'bwd_general' and not dx else ''}"
                f"{f' (clusters of {n})' if n else ''}: {fmt_row(row)}{split}")
            if name == "encoder" and kname != "fwd_train":  # K1's row is the CLI's
                times[kname] = row
        del x, layers, res, g
    return launches, times


def phase_fwd_paths(gpu: str) -> tuple:
    """Phase 11: K1 at the autoencoder's widths (K4's parity is phase 9's)
    and the layer-by-layer path's two pieces alone against their plain
    versions; the `[fwd paths]` sweep; the pieces' timing rows."""
    from cerebra_torch.models import lstm_stack as ls

    errs = {"fwd_in_product": 0.0, "fwd_cluster_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (c, h) in AE_SHAPES.items():
            for B in (16, 13):
                tag = f"{str(dtype).split('.')[-1]} {name} B={B}"
                x, layers, _ = make_stack(B, dtype, seed=B + 1, C=c, H=h, L=1)
                n = ls.pick_fwd(B, c, h, 1, dtype)
                if not n:
                    raise AssertionError(f"pick_fwd leaves the autoencoder's {tag} to lstm_fwd_kernel")
                want = ls._fwd_train_ref(x, layers)
                for k, a, b in zip(("h_all", "prefac", "qf"), ls.fwd_train(x, layers), want):
                    compare(f"K1 {k} {tag} (clusters of {n})", a, b, dtype, False)
                w_ih, w_hh, bias = layers[0]
                P = ls._in_product_ref(x, w_ih)
                ep = compare(f"K1/K4 input product {tag}", ls.fwd_in_product(x, w_ih), P,
                             torch.float32, True)  # f32 sums of exact products
                es = 0.0
                for m in ls.cluster_sizes(h, dtype):
                    for res in (False, True):
                        for k, a, b in zip(("h", "prefac", "qf"),
                                           ls.fwd_cluster_scan(P, w_hh, bias, res, m),
                                           ls._fwd_scan_ref(P, w_hh, bias, res)):
                            if b is not None:
                                es = max(es, compare(f"K1/K4 cluster scan {k} {tag} n={m}"
                                                     f"{' res' if res else ''}", a, b, dtype,
                                                     False, quiet=True))
                log(f"[parity] K1/K4 cluster scan {tag}: every cluster size "
                    f"{ls.cluster_sizes(h, dtype)}, with and without residuals, within its "
                    f"limit; max_abs at most {es:.3e}")
                if dtype == torch.bfloat16 and name == "encoder" and B == B_AE:
                    errs = {"fwd_in_product": ep, "fwd_cluster_scan": es}
                del x, layers, want, P
    torch.cuda.synchronize()

    bf16 = torch.bfloat16
    kinds = ("fwd_train", "fwd_infer", "fwd_infer_last", "fwd_train_rc")
    # the cluster sizes' order differs between the bf16 (tensor-core) and
    # the f32 (FMA) step, so the small batches run in both; every forward
    # through every path it can take, the split layer also for K1 and K3
    # (which fwd_path does not send there: a record)
    for (B, c, h, l_, t_), dtype in [(s, d) for s in FWD_SHAPES for d in (bf16, torch.float32)
                                     if d == bf16 or s[0] <= B_AE]:
        x, layers, _ = make_stack(B, dtype, seed=6, C=c, H=h, L=l_, T=t_)
        ms = {}
        for kind in kinds:
            ms[f"{kind} lstm_fwd_kernel"] = round(time_ms(lambda: ls._fwd_cuda(x, layers, kind), 3), 3)
            if kind in ("fwd_train", "fwd_infer"):
                for n in ls.cluster_sizes(h, dtype):
                    ms[f"{kind} n={n}"] = round(
                        time_ms(lambda: ls._fwd_cluster_cuda(x, layers, kind, n), 3), 3)
            if ls.wave_fits(c, h, l_, dtype):
                ms[f"{kind} wave"] = round(
                    time_ms(lambda: ls._fwd_wave_cuda(x, layers, kind), 3), 3)
            if ls.wave_split_fits(c, h, l_, dtype):  # at each tile that fits
                for mt in range(1, ls._WAVE_SPLIT_TILES + 1):
                    if ls.wave_split_smem(c, h, mt) <= ls._MAX_SMEM:
                        ms[f"{kind} split mt={mt}"] = round(
                            time_ms(lambda: ls._fwd_wave_cuda(x, layers, kind, True, mt), 3), 3)
        paths = {k: ls.fwd_path(B, c, h, l_, dtype, k) for k in kinds}
        tiles = ""
        if ls.wave_split_fits(c, h, l_, dtype):
            q = [ls.wave_clusters(c, h, l_, True, mt) for mt in range(1, ls._WAVE_SPLIT_TILES + 1)
                 if ls.wave_split_smem(c, h, mt) <= ls._MAX_SMEM]
            tiles = (f", split clusters at once by row tiles {q}, split_tiles picks "
                     f"{ls.wave_split_tiles(B, c, h, l_)}")
        log(f"[fwd paths] B={B} C={c} H={h} L={l_} T={t_} {str(dtype).split('.')[-1]}: ms {ms}; "
            f"fwd_path takes {paths} (clusters of {ls.pick_fwd(B, c, h, l_, dtype)}{tiles}) on {gpu}")
        del x, layers

    # the pieces alone at the encoder's width, as the AE step runs them (K1's
    # scan, with residuals)
    c, h = AE_SHAPES["encoder"]
    x, layers, _ = make_stack(B_AE, bf16, seed=7, C=c, H=h, L=1)
    w_ih, w_hh, bias = layers[0]
    P = ls.fwd_in_product(x, w_ih)
    n = ls.pick_fwd(B_AE, c, h, 1, bf16)
    x2 = x.view(T * B_AE, c)
    lib_product = time_windows(lambda: torch.mm(x2, w_ih, out_dtype=torch.float32), 5, 5, 3)[0]
    rows = {
        "fwd_in_product": (lambda: ls.fwd_in_product(x, w_ih), lambda: ls._in_product_ref(x, w_ih),
                           (x, w_ih), 2 * T * B_AE * c * 4 * h, lib_product),
        "fwd_cluster_scan": (lambda: ls.fwd_cluster_scan(P, w_hh, bias, True, n),
                             lambda: ls._fwd_scan_ref(P, w_hh, bias, True), (P, w_hh, bias),
                             2 * T * B_AE * h * 4 * h,
                             cudnn_ms(T, B_AE, 4 * h, h, 1, "train", scan=True)),
    }
    times = {}
    for name, (kern, plain, inputs, flops, lib) in rows.items():
        times[name] = timing_row(kern, plain, inputs, flops, bf16, 5, 2, lib)
        log(f"[fwd timing] {name} encoder C={c} H={h} B={B_AE} T={T} bf16 (clusters of {n}; "
            f"library: {'torch.mm to f32' if name == 'fwd_in_product' else 'cuDNN LSTM(4H, H) with weight_ih = I'}): "
            f"{fmt_row(times[name])}")
    del x, layers, P
    return errs, times


def stack_grad_call(fn, x: torch.Tensor, layers):
    """The lab's rcstack step: the gradient of Σ h_top[T−1]² through `fn` in
    x and every weight, all requiring grad."""
    xs = x.detach().requires_grad_(True)
    ws = [tuple(w.detach().requires_grad_(True) for w in layer) for layer in layers]
    flat = [xs] + [w for layer in ws for w in layer]

    def call():
        return torch.autograd.grad((fn(xs, ws)[-1].float() ** 2).sum(), flat)
    return call


def cudnn_grad_call(T_: int, B: int, C_: int, H_: int, L_: int):
    """The same gradient through torch.nn.LSTM (cuDNN) in `cudnn_dtype()`."""
    dt = cudnn_dtype()
    lstm = cudnn_lstm(C_, H_, L_, dt, False)
    xs = torch.randn(T_, B, C_, generator=torch.Generator().manual_seed(9)).to(
        "cuda", dt).requires_grad_(True)
    flat = [xs] + list(lstm.parameters())

    def call():
        return torch.autograd.grad((lstm(xs)[0][-1].float() ** 2).sum(), flat)
    return call


def peak_mib(call) -> tuple:
    """(peak device memory of one call above what was allocated before it,
    the peak in all), MiB, from reset_peak_memory_stats and
    max_memory_allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return (peak - base) / 2**20, peak / 2**20


RC_PIECES = ("rc_gates", "rc_scan", "rc_products")


def rc_piece_calls(g, x, layers, res) -> dict:
    """K11's three pieces as `bwd_rc` runs them, over every time chunk and
    layer, each on the inputs it gets there: one run of the chunked
    composition through the pieces' dispatching wrappers (fresh outputs, so
    every recorded input stays), recorded. → {name: (kernel wrapper, plain
    version, [argument lists])}; a scan's carry is recorded as it was read."""
    from cerebra_torch.models import lstm_stack as ls

    T_, B, _ = x.shape
    calls = {name: [] for name in RC_PIECES}

    def rec(name, fn):
        def call(*args):
            args = list(args)
            if name == "rc_scan":
                args[5] = args[5].clone()
            calls[name].append(args)
            return fn(*args)
        return call

    pieces = ls._RcPieces(rec("rc_gates", ls.rc_gates), rec("rc_scan", ls.rc_scan),
                          rec("rc_products", ls.rc_products),
                          lambda part: part.sum(0))  # not timed
    group = ls.rc_group(B)
    ls._bwd_rc_chunked(g, x, layers, *res, ls.rc_chunk(T_, B, group), group, pieces)
    plain = {"rc_gates": ls._rc_gates_ref, "rc_scan": ls._rc_scan_ref,
             "rc_products": ls._rc_products_ref}
    kern = {"rc_gates": ls.rc_gates, "rc_scan": ls.rc_scan, "rc_products": ls.rc_products}
    return {name: (kern[name], plain[name], calls[name]) for name in RC_PIECES}


def check_rc_pieces(calls: dict, tag: str, dtype) -> dict:
    """Each recorded call of K11's pieces through the kernel and the plain
    version on the same inputs (fresh outputs, a copy of the scan's carry,
    both carries compared after), one line a piece: the largest error of
    each piece."""
    errs = dict.fromkeys(RC_PIECES, 0.0)
    for name, (kern, plain, arg_lists) in calls.items():
        for k, args in enumerate(arg_lists):
            args = list(args)
            if name == "rc_products":
                args[6:] = [None, None]  # fresh partials and chain
            got_args, want_args = list(args), list(args)
            if name == "rc_scan":
                got_args[5], want_args[5] = args[5].clone(), args[5].clone()
            got, want = kern(*got_args), plain(*want_args)
            if name == "rc_gates":
                pairs = [("gates", got, want, torch.float32, True)]
            elif name == "rc_scan":
                # the f32 carries sum products of the rounded dgates: the
                # stream dtype's limit
                pairs = [("dgates", got, want, dtype, True),
                         ("carry", got_args[5], want_args[5], dtype, True)]
            else:
                pairs = [("dW partials", got[0], want[0], dtype, True),
                         (args[4], got[1], want[1], dtype, True)]
            for what, a, b, dt, grad in pairs:
                e = compare(f"K11 {name}[{k}] {what} {tag}", a, b, dt, grad, quiet=True)
                errs[name] = max(errs[name], e)
        log(f"[parity] K11 {name} {tag}: {len(arg_lists)} calls (every chunk and layer) "
            f"within their limits, max_abs at most {errs[name]:.3e}")
    torch.cuda.synchronize()
    return errs


def rc_piece_rows(calls: dict, dtype, plain_reps: int = 1) -> dict:
    """Timing rows of K11's pieces, each over all its recorded calls: the
    operations of their matrix products (the gates' inp·W_ih and h·W_hh,
    the scans' dgates·W_hhᵀ, the products' dW_ih, dW_hh and chain) and the
    tensors they read and write; library none (no one PyTorch call computes
    a piece over the chunks)."""
    rows = {}
    for name, (kern, plain, arg_lists) in calls.items():
        ops = 0
        for args in arg_lists:
            if name == "rc_gates":
                (n_, B_, in_), (n_h, _, H_) = args[0].shape, args[1].shape
                ops += 2 * B_ * 4 * H_ * (n_ * in_ + n_h * H_)
            elif name == "rc_scan":
                n_, B_, G_ = args[1].shape  # the gates
                ops += 2 * n_ * B_ * G_ * (G_ // 4)
            elif name == "rc_products":
                n_, B_, G_ = args[0].shape
                ops += 2 * n_ * B_ * G_ * (2 * args[1].shape[-1] + G_ // 4)
        inputs = [[a for a in (args[:6] if name == "rc_products" else args)
                   if isinstance(a, torch.Tensor)] for args in arg_lists]
        rows[name] = timing_row(lambda: [kern(*a) for a in arg_lists],
                                lambda: [plain(*a) for a in arg_lists], inputs, ops, dtype, 3,
                                plain_reps)
    return rows


def phase_rc(gpu: str) -> tuple:
    """Phase 12: K10/K11 and K4 against their plain versions (in bf16 K10
    and K4 on the wavefront forward at the headline widths, on its split
    layer at the DINO widths); K11's pieces alone against theirs; the lab's
    rcstack comparison (ms and peak memory of the shipped stack, the
    recompute stack and cuDNN); each kernel and piece alone; K11 at each
    time chunk; the launch checks at both widths."""
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import lstm_stack as ls

    bf16 = torch.bfloat16
    errs = {}
    # the JSON line's name of K10's and K4's row at each width (bf16, B_BIG)
    rows_of = {"headline": ("fwd_train_rc", "fwd_infer_wave"),
               "dino": ("fwd_train_rc_split", "fwd_infer_split")}
    for dtype in (torch.float32, bf16):
        for shape, B in (("headline", B_BIG), ("headline", 13), ("dino", B_BIG), ("dino", 16),
                         ("dino", 13)):
            T_, C_, H_, L_ = RC_SHAPES[shape]
            tag = f"{str(dtype).split('.')[-1]} {shape} C={C_} H={H_} L={L_} T={T_} B={B}"
            x, layers, _ = make_stack(B, dtype, seed=B, C=C_, H=H_, L=L_, T=T_)
            g = torch.randn(T_, B, H_, generator=torch.Generator().manual_seed(B)).to(
                "cuda", dtype)
            want = ls._fwd_train_rc_ref(x, layers)
            path = {k: ls.fwd_path(B, C_, H_, L_, dtype, k) for k in ("fwd_train_rc", "fwd_infer")}
            e10 = max(compare(f"K10 {n} {tag} ({path['fwd_train_rc']})", a, b, dtype, False)
                      for n, a, b in zip(("h_all", "c_all"), ls.fwd_train_rc(x, layers), want))
            e4 = compare(f"K4 h {tag} ({path['fwd_infer']})", ls.fwd_infer(x, layers),
                         ls._fwd_infer_ref(x, layers), dtype, False)
            dx, got = ls.bwd_rc(g, x, layers, *want)  # on the plain residuals: K11 alone
            want_dx, want_g = ls._bwd_rc_ref(g, x, layers, *want)
            pairs = [("dx", dx, want_dx)] + [
                (f"{n}[{l}]", a, b) for l in range(L_)
                for n, a, b in zip(("dW_ih", "dW_hh", "db"), got[l], want_g[l])]
            e11 = max(compare(f"K11 {n} {tag}", a, b, dtype, True) for n, a, b in pairs)
            if B == B_BIG and shape == "headline":
                pieces = check_rc_pieces(rc_piece_calls(g, x, layers, want), tag, dtype)
            if dtype == bf16 and B == B_BIG:
                errs.update(dict(zip(rows_of[shape], (e10, e4))))
                if shape == "headline":
                    errs.update({"bwd_rc": e11, **pieces})
            del x, layers, g, want, dx, got, want_dx, want_g, pairs
    torch.cuda.synchronize()
    log(f"[rc] clusters the card holds at once: the wavefront forward at the headline widths "
        f"{ls.wave_clusters(96, 96, 2)}, its split layer at the DINO widths "
        f"{ls.wave_clusters(96, 128, 4, split=True)}")

    times = {}
    for shape, (T_, C_, H_, L_) in RC_SHAPES.items():
        tag = f"{shape} C={C_} H={H_} L={L_} T={T_} B={B_BIG} bf16"
        x, layers, _ = make_stack(B_BIG, bf16, seed=7, C=C_, H=H_, L=L_, T=T_)
        for name, call in (("shipped K1+K2g", stack_grad_call(ls.lstm_stack, x, layers)),
                           ("recompute K10+K11", stack_grad_call(ls.lstm_stack_rc, x, layers)),
                           (f"cuDNN {str(cudnn_dtype()).split('.')[-1]}",
                            cudnn_grad_call(T_, B_BIG, C_, H_, L_))):
            ms = time_ms(call, 3)
            own, total = peak_mib(call)
            log(f"[rcstack] {tag} {name}: {ms:.3f} ms, peak {own:.1f} MiB above the inputs "
                f"({total:.1f} MiB in all) on {gpu}")
            del call
        res = ls.fwd_train_rc(x, layers)
        g = torch.randn(T_, B_BIG, H_, generator=torch.Generator().manual_seed(8)).to(
            "cuda", bf16)
        rows = {
            "fwd_train_rc": (lambda: ls.fwd_train_rc(x, layers),
                             lambda: ls._fwd_train_rc_ref(x, layers), (x, layers),
                             stack_flops(T_, B_BIG, C_, H_, L_),
                             cudnn_ms(T_, B_BIG, C_, H_, L_, "train", 3)),
            "fwd_infer": (lambda: ls.fwd_infer(x, layers), lambda: ls._fwd_infer_ref(x, layers),
                          (x, layers), stack_flops(T_, B_BIG, C_, H_, L_),
                          cudnn_ms(T_, B_BIG, C_, H_, L_, "infer", 3)),
            "bwd_rc": (lambda: ls.bwd_rc(g, x, layers, *res),
                       lambda: ls._bwd_rc_ref(g, x, layers, *res), (g, x, layers, res),
                       stack_flops(T_, B_BIG, C_, H_, L_, fwd=True, bwd=True, need_dx=True),
                       cudnn_ms(T_, B_BIG, C_, H_, L_, "bwd_seq", 3)),
        }
        group = ls.rc_group(B_BIG)
        chunk = ls.rc_chunk(T_, B_BIG, group)
        setting = (f"scan tile {ls.scan_tile(B_BIG, H_, bf16)}, chunk {chunk}, dW group {group}")
        names = dict(zip(("fwd_train_rc", "fwd_infer"), rows_of[shape]))
        for name, (kern, plain, inputs, flops, lib) in rows.items():
            row = timing_row(kern, plain, inputs, flops, bf16, 3, 1, lib)
            split = ""
            if name in names:  # K10 and K4: the path taken, and lstm_fwd_kernel alone
                old = time_ms(lambda: ls._fwd_cuda(x, layers, name), 3)
                path = ls.fwd_path(B_BIG, C_, H_, L_, bf16, name)
                if path == "split":
                    path += f" ({ls.wave_split_tiles(B_BIG, C_, H_, L_)} row tiles a cluster)"
                split = (f"; path {path}, lstm_fwd_kernel {old:.3f} ms (tile "
                         f"{ls.pick_tile(B_BIG, C_, H_, L_)})")
            log(f"[rc timing] {name} {tag} ({setting}): {fmt_row(row)}{split}")
            if name in names:
                times[names[name]] = row
            elif shape == "headline":
                times[name] = row
        piece_rows = rc_piece_rows(rc_piece_calls(g, x, layers, res), bf16)
        for name, row in piece_rows.items():
            log(f"[rc timing] {name} {tag} (over {-(-T_ // chunk)} chunks x {L_} layers): "
                f"{fmt_row(row)}")
            if shape == "headline":
                times[name] = row
        sweep = {}
        for c in sorted({8, 16, 32, 48, 64, 96, 128, chunk, T_}):
            c = -(-c // group) * group
            call = functools.partial(ls._bwd_rc_cuda, g, x, layers, *res, chunk=c)
            sweep[c] = (round(time_ms(call, 3), 3), round(peak_mib(call)[0], 1))
        log(f"[rc chunks] {tag}: chunk steps -> (K11 ms, K11 peak MiB above its inputs) "
            f"{sweep}; rc_chunk picks {chunk} on {gpu}")
        # the shipped pair beside them, with the gradients' cotangent (at T-1
        # only) for both backwards
        g[:-1] = 0
        res1 = ls.fwd_train(x, layers)
        pieces = {k: time_ms(v[0], 3)
                  for k, v in bwd_pieces(g, x, layers, res1, True).items()}
        # K2g as lstm_stack's gradient runs it here, beside the cuDNN backward
        # of a loss on the output with dx at the same shape (the bwd_rc row's)
        k2g = timing_row(lambda: ls.bwd(g, x, layers, *res1, need_dx=True),
                         lambda: ls._bwd_ref(g, x, layers, *res1, need_dx=True),
                         (g, x, layers, res1),
                         stack_flops(T_, B_BIG, C_, H_, L_, fwd=False, bwd=True, need_dx=True),
                         bf16, 3, 1, rows["bwd_rc"][4])
        log(f"[rc timing] {tag}: K1 {time_ms(lambda: ls.fwd_train(x, layers), 3):.3f} ms "
            f"({ls.fwd_path(B_BIG, C_, H_, L_, bf16, 'fwd_train')}), "
            f"K10 {time_ms(lambda: ls.fwd_train_rc(x, layers), 3):.3f} ms; g at T-1 only: "
            f"K2g with dx {fmt_row(k2g)} (its {L_} scans {pieces['scan']:.3f} ms, its "
            f"products {pieces['products']:.3f} ms), K11 "
            f"{time_ms(lambda: ls.bwd_rc(g, x, layers, *res), 3):.3f} ms")
        del x, layers, res, res1, g, piece_rows

    # the main path at both widths: one grad and one no-grad call, K10 and K4
    # on the wavefront forward (headline) or its split layer (DINO)
    launches = {}
    for shape, wave in (("headline", "fwd_wave"), ("dino", "fwd_wave_split")):
        T_, C_, H_, L_ = RC_SHAPES[shape]
        x, layers, _ = make_stack(B_BIG, bf16, seed=11, C=C_, H=H_, L=L_, T=T_)
        call = stack_grad_call(ls.lstm_stack_rc, x, layers)
        reset_launches()
        grads = call()
        with torch.no_grad():
            h = ls.lstm_stack_rc(x, layers)
        torch.cuda.synchronize()
        n = dict(LAUNCHES)
        log(f"[rc] one grad and one no-grad call of lstm_stack_rc, {shape} B={B_BIG}: "
            f"launches {n}")
        per_piece = -(-T_ // ls.rc_chunk(T_, B_BIG, ls.rc_group(B_BIG))) * L_
        want = {"fwd_train_rc": 1, "bwd_rc": 1, "fwd_infer": 1, "fwd_train": 0, "bwd_general": 0,
                "stack_bwd_scan": 0, "fwd_cluster_scan": 0, "fwd_wave": 0, "fwd_wave_split": 0,
                wave: 2, **dict.fromkeys(RC_PIECES, per_piece)}
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"launches {n}, expected {want}")
        if tuple(h.shape) != (T_, B_BIG, H_) or not all(torch.isfinite(t).all()
                                                        for t in (h, *grads)):
            raise AssertionError("lstm_stack_rc gave a wrong shape or non-finite values")
        k10, k4 = rows_of[shape]
        launches.update({k10: n["fwd_train_rc"], k4: n["fwd_infer"]})
        if shape == "headline":
            launches.update({k: n[k] for k in ("bwd_rc", *RC_PIECES)})
        del x, layers, call, grads, h
    return errs, times, launches


def phase_scan(gpu: str) -> tuple:
    """Phase 13: K12-K14 and lstm_scan's two gradients against the plain
    versions; in bf16 K12 and K13 on the scan's wavefront forward with one
    and with two CTAs a tile against its plain composition and the plain
    versions, and K14 on its residuals; the lab's baseline (forward alone,
    forward + backward of Σ h_all) through the kernels and the plain
    versions; each kernel alone; `[scan paths]`: K12 and K13 through
    scan_fwd_kernel and the wavefront forward at each CTA count; the launch
    check in bf16 (the wavefront forward) and in f32 (scan_fwd_kernel)."""
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import lstm_scan as sc
    from cerebra_torch.models import lstm_stack as ls

    bf16 = torch.bfloat16

    def case(B, dtype, seed):
        gen = torch.Generator().manual_seed(seed)
        x_proj = (torch.randn(T, B, 4 * H_SCAN, generator=gen) * 0.5).to("cuda", dtype)
        w_hh = ((torch.rand(H_SCAN, 4 * H_SCAN, generator=gen) * 2 - 1)
                / math.sqrt(H_SCAN)).to("cuda", dtype)
        g = torch.randn(T, B, H_SCAN, generator=gen).to("cuda", dtype)
        return x_proj, w_hh, g

    def grads(fn, x_proj, w_hh, g=None):
        xs, ws = x_proj.detach().requires_grad_(True), w_hh.detach().requires_grad_(True)
        h = fn(xs, ws)
        return torch.autograd.grad(h.float().sum() if g is None else (h * g).sum(), (xs, ws))

    errs = {}
    for dtype in (torch.float32, bf16):
        for B in (B_BIG, 16, 13):
            tag = f"{str(dtype).split('.')[-1]} H={H_SCAN} T={T} B={B}"
            x_proj, w_hh, g = case(B, dtype, B)
            route = f"ns {sc.scan_ns(B, H_SCAN, dtype)}"
            e12 = compare(f"K12 h_all {tag} ({route})", sc.scan_fwd_infer(x_proj, w_hh),
                          sc._scan_fwd_infer_ref(x_proj, w_hh), dtype, False)
            want = sc._scan_fwd_train_ref(x_proj, w_hh)
            e13 = max(compare(f"K13 {n} {tag} ({route})", a, b, dtype, False) for n, a, b in
                      zip(("h_all", "prefac", "qf"), sc.scan_fwd_train(x_proj, w_hh), want))
            e14 = compare(f"K14 dgates {tag}", sc.scan_bwd(g, *want[1:], w_hh),
                          sc._scan_bwd_ref(g, *want[1:], w_hh), dtype, True)
            want_d = grads(sc.lstm_scan_ref, x_proj, w_hh, g)
            for n, a, b in zip(("d x_proj", "d w_hh"), grads(sc.lstm_scan, x_proj, w_hh, g),
                               want_d):
                compare(f"lstm_scan {n} {tag}", a, b, dtype, True)
            if dtype == bf16:
                # the wavefront forward at each CTA count: against its plain
                # composition and the plain versions, and K14 on its residuals
                for ns in (1, 2):
                    wtag = f"{tag} (wavefront, {ns} CTA{'s' if ns > 1 else ''} a tile)"
                    comp = sc._scan_wave_ref(x_proj, w_hh, True, ns)
                    got = sc._fwd_cuda(x_proj, w_hh, False, ns=ns)
                    for ref, against in ((comp[0], "its composition"), (want[0], "plain")):
                        compare(f"K12 h_all {wtag} vs {against}", got, ref, dtype, False)
                    got = sc._fwd_cuda(x_proj, w_hh, True, ns=ns)
                    for ref, against in ((comp, "its composition"), (want, "plain")):
                        for n, a, b in zip(("h_all", "prefac", "qf"), got, ref):
                            compare(f"K13 {n} {wtag} vs {against}", a, b, dtype, False)
                    compare(f"K14 dgates on K13's residuals, {wtag}", sc.scan_bwd(g, *got[1:], w_hh),
                            sc._scan_bwd_ref(g, *got[1:], w_hh), dtype, True)
                    del comp, got
            if dtype == torch.float32 and B == 13:
                # the library column's call computes lstm_scan's function
                lstm = cudnn_lstm(4 * H_SCAN, H_SCAN, 1, dtype, scan=True)
                with torch.no_grad():
                    lstm.weight_hh_l0.copy_(w_hh.t())
                xs = x_proj.detach().requires_grad_(True)
                h = lstm(xs)[0]
                d_x, d_wT = torch.autograd.grad(h, (xs, lstm.weight_hh_l0), g)
                for n, a, b in (("h_all", h, sc._scan_fwd_infer_ref(x_proj, w_hh)),
                                ("d x_proj", d_x, want_d[0]), ("d w_hh", d_wT.t(), want_d[1])):
                    compare(f"cuDNN LSTM(4H, H) with weight_ih = I: {n} {tag}", a, b, dtype,
                            n != "h_all", TOL_CUDNN_SCAN)
                del lstm, xs, h, d_x, d_wT
            if B == B_BIG:  # bf16: the wavefront forward's rows; f32: scan_fwd_kernel's
                wave = "_wave" if dtype == bf16 else ""
                errs.update({f"scan_fwd_infer{wave}": e12, f"scan_fwd_train{wave}": e13})
                if dtype == bf16:
                    errs["scan_bwd"] = e14
            del x_proj, w_hh, g, want, want_d
    torch.cuda.synchronize()

    times = {}
    cudnn_call = {"scan_fwd_infer": "infer", "scan_fwd_train": "train", "scan_bwd": "bwd_seq"}
    for dtype in (torch.float32, bf16):
        tag = f"{str(dtype).split('.')[-1]} H={H_SCAN} T={T} B={B_BIG}"
        x_proj, w_hh, g = case(B_BIG, dtype, 5)
        for what, kern, plain in (
                ("fwd", lambda: sc.lstm_scan(x_proj, w_hh), lambda: sc.lstm_scan_ref(x_proj, w_hh)),
                ("fwd+bwd", lambda: grads(sc.lstm_scan, x_proj, w_hh),
                 lambda: grads(sc.lstm_scan_ref, x_proj, w_hh))):
            with torch.no_grad() if what == "fwd" else contextlib.nullcontext():
                ms, plain_ms = time_ms(kern, 5), time_ms(plain, 2)
            log(f"[scan baseline] {what} {tag}: kernels {ms:.3f} ms ({ms / T * 1e3:.2f} us/step),"
                f" plain {plain_ms:.3f} ms on {gpu}")
        res = sc.scan_fwd_train(x_proj, w_hh)
        mm = 2 * T * B_BIG * H_SCAN * 4 * H_SCAN  # h·W_hh (K12, K13), dgates·W_hhᵀ (K14)
        rows = {
            "scan_fwd_infer": (lambda: sc.scan_fwd_infer(x_proj, w_hh),
                               lambda: sc._scan_fwd_infer_ref(x_proj, w_hh), (x_proj, w_hh)),
            "scan_fwd_train": (lambda: sc.scan_fwd_train(x_proj, w_hh),
                               lambda: sc._scan_fwd_train_ref(x_proj, w_hh), (x_proj, w_hh)),
            "scan_bwd": (lambda: sc.scan_bwd(g, *res[1:], w_hh),
                         lambda: sc._scan_bwd_ref(g, *res[1:], w_hh), (g, res[1:], w_hh)),
        }
        ns = sc.scan_ns(B_BIG, H_SCAN, dtype)
        for name, (kern, plain, inputs) in rows.items():
            # library: nn.LSTM(4H, H) with weight_ih = I over x_proj, in this
            # row's dtype where cuDNN takes it
            lib = cudnn_ms(T, B_BIG, 4 * H_SCAN, H_SCAN, 1, cudnn_call[name], scan=True,
                           dtype=torch.float32 if dtype == torch.float32 else None)
            row = timing_row(kern, plain, inputs, mm, dtype, 5, 2, lib)
            if name == "scan_bwd":
                setting = f"tile {ls.scan_tile(B_BIG, H_SCAN, dtype)}"
            elif ns:
                setting = f"the wavefront forward, {ns} CTA{'s' if ns > 1 else ''} a tile"
            else:
                setting = f"scan_fwd_kernel, tile {sc.pick_tile(B_BIG, H_SCAN)}"
            log(f"[scan timing] {name} {tag} ({setting}): {fmt_row(row)}")
            if name == "scan_bwd":
                if dtype == bf16:
                    times[name] = row
            else:  # bf16: the wavefront forward's rows; f32: scan_fwd_kernel's
                times[name + ("_wave" if dtype == bf16 else "")] = row
        del x_proj, w_hh, g, res

    # K12 and K13 through each kernel at the batches that set scan_path: the
    # bench batch, the CLI's, and 128 tiles (two CTAs of the split an SM)
    for B in (B_BIG, 16, 2 * B_BIG):
        x_proj, w_hh, _ = case(B, bf16, 9)
        ms = {(kind, ns): time_ms(functools.partial(sc._fwd_cuda, x_proj, w_hh, train, ns=ns), 5)
              for kind, train in (("K12", False), ("K13", True)) for ns in (0, 1, 2)}
        line = "; ".join(f"{kind} " + ", ".join(
            f"{'scan_fwd_kernel' if ns == 0 else f'wavefront {ns} CTA' + ('s' if ns > 1 else '')}"
            f" {ms[(kind, ns)]:.3f}" for ns in (0, 1, 2)) + " ms" for kind in ("K12", "K13"))
        log(f"[scan paths] bf16 H={H_SCAN} T={T} B={B}: {line}; scan_path takes "
            f"{sc.scan_ns(B, H_SCAN, bf16)} CTAs a tile (clusters at once "
            f"{sc.scan_wave_clusters(H_SCAN, 1)} / {sc.scan_wave_clusters(H_SCAN, 2)}) on {gpu}")
        del x_proj, w_hh

    # the main path: one grad and one no-grad call in bf16 (the wavefront
    # forward) and in f32 (scan_fwd_kernel), the counts zeroed before each
    launches = {}
    for dtype in (bf16, torch.float32):
        x_proj, w_hh, _ = case(B_BIG, dtype, 6)
        ns = sc.scan_ns(B_BIG, H_SCAN, dtype)
        reset_launches()
        d = grads(sc.lstm_scan, x_proj, w_hh)
        with torch.no_grad():
            h = sc.lstm_scan(x_proj, w_hh)
        torch.cuda.synchronize()
        n = dict(LAUNCHES)
        log(f"[scan] one grad and one no-grad call of lstm_scan, {str(dtype).split('.')[-1]} "
            f"B={B_BIG}: launches {n}")
        want = {"scan_fwd_train": 1, "scan_bwd": 1, "scan_fwd_infer": 1,
                "scan_fwd_wave": 2 if ns == 1 else 0, "scan_fwd_wave_split": 2 if ns == 2 else 0}
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"launches {n}, expected {want}")
        if tuple(h.shape) != (T, B_BIG, H_SCAN) or not all(torch.isfinite(t).all()
                                                           for t in (h, *d)):
            raise AssertionError("lstm_scan gave a wrong shape or non-finite values")
        if dtype == bf16:
            launches.update({"scan_fwd_infer_wave": n["scan_fwd_infer"],
                             "scan_fwd_train_wave": n["scan_fwd_train"], "scan_bwd": n["scan_bwd"]})
        else:
            launches.update({k: n[k] for k in ("scan_fwd_infer", "scan_fwd_train")})
        del x_proj, w_hh, d, h
    return errs, times, launches


# Phase 14: the LSTM CLI family's shapes, (B, T, C, H, L): the DINO-LSTM
# backbone Model(96, 128, 4) over its 2 x 300 global and 4 x 200 local crops
# at batch 8 (`lstm_distillation`: K1/K2 at B = 16 and 32, the teacher's K3
# at 16), `lstm_distill`'s 4-layer stack at the Perils width and the
# Spampinato rig's (`lstm_distill_from_dinov2_train_spampinato`), each at the
# CLI's batch 16 over T = 460.
FAMILY_SHAPES = {"dino_global": (16, 300, 96, 128, 4), "dino_local": (32, 200, 96, 128, 4),
                 "distill": (16, T, 96, 96, 4), "spampinato": (16, T, 128, 128, 4)}
# K3 alone, at the galleries of 40 classes x 10 trials (80 %: B = 320) and in
# the dtype its main path runs: the eval CLI over a DINO checkpoint's backbone
# (f32, as the eval runs) and `lstm_distill`'s validation (bf16)
FAMILY_K3_SHAPES = {"eval": ((320, T, 96, 128, 4), torch.float32),
                    "distill_val": ((320, T, 96, 96, 4), torch.bfloat16)}
FAMILY_CLASSES, FAMILY_TRIALS = 40, 10
# the kernels line's entries of phase 14: name -> (kernel, shape, dtype)
FAMILY_KERNELS = {
    "fwd_train_dino_global": ("fwd_train", "dino_global", torch.bfloat16),
    "bwd_dino_global": ("bwd", "dino_global", torch.bfloat16),
    "fwd_infer_last_dino_global": ("fwd_infer_last", "dino_global", torch.bfloat16),
    "fwd_train_dino_local": ("fwd_train", "dino_local", torch.bfloat16),
    "bwd_dino_local": ("bwd", "dino_local", torch.bfloat16),
    "fwd_infer_last_eval": ("fwd_infer_last", "eval", torch.float32),
    "fwd_train_distill": ("fwd_train", "distill", torch.bfloat16),
    "bwd_distill": ("bwd", "distill", torch.bfloat16),
    "fwd_infer_last_distill": ("fwd_infer_last", "distill_val", torch.bfloat16),
    "fwd_train_spampinato": ("fwd_train", "spampinato", torch.bfloat16),
    "bwd_spampinato": ("bwd", "spampinato", torch.bfloat16),
}
REPLACES.update({name: REPLACES[k] for name, (k, _, _) in FAMILY_KERNELS.items()})
# the run of family_clis that drives each shape
FAMILY_RUNS = {"dino_global": "dino", "dino_local": "dino", "eval": "eval_dino",
               "distill": "distill", "distill_val": "distill", "spampinato": "spampinato"}
# the DINO-LSTM step's kernels by name fragment (first match wins): K1 runs
# the cluster path there, so `lstm_fwd_kernel` is the teacher's K3 alone;
# the port's own products are in namespace vit (cuBLAS's, the head's, are not)
DINO_LSTM_PARTS = (("lstm_fwd_kernel", "K3 teacher forward"),
                   ("cluster_scan", "K1 cluster scans"),
                   ("gemm_tc<false, false, vit::EpiF32>", "K1 input products"),
                   ("scan_bwd_kernel", "K2 scans"), ("vit::", "K2 products"),
                   ("col_sum_groups", "K2 products"), ("fold_groups", "K2 products"))


def family_case(label: str, dtype: torch.dtype, seed: int):
    shape = FAMILY_SHAPES[label] if label in FAMILY_SHAPES else FAMILY_K3_SHAPES[label][0]
    B, T_, C_, H_, L_ = shape
    return make_stack(B, dtype, seed, C=C_, H=H_, L=L_, T=T_), shape


def family_parity() -> dict:
    """(a) K1, K2 and K3 against their plain versions at every shape of the
    family, f32 and bf16 (K2 on the plain forward's residuals), and K3 at
    the galleries → the largest error by (kernel, shape, dtype)."""
    from cerebra_torch.models import lstm_stack as ls

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for i, label in enumerate((*FAMILY_SHAPES, *FAMILY_K3_SHAPES)):
            (x, layers, g), (B, T_, C_, H_, L_) = family_case(label, dtype, 40 + i)
            tag = f"{label} B={B} T={T_} C={C_} H={H_} L={L_} {dt}"
            errs[("fwd_infer_last", label, dtype)] = compare(
                f"K3 h[T-1] {tag}", ls.fwd_infer_last(x, layers),
                ls._fwd_infer_last_ref(x, layers), dtype, False)
            if label in FAMILY_SHAPES:
                want = ls._fwd_train_ref(x, layers)
                errs[("fwd_train", label, dtype)] = max(
                    compare(f"K1 {n} {tag} ({ls.fwd_path(B, C_, H_, L_, dtype, 'fwd_train')})",
                            a, b, dtype, False)
                    for n, a, b in zip(("h_all", "prefac", "qf"), ls.fwd_train(x, layers), want))
                _, got_g = ls.bwd(g, x, layers, *want)
                _, want_g = ls._bwd_ref(g, x, layers, *want)
                errs[("bwd", label, dtype)] = max(
                    compare(f"K2 {n}[{l}] {tag}", a, b, dtype, True)
                    for l in range(L_) for n, a, b in zip(("dW_ih", "dW_hh", "db"), got_g[l],
                                                          want_g[l]))
                del want, got_g, want_g
            torch.cuda.synchronize()
            del x, layers, g
    return errs


def family_run(what: str, fn, argv, check) -> tuple:
    """One CLI's `main(argv)` with the launch counts zeroed just before and
    read just after → (its result, the counts, seconds): the counts by
    kernel name and, under (kernel, B, T) keys, by shape; `check(result,
    launches)` raises on a wrong result or a path that missed its kernels."""
    from cerebra_torch.kernels import LAUNCH_SHAPES, LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**LAUNCHES, **LAUNCH_SHAPES}
    ran = {k: v for k, v in launches.items() if v}
    log(f"[lstm family] {what}: {seconds:.1f} s, launches {ran}")
    check(out, launches)
    return out, launches, seconds


def check_eval_loaded(argv, weights: str, scores_path: str, device: str = "cuda") -> None:
    """The eval CLI scored the model in `weights`: its top-k distances equal
    those of the model read here on its own (a DINO checkpoint's teacher
    backbone, or a flat `Model` state dict) over the same split; a random
    init, the CLI's fallback, gives other distances."""
    from cerebra_torch.cli.common import load_corpus, reference_argparser, split_train_val
    from cerebra_torch.cli.lstm_distill_from_dinov2_eval import features
    from cerebra_torch.eval.scores import evaluate
    from cerebra_torch.models.lstm import model_from_state_dict

    flags, _ = reference_argparser("eval check").parse_known_args(argv)
    corpus = load_corpus(flags)
    sd = torch.load(weights, map_location="cpu", weights_only=False)
    if "teacher" in sd:
        sd = {k[len("backbone."):]: v for k, v in sd["teacher"].items()
              if k.startswith("backbone.")}
    model = model_from_state_dict(sd, corpus.n_channels, device=device)
    g_idx, q_idx = split_train_val(flags, corpus)
    _, _, want = evaluate(features(model, corpus.eeg[g_idx], device),
                          features(model, corpus.eeg[q_idx], device),
                          list(corpus.labels[g_idx]), list(corpus.labels[q_idx]),
                          corpus.catalog, top_k=flags.topK)
    got = torch.load(scores_path, weights_only=False)["data"]
    for cname, entry in want["data"].items():
        if got[cname]["Topk"]["labels"] != entry["Topk"]["labels"] or not np.allclose(
                got[cname]["Topk"]["scores"], entry["Topk"]["scores"], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"the eval of {weights} scored another model ({cname})")


def family_clis(gpu: str) -> dict:
    """(b)-(d): lstm_distillation at full width, the eval CLI on two
    checkpoint layouts, and the two KD/cosine trainers → launch counts by
    run."""
    import shutil

    from cerebra_torch.cli import (
        lstm_distill,
        lstm_distill_from_dinov2_eval,
        lstm_distill_from_dinov2_train_spampinato,
        lstm_distillation,
    )
    from cerebra_torch.models import lstm_stack as ls

    root = os.path.join(ROOT, "build", "chip_smoke", "family")
    shutil.rmtree(root, ignore_errors=True)  # no auto-resume from an earlier run
    corpus = ["--synthetic", "--synthetic_classes", str(FAMILY_CLASSES),
              "--synthetic_per_class", str(FAMILY_TRIALS), "--device", "cuda"] + ONE_CARD
    n_train = int(FAMILY_CLASSES * FAMILY_TRIALS * 0.8)
    runs = {}

    # (b) the DINO-LSTM at the CLI's defaults for 2 epochs
    dino_dir = os.path.join(root, "dino")
    dino_steps = 2 * (n_train // 8)

    def check_dino(out, n):
        _, hist = out
        if len(hist["loss"]) != 2 or not all(math.isfinite(v) for v in hist["loss"]):
            raise AssertionError(f"lstm_distillation losses {hist['loss']}")
        for name in ("checkpoint.pth", "checkpoint0000.pth", "log.txt"):
            if not os.path.exists(os.path.join(dino_dir, name)):
                raise AssertionError(f"lstm_distillation wrote no {name}")
        want = {"fwd_train": 2 * dino_steps, "bwd": 2 * dino_steps,
                "fwd_infer_last": dino_steps, "bwd_general": 0}
        for label in ("dino_global", "dino_local"):  # K1 and K2 once at each crop shape
            B_, T_ = FAMILY_SHAPES[label][:2]
            want.update({("fwd_train", B_, T_): dino_steps, ("bwd", B_, T_): dino_steps})
        B_, T_ = FAMILY_SHAPES["dino_global"][:2]
        want[("fwd_infer_last", B_, T_)] = dino_steps  # the teacher on the global crops
        if {k: n.get(k, 0) for k in want} != want:
            raise AssertionError(f"a DINO-LSTM step is K1 and K2 at each crop shape and K3 at "
                                 f"the global one: launches {n}, expected {want} over "
                                 f"{dino_steps} steps")

    (_, hist), runs["dino"], seconds = family_run(
        "lstm_distillation (Model(96, 128, 4) + DINOHead(128 -> 384), 2 x 300 + 4 x 200 "
        "crops, batch 8, bf16, 2 epochs)", lstm_distillation.main,
        corpus + ["--epochs", "2", "--saveckp_freq", "20", "--log_dir", dino_dir], check_dino)
    log(f"[lstm family] lstm_distillation: {dino_steps} steps in {seconds:.1f} s, losses "
        f"{[round(v, 5) for v in hist['loss']]}, windows/s per epoch "
        f"{[round(w, 1) for w in hist['windows_per_s']]} on {gpu}")

    # (c) the eval CLI on (b)'s DINO checkpoint and on phase 4's Model weights
    for key, weights in (("eval_dino", os.path.join(dino_dir, "checkpoint.pth")),
                         ("eval_model", os.path.join(ROOT, "build", "chip_smoke", "cli",
                                                     "lstm_dinov2_best_loss.pth"))):
        eval_dir = os.path.join(root, key)
        argv = corpus + ["--custom_model_weights", weights, "--log_dir", eval_dir]
        if not os.path.exists(weights):  # the CLI would score a random-init model
            raise AssertionError(f"no {weights} to evaluate")

        def check_eval(out, n, eval_dir=eval_dir, weights=weights, argv=argv):
            if not all(math.isfinite(v) for v in out):
                raise AssertionError(f"eval recall/precision {out}")
            for name in ("synthetic_Scores.pth", "synthetic_Scores.txt", "synthetic_.csv"):
                if not os.path.exists(os.path.join(eval_dir, name)):
                    raise AssertionError(f"the eval wrote no {name}")
            if n["fwd_infer_last"] != 2:  # the gallery's and the query's features
                raise AssertionError(f"the eval's features bypassed K3: {n}")
            check_eval_loaded(argv, weights, os.path.join(eval_dir, "synthetic_Scores.pth"))

        out, runs[key], _ = family_run(
            f"lstm_distill_from_dinov2_eval on {os.path.relpath(weights, ROOT)}",
            lstm_distill_from_dinov2_eval.main, argv, check_eval)
        log(f"[lstm family] eval on {os.path.basename(weights)}: R {out[0]:.2f} P {out[1]:.2f}")

    # (d) the KD/cosine trainers for 2 epochs at their defaults
    steps = 2 * -(-n_train // 16)
    for key, fn, extra, path in (
            ("distill", lstm_distill.main, [], "wave"),
            ("spampinato", lstm_distill_from_dinov2_train_spampinato.main,
             ["--synthetic_channels", "128", "--synthetic_samples", "500"], "cluster")):
        C_, H_ = (96, 96) if key == "distill" else (128, 128)

        def check_trainer(out, n, key=key, path=path, C_=C_, H_=H_):
            _, hist = out
            if len(hist["train_loss"]) != 2 or not all(
                    math.isfinite(v) for v in hist["train_loss"]):
                raise AssertionError(f"{key} losses {hist['train_loss']}")
            taken = ls.fwd_path(16, C_, H_, 4, torch.bfloat16, "fwd_train")
            if taken != path:
                raise AssertionError(f"{key}: K1 takes {taken}, not {path}")
            if n["fwd_train"] < steps or n["bwd"] < steps:
                raise AssertionError(f"{key} bypassed K1/K2: {n} over {steps} steps")
            if path == "wave" and n["fwd_wave"] < n["fwd_train"] + n["fwd_infer_last"]:
                raise AssertionError(f"{key}: K1/K3 bypassed the wavefront forward: {n}")
            if path == "cluster" and min(n["fwd_in_product"], n["fwd_cluster_scan"]) < 4 * steps:
                raise AssertionError(f"{key}: K1 bypassed its layer-by-layer pieces: {n}")

        (_, hist), runs[key], _ = family_run(
            f"{fn.__module__.split('.')[-1]} (C = H = {H_}, L = 4, batch 16, bf16, 2 epochs)",
            fn, corpus + extra + ["--num_epochs", "2", "--log_dir", os.path.join(root, key)],
            check_trainer)
        log(f"[lstm family] {key}: losses {[round(v, 5) for v in hist['train_loss']]}, "
            f"windows/s per epoch {[round(w, 1) for w in hist['windows_per_s']]} on {gpu}")
    if runs["distill"]["fwd_infer_last"] != 2:  # the epoch-1 validation's gallery and query
        raise AssertionError(f"lstm_distill's validation bypassed K3: {runs['distill']}")
    return runs


def family_step_timing(gpu: str) -> None:
    """(e) `[lstm dino step]`: ms/step and windows/s of the DINO-LSTM step at
    the CLI's defaults (host clock, the median of three windows of three
    steps, each ended by reading the loss); `[lstm dino profile]`: its device
    time by part, K3 apart from K1 and K2, and the device's idle share."""
    from cerebra_torch.train.recipes import DinoSelfDistillConfig, make_dino_lstm, step_generator

    cfg = DinoSelfDistillConfig(dtype=torch.bfloat16, epochs=2, warmup_epochs=1)
    B = cfg.batch_size_per_device
    rng = np.random.default_rng(0)
    eeg = torch.from_numpy(rng.normal(size=(B, 495, 96)).astype(np.float32)).to("cuda")
    state, step, _ = make_dino_lstm(cfg, 320, 96, torch.device("cuda"))
    gen = step_generator(0, 0)
    box = [state]

    def one_step():
        box[0], metrics = step(box[0], eeg, gen)
        return metrics

    one_step()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            metrics = one_step()
        loss = metrics["loss"].item()
        windows.append((time.perf_counter() - t0) / 3)
        if not math.isfinite(loss):
            raise AssertionError(f"DINO-LSTM step loss is {loss}")
    windows.sort()
    dt = windows[1]
    log(f"[lstm dino step] {dt * 1e3:.2f} ms/step (median of 3 windows of 3 steps; "
        f"{windows[0] * 1e3:.2f}-{windows[-1] * 1e3:.2f}), {B / dt:.1f} windows/s "
        f"(Model(96, 128, 4) + DINOHead(128 -> 384), 2 x 300 + 4 x 200 crops, batch {B}, "
        f"bf16) on {gpu}")
    kernels, wall_ms, host = device_kernels(one_step, 3)
    parts = {}
    for name, ms in kernels:
        part = next((p for frag, p in DINO_LSTM_PARTS if frag in name),
                    "rest (head, loss, AdamW, EMA, crops)")
        parts[part] = parts.get(part, 0.0) + ms / 3
    busy = sum(parts.values())
    log(f"[lstm dino profile] {wall_ms:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %); by part "
        f"{ {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} }; "
        f"host ms per step by op (top 5 of {sum(ms for _, ms in host):.1f}): "
        f"{[(k[:40], round(ms, 2)) for k, ms in host[:5]]} on {gpu}")
    del state, box


def family_kernel_timing(gpu: str) -> dict:
    """(e) K1, K2 and K3 at every shape of the family, and K3 at the
    galleries, each against its plain version, its bound and cuDNN → rows
    by (kernel, shape)."""
    from cerebra_torch.models import lstm_stack as ls

    rows = {}
    cases = ([(label, torch.bfloat16) for label in FAMILY_SHAPES]
             + [(label, dtype) for label, (_, dtype) in FAMILY_K3_SHAPES.items()])
    for label, dtype in cases:
        (x, layers, g), (B, T_, C_, H_, L_) = family_case(label, dtype, 7)
        dt = str(dtype).split(".")[-1]
        kinds = ("fwd_train", "bwd", "fwd_infer_last") if label in FAMILY_SHAPES else (
            "fwd_infer_last",)
        res = ls._fwd_train_ref(x, layers) if "bwd" in kinds else None
        for kind in kinds:
            if kind == "fwd_train":
                kern = lambda: ls.fwd_train(x, layers)  # noqa: E731
                plain = lambda: ls._fwd_train_ref(x, layers)  # noqa: E731
                inputs, flops, lib = (x, layers), stack_flops(T_, B, C_, H_, L_), "train"
            elif kind == "bwd":
                kern = lambda: ls.bwd(g, x, layers, *res)  # noqa: E731
                plain = lambda: ls._bwd_ref(g, x, layers, *res)  # noqa: E731
                inputs = (g, x, layers, res)
                flops, lib = stack_flops(T_, B, C_, H_, L_, fwd=False, bwd=True), "bwd_last"
            else:
                kern = lambda: ls.fwd_infer_last(x, layers)  # noqa: E731
                plain = lambda: ls._fwd_infer_last_ref(x, layers)  # noqa: E731
                inputs, flops, lib = (x, layers), stack_flops(T_, B, C_, H_, L_), "infer"
            row = timing_row(kern, plain, inputs, flops, dtype, 5, 1,
                             cudnn_ms(T_, B, C_, H_, L_, lib,
                                      dtype=torch.float32 if dtype == torch.float32 else None))
            path = ls.fwd_path(B, C_, H_, L_, dtype, kind) if kind != "bwd" else "scans + products"
            log(f"[lstm family timing] {kind} {label} B={B} T={T_} C={C_} H={H_} L={L_} {dt} "
                f"({path}): {fmt_row(row)} on {gpu}")
            rows[(kind, label)] = row
        del x, layers, g, res
    return rows


def phase_lstm_family(gpu: str) -> tuple:
    """Phase 14 → (errors, timing rows, launches) of FAMILY_KERNELS."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = family_parity()
    runs = family_clis(gpu)
    family_step_timing(gpu)
    rows = family_kernel_timing(gpu)
    # launches by entry: the count at its own kernel and shape (checked per
    # step above for the DINO-LSTM) in the run that drives that shape
    shapes = dict(FAMILY_SHAPES, **{k: v for k, (v, _) in FAMILY_K3_SHAPES.items()})
    launches = {}
    for name, (kind, label, _) in FAMILY_KERNELS.items():
        B_, T_ = shapes[label][:2]
        n = runs[FAMILY_RUNS[label]].get((kind, B_, T_), 0)
        if n == 0:
            raise AssertionError(f"{name}: no {kind} launch at B={B_} T={T_} in the "
                                 f"{FAMILY_RUNS[label]} run")
        launches[name] = n
    out_errs = {name: errs[(k, label, dtype)] for name, (k, label, dtype) in FAMILY_KERNELS.items()}
    times = {name: rows[(k, label)] for name, (k, label, _) in FAMILY_KERNELS.items()}
    return out_errs, times, launches


# Phase 15: retrieval analysis and the EEG-side DINO CLIs at full width, and
# K15 (`flash_mha`, the flash attention of `Attention(use_flash=True)`) on
# K5/K6's attention cores. The corpora: the Spampinato scale (40 classes x
# 300 trials of 128 channels x 500 samples, windowed to 460: 9600 gallery and
# 2400 query trials, D = 128 x 2400 x 9600 f32 = 11.8 GB) and the Perils
# size (40 x 50 trials of 96 channels x 512 samples).
SPAMPINATO = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "300",
              "--synthetic_channels", "128", "--synthetic_samples", "500"]
PERILS = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "50",
          "--synthetic_channels", "96", "--synthetic_samples", "512"]
FLASH_SOURCES = dict.fromkeys(("vit_attn_flash_fwd", "vit_attn_flash_bwd"),
                              "cerebra_torch/csrc/vit_attn.cu")
# K15 replaces the JAX package's `_flash_mha`, which reaches pl.pallas_call
# through the library kernel jax.experimental.pallas.ops.tpu.flash_attention
REPLACES.update(dict.fromkeys(FLASH_SOURCES, "cerebra/models/vit.py:75"))
# ViT-Ti/16 at 224 px over 64 images: eeg_retrieval_dino's defaults (B, N, D,
# heads, F)
VIT_TI = (64, 197, 192, 3, 768)


def analysis_dir(name: str) -> str:
    import shutil

    path = os.path.join(ROOT, "build", "chip_smoke", "analysis", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


@contextlib.contextmanager
def one_corpus_per_flags(*cli_modules):
    """Each CLI module's `load_corpus` builds a flag set's synthetic corpus
    once (a numpy draw on the host, ~10^9 values at the Spampinato scale)
    and hands the same corpus to the next CLI run with those flags."""
    from unittest import mock

    from cerebra_torch.cli import common

    built = {}

    def load(FLAGS, *args, **kw):
        key = (FLAGS.synthetic_classes, FLAGS.synthetic_per_class, FLAGS.synthetic_channels,
               FLAGS.synthetic_samples, FLAGS.seed, FLAGS.time_low, FLAGS.time_high)
        if key not in built:
            t0 = time.perf_counter()
            built[key] = common.load_corpus(FLAGS, *args, **kw)
            log(f"[analysis] corpus {built[key].eeg.shape} built on the host in "
                f"{time.perf_counter() - t0:.1f} s")
        return built[key]

    with contextlib.ExitStack() as stack:
        for module in cli_modules:
            stack.enter_context(mock.patch.object(module, "load_corpus", load))
        yield


def analysis_greedy(gpu: str) -> None:
    """`[analysis greedy]`: discover_channels at the Spampinato scale, 4
    channels, with D resident and with 16-channel chunks: the same channels
    and the same recalls."""
    from cerebra_torch.cli import discover_channels as dc

    runs = {}
    with one_corpus_per_flags(dc):
        for mode, extra in (("resident", []), ("chunked", ["--channel_chunk", "16"])):
            log_dir = analysis_dir(f"greedy_{mode}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = dc.main(SPAMPINATO + ["--max_channels", "4", "--device", "cuda", "--log_dir",
                                        log_dir] + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            with open(os.path.join(log_dir, "channel_discovery.json")) as f:
                out = json.load(f)
            if out["selected_channels"] != res.selected or not res.selected or not all(
                    0.0 <= r <= 100.0 for r in res.recalls):
                raise AssertionError(f"discover_channels {mode}: {out}")
            log(f"[analysis greedy] {mode}: selected {res.selected}, recalls {res.recalls}; "
                f"{len(res.iteration_s)} iterations of {[round(s, 4) for s in res.iteration_s]} "
                f"s, the whole sweep {out['elapsed_s']:.2f} s (with D's build when resident), "
                f"the CLI {seconds:.1f} s (with the corpus); peak {peak:.2f} GiB allocated on "
                f"{gpu}")
            runs[mode] = res
    a, b = runs["resident"], runs["chunked"]
    if a.selected != b.selected or a.recalls != b.recalls:
        raise AssertionError(f"resident {a.selected} {a.recalls} != chunked {b.selected} "
                             f"{b.recalls}")
    log(f"[analysis greedy] resident and chunked select the same channels with the same "
        f"recalls at 9600 x 2400 x 128")


def analysis_sweep(gpu: str) -> None:
    """`[analysis sweep]`: the best-window sweep (width 1) at the Perils size,
    then brain_map and save_channelwise_outputs on the same corpus; the
    files each writes."""
    from cerebra_torch.cli import brain_map
    from cerebra_torch.cli import discover_channels as dc
    from cerebra_torch.cli import save_channelwise_outputs as cw

    with one_corpus_per_flags(dc, brain_map, cw):
        log_dir = analysis_dir("sweep")
        t0 = time.perf_counter()
        res = dc.main(PERILS + ["--best_window_sweep", "--window_width", "1", "--device", "cuda",
                                "--log_dir", log_dir])
        seconds = time.perf_counter() - t0
        with open(os.path.join(log_dir, "best_window_log.txt")) as f:
            lines = f.read().splitlines()
        with open(os.path.join(log_dir, "best_window_sweep.json")) as f:
            out = json.load(f)
        if len(lines) != 96 or len(out["best_start"]) != 96 or res.recalls.shape != (96, 460):
            raise AssertionError(f"best-window sweep: {len(lines)} log lines, "
                                 f"{res.recalls.shape} recalls")
        log(f"[analysis sweep] best windows of 96 channels x 460 starts (400 queries, 1600 "
            f"gallery trials) in {out['elapsed_s']:.2f} s (the CLI {seconds:.1f} s); best "
            f"recall {float(res.best_recall.max()):.2f} at channel "
            f"{int(res.best_recall.argmax())} on {gpu}")
        bm_dir = analysis_dir("brain_map")
        t0 = time.perf_counter()
        grid = brain_map.main(PERILS + ["--device", "cuda", "--log_dir", bm_dir])
        seconds = time.perf_counter() - t0
        with open(os.path.join(bm_dir, "brain_map.json")) as f:
            clusters = np.asarray(json.load(f)["clusters"])
        if clusters.shape != (96, 20) or not os.path.getsize(os.path.join(bm_dir,
                                                                          "brain_map.png")):
            raise AssertionError(f"brain_map wrote clusters {clusters.shape}")
        cw_dir = analysis_dir("channelwise")
        paths = cw.main(PERILS + ["--max_plots", "4", "--device", "cuda", "--log_dir", cw_dir])
        if [os.path.basename(p) for p in paths] != [f"ch_{c}_the_perils.png" for c in range(4)]:
            raise AssertionError(f"save_channelwise_outputs wrote {paths}")
        log(f"[analysis sweep] brain_map {seconds:.1f} s ({len(np.unique(grid))} clusters over "
            f"96 x 20); save_channelwise_outputs wrote {len(paths)} PNGs")


def dino_retrieval(gpu: str) -> None:
    """`[dino retrieval]`: eeg_retrieval_dino at the CLI's defaults (ViT-Ti/16
    at 224 px, DINOHead to 65536, eeg2eeg both sides) over 40 x 10 trials,
    with random weights and with a vit_small/8 checkpoint written by
    export_dino_pth; K5 and K7 in every block of both forwards; K5 and K7
    against their plain versions at ViT-Ti/16's shapes; the model's CUDA
    features against the same model's on the CPU."""
    from cerebra_torch.cli import eeg_retrieval_dino as erd
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm
    from cerebra_torch.models.dino_model import DinoArgs, DinoModel
    from cerebra_torch.models.multicrop import MultiCropWrapper
    from cerebra_torch.train.checkpoints import export_dino_pth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, N, D, Hh, Fv = VIT_TI
    gen = torch.Generator().manual_seed(15)

    def r(*shape, sc=0.05, base=0.0):
        return (torch.randn(*shape, generator=gen) * sc + base).to("cuda")

    x = r(B, N, D, sc=1.0)
    f32 = torch.float32
    pa = va._prep(r(D, base=1.0), r(D), r(D, 3 * D), r(3 * D), r(D, D), r(D), Hh, f32)
    pm = vm._prep(r(D, base=1.0), r(D), r(D, Fv), r(Fv), r(Fv, D), r(D), f32)
    tag = f"ViT-Ti/16 B={B} N={N} D={D} f32"
    compare(f"K5 out {tag}", va.attn_fwd(x, None, pa, Hh)[0],
            va._attn_fwd_ref(x, None, pa, Hh)[0], f32, False, TOL_VIT)
    xm = x.reshape(B * N, D)
    compare(f"K7 out {tag}", vm.mlp_fwd(xm, None, pm)[0], vm._mlp_fwd_ref(xm, None, pm)[0], f32,
            False, TOL_VIT)
    del x, xm, pa, pm
    # the model end to end: fused kernels on the card, the unfused formulas
    # on the CPU, the same seeded weights and window starts
    args = DinoArgs(arch="vit_tiny", patch_size=16, image_size=224, out_dim=65536)
    eeg = torch.randn(4, 460, 96, generator=gen)
    starts = torch.arange(4)
    got = DinoModel(args, seed=43, device="cuda").features_from_eeg(eeg, starts=starts)
    want = DinoModel(args, seed=43).features_from_eeg(eeg, starts=starts)
    # through 12 blocks and the head: 1e-4 relative, the f32 value limit
    compare("DinoModel features, CUDA (K5/K7) against the CPU's unfused path, f32", got.cpu(),
            want, f32, True, (TOL_VIT[0], TOL_VIT[0], TOL_VIT[2]))

    ckpt = os.path.join(analysis_dir("dino_ckpt"), "checkpoint.pth")
    small = DinoModel(DinoArgs(arch="vit_small", patch_size=8), seed=7)
    wrapped = MultiCropWrapper(small.backbone, small.head)
    export_dino_pth(ckpt, wrapped, wrapped, torch.zeros(1, 65536), epoch=0)
    del small, wrapped
    corpus = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "10"]
    for what, extra in (("random ViT-Ti/16", []),
                        ("vit_small/8 checkpoint", ["--custom_model_weights", ckpt, "--arch",
                                                    "vit_small", "--patch_size", "8"])):
        log_dir = analysis_dir("dino_retrieval")
        reset_launches()
        t0 = time.perf_counter()
        recall, precision = erd.main(corpus + extra + ["--device", "cuda", "--log_dir", log_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = {k: v for k, v in LAUNCHES.items() if v}
        # 12 blocks x (the gallery's forward + the query's)
        if ran != {"vit_attn_fwd": 24, "vit_mlp_fwd": 24}:
            raise AssertionError(f"eeg_retrieval_dino ({what}) launched {ran}")
        files = ("commandline_args.txt", "synthetic_Scores.pth", "synthetic_Scores.txt",
                 "synthetic_.csv")
        if not (math.isfinite(recall) and math.isfinite(precision)) or not all(
                os.path.exists(os.path.join(log_dir, f)) for f in files):
            raise AssertionError(f"eeg_retrieval_dino ({what}): R {recall} P {precision}")
        log(f"[dino retrieval] {what}: {seconds:.1f} s (320 gallery + 80 query trials, the "
            f"models' init and the checkpoint's load included), R {recall:.2f} P "
            f"{precision:.2f}, launches {ran} on {gpu}")


def attention_maps(gpu: str) -> None:
    """`[attention maps]`: visualize_attention --threshold 0.6 at its defaults
    (ViT-Ti/16 at 224 px: 3 heads, a map and a mask each)."""
    from cerebra_torch.cli import visualize_attention as vis
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    log_dir = analysis_dir("attention")
    reset_launches()
    t0 = time.perf_counter()
    paths = vis.main(["--synthetic", "--threshold", "0.6", "--device", "cuda", "--log_dir",
                      log_dir])
    seconds = time.perf_counter() - t0
    want = [n for h in range(3) for n in (f"attn-head{h}.png", f"mask_th0.6_head{h}.png")]
    if [os.path.basename(p) for p in paths] != want or not all(os.path.getsize(p) for p in paths):
        raise AssertionError(f"visualize_attention wrote {paths}")
    # 11 blocks through K5/K7; the last one returns its map from the softmax
    if (LAUNCHES["vit_attn_fwd"], LAUNCHES["vit_mlp_fwd"]) != (11, 11):
        raise AssertionError(f"visualize_attention launched {dict(LAUNCHES)}")
    log(f"[attention maps] {len(paths)} PNGs in {seconds:.1f} s on {gpu}")


def flash_plain(q, k, v, do, scale: float):
    """K15's plain version: the attention cores' plain pieces in the
    wrapper's layout → (out, dq, dk, dv), or (out,) without `do`."""
    from cerebra_torch.models import vit_attn as va

    B, H_, N, _ = q.shape
    qkv = torch.cat([va._rows(t, B, N) for t in (q * scale, k, v)], 1)
    o, stats = va.attn_core_fwd_ref(qkv, B, N, H_)
    if do is None:
        return (va._heads(o.reshape(B, N, -1), B, N, H_),)
    dqkv32, _, _ = va.attn_core_bwd_ref(qkv, va._rows(do, B, N).to(qkv.dtype), stats, B, N, H_)
    dq, dk, dv = va._qkv_heads(dqkv32, B, N, H_)
    return (va._heads(o.reshape(B, N, -1), B, N, H_), (dq * scale).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def flash_kernel(q, k, v, do, scale: float):
    from cerebra_torch.models.vit_attn import flash_mha

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = flash_mha(qg, kg, vg, scale)
    return (out, *torch.autograd.grad(out, (qg, kg, vg), do))


def flash_parity(gpu: str) -> dict:
    """K15 at main_dino's globals: `Attention(use_flash=True)` against its
    softmax path (the value and every gradient), and flash_mha against its
    plain version, bf16 and f32 → the bf16 errors of the forward and the
    backward for the kernels line."""
    from cerebra_torch.models import vit as tv

    B, N, D, Hh = 16, 785, D_VIT, H_VIT
    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        name = str(cdt).split(".")[-1]
        gen = torch.Generator().manual_seed(785)
        attn = tv.Attention(D, Hh, dtype=None if cdt == torch.float32 else cdt, use_flash=True)
        attn = attn.to("cuda")
        x = torch.randn(B, N, D, generator=gen).to("cuda")
        cot = torch.randn(B, N, D, generator=gen).to("cuda")
        outs = []
        for flash in (True, False):
            attn.use_flash = flash
            xg = x.clone().requires_grad_(True)
            out, _ = attn(xg, need_weights=False)
            grads = torch.autograd.grad(out, (xg, *attn.parameters()), cot.to(out.dtype))
            outs.append((out, *grads))
        names = ("out", "dx", "dWqkv", "dbqkv", "dWproj", "dbproj")
        for i, (a, b) in enumerate(zip(*outs)):
            compare(f"K15 Attention(use_flash) {names[i]} B={B} N={N} {name}", a, b, cdt, i > 0,
                    TOL_VIT)
        dh = D // Hh
        q, k, v, do = (torch.randn(B, Hh, N, dh, generator=gen).to("cuda", cdt)
                       for _ in range(4))
        got, want = flash_kernel(q, k, v, do, dh ** -0.5), flash_plain(q, k, v, do, dh ** -0.5)
        e_fwd = compare(f"K15 flash_mha out B={B} H={Hh} N={N} {name}", got[0], want[0], cdt,
                        False, TOL_VIT)
        e_bwd = max(compare(f"K15 flash_mha {n} B={B} H={Hh} N={N} {name}", a, b, cdt, True,
                            TOL_VIT) for n, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]))
        if cdt == torch.bfloat16:
            errs = {"vit_attn_flash_fwd": e_fwd, "vit_attn_flash_bwd": e_bwd}
    return errs


def flash_timing(gpu: str) -> dict:
    """`[flash]`: K15's forward and backward at main_dino's globals, bf16,
    against the plain version, the bound and SDPA's flash kernels on the same
    q, k, v (the yardstick the port no longer calls) → kernels-line rows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from cerebra_torch.models.vit_attn import flash_mha

    B, N, Hh, dh = 16, 785, H_VIT, D_VIT // H_VIT
    scale, bf = dh ** -0.5, torch.bfloat16
    gen = torch.Generator().manual_seed(16)
    q, k, v, do = (torch.randn(B, Hh, N, dh, generator=gen).to("cuda", bf) for _ in range(4))
    out = flash_mha(q, k, v, scale)

    def sdpa_both():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        torch.autograd.grad(sdpa(qg, kg, vg, scale=scale), (qg, kg, vg), do)

    with torch.no_grad():
        fwd = {"ms": time_windows(lambda: flash_mha(q, k, v, scale), 10, 3, 2)[0],
               "plain_ms": time_windows(lambda: flash_plain(q, k, v, None, scale), 3, 1, 1)[0]}
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            fwd["library_ms"] = time_windows(lambda: sdpa(q, k, v, scale=scale), 10, 3, 2)[0]
    both = {"ms": time_windows(lambda: flash_kernel(q, k, v, do, scale), 10, 3, 2)[0],
            "plain_ms": time_windows(lambda: flash_plain(q, k, v, do, scale), 3, 1, 1)[0]}
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        both["library_ms"] = time_windows(sdpa_both, 10, 3, 2)[0]
    n = 5
    kernels, wall_ms, _ = device_kernels(lambda: flash_kernel(q, k, v, do, scale), n)
    device = sum(ms for _, ms in kernels) / n
    cores = sum(ms for name, ms in kernels if "attn_fwd" in name or "attn_bwd" in name) / n
    log(f"[flash] K15 forward + backward by device time: {device:.4f} ms a call, the attention "
        f"cores {cores:.4f}, the layout copies, casts and scaling {device - cores:.4f}; "
        f"{wall_ms:.4f} ms a call on the host clock under the profiler on {gpu}")
    both.update(fwd_bwd_device_ms=device, fwd_bwd_cores_ms=cores)
    # the forward's products: QKᵀ and PV, 4·B·H·N²·dh; the backward's S
    # again, dV, dP, dQ and dK, 2.5 times that; bytes: q, k, v in and o
    # out, then q, k, v, o and do in and dq, dk, dv out
    ops = 4 * B * Hh * N * N * dh
    rows = {}
    for name, row, flops, moved in (
            ("vit_attn_flash_fwd", fwd, ops, nbytes(q, k, v, out)),
            ("vit_attn_flash_bwd", {k_: both[k_] - fwd.get(k_, 0.0) for k_ in both}, 2.5 * ops,
             nbytes(q, k, v, out, do) + 3 * nbytes(q))):
        t_ops, t_mem = flops / PEAK_FLOPS[bf], moved / HBM_BYTES_PER_S
        rows[name] = dict(row, bound_ms=max(t_ops, t_mem) * 1e3,
                          bound_by="operations" if t_ops > t_mem else "bytes")
        log(f"[flash] {name} B={B} H={Hh} N={N} dh={dh} bf16: {fmt_row(rows[name])} (SDPA "
            f"flash; the backward rows are forward + backward less the forward) on {gpu}")
    return rows


def flash_main_dino(gpu: str) -> dict:
    """Two main_dino steps at full width with --use_flash true
    --use_fused_attn false: every global view forward (the student's and
    the teacher's, N = 785) runs K15's forward core in all 12 blocks, every
    student backward its backward cores; the locals (N = 145 < 512) take the
    softmax path → the launches."""
    from cerebra_torch.cli.main_dino import main
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    log_dir = analysis_dir("main_dino_flash")
    steps = 2  # 2 classes x 8 trials at batch 8, one epoch
    reset_launches()
    t0 = time.perf_counter()
    state, hist = main(["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "8",
                        "--epochs", "1", "--warmup_epochs", "0", "--use_flash", "true",
                        "--use_fused_attn", "false", "--device", "cuda", "--log_dir", log_dir]
                       + ONE_CARD)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if state.step != steps or not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"main_dino --use_flash: {state.step} steps, losses {hist['loss']}")
    want = {"vit_attn_core_fwd": 24 * steps, "vit_attn_core_bwd": 12 * steps,
            "vit_attn_fwd": 0, "vit_attn_bwd": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"main_dino --use_flash launched {launches}, not {want}")
    log(f"[flash] main_dino --use_flash true --use_fused_attn false: {steps} steps in "
        f"{seconds:.1f} s (the model's init included), losses {hist['loss']}; K15 forward "
        f"{launches['vit_attn_core_fwd']} launches (12 a global view forward, 2 a step), "
        f"backward {launches['vit_attn_core_bwd']} on {gpu}")
    del state
    torch.cuda.empty_cache()
    return {"vit_attn_flash_fwd": launches["vit_attn_core_fwd"],
            "vit_attn_flash_bwd": launches["vit_attn_core_bwd"]}


def phase_analysis(gpu: str) -> tuple:
    """Phase 15 → (errors, timing rows, launches) of K15."""
    analysis_greedy(gpu)
    analysis_sweep(gpu)
    dino_retrieval(gpu)
    attention_maps(gpu)
    errs = flash_parity(gpu)
    rows = flash_timing(gpu)
    return errs, rows, flash_main_dino(gpu)


# Phase 16: the teacher-feature and image-backbone slice. The DINOv2
# ViT-S/14 teacher (D 384, 6 heads, F 1536, LayerScale) in f32 at the
# extract_features batch: 224 px (N = 257) over 5 batches of 64, 518 px
# (N = 1370, the model's own grid) over one batch of 40; noise_probe's
# ViT-Ti/16 at 64 px (16 images, N = 17). name -> (kernel, B, N, D, heads, F)
TEACHER_KERNELS = {
    "vit_attn_fwd_dinov2_224": ("vit_attn_fwd", 64, 257, 384, 6, 1536),
    "vit_mlp_fwd_dinov2_224": ("vit_mlp_fwd", 64, 257, 384, 6, 1536),
    "vit_attn_fwd_dinov2_518": ("vit_attn_fwd", 40, 1370, 384, 6, 1536),
    "vit_mlp_fwd_dinov2_518": ("vit_mlp_fwd", 40, 1370, 384, 6, 1536),
    "vit_attn_fwd_noise_probe": ("vit_attn_fwd", 16, 17, 192, 3, 768),
    "vit_mlp_fwd_noise_probe": ("vit_mlp_fwd", 16, 17, 192, 3, 768),
}
REPLACES.update({name: REPLACES[k] for name, (k, *_) in TEACHER_KERNELS.items()})
TEACHER_SOURCES = {name: VIT_SOURCES[k] for name, (k, *_) in TEACHER_KERNELS.items()}
# the hub's names and the width of each one's features
HUB_WIDTHS = {"dino_vits16": 384, "dino_vits8": 384, "dino_vitb16": 768, "dino_vitb8": 768,
              "dino_resnet50": 2048, "dino_xcit_small_12_p16": 384,
              "dino_xcit_small_12_p8": 384, "dino_xcit_medium_24_p16": 512,
              "dino_xcit_medium_24_p8": 512, "dinov2_vits14": 384}
HUB_VITS = ("dino_vits16", "dino_vits8", "dino_vitb16", "dino_vitb8", "dinov2_vits14")


def teacher_dir(name: str) -> str:
    import shutil

    path = os.path.join(ROOT, "build", "chip_smoke", "teacher", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def dinov2_hub_state_dict(seed: int) -> dict:
    """A random DINOv2 ViT-S/14 in the torch.hub dinov2_vits14 layout: the
    port's seeded init, a 37 x 37 pos grid, LayerScale gammas U(0.5, 1.5)
    (at their 1e-5 init a wrong branch would hide), an unused mask_token."""
    from cerebra_torch.models.vit import vit_small_dinov2

    gen = torch.Generator().manual_seed(seed)
    sd = vit_small_dinov2(generator=gen).state_dict()
    for k in sd:
        if k.endswith(("ls1.gamma", "ls2.gamma")):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=gen)
    sd["mask_token"] = torch.zeros(1, 384)
    return sd


def layer_scale_half_blocks(B: int, N: int, D: int, Hh: int, Fv: int, seed: int):
    """x (B, N, D) and the f32 parameters of K5 and K7 with LayerScale
    gammas U(0.5, 1.5) folded into proj and fc2, as `Block` folds them."""
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    gen = torch.Generator().manual_seed(seed)

    def r(*shape, sc=0.05, base=0.0):
        return (torch.randn(*shape, generator=gen) * sc + base).to("cuda")

    g1 = (0.5 + torch.rand(D, generator=gen)).to("cuda")
    g2 = (0.5 + torch.rand(D, generator=gen)).to("cuda")
    x = r(B, N, D, sc=1.0)
    pa = va._prep(r(D, base=1.0), r(D), r(D, 3 * D), r(3 * D), r(D, D) * g1, r(D) * g1, Hh,
                  torch.float32)
    pm = vm._prep(r(D, base=1.0), r(D), r(D, Fv), r(Fv), r(Fv, D) * g2, r(D) * g2,
                  torch.float32)
    return x, pa, pm


def teacher_kernels(gpu: str, which) -> tuple:
    """K5 and K7 with LayerScale alone at `which` of TEACHER_KERNELS' shapes:
    against their plain versions (the tail tiles of N = 257, 1370, 17) and
    timed against the plain versions and their bound → (errors, rows)."""
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    errs, rows = {}, {}
    f32 = torch.float32
    for attn_name, mlp_name in which:
        _, B, N, D, Hh, Fv = TEACHER_KERNELS[attn_name]
        x, pa, pm = layer_scale_half_blocks(B, N, D, Hh, Fv, seed=N)
        xm = x.reshape(B * N, D)
        tag = f"B={B} N={N} D={D} heads={Hh} LayerScale f32"
        errs[attn_name] = compare(f"K5 out {tag}", va.attn_fwd(x, None, pa, Hh)[0],
                                  va._attn_fwd_ref(x, None, pa, Hh)[0], f32, False, TOL_VIT)
        errs[mlp_name] = compare(f"K7 out {tag}", vm.mlp_fwd(xm, None, pm)[0],
                                 vm._mlp_fwd_ref(xm, None, pm)[0], f32, False, TOL_VIT)
        M = B * N
        # f32 products: qkv, proj and the two attention products; fc1 and fc2
        for name, kern, plain, inputs, flops in (
                (attn_name, lambda: va.attn_fwd(x, None, pa, Hh),
                 lambda: va._attn_fwd_ref(x, None, pa, Hh), (x, pa),
                 8 * M * D * D + 4 * B * N * N * D),
                (mlp_name, lambda: vm.mlp_fwd(xm, None, pm), lambda: vm._mlp_fwd_ref(xm, None, pm),
                 (xm, pm), 4 * M * D * Fv)):
            # no one PyTorch call computes a fused half-block: library none
            rows[name] = timing_row(kern, plain, inputs, flops, f32, 5, 2)
            log(f"[teacher kernels] {name} ({tag}, {flops / 1e9:.1f} GFLOP): "
                f"{fmt_row(rows[name])} on {gpu}")
        del x, xm, pa, pm
    torch.cuda.empty_cache()
    return errs, rows


def teacher_extract(argv, n: int, kernels: tuple, per_batch: int):
    """One extract_features run → (features, seconds, launches); checks the
    features (finite, (n, 384) or the CLI's width, aligned to the labels)
    and that each of `kernels` launched `per_batch` times a batch of 64."""
    from cerebra_torch.cli import extract_features as ef
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    out = os.path.join(teacher_dir("out"), "features.npz")
    reset_launches()
    t0 = time.perf_counter()
    ef.main(argv + ["--device", "cuda", "--out", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ran = {k: v for k, v in LAUNCHES.items() if v}
    saved = np.load(out)
    feats, labels = saved["features"], saved["labels"]
    classes = int(argv[argv.index("--synthetic_classes") + 1])
    want_labels = np.repeat(np.arange(classes), n // classes)
    batches = -(-n // 64)
    if ran != dict.fromkeys(kernels, per_batch * batches):
        raise AssertionError(f"extract_features {argv} launched {ran}")
    if feats.shape[0] != n or not np.isfinite(feats).all() or not np.array_equal(labels,
                                                                                 want_labels):
        raise AssertionError(f"extract_features wrote {feats.shape}, labels {labels[:8]}")
    return feats, seconds, ran


def teacher_features(gpu: str) -> tuple:
    """`[teacher features]` → (errors, rows, launches) of the kernels line's
    DINOv2 entries: extract_features --teacher dinov2_jax from a random hub
    dict at 224 px (40 x 8 images, 5 batches of 64) and 518 px (40 x 1), one
    batch at each size held against the unfused model on the card, K5/K7
    alone at both shapes; then --teacher dino_ckpt (a vit_small/8 checkpoint
    by export_dino_pth, 224 px) and --teacher random_vit."""
    from cerebra_torch.data.sources import synthetic_image_source
    from cerebra_torch.models.dino_model import DinoArgs, DinoModel, dino_image_transform
    from cerebra_torch.models.multicrop import MultiCropWrapper
    from cerebra_torch.models.vit import import_dinov2_vit_torch, vit_small_dinov2
    from cerebra_torch.train.checkpoints import export_dino_pth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = os.path.join(teacher_dir("weights"), "dinov2_vits14.pth")
    sd = dinov2_hub_state_dict(16)
    torch.save(sd, weights)
    errs, rows = teacher_kernels(gpu, (("vit_attn_fwd_dinov2_224", "vit_mlp_fwd_dinov2_224"),
                                       ("vit_attn_fwd_dinov2_518", "vit_mlp_fwd_dinov2_518")))
    launches = {}
    vit_fwd = ("vit_attn_fwd", "vit_mlp_fwd")
    for size, per_class, suffix in ((224, 8, "224"), (518, 1, "518")):
        n = 40 * per_class
        argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class",
                str(per_class), "--image_size", str(size), "--teacher", "dinov2_jax",
                "--teacher_weights", weights]
        feats, seconds, ran = teacher_extract(argv, n, vit_fwd, 12)
        if feats.shape[1] != 384:
            raise AssertionError(f"DINOv2 features {feats.shape}")
        for k in vit_fwd:
            launches[f"{k}_dinov2_{suffix}"] = ran[k]
        # one batch through the fused model and the same model unfused
        src = synthetic_image_source(40, per_class, size, seed=43)
        batch = torch.from_numpy(np.stack([dino_image_transform(src.images[i], size)
                                           for i in range(min(64, n))])).cuda()
        fused, unfused = vit_small_dinov2(), vit_small_dinov2(use_fused_attn=False,
                                                              use_fused_mlp=False)
        for m in (fused, unfused):
            m.load_state_dict(import_dinov2_vit_torch(sd))
            m.cuda().eval()
        with torch.inference_mode():
            got, want = fused(batch), unfused(batch)
        compare(f"DINOv2 ViT-S/14 features at {size} px (N = {(size // 14) ** 2 + 1}), "
                f"B = {len(batch)}: K5/K7 against the unfused model, f32", got, want,
                torch.float32, False, TOL_VIT)
        if not torch.allclose(got.cpu(), torch.from_numpy(feats[:len(batch)]), atol=TOL_VIT[0]):
            raise AssertionError(f"extract_features' first batch at {size} px differs from "
                                 "the model's")
        del fused, unfused, batch, got, want
        a, m = rows[f"vit_attn_fwd_dinov2_{suffix}"], rows[f"vit_mlp_fwd_dinov2_{suffix}"]
        log(f"[teacher features] dinov2_jax at {size} px: {n} images in {seconds:.2f} s "
            f"({n / seconds:.1f} images/s, host preprocessing and the model's load "
            f"included), launches {ran}; K5 {a['ms']:.3f} ms a launch (bound "
            f"{a['bound_ms']:.3f}), K7 {m['ms']:.3f} ms (bound {m['bound_ms']:.3f}) on {gpu}")
    torch.cuda.empty_cache()
    ckpt = os.path.join(teacher_dir("dino_ckpt"), "checkpoint.pth")
    small = DinoModel(DinoArgs(arch="vit_small", patch_size=8), seed=7)
    wrapped = MultiCropWrapper(small.backbone, small.head)
    export_dino_pth(ckpt, wrapped, wrapped, torch.zeros(1, 65536), epoch=0)
    del small, wrapped
    for teacher, extra in (("dino_ckpt", ["--teacher_weights", ckpt]), ("random_vit", [])):
        argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "2",
                "--teacher", teacher, "--arch", "vit_small", "--patch_size", "8"] + extra
        feats, seconds, ran = teacher_extract(argv, 80, vit_fwd, 12)
        log(f"[teacher features] {teacher} (vit_small/8, 224 px, N = 785): 80 images in "
            f"{seconds:.2f} s, features {feats.shape}, launches {ran}")
    return errs, rows, launches


def noise_probe_phase(gpu: str) -> tuple:
    """`[noise probe]`: noise_probe at its defaults (ViT-Ti/16 at 64 px, 16
    noise images on a synthetic prior): a finite JSON, 12 K5 and 12 K7 a
    forward (real and noise); K5/K7 alone at N = 17."""
    from cerebra_torch.cli import noise_probe
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    errs, rows = teacher_kernels(gpu, (("vit_attn_fwd_noise_probe",
                                        "vit_mlp_fwd_noise_probe"),))
    log_dir = teacher_dir("noise_probe")
    reset_launches()
    t0 = time.perf_counter()
    out = noise_probe.main(["--device", "cuda", "--log_dir", log_dir, "--images_root",
                            os.path.join(log_dir, "none")])
    seconds = time.perf_counter() - t0
    ran = {k: v for k, v in LAUNCHES.items() if v}
    with open(os.path.join(log_dir, "noise_probe.json")) as f:
        saved = json.load(f)
    if ran != {"vit_attn_fwd": 24, "vit_mlp_fwd": 24} or saved != out or not all(
            math.isfinite(v) for v in saved.values()) or saved["feature_dim"] != 192:
        raise AssertionError(f"noise_probe: {saved}, launches {ran}")
    log(f"[noise probe] {seconds:.2f} s, {saved}, launches {ran} on {gpu}")
    return errs, rows, {f"{k}_noise_probe": ran[k] for k in ("vit_attn_fwd", "vit_mlp_fwd")}


def hub_phase(gpu: str) -> None:
    """`[hub]`: every hub name with pretrained=False forwards 8 images at 224
    px on the card (the ViTs through K5/K7 in each block); one ViT and one
    XCiT load weights the phase wrote into the local cache and forward as
    the model built from the same dict; XCiT-S12/16 and DINOv2 ViT-S/14
    timed at B = 64."""
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import hub
    from cerebra_torch.models.vit import vit_small
    from cerebra_torch.models.xcit import xcit_small_12_p16

    gen = torch.Generator().manual_seed(16)
    x = torch.randn(8, 224, 224, 3, generator=gen).cuda()
    reset_launches()
    for name, width in HUB_WIDTHS.items():
        t0 = time.perf_counter()
        model = hub.load(name, pretrained=False).cuda()
        with torch.inference_mode():
            out = model(x)
        torch.cuda.synchronize()
        if tuple(out.shape) != (8, width) or not torch.isfinite(out).all():
            raise AssertionError(f"hub {name}: features {tuple(out.shape)}")
        log(f"[hub] {name}: (8, {width}) features in {time.perf_counter() - t0:.2f} s "
            f"(build on the host included)")
        del model, out
    ran = {k: v for k, v in LAUNCHES.items() if v}
    if ran != {"vit_attn_fwd": 12 * len(HUB_VITS), "vit_mlp_fwd": 12 * len(HUB_VITS)}:
        raise AssertionError(f"hub forwards launched {ran}")
    cache = teacher_dir("hub_cache")
    os.environ["CEREBRA_HUB_CACHE"] = cache
    for name, src, url in (
            ("dino_vits16", vit_small(patch_size=16, generator=gen),
             hub.PRETRAINED_URLS[("vit_small", 16)]),
            ("dino_xcit_small_12_p16", xcit_small_12_p16(generator=gen),
             hub.PRETRAINED_URLS[("xcit_small_12_p16", None)])):
        torch.save(src.state_dict(), os.path.join(cache, url.rsplit("/", 1)[-1]))
        loaded = hub.load(name).cuda()
        src = src.cuda().eval()
        with torch.inference_mode():
            err = (loaded(x) - src(x)).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"hub {name} from the local cache: {err} off the model "
                                 "built from the same dict")
        log(f"[hub] {name} loaded from the local cache: forward equal to the model of the "
            f"same dict")
        del loaded, src
    for name in ("dino_xcit_small_12_p16", "dinov2_vits14"):
        model = hub.load(name, pretrained=False).cuda()
        xb = torch.randn(64, 224, 224, 3, generator=gen).cuda()
        with torch.inference_mode():
            med, lo, hi = time_windows(lambda: model(xb), 3, 3, 1)
        log(f"[hub timing] {name} forward at B = 64, 224 px, f32: {med:.2f} ms "
            f"({64e3 / med:.0f} images/s; windows {lo:.2f}-{hi:.2f}) on {gpu}")
        del model, xb
    torch.cuda.empty_cache()


def dino_images(gpu: str) -> None:
    """`[dino images]`: two steps of dino_vit_train with stimulus-image locals
    at main_dino's defaults (ViT-S/8, out_dim 65536, 2 x 224 px EEG globals,
    4 x 96 px image crops, batch 8, bf16, drop path 0.1): a finite loss and
    K5/K7 36 times, K6/K8 24 times a step; the crops on the card against
    the CPU for the same draws."""
    from cerebra_torch.data.sources import synthetic_image_source
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.signal.image_aug import dino_local_crop, draw_crop
    from cerebra_torch.train.dino_vit import DinoVitConfig, dino_vit_train

    gen = torch.Generator().manual_seed(16)
    images = synthetic_image_source(8, 2, 224, seed=16).images.astype(np.float32) / 255.0
    eeg = torch.randn(16, T, C, generator=gen).numpy()
    draws = draw_crop(gen, (4, 8), 224, 224, scale=(0.05, 0.4), blur_p=0.5)
    crops = torch.from_numpy(images[:8])
    compare("stimulus-image local crops 4 x 8 at 96 px, CUDA against the CPU",
            dino_local_crop(crops.cuda(), draws, 96).cpu(), dino_local_crop(crops, draws, 96),
            torch.float32, False)
    cfg = DinoVitConfig(epochs=1, batch_size_per_device=8, dtype=torch.bfloat16)
    reset_launches()
    t0 = time.perf_counter()
    state, hist = dino_vit_train(eeg, images=images, config=cfg, device=torch.device("cuda"),
                                 log_fn=lambda m: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ran = {k: v for k, v in LAUNCHES.items() if v}
    want = {"vit_attn_fwd": 72, "vit_mlp_fwd": 72, "vit_attn_bwd": 48, "vit_mlp_bwd": 48}
    if state.step != 2 or ran != want or not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"dino_vit_train with images: {state.step} steps, loss "
                             f"{hist['loss']}, launches {ran}")
    log(f"[dino images] 2 steps with image locals in {seconds:.1f} s (init included), loss "
        f"{hist['loss'][0]:.4f}, launches {ran} on {gpu}")
    del state
    torch.cuda.empty_cache()


def phase_teacher(gpu: str) -> tuple:
    """Phase 16 → (errors, timing rows, launches) of TEACHER_KERNELS."""
    errs, rows, launches = teacher_features(gpu)
    e, r, n = noise_probe_phase(gpu)
    errs.update(e)
    rows.update(r)
    launches.update(n)
    hub_phase(gpu)
    dino_images(gpu)
    return errs, rows, launches


# Phase 17: the Barlow Twins and Conformer trainers. The JAX package computes
# them in plain XLA, so the port runs stock PyTorch (cuDNN convolutions,
# cuBLAS products, torch.stft): no kernel of this repo, no kernels-line entry.
# Barlow at the CLI's defaults (2 x ResNet-50, projector 8192-8192-8192,
# n_mels 224, 224 px, B 16, f32) on 40 x 4 synthetic (96, 512) trials: 10
# steps an epoch. The Conformer at its CLI's defaults (emb 40, depth 6, out
# 384, batch 72 + 72 S&R rows, 22 x 1000, bf16) on the synthetic BCI-IV
# corpus, 50 epochs.
BARLOW_ARGV = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "4",
               "--epochs", "2"] + ONE_CARD
CONFORMER_ARGV = ["--synthetic", "--n_epochs", "50", "--subjects", "1"] + ONE_CARD
# device-time parts of a Barlow step, by kernel name (first match)
BARLOW_PARTS = (("fprop", "convolution fwd"), ("dgrad", "convolution dgrad"),
                ("wgrad", "convolution wgrad"), ("conv", "convolution other"),
                ("batch_norm", "BatchNorm"), ("gemm", "matrix products"),
                ("gemv", "matrix products"), ("reduce", "reductions"), ("norm", "reductions"),
                ("elementwise", "elementwise"), ("vectorized", "elementwise"))


@contextlib.contextmanager
def conv_tf32(on: bool):
    """cuDNN's TF32 for convolutions (torch's default: on) and cuBLAS's for
    products (default: off) for the enclosed code; restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = on, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def trainer_dir(name: str) -> str:
    import shutil

    path = os.path.join(ROOT, "build", "chip_smoke", "trainers", name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def barlow_batch(B: int, seed: int):
    """B pairs at the CLI's shapes: 224 px images and (224, 8, 96) mels."""
    gen = torch.Generator().manual_seed(seed)
    return (0.45 + 0.22 * torch.randn(B, 224, 224, 3, generator=gen),
            5.0 * torch.rand(B, 224, 8, 96, generator=gen))


def barlow_run(gpu: str) -> None:
    """`[barlow]`: barlow_train.main at its defaults, 2 epochs of 10 steps:
    finite losses, ms/step and pairs/s on the host clock after the first
    epoch, the corpus spectrogram's seconds and peak, checkpoint.pt reloaded
    and forwarding as the trained model; one step on the card against the
    CPU from the same weights, TF32 off, and both against the CPU in f64."""
    import copy

    from cerebra_torch.cli import barlow_train
    from cerebra_torch.cli.common import load_corpus, reference_argparser
    from cerebra_torch.models.barlow import BarlowTwins
    from cerebra_torch.train import barlow_recipe

    log_dir = trainer_dir("barlow")
    flags = reference_argparser("").parse_known_args(BARLOW_ARGV)[0]
    eeg = load_corpus(flags).eeg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    spec = barlow_recipe.barlow_spectrogram(eeg, 224, 256.0, torch.device("cuda"))
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    spec_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    if tuple(spec.shape) != (len(eeg), 224, 8, 96) or not torch.isfinite(spec).all():
        raise AssertionError(f"barlow spectrogram {tuple(spec.shape)}")
    log(f"[barlow] corpus spectrogram ({len(eeg)}, 224, 8, 96) in {spec_s:.3f} s, peak "
        f"{spec_gib:.3f} GiB above the corpus on {gpu}")
    del spec
    torch.cuda.reset_peak_memory_stats()
    with conv_tf32(True):
        t0 = time.perf_counter()
        model, hist = barlow_train.main(BARLOW_ARGV + ["--device", "cuda", "--log_dir", log_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(hist["loss"]) != 2 or not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"barlow losses {hist['loss']}")
    ms = hist["epoch_time_s"][1] * 1e3 / 10
    log(f"[barlow] barlow_train.main (2 x ResNet-50, projector 8192-8192-8192, B 16, f32, "
        f"cuDNN TF32 on): {seconds:.1f} s in all, losses {[round(v, 2) for v in hist['loss']]}, "
        f"epoch 1 {ms:.2f} ms/step ({16e3 / ms:.1f} pairs/s; epoch 0 "
        f"{hist['epoch_time_s'][0] * 1e3 / 10:.2f} ms/step), peak {peak:.2f} GiB on {gpu}")
    loaded = barlow_train.load_checkpoint(os.path.join(log_dir, barlow_train.CHECKPOINT),
                                          device=torch.device("cuda"))
    y1, y2 = (t.cuda() for t in barlow_batch(4, 17))
    model.eval()
    with torch.inference_mode():
        want = model(y1, y2)
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(loaded(y1, y2), want))
    if not err <= 1e-6:
        raise AssertionError(f"checkpoint.pt forwards {err} off the trained model")
    log(f"[barlow] checkpoint.pt reloaded: eval forward on 4 pairs {err:.1e} (relative, limit "
        f"1e-6) off the trained model's")
    del model, loaded

    # one step from the same weights and batch on the card (f32), on the CPU
    # (f32) and on the CPU in f64. f32 itself carries ~5e-3 (relative
    # Frobenius) in these gradients: the loss's batch-16 BatchNorm
    # subtracts most of each column's gradient. So the card's gradients are
    # held to the f64 ones no worse than twice the CPU's f32 ones are.
    cfg = barlow_recipe.BarlowConfig(epochs=2, batch_size=16, warmup_epochs=0)  # lr > 0 at once
    cpu = BarlowTwins(generator=torch.Generator().manual_seed(17))
    runs = {"card": copy.deepcopy(cpu).cuda(), "cpu": cpu, "f64": copy.deepcopy(cpu).double()}
    y1, y2 = barlow_batch(16, 18)
    out = {}
    with conv_tf32(False):
        for name, m in runs.items():
            p0 = next(m.parameters())
            loss = barlow_recipe.barlow_step(m, barlow_recipe.barlow_optimizer(m, cfg, 10),
                                             y1.to(p0.device, p0.dtype),
                                             y2.to(p0.device, p0.dtype), 0, cfg.lambd).item()
            out[name] = (loss, {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()},
                         {k: v.cpu() for k, v in m.state_dict().items() if "running" in k})
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu), (_, g64, _) = (out[k] for k in runs)

    def rel_frob(g):
        return (sum(float((g[k] - g64[k]).square().sum()) for k in g64)
                / sum(float(v.square().sum()) for v in g64.values())) ** 0.5

    rel = abs(l_card - l_cpu) / abs(l_cpu)
    e_card, e_cpu = rel_frob(g_card), rel_frob(g_cpu)
    stats = max(((s_card[k] - v).abs().max() / v.abs().max()).item() for k, v in s_cpu.items())
    log(f"[barlow] one step on the card against the CPU from the same weights (TF32 off): "
        f"loss {l_card:.6f} vs {l_cpu:.6f} (rel {rel:.2e}, limit 1e-4); running statistics rel "
        f"{stats:.2e} (limit 1e-4); every gradient against the CPU's f64 step: card "
        f"rel_frob {e_card:.2e}, CPU f32 {e_cpu:.2e} (limit: the card within 2x the CPU's)")
    if not (rel <= 1e-4 and stats <= 1e-4 and e_card <= max(2 * e_cpu, 1e-5)):
        raise AssertionError("Barlow step on the card disagrees with the CPU")
    del runs
    del cpu
    torch.cuda.empty_cache()


def barlow_remat(gpu: str) -> None:
    """`[barlow remat]`: one step at B = 64 with remat off and on from the
    same weights: the loss and every running statistic equal within 1e-5;
    the peak memory of each."""
    import copy

    from cerebra_torch.models.barlow import BarlowTwins
    from cerebra_torch.train import barlow_recipe

    cfg = barlow_recipe.BarlowConfig(epochs=2, batch_size=64)
    src = BarlowTwins(generator=torch.Generator().manual_seed(19))
    y1, y2 = (t.cuda() for t in barlow_batch(64, 20))
    out = {}
    with conv_tf32(True):
        for remat in (False, True):
            m = copy.deepcopy(src)
            for tower in (m.backbone_image, m.backbone_eeg):
                tower.remat = remat
            m.cuda()
            opt = barlow_recipe.barlow_optimizer(m, cfg, 10)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            loss = barlow_recipe.barlow_step(m, opt, y1, y2, 0, cfg.lambd).item()
            torch.cuda.synchronize()
            out[remat] = (loss, (torch.cuda.max_memory_allocated() - base) / 2**30,
                          time.perf_counter() - t0,
                          {k: v.cpu() for k, v in m.state_dict().items() if "running" in k})
            del m, opt
            torch.cuda.empty_cache()
    (l0, p0, s0, st0), (l1, p1, s1, st1) = out[False], out[True]
    rel = abs(l0 - l1) / abs(l0)
    stats = max(((st1[k] - v).abs().max() / v.abs().max()).item() for k, v in st0.items())
    log(f"[barlow remat] one step at B = 64: loss {l0:.6f} / {l1:.6f} (rel {rel:.2e}), running "
        f"statistics rel {stats:.2e} (limit 1e-5); peak above the weights {p0:.2f} GiB without "
        f"remat, {p1:.2f} GiB with nested stage + block remat ({p1 / p0:.2f}x; first steps "
        f"{s0:.2f} / {s1:.2f} s) on {gpu}")
    if not (rel <= 1e-5 and stats <= 1e-5):
        raise AssertionError("remat changed the Barlow step")


def barlow_profile(gpu: str) -> None:
    """`[barlow profile]`: torch.profiler over 5 Barlow steps at the CLI's
    shapes: device ms by part and the top kernels, the idle share, the
    host's ops."""
    from cerebra_torch.models.barlow import BarlowTwins
    from cerebra_torch.train import barlow_recipe

    cfg = barlow_recipe.BarlowConfig(epochs=2, batch_size=16)
    m = BarlowTwins(generator=torch.Generator().manual_seed(21)).cuda()
    opt = barlow_recipe.barlow_optimizer(m, cfg, 10)
    y1, y2 = (t.cuda() for t in barlow_batch(16, 22))
    step = [0]

    def one():
        barlow_recipe.barlow_step(m, opt, y1, y2, step[0], cfg.lambd)
        step[0] += 1

    with conv_tf32(True):
        one()
        kernels, wall_ms, host = device_kernels(one, 5)
    # record_function ranges (`Optimizer.step#Lars.step`) come back among the
    # device events, spanning the kernels they hold: not kernels
    kernels = [(name, ms) for name, ms in kernels if "#" not in name]
    parts, names = {}, {}
    for name, ms in kernels:
        low = name.lower()
        part = next((p for frag, p in BARLOW_PARTS if frag in low), "other")
        parts[part] = parts.get(part, 0.0) + ms / 5
        names[name[:70]] = names.get(name[:70], 0.0) + ms / 5
    busy = sum(parts.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    log(f"[barlow profile] {wall_ms:.2f} ms/step under the profiler, device busy {busy:.2f} ms "
        f"(idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %), {len(kernels) // 5} kernels a step; "
        f"by part { {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} } "
        f"on {gpu}")
    log(f"[barlow profile] top kernels {[(k, round(v, 3)) for k, v in top]}")
    log(f"[barlow profile] host ms per step by op, self time under the profiler (top 8 of "
        f"{sum(ms for _, ms in host):.1f}): {[(k[:40], round(ms, 2)) for k, ms in host[:8]]}")
    del m, opt
    torch.cuda.empty_cache()


def conformer_run(gpu: str) -> None:
    """`[conformer]`: conformer_train.main --synthetic at its defaults for 50
    epochs: finite losses (the recipe also raises on one), best accuracy
    above chance, the three files, ms/epoch; one f32 step on the card
    against the CPU from the same weights, batch and dropout masks, and
    both against the CPU in f64."""
    import copy
    import io
    import re
    from unittest import mock

    from cerebra_torch.cli import conformer_train
    from cerebra_torch.models.conformer import Conformer
    from cerebra_torch.train import conformer_recipe

    log_dir = trainer_dir("conformer")
    hists = []

    def keep(*args, **kw):
        model, hist = conformer_recipe.conformer_exp_train(*args, **kw)
        hists.append(hist)
        return model, hist

    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(conformer_train, "conformer_exp_train", keep), \
            contextlib.redirect_stdout(out):
        results = conformer_train.main(CONFORMER_ARGV + ["--device", "cuda", "--log_dir",
                                                         log_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (subject, best, aver), = results
    losses = [float(v) for v in re.findall(r"Train loss: (\S+)", out.getvalue())]
    files = [f for f in ("log_subject1.txt", "sub_result.txt", "conformer_subject1.pt")
             if os.path.exists(os.path.join(log_dir, f))]
    if len(losses) != 50 or not all(map(math.isfinite, losses)) or best <= 0.25 or \
            len(files) != 3:
        raise AssertionError(f"conformer: losses {losses[-3:]}, best {best}, files {files}")
    per_epoch = sorted(hists[0]["epoch_time_s"][1:])
    log(f"[conformer] conformer_train.main (emb 40, depth 6, out 384, batch 72 + 72 S&R, "
        f"22 x 1000, bf16), 50 epochs of 1 step in {seconds:.1f} s: train "
        f"{per_epoch[len(per_epoch) // 2] * 1e3:.2f} ms/epoch (median of epochs 1-49, eval "
        f"apart), last loss {losses[-1]:.4f}, best accuracy {best:.4f}, average {aver:.4f}, "
        f"files {files} on {gpu}")

    # the same batch and masks on the card (f32), the CPU (f32) and the CPU
    # in f64: the losses, and every gradient against the f64 one
    cpu = Conformer(generator=torch.Generator().manual_seed(23))
    runs = {"card": copy.deepcopy(cpu).cuda(), "cpu": cpu, "f64": copy.deepcopy(cpu).double()}
    gen = torch.Generator().manual_seed(24)
    x = torch.randn(144, 1, 22, 1000, generator=gen)
    y = torch.randint(0, 4, (144,), generator=gen)

    def masks(seed):
        g = torch.Generator().manual_seed(seed)

        def drop(t, rate):
            keep_ = (torch.rand(t.shape, generator=g) >= rate).to(t.device)
            return torch.where(keep_, t / (1.0 - rate), torch.zeros((), dtype=t.dtype,
                                                                    device=t.device))
        return drop

    out = {}
    with conv_tf32(False):
        for name, m in runs.items():
            p0 = next(m.parameters())
            opt = torch.optim.Adam(m.parameters(), lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
            loss = conformer_recipe.conformer_step(m, opt, x.to(p0.device, p0.dtype),
                                                   y.to(p0.device), masks(25)).item()
            out[name] = (loss, {k: p.grad.detach().double().cpu()
                                for k, p in m.named_parameters()})
    (l_card, g_card), (l_cpu, g_cpu), (_, g64) = (out[k] for k in runs)

    def rel_frob(g):
        return (sum(float((g[k] - g64[k]).square().sum()) for k in g64)
                / sum(float(v.square().sum()) for v in g64.values())) ** 0.5

    rel = abs(l_card - l_cpu) / abs(l_cpu)
    e_card, e_cpu = rel_frob(g_card), rel_frob(g_cpu)
    log(f"[conformer] one f32 step on the card against the CPU (same weights, batch, masks; "
        f"TF32 off): loss {l_card:.6f} vs {l_cpu:.6f} (rel {rel:.2e}, limit 1e-4); every "
        f"gradient against the CPU's f64 step: card rel_frob {e_card:.2e}, CPU f32 "
        f"{e_cpu:.2e} (limit: the card within 2x the CPU's)")
    if not (rel <= 1e-4 and e_card <= max(2 * e_cpu, 1e-5)):
        raise AssertionError("Conformer step on the card disagrees with the CPU")


def phase_trainers(gpu: str) -> None:
    """Phase 17: `[barlow]`, `[barlow remat]`, `[barlow profile]`,
    `[conformer]`."""
    barlow_run(gpu)
    barlow_remat(gpu)
    barlow_profile(gpu)
    conformer_run(gpu)


# ------------------------------------------------------------------ phase 18
# On one card the world is two ranks sharing it: both on cuda:0 over gloo
# (NCCL refuses two ranks on one GPU, "Duplicate GPU detected"), and NCCL
# runs at world size one; a machine of W > 1 cards runs W ranks over NCCL,
# one a card. Each rank writes its results to MG_DIR/rank{r}.json.
MG_DIR = os.path.join(ROOT, "build", "chip_smoke", "multi_gpu")
MG_TRAINER = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "30",
              "--feature_dim", "384", "--batch_size", "16", "--device", "cuda"]
MG_EPOCHS, MG_STEPS_PER_EPOCH = 6, 60  # 960 training trials over a global batch of 16
MG_DINO_TRIALS, MG_DINO_EPOCHS = 16, 2  # 8 classes x 2 trials
MG_DINO = ["--synthetic", "--synthetic_classes", "8", "--synthetic_per_class", "2",
           "--batch_size_per_gpu", "4", "--epochs", str(MG_DINO_EPOCHS), "--warmup_epochs", "1",
           "--device", "cuda"]
MG_TOL = 1e-5
MG_TOL_BARLOW_F32 = 1e-2  # 1.9e-3 at W = 2 and 5.3e-3 at W = 4 on the H100
NCCL_CHECK = """
import json, sys, time
import torch
import torch.distributed as dist
from cerebra_torch.cli.common import init_distributed
from cerebra_torch.cli.lstm_distill_from_dinov2_train import main
device = init_distributed(torch.device("cuda"))
x = torch.arange(4.0, device=device) + 1
dist.all_reduce(x)
parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
dist.all_gather(parts, x)
dist.barrier()
t0 = time.perf_counter()
model, hist = main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "device": str(device), "all_reduce": x.tolist(),
                  "all_gather": torch.cat(parts).tolist(), "losses": hist["train_loss"],
                  "seconds": time.perf_counter() - t0}))
dist.destroy_process_group()
"""


def digest(tensors) -> str:
    """sha256 of (name, bytes) over a state dict, in name order."""
    h = hashlib.sha256()
    for k, v in sorted(tensors.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rel_frob(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def mg_trainer() -> dict:
    """`[mg trainer]` on one rank: the full-width CLI, its launches, losses
    and a digest of its weights."""
    from cerebra_torch.cli.lstm_distill_from_dinov2_train import main
    from cerebra_torch.models import lstm_stack as ls

    ls.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, hist = main(MG_TRAINER + ["--num_epochs", str(MG_EPOCHS), "--log_dir",
                                     os.path.join(MG_DIR, "trainer")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in ls.LAUNCHES.items() if v}
    steps = MG_EPOCHS * MG_STEPS_PER_EPOCH
    if (launches.get("fwd_train", 0) < steps or launches.get("bwd", 0) < steps
            or launches.get("fwd_infer_last", 0) < 2):
        raise AssertionError(f"the rank's steps or validation bypassed K1/K2/K3: {launches}")
    grad_dtypes = sorted({str(p.grad.dtype) for p in model.parameters() if p.grad is not None})
    if grad_dtypes != ["torch.float32"]:
        raise AssertionError(f"gradients in {grad_dtypes}, not the f32 master gradients")
    warm = hist["epoch_time_s"][1:]  # epoch 0 carries the kernels' first calls
    return {"losses": hist["train_loss"], "launches": launches, "digest": digest(model.state_dict()),
            "seconds": seconds, "windows_per_s": hist["windows_per_s"],
            "ms_per_step": sum(warm) * 1e3 / (len(warm) * MG_STEPS_PER_EPOCH)}


def opt_of(model, make):
    """The optimizer a step pair keeps on its model, made at the first step."""
    if "_opt" not in model.__dict__:
        model.__dict__["_opt"] = make()
    return model.__dict__["_opt"]


def mg_grads(module) -> dict:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}


def mg_pair(name, build, step, batch, mesh, zero_grad=(), timed=True, grad_tol=MG_TOL,
            **ddp_kwargs) -> dict:
    """One step of `build()` on the whole batch in this process, one on this
    rank's rows under DDP (each the other's warm-up), then (`timed`) 2 timed
    steps of each → errors, the gradients' limit and ms."""
    from cerebra_torch.parallel.mesh import data_parallel, shard_batch

    one = build()
    world = copy.deepcopy(one)
    loss_one = float(step(one, batch, None, True))
    g_one = mg_grads(one)
    ddp = data_parallel(world, mesh, **ddp_kwargs)
    rows = shard_batch(mesh, batch)
    loss_world = float(step(ddp, rows, mesh, True))
    g_world = mg_grads(world)
    errs = {k: rel_frob(g_world[k], g) for k, g in g_one.items() if k not in zero_grad}
    ms = {}
    runs = (("one", one, batch, None), ("world", ddp, rows, mesh)) if timed else ()
    for what, model, b, m in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(model, b, m, False)
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3 / 2
    return {"name": name, "loss_one": loss_one, "loss_world": loss_world,
            "loss_rel": abs(loss_world - loss_one) / abs(loss_one),
            "grad_rel_max": max(errs.values()), "worst": max(errs, key=errs.get),
            "zero_grad": sorted(zero_grad), "ms": ms, "grad_tol": grad_tol}


class MaskTape:
    """Dropout masks drawn for the whole batch in one process, replayed as
    each rank's rows of them in the same order."""

    def __init__(self, seed: int):
        self.gen = torch.Generator("cuda").manual_seed(seed)
        self.masks = []

    def record(self, x, rate):
        mask = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=self.gen)
        self.masks.append(mask.bool())
        return torch.where(self.masks[-1], x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))

    def replay(self, rows: slice):
        it = iter(self.masks)

        def drop(x, rate):
            mask = next(it)[rows]
            return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
        return drop


def mg_steps() -> list:
    """`[mg steps]` on one rank: the f32 step pairs, TF32 off."""
    import torch.distributed as dist

    from cerebra_torch.models import Model
    from cerebra_torch.models.barlow import BarlowTwins
    from cerebra_torch.models.batchnorm import sync_batchnorm
    from cerebra_torch.models.conformer import Conformer
    from cerebra_torch.models.dropout import dropout_from
    from cerebra_torch.parallel.mesh import make_mesh
    from cerebra_torch.train import barlow_recipe
    from cerebra_torch.train.conformer_recipe import conformer_step
    from cerebra_torch.train.optim import make_optimizer
    from cerebra_torch.train.recipes import FeatureDistillConfig, distill_loss
    from cerebra_torch.train.steps import feature_distill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(18)
    out = []

    # the feature-distill step: Model(96, 96, 2, 384) + v1 over 16 windows of 460
    batch = (torch.randn(16, T, C, generator=gen).to(dev), torch.randn(16, F, generator=gen).to(dev),
             torch.randint(0, N_CLASSES, (16,), generator=gen).to(dev))
    temps = np.full(8, 0.5, np.float32)

    def distill(model, b, m, _):
        opt = opt_of(model, lambda: make_optimizer("rmsprop", model.parameters(), 1e-3))
        loss_fn = distill_loss(FeatureDistillConfig(), temps, m and m.group("data"))
        return feature_distill_step(model, opt, loss_fn, *b, 1)

    out.append(mg_pair("feature distill", lambda: Model(C, H, L, F, n_classes=N_CLASSES,
                                                        generator=torch.Generator().manual_seed(0),
                                                        device=dev),
                       distill, batch, mesh))

    # the Barlow step: 2 x ResNet-50 + projector 8192-8192-8192, 16 pairs at 224 px
    cfg = barlow_recipe.BarlowConfig(epochs=2, batch_size=16, warmup_epochs=0)
    y1, y2 = (t.to(dev) for t in barlow_batch(16, 19))

    def barlow(model, b, m, _):
        inner = getattr(model, "module", model)
        sync_batchnorm(inner, m and m.group("data"))
        opt = opt_of(inner, lambda: barlow_recipe.barlow_optimizer(inner, cfg, 10))
        return barlow_recipe.barlow_step(model, opt, b[0], b[1], 0, cfg.lambd,
                                         m and m.group("data"))

    def barlow_twins():
        return BarlowTwins(generator=torch.Generator().manual_seed(17)).to(dev)

    # f32 rounds up to ~1e-2 of these gradients on either side (the batch-16
    # BatchNorms subtract most of each column's gradient; f64 references put
    # one process as often as the ranks at fault), so the f32 pair's
    # gradients are held at 1e-2 (a gradient off by a factor of the world
    # size is 0.5 or more off) and all of them at 1e-5 in f64
    out.append(mg_pair("barlow", barlow_twins, barlow, (y1, y2), mesh,
                       grad_tol=MG_TOL_BARLOW_F32))
    out.append(mg_pair("barlow f64", lambda: barlow_twins().double(), barlow,
                       (y1.double(), y2.double()), mesh, timed=False))

    # the Conformer step: emb 40, depth 6, out 384, 22 x 1000, 72 real + 72 S&R rows
    x = torch.randn(144, 1, 22, 1000, generator=gen).to(dev)
    y = torch.randint(0, 4, (144,), generator=gen).to(dev)
    tape = MaskTape(20)
    b = 144 // dist.get_world_size()
    rows = slice(dist.get_rank() * b, (dist.get_rank() + 1) * b)
    timing_drop = dropout_from(torch.Generator("cuda").manual_seed(21))

    def conformer(model, b, m, compare):
        inner = getattr(model, "module", model)
        sync_batchnorm(inner, m and m.group("data"))
        opt = opt_of(inner, lambda: torch.optim.Adam(inner.parameters(), lr=2e-4,
                                                     betas=(0.5, 0.999), eps=1e-8))
        drop = (tape.record if m is None else tape.replay(rows)) if compare else timing_drop
        return conformer_step(model, opt, b[0], b[1], drop, m and m.group("data"))

    names = [k for k, _ in Conformer(22, 1000).named_parameters()]
    zero = [k for k in names if k.endswith(("keys.bias", "conv_0.bias", "conv_1.bias"))]
    out.append(mg_pair("conformer", lambda: Conformer(
        22, 1000, generator=torch.Generator().manual_seed(22)).to(dev), conformer, (x, y), mesh,
        zero_grad=zero))
    torch.cuda.empty_cache()
    return out


def mg_main_dino() -> dict:
    """`[mg main_dino]` on one rank: the CLI at its full-width defaults."""
    import torch.distributed as dist

    from cerebra_torch.cli.main_dino import main
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = main(MG_DINO + ["--log_dir", os.path.join(MG_DIR, "main_dino")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    steps = MG_DINO_EPOCHS * (MG_DINO_TRIALS // (4 * dist.get_world_size()))
    for name, per_step in (("vit_attn_fwd", 36), ("vit_mlp_fwd", 36),
                           ("vit_attn_bwd", 24), ("vit_mlp_bwd", 24)):
        if launches.get(name, 0) < per_step * steps:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times in "
                                 f"{steps} steps on this rank")
    if not all(math.isfinite(v) for v in hist["loss"]) or state.step != steps:
        raise AssertionError(f"main_dino: losses {hist['loss']}, {state.step} steps")
    out = {"losses": hist["loss"], "launches": launches, "center": digest({"c": state.center}),
           "seconds": seconds, "steps": steps,
           "ms_per_step": hist["epoch_time_s"][1] * 1e3 * MG_DINO_EPOCHS / steps}
    del state
    torch.cuda.empty_cache()
    return out


def mg_head() -> dict:
    """`[mg head]` on one rank: DINOHead(384 → 65536) f32, its last layer
    sharded over a (1, W) mesh's model axis, against the whole head, on 6
    crops of 4 samples: the loss, the input's and the replicated layers'
    gradients, the gathered last-layer gradient and center."""
    import torch.distributed as dist

    from cerebra_torch.losses.dino import dino_multicrop_loss
    from cerebra_torch.models.heads import DINOHead
    from cerebra_torch.parallel.dataflow import put_global
    from cerebra_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    world = dist.get_world_size()
    mesh = make_mesh(("data", "model"), (1, world))
    group = mesh.group("model")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    head = DINOHead(384, 65536, norm_last_layer=False,
                    generator=torch.Generator().manual_seed(24)).to(dev)
    sharded = copy.deepcopy(head)
    for p in sharded.last_layer.parameters():
        p.data = put_global(mesh, p.data, 0, "model").clone()
    sharded.model_group = group
    x = torch.randn(24, 384, generator=gen).to(dev)
    teacher = torch.randn(2, 4, 65536, generator=gen).to(dev)
    center = 0.1 * torch.randn(1, 65536, generator=gen).to(dev)

    def run(model, t, c, g):
        xi = x.clone().requires_grad_(True)
        loss, new_center = dino_multicrop_loss(model(xi).reshape(6, 4, -1), t, c, 0.04,
                                               model_group=g)
        model.zero_grad(set_to_none=True)
        loss.backward()
        return loss, new_center, xi.grad

    t_mine = put_global(mesh, teacher, 2, "model")
    c_mine = put_global(mesh, center, 1, "model")
    loss1, c1, gx1 = run(head, teacher, center, None)
    loss2, c2, gx2 = run(sharded, t_mine, c_mine, group)

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    errs = {"x": rel_frob(gx2, gx1), "center": rel_frob(gather(c2, 1), c1)}
    for (k, p1), p2 in zip(head.named_parameters(), sharded.parameters()):
        g2 = gather(p2.grad, 0) if k.startswith("last_layer") else p2.grad
        errs[k] = rel_frob(g2, p1.grad)
    ms = {}
    for what, args in (("whole", (head, teacher, center, None)),
                       ("sharded", (sharded, t_mine, c_mine, group))):
        run(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(*args)
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3 / 5
    loss1, loss2 = loss1.item(), loss2.item()
    return {"loss_rel": abs(loss2 - loss1) / abs(loss1), "loss": loss1, "errs": errs, "ms": ms,
            "shard": tuple(sharded.last_layer.weight_v.shape)}


def mg_tp_ddp() -> dict:
    """`[mg tp+ddp]` on one rank of W >= 4 cards: one DINO-LSTM step
    (lstm_distillation's Model(96, 128, 4) + DINOHead(128 -> 65536), f32,
    crops at fixed starts) over a (2, W/2) mesh, DDP over the data group
    and the prototypes sharded over the model group, against one process on
    the same 16 trials: the loss and every gradient after the per-parameter
    clip (the last layer's gathered), then 2 timed steps of each."""
    import dataclasses

    import torch.distributed as dist

    from cerebra_torch.models import lstm_stack as ls
    from cerebra_torch.parallel.mesh import make_mesh, shard_batch
    from cerebra_torch.parallel.tp import dino_tp_dim
    from cerebra_torch.train import recipes, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(("data", "model"), (2, dist.get_world_size() // 2))
    group = mesh.group("model")
    dev = torch.device("cuda")
    cfg = recipes.DinoSelfDistillConfig(out_dim=65536, epochs=3, warmup_epochs=0,
                                        freeze_last_layer=0)
    eeg = torch.randn(16, 512, 96, generator=torch.Generator().manual_seed(25)).to(dev)

    def views(_, b):  # 2 x 300 + 4 x 200 crops, at the same starts in every row
        return [torch.stack([b[:, s:s + 300] for s in (0, 212)]),
                torch.stack([b[:, s:s + 200] for s in (0, 104, 208, 312)])]

    one, one_step, _ = recipes.make_dino_lstm(
        dataclasses.replace(cfg, batch_size_per_device=16), 16, 96, dev, view_fn=views)
    mine, mine_step, _ = recipes.make_dino_lstm(
        dataclasses.replace(cfg, batch_size_per_device=8), 16, 96, dev, view_fn=views, mesh=mesh)
    steps.distribute_dino_state(mesh, mine, cfg.out_dim)
    rows = shard_batch(mesh, eeg)
    one, m_one = one_step(one, eeg)
    ls.reset_launches()
    mine, m_mine = mine_step(mine, rows)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ls.LAUNCHES.items() if v}
    if not all(launches.get(k) for k in ("fwd_train", "bwd", "fwd_infer_last")):
        raise AssertionError(f"the TP + DDP step bypassed K1/K2/K3: {launches}")

    def grads(state, sharded):
        out = {}
        for k, p in state.student.named_parameters():
            if p.grad is None:  # the fixed weight norm of norm_last_layer
                continue
            g = p.grad.detach()
            if sharded and dino_tp_dim(k, g, 1) is not None:
                parts = [torch.empty_like(g) for _ in range(mesh.size("model"))]
                dist.all_gather(parts, g.contiguous(), group=group)
                g = torch.cat(parts, dino_tp_dim(k, g, 1))
            out[k] = g
        return out

    g_one, g_mine = grads(one, False), grads(mine, True)
    errs = {k: rel_frob(g_mine[k], g) for k, g in g_one.items()}
    ms = {}
    for what, state, step, b in (("one", one, one_step, eeg), ("world", mine, mine_step, rows)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, b)
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3 / 2
    loss_one, loss_world = float(m_one["loss"]), float(m_mine["loss"])
    out = {"mesh": list(mesh.ranks.shape), "loss_one": loss_one, "loss_world": loss_world,
           "loss_rel": abs(loss_world - loss_one) / abs(loss_one),
           "grad_rel_max": max(errs.values()), "worst": max(errs, key=errs.get),
           "shard": list(mine.student.head.last_layer.weight_v.shape), "launches": launches,
           "ms": ms}
    del one, mine
    torch.cuda.empty_cache()
    return out


def mg_rank(rank: int, port: int, world: int, backend: str) -> None:
    """One rank of phase 18's world (the spawned process's entry)."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from cerebra_torch.cli.common import init_distributed

    device = init_distributed(torch.device("cuda"), backend=backend)
    try:
        out = {"device": str(device), "backend": dist.get_backend()}
        parts = [("trainer", mg_trainer), ("steps", mg_steps), ("main_dino", mg_main_dino),
                 ("head", mg_head)]
        if world >= 4 and world % 2 == 0:  # a (2, W/2) mesh: DDP and TP together
            parts.append(("tp_ddp", mg_tp_ddp))
        for name, part in parts:
            t0 = time.perf_counter()
            out[name] = part()
            out[name + "_s"] = time.perf_counter() - t0
        with open(os.path.join(MG_DIR, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_multi_gpu(gpu: str) -> None:
    """Phase 18: `[nccl]`, then the two-rank world's `[mg trainer]`, `[mg
    steps]`, `[mg main_dino]` and `[mg head]`; a rank's failure fails it."""
    import shutil

    import torch.multiprocessing as mp

    from cerebra_torch.cli.launch import _free_port

    shutil.rmtree(MG_DIR, ignore_errors=True)
    os.makedirs(MG_DIR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    argv = MG_TRAINER + ["--num_epochs", "1", "--log_dir", os.path.join(MG_DIR, "nccl")]
    res = subprocess.run(
        [sys.executable, "-m", "cerebra_torch.cli.launch", "--nproc", "1", "--", sys.executable,
         "-c", NCCL_CHECK, *argv],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"launch --nproc 1 (NCCL) exited {res.returncode}: "
                             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    line = [ln for ln in res.stdout.splitlines() if '{"backend"' in ln][-1]
    nccl = json.loads(line.split("] ", 1)[1])
    if (nccl["backend"] != "nccl" or nccl["world"] != 1 or nccl["all_reduce"] != [1, 2, 3, 4]
            or nccl["all_gather"] != [1, 2, 3, 4]
            or not all(math.isfinite(v) for v in nccl["losses"])):
        raise AssertionError(f"NCCL world of one: {nccl}")
    log(f"[nccl] launch --nproc 1: init_distributed's {nccl['backend']} group (world "
        f"{nccl['world']}, {nccl['device']}), all_reduce {nccl['all_reduce']}, all_gather "
        f"{nccl['all_gather']}, barrier; lstm_distill_from_dinov2_train 1 epoch in "
        f"{nccl['seconds']:.1f} s, loss {nccl['losses'][0]:.6f}; {time.perf_counter() - t0:.1f} s "
        f"with the process's start, on {gpu}")

    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    t0 = time.perf_counter()
    mp.start_processes(mg_rank, args=(_free_port(), world, backend), nprocs=world,
                       start_method="spawn", join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(MG_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"[mg] {world} ranks ({backend}, on {sorted({rk['device'] for rk in ranks})}) in "
        f"{time.perf_counter() - t0:.1f} s with their start"
        + ("; two ranks sharing one card: no scaling figure, and NCCL across cards is not "
           "checked on this machine" if cards == 1 else ""))

    tr = [rk["trainer"] for rk in ranks]
    if any(t["losses"] != tr[0]["losses"] or t["digest"] != tr[0]["digest"] for t in tr):
        raise AssertionError(f"the ranks' loss streams or weights differ: "
                             f"{[t['losses'] for t in tr]} {[t['digest'][:12] for t in tr]}")
    for r, t in enumerate(tr):
        log(f"[mg trainer] rank {r}: {t['seconds']:.1f} s with the corpus and validation, "
            f"{t['ms_per_step']:.2f} ms/step over epochs 1-{MG_EPOCHS - 1} "
            f"({MG_EPOCHS * MG_STEPS_PER_EPOCH} steps of {16 // world} rows), windows/s per epoch "
            f"{[round(w, 1) for w in t['windows_per_s']]}, launches {t['launches']} on {gpu}")
    log(f"[mg trainer] one loss stream {[round(v, 6) for v in tr[0]['losses']]}; weights "
        f"bit-identical (sha256 {tr[0]['digest'][:16]}); f32 gradients under DDP")

    for i in range(len(ranks[0]["steps"])):
        for r, pr in enumerate(rk["steps"][i] for rk in ranks):
            ok = pr["loss_rel"] <= MG_TOL and pr["grad_rel_max"] <= pr["grad_tol"]
            rule = f"limit {pr['grad_tol']:g}" + (
                "" if pr["grad_tol"] == MG_TOL else
                ": f32 rounding on either side; held at 1e-5 in f64 below")
            ms = (f"ms/step: {world} ranks {pr['ms']['world']:.2f}, one process "
                  f"{pr['ms']['one']:.2f}" if pr["ms"] else "not timed")
            log(f"[mg steps] {pr['name']} rank {r}: loss {pr['loss_world']:.7f} vs "
                f"{pr['loss_one']:.7f} (rel {pr['loss_rel']:.2e}, limit 1e-5); gradients rel "
                f"Frobenius max {pr['grad_rel_max']:.2e} ({pr['worst']}; {rule}); "
                f"{len(pr['zero_grad'])} zero-gradient tensors aside; {ms} (TF32 off) on {gpu}")
            if not ok:
                raise AssertionError(f"{pr['name']}: {world} ranks disagree with one process")

    md = [rk["main_dino"] for rk in ranks]
    if any(m["losses"] != md[0]["losses"] or m["center"] != md[0]["center"] for m in md):
        raise AssertionError(f"main_dino ranks differ: {md}")
    for r, m in enumerate(md):
        log(f"[mg main_dino] rank {r}: {m['seconds']:.1f} s, {m['steps']} steps, "
            f"{m['ms_per_step']:.1f} ms/step (ViT-S/8, out_dim 65536, 2 x 224 + 4 x 96, 4 a "
            f"rank, bf16), launches {m['launches']} on {gpu}")
    log(f"[mg main_dino] losses {[round(v, 4) for v in md[0]['losses']]} on every rank; one "
        f"center (sha256 {md[0]['center'][:16]})")

    for r, rk in enumerate(ranks):
        hd = rk["head"]
        worst = max(hd["errs"].values())
        log(f"[mg head] rank {r}: DINOHead 384 -> 65536 f32, last layer {hd['shard']} a rank "
            f"(1 x {world} mesh) against the whole head: loss {hd['loss']:.6f} rel {hd['loss_rel']:.2e}, "
            f"gradients and center rel Frobenius max {worst:.2e} (limit 1e-5; "
            f"{ {k: float(f'{v:.1e}') for k, v in hd['errs'].items()} }); fwd+bwd ms: sharded "
            f"{hd['ms']['sharded']:.2f}, whole {hd['ms']['whole']:.2f} on {gpu}")
        if hd["loss_rel"] > MG_TOL or worst > MG_TOL:
            raise AssertionError(f"the sharded head disagrees on rank {r}: {hd}")
    for r, rk in enumerate(ranks if "tp_ddp" in ranks[0] else ()):
        tp = rk["tp_ddp"]
        log(f"[mg tp+ddp] rank {r}: one DINO-LSTM step (Model(96, 128, 4) + DINOHead(128 -> "
            f"65536), f32, 16 trials) over a {tuple(tp['mesh'])} (data, model) mesh, DDP over "
            f"data, last layer {tp['shard']} a rank, against one process: loss "
            f"{tp['loss_world']:.7f} vs {tp['loss_one']:.7f} (rel {tp['loss_rel']:.2e}, limit "
            f"1e-5); gradients rel Frobenius max {tp['grad_rel_max']:.2e} ({tp['worst']}; limit "
            f"1e-5); launches {tp['launches']}; ms/step: {world} ranks {tp['ms']['world']:.2f}, "
            f"one process {tp['ms']['one']:.2f} (TF32 off) on {gpu}")
        if tp["loss_rel"] > MG_TOL or tp["grad_rel_max"] > MG_TOL:
            raise AssertionError(f"TP + DDP disagrees with one process on rank {r}: {tp}")
    log(f"[mg] parts (rank 0): " + ", ".join(f"{k} {ranks[0][k + '_s']:.1f} s"
                                            for k in ("trainer", "steps", "main_dino", "head",
                                                      "tp_ddp") if k in ranks[0]))


# ------------------------------------------------------------------ phase 19
# The last modules of the port: the exact IIR cascade (csrc/sos_scan.cu, no
# Pallas counterpart: JAX ran it as a lax.scan), BDF ingest, the denoisers,
# the corpus transforms and the t-SNE CLI. Files under REMAINDER_DIR.
REMAINDER_DIR = os.path.join(ROOT, "build", "chip_smoke", "remainder")
SOS_SOURCE = "cerebra_torch/csrc/sos_scan.cu"
REPLACES["sos_scan"] = "cerebra/signal/filters.py:101 _sos_scan (lax.scan)"
# The kernel and its plain loop run the same per-section updates; nvcc
# contracts them into FMAs, and the 1 Hz poles of the 1-50 Hz Butterworth
# carry a rounding difference on: on the CPU each f32 side lies 1.7-1.9e-4
# of the peak from f64, and the card's first runs showed 9-10e-5 between
# kernel and plain. Relative to the output's peak: 5e-4 in f32, 1e-9 in f64
# against scipy (the same recurrence in the same dtype).
TOL_SOS = {torch.float32: 5e-4, torch.float64: 1e-9}
# remove_noise's lanes: Perils-sized trials (96 channels, 512 samples) in
# batches of 64, Butterworth(4) 1-50 Hz at 1000 Hz
SOS_SHAPE = (64, 96, 512)
# the ingest recording: 128 EEG + 8 EXG channels (+ Status) at 4096 Hz,
# a session-start trigger and 200 stimulus events 0.35 s apart
INGEST_FS, INGEST_EVENTS, INGEST_GAP = 4096, 200, 0.35


def remainder_dir(name: str) -> str:
    import shutil

    path = os.path.join(REMAINDER_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def rel_peak(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def sos_plain_filtfilt(spec, x: torch.Tensor) -> torch.Tensor:
    """filtfilt composed from the plain loop (`_sos_scan_ref`), on x's device."""
    from cerebra_torch.signal import filters as flt

    p = spec.default_padlen
    ext = flt._odd_ext(x, p)
    y = flt._sos_scan_ref(spec.sos, ext, spec.zi, ext[..., 0])
    y = flt._sos_scan_ref(spec.sos, y, spec.zi, y[..., -1], reverse=True)
    return y[..., p:p + x.shape[-1]]


def sos_chain_ms(T: int, S: int, f64: bool = False) -> float:
    """The serial bound of one pass: a lane's T·S section updates, each two
    dependent FMAs (y, then z0 from y) of 4 cycles (8 in f64), at the card's
    highest SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return T * S * 2 * (8 if f64 else 4) / (mhz * 1e3)


def sos_scan_phase(gpu: str) -> tuple:
    """`[sos scan]` → (errors, timing row) of sos_scan."""
    from scipy import signal as sps

    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.signal import filters as flt

    spec = flt.design_bandpass(1.0, 50.0, fs=1000.0, order=4)
    S, pad = spec.n_sections, spec.default_padlen
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(*SOS_SHAPE, generator=gen, device="cuda")
    ext = flt._odd_ext(x, pad)  # (64, 96, 566): one pass's lanes
    worst = 0.0  # the largest absolute difference, for the kernels line
    for lanes in (ext, torch.randn(96, 4096, generator=gen, device="cuda")):
        for reverse in (False, True):
            scale = lanes[..., -1 if reverse else 0]
            got = flt.sos_scan(spec.sos, lanes, spec.zi, scale, reverse=reverse)
            want = flt._sos_scan_ref(spec.sos, lanes, spec.zi, scale, reverse=reverse)
            err = rel_peak(got, want)
            log(f"[sos scan] {tuple(lanes.shape)} f32 reverse={reverse}: kernel vs plain "
                f"{err:.2e} of the peak (limit {TOL_SOS[torch.float32]:.0e})")
            if not err <= TOL_SOS[torch.float32]:
                raise AssertionError(f"sos_scan {tuple(lanes.shape)} reverse={reverse}: {err}")
            worst = max(worst, float((got - want).abs().max()))
    got, want = flt.filtfilt(spec, x), sos_plain_filtfilt(spec, x)
    err = rel_peak(got, want)
    log(f"[sos scan] filtfilt {SOS_SHAPE} f32: kernel vs plain {err:.2e} of the peak")
    if not err <= TOL_SOS[torch.float32]:
        raise AssertionError(f"filtfilt kernel vs plain: {err}")
    worst = max(worst, float((got - want).abs().max()))
    log(f"[sos scan] largest absolute difference from the plain loop (f32): {worst:.3e}")
    reset_launches()
    flt.filtfilt(spec, x)
    per_filtfilt = LAUNCHES["sos_scan"]
    log(f"[sos scan] launches per filtfilt: {per_filtfilt}")
    if per_filtfilt != 2:
        raise AssertionError(f"filtfilt launched sos_scan {per_filtfilt} times")

    # f64 over a long recording: the ingest's 137 channels at 2048 Hz
    long = torch.randn(137, 152_000, generator=gen, device="cuda", dtype=torch.float64)
    got = flt.filtfilt(spec, long)
    host = long.cpu().numpy()
    t0 = time.perf_counter()
    want = sps.sosfiltfilt(spec.sos, host, axis=-1)
    scipy_s = time.perf_counter() - t0
    err64 = rel_peak(got, torch.from_numpy(want.copy()).cuda())
    long_ms = time_ms(lambda: flt.filtfilt(spec, long), 3)
    log(f"[sos scan] filtfilt (137, 152000) f64: kernel vs scipy sosfiltfilt {err64:.2e} of "
        f"the peak (limit {TOL_SOS[torch.float64]:.0e}); card {long_ms:.3f} ms (2 passes, "
        f"chain bound {2 * sos_chain_ms(152_000 + 2 * pad, S, True):.3f} ms), scipy on the host "
        f"{scipy_s * 1e3:.1f} ms; {gpu}")
    if not err64 <= TOL_SOS[torch.float64]:
        raise AssertionError(f"sos_scan f64 against scipy: {err64}")

    # one forward pass over remove_noise's lanes: the kernels-line row
    lanes, T = ext.numel() // ext.shape[-1], ext.shape[-1]
    row = timing_row(lambda: flt.sos_scan(spec.sos, ext, spec.zi, ext[..., 0]),
                     lambda: flt._sos_scan_ref(spec.sos, ext, spec.zi, ext[..., 0]),
                     (ext, ext[..., 0].contiguous()), 9 * S * lanes * T, torch.float32,
                     reps=20, plain_reps=1)
    big = torch.randn(96, 4096, generator=gen, device="cuda")
    big_ms = time_ms(lambda: flt.sos_scan(spec.sos, big), 10)
    log(f"[sos scan] one pass {tuple(ext.shape)} f32 (S = {S}): {fmt_row(row)}; serial chain "
        f"{sos_chain_ms(T, S):.4f} ms; (96, 4096): {big_ms:.3f} ms, chain "
        f"{sos_chain_ms(4096, S):.4f} ms; library none on the card (scipy: host); {gpu}")
    return {"sos_scan": worst}, {"sos_scan": row}, per_filtfilt


def ingest_phase(gpu: str) -> None:
    """`[ingest]`: convert_to_pth on the card over a full-width recording."""
    from cerebra_torch.cli import convert_to_pth
    from cerebra_torch.data import bdf, ingest, native_bdf
    from cerebra_torch.data.schema import load_corpus_pth

    out = remainder_dir("ingest")
    fs, n = INGEST_FS, INGEST_EVENTS
    T = int((2.0 + (n + 1) * INGEST_GAP + 2.0) * fs)
    names = [f"A{i + 1}" for i in range(128)] + [f"EXG{i + 1}" for i in range(8)]
    rng = np.random.default_rng(19)
    t0 = time.perf_counter()
    sig = rng.standard_normal((len(names), T), dtype=np.float32) * 20.0
    sig += (10.0 * np.sin(2 * np.pi * 10.0 * np.arange(T) / fs)).astype(np.float32)
    status = np.zeros(T, np.int64)
    for k in range(n + 1):  # the session-start trigger, then the stimuli
        s0 = int((2.0 + k * INGEST_GAP) * fs)
        status[s0:s0 + 40] = ingest.STATUS_EVENT
    path = os.path.join(out, "spampinato-2-2.bdf")
    bdf.write_raw_bdf(path, sig, names, fs, status=status)
    del sig
    mb = os.path.getsize(path) / 1e6
    log(f"[ingest] wrote {mb:.1f} MB of BDF ({len(names) + 1} channels x {T} samples at {fs} Hz) "
        f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    py = bdf.read_raw_bdf(path)
    t_py = time.perf_counter() - t0
    if not native_bdf.available():
        raise AssertionError("the native BDF reader does not build")
    t0 = time.perf_counter()
    nat = native_bdf.read_raw_bdf(path)
    t_nat = time.perf_counter() - t0
    same = (nat.channel_names == py.channel_names and nat.sample_rate == py.sample_rate
            and np.array_equal(nat.signals, py.signals) and np.array_equal(nat.status, py.status))
    log(f"[ingest] readers bit-equal: {same}; numpy {t_py:.2f} s, native {t_nat:.2f} s")
    if not same:
        raise AssertionError("the native and numpy BDF readers disagree")
    del py, nat

    payloads = {}
    for exact in (False, True):
        stages = {}
        t0 = time.perf_counter()
        if exact:  # the exact filtfilt (sos_scan) through the library call
            raw = ingest.convert_bdf_to_pth(
                path, os.path.join(out, "exact", "spampinato-2-exact.pth"), subject=2,
                expected_samples=n, use_device_filters=False, device="cuda",
                stage_seconds=stages)
            pth = os.path.join(out, "exact", "spampinato-2-exact.pth")
        else:
            raw = convert_to_pth.main(["--bdf_file", path, "--out_dir", out, "--device", "cuda",
                                       "--number_of_image_samples", str(n)],
                                      stage_seconds=stages)
            pth = os.path.join(out, "spampinato-2-IMAGE_RAPID_14Hz_71Hz.pth")
        seconds = time.perf_counter() - t0
        back = load_corpus_pth(pth)
        ok = (back.eeg.shape == (n, 128, 512) and np.isfinite(back.eeg).all()
              and np.array_equal(back.eeg, raw.eeg) and back.means.shape == (128,))
        labels = ingest.load_stimulus_labels(ingest.IMAGE_RAPID_SEQUENCE)[1][:n]
        ok = ok and list(back.labels) == labels
        what = "filtfilt (sos_scan)" if exact else "convert_to_pth.main, filtfilt_fft"
        log(f"[ingest] {what}: {back.eeg.shape} loaded back: {ok}; {seconds:.2f} s "
            f"({', '.join(f'{k} {v:.2f}' for k, v in stages.items())}); {gpu}")
        if not ok:
            raise AssertionError(f"ingest ({what}) wrote a wrong .pth")
        payloads[exact] = back.eeg
    # every epoch starts >= 2 s into the recording: the FFT form's edge
    # error has decayed there (1.2e-6 of the peak 0.5 s in, f64, CPU)
    err = float(np.abs(payloads[False] - payloads[True]).max() / np.abs(payloads[True]).max())
    log(f"[ingest] filtfilt_fft against the exact filtfilt over the epochs: {err:.2e} of the "
        f"peak (limit 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"filtfilt_fft against filtfilt: {err}")


def peak_call(fn):
    """(result, seconds, peak MiB above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**20


def denoise_phase(gpu: str) -> None:
    """`[denoise]` over a Perils-sized corpus (2000, 512, 96) f32."""
    from scipy import signal as sps

    from cerebra_torch.signal import denoise, psd
    from cerebra_torch.signal.filters import design_bandpass

    gen = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(2000, 512, 96, generator=gen, device="cuda")
    y, _, _ = peak_call(lambda: denoise.remove_noise(x, 1000.0))
    y, s, mib = peak_call(lambda: denoise.remove_noise(x, 1000.0))
    spec = design_bandpass(1.0, 50.0, fs=1000.0, order=4)
    want = sos_plain_filtfilt(spec, x[:2].transpose(1, 2)).transpose(1, 2)
    err = rel_peak(y[:2], want)
    log(f"[denoise] remove_noise (2000, 512, 96) f32: {s * 1e3:.2f} ms, peak {mib:.0f} MiB "
        f"above the input; two trials against the plain loop {err:.2e} of the peak; {gpu}")
    if not (err <= TOL_SOS[torch.float32] and torch.isfinite(y).all()):
        raise AssertionError(f"remove_noise: {err}")
    del y
    z, s, mib = peak_call(lambda: denoise.remove_noise_with_ica(x, 20))
    # three trials against the host's f64 projection: the card in f64 to
    # 1e-10 (the same function); the f32 corpus run within the f32 rounding
    # of a rank-20 subspace, 64·2⁻²⁴·σ₁/(σ₂₀ − σ₂₁) of the peak (Davis–Kahan:
    # a perturbation ε·σ₁ turns the subspace by ε·σ₁/gap)
    xs = x[:3].double().cpu().numpy()
    mean = xs.mean(axis=1, keepdims=True)
    sv, vh = np.linalg.svd(xs - mean, full_matrices=False)[1:]
    vh = vh[:, :20]
    want = (xs - mean) @ np.transpose(vh, (0, 2, 1)) @ vh + mean
    peak = np.abs(want).max()
    err64 = float(np.abs(denoise.remove_noise_with_ica(x[:3].double(), 20).cpu().numpy()
                         - want).max() / peak)
    err = float(np.abs(z[:3].double().cpu().numpy() - want).max() / peak)
    tol = float(64 * 2.0**-24 * (sv[:, 0] / (sv[:, 19] - sv[:, 20])).max())
    log(f"[denoise] remove_noise_with_ica n=20 (batched SVD): {s * 1e3:.1f} ms, peak {mib:.0f} "
        f"MiB; three trials against the host's f64 projection: f32 {err:.2e} of the peak "
        f"(limit {tol:.2e}), f64 on the card {err64:.2e} (limit 1e-10); {gpu}")
    if not (err <= tol and err64 <= 1e-10 and torch.isfinite(z).all()):
        raise AssertionError(f"remove_noise_with_ica: f32 {err} (limit {tol}), f64 {err64}")
    del z
    xt = x.transpose(1, 2)  # (2000, 96, 512): channels' time series
    psd.band_powers(xt, 1000.0)  # cuFFT's plan for the shape, made once
    bp, s, mib = peak_call(lambda: psd.band_powers(xt, 1000.0))
    f, want = sps.welch(xt[:2].double().cpu().numpy(), fs=1000.0, nperseg=256)
    _, got = psd.welch_psd(xt[:2], 1000.0)
    err = float(np.abs(got.double().cpu().numpy() - want).max() / np.abs(want).max())
    log(f"[denoise] band_powers (2000, 96, 512): {s * 1e3:.2f} ms, peak {mib:.0f} MiB; Welch of "
        f"two trials against scipy {err:.2e} of the peak (limit 1e-4); bands "
        f"{sorted(bp)}; {gpu}")
    if not (err <= 1e-4 and all(torch.isfinite(v).all() for v in bp.values())):
        raise AssertionError(f"band_powers / welch_psd: {err}")


def transforms_phase(gpu: str) -> dict:
    """`[transforms]` on the synthetic 40 x 30 corpus → launches."""
    from cerebra_torch.data import make_synthetic_corpus, transforms
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import Model, RecurrentAutoencoder
    from cerebra_torch.models.dino_model import DinoArgs, DinoModel

    corpus = make_synthetic_corpus(seed=19, n_per_class=30, n_classes=N_CLASSES,
                                   n_channels=C, n_samples=T_RAW)
    gen = torch.Generator().manual_seed(19)
    n_batches = -(-corpus.n // 256)
    f32 = torch.float32
    sub = corpus.take(np.arange(32))
    ran = {}
    for name, model, call, kern, per_batch in (
            ("lstm_features", Model(C, H, L, F, generator=gen),
             lambda c, m: transforms.lstm_features(c, m, features_only=True), "fwd_infer_last", 1),
            ("autoencoder_reconstruct", RecurrentAutoencoder(T_RAW, C, E_AE, generator=gen),
             lambda c, m: transforms.autoencoder_reconstruct(c, m).eeg, "fwd_infer", 2)):
        model.eval()
        reset_launches()
        t0 = time.perf_counter()
        got = call(corpus, model.to("cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran[name] = {k: v for k, v in LAUNCHES.items() if v}
        want = call(sub, model.to("cpu"))
        compare(f"[transforms] {name} (first 32 of {corpus.n}) CUDA against the CPU's plain path",
                torch.from_numpy(got[:32]), torch.from_numpy(want), f32, True,
                (TOL_F32_ABS, 1e-5, TOL_BF16_REL))
        log(f"[transforms] {name}: {corpus.n} trials in {seconds:.2f} s, launches {ran[name]}")
        if ran[name].get(kern) != per_batch * n_batches:
            raise AssertionError(f"{name} launched {ran[name]}, not {kern} x {per_batch} a batch")
    dino = DinoModel(DinoArgs(), seed=19, device="cuda")
    starts = np.arange(corpus.n) % 8
    reset_launches()
    t0 = time.perf_counter()
    got = transforms.dino_features(corpus, dino, starts=starts, batch_size=64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ran["dino_features"] = {k: v for k, v in LAUNCHES.items() if v}
    n_dino = -(-corpus.n // 64)
    want = transforms.dino_features(corpus.take(np.arange(2)), DinoModel(DinoArgs(), seed=19),
                                    starts=starts[:2])
    compare("[transforms] dino_features (ViT-S/8, 224 px; first 2) CUDA (K5/K7) against the "
            "CPU's unfused path", torch.from_numpy(got[:2]), torch.from_numpy(want), f32, True,
            (TOL_VIT[0], TOL_VIT[0], TOL_VIT[2]))
    log(f"[transforms] dino_features: {corpus.n} trials in {seconds:.2f} s "
        f"({corpus.n / seconds:.1f} trials/s), launches {ran['dino_features']}; {gpu}")
    if ran["dino_features"] != {"vit_attn_fwd": 12 * n_dino, "vit_mlp_fwd": 12 * n_dino}:
        raise AssertionError(f"dino_features launched {ran['dino_features']}")
    return ran


def tsne_phase(gpu: str) -> None:
    """`[tsne]`: the t-SNE CLI on the card."""
    import io

    from cerebra_torch.cli import get_tsne_for_raw_eeg

    out = remainder_dir("tsne")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        pngs = get_tsne_for_raw_eeg.main(["--synthetic", "--synthetic_classes", "40",
                                          "--synthetic_per_class", "30", "--device", "cuda",
                                          "--log_dir", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    said = [line for line in buf.getvalue().splitlines() if "KL divergence" in line]
    size = os.path.getsize(pngs[0]) if pngs and os.path.exists(pngs[0]) else 0
    log(f"[tsne] {said[0] if said else 'no KL line'}; {os.path.basename(pngs[0]) if pngs else '-'}"
        f" {size} bytes; {seconds:.2f} s; {gpu}")
    if not (size > 1000 and said and pngs[0].endswith("SUB_1_RAW_EEG_features_distribution.png")):
        raise AssertionError(f"get_tsne_for_raw_eeg wrote {pngs}")


def phase_remainder(gpu: str) -> tuple:
    """Phase 19 → (errors, timing rows, launches) of sos_scan."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, rows, per_filtfilt = sos_scan_phase(gpu)
    ingest_phase(gpu)
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    # the main path's launches: remove_noise over the Perils corpus (two
    # launches a filtfilt), read right after
    reset_launches()
    denoise_phase(gpu)
    launches = {"sos_scan": LAUNCHES["sos_scan"]}
    log(f"[remainder] sos_scan launches in [denoise]: {launches['sos_scan']} "
        f"({per_filtfilt} a filtfilt)")
    if launches["sos_scan"] < per_filtfilt:
        raise AssertionError(f"the denoise path launched sos_scan {launches['sos_scan']} times")
    transforms_phase(gpu)
    tsne_phase(gpu)
    return errs, rows, launches


def main(argv) -> None:
    multi_gpu_only = argv == ["--multi-gpu-only"]
    if argv and not multi_gpu_only:
        sys.exit("usage: python3 chip_smoke.py [--multi-gpu-only]")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import cerebra_torch  # noqa: F401  (fails before any output outside a checkout)

    start = time.perf_counter()

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[phases] {phase.__name__} {time.perf_counter() - t0:.1f} s")
        return out

    gpu = run(phase_device)
    run(phase_build)
    if multi_gpu_only:
        run(phase_main)
        run(phase_main_dino)
        run(phase_multi_gpu, gpu)
        log(f"[phases] all {time.perf_counter() - start:.1f} s")
        log(gpu)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    errs = run(phase_parity)
    launches = run(phase_main)
    times = run(phase_kernel_timing)
    run(phase_step_timing, gpu)
    errs.update(run(phase_vit_parity))
    launches.update({k: v for k, v in run(phase_main_dino).items() if k in VIT_SOURCES})
    times.update(run(phase_vit_timing, gpu))
    run(phase_dino_step_timing, gpu)
    errs.update(run(phase_ae_parity))
    ae_launches, ae_times = run(phase_ae_train, gpu)
    launches.update({k: ae_launches[k] for k in ("fwd_infer", "bwd_general", "fwd_in_product",
                                                  "fwd_cluster_scan")})
    times.update(ae_times)
    e, t = run(phase_fwd_paths, gpu)
    errs.update(e)
    times.update(t)
    for phase in (phase_rc, phase_scan, phase_lstm_family, phase_analysis, phase_teacher):
        e, t, n = run(phase, gpu)
        errs.update(e)
        times.update(t)
        launches.update({k: n[k] for k in t})
    run(phase_trainers, gpu)
    run(phase_multi_gpu, gpu)
    e, t, n = run(phase_remainder, gpu)
    errs.update(e)
    times.update(t)
    launches.update(n)
    log(f"[phases] all {time.perf_counter() - start:.1f} s")
    sources = dict(VIT_SOURCES, **FLASH_SOURCES, **TEACHER_SOURCES,
                   **dict.fromkeys(SCAN_KERNELS, SCAN_SOURCE), sos_scan=SOS_SOURCE)
    kernels = [
        {"name": name, "route": "cuda", "source": sources.get(name, SOURCE),
         "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": errs[name],
         **times[name]}
        for name in ("fwd_train", "bwd", "stack_bwd_scan", "stack_bwd_products",
                     "fwd_infer_last", "fwd_wave", *VIT_SOURCES, "fwd_infer", "fwd_in_product",
                     "fwd_cluster_scan", "bwd_general", "fwd_train_rc", "fwd_infer_wave",
                     "fwd_train_rc_split", "fwd_infer_split",
                     "bwd_rc", *RC_PIECES, *SCAN_KERNELS, *FAMILY_KERNELS, *FLASH_SOURCES,
                     *TEACHER_KERNELS, "sos_scan")
    ]
    log(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
