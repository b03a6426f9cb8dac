#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from the checkout's sources, then:

  [kernels]  each CUDA kernel against its plain PyTorch version at the
             shapes of every main path: the serving forward's products,
             attention and LayerNorms (MCAN-small, B=64); the train step's
             dropout epilogues, backward products, attention and LayerNorm
             backwards and column sums at the decoder's and the fused SA
             encoder's shapes (MCAN-small, B=64; the column sums also at
             ragged rows, twice alike, their counters left at 0); and at
             MCAN-large's
             (micro-batch 32, D=1024, 128-wide heads, bf16 saves); with
             each one's device time, its plain version's, one PyTorch
             library call's where there is one, and its bound at the
             card's published peaks; the Hopper products (gemm_sm90.cu:
             gemm_bias_act, gemm_dx, gemm_dw) timed at both models with
             their plan per shape (tile, splits, grid) and each instance's
             registers, spills and shared memory, dW bit for bit over two
             runs; the attention forward (masked_attention.cu, mma.sync)
             with its plan per shape (instance, rows per block, grid,
             shared memory) and each instance's registers and spills;
  [kernels]  (int8) quantize_rows and gemm_s8 (gemm_sm90.cu's S8
             instance, K-major int8 weights) at every int8 site of one B=64
             forward (MCAN-small at levels 1 and 3, MCAN-large at level 1),
             at ragged M, one row, the answer head (N 3129) and the AttFlat
             logit (N 1), bit for bit against their plain versions, with
             the int8 library call (torch._int_mm) and the int8 bound; the
             f32-output attention of the level-3 merges;
  [int4 kernels]  gemm_s4 bit for bit and gemm_w4bf16 against their plain
             versions (gemm_int4.cu's S4 / W4 instances, K-major packed
             weights) at every level-5 site of MCAN-small and MCAN-large
             (M = 14, 60, 896, 3840) with each site's plan (tile, splits,
             grid) and each instance's registers, spills and shared
             memory; times at B = 1 and 64 beside gemm_s8 on the int8
             weight and gemm_bias_act on the dequantized weight;
  [blocks]   both bf16 serving blocks and both int8 serving blocks (levels 1
             and 3; MCAN-large level 1) against their plain versions;
  [int4 blocks] / [int8 blocks]  the qffn blocks at levels 4-7 and the
             full-int8 blocks against their plain versions (B=64, fully
             padded samples; MCAN-large level 5 and full int8 once);
  [train block]  the SGA train block (forward, FFN backward, attention
             backward), the SA train block (forward, backward; save_acts
             both ways) and MCAN-large's SGA train block with att_saves and
             bf16_saves, each against the same block in plain ops
             differentiated by autograd, at full width with fully padded
             samples; the times of each piece with external masks and
             seeded (in-kernel dropout): ``check_train_block`` of
             ``cli/validate_inkernel_dw.py``, which also runs alone;
  [prng]     (``check_prng`` of ``cli/validate_prng_dropout.py``, which
             also runs alone) in-kernel dropout: the CUDA Philox4x32-10 against its plain
             version on 2 M words and the mask dump against its plain
             version, bit for bit (the SGA block at MCAN-small and
             MCAN-large shapes, the SA block, and the plan's edges: rows
             with n % 4 != 0, one and six sites, B = 1 and 65,537), twice
             with equal bits, the keep rate within 5 sigma, each dump's
             and the words' time, plan and registers beside torch.rand +
             the compare and the bound of their integer work; the
             seeded SGA and SA blocks against the external-mask blocks fed
             the dump, bit for bit in the output and every gradient, and
             against their plain twins;
  [serve]    main path 1: MCAN-small (hidden 512, 6+6 layers, 8 heads, 3129
             answers, random weights from a seed) served by ``Predictor()``
             with its defaults: int8 level 1, online calibration after 256
             real rows, level 3 after the swap, every block through the
             int8 block kernels on both sides; checked against the "plain"
             engine; the explicit act_calibration / act_scales paths; the
             all-bf16 engine (qffn=0);
  [serve int4] / [serve q8aux] / [serve int8]  main paths 1b-1d on the same
             requests: Predictor(engine="int4") at level 1, calibrate_now(),
             level 5; levels 4, 6, 7 through build_production_engine;
             Predictor(q8aux=True) before and after its swap (level 3 + the
             static-int8 aux sites); Predictor(engine="int8"); launch counts
             and agreement with the plain engine for each;
  [forward]  forward times of every engine per bucket, in turns;
  [artifact] serving artifacts: the default Predictor at level 1 and the
             online-calibrated one of [serve] exported at buckets 1, 8, 64,
             the int4, full-int8, plain and q8aux engines and the
             hidden-1536 (mode-0) Predictor at bucket 8 and 2 layers
             (Predictor.export_artifact: torch.export, the serving kernels
             as torch.ops.mcan.* custom ops), then loaded in one fresh
             process that imports no model code (``--artifact-load``):
             every program against its live Predictor bit for bit on the
             same padded inputs, with the live kernel launches a forward;
             export and load seconds, forward ms beside the live engine's,
             and the default engines' programs in turns with their op
             nodes calling the ops' implementations directly;
  [http]     cli/serve.py's make_server over the calibrated Predictor and
             over its artifact: 16 concurrent clients, ~256 requests (b64
             and lists, single and batched, top_k 1 and 5, malformed ones
             with their status codes), each answer against a direct
             Predictor.answer (a flip only inside a near-tie); a full queue
             (503) and a body over the cap (413); predict_probs_async at
             B=64 returning before its forward ends; one
             cli/bench_serve_http.py line per wire format and side;
  [per-sub-op]  main path 1e, the per-sub-op path (sga_mode=0): gemm_ln
             and attflat_pool against their plain versions at the
             MCAN-small B=64 shapes (both stream dtypes, D up to 2048,
             B=1), each shape's plan (gemm_ln: tile, cluster, grid, ring,
             shared memory, the instance's registers and spills, which the
             [gemm_ln] lines of the build list and hold against
             kernels.gemm_ln_smem_bytes; attflat_pool: CTAs a sample) and
             two runs' bits compared, and the repaired shapes of the older
             kernels
             (gemm_bias_act at N 480, the long attention forward and
             backward at Dh 192 / 256 and 160 / 608 rows, gemm_s4 /
             gemm_w4bf16 at K 384); build_production_engine(qffn=0,
             sga_mode=0) at MCAN-small full depth for each use_pallas x
             use_pallas_attflat, exact launches and agreement with the
             plain engine; mode 0 against mode 2 timed at B = 1, 8, 64; at
             2 layers a default Predictor at hidden 1536 and 2048 (mode 0)
             and the mode-0 kernel attention at Dh 192, hidden 480 (bf16),
             hidden 384 at int4 levels 5 and 7, 160 image rows;
  [all-layer]  main path 1f, the decoder modes 1, 3, 4, 5: sga_decoder
             (the cross k/v projected inside, mode 3; or outside, modes 4
             and 5), sa_encoder (mode 5) and the head-major SGA block (mode
             1) against their plain twins at MCAN-small, B = 1, 8, 64 with
             ragged and fully padded samples, with times, bounds and each
             stack's grid (blocks, blocks per SM); the stacks again at
             hidden 256 with 2 heads of 128 and 160 image rows (attention
             over three key chunks); build_production_engine(sga_mode=1, 3,
             4, 5) at full depth on the requests of [serve]: exact launches
             (one sga_decoder per forward of modes 3-5, one sa_encoder per
             mode-5 forward) and agreement with the plain engine (bf16
             bound; mode 1 with q8aux at level 3, the int8 bound); modes 1,
             3, 4, 5 and 2 timed at B = 1, 8, 64 in turns;
  [envelope] hidden 256 (8 heads of 32) and 86 image rows: the bf16, int8
             level 1 / 3 / 5 and full-int8 engines against the plain one;
             the seeded SGA block (and at hidden 256 the SA block) at B=64
             against the external-mask block fed the dump, bit for bit,
             and against its plain twin in every gradient; 3 Trainer steps,
             each loss against the plain engine's, with exact launch counts;
             the same seeded blocks at hidden 768 (4 heads of 192) and at
             160 image rows (the long attention kernels, forward and
             backward);
  [last sites]  main path 1g, the last three Pallas sites: ffn_ln_blocked
             and ffn_ln_wstationary (the streaming FFN + LayerNorm kernels)
             against their plain version at MCAN-large (M 3840, 60, a
             ragged 61 with a bf16 x) and MCAN-small (M 3840), each with
             its plan (``kernels.ffn_ln_plan``), two runs and the
             weight-stationary kernel on 3 clusters equal bit for bit, with
             times, the port's unfused pair (gemm_bias_act then gemm_ln),
             the addmm yardstick of the first product and the bound; the SGA train
             block with save_acts=False (the recompute FFN backward) at
             MCAN-small B=64 and MCAN-large micro-batch 32 (bf16_saves both
             ways) against the plain block under autograd, the seeded block
             against the block fed the dump bit for bit; the recompute
             piece's time beside the saved-activation piece's, the bytes
             the variant holds from forward to backward and its peak; then
             the public
             entry points once each with the counts set to 0 around them;
  [train]    main path 2: ``Trainer`` on ``SyntheticVQADataset`` at the
             same width, batch 64, one epoch of 10 steps, the encoder
             through the SA train blocks and the decoder through the SGA
             train blocks, with in-kernel dropout as the Trainer chooses on
             the card (one seed per block and step; the generator draws
             only AttFlat's masks): the fused engine's loss against the
             plain engine's (the same seeds through the plain Philox) at
             every step, the launch counts of every step, ms per step,
             bitwise repeatable gradients; then one step's forward and
             backward through the in-kernel and the external-mask routes
             (launches, masks drawn, ms, each route's loss against the
             plain engine's on that route); a falling loss on one repeated
             batch;
  [checkpoint]  the epoch checkpoint served by
             ``Predictor.from_checkpoint(engine="fused", act_scales=False)``
             (int8 level 1, its stored scales declined);
  [visualize]  ``run_vqa --run visualize``'s forward: [train]'s epoch
             pickle warm-started into a Trainer over a miniature VQA-v2
             val set in its own formats (8 questions, its own vocabulary),
             ``utils/visualize.visualization_outputs`` on the card against
             the same weights' ``forward_outputs`` on the CPU: with f32
             operands all eight keys within 1e-3 + 1e-3 |ref| elementwise
             (masks exactly); with bf16 operands each key's error printed,
             the probabilities within 1e-2; in both ``calc_mats_v2``'s
             top-7 regions the same (or swapped within 1e-5 / 1e-3 of
             v_w, a few times the v_w error read); whether matplotlib is
             installed on its own line, and the sheets rendered where it
             is;
  [stacked]  ``stacked_params="on"``: two Trainers of MCAN-small from the
             same weights and seed, standard and stacked layout, 3 seeded
             B=64 steps each: every weight and AdamW moment bit for bit,
             the same exact launches; the stacked run's pickle resumed by
             a standard Trainer: weights and moments equal;
  [lifecycle]  the checkpoint lifecycle at MCAN-small's full width, batch
             64, 256 synthetic samples, dropout 0.1 in the kernels:
             ``run_vqa --run train`` for 2 epochs (run U), for 1 epoch
             then resumed in a new process (``--resume true --ckpt_epoch
             1``, run R) and again for 2 (the control C): R's epoch-2
             weights, AdamW moments and step equal U's bit for bit (or,
             where C already differs from U, by no more than C does), U's
             launches exact; SIGTERM inside step 2 of epoch 0: epoch1.pkl,
             ``preempted_at_step``, ``train()`` returning, the handlers
             back, then a resume that trains on; ``opt_mu_dtype=
             "bfloat16"``: the pickle's first moment f32 and bf16-exact, a
             falling loss; 3 epochs with ``keep_last_ckpts=1`` saved at
             once and by the async saver (only epoch3.pkl and its side file
             remain; the saver's pickle equal byte for byte to
             ``save_checkpoint`` of the same state; each epoch's wall time,
             the pickle's size and write time); then
             ``Predictor.from_checkpoint`` of that pickle at its default
             engine, with q8aux=True and with engine="int4": the stored
             scales, no online collection, exact level-3 (level-5)
             launches, agreement with the plain engine, and the B=64
             forward of level 3 against level 1;
  [eval]     main path 4: a miniature VQA-v2 dataset in its own file
             formats at MCAN-small's full width (2048-d BUTD npz of 10-60
             regions with a class signature, answers from the frozen
             dictionary, 192 / 320 / 80 train / val / test questions), the
             train split packed by ``cli/pack_features.py``; ``run_vqa
             --run train --eval_ee true`` for 2 epochs (val evaluated after
             each and at the end through the fused eval engine, int8 level
             1), then ``--run val`` / ``test`` / ``parity`` from the epoch
             pickle: exact launches of the train steps and eval batches,
             the fused against the plain eval engine (top-1 outside
             near-ties, the int8 bound), every val question scored, every
             test question once in the EvalAI dumps, ``--run val``'s
             probabilities equal bit for bit to ``Trainer.predict``'s, and
             both engines' evaluation samples/s;
  [train large]  main path 3: ``Trainer`` at MCAN-large (hidden 1024, FF
             4096, batch 64 in two micro-batches of 32), 4 steps, the
             decoder through the SGA train blocks with att_saves and
             bf16_saves, the encoder plain: the same checks as [train];
             then one ``Trainer.evaluate`` of the synthetic val set
             through the fused eval engine (level 1 with the qkv int8 at
             D 1024, eval batch 32), exact launches, against the plain one;
  [classify] main path 5, the image-only classifier: ClassifierNet at
             MCAN-small width (6 SA layers over 60 regions of 1024
             features, 14 labels, seeded weights, images as
             SyntheticMIMICDataset makes them with two of no region)
             through ``build_production_classifier_engine`` at level 1,
             level 3 calibrated, levels 5 and 7 and qffn=0, at B = 1 and
             64: exact launches, each engine against the plain forward
             (2e-2 int8, 1e-2 bf16; int4 against level 3, 0.04, on the
             sigmoid) and the forward times; ``Trainer(task="classify")``
             for 4 steps at MCAN-small and 2 at MCAN-large (hidden 1024,
             two micro-batches), every SA block through the SA train
             kernels with in-kernel dropout: each step's loss against the
             plain blocks' (1e-3), exact launches, the in-epoch eval lines,
             the seeded SA train block at [64, 60, D] against the block fed
             its dump (bit for bit) and its plain twin; ``Trainer.evaluate``
             (ROC-AUC, exact launches, fused vs plain eval engine), the
             end-of-train scales side file against the engine calibrated on
             the last batch (bit for bit), and a falling loss on one batch;
  [mimic]    main path 6, MIMIC-CXR medical VQA on a miniature set in the
             real formats (``data/mimic_files.py``: 640 images, .npy
             region [60, 1024] and anatomy [26, 1024] banks, 15 labels
             with a learnable signature, 512 / 128 / 128 train / val / test
             questions; h5py is never imported): ``run_mimic --run train``
             at MCAN-small width (img_feat_size 1024, 60 region rows), one
             epoch of B=64 steps with in-kernel dropout, warm-started from
             [train]'s VQA epoch pickle (img_feat_size 2048, 3129 answers),
             the train split evaluated beside val and test; then ``--run
             val`` from its checkpoint. Gates: each step's loss against the
             plain blocks' (1e-3 relative), exact launches per step and per
             eval batch, the warm start (every tensor of a shared shape the
             pickle's bit for bit, the others fresh, one skip line each,
             fresh AdamW state), ``--run val``'s line equal to the train
             run's, the fused vs plain eval engine (INT8_BOUND, both
             ROC-AUCs), the end-of-train side file equal to the last
             batch's calibration and its level-3 engine bit for bit, a
             falling loss on one batch; the "both" (86 rows) and "anatomy"
             (26 rows) sources two steps each and an evaluation, and
             ``run_classify --run train`` on the same files, with the same
             step and eval gates;
  [distributed]  main path 7, data and tensor parallelism on
             torch.distributed (``parallel/``), each gate's value printed
             beside its limit: (a) NCCL, world 1, in this process: the
             MCAN-small B=64 fused step through ``make_train_step(
             data_group=WORLD)`` equal to the step with no group bit for
             bit (losses and every weight after 2 AdamW steps, dropout 0.1
             in the kernels); (b) two ranks spawned on cuda:0 over gloo
             (``chip_smoke.py --dist-rank R``), MCAN-small, mesh {data 2},
             the fused engine, 32 rows a rank of a B=64 batch (60 regions,
             3129 answers): at dropout 0 the loss (1e-5 relative) and
             every gradient leaf against one B=64 fused step (1e-3 of
             scale with the plain sites' operands f32; 2^-7 with bf16,
             whose leaves are roundings of partial sums), the gloo
             all-reduce of the gradient buffer timed; at dropout 0.1 in
             the kernels, 3 AdamW steps twice: the ranks' weights equal
             bit for bit and a repeat the same bits, the ranks' first
             decoder masks different, each rank's launches 3 steps' worth
             of the B=32 step; (c) the same ranks, MCAN-large, mesh
             {model 2}, the plain engine (JAX's route at tp > 1), B=64:
             loss (1e-4) and gradients (2e-4 of scale) against the tp = 1
             plain step at dropout 0 and 0.1 (shared masks) with f32
             operands, and with bf16 (2^-7), then one AdamW step each: the
             gathered pickle against the tp = 1 one (keys, shapes, moments
             within the gradient gate, weights within 2 lr); (d)
             ``Predictor(mesh=make_mesh({"data": 2}, devices=["cuda:0"] *
             2))`` at buckets 2, 8, 64 for the plain, level-1, level-3,
             int4 level-5 and q8aux engines: within 1e-6 of the mesh-less
             Predictor of the engine run on the bucket's two row slices,
             within the engine's bound of it on the whole bucket (its
             cuBLAS sites sum in other orders at other row counts) and of
             the plain one, twice its launches;
  [canary]   ``cli/validate_serving_accuracy.py`` at its defaults in a
             process of its own: MCAN-small trained 1200 steps on the card
             through the fused train engine, then the fused, qstatic,
             int8, int4, q8aux and bf16 engines scored against the plain
             one with the official evaluator; its exit code is a gate.

Launch counts are set to 0 just before each main path and read just after
it. Kernel and block times are device times (CUDA-graph replay), but for
the all-layer stacks and the head-major block of [all-layer]: CUDA events
around 20 eager calls queued back to back (a cooperative launch is not
captured into a graph here); step and forward
times are CUDA events
around eager calls, the host's launch time included. A failed build, launch or tolerance exits non-zero. The
next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when no CUDA device is present or the
package is not beside this file.
"""

from __future__ import annotations

import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

try:    # the port's package beside this file (main() checks where from)
    from mcan_vqa_tpu_torch.cli.card_check import (
        BATCH, HBM, LARGE_STEP, PRNG_SEED, SEED, SRC, STEP, TPU_TRAIN, Rows,
        bound_parts, cuda_ms, device_ms, fail, gate, max_err, pad_mask,
        plain_path, say)
    from mcan_vqa_tpu_torch.cli.validate_inkernel_dw import (
        block_vs_plain, check_train_block, sa_block_inputs,
        train_block_inputs)
    from mcan_vqa_tpu_torch.cli.validate_prng_dropout import (
        check_prng, seeded_vs_dump)
except ImportError as e:
    print(f"FAIL: the port package is not beside chip_smoke.py ({e})",
          file=sys.stderr, flush=True)
    sys.exit(1)


ROOT = Path(__file__).resolve().parent
LATENCY_BUCKETS = (1, 8)
TRAIN_STEPS = 10
LARGE_STEPS = 4
ROUNDS = 5                      # turns of every engine in [forward]
TPU = "mcan_vqa_tpu/ops/sga_block.py"
TPU_QUANT = "mcan_vqa_tpu/ops/quant.py"
SERVE = "one B=64 serving forward"
BOTH = SERVE + " + " + STEP
SERVE_INT8 = "one B=64 level-1 + one B=64 level-3 serving forward"
# max |dprob| of the int8 engines against the plain engine (f32 stream):
# at full width on the CPU they are 2.8e-3 (level 1) and 4.5e-3 (level 3)
# from model.apply (tests/test_torch_full_size.py::
# test_int8_engines_match_model_apply); 2e-2 is the bound that test and
# the JAX package (tests/test_quant.py:564) hold the int8 engine to, and
# leaves room for the card's summation order and scales calibrated on
# other rows than the ones compared
INT8_BOUND = 2e-2
# the int4 engines (levels 4-7): their weights alone (level 7, no
# activation quantized) move the sigmoid probabilities of MCAN-small with
# random weights by 4.2e-2 from model.apply on the CPU
# (tests/test_torch_full_size.py::test_quantized_engines_match_model_apply),
# past any bound <= 0.04 on them; so the bound is the JAX package's own int4
# gate, 0.04 on the softmax over the answers (tests/test_quant.py:339-370),
# with the sigmoid figure printed beside it
INT4_BOUND = 4e-2
SERVE_W4 = "one B=1 + one B=64 level-5 serving forward"
SERVE_W7 = "one B=1 + one B=64 level-7 serving forward"


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    sys.path.insert(0, str(ROOT))
    try:
        import mcan_vqa_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("mcan_vqa_tpu_torch was imported from outside this checkout")

    # the plain side runs f32 matmuls of bf16-rounded operands: keep TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from mcan_vqa_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    say(f"[build] {time.perf_counter() - t0:.2f} s (nvcc, one per source in "
        f"parallel, {_build.build_seconds or 0.0:.2f} s, key "
        f"{_build.build_key()})")
    if _build.step_seconds:
        say("[build] wall seconds per nvcc: " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(_build.step_seconds.items(),
                                              key=lambda kv: -kv[1])))
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[ptxas] {line.strip()}")
    sm90_report(_build, _build.load_library())
    int4_report(_build, _build.load_library())
    gemm_ln_report(_build, _build.load_library())
    attention_report(_build)
    stack_report(_build)

    rows = Rows()
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        say(f"[time] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    check_serving_kernels(torch, dev, rows)
    check_train_kernels(torch, dev, rows)
    check_large_kernels(torch, dev, rows)
    check_int8_kernels(torch, dev, rows)
    check_int4_kernels(torch, dev, rows)
    phase_done("kernels")
    model_state, cfg, vocab, ix_to_ans = build_model(torch)
    check_blocks(torch, dev, model_state, cfg, rows)
    check_int8_blocks(torch, dev, model_state, cfg, rows)
    check_int4_blocks(torch, dev, model_state, cfg, rows)
    check_train_block(torch, dev, rows)
    phase_done("blocks")
    check_prng(torch, dev, rows)
    phase_done("prng")
    plain, requests, fused, timed = serve_main_path(
        torch, dev, model_state, cfg, vocab, ix_to_ans, rows)
    timed += serve_quantized_paths(torch, dev, model_state, cfg, vocab,
                                   ix_to_ans, rows, plain, requests)
    time_forwards(torch, cfg, fused, timed + [("plain",
                                               plain.forward_padded)])
    phase_done("serve")
    art_work = ROOT / "ckpts" / "chip_smoke_artifact"
    try:
        art_dir = artifact_path(torch, dev, rows, art_work, model_state, cfg,
                                vocab, ix_to_ans, fused)
        phase_done("artifact")
        http_path(torch, dev, rows, cfg, fused, art_dir, card)
        phase_done("http")
    finally:
        shutil.rmtree(art_work, ignore_errors=True)
    check_sub_op_kernels(torch, dev, rows)
    serve_per_sub_op(torch, dev, model_state, cfg, plain, requests,
                     len(ix_to_ans), rows)
    check_wide_widths(torch, dev, vocab, ix_to_ans, rows)
    phase_done("per-sub-op")
    check_alllayer(torch, dev, model_state, cfg, rows)
    serve_alllayer(torch, dev, model_state, cfg, plain, requests,
                   len(ix_to_ans), rows)
    del plain, fused, timed
    phase_done("all-layer")
    check_envelope(torch, dev, vocab, ix_to_ans, rows)
    phase_done("envelope")
    check_last_sites(torch, dev, rows)
    phase_done("last sites")
    work = ROOT / "ckpts" / "chip_smoke"
    try:
        trainer, vqa_ckpt = train_main_path(torch, dev, rows, work)
        check_checkpoint(torch, dev, trainer, vqa_ckpt)
        check_repeated_batch(torch, trainer)
        del trainer
        phase_done("train")
        visualize_path(torch, dev, work / "visualize", vqa_ckpt)
        phase_done("visualize")
        stacked_path(torch, dev, rows, work / "stacked")
        phase_done("stacked")
        lifecycle_path(torch, dev, rows, work / "lifecycle", card)
        phase_done("lifecycle")
        eval_main_path(torch, dev, rows, work / "eval", card)
        phase_done("eval")
        trainer, _ = train_main_path(torch, dev, rows, work / "large",
                                     model="large", steps=LARGE_STEPS)
        evaluate_large(torch, trainer, rows)
        del trainer
        phase_done("train large")
        classify_path(torch, dev, rows, work / "classify", card)
        phase_done("classify")
        mimic_path(torch, dev, rows, work / "mimic", vqa_ckpt, card)
        phase_done("mimic")
        distributed_path(torch, dev, rows, work / "distributed",
                         model_state, cfg, vocab, ix_to_ans, card)
        phase_done("distributed")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    canary_path()
    phase_done("canary")
    record = rows.record()
    say(f"[card] {card}")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def plan_note(K, layout, M, N, Kd) -> str:
    """gemm_sm90.cu's plan of one product (kernels.gemm_plan)."""
    p = K.gemm_plan(layout, M, N, Kd)
    return (f"plan {p.bm}x{p.bn} tiles {p.tiles} x {p.splits} split(s) "
            f"of {p.k_tiles} K-tiles, grid {p.grid}, workspace "
            f"{p.workspace_bytes / 2 ** 20:.1f} MiB")


SM90_LAYOUTS = {"ILi1E": ("NT (dX)", 1), "ILi2E": ("TN (dW)", 2),
                "ILi3E": ("NN (forward)", 3), "ILi4E": ("S8 (gemm_s8)", 4)}


def sm90_report(build, lib) -> None:
    """Each gemm_sm90.cu instance's registers, spills (ptxas) and dynamic
    shared memory: gemm_sm90_kernel<layout, bn, seeded>, layout 1 NT, 2
    TN, 3 NN, 4 S8 (mangled ...ILi3ELi128ELb1E...)."""
    lines = build.build_log.splitlines()
    if not lines:
        say("[gemm_sm90] the library was built by an earlier process: no "
            "ptxas log here")
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or \
                "gemm_sm90_kernel" not in line:
            continue
        mangled = line.split("'")[1]
        layout, code = next((v for k, v in SM90_LAYOUTS.items()
                             if k in mangled), (mangled, 3))
        if "Lb1E" in mangled:
            layout += ", seeded"
        bn = 128 if "Li128E" in mangled else 64
        info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                        if "spill" in ln or "registers" in ln)
        say(f"[gemm_sm90] {layout} 128x{bn}: {info}; dynamic shared memory "
            f"{lib.mcan_gemm_sm90_smem(code, bn)} bytes")


INT4_LAYOUTS = {"ILi5E": ("S4 (gemm_s4)", 5), "ILi6E": ("W4 (gemm_w4bf16)", 6)}


def int4_report(build, lib) -> None:
    """Each gemm_int4.cu instance's registers, spills and stack frame
    (ptxas) and dynamic shared memory: gemm_int4_kernel<layout, rows>,
    layout 5 S4, 6 W4; the shared memory held against kernels.int4_smem_bytes,
    which the plan tests check against the card's 227 KB."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    lines = build.build_log.splitlines()
    if not lines:
        say("[gemm_int4] the library was built by an earlier process: no "
            "ptxas log here")
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or \
                "gemm_int4_kernel" not in line:
            continue
        mangled = line.split("'")[1]
        label, code = next((v for k, v in INT4_LAYOUTS.items()
                            if k in mangled), (mangled, 5))
        bm = 128 if "Li128E" in mangled else 64
        info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                        if "spill" in ln or "registers" in ln)
        say(f"[gemm_int4] {label} 128 columns x {bm} rows: {info}; dynamic "
            f"shared memory {lib.mcan_gemm_int4_smem(code, bm)} bytes")
    for code, bm in K.INT4_INSTANCES:
        got, want = lib.mcan_gemm_int4_smem(code, bm), K.int4_smem_bytes(
            code, bm)
        if got != want:
            fail(f"gemm_int4 layout {code} at {bm} rows: the library's "
                 f"shared memory {got} != kernels.int4_smem_bytes {want}")


GEMM_LN_INSTANCE = re.compile(r"gemm_ln_kernelILi(\d)ELi(\d)ELi(\d+)EE")
ATTFLAT_INSTANCE = re.compile(
    r"attflat_pool_kernelI(f|13__nv_bfloat16)Li(\d)EE")
FFN_INSTANCE = re.compile(
    r"(ffn_ln_blocked|ffn_ln_wstationary)_kernelILi(\d)ELi(\d+)E(?:Li(\d+)E)?")
# (f32 a, rows, columns) -> "N registers, S spill stores / loads" (ptxas)
GEMM_LN_PTXAS = {}


def gemm_ln_report(build, lib) -> None:
    """gemm_ln.cu's instances, gemm_ln_kernel<f32 a, warpgroups, columns>:
    registers and spills (ptxas) and dynamic shared memory, held against
    kernels.gemm_ln_smem_bytes (the plan's); attflat_pool.cu's and the
    streaming FFN kernels' instances' registers and spills."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    lines = build.build_log.splitlines()
    if not lines:
        say("[gemm_ln] the library was built by an earlier process: no "
            "ptxas log here")
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                        if "spill" in ln or "registers" in ln)
        m = GEMM_LN_INSTANCE.search(line)
        if m:
            f32, wgs, bn = (int(g) for g in m.groups())
            GEMM_LN_PTXAS[f32, 64 * wgs, bn] = info
            say(f"[gemm_ln] {'f32' if f32 else 'bf16'} a, {64 * wgs} x {bn}: "
                f"{info}; dynamic shared memory "
                f"{lib.mcan_gemm_ln_smem(f32, 64 * wgs, bn)} bytes")
        m = ATTFLAT_INSTANCE.search(line)
        if m:
            say(f"[attflat_pool] x {'f32' if m.group(1) == 'f' else 'bf16'}, "
                f"{m.group(2)} values a unit: {info}")
        m = FFN_INSTANCE.search(line)
        if m:
            name, f32, bn, ts = m.groups()
            say(f"[{name}] x {'f32' if f32 == '1' else 'bf16'}, {bn} columns"
                + (f", {ts} hidden units" if ts else "") + f" a CTA: {info}")
    for bm, bn in K.GEMM_LN_TILES:
        for f32 in (0, 1):
            got = lib.mcan_gemm_ln_smem(f32, bm, bn)
            want = K.gemm_ln_smem_bytes(bool(f32), bm, bn)
            if got != want:
                fail(f"gemm_ln {bm} x {bn}, f32 a {f32}: the library's shared "
                     f"memory {got} != kernels.gemm_ln_smem_bytes {want}")


def gemm_ln_plan_note(K, lib, label, M, Kd, D, a_f32) -> None:
    """gemm_ln.cu's plan of one call (kernels.gemm_ln_plan): the tile, the
    cluster, the grid, the ring, the shared memory, how many such clusters
    the card holds at once, and the instance's ptxas line."""
    p = K.gemm_ln_plan(M, Kd, D, a_f32)
    f32 = int(a_f32)
    ptxas = GEMM_LN_PTXAS.get((f32, p.bm, p.bn), "ptxas: not in this process")
    say(f"    [plan] gemm_ln {label}: {p.bm} x {p.bn} tiles, clusters of "
        f"{p.cluster} CTAs, grid {p.grid}, {p.stages} stages of the ring, "
        f"{p.smem} bytes of shared memory, "
        f"{lib.mcan_gemm_ln_max_clusters(f32, p.bm, p.bn, p.cluster)} "
        f"clusters at once; {ptxas}")


def same_bits(name, a, b) -> None:
    """Two runs of a kernel on the same inputs give the same bits."""
    import torch
    ok = all(torch.equal(x, y) for x, y in zip(a, b))
    say(f"  {name}: two runs {'give equal bits' if ok else 'DIFFER'}")
    if not ok:
        fail(f"{name}: two runs of the same inputs differ")


def attention_plan_note(K, label, q, k) -> None:
    """masked_attention.cu's plan of one call (kernels.attention_plan)."""
    B, H, Lq, Dh = q.shape
    p = K.attention_plan(B, H, Lq, k.shape[2], Dh)
    say(f"    [plan] masked_attention {label}: "
        f"{('one-block', 'long')[p.instance]} <{p.dhp}, {p.kc} keys>, "
        f"{p.rows} rows x {p.col_split} warp(s) a tile, {p.tiles} tile(s) a "
        f"head, grid {p.grid} x {p.threads} threads, {p.smem} B shared")


def attention_bwd_plan_note(K, label, q, k) -> None:
    """masked_attention_bwd.cu's plan of one call (kernels.
    attention_bwd_plan)."""
    B, H, Lq, Dh = q.shape
    p = K.attention_bwd_plan(B, H, Lq, k.shape[2], Dh)
    if p.instance == 0:
        say(f"    [plan] masked_attention_bwd {label}: one-block <{p.dhp}, "
            f"{p.kc} keys>, {p.rows} query x {p.key_rows} key rows, grid "
            f"{p.grid} x {p.threads} threads, {p.smem} B shared")
        return
    say(f"    [plan] masked_attention_bwd {label}: long <{p.dhp}>, rows "
        f"kernel {p.rows} rows x {p.col_split} warp(s) a tile, grid "
        f"{p.grid} x {p.threads}, {p.smem} B; keys kernel {p.key_rows} keys "
        f"x {p.key_split} warps a tile, grid {p.key_grid} x "
        f"{p.key_threads}, {p.key_smem} B; stats {4 * p.stats} B")


ATT_INSTANCE = re.compile(
    r"masked_attention_(long_)?kernelILi(\d+)E(?:Li(\d+)E)?")
ATT_BWD_INSTANCE = re.compile(
    r"(masked_attention_bwd|attention_bwd_rows|attention_bwd_keys)_kernel"
    r"ILi(\d+)E(?:Li(\d+)E)?")


def attention_report(build) -> None:
    """Each masked_attention.cu forward instance's registers and spills
    (ptxas) and the most dynamic shared memory a plan gives it: the
    one-block kernel <Dh padded, 8-key tiles> (mangled ...kernelILi64ELi8E)
    and the long kernel <Dh padded>; then masked_attention_bwd.cu's
    one-block and long rows / keys instances."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    lines = build.build_log.splitlines()
    if not lines:
        say("[masked_attention] the library was built by an earlier "
            "process: no ptxas log here")
    for i, line in enumerate(lines):
        m = ATT_INSTANCE.search(line)
        if "Compiling entry function" not in line or m is None:
            continue
        dhp = int(m.group(2))
        if m.group(1):
            name, keys = f"long <{dhp}>", 1 << 12
        else:
            keys = 8 * int(m.group(3))
            name = f"one-block <{dhp}, {keys} keys>"
        # the largest plan: 8 warps a block, every key staged or two stages
        smem = K.attention_plan(K.GEMM_SMS, 1, max(keys, 128), keys,
                                dhp).smem
        info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                        if "spill" in ln or "registers" in ln)
        say(f"[masked_attention] {name}: {info}; dynamic shared memory up "
            f"to {smem} bytes")
    # the backward: the one-block kernel <Dh padded, 8-key tiles> and the
    # long rows / keys kernels <Dh padded>; shared memory of the largest
    # plan (128 query rows one-block; 8 warps a block, 4096 rows long)
    for i, line in enumerate(lines):
        m = ATT_BWD_INSTANCE.search(line)
        if "Compiling entry function" not in line or m is None:
            continue
        dhp = int(m.group(2))
        if m.group(3):
            keys = 8 * int(m.group(3))
            name = f"one-block <{dhp}, {keys} keys>"
            smem = K.attention_bwd_plan(K.GEMM_SMS, 1, 128, keys, dhp).smem
        else:
            p = K.attention_bwd_plan(K.GEMM_SMS, 1, 4096, 4096, dhp)
            rows = m.group(1) == "attention_bwd_rows"
            name = f"long {('keys', 'rows')[rows]} <{dhp}>"
            smem = p.smem if rows else p.key_smem
        info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                        if "spill" in ln or "registers" in ln)
        say(f"[masked_attention_bwd] {name}: {info}; dynamic shared memory "
            f"up to {smem} bytes")


def gemm_bytes(M, K, N, *, a=2, b=2, out=(4,), bias=False, mask=False,
               gate=False, res=False):
    return (a * M * K + b * K * N + 4 * N * bias + M * N * mask
            + 2 * M * N * gate + 4 * M * N * res + sum(out) * M * N)


# ---------------------------------------------------------------------------
# phase: the serving kernels against their plain versions
# ---------------------------------------------------------------------------

def check_serving_kernels(torch, dev, rows) -> None:
    from mcan_vqa_tpu_torch.ops import kernels as K
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    D, F, H, Lq, Lv = 512, 2048, 8, 14, 60
    F_ = torch.nn.functional

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def weight(k, n):
        return ((torch.rand(k, n, generator=g, device=dev) * 2 - 1)
                / k ** 0.5).to(bf16)

    # Tolerances. f32 outputs: the two sides sum the same exact bf16
    # products in another order, so 1e-4 of the output scale covers the
    # rounding of a 2048-term f32 sum. bf16 outputs: one rounding may land
    # on the neighbouring bf16 value (2^-8 relative), so 8e-3 of the scale.
    def tol_for(ref, out_dtype):
        scale = float(ref.float().abs().max()) + 1e-6
        return (1e-4 if out_dtype == f32 else 8e-3) * scale

    say("[kernels] the serving kernels vs their plain PyTorch versions "
        "(times: the launches of one B=64 serving forward)")
    rows.row("gemm_bias_act", SRC + "gemm_sm90.cu", f"{TPU}:285", BOTH)
    rows.row("masked_attention", SRC + "masked_attention.cu", f"{TPU}:273",
             BOTH)
    rows.row("residual_layernorm", SRC + "residual_layernorm.cu",
             f"{TPU}:145", BOTH)
    # --- gemm_bias_act: (name, M, K, N, relu, out dtype, bias, launches
    # per B=64 forward)
    gemm_cases = []
    for M, blocks in ((BATCH * Lq, "enc"), (BATCH * Lv, "dec")):
        gemm_cases += [(f"{blocks} qkv", M, D, 3 * D, False, bf16, 6),
                       (f"{blocks} merge", M, D, D, False, f32,
                        6 if blocks == "enc" else 12),
                       (f"{blocks} ffn1", M, D, F, True, bf16, 6),
                       (f"{blocks} ffn2", M, F, D, False, f32, 6)]
        if blocks == "dec":
            gemm_cases.append(("dec q2", M, D, D, False, bf16, 6))
    gemm_cases += [("ragged M=61", 61, D, 3 * D, False, bf16, 0),
                   ("ragged M=42 relu", 42, D, F, True, bf16, 0),
                   ("ragged M=1", 1, F, D, False, f32, 0)]
    for name, M, Kd, N, relu, odt, per_fwd in gemm_cases:
        a, w = randn(M, Kd, dtype=bf16), weight(Kd, N)
        b = randn(N) * 0.1
        out = K.gemm_bias_act(a, w, b, relu=relu, out_dtype=odt)
        ref = K.gemm_bias_act_plain(a, w, b, relu=relu, out_dtype=odt)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        gate(f"gemm_bias_act {name} [{M}x{Kd}]x[{Kd}x{N}]", err,
             tol_for(ref, odt))
        rows.err("gemm_bias_act", err)
        if per_fwd:
            b16 = b.to(bf16)
            t_k = device_ms(torch, lambda: K.gemm_bias_act(
                a, w, b, relu=relu, out_dtype=odt))
            t_p = device_ms(torch, lambda: K.gemm_bias_act_plain(
                a, w, b, relu=relu, out_dtype=odt))
            t_l = device_ms(torch, lambda: torch.addmm(b16, a, w))
            say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms, addmm "
                f"{t_l:.4f} ms ({2 * M * Kd * N / t_k / 1e9:.1f} TFLOP/s); "
                f"{plan_note(K, 3, M, N, Kd)}")
            rows.add("gemm_bias_act", per_fwd, t_k, t_p, 2 * M * Kd * N,
                     gemm_bytes(M, Kd, N, bias=True,
                                out=(4 if odt == f32 else 2,)), t_l)

    # --- masked_attention
    def qkv_views(B, L):
        qkv = randn(B * L, 3 * D, dtype=bf16)
        q, k, v = qkv.view(B, L, 3 * D).split(D, dim=-1)
        return [t.view(B, L, H, D // H).transpose(1, 2) for t in (q, k, v)]

    def cross(B):
        q = randn(B * Lv, D, dtype=bf16).view(B, Lv, H, D // H).transpose(1, 2)
        return q, randn(B, H, Lq, D // H), randn(B, H, Lq, D // H)

    lens_q = [(i * 5) % (Lq + 1) for i in range(BATCH)]   # includes 0: all PAD
    lens_v = [(i * 17) % (Lv + 1) for i in range(BATCH)]
    att_cases = [("enc self 14x14", qkv_views(BATCH, Lq),
                  pad_mask(torch, BATCH, Lq, lens_q, dev), 6),
                 ("dec self 60x60", qkv_views(BATCH, Lv),
                  pad_mask(torch, BATCH, Lv, lens_v, dev), 6),
                 ("dec cross 60x14 f32 kv", cross(BATCH),
                  pad_mask(torch, BATCH, Lq, lens_q, dev), 6),
                 ("ragged B=3 cross, sample 1 all PAD", cross(3),
                  pad_mask(torch, 3, Lq, [9, 0, 14], dev), 0),
                 ("ragged B=3 self 60, sample 0 all PAD", qkv_views(3, Lv),
                  pad_mask(torch, 3, Lv, [0, 33, 60], dev), 0)]
    for name, (q, k, v), mask, per_fwd in att_cases:
        attention_plan_note(K, name, q, k)
        out = K.masked_attention(q, k, v, mask)
        ref = K.masked_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        gate(f"masked_attention {name} B={q.shape[0]}", err,
             tol_for(ref, bf16))
        rows.err("masked_attention", err)
        if per_fwd:
            B, _, L1, _ = q.shape
            L2 = k.shape[2]
            k16, v16 = k.to(bf16), v.to(bf16)
            keep = ~mask
            t_k = device_ms(torch, lambda: K.masked_attention(q, k, v, mask))
            t_p = device_ms(torch, lambda: K.masked_attention_plain(
                q, k, v, mask))
            t_l = device_ms(torch, lambda: F_.scaled_dot_product_attention(
                q, k16, v16, attn_mask=keep))
            say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms, sdpa "
                f"{t_l:.4f} ms")
            rows.add("masked_attention", per_fwd, t_k, t_p,
                     4 * B * H * L1 * L2 * 64,
                     attention_bytes(B, H, L1, L2, k.element_size()), t_l)

    # --- residual_layernorm: (name, rows, res dtype, bias?, out dtypes,
    # launches per B=64 forward)
    ln_cases = [("enc LN1", BATCH * Lq, bf16, True, (f32, bf16), 6),
                ("enc LN2", BATCH * Lq, f32, False, (bf16,), 6),
                ("dec LN1", BATCH * Lv, bf16, True, (f32, bf16), 6),
                ("dec LN2", BATCH * Lv, f32, True, (f32, bf16), 6),
                ("dec LN3", BATCH * Lv, f32, False, (bf16,), 6),
                ("ragged rows=61", 61, f32, True, (f32, bf16), 0)]
    for name, n_rows, rdt, has_bias, odts, per_fwd in ln_cases:
        res, y = randn(n_rows, D, dtype=rdt), randn(n_rows, D)
        bias = randn(D) * 0.1 if has_bias else None
        gamma, beta = 1 + randn(D) * 0.1, randn(D) * 0.1
        outs = K.residual_layernorm(res, y, bias, gamma, beta, odts)
        refs = K.residual_layernorm_plain(res, y, bias, gamma, beta, odts)
        torch.cuda.synchronize()
        for o, r, dt in zip(outs, refs, odts):
            err = max_err(o, r)
            gate(f"residual_layernorm {name} res {str(rdt)[6:]} -> "
                 f"{str(dt)[6:]}", err, max(tol_for(r, dt), 1e-5))
            rows.err("residual_layernorm", err)
        if per_fwd:
            t_k = device_ms(torch, lambda: K.residual_layernorm(
                res, y, bias, gamma, beta, odts))
            t_p = device_ms(torch, lambda: K.residual_layernorm_plain(
                res, y, bias, gamma, beta, odts))
            say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms "
                f"(no library call: the Bessel-std LayerNorm)")
            rows.add("residual_layernorm", per_fwd, t_k, t_p,
                     10 * n_rows * D, ln_bytes(n_rows, D, res.element_size(),
                                               outs=[o.element_size()
                                                     for o in outs]),
                     tensor=False)


def attention_bytes(B, H, Lq, Lk, kv_size, drop=False, Dh=64):
    return (2 * B * H * Lq * Dh + 2 * kv_size * B * H * Lk * Dh + B * Lk
            + B * H * Lq * Lk * drop + 2 * B * Lq * H * Dh)


def attention_bwd_bytes(B, H, Lq, Lk, kv_size, copies, drop=True, Dh=64):
    """q, k, v, dout read; dq, dk, dv written f32 (and the bf16 copies in
    `copies`: 'q', 'k', 'v')."""
    return (2 * B * H * Lq * Dh + 2 * kv_size * B * H * Lk * Dh + B * Lk
            + B * H * Lq * Lk * drop + 2 * B * Lq * H * Dh
            + (4 + 2 * ("q" in copies)) * B * H * Lq * Dh
            + (8 + 2 * ("k" in copies) + 2 * ("v" in copies)) * B * H * Lk
            * Dh)


def ln_bytes(n_rows, D, res_size, outs=(4,), y=True, mask=False,
             save_r=False):
    return n_rows * D * (res_size + 4 * y + mask + sum(outs) + 4 * save_r) \
        + 12 * D


def ln_bwd_bytes(n_rows, D, y=True, mask=True, dys=(4, 2)):
    return n_rows * D * (4 + 4 + 4 * y + mask + 4 + 4 + sum(dys)) + 8 * D


# ---------------------------------------------------------------------------
# phase (a): the train kernels against their plain versions, at the shapes
# of one B=64 train step (6 decoder blocks, each: forward, FFN backward,
# attention backward)
# ---------------------------------------------------------------------------

class KernelCheck:
    """Random inputs from one generator on the card, and one kernel against
    its plain version: ``case`` gates every output, then times both (and a
    library call) unless ``timed=False``, and adds the times and bound to
    the kernel's row."""

    def __init__(self, torch, dev, rows, seed):
        self.torch, self.dev, self.rows = torch, dev, rows
        self.g = torch.Generator(device=dev).manual_seed(seed)

    def randn(self, *shape, dtype=None, s=1.0):
        t = self.torch.randn(*shape, generator=self.g, device=self.dev) * s
        return t if dtype is None else t.to(dtype)

    def keep(self, *shape):
        return self.torch.rand(*shape, generator=self.g,
                               device=self.dev) >= 0.1

    @staticmethod
    def scaled(ref, rel):
        return rel * (float(ref.float().abs().max()) + 1e-6)

    def case(self, row, label, kern, plain, tols, n, flops, nbytes,
             lib=None, tensor=True, timed=True):
        """kern() / plain() -> tuples of outputs; tols: per output, the
        tolerance as a fraction of that output's max|ref|."""
        torch, rows = self.torch, self.rows
        outs, refs = kern(), plain()
        torch.cuda.synchronize()
        for i, (o, r, rel) in enumerate(zip(outs, refs, tols)):
            err = max_err(o, r)
            gate(f"{row} {label} out{i}", err, max(self.scaled(r, rel), 1e-6))
            rows.err(row, err)
        if not timed:
            return
        t_k = device_ms(torch, kern)
        t_p = device_ms(torch, plain)
        t_l = device_ms(torch, lib) if lib is not None else None
        say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms"
            + (f", library {t_l:.4f} ms" if t_l is not None else "")
            + f"; bound {max(bound_parts(flops, nbytes, tensor)):.4f} ms")
        rows.add(row, n, t_k, t_p, flops, nbytes, t_l, tensor)


def check_train_kernels(torch, dev, rows) -> None:
    from mcan_vqa_tpu_torch.cli.bench_attention import sdpa_backward_ms
    from mcan_vqa_tpu_torch.ops import kernels as K
    kc = KernelCheck(torch, dev, rows, SEED + 3)
    randn, keep, case = kc.randn, kc.keep, kc.case
    bf16, f32 = torch.bfloat16, torch.float32
    D, F, H, Lq, Lv = 512, 2048, 8, 14, 60
    M = BATCH * Lv
    L = 6                              # decoder blocks per step
    inv = 1 / 0.9                      # rate 0.1
    F_ = torch.nn.functional

    def scaled(ref, rel):
        return kc.scaled(ref, rel)

    say("[kernels] the train kernels vs their plain PyTorch versions at the "
        "B=64 train-step shapes, dropout rate 0.1 (times: the launches of "
        "one train step)")
    for name, src, tpu in (
            ("gemm_dx", "gemm_sm90.cu", f"{TPU_TRAIN}:599"),
            ("gemm_dw", "gemm_sm90.cu", f"{TPU_TRAIN}:382"),
            ("masked_attention_bwd", "masked_attention_bwd.cu",
             f"{TPU_TRAIN}:250"),
            ("residual_layernorm_bwd", "residual_layernorm_bwd.cu",
             f"{TPU_TRAIN}:122"),
            ("col_sum", "col_sum.cu", f"{TPU_TRAIN}:406")):
        rows.row(name, SRC + src, tpu, STEP)

    # f32 GEMM outputs: exact bf16 products summed in another order; bf16
    # outputs: one rounding may land a step (2^-8) apart
    T32, T16 = 1e-4, 8e-3

    # --- gemm_bias_act: the FFN's first product with the h1 keep-mask on
    # the ReLU output (the other forward products are the serving ones)
    a, w1 = randn(M, D, dtype=bf16), randn(D, F, dtype=bf16, s=D ** -0.5)
    b1, h1 = randn(F, s=0.1), keep(M, F)
    b1_16 = b1.to(bf16)
    kw = dict(relu=True, out_dtype=bf16, mask=h1, inv_keep=inv)
    case("gemm_bias_act", "ffn1 relu + h1 dropout -> bf16",
         lambda: (K.gemm_bias_act(a, w1, b1, **kw),),
         lambda: (K.gemm_bias_act_plain(a, w1, b1, **kw),), (T16,), L,
         2 * M * D * F, gemm_bytes(M, D, F, bias=True, mask=True, out=(2,)),
         lambda: torch.addmm(b1_16, a, w1))
    fwd_gemms = [("qkv", D, 3 * D, 2), ("merge", D, D, 4), ("q2", D, D, 2),
                 ("merge2", D, D, 4), ("ffn2", F, D, 4)]
    for label, Kd, N, osz in fwd_gemms:
        # the forward's other products (and the attention backward's four
        # recomputes: qkv, the merge, q2, merge2) at the decoder's M
        x, w = randn(M, Kd, dtype=bf16), randn(Kd, N, dtype=bf16, s=Kd ** -.5)
        b = randn(N, s=0.1)
        b16 = b.to(bf16)
        odt = bf16 if osz == 2 else f32
        n = L * (1 if label == "ffn2" else 2)
        case("gemm_bias_act", f"{label} [{M}x{Kd}]x[{Kd}x{N}]",
             lambda: (K.gemm_bias_act(x, w, b, out_dtype=odt),),
             lambda: (K.gemm_bias_act_plain(x, w, b, out_dtype=odt),),
             (T16 if osz == 2 else T32,), n, 2 * M * Kd * N,
             gemm_bytes(M, Kd, N, bias=True, out=(osz,)),
             lambda: torch.addmm(b16, x, w))

    # --- gemm_dx: (label, K = width of dy, N = width of dx, gate, res,
    # out sizes)
    dx_cases = [("da1 = dy3 W2^T, ReLU/h1 gate", D, F, True, False,
                 (f32, bf16)),
                ("gv2 = da1 W1^T + gr3", F, D, False, True, (f32,)),
                ("datt2 = dy2 Wm2^T", D, D, False, False, (bf16,)),
                ("gv1 = dqx Wq2^T + gr2", D, D, False, True, (f32,)),
                ("datt1 = dy1 Wm1^T", D, D, False, False, (bf16,)),
                ("dx = dqkv Wqkv^T + gr1", 3 * D, D, False, True, (f32,))]
    for label, Kd, N, has_gate, has_res, odt in dx_cases:
        say(f"  gemm_dx {label}: {plan_note(K, 1, M, N, Kd)}")
        dy = randn(M, Kd, dtype=bf16)
        w = randn(N, Kd, dtype=bf16, s=Kd ** -0.5)
        gt = torch.relu(randn(M, N)).to(bf16) if has_gate else None
        res = randn(M, N) if has_res else None
        kw = dict(gate=gt, inv_keep=inv, res=res, out_dtypes=odt)
        case("gemm_dx", label, lambda: K.gemm_dx(dy, w, **kw),
             lambda: K.gemm_dx_plain(dy, w, **kw),
             tuple(T32 if o == f32 else T16 for o in odt), L,
             2 * M * Kd * N,
             gemm_bytes(M, Kd, N, gate=has_gate, res=has_res,
                        out=tuple(o.itemsize for o in odt)),
             lambda: torch.mm(dy, w.t()))

    # --- gemm_dw: x [M rows, m]^T . dy [M rows, n], summed over all 3840
    # rows in the plan's splits, added in split order
    dw_cases = [("dW1 = v2^T da1", D, F), ("dW2 = h1d^T dy3", F, D),
                ("dWqkv = x^T dqkv", D, 3 * D), ("dWm1", D, D),
                ("dWq2", D, D), ("dWm2", D, D)]
    for label, m, n in dw_cases:
        say(f"  gemm_dw {label}: {plan_note(K, 2, m, n, M)}")
        xr = randn(M, m, dtype=bf16)
        dy = randn(M, n, dtype=bf16, s=M ** -0.5)
        case("gemm_dw", f"{label} [{m}x{M}]x[{M}x{n}]",
             lambda: (K.gemm_dw(xr, dy),), lambda: (K.gemm_dw_plain(xr, dy),),
             (T32,), L, 2 * M * m * n,
             gemm_bytes(m, M, n, out=(4,)), lambda: torch.mm(xr.t(), dy))
        again = K.gemm_dw(xr, dy)
        if not torch.equal(again, K.gemm_dw(xr, dy)):
            fail(f"gemm_dw {label}: two runs differ")

    # --- masked_attention with the att1 / att2 keep-masks (forward and the
    # attention backward's recompute: 2 of each per block)
    lens_q = [(i * 5) % (Lq + 1) for i in range(BATCH)]
    lens_v = [(i * 17) % (Lv + 1) for i in range(BATCH)]
    qkv = randn(M, 3 * D, dtype=bf16)
    sq, sk, sv = [t.view(BATCH, Lv, H, 64).transpose(1, 2)
                  for t in qkv.view(BATCH, Lv, 3 * D).split(D, dim=-1)]
    cq = randn(M, D, dtype=bf16).view(BATCH, Lv, H, 64).transpose(1, 2)
    ck, cv = randn(BATCH, H, Lq, 64), randn(BATCH, H, Lq, 64)
    vmask = pad_mask(torch, BATCH, Lv, lens_v, dev)
    qmask = pad_mask(torch, BATCH, Lq, lens_q, dev)
    att_cases = [("self 60x60 + att1 dropout", (sq, sk, sv), vmask,
                  keep(BATCH, H, Lv, Lv)),
                 ("cross 60x14 f32 kv + att2 dropout", (cq, ck, cv), qmask,
                  keep(BATCH, H, Lv, Lq))]
    for label, (q, k, v), mask, drop in att_cases:
        Lk = k.shape[2]
        k16, v16 = k.to(bf16), v.to(bf16)
        keep_mask = ~mask
        attention_plan_note(K, label, q, k)
        case("masked_attention", label,
             lambda: (K.masked_attention(q, k, v, mask, drop, inv),),
             lambda: (K.masked_attention_plain(q, k, v, mask, drop, inv),),
             (T16,), 2 * L, 4 * BATCH * H * Lv * Lk * 64,
             attention_bytes(BATCH, H, Lv, Lk, k.element_size(), drop=True),
             lambda: F_.scaled_dot_product_attention(
                 q, k16, v16, attn_mask=keep_mask))

    # --- masked_attention_bwd: self (dq, dk, dv and their bf16 copies, in
    # the fused dqkv layout) and cross (dq and its copy; dkq, dvq f32)
    dout = randn(BATCH, Lv, D, dtype=bf16)
    for label, (q, k, v), mask, drop, copies in (
            ("self 60x60", (sq, sk, sv), vmask, att_cases[0][3], "qkv"),
            ("cross 60x14 f32 kv", (cq, ck, cv), qmask, att_cases[1][3],
             "q")):
        Lk = k.shape[2]
        attention_bwd_plan_note(K, label, q, k)

        def grads(fn, q=q, k=k, v=v, mask=mask, drop=drop, copies=copies):
            dq = torch.empty(BATCH, H, Lv, 64, device=dev)
            dk = torch.empty(BATCH, H, Lk, 64, device=dev)
            dv = torch.empty(BATCH, H, Lk, 64, device=dev)
            c16 = [torch.empty(t.shape, dtype=bf16, device=dev)
                   if c in copies else None
                   for t, c in ((dq, "q"), (dk, "k"), (dv, "v"))]
            fn(q, k, v, mask, dout, dq, dk, dv, *c16, drop=drop,
               inv_keep=inv)
            return (dq, dk, dv)

        d4 = dout.view(BATCH, Lv, H, 64).transpose(1, 2)
        # dS rounded to bf16 may land a step apart: 2^-7 of each output's
        # max|ref|
        tol = 2 ** -7
        outs = grads(K.masked_attention_bwd)
        refs = grads(K.masked_attention_bwd_plain)
        torch.cuda.synchronize()
        for name_, o, r in zip(("dq", "dk", "dv"), outs, refs):
            err = max_err(o, r)
            gate(f"masked_attention_bwd {label} {name_}", err, scaled(r, tol))
            rows.err("masked_attention_bwd", err)
        t_k = device_ms(torch, lambda: grads(K.masked_attention_bwd))
        t_p = device_ms(torch, lambda: grads(K.masked_attention_bwd_plain))
        # SDPA's backward: one autograd call, graphed as the kernel
        t_l = sdpa_backward_ms(torch, q, k, v, mask, d4)
        if t_l is None:
            rows.unmeasured("masked_attention_bwd")
        flops = 10 * BATCH * H * Lv * Lk * 64
        nbytes = attention_bwd_bytes(BATCH, H, Lv, Lk, k.element_size(),
                                     copies)
        say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms, sdpa backward "
            f"{t_l} ms; bound "
            f"{max(bound_parts(flops, nbytes)):.4f} ms")
        rows.add("masked_attention_bwd", L, t_k, t_p, flops, nbytes, t_l)

    # --- residual_layernorm with the y1 / y2 / y3 keep-masks and the train
    # kernels' reciprocal rounding; LN3 also writes r3
    for label, save_r, odts in (("LN1/LN2 + dropout -> f32, bf16", False,
                                 (f32, bf16)),
                                ("LN3 + y3 dropout -> f32, r3", True, (f32,))):
        res, y = randn(M, D), randn(M, D)
        bias, gamma, beta = randn(D, s=0.1), 1 + randn(D, s=0.1), \
            randn(D, s=0.1)
        mask = keep(M, D)
        kw = dict(mask=mask, inv_keep=inv, save_r=save_r, reciprocal=True)
        n = L * (1 if save_r else 2)
        case("residual_layernorm", label,
             lambda: K.residual_layernorm(res, y, bias, gamma, beta, odts,
                                          **kw),
             lambda: K.residual_layernorm_plain(res, y, bias, gamma, beta,
                                                odts, **kw),
             tuple(1e-5 if dt == f32 else T16 for dt in odts) + (1e-5,),
             n, 10 * M * D,
             ln_bytes(M, D, 4, outs=[o.itemsize for o in odts], mask=True,
                      save_r=save_r), tensor=False)

    # --- residual_layernorm_bwd: LN3 (from the saved r3: no y), LN2, LN1
    for label, with_y, n in (("LN3 from r3", False, 1), ("LN1/LN2", True, 2)):
        gout, res = randn(M, D), randn(M, D)
        y = randn(M, D) if with_y else None
        bias = randn(D, s=0.1) if with_y else None
        gamma = 1 + randn(D, s=0.1)
        mask = keep(M, D)
        kw = dict(mask=mask, inv_keep=inv, dy_dtypes=(f32, bf16))
        case("residual_layernorm_bwd", label,
             lambda: K.residual_layernorm_bwd(gout, res, y, bias, gamma,
                                              **kw),
             lambda: K.residual_layernorm_bwd_plain(gout, res, y, bias,
                                                    gamma, **kw),
             (1e-4, 1e-5, 1e-4, T16), n * L, 20 * M * D,
             ln_bwd_bytes(M, D, y=with_y), tensor=False)

    # --- col_sum: the bias and LayerNorm gradients of the three backward
    # sums per block
    for label, widths in (("db1, db2, dln3", (F, D, D, D)),
                          ("dbqkv, dbm1, dln1", (3 * D, D, D, D)),
                          ("dbq2, dbm2, dln2", (D, D, D, D))):
        mats = [randn(M, w_) for w_ in widths]
        case("col_sum", label, lambda: K.col_sum(mats),
             lambda: K.col_sum_plain(mats), (1e-5,) * 4, L,
             M * sum(widths), 4 * (M + 1) * sum(widths),
             lambda: [m_.sum(0) for m_ in mats], tensor=False)
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(K.col_sum(mats), K.col_sum(mats))):
            fail(f"col_sum {label}: two runs differ")
    # ragged rows (one, seven, a count no slab divides) and matrices
    # narrower than one 128-column chunk (widths that are no multiple of 4
    # or 8: read element by element), twice alike, the counters left at 0
    for label, n_rows, widths, dts in (
            ("1 row", 1, (512, 7), (f32, bf16)),
            ("7 rows", 7, (2048, 100), (f32, bf16)),
            ("3841 rows", 3841, (512, 24, 1536, 5), (f32, f32, bf16, bf16)),
            ("1000 rows, narrow", 1000, (96, 40, 8, 3),
             (bf16, f32, bf16, f32))):
        mats = [randn(n_rows, w_, dtype=dt) for w_, dt in zip(widths, dts)]
        say(f"    [plan] col_sum {label}: "
            f"{K.col_sum_plan(n_rows, widths)}")
        case("col_sum", f"ragged {label}", lambda: K.col_sum(mats),
             lambda: K.col_sum_plain(mats), (1e-5,) * len(mats), 0, 0, 0,
             timed=False)
        if not all(torch.equal(a_, b_) for a_, b_ in
                   zip(K.col_sum(mats), K.col_sum(mats))):
            fail(f"col_sum ragged {label}: two runs differ")
    torch.cuda.synchronize()
    counters = K._COL_SUM_COUNTERS.get(mats[0].device)
    if counters is None or bool(counters.any()):
        fail("col_sum: the chunk counters are not all 0 after the launches")

    check_encoder_kernels(torch, K, kc, D, F, H, Lq, L, inv)


def check_encoder_kernels(torch, K, kc, D, F, H, L, n_blocks, inv) -> None:
    """The same kernels at the shapes of the step's six SA encoder blocks
    (the fused encoder: M = 64 x 14 question rows, the h1 / att / y1 / y2
    masks at rate 0.1): the forward products and the backward's recomputed
    qkv / merge, dX, dW, attention, LayerNorms and column sums."""
    from mcan_vqa_tpu_torch.cli.bench_attention import sdpa_backward_ms
    bf16, f32 = torch.bfloat16, torch.float32
    randn, keep, case = kc.randn, kc.keep, kc.case
    T32, T16 = 1e-4, 8e-3
    M, n = BATCH * L, n_blocks
    say(f"[kernels] the same at the SA encoder's shapes (M = {M} rows)")
    for label, Kd, N, relu, odt, k in (
            ("enc qkv", D, 3 * D, False, bf16, 2 * n),
            ("enc merge", D, D, False, f32, 2 * n),
            ("enc ffn1 relu + h1 dropout", D, F, True, bf16, n),
            ("enc ffn2", F, D, False, f32, n)):
        x, w = randn(M, Kd, dtype=bf16), randn(Kd, N, dtype=bf16, s=Kd ** -.5)
        b = randn(N, s=0.1)
        kw = dict(relu=relu, out_dtype=odt)
        if relu:
            kw.update(mask=keep(M, N), inv_keep=inv)
        b16 = b.to(bf16)
        case("gemm_bias_act", label,
             lambda: (K.gemm_bias_act(x, w, b, **kw),),
             lambda: (K.gemm_bias_act_plain(x, w, b, **kw),),
             (T16 if odt == bf16 else T32,), k, 2 * M * Kd * N,
             gemm_bytes(M, Kd, N, bias=True, mask=relu,
                        out=(odt.itemsize,)), lambda: torch.addmm(b16, x, w))
    for label, Kd, N, has_gate, has_res, odt in (
            ("enc da1 = dy2 W2^T, ReLU/h1 gate", D, F, True, False,
             (f32, bf16)),
            ("enc gx1 = da1 W1^T + gr2", F, D, False, True, (f32,)),
            ("enc datt = dy1 Wm^T", D, D, False, False, (bf16,)),
            ("enc dx = dqkv Wqkv^T + gr1", 3 * D, D, False, True, (f32,))):
        say(f"  gemm_dx {label}: {plan_note(K, 1, M, N, Kd)}")
        dy = randn(M, Kd, dtype=bf16)
        w = randn(N, Kd, dtype=bf16, s=Kd ** -0.5)
        gt = torch.relu(randn(M, N)).to(bf16) if has_gate else None
        res = randn(M, N) if has_res else None
        kw = dict(gate=gt, inv_keep=inv, res=res, out_dtypes=odt)
        case("gemm_dx", label, lambda: K.gemm_dx(dy, w, **kw),
             lambda: K.gemm_dx_plain(dy, w, **kw),
             tuple(T32 if o == f32 else T16 for o in odt), n,
             2 * M * Kd * N,
             gemm_bytes(M, Kd, N, gate=has_gate, res=has_res,
                        out=tuple(o.itemsize for o in odt)),
             lambda: torch.mm(dy, w.t()))
    for label, m, n_ in (("enc dWqkv", D, 3 * D), ("enc dWm", D, D),
                         ("enc dW1", D, F), ("enc dW2", F, D)):
        say(f"  gemm_dw {label}: {plan_note(K, 2, m, n_, M)}")
        xr = randn(M, m, dtype=bf16)
        dy = randn(M, n_, dtype=bf16, s=M ** -0.5)
        case("gemm_dw", f"{label} [{m}x{M}]x[{M}x{n_}]",
             lambda: (K.gemm_dw(xr, dy),), lambda: (K.gemm_dw_plain(xr, dy),),
             (T32,), n, 2 * M * m * n_, gemm_bytes(m, M, n_, out=(4,)),
             lambda: torch.mm(xr.t(), dy))
    qkv = randn(M, 3 * D, dtype=bf16)
    q, k, v = [t.view(BATCH, L, H, D // H).transpose(1, 2)
               for t in qkv.view(BATCH, L, 3 * D).split(D, dim=-1)]
    mask = pad_mask(torch, BATCH, L, [(i * 5) % (L + 1) for i in range(BATCH)],
                    kc.dev)
    drop = keep(BATCH, H, L, L)
    F_ = torch.nn.functional
    attention_plan_note(K, "enc self 14x14", q, k)
    case("masked_attention", "enc self 14x14 + att dropout",
         lambda: (K.masked_attention(q, k, v, mask, drop, inv),),
         lambda: (K.masked_attention_plain(q, k, v, mask, drop, inv),),
         (T16,), 2 * n, 4 * BATCH * H * L * L * (D // H),
         attention_bytes(BATCH, H, L, L, 2, drop=True, Dh=D // H),
         lambda: F_.scaled_dot_product_attention(q, k, v, attn_mask=~mask))
    dout = randn(BATCH, L, D, dtype=bf16)
    attention_bwd_plan_note(K, "enc self 14x14", q, k)

    def grads(fn):
        dqkv = torch.empty(M, 3 * D, device=kc.dev)
        d16 = torch.empty(M, 3 * D, dtype=bf16, device=kc.dev)
        views = [t.view(BATCH, L, H, D // H).transpose(1, 2)
                 for t in dqkv.view(BATCH, L, 3 * D).split(D, dim=-1)]
        v16 = [t.view(BATCH, L, H, D // H).transpose(1, 2)
               for t in d16.view(BATCH, L, 3 * D).split(D, dim=-1)]
        fn(q, k, v, mask, dout, *views, *v16, drop=drop, inv_keep=inv)
        return tuple(views)

    case("masked_attention_bwd", "enc self 14x14", lambda: grads(
        K.masked_attention_bwd), lambda: grads(K.masked_attention_bwd_plain),
         (2 ** -7,) * 3, n, 10 * BATCH * H * L * L * (D // H),
         attention_bwd_bytes(BATCH, H, L, L, 2, "qkv", Dh=D // H))
    # SDPA's backward here too, so that the row's library time covers the
    # calls its time does
    t_l = sdpa_backward_ms(torch, q, k, v, mask, dout.view(
        BATCH, L, H, D // H).transpose(1, 2))
    say(f"    sdpa backward {t_l} ms")
    if t_l is None:
        kc.rows.unmeasured("masked_attention_bwd")
    else:
        kc.rows.add("masked_attention_bwd", n, library_ms=t_l)
    for label, save_r, odts, k in (("enc LN1 + y1 -> f32, bf16", False,
                                    (f32, bf16), n),
                                   ("enc LN2 + y2 -> f32, r2", True, (f32,),
                                    n)):
        res, y = randn(M, D), randn(M, D)
        bias, gamma, beta = randn(D, s=0.1), 1 + randn(D, s=0.1), \
            randn(D, s=0.1)
        kw = dict(mask=keep(M, D), inv_keep=inv, save_r=save_r,
                  reciprocal=True)
        case("residual_layernorm", label,
             lambda: K.residual_layernorm(res, y, bias, gamma, beta, odts,
                                          **kw),
             lambda: K.residual_layernorm_plain(res, y, bias, gamma, beta,
                                                odts, **kw),
             tuple(1e-5 if dt == f32 else T16 for dt in odts) + (1e-5,), k,
             10 * M * D, ln_bytes(M, D, 4, outs=[o.itemsize for o in odts],
                                  mask=True, save_r=save_r), tensor=False)
    for label, with_y in (("enc LN2 from r2", False), ("enc LN1", True)):
        gout, res = randn(M, D), randn(M, D)
        y = randn(M, D) if with_y else None
        bias = randn(D, s=0.1) if with_y else None
        gamma = 1 + randn(D, s=0.1)
        kw = dict(mask=keep(M, D), inv_keep=inv, dy_dtypes=(f32, bf16))
        case("residual_layernorm_bwd", label,
             lambda: K.residual_layernorm_bwd(gout, res, y, bias, gamma,
                                              **kw),
             lambda: K.residual_layernorm_bwd_plain(gout, res, y, bias,
                                                    gamma, **kw),
             (1e-4, 1e-5, 1e-4, T16), n, 20 * M * D,
             ln_bwd_bytes(M, D, y=with_y), tensor=False)
    for label, widths in (("enc dbqkv, dbm, dln1", (3 * D, D, D, D)),
                          ("enc db1, db2, dln2", (F, D, D, D))):
        mats = [randn(M, w_) for w_ in widths]
        case("col_sum", label, lambda: K.col_sum(mats),
             lambda: K.col_sum_plain(mats), (1e-5,) * 4, n,
             M * sum(widths), 4 * (M + 1) * sum(widths),
             lambda: [m_.sum(0) for m_ in mats], tensor=False)


def check_large_kernels(torch, dev, rows) -> None:
    """Every kernel of the MCAN-large train step at its shapes (one
    micro-batch of 32: M = 1920 region rows, D = 1024, F = 4096, 8 heads of
    128; the bf16 saves): each against its plain version. The attention
    kernels at Dh = 128 and the backward products (gemm_dx, gemm_dw) are
    timed, for one B=64 MCAN-large step (two micro-batches, 6 decoder
    blocks each); the other kernels' times stand for the MCAN-small
    units."""
    from mcan_vqa_tpu_torch.cli.bench_attention import sdpa_backward_ms
    from mcan_vqa_tpu_torch.ops import kernels as K
    kc = KernelCheck(torch, dev, rows, SEED + 4)
    randn, keep, case = kc.randn, kc.keep, kc.case
    bf16, f32 = torch.bfloat16, torch.float32
    B, D, F, H, Lq, Lv = BATCH // 2, 1024, 4096, 8, 14, 60
    Dh, M, n = D // H, BATCH // 2 * Lv, 12
    inv = 1 / 0.9
    T32, T16 = 1e-4, 8e-3
    F_ = torch.nn.functional
    say(f"[kernels] the MCAN-large train step's kernels at its shapes (B={B}"
        f" per micro-batch, M={M}, D={D}, F={F}, Dh={Dh}, bf16 saves; "
        f"attention times: the launches of one B={BATCH} step)")
    rows.row("masked_attention_dh128", SRC + "masked_attention.cu",
             f"{TPU_TRAIN}:448", LARGE_STEP)
    rows.row("masked_attention_bwd_dh128", SRC + "masked_attention_bwd.cu",
             f"{TPU_TRAIN}:250", LARGE_STEP)
    for label, Kd, N, relu, odt in (("qkv", D, 3 * D, False, bf16),
                                    ("merge", D, D, False, f32),
                                    ("ffn1 relu + h1", D, F, True, bf16),
                                    ("ffn2", F, D, False, f32)):
        x, w = randn(M, Kd, dtype=bf16), randn(Kd, N, dtype=bf16, s=Kd ** -.5)
        b = randn(N, s=0.1)
        kw = dict(relu=relu, out_dtype=odt)
        if relu:
            kw.update(mask=keep(M, N), inv_keep=inv)
        case("gemm_bias_act", f"large {label}",
             lambda: (K.gemm_bias_act(x, w, b, **kw),),
             lambda: (K.gemm_bias_act_plain(x, w, b, **kw),),
             (T16 if odt == bf16 else T32,), 0, 0, 0, timed=False)
    # the backward products of one B=64 step (two micro-batches, six
    # blocks each), timed under L with the torch.mm yardstick
    for name in ("gemm_dx", "gemm_dw"):
        rows.row(f"{name}, MCAN-large", SRC + "gemm_sm90.cu",
                 f"{TPU_TRAIN}:" + ("599" if name == "gemm_dx" else "382"),
                 LARGE_STEP)
    for label, Kd, N, has_gate, has_res, odt in (
            ("da1, ReLU/h1 gate", D, F, True, False, (f32, bf16)),
            ("gv2 = da1 W1^T + gr3 -> bf16", F, D, False, True, (bf16,)),
            ("datt2 = dy2 Wm2^T", D, D, False, False, (bf16,)),
            ("gv1 = dqx Wq2^T + gr2", D, D, False, True, (f32,)),
            ("datt1 = dy1 Wm1^T", D, D, False, False, (bf16,)),
            ("dx = dqkv Wqkv^T + gr1", 3 * D, D, False, True, (f32,))):
        say(f"  gemm_dx large {label}: {plan_note(K, 1, M, N, Kd)}")
        dy = randn(M, Kd, dtype=bf16)
        w = randn(N, Kd, dtype=bf16, s=Kd ** -0.5)
        kw = dict(gate=torch.relu(randn(M, N)).to(bf16) if has_gate else
                  None, inv_keep=inv, res=randn(M, N) if has_res else None,
                  out_dtypes=odt)
        case("gemm_dx, MCAN-large", label, lambda: K.gemm_dx(dy, w, **kw),
             lambda: K.gemm_dx_plain(dy, w, **kw),
             tuple(T32 if o == f32 else T16 for o in odt), n,
             2 * M * Kd * N,
             gemm_bytes(M, Kd, N, gate=has_gate, res=has_res,
                        out=tuple(o.itemsize for o in odt)),
             lambda: torch.mm(dy, w.t()))
    for label, m, n_, k in (("dWqkv", D, 3 * D, n), ("dW1", D, F, n),
                            ("dW2", F, D, n), ("dWm1, dWq2, dWm2", D, D,
                                               3 * n)):
        say(f"  gemm_dw large {label}: {plan_note(K, 2, m, n_, M)}")
        xr = randn(M, m, dtype=bf16)
        dy = randn(M, n_, dtype=bf16, s=M ** -0.5)
        case("gemm_dw, MCAN-large", f"{label} [{m}x{M}]x[{M}x{n_}]",
             lambda: (K.gemm_dw(xr, dy),), lambda: (K.gemm_dw_plain(xr, dy),),
             (T32,), k, 2 * M * m * n_, gemm_bytes(m, M, n_, out=(4,)),
             lambda: torch.mm(xr.t(), dy))
        again = K.gemm_dw(xr, dy)
        if not torch.equal(again, K.gemm_dw(xr, dy)):
            fail(f"gemm_dw large {label}: two runs differ")
    # attention at 128-wide heads: the forward and the att-saves
    # backward's recompute (2 + 2 per block), the backward (2 per block)
    qkv = randn(M, 3 * D, dtype=bf16)
    sq, sk, sv = [t.view(B, Lv, H, Dh).transpose(1, 2)
                  for t in qkv.view(B, Lv, 3 * D).split(D, dim=-1)]
    cq = randn(M, D, dtype=bf16).view(B, Lv, H, Dh).transpose(1, 2)
    ck, cv = randn(B, H, Lq, Dh), randn(B, H, Lq, Dh)
    vmask = pad_mask(torch, B, Lv, [(i * 17) % (Lv + 1) for i in range(B)],
                     dev)
    qmask = pad_mask(torch, B, Lq, [(i * 5) % (Lq + 1) for i in range(B)],
                     dev)
    dout = randn(B, Lv, D, dtype=bf16)
    for label, (q, k, v), mask, copies in (
            ("self 60x60", (sq, sk, sv), vmask, "qkv"),
            ("cross 60x14 f32 kv", (cq, ck, cv), qmask, "q")):
        Lk = k.shape[2]
        drop = keep(B, H, Lv, Lk)
        k16, v16 = k.to(bf16), v.to(bf16)
        attention_plan_note(K, f"Dh 128 {label}", q, k)
        case("masked_attention_dh128", f"{label} + dropout",
             lambda: (K.masked_attention(q, k, v, mask, drop, inv),),
             lambda: (K.masked_attention_plain(q, k, v, mask, drop, inv),),
             (T16,), 2 * n, 4 * B * H * Lv * Lk * Dh,
             attention_bytes(B, H, Lv, Lk, k.element_size(), drop=True,
                             Dh=Dh),
             lambda: F_.scaled_dot_product_attention(q, k16, v16,
                                                     attn_mask=~mask))

        attention_bwd_plan_note(K, f"Dh 128 {label}", q, k)

        def grads(fn, q=q, k=k, v=v, mask=mask, drop=drop, copies=copies,
                  Lk=Lk):
            outs = [torch.empty(B, H, L_, Dh, device=dev)
                    for L_ in (Lv, Lk, Lk)]
            c16 = [torch.empty(t.shape, dtype=bf16, device=dev)
                   if c in copies else None for t, c in zip(outs, "qkv")]
            fn(q, k, v, mask, dout, *outs, *c16, drop=drop, inv_keep=inv)
            return tuple(outs)

        d4 = dout.view(B, Lv, H, Dh).transpose(1, 2)
        outs = grads(K.masked_attention_bwd)
        refs = grads(K.masked_attention_bwd_plain)
        torch.cuda.synchronize()
        for name_, o, r in zip(("dq", "dk", "dv"), outs, refs):
            err = max_err(o, r)
            gate(f"masked_attention_bwd_dh128 {label} {name_}", err,
                 kc.scaled(r, 2 ** -7))
            rows.err("masked_attention_bwd_dh128", err)
        t_k = device_ms(torch, lambda: grads(K.masked_attention_bwd))
        t_p = device_ms(torch, lambda: grads(K.masked_attention_bwd_plain))
        # SDPA's backward: one autograd call, graphed as the kernel
        t_l = sdpa_backward_ms(torch, q, k, v, mask, d4)
        if t_l is None:
            rows.unmeasured("masked_attention_bwd_dh128")
        flops = 10 * B * H * Lv * Lk * Dh
        nbytes = attention_bwd_bytes(B, H, Lv, Lk, k.element_size(), copies,
                                     Dh=Dh)
        say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms, sdpa backward "
            f"{t_l} ms; bound "
            f"{max(bound_parts(flops, nbytes)):.4f} ms")
        rows.add("masked_attention_bwd_dh128", n, t_k, t_p, flops, nbytes,
                 t_l)
    # the LayerNorms with bf16 saves: LN1 / LN2 / LN3 write r bf16; their
    # backwards read it (no y), LN2's with the bf16 gv2
    res, y = randn(M, D), randn(M, D)
    bias, gamma, beta = randn(D, s=0.1), 1 + randn(D, s=0.1), randn(D, s=0.1)
    kw = dict(mask=keep(M, D), inv_keep=inv, save_r=True, reciprocal=True,
              r_dtype=bf16)
    case("residual_layernorm", "large LN + dropout -> f32, bf16, r bf16",
         lambda: K.residual_layernorm(res, y, bias, gamma, beta, (f32, bf16),
                                      **kw),
         lambda: K.residual_layernorm_plain(res, y, bias, gamma, beta,
                                            (f32, bf16), **kw),
         (1e-5, T16, T16), 0, 0, 0, timed=False)
    r16 = randn(M, D, dtype=bf16)
    for label, gdt in (("LN1 / LN3 from bf16 r", f32),
                       ("LN2 from bf16 r, bf16 gv2", bf16)):
        gout = randn(M, D, dtype=gdt)
        kw = dict(mask=keep(M, D), inv_keep=inv, dy_dtypes=(f32, bf16))
        case("residual_layernorm_bwd", f"large {label}",
             lambda: K.residual_layernorm_bwd(gout, r16, None, None, gamma,
                                              **kw),
             lambda: K.residual_layernorm_bwd_plain(gout, r16, None, None,
                                                    gamma, **kw),
             (1e-4, 1e-5, 1e-4, T16), 0, 0, 0, timed=False)
    mats = [randn(M, 3 * D), randn(M, D), randn(M, D), randn(M, D, dtype=bf16)]
    case("col_sum", "large dbq2, dbm2, dln2 (bf16 gv2)", lambda: K.col_sum(mats),
         lambda: K.col_sum_plain(mats), (1e-5,) * 4, 0, 0, 0, timed=False)



# ---------------------------------------------------------------------------
# the model: full MCAN-small width, seeded random weights
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase: the int8 serving kernels against their plain versions
# ---------------------------------------------------------------------------

def check_int8_kernels(torch, dev, rows) -> None:
    """quantize_rows and gemm_s8 at every int8 site of one B=64 forward of
    MCAN-small at level 1 (the FFN, dynamic scales) and level 3 (every
    projection, static scales), and of MCAN-large at level 1 (the FFN and
    the qkv, D = 1024); the f32-output attention at the level-3 merge
    inputs. Both int8 kernels must equal their plain versions bit for bit:
    the int32 sums are exact and every other step is one correctly rounded
    operation in the same order."""
    from mcan_vqa_tpu_torch.cli.bench_gemm import int_mm_call
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.quant import _quant_w
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    bf16, f32 = torch.bfloat16, torch.float32
    rows.row("quantize_rows", SRC + "quantize.cu", f"{TPU_QUANT}:245",
             SERVE_INT8)
    rows.row("gemm_s8", SRC + "gemm_sm90.cu", f"{TPU_QUANT}:253",
             SERVE_INT8)
    rows.row("masked_attention_f32", SRC + "masked_attention.cu",
             f"{TPU_QUANT}:1139", SERVE_INT8)
    say("[kernels] the int8 kernels vs their plain versions at every int8 "
        "site of one B=64 forward (times: the launches of one level-1 and "
        "one level-3 MCAN-small forward; bound at 1,979 TOP/s int8)")
    Mq, Mv = BATCH * 14, BATCH * 60
    # (label, M, K, N, input dtype, static, relu, out dtype, launches per
    # unit); the qkv site reads the bf16 stream, the others f32
    sites = []
    for M, blk in ((Mq, "enc"), (Mv, "dec")):
        sites += [(f"small L1 {blk} w1", M, 512, 2048, f32, False, True,
                   f32, 6),
                  (f"small L1 {blk} w2", M, 2048, 512, f32, False, False,
                   f32, 6),
                  (f"small L3 {blk} qkv", M, 512, 1536, bf16, True, False,
                   bf16, 6),
                  (f"small L3 {blk} merge", M, 512, 512, f32, True, False,
                   f32, 6 if blk == "enc" else 12),
                  (f"small L3 {blk} w1", M, 512, 2048, f32, True, True, f32,
                   6),
                  (f"small L3 {blk} w2", M, 2048, 512, f32, True, False,
                   f32, 6)]
    sites.append(("small L3 dec cross q", Mv, 512, 512, f32, True, False,
                  bf16, 6))
    for M, blk in ((Mq, "enc"), (Mv, "dec")):
        sites += [(f"large L1 {blk} qkv", M, 1024, 3072, bf16, False, False,
                   bf16, 0),
                  (f"large L1 {blk} w1", M, 1024, 4096, f32, False, True,
                   f32, 0),
                  (f"large L1 {blk} w2", M, 4096, 1024, f32, False, False,
                   f32, 0)]
    # the edges: ragged M, one row, and the q8aux / full-int8 sites whose
    # N is no multiple of 8 (the answer head, N 3129, an f32 row not
    # 16-byte aligned; the one-glimpse AttFlat logit, N 1), unpadded
    sites += [("ragged M=61", 61, 512, 2048, f32, False, True, f32, 0),
              ("M=1 static", 1, 2048, 512, bf16, True, False, f32, 0),
              ("head N=3129 static", BATCH, 1024, 3129, f32, True, False,
               f32, 0),
              ("head N=3129 dynamic -> bf16", 61, 1024, 3129, f32, False,
               False, bf16, 0),
              ("attflat logit N=1", Mv, 512, 1, f32, False, False, f32, 0)]
    for label, M, Kd, N, xdt, static, relu, odt, per in sites:
        x = torch.randn(M, Kd, generator=g, device=dev)
        if Kd in (2048, 4096):        # a w2 site reads the ReLU output h1
            x = x.abs()
        x = x.to(xdt)
        if M > 1:
            x[0] = 0.0                # a zero row: scale 1, codes 0
        w = torch.randn(Kd, N, generator=g, device=dev) / Kd ** 0.5
        qw = _quant_w(w.to(bf16))
        wq, sw = qw["w_q"], qw["w_scale"]       # stored K-major
        bias = torch.randn(N, generator=g, device=dev) * 0.1
        a = float(x.float().abs().max()) / 127.0 * 1.1 if static else None
        inv = None if a is None else 1.0 / a
        q, s = K.quantize_rows(x, inv)
        rq, rs = K.quantize_rows_plain(x, inv)
        scale_kw = dict(a=a) if static else dict(sx=s)
        out = K.gemm_s8(q, wq, sw, bias, relu=relu, out_dtypes=(odt,),
                        **scale_kw)[0]
        ref = K.gemm_s8_plain(q, wq, sw, bias, relu=relu, out_dtypes=(odt,),
                              **scale_kw)[0]
        torch.cuda.synchronize()
        e_q = max_err(q, rq) + (0.0 if s is None else max_err(s, rs))
        gate(f"quantize_rows {label} [{M}x{Kd}] {str(xdt)[6:]} "
             f"{'static' if static else 'dynamic'} (bit for bit)", e_q, 0.0)
        rows.err("quantize_rows", e_q)
        e_g = max_err(out, ref)
        say(f"    [plan] gemm_s8 {label}: {plan_note(K, 4, M, N, Kd)}")
        gate(f"gemm_s8 {label} [{M}x{Kd}]x[{Kd}x{N}] -> {str(odt)[6:]} "
             f"(bit for bit)", e_g, 0.0)
        rows.err("gemm_s8", e_g)
        if not per and not label.startswith("large"):
            continue
        t_q = device_ms(torch, lambda: K.quantize_rows(x, inv))
        t_qp = device_ms(torch, lambda: K.quantize_rows_plain(x, inv))
        t_g = device_ms(torch, lambda: K.gemm_s8(
            q, wq, sw, bias, relu=relu, out_dtypes=(odt,), **scale_kw))
        t_gp = device_ms(torch, lambda: K.gemm_s8_plain(
            q, wq, sw, bias, relu=relu, out_dtypes=(odt,), **scale_kw))
        lib = int_mm_call(torch, q, wq)
        t_l = device_ms(torch, lib) if lib is not None else None
        q_bytes = M * Kd * (x.element_size() + 1) + (0 if static else 4 * M)
        g_bytes = (M * Kd + Kd * N + 8 * N + (0 if static else 4 * M)
                   + M * N * (4 if odt == f32 else 2))
        op_q, by_q = bound_parts(3 * M * Kd, q_bytes, tensor=False)
        op_g, by_g = bound_parts(0.0, g_bytes, int8_ops=2 * M * Kd * N)
        say(f"    quantize_rows {t_q:.4f} ms vs plain {t_qp:.4f} ms, bound "
            f"{max(op_q, by_q):.4f} ms; gemm_s8 {t_g:.4f} ms vs plain "
            f"{t_gp:.4f} ms, _int_mm "
            + (f"{t_l:.4f} ms" if t_l is not None else "refused")
            + f", bound {max(op_g, by_g):.4f} ms "
            f"({2 * M * Kd * N / t_g / 1e9:.1f} TOP/s)")
        if per:
            rows.add("quantize_rows", per, t_q, t_qp, 3 * M * Kd, q_bytes,
                     tensor=False)
            rows.add("gemm_s8", per, t_g, t_gp, 0.0, g_bytes, t_l,
                     int8_ops=2 * M * Kd * N)

    # --- the f32-output attention at the level-3 merge inputs
    F_ = torch.nn.functional
    D, H = 512, 8
    lens_q = [(i * 5) % 15 for i in range(BATCH)]        # includes all PAD
    lens_v = [(i * 17) % 61 for i in range(BATCH)]

    def heads(B, L):
        return torch.randn(B, H, L, D // H, generator=g, device=dev)

    cases = [("enc self 14x14", heads(BATCH, 14).to(bf16),
              heads(BATCH, 14).to(bf16), heads(BATCH, 14).to(bf16),
              pad_mask(torch, BATCH, 14, lens_q, dev)),
             ("dec self 60x60", heads(BATCH, 60).to(bf16),
              heads(BATCH, 60).to(bf16), heads(BATCH, 60).to(bf16),
              pad_mask(torch, BATCH, 60, lens_v, dev)),
             ("dec cross 60x14 f32 kv", heads(BATCH, 60).to(bf16),
              heads(BATCH, 14), heads(BATCH, 14),
              pad_mask(torch, BATCH, 14, lens_q, dev))]
    for name, q, k, v, mask in cases:
        attention_plan_note(K, f"f32 out {name}", q, k)
        out = K.masked_attention(q, k, v, mask, out_dtype=f32)
        ref = K.masked_attention_plain(q, k, v, mask, out_dtype=f32)
        same = K.masked_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # the bf16 probabilities: one may land a rounding step apart
        gate(f"masked_attention f32 out {name}", err,
             8e-3 * (float(ref.abs().max()) + 1e-6))
        if not torch.equal(out.to(bf16), same):
            fail(f"masked_attention {name}: the f32 output rounded to bf16 "
                 f"is not the bf16 output")
        rows.err("masked_attention_f32", err)
        B, _, L1, _ = q.shape
        L2 = k.shape[2]
        k16, v16 = k.to(bf16), v.to(bf16)
        t_k = device_ms(torch, lambda: K.masked_attention(
            q, k, v, mask, out_dtype=f32))
        t_p = device_ms(torch, lambda: K.masked_attention_plain(
            q, k, v, mask, out_dtype=f32))
        t_l = device_ms(torch, lambda: F_.scaled_dot_product_attention(
            q, k16, v16, attn_mask=~mask))
        nbytes = attention_bytes(B, H, L1, L2, k.element_size()) \
            + 2 * B * L1 * H * 64
        say(f"    time {t_k:.4f} ms vs plain {t_p:.4f} ms, sdpa {t_l:.4f} ms")
        rows.add("masked_attention_f32", 6, t_k, t_p,
                 4 * B * H * L1 * L2 * 64, nbytes, t_l)


QUESTIONS = ["what color is the cat", "how many people are in the picture",
             "is this a kitchen", "what is on the table",
             "what sport is being played", "is the man wearing a hat"]


def build_model(torch):
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data import build_vocab, load_answer_dict
    from mcan_vqa_tpu_torch.models.net import MCANet
    cfg = Config()
    vocab, emb = build_vocab(QUESTIONS)
    _, ix_to_ans = load_answer_dict()
    g = torch.Generator().manual_seed(SEED)
    net = MCANet(cfg, len(vocab), len(ix_to_ans), pretrained_emb=emb,
                 generator=g)
    say(f"[model] MCAN-small: hidden {cfg.hidden_size}, {cfg.layer}+"
        f"{cfg.layer} layers, {cfg.multi_head} heads, ff {cfg.ff_size}, "
        f"{len(ix_to_ans)} answers, vocab {len(vocab)}, "
        f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f} M params")
    return net.state_dict(), cfg, vocab, ix_to_ans


def block_flops(M, D, F, B, H, Lv, Lq, cross):
    """Operations of one serving block: qkv, merge, FFN, attention (and
    for the SGA block the cross q, its merge and the cross attention)."""
    f = 2 * M * D * 3 * D + 2 * M * D * D + 4 * M * D * F \
        + 4 * B * H * Lv * Lv * 64
    if cross:
        f += 4 * M * D * D + 4 * B * H * Lv * Lq * 64
    return f


def weight_bytes(D, F, cross):
    """bf16 matrices and f32 vectors of one block."""
    mats = 3 * D * D + D * D + 2 * D * F + (2 * D * D if cross else 0)
    vecs = 3 * D + D + F + D + 4 * D + (2 * D + 2 * D if cross else 0)
    return 2 * mats + 4 * vecs


# ---------------------------------------------------------------------------
# phase: both serving block wrappers against their plain versions
# ---------------------------------------------------------------------------

def check_blocks(torch, dev, state_dict, cfg, rows) -> None:
    from mcan_vqa_tpu_torch.ops import sga_block
    from mcan_vqa_tpu_torch.ops.serving import _cross_kv, prepare_params
    prepared = prepare_params(state_dict, cfg.layer, device=dev)
    bb = prepared["backbone"]
    H, D, F = cfg.multi_head, cfg.hidden_size, cfg.ff_size
    Lq, Lv = cfg.max_token, cfg.img_feat_pad_size
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows.row("fused_sa_block", "mcan_vqa_tpu_torch/ops/sga_block.py",
             f"{TPU}:967", SERVE)
    rows.row("fused_sga_block", "mcan_vqa_tpu_torch/ops/sga_block.py",
             f"{TPU}:239", SERVE)
    # Block tolerance: both sides run the same steps at the same precision;
    # the kernels sum in another order, which can move a bf16 rounding of
    # qkv / h1 / the output by one step (2^-8 relative, on values of LN
    # scale ~1-4), and that carries through the rest of the block.
    tol = 6e-2
    say("[blocks] fused_sa_block / fused_sga_block vs their plain versions "
        f"(tol {tol})")
    for B, lq, lv in ((BATCH, [(i * 5) % (Lq + 1) for i in range(BATCH)],
                       [(i * 17) % (Lv + 1) for i in range(BATCH)]),
                      (5, [14, 0, 7, 14, 3], [60, 41, 0, 12, 60])):
        q_mask = pad_mask(torch, B, Lq, lq, dev)
        v_mask = pad_mask(torch, B, Lv, lv, dev)
        x = torch.randn(B, Lq, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Lv, D, generator=g, device=dev).to(torch.bfloat16)
        wp_e, wp_d = bb["enc_0"]["_mk"], bb["dec_0"]["_mk"]
        out = sga_block.fused_sa_block(x, q_mask, wp_e, num_heads=H)
        ref = sga_block.fused_sa_block_plain(x, q_mask, wp_e, num_heads=H)
        torch.cuda.synchronize()
        e_sa = max_err(out, ref)
        gate(f"fused_sa_block B={B}", e_sa, tol)
        rows.err("fused_sa_block", e_sa)
        kq, vq = _cross_kv(bb["dec_0"]["mhatt2"], x, H)
        out = sga_block.fused_sga_block(v, kq, vq, v_mask, q_mask, wp_d,
                                        num_heads=H)
        ref = sga_block.fused_sga_block_plain(v, kq, vq, v_mask, q_mask, wp_d,
                                              num_heads=H)
        torch.cuda.synchronize()
        e_sga = max_err(out, ref)
        gate(f"fused_sga_block B={B}", e_sga, tol)
        rows.err("fused_sga_block", e_sga)
        if B != BATCH:
            continue
        t = [device_ms(torch, lambda: sga_block.fused_sa_block(
                 x, q_mask, wp_e, num_heads=H)),
             device_ms(torch, lambda: sga_block.fused_sa_block_plain(
                 x, q_mask, wp_e, num_heads=H)),
             device_ms(torch, lambda: sga_block.fused_sga_block(
                 v, kq, vq, v_mask, q_mask, wp_d, num_heads=H)),
             device_ms(torch, lambda: sga_block.fused_sga_block_plain(
                 v, kq, vq, v_mask, q_mask, wp_d, num_heads=H))]
        say(f"    B={B} per block: SA {t[0]:.4f} ms vs plain {t[1]:.4f}"
            f" ms; SGA {t[2]:.4f} ms vs plain {t[3]:.4f} ms")
        Mq, Mv = B * Lq, B * Lv
        # in: the bf16 stream, the pads (and the f32 cross k/v), the
        # weights; out: the bf16 stream
        rows.add("fused_sa_block", cfg.layer, t[0], t[1],
                 block_flops(Mq, D, F, B, H, Lq, Lq, False),
                 4 * Mq * D + B * Lq + weight_bytes(D, F, False))
        rows.add("fused_sga_block", cfg.layer, t[2], t[3],
                 block_flops(Mv, D, F, B, H, Lv, Lq, True),
                 4 * Mv * D + B * (Lv + Lq) + 8 * B * H * Lq * 64
                 + weight_bytes(D, F, True))


# ---------------------------------------------------------------------------
# phase: both int8 serving blocks against their plain versions
# ---------------------------------------------------------------------------

def qffn_block_work(B, L, Lq, D, F, H, cross, level):
    """(bf16 operations, int8 operations, bytes) of one quantized serving
    block at qffn level 1-7, or the full-int8 block (level 8 here): the
    stream in and out (bf16; f32 for the full-int8 block), the pads, the
    cross k/v (f32), the weights (int8, int4 packed with f32 group scales,
    or bf16) and the f32 vectors (biases, LN, scales)."""
    M, Dh = B * L, D // H
    n_proj = 3 if cross else 1             # the merges and the cross q
    w4 = {4: 1, 5: 2, 6: 1, 7: 2}.get(level, 0)
    dq = level in (6, 7)
    qkv8, proj8 = level >= 2 or D >= 1024, level >= 3
    att = 4 * B * H * L * L * Dh + (4 * B * H * L * Lq * Dh if cross else 0)
    qkv, proj, ffn = 2 * M * D * 3 * D, 2 * M * D * D * n_proj, 4 * M * D * F
    int8 = bf16 = wbytes = 0
    for ops, mats, how in (
            (ffn, ((D, F), (F, D)), "int4" if w4 else "int8"),
            (qkv, ((D, 3 * D),), "int4" if w4 == 2 else
             "int8" if qkv8 else "bf16"),
            (proj, ((D, D),) * n_proj, "int8" if proj8 else "bf16")):
        for k, n in mats:
            wbytes += {"int4": k * n // 2 + 4 * (k // 128) * n,
                       "int8": k * n + 4 * n, "bf16": 2 * k * n}[how]
        if how == "bf16" or (how == "int4" and dq):
            bf16 += ops
        else:
            int8 += ops
    # biases and LayerNorm
    vecs = 4 * (3 * D + F + D + D * n_proj + 2 * D * (3 if cross else 2))
    stream = 8 if level == 8 else 4
    nbytes = (stream * M * D + B * (L + (Lq if cross else 0))
              + (8 * B * H * Lq * Dh if cross else 0) + wbytes + vecs)
    return bf16 + att, int8, nbytes


def random_block(torch, g, dev, D, F, sga):
    """A block's bf16 layout (ops/sga_block.py names) with random weights
    of std 1/sqrt(fan-in), for a width no model of this script has."""
    def mat(k, n):
        return (torch.randn(k, n, generator=g, device=dev)
                / k ** 0.5).to(torch.bfloat16)

    def vec(n, base=0.0):
        return base + 0.1 * torch.randn(n, generator=g, device=dev)

    one = "1" if sga else ""
    wp = {f"wqkv{one}": mat(D, 3 * D), f"bqkv{one}": vec(3 * D),
          "w1": mat(D, F), "b1": vec(F), "w2": mat(F, D), "b2": vec(D)}
    if sga:
        wp.update(wm1_full=mat(D, D), bm1=vec(D), wq2_full=mat(D, D),
                  bq2_full=vec(D), wm2_full=mat(D, D), bm2=vec(D))
    else:
        wp.update(wm=mat(D, D), bm=vec(D))
    for i in range(1, 4 if sga else 3):
        wp[f"ln{i}_s"], wp[f"ln{i}_b"] = vec(D, 1.0), vec(D)
    return wp


def check_int8_blocks(torch, dev, state_dict, cfg, rows) -> None:
    """fused_qffn_sa_block / fused_qffn_sga_block against their plain
    versions at B=64 with fully padded samples: MCAN-small at level 1
    (dynamic) and level 3 (static scales from the port's calibration
    replay of these inputs), MCAN-large at level 1 (D = 1024, heads of
    128, int8 FFN and qkv)."""
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import (_cross_kv, decode_qffn_level,
                                                prepare_params)
    bf16 = torch.bfloat16
    H, D, F = cfg.multi_head, cfg.hidden_size, cfg.ff_size
    Lq, Lv, B = cfg.max_token, cfg.img_feat_pad_size, BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    rows.row("fused_qffn_sa_block", "mcan_vqa_tpu_torch/ops/quant.py",
             f"{TPU_QUANT}:1184", SERVE_INT8)
    rows.row("fused_qffn_sga_block", "mcan_vqa_tpu_torch/ops/quant.py",
             f"{TPU_QUANT}:1057", SERVE_INT8)
    # Block tolerance: that of the bf16 blocks (sums in another order move
    # a bf16 rounding one step, carried through the block), plus int8
    # codes whose f32 input sits on a rounding boundary, each moving one
    # product term by s_x * |w|: 6e-2
    tol = 6e-2
    say("[blocks] fused_qffn_sa_block / fused_qffn_sga_block vs their plain "
        f"versions, B={B}, fully padded samples (tol {tol})")
    q_mask = pad_mask(torch, B, Lq, [(i * 5) % (Lq + 1) for i in range(B)],
                      dev)
    v_mask = pad_mask(torch, B, Lv, [(i * 17) % (Lv + 1) for i in range(B)],
                      dev)

    def stream(L, width):
        return torch.randn(B, L, width, generator=g, device=dev).to(bf16)

    def run(label, sa, sga, n_rows, work_sa, work_sga):
        for name, (kern, plain) in (("fused_qffn_sa_block", sa),
                                    ("fused_qffn_sga_block", sga)):
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max_err(out, ref)
            gate(f"{name} {label} B={B}", err, tol)
            rows.err(name, err)
        t = [device_ms(torch, f, iters=10) for f in (*sa, *sga)]
        say(f"    {label} per block: SA {t[0]:.4f} ms vs plain {t[1]:.4f} "
            f"ms, bound {max(bound_parts(work_sa[0], work_sa[2], True, work_sa[1])):.4f}"
            f" ms; SGA {t[2]:.4f} ms vs plain {t[3]:.4f} ms, bound "
            f"{max(bound_parts(work_sga[0], work_sga[2], True, work_sga[1])):.4f} ms")
        if n_rows:
            rows.add("fused_qffn_sa_block", n_rows, t[0], t[1], work_sa[0],
                     work_sa[2], int8_ops=work_sa[1])
            rows.add("fused_qffn_sga_block", n_rows, t[2], t[3], work_sga[0],
                     work_sga[2], int8_ops=work_sga[1])

    x, v = stream(Lq, D), stream(Lv, D)
    for level in (1, 3):
        bb = prepare_params(state_dict, cfg.layer, device=dev,
                            qffn=level)["backbone"]
        enc, dec = bb["enc_0"], bb["dec_0"]
        kq, vq = _cross_kv(dec["mhatt2"], x, H)
        sc_sa = sc_sga = None
        if level == 3:
            sc_sa = tuple(float(a) for a in quant._cal_sa_block(
                enc, x, q_mask, H, 1.1)[1])
            sc_sga = tuple(float(a) for a in quant._cal_sga_block(
                dec, v, x, v_mask, q_mask, H, 1.1)[1])
        sa = (lambda: quant.fused_qffn_sa_block(
                  x, q_mask, enc["_mk"], enc["_qffn"], num_heads=H,
                  act_scales=sc_sa),
              lambda: quant.fused_qffn_sa_block_plain(
                  x, q_mask, enc["_mk"], enc["_qffn"], num_heads=H,
                  act_scales=sc_sa))
        sga = (lambda: quant.fused_qffn_sga_block(
                   v, kq, vq, v_mask, q_mask, dec["_mk"], dec["_qffn"],
                   num_heads=H, act_scales=sc_sga),
               lambda: quant.fused_qffn_sga_block_plain(
                   v, kq, vq, v_mask, q_mask, dec["_mk"], dec["_qffn"],
                   num_heads=H, act_scales=sc_sga))
        run(f"MCAN-small level {level}", sa, sga, cfg.layer,
            qffn_block_work(B, Lq, Lq, D, F, H, False, level),
            qffn_block_work(B, Lv, Lq, D, F, H, True, level))

    # MCAN-large level 1: random weights at its widths
    D2, F2 = 1024, 4096
    qkv8, proj8, _ = decode_qffn_level(1, D2)
    wp_sa, wp_sga = (random_block(torch, g, dev, D2, F2, sga)
                     for sga in (False, True))
    qf_sa = quant.prepare_qffn_params(wp_sa, qkv8, proj8)
    qf_sga = quant.prepare_qffn_params(wp_sga, qkv8, proj8)
    x2, v2 = stream(Lq, D2), stream(Lv, D2)
    kq2 = torch.randn(B, H, Lq, D2 // H, generator=g, device=dev)
    vq2 = torch.randn(B, H, Lq, D2 // H, generator=g, device=dev)
    run("MCAN-large level 1",
        (lambda: quant.fused_qffn_sa_block(x2, q_mask, wp_sa, qf_sa,
                                           num_heads=H),
         lambda: quant.fused_qffn_sa_block_plain(x2, q_mask, wp_sa, qf_sa,
                                                 num_heads=H)),
        (lambda: quant.fused_qffn_sga_block(v2, kq2, vq2, v_mask, q_mask,
                                            wp_sga, qf_sga, num_heads=H),
         lambda: quant.fused_qffn_sga_block_plain(v2, kq2, vq2, v_mask,
                                                  q_mask, wp_sga, qf_sga,
                                                  num_heads=H)),
        0, qffn_block_work(B, Lq, Lq, D2, F2, H, False, 1),
        qffn_block_work(B, Lv, Lq, D2, F2, H, True, 1))


# ---------------------------------------------------------------------------
# phase: the int4 GEMMs against their plain versions
# ---------------------------------------------------------------------------

def w4_bytes(M, Kd, N, a_size, out_size, bias=True):
    """Bytes of one int4 product: the activations (int8 codes or bf16), the
    packed weight, its group scales, the bias and the output."""
    return (a_size * M * Kd + Kd * N // 2 + 4 * (Kd // 128) * N
            + 4 * N * bias + out_size * M * N)


def check_int4_kernels(torch, dev, rows) -> None:
    """gemm_s4 bit for bit against its plain version at every level-5 site
    (the qkv, w1 and w2 of MCAN-small and MCAN-large) at M = 14, 60, 896
    and 3840 (the SA and SGA blocks at B = 1 and 64), with and without
    ReLU / bias; gemm_w4bf16 at the same sites within gemm_bias_act's
    tolerance; each site's plan. Times of the MCAN-small sites at B = 1 and
    B = 64 beside gemm_s8 on the int8 weight and gemm_bias_act on the
    dequantized bf16 weight of the same site (the port's own kernels, no
    library calls): no single PyTorch call computes a grouped int4 product
    (library none)."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.quant import _quant_w, _quant_w4
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    bf16, f32 = torch.bfloat16, torch.float32
    rows.row("gemm_s4", SRC + "gemm_int4.cu", f"{TPU_QUANT}:282", SERVE_W4)
    rows.row("gemm_w4bf16", SRC + "gemm_int4.cu", f"{TPU_QUANT}:307",
             SERVE_W7)
    say("[int4 kernels] gemm_s4 (bit for bit) and gemm_w4bf16 vs their "
        "plain versions at every level-5 site, M = 14 / 60 (B=1) and 896 / "
        "3840 (B=64); times: the launches of one B=1 and one B=64 forward "
        "(level 5 / level 7), library none")
    for model, D, F in (("small", 512, 2048), ("large", 1024, 4096)):
        for site, Kd, N, relu, odt in (("qkv", D, 3 * D, False, bf16),
                                       ("w1", D, F, True, f32),
                                       ("w2", F, D, False, f32)):
            w = torch.randn(Kd, N, generator=g, device=dev) / Kd ** 0.5
            q4 = _quant_w4(w.to(bf16))
            wp, s4 = q4["w_p"], q4["w_gscale"]
            bias = torch.randn(N, generator=g, device=dev) * 0.1
            for M in (14, 60, 896, 3840):
                x = torch.randn(M, Kd, generator=g, device=dev)
                if site == "w2":
                    x = x.abs()               # w2 reads the ReLU output
                b = None if (M == 60 and site != "w2") else bias
                a = float(x.abs().max()) / 127.0 * 1.1
                xq, _ = K.quantize_rows(x, 1.0 / a)
                out = K.gemm_s4(xq, wp, s4, b, a=a, relu=relu,
                                out_dtypes=(odt,))[0]
                ref = K.gemm_s4_plain(xq, wp, s4, b, a=a, relu=relu,
                                      out_dtypes=(odt,))[0]
                xb = x.to(bf16)
                out7 = K.gemm_w4bf16(xb, wp, s4, b, relu=relu, out_dtype=odt)
                ref7 = K.gemm_w4bf16_plain(xb, wp, s4, b, relu=relu,
                                           out_dtype=odt)
                torch.cuda.synchronize()
                shape = (f"{model} {site} [{M}x{Kd}]x[{Kd}x{N}]"
                         f"{' relu' if relu else ''}"
                         f"{'' if b is not None else ' no bias'}")
                say(f"    [plan] {shape}: gemm_s4 "
                    f"{plan_note(K, K._S4, M, N, Kd)}; gemm_w4bf16 "
                    f"{plan_note(K, K._W4, M, N, Kd)}")
                e4 = max_err(out, ref)
                gate(f"gemm_s4 {shape} (bit for bit)", e4, 0.0)
                rows.err("gemm_s4", e4)
                # gemm_bias_act's tolerance: the same bf16 weight, exact
                # products, f32 sums in another order
                e7 = max_err(out7, ref7)
                scale = float(ref7.float().abs().max()) + 1e-6
                gate(f"gemm_w4bf16 {shape}", e7,
                     (1e-4 if odt == f32 else 8e-3) * scale)
                rows.err("gemm_w4bf16", e7)
                if model != "small":
                    continue
                osz = 4 if odt == f32 else 2
                t4 = device_ms(torch, lambda: K.gemm_s4(
                    xq, wp, s4, b, a=a, relu=relu, out_dtypes=(odt,)))
                t4p = device_ms(torch, lambda: K.gemm_s4_plain(
                    xq, wp, s4, b, a=a, relu=relu, out_dtypes=(odt,)),
                    iters=5)
                t7 = device_ms(torch, lambda: K.gemm_w4bf16(
                    xb, wp, s4, b, relu=relu, out_dtype=odt))
                t7p = device_ms(torch, lambda: K.gemm_w4bf16_plain(
                    xb, wp, s4, b, relu=relu, out_dtype=odt), iters=5)
                q8 = _quant_w(w.to(bf16))
                t8 = device_ms(torch, lambda: K.gemm_s8(
                    xq, q8["w_q"], q8["w_scale"], b, a=a, relu=relu,
                    out_dtypes=(odt,)))
                wf = K.dequant_w4(wp, s4)
                tnn = device_ms(torch, lambda: K.gemm_bias_act(
                    xb, wf, b, relu=relu, out_dtype=odt))
                by4 = w4_bytes(M, Kd, N, 1, osz, b is not None)
                by7 = w4_bytes(M, Kd, N, 2, osz, b is not None)
                w_only = (Kd * N // 2 + 4 * (Kd // 128) * N) / HBM * 1e3
                ops = 2 * M * Kd * N
                b4 = max(bound_parts(0.0, by4, int8_ops=ops))
                b7 = max(bound_parts(ops, by7))
                say(f"    gemm_s4 {t4:.4f} ms vs plain {t4p:.4f} ms, bound "
                    f"{b4:.4f} ms (the packed weight alone {w_only:.4f}); "
                    f"gemm_w4bf16 {t7:.4f} ms vs plain {t7p:.4f} ms, bound "
                    f"{b7:.4f} ms; gemm_s8 on the int8 weight {t8:.4f} ms, "
                    f"gemm_bias_act on the dequantized weight {tnn:.4f} ms")
                rows.add("gemm_s4", 6, t4, t4p, 0.0, by4, int8_ops=ops)
                rows.add("gemm_w4bf16", 6, t7, t7p, ops, by7)


# ---------------------------------------------------------------------------
# phase: the int4 qffn blocks and the full-int8 blocks
# ---------------------------------------------------------------------------

def quant_layout(wp, sga):
    """A block's bf16 layout (``random_block``) -> the full-int8 engine's
    ``_mk`` (``prepare_quant_sa_params`` / ``_sga_``): every projection
    int8 per output channel, f32 biases and LN."""
    from mcan_vqa_tpu_torch.ops.quant import _quant_w
    names = ((("qkv1", "wqkv1", "bqkv1"), ("m1", "wm1_full", "bm1"),
              ("q2", "wq2_full", "bq2_full"), ("m2", "wm2_full", "bm2"))
             if sga else (("qkv", "wqkv", "bqkv"), ("m", "wm", "bm")))
    mk = {k: v for k, v in wp.items() if k.startswith("ln")}
    for name, w, b in names + (("w1", "w1", "b1"), ("w2", "w2", "b2")):
        q = _quant_w(wp[w].float())
        mk[f"w_{name}"], mk[f"s_{name}"] = q["w_q"], q["w_scale"]
        mk[f"b_{name}"] = wp[b].float()
    return mk


def check_int4_blocks(torch, dev, state_dict, cfg, rows) -> None:
    """The qffn blocks at the int4 levels 4-7 (static scales from the
    port's calibration replay of these inputs) and the full-int8 blocks
    (f32 stream, every site dynamic) against their plain versions at B=64
    with fully padded samples, at MCAN-small; MCAN-large (D = 1024, heads
    of 128, random weights) once each: level 5 and the full-int8 blocks."""
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import (_cross_kv, _qdense, _split_kv,
                                                prepare_params,
                                                quantize_params)
    bf16 = torch.bfloat16
    H, D, F = cfg.multi_head, cfg.hidden_size, cfg.ff_size
    Lq, Lv, B = cfg.max_token, cfg.img_feat_pad_size, BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    tol = 6e-2          # that of the int8 blocks (check_int8_blocks)
    say("[int4 blocks] / [int8 blocks] fused_qffn_* at levels 4-7 and "
        f"fused_quant_* vs their plain versions, B={B}, fully padded "
        f"samples (tol {tol})")
    q_mask = pad_mask(torch, B, Lq, [(i * 5) % (Lq + 1) for i in range(B)],
                      dev)
    v_mask = pad_mask(torch, B, Lv, [(i * 17) % (Lv + 1) for i in range(B)],
                      dev)

    def stream(L, width, dtype=bf16):
        return torch.randn(B, L, width, generator=g, device=dev).to(dtype)

    def floats(scales):
        # Python floats, as a calibrated engine holds them: a 0-d tensor
        # would be read back on every call, which a graph capture refuses
        return tuple(float(a) for a in scales)

    def run(label, pairs, names, work):
        ts = []
        for name, (kern, plain) in zip(names, pairs):
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max_err(out, ref)
            gate(f"{name} {label} B={B}", err, tol)
            rows.err(name, err)
            if work is not None:
                ts.append((device_ms(torch, kern, iters=10),
                           device_ms(torch, plain, iters=3)))
        if work is None:
            return
        msg = []
        for name, (t_k, t_p), (fl, i8, nb) in zip(names, ts, work):
            rows.add(name, cfg.layer, t_k, t_p, fl, nb, int8_ops=i8)
            msg.append(f"{name} {t_k:.4f} ms vs plain {t_p:.4f} ms, bound "
                       f"{max(bound_parts(fl, nb, True, i8)):.4f} ms")
        say(f"    {label} per block: " + "; ".join(msg))

    x, v = stream(Lq, D), stream(Lv, D)
    for level in (4, 5, 6, 7):
        names = (f"fused_qffn_sa_block_level{level}",
                 f"fused_qffn_sga_block_level{level}")
        for name in names:
            rows.row(name, "mcan_vqa_tpu_torch/ops/quant.py",
                     f"{TPU_QUANT}:{1412 if '_sa_' in name else 1326}",
                     f"one B=64 level-{level} serving forward")
        bb = prepare_params(state_dict, cfg.layer, device=dev,
                            qffn=level)["backbone"]
        enc, dec = bb["enc_0"], bb["dec_0"]
        kq, vq = _cross_kv(dec["mhatt2"], x, H)
        dq = level >= 6
        sc_sa = floats(quant._cal_sa_block(enc, x, q_mask, H, 1.1, dq)[1])
        sc_sga = floats(quant._cal_sga_block(dec, v, x, v_mask, q_mask, H,
                                             1.1, dq)[1])
        run(f"MCAN-small level {level}", (
            (lambda: quant.fused_qffn_sa_block(
                x, q_mask, enc["_mk"], enc["_qffn"], num_heads=H,
                act_scales=sc_sa, w4dq=dq),
             lambda: quant.fused_qffn_sa_block_plain(
                 x, q_mask, enc["_mk"], enc["_qffn"], num_heads=H,
                 act_scales=sc_sa, w4dq=dq)),
            (lambda: quant.fused_qffn_sga_block(
                v, kq, vq, v_mask, q_mask, dec["_mk"], dec["_qffn"],
                num_heads=H, act_scales=sc_sga, w4dq=dq),
             lambda: quant.fused_qffn_sga_block_plain(
                 v, kq, vq, v_mask, q_mask, dec["_mk"], dec["_qffn"],
                 num_heads=H, act_scales=sc_sga, w4dq=dq))), names,
            (qffn_block_work(B, Lq, Lq, D, F, H, False, level),
             qffn_block_work(B, Lv, Lq, D, F, H, True, level)))

    names = ("fused_quant_sa_block", "fused_quant_sga_block")
    for name in names:
        rows.row(name, "mcan_vqa_tpu_torch/ops/quant.py",
                 f"{TPU_QUANT}:{599 if '_sa_' in name else 539}",
                 "one B=64 full-int8 serving forward")
    bb = quantize_params(state_dict, cfg.layer, device=dev)["backbone"]
    x32, v32 = stream(Lq, D, torch.float32), stream(Lv, D, torch.float32)
    mk_sa, dec = bb["enc_0"]["_mk"], bb["dec_0"]
    kq, vq = _split_kv(_qdense(dec["mhatt2"]["linear_kv"], x32), H)
    run("MCAN-small full int8", (
        (lambda: quant.fused_quant_sa_block(x32, q_mask, mk_sa, num_heads=H),
         lambda: quant.fused_quant_sa_block_plain(x32, q_mask, mk_sa,
                                                  num_heads=H)),
        (lambda: quant.fused_quant_sga_block(v32, kq, vq, v_mask, q_mask,
                                             dec["_mk"], num_heads=H),
         lambda: quant.fused_quant_sga_block_plain(
             v32, kq, vq, v_mask, q_mask, dec["_mk"], num_heads=H))), names,
        (qffn_block_work(B, Lq, Lq, D, F, H, False, 8),
         qffn_block_work(B, Lv, Lq, D, F, H, True, 8)))

    # MCAN-large: random weights at its widths, level 5 and full int8
    D2, F2 = 1024, 4096
    wp_sa, wp_sga = (random_block(torch, g, dev, D2, F2, sga)
                     for sga in (False, True))
    enc = {"_mk": wp_sa, "_qffn": quant.prepare_qffn_params(wp_sa, True,
                                                            True, 2)}
    kv = {"kernel": (torch.randn(D2, 2 * D2, generator=g, device=dev)
                     / D2 ** 0.5).to(bf16),
          "bias": 0.1 * torch.randn(2 * D2, generator=g, device=dev)}
    dec = {"_mk": wp_sga, "_qffn": quant.prepare_qffn_params(wp_sga, True,
                                                             True, 2),
           "mhatt2": {"linear_kv": kv}}
    x2, v2 = stream(Lq, D2), stream(Lv, D2)
    kq2, vq2 = _cross_kv(dec["mhatt2"], x2, H)
    sc_sa = floats(quant._cal_sa_block(enc, x2, q_mask, H, 1.1)[1])
    sc_sga = floats(quant._cal_sga_block(dec, v2, x2, v_mask, q_mask, H,
                                         1.1)[1])
    run("MCAN-large level 5", (
        (lambda: quant.fused_qffn_sa_block(x2, q_mask, wp_sa, enc["_qffn"],
                                           num_heads=H, act_scales=sc_sa),
         lambda: quant.fused_qffn_sa_block_plain(
             x2, q_mask, wp_sa, enc["_qffn"], num_heads=H,
             act_scales=sc_sa)),
        (lambda: quant.fused_qffn_sga_block(
            v2, kq2, vq2, v_mask, q_mask, wp_sga, dec["_qffn"], num_heads=H,
            act_scales=sc_sga),
         lambda: quant.fused_qffn_sga_block_plain(
             v2, kq2, vq2, v_mask, q_mask, wp_sga, dec["_qffn"],
             num_heads=H, act_scales=sc_sga))),
        ("fused_qffn_sa_block_level5", "fused_qffn_sga_block_level5"), None)
    mk_sa, mk_sga = quant_layout(wp_sa, False), quant_layout(wp_sga, True)
    x2, v2 = x2.float(), v2.float()
    run("MCAN-large full int8", (
        (lambda: quant.fused_quant_sa_block(x2, q_mask, mk_sa, num_heads=H),
         lambda: quant.fused_quant_sa_block_plain(x2, q_mask, mk_sa,
                                                  num_heads=H)),
        (lambda: quant.fused_quant_sga_block(v2, kq2, vq2, v_mask, q_mask,
                                             mk_sga, num_heads=H),
         lambda: quant.fused_quant_sga_block_plain(
             v2, kq2, vq2, v_mask, q_mask, mk_sga, num_heads=H))), names,
        None)


# ---------------------------------------------------------------------------
# main path 1 -- Predictor(engine="fused") answers requests
# ---------------------------------------------------------------------------

def ragged_batch(rng, cfg, n: int):
    """n questions and n per-image [R_i, F] features, R_i ragged."""
    feats = [np.abs(rng.normal(size=(int(r), cfg.img_feat_size)))
             .astype(np.float32)
             for r in rng.integers(10, cfg.img_feat_pad_size + 1, n)]
    return [QUESTIONS[i % len(QUESTIONS)] for i in range(n)], feats


def make_requests(rng, cfg):
    """Three single requests, a batch of 5, a full batch and an empty
    (all-PAD) question."""
    reqs = [ragged_batch(rng, cfg, 1) for _ in range(3)]
    reqs += [ragged_batch(rng, cfg, 5), ragged_batch(rng, cfg, BATCH)]
    _, feats = ragged_batch(rng, cfg, 1)
    return reqs + [([""], feats)]


BF16_SERVE_KERNELS = ("fused_sa_block", "fused_sga_block", "gemm_bias_act",
                      "masked_attention", "residual_layernorm")
INT8_SERVE_KERNELS = ("fused_qffn_sa_block", "fused_qffn_sga_block",
                      "gemm_s8", "quantize_rows", "gemm_bias_act",
                      "masked_attention", "masked_attention_f32",
                      "residual_layernorm")


def serve_launches(L: int, level: int, aux: bool = False, D: int = 512):
    """Every kernel's launches in one forward of the engine at this level
    (0: all bf16) at hidden D: per SA block the qkv, the merge and the
    FFN's two products, one attention, two LayerNorms; per SGA block also
    the cross q, its merge, the cross attention and a third LayerNorm.
    Level 1 runs the FFN products int8 (dynamic), and at D >= 1024 the qkv
    too (``decode_qffn_level``); level 3 every product (static) with the
    attention output f32; levels 4 / 6 the FFN int4 (gemm_s4 /
    gemm_w4bf16) and the other products int8, levels 5 / 7 the qkv int4
    too (the bf16-dequant sites quantize nothing). aux: the static-int8
    cross k/v of each decoder block, both AttFlat merges and the head."""
    blocks = ({"fused_sa_block": L, "fused_sga_block": L} if level == 0 else
              {"fused_qffn_sa_block": L, "fused_qffn_sga_block": L})
    if level >= 4:
        blocks.update({f"fused_qffn_sa_block_level{level}": L,
                       f"fused_qffn_sga_block_level{level}": L})
    int4 = {4: 4 * L, 5: 6 * L, 6: 4 * L, 7: 6 * L}.get(level, 0)
    int8 = {0: 0, 1: (6 if D >= 1024 else 4) * L, 3: 10 * L}.get(
        level, 10 * L - int4)
    counts = dict(blocks, gemm_bias_act=10 * L - int8 - int4,
                  residual_layernorm=5 * L,
                  gemm_s8=int8, quantize_rows=int8 + int4 * (level < 6))
    counts["gemm_s4" if level < 6 else "gemm_w4bf16"] = int4
    counts["masked_attention_f32" if level >= 3 else "masked_attention"] = \
        3 * L
    if aux:
        counts["gemm_s8"] += L + 3
        counts["quantize_rows"] += L + 3
    return {k: n for k, n in counts.items() if n}


def check_launches(label, counts, want, n_fwd) -> None:
    """The run's launch counts are exactly n_fwd forwards' worth."""
    want = {k: n * n_fwd for k, n in want.items()}
    say(f"[launches] {label}, {n_fwd} forwards: {counts}")
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")


def agreement(label, requests, probs, plain, n_answers,
              bound=INT8_BOUND, on="sigmoid") -> None:
    """Top-1 and max |dprob| of a fused engine against the plain engine:
    a top-1 flip only inside a near-tie (the plain engine's top two within
    2 x bound). on="softmax": the bound holds the softmax over the answers
    of the logits (JAX's int4 gate, tests/test_quant.py:339-370); the
    sigmoid figure is printed beside it."""
    worst, worst_sig, strict, near_ties, far_flips = 0.0, 0.0, 0, 0, 0

    def softmax(p):
        z = np.log(p.astype(np.float64)) - np.log1p(-p.astype(np.float64))
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    for (qs, fs), pf in zip(requests, probs):
        if pf.shape != (len(qs), n_answers) or not np.isfinite(pf).all() \
                or pf.min() < 0 or pf.max() > 1:
            fail(f"{label}: bad probabilities: shape {pf.shape}, finite "
                 f"{np.isfinite(pf).all()}")
        pp = plain.predict_probs(qs, fs)
        worst_sig = max(worst_sig, float(np.abs(pf - pp).max()))
        worst = worst_sig if on == "sigmoid" else max(
            worst, float(np.abs(softmax(pf) - softmax(pp)).max()))
        for rf, rp in zip(pf, pp):
            a, b = int(rf.argmax()), int(rp.argmax())
            if a == b:
                strict += 1
            elif rp[b] - rp[a] <= 2 * bound:
                near_ties += 1
            else:
                far_flips += 1
    total = sum(len(q) for q, _ in requests)
    extra = "" if on == "sigmoid" else f" (sigmoid {worst_sig:.3e})"
    say(f"[agree] {label} vs plain on the card: top-1 {strict}/{total} "
        f"(+{near_ties} near-ties, {far_flips} flips), max|dprob| "
        f"{worst:.3e} on the {on}{extra} <= bound {bound:.0e}")
    if worst > bound or far_flips:
        fail(f"{label} and the plain engine disagree")


def serve_main_path(torch, dev, state_dict, cfg, vocab, ix_to_ans,
                    rows) -> None:
    """Predictor() with its defaults: level 1 from the first request, the
    online calibration after 256 real rows, level 3 after the swap; every
    backbone block of every forward through the int8 block kernels on both
    sides of the swap. Then the explicit calibration paths, the all-bf16
    engine's launches and the forward times of every engine."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine

    L = cfg.layer
    kw = dict(ix_to_ans=ix_to_ans, max_batch=BATCH,
              latency_buckets=LATENCY_BUCKETS, device=dev)
    fused = Predictor(cfg, state_dict, vocab, **kw)
    plain = Predictor(cfg, state_dict, vocab, engine="plain", **kw)
    rng = np.random.default_rng(SEED)
    requests = make_requests(rng, cfg)
    with fused.calibration_paused():     # warm-up: not collected
        fused.predict_probs(*requests[0])
    torch.cuda.synchronize()
    n_fwd, n_rows = len(requests), sum(len(q) for q, _ in requests)
    say(f"[serve] Predictor(max_batch={BATCH}, latency_buckets="
        f"{LATENCY_BUCKETS}), engine {fused.engine!r}, calibration "
        f"{fused.calibration}: {n_fwd} requests, sizes "
        f"{[len(q) for q, _ in requests]} -> buckets "
        f"{[fused.bucket_for(len(q)) for q, _ in requests]}")

    # level 1, before the calibration
    K.reset_launches()
    probs1 = [fused.predict_probs(qs, fs) for qs, fs in requests]
    torch.cuda.synchronize()
    counts1 = K.launch_counts()
    check_launches("serve level 1", counts1, serve_launches(L, 1), n_fwd)
    cal = fused.calibration
    if cal != {"state": "collecting", "samples": n_rows, "target": 256}:
        fail(f"calibration after {n_rows} real rows: {cal}")
    agreement("level 1", requests, probs1, plain, len(ix_to_ans))

    # cross 256 real rows: the background rebuild, then the swap
    fill = [ragged_batch(rng, cfg, BATCH) for _ in range(3)]
    t0 = time.perf_counter()
    for qs, fs in fill:
        fused.predict_probs(qs, fs)
    if not fused.wait_calibrated(timeout=600):
        fail("the online calibration did not finish in 600 s")
    cal = fused.calibration
    say(f"[calibrate] online: {cal} after {n_rows + 3 * BATCH} real rows, "
        f"{time.perf_counter() - t0:.2f} s from the crossing request to the "
        f"swap; scales enc_0 {fused.act_scales['enc_0']}")
    if cal["state"] != "calibrated" or "error" in cal:
        fail(f"the online calibration failed: {cal}")
    if fused.routes != {b: "base" for b in fused.buckets}:
        fail(f"routes {fused.routes}")

    # level 3, after the swap (the counts start after the background
    # pre-run, which launches too)
    K.reset_launches()
    probs3 = [fused.predict_probs(qs, fs) for qs, fs in requests]
    torch.cuda.synchronize()
    counts3 = K.launch_counts()
    check_launches("serve level 3", counts3, serve_launches(L, 3), n_fwd)
    say(f"  every backbone block of every forward ran through the int8 "
        f"block kernels ({L} SA + {L} SGA per forward), no bf16 block, on "
        f"both sides of the swap")
    agreement("level 3", requests, probs3, plain, len(ix_to_ans))
    rows.launches("serve", {k: counts1.get(k, 0) + counts3.get(k, 0)
                            for k in INT8_SERVE_KERNELS}, INT8_SERVE_KERNELS)

    # the explicit calibration paths give the online engine's scales and
    # its probabilities, bit for bit (the same replay, deterministic
    # kernels)
    seen = [r for q, f in requests + fill for r in zip(q, f)][:256]
    explicit = Predictor(cfg, state_dict, vocab, act_calibration=(
        [q for q, _ in seen], [f for _, f in seen]), **kw)
    stored = Predictor(cfg, state_dict, vocab,
                       act_scales=fused.act_scales, **kw)
    for name, other in (("act_calibration", explicit),
                        ("act_scales", stored)):
        same_scales = other.act_scales == fused.act_scales
        same_probs = all(np.array_equal(other.predict_probs(qs, fs), p)
                         for (qs, fs), p in zip(requests, probs3))
        say(f"[calibrate] Predictor({name}=...): scales equal "
            f"{same_scales}, probabilities equal bit for bit {same_probs}")
        if not (same_scales and same_probs):
            fail(f"Predictor({name}=...) differs from the online engine")

    # the all-bf16 engine (qffn=0): still built, and past QFFN_MAX_BATCH
    # the path of a dynamic-scale block
    bf16_fwd, bf16_prep = build_production_engine(
        state_dict, L, cfg.multi_head, qffn=0, device=dev)
    level1_fwd, level1_prep = build_production_engine(
        state_dict, L, cfg.multi_head, device=dev)

    engine = functools.partial(padded_engine, torch, dev)
    padded = [fused.pad_batch(qs, fs) for qs, fs in requests]
    bf16 = engine(bf16_fwd, bf16_prep)
    K.reset_launches()
    probs0 = [bf16(img, ques)[:len(qs)].cpu().numpy()
              for (img, ques), (qs, _) in zip(padded, requests)]
    torch.cuda.synchronize()
    counts0 = K.launch_counts()
    check_launches("serve bf16 (qffn=0)", counts0, serve_launches(L, 0),
                   n_fwd)
    rows.launches("serve bf16", counts0, BF16_SERVE_KERNELS)
    # the bf16 stream against f32: a few 1e-3 on the CPU
    # (tests/test_torch_full_size.py), 1e-2 as since the first slice
    agreement("bf16 (qffn=0)", requests, probs0, plain, len(ix_to_ans),
              bound=1e-2)

    level3_fwd, level3_prep = build_production_engine(
        state_dict, L, cfg.multi_head, act_scales=fused.act_scales,
        device=dev)
    return plain, requests, fused, [
        ("bf16", bf16), ("int8 L1", engine(level1_fwd, level1_prep)),
        ("int8 L3", engine(level3_fwd, level3_prep))]


def padded_engine(torch, dev, fwd, prep):
    """An engine's forward on a padded numpy batch -> probabilities."""
    def call(img, ques):
        with torch.inference_mode():
            return torch.sigmoid(fwd(prep, torch.from_numpy(img).to(dev),
                                     torch.from_numpy(ques).to(dev)))
    return call


def time_forwards(torch, cfg, fused, engines) -> None:
    """Forward time per bucket (CUDA events around the forward on a padded
    batch; inputs copied from the host inside). The forward is host-bound,
    so the engines take turns over ROUNDS rounds and each reports its
    median round."""
    rng = np.random.default_rng(SEED + 2)
    for b in LATENCY_BUCKETS + (BATCH,):
        img, ques = fused.pad_batch(*ragged_batch(rng, cfg, b))
        t = {name: [] for name, _ in engines}
        for _ in range(ROUNDS):
            for name, fn in engines:
                t[name].append(cuda_ms(torch, lambda: fn(img, ques),
                                       iters=10))
        say(f"[forward] B={b}, median of {ROUNDS} rounds of 10: "
            + ", ".join(f"{n} {float(np.median(ms)):.3f} ms "
                        f"({min(ms):.3f}-{max(ms):.3f})"
                        for n, ms in t.items()))


# ---------------------------------------------------------------------------
# main paths 1b-1d -- Predictor(engine="int4"), Predictor(q8aux=True),
# Predictor(engine="int8")
# ---------------------------------------------------------------------------

INT4_SERVE_KERNELS = INT8_SERVE_KERNELS + ("gemm_s4", "gemm_w4bf16") + tuple(
    f"fused_qffn_{b}_block_level{lv}" for lv in (4, 5, 6, 7)
    for b in ("sa", "sga"))
QUANT_SERVE_KERNELS = ("fused_quant_sa_block", "fused_quant_sga_block",
                       "gemm_s8", "quantize_rows", "masked_attention_f32",
                       "residual_layernorm")


def int8_engine_launches(L: int):
    """Every kernel's launches in one forward of the full-int8 engine: per
    layer pair 10 int8 sites in the blocks, 3 attentions (f32 out) and 5
    LayerNorms; outside them the image projection, each decoder block's
    cross k/v, both AttFlat MLPs (2 sites each) and merges, the head."""
    n = 10 * L + 1 + L + 4 + 2 + 1
    return {"fused_quant_sa_block": L, "fused_quant_sga_block": L,
            "gemm_s8": n, "quantize_rows": n, "masked_attention_f32": 3 * L,
            "residual_layernorm": 5 * L}


def serve_quantized_paths(torch, dev, state_dict, cfg, vocab, ix_to_ans,
                          rows, plain, requests):
    """Main paths 1b-1d on the requests of [serve] (B = 1, 8 and 64, ragged,
    one empty question): Predictor(engine="int4") before its calibration
    swap (level 1) and after (level 5), then levels 4, 6 and 7 through
    build_production_engine; Predictor(q8aux=True) before and after its
    swap (level 3 + the aux sites); Predictor(engine="int8"). Each checks
    its launches and its agreement with the plain engine. -> the engines
    to time."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine

    L, H, n_ans = cfg.layer, cfg.multi_head, len(ix_to_ans)
    kw = dict(ix_to_ans=ix_to_ans, max_batch=BATCH,
              latency_buckets=LATENCY_BUCKETS, device=dev)
    n_fwd = len(requests)
    engine = functools.partial(padded_engine, torch, dev)

    def serve(label, p, want, bound=INT8_BOUND, on="sigmoid"):
        K.reset_launches()
        probs = [p.predict_probs(qs, fs) for qs, fs in requests]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_launches(label, counts, want, n_fwd)
        agreement(label, requests, probs, plain, n_ans, bound, on)
        return counts

    # [serve int4]: level 1 until calibrate_now(), then level 5
    p4 = Predictor(cfg, state_dict, vocab, engine="int4", **kw)
    say(f"[serve int4] Predictor(engine='int4'), calibration "
        f"{p4.calibration}")
    before = serve("serve int4 before calibration (level 1)", p4,
                   serve_launches(L, 1))
    t0 = time.perf_counter()
    p4.calibrate_now()
    say(f"[calibrate] int4: {p4.calibration}, {time.perf_counter() - t0:.2f}"
        f" s for the replay, the level-5 build and the bucket pre-runs")
    after = serve("serve int4 level 5", p4, serve_launches(L, 5),
                  INT4_BOUND, "softmax")
    rows.launches("serve int4", {k: before.get(k, 0) + after.get(k, 0)
                                 for k in INT4_SERVE_KERNELS},
                  INT4_SERVE_KERNELS)
    # levels 4, 6 and 7 through the builder, calibrated on the full batch
    cal = p4.pad_batch(*requests[4])
    timed = [("int4 L5", p4.forward_padded)]
    for level in (4, 6, 7):
        fwd, prep = build_production_engine(
            state_dict, L, H, qffn=level, act_scale_inputs=cal, device=dev)
        call = engine(fwd, prep)
        K.reset_launches()
        probs = [call(*p4.pad_batch(qs, fs))[:len(qs)].cpu().numpy()
                 for qs, fs in requests]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        label = f"serve level {level} (build_production_engine)"
        check_launches(label, counts, serve_launches(L, level), n_fwd)
        agreement(label, requests, probs, plain, n_ans, INT4_BOUND,
                  "softmax")
        rows.launches(f"serve level {level}", counts, INT4_SERVE_KERNELS)
        if level == 7:
            timed.append(("int4 L7", call))

    # [serve q8aux]: engine "auto" (two-pass scales) with the aux sites
    pq = Predictor(cfg, state_dict, vocab, q8aux=True, **kw)
    before = serve("serve q8aux before calibration (level 1)", pq,
                   serve_launches(L, 1))
    pq.calibrate_now()
    say(f"[calibrate] q8aux: {pq.calibration}, aux scales "
        f"{pq.act_scales['aux']}")
    after = serve("serve q8aux (level 3 + aux)", pq,
                  serve_launches(L, 3, aux=True))
    rows.launches("serve q8aux", {k: before.get(k, 0) + after.get(k, 0)
                                  for k in INT8_SERVE_KERNELS},
                  INT8_SERVE_KERNELS)
    timed.append(("q8aux", pq.forward_padded))

    # [serve int8]: the full-int8 engine, no calibration
    p8 = Predictor(cfg, state_dict, vocab, engine="int8", **kw)
    counts = serve("serve int8 (full)", p8, int8_engine_launches(L))
    rows.launches("serve int8", counts, QUANT_SERVE_KERNELS)
    timed.append(("int8 full", p8.forward_padded))
    return timed


# ---------------------------------------------------------------------------
# main path 1e -- serving artifacts: Predictor.export_artifact, the programs
# loaded in a fresh process (ArtifactPredictor), and the HTTP stack
# ---------------------------------------------------------------------------

ART_ITERS = 10                  # forwards timed per bucket and side
ART_TIMEOUT = 600               # the loading process's time limit
HTTP_CLIENTS = 16
HTTP_SINGLES = 96               # single POSTs per server
HTTP_BATCHES = 4                # batched POSTs of 8 per server
HTTP_BENCH_S = 5.0              # seconds per wire format of the bench
ASYNC_SLEEP_CYCLES = 10 ** 8    # ~50 ms of the card's clock
DISPATCH_TIMED = ("level 1", "level 3")   # engines timed with direct calls
ARTIFACT_KERNELS = ("gemm_bias_act", "gemm_s8", "quantize_rows",
                    "masked_attention", "masked_attention_f32",
                    "residual_layernorm", "gemm_s4", "gemm_ln")


def kernel_launches(counts):
    """The kernel-level counts of a run: the block functions' own counters
    (``fused_*``) are Python side effects that a program does not repeat."""
    return {k: n for k, n in counts.items() if not k.startswith("fused_")}


def artifact_engines(torch, dev, state_dict, cfg, vocab, ix_to_ans, fused):
    """(name, live Predictor, its kernel launches per forward): the
    default Predictor at level 1 and the online-calibrated one of
    [serve] at level 3, MCAN-small at full depth over buckets 1, 8 and 64;
    the int4 (level 5), full-int8, plain and q8aux engines at bucket 8 and
    the hidden-1536 Predictor of [wide] (mode 0) at bucket 8, each cut to
    WIDE_LAYERS layers (a program's export and load time grows with its
    depth; the kernels' shapes do not depend on it)."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet

    def seeded(c):
        return MCANet(c, len(vocab), len(ix_to_ans), generator=torch
                      .Generator().manual_seed(SEED + 51)).state_dict()

    cut = Config.for_model("small", layer=WIDE_LAYERS)
    wide = Config.for_model("small", layer=WIDE_LAYERS, hidden_size=1536)
    cut_sd, wide_sd = seeded(cut), seeded(wide)
    cal = ragged_batch(np.random.default_rng(SEED + 61), cut, BATCH)
    one = dict(ix_to_ans=ix_to_ans, max_batch=8, device=dev)
    C = WIDE_LAYERS
    return [
        ("level 1", Predictor(cfg, state_dict, vocab, ix_to_ans=ix_to_ans,
                              max_batch=BATCH, latency_buckets=LATENCY_BUCKETS,
                              engine="fused", auto_calibrate=0, device=dev),
         serve_launches(cfg.layer, 1)),
        ("level 3", fused, serve_launches(cfg.layer, 3)),
        ("int4", Predictor(cut, cut_sd, vocab, engine="int4",
                           act_calibration=cal, **one),
         serve_launches(C, 5)),
        ("int8", Predictor(cut, cut_sd, vocab, engine="int8", **one),
         int8_engine_launches(C)),
        ("plain", Predictor(cut, cut_sd, vocab, engine="plain", **one), {}),
        ("q8aux", Predictor(cut, cut_sd, vocab, q8aux=True,
                            act_calibration=cal, **one),
         serve_launches(C, 3, aux=True)),
        ("hidden 1536", Predictor(wide, wide_sd, vocab, engine="fused",
                                  auto_calibrate=0, **one),
         mode0_launches(C, False, False))]


def artifact_path(torch, dev, rows, work: Path, state_dict, cfg, vocab,
                  ix_to_ans, fused) -> Path:
    """[artifact]: each engine exported (``Predictor.export_artifact``), its
    live forward per bucket run on seeded padded inputs (probabilities,
    kernel launches of one forward, CUDA-event ms); then one fresh process
    (``--artifact-load``: one torch import, nothing of the model code)
    loads every artifact and runs the same inputs, and each artifact must
    give the live probabilities bit for bit with the live launches. ->
    the level-3 artifact's directory."""
    from mcan_vqa_tpu_torch.device import to_host
    from mcan_vqa_tpu_torch.ops import kernels as K
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 62)
    spec, live = [], {}
    for name, p, want in artifact_engines(torch, dev, state_dict, cfg, vocab,
                                          ix_to_ans, fused):
        path = work / name.replace(" ", "_")
        t0 = time.perf_counter()
        p.export_artifact(str(path))
        export_s = time.perf_counter() - t0
        buckets = []
        for b in p.buckets:
            img, ques = p.pad_batch(*ragged_batch(rng, p.cfg, b))
            inputs = path.parent / f"{path.name}_b{b}.npz"
            probs = to_host(p.forward_padded(img, ques), b)
            np.savez(inputs, img=img, ques=ques, probs=probs)
            K.reset_launches()
            p.forward_padded(img, ques)
            torch.cuda.synchronize()
            counts = kernel_launches(K.launch_counts())
            if counts != kernel_launches(want):
                fail(f"[artifact] {name} B={b}: the live forward launched "
                     f"{counts}, expected {kernel_launches(want)}")
            ms = [cuda_ms(torch, lambda: p.forward_padded(img, ques),
                          iters=ART_ITERS) for _ in range(2)]
            live[name, b] = (counts, ms)
            buckets.append(dict(bucket=b, inputs=str(inputs)))
        mib = sum(f.stat().st_size for f in path.iterdir()) / 2 ** 20
        say(f"[artifact] {name}: engine {p.engine!r}, buckets {p.buckets}, "
            f"exported in {export_s:.1f} s ({export_s / len(p.buckets):.1f} "
            f"s a program), {mib:.1f} MiB on disk")
        spec.append(dict(name=name, path=str(path), buckets=buckets))
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--artifact-load",
         str(work)], cwd=ROOT, capture_output=True, text=True,
        timeout=ART_TIMEOUT)
    if proc.returncode != 0:
        say(proc.stdout[-3000:] + proc.stderr[-3000:])
        fail(f"[artifact] the loading process exited {proc.returncode}")
    got = json.loads((work / "result.json").read_text())
    say(f"[artifact] one fresh process loaded {len(spec)} artifacts in "
        f"{time.perf_counter() - t0:.1f} s (torch import and the kernels' "
        f"library included); model code imported there: "
        f"{got['model_modules'] or 'none'}")
    if got["model_modules"]:
        fail("[artifact] the loader imported the model code")
    total = {}
    for art in got["artifacts"]:
        for r in art["buckets"]:
            name, b = art["name"], r["bucket"]
            counts, ms = live[name, b]
            again = (f"; every artifact loaded, in turns: the program "
                     f"{fmt_ms(r['turns']['ops'])} ms, its {r['op_nodes']} "
                     f"op nodes called directly "
                     f"{fmt_ms(r['turns']['direct'])} ms"
                     if "turns" in r else "")
            say(f"[artifact] {name} B={b}: load {art['load_s']:.2f} s, "
                f"bit for bit {r['equal']} (max |d| {r['max_abs']:.3e}), "
                f"launches a forward {r['launches']}, forward "
                f"{r['ms']:.3f} ms vs live {fmt_ms(ms)} ms (CUDA events, "
                f"{ART_ITERS} eager forwards, input copies included, "
                f"{r['programs_loaded']} programs loaded){again}")
            if not r["equal"]:
                fail(f"[artifact] {name} B={b}: the artifact's probabilities "
                     f"differ from the live Predictor's")
            if r["launches"] != counts:
                fail(f"[artifact] {name} B={b}: launches {r['launches']}, "
                     f"the live forward's {counts}")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    rows.launches("artifact", total,
                  [k for k in ARTIFACT_KERNELS if k in rows.rows])
    return work / "level_3"


def retarget(gm, targets) -> int:
    """Point a loaded program's call nodes from one set of targets to
    another (``targets``: old -> new) and recompile it. -> nodes moved."""
    n = 0
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target in targets:
            node.target = targets[node.target]
            n += 1
    gm.recompile()
    return n


def fmt_ms(ms) -> str:
    return " / ".join(f"{m:.3f}" for m in ms)


def artifact_load(work: Path) -> None:
    """The fresh process of [artifact]: each artifact of work/spec.json
    loaded in turn (timed; the ones before it stay loaded) and run on the
    saved padded inputs: bit-for-bit equality with the live
    probabilities, the kernel launches of one forward, CUDA-event ms; then
    the default engines' programs timed again in turns with the same
    programs calling the ops' implementations directly (``retarget``);
    -> work/result.json."""
    before = set(sys.modules)
    import torch
    sys.path.insert(0, str(ROOT))
    from mcan_vqa_tpu_torch.ops import _build
    _build.load_library()                  # the parent's build, loaded
    from mcan_vqa_tpu_torch.artifact import load_artifact
    from mcan_vqa_tpu_torch.device import to_host
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import library
    out, loaded = [], []
    for art in json.loads((work / "spec.json").read_text()):
        t0 = time.perf_counter()
        ap = load_artifact(art["path"])
        load_s = time.perf_counter() - t0
        loaded.append((ap, art))
        buckets = []
        for entry in art["buckets"]:
            b = entry["bucket"]
            with np.load(entry["inputs"]) as z:
                img, ques, want = z["img"], z["ques"], z["probs"]
            probs = to_host(ap.forward_padded(img, ques), b)
            K.reset_launches()
            ap.forward_padded(img, ques)
            torch.cuda.synchronize()
            counts = K.launch_counts()

            def forward():
                return ap.forward_padded(img, ques)

            buckets.append(dict(
                bucket=b, equal=bool(np.array_equal(probs, want)),
                max_abs=float(np.abs(probs - want).max()), launches=counts,
                ms=cuda_ms(torch, forward, iters=ART_ITERS),
                programs_loaded=sum(len(a.buckets) for a, _ in loaded)))
        out.append(dict(name=art["name"], load_s=load_s, buckets=buckets))
    # the default engines at B = 1 and 64 again, every artifact loaded, in
    # turns: each program as loaded (its torch.ops.mcan.* nodes) and with
    # those nodes pointed at the ops' implementations (library.IMPLS: the
    # same graph and kernels, no custom-op dispatch); the host's clock
    # wanders, so the two take turns
    to_impl = {getattr(torch.ops.mcan, n).default: fn
               for n, fn in library.IMPLS.items()}
    to_op = {fn: op for op, fn in to_impl.items()}
    for (ap, art), res in zip(loaded, out):
        if art["name"] not in DISPATCH_TIMED:
            continue
        for entry, r in zip(art["buckets"], res["buckets"]):
            b = r["bucket"]
            if b not in (1, BATCH):
                continue
            with np.load(entry["inputs"]) as z:
                img, ques = z["img"], z["ques"]

            def forward():
                return ap.forward_padded(img, ques)

            turns = {"ops": [], "direct": []}
            for order in (("ops", "direct"), ("direct", "ops")):
                for side in order:
                    r["op_nodes"] = retarget(
                        ap._fns[b], to_impl if side == "direct" else to_op)
                    turns[side].append(cuda_ms(torch, forward, iters=5,
                                               warmup=2))
            r["turns"] = turns
    model = ("mcan_vqa_tpu_torch.api", "mcan_vqa_tpu_torch.models.net",
             "mcan_vqa_tpu_torch.ops.serving", "mcan_vqa_tpu_torch.ops.quant",
             "mcan_vqa_tpu_torch.ops.sga_block")
    (work / "result.json").write_text(json.dumps(dict(
        artifacts=out, model_modules=sorted(
            m for m in set(sys.modules) - before if m in model))))


class Gated:
    """A predictor whose dispatch waits for ``gate``: the frontend's worker
    holds one request while the next ones queue up behind it."""

    def __init__(self, predictor):
        self._p = predictor
        self.entered = __import__("threading").Event()
        self.gate = __import__("threading").Event()

    def __getattr__(self, name):
        return getattr(self._p, name)

    def predict_probs_async(self, questions, feats):
        self.entered.set()
        self.gate.wait(60)
        return self._p.predict_probs_async(questions, feats)


def http_send(addr, method, path, body=b"", headers=None):
    """One request -> (status, JSON reply)."""
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.putrequest(method, path)
        hdrs = {"Content-Type": "application/json",
                "Content-Length": str(len(body))}
        hdrs.update(headers or {})
        for k, v in hdrs.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body and "Content-Length" not in (headers or {}):
            conn.send(body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def http_traffic(rng, cfg, F: int):
    """The bodies a server gets: singles (b64 and lists, top_k 1 and 5),
    batches of 8, and malformed requests, each with the status it must
    get. -> ([(body, status, items)], the valid items)."""
    import base64

    def feat_json(f, b64):
        return ({"b64": base64.b64encode(f.tobytes()).decode(),
                 "shape": list(f.shape)} if b64 else f.tolist())

    items, posts = [], []
    for i in range(HTTP_SINGLES + 8 * HTTP_BATCHES):
        qs, fs = ragged_batch(rng, cfg, 1)
        items.append((qs[0], fs[0], 5 if i % 3 == 0 else 1, i % 2 == 0))
    for i in range(HTTP_SINGLES):
        q, f, k, b64 = items[i]
        posts.append(({"question": q, "image_feature": feat_json(f, b64),
                       "top_k": k}, 200, [i]))
    for j in range(HTTP_BATCHES):
        idx = list(range(HTTP_SINGLES + 8 * j, HTTP_SINGLES + 8 * (j + 1)))
        posts.append(({"requests": [
            {"question": items[i][0],
             "image_feature": feat_json(items[i][1], items[i][3]),
             "top_k": items[i][2]} for i in idx]}, 200, idx))
    bad = np.ones((3, F), np.float32)
    bad[1, 2] = np.nan
    good = [[0.5] * F] * 3
    posts += [(b"{not json", 400, []),
              ({"question": "what", "image_feature": feat_json(bad, True)},
               400, []),
              ({"question": "what", "image_feature": {"b64": "!!!",
                                                      "shape": [1, F]}},
               400, []),
              ({"requests": []}, 400, []),
              ({"question": "what", "image_feature": good, "top_k": 33},
               400, []),
              ({"question": "", "image_feature": good}, 400, []),
              # a wrong width fails in the frontend's validation: 500, as
              # the JAX server answers it
              ({"question": "what", "image_feature": [[0.5] * 7]}, 500, [])]
    return posts, items


def http_check(label, replies, posts, items, direct) -> float:
    """Every reply has its status; every answer equals the direct
    Predictor's top-1 on the same request, or is a near-tie within
    INT8_BOUND of it. -> the largest probability gap seen."""
    worst, flips = 0.0, 0
    for (status, out), (body, want, idx) in zip(replies, posts):
        if status != want:
            fail(f"[http] {label}: {str(body)[:80]} got {status} {out}, "
                 f"expected {want}")
        if want != 200:
            continue
        results = out["results"] if "requests" in body else [out]
        for i, res in zip(idx, results):
            row = direct[i]
            top = int(row.argmax())
            ans, prob = res["answer"], res["prob"]
            k = items[i][2]
            if k > 1 and [a["prob"] for a in res["answers"]] != sorted(
                    (a["prob"] for a in res["answers"]), reverse=True):
                fail(f"[http] {label}: top-{k} not in order: {res}")
            ix = DIRECT_IX[ans]
            worst = max(worst, abs(prob - float(row[ix])))
            if ix != top:
                flips += 1
                if row[top] - row[ix] > INT8_BOUND:
                    fail(f"[http] {label}: answer {ans!r} ({row[ix]:.4f} "
                         f"direct) against the direct top-1 "
                         f"({row[top]:.4f})")
    answered = sum(len(i) for _, _, i in posts)
    say(f"[http] {label}: {len(posts)} POSTs ({answered} answered items), "
        f"every status as expected; top-1 flips "
        f"inside a near-tie {flips}, largest |dprob| against the direct "
        f"Predictor {worst:.3e} <= {INT8_BOUND:.0e}")
    if worst > INT8_BOUND:
        fail(f"[http] {label}: probabilities off by {worst:.3e}")
    return worst


DIRECT_IX = {}


def http_path(torch, dev, rows, cfg, fused, art_dir: Path, card: str):
    """[http]: make_server over the calibrated Predictor of [serve] and
    over its artifact, 16 concurrent clients posting ~256 requests each
    way; the 503 of a full queue (a gated server, max_queue 1) and the 413
    of a body over the cap; ``predict_probs_async`` at B = 64 returns
    before its forward ends; then one bench_serve_http line per wire
    format."""
    import queue
    import threading

    from mcan_vqa_tpu_torch.artifact import load_artifact
    from mcan_vqa_tpu_torch.cli import bench_serve_http as bench
    from mcan_vqa_tpu_torch.cli import serve
    from mcan_vqa_tpu_torch.device import to_host
    from mcan_vqa_tpu_torch.ops import kernels as K
    F = cfg.img_feat_size
    ap = load_artifact(str(art_dir))
    DIRECT_IX.update({a: int(i) for i, a in fused.ix_to_ans.items()})
    posts, items = http_traffic(np.random.default_rng(SEED + 63), cfg, F)
    direct = [fused.predict_probs([q], [f])[0] for q, f, _, _ in items]
    cap = 64 << 20              # make_server's default body cap
    K.reset_launches()
    for label, p in (("live", fused), ("artifact", ap)):
        serve.warmup(p)
        srv, frontend = serve.make_server(p, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        addr = srv.server_address[:2]
        todo = queue.Queue()
        for i, (body, _, _) in enumerate(posts):
            todo.put((i, body if isinstance(body, bytes)
                      else json.dumps(body).encode()))
        replies = [None] * len(posts)

        def client():
            while True:
                try:
                    i, body = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    replies[i] = http_send(addr, "POST", "/v1/answer", body)
                except OSError as e:     # reported by http_check
                    replies[i] = (None, {"error": repr(e)})

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client)
                   for _ in range(HTTP_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        extra = [http_send(addr, "GET", "/nope"),
                 http_send(addr, "POST", "/v1/answer", b"",
                           {"Content-Length": str(cap + 1)}),
                 http_send(addr, "GET", "/stats")]
        srv.shutdown()
        srv.server_close()
        frontend.close()
        thread.join(timeout=10)
        http_check(label, replies, posts, items, direct)
        (s404, _), (s413, o413), (s200, stats) = extra
        say(f"[http] {label}: {wall:.2f} s for the traffic from "
            f"{HTTP_CLIENTS} clients; unknown route {s404}, body over the "
            f"cap {s413}; /stats: {stats['batches_run']} batches, mean "
            f"occupancy {stats['mean_occupancy']:.2f}, latency "
            f"{stats['latency_ms']}, engine {stats['engine']}, "
            f"calibration {stats['calibration']['state']}")
        if (s404, s413, s200) != (404, 413, 200):
            fail(f"[http] {label}: statuses {s404}, {s413} {o413}, {s200}")
    counts = kernel_launches(K.launch_counts())
    rows.launches("http", counts,
                  [k for k in ARTIFACT_KERNELS if k in rows.rows])
    say(f"[http] kernel launches of both servers' traffic: {counts}")

    # a full queue: 503
    gated = Gated(fused)
    srv, frontend = serve.make_server(gated, port=0, max_queue=1,
                                      max_wait_ms=0.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address[:2]
    one = json.dumps({"question": "what", "image_feature": [[0.5] * F]}
                     ).encode()
    held = [None, None]

    def post(i):
        held[i] = http_send(addr, "POST", "/v1/answer", one)

    first = threading.Thread(target=post, args=(0,))
    first.start()
    gated.entered.wait(60)
    second = threading.Thread(target=post, args=(1,))
    second.start()
    t0 = time.perf_counter()
    while frontend._q.qsize() < 1 and time.perf_counter() - t0 < 30:
        time.sleep(0.01)
    s503, o503 = http_send(addr, "POST", "/v1/answer", one)
    gated.gate.set()
    first.join(60)
    second.join(60)
    srv.shutdown()
    srv.server_close()
    frontend.close()
    thread.join(timeout=10)
    say(f"[http] max_queue=1 with one request held: {s503} {o503}; the held "
        f"ones {[h[0] for h in held]}")
    if s503 != 503 or [h[0] for h in held] != [200, 200]:
        fail("[http] the full queue did not shed with 503")

    # the dispatch returns before the forward ends: the card is kept busy
    # (~50 ms of torch.cuda._sleep) ahead of each call, so a call that
    # waited for the card anywhere (a pageable input copy synchronises the
    # stream) would return with its forward done
    qs, fs = ragged_batch(np.random.default_rng(SEED + 64), cfg, BATCH)
    for label, p in (("live", fused), ("artifact", ap)):
        pending = 0
        for _ in range(20):
            torch.cuda._sleep(ASYNC_SLEEP_CYCLES)
            probs, n = p.predict_probs_async(qs, fs)
            done = torch.cuda.Event()
            done.record()
            pending += not done.query()
            to_host(probs, n)
        say(f"[http] {label} predict_probs_async at B={BATCH}: the forward "
            f"still running at the return in {pending} of 20 calls")
        if pending <= 10:
            fail(f"[http] {label}: predict_probs_async waited for its "
                 f"forward in {20 - pending} of 20 calls")

    for label, p, formats in (("live level 3", fused, ["b64", "list"]),
                              ("artifact level 3", ap, ["b64", "list"])):
        for r in bench.bench(p, HTTP_BENCH_S, HTTP_CLIENTS, formats,
                             cfg.img_feat_pad_size):
            say("[bench_serve_http] " + json.dumps(dict(
                r, engine=label, card=card)))
            if r["errors"]:
                fail(f"[bench_serve_http] {label}: {r['errors']} errors")


# ---------------------------------------------------------------------------
# main path 2 -- Trainer.train() on the synthetic set at full width
# ---------------------------------------------------------------------------

# launches per decoder block in one step: forward (6 products, 2
# attentions, 3 LayerNorms), FFN backward (LN3 backward, 2 dX, 2 dW, one
# column-sum launch), attention backward (4 recomputed products, 2
# recomputed attentions, 2 LN backwards, 4 dX, 2 attention backwards,
# 4 dW, 2 column-sum launches)
PER_BLOCK = {"sga_train_fwd": 1, "sga_train_bwd_ffn": 1,
             "sga_train_bwd_att": 1, "gemm_bias_act": 10, "gemm_dx": 6,
             "gemm_dw": 6, "masked_attention": 4, "masked_attention_bwd": 2,
             "residual_layernorm": 3, "residual_layernorm_bwd": 3,
             "col_sum": 3}
# per encoder block (save_acts): forward (4 products, 1 attention, 2
# LayerNorms), backward (2 LN backwards, 4 dX, the recomputed qkv and
# merge and attention, 1 attention backward, 4 dW, 2 column-sum launches)
SA_PER_BLOCK = {"sa_train_fwd": 1, "sa_train_bwd": 1, "gemm_bias_act": 6,
                "gemm_dx": 4, "gemm_dw": 4, "masked_attention": 2,
                "masked_attention_bwd": 1, "residual_layernorm": 2,
                "residual_layernorm_bwd": 2, "col_sum": 2}
# per decoder block and micro-batch with att_saves: PER_BLOCK without the
# attention backward's 4 recomputed products
SAV_PER_BLOCK = dict(PER_BLOCK, sga_train_bwd_att=0, sga_train_bwd_att_sav=1,
                     gemm_bias_act=6)
# the blocks' own counters: the seeded route counts under name + "_prng"
BLOCK_COUNTERS = ("sga_train_fwd", "sga_train_bwd_ffn", "sga_train_bwd_att",
                  "sga_train_bwd_att_sav", "sa_train_fwd", "sa_train_bwd")
# the rows that stand for the MCAN-large instances of a train kernel
LARGE_ROWS = {"masked_attention_dh128": "masked_attention",
              "masked_attention_bwd_dh128": "masked_attention_bwd",
              "gemm_dx, MCAN-large": "gemm_dx",
              "gemm_dw, MCAN-large": "gemm_dw"}
TRAIN_KERNELS = tuple(sorted(set(PER_BLOCK) | set(SA_PER_BLOCK)
                             | set(SAV_PER_BLOCK)
                             | {k + "_prng" for k in BLOCK_COUNTERS}))


def expected_step_launches(cfg, route, seeded):
    """Every kernel's launches in one step of this configuration, its
    blocks seeded (in-kernel dropout) or fed masks: the same kernels
    either way."""
    n = cfg.layer * cfg.grad_accu_steps
    per = [(SAV_PER_BLOCK if route["att_saves"] else PER_BLOCK, n)]
    if route["fused_encoder"]:
        per.append((SA_PER_BLOCK, n))
    want = {k: 0 for k in TRAIN_KERNELS}
    for d, m in per:
        for k, c in d.items():
            want[k + "_prng" if seeded and k in BLOCK_COUNTERS else k] += \
                c * m
    return want


class MaskDraws:
    """Records every keep-mask the train forward draws from its generator
    (``fused_engine.keep_masks``) while active: site names and keep
    decisions."""

    def __init__(self):
        from mcan_vqa_tpu_torch.train import fused_engine
        self.mod, self.real = fused_engine, fused_engine.keep_masks
        self.names, self.decisions, self.active = [], 0, False

        def spy(generator, rate, shapes, bit_width=32):
            if self.active and rate > 0:
                self.names.extend(shapes)
                self.decisions += sum(int(np.prod(s))
                                      for s in shapes.values())
            return self.real(generator, rate, shapes, bit_width)

        fused_engine.keep_masks = spy

    def take(self):
        out = (list(self.names), self.decisions)
        self.names, self.decisions = [], 0
        return out

    def close(self):
        self.mod.keep_masks = self.real


def plain_site_masks(cfg, route):
    """The generator masks one micro-batch of the seeded route still draws:
    AttFlat's two, and the encoder's four per layer when it is plain."""
    enc = [] if route["fused_encoder"] else ["att", "y1", "h1", "y2"] * \
        cfg.layer
    return enc + ["lang", "img"]


def engine_loss(torch, dev, cfg, fwd, model, batch, gen_state):
    """The step's loss through the train forward ``fwd`` on the given
    weights, micro-batch by micro-batch from the generator state
    ``gen_state``, no autograd -> (the summed loss, the generator where
    the forwards leave it)."""
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    mb = BATCH // cfg.grad_accu_steps
    loss = 0.0
    with torch.no_grad():
        for i in range(cfg.grad_accu_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss += float(bce_with_logits_sum(
                fwd(model, batch["img"][sl], batch["ques"][sl], g),
                batch["target"][sl]))
    return loss, g


def loss_gate(label, loss, plain) -> float:
    """The kernel engine's loss within 1e-3 relative of the plain engine's
    (BCE summed over 64 x 3129 terms; bf16 roundings move it ~1e-6)."""
    rel = abs(loss - plain) / abs(plain)
    if not rel <= 1e-3:
        fail(f"{label}: loss {loss} vs plain engine {plain}, rel {rel}")
    return rel


def compare_dropout_routes(torch, dev, trainer, route, tag, rows,
                           n: int = 3) -> None:
    """One step's forward and backward, every micro-batch (no optimizer
    update: the trained state stays as it is), n times through the
    in-kernel route the Trainer takes and through the external-mask route
    (``make_fused_train_forward(in_kernel_dropout=False)``): the same
    kernel launches but for the blocks' counters, the keep-masks each
    draws from the generator, ms per step (CUDA events, eager), and each
    route's loss against the plain engine's on the same route from the
    same generator state (``loss_gate``)."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    cfg, state = trainer.cfg, trainer.state
    batch = next(iter(trainer.loader()))
    mb = BATCH // cfg.grad_accu_steps
    draws = MaskDraws()
    got = {}
    try:
        for seeded in (True, False):
            fwd = make_fused_train_forward(
                cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
                dropout_bits=cfg.dropout_bits, in_kernel_dropout=seeded,
                **route)

            def once():
                for p in state.model.parameters():
                    p.grad = None
                g = torch.Generator(device=dev).manual_seed(SEED + 9)
                total = 0.0
                for i in range(cfg.grad_accu_steps):
                    sl = slice(i * mb, (i + 1) * mb)
                    loss = bce_with_logits_sum(fwd(
                        state.model, batch["img"][sl], batch["ques"][sl], g),
                        batch["target"][sl])
                    loss.backward()
                    total = total + loss.detach()
                return total

            loss = float(once())
            plain_fwd = make_fused_train_forward(
                cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
                dropout_bits=cfg.dropout_bits, in_kernel_dropout=seeded,
                sga_block="plain", fused_encoder=route["fused_encoder"])
            plain, _ = engine_loss(
                torch, dev, cfg, plain_fwd, state.model, batch,
                torch.Generator(device=dev).manual_seed(SEED + 9)
                .get_state())
            label = "in-kernel dropout" if seeded else "external masks"
            rel = loss_gate(f"{tag} {label}", loss, plain)
            say(f"[{tag}] {label}: loss {loss:.6f}, the plain engine on the "
                f"same route {plain:.6f} (rel {rel:.2e} <= 1e-3)")
            torch.cuda.synchronize()
            draws.take()
            draws.active = True
            K.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                once()
            end.record()
            torch.cuda.synchronize()
            draws.active = False
            got[seeded] = (K.launch_counts(), *draws.take(),
                           start.elapsed_time(end) / n)
    finally:
        draws.close()
    for seeded, (counts, names, decisions, ms) in got.items():
        want = {k: c * n for k, c in
                expected_step_launches(cfg, route, seeded).items() if c}
        mine = {k: v for k, v in counts.items() if k in TRAIN_KERNELS}
        label = "in-kernel dropout" if seeded else "external masks"
        say(f"[{tag}] {label}: {sum(mine.values()) // n} kernel launches "
            f"per step, {len(names) // n} keep-masks drawn from the "
            f"generator per step ({decisions // n} keep decisions, 2 "
            f"PyTorch launches each at 32 bits), {ms:.3f} ms per forward + "
            f"backward (CUDA events, eager)")
        if mine != want:
            fail(f"{tag} {label}: launches {mine}, expected {want}")
    (_, seeded_names, _, _), (ext_counts, ext_names, _, _) = got[True], \
        got[False]
    if seeded_names != plain_site_masks(cfg, route) * cfg.grad_accu_steps \
            * n:
        fail(f"{tag}: the in-kernel route drew generator masks for "
             f"{sorted(set(seeded_names))}")
    rows.launches(f"{tag} external masks", ext_counts,
                  [k for k in BLOCK_COUNTERS if ext_counts.get(k)])


def train_main_path(torch, dev, rows, work: Path, model: str = "small",
                    steps: int = TRAIN_STEPS):
    """Trainer.train() for one epoch of `steps` steps at the model's full
    width: the fused engine's loss against the plain engine's at every
    step (the plain engine replays the step's micro-batches from the same
    generator state, and must leave it where the step leaves it), the
    exact launches of every step, bitwise repeatable gradients."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_route

    cfg = Config.for_model(model, max_epoch=1, batch_size=BATCH,
                           seed=SEED + 7, ckpts_dir=str(work / "ckpts"),
                           log_path=str(work / "log"), verbose=False)
    route = engine_route(cfg.hidden_size)
    ds = SyntheticVQADataset(cfg, size=steps * BATCH, answer_size=3129,
                             seed=SEED)
    trainer = Trainer(cfg, ds, device=dev)
    if not (trainer.fused and trainer.in_kernel_dropout):
        fail(f"the Trainer on the card chose fused={trainer.fused}, "
             f"in_kernel_dropout={trainer.in_kernel_dropout}")
    plain_fwd = make_fused_train_forward(
        cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
        sga_block="plain", fused_encoder=route["fused_encoder"],
        dropout_bits=cfg.dropout_bits, in_kernel_dropout=True)
    real_step = trainer.step_fn
    mb = BATCH // cfg.grad_accu_steps
    log = []
    draws = MaskDraws()

    def step(state, batch):
        """The Trainer's step, with the plain engine's loss on the same
        weights and generator state first (the step's own seed,
        ``seed_step``), micro-batch by micro-batch (no launch counts, not
        timed), the step's launch counts and its time by CUDA events."""
        state.seed_step()
        plain_loss, g = engine_loss(torch, dev, cfg, plain_fwd, state.model,
                                    batch, state.generator.get_state())
        before = K.launch_counts()
        draws.take()
        draws.active = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = real_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        draws.active = False
        after = K.launch_counts()
        log.append(dict(loss=float(metrics["loss"]), plain=plain_loss,
                        ms=start.elapsed_time(end),
                        same_draws=torch.equal(g.get_state(),
                                               state.generator.get_state()),
                        masks=draws.take()[0],
                        counts={k: after.get(k, 0) - before.get(k, 0)
                                for k in TRAIN_KERNELS}))
        return metrics

    trainer.step_fn = step
    tag = "train" if model == "small" else f"train {model}"
    say(f"[{tag}] Trainer(MCAN-{model}: hidden {cfg.hidden_size}, ff "
        f"{cfg.ff_size}, flat_out {cfg.flat_out_size}, lr_base "
        f"{cfg.lr_base}, batch {BATCH} in {cfg.grad_accu_steps} "
        f"micro-batch(es), 1 epoch of {steps} steps) on "
        f"SyntheticVQADataset(answer_size=3129); engine: "
        f"{route}")
    K.reset_launches()
    try:
        trainer.train()
    finally:
        draws.close()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    say(f"[launches] {tag}, {len(log)} steps: {counts}")
    if len(log) != steps:
        fail(f"{len(log)} train steps, expected {steps}")
    logged = (Path(cfg.log_path) / f"log_run_{cfg.run_version}.txt") \
        .read_text()
    line = [ln for ln in logged.splitlines() if "train engine" in ln]
    say(f"[{tag}] the Trainer logged: {line}")
    if not line or "in_kernel_dropout=True" not in line[0]:
        fail(f"{tag}: the Trainer did not log in_kernel_dropout=True")
    want = expected_step_launches(cfg, route, seeded=True)
    plain_masks = plain_site_masks(cfg, route) * cfg.grad_accu_steps
    if route["att_saves"]:
        rows.launches(tag, counts, [k for k in TRAIN_KERNELS
                                    if k not in LARGE_ROWS.values()
                                    and want[k]])
        rows.launches(tag, counts, LARGE_ROWS, key=LARGE_ROWS)
    else:
        rows.launches(tag, counts, [k for k in TRAIN_KERNELS if want[k]])
    for i, r in enumerate(log):
        if r["counts"] != want:
            fail(f"step {i}: launches {r['counts']}, expected {want}")
        if not r["same_draws"]:
            fail(f"step {i}: the step drew other dropout masks than its "
                 f"{cfg.grad_accu_steps} micro-batch forwards")
        if r["masks"] != plain_masks:
            fail(f"step {i}: generator masks {r['masks']}, expected only "
                 f"the plain sites' {plain_masks}")
        rel = loss_gate(f"{tag} step {i}", r["loss"], r["plain"])
        say(f"  step {i}: loss {r['loss']:.6f} (plain engine "
            f"{r['plain']:.6f}, rel {rel:.2e} <= 1e-3), {r['ms']:.3f} ms")
    blocks = (f"{cfg.layer} encoder blocks x (forward + backward) + " if
              route["fused_encoder"] else "")
    say(f"  every step ran {blocks}{cfg.layer} decoder blocks x "
        f"{cfg.grad_accu_steps} micro-batch(es) x (forward + FFN backward + "
        f"attention backward{' from saves' if route['att_saves'] else ''})"
        f" through the kernels with in-kernel dropout (one seed per block, "
        f"no keep-mask drawn for a kernel site: the generator drew only "
        f"{sorted(set(plain_masks))}), with the generator where the "
        f"micro-batch forwards leave it")
    ms = [r["ms"] for r in log[1:]]
    mean = sum(ms) / len(ms)
    say(f"[{tag}] step time (steps 2..{steps}, CUDA events): mean "
        f"{mean:.3f} ms, min {min(ms):.3f} ms -> {BATCH / mean * 1e3:.1f} "
        f"samples/s")

    # the same micro-batch twice from the same state and generator: equal
    # bits
    state = trainer.state
    batch = next(iter(trainer.loader()))
    gen_state = state.generator.get_state()

    def grads_once():
        for p in state.model.parameters():
            p.grad = None
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        loss = bce_with_logits_sum(trainer.forward_fn(
            state.model, batch["img"][:mb], batch["ques"][:mb], g),
            batch["target"][:mb])
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in
                               state.model.parameters()]

    l1, g1 = grads_once()
    l2, g2 = grads_once()
    if not (torch.equal(l1, l2) and all(torch.equal(a, b)
                                        for a, b in zip(g1, g2))):
        n_diff = sum(not torch.equal(a, b) for a, b in zip(g1, g2))
        fail(f"two runs of one step differ: loss {float(l1)} vs "
             f"{float(l2)}, {n_diff} of {len(g1)} gradients")
    say(f"[{tag}] two runs of one micro-batch: the loss and all {len(g1)} "
        f"parameter gradients equal bit for bit")
    compare_dropout_routes(torch, dev, trainer, route, tag, rows)
    ckpt = Path(cfg.ckpts_dir) / f"ckpt_{cfg.run_version}" / "epoch1.pkl"
    if not ckpt.exists():
        fail(f"no epoch checkpoint at {ckpt}")
    return trainer, ckpt


# ---------------------------------------------------------------------------
# phases [visualize] and [stacked]: the visualization's forward and the
# stacked parameter layout
# ---------------------------------------------------------------------------

VIS_EXAMPLES = 8
# card against CPU, plain ops with f32 operands: the same function up to
# summation order, |err| <= VIS_F32_TOL + VIS_F32_TOL |ref| elementwise
VIS_F32_TOL = 1e-3
# the bf16 engines' serving gate on the answer probabilities (PERF.md §2)
BF16_PROB_TOL = 1e-2
# calc_mats_v2's top-k regions may swap only where the card's glimpse
# weights v_w are this close (a near tie): a few times the v_w error the
# card read against the CPU, 2e-6 with f32 operands and 1.4e-4 with bf16
# ones (PERF.md §6, PR 26)
VIS_TIE = {"f32": 1e-5, "bf16": 1e-3}
STACKED_STEPS = 3


def top_k_agree(card_w, card_ix, cpu_ix, tol) -> bool:
    """calc_mats_v2's top-k regions: the same indices in the same order, or
    a swap between regions whose weights are within tol (a near tie)."""
    if list(card_ix) == list(cpu_ix):
        return True
    return all(abs(float(card_w[a]) - float(card_w[b])) <= tol
               for a, b in zip(card_ix, cpu_ix) if a != b)


def visualize_path(torch, dev, work: Path, vqa_ckpt: Path) -> None:
    """``run_vqa --run visualize``'s forward at MCAN-small's full width:
    [train]'s epoch pickle warm-started into a Trainer over a miniature
    VQA-v2 val set in its own file formats (``data/vqa_files.py``; the
    embedding of its own vocabulary), ``utils/visualize.
    visualization_outputs`` on the card for the first 8 examples against
    the same weights' ``forward_outputs`` on the CPU, twice:

      * with f32 matmul operands on both sides (``operand_dtype``): the
        same function up to summation order, every key within VIS_F32_TOL
        + VIS_F32_TOL |ref| elementwise, the masks exactly;
      * as the sheets read it, bf16 operands: a rounding one step apart
        compounds over 12 blocks (the stream ``v`` of random weights read
        1.16e-2 against 4.04), so each key's error is printed, and the
        gates are the bf16 engines' serving gate on the answer
        probabilities (BF16_PROB_TOL) and the masks exactly.

    In both passes ``calc_mats_v2``'s top-k regions are the same on the
    card and the CPU, or swap only within a near tie of VIS_TIE.

    The sheets render where matplotlib is installed."""
    import copy
    from importlib.util import find_spec

    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import VQADataset
    from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files
    from mcan_vqa_tpu_torch.models.layers import operand_dtype
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    from mcan_vqa_tpu_torch.utils import visualize as vis

    render = find_spec("matplotlib") is not None
    say(f"[visualize] matplotlib installed: {render}")
    paths = write_vqa_files(str(work / "vqa"), images={"train": 1, "val": 4,
                                                       "test": 1}, seed=SEED)
    cfg = Config(**paths, vocab_cache_path=str(work / "vocab.npz"),
                 ckpts_dir=str(work / "ckpts"), log_path=str(work / "log"),
                 verbose=False)
    ds = VQADataset(cfg, "val")
    trainer = Trainer(cfg, eval_datasets={"val": ds}, device=dev)
    trainer.warm_start(str(vqa_ckpt))
    cpu = copy.deepcopy(trainer.model).cpu().eval()
    n = min(VIS_EXAMPLES, len(ds))
    img = torch.tensor(np.stack([ds.example(i)["img"] for i in range(n)]))
    ques = torch.tensor(np.stack([ds.example(i)["ques"] for i in range(n)]))

    def both():
        out = vis.visualization_outputs(trainer, ds, VIS_EXAMPLES)
        with torch.no_grad():
            ref = {k: v.numpy() for k, v in
                   cpu.forward_outputs(img, ques).items()}
        if set(out) != set(ref) or len(out) != 8:
            fail(f"[visualize] keys {sorted(out)} vs {sorted(ref)}")
        for k in sorted(out):
            if out[k].shape != ref[k].shape:
                fail(f"[visualize] {k}: {out[k].shape} vs {ref[k].shape}")
            if out[k].dtype == bool and not np.array_equal(out[k], ref[k]):
                fail(f"[visualize] the {k} masks differ")
            if out[k].dtype != bool and not np.isfinite(out[k]).all():
                fail(f"[visualize] {k} is not finite")
        return out, ref

    def top_k(out, ref, operands):
        tie = VIS_TIE[operands]
        for i in range(n):
            a, b = vis.calc_mats_v2(out, i), vis.calc_mats_v2(ref, i)
            if not top_k_agree(out["v_w"][i, :, 0], a["va_indices"],
                               b["va_indices"], tie):
                fail(f"[visualize] {operands} operands, example {i}: top-k "
                     f"regions {list(a['va_indices'])} vs "
                     f"{list(b['va_indices'])}")
        say(f"  {operands} operands: calc_mats_v2's top-"
            f"{len(a['va_indices'])} regions agree for all {n} examples "
            f"(a swap allowed only within {tie} of v_w)")

    def used(a, b, tol):
        return float((np.abs(a - b) / (tol + tol * np.abs(b))).max())

    say(f"[visualize] forward_outputs of {n} val examples (vocabulary "
        f"{ds.token_size}, [train]'s weights but the embedding) on the card "
        f"against the same weights on the CPU; the masks equal")
    with operand_dtype(torch.float32):
        out, ref = both()
    for k in sorted(k for k in out if out[k].dtype != bool):
        u = used(out[k], ref[k], VIS_F32_TOL)
        say(f"  f32 operands, {k}: max|err| "
            f"{float(np.abs(out[k] - ref[k]).max()):.3e}; |err| <= "
            f"{VIS_F32_TOL} + {VIS_F32_TOL} |ref| elementwise, at most "
            f"{u:.3f} of it {'ok' if u <= 1.0 else 'FAILED'}")
        if u > 1.0:
            fail(f"[visualize] f32 operands: {k} past {VIS_F32_TOL} + "
                 f"{VIS_F32_TOL} |ref|")
    top_k(out, ref, "f32")
    out, ref = both()
    say("  bf16 operands (as the sheets read them): "
        + ", ".join(f"{k} max|err| {float(np.abs(out[k] - ref[k]).max()):.3e}"
                    f" of max|ref| {float(np.abs(ref[k]).max()):.3e}"
                    for k in sorted(out) if out[k].dtype != bool))
    dprob = float(np.abs(1 / (1 + np.exp(-out["logits"]))
                         - 1 / (1 + np.exp(-ref["logits"]))).max())
    gate("[visualize] bf16 operands, answer probabilities", dprob,
         BF16_PROB_TOL)
    top_k(out, ref, "bf16")
    if render:
        for i in range(n):
            vis.visualize_example(out, i, str(work / f"example_{i}.png"))
            vis.render_reference_panels(out, i,
                                        str(work / f"example_{i}_mats.png"))
        say(f"[visualize] rendered {2 * n} sheets")
    else:
        say("[visualize] rendered nothing: matplotlib is not installed")


def stacked_path(torch, dev, rows, work: Path) -> None:
    """``stacked_params="on"`` on the card: two Trainers of MCAN-small from
    the same weights and seed, the standard layout and the stacked one,
    train STACKED_STEPS steps of B=64 (one epoch) on the seeded route;
    every weight and AdamW moment equal bit for bit, the same kernel
    launches a step. Then the stacked run's epoch pickle (written through
    the standard boundary) resumed by a standard Trainer: the weights and
    moments equal."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_route

    def config(tag, **kw):
        return Config(max_epoch=1, batch_size=BATCH, seed=SEED + 9,
                      version=tag, ckpts_dir=str(work / "ckpts"),
                      log_path=str(work / "log"), verbose=False,
                      ckpt_calibrate=False, **kw)

    runs, counts, times = {}, {}, {}
    for tag, on in (("standard", "off"), ("stacked", "on")):
        cfg = config(tag, stacked_params=on)
        ds = SyntheticVQADataset(cfg, size=STACKED_STEPS * BATCH,
                                 answer_size=3129, seed=SEED)
        trainer = Trainer(cfg, ds, device=dev)
        if not (trainer.fused and trainer.in_kernel_dropout) or \
                trainer.stacked != (on == "on"):
            fail(f"[stacked] {tag}: fused {trainer.fused}, in-kernel "
                 f"dropout {trainer.in_kernel_dropout}, stacked "
                 f"{trainer.stacked}")
        K.reset_launches()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t0
        counts[tag] = {k: v for k, v in K.launch_counts().items()
                       if k in TRAIN_KERNELS}
        runs[tag] = trainer
    std, stk = runs["standard"], runs["stacked"]
    route = engine_route(std.cfg.hidden_size)
    want = {k: n * STACKED_STEPS for k, n in expected_step_launches(
        std.cfg, route, seeded=True).items() if n}
    n_leaves = len(list(stk.stacked_state().model.parameters()))
    say(f"[stacked] MCAN-small, B={BATCH}, {STACKED_STEPS} steps each on "
        f"the seeded route: standard ({len(list(std.model.parameters()))} "
        f"leaves) {times['standard']:.1f} s, stacked ({n_leaves} leaves) "
        f"{times['stacked']:.1f} s with the epoch pickle")
    for tag, c in counts.items():
        say(f"[launches] stacked phase, {tag}: {c}")
        if c != want:
            fail(f"[stacked] {tag}: launches {c}, expected {want}")
    rows.launches("stacked", counts["stacked"], sorted(want))

    def moments(trainer):
        names = [n for n, _ in trainer.model.named_parameters()]
        return {(names[int(i)], m): s[m] for i, s in
                trainer.state.optimizer.state_dict()["state"].items()
                for m in ("exp_avg", "exp_avg_sq")}

    def same(a_sd, b_sd, what):
        bad = [k for k in a_sd if not torch.equal(a_sd[k], b_sd[k])]
        say(f"  {what}: {len(a_sd) - len(bad)} of {len(a_sd)} equal bit "
            f"for bit")
        if bad or set(a_sd) != set(b_sd):
            fail(f"[stacked] {what} differ: {bad[:4]}")

    if not std.state.step == stk.state.step == STACKED_STEPS:
        fail(f"[stacked] steps {std.state.step} / {stk.state.step}")
    same(std.model.state_dict(), stk.model.state_dict(),
         "weights, standard vs stacked")
    same(moments(std), moments(stk), "AdamW moments, standard vs stacked")
    resumed = Trainer(config("stacked", stacked_params="off", resume=True,
                             ckpt_epoch=1),
                      SyntheticVQADataset(std.cfg, size=STACKED_STEPS * BATCH,
                                          answer_size=3129, seed=SEED),
                      device=dev)
    resumed.ensure_state()
    same(stk.model.state_dict(), resumed.model.state_dict(),
         "weights, the stacked run vs its pickle resumed standard")
    same(moments(stk), moments(resumed),
         "AdamW moments, the stacked run vs its pickle resumed standard")


# ---------------------------------------------------------------------------
# phase [per-sub-op]: the per-sub-op serving path (sga_mode=0) and the
# widened kernels
# ---------------------------------------------------------------------------

TPU_FFN = "mcan_vqa_tpu/ops/fused_ffn.py"
TPU_ATT = "mcan_vqa_tpu/ops/masked_attention.py"
SERVE_MODE0 = "one B=64 mode-0 serving forward (bf16 stream)"
EACH_SHAPE = "one call at each shape of the row"
SUB_OP_KERNELS = ("gemm_ln", "gemm_bias_act", "masked_attention_f32",
                  "attflat_pool")


def mode0_launches(L: int, use_pallas, flat: bool):
    """Every kernel's launches in one forward of the per-sub-op engine
    (bf16 stream, use_pallas_ffn): per layer pair 3 merges + 2 FFNs on
    gemm_ln and 2 first FFN products on gemm_bias_act; 3 attentions on
    the kernel under use_pallas; each AttFlat's MLP product, attflat_pool
    and merge under the AttFlat switch, which use_pallas also turns on
    (serving.py:545)."""
    flat = bool(use_pallas or flat)
    counts = {"gemm_ln": 5 * L, "gemm_bias_act": 2 * L + 4 * flat,
              "masked_attention_f32": 3 * L if use_pallas else 0,
              "attflat_pool": 2 * flat}
    return {k: n for k, n in counts.items() if n}


def gemm_ln_work(M, Kd, D, a_size, res_size):
    """(operations, bytes) of one gemm_ln: the product, the residual and
    the LN; a, W, bias / gamma / beta, res read once, out written once."""
    return (2 * M * Kd * D + 10 * M * D,
            a_size * M * Kd + 2 * Kd * D + 12 * D + 2 * res_size * M * D)


def check_sub_op_kernels(torch, dev, rows) -> None:
    """gemm_ln and attflat_pool against their plain versions at the
    MCAN-small B=64 shapes of the per-sub-op path (both stream dtypes; D
    1024 / 1536 / 2048; B = 1), each with its plan and two runs' bits
    compared, and the repaired shapes of the older kernels: gemm_bias_act
    at N 480, the attention forward and backward at Dh 192 / 256 and 160
    / 608 rows (the long kernels), gemm_s4 /
    gemm_w4bf16 at K 384; each with its time, its plain version's, a
    library call's where one computes the function, and its bound."""
    from mcan_vqa_tpu_torch.cli.bench_attention import sdpa_backward_ms
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.quant import _quant_w4
    from mcan_vqa_tpu_torch.ops._build import load_library
    lib = load_library()
    kc = KernelCheck(torch, dev, rows, SEED + 70)
    bf16, f32 = torch.bfloat16, torch.float32
    F_ = torch.nn.functional
    rows.row("gemm_ln", SRC + "gemm_ln.cu", f"{TPU_FFN}:100", SERVE_MODE0)
    rows.row("attflat_pool", SRC + "attflat_pool.cu",
             "mcan_vqa_tpu/ops/attflat.py:72", SERVE_MODE0)
    rows.row("masked_attention, f32 q", SRC + "masked_attention.cu",
             f"{TPU_ATT}:118", SERVE_MODE0)
    rows.row("gemm_bias_act, AttFlat", SRC + "gemm_sm90.cu",
             "mcan_vqa_tpu/ops/attflat.py:72", SERVE_MODE0)
    rows.row("gemm_bias_act, N 480", SRC + "gemm_sm90.cu", f"{TPU}:285",
             EACH_SHAPE)
    rows.row("masked_attention, long", SRC + "masked_attention.cu",
             f"{TPU_ATT}:118", EACH_SHAPE)
    rows.row("masked_attention_bwd, long", SRC + "masked_attention_bwd.cu",
             f"{TPU_TRAIN}:1139", EACH_SHAPE)
    rows.row("gemm_s4, K 384", SRC + "gemm_int4.cu", f"{TPU_QUANT}:282",
             EACH_SHAPE)
    rows.row("gemm_w4bf16, K 384", SRC + "gemm_int4.cu",
             f"{TPU_QUANT}:307", EACH_SHAPE)
    say("[per-sub-op] gemm_ln and attflat_pool vs their plain versions "
        "(times: the launches of one B=64 mode-0 forward), and the repaired "
        "shapes of the older kernels (times: one call each)")

    def weight(k, n):
        return (kc.randn(k, n) / k ** 0.5).to(bf16)

    # --- gemm_ln: (label, M, K, D, a dtype, stream, launches per forward)
    cases = [("dec merge", BATCH * 60, 512, 512, f32, bf16, 12),
             ("enc merge", BATCH * 14, 512, 512, f32, bf16, 6),
             ("dec ffn", BATCH * 60, 2048, 512, bf16, bf16, 6),
             ("enc ffn", BATCH * 14, 2048, 512, bf16, bf16, 6),
             ("dec merge, f32 stream", BATCH * 60, 512, 512, f32, f32, 0),
             ("dec ffn, f32 stream", BATCH * 60, 2048, 512, bf16, f32, 0),
             ("B=1 dec merge", 60, 512, 512, f32, bf16, 0),
             ("B=1 enc ffn", 14, 2048, 512, bf16, bf16, 0),
             ("D 1024 merge", 32 * 60, 1024, 1024, f32, bf16, 0),
             ("D 1024 ffn", 32 * 60, 4096, 1024, bf16, f32, 0),
             ("D 1536 merge", 8 * 60, 1536, 1536, f32, bf16, 0),
             ("D 1536 ffn", 8 * 60, 6144, 1536, bf16, bf16, 0),
             ("D 2048 merge", 8 * 60, 2048, 2048, f32, f32, 0),
             ("D 2048 ffn", 8 * 60, 8192, 2048, bf16, bf16, 0),
             ("D 480 ragged M=61", 61, 480, 480, f32, bf16, 0)]
    for label, M, Kd, D, adt, sdt, n in cases:
        a = kc.randn(M, Kd, dtype=adt)
        if adt == bf16:
            a = a.relu()                    # the FFN reads the ReLU hidden
        w, b = weight(Kd, D), kc.randn(D, s=0.1)
        res = kc.randn(M, D, dtype=sdt)
        gamma, beta = 1 + kc.randn(D, s=0.1), kc.randn(D, s=0.1)
        ops, nbytes = gemm_ln_work(M, Kd, D, a.element_size(),
                                   res.element_size())
        gemm_ln_plan_note(K, lib, label, M, Kd, D, adt == f32)
        # f32 out: the same exact bf16 products summed in another order,
        # then an LN of O(1) values; bf16: one rounding a step apart
        kc.case("gemm_ln", f"{label} [{M}x{Kd}]x[{Kd}x{D}]",
                lambda: (K.gemm_ln(a, w, b, res, gamma, beta),),
                lambda: (K.gemm_ln_plain(a, w, b, res, gamma, beta),),
                (1e-4 if sdt == f32 else 8e-3,), n, ops, nbytes,
                timed=n > 0 or label.startswith("B=1"))
        same_bits(f"gemm_ln {label}",
                  (K.gemm_ln(a, w, b, res, gamma, beta),),
                  (K.gemm_ln(a, w, b, res, gamma, beta),))

    # --- attflat_pool: (label, L, x dtype, launches per forward)
    for label, L, xdt, n in (("img", 60, bf16, 1), ("lang", 14, bf16, 1),
                             ("img, f32 stream", 60, f32, 0)):
        B, D, Fm = BATCH, 512, 512
        x = kc.randn(B, L, D, dtype=xdt)
        h = kc.randn(B * L, Fm).relu().to(bf16)
        w2, b2 = weight(Fm, 1), kc.randn(1, s=0.1)
        mask = pad_mask(torch, B, L, [(i * 7) % (L + 1) for i in range(B)],
                        dev).contiguous()           # sample 0 fully padded
        ops = 2 * B * L * Fm + 2 * B * L * D + 10 * B * L
        nbytes = (2 * B * L * Fm + 2 * Fm + 4 + B * L
                  + x.element_size() * B * L * D + 2 * B * D + 4 * B * L)
        # att: f32 logits of exact bf16 products, one softmax: 1e-5 of its
        # scale (<= 1); pooled: plus one bf16 rounding a step apart
        kc.case("attflat_pool", f"{label} B={B} L={L}",
                lambda: K.attflat_pool(h, w2, b2, mask, x),
                lambda: K.attflat_pool_plain(h, w2, b2, mask, x),
                (8e-3, 1e-5), n, ops, nbytes, tensor=False, timed=n > 0)
        out = K.attflat_pool(h, w2, b2, mask, x)[1][0]
        gate(f"attflat_pool {label}: the fully padded sample's softmax is "
             f"uniform", max_err(out, torch.full_like(out, 1.0 / L)), 1e-6)
        p = K.attflat_plan(B, L, 1, D)
        say(f"    [plan] attflat_pool {label}: {p.ranks} CTAs a sample "
            f"(grid {p.grid}), {p.chunk} columns each, {p.smem} bytes of "
            f"shared memory")
        same_bits(f"attflat_pool {label}", K.attflat_pool(h, w2, b2, mask, x),
                  K.attflat_pool(h, w2, b2, mask, x))

    # --- the mode-0 attention (masked_attention_pallas and its variants):
    # q, k, v f32 views of the plain projections, f32 out
    H, D = 8, 512
    for label, Lq, Lk, cross in (("enc self 14x14", 14, 14, False),
                                 ("dec self 60x60", 60, 60, False),
                                 ("dec cross 60x14", 60, 14, True)):
        B = BATCH
        if cross:
            q = kc.randn(B * Lq, D).view(B, Lq, H, D // H).transpose(1, 2)
            kv = kc.randn(B * Lk, 2 * D).view(B, Lk, 2 * D)
            k, v = (t.view(B, Lk, H, D // H).transpose(1, 2)
                    for t in kv.split(D, dim=-1))
        else:
            qkv = kc.randn(B * Lq, 3 * D).view(B, Lq, 3 * D)
            q, k, v = (t.view(B, Lq, H, D // H).transpose(1, 2)
                       for t in qkv.split(D, dim=-1))
        mask = pad_mask(torch, B, Lk, [(i * 5) % (Lk + 1) for i in range(B)],
                        dev)
        q16, k16, v16 = q.to(bf16), k.to(bf16), v.to(bf16)
        attention_plan_note(K, f"f32 q {label}", q, k)
        kc.case("masked_attention, f32 q", f"{label} B={B}",
                lambda: (K.masked_attention(q, k, v, mask, out_dtype=f32),),
                lambda: (K.masked_attention_plain(q, k, v, mask,
                                                  out_dtype=f32),),
                (8e-3,), 6, 4 * B * H * Lq * Lk * (D // H),
                4 * B * H * (Lq + 2 * Lk) * (D // H) + B * Lk
                + 4 * B * Lq * D,
                lib=lambda: F_.scaled_dot_product_attention(
                    q16, k16, v16, attn_mask=~mask))

    # --- AttFlat's two products on gemm_bias_act (the MLP's first, ReLU,
    # bf16 out; the merge, f32 out), per AttFlat of one forward
    for label, M, Kd, N, relu, odt in (
            ("img mlp", BATCH * 60, 512, 512, True, bf16),
            ("lang mlp", BATCH * 14, 512, 512, True, bf16),
            ("img merge", BATCH, 512, 1024, False, f32),
            ("lang merge", BATCH, 512, 1024, False, f32)):
        a, w, b = kc.randn(M, Kd, dtype=bf16), weight(Kd, N), kc.randn(N)
        b16 = b.to(bf16)
        kc.case("gemm_bias_act, AttFlat", f"{label} [{M}x{Kd}]x[{Kd}x{N}]",
                lambda: (K.gemm_bias_act(a, w, b, relu=relu, out_dtype=odt),),
                lambda: (K.gemm_bias_act_plain(a, w, b, relu=relu,
                                               out_dtype=odt),),
                (1e-4 if odt == f32 else 8e-3,), 1, 2 * M * Kd * N,
                gemm_bytes(M, Kd, N, bias=True,
                           out=(4 if odt == f32 else 2,)),
                lib=lambda: torch.addmm(b16, a, w))

    # --- gemm_bias_act at hidden 480 (8 heads of 60): N % 64 != 0
    for label, M, Kd, N, relu, odt in (
            ("qkv", BATCH * 60, 480, 1440, False, bf16),
            ("merge", BATCH * 60, 480, 480, False, f32),
            ("ffn1", BATCH * 60, 480, 1920, True, bf16),
            ("ffn2", BATCH * 60, 1920, 480, False, f32)):
        a, w, b = kc.randn(M, Kd, dtype=bf16), weight(Kd, N), kc.randn(N)
        b16 = b.to(bf16)
        kc.case("gemm_bias_act, N 480", f"{label} [{M}x{Kd}]x[{Kd}x{N}]",
                lambda: (K.gemm_bias_act(a, w, b, relu=relu, out_dtype=odt),),
                lambda: (K.gemm_bias_act_plain(a, w, b, relu=relu,
                                               out_dtype=odt),),
                (1e-4 if odt == f32 else 8e-3,), 1, 2 * M * Kd * N,
                gemm_bytes(M, Kd, N, bias=True,
                           out=(4 if odt == f32 else 2,)),
                lib=lambda: torch.addmm(b16, a, w))

    # --- the long attention kernels: (label, B, H, Lq, Lk, Dh, q dtype,
    # kv dtype, out dtype)
    for label, B, H, Lq, Lk, Dh, qdt, kvdt, odt in (
            ("Dh 192 self 160x160 (hidden 1536)", 8, 8, 160, 160, 192, f32,
             f32, f32),
            ("Dh 256 cross 60x14 (hidden 2048)", 8, 8, 60, 14, 256, bf16,
             f32, bf16),
            ("Dh 64 self 608x608 (grid features)", 8, 8, 608, 608, 64, bf16,
             bf16, bf16),
            ("Dh 256 cross 608x14", 8, 8, 608, 14, 256, bf16, f32, f32)):
        q = kc.randn(B, H, Lq, Dh, dtype=qdt)
        k, v = kc.randn(B, H, Lk, Dh, dtype=kvdt), kc.randn(B, H, Lk, Dh,
                                                             dtype=kvdt)
        mask = pad_mask(torch, B, Lk, [(i * 37) % (Lk + 1) for i in range(B)],
                        dev)                        # sample 0 fully padded
        q16, k16, v16 = q.to(bf16), k.to(bf16), v.to(bf16)
        qs, kvs, osz = q.element_size(), k.element_size(), (
            4 if odt == f32 else 2)
        nbytes = (qs * B * H * Lq * Dh + 2 * kvs * B * H * Lk * Dh + B * Lk
                  + osz * B * Lq * H * Dh)
        attention_plan_note(K, label, q, k)
        kc.case("masked_attention, long", label,
                lambda: (K.masked_attention(q, k, v, mask, out_dtype=odt),),
                lambda: (K.masked_attention_plain(q, k, v, mask,
                                                  out_dtype=odt),),
                (8e-3,), 1, 4 * B * H * Lq * Lk * Dh, nbytes,
                lib=lambda: F_.scaled_dot_product_attention(
                    q16, k16, v16, attn_mask=~mask))
        # the backward at the same shape, with a dropout mask
        dout = kc.randn(B, Lq, H * Dh, dtype=bf16)
        drop = kc.keep(B, H, Lq, Lk).to(torch.uint8)
        attention_bwd_plan_note(K, label, q16, k)

        def grads(fn, q=q16, k=k, v=v, mask=mask, dout=dout, drop=drop):
            dq = torch.empty(q.shape, device=dev)
            dk, dv = torch.empty(k.shape, device=dev), torch.empty(
                k.shape, device=dev)
            fn(q, k, v, mask, dout, dq, dk, dv, drop=drop, inv_keep=1 / 0.9)
            return dq, dk, dv

        d4 = dout.view(B, Lq, H, Dh).transpose(1, 2)
        nb = (2 * B * H * Lq * Dh + 2 * kvs * B * H * Lk * Dh + B * Lk
              + B * H * Lq * Lk + 2 * B * Lq * H * Dh + 4 * B * H * Lq * Dh
              + 8 * B * H * Lk * Dh)
        # dS rounded to bf16 may land a step apart: 2^-7 of each output's
        # scale
        kc.case("masked_attention_bwd, long", label,
                lambda: grads(K.masked_attention_bwd),
                lambda: grads(K.masked_attention_bwd_plain),
                (2 ** -7,) * 3, 1, 10 * B * H * Lq * Lk * Dh, nb, timed=False)
        t_k = device_ms(torch, lambda: grads(K.masked_attention_bwd))
        t_p = device_ms(torch, lambda: grads(K.masked_attention_bwd_plain),
                        iters=5)
        # SDPA's backward: one autograd call, graphed as the kernel
        t_l = sdpa_backward_ms(torch, q16, k16, v16, mask, d4)
        if t_l is None:
            rows.unmeasured("masked_attention_bwd, long")
        flops = 10 * B * H * Lq * Lk * Dh
        say(f"    backward {t_k:.4f} ms vs plain {t_p:.4f} ms, sdpa backward "
            f"{t_l} ms; bound "
            f"{max(bound_parts(flops, nb)):.4f} ms")
        rows.add("masked_attention_bwd, long", 1, t_k, t_p, flops, nb, t_l)

    # --- int4 at K 384 (hidden 384, level 5 / 7): a scale group straddles
    # the nibble halves
    for site, M, Kd, N, relu in (("qkv B=1", 60, 384, 1152, False),
                                 ("w1 B=64", BATCH * 60, 384, 1536, True),
                                 ("w2 B=64", BATCH * 60, 1536, 384, False)):
        w = kc.randn(Kd, N) / Kd ** 0.5
        q4 = _quant_w4(w.to(bf16))
        wp, s4 = q4["w_p"], q4["w_gscale"]
        bias = kc.randn(N, s=0.1)
        x = kc.randn(M, Kd)
        a = float(x.abs().max()) / 127.0 * 1.1
        xq, _ = K.quantize_rows(x, 1.0 / a)
        xb = x.to(bf16)
        ops = 2 * M * Kd * N
        out = K.gemm_s4(xq, wp, s4, bias, a=a, relu=relu)[0]
        ref = K.gemm_s4_plain(xq, wp, s4, bias, a=a, relu=relu)[0]
        torch.cuda.synchronize()
        err = max_err(out, ref)
        gate(f"gemm_s4, K 384 {site} [{M}x{Kd}]x[{Kd}x{N}] (bit for bit)",
             err, 0.0)
        rows.err("gemm_s4, K 384", err)
        t4 = device_ms(torch, lambda: K.gemm_s4(xq, wp, s4, bias, a=a,
                                                relu=relu))
        t4p = device_ms(torch, lambda: K.gemm_s4_plain(
            xq, wp, s4, bias, a=a, relu=relu), iters=5)
        say(f"    time {t4:.4f} ms vs plain {t4p:.4f} ms; bound "
            f"{max(bound_parts(0.0, w4_bytes(M, Kd, N, 1, 4), int8_ops=ops)):.4f}"
            f" ms (library none)")
        rows.add("gemm_s4, K 384", 1, t4, t4p, 0.0, w4_bytes(M, Kd, N, 1, 4),
                 int8_ops=ops)
        kc.case("gemm_w4bf16, K 384", f"{site} [{M}x{Kd}]x[{Kd}x{N}]",
                lambda: (K.gemm_w4bf16(xb, wp, s4, bias, relu=relu),),
                lambda: (K.gemm_w4bf16_plain(xb, wp, s4, bias, relu=relu),),
                (1e-4,), 1, ops, w4_bytes(M, Kd, N, 2, 4))


def serve_per_sub_op(torch, dev, state_dict, cfg, plain, requests,
                     n_answers, rows) -> None:
    """``build_production_engine(qffn=0, sga_mode=0)`` at MCAN-small full
    depth and width on the requests of [serve], for each use_pallas
    (False, True, "batched", "packed") x use_pallas_attflat: exact launch
    counts per forward and agreement with the plain engine within the
    bf16 bound (1e-2); then the mode-0 and mode-2 bf16 forwards timed at
    B = 1, 8 and 64 in turns."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    L, H = cfg.layer, cfg.multi_head
    n_fwd = len(requests)
    engine = functools.partial(padded_engine, torch, dev)
    say(f"[per-sub-op] build_production_engine(qffn=0, sga_mode=0): "
        f"{L}+{L} layers, hidden {cfg.hidden_size}, bf16 stream, every "
        f"merge and FFN on gemm_ln")
    timed = {}
    for use_pallas in (False, True, "batched", "packed"):
        for flat in (False, True):
            fwd, prep = build_production_engine(
                state_dict, L, H, qffn=0, sga_mode=0, device=dev,
                use_pallas=use_pallas, use_pallas_attflat=flat)
            call = engine(fwd, prep)
            label = f"mode 0, use_pallas={use_pallas!r}, attflat={flat}"
            K.reset_launches()
            probs = [call(*plain.pad_batch(qs, fs))[:len(qs)].cpu().numpy()
                     for qs, fs in requests]
            torch.cuda.synchronize()
            counts = K.launch_counts()
            check_launches(label, counts, mode0_launches(
                L, use_pallas, flat), n_fwd)
            agreement(label, requests, probs, plain, n_answers, bound=1e-2)
            if use_pallas is True and flat:
                rows.launches("serve mode 0", counts, SUB_OP_KERNELS)
                rows.launches("serve mode 0", dict(
                    counts, **{"gemm_bias_act, AttFlat": 2 * counts.get(
                        "attflat_pool", 0)}),
                    ("masked_attention, f32 q", "gemm_bias_act, AttFlat"),
                    {"masked_attention, f32 q": "masked_attention_f32",
                     "gemm_bias_act, AttFlat": "gemm_bias_act, AttFlat"})
                timed["mode 0 (kernel attention and AttFlat)"] = call
            elif use_pallas is False and not flat:
                timed["mode 0 (plain attention)"] = call
    fwd, prep = build_production_engine(state_dict, L, H, qffn=0, device=dev)
    timed["mode 2 (bf16)"] = engine(fwd, prep)
    say("[per-sub-op] bf16 forwards, mode 0 against mode 2:")
    time_forwards(torch, cfg, plain, list(timed.items())[::-1])


WIDE_LAYERS = 2         # depth cut: the kernels' shapes do not depend on it


def check_wide_widths(torch, dev, vocab, ix_to_ans, rows) -> None:
    """Widths past the old envelope, 2 layers each, every path with exact
    launch counts and against the plain engine: a default Predictor at
    hidden 1536 and 2048 (8 heads) routes to mode 0 (no ``_mk``, every
    merge and FFN on gemm_ln); at 1536 the mode-0 engine with the kernel
    attention (Dh 192: the long kernel); hidden 480 (gemm_bias_act at N
    480) on the bf16 engine; hidden 384 at int4 levels 5 and 7 (K 384),
    held to the int4 bound; 160 image rows on the default Predictor
    (level 1: the long kernel in the decoder's attention)."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    n_ans = len(ix_to_ans)
    kw = dict(ix_to_ans=ix_to_ans, max_batch=BATCH,
              latency_buckets=LATENCY_BUCKETS, device=dev)
    for label, over in (("hidden 1536", dict(hidden_size=1536)),
                        ("hidden 2048", dict(hidden_size=2048)),
                        ("hidden 480", dict(hidden_size=480)),
                        ("hidden 384", dict(hidden_size=384)),
                        ("160 image rows", dict(img_feat_pad_size=160))):
        cfg = Config.for_model("small", layer=WIDE_LAYERS, **over)
        L, H = cfg.layer, cfg.multi_head
        sd = MCANet(cfg, len(vocab), n_ans, generator=torch.Generator()
                    .manual_seed(SEED + 51)).state_dict()
        rng = np.random.default_rng(SEED + 52)
        requests = make_requests(rng, cfg)
        n_fwd = len(requests)
        plain = Predictor(cfg, sd, vocab, engine="plain", **kw)
        say(f"[wide] {label}: {L} layers, hidden {cfg.hidden_size}, ff "
            f"{cfg.ff_size}, {H} heads of {cfg.hidden_size // H}, up to "
            f"{cfg.img_feat_pad_size} regions")

        def serve(name, call, want, bound=1e-2, on="sigmoid", path=None,
                  names=(), key=None):
            K.reset_launches()
            probs = [call(qs, fs) for qs, fs in requests]
            torch.cuda.synchronize()
            counts = K.launch_counts()
            check_launches(f"{label}, {name}", counts, want, n_fwd)
            agreement(f"{label}, {name}", requests, probs, plain, n_ans,
                      bound, on)
            if path:
                rows.launches(path, counts, names, key)

        def padded(fwd, prep):
            call = padded_engine(torch, dev, fwd, prep)
            return lambda qs, fs: call(*plain.pad_batch(qs, fs))[
                :len(qs)].cpu().numpy()

        if cfg.hidden_size >= 1536:
            p = Predictor(cfg, sd, vocab, **kw)
            if "_mk" in p.params["backbone"]["enc_0"]:
                fail(f"{label}: the default Predictor built mode-2 layouts")
            serve("default Predictor (mode 0)", p.predict_probs,
                  mode0_launches(L, False, False),
                  path=f"wide {label}", names=("gemm_ln",))
            del p
            if cfg.hidden_size == 1536:
                fwd, prep = build_production_engine(
                    sd, L, H, qffn=0, sga_mode=0, use_pallas=True,
                    device=dev)
                serve("mode 0, use_pallas=True (Dh 192)", padded(fwd, prep),
                      mode0_launches(L, True, True), path=f"wide {label}",
                      names=("masked_attention, long", "attflat_pool"),
                      key={"masked_attention, long": "masked_attention_f32",
                           "attflat_pool": "attflat_pool"})
        elif cfg.hidden_size == 480:
            fwd, prep = build_production_engine(sd, L, H, qffn=0,
                                                device=dev)
            serve("bf16 (qffn=0)", padded(fwd, prep), serve_launches(L, 0),
                  path=f"wide {label}", names=("gemm_bias_act, N 480",),
                  key={"gemm_bias_act, N 480": "gemm_bias_act"})
        elif cfg.hidden_size == 384:
            p5 = Predictor(cfg, sd, vocab, engine="int4", **kw)
            for qs, fs in requests:
                p5.predict_probs(qs, fs)
            p5.calibrate_now()
            serve("int4 level 5", p5.predict_probs, serve_launches(L, 5),
                  INT4_BOUND, "softmax", path=f"wide {label}",
                  names=("gemm_s4, K 384",),
                  key={"gemm_s4, K 384": "gemm_s4"})
            fwd, prep = build_production_engine(
                sd, L, H, qffn=7, act_scales=p5.act_scales, device=dev)
            serve("int4 level 7", padded(fwd, prep), serve_launches(L, 7),
                  INT4_BOUND, "softmax", path=f"wide {label} level 7",
                  names=("gemm_w4bf16, K 384",),
                  key={"gemm_w4bf16, K 384": "gemm_w4bf16"})
            del p5
        else:
            p = Predictor(cfg, sd, vocab, **kw)
            serve("level 1 (default Predictor)", p.predict_probs,
                  serve_launches(L, 1))
            fwd, prep = build_production_engine(
                sd, L, H, qffn=0, sga_mode=0, use_pallas=True, device=dev)
            serve("mode 0, use_pallas=True", padded(fwd, prep),
                  mode0_launches(L, True, True))
            del p
        del plain, sd


# ---------------------------------------------------------------------------
# phase [all-layer]: the decoder modes 1, 3, 4, 5 (head-major blocks, the
# whole decoder and the whole encoder each in one cooperative launch)
# ---------------------------------------------------------------------------

ALLLAYER_BATCHES = (1, 8, BATCH)
ALLLAYER_UNIT = "one call at B = 64 (MCAN-small, 6 layers)"
BLOCK_UNIT = "one block call at B = 64 (MCAN-small)"
# (row, the TPU kernel's call site, the source, the unit of its numbers)
ALLLAYER_ROWS = (
    ("sga_decoder", TPU + ":606", SRC + "sga_decoder.cu", ALLLAYER_UNIT),
    ("sga_decoder, external k/v", TPU + ":772", SRC + "sga_decoder.cu",
     ALLLAYER_UNIT),
    ("sa_encoder", TPU + ":938", SRC + "sa_encoder.cu", ALLLAYER_UNIT),
    ("fused_sga_block_head_major", TPU + ":392",
     "mcan_vqa_tpu_torch/ops/sga_block.py", BLOCK_UNIT))
# The stacks against their plain twins: every step at the same precision,
# the sums in another order, so a bf16 rounding (q / k / v, the
# probabilities, h) may land a step apart; one block carries that to 6e-2
# ([blocks]), six layers with an f32 stream between them ~sqrt(6) of it.
STACK_TOL = 1.5e-1
BLOCK_TOL = 6e-2        # the head-major block: one block, as [blocks]


def stack_work(B, Lv, Lq, D, F, L, kind, stream=2):
    """(operations, bytes) of one all-layer call: per layer the block's
    products and attention (and the in-kernel cross k/v product); the
    stream in and out, the pads, q or the external f32 k/v, and every
    layer's weights read once."""
    if kind == "encoder":
        M = B * Lq
        flops = 2 * M * D * 3 * D + 2 * M * D * D + 4 * M * D * F \
            + 4 * B * Lq * Lq * D
        return (L * flops, 2 * stream * M * D + B * Lq
                + L * weight_bytes(D, F, False))
    M, Mq = B * Lv, B * Lq
    flops = 2 * M * D * 3 * D + 6 * M * D * D + 4 * M * D * F \
        + 4 * B * Lv * Lv * D + 4 * B * Lv * Lq * D
    nbytes = 2 * stream * M * D + B * (Lv + Lq) \
        + L * weight_bytes(D, F, True)
    if kind == "in":
        flops += 4 * Mq * D * D
        nbytes += 2 * Mq * D + L * (2 * 2 * D * D + 4 * 2 * D)
    else:
        nbytes += 2 * 4 * L * Mq * D
    return L * flops, nbytes


def alllayer_inputs(torch, dev, bb, B, Lv, Lq, D, H, L, seed):
    """bf16 streams, ragged pads (sample 0 fully padded past B = 1) and
    every layer's cross k/v as the mode-4 forward projects them (f32,
    layer-major)."""
    from mcan_vqa_tpu_torch.ops.serving import _cross_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(B, Lv, D, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(B, Lq, D, generator=g, device=dev).to(torch.bfloat16)
    lv = [Lv if B == 1 else (i * 17) % (Lv + 1) for i in range(B)]
    lq = [Lq if B == 1 else (i * 5) % (Lq + 1) for i in range(B)]
    kvs = [_cross_kv(bb[f"dec_{i}"]["mhatt2"], q, H) for i in range(L)]
    return (v, q, torch.cat([k for k, _ in kvs], 1),
            torch.cat([x for _, x in kvs], 1), pad_mask(torch, B, Lv, lv, dev),
            pad_mask(torch, B, Lq, lq, dev))


STACK_PRODUCTS = {"decoder": ("qkv1", "m1", "q2", "kv2", "m2", "w1", "w2"),
                  "encoder": ("qkv", "m", "w1", "w2")}


def stack_plan_note(K, name, B, Lv, Lq, D, F, H) -> None:
    """kernels.stack_plan of one stack call: each product's tile and K
    splits, each attention stage's plan and items a block runs at once,
    the grid's cap, the workspace."""
    if name == "sa_encoder":
        p, names = K.stack_plan(B, Lq, D, F, H), STACK_PRODUCTS["encoder"]
    else:
        p = K.stack_plan(B, Lv, D, F, H, Lq,
                         "in" if name == "sga_decoder" else "ext")
        names = STACK_PRODUCTS["decoder"]
    gemms = ", ".join(f"{n} {g.bm}x{g.bn} x{g.splits}" for n, g in
                      zip(names, p.gemms) if g is not None)
    atts = ", ".join(f"{('one-block', 'long')[a.instance]} <{a.dhp}, "
                     f"{a.kc}> {a.rows} rows x{n} a block"
                     for a, n in zip(p.attention, p.att_groups))
    say(f"    [plan] {name} B={B}: {gemms}; attention {atts}; items "
        f"{p.items}, workspace {p.workspace_floats * 4 / 2 ** 20:.2f} MiB, "
        f"{p.counters} counters")


STACK_BODIES = re.compile(r"persistent\d+(gemm_item|att_one_block|att_long|"
                          r"ln_regs|ln_rolled)(?:ILi(\d+)E(?:Li(\d+)E)?)?")


def stack_report(build) -> None:
    """The stack kernels' registers, spills and stack frame (ptxas) and
    their dynamic shared memory; then each stage body's own function
    (gemm_item<accumulators>, the attention instances, the LayerNorm rows):
    its stack frame and spills, per source."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    lines = build.build_log.splitlines()
    if not lines:
        say("[stacks] the library was built by an earlier process: no ptxas "
            "log here")
    kernel = None
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            kernel = next((k for k in ("sga_decoder", "sa_encoder")
                           if f"{k}_kernel" in line), None)
            if kernel is None:
                continue
            info = " ".join(ln.strip() for ln in lines[i + 1:i + 4]
                            if "spill" in ln or "registers" in ln
                            or "stack frame" in ln)
            say(f"[stacks] {kernel}_kernel: {info}; dynamic shared memory "
                f"{K.STACK_SMEM} bytes")
            continue
        m = STACK_BODIES.search(line)
        if kernel and "Function properties" in line and m:
            args = ", ".join(a for a in m.groups()[1:] if a)
            say(f"[stacks]   {kernel}: {m.group(1)}<{args}>: "
                f"{lines[i + 1].strip()}")


def check_stacks(torch, dev, cfg, state_dict, batches, rows=None):
    """sga_decoder (both k/v sources), sa_encoder and the head-major block
    against their plain twins at each batch; at B = 64 (with rows) their
    times and bounds into the kernels' record. Returns the errors."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_block
    from mcan_vqa_tpu_torch.ops.serving import prepare_params
    L, H, D, F = cfg.layer, cfg.multi_head, cfg.hidden_size, cfg.ff_size
    Lq, Lv = cfg.max_token, cfg.img_feat_pad_size
    bb = prepare_params(state_dict, L, device=dev, prune=False, num_heads=H,
                        alllayer=True)["backbone"]
    wd, we, blk = bb["_mk_dec"], bb["_mk_enc"], bb["dec_0"]["_mk"]
    errs = {}
    for B in batches:
        v, q, kq, vq, vm, qm = alllayer_inputs(torch, dev, bb, B, Lv, Lq, D,
                                               H, L, SEED + B)
        kv0 = (kq[:, :H], vq[:, :H])
        calls = {
            "sga_decoder": (
                lambda: K.sga_decoder(v, vm, qm, wd, num_heads=H, q=q),
                lambda: K.sga_decoder_plain(v, vm, qm, wd, num_heads=H, q=q),
                STACK_TOL),
            "sga_decoder, external k/v": (
                lambda: K.sga_decoder(v, vm, qm, wd, num_heads=H, kq=kq,
                                      vq=vq),
                lambda: K.sga_decoder_plain(v, vm, qm, wd, num_heads=H,
                                            kq=kq, vq=vq), STACK_TOL),
            "sa_encoder": (
                lambda: K.sa_encoder(q, qm, we, num_heads=H),
                lambda: K.sa_encoder_plain(q, qm, we, num_heads=H),
                STACK_TOL),
            "fused_sga_block_head_major": (
                lambda: sga_block.fused_sga_block(
                    v, *kv0, vm, qm, blk, num_heads=H, fused_proj=False),
                lambda: sga_block.fused_sga_block_plain(
                    v, *kv0, vm, qm, blk, num_heads=H, fused_proj=False),
                BLOCK_TOL)}
        for name, (kernel, plain, tol) in calls.items():
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f"{name} B={B}: shape {tuple(out.shape)} or non-finite")
            e = max_err(out, ref)
            mean = float((out.float() - ref.float()).abs().mean())
            gate(f"{name} D={D} Dh={D // H} Lv={Lv} Lq={Lq} B={B} (mean "
                 f"|err| {mean:.2e})", e, tol)
            errs[(name, B)] = e
            if rows is not None:
                rows.err(name, e)
            if name != "fused_sga_block_head_major":
                grid = K.LAST_GRID["sa_encoder" if name == "sa_encoder"
                                   else "sga_decoder"]
                say(f"    {name} B={B}: grid {grid[0]} blocks, {grid[1]} "
                    f"per SM on {grid[2]} SMs, {grid[3]} B shared memory")
                stack_plan_note(K, name, B, Lv, Lq, D, F, H)
            if rows is None:
                continue
            ms, pms = cuda_ms(torch, kernel), cuda_ms(torch, plain)
            if name == "fused_sga_block_head_major":
                Mv = B * Lv
                work = (block_flops(Mv, D, F, B, H, Lv, Lq, True),
                        4 * Mv * D + B * (Lv + Lq) + 8 * B * H * Lq * 64
                        + weight_bytes(D, F, True))
            else:
                work = stack_work(B, Lv, Lq, D, F, L, "encoder" if
                                  name == "sa_encoder" else
                                  "in" if name == "sga_decoder" else "ext")
            op, by = bound_parts(*work)
            say(f"    {name} B={B}: {ms:.4f} ms vs plain {pms:.4f} ms, "
                f"bound {max(op, by):.4f} ms by "
                f"{'operations' if op >= by else 'bytes'} "
                f"({work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB)")
            if B == BATCH:
                rows.add(name, 1, ms, pms, *work)
    return errs


def alllayer_launches(L: int, mode: int, aux: bool = False):
    """Every kernel's launches in one forward of build_production_engine(
    qffn=0 or, with aux, level 3 + q8aux, sga_mode=mode) at hidden 512
    (bf16 stream, use_pallas_ffn, no Pallas attention or AttFlat): mode 1
    runs the mode-0 encoder (per layer a gemm_ln merge, a gemm_bias_act +
    gemm_ln FFN; plain attention) and per decoder layer one head-major
    block (q, k, v, both merges, the cross q and the FFN's two products on
    gemm_bias_act, two attentions, three LayerNorms); modes 3 and 4 the
    per-block encoder (4 products, 1 attention, 2 LayerNorms a block) and
    one sga_decoder; mode 5 one sa_encoder and one sga_decoder. aux: the
    static-int8 cross k/v of each layer, both AttFlat merges and the
    head."""
    if mode == 1:
        counts = {"fused_sga_block_head_major": L, "gemm_bias_act": 9 * L,
                  "masked_attention": 2 * L, "residual_layernorm": 3 * L,
                  "gemm_ln": 2 * L}
        if aux:
            counts.update(gemm_s8=L + 3, quantize_rows=L + 3)
        return counts
    if mode == 5:
        return {"sa_encoder": 1, "sga_decoder": 1}
    return {"fused_sa_block": L, "gemm_bias_act": 4 * L,
            "masked_attention": L, "residual_layernorm": 2 * L,
            "sga_decoder": 1}


def serve_alllayer(torch, dev, state_dict, cfg, plain, requests, n_answers,
                   rows) -> None:
    """build_production_engine(sga_mode=1, 3, 4, 5) at MCAN-small full
    depth on the requests of [serve]: exact launches per forward and
    agreement with the plain engine (bf16 bound 1e-2; mode 1 with q8aux
    at level 3, the int8 bound); then modes 1, 3, 4, 5 and 2 timed at
    B = 1, 8, 64 in turns."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    L, H = cfg.layer, cfg.multi_head
    n_fwd = len(requests)
    engine = functools.partial(padded_engine, torch, dev)
    cal = plain.pad_batch(*requests[4])       # the B=64 request
    settings = [(m, {}) for m in (1, 3, 4, 5)] + [
        (1, dict(qffn=None, q8aux=True, act_scale_inputs=cal))]
    timed = {}
    for mode, kw in settings:
        aux = bool(kw)
        fwd, prep = build_production_engine(
            state_dict, L, H, **dict(dict(qffn=0), **kw), sga_mode=mode,
            alllayer=mode > 2, device=dev)
        call = engine(fwd, prep)
        label = f"mode {mode}" + (" q8aux (level 3)" if aux else " (bf16)")
        K.reset_launches()
        probs = [call(*plain.pad_batch(qs, fs))[:len(qs)].cpu().numpy()
                 for qs, fs in requests]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_launches(label, counts, alllayer_launches(L, mode, aux), n_fwd)
        agreement(label, requests, probs, plain, n_answers,
                  bound=INT8_BOUND if aux else 1e-2)
        if aux:
            continue
        if mode in (3, 4, 5):
            rows.launches(f"serve mode {mode}", counts,
                          ("sga_decoder" if mode == 3 else
                           "sga_decoder, external k/v",)
                          + (("sa_encoder",) if mode == 5 else ()),
                          {"sga_decoder": "sga_decoder",
                           "sga_decoder, external k/v": "sga_decoder",
                           "sa_encoder": "sa_encoder"})
        else:
            rows.launches("serve mode 1", counts,
                          ("fused_sga_block_head_major",))
        timed[label] = call
    fwd, prep = build_production_engine(state_dict, L, H, qffn=0, device=dev)
    timed["mode 2 (bf16)"] = engine(fwd, prep)
    say("[all-layer] bf16 forwards, modes 1, 3, 4, 5 against mode 2:")
    time_forwards(torch, cfg, plain, list(timed.items()))


ALLLAYER_WIDE = dict(hidden_size=256, multi_head=2, ff_size=1024, layer=2,
                     img_feat_pad_size=160, img_feat_size=64)


def check_alllayer(torch, dev, state_dict, cfg, rows) -> None:
    """The stacks and the head-major block at MCAN-small for B = 1, 8, 64
    (ragged pads, fully padded samples), with times and bounds; then at
    hidden 256 with 2 heads of 128 and 160 image rows (the attention over
    three chunks of keys), 2 layers, within decoder_vmem_ok."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops.sga_block import decoder_vmem_ok
    for name, replaces, source, unit in ALLLAYER_ROWS:
        rows.row(name, source, replaces, unit)
    say(f"[all-layer] the stacks (tol {STACK_TOL}) and the head-major block "
        f"(tol {BLOCK_TOL}) vs their plain twins, MCAN-small, B = "
        f"{ALLLAYER_BATCHES}")
    check_stacks(torch, dev, cfg, state_dict, ALLLAYER_BATCHES, rows)
    wide = Config(**ALLLAYER_WIDE)
    if not decoder_vmem_ok(wide.hidden_size, wide.ff_size, wide.layer):
        fail("the [all-layer] wide shape must pass decoder_vmem_ok")
    net = MCANet(wide, 20, 10, generator=torch.Generator().manual_seed(SEED))
    say(f"[all-layer] hidden {wide.hidden_size}, {wide.multi_head} heads of "
        f"{wide.hidden_size // wide.multi_head}, {wide.img_feat_pad_size} "
        f"image rows, {wide.layer} layers")
    check_stacks(torch, dev, wide, net.state_dict(), (8,))


# ---------------------------------------------------------------------------
# phase: the widths the kernels now take -- hidden 256 (8 heads of 32) and
# 86 image rows (MIMIC "both") -- served and trained on the card
# ---------------------------------------------------------------------------

ENVELOPE_STEPS = 3
ENVELOPE_LAYERS = 2     # depth cut: the kernels' shapes do not depend on it


def envelope_blocks(torch, dev, cfg, rows) -> None:
    """The seeded train blocks at this configuration's shapes (B = 64):
    the SGA block, and the SA block when the width is not MCAN-small's,
    against the external-mask blocks fed the dump (bit for bit) and their
    plain twins (``seeded_vs_dump``): the attention kernels' 128-row and
    Dh-32 instances and the LayerNorm at D 256, forward and backward, with
    their Philox sites."""
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    from mcan_vqa_tpu_torch.ops import sga_train as st
    rate, seed = 0.1, PRNG_SEED + 1
    B, Lv, Lq, D, F, H = (BATCH, cfg.img_feat_pad_size, 14, cfg.hidden_size,
                          cfg.ff_size, cfg.multi_head)
    x, kq, vq, vm, qm, _, w, _, probe = train_block_inputs(
        torch, dev, B=B, Lv=Lv, Lq=Lq, D=D, F=F, H=H)
    masks, inv = st.dump_prng_masks(seed, rate, B, Lv, Lq, D, F, H,
                                    device=dev)
    ffn = {"w1", "b1", "w2", "b2", "ln3_s", "ln3_b"}
    seeded_vs_dump(
        torch, f"SGA train block, B={B} Lv={Lv} D={D} H={H}",
        lambda ls, ws: st.fused_sga_block_train_prng(
            *ls, vm, qm, seed, ws, num_heads=H, rate=rate),
        lambda ls, ws: st.fused_sga_block_train(
            *ls, vm, qm, masks, ws, num_heads=H, inv_keep=inv),
        lambda ls, ws: st.fused_sga_block_train_prng_plain(
            *ls, vm, qm, seed, ws, num_heads=H, rate=rate),
        (x, kq, vq), ("x", "kq", "vq"), w, st.WEIGHT_NAMES, probe, rows,
        lambda n: "sga_train_fwd_prng" if n is None
        else "sga_train_bwd_ffn_prng" if n in ffn
        else "sga_train_bwd_att_prng")
    if D == 512:
        return
    xq, qmask, _, sw, _, sprobe = sa_block_inputs(torch, dev, B, L=Lq, D=D,
                                                  F=F, H=H)
    masks, inv = sa.dump_sa_prng_masks(seed, rate, B, Lq, D, F, H,
                                       device=dev)
    seeded_vs_dump(
        torch, f"SA train block, B={B} L={Lq} D={D} H={H}",
        lambda ls, ws: sa.fused_sa_block_train(*ls, qmask, seed, ws,
                                               num_heads=H, rate=rate),
        lambda ls, ws: sa.fused_sa_block_train(*ls, qmask, masks, ws,
                                               num_heads=H, inv_keep=inv),
        lambda ls, ws: sa.fused_sa_block_train_plain(
            *ls, qmask, seed, ws, num_heads=H, rate=rate),
        (xq,), ("x",), sw, sa.SA_WEIGHT_NAMES, sprobe, rows,
        lambda n: "sa_train_fwd_prng" if n is None else "sa_train_bwd_prng")


def check_envelope(torch, dev, vocab, ix_to_ans, rows) -> None:
    """For each width: the bf16 engine, int8 levels 1 / 3 / 5 and the
    full-int8 engine through ``Predictor`` (bf16 through
    ``build_production_engine(qffn=0)``, which the Predictor does not
    expose; levels 1 and 3 from the default Predictor before and after its
    online calibration, as in [serve]; level 5 from
    ``Predictor(engine="int4")`` after ``calibrate_now()``), each within its
    PERF.md section 2 bound of the plain engine with exact launch counts;
    the seeded train blocks at its shapes (``envelope_blocks``); then
    ``Trainer`` (engine "auto": the fused engine with in-kernel dropout on
    the card) for ENVELOPE_STEPS steps at batch 64 with exact launch
    counts, each step's loss within 1e-3 of the plain engine's on the same
    weights, seeds and generator state."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_route

    for label, over in (("hidden 256, 8 heads of 32", dict(hidden_size=256)),
                        ("86 image rows", dict(img_feat_pad_size=86))):
        cfg = Config.for_model("small", layer=ENVELOPE_LAYERS, **over)
        L, n_ans = cfg.layer, len(ix_to_ans)
        net = MCANet(cfg, len(vocab), n_ans,
                     generator=torch.Generator().manual_seed(SEED + 31))
        sd = net.state_dict()
        say(f"[envelope] {label}: {L} layers, hidden {cfg.hidden_size}, ff "
            f"{cfg.ff_size}, {cfg.multi_head} heads of "
            f"{cfg.hidden_size // cfg.multi_head}, up to "
            f"{cfg.img_feat_pad_size} regions")
        kw = dict(ix_to_ans=ix_to_ans, max_batch=BATCH,
                  latency_buckets=LATENCY_BUCKETS, device=dev)
        rng = np.random.default_rng(SEED + 32)
        requests = make_requests(rng, cfg)
        plain = Predictor(cfg, sd, vocab, engine="plain", **kw)
        n_fwd = len(requests)

        def serve(name, call, want, bound=INT8_BOUND, on="sigmoid"):
            K.reset_launches()
            probs = [call(qs, fs) for qs, fs in requests]
            torch.cuda.synchronize()
            check_launches(f"envelope {label}, {name}", K.launch_counts(),
                           want, n_fwd)
            agreement(f"{label}, {name}", requests, probs, plain, n_ans,
                      bound, on)

        fwd, prep = build_production_engine(sd, L, cfg.multi_head, qffn=0,
                                            device=dev)
        bf16 = padded_engine(torch, dev, fwd, prep)
        serve("bf16 (qffn=0)", lambda qs, fs: bf16(*plain.pad_batch(qs, fs))
              [:len(qs)].cpu().numpy(), serve_launches(L, 0), bound=1e-2)
        p = Predictor(cfg, sd, vocab, **kw)
        serve("level 1", p.predict_probs, serve_launches(L, 1))
        for _ in range(-(-256 // BATCH)):       # past 256 real rows
            p.predict_probs(*ragged_batch(rng, cfg, BATCH))
        if not p.wait_calibrated(timeout=600) or \
                p.calibration["state"] != "calibrated":
            fail(f"envelope {label}: calibration {p.calibration}")
        serve("level 3 (online calibration)", p.predict_probs,
              serve_launches(L, 3))
        p5 = Predictor(cfg, sd, vocab, engine="int4", **kw)
        for qs, fs in requests:
            p5.predict_probs(qs, fs)
        p5.calibrate_now()
        serve("int4 level 5", p5.predict_probs, serve_launches(L, 5),
              INT4_BOUND, "softmax")
        p8 = Predictor(cfg, sd, vocab, engine="int8", **kw)
        serve("full int8", p8.predict_probs, int8_engine_launches(L))
        del plain, p, p5, p8, bf16, prep
        envelope_blocks(torch, dev, cfg, rows)

        work = ROOT / "ckpts" / "chip_smoke_envelope"
        tcfg = cfg.with_overrides(max_epoch=1, batch_size=BATCH,
                                  seed=SEED + 33,
                                  ckpts_dir=str(work / "ckpts"),
                                  log_path=str(work / "log"), verbose=False)
        ds = SyntheticVQADataset(tcfg, size=ENVELOPE_STEPS * BATCH,
                                 answer_size=3129, seed=SEED)
        try:
            trainer = Trainer(tcfg, ds, device=dev)
            if not (trainer.fused and trainer.in_kernel_dropout):
                fail(f"envelope {label}: the Trainer chose fused="
                     f"{trainer.fused}, in_kernel_dropout="
                     f"{trainer.in_kernel_dropout}")
            route = engine_route(tcfg.hidden_size)
            plain_fwd = make_fused_train_forward(
                tcfg.layer, tcfg.multi_head, dropout_rate=tcfg.dropout_rate,
                sga_block="plain", fused_encoder=route["fused_encoder"],
                dropout_bits=tcfg.dropout_bits, in_kernel_dropout=True)
            losses, plains = [], []
            real = trainer.step_fn

            def step(state, batch):
                state.seed_step()
                plains.append(engine_loss(
                    torch, dev, tcfg, plain_fwd, state.model, batch,
                    state.generator.get_state())[0])
                metrics = real(state, batch)
                losses.append(float(metrics["loss"]))
                return metrics

            trainer.step_fn = step
            K.reset_launches()
            trainer.train()
            torch.cuda.synchronize()
            counts = {k: v for k, v in K.launch_counts().items()
                      if k in TRAIN_KERNELS}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        want = {k: c * ENVELOPE_STEPS for k, c in expected_step_launches(
            tcfg, route, True).items() if c}
        if len(losses) != ENVELOPE_STEPS or not np.isfinite(losses).all():
            fail(f"envelope {label}: train losses {losses}")
        rels = [loss_gate(f"envelope {label} step {i}", a, b)
                for i, (a, b) in enumerate(zip(losses, plains))]
        say(f"[envelope] {label}: Trainer, {len(losses)} steps at batch "
            f"{BATCH} through the kernels with in-kernel dropout: losses "
            f"{[round(x, 3) for x in losses]}, the plain engine's "
            f"{[round(x, 3) for x in plains]} (rel <= {max(rels):.2e}, "
            f"gate 1e-3); launches {counts}")
        if counts != want:
            fail(f"envelope {label}: launches {counts}, expected {want}")

    # the long attention kernels under the seeded train blocks (Dh 192,
    # 160 rows): the blocks' launches make the path of their rows. Dh 192
    # at hidden 768 (4 heads), not 1536: the blocks' gradients move from
    # their plain twins' through ReLU gates that flip where the two
    # forwards round a near-zero pre-activation apart, a gap that grows
    # with the width whatever the attention kernel and passes the 3e-2
    # gate at hidden 1536 (PERF.md section 6; mcan_vqa_tpu_torch/cli/
    # block_gap.py)
    K.reset_launches()
    for over in (dict(hidden_size=768, multi_head=4),
                 dict(img_feat_pad_size=160)):
        envelope_blocks(torch, dev, Config.for_model(
            "small", layer=ENVELOPE_LAYERS, **over), rows)
    torch.cuda.synchronize()
    rows.launches("envelope blocks, Dh 192 / 160 rows", K.launch_counts(),
                  ("masked_attention_bwd, long",),
                  {"masked_attention_bwd, long": "masked_attention_bwd"})


# ---------------------------------------------------------------------------
# phase: the last Pallas sites -- the SGA train block's recompute FFN
# backward (save_acts=False) and the two streaming FFN + LayerNorm kernels
# ---------------------------------------------------------------------------

RECOMPUTE_UNIT = ("the six decoder blocks of one B=64 MCAN-small step with "
                  "save_acts=False")
FFN_UNIT = "one call at MCAN-large B=64 (M 3840, D 1024, F 4096)"
LAST_SITE_ROWS = (
    ("ffn_ln_blocked", SRC + "ffn_ln_blocked.cu", TPU_FFN + ":174",
     FFN_UNIT),
    ("ffn_ln_wstationary", SRC + "ffn_ln_wstationary.cu", TPU_FFN + ":263",
     FFN_UNIT),
    ("sga_train_bwd_ffn_recompute", "mcan_vqa_tpu_torch/ops/sga_train.py",
     TPU_TRAIN + ":1024", RECOMPUTE_UNIT),
    ("sga_train_bwd_ffn_recompute_prng",
     "mcan_vqa_tpu_torch/ops/sga_train.py", TPU_TRAIN + ":568",
     RECOMPUTE_UNIT))
# (label, M, D, F, x dtype); the first is the row's unit
FFN_CASES = (("MCAN-large B=64", 3840, 1024, 4096, "float32"),
             ("MCAN-large B=1", 60, 1024, 4096, "float32"),
             ("MCAN-large ragged M=61", 61, 1024, 4096, "bfloat16"),
             ("MCAN-small B=64", 3840, 512, 2048, "float32"))
# the streaming kernels against their plain version: f32 out, the same
# exact bf16 products summed in another order (h's bf16 rounding may land
# a step apart where the order moves a sum across a rounding boundary),
# then an LN of O(1) values
FFN_TOL = 1e-3


def ffn_work(M, D, F, x_size):
    """(operations, bytes) of one streaming FFN + LN call: the two products
    and the residual + LN; x, both weights, b1, b2 / gamma / beta read
    once, the f32 out written once."""
    return (4 * M * D * F + 10 * M * D,
            x_size * M * D + 2 * 2 * D * F + 4 * F + 12 * D + 4 * M * D)


def recompute_work(M, D, F, seeded):
    """(operations, bytes) of one recompute FFN backward (_bwd_ffn_kernel):
    6 products of 2 M D F (the two recomputed, dh1d, gv2's da1 . W1^T, dW1,
    dW2); in: g and v2 (f32), the bf16 v2, the h1 / y3 masks (none when
    seeded), W1 / W2 (bf16), b1, b2, ln3_s; out: gv2 (f32) and dW1, dW2,
    db1, db2, dln3_s, dln3_b (f32)."""
    masks = 0 if seeded else M * F + M * D
    return (12 * M * D * F,
            4 * M * D * 2 + 2 * M * D + masks + 2 * 2 * D * F + 4 * (F + 2 * D)
            + 4 * M * D + 4 * 2 * D * F + 4 * (F + 3 * D))


def check_streaming_ffn(torch, dev, rows):
    """Both streaming kernels against their plain version at each of
    FFN_CASES, with times; the MCAN-large B=64 call into the rows. Returns
    that case's operands (the main path's inputs)."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    kc = KernelCheck(torch, dev, rows, SEED + 90)
    bf16 = torch.bfloat16
    first = None
    for label, M, D, F, xdt in FFN_CASES:
        x = kc.randn(M, D, dtype=getattr(torch, xdt))
        w1 = (kc.randn(D, F) / D ** 0.5).to(bf16)
        w2 = (kc.randn(F, D) / F ** 0.5).to(bf16)
        b1, b2, beta = kc.randn(F, s=0.1), kc.randn(D, s=0.1), kc.randn(
            D, s=0.1)
        gamma = 1 + kc.randn(D, s=0.1)
        ops = (x, w1, b1, w2, b2, gamma, beta)
        first = first or ops
        flops, nbytes = ffn_work(M, D, F, x.element_size())
        ref = K.ffn_ln_plain(*ops)
        t_p = device_ms(torch, lambda: K.ffn_ln_plain(*ops), iters=5)
        xb = x.to(bf16)
        t_y = device_ms(torch, lambda: torch.addmm(b1.to(bf16), xb, w1))
        # the port's unfused pair: h through HBM in bf16 (x cast outside)
        t_u = device_ms(torch, lambda: K.gemm_ln(K.gemm_bias_act(
            xb, w1, b1, relu=True, out_dtype=bf16), w2, b2, x, gamma, beta))
        op, by = bound_parts(flops, nbytes)
        for name in ("ffn_ln_blocked", "ffn_ln_wstationary"):
            fn = getattr(K, name)
            plan = K.ffn_ln_plan(name[len("ffn_ln_"):], M, D, F,
                                 xdt == "float32")
            say(f"    [plan] {name} {label}: {plan.cluster} CTAs of "
                f"{plan.bn} columns a cluster, F in {plan.f_steps} steps of "
                f"{plan.f_width}" + (f", {plan.splits} splits"
                                     if plan.variant == "blocked" else
                                     f" ({plan.ts} hidden units a CTA)")
                + f", ring of {plan.stages}, {plan.smem} B shared memory")
            out = fn(*ops)
            torch.cuda.synchronize()
            if out.shape != (M, D) or out.dtype != torch.float32 or \
                    not torch.isfinite(out).all():
                fail(f"{name} {label}: {tuple(out.shape)} {out.dtype} or "
                     f"non-finite")
            err = max_err(out, ref)
            gate(f"{name} {label} [{M}x{D}] F={F} x {xdt}", err,
                 FFN_TOL * (float(ref.abs().max()) + 1e-6))
            rows.err(name, err)
            if not torch.equal(out, fn(*ops)):
                fail(f"{name} {label}: two runs differ")
            grid = ""
            if name == "ffn_ln_wstationary":
                g = K.LAST_GRID[name]
                grid = (f", grid {g[0]} CTAs in {g[1]} clusters (the card "
                        f"holds {g[2]}), {g[3]} B shared memory")
                if not torch.equal(out, fn(*ops, max_clusters=3)):
                    fail(f"{name} {label}: 3 clusters change the bits")
            t_k = device_ms(torch, lambda: fn(*ops))
            say(f"    {name} {label}: {t_k:.4f} ms vs plain {t_p:.4f} ms, "
                f"the unfused pair gemm_bias_act + gemm_ln {t_u:.4f} ms, "
                f"yardstick addmm of the first product {t_y:.4f} ms (no "
                f"single PyTorch call computes FFN + LN); bound "
                f"{max(op, by):.4f} ms by "
                f"{'operations' if op >= by else 'bytes'} "
                f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB){grid}; "
                f"two runs equal bit for bit"
                + ("; 3 clusters equal too" if grid else ""))
            if label == FFN_CASES[0][0]:
                rows.add(name, 1, t_k, t_p, flops, nbytes)
    return first


def recompute_memory(torch, st, x, kq, vq, vm, qm, masks, w, inv, probe,
                     H) -> None:
    """One block's forward + backward, save_acts True and False: the bytes
    held from the forward to the backward and the peak allocated."""
    def once(save_acts):
        ls = [t.clone().requires_grad_() for t in (x, kq, vq)]
        ws = {k: t.clone().requires_grad_() for k, t in w.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = st.fused_sga_block_train(*ls, vm, qm, masks, ws, num_heads=H,
                                       inv_keep=inv, save_acts=save_acts)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        (out * probe).sum().backward()
        torch.cuda.synchronize()
        return held, torch.cuda.max_memory_allocated() - base

    (h1, p1), (h0, p0) = once(True), once(False)
    B, Lv, D = x.shape
    M, F = B * Lv, w["w1"].shape[1]
    say(f"  memory, one SGA block at B={B} (M {M}, D {D}, F {F}): held from "
        f"the forward to the backward {h1 / 1e6:.1f} MB with save_acts, "
        f"{h0 / 1e6:.1f} MB without ({(h1 - h0) / 1e6:.1f} MB less; "
        f"M 2 F = {M * 2 * F / 1e6:.1f} MB: h1d, and the f32 r3 for the f32 "
        f"v2); peak over forward + backward "
        f"{p1 / 1e6:.1f} / {p0 / 1e6:.1f} MB")
    if not h0 < h1:
        fail("save_acts=False holds no fewer bytes than save_acts=True")


def check_recompute(torch, dev, rows):
    """fused_sga_block_train(save_acts=False) and its seeded twin against
    the plain block (autograd) and the block fed the dump, at MCAN-small
    B=64 and MCAN-large's micro-batch of 32 (bf16_saves both ways); the
    recompute FFN backward's time beside the _sav piece's; the memory the
    variant saves."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_train as st
    rate, seed, H = 0.1, PRNG_SEED + 2, 8
    Lv, Lq = 60, 14
    for label, B, D, F, b16 in (("MCAN-small", BATCH, 512, 2048, False),
                                ("MCAN-large", BATCH // 2, 1024, 4096,
                                 False),
                                ("MCAN-large, bf16_saves", BATCH // 2, 1024,
                                 4096, True)):
        say(f"[last sites] fused_sga_block_train(save_acts=False, "
            f"bf16_saves={b16}) vs the plain block (autograd): {label}, "
            f"B={B}, rate 0.1, fully padded samples")
        x, kq, vq, vm, qm, masks, w, inv, probe = train_block_inputs(
            torch, dev, B=B, D=D, F=F)
        block_vs_plain(
            torch, f"SGA train block, save_acts=False, {label}",
            functools.partial(st.fused_sga_block_train, save_acts=False,
                              bf16_saves=b16),
            st.fused_sga_block_train_plain, (x, kq, vq), w, st.WEIGHT_NAMES,
            probe, lambda blk, ls, ws: blk(*ls, vm, qm, masks, ws,
                                           num_heads=H, inv_keep=inv), rows,
            lambda n: "sga_train_bwd_ffn_recompute", ("x", "kq", "vq"))
        dump, inv_d = st.dump_prng_masks(seed, rate, B, Lv, Lq, D, F, H,
                                         device=dev)
        kw = dict(num_heads=H, bf16_saves=b16, save_acts=False)
        seeded_vs_dump(
            torch, f"SGA train block, save_acts=False, {label}",
            lambda ls, ws: st.fused_sga_block_train_prng(
                *ls, vm, qm, seed, ws, rate=rate, **kw),
            lambda ls, ws: st.fused_sga_block_train(
                *ls, vm, qm, dump, ws, inv_keep=inv_d, **kw),
            lambda ls, ws: st.fused_sga_block_train_prng_plain(
                *ls, vm, qm, seed, ws, num_heads=H, rate=rate),
            (x, kq, vq), ("x", "kq", "vq"), w, st.WEIGHT_NAMES, probe, rows,
            lambda n: "sga_train_bwd_ffn_recompute_prng")
        if label != "MCAN-small":
            continue
        recompute_memory(torch, st, x, kq, vq, vm, qm, masks, w, inv, probe,
                         H)
        # the FFN backward pieces: from the saves (_bwd_ffn_kernel_sav) and
        # recomputed (_bwd_ffn_kernel), external masks and seeded
        M = B * Lv
        wk = st._kernel_weights([w[n] for n in st.WEIGHT_NAMES])
        xs, g = x.contiguous(), probe.reshape(M, D).contiguous()
        ps, pinv = st.prng_sites(PRNG_SEED, rate, Lv)
        pieces, work = {}, {}
        for name, m, iv, acts in (
                ("sga_train_bwd_ffn (save_acts)", masks, inv, True),
                ("sga_train_bwd_ffn_recompute", masks, inv, False),
                ("sga_train_bwd_ffn_recompute_prng", ps, pinv, False)):
            sv = st._forward(xs, kq, vq, vm, qm, m, wk, iv, H,
                             save_acts=acts)[1]
            pieces[name] = functools.partial(st._bwd_ffn, g, sv, m, wk, iv)
            work[name] = recompute_work(M, D, F, m is ps)
        sav_f, _ = work["sga_train_bwd_ffn (save_acts)"]
        # the _sav piece reads r3 (f32) and h1d (bf16) and recomputes no
        # product: 4 products, r3 in place of v2, h1d in place of the h1
        # mask
        work["sga_train_bwd_ffn (save_acts)"] = (
            sav_f - 4 * M * D * F, work["sga_train_bwd_ffn_recompute"][1]
            + 2 * M * F - M * F)
        for name, fn in pieces.items():
            flops, nbytes = work[name]
            t_k = device_ms(torch, fn, iters=10)
            t_p = device_ms(torch, plain_path(K, fn), iters=5)
            op, by = bound_parts(flops, nbytes)
            say(f"  {name}: {t_k:.4f} ms vs plain {t_p:.4f} ms per block; "
                f"bound {max(op, by):.4f} ms by "
                f"{'operations' if op >= by else 'bytes'} "
                f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            if name in rows.rows:
                rows.add(name, 6, t_k, t_p, flops, nbytes)


def check_last_sites(torch, dev, rows) -> None:
    """The streaming kernels and the recompute blocks against their plain
    twins with times (``check_streaming_ffn``, ``check_recompute``); then
    the slice's main path: fused_ffn_ln_blocked and
    fused_ffn_ln_weight_stationary at MCAN-large B=64 and the SGA train
    block with save_acts=False, external masks and seeded, forward and
    backward at MCAN-small B=64, with the counts set to 0 just before and
    read just after."""
    from mcan_vqa_tpu_torch.ops import fused_ffn
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_train as st
    for name, source, replaces, unit in LAST_SITE_ROWS:
        rows.row(name, source, replaces, unit)
    say("[last sites] ffn_ln_blocked and ffn_ln_wstationary vs their plain "
        f"version (tol {FFN_TOL} of max|ref|)")
    x, w1, b1, w2, b2, gamma, beta = check_streaming_ffn(torch, dev, rows)
    check_recompute(torch, dev, rows)

    H, seed = 8, PRNG_SEED + 3
    bx, kq, vq, vm, qm, masks, w, inv, probe = train_block_inputs(
        torch, dev, B=BATCH)
    x3 = x.view(BATCH, 60, x.shape[1])
    K.reset_launches()
    outs = [fused_ffn.fused_ffn_ln_blocked(x3, w1, b1, w2, b2, gamma, beta),
            fused_ffn.fused_ffn_ln_weight_stationary(x3, w1, b1, w2, b2,
                                                     gamma, beta)]
    grads = []
    for block, src, kw in (
            (st.fused_sga_block_train, masks, dict(inv_keep=inv)),
            (st.fused_sga_block_train_prng, seed, dict(rate=0.1))):
        ls = [t.clone().requires_grad_() for t in (bx, kq, vq)]
        ws = {k: t.clone().requires_grad_() for k, t in w.items()}
        out = block(*ls, vm, qm, src, ws, num_heads=H, save_acts=False, **kw)
        (out * probe).sum().backward()
        outs.append(out.detach())
        grads += [t.grad for t in ls] + [ws[n].grad for n in st.WEIGHT_NAMES]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    say(f"[launches] last sites (2 streaming FFN calls, 2 SGA train blocks "
        f"with save_acts=False): {counts}")
    want = {"ffn_ln_blocked": 1, "ffn_ln_wstationary": 1,
            "sga_train_fwd": 1, "sga_train_fwd_prng": 1,
            "sga_train_bwd_ffn_recompute": 1,
            "sga_train_bwd_ffn_recompute_prng": 1, "sga_train_bwd_att": 1,
            "sga_train_bwd_att_prng": 1}
    got = {k: counts.get(k, 0) for k in list(want) + ["sga_train_bwd_ffn"]}
    if got != dict(want, sga_train_bwd_ffn=0):
        fail(f"last sites: block launches {got}, expected {want}")
    for name in ("gemm_bias_act", "gemm_dx", "gemm_dw",
                 "residual_layernorm_bwd", "col_sum"):
        if counts.get(name, 0) < 2:
            fail(f"last sites: {name} launched {counts.get(name, 0)} times")
    if not all(torch.isfinite(t).all() for t in outs + grads):
        fail("last sites: non-finite outputs or gradients")
    if max_err(outs[0], outs[1]) > FFN_TOL * float(outs[0].abs().max()):
        fail("last sites: the two streaming kernels disagree")
    rows.launches("last sites", counts, [r[0] for r in LAST_SITE_ROWS])


def check_repeated_batch(torch, trainer) -> None:
    """Six steps on one batch: the loss falls."""
    batch = next(iter(trainer.loader()))
    losses = [float(trainer.step_fn(trainer.state, batch)["loss"])
              for _ in range(6)]
    say(f"[train] one batch, 6 steps: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        fail(f"the loss on a repeated batch did not fall: {losses}")


# ---------------------------------------------------------------------------
# phase (d): the epoch checkpoint served by the fused Predictor
# ---------------------------------------------------------------------------

def check_checkpoint(torch, dev, trainer, ckpt: Path) -> None:
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.checkpoint import load_reference_checkpoint
    cfg, ds = trainer.cfg, trainer.train_dataset
    saved = load_reference_checkpoint(str(ckpt))
    live = trainer.model.state_dict()
    if set(saved) != set(live) or not all(
            torch.equal(saved[k], live[k].cpu()) for k in live):
        fail("the epoch checkpoint does not hold the trained weights")
    vocab = {"PAD": 0, "UNK": 1}
    vocab.update({f"t{i}": i for i in range(2, ds.token_size)})
    kw = dict(ix_to_ans=ds.ix_to_ans, max_batch=8, latency_buckets=(1,),
              device=dev)
    # act_scales=False: the level-1 engine and its online calibration
    # (the stored scales are [lifecycle]'s)
    fused = Predictor.from_checkpoint(str(ckpt), cfg, vocab, engine="fused",
                                      act_scales=False, **kw)
    plain = Predictor.from_checkpoint(str(ckpt), cfg, vocab, engine="plain",
                                      **kw)
    rng = np.random.default_rng(SEED + 5)
    questions = ["t5 t17 t3", "t9 t9 t120 t44", ""]
    feats = [rng.normal(size=(r, cfg.img_feat_size)).astype(np.float32)
             for r in (60, 31, 12)]
    K.reset_launches()
    answers = fused.answer(questions, feats)
    pf = fused.predict_probs(questions, feats)
    counts = K.launch_counts()
    pp = plain.predict_probs(questions, feats)
    worst = float(np.abs(pf - pp).max())
    say(f"[checkpoint] {ckpt.name} ({ckpt.stat().st_size / 1e6:.1f} MB) -> "
        f"Predictor.from_checkpoint(engine='fused', act_scales=False), "
        f"int8 level 1, "
        f"calibration {fused.calibration}: "
        + "; ".join(f"{q!r} -> {a} {p:.3f}" for q, (a, p) in
                    zip(questions, answers))
        + f"; fused vs plain max|dprob| {worst:.3e} <= {INT8_BOUND:.0e}")
    check_launches("checkpoint", counts, serve_launches(cfg.layer, 1), 2)
    if not (np.isfinite(pf).all() and pf.shape == (3, ds.ans_size)
            and all(a in ds.ix_to_ans.values() for a, _ in answers)
            and worst <= INT8_BOUND
            and fused.calibration["samples"] == 6):
        fail("the checkpoint's Predictor gave bad answers")


# ---------------------------------------------------------------------------
# phase [lifecycle]: resume, preemption, the async saver and pruning, the
# calibrated checkpoint, the bf16 first moment
# ---------------------------------------------------------------------------

LIFE_SIZE = 256               # the synthetic train set: 4 steps an epoch
LIFE_PREEMPT_AT = 2           # SIGTERM raised inside this step of epoch 0


def life_config(work: Path, version: str, **kw):
    """MCAN-small at full width, batch 64, no evaluation between epochs."""
    from mcan_vqa_tpu_torch.configs import Config
    return Config.for_model("small", batch_size=BATCH, seed=SEED + 11,
                            version=version, ckpts_dir=str(work / "ckpts"),
                            log_path=str(work / "log"), verbose=False,
                            eval_every_epoch=False, **kw)


def life_dataset(cfg):
    """The CLI's synthetic train set (run_vqa --synthetic)."""
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    return SyntheticVQADataset(cfg, size=LIFE_SIZE, answer_size=3129,
                               seed=cfg.seed)


def life_records(cfg):
    return [json.loads(x) for x in (Path(cfg.log_path) / (
        f"log_run_{cfg.run_version}.jsonl")).read_text().splitlines()]


def pickle_diff(torch, a: Path, b: Path):
    """Two epoch pickles -> (max |difference| over the weights and both
    AdamW moments, the names of the tensors that differ, the steps of each)."""
    A = torch.load(a, map_location="cpu", weights_only=True)
    B = torch.load(b, map_location="cpu", weights_only=True)
    keys = list(A["state_dict"])
    if keys != list(B["state_dict"]) or sorted(A["optimizer"]["state"]) != \
            sorted(B["optimizer"]["state"]):
        fail(f"{a} and {b} hold other parameters")
    pairs = [(k, A["state_dict"][k], B["state_dict"][k]) for k in keys]
    for i, sa in A["optimizer"]["state"].items():
        sb = B["optimizer"]["state"][i]
        pairs += [(f"{keys[i]} {m}", sa[m], sb[m])
                  for m in ("exp_avg", "exp_avg_sq")]
    worst, differ = 0.0, []
    for name, x, y in pairs:
        if x.dtype != y.dtype or not torch.equal(x, y):
            differ.append(name)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    steps = [sorted({float(s["step"]) for s in blob["optimizer"]["state"]
                     .values()}) for blob in (A, B)]
    return worst, differ, len(pairs), steps


def life_resume(torch, dev, rows, work: Path) -> None:
    """Run U trains 2 epochs; run R trains 1, then a new process resumes it
    (``run_vqa --run train --synthetic --resume true --ckpt_epoch 1
    --max_epoch 2``); a control run C trains 2 epochs like U. Gate: R's
    epoch-2 weights, AdamW moments and step equal U's bit for bit, or,
    where C already differs from U, by no more than C does. U's launches
    are exact: 8 train steps and the final val batch (int8 level 1)."""
    from mcan_vqa_tpu_torch.cli import run_vqa
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.trainer import engine_route

    def argv(version, epochs, *extra):
        return ["--run", "train", "--synthetic", "--synthetic_size",
                str(LIFE_SIZE), "--batch_size", str(BATCH), "--seed",
                str(SEED + 11), "--ckpts_dir", str(work / "ckpts"),
                "--log_path", str(work / "log"), "--eval_ee", "false",
                "--verbose", "false", "--version", version, "--max_epoch",
                str(epochs), *extra]

    cfg = run_vqa.build_config(run_vqa.parse_args(argv("U", 2)))
    n_steps = 2 * (LIFE_SIZE // BATCH)
    step = expected_step_launches(cfg, engine_route(cfg.hidden_size), True)
    serve = serve_launches(cfg.layer, 1)
    want = {k: n_steps * step.get(k, 0) + serve.get(k, 0)
            for k in set(step) | set(serve)}
    times = {}
    K.reset_launches()
    t0 = time.perf_counter()
    if run_vqa.main(argv("U", 2)) != 0:
        fail("[lifecycle] run U failed")
    torch.cuda.synchronize()
    times["U"] = time.perf_counter() - t0
    counts = K.launch_counts()
    check_launches("lifecycle: run U (run_vqa --run train, 2 epochs)",
                   counts, {k: n for k, n in want.items() if n}, 1)
    rows.launches("lifecycle: run U", counts,
                  [k for k in TRAIN_KERNELS if step.get(k)]
                  + [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    t0 = time.perf_counter()
    if run_vqa.main(argv("R", 1)) != 0:
        fail("[lifecycle] run R's first epoch failed")
    times["R epoch 1"] = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "mcan_vqa_tpu_torch.cli.run_vqa",
           *argv("R", 2, "--resume", "true", "--ckpt_epoch", "1")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    times["R resumed (new process)"] = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stderr[-4000:])
        fail(f"[lifecycle] the resumed run exited {proc.returncode}")
    log = (work / "log" / "log_run_R.txt").read_text()
    resumed = [ln for ln in log.splitlines() if ln.startswith("resume:")]
    say(f"[lifecycle] {' '.join(cmd[1:4])} ... --resume true --ckpt_epoch 1 "
        f"--max_epoch 2: exit 0, the run logged {resumed}")
    if not resumed or f"@ step {LIFE_SIZE // BATCH}" not in resumed[0]:
        fail("[lifecycle] the resumed run did not restore the moments at "
             "step 4")
    t0 = time.perf_counter()
    if run_vqa.main(argv("C", 2)) != 0:
        fail("[lifecycle] the control run failed")
    times["C"] = time.perf_counter() - t0
    pick = work / "ckpts"
    r_err, r_diff, n, r_steps = pickle_diff(
        torch, pick / "ckpt_U" / "epoch2.pkl", pick / "ckpt_R" / "epoch2.pkl")
    c_err, c_diff, _, c_steps = pickle_diff(
        torch, pick / "ckpt_U" / "epoch2.pkl", pick / "ckpt_C" / "epoch2.pkl")
    say(f"[lifecycle] wall s: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in times.items()))
    say(f"[lifecycle] resume: R (epoch 1, then resumed in a new process) "
        f"against U (2 epochs unbroken), {n} tensors (weights, exp_avg, "
        f"exp_avg_sq): {len(r_diff)} differ, max |d| {r_err:.3e}, steps "
        f"{r_steps}; control C against U: {len(c_diff)} differ, max |d| "
        f"{c_err:.3e}, steps {c_steps}")
    if r_steps != [[float(n_steps)]] * 2 or c_steps != r_steps:
        fail(f"[lifecycle] steps {r_steps} / {c_steps}, expected {n_steps}")
    if c_diff:
        say(f"[lifecycle] two unbroken runs differ on the card: "
            f"{c_diff[:6]}; R is gated at the control's {c_err:.3e}")
        if r_err > c_err:
            fail(f"[lifecycle] the resumed run is {r_err:.3e} from U, past "
                 f"the control pair's {c_err:.3e}")
    elif r_diff:
        fail(f"[lifecycle] the resumed run differs from the unbroken one: "
             f"{r_diff[:6]}")
    else:
        say("[lifecycle] resume: bit for bit (weights, both moments, step)")
    for v in ("U", "R", "C"):
        shutil.rmtree(pick / f"ckpt_{v}", ignore_errors=True)


def life_preempt(torch, dev, work: Path) -> None:
    """SIGTERM raised in the training process inside step LIFE_PREEMPT_AT
    of epoch 0: epoch1.pkl written, preempted_at_step logged, train()
    returns, the handlers back; a run resumed from that pickle trains
    on."""
    import signal
    from mcan_vqa_tpu_torch.train.trainer import Trainer

    cfg = life_config(work, "P", max_epoch=2)
    ds = life_dataset(cfg)
    trainer = Trainer(cfg, ds, device=dev)
    real, seen = trainer.step_fn, []

    def step(state, batch):
        out = real(state, batch)
        seen.append(state.step)
        if len(seen) == LIFE_PREEMPT_AT:
            signal.raise_signal(signal.SIGTERM)
        return out

    def marker(signum, frame):
        fail("SIGTERM reached chip_smoke's own handler, not the Trainer's")

    trainer.step_fn = step
    old_term = signal.signal(signal.SIGTERM, marker)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        t0 = time.perf_counter()
        trainer.train()
        secs = time.perf_counter() - t0
        back = (signal.getsignal(signal.SIGTERM) is marker
                and signal.getsignal(signal.SIGINT) is old_int)
    finally:
        signal.signal(signal.SIGTERM, old_term)
    ck = Path(cfg.ckpts_dir) / "ckpt_P"
    records = life_records(cfg)
    say(f"[lifecycle] preemption: SIGTERM in step {LIFE_PREEMPT_AT} of "
        f"epoch 0 -> train() returned after {seen} in {secs:.2f} s, files "
        f"{sorted(p.name for p in ck.iterdir())}, record "
        f"preempted_at_step={records[-1].get('preempted_at_step')}, "
        f"handlers restored {back}")
    if seen != list(range(1, LIFE_PREEMPT_AT + 1)) or not back \
            or not (ck / "epoch1.pkl").exists() \
            or (ck / "epoch2.pkl").exists() or len(records) != 1 \
            or records[0].get("preempted_at_step") != LIFE_PREEMPT_AT:
        fail("[lifecycle] the preempted run did not save and return")
    resumed = Trainer(cfg.with_overrides(resume=True, ckpt_epoch=1), ds,
                      device=dev)
    resumed.train()
    records = life_records(cfg)
    want = LIFE_PREEMPT_AT + LIFE_SIZE // BATCH
    say(f"[lifecycle] resumed from epoch1.pkl: step {resumed.state.step} "
        f"(want {want}), epoch 1 loss {records[-1]['loss']:.4f}")
    if resumed.state.step != want or not (ck / "epoch2.pkl").exists() \
            or not np.isfinite(records[-1]["loss"]):
        fail("[lifecycle] the run resumed after the preemption did not "
             "train on")
    shutil.rmtree(ck, ignore_errors=True)


def life_async(torch, dev, work: Path, card: str):
    """Three epochs with keep_last_ckpts=1, the pickles written at once and
    then by the async saver: only epoch3.pkl and its side file remain; the
    saver's pickle equals ``save_checkpoint`` of the same state byte for
    byte; each epoch's wall time on both, the pickle's size and its write
    time. -> (the saver's epoch3.pkl, its config, the dataset)."""
    from mcan_vqa_tpu_torch.train.checkpoint import save_checkpoint
    from mcan_vqa_tpu_torch.train.trainer import Trainer

    walls = {}
    for name, on in (("sync", False), ("async", True)):
        cfg = life_config(work, name, max_epoch=3, keep_last_ckpts=1,
                          ckpt_async=on)
        ds = life_dataset(cfg)
        trainer = Trainer(cfg, ds, device=dev)
        trainer.train()
        walls[name] = [r["wall_s"] for r in life_records(cfg)]
        ck = Path(cfg.ckpts_dir) / f"ckpt_{name}"
        names = sorted(p.name for p in ck.iterdir())
        if names != ["epoch3.act_scales.json", "epoch3.pkl"]:
            fail(f"[lifecycle] {name}: {names} remain after pruning")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = save_checkpoint(trainer.state, str(work / "again"), "async", 3,
                            cfg.lr_base)
    write_s = time.perf_counter() - t0
    mb = Path(again).stat().st_size / 1e6
    same = Path(again).read_bytes() == (ck / "epoch3.pkl").read_bytes()
    say(f"[lifecycle] keep_last_ckpts=1 over 3 epochs: only epoch3.pkl and "
        f"epoch3.act_scales.json remain, with the saver and without; the "
        f"saver's pickle equals save_checkpoint of the same state byte for "
        f"byte: {same}")
    say(f"[lifecycle] epoch wall s ({LIFE_SIZE // BATCH} steps + the "
        f"pickle), saver off {[round(w, 3) for w in walls['sync']]}, saver "
        f"on {[round(w, 3) for w in walls['async']]}; one pickle {mb:.1f} "
        f"MB written at once in {write_s:.3f} s ({card})")
    if not same:
        fail("[lifecycle] the async saver's pickle differs from the sync one")
    shutil.rmtree(work / "again", ignore_errors=True)
    shutil.rmtree(Path(cfg.ckpts_dir) / "ckpt_sync", ignore_errors=True)
    return ck / "epoch3.pkl", cfg, ds


def life_serve(torch, dev, rows, ckpt: Path, cfg, ds, card: str) -> None:
    """``Predictor.from_checkpoint`` of the calibrated pickle at its
    default engine, with q8aux=True and with engine="int4": the stored
    scales, no online collection, the exact launches of level 3 (q8aux:
    with the aux sites; int4: level 5), agreement with the plain engine;
    then the B=64 forward of the level-3 engine against level 1."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.checkpoint import load_act_scales

    L = cfg.layer
    stored = load_act_scales(str(ckpt))
    if not stored or "aux" not in stored or len(stored) != 2 * L + 1:
        fail(f"[lifecycle] the side file holds {sorted(stored or {})}")
    vocab = {"PAD": 0, "UNK": 1}
    vocab.update({f"t{i}": i for i in range(2, ds.token_size)})
    kw = dict(ix_to_ans=ds.ix_to_ans, max_batch=BATCH,
              latency_buckets=LATENCY_BUCKETS, device=dev)
    plain = Predictor.from_checkpoint(str(ckpt), cfg, vocab, engine="plain",
                                      **kw)
    rng = np.random.default_rng(SEED + 13)

    def batch(n):
        qs = [" ".join(f"t{t}" for t in rng.integers(2, ds.token_size,
                                                      rng.integers(3, 15)))
              for _ in range(n)]
        fs = [rng.normal(size=(int(r), cfg.img_feat_size)).astype(np.float32)
              for r in rng.integers(10, cfg.img_feat_pad_size + 1, n)]
        return qs, fs

    requests = [batch(1), batch(1), batch(5), batch(BATCH),
                ([""], batch(1)[1])]
    n_ans = len(ds.ix_to_ans)
    preds = {}
    for label, extra, level, aux, bound, on in (
            ("default engine", {}, 3, False, INT8_BOUND, "sigmoid"),
            ("q8aux=True", dict(q8aux=True), 3, True, INT8_BOUND, "sigmoid"),
            ('engine="int4"', dict(engine="int4"), 5, False, INT4_BOUND,
             "softmax")):
        pred = Predictor.from_checkpoint(str(ckpt), cfg, vocab, **extra,
                                         **kw)
        cal = pred.calibration
        say(f"[lifecycle] from_checkpoint({ckpt.name}, {label}): engine "
            f"{pred.engine!r}, calibration {cal}, scales equal the side "
            f"file {pred.act_scales == stored}")
        if pred.act_scales != stored or cal["state"] != "calibrated" \
                or cal["samples"] != 0:
            fail(f"[lifecycle] {label}: not served from the stored scales")
        K.reset_launches()
        probs = [pred.predict_probs(q, f) for q, f in requests]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_launches(f"lifecycle: from_checkpoint, {label}", counts,
                       serve_launches(L, level, aux), len(requests))
        names = INT4_SERVE_KERNELS if level >= 4 else INT8_SERVE_KERNELS
        rows.launches(f"lifecycle: from_checkpoint, {label}", counts,
                      [k for k in names if counts.get(k)])
        agreement(f"lifecycle {label} (level {level}{' + aux' if aux else ''}"
                  f", stored scales)", requests, probs, plain, n_ans,
                  bound=bound, on=on)
        preds[label] = pred
    level1 = Predictor.from_checkpoint(str(ckpt), cfg, vocab, engine="fused",
                                       act_scales=False, auto_calibrate=0,
                                       **kw)
    img, ques = level1.pad_batch(*batch(BATCH))
    engines = (("level 3", preds["default engine"]), ("level 1", level1))
    t = {name: [] for name, _ in engines}
    for _ in range(ROUNDS):
        for name, pred in engines:
            t[name].append(cuda_ms(torch, lambda: pred.forward_padded(
                img, ques), iters=10))
    say(f"[lifecycle] B={BATCH} forward of the checkpoint's engines, median "
        f"of {ROUNDS} rounds of 10 (CUDA events, eager): " + ", ".join(
            f"{n} {float(np.median(ms)):.3f} ms ({min(ms):.3f}-"
            f"{max(ms):.3f})" for n, ms in t.items()) + f" ({card})")


def life_bf16_moment(torch, dev, work: Path) -> None:
    """opt_mu_dtype="bfloat16": one epoch, the pickle's exp_avg f32 holding
    bf16 values (the live moment bf16), then six steps on one batch whose
    loss falls."""
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    cfg = life_config(work, "bf16", max_epoch=1, opt_mu_dtype="bfloat16",
                      ckpt_calibrate=False)
    trainer = Trainer(cfg, life_dataset(cfg), device=dev)
    trainer.train()
    blob = torch.load(Path(cfg.ckpts_dir) / "ckpt_bf16" / "epoch1.pkl",
                      map_location="cpu", weights_only=True)
    moments = [s["exp_avg"] for s in blob["optimizer"]["state"].values()]
    live = {s["exp_avg"].dtype for s in trainer.state.optimizer.state
            .values()}
    exact = all(m.dtype == torch.float32 and torch.equal(
        m.to(torch.bfloat16).float(), m) for m in moments)
    batch = next(iter(trainer.loader()))
    losses = [float(trainer.step_fn(trainer.state, batch)["loss"])
              for _ in range(6)]
    say(f"[lifecycle] opt_mu_dtype='bfloat16': live first moments "
        f"{sorted(str(d) for d in live)}, the pickle's {len(moments)} f32 "
        f"and bf16-exact {exact}; one batch, 6 steps: loss {losses[0]:.3f} "
        f"-> {losses[-1]:.3f}")
    if live != {torch.bfloat16} or not exact or not losses[-1] < losses[0]:
        fail("[lifecycle] the bf16 first moment did not train or save")
    shutil.rmtree(Path(cfg.ckpts_dir) / "ckpt_bf16", ignore_errors=True)


def lifecycle_path(torch, dev, rows, work: Path, card: str) -> None:
    """The phase's sub-steps in order, each timed."""
    for name, fn in (
            ("resume", lambda: life_resume(torch, dev, rows, work)),
            ("preemption", lambda: life_preempt(torch, dev, work)),
            ("bf16 first moment", lambda: life_bf16_moment(torch, dev,
                                                           work))):
        t0 = time.perf_counter()
        fn()
        say(f"[lifecycle] {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ckpt, cfg, ds = life_async(torch, dev, work, card)
    say(f"[lifecycle] async saver and pruning: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    life_serve(torch, dev, rows, ckpt, cfg, ds, card)
    say(f"[lifecycle] calibrated checkpoint: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase [eval]: VQA-v2-format files through run_vqa --run train / val /
# test / parity, evaluated by the int8 serving engine
# ---------------------------------------------------------------------------

EVAL_IMAGES = {"train": 96, "val": 160, "test": 40}   # two questions each
EVAL_EPOCHS = 2
EVAL_LARGE_SIZE = 96          # [train large]'s synthetic val set


def top1_gate(label, pf, pp, bound=INT8_BOUND) -> None:
    """Top-1 of the fused engine's probabilities ``pf`` against the plain
    engine's ``pp`` row by row, a flip allowed only inside a near-tie (the
    plain engine's top two within 2 x bound), and max |dprob| <= bound."""
    if pf.shape != pp.shape or not np.isfinite(pf).all():
        fail(f"{label}: bad probabilities: shape {pf.shape} vs {pp.shape}")
    worst = float(np.abs(pf - pp).max())
    a, b = pf.argmax(1), pp.argmax(1)
    rows_ = np.arange(len(a))
    flips = a != b
    near = flips & (pp[rows_, b] - pp[rows_, a] <= 2 * bound)
    say(f"[agree] {label}: fused vs plain eval engine top-1 "
        f"{int((~flips).sum())}/{len(a)} (+{int(near.sum())} near-ties, "
        f"{int((flips & ~near).sum())} flips), max|dprob| {worst:.3e} <= "
        f"bound {bound:.0e}")
    if worst > bound or (flips & ~near).any():
        fail(f"{label}: the fused and the plain eval engines disagree")


def eval_main_path(torch, dev, rows, work: Path, card: str) -> None:
    """Main path 4: a miniature VQA-v2 dataset in its own file formats
    (``data/vqa_files.py``) at MCAN-small's full width, its train split
    packed (``cli/pack_features.py``), val and test left as npz; then
    ``run_vqa --run train --eval_ee true`` for EVAL_EPOCHS epochs (the
    Trainer evaluating val after each epoch and once more at the end) and
    ``--run val`` / ``test`` / ``parity`` from the epoch pickle, every
    evaluation through the fused eval engine (int8 level 1). Gates: the
    exact launches of the train steps and eval batches, the fused against
    the plain eval engine, every val question scored and every test
    question once in the EvalAI dumps, ``--run val`` equal bit for bit to
    the in-process ``Trainer.predict``."""
    from mcan_vqa_tpu_torch.cli import pack_features, run_vqa
    from mcan_vqa_tpu_torch.data.vqa_dataset import VQADataset
    from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files
    from mcan_vqa_tpu_torch.evals import vqa_eval
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.checkpoint import load_params
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_route

    root = work / "vqa"
    t0 = time.perf_counter()
    paths = write_vqa_files(str(root), images=EVAL_IMAGES, seed=SEED)
    if pack_features.main(["--split", "train", "--feature_path",
                           paths["feature_path"], "--cache_path",
                           str(root / "cache")]) != 0:
        fail("pack_features failed")
    flags = dict(paths, feature_cache_path=str(root / "cache") + "/",
                 vocab_cache_path=str(root / "vocab.npz"),
                 ckpts_dir=str(root / "ckpts"), log_path=str(root / "log"),
                 result_path=str(root / "results") + "/",
                 pred_path=str(root / "pred") + "/", version="eval",
                 seed=str(SEED), batch_size=str(BATCH), split="train",
                 verbose="false")
    argv = [x for k, v in flags.items() for x in (f"--{k}", v)]
    cfg = run_vqa.build_config(run_vqa.parse_args(
        ["--run", "val", "--ckpt_epoch", str(EVAL_EPOCHS), *argv]))
    train, val, test = (VQADataset(cfg, m) for m in ("train", "val", "test"))
    if set(train._packed) != {"train"} or val._packed or test._packed \
            or not val._npz_paths or not test._npz_paths:
        fail("[eval] the train split is not read from the packed cache, or "
             "val / test not from the npz files")
    say(f"[eval] VQA-v2-format files (2048-d BUTD npz, 10-60 regions, the "
        f"frozen 3129 answers): {len(train)} train / {len(val)} val / "
        f"{len(test)} test questions, vocabulary {train.token_size}, train "
        f"packed, val and test npz, written in "
        f"{time.perf_counter() - t0:.1f} s")

    n_eval = -(-len(val) // cfg.eval_batch_size)
    n_steps = EVAL_EPOCHS * (len(train) // BATCH)
    step = expected_step_launches(cfg, engine_route(cfg.hidden_size), True)
    serve = serve_launches(cfg.layer, 1)
    want = {k: n_steps * step.get(k, 0)
            + (EVAL_EPOCHS + 1) * n_eval * serve.get(k, 0)
            for k in set(step) | set(serve)}
    K.reset_launches()
    t0 = time.perf_counter()
    if run_vqa.main(["--run", "train", "--eval_ee", "true", "--max_epoch",
                     str(EVAL_EPOCHS), *argv]) != 0:
        fail("run_vqa --run train failed")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    say(f"[eval] run_vqa --run train --eval_ee true: {n_steps} steps and "
        f"{EVAL_EPOCHS + 1} x {n_eval} eval batches in "
        f"{time.perf_counter() - t0:.1f} s")
    check_launches("eval: run_vqa --run train", counts,
                   {k: n for k, n in want.items() if n}, 1)
    rows.launches("eval: run_vqa --run train", counts,
                  [k for k in TRAIN_KERNELS if step.get(k)]
                  + [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    log = (Path(cfg.log_path) / "log_run_eval.txt").read_text()
    lines = [ln for ln in log.splitlines()
             if "eval engine" in ln or " eval val" in ln]
    for ln in lines:
        say(f"  the Trainer logged: {ln}")
    if not any("eval engine: fused" in ln for ln in lines) \
            or sum(" eval val" in ln for ln in lines) != EVAL_EPOCHS:
        fail("[eval] the Trainer did not log the fused eval engine and one "
             "evaluation an epoch")

    fused = Trainer(cfg, eval_datasets={"val": val}, device=dev)
    plain = Trainer(cfg.with_overrides(eval_engine="plain"),
                    eval_datasets={"val": val}, device=dev)
    if not fused.fused_eval or plain.fused_eval:
        fail("[eval] eval_engine 'auto' did not choose the fused engine on "
             "the card")
    weights = load_params(cfg)
    fused.model.load_state_dict(weights)
    plain.model.load_state_dict(weights)
    times = {}
    for name, t in (("fused", fused), ("plain", plain)) * 2:
        K.reset_launches()
        start = time.perf_counter()
        out = t.predict(val)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - start
        counts = K.launch_counts()
        if name == "fused":
            check_launches("eval: Trainer.predict (fused)", counts, serve,
                           n_eval)
            pf = out
        elif counts:
            fail(f"[eval] the plain eval engine launched {counts}")
        else:
            pp = out
    top1_gate("eval, the epoch checkpoint on val", pf["probs"], pp["probs"])
    if list(pf["qids"]) != [q["question_id"] for q in val.ques_list]:
        fail("[eval] predict did not return every val question once, in "
             "order")
    say(f"[eval] Trainer.predict over {len(val)} val questions (eval batch "
        f"{cfg.eval_batch_size}, loader and engine build included, warm): "
        f"fused {len(val) / times['fused']:.1f} samples/s, plain "
        f"{len(val) / times['plain']:.1f} samples/s ({card})")

    res = fused.evaluate(val)
    gts = {a["question_id"]: a for a in val.ans_list}
    K.reset_launches()
    if run_vqa.main(["--run", "val", "--ckpt_epoch", str(EVAL_EPOCHS),
                     "--save_pred", "true", *argv]) != 0:
        fail("run_vqa --run val failed")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_launches("eval: run_vqa --run val", counts, serve, n_eval)
    rows.launches("eval: run_vqa --run val", counts,
                  [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    saved = np.load(Path(cfg.pred_path) / "pred_run_eval.npz")
    if not (np.array_equal(saved["probs"], pf["probs"])
            and np.array_equal(saved["qids"], pf["qids"])):
        fail("[eval] --run val's probabilities differ from the in-process "
             "predict's")
    dump = Path(cfg.result_path) / "result_run_eval.json"
    loaded = vqa_eval.load_results(str(dump))
    if sorted(loaded) != sorted(gts) or len(json.loads(dump.read_text())) \
            != len(val):
        fail("[eval] the val dump does not hold every val question once")
    scored = vqa_eval.evaluate({q: {"answers": [x["answer"] for x in
                                                a["answers"]]}
                                for q, a in gts.items()}, loaded)["overall"]
    if scored != res["accuracy"]:
        fail(f"[eval] the val dump scores {scored}, evaluate said "
             f"{res['accuracy']}")
    say(f"[eval] run_vqa --run val from epoch{EVAL_EPOCHS}.pkl: probabilities "
        f"equal bit for bit to Trainer.predict; all {len(val)} val questions "
        f"scored: accuracy {res['accuracy']}, per answer type "
        f"{res['perAnswerType']} (the dump rescored: {scored})")

    for mode in ("test", "parity"):
        if run_vqa.main(["--run", mode, "--ckpt_epoch", str(EVAL_EPOCHS),
                         *argv]) != 0:
            fail(f"run_vqa --run {mode} failed")
    want_qids = [q["question_id"] for q in test.ques_list]
    for name in ("result_run_eval.json", "result_run_eval_testdev.json"):
        got = json.loads((Path(cfg.result_path) / name).read_text())
        if sorted(r["question_id"] for r in got) != sorted(want_qids):
            fail(f"[eval] {name} does not hold every test question once")
    parity_val = Path(cfg.result_path) / "result_run_eval_val.json"
    if vqa_eval.load_results(str(parity_val)) != loaded:
        fail("[eval] --run parity's val dump differs from --run val's")
    say(f"[eval] run_vqa --run test and --run parity: all {len(test)} test "
        f"questions once in each EvalAI dump; parity's val dump equals "
        f"--run val's")


def evaluate_large(torch, trainer, rows) -> None:
    """[train large]'s last step: one ``Trainer.evaluate`` of the CLI's
    synthetic val set (seed 1, with targets) through the fused eval engine
    at MCAN-large width: int8 level 1 with the qkv int8 (D 1024), eval batch
    32 (64 in two micro-batches); exact launches, the plain eval engine's
    top-1 and probabilities."""
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.ops import kernels as K
    cfg = trainer.cfg
    ds = SyntheticVQADataset(cfg, size=EVAL_LARGE_SIZE, answer_size=3129,
                             seed=1)
    if not trainer.fused_eval or cfg.eval_batch_size != BATCH // 2:
        fail(f"[train large] eval engine fused={trainer.fused_eval}, eval "
             f"batch {cfg.eval_batch_size}")
    K.reset_launches()
    t0 = time.perf_counter()
    res = trainer.evaluate(ds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    n = -(-len(ds) // cfg.eval_batch_size)
    check_launches("train large: evaluate", counts,
                   serve_launches(cfg.layer, 1, D=cfg.hidden_size), n)
    dh128 = {"masked_attention_dh128": "masked_attention"}
    rows.launches("train large: evaluate", counts,
                  [k for k in INT8_SERVE_KERNELS
                   if k not in ("masked_attention", "masked_attention_f32")])
    rows.launches("train large: evaluate", counts, dh128, key=dh128)
    fused_probs = trainer.predict(ds)["probs"]
    trainer.fused_eval = False
    plain_probs = trainer.predict(ds)["probs"]
    trainer.fused_eval = True
    top1_gate("train large: evaluate", fused_probs, plain_probs)
    if not 0.0 <= res["roc_micro"] <= 1.0:
        fail(f"[train large] ROC {res}")
    say(f"[train large] Trainer.evaluate on the synthetic val set "
        f"({len(ds)} samples, {n} batches of {cfg.eval_batch_size}, int8 "
        f"level 1 + qkv at D {cfg.hidden_size}) in {secs:.2f} s: ROC micro "
        f"{res['roc_micro']:.4f}, macro {res['roc_macro']:.4f}")


# ---------------------------------------------------------------------------
# phase [classify]: ClassifierNet and the classify task
# ---------------------------------------------------------------------------

CLASSIFY_LABELS = 14
CLASSIFY_STEPS = 4            # MCAN-small: 4 steps, the in-epoch eval at 2, 4
CLASSIFY_LARGE_STEPS = 2
CLASSIFY_EVAL_SIZE = 96
CLASSIFY_FIXED_STEPS = 4      # steps on one batch: its loss must fall
CLASSIFY_LEVELS = (("level 1", None), ("level 3", 3), ("level 5", 5),
                   ("level 7", 7), ("bf16", 0))


def classifier_launches(L: int, level):
    """Every kernel's launches in one MCAN-small classifier forward at this
    level (0: all bf16; None: level 1): per SA block the qkv, the merge and
    the FFN's two products, one attention, two LayerNorms, quantized as
    ``serve_launches`` says; the image projection, AttFlat and the head
    are plain products."""
    level = 1 if level is None else level
    blocks = ({"fused_sa_block": L} if level == 0
              else {"fused_qffn_sa_block": L})
    if level >= 4:
        blocks[f"fused_qffn_sa_block_level{level}"] = L
    int4 = {4: 2, 5: 3, 6: 2, 7: 3}.get(level, 0) * L
    int8 = {0: 0, 1: 2 * L, 3: 4 * L}.get(level, 4 * L - int4)
    counts = dict(blocks, gemm_bias_act=4 * L - int8 - int4,
                  residual_layernorm=2 * L, gemm_s8=int8,
                  quantize_rows=int8 + int4 * (level < 6))
    counts["gemm_s4" if level < 6 else "gemm_w4bf16"] = int4
    counts["masked_attention_f32" if level >= 3 else "masked_attention"] = L
    return {k: n for k, n in counts.items() if n}


def classify_config(work: Path, model: str, **kw):
    from mcan_vqa_tpu_torch.configs import Config
    return Config.for_model(model, img_feat_size=1024, max_epoch=1,
                            batch_size=BATCH, seed=SEED + 11,
                            ckpts_dir=str(work / "ckpts"),
                            log_path=str(work / "log"), verbose=False, **kw)


def classify_images(torch, dev, cfg, n: int, empty=(5, 40)):
    """n images as ``SyntheticMIMICDataset`` makes them (L2-normalized
    regions, 30% of them zeroed), the samples ``empty`` with no region."""
    from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
    ds = SyntheticMIMICDataset(cfg, size=n, answer_size=CLASSIFY_LABELS,
                               run_mode="train", seed=SEED)
    img = np.stack([ds.example(i)["img"] for i in range(n)])
    img[[i for i in empty if i < n]] = 0.0
    return torch.from_numpy(img).to(dev)


def classify_serve(torch, dev, rows, card: str) -> None:
    """ClassifierNet at MCAN-small width served by
    ``build_production_classifier_engine`` at level 1, level 3 calibrated,
    levels 5 and 7, and qffn=0, at B = 1 and 64: exact launches per
    forward, each int8 / bf16 engine against the plain forward on the
    sigmoid (INT8_BOUND / 1e-2), int4 against level 3 (0.04: JAX's
    classifier gates, tests/test_quant.py:759, :790); then the forward
    times, rounds of every engine in turn."""
    from mcan_vqa_tpu_torch.models.net import ClassifierNet
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import \
        build_production_classifier_engine
    cfg = classify_config(ROOT / "ckpts", "small")
    L, H = cfg.layer, cfg.multi_head
    net = ClassifierNet(cfg, CLASSIFY_LABELS,
                        generator=torch.Generator().manual_seed(SEED + 12))
    net = net.to(dev).eval()
    sd = net.state_dict()
    x = classify_images(torch, dev, cfg, BATCH)
    say(f"[classify] ClassifierNet (hidden {cfg.hidden_size}, {L} SA "
        f"layers, {H} heads, ff {cfg.ff_size}, img_feat_size "
        f"{cfg.img_feat_size}, {cfg.img_feat_pad_size} regions, "
        f"{CLASSIFY_LABELS} labels, seeded weights) on SyntheticMIMICDataset "
        f"features, samples 5 and 40 with no region")
    with torch.no_grad():
        plain = {B: torch.sigmoid(net(x[:B]).float()) for B in (1, BATCH)}
    engines = {}
    for name, level in CLASSIFY_LEVELS:
        kw = dict(act_scale_inputs=x) if level and level >= 3 else {}
        engines[name] = (level, *build_production_classifier_engine(
            sd, L, H, qffn=level, device=dev, **kw))
    probs = {}
    with torch.no_grad():
        for name, (level, fwd, prep) in engines.items():
            if (fwd.act_scales is None) != (level in (None, 0)):
                fail(f"[classify] {name}: static scales {fwd.act_scales}")
            for B in (1, BATCH):
                K.reset_launches()
                out = fwd(prep, x[:B])
                torch.cuda.synchronize()
                counts = K.launch_counts()
                check_launches(f"classify {name} B={B}", counts,
                               classifier_launches(L, level), 1)
                rows.launches(f"classify {name} B={B}", counts,
                              [k for k in counts if k in rows.rows])
                probs[name, B] = torch.sigmoid(out.float())
    for name, level in CLASSIFY_LEVELS:
        for B in (1, BATCH):
            p = probs[name, B]
            if p.shape != (B, CLASSIFY_LABELS) or not bool(
                    torch.isfinite(p).all()):
                fail(f"[classify] {name} B={B}: bad probabilities")
            if level in (5, 7):
                gate(f"classify {name} vs level 3 B={B}, sigmoid",
                     max_err(p, probs["level 3", B]), INT4_BOUND)
            else:
                gate(f"classify {name} vs plain B={B}, sigmoid",
                     max_err(p, plain[B]),
                     1e-2 if level == 0 else INT8_BOUND)
    for B in (1, BATCH):
        timed = [(n, lambda fwd=fwd, prep=prep, B=B: fwd(prep, x[:B]))
                 for n, (_, fwd, prep) in engines.items()]
        timed.append(("plain", lambda B=B: net(x[:B])))
        ms = {n: [] for n, _ in timed}
        with torch.no_grad():
            for _ in range(ROUNDS):
                for n, fn in timed:
                    ms[n].append(cuda_ms(torch, fn, iters=10, warmup=2))
        say(f"[classify] B={B} forward, median of {ROUNDS} rounds (CUDA "
            f"events, eager, every engine in turn; {card}): " + ", ".join(
                f"{n} {float(np.median(v)):.3f} ms" for n, v in ms.items()))


def classify_train(torch, dev, rows, work: Path, model: str, steps: int,
                   card: str):
    """``Trainer(task="classify")`` for one epoch of ``steps`` B=64 steps
    at the model's full width, dropout 0.1 inside the SA train kernels:
    every step's loss against the plain blocks' from the same weights and
    generator state (1e-3 relative), its exact launches, the generator
    drawing only AttFlat's mask; the in-epoch eval lines; the seeded SA
    train blocks at [64, 60, D] against the blocks fed their dump (bit for
    bit) and their plain twins. -> the trainer, the last batch's images."""
    from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_classifier_forward
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    cfg = classify_config(work, model, eval_interval=2)
    tag = f"classify train {model}"
    L, H, D, F = cfg.layer, cfg.multi_head, cfg.hidden_size, cfg.ff_size
    ds = SyntheticMIMICDataset(cfg, size=steps * BATCH,
                               answer_size=CLASSIFY_LABELS, run_mode="train",
                               seed=SEED)
    val = SyntheticMIMICDataset(cfg, size=CLASSIFY_EVAL_SIZE,
                                answer_size=CLASSIFY_LABELS, run_mode="val",
                                seed=1)
    trainer = Trainer(cfg, ds, eval_datasets={"val": val}, task="classify",
                      device=dev)
    if not (trainer.fused and trainer.in_kernel_dropout
            and trainer.fused_eval):
        fail(f"[{tag}] the Trainer chose fused={trainer.fused}, "
             f"in_kernel_dropout={trainer.in_kernel_dropout}, fused eval "
             f"{trainer.fused_eval}")
    plain_fwd = make_fused_classifier_forward(
        L, H, dropout_rate=cfg.dropout_rate, sa_block="plain",
        dropout_bits=cfg.dropout_bits, in_kernel_dropout=True)
    real_step = trainer.step_fn
    log, last = [], {}
    draws = MaskDraws()

    def step(state, batch):
        state.seed_step()
        ref, g = engine_loss(
            torch, dev, cfg, lambda m, img, _, g: plain_fwd(m, img, g),
            state.model, batch, state.generator.get_state())
        before = K.launch_counts()
        draws.take()
        draws.active = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = real_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        draws.active = False
        after = K.launch_counts()
        last["img"] = batch["img"]
        log.append(dict(loss=float(metrics["loss"]), plain=ref,
                        ms=start.elapsed_time(end), masks=draws.take()[0],
                        same_draws=torch.equal(g.get_state(),
                                               state.generator.get_state()),
                        counts={k: after.get(k, 0) - before.get(k, 0)
                                for k in TRAIN_KERNELS}))
        return metrics

    trainer.step_fn = step
    say(f"[{tag}] Trainer(task='classify', hidden {D}, ff {F}, {L} layers, "
        f"{H} heads, flat_out {cfg.flat_out_size}, batch {BATCH} in "
        f"{cfg.grad_accu_steps} micro-batch(es), 1 epoch of {steps} steps, "
        f"eval_interval 2) on SyntheticMIMICDataset({CLASSIFY_LABELS} "
        f"labels)")
    K.reset_launches()
    try:
        trainer.train()
    finally:
        draws.close()
    torch.cuda.synchronize()
    if len(log) != steps:
        fail(f"[{tag}] {len(log)} steps, expected {steps}")
    want = {k: 0 for k in TRAIN_KERNELS}
    for k, c in SA_PER_BLOCK.items():
        want[k + "_prng" if k in BLOCK_COUNTERS else k] += \
            c * L * cfg.grad_accu_steps
    for i, r in enumerate(log):
        if r["counts"] != want:
            fail(f"[{tag}] step {i}: launches {r['counts']}, expected "
                 f"{want}")
        if not r["same_draws"] or r["masks"] != ["img"] * \
                cfg.grad_accu_steps:
            fail(f"[{tag}] step {i}: generator masks {r['masks']}")
        if not np.isfinite(r["loss"]):
            fail(f"[{tag}] step {i}: loss {r['loss']}")
        rel = loss_gate(f"{tag} step {i}", r["loss"], r["plain"])
        say(f"  step {i}: loss {r['loss']:.6f} (the plain blocks "
            f"{r['plain']:.6f}, rel {rel:.2e} <= 1e-3), {r['ms']:.3f} ms")
    step_counts = {k: sum(r["counts"][k] for r in log) for k in want}
    if model == "small":
        rows.launches(tag, step_counts, [k for k in want if want[k]])
    else:
        rows.launches(tag, step_counts, [k for k in want if want[k]
                                         and k not in LARGE_ROWS.values()])
        rows.launches(tag, step_counts, LARGE_ROWS, key=LARGE_ROWS)
    ms = [r["ms"] for r in log[1:]]
    say(f"[{tag}] every step ran {L} SA blocks x {cfg.grad_accu_steps} "
        f"micro-batch(es) through the SA train kernels with in-kernel "
        f"dropout (one seed a block); step time (steps 2..{steps}, CUDA "
        f"events): mean {sum(ms) / len(ms):.3f} ms, min {min(ms):.3f} ms "
        f"({card})")
    logged = (Path(cfg.log_path) / f"log_run_{cfg.run_version}.txt") \
        .read_text().splitlines()
    engine = [ln for ln in logged if "train engine" in ln]
    evals = [ln for ln in logged if ln.startswith("  [step ")]
    say(f"[{tag}] the Trainer logged: {engine}; {evals}")
    if not engine or "fused SA blocks (classifier, in_kernel_dropout=True)" \
            not in engine[0]:
        fail(f"[{tag}] the Trainer did not log the fused classifier engine")
    if [ln.split("]")[0] for ln in evals] != [
            f"  [step {s}" for s in range(2, steps + 1, 2)] \
            or not all(" val: {'roc_micro': " in ln for ln in evals):
        fail(f"[{tag}] the in-epoch eval lines: {evals}")

    # the seeded SA train block at [64, 60, D]
    rate, seed = cfg.dropout_rate, PRNG_SEED + 3
    Lv = cfg.img_feat_pad_size
    x, mask, _, w, _, probe = sa_block_inputs(torch, dev, BATCH, L=Lv, D=D,
                                              F=F, H=H)
    mask = pad_mask(torch, BATCH, Lv, [(i * 17) % (Lv + 1)
                                       for i in range(BATCH)], dev)
    masks, inv = sa.dump_sa_prng_masks(seed, rate, BATCH, Lv, D, F, H,
                                       device=dev)
    seeded_vs_dump(
        torch, f"{tag}: SA train block, B={BATCH} L={Lv} D={D} H={H}",
        lambda ls, ws: sa.fused_sa_block_train(*ls, mask, seed, ws,
                                               num_heads=H, rate=rate),
        lambda ls, ws: sa.fused_sa_block_train(*ls, mask, masks, ws,
                                               num_heads=H, inv_keep=inv),
        lambda ls, ws: sa.fused_sa_block_train_plain(
            *ls, mask, seed, ws, num_heads=H, rate=rate),
        (x,), ("x",), w, sa.SA_WEIGHT_NAMES, probe, rows,
        lambda n: "sa_train_fwd_prng" if n is None else "sa_train_bwd_prng")
    return trainer, last["img"]


def classify_eval(torch, dev, rows, trainer, last_img) -> None:
    """``Trainer.evaluate``'s ROC-AUC through the fused eval engine (level
    1, exact launches), against the plain eval engine (INT8_BOUND); the
    end-of-train side file loaded into ``build_production_classifier_engine
    (act_scales=...)`` against the engine calibrated on the last batch, bit
    for bit; then the loss on one batch falls over CLASSIFY_FIXED_STEPS
    steps on it."""
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops.serving import \
        build_production_classifier_engine
    from mcan_vqa_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     load_act_scales)
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    cfg = trainer.cfg
    val = trainer.eval_datasets["val"]
    n = -(-len(val) // cfg.eval_batch_size)
    K.reset_launches()
    res = trainer.evaluate(val)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_launches("classify: evaluate", counts,
                   classifier_launches(cfg.layer, None), n)
    if not (0.0 <= res["roc_micro"] <= 1.0 and 0.0 <= res["roc_macro"] <= 1.0):
        fail(f"[classify] ROC-AUC {res}")
    fused = trainer.predict(val)["probs"]
    trainer.fused_eval = False
    plain = trainer.predict(val)["probs"]
    trainer.fused_eval = True
    worst = float(np.abs(fused - plain).max())
    say(f"[classify] Trainer.evaluate ({len(val)} samples, {n} batches of "
        f"{cfg.eval_batch_size}): ROC micro {res['roc_micro']:.4f}, macro "
        f"{res['roc_macro']:.4f}; fused vs plain eval engine max|dprob| "
        f"{worst:.3e} <= {INT8_BOUND:.0e}")
    if worst > INT8_BOUND:
        fail("[classify] the fused and the plain eval engines disagree")

    ckpt = checkpoint_path(cfg.ckpts_dir, cfg.run_version, 1)
    stored = load_act_scales(ckpt)
    if stored is None or set(stored) != {f"enc_{i}"
                                         for i in range(cfg.layer)}:
        fail(f"[classify] the end-of-train side file holds {stored}")
    sd = trainer.model.state_dict()
    x = classify_images(torch, dev, cfg, BATCH)
    outs = []
    with torch.no_grad():
        for kw in (dict(act_scales=stored), dict(act_scale_inputs=last_img)):
            fwd, prep = build_production_classifier_engine(
                sd, cfg.layer, cfg.multi_head, device=dev, **kw)
            outs.append(fwd(prep, x))
    torch.cuda.synchronize()
    if not torch.equal(*outs):
        fail("[classify] the side file's engine differs from the engine "
             "calibrated on the last batch")
    say(f"[classify] epoch1.act_scales.json ({len(stored)} blocks) builds "
        f"the level-3 engine equal bit for bit to the one calibrated on the "
        f"last train batch")

    batch = next(iter(trainer.loader()))
    state = trainer.state

    def fixed_loss():
        with torch.no_grad():
            return float(bce_with_logits_sum(trainer.model(batch["img"]),
                                             batch["target"]))

    losses = [fixed_loss()]
    for _ in range(CLASSIFY_FIXED_STEPS):
        trainer.step_fn(state, batch)
        losses.append(fixed_loss())
    say(f"[classify] one batch, {CLASSIFY_FIXED_STEPS} steps on it: loss "
        f"(plain forward, no dropout) " + " -> ".join(f"{v:.4f}"
                                                      for v in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("[classify] the loss on a fixed batch did not fall")


def classify_path(torch, dev, rows, work: Path, card: str) -> None:
    classify_serve(torch, dev, rows, card)
    trainer, last_img = classify_train(torch, dev, rows, work / "small",
                                       "small", CLASSIFY_STEPS, card)
    classify_eval(torch, dev, rows, trainer, last_img)
    del trainer
    trainer, _ = classify_train(torch, dev, rows, work / "large", "large",
                                CLASSIFY_LARGE_STEPS, card)
    del trainer


# ---------------------------------------------------------------------------
# phase [mimic]: MIMIC-CXR medical VQA on files in the real formats
# ---------------------------------------------------------------------------

MIMIC_IMAGES = 640
MIMIC_QUESTIONS = {"train": 512, "val": 128, "test": 128}
MIMIC_LABELS = 15
MIMIC_SHORT = 128             # the train questions of the two-step runs
MIMIC_FIXED_STEPS = 6         # steps on one batch: its loss must fall
MIMIC_ROWS = {"regions": 60, "anatomy": 26, "both": 86}


def mimic_short_prefix(paths) -> str:
    """The same files under a second prefix whose train split is the
    first MIMIC_SHORT questions (two B=64 steps an epoch)."""
    import pickle
    src, dst = paths["cxr_data_path"], paths["cxr_data_path"] + "short_"
    for name in ("ans2label", "label2ans", "dataset_val", "dataset_test",
                 "dataset_train"):
        blob = pickle.loads(Path(f"{src}{name}_full.pkl").read_bytes())
        if name == "dataset_train":
            blob = blob[:MIMIC_SHORT]
        Path(f"{dst}{name}_full.pkl").write_bytes(pickle.dumps(blob))
    return dst


def mimic_probe(torch, dev, runs):
    """Replace the trainer module's Trainer by a subclass that records, per
    Trainer built: each step's loss from one state against the plain
    blocks' from the same weights and generator state (the classifier's
    plain SA blocks for task "classify"), its launches by kernel, its time
    (CUDA events) and inputs; around ``warm_start`` the weights before and
    after and the AdamW state. -> a function that puts the Trainer back.""" 
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train import trainer as tmod
    from mcan_vqa_tpu_torch.train.fused_engine import (
        make_fused_classifier_forward, make_fused_train_forward)
    base = tmod.Trainer

    class Probe(base):
        def build_step(self, in_kernel_dropout):
            super().build_step(in_kernel_dropout)
            cfg = self.cfg
            run = dict(trainer=self, steps=[], last={}, warm=None)
            runs.append(run)
            if self.image_only:
                pf = make_fused_classifier_forward(
                    cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
                    sa_block="plain", dropout_bits=cfg.dropout_bits,
                    in_kernel_dropout=True)

                def plain_fwd(m, img, _, g):
                    return pf(m, img, g)
            else:
                plain_fwd = make_fused_train_forward(
                    cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
                    sga_block="plain", fused_encoder=True,
                    dropout_bits=cfg.dropout_bits, in_kernel_dropout=True)
            real = self.real_step_fn = self.step_fn

            def step(state, batch):
                state.seed_step()
                ref, g = engine_loss(torch, dev, cfg, plain_fwd, state.model,
                                     batch, state.generator.get_state())
                before = K.launch_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = real(state, batch)
                end.record()
                torch.cuda.synchronize()
                after = K.launch_counts()
                run["last"].update(img=batch["img"], ques=batch["ques"])
                run["steps"].append(dict(
                    loss=float(metrics["loss"]), plain=ref,
                    ms=start.elapsed_time(end),
                    same_draws=torch.equal(g.get_state(),
                                           state.generator.get_state()),
                    counts={k: after.get(k, 0) - before.get(k, 0)
                            for k in TRAIN_KERNELS}))
                return metrics

            self.step_fn = step

        def warm_start(self, path):
            fresh = {k: v.detach().clone()
                     for k, v in self.model.state_dict().items()}
            super().warm_start(path)
            runs[-1].update(
                warm=(fresh, path), opt_after_warm=(
                    self.state.step, len(self.state.optimizer.state)),
                warmed={k: v.detach().clone()
                        for k, v in self.model.state_dict().items()})

    tmod.Trainer = Probe

    def restore():
        tmod.Trainer = base
    return restore


def mimic_steps(tag, run, want) -> None:
    """Every recorded step: the exact launches ``want``, the generator
    where the plain replay leaves it, a finite loss within 1e-3 relative
    of the plain blocks'."""
    if not run["steps"]:
        fail(f"[{tag}] no train step ran")
    for i, r in enumerate(run["steps"]):
        if r["counts"] != want:
            fail(f"[{tag}] step {i}: launches {r['counts']}, expected "
                 f"{want}")
        if not r["same_draws"] or not np.isfinite(r["loss"]):
            fail(f"[{tag}] step {i}: loss {r['loss']}, the generator "
                 f"moved {'alike' if r['same_draws'] else 'otherwise'}")
        rel = loss_gate(f"{tag} step {i}", r["loss"], r["plain"])
        say(f"  [{tag}] step {i}: loss {r['loss']:.6f} (the plain blocks "
            f"{r['plain']:.6f}, rel {rel:.2e} <= 1e-3), {r['ms']:.3f} ms")
    say(f"  [{tag}] each step launched " + ", ".join(
        f"{k} {n}" for k, n in sorted(want.items()) if n))


def mimic_warm_gate(torch, run, log: str) -> None:
    """After ``warm_start``: every tensor whose shape the VQA pickle
    shares equal to the pickle's bit for bit, every other one equal to
    the fresh weights, one ``warm-start skip`` log line each, and the
    AdamW state fresh at step 0."""
    from mcan_vqa_tpu_torch.train.checkpoint import load_reference_checkpoint
    if run["warm"] is None:
        fail("[mimic] run_mimic did not warm-start")
    fresh, path = run["warm"]
    trainer = run["trainer"]
    vqa = load_reference_checkpoint(path)
    warmed = run["warmed"]
    skipped = sorted(k for k in fresh
                     if k not in vqa or vqa[k].shape != fresh[k].shape)
    for k in fresh:
        want = fresh[k] if k in skipped else vqa[k]
        if not torch.equal(warmed[k].cpu(), want.cpu()):
            fail(f"[mimic] warm start: {k} is neither the pickle's nor "
                 f"the fresh tensor it should be")
    lines = [ln for ln in log.splitlines()
             if ln.startswith("warm-start skip ")]
    named = sorted(ln.split()[2].rstrip(":") for ln in lines)
    must = {"img_feat_linear.weight", "proj.weight", "proj.bias"}
    if named != skipped or not must <= set(skipped):
        fail(f"[mimic] warm start skipped {skipped}, logged {named}")
    if run["opt_after_warm"] != (0, 0):
        fail(f"[mimic] warm start left the AdamW state at "
             f"{run['opt_after_warm']}")
    say(f"[mimic] warm start from {Path(path).name} (VQA MCAN-small, "
        f"img_feat_size 2048, 3129 answers): {len(fresh) - len(skipped)} "
        f"tensors equal the pickle's bit for bit, {len(skipped)} kept "
        f"fresh, one log line each: " + "; ".join(lines))


def mimic_eval_gates(torch, rows, trainer, tag) -> None:
    """The fused eval engine on val (exact launches per batch) against the
    plain one (INT8_BOUND on the probabilities), both ROC-AUCs."""
    from mcan_vqa_tpu_torch.evals.roc_auc import multilabel_roc_auc
    from mcan_vqa_tpu_torch.ops import kernels as K
    cfg = trainer.cfg
    val = trainer.eval_datasets["val"]
    n = -(-len(val) // cfg.eval_batch_size)
    serve = serve_launches(cfg.layer, 1)
    K.reset_launches()
    t0 = time.perf_counter()
    res = trainer.evaluate(val)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    check_launches(f"{tag}: Trainer.evaluate", counts, serve, n)
    rows.launches(f"{tag}: Trainer.evaluate", counts,
                  [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    fused = trainer.predict(val)
    trainer.fused_eval = False
    plain = trainer.predict(val)
    trainer.fused_eval = True
    worst = float(np.abs(fused["probs"] - plain["probs"]).max())
    rp = multilabel_roc_auc(plain["targets"] > 0.5, plain["probs"])
    if not (fused["probs"].shape == (len(val), MIMIC_LABELS)
            and np.isfinite(fused["probs"]).all()
            and res["roc_micro"] == multilabel_roc_auc(
                fused["targets"] > 0.5, fused["probs"])["micro"]):
        fail(f"[{tag}] evaluate {res} does not score the fused engine's "
             f"probabilities")
    say(f"[{tag}] Trainer.evaluate on val ({len(val)} questions, {n} "
        f"batches of {cfg.eval_batch_size}, {secs:.2f} s): fused engine ROC "
        f"micro {res['roc_micro']:.4f} macro {res['roc_macro']:.4f}; plain "
        f"engine ROC micro {rp['micro']:.4f} macro {rp['macro']:.4f}; fused "
        f"vs plain max|dprob| {worst:.3e} <= {INT8_BOUND:.0e}")
    if worst > INT8_BOUND:
        fail(f"[{tag}] the fused and the plain eval engines disagree")


def mimic_side_file(torch, dev, trainer, run) -> None:
    """The end-of-train side file's level-3 engine against the engine
    calibrated on the last train batch (``calibrate_serving_scales``), bit
    for bit."""
    from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                                calibrate_serving_scales)
    from mcan_vqa_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     load_act_scales)
    cfg = trainer.cfg
    L, H = cfg.layer, cfg.multi_head
    stored = load_act_scales(checkpoint_path(cfg.ckpts_dir, cfg.run_version,
                                             1))
    sd = trainer.model.state_dict()
    img, ques = run["last"]["img"], run["last"]["ques"]
    scales = calibrate_serving_scales(sd, img, ques, L, H, dev)
    if stored is None or stored != scales or len(stored) != 2 * L + 1:
        fail(f"[mimic] the side file holds {sorted(stored or {})}, the "
             f"last batch calibrates {sorted(scales or {})}")
    outs = []
    with torch.no_grad():
        for source in (stored, scales):
            fwd, prep = build_production_engine(sd, L, H, act_scales=source,
                                                device=dev)
            outs.append(fwd(prep, img, ques))
    torch.cuda.synchronize()
    if not torch.equal(*outs) or outs[0].shape != (BATCH, MIMIC_LABELS):
        fail("[mimic] the side file's engine differs from the engine "
             "calibrated on the last batch")
    say(f"[mimic] epoch1.act_scales.json ({len(stored)} entries, the aux "
        f"tuple included) equals the last train batch's calibration and "
        f"builds the level-3 engine equal bit for bit at B={BATCH}, "
        f"{MIMIC_LABELS} labels")


def mimic_fixed_batch(torch, trainer) -> None:
    """MIMIC_FIXED_STEPS steps on one batch: the loss (plain forward, no
    dropout) falls."""
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    batch = next(iter(trainer.loader()))

    def loss():
        with torch.no_grad():
            return float(bce_with_logits_sum(
                trainer.model(batch["img"], batch["ques"]), batch["target"]))

    losses = [loss()]
    for _ in range(MIMIC_FIXED_STEPS):
        trainer.real_step_fn(trainer.state, batch)
        losses.append(loss())
    say(f"[mimic] one batch, {MIMIC_FIXED_STEPS} steps on it: loss (plain "
        f"forward, no dropout) " + " -> ".join(f"{v:.4f}" for v in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("[mimic] the loss on a fixed batch did not fall")


def mimic_run_train(torch, dev, rows, paths, work, vqa_ckpt, card):
    """``run_mimic --run train`` in this process on "regions": one epoch of
    B=64 steps through the fused train engine with in-kernel dropout,
    warm-started from the [train] phase's VQA epoch pickle, the train split
    evaluated on its cadence beside val and test; then ``--run val`` from
    the checkpoint it wrote."""
    import contextlib
    import io
    from mcan_vqa_tpu_torch.cli import run_mimic
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.train.trainer import engine_route
    flags = dict(paths, ckpts_dir=str(work / "ckpts"),
                 log_path=str(work / "log"), version="mimic",
                 seed=str(SEED + 17), batch_size=str(BATCH), max_epoch="1",
                 verbose="false")
    argv = [x for k, v in flags.items() for x in (f"--{k}", v)]
    runs = []
    restore = mimic_probe(torch, dev, runs)
    try:
        out = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_mimic.main(["--run", "train", "--warm_start",
                                 str(vqa_ckpt), "--train_eval_every", "1",
                                 *argv])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        restore()
    printed = out.getvalue().splitlines()
    for ln in printed:
        say(f"  run_mimic: {ln}")
    if rc != 0 or len(runs) != 1:
        fail(f"[mimic] run_mimic --run train exited {rc} ({len(runs)} "
             f"Trainers)")
    run = runs[0]
    trainer = run["trainer"]
    cfg = trainer.cfg
    if not (trainer.fused and trainer.in_kernel_dropout and
            trainer.fused_eval) or cfg.img_feat_size != 1024:
        fail(f"[mimic] the Trainer chose fused={trainer.fused}, "
             f"in_kernel_dropout={trainer.in_kernel_dropout}, fused eval "
             f"{trainer.fused_eval}, img_feat_size {cfg.img_feat_size}")
    log = (Path(cfg.log_path) / "log_run_mimic.txt").read_text()
    mimic_warm_gate(torch, run, log)
    step = expected_step_launches(cfg, engine_route(cfg.hidden_size), True)
    mimic_steps("mimic regions", run, step)
    n_steps = len(run["steps"])
    sizes = {k: len(ds) for k, ds in trainer.eval_datasets.items()}
    n_eval = sum(-(-n // cfg.eval_batch_size) for n in sizes.values()) + \
        sum(-(-sizes[k] // cfg.eval_batch_size) for k in ("val", "test"))
    serve = serve_launches(cfg.layer, 1)
    want = {k: n_steps * step.get(k, 0) + n_eval * serve.get(k, 0)
            for k in set(step) | set(serve)}
    say(f"[mimic] run_mimic --run train (MCAN-small, hidden "
        f"{cfg.hidden_size}, {cfg.layer} + {cfg.layer} layers, "
        f"img_feat_size {cfg.img_feat_size}, {MIMIC_ROWS['regions']} region "
        f"rows, {trainer.train_dataset.ans_size} labels, vocabulary "
        f"{trainer.train_dataset.token_size}): {n_steps} steps and "
        f"{n_eval} eval batches (train {sizes['train']}, val {sizes['val']}, "
        f"test {sizes['test']} questions; val and test again at the end) in "
        f"{secs:.1f} s")
    check_launches("mimic: run_mimic --run train", counts,
                   {k: n for k, n in want.items() if n}, 1)
    rows.launches("mimic: run_mimic --run train", counts,
                  [k for k in TRAIN_KERNELS if step.get(k)]
                  + [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    ms = [r["ms"] for r in run["steps"][1:]]
    say(f"[mimic] step time (steps 2..{n_steps}, CUDA events): mean "
        f"{sum(ms) / len(ms):.3f} ms, min {min(ms):.3f} ms ({card})")
    evals = [ln for ln in log.splitlines() if ln.startswith((
        "train engine", "eval engine", "epoch 0 eval"))]
    for ln in evals:
        say(f"  the Trainer logged: {ln}")
    if [ln.split(":")[0] for ln in evals if ln.startswith("epoch 0 eval")] \
            != ["epoch 0 eval train", "epoch 0 eval val",
                "epoch 0 eval test"]:
        fail("[mimic] the epoch's evaluations of train, val and test")
    val_line = [ln for ln in printed if ln.startswith("val: ")]
    if len(val_line) != 1 or not [ln for ln in printed
                                  if ln.startswith("test: {'roc_micro'")]:
        fail(f"[mimic] run_mimic printed {printed}")

    out = io.StringIO()
    K.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = run_mimic.main(["--run", "val", "--ckpt_epoch", "1", *argv])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    n_val = -(-sizes["val"] // cfg.eval_batch_size)
    check_launches("mimic: run_mimic --run val", counts, serve, n_val)
    rows.launches("mimic: run_mimic --run val", counts,
                  [k for k in INT8_SERVE_KERNELS if serve.get(k)])
    got = out.getvalue().strip()
    say(f"[mimic] run_mimic --run val --ckpt_epoch 1: {got!r} equals the "
        f"train run's line: {got == val_line[0]}")
    if rc != 0 or got != val_line[0]:
        fail("[mimic] --run val differs from the train run's val line")
    return trainer, run


def mimic_sources(torch, dev, rows, short_paths, work) -> None:
    """``Trainer`` on "both" (86 rows) and "anatomy" (26 rows) for one
    epoch of two B=64 steps, each step's loss against the plain blocks'
    and its exact launches, then ``Trainer.evaluate`` on val."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.mimic import MIMICDataset
    from mcan_vqa_tpu_torch.train import trainer as tmod
    from mcan_vqa_tpu_torch.train.trainer import engine_route
    for source in ("both", "anatomy"):
        cfg = Config.for_model(
            "small", img_feat_size=1024, img_feat_pad_size=MIMIC_ROWS[source],
            mimic_feat_source=source, max_epoch=1, batch_size=BATCH,
            seed=SEED + 19, eval_every_epoch=False, version=source,
            ckpts_dir=str(work / "ckpts"), log_path=str(work / "log"),
            verbose=False, **short_paths)
        train = MIMICDataset(cfg, "train")
        val = MIMICDataset(cfg, "val", vocab=(train.token_to_ix,
                                               train.pretrained_emb))
        if train.example(0)["img"].shape != (MIMIC_ROWS[source], 1024):
            fail(f"[mimic {source}] example shape "
                 f"{train.example(0)['img'].shape}")
        runs = []
        restore = mimic_probe(torch, dev, runs)
        try:
            trainer = tmod.Trainer(cfg, train, eval_datasets={"val": val},
                                   device=dev)
            t0 = time.perf_counter()
            trainer.train()
            secs = time.perf_counter() - t0
        finally:
            restore()
        say(f"[mimic {source}] Trainer on {MIMIC_ROWS[source]} image rows "
            f"a sample ({len(train)} train questions, 1 epoch, "
            f"{secs:.1f} s with the end-of-train calibration):")
        step = expected_step_launches(cfg, engine_route(cfg.hidden_size),
                                      True)
        mimic_steps(f"mimic {source}", runs[0], step)
        rows.launches(f"mimic {source}: train steps", {
            k: sum(r["counts"][k] for r in runs[0]["steps"])
            for k in TRAIN_KERNELS}, [k for k in TRAIN_KERNELS
                                      if step.get(k)])
        mimic_eval_gates(torch, rows, trainer, f"mimic {source}")
        del trainer


def mimic_classify(torch, dev, rows, short_paths, work) -> None:
    """``run_classify --run train`` on the same files (regions): one epoch
    of two steps through the SA train kernels, each against the plain
    blocks, then its evaluation of val (exact launches)."""
    import contextlib
    import io
    from mcan_vqa_tpu_torch.cli import run_classify
    from mcan_vqa_tpu_torch.ops import kernels as K
    flags = dict(short_paths, ckpts_dir=str(work / "ckpts"),
                 log_path=str(work / "log"), version="classify",
                 seed=str(SEED + 23), batch_size=str(BATCH), max_epoch="1",
                 eval_interval="0", verbose="false")
    argv = [x for k, v in flags.items() for x in (f"--{k}", v)]
    runs = []
    restore = mimic_probe(torch, dev, runs)
    out = io.StringIO()
    K.reset_launches()
    try:
        with contextlib.redirect_stdout(out):
            rc = run_classify.main(["--run", "train", *argv])
        torch.cuda.synchronize()
    finally:
        restore()
    counts = K.launch_counts()
    printed = out.getvalue().strip().splitlines()
    if rc != 0 or len(runs) != 1 or not printed[-1].startswith(
            "val: {'roc_micro'"):
        fail(f"[mimic classify] run_classify exited {rc}: {printed}")
    run = runs[0]
    cfg = run["trainer"].cfg
    L = cfg.layer
    want = {k: 0 for k in TRAIN_KERNELS}
    for k, c in SA_PER_BLOCK.items():
        want[k + "_prng" if k in BLOCK_COUNTERS else k] += c * L
    say(f"[mimic classify] run_classify --run train on the MIMIC files "
        f"({MIMIC_SHORT} train questions, {MIMIC_LABELS} labels): "
        f"{printed[-1]}")
    mimic_steps("mimic classify", run, want)
    n_val = -(-MIMIC_QUESTIONS["val"] // cfg.eval_batch_size)
    serve = classifier_launches(L, None)
    total = {k: len(run["steps"]) * want.get(k, 0)
             + 2 * n_val * serve.get(k, 0) for k in set(want) | set(serve)}
    check_launches("mimic classify: run_classify --run train", counts,
                   {k: n for k, n in total.items() if n}, 1)
    rows.launches("mimic classify: run_classify --run train", counts,
                  [k for k in TRAIN_KERNELS if want.get(k)]
                  + [k for k in serve if k in rows.rows])


def mimic_path(torch, dev, rows, work: Path, vqa_ckpt: Path,
               card: str) -> None:
    """The phase's sub-steps in order, each timed."""
    from mcan_vqa_tpu_torch.data.mimic_files import write_mimic_files
    if "h5py" in sys.modules:
        fail("[mimic] h5py was imported before the phase")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_mimic_files(str(work / "files"), images=MIMIC_IMAGES,
                              questions=MIMIC_QUESTIONS, labels=MIMIC_LABELS,
                              seed=SEED)
    short = dict(paths, cxr_data_path=mimic_short_prefix(paths))
    say(f"[mimic] MIMIC-CXR-format files: {MIMIC_IMAGES} images, region "
        f"bank [{MIMIC_IMAGES}, 60, 1024] and anatomy bank [{MIMIC_IMAGES}, "
        f"26, 1024] as .npy, {MIMIC_LABELS} labels, "
        + " / ".join(f"{n} {k}" for k, n in MIMIC_QUESTIONS.items())
        + f" questions, written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainer, run = mimic_run_train(torch, dev, rows, paths, work / "regions",
                                   vqa_ckpt, card)
    mimic_eval_gates(torch, rows, trainer, "mimic regions")
    mimic_side_file(torch, dev, trainer, run)
    mimic_fixed_batch(torch, trainer)
    del trainer, run
    say(f"[mimic] run_mimic: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mimic_sources(torch, dev, rows, short, work / "sources")
    say(f"[mimic] both and anatomy: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mimic_classify(torch, dev, rows, short, work / "classify")
    say(f"[mimic] run_classify: {time.perf_counter() - t0:.1f} s")
    if "h5py" in sys.modules:
        fail("[mimic] the phase imported h5py")


# ---------------------------------------------------------------------------
# phase [distributed]: data and tensor parallelism on torch.distributed
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_TIMEOUT = 600
DIST_VOCAB = 200
DIST_ANSWERS = 3129
# the step of a data rank is a one-process step on its rows, and the sum of
# two is exact: the dp2 gradient is the sum of those steps bit for bit
DP_EXACT = 1e-6
# against one B=64 step the gradients differ where the kernels and cuBLAS
# sum in another order at another row count: in the one process alone,
# the B=64 step and its two halves' steps summed differ at the AttFlat
# ReLU's weights by 0.11 of the leaf (relu gates flip; relative L2 6.9e-4
# over all leaves with f32 plain-site operands, 1.7e-3 with bf16), so the
# leaf form of JAX's gate cannot hold here: the relative L2 is held
DP_GATE = 1e-2
# JAX's gate (tests/test_parallel.py:96-105), held to the relative L2 of
# all leaves for the same reason; each leaf's gap is printed beside the tp
# = 1 step's own against its halves summed
TP_GATE = 2e-4
# with bf16 operands at the plain sites every gradient leaf there is a bf16
# rounding of a partial sum: another split of the sum moves it by up to one
# bf16 step, 2^-8 of the leaf, and a second rounding on the way may add
# another (printed beside the f32-operand gate, held to 2^-7)
BF16_SPLIT_GATE = 2.0 ** -7
# AdamW's first update is lr x sign(g) where |g| >> eps: a sign flipped by
# rounding moves a weight 2 lr apart, plus the f32 rounding of the weight
WEIGHT_FLIP = 1.005


def dist_batch(torch, dev, rows=None):
    """The global B=64 batch from a seed: 10-60 image rows of 2048
    features, 4-14 question tokens, sparse targets over 3129 answers;
    rows: a slice of it (a data rank's)."""
    rng = np.random.default_rng(SEED + 24)
    img = np.abs(rng.normal(size=(BATCH, 60, 2048))).astype(np.float32)
    for i, n in enumerate(rng.integers(10, 61, BATCH)):
        img[i, n:] = 0.0
    ques = rng.integers(1, DIST_VOCAB, size=(BATCH, 14)).astype(np.int64)
    for i, n in enumerate(rng.integers(4, 15, BATCH)):
        ques[i, n:] = 0
    target = (rng.random((BATCH, DIST_ANSWERS)) < 2e-3).astype(np.float32)
    batch = {"img": img, "ques": ques, "target": target}
    rows = slice(None) if rows is None else rows
    return {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}


def dist_model(torch, cfg):
    from mcan_vqa_tpu_torch.models.net import MCANet
    return MCANet(cfg, DIST_VOCAB, DIST_ANSWERS,
                  generator=torch.Generator().manual_seed(cfg.seed))


# leaves whose gradient is 0 in exact arithmetic (a softmax does not move
# when a constant is added to its logits: the AttFlat glimpse bias and the
# key biases), so what they hold is reduction noise: JAX's floor of 1e-2
# (test_parallel.py:99-104) covers it at the O(1) gradients of its test,
# not under a BCE summed over 64 x 3129 terms (gradients up to ~500)
ZERO_GRAD_LEAF = re.compile(r"(attflat_\w+\.mlp\.linear|linear_k)\.bias$")


def grad_gap(a, b):
    """Two gradient sets keyed by parameter name -> (the largest leaf gap,
    the three largest as "leaf gap (leaf max)", the relative L2 gap of
    all leaves together, the largest |a - b| of the ``ZERO_GRAD_LEAF``
    leaves over the largest |a| of all): a leaf's gap is its max |a - b|
    over max |a| floored at 1e-2 (test_parallel.py:96-105), the zero
    leaves left out of it."""
    gaps, num, den, noise, top_all = [], 0.0, 0.0, 0.0, 0.0
    for k, x in a.items():
        top = float(x.abs().max())
        d = (x.float() - b[k].float())
        top_all = max(top_all, top)
        if ZERO_GRAD_LEAF.search(k):
            noise = max(noise, float(d.abs().max()))
        else:
            gaps.append((float(d.abs().max()) / max(top, 1e-2), k, top))
        num += float(d.square().sum())
        den += float(x.float().square().sum())
    gaps.sort(reverse=True)
    return (gaps[0][0], [f"{k} {g:.2e} ({t:.2e})" for g, k, t in gaps[:3]],
            (num / max(den, 1e-30)) ** 0.5, noise / max(top_all, 1e-30))


def dist_gate(label, value, limit):
    ok = value <= limit
    say(f"[distributed] {label}: {value:.3e} <= {limit:.4g} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"[distributed] {label}: {value} over {limit}")


def gap_gate(label, gap, limit, on_leaf=True) -> None:
    """A ``grad_gap`` held to ``limit``: its largest leaf gap (and the
    zero leaves' noise against the largest gradient), or, with bf16
    operands, whose leaves are roundings of partial sums, the relative L2
    gap of all leaves; the other figures printed beside it."""
    say(f"[distributed] {label}: largest leaf gaps (leaf max) {gap[1]}, "
        f"relative L2 {gap[2]:.3e}, zero leaves' noise {gap[3]:.3e} of "
        f"the largest gradient")
    if on_leaf:
        dist_gate(f"{label}, largest leaf", gap[0], limit)
        dist_gate(f"{label}, zero leaves' noise", gap[3], limit)
    else:
        dist_gate(f"{label}, relative L2", gap[2], limit)


def dist_step(torch, dev, cfg, model, data, *, rate, group=None,
              model_group=None, operand=None, steps=1, adamw=False,
              fused=True):
    """``steps`` train steps of ``model`` on ``data`` (the port's
    ``make_train_step`` with the mesh's groups; the fused blocks with
    their dropout in the kernels, or the plain engine) -> (state, losses,
    ms per step). adamw False: SGD at lr 0, so ``p.grad`` holds the
    step's (summed) gradient and the weights stay."""
    from mcan_vqa_tpu_torch.models.layers import operand_dtype
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.optim import make_optimizer
    from mcan_vqa_tpu_torch.train.step import make_train_step
    from mcan_vqa_tpu_torch.train.train_state import TrainState
    fwd = make_fused_train_forward(
        cfg.layer, cfg.multi_head, dropout_rate=rate,
        sga_block="fused" if fused else "plain", fused_encoder=fused,
        in_kernel_dropout=fused, model_group=model_group)
    opt = make_optimizer(model.parameters(), cfg) if adamw else \
        torch.optim.SGD(model.parameters(), lr=0.0)
    state = TrainState.create(model, opt, seed=cfg.seed)
    step = make_train_step(fwd, grad_accu_steps=cfg.grad_accu_steps,
                           data_group=group, model_group=model_group)
    losses, ms = [], []
    with operand_dtype(operand or torch.bfloat16):
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(step(state, data)["loss"]))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    return state, losses, ms


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def weights_digest(torch, model) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dist_world1(torch, dev, work: Path) -> None:
    """(a) NCCL, world 1, in this process: the MCAN-small B=64 fused step
    through ``make_train_step(data_group=WORLD)`` (the flat all-reduce on
    NCCL over one rank) against the step with no group, 2 AdamW steps at
    dropout 0.1 in the kernels: equal losses and weights bit for bit."""
    import torch.distributed as dist

    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.parallel.mesh import init_distributed
    work.mkdir(parents=True, exist_ok=True)
    init_distributed(device="cuda:0", backend="nccl",
                     init_method=f"file://{work / 'store_world1'}", rank=0,
                     world_size=1)
    try:
        cfg = Config(seed=SEED + 24)
        data = dist_batch(torch, dev)
        runs = [dist_step(torch, dev, cfg, dist_model(torch, cfg).to(dev),
                          data, rate=0.1, group=g, steps=2, adamw=True)
                for g in (None, dist.group.WORLD)]
        (s0, l0, ms0), (s1, l1, ms1) = runs
        same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(
            s0.model.parameters(), s1.model.parameters()))
        say(f"[distributed] (a) NCCL world 1: losses {l0} / {l1}, every "
            f"weight after 2 steps equal bit for bit: {same}; ms per step "
            f"{[round(x, 1) for x in ms0]} / {[round(x, 1) for x in ms1]}")
        if not same:
            fail("[distributed] (a) the world-1 NCCL step is not the "
                 "undistributed step bit for bit")
    finally:
        dist.destroy_process_group()


def dist_dp(torch, dev, rank, mesh) -> dict:
    """(b) on each rank: MCAN-small, mesh {data 2, model 1}, the fused
    engine, 32 rows a rank of the global B=64 batch."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_train
    from mcan_vqa_tpu_torch.ops.dropout import draw_seeds
    from mcan_vqa_tpu_torch.parallel.sharding import all_reduce_flat_
    from mcan_vqa_tpu_torch.train.train_state import step_seed
    cfg = Config(seed=SEED + 24)
    per = BATCH // DIST_WORLD
    local = dist_batch(torch, dev, slice(rank * per, (rank + 1) * per))
    full = dist_batch(torch, dev) if rank == 0 else None
    base = dist_model(torch, cfg)
    out = {"ms": {}}
    # dropout 0: the step per data rank against one B=64 step
    for label, operand in (("f32", torch.float32), ("bf16", None)):
        st, loss, ms = dist_step(torch, dev, cfg,
                                 copy_model(base).to(dev), local, rate=0.0,
                                 group=mesh.data_group, operand=operand)
        out["ms"][f"dp2 {label}"] = ms[0]
        if label == "f32":
            grads = [p.grad for p in st.model.parameters()]
            t = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_flat_(grads, mesh.data_group)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            out["allreduce_ms"] = sorted(t)[1]
            out["grad_mb"] = sum(g.numel() for g in grads) * 4 / 2 ** 20
            for g in grads:          # the sum again: back to one step's
                g.div_(DIST_WORLD ** 3)
        if rank == 0:
            one, loss1, ms1 = dist_step(torch, dev, cfg,
                                        copy_model(base).to(dev), full,
                                        rate=0.0, operand=operand)
            out["ms"][f"one {label}"] = ms1[0]
            out[f"loss_rel {label}"] = abs(loss[0] - loss1[0]) / loss1[0]
            out[f"gap {label}"] = grad_gap(grads_of(one.model),
                                           grads_of(st.model))
            del one
            # what each rank computed: one-process steps on its rows
            halves = None
            for r in range(DIST_WORLD):
                h, _, _ = dist_step(torch, dev, cfg, copy_model(base).to(dev),
                                    dist_batch(torch, dev, slice(
                                        r * per, (r + 1) * per)),
                                    rate=0.0, operand=operand)
                g = grads_of(h.model)
                halves = g if halves is None else \
                    {k: halves[k] + g[k] for k in g}
                del h
            out[f"gap halves {label}"] = grad_gap(halves, grads_of(st.model))
        del st
    # dropout 0.1 in the kernels: 3 AdamW steps, twice
    digests = []
    for rep in range(2):
        K.reset_launches()
        st, losses, ms = dist_step(torch, dev, cfg, copy_model(base).to(dev),
                                   local, rate=0.1, group=mesh.data_group,
                                   steps=3, adamw=True)
        if rep == 0:
            out["counts"] = K.launch_counts()
            out["losses"] = losses
            out["ms"]["dp2 dropout"] = ms
        digests.append(weights_digest(torch, st.model))
        del st
    out["digests"] = digests
    # the first decoder block's seed of step 0 on this rank, and its masks
    g = torch.Generator(device=dev).manual_seed(
        step_seed(cfg.seed, 0, rank))
    draw_seeds(g, cfg.layer)                         # the encoder's
    seed = draw_seeds(g, cfg.layer)[0]
    masks, _ = sga_train.dump_prng_masks(seed, 0.1, per, 60, 14,
                                         cfg.hidden_size, cfg.ff_size,
                                         cfg.multi_head, dev)
    import hashlib
    h = hashlib.sha256()
    for m in masks.values():
        h.update(m.cpu().numpy().tobytes())
    out["mask_digest"] = h.hexdigest()[:16]
    out["seed"] = seed
    return out


def copy_model(model):
    import copy
    return copy.deepcopy(model)


def dist_tp(torch, dev, rank, mesh, work: Path) -> dict:
    """(c) on each rank: MCAN-large (hidden 1024), mesh {data 1, model 2},
    the plain engine, B=64 in two micro-batches, against the tp = 1 plain
    step on rank 0."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.parallel.sharding import (gather_shards,
                                                      shard_dim,
                                                      shard_module_)
    from mcan_vqa_tpu_torch.train.checkpoint import save_checkpoint
    cfg = Config.for_model("large", seed=SEED + 25)
    data = dist_batch(torch, dev)
    base = dist_model(torch, cfg)
    out = {"ms": {}}

    def sharded():
        return shard_module_(copy_model(base), mesh.tp, mesh.model_index,
                             mesh.model_group).to(dev)

    def full_grads(model):
        grads = grads_of(model)
        grads.update(gather_shards(
            {k: (g, shard_dim(k)) for k, g in grads.items()
             if shard_dim(k) is not None}, mesh.model_group, mesh.tp))
        return {k: g.to(dev) for k, g in grads.items()}

    if rank == 0:
        # the tp = 1 step against itself summed in another order: the
        # sum of its two halves' steps, the noise floor of a leaf's gap
        one, _, _ = dist_step(torch, dev, cfg, copy_model(base).to(dev),
                              data, rate=0.0, operand=torch.float32,
                              fused=False)
        halves = None
        for r in range(2):
            h, _, _ = dist_step(torch, dev, cfg, copy_model(base).to(dev),
                                dist_batch(torch, dev, slice(32 * r,
                                                             32 * r + 32)),
                                rate=0.0, operand=torch.float32, fused=False)
            g = grads_of(h.model)
            halves = g if halves is None else {k: halves[k] + g[k] for k in g}
            del h
        out["gap tp1 halves"] = grad_gap(grads_of(one.model), halves)
        del one, halves
    for label, rate, operand in (("f32, dropout 0", 0.0, torch.float32),
                                 ("f32, dropout 0.1", 0.1, torch.float32),
                                 ("bf16, dropout 0", 0.0, None)):
        st, loss, ms = dist_step(torch, dev, cfg, sharded(), data, rate=rate,
                                 model_group=mesh.model_group,
                                 operand=operand, fused=False)
        grads = full_grads(st.model)
        out["ms"][f"tp2 {label}"] = ms[0]
        del st
        if rank == 0:
            one, loss1, ms1 = dist_step(torch, dev, cfg,
                                        copy_model(base).to(dev), data,
                                        rate=rate, operand=operand,
                                        fused=False)
            out["ms"][f"one {label}"] = ms1[0]
            out[f"loss_rel {label}"] = abs(loss[0] - loss1[0]) / loss1[0]
            out[f"gap {label}"] = grad_gap(grads_of(one.model), grads)
            del one
        del grads
    # one AdamW step each, the tp = 2 pickle gathered on rank 0
    st, _, _ = dist_step(torch, dev, cfg, sharded(), data, rate=0.0,
                         model_group=mesh.model_group,
                         operand=torch.float32, adamw=True, fused=False)
    save_checkpoint(st, str(work / "ckpts"), "tp2", 1, cfg.lr_base,
                    mesh=mesh)
    del st
    if rank == 0:
        one, _, _ = dist_step(torch, dev, cfg, copy_model(base).to(dev),
                              data, rate=0.0, operand=torch.float32,
                              adamw=True, fused=False)
        save_checkpoint(one, str(work / "ckpts"), "tp1", 1, cfg.lr_base)
        del one
        out["lr"] = cfg.lr_base
    return out


def dist_rank(rank: int, work: Path) -> None:
    """A spawned rank of (b) and (c): gloo on cuda:0 beside the other
    rank; its numbers to work/rank<r>.json."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from mcan_vqa_tpu_torch.ops import _build
    _build.load_library()                  # the parent's build, loaded
    from mcan_vqa_tpu_torch.parallel.mesh import init_distributed, make_mesh
    dev = init_distributed(device="cuda:0", backend="gloo",
                           init_method=f"file://{work / 'store'}", rank=rank,
                           world_size=DIST_WORLD)
    t0 = time.perf_counter()
    dp = dist_dp(torch, dev, rank, make_mesh({"data": 2, "model": 1}))
    t1 = time.perf_counter()
    tp = dist_tp(torch, dev, rank, make_mesh({"data": 1, "model": 2}),
                 work)
    t2 = time.perf_counter()
    torch.distributed.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(
        {"dp": dp, "tp": tp, "s": {"dp": t1 - t0, "tp": t2 - t1}}))


def dist_spawn(work: Path) -> list:
    """The two ranks, started together and waited for; every process
    stopped on the way out."""
    procs = []
    for r in range(DIST_WORLD):
        with open(work / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
                 str(r), "--dist-dir", str(work)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        rcs = [p.wait(timeout=max(1.0, DIST_TIMEOUT - (
            time.perf_counter() - t0))) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * DIST_WORLD:
        for r in range(DIST_WORLD):
            say((work / f"rank{r}.log").read_text()[-3000:])
        fail(f"[distributed] the ranks exited {rcs}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(DIST_WORLD)]


def dist_pickles(torch, work: Path, lr: float) -> None:
    """(c)'s pickles: the tp = 2 run's gathered one and the tp = 1 run's,
    the same keys, shapes and step; AdamW's moments within the gradient
    gate (exp_avg / 0.1 and sqrt(exp_avg_sq / 0.001) are the gradient and
    its magnitude at step 1), the weights within 2 lr (the first update
    is lr x sign(g) but where |g| is at rounding level, test_torch_train_
    step.py's rule)."""
    a = torch.load(work / "ckpts" / "ckpt_tp1" / "epoch1.pkl",
                   weights_only=True)
    b = torch.load(work / "ckpts" / "ckpt_tp2" / "epoch1.pkl",
                   weights_only=True)
    sa, sb = a["state_dict"], b["state_dict"]
    same = list(sa) == list(sb) and all(
        sa[k].shape == sb[k].shape for k in sa)
    if not same:
        fail("[distributed] the gathered pickle's keys or shapes differ "
             "from the one-process pickle's")
    dw = max(float((sa[k] - sb[k]).abs().max()) for k in sa)
    flips = sum(int(((sa[k] - sb[k]).abs() > lr).sum()) for k in sa)
    ma, mb = a["optimizer"]["state"], b["optimizer"]["state"]
    keys = list(sa)
    mu = grad_gap({keys[i]: s["exp_avg"] / 0.1 for i, s in ma.items()},
                  {keys[i]: s["exp_avg"] / 0.1 for i, s in mb.items()})
    nu = grad_gap(
        {keys[i]: (s["exp_avg_sq"] / 1e-3).sqrt() for i, s in ma.items()},
        {keys[i]: (s["exp_avg_sq"] / 1e-3).sqrt() for i, s in mb.items()})
    steps = {float(s["step"]) for m in (ma, mb) for s in m.values()}
    say(f"[distributed] (c) pickles: {len(sa)} tensors, keys and shapes "
        f"equal, AdamW step {sorted(steps)}")
    gap_gate("(c) pickle exp_avg / 0.1", mu, TP_GATE, on_leaf=False)
    gap_gate("(c) pickle sqrt(exp_avg_sq / 0.001)", nu, TP_GATE,
             on_leaf=False)
    say(f"[distributed] (c) pickle weights: {flips} of "
        f"{sum(v.numel() for v in sa.values())} moved apart by more than "
        f"lr (a flipped sign of a gradient at rounding level)")
    dist_gate("(c) pickle weights max |dw| / (2 lr)", dw / (2 * lr),
              WEIGHT_FLIP)
    if steps != {1.0}:
        fail(f"[distributed] AdamW steps {steps}, expected 1")


def dist_report(torch, rows, ranks, cfg_small) -> None:
    """Gates of (b) and (c), each value beside its limit."""
    from mcan_vqa_tpu_torch.train.trainer import engine_route
    r0, r1 = ranks
    dp, tp = r0["dp"], r0["tp"]
    say(f"[distributed] ranks' seconds: {r0['s']} / {r1['s']}")
    say(f"[distributed] (b) dp2 ms per step {dp['ms']}; rank 1 "
        f"{r1['dp']['ms']}")
    say(f"[distributed] (b) gloo all-reduce of the {dp['grad_mb']:.1f} MB "
        f"gradient buffer (cuda:0 tensors, two ranks on one card): "
        f"{dp['allreduce_ms']:.1f} / {r1['dp']['allreduce_ms']:.1f} ms")
    for label in ("f32", "bf16"):
        sites = f"{label} plain sites"
        dist_gate(f"(b) dp2 loss rel to one B=64 step, {sites}",
                  dp[f"loss_rel {label}"], 1e-5)
        gap_gate(f"(b) dp2 grads against the two ranks' rows stepped in "
                 f"one process and summed, {sites}",
                 dp[f"gap halves {label}"], DP_EXACT)
        gap_gate(f"(b) dp2 grads against one B=64 step, {sites}",
                 dp[f"gap {label}"], DP_GATE, on_leaf=False)
    say(f"[distributed] (b) dropout 0.1 in the kernels, 3 steps: losses "
        f"{dp['losses']} / {r1['dp']['losses']}; weights "
        f"{dp['digests']} / {r1['dp']['digests']}; first decoder seeds "
        f"{dp['seed']} / {r1['dp']['seed']}, masks {dp['mask_digest']} / "
        f"{r1['dp']['mask_digest']}")
    if not (dp["digests"][0] == r1["dp"]["digests"][0]
            == dp["digests"][1] == r1["dp"]["digests"][1]):
        fail("[distributed] (b) the ranks' weights differ, or a repeat "
             "gave other bits")
    if dp["mask_digest"] == r1["dp"]["mask_digest"]:
        fail("[distributed] (b) both data ranks drew the same masks")
    route = engine_route(cfg_small.hidden_size)
    want = {k: 3 * n for k, n in expected_step_launches(
        cfg_small, route, seeded=True).items() if n}
    for r, res in enumerate(ranks):
        got = {k: n for k, n in res["dp"]["counts"].items()
               if k in want or n}
        say(f"[launches] distributed dp2 rank {r}, 3 steps of 32 rows: "
            f"{got}")
        if got != want:
            fail(f"[distributed] rank {r}: launches {got}, expected {want}")
    rows.launches("distributed dp2", {
        k: sum(res["dp"]["counts"].get(k, 0) for res in ranks)
        for k in want}, list(want))
    say(f"[distributed] (c) tp2 ms per step {tp['ms']}; rank 1 "
        f"{r1['tp']['ms']}")
    say(f"[distributed] (c) the tp = 1 step against its two halves' steps "
        f"summed (another order of the same sums, f32 operands): largest "
        f"leaf gaps {tp['gap tp1 halves'][1]}, relative L2 "
        f"{tp['gap tp1 halves'][2]:.3e}")
    for label in ("f32, dropout 0", "f32, dropout 0.1"):
        dist_gate(f"(c) tp2 loss rel, {label}", tp[f"loss_rel {label}"],
                  1e-4)
        gap_gate(f"(c) tp2 grad gap, {label}", tp[f"gap {label}"], TP_GATE,
                 on_leaf=False)
    dist_gate("(c) tp2 loss rel, bf16, dropout 0",
              tp["loss_rel bf16, dropout 0"], 1e-4)
    gap_gate("(c) tp2 grad gap, bf16, dropout 0", tp["gap bf16, dropout 0"],
             BF16_SPLIT_GATE, on_leaf=False)


def split_probs(predictor, requests, parts: int):
    """Each request through ``predictor`` padded to its bucket, the bucket
    run as ``parts`` equal row slices one after the other (what a mesh of
    ``parts`` replicas runs) -> the probabilities of the real rows."""
    out = []
    for qs, fs in requests:
        img, ques = predictor.pad_batch(qs, fs)
        rows = img.shape[0] // parts
        out.append(np.concatenate([
            predictor.forward_padded(img[i * rows:(i + 1) * rows],
                                     ques[i * rows:(i + 1) * rows])
            .cpu().numpy() for i in range(parts)])[:len(qs)])
    return out


def dist_predictor(torch, dev, rows, state_dict, cfg, vocab,
                   ix_to_ans) -> None:
    """(d) ``Predictor(mesh=make_mesh({"data": 2}, devices=["cuda:0"] *
    2))`` at buckets 2, 8, 64 for the plain, level-1, level-3, int4
    level-5 and q8aux engines: each equal to the mesh-less Predictor of
    the same engine run on the bucket's two row slices (1e-6: the mesh
    runs just that), against it on the whole bucket within the engine's
    bound (every engine's plain sites, the LSTM, cross k / v, AttFlat and
    head, are cuBLAS products, which sum a 32-row and a 64-row product in
    other orders, and a bf16 operand rounding moves: 2.4e-3 measured for
    the plain and level-1 engines), against the plain engine (the
    engine's bound), and twice its launches (one slice a replica)."""
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(SEED + 26)
    requests = [ragged_batch(rng, cfg, n) for n in (2, 8, BATCH)]
    cal = ragged_batch(rng, cfg, BATCH)
    mesh = make_mesh({"data": 2}, devices=[f"{dev.type}:0"] * 2)
    kw = dict(latency_buckets=(2, 8), max_batch=BATCH, auto_calibrate=0)
    plain = Predictor(cfg, state_dict, vocab, ix_to_ans, engine="plain",
                      device=dev, **kw)
    for label, extra, bound, on in (
            ("plain", dict(engine="plain"), 1e-2, "sigmoid"),
            ("level 1", dict(engine="fused"), INT8_BOUND, "sigmoid"),
            ("level 3", dict(engine="fused", act_calibration=cal),
             INT8_BOUND, "sigmoid"),
            ("int4 level 5", dict(engine="int4", act_calibration=cal),
             INT4_BOUND, "softmax"),
            ("q8aux", dict(engine="fused", q8aux=True, act_calibration=cal),
             INT8_BOUND, "sigmoid")):
        t0 = time.perf_counter()
        alone = Predictor(cfg, state_dict, vocab, ix_to_ans, device=dev,
                          **kw, **extra)
        pm = Predictor(cfg, state_dict, vocab, ix_to_ans, mesh=mesh, **kw,
                       **extra)
        K.reset_launches()
        want = [alone.predict_probs(*r) for r in requests]
        torch.cuda.synchronize()
        c1 = K.launch_counts()
        K.reset_launches()
        got = [pm.predict_probs(*r) for r in requests]
        torch.cuda.synchronize()
        c2 = K.launch_counts()
        sliced = split_probs(alone, requests, 2)
        dist_gate(f"(d) mesh {label} vs mesh-less on the two slices, "
                  f"buckets 2 / 8 / 64",
                  max(float(np.abs(a - b).max())
                      for a, b in zip(got, sliced)), 1e-6)
        dist_gate(f"(d) mesh {label} vs mesh-less on the whole bucket",
                  max(float(np.abs(a - b).max()) for a, b in zip(got, want)),
                  bound)
        if c2 != {k: 2 * n for k, n in c1.items()}:
            fail(f"[distributed] (d) {label}: mesh launches {c2}, expected "
                 f"twice {c1}")
        rows.launches(f"distributed mesh {label}", c2,
                      [k for k in c2 if k in rows.rows])
        if label != "plain":
            agreement(f"[distributed] (d) mesh {label}", requests, got,
                      plain, len(ix_to_ans), bound=bound, on=on)
        say(f"[distributed] (d) {label}: launches {c2} (twice the "
            f"mesh-less {sum(c1.values())}), "
            f"{time.perf_counter() - t0:.1f} s")
        del alone, pm


def distributed_path(torch, dev, rows, work: Path, state_dict, cfg, vocab,
                     ix_to_ans, card: str) -> None:
    """The phase's sub-phases in order, each timed."""
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    dist_world1(torch, dev, work)
    say(f"[distributed] (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # three CUDA contexts share the card
    ranks = dist_spawn(work)
    dist_report(torch, rows, ranks, cfg)
    dist_pickles(torch, work, ranks[0]["tp"]["lr"])
    say(f"[distributed] (b) + (c), two ranks on one card over gloo: "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    t0 = time.perf_counter()
    dist_predictor(torch, dev, rows, state_dict, cfg, vocab, ix_to_ans)
    say(f"[distributed] (d): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase [canary]: the accuracy canary of every engine the Predictor ships
# ---------------------------------------------------------------------------

CANARY_TIMEOUT = 600


def canary_path() -> None:
    """``cli/validate_serving_accuracy.py`` at its defaults in a process
    of its own (MCAN-small trained 1200 steps on the card, then the fused,
    qstatic, int8, int4, q8aux and bf16 engines scored against the plain
    one); its exit code is the gate."""
    cmd = [sys.executable, "-m",
           "mcan_vqa_tpu_torch.cli.validate_serving_accuracy"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=CANARY_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"the canary ran past {CANARY_TIMEOUT} s")
    lines = proc.stdout.strip().splitlines()
    for ln in lines[:-1]:
        if not ln.startswith("step ") or ln.split()[1].split("/")[0] in (
                "50", "600", "1200"):
            say(f"[canary] {ln}")
    say(f"[canary] {' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if lines:
        say(f"[canary] {lines[-1]}")
    if proc.returncode != 0:
        say(proc.stderr[-4000:])
        fail(f"the accuracy canary exited {proc.returncode}")


if __name__ == "__main__":
    if "--artifact-load" in sys.argv:
        artifact_load(Path(sys.argv[sys.argv.index("--artifact-load") + 1]))
    elif "--dist-rank" in sys.argv:
        dist_rank(int(sys.argv[sys.argv.index("--dist-rank") + 1]),
                  Path(sys.argv[sys.argv.index("--dist-dir") + 1]))
    else:
        main()
