"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase; takes no arguments

Phases (any failure raises and exits non-zero; there is no CPU fallback).
The eDOS flagship:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the CUDA kernels from dostransformer_tpu_torch/csrc with nvcc
     (one nvcc per source, all at once), and print the registers a thread
     and the stack bytes of the attention kernels at the flagship width and
     of every message-passing kernel (cuobjdump -res-usage on the built
     library), and of the two LayerNorm-lever kernels, whose stack must be
     0, and of the sliced attention kernels (D > 512); the port's copy of
     the attention kernels' plan by width (attention_plan) is held equal to
     the library's;
  3. each forward kernel against its plain PyTorch version on the card at
     the shapes the flagship eDOS forward gives it (f32, TF32 off),
     including a short batch whose dummy graph has every key masked; max
     abs/rel error against the stated tolerance, and the median time of
     kernel and plain version over 50 runs (CUDA events); the attention
     forward with keys and values as one tensor (the layer's call), and also
     its row statistics (max and sum) against the plain scores', two copies
     of the keys against the one tensor bit for bit, and the time of the op
     with its mask-to-bias ops; the message-passing forward in the form its
     widths take (tensor-core at M = 512, H = 256) bit-identical on a second
     run, beside the generic (FMA) form on the same inputs, with the tile
     taken and the shared memory a block takes, and at a width that keeps
     the generic form (M = 600, H = 300);
  3b. each backward kernel against its plain backward at the training
     shapes (a dummy graph, random nonzero upstream gradients, a fully
     masked attention row), run twice and required to repeat bit for bit,
     timed as in 3; the attention backward as the default layer calls it
     (keys and values one tensor, the forward's row statistics), and also
     without the statistics and with two copies of the keys, bit-equal; the
     message-passing backward as its forward in 3 (both forms, the tile
     and cluster shape taken);
  4. the serving path through the entry points a user calls: a flagship
     DOSTransformerEDOS (hidden 256, 3 processors, 2 transformer layers per
     stack, 201 bins; random weights from a seeded torch.Generator) is saved
     with torch.save, synthetic eDOS samples are written as npz, and
     requests are served through cli.main_predict and Predictor.predict: 96
     samples, 5 samples (a short batch) and a mix of small and large
     crystals (two atom buckets). Every output must be [N, 201], finite and
     >= 0 (the eDOS clamp); the kernel launch counters must show exactly 3
     fused_mp_edge and 6 fused_attention launches per batch and no backward
     launch; and the outputs must match the same model run on the CPU
     through the plain versions;
  5. samples/s for the 96-sample request;
  6. the training path through its entry point: cli.main_edos on 96
     learnable synthetic samples, 3 epochs, eval every epoch, at the full
     width (main_edos defaults, batch 8, f32), on the device-resident
     dataset (the default: uploaded once, batches gathered on the card);
     6b the same for one epoch with --host_loader. Every train step must launch
     exactly 3 + 6 forward and 3 + 6 backward kernels, every eval batch 3 + 6
     forward and no backward; the losses must be finite, the test metrics
     present and the experiments_DOSTransformer.txt block written;
  7. card against CPU: one seeded model copied to both devices, 3
     Trainer.train_steps on the same 3 batches (the last one short, with
     dummy graphs); the first step's gradients and every step's loss must
     agree within the stated tolerances;
  8. training samples/s at batch 8 over 20 steps (host collation and upload
     included, synchronised at both ends), with the card's name and power
     limit.

The phDOS flagship (DOSTransformerPhDOS: hidden 256, 3 processors, 2
transformer layers per stack, 51 bins, r_max 4.0, f32, scatter-mean):

  3c. the segment-sum kernel against its plain version: the phDOS
     NodeModel's edge count (F = 1, exact) on a batch of 8 synthetic phDOS
     samples, F = 256 at B=8 A=32 E=384, real-crystal sizes (E=2048 N=64,
     F = 1 exact and F = 256), and ids out of range or negative with a
     dummy graph; each run twice and required to repeat bit for bit, timed
     as in 3 beside zeros + index_add_, with the partition it took;
  3d. kernels 1-4 against their plain versions at the phDOS shapes:
     message passing on synthetic phDOS batches of 8 (a dummy graph last)
     and of 1 (forms and shapes as in 3 and 3b), attention at 51 queries
     against 16 atom keys (B=8, and the 2B head batch), 51 energy tokens (2B)
     and 8 keys (B=1), forward and backward, with the tolerances of 3 and 3b;
  9. phDOS serving: a seeded flagship saved with torch.save serves 96
     samples through cli.main_predict --task phdos and 5 through
     Predictor.predict; outputs [N, 51] and finite (no clamp: negative
     values stay); exactly 3 fused_mp_edge, 3 batched_segment_sum and 6
     fused_attention launches per batch and no backward launch; card
     against CPU as in 4; samples/s for the 96-sample request;
  10. phDOS training through cli.main_phdos: 96 learnable synthetic samples,
     3 epochs at batch 8, then 24 samples for one epoch at the CLI's default
     batch 1. Every train step launches 3 + 3 + 6 forward and 3 + 6 backward
     kernels, every eval batch 3 + 3 + 6 and no backward; losses finite,
     test metrics present, the experiments block written;
  11. card against CPU: 3 phDOS Trainer.train_steps as in 7;
  12. phDOS training samples/s at batch 8 as in 8.

Every width (the JAX package runs any hidden width; so does the card):

  3g. kernels #3, #4 and #5 against their plain versions at D = 1, 33, 48,
     50, 200, 544 and 1,024 (keys and values one tensor and two; #4
     bit-identical on reruns and without the forward's statistics; #5 in
     f32 and, where D % 8 == 0, bf16), then timed at the h1024 shapes
     (D = 1,024) and the narrow phDOS path's (D = 50) beside their bounds,
     plain versions and library calls;
  3h. #1 and #2 at the h1024 widths (M = 2,048, H = 1,024) and #2 at hidden
     624 and 1,000, as in 3 and 3b (form, tile, generic form beside them);
  17. the h1024 eDOS flagship (hidden 1,024, 3 processors, 2 layers per
     stack, 201 bins, batch 8, f32; bench_configs.py's `h1024` row) served
     through cli.main_predict (96 samples) and Predictor.predict (5), exact
     launch counts, the 5-sample request against the CPU; samples/s;
  18. h1024 training through cli.main_edos --hidden 1024 (one epoch of 3
     steps at batch 8), exact launch counts per step and eval batch;
  19. one h1024 train step at batch 2 card against CPU (loss, gradients);
     one h1024 train step with both LayerNorm levers against one without
     (launch counts, losses); training samples/s (4 readings of 5 steps);
  20. the narrow phDOS path at hidden 50: 5 samples served against the
     CPU, 3 train steps card against CPU, exact launch counts;
  21. #1 and #2 at hidden 1,040, 1,050 and 2,080 (M = 2H), where no block
     of their first generic designs fit: the generic forms (the same
     shared memory at every width) against their plain versions, bit for
     bit on a rerun, timed beside their bounds.

bf16 serving (a model with dtype="bfloat16": f32 parameters, bf16
activations, f32 outputs):

  27. the bf16 forms of #1 (both forms: eDOS, phDOS at B = 8 and 1, hidden
     1,024 and 50), #3 (D = 256 at the eDOS and phDOS shapes, D = 50 and
     1,024; its f32 row statistics too) and #6 (the phDOS count, E = 2,048
     and N = 64 at F = 1 and 256) against their plain versions in bf16
     (2^-7 of the largest value, exact counts), bit-identical on a second
     run, each timed beside the f32 form on the same inputs, its bf16 bound
     (#3's operations at the bf16 tensor-core peak) and the library call
     (SDPA in bf16 for #3, zeros + index_add_ for #6);
  28. the eDOS flagship (with and without fuse_ln_attn) and the phDOS
     flagship served through Predictor.from_torch(..., dtype="bfloat16"):
     the 96-sample request at batch 8 with the launches counted from 0
     (exactly 3 #1, 6 #3 (or #5) and for phDOS 3 #6 a forward, no backward),
     the short and mixed requests within 0.03 (relative RMS) of the CPU's
     bf16 model and of its f32 model; samples/s bf16 against f32, four
     readings each taken in turns in one process;
  29. the h1024 eDOS flagship served in bf16: the same launch counts, five
     samples against the CPU's bf16 model (0.03) and f32 model (0.06),
     device time a forward at batch 8 (CUDA events) and samples/s, bf16
     against f32 in turns.

bf16 training (the same model trained: f32 parameters, gradients and
optimizer state, bf16 activations):

  30. the bf16 forms of the backward kernels against their plain versions
     in bf16: #2 (eDOS, phDOS at B = 8 and 1, hidden 1,024 in a cluster of
     four, hidden 50 in the generic form, and the generic form beside the
     tensor-core one at the eDOS shape; f32 gradients from bf16 operands,
     held to the f32 limits 1e-5 and 1e-4) and #4 (D = 256 at the eDOS and
     phDOS shapes, D = 1,024 sliced, D = 50; bf16 gradients within 2^-7 of
     the largest value; bit-equal without the forward's statistics and with
     two copies of the keys); each bit-identical on a second run and timed
     beside the f32 form on the same inputs, the bound (#2's f32 operations,
     W1 being f32; #4's 10 B Lq Lk D at the bf16 tensor-core peak) and, for
     #4, SDPA's bf16 backward;
  31. bf16 Trainer.train_steps on the card against the same weights and
     batches on the CPU in bf16 (and in f32, for the scale): the eDOS and
     phDOS flagships and eDOS with both levers (3 steps), h1024 at batch 2
     (1 step); every step's launches exact (the forward's bf16 forms and
     3 #2 + 6 #4 in the backward; with the levers 6 #5 and 20 #7); the
     first-step gradients (relative RMS for each parameter and for all
     together) and every step's loss within 3 times the CPU's own bf16-to-
     f32 distance measured here;
  32. cli.main_edos --dtype bfloat16 (2 epochs, 48 learnable samples) with
     checkpoints, a run stopped after epoch 1 and resumed (losses and best
     metrics exactly equal), with --bf16_data --remat, and cli.main_phdos --dtype
     bfloat16: exact launches per step and eval batch, epoch losses within
     0.03 of the same runs in f32; best/ served through
     Predictor.from_checkpoint(..., dtype="bfloat16") against the CPU;
  33. a record without a limit: train samples/s bf16 against f32 in turns
     (eDOS and phDOS at hidden 256, eDOS at 1,024) and the device time of an
     h1024 train step (CUDA events).

The training runtime (checkpoints, resume, best/, the device-resident
datasets, remat, clipping and schedules, artifacts, TensorBoard):

  22. cli.main_edos at the flagship width with --checkpoint_dir
     --checkpoint_every 1: a run stopped after epoch 1 and resumed from its
     checkpoint must give the uninterrupted 3-epoch run's epoch losses and
     best metrics exactly; then cli.main_predict --checkpoint_dir serves
     best/ on the card (exact launch counts) within atol 1e-3 + rtol 1e-3 of
     the same checkpoint served on the CPU;
  23. cli.main_phdos at the flagship width with --bucketed --bf16_data
     --remat --grad_clip 1 --warmup_epochs 1 --cosine_lr --tensorboard
     --export_preds: per train step the remat launch counts (the forward's
     message-passing, edge-count and attention launches once more in the
     backward), the TensorBoard tags and one artifact row per test sample;
  24. train samples/s of the device-resident dataset against --host_loader,
     eDOS and phDOS at batch 8, four readings each taken in turns in one
     process (a record, not a claim).

The baselines and the data layer:

  25. the eight baseline families (graphnetwork, graphnetwork2, mlp, mlp2 of
     eDOS and phDOS) at hidden 256, 3 processors where the family has them,
     batch 8, f32: the forward card against CPU (atol 1e-3 + rtol 1e-3), 3
     train steps card against CPU (first-step gradients atol 1e-3 + rtol
     1e-3, losses rtol 1e-3), the launches of every step exact (eDOS
     graphnetwork* 3 fused_mp_edge + 3 fused_mp_edge_bwd; phDOS
     graphnetwork* also 3 batched_segment_sum; mlp* none; no attention),
     training samples/s of each as a record; then cli.main_edos and
     cli.main_phdos --embedder graphnetwork (2 epochs, exact launches per
     step and eval batch) and cli.main_predict --embedder mlp2 (96 eDOS
     samples, no launch, against the CPU);
  26. 256 Materials-Project-shaped records (CIF strings, 4-24 atoms, some
     with symmetry operations) from a seed, featurised by
     ``python -m dostransformer_tpu_torch.data.featurize_edos`` serially,
     with --workers 4 and with DOSTPU_NO_NATIVE=1 (equal arrays, every
     record converted); cli.main_edos --dataset whole --data_dir trains the
     eDOS flagship 2 epochs on the card from them (exact launches); the
     same crystals as a phononDoS data.csv through featurize_phdos serially
     and with --workers 4 (equal arrays); the featurisers' rates, host
     numbers, beside the host's CPU count.

The LayerNorm levers of the transformer layer (off by default; the paths
above must launch neither of their kernels):

  3e. the LN-fused attention forward kernel against its plain version
     (the shared LayerNorm three times, then the plain attention) at the
     six attention shapes of the two flagships as the model calls it (keys
     and values one tensor, pad atoms masked, the last graph fully masked),
     a self-attention on ONE tensor and a call with three distinct
     tensors, and the three eDOS shapes again on inputs with a mean of 50
     (25 standard deviations); tolerance as 3; keys and values as one
     tensor or two copies bit for bit; every case again with bf16 operands
     (within 2%), timed; beside it the unfused layer's composition on the
     card (F.layer_norm per distinct tensor, then the attention kernel),
     which the kernel must beat at each of the six path shapes, and, as the
     library yardstick, F.layer_norm + F.scaled_dot_product_attention;
  3f. the LayerNorm backward kernel against its plain version at
     rows x 256 for the row counts of a train step (8*201, 16*201, 8*32,
     16*51, 8*16), f32 (dx within 1e-5, dscale and dbias within 1e-4) and
     bf16 operands (within 3% of the largest value: the kernel keeps
     g = dy * scale in f32 where the plain version rounds it), in both
     operand forms (xhat; the raw x with mean and rstd), each run twice and
     required to repeat bit for bit, one launch a call; beside it
     aten.native_layer_norm_backward on the same rows, which it must beat;
     then untimed at widths 48, 600, 1,024 and 50 (the scalar form); the
     wrapper's copy of the partition is held equal to the library's;
  13. serving with fuse_ln_attn: the 96-sample requests through
     cli.main_predict with DOSTPU_FUSE_LN_ATTN=1 in the environment and 5
     samples through Predictor(fuse_ln_attn=True), eDOS and phDOS: per
     batch exactly 3 fused_mp_edge, 6 fused_attention_ln, no fused_attention
     and no backward launch (phDOS: plus 3 batched_segment_sum); outputs
     against the same model on the CPU and against the unfused card
     outputs of 4 and 9; samples/s fused and unfused, six readings each
     taken in turns;
  14. training with both switches through cli.main_edos and cli.main_phdos
     (DOSTPU_FUSE_LN_ATTN=1, DOSTPU_LN_PALLAS=1; 3 epochs at batch 8): per
     train step 3 fused_mp_edge, 6 fused_attention_ln, 3 fused_mp_edge_bwd,
     6 fused_attention_bwd and 20 layer_norm_bwd launches (per layer one
     for each distinct tensor among ln0's inputs and one for ln1, per stack
     one for the final LayerNorm; the self stack's first layer has one
     input tensor), no fused_attention; per eval batch the forward's and
     no backward; epoch losses within LOSS_RTOL of the unfused runs of 6
     and 10 (same seed); then 3 Trainer.train_steps card against CPU;
  15. training samples/s at batch 8 over 20 steps with the levers off,
     ln_lp only and both on, four readings each taken in turns in one
     process, eDOS and phDOS;
  16. where the device time goes (last, because a process that has run
     torch.profiler pays more for every later launch): train steps (the
     batch uploaded per step, and already on the card) and serving forwards
     of both flagships at
     batch 8, with the LayerNorm levers off and with both on, and of the
     h1024 eDOS flagship with the levers off, in f32 and in bf16: wall time
     without the profiler, then under torch.profiler the
     device time and device activities per step, the busy share, and the
     kernels by device time, and what the levers add to or take from each;
     then the device time of each sub-kernel of the
     message-passing calls of 3, 3b and 3d.

The rest of serving (the phases above serve their Predictor requests through
the eager forward, ``graphs=False``, so their launch counts stay exact per
batch; their main_predict runs are graph-served and count two forwards a
geometry, the warm-up and the capture):

  34. Predictor through one CUDA graph per batch geometry (pinned, streamed
     uploads; one copy to the host a request) against the eager forward on
     the same weights: the eDOS flagship in f32, in bf16 and with
     fuse_ln_attn, and the phDOS flagship, each on the 96-sample, 5-sample
     and mixed-bucket requests, bit-equal expected (else within 1e-5 of the
     largest value, with the difference printed); graphs captured equal to
     the distinct geometries, none more for a second request; the graph
     path's launches, counted alone, exactly two forwards a graph (warm-up
     and capture); the 96-sample request through main_predict
     (graph-served by default) against eager, its launches exactly two
     forwards a geometry; samples/s of the 96-sample request graph against
     eager (eDOS, phDOS; five readings each in turns), and the median and p90
     latency of 20 five-sample requests; a record of what the ops'
     torch.library dispatch costs the eager train step (host microseconds a
     call through the op against the wrapper straight, and train samples/s
     both ways in turns). After 16 (the profiler slows what follows): the
     kernels of the five-sample requests' replays by name from
     torch.profiler (the wrappers' counters run at a graph's warm-up and
     capture, not at its replays): exactly 3 #1 and 6 #3 (#5 with
     fuse_ln_attn), phDOS also 3 #6, a replay, and no backward kernel; the
     device's busy share of the 96-sample request, graph against eager
     (device time over the wall time of the same profiled call);
  35. main_predict --export from a checkpoint (eDOS and phDOS): the
     program's dostpu ops (3 fused_mp_edge_fwd, 6 attention_fwd, phDOS also
     3 segment_sum) and the artifact's size; main_predict --from_exported in
     a fresh process, which must import no module of models/ or train/ (nor
     jax) and write the live Predictor's predictions at the artifact's
     geometry; the artifact served in this process eagerly (exact launches a
     batch) and through its one graph (exactly two forwards: warm-up and
     capture); an artifact exported on the CPU served on the card
     (move_to_device_pass);
  36. main_serve on 127.0.0.1:0 in a thread, from a checkpoint and from the
     artifact, each at --coalesce_ms 0 and 2: /healthz; 8 client threads x
     10 requests of 1-12 samples, each response against a direct predict of
     the same samples (1e-5 of the largest value) with its ids; an empty
     body 400, a declared 300 MB body 413, an unknown path 404; requests/s
     and p50 / p99 latency; the servers' launches exactly two forwards for
     each graph their predictors captured.

The eDOS paths must launch no batched_segment_sum (eDOS sums its messages
in the fused kernel). The line before the last is a JSON object with one row
per kernel: error and times at the eDOS flagship shapes (the phDOS shapes'
mean per call as ``ms_phdos``), ``bound_ms`` (the larger of this run's bytes
over 3.35 TB/s and its f32 operations over 67 TFLOP/s, ``bound_by`` saying
which), ``library_ms`` (one PyTorch call computing the same function, timed
here and used nowhere in the port; null where there is none), for the two
message-passing kernels ``form``, ``tile``, ``smem_bytes``, ``ms_generic``
(the generic form on the same inputs), ``sub_kernels_ms``,
``generic_width`` (the row of the width that keeps the generic form),
``by_shape_phdos`` (batch 8 and batch 1) and ``by_hidden`` (3h and 21), for the
three attention kernels ``d1024`` and ``d50`` (3g's timed rows) and
``widths_rel_err``, for the segment sum ``by_shape`` (3c, with the
partition), for the two attention kernels ``by_shape`` (the same numbers
per attention shape),
``ms_two_tensors`` (keys and values as two tensors), ``ms_no_stats`` (the
backward without the forward's row statistics), ``ms_op`` (the forward op
with its mask-to-bias ops) and ``resources``, for the LN-fused forward
``unfused_ms``, ``ms_bf16``, ``ms_other_aliasing`` and ``resources``, for
the LayerNorm backward ``ms_by_rows``, ``ms_raw_form_by_rows`` (x with mean
and rstd), ``library_ms_by_rows`` and ``resources``, and
``launches_by_path``, the launches on each path driven (each with the
counts set to 0 just before and read just after; on the graph-served paths
(``*_graph``, ``*_graph_cli`` for main_predict, ``*_exported``, ``*_http``)
the warm-up and capture runs alone, two forwards a graph), and for the four
forward kernels
``launches_per_replay`` (phase 34's profile, by case). ``launches`` is
the count on the phDOS training path with both levers on, the only path
that launches six of the seven kernels; for fused_attention, which that path
replaces, it is the count on the phDOS training path with the levers off
(``launches_path`` names the path). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
             "is False); this script runs the port on the card only")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dostransformer_tpu_torch.cli import (  # noqa: E402
    main_edos,
    main_phdos,
    main_predict,
)
from dostransformer_tpu_torch.data.datasets import (  # noqa: E402
    GraphLoader,
    edos_random_split,
)
from dostransformer_tpu_torch.data.graph import bucket_size, collate  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_edos_learnable,
    synthetic_edos_samples,
    synthetic_phdos_learnable,
    synthetic_phdos_samples,
)
from dostransformer_tpu_torch.models.registry import (  # noqa: E402
    build_model,
    model_outputs,
)
from dostransformer_tpu_torch.nn.layernorm import (  # noqa: E402
    layer_norm_bwd,
    ln_bwd_plan,
    ln_bwd_reference,
)
from dostransformer_tpu_torch.ops import kernels  # noqa: E402
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_bwd_reference,
    attention_plan,
    attention_stats_reference,
    dot_product_attention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_fwd,
    fused_attention_ln,
    key_bias,
    ln_attention_reference,
)
from dostransformer_tpu_torch.ops.fused_mp import (  # noqa: E402
    FORM_GENERIC,
    _fused_mp_edge_fwd as fused_mp_forward_kernel,
    fused_mp_edge,
    fused_mp_bwd_form,
    fused_mp_edge_bwd,
    fused_mp_edge_bwd_tile,
    fused_mp_edge_tile,
    fused_mp_form,
    mp_edge_bwd_reference,
    mp_edge_reference,
)
from dostransformer_tpu_torch.ops.segment import (  # noqa: E402
    batched_segment_sum,
    segment_sum_plan,
    segment_sum_reference,
)
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

# flagship eDOS serving forward (cli/main_predict defaults) at batch 8
HIDDEN, LAYERS, T_LAYERS, BINS, BATCH = 256, 3, 2, 201, 8
# kernel vs plain version, f32 on the card: the two sum in different orders
# (and the kernel's agg avoids atomics), so they differ by f32 rounding only;
# 1e-5 relative to the output's magnitude leaves > 20x headroom over the
# errors seen at these shapes. The same bound holds per element for the
# backward kernels; their parameter gradients sum over all B*E = 3072 edges
# (the message-passing backward), so those get 1e-4
KERNEL_RTOL = 1e-5
PARAM_GRAD_RTOL = 1e-4
# whole forward on the card (kernels + cuBLAS) vs on the CPU (plain versions
# + CPU BLAS): f32 rounding accumulated through 3 processors and 6
# transformer layers
MODEL_ATOL = MODEL_RTOL = 1e-3
# train step on the card vs on the CPU: first-step gradients within
# atol 1e-3 + rtol 1e-3 (as the forward), per-step losses within rtol 1e-3
GRAD_ATOL = GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-3
# the baselines' first-step gradients, card vs CPU, per tensor: max abs error
# <= BASELINE_GRAD_REL * max(1, the CPU gradient's max abs), a limit that
# scales with each tensor (worst reading at hidden 256: 2.1e-6, 50x under)
BASELINE_GRAD_REL = 1e-4
# the phDOS flagship (main_phdos defaults but the batch): 51 bins
PH_BINS = 51
KERNELS = (fused_mp_edge, fused_attention, fused_mp_edge_bwd,
           fused_attention_bwd, batched_segment_sum, fused_attention_ln,
           layer_norm_bwd)
# the __global__ functions behind the two attention wrappers, by width
ATTENTION_KERNELS = {"fused_attention": ("attn_fwd_kernel",
                                         "attn_fwd_sliced_kernel"),
                     "fused_attention_bwd": ("stats_kernel", "dq_kernel",
                                             "dkv_kernel",
                                             "stats_sliced_kernel",
                                             "dq_sliced_kernel",
                                             "dkv_sliced_kernel")}
# the sliced forms (D > 512), instantiated at 16 column groups
SLICED_KERNELS = {
    "attn_fwd_sliced_kernel": "attn_fwd_sliced_kernelIfLi16E",
    "attn_fwd_sliced_kernel<bf16>":
        "attn_fwd_sliced_kernelI13__nv_bfloat16Li16E",
    "stats_sliced_kernel": "stats_sliced_kernelIfLi16E",
    "dq_sliced_kernel": "dq_sliced_kernelIfLi16E",
    "dkv_sliced_kernel": "dkv_sliced_kernelIfLi16E",
    "dq_sliced_kernel<bf16>": "dq_sliced_kernelI13__nv_bfloat16Li16E",
    "dkv_sliced_kernel<bf16>": "dkv_sliced_kernelI13__nv_bfloat16Li16E",
    "attn_ln_fwd_sliced_kernel<float>": "attn_ln_fwd_sliced_kernelIfLi16E",
    "attn_ln_fwd_sliced_kernel<bf16>":
        "attn_ln_fwd_sliced_kernelI13__nv_bfloat16Li16E"}
BACKWARD = ("fused_mp_edge_bwd", "fused_attention_bwd", "layer_norm_bwd")
# what compare_mp adds to a message-passing row
MP_EXTRAS = ("form", "tile", "smem_bytes", "ms_generic", "sub_kernels_ms")
# the __global__ functions of the two message-passing sources whose
# registers and stack phase 2 prints (template arguments as nvcc mangles them)
MP_KERNELS = {
    "edge_tc_kernel<1,2,4> 32x256": "edge_tc_kernelIfLi1ELi2ELi4E",
    "edge_tc_kernel<1,1,1> 16x64": "edge_tc_kernelIfLi1ELi1ELi1E",
    "edge_tc_kernel<bf16,1,2,4> 32x256":
        "edge_tc_kernelI13__nv_bfloat16Li1ELi2ELi4E",
    "edge_tc_kernel<bf16,1,1,1> 16x64":
        "edge_tc_kernelI13__nv_bfloat16Li1ELi1ELi1E",
    "edge_kernel<bf16>": "11edge_kernelI13__nv_bfloat16E",
    "edge_bwd_tc_kernel<1,4>": "edge_bwd_tc_kernelIfLi1ELi4E",
    "edge_bwd_tc_kernel<2,4>": "edge_bwd_tc_kernelIfLi2ELi4E",
    "edge_bwd_tc_kernel<1,2>": "edge_bwd_tc_kernelIfLi1ELi2E",
    "edge_bwd_tc_kernel<bf16,1,4>":
        "edge_bwd_tc_kernelI13__nv_bfloat16Li1ELi4E",
    "edge_bwd_tc_kernel<bf16,2,4>":
        "edge_bwd_tc_kernelI13__nv_bfloat16Li2ELi4E",
    "edge_bwd_tc_kernel<bf16,1,2>":
        "edge_bwd_tc_kernelI13__nv_bfloat16Li1ELi2E",
    "gw1_tc_kernel": "gw1_tc_kernel", "edge_kernel": "11edge_kernelIfE",
    "edge_bwd_kernel": "15edge_bwd_kernelIfE",
    "edge_bwd_kernel<bf16>": "15edge_bwd_kernelI13__nv_bfloat16E",
    "gw1_kernel": "10gw1_kernel",
    "agg_kernel": "10agg_kernelIfE",
    "agg_kernel<bf16>": "10agg_kernelI13__nv_bfloat16E",
    "tail_kernel": "11tail_kernel"}
# bf16 operands of the LayerNorm backward: the kernel keeps g = dy * scale in
# f32 where the plain version rounds it to bf16, so within 3% of the largest
# value (the JAX package's bound for the same comparison)
BF16_RTOL = 0.03
# bf16 operands of the LN-fused attention: q, k, v and the output are each
# rounded to bf16 (2^-9 relative), and the plain version also rounds its
# softmax weights to bf16 where the kernel keeps TF32's 10 bits
ATTN_BF16_RTOL = 0.02
# the __global__ functions of the two LayerNorm-lever kernels whose registers
# and stack phase 2 prints (a nonzero stack in the first two is a fault)
LN_KERNELS = {
    "attn_ln_fwd_kernel<float,8>": "attn_ln_fwd_kernelIfLi8ELb1E",
    "attn_ln_fwd_kernel<bf16,8>": "attn_ln_fwd_kernelI13__nv_bfloat16Li8ELb1E",
    "attn_ln_fwd_kernel<float,2,ragged> (D=50)":
        "attn_ln_fwd_kernelIfLi2ELb0E",
    "attn_ln_fwd_kernel<bf16,2,ragged> (D=50)":
        "attn_ln_fwd_kernelI13__nv_bfloat16Li2ELb0E",
    "ln_bwd_kernel<float,2> (D=256)": "ln_bwd_kernelIfLi2ELb0E",
    "ln_bwd_kernel<float,2,x> (D=256)": "ln_bwd_kernelIfLi2ELb1E",
    "ln_bwd_kernel<bf16,1> (D=256)": "ln_bwd_kernelI13__nv_bfloat16Li1ELb0E",
    "ln_bwd_kernel<float,8> (D=1024)": "ln_bwd_kernelIfLi8ELb0E",
    "ln_bwd_kernel<float,0> (scalar)": "ln_bwd_kernelIfLi0ELb0E"}
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes/s and f32 FLOP/s outside the tensor cores; every kernel here is f32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the JAX package's lever names, as a user sets them
FUSE_ENV = {"DOSTPU_FUSE_LN_ATTN": "1"}
LEVERS_ENV = {"DOSTPU_FUSE_LN_ATTN": "1", "DOSTPU_LN_PALLAS": "1"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    """Median device time of fn() over ``runs`` runs, by CUDA events. Before
    each run a spin kernel (about a millisecond) keeps the card busy while
    the host queues the start event, fn's launches and the end event, so the
    events bracket device work only and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def launch_counts(**counts) -> dict:
    """A count for every kernel: those given, 0 for the rest."""
    return {**dict.fromkeys((k.__name__ for k in KERNELS), 0), **counts}


def step_launches(task: str, levers: bool) -> dict:
    """Kernel launches of one train step at the flagship depth. With both
    LayerNorm levers on, the attention forward is the LN-fused kernel and
    every LayerNorm backward is a layer_norm_bwd launch: per layer one for
    each distinct tensor among ln0's inputs (keys and values are one tensor
    everywhere; in the self stack's first layer the queries are that tensor
    too) and one for ln1, per stack one for the final LayerNorm."""
    attn = 3 * T_LAYERS
    want = launch_counts(fused_mp_edge=LAYERS, fused_mp_edge_bwd=LAYERS,
                         fused_attention_bwd=attn,
                         batched_segment_sum=LAYERS if task == "phdos" else 0)
    if levers:
        want.update(fused_attention_ln=attn,
                    layer_norm_bwd=3 * (3 * T_LAYERS + 1) - 1)
    else:
        want.update(fused_attention=attn)
    return want


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors given (each read or written once)."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
    return sum(seen.values())


def compare(name, kernel_fn, plain_fn, rtols=None, repeat=False, work=None,
            library_fn=None, floor=1.0, flops_per_s=F32_FLOPS_PER_S):
    """Run kernel and plain version on the same inputs; each output must be
    within its rtol (default KERNEL_RTOL) x max(floor, max|plain|); with
    ``repeat`` a second kernel run must give the same bits. ``work`` is
    (bytes moved, operations) for these inputs, the operations at
    ``flops_per_s`` (f32 outside the tensor cores unless given); ``library_fn`` the one
    PyTorch call that computes the same function. Returns a dict: err, rel,
    ms, plain_ms, bytes_ms, ops_ms (the two lower bounds), library_ms."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rtols = rtols or (KERNEL_RTOL,) * len(want)
    abs_err = rel_err = 0.0
    for i, (g, w, tol) in enumerate(zip(got, want, rtols)):
        check(g.shape == w.shape, f"{name}: output {i} shape {tuple(g.shape)}"
                                  f" != {tuple(w.shape)}")
        check(g.dtype == w.dtype, f"{name}: output {i} is {g.dtype}, plain "
                                  f"{w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        err = (g.float() - w.float()).abs().max().item()
        scale = max(floor, w.float().abs().max().item())
        check(err <= tol * scale,
              f"{name}: output {i} max abs err {err:.3e} > {tol} x "
              f"{scale:.3g}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    if repeat:
        again = kernel_fn()
        again = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: a second run differs (not deterministic)")
    out = {"err": abs_err, "rel": rel_err, "ms": median_ms(kernel_fn),
           "plain_ms": median_ms(plain_fn), "bytes_ms": 0.0, "ops_ms": 0.0,
           "library_ms": None}
    if work is not None:
        out["bytes_ms"] = work[0] / HBM_BYTES_PER_S * 1e3
        out["ops_ms"] = work[1] / flops_per_s * 1e3
    if library_fn is not None:
        out["library_ms"] = median_ms(library_fn)
    lib = ("" if library_fn is None
           else f", library call {out['library_ms']:.4f} ms")
    bound = ("" if work is None else
             f"; bound {max(out['bytes_ms'], out['ops_ms']):.4f} ms "
             f"({work[0] / 1e6:.2f} MB, {work[1] / 1e9:.3f} GFLOP)")
    print(f"  {name}: max abs err {abs_err:.3e}, rel {rel_err:.3e} "
          f"(tol {'/'.join(map(str, sorted(set(rtols))))} rel)"
          f"{', repeats bit-identically' if repeat else ''}; kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms{lib} (median "
          f"of 50){bound}")
    return out


def attention_shapes():
    """The three stacks' attention shapes, D=256: cross (B, 201 x 32), self
    on the 2B head batch (2B, 201 x 201), source (2B, 201 x 32)."""
    return {"cross": (BATCH, BINS, 32), "self": (2 * BATCH, BINS, BINS),
            "source": (2 * BATCH, BINS, 32)}


def phdos_attention_shapes():
    return {"cross B=8": (BATCH, PH_BINS, 16),
            "self 2B": (2 * BATCH, PH_BINS, PH_BINS),
            "source 2B": (2 * BATCH, PH_BINS, 16)}


def per_forward(per_shape):
    """Over a forward's calls (two at each of the shapes given): the largest
    errors and the mean per call of every time and bound."""
    runs = list(per_shape.values())
    out = {k: max(r[k] for r in runs) for k in ("err", "rel")}
    for k in ("ms", "plain_ms", "bytes_ms", "ops_ms"):
        out[k] = statistics.mean(r[k] for r in runs)
    lib = [r["library_ms"] for r in runs]
    out["library_ms"] = None if None in lib else statistics.mean(lib)
    for k in ("ms_two_tensors", "ms_op", "ms_no_stats"):  # attention's extras
        if all(k in r for r in runs):
            out[k] = statistics.mean(r[k] for r in runs)
    out["by_shape"] = {label: {k: r[k] for k in (
        "ms", "plain_ms", "library_ms", "ms_two_tensors", "ms_op",
        "ms_no_stats", *MP_EXTRAS) if k in r}
        | {"bound_ms": max(r["bytes_ms"], r["ops_ms"]), "max_abs_err": r["err"]}
        for label, r in per_shape.items()}
    return out


def mp_work(args, outputs, backward=False):
    """(bytes, f32 operations) of the fused message-passing kernel on these
    inputs: per REAL edge (the mask's) the [M] x [M, H] product (twice in
    the backward: the gradient of the activations and of W1) and ~12 (~30)
    elementwise operations per feature for the gather, LayerNorm and PReLU
    (and their backward)."""
    m, h = args[0].shape[-1], args[9].shape[0]
    real = float(args[5].sum().item())
    flops = real * ((4 * m * h + 30 * m) if backward
                    else (2 * m * h + 12 * m + 2 * h))
    return nbytes(*args) + nbytes(*outputs), flops


def device_kernel_times(fn, runs: int = 10) -> dict:
    """Device time in ms per call of fn(), by kernel name (up to the first
    '(' or '<'), from torch.profiler over ``runs`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {}
    for _ in range(3):  # a profile now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for name, ms in device_events(prof):
            times[name] = times.get(name, 0.0) + ms / runs
        if times:
            break
    check(bool(times), "the profile shows no device activity")
    return times


def device_events(prof):
    """(short kernel name, device ms) of every device activity (kernels and
    memory copies) the profile recorded."""
    from torch.autograd import DeviceType

    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time", None)
        if us is None:
            us = ev.cuda_time
        name = re.sub(r"^void ", "", ev.name)
        name = name.replace("(anonymous namespace)::", "")
        yield re.split(r"[(<]", name)[0], us / 1e3


# (label, call, row) of every message-passing comparison, for phase_sub_kernels
SUB_KERNEL_JOBS = []


def phase_sub_kernels():
    """16a: the device time of each sub-kernel of every message-passing call
    compared in 3, 3b and 3d (torch.profiler), into the rows'
    ``sub_kernels_ms``."""
    print("message-passing sub-kernels, device ms a call (torch.profiler):")
    for label, call, row in SUB_KERNEL_JOBS:
        row["sub_kernels_ms"].update(device_kernel_times(call))
        print(f"  {label} ({row['ms']:.4f} ms the whole call): "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in row["sub_kernels_ms"].items()))


def compare_mp(label, args, backward):
    """Kernel #1 (or #2 with ``backward``) at one shape: the form the widths
    take against the plain version (a second run must repeat the bits),
    beside the generic form on the same inputs (the FMA design every width
    took before the tensor-core form existed); the device time of each
    sub-kernel of the call is taken later, by :func:`phase_sub_kernels`."""
    name = "fused_mp_edge_bwd" if backward else "fused_mp_edge"
    kernel = fused_mp_edge_bwd if backward else fused_mp_forward_kernel
    wrapper = fused_mp_edge_bwd if backward else fused_mp_edge
    plain = mp_edge_bwd_reference if backward else mp_edge_reference
    rtols = ((KERNEL_RTOL,) * 3 + (PARAM_GRAD_RTOL,) * 5 if backward
             else (KERNEL_RTOL,) * 2)
    b, e = args[3].shape
    m, h = args[0].shape[-1], args[9].shape[0]
    form_of = fused_mp_bwd_form if backward else fused_mp_form
    tc = form_of(m, h) != FORM_GENERIC
    out = compare(f"{name}[{label}]", lambda: wrapper(*args),
                  lambda: plain(*args), rtols=rtols, repeat=True,
                  work=mp_work(args, wrapper(*args), backward=backward))
    out["form"] = "tensor-core" if tc else "generic"
    out["sub_kernels_ms"] = {}  # filled in place: copies of the row share it
    # profiled at the end of the run (phase_sub_kernels): once torch.profiler
    # has run in a process, every later launch costs the host more
    SUB_KERNEL_JOBS.append((f"{name}[{label}]", lambda: wrapper(*args), out))
    line = f"  {name}[{label}]: form {out['form']}"
    if tc:
        generic = lambda: kernel(*args, form=FORM_GENERIC)
        for i, (g, w, tol) in enumerate(zip(generic(), plain(*args), rtols)):
            err = (g - w).abs().max().item()
            check(err <= tol * max(1.0, w.abs().max().item()),
                  f"{name}[{label}]: generic form, output {i} max abs err "
                  f"{err:.3e}")
        out["ms_generic"] = median_ms(generic)
        lib = kernels.library()
        if backward:
            te, cluster, splits = fused_mp_edge_bwd_tile(b, e, m, h)
            out["tile"] = (f"{te} edges x {cluster} blocks, {splits} g_W1 "
                           f"splits")
            out["smem_bytes"] = lib.dostpu_fused_mp_edge_bwd_smem_bytes(
                b, e, m, h, -1)
        else:
            out["tile"] = "{}x{}".format(*fused_mp_edge_tile(b, e, m, h))
            out["smem_bytes"] = lib.dostpu_fused_mp_edge_smem_bytes(
                b, e, m, h, -1)
        line += (f"; generic (FMA) form on the same inputs "
                 f"{out['ms_generic']:.4f} ms; tile taken {out['tile']} "
                 f"({out['smem_bytes']} B of shared memory a block)")
    print(line)
    return out


def attention_work(b, lq, lk, d, inputs, outputs, backward=False):
    """(bytes, f32 operations): 2 products of 2 * Lq * Lk * D in the
    forward, 5 in the backward (scores again, dp, dv, dq, dk). ``outputs``
    are tensors of the outputs' shapes."""
    return (nbytes(*inputs) + nbytes(*outputs),
            (10 if backward else 4) * b * lq * lk * d)


def sdpa(q, k, v, bias):
    """The library yardstick: one F.scaled_dot_product_attention call, one
    head, the additive key bias as its mask."""
    return F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None],
        attn_mask=bias[:, None, None, :])[:, 0]


def sdpa_backward(q, k, v, bias, go):
    """A callable that runs the backward of :func:`sdpa` for the upstream
    gradient go (the graph is built once, outside the timing)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = sdpa(*leaves, bias)
    return lambda: torch.autograd.grad(o, leaves, go, retain_graph=True)


def check_attention_forward(name, q, k, km, bias, out):
    """What the tensor-core forward adds to the comparison of ``compare``
    (which ran the kernel as the transformer layer calls it, keys and values
    ONE tensor, staged once): its row statistics against the plain scores'
    max and sum(exp(s - max)); two copies of the keys as k and v against the
    one tensor, bit for bit; and the op a model calls, ``fused_attention``
    with the boolean key mask, against the wrapper. Adds to ``out`` the
    times ``ms_two_tensors`` and ``ms_op`` (the op: the kernel plus the two
    eager ops that turn the mask into the additive bias)."""
    shared, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
    want = attention_stats_reference(q, k, bias)
    dummy = (bias == bias.new_tensor(-1e30)).all(-1)  # every key masked
    check(bool((stats[0][dummy] == -1e30).all())
          and bool((stats[1][dummy] == k.shape[1]).all()),
          f"{name}: a fully masked row's statistics are not (-1e30, Lk)")
    real = ~dummy
    for what, got_s, want_s in (
            ("row max", stats[0][real], want[0][real]),
            ("log-sum-exp", stats[0][real] + stats[1][real].log(),
             want[0][real] + want[1][real].log())):
        err = (got_s - want_s).abs().max().item()
        scale = max(1.0, want_s.abs().max().item())
        check(err <= KERNEL_RTOL * scale,
              f"{name}: {what} max abs err {err:.3e} > {KERNEL_RTOL} x "
              f"{scale:.3g}")
    copy = k.clone()
    check(torch.equal(shared, fused_attention_fwd(q, k, copy, bias)[0]),
          f"{name}: v is k differs from two copies")
    check(torch.equal(shared, fused_attention(q, k, k, km)),
          f"{name}: the op differs from the kernel's wrapper")
    out["ms_two_tensors"] = median_ms(
        lambda: fused_attention_fwd(q, k, copy, bias))
    out["ms_op"] = median_ms(lambda: fused_attention(q, k, k, km))
    print(f"  {name}: row statistics within {KERNEL_RTOL} rel of the plain "
          f"scores'; v is k bit-equal to two copies "
          f"({out['ms_two_tensors']:.4f} ms with copies); the op with its "
          f"mask-to-bias ops {out['ms_op']:.4f} ms")


def check_attention_backward(name, q, k, bias, o, go, stats, got, out):
    """What the tensor-core backward adds to the comparison of ``compare``
    (which ran it as the default layer does: keys and values one tensor,
    the forward's statistics): the same bits without the statistics (the
    kernel then recomputes them: the LayerNorm-fused layer's call) and with
    two copies of the keys as k and v. ``got`` is the compared result. Adds
    ``ms_no_stats`` and ``ms_two_tensors`` to ``out``."""
    copy = k.clone()
    for what, other in (
            ("without the forward's statistics",
             fused_attention_bwd(q, k, k, bias, o, go)),
            ("with two copies of the keys",
             fused_attention_bwd(q, k, copy, bias, o, go, stats))):
        check(all(torch.equal(a, b) for a, b in zip(got, other)),
              f"{name}: the gradients differ {what}")
    out["ms_no_stats"] = median_ms(
        lambda: fused_attention_bwd(q, k, k, bias, o, go))
    out["ms_two_tensors"] = median_ms(
        lambda: fused_attention_bwd(q, k, copy, bias, o, go, stats))
    print(f"  {name}: bit-equal without the forward's statistics "
          f"({out['ms_no_stats']:.4f} ms) and with two copies of the keys "
          f"({out['ms_two_tensors']:.4f} ms)")


def generic_width_args(g, dev, backward=False):
    """Message-passing operands at a width that keeps the generic (FMA)
    form, with ragged tiles everywhere: B=2 A=5 E=17 M=600 H=300."""
    b, a, e, m, h = 2, 5, 17, 600, 300
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            (torch.rand(b, e, generator=g) > 0.25).float().to(dev),
            rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5)
    if backward:
        return args + (rand(b, e, h), rand(b, a, h))
    return args + (rand(h) * 0.1,)


def phase_kernels(dev):
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    out = {}

    # A: one processor's edge pipeline at B=8, A=32, E=384, M=2H=512, H=256
    b, a, e, m, h = BATCH, 32, 384, 2 * HIDDEN, HIDDEN
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0  # a dummy graph of a short batch: no real edges
    args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5,
            rand(h) * 0.1)
    print(f"fused_mp_edge B={b} A={a} E={e} M={m} H={h}")
    out["fused_mp_edge"] = compare_mp("eDOS", args, False)
    odd = generic_width_args(g, dev)
    out["fused_mp_edge"]["generic_width"] = compare_mp(
        "B=2 A=5 E=17 M=600 H=300", odd, False)

    # B: the three stacks' attention shapes
    per_shape = {}
    for label, (bb, lq, lk) in attention_shapes().items():
        q, k = rand(bb, lq, HIDDEN), rand(bb, lk, HIDDEN)
        v = k  # keys and values are one tensor, as the layer passes them
        km = None
        if lk != lq:  # atom keys: pad atoms masked, last graph all masked
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
            km[-1] = False
            km = km.to(dev)
        bias = (key_bias(km) if km is not None
                else torch.zeros(bb, lk, device=dev))
        print(f"fused_attention {label}: B={bb} Lq={lq} Lk={lk} D={HIDDEN}"
              f"{' (last graph fully masked)' if km is not None else ''}")
        per_shape[label] = compare(
            f"fused_attention[{label}]",
            lambda: fused_attention_fwd(q, k, v, bias)[0],
            lambda: dot_product_attention(q, k, v, km),
            work=attention_work(bb, lq, lk, HIDDEN, (q, k, v, bias), (q,)),
            library_fn=lambda: sdpa(q, k, v, bias))
        check_attention_forward(f"fused_attention[{label}]", q, k, km, bias,
                                per_shape[label])
    out["fused_attention"] = per_forward(per_shape)
    return out


def phase_backward_kernels(dev):
    g = torch.Generator().manual_seed(1)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    out = {}

    # A: one processor's edge backward at B=8, A=32, E=384, M=512, H=256
    b, a, e, m, h = BATCH, 32, 384, 2 * HIDDEN, HIDDEN
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0  # a dummy graph: every edge is padding
    args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5,
            rand(b, e, h), rand(b, a, h))
    print(f"fused_mp_edge_bwd B={b} A={a} E={e} M={m} H={h} (last graph a "
          f"dummy, nonzero upstream gradients everywhere)")
    out["fused_mp_edge_bwd"] = compare_mp("eDOS", args, True)
    odd = generic_width_args(g, dev, backward=True)
    out["fused_mp_edge_bwd"]["generic_width"] = compare_mp(
        "B=2 A=5 E=17 M=600 H=300", odd, True)

    # B: attention backward at the three shapes, the last graph fully masked
    per_shape = {}
    for label, (bb, lq, lk) in attention_shapes().items():
        q, k, go = (rand(bb, n, HIDDEN) for n in (lq, lk, lq))
        v = k  # keys and values are one tensor, as the layer passes them
        km = torch.ones(bb, lk, dtype=torch.bool)
        if lk != lq:
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
        km[-1] = False
        bias = key_bias(km.to(dev))
        o, stats = fused_attention_fwd(q, k, v, bias, want_stats=True)
        print(f"fused_attention_bwd {label}: B={bb} Lq={lq} Lk={lk} "
              f"D={HIDDEN} (last graph fully masked)")
        per_shape[label] = compare(
            f"fused_attention_bwd[{label}]",
            lambda: fused_attention_bwd(q, k, v, bias, o, go, stats),
            lambda: attention_bwd_reference(q, k, v, bias, go), repeat=True,
            work=attention_work(bb, lq, lk, HIDDEN, (q, k, v, bias, o, go),
                                (q, k, v), True),
            library_fn=sdpa_backward(q, k, v, bias, go))
        check_attention_backward(
            f"fused_attention_bwd[{label}]", q, k, bias, o, go, stats,
            fused_attention_bwd(q, k, v, bias, o, go, stats),
            per_shape[label])
    out["fused_attention_bwd"] = per_forward(per_shape)
    return out


def serve_requests():
    big = synthetic_edos_samples(96, seed=0)
    short = synthetic_edos_samples(5, seed=1)
    small = synthetic_edos_samples(10, seed=2, min_atoms=3, max_atoms=6)
    large = synthetic_edos_samples(6, seed=3, min_atoms=40, max_atoms=60)
    mixed = [s for pair in zip(small, large) for s in pair] + small[6:]
    return {"96": big, "5 (short batch)": short, "16 mixed": mixed}


def expected_batches(samples) -> int:
    groups = {}
    for s in samples:
        groups[bucket_size(s.n_nodes)] = groups.get(bucket_size(s.n_nodes), 0) + 1
    return sum(math.ceil(n / BATCH) for n in groups.values())


def group_shapes(samples) -> set:
    """The (atoms, edges) geometries a bucketed request's groups collate
    to, each one graph."""
    groups = {}
    for s in samples:
        groups.setdefault(bucket_size(s.n_nodes), []).append(s)
    return {(loader.atoms_per_graph, loader.edges_per_graph)
            for loader in (GraphLoader(g, BATCH) for g in groups.values())}


def graph_forwards(samples) -> int:
    """The forwards the wrappers' counters see when a new graph-served
    predictor (main_predict's) serves a request: two a geometry (the eager
    warm-up and the capture), none at a replay."""
    return 2 * len(group_shapes(samples))


def check_dos(label, dos, n):
    check(dos.shape == (n, BINS), f"{label}: shape {dos.shape} != {(n, BINS)}")
    check(bool(np.isfinite(dos).all()), f"{label}: non-finite output")
    check(bool((dos >= 0).all()), f"{label}: negative output despite clamp")


def check_served(gpu, cpu, requests, outputs, task="") -> float:
    """Each request's card outputs against the CPU predictor's, then the
    serving rate of the 96-sample request (median of 5 calls after a warm
    one, samples/s)."""
    for label, samples in requests.items():
        ref = cpu.predict(samples)
        err = float(np.abs(outputs[label] - ref).max())
        print(f"{task}request {label}: card vs CPU plain max abs err "
              f"{err:.3e} (atol {MODEL_ATOL} + rtol {MODEL_RTOL})")
        check(np.allclose(outputs[label], ref, atol=MODEL_ATOL,
                          rtol=MODEL_RTOL),
              f"{task}{label}: card output differs from the CPU run by "
              f"{err:.3e}")
    return serving_rate(gpu, requests["96"])


def serving_rate(predictor, samples) -> float:
    """Samples/s of one request: median of 5 calls after a warm one."""
    predictor.predict(samples)  # warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor.predict(samples)  # ends in one copy to the host: synchronised
        times.append(time.perf_counter() - t0)
    return len(samples) / statistics.median(times)


def phase_main_path(workdir):
    gen = torch.Generator().manual_seed(0)
    model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN, generator=gen)
    weights = os.path.join(workdir, "edos_flagship.pt")
    torch.save(model.state_dict(), weights)
    requests = serve_requests()
    paths = {}
    for label, samples in requests.items():
        paths[label] = os.path.join(workdir, f"request_{len(samples)}.npz")
        save_samples(paths[label], samples)

    kw = dict(task="edos", example=requests["96"][0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=HIDDEN, batch_size=BATCH)
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False, **kw)
    cpu = Predictor.from_torch(weights, device="cpu", **kw)

    reset_launches()
    outputs, total_batches = {}, 0
    for label, samples in requests.items():
        before = (fused_mp_edge.launches, fused_attention.launches)
        if label == "96":
            out_path = os.path.join(workdir, "preds_96.npz")
            main_predict.main([
                "--task", "edos", "--torch_state_dict", weights,
                "--input", paths[label], "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
                check(list(z["sample_id"]) == [s.sample_id for s in samples],
                      "CLI output sample_id order")
                check(list(z["mp_id"]) == [s.mp_id for s in samples],
                      "CLI output mp_id order")
            n_batches, how = graph_forwards(samples), "graph-served forwards"
        else:
            dos = gpu.predict(samples)
            n_batches, how = expected_batches(samples), "batches"
        total_batches += n_batches
        mp = fused_mp_edge.launches - before[0]
        attn = fused_attention.launches - before[1]
        print(f"request {label}: {n_batches} {how}, fused_mp_edge "
              f"launches {mp}, fused_attention launches {attn}")
        check(mp == LAYERS * n_batches,
              f"{label}: {mp} fused_mp_edge launches, expected "
              f"{LAYERS * n_batches}")
        check(attn == 3 * T_LAYERS * n_batches,
              f"{label}: {attn} fused_attention launches, expected "
              f"{3 * T_LAYERS * n_batches}")
        check_dos(label, dos, len(samples))
        outputs[label] = dos
    launches = read_launches()
    print(f"serving path: {total_batches} forwards, launches {launches}")
    check(launches["fused_mp_edge_bwd"] == launches["fused_attention_bwd"]
          == 0, "serving launched a backward kernel")
    check(launches["batched_segment_sum"] == 0,
          "eDOS serving launched batched_segment_sum (eDOS sums messages)")

    served = dict(kw=kw, weights=weights, requests=requests,
                  request_path=paths["96"], outputs=outputs, gpu=gpu,
                  bins=BINS)
    return launches, check_served(gpu, cpu, requests, outputs), served


def with_env(env, fn, *args):
    """fn(*args) with ``env`` added to os.environ, as a user would set the
    JAX package's lever names; the environment is restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_counted(cli, argv, env=None):
    """Run a training entry point (with ``env`` in its environment) with the
    kernel launches of every Trainer.train_step and Trainer.eval_step
    counted, the counts set to 0 just before; returns (result, per-call
    launches, the run's launches)."""
    per_call = {"train": [], "eval": []}
    originals = (Trainer.train_step, Trainer.eval_step)

    def counted(kind, fn):
        def wrapper(self, batch):
            before = read_launches()
            out = fn(self, batch)
            per_call[kind].append({k: v - before[k]
                                   for k, v in read_launches().items()})
            return out
        return wrapper

    Trainer.train_step = counted("train", originals[0])
    Trainer.eval_step = counted("eval", originals[1])
    reset_launches()
    try:
        result = with_env(env or {}, cli.main, argv)
    finally:
        Trainer.train_step, Trainer.eval_step = originals
    return result, per_call, read_launches()


def check_training_run(label, result, per_call, want_train, n_steps, log,
                       workdir, epochs, hidden=HIDDEN, want_eval=None,
                       embedder="DOSTransformer"):
    """Launches per train step (want_train) and per eval batch (want_eval;
    by default the train step's forward, no backward), the step count,
    finite epoch losses, test metrics and the experiments block
    (experiments_{embedder}.txt). Returns the epoch losses."""
    print(f"\n{label}: {len(per_call['train'])} train steps, "
          f"{len(per_call['eval'])} eval batches")
    if want_eval is None:
        want_eval = dict(want_train, **dict.fromkeys(BACKWARD, 0))
    check(len(per_call["train"]) == n_steps,
          f"{label}: {len(per_call['train'])} train steps, expected "
          f"{n_steps}")
    for kind, want in (("train", want_train), ("eval", want_eval)):
        bad = [c for c in per_call[kind] if c != want]
        check(not bad, f"{label}: {kind} step launches {bad[:1]}, expected "
                       f"{want}")
    check(per_call["eval"], f"{label}: no eval batch ran")
    with open(log) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    print(f"{label}: epoch losses {losses}; test metrics {result['test']}")
    check(len(losses) == epochs and all(math.isfinite(x) for x in losses),
          f"{label}: epoch losses {losses}")
    check(result["test"] is not None
          and all(math.isfinite(v) for v in result["test"].values()),
          f"{label}: test metrics {result['test']}")
    with open(os.path.join(workdir, f"experiments_{embedder}.txt")) as f:
        block = f.read()
    check("best RMSE : " in block and f"hidden({hidden})" in block,
          f"{label}: experiments block: {block!r}")
    return losses


def phase_training_path(workdir, env=None):
    """cli.main_edos at the full width (with ``env``, the LayerNorm levers,
    in its environment); per-call launch counts of every train and eval
    step. Returns (the run's launches, its epoch losses)."""
    log = os.path.join(workdir, "train.jsonl")
    result, per_call, launches = run_counted(main_edos, [
        "--synthetic", "96", "--synthetic_learnable", "--epochs", "3",
        "--eval", "1", "--layers", str(LAYERS), "--transformer",
        str(T_LAYERS), "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
        "--device", "cuda", "--results_dir", workdir, "--log_jsonl", log],
        env)
    label = f"eDOS training path{' (both levers)' if env else ''}"
    print(f"\n{label}: launches {launches}")
    n_train = len(edos_random_split(range(96))[0])  # main_edos's split
    losses = check_training_run(label, result, per_call,
                                step_launches("edos", bool(env)),
                                3 * math.ceil(n_train / BATCH), log, workdir,
                                3)
    return launches, losses


def phase_card_vs_cpu(task: str, hidden=HIDDEN, samples=21, batch=BATCH,
                      **levers):
    """Trainer.train_steps of one seeded model on both devices over
    ``samples`` samples at ``batch`` (21 at 8: 3 steps, the last batch short,
    with dummy graphs); eDOS clamps its targets, phDOS does not. ``levers``
    are the model's LayerNorm switches."""
    learnable = (synthetic_edos_learnable if task == "edos"
                 else synthetic_phdos_learnable)
    clamp = task == "edos"
    cpu_model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                            hidden=hidden,
                            generator=torch.Generator().manual_seed(1),
                            **levers)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batches = list(GraphLoader(learnable(samples, seed=5), batch))
    cpu = Trainer(cpu_model, clamp_targets=clamp, eval_clamp=clamp)
    gpu = Trainer(gpu_model, clamp_targets=clamp, eval_clamp=clamp)
    for step, batch in enumerate(batches):
        lc = cpu.train_step(batch)["loss"].item()
        lg = gpu.train_step(batch)["loss"].item()
        print(f"  step {step}: loss card {lg:.7f}, CPU {lc:.7f}")
        check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
              f"{task} step {step}: card loss {lg} vs CPU {lc}")
        if step == 0:
            worst, worst_name = 0.0, ""
            for (name, pc), pg in zip(cpu_model.named_parameters(),
                                      gpu_model.parameters()):
                gg = pg.grad.cpu()
                err = (gg - pc.grad).abs().max().item()
                if err > worst:
                    worst, worst_name = err, name
                check(torch.allclose(gg, pc.grad, atol=GRAD_ATOL,
                                     rtol=GRAD_RTOL),
                      f"{task} first-step gradient of {name} differs by "
                      f"{err:.3e}")
            print(f"  first-step gradients: card vs CPU max abs err "
                  f"{worst:.3e} ({worst_name}; atol {GRAD_ATOL} + rtol "
                  f"{GRAD_RTOL})")


def phase_train_rate(task: str, steps: int = 20, hidden=HIDDEN,
                     **levers) -> float:
    learnable = (synthetic_edos_learnable if task == "edos"
                 else synthetic_phdos_learnable)
    clamp = task == "edos"
    model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                        hidden=hidden, device="cuda",
                        generator=torch.Generator().manual_seed(2), **levers)
    trainer = Trainer(model, clamp_targets=clamp, eval_clamp=clamp)
    batches = list(GraphLoader(learnable(96, seed=0), BATCH))
    for batch in batches[:2]:  # warm
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    return steps * BATCH / (time.perf_counter() - t0)


# --- the phDOS flagship --------------------------------------------------


def phase_segment_sum(dev):
    """3c: the segment-sum kernel against its plain version: the phDOS
    NodeModel's edge count (F = 1) on a batch of 8 synthetic phDOS samples,
    F = 256 at B=8 A=32 E=384, and dropped ids with a dummy graph."""
    g = torch.Generator().manual_seed(4)
    batch = collate(synthetic_phdos_samples(BATCH, seed=0)).to(dev)
    b, e = batch.edge_mask.shape
    a = batch.atoms_per_graph
    count = batch.edge_mask[..., None]
    print(f"batched_segment_sum phDOS count: B={b} E={e} F=1 N={a} (the "
          f"edge mask onto the receivers)")
    def index_add(data, ids, n):
        """The library yardstick: zeros + index_add_ on the flattened batch
        (the flat index, with dropped ids sent to a spare row, is built
        outside the timing)."""
        bb, ee, f = data.shape
        ok = (ids >= 0) & (ids < n)
        flat = torch.where(ok, ids + torch.arange(bb, device=dev)[:, None] * n,
                           bb * n).reshape(-1).long()
        rows = data.reshape(bb * ee, f)
        return lambda: torch.zeros(bb * n + 1, f, device=dev).index_add_(
            0, flat, rows)[:-1].view(bb, n, f)

    def work(data, ids, n):
        """One add per feature of every row whose id names a segment."""
        kept = float(((ids >= 0) & (ids < n)).sum().item())
        out_bytes = data.shape[0] * n * data.shape[2] * 4
        return nbytes(data, ids) + out_bytes, kept * data.shape[2]

    lib_so = kernels.library()

    def run(name, data, ids, n):
        lib = index_add(data, ids, n)
        check(torch.allclose(lib(), segment_sum_reference(data, ids, n),
                             atol=1e-4), f"{name}: the index_add_ yardstick "
                                         f"computes another function")
        plan = [ctypes.c_int() for _ in range(4)]
        lib_so.dostpu_segment_sum_plan(*data.shape[:2], data.shape[2], n,
                                       *plan)
        vec, lanes, slots, segs = (p.value for p in plan)
        mirror = segment_sum_plan(*data.shape[:2], data.shape[2], n)
        check(mirror == dict(vec=vec, lanes=lanes, slots=slots, segs=segs),
              f"{name}: ops.segment.segment_sum_plan gives {mirror}, the "
              f"library {(vec, lanes, slots, segs)}")
        print(f"  {name}: {lanes} lanes of {vec} floats x {slots} edge "
              f"slots a block, {segs} segments a block (the port's mirror "
              f"agrees)")
        out = compare(name, lambda: batched_segment_sum(data, ids, n),
                      lambda: segment_sum_reference(data, ids, n),
                      repeat=True, work=work(data, ids, n), library_fn=lib)
        out["plan"] = dict(vec=vec, lanes=lanes, slots=slots, segs=segs)
        return out

    runs = [run("batched_segment_sum[count]", count, batch.receivers, a)]
    check(torch.equal(batched_segment_sum(count, batch.receivers, a),
                      segment_sum_reference(count, batch.receivers, a)),
          "batched_segment_sum: the F=1 edge counts are not exact")

    data = torch.randn(BATCH, 384, HIDDEN, generator=g).to(dev)
    ids = torch.randint(0, 32, (BATCH, 384), generator=g,
                        dtype=torch.int32).to(dev)
    print(f"batched_segment_sum wide: B={BATCH} E=384 F={HIDDEN} N=32")
    runs.append(run(f"batched_segment_sum[F={HIDDEN}]", data, ids, 32))
    # real crystals: ~2,000 edges and up to 64 atoms a graph, the count
    # (F = 1, a 0/1 edge mask: exact) and a wide row
    ids = torch.randint(0, 64, (BATCH, 2048), generator=g,
                        dtype=torch.int32).to(dev)
    ones = (torch.rand(BATCH, 2048, 1, generator=g) > 0.1).float().to(dev)
    print(f"batched_segment_sum real crystals: B={BATCH} E=2048 N=64, F=1 "
          f"and F={HIDDEN}")
    runs.append(run("batched_segment_sum[E=2048 N=64 F=1]", ones, ids, 64))
    check(torch.equal(batched_segment_sum(ones, ids, 64),
                      segment_sum_reference(ones, ids, 64)),
          "batched_segment_sum: the E=2048 counts are not exact")
    data = torch.randn(BATCH, 2048, HIDDEN, generator=g).to(dev)
    runs.append(run(f"batched_segment_sum[E=2048 N=64 F={HIDDEN}]", data,
                    ids, 64))

    short = collate(synthetic_phdos_samples(BATCH - 1, seed=1),
                    num_graphs=BATCH).to(dev)
    n = short.atoms_per_graph
    ids = short.receivers.clone()
    ids[:, 1::7] = -1
    ids[:, 2::9] = n + 3
    mask = short.edge_mask[..., None]
    print(f"batched_segment_sum edge cases: B={BATCH} (last graph a dummy) "
          f"E={ids.shape[1]} F=1 N={n}, ids -1 and N+3 dropped")
    runs.append(run("batched_segment_sum[dropped ids, dummy graph]", mask,
                    ids, n))
    # the row of the kernels line: the phDOS count, the path's only call
    labels = ("count", f"F={HIDDEN}", "E=2048 N=64 F=1",
              f"E=2048 N=64 F={HIDDEN}", "dropped ids, dummy graph")
    return {"batched_segment_sum": dict(
        runs[0], err=max(r["err"] for r in runs),
        rel=max(r["rel"] for r in runs),
        by_shape={label: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"],
                          "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
                          "max_abs_err": r["err"], "plan": r["plan"]}
                  for label, r in zip(labels, runs)})}


def phase_phdos_kernels(dev):
    """3d: kernels #1-#4 against their plain versions at the phDOS shapes:
    message passing on synthetic phDOS batches of 8 (7 crystals and a dummy
    graph) and of 1; attention with 51 queries against 16 atom keys (cross,
    source) or 51 energy tokens (self), and at batch 1 against 8 keys."""
    g = torch.Generator().manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    m, h = 2 * HIDDEN, HIDDEN
    runs = {name: {} for name in ("fused_mp_edge", "fused_mp_edge_bwd",
                                  "fused_attention", "fused_attention_bwd")}
    for label, n, slots in (("B=8", BATCH - 1, BATCH), ("B=1", 1, 1)):
        batch = collate(synthetic_phdos_samples(n, seed=2),
                        num_graphs=slots).to(dev)
        b, a, e = slots, batch.atoms_per_graph, batch.edges_per_graph
        fwd = (rand(b, a, m), rand(b, a, m), rand(b, e, m), batch.senders,
               batch.receivers, batch.edge_mask, rand(m).abs() + 0.5,
               rand(m) * 0.1, torch.tensor([0.25], device=dev),
               rand(h, m) * m ** -0.5, rand(h) * 0.1)
        bwd = fwd[:10] + (rand(b, e, h), rand(b, a, h))
        print(f"fused_mp_edge phDOS {label}: A={a} E={e} M={m} H={h}")
        runs["fused_mp_edge"][label] = compare_mp(f"phDOS {label}", fwd,
                                                  False)
        runs["fused_mp_edge_bwd"][label] = compare_mp(f"phDOS {label}", bwd,
                                                      True)

    shapes = dict(phdos_attention_shapes(), **{"cross B=1": (1, PH_BINS, 8)})
    for label, (bb, lq, lk) in shapes.items():
        q, k, go = (rand(bb, n, HIDDEN) for n in (lq, lk, lq))
        v = k  # keys and values are one tensor, as the layer passes them
        km = None
        if lk != lq:  # atom keys: pad atoms masked
            n_real = torch.randint(2, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
            if bb > 1:
                km[-1] = False  # a dummy graph: every key masked
            km = km.to(dev)
        bias = (key_bias(km) if km is not None
                else torch.zeros(bb, lk, device=dev))
        o, stats = fused_attention_fwd(q, k, v, bias, want_stats=True)
        print(f"fused_attention phDOS {label}: B={bb} Lq={lq} Lk={lk} "
              f"D={HIDDEN}")
        runs["fused_attention"][label] = compare(
            f"fused_attention[phDOS {label}]",
            lambda: fused_attention_fwd(q, k, v, bias)[0],
            lambda: dot_product_attention(q, k, v, km),
            work=attention_work(bb, lq, lk, HIDDEN, (q, k, v, bias), (q,)),
            library_fn=lambda: sdpa(q, k, v, bias))
        check_attention_forward(f"fused_attention[phDOS {label}]", q, k, km,
                                bias, runs["fused_attention"][label])
        runs["fused_attention_bwd"][label] = compare(
            f"fused_attention_bwd[phDOS {label}]",
            lambda: fused_attention_bwd(q, k, v, bias, o, go, stats),
            lambda: attention_bwd_reference(q, k, v, bias, go), repeat=True,
            work=attention_work(bb, lq, lk, HIDDEN, (q, k, v, bias, o, go),
                                (q, k, v), True),
            library_fn=sdpa_backward(q, k, v, bias, go))
        check_attention_backward(
            f"fused_attention_bwd[phDOS {label}]", q, k, bias, o, go, stats,
            fused_attention_bwd(q, k, v, bias, o, go, stats),
            runs["fused_attention_bwd"][label])
    return {name: per_forward(r) for name, r in runs.items()}


def phase_phdos_serving(workdir):
    """9: a seeded flagship DOSTransformerPhDOS saved with torch.save and
    served through main_predict --task phdos (96 samples) and
    Predictor.predict (5); no clamp, so outputs may be negative."""
    model = build_model("phdos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN, generator=torch.Generator().manual_seed(0))
    weights = os.path.join(workdir, "phdos_flagship.pt")
    torch.save(model.state_dict(), weights)
    requests = {"96": synthetic_phdos_samples(96, seed=0),
                "5 (short batch)": synthetic_phdos_samples(5, seed=1)}
    path = os.path.join(workdir, "phdos_request_96.npz")
    save_samples(path, requests["96"])
    kw = dict(task="phdos", example=requests["96"][0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=HIDDEN, batch_size=BATCH)
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False, **kw)
    cpu = Predictor.from_torch(weights, device="cpu", **kw)
    check(not gpu.clamp, "the phDOS predictor clamps")

    reset_launches()
    outputs = {}
    for label, samples in requests.items():
        before = read_launches()
        if label == "96":
            out_path = os.path.join(workdir, "phdos_preds_96.npz")
            main_predict.main([
                "--task", "phdos", "--torch_state_dict", weights,
                "--input", path, "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
                check(list(z["sample_id"]) == [s.sample_id for s in samples],
                      "phDOS CLI output sample_id order")
            n, how = graph_forwards(samples), "graph-served forwards"
        else:
            dos = gpu.predict(samples)
            n, how = expected_batches(samples), "batches"
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = dict.fromkeys(got, 0)
        want.update(fused_mp_edge=LAYERS * n, fused_attention=3 * T_LAYERS * n,
                    batched_segment_sum=LAYERS * n)
        print(f"phDOS request {label}: {n} {how}, launches {got}")
        check(got == want, f"phDOS request {label}: launches {got}, expected "
                           f"{want}")
        check(dos.shape == (len(samples), PH_BINS),
              f"phDOS {label}: shape {dos.shape}")
        check(bool(np.isfinite(dos).all()), f"phDOS {label}: non-finite")
        outputs[label] = dos
    launches = read_launches()
    print(f"phDOS serving path: launches {launches}; outputs below 0 (no "
          f"clamp): {int((outputs['96'] < 0).sum())} of {outputs['96'].size}")

    served = dict(kw=kw, weights=weights, requests=requests,
                  request_path=path, outputs=outputs, gpu=gpu, bins=PH_BINS)
    return (launches, check_served(gpu, cpu, requests, outputs, "phDOS "),
            served)


def phase_phdos_training(workdir, env=None):
    """10: cli.main_phdos at the full width, batch 8, 3 epochs; then one
    epoch at the CLI's default batch size 1. With ``env`` (14: the
    LayerNorm levers in the environment) the batch-8 run only. Returns (the
    launches of the runs together, the batch-8 run's epoch losses)."""
    want_train = step_launches("phdos", bool(env))
    width = ["--layers", str(LAYERS), "--transformer", str(T_LAYERS),
             "--hidden", str(HIDDEN), "--device", "cuda"]
    totals = launch_counts()
    runs = (("batch 8", 96, 3, BATCH), ("batch 1", 24, 1, 1))
    batch8_losses = None
    for label, n, epochs, batch in runs[:1] if env else runs:
        label += " (both levers)" if env else ""
        run_dir = os.path.join(workdir, f"phdos_b{batch}")
        log = os.path.join(run_dir, "train.jsonl")
        argv = ["--synthetic", str(n), "--synthetic_learnable", "--epochs",
                str(epochs), "--eval", "1", *width, "--results_dir", run_dir,
                "--log_jsonl", log]
        if batch != 1:  # batch 1 is main_phdos's default
            argv += ["--batch_size", str(batch)]
        os.makedirs(run_dir)
        result, per_call, launches = run_counted(main_phdos, argv, env)
        n_train = len(edos_random_split(range(n))[0])  # main_phdos's split
        losses = check_training_run(f"phDOS training path ({label})", result,
                                    per_call, want_train,
                                    epochs * math.ceil(n_train / batch), log,
                                    run_dir, epochs)
        print(f"phDOS training path ({label}): launches {launches}")
        for k, v in launches.items():
            totals[k] += v
        if batch == BATCH:
            batch8_losses = losses
    return totals, batch8_losses


# --- the LayerNorm levers of the transformer layer ------------------------


def phase_attention_ln_kernel(dev):
    """3e: the LN-fused attention forward against its plain version, beside
    the unfused layer's composition and the library yardstick."""
    g = torch.Generator().manual_seed(6)
    lns = (torch.rand(HIDDEN, generator=g) + 0.5).to(dev)
    lnb = (torch.randn(HIDDEN, generator=g) * 0.1).to(dev)
    ln = lambda t: F.layer_norm(t, (HIDDEN,), lns, lnb, 1e-5)

    def run(label, bb, lq, lk, tensors, mean=0.5, timed=True):
        """tensors: 'kv' (keys and values one tensor, as the model calls
        it), 'one' (queries too) or 'three' (all distinct). Inputs are
        randn * 2 + ``mean``. f32 against the plain version within
        KERNEL_RTOL, with two copies of the keys bit for bit; the same
        inputs as bf16 within ATTN_BF16_RTOL, and timed (``ms_bf16``)."""
        rand = lambda *s: (torch.randn(*s, generator=g) * 2 + mean).to(dev)
        x = rand(bb, lq, HIDDEN)
        xk = x if tensors == "one" else rand(bb, lk, HIDDEN)
        xv = rand(bb, lk, HIDDEN) if tensors == "three" else xk
        km = None
        if lk != lq:  # atom keys: pad atoms masked, last graph all masked
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
            km[-1] = False
            km = km.to(dev)
        bias = (key_bias(km) if km is not None
                else torch.zeros(bb, lk, device=dev))

        def norms():  # one LayerNorm per distinct tensor, as the layer does
            q = ln(x)
            k = q if xk is x else ln(xk)
            return q, k, (k if xv is xk else ln(xv))

        print(f"fused_attention_ln {label}: B={bb} Lq={lq} Lk={lk} D={HIDDEN}"
              f", {tensors}, input mean {mean}"
              f"{', last graph fully masked' if km is not None else ''}")
        rows = bb * (lq + {"one": 0, "kv": lk, "three": 2 * lk}[tensors])
        work = (nbytes(x, xk, xv, lns, lnb, bias) + nbytes(x),
                4 * bb * lq * lk * HIDDEN + 8 * rows * HIDDEN)
        name = f"fused_attention_ln[{label}]"
        if not timed:  # correctness only
            got = fused_attention_ln(x, xk, xv, lns, lnb, km)
            want = ln_attention_reference(x, xk, xv, lns, lnb, km)
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            check(bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale,
                  f"{name}: max abs err {err:.3e} > {KERNEL_RTOL} x {scale:.3g}")
            print(f"  {name}: max abs err {err:.3e}, rel {err / scale:.3e}")
            out = {"err": err, "rel": err / scale}
        else:
            out = compare(
                name, lambda: fused_attention_ln(x, xk, xv, lns, lnb, km),
                lambda: ln_attention_reference(x, xk, xv, lns, lnb, km),
                work=work, library_fn=lambda: sdpa(*norms(), bias))
            out["unfused_ms"] = median_ms(
                lambda: fused_attention(*norms(), km))
            print(f"  unfused layer (F.layer_norm per distinct tensor + the "
                  f"attention kernel): {out['unfused_ms']:.4f} ms")
        if xv is xk and xk is not x:  # one tensor or two copies: same bits
            check(torch.equal(fused_attention_ln(x, xk, xk, lns, lnb, km),
                              fused_attention_ln(x, xk, xk.clone(), lns, lnb,
                                                 km)),
                  f"{name}: x_v is x_k differs from two copies")
        # the same inputs as bf16 operands
        xb = x.bfloat16()
        xkb = xb if xk is x else xk.bfloat16()
        xvb = xkb if xv is xk else xv.bfloat16()
        got = fused_attention_ln(xb, xkb, xvb, lns, lnb, km)
        want = ln_attention_reference(xb, xkb, xvb, lns, lnb, km)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
              and err <= ATTN_BF16_RTOL * scale,
              f"{name}: bf16 max abs err {err:.3e} > {ATTN_BF16_RTOL} x "
              f"{scale:.3g}")
        out["bf16_rel_err"] = err / scale
        line = f"  bf16 operands: rel err {err / scale:.3e} (tol {ATTN_BF16_RTOL})"
        if timed:
            out["ms_bf16"] = median_ms(
                lambda: fused_attention_ln(xb, xkb, xvb, lns, lnb, km))
            line += f", {out['ms_bf16']:.4f} ms"
        print(line)
        return out

    edos = {label: run(label, *shape, "kv")
            for label, shape in attention_shapes().items()}
    phdos = {label: run(f"phDOS {label}", *shape, "kv")
             for label, shape in phdos_attention_shapes().items()}
    extra = {"self, one tensor": run("self, one tensor", 2 * BATCH, BINS,
                                     BINS, "one"),
             "cross, three tensors": run("cross, three tensors", BATCH, BINS,
                                         32, "three")}
    # inputs whose mean is 25 standard deviations: the statistics must not
    # cancel (correctness only)
    large = [run(f"{label}, mean 50", *shape, "kv", mean=50.0, timed=False)
             for label, shape in attention_shapes().items()]
    out, out_ph = per_forward(edos), per_forward(phdos)
    for agg, runs in ((out, edos), (out_ph, phdos)):
        for key in ("unfused_ms", "ms_bf16"):
            agg[key] = statistics.mean(r[key] for r in runs.values())
        for label, r in runs.items():
            agg["by_shape"][label].update(unfused_ms=r["unfused_ms"],
                                          ms_bf16=r["ms_bf16"])
            check(r["ms"] < r["unfused_ms"],
                  f"fused_attention_ln[{label}] {r['ms']:.4f} ms is not under "
                  f"the unfused layer's {r['unfused_ms']:.4f} ms")
    out["err"] = max([out["err"]] + [r["err"] for r in extra.values()]
                     + [r["err"] for r in large])
    out["bf16_max_rel_err"] = max(
        r["bf16_rel_err"] for r in (*edos.values(), *phdos.values(),
                                    *extra.values(), *large))
    out["ms_other_aliasing"] = {k: r["ms"] for k, r in extra.items()}
    return {"fused_attention_ln": out}, {"fused_attention_ln": out_ph}


def phase_layer_norm_bwd_kernel(dev):
    """3f: the LayerNorm backward against its plain version: at 256 columns
    at the row counts of a train step, f32 and bf16 operands (the ten timed
    cases), both operand forms, beside aten.native_layer_norm_backward on
    the same rows; then at widths 48, 600 and 1,024 and at a width that is
    no multiple of the 16-byte vector (50), both forms and both dtypes."""
    g = torch.Generator().manual_seed(7)
    row_counts = {"8*201": BATCH * BINS, "16*201": 2 * BATCH * BINS,
                  "8*32": BATCH * 32, "16*51": 2 * BATCH * PH_BINS,
                  "8*16": BATCH * 16}
    lib = kernels.library()

    def operands(rows, d, dtype):
        scale = (torch.rand(d, generator=g) + 0.5).to(dev)
        x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dev, dtype)
        dy = torch.randn(rows, d, generator=g).to(dev, dtype)
        _, mean, rstd = torch.native_layer_norm(
            x.float(), (d,), scale, torch.zeros(d, device=dev), 1e-5)
        return x, dy, scale, mean, rstd, ((x.float() - mean) * rstd).to(dtype)

    def plan_matches(rows, d, bf16):
        """The wrapper's copy of the partition against the library's."""
        got = [ctypes.c_int() for _ in range(5)]
        lib.dostpu_layer_norm_bwd_plan(rows, d, int(bf16), *got)
        p = ln_bwd_plan(rows, d, bf16)
        want = [int(p["vector_form"]), p["slabs"], p["cluster"],
                p["rows_per_rank"], p["grid"]]
        check([v.value for v in got] == want,
              f"ln_bwd_plan({rows}, {d}, bf16={bf16}) = {want}, the library "
              f"says {[v.value for v in got]}")
        return p

    runs = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        f32 = dtype == torch.float32
        rtols = ((KERNEL_RTOL, PARAM_GRAD_RTOL, PARAM_GRAD_RTOL)
                 if f32 else (BF16_RTOL,) * 3)
        floor = 1.0 if f32 else 1e-3
        d = HIDDEN
        for label, rows in row_counts.items():
            x, dy, scale, mean, rstd, xhat = operands(rows, d, dtype)
            # the library call's own operands: parameters in x's dtype
            w_lib, b_lib = scale.to(dtype), torch.zeros(d, device=dev,
                                                        dtype=dtype)
            _, mean_lib, rstd_lib = torch.native_layer_norm(x, (d,), w_lib,
                                                            b_lib, 1e-5)
            p = plan_matches(rows, d, not f32)
            print(f"layer_norm_bwd {name} rows={label} D={d}: "
                  f"{p['slabs']} column slabs x {p['cluster']} blocks, "
                  f"{p['grid']} blocks in all")
            before = layer_norm_bwd.launches
            runs[name, label] = compare(
                f"layer_norm_bwd[{name}, {label}]",
                lambda: layer_norm_bwd(xhat, rstd, scale, dy),
                lambda: ln_bwd_reference(xhat, rstd, scale, dy),
                rtols=rtols, floor=floor, repeat=True,
                work=(nbytes(xhat, dy, rstd, scale) + nbytes(dy)
                      + 2 * d * 4, 11 * rows * d),
                library_fn=lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [d], mean_lib, rstd_lib, w_lib, b_lib,
                    [True, True, True]))
            # compare() ran the kernel 2 + 5 + 50 times: one launch a call
            check(layer_norm_bwd.launches == before + 57,
                  "layer_norm_bwd counts more than one launch a call")
            raw = compare(
                f"layer_norm_bwd[{name}, {label}, x with mean and rstd]",
                lambda: layer_norm_bwd(x, rstd, scale, dy, mean),
                lambda: ln_bwd_reference(x, rstd, scale, dy, mean),
                rtols=rtols, floor=floor, repeat=True)
            runs[name, label]["ms_raw_form"] = raw["ms"]
            runs[name, label]["err"] = max(runs[name, label]["err"],
                                           raw["err"])
            runs[name, label]["rel"] = max(runs[name, label]["rel"],
                                           raw["rel"])
        # other widths, untimed: small and ragged, wide, and scalar-form
        for d in (48, 600, 1024, 50):
            for rows in (7, 2 * BATCH * BINS):
                x, dy, scale, mean, rstd, xhat = operands(rows, d, dtype)
                p = plan_matches(rows, d, not f32)
                for form, xin, m in (("xhat", xhat, None), ("x", x, mean)):
                    got = layer_norm_bwd(xin, rstd, scale, dy, m)
                    again = layer_norm_bwd(xin, rstd, scale, dy, m)
                    want = ln_bwd_reference(xin, rstd, scale, dy, m)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"layer_norm_bwd[{name}, {rows} x {d}, {form}]: a "
                          f"second run differs")
                    worst = 0.0
                    for a, b, tol in zip(got, want, rtols):
                        err = (a.float() - b.float()).abs().max().item()
                        lim = max(floor, b.float().abs().max().item())
                        check(bool(torch.isfinite(a).all())
                              and err <= tol * lim,
                              f"layer_norm_bwd[{name}, {rows} x {d}, {form}]:"
                              f" max abs err {err:.3e} > {tol} x {lim:.3g}")
                        worst = max(worst, err / lim)
                    runs.setdefault((name, "widths"), {"rel": 0.0})
                    runs[name, "widths"]["rel"] = max(
                        runs[name, "widths"]["rel"], worst)
                print(f"layer_norm_bwd {name} {rows} x {d} "
                      f"({'vector' if p['vector_form'] else 'scalar'} form, "
                      f"{p['slabs']} slabs x {p['cluster']}): both operand "
                      f"forms within tolerance, bit-identical second runs")
    # the row of the kernels line: f32 at the largest row count of a step
    timed = {k: r for k, r in runs.items() if k[1] != "widths"}
    out = dict(runs["f32", "16*201"],
               err=max(r["err"] for (n, _), r in timed.items() if n == "f32"),
               rel=max(max(r["rel"] for (n, _), r in timed.items()
                           if n == "f32"), runs["f32", "widths"]["rel"]))
    out["ms_by_rows"] = {f"{n} {label}": r["ms"]
                         for (n, label), r in timed.items()}
    out["ms_raw_form_by_rows"] = {f"{n} {label}": r["ms_raw_form"]
                                  for (n, label), r in timed.items()}
    out["library_ms_by_rows"] = {f"{n} {label}": r["library_ms"]
                                 for (n, label), r in timed.items()}
    out["bf16_max_rel_err"] = max(r["rel"] for (n, _), r in runs.items()
                                  if n == "bf16")
    for (n, label), r in timed.items():
        check(r["ms"] < r["library_ms"],
              f"layer_norm_bwd[{n}, {label}] {r['ms']:.4f} ms is not under "
              f"native_layer_norm_backward's {r['library_ms']:.4f} ms")
    return {"layer_norm_bwd": out}


def phase_fused_serving(task, served, workdir):
    """13: the serving path with fuse_ln_attn: the 96-sample request through
    cli.main_predict with DOSTPU_FUSE_LN_ATTN=1 in its environment, 5
    samples through Predictor(fuse_ln_attn=True). Returns (launches,
    {"fused": [samples/s, ...], "unfused": [...]}, six readings each)."""
    kw, weights, requests = served["kw"], served["weights"], served["requests"]
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False,
                               fuse_ln_attn=True, **kw)
    cpu = Predictor.from_torch(weights, device="cpu", fuse_ln_attn=True, **kw)
    reset_launches()
    for label in ("96", "5 (short batch)"):
        samples = requests[label]
        before = read_launches()
        if label == "96":
            out_path = os.path.join(workdir, f"{task}_fused_preds_96.npz")
            with_env(FUSE_ENV, main_predict.main, [
                "--task", task, "--torch_state_dict", weights,
                "--input", served["request_path"], "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
            n, how = graph_forwards(samples), "graph-served forwards"
        else:
            dos = gpu.predict(samples)
            n, how = expected_batches(samples), "batches"
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = serving_launches(task, n, fused=True)
        print(f"{task} fused request {label}: {n} {how}, launches {got}")
        check(got == want, f"{task} fused request {label}: launches {got}, "
                           f"expected {want}")
        check(dos.shape == (len(samples), served["bins"])
              and bool(np.isfinite(dos).all()),
              f"{task} fused {label}: shape {dos.shape} or non-finite")
        for what, ref in (("the CPU run", cpu.predict(samples)),
                          ("the unfused card run", served["outputs"][label])):
            err = float(np.abs(dos - ref).max())
            print(f"  vs {what}: max abs err {err:.3e} (atol {MODEL_ATOL} + "
                  f"rtol {MODEL_RTOL})")
            check(np.allclose(dos, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL),
                  f"{task} fused {label}: differs from {what} by {err:.3e}")
    launches = read_launches()
    # unfused, fused, fused, unfused, three times over: each reading the
    # median of 5 calls (the host's clock moves more than the levers do)
    order = (("unfused", served["gpu"]), ("fused", gpu), ("fused", gpu),
             ("unfused", served["gpu"])) * 3
    rates = {"fused": [], "unfused": []}
    for name, predictor in order:
        rates[name].append(serving_rate(predictor, requests["96"]))
    return launches, rates


def phase_lever_train_rates(task):
    """15: train samples/s with the levers off, ln_lp only and both on, in
    turns (off, lp, both, both, lp, off, twice over) in this process;
    returns the four readings of each setting."""
    settings = {"off": {}, "ln_lp": {"ln_lp": True},
                "both": {"ln_lp": True, "fuse_ln_attn": True}}
    rates = {name: [] for name in settings}
    for name in (*settings, *reversed(settings)) * 2:
        rates[name].append(phase_train_rate(task, **settings[name]))
    return rates


def phase_profile():
    """16b: where the device time goes: train steps and serving forwards of
    both flagships at batch 8, with the LayerNorm levers off and then with
    both on (the train step with the batch on the card, and the serving
    forward), and of the h1024 eDOS flagship in f32 and in bf16. First the wall time of every case without the profiler (host
    clock, synchronised at both ends; taken before torch.profiler runs at
    all, which slows every later launch), then each case under
    torch.profiler: the device time and the device activities per step or
    forward, the busy share (device time over that wall time) and the
    kernels by device time. Returns {case: {wall_ms, device_ms,
    activities}}."""
    from torch.profiler import ProfilerActivity, profile

    cases = []
    for task, hidden in (("edos", HIDDEN), ("phdos", HIDDEN), ("edos", WIDE)):
        learnable = (synthetic_edos_learnable if task == "edos"
                     else synthetic_phdos_learnable)
        clamp = task == "edos"
        batches = list(GraphLoader(learnable(96, seed=0), BATCH))[:8]
        on_card = [b.to("cuda") for b in batches]
        # (levers, compute dtype): h1024 with the levers off, f32 and bf16
        settings = ((({}, "float32"), ({}, "bfloat16")) if hidden == WIDE
                    else (({}, "float32"),
                          ({"fuse_ln_attn": True, "ln_lp": True}, "float32")))
        for levers, dtype in settings:
            model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                                hidden=hidden, device="cuda", dtype=dtype,
                                generator=torch.Generator().manual_seed(2),
                                **levers)
            trainer = Trainer(model, clamp_targets=clamp, eval_clamp=clamp)

            def forward(batch, model=model):
                model.eval()
                with torch.no_grad():
                    return model(batch)[2]

            runs = [("train step, batch on the card", trainer.train_step,
                     on_card),
                    ("serving forward, batch on the card", forward, on_card)]
            if not levers and hidden == HIDDEN:
                runs.insert(0, ("train step, host batch uploaded per step",
                                trainer.train_step, batches))
            name = task if hidden == HIDDEN else f"{task} h{hidden}"
            for label, fn, inputs in runs:
                for x in inputs[:3]:  # warm
                    fn(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for x in inputs:
                    fn(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / len(inputs) * 1e3
                cases.append((f"{name} {label}, levers "
                              f"{'both on' if levers else 'off'}"
                              + (", bf16" if dtype == "bfloat16" else ""),
                              fn, inputs, wall))

    print(f"profile, both flagships, batch {BATCH}, f32 (h1024 also bf16):")
    out = {}
    for label, fn, inputs, wall in cases:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                fn(x)
            torch.cuda.synchronize()
        by_name, ops = {}, 0
        for name, ms in device_events(prof):
            by_name[name] = by_name.get(name, 0.0) + ms / len(inputs)
            ops += 1
        device = sum(by_name.values())
        check(device > 0, f"{label}: the profile shows no device time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
        out[label] = {"wall_ms": wall, "device_ms": device,
                      "activities": ops / len(inputs)}
        print(f"  {label}: wall {wall:.3f} ms, device {device:.3f} ms over "
              f"{ops / len(inputs):.0f} device activities, busy "
              f"{100 * device / wall:.1f}%; by kernel (ms, share of device "
              f"time): " + "; ".join(f"{k} {v:.4f} ({100 * v / device:.1f}%)"
                                     for k, v in top))
    # what the levers add or take away, case by case
    for label, on in out.items():
        if not label.endswith("both on"):
            continue
        off = out[label.replace("both on", "off")]
        print(f"  {label} against off: wall {on['wall_ms'] - off['wall_ms']:+.3f}"
              f" ms, device {on['device_ms'] - off['device_ms']:+.3f} ms, "
              f"device activities {on['activities'] - off['activities']:+.0f}")
    return out


# --- every width: the attention kernels at any D, #2 from hidden 624 up,
# the h1024 eDOS flagship and the narrow phDOS path ------------------------

# feature widths the attention kernels are held at (untimed): below 32, odd,
# no multiple of 32, no multiple of 8, above 512 (sliced) and the h1024 width
WIDTHS = (1, 33, 48, 50, 200, 544, 1024)
# the h1024 eDOS flagship's hidden width (bench_configs.py's `h1024` row) and
# the narrow phDOS path's (no multiple of 4: 4-byte staging, odd stores)
WIDE, NARROW = 1024, 50


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(1.0, want.float().abs().max().item())


def phase_attention_widths(dev):
    """3g: kernels #3, #4 and #5 against their plain versions at every width
    of WIDTHS (B=3 Lq=37 Lk=29; all keys, 7 keys and no key attended): keys
    and values one tensor and two distinct tensors; the forward and the
    backward within KERNEL_RTOL, the backward bit-identical on a rerun and
    without the forward's statistics; #5 f32 within KERNEL_RTOL (keys and
    values one tensor and three tensors) and bf16 within ATTN_BF16_RTOL
    where D % 8 == 0. Then timed at the h1024 eDOS shapes (D = 1,024) and
    at the narrow phDOS path's (D = 50), each beside its bound, plain
    version and library call. Returns {kernel: {"d1024": ..., "d50": ...,
    "widths_rel_err": ...}}."""
    g = torch.Generator().manual_seed(8)
    worst = dict.fromkeys(("fused_attention", "fused_attention_bwd",
                           "fused_attention_ln"), 0.0)
    worst_bf16 = 0.0
    b, lq, lk = 3, 37, 29
    km = (torch.arange(lk)[None] < torch.tensor([[lk], [7], [0]])).to(dev)
    bias = key_bias(km)
    for d in WIDTHS:
        rand = lambda *s: torch.randn(*s, generator=g).to(dev)
        q, k, v, go = rand(b, lq, d), rand(b, lk, d), rand(b, lk, d), rand(
            b, lq, d)
        for vv in (k, v):  # one tensor, two tensors
            o, stats = fused_attention_fwd(q, k, vv, bias, want_stats=True)
            got = fused_attention_bwd(q, k, vv, bias, o, go, stats)
            want = attention_bwd_reference(q, k, vv, bias, go)
            errs = {"fused_attention": rel_err(
                        o, dot_product_attention(q, k, vv, km)),
                    "fused_attention_bwd": max(
                        rel_err(x, w) for x, w in zip(got, want))}
            for name, err in errs.items():
                check(err <= KERNEL_RTOL, f"{name} at D={d}: rel err "
                                          f"{err:.3e} > {KERNEL_RTOL}")
                worst[name] = max(worst[name], err)
            for other in (fused_attention_bwd(q, k, vv, bias, o, go, stats),
                          fused_attention_bwd(q, k, vv, bias, o, go)):
                check(all(torch.equal(x, y) for x, y in zip(got, other)),
                      f"fused_attention_bwd at D={d}: a rerun (with or "
                      f"without the forward's statistics) differs")
        lns = (torch.rand(d, generator=g) + 0.5).to(dev)
        lnb = (torch.randn(d, generator=g) * 0.1).to(dev)
        x, xk, xv = (t * 2 + 0.5 for t in (q, k, v))
        for args in ((x, xk, xk), (x, xk, xv)):
            err = rel_err(fused_attention_ln(*args, lns, lnb, km),
                          ln_attention_reference(*args, lns, lnb, km))
            check(err <= KERNEL_RTOL, f"fused_attention_ln at D={d}: rel "
                                      f"err {err:.3e} > {KERNEL_RTOL}")
            worst["fused_attention_ln"] = max(worst["fused_attention_ln"],
                                              err)
            if d % 8 == 0:
                argsb = tuple(t.bfloat16() for t in args)
                got = fused_attention_ln(*argsb, lns, lnb, km)
                err = rel_err(got, ln_attention_reference(*argsb, lns, lnb,
                                                          km))
                check(got.dtype == torch.bfloat16 and err <= ATTN_BF16_RTOL,
                      f"fused_attention_ln bf16 at D={d}: rel err {err:.3e}")
                worst_bf16 = max(worst_bf16, err)
        print(f"attention kernels at D={d} (B={b} Lq={lq} Lk={lk}, plan "
              f"{attention_plan(d)}): #3, #4 and #5 within {KERNEL_RTOL} rel"
              f" of the plain versions with keys and values one tensor and "
              f"two; #4 bit-identical on reruns"
              f"{'; #5 bf16 within ' + str(ATTN_BF16_RTOL) if d % 8 == 0 else ''}")
    print(f"widths {WIDTHS}: worst rel err {json.dumps(worst)}, #5 bf16 "
          f"{worst_bf16:.3e}")
    out = {name: {"widths_rel_err": err} for name, err in worst.items()}
    out["fused_attention_ln"]["widths_bf16_rel_err"] = worst_bf16
    for d, shapes in ((WIDE, attention_shapes()),
                      (NARROW, phdos_attention_shapes())):
        for name, r in timed_attention_at(dev, d, shapes, g).items():
            out[name][f"d{d}"] = r
    return out


def timed_attention_at(dev, d, shapes, g):
    """Kernels #3, #4 and #5 (f32) at feature width d at the three stacks'
    shapes (keys and values one tensor, pad atoms masked, the last graph
    fully masked), each against its plain version, timed beside its bound
    and its library call (SDPA, SDPA's backward, F.layer_norm + SDPA)."""
    runs = {"fused_attention": {}, "fused_attention_bwd": {},
            "fused_attention_ln": {}}
    lns = (torch.rand(d, generator=g) + 0.5).to(dev)
    lnb = (torch.randn(d, generator=g) * 0.1).to(dev)
    for label, (bb, lq, lk) in shapes.items():
        rand = lambda *s: torch.randn(*s, generator=g).to(dev)
        q, k, go = rand(bb, lq, d), rand(bb, lk, d), rand(bb, lq, d)
        km = torch.ones(bb, lk, dtype=torch.bool)
        if lk != lq:
            km = torch.arange(lk)[None] < torch.randint(4, lk + 1, (bb, 1),
                                                        generator=g)
        km[-1] = False
        km = km.to(dev)
        bias = key_bias(km)
        print(f"attention at D={d} {label}: B={bb} Lq={lq} Lk={lk} (last "
              f"graph fully masked)")
        runs["fused_attention"][label] = compare(
            f"fused_attention[D={d} {label}]",
            lambda: fused_attention_fwd(q, k, k, bias)[0],
            lambda: dot_product_attention(q, k, k, km),
            work=attention_work(bb, lq, lk, d, (q, k, bias), (q,)),
            library_fn=lambda: sdpa(q, k, k, bias))
        o, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
        runs["fused_attention_bwd"][label] = compare(
            f"fused_attention_bwd[D={d} {label}]",
            lambda: fused_attention_bwd(q, k, k, bias, o, go, stats),
            lambda: attention_bwd_reference(q, k, k, bias, go), repeat=True,
            work=attention_work(bb, lq, lk, d, (q, k, bias, o, go), (q, k, k),
                                True),
            library_fn=sdpa_backward(q, k, k, bias, go))
        x, xk = q * 2 + 0.5, k * 2 + 0.5
        ln = lambda t: F.layer_norm(t, (d,), lns, lnb, 1e-5)
        rows = bb * (lq + lk)
        runs["fused_attention_ln"][label] = compare(
            f"fused_attention_ln[D={d} {label}]",
            lambda: fused_attention_ln(x, xk, xk, lns, lnb, km),
            lambda: ln_attention_reference(x, xk, xk, lns, lnb, km),
            work=(nbytes(x, xk, lns, lnb, bias) + nbytes(x),
                  4 * bb * lq * lk * d + 8 * rows * d),
            library_fn=lambda: sdpa(ln(x), ln(xk), ln(xk), bias))
    return {name: per_forward(r) for name, r in runs.items()}


def phase_wide_mp(dev):
    """3h: kernels #1 and #2 at the h1024 eDOS widths (B=8 A=32 E=384,
    M = 2,048, H = 1,024: the forward's tensor-core form, the backward's in
    a cluster of four) and #2 at hidden 624 and 1,000 (the generic form,
    xhat in scratch), each against its plain version (a dummy graph,
    nonzero upstream gradients), bit-identical on a rerun, timed beside its
    bound, with the form and tile taken. Returns {kernel: {label: row}}."""
    g = torch.Generator().manual_seed(9)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    b, a, e = BATCH, 32, 384
    out = {"fused_mp_edge": {}, "fused_mp_edge_bwd": {}}
    for h in (WIDE, 624, 1000):
        m = 2 * h
        idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                    dtype=torch.int32).to(dev)
        mask = (torch.rand(b, e, generator=g) > 0.25).float()
        mask[-1] = 0.0
        args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
                mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
                torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5)
        label = f"B={b} A={a} E={e} M={m} H={h}"
        print(f"message passing at hidden {h}: {label}")
        if h == WIDE:
            out["fused_mp_edge"][f"H={h}"] = compare_mp(
                label, args + (rand(h) * 0.1,), False)
        out["fused_mp_edge_bwd"][f"H={h}"] = compare_mp(
            label, args + (rand(b, e, h), rand(b, a, h)), True)
    return out


def serving_readings(predictor, samples, calls: int = 5) -> list:
    """Samples/s of each of ``calls`` calls of one request, after a warm
    one."""
    predictor.predict(samples)
    readings = []
    for _ in range(calls):
        t0 = time.perf_counter()
        predictor.predict(samples)
        readings.append(len(samples) / (time.perf_counter() - t0))
    return readings


def phase_h1024_serving(workdir):
    """17: the h1024 eDOS flagship (hidden 1,024, 3 processors, 2 layers per
    stack, 201 bins, f32, batch 8; random weights from a seed) saved with
    torch.save and served through cli.main_predict (96 samples) and
    Predictor.predict (5): exactly 3 fused_mp_edge and 6 fused_attention
    launches per batch, no other; outputs [N, 201], finite and >= 0; the
    5-sample request against the same model on the CPU. Returns (launches,
    samples/s readings of the 96-sample request)."""
    model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS, hidden=WIDE,
                        generator=torch.Generator().manual_seed(0))
    weights = os.path.join(workdir, "edos_h1024.pt")
    torch.save(model.state_dict(), weights)
    requests = {"96": synthetic_edos_samples(96, seed=0),
                "5 (short batch)": synthetic_edos_samples(5, seed=1)}
    path = os.path.join(workdir, "request_96.npz")
    save_samples(path, requests["96"])
    kw = dict(task="edos", example=requests["96"][0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=WIDE, batch_size=BATCH)
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False, **kw)
    cpu = Predictor.from_torch(weights, device="cpu", **kw)
    reset_launches()
    outputs = {}
    for label, samples in requests.items():
        before = read_launches()
        if label == "96":
            out_path = os.path.join(workdir, "preds_96.npz")
            main_predict.main([
                "--task", "edos", "--torch_state_dict", weights,
                "--input", path, "--output", out_path,
                "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                "--hidden", str(WIDE), "--batch_size", str(BATCH),
                "--device", "cuda"])
            with np.load(out_path) as z:
                dos = z["dos"]
            n, how = graph_forwards(samples), "graph-served forwards"
        else:
            dos = gpu.predict(samples)
            n, how = expected_batches(samples), "batches"
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = serving_launches("edos", n)
        print(f"h1024 request {label}: {n} {how}, launches {got}")
        check(got == want, f"h1024 request {label}: launches {got}, "
                           f"expected {want}")
        check_dos(f"h1024 {label}", dos, len(samples))
        outputs[label] = dos
    launches = read_launches()
    ref = cpu.predict(requests["5 (short batch)"])
    err = float(np.abs(outputs["5 (short batch)"] - ref).max())
    print(f"h1024 request 5: card vs CPU plain max abs err {err:.3e} (atol "
          f"{MODEL_ATOL} + rtol {MODEL_RTOL})")
    check(np.allclose(outputs["5 (short batch)"], ref, atol=MODEL_ATOL,
                      rtol=MODEL_RTOL), f"h1024: card differs from the CPU "
                                        f"by {err:.3e}")
    return launches, serving_readings(gpu, requests["96"])


def phase_h1024_training(workdir):
    """18: cli.main_edos --hidden 1024 at batch 8 on 24 learnable samples,
    one epoch (3 train steps) and its eval: exact launch counts per step.
    Returns the run's launches."""
    log = os.path.join(workdir, "train.jsonl")
    result, per_call, launches = run_counted(main_edos, [
        "--synthetic", "24", "--synthetic_learnable", "--epochs", "1",
        "--eval", "1", "--layers", str(LAYERS), "--transformer",
        str(T_LAYERS), "--hidden", str(WIDE), "--batch_size", str(BATCH),
        "--device", "cuda", "--results_dir", workdir, "--log_jsonl", log])
    n_train = len(edos_random_split(range(24))[0])
    check_training_run("h1024 eDOS training path", result, per_call,
                       step_launches("edos", False),
                       math.ceil(n_train / BATCH), log, workdir, 1,
                       hidden=WIDE)
    print(f"h1024 eDOS training path: launches {launches}")
    return launches


def phase_h1024_levers():
    """19b: one h1024 train step at batch 8 with both LayerNorm levers and
    one without, from one seed on one batch: the levers' launches exactly
    (6 fused_attention_ln, 20 layer_norm_bwd, no fused_attention), the
    losses within LOSS_RTOL. Returns the lever step's launches."""
    batch = next(iter(GraphLoader(synthetic_edos_learnable(8, seed=5),
                                  BATCH)))
    losses, counts = {}, {}
    for name, levers in (("off", {}),
                         ("both", {"fuse_ln_attn": True, "ln_lp": True})):
        model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS,
                            hidden=WIDE, device="cuda",
                            generator=torch.Generator().manual_seed(3),
                            **levers)
        trainer = Trainer(model, clamp_targets=True, eval_clamp=True)
        reset_launches()
        losses[name] = trainer.train_step(batch)["loss"].item()
        counts[name] = read_launches()
        want = step_launches("edos", bool(levers))
        check(counts[name] == want, f"h1024 train step, levers {name}: "
                                    f"launches {counts[name]}, expected {want}")
    print(f"h1024 train step, loss with both levers {losses['both']:.7f}, "
          f"levers off {losses['off']:.7f} (rtol {LOSS_RTOL}); launches "
          f"{counts['both']}")
    check(abs(losses["both"] - losses["off"]) <= LOSS_RTOL * abs(
        losses["off"]), f"h1024: the lever step's loss {losses['both']} "
                        f"differs from {losses['off']}")
    return counts["both"]


def phase_narrow_phdos(workdir):
    """20: the narrow phDOS path, hidden 50 (3 processors, 2 layers per
    stack): 5 samples served through Predictor.predict (3 fused_mp_edge, 3
    batched_segment_sum and 6 fused_attention launches per batch, against
    the CPU), then 3 train steps card against CPU as phase 11 (losses,
    first-step gradients), their launches exactly 3 times a step's.
    Returns (serving launches, training launches)."""
    model = build_model("phdos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=NARROW,
                        generator=torch.Generator().manual_seed(0))
    weights = os.path.join(workdir, "phdos_h50.pt")
    torch.save(model.state_dict(), weights)
    samples = synthetic_phdos_samples(5, seed=1)
    kw = dict(task="phdos", example=samples[0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=NARROW, batch_size=BATCH)
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False, **kw)
    cpu = Predictor.from_torch(weights, device="cpu", **kw)
    reset_launches()
    dos = gpu.predict(samples)
    serving = read_launches()
    n = expected_batches(samples)
    want = launch_counts(fused_mp_edge=LAYERS * n,
                         fused_attention=3 * T_LAYERS * n,
                         batched_segment_sum=LAYERS * n)
    check(serving == want, f"phDOS hidden 50 serving: launches {serving}, "
                           f"expected {want}")
    ref = cpu.predict(samples)
    err = float(np.abs(dos - ref).max())
    print(f"phDOS hidden {NARROW}, 5 samples: launches {serving}; card vs "
          f"CPU max abs err {err:.3e}")
    check(dos.shape == (5, PH_BINS) and bool(np.isfinite(dos).all())
          and np.allclose(dos, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL),
          f"phDOS hidden {NARROW}: card differs from the CPU by {err:.3e}")
    print(f"card vs CPU, 3 phDOS train steps at hidden {NARROW}:")
    reset_launches()
    phase_card_vs_cpu("phdos", hidden=NARROW)
    training = read_launches()
    want = {k: 3 * v for k, v in step_launches("phdos", False).items()}
    check(training == want, f"phDOS hidden 50 training: launches {training},"
                            f" expected {want}")
    return serving, training


# --- the training runtime (checkpoints, resume, best/, the device-resident
# datasets, remat, clipping and schedules, artifacts, TensorBoard) ---------

# the widths whose blocks the first generic designs of #1 and #2 could not
# hold (no tensor-core block fits them either)
REPAIRED = (1040, 1050, 2080)


def phase_repaired_mp(dev):
    """21: kernels #1 and #2 at hidden 1,040, 1,050 and 2,080 (M = 2H; B=8
    A=32 E=384, a dummy graph, nonzero upstream gradients), where both take
    the generic forms, whose blocks no longer grow with the widths: each
    against its plain version, bit-identical on a rerun, timed beside its
    bound. Returns {kernel: {label: row}}."""
    g = torch.Generator().manual_seed(21)
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    b, a, e = BATCH, 32, 384
    out = {"fused_mp_edge": {}, "fused_mp_edge_bwd": {}}
    for h in REPAIRED:
        m = 2 * h
        check(fused_mp_form(m, h) == fused_mp_bwd_form(m, h) == FORM_GENERIC,
              f"hidden {h}: expected the generic forms")
        idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                    dtype=torch.int32).to(dev)
        mask = (torch.rand(b, e, generator=g) > 0.25).float()
        mask[-1] = 0.0
        args = (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
                mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
                torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5)
        label = f"B={b} A={a} E={e} M={m} H={h}"
        print(f"message passing at hidden {h} (repaired): {label}")
        lib = kernels.library()
        for backward, name in ((False, "fused_mp_edge"),
                               (True, "fused_mp_edge_bwd")):
            more = ((rand(b, e, h), rand(b, a, h)) if backward
                    else (rand(h) * 0.1,))
            row = compare_mp(label, args + more, backward)
            smem = (lib.dostpu_fused_mp_edge_bwd_smem_bytes if backward
                    else lib.dostpu_fused_mp_edge_smem_bytes)(b, e, m, h, -1)
            row["smem_bytes"] = smem
            print(f"  {name}[H={h}]: {smem} B of shared memory a block")
            out[name][f"H={h}"] = row
    return out


def edos_run_argv(workdir, epochs, n=48, extra=()):
    return ["--synthetic", str(n), "--synthetic_learnable", "--epochs",
            str(epochs), "--eval", "1", "--layers", str(LAYERS),
            "--transformer", str(T_LAYERS), "--hidden", str(HIDDEN),
            "--batch_size", str(BATCH), "--device", "cuda",
            "--results_dir", workdir, "--log_jsonl",
            os.path.join(workdir, "train.jsonl"), *extra]


def logged_losses(workdir) -> list:
    with open(os.path.join(workdir, "train.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if '"loss"' in line]


def phase_host_loader(workdir):
    """6b: cli.main_edos with --host_loader (batches collated on the host
    and uploaded per step; the device dataset is the default now): one
    epoch of 96 learnable samples, exact launch counts per train step and
    eval batch. Returns the run's launches."""
    argv = edos_run_argv(workdir, 1, n=96, extra=["--host_loader"])
    result, per_call, launches = run_counted(main_edos, argv)
    n_train = len(edos_random_split(range(96))[0])
    check_training_run("eDOS training path (--host_loader)", result, per_call,
                       step_launches("edos", False),
                       math.ceil(n_train / BATCH),
                       os.path.join(workdir, "train.jsonl"), workdir, 1)
    return launches


def phase_checkpoint_resume(workdir):
    """22: cli.main_edos at the flagship width with --checkpoint_dir
    --checkpoint_every 1: an uninterrupted 3-epoch run, and a run stopped
    after epoch 1 then resumed from its checkpoint to epoch 3, whose epoch
    losses and best metrics must equal the uninterrupted run's (the card's
    kernels repeat their bits; the data order is a function of (seed,
    epoch)); then cli.main_predict --checkpoint_dir serves best/ on the
    card, against the same checkpoint served on the CPU (atol 1e-3 + rtol
    1e-3). Returns (the launches of the three training runs, of the
    serving run)."""
    runs = {}
    totals = launch_counts()
    n_train = len(edos_random_split(range(48))[0])
    steps = math.ceil(n_train / BATCH)
    for name, epochs, ck in (("whole", 3, "ck_whole"), ("first", 1, "ck_cut"),
                             ("resumed", 3, "ck_cut")):
        run_dir = os.path.join(workdir, name)
        os.makedirs(run_dir)
        argv = edos_run_argv(run_dir, epochs, extra=[
            "--checkpoint_dir", os.path.join(workdir, ck),
            "--checkpoint_every", "1"])
        result, per_call, launches = run_counted(main_edos, argv)
        done = 1 if name == "resumed" else 0  # epochs the checkpoint holds
        check_training_run(f"eDOS checkpointed run ({name})", result,
                           per_call, step_launches("edos", False),
                           (epochs - done) * steps,
                           os.path.join(run_dir, "train.jsonl"), run_dir,
                           epochs - done)
        for k, v in launches.items():
            totals[k] += v
        runs[name] = (result, logged_losses(run_dir))
    whole, resumed = runs["whole"], runs["resumed"]
    cut = runs["first"][1] + resumed[1]
    diff = max(abs(a - b) for a, b in zip(whole[1], cut))
    print(f"epoch losses, uninterrupted {whole[1]}; stopped after epoch 1 and "
          f"resumed {cut}: max abs difference {diff:.3e}")
    check(len(cut) == len(whole[1]) and cut == whole[1],
          f"resumed losses {cut} differ from the uninterrupted {whole[1]}")
    for k in ("best_epoch", "best_valid_rmse", "best_valid_mae", "test"):
        check(resumed[0][k] == whole[0][k],
              f"resumed {k} {resumed[0][k]} differs from {whole[0][k]}")
    print(f"best epoch {whole[0]['best_epoch']}, best valid rmse "
          f"{whole[0]['best_valid_rmse']:.6f}: equal after the resume")

    ck = os.path.join(workdir, "ck_whole")
    samples = synthetic_edos_samples(20, seed=3)
    request = os.path.join(workdir, "request.npz")
    save_samples(request, samples)
    shape = ["--layers", str(LAYERS), "--transformer", str(T_LAYERS),
             "--hidden", str(HIDDEN), "--batch_size", str(BATCH)]
    out = os.path.join(workdir, "preds.npz")
    reset_launches()
    main_predict.main(["--task", "edos", "--checkpoint_dir", ck,
                       "--input", request, "--output", out, "--device",
                       "cuda", *shape])
    serving = read_launches()
    want = serving_launches("edos", graph_forwards(samples))
    check(serving == want, f"serving best/: launches {serving}, expected "
                           f"{want}")
    with np.load(out) as z:
        dos = z["dos"]
    check_dos("served from best/", dos, len(samples))
    cpu = Predictor.from_checkpoint(
        ck, task="edos", example=samples[0], layers=LAYERS, t_layers=T_LAYERS,
        hidden=HIDDEN, batch_size=BATCH, device="cpu").predict(samples)
    err = float(np.abs(dos - cpu).max())
    print(f"main_predict --checkpoint_dir (best/, epoch "
          f"{whole[0]['best_epoch']}): 20 samples, launches {serving}; card "
          f"vs CPU max abs err {err:.3e} (atol {MODEL_ATOL} + rtol "
          f"{MODEL_RTOL})")
    check(np.allclose(dos, cpu, atol=MODEL_ATOL, rtol=MODEL_RTOL),
          f"best/ served on the card differs from the CPU by {err:.3e}")
    return totals, serving


def remat_step_launches(task: str) -> dict:
    """A train step's launches with --remat: the forward's message-passing
    launches (and phDOS's edge counts) and attention launches once more, in
    the backward's recomputation."""
    want = step_launches(task, False)
    want["fused_mp_edge"] += LAYERS
    want["fused_attention"] += 3 * T_LAYERS
    if task == "phdos":
        want["batched_segment_sum"] += LAYERS
    return want


def phase_runtime_flags(workdir):
    """23: cli.main_phdos at the flagship width, batch 8, with --bucketed
    --bf16_data --remat --grad_clip 1 --warmup_epochs 1 --cosine_lr
    --tensorboard --export_preds: every train step launches the remat
    counts (3 + 3 + 6 forward, 3 + 3 + 6 again in the backward's
    recomputation, 3 + 6 backward), every eval batch the forward's; the
    TensorBoard file holds the loss and the metrics, the artifacts one row
    per test sample. Returns the run's launches."""
    tb = os.path.join(workdir, "tb")
    preds = os.path.join(workdir, "preds.npz")
    argv = ["--synthetic", "64", "--synthetic_learnable", "--epochs", "2",
            "--eval", "1", "--layers", str(LAYERS), "--transformer",
            str(T_LAYERS), "--hidden", str(HIDDEN), "--batch_size",
            str(BATCH), "--device", "cuda", "--results_dir", workdir,
            "--log_jsonl", os.path.join(workdir, "train.jsonl"),
            "--bucketed", "--bf16_data", "--remat", "--grad_clip", "1",
            "--warmup_epochs", "1", "--cosine_lr", "--tensorboard", tb,
            "--export_preds", preds]
    result, per_call, launches = run_counted(main_phdos, argv)
    train, _, test = edos_random_split(synthetic_phdos_learnable(64, seed=0))
    buckets = {}
    for s in train:
        buckets[bucket_size(s.n_nodes)] = buckets.get(
            bucket_size(s.n_nodes), 0) + 1
    steps = sum(math.ceil(n / BATCH) for n in buckets.values())
    want = remat_step_launches("phdos")
    # an eval batch records no gradient, so remat recomputes nothing there
    want_eval = dict(step_launches("phdos", False),
                     **dict.fromkeys(BACKWARD, 0))
    check_training_run("phDOS runtime flags (bucketed, bf16 data, remat, "
                       "clipping, warmup + cosine)", result, per_call, want,
                       2 * steps, os.path.join(workdir, "train.jsonl"),
                       workdir, 2, want_eval=want_eval)
    (event_file,) = os.listdir(tb)
    from dostransformer_tpu_torch.train.tensorboard import read_events

    tags = set()
    for _, scalars in read_events(os.path.join(tb, event_file)):
        tags |= set(scalars)
    check({"train/loss", "valid/rmse", "test/rmse"} <= tags,
          f"TensorBoard tags {sorted(tags)}")
    with np.load(preds) as z:
        n = z["sample_id"].shape[0]
        check(n == len(test) and z["preds"].shape == (n, PH_BINS)
              and z["embeddings"].shape == (n, HIDDEN)
              and bool(np.isfinite(z["preds"]).all()),
              f"artifacts: {n} rows for {len(test)} test samples")
    print(f"phDOS runtime flags: {len(buckets)} atom buckets "
          f"{dict(sorted(buckets.items()))}, {steps} steps an epoch; per "
          f"step {want}; TensorBoard tags {sorted(tags)}; {n} artifact rows")
    return launches


def phase_pipeline_rates():
    """24: train samples/s of the device-resident dataset against the host
    loader (collation and upload every step), eDOS and phDOS flagships at
    batch 8: one epoch of 96 learnable samples a reading, synchronised at
    both ends, four readings each taken in turns (host, device, device,
    host, ...) in one process after a warm epoch of each. A record, not a
    claim: the host clock moves between calls. Returns {task: {pipeline:
    readings}}."""
    from dostransformer_tpu_torch.train.device_dataset import DeviceDataset

    rates = {}
    for task, learnable in (("edos", synthetic_edos_learnable),
                            ("phdos", synthetic_phdos_learnable)):
        clamp = task == "edos"
        model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                            hidden=HIDDEN, device="cuda",
                            generator=torch.Generator().manual_seed(2))
        trainer = Trainer(model, clamp_targets=clamp, eval_clamp=clamp)
        samples = learnable(96, seed=0)
        loader = GraphLoader(samples, BATCH, shuffle=True, seed=0)
        data = DeviceDataset.from_samples(
            samples, BATCH, atoms_per_graph=loader.atoms_per_graph,
            edges_per_graph=loader.edges_per_graph, device="cuda")
        epoch = {"host": lambda: trainer.train_epoch(loader),
                 "device": lambda e: trainer.train_epoch_device(data, 0, e)}
        readings = {"host": [], "device": []}
        epoch["host"]()
        epoch["device"](0)
        for i, name in enumerate(["host", "device", "device", "host"] * 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = (epoch["host"]() if name == "host"
                      else epoch["device"](i + 1))
            torch.cuda.synchronize()
            readings[name].append(losses.numel() * BATCH
                                  / (time.perf_counter() - t0))
        rates[task] = readings
    return rates


# --- the baselines (queue 1 item 7) ----------------------------------------

BASELINES = ("graphnetwork", "graphnetwork2", "mlp", "mlp2")


def baseline_step_launches(task: str, name: str) -> dict:
    """Kernel launches of a baseline's train step: graphnetwork* one
    fused_mp_edge and one fused_mp_edge_bwd a processor (phDOS also one
    batched_segment_sum, its scatter-mean's edge count) and no attention;
    mlp* no kernel at all (no message passing, as in the JAX package)."""
    if not name.startswith("graphnetwork"):
        return launch_counts()
    return launch_counts(fused_mp_edge=LAYERS, fused_mp_edge_bwd=LAYERS,
                         batched_segment_sum=LAYERS if task == "phdos" else 0)


def phase_baselines():
    """25: each of the eight baseline families at hidden 256 (3 processors
    where the family has them, batch 8, f32), one seeded model on the card
    and on the CPU: the forward of 3 batches (the last short, with dummy
    graphs) within MODEL_ATOL + MODEL_RTOL; 3 Trainer.train_steps with each
    first-step gradient within BASELINE_GRAD_REL x max(1, its max abs) and
    every loss within LOSS_RTOL; the launches of every card train step exact
    (baseline_step_launches); then the training samples/s (10 steps at batch
    8 after 2 warm ones, host collation and upload included), a record.
    Returns {"task/name": samples/s}."""
    rates = {}
    for task in ("edos", "phdos"):
        learnable = (synthetic_edos_learnable if task == "edos"
                     else synthetic_phdos_learnable)
        clamp = task == "edos"
        batches = list(GraphLoader(learnable(21, seed=5), BATCH))
        rate_batches = list(GraphLoader(learnable(96, seed=0), BATCH))
        for name in BASELINES:
            label = f"{task} {name}"
            cpu_model = build_model(task, name, layers=LAYERS, hidden=HIDDEN,
                                    generator=torch.Generator().manual_seed(1))
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            worst = 0.0
            with torch.no_grad():
                for batch in batches:
                    want = model_outputs(cpu_model(batch))[0]
                    got = model_outputs(gpu_model(batch.to("cuda")))[0].cpu()
                    worst = max(worst, (got - want).abs().max().item())
                    check(torch.allclose(got, want, atol=MODEL_ATOL,
                                         rtol=MODEL_RTOL),
                          f"{label}: card forward differs from the CPU by "
                          f"{worst:.3e}")
            cpu = Trainer(cpu_model, clamp_targets=clamp, eval_clamp=clamp)
            gpu = Trainer(gpu_model, clamp_targets=clamp, eval_clamp=clamp)
            want_step = baseline_step_launches(task, name)
            losses, grad_err, grad_share = [], 0.0, 0.0
            for step, batch in enumerate(batches):
                lc = cpu.train_step(batch)["loss"].item()
                before = read_launches()
                lg = gpu.train_step(batch)["loss"].item()
                got_step = {k: v - before[k]
                            for k, v in read_launches().items()}
                check(got_step == want_step,
                      f"{label} step {step}: launches {got_step}, expected "
                      f"{want_step}")
                check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
                      f"{label} step {step}: card loss {lg} vs CPU {lc}")
                losses.append((lg, lc))
                if step:
                    continue
                for (pname, pc), pg in zip(cpu_model.named_parameters(),
                                           gpu_model.parameters()):
                    check((pc.grad is None) == (pg.grad is None),
                          f"{label}: {pname} has a gradient on one device "
                          f"only")
                    if pc.grad is None:  # its output is read by nothing
                        continue
                    err = (pg.grad.cpu() - pc.grad).abs().max().item()
                    limit = BASELINE_GRAD_REL * max(
                        1.0, pc.grad.abs().max().item())
                    grad_err = max(grad_err, err)
                    grad_share = max(grad_share, err / limit)
                    check(err <= limit,
                          f"{label}: first-step gradient of {pname} "
                          f"differs by {err:.3e} (limit {limit:.3e})")
            for batch in rate_batches[:2]:  # warm
                gpu.train_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(10):
                gpu.train_step(rate_batches[i % len(rate_batches)])
            torch.cuda.synchronize()
            rates[f"{task}/{name}"] = 10 * BATCH / (time.perf_counter() - t0)
            pairs = [(round(a, 7), round(b, 7)) for a, b in losses]
            nonzero = {k: v for k, v in want_step.items() if v}
            print(f"baseline {label}: forward card vs CPU max abs err "
                  f"{worst:.3e}; first-step gradients {grad_err:.3e} (at most "
                  f"{grad_share:.3f} of a tensor's limit); losses "
                  f"(card, CPU) {pairs}; launches a step {nonzero}; "
                  f"{rates[f'{task}/{name}']:.1f} training samples/s")
    return rates


def phase_baseline_paths(workdir):
    """25b: the baselines through the entry points on the card:
    cli.main_edos and cli.main_phdos --embedder graphnetwork (96 learnable
    samples, 2 epochs, batch 8, exact launches per train step and eval
    batch, the experiments_graphnetwork.txt block), then cli.main_predict
    --embedder mlp2 serving 96 eDOS samples (no kernel launched) against
    the same weights served on the CPU. Returns {path: launches}."""
    paths = {}
    for task, cli in (("edos", main_edos), ("phdos", main_phdos)):
        run_dir = os.path.join(workdir, f"{task}_graphnetwork")
        os.makedirs(run_dir)
        log = os.path.join(run_dir, "train.jsonl")
        argv = ["--embedder", "graphnetwork", "--synthetic", "96",
                "--synthetic_learnable", "--epochs", "2", "--eval", "1",
                "--layers", str(LAYERS), "--hidden", str(HIDDEN),
                "--batch_size", str(BATCH), "--device", "cuda",
                "--results_dir", run_dir, "--log_jsonl", log]
        result, per_call, launches = run_counted(cli, argv)
        n_train = len(edos_random_split(range(96))[0])
        check_training_run(f"{task} graphnetwork training path", result,
                           per_call, baseline_step_launches(task,
                                                            "graphnetwork"),
                           2 * math.ceil(n_train / BATCH), log, run_dir, 2,
                           embedder="graphnetwork")
        print(f"{task} graphnetwork training path: launches {launches}")
        paths[f"{task}_training_graphnetwork"] = launches

    samples = synthetic_edos_samples(96, seed=0)
    weights = os.path.join(workdir, "edos_mlp2.pt")
    model = build_model("edos", "mlp2", hidden=HIDDEN,
                        generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), weights)
    request = os.path.join(workdir, "request_mlp2.npz")
    out = os.path.join(workdir, "preds_mlp2.npz")
    save_samples(request, samples)
    reset_launches()
    main_predict.main(["--task", "edos", "--embedder", "mlp2",
                       "--torch_state_dict", weights, "--input", request,
                       "--output", out, "--hidden", str(HIDDEN),
                       "--batch_size", str(BATCH), "--device", "cuda"])
    launches = read_launches()
    check(launches == launch_counts(), f"mlp2 serving launched {launches}")
    with np.load(out) as z:
        dos = z["dos"]
    check_dos("mlp2 served", dos, len(samples))
    cpu = Predictor.from_torch(weights, task="edos", example=samples[0],
                               embedder="mlp2", hidden=HIDDEN,
                               batch_size=BATCH, device="cpu")
    ref = cpu.predict(samples)
    err = float(np.abs(dos - ref).max())
    print(f"main_predict --embedder mlp2: 96 samples, no kernel launched; "
          f"card vs CPU max abs err {err:.3e} (atol {MODEL_ATOL} + rtol "
          f"{MODEL_RTOL})")
    check(np.allclose(dos, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL),
          f"mlp2 served on the card differs from the CPU by {err:.3e}")
    paths["edos_serving_mlp2"] = launches
    return paths


# --- the data layer (queue 1 item 0) ---------------------------------------

DATA_RECORDS = 256


def featurize(module, args, env=None) -> float:
    """``python -m module *args`` (with ``env`` added to the environment),
    as a user runs a featuriser; returns the rate it reports (crystals or
    records a second of its own work, on the host)."""
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          env={**os.environ, **(env or {})},
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"{module} {' '.join(args)} failed:\n{proc.stderr[-3000:]}")
    rate = re.search(r"\(([\d.]+) (?:crystals|records)/s on the host\)",
                     proc.stdout)
    check(rate is not None, f"{module}: no rate in {proc.stdout!r}")
    return float(rate.group(1))


def same_samples(a, b) -> bool:
    """Every field of two lists of GraphSamples equal, bit for bit."""
    import dataclasses

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                if not (isinstance(v, np.ndarray) and u.dtype == v.dtype
                        and np.array_equal(u, v)):
                    return False
            elif u != v:
                return False
    return True


def phase_data_layer(workdir):
    """26: the data layer on the card's machine. 256 Materials-Project-shaped
    records (CIF strings of 4-24 atoms, P1, P-1 and P2_1/c with their
    symmetry operations) written as mp.pkl / dos.pkl from a seed, featurised
    by ``python -m dostransformer_tpu_torch.data.featurize_edos`` serially,
    with --workers 4 and with DOSTPU_NO_NATIVE=1: the three npz files must
    hold equal arrays, every record converted. Then cli.main_edos --dataset
    whole --data_dir trains the eDOS flagship 2 epochs on the card from
    them (exact launch counts). The same crystals as a phononDoS data.csv
    through featurize_phdos serially and with --workers 4: equal arrays.
    The native library is built first, so no rate counts its build. Then
    three paired readings of the serial featuriser in this process, native
    against DOSTPU_NO_NATIVE=1 in turns (paired_featurizer_ratios). The
    featurisers' rates are host numbers. Returns (the training run's
    launches, {path: records or crystals/s})."""
    import csv
    import pickle
    import platform

    from dostransformer_tpu_torch.data.cif import parse_cif
    from dostransformer_tpu_torch.data.io import load_samples
    from dostransformer_tpu_torch.data.synthetic import synthetic_mp_records

    # the one-time g++ build of the native library, before any rate is
    # timed (a featuriser's first run would count it otherwise)
    from dostransformer_tpu_torch import native

    t0 = time.perf_counter()
    native.library()
    print(f"native library (g++ -O3) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    mp_data, dos_data = synthetic_mp_records(DATA_RECORDS, seed=0)
    pkl = [os.path.join(workdir, n) for n in ("mp.pkl", "dos.pkl")]
    for path, obj in zip(pkl, (mp_data, dos_data)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    edos = "dostransformer_tpu_torch.data.featurize_edos"
    runs = {"serial": ([], None), "--workers 4": (["--workers", "4"], None),
            "DOSTPU_NO_NATIVE=1": ([], {"DOSTPU_NO_NATIVE": "1"})}
    rates, outputs = {}, {}
    for label, (extra, env) in runs.items():
        out = os.path.join(workdir, f"edos_{len(outputs)}.npz")
        rates[f"featurize_edos {label}"] = featurize(edos, [*pkl, out, *extra],
                                                     env)
        outputs[label] = load_samples(out)
    serial = outputs["serial"]
    check(len(serial) == DATA_RECORDS, f"featurize_edos converted "
                                       f"{len(serial)} of {DATA_RECORDS}")
    for label, samples in outputs.items():
        check(same_samples(samples, serial),
              f"featurize_edos {label}: arrays differ from the serial run")
    atoms = [s.n_nodes - 1 for s in serial]
    print(f"featurize_edos: {DATA_RECORDS} records, {min(atoms)}-{max(atoms)} "
          f"atoms, equal arrays serial / --workers 4 / DOSTPU_NO_NATIVE=1")
    ratios = paired_featurizer_ratios(mp_data, dos_data)

    data_dir = os.path.join(workdir, "processed")
    os.makedirs(data_dir)
    os.replace(os.path.join(workdir, "edos_0.npz"),
               os.path.join(data_dir, "dos_dataset_random.npz"))
    log = os.path.join(workdir, "train.jsonl")
    result, per_call, launches = run_counted(main_edos, [
        "--dataset", "whole", "--data_dir", data_dir, "--epochs", "2",
        "--eval", "1", "--layers", str(LAYERS), "--transformer",
        str(T_LAYERS), "--hidden", str(HIDDEN), "--batch_size", str(BATCH),
        "--device", "cuda", "--results_dir", workdir, "--log_jsonl", log])
    n_train = len(edos_random_split(range(DATA_RECORDS))[0])
    check_training_run("eDOS training from featurised records", result,
                       per_call, step_launches("edos", False),
                       2 * math.ceil(n_train / BATCH), log, workdir, 2)

    csv_path = os.path.join(workdir, "data.csv")
    rng = np.random.RandomState(1)
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["mp_id", "structure", "phdos", "crystal_system"])
        for mp_id, rec in mp_data.items():
            d = parse_cif(rec["cif"])
            structure = {"numbers": d["numbers"].tolist(),
                         "positions": d["cart_coords"].tolist(),
                         "cell": d["lattice"].tolist(),
                         "pbc": [True, True, True]}
            writer.writerow([mp_id, repr(structure),
                             repr(np.abs(rng.randn(PH_BINS)).tolist()),
                             rec["spacegroup"]["crystal_system"].capitalize()])
    phdos = "dostransformer_tpu_torch.data.featurize_phdos"
    ph = []
    for label, extra in (("serial", []), ("--workers 4", ["--workers", "4"])):
        out = os.path.join(workdir, f"phdos_{len(ph)}.npz")
        rates[f"featurize_phdos {label}"] = featurize(phdos, [csv_path, out,
                                                              *extra])
        ph.append(load_samples(out))
    check(len(ph[0]) == DATA_RECORDS and same_samples(ph[1], ph[0]),
          "featurize_phdos --workers 4: arrays differ from the serial run")
    host = (f"host: {os.cpu_count()} CPUs, {platform.machine()} "
            f"{platform.processor() or '(processor not reported)'}")
    print(f"featurizer rates ({host}): "
          + ", ".join(f"{k} {v:.1f}/s" for k, v in rates.items())
          + "; serial load_dataset native / DOSTPU_NO_NATIVE=1, "
          + f"{len(ratios)} pairs in turns: "
          + ", ".join(f"{r:.2f}x" for r in ratios))
    return launches, rates


def paired_featurizer_ratios(mp_data, dos_data, pairs: int = 3) -> list:
    """The serial featuriser (load_dataset in this process, library built)
    on the native neighbour search and on the NumPy one
    (DOSTPU_NO_NATIVE=1), in turns, the order flipped each pair; returns
    each pair's rate ratio native / NumPy (host numbers)."""
    from dostransformer_tpu_torch.data.featurize_edos import load_dataset

    ids = list(mp_data)
    before = os.environ.pop("DOSTPU_NO_NATIVE", None)
    try:
        ratios = []
        for k in range(pairs):
            seconds = {}
            for no_native in ((False, True) if k % 2 == 0 else (True, False)):
                if no_native:
                    os.environ["DOSTPU_NO_NATIVE"] = "1"
                else:
                    os.environ.pop("DOSTPU_NO_NATIVE", None)
                t0 = time.perf_counter()
                load_dataset(mp_data, dos_data, ids)
                seconds[no_native] = time.perf_counter() - t0
            ratios.append(seconds[True] / seconds[False])
        return ratios
    finally:
        os.environ.pop("DOSTPU_NO_NATIVE", None)
        if before is not None:
            os.environ["DOSTPU_NO_NATIVE"] = before



def spread(readings) -> str:
    """'median (least-most)' of a setting's samples/s readings."""
    return (f"{statistics.median(readings):.1f} ({min(readings):.1f}-"
            f"{max(readings):.1f})")


# --- bf16 serving (27-29) ------------------------------------------------

# bf16 forms of #1, #3 and #6 against their plain versions on the card: both
# compute in f32 from the same bf16 inputs (to ~1e-6, summation order) and
# round at the same points (#3: the normalised softmax weights, then the
# output), so at most one bf16 ulp (2^-8 of the value) apart; 2 ulps of the
# largest value
BF16_KERNEL_RTOL = 2.0 ** -7
# a bf16 model on the card against the same weights on the CPU, as the
# relative root-mean-square error |card - CPU|_2 / |CPU|_2 of the outputs:
# against the CPU's bf16 model <= 0.03 (the card rounds the attention's
# weights elsewhere and cuBLAS breaks bf16 ties elsewhere than the CPU);
# against its f32 model <= 0.03, the JAX package's bf16-against-f32 limit
# (tests/test_train.py, rtol 0.03 on a mean of squares), at hidden 256, and
# <= 0.06 at hidden 1,024, where the CPU's own bf16 model is 0.027 from f32
# (0.013 and 0.017 at hidden 256, eDOS and phDOS, 5 samples, seed 0)
BF16_MODEL_REL = 0.03
BF16_H1024_F32_REL = 0.06
# tensor-core peak in bf16 (NVIDIA H100 SXM data sheet, dense)
BF16_FLOPS_PER_S = 989e12


def bf16_mp_args(g, dev, b, a, e, m, h):
    """Message-passing operands at (B, A, E, M, H), a last graph with no real
    edge, f32; the caller casts the three projections to bf16."""
    rand = lambda *s: torch.randn(*s, generator=g).to(dev)
    idx = lambda: torch.randint(0, a, (b, e), generator=g,
                                dtype=torch.int32).to(dev)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0
    return (rand(b, a, m), rand(b, a, m), rand(b, e, m), idx(), idx(),
            mask.to(dev), rand(m).abs() + 0.5, rand(m) * 0.1,
            torch.tensor([0.25], device=dev), rand(h, m) * m ** -0.5,
            rand(h) * 0.1)


def bf16_row(run, f32_ms):
    """A bf16 comparison's numbers under the keys of the kernels line."""
    return {"ms_bf16": run["ms"], "ms_f32": f32_ms,
            "plain_ms_bf16": run["plain_ms"],
            "bound_ms_bf16": max(run["bytes_ms"], run["ops_ms"]),
            "bound_by_bf16": ("bytes" if run["bytes_ms"] >= run["ops_ms"]
                              else "operations"),
            "library_ms_bf16": run["library_ms"],
            "bf16_max_abs_err": run["err"], "bf16_rel_err": run["rel"]}


def phase_bf16_kernels(dev):
    """27: the bf16 forms of #1, #3 and #6 against their plain versions on
    the card (bf16 in both), each run twice and required to repeat bit for
    bit, timed beside the f32 form on the same inputs widened, the bf16
    bound and the library call. Returns {kernel: {"ms_bf16", ...,
    "bf16_by_shape"}}: the mean of a forward's calls at the flagship
    shapes, and every shape's row."""
    g = torch.Generator().manual_seed(27)
    out = {}

    # 1: eDOS, phDOS at B=8 and B=1, hidden 1,024 and hidden 50
    mp_shapes = {"eDOS": (BATCH, 32, 384, 2 * HIDDEN, HIDDEN),
                 "phDOS B=8": (BATCH, 16, 128, 2 * HIDDEN, HIDDEN),
                 "phDOS B=1": (1, 16, 128, 2 * HIDDEN, HIDDEN),
                 "h1024": (BATCH, 32, 384, 2 * WIDE, WIDE),
                 "hidden 50": (BATCH, 16, 128, 2 * NARROW, NARROW)}
    rows = {}
    for label, shape in mp_shapes.items():
        args32 = bf16_mp_args(g, dev, *shape)
        args = tuple(t.bfloat16() for t in args32[:3]) + args32[3:]
        b, a, e, m, h = shape
        tc = fused_mp_form(m, h) != FORM_GENERIC
        name = f"fused_mp_edge bf16[{label}]"
        print(f"{name}: B={b} A={a} E={e} M={m} H={h}, form "
              f"{'tensor-core' if tc else 'generic'}")
        run = compare(name, lambda: fused_mp_edge(*args),
                      lambda: mp_edge_reference(*args),
                      rtols=(BF16_KERNEL_RTOL,) * 2, repeat=True,
                      work=mp_work(args, fused_mp_edge(*args)))
        if tc:  # the generic form's bf16 twin on the same inputs
            generic = fused_mp_forward_kernel(*args, form=FORM_GENERIC)
            for i, (x, w) in enumerate(zip(generic, mp_edge_reference(*args))):
                err = (x.float() - w.float()).abs().max().item()
                check(x.dtype == torch.bfloat16 and err <= BF16_KERNEL_RTOL
                      * max(1.0, w.float().abs().max().item()),
                      f"{name}: generic form, output {i} max abs err "
                      f"{err:.3e}")
            run["ms_generic_bf16"] = median_ms(
                lambda: fused_mp_forward_kernel(*args, form=FORM_GENERIC))
        row = bf16_row(run, median_ms(lambda: fused_mp_edge(*args32)))
        row.update({k: run[k] for k in ("ms_generic_bf16",) if k in run})
        print(f"  f32 form on the same inputs {row['ms_f32']:.4f} ms; bf16 "
              f"bound {row['bound_ms_bf16']:.4f} ms ({row['bound_by_bf16']})"
              + (f"; generic bf16 form {run['ms_generic_bf16']:.4f} ms"
                 if tc else ""))
        rows[label] = row
    out["fused_mp_edge"] = rows

    # 3: D = 256 at the eDOS and phDOS shapes, D = 50 (phDOS), D = 1,024
    attn = {}
    cases = ([(f"eDOS {k}", s, HIDDEN) for k, s in attention_shapes().items()]
             + [(f"phDOS {k}", s, HIDDEN)
                for k, s in phdos_attention_shapes().items()]
             + [(f"D=50 phDOS {k}", s, NARROW)
                for k, s in phdos_attention_shapes().items()]
             + [(f"D=1024 eDOS {k}", s, WIDE)
                for k, s in attention_shapes().items()])
    for label, (bb, lq, lk), d in cases:
        q32 = torch.randn(bb, lq, d, generator=g).to(dev)
        k32 = torch.randn(bb, lk, d, generator=g).to(dev)
        q, k = q32.bfloat16(), k32.bfloat16()
        km = None
        if lk != lq:  # atom keys: pad atoms masked, last graph all masked
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = (torch.arange(lk)[None] < n_real[:, None])
            km[-1] = False
            km = km.to(dev)
        bias = (key_bias(km) if km is not None
                else torch.zeros(bb, lk, device=dev))
        name = f"fused_attention bf16[{label}]"
        print(f"{name}: B={bb} Lq={lq} Lk={lk} D={d}, keys = values")
        work = (nbytes(q, k, bias) + nbytes(q), 4 * bb * lq * lk * d)
        run = compare(name, lambda: fused_attention_fwd(q, k, k, bias)[0],
                      lambda: dot_product_attention(q, k, k, km),
                      rtols=(BF16_KERNEL_RTOL,), repeat=True, work=work,
                      flops_per_s=BF16_FLOPS_PER_S,
                      library_fn=lambda: sdpa(q, k, k, bias.bfloat16()))
        # the row statistics the next PR's bf16 backward will read: f32,
        # from scores that are exact products of bf16 values
        _, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
        want = attention_stats_reference(q, k, bias)
        real = ~(bias == -1e30).all(-1)
        for what, got_s, want_s in (
                ("row max", stats[0][real], want[0][real]),
                ("log-sum-exp", stats[0][real] + stats[1][real].log(),
                 want[0][real] + want[1][real].log())):
            err = (got_s - want_s).abs().max().item()
            check(stats.dtype == torch.float32 and err <= KERNEL_RTOL
                  * max(1.0, want_s.abs().max().item()),
                  f"{name}: {what} max abs err {err:.3e}")
        check(torch.equal(fused_attention_fwd(q, k, k, bias)[0],
                          fused_attention_fwd(q, k, k.clone(), bias)[0]),
              f"{name}: v is k differs from two copies")
        check(torch.equal(fused_attention(q, k, k, km),
                          fused_attention_fwd(q, k, k, bias)[0]),
              f"{name}: the op differs from the kernel's wrapper")
        row = bf16_row(run, median_ms(
            lambda: fused_attention_fwd(q32, k32, k32, bias)[0]))
        print(f"  row statistics f32 within {KERNEL_RTOL} rel; f32 form on "
              f"the same inputs {row['ms_f32']:.4f} ms; bf16 bound "
              f"{row['bound_ms_bf16']:.5f} ms ({row['bound_by_bf16']})")
        attn[label] = row
    out["fused_attention"] = attn

    # 6: the phDOS count and E = 2,048, N = 64 (F = 1, exact; F = 256)
    batch = collate(synthetic_phdos_samples(BATCH, seed=0)).to(dev)
    ids = torch.randint(0, 64, (BATCH, 2048), generator=g,
                        dtype=torch.int32).to(dev)
    cases = {"phDOS count": (batch.edge_mask[..., None], batch.receivers,
                             batch.atoms_per_graph),
             "E=2048 N=64 F=1": ((torch.rand(BATCH, 2048, 1, generator=g)
                                  > 0.1).float().to(dev), ids, 64),
             f"E=2048 N=64 F={HIDDEN}": (
                 torch.randn(BATCH, 2048, HIDDEN, generator=g).to(dev), ids,
                 64)}
    seg = {}
    for label, (data32, sids, n) in cases.items():
        data = data32.bfloat16()
        bb, ee, f = data.shape
        name = f"batched_segment_sum bf16[{label}]"
        print(f"{name}: B={bb} E={ee} F={f} N={n}")
        ok = (sids >= 0) & (sids < n)
        flat = torch.where(ok, sids + torch.arange(bb, device=dev)[:, None]
                           * n, bb * n).reshape(-1).long()
        rows_ = data.reshape(bb * ee, f)
        library = lambda: torch.zeros(bb * n + 1, f, device=dev,
                                      dtype=torch.bfloat16).index_add_(
            0, flat, rows_)
        work = (nbytes(data, sids) + bb * n * f * 2,
                float(ok.sum().item()) * f)
        run = compare(name, lambda: batched_segment_sum(data, sids, n),
                      lambda: segment_sum_reference(data, sids, n),
                      rtols=(BF16_KERNEL_RTOL,), repeat=True, work=work,
                      library_fn=library)
        if f == 1:
            check(torch.equal(batched_segment_sum(data, sids, n),
                              segment_sum_reference(data, sids, n)),
                  f"{name}: the bf16 edge counts are not exact")
        seg[label] = bf16_row(run, median_ms(
            lambda: batched_segment_sum(data32, sids, n)))
        print(f"  f32 form on the same inputs {seg[label]['ms_f32']:.4f} ms")
    out["batched_segment_sum"] = seg

    return bf16_line(out, {
        "fused_mp_edge": ["eDOS"],
        "fused_attention": [f"eDOS {k}" for k in attention_shapes()],
        "batched_segment_sum": ["phDOS count"]})


def bf16_line(out, main):
    """The kernels line's bf16 columns of each kernel in ``out``: the mean
    over its ``main`` shapes (a forward's or a step's calls at the flagship
    shapes), the largest error, and every shape's row."""
    line = {}
    for name, rows in out.items():
        shapes = main[name]
        mean = lambda key: (None if any(rows[r][key] is None for r in shapes)
                            else statistics.mean(rows[r][key]
                                                 for r in shapes))
        line[name] = {key: mean(key) for key in (
            "ms_bf16", "ms_f32", "plain_ms_bf16", "bound_ms_bf16",
            "library_ms_bf16")}
        line[name]["bf16_max_rel_err"] = max(r["bf16_rel_err"]
                                             for r in rows.values())
        line[name]["bf16_by_shape"] = rows
    return line


def serving_launches(task, n, fused=False) -> dict:
    """Kernel launches of n serving forwards: the forward kernels (in bf16
    their bf16 forms), no backward."""
    attn = "fused_attention_ln" if fused else "fused_attention"
    return launch_counts(fused_mp_edge=LAYERS * n,
                         batched_segment_sum=LAYERS * n if task == "phdos"
                         else 0, **{attn: 3 * T_LAYERS * n})


def check_bf16_outputs(label, dos, cpu16, cpu32, bins,
                       f32_limit=BF16_MODEL_REL):
    """A bf16 model's served output: f32 [N, bins], finite, within
    BF16_MODEL_REL (relative RMS) of the CPU's bf16 model and within
    ``f32_limit`` of its f32 model. Returns the two relative RMS errors."""
    check(dos.dtype == np.float32 and dos.shape == (len(cpu16), bins)
          and bool(np.isfinite(dos).all()),
          f"{label}: output {dos.dtype} {dos.shape} or non-finite")
    errs = []
    for what, ref, limit in (("CPU bf16", cpu16, BF16_MODEL_REL),
                             ("CPU f32", cpu32, f32_limit)):
        # (an eDOS output clamped to 0 everywhere has no norm: 0 / tiny)
        rel = float(np.linalg.norm(dos - ref)
                    / max(float(np.linalg.norm(ref)), 1e-30))
        top = float(np.abs(dos - ref).max()
                    / max(float(np.abs(ref).max()), 1e-30))
        print(f"  {label} vs the {what} model: relative RMS error {rel:.3e} "
              f"(limit {limit}); max abs err / max |CPU| {top:.3e}")
        check(rel <= limit, f"{label}: {rel:.3e} from the {what} model")
        errs.append(rel)
    own = float(np.linalg.norm(cpu16 - cpu32)
                / max(float(np.linalg.norm(cpu32)), 1e-30))
    print(f"  (the CPU's bf16 model vs its f32 model: relative RMS error "
          f"{own:.3e})")
    return errs


# the CPU's outputs of each flagship request, by (task, request, dtype): the
# LayerNorm lever changes no output, so the fused run reuses the unfused one's
CPU_OUTPUTS = {}


def phase_bf16_serving(task, served, fused=False):
    """28: a flagship served in bf16 through Predictor.from_torch(...,
    dtype="bfloat16") (with ``fused``, also fuse_ln_attn): the 96-sample
    request at batch 8 with the launches counted from 0 (exactly 3 #1, 6 #3
    or #5, and for phDOS 3 #6 a forward, all bf16 forms, no backward); the
    short and mixed requests against the CPU's bf16 and f32 models; then
    samples/s bf16 against f32, taken in turns. Returns (launches,
    {"bf16": [...], "f32": [...]}, the largest relative errors)."""
    kw, weights, requests = served["kw"], served["weights"], served["requests"]
    lever = dict(fuse_ln_attn=True) if fused else {}
    gpu = Predictor.from_torch(weights, device="cuda", graphs=False,
                               dtype="bfloat16", **lever, **kw)
    f32 = (Predictor.from_torch(weights, device="cuda", graphs=False,
                                **lever, **kw)
           if fused else served["gpu"])
    check(all(p.dtype == torch.float32 for p in gpu.model.parameters()),
          f"{task} bf16: a parameter is not f32")
    tag = f"{task} bf16{' fuse_ln_attn' if fused else ''}"
    reset_launches()
    dos = gpu.predict(requests["96"])
    launches = read_launches()
    want = serving_launches(task, expected_batches(requests["96"]), fused)
    print(f"{tag} request 96: launches {launches}")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(dos.dtype == np.float32 and bool(np.isfinite(dos).all()),
          f"{tag}: the 96-sample output is {dos.dtype} or non-finite")
    if task == "edos":
        check(bool((dos >= 0).all()), f"{tag}: negative output despite clamp")
    errs = []
    for label, samples in requests.items():
        if label == "96":
            continue
        refs = []
        for dtype in ("bfloat16", "float32"):
            key = (task, label, dtype)
            if key not in CPU_OUTPUTS:
                CPU_OUTPUTS[key] = Predictor.from_torch(
                    weights, device="cpu", dtype=dtype, **kw).predict(samples)
            refs.append(CPU_OUTPUTS[key])
        errs += check_bf16_outputs(f"{tag} request {label}",
                                   gpu.predict(samples), *refs,
                                   served["bins"])
    rates = {"bf16": [], "f32": []}
    for name, predictor in (("f32", f32), ("bf16", gpu), ("bf16", gpu),
                            ("f32", f32)) * 2:
        rates[name].append(serving_rate(predictor, requests["96"]))
    return launches, rates, max(errs)


def phase_h1024_bf16_serving(workdir):
    """29: the h1024 eDOS flagship served in bf16 (the one card-bound
    shape): the 96-sample request with the launches counted from 0, five
    samples against the CPU's bf16 and f32 models, then device time a
    forward (CUDA events, a batch of 8 from the request) and samples/s,
    bf16 against f32 in turns. Returns (launches, {"device_ms": {...},
    "rates": {...}})."""
    model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS, hidden=WIDE,
                        generator=torch.Generator().manual_seed(0))
    weights = os.path.join(workdir, "edos_h1024.pt")
    torch.save(model.state_dict(), weights)
    requests = {"96": synthetic_edos_samples(96, seed=0),
                "5 (short batch)": synthetic_edos_samples(5, seed=1)}
    kw = dict(task="edos", example=requests["96"][0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=WIDE, batch_size=BATCH)
    gpu = {dt: Predictor.from_torch(weights, device="cuda", graphs=False,
                                    dtype=dt, **kw)
           for dt in ("bfloat16", "float32")}
    reset_launches()
    dos = gpu["bfloat16"].predict(requests["96"])
    launches = read_launches()
    want = serving_launches("edos", expected_batches(requests["96"]))
    print(f"h1024 bf16 request 96: launches {launches}")
    check(launches == want, f"h1024 bf16: launches {launches}, expected "
                            f"{want}")
    check(dos.dtype == np.float32 and bool(np.isfinite(dos).all())
          and bool((dos >= 0).all()), "h1024 bf16: the 96-sample output")
    five = requests["5 (short batch)"]
    cpu = {dt: Predictor.from_torch(weights, device="cpu", dtype=dt,
                                    **kw).predict(five)
           for dt in ("bfloat16", "float32")}
    err = check_bf16_outputs("h1024 bf16 request 5",
                             gpu["bfloat16"].predict(five), cpu["bfloat16"],
                             cpu["float32"], BINS, BF16_H1024_F32_REL)
    batch = next(iter(GraphLoader(requests["96"], BATCH))).to(
        gpu["bfloat16"].device)

    def forward(dt):
        with torch.inference_mode():
            return gpu[dt].model(batch)

    device_ms = {"bfloat16": [], "float32": []}
    rates = {"bfloat16": [], "float32": []}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        device_ms[dt].append(median_ms(lambda: forward(dt), runs=20))
        rates[dt].append(serving_rate(gpu[dt], requests["96"]))
    return launches, {"device_ms": device_ms, "rates": rates,
                      "max_rel_err": max(err)}


# --- bf16 training (30-33) -------------------------------------------------

# a bf16 model's training on the card against the same weights on the CPU:
# two bf16 realisations (the card's kernels and cuBLAS, the CPU's plain
# versions) stand about as far apart as bf16 stands from f32 (phases 28-29),
# and that distance moves with the width and the depth; so the limits
# are this multiple of the CPU's own bf16-to-f32 distance, measured in the
# same phase on the same weights and batches
BF16_TRAIN_FACTOR = 3.0
# a bf16 training run against the same run in f32: the JAX package's own
# bound (tests/test_train.py, rtol 0.03 on the first-step loss)
BF16_RUN_RTOL = 0.03


def rel_rms(got, want) -> float:
    """|got - want|_2 / |want|_2 (0 where both are 0)."""
    num = float((got.float() - want.float()).norm())
    den = float(want.float().norm())
    return 0.0 if num == 0.0 else num / max(den, 1e-30)


def mp_bwd_args(g, dev, b, a, e, m, h):
    """The backward's operands at (B, A, E, M, H): bf16_mp_args without b1,
    plus the cotangents g_eout [B, E, H] and g_agg [B, A, H], f32."""
    args = bf16_mp_args(g, dev, b, a, e, m, h)[:10]
    return args + (torch.randn(b, e, h, generator=g).to(dev),
                   torch.randn(b, a, h, generator=g).to(dev))


def phase_bf16_backward_kernels(dev):
    """30: the bf16 forms of #2 and #4 against their plain versions in bf16
    on the card, each run twice and required to repeat bit for bit, timed
    beside the f32 form on the same inputs widened, the bound and (#4) SDPA's
    bf16 backward. #2's outputs are f32 from bf16-exact inputs: the f32
    limits. #4's are bf16: 2^-7 of the largest value, bit-equal without the
    forward's statistics and with two copies of the keys. Returns the
    kernels line's bf16 columns, as phase 27's."""
    g = torch.Generator().manual_seed(30)
    out = {}

    # 2: eDOS, phDOS at B=8 and B=1, hidden 1,024 (a cluster of four) and
    # hidden 50 (the generic form)
    mp_shapes = {"eDOS": (BATCH, 32, 384, 2 * HIDDEN, HIDDEN),
                 "phDOS B=8": (BATCH, 16, 128, 2 * HIDDEN, HIDDEN),
                 "phDOS B=1": (1, 16, 128, 2 * HIDDEN, HIDDEN),
                 "h1024": (BATCH, 32, 384, 2 * WIDE, WIDE),
                 "hidden 50": (BATCH, 16, 128, 2 * NARROW, NARROW)}
    rtols = (KERNEL_RTOL,) * 3 + (PARAM_GRAD_RTOL,) * 5
    rows = {}
    for label, shape in mp_shapes.items():
        args32 = mp_bwd_args(g, dev, *shape)
        bf = {0, 1, 2, 10, 11}  # the projections and the cotangents
        args = tuple(t.bfloat16() if i in bf else t
                     for i, t in enumerate(args32))
        b, a, e, m, h = shape
        tc = fused_mp_bwd_form(m, h) != FORM_GENERIC
        tile = fused_mp_edge_bwd_tile(b, e, m, h)
        name = f"fused_mp_edge_bwd bf16[{label}]"
        print(f"{name}: B={b} A={a} E={e} M={m} H={h}, form "
              f"{'tensor-core' if tc else 'generic'}, {tile[0]} edges x "
              f"{tile[1]} blocks")
        run = compare(name, lambda: fused_mp_edge_bwd(*args),
                      lambda: mp_edge_bwd_reference(*args), rtols=rtols,
                      repeat=True,
                      work=mp_work(args, fused_mp_edge_bwd(*args),
                                   backward=True))
        if tc and label == "eDOS":  # the generic form's bf16 twin
            generic = fused_mp_edge_bwd(*args, form=FORM_GENERIC)
            for i, (x, w, tol) in enumerate(
                    zip(generic, mp_edge_bwd_reference(*args), rtols)):
                err = (x - w).abs().max().item()
                check(x.dtype == torch.float32 and err <= tol
                      * max(1.0, w.abs().max().item()),
                      f"{name}: generic form, output {i} max abs err "
                      f"{err:.3e}")
            run["ms_generic_bf16"] = median_ms(
                lambda: fused_mp_edge_bwd(*args, form=FORM_GENERIC))
        row = bf16_row(run, median_ms(lambda: fused_mp_edge_bwd(*args32)))
        row.update({k: run[k] for k in ("ms_generic_bf16",) if k in run})
        print(f"  f32 form on the same inputs {row['ms_f32']:.4f} ms; bound "
              f"{row['bound_ms_bf16']:.4f} ms ({row['bound_by_bf16']}, f32 "
              f"operations: W1 is f32)"
              + (f"; generic bf16 form {run['ms_generic_bf16']:.4f} ms"
                 if "ms_generic_bf16" in run else ""))
        rows[label] = row
    out["fused_mp_edge_bwd"] = rows

    # 4: D = 256 at the eDOS and phDOS shapes, D = 1,024 (sliced), D = 50
    attn = {}
    cases = ([(f"eDOS {k}", s, HIDDEN) for k, s in attention_shapes().items()]
             + [(f"phDOS {k}", s, HIDDEN)
                for k, s in phdos_attention_shapes().items()]
             + [(f"D=1024 eDOS {k}", s, WIDE)
                for k, s in attention_shapes().items()]
             + [(f"D=50 phDOS {k}", s, NARROW)
                for k, s in phdos_attention_shapes().items()])
    for label, (bb, lq, lk), d in cases:
        q32, k32, go32 = (torch.randn(bb, n, d, generator=g).to(dev)
                          for n in (lq, lk, lq))
        q, k, go = q32.bfloat16(), k32.bfloat16(), go32.bfloat16()
        km = torch.ones(bb, lk, dtype=torch.bool)
        if lk != lq:  # atom keys: pad atoms masked
            n_real = torch.randint(4, lk + 1, (bb,), generator=g)
            km = torch.arange(lk)[None] < n_real[:, None]
        km[-1] = False  # a dummy graph: every key masked
        bias = key_bias(km.to(dev))
        o, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
        o32, stats32 = fused_attention_fwd(q32, k32, k32, bias,
                                           want_stats=True)
        name = f"fused_attention_bwd bf16[{label}]"
        print(f"{name}: B={bb} Lq={lq} Lk={lk} D={d}, keys = values, the "
              f"forward's row statistics")
        before = fused_attention_bwd.launches
        got = fused_attention_bwd(q, k, k, bias, o, go, stats)
        check(fused_attention_bwd.launches == before + 1
              and all(t.dtype == torch.bfloat16 for t in got),
              f"{name}: one launch and bf16 gradients")
        work = (nbytes(q, k, bias, go, stats) + nbytes(q, k, k.clone()),
                10 * bb * lq * lk * d)
        run = compare(name,
                      lambda: fused_attention_bwd(q, k, k, bias, o, go,
                                                  stats),
                      lambda: attention_bwd_reference(q, k, k, bias, go),
                      rtols=(BF16_KERNEL_RTOL,) * 3, repeat=True, work=work,
                      flops_per_s=BF16_FLOPS_PER_S,
                      library_fn=sdpa_backward(q, k, k, bias.bfloat16(), go))
        check_attention_backward(name, q, k, bias, o, go, stats, got, run)
        row = bf16_row(run, median_ms(
            lambda: fused_attention_bwd(q32, k32, k32, bias, o32, go32,
                                        stats32)))
        row.update(ms_no_stats_bf16=run["ms_no_stats"],
                   ms_two_tensors_bf16=run["ms_two_tensors"])
        print(f"  f32 form on the same inputs {row['ms_f32']:.4f} ms; bf16 "
              f"bound {row['bound_ms_bf16']:.5f} ms ({row['bound_by_bf16']})"
              f"; SDPA's bf16 backward {row['library_ms_bf16']:.4f} ms")
        attn[label] = row
    out["fused_attention_bwd"] = attn

    return bf16_line(out, {
        "fused_mp_edge_bwd": ["eDOS"],
        "fused_attention_bwd": [f"eDOS {k}" for k in attention_shapes()]})


def phase_bf16_card_vs_cpu(task, hidden=HIDDEN, samples=21, batch=BATCH,
                           **levers):
    """31: a bf16 model's Trainer.train_steps on the card against the same
    weights and batches on the CPU in bf16, and in f32 for the scale
    (``samples`` at ``batch``: 21 at 8 are 3 steps, the last short): every
    card step launches exactly the path's kernels, bf16 forms forward and
    backward; the first step's gradients (relative RMS for each parameter
    and for all together) and every step's loss within BF16_TRAIN_FACTOR of
    the CPU bf16 model's own distance from its f32 model. Returns the card
    steps' launches together."""
    learnable = (synthetic_edos_learnable if task == "edos"
                 else synthetic_phdos_learnable)
    clamp = task == "edos"
    kw = dict(layers=LAYERS, t_layers=T_LAYERS, hidden=hidden, **levers)
    cpu16 = build_model(task, dtype="bfloat16",
                        generator=torch.Generator().manual_seed(1), **kw)
    cpu32 = build_model(task, **kw)
    cpu32.load_state_dict(cpu16.state_dict())
    card = copy.deepcopy(cpu16).to("cuda")
    models = {"card": card, "cpu bf16": cpu16, "cpu f32": cpu32}
    trainers = {k: Trainer(m, clamp_targets=clamp, eval_clamp=clamp)
                for k, m in models.items()}
    batches = list(GraphLoader(learnable(samples, seed=5), batch))
    losses = {k: [] for k in models}
    grads = {}
    totals = launch_counts()
    want = step_launches(task, bool(levers))
    for step, b in enumerate(batches):
        for k, trainer in trainers.items():
            reset_launches()
            losses[k].append(trainer.train_step(b)["loss"].item())
            if k == "card":
                counts = read_launches()
                check(counts == want, f"{task} bf16 step {step}: launches "
                                      f"{counts}, expected {want}")
                for name, v in counts.items():
                    totals[name] += v
            if step == 0:
                grads[k] = {n: p.grad.detach().float().cpu()
                            for n, p in models[k].named_parameters()}
    names = list(grads["cpu bf16"])
    cat = lambda d: torch.cat([d[n].flatten() for n in names])
    own = rel_rms(cat(grads["cpu bf16"]), cat(grads["cpu f32"]))
    got = rel_rms(cat(grads["card"]), cat(grads["cpu bf16"]))
    worst = (0.0, "", 0.0)
    for n in names:
        own_p = rel_rms(grads["cpu bf16"][n], grads["cpu f32"][n])
        got_p = rel_rms(grads["card"][n], grads["cpu bf16"][n])
        limit = BF16_TRAIN_FACTOR * max(own_p, own)
        check(got_p <= limit, f"{task} bf16 first-step gradient of {n}: "
                              f"{got_p:.3e} from the CPU's, limit {limit:.3e}")
        if got_p / max(own_p, own) > worst[0]:
            worst = (got_p / max(own_p, own), n, got_p)
    print(f"  first-step gradients, relative RMS: card vs CPU bf16 {got:.3e}, "
          f"CPU bf16 vs CPU f32 {own:.3e} (limit {BF16_TRAIN_FACTOR} x); per "
          f"parameter the worst is {worst[1]} at {worst[2]:.3e}, "
          f"{worst[0]:.2f} x its own distance")
    check(got <= BF16_TRAIN_FACTOR * own,
          f"{task} bf16 first-step gradients: {got:.3e} from the CPU's, "
          f"limit {BF16_TRAIN_FACTOR} x {own:.3e}")
    own_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["cpu bf16"],
                                                       losses["cpu f32"]))
    # one batch's loss may land near f32 by chance: the gradients' distance
    # is the floor of bf16's own noise at this depth
    limit = BF16_TRAIN_FACTOR * max(own_loss, own)
    for step, (lc, l16, l32) in enumerate(zip(*losses.values())):
        rel = abs(lc - l16) / abs(l16)
        print(f"  step {step}: loss card {lc:.7f}, CPU bf16 {l16:.7f}, CPU "
              f"f32 {l32:.7f}; card vs CPU bf16 {rel:.3e} (limit "
              f"{limit:.3e})")
        check(rel <= limit, f"{task} bf16 step {step}: card loss {lc} vs "
                            f"CPU {l16}")
    return totals


def phase_bf16_cli(workdir):
    """32: the training CLIs in bf16 on the card. cli.main_edos --dtype
    bfloat16 for two epochs on 48 learnable samples with --checkpoint_dir
    --checkpoint_every 1, a run stopped after epoch 1 and resumed (epoch
    losses and best metrics exactly the uninterrupted run's), one with
    --bf16_data --remat (the bf16 forward kernels replayed in the
    backward), and the same run in f32; then cli.main_phdos --dtype
    bfloat16 and its f32 twin. Exact launches per train step and eval
    batch; every bf16 run's epoch losses within BF16_RUN_RTOL of its f32
    twin's. best/ is served through Predictor.from_checkpoint(...,
    dtype="bfloat16") on the card against the CPU's bf16 and f32 models.
    Returns {path: launches}."""
    n_train = len(edos_random_split(range(48))[0])
    steps = math.ceil(n_train / BATCH)
    bf16 = ["--dtype", "bfloat16"]
    runs, paths = {}, {}

    def train(cli, task, name, epochs, extra):
        run_dir = os.path.join(workdir, name)
        os.makedirs(run_dir)
        argv = edos_run_argv(run_dir, epochs, n=48, extra=extra)
        result, per_call, launches = run_counted(cli, argv)
        done = 1 if name == "resumed" else 0  # epochs the checkpoint holds
        # with --remat the forward's launches repeat in the backward; an
        # eval batch runs the forward once
        plain = step_launches(task, False)
        want = remat_step_launches(task) if "--remat" in extra else plain
        losses = check_training_run(
            f"{task} training run {name}", result, per_call, want,
            (epochs - done) * steps, os.path.join(run_dir, "train.jsonl"),
            run_dir, epochs - done,
            want_eval=dict(plain, **dict.fromkeys(BACKWARD, 0)))
        runs[name] = (result, losses)
        return launches

    ck = lambda name: ["--checkpoint_dir", os.path.join(workdir, name),
                       "--checkpoint_every", "1"]
    paths["edos_training_bf16_ckpt"] = train(main_edos, "edos", "whole", 2,
                                             bf16 + ck("ck_whole"))
    train(main_edos, "edos", "first", 1, bf16 + ck("ck_cut"))
    train(main_edos, "edos", "resumed", 2, bf16 + ck("ck_cut"))
    paths["edos_training_bf16_data"] = train(
        main_edos, "edos", "bf16_data", 2, bf16 + ["--bf16_data", "--remat"])
    train(main_edos, "edos", "f32", 2, [])
    paths["phdos_training_bf16"] = train(main_phdos, "phdos", "phdos_bf16",
                                         2, bf16)
    train(main_phdos, "phdos", "phdos_f32", 2, [])

    whole, resumed = runs["whole"], runs["resumed"]
    cut = runs["first"][1] + resumed[1]
    print(f"bf16 epoch losses, uninterrupted {whole[1]}; stopped after "
          f"epoch 1 and resumed {cut}")
    check(cut == whole[1], f"bf16: resumed losses {cut} differ from the "
                           f"uninterrupted {whole[1]}")
    for key in ("best_epoch", "best_valid_rmse", "best_valid_mae", "test"):
        check(resumed[0][key] == whole[0][key],
              f"bf16 resumed {key} {resumed[0][key]} differs from "
              f"{whole[0][key]}")
    for name, twin in (("whole", "f32"), ("bf16_data", "f32"),
                       ("phdos_bf16", "phdos_f32")):
        got, want = runs[name][1], runs[twin][1]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"{name} epoch losses {got} vs f32 {want}: max relative "
              f"difference {rel:.3e} (limit {BF16_RUN_RTOL})")
        check(rel <= BF16_RUN_RTOL, f"{name}: bf16 losses {got} do not "
                                    f"track f32 {want}")

    samples = synthetic_edos_samples(20, seed=3)
    kw = dict(task="edos", example=samples[0], layers=LAYERS,
              t_layers=T_LAYERS, hidden=HIDDEN, batch_size=BATCH)
    best = os.path.join(workdir, "ck_whole")
    gpu = Predictor.from_checkpoint(best, device="cuda", graphs=False,
                                    dtype="bfloat16", **kw)
    reset_launches()
    dos = gpu.predict(samples)
    paths["edos_serving_bf16_ckpt"] = read_launches()
    want = serving_launches("edos", expected_batches(samples))
    check(paths["edos_serving_bf16_ckpt"] == want,
          f"best/ in bf16: launches {paths['edos_serving_bf16_ckpt']}, "
          f"expected {want}")
    cpu = [Predictor.from_checkpoint(best, device="cpu", dtype=dt,
                                     **kw).predict(samples)
           for dt in ("bfloat16", "float32")]
    check_bf16_outputs("best/ served in bf16", dos, *cpu, BINS)
    return paths


def phase_bf16_train_rates():
    """33: a record, no limit. Train samples/s bf16 against f32 (batch 8,
    batches on the card, synchronised at both ends), readings taken in turns
    in one process, at hidden 256 (eDOS, phDOS) and 1,024 (eDOS); device ms
    a step by CUDA events at hidden 1,024."""
    out = {}
    for label, task, hidden, steps in (("eDOS h256", "edos", HIDDEN, 10),
                                       ("phDOS h256", "phdos", HIDDEN, 10),
                                       ("eDOS h1024", "edos", WIDE, 4)):
        learnable = (synthetic_edos_learnable if task == "edos"
                     else synthetic_phdos_learnable)
        batches = [b.to("cuda") for b in
                   GraphLoader(learnable(8 * steps, seed=0), BATCH)]
        trainers = {dt: Trainer(build_model(
            task, layers=LAYERS, t_layers=T_LAYERS, hidden=hidden,
            dtype=dt, device="cuda",
            generator=torch.Generator().manual_seed(2)),
            clamp_targets=task == "edos", eval_clamp=task == "edos")
            for dt in ("float32", "bfloat16")}
        for trainer in trainers.values():  # warm
            trainer.train_step(batches[0])
        rates = {dt: [] for dt in trainers}
        ms = {dt: [] for dt in trainers}
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                trainers[dt].train_step(b)
            torch.cuda.synchronize()
            rates[dt].append(len(batches) * BATCH
                             / (time.perf_counter() - t0))
            if hidden == WIDE:
                ms[dt].append(median_ms(
                    lambda: trainers[dt].train_step(batches[0]), runs=6,
                    warmup=1))
        out[label] = {"rates": rates} | ({"device_ms": ms}
                                         if hidden == WIDE else {})
    return out


# --- the rest of serving (34-36): CUDA graphs, torch.export artifacts, the
# coalescing batcher and the HTTP server ------------------------------------

# graph-served against eager on the same weights and batches: the same
# kernels and cuBLAS calls on the same inputs, so bit-equal is expected; where
# not, 1e-5 of the largest eager value (the kernel tolerance) and the reason
GRAPH_REL = 1e-5
# the __global__ functions that mark one call of each forward kernel (a
# message-passing call is its edge kernel, then agg_kernel), for counting the
# launches inside a replayed graph, where the wrappers' counters do not run
CALL_KERNELS = {
    "fused_mp_edge": ("agg_kernel",),
    "fused_attention": ("attn_fwd_kernel", "attn_fwd_sliced_kernel"),
    "fused_attention_ln": ("attn_ln_fwd_kernel", "attn_ln_fwd_sliced_kernel"),
    "batched_segment_sum": ("segment_count_kernel", "segment_sum_kernel")}
# the __global__ functions of the three backward sources (but attention_bwd.cu's
# reduce_kernel, whose name PyTorch's reductions share)
BACKWARD_KERNELS = (
    "edge_bwd_kernel", "edge_bwd_tc_kernel", "gw1_kernel", "gw1_tc_kernel",
    "tail_kernel", "stats_kernel", "stats_sliced_kernel", "dq_kernel",
    "dq_sliced_kernel", "dkv_kernel", "dkv_sliced_kernel", "ln_bwd_kernel")
# the four serving cases of phase 34: (label, task, Predictor keywords)
GRAPH_CASES = (("edos", "edos", {}), ("phdos", "phdos", {}),
               ("edos_bf16", "edos", {"dtype": "bfloat16"}),
               ("edos_fused", "edos", {"fuse_ln_attn": True}))


def same_or_close(label, got, want) -> str:
    """'bit-equal', or the max abs difference within GRAPH_REL of the
    largest expected value (else raise)."""
    if np.array_equal(got, want):
        return "bit-equal"
    err = float(np.abs(got - want).max())
    limit = GRAPH_REL * max(1.0, float(np.abs(want).max()))
    check(err <= limit, f"{label}: max abs difference {err:.3e} over "
                        f"{limit:.3e}")
    return f"max abs diff {err:.3e} (limit {limit:.3e})"


def request_ms(predictor, samples) -> float:
    t0 = time.perf_counter()
    predictor.predict(samples)  # ends in one copy to the host: synchronised
    return (time.perf_counter() - t0) * 1e3


def phase_graph_serving(edos_served, phdos_served):
    """34: Predictor through one CUDA graph per geometry against the eager
    forward (graphs=False) on the same weights: eDOS f32, phDOS f32, eDOS
    bf16 and eDOS with fuse_ln_attn, each on the 96-sample, 5-sample and
    mixed-bucket requests, the eager outputs worked out first so that the
    launches between reset and read are the graph path's alone (exactly two
    forwards a graph); graphs captured = distinct geometries, a second
    request of a captured geometry captures none; main_predict's graph path
    counted on its own; then eDOS and phDOS
    samples/s graph against eager in turns and the latency of 20 five-sample
    requests. Returns (launch counts by path, the predictors by case, the
    readings)."""
    served = {"edos": edos_served, "phdos": phdos_served}
    requests = {
        "edos": edos_served["requests"],
        "phdos": {**phdos_served["requests"], "16 mixed": [
            s for pair in zip(
                synthetic_phdos_samples(10, seed=2, min_atoms=2, max_atoms=6),
                synthetic_phdos_samples(6, seed=3, min_atoms=20, max_atoms=30))
            for s in pair] + synthetic_phdos_samples(4, seed=4)}}
    paths, predictors = {}, {}
    for label, task, kw in GRAPH_CASES:
        s = served[task]
        graph = Predictor.from_torch(s["weights"], device="cuda", **s["kw"],
                                     **kw)
        eager = Predictor.from_torch(s["weights"], device="cuda", graphs=False,
                                     **s["kw"], **kw)
        check(graph.graphs is not None and eager.graphs is None,
              f"{label}: graph/eager predictors")
        fused = bool(kw.get("fuse_ln_attn"))
        oracle = {name: eager.predict(samples)
                  for name, samples in requests[task].items()}
        # the graph path alone between reset and read: its wrappers count
        # at each geometry's warm-up and capture, never at a replay
        reset_launches()
        shapes, got = set(), {}
        for name, samples in requests[task].items():
            got[name] = graph.predict(samples)
            shapes |= group_shapes(samples)
            check(graph.graph_count == len(shapes),
                  f"{label} {name}: {graph.graph_count} graphs for "
                  f"{len(shapes)} geometries")
        path = (f"{task}_serving{'_bf16' if 'bf16' in label else ''}"
                f"{'_fused' if fused else ''}_graph")
        paths[path] = read_launches()
        want = serving_launches(task, 2 * graph.graph_count, fused)
        print(f"graph-served {label}: {graph.graph_count} graphs, launches "
              f"{paths[path]} (2 forwards a graph: warm-up and capture)")
        check(paths[path] == want, f"{label}: graph path launches "
                                   f"{paths[path]}, expected {want}")
        for name in requests[task]:
            how = same_or_close(f"{label} {name} graph vs eager", got[name],
                                oracle[name])
            print(f"graph-served {label} request {name}: {how} against "
                  f"eager")
        if not kw:  # the entry point a user calls, graph-served by default
            out = os.path.join(os.path.dirname(s["request_path"]),
                               f"{task}_graph_preds.npz")
            big = requests[task]["96"]
            reset_launches()
            main_predict.main([
                "--task", task, "--torch_state_dict", s["weights"],
                "--input", s["request_path"], "--output", out, "--layers",
                str(LAYERS), "--transformer", str(T_LAYERS), "--hidden",
                str(HIDDEN), "--batch_size", str(BATCH), "--device", "cuda"])
            paths[f"{path}_cli"] = read_launches()
            want = serving_launches(task, graph_forwards(big))
            check(paths[f"{path}_cli"] == want,
                  f"{label} main_predict launches {paths[f'{path}_cli']}, "
                  f"expected {want}")
            with np.load(out) as z:
                how = same_or_close(f"{label} main_predict", z["dos"],
                                    oracle["96"])
            print(f"graph-served {label} through main_predict, 96 samples: "
                  f"{how} against eager; launches {paths[f'{path}_cli']}")
        captured = graph.graph_count
        graph.predict(requests[task]["96"])
        check(graph.graph_count == captured,
              f"{label}: a second request of captured geometries captured "
              f"{graph.graph_count - captured} more graphs")
        predictors[label] = {"graph": graph, "eager": eager,
                             "requests": requests[task]}

    readings = {}
    for task in ("edos", "phdos"):
        p = predictors[task]
        rates = {"graph": [], "eager": []}
        for name in ("eager", "graph", "graph", "eager") * 2 + ("eager",
                                                               "graph"):
            rates[name].append(serving_rate(p[name], p["requests"]["96"]))
        short = p["requests"]["5 (short batch)"]
        latency = {name: sorted(request_ms(p[name], short)
                                for _ in range(20))
                   for name in ("graph", "eager")}
        readings[task] = {"rates": rates, "latency_ms": latency}
        print(f"{task} serving samples/s, 96-sample request, batch {BATCH}, "
              f"f32, median (least-most) of 5 readings taken in turns in one "
              f"process: graph-served {spread(rates['graph'])}, eager "
              f"{spread(rates['eager'])} on {CARD}")
        for name, ms in latency.items():
            print(f"{task} 5-sample request latency, {name}, 20 requests: "
                  f"median {statistics.median(ms):.3f} ms, p90 "
                  f"{ms[17]:.3f} ms (least {ms[0]:.3f}, most {ms[-1]:.3f}) "
                  f"on {CARD}")
    return paths, predictors, readings


def phase_graph_replays(predictors, readings):
    """34, profiled (after 16): the kernels of each case's 5-sample request
    (a replay for each of its atom buckets) by name from torch.profiler,
    which must be exactly 3 #1 and 6 #3 (or #5), phDOS also 3 #6, a replay,
    and no backward kernel;
    then the device's busy share of the 96-sample request, graph-served and
    eager: device time over the wall time of the same profiled call (and,
    beside it, over phase 34's unprofiled median wall time).
    Returns {case: {kernel: launches a replay}}."""
    from torch.profiler import ProfilerActivity, profile

    per_replay = {}
    for label, task, kw in GRAPH_CASES:
        graph = predictors[label]["graph"]
        short = predictors[label]["requests"]["5 (short batch)"]
        before = graph.graph_count
        for _ in range(3):  # a profile now and then comes back empty
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph.predict(short)
                torch.cuda.synchronize()
            names = {}
            for name, _ in device_events(prof):
                name = name.split("::")[-1]
                names[name] = names.get(name, 0) + 1
            if names:
                break
        check(graph.graph_count == before, f"{label}: the profiled request "
                                           f"captured a graph")
        replays = expected_batches(short)
        total = {k: sum(names.get(n, 0) for n in v)
                 for k, v in CALL_KERNELS.items()}
        got = {k: v / replays for k, v in total.items()}
        attn = "fused_attention_ln" if kw.get("fuse_ln_attn") else \
            "fused_attention"
        want = dict.fromkeys(CALL_KERNELS, 0)
        want.update({"fused_mp_edge": LAYERS, attn: 3 * T_LAYERS})
        if task == "phdos":
            want["batched_segment_sum"] = LAYERS
        backward = sum(names.get(n, 0) for n in BACKWARD_KERNELS)
        print(f"graph replays, {label}, 5 samples in {replays} batches: "
              f"launches a replay {got} (torch.profiler kernel names), "
              f"backward kernels {backward}; every device activity: "
              f"{names}")
        check(got == want, f"{label}: a replay launched {got}, expected "
                           f"{want}")
        check(backward == 0, f"{label}: a replay launched {backward} "
                             f"backward kernels")
        per_replay[label] = {k: v // replays for k, v in total.items()}
    for task in ("edos", "phdos"):
        p = predictors[task]
        big = p["requests"]["96"]
        for name in ("graph", "eager"):
            unprofiled = len(big) / statistics.median(
                readings[task]["rates"][name]) * 1e3
            p[name].predict(big)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                p[name].predict(big)  # ends in a copy to the host
                wall = (time.perf_counter() - t0) * 1e3
            device = sum(ms for _, ms in device_events(prof))
            ops = sum(1 for _ in device_events(prof))
            check(device > 0, f"{task} {name}: the profile shows no device "
                              f"time")
            busy = readings[task].setdefault("busy", {})
            busy[name] = device / wall
            busy[f"{name}, over the unprofiled median wall"] = (
                device / unprofiled)
            print(f"{task} 96-sample request, {name}: wall {wall:.3f} ms and "
                  f"device {device:.3f} ms over {ops} device activities of "
                  f"the same profiled call, busy {100 * device / wall:.1f}%; "
                  f"over phase 34's unprofiled median wall "
                  f"{unprofiled:.3f} ms {100 * device / unprofiled:.1f}% on "
                  f"{CARD}")
    return per_replay


# the forward kernels' torch.library ops on the training path and the
# wrappers their CUDA implementations are: (module, op, wrapper)
OP_WRAPPERS = (("fused_mp", "fused_mp_edge_op", "_fused_mp_edge_fwd"),
               ("attention", "attention_fwd_op", "fused_attention_fwd"),
               ("segment", "segment_sum_op", "_segment_sum_kernel"))


def swap_ops(replace) -> list:
    """Point the autograd Functions' op names at ``replace(module, op,
    wrapper)``; returns what restores them."""
    import importlib

    saved = []
    for mod, op, wrapper in OP_WRAPPERS:
        m = importlib.import_module(f"dostransformer_tpu_torch.ops.{mod}")
        saved.append((m, op, getattr(m, op)))
        setattr(m, op, replace(m, op, wrapper))
    return saved


def restore_ops(saved) -> None:
    for m, op, f in saved:
        setattr(m, op, f)


def phase_op_dispatch():
    """34, a record: what the ops' torch.library dispatch costs the eager
    train step, which no graph covers. Host microseconds a call of each op
    against its wrapper called straight, on the arguments of the op's first
    call in an eDOS / phDOS train step (200 calls a reading, five readings
    each in turns; the host's issue time, the card not waited for); then
    train samples/s (batch 8, batches on the card) with the autograd
    Functions calling the ops against calling the wrappers straight, four
    readings each in turns in one process."""
    args = {}

    def record(m, op, wrapper):
        f = getattr(m, op)

        def call(*a):
            args.setdefault(op, (getattr(m, wrapper), f, a))
            return f(*a)
        return call

    trainers, batches = {}, {}
    for task in ("edos", "phdos"):
        learnable = (synthetic_edos_learnable if task == "edos"
                     else synthetic_phdos_learnable)
        batches[task] = [b.to("cuda") for b in
                         GraphLoader(learnable(80, seed=0), BATCH)]
        trainers[task] = Trainer(build_model(
            task, layers=LAYERS, t_layers=T_LAYERS, hidden=HIDDEN,
            device="cuda", generator=torch.Generator().manual_seed(2)),
            clamp_targets=task == "edos", eval_clamp=task == "edos")
        saved = swap_ops(record)
        try:
            trainers[task].train_step(batches[task][0])
        finally:
            restore_ops(saved)
    check(sorted(args) == sorted(op for _, op, _ in OP_WRAPPERS),
          f"the train steps reached the ops {sorted(args)}")
    out = {"host_us_a_call": {}, "train_rates": {}}
    for op, (direct, via_op, a) in args.items():
        us = {"op": [], "direct": []}
        for name in ("op", "direct", "direct", "op") * 2 + ("op", "direct"):
            fn = via_op if name == "op" else direct
            torch.cuda.synchronize()
            with torch.no_grad():  # as inside the autograd Functions
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(*a)
                us[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        out["host_us_a_call"][op] = us
        print(f"{op}: host us a call, median (least-most) of 5 readings of "
              f"200 calls in turns: through the op {spread(us['op'])}, the "
              f"wrapper straight {spread(us['direct'])} on {CARD}")
    for task, trainer in trainers.items():
        rates = {"op": [], "direct": []}
        for name in ("op", "direct", "direct", "op") * 2:
            saved = swap_ops(lambda m, op, wrapper: getattr(m, wrapper)) \
                if name == "direct" else []
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches[task]:
                    trainer.train_step(b)
                torch.cuda.synchronize()
            finally:
                restore_ops(saved)
            rates[name].append(len(batches[task]) * BATCH
                               / (time.perf_counter() - t0))
        out["train_rates"][task] = rates
        print(f"{task} training samples/s (hidden {HIDDEN}, batch {BATCH}, "
              f"f32, batches on the card, {len(batches[task])} steps a "
              f"reading, median (least-most) of 4 readings in turns): the "
              f"Functions through the ops {spread(rates['op'])}, through "
              f"the wrappers straight {spread(rates['direct'])} on {CARD}")
    return out


def exported_ops(path) -> dict:
    """The ``dostpu`` ops of an exported program, by op name."""
    counts = {}
    program = torch.export.load(os.path.join(path, "forward.pt2"))
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("dostpu."):
            counts[name.split(".")[1]] = counts.get(name.split(".")[1], 0) + 1
    return counts


EXPORT_PROBE = """
import json, sys
import numpy as np
from dostransformer_tpu_torch.cli import main_predict
dos = main_predict.main(sys.argv[1:])
print(json.dumps({"modules": sorted(
    m for m in sys.modules
    if m.startswith(("dostransformer_tpu_torch.models",
                     "dostransformer_tpu_torch.train", "jax"))
    or m == "dostransformer_tpu" or m.startswith("dostransformer_tpu."))}))
"""


def phase_export(edos_served, phdos_served, workdir):
    """35: main_predict --export from a checkpoint (eDOS, phDOS), then
    main_predict --from_exported in a fresh process: its predictions equal
    the live Predictor's at the artifact's geometry, it imports no module of
    models/ or train/, the program holds 3 fused-MP and 6 attention ops
    (phDOS also 3 segment sums); the artifact served in this process eagerly
    (exact launches a batch) and through its graph; an artifact exported on
    the CPU served on the card (move_to_device_pass). Returns (launch counts
    by path, the eDOS artifact's directory)."""
    from dostransformer_tpu_torch.serve import ExportedPredictor
    from dostransformer_tpu_torch.train.checkpoint import CheckpointManager

    paths, artifacts = {}, {}
    for task, s in (("edos", edos_served), ("phdos", phdos_served)):
        model = build_model(task, layers=LAYERS, t_layers=T_LAYERS,
                            hidden=HIDDEN)
        model.load_state_dict(torch.load(s["weights"]))
        ckpt = os.path.join(workdir, f"{task}_ckpt")
        CheckpointManager(ckpt).save(1, model, wait=True)
        art = os.path.join(workdir, f"{task}_artifact")
        shape = ["--layers", str(LAYERS), "--transformer", str(T_LAYERS),
                 "--hidden", str(HIDDEN), "--batch_size", str(BATCH)]
        io = ["--input", s["request_path"], "--device", "cuda"]
        t0 = time.perf_counter()
        check(main_predict.main(["--task", task, "--checkpoint_dir", ckpt,
                                 "--export", art, "--output",
                                 os.path.join(workdir, "unused.npz"),
                                 *shape, *io]) is None,
              f"{task}: --export returned predictions")
        seconds = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(art, f))
                   for f in os.listdir(art))
        ops = exported_ops(art)
        want = {"fused_mp_edge_fwd": LAYERS, "attention_fwd": 3 * T_LAYERS}
        if task == "phdos":
            want["segment_sum"] = LAYERS
        print(f"{task} artifact: {size / 2**20:.2f} MiB ({size} bytes; the "
              f"weights {nbytes(*model.state_dict().values())} bytes) in "
              f"{sorted(os.listdir(art))}, exported in {seconds:.1f} s, "
              f"dostpu ops {ops}")
        check(ops == want, f"{task} artifact holds dostpu ops {ops}, "
                           f"expected {want}")
        with open(os.path.join(art, "serving_meta.json")) as f:
            meta = json.load(f)
        check(meta["device"] == "cuda:0" and meta["dtype"] == "float32",
              f"{task} artifact meta {meta}")

        out = os.path.join(workdir, f"{task}_exported.npz")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.abspath(__file__))}
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_PROBE, "--from_exported", art,
             "--input", s["request_path"], "--output", out, "--device",
             "cuda"],
            capture_output=True, text=True, env=env, timeout=600)
        check(proc.returncode == 0, f"{task} --from_exported failed:\n"
                                    f"{proc.stdout}\n{proc.stderr}")
        imported = json.loads(proc.stdout.strip().splitlines()[-1])["modules"]
        print(f"{task} --from_exported in a fresh process: imported of "
              f"models/, train/, jax and the JAX package: {imported}")
        check(imported == [], f"{task} --from_exported imported {imported}")
        samples = s["requests"]["96"]
        live = Predictor.from_checkpoint(ckpt, device="cuda", **s["kw"])
        want_dos = live.predict(samples, bucketed=False)
        with np.load(out) as z:
            how = same_or_close(f"{task} --from_exported vs the live "
                                f"Predictor", z["dos"], want_dos)
        print(f"{task} --from_exported against the live Predictor at the "
              f"artifact's geometry: {how}")

        # in this process: eagerly (exact launches), then through its graph
        eager = ExportedPredictor(art, device="cuda", graphs=False)
        reset_launches()
        got = eager.predict(samples)
        n = math.ceil(len(samples) / BATCH)
        counts = read_launches()
        want_l = launch_counts(fused_mp_edge=LAYERS * n,
                               fused_attention=3 * T_LAYERS * n,
                               batched_segment_sum=LAYERS * n
                               if task == "phdos" else 0)
        how = same_or_close(f"{task} exported eager", got, want_dos)
        print(f"{task} artifact served eagerly: {n} batches, launches "
              f"{counts}; {how}")
        check(counts == want_l, f"{task} exported eager launches {counts}, "
                                f"expected {want_l}")
        reset_launches()
        graphed = ExportedPredictor(art, device="cuda")
        how = same_or_close(f"{task} exported graph",
                            graphed.predict(samples), want_dos)
        counts = paths[f"{task}_serving_exported"] = read_launches()
        check(graphed.graph_count == 1, f"{task}: the artifact's one "
                                        f"geometry took "
                                        f"{graphed.graph_count} graphs")
        want_l = serving_launches(task, 2)  # the warm-up and the capture
        check(counts == want_l, f"{task} exported graph launches {counts}, "
                                f"expected {want_l}")
        print(f"{task} artifact served through its graph: {how}; launches "
              f"{counts}")
        artifacts[task] = art

    # exported on the CPU, served on the card
    s = edos_served
    cpu = Predictor.from_torch(s["weights"], device="cpu", **s["kw"])
    art = os.path.join(workdir, "edos_artifact_cpu")
    short = s["requests"]["5 (short batch)"]
    cpu.export(art, short)
    moved = ExportedPredictor(art, device="cuda")
    live = Predictor.from_torch(s["weights"], device="cuda", **s["kw"])
    how = same_or_close("CPU-exported artifact on the card",
                        moved.predict(short), live.predict(short,
                                                           bucketed=False))
    print(f"eDOS artifact exported on the CPU, served on the card "
          f"(move_to_device_pass): {how}")
    return paths, artifacts["edos"]


def http_post(port, path, body, length=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    if length is None:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
    else:  # a declared length and no body
        conn.putrequest("POST", path)
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def phase_http(edos_served, artifact, workdir):
    """36: main_serve on 127.0.0.1:0 in a thread, from a checkpoint and
    from the artifact, each at --coalesce_ms 0 and 2: /healthz; 8 client
    threads x 10 requests of 1-12 samples, every response against a direct
    predict of the same samples (1e-5 of the largest value) with its ids;
    an empty body 400, an oversized one 413, an unknown path 404;
    requests/s and p50/p99 latency. Returns (launch counts by path, the
    readings)."""
    import io
    import threading

    from dostransformer_tpu_torch.cli import main_serve
    from dostransformer_tpu_torch.train.checkpoint import CheckpointManager

    s = edos_served
    model = build_model("edos", layers=LAYERS, t_layers=T_LAYERS,
                        hidden=HIDDEN)
    model.load_state_dict(torch.load(s["weights"]))
    ckpt = os.path.join(workdir, "ckpt")
    CheckpointManager(ckpt).save(1, model, wait=True)
    pool = synthetic_edos_samples(64, seed=7)
    rng = np.random.RandomState(7)
    bodies = []
    for _ in range(80):
        picked = [pool[i] for i in rng.choice(len(pool), rng.randint(1, 13),
                                              replace=False)]
        buf = io.BytesIO()
        save_samples(buf, picked)
        bodies.append((picked, buf.getvalue()))
    # where a request's host time goes, one request at a time: the body's
    # decode, the predictor (graph-served, geometries captured), the
    # response's encode (what the server's threads do around the lock)
    from dostransformer_tpu_torch.data.io import load_samples

    direct = Predictor.from_torch(s["weights"], device="cuda", **s["kw"])
    for picked, _ in bodies:
        direct.predict(picked)
    split = {"decode": [], "predict": [], "encode": []}
    for picked, body in bodies:
        t0 = time.perf_counter()
        got = load_samples(io.BytesIO(body))
        t1 = time.perf_counter()
        dos = direct.predict(got)
        t2 = time.perf_counter()
        np.savez_compressed(io.BytesIO(), dos=dos, sample_id=np.asarray(
            [p.sample_id for p in got]), mp_id=np.asarray(
            [p.mp_id for p in got]))
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(1e3 * dt)
    split = {k: statistics.median(v) for k, v in split.items()}
    print(f"HTTP request parts, one at a time, median over the 80 bodies: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" on {CARD}")
    sources = {"checkpoint": ["--task", "edos", "--checkpoint_dir", ckpt,
                              "--example", s["request_path"], "--layers",
                              str(LAYERS), "--transformer", str(T_LAYERS),
                              "--hidden", str(HIDDEN)],
               "artifact": ["--from_exported", artifact]}
    reset_launches()
    readings, graphs = {}, 0
    for source, argv in sources.items():
        for coalesce in ("0", "2"):
            server = main_serve.build_server(
                [*argv, "--port", "0", "--coalesce_ms", coalesce,
                 "--batch_size", str(BATCH), "--device", "cuda"])
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                import http.client

                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                health = json.loads(resp.read())
                conn.close()
                check(resp.status == 200 and health == {
                    "status": "ok", "batch_size": BATCH},
                    f"{source}: /healthz {resp.status} {health}")
                results, latency = {}, []

                def client(k):
                    for j in range(10):
                        i = 10 * k + j
                        t0 = time.perf_counter()
                        results[i] = http_post(port, "/predict", bodies[i][1])
                        latency.append(time.perf_counter() - t0)

                t0 = time.perf_counter()
                clients = [threading.Thread(target=client, args=(k,))
                           for k in range(8)]
                for c in clients:
                    c.start()
                for c in clients:
                    c.join()
                wall = time.perf_counter() - t0
                bad = {"empty": http_post(port, "/predict", b"")[0],
                       "oversized": http_post(port, "/predict", None,
                                              length=300 << 20)[0],
                       "unknown path": http_post(port, "/nope", b"x")[0]}
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            check(bad == {"empty": 400, "oversized": 413,
                          "unknown path": 404},
                  f"{source} coalesce {coalesce}: statuses {bad}")
            worst = 0.0
            for i, (picked, _) in enumerate(bodies):
                status, data = results[i]
                check(status == 200, f"{source}: request {i} got {status} "
                                     f"{data[:200]!r}")
                with np.load(io.BytesIO(data)) as z:
                    got, ids = z["dos"], list(z["sample_id"])
                check(ids == [p.sample_id for p in picked],
                      f"{source}: request {i} ids {ids}")
                want = server.predictor.predict(picked)
                err = float(np.abs(got - want).max())
                limit = GRAPH_REL * max(1.0, float(np.abs(want).max()))
                check(err <= limit, f"{source} coalesce {coalesce}: request "
                                    f"{i} differs from a direct predict by "
                                    f"{err:.3e}")
                worst = max(worst, err)
            graphs += server.predictor.graph_count
            latency.sort()
            key = f"{source}, coalesce_ms {coalesce}"
            readings[key] = {"requests_per_s": len(bodies) / wall,
                             "p50_ms": 1e3 * statistics.median(latency),
                             "p99_ms": 1e3 * latency[int(0.99 * len(latency))]}
            print(f"HTTP {key}: 8 clients x 10 requests of 1-12 samples, "
                  f"{readings[key]['requests_per_s']:.1f} requests/s, p50 "
                  f"{readings[key]['p50_ms']:.2f} ms, p99 "
                  f"{readings[key]['p99_ms']:.2f} ms; max abs diff against "
                  f"a direct predict {worst:.3e}; statuses {bad}; "
                  f"{getattr(server.predictor, 'graph_count', None)} graphs "
                  f"on {CARD}")
    readings["request parts, ms"] = split
    # the servers' predictors are graph-served: their wrappers count two
    # forwards a graph (warm-up and capture) and none at a replay
    launches, want = read_launches(), serving_launches("edos", 2 * graphs)
    print(f"HTTP servers: {graphs} graphs captured in all, launches "
          f"{launches}")
    check(launches == want, f"HTTP servers' launches {launches}, expected "
                            f"{want}")
    return {"edos_serving_http": launches}, readings


def kernel_resources(so, wanted) -> dict:
    """Registers a thread and stack bytes (a nonzero stack means spills or
    local arrays) of the compiled kernels whose mangled names contain one of
    ``wanted``, read from the built library with the toolkit's
    ``cuobjdump -res-usage``. Empty when the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-res-usage", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    found = {}
    for name, reg, stack in re.findall(
            r"Function (\S+?):\s*\n\s*REG:(\d+) STACK:(\d+)", text):
        for label, part in wanted.items():
            if part in name:
                found[label] = {"registers": int(reg), "stack_bytes": int(stack)}
    return found


START = time.perf_counter()
# the card's name and power limit as nvidia-smi prints them, set by main()
# for the phases that print their numbers beside it
CARD = ""


def stamp(what: str) -> None:
    """Seconds since the script started, after ``what``."""
    print(f"[{time.perf_counter() - START:.1f} s] {what}")


def main():
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: takes no arguments, got {sys.argv[1:]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products accumulate in f32 (the contract the CPU versions and
    # the JAX package keep); cuBLAS may otherwise reduce split-K partials in
    # bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); name and power limit from nvidia-smi:")
    print(smi)

    _, seconds = kernels.build(force=True)
    kernels.library()
    stamp("build")
    print(f"built {len(kernels.SOURCES)} CUDA sources for sm_90a in "
          f"{seconds:.1f} s")
    # the attention kernels at the flagship width (D = 256 = 32 x 8), each
    # a template over the operand type
    bf16_mangled = "I13__nv_bfloat16"
    resources = kernel_resources(kernels.library_path(), {
        k: f"{k}IfLi{HIDDEN // 32}ELb1E"
        for names in ATTENTION_KERNELS.values() for k in names
        if "sliced" not in k} | {
        f"{k}<bf16>": f"{k}{bf16_mangled}Li{HIDDEN // 32}ELb1E"
        for k in ("attn_fwd_kernel", "dq_kernel", "dkv_kernel")})
    print(f"attention kernels at D={HIDDEN}, registers a thread and stack "
          f"bytes (cuobjdump -res-usage): {json.dumps(resources)}")
    mp_resources = kernel_resources(kernels.library_path(), MP_KERNELS)
    print(f"message-passing kernels, registers a thread and stack bytes: "
          f"{json.dumps(mp_resources)}")
    ln_resources = kernel_resources(kernels.library_path(), LN_KERNELS)
    print(f"LayerNorm-lever kernels, registers a thread and stack bytes: "
          f"{json.dumps(ln_resources)}")
    for name, res in ln_resources.items():
        check(res["stack_bytes"] == 0,
              f"{name} has a stack of {res['stack_bytes']} bytes")
    for d in (1, 31, 33, 50, 512, 513, 544, 1000, 1024, 2049):
        nc, slices = ctypes.c_int(), ctypes.c_int()
        kernels.library().dostpu_attention_plan(d, nc, slices)
        check((nc.value, slices.value) == attention_plan(d),
              f"ops.attention.attention_plan({d}) is {attention_plan(d)}, "
              f"the library's ({nc.value}, {slices.value})")
    sliced = kernel_resources(kernels.library_path(), SLICED_KERNELS)
    print(f"attention kernels above D=512 (16 column groups a slice), "
          f"registers a thread and stack bytes: {json.dumps(sliced)}")
    resources.update(sliced)

    results = phase_kernels(dev)
    results.update(phase_backward_kernels(dev))
    stamp("phases 3, 3b")
    results.update(phase_segment_sum(dev))
    phdos_results = phase_phdos_kernels(dev)
    ln_results, ln_phdos = phase_attention_ln_kernel(dev)
    results.update(ln_results)
    phdos_results.update(ln_phdos)
    results.update(phase_layer_norm_bwd_kernel(dev))
    widths = phase_attention_widths(dev)
    wide_mp = phase_wide_mp(dev)
    # 21: #1 and #2 at the widths the generic forms were redesigned for
    for name, rows in phase_repaired_mp(dev).items():
        wide_mp[name].update(rows)
    stamp("phases 3c-3h, 21")
    # 27: the bf16 forms of #1, #3 and #6
    for name, row in phase_bf16_kernels(dev).items():
        results[name].update(row)
    stamp("phase 27")
    # 30: the bf16 forms of #2 and #4
    for name, row in phase_bf16_backward_kernels(dev).items():
        results[name].update(row)
    stamp("phase 30")

    paths, losses = {}, {}
    with tempfile.TemporaryDirectory() as root:
        def subdir(name):
            path = os.path.join(root, name)
            os.makedirs(path)
            return path

        paths["edos_serving"], rate, edos_served = phase_main_path(
            subdir("edos_serving"))
        print(f"{rate:.1f} samples/s serving the 96-sample request (eDOS "
              f"flagship, batch {BATCH}, f32) on {smi}")
        paths["edos_training"], losses["edos"] = phase_training_path(
            subdir("edos_training"))
        paths["edos_training_host"] = phase_host_loader(
            subdir("edos_training_host"))
        print("card vs CPU, 3 eDOS train steps:")
        phase_card_vs_cpu("edos")
        rate = phase_train_rate("edos")
        print(f"{rate:.1f} samples/s training (eDOS flagship, batch {BATCH}, "
              f"f32, 20 steps, host collation and upload included) on {smi}")
        stamp("phases 4-8")

        paths["phdos_serving"], rate, phdos_served = phase_phdos_serving(
            subdir("phdos_serving"))
        print(f"{rate:.1f} samples/s serving the 96-sample request (phDOS "
              f"flagship, batch {BATCH}, f32) on {smi}")
        paths["phdos_training"], losses["phdos"] = phase_phdos_training(
            subdir("phdos_training"))
        print("card vs CPU, 3 phDOS train steps:")
        phase_card_vs_cpu("phdos")
        rate = phase_train_rate("phdos")
        print(f"{rate:.1f} samples/s training (phDOS flagship, batch {BATCH}, "
              f"f32, 20 steps, host collation and upload included) on {smi}")

        # 17-20: the h1024 eDOS flagship and the narrow phDOS path
        paths["edos1024_serving"], rates = phase_h1024_serving(
            subdir("edos1024_serving"))
        print(f"h1024 eDOS serving samples/s, 96-sample request, batch "
              f"{BATCH}, f32, median (least-most) of 5 calls: "
              f"{spread(rates)} on {smi}")
        paths["edos1024_training"] = phase_h1024_training(
            subdir("edos1024_training"))
        print("card vs CPU, 1 h1024 eDOS train step at batch 2:")
        phase_card_vs_cpu("edos", hidden=WIDE, samples=2, batch=2)
        paths["edos1024_training_levers"] = phase_h1024_levers()
        rates = [phase_train_rate("edos", steps=5, hidden=WIDE)
                 for _ in range(4)]
        print(f"h1024 eDOS training samples/s (batch {BATCH}, f32, 5 steps, "
              f"host collation and upload included), median (least-most) "
              f"of 4 readings: {spread(rates)} on {smi}")
        paths["phdos50_serving"], paths["phdos50_training"] = (
            phase_narrow_phdos(subdir("phdos50")))
        stamp("phases 9-12, 17-20")

        # 22-23: the training runtime through the entry points
        paths["edos_training_ckpt"], paths["edos_serving_ckpt"] = (
            phase_checkpoint_resume(subdir("checkpoints")))
        paths["phdos_training_remat"] = phase_runtime_flags(
            subdir("runtime_flags"))

        # 25-26: the baselines, and the data layer from CIF records
        rates = phase_baselines()
        print(f"baseline training samples/s (hidden {HIDDEN}, batch {BATCH},"
              f" f32, 10 steps, host collation and upload included): "
              + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
              + f" on {smi}")
        paths.update(phase_baseline_paths(subdir("baselines")))
        paths["edos_training_data"], rates = phase_data_layer(
            subdir("data_layer"))
        stamp("phases 22-26")

        # 13: serving with the LayerNorm fused into the attention forward
        for task, served in (("edos", edos_served), ("phdos", phdos_served)):
            paths[f"{task}_serving_fused"], rates = phase_fused_serving(
                task, served, subdir(f"{task}_serving_fused"))
            print(f"{task} serving samples/s, 96-sample request, batch "
                  f"{BATCH}, f32, median (least-most) of 6 readings taken in "
                  f"turns in one process: fuse_ln_attn "
                  f"{spread(rates['fused'])}, unfused "
                  f"{spread(rates['unfused'])} on {smi}")

        stamp("phase 13")
        # 28-29: bf16 serving, the flagships and h1024
        bf16_errs = {}
        for task, served, fused in (("edos", edos_served, False),
                                    ("edos", edos_served, True),
                                    ("phdos", phdos_served, False)):
            name = f"{task}_serving_bf16{'_fused' if fused else ''}"
            paths[name], rates, bf16_errs[name] = phase_bf16_serving(
                task, served, fused)
            print(f"{task} serving samples/s{' (fuse_ln_attn)' if fused else ''}"
                  f", 96-sample request, batch {BATCH}, median (least-most) of "
                  f"4 readings taken in turns in one process: bf16 "
                  f"{spread(rates['bf16'])}, f32 {spread(rates['f32'])} on "
                  f"{smi}")
        paths["edos1024_serving_bf16"], h1024 = phase_h1024_bf16_serving(
            subdir("edos1024_bf16"))
        for what, unit in (("device_ms", "ms of device time a forward at "
                                         "batch 8 (CUDA events, median of 20)"),
                           ("rates", "samples/s, 96-sample request")):
            print(f"h1024 eDOS serving, {unit}, two readings each taken in "
                  f"turns: bf16 {spread(h1024[what]['bfloat16'])}, f32 "
                  f"{spread(h1024[what]['float32'])} on {smi}")
        bf16_errs["edos1024_serving_bf16"] = h1024["max_rel_err"]
        stamp("phases 28-29")

        # 31: bf16 train steps, card against CPU
        for path, task, kw in (
                ("edos_training_bf16_steps", "edos", {}),
                ("phdos_training_bf16_steps", "phdos", {}),
                ("edos_training_bf16_levers", "edos",
                 dict(fuse_ln_attn=True, ln_lp=True)),
                ("edos1024_training_bf16_steps", "edos",
                 dict(hidden=WIDE, samples=2, batch=2))):
            print(f"card vs CPU, bf16 train steps: {path}")
            paths[path] = phase_bf16_card_vs_cpu(task, **kw)
        # 32: the training CLIs in bf16, resume, best/ served in bf16
        paths.update(phase_bf16_cli(subdir("bf16_cli")))
        stamp("phases 31-32")

        # 34-36: serving through CUDA graphs, exported programs and HTTP
        got, graph_predictors, graph_readings = phase_graph_serving(
            edos_served, phdos_served)
        paths.update(got)
        graph_readings["op dispatch"] = phase_op_dispatch()
        stamp("phase 34")
        got, artifact = phase_export(edos_served, phdos_served,
                                     subdir("export"))
        paths.update(got)
        stamp("phase 35")
        got, http_readings = phase_http(edos_served, artifact, subdir("http"))
        paths.update(got)
        stamp("phase 36")

        # 14: training with both levers on, against the unfused runs above
        trainings = (("edos", phase_training_path),
                     ("phdos", phase_phdos_training))
        for task, phase in trainings:
            name = f"{task}_training_levers"
            paths[name], got = phase(subdir(name), LEVERS_ENV)
            print(f"{task} epoch losses, both levers {got} vs levers off "
                  f"{losses[task]} (rtol {LOSS_RTOL})")
            check(all(abs(a - b) <= LOSS_RTOL * abs(b)
                      for a, b in zip(got, losses[task])),
                  f"{task}: epoch losses with both levers {got} differ from "
                  f"the unfused run's {losses[task]}")
            print(f"card vs CPU, 3 {task} train steps, both levers:")
            phase_card_vs_cpu(task, fuse_ln_attn=True, ln_lp=True)

    # 15: what the levers do to the training rate
    for task in ("edos", "phdos"):
        rates = phase_lever_train_rates(task)
        print(f"{task} training samples/s (batch {BATCH}, f32, 20 steps, "
              f"median (least-most) of 4 readings taken in turns): levers "
              f"off {spread(rates['off'])}, ln_lp only "
              f"{spread(rates['ln_lp'])}, fuse_ln_attn + ln_lp "
              f"{spread(rates['both'])} on {smi}")

    # 24: the device-resident dataset against the host loader
    for task, rates in phase_pipeline_rates().items():
        print(f"{task} training samples/s (batch {BATCH}, f32, one epoch of "
              f"96 samples a reading, median (least-most) of 4 readings "
              f"taken in turns): device-resident dataset "
              f"{spread(rates['device'])}, host loader "
              f"{spread(rates['host'])} on {smi}")

    stamp("phases 14, 15, 24")
    # 33: bf16 against f32 train rates and device time a step (a record)
    for label, r in phase_bf16_train_rates().items():
        print(f"{label} training samples/s (batch {BATCH}, batches on the "
              f"card, two readings each taken in turns): bf16 "
              f"{spread(r['rates']['bfloat16'])}, f32 "
              f"{spread(r['rates']['float32'])} on {smi}")
        if "device_ms" in r:
            print(f"{label} device ms a train step (CUDA events, median of "
                  f"6, two readings each taken in turns): bf16 "
                  f"{spread(r['device_ms']['bfloat16'])}, f32 "
                  f"{spread(r['device_ms']['float32'])} on {smi}")
    stamp("phase 33")
    # 16: where the device time goes (last: the profiler slows what follows)
    phase_profile()
    phase_sub_kernels()
    stamp("phase 16")
    # 34, profiled: kernels a replay, busy share
    per_replay = phase_graph_replays(graph_predictors, graph_readings)
    stamp("phase 34 (profiled)")
    print(f"serving readings (phases 34, 36): {json.dumps(graph_readings)} "
          f"{json.dumps(http_readings)} on {smi}")

    csrc, tpu = "dostransformer_tpu_torch/csrc", "dostransformer_tpu"
    sources = {
        "fused_mp_edge": (f"{csrc}/fused_mp.cu", f"{tpu}/ops/fused_mp.py:79"),
        "fused_attention": (f"{csrc}/attention.cu",
                            f"{tpu}/ops/attention.py:80"),
        "fused_mp_edge_bwd": (f"{csrc}/fused_mp_bwd.cu",
                              f"{tpu}/ops/fused_mp.py:112"),
        "fused_attention_bwd": (f"{csrc}/attention_bwd.cu",
                                f"{tpu}/ops/attention.py:317"),
        "batched_segment_sum": (f"{csrc}/segment_sum.cu",
                                f"{tpu}/ops/segment.py:98"),
        "fused_attention_ln": (f"{csrc}/attention_ln.cu",
                               f"{tpu}/ops/attention.py:474"),
        "layer_norm_bwd": (f"{csrc}/layernorm_bwd.cu",
                           f"{tpu}/nn/layernorm.py:99")}
    # where each kernel must run, and nowhere else: every path its model,
    # mode and lever setting reach
    for path, counts in paths.items():
        task, _, mode, variant, _ = re.fullmatch(
            r"(edos|phdos)(\d*)_(serving|training)(_levers|_fused|_host|"
            r"_ckpt|_remat|_data|_graphnetwork|_mlp2|_bf16(?:_fused|_levers"
            r"|_data|_ckpt|_steps)?)?(_graph(?:_cli)?|_exported|_http)?",
            path).groups()
        if variant in ("_graphnetwork", "_mlp2"):
            want = baseline_step_launches(task, variant[1:])
        else:
            want = step_launches(task, variant in (
                "_levers", "_fused", "_bf16_fused", "_bf16_levers"))
        if mode == "serving":
            want.update(dict.fromkeys(BACKWARD, 0))
        for name in sources:
            if want[name]:
                check(counts[name] > 0, f"{name} never launched on {path}")
            else:
                check(counts[name] == 0, f"{name} launched {counts[name]} "
                                         f"times on {path}")
    rows = []
    for name, r in results.items():
        # the one path that launches six of the seven kernels; the unfused
        # attention forward, which it replaces, on its lever-off twin
        on = ("phdos_training" if name == "fused_attention"
              else "phdos_training_levers")
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1], "launches": paths[on][name],
               "launches_path": on,
               "max_abs_err": max(r["err"],
                                  phdos_results.get(name, {"err": 0.0})["err"]),
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
               "bound_by": ("bytes" if r["bytes_ms"] >= r["ops_ms"]
                            else "operations"),
               "library_ms": r["library_ms"],
               "launches_by_path": {p: c[name] for p, c in paths.items()}}
        check(row["launches"] > 0, f"{name} never launched on {on}")
        # the bf16 paths (serving and training): their launches, and the
        # serving paths' model errors
        row["launches_bf16"] = {p: c[name] for p, c in paths.items()
                                if "_bf16" in p}
        check(any(row["launches_bf16"].values()),
              f"{name}: no bf16 path launched it")
        if name in ("fused_mp_edge", "fused_attention", "batched_segment_sum"):
            row["bf16_serving_max_rel_err"] = bf16_errs
        if name in CALL_KERNELS:
            row["launches_per_replay"] = {
                label: counts[name] for label, counts in per_replay.items()}
        if name in ATTENTION_KERNELS:
            row["resources"] = {k: v for k, v in resources.items()
                                if k.split("<")[0] in ATTENTION_KERNELS[name]}
        if name in ("fused_attention_ln", "layer_norm_bwd"):
            row["resources"] = {
                k: v for k, v in ln_resources.items()
                if k.startswith("attn_ln") == (name == "fused_attention_ln")}
        if name.startswith("fused_mp_edge"):
            row["resources"] = mp_resources
            row["max_abs_err"] = max(row["max_abs_err"],
                                     r["generic_width"]["err"],
                                     *(w["err"] for w in
                                       wide_mp[name].values()))
            row["by_hidden"] = {
                label: {k: w[k] for k in ("ms", "plain_ms", "err",
                                          *MP_EXTRAS) if k in w}
                | {"bound_ms": max(w["bytes_ms"], w["ops_ms"])}
                for label, w in wide_mp[name].items()}
        if name in widths:
            for key, w in widths[name].items():
                row[key] = w
                if key.startswith("d"):
                    row["max_abs_err"] = max(row["max_abs_err"], w["err"])
        for key in ("unfused_ms", "ms_by_rows", "bf16_max_rel_err",
                    "ms_bf16", "ms_f32", "plain_ms_bf16", "bound_ms_bf16",
                    "library_ms_bf16", "bf16_by_shape",
                    "ms_other_aliasing", "ms_raw_form_by_rows",
                    "library_ms_by_rows",
                    "ms_two_tensors", "ms_op", "ms_no_stats", "by_shape",
                    "generic_width", *MP_EXTRAS):
            if key in r:
                row[key] = r[key]
        if name in phdos_results:
            ph = phdos_results[name]
            row.update(ms_phdos=ph["ms"], plain_ms_phdos=ph["plain_ms"],
                       bound_ms_phdos=max(ph["bytes_ms"], ph["ops_ms"]),
                       library_ms_phdos=ph["library_ms"])
            for key in ("unfused_ms", "ms_bf16", "ms_two_tensors", "ms_op",
                        "ms_no_stats", "by_shape"):
                if key in ph:
                    row[f"{key}_phdos"] = ph[key]
        rows.append(row)
    check(len(rows) == len(KERNELS), f"{len(rows)} kernel rows")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
