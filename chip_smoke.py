"""GPU smoke run of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py    # every phase, the kernels and device lines

Phases, in order; any failure exits non-zero:

  1. card     -- print the card's name and power limit; no CUDA -> exit 1
  2. build    -- compile every kernel under src/repro_torch/csrc (one nvcc
                 per source, all at once) into build/kernels; log the
                 registers, spills and shared memory per kernel
  3. parity   -- each kernel and mode against its plain PyTorch version on
                 the card, at the main paths' shapes: qdense at M = 4 (0
                 ulps); the tensor-core tile (M > 8) for every decode
                 (ternary, int4, nf4 at group 64, int8 at mx's 32) at
                 M = 9, 17, 31, 132, 256 and N = 1040 (a ragged last
                 block column), bf16 and f32 x, dynamic and static
                 exponent, bias, no activation, silu, gelu, relu, and
                 packed_qmm for all five formats at those M, 0 ulps, the
                 unfused site equal to the fused one at M = 132, 256; the
                 count of IMMA (int8 tensor-core) instructions in the built
                 qdense libraries, > 0; flash
                 kv_bf16 at decode; kv_int8 and kv_mx at decode (B 4,
                 T 1024); all three formats at a prefill chunk (S 256 from
                 512, T 1024), the in-chunk tail (S = T = 256) and ragged
                 chunks (S 31, 60, 132, 188, 255 from starts 77 and 600,
                 global and a 300-token window), 5e-5; decode at valid 1
                 and at full T in every format: 5e-5, two calls
                 bit-identical, one CUDA launch a call (profiler trace);
                 fused ternary, int4, nf4 and mx (the int8 decode at group
                 32) on every site of a layer at M = 1, 3, 4, 5, 8 (the
                 GEMV; mx at K = 12288 also M = 7) and 17/64/256 (the
                 tile), lm_head at M = 1, 3, 4, 5, 8, packed_qmm for all
                 five formats at M = 1, 4, 8, 256, quantize_rows
                 (bf16, f32; NaN, exact-edge, zero and subnormal rows), all
                 0 ulps, and the unfused site equal to the fused one;
                 flash_attention on every shape of the reference's tests and
                 at full width (BH 128, S = T = 1024, hd 128), causal and not,
                 float32 at 2e-5 and bf16 at 3e-2 and one bf16 ulp per
                 element, and the masked first row; the full-width bf16
                 causal call goes through the kernels API as its users call
                 it (repro_torch.kernels.flash_attention), with its launches
                 counted
  4. main     -- serve the full-width qwen3-8b (ternary PTQ, group 64, all
                 36 layers, bf16, random weights from a seeded generator,
                 quantized on the card one site at a time) through the
                 lockstep engine over kv_bf16: 4 slots, 8 requests,
                 16-token prompts, 16 greedy tokens each; every launch
                 count must be > 0; then 8 more ticks under torch.profiler
                 (device busy share, time by kernel); a 2-layer full-width
                 twin checks the kernel path against the plain path over 6
                 steps
  5. staged   -- the same model, all 36 layers, through the StagedEngine
                 over kv_int8 with flash prefill and decode: 4 slots,
                 max_len 1024, 256-token prefill chunks, decode priority,
                 8 requests with prompts of 1 to 900 tokens, 16 greedy
                 tokens each; every kernel mode of the path must launch;
                 generate ticks and one 256-token chunk under
                 torch.profiler; then the same traffic at 4 layers over
                 kv_mx and over kv_bf16; 2-layer full-width twins check
                 prefill_chunk at ragged starts and 4 decode steps, kernel
                 path against plain path, for kv_int8 and kv_mx (float32:
                 logits 5e-3, equal argmax; the PTQ model: qdense leg
                 bit-identical, picks within the observed difference)
  6. formats  -- the paper's 4-bit weights: int4 (group 64), all 36 layers,
                 through the StagedEngine over kv_int8 with the same traffic
                 (traced chunk and ticks); nf4 (group 64) and mx (group 32)
                 at 4 layers; every site fused=False at 4 layers for
                 ternary, int4 and nf4 (quantize_rows and packed_qmm only,
                 no fused launch), its tokens equal to the fused run's on
                 the same weights; the 2-layer int4 PTQ twin (qdense leg
                 bit-identical)
  7. serve    -- the launcher (repro_torch.launch.serve main(argv)) at full
                 width: qwen3-8b, 36 layers, ternary group 64, kv_int8, both
                 flash flags, 4 slots, max_len 1024, 8 requests, 256-token
                 chunks, through --engine staged and --engine lockstep; each
                 one's tokens equal those of the same engine built here
                 directly on the same seed and prompts; the same launcher
                 under seeded --chaos with --retries 3 (finished requests
                 keep the fault-free tokens, others fail with the retry
                 budget spent); the armed containment matrix at 4 layers
                 through both engines (every tick fault kind on the float
                 model over kv_bf16, the logit kinds on the PTQ model over
                 kv_int8): one victim, the others bit-identical
  8. artifact -- the paper's deliverable as users deploy it, at full width
                 (qwen3-8b, 36 layers, ternary group 64, bf16, kv_int8, both
                 flash flags): float weights made on the card from the seeded
                 generator, calibrated on the launcher's --calibrate 2
                 batches (every site gets a static activation exponent),
                 saved as a packed artifact under build/ (its MB, save s,
                 free disk), then both engines cold-started with
                 from_artifact (cold-start s) serve the launcher's 8 requests
                 with the in-memory calibrated model's tokens, through
                 fused_qmm and flash_attend (launch counts > 0); the
                 directory is deleted; a 2-layer full-width
                 quantize_and_plan(init) must equal init_quantized bit for
                 bit
  9. families -- the dense siblings at their published widths, ternary
                 group 64, kv_int8, both flash flags, random seeded weights
                 quantized on the card: parity first -- qdense at K = 3840
                 (gemma3's d_model = 7 x 512 + 256: a ragged last k-tile) on
                 wq, wk and gate at M = 1, 4, 8, 17, 256 and its int8
                 lm_head at M = 4, and at K = 49152 (qwen1.5-110b's down
                 projection) at M = 4 and 8, every decode, fused and packed,
                 0 ulps; flash_attend at head_dim 240 in all three formats
                 (decode, a 256-token chunk, ragged chunks; global and a
                 300-token window), 5e-5; flash_attention at hd 240, float32
                 2e-5 and bf16 one ulp -- then gemma3-12b, all 48 layers
                 (5 local : 1 global, window 1024), through the StagedEngine
                 (4 slots, max_len 2048, 256-token chunks, 8 prompts of 1 to
                 1900 tokens, so the local layers mask); the lockstep
                 engine on the same prompts at 6 layers (5 local + 1
                 global; cut from 48 for time: ~1,920 ticks of one
                 prompt token each took 417 s at 48 layers) beside the
                 staged engine on that model; its 6-layer float32 twin
                 (5 local + 1 global) at T 2048, flash against the oracle
                 within 5e-3; qwen1.5-110b, 20 of 80 layers (cut for
                 time: the script's limit; 40 until the mesh phase), seeded non-zero
                 q / k / v biases, through the StagedEngine on the
                 launcher's 8 requests (6-token prompts: the GEMV only),
                 with GEMV launches at K = 49152; and
                 phi4-mini-3.8b through the launcher, --engine staged and
                 --engine lockstep.  Each model's load s, peak memory,
                 tokens/s and launches are logged; it is freed before the
                 next
 10. moe      -- the MoE family at its published widths, ternary group 64,
                 kv_int8, both flash flags, random seeded weights quantized
                 on the card one site at a time: parity first -- the
                 expert-batched packed_qmm in all five formats at grok's
                 gate / up (E 8, K 6144, N 32768) and down (K 32768, N
                 6144), C 8 (the expert GEMV over all, none, one and a
                 decode tick's routed experts) and C 80 (the tile), and
                 arctic's (E 128, K 7168 / 4864) at C 8, with the capacity
                 buffer's zero rows, 0 ulps and equal int32 bits;
                 quantize_rows at the decode tick's, the prefill chunk's and
                 the (E * C, K) buffers' shapes with edge, zero and
                 subnormal rows; the int8 router at N 8 and 128, fused and
                 packed, M 1, 4, 8, 256; one grok layer's moe_layer at a
                 decode step and a 256-token chunk, kernels against their
                 plain versions on the card, bit for bit, one quantize_rows
                 and one packed call a site, and the decode step under
                 torch.cuda.set_sync_debug_mode (no host synchronisation in
                 the kernel wrappers) -- then grok-1-314b at 8 of 64 layers
                 (~11 GB packed; 64 layers would take ~84 GB, and 24 and
                 16 -- the depths until this phase's time went to the
                 vlm_ssm and the mesh phases -- fit too) through the
                 StagedEngine and
                 the lockstep engine on the launcher's traffic (8 requests,
                 6-token prompts, 8 new tokens; staged vs lockstep token
                 differences logged, not gated) and staged on prompts of
                 600, 257, 31 and 6 tokens (the tile); arctic-480b at 2 of
                 35 layers (~7 GB packed; 4 until the mesh phase) staged on the launcher's
                 traffic, with 3 packed launches a layer a forward over its
                 128 experts.  Load s, packed and peak GB, tokens/s and
                 launches are logged
 11. vlm_ssm  -- the VLM, SSM and hybrid families at their published widths,
                 ternary group 64, kv_int8, random seeded weights quantized on
                 the card one site at a time: parity first -- qdense at
                 qwen2-vl's down (K = 29568 = 57 x 512 + 384: a ragged last
                 k-tile) and gate / up (N = 29568), falcon-mamba's x_proj (N
                 288) and dt_proj (K 256, shorter than one k-tile, with its
                 bias), zamba2's bc_proj (N 128), at M = 1, 4, 8, 17, 256,
                 every decode, fused and packed, 0 ulps; flash_attend at
                 head_dim 112 (zamba2: G = 1) in all three formats (decode
                 at T 1024, a 256-token chunk, ragged chunks; global and a
                 300-token window), decode at G = 8 (qwen2-vl) and the
                 vision prefill's in-chunk tail (S = T = 1040), 5e-5 -- then
                 qwen2-vl-72b, 40 of 80 layers (cut for the mesh phase's
                 time): one vision prefill through
                 api.prefill (1024 seeded patch embeddings + 16 tokens,
                 M-RoPE positions from build_mrope_positions, both flash
                 flags) and 16 greedy decode steps, then both engines on the
                 launcher's traffic (8 requests, 6-token prompts, 8 new
                 tokens); falcon-mamba-7b (64 layers) and zamba2-7b (81
                 layers, flash decode at hd 112) through both engines on the
                 launcher's traffic and one 64-token prompt through the
                 staged engine's per-token prefill fallback; staged vs
                 lockstep token differences logged, not gated; the twins:
                 qwen2-vl 2 layers float32 (the vision prefill, then flash
                 decode against its plain version; the C13 gap between the
                 prefill routes logged), falcon-mamba 2 layers float32 (decode
                 steps against the sequence form) and ternary (the qdense
                 kernels against their plain versions), zamba2 7 layers
                 float32 (flash decode at hd 112 against the dense oracle),
                 5e-3 and equal argmax.  Load s, packed and peak GB, tokens/s
                 and launches are logged (flash hd 112 > 0)
 12. encdec   -- the enc-dec family at its published widths: whisper-base, all
                 6 + 6 layers (d_model 512, 8 heads of 64, d_ff 2048, vocab
                 51865 padded to 51968, 1500 audio frames), ternary group 64,
                 kv_int8, both flash flags, random seeded weights quantized on
                 the card one site at a time: parity first -- fused_qmm at
                 wq (K 512, one k-tile), up (N 2048, bias) and down (K 2048,
                 bias) at M = 1, 4, 8, 17, 256, 1500, 6000 and the int8
                 lm_head (N 51968) at M <= 256, 0 ulps; flash_attend at
                 head_dim 64, G = 1, in all three formats (decode at T 448
                 with ragged fills, a 64-token chunk, ragged chunks, global
                 and a 100-token window, the prefill's in-chunk tail), 5e-5
                 -- then the audio path through the model API (encode s;
                 api.prefill of 4 x 1500 seeded frame embeddings and
                 4-token prompts; 64 greedy decode steps at max_len 448, ms
                 a step), one decode step's launches by route (GEMV, tile
                 and flash at hd 64 each > 0) and 4 steps under
                 torch.profiler (device busy share), both engines on the
                 launcher's traffic against zero frames (ROADMAP Queue C14;
                 token differences logged, not gated), and the 2 + 2-layer
                 float32 twin (flash decode vs the dense oracle, 5e-3,
                 equal argmax)
 13. qat      -- quantization-aware training's forward and backward on the
                 card (plain torch, as the reference's QAT path reaches no
                 Pallas kernel): train_loss and backward() with float32
                 master weights, ternary group 64 under the paper's
                 policy, a 2 x 256 batch, on whisper-base at full depth
                 (seeded frames) and qwen3-8b at its published widths cut to
                 4 of 36 layers (float32 weights and gradients at 36 layers
                 are ~64 GB); the loss finite, every master weight's
                 gradient equal bit for bit to the gradient at its
                 fake-quantized weight; one full-width site's fake-quantized
                 weight on the card against the CPU's (differing values
                 counted); s and peak GB
 14. train    -- the training loop on the card (plain torch: the reference's
                 training path reaches no Pallas kernel): whisper-base at
                 full depth, float32 masters, QAT ternary group 64, DFP-8
                 moments, 2 x 256 tokens with seeded frames, 8 Trainer steps
                 with a checkpoint every 4; a new Trainer restores step 4
                 (step 8's checkpoint removed) and trains 4 more, its losses
                 equal to the straight run's within rtol 1e-4 (bit-equal
                 ones counted); qwen3-8b at its published widths and all 36
                 layers (a shallower depth only if 36 do not fit, the cut
                 logged), bf16 masters, QAT ternary group 64, DFP-8 moments,
                 remat, 3 steps (losses finite; s a step, the optimizer's
                 share by CUDA events, init and step peak GB), the float32
                 moments' reckoning logged, not run; 4 layers one step with
                 remat on and off (peak GB); the paper's recovery on the
                 benchmark's tiny LM (fp 100 steps, one-shot ternary N64
                 PTQ, 60 steps each of qat, ttq and inq): each must end
                 below PTQ's loss, the reference's values logged beside
 15. timings  -- kernel, plain version, library call (a yardstick the port
                 never calls) and the bound from bytes and operations
                 (flash: at the bf16 tensor-core peak, the float32 one
                 logged beside it); qdense per site and per layer at M = 4
                 and 256 for every format, mx's int8 decode at group 32
                 included (fused_qmm_int8_layer, fused_qmm_int8_prefill);
                 the families' new shapes: a gemma3 ragged-K site (wq) at
                 M = 4 and 256, the K = 49152 GEMV, flash_attend kv_int8 at
                 hd 240 (decode, 256-token chunk) and flash_attention at
                 hd 240; the expert-batched packed_qmm (ternary) at grok's
                 gate and down, C 8 and 80, and arctic's gate, C 8, every
                 expert routed, and at a decode tick's routed experts
                 (grok's gate 5 of 8, arctic's 8 of 128; library: torch.bmm
                 over the bf16-dequantized (E, K, N) weights), quantize_rows
                 over the four (E * C, K) buffers of a decode tick, and the
                 int8 router site at N 8, M = 4; the vlm_ssm phase's shapes:
                 flash_attend kv_int8 at hd 112 (decode, B 4, T 1024, 32 x 32
                 heads), qwen2-vl's down projection (K 29568), falcon-mamba's
                 x_proj and dt_proj (torch.addmm with the bias), M = 4;
                 the encdec phase's shapes: wq (K 512) at M = 4, 1500 and
                 6000, the int8 lm_head at N 51968, M = 4, flash_attend
                 kv_int8 at hd 64 (decode, B 4, T 448); the int8 route
                 (uses_int8_loop) on lm_head and mx's seven layer sites,
                 the int8 loop against the GEMV on the same call, logged
 16. lm_heads -- every family's int8 lm_head at its published widths on
                 the int8 loop (csrc/qmm_gemv8.cuh): fused at M = 1, 4, 8
                 (bf16 dynamic exponent, float32 static, bf16 bias + silu)
                 and packed, 0 ulps (arctic's and zamba2's plans split
                 their k-tiles); the rows no earlier phase times at M = 4

 17. mesh     -- serving on several GPUs (models/spmd.py) on the one card:
                 every kernel at grok-1's shard shapes for model = 2 and 4
                 (wq N 3072 / 1536, wk / wv N 512 / 256, the int8 lm_head
                 N 65536 / 32768 on the int8 loop, the router N 4, the
                 expert stacks E 4 / 2 at C 8) at M = 1, 3, 4, 5, 8, 0 ulps
                 against its plain version and against the whole site's
                 columns or experts, and flash decode over 4 / 2 of 8 kv
                 heads (G 6, hd 128) planned for the whole call's pairs,
                 5e-5 against the plain version and bit for bit the whole
                 call's heads, each timed at M = 4; grok-1-314b at its
                 published widths, 2 layers, ternary group 64, kv_int8,
                 both flash flags: the parent writes the dp=1,ep=2 sharded
                 artifact and serves both engines in one process, two
                 spawned ranks share the card over gloo (each reading only
                 its own shard files) and serve the launcher's traffic,
                 their first decode steps' and a 64-token chunk's logits
                 bit-equal to the single process and their tokens equal;
                 per rank: resident GB, collective bytes a call, launches
                 by kernel, which collectives gloo takes on CUDA tensors;
                 the launcher under torch.distributed.run on one NCCL rank
                 with --mesh dp=1,ep=1, its tokens the single-process
                 launcher's; a rank's packed weights at full depth
                 reckoned from the rules with nothing allocated (grok-1 64
                 layers at ep=4 and 8, arctic-480b 35 layers at ep=8)

The traced ticks and chunks log device busy time, kernels per call and the
qdense GEMV's device time and launches per tick.  ``--only mesh`` runs the
build and the mesh phase alone (for iterating on it; no kernels line).

The last two lines are the `kernels` JSON and the device JSON.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (logged beside the flash bounds)
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (the flash kernels' arithmetic)
SEED = 0
ARCH = "qwen3-8b"
GROUP = 64
SLOTS, MAX_LEN, N_REQ, PROMPT, NEW = 4, 256, 8, 16, 16
FLASH_SHAPE = dict(b=4, t=256, kh=8, g=4, hd=128)  # decode: 4 slots, max_len 256
FLASH_VALID = [1, 77, 200, 256]  # ragged fill levels
QDENSE_SITES = [  # (name, K, N, decode, act) -- one layer's sites, then lm_head
    ("wq", 4096, 4096, "ternary", None), ("wk", 4096, 1024, "ternary", None),
    ("wv", 4096, 1024, "ternary", None), ("wo", 4096, 4096, "ternary", None),
    ("gate", 4096, 12288, "ternary", "silu"), ("up", 4096, 12288, "ternary", None),
    ("down", 12288, 4096, "ternary", None), ("lm_head", 4096, 152064, "int8", None),
]
LAYER_SITES = QDENSE_SITES[:-1]  # the 7 projections of one block
FORMATS = ("ternary", "int4", "int8", "nf4", "mx")
M_ROWS = SLOTS  # rows per decode-tick projection
PREFILL_ROWS = (17, 64, 256)  # prefill-chunk projections (the tensor-core tile)
GEMV_ROWS = (1, 3, 4, 5, 8)  # the GEMV's parity rows: one slot, ragged fills, the tick's 4, a full 8
GEMV_LONG_ROWS = 7  # mx at K = 12288: the int8 decode's longest rows
TILE_ROWS = (9, 17, 31, 132, 256)  # the tile's parity: one past the GEMV bound, ragged row blocks, a full chunk
TILE_SITE = (4096, 1040)  # K, N of the tile's parity site: N leaves a ragged last block column
TILE_FORMATS = ("ternary", "int4", "nf4", "mx")  # one per decode: 2-bit, 4-bit table (two), int8 at group 32
# the staged path: 4 slots over a 1024-token kv_int8 cache, 256-token chunks;
# prompt lengths cross every chunk boundary and the 32-token kv_mx block
STAGED_SLOTS, STAGED_MAX_LEN, STAGED_CHUNK = 4, 1024, 256
STAGED_PROMPTS = [1, 31, 255, 256, 257, 513, 700, 900]
SMALL_DEPTH = 4  # layers of the kv_mx and kv_bf16 staged runs
FLASH_DECODE = dict(b=4, t=1024, kh=8, g=4, hd=128)  # the staged decode tick
FLASH_DECODE_VALID = [1, 300, 777, 1024]
FLASH_PREFILL = dict(b=1, s=256, start=512, t=1024, kh=8, g=4, hd=128)  # one chunk
# ragged chunk lengths (prime, the 900-token prompt's last chunk of 132) from
# ragged starts of two batch rows, global and windowed
FLASH_RAGGED_S = (31, 60, 132, 188, 255)
FLASH_RAGGED = dict(b=2, t=1024, kh=8, g=4, hd=128, starts=(77, 600), window=300)
SHORT = {"kv_bf16": "bf16", "kv_int8": "int8", "kv_mx": "mx"}
# standalone flash_attention: the reference's test shapes (bh, s, t, hd, bq, bk), then the
# full width: 4 sequences x 32 heads, S = T = 1024, hd 128
ATTN_TEST_SHAPES = [(4, 64, 64, 32, 32, 32), (2, 128, 128, 64, 64, 32), (3, 64, 128, 32, 64, 64),
                    (1, 256, 256, 16, 128, 128), (2, 64, 64, 32, 32, 32)]
ATTN_FULL = (128, 1024, 1024, 128)
ATTN_HEADS = 32  # BH 128 = 4 sequences x 32 heads
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# JSON row -> (kernel entry, mode); launches are counted per mode
MODES = {
    "fused_qmm_ternary": ("ternary", "m<=8"), "fused_qmm_ternary_prefill": ("ternary", "m>8"),
    "fused_qmm_int8": ("int8", "m<=8"), "fused_qmm_int8_layer": ("int8", "m<=8"),
    "fused_qmm_int8_prefill": ("int8", "m>8"),
    **{f"flash_attend_{SHORT[f]}{sfx}": ("flash", f"{f}/{mode}")
       for f in SHORT for sfx, mode in (("", "decode"), ("_prefill", "prefill"))},
    "fused_qmm_int4": ("int4", "m<=8"), "fused_qmm_int4_prefill": ("int4", "m>8"),
    "fused_qmm_nf4": ("nf4", "m<=8"), "fused_qmm_nf4_prefill": ("nf4", "m>8"),
    "packed_qmm_ternary": ("ternary_packed", None), "packed_qmm_int4": ("int4_packed", "m<=8"),
    "packed_qmm_int4_prefill": ("int4_packed", "m>8"), "packed_qmm_int8": ("int8_packed", None),
    "packed_qmm_nf4": ("nf4_packed", None),
    "quantize_rows": ("quantize_rows", "m<=8"), "quantize_rows_prefill": ("quantize_rows", "m>8"),
    "flash_attention": ("flash_attention", None),
}
FUSED_ROWS = [name for name in MODES if name.startswith("fused_qmm")]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------
def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false -- this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    if _imma_count() <= 0:
        raise SystemExit("build: the qdense libraries hold no IMMA instruction (the tile is not on the tensor cores)")


# ---------------------------------------------------------------------------
# 3. parity
# ---------------------------------------------------------------------------
def _qsite(k, n, fmt, gen, dev, group=GROUP):
    from repro_torch.quant.formats import quantize_weights

    w = torch.randn((k, n), generator=gen, device=dev) * k**-0.5
    return quantize_weights(w, group_size=group, fmt=fmt)  # mx pins its own group, 32


def _edge_rows(k, gen, dev, dtype):
    """4 rows: plain, one NaN, max exactly 127 * 2**-3, max one ulp above."""
    x = torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1
    x[1, 7] = float("nan")
    x[2, 11] = 127.0 * 2.0**-3
    above = torch.nextafter(torch.tensor(127.0 * 2.0**-3), torch.tensor(1e9)).item()
    if dtype == torch.bfloat16:  # one bf16 ulp above
        above = 127.0 * 2.0**-3 * (1 + 2.0**-7)
    x[3, 13] = above
    return x.to(dtype)


def _entry(fmt):
    """The format's fused kernel entry."""
    from repro_torch.quant.formats import get_format

    return get_format(fmt).fused_kernel


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.view(torch.int32).to(torch.int64)
    bi = b.view(torch.int32).to(torch.int64)
    ai = torch.where(ai < 0, -(2**31) - ai, ai)
    bi = torch.where(bi < 0, -(2**31) - bi, bi)
    return int((ai - bi).abs().max())


def phase_parity(dev) -> dict:
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.fused_qmm import fused_qmm_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {name: 0.0 for name in MODES}
    failures = []
    for name, k, n, decode, act in QDENSE_SITES:
        qt = _qsite(k, n, decode, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = _edge_rows(k, gen, dev, dtype)
            for static_e in (None, -4):
                kw = dict(group=GROUP, act=act, act_exponent=static_e)
                got = _entry(decode)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
                want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all())
                err = float((got - want).abs().max())
                ulps = _ulps(got, want)
                key = f"fused_qmm_{decode}"
                errs[key] = max(errs[key], err)
                ok = finite and ulps == 0  # bit-exact on every site
                log(f"parity qdense {name:7s} K={k:5d} N={n:6d} {decode:7s} x={str(dtype)[6:]:8s} "
                    f"static_e={static_e} act={act}: max_abs_err={err:.3e} ulps={ulps} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"qdense {name} {dtype} static_e={static_e}")
        del qt
    fs = FLASH_SHAPE
    for s in (1, 4):
        q = torch.randn((fs["b"], s, fs["kh"], fs["g"], fs["hd"]), generator=gen, device=dev)
        kc = torch.randn((fs["b"], fs["t"], fs["kh"], fs["hd"]), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((fs["b"], fs["t"], fs["kh"], fs["hd"]), generator=gen, device=dev).to(torch.bfloat16)
        valid = torch.tensor(FLASH_VALID, dtype=torch.int32, device=dev).reshape(-1, 1)
        q_start = torch.clamp(valid - s, min=0)
        win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
        for window in (None, 64):
            w = win if window is None else torch.tensor([[window]], dtype=torch.int32, device=dev)
            got = flash_attend(q, kc, vc, None, None, q_start, valid, w, fmt="kv_bf16")
            want = flash_attend_ref(q, kc, vc, None, None, q_start, valid, w, fmt="kv_bf16")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["flash_attend_bf16"] = max(errs["flash_attend_bf16"], err)
            ok = bool(torch.isfinite(got).all()) and err <= 5e-5
            log(f"parity flash S={s} window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash S={s} window={window}")
    failures += _parity_prefill_rows(dev, gen, errs)
    failures += _parity_packed_flash(dev, gen, errs)
    failures += _parity_formats(dev, gen, errs)
    attn_failures, attn_launches = _parity_flash_attention(dev, gen, errs)
    failures += attn_failures
    if failures:
        raise SystemExit(f"parity failed: {failures}")
    return errs, attn_launches


def _parity_prefill_rows(dev, gen, errs) -> list:
    """The tensor-core tile (M > 8) against the plain versions, 0 ulps: the
    fused site for every decode at TILE_ROWS, bf16 and float32 x, dynamic
    and static exponent, bias with no activation, silu, gelu, relu;
    packed_qmm for all five formats at TILE_ROWS; the unfused site equal
    to the fused one at M = 132 and 256; then the same at M = 17 and 132
    for each decode at the tile's other cluster lengths, 16 (mma k16,
    64-k stages, a 4-deep ring) and 128."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.quant import qdense
    from repro_torch.quant.formats import get_format

    failures = []
    k, n = TILE_SITE
    acts = [(None, None), (-4, "silu"), (None, "gelu"), (-4, "relu")]  # (static exponent, activation)

    def check(key, what, got, want):
        torch.cuda.synchronize()
        err, ulps = float((got - want).abs().max()), _ulps(got, want)
        if key:
            errs[key] = max(errs[key], err)
        ok = bool(torch.isfinite(got).all()) and ulps == 0
        if not ok:
            failures.append(what)
        return ok, ulps

    cases = [(fmt, GROUP, TILE_ROWS, fmt in TILE_FORMATS) for fmt in FORMATS]  # (format, group, rows, fused)
    cases += [(fmt, g, (17, 132), True) for g in (16, 128) for fmt in ("ternary", "int4", "int8")]
    for fmt, group, rows, fused in cases:
        decode = _decode_of(fmt)
        qt = _qsite(k, n, fmt, gen, dev, group)
        bias = torch.randn((n,), generator=gen, device=dev)
        fused_key = f"fused_qmm_{decode}_prefill"
        for m in rows:
            summary, before = [], len(failures)
            if fused:
                for dtype in (torch.bfloat16, torch.float32):
                    x = _rows(m, k, gen, dev, dtype)
                    for static_e, act in acts:
                        kw = dict(group=qt.group_size, bias=bias, act=act, act_exponent=static_e)
                        got = _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
                        want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
                        ok, ulps = check(fused_key, f"tile fused {fmt} g={qt.group_size} M={m} {dtype} "
                                         f"static_e={static_e} act={act}", got, want)
                        summary.append(ulps)
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            got = get_format(fmt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
            want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
            _, ulps_p = check(f"packed_qmm_{decode}{'_prefill' if decode == 'int4' else ''}",
                              f"tile packed {fmt} g={qt.group_size} M={m}", got, want)
            same = "--"
            if m in (132, 256):
                x = _rows(m, k, gen, dev, torch.bfloat16)
                kw = dict(bias=bias, act="silu", backend="cuda")
                _, ulps_u = check(None, f"tile unfused == fused {fmt} g={qt.group_size} M={m}",
                                  qdense(x, qt, fused=False, **kw), qdense(x, qt, fused=True, **kw))
                same = f"{ulps_u} ulps"
            fused_note = f"fused max ulps {max(summary)} over {len(summary)} cases, " if summary else ""
            log(f"parity tile {fmt:7s} g={qt.group_size:3d} K={k} N={n} M={m:3d}: {fused_note}packed ulps {ulps_p}, "
                f"unfused vs fused {same} {'OK' if len(failures) == before else 'FAIL'}")
        del qt
    return failures


def _imma_count() -> int:
    """IMMA (int8 tensor-core) instructions in the built qdense libraries'
    SASS (cuobjdump --dump-sass)."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(os.path.dirname(_build._nvcc())), "bin", "cuobjdump")
    count = 0
    for name in ("fused_qmm", "packed_qmm"):
        sass = subprocess.run([cuobjdump, "--dump-sass", str(_build.lib_path(name))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        n = sum("IMMA" in line for line in sass.splitlines())
        log(f"sass {name}: {n} IMMA instructions")
        count += n
    return count


def _packed_cache(fmt, b, t, kh, hd, gen, dev):
    """A (B, T) cache of one layer filled by the port's quantize-on-write
    from random bf16 K/V."""
    from repro_torch.models import kv_cache

    c = kv_cache.get_kv_format(fmt).init((b,), t, kh, hd, torch.bfloat16, dev)
    kv = [(torch.randn((b, t, kh, hd), generator=gen, device=dev) * 2).to(torch.bfloat16) for _ in range(2)]
    kv_cache.write(fmt, c, kv[0], kv[1], 0)
    return c


def _flash_case(fmt, shape, gen, dev, *, s, starts, valid):
    """(q, cache leaves, q_start, valid, window) for one flash call."""
    c = _packed_cache(fmt, shape["b"], shape["t"], shape["kh"], shape["hd"], gen, dev)
    q = torch.randn((shape["b"], s, shape["kh"], shape["g"], shape["hd"]), generator=gen, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev).reshape(-1, 1)  # noqa: E731
    return q, c, i32(starts), i32(valid), i32([2**30])


def _flash_args(case):
    q, c, q_start, valid, win = case
    return (q, c["k"], c["v"], c.get("ke"), c.get("ve"), q_start, valid, win)


def _parity_packed_flash(dev, gen, errs) -> list:
    """Flash over kv_int8 / kv_mx at the staged decode shape, every format at
    one prefill chunk, and the in-chunk tail, kernel vs plain at 5e-5."""
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref

    fd, fp = FLASH_DECODE, FLASH_PREFILL
    cases = [(f, fd, 1, [v - 1 for v in FLASH_DECODE_VALID], FLASH_DECODE_VALID, w)
             for f in ("kv_int8", "kv_mx") for w in (None, 64)]
    cases += [(f, fp, fp["s"], [fp["start"]], [fp["start"] + fp["s"]], None) for f in SHORT]
    tail = dict(fp, t=fp["s"])  # the in-chunk tail: a chunk's own K/V, S = T = 256
    cases.append(("kv_bf16", tail, fp["s"], [0], [fp["s"]], None))
    failures = []
    for fmt, shape, s, starts, valid, window in cases:
        case = _flash_case(fmt, shape, gen, dev, s=s, starts=starts, valid=valid)
        if window is not None:
            case = case[:4] + (torch.tensor([[window]], dtype=torch.int32, device=dev),)
        args = _flash_args(case)
        got = flash_attend(*args, fmt=fmt)
        want = flash_attend_ref(*args, fmt=fmt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        key = f"flash_attend_{SHORT[fmt]}{'' if s == 1 else '_prefill'}"
        errs[key] = max(errs[key], err)
        ok = bool(torch.isfinite(got).all()) and err <= 5e-5
        what = "in-chunk tail" if shape is tail else ("decode" if s == 1 else "prefill chunk")
        log(f"parity flash {fmt} {what} B={shape['b']} S={s} T={shape['t']} start={starts} valid={valid} "
            f"window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash {fmt} {what} S={s} window={window}")
    return failures + _parity_ragged_flash(dev, gen, errs) + _parity_decode(dev, gen, errs)


def _parity_ragged_flash(dev, gen, errs) -> list:
    """Chunk lengths that the kernel's 64-row tiles do not divide, every
    format, from ragged starts, global and windowed, kernel vs plain at 5e-5."""
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref

    fr = FLASH_RAGGED
    failures = []
    for fmt in SHORT:
        for s in FLASH_RAGGED_S:
            case = _flash_case(fmt, fr, gen, dev, s=s, starts=list(fr["starts"]), valid=[a + s for a in fr["starts"]])
            for window in (None, fr["window"]):
                if window is not None:
                    case = case[:4] + (torch.tensor([[window]], dtype=torch.int32, device=dev),)
                args = _flash_args(case)
                got = flash_attend(*args, fmt=fmt)
                want = flash_attend_ref(*args, fmt=fmt)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                key = f"flash_attend_{SHORT[fmt]}_prefill"
                errs[key] = max(errs[key], err)
                ok = bool(torch.isfinite(got).all()) and err <= 5e-5
                log(f"parity flash {fmt} ragged chunk B={fr['b']} S={s} T={fr['t']} start={list(fr['starts'])} "
                    f"window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"flash {fmt} ragged S={s} window={window}")
    return failures


def _parity_decode(dev, gen, errs) -> list:
    """Decode at the staged tick's shape with every row at valid = 1 and
    every row at full T, every format: within 5e-5 of plain, two identical
    calls bit-identical, and one CUDA launch a call (profiler trace, and
    the wrapper's count of its launches; a trace that holds no device event
    at all, which CUPTI gives now and then -- at times three in a row -- on
    a call that ran, is taken again, up to ten traces)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref

    fd = FLASH_DECODE
    failures = []
    with profile(activities=[ProfilerActivity.CUDA]):  # the first session of a process may miss its kernels
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    for fmt in SHORT:
        for fill in (1, fd["t"]):
            valid = [fill] * fd["b"]
            args = _flash_args(_flash_case(fmt, fd, gen, dev, s=1, starts=[fill - 1] * fd["b"], valid=valid))
            first = flash_attend(*args, fmt=fmt)
            torch.cuda.synchronize()
            for trace in range(1, 11):  # a trace that holds no device event missed the call: trace it again
                before = flash_attend.launches
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    second = flash_attend(*args, fmt=fmt)
                    torch.cuda.synchronize()
                counted = flash_attend.launches - before
                n_launch = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
                if n_launch:
                    break
            want = flash_attend_ref(*args, fmt=fmt)
            torch.cuda.synchronize()
            err = float((first - want).abs().max())
            same = bool(torch.equal(first.view(torch.int32), second.view(torch.int32)))
            errs[f"flash_attend_{SHORT[fmt]}"] = max(errs[f"flash_attend_{SHORT[fmt]}"], err)
            ok = bool(torch.isfinite(first).all()) and err <= 5e-5 and same and n_launch == 1 and counted == 1
            log(f"parity flash {fmt} decode B={fd['b']} T={fd['t']} valid={fill}: max_abs_err={err:.3e} (atol 5e-5), "
                f"two calls bit-identical {same}, CUDA launches a call {n_launch} (want 1; trace {trace}), "
                f"counted {counted} {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash {fmt} decode valid={fill}: max_abs_err {err:.3e}, bit-identical {same}, "
                                f"launches {n_launch} in trace {trace}, counted {counted}")
    return failures


def _rows(m, k, gen, dev, dtype, edge=True):
    """(m, k) activations: random rows; with ``edge``, the first (up to) 4
    rows are ``_edge_rows``' and, where m > 5, row 4 is all zero and row
    5's maximum is subnormal."""
    x = torch.randn((m, k), generator=gen, device=dev) * 0.1
    if edge:
        x[:M_ROWS] = _edge_rows(k, gen, dev, dtype).float()[:m]
    if edge and m > 5:
        x[4] = 0.0
        x[5] = torch.randn((k,), generator=gen, device=dev) * 1e-40
    return x.to(dtype)


def _zero_subnormal_rows(k, gen, dev, dtype):
    """4 rows: all zero, a subnormal maximum, then two plain rows."""
    x = torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1
    x[0] = 0.0
    x[1] = torch.randn((k,), generator=gen, device=dev) * 1e-40
    return x.to(dtype)


def _decode_of(fmt: str) -> str:
    return "int8" if fmt == "mx" else fmt  # mx runs the int8 kernels


def _parity_formats(dev, gen, errs) -> list:
    """This slice's modes against their plain versions at 0 ulps: fused
    ternary, int4, nf4 and mx on every site of one layer (M = 4 in bf16 and
    f32, dynamic and static exponent; the tile at M = 17/64/256 in bf16,
    the site's activation); packed_qmm for all five
    formats and the unfused site (quantize_rows -> packed_qmm -> exponents
    -> activation) against the fused kernel on wq, gate and down at M = 4
    and 256; quantize_rows in bf16 and f32 at (4, 4096) and (256, 12288)."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain
    from repro_torch.quant import qdense
    from repro_torch.quant.formats import get_format

    failures = []

    def check(key, what, got, want):
        torch.cuda.synchronize()
        ulps = _ulps(got, want)
        err = float((got - want).abs().max())
        if key:
            errs[key] = max(errs[key], err)
        ok = bool(torch.isfinite(got).all()) and ulps == 0
        log(f"parity {what}: max_abs_err={err:.3e} ulps={ulps} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    for fmt in TILE_FORMATS:
        decode = _decode_of(fmt)
        for name, k, n, _, act in LAYER_SITES:
            qt = _qsite(k, n, fmt, gen, dev)
            cases = [(M_ROWS, dt, se) for dt in (torch.bfloat16, torch.float32) for se in (None, -4)]
            cases += [(m, (torch.bfloat16, torch.float32)[i % 2], (None, -4)[i // 2 % 2])
                      for i, m in enumerate(m for m in GEMV_ROWS if m != M_ROWS)]
            cases += [(GEMV_LONG_ROWS, torch.bfloat16, None)] if fmt == "mx" and k == 12288 else []
            cases += [(m, torch.bfloat16, None) for m in PREFILL_ROWS]
            for m, dtype, static_e in cases:
                x = _rows(m, k, gen, dev, dtype)
                kw = dict(group=qt.group_size, act=act, act_exponent=static_e)
                got = _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
                want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
                check(f"fused_qmm_{decode}{('_layer' if fmt == 'mx' else '') if m <= 8 else '_prefill'}",
                      f"qdense {name:7s} K={k:5d} N={n:5d} {fmt} M={m:3d} x={str(dtype)[6:]} static_e={static_e} "
                      f"act={act}", got, want)
            del qt
    name, k, n, decode, act = QDENSE_SITES[-1]  # lm_head, int8, at every GEMV row count
    qt = _qsite(k, n, decode, gen, dev)
    for i, m in enumerate(m for m in GEMV_ROWS if m != M_ROWS):
        x = _rows(m, k, gen, dev, (torch.bfloat16, torch.float32)[i % 2])
        kw = dict(group=qt.group_size, act=act, act_exponent=(None, -4)[i // 2 % 2])
        check("fused_qmm_int8", f"qdense {name} K={k:5d} N={n} int8 M={m:3d} x={str(x.dtype)[6:]} "
              f"static_e={kw['act_exponent']}", _entry(decode)(x, qt.packed, qt.scale_m, qt.scale_e, **kw),
              fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw))
    del qt
    for fmt in FORMATS:
        decode = _decode_of(fmt)
        for name, k, n, _, act in (LAYER_SITES[0], LAYER_SITES[4], LAYER_SITES[6]):  # wq, gate, down
            qt = _qsite(k, n, fmt, gen, dev)
            for m in (GEMV_ROWS[0], M_ROWS, GEMV_ROWS[-1], PREFILL_ROWS[-1]):
                x = _rows(m, k, gen, dev, torch.bfloat16)
                xq, _ = quantize_rows(x)
                got = get_format(fmt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
                want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)
                key = f"packed_qmm_{decode}{'_prefill' if decode == 'int4' and m > 8 else ''}"
                check(key, f"packed_qmm {name:7s} K={k:5d} N={n:5d} {fmt} M={m:3d}", got, want)
                kw = dict(act=act, backend="cuda")
                check(None, f"unfused == fused {name:7s} {fmt} M={m:3d} act={act}",
                      qdense(x, qt, fused=False, **kw), qdense(x, qt, fused=True, **kw))
            del qt
    for dtype in (torch.bfloat16, torch.float32):
        cases = [("(4, 4096) edge rows", _rows(M_ROWS, 4096, gen, dev, dtype)),
                 ("(4, 4096) zero/subnormal rows", _zero_subnormal_rows(4096, gen, dev, dtype)),
                 ("(256, 12288)", _rows(PREFILL_ROWS[-1], 12288, gen, dev, dtype))]
        for what, x in cases:
            q, e = quantize_rows(x)
            wq, we = quantize_rows_plain(x)
            torch.cuda.synchronize()
            same = torch.equal(q, wq) and torch.equal(e, we)
            err = float((q.float() - wq.float()).abs().max())
            key = "quantize_rows" if x.shape[0] <= 8 else "quantize_rows_prefill"
            errs[key] = max(errs[key], err)
            log(f"parity quantize_rows {what} x={str(dtype)[6:]}: mantissas and exponents "
                f"{'identical OK' if same else 'differ FAIL'} (max |dq| {err:.0f}; exponents {e[:6, 0].tolist()})")
            if not same:
                failures.append(f"quantize_rows {what} {dtype}")
    return failures


def _attn_inputs(shape, dtype, gen, dev):
    bh, s, t, hd = shape
    return [torch.randn((bh, n, hd), generator=gen, device=dev).to(dtype) for n in (s, t, t)]


def _bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger magnitude, less a
    1e-6 absolute allowance (the float32 sums both sides round from)."""
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)  # |x| in [2^(e-1), 2^e): 2^(e-8)
    return float(((got.float() - want.float()).abs() - 1e-6).clamp(min=0).div(ulp).max())


def _parity_flash_attention(dev, gen, errs) -> tuple:
    """flash_attention against its plain version: every shape of the
    reference's tests and the full width, causal and not, float32 (2e-5)
    and bf16 (3e-2, and at most one bf16 ulp apart per element: both sides
    sum in float32 and round once); the masked first row sees only v[0].
    The full-width bf16 causal call is the kernels API's main path, called
    as its users call it with the counts reset just before: (failures, the
    launches of that call)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    failures, launches = [], None
    cases = [((bh, s, t, hd), dict(block_q=bq, block_k=bk)) for bh, s, t, hd, bq, bk in ATTN_TEST_SHAPES]
    cases.append((ATTN_FULL, {}))
    for shape, blocks in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(shape, dtype, gen, dev)
            for causal in (True, False):
                main_path = shape == ATTN_FULL and dtype == torch.bfloat16 and causal
                if main_path:
                    _reset_counts()
                    got = kernels.flash_attention(q, k, v)
                    torch.cuda.synchronize()
                    launches = _read_counts()
                else:
                    got = flash_attention(q, k, v, causal=causal, **blocks)
                want = flash_attention_plain(q, k, v, causal=causal, **blocks)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                errs["flash_attention"] = max(errs["flash_attention"], err)
                ok = got.dtype == dtype and bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype]
                what = f"flash_attention BH={shape[0]} S={shape[1]} T={shape[2]} hd={shape[3]} {str(dtype)[6:]} causal={causal}"
                note = ""
                if dtype == torch.bfloat16:
                    ulps = _bf16_ulps(got, want)
                    ok = ok and ulps <= 1.0
                    note = f", {ulps:.2f} bf16 ulps (at most 1)"
                if main_path:
                    note += f"; kernels API call, launches {launches['flash_attention']}"
                log(f"parity {what}: max_abs_err={err:.3e} (atol {ATTN_TOL[dtype]}){note} {'OK' if ok else 'FAIL'}")
                if not ok:
                    failures.append(what)
            del q, k, v
    _require_launches(launches, ["flash_attention"], "the kernels API's flash_attention")
    q = torch.ones((1, 32, 16), device=dev)
    v = torch.arange(32, dtype=torch.float32, device=dev)[None, :, None] * torch.ones((1, 32, 16), device=dev)
    out = flash_attention(q, q.clone(), v, causal=True, block_q=16, block_k=16)
    torch.cuda.synchronize()
    ok = abs(float(out[0, 0, 0])) <= 1e-6 and bool(torch.isfinite(out).all())
    log(f"parity flash_attention masked first row: out[0, 0, 0] = {float(out[0, 0, 0]):.3e} (only v[0] = 0) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append("flash_attention masked first row")
    return failures, launches


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------
def _ptq_cfg(n_layers=None, quant=None, arch=ARCH, **over):
    """The full-width PTQ config of ``arch``: ternary group 64 unless
    ``quant`` (a dict of QuantConfig fields) says otherwise."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig

    q = dict(dict(w_bits=2, group_size=GROUP, mode="ptq", backend="auto"), **(quant or {}))
    cfg = configs.get_config(arch, QuantConfig(**q))
    cfg = dataclasses.replace(cfg, flash_decode=True, **over)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _boot(cfg, dev):
    from repro_torch.models import build_model, init_quantized

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return init_quantized(build_model(cfg, device=dev), gen)


def _entries():
    """Every counted kernel entry: the fused entries by format name, the
    packed ones as "<format>_packed", flash and quantize_rows."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_prefill import flash_attend
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import get_format

    out = {"flash": flash_attend, "quantize_rows": quantize_rows, "flash_attention": flash_attention}
    for fmt in ("ternary", "int8", "int4", "nf4"):  # mx's entries are int8's
        out[fmt] = get_format(fmt).fused_kernel
        out[f"{fmt}_packed"] = get_format(fmt).kernel
    return out


def _reset_counts() -> None:
    for fn in _entries().values():
        fn.launches = 0
        fn.mode_launches.clear()


def _read_counts() -> dict:
    """Launches per JSON row since the last reset."""
    entries = _entries()
    return {name: entries[e].launches if mode is None else entries[e].mode_launches[mode]
            for name, (e, mode) in MODES.items()}


def _require_launches(launches: dict, names, path: str) -> None:
    bad = [name for name in names if launches[name] <= 0]
    if bad:
        raise SystemExit(f"{path} never launched {bad}")


def phase_main(dev) -> dict:
    from repro_torch.models.kv_cache import cache_bytes
    from repro_torch.serving import Request, ServingEngine

    cfg = _ptq_cfg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, plan, api = _boot(cfg, dev)
    eng = ServingEngine(api, qparams, n_slots=SLOTS, max_len=MAX_LEN)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    wbytes = sum(qt.nbytes() for qt in _qtensors(qparams))
    log(f"main: {cfg.name} depth {cfg.n_layers}/36 d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff {cfg.d_ff} vocab {cfg.vocab}->{cfg.padded_vocab} dtype {cfg.dtype}; boot {boot_s:.2f} s; "
        f"packed weights {wbytes / 1e9:.3f} GB, embed {qparams['embed']['table'].numel() * 2 / 1e9:.3f} GB, "
        f"kv cache {cache_bytes(eng.cache) / 1e9:.3f} GB; peak alloc {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _read_counts()
    stats = eng.stats()
    used = {k: v for k, v in launches.items() if v}
    log(f"main: {len(done)} requests, {stats['tick']} ticks, {stats['tokens']} tokens in {run_s:.3f} s = "
        f"{stats['tokens'] / run_s:.2f} tokens/s ({stats['tick'] / run_s:.2f} ticks/s); launches {used} "
        f"(per tick: {({k: v / stats['tick'] for k, v in used.items()})})")
    _require_launches(launches, ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_bf16"], "main path")
    if len(done) != N_REQ or any(len(r.output) != NEW for r in done):
        raise SystemExit("main path: not every request finished with its tokens")
    if any(not 0 <= t < cfg.padded_vocab for r in done for t in r.output):
        raise SystemExit("main path: token id out of range")
    log(f"main: first outputs {[r.output[:6] for r in done[:2]]}")
    _trace_ticks(eng, cfg, n_ticks=8)
    del eng, qparams
    torch.cuda.empty_cache()
    _agreement(dev)
    return launches


def _trace_ticks(eng, cfg, n_ticks: int) -> None:
    """torch.profiler over a few steady decode ticks (4 busy slots, after
    the counted run): device busy share and device time by kernel."""
    from repro_torch.serving import Request

    gen = torch.Generator().manual_seed(SEED + 3)
    for i in range(SLOTS):
        prompt = torch.randint(0, cfg.vocab, (PROMPT,), generator=gen).tolist()
        eng.submit(Request(uid=1000 + i, prompt=prompt, max_new_tokens=NEW))
    for _ in range(2):  # admit and warm
        eng.step()
    _profile(eng.step, n_ticks, "trace", "tick")
    eng.run()  # drain the traced requests


def _profile(step, n: int, label: str, unit: str) -> None:
    """torch.profiler over ``n`` calls of ``step``: wall time, device busy
    share and device time by kernel, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"{label}: {n} {unit}s, {wall_us / n / 1e3:.3f} ms/{unit} wall, device busy "
        f"{busy_us / n / 1e3:.3f} ms/{unit} = {busy_us / wall_us:.1%} (idle {1 - busy_us / wall_us:.1%}); "
        f"{sum(e.count for e in kernels) / n:.0f} kernels/{unit}")
    gemv = [e for e in kernels if "gemv_kernel" in e.key]
    if gemv:
        log(f"{label}: qdense GEMV {sum(e.self_device_time_total for e in gemv) / n / 1e3:.3f} ms/{unit} in "
            f"{sum(e.count for e in gemv) / n:.1f} launches/{unit}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"{label}:   {e.self_device_time_total / n:9.1f} us/{unit}  {e.count / n:6.1f}/{unit}  {e.key[:90]}")


def _qtensors(tree):
    from repro_torch.core.quantizer import QTensor

    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qtensors(v)


def _agreement(dev) -> None:
    """A 2-layer full-width twin: 6 decode steps through the kernels (cuda
    backend, flash decode) against the plain path (ref backend, dense
    attention oracle) on the same weights.  Both paths round activations
    to bf16 between ops, so a last-bit difference can move a DFP mantissa;
    logits must agree to 0.1 and each greedy pick must be the plain path's
    best token or within the observed difference of it."""
    from repro_torch.models import build_model

    cfg = _ptq_cfg(n_layers=2)
    qparams, plan, api = _boot(cfg, dev)
    oracle = build_model(dataclasses.replace(cfg, flash_decode=False), device=dev)
    ref_api = oracle.with_plan(dataclasses.replace(plan, backend="ref"))
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (SLOTS, 6), generator=gen).to(dev)
    outs = {}
    for name, a in (("kernel", api), ("plain", ref_api)):
        cache = a.init_cache(SLOTS, 64)
        steps = []
        with torch.inference_mode():
            for i in range(tokens.shape[1]):
                pos = i + torch.arange(SLOTS, device=dev, dtype=torch.int32)  # ragged slots
                logits, cache = a.decode(qparams, tokens[:, i:i + 1], pos, cache)
                steps.append(logits[:, -1].float())
        outs[name] = torch.stack(steps)  # (steps, slots, vocab)
    got, want = outs["kernel"], outs["plain"]
    diff = float((got - want).abs().max())
    pick = got.argmax(-1, keepdim=True)
    near_best = (want.gather(-1, pick)[..., 0] >= want.amax(-1) - 2 * diff).all()
    exact = float((pick[..., 0] == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got).all())
    log(f"agreement (2 layers, full width, 6 steps x {SLOTS} slots): logits max|kernel - plain| = {diff:.3e} "
        f"(logit scale {float(want.abs().max()):.3e}); argmax equal in {exact:.0%} of steps; finite {finite}")
    if not (finite and diff <= 0.1 and bool(near_best)):
        raise SystemExit("kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# 5. staged path
# ---------------------------------------------------------------------------
def _staged_prompts(cfg, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist() for n in STAGED_PROMPTS]


def _pcts_ms(p) -> str:
    return "n/a" if p is None else f"p50 {p['p50'] * 1e3:.1f} / p95 {p['p95'] * 1e3:.1f} / p99 {p['p99'] * 1e3:.1f} ms"


def _with_fused(plan, fused: bool):
    """``plan`` with every site's fused knob set to ``fused``."""
    return dataclasses.replace(
        plan, site_precisions=tuple(dataclasses.replace(p, fused=fused) for p in plan.site_precisions))


def _serve_staged(dev, cfg, required, *, trace=False, booted=None, unfused=False, label=None):
    """Serve the staged traffic with ``cfg`` (booted here unless ``booted``
    gives (qparams, plan, api)); every site ``fused=False`` if ``unfused``.
    Returns (the launches of this run, which must include every mode in
    ``required``; {uid: tokens})."""
    from repro_torch.models.kv_cache import cache_bytes
    from repro_torch.serving import Request, SchedulerConfig, StagedEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, plan, api = booted or _boot(cfg, dev)
    if unfused:
        api = api.with_plan(_with_fused(plan, False))
    eng = StagedEngine(api, qparams, n_slots=STAGED_SLOTS, max_len=STAGED_MAX_LEN,
                       sched=SchedulerConfig(prefill_chunk=STAGED_CHUNK, policy="decode"))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    label = label or f"staged {cfg.kv_fmt} {cfg.n_layers}L"
    log(f"{label}: {'boot' if booted is None else 'engine'} {boot_s:.2f} s; kv cache "
        f"{cache_bytes(eng.cache) / 1e9:.3f} GB ({STAGED_SLOTS} slots x {STAGED_MAX_LEN}); packed weights "
        f"{sum(qt.nbytes() for qt in _qtensors(qparams)) / 1e9:.3f} GB; prompts {STAGED_PROMPTS}, {NEW} new tokens each")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(_staged_prompts(cfg, SEED + 10))]
    _reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_ticks=10_000)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _read_counts()
    st = eng.stats()
    lat = st["latency"]
    log(f"{label}: {len(done)} requests in {run_s:.3f} s: {st['counts']['prefill_chunks']} prefill chunks, "
        f"{st['counts']['inserts']} inserts, {st['counts']['generate_ticks']} generate ticks, {st['tokens']} tokens "
        f"= {st['tokens'] / run_s:.2f} tokens/s; TTFT {_pcts_ms(lat['ttft'])}; TPOT {_pcts_ms(lat['tpot'])}; "
        f"queue wait {_pcts_ms(lat['queue_wait'])}")
    log(f"{label}: launches {({k: v for k, v in launches.items() if v})}")
    _require_launches(launches, required, label)
    if unfused and any(launches[name] for name in FUSED_ROWS):
        raise SystemExit(f"{label}: a fused kernel launched on the fused=False path")
    if len(done) != len(reqs) or any(len(r.output) != NEW for r in done) or eng.leftover()["in_flight"]:
        raise SystemExit(f"{label}: not every request finished with its tokens")
    if any(not 0 <= t < cfg.padded_vocab for r in done for t in r.output):
        raise SystemExit(f"{label}: token id out of range")
    if st["counts"]["inserts"] != len(reqs):
        raise SystemExit(f"{label}: {st['counts']['inserts']} inserts for {len(reqs)} requests")
    log(f"{label}: first outputs {[r.output[:6] for r in sorted(done, key=lambda r: r.uid)[:2]]}")
    if trace:
        _trace_staged(eng, cfg)
    outputs = {r.uid: r.output for r in done}
    del eng, qparams
    torch.cuda.empty_cache()
    return launches, outputs


def _trace_staged(eng, cfg) -> None:
    """torch.profiler over generate ticks with 3 slots generating, then over
    one 256-token prefill chunk (with its insert and first token)."""
    from repro_torch.serving import Request

    gen = torch.Generator().manual_seed(SEED + 11)
    for i in range(STAGED_SLOTS - 1):
        eng.submit(Request(uid=2000 + i, prompt=torch.randint(0, cfg.vocab, (16,), generator=gen).tolist(),
                           max_new_tokens=64))
    while eng.queue or eng._pf is not None:  # prefill all three
        eng.step()
    for _ in range(2):
        eng.step()
    ticks = eng.counts["generate_ticks"]
    _profile(eng.step, 6, "trace staged generate", "tick")
    if eng.counts["generate_ticks"] != ticks + 6:
        raise SystemExit("the traced staged steps were not all generate ticks")
    eng.submit(Request(uid=2100, prompt=torch.randint(0, cfg.vocab, (STAGED_CHUNK,), generator=gen).tolist(),
                       max_new_tokens=4))
    chunks = eng.counts["prefill_chunks"]
    _profile(eng.step, 1, "trace staged prefill", "chunk")
    if eng.counts["prefill_chunks"] != chunks + 1:
        raise SystemExit("the traced staged step was not the 256-token prefill chunk")
    eng.run()


def phase_staged(dev) -> dict:
    """The staged path: 36 layers over kv_int8 (traced), the same traffic
    at 4 layers over kv_mx and kv_bf16, and the chunked-prefill twins."""
    runs = [("kv_int8", None, ["fused_qmm_ternary", "fused_qmm_ternary_prefill", "fused_qmm_int8",
                               "flash_attend_int8", "flash_attend_int8_prefill"], True),
            ("kv_mx", SMALL_DEPTH, ["flash_attend_mx", "flash_attend_mx_prefill"], False),
            ("kv_bf16", SMALL_DEPTH, ["flash_attend_bf16", "flash_attend_bf16_prefill"], False)]
    total: dict = {}
    for fmt, depth, required, trace in runs:
        cfg = _ptq_cfg(depth, kv_fmt=fmt, flash_prefill=True)
        launches, _ = _serve_staged(dev, cfg, required, trace=trace)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    for fmt in ("kv_int8", "kv_mx"):
        _chunk_twin(dev, fmt)
    return total


TWIN_STARTS = [0, 77, 300, 333]  # prefill_chunk boundaries, then 4 decode steps


def _twin_logits(a, params, toks, starts=TWIN_STARTS, max_len=512) -> torch.Tensor:
    """Last-token logits of each chunk and of 4 decode steps, (chunks + 4, 2, vocab)."""
    cache = a.init_cache(2, max_len)
    steps = []
    with torch.inference_mode():
        for s0, s1 in zip(starts, starts[1:]):
            logits, cache = a.prefill_chunk(params, toks[:, s0:s1], s0, cache)
            steps.append(logits[:, -1].float())
        for i in range(4):
            pos = starts[-1] + i
            logits, cache = a.decode(params, toks[:, pos:pos + 1], pos, cache)
            steps.append(logits[:, -1].float())
    return torch.stack(steps)


def _twin_diff(got, want):
    return float((got - want).abs().max()), bool((got.argmax(-1) == want.argmax(-1)).all())


def _fp_twin(dev, fcfg, kv_fmt: str, toks) -> bool:
    """The float32 float-weight twin: flash within 5e-3 of the oracle,
    equal argmax."""
    from repro_torch.models import build_model

    fapi = build_model(fcfg, device=dev)
    fparams = fapi.init(torch.Generator(device=dev).manual_seed(SEED))
    foracle = build_model(dataclasses.replace(fcfg, flash_decode=False, flash_prefill=False), device=dev)
    want = _twin_logits(foracle, fparams, toks)
    diff, same = _twin_diff(_twin_logits(fapi, fparams, toks), want)
    ok_fp = diff <= 5e-3 and same
    log(f"twin fp32 {kv_fmt} (2 layers, full width, chunks {TWIN_STARTS} + 4 decode steps): logits "
        f"max|flash - oracle| = {diff:.3e} (atol 5e-3; logit scale {float(want.abs().max()):.3e}); "
        f"argmax equal {same} {'OK' if ok_fp else 'FAIL'}")
    del fparams, fapi, foracle
    torch.cuda.empty_cache()
    return ok_fp


def _chunk_twin(dev, kv_fmt: str, quant=None, fp_twin=True, dtypes=("bfloat16", "float32")) -> None:
    """2-layer full-width twins over ``kv_fmt``: prefill_chunk at ragged
    starts (0, 77, 300) then 4 decode steps, the kernel path (flash prefill
    and decode) against the plain path (dense attention oracle).

    fp32: float weights and float32 activations, the setting of the
    reference's model-level tolerance (tests/test_flash_prefill.py): logits
    within 5e-3 and equal argmax.
    ptq: the served model (ternary PTQ unless ``quant`` names other
    weights; ``dtypes``: bf16, then float32 activations),
    cuda backend and flash against the ref backend and the oracle, split in
    two legs.  The qdense leg (cuda vs ref backend, both with the oracle)
    must be bit-identical in bf16.  The attention leg is not held to 5e-3:
    flash and the oracle sum in other orders (kernel within 5e-5 of its
    plain version), and every 8-bit DFP activation quantizer turns a
    sub-ulp difference of its input into whole mantissa steps -- in float32
    as in bf16; each greedy pick must be the plain path's best token or
    within the observed difference of it."""
    from repro_torch.models import build_model

    gen = torch.Generator().manual_seed(SEED + 4)
    fcfg = dataclasses.replace(_ptq_cfg(2, kv_fmt=kv_fmt, flash_prefill=True, dtype="float32"),
                               quant=dataclasses.replace(_ptq_cfg().quant, mode="fp"))
    toks = torch.randint(0, fcfg.vocab, (2, TWIN_STARTS[-1] + 4), generator=gen).to(dev)
    ok_fp = not fp_twin or _fp_twin(dev, fcfg, kv_fmt, toks)
    ok_ptq = True
    for dtype in dtypes:  # the served activations, then float32 to show the DFP effect
        cfg = _ptq_cfg(2, quant, kv_fmt=kv_fmt, flash_prefill=True, dtype=dtype)
        qparams, plan, api = _boot(cfg, dev)
        oracle = build_model(dataclasses.replace(cfg, flash_decode=False, flash_prefill=False), device=dev)
        got = _twin_logits(api, qparams, toks)
        mid = _twin_logits(oracle.with_plan(plan), qparams, toks)  # cuda backend, oracle attention
        plain = _twin_logits(oracle.with_plan(dataclasses.replace(plan, backend="ref")), qparams, toks)
        q_diff, _ = _twin_diff(mid, plain)
        diff, same = _twin_diff(got, plain)
        a_diff, _ = _twin_diff(got, mid)
        pick = got.argmax(-1, keepdim=True)
        near_best = bool((plain.gather(-1, pick)[..., 0] >= plain.amax(-1) - 2 * diff).all())
        finite = bool(torch.isfinite(got).all())
        # bf16: the backends agree bit for bit; float32: to float32 rounding
        ok = finite and near_best and q_diff <= (0.0 if dtype == "bfloat16" else 1e-5)
        ok_ptq = ok_ptq and ok
        weights = cfg.quant.fmt or {2: "ternary", 4: "int4", 8: "int8"}[cfg.quant.w_bits]
        log(f"twin ptq {weights} {kv_fmt} ({dtype}): logits max|kernel - plain| = {diff:.3e} (logit scale "
            f"{float(plain.abs().max()):.3e}); qdense leg max|cuda - ref| = {q_diff:.3e}; attention leg "
            f"max|flash - oracle| = {a_diff:.3e}; argmax equal {same}, every pick within the difference of "
            f"the best {near_best}; finite {finite} {'OK' if ok else 'FAIL'}")
        del qparams, api, oracle
        torch.cuda.empty_cache()
    if not (ok_fp and ok_ptq):
        raise SystemExit(f"twin {kv_fmt}: the kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# 6. weight formats: int4, nf4, mx, and the unfused path
# ---------------------------------------------------------------------------
FORMAT_QUANTS = {"ternary": dict(w_bits=2), "int4": dict(w_bits=4), "nf4": dict(fmt="nf4"), "mx": dict(fmt="mx")}


def phase_formats(dev) -> dict:
    """The paper's 4-bit weights on the staged path over kv_int8: int4 at
    all 36 layers (traced), nf4 and mx at 4 layers; then, at 4 layers, every
    site fused=False for ternary, int4 and nf4, whose tokens must equal
    the fused run's on the same weights; then the 2-layer int4 PTQ twin."""
    flash = ["flash_attend_int8", "flash_attend_int8_prefill"]
    runs = [("int4", None, ["fused_qmm_int4", "fused_qmm_int4_prefill", "fused_qmm_int8"] + flash, True),
            ("nf4", SMALL_DEPTH, ["fused_qmm_nf4", "fused_qmm_nf4_prefill", "fused_qmm_int8"] + flash, False),
            ("mx", SMALL_DEPTH, ["fused_qmm_int8", "fused_qmm_int8_prefill"] + flash, False)]
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for fmt, depth, required, trace in runs:
        cfg = _ptq_cfg(depth, FORMAT_QUANTS[fmt], kv_fmt="kv_int8", flash_prefill=True)
        add(_serve_staged(dev, cfg, required, trace=trace, label=f"staged {fmt} kv_int8 {cfg.n_layers}L")[0])
    for fmt in ("int4", "ternary", "nf4"):
        cfg = _ptq_cfg(SMALL_DEPTH, FORMAT_QUANTS[fmt], kv_fmt="kv_int8", flash_prefill=True)
        booted = _boot(cfg, dev)
        label = f"staged {fmt} kv_int8 {SMALL_DEPTH}L"
        launches, fused_out = _serve_staged(dev, cfg, [f"fused_qmm_{fmt}"], booted=booted, label=f"{label} fused")
        add(launches)
        packed = [f"packed_qmm_{fmt}"] + (["packed_qmm_int4_prefill"] if fmt == "int4" else [])
        launches, unfused_out = _serve_staged(
            dev, cfg, ["quantize_rows", "quantize_rows_prefill", "packed_qmm_int8"] + packed, booted=booted,
            unfused=True, label=f"{label} fused=False")
        add(launches)
        same = unfused_out == fused_out
        log(f"{label}: fused=False tokens {'equal' if same else 'DIFFER from'} the fused run's "
            f"({sum(map(len, unfused_out.values()))} tokens) {'OK' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"{label}: the unfused path's tokens differ from the fused path's")
        del booted
        torch.cuda.empty_cache()
    _chunk_twin(dev, "kv_int8", FORMAT_QUANTS["int4"], fp_twin=False, dtypes=("bfloat16",))
    return total


# ---------------------------------------------------------------------------
# 7. the serving launcher at full width, chaos, containment
# ---------------------------------------------------------------------------
SERVE_ARGV = ["--arch", ARCH, "--bits", "2", "--group-size", str(GROUP), "--kv-fmt", "kv_int8", "--flash-decode",
              "--flash-prefill", "--slots", str(STAGED_SLOTS), "--max-len", str(STAGED_MAX_LEN), "--requests", "8",
              "--prefill-chunk", str(STAGED_CHUNK), "--backend", "auto", "--device", "cuda"]
CHAOS_SPEC = "rate=0.05,kinds=nan_logits|inf_logits|sat_logits|stall_tick,seed=0"
SERVE_REQUIRED = {
    "staged": ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8", "flash_attend_int8_prefill"],
    "lockstep": ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8"],
}


def _serve_cli(engine: str, *extra) -> tuple:
    """One run of the launcher's main(argv): (run, launches of the run)."""
    from repro_torch.launch import serve

    _reset_counts()
    t0 = time.perf_counter()
    run = serve.main(SERVE_ARGV + ["--engine", engine, *extra])
    torch.cuda.synchronize()
    launches = _read_counts()
    st = run.engine.stats()
    lat = st["latency"]
    toks = sum(len(r.output) for r in run.done if r.status == "finished")
    log(f"serve {engine}{' ' + ' '.join(extra) if extra else ''}: main() {time.perf_counter() - t0:.2f} s, boot "
        f"{run.boot_s:.2f} s, run {run.run_s:.3f} s, {toks} tokens = {toks / run.run_s:.2f} tokens/s; TTFT "
        f"{_pcts_ms(lat['ttft'])}; TPOT {_pcts_ms(lat['tpot'])}; launches "
        f"{({k: n for k, n in launches.items() if n})}")
    _require_launches(launches, SERVE_REQUIRED[engine], f"serve {engine}")
    if run.engine.leftover()["in_flight"] or run.engine.leftover()["queued"] or len(run.done) != 8:
        raise SystemExit(f"serve {engine}: the engine did not serve every request to its end")
    return run, launches


def _direct_outputs(engine: str, booted, prompts) -> dict:
    """The same engine built here on ``_boot``'s weights, with the
    launcher's arguments and prompts: {uid: tokens}."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

    qparams, _, api = booted
    kw = dict(n_slots=STAGED_SLOTS, max_len=STAGED_MAX_LEN)
    if engine == "staged":
        eng = StagedEngine(api, qparams, sched=SchedulerConfig(prefill_chunk=STAGED_CHUNK, policy="decode"), **kw)
    else:
        eng = ServingEngine(api, qparams, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=serve.NEW_TOKENS, max_retries=1))
    done = eng.run()
    if len(done) != len(prompts) or any(r.status != "finished" for r in done):
        raise SystemExit(f"direct {engine}: not every request finished")
    return {r.uid: r.output for r in done}


def phase_serve(dev) -> dict:
    """The launcher through both engines at full width, each against the
    engine built directly; the launcher under chaos; the containment
    matrix."""
    from repro_torch.launch import serve

    total: dict = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    outs = {}
    for engine in ("staged", "lockstep"):
        run, launches = _serve_cli(engine)
        add(launches)
        if any(r.status != "finished" or len(r.output) != serve.NEW_TOKENS for r in run.done):
            raise SystemExit(f"serve {engine}: not every request finished with its tokens")
        outs[engine] = {r.uid: r.output for r in run.done}
        del run
        torch.cuda.empty_cache()
    cfg = _ptq_cfg(kv_fmt="kv_int8", flash_prefill=True)
    booted = _boot(cfg, dev)
    prompts = serve.draw_prompts(8, cfg.vocab)
    for engine in ("staged", "lockstep"):
        direct = _direct_outputs(engine, booted, prompts)
        same = direct == outs[engine]
        log(f"serve {engine}: launcher tokens {'equal' if same else 'DIFFER from'} the directly built engine's "
            f"({sum(map(len, direct.values()))} tokens) {'OK' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"serve {engine}: the launcher's tokens differ from the directly built engine's")
    del booted
    torch.cuda.empty_cache()
    differ = sum(a != b for u in outs["staged"] for a, b in zip(outs["staged"][u], outs["lockstep"][u]))
    log(f"serve: staged vs lockstep on the card: {differ} of {sum(map(len, outs['staged'].values()))} tokens differ "
        "(S > 1 chunks and S == 1 steps sum in other orders; not gated, see ROADMAP Queue C)")

    run, launches = _serve_cli("staged", "--chaos", CHAOS_SPEC, "--retries", "3")
    add(launches)
    h = run.engine.stats()["health"]
    bad = [r.uid for r in run.done if not (
        (r.status == "finished" and r.output == outs["staged"][r.uid])
        or (r.status == "failed" and "retry budget exhausted" in (r.reason or "")))]
    log(f"serve chaos: {h['faults']}; events {h['events']}; slow ticks {h['slow_ticks']}; statuses "
        f"{sorted((r.uid, r.status) for r in run.done)}; {'OK' if not bad and h['faults']['injected'] else 'FAIL'}")
    if bad or not h["faults"]["injected"]:
        raise SystemExit(f"serve chaos: requests {bad} neither kept the fault-free tokens nor failed out of retries")
    del run
    torch.cuda.empty_cache()
    _containment(dev)
    return total


def _containment(dev) -> None:
    """The armed containment matrix at 4 layers, both engines: each fault
    armed on slot 0 after two healthy steps fails exactly its victim (retry
    budget 0) and leaves every other request's tokens bit-identical to the
    fault-free run; a stalled tick is flagged and changes no token.  Every
    tick fault kind on the float model over kv_bf16 (the reference's
    setting: the 8-bit DFP casts map NaN to 0, so under PTQ a NaN cache row
    never reaches the logit guardrail, and kv_int8 has no float leaf to
    fill); the logit kinds on the PTQ model over kv_int8."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import (
        TICK_FAULT_KINDS, FaultInjector, HealthConfig, Request, SchedulerConfig, ServingEngine, StagedEngine,
    )

    fp_cfg = _ptq_cfg(SMALL_DEPTH, kv_fmt="kv_bf16", flash_prefill=True)
    fp_cfg = dataclasses.replace(fp_cfg, quant=dataclasses.replace(fp_cfg.quant, mode="fp"))
    fp_api = build_model(fp_cfg, device=dev)
    fp = (fp_api, fp_api.init(torch.Generator(device=dev).manual_seed(SEED)))
    qparams, _, q_api = _boot(_ptq_cfg(SMALL_DEPTH, kv_fmt="kv_int8", flash_prefill=True), dev)
    models = [("fp kv_bf16", fp, TICK_FAULT_KINDS), ("ptq kv_int8", (q_api, qparams), TICK_FAULT_KINDS[:3])]
    prompts = serve.draw_prompts(4, fp_cfg.vocab)

    def run(api, params, engine, inj=None, kind=None):
        kw = dict(n_slots=4, max_len=64, faults=inj, health=HealthConfig(tick_slow_s=0.1))
        if engine == "staged":
            eng = StagedEngine(api, params, sched=SchedulerConfig(prefill_chunk=4), **kw)
        else:
            eng = ServingEngine(api, params, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        done = eng.step() + eng.step()
        if kind is not None:
            inj.arm(kind, slot=0)
        done += eng.run()
        return eng, {r.uid: r for r in done}

    failures = []
    for label, (api, params), kinds in models:
        for engine in ("lockstep", "staged"):
            _, base = run(api, params, engine)
            if any(r.status != "finished" for r in base.values()):
                raise SystemExit(f"containment {label} {engine}: the fault-free run did not finish")
            for kind in kinds:
                inj = FaultInjector()
                eng, got = run(api, params, engine, inj, kind)
                h = eng.stats()["health"]
                victim = inj.log[0].uid if len(inj.log) == 1 else None
                others = [u for u in base if u != victim]
                same = all(got[u].status == "finished" and got[u].output == base[u].output for u in others)
                if kind == "stall_tick":  # a 0.25 s host stall: flagged, no token changed
                    ok = same and h["tick_ms_worst"] >= 250.0 and got[victim].output == base[victim].output
                else:
                    ok = (victim is not None and got[victim].status == "failed" and same
                          and h["events"]["quarantined"] == h["events"]["failed"] == 1)
                log(f"containment {label} {engine} {kind}: victim uid {victim} -> {got[victim].status} "
                    f"({got[victim].reason}); others bit-identical {same}; quarantined {h['events']['quarantined']} "
                    f"slow ticks {h['slow_ticks']} {'OK' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{label} {engine} {kind}")
    del fp, models, qparams
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"containment failed: {failures}")


# ---------------------------------------------------------------------------
# 8. the packed artifact: calibrate, save, cold-start
# ---------------------------------------------------------------------------
ARTIFACT_DIR = os.path.join(HERE, "build", "artifact")
ARTIFACT_REQUIRED = {
    "staged": ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8", "flash_attend_int8_prefill"],
    "lockstep": ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8"],
}


def phase_artifact(dev) -> dict:
    """Calibrate the full-width model, save it, serve it cold from the
    artifact through both engines with the in-memory model's tokens."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model, quantize_and_plan, save_servable
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine
    from repro_torch.training import checkpoint as ck

    t_phase = time.perf_counter()
    cfg = _ptq_cfg(kv_fmt="kv_int8", flash_prefill=True)
    api = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, plan, qapi = quantize_and_plan(api, params, serve.calibration_batches(cfg, 2, dev))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    exps = dict(plan.act_exponents)
    log(f"artifact: {cfg.name} depth {cfg.n_layers} {cfg.dtype}; float init {init_s:.2f} s; quantize + calibrate "
        f"(2 batches of {serve.CALIB_BATCH} x {serve.CALIB_SEQ}) {quant_s:.2f} s; {len(exps)} of "
        f"{len(plan.site_paths)} sites calibrated {exps}; peak alloc {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if set(exps) != set(plan.site_paths):
        raise SystemExit("artifact: calibration missed sites")
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        step = save_servable(ARTIFACT_DIR, qapi, qparams, plan)
        save_s = time.perf_counter() - t0
        log(f"artifact: saved {step}: {ck.dir_bytes(ARTIFACT_DIR) / 1e6:.1f} MB in {len(os.listdir(step))} files, "
            f"save {save_s:.2f} s; host free disk {shutil.disk_usage(ARTIFACT_DIR).free / 1e9:.1f} GB")
        prompts = serve.draw_prompts(8, cfg.vocab)
        warm = {engine: _direct_outputs(engine, (qparams, plan, qapi), prompts) for engine in ("staged", "lockstep")}
        del qapi
        torch.cuda.empty_cache()
        total: dict = {}
        for engine in ("staged", "lockstep"):
            kw = dict(n_slots=STAGED_SLOTS, max_len=STAGED_MAX_LEN, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if engine == "staged":
                eng = StagedEngine.from_artifact(ARTIFACT_DIR, sched=SchedulerConfig(prefill_chunk=STAGED_CHUNK), **kw)
            else:
                eng = ServingEngine.from_artifact(ARTIFACT_DIR, **kw)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            # the 36-layer tree comes back bit for bit (layer split, bf16
            # payloads, uint32 words as int32) under the saved plan, with
            # every site on its calibrated static exponent
            bad = _tree_mismatch(eng.params, qparams)
            loaded = eng.api.ctx.plan
            dynamic = [p for p in loaded.site_paths if loaded.act_exponent(p) is None]
            log(f"artifact {engine}: loaded tree equals the saved one: {'OK' if bad is None else f'FAIL at {bad}'}; "
                f"loaded plan equals the saved plan: {'OK' if loaded == plan else 'FAIL'}; "
                f"{len(loaded.site_paths) - len(dynamic)} of {len(loaded.site_paths)} sites static")
            if bad is not None or loaded != plan or dynamic:
                raise SystemExit(f"artifact {engine}: the cold-started tree or plan differs from the saved one "
                                 f"(first differing leaf {bad}, sites left dynamic {dynamic[:4]})")
            _reset_counts()
            t0 = time.perf_counter()
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=serve.NEW_TOKENS, max_retries=1))
            done = eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _read_counts()
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            cold = {r.uid: r.output for r in done if r.status == "finished"}
            same = cold == warm[engine] and len(cold) == len(prompts)
            log(f"artifact {engine}: cold start {cold_s:.2f} s (plan: {len(eng.api.ctx.plan.act_exponents)} "
                f"calibrated), run {run_s:.3f} s, {sum(map(len, cold.values()))} tokens "
                f"{'equal' if same else 'DIFFER from'} the in-memory calibrated model's; launches "
                f"{({k: n for k, n in launches.items() if n})} {'OK' if same else 'FAIL'}")
            _require_launches(launches, ARTIFACT_REQUIRED[engine], f"artifact {engine}")
            if not same:
                raise SystemExit(f"artifact {engine}: the cold-started tokens differ from the in-memory model's")
            del eng
            torch.cuda.empty_cache()
        del qparams
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    _quantize_twin(dev)
    log(f"artifact: phase {time.perf_counter() - t_phase:.1f} s")
    return total


def _tree_mismatch(a, b, path="params"):
    """The first path where two port trees differ (structure, QTensor
    metadata, tensor dtype or any bit of a tensor), or None when they are
    equal.  Dicts are matched by key, so key order does not matter."""
    from repro_torch.core.quantizer import QTensor

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
            return path
        return next((m for k in sorted(a) if (m := _tree_mismatch(a[k], b[k], f"{path}.{k}"))), None)
    if isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)) or len(a) != len(b):
            return path
        return next((m for i, (x, y) in enumerate(zip(a, b)) if (m := _tree_mismatch(x, y, f"{path}[{i}]"))), None)
    if isinstance(a, QTensor) or isinstance(b, QTensor):
        if not (isinstance(a, QTensor) and isinstance(b, QTensor)) or (
                (a.bits, a.group_size, tuple(a.shape), a.fmt) != (b.bits, b.group_size, tuple(b.shape), b.fmt)):
            return path
        return next((m for f in ("packed", "scale_m", "scale_e")
                     if (m := _tree_mismatch(getattr(a, f), getattr(b, f), f"{path}.{f}"))), None)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return None if a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) else path
    return None if a == b else path


def _quantize_twin(dev) -> None:
    """2 layers at full width: quantize_and_plan over the float init equals
    init_quantized (a site quantized as it is made) bit for bit."""
    from repro_torch.models import build_model, quantize_and_plan

    cfg = _ptq_cfg(n_layers=2)
    api = build_model(cfg, device=dev)
    q1, plan1, _ = quantize_and_plan(api, api.init(torch.Generator(device=dev).manual_seed(SEED)))
    q2, plan2, _ = _boot(cfg, dev)
    bad = _tree_mismatch(q1, q2)
    same = plan1 == plan2 and bad is None
    log(f"artifact: 2-layer twin quantize_and_plan(init) == init_quantized, every leaf and the plan: "
        f"{'OK' if same else f'FAIL (plans equal {plan1 == plan2}, first differing leaf {bad})'}")
    del q1, q2
    torch.cuda.empty_cache()
    if not same:
        raise SystemExit("quantize_and_plan(init(gen)) differs from init_quantized(gen)")


# ---------------------------------------------------------------------------
# 9. families: the dense siblings at their published widths
# ---------------------------------------------------------------------------
GEMMA, QWEN110, PHI4 = "gemma3-12b", "qwen1.5-110b", "phi4-mini-3.8b"
QWEN110_LAYERS = 20  # of 80: cut for the script's time limit (load 57 s at 80 layers; 40 until the mesh phase)
GEMMA_MAX_LEN = 2048
# longest first, so the lockstep engine (one prompt token a tick) runs them side by side
GEMMA_PROMPTS = [1900, 1700, 1300, 1025, 640, 255, 37, 1]
GEMMA_TWIN_LAYERS = 6  # 5 local + 1 global
# the lockstep engine takes a prompt one token a tick: ~1,920 ticks for these prompts, 218 ms a tick at 48
# layers on a slow host (417 s); cut to the 6-layer model, beside a staged run of the same model
GEMMA_LOCKSTEP_LAYERS = 6
GEMMA_TWIN_STARTS = [0, 300, 556, 812, 1068, 1324, 1580]  # chunks past the 1024 window, then 4 decode steps
RAGGED_SITES = [("wq", 3840, 3840, None), ("wk", 3840, 1920, None), ("gate", 3840, 15360, "silu")]  # gemma3
RAGGED_ROWS = (1, 4, 8, 17, 256)
RAGGED_LM_HEAD = (3840, 32768)  # gemma3's int8 lm_head (K 3840), 256 column blocks: the int8 loop
LONG_K = (49152, 8192)  # qwen1.5-110b's down projection
LONG_K_ROWS = (4, 8, 17)  # M = 8 stages x's rows a few k-tiles at a time; 17: the tile, split
HD240 = dict(b=4, t=2048, kh=8, g=2, hd=240)  # gemma3: 16 query heads over 8 kv heads
HD240_DECODE_VALID = [1, 700, 1500, 2048]
HD240_CHUNK = dict(s=256, start=1300)
HD240_RAGGED = dict(s=(31, 255), starts=(77, 1600))
HD240_WINDOW = 300
ATTN_HD240 = [(2, 64, 64, 240), (3, 64, 128, 240), (64, 1024, 1024, 240)]  # last: 4 sequences x 16 heads
FAMILY_ROWS = {  # JSON row -> what the families phase counts for its launches
    "fused_qmm_ternary_ragged": ("gemv", 3840), "fused_qmm_ternary_ragged_prefill": ("tile", 3840),
    "fused_qmm_ternary_k49152": ("gemv", 49152),
    "fused_qmm_int8_lm_gemma3": ("int8 loop", 3840), "fused_qmm_int8_lm_qwen110": ("int8 loop", 8192),
    "fused_qmm_int8_lm_phi4": ("int8 loop", 3072),
    "flash_attend_int8_hd240": ("kv_int8/decode", 240), "flash_attend_int8_hd240_prefill": ("kv_int8/prefill", 240),
    "flash_attention_hd240": ("flash_attention", 240),
}


class _KeyedLaunches:
    """Launches by a key of each call's arguments: ``wraps`` is (module,
    function name, key of the positional arguments) for every function to
    count; ``close`` puts the functions back."""

    def __init__(self, wraps):
        self.counts: dict = {}
        self.saved = []
        for mod, name, key in wraps:
            self._wrap(mod, name, key)

    def _wrap(self, mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            k = key(a)
            self.counts[k] = self.counts.get(k, 0) + 1
            return fn(*a, **kw)

        self.saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _family_launches() -> _KeyedLaunches:
    """Launches by route and K (qdense) or by mode and head_dim (flash),
    counted where the wrappers plan a launch: fused_qmm / packed_qmm plan
    the GEMV (``gemv_plan``), the tile (``tile_plan``) or the int8 loop
    (``int8_loop_plan``) right before they launch it, flash_attend its
    call (``launch_plan``).  Installed for the families phase only."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import fused_qmm as fq
    from repro_torch.kernels import packed_qmm as pq

    wraps = [(mod, name, lambda a, route=route: (route, a[1])) for mod in (fq, pq)
             for name, route in (("gemv_plan", "gemv"), ("tile_plan", "tile"), ("int8_loop_plan", "int8 loop"))]
    wraps.append((fp, "launch_plan", lambda a: (f"{a[0]}/{'decode' if a[2] == 1 else 'prefill'}", a[6])))
    return _KeyedLaunches(wraps)


def _parity_families(dev, gen, errs) -> list:
    """The repairs this phase's models need, against the plain versions:
    qdense at a ragged K and at K = 49152 (0 ulps), flash_attend and
    flash_attention at head_dim 240."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import get_format

    failures = []

    def check(key, what, got, want):
        torch.cuda.synchronize()
        ulps, err = _ulps(got, want), float((got - want).abs().max())
        if key:
            errs[key] = max(errs.get(key, 0.0), err)
        ok = bool(torch.isfinite(got).all()) and ulps == 0
        log(f"parity {what}: max_abs_err={err:.3e} ulps={ulps} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    sites = [(name, k, n, act, RAGGED_ROWS, "fused_qmm_ternary_ragged") for name, k, n, act in RAGGED_SITES]
    sites.append(("down", *LONG_K, None, LONG_K_ROWS, "fused_qmm_ternary_k49152"))
    for fmt in TILE_FORMATS:
        decode = _decode_of(fmt)
        for name, k, n, act, rows, key in sites:
            qt = _qsite(k, n, fmt, gen, dev)
            for i, m in enumerate(rows):
                x = _rows(m, k, gen, dev, (torch.bfloat16, torch.float32)[i % 2])
                kw = dict(group=qt.group_size, act=act, act_exponent=(None, -4)[i // 2 % 2])
                row = (key if m <= 8 else f"{key}_prefill") if fmt == "ternary" else None
                check(row, f"qdense {name} K={k} N={n} {fmt} M={m} x={str(x.dtype)[6:]} static_e="
                      f"{kw['act_exponent']} act={act}", _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, **kw),
                      fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw))
                if m in (4, 8, 256):
                    xq, _ = quantize_rows(x)
                    check(None, f"packed_qmm {name} K={k} N={n} {fmt} M={m}",
                          get_format(fmt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size),
                          packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size))
            del qt
            torch.cuda.empty_cache()
    k, n = RAGGED_LM_HEAD
    qt = _qsite(k, n, "int8", gen, dev)
    x = _rows(M_ROWS, k, gen, dev, torch.bfloat16)
    check(None, f"qdense lm_head K={k} N={n} int8 M={M_ROWS} (the int8 loop)",
          _entry("int8")(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size),
          fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", group=qt.group_size))
    xq, _ = quantize_rows(x)
    check(None, f"packed_qmm lm_head K={k} N={n} int8 M={M_ROWS}",
          get_format("int8").kernel(xq, qt.packed, qt.scale_m, group=qt.group_size),
          packed_qmm_ref(xq, qt.packed, qt.scale_m, decode="int8", group=qt.group_size))
    del qt
    return failures + _parity_hd240(dev, gen, errs)


def _parity_hd240(dev, gen, errs) -> list:
    """flash_attend at head_dim 240 in every format: decode (B 4, T 2048),
    a 256-token chunk and ragged chunks, global and a 300-token window,
    5e-5; flash_attention at hd 240, float32 2e-5 and bf16 3e-2 and one
    ulp, through the kernels API as its users call it."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref

    fs, failures = HD240, []
    cases = [(f, 1, [v - 1 for v in HD240_DECODE_VALID], HD240_DECODE_VALID) for f in SHORT]
    cases += [(f, HD240_CHUNK["s"], [HD240_CHUNK["start"]], [HD240_CHUNK["start"] + HD240_CHUNK["s"]]) for f in SHORT]
    cases += [(f, s, list(HD240_RAGGED["starts"]), [a + s for a in HD240_RAGGED["starts"]])
              for f in SHORT for s in HD240_RAGGED["s"]]
    for fmt, s, starts, valid in cases:
        case = _flash_case(fmt, dict(fs, b=len(starts)), gen, dev, s=s, starts=starts, valid=valid)
        for window in (None, HD240_WINDOW):
            if window is not None:
                case = case[:4] + (torch.tensor([[window]], dtype=torch.int32, device=dev),)
            args = _flash_args(case)
            got = flash_attend(*args, fmt=fmt)
            want = flash_attend_ref(*args, fmt=fmt)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if fmt == "kv_int8":
                key = f"flash_attend_int8_hd240{'' if s == 1 else '_prefill'}"
                errs[key] = max(errs.get(key, 0.0), err)
            ok = bool(torch.isfinite(got).all()) and err <= 5e-5
            log(f"parity flash {fmt} hd=240 B={len(starts)} S={s} T={fs['t']} start={starts} valid={valid} "
                f"window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash {fmt} hd 240 S={s} window={window}")
    for shape in ATTN_HD240:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(shape, dtype, gen, dev)
            got = kernels.flash_attention(q, k, v)
            want = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            errs["flash_attention_hd240"] = max(errs.get("flash_attention_hd240", 0.0), err)
            ok = got.dtype == dtype and bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype]
            note = ""
            if dtype == torch.bfloat16:
                ulps = _bf16_ulps(got, want)
                ok = ok and ulps <= 1.0
                note = f", {ulps:.2f} bf16 ulps (at most 1)"
            log(f"parity flash_attention BH={shape[0]} S={shape[1]} T={shape[2]} hd=240 {str(dtype)[6:]} causal: "
                f"max_abs_err={err:.3e} (atol {ATTN_TOL[dtype]}){note} {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_attention hd 240 {shape} {dtype}")
            del q, k, v
    return failures


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _free() -> None:
    """Drop a model before the next: the engines and model APIs hold
    reference cycles, so its tensors go only once the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _run_engine(kind, booted, prompts, *, max_len, new, label, required) -> dict:
    """One engine over ``prompts`` on the booted model: {uid: tokens};
    logs its tokens/s, launches and peak memory."""
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

    qparams, _, api = booted
    kw = dict(n_slots=STAGED_SLOTS, max_len=max_len)
    if kind == "staged":
        eng = StagedEngine(api, qparams, sched=SchedulerConfig(prefill_chunk=STAGED_CHUNK, policy="decode"), **kw)
    else:
        eng = ServingEngine(api, qparams, **kw)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=new))
    done = eng.run(max_ticks=20_000)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _read_counts()
    toks = sum(len(r.output) for r in done)
    log(f"{label} {kind}: {len(done)} requests, {toks} tokens in {run_s:.2f} s = {toks / run_s:.2f} tokens/s; "
        f"{eng.counts if kind == 'staged' else ''} peak {_peak_gb():.2f} GB; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    _require_launches(launches, required, f"{label} {kind}")
    if len(done) != len(prompts) or any(r.status != "finished" or len(r.output) != new for r in done):
        raise SystemExit(f"{label} {kind}: not every request finished with its tokens")
    out = {r.uid: r.output for r in done}
    del eng
    _free()
    return out, launches


def _compare_engines(label, outs) -> None:
    total = sum(map(len, outs["staged"].values()))
    differ = sum(a != b for u in outs["staged"] for a, b in zip(outs["staged"][u], outs["lockstep"][u]))
    log(f"{label}: staged vs lockstep on the card: {differ} of {total} tokens differ (S > 1 chunks and S == 1 "
        "steps sum attention in other orders, and the 8-bit activation quantizers turn that into mantissa steps; "
        "ROADMAP Queue C; the CPU tests hold both engines to the reference's)")


def _boot_family(dev, cfg, label):
    """init_quantized on the card: (booted, load s), logged with its sizes."""
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    booted = _boot(cfg, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    heads = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd()}" if cfg.n_heads else "attention-free"
    ssm = (f", Mamba{cfg.ssm_version} d_inner {cfg.ssm_expand * cfg.d_model} state {cfg.ssm_state}"
           if cfg.ssm_state else "")
    log(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}{ssm}, vocab "
        f"{cfg.padded_vocab}: load {load_s:.2f} s (init_quantized on the card), "
        f"packed weights {sum(qt.nbytes() for qt in _qtensors(booted[0])) / 1e9:.2f} GB, peak {_peak_gb():.2f} GB")
    return booted


def _family_gemma(dev, totals) -> None:
    """All 48 layers through the StagedEngine; the lockstep engine on the
    same prompts at GEMMA_LOCKSTEP_LAYERS, beside the staged engine on
    that model; the float32 twin."""
    req = {"staged": ["fused_qmm_ternary", "fused_qmm_ternary_prefill", "fused_qmm_int8", "flash_attend_int8",
                      "flash_attend_int8_prefill"],
           "lockstep": ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8"]}
    gen = torch.Generator().manual_seed(SEED + 20)
    prompts = None
    for depth, kinds in ((None, ("staged",)), (GEMMA_LOCKSTEP_LAYERS, ("staged", "lockstep"))):
        cfg = _ptq_cfg(depth, arch=GEMMA, kv_fmt="kv_int8", flash_prefill=True)
        label = f"{GEMMA} {cfg.n_layers}L"
        booted = _boot_family(dev, cfg, label)
        if prompts is None:
            prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist() for n in GEMMA_PROMPTS]
        log(f"{label}: window schedule {_window_counts(cfg)}; prompts {GEMMA_PROMPTS} (+{NEW} new tokens), "
            f"max_len {GEMMA_MAX_LEN}")
        outs = {}
        for kind in kinds:
            outs[kind], launches = _run_engine(kind, booted, prompts, max_len=GEMMA_MAX_LEN, new=NEW, label=label,
                                               required=req[kind])
            _add(totals, launches)
        if len(outs) == 2:
            _compare_engines(label, outs)
        del booted
        _free()
    _gemma_twin(dev)


def _window_counts(cfg) -> str:
    from repro_torch.models.transformer import window_schedule

    win = window_schedule(cfg, GEMMA_MAX_LEN).tolist()
    return f"{sum(w == cfg.sliding_window for w in win)} local (window {cfg.sliding_window}) + " \
           f"{sum(w != cfg.sliding_window for w in win)} global layers"


def _gemma_twin(dev) -> None:
    """The 6-layer float32 twin (5 local + 1 global layers) at T 2048:
    prefill chunks up to 1580 then 4 decode steps, so every local layer
    masks; flash within 5e-3 of the dense oracle, equal argmax."""
    from repro_torch.models import build_model

    fcfg = dataclasses.replace(_ptq_cfg(GEMMA_TWIN_LAYERS, arch=GEMMA, kv_fmt="kv_int8", flash_prefill=True,
                                        dtype="float32"), quant=dataclasses.replace(_ptq_cfg().quant, mode="fp"))
    toks = torch.randint(0, fcfg.vocab, (2, GEMMA_TWIN_STARTS[-1] + 4),
                         generator=torch.Generator().manual_seed(SEED + 21)).to(dev)
    fapi = build_model(fcfg, device=dev)
    fparams = fapi.init(torch.Generator(device=dev).manual_seed(SEED))
    foracle = build_model(dataclasses.replace(fcfg, flash_decode=False, flash_prefill=False), device=dev)
    kw = dict(starts=GEMMA_TWIN_STARTS, max_len=GEMMA_MAX_LEN)
    want = _twin_logits(foracle, fparams, toks, **kw)
    diff, same = _twin_diff(_twin_logits(fapi, fparams, toks, **kw), want)
    ok = diff <= 5e-3 and same
    log(f"twin fp32 {GEMMA} kv_int8 ({GEMMA_TWIN_LAYERS} layers: {_window_counts(fcfg)}; full width, chunks "
        f"{GEMMA_TWIN_STARTS} + 4 decode steps, T {GEMMA_MAX_LEN}): logits max|flash - oracle| = {diff:.3e} "
        f"(atol 5e-3; logit scale {float(want.abs().max()):.3e}); argmax equal {same} {'OK' if ok else 'FAIL'}")
    del fparams, fapi, foracle
    _free()
    if not ok:
        raise SystemExit(f"twin {GEMMA}: the kernel path disagrees with the plain path")


def _family_qwen110(dev, totals, keyed) -> None:
    from repro_torch.launch import serve

    cfg = _ptq_cfg(QWEN110_LAYERS, arch=QWEN110, kv_fmt="kv_int8", flash_prefill=True)
    qparams, plan, api = _boot_family(dev, cfg, QWEN110)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    for block in qparams["blocks"]:  # seeded non-zero q / k / v biases (init gives zeros), so the epilogue adds them
        for site in ("wq", "wk", "wv"):
            b = block["attn"][site]["b"]
            b.copy_((torch.randn(b.shape, generator=gen, device=dev) * 0.1).to(b.dtype))
    prompts = serve.draw_prompts(8, cfg.vocab)
    before = keyed.counts.get(("gemv", LONG_K[0]), 0)
    _, launches = _run_engine("staged", (qparams, plan, api), prompts, max_len=STAGED_MAX_LEN,
                              new=serve.NEW_TOKENS, label=QWEN110,
                              required=["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8",
                                        "flash_attend_int8_prefill"])  # 6-token prompts: no chunk reaches the tile
    _add(totals, launches)
    long_k = keyed.counts.get(("gemv", LONG_K[0]), 0) - before
    log(f"{QWEN110}: GEMV launches at K = {LONG_K[0]} (the down projection) {long_k} "
        f"{'OK' if long_k > 0 else 'FAIL'}")
    if long_k <= 0:
        raise SystemExit(f"{QWEN110}: the K = {LONG_K[0]} down projection never went through the GEMV")
    del qparams, plan, api
    _free()


def _family_phi4(totals) -> None:
    from repro_torch.launch import serve

    argv = ["--arch", PHI4] + SERVE_ARGV[2:]
    outs = {}
    for engine in ("staged", "lockstep"):
        _free()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        run = serve.main(argv + ["--engine", engine])
        torch.cuda.synchronize()
        launches = _read_counts()
        toks = sum(len(r.output) for r in run.done if r.status == "finished")
        log(f"{PHI4} launcher --engine {engine}: load {run.boot_s:.2f} s (boot: init_quantized, engine), run "
            f"{run.run_s:.3f} s, {toks} tokens = {toks / run.run_s:.2f} tokens/s; peak {_peak_gb():.2f} GB; launches "
            f"{({k: n for k, n in launches.items() if n})}")
        _require_launches(launches, SERVE_REQUIRED[engine], f"{PHI4} {engine}")
        if len(run.done) != 8 or any(r.status != "finished" or len(r.output) != serve.NEW_TOKENS for r in run.done):
            raise SystemExit(f"{PHI4} {engine}: not every request finished with its tokens")
        outs[engine] = {r.uid: r.output for r in run.done}
        _add(totals, launches)
        del run
        _free()
    _compare_engines(PHI4, outs)


def _add(totals, launches) -> None:
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n


def phase_families(dev, errs) -> tuple:
    """Parity of the repairs, then gemma3-12b, qwen1.5-110b and
    phi4-mini-3.8b at full width: (launches by JSON row, launches of the
    families' own rows)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    from repro_torch.kernels.flash_attention import flash_attention

    keyed = _family_launches()
    totals: dict = {}
    try:
        attn = flash_attention.launches
        failures = _parity_families(dev, gen, errs)
        attn = flash_attention.launches - attn
        if failures:
            raise SystemExit(f"families parity failed: {failures}")
        before = dict(keyed.counts)  # the parity calls are not the main path's launches
        _family_gemma(dev, totals)
        _family_qwen110(dev, totals, keyed)
        _family_phi4(totals)
    finally:
        keyed.close()
    own = {row: keyed.counts.get(key, 0) - before.get(key, 0) for row, key in FAMILY_ROWS.items()}
    own["flash_attention_hd240"] = attn  # the kernels API calls of its parity
    log(f"families: phase {time.perf_counter() - t0:.1f} s; launches of the new rows {own}")
    return totals, own


# ---------------------------------------------------------------------------
# 10. moe: the MoE family at its published widths
# ---------------------------------------------------------------------------
GROK, ARCTIC = "grok-1-314b", "arctic-480b"
GROK_LAYERS = 8  # of 64 (~11 GB packed; 64 layers, ~84 GB, do not fit one card): cut from 24 and 16 for the time limit
ARCTIC_LAYERS = 2  # of 35: ~7 GB packed, the 128-expert path at a few layers (4 until the mesh phase)
MOE_FORMATS = FORMATS  # every weight format over the experts
EXPERT_SITES = [  # (name, E, K, N, capacity rows C): grok gate / up and down, arctic's
    ("grok_gate", 8, 6144, 32768, (8, 80)), ("grok_down", 8, 32768, 6144, (8, 80)),
    ("arctic_gate", 128, 7168, 4864, (8,)), ("arctic_down", 128, 4864, 7168, (8,)),
]
ROUTER_SITES = [(6144, 8), (7168, 128)]  # (d_model, E): grok, arctic
ROUTER_ROWS = (1, 4, 8, 256)
MOE_LONG_PROMPTS = [600, 257, 31, 6]  # grok staged: 256-token chunks and ragged tails, so the tile runs (C 80, 32, 16)
MOE_CHUNK = 256
# JSON row -> what the moe phase counts: an expert packed launch (E, K, N, mode), the fused router (K, N), or
# quantize_rows over a decode tick's (E * C, K) capacity buffer (rows, K, dtype)
MOE_ROWS = {
    "packed_qmm_ternary_experts_grok_gate": ("packed", 8, 6144, 32768, "m<=8"),
    "packed_qmm_ternary_experts_grok_gate_prefill": ("packed", 8, 6144, 32768, "m>8"),
    "packed_qmm_ternary_experts_grok_down": ("packed", 8, 32768, 6144, "m<=8"),
    "packed_qmm_ternary_experts_grok_down_prefill": ("packed", 8, 32768, 6144, "m>8"),
    "packed_qmm_ternary_experts_arctic_gate": ("packed", 128, 7168, 4864, "m<=8"),
    "packed_qmm_ternary_experts_grok_gate_routed5": ("packed", 8, 6144, 32768, "m<=8"),
    "packed_qmm_ternary_experts_arctic_gate_routed8": ("packed", 128, 7168, 4864, "m<=8"),
    "fused_qmm_int8_router": ("fused", 0, 6144, 8, "m<=8"),
    "fused_qmm_int8_lm_grok": ("fused", 0, 6144, 131072, "m<=8"),
    "fused_qmm_int8_lm_arctic": ("fused", 0, 7168, 32000, "m<=8"),
    "quantize_rows_grok_gate_c8": ("quantize", 64, 6144, "torch.bfloat16", "m>8"),
    "quantize_rows_grok_down_c8": ("quantize", 64, 32768, "torch.float32", "m>8"),
    "quantize_rows_arctic_gate_c8": ("quantize", 1024, 7168, "torch.bfloat16", "m>8"),
    "quantize_rows_arctic_down_c8": ("quantize", 1024, 4864, "torch.float32", "m>8"),
}
# The packed rows' timing: JSON row -> (E, K, N, C, experts routed; the others' capacity rows are zero)
MOE_TIMED = {
    "packed_qmm_ternary_experts_grok_gate": (8, 6144, 32768, 8, 8),
    "packed_qmm_ternary_experts_grok_gate_prefill": (8, 6144, 32768, 80, 8),
    "packed_qmm_ternary_experts_grok_down": (8, 32768, 6144, 8, 8),
    "packed_qmm_ternary_experts_grok_down_prefill": (8, 32768, 6144, 80, 8),
    "packed_qmm_ternary_experts_arctic_gate": (128, 7168, 4864, 8, 128),
    "packed_qmm_ternary_experts_grok_gate_routed5": (8, 6144, 32768, 8, 5),
    "packed_qmm_ternary_experts_arctic_gate_routed8": (128, 7168, 4864, 8, 8),
}


def _moe_launches() -> _KeyedLaunches:
    """Launches of the format entries' kernels (``packed_qmm`` and
    ``fused_qmm`` as the entries call them) keyed by (kind, E, K, N, mode),
    E 0 for one site, and of ``quantize_rows`` as the unfused sites call it
    keyed by ("quantize", rows, K, dtype, mode).  Installed for the moe
    phase's serving runs only."""
    import importlib

    from repro_torch.quant import backends

    def key(kind):
        return lambda a: (kind, a[0].shape[0] if a[0].ndim == 3 else 0, a[0].shape[-1], a[1].shape[-1],
                          "m<=8" if a[0].shape[-2] <= 8 else "m>8")

    wraps = [(importlib.import_module(f"repro_torch.kernels.{fmt}_matmul"), name, key(name.split("_")[0]))
             for fmt in ("ternary", "int4", "int8", "nf4") for name in ("packed_qmm", "fused_qmm")]
    wraps.append((backends, "quantize_rows", lambda a: ("quantize", a[0].shape[0], a[0].shape[1], str(a[0].dtype),
                                                        "m<=8" if a[0].shape[0] <= 8 else "m>8")))
    return _KeyedLaunches(wraps)


class _PlainKernels:
    """Inside ``with``, the format entries, the quantize step and flash run
    their kernels' plain versions on CUDA tensors (the fused site's
    ``fused_qmm_ref``, ``packed_qmm_ref`` over every expert,
    ``quantize_rows_plain``, ``flash_attend_ref``): a path's plain version
    on the card, the same torch code around them."""

    def __enter__(self):
        import importlib

        from repro_torch.kernels import flash_prefill
        from repro_torch.kernels.fused_qmm import fused_qmm_ref
        from repro_torch.kernels.packed_qmm import packed_qmm_ref
        from repro_torch.kernels.quantize import quantize_rows_plain
        from repro_torch.quant import backends

        self.saved = [(backends, "quantize_rows", backends.quantize_rows),
                      (flash_prefill, "flash_attend", flash_prefill.flash_attend)]
        backends.quantize_rows = quantize_rows_plain
        flash_prefill.flash_attend = flash_prefill.flash_attend_ref  # attention imports it at each call
        for fmt in ("ternary", "int4", "int8", "nf4"):
            mod = importlib.import_module(f"repro_torch.kernels.{fmt}_matmul")
            self.saved += [(mod, "packed_qmm", mod.packed_qmm), (mod, "fused_qmm", mod.fused_qmm)]
            mod.packed_qmm, mod.fused_qmm = packed_qmm_ref, fused_qmm_ref
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _expert_qsite(e, k, n, fmt, gen, dev):
    """An expert site's QTensor of random codes in the format's range, one
    expert at a time: (E, K/w, N) words, (E, K/g, N) scale mantissas (mx:
    powers of two), (E,) exponents."""
    from repro_torch.core.quantizer import QTensor
    from repro_torch.quant.formats import get_format

    f = get_format(fmt)
    group = f.block_size or GROUP
    lo, hi = {"ternary": (-1, 2), "int4": (-7, 8), "nf4": (0, 16)}.get(fmt, (-127, 128))
    packed = torch.stack([f.encode(torch.randint(lo, hi, (k, n), generator=gen, device=dev, dtype=torch.int8))
                          for _ in range(e)])
    if fmt == "mx":
        scale_m = (1 << torch.randint(0, 7, (e, k // group, n), generator=gen, device=dev)).to(torch.int8)
    else:
        scale_m = torch.randint(-127, 128, (e, k // group, n), generator=gen, device=dev, dtype=torch.int8)
    scale_e = torch.randint(-14, -4, (e,), generator=gen, device=dev, dtype=torch.int32)
    return QTensor(packed, scale_m, scale_e, f.bits, group, (k, n), fmt=fmt)


ROUTED_SETS = ("all", "none", "one", "some")  # the expert GEMV's routed experts in the parity cases
MOE_QUANTIZE = [  # quantize_rows parity: (rows, K, dtype, JSON row or None)
    (M_ROWS, 4096, torch.bfloat16, None), (PREFILL_ROWS[-1], 12288, torch.bfloat16, None),
    (64, 6144, torch.bfloat16, "quantize_rows_grok_gate_c8"), (64, 32768, torch.float32, "quantize_rows_grok_down_c8"),
    (1024, 7168, torch.bfloat16, "quantize_rows_arctic_gate_c8"),
    (1024, 4864, torch.float32, "quantize_rows_arctic_down_c8"),
    (640, 6144, torch.bfloat16, None), (640, 32768, torch.float32, None),  # grok at C 80
]


def _routed(e: int, kind: str, seed: int) -> list:
    """The routed experts of a parity case: all, none, the last one, or a
    decode tick's (8 token replicas: 5 of grok's 8, 8 of arctic's 128)."""
    if kind in ("all", "none"):
        return list(range(e)) if kind == "all" else []
    if kind == "one":
        return [e - 1]
    return sorted(torch.randperm(e, generator=torch.Generator().manual_seed(seed))[:5 if e == 8 else 8].tolist())


def _parity_moe(dev, gen, errs) -> list:
    """The MoE path's kernels against their plain versions on the card, 0
    ulps and the same int32 bits (the signs of zero included): the
    expert-batched packed_qmm in all five formats at grok's gate / up and
    down (C 8: the expert GEMV over all, none, one and a decode tick's
    routed experts, the first capacity rows of each filled; C 80: the
    tile) and arctic's (E 128, C 8); quantize_rows at the decode tick's,
    the prefill chunk's and the (E * C, K) capacity buffers' shapes with
    edge rows, and zero / subnormal rows; the int8 router site at N 8 and
    128, fused and packed, M 1, 4, 8, 256."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain
    from repro_torch.quant.formats import get_format

    failures = []

    def check(key, what, got, want, launched=True):
        torch.cuda.synchronize()
        ulps, err = _ulps(got, want), float((got - want).abs().max())
        bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
        if key:
            errs[key] = max(errs.get(key, 0.0), err)
        ok = bool(torch.isfinite(got).all()) and ulps == 0 and bits and launched
        log(f"parity {what}: max_abs_err={err:.3e} ulps={ulps} int32 bits {'equal' if bits else 'DIFFER'}"
            f"{'' if launched else ' (not one launch)'} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    for name, e, k, n, rows in EXPERT_SITES:
        for fmt in MOE_FORMATS:
            qt = _expert_qsite(e, k, n, fmt, gen, dev)
            entry = get_format(fmt).kernel
            for c in rows:
                for kind in ROUTED_SETS if c <= 8 else ("all",):
                    routed = _routed(e, kind, SEED + k)
                    xq = torch.randint(-127, 128, (e, c, k), generator=gen, device=dev, dtype=torch.int8)
                    xq[:, c // 2 + 1:] = 0  # the capacity buffer's empty rows
                    xq[[i for i in range(e) if i not in routed]] = 0  # the experts no replica was routed to
                    before = entry.launches
                    got = entry(xq, qt.packed, qt.scale_m, group=qt.group_size)
                    one = entry.launches == before + 1
                    want = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=_decode_of(fmt), group=qt.group_size)
                    key = f"packed_qmm_ternary_experts_{name}{'' if c <= 8 else '_prefill'}"
                    if kind == "some":
                        key += f"_routed{len(routed)}"
                    check(key if fmt == "ternary" and kind in ("all", "some") and key in MOE_ROWS else None,
                          f"packed_qmm experts {name} E={e} K={k} N={n} C={c} {fmt} routed {kind} ({len(routed)})",
                          got, want, one)
                    del xq, got, want
            del qt
            torch.cuda.empty_cache()
    for m, k, dtype, key in MOE_QUANTIZE:
        for what, x in (("edge rows", _rows(m, k, gen, dev, dtype)),
                        ("zero / subnormal rows", _zero_subnormal_rows(k, gen, dev, dtype))):
            if m > 8 and what == "edge rows":
                x[m // 2 + 1:] = 0  # the capacity buffer's empty rows
            q, ex = quantize_rows(x)
            wq, wex = quantize_rows_plain(x)
            torch.cuda.synchronize()
            ok = torch.equal(q, wq) and torch.equal(ex, wex)
            if key:
                errs[key] = max(errs.get(key, 0.0), float((q.float() - wq.float()).abs().max()))
            log(f"parity quantize_rows ({x.shape[0]}, {k}) {str(dtype)[6:]} {what}: mantissas and exponents "
                f"{'bit-identical OK' if ok else 'DIFFER FAIL'}")
            if not ok:
                failures.append(f"quantize_rows ({x.shape[0]}, {k}) {dtype} {what}")
    for k, n in ROUTER_SITES:
        qt = _qsite(k, n, "int8", gen, dev)
        for m in ROUTER_ROWS:
            x = _rows(m, k, gen, dev, torch.bfloat16)
            key = "fused_qmm_int8_router" if (k, n) == ROUTER_SITES[0] and m <= 8 else None
            check(key, f"router K={k} N={n} int8 M={m} fused", _entry("int8")(x, qt.packed, qt.scale_m, qt.scale_e,
                                                                               group=qt.group_size),
                  fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", group=qt.group_size))
            xq, _ = quantize_rows(x)
            check(None, f"router K={k} N={n} int8 M={m} packed",
                  get_format("int8").kernel(xq, qt.packed, qt.scale_m, group=qt.group_size),
                  packed_qmm_ref(xq, qt.packed, qt.scale_m, decode="int8", group=qt.group_size))
        del qt
    return failures


def _sync_free(fn, label) -> list:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode``: "warn" lists
    every operation that synchronises with the host by the innermost frames
    of the Python stack that reached it (this repository's, and torch's
    where the sync is in a torch function), then, where there is none,
    "error" runs it again.  A sync reached from a kernel wrapper
    (``repro_torch/kernels``) or the qmatmul backends fails the phase."""
    import traceback
    import warnings

    stacks = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):  # not the mode's own notice that it is a prototype
            stacks.append([f"{os.path.relpath(f.filename, HERE) if f.filename.startswith(HERE) else f.filename}:"
                           f"{f.lineno} {f.name}" for f in traceback.extract_stack()[:-1]])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not stacks:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = []
    for st in stacks:  # the repository's innermost frame, and anything below it
        inner = max((i for i, f in enumerate(st) if f.startswith("src/") or f.startswith("chip_smoke")), default=0)
        where.append(" <- ".join(reversed(st[inner:])))
    wrappers = ("src/repro_torch/kernels", "src/repro_torch/quant/backends")
    ours = [w for w in where if any(f.startswith(wrappers) for f in w.split(" <- "))]
    log(f"{label} under torch.cuda.set_sync_debug_mode: {len(stacks)} host synchronisation(s) "
        f"{sorted(set(where)) if where else '(none; then mode error ran it through)'}; reached from the kernel "
        f"wrappers {len(ours)} {'OK' if not ours else 'FAIL'}")
    return [f"{label}: host syncs in the kernel wrappers {ours}"] if ours else []


def _moe_layer_parity(dev) -> list:
    """One grok-1 layer's ``moe_layer`` at full width (ternary group 64,
    the int8 router): a decode step (4 slots: C 8) and a 256-token chunk
    (C 80), the kernels against their plain versions on the card on the
    same weights and input, bit for bit, and one packed launch and one
    quantize_rows a site; the decode step again under the sync debug mode
    (``_sync_free``)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.models import moe
    from repro_torch.quant import api as quant_api
    from repro_torch.quant.plan import QuantCtx, QuantPlan, compile_policy

    cfg = _ptq_cfg(1, arch=GROK)
    policy = QuantCtx.from_config(cfg.quant).policy
    rules = QuantPlan(policy=policy)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    p = moe.init_moe(gen, cfg, torch.bfloat16, dev,
                     leaf=lambda path, key, val: quant_api.quantize_leaf(path, key, val, rules))
    ctx = QuantCtx.for_plan(compile_policy(policy, {"blocks": [{"moe": p}]}, backend="auto"))
    failures = []
    for label, shape in (("decode step", (SLOTS, 1)), ("256-token chunk", (1, MOE_CHUNK))):
        h = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev).to(torch.bfloat16)
        before = (quantize_rows.launches, ternary_matmul.launches)
        with torch.inference_mode():
            got = moe.moe_layer(p, h, "blocks/moe", cfg, ctx)
            launched = (quantize_rows.launches - before[0], ternary_matmul.launches - before[1])
            with _PlainKernels():
                want = moe.moe_layer(p, h, "blocks/moe", cfg, ctx)
        torch.cuda.synchronize()
        ulps = _ulps(got.float(), want.float())
        ok = bool(torch.isfinite(got).all()) and ulps == 0 and launched == (3, 3)
        log(f"parity moe_layer {GROK} full width, {label} {tuple(h.shape)}: kernels vs plain versions ulps={ulps} "
            f"(max|y| {float(want.float().abs().max()):.3e}); quantize_rows / packed launches {launched} (one a site) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"moe_layer {label}")
        if label == "decode step":
            with torch.inference_mode():
                failures += _sync_free(lambda: moe.moe_layer(p, h, "blocks/moe", cfg, ctx),
                                       f"moe_layer {GROK} decode step")
    del p
    _free()
    return failures


def _family_grok(dev, totals) -> None:
    """GROK_LAYERS of grok-1 through the StagedEngine and the lockstep
    engine on the launcher's traffic, then staged on longer prompts (the
    tile at C 80, 32, 16)."""
    from repro_torch.launch import serve

    cfg = _ptq_cfg(GROK_LAYERS, arch=GROK, kv_fmt="kv_int8", flash_prefill=True)
    label = f"{GROK} {cfg.n_layers}L"
    booted = _boot_family(dev, cfg, label)
    prompts = serve.draw_prompts(8, cfg.vocab)
    base = ["fused_qmm_ternary", "fused_qmm_int8", "packed_qmm_ternary", "flash_attend_int8"]
    req = {"staged": base + ["quantize_rows_prefill", "flash_attend_int8_prefill"],
           "lockstep": base + ["quantize_rows_prefill"]}  # the (E * C, K) buffer: 64 rows at C 8
    outs = {}
    for kind in ("staged", "lockstep"):
        outs[kind], launches = _run_engine(kind, booted, prompts, max_len=STAGED_MAX_LEN, new=serve.NEW_TOKENS,
                                           label=label, required=req[kind])
        _add(totals, launches)
    _compare_engines(label, outs)
    gen = torch.Generator().manual_seed(SEED + 31)
    long_prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist() for n in MOE_LONG_PROMPTS]
    _, launches = _run_engine("staged", booted, long_prompts, max_len=STAGED_MAX_LEN, new=NEW,
                              label=f"{label} prompts {MOE_LONG_PROMPTS}",
                              required=req["staged"] + ["fused_qmm_ternary_prefill"])
    _add(totals, launches)
    del booted
    _free()


def _family_arctic(dev, totals) -> None:
    """ARCTIC_LAYERS of arctic-480b (128 experts, the dense residual MLP)
    through the StagedEngine on the launcher's traffic: every forward
    makes 3 packed launches a layer over all 128 experts, not 384."""
    from repro_torch.launch import serve

    cfg = _ptq_cfg(ARCTIC_LAYERS, arch=ARCTIC, kv_fmt="kv_int8", flash_prefill=True)
    label = f"{ARCTIC} {cfg.n_layers}L"
    booted = _boot_family(dev, cfg, label)
    _, launches = _run_engine("staged", booted, serve.draw_prompts(8, cfg.vocab), max_len=STAGED_MAX_LEN,
                              new=serve.NEW_TOKENS, label=label,
                              required=["fused_qmm_ternary", "fused_qmm_int8", "packed_qmm_ternary",
                                        "quantize_rows_prefill", "flash_attend_int8", "flash_attend_int8_prefill"])
    _add(totals, launches)
    forwards = launches["fused_qmm_int8"] // (cfg.n_layers + 1)  # the router a layer and lm_head, each forward
    per_layer = launches["packed_qmm_ternary"] / (forwards * cfg.n_layers)
    ok = per_layer == 3
    log(f"{label}: {forwards} forwards, {launches['packed_qmm_ternary']} packed launches = {per_layer:g} a layer a "
        f"forward over all {cfg.n_experts} experts (one a site; a loop over experts would be "
        f"{3 * cfg.n_experts}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: the expert sites did not run one packed launch a site")
    del booted
    _free()


def phase_moe(dev, errs) -> tuple:
    """Parity of the MoE path's kernels, one grok layer's moe_layer against
    its plain path, then grok-1-314b and arctic-480b at their published
    widths: (launches by JSON row, launches of the moe phase's own rows)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    failures = _parity_moe(dev, gen, errs) + _moe_layer_parity(dev)
    if failures:
        raise SystemExit(f"moe parity failed: {failures}")
    keyed = _moe_launches()
    totals: dict = {}
    try:
        _family_grok(dev, totals)
        _family_arctic(dev, totals)
    finally:
        keyed.close()
    own = {row: keyed.counts.get(key, 0) for row, key in MOE_ROWS.items()}
    log(f"moe: phase {time.perf_counter() - t0:.1f} s; launches of the new rows {own}")
    missing = [row for row, n in own.items() if n <= 0]
    if missing:
        raise SystemExit(f"moe: the serving runs never launched {missing}")
    return totals, own


# ---------------------------------------------------------------------------
# 11. vlm_ssm: the VLM, SSM and hybrid families at their published widths
# ---------------------------------------------------------------------------
VLM, SSM, HYBRID = "qwen2-vl-72b", "falcon-mamba-7b", "zamba2-7b"
VLM_LAYERS = 40  # of 80: cut for the script's time limit when the mesh phase came (load 37 s at 80 layers)
VLM_TEXT, VLM_STEPS = 16, 16  # text tokens after the 1024 patch embeddings; greedy decode steps after the prefill
VLM_MAX_LEN = 1088  # 1024 + 16 + 16 positions, 34 kv_mx blocks
SSM_LONG_PROMPT = 64  # one prompt through the staged engine's per-token fallback (128 until the mesh phase)
HYBRID_TWIN_LAYERS = 7  # one superblock of 6 Mamba2 layers and its shared attention, plus a tail layer
TWIN_TOKENS = 24  # the SSM twins: a forward pass over 24 tokens, or 24 decode steps
# (label, K, N, bias, JSON row at M <= 8 or None): the new families' qdense shapes
NEW_SITES = [
    ("qwen2-vl down", 29568, 8192, False, "fused_qmm_ternary_k29568"),  # K = 57 x 512 + 384: a ragged last k-tile
    ("qwen2-vl gate", 8192, 29568, False, None),
    ("falcon-mamba x_proj", 8192, 288, False, "fused_qmm_ternary_x_proj"),
    ("falcon-mamba dt_proj", 256, 8192, True, "fused_qmm_ternary_dt_proj"),  # K shorter than one k-tile
    ("zamba2 bc_proj", 3584, 128, False, None),
]
NEW_SITE_ROWS = (1, 4, 8, 17, 256)
HD112 = dict(b=4, t=1024, kh=32, g=1, hd=112)  # zamba2's shared attention: 32 heads over 32 kv heads
HD112_DECODE_VALID = [1, 300, 777, 1024]
HD112_CHUNK = dict(s=256, start=512)
HD112_RAGGED = dict(s=(31, 255), starts=(77, 600))
HD112_WINDOW = 300
G8 = dict(b=4, t=1024, kh=8, g=8, hd=128)  # qwen2-vl: 64 query heads over 8 kv heads
VISION_TAIL = dict(b=1, t=1024 + VLM_TEXT, kh=8, g=8, hd=128)  # the vision prefill's in-chunk tail, S = T = 1040
VLM_SSM_ROWS = {  # JSON row -> what the phase counts for its launches: (route, K, N) or (flash mode, head_dim)
    "fused_qmm_ternary_k29568": ("gemv", 29568, 8192),
    "fused_qmm_ternary_x_proj": ("gemv", 8192, 288),
    "fused_qmm_ternary_dt_proj": ("gemv", 256, 8192),
    "fused_qmm_int8_lm_falcon": ("int8 loop", 4096, 65024), "fused_qmm_int8_lm_zamba2": ("int8 loop", 3584, 32000),
    "flash_attend_int8_hd112": ("kv_int8/decode", 112),
}


def _vlm_ssm_launches() -> _KeyedLaunches:
    """Launches by route, K and N (qdense: where fused_qmm / packed_qmm
    plan the GEMV, the tile or the int8 loop right before launching it) or
    by mode and head_dim (flash_attend's ``launch_plan``).  Installed for
    the phase's serving runs only."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import fused_qmm as fq
    from repro_torch.kernels import packed_qmm as pq

    wraps = [(mod, name, lambda a, route=route: (route, a[1], a[2])) for mod in (fq, pq)
             for name, route in (("gemv_plan", "gemv"), ("tile_plan", "tile"), ("int8_loop_plan", "int8 loop"))]
    wraps.append((fp, "launch_plan", lambda a: (f"{a[0]}/{'decode' if a[2] == 1 else 'prefill'}", a[6])))
    return _KeyedLaunches(wraps)


def _parity_vlm_ssm(dev, gen, errs) -> list:
    """The new shapes against the plain versions: qdense at NEW_SITES, M =
    1, 4, 8, 17, 256, every decode, fused and packed, 0 ulps; flash_attend
    at head_dim 112 (G = 1) in every format -- decode at T 1024, a 256-token
    chunk, ragged chunks, global and a 300-token window --, decode at G = 8
    (hd 128) and the vision prefill's in-chunk tail (S = T = 1040, G = 8),
    5e-5."""
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import get_format

    failures = []
    for fmt in TILE_FORMATS:
        decode = _decode_of(fmt)
        for name, k, n, bias, key in NEW_SITES:
            qt = _qsite(k, n, fmt, gen, dev)
            b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(torch.bfloat16) if bias else None
            for i, m in enumerate(NEW_SITE_ROWS):
                x = _rows(m, k, gen, dev, (torch.bfloat16, torch.float32)[i % 2])
                kw = dict(group=qt.group_size, bias=b, act_exponent=(None, -4)[i // 2 % 2])
                got = _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
                want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
                checks = [(f"qdense {name} K={k} N={n} {fmt} M={m} x={str(x.dtype)[6:]} static_e="
                           f"{kw['act_exponent']} bias={bias}", got, want)]
                if fmt == "ternary" and key and m <= 8:
                    errs[key] = max(errs.get(key, 0.0), float((got - want).abs().max()))
                xq, _ = quantize_rows(x)
                checks.append((f"packed_qmm {name} K={k} N={n} {fmt} M={m}",
                               get_format(fmt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size),
                               packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=decode, group=qt.group_size)))
                for what, g, w in checks:
                    torch.cuda.synchronize()
                    ulps = _ulps(g, w)
                    ok = bool(torch.isfinite(g).all()) and ulps == 0
                    log(f"parity {what}: max_abs_err={float((g - w).abs().max()):.3e} ulps={ulps} "
                        f"{'OK' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(what)
            del qt
            torch.cuda.empty_cache()

    fs = HD112
    cases = [(f, fs, 1, [v - 1 for v in HD112_DECODE_VALID], HD112_DECODE_VALID) for f in SHORT]
    cases += [(f, dict(fs, b=1), HD112_CHUNK["s"], [HD112_CHUNK["start"]], [HD112_CHUNK["start"] + HD112_CHUNK["s"]])
              for f in SHORT]
    cases += [(f, dict(fs, b=2), s, list(HD112_RAGGED["starts"]), [a + s for a in HD112_RAGGED["starts"]])
              for f in SHORT for s in HD112_RAGGED["s"]]
    cases += [(f, G8, 1, [v - 1 for v in HD112_DECODE_VALID], HD112_DECODE_VALID) for f in SHORT]
    tail = VISION_TAIL  # the vision prefill's in-chunk tail: its own bf16 K/V, S = T
    cases.append(("kv_bf16", tail, tail["t"], [0], [tail["t"]]))
    for fmt, shape, s, starts, valid in cases:
        case = _flash_case(fmt, shape, gen, dev, s=s, starts=starts, valid=valid)
        for window in (None, HD112_WINDOW):
            if window is not None:
                case = case[:4] + (torch.tensor([[window]], dtype=torch.int32, device=dev),)
            args = _flash_args(case)
            got = flash_attend(*args, fmt=fmt)
            want = flash_attend_ref(*args, fmt=fmt)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if fmt == "kv_int8" and s == 1 and shape["hd"] == 112:
                errs["flash_attend_int8_hd112"] = max(errs.get("flash_attend_int8_hd112", 0.0), err)
            ok = bool(torch.isfinite(got).all()) and err <= 5e-5
            log(f"parity flash {fmt} hd={shape['hd']} G={shape['g']} Kh={shape['kh']} B={len(starts)} S={s} "
                f"T={shape['t']} start={starts} valid={valid} window={window}: max_abs_err={err:.3e} (atol 5e-5) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash {fmt} hd {shape['hd']} G {shape['g']} S={s} window={window}")
    return failures


def _vision_batch(cfg, dev, n_text=VLM_TEXT):
    """One request's seeded patch embeddings (bf16, as a frontend would
    hand them over), text tokens and M-RoPE positions."""
    from repro_torch.models.vlm import build_mrope_positions

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    nv = cfg.n_frontend_tokens
    return {"tokens": torch.randint(0, cfg.vocab, (1, n_text), generator=gen, device=dev, dtype=torch.int32),
            "vision_embeds": (torch.randn((1, nv, cfg.d_model), generator=gen, device=dev) * 0.1).to(
                getattr(torch, cfg.dtype)),
            "positions": build_mrope_positions(1, nv, n_text, device=dev)}


def _vision_logits(api, params, batch, steps, max_len=VLM_MAX_LEN):
    """Last-token logits of the vision prefill and of ``steps`` greedy
    decode steps after it, (1 + steps, vocab) float32."""
    cache = api.init_cache(1, max_len)
    out = []
    with torch.inference_mode():
        logits, cache = api.prefill(params, batch, cache)
        pos = batch["positions"].shape[-1]
        for i in range(steps + 1):
            out.append(logits[0, -1].float())
            if i == steps:
                break
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            logits, cache = api.decode(params, tok, pos + i, cache)
    return torch.stack(out)


def _family_vlm(dev, totals) -> None:
    """qwen2-vl-72b at VLM_LAYERS of 80 layers: one vision prefill (1024 patch
    embeddings + 16 tokens) through ``api.prefill`` with both flash flags
    over kv_int8, 16 greedy decode steps; both engines on the launcher's
    text traffic."""
    from repro_torch.launch import serve

    cfg = _ptq_cfg(VLM_LAYERS, arch=VLM, kv_fmt="kv_int8", flash_prefill=True)
    booted = _boot_family(dev, cfg, VLM)
    qparams, _, api = booted
    batch = _vision_batch(cfg, dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = _vision_logits(api, qparams, batch, VLM_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    _add(totals, launches)
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (VLM_STEPS + 1, cfg.padded_vocab)
    log(f"{VLM} vision prefill: {cfg.n_frontend_tokens} patch embeddings + {VLM_TEXT} tokens (S = "
        f"{batch['positions'].shape[-1]}, M-RoPE positions), then {VLM_STEPS} greedy decode steps over kv_int8 in "
        f"{dt:.2f} s; tokens {logits.argmax(-1).tolist()}; finite {ok}; launches "
        f"{({k: n for k, n in launches.items() if n})}")
    _require_launches(launches, ["fused_qmm_ternary", "fused_qmm_ternary_prefill", "fused_qmm_int8",
                                 "flash_attend_bf16_prefill", "flash_attend_int8"], f"{VLM} vision prefill")
    if not ok:
        raise SystemExit(f"{VLM}: the vision prefill's logits are not finite or not of their shape")
    prompts = serve.draw_prompts(8, cfg.vocab)
    req = {"staged": SERVE_REQUIRED["staged"], "lockstep": SERVE_REQUIRED["lockstep"]}
    outs = {}
    for kind in ("staged", "lockstep"):
        outs[kind], launches = _run_engine(kind, booted, prompts, max_len=STAGED_MAX_LEN, new=serve.NEW_TOKENS,
                                           label=VLM, required=req[kind])
        _add(totals, launches)
    _compare_engines(VLM, outs)
    del booted, qparams, api
    _free()


def _vlm_twin(dev) -> None:
    """The 2-layer full-width float32 twin of the vision prefill and 4
    decode steps: flash decode (G = 8) against its plain version after the
    prefill on the oracle route, 5e-3 and equal argmax (the in-chunk flash
    tail takes a bf16 model's K/V; its vision shape is held in the parity
    cases).  ROADMAP Queue C13: the oracle route masks by the temporal id,
    so its prefill logits differ from the flash route's (here its plain
    version), as in the reference; the gap is logged, not gated."""
    from repro_torch.models import build_model

    fcfg = dataclasses.replace(_ptq_cfg(2, arch=VLM, kv_fmt="kv_int8", dtype="float32"),
                               quant=dataclasses.replace(_ptq_cfg().quant, mode="fp"))
    fapi = build_model(fcfg, device=dev)
    fparams = fapi.init(torch.Generator(device=dev).manual_seed(SEED))
    batch = _vision_batch(fcfg, dev)
    before = _entries()["flash"].launches
    got = _vision_logits(fapi, fparams, batch, 4)
    launched = _entries()["flash"].launches - before
    with _PlainKernels():
        want = _vision_logits(fapi, fparams, batch, 4)
        flash_route = _vision_logits(build_model(dataclasses.replace(fcfg, flash_prefill=True), device=dev), fparams,
                                     batch, 0)
    c13 = float((flash_route[0] - want[0]).abs().max())
    diff, same = _twin_diff(got, want)
    ok = diff <= 5e-3 and same and launched == 4 * fcfg.n_layers
    log(f"twin fp32 {VLM} kv_int8 (2 layers, full width, vision prefill S = {batch['positions'].shape[-1]} + 4 decode "
        f"steps, {launched} flash decode launches): logits max|kernels - plain versions| = {diff:.3e} (atol 5e-3; "
        f"logit scale {float(want.abs().max()):.3e}); argmax equal {same} {'OK' if ok else 'FAIL'}; the flash "
        f"route's prefill logits differ from the oracle route's by {c13:.3e} (ROADMAP Queue C13, as in the "
        f"reference; not gated)")
    del fparams, fapi
    _free()
    if not ok:
        raise SystemExit(f"twin {VLM}: the kernel path disagrees with the plain path")


def _family_recurrent(dev, totals, arch, required) -> None:
    """All layers of ``arch`` through both engines on the launcher's
    traffic, then one SSM_LONG_PROMPT-token prompt through the staged
    engine's per-token prefill fallback."""
    from repro_torch.launch import serve

    cfg = _ptq_cfg(arch=arch, kv_fmt="kv_int8")
    booted = _boot_family(dev, cfg, arch)
    if booted[2].prefill_chunk is not None:
        raise SystemExit(f"{arch}: expected no prefill_chunk (the staged engine's per-token fallback)")
    prompts = serve.draw_prompts(8, cfg.vocab)
    outs = {}
    for kind in ("staged", "lockstep"):
        outs[kind], launches = _run_engine(kind, booted, prompts, max_len=STAGED_MAX_LEN, new=serve.NEW_TOKENS,
                                           label=arch, required=required)
        _add(totals, launches)
    _compare_engines(arch, outs)
    long_prompt = torch.randint(0, cfg.vocab, (SSM_LONG_PROMPT,), generator=torch.Generator().manual_seed(SEED + 41))
    _, launches = _run_engine("staged", booted, [long_prompt.tolist()], max_len=STAGED_MAX_LEN, new=NEW,
                              label=f"{arch} one {SSM_LONG_PROMPT}-token prompt (per-token fallback)",
                              required=required)
    _add(totals, launches)
    del booted
    _free()


def _ssm_decode_logits(api, params, toks):
    """(steps, B, vocab) float32 logits of one decode step a token."""
    cache = api.init_cache(toks.shape[0], STAGED_MAX_LEN)
    out = []
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            logits, cache = api.decode(params, toks[:, t:t + 1], t, cache)
            out.append(logits[:, -1].float())
    return torch.stack(out)


def _ssm_twins(dev) -> None:
    """falcon-mamba: the 2-layer full-width float32 twin (24 decode steps
    through the recurrent state against the sequence form's logits) and
    its ternary-PTQ twin (decode steps, the qdense kernels against their
    plain versions); zamba2: the HYBRID_TWIN_LAYERS float32 twin (a shared
    block needs 6 Mamba2 layers before it), flash decode at hd 112 against
    the dense oracle over the same kv_int8 cache.  5e-3, equal argmax."""
    from repro_torch.models import build_model, init_quantized

    fp = dict(quant=dataclasses.replace(_ptq_cfg().quant, mode="fp"))
    failures = []

    def tokens(cfg):
        return torch.randint(0, cfg.vocab, (2, TWIN_TOKENS), generator=torch.Generator().manual_seed(SEED + 42)).to(dev)

    def report(label, got, want):
        diff, same = _twin_diff(got, want)
        ok = diff <= 5e-3 and same
        log(f"twin {label}: logits max diff {diff:.3e} (atol 5e-3; logit scale {float(want.abs().max()):.3e}); "
            f"argmax equal {same} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    fcfg = dataclasses.replace(_ptq_cfg(2, arch=SSM, dtype="float32"), **fp)
    toks = tokens(fcfg)
    fapi = build_model(fcfg, device=dev)
    fparams = fapi.init(torch.Generator(device=dev).manual_seed(SEED))
    with torch.inference_mode():
        seq = fapi.forward(fparams, {"tokens": toks}).float().transpose(0, 1)
    report(f"fp32 {SSM} (2 layers, full width, {TWIN_TOKENS} tokens): decode steps vs the sequence form",
           _ssm_decode_logits(fapi, fparams, toks), seq)
    del fparams, fapi
    _free()
    qparams, _, qapi = init_quantized(build_model(_ptq_cfg(2, arch=SSM), device=dev),
                                      torch.Generator(device=dev).manual_seed(SEED))
    got = _ssm_decode_logits(qapi, qparams, toks)
    with _PlainKernels():
        want = _ssm_decode_logits(qapi, qparams, toks)
    report(f"ternary {SSM} (2 layers, full width, {TWIN_TOKENS} decode steps, ulps {_ulps(got, want)}): "
           "qdense kernels vs plain versions", got, want)
    del qparams, qapi
    _free()
    hcfg = dataclasses.replace(_ptq_cfg(HYBRID_TWIN_LAYERS, arch=HYBRID, kv_fmt="kv_int8", dtype="float32"), **fp)
    toks = tokens(hcfg)
    hapi = build_model(hcfg, device=dev)
    hparams = hapi.init(torch.Generator(device=dev).manual_seed(SEED))
    oracle = build_model(dataclasses.replace(hcfg, flash_decode=False), device=dev)
    report(f"fp32 {HYBRID} kv_int8 ({HYBRID_TWIN_LAYERS} layers: 6 Mamba2, a shared block, a tail layer; full width, "
           f"{TWIN_TOKENS} decode steps): flash decode at hd 112 vs the dense oracle",
           _ssm_decode_logits(hapi, hparams, toks), _ssm_decode_logits(oracle, hparams, toks))
    del hparams, hapi, oracle
    _free()
    if failures:
        raise SystemExit(f"twins failed: {failures}")


def phase_vlm_ssm(dev, errs) -> tuple:
    """Parity of the new shapes, then qwen2-vl-72b, falcon-mamba-7b and
    zamba2-7b at their published widths and their twins: (launches by JSON
    row, launches of the phase's own rows)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    failures = _parity_vlm_ssm(dev, gen, errs)
    if failures:
        raise SystemExit(f"vlm_ssm parity failed: {failures}")
    keyed = _vlm_ssm_launches()
    totals: dict = {}
    try:
        _family_vlm(dev, totals)
        _family_recurrent(dev, totals, SSM, ["fused_qmm_ternary", "fused_qmm_int8"])
        _family_recurrent(dev, totals, HYBRID, ["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8"])
    finally:
        keyed.close()
    own = {row: keyed.counts.get(key, 0) for row, key in VLM_SSM_ROWS.items()}
    log(f"vlm_ssm: serving runs {time.perf_counter() - t0:.1f} s; launches of the new rows {own}")
    missing = [row for row, n in own.items() if n <= 0]
    if missing:
        raise SystemExit(f"vlm_ssm: the serving runs never launched {missing}")
    _vlm_twin(dev)
    _ssm_twins(dev)
    log(f"vlm_ssm: phase {time.perf_counter() - t0:.1f} s")
    return totals, own


# ---------------------------------------------------------------------------
# 12. encdec
# ---------------------------------------------------------------------------
WHISPER = "whisper-base"
WHISPER_SITES = [  # (name, K, N, decode, bias, M rows) at whisper-base's widths
    ("wq", 512, 512, "ternary", False, (1, 4, 8, 17, 256, 1500, 6000)),  # K 512: exactly one k-tile
    ("up", 512, 2048, "ternary", True, (1, 4, 8, 17, 256, 1500, 6000)),
    ("down", 2048, 512, "ternary", True, (1, 4, 8, 17, 256, 1500, 6000)),
    ("lm_head", 512, 51968, "int8", False, (1, 4, 8, 17, 256)),  # the int8 head at the padded vocab
]
WHISPER_MAX_LEN = 448  # the decoder's position table; 14 kv_mx blocks
WHISPER_SLOTS, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 64  # the audio path: 4 x 1500 frames, 4-token prompts
HD64 = dict(b=4, t=WHISPER_MAX_LEN, kh=8, g=1, hd=64)  # whisper's self-attention: 8 heads over 8 kv heads
HD64_DECODE_VALID = [1, 100, 300, 448]
HD64_CHUNK = dict(s=64, start=128)
HD64_RAGGED = dict(s=(31, 60), starts=(7, 300))
HD64_TAIL = dict(b=WHISPER_SLOTS, t=WHISPER_PROMPT, kh=8, g=1, hd=64)  # prefill's in-chunk tail, S = T = 4
ENCDEC_ROWS = {  # JSON row -> which planned launches of the phase's serving runs it counts
    "fused_qmm_ternary_k512": lambda key: key[0] == "gemv" and key[2:] == (512, 512),
    "fused_qmm_ternary_k512_m1500": lambda key: key == ("tile", 1500, 512, 512),
    "fused_qmm_ternary_k512_m6000": lambda key: key == ("tile", 6000, 512, 512),
    "fused_qmm_int8_n51968": lambda key: key == ("int8 loop", 512) or (key[0] == "gemv" and key[2:] == (512, 51968)),
    "flash_attend_int8_hd64": lambda key: key == ("kv_int8/decode", 64),
}
ENCDEC_ERR_KEYS = {  # JSON row -> the parity case whose error it reports: (site, M)
    "fused_qmm_ternary_k512": ("wq", 4), "fused_qmm_ternary_k512_m1500": ("wq", 1500),
    "fused_qmm_ternary_k512_m6000": ("wq", 6000), "fused_qmm_int8_n51968": ("lm_head", 4),
}


def _encdec_launches() -> _KeyedLaunches:
    """Launches keyed by route, M, K, N (qdense's GEMV and tile plans), by
    route and K (the int8 loop) or by mode and head_dim (flash)."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import fused_qmm as fq

    wraps = [(fq, name, lambda a, route=route: (route, a[0], a[1], a[2]))
             for name, route in (("gemv_plan", "gemv"), ("tile_plan", "tile"))]
    wraps.append((fq, "int8_loop_plan", lambda a: ("int8 loop", a[1])))
    wraps.append((fp, "launch_plan", lambda a: (f"{a[0]}/{'decode' if a[2] == 1 else 'prefill'}", a[6])))
    return _KeyedLaunches(wraps)


def _parity_encdec(dev, gen, errs) -> list:
    """whisper's shapes against the plain versions: fused_qmm at WHISPER_SITES
    (bf16 x, dynamic and static exponent, the biases), 0 ulps; flash_attend
    at head_dim 64, G = 1, in every format -- decode at T 448 with ragged
    fills, a 64-token chunk, ragged chunks, global and a 100-token window,
    and the prefill's in-chunk tail -- 5e-5."""
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.fused_qmm import fused_qmm_ref

    failures = []
    for name, k, n, fmt, bias, rows in WHISPER_SITES:
        qt = _qsite(k, n, fmt, gen, dev)
        b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(torch.bfloat16) if bias else None
        for i, m in enumerate(rows):
            x = _rows(m, k, gen, dev, torch.bfloat16)
            kw = dict(group=qt.group_size, bias=b, act_exponent=(None, -4)[i % 2])
            got = _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
            want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=fmt, **kw)
            torch.cuda.synchronize()
            err, ulps = float((got - want).abs().max()), _ulps(got, want)
            for row, key in ENCDEC_ERR_KEYS.items():
                if key == (name, m):
                    errs[row] = err
            ok = bool(torch.isfinite(got).all()) and ulps == 0
            log(f"parity qdense whisper {name} K={k} N={n} {fmt} M={m} static_e={kw['act_exponent']} bias={bias}: "
                f"max_abs_err={err:.3e} ulps={ulps} {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"qdense {name} M={m}")
            del x, got, want
        del qt
        torch.cuda.empty_cache()

    fs = HD64
    cases = [(f, fs, 1, [v - 1 for v in HD64_DECODE_VALID], HD64_DECODE_VALID) for f in SHORT]
    cases += [(f, dict(fs, b=1), HD64_CHUNK["s"], [HD64_CHUNK["start"]], [HD64_CHUNK["start"] + HD64_CHUNK["s"]])
              for f in SHORT]
    cases += [(f, dict(fs, b=2), s, list(HD64_RAGGED["starts"]), [a + s for a in HD64_RAGGED["starts"]])
              for f in SHORT for s in HD64_RAGGED["s"]]
    cases.append(("kv_bf16", HD64_TAIL, HD64_TAIL["t"], [0] * HD64_TAIL["b"], [HD64_TAIL["t"]] * HD64_TAIL["b"]))
    for fmt, shape, s, starts, valid in cases:
        case = _flash_case(fmt, shape, gen, dev, s=s, starts=starts, valid=valid)
        for window in (None, 100):
            if window is not None:
                case = case[:4] + (torch.tensor([[window]], dtype=torch.int32, device=dev),)
            args = _flash_args(case)
            got = flash_attend(*args, fmt=fmt)
            want = flash_attend_ref(*args, fmt=fmt)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if fmt == "kv_int8" and s == 1:
                errs["flash_attend_int8_hd64"] = max(errs.get("flash_attend_int8_hd64", 0.0), err)
            ok = bool(torch.isfinite(got).all()) and err <= 5e-5
            log(f"parity flash {fmt} hd=64 G=1 Kh={shape['kh']} B={len(starts)} S={s} T={shape['t']} start={starts} "
                f"valid={valid} window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash {fmt} hd 64 S={s} window={window}")
    return failures


def _audio_batch(cfg, dev, b=WHISPER_SLOTS):
    """b requests' seeded frame embeddings (bf16, as a frontend would hand
    them over) and WHISPER_PROMPT-token decoder prompts."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    return {"frames": (torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=gen, device=dev) * 0.1).to(
                getattr(torch, cfg.dtype)),
            "tokens": torch.randint(0, cfg.vocab, (b, WHISPER_PROMPT), generator=gen, device=dev, dtype=torch.int32)}


def _audio_logits(api, params, batch, steps, max_len=WHISPER_MAX_LEN):
    """(prefill s, decode seconds, (1 + steps, B, vocab) float32 logits) of
    ``api.prefill`` over the frames and prompt, then greedy ``decode_step``s."""
    cache = api.init_cache(batch["tokens"].shape[0], max_len)
    out = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pos = batch["tokens"].shape[1]
        for i in range(steps + 1):
            out.append(logits[:, -1].float())
            if i == steps:
                break
            logits, cache = api.decode(params, logits[:, -1:].argmax(-1).to(torch.int32), pos + i, cache)
        torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, torch.stack(out)


def _family_whisper(dev, totals, keyed) -> None:
    """whisper-base, all 6 + 6 layers: the audio path through the model API
    (encode s; prefill of 4 x 1500 frames + 4 tokens; WHISPER_STEPS greedy
    steps), one decode step's launches by route, then both engines on the
    launcher's text traffic (zero frames: ROADMAP Queue C14)."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec

    cfg = _ptq_cfg(arch=WHISPER, kv_fmt="kv_int8", flash_prefill=True)
    booted = _boot_family(dev, cfg, WHISPER)
    qparams, _, api = booted
    batch = _audio_batch(cfg, dev)
    with torch.inference_mode():
        encdec.encode(qparams, batch["frames"], cfg, api.ctx)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encdec.encode(qparams, batch["frames"], cfg, api.ctx)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    _reset_counts()
    prefill_s, decode_s, logits = _audio_logits(api, qparams, batch, WHISPER_STEPS)
    launches = _read_counts()
    _add(totals, launches)
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (WHISPER_STEPS + 1, WHISPER_SLOTS, cfg.padded_vocab)
    log(f"{WHISPER} audio path: encode {WHISPER_SLOTS} x {cfg.n_audio_frames} frames {enc_s:.3f} s; api.prefill "
        f"(encode + {WHISPER_PROMPT}-token prompt) {prefill_s:.3f} s; {WHISPER_STEPS} greedy decode steps over kv_int8 "
        f"{decode_s / WHISPER_STEPS * 1e3:.2f} ms a step; finite {ok}; tokens of slot 0 "
        f"{logits[:, 0].argmax(-1).tolist()[:16]}...; launches {({k: n for k, n in launches.items() if n})}")
    _require_launches(launches, ["fused_qmm_ternary", "fused_qmm_ternary_prefill", "fused_qmm_int8",
                                 "flash_attend_bf16_prefill", "flash_attend_int8"], f"{WHISPER} audio path")
    if not ok:
        raise SystemExit(f"{WHISPER}: the audio path's logits are not finite or not of their shape")
    # one decode step's planned launches, by route
    cache = api.init_cache(WHISPER_SLOTS, WHISPER_MAX_LEN)
    with torch.inference_mode():
        _, cache = api.prefill(qparams, batch, cache)
        before = dict(keyed.counts)
        api.decode(qparams, batch["tokens"][:, :1], WHISPER_PROMPT, cache)
        torch.cuda.synchronize()
    step = {k: n - before.get(k, 0) for k, n in keyed.counts.items() if n - before.get(k, 0)}
    by_route = {r: sum(n for k, n in step.items() if k[0].startswith(r)) for r in ("gemv", "tile", "int8 loop")}
    by_route["flash hd 64"] = step.get(("kv_int8/decode", 64), 0)
    log(f"{WHISPER} one decode step (B {WHISPER_SLOTS}): launches {by_route}; by shape {step}")
    if min(by_route["gemv"], by_route["tile"], by_route["flash hd 64"]) <= 0:
        raise SystemExit(f"{WHISPER}: a decode step must launch the GEMV, the tile and flash at hd 64: {by_route}")
    with torch.inference_mode():  # where a step's time goes: device busy share and kernels
        _profile(lambda: api.decode(qparams, batch["tokens"][:, :1], WHISPER_PROMPT, cache), 4,
                 f"{WHISPER} decode step trace (B {WHISPER_SLOTS})", "step")
    del cache
    prompts = serve.draw_prompts(8, cfg.vocab)
    outs = {}
    for kind in ("staged", "lockstep"):
        outs[kind], launches = _run_engine(kind, booted, prompts, max_len=WHISPER_MAX_LEN, new=serve.NEW_TOKENS,
                                           label=f"{WHISPER} (zero frames: C14)",
                                           required=["fused_qmm_ternary", "fused_qmm_int8", "flash_attend_int8"])
        _add(totals, launches)
    _compare_engines(WHISPER, outs)
    del booted, qparams, api
    _free()


def _whisper_twin(dev) -> None:
    """The 2 + 2-layer full-width float32 twin of the audio path: flash
    decode (hd 64, over kv_int8) against the dense oracle after the same
    oracle prefill, 5e-3 and equal argmax (the in-chunk flash tail takes a
    bf16 model's K / V; its shape is held in the parity cases)."""
    from repro_torch.models import build_model

    fcfg = dataclasses.replace(_ptq_cfg(2, arch=WHISPER, kv_fmt="kv_int8", dtype="float32", n_enc_layers=2),
                               quant=dataclasses.replace(_ptq_cfg().quant, mode="fp"))
    fapi = build_model(fcfg, device=dev)
    fparams = fapi.init(torch.Generator(device=dev).manual_seed(SEED))
    oracle = build_model(dataclasses.replace(fcfg, flash_decode=False), device=dev)
    batch = _audio_batch(fcfg, dev)
    before = _entries()["flash"].launches
    got = _audio_logits(fapi, fparams, batch, 8)[2]
    launched = _entries()["flash"].launches - before
    want = _audio_logits(oracle, fparams, batch, 8)[2]
    diff, same = _twin_diff(got, want)
    ok = diff <= 5e-3 and same and launched == 8 * fcfg.n_layers
    log(f"twin fp32 {WHISPER} kv_int8 (2 + 2 layers, full width, {WHISPER_SLOTS} x {fcfg.n_audio_frames} frames, "
        f"8 decode steps, {launched} flash decode launches): logits max|flash - oracle| = {diff:.3e} (atol 5e-3; "
        f"logit scale {float(want.abs().max()):.3e}); argmax equal {same} {'OK' if ok else 'FAIL'}")
    del fparams, fapi, oracle
    _free()
    if not ok:
        raise SystemExit(f"twin {WHISPER}: the flash path disagrees with the oracle")


def phase_encdec(dev, errs) -> tuple:
    """Parity at whisper's shapes, whisper-base at its published widths, its
    twin: (launches by JSON row, launches of the phase's own rows)."""
    t0 = time.perf_counter()
    failures = _parity_encdec(dev, torch.Generator(device=dev).manual_seed(SEED + 7), errs)
    if failures:
        raise SystemExit(f"encdec parity failed: {failures}")
    keyed = _encdec_launches()
    totals: dict = {}
    try:
        _family_whisper(dev, totals, keyed)
    finally:
        keyed.close()
    own = {row: sum(n for key, n in keyed.counts.items() if pred(key)) for row, pred in ENCDEC_ROWS.items()}
    log(f"encdec: serving runs {time.perf_counter() - t0:.1f} s; launches of the new rows {own}")
    missing = [row for row, n in own.items() if n <= 0]
    if missing:
        raise SystemExit(f"encdec: the serving runs never launched {missing}")
    _whisper_twin(dev)
    log(f"encdec: phase {time.perf_counter() - t0:.1f} s")
    return totals, own


# ---------------------------------------------------------------------------
# 13. qat
# ---------------------------------------------------------------------------
QAT_BATCH, QAT_SEQ = 2, 256
QAT_QWEN_LAYERS = 4  # of 36: float32 master weights and their gradients at 36 layers are ~64 GB before activations
QAT_CPU_SITE = ("blocks/attn/wq", 4096, 4096)  # the site whose fake-quantized weight is held against the CPU's


class _SteRecorder:
    """Inside ``with``, every ``weights_ste`` call keeps its master weight
    and the gradient that reaches its fake-quantized output, so the
    straight-through contract (the master's gradient IS that gradient) can
    be checked after ``backward()``."""

    def __enter__(self):
        from repro_torch.core import ste

        self.mod, self.fn, self.records = ste, ste.weights_ste, []

        def recorded(w, *a, **kw):
            out = self.fn(w, *a, **kw)
            if out.requires_grad and out is not w:
                rec = {"w": w}
                out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach().clone()))
                self.records.append(rec)
            return out

        ste.weights_ste = recorded
        return self

    def __exit__(self, *exc):
        self.mod.weights_ste = self.fn


def _qat_run(dev, arch, n_layers=None) -> None:
    """``train_loss`` and ``backward()`` of ``arch`` under QAT (ternary group
    64, the paper's policy, float32 master weights) on a 2 x 256 batch:
    the loss finite, every master weight's gradient equal bit for bit to
    the gradient at its fake-quantized weight, the s and peak GB."""
    from repro_torch.models import build_model, make_smoke_batch

    # remat off: the recorder's hooks sit on the forward's tensors, which a recompute replaces (phase 14 trains
    # with remat)
    cfg = _ptq_cfg(n_layers, arch=arch, dtype="float32", quant=dict(mode="qat"), remat=False)
    _free()
    torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    for leaf in _float_leaves(params):
        leaf.requires_grad_(True)
    batch = make_smoke_batch(torch.Generator(device=dev).manual_seed(SEED + 60), cfg, QAT_BATCH, QAT_SEQ)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with _SteRecorder() as rec:
        t0 = time.perf_counter()
        loss = api.train_loss(params, batch)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        loss.backward()
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0 - fwd_s
    mismatched = [i for i, r in enumerate(rec.records) if r["w"].grad is None or not torch.equal(r["w"].grad, r["g"])]
    n_params = sum(leaf.numel() for leaf in _float_leaves(params))
    ok = bool(torch.isfinite(loss)) and rec.records and not mismatched
    layers = f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.family == "encdec" else f"{cfg.n_layers}"
    log(f"qat {arch} ({layers} layers, full width, {n_params / 1e9:.3f} B float32 parameters, batch {QAT_BATCH} x "
        f"{QAT_SEQ}): loss {float(loss):.4f}; init {init_s:.2f} s, train_loss {fwd_s:.2f} s, backward {bwd_s:.2f} s, "
        f"peak {_peak_gb():.2f} GB; {len(rec.records)} weight STE sites, master gradient == gradient at the "
        f"fake-quantized weight bit for bit at {len(rec.records) - len(mismatched)} {'OK' if ok else 'FAIL'}")
    if arch == ARCH:
        _qat_cpu_site(params)
    del params, loss, api, rec
    _free()
    if not ok:
        raise SystemExit(f"qat {arch}: the loss is not finite or the STE gradient differs at sites {mismatched}")


def _tensor_leaves(tree):
    from repro_torch.tree import tree_leaves

    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _float_leaves(tree):
    return (t for t in _tensor_leaves(tree) if t.is_floating_point())


def _qat_cpu_site(params) -> None:
    """One full-width site's fake-quantized weight (Algorithm 1, group 64)
    on the card against the same function on the CPU: the codes that
    differ are counted and logged (ROADMAP Queue C7: the cumsum order)."""
    from repro_torch.quant.formats import fake_quantize_weights

    w = params["blocks"][0]["attn"]["wq"]["w"].detach()
    t0 = time.perf_counter()
    card = fake_quantize_weights(w, 2, GROUP).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fake_quantize_weights(w.cpu(), 2, GROUP)
    cpu_s = time.perf_counter() - t0
    differ = int((card != cpu).sum())
    log(f"qat {QAT_CPU_SITE[0]} ({QAT_CPU_SITE[1]} x {QAT_CPU_SITE[2]}, ternary group {GROUP}): fake-quantized on the "
        f"card ({card_s:.2f} s) vs the CPU ({cpu_s:.2f} s): {differ} of {cpu.numel()} values differ"
        f"{'' if differ else ' (bit for bit)'}")


def phase_qat(dev) -> None:
    """QAT's forward and backward on the card: whisper-base at full depth
    (seeded frames) and qwen3-8b at its published widths, cut to
    QAT_QWEN_LAYERS layers."""
    t0 = time.perf_counter()
    _qat_run(dev, WHISPER)
    _qat_run(dev, ARCH, QAT_QWEN_LAYERS)
    log(f"qat: phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 14. train
# ---------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ = 2, 256
TRAIN_QWEN_DEPTHS = (36, 32, 24)  # all 36 layers; a shallower model only if 36 does not fit, the cut logged
TRAIN_QWEN_STEPS, TRAIN_WHISPER_STEPS = 3, 8
TRAIN_CKPT = os.path.join(HERE, "build", "train_ckpt")
# benchmarks/BENCH_finetune.json: the reference's ternary N64 cell (150 fp + 120 fine-tuning steps), eval losses
RECOVERY_REFERENCE = {"fp": 1.0655, "ptq": 3.0421, "qat": 1.5508, "ttq": 1.4474, "inq": 1.1715}


def _train_cfg(arch, n_layers=None, **over):
    """``arch`` at its published widths under QAT: ternary group 64, the
    paper's policy."""
    return dataclasses.replace(_ptq_cfg(n_layers, arch=arch, quant=dict(mode="qat")), **over)


class _OptTimer:
    """Inside ``with``, the CUDA-event time of every optimizer step the
    trainer takes (read after a synchronise)."""

    def __enter__(self):
        from repro_torch.training import optimizer as opt_lib

        self.mod, self.fn, self.events = opt_lib, opt_lib.apply_updates, []

        def timed(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            return out

        opt_lib.apply_updates = timed
        return self

    def __exit__(self, *exc):
        self.mod.apply_updates = self.fn

    def seconds(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in self.events]


def _timed_steps(tr, batch_fn, n: int) -> tuple:
    """``n`` steps, one ``train`` call each (its one flush synchronises):
    (losses, s a step, optimizer s a step)."""
    losses, secs = [], []
    with _OptTimer() as ot:
        for _ in range(n):
            t0 = time.perf_counter()
            losses += tr.train(batch_fn, 1)["loss"]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    return losses, secs, ot.seconds()


def _steps_str(secs, opt_s) -> str:
    return (f"s a step {', '.join(f'{s:.3f}' for s in secs)} (optimizer {', '.join(f'{s:.3f}' for s in opt_s)}; "
            f"steady {secs[-1]:.3f} s, optimizer {100 * opt_s[-1] / secs[-1]:.1f}%)")


def _train_whisper(dev) -> None:
    """whisper-base at full depth, float32 masters, DFP-8 moments: 8 steps
    with a checkpoint every 4, then a new Trainer restores step 4 (step 8's
    checkpoint removed: the node died before it) and trains 4 more; its
    losses equal the uninterrupted run's within rtol 1e-4 (the reference's
    resume bound; not deterministic mode: the embedding's backward adds
    with atomics), the bit-equal ones counted."""
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, TrainConfig, Trainer
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, make_batch

    cfg = _train_cfg(WHISPER, dtype="float32")
    _free()
    torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    api = api.compiled(params)
    dcfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED)
    batch_fn = lambda i: make_batch(cfg, dcfg, i, device=dev)  # noqa: E731
    tcfg = TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=2, decay_steps=TRAIN_WHISPER_STEPS, state_bits=8),
                       ckpt_dir=TRAIN_CKPT, ckpt_every=4)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    tr = Trainer(api.train_loss, _detached(params), tcfg, plan=api.ctx.plan)  # params stay for the resumed run
    losses, secs, opt_s = _timed_steps(tr, batch_fn, TRAIN_WHISPER_STEPS)
    peak = _peak_gb()
    n_params = sum(t.numel() for t in _float_leaves(tr.params))
    del tr
    assert ckpt.list_steps(TRAIN_CKPT) == [4, 8], ckpt.list_steps(TRAIN_CKPT)
    shutil.rmtree(ckpt.step_dir(TRAIN_CKPT, 8))
    t0 = time.perf_counter()
    resumed = Trainer(api.train_loss, params, tcfg, plan=api.ctx.plan)
    start = resumed.maybe_restore()
    restore_s = time.perf_counter() - t0
    again = resumed.train(batch_fn, TRAIN_WHISPER_STEPS - start)["loss"]
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    ref = losses[start:]
    gap = max(abs(a - b) / abs(b) for a, b in zip(again, ref))
    ok = start == 4 and len(again) == len(ref) and gap <= 1e-4 and all(math.isfinite(x) for x in losses)
    log(f"train {WHISPER} ({cfg.n_enc_layers} + {cfg.n_layers} layers, full width, {n_params / 1e9:.3f} B float32 "
        f"parameters, QAT ternary group {GROUP}, DFP-8 moments, batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {_steps_str(secs, opt_s)}; peak {peak:.2f} GB; restored step "
        f"{start} in {restore_s:.2f} s, steps {start}-{TRAIN_WHISPER_STEPS - 1} again "
        f"{', '.join(f'{x:.4f}' for x in again)}: {sum(a == b for a, b in zip(again, ref))} of {len(ref)} bit-equal, "
        f"largest relative gap {gap:.2e} (rtol 1e-4) {'OK' if ok else 'FAIL'}")
    del resumed, params, api
    _free()
    if not ok:
        raise SystemExit(f"train {WHISPER}: the resumed run's losses {again} differ from {ref}")


def _train_qwen(dev, n_layers: int, steps: int, remat: bool = True) -> dict:
    """qwen3-8b at its published widths, ``n_layers`` deep: bf16 masters,
    QAT ternary group 64, DFP-8 moments, ``remat``; ``steps`` steps on
    2 x 256 tokens.  Returns the losses, times and peaks."""
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, TrainConfig, Trainer
    from repro_torch.training.data import DataConfig, make_batch

    cfg = _train_cfg(ARCH, n_layers, remat=remat)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = build_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    api = api.compiled(params)
    tr = Trainer(api.train_loss, params, TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=0, state_bits=8)),
                 plan=api.ctx.plan)
    del params
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "init_peak": _peak_gb(), "cfg": cfg,
           "params": sum(t.numel() for t in _float_leaves(tr.params)),
           "moment_gb": sum(t.numel() * t.element_size() for k in ("m", "v") for t in _tensor_leaves(tr.opt_state[k]))
           / 1e9}
    torch.cuda.reset_peak_memory_stats()
    dcfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED)
    out["losses"], out["secs"], out["opt_s"] = _timed_steps(tr, lambda i: make_batch(cfg, dcfg, i, device=dev), steps)
    out["peak"] = _peak_gb()
    del tr, api
    _free()
    return out


def _train_qwen_full(dev) -> None:
    """The deepest of TRAIN_QWEN_DEPTHS that fits, 3 steps; then 4 layers
    one step with remat on and off (peak GB)."""
    for n_layers in TRAIN_QWEN_DEPTHS:
        try:
            r = _train_qwen(dev, n_layers, TRAIN_QWEN_STEPS)
            break
        except torch.cuda.OutOfMemoryError:
            total = torch.cuda.get_device_properties(0).total_memory / 1e9
            log(f"train {ARCH}: {n_layers} layers do not fit in {total:.1f} GB; cut to the next depth")
            _free()
    else:
        raise SystemExit(f"train {ARCH}: no depth of {TRAIN_QWEN_DEPTHS} fits")
    n = r["params"]
    ok = all(math.isfinite(x) for x in r["losses"])
    log(f"train {ARCH} ({n_layers} of 36 layers, full width, {n / 1e9:.3f} B bf16 parameters, QAT ternary group "
        f"{GROUP}, DFP-8 moments ({r['moment_gb']:.2f} GB), remat, batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses "
        f"{', '.join(f'{x:.4f}' for x in r['losses'])}; init {r['init_s']:.1f} s (peak {r['init_peak']:.2f} GB); "
        f"{_steps_str(r['secs'], r['opt_s'])}; peak "
        f"{r['peak']:.2f} GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
        f"{'OK' if ok else 'FAIL'}")
    log(f"train {ARCH}: float32 moments would hold {8 * n / 1e9:.1f} GB (m and v at 4 bytes each) beside "
        f"{2 * n / 1e9:.1f} GB of bf16 params and {2 * n / 1e9:.1f} GB of gradients: "
        f"{12 * n / 1e9:.1f} GB before a temporary, more than the card's 80 GB -- not run")
    if not ok:
        raise SystemExit(f"train {ARCH}: a loss is not finite: {r['losses']}")
    peaks = {remat: _train_qwen(dev, 4, 1, remat=remat)["peak"] for remat in (True, False)}
    log(f"train {ARCH} (4 layers, one step): peak {peaks[True]:.2f} GB with remat, {peaks[False]:.2f} GB without")


def _tiny_lm(quant):
    """The reference's benchmark LM (benchmarks/common.py ``tiny_lm``)."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="bench-lm", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab=512, head_dim=32, remat=False, dtype="float32", quant=quant)


def _eval_lm(api, params, cfg, dcfg, dev, n_batches=4, seed=10_000) -> tuple:
    """Loss and next-token top-1 on held-out batches (the benchmark's eval)."""
    from repro_torch.training.data import make_batch

    loss = top1 = 0.0
    with torch.no_grad():
        for i in range(n_batches):
            batch = make_batch(cfg, dcfg, seed + i, device=dev)
            loss += float(api.train_loss(params, batch))
            pred = torch.argmax(api.forward(params, batch)[..., :cfg.vocab], dim=-1)
            top1 += float((pred == batch["labels"]).to(torch.float32).mean())
    return loss / n_batches, top1 / n_batches


def _eval_ptq(params, dcfg, dev, fmt=None) -> tuple:
    """PTQ ternary N64 of ``params`` (on a learned grid where the tree
    carries one), served through the qdense kernels; the ttq format, which
    has no kernel in either package, through the plain backend (``ref``)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import build_model, quantize_and_plan

    backend = "ref" if fmt == "ttq" else "auto"
    cfg = _tiny_lm(QuantConfig(w_bits=2, group_size=GROUP, mode="ptq", backend=backend, fmt=fmt))
    with torch.no_grad():
        qparams, _, qapi = quantize_and_plan(build_model(cfg, device=dev), params)
    return _eval_lm(qapi, qparams, cfg, dcfg, dev)


def _recovery(dev) -> None:
    """The paper's Sec. 4 direction on the benchmark's tiny LM: a float
    baseline (100 steps), one-shot ternary N64 PTQ, then 60 steps of qat,
    ttq and inq fine-tuning each (lr 1e-4, no weight decay); each must end
    below PTQ's loss (the benchmark's --smoke check, direction only)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import build_model
    from repro_torch.quant.state import init_quant_state
    from repro_torch.training import OptConfig, TrainConfig, Trainer
    from repro_torch.training.data import DataConfig, make_batch

    t0 = time.perf_counter()
    cfg = _tiny_lm(QuantConfig(mode="fp", group_size=16))
    api = build_model(cfg, device=dev)
    dcfg = DataConfig(batch=16, seq=64, seed=SEED, structure=0.9)
    batch_fn = lambda i: make_batch(cfg, dcfg, i, device=dev)  # noqa: E731
    tr = Trainer(api.train_loss, api.init(torch.Generator(device=dev).manual_seed(SEED)),
                 TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=20, decay_steps=100)))
    tr.train(batch_fn, 100)
    base = _detached(tr.params)
    rows = {"fp": _eval_lm(api, base, cfg, dcfg, dev), "ptq": _eval_ptq(base, dcfg, dev)}
    for method in ("qat", "ttq", "inq"):
        qcfg = _tiny_lm(QuantConfig(w_bits=2, group_size=GROUP, mode="qat", fmt="ttq" if method == "ttq" else None))
        qapi = build_model(qcfg, device=dev).compiled(base)
        p0, qs = _detached(base), None  # each method fine-tunes its own copy of the baseline
        if method != "qat":
            p0, qs = init_quant_state(p0, qapi.ctx.plan, method, total_steps=60)
        ft = Trainer(qapi.train_loss, p0, TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=0, decay_steps=60,
                                                                    weight_decay=0.0)),
                     plan=qapi.ctx.plan, quant_state=qs)
        ft.train(lambda i: make_batch(cfg, dcfg, 500 + i, device=dev), 60)
        rows[method] = _eval_ptq(_detached(ft.params), dcfg, dev, fmt="ttq" if method == "ttq" else None)
    ok = all(rows[m][0] < rows["ptq"][0] for m in ("qat", "ttq", "inq"))
    table = "; ".join(f"{m} loss {rows[m][0]:.4f} top-1 {rows[m][1]:.4f}"
                      + (f" recovered {rows['ptq'][0] - rows[m][0]:+.4f} (reference "
                         f"{RECOVERY_REFERENCE['ptq'] - RECOVERY_REFERENCE[m]:+.4f})" if m in ("qat", "ttq", "inq")
                         else f" (reference loss {RECOVERY_REFERENCE[m]:.4f})")
                      for m in ("fp", "ptq", "qat", "ttq", "inq"))
    log(f"train recovery (the benchmark LM, 2 layers, d_model 128, vocab 512; fp 100 steps, ternary N{GROUP}, "
        f"fine-tuning 60 steps at lr 1e-4; eval on 4 held-out batches of 16 x 64, PTQ through the qdense kernels, "
        f"ttq's on the plain backend): "
        f"{table}; every method below PTQ {'OK' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s; the "
        f"reference's values from benchmarks/BENCH_finetune.json, 150 + 120 steps, not gated)")
    if not ok:
        raise SystemExit(f"train recovery: a retrained method does not beat one-shot PTQ: {rows}")


def _detached(tree):
    """A detached copy of every tensor of ``tree`` (a Trainer updates the
    tree it is given in place)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


def phase_train(dev) -> None:
    """The training loop on the card: whisper-base's resume, qwen3-8b's
    steps at full depth, the paper's recovery direction."""
    t0 = time.perf_counter()
    _train_whisper(dev)
    _train_qwen_full(dev)
    _recovery(dev)
    log(f"train: phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 15. timings

# ---------------------------------------------------------------------------
class _Timer:
    """CUDA-event time of one call, device memory flushed before each run
    (the decode tick streams 2.3 GB of weights, far more than the 50 MB L2,
    so every site finds its weights cold).  A device-side sleep after the
    flush (~5 ms: a host that stalls for a few ms while it enqueues the
    call must not show in a device time) keeps the card busy while the
    host enqueues the call, so the events time the device work, not the
    wrapper's host overhead."""

    def __init__(self, dev):
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(10_000_000)  # ~5 ms of device time
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


# JSON row -> (format, kernel "fused" | "packed", M, sites): the per-site
# times add up to one layer's 7 projections, or lm_head for int8
LM_HEAD = QDENSE_SITES[-1:]
QDENSE_TIMED = {
    "fused_qmm_ternary": ("ternary", "fused", M_ROWS, LAYER_SITES),
    "fused_qmm_ternary_prefill": ("ternary", "fused", PREFILL_ROWS[-1], LAYER_SITES),
    "fused_qmm_int8": ("int8", "fused", M_ROWS, LM_HEAD),
    "fused_qmm_int8_layer": ("mx", "fused", M_ROWS, LAYER_SITES),  # mx layers: int8 decode, group 32
    "fused_qmm_int8_prefill": ("mx", "fused", PREFILL_ROWS[-1], LAYER_SITES),
    "fused_qmm_int4": ("int4", "fused", M_ROWS, LAYER_SITES),
    "fused_qmm_int4_prefill": ("int4", "fused", PREFILL_ROWS[-1], LAYER_SITES),
    "fused_qmm_nf4": ("nf4", "fused", M_ROWS, LAYER_SITES),
    "fused_qmm_nf4_prefill": ("nf4", "fused", PREFILL_ROWS[-1], LAYER_SITES),
    "packed_qmm_ternary": ("ternary", "packed", M_ROWS, LAYER_SITES),
    "packed_qmm_int4": ("int4", "packed", M_ROWS, LAYER_SITES),
    "packed_qmm_int4_prefill": ("int4", "packed", PREFILL_ROWS[-1], LAYER_SITES),
    "packed_qmm_nf4": ("nf4", "packed", M_ROWS, LAYER_SITES),
    "packed_qmm_int8": ("int8", "packed", M_ROWS, LM_HEAD),
}
QUANTIZE_TIMED = {  # JSON row -> (rows, D, dtype): the decode tick, the prefill chunk, the capacity buffers at C 8
    "quantize_rows": (M_ROWS, 4096, torch.bfloat16), "quantize_rows_prefill": (PREFILL_ROWS[-1], 12288, torch.bfloat16),
    **{row: (key[1], key[2], getattr(torch, key[3][6:])) for row, key in MOE_ROWS.items() if key[0] == "quantize"},
}


def _bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                t_bytes=t_bytes, t_ops=t_ops)


def _time_site(timer, qt, w_bf16, fmt, kernel, m, act, gen, dev, bias=None) -> dict:
    """One site's kernel, plain version and torch.matmul (torch.addmm with
    a ``bias``) on the bf16 dequantized weights; the bound from the bytes
    the call moves (x or its int8 mantissas, packed weights and scales, the
    bias, f32 out) and its int8 operations."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import get_format

    k, n = qt.shape
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    if kernel == "packed":
        xq, _ = quantize_rows(x)
        entry, x_bytes = get_format(fmt).kernel, xq.numel()
        fn = lambda: entry(xq, qt.packed, qt.scale_m, group=qt.group_size)  # noqa: E731
        plain = lambda: packed_qmm_ref(xq, qt.packed, qt.scale_m, decode=_decode_of(fmt),  # noqa: E731
                                       group=qt.group_size)
    else:
        entry, x_bytes = _entry(fmt), x.numel() * x.element_size()
        kw = dict(group=qt.group_size, act=act, bias=bias)
        fn = lambda: entry(x, qt.packed, qt.scale_m, qt.scale_e, **kw)  # noqa: E731
        plain = lambda: fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=_decode_of(fmt), **kw)  # noqa: E731
    nbytes = x_bytes + qt.nbytes() + m * n * 4 + (0 if bias is None else bias.numel() * bias.element_size())
    library = (lambda: torch.matmul(x, w_bf16)) if bias is None else (lambda: torch.addmm(bias, x, w_bf16))
    row = dict(ms=timer(fn), plain_ms=timer(plain, iters=3, warmup=1), library_ms=timer(library),
               **_bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S))
    return row


def phase_timings(dev) -> dict:
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain
    from repro_torch.quant.formats import dequantize_weights

    timer = _Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    rows = {name: dict.fromkeys(keys, 0.0) for name in QDENSE_TIMED}
    for fmt in ("ternary", "int8", "int4", "nf4", "mx"):
        for name, k, n, _, act in QDENSE_SITES:
            timed = [(row, kernel, m) for row, (f, kernel, m, sites) in QDENSE_TIMED.items()
                     if f == fmt and any(site[0] == name for site in sites)]
            if not timed:
                continue
            qt = _qsite(k, n, fmt, gen, dev)
            w_bf16 = dequantize_weights(qt).to(torch.bfloat16)
            for row, kernel, m in timed:
                r = _time_site(timer, qt, w_bf16, fmt, kernel, m, act, gen, dev)
                for key in keys:
                    rows[row][key] += r[key]
                log(f"time {kernel} qdense {name:7s} K={k:5d} N={n:6d} {fmt:7s} M={m:3d}: kernel {r['ms']:.4f} ms, "
                    f"bound {r['bound_ms']:.4f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                    f"torch.matmul bf16 {r['library_ms']:.4f} ms")
            del qt, w_bf16
    for name, row in rows.items():
        row["bound_by"] = "bytes" if row["t_bytes"] >= row["t_ops"] else "operations"
        fmt, kernel, m, sites = QDENSE_TIMED[name]
        log(f"time {name} ({len(sites)} site{'s' * (len(sites) > 1)} at M={m}): kernel {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms (by {row['bound_by']}), plain {row['plain_ms']:.4f} ms, torch.matmul bf16 "
            f"{row['library_ms']:.4f} ms")
    _time_split(timer, gen, dev)
    _time_gemv_choices(timer, gen, dev)
    for name, (m, d, dtype) in QUANTIZE_TIMED.items():
        x = (torch.randn((m, d), generator=gen, device=dev) * 0.1).to(dtype)
        nbytes = x.numel() * x.element_size() + m * d + m * 4  # x in, int8 mantissas and int32 exponents out
        rows[name] = dict(ms=timer(lambda: quantize_rows(x)), plain_ms=timer(lambda: quantize_rows_plain(x), iters=3,
                                                                             warmup=1),
                          library_ms=None, **_bound(nbytes, 0, INT8_OPS_PER_S))
        log(f"time {name} ({m}, {d}) {str(dtype)[6:]}: kernel {rows[name]['ms']:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB; by bytes), "
            f"plain {rows[name]['plain_ms']:.4f} ms, "
            f"library -- (no single call)")

    # flash kv_bf16 at the lockstep decode shape (4 slots x 256 positions)
    fs = FLASH_SHAPE
    case = _flash_case("kv_bf16", fs, gen, dev, s=1, starts=[v - 1 for v in FLASH_VALID], valid=FLASH_VALID)
    rows["flash_attend_bf16"] = _time_flash(timer, "kv_bf16", fs, case, "decode")
    for fmt in ("kv_int8", "kv_mx"):  # the staged decode tick
        fd = FLASH_DECODE
        case = _flash_case(fmt, fd, gen, dev, s=1, starts=[v - 1 for v in FLASH_DECODE_VALID],
                           valid=FLASH_DECODE_VALID)
        rows[f"flash_attend_{SHORT[fmt]}"] = _time_flash(timer, fmt, fd, case, "decode")
    fp = FLASH_PREFILL
    for fmt in SHORT:  # one 256-token chunk from 512
        case = _flash_case(fmt, fp, gen, dev, s=fp["s"], starts=[fp["start"]], valid=[fp["start"] + fp["s"]])
        rows[f"flash_attend_{SHORT[fmt]}_prefill"] = _time_flash(timer, fmt, fp, case, "prefill chunk")
    rows["flash_attention"] = _time_flash_attention(timer, gen, dev)
    _time_families(timer, gen, dev, rows)
    _time_moe(timer, gen, dev, rows)
    _time_vlm_ssm(timer, gen, dev, rows)
    _time_encdec(timer, gen, dev, rows)
    return rows


def _time_families(timer, gen, dev, rows) -> None:
    """The families' new shapes: gemma3's wq (K 3840, a ragged k-tile) at
    M = 4 and 256, qwen1.5-110b's down projection (K 49152) at M = 4,
    flash_attend kv_int8 at hd 240 (the decode tick, a 256-token chunk)
    and flash_attention at hd 240."""
    from repro_torch.quant.formats import dequantize_weights

    for name, (k, n), m in (("fused_qmm_ternary_ragged", RAGGED_SITES[0][1:3], M_ROWS),
                            ("fused_qmm_ternary_ragged_prefill", RAGGED_SITES[0][1:3], PREFILL_ROWS[-1]),
                            ("fused_qmm_ternary_k49152", LONG_K, M_ROWS)):
        qt = _qsite(k, n, "ternary", gen, dev)
        w_bf16 = dequantize_weights(qt).to(torch.bfloat16)
        rows[name] = r = _time_site(timer, qt, w_bf16, "ternary", "fused", m, None, gen, dev)
        log(f"time {name} (K={k} N={n} ternary M={m}): kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"(by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.matmul bf16 {r['library_ms']:.4f} ms")
        del qt, w_bf16
        torch.cuda.empty_cache()
    case = _flash_case("kv_int8", HD240, gen, dev, s=1, starts=[v - 1 for v in HD240_DECODE_VALID],
                       valid=HD240_DECODE_VALID)
    rows["flash_attend_int8_hd240"] = _time_flash(timer, "kv_int8", HD240, case, "decode")
    start, s = HD240_CHUNK["start"], HD240_CHUNK["s"]
    case = _flash_case("kv_int8", dict(HD240, b=1), gen, dev, s=s, starts=[start], valid=[start + s])
    rows["flash_attend_int8_hd240_prefill"] = _time_flash(timer, "kv_int8", HD240, case, "prefill chunk")
    rows["flash_attention_hd240"] = _time_flash_attention(timer, gen, dev, ATTN_HD240[-1], 16)


def _time_moe(timer, gen, dev, rows) -> None:
    """The expert-batched packed_qmm at grok's gate and down (C 8 and 80)
    and arctic's gate (C 8), ternary, every expert routed, and at a decode
    tick's routed experts (grok's gate 5 of 8, arctic's 8 of 128; the
    others' capacity rows zero): kernel, plain version (the loop over
    experts) and ``torch.bmm`` over the bf16-dequantized (E, K, N) weights
    and the same x; the bound from all of x's int8 rows and the f32 out,
    the routed experts' packed weights and scales (what these inputs need)
    and 2 R C K N int8 operations.  The int8 router site (grok, N 8) at M =
    4 as a qdense site."""
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import dequantize_weights, get_format

    entry = get_format("ternary").kernel
    for name, (e, k, n, c, routed) in MOE_TIMED.items():
        qt = _expert_qsite(e, k, n, "ternary", gen, dev)
        x = (torch.randn((e, c, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        if routed < e:  # a decode tick's routed experts: the others' capacity rows are zero
            keep = _routed(e, "some", SEED + k)
            x[[i for i in range(e) if i not in keep]] = 0
        xq = quantize_rows(x.view(e * c, k))[0].view(e, c, k)
        w_bf16 = torch.stack([dequantize_weights(qt.expert(i)).to(torch.bfloat16) for i in range(e)])
        nbytes = xq.numel() + qt.nbytes() * routed // e + e * c * n * 4
        rows[name] = r = dict(
            ms=timer(lambda: entry(xq, qt.packed, qt.scale_m, group=qt.group_size)),
            plain_ms=timer(lambda: packed_qmm_ref(xq, qt.packed, qt.scale_m, decode="ternary", group=qt.group_size),
                           iters=3, warmup=1),
            library_ms=timer(lambda: torch.bmm(x, w_bf16)), **_bound(nbytes, 2 * routed * c * k * n, INT8_OPS_PER_S))
        log(f"time {name} (E={e} K={k} N={n} C={c} ternary, {routed} routed, one call): kernel {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (by {r['bound_by']}; {nbytes / 1e9:.3f} GB), plain {r['plain_ms']:.4f} ms, "
            f"torch.bmm bf16 {r['library_ms']:.4f} ms")
        del qt, x, xq, w_bf16
        torch.cuda.empty_cache()
    k, n = ROUTER_SITES[0]
    qt = _qsite(k, n, "int8", gen, dev)
    rows["fused_qmm_int8_router"] = r = _time_site(timer, qt, dequantize_weights(qt).to(torch.bfloat16), "int8",
                                                   "fused", M_ROWS, None, gen, dev)
    log(f"time fused_qmm_int8_router (K={k} N={n} int8 M={M_ROWS}): kernel {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.matmul bf16 "
        f"{r['library_ms']:.4f} ms")


def _time_vlm_ssm(timer, gen, dev, rows) -> None:
    """The VLM, SSM and hybrid families' new shapes: flash_attend kv_int8
    at hd 112 (zamba2's decode tick: B 4, T 1024, 32 heads over 32 kv
    heads), qwen2-vl's down projection (K 29568, a ragged last k-tile) and
    falcon-mamba's x_proj (N 288) and dt_proj (K 256, with its bias), fused
    ternary at M = 4."""
    from repro_torch.quant.formats import dequantize_weights

    case = _flash_case("kv_int8", HD112, gen, dev, s=1, starts=[v - 1 for v in HD112_DECODE_VALID],
                       valid=HD112_DECODE_VALID)
    rows["flash_attend_int8_hd112"] = _time_flash(timer, "kv_int8", HD112, case, "decode")
    for name, k, n, bias, row in NEW_SITES:
        if row is None:
            continue
        qt = _qsite(k, n, "ternary", gen, dev)
        b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(torch.bfloat16) if bias else None
        rows[row] = r = _time_site(timer, qt, dequantize_weights(qt).to(torch.bfloat16), "ternary", "fused", M_ROWS,
                                   None, gen, dev, bias=b)
        log(f"time {row} ({name}: K={k} N={n} ternary M={M_ROWS}{' + bias' if bias else ''}): kernel {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.5f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"torch.{'addmm' if bias else 'matmul'} bf16 {r['library_ms']:.4f} ms")
        del qt
        torch.cuda.empty_cache()


def _time_encdec(timer, gen, dev, rows) -> None:
    """whisper-base's shapes: wq (K 512, one k-tile) at M = 4 (the GEMV) and
    on the tile at M = 1500 (one slot's cross K / V) and 6000 (the encoder
    of 4 x 1500 frames, a 4-slot step's cross K / V), the int8 lm_head at N
    51968, M = 4, and flash_attend kv_int8 at hd 64 (the decode tick: B 4,
    T 448, 8 heads over 8 kv heads)."""
    from repro_torch.quant.formats import dequantize_weights

    for row, (k, n, fmt, m) in (("fused_qmm_ternary_k512", (512, 512, "ternary", M_ROWS)),
                                ("fused_qmm_ternary_k512_m1500", (512, 512, "ternary", 1500)),
                                ("fused_qmm_ternary_k512_m6000", (512, 512, "ternary", 6000)),
                                ("fused_qmm_int8_n51968", (512, 51968, "int8", M_ROWS))):
        qt = _qsite(k, n, fmt, gen, dev)
        rows[row] = r = _time_site(timer, qt, dequantize_weights(qt).to(torch.bfloat16), fmt, "fused", m, None, gen,
                                   dev)
        log(f"time {row} (K={k} N={n} {fmt} M={m}): kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms (by "
            f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.matmul bf16 {r['library_ms']:.4f} ms")
        del qt
        torch.cuda.empty_cache()
    case = _flash_case("kv_int8", HD64, gen, dev, s=1, starts=[v - 1 for v in HD64_DECODE_VALID],
                       valid=HD64_DECODE_VALID)
    rows["flash_attend_int8_hd64"] = _time_flash(timer, "kv_int8", HD64, case, "decode")


def _time_split(timer, gen, dev) -> None:
    """The tile's k-split choice (kernels/fused_qmm.py::tile_plan), logged:
    wq and wk of a 17-row chunk (a ragged prompt's tail), which the plan
    splits, against the same call unsplit; wk at M = 256, which it does
    not split, against a split forced by a larger scratch budget."""
    from repro_torch.kernels import fused_qmm as fq

    cases = [(17, LAYER_SITES[0], 0), (17, LAYER_SITES[1], 0), (PREFILL_ROWS[-1], LAYER_SITES[1], 64 * 2**20)]
    for m, (name, k, n, _, act), other_budget in cases:
        qt = _qsite(k, n, "ternary", gen, dev)
        x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        fn = lambda: _entry("ternary")(x, qt.packed, qt.scale_m, qt.scale_e, group=GROUP, act=act)  # noqa: E731
        budget = fq.TILE_SPLIT_BYTES
        ms, splits = {}, {}
        for b in (budget, other_budget):
            fq.TILE_SPLIT_BYTES = b
            try:
                splits[b] = fq.tile_plan(m, k, n, "ternary", GROUP)["splits"]
                ms[b] = timer(fn)
            finally:
                fq.TILE_SPLIT_BYTES = budget
        log(f"time tile k-split {name} K={k} N={n} ternary M={m}: plan {splits[budget]} split(s) "
            f"{ms[budget]:.4f} ms; with {splits[other_budget]} split(s) {ms[other_budget]:.4f} ms")
        del qt


def _time_gemv_choices(timer, gen, dev) -> None:
    """The GEMV's two shape choices (kernels/fused_qmm.py), logged at M = 4:
    the k-split cap (GEMV_MAX_SPLITS, the cluster size) on wk and wq
    against a cap of 8; and the int8 routing (uses_int8_loop) on lm_head
    and each of the mx layer's seven sites against the other int8 kernel
    on the same call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_qmm as fq
    from repro_torch.kernels import packed_qmm as pq

    for name, k, n, _, act in LAYER_SITES[:2]:
        qt = _qsite(k, n, "ternary", gen, dev)
        x = (torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        fn = lambda: _entry("ternary")(x, qt.packed, qt.scale_m, qt.scale_e, group=GROUP, act=act)  # noqa: E731
        cap, ms, blocks = fq.GEMV_MAX_SPLITS, {}, {}
        for c in (cap, 8):
            fq.GEMV_MAX_SPLITS = c
            try:
                blocks[c] = fq.gemv_plan(M_ROWS, k, n, "ternary", GROUP)["blocks"]
                ms[c] = timer(fn)
            finally:
                fq.GEMV_MAX_SPLITS = cap
        log(f"time gemv k-split cap {name} K={k} N={n} ternary M={M_ROWS}: cap {cap} ({blocks[cap]} blocks) "
            f"{ms[cap]:.4f} ms; cap 8 ({blocks[8]} blocks) {ms[8]:.4f} ms")
        del qt
    route = fq.uses_int8_loop
    sites = [("lm_head", 4096, 152064, "int8")] + [(name, k, n, "mx") for name, k, n, _, _ in LAYER_SITES]
    for name, k, n, fmt in sites:
        qt = _qsite(k, n, fmt, gen, dev)
        x = (torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        fn = lambda: _entry(fmt)(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size)  # noqa: E731
        chosen = "int8 loop" if route("int8", M_ROWS, k, n, qt.group_size, 512, _build.sm_count(dev)) else "GEMV"
        ms = {chosen: timer(fn)}
        other = "GEMV" if chosen == "int8 loop" else "int8 loop"
        fq.uses_int8_loop = pq.uses_int8_loop = lambda d, *a, o=other, **kw: d == "int8" and o == "int8 loop"
        try:
            ms[other] = timer(fn)
        finally:
            fq.uses_int8_loop = pq.uses_int8_loop = route
        log(f"time gemv int8 route {name} K={k} N={n} {fmt} M={M_ROWS}: {chosen} (taken) {ms[chosen]:.4f} ms; "
            f"{other} {ms[other]:.4f} ms")
        del qt


def _time_flash_attention(timer, gen, dev, shape=ATTN_FULL, heads=ATTN_HEADS) -> dict:
    """The standalone kernel at the parity phase's full-width shape (causal, bf16),
    its plain version and SDPA with is_causal (also top-left aligned); the
    bound from q, k, v read and the output written once, and 4 * hd float32
    operations per live (query, key) pair (the causal half)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    bh, s, t, hd = shape
    q, k, v = _attn_inputs(shape, torch.bfloat16, gen, dev)
    ms = timer(lambda: flash_attention(q, k, v))
    plain_ms = timer(lambda: flash_attention_plain(q, k, v), iters=3, warmup=1)
    # SDPA on the (sequences, heads, S, hd) view of the same tensors: its fused kernels take 4-D inputs
    q4, k4, v4 = (x.view(-1, heads, x.shape[1], hd) for x in (q, k, v))
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    pairs = sum(min(i + 1, t) for i in range(s))  # live keys per query row, summed
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * hd * pairs * bh
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **_bound(nbytes, flops, BF16_TC_OPS_PER_S))
    f32_ms = max(row["t_bytes"], flops / F32_OPS_PER_S * 1e3)  # the bound before the tensor cores
    log(f"time flash_attention causal bf16 BH={bh} S={s} T={t} hd={hd}: kernel {ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the bf16 tensor-core peak; by "
        f"{row['bound_by']}), float32 bound {f32_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bf16 {lib_ms:.4f} ms")
    return row


def _time_flash(timer, fmt, shape, case, what, plan_pairs=None) -> dict:
    """Kernel, plain version and SDPA over the dequantized bf16 cache (the
    yardstick), with the bound from the live cache bytes and the score and
    P.V operations these fill levels need."""
    from repro_torch.kernels.flash_prefill import dequant_tile, flash_attend, flash_attend_ref
    from repro_torch.models.kv_cache import MX_KV_BLOCK

    q, c, q_start, valid, win = case
    args = _flash_args(case)
    b, s, kh, g, hd = q.shape
    t = shape["t"]
    ms = timer(lambda: flash_attend(*args, fmt=fmt, plan_pairs=plan_pairs))
    plain_ms = timer(lambda: flash_attend_ref(*args, fmt=fmt), iters=3, warmup=1)
    kd = dequant_tile(c["k"], c.get("ke"), fmt, 0, t).to(torch.bfloat16).transpose(1, 2)  # (B, Kh, T, hd)
    vd = dequant_tile(c["v"], c.get("ve"), fmt, 0, t).to(torch.bfloat16).transpose(1, 2)
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kh * g, s, hd).to(torch.bfloat16)
    q_pos = q_start + torch.arange(s, device=q.device)[None]  # (B, S)
    k_pos = torch.arange(t, device=q.device)
    mask = ((k_pos[None, None] <= q_pos[..., None]) & (k_pos[None, None] < valid[..., None]))[:, None]
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                                                           enable_gqa=True))
    pairs = int(mask.sum())  # live (query, key) pairs per kv-head group
    live = [int(v) for v in valid.flatten()]
    if fmt == "kv_bf16":
        cache = sum(2 * n * kh * hd * 2 for n in live)
    elif fmt == "kv_int8":
        cache = sum(2 * n * kh * (hd + 1) for n in live)
    else:
        cache = sum(2 * (n * kh * hd // 2 + -(-n // MX_KV_BLOCK) * kh) for n in live)
    nbytes = 2 * q.numel() * 4 + cache + 3 * b * 4  # q in, out, live cache, scalars
    flops = 4 * pairs * kh * g * hd  # q.k and p.v, multiply-add = 2
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, **_bound(nbytes, flops, BF16_TC_OPS_PER_S))
    f32_ms = max(row["t_bytes"], flops / F32_OPS_PER_S * 1e3)  # the bound before the tensor cores
    log(f"time flash {fmt} {what} B={b} S={s} T={t} Kh={kh} G={g} hd={hd} valid={live}: kernel {ms:.4f} ms, "
        f"bound {row['bound_ms']:.5f} ms ({nbytes / 1e6:.3f} MB live, {flops / 1e9:.3f} GFLOP at the bf16 tensor-core "
        f"peak; by {row['bound_by']}), float32 bound {f32_ms:.5f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa bf16 {lib_ms:.4f} ms")
    return row


# ---------------------------------------------------------------------------
# 16. lm_heads: the int8 loop at every family's lm_head
# ---------------------------------------------------------------------------
# (family, K, N, JSON row): each family's int8 lm_head at its published widths (vocab padded to 256); the rows of
# qwen3-8b and whisper-base are timed with their phases (fused_qmm_int8, fused_qmm_int8_n51968), qwen2-vl-72b's
# shape is qwen1.5-110b's
LM_HEAD_SHAPES = [
    ("qwen3-8b", 4096, 152064, "fused_qmm_int8"), ("phi4-mini-3.8b", 3072, 200192, "fused_qmm_int8_lm_phi4"),
    ("gemma3-12b", 3840, 262144, "fused_qmm_int8_lm_gemma3"), ("qwen1.5-110b", 8192, 152064, "fused_qmm_int8_lm_qwen110"),
    ("grok-1-314b", 6144, 131072, "fused_qmm_int8_lm_grok"), ("arctic-480b", 7168, 32000, "fused_qmm_int8_lm_arctic"),
    ("falcon-mamba-7b", 4096, 65024, "fused_qmm_int8_lm_falcon"), ("zamba2-7b", 3584, 32000, "fused_qmm_int8_lm_zamba2"),
    ("whisper-base", 512, 51968, "fused_qmm_int8_n51968"),
]
LM_HEAD_ROWS = (1, 4, 8)
LM_HEAD_TIMED = ("fused_qmm_int8", "fused_qmm_int8_n51968")  # rows timed by earlier phases


def phase_lm_heads(dev, errs) -> dict:
    """Every family's int8 lm_head at its published widths on the int8 loop
    (weights quantized on the card): fused at M = 1, 4, 8 (bf16 with the
    dynamic exponent, float32 with a static one, bf16 with a bias and
    silu), packed over quantize_rows' rows at each M, both 0 ulps against
    the plain versions (arctic's and zamba2's plans split their k-tiles);
    then, for the rows no earlier phase times, the kernel at M = 4 beside
    its bound, the plain version and torch.matmul.  Returns those rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_qmm import fused_qmm_ref, int8_loop_plan, uses_int8_loop
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import dequantize_weights, get_format

    t0 = time.perf_counter()
    timer = _Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    sms = _build.sm_count(dev)
    rows, failures = {}, []
    for family, k, n, row in LM_HEAD_SHAPES:
        qt = _qsite(k, n, "int8", gen, dev)
        bias = torch.randn((n,), generator=gen, device=dev) * 0.1
        cases = [(torch.bfloat16, dict()), (torch.float32, dict(act_exponent=-4)),
                 (torch.bfloat16, dict(bias=bias, act="silu"))]
        worst = 0
        for i, m in enumerate(LM_HEAD_ROWS):
            if not uses_int8_loop("int8", m, k, n, qt.group_size, 512, sms):
                failures.append(f"{family} lm_head M={m} is not on the int8 loop")
            dtype, kw = cases[i]
            x = _rows(m, k, gen, dev, dtype)
            kw = dict(group=qt.group_size, **kw)
            got = _entry("int8")(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
            want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode="int8", **kw)
            xq, _ = quantize_rows(x.to(torch.bfloat16))
            got_p = get_format("int8").kernel(xq, qt.packed, qt.scale_m, group=qt.group_size)
            want_p = packed_qmm_ref(xq, qt.packed, qt.scale_m, decode="int8", group=qt.group_size)
            torch.cuda.synchronize()
            ulps, ulps_p = _ulps(got, want), _ulps(got_p, want_p)
            errs[row] = max(errs.get(row, 0.0), float((got - want).abs().max()))
            worst = max(worst, ulps, ulps_p)
            if ulps or ulps_p or not bool(torch.isfinite(got).all()):
                failures.append(f"{family} lm_head M={m}")
            del x, xq, got, want, got_p, want_p
        plan = int8_loop_plan(M_ROWS, k, n, qt.group_size, 512, sms)
        log(f"parity lm_head {family} K={k} N={n} int8 M={LM_HEAD_ROWS} fused and packed (the int8 loop: "
            f"{plan['splits']} split(s), {plan['warps']} warps): max ulps {worst} {'OK' if not worst else 'FAIL'}")
        if row not in LM_HEAD_TIMED:
            w_bf16 = dequantize_weights(qt).to(torch.bfloat16)
            rows[row] = r = _time_site(timer, qt, w_bf16, "int8", "fused", M_ROWS, None, gen, dev)
            log(f"time {row} ({family} lm_head: K={k} N={n} int8 M={M_ROWS}): kernel {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, torch.matmul bf16 "
                f"{r['library_ms']:.4f} ms")
            del w_bf16
        del qt, bias
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"lm_heads parity failed: {failures}")
    log(f"lm_heads: phase {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# 17. mesh: serving on several GPUs (models/spmd.py) on the one card
# ---------------------------------------------------------------------------
MESH_LAYERS = 2  # grok-1-314b layers of the two-rank run (~2.6 GB of experts; the artifact ~5.5 GB with the vocab)
MESH_DIR = os.path.join(HERE, "build", "mesh_artifact")
MESH_SIZES = {"data": 1, "model": 2}  # dp=1,ep=2: the two ranks share cuda:0 over gloo (NCCL takes one rank a device)
MESH_DECODE_STEPS = 4  # the first decode steps whose logits the two ranks must equal bit for bit
# grok-1's sites at their published widths split over model = 2 and 4: (JSON row, decode, K, N of the whole
# site, ranks, launch key of the two-rank run or None where only model = 4 launches it)
MESH_SITES = [
    ("fused_qmm_ternary_wq_n3072", "ternary", 6144, 6144, 2, ("fused", 0, 6144, 3072, "m<=8")),
    ("fused_qmm_ternary_wq_n1536", "ternary", 6144, 6144, 4, None),
    ("fused_qmm_ternary_wkv_n512", "ternary", 6144, 1024, 2, ("fused", 0, 6144, 512, "m<=8")),
    ("fused_qmm_ternary_wkv_n256", "ternary", 6144, 1024, 4, None),
    ("fused_qmm_int8_lm_grok_n65536", "int8", 6144, 131072, 2, ("fused", 0, 6144, 65536, "m<=8")),
    ("fused_qmm_int8_lm_grok_n32768", "int8", 6144, 131072, 4, None),
    ("fused_qmm_int8_router_n4", "int8", 6144, 8, 2, ("fused", 0, 6144, 4, "m<=8")),
]
MESH_EXPERTS = [  # (JSON row, experts a rank, launch key): grok's gate / up, C 8, every expert routed
    ("packed_qmm_ternary_experts_e4", 4, ("packed", 4, 6144, 32768, "m<=8")),
    ("packed_qmm_ternary_experts_e2", 2, None),
]
MESH_FLASH = [("flash_attend_int8_kh4", 4, ("kv_int8/decode", 4)), ("flash_attend_int8_kh2", 2, None)]
MESH_FLASH_SHAPE = dict(b=4, t=1024, kh=8, g=6, hd=128)  # grok's decode tick: 48 q heads over 8 kv heads
MESH_FULL_DEPTH = [(GROK, 64, 4), (GROK, 64, 8), (ARCTIC, 35, 8)]  # (arch, layers, ep) of the resident reckoning
MESH_ROWS = [site[0] for site in MESH_SITES + MESH_EXPERTS + MESH_FLASH]


def _mesh_launches() -> _KeyedLaunches:
    """The moe phase's keys (the format entries by (kind, E, K, N, mode))
    and flash_attend's plan by (mode, kv heads)."""
    from repro_torch.kernels import flash_prefill as fp

    keyed = _moe_launches()
    keyed._wrap(fp, "launch_plan", lambda a: (f"{a[0]}/{'decode' if a[2] == 1 else 'prefill'}", a[4]))
    return keyed


def _column_shard(qt, parts: int, r: int):
    """Rank ``r``'s columns of a site split ``parts`` ways."""
    cols = qt.n // parts
    sl = slice(r * cols, (r + 1) * cols)
    return dataclasses.replace(qt, packed=qt.packed[:, sl].contiguous(), scale_m=qt.scale_m[:, sl].contiguous(),
                               shape=(qt.k, cols)), sl


def _mesh_parity(dev, timer, errs, rows) -> list:
    """(a) Every shard shape of grok-1's sites: the last rank's launch
    against its plain version and against the whole site's slice, 0 ulps
    (flash: 5e-5 against the plain version, bit for bit the whole call's
    heads); timed at M = 4 beside the bound and the library call."""
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.packed_qmm import packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.quant.formats import dequantize_weights, get_format

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    failures = []
    wholes = {}
    for row, decode, k, n, parts, _ in MESH_SITES:
        if (decode, k, n) not in wholes:
            wholes.clear()
            torch.cuda.empty_cache()
            wholes[decode, k, n] = _qsite(k, n, decode, gen, dev)
        qt = wholes[decode, k, n]
        shard, sl = _column_shard(qt, parts, parts - 1)
        worst = 0
        for m in LM_HEAD_ROWS:
            x = _rows(m, k, gen, dev, torch.bfloat16)
            whole = _entry(decode)(x, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size)
            got = _entry(decode)(x, shard.packed, shard.scale_m, shard.scale_e, group=qt.group_size)
            want = fused_qmm_ref(x, shard.packed, shard.scale_m, shard.scale_e, decode=decode, group=qt.group_size)
            torch.cuda.synchronize()
            worst = max(worst, _ulps(got, want), _ulps(got, whole[:, sl].contiguous()))
            errs[row] = max(errs.get(row, 0.0), float((got - want).abs().max()))
        if worst:
            failures.append(row)
        w_bf16 = dequantize_weights(shard).to(torch.bfloat16)
        rows[row] = r = _time_site(timer, shard, w_bf16, decode, "fused", M_ROWS, None, gen, dev)
        log(f"mesh parity {row} (K={k} N={n}/{parts} {decode} M={LM_HEAD_ROWS}): max ulps {worst} against the plain "
            f"version and the whole site's columns {'OK' if not worst else 'FAIL'}; M={M_ROWS}: kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"torch.matmul bf16 {r['library_ms']:.4f} ms")
        del w_bf16
    wholes.clear()
    torch.cuda.empty_cache()
    entry = get_format("ternary").kernel
    e, k, n, c = 8, 6144, 32768, 8
    qt = _expert_qsite(e, k, n, "ternary", gen, dev)
    x = (torch.randn((e, c, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    xq = quantize_rows(x.view(e * c, k))[0].view(e, c, k)
    whole = entry(xq, qt.packed, qt.scale_m, group=qt.group_size)
    for row, el, _ in MESH_EXPERTS:
        sl = slice(e - el, e)  # the last rank's experts
        packed, scale_m, xs = (t[sl].contiguous() for t in (qt.packed, qt.scale_m, xq))
        got = entry(xs, packed, scale_m, group=qt.group_size)
        want = packed_qmm_ref(xs, packed, scale_m, decode="ternary", group=qt.group_size)
        torch.cuda.synchronize()
        worst = max(_ulps(got, want), _ulps(got, whole[sl].contiguous()))
        errs[row] = float((got - want).abs().max())
        if worst:
            failures.append(row)
        w_bf16 = torch.stack([dequantize_weights(qt.expert(i)).to(torch.bfloat16) for i in range(e - el, e)])
        xb = x[sl].contiguous()
        nbytes = xs.numel() + packed.numel() * 4 + scale_m.numel() + el * c * n * 4
        rows[row] = r = dict(ms=timer(lambda: entry(xs, packed, scale_m, group=qt.group_size)),
                             plain_ms=timer(lambda: packed_qmm_ref(xs, packed, scale_m, decode="ternary",
                                                                   group=qt.group_size), iters=3, warmup=1),
                             library_ms=timer(lambda: torch.bmm(xb, w_bf16)),
                             **_bound(nbytes, 2 * el * c * k * n, INT8_OPS_PER_S))
        log(f"mesh parity {row} (E={el} of 8, K={k} N={n} C={c} ternary, every expert routed): max ulps {worst} "
            f"against the plain loop and the whole stack's experts {'OK' if not worst else 'FAIL'}; kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"torch.bmm bf16 {r['library_ms']:.4f} ms")
        del w_bf16
    del qt, x, xq, whole
    torch.cuda.empty_cache()
    shape = MESH_FLASH_SHAPE
    valid = [1, 300, 777, 1024]
    q_full, c_full, q_start, val, win = _flash_case("kv_int8", shape, gen, dev, s=1, starts=[v - 1 for v in valid],
                                                    valid=valid)
    pairs = shape["b"] * shape["kh"]
    whole = flash_attend(*_flash_args((q_full, c_full, q_start, val, win)), fmt="kv_int8")
    for row, kh, _ in MESH_FLASH:
        hs = slice(shape["kh"] - kh, shape["kh"])
        case = (q_full[:, :, hs].contiguous(), {n_: leaf[:, :, hs].contiguous() for n_, leaf in c_full.items()},
                q_start, val, win)
        got = flash_attend(*_flash_args(case), fmt="kv_int8", plan_pairs=pairs)
        want = flash_attend_ref(*_flash_args(case), fmt="kv_int8")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, whole[:, :, hs])
        errs[row] = err
        if err > 5e-5 or not same:
            failures.append(row)
        rows[row] = r = _time_flash(timer, "kv_int8", dict(shape, kh=kh), case, f"decode, {kh} of 8 kv heads",
                                    plan_pairs=pairs)
        log(f"mesh parity {row} ({shape['g'] * kh} q heads over {kh} of 8 kv heads, hd 128, decode planned for the "
            f"whole call's {pairs} pairs): max err {err:.2e} against the plain version, bit for bit the whole call's "
            f"heads {same} {'OK' if err <= 5e-5 and same else 'FAIL'}")
    return failures


def _mesh_logits(api, params) -> list:
    """Logits of MESH_DECODE_STEPS decode steps over STAGED_SLOTS slots and
    of one 64-token prefill chunk, through ``api`` (sharded or not)."""
    gen = torch.Generator().manual_seed(SEED + 18)
    cache = api.init_cache(STAGED_SLOTS, STAGED_MAX_LEN)
    out = []
    with torch.inference_mode():
        for step in range(MESH_DECODE_STEPS):
            tok = torch.randint(0, api.cfg.vocab, (STAGED_SLOTS, 1), generator=gen).to(torch.int32).to(api.device)
            pos = torch.tensor([step, 3 * step, step + 5, 0], dtype=torch.int32, device=api.device)
            lg, cache = api.decode(params, tok, pos, cache)
            out.append(lg.cpu())
        chunk = torch.randint(0, api.cfg.vocab, (1, 64), generator=gen).to(torch.int32).to(api.device)
        lg, _ = api.prefill_chunk(params, chunk, 0, api.init_cache(1, STAGED_MAX_LEN))
        out.append(lg.cpu())
    return out


def _mesh_serve(api, params, prompts, mesh=None) -> dict:
    """Both engines on the launcher's traffic: tokens and tokens/s."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request, SchedulerConfig, ServingEngine, StagedEngine

    out = {}
    for kind in ("lockstep", "staged"):
        kw = dict(n_slots=STAGED_SLOTS, max_len=STAGED_MAX_LEN, mesh=mesh)
        eng = (StagedEngine(api, params, sched=SchedulerConfig(prefill_chunk=STAGED_CHUNK), **kw) if kind == "staged"
               else ServingEngine(api, params, **kw))
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=serve.NEW_TOKENS))
        done = eng.run(max_ticks=20_000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = sum(len(r.output) for r in done)
        out[kind] = {"tokens": {r.uid: r.output for r in done}, "tok_s": toks / dt, "ticks": eng.stats()["tick"]}
        del eng
    return out


def _mesh_rank(rank: int, world: int, port: int, prompts, out_dir: str) -> None:
    """One rank of the two-rank run: gloo over tcp on the shared card; its
    own shards of the artifact, both engines, the decode logits, resident
    GB, collective bytes and launches by kernel, saved for the parent."""
    import torch.distributed as dist

    from repro_torch.models import load_servable, spmd
    from repro_torch.parallel import collectives
    from repro_torch.parallel.collectives import init_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        mesh = init_mesh(MESH_SIZES, dev)
        probe = {}
        for name, fn in (("all_gather", lambda x: collectives.all_gather(x, mesh, "model", 0)),
                         ("all_to_all", lambda x: collectives.all_to_all(x, mesh, "model", 0, 0)),
                         ("broadcast", lambda x: collectives.broadcast(x, mesh, "model")),
                         ("all_reduce", lambda x: collectives.all_reduce(x, mesh, "model"))):
            try:
                y = fn(torch.full((4, 3), float(rank + 1), device=dev))
                probe[name] = f"ok {y.device} {tuple(y.shape)}"
            except Exception as e:  # the probe's finding is its output; the serving run below decides the phase
                probe[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api, params, _ = load_servable(MESH_DIR, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated(dev) / 1e9
        keyed = _mesh_launches()
        try:
            served = _mesh_serve(api, params, prompts, mesh)
            launches = dict(keyed.counts)
            local, state = spmd.install(params, mesh, api.cfg)
            sharded = spmd.shard_api(api, state)
            collectives.reset_traffic()
            logits = _mesh_logits(sharded, local)
            traffic = collectives.traffic()
        finally:
            keyed.close()
        torch.save({"probe": probe, "load_s": load_s, "resident_gb": resident, "served": served,
                    "launches": launches, "logits": logits, "traffic": traffic, "layouts": state.layouts,
                    "heads_local": state.heads_local, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_two_ranks(dev) -> dict:
    """(b) grok-1-314b at its published widths, MESH_LAYERS layers: the
    parent writes the dp=1,ep=2 sharded artifact and serves in one process;
    two spawned ranks share the card over gloo, each reading only its own
    shards; logits bit-equal, tokens equal.  Returns both ranks' launches
    and the single process's staged tokens."""
    import torch.multiprocessing as mp

    from repro_torch.launch import serve
    from repro_torch.models import save_servable

    cfg = _ptq_cfg(MESH_LAYERS, arch=GROK, kv_fmt="kv_int8", flash_prefill=True)
    label = f"mesh {GROK} {cfg.n_layers}L"
    qparams, plan, api = _boot_family(dev, cfg, label)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    step = save_servable(MESH_DIR, api, qparams, plan, mesh=MESH_SIZES)
    shards = sum(".shard" in f for f in os.listdir(step))
    log(f"{label}: sharded artifact for {MESH_SIZES} in {time.perf_counter() - t0:.2f} s: "
        f"{sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step)) / 1e9:.2f} GB, {shards} shard files")
    prompts = serve.draw_prompts(8, cfg.vocab)
    single = _mesh_serve(api, qparams, prompts)
    single_logits = _mesh_logits(api, qparams)
    del qparams, api
    _free()
    out_dir = os.path.join(HERE, "build", "mesh_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(2, _free_port(), prompts, out_dir), nprocs=2, join=True)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]
    log(f"{label}: two ranks on one card over gloo, {time.perf_counter() - t0:.1f} s with their starts; collectives "
        f"on CUDA tensors {ranks[0]['probe']}")
    failures = []
    r0 = ranks[0]
    equal = [torch.equal(a, b) for a, b in zip(r0["logits"], single_logits)]
    log(f"{label}: decode steps {MESH_DECODE_STEPS} x {STAGED_SLOTS} slots and a 64-token chunk: logits bit-equal to "
        f"the single process {equal} (ranks agree: {all(torch.equal(a, b) for a, b in zip(r0['logits'], ranks[1]['logits']))})")
    if not all(equal) or len(equal) != MESH_DECODE_STEPS + 1:
        failures.append("logits")
    for kind in ("lockstep", "staged"):
        same = all(r["served"][kind]["tokens"] == single[kind]["tokens"] for r in ranks)
        log(f"{label} {kind}: tokens equal to the single process on both ranks {same}; tokens/s two ranks "
            f"{r0['served'][kind]['tok_s']:.2f}, one process {single[kind]['tok_s']:.2f} "
            f"({r0['served'][kind]['ticks']} dispatches)")
        if not same:
            failures.append(f"{kind} tokens")
    steps = MESH_DECODE_STEPS + 1
    for r, res in enumerate(ranks):
        log(f"{label} rank {r}: load {res['load_s']:.2f} s, resident {res['resident_gb']:.2f} GB after load, peak "
            f"{res['peak_gb']:.2f} GB; collective bytes a call (decode steps and the chunk, mean) "
            f"{ {k: v // steps for k, v in res['traffic'].items()} }; layouts {res['layouts']}, heads local "
            f"{res['heads_local']}; launches by kernel {res['launches']}")
    if failures:
        raise SystemExit(f"mesh: the two-rank run differs from the single process: {failures}")
    counts = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in set().union(*(r["launches"] for r in ranks))}
    return counts, single["staged"]["tokens"]


def _mesh_nccl(single: dict) -> None:
    """(c) The launcher under torch.distributed.run on one NCCL rank with
    --mesh dp=1,ep=1 prints ``single``: the single process's staged tokens
    on the launcher's traffic (the launcher's staged engine, same slots,
    max_len, chunk and policy)."""
    argv = ["--artifact", MESH_DIR, "--kv-fmt", "kv_int8", "--flash-decode", "--flash-prefill", "--max-len",
            str(STAGED_MAX_LEN), "--prefill-chunk", str(STAGED_CHUNK), "--requests", "8", "--slots", str(STAGED_SLOTS)]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
                        str(_free_port()), "-m", "repro_torch.launch.serve", *argv, "--mesh", "dp=1,ep=1"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=HERE)
    lines = [line.strip() for line in r.stdout.splitlines() if line.strip().startswith("req ")]
    want = [f"req {u}: {single[u]}" for u in sorted(single)][:4]
    log(f"mesh launcher on NCCL (torch.distributed.run, 1 rank, --mesh dp=1,ep=1): exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; tokens equal to the single process's {lines == want}")
    if r.returncode or lines != want:
        raise SystemExit(f"mesh: the NCCL launcher failed or differs:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")


def _rank_gb(arch: str, n_layers: int, ep: int) -> float:
    """(d) A rank's packed weights at full depth under ep, reckoned from the
    serving rules over the artifact's abstract tree (one layer made on the
    meta device, its layer axis set to ``n_layers``): nothing allocated."""
    from repro_torch.core.quantizer import QTensor
    from repro_torch.models.model_zoo import abstract_quantized
    from repro_torch.parallel.sharding import qtensor_shardings
    from repro_torch.training.checkpoint import stacked_shapes

    cfg = _ptq_cfg(1, arch=arch)
    shapes = stacked_shapes(abstract_quantized(cfg))
    sizes = {"data": 1, "model": ep}
    specs = qtensor_shardings(shapes, sizes)

    def nbytes(t, spec, stacked):
        n = t.numel() * t.element_size() * (n_layers if stacked else 1)
        return n / math.prod(sizes[a] for e in spec if e for a in ((e,) if isinstance(e, str) else e))

    def walk(tree, spec, stacked=False):
        if isinstance(tree, dict):
            return sum(walk(tree[k], spec[k], stacked or k == "blocks") for k in tree)
        if isinstance(tree, QTensor):
            return sum(nbytes(getattr(tree, f), getattr(spec, f), stacked) for f in ("packed", "scale_m", "scale_e"))
        return nbytes(tree, spec, stacked)

    return walk(shapes, specs) / 1e9


def phase_mesh(dev, errs) -> tuple:
    """(a) kernel parity and times at grok-1's shard shapes, (b) the
    two-rank run, (c) the NCCL launcher, (d) the full-depth reckoning:
    (launches of the two-rank run by JSON row, rows)."""
    t0 = time.perf_counter()
    timer = _Timer(dev)
    rows: dict = {}
    failures = _mesh_parity(dev, timer, errs, rows)
    if failures:
        raise SystemExit(f"mesh parity failed: {failures}")
    counts, single = _mesh_two_ranks(dev)
    _mesh_nccl(single)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    for arch, layers, ep in MESH_FULL_DEPTH:
        gb = _rank_gb(arch, layers, ep)
        log(f"mesh reckoning {arch} {layers} layers, ternary group 64, ep={ep}: {gb:.2f} GB of packed weights a rank "
            f"({'fits' if gb < 80 else 'does not fit'} an 80 GB card, {80 - gb:.1f} GB left for caches and work)")
    keys = {row: key for row, *_, key in MESH_SITES}
    keys.update({row: key for row, _, key in MESH_EXPERTS + MESH_FLASH})
    own = {row: (counts.get(key, 0) if key else 0) for row, key in keys.items()}
    missing = [row for row, key in keys.items() if key and own[row] <= 0]
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s; launches of the two-rank run {own} (the model = 4 rows: "
        f"parity and times only, no run launches them)")
    if missing:
        raise SystemExit(f"mesh: the two-rank run never launched {missing}")
    return own, rows


KERNEL_SOURCES = {  # JSON row prefix -> (source in the repo, the TPU kernel it replaces); first match wins
    "fused_qmm_int8_prefill": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/int8_matmul.py:53"),
    "fused_qmm_ternary": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/ternary_matmul.py:63"),
    "fused_qmm_int8": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/int8_matmul.py:53"),
    "fused_qmm_int4": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/int4_matmul.py:53"),
    "fused_qmm_nf4": ("src/repro_torch/csrc/fused_qmm.cu", "src/repro/kernels/nf4_matmul.py:56"),
    "packed_qmm_ternary": ("src/repro_torch/csrc/packed_qmm.cu", "src/repro/kernels/ternary_matmul.py:37"),
    "packed_qmm_int4": ("src/repro_torch/csrc/packed_qmm.cu", "src/repro/kernels/int4_matmul.py:27"),
    "packed_qmm_int8": ("src/repro_torch/csrc/packed_qmm.cu", "src/repro/kernels/int8_matmul.py:27"),
    "packed_qmm_nf4": ("src/repro_torch/csrc/packed_qmm.cu", "src/repro/kernels/nf4_matmul.py:30"),
    "quantize_rows": ("src/repro_torch/csrc/quantize_rows.cu", "src/repro/kernels/quantize.py:45"),
    "flash_attend": ("src/repro_torch/csrc/flash_attend.cu", "src/repro/kernels/flash_prefill.py:158"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:77"),
}


def _kernel_line(errs, launches, rows) -> dict:
    out = []
    for name in (list(MODES) + list(FAMILY_ROWS) + list(MOE_ROWS) + list(VLM_SSM_ROWS) + list(ENCDEC_ROWS)
                 + MESH_ROWS):
        source, replaces = next(v for prefix, v in KERNEL_SOURCES.items() if name.startswith(prefix))
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return {"kernels": out}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="GPU smoke run of the port; with no arguments every phase")
    ap.add_argument("--only", default=None, metavar="PHASE",
                    help="build, then this one phase alone (mesh), for iterating on it; no kernels line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = phase_card()
    dev = torch.device("cuda", 0)
    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            seconds[name] = round(time.perf_counter() - t0, 1)

    timed("build", phase_build)
    if args.only == "mesh":
        timed("mesh", phase_mesh, dev, {})
        log(f"phase seconds {seconds}")
        log(smi)
        return
    if args.only is not None:
        raise SystemExit(f"--only takes mesh, got {args.only!r}")
    errs, launches = timed("parity", phase_parity, dev)
    for name, phase in (("main", phase_main), ("staged", phase_staged), ("formats", phase_formats),
                        ("serve", phase_serve), ("artifact", phase_artifact)):
        for k, v in timed(name, phase, dev).items():
            launches[k] += v
    for name, phase in (("families", phase_families), ("moe", phase_moe), ("vlm_ssm", phase_vlm_ssm),
                        ("encdec", phase_encdec)):
        totals, own = timed(name, phase, dev, errs)
        for k, v in totals.items():
            launches[k] += v
        launches.update(own)
    timed("qat", phase_qat, dev)
    timed("train", phase_train, dev)
    rows = timed("timings", phase_timings, dev)
    rows.update(timed("lm_heads", phase_lm_heads, dev, errs))
    own, mesh_rows = timed("mesh", phase_mesh, dev, errs)
    launches.update(own)
    rows.update(mesh_rows)
    log(f"phase seconds {seconds}")
    line = _kernel_line(errs, launches, rows)
    if not all(math.isfinite(v) for k in line["kernels"] for v in k.values() if isinstance(v, float)):
        raise SystemExit("a measured number is not finite")
    log(f"total {time.perf_counter() - t_start:.1f} s; qdense ms/plain/library/bound of 2- and 4-bit rows are sums "
        f"over one layer's 7 sites (at M={M_ROWS}, and at M={PREFILL_ROWS[-1]} for *_prefill rows; "
        f"fused_qmm_int8_layer and fused_qmm_int8_prefill: mx weights, the int8 decode at group 32; their launches "
        f"are the int8 entry's, lm_head's included), fused_qmm_int8 and packed_qmm_int8 are "
        f"lm_head at M={M_ROWS}; launches are summed over the kernels API call of the parity phase and the lockstep, "
        f"staged, format, serve, artifact and families runs; the families' rows (*_ragged*, *_k49152, *_hd240) are "
        f"single sites or calls, their launches those of their K or head_dim in the families runs (flash_attention: "
        f"its hd 240 parity calls); the moe rows (*_experts_*, fused_qmm_int8_router, quantize_rows_*_c8) are one call "
        f"over every expert of a site (the *_routed* rows: a decode tick's routed experts, the bound from their "
        f"weights), "
        f"the router site or a decode tick's capacity buffer, their launches those of their shape in the moe phase's "
        f"serving runs; the vlm_ssm rows (*_k29568, *_x_proj, *_dt_proj, *_hd112) are single sites or calls, their "
        f"launches those of their shape in the vlm_ssm phase's serving runs; the encdec rows (*_k512*, *_n51968, "
        f"*_hd64) are single sites or calls, their launches those of their shape in the encdec phase's serving runs; "
        f"the lm_head rows (fused_qmm_int8_lm_*: the int8 loop) are each family's int8 lm_head at M={M_ROWS}, their "
        f"launches those of their shape in the families, moe and vlm_ssm phases' serving runs; the mesh rows "
        f"(*_n3072, *_n1536, *_n512, *_n256, *_n65536, *_n32768, *_router_n4, *_experts_e4 / _e2, *_kh4 / _kh2) are the "
        f"last rank's shard of grok-1's sites at model = 2 and 4 at M={M_ROWS} (C 8; flash: the decode tick), their "
        f"launches the two-rank run's (0 for the model = 4 shapes, which no run launches)")
    log(smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
