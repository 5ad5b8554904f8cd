#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases (each prints its lines; any failure ends the run with a non-zero exit):

1. Device: ``nvidia-smi`` name and power limit, the time ``nvcc`` took
   to build the kernels from ``compactfusion_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel), and what ``ptxas -v`` said of each kernel.
2. Each kernel against its plain PyTorch twin at the shapes the main path
   gives it, with the times of both (CUDA events), of one PyTorch call that
   computes the same function where there is one (``library_ms``), and the
   least time the card could take (``bound_ms``): flash attention, banded
   (window) flash attention, the 1-bit quant pair at K=1 and K=2, the 2-bit
   (INT2) pair on fp32 and bf16 bases.  Flash and banded attention also
   name their plan (``ops/flash.py::flash_plan``: body, padded head dim,
   warps) and CTAs (the banded kernel must take the register body, bf16
   kernels 1 and 7 up to d=128 the wgmma body, ``csrc/flash_wgmma.cuh``),
   and flash is timed without dispatch cost on inputs read from DRAM
   (``graph_ms``: CUDA graphs, ``probes/timing.py``).  The VAE's d=512
   attention must take the wide body.  Kernel 1 also runs the wgmma body's
   edge cases (``wgmma_edge_cases``: a batch of no key, a ragged Sq and Sk
   at d88 on 64-row tiles over K/V column slices).  The quant pairs are also timed by
   CUDA graphs on inputs from DRAM, beside the time of an empty kernel
   (the least a launch costs).  Both quants and both dequants run both
   their plans (``ops/quant.py::quant_plan``): the vector kernel at C=1152
   and the scalar one at C=1160 (145 binary and 290 INT2 bytes per row, not
   multiples of 4).  At C=1152 every sender plan goes into every receiver
   plan (the scalar ones forced through the wrappers' internal launches),
   each quant runs on an x view and each dequant on a base view 4 bytes
   into its storage, where they must take the scalar plan: every output
   bit-equal to quant's new base.  Last, ``sdpa``'s no-LSE route (plain
   torch) at PixArt's cross-attention shape, B2 Sq1024 H16 Sk120 d72 with
   ``kv_lens`` (120, 120) and (120, 0): against the math path on the live
   rows, 0 on the dead ones, timed beside the math path and SDPA.
3. The full-width PixArt-alpha 512 pipeline (28 blocks, dim 1152, S=1024,
   CFG batch 2, 20 DPM-Solver++ steps, SD-VAE decode), random weights with
   spiced AdaLN tables, compression off: 3 requests, each from its own seed.
4. The same pipeline with the 1-bit compressed-ring emulation (ring 8,
   residual 1 + error feedback, warmup 4), from request 1's seed.
5. The same with INT2 through the fused 2-bit kernels.
6. The same with LOW_RANK, rank 4 (subspace iteration; no quant kernel).
7. A per-layer plan on int8-quantized EF caches: layer 0 uncompressed,
   layers 1-13 INT2, layers 14-27 BINARY with a rank-2 scale.
8. DiTFastAttn with an all-FULL plan: the lossless latents, bit for bit.
9. DiTFastAttn with a fixed plan that holds all seven methods after
   ``optimize_plan`` (window 64): the banded kernel on the path.
10. ``calibrate_pixart`` on request 1's text and noise (threshold 0.5,
    window 64), then the request with the calibrated plan.
11. FBCache at threshold 0 (the lossless latents, no skip) and 1e6 (18
    skipped steps), then FBCache 0.12 and TeaCache 0.25.
12. The two ring kernels against their twins, one rank's view with the
    other ranks' blocks or payloads made in this process (each virtual rank
    updates its own copy of the EF stacks, which must stay bit-equal):
    ring 2 at the path's shape (512 tokens per rank, B 2 and B 1) and ring 8
    (128 tokens per rank); BINARY at K=1 and K=2, INT2 and LOW_RANK r4 on
    fp32 stacks, and on int8 stacks at B 1.  Kernel 7 is timed as kernel 1
    in phase 2 (plan, ``graph_ms``), and a ring-8 hop on the register body
    must launch at least 128 CTAs (the wgmma body's 64-row tiles give 64);
    so must kernel 8's flash partial there, and kernel 8 and its
    EF pass (``ef_update_slot``, checked alone against its twin) are timed
    eager and by CUDA graphs on cloned stacks.  Kernel 7 also runs a ring 3
    of 700 queries against hops of 513 keys (``ring_edge_cases``).
13. The pipeline cut to SP_CUT (7) of its 28 blocks (the script's
    time limit) as a ring of 2 processes that share this GPU (a
    gloo group: NCCL refuses two ranks on one device), lossless, unfused
    and through the fused ring kernel, against request 1's lossless
    latents of one process on the same cut; first cfg 2 alone (each
    process one CFG half, no ring), which runs the model at a ring-2
    rank's rows per GEMM without the ring.  Before the ranks, this process
    runs request 1 on the cut with each CFG half's forward alone at B1, as
    a cfg-2 rank does: what the batch alone moves against the B2 request.
    Every run of phases 13-15 is also held against it.  Phases 13-15, 24,
    25 and 27 share one spawn of 2 processes and one of 4.
14. The same ring with BINARY compression (warmup 4), unfused and through
    the fused compressed ring kernel, against the single-process ring-2
    emulation of the same request, against each other and against lossless;
    both send the same bytes.
15. cfg 2 x ring 2 in 4 processes (the cut): fused LOW_RANK r4 on int8 EF caches
    (B 1 per rank) with the consistency check on: the caches stay equal.
16. The flash profiling probes (``compactfusion_tpu_torch/probes``): each
    stage mask of ``flash_parts`` (kernel 1's register body) and
    ``dma_only`` against its twin at B2 H16 S1024 d72 (``full`` bit-equal
    to kernel 1 launched on the same register-body plan, ``ops/probes.py::
    PLAN``, on the same views,
    ``dma_only`` bit-equal to its twin, the others by largest and relative
    error), ``plumb`` bit-equal to its twin on column slices of one qkv
    tensor and timed on enough of them in turn that each call reads from
    DRAM, not L2 (it fails below its bound); then both probes' entry
    points: the stage breakdown of kernel 1 (nine rows and SDPA, per call
    without dispatch cost, on inputs from DRAM) and the full-width
    28-block forward with parts of the block switched off or replaced (per
    forward by CUDA-graph replay and eager), with the block-level
    breakdown.

17. Kernels 1, 2, 3, 7 and 8 against their twins at FLUX.1-dev's shapes:
    kernel 1 over the 512 text + 4096 image tokens at 24 heads of 128 (the
    wgmma body at DP 128: 8 consumer warps, 864 CTAs), at the two hops of the
    unfused ring 2 (the text in front of hop 0's K/V) and the fused ring's
    text block, and on the wide body at the VAE's 128 x 128 tokens; the
    1-bit pair at N2048 C3072 (the vector plans); kernels 7 and 8 (and 8's
    EF pass) at the ring-2 hop, q holding the text rows in front of the
    2048 local image rows.
18. FLUX.1-dev at full width and depth (19 double + 38 single blocks, dim
    3072, bf16, 11.9B parameters), 28 flow-match steps at guidance 3.5,
    1024 x 1024, random weights with spiced modulation biases, T5 states
    (1, 512, 4096) and a pooled vector (1, 768) from each request's seed:
    3 requests (kernel 1 exactly 57 x 28 + 1 times, once on the wide body;
    s/image and ``torch.cuda.max_memory_allocated``); request 1 again with
    the tracer switched on (``utils/prof.py``): the same latents, its
    summary window holds the request, its decode, 28 steps and 57 x 28
    attention spans with device times and the wgmma route, and the
    ``flash.body.*`` counters equal kernel 1's route counters; then FBCache
    at threshold 0 (the lossless latents, no skip) and 1e6 (26 skipped
    steps, 57 x 2 + 26 + 1 kernel 1 launches).
19. FLUX.1-dev with its depth cut to 1 double + 2 single blocks (full
    width) as a ring of 2 processes on this GPU: lossless and BINARY
    (residual 1 + EF, warmup 4, the consistency check on), unfused and
    fused, each against one process running the same cut model lossless,
    the fused runs against the unfused ones; EF caches equal across ranks,
    the binary runs' wire bytes those of their payloads.
20. Kernels 1, 4, 7 and 8 (and 8's EF pass) on fp32 q/k/v, as the Pallas
    kernels take the input dtype, against their fp32 twins (TF32 off):
    kernel 1 at PixArt's self-attention (also with a batch of no key: LSE
    -inf rows), FLUX's d=128 and the VAE's d=512 (the wide body), kernel 4
    at w = 64, 0 and 1024, kernel 7 at ring 2 (B2, B1), ring 8 and FLUX's
    ring 2, kernel 8 with BINARY K1 and INT2 on fp32 stacks (B2) and int8
    stacks (B1) and at FLUX's ring 2: out within F32_OUT_REL_MAX, LSE within
    F32_LSE_ATOL, kernel 8's stacks and fp32 reconstructions bit for bit;
    each with its plan, eager and ``graph_ms`` times, the fp32 bound, one
    fp32 SDPA call and what ptxas said of it.  No fp32 instantiation may
    spill.
21. PixArt-alpha 512 in fp32 at full width (the model and its SD-VAE,
    ``dataclasses.replace(..., dtype=torch.float32)``): 2 requests, every
    flash launch an fp32 one (28 x 20 + the VAE's on the wide body); one
    CFG forward of request 1's first step against the same forward on this
    machine's CPU through the plain versions, within F32_FORWARD_REL_MAX;
    DiTFastAttn's fixed mixed plan in fp32 (kernel 4).
22. That fp32 pipeline, cut to SP_CUT (7) of its 28 blocks
    (the script's time limit), as a ring of 2 processes on this GPU (gloo),
    lossless and BINARY (the consistency check on), unfused and fused:
    every run within F32_RING_LOSSLESS_REL_MAX (lossless, of one process's
    request 1 on the same cut) or F32_RING_BINARY_REL_MAX (BINARY, of the
    fp32 ring-2 emulation of the cut and, fused, of the unfused run) of one process,
    the BINARY runs also 0 < err < 0.05 from lossless, EF caches equal
    across ranks, the same wire bytes on both routes.
23. Kernels 1, 2/3, 5/6, 7 and 8 against their twins at the shapes
    Ulysses and the patch gather give them (``sp_flash_cases``,
    ``sp_ring_cases``): kernel 1 at U2 (B2 H8 S1024 d72), the U2 x R2 hop
    (512 rows), the patch gather at R2 (512 query rows over 1024 keys, 16
    heads) and FLUX's U2 and U2 x R2 hop 0 (12 heads of 128, the text rows
    in each Ulysses rank's chunk); the quant pairs at the compressed
    all-gather's N1024 C1152 and the compressed USP ring's N1024 C576 (the
    vector plans, every plan pairing bit for bit); kernels 7 and 8 (BINARY
    and INT2) at the U2 x R2 hop, 8 heads, and FLUX's at 12 heads of 128.
24. PixArt-alpha 512 at full width, its depth cut to SP_CUT (7) of 28
    blocks (the script's time limit), as Ulysses ranks on this
    card (gloo): U2 in 2 processes, lossless; U2 x R2 in 4, lossless and
    BINARY (the consistency check on), unfused and fused: lossless within
    HALVES_REL_MAX of one process's request 1 on the same cut, BINARY 0 <
    err < 0.05, fused within
    RING_REL_MAX of unfused, EF deviation 0, the ring and all-to-all bytes
    the shapes imply.
25. The patch-parallel gather at R2 in 2 processes: sync (within
    HALVES_REL_MAX), BINARY and INT2 (residual 1 + EF, warmup 4, the
    consistency check on: 0 < err < 0.05, every slot equal across ranks),
    DistriFusion's stale gather (0 < err <= PATCH_ASYNC_REL_MAX); the
    gathered bytes W times the payloads', and the dense-over-compressed
    ratio.
26. FLUX.1-dev at phase 19's cut depth as U2 (2 processes, phase 19's
    spawn) and U2 x R2 (4;
    lossless and BINARY, unfused and fused), with phase 19's bounds against
    one process running the same cut model.
27. FBCache at R2 in 2 processes (PixArt's cut), the probe summed over the
    ring: threshold 0 bit-equal to phase 13's ring-2 lossless run, 1e6
    RANK_STEPS - 2 skipped steps on both ranks.
28. The prompt encoders at their published widths and depths: T5-XXL (24
    layers, d_model 4096, 64 heads of 64, d_ff 10240) and CLIP-L with seeded
    bf16 weights on the card behind the byte tokenizers
    (``models/prompt.py``): FLUX's prompt batch at 512 tokens and PixArt's
    cond/uncond pair at 120, ms per batch (CUDA events) and peak memory; both
    encoders cut to 2 layers in fp32 within ENCODER_F32_REL_MAX of the CPU's
    plain run; the int8 T5 (``--use_int8_t5_encoder``) against the bf16 one
    at full depth within T5_INT8_REL, its parameters under
    T5_INT8_BYTES_MAX of the bf16 bytes.  No port kernel may launch.
29. ``xDiTParallel`` built from ``xFuserArgs`` on the README's argument
    lists: PixArt-alpha 512 (20 steps, CFG) and FLUX.1-dev 1024 (28 steps,
    guidance 3.5), ``prepare_run``, then 2 requests from prompts (s/image by
    CUDA events, prompt encoding included; kernel 1's launches an image equal
    to phase 3's and phase 18's); ``save`` writes a PNG, read back with the
    port's own decoder; then FLUX.1-dev with ``--quantize_backbone_int8``:
    latents within BACKBONE_INT8_REL_MAX of the bf16 run and a lower peak
    memory.
30. The HTTP service (``entrypoints/launch.py``) on PixArt-alpha 512 at
    ``serve_batch`` 2 on localhost: ``/health``, then 4 concurrent
    ``/generate`` requests, each answered with a 512 x 512 PNG and its
    latency; at least one pipeline call packs 2 requests.
31. ``examples/pixartalpha_example.py``'s ``main`` as 2 gloo processes on
    the card (PixArt at RUNNER_CUT (14) of its 28 blocks, the script's
    time limit) at ``--ring_degree 2`` (``--output_type latent``), lossless and
    ``--compact --compact_type binary``: lossless within HALVES_REL_MAX of
    the one-process runner's request, BINARY within COMPRESSED_REL_ERR_MAX
    and above 0; exact launch counts and ring-shift bytes per rank.

32. Kernels 1, 2, 3, 5, 6, 7 and 8 (and 8's EF pass) against their twins
    at CogVideoX-2b's shapes (30 heads of 64: kernel 1 on the wgmma
    body's DP 64 plan): kernel 1 over the 226 text + 17,550 video tokens at
    the CFG batch 2, at Ulysses 2 (15 heads, both ranks' text rows among the
    queries) and at the two hops of the unfused ring 2 (the text in front of
    each rank's 8,775 rows), its twin on (batch row, 2 or 3 heads) slices
    (the whole call's fp32 scores would take 76 GB), timed beside one
    SDPA call on the whole shape; the quant pairs at N8775 and N17550 x C1920
    (the vector plans, a rank's rows at B1 and B2; every plan pairing bit for
    bit); kernels 7 and 8 (BINARY and INT2) at ring 2, B1, q holding the
    text rows in front of the 8,775 local rows (a ragged last 64-row EF tile).
33. CogVideoX-2b at full width and depth (30 blocks, dim 1920) through
    ``xDiTParallel`` from the published command line (49 x 480 x 720,
    guidance 6, ``--max_sequence_length 226``) at 10 of its 50 steps since
    (the script's time limit), random weights with
    spiced modulation biases, T5-XXL at full size behind the byte
    tokenizer: a 2-step warm-up, then the request (kernel 1 exactly 30 x 10
    times; s/video, s/step, encode and decode by CUDA events; peak memory):
    a finite, non-constant (1, 49, 480, 720, 3) video in [0, 1]; the dense
    and the tiled 3D VAE decode of its latents (seconds, peak memory); the
    model cut to 2 blocks in fp32, one CFG forward at 9 frames on the card
    against the CPU's plain run within ENCODER_F32_REL_MAX.
34. CogVideoX-2b at full width and the whole 17,550 tokens, cut to 2 blocks,
    4 steps, as 2 processes on this card (gloo): ring 2 lossless, BINARY and
    INT2 (residual 1 + EF, warmup 2, the consistency check on), each unfused
    and fused (the compressed rings take the unfused route, bit-equal to it:
    the fused compressed ring needs a multiple of 8 query rows, and a rank
    holds 226 + 8,775); Ulysses 2 lossless and BINARY (a ring of 1:
    bit-equal to lossless); cfg 2 (bit-equal to one process running each
    CFG half at B1).  The order floor is measured first: one process with
    kernel 1 swapped for its plain twin, against the kernel's run.
    Lossless runs within COG_RING_REL_MAX of one process running the same
    cut model and of the twin's run, the fused lossless ring within it of
    the unfused one; compressed 0 < err < 0.05; EF deviation 0; the ring,
    all-to-all and cfg bytes the shapes imply.
35. Kernel 1 against its twin at PixArt's patch-pipeline shapes (the patch
    queries, 512 rows at M = 2 and 256 at M = 4, against the whole
    1,024-token K/V cache, B2), timed eager and by CUDA graphs beside SDPA;
    then PixArt-alpha 512 at full width, at RUNNER_CUT (14) of its 28
    blocks (the script's time limit), through ``xDiTParallel``
    from its prompt in 4 gloo processes on this card: sync PipeFusion pp2
    (``--num_pipeline_patch 1``; bit-equal to the one-process runner
    expected, within HALVES_REL_MAX), the patch pipeline at pp2 with M = 2
    (the default) and with M = 4 after 2 warmup steps (PATCH_PP_REL from
    sync), TP 2 (within HALVES_REL_MAX), TP 2 with DiTFastAttn from a
    cached plan (phase 21's mixed plan on the 14 blocks, the runner's cache
    file; within HALVES_REL_MAX of the one-process runner running the same
    cached plan, kernel 4 launched as the plan implies), pp2 x ring 2 BINARY (the
    consistency check on: 0 < err < 0.05, EF deviation 0), and ring 2 with
    2 VAE ranks (rank 0's image within VAE_RANKS_ATOL and VAE_RANKS_MEAN of
    the one-process decode of its latents, no image on the other ranks);
    exact launch counts on every rank (each stage's 7 blocks a forward,
    the patch pipeline's (steps - warmup) x M patches).
36. Kernel 1 against its twin at FLUX's patch shape (the 512 text rows in
    front of a 1,024-row patch against 4,608 keys, 24 heads of 128); then
    phase 19's FLUX.1-dev cut (padded with zero blocks to 2 + 2 under pp2)
    and phase 34's CogVideoX-2b cut at full width, in 2 gloo processes:
    FLUX sync pp2 within PP_FLUX_REL_MAX of one process running the same
    padded model, the patch pipeline pp2 M = 4 within PATCH_PP_REL of
    sync, TP 2 within RING_REL_MAX; CogVideoX sync pp2 and TP 2 within
    COG_RING_REL_MAX of phase 34's one process; exact launch counts.
37. Kernels 1-8 against their twins at SD3-medium's shapes (the 197 text
    rows in front of 4,096 image rows, 24 heads of 64: self-attention,
    Ulysses 2, the ring-2 hops, the patch at M = 2), HunyuanDiT v1.2's (16
    heads of 88 on the wgmma body at DP 96, whose instantiations must
    not spill; the 8 padded columns must not reach out or the LSE),
    PixArt-Sigma's (4,096 and 16,384 tokens; kernel 4 at 16,384, w64) and
    the 2K VAE's dense mid-attention (65,536 rows of d = 512 in one wide
    launch, its twin on 4,096-row query slices); the quant pairs at the
    rings' N4096 x C1536 and C1408; kernels 7 and 8 at HunyuanDiT's and
    Sigma's ring 2.
38. The 2D VAE's decode knobs on random weights (B2): SD3's and FLUX.1's
    1024 px latents and Sigma 2K's 256 x 256 (SDXL VAE): dense, sliced
    (each image bit-equal to its decode alone; within SLICED_REL_MAX of the
    B2 decode) and tiled (0 < err < TILED_REL_MAX); seconds and peak memory
    of each; kernel 1 once a call, a slice or a tile.
39. SD3-medium (24 blocks, dim 1536, 2.06B parameters) through
    ``xDiTParallel`` from its command line at 1024 x 1024, 28 steps,
    guidance 7, spiced modulation: a warm-up request, then the request
    (kernel 1 exactly 24 x 28 + 1 times, a valid image, s/image by CUDA
    events, peak memory); the 2-block fp32 cut's CFG forward (512 px) on the card
    against the CPU within ENCODER_F32_REL_MAX.
40. HunyuanDiT v1.2 (40 blocks, 16 heads of 88) likewise at 25 steps,
    guidance 5 (kernel 1 40 x 25 + 1 times); its 2 + 2-block fp32 cut.
41. PixArt-Sigma 1024 and 2K through ``xDiTParallel`` (20 steps; 2K with
    ``--enable_tiling``: kernel 1 28 x 20 times and once per VAE tile of
    512 latent pixels or more); then 2K with phase 9's mixed DiTFastAttn
    plan (kernel 4 at 16,384 tokens; the launches the plan implies).
42. SD3-medium and HunyuanDiT v1.2 at full width and 1024 x 1024, cut to 2
    and 2 + 2 blocks, 6 steps, in 2 gloo processes: ring 2 lossless,
    BINARY and INT2, unfused and fused (SD3's compressed fused runs take
    the unfused route: 2,245 query rows a rank), U2, cfg 2, sync pp2
    (HunyuanDiT's skip stacks crossing to the mirror stage), the patch
    pipelines (M 2, M 4), TP 2; against one process on the same cut, the
    CFG halves at B1 and the bf16 order floor (kernel 1 swapped for its
    twin) measured in the same run: lossless and TP within max(RING_REL_MAX,
    ORDER_FLOOR_FACTOR x floor), sync pp2 within PP_FLUX_REL_MAX, cfg 2
    bit-equal to the halves, compressed 0 < err < 0.05 with EF deviation 0,
    the patch pipelines in PATCH_PP_REL of sync; exact launch counts; the
    ring, cfg and all-to-all bytes the shapes imply.
43-47. The stats and collector taps; Latte-1, ConsisID-preview and
    HunyuanVideo-T2V at full width and depth through ``xDiTParallel``, and
    cut in depth across 2 gloo processes (Latte also at tp 2 and pp 2,
    pp bit-equal to one process; ``observability_phase``,
    ``latte_phase``, ``consisid_phase``, ``hunyuanvideo_phase``,
    ``video_ring_phase``).
48. Kernel 1 at Step-Video-T2V's B2 H48 S18,972 d128 against its twin on
    head slices and cuDNN, kernels 2, 3, 5-8 at phase 49's shapes, then
    Step-Video-T2V at full width and depth (48 blocks, 58.7 GB of bf16
    weights) through ``xDiTParallel`` at 204 x 544 x 992, SV_STEPS steps,
    CFG 9: s/step, peak memory, kernel 1 once a block and step, the
    latents (1, 18,972, 64) finite (``stepvideo_phase``).
49. Step-Video cut to SV_CUT blocks in 2 gloo processes: TP 2, U2, cfg 2,
    ring 2 lossless (fused or not) and BINARY (also on kernel 1's twin) at
    544 x 992 x 34; BINARY unfused and fused (kernel 8) at 512 x 512 x 17;
    lossless within max(RING_REL_MAX, ORDER_FLOOR_FACTOR x floor) of one
    process, BINARY within SV_BINARY_REL_MAX of it and within the lossless
    bound of its twin ring and of unfused; EF deviation 0
    (``stepvideo_ring_phase``).
50. Kernel 1 at d 576 and 1024, kernel 4 at d 256 (w 64 and 0), kernels 7
    and 8 at d 256, in bf16 and in fp32, on TILE_BODY, within FLASH_OUT_REL_MAX
    (bf16) or TILE_F32_REL_MAX (fp32) of their twins (``check_tile_kernels``),
    which no model path runs.
51. The quality-eval package on the card (``quality_phase``): InceptionV3,
    VGG16-LPIPS and I3D in fp32 on seeded weights, each against the same
    module on the CPU (FEATURE_REL_MAX), ms per batch and peak memory; PSNR,
    SSIM and LPIPS of phases 4-7's images against phase 3's lossless one
    (lossless against itself 120 dB, SSIM 1, LPIPS 0), PSNR and SSIM within
    METRIC_CARD_REL_MAX of the CPU's; ``video_psnr``, ``video_ssim`` and
    I3D on a 16 x 224^2 crop of phase 44's Latte video against its 8-bit
    round trip; ``ddpm_step`` converging; phase 43's spectra through
    ``tensor_viz.energy_curves``.  No kernel of the port runs here.
52. ``examples/external_usp_example.py`` (U2 x R2, USP_SEQ tokens, kernel
    1's fp32 route) and ``examples/per_layer_schedule_example.py`` (PixArt
    at SP_CUT blocks, ring EXAMPLE_RING, EXAMPLE_STEPS steps, beside a
    lossless and an all-BINARY run) in one spawn of 4 gloo processes
    (``examples_phase``).
Phase 34 also runs its cut in fp32 (the bf16 weights, the same request):
ring 2 lossless, unfused and fused, within F32_RING_LOSSLESS_REL_MAX of
the fp32 one process; BINARY within F32_RING_BINARY_REL_MAX of the same
BINARY ring with kernel 1 swapped for its plain twin (the emulation takes
no joint text rows) and 0 < err < 0.05 from lossless; EF deviation 0.

Every PixArt and FLUX run on a cut model across gloo processes (phases
13-15, 19, 22, 24-27, 36), and the one-process run it is held against, takes
RANK_STEPS (10) steps, not their 20 and 28: the script's time limit.

Phases 4-15, 18-19, 21-27, 29, 31, 33-36 and 38-42 hold their latents against a lossless request and
their kernel launch counts against the counts the path implies (kernel 1's
wide-body launches among them, one per decoded image, and those of
kernels 2, 3, 5 and 6 on their vector plans, all of their launches); every
count is set to 0 just before each of phases 3-11, 13-15, 16's probes
(and the calibration), 18-19, 21-22, 24-27 and each request or run of 28-31,
33-36 and 38-42,
in every process, and read just after; kernels 1, 4, 7 and 8 count their fp32 launches apart.  A probe
counts a launch when it captures a CUDA graph, so phase 16 reports the
launches the device ran (the captured count times the replays).  The
``launches`` of the pipeline's kernels are those of phases 3-15, 18-19, 21-31, 33-36 and 38-42: what
kernel 1 ran inside the probes is reported beside them, under phase 16's
``launches_of_pipeline_kernels``.  The s/image of phases 13-15 is that of
processes sharing one card, not a ring speed (so are phase 19's).
PixArt's models leave the card before phase 17.
Then one JSON line with each kernel's launches on the main path, error and
times, and a last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.  It imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

# flash vs twin on bf16 outputs: the output is rounded to bf16 (half an ulp
# is 2^-9 relative) and the kernel rounds running, unnormalised
# probabilities to bf16 where the twin rounds normalised ones, so outputs of
# magnitude ~1 may differ by a few bf16 ulps
FLASH_OUT_ATOL = 2e-2
# both sides take the LSE in fp32 from fp32 scores of the same bf16 inputs;
# only the summation order and exp2/log2 against exp/log differ
FLASH_LSE_ATOL = 1e-3
# kernels 1, 7 and 8 vs their twins, relative Frobenius error of out: their
# outputs are averages over 1024-16384 keys, RMS 0.01-0.05, so FLASH_OUT_ATOL
# alone would pass a P.V wrong in one head-dim slice or off by 5-10% (the
# VAE's d=512 at B1 H1 S4096 has an RMS of about 0.026, FLUX's ring-2 hop
# over 2x2048 keys at d=128 about 0.026 too); bf16 rounding of P and of the
# output gives about 2e-3 (the stage probe's full mask on an H100,
# PROBE_REL_MAX's note), and tests/test_torch_wide_flash.py shows faults of
# one slice of the wide body above this limit at the VAE's shape
FLASH_OUT_REL_MAX = 1e-2
# quant new_base vs twin: the same fp32 arithmetic; the scale products of
# bf16 factors are exact in fp32 at K=1, and at K=2 the one rounding of their
# sum does not depend on the order
QUANT_NEW_BASE_RTOL = 1e-6
# sdpa's no-LSE route vs the math path at PixArt's cross-attention shape,
# relative Frobenius error on the live rows: both round p to bf16 (the route
# unnormalised, the math path normalised) and the output to bf16, about
# 3e-3 (the bf16 rounding kernel 1's out shows against the same twin,
# FLASH_OUT_REL_MAX's note)
CROSS_REL_MAX = 1e-2
# compressed vs lossless latents (relative Frobenius error): each codec must
# change the result (> 0) but stay close to it
COMPRESSED_REL_ERR_MAX = 0.05
# the ring across ranks vs one process computing the same function (the
# lossless pipeline, the ring-2 emulation, or the other route): only the
# order of the bf16 attention partials differs; the JAX package's dryrun
# puts this bound on its fused vs unfused ring (__graft_entry__.py:250)
RING_REL_MAX = 2e-2
# the ring across ranks vs one process that runs each CFG half's forward at
# B1, as a rank of cfg 2 does (phases 13-15).  That run alone is 0.016153
# from the B2 request (batch variance of bf16 GEMMs, amplified over 20
# steps), and the ring runs sit 0.0163-0.0173 from it (PERF.md §6):
# any change of bf16 order lands near 0.016-0.017, so the bound leaves 7%
# above the largest
HALVES_REL_MAX = 0.0185
# cfg 2 alone vs that run: the same computation per rank, bit for bit
CFG2_VS_HALVES_MAX = 0.0
# fp32 kernels vs their fp32 twins (phases 20-22): the kernels' products in
# 3xTF32 (about 2^-21 relative each) against the twins' fp32 einsums with
# TF32 off differ in summation order only: out's relative Frobenius error,
# and LSE's largest error on the rows with a key (a row with none is -inf
# in both)
F32_OUT_REL_MAX = 1e-5
F32_LSE_ATOL = 1e-4
# one fp32 CFG forward on the card vs the same forward on this machine's
# CPU through the plain versions (phase 21): the north star's bound for fp32
# model math (tests/io/test_backbone_parity.py)
F32_FORWARD_REL_MAX = 2e-4
# the fp32 ring across ranks vs one process computing the same function
# (phase 22), set from the readings on an H100 (PERF.md §2) with room over
# them, and far under bf16's 0.016-0.017 floor (HALVES_REL_MAX's note):
# the lossless rings read 1.37e-6-1.38e-6 from the one-process request;
# the BINARY rings 1.5e-5-2.0e-5 from the fp32 ring-2 emulation and
# 1.3e-5-1.5e-5 fused from unfused (a sign of the 1-bit code flips where a
# delta is near 0, so the last-bit differences of the two routes grow more)
F32_RING_LOSSLESS_REL_MAX = 1e-5
F32_RING_BINARY_REL_MAX = 1e-4
# DistriFusion's stale patch gather vs lossless latents (phase 25): the
# bound the JAX package's own test puts on it
# (tests/models/test_pixart.py::test_patch_parallel_pipeline)
PATCH_ASYNC_REL_MAX = 0.2
# the probes' matmuls_only divides by l = the sum of a row's raw scores,
# which can be near 0; it is compared on the rows with |l| >= 8 * sqrt(S),
# where one bf16 ulp of the output stays below FLASH_OUT_ATOL
PROBE_L_FLOOR = 8.0
# a stage mask vs its twin, relative Frobenius error: the outputs of most
# masks are averages over 1024 keys, 0.03-0.05 in size, so FLASH_OUT_ATOL
# alone would pass a mask wrong by tens of percent; bf16 rounding of p and
# of the output gives at most 2.3e-3 here on an H100 (full; the other
# masks 0 - 7.4e-4) and 2.6e-3 in the tests' CPU runs of the twins against
# the Pallas probe
PROBE_REL_MAX = 1e-2

# the card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# the dense TF32 rate of the tensor cores: the fp32 flash kernels run each
# fp32 product as three TF32 ones there (3xTF32), so beside the fp32 bound
# above they carry the bound of that design (``bound_3xtf32_ms``)
PEAK_TF32_FLOPS = 495e12
#: what ``ptxas -v`` said of each kernel of this run's build (phase 1)
PTXAS = {}

STEPS = 20
DEPTH = 28
# FLUX.1-dev (phases 17-19): 28 flow-match steps at guidance 3.5, 1024 x 1024,
# 512 T5 tokens; 24 heads of 128; a 128 x 128 latent, 4096 image tokens
FLUX_STEPS = 28
FLUX_GUIDANCE = 3.5
FLUX_SIZE = 1024
FLUX_TXT = 512
FLUX_HEADS, FLUX_HEAD_DIM = 24, 128
FLUX_IMG = (FLUX_SIZE // 16) ** 2
# phase 19's depth: 1 double + 2 single blocks, FLUX's 1 : 2 ratio, at full width
FLUX_CUT = (1, 2)
# image tokens of one rank of a ring of 2
FLUX_RING_LOCAL = FLUX_IMG // 2
#: phases 13-15's, 22's and 24-27's PixArt: its first 7 of 28 blocks at
#: full width, so that the whole script keeps within its 1200 s with phases
#: 37-42 (at full depth their gloo runs took ~200 s of 881 s on an H100)
SP_CUT = 7
#: the steps of the cut PixArt and FLUX runs across gloo processes and of
#: the one-process runs they are held against (phases 13-15, 19, 22, 24-27 and
#: 36; not 20 and 28): gloo sends the ring shifts, gathers and
#: stage hand-offs through host memory, about half of the script's time at
#: the full step counts on an H100
RANK_STEPS = 10
WINDOW = 64
RING = 8
WARMUP = 4
# rows and channels of one ring chunk's K or V: CFG batch 2 x 1024 / 8 tokens, 16 x 72
CHUNK = (2 * 1024 // RING, 1152)
# compress (or decompress) calls of one image per compressed layer: 8 chunks, K and V
CALLS_PER_LAYER = RING * 2 * (STEPS - WARMUP)
# phase 12's compressed-ring cases: (ring, batch, tokens per rank, codec,
# scale rank, int8 bases); ring 2 at the path's shape, ring 8 at S/8
_CODECS = (("binary", -1), ("binary", 2), ("int2", -1), ("lowrank", 4))
CRING_CASES = ([(2, 2, 512, c, r, False) for c, r in _CODECS]
               + [(2, 1, 512, c, r, True) for c, r in _CODECS if r != 2]
               + [(RING, 2, 1024 // RING, c, r, False) for c, r in _CODECS])


def _time_ms(fn, iters, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: {(wrapper, its count of the launches of one route): the route's key in a
#: phase's launch counts, beside every wrapper's own}: kernel 1's on the wide
#: body (the VAE's d=512), kernels 1, 7 and 8's on the wgmma body (bf16 at d
#: <= 128), and kernels 2, 3, 5 and 6 on their vector plans
#: (``ops/quant.py::quant_plan``)
#: {kernel: the key of its launches on fp32 q/k/v}: kernels 1, 4, 7 and 8,
#: and 8's EF pass writing fp32 reconstructions
F32 = {name: f"{name} (fp32)" for name in ("flash_attn_with_lse", "flash_attn_window_with_lse",
                                           "ring_flash_attn_with_lse", "compact_ring_flash", "ef_update_slot")}
F32_WIDE = "flash_attn_with_lse (fp32, wide body)"
#: {kernel: the key of its launches on the wgmma body}
WG = {name: f"{name} (wgmma body)" for name in ("flash_attn_with_lse", "ring_flash_attn_with_lse",
                                                "compact_ring_flash")}
ROUTES = {("flash_attn_with_lse", "wide_launches"): "flash_attn_with_lse (wide body)",
          **{(name, "wgmma_launches"): key for name, key in WG.items()},
          **{(f"{codec}_{side}_fastpath", "vec_launches"): f"{codec}_{side}_fastpath (vector plan)"
             for codec in ("binary", "int2") for side in ("quant", "dequant")},
          **{(name, "f32_launches"): key for name, key in F32.items()},
          ("flash_attn_with_lse", "f32_wide_launches"): F32_WIDE}
WIDE = ROUTES["flash_attn_with_lse", "wide_launches"]
#: {kernel: the key of its launches on the vector plan}
VEC = {name: key for (name, attr), key in ROUTES.items() if attr == "vec_launches"}


def _counter(name):
    """The port's counter ``name`` (``utils/prof.py``)."""
    from compactfusion_tpu_torch.utils.prof import Profiler

    return Profiler.counter(name)


def _reset_counters():
    """Zero the port's counters (``utils/prof.py``)."""
    from compactfusion_tpu_torch.utils.prof import Profiler

    Profiler.reset()


def _counts(kernels):
    """{wrapper name: its launches} of the kernels, and under the keys of
    :data:`ROUTES` the launches of those routes."""
    counts = {fn.__name__: _counter(f"{fn.__name__}.launches") for fn in kernels}
    for (name, attr), key in ROUTES.items():
        counts[key] = _counter(f"{name}.{attr}")
    return counts


def _ring_routes(totals, name):
    """The launches of kernel 7 or 8's flash partial by body: the wgmma body
    (bf16 at d <= 128) and the others (fp32, ring-8 hops, d > 128)."""
    return {"wgmma body (bf16, d <= 128), csrc/flash_wgmma.cu": totals[WG[name]],
            "register or wide body, csrc/ring_flash.cu": totals[name] - totals[WG[name]]}


def _with_routes(expect):
    """``expect`` ({kernel: count}) with the routes' counts the path
    implies: one wide-body launch (one decoded image), and every launch of
    both quants and both dequants on the vector plan (the engine's chunks
    and the ring's received views start 16-byte aligned, and C/8 = 144 and
    C/4 = 288 are multiples of 4)."""
    return {WIDE: 1, **{key: expect.get(name, 0) for name, key in VEC.items()}, **expect}


def _all_f32(expect):
    """``expect`` ({kernel or route: count}) of a path that runs in fp32
    throughout: every launch of kernels 1, 4, 7 and 8 (and of 1 on the wide
    body) an fp32 one."""
    return {**expect, **{key: expect[name] for name, key in F32.items() if name in expect},
            F32_WIDE: expect.get(WIDE, 0)}


def _nbytes(*tensors):
    """Bytes of the tensors' elements (a strided view counts what it shows)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _tc_bound(nbytes, ops, dtype):
    """For fp32 operands, {"bound_3xtf32_ms": the bound of the 3xTF32 design:
    the larger of bytes over the memory rate and three TF32 operations for
    each fp32 one over the tensor cores' TF32 rate}; else {}."""
    import torch

    if dtype != torch.float32:
        return {}
    return {"bound_3xtf32_ms": max(nbytes / PEAK_BYTES_PER_S, 3 * ops / PEAK_TF32_FLOPS) * 1e3}


def _tc_text(row):
    """The 3xTF32 bound of an fp32 row for a printed line, or ""."""
    return f", 3xTF32 bound {row['bound_3xtf32_ms']:.4f} ms" if "bound_3xtf32_ms" in row else ""


def _library(q, k, v, mask=None):
    """One ``scaled_dot_product_attention`` call on the (B, H, S, D) views of
    the same inputs (the yardstick; the port never calls it), and the
    backend PyTorch picks for it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, attn_mask=mask)).name
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)), backend


#: the device time of one replay of graph_ms's longer graph: 120 calls of a
#: kernel up to 0.42 ms, fewer of a longer one (at least 12), where the
#: dispatch cost the graphs take out is a smaller share (120 calls of
#: CogVideoX's 26 ms kernel took 15 s of replays for one number)
GRAPH_REPLAY_MS = 50.0


def graph_ms(timing, calls):
    """ms per call without dispatch cost: CUDA graphs of n and 6n calls
    (``timing.per_call_ms``; n = 20, or fewer for a call longer than
    GRAPH_REPLAY_MS / 120, at least 2), each call on the next of ``calls``
    (one per input set, as many as fill 4x the L2), so each reads its
    inputs from DRAM."""
    fn = timing.rotate(calls)
    n_hi = min(120, max(12, int(GRAPH_REPLAY_MS / _time_ms(fn, 1, 1))))
    return timing.per_call_ms(fn, n_hi // 6, n_hi)[0]


def _qkv_views(gen, dev, b, s, h=16, d=72, dtype=None):
    """q/k/v as a block's qkv linear gives them: (B, S, H, D) column slices
    of one qkv tensor, bf16 unless ``dtype`` says otherwise (PixArt's 16
    heads of 72 by default)."""
    import torch

    dim = h * d
    qkv = torch.randn((b, s, 3 * dim), generator=gen, device=dev).to(dtype or torch.bfloat16)
    return tuple(t.view(b, s, h, d) for t in qkv.split(dim, dim=-1))


def _limits(dtype):
    """(out max-abs, out relative Frobenius, LSE) limits of kernels 1, 4, 7
    and 8 against their twins on ``dtype`` q/k/v (None: no limit)."""
    import torch

    if dtype == torch.float32:
        return None, F32_OUT_REL_MAX, F32_LSE_ATOL
    return FLASH_OUT_ATOL, FLASH_OUT_REL_MAX, FLASH_LSE_ATOL


def _agree(out, ref_out, lse, ref_lse):
    """(out's largest error, its relative Frobenius error, LSE's largest
    error on the rows with a key, whether it is within :func:`_limits` and
    the rows with no key (LSE -inf) are the twin's)"""
    import torch

    err_out = (out.float() - ref_out.float()).abs().max().item()
    rel_out = rel_fro(out, ref_out)
    dead = torch.isneginf(ref_lse)
    live_err = (lse - ref_lse)[~dead]
    err_lse = live_err.abs().max().item() if live_err.numel() else 0.0
    atol, rtol, ltol = _limits(out.dtype)
    ok = ((atol is None or err_out <= atol) and rel_out <= rtol and err_lse <= ltol
          and torch.equal(torch.isneginf(lse), dead))
    return err_out, rel_out, err_lse, ok


def _tol_text(dtype):
    atol, rtol, ltol = _limits(dtype)
    return ("" if atol is None else f"abs tol {atol}, ") + f"rel tol {rtol}, lse tol {ltol}"


def _peak(dtype):
    """The card's peak rate for operations on ``dtype`` operands."""
    import torch

    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def _ptxas(flash, kind, plan, dtype):
    """What ptxas said of the kernel instantiation a launch of ``kind``
    (flash, window, ring) at ``plan`` of ``flash``'s tree runs (the wide
    body's by one CTA's padded head dim; kernel 1's split over a cluster
    apart), or None."""
    import torch

    body, dp, warps = plan
    if body == "flash_wide_tile":
        parts = flash.wide_parts(dp) if hasattr(flash, "wide_parts") else 1
        dp //= parts
        if kind == "flash" and parts > 1:
            kind = "split"
    name = {("flash", "flash_reg_tile"): "flash_fwd_reg", ("flash", "flash_wide_tile"): "flash_fwd_wide",
            ("flash", "flash_wgmma_tile"): "flash_fwd_wgmma", ("ring", "flash_wgmma_tile"): "ring_flash_hop_wgmma",
            ("split", "flash_wide_tile"): "flash_fwd_wide_split", ("window", "flash_reg_tile"): "flash_window_reg",
            ("window", "flash_wide_tile"): "flash_window_wide", ("ring", "flash_reg_tile"): "ring_flash_hop_reg",
            ("ring", "flash_wide_tile"): "ring_flash_hop_wide"}.get((kind, body))
    return name and PTXAS.get(f"{name}{'_f32' if dtype == torch.float32 else ''}_kernel<{dp}, {warps}>")


def flash_cases(gen, dev):
    """Kernel 1 at the path's three shapes: (name, a maker of one input set
    (q, k, v), eager iterations)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def chunk():
        q, k, v = _qkv_views(gen, dev, 2, 1024)
        return q[:, :128], k.contiguous(), v.contiguous()

    return [
        ("self-attn B2 H16 S1024 d72", lambda: _qkv_views(gen, dev, 2, 1024), 20),
        ("ring-8 query chunk B2 H16 Sq128 Sk1024 d72", chunk, 20),
        ("VAE mid-attn B1 H1 S4096 d512", lambda: tuple(rnd(1, 4096, 1, 512) for _ in range(3)), 5),
    ]


def wgmma_edge_cases(gen, dev):
    """Kernel 1 on the wgmma body at edge inputs: PixArt's self-attention
    with a batch of no key (``kv_lens`` (1000, 0): rows of 0 and LSE -inf),
    and 64-row tiles over a ragged Sq and Sk (1,000 queries against 777
    keys, neither a multiple of a tile) at d 88 (DP 96), K and V column
    slices of one kv tensor."""
    import torch

    def with_lens():
        return (*_qkv_views(gen, dev, 2, 1024), torch.tensor([1000, 0], device=dev, dtype=torch.int32))

    def ragged():
        q = torch.randn((2, 1000, 8, 88), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((2, 777, 2 * 8 * 88), generator=gen, device=dev).to(torch.bfloat16)
        return (q, *(t.view(2, 777, 8, 88) for t in kv.split(8 * 88, dim=-1)))

    return [("kv_lens (1000, 0) B2 H16 S1024 d72", with_lens, 20),
            ("ragged B2 H8 Sq1000 Sk777 d88 (K/V column slices)", ragged, 20)]


def ring_edge_cases(gen, dev):
    """Kernel 7 on the wgmma body with Sq != Sk, both ragged: ring 3, B1
    H16, 700 queries against hops of 513 keys at d 72 (64-row tiles)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return [((3, 1, 513), lambda: (rnd(1, 700, 16, 72), [(rnd(1, 513, 16, 72), rnd(1, 513, 16, 72))
                                                          for _ in range(3)]))]


def _plan(flash, b, h, sq, d, elem, kernel=1):
    """``flash``'s plan of a launch of ``kernel`` (1, 4 or 7; kernel 8's
    flash partial asks as 7).  A checkout whose ``flash_plan`` does not name
    the kernel (older checkouts that ``tools/time_flash.py --root`` times)
    has one rule for all, and where it still tells kernels 4, 7 and 8 from
    kernel 1 by a ``wide`` argument they plan with ``wide=False``, as their
    wrappers there do."""
    import inspect

    params = inspect.signature(flash.flash_plan).parameters
    if "kernel" in params:
        return flash.flash_plan(b, h, sq, d, elem=elem, kernel=kernel)
    old = kernel != 1 and "wide" in params
    return flash.flash_plan(b, h, sq, d, elem=elem, **({"wide": False} if old else {}))


def _main_body(dtype):
    """The body kernels 1 and 7 (and 8's flash partial) must take at d <=
    128: the wgmma body on bf16, the register body on fp32."""
    import torch

    return "flash_wgmma_tile" if dtype == torch.bfloat16 else "flash_reg_tile"


def _ctas(flash, plan, b, h, sq):
    """CTAs of a launch at ``plan`` on ``flash``'s tree (one a query tile
    where the tree has no ``plan_ctas``)."""
    if hasattr(flash, "plan_ctas"):
        return flash.plan_ctas(plan, b, h, sq)
    return b * h * -(-sq // flash.plan_rows(plan))


def check_flash(flash, timing, dev, gen, cases=None, phase=2):
    """Flash kernel vs twin at ``cases`` (default: PixArt's three path
    shapes, :func:`flash_cases`); returns a report.  Each shape is timed
    eager on one input set (``ms``) and by CUDA graphs on inputs from DRAM
    (``graph_ms``).  A head dim up to 128 must take the register body, one
    in (128, 512] the wide body (phase 50 holds wider ones to it)."""
    import torch

    rows = []
    for name, make, iters, *sliced in cases or flash_cases(gen, dev):
        # a fourth element: the twin runs on (batch row, that many heads)
        # slices, or on (batch row, heads, query rows) slices for a pair
        twin = _sliced_twin(flash, *(sliced[0] if isinstance(sliced[0], tuple) else (sliced[0],))) \
            if sliced else flash.flash_attn_with_lse_ref
        qq, kk, vv, *lens = make()  # a fourth element: kv_lens
        kv = {"kv_lens": lens[0]} if lens else {}
        out, lse = flash.flash_attn_with_lse(qq, kk, vv, **kv)
        torch.cuda.synchronize()
        ref_out, ref_lse = twin(qq, kk, vv, **kv)
        err_out, rel_out, err_lse, ok = _agree(out, ref_out, lse, ref_lse)
        b, sq, h, d = qq.shape
        plan = _plan(flash, b, h, sq, d, qq.element_size())
        ms = _time_ms(lambda: flash.flash_attn_with_lse(qq, kk, vv, **kv), iters)
        # one eager call (a shape of a second or more): no graphs of 140 calls
        sets = [(qq, kk, vv, *lens)] + [make() for _ in range(timing.copies(_nbytes(qq, kk, vv, out, lse)) - 1)
                                        if iters > 1]
        g_ms = graph_ms(timing, [lambda t=t: flash.flash_attn_with_lse(*t[:3], **({"kv_lens": t[3]} if lens else {}))
                                 for t in sets]) if iters > 1 else None
        n_sets = len(sets)
        del sets
        del ref_out, ref_lse
        plain_ms = _time_ms(lambda: twin(qq, kk, vv, **kv), 1 if sliced else iters, 1 if sliced else 3)
        key_mask = (torch.arange(kk.shape[1], device=dev) < lens[0][:, None])[:, None, None, :] if lens else None
        lib, backend = _library(qq, kk, vv, key_mask)
        library_ms = _time_ms(lib, iters)
        # the products over the keys each batch has (kv_lens: the live ones)
        keys = int(lens[0].clamp(0, kk.shape[1]).sum()) if lens else b * kk.shape[1]
        work = (_nbytes(qq, kk, vv, out, lse), 4 * h * sq * keys * d)
        bound_ms, bound_by = _bound(*work, _peak(qq.dtype))
        rows.append({"shape": name, "max_abs_err_out": err_out, "rel_err_out": rel_out,
                     "max_abs_err_lse": err_lse, **({"twin_slice": sliced[0]} if sliced else {}),
                     "plan": list(plan), "ctas": _ctas(flash, plan, b, h, sq), "ms": ms,
                     **({"graph_ms": g_ms} if g_ms is not None else {}),
                     "plain_ms": plain_ms, "library_ms": library_ms, "library_backend": backend,
                     "bound_ms": bound_ms, "bound_by": bound_by, **_tc_bound(*work, qq.dtype),
                     "ptxas": _ptxas(flash, "flash", plan, qq.dtype)})
        print(f"[{phase}] flash {name}: out err {err_out:.3e}, rel {rel_out:.3e}, lse err {err_lse:.3e} "
              f"({_tol_text(qq.dtype)}{f'; twin on B1 H/rows {sliced[0]} slices' if sliced else ''}); plan {plan}, "
              f"{rows[-1]['ctas']} CTAs; kernel "
              f"{ms:.4f} ms eager, "
              + (f"{g_ms:.4f} ms by CUDA graphs on {n_sets} input sets; " if g_ms is not None else "")
              + f"twin {plain_ms:.4f} ms, SDPA ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}){_tc_text(rows[-1])}; ptxas {rows[-1]['ptxas']}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its twin at {name}")
        if 128 < d <= 512 and plan[0] != "flash_wide_tile":
            raise AssertionError(f"flash at {name}: plan {plan} is not the wide body")
        if d <= 128 and plan[0] != _main_body(qq.dtype):
            raise AssertionError(f"flash at {name}: plan {plan}, not the {_main_body(qq.dtype)}")
    return rows


def band_pairs(s, w):
    """(query, key) pairs with |i - j| <= w over S tokens."""
    return sum(min(s - 1, i + w) - max(0, i - w) + 1 for i in range(s))


def window_cases(gen, dev):
    """Kernel 4's phase-2 cases: PixArt's B2 self-attention on column slices
    of one qkv tensor at w = 64, 4, 0 and 1024, the CFG half (B1) and a
    ragged S=1000: (name, a maker of one input set (q, k, v), window)."""
    def qkv(b, s):
        return lambda: _qkv_views(gen, dev, b, s)

    def half():
        q, k, v = _qkv_views(gen, dev, 2, 1024)
        return q[:1], k[:1], v[:1]

    return ([(f"B2 H16 S1024 d72 w{w}", qkv(2, 1024), w) for w in (WINDOW, 4, 0, 1024)]
            + [(f"CFG half B1 H16 S1024 d72 w{WINDOW}", half, WINDOW),
               (f"ragged B2 H16 S1000 d72 w{WINDOW}", qkv(2, 1000), WINDOW)])


def check_window(flash, dev, gen, cases=None, timing=None, phase=2):
    """Banded flash kernel vs twin at ``cases`` (default: :func:`window_cases`);
    returns a report, with the ratio of the first case's time to the full
    kernel's at the same shape.  With ``timing``, each case is also timed by
    CUDA graphs on inputs from DRAM (``graph_ms``).  bf16 cases are held to
    the absolute limits alone; fp32 ones to :func:`_limits`' relative one."""
    import torch

    rows = []
    for name, make, w, *sliced in cases or window_cases(gen, dev):
        # a fourth element: the twin runs on (batch row, that many heads) slices
        twin = (_sliced_twin(flash, sliced[0], ref=flash.flash_attn_window_with_lse_ref) if sliced
                else flash.flash_attn_window_with_lse_ref)
        qq, kk, vv = make()
        out, lse = flash.flash_attn_window_with_lse(qq, kk, vv, w)
        torch.cuda.synchronize()
        ref_out, ref_lse = twin(qq, kk, vv, w)
        err_out, rel_out, err_lse, ok = _agree(out, ref_out, lse, ref_lse)
        if qq.dtype == torch.bfloat16:
            ok = err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL
        ms = _time_ms(lambda: flash.flash_attn_window_with_lse(qq, kk, vv, w), 20)
        plain_ms = _time_ms(lambda: twin(qq, kk, vv, w), 1 if sliced else 20, 1 if sliced else 3)
        b, s, h, d = qq.shape
        plan = _plan(flash, b, h, s, d, qq.element_size(), kernel=4)
        lib, backend = _library(qq, kk, vv, flash.window_mask(s, w, dev))
        library_ms = _time_ms(lib, 20)
        work = (_nbytes(qq, kk, vv, out, lse), 4 * b * h * d * band_pairs(s, w))
        bound_ms, bound_by = _bound(*work, _peak(qq.dtype))
        rows.append({"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                     "plan": list(plan), "ctas": _ctas(flash, plan, b, h, s),
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by,
                     **_tc_bound(*work, qq.dtype), "ptxas": _ptxas(flash, "window", plan, qq.dtype)})
        if timing is not None:
            sets = [(qq, kk, vv)] + [make() for _ in range(timing.copies(_nbytes(qq, kk, vv, out, lse)) - 1)]
            rows[-1]["graph_ms"] = graph_ms(timing, [lambda t=t: flash.flash_attn_window_with_lse(*t, w)
                                                     for t in sets])
            rows[-1]["rel_err_out"] = rel_out
            del sets
        graphs = f", {rows[-1]['graph_ms']:.4f} ms by CUDA graphs" if timing is not None else ""
        tols = (f"tol {FLASH_OUT_ATOL}), lse err {err_lse:.3e} (tol {FLASH_LSE_ATOL})"
                if qq.dtype == torch.bfloat16 else
                f"rel {rel_out:.3e}), lse err {err_lse:.3e} ({_tol_text(qq.dtype)})")
        print(f"[{phase}] window flash {name}: out err {err_out:.3e} ({tols}; plan {plan}, "
              f"{rows[-1]['ctas']} CTAs; kernel "
              f"{ms:.4f} ms{graphs}, twin {plain_ms:.4f} ms, SDPA with band mask ({backend}) {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}){_tc_text(rows[-1])}"
              + (f"; ptxas {rows[-1]['ptxas']}" if timing else ""))
        if not ok:
            raise AssertionError(f"window flash kernel disagrees with its twin at {name}")
        if d <= 128 and plan[0] != "flash_reg_tile":
            raise AssertionError(f"window flash at {name}: plan {plan} is not the register body")
    if cases is not None:
        return rows, None
    q, k, v = _qkv_views(gen, dev, 2, 1024)
    full_ms = _time_ms(lambda: flash.flash_attn_with_lse(q, k, v), 20)
    print(f"[2] window flash w{WINDOW} / full flash at B2 H16 S1024 d72: {rows[0]['ms']:.4f} / "
          f"{full_ms:.4f} ms = {rows[0]['ms'] / full_ms:.3f}")
    return rows, rows[0]["ms"] / full_ms


def quant_case(codecs, dev, gen, codec, rank, base_dtype, shape=CHUNK):
    """One input set of a quant pair at ``shape`` (default the ring-8
    PixArt chunk): x, base (N, C) in ``base_dtype`` and the bf16 scale
    factors u, v the engine gives it (``rank``: the scale model, -1 for the
    mean scale, which the engine's INT2 always takes)."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev).to(base_dtype)
    base = (torch.randn(shape, generator=gen, device=dev) * 0.9).to(base_dtype)
    delta = x.float() - base.float()
    u, v = codecs._scale_uv(delta, rank)
    return x, base, codecs._wire(u), codecs._wire(v)


def _plan_name(plan):
    return f"{'vector' if plan > 1 else 'scalar'} plan ({plan} packed bytes per thread)"


def check_across_plans(quant, codec, name, x, base, u, v, packed, new_base, x_hat, phase=2):
    """At a shape where both plans can run: every sender plan into every
    receiver plan rebuilds quant's new base bit for bit.  The scalar plans
    run through the wrappers' internal launches with plan 1 forced (quant's
    scalar kernel into both dequant plans; the dequant's scalar kernel on
    the bytes the wrapper's quant sent); then the misaligned views, where no
    16-byte access can start: quant on an x view and dequant on a base view
    4 bytes into their storage must take the scalar plan (and give the same
    bits), and the C entries must refuse the vector plan there.  Returns the
    pairings checked."""
    import torch

    per_byte = 8 if codec == "binary" else 4
    q, dq = getattr(quant, f"{codec}_quant_fastpath"), getattr(quant, f"{codec}_dequant_fastpath")
    q_entry, dq_entry = f"cf_{codec}_quant", f"cf_{codec}_dequant"
    packed_s, new_base_s = quant._quant_launch(q_entry, x, base, u, v, per_byte, 1)
    if not (torch.equal(packed_s, packed) and torch.equal(new_base_s, new_base)):
        raise AssertionError(f"{name}: quant's scalar plan differs from its vector plan")
    pairs = {"quant vector -> dequant scalar": (quant._dequant_launch(dq_entry, packed, base, u, v, per_byte, 1),
                                                new_base),
             "quant vector -> dequant vector": (x_hat, new_base),
             "quant scalar -> dequant vector": (dq(packed_s, base, u, v), new_base_s),
             "quant scalar -> dequant scalar": (
                 quant._dequant_launch(dq_entry, packed_s, base, u, v, per_byte, 1), new_base_s)}

    def off4(t):  # a copy of t that starts 4 bytes into its storage
        n, c = t.shape
        view = torch.empty(n * c + 4 // t.element_size(), dtype=t.dtype, device=t.device)
        view = view[4 // t.element_size():].view(n, c)
        return view.copy_(t)

    x_off, base_off = off4(x), off4(base)
    q_vec, dq_vec = f"{q.__name__}.vec_launches", f"{dq.__name__}.vec_launches"
    before = _counter(q_vec)
    packed_off, new_base_off = q(x_off, base, u, v)
    if quant.quant_plan(per_byte, base, v, x=x_off) != 1 or _counter(q_vec) != before:
        raise AssertionError(f"{name}: quant took the vector plan on an x view 4 bytes into its storage")
    before = _counter(dq_vec)
    pairs["quant vector -> dequant on a base view 4 bytes in"] = (dq(packed, base_off, u, v), new_base)
    if quant.quant_plan(per_byte, base_off, v, packed=packed) != 1 or _counter(dq_vec) != before:
        raise AssertionError(f"{name}: dequant took the vector plan on a base view 4 bytes into its storage")
    pairs["quant on an x view 4 bytes in -> dequant vector"] = (dq(packed_off, base, u, v), new_base_off)
    if not (torch.equal(packed_off, packed) and torch.equal(new_base_off, new_base)):
        raise AssertionError(f"{name}: quant on an x view 4 bytes into its storage gave other bits")
    for what, launch in (
            (q_entry, lambda: quant._quant_launch(q_entry, x_off, base, u, v, per_byte, quant.QUANT_VEC_BYTES)),
            (dq_entry, lambda: quant._dequant_launch(dq_entry, packed, base_off, u, v, per_byte,
                                                     quant.QUANT_VEC_BYTES))):
        try:
            launch()
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"{name}: {what} ran the vector plan on a misaligned view")
    torch.cuda.synchronize()
    for what, (got, want) in pairs.items():
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {what}: not bit-identical to quant's new base")
    print(f"[{phase}] {name}: across plans, bit for bit: {'; '.join(pairs)}; both C entries refuse the vector "
          f"plan on the misaligned views")
    return list(pairs)


def check_quant(quant, codecs, timing, dev, gen, codec, rank, base_dtype, shape=CHUNK, phase=2):
    """One quant/dequant kernel pair vs its twins at ``shape`` on
    :func:`quant_case`'s inputs; each kernel timed eager (200 calls on one
    input set) and by CUDA graphs on enough input sets to fill 4x the L2
    (``graph_ms``).  Where both take the vector plan, also
    :func:`check_across_plans`.  Returns a report, with the plans (packed
    bytes per thread: ``ops/quant.py::quant_plan``) of the quant and of the
    dequant."""
    import torch

    x, base, u, v = quant_case(codecs, dev, gen, codec, rank, base_dtype, shape)
    q, dq = getattr(quant, f"{codec}_quant_fastpath"), getattr(quant, f"{codec}_dequant_fastpath")
    q_ref, dq_ref = getattr(quant, f"{codec}_quant_fastpath_ref"), getattr(quant, f"{codec}_dequant_fastpath_ref")
    packed, new_base = q(x, base, u, v)
    x_hat = dq(packed, base, u, v)
    torch.cuda.synchronize()
    ref_packed, ref_base = q_ref(x, base, u, v)
    ref_hat = dq_ref(packed, base, u, v)
    n, c = x.shape
    kk = u.shape[1]
    per_byte = 8 if codec == "binary" else 4
    name = f"{codec} N{n} C{c} K{kk} {str(base_dtype).replace('torch.', '')}"
    if not torch.equal(packed, ref_packed):
        raise AssertionError(f"{name} quant kernel: packed bytes differ from the twin's")
    rel = _rel(new_base, ref_base)
    if rel > QUANT_NEW_BASE_RTOL:
        raise AssertionError(f"{name} quant kernel: new_base off the twin by {rel:.3e} relative")
    if not torch.equal(x_hat, new_base):
        raise AssertionError(f"{name}: dequant output is not bit-identical to quant's new_base")
    quant_plan = quant.quant_plan(per_byte, base, v, x=x)
    dequant_plan = quant.quant_plan(per_byte, base, v, packed=packed)
    across = (check_across_plans(quant, codec, name, x, base, u, v, packed, new_base, x_hat, phase)
              if quant_plan > 1 and dequant_plan > 1 else [])
    # fp32 elementwise work per value: delta, the rank-K scale, the level
    # decision and the base update (quant); the scale and the update (dequant)
    quant_bytes = _nbytes(x, base, u, v, packed, new_base)
    dequant_bytes = _nbytes(packed, base, u, v, x_hat)
    quant_bound = _bound(quant_bytes, (4 + 2 * kk) * n * c, PEAK_FP32_FLOPS)
    dequant_bound = _bound(dequant_bytes, (3 + 2 * kk) * n * c, PEAK_FP32_FLOPS)
    sets = [(x, base, u, v)] + [quant_case(codecs, dev, gen, codec, rank, base_dtype, shape)
                                for _ in range(timing.copies(quant_bytes) - 1)]
    quant_graph = graph_ms(timing, [lambda t=t: q(*t) for t in sets])
    sets = [(packed, base, u, v)] + [
        (torch.randint(0, 256, tuple(packed.shape), generator=gen, device=dev, dtype=torch.uint8), *t[1:])
        for t in sets[1:]]
    dequant_graph = graph_ms(timing, [lambda t=t: dq(*t) for t in sets])
    n_sets = len(sets)
    del sets
    row = {"shape": name, "new_base_rel_err": rel,
           "quant_bound_ms": quant_bound[0], "quant_bound_by": quant_bound[1],
           "dequant_bound_ms": dequant_bound[0], "dequant_bound_by": dequant_bound[1],
           "max_abs_err_quant": (new_base.float() - ref_base.float()).abs().max().item(),
           "max_abs_err_dequant": (x_hat.float() - ref_hat.float()).abs().max().item(),
           "quant_ms": _time_ms(lambda: q(x, base, u, v), 200), "quant_graph_ms": quant_graph,
           "quant_plain_ms": _time_ms(lambda: q_ref(x, base, u, v), 200),
           "dequant_ms": _time_ms(lambda: dq(packed, base, u, v), 200), "dequant_graph_ms": dequant_graph,
           "dequant_plain_ms": _time_ms(lambda: dq_ref(packed, base, u, v), 200),
           "quant_plan_bytes_per_thread": quant_plan, "dequant_plan_bytes_per_thread": dequant_plan,
           "across_plans": across}
    print(f"[{phase}] {name}: packed bytes equal, new_base rel err {rel:.3e} (tol {QUANT_NEW_BASE_RTOL}), "
          f"dequant == new_base bit for bit; quant on the {_plan_name(quant_plan)} {row['quant_ms']:.4f} ms eager, "
          f"{quant_graph:.5f} ms by CUDA graphs on {n_sets} input sets (twin {row['quant_plain_ms']:.4f}, "
          f"bound {quant_bound[0]:.5f}), dequant on the {_plan_name(dequant_plan)} {row['dequant_ms']:.4f} "
          f"ms eager, {dequant_graph:.5f} ms by graphs (twin {row['dequant_plain_ms']:.4f}, bound "
          f"{dequant_bound[0]:.5f})")
    return row


def launch_floor_ms(ops_probes, timing, dev):
    """ms per launch of a kernel that does nothing, by the CUDA graphs of
    ``graph_ms`` (no inputs): the floor under the quant kernels'
    ``graph_ms``."""
    return timing.per_call_ms(lambda: ops_probes.empty(dev), 20, 120)[0]


def rel_fro(a, b):
    """||a - b|| / ||b|| over all elements, in fp32."""
    import torch

    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def _rel(a, b):
    """Largest elementwise |a - b| / |b| (0 where both are 0)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def cross_inputs(gen, dev, b=2, sq=1024, sk=120):
    """PixArt's cross-attention operands: q (B, Sq, 16, 72) bf16 heads of
    the query projection, k and v column slices of the text's (B, Sk, 2 x
    1152) key-value projection."""
    import torch

    dim = 1152
    q = torch.randn((b, sq, dim), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((b, sk, 2 * dim), generator=gen, device=dev).to(torch.bfloat16)
    k, v = kv.split(dim, dim=-1)
    return q.view(b, sq, 16, 72), k.view(b, sk, 16, 72), v.view(b, sk, 16, 72)


def check_cross_attention(attention, timing, dev, gen):
    """``sdpa``'s no-LSE route (``ops/attention.py::_attn_nolse``, plain
    torch: no kernel of the port) at PixArt's cross-attention shape, with
    ``kv_lens`` (120, 120) and (120, 0): the call must take the route (bit
    for bit the direct call), agree with the math path (``_attn_math``) on
    the live rows to :data:`CROSS_REL_MAX` and give exactly 0 on the dead
    ones.  Timed eager and by CUDA graphs on inputs from DRAM against the
    math path and one ``scaled_dot_product_attention`` call with the key
    padding as a bool mask (the yardstick; the port never calls it).
    Returns a report."""
    import torch

    rows = []
    for lens in ((120, 120), (120, 0)):
        q, k, v = cross_inputs(gen, dev)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = attention.sdpa(q, k, v, kv_lens=kl)
        torch.cuda.synchronize()
        nolse = attention._attn_nolse(q, k, v, None, kl)
        ref = attention._attn_math(q, k, v, None, False, None, kl)[0]
        live, dead = kl > 0, kl == 0
        rel = rel_fro(out[live], ref[live])
        dead_max = out[dead].abs().max().item() if bool(dead.any()) else 0.0
        if not torch.equal(out, nolse):
            raise AssertionError(f"sdpa at kv_lens {lens} did not take the no-LSE route")
        if not (rel <= CROSS_REL_MAX and dead_max == 0.0 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"sdpa's no-LSE route at kv_lens {lens}: rel err {rel:.3e} on live rows, "
                                 f"{dead_max} on dead rows")
        b, sq, h, d = q.shape
        sk = k.shape[1]
        mask = (torch.arange(sk, device=dev) < kl[:, None])[:, None, None, :]
        nbytes = _nbytes(q, k, v, out, kl)
        sets = [(q, k, v)] + [cross_inputs(gen, dev) for _ in range(timing.copies(nbytes) - 1)]
        lib, backend = _library(q, k, v, mask)
        bound_ms, bound_by = _bound(nbytes, 4 * b * h * sq * sk * d, PEAK_BF16_FLOPS)
        rows.append({
            "shape": f"B{b} Sq{sq} H{h} Sk{sk} d{d} kv_lens {lens}", "rel_err_live": rel, "dead_max": dead_max,
            "ms": _time_ms(lambda: attention.sdpa(q, k, v, kv_lens=kl), 50),
            "graph_ms": graph_ms(timing, [lambda t=t: attention.sdpa(*t, kv_lens=kl) for t in sets]),
            "math_ms": _time_ms(lambda: attention._attn_math(q, k, v, None, False, None, kl), 50),
            "math_graph_ms": graph_ms(timing, [lambda t=t: attention._attn_math(*t, None, False, None, kl)
                                               for t in sets]),
            "library_ms": _time_ms(lib, 50), "library_backend": backend,
            "bound_ms": bound_ms, "bound_by": bound_by})
        del sets
    r = rows[0]
    print(f"[2] sdpa cross-attention route {r['shape']}: rel err vs the math path {r['rel_err_live']:.3e} on "
          f"live rows (tol {CROSS_REL_MAX}), kv_lens (120, 0) rel {rows[1]['rel_err_live']:.3e} and dead rows "
          f"0; route {r['graph_ms']:.4f} ms by CUDA graphs, {r['ms']:.4f} eager; math path "
          f"{r['math_graph_ms']:.4f} / {r['math_ms']:.4f}; SDPA with a key-padding mask ({r['library_backend']}) "
          f"{r['library_ms']:.4f} eager; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def ring_cases(gen, dev, dtype=None):
    """Kernel 7's phase-12 shapes: (ring, batch, tokens per rank) and a
    maker of one input set: rank 0's queries, and its own K/V slices (hop
    0) then the contiguous blocks the other ranks send, in the order they
    arrive; bf16 unless ``dtype`` says otherwise."""
    def make(ring, b, s_local):
        shards = [_qkv_views(gen, dev, b, s_local, dtype=dtype) for _ in range(ring)]
        return shards[0][0], [(shards[0][1], shards[0][2])] + [
            (shards[(-s) % ring][1].contiguous(), shards[(-s) % ring][2].contiguous())
            for s in range(1, ring)]

    return [((ring, b, s), lambda ring=ring, b=b, s=s: make(ring, b, s))
            for ring, b, s in ((2, 2, 512), (2, 1, 512), (RING, 2, 1024 // RING))]


def check_ring_flash(rf, flash, timing, dev, gen, cases=None, phase=12):
    """Kernel 7 (one launch per hop) vs its twin, rank 0's view of a ring,
    at ``cases`` (default PixArt's, :func:`ring_cases`), timed eager and by
    CUDA graphs on inputs from DRAM next to one SDPA call on the
    concatenated K/V.  Returns a report."""
    import torch

    rows = []
    for (ring, b, s_local), make in cases or ring_cases(gen, dev):
        q, blocks = make()
        _, sq, h, d = q.shape
        out, lse = rf.ring_flash_attn_with_lse(q, iter(blocks), ring)
        torch.cuda.synchronize()
        ref_out, ref_lse = rf.ring_flash_attn_with_lse_ref(q, iter(blocks), ring)
        err_out, rel_out, err_lse, ok = _agree(out, ref_out, lse, ref_lse)
        name = f"ring {ring} B{b} H{h} Sq{sq} Sk{ring}x{s_local} d{d}"
        plan = _plan(flash, b, h, sq, d, q.element_size(), kernel=7)
        ms = _time_ms(lambda: rf.ring_flash_attn_with_lse(q, iter(blocks), ring), 20)
        k_all = torch.cat([k for k, _ in blocks], dim=1)
        v_all = torch.cat([v for _, v in blocks], dim=1)
        nbytes = _nbytes(q, k_all, v_all, out, lse)
        sets = [(q, blocks)] + [make() for _ in range(timing.copies(nbytes) - 1)]
        g_ms = graph_ms(timing, [lambda t=t: rf.ring_flash_attn_with_lse(t[0], iter(t[1]), ring)
                                 for t in sets])
        n_sets = len(sets)
        del sets
        plain_ms = _time_ms(lambda: rf.ring_flash_attn_with_lse_ref(q, iter(blocks), ring), 20)
        lib, backend = _library(q, k_all, v_all)
        library_ms = _time_ms(lib, 20)
        work = (nbytes, 4 * b * h * sq * k_all.shape[1] * d)
        bound_ms, bound_by = _bound(*work, _peak(q.dtype))
        rows.append({"shape": name, "max_abs_err_out": err_out, "rel_err_out": rel_out,
                     "max_abs_err_lse": err_lse, "plan": list(plan), "ctas": _ctas(flash, plan, b, h, sq),
                     "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library_backend": backend, "bound_ms": bound_ms,
                     "bound_by": bound_by, **_tc_bound(*work, q.dtype), "ptxas": _ptxas(flash, "ring", plan, q.dtype)})
        print(f"[{phase}] ring flash {name}: out err {err_out:.3e}, rel {rel_out:.3e}, lse err {err_lse:.3e} "
              f"({_tol_text(q.dtype)}); plan {plan}, {rows[-1]['ctas']} CTAs per hop; "
              f"kernel {ms:.4f} ms eager ({ring} launches), {g_ms:.4f} ms by CUDA graphs on {n_sets} "
              f"input sets; twin {plain_ms:.4f} ms, SDPA on the gathered K/V ({backend}) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}){_tc_text(rows[-1])}; "
              f"ptxas {rows[-1]['ptxas']}")
        if not ok:
            raise AssertionError(f"ring flash kernel disagrees with its twin at {name}")
        # the register body's 32-row tiles must fill the card at ring 8; the
        # wgmma body's 64-row tiles (64 CTAs) measured faster there than
        # the register body's 128 (ops/flash.py::flash_plan)
        if ring == RING and plan[0] == "flash_reg_tile" and rows[-1]["ctas"] < 128:
            raise AssertionError(f"ring flash at ring {RING}: {rows[-1]['ctas']} CTAs per hop, fewer than 128")
        if d <= 128 and plan[0] != _main_body(q.dtype):
            raise AssertionError(f"ring flash at {name}: plan {plan}, not the {_main_body(q.dtype)}")
    return rows


def _stack(gen, dev, ring, n, c, quantized):
    """A random EF stack (R, N, C): fp32, or int8-quantized slots."""
    import torch

    from compactfusion_tpu_torch.compact import codecs

    slots = [torch.randn((n, c), generator=gen, device=dev) * 0.9 for _ in range(ring)]
    if not quantized:
        return torch.stack(slots)
    enc = [codecs.encode_int8(x) for x in slots]
    return codecs.Int8Payload(*(torch.stack(parts) for parts in zip(*enc)))


def _clone(base):
    from compactfusion_tpu_torch.compact import codecs

    if isinstance(base, codecs.Int8Payload):
        return codecs.Int8Payload(*(t.clone() for t in base))
    return base.clone()


def _decoded(base):
    from compactfusion_tpu_torch.compact import codecs

    if isinstance(base, codecs.Int8Payload):
        return base.q.float() * base.scale.float() + base.minv.float()
    return base


def _same(a, b):
    import torch

    from compactfusion_tpu_torch.compact import codecs

    if isinstance(a, codecs.Int8Payload):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def cring_inputs(rf, gen, dev, ring, b, s_local, codec, rank, quantized, h=16, d=72, q_rows=None,
                 dtype=None):
    """One case of kernel 8: every virtual rank's (q, k, v) shard, the two
    EF stacks every rank starts from, and every rank's fused payload made
    from its own K/V and EF slot.  PixArt's 16 heads of 72 by default;
    ``q_rows``: q has that many rows (FLUX's text rows joined in front of the
    image's), else s_local, as a column slice beside k and v; bf16 unless
    ``dtype`` says otherwise."""
    import torch

    n, c = b * s_local, h * d
    shards = [_qkv_views(gen, dev, b, s_local, h, d, dtype) for _ in range(ring)]
    if q_rows is not None:
        shards = [(torch.randn((b, q_rows, h, d), generator=gen, device=dev).to(dtype or torch.bfloat16), k, v)
                  for _, k, v in shards]
    kb0, vb0 = _stack(gen, dev, ring, n, c, quantized), _stack(gen, dev, ring, n, c, quantized)
    payloads = [rf.fused_ring_payload(shards[r][1], shards[r][2], rf.decode_slot(kb0, r),
                                      rf.decode_slot(vb0, r), codec, rank) for r in range(ring)]
    return shards, kb0, vb0, payloads


def arriving(payloads, r):
    """The payloads rank r of the ring works on, hop by hop (its own first)."""
    ring = len(payloads)
    return iter([payloads[(r - s) % ring] for s in range(ring)])


def cring_name(ring, b, s_local, codec, rank, quantized, h=16, d=72, q_rows=None, dtype=None):
    import torch

    kname = {"binary": f"binary K{max(rank, 1)}", "int2": "int2", "lowrank": f"low-rank r{rank}"}[codec]
    sq = "" if q_rows is None else f" Sq{q_rows}"
    act = " fp32 q/k/v" if dtype == torch.float32 else ""
    return f"ring {ring} B{b} H{h}{sq} S{s_local} d{d}{act} {kname} {'int8' if quantized else 'fp32'} bases"


def check_compact_ring(rf, flash, timing, dev, gen, ring, b, s_local, codec, rank, quantized, h=16, d=72,
                       q_rows=None, phase=12, dtype=None):
    """Kernel 8 vs its twin: every virtual rank of a ring of ``ring`` makes
    its fused payload from its own K/V and EF slot, and each runs the kernel
    on its own copy of one stack with the payloads in the order they would
    arrive; rank 0 also runs the twin.  Checks out (max-abs and relative),
    LSE and rank 0's new stack against the twin, every rank's stack against
    every other's (bit for bit), and that the flash partial runs on at least
    128 CTAs; then its
    EF pass alone (``ef_update_slot`` of rank 0's own payload) against its
    twin: new bases and the reconstruction.  Rank 0's call and the EF
    pass are timed eager and by CUDA graphs on cloned stacks (each launch
    writes its stacks), enough of them in turn that each call reads from
    DRAM.  ``h``, ``d``, ``q_rows``, ``dtype``: as :func:`cring_inputs`; on
    fp32 q/k/v the stacks and the fp32 reconstructions must equal the twin's
    bit for bit.  Returns a report."""
    import torch

    n, c = b * s_local, h * d
    sq = s_local if q_rows is None else q_rows
    act = dtype or torch.bfloat16
    f32 = act == torch.float32
    shards, kb0, vb0, payloads = cring_inputs(rf, gen, dev, ring, b, s_local, codec, rank, quantized, h, d,
                                              q_rows, dtype)

    def kernel(r, kb, vb):
        return rf.compact_ring_flash(*shards[r], kb, vb, arriving(payloads, r), codec=codec, my=r,
                                     ring_size=ring)

    stacks = [(_clone(kb0), _clone(vb0)) for _ in range(ring)]
    out, lse = [kernel(r, *stacks[r]) for r in range(ring)][0]
    torch.cuda.synchronize()
    kr, vr = _clone(kb0), _clone(vb0)
    ref_out, ref_lse = rf.compact_ring_flash_ref(*shards[0], kr, vr, arriving(payloads, 0), codec=codec,
                                                 my=0, ring_size=ring)
    err_out, rel_out, err_lse, ok = _agree(out, ref_out, lse, ref_lse)
    base_rel = max(_rel(_decoded(stacks[0][0]), _decoded(kr)), _rel(_decoded(stacks[0][1]), _decoded(vr)))
    consistent = all(_same(stacks[r][i], stacks[0][i]) for r in range(ring) for i in range(2))
    name = cring_name(ring, b, s_local, codec, rank, quantized, h, d, q_rows, dtype)
    plan = _plan(flash, b, h, sq, d, shards[0][0].element_size(), kernel=7)
    ctas = _ctas(flash, plan, b, h, sq)
    ok = ok and base_rel <= QUANT_NEW_BASE_RTOL and consistent
    if f32:  # the stacks bit for bit
        ok = ok and _same(stacks[0][0], kr) and _same(stacks[0][1], vr)
    if not ok:
        raise AssertionError(f"compact ring kernel disagrees with its twin at {name}: out {err_out} "
                             f"(rel {rel_out}), lse {err_lse}, bases {base_rel}, ranks bit-equal {consistent}")
    if plan[0] == "flash_reg_tile" and ctas < 128:  # as kernel 7's at ring 8
        raise AssertionError(f"compact ring at {name}: the flash partial has {ctas} CTAs, fewer than 128")
    if d <= 128 and plan[0] != _main_body(act):
        raise AssertionError(f"compact ring at {name}: plan {plan}, not the {_main_body(act)}")

    # the EF pass alone, on rank 0's own payload (slot 0), after hop 0 (rec kept)
    shape = (b, s_local, h, d)
    ek, ev = _clone(kb0), _clone(vb0)
    rec = tuple(torch.empty(shape, dtype=act, device=dev) for _ in range(2))
    rf.ef_update_slot(ek, ev, 0, codec, payloads[0], shape, rec=rec)
    torch.cuda.synchronize()
    tk, tv = _clone(kb0), _clone(vb0)
    ref_rec = rf.ef_update_slot_ref(tk, tv, 0, codec, payloads[0])
    ef_rel = max(_rel(_decoded(ek), _decoded(tk)), _rel(_decoded(ev), _decoded(tv)))
    ef_err = max((_decoded(x).float() - _decoded(y).float()).abs().max().item() for x, y in ((ek, tk), (ev, tv)))
    rec_equal = all(torch.equal(r_, x.reshape(shape).to(act)) for r_, x in zip(rec, ref_rec))
    ef_same = _same(ek, tk) and _same(ev, tv)
    if not (ef_rel <= QUANT_NEW_BASE_RTOL and rec_equal and (ef_same or not f32)):
        raise AssertionError(f"EF pass at {name}: new bases {ef_rel} relative (bit-equal {ef_same}), "
                             f"{act} reconstruction equal to the twin's: {rec_equal}")

    q, k, v = shards[0]
    payload_bytes = sum(t.numel() * t.element_size() for p in payloads for t in p)
    # each hop reads and writes its source slot of both stacks
    base_bytes = 2 * 2 * ring * n * c * (1 if quantized else 4)
    work = (_nbytes(q, k, v, out, lse) + payload_bytes + base_bytes, 4 * b * h * sq * ring * s_local * d)
    bound_ms, bound_by = _bound(*work, _peak(act))
    # the EF pass: one slot of both stacks read and written, the payload
    # read, the reconstruction written (bf16 or fp32); (4 + 2K) fp32 operations per
    # element (the rank-K scale, the sign or level, the base update)
    ef_bytes = (2 * 2 * n * c * (1 if quantized else 4) + sum(_nbytes(t) for t in payloads[0])
                + _nbytes(*rec))
    ef_bound_ms, ef_bound_by = _bound(ef_bytes, 2 * (4 + 2 * payloads[0][-1].shape[0]) * n * c,
                                      PEAK_FP32_FLOPS)

    ms = _time_ms(lambda: kernel(0, *stacks[0]), 20)
    plain_ms = _time_ms(lambda: rf.compact_ring_flash_ref(*shards[0], kr, vr, arriving(payloads, 0),
                                                          codec=codec, my=0, ring_size=ring), 5)
    ef_ms = _time_ms(lambda: rf.ef_update_slot(ek, ev, 0, codec, payloads[0], shape, rec=rec), 20)
    ef_plain_ms = _time_ms(lambda: rf.ef_update_slot_ref(tk, tv, 0, codec, payloads[0]), 5)
    sets = [(_clone(kb0), _clone(vb0)) for _ in range(timing.copies(base_bytes // 2 + _nbytes(q, k, v)))]
    g_ms = graph_ms(timing, [lambda t=t: kernel(0, *t) for t in sets])
    n_sets = len(sets)
    sets = [(_clone(kb0), _clone(vb0), tuple(torch.empty_like(x) for x in rec))
            for _ in range(timing.copies(ef_bytes))]
    ef_g_ms = graph_ms(timing, [lambda t=t: rf.ef_update_slot(t[0], t[1], 0, codec, payloads[0], shape,
                                                              rec=t[2]) for t in sets])
    del sets
    ef_kernel = ("ef_codes_int8" if quantized else "ef_update_fp32") + ("_f32rec" if f32 else "") + "_kernel"
    row = {"shape": name, "max_abs_err_out": err_out, "rel_err_out": rel_out, "max_abs_err_lse": err_lse,
           "new_base_rel_err": base_rel, "ranks_bit_equal": consistent, "plan": list(plan),
           "ctas": ctas, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, **_tc_bound(*work, act), "ptxas": _ptxas(flash, "ring", plan, act),
           "ef": {"max_abs_err": ef_err, "new_base_rel_err": ef_rel, "rec_bit_equal": rec_equal,
                  "ms": ef_ms, "graph_ms": ef_g_ms, "plain_ms": ef_plain_ms, "bound_ms": ef_bound_ms,
                  "bound_by": ef_bound_by, "ptxas": PTXAS.get(ef_kernel)}}
    print(f"[{phase}] compact ring {name}: out err {err_out:.3e}, rel {rel_out:.3e}, lse err {err_lse:.3e} "
          f"({_tol_text(act)}), new bases rel err {base_rel:.3e} (tol "
          f"{QUANT_NEW_BASE_RTOL}{'; bit for bit' if f32 else ''}), {ring} ranks' stacks bit-equal: {consistent}; "
          f"flash plan {plan}, "
          f"{ctas} CTAs per hop; kernel {ms:.4f} ms eager ({ring} hops), {g_ms:.4f} ms by CUDA graphs "
          f"on {n_sets} stack copies; twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
          f"{_tc_text(row)}; ptxas {row['ptxas']}")
    print(f"[{phase}] EF pass {name}: new bases rel err {ef_rel:.3e} (tol {QUANT_NEW_BASE_RTOL}), bit-equal "
          f"{ef_same}, {act} reconstruction bit-equal to the twin's: {rec_equal}; {ef_ms:.4f} ms eager, "
          f"{ef_g_ms:.4f} ms by CUDA graphs per hop; twin {ef_plain_ms:.4f} ms, bound {ef_bound_ms:.5f} ms "
          f"({ef_bound_by}); ptxas {ef_kernel}: {row['ef']['ptxas']}")
    return row


def check_probes(ops_probes, flash, stage_probe, timing, dev, gen):
    """Phase 16's kernel checks: each stage mask of ``flash_parts`` (and
    ``dma_only``) against its twin on the (B, S, H, D) views of bf16
    (B, H, S, D) tensors at B2 H16 S1024 d72, by largest and relative
    error, ``full`` bit for bit against kernel 1 on the same views;
    ``plumb`` bit for bit against its twin on column slices of one qkv
    tensor, timed without dispatch cost on enough qkv tensors in turn that
    each call reads from DRAM.  Returns (flash_parts rows, plumb row)."""
    import math

    import torch

    q, k, v = stage_probe.make_inputs(gen)
    s = q.shape[1]
    kernel1, _ = flash.flash_attn_with_lse(q, k, v, plan=ops_probes.PLAN)  # the body the probe is built from
    rows = []
    for name, parts in stage_probe.VARIANTS.items():
        if parts is None:
            continue
        out = ops_probes.flash_parts(q, k, v, parts)
        torch.cuda.synchronize()
        ref, l = ops_probes.flash_parts_ref(q, k, v, parts, return_l=True)
        diff = (out.float() - ref.float()).abs()
        what = f"{name} B2 H16 S{s} d72"
        if name == "matmuls_only":
            live = l.abs().transpose(1, 2) >= PROBE_L_FLOOR * math.sqrt(s)  # (B, S, H)
            diff = diff[live]
            what += f" on the {live.float().mean().item():.0%} of rows with |l| >= {PROBE_L_FLOOR} sqrt(S)"
        err = diff.max().item()
        ref_f = ref.float()[live] if name == "matmuls_only" else ref.float()
        rel = (diff.norm() / ref_f.norm()).item()
        ok = err == 0.0 if name == "dma_only" else err <= FLASH_OUT_ATOL and rel <= PROBE_REL_MAX
        same_as_kernel1 = torch.equal(out, kernel1)
        if name == "full":
            ok = ok and same_as_kernel1
        plain_ms = _time_ms(lambda: ops_probes.flash_parts_ref(q, k, v, parts), 5)
        rows.append({"name": name, "max_abs_err": err, "rel_err": rel,
                     "twin_rms": (ref_f.norm() / ref_f.numel() ** 0.5).item(), "plain_ms": plain_ms})
        print(f"[16] flash_parts {what}: max abs err vs twin {err:.3e} (tol "
              f"{0.0 if name == 'dma_only' else FLASH_OUT_ATOL}), relative error {rel:.3e} (tol "
              f"{0.0 if name == 'dma_only' else PROBE_REL_MAX}), twin rms {rows[-1]['twin_rms']:.3e}"
              + (f", bit-equal to kernel 1: {same_as_kernel1}" if name == "full" else "")
              + f"; twin {plain_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"flash_parts {name} disagrees with its twin or kernel 1")
    def qkv_views():
        return _qkv_views(gen, dev, 2, 1024)

    pq, pk, pv = qkv_views()
    out = ops_probes.plumb(pq, pk, pv)
    torch.cuda.synchronize()
    if not torch.equal(out, ops_probes.plumb_ref(pq, pk, pv)):
        raise AssertionError("plumb differs from its twin")
    nbytes = _nbytes(pq, pk, pv, out)
    sets = [(pq, pk, pv)] + [qkv_views() for _ in range(timing.copies(nbytes) - 1)]
    ms, _ = timing.per_call_ms(timing.rotate([lambda t=t: ops_probes.plumb(*t) for t in sets]), 20, 120)
    plain_ms = _time_ms(lambda: ops_probes.plumb_ref(pq, pk, pv), 20)
    bound_ms, bound_by = _bound(nbytes, 0, PEAK_BF16_FLOPS)
    plumb_row = {"shape": "B2 S1024 H16 d72 column slices", "max_abs_err": 0.0, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[16] plumb B2 S1024 H16 d72 (column slices of one qkv tensor): bit-equal to its twin; "
          f"kernel {ms:.4f} ms per call (CUDA graphs of 20 and 120 launches on {len(sets)} qkv tensors "
          f"in turn), twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if ms < bound_ms:
        raise AssertionError(f"plumb took {ms:.4f} ms, below its DRAM bound {bound_ms:.4f} ms")
    return rows, plumb_row


def check_image(img, what, size=512):
    import torch

    if tuple(img.shape) != (1, size, size, 3):
        raise AssertionError(f"{what}: image shape {tuple(img.shape)}")
    f = img.float()
    if not bool(torch.isfinite(f).all()):
        raise AssertionError(f"{what}: non-finite pixels")
    lo, hi = f.min().item(), f.max().item()
    if lo < 0.0 or hi > 1.0 or hi <= lo:
        raise AssertionError(f"{what}: pixels span [{lo}, {hi}]")
    return lo, hi


def build_models(dev, dtype=None, depth=None):
    """Full-width PixArt-alpha 512 + SD-VAE with random weights from fixed
    seeds; the zero-init AdaLN tables are spiced so attention (and
    compression error) reaches the output at trained-model-like magnitude.
    ``dtype``: both configs in that dtype (phases 21-22: fp32; the VAE, as
    in the JAX package, follows its own config), else their bf16.
    ``depth``: the model's first ``depth`` blocks (phases 24-27)."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.pixart import init_pixart, pixart_alpha_512
    from compactfusion_tpu_torch.models.vae import init_vae_decoder, sd_vae

    mcfg, vcfg = pixart_alpha_512(), sd_vae()
    if dtype is not None:
        mcfg, vcfg = dataclasses.replace(mcfg, dtype=dtype), dataclasses.replace(vcfg, dtype=dtype)
    params = spice_pixart(init_pixart(torch.Generator(device=dev).manual_seed(0), mcfg))
    vae_params = init_vae_decoder(torch.Generator(device=dev).manual_seed(1), vcfg)
    if depth is not None:
        mcfg, params = dataclasses.replace(mcfg, depth=depth), _cut_blocks(params, depth)
    return mcfg, vcfg, params, vae_params


def spice_pixart(params):
    """``params`` with the zero-init AdaLN tables (every block's
    ``scale_shift_table`` and ``adaln_single``'s bias) drawn from N(0, 0.5^2)
    with a fixed seed, in place: zero gates hide the attention, and the
    compression error with it, under bf16 rounding."""
    import numpy as np
    import torch

    spice = np.random.default_rng(99)
    for tree, key in ((params["blocks"], "scale_shift_table"), (params["adaln_single"], "b")):
        tree[key] = torch.from_numpy(spice.standard_normal(tuple(tree[key].shape)) * 0.5).to(
            device=tree[key].device, dtype=tree[key].dtype)
    return params


def compressed_config(compress_type="binary", **kw):
    """The compressed-ring emulation: ring 8, residual 1 with error
    feedback, warmup 4, the fused quant kernels on; 1-bit by default."""
    from compactfusion_tpu_torch.config import CompactConfig, CompressType

    kw = {"comp_rank": -1, **kw}
    return CompactConfig(enabled=True, compress_type=CompressType(compress_type),
                         warmup_steps=WARMUP, residual=1, error_feedback=True,
                         fastpath=True, simulate_ring=RING, **kw)


def layer_plan_config():
    """Phase 7's per-layer plan on int8-quantized EF caches: WARMUP for the
    first 4 steps, then layer 0 IDENTITY, layers 1-13 INT2, layers 14-27
    BINARY with a rank-2 scale."""
    from compactfusion_tpu_torch.config import CompressType

    def plan(layer, step):
        if step < WARMUP:
            return CompressType.WARMUP
        if layer == 0:
            return CompressType.IDENTITY
        return CompressType.INT2 if layer <= 13 else CompressType.BINARY

    return compressed_config("binary", comp_rank=2, quantized_cache=True, compress_func=plan)


def wire_compression(codecs, plan):
    """Dense bf16 K/V bytes over payload bytes for one image's compressed
    layers: ``plan`` lists (method, comp_rank, layers); IDENTITY layers send
    K/V dense in bf16."""
    import torch

    from compactfusion_tpu_torch.config import CompressType

    dense = CHUNK[0] * CHUNK[1] * 2
    sent = total = 0
    for method, rank, layers in plan:
        nbytes = dense if method == "identity" else codecs.payload_nbytes(
            codecs.encode(torch.ones(CHUNK), CompressType(method), rank=rank))
        sent += nbytes * layers
        total += dense * layers
    return total / sent


def request(pipe, seed):
    """One image: random text (2, 1, 120, text_dim) with a full mask, and
    the noise, both from ``seed``; returns (latents, image, seconds from
    CUDA events)."""
    import torch

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    text = torch.randn((2, 1, 120, pipe.cfg.model.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lat = pipe(text, mask, generator=g, decode=False)
    img = pipe.decode(lat)
    end.record()
    torch.cuda.synchronize()
    return lat, img, start.elapsed_time(end) / 1e3


def compressed_phase(phase, what, pipe, kernels, lossless, expect):
    """One compressed request from request 1's seed, with every launch count
    set to 0 before it; checks the image, the launch counts against
    ``expect`` ({kernel name: count}, any other kernel 0 unless it is the
    flash kernel, which must run) and the latent error against lossless."""
    import torch

    _reset_counters()
    lat, img, sec = request(pipe, 1)
    counts = _counts(kernels)
    check_image(img, what)
    expect = _with_routes(expect)
    for name, count in counts.items():
        want = expect.get(name, 0)
        if name == "flash_attn_with_lse":
            if count < DEPTH * STEPS:
                raise AssertionError(f"{what}: flash launched {count} < {DEPTH * STEPS} times")
        elif name == WG["flash_attn_with_lse"]:  # every bf16 launch below the VAE's d=512
            if count != counts["flash_attn_with_lse"] - counts[WIDE]:
                raise AssertionError(f"{what}: {count} of kernel 1's launches on the wgmma body")
        elif count != want:
            raise AssertionError(f"{what}: {name} launched {count} times, expected {want}")
    rel = (torch.linalg.vector_norm(lat - lossless) / torch.linalg.vector_norm(lossless)).item()
    if not 0.0 < rel < COMPRESSED_REL_ERR_MAX:
        raise AssertionError(f"{what}: latent rel err vs lossless {rel} not in (0, {COMPRESSED_REL_ERR_MAX})")
    launched = ", ".join(f"{k} {v}" for k, v in counts.items())
    print(f"[{phase}] {what}: latent rel err vs lossless {rel:.6f} (bound {COMPRESSED_REL_ERR_MAX}), "
          f"{sec:.4f} s/image; launches: {launched}")
    return {"s_per_image": sec, "latent_rel_err": rel, "launches": counts, "image": img}


def mixed_plan():
    """Phase 9's fixed DiTFastAttn plan: steps 0-1 FULL, then the cycle
    WINDOW, SHARE, FULL_CFG, WINDOW_CFG, FULL over (step + layer), in which
    each FULL_CFG is followed by a WINDOW_CFG that reads its residual (else
    optimize_plan rewrites it)."""
    import numpy as np

    return np.array([[0 if i < 2 else (1, 2, 3, 4, 0)[(i + l) % 5] for l in range(DEPTH)]
                     for i in range(STEPS)], np.int32)


def calibrated_plan(params, mcfg, vcfg, dev, threshold=0.5):
    """Phase 10's DiTFastAttn calibration: ``calibrate_pixart`` on request
    1's text and noise (window 64); returns (plan, seconds)."""
    import torch

    from compactfusion_tpu_torch.cache.fast_attn import calibrate_pixart
    from compactfusion_tpu_torch.pipelines import base
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipelineConfig

    g = torch.Generator(device=dev).manual_seed(1)  # as in request(pipe, 1): text, then noise
    text = torch.randn((2, 1, 120, mcfg.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    cfg = PixArtPipelineConfig(model=mcfg, vae=vcfg, num_steps=STEPS, guidance_scale=4.5,
                               fast_attn_window=WINDOW)
    noise = base.prepare_latents(g, 1, cfg.tokens, mcfg.patch**2 * mcfg.in_channels,
                                 torch.float32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = calibrate_pixart(params, cfg, text, mask, threshold=threshold, latents=noise)
    return plan, time.perf_counter() - t0


def plan_launches(table):
    """(full, window) flash launches of one image under an optimized
    DiTFastAttn table: FULL, FULL_CFG and the two NO_RESIDUAL methods launch
    the full kernel once per (step, layer), FULL, FULL_CFG, WINDOW and
    WINDOW_CFG the window kernel once; the VAE adds one full launch."""
    import numpy as np

    return int(np.isin(table, (0, 3, 5, 6)).sum()) + 1, int(np.isin(table, (0, 1, 3, 4)).sum())


def accel_phase(phase, what, pipe, kernels, lossless, full, window, exact=False, f32=False):
    """One request of a single-device accelerator (DiTFastAttn or a cache)
    from request 1's seed, every launch count set to 0 before it: checks the
    image, the flash and window-kernel launches against ``full`` (or
    ``full(skipped steps)``) and ``window`` (the quant kernels 0), and the
    latents against lossless (equal within 1e-6 with ``exact`` or when a
    cache skipped no step, else different and finite).  ``f32``: the
    pipeline runs in fp32, every flash launch an fp32 one."""
    import torch

    _reset_counters()
    lat, img, sec = request(pipe, 1)
    counts = _counts(kernels)
    check_image(img, what)
    if callable(full):
        full = full(pipe.last_skips)
    want = {"flash_attn_with_lse": full, "flash_attn_window_with_lse": window, WIDE: 1}
    if f32:
        want = _all_f32(want)
    _check_counts(what, counts, want)
    rel = (torch.linalg.vector_norm(lat - lossless) / torch.linalg.vector_norm(lossless)).item()
    exact = exact or pipe.last_skips == 0  # a cache that skips nothing is the lossless path
    if not (rel <= 1e-6 if exact else 0.0 < rel < float("inf")):
        raise AssertionError(f"{what}: latent rel err vs lossless {rel}")
    print(f"[{phase}] {what}: latent rel err vs lossless {rel:.6e}, {sec:.4f} s/image, skipped "
          f"steps {pipe.last_skips}; launches: {', '.join(f'{k} {v}' for k, v in counts.items())}")
    return {"s_per_image": sec, "latent_rel_err": rel, "skips": pipe.last_skips, "launches": counts}


@contextlib.contextmanager
def cfg_halves_apart():
    """Within the block, a pipeline of this process runs each CFG half's
    text path and backbone forward alone, at B1, as a rank of cfg 2 runs its
    half: ``pipelines.pixart``'s ``precompute_text_kv`` and
    ``pixart_forward`` are swapped for ones that split the [cond; uncond]
    batch, call the real function on each half and join the results.  For
    lossless requests (no attention state, no cache)."""
    import torch

    from compactfusion_tpu_torch.pipelines import pixart as pp

    real_kv, real_fwd = pp.precompute_text_kv, pp.pixart_forward

    def text_kv(params, text):
        return torch.cat([real_kv(params, t) for t in text.chunk(2)], dim=1)

    def forward(params, x, t, text, cfg, *, text_mask, text_kv, attn_state, **kw):
        outs = [real_fwd(params, x_, t_, None, cfg, text_mask=m_, text_kv=kv_, attn_state=attn_state, **kw)[0]
                for x_, t_, m_, kv_ in zip(x.chunk(2), t.chunk(2), text_mask.chunk(2), text_kv.chunk(2, dim=1))]
        return torch.cat(outs), attn_state

    pp.precompute_text_kv, pp.pixart_forward = text_kv, forward
    try:
        yield
    finally:
        pp.precompute_text_kv, pp.pixart_forward = real_kv, real_fwd


@contextlib.contextmanager
def plain_attention():
    """Within the block, every kernel-1 call of ``sdpa`` runs its plain twin
    instead (on (batch row, :data:`COG_TWIN_HEADS` heads) slices): the same
    function in another bf16 order, which sizes the order floor."""
    from compactfusion_tpu_torch.ops import attention, flash

    real = attention.flash_attn_with_lse
    attention.flash_attn_with_lse = _sliced_twin(flash, COG_TWIN_HEADS)
    try:
        yield
    finally:
        attention.flash_attn_with_lse = real


@contextlib.contextmanager
def cog_halves_apart():
    """Within the block, a CogVideoX pipeline of this process runs each CFG
    half's forward alone, at B1, as a rank of cfg 2 runs its half (lossless
    requests: no attention state)."""
    import torch

    from compactfusion_tpu_torch.pipelines import cogvideox as pc

    real = pc.cogvideox_forward

    def forward(params, x, txt, t, cfg, *, attn_state, **kw):
        outs = [real(params, x_, txt_, t_, cfg, attn_state=attn_state, **kw)[0]
                for x_, txt_, t_ in zip(x.chunk(2), txt.chunk(2), t.chunk(2))]
        return torch.cat(outs), attn_state

    pc.cogvideox_forward = forward
    try:
        yield
    finally:
        pc.cogvideox_forward = real


def port_kernels():
    """Every kernel wrapper of the port (each counts its own launches)."""
    from compactfusion_tpu_torch.ops import flash, probes, quant, ring_flash

    return (flash.flash_attn_with_lse, quant.binary_quant_fastpath, quant.binary_dequant_fastpath,
            quant.int2_quant_fastpath, quant.int2_dequant_fastpath, flash.flash_attn_window_with_lse,
            ring_flash.ring_flash_attn_with_lse, ring_flash.compact_ring_flash,
            ring_flash.ef_update_slot, probes.flash_parts, probes.plumb)


def ring_compact(compress_type, **kw):
    """The compressed ring across ranks of phases 14-15 (and the compressed
    USP and patch gather of phases 24-26): residual 1 with error feedback
    unless ``kw`` says otherwise, warmup 4, the fused quant kernels on for
    the unfused route."""
    from compactfusion_tpu_torch.config import CompactConfig, CompressType

    kw = {"residual": 1, "error_feedback": True, **kw}
    return CompactConfig(enabled=True, compress_type=CompressType(compress_type),
                         warmup_steps=WARMUP, fastpath=True, **kw)


def ring_rank(rank, world, runs, family="pixart"):
    """One rank of phases 13-15, 19, 22 and 24-27 (``spawn_local`` on this
    GPU, gloo): the full-width models from the same seeds (``family``
    "flux": FLUX.1-dev at phase 19's cut depth; "pixart-fp32": PixArt and
    its VAE in fp32, as in phase 21; "pixart-cut", "pixart-fp32-cut":
    either cut to :data:`SP_CUT` blocks), then per run (name, ParallelConfig kwargs,
    CompactConfig kwargs or None, and optionally CacheAccelConfig kwargs)
    request 1 with every launch count set to 0 before it; returns per run
    the whole latents, the launch counts, the bytes this rank's ring shifts
    sent, its all-to-alls sent to the other ranks and its tree gathers
    gathered, the largest EF cache deviation across the ring (or the
    patch gather's ranks), the skipped steps (None without a cache) and
    s/image."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import ParallelConfig
    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    if family == "flux":
        models, make_request, size = build_flux(dev, *FLUX_CUT), flux_request, FLUX_SIZE
    else:
        dtype = torch.float32 if family.startswith("pixart-fp32") else None
        depth = SP_CUT if family.endswith("-cut") else None
        models, make_request, size = build_models(dev, dtype, depth), request, 512
    out = {}
    for name, par, compact, *cache in runs:
        parallel = ParallelConfig(**par)
        kw = {} if compact is None else {"compact": ring_compact(**compact)}
        if cache:
            kw["cache"] = CacheAccelConfig(**cache[0])
        pipe = (flux_pipeline if family == "flux" else pixart_pipeline)(*models, dev, parallel=parallel,
                                                                         mesh=make_mesh(parallel),
                                                                         steps=RANK_STEPS, **kw)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        lat, img, sec = make_request(pipe, 1)
        counts = _counts(kernels)
        check_image(img, f"{name} rank {rank}", size)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": counts,
                     "wire_bytes": _counter("ring_shift.nbytes"),
                     "all_to_all_bytes": _counter("Mesh.all_to_all.nbytes"),
                     "gather_bytes": _counter("Mesh.all_gather_tree.nbytes"),
                     "consistency_dev": compact_ring.max_consistency_dev, "skips": pipe.last_skips,
                     "s_per_image": sec}
    return out


def pixart_pipeline(mcfg, vcfg, params, vae_params, dev, mesh=None, steps=STEPS, **kw):
    """The full-width PixArt pipeline of phases 3-15 (20 steps unless
    ``steps`` says otherwise, CFG 4.5)."""
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    return PixArtPipeline(params, vae_params, PixArtPipelineConfig(
        model=mcfg, vae=vcfg, num_steps=steps, guidance_scale=4.5, **kw), dev, mesh=mesh)


def _spiced(tree, rng, path=""):
    """``tree`` with every modulation bias (a path with "mod" ending in
    "/b", as ``tests/helpers.py::spice_params`` picks them) drawn from
    N(0, 0.5^2): FLUX's AdaLN-Zero biases start at 0, and a zero gate
    hides the attention (and the compression error) under bf16 rounding."""
    import torch

    if isinstance(tree, dict):
        return {k: _spiced(v, rng, f"{path}/{k}") for k, v in tree.items()}
    if "mod" in path and path.endswith("/b"):
        return torch.from_numpy(rng.standard_normal(tuple(tree.shape)) * 0.5).to(tree.device, tree.dtype)
    return tree


def build_flux(dev, double_layers=19, single_layers=38):
    """FLUX.1-dev at full width (dim 3072, 24 heads of 128) with ``double_layers``
    and ``single_layers`` blocks (default: the full 19 + 38) and its
    16-channel VAE, random weights from fixed seeds, modulation biases
    spiced (:func:`_spiced`)."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.flux import flux_dev, init_flux
    from compactfusion_tpu_torch.models.vae import flux_vae, init_vae_decoder

    mcfg = dataclasses.replace(flux_dev(), double_layers=double_layers, single_layers=single_layers)
    params = _spiced(init_flux(torch.Generator(device=dev).manual_seed(0), mcfg), np.random.default_rng(99))
    vcfg = flux_vae()
    return mcfg, vcfg, params, init_vae_decoder(torch.Generator(device=dev).manual_seed(1), vcfg)


def flux_pipeline(mcfg, vcfg, params, vae_params, dev, mesh=None, steps=FLUX_STEPS, **kw):
    """The FLUX.1-dev pipeline of phases 18-19: 28 steps unless ``steps``
    says otherwise, guidance 3.5, 1024 x 1024."""
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    cfg = FluxPipelineConfig(model=mcfg, vae=vcfg, num_steps=steps, guidance_scale=FLUX_GUIDANCE,
                             height=FLUX_SIZE, width=FLUX_SIZE, **kw)
    return FluxPipeline(params, vae_params, cfg, dev, mesh=mesh)


def flux_request(pipe, seed):
    """One FLUX image: T5 states (1, 512, 4096) and a pooled CLIP vector
    (1, 768), then the noise, all from ``seed``; returns (latents, image,
    seconds from CUDA events)."""
    import torch

    dev, m = pipe.device, pipe.cfg.model
    g = torch.Generator(device=dev).manual_seed(seed)
    txt = torch.randn((1, FLUX_TXT, m.text_dim), generator=g, device=dev)
    pooled = torch.randn((1, m.pooled_dim), generator=g, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lat = pipe(txt, pooled, generator=g, decode=False)
    img = pipe.decode(lat)
    end.record()
    torch.cuda.synchronize()
    return lat, img, start.elapsed_time(end) / 1e3


def flux_flash_cases(gen, dev):
    """Kernel 1 at FLUX's shapes: self-attention over the 512 text + 4096
    image tokens (column slices of one qkv tensor, as the single blocks
    give them), the two hops of the unfused ring 2 (hop 0 with the text as
    joint K/V in front, hop 1 on the received block), the fused ring's
    joint block, and the VAE's mid-block attention over 128 x 128 tokens
    (the wide body)."""
    import torch

    h, d, s_q = FLUX_HEADS, FLUX_HEAD_DIM, FLUX_TXT + FLUX_RING_LOCAL

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def qkv(sq, sk):
        return lambda: (rnd(1, sq, h, d), rnd(1, sk, h, d), rnd(1, sk, h, d))

    s_all = FLUX_TXT + FLUX_IMG
    return [
        (f"FLUX self-attn B1 H{h} S{s_all} d{d}", lambda: _qkv_views(gen, dev, 1, s_all, h, d), 10),
        (f"FLUX ring-2 hop 0 (text joint in front) B1 H{h} Sq{s_q} Sk{s_q} d{d}", qkv(s_q, s_q), 10),
        (f"FLUX ring-2 hop 1 B1 H{h} Sq{s_q} Sk{FLUX_RING_LOCAL} d{d}", qkv(s_q, FLUX_RING_LOCAL), 10),
        (f"FLUX fused ring-2 joint block B1 H{h} Sq{s_q} Sk{FLUX_TXT} d{d}", qkv(s_q, FLUX_TXT), 20),
        ("FLUX VAE mid-attn B1 H1 S16384 d512", lambda: tuple(rnd(1, 16384, 1, 512) for _ in range(3)), 3),
    ]


def flux_ring_cases(gen, dev, dtype=None):
    """Kernel 7 at FLUX's fused ring 2, rank 0's view: q (the text rows in
    front of the 2048 local image rows), its own K/V slices at hop 0, the
    other rank's contiguous block at hop 1; bf16 unless ``dtype`` says
    otherwise."""
    import torch

    h, d = FLUX_HEADS, FLUX_HEAD_DIM

    def make():
        q = torch.randn((1, FLUX_TXT + FLUX_RING_LOCAL, h, d), generator=gen, device=dev).to(dtype or torch.bfloat16)
        _, k0, v0 = _qkv_views(gen, dev, 1, FLUX_RING_LOCAL, h, d, dtype)
        _, k1, v1 = _qkv_views(gen, dev, 1, FLUX_RING_LOCAL, h, d, dtype)
        return q, [(k0, v0), (k1.contiguous(), v1.contiguous())]

    return [((2, 1, FLUX_RING_LOCAL), make)]


def check_flux_kernels(flash, quant, codecs, rf, timing, dev, gen):
    """Phase 17: kernels 1, 2, 3, 7 and 8 (and 8's EF pass) against their
    twins at FLUX's shapes; returns the rows by kernel."""
    import torch

    flash_rows = check_flash(flash, timing, dev, gen, flux_flash_cases(gen, dev), phase=17)
    self_attn = flash_rows[0]
    if (self_attn["plan"], self_attn["ctas"]) != (["flash_wgmma_tile", FLUX_HEAD_DIM, 8], 864):
        raise AssertionError(f"FLUX self-attention: plan {self_attn['plan']}, {self_attn['ctas']} CTAs; "
                             f"the wgmma body at DP 128, 8 consumer warps and 864 CTAs expected")
    shape = (FLUX_RING_LOCAL, FLUX_HEADS * FLUX_HEAD_DIM)
    quant_rows = [check_quant(quant, codecs, timing, dev, gen, "binary", -1, torch.float32, shape, phase=17)]
    if [quant_rows[0]["quant_plan_bytes_per_thread"], quant_rows[0]["dequant_plan_bytes_per_thread"]] != \
            [quant.QUANT_VEC_BYTES] * 2:
        raise AssertionError(f"binary quant/dequant at N{shape[0]} C{shape[1]}: not the vector plan")
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, flux_ring_cases(gen, dev), phase=17)
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 1, FLUX_RING_LOCAL, "binary", -1, False,
                                     FLUX_HEADS, FLUX_HEAD_DIM, FLUX_TXT + FLUX_RING_LOCAL, phase=17)]
    return {"flash": flash_rows, "quant": quant_rows, "ring": ring_rows, "cring": cring_rows}


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(t) for t in tree.values())
    if isinstance(tree, list):
        return sum(_numel(t) for t in tree)
    return tree.numel()


def _check_counts(what, counts, expect):
    """Every kernel's (and route's) launches equal ``expect``, else 0; a
    count of launches on the wgmma body (:data:`WG`) only where ``expect``
    names it (a phase that asks which body its launches took)."""
    for name, count in counts.items():
        if name in WG.values() and name not in expect:
            continue
        if count != expect.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {count} times, expected {expect.get(name, 0)}")


def flux_lossless_phase(kernels, dev):
    """Phase 18: FLUX.1-dev at full width and depth, 3 requests, then
    FBCache at thresholds 0 and 1e6 from request 1's seed.  Returns
    (phases, request 1's latents)."""
    import torch

    t0 = time.perf_counter()
    models = build_flux(dev)
    torch.cuda.synchronize()
    mcfg = models[0]
    n_params = _numel(models[2])
    print(f"[18] FLUX.1-dev: {mcfg.double_layers} double + {mcfg.single_layers} single blocks, dim {mcfg.dim}, "
          f"{mcfg.heads} heads of {mcfg.head_dim}, {n_params / 1e9:.3f}B parameters in bf16, built in "
          f"{time.perf_counter() - t0:.1f} s; {FLUX_STEPS} steps, guidance {FLUX_GUIDANCE}, "
          f"{FLUX_SIZE} x {FLUX_SIZE}, B1")
    blocks = mcfg.double_layers + mcfg.single_layers
    pipe = flux_pipeline(*models, dev)
    torch.cuda.reset_peak_memory_stats()
    secs, lossless = [], None
    _reset_counters()
    for seed in (1, 2, 3):
        before = _counts(kernels)
        lat, img, sec = flux_request(pipe, seed)
        lo, hi = check_image(img, f"FLUX request seed {seed}", FLUX_SIZE)
        ran = {k: v - before[k] for k, v in _counts(kernels).items()}
        _check_counts(f"FLUX request seed {seed}", ran, {"flash_attn_with_lse": blocks * FLUX_STEPS + 1, WIDE: 1,
                                                         WG["flash_attn_with_lse"]: blocks * FLUX_STEPS})
        lossless = lat if lossless is None else lossless
        secs.append(sec)
        print(f"[18] FLUX request seed {seed}: image (1, {FLUX_SIZE}, {FLUX_SIZE}, 3) in [{lo:.4f}, {hi:.4f}], "
              f"kernel 1 launches {ran['flash_attn_with_lse']} (wide body {ran[WIDE]}), {sec:.4f} s/image")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[18] FLUX s/image {', '.join(f'{s:.4f}' for s in secs)}; torch.cuda.max_memory_allocated "
          f"{peak:.3f} GiB")
    phases = {"flux lossless": {"s_per_image": secs, "max_memory_allocated_gib": peak,
                                "launches": _counts(kernels)}}
    phases["flux traced"] = flux_traced_request(kernels, pipe, lossless, blocks)
    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig

    for thr, skips in ((0.0, 0), (1e6, FLUX_STEPS - 2)):
        name = f"flux fbcache {thr:g}"
        cached = flux_pipeline(*models, dev, cache=CacheAccelConfig(mode="fbcache", threshold=thr))
        _reset_counters()
        lat, img, sec = flux_request(cached, 1)
        counts = _counts(kernels)
        check_image(img, name, FLUX_SIZE)
        # threshold 0 never skips; 1e6 skips every step but the first (no
        # probe yet) and the last (always computed); a skipped step runs the
        # first double block alone
        want = blocks * (FLUX_STEPS - skips) + skips + 1
        _check_counts(name, counts, {"flash_attn_with_lse": want, WIDE: 1, WG["flash_attn_with_lse"]: want - 1})
        rel = rel_fro(lat, lossless)
        if cached.last_skips != skips or not (rel <= 1e-6 if skips == 0 else 0.0 < rel < float("inf")):
            raise AssertionError(f"{name}: {cached.last_skips} skipped steps (expected {skips}), latent rel "
                                 f"err vs lossless {rel}")
        print(f"[18] {name}: latent rel err vs lossless {rel:.6e}, skipped steps {cached.last_skips}, kernel 1 "
              f"launches {counts['flash_attn_with_lse']} (expected {want}), {sec:.4f} s/image")
        phases[name] = {"s_per_image": sec, "latent_rel_err": rel, "skips": cached.last_skips,
                        "launches": counts}
    del pipe, models
    return phases, lossless


def flux_traced_request(kernels, pipe, lossless, blocks):
    """Phase 18's request at seed 1 under the tracer switched on, in a
    ``total`` scope as ``RuntimeConfig.use_profiler`` runs it: the latents
    of the untraced request; the summary's window holds the request and its
    decode, a span per step and per block's attention with device times,
    and the flash route on every attention span; and the tile-body
    counters agree with kernel 1's route counters."""
    from compactfusion_tpu_torch.utils.prof import Profiler

    _reset_counters()
    Profiler.enable()
    try:
        with Profiler.scope("total"):
            lat, img, sec = flux_request(pipe, 1)
        table = Profiler.span_table()
        summary = Profiler.summary()
    finally:
        Profiler.enable(False)
    check_image(img, "FLUX traced request", FLUX_SIZE)
    rel = rel_fro(lat, lossless)
    calls = blocks * FLUX_STEPS
    rows = {name: table.get(name, {}).get("count") for name in ("total", "request", "decode", "step", "attention")}
    want = {"total": 1, "request": 1, "decode": 1, "step": FLUX_STEPS, "attention": calls}
    route = table.get("attention", {}).get("attrs")
    bodies = {key: _counter(key) for key in ("flash.body.flash_wgmma_tile", "flash.body.flash_wide_tile",
                                             "flash_attn_with_lse.wgmma_launches",
                                             "flash_attn_with_lse.wide_launches")}
    if (rel > 1e-6 or rows != want or route != {"body": ["flash_wgmma_tile"], "dp": [128], "warps": [8]}
            or any(table[n]["device_ms"] is None for n in want)
            or bodies != {"flash.body.flash_wgmma_tile": calls, "flash.body.flash_wide_tile": 1,
                          "flash_attn_with_lse.wgmma_launches": calls, "flash_attn_with_lse.wide_launches": 1}):
        raise AssertionError(f"FLUX traced request: latent rel err vs untraced {rel}, span counts {rows} "
                             f"(expected {want}), attention route {route}, body counters {bodies}\n{summary}")
    print(f"[18] FLUX traced request (tracer on, seed 1): latent rel err vs untraced {rel:.3e}, {sec:.4f} "
          f"s/image; spans {rows}; attention route {route}; body counters {bodies}; summary: "
          + " | ".join(line.strip() for line in summary.splitlines()[:12]))
    return {"s_per_image": sec, "latent_rel_err": rel, "spans": rows, "body_counters": bodies,
            "launches": _counts(kernels), "device_ms": {n: table[n]["device_ms"] for n in want},
            "self_device_ms": {n: table[n]["self_device_ms"] for n in want}}


def _rel_np(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ring_phase(phase, results, name, lossless, expect, bound, references=(), low=None, f32=False):
    """Checks one run of phases 13-15 on every rank: the same whole
    latents, launch counts equal to ``expect`` ({kernel: count}, others 0),
    and the latent error against ``lossless`` (below ``bound``; above
    ``low`` when given) and against each of ``references`` ((name,
    latents, bound)); ``f32``: the run is fp32 throughout (:func:`_all_f32`).
    Returns the phase's report with the counts summed over ranks."""
    import numpy as np

    runs = [r[name] for r in results]
    lat = runs[0]["latents"]
    expect = _with_routes(expect)
    if f32:
        expect = _all_f32(expect)
    for i, r in enumerate(runs):
        if not np.array_equal(r["latents"], lat):
            raise AssertionError(f"{name}: rank {i}'s latents differ from rank 0's")
        _check_counts(f"{name} rank {i}", r["launches"], expect)
    rel = _rel_np(lat, lossless)
    if not (rel <= bound and (low is None or rel > low)):
        raise AssertionError(f"{name}: latent rel err vs lossless {rel} outside ({low}, {bound}]")
    rep = {"latent_rel_err_vs_lossless": rel, "s_per_image": [r["s_per_image"] for r in runs],
           "wire_bytes_per_rank": runs[0]["wire_bytes"],
           "consistency_dev": max(r["consistency_dev"] for r in runs),
           "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
           "launches_per_rank": runs[0]["launches"]}
    line = (f"[{phase}] {name} ({len(runs)} processes on one GPU, gloo): latents equal on every "
            f"rank; rel err vs lossless {rel:.6g} (bound {bound}"
            + (f", > {low}" if low is not None else "") + ")")
    for ref_name, ref_lat, ref_bound in references:
        rep[f"latent_rel_err_vs_{ref_name}"] = r_ref = _rel_np(lat, ref_lat)
        if not r_ref <= ref_bound:
            raise AssertionError(f"{name}: latent rel err vs {ref_name} {r_ref} > {ref_bound}")
        line += f"; vs {ref_name} {r_ref:.6g} (bound {ref_bound})"
    print(line + f"; s/image {', '.join(f'{s:.4f}' for s in rep['s_per_image'])} (shared card, "
          f"not a ring speed); ring-shift bytes per rank {rep['wire_bytes_per_rank']}; launches per "
          f"rank: {', '.join(f'{k} {v}' for k, v in runs[0]['launches'].items() if v)}")
    return rep


def flux_ring_phase(kernels, dev, codecs):
    """Phase 19: FLUX.1-dev at full width, its depth cut to 1 double + 2
    single blocks, as a ring of 2 processes on this card (gloo): lossless
    and BINARY (residual 1 + EF, warmup 4, the consistency check on), each
    unfused and fused, every run against one process running the same cut
    model lossless, the fused runs against the unfused ones, with exact
    launch counts on every rank; the same spawn runs phase 26's U2.  Returns
    (the phases, the one-process latents, the spawn's results)."""
    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    n_double, n_single = FLUX_CUT
    layers = n_double + n_single
    models = build_flux(dev, n_double, n_single)
    _reset_counters()
    lat, img, sec = flux_request(flux_pipeline(*models, dev, steps=RANK_STEPS), 1)
    check_image(img, "FLUX cut, one process", FLUX_SIZE)
    _check_counts("FLUX cut, one process", _counts(kernels),
                  {"flash_attn_with_lse": layers * RANK_STEPS + 1, WIDE: 1})
    del models
    torch.cuda.empty_cache()
    one = lat.float().cpu().numpy()
    print(f"[19] FLUX.1-dev with its depth cut to {n_double} double + {n_single} single blocks (FLUX's 1 : 2 "
          f"ratio; full width, {RANK_STEPS} steps, {FLUX_SIZE} x {FLUX_SIZE}): one process, lossless, "
          f"{sec:.4f} s/image")
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    binary = {"compress_type": "binary", "comp_rank": -1, "check_consistency": True}
    names = ("flux ring2 lossless", "flux ring2 lossless fused", "flux ring2 binary", "flux ring2 binary fused")
    two = spawn_local(ring_rank, 2, "gloo", list(zip(names, (ring2, fused2, ring2, fused2),
                                                     (None, None, binary, binary)))
                      + [("flux u2 lossless", {"ulysses_degree": 2}, None)], "flux", threads=2)
    # ring 2: two hops per attention; the unfused ring launches kernel 1 per
    # hop (the text joins hop 0's K/V), the fused one kernel 7 per hop and
    # kernel 1 once for the text block; the fused compressed ring runs its
    # warmup steps unfused, then kernel 8 and its EF pass per hop; each rank
    # decodes its image (one wide-body launch)
    hops, comp = 2 * layers, RANK_STEPS - WARMUP
    expect = [{"flash_attn_with_lse": hops * RANK_STEPS + 1},
              {"flash_attn_with_lse": layers * RANK_STEPS + 1, "ring_flash_attn_with_lse": hops * RANK_STEPS},
              {"flash_attn_with_lse": hops * RANK_STEPS + 1, "binary_quant_fastpath": hops * comp,
               "binary_dequant_fastpath": hops * comp},
              {"flash_attn_with_lse": hops * WARMUP + layers * comp + 1, "compact_ring_flash": hops * comp,
               "ef_update_slot": hops * comp}]
    phases = {}
    for i, name in enumerate(names):
        fused = name.endswith("fused")
        refs = [(names[i - 1], two[0][names[i - 1]]["latents"], RING_REL_MAX)] if fused else []
        if "binary" in name:
            phases[name] = ring_phase(19, two, name, one, expect[i], COMPRESSED_REL_ERR_MAX, refs, low=0.0)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
        else:
            phases[name] = ring_phase(19, two, name, one, expect[i], RING_REL_MAX, refs)
    # wire bytes: the raw fp32 K/V in warmup, then the payloads; the same on both routes
    n, c = FLUX_RING_LOCAL, FLUX_HEADS * FLUX_HEAD_DIM
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    want_bytes = layers * (WARMUP * 2 * n * c * 4 + comp * 2 * payload)
    got_bytes = [phases[k]["wire_bytes_per_rank"] for k in names[2:]]
    print(f"[19] EF caches across the ring: largest deviation "
          f"{max(phases[k]['consistency_dev'] for k in names[2:])}; ring-shift bytes per rank of the binary "
          f"runs {got_bytes}, expected {want_bytes} (payload_nbytes {payload} per K or V)")
    if got_bytes != [want_bytes, want_bytes]:
        raise AssertionError("phase 19: the binary rings sent other bytes than their payloads")
    return phases, one, two


def f32_flash_cases(gen, dev):
    """Kernel 1 in fp32 at the path's shapes: PixArt's self-attention
    (column slices of one fp32 qkv tensor), the same with ``kv_lens`` (1000,
    0) (a batch with no key: rows of LSE -inf), FLUX's self-attention at
    d=128 and the VAE's d=512 (the wide body)."""
    import torch

    f32, s_all = torch.float32, FLUX_TXT + FLUX_IMG

    def with_lens():
        return (*_qkv_views(gen, dev, 2, 1024, dtype=f32), torch.tensor([1000, 0], dtype=torch.int32, device=dev))

    return [
        ("fp32 self-attn B2 H16 S1024 d72", lambda: _qkv_views(gen, dev, 2, 1024, dtype=f32), 20),
        ("fp32 self-attn B2 H16 S1024 d72 kv_lens (1000, 0)", with_lens, 20),
        (f"fp32 FLUX self-attn B1 H{FLUX_HEADS} S{s_all} d{FLUX_HEAD_DIM}",
         lambda: _qkv_views(gen, dev, 1, s_all, FLUX_HEADS, FLUX_HEAD_DIM, f32), 5),
        ("fp32 VAE mid-attn B1 H1 S4096 d512",
         lambda: tuple(torch.randn((1, 4096, 1, 512), generator=gen, device=dev) for _ in range(3)), 5),
    ]


def check_f32_kernels(flash, rf, timing, dev, gen):
    """Phase 20: kernels 1, 4, 7 and 8 (and 8's EF pass) on fp32 q/k/v
    against their fp32 twins at the path's shapes and FLUX's d=128: out
    within :data:`F32_OUT_REL_MAX`, LSE within :data:`F32_LSE_ATOL`, rows
    with no key -inf in both; kernel 8's stacks and fp32 reconstructions bit
    for bit.  No fp32 instantiation may spill (ptxas).  Returns the rows by
    kernel."""
    import torch

    f32 = torch.float32
    spilled = {k: v for k, v in PTXAS.items() if "_f32" in k and "0 bytes spill stores, 0 bytes spill loads" not in v}
    built = sorted(k for k in PTXAS if "_f32" in k)
    print(f"[20] {len(built)} fp32 kernel instantiations built, none spills: {not spilled}")
    if not built or spilled:
        raise AssertionError(f"fp32 kernels that spill (ptxas): {spilled}")
    flash_rows = check_flash(flash, timing, dev, gen, f32_flash_cases(gen, dev), phase=20)
    if [r["plan"][0] for r in flash_rows] != ["flash_reg_tile"] * 3 + ["flash_wide_tile"]:
        raise AssertionError(f"fp32 kernel 1 took the plans {[r['plan'] for r in flash_rows]}")
    window_rows, _ = check_window(flash, dev, gen, [
        (f"fp32 B2 H16 S1024 d72 w{w}", lambda: _qkv_views(gen, dev, 2, 1024, dtype=f32), w)
        for w in (WINDOW, 0, 1024)], timing, phase=20)
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen,
                                 ring_cases(gen, dev, f32) + flux_ring_cases(gen, dev, f32), phase=20)
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, b, 512, codec, -1, quantized, phase=20,
                                     dtype=f32)
                  for b, quantized in ((2, False), (1, True)) for codec in ("binary", "int2")]
    cring_rows.append(check_compact_ring(rf, flash, timing, dev, gen, 2, 1, FLUX_RING_LOCAL, "binary", -1, False,
                                         FLUX_HEADS, FLUX_HEAD_DIM, FLUX_TXT + FLUX_RING_LOCAL, phase=20,
                                         dtype=f32))
    return {"flash": flash_rows, "window": window_rows, "ring": ring_rows, "cring": cring_rows,
            "ptxas": {k: PTXAS[k] for k in built}}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def cfg_forward(params, mcfg, pos_embed, text, mask, x, t):
    """One CFG forward of the PixArt denoiser as the pipeline's first step
    runs it: the [cond; uncond] text path, then ``pixart_forward`` on the
    latents twice over."""
    import torch

    from compactfusion_tpu_torch.models.pixart import pixart_forward, precompute_text_kv

    with torch.inference_mode():
        text2, mask2 = torch.cat([text[0], text[1]]), torch.cat([mask[0], mask[1]])
        kv = precompute_text_kv(params, text2).to(mcfg.dtype)
        out, _ = pixart_forward(params, torch.cat([x, x]).to(mcfg.dtype), t, None, mcfg, pos_embed=pos_embed,
                                text_mask=mask2, text_kv=kv)
    return out


def f32_pipeline_phase(kernels, dev):
    """Phase 21: full-width PixArt-alpha 512 in fp32 (the model and its VAE,
    ``build_models(dev, torch.float32)``): 2 requests (a valid image,
    s/image, every flash launch an fp32 one: 28 x 20 of kernel 1 and the
    VAE's on the wide body), one CFG forward of request 1's first step on
    the card against the same forward on this machine's CPU through the
    plain versions, then DiTFastAttn's fixed mixed plan (kernel 4 in fp32).
    Returns (phases, models)."""
    import torch

    from compactfusion_tpu_torch.cache.fast_attn import optimize_plan
    from compactfusion_tpu_torch.pipelines import base

    t0 = time.perf_counter()
    models = build_models(dev, torch.float32)
    mcfg = models[0]
    pipe = pixart_pipeline(*models, dev)
    print(f"[21] PixArt-alpha 512 in fp32 ({mcfg.depth} blocks, dim {mcfg.dim}, {mcfg.heads} heads of "
          f"{mcfg.head_dim}, SD-VAE in {models[1].dtype}), built in {time.perf_counter() - t0:.1f} s")
    want = _all_f32(_with_routes({"flash_attn_with_lse": DEPTH * STEPS + 1}))
    secs, lossless = [], None
    _reset_counters()
    for seed in (1, 2):
        before = _counts(kernels)
        lat, img, sec = request(pipe, seed)
        lo, hi = check_image(img, f"fp32 request seed {seed}")
        ran = {k: v - before[k] for k, v in _counts(kernels).items()}
        _check_counts(f"fp32 request seed {seed}", ran, want)
        lossless = lat if lossless is None else lossless
        secs.append(sec)
        print(f"[21] fp32 request seed {seed}: image (1, 512, 512, 3) in [{lo:.4f}, {hi:.4f}], kernel 1 launches "
              f"{ran['flash_attn_with_lse']} (fp32 {ran[F32['flash_attn_with_lse']]}, fp32 wide body "
              f"{ran[F32_WIDE]}), {sec:.4f} s/image")
    phases = {"fp32 lossless": {"s_per_image": secs, "launches": _counts(kernels)}}

    # request 1's first step, one CFG forward, on the card and on the CPU
    g = torch.Generator(device=dev).manual_seed(1)  # as in request(pipe, 1): text, then noise
    text = torch.randn((2, 1, 120, mcfg.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    x = base.prepare_latents(g, 1, pipe.cfg.tokens, mcfg.patch**2 * mcfg.in_channels, torch.float32, dev)
    t = torch.full((2,), float(pipe.sched.timesteps[0]), dtype=torch.float32, device=dev)
    _reset_counters()
    gpu = cfg_forward(models[2], mcfg, pipe.pos_embed, text, mask, x, t)
    counts = _counts(kernels)
    _check_counts("fp32 CFG forward", counts, _all_f32({"flash_attn_with_lse": DEPTH}))
    t0 = time.perf_counter()
    cpu = cfg_forward(_to(models[2], "cpu"), mcfg, pipe.pos_embed.cpu(), text.cpu(), mask.cpu(), x.cpu(), t.cpu())
    cpu_s = time.perf_counter() - t0
    rel = rel_fro(gpu.cpu(), cpu)
    print(f"[21] one fp32 CFG forward (B2 S1024, {DEPTH} blocks) on the card vs this machine's CPU ({cpu_s:.1f} s "
          f"through the plain versions): rel err {rel:.3e} (bound {F32_FORWARD_REL_MAX}); out "
          f"{tuple(gpu.shape)}, finite {bool(torch.isfinite(gpu).all())}; kernel 1 launches "
          f"{counts[F32['flash_attn_with_lse']]} fp32")
    if not (rel <= F32_FORWARD_REL_MAX and bool(torch.isfinite(gpu).all())):
        raise AssertionError(f"fp32 CFG forward: rel err vs the CPU {rel} > {F32_FORWARD_REL_MAX}")
    phases["fp32 CFG forward vs CPU"] = {"rel_err": rel, "cpu_s": cpu_s, "launches": counts}

    mixed = optimize_plan(mixed_plan())
    phases["fp32 fast-attn mixed plan"] = accel_phase(
        21, "fp32 fast-attn mixed plan (all seven methods)",
        pixart_pipeline(*models, dev, fast_attn_plan=tuple(tuple(int(m) for m in row) for row in mixed_plan()),
                        fast_attn_window=WINDOW),
        kernels, lossless, *plan_launches(mixed), f32=True)
    return phases, models


def f32_ring_phase(kernels, dev, codecs, models):
    """Phase 22: the fp32 pipeline of phase 21, cut to :data:`SP_CUT`
    blocks, as a ring of 2 gloo processes
    on this card, lossless and BINARY (residual 1 + EF, warmup 4, the
    consistency check on), each unfused and fused: every run within
    :data:`F32_RING_LOSSLESS_REL_MAX` (the lossless runs, of request 1 of
    one process on the same cut) or :data:`F32_RING_BINARY_REL_MAX` (the
    BINARY runs, of the cut's fp32 ring-2 emulation and, fused, of the
    unfused run) of one process
    computing the same function, the BINARY runs also 0 < err < 0.05 from lossless,
    EF caches equal across ranks, the same wire bytes on both routes, every
    flash launch an fp32 one.  Returns the phases."""
    import dataclasses

    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    mcfg, vcfg, params, vae_params = models
    models = dataclasses.replace(mcfg, depth=SP_CUT), vcfg, _cut_blocks(params, SP_CUT), vae_params
    lossless, _, sec = request(pixart_pipeline(*models, dev, steps=RANK_STEPS), 1)
    lossless_np = lossless.float().cpu().numpy()
    print(f"[22] fp32 PixArt cut to its first {SP_CUT} of {DEPTH} blocks: one process, lossless, {sec:.4f} s/image")
    _reset_counters()
    sim_lat, sim_img, sim_sec = request(pixart_pipeline(
        *models, dev, steps=RANK_STEPS, compact=ring_compact("binary", comp_rank=-1, simulate_ring=2)), 1)
    check_image(sim_img, "fp32 ring-2 emulation")
    sim_np = sim_lat.float().cpu().numpy()
    print(f"[22] single-process fp32 ring-2 binary emulation: rel err vs lossless {_rel_np(sim_np, lossless_np):.6f}, "
          f"{sim_sec:.4f} s/image")
    hops, comp = 2 * SP_CUT, RANK_STEPS - WARMUP
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    binary = {"compress_type": "binary", "comp_rank": -1, "check_consistency": True}
    names = ("fp32 ring2 lossless", "fp32 ring2 lossless fused", "fp32 ring2 binary", "fp32 ring2 binary fused")
    two = spawn_local(ring_rank, 2, "gloo", list(zip(names, (ring2, fused2, ring2, fused2),
                                                     (None, None, binary, binary))), "pixart-fp32-cut", threads=2)
    expect = [{"flash_attn_with_lse": hops * RANK_STEPS + 1},
              {"flash_attn_with_lse": 1, "ring_flash_attn_with_lse": hops * RANK_STEPS},
              {"flash_attn_with_lse": hops * RANK_STEPS + 1, "binary_quant_fastpath": hops * comp,
               "binary_dequant_fastpath": hops * comp},
              {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp,
               "ef_update_slot": hops * comp}]
    phases = {}
    for i, name in enumerate(names):
        if "binary" in name:
            refs = [("the fp32 ring-2 emulation", sim_np, F32_RING_BINARY_REL_MAX)]
            if name.endswith("fused"):
                refs.append((names[i - 1], two[0][names[i - 1]]["latents"], F32_RING_BINARY_REL_MAX))
            phases[name] = ring_phase(22, two, name, lossless_np, expect[i], COMPRESSED_REL_ERR_MAX, refs, low=0.0,
                                      f32=True)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
        else:
            phases[name] = ring_phase(22, two, name, lossless_np, expect[i], F32_RING_LOSSLESS_REL_MAX,
                                      f32=True)
    n, c = 2 * 1024 // 2, 1152
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    want_bytes = SP_CUT * (WARMUP * 2 * n * c * 4 + comp * 2 * payload)
    got_bytes = [phases[k]["wire_bytes_per_rank"] for k in names[2:]]
    print(f"[22] EF caches across the ring: largest deviation {max(phases[k]['consistency_dev'] for k in names[2:])}; "
          f"ring-shift bytes per rank of the binary runs {got_bytes}, expected {want_bytes}")
    if got_bytes != [want_bytes, want_bytes]:
        raise AssertionError("phase 22: the binary rings sent other bytes than their payloads")
    return phases


def sp_flash_cases(gen, dev):
    """Kernel 1 at the shapes Ulysses and the patch gather give it: PixArt's
    self-attention at U2 (the whole sequence, 8 heads of 72), a U2 x R2
    hop (512 rows, 8 heads), the patch gather at R2 (512 query rows over
    the 1024 gathered keys, 16 heads), and FLUX at U2 (the 512 text rows
    in each Ulysses rank's chunk, 2 x 2560 query rows over the 512 text + 4096
    image keys, 12 heads of 128), and at U2 x R2 the text-joined hop 0, hop 1
    (the peer's 2048 image keys) and the fused route's joint block (the 512
    text keys alone)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def qkv(b, sq, sk, h, d):
        return lambda: (rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d))

    def patch():
        q, _, _ = _qkv_views(gen, dev, 2, 512)
        return q, rnd(2, 1024, 16, 72), rnd(2, 1024, 16, 72)

    fq, fk = 2 * (FLUX_TXT + FLUX_IMG // 2), FLUX_TXT + FLUX_IMG
    hq, hk = 2 * (FLUX_TXT + FLUX_IMG // 4), FLUX_TXT + FLUX_IMG // 2
    h = FLUX_HEADS // 2
    return [
        ("Ulysses U2 self-attn B2 H8 S1024 d72", qkv(2, 1024, 1024, 8, 72), 20),
        ("U2 x R2 hop B2 H8 Sq512 Sk512 d72", qkv(2, 512, 512, 8, 72), 20),
        ("patch gather R2 B2 H16 Sq512 Sk1024 d72", patch, 20),
        (f"FLUX Ulysses U2 B1 H{h} Sq{fq} Sk{fk} d{FLUX_HEAD_DIM} (text rows in each chunk)",
         qkv(1, fq, fk, h, FLUX_HEAD_DIM), 10),
        (f"FLUX U2 x R2 hop 0 (text joint in front) B1 H{h} Sq{hq} Sk{hk} d{FLUX_HEAD_DIM}",
         qkv(1, hq, hk, h, FLUX_HEAD_DIM), 10),
        (f"FLUX U2 x R2 hop 1 B1 H{h} Sq{hq} Sk{hk - FLUX_TXT} d{FLUX_HEAD_DIM}",
         qkv(1, hq, hk - FLUX_TXT, h, FLUX_HEAD_DIM), 10),
        (f"FLUX U2 x R2 fused joint block B1 H{h} Sq{hq} Sk{FLUX_TXT} d{FLUX_HEAD_DIM}",
         qkv(1, hq, FLUX_TXT, h, FLUX_HEAD_DIM), 10),
    ]


def sp_ring_cases(gen, dev):
    """Kernel 7 at the U2 x R2 ring hop: PixArt's 512 rows of 8 heads a
    rank (B2), and FLUX's 12 heads of 128 with the text rows in front of
    the 2048 image rows of each Ulysses rank's chunk, rank 0's view."""
    import torch

    def make(b, sq, s_local, h, d):
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        blocks = [tuple(torch.randn((b, s_local, h, d), generator=gen, device=dev).to(torch.bfloat16)
                        for _ in range(2)) for _ in range(2)]
        return q, blocks

    fq, fs = 2 * (FLUX_TXT + FLUX_IMG // 4), FLUX_IMG // 2
    return [((2, 2, 512), lambda: make(2, 512, 512, 8, 72)),
            ((2, 1, fs), lambda: make(1, fq, fs, FLUX_HEADS // 2, FLUX_HEAD_DIM))]


def check_sp_kernels(flash, quant, codecs, rf, timing, dev, gen):
    """Phase 23: kernels 1, 7 and 8 at the shapes Ulysses and the patch
    gather give them, and kernels 2/3 and 5/6 at the compressed all-gather's
    N1024 C1152 (B2 x 512 tokens a rank, 16 heads of 72) and the compressed
    USP ring's N1024 C576 (B2 x 2 x 256 tokens, 8 heads), kernels 2/3 also
    at FLUX's compressed USP ring, N2048 C1536 (2 x 1024 tokens, 12 heads
    of 128): every check and timing as in phases 2 and 12.  Returns the
    rows by kernel."""
    import torch

    flash_rows = check_flash(flash, timing, dev, gen, sp_flash_cases(gen, dev), phase=23)
    flux_usp = FLUX_IMG // 4 * 2, FLUX_HEADS // 2 * FLUX_HEAD_DIM
    shapes = {"binary": ((1024, 1152), (1024, 576), flux_usp), "int2": ((1024, 1152), (1024, 576))}
    quant_rows = {codec: [check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32, shape, phase=23)
                          for shape in shapes[codec]] for codec in shapes}
    for codec, rows in quant_rows.items():
        for r in rows:
            if [r["quant_plan_bytes_per_thread"], r["dequant_plan_bytes_per_thread"]] != [quant.QUANT_VEC_BYTES] * 2:
                raise AssertionError(f"phase 23: {r['shape']} did not take the vector plans")
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, sp_ring_cases(gen, dev), phase=23)
    fq = 2 * (FLUX_TXT + FLUX_IMG // 4)
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 2, 512, codec, -1, False, 8, 72, phase=23)
                  for codec in ("binary", "int2")]
    cring_rows.append(check_compact_ring(rf, flash, timing, dev, gen, 2, 1, FLUX_IMG // 2, "binary", -1, False,
                                         FLUX_HEADS // 2, FLUX_HEAD_DIM, fq, phase=23))
    return {"flash": flash_rows, "quant": quant_rows, "ring": ring_rows, "cring": cring_rows}


def _payload_bytes(codecs, n, c, codec):
    import torch

    return codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType(codec)))


def pixart_sp_phases(two, four, lossless_np, codecs):
    """Phases 24, 25 and 27 from the runs of :func:`pixart_spawns`' 2-process
    spawn (``two``: ring 2, Ulysses 2, the patch gathers and FBCache at R2)
    and its 4-process spawn (``four``: U2 x R2 lossless and BINARY, unfused
    and fused), PixArt cut to :data:`SP_CUT` blocks; ``lossless_np``: one
    process's latents of the same cut model.  Returns the phases."""
    depth = SP_CUT
    hops, comp = 2 * depth, RANK_STEPS - WARMUP
    phases = {}
    ring2_np = two[0]["ring2 lossless"]["latents"]  # phase 13's
    # -- 24: Ulysses ----------------------------------------------------------
    phases["u2 lossless"] = ring_phase(24, two, "u2 lossless", lossless_np,
                                       {"flash_attn_with_lse": depth * RANK_STEPS + 1}, HALVES_REL_MAX)
    expect = {"u2r2 lossless": {"flash_attn_with_lse": hops * RANK_STEPS + 1},
              "u2r2 lossless fused": {"flash_attn_with_lse": 1, "ring_flash_attn_with_lse": hops * RANK_STEPS},
              "u2r2 binary": {"flash_attn_with_lse": hops * RANK_STEPS + 1, "binary_quant_fastpath": hops * comp,
                              "binary_dequant_fastpath": hops * comp},
              "u2r2 binary fused": {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp,
                                    "ef_update_slot": hops * comp}}
    for name, want in expect.items():
        refs = []
        if name.endswith("fused"):
            unfused = name[:-len(" fused")]
            refs = [(unfused, four[0][unfused]["latents"], RING_REL_MAX)]
        if "binary" in name:
            phases[name] = ring_phase(24, four, name, lossless_np, want, COMPRESSED_REL_ERR_MAX, refs, low=0.0)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across the ring")
        else:
            phases[name] = ring_phase(24, four, name, lossless_np, want, HALVES_REL_MAX, refs)
    # the ring of U2 x R2: N = B2 x 256 tokens x U2 rows of (8 heads x 72) channels
    n, c = 2 * 1024 // 4 * 2, 1152 // 2
    want_bytes = depth * (WARMUP * 2 * n * c * 4 + comp * 2 * _payload_bytes(codecs, n, c, "binary"))
    got = [phases[k]["wire_bytes_per_rank"] for k in ("u2r2 binary", "u2r2 binary fused")]
    a2a = {k: [r[k]["all_to_all_bytes"] for r in four] for k in expect}
    # per layer and step: q, k, v and out, each (B2, 256 tokens, 16 heads of 72) in bf16, half of it sent
    want_a2a = depth * RANK_STEPS * 4 * (2 * 256 * 1152 * 2) // 2
    print(f"[24] ring-shift bytes per rank of the binary runs {got}, expected {want_bytes}; all-to-all bytes "
          f"sent per rank and image {sorted({b for v in a2a.values() for b in v})}, expected {want_a2a} "
          f"(U2 in 2 processes: {[r['u2 lossless']['all_to_all_bytes'] for r in two]})")
    if got != [want_bytes, want_bytes] or any(b != want_a2a for v in a2a.values() for b in v):
        raise AssertionError("phase 24: the rings or the all-to-alls sent other bytes than the path implies")
    if any(r["u2 lossless"]["all_to_all_bytes"] != 2 * want_a2a for r in two):
        raise AssertionError("phase 24: the U2 all-to-alls sent other bytes than the path implies")
    for k in expect:
        phases[k]["all_to_all_bytes_per_rank"] = want_a2a
    phases["u2 lossless"]["all_to_all_bytes_per_rank"] = 2 * want_a2a
    # -- 25: the patch gather at R2 ------------------------------------------
    n, c = 2 * 512, 1152
    dense = 2 * n * c * 2  # K and V of one rank in bf16
    phases["patch sync"] = ring_phase(25, two, "patch sync", lossless_np,
                                      {"flash_attn_with_lse": depth * RANK_STEPS + 1}, HALVES_REL_MAX)
    want_gather = {"patch sync": depth * RANK_STEPS * 2 * dense}
    for codec in ("binary", "int2"):
        name = f"patch {codec}"
        phases[name] = ring_phase(
            25, two, name, lossless_np,
            {"flash_attn_with_lse": depth * RANK_STEPS + 1, f"{codec}_quant_fastpath": 2 * depth * comp,
             f"{codec}_dequant_fastpath": 2 * 2 * depth * comp}, COMPRESSED_REL_ERR_MAX, low=0.0)
        payload = _payload_bytes(codecs, n, c, codec)
        # warmup: the raw fp32 K/V; then the payloads; each gathered from W = 2 ranks
        want_gather[name] = depth * 2 * 2 * (WARMUP * n * c * 4 + comp * payload)
        phases[name]["dense_over_compressed"] = (n * c * 2) / payload
        if phases[name]["consistency_dev"] != 0.0:
            raise AssertionError(f"{name}: the gathered slots differ across ranks")
        print(f"[25] {name}: all W slots equal across ranks; payload {payload} bytes per K or V against "
              f"{n * c * 2} dense bf16 ({phases[name]['dense_over_compressed']:.2f}x)")
    phases["patch async"] = ring_phase(25, two, "patch async", lossless_np,
                                       {"flash_attn_with_lse": depth * RANK_STEPS + 1}, PATCH_ASYNC_REL_MAX, low=0.0)
    want_gather["patch async"] = depth * RANK_STEPS * 2 * dense
    got_gather = {k: [r[k]["gather_bytes"] for r in two] for k in want_gather}
    print(f"[25] gathered bytes per rank and image {got_gather}, expected {want_gather}")
    if any(b != want_gather[k] for k, v in got_gather.items() for b in v):
        raise AssertionError("phase 25: the patch gathers gathered other bytes than W x their payloads")
    for k in want_gather:
        phases[k]["gather_bytes_per_rank"] = want_gather[k]
    # -- 27: FBCache at R2 ----------------------------------------------------
    for thr, skips in ((0.0, 0), (1e6, RANK_STEPS - 2)):
        name = f"ring2 fbcache {thr:g}"
        # a skipped step runs block 0 alone: its two hops
        want = {"flash_attn_with_lse": hops * (RANK_STEPS - skips) + 2 * skips + 1}
        phases[name] = ring_phase(27, two, name, lossless_np, want,
                                  HALVES_REL_MAX if skips == 0 else float("inf"), low=None if skips == 0 else 0.0)
        got = [r[name]["skips"] for r in two]
        if got != [skips, skips]:
            raise AssertionError(f"{name}: skipped steps {got} on the ranks, expected {skips} on each")
        phases[name]["skips"] = skips
        if skips == 0:
            if not (two[0][name]["latents"] == ring2_np).all():
                raise AssertionError(f"{name}: not bit-equal to the ring-2 lossless run")
            print(f"[27] {name}: bit-equal to phase 13's ring-2 lossless run; skipped steps {got}")
        else:
            print(f"[27] {name}: skipped steps {got} (the probe summed over the ring), kernel 1 launches "
                  f"{want['flash_attn_with_lse']} per rank")
    return phases


def flux_sp_phases(two, four, one, codecs):
    """Phase 26: FLUX.1-dev at phase 19's cut depth as Ulysses 2 (2
    processes) and U2 x R2 (4 processes, lossless and BINARY, unfused and
    fused), every run against ``one`` (one process running the same cut
    model), with phase 19's bounds.  Returns the phases."""
    layers = sum(FLUX_CUT)
    hops, comp = 2 * layers, RANK_STEPS - WARMUP
    phases = {"flux u2 lossless": ring_phase(26, two, "flux u2 lossless", one,
                                             {"flash_attn_with_lse": layers * RANK_STEPS + 1}, RING_REL_MAX)}
    expect = {"flux u2r2 lossless": {"flash_attn_with_lse": hops * RANK_STEPS + 1},
              "flux u2r2 lossless fused": {"flash_attn_with_lse": layers * RANK_STEPS + 1,
                                           "ring_flash_attn_with_lse": hops * RANK_STEPS},
              "flux u2r2 binary": {"flash_attn_with_lse": hops * RANK_STEPS + 1,
                                   "binary_quant_fastpath": hops * comp, "binary_dequant_fastpath": hops * comp},
              "flux u2r2 binary fused": {"flash_attn_with_lse": hops * WARMUP + layers * comp + 1,
                                         "compact_ring_flash": hops * comp, "ef_update_slot": hops * comp}}
    for name, want in expect.items():
        refs = []
        if name.endswith("fused"):
            unfused = name[:-len(" fused")]
            refs = [(unfused, four[0][unfused]["latents"], RING_REL_MAX)]
        if "binary" in name:
            phases[name] = ring_phase(26, four, name, one, want, COMPRESSED_REL_ERR_MAX, refs, low=0.0)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across the ring")
        else:
            phases[name] = ring_phase(26, four, name, one, want, RING_REL_MAX, refs)
    n, c = FLUX_IMG // 4 * 2, FLUX_HEADS // 2 * FLUX_HEAD_DIM
    want_bytes = layers * (WARMUP * 2 * n * c * 4 + comp * 2 * _payload_bytes(codecs, n, c, "binary"))
    got = [phases[k]["wire_bytes_per_rank"] for k in ("flux u2r2 binary", "flux u2r2 binary fused")]
    print(f"[26] ring-shift bytes per rank of the binary runs {got}, expected {want_bytes}; all-to-all bytes "
          f"per rank and image: U2 {two[0]['flux u2 lossless']['all_to_all_bytes']}, U2 x R2 "
          f"{four[0]['flux u2r2 lossless']['all_to_all_bytes']}")
    if got != [want_bytes, want_bytes]:
        raise AssertionError("phase 26: the binary rings sent other bytes than their payloads")
    return phases


#: phase 15's run: cfg 2 x ring 2 in 4 processes, fused LOW_RANK r4 on int8 EF caches
CFG2_RING2 = "cfg2 x ring2 low-rank r4 int8 fused"


def pixart_spawns(spawn_local):
    """The PixArt spawns of phases 13-15, 24, 25 and 27, PixArt cut to
    :data:`SP_CUT` blocks: in 2 processes cfg 2, ring 2 lossless and
    BINARY (unfused and fused), U2, the patch gathers and FBCache at R2; in
    4 cfg 2 x ring 2 (:data:`CFG2_RING2`) and U2 x R2 lossless and BINARY,
    unfused and fused.  Returns them and their seconds."""
    binary = {"compress_type": "binary", "comp_rank": -1}
    checked = dict(binary, check_consistency=True)
    patch = {"patch_gather": True, "check_consistency": True}
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    u2r2, u2r2_fused = {"ulysses_degree": 2, "ring_degree": 2}, {"ulysses_degree": 2, "ring_degree": 2,
                                                                  "use_fused_ring": True}
    secs = {}
    t0 = time.perf_counter()
    two = spawn_local(ring_rank, 2, "gloo", [
        ("cfg2 lossless", {"cfg_degree": 2}, None),
        ("ring2 lossless", ring2, None), ("ring2 lossless fused", fused2, None),
        ("ring2 binary", ring2, binary), ("ring2 binary fused", fused2, binary),
        ("u2 lossless", {"ulysses_degree": 2}, None),
        ("patch sync", ring2, {"compress_type": "identity", "patch_gather": True}),
        ("patch binary", ring2, dict(patch, compress_type="binary")),
        ("patch int2", ring2, dict(patch, compress_type="int2")),
        ("patch async", ring2, {"compress_type": "identity", "patch_gather": True, "patch_async": True,
                                "error_feedback": False}),
        ("ring2 fbcache 0", ring2, None, {"mode": "fbcache", "threshold": 0.0}),
        ("ring2 fbcache 1e+06", ring2, None, {"mode": "fbcache", "threshold": 1e6})], "pixart-cut", threads=2)
    secs["2 processes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = spawn_local(ring_rank, 4, "gloo", [
        (CFG2_RING2, {"cfg_degree": 2, "ring_degree": 2, "use_fused_ring": True},
         {"compress_type": "low-rank", "comp_rank": 4, "quantized_cache": True, "check_consistency": True}),
        ("u2r2 lossless", u2r2, None), ("u2r2 lossless fused", u2r2_fused, None),
        ("u2r2 binary", u2r2, checked), ("u2r2 binary fused", u2r2_fused, checked)], "pixart-cut", threads=2)
    secs["4 processes"] = time.perf_counter() - t0
    return two, four, secs


def run_sp_phases(kernels, dev, gen, lossless_np, pixart_two, pixart_four, flux_one, flux_two):
    """Phases 23-27; returns (the kernel rows of phase 23, the phases, the
    seconds of each phase).  PixArt's runs (cut to :data:`SP_CUT` blocks)
    come from :func:`pixart_spawns`, held against ``lossless_np``, one
    process's request 1 on the same cut; FLUX's U2 from phase 19's spawn
    (``flux_two``), its U2 x R2 from a spawn of 4 here."""
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import flash, quant, ring_flash
    from compactfusion_tpu_torch.parallel.mesh import spawn_local
    from compactfusion_tpu_torch.probes import timing

    t0 = time.perf_counter()
    rows = check_sp_kernels(flash, quant, codecs, ring_flash, timing, dev, gen)
    secs = {"23": time.perf_counter() - t0}
    binary = {"compress_type": "binary", "comp_rank": -1, "check_consistency": True}
    u2r2, fused = {"ulysses_degree": 2, "ring_degree": 2}, {"ulysses_degree": 2, "ring_degree": 2,
                                                            "use_fused_ring": True}
    t0 = time.perf_counter()
    flux_four = spawn_local(ring_rank, 4, "gloo", [("flux u2r2 lossless", u2r2, None),
                                                   ("flux u2r2 lossless fused", fused, None),
                                                   ("flux u2r2 binary", u2r2, binary),
                                                   ("flux u2r2 binary fused", fused, binary)], "flux", threads=2)
    secs["spawn: flux 4 processes"] = time.perf_counter() - t0
    phases = pixart_sp_phases(pixart_two, pixart_four, lossless_np, codecs)
    phases.update(flux_sp_phases(flux_two, flux_four, flux_one, codecs))
    print(f"[23-27] seconds: {secs}")
    return rows, phases, secs


def quant_entry(quant_rows, totals, codec, which, line):
    """The kernels line's entry of one quant kernel: its first shape's
    numbers at the top, every shape in ``shapes``, and for a kernel with a
    vector plan its launches by plan."""
    rows = quant_rows[codec]
    name = f"{codec}_{which}_fastpath"
    by_plan = ({"launches_by_plan": {"vector": totals[VEC[name]], "scalar": totals[name] - totals[VEC[name]]}}
               if name in VEC else {})
    return {"name": name, "route": "cuda",
            "source": f"compactfusion_tpu_torch/csrc/{codec}_quant.cu",
            "replaces": f"compactfusion_tpu/ops/quant_pallas.py:{line}",
            "launches": totals[name],
            "max_abs_err": max(r[f"max_abs_err_{which}"] for r in rows),
            "ms": rows[0][f"{which}_ms"], "graph_ms": rows[0][f"{which}_graph_ms"],
            "plain_ms": rows[0][f"{which}_plain_ms"],
            "bound_ms": rows[0][f"{which}_bound_ms"], "bound_by": rows[0][f"{which}_bound_by"],
            "library_ms": None, "shapes": rows, **by_plan}


# -- phases 28-31: the entry points ----------------------------------------

PIXART_ARGV = ["--model", "PixArt-alpha/PixArt-XL-2-512x512", "--height", "512", "--width", "512",
               "--num_inference_steps", str(STEPS), "--prompt", "a small cactus with a happy face in the Sahara desert"]
#: phases 31's and 35's PixArt-alpha 512 (through the entry points in gloo
#: processes, and the one-process runs they are held against): 14 of its 28
#: blocks at full width, its 20 steps kept (at 10 steps the full
#: depth's bf16 order floor rose past HALVES_REL_MAX: 0.0215)
RUNNER_CUT = 14


@contextlib.contextmanager
def pixart_depth(depth):
    """Within the block, ``xDiTParallel`` builds PixArt-alpha 512 with
    ``depth`` blocks (``models.pixart.pixart_alpha_512`` swapped; its seeded
    weights are drawn at that depth)."""
    import dataclasses

    from compactfusion_tpu_torch.models import pixart as model_pixart

    real = model_pixart.pixart_alpha_512
    model_pixart.pixart_alpha_512 = lambda: dataclasses.replace(real(), depth=depth)
    try:
        yield
    finally:
        model_pixart.pixart_alpha_512 = real
FLUX_ARGV = ["--model", "black-forest-labs/FLUX.1-dev", "--height", str(FLUX_SIZE), "--width", str(FLUX_SIZE),
             "--num_inference_steps", str(FLUX_STEPS), "--prompt", "a photo of a cat"]
#: the prompts of phases 28-29's requests
PROMPTS = ("a tiny astronaut hatching from an egg on the moon", "an oil painting of a lighthouse at dawn")
#: int8 T5 against bf16 T5 (tests/io/test_t5_int8.py's bounds): close, not equal
T5_INT8_REL = (1e-6, 0.05)
#: int8 weights' share of the bf16 bytes (tests/io/test_t5_int8.py)
T5_INT8_BYTES_MAX = 0.62
#: the int8 FLUX backbone against bf16, latents (tests/core/test_parallel_api.py:469)
BACKBONE_INT8_REL_MAX = 0.1
#: fp32 encoders on the card against the CPU's plain run (the north star's
#: fp32 bound, tests/io/test_backbone_parity.py)
ENCODER_F32_REL_MAX = 2e-4


def _cli(argv):
    from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs

    parser = FlexibleArgumentParser()
    xFuserArgs.add_cli_args(parser)
    return xFuserArgs.from_cli_args(parser.parse_args(argv))


def _nbytes_tree(tree):
    if isinstance(tree, dict):
        return sum(_nbytes_tree(t) for t in tree.values())
    return tree.numel() * tree.element_size()


def _events_s(fn):
    """(fn's result, its seconds by CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _cut(tree, n):
    """The first ``n`` layers of a tree's stacked block axis."""
    return {k: (v if k != "blocks" else {b: {p: t[:n] for p, t in w.items()} for b, w in v.items()})
            for k, v in tree.items()}


def _to_dev(tree, dev, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev, dtype) for k, v in tree.items()}
    return tree.to(dev, dtype if dtype is not None and tree.is_floating_point() else tree.dtype)


def prompt_phase(kernels, dev):
    """Phase 28: T5-XXL and CLIP-L at their published widths and depths, seeded
    bf16 weights on the card behind the byte tokenizers; FLUX's prompt batch
    at 512 tokens and PixArt's cond/uncond pair at 120; both encoders cut to
    2 layers in fp32 against the CPU's plain run of the same weights; the
    int8 T5 against the bf16 one at full depth."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models import prompt as mp
    from compactfusion_tpu_torch.models import text_encoders as te

    t0 = time.perf_counter()
    t5_cfg, clip_cfg = te.t5_xxl(), te.clip_l()
    t5 = te.init_t5(torch.Generator(device=dev).manual_seed(7), t5_cfg)
    clip = te.init_clip(torch.Generator(device=dev).manual_seed(8), clip_cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    enc = mp.PromptEncoder(mp._T5Bundle(mp.byte_unigram_tokenizer(), t5, t5_cfg),
                           mp._CLIPBundle(mp.byte_clip_tokenizer(), clip, clip_cfg))
    print(f"[28] T5-XXL ({t5_cfg.num_layers} layers, d_model {t5_cfg.d_model}, {t5_cfg.num_heads} heads of "
          f"{t5_cfg.d_kv}, d_ff {t5_cfg.d_ff}; {_numel(t5) / 1e9:.3f}B parameters, {_nbytes_tree(t5) / 2**30:.3f} "
          f"GiB bf16) and CLIP-L ({clip_cfg.num_layers} layers, d {clip_cfg.d_model}) drawn on the card in "
          f"{build_s:.2f} s")
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    flux_prompt, pixart_pair = [PROMPTS[0]], ([PROMPTS[0]], [""])
    for _ in range(2):  # warm-up
        enc.encode_for_flux(flux_prompt, max_length=FLUX_TXT)
        enc.encode_for_pixart(*pixart_pair, max_length=120)
    flux_ms = [1e3 * _events_s(lambda: enc.encode_for_flux(flux_prompt, max_length=FLUX_TXT))[1] for _ in range(5)]
    pixart_ms = [1e3 * _events_s(lambda: enc.encode_for_pixart(*pixart_pair, max_length=120))[1] for _ in range(5)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    txt, pooled = enc.encode_for_flux(flux_prompt, max_length=FLUX_TXT)
    ptxt, pmask = enc.encode_for_pixart(*pixart_pair, max_length=120)
    for what, t, shape in (("FLUX T5 states", txt, (1, FLUX_TXT, t5_cfg.d_model)),
                           ("FLUX pooled", pooled, (1, clip_cfg.d_model)),
                           ("PixArt cond/uncond", ptxt, (2, 1, 120, t5_cfg.d_model))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"[28] {what}: shape {tuple(t.shape)} (expected {shape}) or not finite")
    if any(_counts(kernels).values()):
        raise AssertionError("[28] the text encoders launched a port kernel: their products are plain torch")
    print(f"[28] FLUX prompt batch (B1, 512 tokens, T5-XXL + CLIP-L): {', '.join(f'{m:.3f}' for m in flux_ms)} ms; "
          f"PixArt cond/uncond pair (2 x B1, 120 tokens): {', '.join(f'{m:.3f}' for m in pixart_ms)} ms; "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB")

    # 2 layers at full width in fp32: the card against the CPU's plain run
    ids, mask = mp.byte_unigram_tokenizer()([PROMPTS[1]], max_length=120)
    cids = mp.byte_clip_tokenizer()([PROMPTS[1]])
    outs = {}
    cut_t5 = dataclasses.replace(t5_cfg, num_layers=2, dtype=torch.float32)
    cut_clip = dataclasses.replace(clip_cfg, num_layers=2, dtype=torch.float32)
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p5 = _to_dev(_cut(t5, 2), d, torch.float32)
        pc = _to_dev(_cut(clip, 2), d, torch.float32)
        with torch.inference_mode():
            outs[where] = (te.t5_encode(p5, torch.from_numpy(ids).long().to(d), cut_t5,
                                         mask=torch.from_numpy(mask).to(d)).cpu().numpy(),
                            te.clip_encode(pc, torch.from_numpy(cids).long().to(d), cut_clip)[1].cpu().numpy())
    t5_rel = _rel_np(outs["card"][0], outs["cpu"][0])
    clip_rel = _rel_np(outs["card"][1], outs["cpu"][1])
    print(f"[28] 2 layers at full width in fp32, card vs CPU: T5 states rel err {t5_rel:.3e}, CLIP pooled "
          f"{clip_rel:.3e} (bound {ENCODER_F32_REL_MAX})")
    if not (t5_rel <= ENCODER_F32_REL_MAX and clip_rel <= ENCODER_F32_REL_MAX):
        raise AssertionError("[28] the encoders on the card differ from the CPU's plain run")

    # --use_int8_t5_encoder: the int8 T5 against the bf16 one, full depth.
    # With init_t5's std-0.02 draws at d_model 4096 the unscaled attention
    # logits have a std of ~13: near-hard attention, where the int8 rounding
    # flips near-ties from layer to layer, so that comparison is reported,
    # not bounded.  The bound applies to the same draws at T5's own
    # initialisation scales (HF ``T5PreTrainedModel._init_weights``), which
    # keep the logits near unit std as trained weights do.
    def int8_vs_bf16(params):
        q = te.quantize_t5_int8(params)
        enc.t5.params = params
        full = enc.encode_t5([PROMPTS[1]], FLUX_TXT)[0]
        enc.t5.params = q
        torch.cuda.reset_peak_memory_stats()
        quant, q_s = _events_s(lambda: enc.encode_t5([PROMPTS[1]], FLUX_TXT)[0])
        return rel_fro(quant, full), q_s, _nbytes_tree(q), torch.cuda.max_memory_allocated() / 2**30

    raw_rel = int8_vs_bf16(t5)[0]
    d, h, dk, ff = t5_cfg.d_model, t5_cfg.num_heads, t5_cfg.d_kv, t5_cfg.d_ff
    stds = {"q": (d * dk) ** -0.5, "k": d ** -0.5, "v": d ** -0.5, "o": (h * dk) ** -0.5, "wi_0": d ** -0.5,
            "wi_1": d ** -0.5, "wo": ff ** -0.5}
    t5 = dict(t5, blocks={k: ({"w": (v["w"].float() * (stds[k] / 0.02)).to(v["w"].dtype)} if k in stds else v)
                          for k, v in t5["blocks"].items()})
    rel, q_s, q_bytes, q_peak = int8_vs_bf16(t5)
    b_bytes = _nbytes_tree(t5)
    enc.t5.params = t5
    print(f"[28] int8 T5-XXL vs bf16, full depth: states rel err {rel:.5f} at T5's initialisation scales (bounds "
          f"{T5_INT8_REL}), {raw_rel:.5f} on the std-0.02 draws (not bounded: near-hard attention); parameter "
          f"bytes {q_bytes / 2**30:.3f} GiB = {q_bytes / b_bytes:.4f} x bf16 (bound {T5_INT8_BYTES_MAX}); "
          f"{1e3 * q_s:.3f} ms; max_memory_allocated with both copies {q_peak:.3f} GiB")
    if not (T5_INT8_REL[0] < rel < T5_INT8_REL[1] and q_bytes < T5_INT8_BYTES_MAX * b_bytes):
        raise AssertionError("[28] the int8 T5 is outside its bounds")
    return {"t5 and clip-l": {
        "flux_prompt_ms": flux_ms, "pixart_pair_ms": pixart_ms, "max_memory_allocated_gib": peak,
        "t5_params": _numel(t5), "cut_fp32_rel_err_vs_cpu": {"t5": t5_rel, "clip_pooled": clip_rel},
        "int8_rel_err_vs_bf16": rel, "int8_rel_err_vs_bf16_std002": raw_rel, "int8_bytes_share": q_bytes / b_bytes,
        "launches": _counts(kernels)}}


def _request(runner):
    """One request of a runner: (latents, image), decoded as ``runner()`` does."""
    lat = runner(decode=False)
    return lat, runner.pipeline.decode(lat)


def runner_phase(kernels, pixart_launches, flux_launches, out_dir):
    """Phase 29: ``xDiTParallel`` from the README's argument lists,
    PixArt-alpha 512 and FLUX.1-dev 1024, from prompts; then FLUX.1-dev with
    ``--quantize_backbone_int8``.  Returns (phases, the PixArt runner with
    its launch request restored)."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel_api import xDiTParallel
    from compactfusion_tpu_torch.utils.image import read_png, to_uint8

    phases, keep = {}, {}
    for family, argv, size, launches in (("pixart", PIXART_ARGV, 512, pixart_launches),
                                         ("flux", FLUX_ARGV, FLUX_SIZE, flux_launches)):
        args = _cli(argv)
        if family == "flux":  # the FLUX example's guidance rule
            args.guidance_scale = 3.5 if args.guidance_scale == 4.5 else args.guidance_scale
        engine, inp = args.create_config()
        t0 = time.perf_counter()
        runner = xDiTParallel(engine, inp)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        warm_s = _events_s(runner.prepare_run)[1]  # (prepare_run returns the runner: keep no reference)
        torch.cuda.reset_peak_memory_stats()
        secs, lat0, total = [], None, None
        for i, prompt in enumerate(PROMPTS):
            runner.input_config = dataclasses.replace(inp, prompt=(prompt,), seed=i + 1)
            _reset_counters()
            (lat, img), sec = _events_s(lambda: _request(runner))
            ran = _counts(kernels)
            _check_counts(f"[29] {family} request {i + 1}", ran, {"flash_attn_with_lse": launches, WIDE: 1})
            check_image(img, f"[29] {family} request {i + 1}", size)
            lat0 = lat if lat0 is None else lat0
            total = ran if total is None else {k: total[k] + v for k, v in ran.items()}
            secs.append(sec)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runner.input_config = inp
        path = runner.save(out_dir, prefix=f"runner_{family}", out=img)
        with open(path, "rb") as f:
            back = read_png(f.read())
        if back.shape != tuple(img.shape[1:]) or not np.array_equal(back, to_uint8(img.float().cpu().numpy())[0]):
            raise AssertionError(f"[29] {family}: the PNG read back is not the image ({back.shape})")
        print(f"[29] {family} through xDiTParallel ({' '.join(argv[:2])}, guidance {inp.guidance_scale}): "
              f"built in {build_s:.2f} s, prepare_run {warm_s:.4f} s, s/image {', '.join(f'{s:.4f}' for s in secs)} "
              f"(CUDA events, prompt encoding included); kernel 1 {launches} launches an image (as phase "
              f"{3 if family == 'pixart' else 18}), 1 on the wide body; max_memory_allocated {peak:.3f} GiB; "
              f"PNG {path} read back, {back.shape}")
        phases[f"runner {family}"] = {"s_per_image": secs, "prepare_run_s": warm_s, "build_s": build_s,
                                      "max_memory_allocated_gib": peak, "launches": total}
        keep[family] = (runner, lat0)
    flux_lat = keep.pop("flux")[1]
    bf16_peak = phases["runner flux"]["max_memory_allocated_gib"]
    del runner, lat, img, lat0  # the bf16 FLUX runner leaves the card
    torch.cuda.empty_cache()

    args = _cli(FLUX_ARGV + ["--quantize_backbone_int8"])
    args.guidance_scale = 3.5
    engine, inp = args.create_config()
    runner = xDiTParallel(engine, inp)
    runner.input_config = dataclasses.replace(inp, prompt=(PROMPTS[0],), seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    lat, sec = _events_s(lambda: runner(decode=False))
    _check_counts("[29] flux int8", _counts(kernels), {"flash_attn_with_lse": flux_launches - 1, WIDE: 0})
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = rel_fro(lat, flux_lat)
    blocks = runner.pipeline.params["double_blocks"]["img_qkv"]
    print(f"[29] FLUX.1-dev --quantize_backbone_int8: latents rel err vs bf16 {rel:.5f} (bound "
          f"{BACKBONE_INT8_REL_MAX}, > 0); {sec:.4f} s for the latents; max_memory_allocated {peak:.3f} GiB "
          f"(bf16 {bf16_peak:.3f}); block weights {blocks['w_q'].dtype}")
    if not (0.0 < rel < BACKBONE_INT8_REL_MAX and peak < bf16_peak and blocks["w_q"].dtype == torch.int8):
        raise AssertionError("[29] the int8 FLUX backbone is outside its bounds or takes no less memory")
    phases["runner flux int8"] = {"s_latents": sec, "latent_rel_err_vs_bf16": rel,
                                  "max_memory_allocated_gib": peak, "launches": _counts(kernels)}
    del runner
    torch.cuda.empty_cache()
    return phases, keep["pixart"]


def service_phase(kernels, pixart_launches):
    """Phase 30: the HTTP service on PixArt-alpha 512 at serve_batch 2 on
    localhost: /health, then 4 concurrent /generate requests."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from compactfusion_tpu_torch.entrypoints.launch import Engine, make_handler
    from compactfusion_tpu_torch.utils.image import read_png

    engine = Engine(_cli(PIXART_ARGV), serve_batch=2)
    engine.batch_window_s = 0.5  # the 4 clients start together; packing must not hang on the thread start
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    try:
        health = call("/health")
        if health != (200, {"status": "ok"}):
            raise AssertionError(f"[30] /health answered {health}")
        _reset_counters()
        results, barrier = [None] * 4, threading.Barrier(4)
        t0 = time.perf_counter()

        def client(i):
            barrier.wait()
            t = time.perf_counter()
            code, body = call("/generate", {"prompt": PROMPTS[i % 2] + f" #{i}", "seed": 10 + i})
            results[i] = (code, body, time.perf_counter() - t)

        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        for i, (code, body, wall_i) in enumerate(results):
            if code != 200 or "latency_s" not in body:
                raise AssertionError(f"[30] request {i}: {code} {str(body)[:200]}")
            img = read_png(base64.b64decode(body["images"][0]))
            if img.shape != tuple(body["shape"][1:]) or body["shape"][1] != engine._base_input.height:
                raise AssertionError(f"[30] request {i}: PNG of shape {img.shape}")
        stats = dict(engine.stats)
        if stats["max_packed"] != 2:
            raise AssertionError(f"[30] no pipeline call packed 2 requests: {stats}")
        counts = _counts(kernels)
        _check_counts("[30] service", counts, {"flash_attn_with_lse": stats["batches"] * pixart_launches,
                                               WIDE: stats["batches"]})
        lat = [body["latency_s"] for _, body, _ in results]
        print(f"[30] HTTP service, PixArt-alpha 512, serve_batch 2: /health ok; 4 concurrent /generate in "
              f"{wall:.3f} s: {stats['batches']} pipeline calls (max packed {stats['max_packed']}), PNGs 512 x 512 "
              f"decoded; latency_s per request {lat}, client wall {[round(w, 4) for _, _, w in results]} s; "
              f"kernel 1 {counts['flash_attn_with_lse']} launches ({pixart_launches} a call)")
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    phase = {"latency_s": lat, "wall_s": wall, "batches": stats["batches"], "max_packed": stats["max_packed"],
             "s_per_image": [l / 2 for l in lat], "launches": counts}
    del engine
    torch.cuda.empty_cache()
    return {"service": phase}


def example_rank(rank, world, runs):
    """One rank of phase 31: the torchrun environment, then per run (name,
    argv) ``pixartalpha_example.main`` with every launch count set to 0 before
    it; returns the latents, the counts and the ring-shift bytes."""
    import torch

    from compactfusion_tpu_torch.examples import pixartalpha_example

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    # the runner draws the same seeded weights as the parent's reference;
    # both spice the AdaLN tables, or the zero gates hide the codec
    from compactfusion_tpu_torch.models import pixart as model_pixart

    init = model_pixart.init_pixart
    model_pixart.init_pixart = lambda generator, cfg: spice_pixart(init(generator, cfg))
    kernels = port_kernels()
    out = {}
    for name, argv in runs:
        _reset_counters()
        t0 = time.perf_counter()
        with pixart_depth(RUNNER_CUT):
            lat, saved = pixartalpha_example.main(argv)
        torch.cuda.synchronize()
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "wire_bytes": _counter("ring_shift.nbytes"), "saved": saved, "s": time.perf_counter() - t0}
    return out


def example_ring_phase(kernels, codecs, lossless_np):
    """Phase 31: ``pixartalpha_example.main`` as 2 gloo processes on the card at
    ``--ring_degree 2``, lossless and ``--compact --compact_type binary``,
    against the one-process runner's latents of the same request."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    ring = PIXART_ARGV + ["--ring_degree", "2", "--output_type", "latent"]
    runs = [("example ring2 lossless", ring), ("example ring2 binary", ring + ["--compact", "--compact_type", "binary"])]
    t0 = time.perf_counter()
    two = spawn_local(example_rank, 2, "gloo", runs, threads=2)
    spawn_s = time.perf_counter() - t0
    hops, comp = 2 * RUNNER_CUT, STEPS - WARMUP
    n, c = 2 * 1024 // 2, 1152  # CFG batch 2 x 512 tokens a rank, 16 heads of 72
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    images = 2  # the example's warm-up call and its generate call
    # --output_type latent: no VAE decode, so no wide-body launch
    expect = {"example ring2 lossless": ({"flash_attn_with_lse": images * hops * STEPS, WIDE: 0},
                                         images * RUNNER_CUT * STEPS * 2 * n * c * 2),
              "example ring2 binary": ({"flash_attn_with_lse": images * hops * STEPS, WIDE: 0,
                                        "binary_quant_fastpath": images * hops * comp,
                                        "binary_dequant_fastpath": images * hops * comp},
                                       images * RUNNER_CUT * (WARMUP * 2 * n * c * 4 + comp * 2 * payload))}
    phases = {}
    for name, _ in runs:
        want_counts, want_bytes = expect[name]
        want_counts = {**{key: want_counts.get(k, 0) for k, key in VEC.items()}, **want_counts}
        lat = two[0][name]["latents"]
        for r, res in enumerate(two):
            if not np.array_equal(res[name]["latents"], lat):
                raise AssertionError(f"[31] {name}: rank {r}'s latents differ from rank 0's")
            _check_counts(f"[31] {name} rank {r}", res[name]["launches"], want_counts)
            if res[name]["wire_bytes"] != want_bytes:
                raise AssertionError(f"[31] {name} rank {r}: ring-shift bytes {res[name]['wire_bytes']}, "
                                     f"expected {want_bytes}")
        rel = _rel_np(lat, lossless_np)
        bound, low = (HALVES_REL_MAX, None) if "lossless" in name else (COMPRESSED_REL_ERR_MAX, 0.0)
        if not (rel <= bound and (low is None or rel > low)):
            raise AssertionError(f"[31] {name}: latent rel err vs the one-process runner {rel} outside ({low}, {bound}]")
        if "binary" in name:  # the codec acts: the compressed ring moves off the lossless one
            vs_ring = _rel_np(lat, two[0]["example ring2 lossless"]["latents"])
            print(f"[31] {name}: rel err vs the lossless ring {vs_ring:.6g} (bound {COMPRESSED_REL_ERR_MAX}, > 0)")
            if not 0.0 < vs_ring <= COMPRESSED_REL_ERR_MAX:
                raise AssertionError(f"[31] {name}: rel err vs the lossless ring {vs_ring}")
        print(f"[31] {name} (pixartalpha_example.main in 2 gloo processes on one GPU): latents equal on both "
              f"ranks; rel err vs the one-process runner {rel:.6g} (bound {bound}" + (", > 0" if low is not None else "")
              + f"); ring-shift bytes per rank {want_bytes} as the shapes imply; main took "
              f"{', '.join(f'{res[name]['s']:.2f}' for res in two)} s (2 images, shared card); saved "
              f"{two[0][name]['saved']}")
        phases[name] = {"latent_rel_err_vs_runner": rel, "wire_bytes_per_rank": want_bytes,
                        "main_s": [res[name]["s"] for res in two],
                        "launches": {k: sum(res[name]["launches"][k] for res in two) for k in two[0][name]["launches"]}}
    print(f"[31] the spawn took {spawn_s:.1f} s")
    return phases


def run_entry_phases(kernels, dev, codecs, pixart_launches, flux_launches):
    """Phases 28-31; returns (the phases, the seconds of each)."""
    import tempfile

    import torch

    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    out_dir = tempfile.mkdtemp(prefix="cf_entry_")
    secs, t0 = {}, time.perf_counter()
    phases = prompt_phase(kernels, dev)
    torch.cuda.empty_cache()
    secs["28"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner_phases, (pixart_runner, _) = runner_phase(kernels, pixart_launches, flux_launches, out_dir)
    phases.update(runner_phases)
    del pixart_runner
    # the one-process reference of phase 31: the example's request (its
    # prompt, seed 42) on the runner's weights at RUNNER_CUT blocks with the
    # AdaLN tables spiced
    with pixart_depth(RUNNER_CUT):
        ref_runner = xDiTParallel(*_cli(PIXART_ARGV).create_config())
    spice_pixart(ref_runner.pipeline.params)
    ref = ref_runner(decode=False).float().cpu().numpy()
    del ref_runner
    torch.cuda.empty_cache()
    secs["29"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases.update(service_phase(kernels, pixart_launches))
    secs["30"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases.update(example_ring_phase(kernels, codecs, ref))
    secs["31"] = time.perf_counter() - t0
    print(f"[28-31] seconds: {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}")
    return phases, secs


# -- phases 32-34: CogVideoX-2b ----------------------------------------------

COG_HEADS, COG_HEAD_DIM, COG_DIM = 30, 64, 1920
#: T5 tokens (``--max_sequence_length 226``) and video tokens at 49 x 480 x 720
#: (13 latent frames x 30 x 45 patches)
COG_TXT, COG_VIDEO = 226, 13 * 30 * 45
COG_RING_LOCAL = COG_VIDEO // 2  # 8,775 video rows a rank at ring 2 or Ulysses 2
#: phase 33's request: the published command line at 10 of its 50 steps (the
#: script's time limit; s/step is what the phase measures)
COG_STEPS, COG_GUIDANCE = 10, 6.0
COG_ARGV = ["--model", "THUDM/CogVideoX-2b", "--height", "480", "--width", "720", "--num_frames", "49",
            "--num_inference_steps", str(COG_STEPS), "--guidance_scale", str(COG_GUIDANCE),
            "--max_sequence_length", str(COG_TXT), "--prompt", "a panda playing a guitar in a bamboo forest"]
#: phase 34's cut: 2 of the 30 blocks at full width, 4 steps,
#: the first 2 sent raw
COG_CUT, COG_RING_STEPS, COG_WARMUP = 2, 4, 2
#: phase 34's lossless runs vs one process, and fused vs unfused: only the
#: bf16 order differs, as under RING_REL_MAX, but this model's order floor
#: lies above that bound: one process with kernel 1 swapped for its plain
#: twin (the same function in another order) lands 0.0225 from the kernel's
#: run at 4 blocks and 6 steps of guidance 6, and the ring 2 runs 0.0232
#: and 0.0235 (PERF.md §6, PR 15); phase 34 measures that floor in every
#: run and holds each ring to this bound against both processes' runs
COG_RING_REL_MAX = 0.03
#: kernel 1's twin at the full sequence runs on (1 batch row, this many heads)
#: slices: the fp32 scores of the whole B2 H30 S17776 call would take 76 GB
COG_TWIN_HEADS = 2


def _sliced_twin(flash, heads, rows=None, ref=None):
    """Kernel 1's twin (or ``ref``, a twin of the same call form with its
    extra arguments) computed on (batch row, ``heads`` heads, ``rows``
    query rows; default all) slices of the inputs and put back together:
    the same function, the scores of one slice at a time."""
    import torch

    ref = ref or flash.flash_attn_with_lse_ref

    def twin(q, k, v, *args, **kw):
        outs, lses = [], []
        step = rows or q.shape[1]
        for b in range(q.shape[0]):
            parts = [[ref(q[b:b + 1, r:r + step, h:h + heads], k[b:b + 1, :, h:h + heads],
                          v[b:b + 1, :, h:h + heads], *args, **kw)
                      for r in range(0, q.shape[1], step)] for h in range(0, q.shape[2], heads)]
            outs.append(torch.cat([torch.cat([o for o, _ in hp], dim=1) for hp in parts], dim=2))
            lses.append(torch.cat([torch.cat([lse for _, lse in hp], dim=2) for hp in parts], dim=1))
        return torch.cat(outs), torch.cat(lses)

    return twin


def cog_flash_cases(gen, dev):
    """Kernel 1 at CogVideoX-2b's shapes (30 heads of 64, the register
    body's DP 64 plan): the self-attention over the 226 text + 17,550 video
    tokens (column slices of one qkv tensor), the same at Ulysses 2 (15
    heads; the queries hold each rank's text rows, 2 x 9,001, the keys the
    text once and the 17,550 video rows) and the two hops of the unfused
    ring 2 (hop 0 with the text in front of the local 8,775 rows' K/V), all
    at the CFG batch 2; the twin on head slices.  The fused ring's text
    block (Sk 226 < 512) takes the plain route, as the JAX routing rule
    sends it to XLA."""
    import torch

    h, d, s_q, s_all = COG_HEADS, COG_HEAD_DIM, COG_TXT + COG_RING_LOCAL, COG_TXT + COG_VIDEO

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def qkv(b, heads, sq, sk):
        return lambda: (rnd(b, sq, heads, d), rnd(b, sk, heads, d), rnd(b, sk, heads, d))

    return [
        (f"CogVideoX-2b self-attn B2 H{h} S{s_all} d{d}", lambda: _qkv_views(gen, dev, 2, s_all, h, d), 3,
         COG_TWIN_HEADS),
        (f"CogVideoX-2b Ulysses-2 B2 H{h // 2} Sq{2 * s_q} Sk{s_all} d{d}", qkv(2, h // 2, 2 * s_q, s_all), 3, 3),
        (f"CogVideoX-2b ring-2 hop 0 (text joint in front) B2 H{h} Sq{s_q} Sk{s_q} d{d}", qkv(2, h, s_q, s_q), 5,
         COG_TWIN_HEADS),
        (f"CogVideoX-2b ring-2 hop 1 B2 H{h} Sq{s_q} Sk{COG_RING_LOCAL} d{d}", qkv(2, h, s_q, COG_RING_LOCAL), 5,
         COG_TWIN_HEADS),
    ]


def cog_ring_cases(gen, dev):
    """Kernel 7 at CogVideoX-2b's fused ring 2, rank 0's view at B1: q (the
    226 text rows in front of the 8,775 local rows), its own K/V slices at
    hop 0, the other rank's contiguous block at hop 1 (B1: the twin's fp32
    scores of B2 would take 38 GB)."""
    import torch

    h, d = COG_HEADS, COG_HEAD_DIM

    def make():
        q = torch.randn((1, COG_TXT + COG_RING_LOCAL, h, d), generator=gen, device=dev).to(torch.bfloat16)
        _, k0, v0 = _qkv_views(gen, dev, 1, COG_RING_LOCAL, h, d)
        _, k1, v1 = _qkv_views(gen, dev, 1, COG_RING_LOCAL, h, d)
        return q, [(k0, v0), (k1.contiguous(), v1.contiguous())]

    return [((2, 1, COG_RING_LOCAL), make)]


def check_cog_kernels(flash, quant, codecs, rf, timing, dev, gen):
    """Phase 32: kernels 1, 2, 3, 5, 6, 7 and 8 (and 8's EF pass) against
    their twins at CogVideoX-2b's shapes; returns the rows by kernel."""
    import torch

    flash_rows = check_flash(flash, timing, dev, gen, cog_flash_cases(gen, dev), phase=32)
    for r in flash_rows:
        if r["plan"][:2] != ["flash_wgmma_tile", COG_HEAD_DIM]:
            raise AssertionError(f"{r['shape']}: plan {r['plan']}; the wgmma body at DP 64 expected")
    quant_rows = {"binary": [], "int2": []}
    for n in (COG_RING_LOCAL, 2 * COG_RING_LOCAL):  # a rank's rows at B1 and at the CFG batch 2
        for codec in ("binary", "int2"):
            row = check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32, (n, COG_DIM), phase=32)
            if [row["quant_plan_bytes_per_thread"], row["dequant_plan_bytes_per_thread"]] != \
                    [quant.QUANT_VEC_BYTES] * 2:
                raise AssertionError(f"{row['shape']}: not the vector plans")
            quant_rows[codec].append(row)
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, cog_ring_cases(gen, dev), phase=32)
    torch.cuda.empty_cache()
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 1, COG_RING_LOCAL, codec, -1, False,
                                     COG_HEADS, COG_HEAD_DIM, COG_TXT + COG_RING_LOCAL, phase=32)
                  for codec in ("binary", "int2")]
    torch.cuda.empty_cache()
    return {"flash": flash_rows, "quant": quant_rows, "ring": ring_rows, "cring": cring_rows}


def _cut_blocks(params, n):
    """The model with its stacked blocks cut to the first ``n`` (views)."""
    from compactfusion_tpu_torch.models import common as cm

    return {k: cm.layer_of(v, slice(0, n)) if k == "blocks" else v for k, v in params.items()}


def cog_txt(dev, seed, dtype=None):
    """(2, 1, 226, 4096) [cond, uncond] T5 states from ``seed``, as phase 34's
    requests take them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((2, 1, COG_TXT, 4096), generator=g, device=dev, dtype=torch.float32).to(
        dtype or torch.bfloat16)


def cog_pipeline_phase(kernels, dev):
    """Phase 33: CogVideoX-2b at full width and depth through ``xDiTParallel``
    (random weights, modulation biases spiced; T5-XXL at full size behind
    the byte tokenizer): a 2-step warm-up, then the published request at
    :data:`COG_STEPS` steps (guidance 6, 49 x 480 x 720, decode included)
    with kernel 1 exactly 30 x COG_STEPS times; the tiled decode of its latents; a 2-block fp32
    cut at 9 frames, one CFG forward on the card against the CPU's plain
    run.  Returns the phases."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models import prompt as mp
    from compactfusion_tpu_torch.models import text_encoders as te
    from compactfusion_tpu_torch.models.cogvideox import cogvideox_forward
    from compactfusion_tpu_torch.models import common as cm
    from compactfusion_tpu_torch.parallel_api import xDiTParallel
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    t0 = time.perf_counter()
    runner = xDiTParallel(*_cli(COG_ARGV).create_config())
    pipe, pcfg = runner.pipeline, runner.pipeline_config
    pipe.params = _spiced(pipe.params, np.random.default_rng(99))
    t5_cfg = te.t5_xxl()
    runner.prompt_encoder = mp.PromptEncoder(mp._T5Bundle(
        mp.byte_unigram_tokenizer(), te.init_t5(torch.Generator(device=dev).manual_seed(7), t5_cfg), t5_cfg))
    torch.cuda.synchronize()
    m = pcfg.model
    print(f"[33] CogVideoX-2b through xDiTParallel: {m.depth} blocks, dim {m.dim}, {m.heads} heads of "
          f"{m.head_dim}, {_numel(pipe.params) / 1e9:.3f}B parameters in bf16, the 3D VAE "
          f"({_numel(pipe.vae_params) / 1e6:.1f}M) and T5-XXL drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{pcfg.num_frames} x {pcfg.height} x {pcfg.width}: {pcfg.tokens} video + {COG_TXT} text tokens, "
          f"{pcfg.num_steps} steps, guidance {pcfg.guidance_scale}")
    if (pcfg.tokens, pcfg.num_steps, m.dim, m.depth) != (COG_VIDEO, COG_STEPS, COG_DIM, 30):
        raise AssertionError(f"phase 33: {pcfg}")
    warm = CogVideoXPipeline(pipe.params, pipe.vae_params, dataclasses.replace(pcfg, num_steps=2), dev)
    _, warm_s = _events_s(lambda: warm(runner.prompt_encoder.encode_for_video(list(runner.input_config.prompt),
                                                                              [""], COG_TXT),
                                       generator=torch.Generator(device=dev).manual_seed(1), decode=False))
    del warm
    # the request through the runner; the encoder and the decode timed inside it
    marks = {}

    def timed(name, fn):
        def call(*a, **kw):
            out, marks[name] = _events_s(lambda: fn(*a, **kw))
            return out
        return call

    held = {}

    def decode(lat, real=pipe.decode):
        # the request's latents kept; the decode's own peak above what is held
        held["latents"], held["base"] = lat, torch.cuda.memory_allocated()
        held["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, marks["decode"] = _events_s(lambda: real(lat))
        held["decode_peak"] = torch.cuda.max_memory_allocated() - held["base"]
        return out

    runner.prompt_encoder.encode_for_video = timed("encode", runner.prompt_encoder.encode_for_video)
    pipe.decode = decode
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    video, total = _events_s(runner)
    peak = max(held["peak"], torch.cuda.max_memory_allocated()) / 2**30
    counts = _counts(kernels)
    _check_counts("CogVideoX-2b request", counts, {"flash_attn_with_lse": m.depth * COG_STEPS,
                                                   WG["flash_attn_with_lse"]: m.depth * COG_STEPS})
    v32 = video.float()
    lo, hi, std = v32.min().item(), v32.max().item(), v32.std().item()
    if tuple(video.shape) != (1, 49, 480, 720, 3) or not bool(torch.isfinite(v32).all()) or lo < 0 or hi > 1 \
            or std == 0.0:
        raise AssertionError(f"CogVideoX-2b video {tuple(video.shape)} in [{lo}, {hi}], std {std}")
    sample_s = total - marks["encode"] - marks["decode"]
    print(f"[33] request: video (1, 49, 480, 720, 3) in [{lo:.4f}, {hi:.4f}], std {std:.4f}; {total:.4f} s/video "
          f"(CUDA events: T5-XXL {marks['encode']:.4f} s, {COG_STEPS} steps {sample_s:.4f} s = "
          f"{sample_s / COG_STEPS:.4f} s/step, dense 3D VAE decode {marks['decode']:.4f} s); warm-up (2 steps) "
          f"{warm_s:.4f} s; kernel 1 {counts['flash_attn_with_lse']} launches ({m.depth} x {COG_STEPS}); "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB")
    phases = {"cogvideox-2b": {"s_per_video": total, "s_per_step": sample_s / COG_STEPS, "encode_s": marks["encode"],
                               "decode_s": marks["decode"], "warmup_s": warm_s, "max_memory_allocated_gib": peak,
                               "launches": counts}}
    del v32
    # the tiled decode of the request's latents, against its dense decode
    lat, vcfg = held.pop("latents"), pcfg.vae
    dense_s, dense_peak, base = marks["decode"], held["decode_peak"] / 2**30, held["base"]
    dense = video
    tiled_pipe = CogVideoXPipeline(pipe.params, pipe.vae_params,
                                   dataclasses.replace(pcfg, vae=dataclasses.replace(vcfg, use_tiling=True)), dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    tiled, tiled_s = _events_s(lambda: tiled_pipe.decode(lat))
    tiled_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    _check_counts("tiled decode", _counts(kernels), {})
    t32 = tiled.float()
    if tuple(tiled.shape) != (1, 49, 480, 720, 3) or not bool(torch.isfinite(t32).all()) or t32.min() < 0 \
            or t32.max() > 1:
        raise AssertionError(f"tiled decode {tuple(tiled.shape)} not a finite video in [0, 1]")
    tiled_rel = rel_fro(tiled, dense)
    print(f"[33] 3D VAE decode of the request's latents: dense {dense_s:.4f} s (in the request), peak "
          f"{dense_peak:.3f} GiB above the {base / 2**30:.3f} GiB held; tiled ({vcfg.tile_latent_size}-latent "
          f"tiles, overlap "
          f"{vcfg.tile_overlap_factor}) {tiled_s:.4f} s, peak {tiled_peak:.3f} GiB; tiled vs dense rel err "
          f"{tiled_rel:.4f} (the tiles see less context: no bound)")
    phases["cogvideox-2b"].update(dense_decode_s=dense_s, dense_decode_peak_gib=dense_peak, tiled_decode_s=tiled_s,
                                  tiled_decode_peak_gib=tiled_peak, tiled_vs_dense_rel_err=tiled_rel)
    del video, dense, tiled, t32, tiled_pipe, lat
    # a 2-block fp32 cut at 9 frames (3 latent frames: 4,050 video tokens):
    # one CFG forward on the card against the CPU's plain run
    f32 = dataclasses.replace(m, depth=2, dtype=torch.float32)
    cut = _to_dev(_cut_blocks(pipe.params, 2), dev, torch.float32)
    f, hp, wp = 3, 30, 45
    pos = cm.sincos_pos_embed_2d(m.dim, f * hp, wp)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, f * hp * wp, m.token_in), generator=g, device=dev)
    txt = torch.randn((2, COG_TXT, m.text_dim), generator=g, device=dev)
    t = torch.full((2,), 999.0, device=dev)
    _reset_counters()
    with torch.inference_mode():
        gpu, _ = cogvideox_forward(cut, x, txt, t, f32, pos_embed=pos.to(dev))
        counts = _counts(kernels)
        cpu, _ = cogvideox_forward(_to_dev(cut, "cpu"), x.cpu(), txt.cpu(), t.cpu(), f32, pos_embed=pos)
    _check_counts("fp32 cut forward", counts, {"flash_attn_with_lse": 2, F32["flash_attn_with_lse"]: 2})
    rel = rel_fro(gpu.cpu(), cpu)
    print(f"[33] CogVideoX-2b cut to 2 blocks in fp32, one CFG forward at 9 x 480 x 720 ({f * hp * wp} video "
          f"tokens): card vs the CPU's plain run rel err {rel:.3e} (bound {ENCODER_F32_REL_MAX}); kernel 1 "
          f"{counts['flash_attn_with_lse']} fp32 launches")
    if not rel <= ENCODER_F32_REL_MAX:
        raise AssertionError(f"fp32 CogVideoX cut: card vs CPU {rel}")
    phases["cogvideox-2b fp32 cut"] = {"rel_err_vs_cpu": rel, "launches": counts}
    del runner, pipe, cut, gpu, cpu
    return phases


def cog_request(pipe, seed):
    """Phase 34's request: T5 states (:func:`cog_txt`) and the noise from
    ``seed``; returns (latents, seconds by CUDA events)."""
    import torch

    g = torch.Generator(device=pipe.device).manual_seed(seed)
    txt = cog_txt(pipe.device, seed)
    return _events_s(lambda: pipe(txt, generator=g, decode=False))


def build_cog_cut(dev, dtype=None):
    """Phase 34's model: CogVideoX-2b at full width, its first
    :data:`COG_CUT` blocks, random weights from seed 0, modulation biases
    spiced; with ``dtype`` (fp32) the same bf16 weights in that dtype."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.cogvideox import cogvideox_2b, init_cogvideox

    mcfg = dataclasses.replace(cogvideox_2b(), depth=COG_CUT)
    params = _spiced(init_cogvideox(torch.Generator(device=dev).manual_seed(0), mcfg), np.random.default_rng(99))
    if dtype is None:
        return mcfg, params
    return dataclasses.replace(mcfg, dtype=dtype), _to_dev(params, dev, dtype)


def cog_pipeline(mcfg, params, dev, mesh=None, **kw):
    """Phase 34's pipeline: 49 x 480 x 720, :data:`COG_RING_STEPS` steps, guidance 6, no VAE."""
    from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig

    cfg = CogVideoXPipelineConfig(model=mcfg, num_steps=COG_RING_STEPS, guidance_scale=COG_GUIDANCE, **kw)
    return CogVideoXPipeline(params, None, cfg, dev, mesh=mesh)


def cog_rank(rank, world, runs, dtype=None):
    """One rank of phase 34 (``spawn_local`` on this GPU, gloo): the cut
    model from its seeds (in ``dtype`` when given), then per run (name,
    ParallelConfig kwargs, CompactConfig codec or None, and optionally True:
    kernel 1 swapped for its plain twin) the request from seed 1 with every
    launch count set to 0 before it; returns per run what :func:`ring_rank`
    returns."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    mcfg, params = build_cog_cut(dev, dtype)
    out = {}
    for name, par, compact, *plain in runs:
        parallel = ParallelConfig(**par)
        kw = {} if compact is None else {"compact": CompactConfig(
            enabled=True, warmup_steps=COG_WARMUP, residual=1, error_feedback=True, fastpath=True,
            check_consistency=True, compress_type=CompressType(compact))}
        pipe = cog_pipeline(mcfg, params, dev, parallel=parallel, mesh=make_mesh(parallel), **kw)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        with plain_attention() if plain and plain[0] else contextlib.nullcontext():
            lat, sec = cog_request(pipe, 1)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "wire_bytes": _counter("ring_shift.nbytes"),
                     "all_to_all_bytes": _counter("Mesh.all_to_all.nbytes"),
                     "gather_bytes": _counter("Mesh.all_gather_tree.nbytes"),
                     "consistency_dev": compact_ring.max_consistency_dev, "skips": None, "s_per_image": sec}
    return out


def cog_ring_phase(kernels, dev, codecs):
    """Phase 34: CogVideoX-2b at full width and the whole 17,550 video
    tokens, cut to 2 blocks, :data:`COG_RING_STEPS` steps, as 2 processes on this card (gloo):
    ring 2 lossless, BINARY and INT2 (residual 1 + EF, warmup 2, the
    consistency check on), each unfused and fused (the compressed ones take
    the unfused route: 9,001 query rows a rank); Ulysses 2 lossless and
    BINARY; cfg 2.  Every run against one process running the same cut
    model, the fused runs against the unfused ones, with exact launch
    counts, EF caches equal across ranks and the bytes the shapes imply.
    Returns (the phases, the one-process latents)."""
    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    mcfg, params = build_cog_cut(dev)
    _reset_counters()
    pipe = cog_pipeline(mcfg, params, dev)
    lat, sec = cog_request(pipe, 1)
    L, S, W = COG_CUT, COG_RING_STEPS, COG_WARMUP
    _check_counts("CogVideoX cut, one process", _counts(kernels), {"flash_attn_with_lse": L * S})
    with cog_halves_apart():
        halves, halves_sec = cog_request(pipe, 1)
    with plain_attention():
        plain, plain_sec = cog_request(pipe, 1)
    del params, pipe
    torch.cuda.empty_cache()
    one, halves, plain = (x.float().cpu().numpy() for x in (lat, halves, plain))
    floor = _rel_np(plain, one)
    print(f"[34] CogVideoX-2b cut to {L} of 30 blocks (full width, {COG_VIDEO} video + {COG_TXT} text tokens, "
          f"{S} steps, guidance {COG_GUIDANCE}): one process, lossless, {sec:.4f} s; each CFG half's forward at "
          f"B1 (as a cfg-2 rank runs it): rel err vs the B2 run {_rel_np(halves, one):.6g}, {halves_sec:.4f} s; "
          f"kernel 1 swapped for its plain twin: rel err vs the kernel's run {floor:.6g}, {plain_sec:.4f} s")
    ring2, fused2, u2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}, {"ulysses_degree": 2}
    runs = [("cog ring2 lossless", ring2, None), ("cog ring2 lossless fused", fused2, None),
            ("cog ring2 binary", ring2, "binary"), ("cog ring2 binary fused", fused2, "binary"),
            ("cog ring2 int2", ring2, "int2"), ("cog ring2 int2 fused", fused2, "int2"),
            ("cog u2 lossless", u2, None), ("cog u2 binary", u2, "binary"),
            ("cog cfg2 lossless", {"cfg_degree": 2}, None)]
    two = spawn_local(cog_rank, 2, "gloo", runs, threads=2)
    hops, C = 2 * L, S - W
    no_vae = {WIDE: 0}
    expect = {
        "cog ring2 lossless": {"flash_attn_with_lse": hops * S},
        # the fused ring's text block (Sk 226) takes the plain route, not kernel 1
        "cog ring2 lossless fused": {"ring_flash_attn_with_lse": hops * S},
        "cog u2 lossless": {"flash_attn_with_lse": L * S},
        # ring 1 under Ulysses 2: each rank compresses its own K/V into its
        # own EF slot and attends the exact ones (the latents are U2 lossless's)
        "cog u2 binary": {"flash_attn_with_lse": L * S, "binary_quant_fastpath": 2 * L * C},
        "cog cfg2 lossless": {"flash_attn_with_lse": L * S},
    }
    for codec in ("binary", "int2"):
        expect[f"cog ring2 {codec}"] = {"flash_attn_with_lse": hops * S, f"{codec}_quant_fastpath": hops * C,
                                       f"{codec}_dequant_fastpath": hops * C}
        # the fused compressed ring needs a multiple of 8 query rows (the JAX
        # package's condition, compactfusion_tpu/compact/ring.py:209); with
        # the 226 text rows in front a rank holds 9,001: the unfused route
        expect[f"cog ring2 {codec} fused"] = expect[f"cog ring2 {codec}"]
    phases = {}
    for name, _, compact in runs:
        # cfg 2 runs each half at B1: bit-equal to the one process doing so
        refs = [("the CFG halves at B1", halves, 0.0)] if name == "cog cfg2 lossless" else []
        if name.endswith("fused"):
            refs.append((name[:-6], two[0][name[:-6]]["latents"], 0.0 if compact else COG_RING_REL_MAX))
        if compact is not None:
            phases[name] = ring_phase(34, two, name, one, dict(no_vae, **expect[name]), COMPRESSED_REL_ERR_MAX, refs,
                                      low=0.0 if "ring2" in name else None)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
        else:
            refs.append(("the plain twin's run", plain, COG_RING_REL_MAX))
            phases[name] = ring_phase(34, two, name, one, dict(no_vae, **expect[name]), COG_RING_REL_MAX, refs)
        phases[name]["latent_rel_err_order_floor"] = floor
    u2_same = _rel_np(two[0]["cog u2 binary"]["latents"], two[0]["cog u2 lossless"]["latents"])
    if u2_same != 0.0:
        raise AssertionError(f"cog u2 binary: {u2_same} from U2 lossless; a ring of 1 attends the exact K/V")
    # wire bytes per rank: the bf16 K/V of the CFG batch per layer and step
    # (lossless), the raw fp32 K/V in warmup then the payloads (compressed);
    # the same on both routes; Ulysses: every all-to-all of q, k, v and out
    n, c = 2 * COG_RING_LOCAL, COG_DIM
    for codec in ("binary", "int2"):
        payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType(codec)))
        want = L * (W * 2 * n * c * 4 + C * 2 * payload)
        got = [phases[f"cog ring2 {codec}" + f][ "wire_bytes_per_rank"] for f in ("", " fused")]
        print(f"[34] {codec}: ring-shift bytes per rank {got}, expected {want} (payload_nbytes {payload} per K "
              f"or V)")
        if got != [want, want]:
            raise AssertionError(f"phase 34: the {codec} rings sent other bytes than their payloads")
    lossless_bytes = L * S * 2 * n * c * 2
    if phases["cog ring2 lossless"]["wire_bytes_per_rank"] != lossless_bytes:
        raise AssertionError(f"phase 34: the lossless ring sent "
                             f"{phases['cog ring2 lossless']['wire_bytes_per_rank']} "
                             f"bytes, {lossless_bytes} expected")
    # Ulysses 2, per layer and step: q (the text rows in front of the local
    # rows), k, v and out in bf16 at the CFG batch, half of each sent
    want_a2a = L * S * (2 * (COG_TXT + COG_RING_LOCAL) + 2 * COG_RING_LOCAL) * 2 * c * 2 // 2
    a2a = [r[k]["all_to_all_bytes"] for r in two for k in ("cog u2 lossless", "cog u2 binary")]
    # cfg 2: each step's bf16 prediction of this rank's half, sent to the other
    want_cfg = S * COG_VIDEO * mcfg.token_out * 2
    cfg_bytes = [r["cog cfg2 lossless"]["wire_bytes"] for r in two]
    print(f"[34] EF caches across the ring: largest deviation "
          f"{max(phases[k]['consistency_dev'] for k, _, cc in runs if cc)}; lossless ring {lossless_bytes} bytes "
          f"per "
          f"rank; U2 all-to-all bytes per rank {sorted(set(a2a))}, expected {want_a2a}; cfg 2 exchange bytes per "
          f"rank {sorted(set(cfg_bytes))}, expected {want_cfg}; u2 binary vs u2 lossless {u2_same}")
    if any(b != want_a2a for b in a2a) or any(b != want_cfg for b in cfg_bytes):
        raise AssertionError("phase 34: the all-to-alls or the cfg exchange sent other bytes than the path implies")
    return phases, one


# -- phases 35-36: PipeFusion, TP and the VAE ranks ---------------------------

#: phase 35's PixArt command lines (through ``xDiTParallel``, from the prompt)
PP_ARGV = PIXART_ARGV + ["--pipefusion_parallel_degree", "2"]
#: the patch pipelines against sync PipeFusion: the stale K/V moves them off
#: it (> 1e-6), within the JAX package's bound
#: (tests/models/test_pixart.py::test_patch_pipelined_pipefusion)
PATCH_PP_REL = (1e-6, 0.3)
#: the VAE ranks' image against the one-process decode of the same latents
#: (tests/core/test_parallel_api.py::test_vae_parallel_size_through_api)
VAE_RANKS_ATOL, VAE_RANKS_MEAN = 2e-2, 2e-3
#: FLUX's sync PipeFusion against one process running the same padded model
PP_FLUX_REL_MAX = 1e-5
#: phase 36's patch pipeline: M = 4 patches after 1 sync step (FLUX needs
#: M >= 2 x pp); CogVideoX has no patch pipeline in the JAX package
FLUX_PATCH = 4


def patch_flash_cases(gen, dev):
    """Kernel 1 at the patch pipelines' shapes: PixArt's patch queries (M =
    2: 512 rows, M = 4: 256) against the whole 1,024-token K/V cache at the
    CFG batch 2; FLUX's (M = 4) the 512 text rows in front of a 1,024-row
    patch against the text and the 4,096-token cache (24 heads of 128)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def pixart(sq):
        def make():
            q, _, _ = _qkv_views(gen, dev, 2, sq)
            return q, rnd(2, 1024, 16, 72), rnd(2, 1024, 16, 72)
        return make

    fq, fk = FLUX_TXT + FLUX_IMG // FLUX_PATCH, FLUX_TXT + FLUX_IMG
    return [
        ("PixArt patch (M2) B2 H16 Sq512 Sk1024 d72", pixart(512), 20),
        ("PixArt patch (M4) B2 H16 Sq256 Sk1024 d72", pixart(256), 20),
        (f"FLUX patch (M4) B1 H24 Sq{fq} Sk{fk} d128",
         lambda: (rnd(1, fq, 24, 128), rnd(1, fk, 24, 128), rnd(1, fk, 24, 128)), 10),
    ]


def pp_runner_rank(rank, world, runs, plan_dir):
    """One rank of phase 35 (``spawn_local`` on this GPU, gloo): per run
    (name, argv, whether the consistency check is on) ``xDiTParallel`` from
    the command line (PixArt's AdaLN tables spiced, as phase 31's runner),
    built in ``plan_dir`` (where a DiTFastAttn run finds its cached plan),
    the request from its prompt with every launch count set to 0 before
    it: its latents (None on a VAE rank), then the image as the runner
    decodes it (rank 0's alone with VAE ranks, the VAE ranks decoding their
    bands).  A rank past the run's mesh and VAE tail only joins its groups.
    Returns per run the latents, the image, the counts, the largest EF
    deviation across the ring and the seconds."""
    import dataclasses

    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.models import pixart as model_pixart
    from compactfusion_tpu_torch.parallel import mesh as pmesh
    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    init = model_pixart.init_pixart
    model_pixart.init_pixart = lambda generator, cfg: spice_pixart(init(generator, cfg))
    kernels = port_kernels()
    out = {}
    for name, argv, check in runs:
        engine, inp = _cli(argv).create_config()
        par = engine.parallel_config
        if rank >= par.world_size + par.vae_parallel_size:
            pmesh.make_mesh(par)
            pmesh.make_vae_mesh(par)
            out[name] = None
            continue
        if check:
            engine = dataclasses.replace(engine, compact_config=dataclasses.replace(
                engine.compact_config, check_consistency=True))
        with pixart_depth(RUNNER_CUT), contextlib.chdir(plan_dir):
            runner = xDiTParallel(engine, inp)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        t0 = time.perf_counter()
        lat = runner(decode=False)
        if runner.tail:
            runner.pipeline.decode_band(len(inp.prompt))
            img = None
        else:
            img = runner.pipeline.decode(lat)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[name] = {"latents": None if lat is None else lat.float().cpu().numpy(),
                     "image": None if img is None else img.float().cpu().numpy(), "launches": _counts(kernels),
                     "consistency_dev": compact_ring.max_consistency_dev, "s": sec}
        del runner, lat, img
        torch.cuda.empty_cache()
    return out


def _rank_counts(phase, name, ranks, expect):
    """Every rank's counts against ``expect`` (a function of the rank, to
    {kernel: count}, the routes' counts as :func:`_with_routes` implies);
    returns the counts summed over the ranks."""
    for r, res in enumerate(ranks):
        _check_counts(f"[{phase}] {name} rank {r}", res["launches"], _with_routes(expect(r)))
    return {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]}


def pp_pixart_phase(kernels, flash, timing, dev, gen):
    """Phase 35: kernel 1 at PixArt's patch shapes, then PixArt-alpha 512 at
    full width and :data:`RUNNER_CUT` blocks through ``xDiTParallel`` from the prompt, in 4 gloo
    processes on this card: sync PipeFusion pp2 (``--num_pipeline_patch
    1``), the patch pipeline at pp2 with M = 2 (the default) and with M = 4
    after 2 warmup steps, TP 2, TP 2 with DiTFastAttn from a cached plan
    (phase 21's mixed plan on the cut's blocks, written as the runner's
    cache file first), pp2 x ring 2 BINARY (the consistency check on), and
    ring 2 with 2 VAE ranks; against the one-process runner's request (the
    DiTFastAttn run against one process running the same cached plan).
    Returns (the phases, kernel 1's rows)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from compactfusion_tpu_torch.cache.fast_attn import optimize_plan, save_plan
    from compactfusion_tpu_torch.config import FastAttnConfig
    from compactfusion_tpu_torch.parallel.mesh import spawn_local
    from compactfusion_tpu_torch.parallel_api import fast_attn_cache_path, xDiTParallel

    rows = check_flash(flash, timing, dev, gen, patch_flash_cases(gen, dev)[:2], phase=35)
    # the one-process reference: the same weights (spiced), prompt and seed
    t0 = time.perf_counter()
    with pixart_depth(RUNNER_CUT):
        runner = xDiTParallel(*_cli(PIXART_ARGV).create_config())
    spice_pixart(runner.pipeline.params)
    _reset_counters()
    one = runner(decode=False)
    _check_counts("[35] one process", _counts(kernels), {"flash_attn_with_lse": RUNNER_CUT * STEPS})
    pipe = runner.pipeline
    # the cached plan, and one process running it (the runner finds it in
    # the working directory, as a tp rank does below)
    fast = FastAttnConfig(use_fast_attn=True, use_cache=True, window_size=WINDOW)
    plan_dir = tempfile.mkdtemp()
    plan = mixed_plan()[:, :RUNNER_CUT]
    save_plan(plan, os.path.join(plan_dir, fast_attn_cache_path(PIXART_ARGV[1], STEPS, RUNNER_CUT, fast)))
    with contextlib.chdir(plan_dir):
        runner._apply_fast_attn(fast)
    if runner.pipeline_config.fast_attn_plan != tuple(map(tuple, plan.tolist())):
        raise AssertionError("[35] the one-process runner did not take the cached plan")
    plan_full, plan_window = plan_launches(optimize_plan(plan))
    _reset_counters()
    planned, plan_s = _events_s(lambda: runner(decode=False))
    planned_counts = _counts(kernels)
    # no decode here: the VAE's one full launch is not in the count
    _check_counts("[35] one process, cached plan", planned_counts,
                  {"flash_attn_with_lse": plan_full - 1, "flash_attn_window_with_lse": plan_window})
    del runner  # the prompt encoder leaves the card; the pipeline decodes below
    torch.cuda.empty_cache()
    one_np, planned_np = one.float().cpu().numpy(), planned.float().cpu().numpy()
    ref_s = time.perf_counter() - t0
    print(f"[35] one process with the cached plan ({plan_full - 1} full and {plan_window} window launches of "
          f"{RUNNER_CUT * STEPS} layer-steps): {plan_s:.4f} s; rel err vs no plan {_rel_np(planned_np, one_np):.6g}")
    phases = {"pixart one process cached plan": {"s": plan_s, "launches": planned_counts,
                                                 "latent_rel_err_vs_no_plan": _rel_np(planned_np, one_np)}}
    sync = PP_ARGV + ["--num_pipeline_patch", "1"]
    runs = [("pp2 sync", sync, False), ("pp2 patch M2", PP_ARGV, False),
            ("pp2 patch M4 warmup 2", PP_ARGV + ["--num_pipeline_patch", "4", "--warmup_steps", "2"], False),
            ("tp2", PIXART_ARGV + ["--tensor_parallel_degree", "2"], False),
            ("tp2 fast-attn cached plan", PIXART_ARGV + ["--tensor_parallel_degree", "2", "--use_fast_attn",
                                                         "--use_cache", "--window_size", str(WINDOW)], False),
            ("pp2 x ring2 binary", sync + ["--ring_degree", "2", "--compact", "--compact_type", "binary"], True),
            ("ring2 + 2 VAE ranks", PIXART_ARGV + ["--ring_degree", "2", "--vae_parallel_size", "2"], False)]
    t0 = time.perf_counter()
    four = spawn_local(pp_runner_rank, 4, "gloo", runs, plan_dir, threads=2)
    spawn_s = time.perf_counter() - t0
    shutil.rmtree(plan_dir)
    half, comp = RUNNER_CUT // 2, STEPS - WARMUP
    # kernel 1 a rank: its stage's RUNNER_CUT / 2 blocks a forward; the patch pipeline's
    # sync warmup steps and its priming step take the whole sequence, then
    # (steps - warmup) x M patches; each rank decodes its image (one wide launch)
    expect = {
        "pp2 sync": lambda r: {"flash_attn_with_lse": half * STEPS + 1},
        "pp2 patch M2": lambda r: {"flash_attn_with_lse": half * (1 + 2 * (STEPS - 1)) + 1},
        "pp2 patch M4 warmup 2": lambda r: {"flash_attn_with_lse": half * (2 + 4 * (STEPS - 2)) + 1},
        "tp2": lambda r: {"flash_attn_with_lse": RUNNER_CUT * STEPS + 1},
        # each tp rank's attention is whole: the plan's launches, and the decode's
        "tp2 fast-attn cached plan": lambda r: {"flash_attn_with_lse": plan_full,
                                                "flash_attn_window_with_lse": plan_window},
        "pp2 x ring2 binary": lambda r: {"flash_attn_with_lse": 2 * half * STEPS + 1,
                                         "binary_quant_fastpath": 2 * half * comp,
                                         "binary_dequant_fastpath": 2 * half * comp},
        # the DiT ranks decode nothing; each VAE rank's band runs the mid-block
        # attention on the gathered map once
        "ring2 + 2 VAE ranks": lambda r: ({"flash_attn_with_lse": 2 * RUNNER_CUT * STEPS, WIDE: 0} if r < 2
                                          else {"flash_attn_with_lse": 1}),
    }
    sync_np = None
    for name, argv, _ in runs:
        ranks = [res[name] for res in four if res[name] is not None]
        dit = [res for res in ranks if res["latents"] is not None]
        lat = dit[0]["latents"]
        for r, res in enumerate(dit):
            if not np.array_equal(res["latents"], lat):
                raise AssertionError(f"[35] {name}: rank {r}'s latents differ from rank 0's")
        launches = _rank_counts(35, name, ranks, expect[name])
        rel = _rel_np(lat, one_np)
        rep = {"latent_rel_err_vs_one_process": rel, "s": [res["s"] for res in ranks], "launches": launches,
               "launches_per_rank": [res["launches"] for res in ranks],
               "consistency_dev": max(res["consistency_dev"] for res in ranks)}
        line = f"[35] {name} ({len(ranks)} processes on one GPU, gloo): rel err vs one process {rel:.6g}"
        if name == "pp2 sync":
            sync_np = lat
            ok = rel <= HALVES_REL_MAX
            line += f" (bit-equal expected, bound {HALVES_REL_MAX})"
        elif name.startswith("pp2 patch"):
            rep["latent_rel_err_vs_sync"] = vs = _rel_np(lat, sync_np)
            ok = PATCH_PP_REL[0] < vs < PATCH_PP_REL[1] and np.isfinite(lat).all()
            line += f"; vs sync PipeFusion {vs:.6g} (bounds {PATCH_PP_REL})"
        elif name == "tp2":
            ok = rel <= HALVES_REL_MAX
            line += f" (bound {HALVES_REL_MAX})"
        elif name == "tp2 fast-attn cached plan":
            rep["latent_rel_err_vs_one_process_same_plan"] = vs = _rel_np(lat, planned_np)
            ok = vs <= HALVES_REL_MAX
            line += f"; vs one process with the same plan {vs:.6g} (bound {HALVES_REL_MAX})"
        elif "binary" in name:
            ok = 0.0 < rel <= COMPRESSED_REL_ERR_MAX and rep["consistency_dev"] == 0.0
            line += f" (bounds (0, {COMPRESSED_REL_ERR_MAX}]); EF deviation {rep['consistency_dev']}"
        else:
            img = dit[0]["image"]
            if any(res["image"] is not None for res in ranks[1:]):
                raise AssertionError(f"[35] {name}: a rank other than 0 holds an image")
            check_image(torch.from_numpy(img), f"[35] {name} rank 0")
            ref_img = pipe.decode(torch.from_numpy(lat).to(dev)).float().cpu().numpy()
            err = np.abs(img - ref_img)
            rep.update(image_max_abs_err=float(err.max()), image_mean_abs_err=float(err.mean()))
            ok = rel <= HALVES_REL_MAX and err.max() <= VAE_RANKS_ATOL and err.mean() < VAE_RANKS_MEAN
            line += (f" (bound {HALVES_REL_MAX}); rank 0's image vs the one-process decode of its latents: max abs "
                     f"{err.max():.3e} (bound {VAE_RANKS_ATOL}), mean {err.mean():.3e} (bound {VAE_RANKS_MEAN}); "
                     f"the other ranks hold none")
        print(line + f"; seconds a rank (runner build excluded) {', '.join(f'{res['s']:.2f}' for res in ranks)}; "
              f"launches per rank: {', '.join(f'{k} {v}' for k, v in ranks[0]['launches'].items() if v)}")
        if not ok:
            raise AssertionError(f"[35] {name}: outside its bounds")
        phases[f"pixart {name}"] = rep
    print(f"[35] one-process reference {ref_s:.1f} s; the spawn took {spawn_s:.1f} s")
    del pipe
    torch.cuda.empty_cache()
    return phases, rows


def stage_rank(rank, world, runs):
    """One rank of phase 36 (``spawn_local`` on this GPU, gloo): phase 19's
    FLUX.1-dev cut and phase 34's CogVideoX-2b cut from their seeds, then
    per run (name, family, ParallelConfig kwargs, pipeline-config kwargs)
    the request from seed 1 (FLUX decoded, CogVideoX not) with every launch
    count set to 0 before it; returns per run the latents, the counts and
    the seconds."""
    import torch

    from compactfusion_tpu_torch.config import ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    models = {"flux": build_flux(dev, *FLUX_CUT), "cogvideox": build_cog_cut(dev)}
    out = {}
    for name, family, par, kw in runs:
        parallel = ParallelConfig(**par)
        mesh = make_mesh(parallel)
        _reset_counters()
        if family == "flux":
            pipe = flux_pipeline(*models["flux"], dev, parallel=parallel, mesh=mesh, steps=RANK_STEPS, **kw)
            lat, img, sec = flux_request(pipe, 1)
            check_image(img, f"[36] {name} rank {rank}", FLUX_SIZE)
        else:
            pipe = cog_pipeline(*models["cogvideox"], dev, parallel=parallel, mesh=mesh, **kw)
            lat, sec = cog_request(pipe, 1)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels), "s": sec}
        del pipe
    return out


def pp_flux_cog_phase(kernels, flash, timing, dev, gen, flux_one, cog_one):
    """Phase 36: kernel 1 at FLUX's patch shape; then FLUX.1-dev at phase
    19's cut (1 + 2 blocks, padded to 2 + 2 under pp2) and CogVideoX-2b at
    phase 34's (2 blocks, :data:`COG_RING_STEPS` steps), full width, in 2 gloo processes on this
    card: FLUX sync pp2 against one process running the same padded model,
    the patch pipeline pp2 M = 4 against sync, TP 2; CogVideoX sync pp2 and
    TP 2 against phase 34's one process.  Returns (the phases, kernel 1's
    rows)."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.flux import pad_flux_for_pp
    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    rows = check_flash(flash, timing, dev, gen, patch_flash_cases(gen, dev)[2:], phase=36)
    mcfg, vcfg, params, vae_params = build_flux(dev, *FLUX_CUT)
    padded, pcfg = pad_flux_for_pp(params, mcfg, 2)
    _reset_counters()
    lat, img, sec = flux_request(flux_pipeline(pcfg, vcfg, padded, vae_params, dev, steps=RANK_STEPS), 1)
    check_image(img, "[36] FLUX padded, one process", FLUX_SIZE)
    pl = pcfg.double_layers + pcfg.single_layers
    _check_counts("[36] FLUX padded, one process", _counts(kernels), {"flash_attn_with_lse": pl * RANK_STEPS + 1,
                                                                       WIDE: 1})
    padded_np = lat.float().cpu().numpy()
    del params, padded, vae_params, lat, img
    torch.cuda.empty_cache()
    pad_vs = _rel_np(padded_np, flux_one)
    print(f"[36] FLUX.1-dev cut to {mcfg.double_layers} + {mcfg.single_layers} blocks, padded with zero blocks "
          f"to {pcfg.double_layers} + {pcfg.single_layers} for pp2: one process {sec:.4f} s/image, rel err vs "
          f"phase 19's unpadded run {pad_vs:.6g}")
    runs = [("flux pp2 sync", "flux", {"pp_degree": 2}, {}),
            ("flux pp2 patch M4", "flux", {"pp_degree": 2}, {"num_pipeline_patch": FLUX_PATCH}),
            ("flux tp2", "flux", {"tp_degree": 2}, {}),
            ("cog pp2 sync", "cogvideox", {"pp_degree": 2}, {}),
            ("cog tp2", "cogvideox", {"tp_degree": 2}, {})]
    t0 = time.perf_counter()
    two = spawn_local(stage_rank, 2, "gloo", runs, threads=2)
    spawn_s = time.perf_counter() - t0
    fl, L = pl // 2, COG_CUT  # a FLUX stage's layers (1 double + 1 single), CogVideoX's blocks
    expect = {"flux pp2 sync": {"flash_attn_with_lse": fl * RANK_STEPS + 1},
              # 1 sync step on the whole sequence, then RANK_STEPS - 1 steps x 4 patches
              "flux pp2 patch M4": {"flash_attn_with_lse": fl * (1 + FLUX_PATCH * (RANK_STEPS - 1)) + 1},
              "flux tp2": {"flash_attn_with_lse": (mcfg.double_layers + mcfg.single_layers) * RANK_STEPS + 1},
              "cog pp2 sync": {"flash_attn_with_lse": L // 2 * COG_RING_STEPS, WIDE: 0},
              "cog tp2": {"flash_attn_with_lse": L * COG_RING_STEPS, WIDE: 0}}
    phases = {}
    for name, family, _, _ in runs:
        ranks = [res[name] for res in two]
        lat = ranks[0]["latents"]
        if not all(np.array_equal(res["latents"], lat) for res in ranks):
            raise AssertionError(f"[36] {name}: the ranks' latents differ")
        launches = _rank_counts(36, name, ranks, lambda r: expect[name])
        ref, ref_name = (padded_np, "one process (padded)") if family == "flux" else (cog_one, "phase 34's one process")
        rel = _rel_np(lat, ref)
        rep = {f"latent_rel_err_vs_{ref_name}": rel, "s": [res["s"] for res in ranks], "launches": launches,
               "launches_per_rank": [res["launches"] for res in ranks]}
        if name == "flux pp2 sync":
            bound = (None, PP_FLUX_REL_MAX)
        elif name == "flux pp2 patch M4":
            rep["latent_rel_err_vs_sync"] = vs = _rel_np(lat, phases["flux pp2 sync"]["latents"])
            bound = PATCH_PP_REL
            rel = vs
        elif name == "flux tp2":
            bound = (None, RING_REL_MAX)
        else:
            bound = (None, COG_RING_REL_MAX)
        ok = (bound[0] is None or rel > bound[0]) and rel <= bound[1] and np.isfinite(lat).all()
        print(f"[36] {name} (2 processes on one GPU, gloo): latents equal on both ranks; rel err vs "
              f"{'sync PipeFusion' if 'patch' in name else ref_name} {rel:.6g} (bounds {bound}); s/request "
              f"{', '.join(f'{res['s']:.3f}' for res in ranks)}; launches per rank: "
              f"{', '.join(f'{k} {v}' for k, v in ranks[0]['launches'].items() if v)}")
        if not ok:
            raise AssertionError(f"[36] {name}: outside its bounds")
        phases[name] = dict(rep, latents=lat)
    for rep in phases.values():
        rep.pop("latents")
    print(f"[36] the spawn took {spawn_s:.1f} s")
    return phases, rows


# -- phases 37-42: SD3-medium, HunyuanDiT v1.2, PixArt-Sigma, the tiled VAE ----

#: SD3-medium at 1024 x 1024: 4,096 image tokens; the text rows are the 77
#: CLIP rows and the runner's --max_sequence_length (120) T5 rows
SD3_IMG, SD3_TXT, SD3_HEADS, SD3_HEAD_DIM, SD3_DIM = 4096, 77 + 120, 24, 64, 1536
SD3_STEPS, SD3_GUIDANCE = 28, 7.0
#: HunyuanDiT v1.2 at 1024 x 1024: 16 heads of 88 (the register body at DP 96)
HY_IMG, HY_HEADS, HY_HEAD_DIM, HY_DIM = 4096, 16, 88, 1408
HY_STEPS, HY_GUIDANCE = 25, 5.0
#: PixArt-Sigma 2K: 128 x 128 patches; its VAE's dense mid-attention holds
#: 256 x 256 latent pixels
SIGMA_2K_IMG, VAE_2K_ROWS = 16384, 65536
PROMPT = "a tiny astronaut hatching from an egg on the moon"
SD3_ARGV = ["--model", "stabilityai/stable-diffusion-3-medium", "--height", "1024", "--width", "1024",
            "--num_inference_steps", str(SD3_STEPS), "--guidance_scale", str(SD3_GUIDANCE), "--prompt", PROMPT]
HY_ARGV = ["--model", "Tencent-Hunyuan/HunyuanDiT-v1.2", "--height", "1024", "--width", "1024",
           "--num_inference_steps", str(HY_STEPS), "--guidance_scale", str(HY_GUIDANCE), "--prompt", PROMPT]
SIGMA_ARGV = ["--model", "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS", "--height", "1024", "--width", "1024",
              "--num_inference_steps", str(STEPS), "--prompt", PROMPT]
SIGMA_2K_ARGV = ["--model", "PixArt-alpha/PixArt-Sigma-XL-2-2K-MS", "--height", "2048", "--width", "2048",
                 "--num_inference_steps", str(STEPS), "--enable_tiling", "--prompt", PROMPT]
#: the tiled decode against the dense one: the tiles lose the mid-attention's
#: context across them, within the JAX tests' bound
#: (tests/core/test_vae_tiling.py::test_tiled_decode_shape_and_seam_error)
TILED_REL_MAX = 0.5
#: the sliced decode (B1 a call) against the dense B2 one on the card: each
#: image of the sliced decode is its own B1 dense decode bit for bit, but
#: cuBLAS, cuDNN and the reductions pick their kernels by shape, so B1 and
#: B2 sum in other orders; held as the other bf16 order effects are
#: (RING_REL_MAX).  Bit-equal on the CPU (tests/test_torch_vae_tiling.py)
SLICED_REL_MAX = RING_REL_MAX
#: phase 42's cut: SD3's first 2 blocks, HunyuanDiT's first 2 down and 2 up
#: blocks (under pp2 each stage holds 1 + 1, the skip channel crosses), at
#: full width, 6 steps, the first 2 sent raw
IMG_CUT = {"sd3": 2, "hunyuandit": 4}
IMG_CUT_STEPS, IMG_CUT_WARMUP = 6, 2
#: the patch pipelines of phase 42: SD3's M = 2 (M >= pp), HunyuanDiT's
#: M = 4 (its down/up virtual pipeline needs M >= 2 x pp)
IMG_PATCH = {"sd3": 2, "hunyuandit": 4}
#: phase 42's lossless runs against one process: at the bf16 order floor,
#: measured in the same run (one process with kernel 1 swapped for its
#: plain twin), this many times over, and never tighter than RING_REL_MAX
ORDER_FLOOR_FACTOR = 1.5


def image_flash_cases(gen, dev):
    """Kernel 1 at the three families' shapes (bf16, the CFG batch 2):
    SD3-medium's joint self-attention (the 197 text rows in front of the
    4,096 image rows, 24 heads of 64), its Ulysses-2, ring-2 and patch
    (M = 2) shapes; HunyuanDiT's (16 heads of 88: DP 96), likewise; PixArt-
    Sigma's at 1024 (4,096 tokens) and 2K (16,384); the twin on head
    slices where the whole call's scores would not fit."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def qkv(b, heads, sq, sk, d):
        return lambda: (rnd(b, sq, heads, d), rnd(b, sk, heads, d), rnd(b, sk, heads, d))

    h, d, s_all, s_loc = SD3_HEADS, SD3_HEAD_DIM, SD3_TXT + SD3_IMG, SD3_TXT + SD3_IMG // 2
    hh, hd = HY_HEADS, HY_HEAD_DIM
    return [
        (f"SD3 joint self-attn B2 H{h} S{s_all} d{d}", lambda: _qkv_views(gen, dev, 2, s_all, h, d), 10, 6),
        (f"SD3 Ulysses-2 B2 H{h // 2} Sq{2 * s_loc} Sk{s_all} d{d}", qkv(2, h // 2, 2 * s_loc, s_all, d), 10, 6),
        (f"SD3 ring-2 hop 0 (text joint in front) B2 H{h} Sq{s_loc} Sk{s_loc} d{d}", qkv(2, h, s_loc, s_loc, d), 10, 6),
        (f"SD3 ring-2 hop 1 B2 H{h} Sq{s_loc} Sk{SD3_IMG // 2} d{d}", qkv(2, h, s_loc, SD3_IMG // 2, d), 10, 6),
        (f"SD3 patch (M2) B2 H{h} Sq{s_loc} Sk{s_all} d{d}", qkv(2, h, s_loc, s_all, d), 10, 6),
        (f"HunyuanDiT self-attn B2 H{hh} S{HY_IMG} d{hd}", lambda: _qkv_views(gen, dev, 2, HY_IMG, hh, hd), 10, 4),
        (f"HunyuanDiT Ulysses-2 B2 H{hh // 2} S{HY_IMG} d{hd}", qkv(2, hh // 2, HY_IMG, HY_IMG, hd), 10, 4),
        (f"HunyuanDiT ring-2 hop B2 H{hh} Sq{HY_IMG // 2} Sk{HY_IMG // 2} d{hd}",
         qkv(2, hh, HY_IMG // 2, HY_IMG // 2, hd), 10, 4),
        (f"HunyuanDiT patch (M4) B2 H{hh} Sq{HY_IMG // 4} Sk{HY_IMG} d{hd}", qkv(2, hh, HY_IMG // 4, HY_IMG, hd), 10,
         4),
        ("PixArt-Sigma 1024 self-attn B2 H16 S4096 d72", lambda: _qkv_views(gen, dev, 2, 4096), 10, 4),
        (f"PixArt-Sigma 2K self-attn B2 H16 S{SIGMA_2K_IMG} d72", lambda: _qkv_views(gen, dev, 2, SIGMA_2K_IMG), 3, 1),
        (f"2K VAE dense mid-attn B1 H1 S{VAE_2K_ROWS} d512",
         lambda: tuple(rnd(1, VAE_2K_ROWS, 1, 512) for _ in range(3)), 1, (1, 4096)),
    ]


def image_ring_cases(gen, dev):
    """Kernel 7 at HunyuanDiT's fused ring 2 (2,048 image rows a rank, 16
    heads of 88) and PixArt-Sigma 1024's, rank 0's view at the CFG batch 2."""
    def make(s_local, h, d):
        shards = [_qkv_views(gen, dev, 2, s_local, h, d) for _ in range(2)]
        return shards[0][0], [(shards[0][1], shards[0][2]), (shards[1][1].contiguous(), shards[1][2].contiguous())]

    return [((2, 2, HY_IMG // 2), lambda: make(HY_IMG // 2, HY_HEADS, HY_HEAD_DIM)),
            ((2, 2, 2048), lambda: make(2048, 16, 72))]


def check_image_kernels(flash, quant, codecs, rf, timing, dev, gen):
    """Phase 37: kernels 1, 2, 3, 4, 5, 6, 7 and 8 (and 8's EF pass)
    against their twins at SD3-medium's, HunyuanDiT v1.2's and
    PixArt-Sigma's shapes and the 2K VAE's dense mid-attention (65,536 rows
    of d = 512, one wide-body launch); a head dim of 88 must take the
    register body at DP 96, whose instantiations must not spill.  Returns
    the rows by kernel."""
    import torch

    flash_rows = check_flash(flash, timing, dev, gen, image_flash_cases(gen, dev), phase=37)
    for r in flash_rows:
        if "d88" in r["shape"]:
            said = r["ptxas"] or ""
            if r["plan"][:2] != ["flash_wgmma_tile", 96] or "0 bytes spill stores" not in said:
                raise AssertionError(f"{r['shape']}: plan {r['plan']}, ptxas {said}; DP 96 without spills expected")
    torch.cuda.empty_cache()
    window_rows, _ = check_window(flash, dev, gen, [
        (f"PixArt-Sigma 2K B2 H16 S{SIGMA_2K_IMG} d72 w{WINDOW}", lambda: _qkv_views(gen, dev, 2, SIGMA_2K_IMG),
         WINDOW, 2)], timing, phase=37)
    quant_rows = {"binary": [], "int2": []}
    for n, c in ((SD3_IMG, SD3_DIM), (HY_IMG, HY_DIM)):  # a ring-2 rank's image rows at the CFG batch 2
        for codec in ("binary", "int2"):
            row = check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32, (n, c), phase=37)
            if [row["quant_plan_bytes_per_thread"], row["dequant_plan_bytes_per_thread"]] != \
                    [quant.QUANT_VEC_BYTES] * 2:
                raise AssertionError(f"{row['shape']}: not the vector plans")
            quant_rows[codec].append(row)
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, image_ring_cases(gen, dev), phase=37)
    for r in ring_rows:
        if "d88" in r["shape"] and r["plan"][:2] != ["flash_wgmma_tile", 96]:
            raise AssertionError(f"{r['shape']}: plan {r['plan']}; the wgmma body at DP 96 expected")
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 2, HY_IMG // 2, codec, -1, False, HY_HEADS,
                                     HY_HEAD_DIM, phase=37) for codec in ("binary", "int2")]
    cring_rows.append(check_compact_ring(rf, flash, timing, dev, gen, 2, 2, 2048, "binary", -1, False, phase=37))
    torch.cuda.empty_cache()
    return {"flash": flash_rows, "window": window_rows, "quant": quant_rows, "ring": ring_rows,
            "cring": cring_rows}


def vae_flash_tiles(h, w, vcfg):
    """The tiles of a tiled decode of h x w latents whose mid-attention
    takes kernel 1: those of at least 512 latent pixels (``ops/attention.
    py``'s rule; a smaller edge tile takes the plain route)."""
    tl = vcfg.tile_latent_size
    stride = int(tl * (1 - vcfg.tile_overlap_factor))
    return sum(min(tl, h - i) * min(tl, w - j) >= 512 for i in range(0, h, stride) for j in range(0, w, stride))


def vae_phase(kernels, dev):
    """Phase 38: the 2D VAE's decode memory knobs on random weights and
    latents (B2) at SD3's and FLUX.1's 1024 px latents (128 x 128 x 16) and
    PixArt-Sigma 2K's (256 x 256 x 4, the SDXL VAE): each image of the
    sliced decode bit-equal to the dense decode of that image alone, and
    within SLICED_REL_MAX of the dense B2 decode; the tiled decode within
    TILED_REL_MAX of it (and not equal: the tiles see less); each one's
    seconds by CUDA events and peak memory above the latents; kernel 1's
    wide-body launches one per decode call (the dense B2 mid-attention,
    each slice, each tile of 512 latent pixels or more).  Returns the
    phases."""
    import dataclasses

    import torch

    from compactfusion_tpu_torch.models import vae as mvae

    sdxl = dataclasses.replace(mvae.sd_vae(), scaling_factor=0.13025)
    phases = {}
    for name, vcfg, hw in (("SD3 1024", mvae.sd3_vae(), 128), ("FLUX.1 1024", mvae.flux_vae(), 128),
                           ("PixArt-Sigma 2K", sdxl, 256)):
        params = mvae.init_vae_decoder(torch.Generator(device=dev).manual_seed(11), vcfg)
        g = torch.Generator(device=dev).manual_seed(3)
        lat = torch.randn((2, hw, hw, vcfg.latent_channels), generator=g, device=dev) * 0.8
        tiles = vae_flash_tiles(hw, hw, vcfg)
        rep, outs = {}, {}
        for mode, kw, wide in (("dense", {}, 1), ("sliced", {"use_slicing": True}, 2),
                               ("tiled", {"use_tiling": True}, tiles)):
            cfg = dataclasses.replace(vcfg, **kw)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            with torch.inference_mode():
                img, sec = _events_s(lambda: mvae.vae_decode(params, lat, cfg))
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            _check_counts(f"[38] {name} {mode}", _counts(kernels), {"flash_attn_with_lse": wide, WIDE: wide})
            f = img.float()
            if tuple(img.shape) != (2, 8 * hw, 8 * hw, 3) or not bool(torch.isfinite(f).all()):
                raise AssertionError(f"[38] {name} {mode}: image {tuple(img.shape)} not finite")
            outs[mode] = img
            rep[mode] = {"s": sec, "peak_gib": peak, "wide_launches": wide}
        with torch.inference_mode():
            alone = mvae.vae_decode(params, lat[:1], vcfg)
        sliced_equal = torch.equal(outs["sliced"][:1], alone)
        sliced_rel = rel_fro(outs["sliced"], outs["dense"])
        tiled_rel = rel_fro(outs["tiled"], outs["dense"])
        print(f"[38] {name} VAE decode, B2 x {hw} x {hw} x {vcfg.latent_channels} latents -> {8 * hw} px: dense "
              f"{rep['dense']['s']:.4f} s, peak {rep['dense']['peak_gib']:.3f} GiB (the mid-attention B2 S{hw * hw} "
              f"d512 in one wide-body launch); sliced {rep['sliced']['s']:.4f} s, peak {rep['sliced']['peak_gib']:.3f} "
              f"GiB, image 0 bit-equal to its decode alone: {sliced_equal}, rel err vs the B2 decode {sliced_rel:.3e} "
              f"(bound {SLICED_REL_MAX}); tiled ({tiles} tiles on kernel 1 of {vcfg.tile_latent_size} latent px an "
              f"image) {rep['tiled']['s']:.4f} s, peak {rep['tiled']['peak_gib']:.3f} GiB, rel err vs dense "
              f"{tiled_rel:.4f} (bound (0, {TILED_REL_MAX}))")
        if not sliced_equal or not sliced_rel <= SLICED_REL_MAX or not 0.0 < tiled_rel < TILED_REL_MAX:
            raise AssertionError(f"[38] {name}: sliced equal {sliced_equal}, rel err {sliced_rel}, tiled rel err "
                                 f"{tiled_rel}")
        phases[f"vae {name}"] = dict(rep, sliced_rel_err_vs_dense=sliced_rel, tiled_rel_err_vs_dense=tiled_rel,
                                     launches=_counts(kernels))
        del params, lat, outs, img, f, alone
        torch.cuda.empty_cache()
    return phases


def _valid_image(img, what, size):
    """A finite (1, size, size, 3) image in [0, 1] that is not constant;
    returns (min, max, std)."""
    import torch

    f = img.float()
    lo, hi, std = f.min().item(), f.max().item(), f.std().item()
    if tuple(img.shape) != (1, size, size, 3) or not bool(torch.isfinite(f).all()) or lo < 0 or hi > 1 \
            or std == 0.0:
        raise AssertionError(f"{what}: image {tuple(img.shape)} in [{lo}, {hi}], std {std}")
    return lo, hi, std


def runner_request(kernels, runner, what, expect, size=1024):
    """One request of a runner from its prompt, every count set to 0 before
    it: (latents, image, seconds by CUDA events, peak memory in GiB, the
    counts, the image's (min, max, std)), the counts held to ``expect`` and
    the image to :func:`_valid_image`."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    (lat, img), sec = _events_s(lambda: _request(runner))
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _counts(kernels)
    _check_counts(what, counts, expect)
    return lat, img, sec, peak, counts, _valid_image(img, what, size)


#: the fp32 cuts' patch grid (phases 39-40): 32 x 32 patches of 2 latent
#: pixels, 512 px
F32_CUT_GRID = 32


def f32_cut_forward(family, params, mcfg, dev, kernels):
    """A 2-block (SD3) or 2 + 2-block (HunyuanDiT) cut of the full-width
    model in fp32: one CFG forward (B2, 512 px, as
    phase 33's cut runs 9 of 49 frames: the CPU's run of 1024 px took ~13 s a
    family; text from a seed) on the card against the CPU's plain run;
    returns (rel err, the card's counts)."""
    import dataclasses

    import torch

    from compactfusion_tpu_torch.models import common as cm

    g = torch.Generator(device=dev).manual_seed(5)
    t = torch.full((2,), 999.0, device=dev)
    n = IMG_CUT[family]
    if family == "sd3":
        from compactfusion_tpu_torch.models.sd3 import sd3_forward

        m = dataclasses.replace(mcfg, depth=n, dtype=torch.float32)
        cut = _to_dev(_cut_blocks(params, n), dev, torch.float32)
        x = torch.randn((2, F32_CUT_GRID ** 2, m.patch ** 2 * m.in_channels), generator=g, device=dev)
        txt = torch.randn((2, SD3_TXT, m.text_dim), generator=g, device=dev)
        pooled = torch.randn((2, m.pooled_dim), generator=g, device=dev)
        pos = cm.cropped_pos_embed_2d(m.dim, F32_CUT_GRID, F32_CUT_GRID, m.pos_embed_max_size, m.base_size)

        def run(p, d):
            return sd3_forward(p, x.to(d), txt.to(d), pooled.to(d), t.to(d), m, pos_embed=pos.to(d))[0]
    else:
        from compactfusion_tpu_torch.models.hunyuandit import hunyuandit_forward, hunyuandit_positions

        m = dataclasses.replace(mcfg, depth=n, dtype=torch.float32)
        cut = _to_dev({k: cm.layer_of(v, slice(0, n // 2)) if k in ("down_blocks", "up_blocks") else v
                       for k, v in params.items()}, dev, torch.float32)
        x = torch.randn((2, F32_CUT_GRID ** 2, m.patch ** 2 * m.in_channels), generator=g, device=dev)
        text = torch.randn((2, 120, m.text_dim), generator=g, device=dev)
        mask = torch.ones((2, 120), dtype=torch.bool, device=dev)
        mask[1, 9:] = False  # a padded uncond prompt
        rope = cm.rope_frequencies(hunyuandit_positions(F32_CUT_GRID, F32_CUT_GRID), m.rope_axes)

        def run(p, d):
            return hunyuandit_forward(p, x.to(d), t.to(d), text.to(d), m, rope=tuple(r.to(d) for r in rope),
                                      text_mask=mask.to(d))[0]
    _reset_counters()
    with torch.inference_mode():
        gpu = run(cut, dev)
        counts = _counts(kernels)
        cpu = run(_to_dev(cut, "cpu"), "cpu")
    return rel_fro(gpu.cpu(), cpu), counts


def family_runner_phase(kernels, dev, family):
    """Phase 39 (SD3-medium) or 40 (HunyuanDiT v1.2): the model at full width
    and depth through ``xDiTParallel`` from the published command line
    (1024 x 1024; 28 steps, guidance 7 / 25 steps, guidance 5), random
    weights with spiced modulation biases and the runner's prompt encoder:
    a warm-up request, then the request: a valid image, kernel 1 exactly
    depth x steps times (the CFG batch in one launch a layer) and once on
    the wide body (the VAE), s/image by CUDA events, peak memory; then the
    fp32 cut's CFG forward on the card against the CPU.  Returns the
    phases."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    phase, argv, steps = (39, SD3_ARGV, SD3_STEPS) if family == "sd3" else (40, HY_ARGV, HY_STEPS)
    t0 = time.perf_counter()
    runner = xDiTParallel(*_cli(argv).create_config())
    runner.pipeline.params = _spiced(runner.pipeline.params, np.random.default_rng(99))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pipe, pcfg = runner.pipeline, runner.pipeline_config
    m = pcfg.model
    expect = {"flash_attn_with_lse": m.depth * steps + 1, WIDE: 1}
    _, warm_s = _events_s(lambda: _request(runner))
    lat, img, sec, peak, counts, (lo, hi, std) = runner_request(kernels, runner, f"[{phase}] {family}", expect)
    print(f"[{phase}] {family} through xDiTParallel ({' '.join(argv[:2])}): {m.depth} blocks, dim {m.dim}, "
          f"{m.heads} heads of {m.head_dim}, {_numel(pipe.params) / 1e9:.3f}B parameters in bf16, built in "
          f"{build_s:.2f} s; {pcfg.num_steps} steps, guidance {pcfg.guidance_scale}, {pcfg.tokens} image tokens; "
          f"image (1, 1024, 1024, 3) in [{lo:.4f}, {hi:.4f}], std {std:.4f}; {sec:.4f} s/image (CUDA events, the "
          f"prompt encoding and the decode included; warm-up {warm_s:.4f} s); kernel 1 "
          f"{counts['flash_attn_with_lse']} launches ({m.depth} x {steps} + the VAE's); "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB")
    phases = {f"{family} 1024": {"s_per_image": sec, "warmup_s": warm_s, "build_s": build_s,
                                 "max_memory_allocated_gib": peak, "launches": counts}}
    rel, counts = f32_cut_forward(family, pipe.params, m, dev, kernels)
    n = IMG_CUT[family]
    _check_counts(f"[{phase}] fp32 cut", counts, {"flash_attn_with_lse": n, F32["flash_attn_with_lse"]: n})
    print(f"[{phase}] {family} cut to {n} blocks in fp32, one CFG forward at {F32_CUT_GRID * 16} px: card vs the CPU's plain run "
          f"rel err {rel:.3e} (bound {ENCODER_F32_REL_MAX}); kernel 1 {counts['flash_attn_with_lse']} fp32 launches")
    if not rel <= ENCODER_F32_REL_MAX:
        raise AssertionError(f"[{phase}] fp32 {family} cut: card vs CPU {rel}")
    phases[f"{family} fp32 cut"] = {"rel_err_vs_cpu": rel, "launches": counts}
    del runner, pipe, lat, img
    return phases


def sigma_phase(kernels, dev):
    """Phase 41: PixArt-Sigma 1024 and 2K at full width and depth through
    ``xDiTParallel`` (20 steps, guidance 4.5, AdaLN tables spiced): one
    request each, 2K with ``--enable_tiling`` (kernel 1 28 x 20 times plus
    once per VAE tile of 512 latent pixels or more); then Sigma 2K with
    phase 9's mixed DiTFastAttn plan
    (kernel 4 at S16384; the full and window launches the plan implies).
    Returns the phases."""
    import dataclasses

    import torch

    from compactfusion_tpu_torch.cache.fast_attn import optimize_plan
    from compactfusion_tpu_torch.models import pixart as model_pixart
    from compactfusion_tpu_torch.parallel_api import xDiTParallel
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline

    init = model_pixart.init_pixart
    model_pixart.init_pixart = lambda generator, cfg: spice_pixart(init(generator, cfg))
    phases = {}
    try:
        for name, argv, size in (("pixart-sigma 1024", SIGMA_ARGV, 1024), ("pixart-sigma 2k tiled", SIGMA_2K_ARGV,
                                                                           2048)):
            t0 = time.perf_counter()
            runner = xDiTParallel(*_cli(argv).create_config())
            build_s = time.perf_counter() - t0
            pcfg = runner.pipeline_config
            vcfg = pcfg.vae
            tiles = vae_flash_tiles(size // 8, size // 8, vcfg) if vcfg.use_tiling else 1
            expect = {"flash_attn_with_lse": DEPTH * STEPS + tiles, WIDE: tiles}
            lat, img, sec, peak, counts, (lo, hi, std) = runner_request(kernels, runner, f"[41] {name}", expect,
                                                                        size)
            print(f"[41] {name} through xDiTParallel ({' '.join(argv[:2])}, {pcfg.height} x {pcfg.width}, "
                  f"interpolation scale {pcfg.model.interpolation_scale}, VAE scaling {vcfg.scaling_factor}"
                  f"{', tiled decode' if vcfg.use_tiling else ''}): built in {build_s:.2f} s; image in "
                  f"[{lo:.4f}, {hi:.4f}], std {std:.4f}; {sec:.4f} s/image (CUDA events, the first request: "
                  f"no warm-up); kernel 1 {counts['flash_attn_with_lse']} launches ({DEPTH} x {STEPS} + {tiles} "
                  f"VAE {'tiles' if tiles > 1 else 'decode'}); max_memory_allocated {peak:.3f} GiB")
            phases[name] = {"s_per_image": sec, "build_s": build_s, "max_memory_allocated_gib": peak,
                            "launches": counts}
        # Sigma 2K with the mixed DiTFastAttn plan, the runner's request
        mixed = mixed_plan()
        full, window = plan_launches(optimize_plan(mixed))
        pipe = runner.pipeline
        runner.pipeline = PixArtPipeline(pipe.params, pipe.vae_params, dataclasses.replace(
            pcfg, fast_attn_plan=tuple(tuple(int(v) for v in row) for row in mixed), fast_attn_window=WINDOW),
            dev)
        expect = {"flash_attn_with_lse": full - 1 + tiles, "flash_attn_window_with_lse": window, WIDE: tiles}
        plan_lat, _, plan_sec, plan_peak, counts, _ = runner_request(kernels, runner, "[41] sigma 2k mixed plan",
                                                                     expect, 2048)
        rel = rel_fro(plan_lat, lat)
        print(f"[41] pixart-sigma 2k with phase 9's mixed DiTFastAttn plan (window {WINDOW}): latent rel err vs "
              f"the plain request {rel:.6f}; {plan_sec:.4f} s/image; kernel 1 {counts['flash_attn_with_lse']}, "
              f"kernel 4 {counts['flash_attn_window_with_lse']} launches (as the plan implies: "
              f"{full - 1} + {tiles} and {window}); max_memory_allocated {plan_peak:.3f} GiB")
        if not 0.0 < rel < float("inf"):
            raise AssertionError(f"[41] sigma 2k mixed plan: rel err {rel}")
        phases["pixart-sigma 2k mixed plan"] = {"s_per_image": plan_sec, "latent_rel_err": rel,
                                                "max_memory_allocated_gib": plan_peak, "launches": counts}
        del runner, pipe, lat, img, plan_lat
    finally:
        model_pixart.init_pixart = init
    return phases


def build_image_cut(family, dev):
    """Phase 42's model: SD3-medium or HunyuanDiT v1.2 at full width, cut to
    :data:`IMG_CUT` blocks, random weights from seed 0, modulation biases
    spiced."""
    import dataclasses

    import numpy as np
    import torch

    if family == "sd3":
        from compactfusion_tpu_torch.models.sd3 import init_sd3, sd3_medium

        mcfg = dataclasses.replace(sd3_medium(), depth=IMG_CUT[family])
        params = init_sd3(torch.Generator(device=dev).manual_seed(0), mcfg)
    else:
        from compactfusion_tpu_torch.models.hunyuandit import hunyuandit_v12, init_hunyuandit

        mcfg = dataclasses.replace(hunyuandit_v12(), depth=IMG_CUT[family])
        params = init_hunyuandit(torch.Generator(device=dev).manual_seed(0), mcfg)
    return mcfg, _spiced(params, np.random.default_rng(99))


def image_cut_pipeline(family, mcfg, params, dev, mesh=None, **kw):
    """Phase 42's pipeline: 1024 x 1024, 6 steps, the family's guidance, no VAE."""
    if family == "sd3":
        from compactfusion_tpu_torch.models.vae import sd3_vae
        from compactfusion_tpu_torch.pipelines.sd3 import SD3Pipeline, SD3PipelineConfig

        cfg = SD3PipelineConfig(model=mcfg, vae=sd3_vae(), num_steps=IMG_CUT_STEPS, guidance_scale=SD3_GUIDANCE, **kw)
        return SD3Pipeline(params, None, cfg, dev, mesh=mesh)
    from compactfusion_tpu_torch.pipelines.hunyuandit import HunyuanDiTPipeline, HunyuanDiTPipelineConfig

    cfg = HunyuanDiTPipelineConfig(model=mcfg, num_steps=IMG_CUT_STEPS, guidance_scale=HY_GUIDANCE, **kw)
    return HunyuanDiTPipeline(params, None, cfg, dev, mesh=mesh)


def image_cut_request(pipe, family, seed):
    """Phase 42's request from ``seed``: SD3's (2, 1, 197, 4096) text states
    and (2, 1, 2048) pooled vectors, or HunyuanDiT's (2, 1, 120, 1024) text
    states with the uncond prompt padded after 9 tokens; then the noise.
    Returns (latents, seconds by CUDA events)."""
    import torch

    dev, m = pipe.device, pipe.cfg.model
    g = torch.Generator(device=dev).manual_seed(seed)
    if family == "sd3":
        txt = torch.randn((2, 1, SD3_TXT, m.text_dim), generator=g, device=dev).to(torch.bfloat16)
        second = torch.randn((2, 1, m.pooled_dim), generator=g, device=dev)
    else:
        txt = torch.randn((2, 1, 120, m.text_dim), generator=g, device=dev).to(torch.bfloat16)
        second = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
        second[1, :, 9:] = False
    return _events_s(lambda: pipe(txt, second, generator=g, decode=False))


@contextlib.contextmanager
def image_halves_apart(family):
    """Within the block, an SD3 or HunyuanDiT pipeline of this process runs
    each CFG half's forward alone, at B1, as a rank of cfg 2 runs its half
    (lossless requests: no attention state)."""
    import torch

    if family == "sd3":
        from compactfusion_tpu_torch.pipelines import sd3 as mod

        real = mod.sd3_forward

        def forward(params, x, txt, pooled, t, cfg, *, attn_state, **kw):
            outs = [real(params, x_, txt_, p_, t_, cfg, attn_state=attn_state, **kw)[0]
                    for x_, txt_, p_, t_ in zip(x.chunk(2), txt.chunk(2), pooled.chunk(2), t.chunk(2))]
            return torch.cat(outs), attn_state

        mod.sd3_forward = forward
    else:
        from compactfusion_tpu_torch.pipelines import hunyuandit as mod

        real = mod.hunyuandit_forward

        def forward(params, x, t, text, cfg, *, text_mask, attn_state_down, attn_state_up, **kw):
            outs = [real(params, x_, t_, text_, cfg, text_mask=m_, attn_state_down=attn_state_down,
                         attn_state_up=attn_state_up, **kw)[0]
                    for x_, t_, text_, m_ in zip(x.chunk(2), t.chunk(2), text.chunk(2), text_mask.chunk(2))]
            return torch.cat(outs), attn_state_down, attn_state_up

        mod.hunyuandit_forward = forward
    name = "sd3_forward" if family == "sd3" else "hunyuandit_forward"
    try:
        yield
    finally:
        setattr(mod, name, real)


def image_rank(rank, world, runs):
    """One rank of phase 42 (``spawn_local`` on this GPU, gloo): both cut
    models from their seeds, then per run (name, family, ParallelConfig
    kwargs, CompactConfig codec or None, pipeline-config kwargs) the request
    from seed 1 with every count set to 0 before it; returns per run what
    :func:`ring_rank` returns."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    models = {f: build_image_cut(f, dev) for f in IMG_CUT}
    out = {}
    for name, family, par, codec, extra in runs:
        parallel = ParallelConfig(**par)
        kw = dict(extra)
        if codec is not None:
            kw["compact"] = CompactConfig(enabled=True, warmup_steps=IMG_CUT_WARMUP, residual=1, error_feedback=True,
                                          fastpath=True, check_consistency=True, compress_type=CompressType(codec))
        pipe = image_cut_pipeline(family, *models[family], dev, parallel=parallel, mesh=make_mesh(parallel), **kw)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        lat, sec = image_cut_request(pipe, family, 1)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "wire_bytes": _counter("ring_shift.nbytes"),
                     "all_to_all_bytes": _counter("Mesh.all_to_all.nbytes"),
                     "gather_bytes": _counter("Mesh.all_gather_tree.nbytes"),
                     "consistency_dev": compact_ring.max_consistency_dev, "skips": None, "s_per_image": sec}
        del pipe
    return out


def image_ring_phase(kernels, dev, codecs):
    """Phase 42: SD3-medium and HunyuanDiT v1.2 at full width and 1024 x 1024,
    cut to :data:`IMG_CUT` blocks, 6 steps, as 2 gloo processes on this
    card: ring 2 lossless, BINARY and INT2 (residual 1 + EF, warmup 2, the
    consistency check on), each unfused and fused; Ulysses 2; cfg 2; sync
    PipeFusion pp2 (HunyuanDiT's with the mirror skip channel); the patch
    pipeline (SD3 M = 2, HunyuanDiT M = 4); TP 2.  One process runs the
    same cut first: lossless, each CFG half at B1, and with kernel 1
    swapped for its plain twin (the bf16 order floor).  Lossless runs,
    sync pp2 and TP 2 within max(RING_REL_MAX, ORDER_FLOOR_FACTOR x the
    floor) of one process (sync pp2 also within PP_FLUX_REL_MAX); cfg 2
    bit-equal to the halves at B1; the fused lossless ring against the
    unfused one; compressed 0 < err < 0.05 with EF deviation 0; the patch
    pipelines in PATCH_PP_REL of sync; exact launch counts; the ring, cfg
    and all-to-all bytes the shapes imply.  SD3's fused compressed ring
    takes the unfused route (197 text + 2,048 image query rows a rank, not
    a multiple of 8); HunyuanDiT's takes kernel 8.  Returns the phases."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    S, W = IMG_CUT_STEPS, IMG_CUT_WARMUP
    refs = {}
    for family in IMG_CUT:
        mcfg, params = build_image_cut(family, dev)
        pipe = image_cut_pipeline(family, mcfg, params, dev)
        _reset_counters()
        lat, sec = image_cut_request(pipe, family, 1)
        _check_counts(f"[42] {family} cut, one process", _counts(kernels),
                      {"flash_attn_with_lse": IMG_CUT[family] * S})
        with image_halves_apart(family):
            halves, _ = image_cut_request(pipe, family, 1)
        with plain_attention():
            plain, plain_sec = image_cut_request(pipe, family, 1)
        one, halves, plain = (x.float().cpu().numpy() for x in (lat, halves, plain))
        floor = _rel_np(plain, one)
        refs[family] = {"one": one, "halves": halves, "floor": floor,
                        "bound": max(RING_REL_MAX, ORDER_FLOOR_FACTOR * floor), "s": sec}
        print(f"[42] {family} cut to {IMG_CUT[family]} blocks (full width, 1024 x 1024, {S} steps): one process, "
              f"lossless, {sec:.4f} s; CFG halves at B1 vs the B2 run {_rel_np(halves, one):.6g}; kernel 1 swapped "
              f"for its plain twin: rel err vs the kernel's run {floor:.6g} ({plain_sec:.4f} s): lossless bound "
              f"{refs[family]['bound']:.6g}")
        del params, pipe
        torch.cuda.empty_cache()
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    runs = []
    for f in IMG_CUT:
        runs += [(f"{f} ring2 lossless", f, ring2, None, {}), (f"{f} ring2 lossless fused", f, fused2, None, {})]
        runs += [(f"{f} ring2 {c}" + s, f, par, c, {}) for c in ("binary", "int2")
                 for s, par in (("", ring2), (" fused", fused2))]
        runs += [(f"{f} u2 lossless", f, {"ulysses_degree": 2}, None, {}),
                 (f"{f} cfg2 lossless", f, {"cfg_degree": 2}, None, {}),
                 (f"{f} pp2 sync", f, {"pp_degree": 2}, None, {}),
                 (f"{f} pp2 patch M{IMG_PATCH[f]}", f, {"pp_degree": 2}, None,
                  {"num_pipeline_patch": IMG_PATCH[f]}),
                 (f"{f} tp2", f, {"tp_degree": 2}, None, {})]
    t0 = time.perf_counter()
    two = spawn_local(image_rank, 2, "gloo", runs, threads=2)
    spawn_s = time.perf_counter() - t0
    phases = {}
    for f in IMG_CUT:
        L, C, ref = IMG_CUT[f], S - W, refs[f]
        hops = 2 * L
        # the fused compressed ring: SD3's 197 + 2,048 query rows are not a
        # multiple of 8 (the unfused route, as in the JAX package); HunyuanDiT's 2,048 are
        fused_c = f == "hunyuandit"
        patch_warm = 1  # runtime_warmup_steps; HunyuanDiT primes its caches with one more forward
        patch = L // 2 * (patch_warm + (f == "hunyuandit") + IMG_PATCH[f] * (S - patch_warm))
        expect = {f"{f} ring2 lossless": {"flash_attn_with_lse": hops * S},
                  # SD3's fused ring: its text block (Sk 197 < 512) takes the plain route
                  f"{f} ring2 lossless fused": {"ring_flash_attn_with_lse": hops * S},
                  f"{f} u2 lossless": {"flash_attn_with_lse": L * S},
                  f"{f} cfg2 lossless": {"flash_attn_with_lse": L * S},
                  f"{f} pp2 sync": {"flash_attn_with_lse": L // 2 * S},
                  f"{f} pp2 patch M{IMG_PATCH[f]}": {"flash_attn_with_lse": patch},
                  f"{f} tp2": {"flash_attn_with_lse": L * S}}
        for codec in ("binary", "int2"):
            q, dq = f"{codec}_quant_fastpath", f"{codec}_dequant_fastpath"
            expect[f"{f} ring2 {codec}"] = {"flash_attn_with_lse": hops * S, q: hops * C, dq: hops * C}
            expect[f"{f} ring2 {codec} fused"] = ({"flash_attn_with_lse": hops * W, "compact_ring_flash": hops * C,
                                                   "ef_update_slot": hops * C} if fused_c
                                                  else expect[f"{f} ring2 {codec}"])
        for name, fam, _, codec, _ in runs:
            if fam != f:
                continue
            want = dict({WIDE: 0}, **expect[name])
            if codec is not None:
                more = [(name[:-6], two[0][name[:-6]]["latents"], COMPRESSED_REL_ERR_MAX)] if name.endswith(
                    "fused") else []
                phases[name] = ring_phase(42, two, name, ref["one"], want, COMPRESSED_REL_ERR_MAX, more, low=0.0)
                if phases[name]["consistency_dev"] != 0.0:
                    raise AssertionError(f"{name}: EF caches differ across ranks")
            elif "patch" in name:
                phases[name] = ring_phase(42, two, name, two[0][f"{f} pp2 sync"]["latents"], want, PATCH_PP_REL[1],
                                          low=PATCH_PP_REL[0])
            else:
                more = []
                if name.endswith("fused"):
                    more.append((name[:-6], two[0][name[:-6]]["latents"], ref["bound"]))
                if "cfg2" in name:
                    more.append(("the CFG halves at B1", ref["halves"], 0.0))
                bound = PP_FLUX_REL_MAX if "pp2 sync" in name else ref["bound"]
                phases[name] = ring_phase(42, two, name, ref["one"], want, bound, more)
            phases[name]["latent_rel_err_order_floor"] = ref["floor"]
        # bytes per rank: the ring's bf16 image K/V of the CFG batch per layer
        # and step (lossless), the raw fp32 K/V in warmup then the payloads
        # (compressed); cfg 2: each step's bf16 prediction; Ulysses 2: q (the
        # text rows in front of the local rows), k, v and out, half of each
        n, c = 2 * (SD3_IMG if f == "sd3" else HY_IMG) // 2, SD3_DIM if f == "sd3" else HY_DIM
        want = {f"{f} ring2 lossless": L * S * 2 * n * c * 2}
        for codec in ("binary", "int2"):
            payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType(codec)))
            want[f"{f} ring2 {codec}"] = want[f"{f} ring2 {codec} fused"] = L * (W * 2 * n * c * 4 + C * 2 * payload)
        txt = SD3_TXT if f == "sd3" else 0
        out_ch = 64 if f == "sd3" else 16  # the velocity, or eps without the learned-variance half
        want_cfg = S * (SD3_IMG if f == "sd3" else HY_IMG) * out_ch * 2
        want_a2a = L * S * (2 * (txt + n // 2) + 2 * (n // 2)) * 2 * c * 2 // 2
        got = {k: phases[k]["wire_bytes_per_rank"] for k in want}
        cfg_bytes = [r[f"{f} cfg2 lossless"]["wire_bytes"] for r in two]
        a2a = [r[f"{f} u2 lossless"]["all_to_all_bytes"] for r in two]
        print(f"[42] {f}: ring-shift bytes per rank {got}, expected {want}; cfg 2 exchange {sorted(set(cfg_bytes))}, "
              f"expected {want_cfg}; U2 all-to-all {sorted(set(a2a))}, expected {want_a2a}")
        if got != want or any(b != want_cfg for b in cfg_bytes) or any(b != want_a2a for b in a2a):
            raise AssertionError(f"[42] {f}: the rings, the cfg exchange or the all-to-alls sent other bytes")
    print(f"[42] the spawn took {spawn_s:.1f} s")
    return phases


def cog_f32_ring_phase(kernels, dev, codecs):
    """Phase 34 in fp32: the same cut model (its bf16 weights in fp32) and
    request, one process, then 2 gloo processes on this card: ring 2
    lossless, unfused and fused, within F32_RING_LOSSLESS_REL_MAX of the
    one process; BINARY (residual 1 + EF, warmup 2, the consistency check
    on), unfused and fused (the fused route takes the unfused one at 9,001
    query rows a rank: bit-equal), within F32_RING_BINARY_REL_MAX of the
    same BINARY ring run with kernel 1 swapped for its plain twin (the fp32
    reference of the ring's arithmetic: CogVideoX's text rows ride as joint
    tensors, which the single-process ring emulation does not take) and 0 <
    err < 0.05 from lossless; EF deviation 0; every flash launch an fp32
    one.  Returns the phases."""
    import torch

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    mcfg, params = build_cog_cut(dev, torch.float32)
    _reset_counters()
    lat, sec = cog_request(cog_pipeline(mcfg, params, dev), 1)
    L, S, W = COG_CUT, COG_RING_STEPS, COG_WARMUP
    _check_counts("CogVideoX fp32 cut, one process", _counts(kernels),
                  _all_f32({"flash_attn_with_lse": L * S}))
    one = lat.float().cpu().numpy()
    del params, lat
    torch.cuda.empty_cache()
    print(f"[34] CogVideoX-2b cut to {L} blocks in fp32 (the bf16 weights, the same request): one process, "
          f"lossless, {sec:.4f} s")
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    runs = [("fp32 cog ring2 lossless", ring2, None), ("fp32 cog ring2 lossless fused", fused2, None),
            ("fp32 cog ring2 binary", ring2, "binary"), ("fp32 cog ring2 binary fused", fused2, "binary"),
            ("fp32 cog ring2 binary, kernel 1's twin", ring2, "binary", True)]
    two = spawn_local(cog_rank, 2, "gloo", runs, torch.float32, threads=2)
    hops, C = 2 * L, S - W
    binary = {"flash_attn_with_lse": hops * S, "binary_quant_fastpath": hops * C,
              "binary_dequant_fastpath": hops * C}
    expect = {"fp32 cog ring2 lossless": {"flash_attn_with_lse": hops * S},
              "fp32 cog ring2 lossless fused": {"ring_flash_attn_with_lse": hops * S},
              "fp32 cog ring2 binary": binary, "fp32 cog ring2 binary fused": binary,
              "fp32 cog ring2 binary, kernel 1's twin": dict(binary, flash_attn_with_lse=0)}
    twin = two[0]["fp32 cog ring2 binary, kernel 1's twin"]["latents"]
    phases = {}
    for name, _, codec, *_ in runs:
        want = dict({WIDE: 0}, **expect[name])
        if codec is None:
            phases[name] = ring_phase(34, two, name, one, want, F32_RING_LOSSLESS_REL_MAX, f32=True)
        else:
            refs = [] if "twin" in name else [("the BINARY ring on kernel 1's twin", twin, F32_RING_BINARY_REL_MAX)]
            if name.endswith("fused"):
                refs.append((name[:-6], two[0][name[:-6]]["latents"], 0.0))
            phases[name] = ring_phase(34, two, name, one, want, COMPRESSED_REL_ERR_MAX, refs, low=0.0, f32=True)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
    n, c = 2 * COG_RING_LOCAL, COG_DIM
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    want = {"fp32 cog ring2 lossless": L * S * 2 * n * c * 4,
            **{k: L * (W * 2 * n * c * 4 + C * 2 * payload) for k, _, cc, *_ in runs if cc}}
    got = {k: phases[k]["wire_bytes_per_rank"] for k in want}
    print(f"[34] fp32: ring-shift bytes per rank {got}, expected {want}")
    if got != want:
        raise AssertionError("phase 34 (fp32): the rings sent other bytes than the path implies")
    return phases


# -- phases 43-47: observability, Latte-1, ConsisID-preview, HunyuanVideo --

VID_PROMPT = "a corgi running along a beach at sunset, waves in the background"
#: phase 44: Latte-1 as published (512 x 512, 16 frames, CFG 7.5) at 10 of
#: its 50 steps (the script's time limit; s/step is what the phase measures)
LATTE_STEPS = 10
LATTE_ARGV = ["--model", "maxin-cn/Latte-1", "--height", "512", "--width", "512", "--num_frames", "16",
              "--num_inference_steps", str(LATTE_STEPS), "--guidance_scale", "7.5", "--max_sequence_length", "120",
              "--prompt", VID_PROMPT]
#: phase 45: ConsisID-preview at 49 x 480 x 720, 4 of its 50 steps
CON_STEPS = 4
CON_ARGV = ["--model", "BestWishYsh/ConsisID-preview", "--height", "480", "--width", "720", "--num_frames", "49",
            "--num_inference_steps", str(CON_STEPS), "--guidance_scale", "6", "--max_sequence_length", "226",
            "--prompt", VID_PROMPT]
#: phase 46: HunyuanVideo-T2V at 33 x 544 x 960 (cut from the published 129
#: x 720 x 1280: the time limit), 4 of its 50 steps
HV_STEPS, HV_TXT = 4, 256
HV_ARGV = ["--model", "tencent/HunyuanVideo", "--height", "544", "--width", "960", "--num_frames", "33",
           "--num_inference_steps", str(HV_STEPS), "--guidance_scale", "6", "--max_sequence_length", str(HV_TXT),
           "--prompt", VID_PROMPT]
#: token counts of those requests: Latte's frames of 32 x 32 patches,
#: ConsisID's 13 x 30 x 45, HunyuanVideo's 9 x 34 x 60
LATTE_FRAME, CON_VIDEO, CON_TXT, HV_VIDEO = 1024, 13 * 30 * 45, 226, 9 * 34 * 60
#: phase 47: each family at full width cut to these blocks (Latte: pairs;
#: HunyuanVideo: double, single), VID_CUT_STEPS steps (the first sent raw),
#: and sizes cut where the gloo ring's bytes would dominate (ConsisID 13
#: frames: 5,400 tokens; HunyuanVideo 5 frames: 4,080, an even latent frame
#: count so that a rank's 2,040 rows plus 256 text rows are a multiple of 8
#: and the fused compressed ring is on the path)
VID_CUT = {"latte": 2, "consisid": 2, "hunyuanvideo": (1, 2)}
VID_CUT_STEPS, VID_CUT_WARMUP = 3, 1
VID_CUT_SIZE = {"latte": dict(height=512, width=512, num_frames=16),
                "consisid": dict(height=480, width=720, num_frames=13),
                "hunyuanvideo": dict(height=544, width=960, num_frames=5)}
#: phase 43's collector run: PixArt at full width cut to 2 blocks, 2 steps
COLLECT_CUT, COLLECT_STEPS = 2, 2


def observability_phase(kernels, dev, codecs):
    """Phase 43, the stats half: PixArt-alpha 512's ring-8 BINARY emulation
    at full width cut to :data:`SP_CUT` blocks, :data:`RANK_STEPS` steps,
    once plain and once with ``log_stats``: the latents and launch counts
    equal (the taps change nothing), ``StatsLogger``'s keys, steps and
    record counts (one per compressed step, layer and ring chunk), finite
    metrics, 64-value spectra with the activation's above its delta's, the
    compression ratio of the chunks' payloads, and the JSON dumps grouped
    by step.  Returns (the phases, the eigenvalue dump)."""
    import tempfile

    import torch

    from compactfusion_tpu_torch.compact.stats import StatsLogger
    from compactfusion_tpu_torch.config import CompressType

    mcfg, vcfg, params, vae_params = build_models(dev, depth=SP_CUT)
    runs = {}
    for name, compact in (("plain", compressed_config()), ("log_stats", compressed_config(log_stats=True))):
        StatsLogger.reset()
        pipe = pixart_pipeline(mcfg, vcfg, params, vae_params, dev, steps=RANK_STEPS, compact=compact)
        _reset_counters()
        lat, img, sec = request(pipe, 1)
        check_image(img, f"[43] ring-8 binary emulation, {name}")
        runs[name] = (lat, sec, _counts(kernels))
    log = StatsLogger.instance()
    n = (RANK_STEPS - WARMUP) * SP_CUT * RING
    if not torch.equal(runs["plain"][0], runs["log_stats"][0]) or runs["plain"][2] != runs["log_stats"][2]:
        raise AssertionError("[43] the log_stats taps changed the latents or the launches")
    keys = (sorted(log.records), sorted(log.spectra))
    if keys != (["k", "v"], ["k-activation", "k-delta"]):
        raise AssertionError(f"[43] StatsLogger keys {keys}")
    for key in ("k", "v"):
        recs = log.records[key]
        if len(recs) != n or {s for s, _ in recs} != {-1}:
            raise AssertionError(f"[43] {key}: {len(recs)} records, expected {n} at step -1")
        for _, m in recs:
            if not (all(v == v and abs(v) < float("inf") for v in m.values()) and 0 < m["rel_err"] < 1
                    and m["cos_sim"] > 0.5):
                raise AssertionError(f"[43] {key}: metrics {m}")
    for key in ("k-activation", "k-delta"):
        if len(log.spectra[key]) != n or any(len(r) != 64 for r in log.spectra[key]):
            raise AssertionError(f"[43] {key}: {len(log.spectra[key])} spectra")
    top = [(a[0], d[0]) for a, d in zip(log.spectra["k-activation"], log.spectra["k-delta"])]
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(CHUNK), CompressType.BINARY))
    log.account_volume(2 * n * payload, 2 * n * CHUNK[0] * CHUNK[1] * 2)  # K and V, bf16 on the wire
    with tempfile.TemporaryDirectory() as tmp:
        eig = log.dump_eigenvalues(os.path.join(tmp, "eig.json"), depth=SP_CUT * RING)
        err = log.dump_err_vs_steps(os.path.join(tmp, "err.json"), depth=SP_CUT * RING)
    if len(eig["k-delta"]) != RANK_STEPS - WARMUP or len(err["k"]) != RANK_STEPS - WARMUP:
        raise AssertionError("[43] the dumps are not grouped by denoise step")
    mean_rel = sum(m["rel_err"] for _, m in log.records["k"]) / n
    print(f"[43] PixArt-alpha 512 cut to {SP_CUT} blocks, ring-8 binary emulation, {RANK_STEPS} steps: latents and "
          f"launches bit-equal with log_stats on; {runs['plain'][1]:.4f} s plain, {runs['log_stats'][1]:.4f} s with "
          f"the taps (the spectra's svdvals on the card); StatsLogger keys {keys}, {n} records and spectra a key; K "
          f"mean rel err {mean_rel:.4f}, err by step {[round(e['rel_err'], 4) for e in err['k']]}; top singular "
          f"value activation/delta {top[0][0]:.2f}/{top[0][1]:.2f} (first), {top[-1][0]:.2f}/{top[-1][1]:.2f} "
          f"(last); compression ratio {log.compression_ratio:.2f}x")
    summary = log.summary()
    print("[43] StatsLogger.summary(): " + summary.replace("\n", " | "))
    StatsLogger.reset()
    return {"observability log_stats": {"s_per_image": [runs["plain"][1], runs["log_stats"][1]],
                                        "records_per_key": n, "k_mean_rel_err": mean_rel,
                                        "k_rel_err_by_step": [e["rel_err"] for e in err["k"]],
                                        "compression_ratio": log.compression_ratio,
                                        "launches": runs["log_stats"][2]}}, eig


def _video_ok(video, what, shape):
    import torch

    v32 = video.float()
    lo, hi, std = v32.min().item(), v32.max().item(), v32.std().item()
    if tuple(video.shape) != shape or not bool(torch.isfinite(v32).all()) or lo < 0 or hi > 1 or std == 0.0:
        raise AssertionError(f"{what}: video {tuple(video.shape)} in [{lo}, {hi}], std {std}")
    return lo, hi, std


def video_runner_phase(phase, name, argv, kernels, expect, shape, setup=None):
    """One request of a video family through ``xDiTParallel`` at the
    published width and depth (random weights, modulation biases spiced;
    the runner's seeded prompt encoder): its seconds by CUDA events, the
    decode's apart, the peak memory, the launch counts against ``expect``
    and the video's validity.  ``setup(runner)`` runs after the build.
    Returns (the phases, the runner, the video)."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    t0 = time.perf_counter()
    runner = xDiTParallel(*_cli(argv).create_config())
    pipe, pcfg = runner.pipeline, runner.pipeline_config
    pipe.params = _spiced(pipe.params, np.random.default_rng(99))
    if setup is not None:
        setup(runner)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    marks = {}

    def decode(lat, real=pipe.decode):
        out, marks["decode"] = _events_s(lambda: real(lat))
        return out

    pipe.decode = decode
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    video, total = _events_s(runner)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _counts(kernels)
    _check_counts(f"[{phase}] {name}", counts, expect)
    lo, hi, std = _video_ok(video, f"[{phase}] {name}", shape)
    steps = pcfg.num_steps
    sample_s = total - marks["decode"]
    print(f"[{phase}] {name} through xDiTParallel: {_numel(pipe.params) / 1e9:.3f}B parameters in bf16 drawn on the "
          f"card with the VAE ({_numel(pipe.vae_params) / 1e6:.1f}M) in {build_s:.1f} s; {pcfg.num_frames} x "
          f"{pcfg.height} x {pcfg.width}, {pcfg.tokens} tokens, {steps} steps: video {tuple(video.shape)} in "
          f"[{lo:.4f}, {hi:.4f}], std {std:.4f}; {total:.4f} s/video (CUDA events: prompt + {steps} steps "
          f"{sample_s:.4f} s = {sample_s / steps:.4f} s/step, decode {marks['decode']:.4f} s); "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB; launches "
          f"{', '.join(f'{k} {v}' for k, v in counts.items() if v)}")
    return {name: {"s_per_video": total, "s_per_step": sample_s / steps, "decode_s": marks["decode"],
                   "build_s": build_s, "max_memory_allocated_gib": peak, "launches": counts}}, runner, video


def latte_phase(kernels, flash, timing, dev, gen):
    """Phase 44: kernel 1 at Latte-1's spatial self-attention (the CFG
    batch's 2 x 16 frames of 1,024 tokens, 16 heads of 72, DP 80) against
    its twin; Latte-1 at full width and depth (28 spatial + 28 temporal
    blocks) through ``xDiTParallel``, 512 x 512, 16 frames, CFG 7.5,
    :data:`LATTE_STEPS` steps, every frame through the SD VAE: kernel 1
    once a spatial block and step, plus the VAE's one wide launch (the
    temporal attention over 16 frames and the cross-attention to 120 tokens
    take ``sdpa``'s plain route).  Returns (the phases, the flash rows, the
    video)."""
    rows = check_flash(flash, timing, dev, gen, [
        (f"Latte-1 spatial self-attn B32 H16 S{LATTE_FRAME} d72", lambda: _qkv_views(gen, dev, 32, LATTE_FRAME), 5,
         4)], phase=44)
    phases, runner, video = video_runner_phase(44, "latte-1", LATTE_ARGV, kernels,
                                               {"flash_attn_with_lse": 28 * LATTE_STEPS + 1, WIDE: 1,
                                                WG["flash_attn_with_lse"]: 28 * LATTE_STEPS},
                                               (1, 16, 512, 512, 3))
    del runner
    return phases, rows, video


def consisid_phase(kernels, flash, quant, codecs, timing, dev, gen):
    """Phase 45: kernel 1 at ConsisID-preview's self-attention (B2 H48
    S17,776 d64) against its twin on head slices; kernels 2, 3, 5 and 6 at
    its ring-2 rows (2 x 8,775 at C3,072) bit for bit; the face encoder
    (``lfe_forward`` at ``lfe_consisid`` width, seeded weights) on the
    stand-in features of a PNG this phase writes; ConsisID-preview at full
    width and depth (42 blocks) through ``xDiTParallel`` with
    ``--img_file_path`` on that PNG, 49 x 480 x 720, :data:`CON_STEPS`
    steps, the 3D VAE: kernel 1 once a block and step (the perceiver
    cross-attention to 5 identity tokens takes the plain route).  Returns
    (the phases, rows by kernel)."""
    import tempfile

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.face import image_face_features, init_lfe, lfe_consisid
    from compactfusion_tpu_torch.utils.image import write_png

    s_all = CON_TXT + CON_VIDEO
    flash_rows = check_flash(flash, timing, dev, gen, [
        (f"ConsisID self-attn B2 H48 S{s_all} d64", lambda: _qkv_views(gen, dev, 2, s_all, 48, 64), 3,
         COG_TWIN_HEADS)], phase=45)
    quant_rows = {codec: [check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32,
                                      (2 * (CON_VIDEO // 2), 3072), phase=45)] for codec in ("binary", "int2")}
    tmp = tempfile.mkdtemp()
    face = os.path.join(tmp, "face.png")
    yy, xx = np.mgrid[0:256, 0:192]
    write_png(face, np.stack([128 + 100 * np.sin(xx / 11.0), 128 + 90 * np.cos(yy / 9.0), (xx + yy) % 256],
                             -1).astype(np.uint8))
    lcfg = lfe_consisid()
    lfe = init_lfe(torch.Generator(device=dev).manual_seed(13), lcfg)
    held = {}

    def setup(runner):
        id_cond, hidden = image_face_features(face, lcfg, dev)
        tokens, held["lfe_s"] = _events_s(lambda: runner.pipeline.encode_face(lfe, id_cond, hidden, lcfg))
        if tuple(tokens.shape) != (1, lcfg.num_queries, lcfg.output_dim) or not bool(torch.isfinite(tokens).all()):
            raise AssertionError(f"[45] face encoder: tokens {tuple(tokens.shape)}")
        held["ids"] = runner._encode_identity(face)

    phases, runner, _ = video_runner_phase(45, "consisid-preview", CON_ARGV + ["--img_file_path", face], kernels,
                                        {"flash_attn_with_lse": 42 * CON_STEPS, WG["flash_attn_with_lse"]: 42 * CON_STEPS},
                                           (1, 49, 480, 720, 3), setup)
    ids = held["ids"]
    print(f"[45] face encoder (lfe_consisid, {_numel(lfe) / 1e6:.1f}M fp32 parameters, seeded) on the PNG's stand-in "
          f"features: (1, 32, 2048) identity tokens in {held['lfe_s']:.4f} s; the runner's identity tokens "
          f"{tuple(ids.shape)} from the seed-303 projection (no face-encoder checkpoint), norm "
          f"{ids.float().norm().item():.3f}")
    phases["consisid-preview"]["face_encoder_s"] = held["lfe_s"]
    del runner, lfe
    os.remove(face)
    os.rmdir(tmp)
    return phases, {"flash": flash_rows, "quant": quant_rows}


def hv_ring_cases(gen, dev, s_local, txt):
    """Kernel 7 at HunyuanVideo's fused ring 2, rank 0's view at B1: q (the
    text rows in front of the local rows), its own K/V, the other rank's."""
    import torch

    def make():
        q = torch.randn((1, txt + s_local, 24, 128), generator=gen, device=dev).to(torch.bfloat16)
        _, k0, v0 = _qkv_views(gen, dev, 1, s_local, 24, 128)
        _, k1, v1 = _qkv_views(gen, dev, 1, s_local, 24, 128)
        return q, [(k0, v0), (k1.contiguous(), v1.contiguous())]

    return [((2, 1, s_local), make)]


def hunyuanvideo_phase(kernels, flash, quant, codecs, rf, timing, dev, gen):
    """Phase 46: kernel 1 at HunyuanVideo's joint self-attention (B1 H24
    S18,360 + 256 d128) and at its VAE's mid attention (one query frame of
    8,160 tokens over its key prefix: the first frame's 8,160 and the last
    frame's 73,440 keys, d512 on the wide body); kernels 2, 3, 5 and 6 at
    its ring-2 rows (9,180 at C3,072); kernels 7 and 8 at phase 47's fused
    ring 2 (2,040 rows a rank, 256 text rows); then HunyuanVideo-T2V at
    full width and depth (20 double + 40 single blocks, 24 heads of 128)
    through ``xDiTParallel``, 33 x 544 x 960, :data:`HV_STEPS` steps, the
    causal 3D VAE: kernel 1 once a block and step plus 9 wide launches of
    the VAE's mid attention (one per latent frame; the token refiner's
    masked attention takes the math path).  Returns (the phases, rows by
    kernel)."""
    import torch

    hw = 68 * 120  # latent tokens a frame at 544 x 960

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def mid(frames):
        return lambda: (rnd(1, hw, 1, 512), rnd(1, frames * hw, 1, 512), rnd(1, frames * hw, 1, 512))

    s_all = HV_VIDEO + HV_TXT
    flash_rows = check_flash(flash, timing, dev, gen, [
        (f"HunyuanVideo joint self-attn B1 H24 S{s_all} d128", lambda: _qkv_views(gen, dev, 1, s_all, 24, 128), 3,
         COG_TWIN_HEADS),
        (f"HunyuanVideo VAE mid-attn, first frame B1 H1 Sq{hw} Sk{hw} d512", mid(1), 5, (1, 2040)),
        (f"HunyuanVideo VAE mid-attn, last frame B1 H1 Sq{hw} Sk{9 * hw} d512", mid(9), 3, (1, 2040))], phase=46)
    quant_rows = {codec: [check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32,
                                      (HV_VIDEO // 2, 3072), phase=46)] for codec in ("binary", "int2")}
    cut_local = VID_CUT_SIZE["hunyuanvideo"]
    s_local = (((cut_local["num_frames"] - 1) // 4 + 1) * (cut_local["height"] // 16) * (cut_local["width"] // 16)) // 2
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, hv_ring_cases(gen, dev, s_local, HV_TXT), phase=46)
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 1, s_local, "binary", -1, False, 24, 128,
                                     HV_TXT + s_local, phase=46)]
    torch.cuda.empty_cache()
    phases, runner, _ = video_runner_phase(46, "hunyuanvideo-t2v", HV_ARGV, kernels,
                                        {"flash_attn_with_lse": 60 * HV_STEPS + 9, WIDE: 9,
                                            WG["flash_attn_with_lse"]: 60 * HV_STEPS}, (1, 33, 544, 960, 3))
    del runner
    return phases, {"flash": flash_rows, "quant": quant_rows, "ring": ring_rows, "cring": cring_rows}


def build_video_cut(family, dev):
    """Phase 47's model of ``family`` at full width cut to :data:`VID_CUT`,
    random weights from seed 0, modulation biases spiced."""
    import dataclasses

    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    if family == "latte":
        from compactfusion_tpu_torch.models.latte import init_latte, latte_1

        mcfg = dataclasses.replace(latte_1(), num_pairs=VID_CUT[family])
        return mcfg, init_latte(g, mcfg)
    if family == "consisid":
        from compactfusion_tpu_torch.models.consisid import consisid_preview, init_consisid

        mcfg = dataclasses.replace(consisid_preview(), depth=VID_CUT[family])
        return mcfg, _spiced(init_consisid(g, mcfg), np.random.default_rng(99))
    from compactfusion_tpu_torch.models.hunyuanvideo import hunyuanvideo_config, init_hunyuanvideo

    d, s = VID_CUT[family]
    mcfg = dataclasses.replace(hunyuanvideo_config(), double_layers=d, single_layers=s)
    return mcfg, _spiced(init_hunyuanvideo(g, mcfg), np.random.default_rng(99))


def video_cut_pipeline(family, mcfg, params, dev, mesh=None, **kw):
    """Phase 47's pipeline: :data:`VID_CUT_SIZE`, :data:`VID_CUT_STEPS`
    steps, no VAE."""
    size = dict(VID_CUT_SIZE[family], num_steps=VID_CUT_STEPS, **kw)
    if family == "latte":
        from compactfusion_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

        return LattePipeline(params, None, LattePipelineConfig(model=mcfg, guidance_scale=7.5, **size), dev, mesh=mesh)
    if family == "consisid":
        from compactfusion_tpu_torch.pipelines.consisid import ConsisIDPipeline, ConsisIDPipelineConfig

        return ConsisIDPipeline(params, None, ConsisIDPipelineConfig(model=mcfg, guidance_scale=6.0, **size), dev,
                                mesh=mesh)
    from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline, HunyuanVideoPipelineConfig

    return HunyuanVideoPipeline(params, None, HunyuanVideoPipelineConfig(model=mcfg, **size), dev, mesh=mesh)


def video_cut_request(pipe, family, seed):
    """Phase 47's request from ``seed``: the text states (Latte with its
    mask, ConsisID's [cond, uncond] and identity tokens, HunyuanVideo's
    LLaMA-width states) and the noise; returns (latents, seconds)."""
    import torch

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    if family == "latte":
        text = torch.randn((2, 1, 120, 4096), generator=g, device=dev)
        return _events_s(lambda: pipe(text, None, generator=g, decode=False))
    if family == "consisid":
        txt = torch.randn((2, 1, CON_TXT, 4096), generator=g, device=dev)
        ids = torch.randn((1, 5, 2048), generator=g, device=dev)
        return _events_s(lambda: pipe(txt, generator=g, id_states=ids, decode=False))
    txt = torch.randn((1, HV_TXT, 4096), generator=g, device=dev)
    return _events_s(lambda: pipe(txt, generator=g, decode=False))


def video_rank(rank, world, runs, collect_dir):
    """One rank of phases 43 and 47 (``spawn_local`` on this GPU, gloo).
    Run "pixart collect": PixArt-alpha 512 at full width cut to
    :data:`COLLECT_CUT` blocks, :data:`COLLECT_STEPS` steps, ring 2 BINARY
    with the fused ring asked for, ``CFTPU_COLLECT_DIR`` set to
    ``collect_dir``.  Then per run (name, family, ParallelConfig kwargs,
    CompactConfig codec or None) the family's cut request from seed 1 with
    every count set to 0 before it; returns per run what :func:`ring_rank`
    returns."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    out = {}
    mcfg, vcfg, params, vae_params = build_models(dev, depth=COLLECT_CUT)
    parallel = ParallelConfig(ring_degree=2, use_fused_ring=True)
    compact = CompactConfig(enabled=True, warmup_steps=1, residual=1, error_feedback=True, fastpath=True,
                            compress_type=CompressType.BINARY)
    pipe = pixart_pipeline(mcfg, vcfg, params, vae_params, dev, steps=COLLECT_STEPS, parallel=parallel,
                           mesh=make_mesh(parallel), compact=compact)
    os.environ["CFTPU_COLLECT_DIR"] = collect_dir
    _reset_counters()
    g = torch.Generator(device=dev).manual_seed(1)
    text = torch.randn((2, 1, 120, 4096), generator=g, device=dev)
    pipe(text, None, generator=g, decode=False)
    torch.cuda.synchronize()
    del os.environ["CFTPU_COLLECT_DIR"]
    out["pixart collect"] = {"launches": _counts(kernels)}
    del pipe, params, vae_params
    models = {}
    for name, family, par, codec in runs:
        if family not in models:
            models[family] = build_video_cut(family, dev)
        parallel = ParallelConfig(**par)
        kw = {}
        if codec is not None:
            kw["compact"] = CompactConfig(enabled=True, warmup_steps=VID_CUT_WARMUP, residual=1, error_feedback=True,
                                          fastpath=True, check_consistency=True, compress_type=CompressType(codec))
        pipe = video_cut_pipeline(family, *models[family], dev, mesh=make_mesh(parallel), parallel=parallel, **kw)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        lat, sec = video_cut_request(pipe, family, 1)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "wire_bytes": _counter("ring_shift.nbytes"),
                     "all_to_all_bytes": _counter("Mesh.all_to_all.nbytes"),
                     "gather_bytes": _counter("Mesh.all_gather_tree.nbytes"),
                     "consistency_dev": compact_ring.max_consistency_dev, "skips": None, "s_per_image": sec}
        del pipe
    return out


def video_ring_phase(kernels, dev):
    """Phase 43's collector half and phase 47, in one spawn of 2 gloo
    processes on this card.  43: every rank writes q/k/v/kbase/vbase once a
    layer and step and its latents once a step, with the shapes of its
    ring shard, and the fused compressed ring stays off while collecting
    (kernel 8 never launches; the quant kernels do).  47: each new family
    at full width cut to :data:`VID_CUT` blocks, :data:`VID_CUT_STEPS`
    steps (warmup 1, the consistency check on): Latte at Ulysses 2 (the
    frame all-to-alls), cfg 2, tp 2 (the ffns split; within the lossless
    bound) and pp 2 (every rank the whole model: one process's latents bit
    for bit); ConsisID with identity tokens at ring 2
    lossless and BINARY (a rank's 2,700 rows plus 226 text rows: the
    unfused route, as in JAX); HunyuanVideo at U2 and at ring 2 lossless and
    BINARY, each unfused and fused (kernels 7 and 8).  One process runs
    each cut first, also with kernel 1 swapped for its twin (the bf16 order
    floor).  Lossless runs within max(RING_REL_MAX, ORDER_FLOOR_FACTOR x the
    floor) of one process; fused within that of unfused; compressed 0 <
    err < max(0.05, ORDER_FLOOR_FACTOR x the floor) with EF deviation 0;
    exact launch counts; the Latte all-to-all bytes the shapes imply.
    Returns the phases."""
    import shutil
    import tempfile

    import numpy as np

    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    S, W = VID_CUT_STEPS, VID_CUT_WARMUP
    refs = {}
    for family in VID_CUT:
        mcfg, params = build_video_cut(family, dev)
        pipe = video_cut_pipeline(family, mcfg, params, dev)
        _reset_counters()
        lat, sec = video_cut_request(pipe, family, 1)
        with plain_attention():
            plain, _ = video_cut_request(pipe, family, 1)
        one, plain = lat.float().cpu().numpy(), plain.float().cpu().numpy()
        floor = _rel_np(plain, one)
        refs[family] = {"one": one, "floor": floor, "bound": max(RING_REL_MAX, ORDER_FLOOR_FACTOR * floor),
                        "s": sec, "tokens": pipe.cfg.tokens}
        print(f"[47] {family} cut to {VID_CUT[family]} blocks (full width, {VID_CUT_SIZE[family]}, {S} steps), one "
              f"process: {sec:.4f} s; kernel 1 swapped for its twin: rel err {floor:.6g}; lossless bound "
              f"{refs[family]['bound']:.6g}")
        del pipe, params
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    runs = [("latte u2 lossless", "latte", {"ulysses_degree": 2}, None),
            ("latte cfg2 lossless", "latte", {"cfg_degree": 2}, None),
            ("latte tp2", "latte", {"tp_degree": 2}, None), ("latte pp2", "latte", {"pp_degree": 2}, None),
            ("consisid ring2 lossless", "consisid", ring2, None), ("consisid ring2 binary", "consisid", ring2, "binary"),
            ("hunyuanvideo u2 lossless", "hunyuanvideo", {"ulysses_degree": 2}, None),
            ("hunyuanvideo ring2 lossless", "hunyuanvideo", ring2, None),
            ("hunyuanvideo ring2 lossless fused", "hunyuanvideo", fused2, None),
            ("hunyuanvideo ring2 binary", "hunyuanvideo", ring2, "binary"),
            ("hunyuanvideo ring2 binary fused", "hunyuanvideo", fused2, "binary")]
    collect_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    two = spawn_local(video_rank, 2, "gloo", runs, collect_dir, threads=2)
    spawn_s = time.perf_counter() - t0
    # 43: the collector's files
    names = sorted(os.listdir(collect_dir))
    want = sorted(f"{t}_n{i:05d}_r{r}.npy" for t in ("q", "k", "v", "kbase", "vbase") for r in range(2)
                  for i in range(COLLECT_CUT * COLLECT_STEPS))
    want += [f"latents_n{i:05d}_r{r}.npy" for r in range(2) for i in range(COLLECT_STEPS)]
    shapes = {t: np.load(os.path.join(collect_dir, f"{t}_n00000_r1.npy"), mmap_mode="r").shape
              for t in ("q", "kbase", "latents")}
    finite = all(np.isfinite(np.load(os.path.join(collect_dir, n))).all() for n in names)
    nbytes = sum(os.path.getsize(os.path.join(collect_dir, n)) for n in names)
    shutil.rmtree(collect_dir)
    col = [r["pixart collect"]["launches"] for r in two]
    print(f"[43] collector: ring 2 BINARY, fused ring asked for, {COLLECT_CUT} blocks x {COLLECT_STEPS} steps, 2 "
          f"gloo ranks: {len(names)} files ({nbytes / 2**20:.1f} MiB), shapes q {shapes['q']}, kbase "
          f"{shapes['kbase']}, latents {shapes['latents']}, all finite {finite}; kernel 8 launches "
          f"{[c['compact_ring_flash'] for c in col]}, binary quant {[c['binary_quant_fastpath'] for c in col]}")
    if names != sorted(want) or not finite or shapes != {"q": (2, 512, 16, 72), "kbase": (1024, 1152),
                                                         "latents": (1, 512, 16)}:
        raise AssertionError(f"[43] collector files {names[:6]}... or shapes {shapes}")
    if any(c["compact_ring_flash"] or not c["binary_quant_fastpath"] for c in col):
        raise AssertionError("[43] the fused ring ran while collecting, or the quant kernels did not")
    phases = {"observability collector": {"files": len(names), "bytes": nbytes,
                                          "launches": {k: sum(c[k] for c in col) for k in col[0]}}}
    # 47
    layers = {"latte": VID_CUT["latte"], "consisid": VID_CUT["consisid"], "hunyuanvideo": sum(VID_CUT["hunyuanvideo"])}
    for name, family, par, codec in runs:
        L, ref, hops = layers[family], refs[family], 2 * layers[family]
        if family == "latte":
            want = {"flash_attn_with_lse": L * S}
        elif "fused" in name and codec is None:
            want = {"ring_flash_attn_with_lse": hops * S}  # the 256 text keys take the plain route
        elif "fused" in name:
            want = {"flash_attn_with_lse": hops * W, "compact_ring_flash": hops * (S - W),
                    "ef_update_slot": hops * (S - W)}
        elif "ring2" in name:
            want = {"flash_attn_with_lse": hops * S}
            if codec is not None:
                want.update({f"{codec}_quant_fastpath": hops * (S - W), f"{codec}_dequant_fastpath": hops * (S - W)})
        else:
            want = {"flash_attn_with_lse": L * S}
        want = dict({WIDE: 0}, **want)
        if codec is not None:
            # the codec's error sits on top of the bf16 order floor, which
            # for ConsisID's cut (guidance 6 on the zero-SNR schedule) is 0.04
            bound = max(COMPRESSED_REL_ERR_MAX, ORDER_FLOOR_FACTOR * ref["floor"])
            more = [(name[:-6], two[0][name[:-6]]["latents"], bound)] if name.endswith("fused") else []
            phases[name] = ring_phase(47, two, name, ref["one"], want, bound, more, low=0.0)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
        else:
            more = [(name[:-6], two[0][name[:-6]]["latents"], ref["bound"])] if name.endswith("fused") else []
            if name == "latte pp2":  # the whole model on the whole weights
                more = [("one process, bit for bit", ref["one"], 0.0)]
            phases[name] = ring_phase(47, two, name, ref["one"], want, ref["bound"], more)
        phases[name]["latent_rel_err_order_floor"] = ref["floor"]
    # Latte U2: each temporal block's two all-to-alls move half of the
    # rank's (B 2, 8 frames, 1,024 tokens, 1,152) bf16 activations away
    want_a2a = VID_CUT["latte"] * S * 2 * (2 * 8 * LATTE_FRAME * 1152 * 2) // 2
    a2a = sorted({r["latte u2 lossless"]["all_to_all_bytes"] for r in two})
    print(f"[47] Latte U2 all-to-all bytes per rank {a2a}, expected {want_a2a}; the spawn took {spawn_s:.1f} s")
    if a2a != [want_a2a]:
        raise AssertionError("[47] Latte's frame all-to-alls sent other bytes")
    return phases


#: phase 48: Step-Video-T2V at the published geometry (204 x 544 x 992: 36
#: latent frames of 17 x 31 tokens), full width and depth (48 blocks of dim
#: 6144, 48 heads of 128: 58.7 GB of bf16 weights), SV_STEPS of its 50
#: steps with CFG 9 batched; the text SV_TXT tokens (the cross-attention
#: takes sdpa's plain route below 512 keys)
SV_STEPS, SV_TXT = 2, 256
SV_ARGV = ["--model", "stepfun-ai/Step-Video-T2V", "--height", "544", "--width", "992", "--num_frames", "204",
           "--num_inference_steps", str(SV_STEPS), "--guidance_scale", "9", "--max_sequence_length", str(SV_TXT),
           "--prompt", VID_PROMPT]
SV_VIDEO = 36 * 17 * 31
#: phase 49: Step-Video at full width cut to SV_CUT blocks, SV_CUT_STEPS
#: steps (the first sent raw), at 544 x 992 with 34 frames (6 latent frames:
#: 3,162 tokens, 1,581 a rank: odd, so the fused compressed ring is not on
#: the path, as in JAX) and, for the fused compressed ring (kernel 8), at
#: 512 x 512 with 17 frames (768 tokens, 384 a rank)
SV_CUT, SV_CUT_STEPS, SV_CUT_WARMUP = 2, 3, 1
SV_CUT_SIZE = dict(height=544, width=992, num_frames=34)
SV_FUSED_SIZE = dict(height=512, width=512, num_frames=17)
#: phase 49's BINARY rings against lossless: the codec acts (> 0) and stays
#: within this; at CFG 9 the cut's BINARY ring lands 0.094 from lossless
#: against a bf16 order floor of 0.037 (PERF.md §6), past phase 47's
#: max(0.05, 1.5 x floor), so the ring's arithmetic is held instead to the
#: same BINARY ring run on kernel 1's twin (and fused to unfused) within the
#: lossless bound
SV_BINARY_REL_MAX = 0.2
#: phase 50: the fp32 launches above the register body against their twins
#: (TF32 off), relative Frobenius error of out (the register and wide
#: bodies' fp32 rows read up to 2e-6)
TILE_F32_REL_MAX = 2e-6
#: the body phase 50's launches take: kernel 1 above d = 512, kernels 4, 7
#: and 8 above d = 128
TILE_BODY = "flash_wide_tile"


def _spiced_tables(tree, rng, path=""):
    """``tree`` with Step-Video's ``scale_shift_table`` leaves (every block's
    and the head's ``final_scale_shift``) drawn from N(0, 0.5^2), as
    ``tests/helpers.py::spice_params`` spices them: at 0 the modulation
    rests on the adaln projection alone."""
    import torch

    if isinstance(tree, dict):
        return {k: _spiced_tables(v, rng, f"{path}/{k}") for k, v in tree.items()}
    if "scale_shift" in path:
        return torch.from_numpy(rng.standard_normal(tuple(tree.shape)) * 0.5).to(tree.device, tree.dtype)
    return tree


def sv_ring_cases(gen, dev, s_local):
    """Kernel 7 at Step-Video's fused ring 2 (phase 49's 512 x 512 cut), rank
    0's view at the CFG batch B2: q, its own K/V, the other rank's."""
    def make():
        q, k0, v0 = _qkv_views(gen, dev, 2, s_local, 48, 128)
        _, k1, v1 = _qkv_views(gen, dev, 2, s_local, 48, 128)
        return q, [(k0, v0), (k1.contiguous(), v1.contiguous())]

    return [((2, 2, s_local), make)]


def stepvideo_phase(kernels, flash, quant, codecs, rf, timing, dev, gen):
    """Phase 48: kernel 1 at Step-Video's self-attention (B2 H48 S18,972
    d128) against its twin on head slices, eager and by CUDA graphs beside
    cuDNN's SDPA; kernels 2, 3, 5 and 6 at phase 49's ring-2 rows (2 x 1,581
    at C6,144); kernels 7 and 8 at phase 49's fused ring 2 (384 rows a rank,
    B2); then Step-Video-T2V at full width and depth through
    ``xDiTParallel`` (48 blocks, seeded weights drawn one layer at a time on
    the card, the scale-shift tables spiced, the seeded prompt encoder at
    text width 6,144), 204 x 544 x 992, :data:`SV_STEPS` steps at CFG 9:
    kernel 1 once a block and step, the latents (1, 18,972, 64) finite.
    Returns (the phases, rows by kernel)."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    flash_rows = check_flash(flash, timing, dev, gen, [
        (f"Step-Video self-attn B2 H48 S{SV_VIDEO} d128", lambda: _qkv_views(gen, dev, 2, SV_VIDEO, 48, 128), 3,
         COG_TWIN_HEADS)], phase=48)
    rows_ring2 = 2 * (sv_tokens(SV_CUT_SIZE) // 2)  # B2 x a rank's tokens at ring 2
    quant_rows = {codec: [check_quant(quant, codecs, timing, dev, gen, codec, -1, torch.float32, (rows_ring2, 6144),
                                      phase=48)] for codec in ("binary", "int2")}
    s_fused = sv_tokens(SV_FUSED_SIZE) // 2
    ring_rows = check_ring_flash(rf, flash, timing, dev, gen, sv_ring_cases(gen, dev, s_fused), phase=48)
    cring_rows = [check_compact_ring(rf, flash, timing, dev, gen, 2, 2, s_fused, "binary", -1, False, 48, 128,
                                     phase=48)]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    runner = xDiTParallel(*_cli(SV_ARGV).create_config())
    pipe, pcfg = runner.pipeline, runner.pipeline_config
    pipe.params = _spiced_tables(pipe.params, np.random.default_rng(99))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_bytes, n_params = _nbytes_tree(pipe.params), _numel(pipe.params)
    marks = {}

    def sample(*a, real=pipe._sample):
        out, marks["sample"] = _events_s(lambda: real(*a))
        return out

    pipe._sample = sample
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    lat, total = _events_s(runner)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _counts(kernels)
    _check_counts("[48] step-video-t2v", counts, {"flash_attn_with_lse": 48 * SV_STEPS,
                                                  WG["flash_attn_with_lse"]: 48 * SV_STEPS})
    l32 = lat.float()
    std = l32.std().item()
    if tuple(lat.shape) != (1, SV_VIDEO, 64) or not bool(torch.isfinite(l32).all()) or std == 0.0:
        raise AssertionError(f"[48] step-video-t2v: latents {tuple(lat.shape)}, std {std}")
    s_step = marks["sample"] / SV_STEPS
    print(f"[48] Step-Video-T2V through xDiTParallel: 48 blocks, dim 6144, 48 heads of 128, {n_params / 1e9:.3f}B "
          f"parameters, {weight_bytes / 1e9:.2f} GB ({weight_bytes / 2**30:.2f} GiB) of bf16 weights drawn on the card "
          f"layer by layer with the prompt encoder in {build_s:.1f} s; {pcfg.num_frames} x {pcfg.height} x "
          f"{pcfg.width}: {pcfg.tokens} tokens, {SV_TXT} text tokens, {SV_STEPS} steps at CFG {pcfg.guidance_scale}: "
          f"latents {tuple(lat.shape)} finite, std {std:.4f}; {total:.4f} s a request (CUDA events: prompt "
          f"{total - marks['sample']:.4f} s, {SV_STEPS} steps {marks['sample']:.4f} s = {s_step:.4f} s/step); "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB; kernel 1 {counts['flash_attn_with_lse']} launches")
    phases = {"step-video-t2v": {"s_per_request": total, "s_per_step": s_step, "build_s": build_s,
                                 "weight_bytes": weight_bytes, "parameters": n_params,
                                 "max_memory_allocated_gib": peak, "launches": counts}}
    del runner, pipe, lat, l32
    return phases, {"flash": flash_rows, "quant": quant_rows, "ring": ring_rows, "cring": cring_rows}


def sv_tokens(size):
    """The video tokens of a Step-Video request of ``size``."""
    from compactfusion_tpu_torch.models.stepvideo import stepvideo_t2v
    from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipelineConfig

    return StepVideoPipelineConfig(model=stepvideo_t2v(), **size).tokens


def build_sv_cut(dev):
    """Phase 49's model: Step-Video at full width cut to :data:`SV_CUT`
    blocks, seeded weights (seed 0), the scale-shift tables spiced."""
    import dataclasses

    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.stepvideo import init_stepvideo, stepvideo_t2v

    mcfg = dataclasses.replace(stepvideo_t2v(), depth=SV_CUT)
    return mcfg, _spiced_tables(init_stepvideo(torch.Generator(device=dev).manual_seed(0), mcfg),
                                np.random.default_rng(99))


def sv_cut_pipeline(mcfg, params, dev, size, mesh=None, **kw):
    """Phase 49's pipeline at ``size``: :data:`SV_CUT_STEPS` steps, CFG 9."""
    from compactfusion_tpu_torch.pipelines.stepvideo import StepVideoPipeline, StepVideoPipelineConfig

    return StepVideoPipeline(params, StepVideoPipelineConfig(model=mcfg, num_steps=SV_CUT_STEPS, **size, **kw), dev,
                             mesh=mesh)


def sv_cut_request(pipe, seed):
    """Phase 49's request from ``seed``: [cond, uncond] text states at width
    6,144 and the noise; returns (latents, seconds)."""
    import torch

    g = torch.Generator(device=pipe.device).manual_seed(seed)
    txt = torch.randn((2, 1, SV_TXT, 6144), generator=g, device=pipe.device)
    return _events_s(lambda: pipe(txt, generator=g))


def sv_rank(rank, world, runs):
    """One rank of phase 49 (``spawn_local`` on this GPU, gloo): per run
    (name, size, ParallelConfig kwargs, CompactConfig codec or None, and
    optionally True: kernel 1 swapped for its plain twin) the cut request
    from seed 1 with every count set to 0 before it; returns per run what
    :func:`ring_rank` returns."""
    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.config import CompactConfig, CompressType, ParallelConfig
    from compactfusion_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    mcfg, params = build_sv_cut(dev)
    out = {}
    for name, size, par, codec, *plain in runs:
        parallel = ParallelConfig(**par)
        kw = {}
        if codec is not None:
            kw["compact"] = CompactConfig(enabled=True, warmup_steps=SV_CUT_WARMUP, residual=1, error_feedback=True,
                                          fastpath=True, check_consistency=True, compress_type=CompressType(codec))
        pipe = sv_cut_pipeline(mcfg, params, dev, size, mesh=make_mesh(parallel), parallel=parallel, **kw)
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        with plain_attention() if plain and plain[0] else contextlib.nullcontext():
            lat, sec = sv_cut_request(pipe, 1)
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "wire_bytes": _counter("ring_shift.nbytes"),
                     "all_to_all_bytes": _counter("Mesh.all_to_all.nbytes"),
                     "gather_bytes": _counter("Mesh.all_gather_tree.nbytes"),
                     "consistency_dev": compact_ring.max_consistency_dev, "skips": None, "s_per_image": sec}
        del pipe
    return out


def stepvideo_ring_phase(kernels, dev):
    """Phase 49: Step-Video at full width cut to :data:`SV_CUT` blocks,
    :data:`SV_CUT_STEPS` steps (warmup 1, the consistency check on), in one
    spawn of 2 gloo processes on this card: at 544 x 992 x 34 TP 2 (every
    attention projection split by heads, the ffn Megatron-split), U2, cfg 2,
    ring 2 lossless unfused and fused (kernel 7), ring 2 BINARY unfused
    (kernels 2 and 3), also with kernel 1 swapped for its twin; at 512 x 512
    x 17 ring 2 BINARY unfused and fused (kernel 8).  One process runs each
    size first, also with kernel 1 swapped for its twin (the bf16 order
    floor).  Lossless runs within max(RING_REL_MAX, ORDER_FLOOR_FACTOR x
    the floor) of one process, fused within that of unfused; compressed 0 <
    err <= :data:`SV_BINARY_REL_MAX` from lossless and within the lossless
    bound of the same BINARY ring on kernel 1's twin (544 x 992) or unfused
    (512 x 512), EF deviation 0; exact launch counts; the Ulysses
    all-to-all bytes the shapes imply.  Returns the phases."""
    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    S, W, L = SV_CUT_STEPS, SV_CUT_WARMUP, SV_CUT
    mcfg, params = build_sv_cut(dev)
    refs = {}
    for key, size in (("cut", SV_CUT_SIZE), ("fused", SV_FUSED_SIZE)):
        pipe = sv_cut_pipeline(mcfg, params, dev, size)
        _reset_counters()
        lat, sec = sv_cut_request(pipe, 1)
        _check_counts(f"[49] step-video {key}, one process", _counts(kernels), {"flash_attn_with_lse": L * S})
        with plain_attention():
            plain, _ = sv_cut_request(pipe, 1)
        one, plain = lat.float().cpu().numpy(), plain.float().cpu().numpy()
        floor = _rel_np(plain, one)
        refs[key] = {"one": one, "floor": floor, "bound": max(RING_REL_MAX, ORDER_FLOOR_FACTOR * floor)}
        print(f"[49] Step-Video cut to {L} blocks (full width, {size}: {pipe.cfg.tokens} tokens, {S} steps), one "
              f"process: {sec:.4f} s; kernel 1 swapped for its twin: rel err {floor:.6g}; lossless bound "
              f"{refs[key]['bound']:.6g}")
        del pipe
    del params
    ring2, fused2 = {"ring_degree": 2}, {"ring_degree": 2, "use_fused_ring": True}
    runs = [("sv tp2", SV_CUT_SIZE, {"tp_degree": 2}, None),
            ("sv u2", SV_CUT_SIZE, {"ulysses_degree": 2}, None),
            ("sv cfg2", SV_CUT_SIZE, {"cfg_degree": 2}, None),
            ("sv ring2 lossless", SV_CUT_SIZE, ring2, None),
            ("sv ring2 lossless fused", SV_CUT_SIZE, fused2, None),
            ("sv ring2 binary", SV_CUT_SIZE, ring2, "binary"),
            ("sv ring2 binary twin", SV_CUT_SIZE, ring2, "binary", True),
            ("sv 512 ring2 binary", SV_FUSED_SIZE, ring2, "binary"),
            ("sv 512 ring2 binary fused", SV_FUSED_SIZE, fused2, "binary")]
    t0 = time.perf_counter()
    two = spawn_local(sv_rank, 2, "gloo", runs, threads=2)
    spawn_s = time.perf_counter() - t0
    phases = {}
    for name, size, par, codec, *plain in runs:
        ref = refs["fused" if size is SV_FUSED_SIZE else "cut"]
        hops = 2 * L
        # an unfused hop of 384 keys (512 x 512) takes the math path: the
        # routing contract sends kernel 1 no call with fewer than 512 keys
        hop_flash = 0 if plain or size is SV_FUSED_SIZE else hops
        if "fused" in name and codec is None:
            want = {"ring_flash_attn_with_lse": hops * S}
        elif "fused" in name:
            want = {"flash_attn_with_lse": hop_flash * W, "compact_ring_flash": hops * (S - W),
                    "ef_update_slot": hops * (S - W)}
        elif "ring2" in name:
            want = {"flash_attn_with_lse": hop_flash * S}
            if codec is not None:
                want.update({f"{codec}_quant_fastpath": hops * (S - W), f"{codec}_dequant_fastpath": hops * (S - W)})
        else:
            want = {"flash_attn_with_lse": L * S}
        want = dict({WIDE: 0}, **want)
        if codec is not None:
            mate = {"sv ring2 binary": "sv ring2 binary twin"}.get(name, name[:-6] if name.endswith("fused") else None)
            more = [] if mate is None else [(mate, two[0][mate]["latents"], ref["bound"])]
            phases[name] = ring_phase(49, two, name, ref["one"], want, SV_BINARY_REL_MAX, more, low=0.0)
            if phases[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"{name}: EF caches differ across ranks")
        else:
            more = [(name[:-6], two[0][name[:-6]]["latents"], ref["bound"])] if name.endswith("fused") else []
            phases[name] = ring_phase(49, two, name, ref["one"], want, ref["bound"], more)
        phases[name]["latent_rel_err_order_floor"] = ref["floor"]
    # TP 2: three all-reduces a block and step (attention out, cross out, ffn)
    # of the rank's (B2, 3,162, 6,144) bf16 partial sums; U2: four
    # all-to-alls a block and step of half of (B2, 1,581, 6,144) bf16 each
    tokens = sv_tokens(SV_CUT_SIZE)
    want_a2a = L * S * 4 * (2 * (tokens // 2) * 6144 * 2) // 2
    a2a = sorted({r["sv u2"]["all_to_all_bytes"] for r in two})
    print(f"[49] U2 all-to-all bytes per rank {a2a}, expected {want_a2a}; the spawn took {spawn_s:.1f} s")
    if a2a != [want_a2a]:
        raise AssertionError("[49] Step-Video's Ulysses all-to-alls sent other bytes")
    return phases


def tile_checks(flash, rf, timing, dev, gen, dtype):
    """Phase 50's cases on ``dtype`` q/k/v, each a (kernel, name, check)
    whose check returns its rows: kernel 1 at d 576 and 1024, kernel 4 at
    d 256 (w 64 and 0), kernel 7 and kernel 8 (BINARY K1, fp32 bases) at
    d 256 on a ring of 2, each timed beside SDPA.  The checks hold out and
    LSE to :func:`_limits` and kernel 8's stacks and reconstructions bit for
    bit (:func:`check_compact_ring`)."""
    import torch

    tag = "fp32" if dtype == torch.float32 else "bf16"

    def rnd(b, s, h, d):
        return lambda: tuple(torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype) for _ in range(3))

    def ring_make():
        shards = [rnd(1, 1024, 8, 256)() for _ in range(2)]
        return shards[0][0], [(shards[0][1], shards[0][2]), (shards[1][1].contiguous(), shards[1][2].contiguous())]

    def flash_case(h, d):
        name = f"{tag} B1 H{h} S2048 d{d}"
        return ("kernel 1", name, lambda: check_flash(flash, timing, dev, gen, [(name, rnd(1, 2048, h, d), 5)],
                                                      phase=50))

    def window_case(w):
        name = f"{tag} B1 H8 S2048 d256 w{w}"
        return ("kernel 4", name, lambda: check_window(flash, dev, gen, [(name, rnd(1, 2048, 8, 256), w)], timing,
                                                       phase=50)[0])

    return [flash_case(4, 576), flash_case(2, 1024), window_case(WINDOW), window_case(0),
            ("kernel 7", f"{tag} ring 2 B1 H8 Sq1024 Sk2x1024 d256",
             lambda: check_ring_flash(rf, flash, timing, dev, gen, [((2, 1, 1024), ring_make)], phase=50)),
            ("kernel 8", f"{tag} ring 2 B1 H8 S1024 d256 binary K1",
             lambda: [check_compact_ring(rf, flash, timing, dev, gen, 2, 1, 1024, "binary", -1, False, 8, 256,
                                         phase=50, dtype=dtype)])]


def check_tile_kernels(flash, rf, timing, dev, gen):
    """Phase 50: kernel 1 above d = 512 and kernels 4, 7 and 8 above
    d = 128, which no model path runs, in bf16 and in fp32 against their
    twins (TF32 off) at :func:`tile_checks`' cases: on :data:`TILE_BODY`,
    out within :func:`_limits`' bounds and, relative, within
    FLASH_OUT_REL_MAX (bf16) or :data:`TILE_F32_REL_MAX` (fp32), LSE within
    FLASH_LSE_ATOL or F32_LSE_ATOL.  Returns the rows by dtype and
    kernel."""
    import torch

    kinds = {"kernel 1": "flash", "kernel 4": "window", "kernel 7": "ring", "kernel 8": "cring"}
    got = {}
    for dtype, rel_max in ((torch.bfloat16, FLASH_OUT_REL_MAX), (torch.float32, TILE_F32_REL_MAX)):
        rows = got[dtype] = {kind: [] for kind in kinds.values()}
        for what, name, check in tile_checks(flash, rf, timing, dev, gen, dtype):
            for r in check():
                if r["plan"][0] != TILE_BODY or not r["rel_err_out"] <= rel_max:
                    raise AssertionError(f"[50] {what} {r['shape']}: plan {r['plan']}, rel err {r['rel_err_out']} "
                                         f"(body {TILE_BODY}, bound {rel_max})")
                rows[kinds[what]].append(r)
    print(f"[50] {TILE_BODY} above the register body, bf16 and fp32: kernels 1, 4, 7 and 8 within "
          f"{FLASH_OUT_REL_MAX} (bf16) and {TILE_F32_REL_MAX} (fp32) of their twins (relative)")
    return got


# -- 51.-52. quality eval, ddpm_step, tensor_viz; the last two examples --------

#: the extractors' fp32 features on the card against the CPU's (the
#: north star's fp32 bound)
FEATURE_REL_MAX = 2e-4
#: PSNR and SSIM on the card against the CPU's, relative
METRIC_CARD_REL_MAX = 1e-4
#: the extractors' batches: InceptionV3 at B8 x 299^2, VGG16-LPIPS at B2
#: pairs of 512^2, I3D at B2 x 16 x 224^2
INCEPTION_B, LPIPS_PAIRS, I3D_B = 8, 2, 2
#: phase 52's PixArt runs (per-layer plan, all-BINARY, lossless) at ring 4
EXAMPLE_STEPS = 10
EXAMPLE_RING = 4
#: the external USP example's tokens on the card: a hop's 512 keys meet
#: kernel 1's routing contract
USP_SEQ = 1024


def _spiced_biases(tree, gen):
    """Every conv bias of an extractor tree drawn from N(0, 0.1^2) (the
    seeded trees' biases are 0, which a BatchNorm fold never leaves)."""
    import torch

    for p in tree.values():
        p["b"] = torch.randn(p["b"].shape, generator=gen, device=p["b"].device) * 0.1
    return tree


def _to_cpu(tree):
    return {k: {n: t.cpu() for n, t in p.items()} for k, p in tree.items()}


def _time_batch_ms(fn, iters=3):
    """ms a call by CUDA events after one warm call, and the peak memory
    (GiB) of the calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / iters, torch.cuda.max_memory_allocated() / 2**30


def _card_vs_cpu(what, card, cpu, bound):
    import torch

    rel = (torch.linalg.vector_norm(card.cpu().double() - cpu.double())
           / torch.linalg.vector_norm(cpu.double())).item()
    if not rel <= bound:
        raise AssertionError(f"[51] {what}: card vs CPU rel err {rel} > {bound}")
    return rel


def quality_phase(kernels, dev, images, video, eig):
    """Phase 51: the eval extractors in fp32 on the card on seeded weights
    (InceptionV3 B8 x 299^2, VGG16-LPIPS B2 pairs at 512^2, I3D B2 x 16 x
    224^2), sample 0 of each against the same module on the CPU within
    FEATURE_REL_MAX, ms per batch and peak memory; PSNR, SSIM and LPIPS of
    every compressed image of phases 4-7 against phase 3's lossless image
    of the same seed (``images``: name -> (1, 512, 512, 3) on the card,
    "lossless" among them), PSNR and SSIM within METRIC_CARD_REL_MAX of the
    CPU's; ``video_psnr``, ``video_ssim`` and I3D features on a 16-frame
    224^2 centre crop of phase 44's Latte video (``video``) against its
    8-bit round trip; ``ddpm_step`` converging on the card; phase 43's
    eigenvalue dump (``eig``) through ``tensor_viz.energy_curves``.  No
    kernel of the port is on this path (the JAX package left these convs to
    XLA; here they are cuDNN's): every count must stay 0.  Returns the
    phase's numbers."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.eval import i3d, inception, metrics, vgg
    from compactfusion_tpu_torch.schedulers import diffusion
    from compactfusion_tpu_torch.utils import tensor_viz

    _reset_counters()
    gen = torch.Generator(device=dev).manual_seed(51)
    inc = _spiced_biases(inception.init_inception_v3(gen), gen)
    seeded = _spiced_biases(vgg.init_vgg16(gen), gen)
    # the seeded VGG16 goes through the converter a user loads weights with,
    # from a torchvision-named state dict, onto the card by default
    vgg_p = vgg.convert_vgg16({f"features.{idx}.{leaf}": seeded[f"conv{idx}"][k].cpu().numpy()
                               for idx, _, _ in vgg.VGG16_CONVS for k, leaf in (("w", "weight"), ("b", "bias"))})
    if not all(p[k].is_cuda and torch.equal(p[k], seeded[n][k]) for n, p in vgg_p.items() for k in p):
        raise AssertionError("[51] convert_vgg16 did not put the seeded weights on the card bit for bit")
    del seeded
    i3d_p = _spiced_biases(i3d.init_i3d(gen), gen)
    lossless = images["lossless"]
    codecs_ = [k for k in images if k != "lossless"]
    # -- the extractors: card against CPU, ms per batch -----------------------
    x_inc = torch.rand((INCEPTION_B, 299, 299, 3), generator=gen, device=dev) * 2 - 1
    feats, inc_ms, inc_gib = _time_batch_ms(lambda: inception.inception_pool_features(inc, x_inc))
    inc_rel = _card_vs_cpu("InceptionV3 pool features", feats[:1],
                           inception.inception_pool_features(_to_cpu(inc), x_inc[:1].cpu()), FEATURE_REL_MAX)
    lpips = vgg.make_lpips(vgg_p)
    pairs = [images[k] for k in codecs_[:LPIPS_PAIRS]]
    a = torch.cat([lossless] * LPIPS_PAIRS) * 2 - 1
    b = torch.cat(pairs) * 2 - 1
    d, vgg_ms, vgg_gib = _time_batch_ms(lambda: lpips(a, b))
    with torch.no_grad():
        taps = torch.cat([t.flatten() for t in vgg.vgg16_features(vgg_p, a[:1])])
        cpu_taps = torch.cat([t.flatten() for t in vgg.vgg16_features(_to_cpu(vgg_p), a[:1].cpu())])
    vgg_rel = _card_vs_cpu("VGG16's five LPIPS taps", taps, cpu_taps, FEATURE_REL_MAX)
    lpips_rel = _card_vs_cpu("LPIPS", d[:1], vgg.make_lpips(_to_cpu(vgg_p))(a[:1].cpu(), b[:1].cpu()),
                             FEATURE_REL_MAX)
    del taps, cpu_taps
    f, h, w = video.shape[1:4]
    top, left = (h - 224) // 2, (w - 224) // 2
    crop = video[:1, :16, top:top + 224, left:left + 224].float()
    crop8 = torch.round(crop * 255) / 255  # what an 8-bit file of the video holds
    clips = torch.cat([crop, crop8])[:I3D_B] * 2 - 1
    logits, i3d_ms, i3d_gib = _time_batch_ms(lambda: i3d.i3d_features(i3d_p, clips))
    i3d_rel = _card_vs_cpu("I3D logits", logits[:1], i3d.i3d_features(_to_cpu(i3d_p), clips[:1].cpu()),
                           FEATURE_REL_MAX)
    pre = i3d.i3d_features(i3d_p, clips, pre_logits=True)
    for what, t, shape in (("inception", feats, (INCEPTION_B, 2048)), ("lpips", d, (LPIPS_PAIRS,)),
                           ("i3d", logits, (I3D_B, 400)), ("i3d pre-logits", pre, (I3D_B, 1024))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"[51] {what}: {tuple(t.shape)}, finite {bool(torch.isfinite(t).all())}")
    print(f"[51] extractors in fp32 on the card (seeded weights, TF32 off): InceptionV3 B{INCEPTION_B} x 299^2 "
          f"{inc_ms:.3f} ms/batch (peak {inc_gib:.2f} GiB), card vs CPU {inc_rel:.3g}; VGG16-LPIPS "
          f"{LPIPS_PAIRS} pairs at 512^2 {vgg_ms:.3f} ms/batch (peak {vgg_gib:.2f} GiB), card vs CPU {vgg_rel:.3g} "
          f"(the taps), {lpips_rel:.3g} (the distance); "
          f"I3D B{I3D_B} x 16 x 224^2 {i3d_ms:.3f} ms/batch (peak {i3d_gib:.2f} GiB), card vs CPU {i3d_rel:.3g} "
          f"(bound {FEATURE_REL_MAX})")
    # -- PSNR, SSIM, LPIPS per codec against the lossless image ----------------
    per_codec = {}
    for name in ["lossless"] + codecs_:
        img = images[name]
        p_card, s_card = metrics.psnr(img, lossless).item(), metrics.ssim(img, lossless).item()
        p_cpu, s_cpu = metrics.psnr(img.cpu(), lossless.cpu()).item(), metrics.ssim(img.cpu(), lossless.cpu()).item()
        lp = lpips(img * 2 - 1, lossless * 2 - 1).item()
        for what, card, cpu in (("PSNR", p_card, p_cpu), ("SSIM", s_card, s_cpu)):
            if not abs(card - cpu) <= METRIC_CARD_REL_MAX * abs(cpu):
                raise AssertionError(f"[51] {name}: {what} {card} on the card, {cpu} on the CPU")
        if name == "lossless":
            ok = p_card == 120.0 and abs(s_card - 1) <= 1e-6 and lp == 0.0
        else:
            ok = np.isfinite(p_card) and p_card < 120.0 and s_card < 1.0 and lp > 0.0
        if not ok:
            raise AssertionError(f"[51] {name} vs lossless: PSNR {p_card}, SSIM {s_card}, LPIPS {lp}")
        per_codec[name] = {"psnr_db": p_card, "ssim": s_card, "lpips_seeded_vgg": lp}
        print(f"[51] {name} vs the lossless image (seed 1): PSNR {p_card:.4f} dB, SSIM {s_card:.6f}, LPIPS "
              f"(seeded VGG16) {lp:.6g}; card vs CPU PSNR {abs(p_card - p_cpu) / abs(p_cpu):.2g}, SSIM "
              f"{abs(s_card - s_cpu) / abs(s_cpu):.2g} relative")
    # -- the video metrics on phase 44's Latte video ---------------------------
    vp, vs = metrics.video_psnr(crop8, crop).item(), metrics.video_ssim(crop8, crop).item()
    vp_cpu, vs_cpu = metrics.video_psnr(crop8.cpu(), crop.cpu()).item(), metrics.video_ssim(crop8.cpu(), crop.cpu()).item()
    if not (abs(vp - vp_cpu) <= METRIC_CARD_REL_MAX * vp_cpu and abs(vs - vs_cpu) <= METRIC_CARD_REL_MAX * vs_cpu
            and 40.0 < vp < 120.0 and 0.9 < vs < 1.0 and metrics.video_psnr(crop, crop).item() == 120.0):
        raise AssertionError(f"[51] Latte video crop vs its 8-bit round trip: PSNR {vp} ({vp_cpu} on the CPU), "
                             f"SSIM {vs} ({vs_cpu})")
    fd = (logits[0] - logits[1]).norm().item()
    print(f"[51] Latte-1 video (phase 44), 16 x 224^2 centre crop vs its 8-bit round trip: video_psnr {vp:.4f} dB, "
          f"video_ssim {vs:.6f} (CPU {vp_cpu:.4f}, {vs_cpu:.6f}); I3D logits finite, |diff| {fd:.4g}")
    # -- ddpm_step on the card ------------------------------------------------
    n = 25
    sched = diffusion.ddpm_schedule(n)
    g = torch.Generator(device=dev).manual_seed(0)
    # x0 inside [-1, 1], the range DDPM's clip of its x0 prediction assumes
    x0 = torch.rand((4, 8), generator=g, device=dev) * 1.8 - 0.9
    a0 = sched.alphas_cumprod[int(sched.timesteps[0])].item()
    x = a0**0.5 * x0 + (1 - a0) ** 0.5 * torch.randn((4, 8), generator=g, device=dev)
    for i in range(n):
        a = sched.alphas_cumprod[int(sched.timesteps[i])].item()
        x = diffusion.ddpm_step(sched, i, n, x, (x - a**0.5 * x0) / (1 - a) ** 0.5, g)
    ddpm_rel = (torch.linalg.vector_norm(x - x0) / torch.linalg.vector_norm(x0)).item()
    if not (x.is_cuda and ddpm_rel < 0.35):
        raise AssertionError(f"[51] ddpm_step with the exact eps: rel err {ddpm_rel} to x0 (bound 0.35)")
    print(f"[51] ddpm_step, {n} ancestral steps with the exact eps on the card: rel err to x0 {ddpm_rel:.3g} "
          f"(bound 0.35)")
    # -- phase 43's spectra through tensor_viz ---------------------------------
    curves = {}
    if eig["_shapes"] != {key: list(CHUNK) for key in ("k-activation", "k-delta")}:
        raise AssertionError(f"[51] the dump records the shapes {eig['_shapes']}, not {CHUNK}")
    for key, rows in eig.items():
        if key == "_shapes":
            continue
        e = tensor_viz.energy_curves(rows, eig["_shapes"][key])
        cum = np.stack([c for _, c in e["curves"]])
        if not (e["k"] == 64 and np.isfinite(cum).all() and (np.diff(cum, axis=1) >= 0).all()
                and np.allclose(cum[:, -1], 1.0)):
            raise AssertionError(f"[51] tensor_viz curves of {key}: k {e['k']}")
        curves[key] = {"energy_at_rank_4": float(cum[:, 3].mean()), "energy_at_rank_16": float(cum[:, 15].mean()),
                       "baseline_at_rank_4": float(e["baseline"][3]), "curves": len(e["curves"])}
        print(f"[51] tensor_viz.energy_curves({key}, top {e['k']} of {e['of']}, a {CHUNK[0]} x {CHUNK[1]} matrix): "
              f"{len(e['curves'])} curves, mean "
              f"energy within the top 64 at rank 4 {curves[key]['energy_at_rank_4']:.4f}, at rank 16 "
              f"{curves[key]['energy_at_rank_16']:.4f}; iid-Gaussian baseline at rank 4 "
              f"{curves[key]['baseline_at_rank_4']:.4f}")
    counts = _counts(kernels)
    _check_counts("[51] the quality eval", counts, {})
    return {"quality eval": {"launches": counts, "feature_card_vs_cpu_rel": {"inception": inc_rel, "vgg16_taps": vgg_rel,
                                                                         "lpips": lpips_rel, "i3d": i3d_rel},
                             "ms_per_batch": {"inception_b8_299": inc_ms, "lpips_2pairs_512": vgg_ms,
                                              "i3d_b2_16x224": i3d_ms},
                             "peak_gib": {"inception": inc_gib, "lpips": vgg_gib, "i3d": i3d_gib},
                             "per_codec": per_codec, "latte_crop_vs_8bit": {"video_psnr_db": vp, "video_ssim": vs},
                             "ddpm_rel_err": ddpm_rel, "tensor_viz": curves}}


def examples_rank(rank, world, lossless_argv, binary_argv, per_layer_argv):
    """One rank of phase 52: the torchrun environment, then
    ``external_usp_example.main`` at USP_SEQ tokens; PixArt-alpha 512 at
    full width cut to SP_CUT blocks (AdaLN spiced) at ring EXAMPLE_RING
    through ``xDiTParallel``, lossless and all-BINARY, one request each;
    then ``per_layer_schedule_example.main`` with the EF consistency check
    on.  Every launch count set to 0 before each; returns the USP error,
    the latents, the counts and the EF deviation of each run."""
    import gc

    import torch

    from compactfusion_tpu_torch.compact import ring as compact_ring
    from compactfusion_tpu_torch.examples import external_usp_example, per_layer_schedule_example
    from compactfusion_tpu_torch.models import pixart as model_pixart
    from compactfusion_tpu_torch.parallel_api import xDiTParallel

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    init = model_pixart.init_pixart
    model_pixart.init_pixart = lambda generator, cfg: spice_pixart(init(generator, cfg))
    kernels = port_kernels()
    out = {}
    _reset_counters()
    t0 = time.perf_counter()
    err = external_usp_example.main(seq_len=USP_SEQ)
    torch.cuda.synchronize()
    out["usp"] = {"rel_err": err, "launches": _counts(kernels), "s": time.perf_counter() - t0}
    for name, argv in (("lossless", lossless_argv), ("binary", binary_argv)):
        with pixart_depth(SP_CUT):
            runner = xDiTParallel(*_cli(argv).create_config())
        _reset_counters()
        compact_ring.max_consistency_dev = 0.0
        t0 = time.perf_counter()
        lat = runner(decode=False)
        torch.cuda.synchronize()
        out[name] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels),
                     "consistency_dev": compact_ring.max_consistency_dev, "s": time.perf_counter() - t0}
        del runner, lat
        gc.collect()
        torch.cuda.empty_cache()
    _reset_counters()
    compact_ring.max_consistency_dev = 0.0
    t0 = time.perf_counter()
    with pixart_depth(SP_CUT):
        lat, saved = per_layer_schedule_example.main(per_layer_argv, check_consistency=True)
    torch.cuda.synchronize()
    out["per_layer"] = {"latents": lat.float().cpu().numpy(), "launches": _counts(kernels), "saved": saved,
                        "consistency_dev": compact_ring.max_consistency_dev, "s": time.perf_counter() - t0}
    return out


def examples_phase():
    """Phase 52: both examples' ``main`` in one spawn of 4 gloo processes on
    the card (:func:`examples_rank`): the external USP example at U2 x R2
    within its 2e-5 through kernel 1's fp32 route (one launch a ring hop);
    PixArt-alpha 512 cut to SP_CUT blocks at ring EXAMPLE_RING, EXAMPLE_STEPS
    steps: the per-layer plan (warmup 2, layers 0-1 IDENTITY, BINARY after)
    with finite latents equal on every rank, the launches of kernels 1, 2
    and 3 the plan implies (its warm-up and its generate call), EF deviation
    0, within COMPRESSED_REL_ERR_MAX of lossless; the all-BINARY run (warmup
    2) likewise, and apart from the plan's (err > 0)."""
    import numpy as np

    from compactfusion_tpu_torch.examples import external_usp_example, per_layer_schedule_example as plan
    from compactfusion_tpu_torch.parallel.mesh import spawn_local

    ring = PIXART_ARGV + ["--ring_degree", str(EXAMPLE_RING), "--num_inference_steps", str(EXAMPLE_STEPS),
                          "--output_type", "latent"]
    binary = ring + ["--compact", "--compact_type", "binary", "--compact_warmup_steps", str(plan.WARMUP_STEPS)]
    t0 = time.perf_counter()
    ranks = spawn_local(examples_rank, 4, "gloo", ring, binary, ring, threads=2)
    spawn_s = time.perf_counter() - t0
    # -- the external USP example ---------------------------------------------
    hops = external_usp_example.RING
    for r, res in enumerate(ranks):
        usp = res["usp"]
        _check_counts(f"[52] external USP rank {r}", usp["launches"],
                      {"flash_attn_with_lse": hops, F32["flash_attn_with_lse"]: hops})
        if not usp["rel_err"] < external_usp_example.REL_MAX:
            raise AssertionError(f"[52] external USP rank {r}: rel err {usp['rel_err']}")
    print(f"[52] external_usp_example.main (a toy nn.Module block, U{external_usp_example.ULYSSES} x "
          f"R{external_usp_example.RING}, {USP_SEQ} tokens, fp32) in 4 gloo processes: rel err vs one device "
          f"{', '.join(f'{res['usp']['rel_err']:.3g}' for res in ranks)} (bound {external_usp_example.REL_MAX}); "
          f"kernel 1's fp32 route {hops} launches a rank")
    # -- the per-layer plan against lossless and all-BINARY --------------------
    from compactfusion_tpu_torch.ops.attention import _flash_shape_ok

    depth, comp = SP_CUT, EXAMPLE_STEPS - plan.WARMUP_STEPS
    # a hop's q and K/V: the CFG batch's 1,024 / R tokens, 16 heads of 72;
    # at ring 4 its 256 keys are under kernel 1's routing contract (the
    # plain math path attends), at ring 2 they meet it
    local = (2, 1024 // EXAMPLE_RING, 16, 72)
    per_hop = depth * EXAMPLE_STEPS * EXAMPLE_RING * int(_flash_shape_ok(local, local))
    binary_layers = depth - plan.LOSSLESS_LAYERS

    def quant(layers, requests):  # a rank encodes its K and V, decodes R - 1 of each
        return {"binary_quant_fastpath": requests * 2 * layers * comp,
                "binary_dequant_fastpath": requests * 2 * (EXAMPLE_RING - 1) * layers * comp}

    expect = {"lossless": {"flash_attn_with_lse": per_hop},
              "binary": {"flash_attn_with_lse": per_hop, **quant(depth, 1)},
              "per_layer": {"flash_attn_with_lse": 2 * per_hop, **quant(binary_layers, 2)}}
    lossless = ranks[0]["lossless"]["latents"]
    phases = {}
    for name in ("lossless", "binary", "per_layer"):
        lat = ranks[0][name]["latents"]
        for r, res in enumerate(ranks):
            _check_counts(f"[52] {name} rank {r}", res[name]["launches"], {**_with_routes(expect[name]), WIDE: 0})
            if not np.array_equal(res[name]["latents"], lat) or res[name]["consistency_dev"] != 0.0:
                raise AssertionError(f"[52] {name} rank {r}: latents differ from rank 0's or EF deviation "
                                     f"{res[name]['consistency_dev']}")
        if not np.isfinite(lat).all():
            raise AssertionError(f"[52] {name}: non-finite latents")
        rel = _rel_np(lat, lossless)
        if name != "lossless" and not 0.0 < rel <= COMPRESSED_REL_ERR_MAX:
            raise AssertionError(f"[52] {name}: rel err vs lossless {rel}")
        phases[f"example {name}"] = {"latent_rel_err_vs_lossless": rel, "s": [res[name]["s"] for res in ranks],
                                     "launches": {k: sum(res[name]["launches"][k] for res in ranks)
                                                  for k in ranks[0][name]["launches"]}}
    apart = _rel_np(ranks[0]["per_layer"]["latents"], ranks[0]["binary"]["latents"])
    if not apart > 0.0:
        raise AssertionError("[52] the per-layer plan's latents equal the all-BINARY run's")
    print(f"[52] PixArt-alpha 512 cut to {depth} blocks, ring {EXAMPLE_RING} in 4 gloo processes, {EXAMPLE_STEPS} "
          f"steps: per_layer_schedule_example.main (warmup {plan.WARMUP_STEPS}, layers 0-{plan.LOSSLESS_LAYERS - 1} "
          f"IDENTITY, {binary_layers} BINARY; 2 requests) rel err vs lossless "
          f"{phases['example per_layer']['latent_rel_err_vs_lossless']:.6g}, all-BINARY "
          f"{phases['example binary']['latent_rel_err_vs_lossless']:.6g} (bound {COMPRESSED_REL_ERR_MAX}), plan vs "
          f"all-BINARY {apart:.6g}; EF deviation 0; launches a rank as the plan implies "
          f"({', '.join(f'{k} {v}' for k, v in ranks[0]['per_layer']['launches'].items() if v)}); saved "
          f"{ranks[0]['per_layer']['saved']}; seconds lossless/binary/per-layer "
          f"{ranks[0]['lossless']['s']:.2f}/{ranks[0]['binary']['s']:.2f}/{ranks[0]['per_layer']['s']:.2f}; the spawn "
          f"{spawn_s:.1f} s")
    phases["example external usp"] = {"rel_err": [res["usp"]["rel_err"] for res in ranks],
                                      "launches": {k: sum(res["usp"]["launches"][k] for res in ranks)
                                                   for k in ranks[0]["usp"]["launches"]}}
    phases["example per_layer"]["plan_vs_binary_rel_err"] = apart
    return phases


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on a GPU")
    t_run = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.cache.fast_attn import optimize_plan
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import _build, attention, flash, quant, ring_flash
    from compactfusion_tpu_torch.ops import probes as ops_probes
    from compactfusion_tpu_torch.parallel.mesh import spawn_local
    from compactfusion_tpu_torch.probes import block_parts, flash_parts, timing

    # float32 matmuls and convolutions in full fp32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    secs_by_phase, t_mark = {}, [t_run]

    def mark(key):
        """The seconds since the last mark, as phase ``key``'s."""
        now = time.perf_counter()
        secs_by_phase[key], t_mark[0] = now - t_mark[0], now

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"kernels built in {_build.last_build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    PTXAS.update(_build.ptxas_summary(_build.last_build_log))
    for kernel, said in PTXAS.items():
        print(f"[1] ptxas {kernel}: {said}")

    mark("1")
    # -- 2. kernels vs twins ----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_rows = check_flash(flash, timing, dev, gen)
    flash_rows += check_flash(flash, timing, dev, gen, wgmma_edge_cases(gen, dev))
    window_rows, window_vs_full = check_window(flash, dev, gen)
    quant_rows = {
        "binary": [check_quant(quant, codecs, timing, dev, gen, "binary", r, torch.float32)
                   for r in (-1, 2)]
        + [check_quant(quant, codecs, timing, dev, gen, "binary", -1, torch.float32, (CHUNK[0], 1160))],
        "int2": [check_quant(quant, codecs, timing, dev, gen, "int2", -1, dt)
                 for dt in (torch.float32, torch.bfloat16)]
        + [check_quant(quant, codecs, timing, dev, gen, "int2", -1, torch.float32, (CHUNK[0], 1160))],
    }
    vec_scalar = [quant.QUANT_VEC_BYTES, quant.QUANT_VEC_BYTES, 1]  # C1152, C1152, C1160
    for what, plans in (("binary quant", [r["quant_plan_bytes_per_thread"] for r in quant_rows["binary"]]),
                        ("binary dequant", [r["dequant_plan_bytes_per_thread"] for r in quant_rows["binary"]]),
                        ("int2 quant", [r["quant_plan_bytes_per_thread"] for r in quant_rows["int2"]]),
                        ("int2 dequant", [r["dequant_plan_bytes_per_thread"] for r in quant_rows["int2"]])):
        if plans != vec_scalar:
            raise AssertionError(f"{what} took the plans {plans}: the vector kernel at C=1152, the "
                                 f"scalar one at C=1160 expected")
    floor_ms = launch_floor_ms(ops_probes, timing, dev)
    print(f"[2] empty kernel: {floor_ms:.5f} ms per launch by CUDA graphs (the floor under graph_ms)")
    cross_rows = check_cross_attention(attention, timing, dev, gen)

    mark("2")
    # -- 3. full-width pipeline, compression off -----------------------------
    mcfg, vcfg, params, vae_params = build_models(dev)

    def pipeline(compact=None, **kw):
        if compact is not None:
            kw["compact"] = compact
        return pixart_pipeline(mcfg, vcfg, params, vae_params, dev, **kw)

    pipe = pipeline()
    _reset_counters()
    lossless = None
    secs = []
    for seed in (1, 2, 3):
        before = _counter("flash_attn_with_lse.launches")
        wide_before = _counter("flash_attn_with_lse.wide_launches")
        lat, img, sec = request(pipe, seed)
        lo, hi = check_image(img, f"request seed {seed}")
        launched = _counter("flash_attn_with_lse.launches") - before
        if launched < DEPTH * STEPS:
            raise AssertionError(f"request seed {seed}: flash launched {launched} < {DEPTH * STEPS} times")
        if _counter("flash_attn_with_lse.wide_launches") - wide_before != 1:
            raise AssertionError(f"request seed {seed}: the VAE's attention did not launch the wide body once")
        if any(_counter(f"{fn.__name__}.launches") for fn in kernels[1:]):
            raise AssertionError("compression off, yet a quant or window kernel launched")
        if lossless is None:
            lossless, images = lat, {"lossless": img}
        secs.append(sec)
        print(f"[3] request seed {seed}: image (1, 512, 512, 3) in [{lo:.4f}, {hi:.4f}], "
              f"flash launches {launched}, {sec:.4f} s/image")
    phases = {"lossless": {"s_per_image": secs, "launches": _counts(kernels)}}
    pixart_launches = launched  # kernel 1's launches an image, the VAE's included

    mark("3")
    # -- 4.-7. full-width pipeline, compressed-ring emulations ---------------
    per_layer = CALLS_PER_LAYER
    runs = [
        (4, "ring-8 binary", compressed_config(), [("binary", -1, DEPTH)],
         {"binary_quant_fastpath": DEPTH * per_layer, "binary_dequant_fastpath": DEPTH * per_layer}),
        (5, "ring-8 int2", compressed_config("int2"), [("int2", -1, DEPTH)],
         {"int2_quant_fastpath": DEPTH * per_layer, "int2_dequant_fastpath": DEPTH * per_layer}),
        (6, "ring-8 low-rank r4", compressed_config("low-rank", comp_rank=4), [("low-rank", 4, DEPTH)], {}),
        (7, "ring-8 per-layer plan (int8 EF caches)", layer_plan_config(),
         [("identity", -1, 1), ("int2", -1, 13), ("binary", 2, 14)],
         {"int2_quant_fastpath": 13 * per_layer, "int2_dequant_fastpath": 13 * per_layer,
          "binary_quant_fastpath": 14 * per_layer, "binary_dequant_fastpath": 14 * per_layer}),
    ]
    for phase, what, compact, plan, expect in runs:
        r = compressed_phase(phase, what, pipeline(compact), kernels, lossless, expect)
        images[what] = r.pop("image")
        r["wire_compression_vs_bf16"] = wire_compression(codecs, plan)
        print(f"[{phase}] {what}: wire compression vs dense bf16 K/V {r['wire_compression_vs_bf16']:.2f}x")
        phases[what] = r

    mark("4-7")
    # -- 8.-10. DiTFastAttn: per-(step, layer) method plans, window 64 -------
    def plan_pipeline(plan):
        return pipeline(fast_attn_plan=tuple(tuple(int(m) for m in row) for row in plan),
                        fast_attn_window=WINDOW)

    full_plan = np.zeros((STEPS, DEPTH), np.int32)
    phases["fast-attn all FULL"] = accel_phase(
        8, "fast-attn all FULL", plan_pipeline(full_plan), kernels, lossless,
        *plan_launches(optimize_plan(full_plan)), exact=True)
    mixed = mixed_plan()
    if sorted(set(optimize_plan(mixed).ravel().tolist())) != list(range(7)):
        raise AssertionError("the fixed plan does not hold all seven methods after optimize_plan")
    phases["fast-attn mixed plan"] = accel_phase(
        9, "fast-attn mixed plan (all seven methods)", plan_pipeline(mixed), kernels, lossless,
        *plan_launches(optimize_plan(mixed)))

    mark("8-9")
    _reset_counters()
    calibrated, cal_s = calibrated_plan(params, mcfg, vcfg, dev)
    hist = {m: int((calibrated == m).sum()) for m in range(7)}
    cal_launches = _counts(kernels)
    print(f"[10] calibrate_pixart (threshold 0.5, window {WINDOW}): {cal_s:.3f} s; methods "
          f"{hist}; optimized {({m: int((optimize_plan(calibrated) == m).sum()) for m in range(7)})}; "
          f"launches {cal_launches}")
    r = accel_phase(10, "fast-attn calibrated plan", plan_pipeline(calibrated), kernels, lossless,
                    *plan_launches(optimize_plan(calibrated)))
    phases["fast-attn calibrated plan"] = dict(r, calibration_s=cal_s, methods=hist,
                                               calibration_launches=cal_launches)

    mark("10")
    # -- 11. TeaCache / FBCache -------------------------------------------------
    def cache_full(skips):  # blocks 1-27 skipped on a skipped step; + VAE
        return DEPTH * (STEPS - skips) + skips + 1

    for name, mode, thr in (("fbcache 0", "fbcache", 0.0), ("fbcache 1e6", "fbcache", 1e6),
                            ("fbcache 0.12", "fbcache", 0.12), ("teacache 0.25", "teacache", 0.25)):
        r = accel_phase(11, name, pipeline(cache=CacheAccelConfig(mode=mode, threshold=thr)),
                        kernels, lossless, cache_full, 0, exact=thr == 0.0)
        # threshold 0 never skips; 1e6 skips every step but the first (no
        # probe yet) and the forced last
        want = {0.0: 0, 1e6: STEPS - 2}.get(thr, r["skips"])
        if r["skips"] != want:
            raise AssertionError(f"{name}: {r['skips']} skipped steps, expected {want}")
        phases[name] = r

    mark("11")
    # -- 12. the ring kernels vs their twins, one rank's view ------------------
    ring_rows = check_ring_flash(ring_flash, flash, timing, dev, gen)
    ring_rows += check_ring_flash(ring_flash, flash, timing, dev, gen, ring_edge_cases(gen, dev))
    cring_rows = [check_compact_ring(ring_flash, flash, timing, dev, gen, *case) for case in CRING_CASES]

    mark("12")
    # -- 13.-15. the ring across processes that share this GPU ----------------
    # NCCL refuses two ranks on one device, so the ranks join a gloo group
    # and their ring shifts go through host memory; all compute runs here.
    # PixArt cut to its first SP_CUT blocks (full width), as phases 22 and
    # 24-27, whose runs share these two spawns.  First, in this process,
    # request 1 on the cut, then with each CFG half's text path and backbone
    # forward run alone at B1, as a rank of cfg 2 runs its half: what the
    # model's batch alone moves against the B2 request
    import dataclasses

    cut_models = dataclasses.replace(mcfg, depth=SP_CUT), vcfg, _cut_blocks(params, SP_CUT), vae_params
    cut_pipe = pixart_pipeline(*cut_models, dev, steps=RANK_STEPS)
    _reset_counters()
    cut_lat, cut_img, cut_sec = request(cut_pipe, 1)
    check_image(cut_img, "PixArt cut, one process")
    _check_counts("PixArt cut, one process", _counts(kernels), {"flash_attn_with_lse": SP_CUT * RANK_STEPS + 1, WIDE: 1})
    lossless_np = cut_lat.float().cpu().numpy()
    print(f"[13] PixArt-alpha 512 cut to its first {SP_CUT} of {DEPTH} blocks (full width): one process, "
          f"lossless, {cut_sec:.4f} s/image")
    _reset_counters()
    with cfg_halves_apart():
        halves_lat, halves_img, halves_sec = request(cut_pipe, 1)
    check_image(halves_img, "CFG halves at B1")
    halves = (_counter("flash_attn_with_lse.launches"), _counter("flash_attn_with_lse.wide_launches"))
    if halves != (2 * SP_CUT * RANK_STEPS + 1, 1):
        raise AssertionError(f"CFG halves at B1: flash launched {halves[0]} times, {halves[1]} on the wide body")
    halves_np = halves_lat.float().cpu().numpy()
    halves_rel = _rel_np(halves_np, lossless_np)
    print(f"[13] one process, each CFG half's forward at B1 (as a cfg-2 rank runs it): rel err vs the "
          f"B2 request (lossless) {halves_rel:.6f}, {halves_sec:.4f} s/image")
    phases["cfg halves at B1"] = {"latent_rel_err_vs_lossless": halves_rel, "s_per_image": halves_sec,
                                  "launches": _counts(kernels)}
    halves_ref = ("the CFG halves at B1", halves_np, HALVES_REL_MAX)
    # the single-process emulation of the ring: same codec, chunking and batch
    _reset_counters()
    sim_lat, sim_img, sim_sec = request(pixart_pipeline(
        *cut_models, dev, steps=RANK_STEPS, compact=ring_compact("binary", comp_rank=-1, simulate_ring=2)), 1)
    check_image(sim_img, "ring-2 emulation")
    sim_np = sim_lat.float().cpu().numpy()
    print(f"[14] single-process ring-2 binary emulation: rel err vs lossless "
          f"{_rel_np(sim_np, lossless_np):.6f}, vs the CFG halves at B1 {_rel_np(sim_np, halves_np):.6f}, "
          f"{sim_sec:.4f} s/image")
    del cut_pipe, cut_lat, cut_img, halves_lat, halves_img, sim_lat, sim_img
    sim_ref = ("the ring-2 emulation", sim_np, RING_REL_MAX)
    pixart_two, pixart_four, pixart_spawn_secs = pixart_spawns(spawn_local)
    two, four = pixart_two, pixart_four
    hops, comp_steps = 2 * SP_CUT, RANK_STEPS - WARMUP  # ring 2: two hops per self-attention
    # no ring: each rank runs the model on its CFG half, which the one-process
    # run above does too
    phases["cfg2 lossless"] = ring_phase(13, two, "cfg2 lossless", lossless_np,
                                         {"flash_attn_with_lse": SP_CUT * RANK_STEPS + 1}, RING_REL_MAX,
                                         [("the CFG halves at B1", halves_np, CFG2_VS_HALVES_MAX)])
    phases["ring2 lossless"] = ring_phase(13, two, "ring2 lossless", lossless_np,
                                          {"flash_attn_with_lse": hops * RANK_STEPS + 1}, RING_REL_MAX,
                                          [halves_ref])
    phases["ring2 lossless fused"] = ring_phase(
        13, two, "ring2 lossless fused", lossless_np,
        {"flash_attn_with_lse": 1, "ring_flash_attn_with_lse": hops * RANK_STEPS}, RING_REL_MAX, [halves_ref])
    phases["ring2 binary"] = ring_phase(
        14, two, "ring2 binary", lossless_np,
        {"flash_attn_with_lse": hops * RANK_STEPS + 1, "binary_quant_fastpath": hops * comp_steps,
         "binary_dequant_fastpath": hops * comp_steps}, COMPRESSED_REL_ERR_MAX, [sim_ref, halves_ref],
        low=0.0)
    phases["ring2 binary fused"] = ring_phase(
        14, two, "ring2 binary fused", lossless_np,
        {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp_steps,
         "ef_update_slot": hops * comp_steps}, COMPRESSED_REL_ERR_MAX, [sim_ref, halves_ref], low=0.0)
    fused_vs = _rel_np(two[0]["ring2 binary fused"]["latents"], two[0]["ring2 binary"]["latents"])
    # wire bytes: the raw fp32 K/V in warmup, then the payloads; the same on both routes
    n, c = 2 * 1024 // 2, 1152
    payload = codecs.payload_nbytes(codecs.encode(torch.ones(n, c), codecs.CompressType.BINARY))
    want_bytes = SP_CUT * (WARMUP * 2 * n * c * 4 + comp_steps * 2 * payload)
    got_bytes = [phases[k]["wire_bytes_per_rank"] for k in ("ring2 binary", "ring2 binary fused")]
    print(f"[14] fused vs unfused latent rel err {fused_vs:.6f} (bound {RING_REL_MAX}); ring-shift "
          f"bytes per rank {got_bytes}, expected {want_bytes} (payload_nbytes {payload} per K or V)")
    if not (fused_vs <= RING_REL_MAX and got_bytes == [want_bytes, want_bytes]):
        raise AssertionError("phase 14: the fused ring drifts from the unfused one or sends other bytes")
    # int8 EF caches: the EF pass launches twice per hop (min-max, then codes)
    phases[CFG2_RING2] = ring_phase(15, four, CFG2_RING2, lossless_np,
                                    {"flash_attn_with_lse": hops * WARMUP + 1, "compact_ring_flash": hops * comp_steps,
                                     "ef_update_slot": 2 * hops * comp_steps},
                                    COMPRESSED_REL_ERR_MAX, [halves_ref], low=0.0)
    print(f"[15] EF caches across the ring: largest deviation {phases[CFG2_RING2]['consistency_dev']}")
    if phases[CFG2_RING2]["consistency_dev"] != 0.0:
        raise AssertionError(f"{CFG2_RING2}: EF caches differ across ranks")
    print(f"[13-15] spawn seconds (model build, every run of phases 13-15, 24, 25 and 27, the checks of the "
          f"images): {pixart_spawn_secs}")

    mark("13-15")
    # -- 16. the flash profiling probes -----------------------------------------
    part_rows, plumb_row = check_probes(ops_probes, flash, flash_parts, timing, dev, gen)
    _reset_counters()
    stage_rows = flash_parts.run()
    block_rows = block_parts.run()
    counted = {fn.__name__: _counter(f"{fn.__name__}.launches") for fn in kernels}
    ran = {k: sum(r["launches"].get(k, 0) for r in stage_rows + block_rows) for k in counted}
    for k in ("flash_parts", "plumb"):
        if not counted[k]:
            raise AssertionError(f"the probes never launched {k}")
    stage = {r["name"]: r for r in stage_rows}
    if not torch.equal(stage["full"]["out"], stage["real"]["out"]):
        raise AssertionError("the full stage mask differs from kernel 1 in the stage probe")
    for r in stage_rows:
        print(f"[16] stage probe {flash_parts.format_row(r)}")
    for r in block_rows:
        if tuple(r["out"].shape) != (2, 1024, 1152) or not bool(torch.isfinite(r["out"]).all()):
            raise AssertionError(f"block probe {r['name']}: output {tuple(r['out'].shape)} not finite")
        print(f"[16] block probe {block_parts.format_row(r)}")
    breakdown = block_parts.breakdown(block_rows)
    for part, cost, share in breakdown:
        print(f"[16] block breakdown: {part} {cost:.4f} ms per forward ({share:.1%} of full)")
    print(f"[16] launches the device ran: {', '.join(f'{k} {v}' for k, v in ran.items() if v)} "
          f"(counted at capture: {', '.join(f'{k} {v}' for k, v in counted.items() if v)})")

    def plain(rows):
        return [{k: v for k, v in r.items() if k != "out"} for r in rows]

    # the kernels line counts each kernel of the pipeline on the pipeline
    # alone: kernel 1's runs in the probes ("real", the block forward) are
    # reported beside it, not added to it
    probe_kernels = ("flash_parts", "plumb")
    phases["probes"] = {"launches": {k: v if k in probe_kernels else 0 for k, v in ran.items()},
                        "launches_of_pipeline_kernels": {k: v for k, v in ran.items() if k not in probe_kernels},
                        "launches_counted": counted, "stage_rows": plain(stage_rows),
                        "block_rows": plain(block_rows),
                        "block_breakdown": [{"part": p, "ms": c, "share": s} for p, c, s in breakdown]}

    mark("16")
    # -- 17.-19. FLUX.1-dev ----------------------------------------------------
    # PixArt's models leave the card first
    del pipe, params, vae_params
    torch.cuda.empty_cache()
    flux_rows = check_flux_kernels(flash, quant, codecs, ring_flash, timing, dev, gen)
    mark("17")
    flux_phases, _ = flux_lossless_phase(kernels, dev)
    phases.update(flux_phases)
    torch.cuda.empty_cache()
    mark("18")
    flux_ring_phases, flux_one, flux_two = flux_ring_phase(kernels, dev, codecs)
    phases.update(flux_ring_phases)
    flash_rows += flux_rows["flash"]
    quant_rows["binary"] += flux_rows["quant"]
    ring_rows += flux_rows["ring"]
    cring_rows += flux_rows["cring"]

    mark("19")
    # -- 20.-22. kernels 1, 4, 7 and 8 in fp32; PixArt in fp32 ----------------
    torch.cuda.empty_cache()
    f32_rows = check_f32_kernels(flash, ring_flash, timing, dev, gen)
    torch.cuda.empty_cache()
    mark("20")
    f32_phases, f32_models = f32_pipeline_phase(kernels, dev)
    phases.update(f32_phases)
    mark("21")
    phases.update(f32_ring_phase(kernels, dev, codecs, f32_models))
    del f32_models

    mark("22")
    # -- 23.-27. Ulysses, the patch gathers and the cache probes across ranks --
    torch.cuda.empty_cache()
    sp_rows, sp_phases, _ = run_sp_phases(kernels, dev, gen, lossless_np, pixart_two, pixart_four,
                                          flux_one, flux_two)
    phases.update(sp_phases)
    flash_rows += sp_rows["flash"]
    for codec in ("binary", "int2"):
        quant_rows[codec] += sp_rows["quant"][codec]
    ring_rows += sp_rows["ring"]
    cring_rows += sp_rows["cring"]

    mark("23-27")
    # -- 28.-31. the entry points: prompts in, images out -------------------
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the models of earlier phases leave the card
    entry_phases, _ = run_entry_phases(kernels, dev, codecs, pixart_launches,
                                                phases["flux lossless"]["launches"]["flash_attn_with_lse"] // 3)
    phases.update(entry_phases)

    mark("28-31")
    # -- 32.-34. CogVideoX-2b: kernels at d64, the model, the ring ------------
    gc.collect()
    torch.cuda.empty_cache()
    cog_secs, t0 = {}, time.perf_counter()
    cog_rows = check_cog_kernels(flash, quant, codecs, ring_flash, timing, dev, gen)
    cog_secs["32"], t0 = time.perf_counter() - t0, time.perf_counter()
    phases.update(cog_pipeline_phase(kernels, dev))
    gc.collect()
    torch.cuda.empty_cache()
    cog_secs["33"], t0 = time.perf_counter() - t0, time.perf_counter()
    cog_phases, cog_one = cog_ring_phase(kernels, dev, codecs)
    phases.update(cog_phases)
    cog_secs["34"], t0 = time.perf_counter() - t0, time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(cog_f32_ring_phase(kernels, dev, codecs))
    cog_secs["34 fp32"] = time.perf_counter() - t0
    print(f"[32-34] seconds: {', '.join(f'{k} {v:.1f}' for k, v in cog_secs.items())}")
    flash_rows += cog_rows["flash"]
    for codec in ("binary", "int2"):
        quant_rows[codec] += cog_rows["quant"][codec]
    ring_rows += cog_rows["ring"]
    cring_rows += cog_rows["cring"]

    mark("32-34")
    # -- 35.-36. PipeFusion, TP and the VAE ranks ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    pp_secs, t0 = {}, time.perf_counter()
    pp_phases, pp_rows = pp_pixart_phase(kernels, flash, timing, dev, gen)
    phases.update(pp_phases)
    pp_secs["35"], t0 = time.perf_counter() - t0, time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    stage_phases, stage_rows = pp_flux_cog_phase(kernels, flash, timing, dev, gen, flux_one, cog_one)
    phases.update(stage_phases)
    pp_secs["36"] = time.perf_counter() - t0
    print(f"[35-36] seconds: {', '.join(f'{k} {v:.1f}' for k, v in pp_secs.items())}")
    flash_rows += pp_rows + stage_rows

    mark("35-36")
    # -- 37.-42. SD3-medium, HunyuanDiT v1.2, PixArt-Sigma, the tiled VAE -----
    image_secs = {}
    for key, run in (("37", lambda: check_image_kernels(flash, quant, codecs, ring_flash, timing, dev, gen)),
                     ("38", lambda: vae_phase(kernels, dev)), ("39", lambda: family_runner_phase(kernels, dev, "sd3")),
                     ("40", lambda: family_runner_phase(kernels, dev, "hunyuandit")),
                     ("41", lambda: sigma_phase(kernels, dev)), ("42", lambda: image_ring_phase(kernels, dev, codecs))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = run()
        image_secs[key] = time.perf_counter() - t0
        if key == "37":
            image_rows = got
        else:
            phases.update(got)
    print(f"[37-42] seconds: {', '.join(f'{k} {v:.1f}' for k, v in image_secs.items())}")
    mark("37-42")
    flash_rows += image_rows["flash"]
    window_rows += image_rows["window"]
    for codec in ("binary", "int2"):
        quant_rows[codec] += image_rows["quant"][codec]
    ring_rows += image_rows["ring"]
    cring_rows += image_rows["cring"]

    # -- 43.-47. observability; Latte-1, ConsisID-preview, HunyuanVideo-T2V ---
    video_secs = {}
    for key, run in (("43", lambda: observability_phase(kernels, dev, codecs)),
                     ("44", lambda: latte_phase(kernels, flash, timing, dev, gen)),
                     ("45", lambda: consisid_phase(kernels, flash, quant, codecs, timing, dev, gen)),
                     ("46", lambda: hunyuanvideo_phase(kernels, flash, quant, codecs, ring_flash, timing, dev, gen)),
                     ("43, 47", lambda: video_ring_phase(kernels, dev))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = run()
        video_secs[key] = time.perf_counter() - t0
        if key == "43":
            got, eig = got
        if key in ("43", "43, 47"):
            phases.update(got)
            continue
        if key == "44":
            got_phases, rows, latte_video = got
            phases.update(got_phases)
            flash_rows += rows
            continue
        got_phases, rows = got
        phases.update(got_phases)
        flash_rows += rows["flash"]
        for codec in ("binary", "int2"):
            quant_rows[codec] += rows["quant"][codec]
        ring_rows += rows.get("ring", [])
        cring_rows += rows.get("cring", [])
    print(f"[43-47] seconds: {', '.join(f'{k} {v:.1f}' for k, v in video_secs.items())}")
    mark("43-47")

    # -- 48.-49. Step-Video-T2V; 50. the wide body above d 128, bf16 and fp32 ---
    sv_secs = {}
    for key, run in (("48", lambda: stepvideo_phase(kernels, flash, quant, codecs, ring_flash, timing, dev, gen)),
                     ("49", lambda: stepvideo_ring_phase(kernels, dev)),
                     ("50", lambda: check_tile_kernels(flash, ring_flash, timing, dev, gen))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = run()
        sv_secs[key] = time.perf_counter() - t0
        if key == "49":
            phases.update(got)
        elif key == "48":
            got_phases, rows = got
            phases.update(got_phases)
            flash_rows += rows["flash"]
            for codec in ("binary", "int2"):
                quant_rows[codec] += rows["quant"][codec]
            ring_rows += rows["ring"]
            cring_rows += rows["cring"]
        else:
            bf16, fp32 = got[torch.bfloat16], got[torch.float32]
            flash_rows += bf16["flash"]
            window_rows += bf16["window"]
            ring_rows += bf16["ring"]
            cring_rows += bf16["cring"]
            for kind in ("flash", "window", "ring", "cring"):
                f32_rows[kind] += fp32[kind]
    print(f"[48-50] seconds: {', '.join(f'{k} {v:.1f}' for k, v in sv_secs.items())}")
    mark("48-50")

    # -- 51. quality eval, ddpm_step, tensor_viz; 52. the last two examples ------
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(quality_phase(kernels, dev, images, latte_video, eig))
    del images, latte_video
    mark("51")
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(examples_phase())
    mark("52")

    totals = {fn.__name__: sum(p["launches"][fn.__name__] for p in phases.values()) for fn in kernels}
    for key in ROUTES.values():
        totals[key] = sum(p["launches"].get(key, 0) for p in phases.values())
    for name, count in totals.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    def flash_entry(name, line, rows, source="flash_attn.cu", key=None, **extra):
        """One kernel of kernels 1, 4, 7 and 8: its first shape's numbers
        at the top (eager ``ms``, where measured ``graph_ms``, and for fp32
        ``bound_3xtf32_ms``, the bound of the 3xTF32 design), every
        shape in ``shapes`` (with the tile body it ran, where it has a
        ``plan``); ``source`` holds the ``__global__`` functions; ``key``
        the count of its launches (default: ``name``'s)."""
        return {"name": name, "route": "cuda", "source": f"compactfusion_tpu_torch/csrc/{source}",
                "replaces": line, "launches": totals[key or name],
                "max_abs_err": max(r["max_abs_err_out"] for r in rows),
                "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
                "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
                "library_ms": rows[0].get("library_ms"), "shapes": rows,
                **{k: rows[0][k] for k in ("graph_ms", "bound_3xtf32_ms") if k in rows[0]}, **extra}

    report = {"kernels": [
        flash_entry("flash_attn_with_lse", "compactfusion_tpu/ops/flash_pallas.py:593", flash_rows, "flash_wgmma.cu",
                    launches_by_route={
                        "wgmma body (bf16, d <= 128), csrc/flash_wgmma.cu": totals[WG["flash_attn_with_lse"]],
                        "register body (d <= 128), csrc/flash_attn.cu":
                            totals["flash_attn_with_lse"] - totals[WIDE] - totals[WG["flash_attn_with_lse"]],
                        "wide body (d > 128), csrc/flash_wide.cu": totals[WIDE]},
                    launches_in_probes=phases["probes"]["launches_of_pipeline_kernels"]["flash_attn_with_lse"]),
        dict(quant_entry(quant_rows, totals, "binary", "quant", 118), launch_floor_ms=floor_ms),
        dict(quant_entry(quant_rows, totals, "binary", "dequant", 159), launch_floor_ms=floor_ms),
        dict(quant_entry(quant_rows, totals, "int2", "quant", 238), launch_floor_ms=floor_ms),
        dict(quant_entry(quant_rows, totals, "int2", "dequant", 273), launch_floor_ms=floor_ms),
        flash_entry("flash_attn_window_with_lse", "compactfusion_tpu/ops/flash_pallas.py:508", window_rows,
                    ms_vs_full_kernel=window_vs_full),
        flash_entry("ring_flash_attn_with_lse", "compactfusion_tpu/ops/ring_flash_pallas.py:347", ring_rows,
                    "flash_wgmma.cu", launches_by_route=_ring_routes(totals, "ring_flash_attn_with_lse")),
        flash_entry("compact_ring_flash", "compactfusion_tpu/ops/ring_flash_pallas.py:954",
                    [{k: v for k, v in r.items() if k != "ef"} for r in cring_rows], "flash_wgmma.cu",
                    launches_by_route=_ring_routes(totals, "compact_ring_flash")),
        {"name": "ef_update_slot", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/ring_flash.cu",
         "replaces": "compactfusion_tpu/ops/ring_flash_pallas.py:954", "launches": totals["ef_update_slot"],
         "max_abs_err": max(r["ef"]["max_abs_err"] for r in cring_rows), "library_ms": None,
         **{k: cring_rows[0]["ef"][k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
         "shapes": [dict(r["ef"], shape=r["shape"]) for r in cring_rows]},
        {"name": "flash_parts", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/probes.cu",
         "replaces": "_prof_kernel_parts.py:69", "launches": totals["flash_parts"],
         "max_abs_err": max(r["max_abs_err"] for r in part_rows),
         "ms": stage["full"]["us_per_call"] / 1e3, "plain_ms": part_rows[0]["plain_ms"],
         "bound_ms": stage["full"]["bound_ms"], "bound_by": stage["full"]["bound_by"],
         "library_ms": stage["sdpa"]["us_per_call"] / 1e3,
         "variants": [dict(r, **{k: stage[r["name"]][k] for k in
                                 ("us_per_call", "us_per_bh", "delta_vs_full_us", "bound_ms", "bound_by")})
                      for r in part_rows]},
        {"name": "plumb", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/probes.cu",
         "replaces": "_prof2_dbg.py:75", "launches": totals["plumb"], "library_ms": None, **plumb_row},
        flash_entry("flash_attn_with_lse (fp32)", "compactfusion_tpu/ops/flash_pallas.py:593", f32_rows["flash"],
                    key=F32["flash_attn_with_lse"],
                    launches_by_route={"register body (d <= 128)": totals[F32["flash_attn_with_lse"]] - totals[F32_WIDE],
                                       "wide body (d > 128), csrc/flash_wide.cu": totals[F32_WIDE]}),
        flash_entry("flash_attn_window_with_lse (fp32)", "compactfusion_tpu/ops/flash_pallas.py:508",
                    f32_rows["window"], key=F32["flash_attn_window_with_lse"]),
        flash_entry("ring_flash_attn_with_lse (fp32)", "compactfusion_tpu/ops/ring_flash_pallas.py:347",
                    f32_rows["ring"], "ring_flash.cu", key=F32["ring_flash_attn_with_lse"]),
        flash_entry("compact_ring_flash (fp32)", "compactfusion_tpu/ops/ring_flash_pallas.py:954",
                    [{k: v for k, v in r.items() if k != "ef"} for r in f32_rows["cring"]], "ring_flash.cu",
                    key=F32["compact_ring_flash"]),
        {"name": "ef_update_slot (fp32)", "route": "cuda", "source": "compactfusion_tpu_torch/csrc/ring_flash.cu",
         "replaces": "compactfusion_tpu/ops/ring_flash_pallas.py:954", "launches": totals[F32["ef_update_slot"]],
         "max_abs_err": max(r["ef"]["max_abs_err"] for r in f32_rows["cring"]), "library_ms": None,
         **{k: f32_rows["cring"][0]["ef"][k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")},
         "shapes": [dict(r["ef"], shape=r["shape"]) for r in f32_rows["cring"]]},
    ], "sdpa_cross_attention": cross_rows, "fp32_ptxas": f32_rows["ptxas"], "phases": phases}
    report["seconds_by_phase"] = secs_by_phase
    print(f"[done] phases 1-52 passed in {time.perf_counter() - t_run:.1f} s, the kernels' build included "
          f"(seconds by phase: {', '.join(f'{k} {v:.1f}' for k, v in secs_by_phase.items())})")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
