"""Smoke run of pytorchvideo_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and ``nvcc``, and
exits nonzero, printing no result, when a check fails or no card is present.

1. Device: name, torch and CUDA versions, ``nvidia-smi`` name and power limit.
2. Build: compiles every ``pytorchvideo_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, all at once) and loads the library.
3. X3D kernel vs plain version at X3D-S's four stride-1 ``conv_b`` shapes
   (T13, S40C54 / S20C108 / S10C216 / S5C432, B2): f32 and bf16, swish on
   and off, with and without scale/bias, every call on the tiled route. The
   reference is the plain version (``F.conv3d(groups=C)`` + epilogue) in f32
   with TF32 off, on the same (bf16-rounded) inputs. Then at B128 in bf16
   the tiled route, the scalar route (the first version), the plain version
   and the library call ``F.conv3d(groups=C)`` alone are timed per shape,
   and both routes' B128 outputs are held against the plain version in f32
   as well. The tiled time per B128 forward (22 launches) must stay within
   half of the first version's (``DEPTHWISE_GATE_SHARE``).
4. X3D slice: ``hub.x3d_s(model_num_class=400)`` at full width, 13x160x160,
   with random weights from a seeded ``torch.Generator`` (BN affine
   randomised, running stats measured on seeded random clips; see
   ``randomize_``). The deploy form (``convert_to_deployable_form``, bf16)
   serves request batches of 1, 8 and 128 clips; the kernel's launch count
   must rise by 22 per forward (the 22 stride-1 ``conv_b``), all on the
   tiled route. Its logits are held against the plain f32 eval model (cuDNN
   for every conv, TF32 off) at B8, as is the f32 deploy form, each form's
   22 launches on the tiled route; top-1 must agree on every row whose
   top-two margin the measured error cannot bridge.
5. MViT kernels: the pooled-attention kernel in both layouts (head-packed
   and per-head), residual on and off, at B2 on every distinct
   (H*c, Lq, Lk) of MViT-B 16x4, on each one's cls query (Lq 1) and on
   MViT-B 32x3's block 14 (Lq 784, Lk 3137); the token-pool kernel in its
   three modes (conv, max, avg) at every pool geometry of MViT-B 16x4; each
   in f32 and bf16, against its plain version in f32 (TF32 off) on the same
   inputs; each attention call's route counter must move (bf16: the tensor
   cores for the grid queries, the split-key route for the cls query; f32:
   the CUDA cores), and every pool call must take the tiled route. Then at
   B32 bf16 the kernel, its plain version and one library call
   (``F.scaled_dot_product_attention`` on (B, H, L, c) views;
   ``F.conv3d(groups=C)``, ``F.max_pool3d``, ``F.avg_pool3d``) are timed per
   shape, the attention also through its CUDA-core kernel and the pools
   through their scalar route (each the first version), and the kernel's
   timed output is held against the plain version. The pools' tiled time per
   B32 forward (35 conv + 3 max) must stay within a quarter of the first
   version's (``POOL_GATE_SHARE``).
6. MViT slice: ``hub.mvit_base_16x4()`` at full width and depth, 16x224x224,
   seeded random weights (``randomize_mvit_``), in its deploy form (bf16),
   serves B1, B8 and B32; per forward the counts rise by 32 (attention: 16
   grid queries on the tensor cores and 16 cls queries on the split-key
   route), 35 (conv pools) and 3 (skip max pools). Its logits at B4, and
   those of the f32 deploy form, are held against the plain f32 model
   (every kernel swapped for its plain version, TF32 off).
7. ``pool_first``: ``hub.mvit_base_16x4(pool_first=True)`` the same way at
   B4; the per-head attention count rises by 16 per forward, all on the
   tensor cores (the cls row rides with the grid).
8. Backward kernels: the attention backward in both layouts (#5 head-packed,
   #3 per-head), residual on and off, at the shapes of phase 5, and the conv
   pool's input and weight gradients (dx, dw) at every conv-pool geometry of
   MViT-B 16x4 (head-packed: the 96-row weight shared by C / 96 heads); each
   at B2 in f32 and bf16 against its plain version in f32 (TF32 off) on the
   same inputs and the same output gradient, and the plain backward against
   ``torch.autograd.grad`` through the plain forward in f32. Each attention
   backward call's route counter must move (bf16: the tensor cores for the
   grid queries, the split-key route for the cls query; f32: the CUDA
   cores); every dx and dw call must take the tiled route. Then at the
   training batch (B8, bf16) the kernel, its plain version and one library
   call (``F.scaled_dot_product_attention`` forward and backward through
   ``torch.autograd.grad``; ``aten.convolution_backward`` of the
   channels-last ``F.conv3d(groups=C)``) are timed per shape; the attention
   backward also through its CUDA-core kernels and beside SDPA's backward
   alone, dx and dw through their scalar route (each the first version).
   Per B8 step, #5's tensor-core and split-key time and #3's tensor-core
   time must each stay within a quarter of the first version's
   (``BWD_GATE_SHARE``), and so must dx's and dw's (``POOL_GATE_SHARE``).
9. Training: ``VideoClassificationTrainApp`` on the
   ``classification_mvit_16x4`` recipe (AdamW, cosine after warmup, clip
   1.0, MixUp/CutMix with label smoothing 0.1, soft-target cross-entropy)
   with ``compute_dtype="bfloat16"`` trains ``hub.mvit_base_16x4()`` at full
   width and depth, 16x224x224, seeded random weights, on seeded synthetic
   clips made on the card. The app runs the captured step (phase 19): the
   first batch of each signature captures it, after the captured step's
   eager warm-up updates, and the replays after run no Python. Every
   parameter must receive a finite gradient through autograd in the first
   step. Timed steps at B8 and at the preset's B2 (clips/s, ms per step,
   peak memory, the capture's included); at each update that launches (a
   batch signature's first three: the captured step's two eager warm-up
   updates and its capture) the counts rise by 32 attention forwards and 32
   backwards (each 16 on the tensor
   cores, 16 split-key; in f32 compute all on the CUDA cores), 35 conv
   pools with 35 dx and 35 dw, and 3 max pools, every pool launch on the
   tiled route (dw one launch each); a replay moves no counter. One eager
   step's gradients at B2 are held against the same step with every kernel
   swapped for its plain version (in f32 and in bf16 compute), on the seeded
   weights (a snapshot taken before the timed steps, so every run checks
   the same weights); in f32 both forms' skip max pools route their
   gradients by PyTorch's argmax of the kernel form's input
   (``SharedMaxRouting``; the kernel's output must be the maxima at those
   positions, and at most ``MAX_POOL_FLIPS`` windows may have another argmax
   in the plain form's input), so a window that ties within rounding cannot
   send them apart. The loss must fall
   over 10 steps on one fixed batch.
10. ``pool_first`` training: four single steps at B2 of
    ``hub.mvit_base_16x4(pool_first=True)`` through ``app.train()``, the
    launches read over each (two warm-up updates, the capture, a replay);
    the per-head attention backward (#3) rises by 16 an update, all on the
    tensor cores, and by none at the replay.
11. Fused kv-pool kernel: the fused op (the pool-LN kernel, then the
    attention kernel for the grid and the cls query) at every MViT-B 16x4
    block geometry, all of which pass ``fusable``, at B2 in f32 and bf16: the
    pooled k and v against the plain version in f32 on the same inputs, each
    attention against the plain attention over the kernel's own k and v (in
    f32 also the whole op against the plain version); every pool-LN launch
    must take the tiled route. Then at B32 bf16 the op, the unfused kernel
    path the layer otherwise runs (two conv pools, LayerNorms,
    concatenations, two attention launches), a library composition
    (``F.conv3d(groups=C)``, ``F.layer_norm``, SDPA) and the plain version
    are timed per shape, with the bound; and the pool-LN launch alone on its
    tiled route and on its scalar route (the first version), beside its
    plain version, a library composition (``F.conv3d``, ``F.layer_norm``,
    ``torch.cat``) and its own byte bound, both routes' outputs held against
    the plain version. The tiled pool-LN time per B32 forward (16 launches)
    must stay within half of the first version's (``POOL_LN_GATE_SHARE``).
12. The per-head attention kernel at the four shapes of the benchmark-only
    TPU variant ``_pallas_nopad`` (benchmarks/mvit_micro.py:236-241, B16
    bf16, residual on) against ``pooled_attention_torch``, timed with SDPA
    and the first version.
13. Fused serving: ``hub.mvit_base_16x4(fused_kvpool=True)`` with seeded
    random weights, deploy bf16, B1/B8/B32; per forward the counts rise by
    16 (fused pool-LN, all on its tiled route), 32 (attention), 3 (conv
    pools: pool_q only) and 3 (max). Its logits at B4 (bf16 and f32 deploy,
    each forward's pool-LN launches on the tiled route) against the plain
    f32 model and the bf16 ones against the unfused deploy form of the same
    weights; the unfused form is served after it for clips/s side by side.
14. Fused training: the ``classification_mvit_16x4`` recipe with
    ``model.kwargs={"fused_kvpool": True}``: every parameter's gradient
    through autograd, timed captured steps at B8 and B2 (per update at a
    capture 16 fused (tiled), 64 attention forwards (the backward
    recomputes), 32 attention backwards (16 tensor-core, 16 split-key), 35
    conv pools with 35 dx and 35 dw, 3 max pools; none per replay), and one
    B2 eager step's gradients against the unfused kernel step of the same
    weights: the seeded ones, as in phase 9, with the f32 skip max pools
    routed by ``SharedMaxRouting`` (the fused form records, the unfused
    form replays; at most ``MAX_POOL_FLIPS`` windows may flip).
15. The depthwise kernel (#1) at CSN-R101's four stride-1 ``conv_b`` shapes (T32 S112 C64,
    T16 S56 C128, T8 S28 C256, T4 S14 C512) at B2: f32 and bf16, bias only
    (as CSN's deploy form calls it) and with scale, bias and swish, against
    the plain version in f32 (TF32 off) on the same inputs, every call on
    the tiled route; then at B8 in bf16, bias only, the tiled route, the
    plain version and ``F.conv3d(groups=C)`` alone timed per shape beside
    the byte bound, the timed output held against the plain version.
16. ResNet family at full width, seeded random weights (``randomize_``, BN
    stats from a B2 batch): ``hub.slowfast_r50()`` ([8, 32] x 224 x 224)
    serves B1, B8 and B64 in its bf16 deploy form (no kernel of the port on
    its path); ``hub.csn_r101()`` (32x224x224) serves B1 and B8, the
    depthwise kernel's count rising by 30 per forward (its stride-1
    ``conv_b``), all on the tiled route; clips/s, ms per forward and peak
    memory of each. Their logits (B4, B2) and one B2 forward of each of
    ``slow_r50``, ``c2d_r50``, ``i3d_r50`` (8x224x224), ``r2plus1d_r50``
    (16x224x224), ``slowfast_r101`` ([8, 32] x 224 x 224) and
    ``slowfast_16x8_r101_50_50`` ([16, 64] x 224 x 224), in the f32 and the
    bf16 deploy form, are held against the plain f32 eval model (cuDNN, TF32
    off).
17. Compiled serving and export: each deploy form phases 4-16 serve
    (``x3d_s`` B1/B8/B128; ``mvit_base_16x4`` unfused and
    ``fused_kvpool=True`` B1/B8/B32, ``pool_first=True`` B4;
    ``slowfast_r50`` B1/B8/B64; ``csn_r101`` B1/B8), new seeded weights,
    bf16: the first batch through ``convert_to_deployable_form(...,
    example_input=x)``, the others as ``CompiledForward``s of the same
    module in the same memory pool. Each capture (after its warm-up
    forwards) launches the eager per-forward counts; replays launch no
    wrapper; the replayed logits match the eager form's on the same input
    (max |diff| within the bf16 logit bound, expected 0), and two replays of
    different inputs return two different, unaliased tensors. Eager against
    compiled per batch: clips/s (``cuda_time_ms``), host ms per forward (a
    median of synchronised calls), the busy share (the union of the
    device's activity in a ``torch.profiler`` trace of back-to-back calls,
    over its span) and the peak memory above what was allocated before. Then
    ``export_program`` of ``x3d_s``, both ``mvit_base_16x4`` forms and
    ``csn_r101`` at B1, loaded back with ``torch.export.load``: one
    ``pvt::`` node per eager kernel launch, the loaded program's run on
    the card moving the counters by the eager per-forward counts, its
    logits against the eager form's. Each model's graphs are freed before
    the next model is built.

18. BatchNorm-family training (no kernel of the port on these steps: the
    JAX package's training of these models reaches no Pallas kernel). The
    train-mode BatchNorm on bf16 input, weight and bias beside f32 running
    buffers at X3D-S's stem and last-stage shapes (B8) against an f64
    reference: the output within one bf16 rounding, the running mean and
    biased variance within 1e-5. ``hub.x3d_s(model_num_class=400)`` at
    13x160x160 through ``VideoClassificationTrainApp`` on bench.py:317's
    recipe (the X3D-XS preset with ``x3d_s_bench_overrides``: SGD momentum
    0.9 at LR 0.1, MixUp alpha 1.0 with label smoothing 0.1, soft-target
    CE, bf16 compute), weights from ``init_net_weights``: every parameter
    gets a finite gradient in the first step, then B64 and B128 are timed
    through the app, captured (clips/s, ms per step, peak memory, the busy
    share as phase 17 takes it). One B8 step's gradients in bf16 compute against f32 compute (TF32
    off, dropout 0, ``randomize_`` weights): the loss, the relative L2
    error and cosine of all gradients and each stage's error
    (``BF16_STEP_*``). The loss falls over 10 steps on one fixed B8 batch.
    ``hub.slowfast_r50()`` on ``classification_slowfast_8x8_r50`` in bf16
    at B32 on ``[slow, fast]`` batches (``SlowFastPackPathway(4)``,
    ``default_collate``): first-step gradients, then timed.
    ``classification_x3d_xs`` at its B16: 3 steps, precise BN over 4
    batches, whose stats must equal the mean of the per-batch stats taken
    separately (``PRECISE_BN_REL``), then ``test()`` on 16 videos of 2
    clips against the ensembling by hand from ``predict()``.
    ``classification_slow_8x8_r50``: one step at B4. ``test()`` and
    ``predict()`` replay a captured eval forward per clip shape.
19. The captured training step (train/compiled_step.py) against the eager
    one. (a) ``classification_mvit_16x4`` in bf16 on full
    ``mvit_base_16x4`` (head dropout 0; DropPath is 0 in its config) at B8
    and B2, and with ``fused_kvpool=True`` at B8: five updates from the same
    weights, batches and MixUp draws through the captured step, the eager
    step and the eager step again (its own spread: PyTorch's max-pool
    backward adds with atomics); each update's loss within the bf16 logit
    bound and its gradients within phase 9's bf16 per-tensor bound of the
    eager ones, the parameters after within that bound too; the launches
    read over each update: the eager per-step counts at each of the two
    warm-up updates and at the capture, none at a replay. (b) Eager against
    captured at each of those batches, in turns: clips/s, ms per step
    (``cuda_time_ms``), host ms per step, the busy share (phase 17's) and
    the peak memory (eager: five steps; captured: its capture). Then two
    sets of replays on one batch at LR 0 with head dropout 0.5 and DropPath
    0.2, from torch's default generator and from the modules' own CUDA
    generators: every update's loss differs (three replays), the parameters
    stay. (c) ``x3d_s`` at B64 on ``x3d_s_bench_overrides`` and
    ``slowfast_r50`` at B32 on its preset, dropout 0: five updates through
    the captured step (three replays) against five eager ones, the parameters and BN buffers (running stats,
    ``num_batches_tracked`` exactly) within phase 9's bound; timed beside
    phase 18's figures. (d) ``remat_policy`` ``"full"`` and
    ``"dots_with_no_batch_dims_saveable"`` on MViT-B B8, eager and captured:
    one step's gradients against the step without remat within phase 9's
    bound; every forward kernel launches twice a step (64 attention
    forwards); ms per step and peak memory beside the step without remat;
    ``x3d_s`` at B128 under ``"full"``: its capture's peak memory beside
    phase 18's. (e) The LR on the device, in f32 (TF32 off) with every
    dropout 0 and an LR that changes at each update: MViT-B's recipe
    (capturable AdamW, its warm-up) at B2 and ``x3d_s`` on bench.py's recipe
    (fused SGD, a 10-step warm-up) at B8, six updates through the captured
    step; each held against ``torch.optim``'s update in float64 at the float
    LR from the state before it and the gradients it took, per tensor within
    ``LR_CHECK_REL`` of the change plus one f32 rounding; the whole change
    over the six, captured against eager, within ``LR_CHECK_WHOLE_REL``
    (relative L2; the eager step's own spread printed beside it).
20. The data feed (data/, transforms/, train/datamodule.py; no kernel of
    the port: the JAX package's data path reaches no Pallas kernel). (a)
    Every functional op and transform class (fixed seeds), the 14
    RandAugment ops at magnitudes that exercise each, RandAugment, AugMix
    and ``create_video_transform``'s chains on a CUDA tensor against the
    same call on a CPU tensor, on a seeded uint8 clip at MViT's decode
    geometry (16x256x340) and its float32 / 255: index ops and the uint8
    ops (equalize, posterize, solarize, invert) equal, every other result
    within ``FEED_TOL`` of its value range; the worst error per op printed.
    (b) A ``ClipStore`` of ``FEED_STORE_CLIPS`` seeded uint8 clips at
    13x240x320 (``prepare_clip_store``, under build/), then
    ``ClipStore.batches`` -> ``device_prefetch`` to the card at B128, and
    ``ClipStore.prefetch`` (each batch gathered into the pinned ring): each
    batch equal byte for byte to ``store.gather`` of its indices; the host
    gather's GB/s (into a new buffer and into a pinned one) and the pinned
    ring's copy GB/s; the pinned allocations equal to the ring's size per
    leaf, not the batch count; the overlap (a consumer that spends the
    producer's time per batch should take max(produce, consume), not their
    sum, as the JAX package's ``--no-device`` probe takes it); ``close()``
    in mid-epoch stops the producer. (c) ``hub.x3d_s`` deploy bf16 as a
    ``CompiledForward`` at B128 fed from that store by ``ClipStore.prefetch``
    through the val chain run on the card in the prefetch's stream
    (``Div255``, ``Normalize``, ``ShortSideScale(182)``,
    ``CenterCropVideo(160)``, THWC -> CTHW): clips/s beside the same graph
    on one resident batch (steady windows, in turns), the busy share, host
    ms of the chain; one fed batch's logits
    within the bf16 logit bound of the same clips transformed on the CPU.
    (d) ``classification_mvit_16x4`` (RandAugment, MixUp/CutMix, bf16) at
    B8 through ``app.train()`` fed from a store of ``TRAIN_STORE_CLIPS``
    clips at 16x256x340 by an adapter that runs
    ``create_video_transform("train", aug_type="randaug")`` per clip on the
    card, in the prefetch's stream and, for comparison, in the step's:
    steady clips/s beside the captured step on one resident batch, the busy
    share, host ms of the chain, finite losses, and the launches per update
    phase 19 reads. (e) The app
    built without a datamodule builds ``VideoClassificationDataModule`` on
    the card (not iterated: the card's machine has no video decoder).

21. AVA detection and the serving engine (models/detection.py,
    ops/roi_align.py, engine/; no kernel of the port: no JAX module of
    this path reaches a Pallas kernel, and the counters must stay at 0).
    (a) ``hub.slow_r50_detection()`` at full width (80 classes, res5
    dilated at stride 1, RoI head at 1/16), seeded random weights
    (``randomize_`` on the backbone, BN stats from a B2 batch), 4x256x256
    in f32: requests of B1 with 1, 8 and 32 boxes and B8 with 8 boxes a
    clip, each one's scores held against the same model on the CPU (rtol
    5e-3, atol 5e-4) and timed, the request types in turns (requests/s by
    ``cuda_time_ms``, host ms a request; then the busy share as phase
    17's, peak memory); one traced B1 request with 8 boxes split by part
    inside the model's forward (backbone, head, and in it the T pool,
    RoIAlign, the spatial max pool, ``proj``; the request's busy ms, span
    and host gaps; its device ms by aten op). (b) ``hub.slowfast_r50_detection()`` at [8, 32]
    x 256 x 256: B1 with 8 boxes held against the CPU, B1 and B8 timed.
    (c) A ``NeuralEngine`` of ``PeopleDetectionHook`` (a stub predictor of
    5 boxes), ``ActionDetectionHook`` (full-width ``slow_r50_detection``)
    and ``X3DClsHook`` (full-width ``x3d_s``, its forward a
    ``CompiledForward``) over an in-memory 64x360x640 uint8 video on the
    host (the card's machine has no decoder: the pipeline starts at
    ``"video"``): 20 requests, ms a request and a hook; one request's
    outputs against the eager models on the same preprocessed input;
    ``X3DClsHook``'s input (frame pick, copy, transform) and its replay
    timed alone; the X3D forward replays with no eager call and no new
    capture. (d) RoIAlign
    at (8, 2048, 16, 16) with 64 boxes, 7x7 at 1/16, f32 and bf16, on the
    card against the CPU, timed beside its byte bound.

22. Self-supervised pretraining (train/ssl_app.py, train/ssl.py,
    models/byol.py, simclr.py, memory_bank.py; LARS in train/optimizer.py),
    in f32 with TF32 off. (a) LARS (the BYOL preset's optimizer: lr 4.8, wd
    1e-6, zero-wd 1-D params) on full-width ``slow_r50``: six updates at a
    warm-up of the device LR on seeded gradients, the head's bias zeroed (a
    tensor whose norm is 0), each tensor's update held against the JAX
    chain (decay, trust ratio on "main" and "zero", momentum) in float64
    within phase 19 (e)'s bound; the update of the 1-D "zero" group with
    and without the ratio (the JAX chain's scaling that its docstring
    denies). (b) BYOL on full-width ``slow_r50`` at 8x224x224 (feature
    256, predictor 4096, mmt 0.996 annealed, the preset's LARS): a B2
    two-view step on the card against the same step on the CPU (the loss,
    every parameter, the momentum encoder and the BN buffers within rtol
    5e-3 / atol 5e-4; the head's bias, whose gradient is zero up to rounding
    so that LARS steps it by lr x its norm in a direction the rounding
    picks, held by that step's norm instead); B8 through
    ``SSLTrainApp.train()`` (the captured step) timed against the eager
    step in turns, with the step's device time by part (online forward and
    backward, momentum forwards, LARS, the EMA). (c) SimCLR (feature 128,
    temperature 0.1, LARS) and MoCo v2 (dim 128, queue 65536, temperature
    0.07, SGD lr 0.4) on ``slow_r50`` at B8: five updates through
    ``SSLTrainApp.train()`` against five eager ones from the same weights
    and batches within phase 19's bound, MoCo's pointer +8 a step and the
    queue rows a replay writes equal to its normalised keys; then timed as
    (b). (d) SimCLR on full-width ``mvit_base_16x4`` (16x224x224, f32) at
    B4 through ``make_simclr_train_step``: one step launches twice the
    classification step's kernels (once a view; attention on the CUDA
    cores, the pools tiled), and its gradients lie within phase 9's
    per-tensor bound of the plain-kernel step (printed beside it). (e)
    ``MemoryBank`` at its defaults (1,280,000 x 2048 f32, 4096 negatives) on
    ``slow_r50`` at B8: one step changes the ``x_ind`` rows and no other;
    ms a step and peak memory; ``KnnMemory.knn_predict`` at length 65536,
    k 200, B8, timed.
23. The deploy extras (accelerate/, utils/), full width, seeded random
    weights. (a) ``hub.efficient_x3d_s()`` at 13x160x160: ``convert()``
    eager and compiled at B1, B8 and B128, each eager forward raising #1's
    count by 22, all tiled; its logits within phase 4's bf16 bound of the
    plain f32 model; clips/s eager and compiled beside phase 17's ``x3d_s``;
    ``efficient_x3d_xs`` at 4x160, one B8 check. (b) The efficient blocks
    at X3D-S's stage-2 shape (T13, S20, C108) in f32 and bf16:
    ``X3dBottleneckBlock`` with and without SE at stride 1 and 2 and
    ``Conv3d3x3x3DwBnAct`` with each activation, converted, against the
    train form in eval mode (bf16: phase 4's bound; f32: 1e-4 x max |y|);
    one #1 launch per stride-1 depthwise conv, none at stride 2. (c)
    ``transmute_model(hub.x3d_s(), "cuda")`` bit-equal to
    ``convert_to_deployable_form`` on the same B8, with the same 22
    launches. (d) Int8 MViT-B 16x4 (``int8_serving_fn`` of the bf16 deploy
    form): the number of quantized layers by the JAX package's rule; every
    ``torch._int_mm`` product of one B8 forward equal to the same operands'
    product on the CPU (in float64, exact); the logits against the bf16
    deploy form's (``INT8_REL_TOL``) and top-1 where the margin allows; B1,
    B8, B32 eager and compiled (clips/s, host ms, busy, peak) beside phase
    17's bf16 figures. (e) ``quantize_variables`` of full-width ``x3d_s`` and
    MViT-B: ``quantization_error``, and the dequantized model's logits
    against the original's (``WEIGHT_INT8_REL_TOL``). (f)
    ``model_complexity`` of ``x3d_s``, ``x3d_xs``, ``mvit_base_16x4`` and
    ``slow_r50``: parameters equal to MODEL_ZOO.md's, GFLOPs printed. (g)
    The BatchNorm MViT-B 16x4 (random BN affine, running stats of one
    train-mode forward, each branch's last layer scaled down to keep the
    random network well-conditioned): ``fuse_bn_mvit`` (f32: phase 4's f32
    bound) and its bf16 deploy form (the bf16 bound) against the unfused
    f32 model on the plain kernels; #4's and #6's launches per forward equal
    to the LayerNorm model's. (h) ``utils.time_jitted`` of (a)'s compiled B8
    forward within 25% of ``cuda_time_ms``; a ``utils.trace`` written to a
    temporary directory.
24. Audio-visual SlowFast and the masked multistream, full width, seeded
    random weights; no TPU kernel lies on this path, and every part's
    kernel counters must read 0. (a) ``create_audio_visual_slowfast()``
    (slow 8x224x224, fast 32x224x224, a (1, 128, 1, 80) spectrogram): the
    f32 and bf16 deploy forms' logits at B8 against the plain f32 model
    (phase 4's bounds), the BNs folded and kept (the acoustic stem's, after
    a ``ConvReduce3D``); then served as phase 17 serves, eager and
    compiled, at B1, B8, B32. (b) ``create_acoustic_resnet()`` the same at
    B32. (c) The AV model trained through ``VideoClassificationTrainApp`` on
    the SlowFast-R50 preset in bf16 at B8 on three-pathway batches
    (``SyntheticAVClips``): three steps as the app runs them, the first's
    gradients reaching every parameter, every BN's running stats moved,
    then timed replays. (d) The masked multistream at B32 (video features
    through ``PositionalEncoding`` and a 2-layer 8-head encoder, audio
    features through a bidirectional LSTM, object features through 4-head
    attention, max pooling and the learned default; concatenated): the
    card's f32 output against the port's CPU float64 forward, padded tails
    filled with 1e4 leaving it unchanged, the empty rows equal to the
    learned default, ms a forward.
25. The data-parallel layer (parallel/, the synced BatchNorm, the app's
    data-parallel step) on a one-rank NCCL group made through an in-memory
    store (no TCP port) and destroyed after each part; a card's machine has
    one card, so what differs across ranks is held on four gloo ranks by the
    CPU tests. (a) ``mvit_base_16x4`` (seeded random weights) at B8 through
    the classification app in bf16: the app made before the group and the
    app made on it (its mesh, its step averaging the gradients over the
    group), from the same weights and batches, each through its captured
    step for its two warm-up updates, the capture and two replays; the
    step's all-reduce called eagerly at each warm-up update and while the
    stream captures (so the graph holds it) and never at a replay; the
    losses, and every parameter after the five updates, within phase 9's
    bf16 bound (the share of its f32 bound printed); #4-#7's launches per
    update as phase 19 reads them; the NCCL kernels a replay's trace shows.
    (b) ``x3d_s`` at B16 in f32 on the X3D-S recipe, every BatchNorm synced
    over the group, against the local-BN app the same way: parameters,
    running stats and ``num_batches_tracked``. (c) ``sequence_parallel_body``
    at MViT-B 32x3's first-stage shape (B4, Lq 16x56x56 = 50176 grid tokens,
    kv pooled to 16x7x7 = 784, one head of 96), shard by shard for four
    simulated ranks (Lq 12544 each), kv replicated and kv gathered (the
    shards' concatenation), f32 and bf16: each shard one #4 and one #5
    launch on the route its shape and alignment give (printed), the
    concatenated output against one call and the plain version (phase 5's
    bound), the gradients against one call's and the plain backward's
    (phase 8's); then ``sequence_parallel_attention`` with kv sharded
    through ``all_gather_with_grad`` on the group, forward and backward,
    against one call. (d) ``ntxent_loss`` and ``SimCLR.loss`` with the group
    against none: losses and gradients. (e) Times beside the card's name and
    power limit: each captured data-parallel step against the captured plain
    one in turns (``cuda_time_ms``, host ms, busy share), and the four
    shards' #4 calls against one call over all rows, the plain version,
    SDPA and the bound.
26. Tensor parallelism and FSDP (parallel/sharding.py, parallel/tensor.py,
    train/sharded.py). NCCL refuses two ranks on one device, so (a, b) run
    in two processes that share the card, joined by a gloo group over CUDA
    tensors (the Megatron layers need only all_reduce, which gloo carries
    for CUDA tensors by staging them through the host; a file store under
    ``build/``): ``mvit_base_16x4`` (seeded random weights, no dropout) on a
    (1, 2) (data, model) mesh, block 0's one-head attention replicated by a
    rule ahead of ``MEGATRON_ATTENTION_RULES``, every other q, k, v, proj,
    fc1 and fc2 split. (a) The f32 and bf16 forwards at B8, and with
    ``fused_kvpool``, against the one-process unsharded f32 forward (phase
    4's bounds), and ``pool_first``'s bf16 training forward at B2 against
    its f32 forward; each read from zeroed counters: the unsharded counts
    and routes per forward (32 attention, 35 + 3 pools; fused: 16 pool-LN)
    and per step. (b) One bf16 step at B8 (the dry run's SGD, the clip at
    1.0): the full state against the unsharded step's within phase 9's bf16
    bound, the region's replicated parameters equal on both ranks. (c) #2/#3
    (per-head), #4/#5, #6, #7's dx and dw and #8's pool-LN at the tp = 2
    local shapes of blocks 1-15, f32 and bf16 at B2, against their plain
    versions, each call on its route. (d) ``run_sharded_step`` on a
    one-rank NCCL group (FSDP over data, each shard the whole parameter) on
    the dry run's BatchNorm MViT-tiny (MixUp) and SlowFast-tiny in f32:
    placements, shard and momentum numel, the loss and state against the
    unsharded step. (e) Times beside the card's name and power limit: the
    tp forward and step (rank 0, the ranks sharing the card, gloo's
    host-staged all-reduces) against one process unsharded; #4-#8 at the
    local shapes against the same blocks at whole heads.
27. The Ego4d audio front end (``data/ego4d`` ``signal_transform``: an STFT
    of 1024 samples every 512 under a symmetric Hann window, the HTK mel
    filterbank to 256 mels, MFCCs) at its real window, 10 s at 48 kHz (936
    frames x 513 bins); no TPU kernel lies on this path, and every part's
    kernel counters must read 0. (a) Each of the three types on 32 seeded
    waveforms in float32 on the card against the port's CPU float64 result,
    within 1e-5 of max |value|. (b) The mel spectrograms as
    ``create_audio_visual_slowfast()``'s audio pathway (transposed,
    subsampled to 128 frames and 80 mels, as the JAX package composes the
    two), beside phase 24's visual pathways: the bf16 deploy form at B8 and
    B32, its B8 logits against the plain f32 model (phase 4's bound), and
    the front end's and the forward's ms at each batch. (c)
    ``Ego4dMomentsDataset._transform_mm`` over a sample whose video and audio
    lie on the card (annotations and an IMU CSV written under ``build/``):
    the spectrogram and the IMU window come out on the card, the window and
    the one-hot labels equal the host's, the spectrogram within 1e-5 of max
    |value| of the host's.
28. The native decoder (``data/native_build.py`` builds ``native/decode.cc``
    and ``native/pipeline.cc`` with g++ and FFmpeg at first use) and
    MixVideo's ``x_audio``. (a) Where ``g++`` and the four FFmpeg packages
    of ``pkg-config`` are present: a seeded file written by ``mux_av`` (300
    frames of 240x320 at 30 fps, FFV1; 10 s of 48 kHz mono audio,
    pcm_s16le), decoded through ``EncodedVideo.from_path(decoder="native",
    decode_audio=True)`` and ``from_bytes`` (frames bit for bit, audio
    within 2e-4); eight 2 s clips through one handle and through
    ``NativeDecodePipeline`` (4 threads) at the file's size (bit for bit)
    and rescaled to 182x242 in native code, each timed; the clips through
    X3D-S's val chain on the card into ``x3d_s`` deploy bf16 at B8 (logits on
    the decoded clips equal to those on the written frames; 22 #1 launches
    a forward); the visual pathways and the decoded audio, through phase
    27's front end, into AV SlowFast-R50 deploy bf16 at B8 against the f32
    model on the written waveform (phase 4's bound). Where any is missing,
    one line names it and (a) does not run. (b) An AV SlowFast-R50 batch at
    B8 (fast 32x224x224, 128 x 80 audio, f32) mixed on the card by
    ``MixVideo(x_audio=...)`` with a CUDA generator, CutMix and MixUp, each
    against the CPU's mix at the card's draws (CutMix exactly, MixUp within
    1e-6 relative); one bf16 training step of the SlowFast-R50 preset on the
    CutMix batch, its loss finite. No kernel launches in (a)'s AV part or in
    (b).
29. The examples (``examples_torch/``) at full width, seeded random weights.
    (a) The model-zoo eval protocol of ``eval_kinetics.evaluate`` (clip
    sampler, transforms, ``BatchLoader`` with 4 threads, f32 forward,
    sum ensemble) on ``x3d_s`` at 10x3 views of 13x182x182,
    ``mvit_base_16x4`` at 5x1 of 16x224x224 and ``slowfast_r50`` at 10x3 of
    32x256x256 (alpha 4): seeded uint8 videos of 10 s at 30 fps and
    240x320, 4 a model (2 for SlowFast), handed over in memory through the
    harness's ``video_path_handler`` (the card's machine has no decoder;
    chosen before the run). The views must number videos x clips x crops,
    each video seen once a view; the ensembled logits within 1e-3 x max
    |logit| of the same run under ``plain_kernels()``, the predictions
    equal wherever the top-two margin exceeds that bound; MViT's #4 (f32:
    the CUDA cores) and #6 (tiled) launches, 32 and 38 a forward batch, and
    none on the other two. views/s and the host's ms a batch (waiting for
    the loader, in the forward call) are printed. The golden fixture
    (tests/test_eval_harness.py:38) on the card: the sum ensemble 100%
    top-1, max 0%. (b) ``accelerator_deployment.main(["--device",
    "cuda"])``: #1's launches, 22 a deploy forward as in phase 23, over
    every eager, warm-up and captured forward and the loaded program's; the
    deploy forms' logits (efficient, eager, compiled, transmuted) within
    3e-2 x max |logit| of the f32 model's, the exported program's within
    the same bound of the eager form's. The examples that read video files
    (hub inference, classification, SSL pretraining, detection) need a
    decoder and run in the CPU tests only.

Each phase from 15 on prints its seconds. ``python3 chip_smoke.py --phase N``
(N from 23 to 29) runs the build and that phase alone (no kernels line, no
ok line), a development run.

The line before the last is a JSON object with one entry per kernel, each
with its launches on its path (the attention forwards also by route; the
MViT kernels also at a capture of the training step, ``captured_step``), its
errors, its time per forward or per step beside its plain version's, the
library call's and its bound (the attention forwards and backwards also
by route and the first version's; the depthwise kernel's also on
``csn_r101``, under that key; the MViT kernels' launches in phase 25's
data-parallel step, ``data_parallel_step``, and #4's and #5's in its
sequence-parallel shards, ``sequence_parallel``; each MViT kernel's launches
on phase 26's tensor-parallel path, by route, and its errors, launches and
times at the local shapes, ``tensor_parallel``; #1's, #4's and #6's
launches on phase 29's example paths, ``phase29``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# X3D-S stride-1 conv_b shapes at 13x160x160 (T, H=W, C) and how many
# stride-1 blocks of each stage one forward runs.
STAGE_SHAPES = [(13, 40, 54), (13, 20, 108), (13, 10, 216), (13, 5, 432)]
STAGE_STRIDE1_BLOCKS = [2, 4, 10, 6]
KERNELS_PER_FORWARD = sum(STAGE_STRIDE1_BLOCKS)  # 22
# Every one of them takes the tiled route, in bf16 and in f32 (C even).
X3D_PER_FORWARD = {"depthwise3x3x3_bn_swish": KERNELS_PER_FORWARD,
                   "depthwise3x3x3_bn_swish.tiled": KERNELS_PER_FORWARD}
# The tiled depthwise kernel (#1) per B128 forward against its first version
# (the scalar route on the same inputs), both on cuda_time_ms: the run fails
# above this share.
DEPTHWISE_GATE_SHARE = 0.5
# Kernel vs plain version. f32: summation order only. bf16: the inputs are
# the same bf16 values, so the kernel differs from the f32 reference by the
# rounding of its output to bf16 (one ulp is 2^-7 relative at worst).
KERNEL_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=2**-7)}
# Attention in f32 sums 96-wide dot products and up to 3137 weighted rows in
# another order than the plain version's cuBLAS.
ATTENTION_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": KERNEL_TOL["bfloat16"]}
# Logits vs the f32 eval model, relative to the largest reference logit:
# the f32 deploy form differs only by BN folding and summation order; the
# bf16 one rounds weights and every activation to 8 bits of mantissa.
LOGIT_REL_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
BATCHES = (1, 8, 128)

# CSN-R101 at 32x224x224 (no stem pool, so stage 1 runs at 112x112): its
# stride-1 depthwise conv_b shapes (T, H = W, C) and how many blocks of each
# stage run one (all but each strided stage's first block).
CSN_SHAPES = [(32, 112, 64), (16, 56, 128), (8, 28, 256), (4, 14, 512)]
CSN_STRIDE1_BLOCKS = [3, 3, 22, 2]
CSN_KERNELS_PER_FORWARD = sum(CSN_STRIDE1_BLOCKS)  # 30
CSN_PER_FORWARD = {"depthwise3x3x3_bn_swish": CSN_KERNELS_PER_FORWARD,
                   "depthwise3x3x3_bn_swish.tiled": CSN_KERNELS_PER_FORWARD}
CSN_CHECK_BATCH = 2
CSN_TIMING_BATCH = 8
# The ResNet family's clips, (T, H, W) or a list of one per pathway
# (SlowFast's [slow, fast]), and the batches
# served: up to B64 for SlowFast-R50 (the batch of BASELINE.json's
# SlowFast-R50 serving metric), B8 for CSN-R101; the logits are checked at a
# small batch.
RESNET_SERVED = {
    "slowfast_r50": ([(8, 224, 224), (32, 224, 224)], (1, 8, 64), 4),
    "csn_r101": ((32, 224, 224), (1, 8), CSN_CHECK_BATCH),
}
# One B2 forward of each other factory, deploy f32 and bf16 against plain f32.
RESNET_CHECKED = {
    "slow_r50": (8, 224, 224),
    "c2d_r50": (8, 224, 224),
    "i3d_r50": (8, 224, 224),
    "r2plus1d_r50": (16, 224, 224),
    "slowfast_r101": [(8, 224, 224), (32, 224, 224)],
    "slowfast_16x8_r101_50_50": [(16, 224, 224), (64, 224, 224)],
}

# MViT-B 16x4 at 16x224x224: tokens (8, 56, 56), head_dim 96 everywhere.
MVIT_CLIP = (16, 224, 224)
MVIT_BATCHES = (1, 8, 32)
MVIT_CHECK_BATCH = 4
MVIT_TIMING_BATCH = 32
HEAD_DIM = 96
# Distinct attention shapes: (H*c, heads, Lq of the grid, Lk with the cls
# row, blocks of that shape). Each block also runs its cls query (Lq 1)
# against the same keys.
MVIT_ATTENTION = [
    (96, 1, 25088, 393, 1),
    (192, 2, 6272, 1569, 1),
    (192, 2, 6272, 393, 1),
    (384, 4, 1568, 1569, 1),
    (384, 4, 1568, 393, 10),
    (768, 8, 392, 1569, 1),
    (768, 8, 392, 393, 1),
]
MVIT_32X3_BLOCK14 = (768, 8, 784, 3137)
# Pool geometries: (input grid (T, H, W, C), kernel, stride, mode, launches
# per forward). Conv: the k and v pools of every block and the q pools of
# blocks 1, 3 and 14; max: the skip pools of blocks 1, 3 and 14.
MVIT_POOLS = [
    ((8, 56, 56, 96), (3, 3, 3), (1, 8, 8), "conv", 2),
    ((8, 56, 56, 192), (3, 3, 3), (1, 4, 4), "conv", 2),
    ((8, 56, 56, 192), (3, 3, 3), (1, 2, 2), "conv", 1),
    ((8, 28, 28, 192), (3, 3, 3), (1, 4, 4), "conv", 2),
    ((8, 28, 28, 384), (3, 3, 3), (1, 2, 2), "conv", 3),
    ((8, 14, 14, 384), (3, 3, 3), (1, 2, 2), "conv", 20),
    ((8, 14, 14, 768), (3, 3, 3), (1, 1, 1), "conv", 2),
    ((8, 14, 14, 768), (3, 3, 3), (1, 2, 2), "conv", 1),
    ((8, 7, 7, 768), (3, 3, 3), (1, 1, 1), "conv", 2),
    ((8, 56, 56, 192), (1, 3, 3), (1, 2, 2), "max", 1),
    ((8, 28, 28, 384), (1, 3, 3), (1, 2, 2), "max", 1),
    ((8, 14, 14, 768), (1, 3, 3), (1, 2, 2), "max", 1),
]
MVIT_BLOCKS = sum(n for *_, n in MVIT_ATTENTION)  # 16


def tiled(counts: dict) -> dict:
    """``counts`` with every token-pool wrapper's launches also on its
    ``tiled`` route: MViT-B's pools (f32 and bf16, C a multiple of 8, kernel
    (3, 3, 3) or (1, 3, 3)) take it throughout."""
    return {**counts, **{f"{name}.tiled": n for name, n in counts.items()
                         if name.startswith("token_pool") and "." not in name}}


# In bf16 the attention forward takes the tensor cores for the grid queries
# and the split-key route for the cls query (Lq 1); in f32 the CUDA cores.
MVIT_PER_FORWARD = tiled({
    "pooled_attention_packed": 2 * MVIT_BLOCKS,  # 32
    "pooled_attention_packed.tensor_core": MVIT_BLOCKS,
    "pooled_attention_packed.split_key": MVIT_BLOCKS,
    "token_pool_conv": sum(n for *_, mode, n in MVIT_POOLS if mode == "conv"),  # 35
    "token_pool_max": sum(n for *_, mode, n in MVIT_POOLS if mode == "max"),  # 3
})
POOL_FIRST_PER_FORWARD = tiled({
    "pooled_attention": MVIT_BLOCKS,  # 16, cls row included: tensor cores
    "pooled_attention.tensor_core": MVIT_BLOCKS,
    "token_pool_conv": MVIT_PER_FORWARD["token_pool_conv"],
    "token_pool_max": MVIT_PER_FORWARD["token_pool_max"],
})
FORWARD_WRAPPERS = ("pooled_attention_packed", "pooled_attention")
# The attention forwards and backwards: the wrappers whose float32 calls
# take another route (cuda_core) than their bf16 ones.
ROUTED_WRAPPERS = (*FORWARD_WRAPPERS, "pooled_attention_packed_bwd", "pooled_attention_bwd")
# Training: the step's batch (timings of phase 8 too) and the preset's own.
TRAIN_BATCH = 8
PRESET_BATCH = 2
# The timed window is the preset's log interval (trainer.log_every_n_steps),
# so it reads the loss back to the host as often as a user's run does: once.
TRAIN_TIMED_STEPS = 10
LOSS_STEPS = 10
# Launches per training step (one forward and one backward): each attention
# and each conv pool runs its backward kernels once; the max pools' backward
# is PyTorch's own. In bf16 the attention backward takes the forward's
# routes: the tensor cores for the grid queries (and pool_first's per-head
# calls, cls row included), the split-key route for the cls query.
CONV_POOLS = MVIT_PER_FORWARD["token_pool_conv"]
MVIT_PER_STEP = tiled({**MVIT_PER_FORWARD, "token_pool_dx": CONV_POOLS,
                       "token_pool_dw": CONV_POOLS,
                       "pooled_attention_packed_bwd": MVIT_PER_FORWARD["pooled_attention_packed"],
                       "pooled_attention_packed_bwd.tensor_core": MVIT_BLOCKS,
                       "pooled_attention_packed_bwd.split_key": MVIT_BLOCKS})
POOL_FIRST_PER_STEP = tiled({**POOL_FIRST_PER_FORWARD, "token_pool_dx": CONV_POOLS,
                             "token_pool_dw": CONV_POOLS,
                             "pooled_attention_bwd": POOL_FIRST_PER_FORWARD["pooled_attention"],
                             "pooled_attention_bwd.tensor_core": MVIT_BLOCKS})
# Backward kernel vs its plain version in f32, elementwise |err| <= atol_rel
# x max |ref| + rtol x |ref|. f32: sums of up to 25088 products in another
# order (f32 eps 6e-8 x sqrt(25088) ~ 1e-5 of the largest term; 10x margin).
# bf16: each gradient is also rounded once to bf16 (2^-8 relative).
GRAD_TOL = {"float32": dict(rtol=1e-4, atol_rel=1e-4),
            "bfloat16": dict(rtol=2**-7, atol_rel=2e-3)}
# One step's gradients, kernels vs plain versions, per tensor: max |err| <=
# rel x max |its plain gradient| + floor x max |plain gradient of its
# module| (its block, or the embedding, norm or head it belongs to). f32:
# 16 blocks of f32 arithmetic in another order. bf16: both round every
# activation to bf16, at points where their f32 sums differ by an ulp, and
# 16 blocks carry the flips on. The floor covers tensors whose exact
# gradient is zero (norm_k's shift: one shift of every key leaves each
# softmax as it was), where both sides hold only rounding noise.
STEP_GRAD_TOL = {"float32": (1e-3, 1e-5), "bfloat16": (0.1, 0.01)}
# Phase 9's f32 check: skip max-pool windows whose argmax in the plain
# form's own input differs from the kernel form's (near-ties that rounding
# breaks apart). The seeded weights give 7 at B2; a wrong forward would
# move far more.
MAX_POOL_FLIPS = 64
# The bf16 attention backward (#3, #5) per training step against its first
# version (the CUDA-core kernels on the same inputs), both on cuda_time_ms:
# the run fails above this share.
BWD_GATE_SHARE = 0.25
# The token pool's tiled kernels (#6 per B32 forward; dx and dw each per B8
# step) against their first version (the scalar route on the same inputs),
# both on cuda_time_ms: the run fails above this share.
POOL_GATE_SHARE = 0.25
# MViT-B 16x4's kv pools as the fused op sees them: (unpooled grid (T, H, W),
# H*c, heads, kv stride, Lq of the grid queries, blocks of that geometry).
# Every block passes the card's ``fusable`` (the pooled grids are those of
# MVIT_ATTENTION, whose Lk counts the cls row).
MVIT_FUSED = [
    ((8, 56, 56), 96, 1, (1, 8, 8), 25088, 1),
    ((8, 56, 56), 192, 2, (1, 4, 4), 6272, 1),
    ((8, 28, 28), 192, 2, (1, 4, 4), 6272, 1),
    ((8, 28, 28), 384, 4, (1, 2, 2), 1568, 1),
    ((8, 14, 14), 384, 4, (1, 2, 2), 1568, 10),
    ((8, 14, 14), 768, 8, (1, 1, 1), 392, 1),
    ((8, 7, 7), 768, 8, (1, 1, 1), 392, 1),
]
FUSED_BLOCKS = sum(n for *_, n in MVIT_FUSED)  # 16
FUSED_EPS = 1e-6  # MViT's LayerNorm eps
# Per forward with fused_kvpool: one pool-LN launch per block (on the tiled
# route, f32 and bf16: head width 96), the attention for the grid and the
# cls query, the q pools of blocks 1, 3 and 14 (the k and v pools go into
# the fused kernel), the skip max pools.
FUSED_PER_FORWARD = tiled({
    "fused_kvpool_attention": FUSED_BLOCKS,
    "fused_kvpool_attention.tiled": FUSED_BLOCKS,
    "pooled_attention_packed": 2 * FUSED_BLOCKS,
    "pooled_attention_packed.tensor_core": FUSED_BLOCKS,
    "pooled_attention_packed.split_key": FUSED_BLOCKS,
    "token_pool_conv": MVIT_PER_FORWARD["token_pool_conv"] - 2 * FUSED_BLOCKS,  # 3
    "token_pool_max": MVIT_PER_FORWARD["token_pool_max"],
})
# Per step: the fused op's backward recomputes the unfused composition (the
# k and v conv pools and both attentions) and differentiates it.
FUSED_PER_STEP = tiled({**FUSED_PER_FORWARD,
                  "pooled_attention_packed": 4 * FUSED_BLOCKS,
                  "pooled_attention_packed.tensor_core": 2 * FUSED_BLOCKS,
                  "pooled_attention_packed.split_key": 2 * FUSED_BLOCKS,
                  "pooled_attention_packed_bwd": 2 * FUSED_BLOCKS,
                  "pooled_attention_packed_bwd.tensor_core": FUSED_BLOCKS,
                  "pooled_attention_packed_bwd.split_key": FUSED_BLOCKS,
                  "token_pool_conv": CONV_POOLS, "token_pool_dx": CONV_POOLS,
                  "token_pool_dw": CONV_POOLS})
# The tiled pool-LN launch of the fused op (#8's pool phase) per B32 bf16
# forward against its first version (the scalar route on the same inputs),
# both on cuda_time_ms: the run fails above this share.
POOL_LN_GATE_SHARE = 0.5
# The benchmark-only TPU variant `_pallas_nopad` (benchmarks/mvit_micro.py
# :236-241): (label, B, heads, Lq, c, Lk), per-head, bf16, residual on.
NOPAD_SHAPES = [("d0", 16, 1, 25089, 96, 393), ("d1", 16, 2, 6273, 96, 393),
                ("d3", 16, 4, 1569, 96, 393), ("d14", 16, 8, 393, 96, 99)]
# Published peaks of one H100 SXM at its 700 W limit (dense bf16 tensor
# cores; f32 on the CUDA cores; HBM3): the bound of a call is the larger of
# its operations over the peak of the units it can use and its bytes over
# the memory's.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Phase 17, compiled serving: (label, hub factory, its kwargs, clip, batches
# served, kernel launches per forward) of every deploy form phases 4-16
# serve, at their batches; the first four are also exported at B1.
COMPILED_SERVED = [
    ("x3d_s", "x3d_s", {"model_num_class": 400}, (13, 160, 160), BATCHES, X3D_PER_FORWARD),
    ("mvit_base_16x4", "mvit_base_16x4", {}, MVIT_CLIP, MVIT_BATCHES, MVIT_PER_FORWARD),
    ("mvit_base_16x4 fused_kvpool", "mvit_base_16x4", {"fused_kvpool": True}, MVIT_CLIP,
     MVIT_BATCHES, FUSED_PER_FORWARD),
    ("mvit_base_16x4 pool_first", "mvit_base_16x4", {"pool_first": True}, MVIT_CLIP,
     (MVIT_CHECK_BATCH,), POOL_FIRST_PER_FORWARD),
    ("slowfast_r50", "slowfast_r50", {}, RESNET_SERVED["slowfast_r50"][0],
     RESNET_SERVED["slowfast_r50"][1], {}),
    ("csn_r101", "csn_r101", {}, RESNET_SERVED["csn_r101"][0], RESNET_SERVED["csn_r101"][1],
     CSN_PER_FORWARD),
]
EXPORTED = ("x3d_s", "mvit_base_16x4", "mvit_base_16x4 fused_kvpool", "csn_r101")
# The pvt:: op of a counted wrapper, where its name differs: an exported
# graph's nodes by op name are held against the eager launches by wrapper.
PVT_OP = {"fused_kvpool_attention": "kvpool_ln"}
# Host-clock samples of one served forward, each after a synchronise.
HOST_SAMPLES = 3
# Forwards the profiler traces for a form's busy share.
PROFILED_CALLS = 2

# Phase 18, BatchNorm-family training. X3D-S on bench.py:317's recipe (SGD
# momentum 0.9 at LR 0.1, MixUp alpha 1.0 with label smoothing 0.1, bf16)
# at the anchor's B64 and at B128; SlowFast-R50 on its preset at
# bench.py:418's B32; the X3D-XS preset at its B16.
X3D_S_CLIP = (13, 160, 160)
BN_X3D_BATCHES = (64, 128)
SLOWFAST_CLIPS = [(8, 224, 224), (32, 224, 224)]
BN_SLOWFAST_BATCH = 32
BN_TIMED_STEPS = 4
BN_CHECK_BATCH = 8
X3D_XS_BATCH = 16
X3D_XS_STEPS = 3
PRECISE_BN_BATCHES = 4
# X3D-S's stem BN (24 channels at 13x80x80) and its last stage's norm_b (432
# channels at 13x5x5), at the check batch.
BN_LAYER_SHAPES = {"stem": (BN_CHECK_BATCH, 24, 13, 80, 80),
                   "last stage norm_b": (BN_CHECK_BATCH, 432, 13, 5, 5)}
# A bf16 train-mode BN output against the f64 reference: one bf16 rounding of
# an f32 result (KERNEL_TOL's bf16 bound). Its running mean and biased
# variance: float32 statistics of the same bf16 values, |err| within
# BN_STAT_REL x (|ref| + the batch's std) for the mean, x ref for the var.
BN_STAT_REL = 1e-5
# Precise BN against the mean of the per-batch stats taken separately,
# relative to each tensor's largest value.
PRECISE_BN_REL = 1e-5
# One X3D-S step's gradients in bf16 compute against f32 compute. Phase 9's
# per-tensor bf16 bounds (STEP_GRAD_TOL, which hold two bf16 forms against
# each other) do not hold bf16 against f32 in a BatchNorm network: its
# backward takes each channel's mean and projection out of a bf16 gradient,
# and what is left carries bf16's rounding magnified. On X3D-S B8 (seeded
# ``randomize_`` weights) the worst tensor sits at about 9x those bounds
# against f32 and against f64, where the f32 step sits well inside them
# against f64 (benchmarks_torch/bf16_grad_error.py); on the CPU the port's
# bf16 error stays within twice the JAX package's own
# (tests/test_torch_train_bn.py). So the check holds the whole gradient:
# its relative L2 error and cosine, each stage's relative L2 error below 1
# (a stage of zero gradients gives 1), and the loss (LOGIT_REL_TOL's bf16
# bound); the per-tensor share is printed.
BF16_STEP_GLOBAL_REL = 0.3
BF16_STEP_MIN_COS = 0.95
BF16_STEP_STAGE_REL = 1.0


# Phase 19, the captured training step. MViT-B's recipe at B8 and B2
# (unfused) and B8 (fused_kvpool), every dropout 0 from construction (its
# config's DropPath is 0; the head's dropout set to 0): CAPTURED_STEPS steps
# of the eager step and of the captured one from the same weights and
# batches; then each form timed. The BN models: CAPTURED_BN_STEPS steps at
# the batches of phase 18.
CAPTURED_CASES = [("mvit_base_16x4", {}, TRAIN_BATCH, MVIT_PER_STEP),
                  ("mvit_base_16x4", {}, PRESET_BATCH, MVIT_PER_STEP),
                  ("mvit_base_16x4 fused_kvpool", {"fused_kvpool": True}, TRAIN_BATCH,
                   FUSED_PER_STEP)]
CAPTURED_STEPS = 5
CAPTURED_TIMED_STEPS = 5
CAPTURED_BN_STEPS = 5
# A schedule whose LR is 0 at every step, and no MixUp: parameters that do
# not move and a batch as it is, so two replays on one batch differ only by
# their dropout masks.
ZERO_LR = {"lr_scheduler.lr_policy": "steps_with_relative_lrs", "lr_scheduler.lr": 0.0,
           "lr_scheduler.steps": [0], "lr_scheduler.lrs": [1.0],
           "lr_scheduler.warmup_iters": 0, "mix.enabled": False}
REMAT_CHECKED = (None, "full", "dots_with_no_batch_dims_saveable")
# Phase 19 (e), the LR on the device: LR_CHECK_STEPS updates in f32 compute
# (TF32 off, as the whole run), a new LR at each (the MViT recipe's warm-up;
# X3D-S's SGD with a 10-step warm-up from 0.01), every dropout 0. Each
# parameter's change over them, captured against eager: |dc - de| <=
# LR_CHECK_REL x |de| (L2 norms per tensor). A graph that kept one LR, or
# skipped the update, moves the change by tens of percent (printed).
# The whole change over the six updates, captured against eager, within
# LR_CHECK_WHOLE_REL (relative L2): the eager step's own spread, eager
# against eager, was up to 8.6e-5 (MViT-B; PyTorch's atomic max-pool
# backward) and 1.6e-5 (X3D-S; cuDNN's algorithms) in two runs.
LR_CHECK_STEPS = 6
LR_CHECK_REL = 1e-5
LR_CHECK_WHOLE_REL = 1e-3
LR_CHECK_BATCH = {"mvit_base_16x4": PRESET_BATCH, "x3d_s": BN_CHECK_BATCH}
# The kernels' forwards: under remat the recomputation runs each once more.
FORWARD_KERNELS = ("pooled_attention_packed", "pooled_attention", "token_pool_conv",
                        "token_pool_max", "token_pool_avg", "fused_kvpool_attention")


def remat_per_step(per_step: dict) -> dict:
    """Launches per step with the forward checkpointed: each forward kernel
    twice (the forward, then its recomputation in the backward)."""
    return {key: n * (2 if key.split(".")[0] in FORWARD_KERNELS else 1)
            for key, n in per_step.items()}


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn()`` over ``iters`` calls, by CUDA events: the
    device's time where it is the slower side, the host's launches where
    they are (a served forward at B1)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, "operations" or "bytes"): the card's bound for one call,
    its operations at ``peak_flops`` (default: the tensor cores' bf16)."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_turns(fns: dict, iters: int, warmup: int = 2) -> dict:
    """Each of ``fns`` (key -> call) timed in turns, in order and then in
    reverse; the faster run of each."""
    order = list(fns.items())
    runs = {key: [] for key in fns}
    for key, fn in order + order[::-1]:
        runs[key].append(cuda_time_ms(fn, iters, warmup))
    return {key: min(ts) for key, ts in runs.items()}


def per_forward(rows, extra=()) -> dict:
    """Sums the per-call times and bounds of ``rows`` (each with its
    per-forward ``calls``) into one forward's figures."""
    total = {key: sum(r["calls"] * r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms", *extra)}
    by_time = {}
    for r in rows:
        by_time[r["bound_by"]] = by_time.get(r["bound_by"], 0.0) + r["calls"] * r["bound_ms"]
    total["bound_by"] = max(by_time, key=by_time.get)
    return total


def by_route_ms(rows) -> dict:
    """ms per forward or step of token-pool ``rows`` timed through both
    routes: ``ms`` on the tiled route, ``first_ms`` on the scalar one."""
    return {"tiled": sum(r["calls"] * r["ms"] for r in rows),
            "scalar": sum(r["calls"] * r["first_ms"] for r in rows)}


def pool_routes(counts: dict, names) -> dict:
    """The per-route launches of the token-pool wrappers ``names``, summed."""
    return {route: sum(counts.get(f"{name}.{route}", 0) for name in names)
            for route in ("tiled", "scalar")}


def route_sums(rows) -> dict:
    """ms per forward of ``rows`` by the route each shape takes."""
    sums = {}
    for r in rows:
        sums[r["route"]] = sums.get(r["route"], 0.0) + r["calls"] * r["ms"]
    return sums


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its count is read under."""
    from pytorchvideo_tpu_torch import ops

    return ops.kernel_wrappers()


def reset_counts() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_route"):
            wrapper.launches_by_route = dict.fromkeys(wrapper.launches_by_route, 0)


def read_counts() -> dict:
    """Each wrapper's launches, and per route as "<name>.<route>" (the
    attention and token-pool wrappers)."""
    counts = {}
    for name, wrapper in kernel_wrappers().items():
        counts[name] = wrapper.launches
        for route, n in getattr(wrapper, "launches_by_route", {}).items():
            counts[f"{name}.{route}"] = n
    return counts


def by_route(counts: dict, name: str) -> dict:
    """The per-route launches of ``name`` in ``counts``."""
    return {key.split(".")[1]: n for key, n in counts.items() if key.startswith(name + ".")}


def f32_routes(per_run: dict) -> dict:
    """The launches of ``per_run`` (a bf16 path's) when the path runs in
    float32: every attention forward and backward on the CUDA cores; the
    pools stay on their tiled route."""
    out = {key: n for key, n in per_run.items()
           if "." not in key or key.split(".")[0] not in ROUTED_WRAPPERS}
    for name in ROUTED_WRAPPERS:
        if per_run.get(name):
            out[f"{name}.cuda_core"] = per_run[name]
    return out


def check_path_counts(label: str, counts: dict, per_run_counts: dict, runs: int,
                      unit: str = "forwards") -> None:
    """Each kernel of the path launched its count per run (a forward or a
    training step); no other ran."""
    expected = {name: per_run_counts.get(name, 0) * runs for name in counts}
    print(f"{label}: {runs} {unit}, kernel launches {({k: n for k, n in counts.items() if n})}")
    assert counts == expected, f"{label}: launches {counts}, expected {expected}"


def randomize_(model, generator, calibration_clips) -> None:
    """Seeded random weights: He-normal convs and linears, small biases, BN
    affine away from the identity: gamma in [0.5, 1.5], except the last BN of
    each residual branch (``norm_c``, which upstream zero-initialises) in
    [0.2, 0.4], so no branch is zeroed and none dominates. Each BN's running
    stats are then those of one train-mode forward of ``calibration_clips``
    (as precise BN would set them). Together these keep activations at the
    O(1) scale of a trained model: with arbitrary stats the 26 residual
    blocks compound them to ~1e5, and with gamma_c near 1 the random network
    amplifies bf16 rounding by ~1% per block. ``calibration_clips`` is the
    model's input: one NCTHW batch, or a list of them (SlowFast's
    ``[slow, fast]``)."""
    import torch
    import torch.nn as nn

    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, (nn.Conv3d, nn.Linear)):
                fan_in = module.weight[0].numel()
                w = torch.randn(module.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
                module.weight.copy_(w.to(module.weight.device))
                if module.bias is not None:
                    b = torch.randn(module.bias.shape, generator=generator) * 0.1
                    module.bias.copy_(b.to(module.bias.device))
            elif isinstance(module, nn.BatchNorm3d):
                c, dev = module.num_features, module.weight.device
                low, high = (0.2, 0.4) if name.endswith("norm_c") else (0.5, 1.5)
                gamma = low + (high - low) * torch.rand(c, generator=generator)
                module.weight.copy_(gamma.to(dev))
                module.bias.copy_((torch.randn(c, generator=generator) * 0.1).to(dev))
                module.reset_running_stats()
                module.momentum = None  # cumulative: one batch sets the stats
        model.train()
        model(calibration_clips)
        model.eval()
        for module in model.modules():
            if isinstance(module, nn.BatchNorm3d):
                module.momentum = 0.1


def randomize_mvit_(model, generator) -> None:
    """Seeded random weights for an MViT: Linear, conv and pool weights
    normal with std 1/sqrt(fan_in) (so q and k are of unit scale and the
    softmax is neither flat nor one-hot), biases and LN shifts normal with
    std 0.02, LN gains uniform in [0.9, 1.1], the cls token and position
    tables normal with std 0.02 (nonzero, as upstream's init)."""
    import torch
    import torch.nn as nn

    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                if isinstance(module, nn.LayerNorm) and name == "weight":
                    v = 0.9 + 0.2 * torch.rand(p.shape, generator=generator)
                elif name == "weight" and p.dim() >= 2:
                    v = torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel())
                else:  # biases, LN shifts, cls token, position tables
                    v = torch.randn(p.shape, generator=generator) * 0.02
                p.copy_(v.to(p.device, p.dtype))
    model.eval()


@contextlib.contextmanager
def plain_kernels():
    """Swaps the MViT layers' kernel dispatchers for the plain versions, so
    that a model on the card runs no kernel, forward or backward (autograd
    differentiates the plain versions): the reference of the logit and
    gradient checks."""
    from pytorchvideo_tpu_torch.layers import attention
    from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
    pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")
    from pytorchvideo_tpu_torch.ops import token_pool as tp

    plain = {
        "fused_kvpool_attention": fk.fused_kvpool_attention_torch,
        "pooled_attention_packed": pa.pooled_attention_packed_torch,
        "pooled_attention": pa.pooled_attention_torch,
        "depthwise_token_pool": tp.depthwise_token_pool_torch,
        "max_token_pool": tp.max_token_pool_torch,
        "avg_token_pool": tp.avg_token_pool_torch,
    }
    saved = {name: getattr(attention, name) for name in plain}
    for name, fn in plain.items():
        setattr(attention, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


def max_pool_indices(x, kernel_size, stride):
    """Each window's argmax of the token max pool of x (B, T, H, W, C), as
    ``F.max_pool3d`` (-inf padding k // 2) picks it: (B, C, T', H', W')
    indices into the flattened (T, H, W) grid."""
    import torch.nn.functional as F

    return F.max_pool3d(x.detach().permute(0, 4, 1, 2, 3), kernel_size, stride,
                        [k // 2 for k in kernel_size], return_indices=True)[1]


def gather_at(x, indices):
    """(B, T, H, W, C) -> the pooled (B, T', H', W', C) values at
    ``indices`` (from :func:`max_pool_indices`), by a gather whose gradient
    lands at those positions."""
    flat = x.permute(0, 4, 1, 2, 3).flatten(2)
    return flat.gather(2, indices.flatten(2)).view(indices.shape).permute(0, 2, 3, 4, 1)


class SharedMaxRouting:
    """Phase 9's and phase 14's f32 gradient checks route both forms'
    max-pool gradients alike: under :meth:`record` (the first form) each
    float32 token max pool (MViT's skip pools) keeps PyTorch's argmax of its
    input, and the kernel's output must equal the values at those positions
    exactly, so the kernel picked a maximum of each window; under
    :meth:`replay` (the second form, inside its own context) the pools, in
    the same order, take those positions by a gather (the form's own pool
    still runs, so its launches count as the form's; its output is
    dropped). A window whose two largest values tie
    within rounding otherwise routes its token's gradient to different
    places in the two forms, and the check fails on weights that hold such
    a window. Only an exact tie, which the kernel's own backward may break
    another way, is left to route apart. ``flips`` counts the windows whose
    argmax in the plain form's own input differs; it must stay within
    ``MAX_POOL_FLIPS``, so that a wrong forward cannot hide behind the
    shared routing. bfloat16 pools run as they are."""

    def __init__(self):
        self.indices, self.flips = [], 0

    @contextlib.contextmanager
    def _wrapped(self, pool_fn):
        from pytorchvideo_tpu_torch.layers import attention

        saved = attention.max_token_pool
        attention.max_token_pool = pool_fn(saved)
        try:
            yield
        finally:
            attention.max_token_pool = saved

    def record(self):
        import torch

        self.indices = []

        def recording(pool):
            def forward(x, kernel_size, stride):
                out = pool(x, kernel_size, stride)
                if x.dtype == torch.float32:
                    indices = max_pool_indices(x, kernel_size, stride)
                    assert torch.equal(out, gather_at(x.detach(), indices)), (
                        "max pool: the kernel's output is not the window maxima")
                    self.indices.append(indices)
                return out
            return forward

        return self._wrapped(recording)

    @contextlib.contextmanager
    def replay(self, context):
        import torch

        recorded = iter(self.indices)

        def replaying(pool):
            def forward(x, kernel_size, stride):
                if x.dtype != torch.float32:
                    return pool(x, kernel_size, stride)
                indices = next(recorded)
                self.flips += int((max_pool_indices(x, kernel_size, stride) != indices).sum())
                pool(x, kernel_size, stride)
                return gather_at(x, indices)
            return forward

        with context(), self._wrapped(replaying):
            yield


def check_logits(label: str, got: dict, ref) -> None:
    """Logits of each form in ``got`` against ``ref``: max |err| within
    LOGIT_REL_TOL x max |ref|, and top-1 equal on every row whose top-two
    margin exceeds twice the measured error (an error that small cannot flip
    it)."""
    scale = ref.abs().max().item()
    assert math.isfinite(scale) and scale > 0
    for name, logits in got.items():
        assert logits.shape == ref.shape and bool(logits.isfinite().all()), f"{label}: bad logits"
        err = (logits - ref).abs().max().item()
        bound = LOGIT_REL_TOL[name] * scale
        top2 = ref.topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * err
        agree = logits.argmax(1) == ref.argmax(1)
        print(f"{label} {name} vs plain f32, B{len(ref)}: max |err| {err!r} "
              f"(bound {bound!r} = {LOGIT_REL_TOL[name]} x max |logit| {scale!r}); "
              f"top-1 agrees on {int(agree.sum())}/{len(agree)} rows, "
              f"{int(agree[decided].sum())}/{int(decided.sum())} rows decided by 2 x max |err|")
        assert err <= bound, f"{label} {name} logits off by {err} > {bound}"
        assert bool(agree[decided].all()), f"{label} {name} top-1 disagrees with the f32 model"


def check_kernel(dw) -> dict:
    """Phase 3: the kernel against its plain version at B2, every call on
    the tiled route; then timed at B128 bf16 through the tiled route and
    the first version (the scalar route), with the plain version and the
    library call beside them."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    before = read_counts()
    for T, S, C in STAGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(2, T, S, S, C, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, C, device="cuda", generator=gen) * 0.2).to(dtype)
            s = (torch.rand(C, device="cuda", generator=gen) + 0.5).to(dtype)
            b = (torch.randn(C, device="cuda", generator=gen) * 0.1).to(dtype)
            for swish in (False, True):
                for scale, bias in ((None, None), (s, b)):
                    out = dw.depthwise3x3x3_bn_swish(x, w, scale, bias, swish)
                    torch.cuda.synchronize()
                    ref = dw.depthwise3x3x3_bn_swish_torch(
                        x.float(),
                        w.float(),
                        None if scale is None else scale.float(),
                        None if bias is None else bias.float(),
                        swish,
                    )
                    assert out.shape == x.shape and out.dtype == dtype
                    torch.testing.assert_close(out.float(), ref, **KERNEL_TOL[name])
                    errs[name] = max(errs[name], (out.float() - ref).abs().max().item())
    calls = 8 * len(STAGE_SHAPES)
    expected = {"depthwise3x3x3_bn_swish": calls, "depthwise3x3x3_bn_swish.tiled": calls,
                "depthwise3x3x3_bn_swish.scalar": 0}
    moved = {name: read_counts()[name] - before[name] for name in expected}
    assert moved == expected, f"depthwise checks: launches {moved}, expected {expected}"
    print(f"kernel vs plain (all tiled): max |err| f32 {errs['float32']!r}, bf16 "
          f"{errs['bfloat16']!r} (tolerances {KERNEL_TOL})")

    per_shape = []
    for (T, S, C), calls in zip(STAGE_SHAPES, STAGE_STRIDE1_BLOCKS):
        x = torch.randn(128, T, S, S, C, device="cuda", generator=gen).bfloat16()
        w = torch.randn(3, 3, 3, C, device="cuda", generator=gen).bfloat16()
        s = (torch.rand(C, device="cuda", generator=gen) + 0.5).bfloat16()
        b = torch.randn(C, device="cuda", generator=gen).bfloat16()
        # The library call: the depthwise conv alone, on the same
        # channels-last input seen as NCTHW.
        x_ncthw = x.permute(0, 4, 1, 2, 3)
        w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
        # Both routes' B128 outputs, held against the plain version in f32.
        ref = dw.depthwise3x3x3_bn_swish_torch(x.float(), w.float(), s.float(), b.float(), True)
        err = 0.0
        for route in dw.DEPTHWISE_ROUTES:
            out = dw.depthwise3x3x3_bn_swish_cuda(x, w, s, b, True, route=route).float()
            torch.testing.assert_close(out, ref, **KERNEL_TOL["bfloat16"])
            err = max(err, (out - ref).abs().max().item())
        del out, ref
        # x in and the output out once in bf16, with the weights and the
        # affine; 27 FMAs, scale, bias and swish per output, on the CUDA
        # cores (a depthwise conv has no product for the tensor cores).
        bound, bound_by = bound_ms(x.numel() * (2 * 27 + 4), 2 * (2 * x.numel() + 29 * C),
                                   peak_flops=PEAK_F32_FLOPS)
        per_shape.append({"shape": f"B128 T{T} S{S} C{C}", "calls": calls,
                          "copy_bytes": dw.depthwise_copy_bytes(torch.bfloat16, C),
                          "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                          **time_turns({
                              "plain_ms": lambda: dw.depthwise3x3x3_bn_swish_torch(
                                  x, w, s, b, True),
                              "ms": lambda: dw.depthwise3x3x3_bn_swish_cuda(
                                  x, w, s, b, True, route="tiled"),
                              "first_ms": lambda: dw.depthwise3x3x3_bn_swish_cuda(
                                  x, w, s, b, True, route="scalar"),
                              "library_ms": lambda: F.conv3d(x_ncthw, w_conv, padding=1,
                                                             groups=C)}, iters=10)})
        r = per_shape[-1]
        print(f"depthwise3x3x3 B128 T{T} {S}x{S} C{C} bf16 swish: kernel (tiled, "
              f"{r['copy_bytes']}-byte copies) {r['ms']!r} ms, first version (scalar) "
              f"{r['first_ms']!r} ms, plain {r['plain_ms']!r} ms, F.conv3d(groups=C) alone "
              f"{r['library_ms']!r} ms, bound {bound!r} ms ({bound_by}); max |err| vs plain "
              f"f32 {err!r}")
        del x, x_ncthw
    new = sum(r["calls"] * r["ms"] for r in per_shape)
    old = sum(r["calls"] * r["first_ms"] for r in per_shape)
    print(f"depthwise3x3x3 per B128 forward (22 launches): tiled {new!r} ms against the first "
          f"version's {old!r} ms, ratio {new / old!r}; gate {DEPTHWISE_GATE_SHARE} x")
    assert new <= DEPTHWISE_GATE_SHARE * old, (
        f"depthwise3x3x3: {new} ms per forward, over {DEPTHWISE_GATE_SHARE} x the first "
        f"version's {old} ms")
    return {"errs": errs, "per_shape": per_shape}


def clips(B: int, clip, generator, dtype=None):
    """A seeded batch of B clips on the card: ``clip`` is one (T, H, W) of 3
    channels or one (C, T, H, W), or a list of them, one per pathway (then a
    list of batches)."""
    import torch

    if isinstance(clip, list):
        return [clips(B, c, generator, dtype) for c in clip]
    shape = tuple(clip) if len(clip) == 4 else (3, *clip)
    return torch.randn(B, *shape, generator=generator).to("cuda", dtype)


def cast(x, dtype):
    """x (a tensor or a list of pathway tensors) in ``dtype`` (None: as is)."""
    if dtype is None:
        return x
    return [p.to(dtype) for p in x] if isinstance(x, list) else x.to(dtype)


def serve(model, batches, generator, clip, classes: int) -> dict:
    """A slice's main path: request batches of ``clip``-sized clips (a list
    of clip sizes: one batch per pathway), with each batch's peak memory."""
    import torch

    rates = {}
    for B in batches:
        x = clips(B, clip, generator, torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = model(x)
            torch.cuda.synchronize()
            assert out.shape == (B, classes) and torch.isfinite(out.float()).all(), "bad logits"
            iters = 10 if B < max(batches) else 5
            ms = cuda_time_ms(lambda: model(x), iters, warmup=1)
        rates[B] = {"forwards": 2 + iters, "ms": ms, "clips_per_s": B * 1000.0 / ms,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
    return rates


def check_csn_kernel(dw) -> dict:
    """Phase 15: the depthwise kernel (#1) at CSN-R101's four stride-1
    shapes at B2, bias only (as the deploy form calls it) and with scale,
    bias and swish, in f32 and bf16, every call on the tiled route; then
    timed at B8 bf16 (bias only) beside its plain version and the library
    call, with its byte bound."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(15)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    before = read_counts()
    for T, S, C in CSN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(CSN_CHECK_BATCH, T, S, S, C, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, C, device="cuda", generator=gen) * 0.2).to(dtype)
            s = (torch.rand(C, device="cuda", generator=gen) + 0.5).to(dtype)
            b = (torch.randn(C, device="cuda", generator=gen) * 0.1).to(dtype)
            for scale, swish in ((None, False), (s, True)):
                out = dw.depthwise3x3x3_bn_swish(x, w, scale, b, swish)
                ref = dw.depthwise3x3x3_bn_swish_torch(
                    x.float(), w.float(), None if scale is None else scale.float(), b.float(),
                    swish)
                assert out.shape == x.shape and out.dtype == dtype
                torch.testing.assert_close(out.float(), ref, **KERNEL_TOL[name])
                errs[name] = max(errs[name], (out.float() - ref).abs().max().item())
            del x, out, ref
    calls = 4 * len(CSN_SHAPES)
    expected = {"depthwise3x3x3_bn_swish": calls, "depthwise3x3x3_bn_swish.tiled": calls,
                "depthwise3x3x3_bn_swish.scalar": 0}
    moved = {name: read_counts()[name] - before[name] for name in expected}
    assert moved == expected, f"CSN depthwise checks: launches {moved}, expected {expected}"
    print(f"kernel vs plain at CSN-R101's shapes, B{CSN_CHECK_BATCH} (all tiled): max |err| f32 "
          f"{errs['float32']!r}, bf16 {errs['bfloat16']!r} (tolerances {KERNEL_TOL})")

    per_shape = []
    B = CSN_TIMING_BATCH
    for (T, S, C), calls in zip(CSN_SHAPES, CSN_STRIDE1_BLOCKS):
        x = torch.randn(B, T, S, S, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, 3, C, device="cuda", generator=gen) * 0.2).bfloat16()
        b = (torch.randn(C, device="cuda", generator=gen) * 0.1).bfloat16()
        x_ncthw = x.permute(0, 4, 1, 2, 3)
        w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
        ref = dw.depthwise3x3x3_bn_swish_torch(x.float(), w.float(), None, b.float(), False)
        tiled = read_counts()["depthwise3x3x3_bn_swish.tiled"]
        out = dw.depthwise3x3x3_bn_swish_cuda(x, w, None, b, False).float()
        assert read_counts()["depthwise3x3x3_bn_swish.tiled"] == tiled + 1
        torch.testing.assert_close(out, ref, **KERNEL_TOL["bfloat16"])
        err = (out - ref).abs().max().item()
        plan = dw.tp.pool_tile_plan(B, T, S, S, C, dw.KERNEL_SIZE, dw.STRIDE, torch.bfloat16)
        del out, ref
        # x in and the output out once in bf16, with the taps and the bias;
        # 27 FMAs and the bias per output, on the CUDA cores.
        bound, bound_by = bound_ms(x.numel() * (2 * 27 + 1), 2 * (2 * x.numel() + 28 * C),
                                   peak_flops=PEAK_F32_FLOPS)
        per_shape.append({"shape": f"B{B} T{T} S{S} C{C}", "calls": calls,
                          "tile": [plan.tile_h, plan.tile_w], "blocks": plan.blocks,
                          "smem_bytes": plan.smem_bytes,
                          "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                          **time_turns({
                              "plain_ms": lambda: dw.depthwise3x3x3_bn_swish_torch(
                                  x, w, None, b, False),
                              "ms": lambda: dw.depthwise3x3x3_bn_swish_cuda(
                                  x, w, None, b, False, route="tiled"),
                              "library_ms": lambda: F.conv3d(x_ncthw, w_conv, padding=1,
                                                             groups=C)}, iters=5)})
        r = per_shape[-1]
        print(f"depthwise3x3x3 B{B} T{T} {S}x{S} C{C} bf16 bias only: kernel (tiled, tile "
              f"{plan.tile_h}x{plan.tile_w}, {plan.blocks} blocks, {plan.smem_bytes} B shared) "
              f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, F.conv3d(groups=C) alone "
              f"{r['library_ms']!r} ms, bound {bound!r} ms ({bound_by}); max |err| vs plain "
              f"f32 {err!r}")
        del x, x_ncthw
    total = per_forward(per_shape)
    print(f"depthwise3x3x3 per csn_r101 B{B} forward ({CSN_KERNELS_PER_FORWARD} launches): "
          f"kernel {total['ms']!r} ms, plain {total['plain_ms']!r} ms, F.conv3d(groups=C) "
          f"{total['library_ms']!r} ms, bound {total['bound_ms']!r} ms ({total['bound_by']})")
    torch.cuda.empty_cache()
    return {"errs": errs, "per_shape": per_shape}


def resnet_model(hub, name: str, clip, gen):
    """``hub.<name>()`` on the card with seeded random weights, BN stats
    measured on a B2 batch of ``clip``."""
    model = getattr(hub, name)()
    assert all(p.is_cuda for p in model.parameters()), f"{name} built off the card"
    randomize_(model, gen, clips(2, clip, gen))
    return model


def check_resnet_logits(convert_to_deployable_form, label: str, model, clip, B: int, gen,
                        per_forward_counts: dict):
    """The deploy forms' logits (f32 and bf16) against the plain f32 eval
    model (cuDNN, TF32 off) at B, each form's kernel launches counted."""
    import torch

    x = clips(B, clip, gen)
    with torch.no_grad():
        reset_counts()
        ref = model(x).float()
        assert not any(read_counts().values()), f"{label}: the plain model launched a kernel"
        got = {}
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            form = convert_to_deployable_form(model, dtype=dtype)
            reset_counts()
            got[name] = form(cast(x, dtype)).float()
            check_path_counts(f"{label} deploy {name}", read_counts(), per_forward_counts, 1)
            del form
    check_logits(label, got, ref)
    return {name: (logits - ref).abs().max().item() for name, logits in got.items()}


def resnet_slice(hub, convert_to_deployable_form) -> dict:
    """Phase 16: the ResNet family at full width. ``slowfast_r50`` and
    ``csn_r101`` serve their batches in their bf16 deploy form (CSN: 30
    depthwise launches per forward, all tiled; SlowFast: none); every other
    factory runs one B2 forward of each deploy form against the plain f32
    model."""
    import torch

    gen = torch.Generator().manual_seed(16)
    report = {}
    for name, (clip, batches, check_batch) in RESNET_SERVED.items():
        per_forward_counts = CSN_PER_FORWARD if name == "csn_r101" else {}
        model = resnet_model(hub, name, clip, gen)
        n_params = sum(p.numel() for p in model.parameters())
        errs = check_resnet_logits(convert_to_deployable_form, name, model, clip, check_batch,
                                   gen, per_forward_counts)
        deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
        del model
        torch.cuda.empty_cache()
        reset_counts()
        rates = serve(deploy, batches, gen, clip, 400)
        counts = read_counts()
        forwards = sum(r["forwards"] for r in rates.values())
        check_path_counts(f"{name} path", counts, per_forward_counts, forwards)
        shape = " + ".join("x".join(map(str, c)) for c in (clip if isinstance(clip, list)
                                                           else [clip]))
        for B, r in rates.items():
            print(f"{name} deploy bf16 {shape} B{B}: {r['clips_per_s']!r} clips/s "
                  f"({r['ms']!r} ms/forward), peak {r['peak_bytes']} bytes; {n_params} "
                  f"parameters")
        report[name] = {"rates": rates, "counts": counts, "forwards": forwards,
                        "logit_errs": errs}
        del deploy
        torch.cuda.empty_cache()
    for name, clip in RESNET_CHECKED.items():
        model = resnet_model(hub, name, clip, gen)
        report[name] = {"logit_errs": check_resnet_logits(
            convert_to_deployable_form, name, model, clip, 2, gen, {})}
        del model
        torch.cuda.empty_cache()
    return report


def host_ms(fn, samples: int = HOST_SAMPLES) -> float:
    """Median host ms of ``fn()``: the card synchronised before each call,
    the host clock read when it returns (the time to enqueue the forward)."""
    import statistics

    import torch

    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_spans(prof) -> list:
    """The (start, end) us of the device intervals ``device_union_ms`` unites."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name
                  and not e.name.startswith(("Optimizer.", DET_RANGE)))


def device_trace(fn):
    """A ``torch.profiler`` trace (device activity only) of ``fn()``, the card
    synchronised at both ends. A trace that holds no device interval at all
    is taken once more: on the card's machine the profiler now and then
    records nothing for a whole trace (phase 21 (d)'s RoIAlign once), which
    says nothing of ``fn``. ``device_union_ms`` fails when the second trace
    holds none either."""
    import torch

    for _ in range(2):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if device_spans(prof):
            break
    return prof


def device_union_ms(prof):
    """(busy ms, span ms) of a ``torch.profiler`` trace: the union of the
    device's kernel, copy and set intervals (not the optimizer's or
    ``detection_split``'s ``record_function`` spans, which the trace also
    puts on the device), and
    the span from the first one's start to the last one's end. A union, not
    a sum: cuDNN's grouped convs run kernels side by side, and a graph's
    independent branches overlap."""
    spans = device_spans(prof)
    assert spans, "the profiler saw no device activity"
    busy, (start, end) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > end:
            busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    return busy / 1000.0, (max(b for _, b in spans) - spans[0][0]) / 1000.0


def device_busy(fn, calls: int = PROFILED_CALLS):
    """(busy ms per call, busy share) of ``calls`` back-to-back ``fn()``s
    traced by ``torch.profiler`` (device activity only): the union of the
    device's intervals per call, and over the span (``device_union_ms``)."""
    fn()

    def back_to_back():
        for _ in range(calls):
            fn()

    busy, span = device_union_ms(device_trace(back_to_back))
    return busy / calls, busy / span


def compiled_model(hub, name: str, kwargs: dict, clip, gen):
    """``hub.<name>(**kwargs)`` on the card with the seeded random weights
    of its slice (``randomize_mvit_``, or ``randomize_`` with BN stats from a
    B2 batch)."""
    model = getattr(hub, name)(**kwargs)
    assert all(p.is_cuda for p in model.parameters()), f"{name} built off the card"
    if name.startswith("mvit"):
        randomize_mvit_(model, gen)
    else:
        randomize_(model, gen, clips(2, clip, gen))
    return model


def serve_compiled(label: str, compiled, batch_index: int, B: int, clip, gen,
                   per_forward_counts: dict, capture_peak: int) -> dict:
    """One batch of phase 17: the eager deploy form (``compiled.module``)
    and its captured graph ``compiled`` on the same inputs. Checks the
    eager forward's launches, the replayed logits against the eager ones
    (max |diff| within the bf16 logit bound), that two replays of different
    inputs return two different, unaliased tensors and that replays launch
    no wrapper; measures each form's clips/s (``cuda_time_ms``), host ms,
    busy share (:func:`device_busy`) and peak memory above what was
    allocated before (eager: one forward; compiled: ``capture_peak``, its
    construction's, warm-up and capture; a replay allocates only its
    output's clone)."""
    import torch

    eager = compiled.module
    x = clips(B, clip, gen, torch.bfloat16)
    x2 = clips(B, clip, gen, torch.bfloat16)
    iters = 10 if batch_index == 0 else 3
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        ref = eager(x)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - base
        check_path_counts(f"{label} B{B} eager", read_counts(), per_forward_counts, 1)
        eager_ms = cuda_time_ms(lambda: eager(x), iters, warmup=1)
        eager_host = host_ms(lambda: eager(x))
        eager_busy = device_busy(lambda: eager(x))
        ref2 = eager(x2)

        reset_counts()
        out = compiled(x)
        keep = out.clone()
        out2 = compiled(x2)
        compiled_ms = cuda_time_ms(lambda: compiled(x), iters, warmup=1)
        compiled_host = host_ms(lambda: compiled(x))
        compiled_busy = device_busy(lambda: compiled(x))
        assert not any(read_counts().values()), f"{label} B{B}: a replay launched a wrapper"
    scale = ref.float().abs().max().item()
    bound = LOGIT_REL_TOL["bfloat16"] * scale
    err = max((out.float() - ref.float()).abs().max().item(),
              (out2.float() - ref2.float()).abs().max().item())
    assert out.shape == ref.shape and bool(out.float().isfinite().all()), f"{label}: bad logits"
    assert err <= bound, f"{label} B{B}: replayed logits off the eager ones by {err} > {bound}"
    assert out.data_ptr() != out2.data_ptr() and torch.equal(out, keep), (
        f"{label} B{B}: the second replay overwrote the first one's logits")
    assert not torch.equal(out, out2), f"{label} B{B}: two inputs, one output"
    row = {
        "batch": B, "max_abs_diff_vs_eager": err, "bound": bound,
        "eager": {"ms": eager_ms, "clips_per_s": B * 1000.0 / eager_ms, "host_ms": eager_host,
                  "busy_ms": eager_busy[0], "busy": eager_busy[1], "peak_bytes": eager_peak},
        "compiled": {"ms": compiled_ms, "clips_per_s": B * 1000.0 / compiled_ms,
                     "host_ms": compiled_host, "busy_ms": compiled_busy[0],
                     "busy": compiled_busy[1], "peak_bytes": capture_peak},
    }
    e, c = row["eager"], row["compiled"]
    print(f"{label} B{B} bf16 eager / compiled: {e['clips_per_s']!r} / {c['clips_per_s']!r} "
          f"clips/s ({e['ms']!r} / {c['ms']!r} ms/forward), host {e['host_ms']!r} / "
          f"{c['host_ms']!r} ms/forward, busy {e['busy']!r} / {c['busy']!r} ({e['busy_ms']!r} / "
          f"{c['busy_ms']!r} ms/forward), peak {e['peak_bytes']} / {c['peak_bytes']} bytes; "
          f"replayed logits vs eager max |diff| {err!r} (bound {bound!r})")
    return row


def exported_counts(program) -> dict:
    """The ``pvt::`` nodes of an exported program, by op name."""
    nodes = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == "pvt":
            nodes[node.target._opname] = nodes.get(node.target._opname, 0) + 1
    return nodes


def check_export(label: str, deploy, clip, gen, per_forward_counts: dict) -> dict:
    """``export_program`` of the bf16 deploy form at B1, loaded back: one
    ``pvt::`` node per eager kernel launch; running it on the card moves the
    wrappers' counters by the eager per-forward counts; its logits against
    the eager form's (the bf16 logit bound)."""
    import io

    import torch
    from pytorchvideo_tpu_torch.accelerate import export_program

    x = clips(1, clip, gen, torch.bfloat16)
    t0 = time.perf_counter()
    data = export_program(deploy, x)
    program = torch.export.load(io.BytesIO(data))
    seconds = time.perf_counter() - t0
    launches = {name: n for name, n in per_forward_counts.items() if "." not in name}
    nodes = exported_counts(program)
    expected_nodes = {PVT_OP.get(name, name): n for name, n in launches.items()}
    assert nodes == expected_nodes, (
        f"{label} export: pvt:: nodes {nodes}, expected {expected_nodes}")
    with torch.no_grad():
        ref = deploy(x)
        reset_counts()
        out = program.module()(x)
        check_path_counts(f"{label} loaded program", read_counts(), per_forward_counts, 1)
    bound = LOGIT_REL_TOL["bfloat16"] * ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert out.shape == ref.shape and err <= bound, f"{label} export: logits off by {err} > {bound}"
    print(f"{label} export_program B1: {len(data)} bytes, export + save + load {seconds:.1f} s; "
          f"pvt:: nodes {nodes}; loaded program's logits vs eager max |diff| {err!r} "
          f"(bound {bound!r})")
    return {"bytes": len(data), "seconds": seconds, "nodes": nodes, "max_abs_diff_vs_eager": err}


def serve_compiled_model(convert_to_deployable_form, label: str, model, clip, batches, gen,
                         per_forward_counts: dict):
    """One model of phase 17: its bf16 deploy form captured at each of
    ``batches`` (the first by ``convert_to_deployable_form(example_input=)``,
    which drops ``model``, the others by ``CompiledForward`` in its pool),
    each capture's launches checked and each batch served by
    :func:`serve_compiled`. Returns (the report entry, the eager deploy
    form)."""
    import torch
    from pytorchvideo_tpu_torch.accelerate import CompiledForward
    from pytorchvideo_tpu_torch.accelerate.deploy import WARMUP_FORWARDS

    rows, compiled, pool_bytes = [], None, 0
    for i, B in enumerate(batches):
        x = clips(B, clip, gen, torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reserved, base = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        reset_counts()
        if compiled is None:
            compiled = convert_to_deployable_form(model, dtype=torch.bfloat16, example_input=x)
            del model
            graphs = [compiled]
        else:
            graphs.append(CompiledForward(compiled.module, x, pool=compiled.pool))
        torch.cuda.synchronize()
        capture_peak = torch.cuda.max_memory_allocated() - base
        pool_bytes += torch.cuda.memory_reserved() - reserved
        check_path_counts(f"{label} B{B} capture", read_counts(), per_forward_counts,
                          WARMUP_FORWARDS + 1, unit="forwards (warm-up and capture)")
        rows.append(serve_compiled(label, graphs[-1], i, B, clip, gen, per_forward_counts,
                                   capture_peak))
    entry = {"rows": rows, "reserved_growth_bytes": pool_bytes}
    print(f"{label}: {len(graphs)} graphs in one pool; the device memory reserved grew by "
          f"{pool_bytes} bytes while they were built (the deploy copy, warm-up, capture)")
    deploy = compiled.module
    del graphs, compiled
    torch.cuda.empty_cache()
    return entry, deploy


def compiled_slice(hub, convert_to_deployable_form) -> dict:
    """Phase 17: every deploy form served compiled (``example_input``: one
    CUDA graph per batch, the batches of one model in one memory pool)
    beside its eager form, and four of them exported and loaded back."""
    import torch

    gen = torch.Generator().manual_seed(17)
    report = {}
    for label, name, kwargs, clip, batches, per_forward_counts in COMPILED_SERVED:
        entry, deploy = serve_compiled_model(convert_to_deployable_form, label,
                                             compiled_model(hub, name, kwargs, clip, gen), clip,
                                             batches, gen, per_forward_counts)
        if label in EXPORTED:
            entry["export"] = check_export(label, deploy, clip, gen, per_forward_counts)
        del deploy
        torch.cuda.empty_cache()
        report[label] = entry
    return report


def attention_rows():
    """(H*c, heads, Lq, Lk, launches per forward) of every attention shape
    checked: MViT-B 16x4's grid queries, their cls queries (Lq 1) and MViT-B
    32x3's block 14 (on no path here)."""
    return [*MVIT_ATTENTION, *((hc, h, 1, lk, n) for hc, h, _, lk, n in MVIT_ATTENTION),
            (*MVIT_32X3_BLOCK14, 0)]


def close_rel(out, ref, rtol: float, atol_rel: float):
    """Asserts |out - ref| <= atol_rel x max |ref| + rtol x |ref| elementwise
    (ref in f32); returns (max |out - ref|, that over max |ref|)."""
    import torch

    out, scale = out.float(), ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol_rel * scale)
    err = (out - ref).abs().max().item()
    return err, err / scale


def worse(*pairs):
    """The elementwise max of (abs, rel) error pairs."""
    return tuple(max(p[i] for p in pairs) for i in range(2))


def check_attention(pa) -> dict:
    """Phase 5, attention: the kernel in both layouts against the plain
    version at B2, then timed at B32 bf16."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [row[:4] for row in attention_rows()]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for HC, H, Lq, Lk in shapes:
        c = HC // H
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(2, L, HC, device="cuda", generator=gen).to(dtype)
                       for L in (Lq, Lk, Lk))
            heads = [t.view(2, -1, H, c).transpose(1, 2).contiguous() for t in (q, k, v)]
            route = pa.forward_route(dtype, Lq, c)
            for residual in (False, True):
                reset_counts()
                out = pa.pooled_attention_packed(q, k, v, H, c**-0.5, residual)
                ref = pa.pooled_attention_packed_torch(
                    q.float(), k.float(), v.float(), H, c**-0.5, residual)
                out_h = pa.pooled_attention(*heads, c**-0.5, residual)
                ref_h = pa.pooled_attention_torch(*(t.float() for t in heads), c**-0.5, residual)
                torch.cuda.synchronize()
                counts = read_counts()
                assert all(by_route(counts, name)[route] == 1 for name in FORWARD_WRAPPERS), counts
                assert out.shape == q.shape and out.dtype == dtype and out_h.dtype == dtype
                torch.testing.assert_close(out.float(), ref, **ATTENTION_TOL[name])
                torch.testing.assert_close(out_h.float(), ref_h, **ATTENTION_TOL[name])
                errs[name] = max(errs[name], (out.float() - ref).abs().max().item(),
                                 (out_h.float() - ref_h).abs().max().item())
    print(f"pooled attention vs plain ({len(shapes)} shapes, both layouts, residual on and "
          f"off): max |err| f32 {errs['float32']!r}, bf16 {errs['bfloat16']!r}")

    B = MVIT_TIMING_BATCH
    packed, per_head, timed_err = [], [], 0.0
    for HC, H, Lq, Lk, calls in attention_rows():
        c = HC // H
        scale = c**-0.5
        q, k, v = (torch.randn(B, L, HC, device="cuda", generator=gen).bfloat16()
                   for L in (Lq, Lk, Lk))
        q4, k4, v4 = (t.view(B, -1, H, c).transpose(1, 2) for t in (q, k, v))
        sq, sk = pa._packed_strides(q, k, H)
        # The products q k^T and p v; q, out, k and v once in bf16.
        bound, bound_by = bound_ms(4 * B * Lq * Lk * HC, 2 * B * HC * (2 * Lq + 2 * Lk))
        packed.append({
            "shape": f"B{B} H*c {HC} heads {H} Lq {Lq} Lk {Lk}", "calls": calls,
            "route": pa.forward_route(q.dtype, Lq, c), "bound_ms": bound, "bound_by": bound_by,
            **time_turns({
                "plain_ms": lambda: pa.pooled_attention_packed_torch(q, k, v, H, scale),
                "ms": lambda: pa.pooled_attention_packed_cuda(q, k, v, H, scale),
                # The first version: the CUDA-core kernel, bf16's route before these two.
                "first_ms": lambda: pa._launch(q, k, v, H, c, sq + sk + sk + sq, scale, False,
                                               False, route="cuda_core"),
                "library_ms": lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)},
                iters=5)})
        out = pa.pooled_attention_packed_cuda(q, k, v, H, scale).float()
        ref = pa.pooled_attention_packed_torch(q.float(), k.float(), v.float(), H, scale)
        torch.testing.assert_close(out, ref, **ATTENTION_TOL["bfloat16"])
        packed[-1]["max_abs_err"] = (out - ref).abs().max().item()
        timed_err = max(timed_err, packed[-1]["max_abs_err"])
        del out, ref
        timed = [("packed", packed[-1])]
        if Lq > 1:
            # pool_first runs one per-head launch per block, cls row included.
            qh = torch.randn(B, H, Lq + 1, c, device="cuda", generator=gen).bfloat16()
            kh, vh = k4.contiguous(), v4.contiguous()
            sqh, skh = pa._per_head_strides(qh, kh)
            bound_h, by_h = bound_ms(4 * B * (Lq + 1) * Lk * HC,
                                     2 * B * HC * (2 * (Lq + 1) + 2 * Lk))
            per_head.append({
                "shape": f"B{B} heads {H} c {c} Lq {Lq + 1} Lk {Lk}", "calls": calls,
                "route": pa.forward_route(qh.dtype, Lq + 1, c), "bound_ms": bound_h,
                "bound_by": by_h, **time_turns({
                    "plain_ms": lambda: pa.pooled_attention_torch(qh, kh, vh, scale),
                    "ms": lambda: pa.pooled_attention_cuda(qh, kh, vh, scale),
                    "first_ms": lambda: pa._launch(qh, kh, vh, H, c, sqh + skh + skh + sqh, scale,
                                                   False, False, route="cuda_core"),
                    "library_ms": lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)},
                    iters=5)})
            timed.append(("per-head", per_head[-1]))
            del qh, kh, vh
        for label, r in timed:
            print(f"attention {label} {r['shape']} bf16: kernel ({r['route']}) {r['ms']!r} ms, "
                  f"first version (cuda_core) {r['first_ms']!r} ms, plain {r['plain_ms']!r} ms, "
                  f"SDPA {r['library_ms']!r} ms, bound {r['bound_ms']!r} ms ({r['bound_by']})")
        del q, k, v, q4, k4, v4
    return {"errs": errs, "timed_err": timed_err, "packed": packed, "per_head": per_head}


def needed_positions(D: int, k: int, s: int, out: int) -> int:
    """Input positions along one axis that some output of the pool reads."""
    return len({o * s + d - k // 2 for o in range(out) for d in range(k)} & set(range(D)))


def check_token_pool(tp) -> dict:
    """Phase 5, pools: the kernel in its three modes against the plain
    version at B2, each call on the tiled route, then timed at B32 bf16
    through the tiled route and the first version (the scalar route)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    geometries = sorted({(grid, kernel, stride) for grid, kernel, stride, _, _ in MVIT_POOLS})
    errs = {"float32": 0.0, "bfloat16": 0.0}
    before = read_counts()
    for grid, kernel, stride in geometries:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(2, *grid, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).to(dtype)
            for out, ref in (
                (tp.depthwise_token_pool(x, w, stride),
                 tp.depthwise_token_pool_torch(x.float(), w.float(), stride)),
                (tp.max_token_pool(x, kernel, stride),
                 tp.max_token_pool_torch(x.float(), kernel, stride)),
                (tp.avg_token_pool(x, kernel, stride),
                 tp.avg_token_pool_torch(x.float(), kernel, stride)),
            ):
                torch.cuda.synchronize()
                assert out.dtype == dtype and out.shape == ref.shape and out.is_contiguous()
                torch.testing.assert_close(out.float(), ref, **KERNEL_TOL[name])
                errs[name] = max(errs[name], (out.float() - ref).abs().max().item())
    expected = {f"token_pool_{m}{r}": 2 * len(geometries) * (r != ".scalar")
                for m in ("conv", "max", "avg") for r in ("", ".tiled", ".scalar")}
    moved = {name: read_counts()[name] - before[name] for name in expected}
    assert moved == expected, f"token pool checks: launches {moved}, expected {expected}"
    print(f"token pool vs plain ({len(geometries)} geometries x conv/max/avg, all tiled): max "
          f"|err| f32 {errs['float32']!r}, bf16 {errs['bfloat16']!r}")

    B = MVIT_TIMING_BATCH
    rows, timed_err = {"conv": [], "max": [], "avg": []}, 0.0
    for grid, kernel, stride, mode, calls in MVIT_POOLS:
        x = torch.randn(B, *grid, device="cuda", generator=gen).bfloat16()
        C = grid[-1]
        w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).bfloat16()
        x_ncthw, pad = x.permute(0, 4, 1, 2, 3), [k // 2 for k in kernel]
        w_full = w.repeat(C // HEAD_DIM, 1, 1, 1, 1)
        out_grid = [tp.pool_out_size(d, k, s) for d, k, s in zip(grid[:3], kernel, stride)]
        reads = math.prod(needed_positions(d, k, s, o)
                          for d, k, s, o in zip(grid[:3], kernel, stride, out_grid))
        outputs = B * math.prod(out_grid) * C
        taps = math.prod(kernel)
        # The avg mode is on no path of MViT-B: timed at the conv geometries.
        for m in ([mode] if mode == "max" else [mode, "avg"]):
            if m == "conv":
                kernel_call, plain, library = (
                    lambda r: tp.depthwise_token_pool_cuda(x, w, stride, route=r),
                    lambda: tp.depthwise_token_pool_torch(x, w, stride),
                    lambda: F.conv3d(x_ncthw, w_full, stride=stride, padding=pad, groups=C))
                ops, weight_bytes = 2 * taps * outputs, 2 * w.numel()
                ref = tp.depthwise_token_pool_torch(x.float(), w.float(), stride)
            elif m == "max":
                kernel_call, plain, library = (
                    lambda r: tp.max_token_pool_cuda(x, kernel, stride, route=r),
                    lambda: tp.max_token_pool_torch(x, kernel, stride),
                    lambda: F.max_pool3d(x_ncthw, kernel, stride, pad))
                ops, weight_bytes = taps * outputs, 0
                ref = tp.max_token_pool_torch(x.float(), kernel, stride)
            else:
                kernel_call, plain, library = (
                    lambda r: tp.avg_token_pool_cuda(x, kernel, stride, route=r),
                    lambda: tp.avg_token_pool_torch(x, kernel, stride),
                    lambda: F.avg_pool3d(x_ncthw, kernel, stride, pad, count_include_pad=True))
                ops, weight_bytes = (taps + 1) * outputs, 0
                ref = tp.avg_token_pool_torch(x.float(), kernel, stride)
            err = 0.0
            for route in tp.POOL_ROUTES:
                out = kernel_call(route)
                torch.testing.assert_close(out.float(), ref, **KERNEL_TOL["bfloat16"])
                err = max(err, (out.float() - ref).abs().max().item())
            timed_err = max(timed_err, err)
            del out, ref
            # The input positions some output reads and the output, once in bf16.
            bound, bound_by = bound_ms(ops, 2 * (B * reads * C + outputs) + weight_bytes)
            rows[m].append({"shape": f"B{B} {grid} k{kernel} s{stride}",
                            "calls": 0 if m == "avg" else calls,
                            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
                            **time_turns({"plain_ms": plain, "ms": lambda: kernel_call("tiled"),
                                          "first_ms": lambda: kernel_call("scalar"),
                                          "library_ms": library}, iters=10)})
            r = rows[m][-1]
            print(f"token pool {m} {r['shape']} bf16: kernel {r['ms']!r} ms, first version "
                  f"(scalar) {r['first_ms']!r} ms, plain {r['plain_ms']!r} ms, library "
                  f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms ({r['bound_by']})")
        del x, x_ncthw, w_full
    pool_rows = rows["conv"] + rows["max"]
    new = sum(r["calls"] * r["ms"] for r in pool_rows)
    old = sum(r["calls"] * r["first_ms"] for r in pool_rows)
    print(f"token pool per B{B} forward (35 conv + 3 max): tiled {new!r} ms against the first "
          f"version's {old!r} ms; gate {POOL_GATE_SHARE} x")
    assert new <= POOL_GATE_SHARE * old, (
        f"token pool: {new} ms per forward, over {POOL_GATE_SHARE} x the first version's {old} ms")
    return {"errs": errs, "timed_err": timed_err, "rows": rows}


def mvit_slice(hub, convert_to_deployable_form, label: str, batches, per_forward_counts: dict,
               gen, **kwargs) -> dict:
    """Phases 6 and 7: MViT-B 16x4 on the card, its logits against the plain
    f32 model, then its deploy form serving ``batches``."""
    import torch

    model = hub.mvit_base_16x4(**kwargs)
    assert all(p.is_cuda for p in model.parameters()), "the hub factory built off the card"
    randomize_mvit_(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    x = torch.randn(MVIT_CHECK_BATCH, 3, *MVIT_CLIP, generator=gen).cuda()
    with torch.no_grad():
        reset_counts()
        with plain_kernels():
            ref = model(x).float()
        assert not any(read_counts().values()), "the plain reference launched a kernel"
        got = {
            "float32": convert_to_deployable_form(model, dtype=None)(x).float(),
            "bfloat16": deploy(x.bfloat16()).float(),
        }
    check_logits(label, got, ref)
    del model, ref, got

    reset_counts()
    rates = serve(deploy, batches, gen, MVIT_CLIP, 400)
    counts = read_counts()
    forwards = sum(r["forwards"] for r in rates.values())
    check_path_counts(f"{label} path", counts, per_forward_counts, forwards)
    for B, r in rates.items():
        print(f"{label} deploy bf16 16x224x224 B{B}: {r['clips_per_s']!r} clips/s "
              f"({r['ms']!r} ms/forward); {n_params} parameters")
    del deploy
    torch.cuda.empty_cache()
    return {"rates": rates, "counts": counts, "forwards": forwards}


def check_attention_backward(pa) -> dict:
    """Phase 8, attention: the backward kernels in both layouts against the
    plain backward at B2, each call on its route; then timed at the training
    batch in bf16 beside the first version, and held to BWD_GATE_SHARE of
    its time."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    # (max |err|, max |err| over max |ref|) per dtype.
    errs = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    autograd_err, lse_err = (0.0, 0.0), 0.0
    shapes = [row[:4] for row in attention_rows()]
    for HC, H, Lq, Lk in shapes:
        c = HC // H
        scale = c**-0.5
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v, g = (torch.randn(2, L, HC, device="cuda", generator=gen).to(dtype)
                          for L in (Lq, Lk, Lk, Lq))
            heads = [pa._heads(t, H).contiguous() for t in (q, k, v, g)]
            ref_lse = pa.attention_lse_torch(heads[0].float(), heads[1].float(), scale)
            route = pa.backward_route(dtype, Lq, c)
            for residual in (False, True):
                o, lse = pa.pooled_attention_packed_cuda(q, k, v, H, scale, residual,
                                                         return_lse=True)
                o_h, lse_h = pa.pooled_attention_cuda(*heads[:3], scale, residual, return_lse=True)
                for got_lse in (lse, lse_h):
                    torch.testing.assert_close(got_lse, ref_lse, atol=1e-4, rtol=1e-5)
                    lse_err = max(lse_err, (got_lse - ref_lse).abs().max().item())
                reset_counts()
                got = pa.pooled_attention_packed_bwd_cuda(q, k, v, o, lse, g, H, scale, residual)
                ref = pa.pooled_attention_packed_bwd_torch(
                    *(t.float() for t in (q, k, v, o)), lse, g.float(), H, scale, residual)
                got_h = pa.pooled_attention_bwd_cuda(*heads[:3], o_h, lse_h, heads[3], scale,
                                                     residual)
                counts = read_counts()
                for wrapper in ("pooled_attention_packed_bwd", "pooled_attention_bwd"):
                    assert counts[wrapper] == by_route(counts, wrapper)[route] == 1, counts
                ref_h = pa.pooled_attention_bwd_torch(
                    *(t.float() for t in (*heads[:3], o_h)), lse_h, heads[3].float(), scale,
                    residual)
                for a, b, t in zip((*got, *got_h), (*ref, *ref_h), (q, k, v, *heads[:3])):
                    assert a.shape == t.shape and a.dtype == dtype
                    errs[name] = worse(errs[name], close_rel(a, b, **GRAD_TOL[name]))
                if dtype == torch.float32:
                    # The reference itself: the plain backward, given the
                    # plain forward's output and lse, against autograd
                    # through that forward.
                    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                    out = pa.pooled_attention_packed_torch(*qkv, H, scale, residual)
                    auto = torch.autograd.grad(out, qkv, g)
                    plain = pa.pooled_attention_packed_bwd_torch(q, k, v, out.detach(), ref_lse, g,
                                                                 H, scale, residual)
                    for a, b in zip(plain, auto):
                        autograd_err = worse(autograd_err, close_rel(a, b, **GRAD_TOL["float32"]))
                    del qkv, out, auto, plain
                del o, lse, o_h, lse_h, got, ref, got_h, ref_h
    print(f"attention backward vs plain ({len(shapes)} shapes, both layouts, residual on and "
          f"off; bf16 on the tensor-core and split-key routes, f32 on the CUDA cores): (max "
          f"|err|, over max |ref|) f32 {errs['float32']!r}, bf16 {errs['bfloat16']!r}; lse max "
          f"|err| {lse_err!r}; plain backward vs autograd (f32) {autograd_err!r}")

    B = TRAIN_BATCH
    packed, per_head, timed_err = [], [], (0.0, 0.0)
    for HC, H, Lq, Lk, calls in attention_rows():
        c = HC // H
        scale = c**-0.5
        timed = []
        for layout in ("packed", "per-head"):
            if layout == "packed":
                q, k, v, g = (torch.randn(B, L, HC, device="cuda", generator=gen).bfloat16()
                              for L in (Lq, Lk, Lk, Lq))
                Lq_run = Lq
                o, lse = pa.pooled_attention_packed_cuda(q, k, v, H, scale, return_lse=True)
                sq, sk = pa._packed_strides(q, k, H)

                def kernel():
                    return pa.pooled_attention_packed_bwd_cuda(q, k, v, o, lse, g, H, scale)

                def plain(f=lambda t: t):
                    return pa.pooled_attention_packed_bwd_torch(*(f(t) for t in (q, k, v, o)),
                                                                lse, f(g), H, scale)

                def views(t):
                    return pa._heads(t, H)
            elif Lq > 1:
                # pool_first runs one per-head launch per block, cls row included.
                q, g = (torch.randn(B, H, Lq + 1, c, device="cuda", generator=gen).bfloat16()
                        for _ in range(2))
                k, v = (torch.randn(B, H, Lk, c, device="cuda", generator=gen).bfloat16()
                        for _ in range(2))
                Lq_run = Lq + 1
                o, lse = pa.pooled_attention_cuda(q, k, v, scale, return_lse=True)
                sq, sk = pa._per_head_strides(q, k)

                def kernel():
                    return pa.pooled_attention_bwd_cuda(q, k, v, o, lse, g, scale)

                def plain(f=lambda t: t):
                    return pa.pooled_attention_bwd_torch(*(f(t) for t in (q, k, v, o)), lse, f(g),
                                                         scale)

                def views(t):
                    return t
            else:
                continue
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]

            def first():
                # The first version: the CUDA-core kernels on the same bf16
                # inputs, bf16's route before the tensor-core and split-key
                # routes.
                return pa._launch_bwd(q, k, v, o, lse, g, H, c, sq, sk, scale, False,
                                      route="cuda_core")

            def library():
                # The same (dq, dk, dv) from q, k, v and g: SDPA's forward
                # and backward.
                out = F.scaled_dot_product_attention(*(views(t) for t in leaves), scale=scale)
                return torch.autograd.grad(out, leaves, views(g))

            lib_out = F.scaled_dot_product_attention(*(views(t) for t in leaves), scale=scale)

            def library_bwd():
                # SDPA's backward alone, of one forward kept for it.
                return torch.autograd.grad(lib_out, leaves, views(g), retain_graph=True)

            # Five products of the forward's size; q, o, g, dq and k, v, dk,
            # dv once in bf16, and the f32 lse.
            bound, bound_by = bound_ms(10 * B * Lq_run * Lk * HC,
                                       2 * B * HC * (4 * Lq_run + 4 * Lk) + 4 * B * H * Lq_run)
            row = {"shape": f"B{B} H*c {HC} heads {H} Lq {Lq_run} Lk {Lk}", "calls": calls,
                   "route": pa.backward_route(q.dtype, Lq_run, c),
                   "bound_ms": bound, "bound_by": bound_by,
                   **time_turns({"plain_ms": plain, "ms": kernel, "first_ms": first,
                                 "library_ms": library, "library_bwd_ms": library_bwd}, iters=5)}
            err = worse(*(close_rel(a, b, **GRAD_TOL["bfloat16"])
                          for a, b in zip(kernel(), plain(lambda t: t.float()))))
            row["max_abs_err"], row["max_rel_err"] = err
            timed_err = worse(timed_err, err)
            (packed if layout == "packed" else per_head).append(row)
            timed.append((layout, row))
            del q, k, v, g, o, lse, leaves, lib_out
        for label, r in timed:
            print(f"attention backward {label} {r['shape']} bf16: kernel ({r['route']}) "
                  f"{r['ms']!r} ms, first version (cuda_core) {r['first_ms']!r} ms, plain "
                  f"{r['plain_ms']!r} ms, SDPA fwd+bwd {r['library_ms']!r} ms, SDPA bwd "
                  f"{r['library_bwd_ms']!r} ms, bound {r['bound_ms']!r} ms ({r['bound_by']})")
    for label, rows in (("#5 head-packed", packed), ("#3 per-head", per_head)):
        new = sum(r["calls"] * r["ms"] for r in rows)
        old = sum(r["calls"] * r["first_ms"] for r in rows)
        print(f"attention backward {label} per B{B} step: {new!r} ms ({route_sums(rows)}) "
              f"against the first version's {old!r} ms; gate {BWD_GATE_SHARE} x")
        assert new <= BWD_GATE_SHARE * old, (
            f"attention backward {label}: {new} ms per step, over {BWD_GATE_SHARE} x the first "
            f"version's {old} ms")
    torch.cuda.empty_cache()
    return {"errs": errs, "timed_err": timed_err, "lse_err": lse_err,
            "autograd_err": autograd_err, "packed": packed, "per_head": per_head}


def check_pool_backward(tp) -> dict:
    """Phase 8, pools: the conv pool's dx and dw kernels against their plain
    versions at B2, each call on the tiled route, then timed at the training
    batch in bf16 through the tiled route and the first version (the scalar
    route)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    conv_pools = [(grid, kernel, stride, calls)
                  for grid, kernel, stride, mode, calls in MVIT_POOLS if mode == "conv"]
    errs = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    autograd_err = (0.0, 0.0)
    before = read_counts()
    for grid, kernel, stride, _ in conv_pools:
        out_grid = tuple(tp.pool_out_size(d, k, s) for d, k, s in zip(grid[:3], kernel, stride))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(2, *grid, device="cuda", generator=gen).to(dtype)
            g = torch.randn(2, *out_grid, grid[-1], device="cuda", generator=gen).to(dtype)
            w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).to(dtype)
            dx = tp.depthwise_token_pool_dx_cuda(g, w, x.shape, stride)
            dw = tp.depthwise_token_pool_dw_cuda(x, g, w, stride)
            assert dx.shape == x.shape and dx.dtype == dtype
            assert dw.shape == w.shape and dw.dtype == dtype
            ref_dx = tp.depthwise_token_pool_dx_torch(g.float(), w.float(), x.shape, stride)
            ref_dw = tp.depthwise_token_pool_dw_torch(x.float(), g.float(), w.float(), stride)
            errs[name] = worse(errs[name], close_rel(dx, ref_dx, **GRAD_TOL[name]),
                               close_rel(dw, ref_dw, **GRAD_TOL[name]))
            if dtype == torch.float32:
                xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
                auto = torch.autograd.grad(tp.depthwise_token_pool_torch(xr, wr, stride),
                                           (xr, wr), g)
                autograd_err = worse(autograd_err, close_rel(ref_dx, auto[0], **GRAD_TOL[name]),
                                     close_rel(ref_dw, auto[1], **GRAD_TOL[name]))
    expected = {f"token_pool_{which}{r}": 2 * len(conv_pools) * (r != ".scalar")
                for which in ("dx", "dw") for r in ("", ".tiled", ".scalar")}
    moved = {name: read_counts()[name] - before[name] for name in expected}
    assert moved == expected, f"token pool backward checks: launches {moved}, expected {expected}"
    print(f"token pool backward vs plain ({len(conv_pools)} conv geometries, dx and dw, all "
          f"tiled, weight rows shared by C / {HEAD_DIM} heads): (max |err|, over max |ref|) f32 "
          f"{errs['float32']!r}, bf16 {errs['bfloat16']!r}; plain backward vs autograd (f32) "
          f"{autograd_err!r}")

    B = TRAIN_BATCH
    rows, timed_err = {"dx": [], "dw": []}, (0.0, 0.0)
    for grid, kernel, stride, calls in conv_pools:
        C = grid[-1]
        out_grid = [tp.pool_out_size(d, k, s) for d, k, s in zip(grid[:3], kernel, stride)]
        x = torch.randn(B, *grid, device="cuda", generator=gen).bfloat16()
        g = torch.randn(B, *out_grid, C, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).bfloat16()
        x_nc, g_nc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        w_full, pad = w.repeat(C // HEAD_DIM, 1, 1, 1, 1), [k // 2 for k in kernel]

        def library(mask):
            # The channels-last F.conv3d(groups=C)'s own backward, one call.
            return torch.ops.aten.convolution_backward(
                g_nc, x_nc, w_full, None, list(stride), pad, [1, 1, 1], False, [0, 0, 0], C, mask)

        reads = math.prod(needed_positions(d, k, s, o)
                          for d, k, s, o in zip(grid[:3], kernel, stride, out_grid))
        outputs = B * math.prod(out_grid) * C
        ops = 2 * math.prod(kernel) * outputs
        for which in ("dx", "dw"):
            if which == "dx":
                kernel_call, plain, lib_call = (
                    lambda r: tp.depthwise_token_pool_dx_cuda(g, w, x.shape, stride, route=r),
                    lambda: tp.depthwise_token_pool_dx_torch(g, w, x.shape, stride),
                    lambda: library([True, False, False]))
                # g and the weight in, dx out, once in bf16.
                nbytes = 2 * (outputs + x.numel() + w.numel())
                ref = tp.depthwise_token_pool_dx_torch(g.float(), w.float(), x.shape, stride)
            else:
                kernel_call, plain, lib_call = (
                    lambda r: tp.depthwise_token_pool_dw_cuda(x, g, w, stride, route=r),
                    lambda: tp.depthwise_token_pool_dw_torch(x, g, w, stride),
                    lambda: library([False, True, False]))
                # The input positions some output reads and g in, dw out.
                nbytes = 2 * (B * reads * C + outputs + w.numel())
                ref = tp.depthwise_token_pool_dw_torch(x.float(), g.float(), w.float(), stride)
            err = worse(*(close_rel(kernel_call(route), ref, **GRAD_TOL["bfloat16"])
                          for route in tp.POOL_ROUTES))
            timed_err = worse(timed_err, err)
            del ref
            bound, bound_by = bound_ms(ops, nbytes)
            rows[which].append({"shape": f"B{B} {grid} k{kernel} s{stride}", "calls": calls,
                                "bound_ms": bound, "bound_by": bound_by,
                                "max_abs_err": err[0], "max_rel_err": err[1],
                                **time_turns({"plain_ms": plain, "ms": lambda: kernel_call("tiled"),
                                              "first_ms": lambda: kernel_call("scalar"),
                                              "library_ms": lib_call}, iters=10)})
            r = rows[which][-1]
            print(f"token pool {which} {r['shape']} bf16: kernel {r['ms']!r} ms, first version "
                  f"(scalar) {r['first_ms']!r} ms, plain {r['plain_ms']!r} ms, "
                  f"convolution_backward {r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
                  f"({r['bound_by']})")
        del x, g, w, x_nc, g_nc, w_full
    for which in ("dx", "dw"):
        new = sum(r["calls"] * r["ms"] for r in rows[which])
        old = sum(r["calls"] * r["first_ms"] for r in rows[which])
        print(f"token pool {which} per B{B} step ({CONV_POOLS} conv pools): tiled {new!r} ms "
              f"against the first version's {old!r} ms; gate {POOL_GATE_SHARE} x")
        assert new <= POOL_GATE_SHARE * old, (
            f"token pool {which}: {new} ms per step, over {POOL_GATE_SHARE} x the first "
            f"version's {old} ms")
    torch.cuda.empty_cache()
    return {"errs": errs, "timed_err": timed_err, "autograd_err": autograd_err, "rows": rows}


def fused_inputs(gen, B: int, thw, HC: int, heads: int, Lq: int, dtype) -> dict:
    """The fused op's inputs as MViT's layer passes them: q, the unpooled k
    and v grids, per-head taps (27, c) and LayerNorm parameters (2, c) that
    every head shares, cls rows for k and v and a cls query."""
    import torch

    c = HC // heads

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale + shift).to(dtype)

    L = math.prod(thw)
    return dict(q=randn(B, Lq, HC), k_grid=randn(B, L, HC), v_grid=randn(B, L, HC),
                wk=randn(27, c, scale=0.2), wv=randn(27, c, scale=0.2),
                lnk=randn(2, c, scale=0.3, shift=1.0), lnv=randn(2, c, scale=0.3, shift=1.0),
                cls_k=randn(B, 1, HC), cls_v=randn(B, 1, HC), cls_q=randn(B, 1, HC))


def fused_call(fn, t: dict, thw, heads: int, stride, residual: bool, cls_k=None, cls_v=None):
    """``fn`` (the fused op or its plain version) on the inputs ``t``; the cls
    rows are ``t``'s unless normed ones are given."""
    HC = t["q"].shape[2]
    return fn(t["q"], t["k_grid"], t["v_grid"], t["wk"], t["wv"], t["lnk"], t["lnv"],
              t["cls_k"] if cls_k is None else cls_k, t["cls_v"] if cls_v is None else cls_v,
              thw, heads, (HC // heads) ** -0.5, residual, (3, 3, 3), stride, FUSED_EPS,
              cls_q=t["cls_q"])


def check_fused_kvpool(fk, pa, tp) -> dict:
    """Phase 11: the fused op against its plain version at B2 at every
    MViT-B 16x4 block geometry, then timed at B32 bf16 beside the unfused
    kernel path, a library composition and the plain version."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    bf16_end_to_end = 0.0
    before = read_counts()
    for thw, HC, heads, stride, Lq, _ in MVIT_FUSED:
        assert fk.fusable(thw, HC, (3, 3, 3), stride, HC // heads), f"{thw} {stride} not fusable"
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            t = fused_inputs(gen, 2, thw, HC, heads, Lq, dtype)
            f32 = {key: v.float() for key, v in t.items()}
            for residual in (False, True):
                outs = fused_call(fk.fused_kvpool_attention_cuda, t, thw, heads, stride, residual)
                torch.cuda.synchronize()
                ref = fused_call(fk.fused_kvpool_attention_torch, f32, thw, heads, stride, residual)
                assert [o.shape for o in outs] == [r.shape for r in ref]
                assert all(o.dtype == dtype for o in outs)
                # The pool-LN kernel: pooled, normed k and v.
                for got, want in zip(outs[1:3], ref[1:3]):
                    torch.testing.assert_close(got.float(), want, **KERNEL_TOL[name])
                    errs[name] = max(errs[name], (got.float() - want).abs().max().item())
                # The attention launches, over the kernel's own k and v.
                k_full, v_full = (torch.cat([t[f"cls_{x}"], o], dim=1).float()
                                  for x, o in (("k", outs[1]), ("v", outs[2])))
                for got, qq in ((outs[0], f32["q"]), (outs[3], f32["cls_q"])):
                    want = pa.pooled_attention_packed_torch(qq, k_full, v_full, heads,
                                                            (HC // heads) ** -0.5, residual)
                    torch.testing.assert_close(got.float(), want, **ATTENTION_TOL[name])
                    errs[name] = max(errs[name], (got.float() - want).abs().max().item())
                # The whole op: in f32 held to the attention's tolerance; in
                # bf16 its k and v are rounded before the attention reads
                # them, so the end-to-end error is reported.
                for got, want in zip(outs[::3], ref[::3]):
                    if dtype == torch.float32:
                        torch.testing.assert_close(got, want, **ATTENTION_TOL[name])
                    else:
                        bf16_end_to_end = max(bf16_end_to_end,
                                              (got.float() - want).abs().max().item())
                del outs, ref, k_full, v_full
    checks = 2 * 2 * len(MVIT_FUSED)  # f32 and bf16, residual on and off
    expected = {"fused_kvpool_attention": checks, "fused_kvpool_attention.tiled": checks,
                "fused_kvpool_attention.scalar": 0}
    moved = {name: read_counts()[name] - before[name] for name in expected}
    assert moved == expected, f"fused kv-pool checks: launches {moved}, expected {expected}"
    print(f"fused kv-pool vs plain ({len(MVIT_FUSED)} geometries, residual on and off, cls query "
          f"included, every pool-LN launch tiled): max |err| f32 {errs['float32']!r}, bf16 "
          f"{errs['bfloat16']!r} (pooled k, v and each attention); bf16 whole op vs plain f32 "
          f"{bf16_end_to_end!r}")

    B = MVIT_TIMING_BATCH
    rows, pool_ln_rows, timed_err = [], [], 0.0
    for thw, HC, heads, stride, Lq, calls in MVIT_FUSED:
        c = HC // heads
        scale = c**-0.5
        t = fused_inputs(gen, B, thw, HC, heads, Lq, torch.bfloat16)
        pooled = tuple(fk.pool_out(d, 3, st, 1) for d, st in zip(thw, stride))
        Lk = math.prod(pooled)

        def norm(x, ln):
            # The layer's per-head LayerNorm of a (B, L, H*c) tensor.
            return F.layer_norm(x.view(B, -1, heads, c), (c,), ln[0], ln[1],
                                FUSED_EPS).view(B, -1, HC)

        cls_k, cls_v = norm(t["cls_k"], t["lnk"]), norm(t["cls_v"], t["lnv"])
        w_k, w_v = (t[w].t().contiguous().view(c, 1, 3, 3, 3) for w in ("wk", "wv"))

        def kernel():
            # As the layer calls it: the cls rows normed, then the op.
            ck, cv = norm(t["cls_k"], t["lnk"]), norm(t["cls_v"], t["lnv"])
            return fused_call(fk.fused_kvpool_attention_cuda, t, thw, heads, stride, False, ck, cv)

        def pool_ln(route=None):
            return fk._pool_ln_cuda(t["k_grid"], t["v_grid"], t["wk"], t["wv"], t["lnk"],
                                    t["lnv"], cls_k, cls_v, thw, heads, (3, 3, 3), stride,
                                    FUSED_EPS, pooled, route)[:2]

        def pool_ln_plain():
            return fk.pool_ln_torch(t["k_grid"], t["v_grid"], t["wk"], t["wv"], t["lnk"],
                                    t["lnv"], cls_k, cls_v, thw, heads, (3, 3, 3), stride,
                                    FUSED_EPS)

        def plain():
            ck, cv = norm(t["cls_k"], t["lnk"]), norm(t["cls_v"], t["lnv"])
            return fused_call(fk.fused_kvpool_attention_torch, t, thw, heads, stride, False, ck, cv)

        def two_pools(pool, weights):
            # k and v: pooled by ``pool`` (grid, weight), normed, cls row in front.
            return [torch.cat([norm(t[f"cls_{x}"], t[f"ln{x}"]),
                               norm(pool(t[f"{x}_grid"].view(B, *thw, HC), w).reshape(B, -1, HC),
                                    t[f"ln{x}"])], dim=1)
                    for x, w in zip("kv", weights)]

        def unfused():
            # The layer's unfused path: two conv pools, four LayerNorms, two
            # concatenations, the grid and the cls attention.
            k_full, v_full = two_pools(lambda g, w: tp.depthwise_token_pool_cuda(g, w, stride),
                                       (w_k, w_v))
            return [pa.pooled_attention_packed_cuda(qq, k_full, v_full, heads, scale)
                    for qq in (t["q"], t["cls_q"])]

        w_full = [w.repeat(heads, 1, 1, 1, 1) for w in (w_k, w_v)]

        def pool_ln_library():
            # The pool-LN launch's function: F.conv3d(groups=C) on the
            # channels-last grids, F.layer_norm, the normed cls rows in front.
            return [torch.cat([cls, norm(F.conv3d(
                t[f"{x}_grid"].view(B, *thw, HC).permute(0, 4, 1, 2, 3), w, stride=stride,
                padding=1, groups=HC).permute(0, 2, 3, 4, 1).reshape(B, -1, HC), t[f"ln{x}"])],
                dim=1) for x, w, cls in zip("kv", w_full, (cls_k, cls_v))]

        def library():
            # F.conv3d(groups=C) on the channels-last grids, F.layer_norm,
            # torch.cat and SDPA on (B, H, L, c) views.
            k_full, v_full = two_pools(lambda g, w: F.conv3d(
                g.permute(0, 4, 1, 2, 3), w, stride=stride, padding=1,
                groups=HC).permute(0, 2, 3, 4, 1), w_full)
            k4, v4 = (x.view(B, -1, heads, c).transpose(1, 2) for x in (k_full, v_full))
            return [F.scaled_dot_product_attention(qq.view(B, -1, heads, c).transpose(1, 2), k4,
                                                   v4, scale=scale)
                    for qq in (t["q"], t["cls_q"])]

        reads = math.prod(needed_positions(d, 3, st, o) for d, st, o in zip(thw, stride, pooled))
        # q, out, the k and v positions some output reads, pooled k and v
        # out, the cls rows of k, v and q in and the cls output, the taps and
        # norms, once in bf16. The products of both attentions, 27 FMAs and
        # ~8 LayerNorm operations per pooled output.
        bound, bound_by = bound_ms(
            4 * B * (Lq + 1) * (Lk + 1) * HC + 2 * B * Lk * HC * (2 * 27 + 8),
            2 * (2 * B * Lq * HC + 2 * B * reads * HC + 2 * B * Lk * HC + 4 * B * HC + 58 * c))
        # The k and v buffers the pool-LN launch writes and the attention
        # reads back: their cost had each byte gone through HBM once each way.
        handover_ms = 2 * 2 * (2 * B * (Lk + 1) * HC) / PEAK_BYTES_PER_S * 1e3
        # The pool-LN launch alone: the k and v positions some output reads
        # and the (1 + Lk) rows of each buffer, once in bf16, beside the taps
        # and norms; 27 FMAs and ~8 LayerNorm operations per output at the
        # CUDA cores' f32 peak.
        ln_bound, ln_bound_by = bound_ms(
            2 * B * Lk * HC * (2 * 27 + 8),
            2 * (2 * B * reads * HC + 2 * B * (Lk + 1) * HC + 2 * 29 * c), PEAK_F32_FLOPS)
        shape = f"B{B} {thw} H*c {HC} heads {heads} s{stride} Lq {Lq} Lk {Lk + 1}"
        times = time_turns({"plain_ms": plain, "ms": kernel, "pool_ln_ms": pool_ln,
                            "pool_ln_first_ms": lambda: pool_ln("scalar"),
                            "pool_ln_plain_ms": pool_ln_plain,
                            "pool_ln_library_ms": pool_ln_library,
                            "unfused_ms": unfused, "library_ms": library}, iters=5)
        row = {"shape": shape, "calls": calls, "bound_ms": bound, "bound_by": bound_by,
               "handover_ms": handover_ms, **times}
        # Both routes' buffers at the timed shape against the plain version in f32.
        ref_ln = fk.pool_ln_torch(*(t[key].float() for key in ("k_grid", "v_grid", "wk", "wv",
                                                                 "lnk", "lnv")),
                                  cls_k.float(), cls_v.float(), thw, heads, (3, 3, 3), stride,
                                  FUSED_EPS)
        ln_err = 0.0
        for route in fk.POOL_LN_ROUTES:
            for got, want in zip(pool_ln(route), ref_ln):
                torch.testing.assert_close(got.float(), want, **KERNEL_TOL["bfloat16"])
                ln_err = max(ln_err, (got.float() - want).abs().max().item())
        del ref_ln
        pool_ln_rows.append({"shape": shape, "calls": calls, "route": "tiled",
                             "bound_ms": ln_bound, "bound_by": ln_bound_by, "max_abs_err": ln_err,
                             "ms": times["pool_ln_ms"], "first_ms": times["pool_ln_first_ms"],
                             "plain_ms": times["pool_ln_plain_ms"],
                             "library_ms": times["pool_ln_library_ms"]})
        print(f"fused kv-pool pool-LN {shape} bf16: tiled {times['pool_ln_ms']!r} ms, first "
              f"version (scalar) {times['pool_ln_first_ms']!r} ms, plain "
              f"{times['pool_ln_plain_ms']!r} ms, library {times['pool_ln_library_ms']!r} ms, "
              f"bound {ln_bound!r} ms ({ln_bound_by}); max |err| both routes {ln_err!r}")
        # The timed shape held against the plain version as above.
        outs = kernel()
        f32 = {key: v.float() for key, v in t.items()}
        ref = fused_call(fk.fused_kvpool_attention_torch, f32, thw, heads, stride, False,
                         cls_k.float(), cls_v.float())
        for got, want in zip(outs[1:3], ref[1:3]):
            torch.testing.assert_close(got.float(), want, **KERNEL_TOL["bfloat16"])
        row["max_abs_err"] = max((got.float() - want).abs().max().item()
                                 for got, want in zip(outs[1:3], ref[1:3]))
        timed_err = max(timed_err, row["max_abs_err"])
        rows.append(row)
        del outs, ref, f32, t, w_full
        print(f"fused kv-pool {row['shape']} bf16: op {row['ms']!r} ms (pool-LN launch "
              f"{row['pool_ln_ms']!r}), unfused kernel path {row['unfused_ms']!r} ms, plain "
              f"{row['plain_ms']!r} ms, library {row['library_ms']!r} ms, bound "
              f"{row['bound_ms']!r} ms ({row['bound_by']}); k/v handover at the HBM rate "
              f"{handover_ms!r} ms")
    torch.cuda.empty_cache()
    new = sum(r["calls"] * r["ms"] for r in pool_ln_rows)
    old = sum(r["calls"] * r["first_ms"] for r in pool_ln_rows)
    ln_bound = sum(r["calls"] * r["bound_ms"] for r in pool_ln_rows)
    print(f"fused kv-pool pool-LN per B{B} forward ({FUSED_BLOCKS} launches): tiled {new!r} ms "
          f"against the first version's {old!r} ms, bound {ln_bound!r} ms; gate "
          f"{POOL_LN_GATE_SHARE} x")
    assert new <= POOL_LN_GATE_SHARE * old, (
        f"pool-LN: {new} ms per forward, over {POOL_LN_GATE_SHARE} x the first version's {old} ms")
    return {"errs": errs, "bf16_end_to_end": bf16_end_to_end, "timed_err": timed_err,
            "rows": rows, "pool_ln_rows": pool_ln_rows}


def check_attention_nopad(pa) -> list:
    """Phase 12: the per-head kernel at `_pallas_nopad`'s shapes against its
    plain version, timed with SDPA (plus the residual) beside it."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for label, B, H, Lq, c, Lk in NOPAD_SHAPES:
        # uniform(-1, 1), as the benchmark draws them
        q, k, v = ((torch.rand(B, H, L, c, device="cuda", generator=gen) * 2 - 1).bfloat16()
                   for L in (Lq, Lk, Lk))
        scale = c**-0.5
        out = pa.pooled_attention_cuda(q, k, v, scale, True).float()
        ref = pa.pooled_attention_torch(q.float(), k.float(), v.float(), scale, True)
        torch.testing.assert_close(out, ref, **ATTENTION_TOL["bfloat16"])
        err = (out - ref).abs().max().item()
        del out, ref
        bound, bound_by = bound_ms(4 * B * H * Lq * Lk * c, 2 * B * H * c * (2 * Lq + 2 * Lk))
        sq, sk = pa._per_head_strides(q, k)
        row = {"shape": f"{label}: B{B} heads {H} Lq {Lq} c {c} Lk {Lk}", "calls": 1,
               "route": pa.forward_route(q.dtype, Lq, c), "bound_ms": bound,
               "bound_by": bound_by, "max_abs_err": err, **time_turns({
                   "plain_ms": lambda: pa.pooled_attention_torch(q, k, v, scale, True),
                   "ms": lambda: pa.pooled_attention_cuda(q, k, v, scale, True),
                   "first_ms": lambda: pa._launch(q, k, v, H, c, sq + sk + sk + sq, scale, True,
                                                  False, route="cuda_core"),
                   "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale) + q},
                   iters=5)}
        rows.append(row)
        print(f"attention nopad {row['shape']} bf16 residual: kernel ({row['route']}) "
              f"{row['ms']!r} ms, first version {row['first_ms']!r} ms, plain "
              f"{row['plain_ms']!r} ms, SDPA + q {row['library_ms']!r} ms, bound "
              f"{row['bound_ms']!r} ms ({row['bound_by']}); max |err| {err!r}")
        del q, k, v
    return rows


def mvit_fused_slice(hub, convert_to_deployable_form, batches, seed: int) -> dict:
    """Phase 13: ``mvit_base_16x4(fused_kvpool=True)`` deploy serving
    ``batches``, its logits against the plain f32 model and against the
    unfused deploy form of the same weights, which is served after it."""
    import torch

    label = "mvit_base_16x4 fused_kvpool"
    gen = torch.Generator().manual_seed(seed)
    model = hub.mvit_base_16x4(fused_kvpool=True)
    randomize_mvit_(model, gen)
    unfused = hub.mvit_base_16x4()
    unfused.load_state_dict(model.state_dict(), strict=True)  # one checkpoint, both forms
    unfused.eval()
    x = torch.randn(MVIT_CHECK_BATCH, 3, *MVIT_CLIP, generator=gen).cuda()
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    unfused_deploy = convert_to_deployable_form(unfused, dtype=torch.bfloat16)
    with torch.no_grad():
        with plain_kernels():
            ref = unfused(x).float()
        got = {}
        # Each form's pool-LN launches on the tiled route, in f32 and bf16.
        for name, form, xx, per_forward_counts in (
                ("float32", convert_to_deployable_form(model, dtype=None), x,
                 f32_routes(FUSED_PER_FORWARD)),
                ("bfloat16", deploy, x.bfloat16(), FUSED_PER_FORWARD)):
            reset_counts()
            got[name] = form(xx).float()
            check_path_counts(f"{label} deploy {name}", read_counts(), per_forward_counts, 1)
        unfused_bf16 = unfused_deploy(x.bfloat16()).float()
    check_logits(label, got, ref)
    diff = (got["bfloat16"] - unfused_bf16).abs().max().item()
    bound = LOGIT_REL_TOL["bfloat16"] * ref.abs().max().item()
    agree = int((got["bfloat16"].argmax(1) == unfused_bf16.argmax(1)).sum())
    print(f"{label} bf16 vs the unfused bf16 deploy form, B{MVIT_CHECK_BATCH}: max |diff| "
          f"{diff!r} (bound {bound!r}); top-1 equal on {agree}/{MVIT_CHECK_BATCH} rows")
    assert diff <= bound, f"{label}: fused and unfused bf16 logits differ by {diff} > {bound}"
    del model, unfused, ref, got, unfused_bf16

    reset_counts()
    rates = serve(deploy, batches, gen, MVIT_CLIP, 400)
    counts = read_counts()
    forwards = sum(r["forwards"] for r in rates.values())
    check_path_counts(f"{label} path", counts, FUSED_PER_FORWARD, forwards)
    unfused_rates = serve(unfused_deploy, batches, gen, MVIT_CLIP, 400)
    for B, r in rates.items():
        print(f"{label} deploy bf16 16x224x224 B{B}: {r['clips_per_s']!r} clips/s "
              f"({r['ms']!r} ms/forward); unfused served next: "
              f"{unfused_rates[B]['clips_per_s']!r} clips/s ({unfused_rates[B]['ms']!r} ms)")
    del deploy, unfused_deploy
    torch.cuda.empty_cache()
    return {"rates": rates, "unfused_rates": unfused_rates, "counts": counts,
            "forwards": forwards, "logit_diff_vs_unfused": diff}


class SyntheticClips:
    """A datamodule of seeded random clips made on the card:
    ``train_dataloader(n)`` yields n batches {"video": (B, 3, *clip) float32
    (MViT's 16x224x224 unless ``clip`` says otherwise), "label": (B,)} of 400
    classes, the same n on every call; with ``fixed`` every batch is the
    first one. With ``alpha`` each clip becomes SlowFast's ``[slow, fast]``
    through ``SlowFastPackPathway(alpha)`` and the batch is collated by
    ``default_collate``. ``val_dataloader(None)`` yields ``val_batches``
    batches of B clips, two clips a video, with "video_index" and
    "clip_index"."""

    def __init__(self, batch: int, seed: int, fixed: bool = False, clip=MVIT_CLIP,
                 alpha=None, val_batches: int = 0):
        self.batch, self.seed, self.fixed, self.clip = batch, seed, fixed, clip
        self.alpha, self.val_batches = alpha, val_batches

    def _batch(self, gen, per_label: int = 1, **extra):
        import torch

        video = torch.randn(self.batch, 3, *self.clip, device="cuda", generator=gen)
        label = torch.randint(0, 400, (self.batch // per_label,), device="cuda", generator=gen)
        label = label.repeat_interleave(per_label)
        if self.alpha is None:
            return {"video": video, "label": label, **extra}
        from pytorchvideo_tpu_torch.train import SlowFastPackPathway, default_collate

        pack = SlowFastPackPathway(self.alpha)
        batch = default_collate([{"video": pack(v), "label": y} for v, y in zip(video, label)])
        return {**batch, **extra}

    def train_dataloader(self, n: int):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(self.seed)
        for _ in range(n):
            if self.fixed:
                gen.manual_seed(self.seed)
            yield self._batch(gen)

    def val_dataloader(self, _):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(self.seed + 1)
        for i in range(self.val_batches):
            first = i * self.batch // 2
            videos = first + torch.arange(self.batch, device="cuda") // 2
            yield self._batch(gen, per_label=2, video_index=videos,
                              clip_index=torch.arange(self.batch, device="cuda") % 2)


def train_app(train, batch: int, seed: int, model=None, **overrides):
    """The ``classification_mvit_16x4`` recipe in bf16 compute through
    ``VideoClassificationTrainApp``; a model it builds itself
    (``hub.mvit_base_16x4`` at full width and depth, on the card) gets seeded
    random weights. Each ``train()`` runs ``steps_per_epoch`` steps and
    reads the loss back at the preset's log interval, its first step
    included."""
    import torch

    cfg = train.get_preset("classification_mvit_16x4", **{
        "trainer.compute_dtype": "bfloat16", "trainer.max_epochs": 1, **overrides})
    app = train.VideoClassificationTrainApp(cfg, model=model,
                                            datamodule=SyntheticClips(batch, seed),
                                            steps_per_epoch=1, seed=seed)
    if model is None:
        assert all(p.is_cuda for p in app.model.parameters()), "the app built off the card"
        randomize_mvit_(app.model, torch.Generator().manual_seed(seed))
    app.setup()
    return app


def run_steps(app, steps: int):
    """``steps`` training steps through ``app.train()``; returns the losses
    it logged and the wall-clock ms per step (the card synchronised at both
    ends)."""
    import torch

    app.steps_per_epoch = steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = app.train()
    torch.cuda.synchronize()
    return history, (time.perf_counter() - t0) * 1000.0 / steps


def _module_of(name: str) -> str:
    """The module a parameter belongs to: "blocks.3.attn.norm_k.bias" ->
    "blocks.3", "head.proj.weight" -> "head"."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else parts[0]


def check_step_grads(train, forms, batch, label: str) -> dict:
    """One step's gradients (``forward_backward``, the step's own) of the
    first of ``forms`` against the second's, in f32 and in bf16 compute, per
    tensor (STEP_GRAD_TOL). A form is (name, model, context, per-step
    launches, or None for a form that must launch no kernel)."""
    import torch

    report = {}
    (got_name, *_), (ref_name, *_) = forms
    for compute in ("float32", "bfloat16"):
        dtype = None if compute == "float32" else torch.bfloat16
        grads, losses = {}, {}
        for form, model, context, per_step in forms:
            model.zero_grad(set_to_none=True)
            torch.cuda.manual_seed(11)  # the same dropout masks in both forms
            reset_counts()
            with context():
                loss, _ = train.forward_backward(model.train(), batch["video"], batch["label"],
                                                 compute_dtype=dtype)
            counts = read_counts()
            if per_step is None:
                assert not any(counts.values()), f"the {form} step launched kernels: {counts}"
            else:
                expected = per_step if dtype is not None else f32_routes(per_step)
                check_path_counts(f"{label} grad check, {form} ({compute})", counts, expected, 1,
                                  "steps")
            grads[form] = {n: p.grad.clone() for n, p in model.named_parameters()}
            losses[form] = loss.item()
            model.zero_grad(set_to_none=True)
        rel, floor = STEP_GRAD_TOL[compute]
        scales = {n: ref.abs().max().item() for n, ref in grads[ref_name].items()}
        module_max = {}
        for n, scale in scales.items():
            module_max[_module_of(n)] = max(module_max.get(_module_of(n), 0.0), scale)
        rows = []
        for n, ref in grads[ref_name].items():
            got = grads[got_name][n]
            assert torch.isfinite(got).all(), f"{n}: non-finite gradient"
            err, scale, mod = (got - ref).abs().max().item(), scales[n], module_max[_module_of(n)]
            rows.append((err / (rel * scale + floor * mod), n, err, scale, mod))
        rows.sort(reverse=True)
        for share, n, err, scale, mod in rows[:8]:
            print(f"  {compute} step grad {n}: |err| {err!r}, max |g| {scale!r}, module max "
                  f"|g| {mod!r}, {share!r} of its bound")
        share, n, err, scale, mod = rows[0]
        assert share <= 1.0, (f"{label} {compute} step: {n} gradient off by {err} (max |g| "
                              f"{scale}, module {mod})")
        print(f"{label}: one step's grads at B{len(batch['video'])}, {compute} compute, "
              f"{got_name} vs {ref_name}: loss {losses[got_name]!r} vs {losses[ref_name]!r}; "
              f"worst tensor {n} at {share!r} of its bound ({rel} x its max |g| + {floor} x its "
              f"module's)")
        report[compute] = {"losses": losses, "worst_share_of_bound": share, "worst_tensor": n}
        del grads
    return report


def launching_updates(app) -> int:
    """The updates of ``app``'s captured steps so far that launch kernels:
    each batch signature's first ``WARMUP_STEPS`` + 1 (its eager warm-up
    updates, then the capture); a replay launches none."""
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    return sum(min(step.calls, WARMUP_STEPS + 1) for step in app._captured_steps.values())


def captured_run(app, steps: int, per_step: dict, label: str):
    """``steps`` steps through ``app.train()`` with the kernels' launches of
    the run, checked: ``per_step`` at each update that launches
    (``launching_updates``), none at a replay. Returns (losses, ms per step,
    counts, the run's peak device memory)."""
    import torch

    before = launching_updates(app)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    history, ms = run_steps(app, steps)
    counts = read_counts()
    updates = launching_updates(app) - before
    check_path_counts(f"{label} B{app.datamodule.batch}, {steps} steps through app.train()",
                      counts, per_step, updates, "warm-up or capture updates (replays: none)")
    return history, ms, counts, torch.cuda.max_memory_allocated()


def counted_update(app, batch, per_step: dict, label: str):
    """One update of ``app`` on a device batch through its captured step
    (``app._step``), with the launches read over it and checked as
    ``captured_run`` checks them. Returns (metrics, counts)."""
    before = launching_updates(app)
    reset_counts()
    app.state, metrics = app._step(batch)
    counts = read_counts()
    check_path_counts(label, counts, per_step, launching_updates(app) - before,
                      "warm-up or capture updates (replays: none)")
    return metrics, counts


def capture_reading(calls: list) -> dict:
    """The launches read over each update of a new captured step
    (``calls``, in order): one warm-up update's, the capture's, and each
    replay's."""
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    assert len(calls) > WARMUP_STEPS + 1, f"{len(calls)} updates: no replay read"
    return {"warm_up": calls[0], "capture": calls[WARMUP_STEPS],
            "replays": calls[WARMUP_STEPS + 1:]}


def first_step_grads(app, label: str, per_step: dict) -> dict:
    """The first step, the captured step's first warm-up update at its
    batch: every parameter receives its gradient through autograd (the
    step's zero fill for parameters the loss misses does not count); it
    launches ``per_step`` (``captured_run``). Returns the counts and the
    run's peak device memory."""
    import torch

    named = dict(app.model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    reached = set()
    hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n: reached.add(n))
             for n, p in named.items()]
    history, first_ms, counts, peak = captured_run(app, 1, per_step, label)
    for hook in hooks:
        hook.remove()
    missing = sorted(set(named) - reached)
    assert not missing, f"{label}: no gradient reached {missing}"
    bad = [n for n, p in named.items() if not torch.isfinite(p.grad).all()]
    assert not bad and all(math.isfinite(h) for h in history), f"non-finite gradients: {bad}"
    print(f"{label} train step 1 (B{app.datamodule.batch}): loss {history[0]!r}, all "
          f"{len(named)} parameter tensors ({n_params} values) got finite gradients through "
          f"autograd; {first_ms!r} ms (an eager warm-up update)")
    return counts, peak


def add_counts(a: dict, b: dict) -> dict:
    return {name: a.get(name, 0) + n for name, n in b.items()}


def timed_steps(app, per_step: dict, label: str, counts: dict, first_peak: int):
    """The main path: at B8 (whose first step's peak memory is
    ``first_peak``) and at the preset's B2, ``WARMUP_STEPS`` + 1 steps (the
    warm-up updates and the capture of a new batch signature; at B8 the
    first step was one), then timed replays; the launches of
    every run checked by ``captured_run`` and added to ``counts``; the peak
    memory of a batch is its capture's or its replays', the larger. Returns
    (rates by batch, summed counts)."""
    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    named = dict(app.model.named_parameters())
    rates = {}
    for B in (TRAIN_BATCH, PRESET_BATCH):
        app.datamodule = SyntheticClips(B, seed=22 + B)
        *_, warm_counts, warm_peak = captured_run(app, WARMUP_STEPS + 1, per_step,
                                                  f"{label} warm-up")
        history, ms, run_counts, run_peak = captured_run(app, TRAIN_TIMED_STEPS, per_step,
                                                         f"{label} timed")
        bad = [n for n, p in named.items() if not torch.isfinite(p).all()]
        assert not bad, f"{label} B{B}: non-finite parameters after the timed steps: {bad}"
        counts = add_counts(add_counts(counts, warm_counts), run_counts)
        peak = max(warm_peak, run_peak, first_peak if B == TRAIN_BATCH else 0)
        assert all(math.isfinite(h) for h in history), f"{label} B{B}: non-finite loss {history}"
        rates[B] = {"ms_per_step": ms, "clips_per_s": B * 1000.0 / ms, "peak_bytes": peak,
                    "losses": history}
        print(f"{label} train bf16 16x224x224 B{B}: {rates[B]['clips_per_s']!r} clips/s "
              f"({ms!r} ms/step over {TRAIN_TIMED_STEPS} captured steps, MixUp/CutMix, AdamW, "
              f"clip 1.0); peak device memory {peak!r} bytes; losses {history}")
    return rates, counts


def preset_batch(seed: int) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"video": torch.randn(PRESET_BATCH, 3, *MVIT_CLIP, device="cuda", generator=gen),
            "label": torch.randint(0, 400, (PRESET_BATCH,), device="cuda", generator=gen)}


def train_slice(train) -> dict:
    """Phases 9 and 10: MViT-B 16x4 training through the app, then one
    ``pool_first`` step."""
    import torch

    app = train_app(train, TRAIN_BATCH, seed=21)
    model = app.model
    # The seeded weights, before any step: the gradient check runs on them,
    # so that it sees the same weights (as well as the same batch and
    # dropout masks) in every run; the timed steps' updates do not repeat
    # from run to run (the max-pool backward adds with atomics). The seeded
    # weights hold near-ties in the skip pools too, so the f32 check routes
    # both forms' max-pool gradients alike (SharedMaxRouting).
    # Kept on the host, so that the peak device memory of the steps below
    # is the program's alone.
    seeded = {name: t.detach().to("cpu", copy=True) for name, t in model.state_dict().items()}
    counts, peak = first_step_grads(app, "mvit_base_16x4", MVIT_PER_STEP)
    rates, counts = timed_steps(app, MVIT_PER_STEP, "mvit_base_16x4", counts, peak)
    app._drop_graphs()
    model.load_state_dict(seeded)
    del seeded
    batch = preset_batch(23)
    routing = SharedMaxRouting()
    grad_report = check_step_grads(
        train, [("kernels", model, routing.record, MVIT_PER_STEP),
                ("plain", model, functools.partial(routing.replay, plain_kernels), None)],
        batch, "mvit_base_16x4")
    grad_report["max_pool_flips"] = routing.flips
    print(f"mvit_base_16x4 grad check: {routing.flips} skip max-pool windows whose argmax the "
          f"plain f32 form placed elsewhere than the kernel form (bound {MAX_POOL_FLIPS}); "
          f"both routed by PyTorch's argmax of the kernel form's input")
    assert routing.flips <= MAX_POOL_FLIPS, f"{routing.flips} max-pool windows flipped"

    # The loss falls on one fixed batch: hard labels, no warmup, an LR of
    # 1e-4 (cosine over the preset's 200 epochs, flat over these steps).
    fit = train_app(train, TRAIN_BATCH, seed=24, model=model, **{
        "trainer.log_every_n_steps": 1, "mix.enabled": False, "optim.lr": 1e-4, "lr_scheduler.lr": 1e-4,
        "lr_scheduler.warmup_iters": 0, "lr_scheduler.cosine_end_lr": 0.0})
    fit.datamodule = SyntheticClips(TRAIN_BATCH, seed=24, fixed=True)
    losses, _ = run_steps(fit, LOSS_STEPS)
    print(f"loss over {LOSS_STEPS} steps on one fixed B{TRAIN_BATCH} batch: {losses}")
    assert all(math.isfinite(h) for h in losses), losses
    assert losses[-1] < losses[0] and sum(losses[-3:]) < sum(losses[:3]), f"no fall: {losses}"
    del app, fit, model, batch
    torch.cuda.empty_cache()

    # pool_first, through the per-head attention and its backward: single
    # steps through app.train(), the launches read over each, up to one
    # replay after the capture.
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    pf = train_app(train, PRESET_BATCH, seed=25, **{"model.kwargs": {"pool_first": True}})
    pf_losses, pf_calls = [], []
    for _ in range(WARMUP_STEPS + 2):
        losses_1, pf_ms, counts_1, _ = captured_run(pf, 1, POOL_FIRST_PER_STEP,
                                                    "mvit_base_16x4 pool_first train")
        pf_losses += losses_1
        pf_calls.append(counts_1)
    pf_reading = capture_reading(pf_calls)
    bad = [n for n, p in pf.model.named_parameters() if not torch.isfinite(p.grad).all()]
    assert not bad and all(map(math.isfinite, pf_losses)), (
        f"pool_first: non-finite {bad} {pf_losses}")
    print(f"mvit_base_16x4 pool_first train bf16 B{PRESET_BATCH}: losses {pf_losses}, "
          f"{pf_ms!r} ms for the last step (a replay)")
    del pf
    torch.cuda.empty_cache()
    return {"rates": rates, "counts": counts, "pool_first_counts": functools.reduce(add_counts, pf_calls),
            "pool_first_reading": pf_reading,
            "grads": grad_report, "fit_losses": losses}


def train_fused_slice(train, unfused_rates: dict) -> dict:
    """Phase 14: the recipe with ``fused_kvpool=True``: gradients through
    autograd, timed steps beside the unfused ones of phase 9, and one step's
    gradients against the unfused kernel step of the same weights: the
    seeded ones, with both forms' max-pool gradients routed alike, as in
    phase 9."""
    import copy

    import torch

    label = "mvit_base_16x4 fused_kvpool"
    app = train_app(train, TRAIN_BATCH, seed=31, **{"model.kwargs": {"fused_kvpool": True}})
    model = app.model
    assert all(block.attn.fused_kvpool for block in model.blocks)
    # The timed steps' updates do not repeat from run to run, and the two
    # forms' rounding breaks the skip pools' near-ties apart: the check runs
    # on the seeded weights (kept on the host) under SharedMaxRouting.
    seeded = {name: t.detach().to("cpu", copy=True) for name, t in model.state_dict().items()}
    counts, peak = first_step_grads(app, label, FUSED_PER_STEP)
    rates, counts = timed_steps(app, FUSED_PER_STEP, label, counts, peak)
    app._drop_graphs()
    model.load_state_dict(seeded)
    del seeded
    for B, r in rates.items():
        u = unfused_rates[B]
        print(f"{label} train B{B}: {r['ms_per_step']!r} ms/step, peak {r['peak_bytes']!r} bytes; "
              f"unfused (phase 9) {u['ms_per_step']!r} ms/step, peak {u['peak_bytes']!r} bytes")
    unfused = copy.deepcopy(model)
    for block in unfused.blocks:
        block.attn.fused_kvpool = False
    routing = SharedMaxRouting()
    grad_report = check_step_grads(
        train, [("fused", model, routing.record, FUSED_PER_STEP),
                ("unfused", unfused, functools.partial(routing.replay, contextlib.nullcontext),
                 MVIT_PER_STEP)],
        preset_batch(32), label)
    grad_report["max_pool_flips"] = routing.flips
    print(f"{label} grad check: {routing.flips} skip max-pool windows whose argmax the unfused "
          f"f32 form placed elsewhere than the fused form (bound {MAX_POOL_FLIPS}); both routed "
          f"by PyTorch's argmax of the fused form's input")
    assert routing.flips <= MAX_POOL_FLIPS, f"{label}: {routing.flips} max-pool windows flipped"
    del app, model, unfused
    torch.cuda.empty_cache()
    return {"rates": rates, "counts": counts, "grads": grad_report}


def check_bn_layer(BatchNorm, label: str, shape, gen) -> dict:
    """Phase 18: the train-mode BatchNorm on a bf16 input with bf16 weight
    and bias (a bf16 step's cast copies) beside f32 running buffers, against
    an f64 reference of the same batch."""
    import torch

    C = shape[1]
    x = (torch.randn(shape, generator=gen) * 2.0 + 0.5).to("cuda", torch.bfloat16)
    bn = BatchNorm(C).cuda()
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=gen))
        bn.bias.copy_(torch.randn(C, generator=gen) * 0.1)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.1)
        bn.running_var.copy_(0.5 + torch.rand(C, generator=gen))
    mean0, var0 = bn.running_mean.double(), bn.running_var.double()
    weight, bias = bn.weight.bfloat16(), bn.bias.bfloat16()
    out = torch.func.functional_call(bn.train(), {"weight": weight, "bias": bias}, (x,))
    assert out.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    xd, dims, view = x.double(), (0, 2, 3, 4), (1, C, 1, 1, 1)
    mean, var = xd.mean(dims), xd.var(dims, unbiased=False)
    ref = ((xd - mean.view(view)) / torch.sqrt(var.view(view) + bn.eps) * weight.double().view(view)
           + bias.double().view(view))
    tol = KERNEL_TOL["bfloat16"]
    share = ((out.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()
    ref_mean, ref_var = 0.9 * mean0 + 0.1 * mean, 0.9 * var0 + 0.1 * var
    mean_share = ((bn.running_mean.double() - ref_mean).abs()
                  / (BN_STAT_REL * (ref_mean.abs() + var.sqrt()))).max().item()
    var_share = ((bn.running_var.double() - ref_var).abs()
                 / (BN_STAT_REL * ref_var)).max().item()
    print(f"BN train bf16 {label} {tuple(shape)} vs f64: output at {share!r} of its bound "
          f"(atol {tol['atol']}, rtol {tol['rtol']}), running mean at {mean_share!r}, biased "
          f"running var at {var_share!r} of theirs ({BN_STAT_REL} relative)")
    assert max(share, mean_share, var_share) <= 1.0, f"BN train {label} off its bound"
    return {"output": share, "running_mean": mean_share, "running_var": var_share}


@contextlib.contextmanager
def no_dropout(model):
    """The model's dropouts at rate 0 inside the block."""
    from pytorchvideo_tpu_torch.layers.stochastic import Dropout

    drops = [(m, m.rate) for m in model.modules() if isinstance(m, Dropout)]
    for m, _ in drops:
        m.rate = 0.0
    try:
        yield
    finally:
        for m, rate in drops:
            m.rate = rate


def grad_error(got: dict, ref: dict) -> dict:
    """How far gradients ``got`` lie from ``ref`` ({name: tensor}): the
    relative L2 error and the cosine of all of them together, each stage's
    relative L2 error, and the worst tensor's share of phase 9's per-tensor
    bf16 bound (STEP_GRAD_TOL)."""
    stages, dot, got_sq, module_max = {}, 0.0, 0.0, {}
    for n, r in ref.items():
        r, g = r.double(), got[n].double()
        err_sq, ref_sq = stages.get(_module_of(n), (0.0, 0.0))
        stages[_module_of(n)] = (err_sq + (g - r).square().sum().item(),
                                 ref_sq + r.square().sum().item())
        dot += (g * r).sum().item()
        got_sq += g.square().sum().item()
        module_max[_module_of(n)] = max(module_max.get(_module_of(n), 0.0), r.abs().max().item())
    err_total = sum(e for e, _ in stages.values())
    ref_total = sum(r for _, r in stages.values())
    rel, floor = STEP_GRAD_TOL["bfloat16"]
    share, worst = max(((got[n].double() - r.double()).abs().max().item()
                        / (rel * r.abs().max().item() + floor * module_max[_module_of(n)]), n)
                       for n, r in ref.items())
    return {"relative_l2": math.sqrt(err_total / ref_total),
            "cosine": dot / math.sqrt(ref_total * got_sq),
            "stage_relative_l2": {k: math.sqrt(e / r) for k, (e, r) in stages.items() if r > 0},
            "phase9_worst_share": share, "phase9_worst_tensor": worst}


def check_bf16_step_grads(train, model, batch, label: str) -> dict:
    """One step's gradients in bf16 compute against the same step in f32
    compute (TF32 off, dropout 0): the loss, and ``grad_error``'s relative
    L2 error, cosine and stage errors under BF16_STEP_*; phase 9's
    per-tensor share is printed."""
    import torch

    grads, losses = {}, {}
    with no_dropout(model):
        for compute, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            model.zero_grad(set_to_none=True)
            loss, _ = train.forward_backward(model.train(), batch["video"], batch["label"],
                                             compute_dtype=dtype)
            grads[compute] = {n: p.grad.clone() for n, p in model.named_parameters()}
            losses[compute] = loss.item()
    model.zero_grad(set_to_none=True)
    bad = [n for n, g in grads["bfloat16"].items() if not torch.isfinite(g).all()]
    assert not bad, f"{label}: non-finite bf16 gradients {bad}"
    err = grad_error(grads["bfloat16"], grads["float32"])
    loss_rel = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    print(f"{label}: one step's grads at B{len(batch['label'])}, bf16 vs f32 compute: loss "
          f"{losses['bfloat16']!r} vs {losses['float32']!r}; all gradients: relative L2 error "
          f"{err['relative_l2']!r} (bound {BF16_STEP_GLOBAL_REL}), cosine {err['cosine']!r} "
          f"(bound {BF16_STEP_MIN_COS}); by stage {err['stage_relative_l2']}; worst tensor "
          f"{err['phase9_worst_tensor']} at {err['phase9_worst_share']!r} of phase 9's "
          f"per-tensor bound")
    assert loss_rel <= LOGIT_REL_TOL["bfloat16"], f"{label}: bf16 loss off by {loss_rel}"
    assert err["relative_l2"] <= BF16_STEP_GLOBAL_REL and err["cosine"] >= BF16_STEP_MIN_COS, (
        f"{label}: bf16 gradients off: {err}")
    assert max(err["stage_relative_l2"].values()) < BF16_STEP_STAGE_REL, (
        f"{label}: a stage's bf16 gradients off: {err['stage_relative_l2']}")
    return {"losses": losses, **err}


def bn_app(train, preset: str, datamodule, model=None, seed: int = 0, **overrides):
    """``VideoClassificationTrainApp`` on a BN preset, one epoch, precise BN
    off unless overridden; a model it builds itself (on the card) gets the
    ResNet-style init of models/weight_init.py from a seeded generator."""
    import torch

    from pytorchvideo_tpu_torch.models import init_net_weights

    cfg = train.get_preset(preset, **{"trainer.max_epochs": 1, "trainer.precise_bn_batches": 0,
                                      **overrides})
    app = train.VideoClassificationTrainApp(cfg, model=model, datamodule=datamodule,
                                            steps_per_epoch=1, seed=seed)
    if model is None:
        assert all(p.is_cuda for p in app.model.parameters()), f"{preset} built off the card"
        init_net_weights(app.model, generator=torch.Generator(device="cuda").manual_seed(seed))
    app.setup()
    return app


def x3d_s_bench_overrides() -> dict:
    """bench.py:317's X3D-S recipe on the X3D-XS preset: hub x3d_s at
    13x160x160, SGD momentum 0.9 (no nesterov) at LR 0.1 (flat over a few
    steps: no warmup), MixUp alpha 1.0 (no CutMix) with label smoothing 0.1,
    soft-target CE, bf16 compute."""
    return {"model.name": "x3d_s", "model.clip_length": 13, "optim.lr": 0.1,
            "optim.nesterov": False, "optim.weight_decay": 1e-4, "lr_scheduler.lr": 0.1,
            "lr_scheduler.warmup_iters": 0, "mix.enabled": True, "mix.mixup_alpha": 1.0,
            "mix.cutmix_prob": 0.0, "mix.label_smoothing": 0.1,
            "trainer.compute_dtype": "bfloat16"}


def timed_bn_steps(app, label: str, card: str, first_peak: int = 0) -> dict:
    """The main path at the app's batch: ``WARMUP_STEPS`` + 1 steps (a new
    batch signature's warm-up updates and its capture), then timed replays
    through ``app.train()`` (the card synchronised at both ends); the peak
    memory of those runs (and ``first_peak``, an earlier step's at this
    batch), the largest; and the busy share of two more steps on one batch."""
    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    B = app.datamodule.batch
    *_, warm_peak = captured_run(app, WARMUP_STEPS + 1, {}, f"{label} warm-up")
    history, ms, _, run_peak = captured_run(app, BN_TIMED_STEPS, {}, f"{label} timed")
    peak = max(first_peak, warm_peak, run_peak)
    assert all(math.isfinite(h) for h in history), f"{label} B{B}: non-finite loss {history}"
    bad = [n for n, p in app.model.named_parameters() if not torch.isfinite(p).all()]
    assert not bad, f"{label} B{B}: non-finite parameters after the timed steps: {bad}"
    batch = app._device_batch(next(app.datamodule.train_dataloader(1)))
    busy_ms, busy = device_busy(lambda: app._step(batch))
    print(f"{label} train bf16 B{B}: {B * 1000.0 / ms!r} clips/s ({ms!r} ms/step over "
          f"{BN_TIMED_STEPS} captured steps); peak device memory {peak!r} bytes; busy share {busy!r} "
          f"({busy_ms!r} device ms/step); losses {history}; on {card}")
    return {"ms_per_step": ms, "clips_per_s": B * 1000.0 / ms, "peak_bytes": peak,
            "busy_share": busy, "busy_ms_per_step": busy_ms, "losses": history}


def bn_train_slice(train, card: str) -> dict:
    """Phase 18: the BatchNorm models' training (X3D-S, SlowFast-R50, the
    X3D-XS preset with precise BN and test(), Slow-R50), with the BN layer
    and bf16 gradient checks."""
    import copy

    import torch

    from pytorchvideo_tpu_torch.layers.norms import BatchNorm

    report = {"bn_layer": {}}
    gen = torch.Generator().manual_seed(40)
    for name, shape in BN_LAYER_SHAPES.items():
        report["bn_layer"][name] = check_bn_layer(BatchNorm, name, shape, gen)

    # X3D-S: every parameter's first gradient, then the timed batches.
    overrides = x3d_s_bench_overrides()
    app = bn_app(train, "classification_x3d_xs",
                 SyntheticClips(BN_X3D_BATCHES[0], seed=41, clip=X3D_S_CLIP), seed=41, **overrides)
    model = app.model
    _, first_peak = first_step_grads(app, "x3d_s", {})
    report["x3d_s"] = {}
    for B in BN_X3D_BATCHES:
        app.datamodule = SyntheticClips(B, seed=42 + B, clip=X3D_S_CLIP)
        report["x3d_s"][B] = timed_bn_steps(app, "x3d_s", card,
                                            first_peak if B == BN_X3D_BATCHES[0] else 0)
    del app
    torch.cuda.empty_cache()

    # bf16 against f32 compute, on weights away from the init (randomize_:
    # no residual branch zeroed by norm_c).
    randomize_(model, gen, clips(2, X3D_S_CLIP, gen))
    batch = next(SyntheticClips(BN_CHECK_BATCH, seed=43, clip=X3D_S_CLIP).train_dataloader(1))
    report["x3d_s_grads"] = check_bf16_step_grads(train, model, batch, "x3d_s")

    # The loss falls over 10 steps on one fixed batch (hard labels, no mix,
    # LR 0.01).
    fit = bn_app(train, "classification_x3d_xs",
                 SyntheticClips(BN_CHECK_BATCH, seed=44, fixed=True, clip=X3D_S_CLIP),
                 model=model, **{**overrides, "mix.enabled": False, "trainer.log_every_n_steps": 1,
                                 "optim.lr": 0.01, "lr_scheduler.lr": 0.01})
    with no_dropout(model):
        losses, _ = run_steps(fit, LOSS_STEPS)
    print(f"x3d_s loss over {LOSS_STEPS} steps on one fixed B{BN_CHECK_BATCH} batch: {losses}")
    assert all(math.isfinite(h) for h in losses), losses
    assert losses[-1] < losses[0] and sum(losses[-3:]) < sum(losses[:3]), f"no fall: {losses}"
    report["x3d_s_fit_losses"] = losses
    del fit, model, batch
    torch.cuda.empty_cache()

    # SlowFast-R50 on its preset, pathway-list batches, bf16.
    app = bn_app(train, "classification_slowfast_8x8_r50",
                 SyntheticClips(BN_SLOWFAST_BATCH, seed=45, clip=SLOWFAST_CLIPS[1], alpha=4),
                 seed=45, **{"trainer.compute_dtype": "bfloat16"})
    _, first_peak = first_step_grads(app, "slowfast_r50", {})
    report["slowfast_r50"] = {BN_SLOWFAST_BATCH: timed_bn_steps(app, "slowfast_r50", card,
                                                                first_peak)}
    del app
    torch.cuda.empty_cache()

    # The X3D-XS preset: an epoch, precise BN over PRECISE_BN_BATCHES, test().
    data = SyntheticClips(X3D_XS_BATCH, seed=46, clip=(4, 160, 160), val_batches=2)
    app = bn_app(train, "classification_x3d_xs", data, seed=46,
                 **{"trainer.precise_bn_batches": PRECISE_BN_BATCHES})
    app.steps_per_epoch = X3D_XS_STEPS
    app.train()
    norms = [n for n, m in app.model.named_modules() if isinstance(m, BatchNorm)]
    # The same stats taken one batch at a time on copies of the trained
    # model (precise BN leaves every parameter as training left it).
    trained = app.model.state_dict()
    per_batch = []
    for b in data.train_dataloader(PRECISE_BN_BATCHES):
        single = copy.deepcopy(app.model)
        train.update_bn_stats(single, [app._device_batch(b)], 1)
        per_batch.append(single.state_dict())
        del single
    worst = 0.0
    for n in norms:
        for stat in ("running_mean", "running_var"):
            key = f"{n}.{stat}"
            mean = torch.stack([s[key] for s in per_batch]).mean(0)
            err = (trained[key] - mean).abs().max().item() / mean.abs().max().item()
            worst = max(worst, err)
    print(f"x3d_xs precise BN over {PRECISE_BN_BATCHES} B{X3D_XS_BATCH} batches: {len(norms)} "
          f"BNs, the worst stat {worst!r} of its largest value from the mean of the per-batch "
          f"stats taken separately (bound {PRECISE_BN_REL})")
    assert worst <= PRECISE_BN_REL, f"precise BN off the per-batch mean by {worst}"
    result = app.test()
    predictions = app.predict()
    logits = torch.cat([p["logits"] for p in predictions])
    index = torch.cat([p["video_index"] for p in predictions])
    labels = torch.cat([p["label"] for p in predictions])
    videos = int(index.max()) + 1
    summed = torch.zeros(videos, logits.shape[1]).index_add_(0, index, logits)
    truth = torch.zeros(videos, dtype=torch.long).index_copy_(0, index, labels)
    by_hand = (summed.argmax(-1) == truth).float().mean().item()
    assert torch.isfinite(logits).all() and (index.bincount() == 2).all()
    assert result == {"video_top1": by_hand}, (result, by_hand)
    print(f"x3d_xs test(): {result} over {videos} videos of 2 clips (the clips' summed logits, "
          f"as by hand from predict())")
    report["x3d_xs"] = {"precise_bn_worst": worst, "test": result}
    del app, trained, per_batch
    torch.cuda.empty_cache()

    # Slow-R50 on its preset: one step at B4.
    app = bn_app(train, "classification_slow_8x8_r50",
                 SyntheticClips(4, seed=47, clip=(8, 224, 224)), seed=47)
    first_step_grads(app, "slow_r50", {})
    del app
    torch.cuda.empty_cache()
    return report


def eager_run(app, steps: int):
    """``steps`` eager steps (``app._train_step``, the step a CPU app runs)
    over the app's datamodule, as ``app.train()`` walks it (the same MixUp
    draws from the app's generator, the loss read back at the same log
    interval); returns the losses read and ms per step."""
    import torch

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step, batch in enumerate(app.datamodule.train_dataloader(steps)):
        app.state, metrics = app._train_step(app.state, app._device_batch(batch), app.generator)
        if step % app.cfg.trainer.log_every_n_steps == 0:
            losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) * 1000.0 / steps


def tensors_close(label: str, got: dict, ref: dict, compute: str = "bfloat16",
                  share: float = 1.0) -> float:
    """Each tensor of ``got`` against ``ref`` within ``share`` of phase 9's
    bound for ``compute`` (STEP_GRAD_TOL: rel x its max |ref| + floor x its
    module's; bf16's by default); integer buffers exactly. Returns the max
    |diff|."""
    import torch

    rel, floor = STEP_GRAD_TOL[compute]
    module_max = {}
    for n, r in ref.items():
        if r.is_floating_point():
            module_max[_module_of(n)] = max(module_max.get(_module_of(n), 0.0),
                                            r.abs().max().item() if r.numel() else 0.0)
    worst = 0.0
    for n, r in ref.items():
        g = got[n]
        assert torch.isfinite(g.float()).all(), f"{label}: {n} not finite"
        if not r.is_floating_point():
            assert torch.equal(g, r), f"{label}: {n} {g} != {r}"
            continue
        err = (g.double() - r.double()).abs().max().item() if r.numel() else 0.0
        bound = share * (rel * r.abs().max().item() + floor * module_max[_module_of(n)])
        assert err <= bound, f"{label}: {n} off by {err} > {bound}"
        worst = max(worst, err)
    return worst


def step_timings(fns: dict, B: int, iters: int) -> dict:
    """Each form's step (``fns``: form -> call, each run before) timed in
    turns by ``cuda_time_ms``, then its host ms and busy share (phase 17's)."""
    ms = time_turns(fns, iters, warmup=1)
    out = {}
    for form, fn in fns.items():
        busy_ms, busy = device_busy(fn)
        out[form] = {"ms_per_step": ms[form], "clips_per_s": B * 1000.0 / ms[form],
                     "host_ms": host_ms(fn), "busy": busy, "busy_ms_per_step": busy_ms}
    return out


def mvit_weights(hub, seed: int, **kwargs):
    import torch

    model = hub.mvit_base_16x4(**kwargs)
    randomize_mvit_(model, torch.Generator().manual_seed(seed))
    return model


def captured_mvit_case(train, hub, label: str, kwargs: dict, B: int, per_step: dict,
                       seed: int) -> dict:
    """Phase 19 (a, b) for one MViT case: the eager and the captured step
    from the same weights and batches (and a second eager run, the eager
    step's own spread: PyTorch's max-pool backward adds with atomics), then
    both timed."""
    import copy

    import torch

    model = mvit_weights(hub, seed, head_dropout_rate=0.0, **kwargs)
    apps = {form: train_app(train, B, seed, model=copy.deepcopy(model) if form != "captured"
                            else model) for form in ("eager", "eager again", "captured")}
    batches = list(apps["captured"].datamodule.train_dataloader(CAPTURED_STEPS))
    runs, peaks = {}, {}
    for form, app in apps.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, grads, calls = [], [], []
        for i, batch in enumerate(batches):
            batch = app._device_batch(batch)
            if form == "captured":
                metrics, counts = counted_update(app, batch, per_step,
                                                 f"{label} B{B} captured update {i + 1}")
                calls.append(counts)
            else:
                app.state, metrics = app._train_step(app.state, batch, app.generator)
            losses.append(metrics["loss"].item())
            grads.append({n: p.grad.clone() for n, p in app.model.named_parameters()})
        if form == "captured":
            reading = capture_reading(calls)
        else:
            check_path_counts(f"{label} B{B} {form}", read_counts(), per_step, CAPTURED_STEPS,
                              "steps")
        peaks[form] = torch.cuda.max_memory_allocated() - base
        runs[form] = (losses, grads)
    errs = {}
    for form in ("captured", "eager again"):
        losses, grads = runs[form]
        eager_losses, eager_grads = runs["eager"]
        rel = LOGIT_REL_TOL["bfloat16"]
        assert all(abs(a - b) <= rel * abs(b) for a, b in zip(losses, eager_losses)), (
            f"{label} B{B}: {form} losses {losses} against eager {eager_losses}")
        errs[form] = {
            "loss": max(abs(a - b) for a, b in zip(losses, eager_losses)),
            "grads": max(tensors_close(f"{label} B{B} {form} step {i + 1} gradients", g, e)
                         for i, (g, e) in enumerate(zip(grads, eager_grads))),
            "params": tensors_close(f"{label} B{B} {form} parameters after {CAPTURED_STEPS} "
                                    f"steps", dict(apps[form].model.named_parameters()),
                                    dict(apps["eager"].model.named_parameters()))}
    print(f"{label} B{B}: {CAPTURED_STEPS} steps from the same weights and batches, captured "
          f"against eager: losses {runs['captured'][0]} / {runs['eager'][0]}; max |diff| of "
          f"the loss {errs['captured']['loss']!r}, of each step's gradients "
          f"{errs['captured']['grads']!r}, of the parameters after {errs['captured']['params']!r} "
          f"(bounds: phase 9's bf16 per-tensor one); eager against eager again (its own "
          f"spread): {errs['eager again']['loss']!r}, {errs['eager again']['grads']!r}, "
          f"{errs['eager again']['params']!r}")
    eager, captured = apps["eager"], apps["captured"]
    del apps["eager again"], runs
    batch = captured._device_batch(batches[0])
    timings = step_timings({
        "eager": lambda: eager._train_step(eager.state, batch, eager.generator),
        "captured": lambda: captured._step(batch)}, B, CAPTURED_TIMED_STEPS)
    reset_counts()
    captured._step(batch)
    assert not any(read_counts().values()), f"{label} B{B}: a replay launched a wrapper"
    timings["eager"]["peak_bytes"] = peaks["eager"]
    timings["captured"]["peak_bytes"] = peaks["captured"]
    e, c = timings["eager"], timings["captured"]
    print(f"{label} train bf16 B{B} eager / captured: {e['clips_per_s']!r} / "
          f"{c['clips_per_s']!r} clips/s ({e['ms_per_step']!r} / {c['ms_per_step']!r} ms/step), "
          f"host {e['host_ms']!r} / {c['host_ms']!r} ms/step, busy {e['busy']!r} / "
          f"{c['busy']!r} ({e['busy_ms_per_step']!r} / {c['busy_ms_per_step']!r} device "
          f"ms/step), peak {peaks['eager']} / {peaks['captured']} bytes above the resident "
          f"state (captured: its capture's, warm-up updates included)")
    del eager, captured, apps, model, batch, batches
    torch.cuda.empty_cache()
    return {"max_abs_diff": errs, "capture_reading": reading, **timings}


def dropout_replays(train, hub, seed: int, explicit: bool) -> list:
    """Updates of the captured step on one batch with the recipe's head
    dropout (0.5) and DropPath 0.2, at LR 0, up to three replays: their
    losses must differ (new masks each replay), the parameters stay. ``explicit``: the blocks and
    the head draw from their own CUDA generators (registered with the
    graph), else from torch's default one."""
    import torch

    model = mvit_weights(hub, seed, droppath_rate_block=0.2)
    if explicit:
        for i, module in enumerate([*model.blocks, model.head.dropout]):
            module.generator = torch.Generator(device="cuda").manual_seed(seed + i)
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    app = train_app(train, PRESET_BATCH, seed, model=model, **ZERO_LR)
    batch = app._device_batch(next(app.datamodule.train_dataloader(1)))
    # The warm-up updates, the capture's replay and one more replay.
    losses = [app._step(batch)[1]["loss"].item() for _ in range(WARMUP_STEPS + 2)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses.append(app._step(batch)[1]["loss"].item())
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters()), "LR 0 moved"
    assert len(set(losses)) == len(losses), f"replays drew one mask: losses {losses}"
    print(f"dropout on ({'explicit CUDA generators' if explicit else 'default generator'}), LR 0, "
          f"one B{PRESET_BATCH} batch: replay losses {losses}, all different")
    del app, model
    torch.cuda.empty_cache()
    return losses


def captured_bn_case(train, label: str, preset: str, data, overrides: dict, phase18: dict,
                     seed: int) -> dict:
    """Phase 19 (c): a BN model's eager and captured steps from the same
    weights and batches (dropout 0), then both timed."""
    import copy

    import torch

    captured = bn_app(train, preset, data(), seed=seed, **overrides)
    eager = bn_app(train, preset, data(), model=copy.deepcopy(captured.model), seed=seed,
                   **overrides)
    B = captured.datamodule.batch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager_losses, _ = eager_run(eager, CAPTURED_BN_STEPS)
    eager_peak = torch.cuda.max_memory_allocated() - base
    base = torch.cuda.memory_allocated()
    losses, _, _, peak = captured_run(captured, CAPTURED_BN_STEPS, {}, f"{label} captured")
    capture_peak = peak - base
    err = tensors_close(f"{label} B{B} parameters and BN buffers after {CAPTURED_BN_STEPS} steps",
                        captured.model.state_dict(), eager.model.state_dict())
    print(f"{label} B{B}: {CAPTURED_BN_STEPS} captured steps against eager: losses {losses} / "
          f"{eager_losses}; parameters, running stats and num_batches_tracked max |diff| {err!r}")
    batch = captured._device_batch(next(captured.datamodule.train_dataloader(1)))
    timings = step_timings({
        "eager": lambda: eager._train_step(eager.state, batch, eager.generator),
        "captured": lambda: captured._step(batch)}, B, 2)
    timings["eager"]["peak_bytes"], timings["captured"]["peak_bytes"] = eager_peak, capture_peak
    e, c = timings["eager"], timings["captured"]
    print(f"{label} train bf16 B{B} eager / captured: {e['clips_per_s']!r} / "
          f"{c['clips_per_s']!r} clips/s, busy {e['busy']!r} / {c['busy']!r}, host "
          f"{e['host_ms']!r} / {c['host_ms']!r} ms/step, peak {eager_peak} / {capture_peak} "
          f"bytes; phase 18 through app.train(): {phase18['clips_per_s']!r} clips/s, busy "
          f"{phase18['busy_share']!r}, peak {phase18['peak_bytes']} bytes")
    del captured, eager, batch
    torch.cuda.empty_cache()
    return {"max_abs_diff": err, "losses": losses, "eager_losses": eager_losses, **timings}


def remat_case(train, hub, model, policy, batch, seed: int) -> dict:
    """Phase 19 (d) for one policy on MViT-B B8: one eager step's gradients
    (``forward_backward``), and the captured step's gradients at its first
    replay (the capture's) after its warm-up updates, with its launches,
    timings and peak memory."""
    import copy

    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    per_step = MVIT_PER_STEP if policy is None else remat_per_step(MVIT_PER_STEP)
    label = f"mvit_base_16x4 remat {policy}"
    ours = copy.deepcopy(model)
    reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train.forward_backward(ours.train(), batch["video"], batch["label"],
                           compute_dtype=torch.bfloat16, remat_policy=policy)
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() - base
    check_path_counts(f"{label} B{TRAIN_BATCH} eager", read_counts(), per_step, 1, "steps")
    eager_grads = {n: p.grad.clone() for n, p in ours.named_parameters()}
    del ours
    app = train_app(train, TRAIN_BATCH, seed, model=copy.deepcopy(model),
                    **{"trainer.remat_policy": policy})
    base = torch.cuda.memory_allocated()
    _, _, _, peak = captured_run(app, WARMUP_STEPS + 1, per_step, label)
    capture_peak = peak - base
    captured_grads = {n: p.grad.clone() for n, p in app.model.named_parameters()}
    device_batch = app._device_batch(next(app.datamodule.train_dataloader(1)))
    timings = step_timings({
        "eager": lambda: app._train_step(app.state, device_batch, app.generator),
        "captured": lambda: app._step(device_batch)}, TRAIN_BATCH, 3)
    timings["captured"]["peak_bytes"] = capture_peak
    timings["eager"]["peak_bytes"] = fb_peak
    e, c = timings["eager"], timings["captured"]
    print(f"{label} B{TRAIN_BATCH}: eager / captured {e['ms_per_step']!r} / "
          f"{c['ms_per_step']!r} ms/step, busy {e['busy']!r} / {c['busy']!r} "
          f"({e['busy_ms_per_step']!r} / {c['busy_ms_per_step']!r} device ms/step), peak "
          f"{fb_peak} (one forward and backward) / {capture_peak} (the capture) bytes")
    del app, device_batch
    torch.cuda.empty_cache()
    return {"eager_grads": eager_grads, "captured_grads": captured_grads, **timings}


def reference_update(optimizer, names: dict, before: dict, state: dict, grads: dict,
                     lr: float) -> dict:
    """torch.optim's update of ``optimizer``'s kind, groups and
    hyperparameters, in float64 one tensor at a time at the float LR ``lr``,
    from the parameters ``before`` and the optimizer state ``state`` at the
    gradients ``grads`` (each by name; ``names``: parameter -> name).
    Returns {name: the parameter after}."""
    import torch

    ref, groups = {}, []
    for group in optimizer.param_groups:
        members = []
        for p in group["params"]:
            q = before[names[p]].double().clone()
            q.grad = grads[names[p]].double()
            ref[names[p]] = q
            members.append(q)
        hyper = {k: v for k, v in group.items()
                 if k not in ("params", "lr", "foreach", "fused", "capturable")}
        groups.append({**hyper, "params": members, "lr": lr})
    reference = type(optimizer)(groups, lr=lr, foreach=False)
    for n, q in ref.items():
        if state.get(n):
            reference.state[q] = {k: v.detach().cpu().float() if k == "step" else v.double()
                                  for k, v in state[n].items()}
    reference.step()
    return {n: q.detach() for n, q in ref.items()}


def update_share(model, ref: dict, before: dict) -> tuple:
    """The worst tensor's |p - ref| / (LR_CHECK_REL x |ref - before| +
    2^-23 x |ref|), L2 norms over each tensor (the second term: one f32
    rounding of the result either way); returns (share, its name)."""
    import torch

    norm = torch.linalg.vector_norm
    shares = []
    for n, p in model.named_parameters():
        bound = LR_CHECK_REL * norm(ref[n] - before[n].double()) + 2.0**-23 * norm(ref[n])
        shares.append(((norm(p.detach().double() - ref[n]) / bound).item(), n))
    return max(shares)


def lr_check_case(label: str, apps: dict) -> dict:
    """Phase 19 (e) for one model: ``apps`` (eager, eager again, captured:
    the same weights and seeds) each make LR_CHECK_STEPS updates on the same
    batches. Each update of the captured step (its warm-up updates, the
    capture's replay, replays) is held against torch.optim's update from
    the state before it at the gradients it took (``reference_update``);
    each run's change of the parameters over all updates against the eager
    run's is printed."""
    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    eager = apps["eager"]
    start = {n: p.detach().clone() for n, p in eager.model.named_parameters()}
    batches = list(eager.datamodule.train_dataloader(LR_CHECK_STEPS))
    lrs = [eager.state.lr_schedule(k) for k in range(LR_CHECK_STEPS)]
    assert len(set(lrs)) == len(lrs), f"{label}: the LR repeats: {lrs}"
    changes, shares = {}, []
    for form, app in apps.items():
        model, optimizer = app.model, app.state.optimizer
        assert all(torch.equal(p, start[n]) for n, p in model.named_parameters())
        names = {p: n for n, p in model.named_parameters()}
        for k, batch in enumerate(batches):
            batch = app._device_batch(batch)
            if form != "captured":
                app.state, _ = app._train_step(app.state, batch, app.generator)
                continue
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            state = {names[p]: {key: v.clone() for key, v in s.items()}
                     for p, s in optimizer.state.items()}
            app.state, _ = app._step(batch)
            grads = {n: p.grad for n, p in model.named_parameters()}
            ref = reference_update(optimizer, names, before, state, grads, lrs[k])
            shares.append(update_share(model, ref, before))
        changes[form] = {n: (p.detach() - start[n]).double()
                         for n, p in model.named_parameters()}
    (step,) = apps["captured"]._captured_steps.values()
    assert step.graph is not None and step.calls == LR_CHECK_STEPS
    norm = torch.linalg.vector_norm
    whole = norm(torch.cat([d.flatten() for d in changes["eager"].values()]))
    spread = {form: (norm(torch.cat([(changes[form][n] - d).flatten()
                                     for n, d in changes["eager"].items()])) / whole).item()
              for form in ("captured", "eager again")}
    kept = sum(lrs[:WARMUP_STEPS + 1]) + lrs[WARMUP_STEPS] * (LR_CHECK_STEPS - WARMUP_STEPS - 1)
    report = {"lrs": lrs, "update_shares": [share for share, _ in shares],
              "change_rel_diff": spread,
              "kept_lr_share": abs(kept - sum(lrs)) / sum(lrs)}
    print(f"{label} f32, LRs {lrs}: each update of the captured step against torch.optim's "
          f"(float64, float LR) from the same state at its gradients, the worst tensor's share "
          f"of its bound ({LR_CHECK_REL} x its change + one f32 rounding): "
          f"{[(round(share, 6), n) for share, n in shares]}; a graph that kept the capture's "
          f"LR would move the summed LR by {report['kept_lr_share']!r}. The whole change over "
          f"{LR_CHECK_STEPS} updates against eager's, relative L2: captured "
          f"{spread['captured']!r}, eager again {spread['eager again']!r}")
    worst, name = max(shares)
    assert worst <= 1.0, f"{label}: an update off torch.optim's by {worst} of its bound in {name}"
    assert spread["captured"] <= LR_CHECK_WHOLE_REL, (
        f"{label}: the captured run's change off eager's by {spread['captured']}")
    return report


def captured_lr_checks(train, hub, seed: int) -> dict:
    """Phase 19 (e): the LR tensor read at each replay, by AdamW (MViT-B's
    recipe, B2) and by SGD (X3D-S on bench.py's recipe, B8), in f32."""
    import copy

    import torch

    report = {}
    model = mvit_weights(hub, seed, head_dropout_rate=0.0)
    report["mvit_base_16x4"] = lr_check_case("mvit_base_16x4 AdamW", {
        form: train_app(train, LR_CHECK_BATCH["mvit_base_16x4"], seed, model=copy.deepcopy(model),
                        **{"trainer.compute_dtype": "float32"})
        for form in ("eager", "eager again", "captured")})
    del model
    torch.cuda.empty_cache()
    overrides = {**x3d_s_bench_overrides(), "trainer.compute_dtype": "float32",
                 "model.kwargs": {"dropout_rate": 0.0}, "lr_scheduler.warmup_iters": 10,
                 "lr_scheduler.warmup_start_lr": 0.01}
    data = SyntheticClips(LR_CHECK_BATCH["x3d_s"], seed=seed + 1, clip=X3D_S_CLIP)
    first = bn_app(train, "classification_x3d_xs", data, seed=seed + 1, **overrides)
    apps = {form: bn_app(train, "classification_x3d_xs", data, seed=seed + 1,
                         model=copy.deepcopy(first.model), **overrides)
            for form in ("eager", "eager again")}
    report["x3d_s"] = lr_check_case("x3d_s SGD", {**apps, "captured": first})
    del first, apps
    torch.cuda.empty_cache()
    return report


def captured_step_slice(train, hub, bn_report: dict) -> dict:
    """Phase 19: the training step captured in CUDA graphs, against the
    eager step: MViT-B (a, b), dropout masks across replays, the BN models
    (c), activation rematerialisation (d), the LR on the device (e); each
    part's seconds printed."""
    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    t_part = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"phase 19 {part}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    report = {"mvit": {}, "bn": {}, "remat": {}}
    for i, (label, kwargs, B, per_step) in enumerate(CAPTURED_CASES):
        report["mvit"][f"{label} B{B}"] = captured_mvit_case(train, hub, label, kwargs, B,
                                                             per_step, seed=50 + i)
    report["dropout_replays"] = {"default": dropout_replays(train, hub, 55, explicit=False),
                                 "explicit": dropout_replays(train, hub, 56, explicit=True)}
    lap("(a, b) and the dropout replays")
    x3d = dict(x3d_s_bench_overrides(), **{"model.kwargs": {"dropout_rate": 0.0}})
    report["bn"]["x3d_s"] = captured_bn_case(
        train, "x3d_s", "classification_x3d_xs",
        lambda: SyntheticClips(BN_X3D_BATCHES[0], seed=57, clip=X3D_S_CLIP), x3d,
        bn_report["x3d_s"][BN_X3D_BATCHES[0]], seed=57)
    report["bn"]["slowfast_r50"] = captured_bn_case(
        train, "slowfast_r50", "classification_slowfast_8x8_r50",
        lambda: SyntheticClips(BN_SLOWFAST_BATCH, seed=58, clip=SLOWFAST_CLIPS[1], alpha=4),
        {"trainer.compute_dtype": "bfloat16", "model.kwargs": {"dropout_rate": 0.0}},
        bn_report["slowfast_r50"][BN_SLOWFAST_BATCH], seed=58)
    lap("(c)")

    model = mvit_weights(hub, 59, head_dropout_rate=0.0)
    gen = torch.Generator(device="cuda").manual_seed(59)
    batch = {"video": torch.randn(TRAIN_BATCH, 3, *MVIT_CLIP, device="cuda", generator=gen),
             "label": torch.randint(0, 400, (TRAIN_BATCH,), device="cuda", generator=gen)}
    cases = {policy: remat_case(train, hub, model, policy, batch, seed=59)
             for policy in REMAT_CHECKED}
    for policy in REMAT_CHECKED[1:]:
        row = {}
        for form in ("eager", "captured"):
            row[f"{form}_grad_max_abs_diff"] = tensors_close(
                f"remat {policy} {form} gradients", cases[policy][f"{form}_grads"],
                cases[None][f"{form}_grads"])
            row[form] = {k: cases[policy][form][k] for k in ("ms_per_step", "busy",
                                                             "busy_ms_per_step", "peak_bytes")}
            row[f"{form}_without_remat"] = {k: cases[None][form][k] for k in
                                            ("ms_per_step", "busy", "busy_ms_per_step",
                                             "peak_bytes")}
        print(f"remat {policy} B{TRAIN_BATCH}: gradients against the step without remat, max "
              f"|diff| eager {row['eager_grad_max_abs_diff']!r}, captured "
              f"{row['captured_grad_max_abs_diff']!r}")
        report["remat"][policy] = row
    del cases, model, batch
    torch.cuda.empty_cache()

    app = bn_app(train, "classification_x3d_xs",
                 SyntheticClips(BN_X3D_BATCHES[1], seed=60, clip=X3D_S_CLIP), seed=60,
                 **{**x3d_s_bench_overrides(), "trainer.remat_policy": "full"})
    base = torch.cuda.memory_allocated()
    losses, ms, _, peak = captured_run(app, WARMUP_STEPS + 1, {}, "x3d_s remat full")
    report["remat"]["x3d_s B128 full"] = {"capture_peak_bytes": peak - base,
                                          "peak_bytes_with_state": peak, "losses": losses}
    print(f"x3d_s remat full B{BN_X3D_BATCHES[1]}: peak {peak!r} bytes with the resident state "
          f"({peak - base!r} above it) at the capture; phase 18 without remat "
          f"{bn_report['x3d_s'][BN_X3D_BATCHES[1]]['peak_bytes']!r} bytes; losses {losses}")
    del app
    torch.cuda.empty_cache()
    lap("(d)")

    report["lr"] = captured_lr_checks(train, hub, seed=61)
    lap("(e)")
    return report


# Phase 20, the data feed. (a) the transforms at MViT's decode geometry; (b)
# and (c) a store of X3D-S clips before their resize; (d) a store at MViT's
# decode geometry.
FEED_CLIP = (16, 256, 340)
FEED_TOL = 1e-5  # float results, CUDA against CPU, relative to the value range
FEED_EXACT_OPS = ("Equalize", "Posterize", "Solarize", "Invert")
FEED_OP_FACTORS = {
    "AutoContrast": [None], "Equalize": [None], "Invert": [None],
    "AdjustBrightness": [0.3, 1.6], "AdjustContrast": [0.2, 1.8],
    "AdjustSaturation": [0.1, 1.9], "AdjustSharpness": [0.1, 1.9],
    "Posterize": [0, 2, 4], "Solarize": [0.1, 0.5, 0.9], "Rotate": [-27.0, 13.5],
    "ShearX": [-0.3, 0.17], "ShearY": [0.3, -0.11], "TranslateX": [-0.45, 0.2],
    "TranslateY": [0.45, -0.13],
}
FEED_STORE_CLIPS = 256
FEED_STORE_CLIP = (13, 240, 320)
FEED_BATCH = 128
FEED_BATCHES = 12
FEED_MEAN, FEED_STD = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
TRAIN_STORE_CLIPS = 64
FEED_TRAIN_STEPS = 10
FEED_PROFILED_BATCHES = 6


def feed_compare(rows: dict, name: str, make, x, exact: bool) -> None:
    """``make()(x)`` on the card against ``make()(x)`` on the CPU (a new
    transform each, so seeded ones draw alike): equal where ``exact``, else
    within ``FEED_TOL`` of the CPU result's value range. Records the worst
    error relative to the range in ``rows[name]``."""
    import torch

    def leaves(out):
        if isinstance(out, dict):
            out = out["video"]
        return list(out) if isinstance(out, (list, tuple)) else [out]

    want = leaves(make()(x.clone()))
    got = leaves(make()(x.cuda()))
    assert len(want) == len(got), name
    worst = 0.0
    for w, g in zip(want, got):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, (
            f"{name}: {g.device} {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} {w.dtype}")
        g = g.cpu()
        if exact:
            assert torch.equal(g, w), f"{name}: the card's result differs from the CPU's"
            continue
        span = float(w.double().max() - w.double().min()) or 1.0
        err = float((g.double() - w.double()).abs().max()) / span
        assert err <= FEED_TOL, f"{name}: {err!r} of the value range > {FEED_TOL}"
        worst = max(worst, err)
    rows[name] = worst


def transforms_on_card(card: str) -> dict:
    """Phase 20 (a): each transform on the card against the CPU."""
    import numpy as np
    import torch

    from pytorchvideo_tpu_torch.transforms import augmentations as A
    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms import transforms as T
    from pytorchvideo_tpu_torch.transforms.augmix import AugMix
    from pytorchvideo_tpu_torch.transforms.rand_augment import RandAugment
    from pytorchvideo_tpu_torch.transforms.transforms_factory import create_video_transform

    u8 = torch.from_numpy(np.random.default_rng(20).integers(0, 256, size=(*FEED_CLIP, 3),
                                                             dtype=np.uint8))
    f32 = u8.float() / 255.0
    rows = {}

    def fn(f):
        return lambda: f

    seeded = torch.Generator
    exact = [
        ("uniform_temporal_subsample", fn(lambda x: F.uniform_temporal_subsample(x, 8))),
        ("uniform_temporal_subsample_repeated",
         fn(lambda x: F.uniform_temporal_subsample_repeated(x, (1, 4)))),
        ("crop", fn(lambda x: F.crop(x, 17, 33, 224))),
        *[(f"uniform_crop {i}", fn(lambda x, i=i: F.uniform_crop(x, 224, i))) for i in range(3)],
        ("center_crop", fn(lambda x: F.center_crop(x, 224))),
        ("horizontal_flip", fn(F.horizontal_flip)),
        ("random_crop", fn(lambda x: F.random_crop(x, 224, seeded().manual_seed(5)))),
        ("thwc_to_cthw", fn(lambda x: F.thwc_to_cthw(x).contiguous())),
        ("UniformTemporalSubsample", lambda: T.UniformTemporalSubsample(8)),
        ("UniformTemporalSubsampleRepeated", lambda: T.UniformTemporalSubsampleRepeated((1, 4))),
        ("RandomCropVideo", lambda: T.RandomCropVideo(224, seed=2)),
        ("CenterCropVideo", lambda: T.CenterCropVideo(224)),
        ("RandomHorizontalFlipVideo", lambda: T.RandomHorizontalFlipVideo(0.5, seed=1)),
        ("UniformCropVideo", lambda: (lambda x: T.UniformCropVideo(224)(
            {"video": x, "aug_index": 2}))),
        ("Permute", lambda: T.Permute((3, 0, 1, 2))),
        ("MoveChannelFront", lambda: T.MoveChannelFront()),
        ("OpSampler", lambda: T.OpSampler([F.horizontal_flip, A._invert,
                                           lambda x: F.crop(x, 3, 4, 200)],
                                          num_sample_op=2, seed=3)),
    ]
    for name, make in exact:
        feed_compare(rows, name, make, u8, exact=True)
    feed_compare(rows, "MoveChannelRear", lambda: T.MoveChannelRear(),
                 F.thwc_to_cthw(u8).contiguous(), exact=True)
    feed_compare(rows, "ConvertFloatToUint8", lambda: T.ConvertFloatToUint8(), f32, exact=True)
    floats = [
        ("resize down", fn(lambda x: F.resize(x, (224, 298))), f32),
        ("resize up", fn(lambda x: F.resize(x, (320, 425))), f32),
        ("short_side_scale", fn(lambda x: F.short_side_scale(x, 224)), f32),
        ("crop_and_resize", fn(lambda x: F.crop_and_resize(x, 10.0, 20.0, 150.0, 170.0, 224,
                                                           224)), f32),
        ("crop_and_resize up", fn(lambda x: F.crop_and_resize(x, 0.0, 0.0, 100.0, 120.0, 224,
                                                              224)), f32),
        ("div_255", fn(F.div_255), u8),
        ("normalize", fn(lambda x: F.normalize(x, (0.45, 0.4, 0.35), (0.225, 0.2, 0.25))), f32),
        ("random_resized_crop", fn(lambda x: F.random_resized_crop(
            x, 224, 224, (0.08, 1.0), (3 / 4, 4 / 3), generator=seeded().manual_seed(6))), f32),
        ("random_resized_crop shift", fn(lambda x: F.random_resized_crop(
            x, 224, 224, (0.08, 1.0), (3 / 4, 4 / 3), generator=seeded().manual_seed(7),
            shift=True)), f32),
        ("ShortSideScale", lambda: T.ShortSideScale(224), f32),
        ("RandomShortSideScale", lambda: T.RandomShortSideScale(256, 320, seed=4), f32),
        ("Normalize", lambda: T.Normalize(FEED_MEAN, FEED_STD), f32),
        ("ConvertUint8ToFloat", lambda: T.ConvertUint8ToFloat(), u8),
        ("Div255", lambda: T.Div255(), u8),
        ("RandomResizedCrop", lambda: T.RandomResizedCrop(224, 224, (0.08, 1.0),
                                                          (3 / 4, 4 / 3), seed=8), f32),
        ("affine nearest", fn(lambda x: A.affine(x, [1, 0.1, 2.5, -0.2, 1, -3.0],
                                                 interpolation="nearest")), u8),
    ]
    for name, make, x in floats:
        feed_compare(rows, name, make, x, exact=False)
    for name, factors in FEED_OP_FACTORS.items():
        op = A._NAME_TO_TRANSFORM_FUNC[name]
        for factor in factors:
            args = () if factor is None else (factor,)
            for kind, x in (("uint8", u8), ("float32", f32)):
                feed_compare(rows, f"{name} {factor} {kind}",
                             fn(lambda v, op=op, args=args: op(v, *args, fill=(0.5, 0.5, 0.5))),
                             x, exact=kind == "uint8" and name in FEED_EXACT_OPS)
    for kind, x in (("uint8", u8), ("float32", f32)):
        feed_compare(rows, f"RandAugment {kind}", lambda: RandAugment(prob=1.0, seed=9), x,
                     exact=False)
        feed_compare(rows, f"AugMix {kind}", lambda: AugMix(seed=10), x, exact=False)
    chains = {"train default": dict(), "train randaug": dict(aug_type="randaug"),
              "train augmix": dict(aug_type="augmix"),
              "train rrc": dict(random_resized_crop_paras={}), "val": dict()}
    for name, kw in chains.items():
        mode = name.split()[0]
        feed_compare(rows, f"create_video_transform {name}",
                     lambda mode=mode, kw=kw: (lambda v, t=create_video_transform(
                         mode, video_key="video", num_samples=16, min_size=256, max_size=320,
                         crop_size=224, seed=11, **kw): t({"video": v})),
                     u8, exact=False)
    worst = max(rows.values())
    print(f"phase 20 (a): {len(rows)} transforms on the card against the CPU at "
          f"{FEED_CLIP[0]}x{FEED_CLIP[1]}x{FEED_CLIP[2]}: the index and uint8 ops equal, the "
          f"worst float error {worst!r} of the value range (bound {FEED_TOL}); on {card}")
    print("phase 20 (a) worst error per op: " + json.dumps(rows))
    return {"ops": len(rows), "worst": worst, "per_op": rows}


def make_store(directory: str, count: int, clip, seed: int):
    """``prepare_clip_store`` of ``count`` seeded uint8 clips of (T, H, W)
    ``clip`` (labels of 400 classes); returns the opened ClipStore."""
    import numpy as np

    from pytorchvideo_tpu_torch.data import ClipStore, prepare_clip_store

    rng = np.random.default_rng(seed)

    def samples():
        for i in range(count):
            yield {"video": rng.integers(0, 256, size=(*clip, 3), dtype=np.uint8),
                   "label": int(rng.integers(0, 400)), "video_index": i}

    prepare_clip_store(samples(), directory, clips_per_shard=64, num_workers=2)
    return ClipStore(directory)


def store_order(store, seed: int, epoch: int):
    """The clip order of ``store.batches(shuffle=True, seed=seed)``'s epoch."""
    import numpy as np

    order = np.arange(len(store))
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def streamed_ms(open_stream, batches: int, consume_s: float) -> float:
    """Wall ms per batch of the prefetch ``open_stream()`` returns, each
    batch waited for on the card and then held ``consume_s`` by the
    consumer (after four batches: the ring's pinned buffers allocated)."""
    import torch

    with open_stream() as stream:
        for _ in range(4):
            next(stream)
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            next(stream)
            torch.cuda.current_stream().synchronize()
            if consume_s:
                time.sleep(consume_s)
        return (time.perf_counter() - t0) * 1e3 / batches


def check_prefetched(label: str, store, stream, seed: int, batches: int) -> int:
    """Each of ``batches`` batches of ``stream`` (over ``store`` shuffled
    from ``seed``) equal byte for byte to ``store.gather`` of its indices
    on the card; its pinned allocations the ring's per leaf; ``close()``
    in mid-epoch stops its producer. Returns the pinned allocations."""
    import torch

    per_epoch = len(store) // FEED_BATCH
    for i in range(batches):
        batch = next(stream)
        epoch, j = divmod(i, per_epoch)
        ref = store.gather(store_order(store, seed, epoch)[j * FEED_BATCH:(j + 1) * FEED_BATCH])
        for key in ("video", "label", "video_index"):
            assert batch[key].is_cuda and torch.equal(batch[key], ref[key].cuda()), (
                f"phase 20 (b) {label}: batch {i}'s {key} differs from store.gather")
    allocations = stream.pinned_allocations
    assert allocations == stream.ring_size * 3, (
        f"phase 20 (b) {label}: {allocations} pinned allocations over {batches} batches, "
        f"expected the ring's {stream.ring_size} per leaf (3 leaves)")
    stream.close()
    assert not stream.alive, f"phase 20 (b) {label}: close() left the producer running"
    return allocations


def feed_alone(store, card: str) -> dict:
    """Phase 20 (b): the store -> prefetch path at B128, as
    ``ClipStore.batches`` -> ``device_prefetch`` and as
    ``ClipStore.prefetch`` (the gather into the pinned ring)."""
    import torch

    from pytorchvideo_tpu_torch.data import device_prefetch

    batch_bytes = FEED_BATCH * math.prod(store.clip_shape) * 3
    per_epoch = len(store) // FEED_BATCH
    order = store_order(store, 0, 0)
    pinned = {}

    def into_pinned(name, shape, dtype):
        if name not in pinned:
            pinned[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return pinned[name]

    gather_gbs = {}
    for label, out in (("new buffer", None), ("pinned buffer", into_pinned)):
        store.gather(order[:FEED_BATCH], out)
        t0 = time.perf_counter()
        for i in range(2 * per_epoch):
            j = i % per_epoch
            store.gather(order[j * FEED_BATCH:(j + 1) * FEED_BATCH], out)
        gather_gbs[label] = 2 * per_epoch * batch_bytes / (time.perf_counter() - t0) / 1e9
    target = torch.empty(pinned["video"].shape, dtype=torch.uint8, device="cuda")
    copy_ms = cuda_time_ms(lambda: target.copy_(pinned["video"], non_blocking=True), 5)
    copy_gbs = batch_bytes / copy_ms / 1e6
    del pinned, target

    checked = 2 * per_epoch
    allocations = {
        "batches": check_prefetched("batches -> device_prefetch", store, device_prefetch(
            store.batches(FEED_BATCH, seed=5, epochs=None), "cuda"), 5, checked),
        "prefetch": check_prefetched("ClipStore.prefetch", store, store.prefetch(
            FEED_BATCH, "cuda", seed=6, epochs=None), 6, checked)}
    streams = {"batches": lambda: device_prefetch(store.batches(FEED_BATCH, seed=1, epochs=None),
                                                  "cuda"),
               "prefetch": lambda: store.prefetch(FEED_BATCH, "cuda", seed=1, epochs=None)}
    overlap = {}
    for label, open_stream in streams.items():
        produce = streamed_ms(open_stream, FEED_BATCHES, 0.0)
        paced = streamed_ms(open_stream, FEED_BATCHES, produce / 1e3)
        overlap[label] = {"produce_ms": produce, "paced_ms": paced, "overlap": produce / paced}
    report = {"batch_bytes": batch_bytes, "gather_gb_per_s": gather_gbs,
              "copy_gb_per_s": copy_gbs, "copy_ms": copy_ms, "checked_batches": checked,
              "pinned_allocations": allocations, "ring_size": 3, "streams": overlap}
    print(f"phase 20 (b): store {len(store)} clips {store.clip_shape} uint8, B{FEED_BATCH} "
          f"({batch_bytes} bytes a batch): host gather {gather_gbs!r} GB/s, the pinned "
          f"ring's copy to the card {copy_gbs!r} GB/s ({copy_ms!r} ms a batch); {checked} "
          f"batches of each path equal store.gather byte for byte; pinned allocations "
          f"{allocations} (3 leaves x ring 3) whatever the batch count; close() stopped each "
          f"producer; on {card}")
    for label, o in overlap.items():
        print(f"phase 20 (b) {label}: the producer alone {o['produce_ms']!r} ms a batch; with "
              f"a consumer holding each batch as long, {o['paced_ms']!r} ms (max "
              f"{o['produce_ms']!r}, sum {2 * o['produce_ms']!r}): overlap {o['overlap']!r} "
              f"(1 overlapped, 0.5 serial); on {card}")
    return report


def profiled_busy(fn) -> tuple:
    """(busy ms, busy share) of ``fn()`` traced by ``torch.profiler``
    (device activity only; phase 17's union over the span)."""
    busy, span = device_union_ms(device_trace(fn))
    return busy, busy / span


def window_ms(step, batches: int = FEED_BATCHES) -> float:
    """Wall ms per call of ``batches`` calls of ``step()``, the card
    synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / batches


def serve_from_store(store, hub, convert_to_deployable_form, card: str) -> dict:
    """Phase 20 (c): X3D-S deploy bf16 captured at B128, fed from the store
    (``ClipStore.prefetch``) through the val chain, run on the card in the
    prefetch's stream."""
    import torch

    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms import transforms as T

    clip = (13, 160, 160)
    gen = torch.Generator().manual_seed(20)
    model = compiled_model(hub, "x3d_s", {}, clip, gen)
    compiled = convert_to_deployable_form(model, dtype=torch.bfloat16,
                                          example_input=clips(FEED_BATCH, clip, gen,
                                                              torch.bfloat16))
    del model
    chain = T.Compose([T.Div255(), T.Normalize(FEED_MEAN, FEED_STD), T.ShortSideScale(182),
                       T.CenterCropVideo(160), F.thwc_to_cthw])

    def fed_input(batch):
        return {**batch, "video": chain(batch["video"]).to(torch.bfloat16)}

    def open_stream(seed=3):
        return store.prefetch(FEED_BATCH, "cuda", seed=seed, epochs=None, transform=fed_input)

    with open_stream() as stream:
        first = next(stream)["video"]
    fed_logits = compiled(first)
    host_batch = store.gather(store_order(store, 3, 0)[:FEED_BATCH])
    host_in = fed_input(host_batch)["video"]
    in_err = float((first.float().cpu() - host_in.float()).abs().max())
    ref_logits = compiled(host_in.cuda())
    scale = ref_logits.float().abs().max().item()
    bound = LOGIT_REL_TOL["bfloat16"] * scale
    err = (fed_logits.float() - ref_logits.float()).abs().max().item()
    assert fed_logits.shape == (FEED_BATCH, 400) and bool(fed_logits.isfinite().all())
    assert err <= bound, f"phase 20 (c): fed logits off the CPU-fed ones by {err} > {bound}"
    device_batch = {k: v.cuda() for k, v in host_batch.items()}
    chain_host_ms = host_ms(lambda: fed_input(device_batch))
    chain_ms = cuda_time_ms(lambda: fed_input(device_batch), 3)

    def fed():
        # The window starts once the prefetch's ring is allocated (pinning
        # 383 MB takes a while) and its queue full: the steady rate.
        with open_stream() as stream:
            for _ in range(4):
                compiled(next(stream)["video"])
            return window_ms(lambda: compiled(next(stream)["video"]))

    # In turns: resident, fed, fed, resident; the mean of each.
    runs = {"resident": [], "fed": []}
    for label in ("resident", "fed", "fed", "resident"):
        runs[label].append(window_ms(lambda: compiled(first)) if label == "resident" else fed())
    resident_ms, fed_ms = (sum(runs[k]) / 2 for k in ("resident", "fed"))

    with open_stream(seed=4) as stream:
        for _ in range(4):
            compiled(next(stream)["video"])
        busy_ms, busy = profiled_busy(lambda: [compiled(next(stream)["video"])
                                               for _ in range(FEED_PROFILED_BATCHES)])
    report = {"clips_per_s": FEED_BATCH * 1e3 / fed_ms, "ms": fed_ms,
              "resident_clips_per_s": FEED_BATCH * 1e3 / resident_ms,
              "resident_ms": resident_ms, "ratio": resident_ms / fed_ms, "busy": busy,
              "runs_ms": runs, "chain_host_ms": chain_host_ms, "chain_device_ms": chain_ms,
              "logits_err": err,
              "bound": bound, "input_err_vs_cpu_chain": in_err}
    print(f"phase 20 (c): x3d_s deploy bf16 compiled B{FEED_BATCH} fed from the store (val chain "
          f"on the card, in the prefetch's stream): {report['clips_per_s']!r} clips/s "
          f"({fed_ms!r} ms a batch) against {report['resident_clips_per_s']!r} on one resident "
          f"batch ({resident_ms!r} ms; windows of {FEED_BATCHES} in turns {runs}): ratio "
          f"{report['ratio']!r}; busy "
          f"{busy!r} ({FEED_PROFILED_BATCHES} batches, after four); the chain "
          f"{chain_host_ms!r} host ms, "
          f"{chain_ms!r} ms on the card a batch; fed logits vs the CPU chain's max |diff| "
          f"{err!r} (bound {bound!r}; inputs {in_err!r} apart in bf16); on {card}")
    return report


class StoreFeed:
    """A datamodule over a ClipStore: ``train_dataloader(n)`` prefetches n
    batches of ``batch`` uint8 clips to the card (``ClipStore.prefetch``)
    and runs ``transform`` (a per-clip THWC chain) on each clip there, then
    collates the CTHW views: in the prefetch's stream (``in_prefetch``) or
    in the consumer's, after the handover. ``chain_host_ms`` collects the
    host ms of each batch's chain."""

    def __init__(self, store, batch: int, transform, seed: int, in_prefetch: bool):
        self.store, self.batch, self.transform, self.seed = store, batch, transform, seed
        self.in_prefetch = in_prefetch
        self.chain_host_ms = []
        self._epochs = 0

    def transformed(self, batch: dict) -> dict:
        from pytorchvideo_tpu_torch.train.transforms import default_collate
        from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

        t0 = time.perf_counter()
        video = default_collate([thwc_to_cthw(self.transform(v)) for v in batch["video"]])
        self.chain_host_ms.append((time.perf_counter() - t0) * 1e3)
        return {"video": video, "label": batch["label"]}

    def train_dataloader(self, n: int):
        self._epochs += 1
        with self.store.prefetch(self.batch, "cuda", seed=self.seed + self._epochs, epochs=None,
                                 transform=self.transformed if self.in_prefetch else None
                                 ) as stream:
            for _ in range(n):
                batch = next(stream)
                yield batch if self.in_prefetch else self.transformed(batch)


class ResidentFeed:
    """A datamodule that yields one batch ``n`` times."""

    def __init__(self, batch: dict):
        self.batch_dict, self.batch = batch, batch["label"].shape[0]

    def train_dataloader(self, n: int):
        for _ in range(n):
            yield dict(self.batch_dict)


def train_from_store(store, train, card: str) -> dict:
    """Phase 20 (d): MViT-B's recipe at B8 through app.train(), fed from the
    store with the train chain (RandAugment) per clip on the card, in the
    prefetch's stream and, for comparison, in the step's."""
    import torch

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS
    from pytorchvideo_tpu_torch.transforms.transforms_factory import create_video_transform

    app = train_app(train, TRAIN_BATCH, seed=40)
    data = app.cfg.data
    assert data.aug_type == "randaug" and app.cfg.mix.enabled
    transform = create_video_transform(
        "train", num_samples=data.num_samples, video_mean=data.video_mean,
        video_std=data.video_std, min_size=data.min_size, max_size=data.max_size,
        crop_size=data.crop_size, aug_type=data.aug_type, seed=41)
    feeds = {"prefetch stream": StoreFeed(store, TRAIN_BATCH, transform, 42, in_prefetch=True),
             "step's stream": StoreFeed(store, TRAIN_BATCH, transform, 43, in_prefetch=False)}
    app.datamodule = feeds["prefetch stream"]
    losses, *_ = captured_run(app, WARMUP_STEPS + 1, MVIT_PER_STEP, "phase 20 (d) warm-up")

    def steady_ms(label: str) -> float:
        """ms per step through app.train() (each call a new epoch, whose
        prefetch starts empty) by the difference of 2 and 2 +
        FEED_TRAIN_STEPS steps."""
        totals = {}
        for n in (2, 2 + FEED_TRAIN_STEPS):
            history, ms, *_ = captured_run(app, n, MVIT_PER_STEP, f"phase 20 (d) {label}")
            losses.extend(history)
            totals[n] = ms * n
        return (totals[2 + FEED_TRAIN_STEPS] - totals[2]) / FEED_TRAIN_STEPS

    runs = {}
    for label, feed in feeds.items():
        app.datamodule = feed
        feed.chain_host_ms.clear()
        fed_ms = steady_ms(f"fed, the chain in the {label}")
        chain_ms = sorted(feed.chain_host_ms)[len(feed.chain_host_ms) // 2]
        busy_ms, busy = profiled_busy(lambda: run_steps(app, FEED_TRAIN_STEPS))
        runs[label] = {"clips_per_s": TRAIN_BATCH * 1e3 / fed_ms, "ms_per_step": fed_ms,
                       "busy": busy, "chain_host_ms": chain_ms}
    batch = next(iter(feeds["prefetch stream"].train_dataloader(1)))
    assert batch["video"].is_contiguous(memory_format=torch.channels_last_3d)
    app.datamodule = ResidentFeed(batch)
    resident_ms = steady_ms("resident")
    assert all(math.isfinite(h) for h in losses), f"phase 20 (d): non-finite loss {losses}"
    for run in runs.values():
        run["ratio"] = resident_ms / run["ms_per_step"]
    report = {"resident_clips_per_s": TRAIN_BATCH * 1e3 / resident_ms,
              "resident_ms_per_step": resident_ms, "runs": runs, "losses": losses}
    for label, run in runs.items():
        print(f"phase 20 (d): mvit_base_16x4 classification_mvit_16x4 (RandAugment, "
              f"MixUp/CutMix, bf16) B{TRAIN_BATCH} through app.train() fed from the store "
              f"({len(store)} clips {store.clip_shape}), the chain in the {label}: "
              f"{run['clips_per_s']!r} clips/s ({run['ms_per_step']!r} ms a step) against "
              f"{report['resident_clips_per_s']!r} on one resident batch ({resident_ms!r} ms): "
              f"ratio {run['ratio']!r} (steady: the difference of 2 and "
              f"{2 + FEED_TRAIN_STEPS} steps); busy {run['busy']!r} ({FEED_TRAIN_STEPS} steps, "
              f"the prefetch's start included); the chain {run['chain_host_ms']!r} host ms a "
              f"batch (median); on {card}")
    print(f"phase 20 (d): losses finite; launches per update as phase 19 reads them")
    del app
    torch.cuda.empty_cache()
    return report


def default_datamodule(train) -> None:
    """Phase 20 (e): the app without a datamodule builds the config's."""
    import torch

    app = train.VideoClassificationTrainApp(train.get_preset("classification_mvit_16x4"),
                                            model=torch.nn.Linear(1, 1).cuda())
    dm = app.datamodule
    assert isinstance(dm, train.VideoClassificationDataModule) and dm.device.type == "cuda", dm
    assert dm.cfg is app.cfg.data
    print("phase 20 (e): VideoClassificationTrainApp without a datamodule built "
          f"VideoClassificationDataModule on {dm.device} (not iterated: no video decoder here)")


def data_feed_slice(hub, convert_to_deployable_form, train, card: str) -> dict:
    """Phase 20: the data feed, (a) to (e), each part's seconds printed."""
    import tempfile

    import torch

    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        print(f"phase 20 {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    report = {"transforms": transforms_on_card(card)}
    part("(a)")
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase20_", dir=build) as tmp:
        store = make_store(os.path.join(tmp, "serve"), FEED_STORE_CLIPS, FEED_STORE_CLIP, 20)
        part("store of the feed")
        report["feed"] = feed_alone(store, card)
        part("(b)")
        report["serving"] = serve_from_store(store, hub, convert_to_deployable_form, card)
        del store
        torch.cuda.empty_cache()
        part("(c)")
        store = make_store(os.path.join(tmp, "train"), TRAIN_STORE_CLIPS, FEED_CLIP, 21)
        report["training"] = train_from_store(store, train, card)
        del store
        part("(d)")
    default_datamodule(train)
    part("(e)")
    return report


DET_CLIP = (4, 256, 256)
DET_SLOWFAST_CLIP = [(8, 256, 256), (32, 256, 256)]
# (clips, boxes per clip) of each timed request.
DET_REQUESTS = [(1, 1), (1, 8), (1, 32), (8, 8)]
DET_SLOWFAST_REQUESTS = [(1, 8), (8, 8)]
DET_TOL = dict(rtol=5e-3, atol=5e-4)  # card f32 against the CPU, as tests/test_models_parity.py
DET_TIMED = 10
DET_WARMUP = 10
# The prefix of detection_split's record_function ranges.
DET_RANGE = "detection."
ENGINE_VIDEO = (64, 360, 640)
ENGINE_REQUESTS = 20
ENGINE_BOXES = 5
ROI_FEATURES = (8, 2048, 16, 16)  # slow_r50_detection's res5 at B8, 256x256
ROI_BOXES = 64
ROI_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": KERNEL_TOL["bfloat16"]}
# The aten ops a detection request's device time is split by (each one's
# device time includes its callees').
DET_SPLIT_OPS = ("aten::conv3d", "aten::batch_norm", "aten::relu_", "aten::add_",
                 "aten::max_pool3d", "aten::avg_pool3d", "aten::index_select", "aten::bmm",
                 "aten::max_pool2d", "aten::linear", "aten::sigmoid")


def random_boxes(n_per_clip: int, clips_: int, size: int, generator):
    """(N, 5) boxes over ``clips_`` clips of ``size`` pixels (batch index,
    x1, y1, x2, y2), a fifth of each side to either side of the frame."""
    import torch

    rows = []
    for b in range(clips_):
        xy = (torch.rand(n_per_clip, 2, generator=generator) * 1.0 - 0.2) * size
        wh = (torch.rand(n_per_clip, 2, generator=generator) * 0.5 + 0.1) * size
        rows.append(torch.cat([torch.full((n_per_clip, 1), float(b)), xy, xy + wh], dim=1))
    return torch.cat(rows)


def detection_model(hub, name: str, clip, gen):
    """``hub.<name>()`` on the card: the backbone's weights and BN stats as
    ``randomize_`` sets them (stats from a B2 batch of ``clip``), the head's
    projection He-normal with a small bias."""
    import torch

    model = getattr(hub, name)()
    assert all(p.is_cuda for p in model.parameters()), f"{name} built off the card"
    randomize_(model.model, gen, clips(2, clip, gen))
    proj = model.detection_head.proj
    with torch.no_grad():
        proj.weight.copy_(torch.randn(proj.weight.shape, generator=gen)
                          * math.sqrt(2.0 / proj.in_features))
        proj.bias.copy_(torch.randn(proj.bias.shape, generator=gen) * 0.1)
    return model.eval()


def check_detection_on_cpu(label: str, model, cpu_model, x, boxes) -> float:
    """The card's f32 scores against the same model's on the CPU
    (``cpu_model``, a copy): max |err|, within DET_TOL."""
    import torch

    with torch.inference_mode():
        got = model(x, boxes.cuda()).cpu()
        ref = cpu_model([p.cpu() for p in x] if isinstance(x, list) else x.cpu(), boxes)
    assert got.shape == ref.shape == (len(boxes), 80, 1, 1, 1), f"{label}: {got.shape}"
    assert bool(got.isfinite().all()), f"{label}: scores not finite"
    err = (got - ref).abs().max().item()
    print(f"phase 21 {label}: card f32 vs CPU, max |err| {err!r} over {tuple(got.shape)} "
          f"(rtol {DET_TOL['rtol']}, atol {DET_TOL['atol']})")
    torch.testing.assert_close(got, ref, **DET_TOL)
    return err


def serve_detections(name: str, model, requests: dict, card: str) -> dict:
    """The request types of phase 21 for one model (key -> (x, boxes)):
    ``model(x, boxes)`` in f32 under inference mode. Each type's peak memory
    above what was allocated before; then ms (``cuda_time_ms``, after
    DET_WARMUP calls) and host ms a request, timed in turns (in order, then
    in reverse; the faster run of each), so no type pays for being timed
    first; then its busy share (phase 17's)."""
    import torch

    calls = {}
    for key, (x, boxes) in requests.items():
        def request(x=x, boxes=boxes.cuda()):
            with torch.inference_mode():
                return model(x, boxes)

        calls[key] = request
    rows = {}
    for key, request in calls.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = request()
        torch.cuda.synchronize()
        assert bool(out.isfinite().all()), f"{name} {key}: scores not finite"
        rows[key] = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
                     "boxes": len(requests[key][1]), "ms": [], "host_ms": []}
    order = list(calls.items())
    for key, request in order + order[::-1]:
        rows[key]["ms"].append(cuda_time_ms(request, DET_TIMED, DET_WARMUP))
        rows[key]["host_ms"].append(host_ms(request))
    for key, request in calls.items():
        row = rows[key]
        row["ms_turns"], row["host_ms_turns"] = row["ms"], row["host_ms"]
        row["ms"], row["host_ms"] = min(row["ms"]), min(row["host_ms"])
        row["requests_per_s"] = 1000.0 / row["ms"]
        row["busy_ms"], row["busy_share"] = device_busy(request)
        print(f"phase 21 {name} f32 {key}: {row['requests_per_s']!r} requests/s "
              f"({row['ms']!r} ms; turns {row['ms_turns']}), host {row['host_ms']!r} ms a "
              f"request (turns {row['host_ms_turns']}), busy {row['busy_share']!r} "
              f"({row['busy_ms']!r} ms), peak {row['peak_bytes']} bytes; on {card}")
    return rows


def detection_split(model, x, boxes) -> dict:
    """Device ms of one traced request's parts, read inside the model's own
    forward: each part (the backbone, the head, and in it the T pool,
    RoIAlign, the spatial max pool and ``proj``) runs in a
    ``record_function`` range opened and closed by forward hooks, and its
    device ms is the sum of the kernels launched in that range; beside
    them the request's busy ms, its span and the host's gaps (span -
    busy), and its device ms by the aten ops of ``DET_SPLIT_OPS``."""
    import torch
    from torch.autograd import DeviceType

    head = model.detection_head
    parts = {"backbone": model.model, "head": head, "t_pool": head.pool,
             "roi_align": head.roi_layer, "spatial_max_pool": head.pool_spatial,
             "proj": head.proj}
    parts = {part: module for part, module in parts.items() if module is not None}
    handles = []
    for part, module in parts.items():
        ranges = []

        def enter(m, args, name=DET_RANGE + part, ranges=ranges):
            ranges.append(torch.autograd.profiler.record_function(name))
            ranges[-1].__enter__()

        def leave(m, args, out, ranges=ranges):
            ranges.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(enter),
                    module.register_forward_hook(leave)]
    boxes = boxes.cuda()
    try:
        with torch.inference_mode():
            model(x, boxes)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                model(x, boxes)
                torch.cuda.synchronize()
    finally:
        for handle in handles:
            handle.remove()
    busy, span = device_union_ms(prof)
    split = dict.fromkeys(parts, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(DET_RANGE):
            total = getattr(e, "device_time_total", None)
            total = e.cuda_time_total if total is None else total
            split[e.name[len(DET_RANGE):]] += total / 1000.0
    assert all(split[part] > 0 for part in ("backbone", "head", "roi_align")), \
        f"the trace gave a part of the request no device time: {split}"
    by_op = {}
    for e in prof.key_averages():
        if e.key in DET_SPLIT_OPS:
            total = getattr(e, "device_time_total", None)
            total = e.cuda_time_total if total is None else total
            by_op[e.key] = {"calls": e.count, "device_ms": total / 1000.0}
    split.update({"request_busy_ms": busy, "request_span_ms": span,
                  "host_gaps_ms": span - busy, "by_op": by_op})
    return split


def check_roi_align(card: str) -> dict:
    """Phase 21 (d): RoIAlign at slow_r50_detection's B8 res5 shape, as the
    head calls it (7x7, spatial scale 1/16, 2 samples a bin), on the card
    against the same call on the CPU, f32 and bf16, and timed."""
    import torch

    from pytorchvideo_tpu_torch.ops import roi_align

    gen = torch.Generator().manual_seed(214)
    B, C, H, W = ROI_FEATURES
    feats = torch.randn(ROI_FEATURES, generator=gen).contiguous(memory_format=torch.channels_last)
    boxes = random_boxes(ROI_BOXES // B, B, H * 16, gen)
    report = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        f_cpu = feats.to(dtype)
        f_card = f_cpu.cuda()
        b_card = boxes.cuda()
        ref = roi_align(f_cpu, boxes, (7, 7), 1.0 / 16.0)
        got = roi_align(f_card, b_card, (7, 7), 1.0 / 16.0)
        assert got.shape == (ROI_BOXES, C, 7, 7) and got.dtype == dtype
        err = (got.float().cpu() - ref.float()).abs().max().item()
        torch.testing.assert_close(got.cpu(), ref, **ROI_TOL[name])
        call = functools.partial(roi_align, f_card, b_card, (7, 7), 1.0 / 16.0)
        ms = cuda_time_ms(call, 20)
        device_ms, busy = device_busy(call)
        itemsize = f_card.element_size()
        nbytes = (feats.numel() + ROI_BOXES * C * 49) * itemsize + boxes.numel() * 4
        bound, bound_by = bound_ms(0.0, nbytes)
        report[name] = {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "busy_share": busy,
                        "bound_ms": bound, "bound_by": bound_by}
        print(f"phase 21 (d) roi_align {name} {ROI_FEATURES} x {ROI_BOXES} boxes -> 7x7: card "
              f"vs CPU max |err| {err!r}; {ms!r} ms a call, {device_ms!r} ms of it on the "
              f"device (busy {busy!r}; bound {bound!r} ms, {bound_by}: the features read and "
              f"the output written once); on {card}")
    return report


def engine_run(hooks, video, keyframe, requests: int) -> dict:
    """``requests`` runs of a NeuralEngine of ``hooks`` from a status of the
    video and its keyframe: wall ms per request (the card synchronised at
    its end) and per hook (each hook's run timed to a synchronise)."""
    import statistics

    import torch

    from pytorchvideo_tpu_torch.engine import NeuralEngine

    per_hook = {type(h).__name__: [] for h in hooks}
    for hook in hooks:
        run = hook.run

        def timed(status, run=run, name=type(hook).__name__):
            t0 = time.perf_counter()
            out = run(status)
            torch.cuda.synchronize()
            per_hook[name].append((time.perf_counter() - t0) * 1e3)
            return out

        hook.run = timed
    engine = NeuralEngine(hooks)
    request_ms, last = [], None
    for _ in range(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = engine({"video": video, "loaded_image": keyframe})
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
    for hook in hooks:
        del hook.run
    return {"request_ms": statistics.median(request_ms), "request_ms_all": request_ms,
            "hook_ms": {name: statistics.median(ts) for name, ts in per_hook.items()},
            "status": last}


def engine_slice(hub, card: str) -> dict:
    """Phase 21 (c): a NeuralEngine of PeopleDetectionHook (a stub predictor
    of ENGINE_BOXES boxes), ActionDetectionHook (full-width
    slow_r50_detection) and X3DClsHook (full-width x3d_s, captured) over an
    in-memory uint8 video on the host."""
    import torch

    from pytorchvideo_tpu_torch.engine import (
        ActionDetectionHook,
        PeopleDetectionHook,
        X3DClsHook,
    )
    from pytorchvideo_tpu_torch.engine.hook import transform_on
    from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

    gen = torch.Generator().manual_seed(213)
    T, H, W = ENGINE_VIDEO
    video = torch.randint(0, 256, (T, H, W, 3), generator=gen, dtype=torch.uint8)
    keyframe = video[T // 2]
    stub = random_boxes(ENGINE_BOXES, 1, min(H, W), gen)[:, 1:] * torch.tensor(
        [W / min(H, W), H / min(H, W)] * 2)

    det = detection_model(hub, "slow_r50_detection", DET_CLIP, gen)
    action = ActionDetectionHook(state_dict=det.state_dict())
    del det
    x3d = hub.x3d_s(model_num_class=400)
    randomize_(x3d, gen, torch.randn(2, 3, 13, 160, 160, generator=gen).cuda())
    cls_hook = X3DClsHook(state_dict=x3d.state_dict())
    del x3d
    assert all(p.is_cuda for p in action.model.parameters())
    assert all(p.is_cuda for p in cls_hook.model.parameters())
    graph = cls_hook._forward.graph
    eager_calls = []
    handle = cls_hook.model.register_forward_pre_hook(lambda m, a: eager_calls.append(1))
    people = PeopleDetectionHook(predictor=lambda image: stub)
    engine_run([people, action, cls_hook], video, keyframe, 2)  # warm-up
    reset_counts()
    run = engine_run([people, action, cls_hook], video, keyframe, ENGINE_REQUESTS)
    counts = read_counts()
    handle.remove()
    assert not eager_calls and cls_hook._forward.graph is graph, \
        "X3DClsHook ran its model eagerly or captured again"
    assert not any(counts.values()), f"the engine launched a kernel of the port: {counts}"
    status = run.pop("status")
    scores, logits = status["action_scores"], status["action_class"]
    assert scores.shape == (ENGINE_BOXES, 80, 1, 1, 1) and logits.shape == (1, 400)
    assert bool(scores.isfinite().all()) and bool(logits.isfinite().all())

    # One request's outputs against the eager models on the same
    # preprocessed input.
    with torch.inference_mode():
        clip = thwc_to_cthw(cls_hook.transform(video.cuda()))[None]
        eager_logits = cls_hook.model(clip)
        v = action.transform(video.cuda().float())
        sh, sw = v.shape[1:3]
        y0, x0 = (sh - action.crop_size) // 2, (sw - action.crop_size) // 2
        v = v[:, y0:y0 + action.crop_size, x0:x0 + action.crop_size]
        boxes = stub * torch.tensor([sw / W, sh / H] * 2) - torch.tensor(
            [x0, y0, x0, y0], dtype=torch.float32)
        rois = torch.cat([torch.zeros(len(boxes), 1), boxes.clamp(0, action.crop_size)], 1)
        eager_scores = action.model(thwc_to_cthw(v)[None], rois.cuda())
    errs = {"action_scores": (scores - eager_scores).abs().max().item(),
            "action_class": (logits - eager_logits).abs().max().item()}
    torch.testing.assert_close(scores, eager_scores, **DET_TOL)
    torch.testing.assert_close(logits, eager_logits, **DET_TOL)

    # X3DClsHook's time split: its input (the frame pick on the host, the
    # copy to the card, the transform there) and the captured forward's
    # replay, each timed alone.
    x3d_input = functools.partial(transform_on, cls_hook.transform, video, cls_hook.device)

    def replay():
        with torch.inference_mode():
            return cls_hook._forward(clip)

    x3d_split = time_turns({"input": x3d_input, "replay": replay}, DET_TIMED, DET_WARMUP)
    x3d_split["replay_device_ms"], x3d_split["replay_busy_share"] = device_busy(replay)
    assert cls_hook._forward.graph is graph, "X3DClsHook captured again"
    print(f"phase 21 (c) X3DClsHook split, ms a call: {x3d_split}; on {card}")
    print(f"phase 21 (c) engine (people stub {ENGINE_BOXES} boxes -> slow_r50_detection, "
          f"x3d_s captured) over a {T}x{H}x{W} uint8 video on the host, {ENGINE_REQUESTS} "
          f"requests: {run['request_ms']!r} ms a request (median); per hook "
          f"{run['hook_ms']}; outputs vs the eager models max |err| {errs}; X3D replays "
          f"with no new capture; no kernel of the port launched; on {card}")
    run.update({"errs": errs, "counts": counts, "x3d_split": x3d_split})
    del action, cls_hook
    torch.cuda.empty_cache()
    return run


def detection_slice(hub, card: str) -> dict:
    """Phase 21: AVA detection and the engine at full width, (a) to (d)."""
    import copy

    import torch

    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        print(f"phase 21 {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    gen = torch.Generator().manual_seed(21)
    report = {"slow_r50_detection": {}, "slowfast_r50_detection": {}}
    reset_counts()
    for name, clip, requests in (("slow_r50_detection", DET_CLIP, DET_REQUESTS),
                                 ("slowfast_r50_detection", DET_SLOWFAST_CLIP,
                                  DET_SLOWFAST_REQUESTS)):
        model = detection_model(hub, name, clip, gen)
        cpu_model = copy.deepcopy(model).cpu()
        n_params = sum(p.numel() for p in model.parameters())
        x8 = clips(8, clip, gen)
        errs, typed = {}, {}
        for B, n in requests:
            x = [p[:B] for p in x8] if isinstance(x8, list) else x8[:B]
            boxes = random_boxes(n, B, clip[-1] if isinstance(clip[0], int) else clip[0][-1],
                                 gen)
            key = f"B{B} {n} boxes/clip"
            if name == "slow_r50_detection" or (B, n) == requests[0]:
                errs[key] = check_detection_on_cpu(f"{name} {key}", model, cpu_model, x,
                                                   boxes)
            typed[key] = (x, boxes)
        report[name].update(serve_detections(name, model, typed, card))
        del typed
        report[name]["cpu_errs"] = errs
        report[name]["parameters"] = n_params
        if name == "slow_r50_detection":
            x, boxes = x8[:1], random_boxes(8, 1, clip[-1], gen)
            split = detection_split(model, x, boxes)
            report[name]["split_B1_8_boxes"] = split
            print(f"phase 21 (a) slow_r50_detection B1 8 boxes, device ms by part: {split}")
        del model, cpu_model, x8
        torch.cuda.empty_cache()
        part("(a)" if name == "slow_r50_detection" else "(b)")
    counts = read_counts()
    assert not any(counts.values()), f"detection launched a kernel of the port: {counts}"
    report["engine"] = engine_slice(hub, card)
    part("(c)")
    report["roi_align"] = check_roi_align(card)
    part("(d)")
    return report


# Phase 22, self-supervised pretraining, float32 with TF32 off.
SSL_CLIP = (8, 224, 224)  # slow_r50's 8x8 clip
SSL_CHECK_BATCH = 2
SSL_BATCH = 8
SSL_TOL = dict(rtol=5e-3, atol=5e-4)  # card against the CPU, tests/test_models_parity.py
SSL_STEPS = 5  # captured against eager in (c)
SSL_TIMED_STEPS = 3
SSL_MVIT_BATCH = 4
# BYOL's backbone head feeds the predictor's fc1 and BatchNorm, so the
# head's bias gets a gradient that is zero up to rounding; LARS's trust
# ratio (on the 1-D "zero" group, as the JAX chain scales it) turns that
# into a step of lr x its norm in the direction the rounding picks.
BYOL_ROUNDING_BIAS = "blocks.5.proj.bias"
STEP_NORM_REL = 1e-4
F32_SPREAD_FACTOR = 2.0
QUEUE_TOL = dict(rtol=1e-4, atol=1e-5)
BANK = dict(bank_size=1280000, dim=2048, neg_size=4096)
KNN = dict(length=65536, dim=2048, knn_k=200, num_classes=400)


class SyntheticViews:
    """A two-view datamodule of seeded random clips on the card:
    ``train_dataloader(n)`` yields n batches {"video": (B, 2, 3, *clip)},
    the same n on every call."""

    def __init__(self, batch: int, seed: int, clip=SSL_CLIP):
        self.batch, self.seed, self.clip = batch, seed, clip

    def train_dataloader(self, n: int):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(self.seed)
        for _ in range(n):
            yield {"video": torch.randn(self.batch, 2, 3, *self.clip, device="cuda",
                                        generator=gen)}


def ssl_app(train, task: str, batch: int, seed: int, optim, steps: int = SSL_STEPS, **fields):
    """``SSLTrainApp`` of ``task`` on full-width ``slow_r50`` (head dropout 0)
    at 8x224x224 over ``SyntheticViews``, its weights drawn under ``seed``."""
    import torch

    cfg = train.SSLConfig(task=task, optim=optim, max_epochs=1, **fields)
    cfg.model = train.ModelConfig(name="slow_r50", clip_length=SSL_CLIP[0], crop_size=SSL_CLIP[1],
                                  kwargs={"dropout_rate": 0.0})
    torch.manual_seed(seed)
    app = train.SSLTrainApp(cfg, steps_per_epoch=steps, seed=seed,
                            datamodule=SyntheticViews(batch, seed))
    app.setup()
    assert all(p.is_cuda for p in app.task.parameters()), "the app built off the card"
    return app


def lars_reference(p, g, buf, label: str, cfg, lr: float, trust=None):
    """The JAX chain's update of one tensor in float64 (JAX
    optimizer.py:102-122): decayed weights, the trust ratio (1 where either
    norm is 0) unless ``label`` is "bn" (or ``trust`` says otherwise), the
    momentum trace, -lr."""
    import torch

    wd = {"main": cfg.weight_decay, "zero": 0.0, "bn": cfg.bn_weight_decay}[label]
    u = g + wd * p
    if trust is None:
        trust = label != "bn"
    if trust:
        pn, un = torch.linalg.vector_norm(p).item(), torch.linalg.vector_norm(u).item()
        u = u * (1.0 if pn == 0.0 or un == 0.0 else pn / un)
    m = u if buf is None else u + cfg.momentum * buf
    return p - lr * (u + cfg.momentum * m if cfg.nesterov else m)


def lars_check(train, hub, card: str) -> dict:
    """Phase 22 (a): LARS on the card against the JAX chain in float64."""
    import torch

    model = hub.slow_r50(model_num_class=256)
    with torch.no_grad():
        model.get_parameter(BYOL_ROUNDING_BIAS).zero_()  # a tensor whose norm is 0
    cfg = train.get_preset("byol_train_app_conf")["optimizer"]
    optimizer = train.construct_optimizer(model, cfg)
    assert isinstance(optimizer, train.LARS), type(optimizer)
    names = {p: n for n, p in model.named_parameters()}
    labels = {names[p]: g["label"] for g in optimizer.param_groups for p in g["params"]}
    gen = torch.Generator(device="cuda").manual_seed(71)
    lrs = [cfg.lr * (k + 1) / 8 for k in range(LR_CHECK_STEPS)]  # a linear warm-up
    shares, zero_delta = [], 0.0
    for lr in lrs:
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        buffers = {names[p]: s["momentum_buffer"].double() for p, s in optimizer.state.items()}
        grads = {n: torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n]
        train.set_lr(optimizer, lr)
        optimizer.step()
        ref = {n: lars_reference(before[n].double(), grads[n].double(), buffers.get(n),
                                 labels[n], cfg, lr) for n in before}
        shares.append(update_share(model, ref, before))
        for n in (n for n in before if labels[n] == "zero"):
            plain = lars_reference(before[n].double(), grads[n].double(), buffers.get(n), "zero",
                                   cfg, lr, trust=False)
            zero_delta = max(zero_delta, (plain - ref[n]).abs().max().item())
    worst, name = max(shares)
    print(f"phase 22 (a) LARS (byol_train_app_conf: lr {cfg.lr}, wd {cfg.weight_decay}, zero-wd "
          f"1-D) on slow_r50, {len(lrs)} updates at LRs {lrs}: each update against the JAX "
          f"chain in float64, the worst tensor's share of its bound ({LR_CHECK_REL} x its change "
          f"+ one f32 rounding): {[(round(sh, 6), n) for sh, n in shares]}; {BYOL_ROUNDING_BIAS} "
          f"started at norm 0. The 'zero' group with the trust ratio against without it (the "
          f"JAX docstring's reading): max |delta| {zero_delta!r}; on {card}")
    assert worst <= 1.0, f"LARS: an update off the JAX chain by {worst} of its bound in {name}"
    return {"lrs": lrs, "update_shares": [sh for sh, _ in shares], "zero_group_max_delta":
            zero_delta}


def ssl_step_norm_check(label: str, before: dict, after: dict, key: str, scale: float) -> float:
    """|after - before| of ``key`` equals ``scale`` (0 where the gradient was
    exactly 0) within STEP_NORM_REL; returns the step's norm."""
    import torch

    step = torch.linalg.vector_norm((after[key] - before[key]).double()).item()
    assert step == 0.0 or abs(step - scale) <= STEP_NORM_REL * scale, (
        f"{label}: {key} stepped by {step}, expected {scale}")
    return step


def ssl_timings(label: str, captured, eager, B: int, card: str, capture_peak: int) -> dict:
    """The captured step (the app's, captured before) and the eager step
    timed in turns on one batch, as phase 19 times them; the eager step's
    peak memory over one step, the captured one's ``capture_peak`` (its
    warm-up updates and capture: a replay allocates nothing)."""
    import torch

    batch = {"video": next(iter(captured.datamodule.train_dataloader(1)))["video"]}
    mmt = captured._momentum(0, 0)
    fns = {"eager": lambda: eager._train_step(eager.state, batch,
                                               **({} if mmt is None else {"mmt": mmt})),
           "captured": lambda: captured._step(batch, mmt)}
    timings = step_timings(fns, 2 * B, SSL_TIMED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns["eager"]()
    torch.cuda.synchronize()
    timings["eager"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    timings["captured"]["peak_bytes"] = capture_peak
    e, c = timings["eager"], timings["captured"]
    print(f"phase 22 {label} f32 B{B} (two views: {2 * B} clips through the online network) "
          f"eager / captured: {e['clips_per_s']!r} / {c['clips_per_s']!r} clips/s "
          f"({e['ms_per_step']!r} / {c['ms_per_step']!r} ms/step), host {e['host_ms']!r} / "
          f"{c['host_ms']!r} ms/step, busy {e['busy']!r} / {c['busy']!r}, peak "
          f"{e['peak_bytes']} / {c['peak_bytes']} bytes; on {card}")
    return timings


def byol_parts_ms(app, B: int) -> dict:
    """Device ms of a BYOL step's parts at B (``cuda_time_ms``, eager, on the
    app's task): the online network and predictor forward and backward of
    both views, the momentum encoder's two forwards, LARS's update, the EMA."""
    import torch

    from pytorchvideo_tpu_torch.models.byol import l2_normalize

    task, optimizer = app.task, app.state.optimizer
    video = next(iter(app.datamodule.train_dataloader(1)))["video"]
    x1, x2 = video[:, 0], video[:, 1]
    task.train()
    with torch.no_grad():
        t1, t2 = task.forward_backbone_mmt(x1), task.forward_backbone_mmt(x2)

    def online():
        for p in task.parameters():
            p.grad = None
        p1, p2 = task.forward_backbone(x1), task.forward_backbone(x2)
        ((task.sim_loss(p1, t2) + task.sim_loss(p2, t1)) / 2).backward()

    def momentum():
        with torch.no_grad():
            l2_normalize(task.momentum(x1)), l2_normalize(task.momentum(x2))

    online()
    parts = {"online forward and backward": online, "momentum forwards": momentum,
             "LARS update": optimizer.step,
             "EMA": lambda: task.momentum_update(app.state.mmt)}
    return {name: cuda_time_ms(fn, SSL_TIMED_STEPS, warmup=1) for name, fn in parts.items()}


def byol_check(train, card: str) -> dict:
    """Phase 22 (b): BYOL on slow_r50, the card against the CPU at B2, then
    at B8 the app's captured step against the eager one, ``train()`` and the
    timings (:func:`ssl_captured_against_eager`), with the eager step's
    device time by part."""
    import copy

    import torch

    optim = train.get_preset("byol_train_app_conf")["optimizer"]
    fields = dict(feature_dim=256, predictor_inner=4096, mmt=0.996)
    app = ssl_app(train, "byol", SSL_CHECK_BATCH, seed=81, optim=optim, **fields)
    video = next(iter(app.datamodule.train_dataloader(1)))["video"]
    mmt = app._momentum(0, 0)
    before = {k: v.detach().cpu().double() for k, v in app.task.state_dict().items()}
    # One step from the same weights and views, in four forms.
    tasks = {"card f64": copy.deepcopy(app.task).double(),
             "cpu f64": copy.deepcopy(app.task).cpu().double(),
             "cpu f32": copy.deepcopy(app.task).cpu(), "card f32": app.task}
    after, losses = {}, {}
    for form, task in tasks.items():
        p = next(task.parameters())
        state = app.state if task is app.task else train.ssl_train_state(
            task, train.construct_optimizer(task, optim), app.cfg.mmt)
        reset_counts()
        state, metrics = app._train_step(state, {"video": video.to(p.device, p.dtype)}, mmt=mmt)
        if p.is_cuda:
            check_path_counts(f"phase 22 (b) byol slow_r50 {form} step", read_counts(), {}, 1,
                              "steps")
        losses[form] = metrics["loss"].item()
        after[form] = {k: v.detach().cpu() for k, v in task.state_dict().items()}
        del state
    del tasks
    torch.cuda.empty_cache()
    bias = f"online.{BYOL_ROUNDING_BIAS}"
    rounding = {bias, f"momentum.{BYOL_ROUNDING_BIAS}"}
    # (1) The card's step against the CPU's in float64: the port's step,
    # LARS, the EMA and the BN buffers, free of f32 rounding.
    for a, b in (("card f64", "cpu f64"), ("card f32", "cpu f32")):
        assert abs(losses[a] - losses[b]) <= SSL_TOL["atol"] + SSL_TOL["rtol"] * abs(losses[b]), (
            a, b, losses)
    worst = {}
    for key, r in after["cpu f64"].items():
        got = after["card f64"][key]
        assert torch.isfinite(got.double()).all(), key
        if key in rounding:
            continue
        if not r.is_floating_point():
            assert torch.equal(got, r), key
            continue
        torch.testing.assert_close(got, r, **SSL_TOL, msg=lambda m, k=key: f"{k}: {m}")
        tree = key.split(".")[0]
        worst[tree] = max(worst.get(tree, 0.0), (got - r).abs().max().item())
    scale = optim.lr * torch.linalg.vector_norm(before[bias]).item()
    norms = {form: ssl_step_norm_check(f"phase 22 (b) {form}", before, after[form], bias, scale)
             for form in after}
    rounding_delta = (after["card f64"][bias] - after["cpu f64"][bias]).abs().max().item()
    # (2) In float32, as SSL runs: each tensor's update off the float64 one,
    # relative to the update's size, on the card and on the CPU (the
    # momentum tree and the BN buffers included); per tensor, the card's
    # within F32_SPREAD_FACTOR of the CPU's, or of the CPU's median where
    # the CPU's is below it.
    rel = {form: {k: (torch.linalg.vector_norm(after[form][k].double() - r.double())
                      / torch.linalg.vector_norm(r.double() - before[k])).item()
                  for k, r in after["card f64"].items()
                  if r.is_floating_point() and k not in rounding
                  and not torch.equal(r.double(), before[k])}
           for form in ("card f32", "cpu f32")}
    spread = {}
    for form, errs in rel.items():
        for tree in ("online", "momentum", "predictor"):
            vals = sorted(v for k, v in errs.items() if k.split(".")[0] == tree)
            spread.setdefault(form, {})[tree] = {"median": vals[len(vals) // 2],
                                                 "max": vals[-1], "tensors": len(vals)}
    cpu_median = sorted(rel["cpu f32"].values())[len(rel["cpu f32"]) // 2]
    ratios = sorted((rel["card f32"][k] / max(rel["cpu f32"][k], cpu_median), k)
                    for k in rel["card f32"])
    quantiles = {q: ratios[min(len(ratios) - 1, int(q * len(ratios)))][0]
                 for q in (0.5, 0.9, 0.99)}
    worst_ratio, worst_key = ratios[-1]
    print(f"phase 22 (b) byol slow_r50 B{SSL_CHECK_BATCH} two-view step (LARS lr {optim.lr}), "
          f"losses {losses}. float64, card against the CPU: max |diff| by tree {worst} (rtol "
          f"{SSL_TOL['rtol']}, atol {SSL_TOL['atol']}). float32: each tensor's update off the "
          f"float64 one, relative L2, by tree: {spread}; per tensor, the card's over max(the "
          f"CPU's, the CPU's median {cpu_median!r}): quantiles {quantiles}, max {worst_ratio!r} "
          f"({worst_key}), bound {F32_SPREAD_FACTOR} (a random-init BN ResNet amplifies f32 "
          f"rounding, and LARS steps every tensor by lr x its norm). {bias}: its gradient is zero "
          f"up to rounding; LARS stepped it by {norms} (lr x its norm {scale!r}), the f64 runs "
          f"apart by max |diff| {rounding_delta!r}; on {card}")
    assert worst_ratio <= F32_SPREAD_FACTOR, (
        f"phase 22 (b): float32 on the card {worst_ratio} x the CPU's distance from float64 in "
        f"{worst_key}")
    del app, before, after
    torch.cuda.empty_cache()

    report = ssl_captured_against_eager(train, "byol", 82, optim, card, part="(b)",
                                        parts=lambda eager: byol_parts_ms(eager, SSL_BATCH),
                                        **fields)
    report["check"] = {"losses": losses, "f64_max_abs_diff": worst, "f32_update_spread": spread,
                       "f32_card_over_cpu": {"quantiles": quantiles, "max": worst_ratio,
                                             "tensor": worst_key},
                       "rounding_bias_step_norms": norms, "rounding_bias_delta": rounding_delta}
    return report


def worst_share(got: dict, ref: dict) -> tuple:
    """(the worst tensor's max |diff| over its bound in ``tensors_close``,
    its name, its max |diff|), without asserting; integer buffers must be
    equal."""
    import torch

    rel, floor = STEP_GRAD_TOL["bfloat16"]
    module_max = {}
    for n, r in ref.items():
        if r.is_floating_point() and r.numel():
            module_max[_module_of(n)] = max(module_max.get(_module_of(n), 0.0),
                                            r.abs().max().item())
    worst = (0.0, "", 0.0)
    for n, r in ref.items():
        if not r.is_floating_point():
            assert torch.equal(got[n], r), f"{n}: {got[n]} != {r}"
            continue
        err = (got[n].double() - r.double()).abs().max().item() if r.numel() else 0.0
        bound = rel * r.abs().max().item() + floor * module_max[_module_of(n)]
        worst = max(worst, (err / bound, n, err))
    return worst


def sync_state(src, dst) -> None:
    """Copies ``src``'s task state (parameters, buffers, queue) and its
    optimizer's per-parameter state into ``dst`` (an app of the same task
    and optimizer), in place where ``dst`` holds them."""
    dst.task.load_state_dict(src.task.state_dict())
    source, target = src.state.optimizer.state, dst.state.optimizer.state
    for ps, pd in zip(src.task.parameters(), dst.task.parameters()):
        if ps in source:
            target[pd] = {k: v.clone() for k, v in source[ps].items()}


def ssl_captured_against_eager(train, task: str, seed: int, optim, card: str, part: str = "(c)",
                               parts=None, **fields) -> dict:
    """Phase 22 ``part`` for one task: SSL_STEPS updates of the app's captured
    step (its warm-up updates, the capture's replay, replays), each held by
    phase 19's bound against the eager step's update from the same state on
    the same batch; a second eager update from that state gives the eager
    step's own spread (cuDNN's weight gradients and the max pool's backward
    add with atomics, and a random-init BN ResNet amplifies rounding). Then,
    for BYOL and MoCo, a replay at mmt 0 (the momentum encoder must equal the
    online one after it) and MoCo's queue; ``SSLTrainApp.train()`` on a
    fresh app through its capture; that app's captured step and the eager
    one timed, and ``parts(eager app)`` (a dict of device ms) when given."""
    import torch

    from pytorchvideo_tpu_torch.models.byol import l2_normalize
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    apps = {form: ssl_app(train, task, SSL_BATCH, seed, optim, **fields)
            for form in ("captured", "eager", "eager again")}
    app, eager = apps["captured"], apps["eager"]
    batches = [b["video"] for b in app.datamodule.train_dataloader(SSL_STEPS)]
    shares, losses, capture_peak = [], {form: [] for form in apps}, 0
    reset_counts()
    for i, video in enumerate(batches):
        scalars = {} if task == "simclr" else {"mmt": app._momentum(i, 0)}
        for form in ("eager", "eager again"):
            sync_state(app, apps[form])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        app.state, metrics = app._step({"video": video}, scalars.get("mmt"))
        torch.cuda.synchronize()
        capture_peak = max(capture_peak, torch.cuda.max_memory_allocated())
        losses["captured"].append(metrics["loss"].item())
        for form in ("eager", "eager again"):
            e = apps[form]
            e.state, metrics = e._train_step(e.state, {"video": video}, **scalars)
            losses[form].append(metrics["loss"].item())
        ref = eager.task.state_dict()
        shares.append({form: worst_share(apps[form].task.state_dict(), ref)
                       for form in ("captured", "eager again")})
    label = f"phase 22 {part} {task} slow_r50 f32 B{SSL_BATCH} lr {optim.lr}"
    check_path_counts(f"{label} updates", read_counts(), {}, 3 * SSL_STEPS, "steps")
    (step,) = app._captured_steps.values()
    assert step.graph is not None and step.calls == SSL_STEPS
    print(f"{label}: {SSL_STEPS} updates of SSLTrainApp's captured step (2 eager warm-ups, the "
          f"capture, replays), each against the eager update from the same state, and a second "
          f"eager update against the first: losses {losses}; per update, the worst tensor's max "
          f"|diff| over phase 19's bound (share, tensor, max |diff|): {shares}; on {card}")
    report = {"lr": optim.lr, "losses": losses, "worst_share_of_bound": shares}
    for i, row in enumerate(shares):
        share, name, err = row["captured"]
        assert share <= 1.0, (f"{label}: update {i + 1} off eager by {err} in {name}, {share} "
                              f"of its bound")
    del apps["eager again"]
    if task != "simclr":
        model = app.task
        video = next(iter(app.datamodule.train_dataloader(1)))["video"]
        ptr = int(model.queue_ptr) if task == "moco_v2" else None
        if task == "moco_v2":
            assert ptr == SSL_STEPS * SSL_BATCH % model.queue_size
            with torch.no_grad():
                keys = l2_normalize(l2_normalize(model.momentum(video[:, 1])))
        # A replay at mmt 0: the EMA must read the value written before it,
        # leaving the momentum encoder equal to the updated online one.
        app._step({"video": video}, 0.0)
        online = {k: v for k, v in model.online.state_dict().items() if v.is_floating_point()}
        momentum = model.momentum.state_dict()
        assert all(torch.equal(momentum[k], v) for k, v in online.items()), "mmt 0 not read"
        print(f"{label}: a replay at mmt 0 left the momentum encoder equal to the online one "
              f"({len(online)} tensors, BN buffers included)")
        if task == "moco_v2":
            assert int(model.queue_ptr) == (ptr + SSL_BATCH) % model.queue_size
            rows = model.queue[ptr:ptr + SSL_BATCH]
            torch.testing.assert_close(rows, keys, **QUEUE_TOL)
            report["queue_rows_max_abs_diff"] = (rows - keys).abs().max().item()
            print(f"{label}: the queue pointer at {ptr} after {SSL_STEPS} updates, +{SSL_BATCH} "
                  f"at that replay, whose rows match its normalised keys within max |diff| "
                  f"{report['queue_rows_max_abs_diff']!r}")
    # The user's entry point on a fresh app (the one above has taken
    # SSL_STEPS + 1 updates at the recipe's constant LR): train() captures
    # its step after the warm-up updates.
    del app
    torch.cuda.empty_cache()
    app = ssl_app(train, task, SSL_BATCH, seed, optim, steps=WARMUP_STEPS + 1, **fields)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    train_losses = app.train()
    capture_peak = torch.cuda.max_memory_allocated()
    check_path_counts(f"{label} app.train()", read_counts(), {}, len(train_losses), "steps")
    (step,) = app._captured_steps.values()
    assert step.graph is not None and step.calls == WARMUP_STEPS + 1, step.calls
    assert all(map(math.isfinite, train_losses)), train_losses
    report["train_losses"] = train_losses
    report["timings"] = ssl_timings(f"{part} {task} slow_r50", app, eager, SSL_BATCH, card,
                                    capture_peak)
    if parts is not None:
        report["parts_ms"] = parts(eager)
        total = sum(report["parts_ms"].values())
        print(f"{label} eager step's device ms by part: {report['parts_ms']}; shares "
              f"{({k: v / total for k, v in report['parts_ms'].items()})}; on {card}")
    del app, eager, apps
    torch.cuda.empty_cache()
    return report


def ssl_mvit_check(train, hub, card: str) -> dict:
    """Phase 22 (d): SimCLR on mvit_base_16x4 through the port's step maker:
    the kernels' launches over one step, and its gradients against the
    plain-kernel step's."""
    import torch

    from pytorchvideo_tpu_torch.layers import MultilayerPerceptron
    from pytorchvideo_tpu_torch.models import SimCLR

    mvit = hub.mvit_base_16x4(head_num_classes=128)
    randomize_mvit_(mvit, torch.Generator().manual_seed(91))
    task = SimCLR(MultilayerPerceptron([128, 128, 128], final_activation=None), backbone=mvit,
                  temperature=0.1)
    optim = train.get_preset("simclr_train_app_conf")["optimizer"]
    state = train.ssl_train_state(task, train.construct_optimizer(task, optim))
    gen = torch.Generator(device="cuda").manual_seed(92)
    video = torch.randn(SSL_MVIT_BATCH, 2, 3, *MVIT_CLIP, device="cuda", generator=gen)
    x1, x2 = video[:, 0], video[:, 1]
    grads = {}
    for form, context in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
        task.zero_grad(set_to_none=True)
        task.train()
        torch.cuda.manual_seed(11)  # the same head dropout masks in both forms
        reset_counts()
        with context():
            task.loss(x1, x2).backward()
        counts = read_counts()
        if form == "plain":
            assert not any(counts.values()), f"the plain step launched kernels: {counts}"
        grads[form] = {n: p.grad.clone() for n, p in task.named_parameters()}
    err = tensors_close("phase 22 (d) simclr mvit_base_16x4 gradients, kernels against plain",
                        grads["kernels"], grads["plain"])
    share, worst_name, _ = worst_share(grads["kernels"], grads["plain"])
    del grads
    task.zero_grad(set_to_none=True)
    step = train.make_simclr_train_step()
    reset_counts()
    state, metrics = step(state, {"video": video})
    counts = read_counts()
    check_path_counts(f"phase 22 (d) simclr mvit_base_16x4 f32 B{SSL_MVIT_BATCH}, one step of "
                      f"two views", counts, f32_routes(MVIT_PER_STEP), 2, "views")
    loss = metrics["loss"].item()
    assert math.isfinite(loss), loss
    print(f"phase 22 (d) simclr mvit_base_16x4 f32 B{SSL_MVIT_BATCH} (two views, LARS): loss "
          f"{loss!r}; gradients against the plain-kernel step: max |diff| {err!r}, the worst "
          f"tensor ({worst_name}) at {share!r} of phase 9's bf16 bound (rel "
          f"{STEP_GRAD_TOL['bfloat16'][0]} of the tensor's max |g| + {STEP_GRAD_TOL['bfloat16'][1]}"
          f" of its module's); on {card}")
    del task, state, video
    torch.cuda.empty_cache()
    return {"counts": counts, "grad_max_abs_diff": err, "grad_worst_share_of_bound": share,
            "loss": loss}


def memory_bank_check(train, hub, card: str) -> dict:
    """Phase 22 (e): ``MemoryBank`` at its defaults on slow_r50, and
    ``KnnMemory.knn_predict`` timed."""
    import torch

    from pytorchvideo_tpu_torch.models import MemoryBank

    gen = torch.Generator(device="cuda").manual_seed(101)
    bank = MemoryBank(hub.slow_r50(model_num_class=BANK["dim"], dropout_rate=0.0),
                      generator=gen, **BANK)
    optimizer = train.construct_optimizer(bank, train.OptimizerConfig(method="sgd", lr=0.1))
    x = torch.randn(SSL_BATCH, 3, *SSL_CLIP, device="cuda", generator=gen)
    x_ind = torch.randperm(BANK["bank_size"], device="cuda", generator=gen)[:SSL_BATCH]

    def step():
        bank.train()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = bank.loss(x, x_ind, gen)
        loss.backward()
        optimizer.step()
        return loss

    before = bank.memory.clone()
    loss = step().item()
    changed = torch.nonzero((bank.memory != before).any(dim=1)).flatten()
    del before
    assert sorted(changed.tolist()) == sorted(x_ind.tolist()), (changed, x_ind)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(step, SSL_TIMED_STEPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    del bank, optimizer
    torch.cuda.empty_cache()
    knn = train.KnnMemory(**{k: v for k, v in KNN.items()})
    knn_state = knn.init(gen, device="cuda")
    knn_state["labels"].copy_(torch.randint(0, KNN["num_classes"], (KNN["length"],),
                                            device="cuda", generator=gen))
    q = torch.randn(SSL_BATCH, KNN["dim"], device="cuda", generator=gen)
    scores = knn.knn_predict(knn_state, q)
    assert scores.shape == (SSL_BATCH, KNN["num_classes"]) and torch.isfinite(scores).all()
    knn_ms = cuda_time_ms(lambda: knn.knn_predict(knn_state, q), 20)
    print(f"phase 22 (e) MemoryBank {BANK} f32 on slow_r50 B{SSL_BATCH}: loss {loss!r}; the "
          f"{SSL_BATCH} x_ind rows changed and no other; {ms!r} ms a step (SGD), peak "
          f"{peak} bytes; KnnMemory.knn_predict {KNN} at B{SSL_BATCH}: {knn_ms!r} ms; on {card}")
    return {"loss": loss, "ms_per_step": ms, "peak_bytes": peak, "knn_predict_ms": knn_ms}


def ssl_slice(train, hub, card: str) -> dict:
    """Phase 22: self-supervised pretraining, each part's seconds printed."""
    t_part = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"phase 22 {part}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    report = {"lars": lars_check(train, hub, card)}
    lap("(a)")
    report["byol"] = byol_check(train, card)
    lap("(b)")
    report["simclr"] = ssl_captured_against_eager(
        train, "simclr", 83, train.get_preset("simclr_train_app_conf")["optimizer"], card,
        feature_dim=128, temperature=0.1)
    report["moco_v2"] = ssl_captured_against_eager(
        train, "moco_v2", 84, train.get_preset("moco_v2_train_app_conf")["optimizer"], card,
        feature_dim=128, queue_size=65536, temperature=0.07, mmt=0.994)
    lap("(c)")
    report["mvit_simclr"] = ssl_mvit_check(train, hub, card)
    lap("(d)")
    report["memory_bank"] = memory_bank_check(train, hub, card)
    lap("(e)")
    return report


# Phase 23, the deploy extras. X3D-XS's clip; the efficient blocks at X3D-S's
# stage 2 (conv_b's grid and width, the stage's width outside the bottleneck).
X3D_XS_CLIP = (4, 160, 160)
BLOCK_BATCH = 4
BLOCK_GRID = (13, 20, 20)
BLOCK_WIDTH, BLOCK_INNER = 48, 108
# A converted block in f32 against its train form: BN folded in float64,
# then rounded to f32, and the convs summed in another order.
BLOCK_F32_REL_TOL = 1e-4
# (label, factory, args, kwargs, input channels, #1 launches per forward)
BOTTLENECK = ("X3dBottleneckBlock", (BLOCK_WIDTH, BLOCK_INNER, BLOCK_WIDTH))
BLOCK_CASES = [
    ("X3dBottleneckBlock SE stride 1", *BOTTLENECK, dict(act_functions=("swish", "swish", "relu")),
     BLOCK_WIDTH, 1),
    ("X3dBottleneckBlock no SE stride 1", *BOTTLENECK,
     dict(se_ratio=0.0, act_functions=("swish", "swish", "relu")), BLOCK_WIDTH, 1),
    ("X3dBottleneckBlock SE stride 2", *BOTTLENECK, dict(spatial_stride=2), BLOCK_WIDTH, 0),
    ("X3dBottleneckBlock no SE stride 2", *BOTTLENECK, dict(se_ratio=0.0, spatial_stride=2),
     BLOCK_WIDTH, 0),
    *((f"Conv3d3x3x3DwBnAct {act}", "Conv3d3x3x3DwBnAct", (BLOCK_INNER,),
       dict(activation=act), BLOCK_INNER, 1) for act in ("relu", "swish", "hswish", "identity")),
]
# Int8 MViT-B's logits against the bf16 deploy form's, relative to the
# largest (PERF.md section 6: set before the first run on the card).
INT8_REL_TOL = 0.1
INT8_CHECK_BATCH = 8
# Weight-only int8 (dequantized to f32) against the f32 model, relative to
# the largest logit (set with INT8_REL_TOL).
WEIGHT_INT8_REL_TOL = 0.1
# MODEL_ZOO.md's parameter counts (millions, two decimals) and each model's clip.
MODEL_ZOO_PARAMS = {"x3d_s": (3.79, (3, 13, 160, 160)), "x3d_xs": (3.79, (3, 4, 160, 160)),
                    "mvit_base_16x4": (36.61, (3, 16, 224, 224)),
                    "slow_r50": (32.45, (3, 8, 224, 224))}
# utils.time_jitted against cuda_time_ms on one compiled forward.
TIME_JITTED_SHARE = 0.25


def phase17_rows(compiled_report: dict, label: str) -> dict:
    """Phase 17's served rows of ``label`` by batch (empty where phase 17 did
    not run in this process)."""
    return {r["batch"]: r for r in compiled_report.get(label, {}).get("rows", [])}


def efficient_x3d_check(hub, label: str, clip, gen):
    """Phase 23 (a): the efficient X3D's eager deploy form at B8, its 22
    launches and its logits against its train form in f32 (TF32 off), and
    its train mode back on the train form."""
    import torch
    from pytorchvideo_tpu_torch.accelerate import EfficientX3d

    model = getattr(hub, label)()
    assert isinstance(model, EfficientX3d) and all(p.is_cuda for p in model.parameters())
    randomize_(model.model, gen, clips(2, clip, gen))
    model.eval()
    x = clips(8, clip, gen)
    with torch.no_grad():
        ref = model(x).float()
        model.convert()
        reset_counts()
        got = model(x).float()
        check_path_counts(f"{label} convert() B8", read_counts(), X3D_PER_FORWARD, 1)
    check_logits(label, {"bfloat16": got}, ref)
    return model


def efficient_x3d_slice(hub, card: str, compiled_report: dict) -> dict:
    """Phase 23 (a) and (h): ``efficient_x3d_s`` served eager and compiled
    at B1, B8 and B128 (the counts cover the eager forwards exactly),
    ``efficient_x3d_xs`` checked at B8, then ``time_jitted`` and ``trace`` on
    the compiled B8 forward."""
    import tempfile

    import torch
    from pytorchvideo_tpu_torch import utils
    from pytorchvideo_tpu_torch.accelerate import CompiledForward
    from pytorchvideo_tpu_torch.accelerate.deploy import WARMUP_FORWARDS

    gen = torch.Generator().manual_seed(23)
    efficient_x3d_check(hub, "efficient_x3d_xs", X3D_XS_CLIP, gen)
    model = efficient_x3d_check(hub, "efficient_x3d_s", X3D_S_CLIP, gen)
    batches = {B: clips(B, X3D_S_CLIP, gen, torch.bfloat16) for B in BATCHES}
    rates = {}
    reset_counts()
    with torch.no_grad():
        for B, x in batches.items():
            iters = 10 if B < max(BATCHES) else 5
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: model(x), iters, warmup=1)
            rates[B] = {"forwards": iters + 1, "eager_ms": ms,
                        "eager_clips_per_s": B * 1000.0 / ms,
                        "eager_peak_bytes": torch.cuda.max_memory_allocated()}
    counts = read_counts()
    check_path_counts("efficient_x3d_s eager path", counts, X3D_PER_FORWARD,
                      sum(r["forwards"] for r in rates.values()))
    with torch.no_grad():
        for B, x in batches.items():
            reset_counts()
            model.convert(example_input=x)
            assert isinstance(model.deploy_form, CompiledForward)
            check_path_counts(f"efficient_x3d_s B{B} capture", read_counts(), X3D_PER_FORWARD,
                              WARMUP_FORWARDS + 1, unit="forwards (warm-up and capture)")
            reset_counts()
            ms = cuda_time_ms(lambda: model(x), 10 if B < max(BATCHES) else 5, warmup=1)
            assert not any(read_counts().values()), f"efficient_x3d_s B{B}: a replay launched"
            rates[B].update(compiled_ms=ms, compiled_clips_per_s=B * 1000.0 / ms)
            p17 = phase17_rows(compiled_report, "x3d_s").get(B)
            beside = ("phase 17 not run" if p17 is None else
                      f"phase 17 x3d_s deploy {p17['eager']['clips_per_s']!r} / "
                      f"{p17['compiled']['clips_per_s']!r}")
            print(f"efficient_x3d_s B{B} bf16 eager / compiled: {rates[B]['eager_clips_per_s']!r}"
                  f" / {rates[B]['compiled_clips_per_s']!r} clips/s ({rates[B]['eager_ms']!r} / "
                  f"{ms!r} ms/forward); {beside} clips/s; on {card}")
            if B == 8:
                x8, compiled8 = x, model.deploy_form
        # (h) time_jitted on the compiled B8 forward against cuda_time_ms, in turns.
        jitted, events = [], []
        for _ in range(2):
            jitted.append(utils.time_jitted(compiled8, x8, iters=20, trials=3) * 1e3)
            events.append(cuda_time_ms(lambda: compiled8(x8), 20))
        tj, ct = min(jitted), min(events)
        print(f"efficient_x3d_s compiled B8: utils.time_jitted {tj!r} ms, cuda_time_ms {ct!r} ms "
              f"(ratio {tj / ct!r}; bound {TIME_JITTED_SHARE})")
        assert abs(tj - ct) <= TIME_JITTED_SHARE * ct, (
            f"time_jitted {tj} ms against cuda_time_ms {ct} ms")
        # A trace of one eager deploy forward and one replay.
        with tempfile.TemporaryDirectory() as log_dir:
            with utils.trace(log_dir):
                with utils.annotate("efficient_x3d_s B8 eager"):
                    compiled8.module(x8)
                with utils.annotate("efficient_x3d_s B8 replay"):
                    compiled8(x8)
                torch.cuda.synchronize()
            path = os.path.join(log_dir, "trace.json")
            size = os.path.getsize(path)
            with open(path) as f:
                events_in = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events_in if e.get("cat") == "kernel")
        ranges = [e["name"] for e in events_in if str(e.get("name")).startswith("efficient_x3d_s")]
        print(f"utils.trace: {size} bytes, {kernels} device kernel events, ranges "
              f"{sorted(set(ranges))}")
        assert size > 0 and kernels > 0, "the trace holds no device kernel"
    return {"model": model.model, "rates": rates, "counts": counts,
            "time_jitted_ms": tj, "cuda_time_ms": ct}


def efficient_blocks_check() -> dict:
    """Phase 23 (b): each block case converted in f32 and bf16 against its
    train form in eval mode, with its #1 launches."""
    import torch
    from pytorchvideo_tpu_torch import accelerate

    gen = torch.Generator().manual_seed(231)
    errs = {}
    for label, factory, args, kwargs, channels, launches in BLOCK_CASES:
        block = getattr(accelerate, factory)(*args, **kwargs)
        assert all(p.is_cuda for p in block.parameters()), f"{label} built off the card"
        randomize_(block.model, gen, torch.randn(2, channels, *BLOCK_GRID, generator=gen).cuda())
        x = torch.randn(BLOCK_BATCH, channels, *BLOCK_GRID, generator=gen).cuda()
        with torch.no_grad():
            ref = block.eval()(x).float()
            scale = ref.abs().max().item()
            for dtype, rel in ((torch.float32, BLOCK_F32_REL_TOL),
                               (torch.bfloat16, LOGIT_REL_TOL["bfloat16"])):
                block.convert(dtype=dtype)
                reset_counts()
                out = block(x).float()
                expected = {"depthwise3x3x3_bn_swish": launches,
                            "depthwise3x3x3_bn_swish.tiled": launches}
                moved = {k: read_counts()[k] for k in expected}
                assert moved == expected, f"{label} {dtype}: launches {moved}, expected {expected}"
                err = (out - ref).abs().max().item()
                name = str(dtype).split(".")[-1]
                errs[f"{label} {name}"] = err / scale
                assert out.shape == ref.shape and err <= rel * scale, (
                    f"{label} {name}: off the train form by {err} > {rel} x {scale}")
        print(f"efficient block {label} at {(BLOCK_BATCH, channels, *BLOCK_GRID)}: converted vs "
              f"train form max |err| / max |y| f32 {errs[label + ' float32']!r} (bound "
              f"{BLOCK_F32_REL_TOL}), bf16 {errs[label + ' bfloat16']!r} (bound "
              f"{LOGIT_REL_TOL['bfloat16']}); #1 launches {launches} a forward")
    return errs


def transmuter_check(hub, x3d_model) -> dict:
    """Phase 23 (c): ``transmute_model(hub.x3d_s(), "cuda")`` against
    ``convert_to_deployable_form`` of the same weights: equal tensors, equal
    logits on one B8, 22 launches each."""
    import torch
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, transmute_model

    model = hub.x3d_s()
    model.load_state_dict(x3d_model.state_dict(), strict=True)
    model.eval()
    deploy = convert_to_deployable_form(model)
    transmuted = transmute_model(model, "cuda")
    a, b = deploy.state_dict(), transmuted.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a), "weights differ"
    x = clips(8, X3D_S_CLIP, torch.Generator().manual_seed(232), torch.bfloat16)
    out = {}
    with torch.no_grad():
        for name, form in (("convert_to_deployable_form", deploy), ("transmute_model", transmuted)):
            reset_counts()
            out[name] = form(x)
            check_path_counts(f"x3d_s {name} B8", read_counts(), X3D_PER_FORWARD, 1)
    equal = torch.equal(out["convert_to_deployable_form"], out["transmute_model"])
    print(f"transmute_model(x3d_s, 'cuda') vs convert_to_deployable_form, B8: {len(a)} tensors "
          f"equal, logits bit-equal: {equal}")
    assert equal, "the transmuter's logits differ from the deploy form's"
    return {"tensors": len(a), "bit_equal": equal}


def expected_int8_layers(model) -> int:
    """The Linear layers the JAX interceptor quantizes on an MViT, counted
    here from the architecture: in x out >= 16384, and not a head-packed
    attention's q, k or v (JAX's ``_ProjParams``)."""
    import torch.nn as nn

    n = 0
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, nn.Linear) and m.in_features * m.out_features >= 16384:
            n += leaf not in ("q", "k", "v")
    return n


def int8_slice(hub, card: str, compiled_report: dict) -> dict:
    """Phase 23 (d) and (e): int8 MViT-B 16x4 (``int8_serving_fn`` of the
    bf16 deploy form) against the bf16 deploy form, its products checked
    exactly, served eager and compiled; weight-only int8 of MViT-B."""
    import torch
    from pytorchvideo_tpu_torch.accelerate import (
        CompiledForward,
        convert_to_deployable_form,
        int8_serving_fn,
    )
    from pytorchvideo_tpu_torch.accelerate import int8 as int8_module
    from pytorchvideo_tpu_torch.accelerate.deploy import WARMUP_FORWARDS

    gen = torch.Generator().manual_seed(233)
    model = hub.mvit_base_16x4()
    randomize_mvit_(model, gen)
    deploy = convert_to_deployable_form(model)
    int8 = int8_serving_fn(deploy)
    layers = sum(isinstance(m, int8_module.Int8Linear) for m in int8.modules())
    expected = expected_int8_layers(model)
    print(f"int8 mvit_base_16x4: {layers} int8 Linear layers (the JAX rule counts {expected}); "
          f"q, k and v and block 0's 96 x 96 attention proj stay bf16")
    assert layers == expected

    # One B8 forward: every int8 product against the CPU's, exactly.
    x = clips(INT8_CHECK_BATCH, MVIT_CLIP, gen, torch.bfloat16)
    plain = int8_module.int8_matmul
    seen = {"calls": 0, "padded": 0, "macs": 0}

    def checked(x_q, w_q):
        y = plain(x_q, w_q)
        assert y.is_cuda and y.dtype == torch.int32
        (M, K), N = x_q.shape, w_q.shape[0]
        cpu = torch.mm(x_q.cpu().double(), w_q.cpu().double().t())  # |sum| < 2^53: exact
        assert torch.equal(y.cpu().double(), cpu), f"an int8 product ({M}x{K}x{N}) differs"
        seen["calls"] += 1
        seen["padded"] += M < int8_module.INT_MM_MIN_ROWS
        seen["macs"] += M * K * N
        return y

    t0 = time.perf_counter()
    with torch.no_grad():
        ref = deploy(x).float()
        int8_module.int8_matmul = checked
        try:
            reset_counts()
            got = int8(x).float()
            counts = read_counts()
        finally:
            int8_module.int8_matmul = plain
        check_path_counts("int8 mvit_base_16x4 B8", counts, MVIT_PER_FORWARD, 1)
    print(f"int8 mvit_base_16x4 B8: {seen['calls']} torch._int_mm products ({seen['padded']} "
          f"padded to {int8_module.INT_MM_PAD_ROWS} rows, {seen['macs']} MACs) equal to the CPU's "
          f"float64 products of the same int8 operands ({time.perf_counter() - t0:.1f} s)")
    # A block's layers run on the cls token and the grid apart, the head once.
    assert seen["calls"] == 2 * layers - 1, f"{seen['calls']} int8 products for {layers} layers"
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = got.argmax(1) == ref.argmax(1)
    print(f"int8 mvit_base_16x4 vs bf16 deploy, B8: max |diff| / max |logit| {err / scale!r} "
          f"(bound {INT8_REL_TOL}); top-1 agrees on {int(agree.sum())}/{len(agree)} rows, "
          f"{int(agree[decided].sum())}/{int(decided.sum())} decided by 2 x max |diff|")
    assert bool(got.isfinite().all()) and err <= INT8_REL_TOL * scale
    assert bool(agree[decided].all()), "int8 top-1 differs where the margin decides it"

    # Served eager and compiled, beside phase 17's bf16 deploy form.
    rows, first = [], None
    reset_counts()
    for i, B in enumerate(MVIT_BATCHES):
        xb = clips(B, MVIT_CLIP, gen, torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        graph = CompiledForward(int8, xb, pool=None if first is None else first.pool)
        first = first or graph
        torch.cuda.synchronize()
        check_path_counts(f"int8 mvit_base_16x4 B{B} capture", read_counts(), MVIT_PER_FORWARD,
                          WARMUP_FORWARDS + 1, unit="forwards (warm-up and capture)")
        rows.append(serve_compiled("int8 mvit_base_16x4", graph, i, B, MVIT_CLIP, gen,
                                   MVIT_PER_FORWARD, torch.cuda.max_memory_allocated() - base))
        p17 = phase17_rows(compiled_report, "mvit_base_16x4").get(B)
        if p17 is not None:
            print(f"  beside phase 17's bf16 mvit_base_16x4 B{B} eager / compiled: "
                  f"{p17['eager']['clips_per_s']!r} / {p17['compiled']['clips_per_s']!r} clips/s, "
                  f"host {p17['eager']['host_ms']!r} / {p17['compiled']['host_ms']!r} ms, peak "
                  f"{p17['eager']['peak_bytes']} / {p17['compiled']['peak_bytes']} bytes")
            rows[-1]["bf16_phase17"] = {k: p17[k] for k in ("eager", "compiled")}
        del graph
    del first, deploy, int8
    torch.cuda.empty_cache()
    weight_only = weight_int8_check({"mvit_base_16x4": model}, gen)
    del model
    torch.cuda.empty_cache()
    return {"layers": layers, "products": seen, "rel_err_vs_bf16": err / scale, "rows": rows,
            "counts": counts, "weight_only": weight_only}


def weight_int8_check(models: dict, gen) -> dict:
    """Phase 23 (e): ``quantization_error`` of each model's ``state_dict``, and
    its logits with the dequantized weights (f32) against its own."""
    import copy

    import torch
    from pytorchvideo_tpu_torch.accelerate import (
        dequantize_variables,
        quantization_error,
        quantize_variables,
    )

    report = {}
    for name, model in models.items():
        clip = MVIT_CLIP if name.startswith("mvit") else X3D_S_CLIP
        state = model.state_dict()
        quantized = quantize_variables(state)
        n = sum(isinstance(v, dict) for v in quantized.values())
        dequantized = copy.deepcopy(model)
        dequantized.load_state_dict(dequantize_variables(quantized, torch.float32))
        x = clips(2, clip, gen)
        with torch.no_grad():
            ref, got = model(x).float(), dequantized(x).float()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        err = quantization_error(state)
        print(f"quantize_variables {name}: {n} int8 weights, quantization_error {err!r}; "
              f"dequantized f32 logits vs the model's, B2: max |diff| / max |logit| {rel!r} "
              f"(bound {WEIGHT_INT8_REL_TOL})")
        assert rel <= WEIGHT_INT8_REL_TOL
        report[name] = {"int8_weights": n, "quantization_error": err, "rel_logit_err": rel}
        del dequantized
    return report


def complexity_check(hub) -> dict:
    """Phase 23 (f): ``model_complexity`` of four hub models: parameters
    equal to MODEL_ZOO.md's, GFLOPs of one clip printed."""
    import torch
    from pytorchvideo_tpu_torch.utils.flops import model_complexity

    report = {}
    for name, (params_m, shape) in MODEL_ZOO_PARAMS.items():
        t0 = time.perf_counter()
        model = getattr(hub, name)()
        out = model_complexity(model, shape)
        del model
        torch.cuda.empty_cache()
        print(f"model_complexity {name} {shape}: {out['params_m']!r} M parameters (MODEL_ZOO.md "
              f"{params_m}), {out['gflops']!r} GFLOPs a clip (FlopCounterMode, 2 per MAC; "
              f"{time.perf_counter() - t0:.1f} s on the host)")
        assert round(out["params_m"], 2) == params_m, f"{name}: {out['params_m']} M parameters"
        report[name] = out
    return report


# The BatchNorm MViT has no final norm: its residual stream adds up 32
# branches as they come. With randomize_mvit_'s weights as they are it is
# chaotic at full depth (benchmarks_torch/bn_mvit_conditioning.py, on the CPU
# at 4x64x64 clips: a 1e-6 change of the input moves its logits by 115 of
# 244, float64 against float32 by 67); with the last layer of each branch
# scaled down, as randomize_ keeps X3D's norm_c gains in [0.2, 0.4], it is
# not, and its bf16 rounding stays within phase 4's bound.
BN_MVIT_BRANCH_SCALE = 0.1


def randomize_bn_mvit_(model, generator) -> None:
    """``randomize_mvit_``'s weights with each residual branch's last layer
    (``attn.proj``, ``mlp.fc2``) scaled by ``BN_MVIT_BRANCH_SCALE``, BN
    affine away from the identity (gamma in [0.5, 1.5], beta of std 0.1),
    and running stats those of one train-mode forward of seeded clips
    (cumulative over the norm's calls)."""
    import torch
    from torch.nn.modules.batchnorm import _BatchNorm

    randomize_mvit_(model, generator)
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    with torch.no_grad():
        for name, module in model.named_modules():
            if name.endswith(("attn.proj", "mlp.fc2")):
                module.weight.mul_(BN_MVIT_BRANCH_SCALE)
        for bn in norms:
            c, dev = bn.num_features, bn.weight.device
            bn.weight.copy_((0.5 + torch.rand(c, generator=generator)).to(dev))
            bn.bias.copy_((torch.randn(c, generator=generator) * 0.1).to(dev))
            bn.reset_running_stats()
            bn.momentum = None
        model.train()
        model(torch.randn(2, 3, *MVIT_CLIP, generator=generator).cuda())
        model.eval()
        for bn in norms:
            bn.momentum = 0.1


def bn_mvit_check(hub) -> dict:
    """Phase 23 (g): the BatchNorm MViT-B 16x4, ``fuse_bn_mvit`` in f32 and
    its bf16 deploy form against the unfused f32 model on the plain kernels,
    with #4's and #6's launches per forward."""
    import torch
    from torch.nn.modules.batchnorm import _BatchNorm
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form, fuse_bn_mvit

    gen = torch.Generator().manual_seed(234)
    model = hub.mvit_base_16x4(norm="batchnorm")
    randomize_bn_mvit_(model, gen)
    n_bn = sum(isinstance(m, _BatchNorm) for m in model.modules())
    x = torch.randn(MVIT_CHECK_BATCH, 3, *MVIT_CLIP, generator=gen).cuda()
    per_forward = {}
    with torch.no_grad():
        with plain_kernels():
            ref = model(x).float()
        fused = fuse_bn_mvit(model)
        left = sum(isinstance(m, _BatchNorm) for m in fused.modules())
        deploy = convert_to_deployable_form(fused)
        got = {}
        for name, form, xx, counts in (("float32", fused, x, f32_routes(MVIT_PER_FORWARD)),
                                       ("bfloat16", deploy, x.bfloat16(), MVIT_PER_FORWARD)):
            reset_counts()
            got[name] = form(xx).float()
            per_forward[name] = read_counts()
            check_path_counts(f"mvit_base_16x4 batchnorm fuse_bn_mvit {name}", per_forward[name],
                              counts, 1)
        with plain_kernels():
            plain_bf16 = deploy(x.bfloat16()).float()
    print(f"mvit_base_16x4 batchnorm bf16 deploy form on the plain versions vs plain f32: max "
          f"|err| / max |logit| {(plain_bf16 - ref).abs().max().item() / ref.abs().max().item()!r}")
    bf16 = per_forward["bfloat16"]
    print(f"mvit_base_16x4 batchnorm: {n_bn} BatchNorms, {left} left after fuse_bn_mvit (the pool "
          f"norms, which skip the cls token); #4 {bf16['pooled_attention_packed']} and #6 "
          f"{bf16['token_pool_conv']} conv + {bf16['token_pool_max']} max launches a bf16 "
          f"forward, as the LayerNorm model's")
    check_logits("mvit_base_16x4 batchnorm fuse_bn_mvit", got, ref)
    del model, fused, deploy
    torch.cuda.empty_cache()
    return {"batchnorms": n_bn, "left_after_fuse": left, "per_forward": per_forward["bfloat16"]}


def deploy_extras_slice(hub, card: str, compiled_report: dict) -> dict:
    """Phase 23: the deploy extras (see the module docstring)."""
    import torch

    report, t_part = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        print(f"phase 23 {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    x3d = efficient_x3d_slice(hub, card, compiled_report)
    part("(a) and (h)")
    report["efficient_blocks"] = efficient_blocks_check()
    part("(b)")
    report["transmuter"] = transmuter_check(hub, x3d["model"])
    part("(c)")
    report["int8"] = int8_slice(hub, card, compiled_report)
    report["int8"]["weight_only"].update(
        weight_int8_check({"x3d_s": x3d["model"]}, torch.Generator().manual_seed(235)))
    part("(d) and (e)")
    report["complexity"] = complexity_check(hub)
    part("(f)")
    report["bn_mvit"] = bn_mvit_check(hub)
    part("(g)")
    report["efficient_x3d"] = {k: v for k, v in x3d.items() if k != "model"}
    return report


# Phase 24: audio-visual SlowFast, the acoustic ResNet and the masked
# multistream, at full width. No TPU kernel lies on this path.
AV_CLIPS = [(3, 8, 224, 224), (3, 32, 224, 224), (1, 128, 1, 80)]  # (C, T, H, W) a pathway
AV_BATCHES = (1, 8, 32)
AV_CHECK_BATCH = 8
ACOUSTIC_CLIP = AV_CLIPS[2]
ACOUSTIC_BATCH = 32
AV_TRAIN_BATCH = 8
AV_TIMED_STEPS = 4  # captured replays after the three steps
STREAM_BATCH = 32
# (stream, sequence length, width): video features through PositionalEncoding
# and a 2-layer, 8-head encoder; audio through a bidirectional LSTM of 512;
# objects through 4-head attention, max pooling and the learned default.
STREAMS = (("video", 64, 1024), ("audio", 128, 512), ("objects", 16, 256))
STREAM_EMPTY_ROWS = 2  # object rows with no valid entry
STREAM_TOL = (5e-3, 5e-4)  # rtol, and atol as a share of max |y| (the slice rule)
STREAM_PAD = 1e4
STREAM_ITERS = 10


class SyntheticAVClips(SyntheticClips):
    """:class:`SyntheticClips`' ``[slow, fast]`` batches (alpha 4 over 32 x
    224 x 224) with a seeded (B, 1, 128, 1, 80) spectrogram as the third
    pathway: audio-visual SlowFast's input."""

    def __init__(self, batch: int, seed: int):
        super().__init__(batch, seed, clip=AV_CLIPS[1][1:], alpha=4)

    def _batch(self, gen, per_label: int = 1, **extra):
        import torch

        batch = super()._batch(gen, per_label, **extra)
        audio = torch.randn(self.batch, *AV_CLIPS[2], device="cuda", generator=gen)
        return {**batch, "video": [*batch["video"], audio]}


def av_deploy_check(convert_to_deployable_form, label: str, model, clip, B: int, gen) -> dict:
    """The f32 and bf16 deploy forms' logits against the plain f32 eval
    model's at B (``check_logits``: LOGIT_REL_TOL of max |logit|), with no
    kernel launched, and how many BNs the fold took and left."""
    import torch
    from torch.nn.modules.batchnorm import _BatchNorm

    x = clips(B, clip, gen)
    forms = {"float32": (convert_to_deployable_form(model, dtype=None), x),
             "bfloat16": (convert_to_deployable_form(model, dtype=torch.bfloat16),
                          cast(x, torch.bfloat16))}
    with torch.no_grad():
        reset_counts()
        ref = model(x).float()
        got = {name: form(xs).float() for name, (form, xs) in forms.items()}
        check_path_counts(f"{label} logit check", read_counts(), {}, 1 + len(forms))
    check_logits(f"{label} deploy", got, ref)
    norms = sum(isinstance(m, _BatchNorm) for m in model.modules())
    kept = [n for n, m in forms["bfloat16"][0].named_modules() if isinstance(m, _BatchNorm)]
    print(f"{label} deploy: {norms - len(kept)} of {norms} BNs folded, {len(kept)} kept "
          f"(after a ConvReduce3D, in eval mode): {kept}")
    return {"bn_folded": norms - len(kept), "bn_kept": kept,
            "max_abs_err": {name: (got[name] - ref).abs().max().item() for name in got},
            "max_abs_logit": ref.abs().max().item()}


def av_train_check(train, card: str) -> dict:
    """Phase 24 (c): audio-visual SlowFast-R50 through
    ``VideoClassificationTrainApp(model=...)`` on the SlowFast-R50 preset in
    bf16 at B8, three-pathway batches: three steps as ``app.train()`` runs
    them (two eager warm-up updates, then the capture), the first with
    every parameter's gradient checked (``first_step_grads``), then
    ``AV_TIMED_STEPS`` replays timed. Every BN's running stats moved."""
    import torch
    from torch.nn.modules.batchnorm import _BatchNorm

    from pytorchvideo_tpu_torch.models import create_audio_visual_slowfast, init_net_weights
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    label = "av_slowfast_r50"
    model = create_audio_visual_slowfast()
    assert all(p.is_cuda for p in model.parameters()), "the AV model was built off the card"
    init_net_weights(model, generator=torch.Generator(device="cuda").manual_seed(241))
    app = bn_app(train, "classification_slowfast_8x8_r50", SyntheticAVClips(AV_TRAIN_BATCH, 241),
                 model=model, seed=241, **{"trainer.compute_dtype": "bfloat16"})
    norms = {n: m for n, m in model.named_modules() if isinstance(m, _BatchNorm)}
    before = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in norms.items()}
    _, first_peak = first_step_grads(app, label, {})
    losses, _, _, warm_peak = captured_run(app, WARMUP_STEPS, {}, f"{label} warm-up and capture")
    still = [n for n, m in norms.items() if torch.equal(m.running_mean, before[n][0])
             or torch.equal(m.running_var, before[n][1])]
    assert not still, f"{label}: running stats that did not move: {still}"
    history, ms, _, run_peak = captured_run(app, AV_TIMED_STEPS, {}, f"{label} timed")
    losses = losses + history
    bad = [n for n, p in model.named_parameters() if not torch.isfinite(p).all()]
    assert not bad and all(map(math.isfinite, losses)), f"{label}: non-finite {bad} {losses}"
    peak = max(first_peak, warm_peak, run_peak)
    print(f"{label} train bf16 B{AV_TRAIN_BATCH} (slow 8x224x224, fast 32x224x224, audio "
          f"128x80): {AV_TRAIN_BATCH * 1000.0 / ms!r} clips/s ({ms!r} ms/step over "
          f"{AV_TIMED_STEPS} captured replays); peak device memory {peak!r} bytes; all "
          f"{len(norms)} BNs' running stats moved over the first {WARMUP_STEPS + 1} steps; "
          f"losses {losses}; on {card}")
    return {"ms_per_step": ms, "clips_per_s": AV_TRAIN_BATCH * 1000.0 / ms, "peak_bytes": peak,
            "losses": losses, "norms": len(norms)}


def multistream_model(generator):
    """Three masked streams fused by concatenation (``STREAMS``), with
    seeded weights (``randomize_mvit_``'s: linear and LSTM weights normal
    with std 1/sqrt(fan_in), biases and the learned default std 0.02,
    LayerNorm gains in [0.9, 1.1])."""
    import torch

    from pytorchvideo_tpu_torch.layers import PositionalEncoding, make_fusion_layer
    from pytorchvideo_tpu_torch.models import masked_multistream as mm

    (_, video_len, video_dim), (_, _, audio_dim), (_, _, object_dim) = STREAMS
    model = mm.MaskedMultiPathWay(
        [mm.MaskedSequential([PositionalEncoding(video_dim, seq_len=video_len),
                              mm.TransposeTransformerEncoder(video_dim, num_heads=8,
                                                             num_layers=2)]),
         mm.MaskedSequential([mm.LSTM(audio_dim, 512, bidirectional=True)]),
         mm.MaskedSequential([mm.TransposeMultiheadAttention(object_dim, num_heads=4),
                              mm.MaskedTemporalPooling("max"),
                              mm.LearnMaskedDefault(object_dim, generator=generator)])],
        make_fusion_layer("concat", [video_dim, 2 * 512, object_dim]))
    randomize_mvit_(model, generator)
    return model


def multistream_inputs(generator):
    """(x, mask) per stream at STREAM_BATCH, on the card: x normal, masks
    valid prefixes of seeded lengths in [1, L], the objects' first
    STREAM_EMPTY_ROWS rows empty."""
    import torch

    pairs = []
    for name, length, dim in STREAMS:
        x = torch.randn(STREAM_BATCH, length, dim, generator=generator)
        lengths = torch.randint(1, length + 1, (STREAM_BATCH,), generator=generator)
        if name == "objects":
            lengths[:STREAM_EMPTY_ROWS] = 0
        mask = torch.arange(length)[None, :] < lengths[:, None]
        pairs.append((x.cuda(), mask.cuda()))
    return pairs


def multistream_check(card: str) -> dict:
    """Phase 24 (d): the masked multistream at B32 on the card in f32 against
    the port's CPU float64 forward on the same weights (within STREAM_TOL);
    padded tails, from position max(length, 1) on, filled with STREAM_PAD
    leave the output as it was; the empty object rows give the learned
    default; ms a forward."""
    import copy

    import torch

    gen = torch.Generator().manual_seed(244)
    model = multistream_model(gen)
    pairs = multistream_inputs(gen)
    reference = copy.deepcopy(model).cpu().double()
    with torch.no_grad():
        reset_counts()
        out = model(pairs)
        ref = reference([(x.cpu().double(), m.cpu()) for x, m in pairs])
        padded = []
        for x, m in pairs:
            first = m.sum(1).clamp(min=1)[:, None]  # the tail starts at max(length, 1)
            tail = torch.arange(x.shape[1], device=x.device)[None, :] >= first
            padded.append((x.masked_fill(tail[..., None], STREAM_PAD), m))
        out_padded = model(padded)
        ms = cuda_time_ms(lambda: model(pairs), STREAM_ITERS)
        check_path_counts("masked multistream", read_counts(), {}, 4 + STREAM_ITERS)
    rtol, atol_rel = STREAM_TOL
    scale = ref.abs().max().item()
    err = (out.double().cpu() - ref).abs()
    share = (err / (rtol * ref.abs() + atol_rel * scale)).max().item()
    width = sum(2 * 512 if name == "audio" else dim for name, _, dim in STREAMS)
    assert out.shape == (STREAM_BATCH, width) and bool(out.isfinite().all())
    assert share <= 1.0, f"masked multistream: card f32 off the CPU f64 by {err.max().item()}"
    pad_delta = (out_padded - out).abs().max().item()
    assert pad_delta == 0.0, f"masked multistream: padded tails moved the output by {pad_delta}"
    default = model.multipathway_blocks[2].layers[2]._learned_defaults
    empty = out[:STREAM_EMPTY_ROWS, -default.numel():]
    assert torch.equal(empty, default.expand_as(empty)), "the empty rows missed the default"
    print(f"masked multistream B{STREAM_BATCH} f32 (video 64x1024 encoder 2x8 heads, audio "
          f"128x512 bidirectional LSTM 512, objects 16x256 attention 4 heads -> max -> default; "
          f"concat {width}): card vs CPU f64 max |err| {err.max().item()!r} ({share!r} of the "
          f"bound {rtol} x |y| + {atol_rel} x max |y| {scale!r}); padded tails ({STREAM_PAD}) "
          f"max |delta| {pad_delta!r}; the {STREAM_EMPTY_ROWS} empty object rows equal the "
          f"learned default; {ms!r} ms/forward on {card}")
    return {"max_abs_err": err.max().item(), "share_of_bound": share, "pad_max_delta": pad_delta,
            "ms": ms}


def av_slice(convert_to_deployable_form, train, card: str) -> dict:
    """Phase 24: audio-visual SlowFast-R50 and the acoustic ResNet-50 served
    in their bf16 deploy forms (eager and compiled, phase 17's way), the AV
    model's training through the app, and the masked multistream; no
    kernel launches in any of them."""
    import torch

    from pytorchvideo_tpu_torch.models import create_acoustic_resnet, create_audio_visual_slowfast

    report, t_part = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        print(f"phase 24 {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    gen = torch.Generator().manual_seed(240)
    for key, build, clip, batches, check_batch in (
            ("av_slowfast_r50", create_audio_visual_slowfast, AV_CLIPS, AV_BATCHES,
             AV_CHECK_BATCH),
            ("acoustic_resnet50", create_acoustic_resnet, ACOUSTIC_CLIP, (ACOUSTIC_BATCH,),
             ACOUSTIC_BATCH)):
        model = build()
        assert all(p.is_cuda for p in model.parameters()), f"{key} was built off the card"
        randomize_(model, gen, clips(2, clip, gen))
        checks = av_deploy_check(convert_to_deployable_form, key, model, clip, check_batch, gen)
        entry, deploy = serve_compiled_model(convert_to_deployable_form, key, model, clip,
                                             batches, gen, {})
        del model, deploy
        torch.cuda.empty_cache()
        report[key] = {**checks, **entry}
        part("(a)" if key.startswith("av") else "(b)")
    report["av_train"] = av_train_check(train, card)
    torch.cuda.empty_cache()
    part("(c)")
    report["multistream"] = multistream_check(card)
    part("(d)")
    print("phase 24 (e): every part read its kernel counters and found 0 launches (no TPU "
          "kernel lies on this path)")
    return report


# Phase 25, the data-parallel layer on a one-rank NCCL group. (c) runs the
# sequence-parallel body at MViT-B 32x3's first stage: the grid tokens of a
# 16x224x224 clip at patch stride (2, 4, 4) (no cls row), kv pooled by
# stride (1, 8, 8), one head of 96.
DP_MVIT_BATCH = 8
DP_X3D_BATCH = 16
DP_CAPTURED_UPDATES = 2  # replays after the warm-up updates and the capture's
# (b)'s state limit, in shares of phase 9's f32 bound, on the state after
# five updates against the local-BN step's: between the synced step's
# reading (1.30 on an H100) and its control's, the statistics rounded to
# bf16 (18.97), which must exceed it.
DP_X3D_STATE_SHARE = 4.0
SP_SHAPE = (4, 16 * 56 * 56, 16 * 7 * 7, 96, 1)  # B, Lq, Lk, H*c, heads
SP_RANKS = 4
SP_TIMED_ITERS = 3
NTXENT_SHAPE = (256, 128)
SIMCLR_DIMS = [2048, 2048, 128]
SIMCLR_BATCH = 64
# The card's all-gather of one rank is a copy: the grouped losses and
# gradients equal the ungrouped ones up to the order of float sums.
GROUP_TOL = dict(rtol=1e-6, atol=1e-7)


@contextlib.contextmanager
def one_rank_nccl_group():
    """A default NCCL process group of this process alone, on the current
    card, through an in-memory store (no TCP port); destroyed on exit."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


class _RecordedAllReduce:
    """``torch.distributed`` as train/train_loop.py sees it, with each
    ``all_reduce`` call recording whether the current stream was capturing a
    CUDA graph (the step's gradient all-reduce is then a node of the graph,
    replayed without a Python call)."""

    def __init__(self, calls: list):
        self.calls = calls

    def __getattr__(self, name):
        import torch.distributed

        return getattr(torch.distributed, name)

    def all_reduce(self, *args, **kwargs):
        import torch

        self.calls.append(torch.cuda.is_current_stream_capturing())
        return torch.distributed.all_reduce(*args, **kwargs)


@contextlib.contextmanager
def step_all_reduce_calls(calls: list):
    """Records the train step's all-reduce calls (``_RecordedAllReduce``);
    the BatchNorms' statistics all-reduces (parallel/collectives.py) are not
    among them."""
    from pytorchvideo_tpu_torch.train import train_loop

    original = train_loop.dist
    train_loop.dist = _RecordedAllReduce(calls)
    try:
        yield
    finally:
        train_loop.dist = original


def bound_share(got: dict, ref: dict, compute: str) -> float:
    """The largest share of phase 9's per-tensor bound (STEP_GRAD_TOL of
    ``compute``: rel x its max |ref| + floor x its module's) that a
    floating tensor of ``got`` is off ``ref``."""
    rel, floor = STEP_GRAD_TOL[compute]
    module_max = {}
    for n, r in ref.items():
        if r.is_floating_point() and r.numel():
            module_max[_module_of(n)] = max(module_max.get(_module_of(n), 0.0),
                                            r.abs().max().item())
    worst = max((got[n].double() - r.double()).abs().max().item()
                / (rel * r.abs().max().item() + floor * module_max[_module_of(n)])
                for n, r in ref.items() if r.is_floating_point() and r.numel())
    return worst if math.isfinite(worst) else math.inf


def dp_updates(app, batches, per_step, label: str) -> dict:
    """Every batch of ``batches`` through the app's captured step
    (``counted_update``: ``per_step`` launches at each warm-up update and
    at the capture, none at a replay); the losses and the launch reading."""
    losses, calls = [], []
    for i, batch in enumerate(batches):
        metrics, counts = counted_update(app, app._device_batch(batch), per_step,
                                         f"{label} update {i + 1}")
        losses.append(metrics["loss"].item())
        calls.append(counts)
    return {"losses": losses, "reading": capture_reading(calls)}


def dp_against_plain(label: str, make_app, per_step: dict, B: int, card: str,
                     state_of, compute: str = "bfloat16", share: float = 1.0,
                     control=None) -> dict:
    """Phase 25 (a, b) for one model: the app made before the group (no
    mesh) and the app made on the one-rank group (``make_app(model)``), from
    the same weights and batches, each through its captured step for
    ``WARMUP_STEPS`` + 1 + ``DP_CAPTURED_UPDATES`` updates; the all-reduce's
    calls recorded; the losses within LOGIT_REL_TOL of ``compute`` and
    ``state_of(app)`` of both within ``share`` of phase 9's bound for it
    (``tensors_close``); then both steps timed in turns. ``control``: a
    context in which the synced step is wrong by a fault the check must
    see; its app's state must lie outside that bound."""
    import copy

    import torch
    import torch.distributed as dist

    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    plain = make_app(None)
    model = copy.deepcopy(plain.model)
    control_model = copy.deepcopy(model) if control is not None else None
    updates = WARMUP_STEPS + 1 + DP_CAPTURED_UPDATES
    batches = list(plain.datamodule.train_dataloader(updates))
    runs = {"plain": dp_updates(plain, batches, per_step, f"{label} plain")}
    with one_rank_nccl_group() as group:
        dp = make_app(model)
        assert dp.mesh is not None and dp._group() is not None, f"{label}: the app built no mesh"
        synced = [m for m in dp.model.modules() if getattr(m, "process_group", None) is not None]
        calls = []
        with step_all_reduce_calls(calls):
            runs["data_parallel"] = dp_updates(dp, batches, per_step, f"{label} data-parallel")
        # The warm-up updates call it eagerly, the capture records it into
        # the graph, and the replays run it with no Python call.
        assert calls == [False] * WARMUP_STEPS + [True], f"{label}: all_reduce calls {calls}"
        rel = LOGIT_REL_TOL[compute]
        for a, b in zip(runs["data_parallel"]["losses"], runs["plain"]["losses"]):
            assert abs(a - b) <= rel * abs(b), f"{label}: losses {runs}"
        got, ref = state_of(dp), state_of(plain)
        f32_share = bound_share(got, ref, "float32")
        control_share = None
        if control is not None:
            with control():
                wrong = make_app(control_model)
                dp_updates(wrong, batches, per_step, f"{label} control")
            control_share = bound_share(state_of(wrong), ref, compute)
            del wrong
            print(f"{label}: state against the app without a group, in shares of phase 9's "
                  f"{compute} bound: synced {bound_share(got, ref, compute)!r}, the control "
                  f"{control_share!r}, limit {share!r}")
            assert control_share > share, f"{label}: the control passes the check"
        err = tensors_close(f"{label} state after {updates} updates", got, ref, compute, share)
        batch = dp._device_batch(batches[0])
        plain_batch = plain._device_batch(batches[0])
        trace = device_trace(lambda: dp._step(batch))
        nccl = sorted({e.name for e in trace.events() if "nccl" in e.name.lower()})
        timings = step_timings({"plain": lambda: plain._step(plain_batch),
                                "data_parallel": lambda: dp._step(batch)}, B, 2)
        world = dist.get_world_size(group)
        del dp, got, batch, trace  # the graphs go before the communicator
        torch.cuda.synchronize()
    p, d = timings["plain"], timings["data_parallel"]
    print(f"{label} B{B}: {updates} captured-app updates on a {world}-rank NCCL group against "
          f"the app without one: losses {runs['data_parallel']['losses']} / "
          f"{runs['plain']['losses']}; state max |diff| {err!r} (held within {share!r}x phase "
          f"9's {compute} bound; "
          f"{f32_share!r} of its f32 bound at worst); {len(synced)} BatchNorms synced; "
          f"all_reduce calls (capturing?) {calls}; NCCL kernels in a replay's trace {nccl}")
    print(f"{label} B{B} captured plain / data-parallel: {p['ms_per_step']!r} / "
          f"{d['ms_per_step']!r} ms/step (cuda_time_ms), host {p['host_ms']!r} / "
          f"{d['host_ms']!r} ms/step, busy {p['busy']!r} / {d['busy']!r}; on {card}")
    del plain, model, batches, plain_batch, ref
    torch.cuda.empty_cache()
    return {"losses": {k: r["losses"] for k, r in runs.items()}, "max_abs_diff": err,
            "f32_bound_share": f32_share, "control_bound_share": control_share,
            "all_reduce_capturing": calls,
            "nccl_kernels_in_replay": nccl, "synced_batchnorms": len(synced),
            "reading": runs["data_parallel"]["reading"], **timings}


def mvit_dp_case(train, hub, card: str) -> dict:
    """Phase 25 (a): MViT-B 16x4 at B8, bf16, the recipe's MixUp/CutMix."""
    import copy

    weights = mvit_weights(hub, 70, head_dropout_rate=0.0)

    def make_app(model):
        return train_app(train, DP_MVIT_BATCH, 70,
                         model=copy.deepcopy(weights) if model is None else model)

    return dp_against_plain("mvit_base_16x4 (a)", make_app, MVIT_PER_STEP,
                            DP_MVIT_BATCH, card,
                            lambda app: dict(app.model.named_parameters()))


@contextlib.contextmanager
def bf16_synced_statistics():
    """Phase 25 (b)'s control: the synced BatchNorms' statistics rounded to
    bf16 before the all-reduce, a fault the f32 check must see."""
    from pytorchvideo_tpu_torch.layers import norms

    original = norms.all_reduce_with_grad
    norms.all_reduce_with_grad = lambda stats, group: original(stats.bfloat16().float(), group)
    try:
        yield
    finally:
        norms.all_reduce_with_grad = original


def x3d_dp_case(train, card: str) -> dict:
    """Phase 25 (b): X3D-S at B16 in f32, every BatchNorm synced over the
    group, against the local-BN step: losses at the f32 bound, parameters
    and running stats within DP_X3D_STATE_SHARE of phase 9's f32 bound,
    which the control (``bf16_synced_statistics``) must exceed."""
    overrides = {**x3d_s_bench_overrides(), "trainer.compute_dtype": "float32",
                 "model.kwargs": {"dropout_rate": 0.0}}

    def make_app(model):
        return bn_app(train, "classification_x3d_xs",
                      SyntheticClips(DP_X3D_BATCH, seed=71, clip=X3D_S_CLIP), model=model,
                      seed=71, **overrides)

    report = dp_against_plain("x3d_s (b)", make_app, {}, DP_X3D_BATCH, card,
                              lambda app: dict(app.model.state_dict()), "float32",
                              DP_X3D_STATE_SHARE, bf16_synced_statistics)
    assert report["synced_batchnorms"] > 0, "x3d_s (b): no BatchNorm synced"
    return report


def sequence_shards_check(pa, card: str) -> dict:
    """Phase 25 (c): ``sequence_parallel_body`` shard by shard for
    ``SP_RANKS`` simulated ranks at MViT-B 32x3's first-stage shape, kv
    replicated and kv gathered (the shards' concatenation, as the all-gather
    gives it), forward (#4) and backward (#5), f32 and bf16; concatenated
    against one call and the plain version at phase 5's and phase 8's bounds;
    then ``sequence_parallel_attention`` through ``all_gather_with_grad`` on
    the one-rank group; the shards timed against one call."""
    import torch
    import torch.nn.functional as F

    from pytorchvideo_tpu_torch.parallel import (
        sequence_parallel_attention,
        sequence_parallel_body,
        sequence_shard,
    )

    B, Lq, Lk, HC, H = SP_SHAPE
    c = HC // H
    scale = c**-0.5
    gen = torch.Generator(device="cuda").manual_seed(72)
    report = {"errs": {}, "routes": {}, "launches": {}, "launches_by_route": {}}
    total = {"pooled_attention_packed": 0, "pooled_attention_packed_bwd": 0}
    by_route_total = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, g = (torch.randn(B, L, HC, device="cuda", generator=gen).to(dtype)
                      for L in (Lq, Lk, Lk, Lq))
        # The plain versions in f32 (the backward's given the kernel's
        # output and row lse, as phase 8's), and one call of each kernel.
        ref = pa.pooled_attention_packed_torch(q.float(), k.float(), v.float(), H, scale)
        o, lse = pa.pooled_attention_packed_cuda(q, k, v, H, scale, return_lse=True)
        ref_grads = pa.pooled_attention_packed_bwd_torch(*(t.float() for t in (q, k, v, o)), lse,
                                                         g.float(), H, scale)
        del o, lse
        one_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        one = pa.pooled_attention_packed(*one_leaves, H, scale)
        one_grads = torch.autograd.grad(one, one_leaves, g)
        one = one.detach()
        for kv_sharded in (False, True):
            outs, dqs, dkv, routes = [], [], [], []
            shard_err, dkv_bound = (0.0, 0.0), [0.0, 0.0]
            for r in range(SP_RANKS):
                q_r = sequence_shard(q, SP_RANKS, r).requires_grad_()
                g_r = sequence_shard(g, SP_RANKS, r)
                kv = [t.detach().clone().requires_grad_() for t in (k, v)]
                if kv_sharded:  # each rank's kv rows, gathered in rank order
                    k_r, v_r = (torch.cat([sequence_shard(t, SP_RANKS, j)
                                           for j in range(SP_RANKS)], dim=1) for t in kv)
                else:
                    k_r, v_r = kv
                reset_counts()
                out_r = sequence_parallel_body(q_r, k_r, v_r, H, scale)
                grads_r = torch.autograd.grad(out_r, (q_r, *kv), g_r)
                counts = read_counts()
                assert counts["pooled_attention_packed"] == 1, counts
                assert counts["pooled_attention_packed_bwd"] == 1, counts
                fwd_route = [rt for rt, n in by_route(counts, "pooled_attention_packed").items()
                             if n]
                bwd_route = [rt for rt, n in by_route(counts,
                                                      "pooled_attention_packed_bwd").items() if n]
                assert fwd_route == [pa.forward_route(dtype, q_r.shape[1], c,
                                                      pa._aligned(q_r, k_r, v_r))], counts
                routes.append({"forward": fwd_route[0], "backward": bwd_route[0],
                               "q_rows": q_r.shape[1], "q_16_byte_aligned":
                               q_r.data_ptr() % 16 == 0})
                for key in total:
                    total[key] += counts[key]
                for key, n in counts.items():
                    if "." in key and key.split(".")[0] in total:
                        by_route_total[key] = by_route_total.get(key, 0) + n
                # This rank's gradients against the plain backward of its
                # rows (given the kernel's output and lse, as phase 8's).
                o_r, lse_r = pa.pooled_attention_packed_cuda(q_r.detach(), k, v, H, scale,
                                                             return_lse=True)
                ref_r = pa.pooled_attention_packed_bwd_torch(
                    *(t.float() for t in (q_r.detach(), k, v, o_r)), lse_r, g_r.float(), H,
                    scale)
                for got, want in zip(grads_r, ref_r):
                    shard_err = worse(shard_err, close_rel(got, want, **GRAD_TOL[name]))
                # k's and v's gradients are the ranks' partial sums: their
                # bound is the sum of each rank's.
                tol = GRAD_TOL[name]
                for i, want in enumerate(ref_r[1:]):
                    dkv_bound[i] = (dkv_bound[i] + tol["atol_rel"] * want.abs().max()
                                    + tol["rtol"] * want.abs())
                outs.append(out_r.detach())
                dqs.append(grads_r[0])
                dkv.append([t.float() for t in grads_r[1:]])
                del o_r, lse_r, ref_r, grads_r, kv
            out = torch.cat(outs, dim=1)
            torch.testing.assert_close(out.float(), ref, **ATTENTION_TOL[name])
            torch.testing.assert_close(out.float(), one.float(), **ATTENTION_TOL[name])
            dq_err = close_rel(torch.cat(dqs, dim=1), one_grads[0].float(), **GRAD_TOL[name])
            summed = [sum(parts[i] for parts in dkv) for i in range(2)]
            sum_err = 0.0
            for i, (got, want) in enumerate(zip(summed, ref_grads[1:])):
                excess = ((got - want).abs() - dkv_bound[i]).max().item()
                assert excess <= 0.0, f"{name} summed d{'kv'[i]} off its bound by {excess}"
                sum_err = max(sum_err, (got - want).abs().max().item())
            bwd = worse(shard_err, dq_err)
            key = f"{name} kv_sharded={kv_sharded}"
            report["errs"][key] = {
                "forward_vs_plain": (out.float() - ref).abs().max().item(),
                "forward_vs_one_call": (out.float() - one.float()).abs().max().item(),
                "backward_abs_rel": bwd, "summed_dkv_vs_plain": sum_err}
            report["routes"][key] = routes
            print(f"sequence-parallel body B{B} Lq {Lq} ({SP_RANKS} shards of {Lq // SP_RANKS}) "
                  f"Lk {Lk} H*c {HC} {name}, kv_sharded={kv_sharded}: routes {routes}; "
                  f"errors {report['errs'][key]}")
            del outs, dqs, dkv, out, summed
        # Through the collectives on the one-rank group: the all-gather of
        # k and v with grad (its backward a reduce-scatter), then #4 and #5.
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = sequence_parallel_attention(*leaves, H, scale, kv_sharded=True)
        grads = torch.autograd.grad(out, leaves, g)
        torch.testing.assert_close(out.float(), one.float(), **ATTENTION_TOL[name])
        group_err = (0.0, 0.0)
        for a, o in zip(grads, one_grads):
            group_err = worse(group_err, close_rel(a, o.float(), **GRAD_TOL[name]))
        report["errs"][f"{name} through the group"] = group_err
        del leaves, out, grads, ref, ref_grads, one, one_grads, q, k, v, g
        torch.cuda.empty_cache()
    report["launches"] = total
    report["launches_by_route"] = by_route_total

    # Timed in bf16: the four ranks' bodies on their (already cut) shards,
    # one call over all rows, the plain version and the library call.
    q, k, v = (torch.randn(B, L, HC, device="cuda", generator=gen).bfloat16()
               for L in (Lq, Lk, Lk))
    shards = [sequence_shard(q, SP_RANKS, r) for r in range(SP_RANKS)]
    q4, k4, v4 = (t.view(B, -1, H, c).transpose(1, 2) for t in (q, k, v))
    bound, bound_by = bound_ms(4 * B * Lq * Lk * HC, 2 * B * HC * (2 * Lq + 2 * Lk))
    timed = time_turns({
        "ms": lambda: [pa.pooled_attention_packed_cuda(s, k, v, H, scale) for s in shards],
        "one_call_ms": lambda: pa.pooled_attention_packed_cuda(q, k, v, H, scale),
        "plain_ms": lambda: pa.pooled_attention_packed_torch(q, k, v, H, scale),
        "library_ms": lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)},
        iters=SP_TIMED_ITERS)
    report["timing"] = {**timed, "bound_ms": bound, "bound_by": bound_by}
    print(f"sequence-parallel body bf16 B{B} Lq {Lq} Lk {Lk} H*c {HC}: {SP_RANKS} shards "
          f"{timed['ms']!r} ms, one #4 call {timed['one_call_ms']!r} ms, plain "
          f"{timed['plain_ms']!r} ms, SDPA {timed['library_ms']!r} ms, bound {bound!r} ms "
          f"({bound_by}); on {card}")
    del q, k, v, shards, q4, k4, v4
    torch.cuda.empty_cache()
    return report


def ntxent_group_check(train) -> dict:
    """Phase 25 (d): ``ntxent_loss`` and ``SimCLR.loss`` with the one-rank
    group against no group: losses and gradients within GROUP_TOL."""
    import torch

    from pytorchvideo_tpu_torch.layers import MultilayerPerceptron
    from pytorchvideo_tpu_torch.models import SimCLR

    gen = torch.Generator(device="cuda").manual_seed(73)
    z1, z2 = (torch.randn(*NTXENT_SHAPE, device="cuda", generator=gen) for _ in range(2))
    runs = {}
    for form, group in (("alone", None), ("group", torch.distributed.group.WORLD)):
        leaves = [z1.clone().requires_grad_(), z2.clone().requires_grad_()]
        loss = train.ntxent_loss(*leaves, 0.1, group=group)
        runs[form] = (loss.detach(), *torch.autograd.grad(loss, leaves))
    errs = {"ntxent": max((a - b).abs().max().item() for a, b in zip(runs["group"],
                                                                     runs["alone"]))}
    for a, b in zip(runs["group"], runs["alone"]):
        torch.testing.assert_close(a, b, **GROUP_TOL)
    torch.manual_seed(73)
    simclr = SimCLR(MultilayerPerceptron(SIMCLR_DIMS, final_activation=None, device="cuda"),
                    temperature=0.1)
    x1, x2 = (torch.randn(SIMCLR_BATCH, SIMCLR_DIMS[0], device="cuda", generator=gen)
              for _ in range(2))
    grads = {}
    for form, group in (("alone", None), ("group", torch.distributed.group.WORLD)):
        simclr.zero_grad(set_to_none=True)
        loss = simclr.loss(x1, x2, group=group)
        loss.backward()
        grads[form] = {"loss": loss.detach(),
                       **{n: p.grad.clone() for n, p in simclr.named_parameters()}}
    for n, ref in grads["alone"].items():
        torch.testing.assert_close(grads["group"][n], ref, **GROUP_TOL, msg=n)
    errs["simclr"] = max((grads["group"][n] - r).abs().max().item()
                         for n, r in grads["alone"].items())
    print(f"NT-Xent ({NTXENT_SHAPE}) and SimCLR.loss (MLP {SIMCLR_DIMS}, B{SIMCLR_BATCH}) with "
          f"the one-rank group against none: max |diff| of losses and gradients {errs}")
    return errs


def data_parallel_slice(train, hub, pa, card: str) -> dict:
    """Phase 25: (a) MViT-B in the data-parallel app, (b) X3D-S with synced
    BatchNorm, (c) the sequence-parallel body, (d) the grouped NT-Xent; the
    group made and destroyed by each part that needs it; (e) the times,
    printed by each part. Each part's seconds printed."""
    t_part = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"phase 25 {part}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    report = {"mvit": mvit_dp_case(train, hub, card)}
    lap("(a)")
    report["x3d_s"] = x3d_dp_case(train, card)
    lap("(b)")
    with one_rank_nccl_group():
        report["sequence"] = sequence_shards_check(pa, card)
        lap("(c)")
        report["ntxent"] = ntxent_group_check(train)
        lap("(d)")
    return report


# Phase 26, tensor parallelism and FSDP. (a, b) run MViT-B 16x4 on a (1,
# TP_RANKS) (data, model) mesh in TP_RANKS processes that share the card,
# joined by a gloo group over CUDA tensors: NCCL refuses two ranks on one
# device, and the Megatron layers need only all_reduce, which gloo carries
# for CUDA tensors by staging them through the host. Block 0 has one head,
# so a rule replicates its attention ahead of the Megatron rules.
TP_RANKS = 2
TP_BATCH = 8
TP_POOL_FIRST_BATCH = 2
TP_SEED = 80
TP_RULES_HEAD = [(r"blocks\.0\.attn\..*", ())]
TP_TIMED_ITERS = 3
TP_DEADLINE_S = 600
# (d): the dry run's models (__graft_entry__.py:186-229, dropout 0) at the
# batch it gives one device, max(1, 2).
FSDP_BATCH = 2
FSDP_MVIT_BN = dict(spatial_size=32, temporal_size=4, depth=2, num_heads=2, patch_embed_dim=32,
                    norm="batchnorm", pool_q_stride_size=[[1, 1, 2, 2]],
                    pool_kv_stride_adaptive=[1, 2, 2], pool_kvq_kernel=[3, 3, 3],
                    head_num_classes=10, head_dropout_rate=0.0)
FSDP_SLOWFAST = dict(model_num_class=10, stage_depths=(1, 1, 1, 1),
                     head_pool_kernel_sizes=((4, 1, 1), (16, 1, 1)), dropout_rate=0.0)
# The kernels line's tensor_parallel entries: each MViT kernel's wrappers.
TP_WRAPPERS = {
    "pooled_attention_packed": ("pooled_attention_packed",),
    "pooled_attention": ("pooled_attention",),
    "token_pool": ("token_pool_conv", "token_pool_max"),
    "pooled_attention_packed_bwd": ("pooled_attention_packed_bwd",),
    "pooled_attention_bwd": ("pooled_attention_bwd",),
    "token_pool_dw": ("token_pool_dw",),
    "token_pool_dx": ("token_pool_dx",),
    "fused_kvpool_attention": ("fused_kvpool_attention",),
    "fused_kvpool_ln": ("fused_kvpool_attention.tiled",),
    "attention_nopad": ("pooled_attention",),
}


def tp_local_shapes():
    """MViT-B 16x4's kernel shapes at tp = TP_RANKS, every block but block 0
    (replicated) at its local heads: (attention rows (H*c, heads, Lq, Lk,
    blocks), conv pool rows (grid, kernel, stride, launches), fused rows as
    MVIT_FUSED's), and the same blocks' whole-head rows."""
    split = [r for r in MVIT_ATTENTION if r[1] > 1]
    pools = [(grid, kernel, stride, n) for i, (grid, kernel, stride, mode, n)
             in enumerate(MVIT_POOLS) if mode == "conv" and i > 0]
    fused = [r for r in MVIT_FUSED if r[2] > 1]
    local = ([(hc // TP_RANKS, h // TP_RANKS, lq, lk, n) for hc, h, lq, lk, n in split],
             [((*g[:3], g[3] // TP_RANKS), k, s, n) for g, k, s, n in pools],
             [(thw, hc // TP_RANKS, h // TP_RANKS, s, lq, n) for thw, hc, h, s, lq, n in fused])
    return local, (split, pools, fused)


def tp_model(hub, **kwargs):
    """Phase 26's MViT-B 16x4: seeded random weights, no dropout."""
    return mvit_weights(hub, TP_SEED, head_dropout_rate=0.0, **kwargs)


def tp_batch(B: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 1)
    return (torch.randn(B, 3, *MVIT_CLIP, device="cuda", generator=gen),
            torch.arange(B, device="cuda") % 400)


def tp_step(train, model, sharding=None):
    """The step of (b): the dry run's SGD, bf16 compute, the clip at 1.0."""
    import torch

    from pytorchvideo_tpu_torch.train.sharded import SHARDED_STEP_OPTIMIZER

    state = train.create_train_state(model, train.construct_optimizer(
        model, train.OptimizerConfig(**SHARDED_STEP_OPTIMIZER)))
    step = train.make_train_step(clip_grad_norm=1.0, compute_dtype=torch.bfloat16,
                                 sharding=sharding)
    return state, step


def tp_forwards(model, x, fused: bool) -> tuple:
    """(logits by dtype, launches by dtype) of ``model`` at ``x``, f32 and
    bf16 (a bf16 copy), the blocks' ``fused_kvpool`` set to ``fused``."""
    import copy

    import torch

    logits, counts = {}, {}
    for block in model.blocks:
        block.attn.fused_kvpool = fused
    for name in ("float32", "bfloat16"):
        form = model if name == "float32" else copy.deepcopy(model).to(torch.bfloat16)
        with torch.no_grad():
            reset_counts()
            logits[name] = form.eval()(x.to(getattr(torch, name))).float()
            torch.cuda.synchronize()
            counts[name] = read_counts()
        del form
    for block in model.blocks:
        block.attn.fused_kvpool = False
    return logits, counts


def tp_rank_main(rank: int, world: int, directory: str) -> None:
    """One rank of phase 26 (a, b): joins the gloo group through a file store
    in ``directory`` on the card, runs :func:`tp_rank_run` and writes
    ``directory/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pytorchvideo_tpu_torch.ops import _build

    _build.load_library()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store')}",
                            rank=rank, world_size=world)
    try:
        torch.save(tp_rank_run(world), os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_rank_run(world: int) -> dict:
    """Phase 26 (a, b) on this rank: MViT-B on its placements, the forwards
    (f32, bf16, fused) and one step at TP_BATCH, a pool_first forward and
    backward at TP_POOL_FIRST_BATCH, each read from zeroed counters; the
    full state after the step, the region's replicated parameters, and the
    times (e)."""
    import copy

    import torch

    from pytorchvideo_tpu_torch import parallel, train
    from pytorchvideo_tpu_torch.models import hub
    from pytorchvideo_tpu_torch.train import train_loop

    mesh = parallel.make_mesh((1, world), ("data", "model"))
    rules = [*TP_RULES_HEAD, *parallel.MEGATRON_ATTENTION_RULES]
    model = tp_model(hub)
    plan = parallel.shard_model_(model, parallel.infer_param_shardings(model, mesh, rules), mesh)
    x, labels = tp_batch(TP_BATCH)
    out = {"split": sorted(plan.tensor_parallel), "region": {}}
    out["logits"], out["counts"] = tp_forwards(model, x, False)
    fused_logits, fused_counts = tp_forwards(model, x, True)
    out["logits"].update({f"fused {k}": v for k, v in fused_logits.items()})
    out["counts"].update({f"fused {k}": v for k, v in fused_counts.items()})
    bf16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    xb = x.bfloat16()
    with torch.no_grad():
        out["forward_ms"] = cuda_time_ms(lambda: bf16(xb), TP_TIMED_ITERS)
    del bf16, xb
    state, step = tp_step(train, model, plan)
    batch = {"video": x, "label": labels}
    reset_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    out["counts"]["step"] = read_counts()
    out["loss"] = metrics["loss"].item()
    out["state"] = {k: v.cpu() for k, v in plan.full_state_dict(model).items()}
    out["region"] = {n: p.detach().cpu() for n, p in model.named_parameters() if n in plan.region}
    out["step_ms"] = cuda_time_ms(lambda: step(state, batch), TP_TIMED_ITERS, warmup=1)
    del state, step, model, batch
    torch.cuda.empty_cache()

    model = tp_model(hub, pool_first=True).train()
    plan = parallel.shard_model_(model, parallel.infer_param_shardings(model, mesh, rules), mesh)
    x, labels = tp_batch(TP_POOL_FIRST_BATCH)
    reset_counts()
    _, logits = train_loop.forward_backward(model, x, labels, compute_dtype=torch.bfloat16,
                                            sharding=plan)
    torch.cuda.synchronize()
    out["counts"]["pool_first"] = read_counts()
    out["logits"]["pool_first bfloat16"] = logits.float()
    return {k: ({n: t.cpu() for n, t in v.items()} if k == "logits" else v)
            for k, v in out.items()}


def run_tp_ranks(directory: str) -> list:
    """Starts TP_RANKS processes of :func:`tp_rank_main` on the card and
    waits for them, within TP_DEADLINE_S (then they are ended and the phase
    fails); returns each rank's output."""
    import torch
    import torch.multiprocessing as mp

    context = mp.start_processes(tp_rank_main, args=(TP_RANKS, directory), nprocs=TP_RANKS,
                                 join=False, start_method="spawn")
    deadline = time.perf_counter() + TP_DEADLINE_S
    try:
        while not context.join(timeout=5):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"phase 26: the {TP_RANKS} ranks did not end within "
                                   f"{TP_DEADLINE_S} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(TP_RANKS)]


def tp_references(hub, train) -> dict:
    """Phase 26's one-process references: the unsharded f32 and bf16
    forwards, the unsharded step (state and loss), pool_first's f32 forward,
    and the unsharded times (e)."""
    import copy

    import torch

    model = tp_model(hub)
    x, labels = tp_batch(TP_BATCH)
    ref = {}
    ref["logits"], ref["counts"] = tp_forwards(model, x, False)
    bf16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    xb = x.bfloat16()
    with torch.no_grad():
        ref["forward_ms"] = cuda_time_ms(lambda: bf16(xb), TP_TIMED_ITERS)
    del bf16, xb
    state, step = tp_step(train, model)
    batch = {"video": x, "label": labels}
    state, metrics = step(state, batch)
    ref["loss"] = metrics["loss"].item()
    ref["state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ref["step_ms"] = cuda_time_ms(lambda: step(state, batch), TP_TIMED_ITERS, warmup=1)
    del state, step, model, batch
    model = tp_model(hub, pool_first=True)
    x, _ = tp_batch(TP_POOL_FIRST_BATCH)
    with torch.no_grad():
        ref["pool_first_f32"] = model.eval()(x).float()
    del model
    torch.cuda.empty_cache()
    return ref


def tp_path_checks(ranks: list, ref: dict, card: str) -> dict:
    """Phase 26 (a, b, e) from the ranks' outputs against the references."""
    import torch

    first = ranks[0]
    for other in ranks[1:]:
        for name, t in first["logits"].items():
            assert torch.equal(other["logits"][name], t), f"phase 26: ranks' {name} logits differ"
        for n, t in first["region"].items():
            assert torch.equal(other["region"][n], t), f"phase 26 (b): {n} differs across ranks"
    assert first["region"], "phase 26 (b): no region parameter"
    f32_ref = ref["logits"]["float32"].cuda()
    check_logits(f"phase 26 (a) mvit_base_16x4 tp={TP_RANKS}",
                 {k: first["logits"][k].cuda() for k in ("float32", "bfloat16")}, f32_ref)
    check_logits(f"phase 26 (a) mvit_base_16x4(fused_kvpool=True) tp={TP_RANKS}",
                 {k: first["logits"][f"fused {k}"].cuda() for k in ("float32", "bfloat16")},
                 f32_ref)
    check_logits(f"phase 26 (a) mvit_base_16x4(pool_first=True) tp={TP_RANKS}, the training "
                 f"forward", {"bfloat16": first["logits"]["pool_first bfloat16"].cuda()},
                 ref["pool_first_f32"])
    counts = first["counts"]
    check_path_counts("phase 26 (a) tp forward f32", counts["float32"],
                      f32_routes(MVIT_PER_FORWARD), 1)
    check_path_counts("phase 26 (a) tp forward bf16", counts["bfloat16"], MVIT_PER_FORWARD, 1)
    check_path_counts("phase 26 (a) tp fused forward f32", counts["fused float32"],
                      f32_routes(FUSED_PER_FORWARD), 1)
    check_path_counts("phase 26 (a) tp fused forward bf16", counts["fused bfloat16"],
                      FUSED_PER_FORWARD, 1)
    check_path_counts("phase 26 (b) tp step bf16", counts["step"], MVIT_PER_STEP, 1, "steps")
    check_path_counts("phase 26 (b) tp pool_first forward and backward bf16",
                      counts["pool_first"], POOL_FIRST_PER_STEP, 1, "steps")
    rel = LOGIT_REL_TOL["bfloat16"]
    assert abs(first["loss"] - ref["loss"]) <= rel * abs(ref["loss"]), (first["loss"], ref["loss"])
    state_err = tensors_close(f"phase 26 (b) tp={TP_RANKS} state after one step", first["state"],
                              {k: v.cpu() for k, v in ref["state"].items()})
    f32_share = bound_share(first["state"], {k: v.cpu() for k, v in ref["state"].items()},
                            "float32")
    print(f"phase 26 (a, b) mvit_base_16x4 on a (1, {TP_RANKS}) mesh, {len(first['split'])} "
          f"Megatron weights split, block 0's attention replicated: one bf16 B{TP_BATCH} step's "
          f"loss {first['loss']!r} against the unsharded step's {ref['loss']!r}; state max "
          f"|diff| {state_err!r} (phase 9's bf16 bound; {f32_share!r} of its f32 bound); "
          f"{len(first['region'])} region parameters equal on every rank")
    print(f"phase 26 (e) mvit_base_16x4 B{TP_BATCH}: bf16 forward tp={TP_RANKS} (rank 0; the "
          f"{TP_RANKS} ranks share the card, their all-reduces are gloo's, staged through the "
          f"host) {first['forward_ms']!r} ms against one process unsharded {ref['forward_ms']!r} "
          f"ms; the bf16 step {first['step_ms']!r} ms against {ref['step_ms']!r} ms "
          f"(cuda_time_ms); on {card}")
    return {"loss": first["loss"], "unsharded_loss": ref["loss"], "state_max_abs_diff": state_err,
            "state_f32_bound_share": f32_share, "split": len(first["split"]),
            "region_parameters": len(first["region"]), "counts": counts,
            "forward_ms": first["forward_ms"], "unsharded_forward_ms": ref["forward_ms"],
            "step_ms": first["step_ms"], "unsharded_step_ms": ref["step_ms"],
            "collective": "gloo over CUDA tensors, staged through the host; the ranks share one "
                          "card"}


def _count_routes(name: str, route: str, totals: dict) -> None:
    """Asserts every launch of wrapper ``name`` since the last reset took
    ``route``; adds the counts to ``totals``."""
    counts = read_counts()
    assert counts[name] > 0 and by_route(counts, name)[route] == counts[name], (name, counts)
    for key, n in counts.items():
        if key == name or key.startswith(name + "."):
            totals[key] = totals.get(key, 0) + n


def check_tp_local_kernels(pa, tp, fk) -> dict:
    """Phase 26 (c): #2/#3 (per-head, pool_first's layout, cls row included),
    #4/#5 (head-packed, grid and cls queries), #6, #7's dx and dw and #8's
    pool-LN at the tp = TP_RANKS local shapes of MViT-B 16x4, f32 and bf16 at
    B2, against their plain versions (phases 5, 8 and 11's bounds), each
    call on the route its shape gives; then the forward kernels at B32 and
    the backward ones at B8, bf16, at the local shapes against the same
    blocks' whole-head shapes, in turns."""
    import torch

    (attention, pools, fused), (whole_attention, whole_pools, whole_fused) = tp_local_shapes()
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 2)
    errs, totals = {}, {}

    def note(key, err):
        errs[key] = worse(errs.get(key, (0.0, 0.0)), err if isinstance(err, tuple) else (err, 0.0))

    for HC, H, Lq, Lk, _ in attention:
        c = HC // H
        scale = c**-0.5
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for lq in (Lq, 1):
                q, k, v, g = (torch.randn(2, L, HC, device="cuda", generator=gen).to(dtype)
                              for L in (lq, Lk, Lk, lq))
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                reset_counts()
                out = pa.pooled_attention_packed(*leaves, H, scale)
                grads = torch.autograd.grad(out, leaves, g)
                torch.cuda.synchronize()
                _count_routes("pooled_attention_packed", pa.forward_route(dtype, lq, c), totals)
                _count_routes("pooled_attention_packed_bwd", pa.backward_route(dtype, lq, c),
                              totals)
                ref = pa.pooled_attention_packed_torch(q.float(), k.float(), v.float(), H, scale)
                torch.testing.assert_close(out.float(), ref, **ATTENTION_TOL[name])
                note("pooled_attention_packed", (out.float() - ref).abs().max().item())
                o, lse = pa.pooled_attention_packed_cuda(q, k, v, H, scale, return_lse=True)
                ref_g = pa.pooled_attention_packed_bwd_torch(
                    *(t.float() for t in (q, k, v, o)), lse, g.float(), H, scale)
                note("pooled_attention_packed_bwd", worse(*(
                    close_rel(a, b, **GRAD_TOL[name]) for a, b in zip(grads, ref_g))))
            # pool_first's per-head layout, the cls row riding with the grid.
            qh, gh = (torch.randn(2, H, Lq + 1, c, device="cuda", generator=gen).to(dtype)
                      for _ in range(2))
            kh, vh = (torch.randn(2, H, Lk, c, device="cuda", generator=gen).to(dtype)
                      for _ in range(2))
            leaves = [t.clone().requires_grad_() for t in (qh, kh, vh)]
            reset_counts()
            out = pa.pooled_attention(*leaves, scale)
            grads = torch.autograd.grad(out, leaves, gh)
            torch.cuda.synchronize()
            _count_routes("pooled_attention", pa.forward_route(dtype, Lq + 1, c), totals)
            _count_routes("pooled_attention_bwd", pa.backward_route(dtype, Lq + 1, c), totals)
            ref = pa.pooled_attention_torch(*(t.float() for t in (qh, kh, vh)), scale)
            torch.testing.assert_close(out.float(), ref, **ATTENTION_TOL[name])
            note("pooled_attention", (out.float() - ref).abs().max().item())
            o, lse = pa.pooled_attention_cuda(qh, kh, vh, scale, return_lse=True)
            ref_g = pa.pooled_attention_bwd_torch(*(t.float() for t in (qh, kh, vh, o)), lse,
                                                  gh.float(), scale)
            note("pooled_attention_bwd", worse(*(
                close_rel(a, b, **GRAD_TOL[name]) for a, b in zip(grads, ref_g))))
    for grid, kernel, stride, _ in pools:
        out_grid = tuple(tp.pool_out_size(d, k, s) for d, k, s in zip(grid[:3], kernel, stride))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(2, *grid, device="cuda", generator=gen).to(dtype)
            g = torch.randn(2, *out_grid, grid[-1], device="cuda", generator=gen).to(dtype)
            w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).to(dtype)
            reset_counts()
            out = tp.depthwise_token_pool(x, w, stride)
            _count_routes("token_pool_conv", "tiled", totals)
            ref = tp.depthwise_token_pool_torch(x.float(), w.float(), stride)
            torch.testing.assert_close(out.float(), ref, **KERNEL_TOL[name])
            note("token_pool", (out.float() - ref).abs().max().item())
            reset_counts()
            dx = tp.depthwise_token_pool_dx_cuda(g, w, x.shape, stride)
            _count_routes("token_pool_dx", "tiled", totals)
            reset_counts()
            dw = tp.depthwise_token_pool_dw_cuda(x, g, w, stride)
            _count_routes("token_pool_dw", "tiled", totals)
            note("token_pool_dx", close_rel(dx, tp.depthwise_token_pool_dx_torch(
                g.float(), w.float(), x.shape, stride), **GRAD_TOL[name]))
            note("token_pool_dw", close_rel(dw, tp.depthwise_token_pool_dw_torch(
                x.float(), g.float(), w.float(), stride), **GRAD_TOL[name]))
    for thw, HC, heads, stride, Lq, _ in fused:
        assert fk.fusable(thw, HC, (3, 3, 3), stride, HC // heads), f"{thw} {HC} not fusable"
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            t = fused_inputs(gen, 2, thw, HC, heads, Lq, dtype)
            reset_counts()
            outs = fused_call(fk.fused_kvpool_attention_cuda, t, thw, heads, stride, False)
            torch.cuda.synchronize()
            _count_routes("fused_kvpool_attention", "tiled", totals)
            ref = fused_call(fk.fused_kvpool_attention_torch, {k: v.float() for k, v in t.items()},
                             thw, heads, stride, False)
            for got, want in zip(outs[1:3], ref[1:3]):
                torch.testing.assert_close(got.float(), want, **KERNEL_TOL[name])
                note("fused_kvpool_ln", (got.float() - want).abs().max().item())
            if dtype == torch.float32:
                for got, want in zip(outs[::3], ref[::3]):
                    torch.testing.assert_close(got, want, **ATTENTION_TOL[name])
                    note("fused_kvpool_attention", (got - want).abs().max().item())
    print(f"phase 26 (c) kernels at the tp={TP_RANKS} local shapes of mvit_base_16x4 (blocks "
          f"1-15 at half their heads; f32 and bf16, B2) against their plain versions: errors "
          f"(max |err|, over max |ref|) {errs}; launches by route {totals}")
    timing = tp_local_times(pa, tp, fk, gen, (attention, pools, fused),
                            (whole_attention, whole_pools, whole_fused))
    torch.cuda.empty_cache()
    return {"errs": errs, "launches": totals, "timing": timing,
            "local_attention": attention, "local_pools": pools, "local_fused": fused}


def tp_local_times(pa, tp, fk, gen, local, whole) -> dict:
    """Phase 26 (e): each kernel's time per forward (B32) or per step (B8),
    bf16, over blocks 1-15 at the local shapes against the same blocks at
    whole heads, in turns (``cuda_time_ms``)."""
    import torch

    sums = {}

    def add(key, calls, fns):
        ms = time_turns(fns, iters=TP_TIMED_ITERS)
        for form, t in ms.items():
            sums.setdefault(key, {"local_ms": 0.0, "whole_ms": 0.0})[f"{form}_ms"] += calls * t

    B, Bs = MVIT_TIMING_BATCH, TRAIN_BATCH

    def attention_inputs(HC, Lq, Lk, batch):
        return [torch.randn(batch, L, HC, device="cuda", generator=gen).bfloat16()
                for L in (Lq, Lk, Lk, Lq)]

    for (lhc, lh, lq, lk, n), (hc, h, _, _, _) in zip(local[0], whole[0]):
        for q_len in (lq, 1):
            loc, who = attention_inputs(lhc, q_len, lk, B), attention_inputs(hc, q_len, lk, B)
            add("pooled_attention_packed", n, {
                "local": lambda: pa.pooled_attention_packed_cuda(*loc[:3], lh, 96**-0.5),
                "whole": lambda: pa.pooled_attention_packed_cuda(*who[:3], h, 96**-0.5)})
            del loc, who
            loc, who = attention_inputs(lhc, q_len, lk, Bs), attention_inputs(hc, q_len, lk, Bs)
            lo = pa.pooled_attention_packed_cuda(*loc[:3], lh, 96**-0.5, return_lse=True)
            wo = pa.pooled_attention_packed_cuda(*who[:3], h, 96**-0.5, return_lse=True)
            add("pooled_attention_packed_bwd", n, {
                "local": lambda: pa.pooled_attention_packed_bwd_cuda(*loc[:3], *lo, loc[3], lh,
                                                                     96**-0.5),
                "whole": lambda: pa.pooled_attention_packed_bwd_cuda(*who[:3], *wo, who[3], h,
                                                                     96**-0.5)})
            del loc, who, lo, wo
    for (lgrid, kernel, stride, n), (grid, _, _, _) in zip(local[1], whole[1]):
        out_l = tuple(tp.pool_out_size(d, k, s) for d, k, s in zip(grid[:3], kernel, stride))
        w = (torch.randn(HEAD_DIM, 1, *kernel, device="cuda", generator=gen) * 0.2).bfloat16()
        xs = {f: torch.randn(B, *gr, device="cuda", generator=gen).bfloat16()
              for f, gr in (("local", lgrid), ("whole", grid))}
        add("token_pool", n, {f: functools.partial(tp.depthwise_token_pool_cuda, xs[f], w,
                                                   stride) for f in xs})
        xs = {f: (torch.randn(Bs, *gr, device="cuda", generator=gen).bfloat16(),
                  torch.randn(Bs, *out_l, gr[-1], device="cuda", generator=gen).bfloat16())
              for f, gr in (("local", lgrid), ("whole", grid))}
        add("token_pool_dx", n, {f: functools.partial(tp.depthwise_token_pool_dx_cuda, xg[1], w,
                                                      xg[0].shape, stride)
                                 for f, xg in xs.items()})
        add("token_pool_dw", n, {f: functools.partial(tp.depthwise_token_pool_dw_cuda, xg[0],
                                                      xg[1], w, stride) for f, xg in xs.items()})
        del xs
    for (thw, lhc, lh, stride, lq, n), (_, hc, h, _, _, _) in zip(local[2], whole[2]):
        ts = {f: fused_inputs(gen, B, thw, c, hh, lq, torch.bfloat16)
              for f, c, hh in (("local", lhc, lh), ("whole", hc, h))}
        pooled = tuple(fk.pool_out(d, 3, st, 1) for d, st in zip(thw, stride))
        add("fused_kvpool_ln", n, {
            f: functools.partial(fk._pool_ln_cuda, t["k_grid"], t["v_grid"], t["wk"], t["wv"],
                                 t["lnk"], t["lnv"], t["cls_k"], t["cls_v"], thw,
                                 hh, (3, 3, 3), stride, FUSED_EPS, pooled, None)
            for (f, t), hh in zip(ts.items(), (lh, h))})
        del ts
    print(f"phase 26 (e) kernels over blocks 1-15, bf16, ms per B{B} forward (#4, #6, #8's "
          f"pool-LN) or per B{Bs} step (#5, #7) at the tp={TP_RANKS} local shapes against whole "
          f"heads: {sums}")
    return sums


def fsdp_one_rank_check(train, card: str) -> dict:
    """Phase 26 (d): ``run_sharded_step`` on a one-rank NCCL group (a (1, 1)
    mesh: FSDP over ``data`` on the card, each shard the whole parameter),
    on the dry run's BatchNorm MViT-tiny (MixUp) and SlowFast-tiny in f32
    at FSDP_BATCH, against the unsharded step from the same weights: the
    placements, each shard's and its momentum's numel, the loss within the
    f32 logit bound and the state within DP_X3D_STATE_SHARE of phase 9's f32
    bound (the synced BatchNorm's statistics, phase 25 (b)'s)."""
    import copy

    import torch
    from torch.distributed.tensor import Shard

    from pytorchvideo_tpu_torch import parallel
    from pytorchvideo_tpu_torch.models import create_multiscale_vision_transformers
    from pytorchvideo_tpu_torch.models.slowfast import create_slowfast
    from pytorchvideo_tpu_torch.train.sharded import SHARDED_STEP_OPTIMIZER
    from pytorchvideo_tpu_torch.transforms.mix import MixUp

    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 3)
    labels = torch.arange(FSDP_BATCH, device="cuda") % 10
    cases = {
        "mvit_bn": (lambda: create_multiscale_vision_transformers(**FSDP_MVIT_BN),
                    torch.randn(FSDP_BATCH, 3, 4, 32, 32, device="cuda", generator=gen),
                    MixUp(alpha=1.0, label_smoothing=0.1, num_classes=10)),
        "slowfast": (lambda: create_slowfast(**FSDP_SLOWFAST),
                     [torch.randn(FSDP_BATCH, 3, t, 32, 32, device="cuda", generator=gen)
                      for t in (4, 16)], None),
    }
    report = {}
    with one_rank_nccl_group():
        mesh = parallel.make_mesh((-1, 1), ("data", "model"))
        for name, (build, video, mix) in cases.items():
            torch.manual_seed(TP_SEED)
            model = build()
            plain = copy.deepcopy(model)
            result = train.run_sharded_step(model, video, labels, mix, mesh=mesh)
            state = train.create_train_state(plain, train.construct_optimizer(
                plain, train.OptimizerConfig(**SHARDED_STEP_OPTIMIZER)))
            step = train.make_train_step(batch_transform=mix, clip_grad_norm=1.0)
            torch.manual_seed(TP_SEED)
            state, metrics = step(state, {"video": video, "label": labels},
                                  torch.Generator().manual_seed(0))
            loss = metrics["loss"].item()
            assert abs(result.loss - loss) <= LOGIT_REL_TOL["float32"] * abs(loss), (
                name, result.loss, loss)
            shards = result.plan.fsdp
            assert shards, f"phase 26 (d) {name}: no FSDP shard"
            for n, p in model.named_parameters():
                momentum = result.state.optimizer.state[p]["momentum_buffer"]
                assert p.numel() == momentum.numel() == result.plan.full_shapes.get(
                    n, p.shape).numel(), n
                if n in shards:
                    assert isinstance(result.plan.placements[n][0], Shard), n
            err = tensors_close(f"phase 26 (d) {name} state", result.plan.full_state_dict(model),
                                dict(plain.state_dict()), "float32", DP_X3D_STATE_SHARE)
            report[name] = {"loss": result.loss, "unsharded_loss": loss,
                            "fsdp_shards": len(shards), "state_max_abs_diff": err,
                            "parameters": sum(1 for _ in model.parameters())}
            print(f"phase 26 (d) run_sharded_step {name} f32 B{FSDP_BATCH} on a one-rank NCCL "
                  f"(1, 1) mesh: {len(shards)} parameters FSDP-sharded over data (each shard "
                  f"and its momentum the whole numel / 1), loss {result.loss!r} against the "
                  f"unsharded step's {loss!r}, state max |diff| {err!r}")
            del model, plain, result, state, step
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def tensor_parallel_slice(train, hub, pa, tp, fk, card: str) -> dict:
    """Phase 26: (a, b) MViT-B 16x4 tensor-parallel over TP_RANKS processes
    sharing the card against one process unsharded; (c) the kernels at the
    local shapes; (d) FSDP and ``run_sharded_step`` on a one-rank NCCL
    group; (e) the times, printed by each part. Each part's seconds
    printed."""
    import shutil

    t_part = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        print(f"phase 26 {part}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    ref = tp_references(hub, train)
    lap("references")
    directory = os.path.join(REPO, "build", f"phase26_{os.getpid()}")
    os.makedirs(directory, exist_ok=True)
    try:
        ranks = run_tp_ranks(directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    lap(f"(a, b) {TP_RANKS} ranks")
    report = {"path": tp_path_checks(ranks, ref, card)}
    del ranks, ref
    report["kernels"] = check_tp_local_kernels(pa, tp, fk)
    lap("(c, e)")
    report["fsdp"] = fsdp_one_rank_check(train, card)
    lap("(d)")
    return report


def tensor_parallel_entries(entries: list, tensor: dict) -> None:
    """Each MViT kernel's ``tensor_parallel`` entry on the kernels line: its
    launches on the tp = TP_RANKS path (rank 0's (a) bf16 and fused bf16
    forwards, (b) step and pool_first forward and backward), by route, its
    errors and launches at the local shapes (c), its times there (e)."""
    path = tensor["path"]["counts"]
    readings = [path[k] for k in ("bfloat16", "fused bfloat16", "step", "pool_first")]
    kernels = tensor["kernels"]
    err_key = {"attention_nopad": "pooled_attention"}
    for entry in entries:
        names = TP_WRAPPERS.get(entry["name"])
        if names is None:
            continue
        bases = {n.split(".")[0] for n in names}
        key = err_key.get(entry["name"], entry["name"])
        routes = {}
        for reading in readings:
            for base in bases:
                for route, n in by_route(reading, base).items():
                    routes[route] = routes.get(route, 0) + n
        entry["tensor_parallel"] = {
            "launches": sum(r[n] for r in readings for n in names),
            "launches_by_route": routes,
            "path": f"phase 26 (a, b): mvit_base_16x4 on a (1, {TP_RANKS}) (data, model) mesh, "
                    f"rank 0: the bf16 and fused bf16 B{TP_BATCH} forwards, one bf16 B{TP_BATCH} "
                    f"step, pool_first's bf16 B{TP_POOL_FIRST_BATCH} forward and backward",
            "local_shapes_max_abs_err": kernels["errs"].get(key, (None,))[0],
            "local_shapes_max_rel_err": kernels["errs"].get(key, (None, None))[1],
            "local_shapes_launches": {k: n for k, n in kernels["launches"].items()
                                      if k.split(".")[0] in bases},
            **({"timing": "bf16, blocks 1-15, ms per B32 forward (#4, #6, #8's pool-LN) or B8 "
                          "step (#5, #7) at the local shapes (local_ms) and at whole heads "
                          "(whole_ms)", **kernels["timing"][key]}
               if key in kernels["timing"] else {})}
        assert entry["tensor_parallel"]["launches"] > 0, f"{entry['name']}: no launch under tp"


# Phase 27: the Ego4d audio front end (``data/ego4d`` ``signal_transform``:
# an STFT, the HTK mel filterbank, MFCCs) on the card at its real window,
# 10 s at 48 kHz (936 frames x 513 bins -> 256 mels), feeding audio-visual
# SlowFast-R50's audio pathway. No TPU kernel lies on this path.
FRONT_END_CLIPS = 32
FRONT_END_RATE = 48000
FRONT_END_SAMPLES = 10 * FRONT_END_RATE
FRONT_END_TYPES = ("spectrogram", "melspectrogram", "mfcc")
FRONT_END_SHARE = 1e-5  # float32 on the card against float64 on the CPU, of max |value|
FRONT_END_BATCHES = (8, 32)
FRONT_END_CHECK_BATCH = 8
FRONT_END_ITERS = 5
EGO4D_WINDOW_SEC = 10
EGO4D_IMU_RATE = 200


def front_end_waves(generator):
    """FRONT_END_CLIPS seeded 10 s, 48 kHz waveforms in float64 on the host:
    noise (std 0.1) over a tone of a seeded frequency in [100, 8000] Hz."""
    import torch

    t = torch.arange(FRONT_END_SAMPLES, dtype=torch.float64) / FRONT_END_RATE
    hz = 100 + 7900 * torch.rand(FRONT_END_CLIPS, 1, generator=generator, dtype=torch.float64)
    noise = torch.randn(FRONT_END_CLIPS, FRONT_END_SAMPLES, generator=generator,
                        dtype=torch.float64)
    return 0.5 * torch.sin(2 * math.pi * hz * t) + 0.1 * noise


def front_end_check(waves, card: str) -> dict:
    """Phase 27 (a): each of ``signal_transform``'s three types on every
    waveform in float32 on the card against the port's CPU float64 result
    on the same waveform, within FRONT_END_SHARE of max |value|; no kernel
    launched."""
    import torch

    from pytorchvideo_tpu_torch.data.ego4d import signal_transform

    frames = 1 + (FRONT_END_SAMPLES - 1024) // 512
    worst = {}
    reset_counts()
    for kind in FRONT_END_TYPES:
        transform = signal_transform(kind, FRONT_END_RATE)
        shares = []
        for w in waves:
            ref = transform(w)
            got = transform(w.to("cuda", torch.float32))
            assert got.is_cuda and got.dtype == torch.float32, f"{kind}: {got.device} {got.dtype}"
            assert got.shape == ref.shape == (513 if kind == "spectrogram" else 256, frames), (
                f"{kind}: {tuple(got.shape)}")
            assert bool(got.isfinite().all()), f"{kind}: non-finite values on the card"
            scale = ref.abs().max().item()
            shares.append((got.double().cpu() - ref).abs().max().item() / scale)
        worst[kind] = max(shares)
        print(f"phase 27 (a) signal_transform({kind!r}, {FRONT_END_RATE}) on {len(waves)} "
              f"waveforms of {FRONT_END_SAMPLES} samples: card float32 against CPU float64, "
              f"worst max |err| / max |value| {worst[kind]!r} (bound {FRONT_END_SHARE}) on {card}")
        assert worst[kind] <= FRONT_END_SHARE, f"{kind}: {worst[kind]} of max |value|"
    check_path_counts("phase 27 (a) front end", read_counts(), {}, 2 * len(waves),
                      "transforms of each type")
    return {"worst_share": worst}


def front_end_audio(transform, waves):
    """Audio-visual SlowFast's audio pathway from waveforms, as the JAX
    package composes the two (tests/test_audio_e2e.py:268-271): each mel
    spectrogram transposed to (frames, mels), subsampled to 128 frames, then
    to 80 mels; (B, 1, 128, 1, 80) on the waveforms' device."""
    import torch

    from pytorchvideo_tpu_torch.transforms.functional import uniform_temporal_subsample

    t_audio, f_audio = AV_CLIPS[2][1], AV_CLIPS[2][3]
    out = []
    for w in waves:
        spec = uniform_temporal_subsample(transform(w).T, t_audio, temporal_axis=0)
        out.append(uniform_temporal_subsample(spec, f_audio, temporal_axis=1))
    return torch.stack(out)[:, None, :, None, :]


def front_end_av_check(convert_to_deployable_form, waves, card: str) -> dict:
    """Phase 27 (b): the card's mel spectrograms as AV SlowFast-R50's audio
    pathway (BN statistics measured on two such clips with phase 24's
    visual pathways), the bf16 deploy form at FRONT_END_BATCHES, its logits
    at FRONT_END_CHECK_BATCH against the plain f32 eval model
    (``check_logits``); the front end's and the forward's device ms at each
    batch (``cuda_time_ms``); no kernel launched."""
    import torch

    from pytorchvideo_tpu_torch.data.ego4d import signal_transform
    from pytorchvideo_tpu_torch.models import create_audio_visual_slowfast

    transform = signal_transform("melspectrogram", FRONT_END_RATE)
    card_waves = waves.to("cuda", torch.float32)
    visual = {B: next(SyntheticAVClips(B, 270 + B).train_dataloader(1))["video"][:2]
              for B in FRONT_END_BATCHES}
    inputs = {B: [*visual[B], front_end_audio(transform, card_waves[:B])]
              for B in FRONT_END_BATCHES}
    audio = inputs[FRONT_END_CHECK_BATCH][2]
    assert tuple(audio.shape) == (FRONT_END_CHECK_BATCH, *AV_CLIPS[2]) and audio.is_cuda
    cpu_audio = front_end_audio(transform, waves[:FRONT_END_CHECK_BATCH])
    audio_share = ((audio.double().cpu() - cpu_audio).abs().max()
                   / cpu_audio.abs().max()).item()
    assert audio_share <= FRONT_END_SHARE, f"the audio pathway off the CPU's by {audio_share}"

    gen = torch.Generator().manual_seed(272)
    model = create_audio_visual_slowfast()
    assert all(p.is_cuda for p in model.parameters()), "the AV model was built off the card"
    randomize_(model, gen, [p[:2] for p in inputs[FRONT_END_CHECK_BATCH]])
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    report = {"audio_share": audio_share, "batches": {}}
    with torch.no_grad():
        reset_counts()
        x = inputs[FRONT_END_CHECK_BATCH]
        ref = model(x).float()
        got = {"bfloat16": deploy(cast(x, torch.bfloat16)).float()}
        check_logits("phase 27 (b) av_slowfast_r50 on the front end's audio", got, ref)
        report["max_abs_err"] = (got["bfloat16"] - ref).abs().max().item()
        report["max_abs_logit"] = ref.abs().max().item()
        for B in FRONT_END_BATCHES:
            xb = cast(inputs[B], torch.bfloat16)
            front_ms = cuda_time_ms(lambda: front_end_audio(transform, card_waves[:B]),
                                    FRONT_END_ITERS)
            forward_ms = cuda_time_ms(lambda: deploy(xb), FRONT_END_ITERS)
            logits = deploy(xb)
            assert logits.shape == (B, 400) and bool(logits.isfinite().all())
            report["batches"][B] = {"front_end_ms": front_ms, "forward_ms": forward_ms}
            print(f"phase 27 (b) B{B}: the front end (melspectrogram of {B} x 10 s at "
                  f"{FRONT_END_RATE} Hz, then 128 x 80) {front_ms!r} ms; av_slowfast_r50 bf16 "
                  f"deploy forward (slow 8x224x224, fast 32x224x224, audio 128x80) "
                  f"{forward_ms!r} ms; cuda_time_ms over {FRONT_END_ITERS} calls; on {card}")
        forwards = 2 + len(FRONT_END_BATCHES) * (FRONT_END_ITERS + 3)
        check_path_counts("phase 27 (b) front end and AV", read_counts(), {}, forwards)
    print(f"phase 27 (b): the card's audio pathway against the CPU's float64 at "
          f"B{FRONT_END_CHECK_BATCH}: {audio_share!r} of max |value| (bound {FRONT_END_SHARE}); "
          f"bf16 logits {report['max_abs_err']!r} off the f32 model's (max |logit| "
          f"{report['max_abs_logit']!r}) on {card}")
    del model, deploy
    torch.cuda.empty_cache()
    return report


def write_ego4d_files(directory: str, generator) -> dict:
    """Phase 27 (c)'s annotations: one train video ``u0`` of 20 s with a
    label span, its metadata, and its IMU CSV (EGO4D_IMU_RATE Hz, seeded
    readings)."""
    import torch

    os.makedirs(os.path.join(directory, "imu"))
    label = {"label": "cooking", "start_time": 4.0, "end_time": 9.0, "video_start_time": 4.0,
             "video_end_time": 9.0}
    moments = {"videos": [{"video_uid": "u0", "split": "train", "clips": [{
        "clip_uid": "u0_c0", "video_start_sec": 0.0, "video_end_sec": 20.0,
        "annotations": [{"labels": [label]}]}]}]}
    meta = {"videos": [{"video_uid": "u0", "duration_sec": 20.0, "manifold_path": "u0.mp4"}]}
    paths = {"annotation_path": os.path.join(directory, "moments.json"),
             "metadata_path": os.path.join(directory, "meta.json"),
             "imu_path": os.path.join(directory, "imu")}
    for key, content in (("annotation_path", moments), ("metadata_path", meta)):
        with open(paths[key], "w") as f:
            json.dump(content, f)
    n = 20 * EGO4D_IMU_RATE
    readings = torch.randn(n, 6, generator=generator, dtype=torch.float64) + 9.8
    with open(os.path.join(directory, "imu", "u0.csv"), "w") as f:
        f.write("canonical_timestamp_ms,accl_x,accl_y,accl_z,gyro_x,gyro_y,gyro_z\n")
        for i, row in enumerate(readings.tolist()):
            f.write(f"{1000.0 * i / EGO4D_IMU_RATE!r}," + ",".join(map(repr, row)) + "\n")
    return paths


def ego4d_transform_check(waves, card: str) -> dict:
    """Phase 27 (c): ``Ego4dMomentsDataset._transform_mm`` over a sample
    whose video and audio lie on the card and over the same sample on the
    host: the spectrogram and the IMU window come out on the card, the
    one-hot labels (a list, as in the JAX package) and the IMU window equal
    the host's, the spectrogram within FRONT_END_SHARE of it."""
    import shutil

    import torch

    from pytorchvideo_tpu_torch.data import Ego4dMomentsDataset

    gen = torch.Generator().manual_seed(273)
    directory = os.path.join(REPO, "build", f"phase27_{os.getpid()}")
    try:
        paths = write_ego4d_files(directory, gen)
        dataset = Ego4dMomentsDataset(split="train", decode_audio=True, imu=True,
                                      window_sec=EGO4D_WINDOW_SEC,
                                      label_id_map={"cooking": 0, "washing": 1}, **paths)
        assert dataset.cnt_samples == 1, dataset.cnt_samples
        _, info = dataset._labeled_videos[0]
        info = dict(info)
        clip = dataset._clip_sampler(None, info["duration"], info)
        video = torch.randint(0, 256, (8, 224, 224, 3), generator=gen, dtype=torch.uint8)
        audio = waves[0].float()
        host = dict(info, video=video, audio=audio, clip_index=0, aug_index=0)
        on_card = dict(info, video=video.cuda(), audio=audio.cuda(), clip_index=0, aug_index=0)
        reset_counts()
        got = dataset._transform_mm(on_card)
        want = dataset._transform_mm(host)
        check_path_counts("phase 27 (c) _transform_mm", read_counts(), {}, 2, "samples")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert list(got) == list(want), (list(got), list(want))
    assert got["spectrogram"].is_cuda and got["audio"]["signal"].is_cuda
    assert all(got["imu"][k].is_cuda for k in ("signal", "timestamp"))
    for k in ("signal", "timestamp"):
        assert torch.equal(got["imu"][k].cpu(), want["imu"][k]), f"imu {k} differs"
    assert got["imu"]["sampling_rate"] == want["imu"]["sampling_rate"]
    assert got["labels_onehot"] == want["labels_onehot"] == [1, 0]
    share = ((got["spectrogram"].cpu() - want["spectrogram"]).abs().max()
             / want["spectrogram"].abs().max()).item()
    assert share <= FRONT_END_SHARE, f"_transform_mm's spectrogram off the host's by {share}"
    window = tuple(got["imu"]["signal"].shape)
    print(f"phase 27 (c) Ego4dMomentsDataset._transform_mm, clip [{clip.clip_start_sec}, "
          f"{clip.clip_end_sec}] s: spectrogram {tuple(got['spectrogram'].shape)} and IMU window "
          f"{window} at {got['imu']['sampling_rate']} Hz on the card; IMU window and one-hot "
          f"labels {got['labels_onehot']} equal the host's; spectrogram {share!r} of max |value| "
          f"off the host's float32 (bound {FRONT_END_SHARE}) on {card}")
    return {"spectrogram_share": share, "imu_window": window,
            "sampling_rate": got["imu"]["sampling_rate"]}


def front_end_slice(convert_to_deployable_form, card: str) -> dict:
    """Phase 27: the Ego4d audio front end on the card (a), feeding
    audio-visual SlowFast-R50 (b), and the moments dataset's transform on
    a sample on the card (c); no kernel launched in any of them."""
    import torch

    report, t_part = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        print(f"phase 27 {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    waves = front_end_waves(torch.Generator().manual_seed(270))
    report["signal_transform"] = front_end_check(waves, card)
    part("(a)")
    report["av_slowfast_r50"] = front_end_av_check(convert_to_deployable_form, waves, card)
    part("(b)")
    report["transform_mm"] = ego4d_transform_check(waves, card)
    part("(c)")
    return report


# Phase 28: the native decoder (``data/native_build.py``,
# ``encoded_video_native.py``, ``native_pipeline.py``) on a seeded A/V file,
# feeding X3D-S (#1 on its 22 stride-1 ``conv_b``) and audio-visual
# SlowFast-R50 (a); MixVideo with ``x_audio`` on the card (b).
DECODE_FRAMES = 300
DECODE_HW = (240, 320)
DECODE_FPS = 30
DECODE_RATE = 48000  # 10 s of mono audio at 48 kHz
DECODE_CLIPS = 8
DECODE_CLIP_FRAMES = 60  # 2 s a clip
DECODE_THREADS = 4
DECODE_SCALE = (182, 242)  # the pipeline's rescale in native code
DECODE_AUDIO_TOL = 2e-4  # pcm_s16le against the float32 waveform (tests/test_audio_e2e.py:39)
DECODE_RESCALE_TOL = 8.0  # swscale's bilinear against torch's: mean |diff| on [0, 255]
# (tests/test_native_decoder.py:105)
DECODE_ITERS = 5
X3D_VAL = (13, 182, 160)  # X3D-S's val chain: frames, short side, centre crop
MIX_REL_TOL = 1e-6  # MixUp in f32 on the card against the CPU's


def av_file(directory: str, generator) -> tuple:
    """A seeded A/V file written by ``mux_av`` (FFV1 and pcm_s16le):
    DECODE_FRAMES frames of DECODE_HW RGB at DECODE_FPS, a moving gradient
    with seeded noise, and 10 s of a seeded tone with noise at DECODE_RATE.
    Returns (path, frames (T, H, W, 3) uint8, waveform float32, seconds to
    write)."""
    import torch

    from pytorchvideo_tpu_torch.data.encoded_video_native import mux_av

    (h, w), n = DECODE_HW, DECODE_FRAMES
    y, x = torch.arange(h, dtype=torch.int32)[:, None], torch.arange(w, dtype=torch.int32)[None]
    t = torch.arange(n, dtype=torch.int32)[:, None, None]
    ramp = (x + 2 * y + 4 * t)[..., None] * torch.tensor([1, 2, 3], dtype=torch.int32)
    noise = torch.randint(0, 16, (n, h, w, 3), generator=generator, dtype=torch.int32)
    frames = ((ramp + noise) % 256).to(torch.uint8)
    seconds = n / DECODE_FPS
    times = torch.arange(int(seconds * DECODE_RATE), dtype=torch.float64) / DECODE_RATE
    hz = 200 + 1800 * torch.rand((), generator=generator, dtype=torch.float64)
    wave = (0.5 * torch.sin(2 * math.pi * hz * times)
            + 0.05 * torch.randn(times.shape, generator=generator, dtype=torch.float64))
    wave = wave.clamp(-1.0, 1.0).float()
    path = os.path.join(directory, "av.avi")
    t0 = time.perf_counter()
    mux_av(path, frames, DECODE_FPS, wave, DECODE_RATE)
    return path, frames, wave, time.perf_counter() - t0


def check_decoded_clip(label: str, clip: dict, frames, wave) -> float:
    """The whole file's clip: the frames equal to the written ones bit for
    bit, the audio the whole window within DECODE_AUDIO_TOL of the written
    waveform. Returns the audio's max |err|."""
    import torch

    video, audio = clip["video"], clip["audio"]
    assert video is not None and video.dtype == torch.uint8 and video.device.type == "cpu"
    assert torch.equal(video, frames), f"{label}: the decoded frames differ from the written"
    assert audio is not None and audio.dtype == torch.float32 and audio.device.type == "cpu"
    n = min(audio.numel(), wave.numel())
    assert n >= wave.numel() - 1024, f"{label}: {audio.numel()} of {wave.numel()} samples"
    err = (audio[:n] - wave[:n]).abs().max().item()
    assert err <= DECODE_AUDIO_TOL, f"{label}: audio off by {err}"
    return err


def decode_checks(path: str, frames, wave, card: str) -> dict:
    """Phase 28 (a) 1-4, on the host: the whole file through
    ``EncodedVideo.from_path`` and ``from_bytes`` (frames bit for bit, audio
    within DECODE_AUDIO_TOL); DECODE_CLIPS clips of 2 s through one handle
    and through ``NativeDecodePipeline`` at the file's size (each equal to
    its frames) and rescaled to DECODE_SCALE in native code (near torch's
    bilinear resize of its frames), each timed. Returns (report, the clips
    at the file's size, the rescaled clips, the decoded audio)."""
    import torch
    import torch.nn.functional as TF

    from pytorchvideo_tpu_torch.data.encoded_video import EncodedVideo
    from pytorchvideo_tpu_torch.data.native_pipeline import iter_decoded_clips

    report = {}
    video = EncodedVideo.from_path(path, decoder="native", decode_audio=True)
    assert type(video).__name__ == "EncodedVideoNative" and video.has_audio
    assert video.duration == DECODE_FRAMES / DECODE_FPS and video.audio_rate == DECODE_RATE
    report["audio_err"] = check_decoded_clip("from_path", video.get_clip(0, video.duration),
                                             frames, wave)
    video.close()
    with open(path, "rb") as f:
        blob = f.read()
    video = EncodedVideo.from_bytes(blob, decoder="native", decode_audio=True)
    clip = video.get_clip(0, video.duration)
    video.close()
    report["audio_err_from_bytes"] = check_decoded_clip("from_bytes", clip, frames, wave)
    report["file_bytes"] = len(blob)

    spans = [(i * DECODE_FPS, i * DECODE_FPS + DECODE_CLIP_FRAMES) for i in range(DECODE_CLIPS)]
    video = EncodedVideo.from_path(path, decoder="native")
    t0 = time.perf_counter()
    one = [video.get_clip(s / DECODE_FPS, e / DECODE_FPS)["video"] for s, e in spans]
    report["one_handle_ms_per_clip"] = (time.perf_counter() - t0) * 1e3 / DECODE_CLIPS
    video.close()
    for (s, e), got in zip(spans, one):
        assert torch.equal(got, frames[s:e]), f"one handle: frames {s}-{e} differ"

    def pipeline(out_hw):
        t0 = time.perf_counter()
        got = dict(iter_decoded_clips([(path, s, e) for s, e in spans], DECODE_THREADS,
                                      DECODE_CLIPS, *out_hw))
        return [got[i] for i in range(DECODE_CLIPS)], time.perf_counter() - t0

    native, native_s = pipeline((0, 0))
    for (s, e), got in zip(spans, native):
        assert torch.equal(got, frames[s:e]), f"pipeline: frames {s}-{e} differ"
    scaled, scaled_s = pipeline(DECODE_SCALE)
    diffs = []
    for (s, e), got in zip(spans, scaled):
        assert tuple(got.shape) == (e - s, *DECODE_SCALE, 3), tuple(got.shape)
        ref = TF.interpolate(frames[s:e].permute(0, 3, 1, 2).float(), size=DECODE_SCALE,
                             mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        diffs.append((got.float() - ref).abs().mean().item())
    report.update(pipeline_clips_per_s=DECODE_CLIPS / native_s,
                  pipeline_scaled_clips_per_s=DECODE_CLIPS / scaled_s,
                  scaled_mean_abs_diff=max(diffs))
    assert report["scaled_mean_abs_diff"] <= DECODE_RESCALE_TOL, report["scaled_mean_abs_diff"]
    print(f"phase 28 (a) decode: {DECODE_FRAMES} frames of {DECODE_HW[0]}x{DECODE_HW[1]} at "
          f"{DECODE_FPS} fps and {wave.numel()} samples at {DECODE_RATE} Hz ({len(blob)} bytes, "
          f"FFV1 + pcm_s16le): from_path and from_bytes frames equal bit for bit, audio max "
          f"|err| {report['audio_err']!r} and {report['audio_err_from_bytes']!r} (bound "
          f"{DECODE_AUDIO_TOL}); {DECODE_CLIPS} clips of {DECODE_CLIP_FRAMES} frames: one "
          f"handle {report['one_handle_ms_per_clip']!r} ms a clip; the pipeline "
          f"({DECODE_THREADS} threads) {report['pipeline_clips_per_s']!r} clips/s at "
          f"{DECODE_HW[0]}x{DECODE_HW[1]} (equal bit for bit) and "
          f"{report['pipeline_scaled_clips_per_s']!r} clips/s rescaled to "
          f"{DECODE_SCALE[0]}x{DECODE_SCALE[1]} (mean |diff| against torch's bilinear "
          f"{report['scaled_mean_abs_diff']!r}, bound {DECODE_RESCALE_TOL}); host clock; "
          f"host of {card}")
    return report, native, scaled, clip["audio"]


def x3d_val_batch(clips, device):
    """X3D-S's val chain on ``device`` over a list of (T, H, W, 3) uint8
    clips: X3D_VAL[0] frames, /255, normalised, short side X3D_VAL[1],
    centre crop X3D_VAL[2]; a bf16 NCTHW batch."""
    import torch

    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms import transforms as T

    frames, side, crop = X3D_VAL
    chain = T.Compose([T.UniformTemporalSubsample(frames), T.Div255(),
                       T.Normalize(FEED_MEAN, FEED_STD), T.ShortSideScale(side),
                       T.CenterCropVideo(crop), F.thwc_to_cthw])
    return chain(torch.stack(clips).to(device)).to(torch.bfloat16)


def av_visual_batch(clips, device):
    """AV SlowFast-R50's visual pathways from (T, H, W, 3) uint8 clips on
    ``device``: fast AV_CLIPS[1] (frames uniformly, /255, normalised, short
    side and centre crop 224), slow its AV_CLIPS[0][1] frames uniformly."""
    import torch

    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms import transforms as T

    _, t_fast, size, _ = AV_CLIPS[1]
    chain = T.Compose([T.UniformTemporalSubsample(t_fast), T.Div255(),
                       T.Normalize(FEED_MEAN, FEED_STD), T.ShortSideScale(size),
                       T.CenterCropVideo(size), F.thwc_to_cthw])
    fast = chain(torch.stack(clips).to(device))
    return [F.uniform_temporal_subsample(fast, AV_CLIPS[0][1], temporal_axis=-3), fast]


def decoded_x3d_check(hub, convert_to_deployable_form, native, scaled, frames, card: str,
                      device: str = "cuda") -> dict:
    """Phase 28 (a) 5-6: the decoded clips through X3D-S's val chain on the
    card into ``x3d_s`` deploy bf16 at B DECODE_CLIPS: the clips decoded at
    the file's size give logits equal to those of the written frames
    themselves (the same input); the rescaled clips' logits finite, their
    distance from those reported; #1 launched 22 times a forward; the
    forward's ms (``cuda_time_ms``)."""
    import torch

    gen = torch.Generator().manual_seed(281)
    model = hub.x3d_s(model_num_class=400, device=device)
    calib = torch.randn(2, 3, X3D_VAL[0], X3D_VAL[2], X3D_VAL[2], generator=gen).to(device)
    randomize_(model, gen, calib)
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    spans = [(i * DECODE_FPS, i * DECODE_FPS + DECODE_CLIP_FRAMES) for i in range(DECODE_CLIPS)]
    written = x3d_val_batch([frames[s:e] for s, e in spans], device)
    decoded = x3d_val_batch(native, device)
    rescaled = x3d_val_batch(scaled, device)
    assert torch.equal(decoded, written), "the val chain's input differs from the written frames'"
    with torch.no_grad():
        reset_counts()
        want = deploy(written).float()
        got = deploy(decoded).float()
        got_scaled = deploy(rescaled).float()
        check_path_counts("phase 28 (a) x3d_s on decoded clips", read_counts(), X3D_PER_FORWARD,
                          3)
        forward_ms = cuda_time_ms(lambda: deploy(rescaled), DECODE_ITERS)
    assert got.shape == (DECODE_CLIPS, 400) and bool(want.isfinite().all())
    assert torch.equal(got, want), "logits on the decoded clips differ from the written frames'"
    assert bool(got_scaled.isfinite().all()), "non-finite logits on the rescaled clips"
    scale = want.abs().max().item()
    scaled_err = (got_scaled - want).abs().max().item()
    agree = int((got_scaled.argmax(1) == want.argmax(1)).sum())
    print(f"phase 28 (a) x3d_s deploy bf16 B{DECODE_CLIPS} (val chain {X3D_VAL}) on the clips "
          f"decoded at {DECODE_HW[0]}x{DECODE_HW[1]}: logits equal to the written frames' bit "
          f"for bit; on the clips rescaled in native code: max |logit - the written frames'| "
          f"{scaled_err!r} at max |logit| {scale!r}, top-1 equal on {agree}/{DECODE_CLIPS}; 22 "
          f"#1 launches a forward; the forward {forward_ms!r} ms (cuda_time_ms over "
          f"{DECODE_ITERS}); on {card}")
    del model, deploy
    return {"forward_ms": forward_ms, "rescaled_max_abs_diff": scaled_err,
            "max_abs_logit": scale, "rescaled_top1_agree": agree}


def decoded_av_check(convert_to_deployable_form, native, audio, wave, card: str,
                     device: str = "cuda") -> dict:
    """Phase 28 (a) 7: the decoded clips' visual pathways and the decoded
    10 s of audio through ``signal_transform`` (phase 27's front end) into
    AV SlowFast-R50 deploy bf16 at B DECODE_CLIPS (each row the file's one
    waveform), held as phase 27 (b) holds its forward: against the plain f32
    model on the same path from the written waveform (``check_logits``); the
    bf16 forward on the written waveform beside it; no kernel launched."""
    import torch

    from pytorchvideo_tpu_torch.data.ego4d import signal_transform
    from pytorchvideo_tpu_torch.models import create_audio_visual_slowfast

    transform = signal_transform("melspectrogram", DECODE_RATE)
    visual = av_visual_batch(native, device)
    decoded = front_end_audio(transform, audio.to(device).expand(DECODE_CLIPS, -1))
    written = front_end_audio(transform, wave.to(device).expand(DECODE_CLIPS, -1))
    assert tuple(decoded.shape) == (DECODE_CLIPS, *AV_CLIPS[2])
    audio_share = ((decoded - written).abs().max() / written.abs().max()).item()
    gen = torch.Generator().manual_seed(282)
    model = create_audio_visual_slowfast(device=device)
    randomize_(model, gen, [p[:2] for p in [*visual, written]])
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    with torch.no_grad():
        reset_counts()
        ref = model([*visual, written]).float()
        got = deploy(cast([*visual, decoded], torch.bfloat16)).float()
        beside = deploy(cast([*visual, written], torch.bfloat16)).float()
        check_path_counts("phase 28 (a) av_slowfast_r50 on decoded audio", read_counts(), {}, 3)
    check_logits("phase 28 (a) av_slowfast_r50 on the decoded audio (the f32 model on the "
                 "written waveform's)", {"bfloat16": got}, ref)
    err = (got - ref).abs().max().item()
    written_err = (beside - ref).abs().max().item()
    print(f"phase 28 (a) av_slowfast_r50 deploy bf16 B{DECODE_CLIPS}: visual pathways from the "
          f"decoded clips, the audio pathway from the decoded {audio.numel()} samples "
          f"({audio_share!r} of max |value| off the written waveform's): logits {err!r} off "
          f"the f32 model's on the written waveform (max |logit| {ref.abs().max().item()!r}); "
          f"the bf16 forward on the written waveform {written_err!r} off; on {card}")
    del model, deploy
    return {"audio_share": audio_share, "max_abs_err": err, "written_max_abs_err": written_err,
            "max_abs_logit": ref.abs().max().item()}


def decoder_feed_check(hub, convert_to_deployable_form, card: str, device: str = "cuda") -> dict:
    """Phase 28 (a): where ``g++`` and FFmpeg's development packages are
    present, the decoder built from ``native/``, a seeded A/V file written
    and decoded (``decode_checks``) into X3D-S and AV SlowFast-R50; where
    any is missing, one line that names it, and nothing else."""
    import shutil

    import torch

    from pytorchvideo_tpu_torch.data import native_build

    missing = native_build.missing_tools()
    if missing:
        print(f"phase 28 (a): the native decoder cannot be built on this machine: missing "
              f"{', '.join(missing)} (it needs g++ and FFmpeg's development libraries through "
              f"pkg-config); (a) not run")
        return {"built": False, "missing": missing}
    t0 = time.perf_counter()
    library = native_build.build_library()
    build_s = time.perf_counter() - t0
    directory = os.path.join(REPO, "build", f"phase28_{os.getpid()}")
    os.makedirs(directory)
    try:
        path, frames, wave, write_s = av_file(directory, torch.Generator().manual_seed(280))
        report, native, scaled, audio = decode_checks(path, frames, wave, card)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    report.update(built=True, build_s=build_s, write_s=write_s,
                  library=os.path.relpath(library, REPO))
    report["x3d_s"] = decoded_x3d_check(hub, convert_to_deployable_form, native, scaled, frames,
                                        card, device)
    report["av_slowfast_r50"] = decoded_av_check(convert_to_deployable_form, native, audio, wave,
                                                 card, device)
    print(f"phase 28 (a): the decoder built in {build_s:.1f} s, the file written in "
          f"{write_s:.1f} s")
    return report


class _RecordedDraws:
    """The random scalars ``transforms.mix`` reads from a generator
    (``_sample_beta``, ``_sample_center`` and MixVideo's coin ``_uniform``,
    the outermost call only), recorded in one run and replayed in another,
    so that a mix on the CPU takes the card's lambda, boxes and coin."""

    NAMES = ("_uniform", "_sample_beta", "_sample_center")

    def __init__(self):
        self.draws = {name: [] for name in self.NAMES}

    @contextlib.contextmanager
    def recording(self):
        from unittest import mock

        from pytorchvideo_tpu_torch.transforms import mix

        originals, depth = {n: getattr(mix, n) for n in self.NAMES}, [0]

        def recorder(name):
            def draw(*args, **kwargs):
                depth[0] += 1
                try:
                    value = originals[name](*args, **kwargs)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    self.draws[name].append(value)
                return value
            return draw

        with mock.patch.multiple(mix, **{n: recorder(n) for n in self.NAMES}):
            yield

    @contextlib.contextmanager
    def replaying(self):
        from unittest import mock

        from pytorchvideo_tpu_torch.transforms import mix

        queues = {n: list(v) for n, v in self.draws.items()}
        with mock.patch.multiple(mix, **{n: (lambda *a, n=n, **k: queues[n].pop(0))
                                         for n in self.NAMES}):
            yield
        assert not any(queues.values()), f"draws left over: {queues}"


def mix_video_check(train, card: str) -> dict:
    """Phase 28 (b): a seeded AV SlowFast-R50 batch at AV_TRAIN_BATCH (fast
    32x224x224 and a 128 x 80 spectrogram in f32; soft labels of 400
    classes) mixed on the card by ``MixVideo(x_audio=...)`` with a CUDA
    generator, at cutmix_prob 1 (CutMix) and 0 (MixUp); the slow pathway
    the mixed fast one's 8 frames. Each against the CPU's mix of the same
    batch at the card's lambda, boxes and coin: CutMix exactly, MixUp within
    MIX_REL_TOL relative. Then one bf16 training step of the SlowFast-R50
    preset (``bn_app``, as phase 24) on the CutMix batch: its loss finite,
    no kernel launched."""
    import torch

    from pytorchvideo_tpu_torch.models import create_audio_visual_slowfast, init_net_weights
    from pytorchvideo_tpu_torch.transforms import functional as F
    from pytorchvideo_tpu_torch.transforms.mix import MixVideo

    gen = torch.Generator(device="cuda").manual_seed(283)
    B = AV_TRAIN_BATCH
    fast = torch.randn(B, *AV_CLIPS[1], device="cuda", generator=gen)
    audio = torch.randn(B, *AV_CLIPS[2], device="cuda", generator=gen)
    labels = torch.randint(0, 400, (B,), device="cuda", generator=gen)
    report, mixed = {}, {}
    for name, prob in (("cutmix", 1.0), ("mixup", 0.0)):
        mixer = MixVideo(cutmix_prob=prob, label_smoothing=0.1, num_classes=400)
        draws = _RecordedDraws()
        with draws.recording():
            out = mixer(fast, labels, gen, x_audio=audio)
        with draws.replaying():
            ref = mixer(fast.cpu(), labels.cpu(), None, x_audio=audio.cpu())
        assert all(t.is_cuda for t in out) and len(out) == len(ref) == 3
        errs = [((o.cpu() - r).abs().max() / r.abs().max()).item() for o, r in zip(out, ref)]
        if name == "cutmix":
            assert all(torch.equal(o.cpu(), r) for o, r in zip(out, ref)), f"cutmix: {errs}"
        else:
            assert max(errs) <= MIX_REL_TOL, f"mixup: {errs} of max |value|"
        assert not torch.equal(out[0], fast), f"{name} left the clips as they were"
        report[name] = {"max_rel_err": errs, "lambda": draws.draws["_sample_beta"],
                        "centres": draws.draws["_sample_center"]}
        mixed[name] = out
        print(f"phase 28 (b) MixVideo(cutmix_prob={prob}, x_audio=...) on the card, B{B} "
              f"(fast {AV_CLIPS[1]}, audio {AV_CLIPS[2]}) f32, CUDA generator: lambda "
              f"{draws.draws['_sample_beta']}, box centres {draws.draws['_sample_center']} "
              f"(video, audio); video, audio and labels against the CPU's mix at those draws: "
              f"max |err| / max |value| {errs} ({'exact' if name == 'cutmix' else MIX_REL_TOL}); "
              f"on {card}")
    video, mixed_audio, soft = mixed["cutmix"]
    batch = {"video": [F.uniform_temporal_subsample(video, AV_CLIPS[0][1], temporal_axis=-3),
                       video, mixed_audio], "label": soft}
    model = create_audio_visual_slowfast()
    init_net_weights(model, generator=torch.Generator(device="cuda").manual_seed(284))
    app = bn_app(train, "classification_slowfast_8x8_r50", ResidentFeed(batch), model=model,
                 seed=284, **{"trainer.compute_dtype": "bfloat16"})
    metrics, _ = counted_update(app, batch, {}, "phase 28 (b) av_slowfast_r50 step on the mix")
    loss = metrics["loss"].item()
    assert math.isfinite(loss), f"phase 28 (b): loss {loss}"
    report["loss"] = loss
    print(f"phase 28 (b) av_slowfast_r50 train bf16 B{B} (classification_slowfast_8x8_r50) on "
          f"the CutMix batch, soft labels: loss {loss!r} (finite); on {card}")
    del app, model
    torch.cuda.empty_cache()
    return report


def decoder_slice(hub, convert_to_deployable_form, train, card: str) -> dict:
    """Phase 28: the native decoder into X3D-S and AV SlowFast-R50 (a),
    MixVideo with ``x_audio`` on the card (b)."""
    t0 = time.perf_counter()
    report = {"decoder": decoder_feed_check(hub, convert_to_deployable_form, card)}
    print(f"phase 28 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    report["mix_video"] = mix_video_check(train, card)
    print(f"phase 28 (b): {time.perf_counter() - t0:.1f} s")
    return report


# Phase 29: the examples of examples_torch/ at full width. Each eval case
# is (model, videos, batch size) at its EVAL_CONFIGS protocol; the videos are
# seeded uint8 frames of 10 s at 30 fps, handed to the harness in memory.
EXAMPLE_VIDEO = (300, 240, 320)
EXAMPLE_FPS = 30
EVAL_CASES = (("x3d_s", 4, 16), ("mvit_base_16x4", 4, 8), ("slowfast_r50", 4, 8))
EVAL_PLAIN_SHARE = 1e-3  # kernel run against plain run, of max |ensembled logit|
EVAL_SEED = 290
# Calibration clips of randomize_ per ResNet-family model, at its eval crop.
EVAL_CALIBRATION = {"x3d_s": (13, 182, 182), "slowfast_r50": [(8, 256, 256), (32, 256, 256)]}


def example_module(name: str):
    """examples_torch/<name>.py of this checkout."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module(f"examples_torch.{name}")


def eval_model(ek, name: str, gen, device: str):
    """``name`` as the harness builds it (f32, 400 classes, eval mode) with
    seeded random weights (randomize_ / randomize_mvit_)."""
    import torch

    model = ek.build_model(name, 400, device)
    if name.startswith("mvit_"):
        randomize_mvit_(model, gen)
    else:
        calibration = clips(2, EVAL_CALIBRATION[name], gen)
        randomize_(model, gen, calibration)
        del calibration
        torch.cuda.empty_cache()
    return model


def eval_protocol_case(ek, name: str, model, videos: dict, batch: int, per_forward: dict,
                       directory: str, card: str) -> dict:
    """Phase 29 (a) for one model: the harness over ``videos`` (in memory),
    its views counted by video, its launches per forward batch, its
    ensembled logits against the same run under ``plain_kernels()``."""
    import numpy as np

    num_frames, rate, side, crop, n_clips, n_crops, alpha = ek.EVAL_CONFIGS[name]
    labels = [(video, (7 * i) % 400) for i, video in enumerate(videos)]
    csv = ek.write_csv(os.path.join(directory, f"{name}.csv"), labels)
    kwargs = dict(num_frames=num_frames, sampling_rate=rate, side_size=side, crop_size=crop,
                  clips_per_video=n_clips, spatial_crops=n_crops, alpha=alpha, batch_size=batch,
                  fps=float(EXAMPLE_FPS),
                  video_path_handler=ek.ArrayVideoPathHandler(videos, EXAMPLE_FPS))
    reset_counts()
    record = {}
    result = ek.evaluate(model, csv, record=record, **kwargs)
    counts = read_counts()
    views = len(videos) * n_clips * n_crops
    seen = np.bincount(record["video_index"], minlength=len(videos))
    print(f"phase 29 (a) {name} {n_clips}x{n_crops} views of {num_frames}x{crop}x{crop}"
          f"{'' if alpha is None else f' (alpha {alpha})'}, {len(videos)} videos, B{batch}: "
          f"{len(record['video_index'])} views in {record['batches']} batches, per video "
          f"{seen.tolist()}")
    assert result["num_videos"] == len(videos) and result["views"] == f"{n_clips}x{n_crops}"
    assert len(record["video_index"]) == views, f"{name}: {len(record['video_index'])} views"
    assert (seen == n_clips * n_crops).all(), f"{name}: views per video {seen.tolist()}"
    check_path_counts(f"phase 29 (a) {name} eval", counts, per_forward, record["batches"],
                      unit="forward batches")
    plain = {}
    with plain_kernels():
        reset_counts()
        ek.evaluate(model, csv, record=plain, **kwargs)
        assert not any(read_counts().values()), f"{name}: the plain run launched a kernel"
    got, ref = record["ensembled"].float(), plain["ensembled"].float()
    assert got.shape == (len(videos), 400) and bool(got.isfinite().all()), f"{name}: bad logits"
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    bound = EVAL_PLAIN_SHARE * scale
    top2 = ref.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > bound
    agree = got.argmax(1) == ref.argmax(1)
    wait_ms = sum(record["wait_ms"]) / record["batches"]
    call_ms = sum(record["call_ms"]) / record["batches"]
    print(f"phase 29 (a) {name}: {result['views_per_s']!r} views/s ({result['wall_s']!r} s), host "
          f"{wait_ms!r} ms a batch waiting for the loader and {call_ms!r} ms in the forward "
          f"call; ensembled logits vs plain kernels max |err| {err!r} (bound {bound!r} = "
          f"{EVAL_PLAIN_SHARE} x {scale!r}); predictions agree on {int(agree[decided].sum())}/"
          f"{int(decided.sum())} decided videos; on {card}")
    assert err <= bound, f"{name}: ensembled logits off the plain run by {err} > {bound}"
    assert bool(agree[decided].all()), f"{name}: a decided prediction differs from the plain run"
    return {"views": views, "batches": record["batches"], "views_per_s": result["views_per_s"],
            "wall_s": result["wall_s"], "host_wait_ms": wait_ms, "host_call_ms": call_ms,
            "max_abs_err_vs_plain": err, "bound": bound, "counts": counts,
            "predictions": result["predictions"]}


def golden_fixture_check(ek, device: str, directory: str) -> dict:
    """tests/test_eval_harness.py:38 on ``device``: each video's first clip
    lies nearer a wrong class's brightness, the sum over both clips picks
    the true one and the max the wrong one (100% and 0% top-1)."""
    import numpy as np
    import torch

    centers_b = np.array([40.0, 100.0, 160.0, 220.0])
    b1 = np.where(np.arange(4) == 0, centers_b + 55, centers_b - 55)
    b2 = np.where(np.arange(4) == 0, centers_b - 15, centers_b + 15)
    videos = {f"golden{k}": torch.cat([torch.full((4, 64, 64, 3), int(b1[k])),
                                       torch.full((4, 64, 64, 3), int(b2[k]))]).to(torch.uint8)
              for k in range(4)}

    class BrightnessModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.centers = torch.nn.Parameter(torch.tensor(
                (centers_b / 255.0 - 0.45) / 0.225, dtype=torch.float32, device=device))

        def forward(self, x):
            m = x.mean(dim=tuple(range(1, x.dim())))
            return -torch.square(m[:, None] - self.centers[None, :])

    csv = ek.write_csv(os.path.join(directory, "golden.csv"), [(v, k) for k, v in
                                                               enumerate(videos)])
    results = {method: ek.evaluate(
        BrightnessModel(), csv, num_frames=4, sampling_rate=1, side_size=64, crop_size=64,
        clips_per_video=2, spatial_crops=1, alpha=None, batch_size=4, fps=4.0,
        ensemble_method=method, video_path_handler=ek.ArrayVideoPathHandler(videos, 4))
        for method in ("sum", "max")}
    top1 = {method: r["top1"] for method, r in results.items()}
    print(f"phase 29 (a) golden fixture on {device}: top-1 {top1} (sum must be 100, max 0)")
    assert results["sum"]["views"] == "2x1" and results["sum"]["num_videos"] == 4
    assert top1 == {"sum": 100.0, "max": 0.0}, top1
    return top1


def deployment_example_check(card: str) -> dict:
    """Phase 29 (b): ``accelerator_deployment.main(["--device", "cuda"])``,
    its #1 launches over every forward that ran a deploy form eagerly (22
    each, phase 23's count) and in one more forward of its deploy form; the
    deploy forms' logits against the f32 models', the loaded program's
    against the eager form's."""
    import torch

    ad = example_module("accelerator_deployment")
    reset_counts()
    t0 = time.perf_counter()
    out = ad.main(["--device", "cuda"])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_path_counts("phase 29 (b) accelerator_deployment.main", counts, X3D_PER_FORWARD,
                      out["deploy_forwards"],
                      unit="deploy forwards (eager, warm-up, capture and the loaded program)")
    with torch.no_grad():
        reset_counts()
        out["deploy"](out["input"].bfloat16())
        check_path_counts("phase 29 (b) its deploy form, one forward", read_counts(),
                          X3D_PER_FORWARD, 1)
    bound = LOGIT_REL_TOL["bfloat16"]
    errs = {}
    for ref_key, keys in (("reference", ("deployable", "compiled", "transmuted")),
                          ("efficient_reference", ("efficient",)),
                          ("deployable", ("exported",))):
        ref = out[ref_key]
        scale = ref.abs().max().item()
        assert math.isfinite(scale) and scale > 0, f"phase 29 (b): {ref_key} logits"
        for key in keys:
            got = out[key]
            assert got.shape == ref.shape == (1, 400) and bool(got.isfinite().all()), key
            errs[key] = (got - ref).abs().max().item() / scale
            assert errs[key] <= bound, f"phase 29 (b) {key}: {errs[key]} of max |logit| > {bound}"
    print(f"phase 29 (b) accelerator_deployment.main: {seconds:.1f} s, {out['deploy_forwards']} "
          f"deploy forwards, #1 launches {counts['depthwise3x3x3_bn_swish']}; logits off their "
          f"reference, of max |logit| (bound {bound}): {errs}; program {out['exported_bytes']} "
          f"bytes; on {card}")
    return {"launches": counts["depthwise3x3x3_bn_swish"],
            "launches_by_route": by_route(counts, "depthwise3x3x3_bn_swish"),
            "deploy_forwards": out["deploy_forwards"], "rel_errs": errs, "seconds": seconds}


def examples_slice(card: str, device: str = "cuda") -> dict:
    """Phase 29: the examples (see the module docstring)."""
    import tempfile

    import torch

    ek = example_module("eval_kinetics")
    gen = torch.Generator().manual_seed(EVAL_SEED)
    t0 = time.perf_counter()
    most = max(n for _, n, _ in EVAL_CASES)
    videos = {f"video{i}": torch.randint(0, 256, (*EXAMPLE_VIDEO, 3), generator=gen,
                                         dtype=torch.uint8) for i in range(most)}
    print(f"phase 29 (a): {most} seeded videos of {EXAMPLE_VIDEO} uint8 at {EXAMPLE_FPS} fps "
          f"made in {time.perf_counter() - t0:.1f} s, handed to eval_kinetics.evaluate in memory "
          f"through video_path_handler=ArrayVideoPathHandler: the card's machine has no decoder "
          f"(a choice made before the run)")
    per_forward = {"mvit_base_16x4": f32_routes(MVIT_PER_FORWARD)}
    report = {"eval": {}}
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase29_", dir=build) as tmp:
        for name, count, batch in EVAL_CASES:
            t0 = time.perf_counter()
            model = eval_model(ek, name, gen, device)
            subset = {key: videos[key] for key in list(videos)[:count]}
            report["eval"][name] = eval_protocol_case(ek, name, model, subset, batch,
                                                      per_forward.get(name, {}), tmp, card)
            del model
            torch.cuda.empty_cache()
            print(f"phase 29 (a) {name}: {time.perf_counter() - t0:.1f} s")
        report["golden_fixture"] = golden_fixture_check(ek, device, tmp)
    del videos
    t0 = time.perf_counter()
    report["deployment"] = deployment_example_check(card)
    print(f"phase 29 (b): {time.perf_counter() - t0:.1f} s")
    print("phase 29: hub_inference, video_classification, ssl_pretraining and video_detection "
          "read video files, and the card's machine has no decoder: they run in the CPU tests "
          "only (tests/test_torch_examples.py)")
    return report


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    sys.path.insert(0, REPO)
    from pytorchvideo_tpu_torch.accelerate import (
        DepthwiseConv3x3x3BnAct,
        convert_to_deployable_form,
    )
    from pytorchvideo_tpu_torch.models import hub
    from pytorchvideo_tpu_torch.ops import _build
    from pytorchvideo_tpu_torch.ops import depthwise_conv as dw
    from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
    pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")
    from pytorchvideo_tpu_torch.ops import token_pool as tp
    from pytorchvideo_tpu_torch import train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    print(card)

    t_start = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t_start:.1f} s")
    if sys.argv[1:] == ["--phase", "23"]:  # a development run: phase 23 alone
        t_phase = time.perf_counter()
        extras = deploy_extras_slice(hub, card, {})
        print(f"phase 23 (the deploy extras): {time.perf_counter() - t_phase:.1f} s")
        print("deploy extras report: " + json.dumps(extras, default=str))
        return
    if sys.argv[1:] == ["--phase", "24"]:  # a development run: phase 24 alone
        t_phase = time.perf_counter()
        audio = av_slice(convert_to_deployable_form, train, card)
        print(f"phase 24 (audio-visual SlowFast and the masked multistream): "
              f"{time.perf_counter() - t_phase:.1f} s")
        print("audio report: " + json.dumps(audio, default=str))
        return
    if sys.argv[1:] == ["--phase", "25"]:  # a development run: phase 25 alone
        t_phase = time.perf_counter()
        parallel = data_parallel_slice(train, hub, pa, card)
        print(f"phase 25 (the data-parallel layer): {time.perf_counter() - t_phase:.1f} s")
        print("data parallel report: " + json.dumps(parallel, default=str))
        return
    if sys.argv[1:] == ["--phase", "26"]:  # a development run: phase 26 alone
        t_phase = time.perf_counter()
        tensor = tensor_parallel_slice(train, hub, pa, tp, fk, card)
        print(f"phase 26 (tensor parallelism and FSDP): {time.perf_counter() - t_phase:.1f} s")
        print("tensor parallel report: " + json.dumps(tensor, default=str))
        return
    if sys.argv[1:] == ["--phase", "27"]:  # a development run: phase 27 alone
        t_phase = time.perf_counter()
        front_end = front_end_slice(convert_to_deployable_form, card)
        print(f"phase 27 (the Ego4d audio front end): {time.perf_counter() - t_phase:.1f} s")
        print("front end report: " + json.dumps(front_end, default=str))
        return
    if sys.argv[1:] == ["--phase", "28"]:  # a development run: phase 28 alone
        t_phase = time.perf_counter()
        decoder = decoder_slice(hub, convert_to_deployable_form, train, card)
        print(f"phase 28 (the native decoder and MixVideo's audio): "
              f"{time.perf_counter() - t_phase:.1f} s")
        print("decoder report: " + json.dumps(decoder, default=str))
        return
    if sys.argv[1:] == ["--phase", "29"]:  # a development run: phase 29 alone
        t_phase = time.perf_counter()
        examples = examples_slice(card)
        print(f"phase 29 (the examples): {time.perf_counter() - t_phase:.1f} s")
        print("examples report: " + json.dumps(examples, default=str))
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}; run it with none or --phase N, "
                 f"N in 23-29")

    kernel_report = check_kernel(dw)

    gen = torch.Generator().manual_seed(0)
    model = hub.x3d_s(model_num_class=400)
    randomize_(model, gen, torch.randn(4, 3, 13, 160, 160, generator=gen).cuda())
    deploy = convert_to_deployable_form(model, dtype=torch.bfloat16)
    n_fused = sum(isinstance(m, DepthwiseConv3x3x3BnAct) for m in deploy.modules())
    assert n_fused == KERNELS_PER_FORWARD, f"{n_fused} fused conv_b, expected 22"

    # Logits against the plain f32 eval model, at B8; each deploy form's 22
    # launches on the tiled route.
    x8 = torch.randn(8, 3, 13, 160, 160, generator=gen).cuda()
    got = {}
    with torch.no_grad():
        ref = model(x8).float()
        for name, form, x in (("float32", convert_to_deployable_form(model, dtype=None), x8),
                              ("bfloat16", deploy, x8.bfloat16())):
            reset_counts()
            got[name] = form(x).float()
            check_path_counts(f"x3d_s deploy {name}", read_counts(), X3D_PER_FORWARD, 1)
    check_logits("x3d_s deploy", got, ref)

    # The main path: the counts cover exactly this run.
    reset_counts()
    rates = serve(deploy, BATCHES, gen, (13, 160, 160), 400)
    x3d_counts = read_counts()
    forwards = sum(r["forwards"] for r in rates.values())
    check_path_counts("x3d_s path", x3d_counts, X3D_PER_FORWARD, forwards)
    for B, r in rates.items():
        print(f"x3d_s deploy bf16 13x160x160 B{B}: {r['clips_per_s']!r} clips/s "
              f"({r['ms']!r} ms/forward) on {card}")
    del model, deploy, x8, ref, got
    torch.cuda.empty_cache()

    attention_report = check_attention(pa)
    pool_report = check_token_pool(tp)
    mvit = mvit_slice(hub, convert_to_deployable_form, "mvit_base_16x4", MVIT_BATCHES,
                      MVIT_PER_FORWARD, gen)
    pool_first = mvit_slice(hub, convert_to_deployable_form, "mvit_base_16x4 pool_first",
                            (MVIT_CHECK_BATCH,), POOL_FIRST_PER_FORWARD, gen, pool_first=True)
    attention_bwd = check_attention_backward(pa)
    pool_bwd = check_pool_backward(tp)
    trained = train_slice(train)
    fused_report = check_fused_kvpool(fk, pa, tp)
    nopad_rows = check_attention_nopad(pa)
    fused = mvit_fused_slice(hub, convert_to_deployable_form, MVIT_BATCHES, seed=30)
    fused_trained = train_fused_slice(train, trained["rates"])
    t_phase = time.perf_counter()
    csn_kernel = check_csn_kernel(dw)
    print(f"phase 15 (the depthwise kernel at CSN-R101's shapes): "
          f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    resnets = resnet_slice(hub, convert_to_deployable_form)
    print(f"phase 16 (the ResNet family at full width): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    compiled = compiled_slice(hub, convert_to_deployable_form)
    print(f"phase 17 (compiled serving and export): {time.perf_counter() - t_phase:.1f} s")
    print("compiled serving report: " + json.dumps(compiled))
    t_phase = time.perf_counter()
    bn_trained = bn_train_slice(train, card)
    print(f"phase 18 (BatchNorm-family training): {time.perf_counter() - t_phase:.1f} s")
    print("bn training report: " + json.dumps(bn_trained))
    t_phase = time.perf_counter()
    captured = captured_step_slice(train, hub, bn_trained)
    print(f"phase 19 (the captured training step): {time.perf_counter() - t_phase:.1f} s")
    print("captured step report: " + json.dumps(captured, default=str))
    t_phase = time.perf_counter()
    fed = data_feed_slice(hub, convert_to_deployable_form, train, card)
    print(f"phase 20 (the data feed): {time.perf_counter() - t_phase:.1f} s")
    print("data feed report: " + json.dumps(fed))
    t_phase = time.perf_counter()
    detection = detection_slice(hub, card)
    print(f"phase 21 (AVA detection and the engine): {time.perf_counter() - t_phase:.1f} s")
    print("detection report: " + json.dumps(detection))
    t_phase = time.perf_counter()
    ssl = ssl_slice(train, hub, card)
    print(f"phase 22 (self-supervised pretraining): {time.perf_counter() - t_phase:.1f} s")
    print("ssl report: " + json.dumps(ssl, default=str))
    t_phase = time.perf_counter()
    extras = deploy_extras_slice(hub, card, compiled)
    print(f"phase 23 (the deploy extras): {time.perf_counter() - t_phase:.1f} s")
    print("deploy extras report: " + json.dumps(extras, default=str))
    t_phase = time.perf_counter()
    audio = av_slice(convert_to_deployable_form, train, card)
    print(f"phase 24 (audio-visual SlowFast and the masked multistream): "
          f"{time.perf_counter() - t_phase:.1f} s")
    print("audio report: " + json.dumps(audio, default=str))
    t_phase = time.perf_counter()
    parallel = data_parallel_slice(train, hub, pa, card)
    print(f"phase 25 (the data-parallel layer): {time.perf_counter() - t_phase:.1f} s")
    print("data parallel report: " + json.dumps(parallel, default=str))
    t_phase = time.perf_counter()
    tensor = tensor_parallel_slice(train, hub, pa, tp, fk, card)
    print(f"phase 26 (tensor parallelism and FSDP): {time.perf_counter() - t_phase:.1f} s")
    print("tensor parallel report: " + json.dumps(tensor, default=str))
    t_phase = time.perf_counter()
    front_end = front_end_slice(convert_to_deployable_form, card)
    print(f"phase 27 (the Ego4d audio front end): {time.perf_counter() - t_phase:.1f} s")
    print("front end report: " + json.dumps(front_end, default=str))
    t_phase = time.perf_counter()
    decoder = decoder_slice(hub, convert_to_deployable_form, train, card)
    print(f"phase 28 (the native decoder and MixVideo's audio): "
          f"{time.perf_counter() - t_phase:.1f} s")
    print("decoder report: " + json.dumps(decoder, default=str))
    t_phase = time.perf_counter()
    examples = examples_slice(card)
    print(f"phase 29 (the examples): {time.perf_counter() - t_phase:.1f} s")
    print("examples report: " + json.dumps(examples, default=str))

    x3d_rows = kernel_report["per_shape"]
    pool_rows = pool_report["rows"]["conv"] + pool_report["rows"]["max"]
    attention_errs = [*attention_report["errs"].values(), attention_report["timed_err"]]
    timing = "per forward at B{}: each shape's time times its launches, summed"
    first = ("; first_ms: the same shapes through the CUDA-core kernel (the first version, "
             "bf16's route before the tensor-core and split-key routes)")
    attention_common = {
        "route": "cuda",
        "source": "pytorchvideo_tpu_torch/csrc/pooled_attention.cu",
        "max_abs_err": max(attention_errs),
        "max_abs_err_f32": attention_report["errs"]["float32"],
        "max_abs_err_bf16": attention_report["errs"]["bfloat16"],
    }
    scalar_first = ("; first_ms: the same shapes through the scalar route (the first version); "
                    "ms_by_route: ms (tiled) and first_ms (scalar)")
    x3d_timing = per_forward(x3d_rows, extra=("first_ms",))
    csn_rows = csn_kernel["per_shape"]
    csn_counts = resnets["csn_r101"]["counts"]
    entries = [
        {
            "name": "depthwise3x3x3_bn_swish",
            "route": "cuda",
            "source": "pytorchvideo_tpu_torch/csrc/depthwise_conv.cu",
            "replaces": "pytorchvideo_tpu/ops/depthwise_conv.py:132",
            "launches": x3d_counts["depthwise3x3x3_bn_swish"],
            "launches_by_route": by_route(x3d_counts, "depthwise3x3x3_bn_swish"),
            "path": "x3d_s deploy bf16 13x160x160, B1/8/128",
            "max_abs_err": max([*kernel_report["errs"].values(), *csn_kernel["errs"].values(),
                                *(t["max_abs_err"] for t in x3d_rows + csn_rows)]),
            "max_abs_err_f32": kernel_report["errs"]["float32"],
            "max_abs_err_bf16": kernel_report["errs"]["bfloat16"],
            **x3d_timing,
            "ms_by_route": by_route_ms(x3d_rows),
            "first_version_ratio": x3d_timing["ms"] / x3d_timing["first_ms"],
            "timing": "bf16 swish, " + timing.format(128) + " (22 stride-1 conv_b)"
                      + scalar_first + "; bound: bytes at the HBM rate, FMAs at the CUDA "
                                       "cores' f32 peak",
            "library": "F.conv3d(groups=C) alone",
            "per_shape": x3d_rows,
            "csn_r101": {
                "launches": csn_counts["depthwise3x3x3_bn_swish"],
                "launches_by_route": by_route(csn_counts, "depthwise3x3x3_bn_swish"),
                "path": "csn_r101 deploy bf16 32x224x224, B1/8 (bias only, swish off)",
                "max_abs_err": max([*csn_kernel["errs"].values(),
                                    *(t["max_abs_err"] for t in csn_rows)]),
                "max_abs_err_f32": csn_kernel["errs"]["float32"],
                "max_abs_err_bf16": csn_kernel["errs"]["bfloat16"],
                **per_forward(csn_rows),
                "timing": "bf16 bias only, " + timing.format(CSN_TIMING_BATCH)
                          + " (30 stride-1 conv_b); bound: bytes at the HBM rate, FMAs at "
                            "the CUDA cores' f32 peak",
                "serving": {B: {"clips_per_s": r["clips_per_s"], "peak_bytes": r["peak_bytes"]}
                            for B, r in resnets["csn_r101"]["rates"].items()},
                "per_shape": csn_rows,
            },
        },
        {
            "name": "pooled_attention_packed",
            "replaces": "pytorchvideo_tpu/ops/pooled_attention.py:487",
            "launches": mvit["counts"]["pooled_attention_packed"],
            "launches_by_route": by_route(mvit["counts"], "pooled_attention_packed"),
            "path": "mvit_base_16x4 deploy bf16 16x224x224, B1/8/32",
            **attention_common,
            **per_forward(attention_report["packed"], extra=("first_ms",)),
            "ms_by_route": route_sums(attention_report["packed"]),
            "timing": "bf16, residual off, " + timing.format(MVIT_TIMING_BATCH)
                      + " (16 grid and 16 cls queries)" + first,
            "library": "F.scaled_dot_product_attention on (B, H, L, c) views",
            "per_shape": attention_report["packed"],
        },
        {
            "name": "pooled_attention",
            "replaces": "pytorchvideo_tpu/ops/pooled_attention.py:312",
            "launches": pool_first["counts"]["pooled_attention"],
            "launches_by_route": by_route(pool_first["counts"], "pooled_attention"),
            "path": "mvit_base_16x4(pool_first=True) deploy bf16 16x224x224, B4",
            **attention_common,
            **per_forward(attention_report["per_head"], extra=("first_ms",)),
            "timing": "bf16, residual off, " + timing.format(MVIT_TIMING_BATCH)
                      + " (16 per-head launches, cls row included)" + first,
            "library": "F.scaled_dot_product_attention",
            "per_shape": attention_report["per_head"],
        },
        {
            "name": "token_pool",
            "route": "cuda",
            "source": "pytorchvideo_tpu_torch/csrc/token_pool.cu",
            "replaces": "pytorchvideo_tpu/ops/token_pool.py:242",
            "launches": mvit["counts"]["token_pool_conv"] + mvit["counts"]["token_pool_max"],
            "launches_by_mode": {m: mvit["counts"][f"token_pool_{m}"]
                                 for m in ("conv", "max", "avg")},
            "launches_by_route": pool_routes(mvit["counts"], ("token_pool_conv", "token_pool_max")),
            "path": "mvit_base_16x4 deploy bf16 16x224x224, B1/8/32",
            "max_abs_err": max([*pool_report["errs"].values(), pool_report["timed_err"]]),
            "max_abs_err_f32": pool_report["errs"]["float32"],
            "max_abs_err_bf16": pool_report["errs"]["bfloat16"],
            **per_forward(pool_rows, extra=("first_ms",)),
            "ms_by_route": by_route_ms(pool_rows),
            "timing": "bf16, " + timing.format(MVIT_TIMING_BATCH)
                      + " (35 conv and 3 max pools; the avg mode apart)" + scalar_first,
            "library": "F.conv3d(groups=C) / F.max_pool3d / F.avg_pool3d",
            "avg_mode_per_shape": pool_report["rows"]["avg"],
            "per_shape": pool_rows,
        },
    ]
    step_timing = "per step at B{}: each shape's time times its launches, summed".format(
        TRAIN_BATCH)
    train_path = (f"mvit_base_16x4 train bf16 16x224x224 (classification_mvit_16x4), "
                  f"B{TRAIN_BATCH} and B{PRESET_BATCH}, {TRAIN_TIMED_STEPS} timed steps each")

    def bwd_errors(report) -> dict:
        # Absolute, and relative to the largest reference gradient.
        errs = report["errs"]
        total = worse(*errs.values(), report["timed_err"])
        return {"max_abs_err": total[0], "max_rel_err": total[1],
                "max_abs_err_f32": errs["float32"][0], "max_rel_err_f32": errs["float32"][1],
                "max_abs_err_bf16": errs["bfloat16"][0], "max_rel_err_bf16": errs["bfloat16"][1],
                "plain_vs_autograd_f32": report["autograd_err"]}

    attention_bwd_common = {
        "route": "cuda",
        "source": "pytorchvideo_tpu_torch/csrc/pooled_attention_bwd.cu",
        **bwd_errors(attention_bwd),
        "library": "F.scaled_dot_product_attention forward + backward (torch.autograd.grad): "
                   "the same (dq, dk, dv) from q, k, v and g; library_bwd_ms: its backward "
                   "alone (retain_graph, one forward kept)",
    }
    bwd_first = ("; first_ms: the same shapes through the CUDA-core kernels (the first "
                 "version, bf16's route before the tensor-core and split-key routes)")
    pool_bwd_common = {
        "route": "cuda",
        "source": "pytorchvideo_tpu_torch/csrc/token_pool_bwd.cu",
        **bwd_errors(pool_bwd),
        "path": train_path,
        "timing": "bf16, " + step_timing + " (35 conv pools)" + scalar_first,
    }
    entries += [
        {
            "name": "pooled_attention_packed_bwd",
            "replaces": "pytorchvideo_tpu/ops/pooled_attention.py:579",
            "launches": trained["counts"]["pooled_attention_packed_bwd"],
            "launches_by_route": by_route(trained["counts"], "pooled_attention_packed_bwd"),
            "path": train_path,
            **attention_bwd_common,
            **per_forward(attention_bwd["packed"], extra=("first_ms", "library_bwd_ms")),
            "ms_by_route": route_sums(attention_bwd["packed"]),
            "timing": "bf16, residual off, " + step_timing + " (16 grid and 16 cls queries)"
                      + bwd_first,
            "per_shape": attention_bwd["packed"],
        },
        {
            "name": "pooled_attention_bwd",
            "replaces": "pytorchvideo_tpu/ops/pooled_attention.py:411",
            "launches": trained["pool_first_counts"]["pooled_attention_bwd"],
            "launches_by_route": by_route(trained["pool_first_counts"], "pooled_attention_bwd"),
            "path": f"mvit_base_16x4(pool_first=True) train bf16 16x224x224 through "
                    f"app.train() at B{PRESET_BATCH}: the captured step's warm-up updates, "
                    f"capture and one replay",
            **attention_bwd_common,
            **per_forward(attention_bwd["per_head"], extra=("first_ms", "library_bwd_ms")),
            "ms_by_route": route_sums(attention_bwd["per_head"]),
            "timing": "bf16, residual off, " + step_timing
                      + " (16 per-head launches, cls row included)" + bwd_first,
            "per_shape": attention_bwd["per_head"],
        },
        {
            "name": "token_pool_dw",
            "replaces": "pytorchvideo_tpu/ops/token_pool.py:450",
            "launches": trained["counts"]["token_pool_dw"],
            "launches_by_route": pool_routes(trained["counts"], ("token_pool_dw",)),
            **pool_bwd_common,
            **per_forward(pool_bwd["rows"]["dw"], extra=("first_ms",)),
            "ms_by_route": by_route_ms(pool_bwd["rows"]["dw"]),
            "library": "aten.convolution_backward of F.conv3d(groups=C), weight gradient",
            "per_shape": pool_bwd["rows"]["dw"],
        },
        {
            "name": "token_pool_dx",
            "replaces": "pytorchvideo_tpu/ops/token_pool.py:501",
            "launches": trained["counts"]["token_pool_dx"],
            "launches_by_route": pool_routes(trained["counts"], ("token_pool_dx",)),
            **pool_bwd_common,
            **per_forward(pool_bwd["rows"]["dx"], extra=("first_ms",)),
            "ms_by_route": by_route_ms(pool_bwd["rows"]["dx"]),
            "library": "aten.convolution_backward of F.conv3d(groups=C), input gradient",
            "per_shape": pool_bwd["rows"]["dx"],
        },
    ]
    fused_rows = fused_report["rows"]
    pool_ln_rows = fused_report["pool_ln_rows"]
    pool_ln_timing = per_forward(pool_ln_rows, extra=("first_ms",))
    entries += [
        {
            "name": "fused_kvpool_attention",
            "route": "cuda",
            "source": "pytorchvideo_tpu_torch/csrc/fused_kvpool_attention.cu",
            "replaces": "pytorchvideo_tpu/ops/fused_kvpool_attention.py:288",
            "launches": fused["counts"]["fused_kvpool_attention"],
            "launches_train": fused_trained["counts"]["fused_kvpool_attention"],
            "attention_launches_by_route": by_route(fused["counts"], "pooled_attention_packed"),
            "path": "mvit_base_16x4(fused_kvpool=True) deploy bf16 16x224x224, B1/8/32; its "
                    f"training, B{TRAIN_BATCH} and B{PRESET_BATCH}",
            "max_abs_err": max([*fused_report["errs"].values(), fused_report["timed_err"]]),
            "max_abs_err_f32": fused_report["errs"]["float32"],
            "max_abs_err_bf16": fused_report["errs"]["bfloat16"],
            "bf16_whole_op_vs_plain_f32": fused_report["bf16_end_to_end"],
            **per_forward(fused_rows, extra=("pool_ln_ms", "unfused_ms", "handover_ms")),
            "timing": "bf16, residual off, " + timing.format(MVIT_TIMING_BATCH)
                      + " (16 blocks); ms: the op as the layer calls it (cls rows normed, the "
                        "pool-LN launch, the grid and cls attention); pool_ln_ms: the pool-LN "
                        "launch alone; unfused_ms: the unfused kernel path; handover_ms: the k "
                        "and v buffers written and read once at the HBM rate (computed)",
            "library": "F.conv3d(groups=C) + F.layer_norm + torch.cat + "
                       "F.scaled_dot_product_attention (grid and cls queries)",
            "serving": {B: {"clips_per_s": r["clips_per_s"],
                            "unfused_clips_per_s": fused["unfused_rates"][B]["clips_per_s"]}
                        for B, r in fused["rates"].items()},
            "training": {B: {"ms_per_step": r["ms_per_step"], "peak_bytes": r["peak_bytes"],
                             "unfused_ms_per_step": trained["rates"][B]["ms_per_step"],
                             "unfused_peak_bytes": trained["rates"][B]["peak_bytes"]}
                         for B, r in fused_trained["rates"].items()},
            "per_shape": fused_rows,
        },
        {
            "name": "fused_kvpool_ln",
            "route": "cuda",
            "source": "pytorchvideo_tpu_torch/csrc/fused_kvpool_attention.cu",
            "replaces": "pytorchvideo_tpu/ops/fused_kvpool_attention.py:133",
            "launches": fused["counts"]["fused_kvpool_attention.tiled"],
            "launches_by_route": by_route(fused["counts"], "fused_kvpool_attention"),
            "launches_train_by_route": by_route(fused_trained["counts"], "fused_kvpool_attention"),
            "path": "the pool-LN launch of the fused op (#8's pool phase, `_pool_ln_plane`) on "
                    "mvit_base_16x4(fused_kvpool=True) deploy bf16 16x224x224, B1/8/32",
            "max_abs_err": max(r["max_abs_err"] for r in pool_ln_rows),
            **pool_ln_timing,
            "ms_by_route": by_route_ms(pool_ln_rows),
            "first_version_ratio": pool_ln_timing["ms"] / pool_ln_timing["first_ms"],
            "timing": "bf16, " + timing.format(MVIT_TIMING_BATCH) + " (16 blocks; k and v in "
                      "one launch)" + scalar_first + "; bound: the k and v positions some output "
                      "reads and the (1 + Lk) rows written, once in bf16 at the HBM rate, FMAs "
                      "at the CUDA cores' f32 peak",
            "library": "F.conv3d(groups=C) + F.layer_norm + torch.cat (k and v)",
            "per_shape": pool_ln_rows,
        },
        {
            "name": "attention_nopad",
            "route": "cuda",
            "source": "pytorchvideo_tpu_torch/csrc/pooled_attention.cu",
            "replaces": "benchmarks/mvit_micro.py:193",
            "launches": pool_first["counts"]["pooled_attention"],
            "launches_by_route": by_route(pool_first["counts"], "pooled_attention"),
            "path": "the per-head kernel (kernel #2's port, which pads neither Lq nor Lk); its "
                    "launches on mvit_base_16x4(pool_first=True) deploy, B4",
            "max_abs_err": max(r["max_abs_err"] for r in nopad_rows),
            **per_forward(nopad_rows, extra=("first_ms",)),
            "timing": "bf16, residual on, the four shapes of benchmarks/mvit_micro.py:236-241 "
                      "at B16, one call each, summed" + first,
            "library": "F.scaled_dot_product_attention + q",
            "per_shape": nopad_rows,
        },
    ]
    # The launches of the captured step, read over single updates of a new
    # one: a warm-up update, the capture and each replay after it.
    capture_paths = {
        "unfused": (captured["mvit"][f"mvit_base_16x4 B{TRAIN_BATCH}"]["capture_reading"],
                    f"phase 19: mvit_base_16x4 train bf16 B{TRAIN_BATCH}"),
        "fused": (captured["mvit"][f"mvit_base_16x4 fused_kvpool B{TRAIN_BATCH}"]
                  ["capture_reading"],
                  f"phase 19: mvit_base_16x4(fused_kvpool=True) train bf16 B{TRAIN_BATCH}"),
        "pool_first": (trained["pool_first_reading"],
                       f"phase 10: mvit_base_16x4(pool_first=True) train bf16 B{PRESET_BATCH}, "
                       f"through app.train()"),
    }
    captured_wrappers = {
        "pooled_attention_packed": ("unfused", ("pooled_attention_packed",)),
        "pooled_attention": ("pool_first", ("pooled_attention",)),
        "token_pool": ("unfused", ("token_pool_conv", "token_pool_max")),
        "pooled_attention_packed_bwd": ("unfused", ("pooled_attention_packed_bwd",)),
        "pooled_attention_bwd": ("pool_first", ("pooled_attention_bwd",)),
        "token_pool_dw": ("unfused", ("token_pool_dw",)),
        "token_pool_dx": ("unfused", ("token_pool_dx",)),
        "fused_kvpool_attention": ("fused", ("fused_kvpool_attention",)),
        "fused_kvpool_ln": ("fused", ("fused_kvpool_attention.tiled",)),
        "attention_nopad": ("pool_first", ("pooled_attention",)),
    }
    for entry in entries:
        if entry["name"] in captured_wrappers:
            path, names = captured_wrappers[entry["name"]]
            reading, where = capture_paths[path]
            entry["captured_step"] = {
                "launches_per_warmup_update": sum(reading["warm_up"][n] for n in names),
                "launches_at_capture": sum(reading["capture"][n] for n in names),
                "launches_per_replay": [sum(r[n] for n in names) for r in reading["replays"]],
                "path": where}
    # The launches of one SimCLR step on MViT-B (phase 22 (d)), two views.
    ssl_counts = ssl["mvit_simclr"]["counts"]
    ssl_wrappers = {
        "pooled_attention_packed": ("pooled_attention_packed",),
        "token_pool": ("token_pool_conv", "token_pool_max"),
        "pooled_attention_packed_bwd": ("pooled_attention_packed_bwd",),
        "token_pool_dw": ("token_pool_dw",),
        "token_pool_dx": ("token_pool_dx",),
    }
    for entry in entries:
        if entry["name"] in ssl_wrappers:
            entry["ssl_step"] = {
                "launches": sum(ssl_counts[n] for n in ssl_wrappers[entry["name"]]),
                "path": f"phase 22 (d): SimCLR on mvit_base_16x4 f32 16x224x224, B{SSL_MVIT_BATCH}, "
                        f"one step of two views through make_simclr_train_step"}
    # Phase 23's paths: the efficient X3D's eager forwards (#1), the int8 and
    # the BatchNorm MViT-B's forwards (#4, #6).
    eff = extras["efficient_x3d"]
    mvit_paths = {
        "int8_mvit": (extras["int8"]["counts"],
                      f"phase 23 (d): int8_serving_fn(mvit_base_16x4 deploy bf16), one B"
                      f"{INT8_CHECK_BATCH} forward (then captured at B1/8/32, as phase 17)"),
        "bn_mvit": (extras["bn_mvit"]["per_forward"],
                    f"phase 23 (g): convert_to_deployable_form(fuse_bn_mvit(mvit_base_16x4("
                    f"norm='batchnorm'))) bf16, one B{MVIT_CHECK_BATCH} forward"),
    }
    phase23_wrappers = {"pooled_attention_packed": ("pooled_attention_packed",),
                        "token_pool": ("token_pool_conv", "token_pool_max")}
    for entry in entries:
        if entry["name"] == "depthwise3x3x3_bn_swish":
            entry["efficient_x3d"] = {
                "launches": eff["counts"]["depthwise3x3x3_bn_swish"],
                "launches_by_route": by_route(eff["counts"], "depthwise3x3x3_bn_swish"),
                "path": "phase 23 (a): efficient_x3d_s().convert() bf16 13x160x160, eager, "
                        "B1/8/128 (22 a forward)",
                "serving": eff["rates"]}
        for key, (counts, path) in mvit_paths.items():
            if entry["name"] in phase23_wrappers:
                entry[key] = {"launches": sum(counts[n] for n in phase23_wrappers[entry["name"]]),
                              "path": path}
    # Phase 25: the data-parallel MViT-B step's launches (a), and the
    # sequence-parallel body's shards (c).
    dp_reading = parallel["mvit"]["reading"]
    sequence = parallel["sequence"]
    B, Lq, Lk, HC, H = SP_SHAPE
    sp_path = (f"phase 25 (c): sequence_parallel_body, {SP_RANKS} shards of Lq {Lq // SP_RANKS} "
               f"(MViT-B 32x3's first stage, B{B} Lq {Lq} Lk {Lk} H*c {HC}, {H} head), kv "
               f"replicated and gathered, f32 and bf16")
    for entry in entries:
        if entry["name"] in ssl_wrappers:
            names = ssl_wrappers[entry["name"]]
            entry["data_parallel_step"] = {
                "launches_per_warmup_update": sum(dp_reading["warm_up"][n] for n in names),
                "launches_at_capture": sum(dp_reading["capture"][n] for n in names),
                "launches_per_replay": [sum(r[n] for n in names) for r in dp_reading["replays"]],
                "path": f"phase 25 (a): mvit_base_16x4 train bf16 B{DP_MVIT_BATCH} through the "
                        f"data-parallel app on a one-rank NCCL group, the all-reduce captured"}
        if entry["name"] in ("pooled_attention_packed", "pooled_attention_packed_bwd"):
            errs = sequence["errs"]
            entry["sequence_parallel"] = {
                "launches": sequence["launches"][entry["name"]],
                "launches_by_route": by_route(sequence["launches_by_route"], entry["name"]),
                "path": sp_path,
                "routes": sequence["routes"],
                "max_abs_err": max(
                    max(e["forward_vs_plain"], e["forward_vs_one_call"])
                    if entry["name"] == "pooled_attention_packed" else e["backward_abs_rel"][0]
                    for key, e in errs.items() if isinstance(e, dict)),
                **({"timing": f"bf16, the {SP_RANKS} shards' calls summed (ms) against one "
                              f"call over all rows (one_call_ms)", **sequence["timing"]}
                   if entry["name"] == "pooled_attention_packed" else {})}
    # Phase 26: each MViT kernel on the tensor-parallel path and at its
    # local shapes.
    tensor_parallel_entries(entries, tensor)
    # Phase 29: #1 on the deployment walkthrough, #4 and #6 on the eval
    # harness's MViT-B.
    eval_counts = examples["eval"]["mvit_base_16x4"]["counts"]
    eval_path = ("phase 29 (a): eval_kinetics.evaluate on mvit_base_16x4 f32 16x224x224, 5x1 views "
                 "of 4 videos in batches of 8, and nothing else")
    for entry in entries:
        if entry["name"] == "depthwise3x3x3_bn_swish":
            entry["phase29"] = {
                "launches": examples["deployment"]["launches"],
                "launches_by_route": examples["deployment"]["launches_by_route"],
                "path": "phase 29 (b): accelerator_deployment.main([\"--device\", \"cuda\"]), "
                        "X3D-XS 4x160x160 B1: the efficient and hub deploy forms eager, "
                        "captured and transmuted, and the exported program"}
        elif entry["name"] == "pooled_attention_packed":
            entry["phase29"] = {"launches": eval_counts["pooled_attention_packed"],
                                "launches_by_route": by_route(eval_counts,
                                                              "pooled_attention_packed"),
                                "path": eval_path}
        elif entry["name"] == "token_pool":
            entry["phase29"] = {
                "launches": eval_counts["token_pool_conv"] + eval_counts["token_pool_max"],
                "launches_by_mode": {m: eval_counts[f"token_pool_{m}"]
                                     for m in ("conv", "max", "avg")},
                "launches_by_route": pool_routes(eval_counts,
                                                 ("token_pool_conv", "token_pool_max")),
                "path": eval_path}
    for entry in entries:
        assert entry["launches"] > 0, f"{entry['name']} never launched on its path"
    print(f"total {time.perf_counter() - t_start:.1f} s from the build on")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
