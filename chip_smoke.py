#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It exits non-zero, printing no result, when there is no card or no
``paddle_tpu_torch`` package beside it. No phase catches an exception.

Phases:

1. device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit (every time below stands beside them);
2. build: every source under ``paddle_tpu_torch/csrc/`` (the paged-attention,
   flash-attention and fused 1x1 conv kernels), one ``nvcc`` each for
   ``sm_90a``, all started together (seconds and ``-Xptxas -v`` lines
   printed, spill lines included); then each flash body (forward, dK/dV,
   dQ; bf16 and f32; every head dim) as the loaded library reports it:
   registers, local memory a thread (spills), static and dynamic shared
   memory and the CTAs an SM holds; then the same for K1's split-context
   and K2's key-split bodies (every head dim, over f32, bf16 and int8
   pools) and K4's bodies (bf16 wgmma at 64 and 128 tile columns, bf16
   WMMA, f32);
2b. ROADMAP C.14, bounded: in 8 fresh processes (four at a time), each
   under ``CUDA_LAUNCH_BLOCKING=1``, the first launch of each K1
   instantiation and shape the serving path makes, each checked against
   the plain version: K1 over the f32 pool, then over the bf16 and int8
   pools, then the flattened verify read (k 4); four at phase 3's seeded
   contexts and four at random ragged ones, every table entry a row reads
   up to ceil(context / 16) checked on the host to lie in [0, 256) first;
   the count of faulted processes printed, a fault fails the smoke;
3. kernels against their plain PyTorch versions at the decode-serving
   path's shapes (8 slots, 8 heads, head_dim 64, block 16, 256-block pool,
   24 blocks per sequence): K1 at ragged contexts up to the full 384 and
   at the served decode step's (contexts 128-188 on every slot), two
   launches bitwise equal; K2 at every prompt rung (1, 16, 64, 256), two
   launches bitwise equal; then K1 and K2 over bf16 and int8 pools (the
   KV cache's codec) at the same contexts and rungs, and the verify read
   of speculative decoding (k 4, f32, bf16 and int8, at the served
   contexts) against the plain multi-query version and each of its rows
   bitwise against a single-query K1 launch at context c + j; each launch
   synchronised and compared; then the device time (torch.profiler) of
   the kernel, the plain version and one PyTorch library call
   (``scaled_dot_product_attention`` on the gathered, dequantized view,
   timed only, never called by the port), CUDA-event times of the same
   calls back to back, and the least time the card could take (bytes over
   3.35 TB/s, the K and V rows at the pool's payload, or f32 operations
   over 67 TFLOP/s, whichever is larger);
3b. the flash-attention kernels (forward K3, backward K3b-dkv and K3b-dq)
   against their plain versions: at BERT-base's training shapes (B 128,
   H 12, S 128, D 64) in bf16 (the path's type) and f32 with no bias, in
   bf16 with a (B, 1, 1, S) mask bias that takes a gradient (so dS is
   written), and at TransformerLM's causal shape (B 8, H 8, S 512, D 64,
   f32); each chain of launches synchronised and compared, max |diff|
   printed beside its tolerance; rows that a ``finfo.min`` bias masks
   whole (bf16 at BERT-base's head shape, f32 causal) held to the JAX
   op's formulation (``fused_attention_ref``'s autograd, in f32); then
   device times of each kernel, the plain version and the library
   yardstick (``scaled_dot_product_attention`` forward, and its autograd
   backward for K3b; timed only, never called by the port) beside the
   bound (bytes over 3.35 TB/s, or operations over 989 TFLOP/s bf16 or 67
   TFLOP/s f32);
4. served path: ``TransformerLM(CausalLMConfig())`` at full width from a
   seed, behind the replica stack's ``ServingServer`` on port 0 (8 slots,
   prompts up to 256, up to 128 new tokens); 16 concurrent ``/generate``
   requests (half streamed), each finishing with its full budget; two
   streams held against the uncached ``greedy_generate`` under teacher
   forcing; the kernels' launch counts equal to decode steps x layers and
   prefills x layers; tokens/s, decode-step p50, prefill ms by rung and
   peak device memory; then a profiled window of decode steps with every
   slot active: host ms per step, device busy ms and idle share, K1's
   share of it, and the kernels that take the time;
5. training: ``BertForPretraining`` at BERT-base width and full depth (110 M
   parameters, ``use_fused_attention=True``, dropouts 0, 128 positions)
   from ``bert_init_params(cfg, seed)``, the batch ``bench.py`` makes (128
   sequences of 128, 15% MLM labels); the f32 loss through the fused model
   against a second instance with ``use_fused_attention=False`` (relative
   1e-4); then ``TrainStep(amp_dtype=torch.bfloat16)`` with ``Adam(1e-4)``:
   2 warm-up and 20 timed steps, each synchronised; every loss finite and
   the last below the first; seq/s, step p50, peak device memory and the
   model-FLOP share (``bench.py``'s count over 989 TFLOP/s); each flash
   kernel launched exactly 12 x the steps run; one profiled step: device
   busy ms, idle share, the top kernels and the flash kernels' share;
6. ResNet-50 training: ``ResNet50(class_dim=1000, data_format='NHWC')`` at
   full depth from ``resnet_init_params(50, 1000, 'NHWC', seed)``, the
   batch ``bench.py`` makes (128 images of N(0, 1) at 224x224, uniform
   labels in [0, 1000)); f32 checks first: its training-mode logits
   against an NCHW instance loaded with the same weights (relative 1e-4)
   and the s2d stem ConvBNLayer against the plain one (atol and rtol 1e-4,
   as the reference's test); then ``TrainStep(amp_dtype=torch.bfloat16)``
   with ``Momentum(0.1, momentum=0.9)``: 2 warm-up and 20 timed steps,
   each synchronised, every loss finite and the last below the first,
   every master parameter f32; images/s, step p50, min and max, peak
   device memory and the model-FLOP share (``bench.py``'s 12.3 GFLOP per
   image over 989 TFLOP/s); ``bench.py``'s s2d A/B (10 timed steps with
   ``stem_space_to_depth=True``); one profiled step: device busy ms, idle
   share, the top kernels and any NCHW/NHWC transpose kernels;
7. K4 (the fused 1x1 conv + BN + act kernel) against its plain version at
   every distinct (M, K, N) of the model's 33 stride-1 1x1 ConvBNLayers
   at batch 128 (which include ``tools/bench_fused_conv.py``'s four
   shapes), bf16 and f32, act None and relu: bf16 within one bf16 ulp,
   f32 within 1e-4 absolute and relative; device times of the kernel, the
   plain version and the library yardstick (``F.conv2d`` on the
   channels_last input with the weight pre-multiplied by scale and
   ``bias=shift``, then ``relu_``; timed only, never called by the port)
   beside the bound, kernel / library, and the body and tile the launcher
   chose, a row per shape. Then K4's path: the trained model in eval mode, the
   input and output of each of the 33 layers captured in one eval forward
   in f32 and one with the weights cast to bf16; each layer's BN folded
   into scale and shift and run through ``fused_conv1x1_bn_act``, held
   against the layer's own output (f32 atol and rtol 1e-4; bf16 within
   2**-5 of the sum of the magnitudes the layer rounds, see
   ``check_k4_on_model``); K4 launched exactly 33 times per pass, in
   bf16 all 33 through its wgmma body (that body's own counter);
8. the static graph: README's Fluid script, ``build_static_lenet``
   (MNIST LeNet at its published width, 431,080 parameters) with
   ``Adam(0.001)``, through ``Executor(CUDAPlace(0))`` on a seeded f32
   batch of 64; the first step's loss, accuracy and every ``@GRAD``
   against the same step on ``Executor(CPUPlace())`` from the card's
   startup values copied across (atol 1e-5, rtol 1e-4); then 2 warm-up and
   20 timed steps, each synchronised, every loss finite and the last below
   the first; one lowering of the main program for all of them and a
   second after one step at batch 32; steps/s, images/s, step p50, min and
   max, host dispatch ms and peak device memory; one profiled step: device
   busy ms, idle share, kernel launches and the top kernels. None of the
   port's kernels is on this path: every launch count stays 0;
9. the dygraph API: README's dygraph script at Transformer-big
   (``TransformerConfig.big(dropout=0.0, max_length=64)``, 6 + 6 layers at
   full width, about 275 M parameters) from
   ``transformer_init_params(cfg, seed)`` under ``guard(CUDAPlace(0))``,
   on bench.py's batch (64 x 64 source, target and label ids from
   ``RandomState(0)``): an f32 forward, loss and five parameters'
   gradients at batch 2 against the same weights under
   ``guard(CPUPlace())``; three steps of the user loop (``backward`` ->
   ``Adam(NoamDecay(1024, 4000)).minimize`` -> ``clear_gradients``), every
   loss finite and every rate the formula's; then
   ``TrainStep(amp_dtype=torch.bfloat16)`` with ``Adam(1e-4)``, 2 warm-up
   and 20 timed steps, each synchronised, every loss finite, the last
   below the first, every master an f32 Parameter: tokens/s by bench.py's
   count, step p50, min and max, host dispatch, peak device memory and the
   model-FLOP share (bench.py's FLOPs a token over 989 TFLOP/s); one
   profiled step (device busy ms, idle share, launches and the top
   kernels by kind); ``save_dygraph`` -> ``load_dygraph`` into a fresh
   model with identical logits; ``greedy_decode`` and
   ``beam_search_decode`` (beam 4, 16 new tokens) of two rows on the card
   and on the CPU from the trained weights, equal or parting only at a
   near tie; the host cost of the dygraph API per call. None of the
   port's kernels is on this path: every launch count stays 0;
10. ERNIE-base finetuning (``ErnieConfig.base``, dropouts 0, 128
   positions, 99.6 M parameters) from ``ernie_init_params(cfg, seed)``
   under ``guard(CUDAPlace(0))``: at batch 2 x 128 the f32 logits, loss
   and five parameters' gradients against the same weights under
   ``guard(CPUPlace())``, then one ``finetune_optimizer`` step (Adam with
   L2Decay 0.01, LinearLrWarmup over 100 steps, ``decorate``) on both,
   the parameters compared; an overflow step on the card (one gradient
   set to inf), which ``decorate`` skips and counts; then bench.py's loop
   at batch 64 x 128: bf16 ``TrainStep(accum_steps=4)``, 2 warm-up and 16
   timed calls, each synchronised: seq/s by bench.py's count, call p50,
   min and max, peak device memory and the model-FLOP share (bench.py's
   count over 989 TFLOP/s), no kernel of the port launched; one profiled
   merge of 4 calls (device busy ms, idle share, the top kernels); then
   ``use_fused_attention=True``: the f32 loss at batch 2 against the
   unfused model's (relative 1e-4), and the same loop for 2 warm-up and 4
   timed calls, K3, K3b-dkv and K3b-dq launched exactly 12 x the calls
   (their ``launches_ernie`` in the kernels line);
11. the static graph at scale: PaddleCV's ResNet-50 image-classification
   recipe (``tools/static_resnet.py``: 25.6 M parameters, 1000 classes,
   224^2, ``cross_entropy`` of the softmax, top-1/top-5 ``accuracy``,
   ``Momentum(piecewise_decay(...), 0.9, L2Decay(1e-4))``) through
   ``Executor(CUDAPlace(0))``: the first step at batch 8 against
   ``Executor(CPUPlace())`` from the card's startup values (f32, TF32
   off; loss, top-1, top-5, and five gradients within 4x the CPU's own
   spread at images moved by 1e-7); then 2 warm-up and 20
   timed steps at batch 128 through
   ``CompiledProgram(main).with_data_parallel(loss_name=...)``, each
   synchronised: every loss finite, the last below the first, the fetched
   rate ``piecewise_decay``'s, one lowering; images/s, step p50, min and
   max, host dispatch, peak device memory, the model-FLOP share
   (bench.py's count over 989 TFLOP/s, of an f32 step) and one profiled
   step; ``io.save_persistables`` and ``save_inference_model`` into a
   temporary directory, ``load_persistables`` back bit for bit; the saved
   model through ``load_inference_model`` + ``Executor`` and through
   ``inference.create_paddle_predictor`` on 20 batches of 128: within
   1e-5 of the in-memory test program, the Predictor equal to the loaded
   program bit for bit, one lowering each; eval images/s, batch p50 and
   one profiled batch. None of the port's kernels is on this path: every
   launch count stays 0;
12. the static control flow and PaddleNLP's PTB LSTM LM: ``cond``,
   ``case``, ``switch_case``, ``Switch``, ``IfElse``, ``While``,
   ``while_loop`` bounded (with a gradient) and unbounded, ``DynamicRNN``
   with lengths and the tensor arrays on ``Executor(CUDAPlace(0))``
   against ``Executor(CPUPlace())`` (f32, 1e-6); the LM
   (``tools/static_ptb_lm.py``, ``large``: 66,022,000 parameters,
   vocabulary 10,000, hidden 1,500, 2 layers, 35 steps) at batch 4 with
   dropout off, its first step against the CPU in f32 and float64 (loss
   and the 7 gradients in L2 norm against the CPU's f64 run, as phase
   11); then each route (``padding``: ``StaticRNN``; ``static``:
   ``layers.lstm``, its boundaries moved to steps 8 and 16) at batch 20,
   dropout 0.65, through ``CompiledProgram`` on one batch of seeded
   token ids with a Zipf skew: 3 warm-up and 20 timed steps, then
   untimed ones to 150, each synchronised and feeding the fetched last
   states back; every loss finite, the last below the first and the last
   window's median below the first's, the fetched rate
   ``piecewise_decay``'s, one lowering; tokens/s, step p50, min and max
   over the timed steps, host dispatch and its cost
   an op, the forward's dispatch alone, peak device memory, the
   model-FLOP share (214.2 GFLOP a step over 989 TFLOP/s) and one
   profiled step (busy, idle share, launches and the top kernels by
   kind). None of the port's kernels is on this path: every launch count
   stays 0;
13. PaddleNLP's attention seq2seq (``tools/static_seq2seq.py``, IWSLT'15
   en-vi: vocabularies 17,191 and 7,709, hidden 512, 2 + 2 LSTM layers,
   26,927,616 parameters) through ``Executor(CUDAPlace(0))``: its first
   step at batch 8, dropout off, against the CPU in f32 and float64 (loss
   and the 13 gradients in L2 norm against the CPU's f64 run, as phase
   11; 0.9x the card's gradients must fail); then batch 128 of one seeded
   batch of sentence pairs (lengths 10-50, the recipe's </s> padding to
   50 and 49 positions), dropout 0.2, ``Adam(0.001)`` with the global-norm
   clip at 5: 3 warm-up and 20 timed steps, then untimed ones to 40, each
   synchronised; every loss finite, the last below the first, one
   lowering; target tokens/s, step p50, min and max, host dispatch and
   its cost an op, peak device memory and one profiled step; then
   ``infer.py``'s beam search (beam 10, 100 steps) over the trained
   parameters: the card's ids against the CPU's at batch 2 (equal, or
   parted at a near tie of the step scores), and batch 128 timed:
   sentences/s, ms a decode step and one profiled decode. None of the
   port's kernels is on this path: every launch count stays 0;
14. static mixed precision and recompute: PaddleCV's ResNet-50 recipe as
   phase 11 builds it (full width, batch 128 at 224^2, NCHW, through
   ``CompiledProgram``, Momentum on ``piecewise_decay``, L2Decay(1e-4)):
   (a) under ``decorate(dtype='bfloat16')``, its step at batch 8 on the
   card against ``Executor(CPUPlace())`` from the same values, each held to
   the CPU's float64 run without casts (the card's error within 3x the
   CPU's plus 2u, u = 2**-8, at the loss and the head's gradients; the root
   mean square over all gradients within 2x plus 2u and over a third; 0.9x
   the card's gradients must fail), then 2 warm-up and 20 timed steps:
   images/s, step p50, min and max, host dispatch, peak memory, a profiled
   step (which must record device time) and the share of its convolution
   time in bf16 kernels, every master parameter f32; (b) the recipe's
   ``--use_fp16`` path (``--scale_loss=128.0
   --use_dynamic_loss_scaling=True``), the same loop, then two steps fed
   images of inf (the parameters and velocities bit for bit, the scale and
   counts by the reference's rule, ``overflow_steps()`` 1 then 2) and a
   finite step that moves them; (c) f32 with ``RecomputeOptimizer`` at the
   16 bottleneck outputs: three steps' loss and gradients against two plain
   runs from the same values (within twice their distance plus 1e-6), peak
   memory against the plain run's and phase 11's, step p50; (d) (a)'s eval
   clone on phase 11's 20 eval batches, and its saved model through
   ``create_paddle_predictor(Config(dir).enable_bf16())``: the clone's
   logits within 3u of their largest entry from the f32 eval program's (one
   bottleneck's last convolution scaled by 0.9 must fail that), the bf16
   Predictor bit for bit the f32 Predictor on bf16-rounded images, within
   2**-5 of its largest entry on the raw ones, one lowering each; (e)
   PaddleNLP's attention seq2seq as phase 13 trains it, under
   ``decorate(dtype='bfloat16')`` (the casts inside ``__scan__``'s
   sub-blocks): 3 warm-up and 20 timed steps, then untimed ones to 40,
   target tokens/s, busy, idle and peak memory. None of the port's kernels
   is on this path: every launch count stays 0;
15. the IR passes (ROADMAP A.8d) and in-place state with early freeing
   (A.8f): PaddleCV's ResNet-50 recipe as phase 11 builds it (full width,
   batch 128 at 224^2, NCHW, Momentum on ``piecewise_decay``,
   L2Decay(1e-4)) through ``CompiledProgram`` with
   ``fuse_elewise_add_act_ops``, ``fuse_all_optimizer_ops`` and
   ``enable_inplace`` set ('fused') against ``CompiledProgram`` with
   ``enable_inplace=False`` under ``PADDLE_TPU_PASSES=0`` ('plain'), in one
   process from the same values on the same batch: the ops a step before
   and after the pipeline; 3 steps of each under cuDNN's deterministic
   algorithms, the losses and every persistable bit for bit; then 2
   warm-up and 20 timed steps of each with the default algorithms, the
   first step's losses within phase 11's 1e-4: losses, step p50, busy,
   idle, launches a step, peak memory and the plan's env high-water; the
   plain run with a plan that frees nothing for its peak and high-water;
   then the static LeNet with ``Adam`` (phase 8's script) fused and plain,
   the same checks and its launches a step;
16. the served variants (ROADMAP A.5, A.6): phase 4's seeded mix through
   the replica stack at full width four more times, (a) with speculative
   decoding and the n-gram drafter, (b) with speculative decoding and the
   target model as its own draft model (acceptance near 1), (c) over a
   bf16 pool and (d) over an int8 pool: every request its full budget, K1
   launched (decode steps + verify rounds) x layers and K2 prefills x
   layers in each run, two streams under teacher forcing through the f32
   model (the near-tie rule for (a) and (b); for (c) and (d) a limit
   derived from the storage's half step, ``QUANT_HALF_STEP``); tokens/s,
   decode-step p50, verify rounds, acceptance, the greedy match rate
   against phase 4's f32 streams, peak memory and the pool's bytes; one
   profiled window of verify rounds or decode steps each (host ms, busy
   ms, idle share);
17. the serving tier (ROADMAP A.7a): a seeded shared-system-prompt mix
   (16 greedy requests, one 192-token system prompt of 12 whole blocks,
   distinct 16-64-token suffixes, budgets 32-64; the first request alone,
   then the other 15 at once, streamed over HTTP) through the replica
   stack at full width six ways: (a) prefix cache off, (b) on, (c) on with
   speculative decoding (k 4, n-gram; the suffix fill rides verify
   rounds), (d) disaggregated prefill on a prefill engine on the same
   card, (e) on with a host tier, its cap lowered below the system prompt
   after the first request so the second wave reinjects spilled blocks,
   (f) two replica processes (cache on) behind the ``Router``, one killed
   with SIGKILL once a stream on it has a token. Each: tokens/s, time to
   first token p50 and p90 at the client, decode-step p50, K1 and K2
   launches against decode steps and prefills x layers, hits, misses and
   tokens saved, handoff bytes and seconds, spills and reinjects, the
   router's completed, rerouted and failed counts. (b) and (c) equal (a)
   token for token or part at a near tie; (d)'s handed-over blocks equal
   a colocated prefill's bit for bit, and its streams (a)'s; (e)'s
   streams equal (b)'s bit for bit; in (f) only streams with a token from
   the killed replica fail, every other request completes with (b)'s
   tokens, and the lost ones, sent again, too;
18. the Fluid script surface (ROADMAP A.13): PaddleBook's recognize_digits
   (``tools/recognize_digits.py``: ``build_static_lenet``'s LeNet, batch
   64, Adam 1e-3) through ``import paddle_tpu_torch.fluid as fluid``: (a)
   ``fluid.install_check.run_check()`` on the card; (b)
   ``contrib.Trainer(place=CUDAPlace(0))`` for 200 steps on seeded
   synthetic digits in MNIST's row format, ``feed_order=['img',
   'label']``, checkpoints every 50 steps keeping 2, an ``EndStepEvent``
   handler accumulating ``fluid.metrics.Accuracy`` and
   ``fluid.average.WeightedAverage`` (each equal to the mean of the
   fetched values within 1e-12), ``test`` over 10 batches,
   ``save_params``, ``save_inference_model`` (reloaded) and
   ``contrib.Inferencer`` against the test program on the same batch
   within 1e-6; (c) the same LeNet through a plain ``Executor.run`` loop
   on a pre-stacked batch: both loops' step p50, busy and idle share, and
   ``DataFeeder.feed``'s host time a batch; (d) ``FLAGS_check_nan_inf``:
   step p50 with the fetch scan on and off, and a NaN pixel raising
   ``FloatingPointError`` naming the loss; (e) ``contrib.summary``'s
   parameter and FLOP totals, ``op_freq_statistic``'s top ops,
   ``memory_usage(program, 64)``, and ``device_memory_stats()``'s peak
   against ``torch.cuda.max_memory_allocated()``; no kernel of the port
   launched;
19. the stateless serving path (ROADMAP A.7b) and the observability core
   (A.11): PaddleCV's ResNet-50 inference model (``tools/static_resnet.py``
   at full width, 1000 classes, 224^2, weights from the seed, saved with
   ``save_inference_model``) behind ``InferenceEngine(max_batch_size=32)``
   (ladder 1-32), in f32 and through ``Config.enable_bf16()``: (a) the
   engine alone: each rung's first-run seconds; at each rung a seeded batch
   against ``Predictor.run`` on the same rows and each row alone (max
   |diff| and whether bit for bit, within ``STATELESS_ROW_TOL``);
   ``Predictor.run`` at batch 32: images/s and p50, the ceiling; (b)
   ``MicroBatcher(batch_timeout_ms=2)`` under 64 closed-loop clients, 2048
   one-row requests: images/s, latency p50 and p99, queue wait p50, the
   batch rows, padding waste, a profiled window's busy ms and idle share,
   every row against its row alone; (c) f32 only: ``ServingServer`` on
   port 0, 8 clients x 8 one-row ``POST /predict`` requests (rows against
   (b)'s), latency p50, the parse of a body timed apart from compute, one
   400, 429 and 504, then ``GET /metrics`` against the clients' counts and
   the batches run; no kernel of the port launched. Two more parts run
   inside earlier phases: (d) in phase 4, the decode server's
   ``/metrics`` over its 16 requests (decode steps x layers = K1's
   launches, prefills x layers = K2's, tokens generated = tokens
   streamed) and the decode step's p50 with telemetry off, on, on, off and
   with the metric hooks stubbed, on, on, stubbed; (e) at the end of phase
   17 (f), the router's ``/metrics/fleet`` against the live replica's own
   ``/metrics``;
20. the optimizer surface (ROADMAP A.4b): (a) BERT-base pretraining at
   phase 5's configuration (batch 128 x 128, bf16 AMP, fused attention)
   with ``Lamb(1e-3, lamb_weight_decay=0.01, epsilon=1e-6)``, LayerNorm's
   parameters and the biases excluded from weight decay, 2 + 20 steps:
   losses finite and falling, step p50, seq/s, busy and idle share and the
   peak beside phase 5's Adam run, the flash kernels launched layers x
   steps; (b) the same with ``TrainStep(remat=True)`` (each encoder layer
   recomputed in the backward), 2 + 10 steps: the peak, p50 and busy
   against (a)'s, the forward's kernel twice a layer a step,
   and the first call's loss and gradients against those without remat
   from the same weights and batch; (c) 6 calls with ``accum_steps=2``,
   snapshotted after call 3 (mid merge) and restored into a fresh model:
   calls 4-6 against the run that never stopped (bit for bit or not, and
   the max |diff|); (d) PaddleCV's static ResNet-50 with the LARS recipe
   (``tools/static_resnet.py optimizer='lars'``, batch 128, the schedule
   over a run of 20 steps as the example sets it) plain (a
   ``lars_momentum`` op a parameter) and fused (one
   ``fused_lars_momentum`` a group): the rate fetched against the warm-up,
   3 losses each within phase 11's bound, ops and launches a step,
   images/s, busy; (e) each rule at BERT-base's 109.8 M f32 parameters,
   one seeded gradient: the class's multi-tensor update against the
   per-parameter plain update (max |diff|), the device ms of one update
   (torch.profiler) and the host clock's beside its bound (the bytes it
   must move a parameter, at HBM_BYTES_PER_S); no
   kernel of the port launched in (d) and (e);
21. the rest of the dygraph layers and the vision models (ROADMAP A.4c,
   ``models/vision.py``), each on one seeded batch through
   ``tools/vision_recipes.py``: (a) MobileNetV2 (scale 1.0, 1000 classes,
   batch 128 at 224^2) in bf16 AMP and in f32, 2 + 20 synchronised steps:
   losses finite and falling, p50, min, max, images/s, peak memory, busy
   and idle share over a profiled step and its device time by kind
   (depthwise conv, other conv, every elementwise kernel, every
   reduction, the update), and its BatchNorms' own device time, replayed
   at the step's shapes and types; (b) MobileNetV1 (batch 128) and VGG-16 with
   BatchNorm (batch 64), bf16, 2 + 10 steps each; (c) TSM over ResNet-50
   (400 classes, 16 clips of 8 frames), bf16, 2 + 10 steps, clips/s and
   ``temporal_shift``'s device ms a step; (d) the DCGAN (z 100, base 64,
   batch 128) for 50 alternating iterations: p50, busy, idle, finite
   losses, and no discriminator update that saw the generator's
   gradients; (e) every A.4c layer and new op on the card against the
   same code on the CPU, forward and gradients, each max |diff| beside its
   tolerance (Conv3D and Conv3DTranspose at (8, 64, 16, 56, 56), GroupNorm
   at (32, 256, 56, 56), SpectralNorm of (512, 4608), NCE over 100,000
   classes, the activations at their breakpoints, ...); (f) no kernel of
   the port launched;
22. a ``{"kernels": [...]}`` line (K1 and K2 over each pool, the verify
   read, the flash kernels and K4, each with its launches on its path and
   those of phases 12-21) and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 dense on the tensor cores
ATOL, RTOL = 2e-5, 1e-5         # f32, sums in another order
# flash kernels against their plain versions, (atol, rtol): f32 as above
# for O and the log-sum-exp, 1e-4 for gradients (sums of up to S * D f32
# products in another order); bf16 output of both is one rounding of an
# f32 sum (the kernels carry P and dS as two bf16 terms, about 16 bits),
# so they differ by about one bf16 ulp (at most 2**-7 relative)
FLASH_TOL = {'f32': {'o': (ATOL, RTOL), 'grad': (1e-4, 1e-4)},
             'bf16': {'o': (1e-3, 8e-3), 'grad': (1e-3, 8e-3)}}
NEAR_TIE = 1e-3                 # served token's logit vs its row's max
TIMED_LAUNCHES = 200

# kernel shapes of the decode-serving path (replica ENGINE_DEFAULTS)
S, H, D, BS, NB, MAX_BPS = 8, 8, 64, 16, 256, 24
# K1's contexts: ragged up to the full 384, and the profiled decode step's
# (every slot active, prompts of 128 and up to 60 tokens decoded)
DECODE_CONTEXTS = [1, 17, 384, 100, None, 250, 33, 64]
K1_PROBES, K1_PROBE_TIMEOUT = 8, 300
SERVED_CONTEXTS = [128, 137, 146, 155, 164, 173, 182, 188]
PREFILL_RUNGS = (1, 16, 64, 256)
# the pool payloads (kv_dtype) K1 and K2 are built for, and the verify
# window of speculative decoding (the engine's default spec_k)
PAYLOADS = ('f32', 'bf16', 'int8')
SPEC_K = 4
# flash kernel shapes: BERT-base training (bench.py bench_bert) and the
# causal TransformerLM (CausalLMConfig(): 8 heads of 64, 512 positions)
BERT_SHAPE = (128, 12, 128, 64)
LM_SHAPE = (8, 8, 512, 64)
TRAIN_STEPS, WARMUP_STEPS = 20, 2
# ResNet-50 training: bench.py bench_resnet's on-chip shape and its
# analytic train FLOPs per image (bench.py:62)
RESNET_BATCH, RESNET_IMG, RESNET_CLASSES = 128, 224, 1000
RESNET_GFLOP_PER_IMAGE = 12.3
RESNET_S2D_STEPS = 10
# MNIST LeNet on the static graph: the book recipe's batch and Adam(0.001);
# the card against the CPU executor at a stated tolerance (f32, TF32 off,
# sums in another order)
LENET_BATCH, LENET_SMALL_BATCH, LENET_PARAMS = 64, 32, 431080
LENET_ATOL, LENET_RTOL = 1e-5, 1e-4
K4_PER_PASS = 33                # stride-1 1x1 ConvBNLayers of ResNet-50
# Transformer-big WMT en-de: bench.py bench_transformer_big's on-chip batch
# (64 x 64, max_length 64); the card against the CPU in f32, TF32 off, sums
# in another order: logits and loss at atol/rtol 1e-4, gradients within
# 1e-3 of their tensor's largest entry; decode at 16 new tokens
NMT_BATCH, NMT_SEQ, NMT_DECODE_LEN = 64, 64, 16
NMT_ATOL, NMT_RTOL, NMT_GRAD_RTOL = 1e-4, 1e-4, 1e-3
# ERNIE-base finetuning: bench.py bench_ernie's on-chip batch (64 x 128)
# and gradient merge (4), its 16 timed calls; the fused-attention run's
# calls; the card against the CPU at batch 2 in f32, TF32 off, sums in
# another order: logits at atol/rtol 1e-4, gradients within 1e-3 of their
# tensor's largest entry; one finetune step's update (the parameters after
# it less those before) within 0.1 of the rate (5e-7: the warm-up's first)
# of the CPU's in every entry, beyond one f32 spacing of the parameter
# (the rounding of the stored sum). Adam's first step moves an entry by
# about the rate wherever its gradient is well above round-off, so a
# skipped or halved update is off by 1 or 0.5 of it; where a gradient is
# round-off (the attention key biases, which softmax cancels), Adam's
# step is lr·g/(|g| + eps/sqrt(1 - beta2)), far under the rate.
ERNIE_BATCH, ERNIE_SEQ, ERNIE_ACCUM, ERNIE_CALLS = 64, 128, 4, 16
ERNIE_FUSED_CALLS, ERNIE_CHECK_BATCH = 4, 2
ERNIE_ATOL, ERNIE_RTOL, ERNIE_GRAD_RTOL, ERNIE_STEP_TOL = (1e-4, 1e-4,
                                                         1e-3, 0.1)
# PaddleCV's static ResNet-50 recipe (tools/static_resnet.py) at full width
# and depth: bench.py's batch of 128 at 224^2, 20 eval batches of 128; the
# card against the CPU at batch 8, every parameter's gradient in L2 norm
# relative to a float64 CPU run of the same step (the witness). In float64
# (the program made f64 on both sides) the card's within 1e-6 of it, and
# its loss within 1e-10; in f32 (resolve_device turns TF32 off) the loss at
# rtol 1e-4 of the f32 CPU run's, top-1 and top-5 equal, and each gradient
# within 2x the f32 CPU run's own distance from the witness plus 1e-4
# (f32 gradients of this net at batch 8 lie about 2% from the witness on
# either side, ROADMAP C.4 item 4). A gradient scaled by 0.9 must fail
# both. The saved model's output against the in-memory test program's
# within 1e-5 of its largest entry
SRESNET_PARAMS, SRESNET_CHECK_BATCH, SRESNET_EVAL_BATCHES = 25557032, 8, 20
SRESNET_RTOL, SRESNET_SERVE_RTOL, SRESNET_GRAD_FLOOR = 1e-4, 1e-5, 1e-4
SRESNET_F64_RTOL, SRESNET_F64_LOSS_RTOL = 1e-6, 1e-10
SRESNET_GRADS = ('conv1_weights', 'res2a_branch2a_weights',
                 'res4c_branch2b_weights', 'bn5c_branch2c_scale', 'fc_0.w_0')


def log(*parts):
    print(*parts, flush=True)


def device_us(prof):
    """Device time in microseconds of everything a profiler recorded
    (kernels, copies, fills), summed over all events."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0.0))
    return total


def profiled(run):
    """A torch.profiler trace (device activity only) of one call of
    ``run``, after an identical warm-up call inside the profiler, so that
    the tracer's start-up does not drop the first events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    return prof


def timed(fn, iters=TIMED_LAUNCHES, warmup=10):
    """(device ms per call, event ms per call) of ``fn``.

    Device ms: the kernels' own time per call, summed by torch.profiler
    (CUPTI) over ``iters`` calls, without the host's launch gaps; None when
    the profiler recorded no device time. Event ms: CUDA events around
    ``iters`` back-to-back calls, which for calls shorter than their host
    overhead measures the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    dev = device_us(profiled(lambda: [fn() for _ in range(iters)]))
    return (dev / 1e3 / iters if dev > 0 else None), event_ms


def times(kernel, plain, library):
    """The three timings of one comparison, device time where the
    profiler saw it, else CUDA events (``timing`` says which)."""
    return times_of(timed(kernel), timed(plain), timed(library))


def times_of(kernel, plain, library):
    """:func:`times` from three :func:`timed` results."""
    (k, ke), (p, pe), (lib, libe) = kernel, plain, library
    if None in (k, p, lib):
        return {'ms': ke, 'plain_ms': pe, 'library_ms': libe,
                'timing': 'cuda events, back to back'}
    return {'ms': k, 'plain_ms': p, 'library_ms': lib,
            'timing': 'profiler device time', 'event_ms': ke,
            'plain_event_ms': pe, 'library_event_ms': libe}


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def fmt_times(t, library='sdpa'):
    line = (f'kernel {t["ms"]:.5f} ms plain {t["plain_ms"]:.5f} ms '
            f'{library} {t["library_ms"]:.5f} ms bound {t["bound_ms"]:.5f} '
            f'ms ({t["bound_by"]}); {t["timing"]}')
    if 'event_ms' in t:
        line += (f'; back-to-back events: kernel {t["event_ms"]:.5f} plain '
                 f'{t["plain_event_ms"]:.5f} {library} '
                 f'{t["library_event_ms"]:.5f} ms')
    return line


def compare(name, got, want, atol=ATOL, rtol=RTOL):
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite kernel output')
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f'{name}: max |diff| {err.max().item():.3e} '
                             f'beyond atol {atol} + rtol {rtol}')
    return err.max().item()


def make_pool(rng, dev):
    """A pool full of non-zero data: every free block holds stale rows."""
    import torch
    k = torch.from_numpy(rng.standard_normal((H, NB, BS, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((H, NB, BS, D), np.float32))
    return k.to(dev), v.to(dev)


def quantize_pool(k_pages, v_pages, payload):
    """(k_pages, v_pages, k_scales, v_scales) of an f32 pool stored at
    ``payload`` as the KV cache stores it (int8 through its row codec)."""
    from paddle_tpu_torch.parallel.quant_collectives import rowwise_quantize
    if payload == 'f32':
        return k_pages, v_pages, None, None
    if payload == 'bf16':
        return k_pages.bfloat16(), v_pages.bfloat16(), None, None
    (kq, ks), (vq, vs) = rowwise_quantize(k_pages), rowwise_quantize(v_pages)
    return kq, vq, ks, vs


def kv_bytes(keys, payload):
    """Bytes of ``keys`` K and V rows of H heads at ``payload``: 4 bytes an
    element for f32, 2 for bf16, 1 for int8 plus its 4-byte row scale."""
    per_row = {'f32': 4 * D, 'bf16': 2 * D, 'int8': D + 4}[payload]
    return 2 * keys * H * per_row


def make_tables(rng, contexts):
    """Distinct random blocks per sequence, scratch-padded; a context of
    None is an inactive slot (all scratch, context 1)."""
    free = list(rng.permutation(np.arange(1, NB)))
    tables, ctx = np.zeros((len(contexts), MAX_BPS), np.int32), []
    for i, c in enumerate(contexts):
        if c is None:
            ctx.append(1)
            continue
        nb = -(-c // BS)
        tables[i, :nb] = [free.pop() for _ in range(nb)]
        ctx.append(c)
    return tables, np.asarray(ctx, np.int32)


def decode_inputs(rng, dev, contexts):
    """K1's inputs at ``contexts``, drawn from ``rng`` in phase 3's order:
    (k_pages, v_pages, tables, contexts, q), the tables and contexts also
    as numpy."""
    import torch
    k_pages, v_pages = make_pool(rng, dev)
    tables, ctx = make_tables(rng, contexts)
    bt = torch.from_numpy(tables).to(dev)
    cl = torch.from_numpy(ctx).to(dev)
    q = torch.from_numpy(rng.standard_normal((S, H, D), np.float32)).to(dev)
    return k_pages, v_pages, bt, cl, q, tables, ctx


def check_decode_kernel(rng, dev, contexts, payload='f32'):
    """K1 over a ``payload`` pool against its plain version at
    ``contexts`` (two launches bitwise equal), then its times beside the
    plain version, SDPA (on the pre-gathered, dequantized dense view) and
    the bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    k_pages, v_pages, bt, cl, q, tables, ctx = decode_inputs(rng, dev,
                                                             contexts)
    kp, vp, ks, vs = quantize_pool(k_pages, v_pages, payload)
    del k_pages, v_pages
    scale = 1.0 / np.sqrt(D)
    name = 'paged_decode_attention' + ('' if payload == 'f32'
                                       else f' {payload}')
    got = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs, sm_scale=scale)
    want = nn_ops.paged_attention_ref(q, kp, vp, bt, cl, ks, vs,
                                      sm_scale=scale)
    err = compare(name, got, want)
    again = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs, sm_scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f'{name}: two launches differ')

    # yardstick: one library call on the pre-gathered dense view
    kd = nn_ops._gather_pages(kp, bt, S, H, D, ks)
    vd = nn_ops._gather_pages(vp, bt, S, H, D, vs)
    mask = (torch.arange(MAX_BPS * BS, device=dev)[None, None, None, :]
            < cl[:, None, None, None])
    tm = times(lambda: nn_ops.paged_attention(
                   q, kp, vp, bt, cl, ks, vs, sm_scale=scale),
               lambda: nn_ops.paged_attention_ref(
                   q, kp, vp, bt, cl, ks, vs, sm_scale=scale),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None, :], kd, vd, attn_mask=mask, scale=scale))
    keys = int(np.minimum(ctx, MAX_BPS * BS).sum())
    nbytes = (2 * S * H * D * 4            # q in, out
              + kv_bytes(keys, payload)    # K and V rows of attended keys
              + tables.nbytes + ctx.nbytes)
    flops = keys * H * 4 * D               # q.k and p.v per key
    bms, by = bound_ms(nbytes, flops)
    return {'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/paged_attention.cu',
            'replaces': 'paddle_tpu/ops/nn_ops.py:785',
            'shape': f'S={S} H={H} D={D} BS={BS} NB={NB} max_bps={MAX_BPS} '
                     f'{payload} ctx={ctx.tolist()}',
            'max_abs_err': err, 'bound_ms': bms, 'bound_by': by, **tm}


def check_verify_read(rng, dev, contexts, payload='f32', kq=SPEC_K):
    """The verify read of speculative decoding, (S, H, kq, D) at
    ``contexts`` over a ``payload`` pool, through K1 in one launch: against
    the plain multi-query version (rows whose context stays inside the
    table), each row bitwise equal to a single-query K1 launch at context
    c + j, two launches bitwise equal; then the times of K1 on the
    flattened rows, the whole wrapper, the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    k_pages, v_pages, bt, cl, _, tables, ctx = decode_inputs(rng, dev,
                                                             contexts)
    kp, vp, ks, vs = quantize_pool(k_pages, v_pages, payload)
    del k_pages, v_pages
    q = torch.from_numpy(
        rng.standard_normal((S, H, kq, D), np.float32)).to(dev)
    scale = 1.0 / np.sqrt(D)
    full = MAX_BPS * BS
    name = f'paged_decode_attention verify k={kq} {payload}'
    rows, rt, rc = nn_ops.verify_rows(q, bt, cl, full)
    for r, c in zip(rt.cpu().numpy(), rc.cpu().numpy()):
        read = r[:-(-int(c) // BS)]
        if not ((read >= 0) & (read < NB)).all() or not 1 <= c <= full:
            raise AssertionError(f'{name}: a flattened row reads outside '
                                 f'the pool: context {c}, table {read}')
    got = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs, sm_scale=scale)
    again = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs, sm_scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f'{name}: two launches differ')
    for j in range(kq):
        single = nn_ops.paged_attention(
            q[:, :, j].contiguous(), kp, vp, bt,
            (cl + j).clamp(max=full).int(), ks, vs, sm_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(got[:, :, j], single):
            raise AssertionError(f'{name}: row {j} differs from the '
                                 f'single-query launch at context c + {j}')
    want = nn_ops.paged_attention_ref(q, kp, vp, bt, cl, ks, vs,
                                      sm_scale=scale)
    inside = (cl[:, None] + torch.arange(kq, device=dev)) <= full
    err = compare(name, got.transpose(1, 2)[inside],
                  want.transpose(1, 2)[inside])
    kd = nn_ops._gather_pages(kp, bt, S, H, D, ks)
    vd = nn_ops._gather_pages(vp, bt, S, H, D, vs)
    mask = (torch.arange(full, device=dev)[None, None, None, :]
            < cl[:, None, None, None]
            + torch.arange(kq, device=dev)[None, None, :, None])
    tk, tw = timed(lambda: nn_ops.paged_attention(
        rows, kp, vp, rt, rc, ks, vs, sm_scale=scale)), timed(
        lambda: nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs,
                                       sm_scale=scale))
    tm = times_of(tk, timed(lambda: nn_ops.paged_attention_ref(
                      q, kp, vp, bt, cl, ks, vs, sm_scale=scale)),
                  timed(lambda: F.scaled_dot_product_attention(
                      q, kd, vd, attn_mask=mask, scale=scale)))
    tm['wrapper_ms'] = tw[0] if tw[0] is not None else tw[1]
    attended = np.minimum(ctx[:, None] + np.arange(kq), full)
    keys = int(np.minimum(ctx + kq - 1, full).sum())    # each row read once
    nbytes = (2 * S * kq * H * D * 4 + kv_bytes(keys, payload)
              + tables.nbytes + ctx.nbytes)
    flops = int(attended.sum()) * H * 4 * D
    bms, by = bound_ms(nbytes, flops)
    return {'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/paged_attention.cu',
            'replaces': 'paddle_tpu/ops/nn_ops.py:785',
            'shape': f'S={S} H={H} K={kq} D={D} BS={BS} NB={NB} '
                     f'max_bps={MAX_BPS} {payload} ctx={ctx.tolist()}',
            'max_abs_err': err, 'bound_ms': bms, 'bound_by': by, **tm}


def check_tables_in_range(what, tables, contexts):
    """Every table entry up to ceil(context / BS) lies in [0, NB)."""
    for i, c in enumerate(contexts):
        row = tables[i, :-(-int(c) // BS)]
        if not ((row >= 0) & (row < NB)).all():
            raise AssertionError(f'{what}: row {i} (context {c}) has a table '
                                 f'entry outside [0, {NB}): {row.tolist()}')


def k1_probe(probe, seed):
    """One of ROADMAP C.14's probes, in a fresh process: the first launch of
    each K1 instantiation and shape the serving path makes, each checked
    against the plain version: the f32 pool, then the bf16 and int8 pools,
    then the flattened verify read (k = SPEC_K, f32) on the same inputs.
    Probes 0 to K1_PROBES / 2 - 1 draw phase 3's first inputs
    (``default_rng(seed)``, DECODE_CONTEXTS), the others random ragged
    contexts. Before each launch the host checks that every table entry up
    to ceil(context / BS) of every row it reads lies in [0, NB). Prints one
    JSON line; a fault ends the process with an error."""
    import torch
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.ops import nn_ops
    dev = resolve_device('cuda')
    if probe < K1_PROBES // 2:
        rng, contexts = np.random.default_rng(seed), DECODE_CONTEXTS
    else:
        rng = np.random.default_rng(seed + 1000 + probe)
        contexts = [int(c) for c in rng.integers(1, MAX_BPS * BS + 1, S)]
    k_pages, v_pages, bt, cl, q, tables, ctx = decode_inputs(rng, dev,
                                                             contexts)
    check_tables_in_range(f'probe {probe}', tables, ctx)
    scale = 1.0 / np.sqrt(D)
    errs = {}
    for payload in PAYLOADS:
        kp, vp, ks, vs = quantize_pool(k_pages, v_pages, payload)
        got = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs,
                                     sm_scale=scale)
        torch.cuda.synchronize()
        want = nn_ops.paged_attention_ref(q, kp, vp, bt, cl, ks, vs,
                                          sm_scale=scale)
        errs[payload] = compare(f'K1 {payload}, probe {probe}', got, want)
    full = MAX_BPS * BS
    q4 = torch.from_numpy(
        rng.standard_normal((S, H, SPEC_K, D), np.float32)).to(dev)
    _, rt, rc = nn_ops.verify_rows(q4, bt, cl, full)
    check_tables_in_range(f'probe {probe} verify rows', rt.cpu().numpy(),
                          rc.cpu().numpy())
    got = nn_ops.paged_attention(q4, k_pages, v_pages, bt, cl,
                                 sm_scale=scale)
    torch.cuda.synchronize()
    want = nn_ops.paged_attention_ref(q4, k_pages, v_pages, bt, cl,
                                      sm_scale=scale)
    inside = (cl[:, None] + torch.arange(SPEC_K, device=dev)) <= full
    errs['verify'] = compare(f'K1 verify, probe {probe}',
                             got.transpose(1, 2)[inside],
                             want.transpose(1, 2)[inside])
    print(json.dumps({'probe': probe, 'contexts': ctx.tolist(),
                      'max_abs_err': errs,
                      'launches': nn_ops.launch_counts()['paged_attention']}),
          flush=True)


def probe_k1_first_launches(seed, card):
    """ROADMAP C.14, bounded: K1's first launch in K1_PROBES fresh
    processes (four at a time), each under CUDA_LAUNCH_BLOCKING=1, so an
    illegal address shows at the launch that makes it. Prints how many
    faulted; a fault fails the smoke."""
    import os
    env = {**os.environ, 'CUDA_LAUNCH_BLOCKING': '1'}
    results, faults = [], []
    t0 = time.perf_counter()
    for wave in range(0, K1_PROBES, 4):
        procs = [(i, subprocess.Popen(
            [sys.executable, __file__, '--seed', str(seed), '--k1-probe',
             str(i)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)) for i in range(wave, min(wave + 4,
                                                          K1_PROBES))]
        for i, p in procs:
            try:
                out, err = p.communicate(timeout=K1_PROBE_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            if p.returncode == 0:
                results.append(json.loads(out.strip().splitlines()[-1]))
            else:
                faults.append(i)
                log(f'K1 probe {i} exited {p.returncode}: '
                    + ' | '.join(err.strip().splitlines()[-3:]))
    log(f'K1 first launches in fresh processes (ROADMAP C.14) [{card}]: '
        f'{len(faults)} of {K1_PROBES} processes faulted, each making the '
        f'first launch of K1 over f32, bf16 and int8 pools and of the '
        f'flattened verify read (k={SPEC_K}) ({K1_PROBES // 2} at phase '
        f'3\'s seeded contexts {DECODE_CONTEXTS}, {K1_PROBES // 2} at random '
        f'ragged ones, CUDA_LAUNCH_BLOCKING=1, table entries checked on the '
        f'host first); ' + ', '.join(
            f'probe {r["probe"]} max|diff| '
            + ' '.join(f'{k} {v:.3e}' for k, v in r['max_abs_err'].items())
            + f' launches {r["launches"]} contexts {r["contexts"]}'
            for r in results)
        + f'; {time.perf_counter() - t0:.1f} s')
    if faults:
        raise AssertionError(f'K1 faulted in probes {faults} (ROADMAP C.14)')


def check_prefill_kernel(rng, dev, payload='f32'):
    """K2 over a ``payload`` pool against its plain version at every prompt
    rung (two launches bitwise equal), with its times beside the plain
    version, SDPA (on the raw, dequantized prompt K/V) and the bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    kp, vp, ks, vs = quantize_pool(*make_pool(rng, dev), payload)
    scale = 1.0 / np.sqrt(D)
    name = 'paged_prefill_attention' + ('' if payload == 'f32'
                                        else f' {payload}')
    errs, rungs = [], {}
    for lb in PREFILL_RUNGS:
        # a prompt of lb tokens plus a budget, as the engine reserves it
        tables, _ = make_tables(rng, [min(lb + 128, MAX_BPS * BS)])
        bt = torch.from_numpy(tables).to(dev)
        q = torch.from_numpy(
            rng.standard_normal((1, H, lb, D), np.float32)).to(dev)
        got = nn_ops.paged_prefill_attention(q, q, q, kp, vp, bt, ks, vs,
                                             sm_scale=scale)
        want = nn_ops.paged_prefill_attention_ref(q, kp, vp, bt, ks, vs,
                                                  sm_scale=scale)
        errs.append(compare(f'{name} Lb={lb}', got, want))
        again = nn_ops.paged_prefill_attention(q, q, q, kp, vp, bt, ks, vs,
                                               sm_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f'{name} Lb={lb}: two launches differ')
        # yardstick: causal SDPA on the raw prompt K/V (what the TPU
        # kernel attended); the same rows the paged view holds
        kr = nn_ops._gather_pages(kp, bt, 1, H, D, ks)[:, :, :lb]
        vr = nn_ops._gather_pages(vp, bt, 1, H, D, vs)[:, :, :lb]
        tm = times(lambda: nn_ops.paged_prefill_attention(
                       q, q, q, kp, vp, bt, ks, vs, sm_scale=scale),
                   lambda: nn_ops.paged_prefill_attention_ref(
                       q, kp, vp, bt, ks, vs, sm_scale=scale),
                   lambda: F.scaled_dot_product_attention(
                       q, kr, vr, is_causal=True, scale=scale))
        nbytes = (2 * lb * H * D * 4            # q in, out
                  + kv_bytes(lb, payload)       # the prompt's K and V rows
                  + tables.nbytes)
        flops = lb * (lb + 1) // 2 * H * 4 * D  # causal pairs
        bms, by = bound_ms(nbytes, flops)
        rungs[lb] = {'bound_ms': bms, 'bound_by': by, **tm}
        log(f'K2 {payload} Lb={lb}: max|diff| {errs[-1]:.3e} '
            f'{fmt_times(rungs[lb])}')
    top = rungs[PREFILL_RUNGS[-1]]
    return {'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/paged_attention.cu',
            'replaces': 'paddle_tpu/ops/nn_ops.py:883',
            'shape': f'B=1 H={H} Lb={PREFILL_RUNGS[-1]} D={D} BS={BS} '
                     f'NB={NB} max_bps={MAX_BPS} {payload}',
            'max_abs_err': max(errs), **top}


def flash_inputs(rng, dev, shape, dtype, mask=False):
    """q, k, v, dO of ``shape`` in ``dtype`` and, with ``mask``, BertModel's
    (B, 1, 1, S) f32 bias: 0 where attended, -1e4 where padded."""
    import torch
    b, h, s, d = shape

    def n():
        return torch.from_numpy(
            rng.standard_normal((b, h, s, d), np.float32)).to(dev, dtype)

    q, k, v, do = n(), n(), n(), n()
    bias = None
    if mask:
        keep = rng.random((b, 1, 1, s)) < 0.85
        keep[..., 0] = True
        bias = torch.from_numpy(
            np.where(keep, 0.0, -1e4).astype(np.float32)).to(dev)
    return q, k, v, do, bias


def report_flash_build():
    """Phase 2, the flash bodies (forward, dK/dV, dQ; bf16 and f32; every
    head dim) as the loaded library reports them: registers, local memory a
    thread (spills), static and dynamic shared memory, threads and the CTAs
    an SM holds. Returns the bf16 bodies' figures at D 64, the training
    path's, by wrapper name."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    at_d64 = {}
    for kind in nn_ops.FLASH_KINDS:
        for dtype in (torch.bfloat16, torch.float32):
            for d in nn_ops.HEAD_DIMS:
                info = nn_ops.flash_kernel_info(kind, d, dtype)
                log(f'{kind} D {d} {str(dtype)[6:]}: {info["registers"]} '
                    f'registers, {info["spill_bytes"]} B local a thread, '
                    f'{info["static_smem"]} B static and '
                    f'{info["dynamic_smem"]} B dynamic shared, '
                    f'{info["threads"]} threads, {info["ctas_per_sm"]} CTAs '
                    f'an SM')
                if dtype == torch.bfloat16 and d == 64:
                    at_d64[kind] = info
    return at_d64


def report_k2_k4_build():
    """Phase 2, K1's and K2's bodies (every head dim, over f32, bf16 and
    int8 pools) and K4's (the bf16 wgmma body at each tile width, the bf16
    WMMA body, the f32 body) as the loaded libraries report them. Returns
    the paged bodies' figures at D 64 by kernel and payload
    (``{'paged_decode_attention': {'f32': {...}, ...}, ...}``) and K4's by
    body and tile, labelled as ``check_k4_kernel`` labels them (``'wgmma
    128x64'``)."""
    from paddle_tpu_torch.ops import nn_ops, pallas_conv

    def line(label, info):
        log(f'{label}: {info["registers"]} registers, {info["spill_bytes"]} '
            f'B local a thread, {info["static_smem"]} B static and '
            f'{info["dynamic_smem"]} B dynamic shared, {info["threads"]} '
            f'threads, {info["ctas_per_sm"]} CTAs an SM')

    paged = {kind: {} for kind in nn_ops.PAGED_KINDS}
    for kind in nn_ops.PAGED_KINDS:
        for payload, name in zip(nn_ops.PAGED_PAYLOADS, PAYLOADS):
            for d in nn_ops.HEAD_DIMS:
                info = nn_ops.paged_kernel_info(kind, d, payload)
                line(f'{kind} {name} D {d}', info)
                if d == D:
                    paged[kind][name] = info
    k4 = {}
    for body, bn in [('wgmma', t) for t in pallas_conv.K4_WGMMA_TILES] + [
            ('wmma', 64), ('f32', 64)]:
        k4[f'{body} 128x{bn}'] = pallas_conv.conv1x1_kernel_info(body, bn)
        line(f'conv1x1_bn_act {body} 128 x {bn}', k4[f'{body} 128x{bn}'])
    return paged, k4


def check_flash_chain(label, q, k, v, do, bias, causal, tol):
    """The kernels as the training path runs them (the autograd Function:
    forward, then dK/dV and dQ, and dS where the bias takes a gradient)
    against the plain versions; returns {quantity: max |diff|}.

    The forward's O and row statistics are held against the plain forward;
    the gradients against the plain backward run on the forward kernel's
    own saved O and statistics (the kernel is deterministic, so a second
    launch gives the Function's). Fed the plain forward's bf16 O instead,
    ``di = rowsum(O . dO)`` would carry O's one-ulp rounding differences
    into every gradient and measure the forward twice. In f32 the whole
    chain is also held against the whole plain chain."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    sm = q.shape[-1] ** -0.5
    kw = {'sm_scale': sm, 'causal': causal}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b = None if bias is None else bias.clone().requires_grad_()
    o = nn_ops.fused_attention(*leaves, b, **kw)
    o.backward(do)
    o_k, st_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    o_ref, st_ref = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
    errs = {'o': compare(f'{label} O', o.detach(), o_ref, *tol['o']),
            'stats': compare(f'{label} row statistics', st_k, st_ref,
                             *FLASH_TOL['f32']['o'])}
    refs = [nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k, st_k, do,
                                           **kw)]
    if q.dtype == torch.float32:
        refs.append(nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_ref,
                                                   st_ref, do, **kw))
    for i, want in enumerate(refs):
        tag = '' if i == 0 else ' (whole chain)'
        for name, leaf, ref in zip(('dq', 'dk', 'dv'), leaves, want):
            e = compare(f'{label} {name}{tag}', leaf.grad, ref, *tol['grad'])
            errs[name] = max(errs.get(name, 0.0), e)
        if b is not None:
            e = compare(f'{label} dbias{tag}', b.grad,
                        nn_ops._sum_to(want[3], bias.shape), *tol['grad'])
            errs['dbias'] = max(errs.get('dbias', 0.0), e)
    return errs


def time_flash(q, k, v, do, causal):
    """Device times of the three kernels at these inputs (no bias), beside
    their plain versions, the library yardstick and their bounds. The
    plain and library backward compute dQ, dK and dV together, so both
    backward kernels stand beside the same two times."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    b, h, s, d = q.shape
    sm = d ** -0.5
    kw = {'sm_scale': sm, 'causal': causal}
    o, stats = nn_ops.flash_attention_fwd(q, k, v, **kw)
    di = nn_ops._row_dot(o, do)
    fwd = times(lambda: nn_ops.flash_attention_fwd(q, k, v, **kw),
                lambda: nn_ops.fused_attention_fwd_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sm))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         scale=sm)
    plain_bwd = timed(lambda: nn_ops.fused_attention_bwd_ref(
        q, k, v, None, o, stats, do, **kw))
    lib_bwd = timed(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                retain_graph=True))
    dkv = times_of(timed(lambda: nn_ops.flash_attention_bwd_dkv(
        q, k, v, None, stats, di, do, **kw)), plain_bwd, lib_bwd)
    dq = times_of(timed(lambda: nn_ops.flash_attention_bwd_dq(
        q, k, v, None, stats, di, do, **kw)), plain_bwd, lib_bwd)
    # bytes: each (B, H, S, D) operand read or written once, the f32 row
    # statistics (m and log l) and di rows; operations: 2 * D per attended
    # pair and product (QK^T and PV forward; S, dP, dV, dK for dK/dV; S,
    # dP, dQ for dQ)
    row = b * h * s * d * q.element_size()
    vec = b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    out = []
    for name, t, nbytes, products in (
            ('flash_attention_fwd', fwd, 4 * row + 2 * vec, 2),
            ('flash_attention_bwd_dkv', dkv, 6 * row + 3 * vec, 4),
            ('flash_attention_bwd_dq', dq, 5 * row + 3 * vec, 3)):
        bms, by = bound_ms(nbytes, products * 2 * pairs * d, peak)
        out.append({'name': name, 'bound_ms': bms, 'bound_by': by, **t})
    return out


# the stock Pallas kernels that paddle_tpu/ops/nn_ops.py:714 reaches
FLASH_STOCK = {
    'flash_attention_fwd': 'jax/experimental/pallas/ops/tpu/'
                           'flash_attention.py:758',
    'flash_attention_bwd_dkv': 'jax/experimental/pallas/ops/tpu/'
                               'flash_attention.py:1121',
    'flash_attention_bwd_dq': 'jax/experimental/pallas/ops/tpu/'
                              'flash_attention.py:1456'}


def check_flash_kernels(rng, dev, card):
    """Phase 3b: every case's kernel chain against the plain chain, then
    the times at the unbiased shapes. Returns the kernels' entries at the
    training path's case (BERT-base, bf16, no bias)."""
    import torch
    cases = (('BERT bf16', BERT_SHAPE, torch.bfloat16, False, False),
             ('BERT f32', BERT_SHAPE, torch.float32, False, False),
             ('BERT bf16 mask', BERT_SHAPE, torch.bfloat16, True, False),
             ('LM causal f32', LM_SHAPE, torch.float32, False, True))
    entries = None
    for label, shape, dtype, mask, causal in cases:
        q, k, v, do, bias = flash_inputs(rng, dev, shape, dtype, mask)
        tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
        errs = check_flash_chain(label, q, k, v, do, bias, causal, tol)
        log(f'K3/K3b {label} (B, H, S, D)={shape} causal={causal}: max|diff| '
            + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
            + f' (O atol {tol["o"][0]} rtol {tol["o"][1]}, gradients atol '
              f'{tol["grad"][0]} rtol {tol["grad"][1]}, row statistics '
              f'atol {ATOL} rtol {RTOL})')
        if not mask:
            timings = time_flash(q, k, v, do, causal)
            for t in timings:
                log(f'{t["name"]} {label} [{card}]: {fmt_times(t)}')
            if entries is None:
                errs_of = {'flash_attention_fwd': errs['o'],
                           'flash_attention_bwd_dkv': max(errs['dk'],
                                                          errs['dv']),
                           'flash_attention_bwd_dq': errs['dq']}
                entries = [{
                    'route': 'cuda',
                    'source': 'paddle_tpu_torch/csrc/flash_attention.cu',
                    'replaces': 'paddle_tpu/ops/nn_ops.py:714',
                    'stock': FLASH_STOCK[t['name']],
                    'shape': f'B={shape[0]} H={shape[1]} S={shape[2]} '
                             f'D={shape[3]} bf16, no bias',
                    'max_abs_err': errs_of[t['name']], **t}
                    for t in timings]
        del q, k, v, do, bias
        torch.cuda.empty_cache()
    for shape, dtype, causal in (((4, 12, 128, 64), torch.bfloat16, False),
                                 ((2, 8, 130, 64), torch.float32, True)):
        errs = check_flash_masked_rows(rng, dev, shape, dtype, causal)
        tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
        log(f'K3/K3b finfo.min rows {str(dtype)[6:]} (B, H, S, D)={shape} '
            f'causal={causal} against fused_attention_ref autograd: max|diff| '
            + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
            + f' (O atol {tol["o"][0]} rtol {tol["o"][1]}, gradients atol '
              f'{tol["grad"][0]} rtol {tol["grad"][1]})')
    return entries


def check_flash_masked_rows(rng, dev, shape, dtype, causal):
    """Rows that a ``finfo.min`` bias masks whole: a (B, 1, 1, S) bias of
    ``finfo.min`` on about a third of batch row 0's keys and on every key
    of batch row 1, taking a gradient. The kernels, through the autograd
    Function, against ``fused_attention_ref``'s autograd (the JAX op's
    formulation: weight 1/S on each key of a masked row, and under causal
    on the keys past the diagonal too) on the same values in f32: O, and
    the gradients of q, k, v and the bias, in f32 whole and in bf16 on
    batch row 1. In bf16 every gradient is also held, as in
    :func:`check_flash_chain`, to the plain backward run on the forward
    kernel's own O (di = rowsum(O . dO) from a bf16 O differs from the f32
    one by O's rounding, which moves row 0's gradients by more than the
    bf16 tolerance)."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    q, k, v, do, _ = flash_inputs(rng, dev, shape, dtype)
    b, _, s, d = shape
    keep = rng.random((b, 1, 1, s)) < 0.7
    keep[0, ..., 0] = True
    keep[1] = False
    bias = torch.from_numpy(np.where(keep, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32)).to(dev)
    kw = {'sm_scale': d ** -0.5, 'causal': causal}
    tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    o = nn_ops.fused_attention(*leaves, **kw)
    o.backward(do)
    refs = [t.float().requires_grad_() for t in (q, k, v, bias)]
    o_ref = nn_ops.fused_attention_ref(*refs, **kw)
    o_ref.backward(do.float())
    errs = {'o': compare('finfo.min rows O', o.detach(), o_ref.detach(),
                         *tol['o'])}
    rows = slice(None) if dtype == torch.float32 else slice(1, 2)
    names = ('dq', 'dk', 'dv', 'dbias')
    for name, got, want in zip(names, leaves, refs):
        errs[name] = compare(f'finfo.min rows {name}', got.grad[rows],
                             want.grad[rows], *tol['grad'])
    if dtype == torch.bfloat16:
        o_k, st_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
        dq, dk, dv, ds = nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k,
                                                        st_k, do, **kw)
        plain = (dq, dk, dv, nn_ops._sum_to(ds, bias.shape))
        for name, got, want in zip(names, leaves, plain):
            errs[name] = max(errs[name], compare(
                f'finfo.min rows {name} (plain backward)', got.grad, want,
                *tol['grad']))
    return errs


# phase 5's Adam run, for phase 20 (a) to print beside LAMB's
ADAM_RUN = {}


def train(seed, dev, card):
    """Phase 5: BERT-base pretraining steps through the flash kernels;
    returns the kernels' launch counts over the warm-up and timed steps."""
    import torch
    from paddle_tpu_torch.convert import (bert_init_params,
                                          bert_state_dict_from_paddle)
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretrain_loss)
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.optimizer import Adam
    t0 = time.perf_counter()

    def config(fused):
        # bench.py bench_bert's configuration, plus the fused-attention flag
        return BertConfig(attention_probs_dropout_prob=0.0,
                          hidden_dropout_prob=0.0,
                          max_position_embeddings=128,
                          use_fused_attention=fused)

    cfg = config(True)
    sd = bert_state_dict_from_paddle(bert_init_params(cfg, seed))
    model = BertForPretraining(cfg, device=dev, seed=seed)
    model.load_state_dict(sd)
    n_params = sum(p.numel() for p in model.parameters())
    # the batch bench.py makes: 15% MLM labels, the rest -1
    batch, seq = 128, 128
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    tt = np.zeros((batch, seq), np.int64)
    mlm = np.where(rng.rand(batch, seq) < 0.15,
                   rng.randint(0, cfg.vocab_size, (batch, seq)),
                   -1).astype(np.int64)
    nsp = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    feeds = [torch.from_numpy(a).to(dev) for a in (ids, tt, mlm, nsp)]
    log(f'training model: BertConfig(vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, {cfg.num_hidden_layers} layers, '
        f'{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, '
        f'fused attention) {n_params} parameters; batch {batch} x {seq}, '
        f'{int((mlm >= 0).sum())} MLM labels; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # 1. the fused model against the reference's own unfused route, f32
    unfused = BertForPretraining(config(False), device=dev, seed=seed)
    unfused.load_state_dict(sd)
    with torch.no_grad():
        lf = pretrain_loss(model, *feeds).item()
        lu = pretrain_loss(unfused, *feeds).item()
    del unfused
    torch.cuda.empty_cache()
    rel = abs(lf - lu) / abs(lu)
    log(f'f32 loss: fused {lf!r} unfused {lu!r}, relative difference '
        f'{rel:.3e} (limit 1e-4)')
    if not rel <= 1e-4:
        raise AssertionError(f'fused and unfused f32 losses differ by {rel}')

    # 2. bf16-AMP training steps on the same batch, as bench.py runs them
    step = TrainStep(model, pretrain_loss,
                     Adam(1e-4, parameter_list=list(model.parameters())),
                     amp_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nn_ops.reset_launch_counts()
    losses, secs = [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(*feeds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = nn_ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TRAIN_STEPS
    log('bf16 AMP losses: ' + ' '.join(repr(x) for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    want = cfg.num_hidden_layers * steps
    for name in FLASH_STOCK:
        if launches[name] != want:
            raise AssertionError(f'{name}: {launches[name]} launches for '
                                 f'{steps} steps x {cfg.num_hidden_layers} '
                                 f'layers')
    timed_s = secs[WARMUP_STEPS:]
    seq_s = batch * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    h, layers, vocab = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    # bench.py's analytic train FLOPs per sequence (forward + backward)
    flops_per_seq = seq * (72.0 * layers * h * h + 12.0 * layers * h * seq
                           + 6.0 * h * vocab)
    log(f'trained [{card}]: {steps} steps ({WARMUP_STEPS} warm-up), '
        f'{seq_s:.1f} seq/s over the {TRAIN_STEPS} timed steps, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); peak device memory {peak} bytes; '
        f'model FLOPs {flops_per_seq / 1e9:.1f} G per sequence, '
        f'{flops_per_seq * seq_s / 1e12:.1f} TFLOP/s = '
        f'{flops_per_seq * seq_s / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s '
        f'bf16')
    log(f'launches on the training path: {launches} ({steps} steps x '
        f'{layers} layers = {want} each)')
    prof = profile_train_step(step, feeds, p50, card,
                              {'flash kernels': lambda key: 'flash_' in key})
    ADAM_RUN.update({'p50': p50, 'seq_s': seq_s, 'peak': peak,
                     'busy': None if prof is None else prof[0]})
    return launches


def profile_train_step(step, feeds, step_ms, card, groups,
                       what='train step', calls=1):
    """Where a training step's time goes: the device's busy ms in one
    profiled step (``calls`` calls of ``step``) against the step's p50 on
    the host clock, the kernels that take it, and for each ``label:
    match`` of ``groups`` the share of the kernels whose name
    ``match``es. Returns (busy ms, the profiler's events by device time),
    or None where the profiler recorded no device time."""
    prof = profiled(lambda: [step(*feeds) for _ in range(calls)])
    busy_ms = device_us(prof) / 1e3
    if busy_ms <= 0:
        log(f'{what} [{card}]: device busy share not measured (the '
            f'profiler recorded no device time)')
        return None

    def dev_ms(e):
        return getattr(e, 'self_device_time_total', 0.0) / 1e3

    events = sorted(prof.key_averages(), key=lambda e: -dev_ms(e))
    shares = []
    for label, match in groups.items():
        matched = [e for e in events if match(e.key)]
        ms = sum(dev_ms(e) for e in matched)
        shares.append(f'{label} {ms:.3f} ms = {ms / busy_ms:.3f} of busy, '
                      f'{sum(e.count for e in matched)} launches')
    log(f'{what} [{card}]: p50 {step_ms:.3f} ms on the host clock, '
        f'device busy {busy_ms:.3f} ms, idle share '
        f'{1 - busy_ms / step_ms:.3f}; ' + '; '.join(shares))
    for e in events[:12]:
        log(f'  {dev_ms(e):.4f} ms  {dev_ms(e) / busy_ms:.3f}  '
            f'{e.count} calls  {e.key[:90]}')
    return busy_ms, events


def resnet_loss(model, x, y):
    """bench.py's loss: the logits cast to f32, softmax cross entropy, the
    batch mean."""
    from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
    loss, _ = softmax_with_cross_entropy(model(x).float(), y)
    return loss.mean()


def resnet_model(named, fmt, dev, seed, s2d=False):
    from paddle_tpu_torch.convert import resnet_state_dict_from_paddle
    from paddle_tpu_torch.models import ResNet50
    model = ResNet50(RESNET_CLASSES, fmt, stem_space_to_depth=s2d,
                     device=dev, seed=seed)
    model.load_state_dict(resnet_state_dict_from_paddle(named, fmt))
    return model


def check_resnet_f32(named, model, x, dev, seed):
    """The NHWC model's f32 training-mode logits against an NCHW instance
    loaded with the same weights (OIHW copies), and the s2d stem against
    the plain one; ``model`` is reloaded afterwards (the training-mode
    forward moved its running statistics)."""
    import torch
    from paddle_tpu_torch.convert import resnet_state_dict_from_paddle
    from paddle_tpu_torch.models.resnet import ConvBNLayer
    oihw = {n: (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
            for n, a in named.items()}
    nchw = resnet_model(oihw, 'NCHW', dev, seed)
    with torch.no_grad():
        a = model.train()(x)
        b = nchw.train()(x.permute(0, 3, 1, 2).contiguous())
    rel = ((a - b).abs().max() / b.abs().max()).item()
    log(f'ResNet-50 f32 training-mode logits, NHWC against NCHW: max|diff| '
        f'{(a - b).abs().max().item():.3e} at max|logit| '
        f'{b.abs().max().item():.3e}, relative {rel:.3e} (limit 1e-4)')
    if not rel <= 1e-4:
        raise AssertionError(f'NHWC and NCHW logits differ by {rel}')
    del nchw, a, b
    model.load_state_dict(resnet_state_dict_from_paddle(named, 'NHWC'))
    s2d = ConvBNLayer(3, 64, 7, stride=2, act='relu', data_format='NHWC',
                      space_to_depth=True, device=dev)
    s2d.set_dict(model.conv.state_dict())
    with torch.no_grad():
        want = model.conv.eval()(x)
        got = s2d.eval()(x)
    err = compare('s2d stem', got, want, 1e-4, 1e-4)
    log(f's2d stem ConvBNLayer against the plain stem, f32 eval: max|diff| '
        f'{err:.3e} (atol 1e-4, rtol 1e-4)')
    model.train()
    torch.cuda.empty_cache()


def resnet_steps(model, x, y, steps):
    """``steps`` bf16-AMP Momentum(0.1, 0.9) steps on one batch, each
    synchronised: (losses, seconds per step, the TrainStep)."""
    import torch
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    step = TrainStep(model, resnet_loss,
                     Momentum(0.1, momentum=0.9,
                              parameter_list=list(model.parameters())),
                     amp_dtype=torch.bfloat16)
    losses, secs = [], []
    for _ in range(steps):
        t = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError('a master parameter left f32')
    return losses, secs, step


def train_resnet(seed, dev, card):
    """Phase 6: ResNet-50 bf16-AMP training at bench.py's on-chip shape;
    returns the trained model and the batch's images."""
    import torch
    from paddle_tpu_torch.convert import resnet_init_params
    t0 = time.perf_counter()
    named = resnet_init_params(50, RESNET_CLASSES, 'NHWC', seed)
    model = resnet_model(named, 'NHWC', dev, seed)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, (RESNET_BATCH, 1))
                         .astype(np.int64)).to(dev)
    log(f'ResNet-50 NHWC, class_dim {RESNET_CLASSES}: '
        f'{sum(p.numel() for p in model.parameters())} parameters, '
        f'{sum(b.numel() for b in model.buffers())} running statistics; '
        f'batch {RESNET_BATCH} x {RESNET_IMG}^2; built in '
        f'{time.perf_counter() - t0:.1f} s')
    check_resnet_f32(named, model, x, dev, seed)

    xb = x.to(torch.bfloat16)       # bench.py feeds bf16 images on the chip
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, step = resnet_steps(model, xb, y, WARMUP_STEPS + TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    timed_s = secs[WARMUP_STEPS:]
    img_s = RESNET_BATCH * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    flops = RESNET_GFLOP_PER_IMAGE * 1e9 * img_s
    log('ResNet-50 bf16 AMP losses: ' + ' '.join(repr(v) for v in losses))
    log(f'ResNet-50 trained [{card}]: {WARMUP_STEPS + TRAIN_STEPS} steps '
        f'({WARMUP_STEPS} warm-up), {img_s:.1f} images/s over the '
        f'{TRAIN_STEPS} timed steps, step p50 {p50:.3f} ms (min '
        f'{min(timed_s) * 1e3:.3f}, max {max(timed_s) * 1e3:.3f}); peak '
        f'device memory {peak} bytes; model FLOPs {RESNET_GFLOP_PER_IMAGE} '
        f'G per image, {flops / 1e12:.1f} TFLOP/s = '
        f'{flops / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s bf16')
    # a transpose kernel would mean a layer dropped channels_last
    profile_train_step(step, (xb, y), p50, card, {
        'NCHW/NHWC transpose kernels':
            lambda key: 'nchwToNhwc' in key or 'nhwcToNchw' in key,
        'convolutions': lambda key: any(
            t in key.lower() for t in ('conv', 'xmma', 'cudnn', 'dgrad',
                                       'wgrad', 'implicit_gemm', 'nvjet')),
        'reductions': lambda key: 'reduce_kernel' in key,
        'elementwise': lambda key: 'elementwise' in key,
        'optimizer (_foreach)': lambda key: 'multi_tensor' in key,
        'pooling': lambda key: 'pool' in key.lower()})

    # bench.py's A/B of the space-to-depth stem: a fresh model from the
    # same weights, 2 warm-up and 10 timed steps
    s2d = resnet_model(named, 'NHWC', dev, seed, s2d=True)
    _, s2d_secs, _ = resnet_steps(s2d, xb, y, WARMUP_STEPS + RESNET_S2D_STEPS)
    s2d_rate = (RESNET_BATCH * RESNET_S2D_STEPS
                / sum(s2d_secs[WARMUP_STEPS:]))
    log(f'ResNet-50 stem A/B [{card}]: plain {img_s:.1f} images/s, s2d '
        f'{s2d_rate:.1f} images/s ({RESNET_S2D_STEPS} timed steps), step p50 '
        f'{statistics.median(s2d_secs[WARMUP_STEPS:]) * 1e3:.3f} ms')
    del s2d, step
    torch.cuda.empty_cache()
    return model, x


def lenet_programs():
    """README's Fluid script: ``build_static_lenet`` + ``Adam(0.001)`` on
    the port's static graph. Returns (main, startup, loss, acc)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_static_lenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        loss, acc, _ = build_static_lenet(img, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return main, startup, loss, acc


def train_static_lenet(seed, card):
    """Phase 8: MNIST LeNet through ``Executor(CUDAPlace(0))``, held
    against ``Executor(CPUPlace())``, then timed and profiled. Returns the
    kernels' launch counts over the phase (none of the port's kernels is
    on this path)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.ops import nn_ops
    fluid.seed(seed)
    main, startup, loss, acc = lenet_programs()
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != LENET_PARAMS:
        raise AssertionError(f'LeNet has {n_params} parameters, not '
                             f'{LENET_PARAMS}')
    rng = np.random.default_rng(seed)
    feed = {'img': rng.random((LENET_BATCH, 1, 28, 28), dtype=np.float32),
            'label': rng.integers(0, 10, (LENET_BATCH, 1))}
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    fetch = [loss, acc] + grads

    nn_ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    # the same first step on the CPU executor, from the card's startup
    # values copied across
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    scope_from_paddle({n: gscope.find(n).cpu().numpy() for n in persist},
                      cscope, fluid.CPUPlace(), program=main)
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    worst = {}
    for name, g, w in zip(['loss', 'acc'] + grads, got, want):
        worst[name] = float(np.max(np.abs(g - w)))
        if g.shape != w.shape or not np.allclose(g, w, atol=LENET_ATOL,
                                                 rtol=LENET_RTOL):
            raise AssertionError(f'LeNet {name} on the card differs from '
                                 f'the CPU executor: max|diff| '
                                 f'{worst[name]:.3e}')
    log(f'LeNet static graph, batch {LENET_BATCH}, {n_params} parameters: '
        f'first step on the card against the CPU executor within atol '
        f'{LENET_ATOL} rtol {LENET_RTOL}: loss {float(got[0])!r} (cpu '
        f'{float(want[0])!r}), acc {float(got[1])!r}; max|diff| ' + ', '.join(
            f'{n} {e:.3e}' for n, e in worst.items()))

    losses, secs = [float(got[0])], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    peak = torch.cuda.max_memory_allocated()
    log('LeNet static-graph Adam losses: ' + ' '.join(repr(v)
                                                      for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'LeNet losses {losses}: not finite or not '
                             f'falling')
    lowered = gpu.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'main program lowered {lowered} times over '
                             f'{len(losses)} steps of one feed shape')
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    # host dispatch: the run with device tensors fetched, before the sync
    dispatch = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope,
                return_numpy=False)
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    log(f'LeNet static graph trained [{card}]: {len(losses)} steps '
        f'({WARMUP_STEPS} warm-up, {TRAIN_STEPS} timed), '
        f'{TRAIN_STEPS / sum(timed_s):.1f} steps/s, '
        f'{LENET_BATCH * TRAIN_STEPS / sum(timed_s):.1f} images/s, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); host dispatch p50 '
        f'{statistics.median(dispatch) * 1e3:.3f} ms (run returning device '
        f'tensors, before the sync); peak device memory {peak} bytes; '
        f'lowerings of the main program {lowered}')
    profile_train_step(
        lambda: gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope),
        (), p50, card, STATIC_STEP_GROUPS, what='LeNet static-graph step')

    small = {k: v[:LENET_SMALL_BATCH] for k, v in feed.items()}
    out = gpu.run(main, feed=small, fetch_list=[loss], scope=gscope)
    lowered = gpu.lowering_count(main)
    if lowered != 2 or not np.isfinite(out[0]):
        raise AssertionError(f'batch {LENET_SMALL_BATCH}: {lowered} '
                             f'lowerings, loss {out[0]}')
    log(f'LeNet at batch {LENET_SMALL_BATCH}: loss {float(out[0])!r}, '
        f'lowerings of the main program {lowered} (one more for the new '
        f'feed shape)')
    return nn_ops.launch_counts()


def nmt_batch(cfg, batch, seq, seed=0):
    """bench.py's Transformer batch: source, target and (B, S, 1) label ids
    in [1, vocab) from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, cfg.src_vocab_size, (batch, seq)).astype(np.int64)
    trg = rng.randint(1, cfg.trg_vocab_size, (batch, seq)).astype(np.int64)
    lbl = rng.randint(1, cfg.trg_vocab_size,
                      (batch, seq, 1)).astype(np.int64)
    return src, trg, lbl


def nmt_flops_per_token(cfg, seq):
    """bench.py's analytic train FLOPs per token of Transformer-big (2 FLOP
    a MAC, train = 3x forward, averaged over source and target tokens)."""
    d, di, layers = cfg.d_model, cfg.d_inner, cfg.n_layer
    enc_lin = 2.0 * (4 * d * d + 2 * d * di)
    dec_lin = 2.0 * (8 * d * d + 2 * d * di)
    attn = 4.0 * seq * d
    fwd_per_pair = (layers * (enc_lin + attn) + layers * (dec_lin + 2 * attn)
                    + 2.0 * d * cfg.trg_vocab_size)
    return 3.0 * fwd_per_pair / 2.0


def noam_rate(d_model, warmup, n):
    n = max(n, 1)
    return d_model ** -0.5 * min(n ** -0.5, warmup ** -1.5 * n)


def dygraph_host_costs(dev, card, n=20000):
    """Host microseconds a call of what the dygraph API adds to a plain
    torch op: the op on plain tensors, the op on a dygraph Tensor (torch
    function off), Python arithmetic on a Tensor (wrapped back into one),
    and an outermost against a nested Layer call of a 1x1 Linear."""
    import torch
    from paddle_tpu_torch import dygraph
    x = torch.ones(4, device=dev)
    t = x.as_subclass(dygraph.Tensor)

    def host_us(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
        return us

    with dygraph.guard(dev):
        fc = dygraph.Linear(4, 4)
        outer = dygraph.Sequential(fc)
    costs = {'torch.add(plain, plain)': host_us(lambda: torch.add(x, x)),
             'torch.add(Tensor, plain)': host_us(lambda: torch.add(t, x)),
             'plain + plain': host_us(lambda: x + x),
             'Tensor + plain': host_us(lambda: t + x),
             'F.linear (what Linear runs)': host_us(
                 lambda: torch.nn.functional.linear(x, fc.weight.t(),
                                                    fc.bias)),
             'Linear call, outermost': host_us(lambda: fc(x)),
             'Sequential(Linear) call': host_us(lambda: outer(x))}
    log(f'dygraph host cost per call [{card}], {n} calls each on the host '
        f'clock: ' + '; '.join(f'{k} {v:.2f} us' for k, v in costs.items()))
    return costs


def decode_equal_or_near_tie(cpu_model, src, got, want, eos, what):
    """Greedy tokens of the card (``got``) against the CPU's (``want``):
    equal, or at the first step where they part the CPU's top two
    log-probabilities lie within ``NEAR_TIE`` (teacher-forced on the
    common prefix). Returns the rows that parted."""
    import torch
    from paddle_tpu_torch.ops.nn_ops import log_softmax
    parted = []
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        ys = np.full((1, got.shape[1] + 1), eos, np.int64)
        ys[0, 0] = 1
        ys[0, 1:t + 1] = want[r, :t]
        with torch.no_grad():
            enc = cpu_model.encode(torch.from_numpy(src[r:r + 1]))
            logp = log_softmax(cpu_model.decode(torch.from_numpy(ys),
                                                enc)[0, t]).numpy()
        top = np.sort(logp)[-2:]
        gap = float(top[1] - top[0])
        log(f'{what}: row {r} parts at step {t}: card {got[r, t]} cpu '
            f'{want[r, t]}, the CPU\'s top-two gap {gap:.3e} (near-tie '
            f'limit {NEAR_TIE})')
        if gap > NEAR_TIE:
            raise AssertionError(f'{what}: row {r} differs at step {t} with '
                                 f'a top-two gap of {gap}')
        parted.append(r)
    return parted


def beam_equal_or_near_tie(cpu_model, src, got, want, eos, alpha, what):
    """Beam hypotheses of the card against the CPU's: equal, or, where a
    row's best hypothesis differs, the two hypotheses' length-normalised
    scores under the CPU model (teacher-forced) within ``NEAR_TIE``: a
    near tie between whole hypotheses."""
    import torch
    from paddle_tpu_torch.ops.nn_ops import log_softmax

    def score(r, hyp):
        ys = np.concatenate([[1], hyp]).astype(np.int64)[None]
        with torch.no_grad():
            enc = cpu_model.encode(torch.from_numpy(src[r:r + 1]))
            logp = log_softmax(cpu_model.decode(torch.from_numpy(ys),
                                                enc)[0]).numpy()
        total, n = 0.0, 0
        for t, tok in enumerate(hyp):
            total += float(logp[t, tok])
            n += 1
            if tok == eos:
                break
        length = int((hyp != eos).sum()) + 1
        return total / (((5 + length) / 6.0) ** alpha)

    for r in range(got.shape[0]):
        if np.array_equal(got[r], want[r]):
            continue
        gap = abs(score(r, got[r]) - score(r, want[r]))
        log(f'{what}: row {r} differs; the hypotheses\' normalised CPU '
            f'scores differ by {gap:.3e} (near-tie limit {NEAR_TIE})')
        if gap > NEAR_TIE:
            raise AssertionError(f'{what}: row {r} differs with a score gap '
                                 f'of {gap}')


def train_dygraph_transformer(seed, card):
    """Phase 9: the dygraph API training Transformer-big WMT en-de on the
    card (``guard(CUDAPlace(0))``) at bench.py's on-chip configuration.
    Returns the kernels' launch counts over the phase (none of the port's
    kernels is on this path)."""
    import os
    import shutil
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.convert import transformer_init_params
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, beam_search_decode, greedy_decode,
        transformer_loss)
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.optimizer import Adam

    nn_ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = TransformerConfig.big(dropout=0.0, max_length=NMT_SEQ)
    named = transformer_init_params(cfg, seed)
    gpu, cpu = fluid.CUDAPlace(0), fluid.CPUPlace()
    with dygraph.guard(gpu):
        model = Transformer(cfg)
        model.set_dict(named)
    n_params = sum(p.numel() for p in model.parameters())
    src, trg, lbl = nmt_batch(cfg, NMT_BATCH, NMT_SEQ)
    log(f'dygraph Transformer-big: TransformerConfig.big(d_model '
        f'{cfg.d_model}, {cfg.n_head} heads, {cfg.n_layer} + {cfg.n_layer} '
        f'layers, d_inner {cfg.d_inner}, vocab {cfg.src_vocab_size}/'
        f'{cfg.trg_vocab_size}, max_length {cfg.max_length}, dropout 0) '
        f'{n_params} parameters on {model.parameters()[0].device}; '
        f'batch {NMT_BATCH} x {NMT_SEQ}; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # 1. the card against the CPU: f32 forward, loss and a few gradients
    # at batch 2, the same weights
    with dygraph.guard(cpu):
        cpu_model = Transformer(cfg)
        cpu_model.set_dict(named)
    del named
    last = f'dec_{cfg.n_layer - 1}'
    names = ('src_emb.weight', 'enc_0.attn.q.weight', f'{last}.ffn.fc2.weight',
             f'{last}.ln3.bias', 'proj.weight')
    out = {}
    for where, place, m in (('card', gpu, model), ('cpu', cpu, cpu_model)):
        with dygraph.guard(place):
            logits = m(dygraph.to_variable(src[:2]),
                       dygraph.to_variable(trg[:2]))
            loss = transformer_loss(logits, dygraph.to_variable(lbl[:2]))
            loss.backward()
            params = dict(m.named_parameters())
            out[where] = (
                logits.numpy(), float(loss.numpy()),
                {n: params[n].gradient() for n in names})
            m.clear_gradients()
    (gl, gloss, gg), (cl, closs, cg) = out['card'], out['cpu']
    err = float(np.abs(gl - cl).max())
    lerr = abs(gloss - closs) / abs(closs)
    gerr = {n: float(np.abs(gg[n] - cg[n]).max() / np.abs(cg[n]).max())
            for n in names}
    log(f'Transformer-big card vs CPU, f32, batch 2: logits max|diff| '
        f'{err:.3e} (atol {NMT_ATOL} + rtol {NMT_RTOL}), loss {gloss!r} vs '
        f'{closs!r} (relative {lerr:.3e}, limit {NMT_RTOL}); gradients '
        f'max|diff| / max|grad|: ' + ', '.join(
            f'{n} {e:.3e}' for n, e in gerr.items())
        + f' (limit {NMT_GRAD_RTOL})')
    if not np.allclose(gl, cl, atol=NMT_ATOL, rtol=NMT_RTOL) \
            or not lerr <= NMT_RTOL \
            or not max(gerr.values()) <= NMT_GRAD_RTOL:
        raise AssertionError('Transformer-big on the card differs from the '
                             'CPU')

    # 2. the user loop of README's dygraph script, f32: backward ->
    # Adam(NoamDecay(1024, 4000)).minimize -> clear_gradients
    feeds = [torch.from_numpy(a).cuda() for a in (src, trg, lbl)]
    with dygraph.guard(gpu):
        sched = dygraph.NoamDecay(1024, 4000)
        opt = fluid.optimizer.Adam(learning_rate=sched,
                                   parameter_list=model.parameters())
        losses, rates, secs = [], [], []
        for n in range(1, 4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = transformer_loss(model(dygraph.to_variable(feeds[0]),
                                          dygraph.to_variable(feeds[1])),
                                    dygraph.to_variable(feeds[2]))
            loss.backward()
            rates.append(opt.current_step_lr)
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()))
            secs.append(time.perf_counter() - t)
            want = noam_rate(1024, 4000, n)
            if abs(rates[-1] - want) > 1e-12 * want:
                raise AssertionError(f'NoamDecay rate {rates[-1]} at step '
                                     f'{n}, formula {want}')
    log(f'user loop (f32, Adam(NoamDecay(1024, 4000))): losses '
        + ' '.join(repr(v) for v in losses) + '; rates '
        + ' '.join(f'{r:.6e}' for r in rates) + ' (the formula\'s); step ms '
        + ' '.join(f'{s * 1e3:.1f}' for s in secs))
    if not all(np.isfinite(losses)):
        raise AssertionError(f'user-loop losses not finite: {losses}')
    del opt
    torch.cuda.empty_cache()

    # 3. TrainStep(amp_dtype=bf16) with Adam(1e-4), as bench.py runs it
    def loss_fn(m, s, t, y):
        return transformer_loss(m(s, t), y)

    params = model.parameters()
    step = TrainStep(model, loss_fn, Adam(1e-4, parameter_list=params),
                     amp_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, host = [], [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(*feeds)
        host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    log('Transformer-big bf16 AMP losses: ' + ' '.join(repr(v)
                                                       for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    if not all(p.dtype == torch.float32 and type(p) is dygraph.Parameter
               for p in model.parameters()) or model.parameters() != params:
        raise AssertionError('a master parameter is not an f32 Parameter '
                             'after the AMP steps')
    timed_s = secs[WARMUP_STEPS:]
    tokens = NMT_BATCH * 2 * NMT_SEQ
    tok_s = tokens * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    flops = nmt_flops_per_token(cfg, NMT_SEQ)
    log(f'Transformer-big trained [{card}]: {len(losses)} steps '
        f'({WARMUP_STEPS} warm-up), {tok_s:.1f} tokens/s (bench.py\'s count, '
        f'{tokens} source + target tokens a step) over the {TRAIN_STEPS} '
        f'timed steps, step p50 {p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, '
        f'max {max(timed_s) * 1e3:.3f}); host dispatch p50 '
        f'{statistics.median(host[WARMUP_STEPS:]) * 1e3:.3f} ms (the call '
        f'returning, before the sync); peak device memory {peak} bytes; '
        f'model FLOPs {flops / 1e9:.4f} G per token, '
        f'{flops * tok_s / 1e12:.1f} TFLOP/s = '
        f'{flops * tok_s / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s bf16')
    profile_train_step(step, feeds, p50, card, {
        'all kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
        'gemm': lambda key: any(s in key.lower() for s in (
            'gemm', 'nvjet', 'sm90_', 'cutlass', 'xmma')),
        'multi-tensor (optimizer, casts)': lambda key: 'multi_tensor' in key
        or 'foreach' in key.lower(),
        'softmax': lambda key: 'softmax' in key.lower(),
        'layer norm': lambda key: 'layer_norm' in key.lower(),
        'elementwise': lambda key: 'elementwise' in key,
        'reductions': lambda key: 'reduce_kernel' in key,
        'embedding': lambda key: 'embedding' in key.lower()
        or 'index' in key.lower(),
        'copies and fills': lambda key: key.startswith(('Memcpy',
                                                        'Memset'))},
        what='Transformer-big bf16 step')
    del step
    torch.cuda.empty_cache()

    # 4. checkpoint: save_dygraph of the trained state, load_dygraph into a
    # fresh model, identical logits
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'paddle_tpu_torch', 'build', 'smoke_ckpt',
                        'transformer')
    t = time.perf_counter()
    dygraph.save_dygraph(model.state_dict(), path)
    saved_s = time.perf_counter() - t
    state, _ = dygraph.load_dygraph(path)
    shutil.rmtree(os.path.dirname(path))
    with dygraph.guard(gpu), torch.no_grad():
        fresh = Transformer(cfg)
        fresh.set_dict(state)
        model.eval()
        fresh.eval()
        a = model(feeds[0][:4], feeds[1][:4])
        b = fresh(feeds[0][:4], feeds[1][:4])
        same = torch.equal(a, b)
    log(f'checkpoint: save_dygraph of {len(state)} arrays in {saved_s:.1f} '
        f's, load_dygraph into a fresh model: logits identical {same} '
        f'(max|diff| {float((a - b).abs().max()):.3e})')
    if not same:
        raise AssertionError('a reloaded checkpoint gives other logits')
    del fresh, a, b, state
    torch.cuda.empty_cache()

    # 5. decode on two source rows, the card against the CPU, the trained
    # weights
    cpu_model.set_dict(model.state_dict())
    cpu_model.eval()
    rows = src[:2]
    res = {}
    for where, place, m in (('card', gpu, model), ('cpu', cpu, cpu_model)):
        with dygraph.guard(place):
            t = time.perf_counter()
            g = greedy_decode(m, rows, 1, 2, max_len=NMT_DECODE_LEN)
            g_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            b = beam_search_decode(m, rows, 1, 2, beam_size=4,
                                   max_len=NMT_DECODE_LEN)
            b_ms = (time.perf_counter() - t) * 1e3
        res[where] = (g, b, g_ms, b_ms)
    (gg, gb, ggms, gbms), (cg_, cb, cgms, cbms) = res['card'], res['cpu']
    log(f'decode of 2 rows, max_len {NMT_DECODE_LEN} [{card}]: greedy '
        f'{ggms:.1f} ms on the card ({cgms:.1f} ms on the CPU), beam 4 '
        f'{gbms:.1f} ms ({cbms:.1f} ms); greedy tokens equal '
        f'{np.array_equal(gg, cg_)}, beam tokens equal '
        f'{np.array_equal(gb, cb)}; card greedy {gg.tolist()}, beam '
        f'{gb.tolist()}')
    with dygraph.guard(cpu):
        decode_equal_or_near_tie(cpu_model, rows, gg, cg_, 2, 'greedy')
        beam_equal_or_near_tie(cpu_model, rows, gb, cb, 2, 0.6, 'beam')
    del cpu_model
    return nn_ops.launch_counts()


def ernie_config(fused=False):
    """bench.py bench_ernie's on-chip configuration: ERNIE-base, dropouts
    0, 128 positions."""
    from paddle_tpu_torch.models.ernie import ErnieConfig
    return ErnieConfig.base(attention_probs_dropout_prob=0.0,
                            hidden_dropout_prob=0.0,
                            max_position_embeddings=ERNIE_SEQ,
                            use_fused_attention=fused)


def ernie_loss(m, ids, tt, y):
    """bench.py bench_ernie's loss: the logits cast to f32, softmax cross
    entropy, the batch mean."""
    from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
    loss, _ = softmax_with_cross_entropy(m(ids, tt).float(), y)
    return loss.mean()


def ernie_calls(step, feeds, calls):
    """(losses, seconds) of ``calls`` calls of ``step``, each
    synchronised."""
    import torch
    losses, secs = [], []
    for _ in range(calls):
        t = time.perf_counter()
        loss = step(*feeds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    return losses, secs


def update_errors(before, card, cpu):
    """Per parameter, the largest entry of |card update - CPU update| less
    one f32 spacing of the CPU's parameter (in f64), and the largest entry
    each side's update moved by: ``before``, ``card`` and ``cpu`` are
    {name: array} of the parameters before and after one step."""
    errs, card_moved, cpu_moved = {}, 0.0, 0.0
    for n, b in before.items():
        b = np.asarray(b, np.float64)
        dg = np.asarray(card[n], np.float64) - b
        dc = np.asarray(cpu[n], np.float64) - b
        room = np.spacing(np.abs(cpu[n]).astype(np.float32))
        errs[n] = float((np.abs(dg - dc) - room).max())
        card_moved = max(card_moved, float(np.abs(dg).max()))
        cpu_moved = max(cpu_moved, float(np.abs(dc).max()))
    return errs, card_moved, cpu_moved


def check_ernie_card_against_cpu(named, feeds, card):
    """Phase 10, part 1: ERNIE-base at batch 2 on the card and on the CPU
    from the same weights: f32 logits and gradients, then one
    ``finetune_optimizer`` step (L2Decay 0.01, LinearLrWarmup over 100
    steps, ``decorate``) through the user loop; then an overflow step on
    the card, which ``decorate`` skips and counts."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models.ernie import (
        ErnieForSequenceClassification, finetune_optimizer)
    cfg = ernie_config()
    names = ('backbone.word_emb.weight', 'backbone.encoder.0.attn.q.weight',
             f'backbone.encoder.{cfg.num_hidden_layers - 1}.ffn2.weight',
             'backbone.pooler.weight',
             'classifier.weight')
    out = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        with dygraph.guard(place):
            m = ErnieForSequenceClassification(cfg, dropout=0.0)
            m.set_dict(named)
            opt = finetune_optimizer(m, 5e-5, warmup_steps=100,
                                     weight_decay=0.01, use_amp=True)
            ids, tt, y = (dygraph.to_variable(a) for a in feeds)
            logits = m(ids, tt)
            loss = ernie_loss(m, ids, tt, y)
            loss.backward()
            params = dict(m.named_parameters())
            grads = {n: params[n].grad.cpu().numpy() for n in names}
            rate = opt.current_step_lr
            opt.minimize(loss)
            m.clear_gradients()
            out[where] = (logits.numpy(), loss.item(), grads,
                          {n: p.detach().cpu().numpy()
                           for n, p in params.items()}, rate)
            if where == 'card':
                card_model, card_opt = m, opt
    (gl, gloss, gg, gp, grate), (cl, closs, cg, cp, crate) = (out['card'],
                                                               out['cpu'])
    err = float(np.abs(gl - cl).max())
    lerr = abs(gloss - closs) / abs(closs)
    gerr = {n: float(np.abs(gg[n] - cg[n]).max() / np.abs(cg[n]).max())
            for n in names}
    uerr, gmoved, cmoved = update_errors(named, gp, cp)
    worst = max(uerr, key=uerr.get)
    log(f'ERNIE-base card vs CPU [{card}], f32, batch {ERNIE_CHECK_BATCH} '
        f'x {ERNIE_SEQ}: logits max|diff| {err:.3e} (atol {ERNIE_ATOL} + rtol '
        f'{ERNIE_RTOL}), loss {gloss!r} vs {closs!r} (relative {lerr:.3e}, '
        f'limit {ERNIE_RTOL}); gradients max|diff| / max|grad|: '
        + ', '.join(f'{n} {e:.3e}' for n, e in gerr.items())
        + f' (limit {ERNIE_GRAD_RTOL}); one finetune step at rate '
        f'{grate:.3e} (CPU {crate:.3e}): update max|card - CPU| beyond '
        f'one f32 spacing {uerr[worst]:.3e} ({worst}; limit '
        f'{ERNIE_STEP_TOL} of the rate, {ERNIE_STEP_TOL * crate:.3e}) over '
        f'{len(uerr)} parameters; largest entry moved {gmoved:.3e} on the '
        f'card, {cmoved:.3e} on the CPU (at least half the rate on each)')
    if not np.allclose(gl, cl, atol=ERNIE_ATOL, rtol=ERNIE_RTOL) \
            or not lerr <= ERNIE_RTOL \
            or not max(gerr.values()) <= ERNIE_GRAD_RTOL \
            or not uerr[worst] <= ERNIE_STEP_TOL * crate or grate != crate \
            or not min(gmoved, cmoved) >= 0.5 * crate:
        raise AssertionError('ERNIE-base on the card differs from the CPU')

    # an overflow step: one gradient set to inf; decorate skips the update
    # and counts it
    with dygraph.guard(fluid.CUDAPlace(0)):
        ids, tt, y = (dygraph.to_variable(a) for a in feeds)
        loss = ernie_loss(card_model, ids, tt, y)
        loss.backward()
        before = {n: p.detach().clone()
                  for n, p in card_model.named_parameters()}
        card_model.classifier.weight.grad[0, 0] = float('inf')
        skips = card_opt.overflow_steps()
        card_opt.minimize(loss)
        kept = all(torch.equal(p, before[n])
                   for n, p in card_model.named_parameters())
        cleared = all(p.grad is None for p in card_model.parameters())
    log(f'overflow step [{card}]: an inf gradient; skipped {kept}, '
        f'gradients cleared {cleared}, overflow_steps {skips} -> '
        f'{card_opt.overflow_steps()}, loss scale '
        f'{card_opt.get_loss_scaling()}')
    if not (kept and cleared and card_opt.overflow_steps() == skips + 1):
        raise AssertionError('decorate did not skip the overflow step')
    del card_model, card_opt, before
    torch.cuda.empty_cache()


def train_ernie(seed, card):
    """Phase 10: ERNIE-base finetuning through the dygraph API under
    ``guard(CUDAPlace(0))`` at bench.py's on-chip configuration, unfused
    (the config's default; no kernel of the port) and with
    ``use_fused_attention=True`` (K3 and K3b). Returns the kernels' launch
    counts over the fused run."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.convert import ernie_init_params
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.ernie import (
        ErnieForSequenceClassification, finetune_optimizer)
    from paddle_tpu_torch.ops import nn_ops

    t0 = time.perf_counter()
    cfg = ernie_config()
    named = ernie_init_params(cfg, seed)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size,
                      (ERNIE_BATCH, ERNIE_SEQ)).astype(np.int64)
    tt = np.zeros((ERNIE_BATCH, ERNIE_SEQ), np.int64)
    y = rng.randint(0, 2, (ERNIE_BATCH, 1)).astype(np.int64)
    log(f'ERNIE-base: ErnieConfig.base(vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, {cfg.num_hidden_layers} layers, '
        f'{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, '
        f'{cfg.max_position_embeddings} positions, dropouts 0), '
        f'{sum(a.size for a in named.values())} parameters; batch '
        f'{ERNIE_BATCH} x {ERNIE_SEQ}, accum_steps {ERNIE_ACCUM}; weights '
        f'made in {time.perf_counter() - t0:.1f} s')

    # 1. the card against the CPU, and an overflow step
    check_ernie_card_against_cpu(
        named, [a[:ERNIE_CHECK_BATCH] for a in (ids, tt, y)], card)

    # 2. bench.py's loop: bf16 TrainStep(accum_steps=4) with the finetune
    # optimizer, 2 warm-up and 16 timed calls, unfused attention
    gpu = fluid.CUDAPlace(0)
    feeds = [torch.from_numpy(a).cuda() for a in (ids, tt, y)]
    with dygraph.guard(gpu):
        model = ErnieForSequenceClassification(cfg, dropout=0.0)
        model.set_dict(named)
        opt = finetune_optimizer(model, 5e-5, warmup_steps=100,
                                 weight_decay=0.01, use_amp=True)
        step = TrainStep(model, ernie_loss, opt, amp_dtype=torch.bfloat16,
                         accum_steps=ERNIE_ACCUM)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nn_ops.reset_launch_counts()
        losses, secs = ernie_calls(step, feeds, WARMUP_STEPS + ERNIE_CALLS)
        unfused_launches = nn_ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    log('ERNIE-base bf16 AMP losses: ' + ' '.join(repr(v) for v in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f'ERNIE losses not finite: {losses}')
    if any(unfused_launches.values()):
        raise AssertionError(f'kernels launched on the unfused ERNIE path: '
                             f'{unfused_launches}')
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError('a master parameter is not f32 after the AMP '
                             'calls')
    timed_s = secs[WARMUP_STEPS:]
    seq_s = ERNIE_BATCH * ERNIE_CALLS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    h, layers = cfg.hidden_size, cfg.num_hidden_layers
    # bench.py bench_ernie's analytic train FLOPs per sequence
    flops_per_seq = ERNIE_SEQ * (72.0 * layers * h * h
                                 + 12.0 * layers * h * ERNIE_SEQ)
    log(f'ERNIE-base finetuned [{card}]: {len(losses)} calls '
        f'({WARMUP_STEPS} warm-up), {seq_s:.1f} seq/s (bench.py\'s '
        f'count, batch x calls / time) over the {ERNIE_CALLS} timed calls, '
        f'call '
        f'p50 {p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); an update every {ERNIE_ACCUM} calls; '
        f'rate after them {opt.current_step_lr:.4e}; peak device memory '
        f'{peak} bytes; model FLOPs {flops_per_seq / 1e9:.2f} G per '
        f'sequence, {flops_per_seq * seq_s / 1e12:.1f} TFLOP/s = '
        f'{flops_per_seq * seq_s / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s '
        f'bf16; kernel launches {unfused_launches}')
    merge_ms = sorted(sum(timed_s[i:i + ERNIE_ACCUM]) * 1e3
                      for i in range(0, ERNIE_CALLS, ERNIE_ACCUM))
    profile_train_step(
        step, feeds, statistics.median(merge_ms), card, {
            'all kernels': lambda key: not key.startswith(('Memcpy',
                                                           'Memset')),
            'gemm': lambda key: any(s in key.lower() for s in (
                'gemm', 'nvjet', 'sm90_', 'cutlass', 'xmma')),
            'multi-tensor (optimizer, regularizer, clip, casts)':
                lambda key: 'multi_tensor' in key or 'foreach' in key.lower(),
            'softmax': lambda key: 'softmax' in key.lower(),
            'layer norm': lambda key: 'layer_norm' in key.lower(),
            'elementwise': lambda key: 'elementwise' in key,
            'reductions': lambda key: 'reduce_kernel' in key,
            'copies and fills': lambda key: key.startswith(('Memcpy',
                                                            'Memset'))},
        what=f'ERNIE-base bf16 merge of {ERNIE_ACCUM} calls (host clock: '
             f'the p50 of the timed merges)', calls=ERNIE_ACCUM)
    del step, opt, model
    torch.cuda.empty_cache()

    # 3. the fused path: the same loop through the flash kernels; f32 loss
    # against the unfused model first, from the same weights
    with dygraph.guard(gpu):
        fused = ErnieForSequenceClassification(ernie_config(True),
                                               dropout=0.0)
        fused.set_dict(named)
        unfused = ErnieForSequenceClassification(cfg, dropout=0.0)
        unfused.set_dict(named)
        small = [f[:ERNIE_CHECK_BATCH] for f in feeds]
        nn_ops.reset_launch_counts()
        with torch.no_grad():
            yf, yu = fused(*small[:2]), unfused(*small[:2])
            lf = float(ernie_loss(fused, *small))
            lu = float(ernie_loss(unfused, *small))
        f32_fwd = nn_ops.launch_counts()['flash_attention_fwd']
        del unfused
        torch.cuda.empty_cache()
        rel = abs(lf - lu) / abs(lu)
        log(f'ERNIE-base f32 at batch {ERNIE_CHECK_BATCH} [{card}]: fused '
            f'loss '
            f'{lf!r} unfused {lu!r}, relative difference {rel:.3e} (limit '
            f'1e-4); logits max|diff| {float((yf - yu).abs().max()):.3e}; '
            f'{f32_fwd} flash forward launches (2 passes x {layers} '
            f'layers)')
        if not rel <= 1e-4 or f32_fwd != 2 * layers:
            raise AssertionError(f'fused and unfused ERNIE losses differ by '
                                 f'{rel}, or the fused model ran {f32_fwd} '
                                 f'flash forward launches')
        opt = finetune_optimizer(fused, 5e-5, warmup_steps=100,
                                 weight_decay=0.01, use_amp=True)
        step = TrainStep(fused, ernie_loss, opt, amp_dtype=torch.bfloat16,
                         accum_steps=ERNIE_ACCUM)
        torch.cuda.synchronize()
        nn_ops.reset_launch_counts()
        losses, secs = ernie_calls(step, feeds,
                                   WARMUP_STEPS + ERNIE_FUSED_CALLS)
        launches = nn_ops.launch_counts()
    calls = WARMUP_STEPS + ERNIE_FUSED_CALLS
    want = cfg.num_hidden_layers * calls
    log('ERNIE-base fused bf16 AMP losses: ' + ' '.join(repr(v)
                                                        for v in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f'fused ERNIE losses not finite: {losses}')
    for name in FLASH_STOCK:
        if launches[name] != want:
            raise AssertionError(f'{name}: {launches[name]} launches for '
                                 f'{calls} calls x {layers} layers')
    timed_s = secs[WARMUP_STEPS:]
    fseq_s = ERNIE_BATCH * ERNIE_FUSED_CALLS / sum(timed_s)
    log(f'ERNIE-base fused attention [{card}]: {calls} calls '
        f'({WARMUP_STEPS} warm-up), {fseq_s:.1f} seq/s over the '
        f'{ERNIE_FUSED_CALLS} timed calls (unfused {seq_s:.1f}), call p50 '
        f'{statistics.median(timed_s) * 1e3:.3f} ms (min '
        f'{min(timed_s) * 1e3:.3f}, max {max(timed_s) * 1e3:.3f}); '
        f'launches {launches} ({calls} calls x {layers} layers = {want} '
        f'each)')
    del step, opt, fused
    torch.cuda.empty_cache()
    return launches


def k4_layers(model):
    """(name, ConvBNLayer) of the model's stride-1 1x1 ConvBNLayers, the
    layers K4 takes: every bottleneck's conv0 (relu) and conv2 (no act),
    and the first stage's stride-1 shortcut."""
    from paddle_tpu_torch.models.resnet import ConvBNLayer
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, ConvBNLayer)
            and tuple(m._conv.weight.shape[2:]) == (1, 1)
            and m._conv._attrs['stride'] == 1]


def check_k4_on_model(model, x, card):
    """Phase 7, K4's path: the trained model in eval mode; each of its 33
    stride-1 1x1 ConvBNLayers' input and output captured in one eval
    forward, in f32 and with the weights cast to bf16; the layer's BN
    folded (scale = gamma / sqrt(var + eps), shift = beta - mean * scale,
    from the f32 masters) and run through ``fused_conv1x1_bn_act``.

    f32 is held to atol and rtol 1e-4. In bf16 the layer rounds seven times
    (its conv output, the mean, the rsqrt, the difference, two products
    and the sum) besides the AMP cast of gamma and beta, K4 three times
    (scale, shift, its output); each rounding moves the output by at most
    2**-8 of one of |c s|, |mean s|, |beta|, |y| (c the f32 conv sum, s
    the folded scale), and together they come to at most 7 * 2**-8 of
    their sum B: the bound is 2**-5 B, elementwise.

    Every bf16 layer is a shape the TMA loads of K4's wgmma body describe,
    so the bf16 pass launches that body 33 times (its own counter), the f32
    pass the f32 body.

    Returns (launches in the two passes, the wgmma body's under
    ``'conv1x1_bn_act wgmma'``; the 33 layers' (B, H, W, K, N))."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.pallas_conv import (conv1x1_bn_act,
                                                  fused_conv1x1_bn_act)
    layers = k4_layers(model)
    if len(layers) != K4_PER_PASS:
        raise AssertionError(f'{len(layers)} stride-1 1x1 ConvBNLayers, '
                             f'expected {K4_PER_PASS}')
    model.eval()
    shapes = []
    wgmma_launches = 0
    nn_ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        captured = {}
        hooks = [m.register_forward_hook(
            lambda mod, args, out, n=n: captured.__setitem__(n, (args[0],
                                                                 out)))
            for n, m in layers]
        params = {n: p.detach().to(dtype)
                  for n, p in model.named_parameters()}
        with torch.no_grad():
            torch.func.functional_call(model, params, (x.to(dtype),))
        for h in hooks:
            h.remove()
        before = conv1x1_bn_act.launches
        before_wgmma = conv1x1_bn_act.launches_wgmma
        worst, worst_b = 0.0, 0.0
        for n, m in layers:
            xin, want = captured.pop(n)
            bn = m._bn
            scale = bn.weight.detach() / torch.sqrt(
                bn._variance_buf + bn._attrs['epsilon'])
            shift = bn.bias.detach() - bn._mean_buf * scale
            w = params[f'{n}._conv.weight']
            with torch.no_grad():
                got = fused_conv1x1_bn_act(xin, w, scale, shift, act=m._act)
            if dtype == torch.float32:
                b, h, ww, k = xin.shape
                shapes.append((b, h, ww, k, w.shape[0]))
                worst = max(worst, compare(f'K4 on {n} f32', got, want,
                                           1e-4, 1e-4))
                worst_b = max(worst_b, ((got - want).abs()
                                        / (1e-4 + 1e-4 * want.abs()))
                              .max().item())
                continue
            torch.cuda.synchronize()
            k = xin.shape[-1]
            c = (xin.reshape(-1, k).float()
                 @ w.reshape(-1, k).float().t()).reshape(got.shape)
            bound = (c * scale).abs() + (bn._mean_buf * scale).abs() \
                + bn.bias.detach().abs() + want.float().abs()
            err = (got.float() - want.float()).abs()
            if not bool((err <= 2 ** -5 * bound).all()):
                raise AssertionError(f'K4 on {n} bf16: max|diff| '
                                     f'{err.max().item():.3e} beyond 2**-5 '
                                     f'of B')
            worst = max(worst, err.max().item())
            worst_b = max(worst_b, (err / bound).max().item())
            del c, bound, err
        torch.cuda.synchronize()
        ran = conv1x1_bn_act.launches - before
        ran_wgmma = conv1x1_bn_act.launches_wgmma - before_wgmma
        # every bf16 layer of the pass is a shape TMA describes
        want_wgmma = K4_PER_PASS if dtype == torch.bfloat16 else 0
        if ran != K4_PER_PASS or ran_wgmma != want_wgmma:
            raise AssertionError(f'K4 launched {ran} times ({ran_wgmma} of '
                                 f'the wgmma body) in one {dtype} pass, '
                                 f'expected {K4_PER_PASS} ({want_wgmma})')
        wgmma_launches += ran_wgmma
        log(f'K4 on the trained model, eval {dtype} [{card}]: 33 layers, '
            f'{ran} launches ({ran_wgmma} of the wgmma body), max|diff| '
            f'against the layers {worst:.3e}'
            + (f', max |diff| / (1e-4 + 1e-4 |y|) {worst_b:.3e} (limit 1)'
               if dtype == torch.float32 else
               f', max |diff| / B {worst_b:.3e} (limit 2**-5 = 0.03125)'))
        del captured, params
        torch.cuda.empty_cache()
    launches = nn_ops.launch_counts()
    launches['conv1x1_bn_act wgmma'] = wgmma_launches
    return launches, shapes


def k4_inputs(shape, dtype, dev, gen):
    """``tools/bench_fused_conv.py``'s inputs at (B, H, W, K, N)."""
    import torch
    b, h, w, k, n = shape

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev)

    return ((randn(b, h, w, k)).to(dtype),
            (randn(n, k, 1, 1) * 0.05).to(dtype),
            (torch.rand(n, generator=gen, device=dev) + 0.5).to(dtype),
            (randn(n) * 0.1).to(dtype))


def bf16_ulp_err(got, want, atol=1e-5):
    """max |got - want| after one bf16 ulp of the larger magnitude (plus
    ``atol`` for values ReLU cuts at zero) is taken off; <= 0 passes."""
    import torch
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    return ((got - want).abs() - ulp - atol).max().item()


def check_k4_kernel(layer_shapes, dev, card):
    """Phase 7, K4 against its plain version at every distinct shape of its
    path (``layer_shapes``, one per layer), bf16 and f32, act None and
    relu, then its device time (relu) beside the plain version, the
    library yardstick and the bound, kernel / library, and the body and
    tile the launcher chose; a row per shape, and those times summed over
    the path's layers. Returns the kernels-line entry at
    tools/bench_fused_conv.py's first shape (256 -> 64 at 56x56), bf16."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas_conv import (conv1x1_bn_act,
                                                  conv1x1_plan,
                                                  fused_conv1x1_bn_act_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    entry = None
    per_pass = {}             # dtype label -> summed ms over the layers
    rows = []
    for shape in dict.fromkeys(layer_shapes):
        b, h, w, k, n = shape
        m = b * h * w
        cells = []
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, sc, sh = k4_inputs(shape, dtype, dev, gen)
            plan = conv1x1_plan(x, wt, sc, sh)
            errs = []
            for act in (None, 'relu'):
                got = conv1x1_bn_act(x, wt, sc, sh, act=act)
                want = fused_conv1x1_bn_act_ref(x, wt, sc, sh, act=act)
                if dtype == torch.bfloat16:
                    torch.cuda.synchronize()
                    over = bf16_ulp_err(got, want)
                    if over > 0:
                        raise AssertionError(f'K4 {shape} bf16 act={act}: '
                                             f'beyond one bf16 ulp by '
                                             f'{over:.3e}')
                    errs.append((got.float() - want.float()).abs().max()
                                .item())
                else:
                    errs.append(compare(f'K4 {shape} f32 act={act}', got,
                                        want, 1e-4, 1e-4))
            wl = (wt * sc.view(-1, 1, 1, 1)).contiguous(
                memory_format=torch.channels_last)
            xl = x.permute(0, 3, 1, 2)            # channels_last view

            def library():
                return F.conv2d(xl, wl, sh).relu_()

            tm = times_of(
                timed(lambda: conv1x1_bn_act(x, wt, sc, sh, act='relu'),
                      iters=50),
                timed(lambda: fused_conv1x1_bn_act_ref(x, wt, sc, sh,
                                                       act='relu'),
                      iters=50),
                timed(library, iters=50))
            es = x.element_size()
            nbytes = (m * k + n * k + m * n + 2 * n) * es
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
                else F32_FLOPS_PER_S
            bms, by = bound_ms(nbytes, 2 * m * n * k, peak)
            tm.update(bound_ms=bms, bound_by=by)
            label = 'bf16' if dtype == torch.bfloat16 else 'f32'
            body = f'{plan["body"]} 128x{plan["bn"]}'
            ratio = tm['ms'] / tm['library_ms']
            log(f'K4 {k}->{n}@{h}x{w} (M {m}) {label} [{card}]: body {body}, '
                f'{plan["grid"]} CTAs, {plan["stages"]} stages; max|diff| '
                f'{max(errs):.3e}; {fmt_times(tm, "conv2d")}; kernel / '
                f'conv2d {ratio:.3f}')
            cells.append(f'{label} {body} {tm["ms"]:.5f} / '
                         f'{tm["plain_ms"]:.5f} / {tm["library_ms"]:.5f} / '
                         f'{tm["bound_ms"]:.5f} ({ratio:.2f})')
            total = per_pass.setdefault(label, dict.fromkeys(
                ('ms', 'plain_ms', 'library_ms', 'bound_ms'), 0.0))
            for key in total:
                total[key] += layer_shapes.count(shape) * tm[key]
            if (k, n, h, label) == (256, 64, 56, 'bf16'):
                entry = {'name': 'conv1x1_bn_act', 'route': 'cuda',
                         'source': 'paddle_tpu_torch/csrc/conv1x1_bn_act.cu',
                         'replaces': 'paddle_tpu/ops/pallas_conv.py:93',
                         'body': body,
                         'shape': f'M={m} K={k} N={n} ({k}->{n}@{h}x{w}, '
                                  f'batch {b}) {label}, relu',
                         'max_abs_err': max(errs), **tm}
            del x, wt, sc, sh, wl, xl
        rows.append(f'{k}->{n} @{h} x{layer_shapes.count(shape)}: '
                    + '; '.join(cells))
        torch.cuda.empty_cache()
    log(f'K4 by shape [{card}] (kernel / plain / conv2d + relu_ / bound ms, '
        f'kernel / conv2d):')
    for row in rows:
        log(f'  {row}')
    for label, t in per_pass.items():
        log(f'K4 over the {len(layer_shapes)} layers of one {label} pass '
            f'[{card}]: kernel {t["ms"]:.5f} ms, plain {t["plain_ms"]:.5f} '
            f'ms, conv2d {t["library_ms"]:.5f} ms, bound {t["bound_ms"]:.5f} '
            f'ms')
    if entry is None:
        raise AssertionError('the path has no 256 -> 64 layer at 56x56')
    return entry


def post(port, body, timeout=600):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
    if not body.get('stream', True):
        reply = json.loads(raw)
        return reply['tokens'], reply['finish_reason']
    lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
    if 'error' in lines[-1]:
        raise RuntimeError(f'stream failed: {lines[-1]}')
    tokens = [ln['token'] for ln in lines[:-1]]
    if tokens != lines[-1]['tokens']:
        raise AssertionError('streamed tokens differ from the final line')
    return tokens, lines[-1]['finish_reason']


def served_mix(seed, vocab):
    """Phase 4's seeded mix of 16 ``/generate`` requests: prompts of 16-256
    tokens, budgets of 16-48 and, every fourth, 96-128; half streamed."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 257))
        budget = int(rng.randint(96, 129) if i % 4 == 3
                     else rng.randint(16, 49))
        prompt = [int(t) for t in rng.randint(0, vocab, n)]
        reqs.append({'prompt': prompt, 'max_new_tokens': budget,
                     'stream': i % 2 == 0, 'request_id': f'smoke-{i}'})
    return reqs, rng


def scrape_metrics(port):
    """``GET /metrics`` of the server on ``port``, parsed."""
    from paddle_tpu_torch.observability import distributed
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/metrics',
                                timeout=60) as r:
        return distributed.parse_prometheus_text(r.read().decode())


def metric_total(fams, name, suffix=''):
    """Sum over the samples of family ``name`` (prefixed) whose sample
    name ends with ``suffix``; 0 for a family the export lacks."""
    fam = fams.get('paddle_tpu_' + name)
    if fam is None:
        return 0.0
    return sum(v for s, _, v in fam['samples'] if s.endswith(suffix))


def drive_mix(engine, sched, reqs, scraped=None):
    """Serve ``reqs`` concurrently through a ``ServingServer`` over
    ``sched`` (warmed first): every request must end with its full budget,
    and K1 must launch once a layer for every decode step and verify round,
    K2 once a layer for every prefill. With ``scraped`` (a dict) the
    server's ``/metrics`` is read just before the clients start and just
    after they end, into its 'before' and 'after'. Returns (results, wall
    seconds, launch counts, the engine's stats, peak device memory)."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.serving import ServingServer
    srv = ServingServer(None, port=0, generator=sched, warmup=True,
                        request_timeout=600).start()
    try:
        results = [None] * len(reqs)

        def client(i):
            results[i] = post(srv.port, reqs[i])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if scraped is not None:
            scraped['before'] = scrape_metrics(srv.port)
        nn_ops.reset_launch_counts()
        engine.reset_stats()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = nn_ops.launch_counts()
        stats = engine.stats
        peak = torch.cuda.max_memory_allocated()
        if scraped is not None:
            scraped['after'] = scrape_metrics(srv.port)
    finally:
        srv.shutdown()
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError('a /generate request did not finish')
    for r, (tokens, reason) in zip(reqs, results):
        if len(tokens) != r['max_new_tokens'] or reason != 'length':
            raise AssertionError(
                f'{r["request_id"]}: {len(tokens)} tokens ({reason}), '
                f'budget {r["max_new_tokens"]}')
    layers = engine.model.cfg.num_hidden_layers
    if stats['prefills'] != len(reqs):
        raise AssertionError(f'{stats["prefills"]} prefills for '
                             f'{len(reqs)} requests')
    if launches['paged_attention'] != stats['decode_steps'] * layers:
        raise AssertionError(f'K1 launches {launches} != (decode steps + '
                             f'verify rounds) {stats["decode_steps"]} x '
                             f'{layers}')
    if launches['paged_prefill_attention'] != stats['prefills'] * layers:
        raise AssertionError(f'K2 launches {launches} != prefills '
                             f'{stats["prefills"]} x {layers}')
    return results, wall, launches, stats, peak


def served_line(label, card, reqs, results, wall, stats, peak):
    generated = sum(len(t) for t, _ in results)
    steps_ms = sorted(1e3 * s for s in stats['step_seconds'])
    prefill_ms = {b: round(1e3 * statistics.median(v), 3)
                  for b, v in sorted(stats['prefill_seconds'].items())}
    log(f'{label} [{card}]: {len(reqs)} requests, {generated} tokens in '
        f'{wall:.3f} s = {generated / wall:.1f} tokens/s; '
        f'{stats["decode_steps"]} decode steps ({stats["spec_rounds"]} '
        f'verify rounds), p50 {statistics.median(steps_ms):.3f} ms; prefill '
        f'median ms by rung {prefill_ms}; peak device memory {peak} bytes')


def serve(seed, card):
    """Phase 4: the f32 replica stack at full width on the seeded mix.
    Returns the launch counts, the model, the requests and their results
    (phase 16's f32 reference)."""
    from paddle_tpu_torch.models.causal_lm import (greedy_generate,
                                                   max_logit_gaps)
    from paddle_tpu_torch.serving.tier.replica import (build_lm,
                                                       build_replica_stack)
    t0 = time.perf_counter()
    model = build_lm('default', seed, 'cuda')
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    engine, sched, _ = build_replica_stack(model)
    reqs, rng = served_mix(seed, cfg.vocab_size)
    scraped = {}
    results, wall, launches, stats, peak = drive_mix(engine, sched, reqs,
                                                     scraped)
    log(f'served model: CausalLMConfig() {n_params} parameters, '
        f'{cfg.num_hidden_layers} layers; engine slots={engine.slots} '
        f'block={engine.block_size} ladder={engine.prompt_buckets} '
        f'padded_context={engine.padded_context}; built, warmed and served '
        f'in {time.perf_counter() - t0:.1f} s')
    # two streamed requests against the uncached reference on the card
    for i in (0, 3):
        r, tokens = reqs[i], results[i][0]
        gaps = max_logit_gaps(model, r['prompt'], tokens,
                              pad_len=engine.padded_context)
        ref = greedy_generate(model, r['prompt'], len(tokens),
                              pad_len=engine.padded_context)
        same = sum(a == b for a, b in zip(tokens, ref))
        log(f'reference {r["request_id"]}: prompt {len(r["prompt"])} '
            f'budget {len(tokens)}: {same}/{len(tokens)} tokens equal to '
            f'greedy_generate, max teacher-forced logit gap '
            f'{gaps.max():.3e} (limit {NEAR_TIE})')
        if gaps.max() > NEAR_TIE:
            raise AssertionError(f'{r["request_id"]}: served token '
                                 f'{gaps.max():.3e} below its row max')
    served_line('served', card, reqs, results, wall, stats, peak)
    log(f'launches on the served path: {launches} '
        f'(decode steps {stats["decode_steps"]}, prefills '
        f'{stats["prefills"]}, layers {cfg.num_hidden_layers})')
    profile_decode_steps(engine, rng, card)
    check_decode_metrics(scraped, launches, results, cfg.num_hidden_layers,
                         card)
    decode_hook_cost(engine, rng, card)
    return launches, model, reqs, results


def check_decode_metrics(scraped, launches, results, layers, card):
    """Phase 19 (d), on phase 4's mix: the decode server's ``/metrics``
    over the 16 requests (read just before and just after them) against
    the kernels' launch counters and the tokens streamed."""
    def delta(name, suffix=''):
        return (metric_total(scraped['after'], name, suffix)
                - metric_total(scraped['before'], name, suffix))

    steps = delta('decode_steps')
    prefills = delta('decode_prefill_seconds', '_count')
    tokens = delta('decode_tokens_generated')
    streamed = sum(len(t) for t, _ in results)
    got = {'K1': launches['paged_attention'],
           'K2': launches['paged_prefill_attention']}
    want = {'K1': steps * layers, 'K2': prefills * layers}
    if got != want or tokens != streamed or \
            delta('decode_requests_completed') != len(results):
        raise AssertionError(f'19 (d): launches {got} against /metrics '
                             f'{want}; tokens {tokens} against {streamed} '
                             f'streamed')
    log(f'19 (d) phase 4\'s decode server, GET /metrics over its '
        f'{len(results)} requests [{card}]: decode_steps {steps:.0f} x '
        f'{layers} layers = K1 launches {got["K1"]}, prefills '
        f'{prefills:.0f} x {layers} = K2 launches {got["K2"]}, '
        f'decode_tokens_generated {tokens:.0f} = tokens streamed')


class _NoHooks:
    """Stands in for the decode engine's metrics and series modules:
    every attribute and call is itself, so a hook site does nothing."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kwargs):
        return self


def decode_hook_cost(engine, rng, card, steps=40, prompt_len=16):
    """Phase 19 (d): phase 4's decode step (every slot active, contexts
    from ``prompt_len`` up) timed on the host clock, ``steps`` steps a
    turn, p50 a turn: telemetry off, on, on, off; then the engine's
    always-on metric hooks stubbed out, on, on, stubbed; the spread of a
    pair of equal turns is the host's noise."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.serving.decode import engine as decode_engine
    vocab = engine.model.cfg.vocab_size
    tables, tokens = [], []
    for _ in range(engine.slots):
        t = engine.reserve_table(prompt_len, 8 * steps + 1)
        tokens.append(engine.prefill(
            [int(x) for x in rng.randint(0, vocab, prompt_len)], t))
        tables.append(t)

    def turn():
        nonlocal tokens
        secs = []
        for _ in range(steps):
            t0 = time.perf_counter()
            tokens = [int(x) for x in engine.decode_step(tokens, tables)]
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs) * 1e3

    hooks = (decode_engine._m, decode_engine._dobs)
    tele = []
    for on in (False, True, True, False):
        with observability.telemetry_guard(on):
            tele.append(turn())
    stub = []
    try:
        for live in (False, True, True, False):
            decode_engine._m, decode_engine._dobs = (
                hooks if live else (_NoHooks(), _NoHooks()))
            stub.append(turn())
    finally:
        decode_engine._m, decode_engine._dobs = hooks
    for t in tables:
        engine.release_table(t)
    fmt = ', '.join
    log(f'19 (d) decode step p50 ms, {engine.slots} active slots [{card}]: '
        f'telemetry off/on/on/off '
        f'{fmt(f"{x:.3f}" for x in tele)} (on - off '
        f'{(tele[1] + tele[2] - tele[0] - tele[3]) / 2:+.3f}, noise: the '
        f'off turns differ by {abs(tele[0] - tele[3]):.3f}, the on turns by '
        f'{abs(tele[1] - tele[2]):.3f}); metric hooks stubbed/on/on/stubbed '
        f'{fmt(f"{x:.3f}" for x in stub)} (hooks - stubbed '
        f'{(stub[1] + stub[2] - stub[0] - stub[3]) / 2:+.3f}, noise '
        f'{abs(stub[0] - stub[3]):.3f} / {abs(stub[1] - stub[2]):.3f})')
    return {'telemetry': tele, 'hooks': stub}


def profile_decode_steps(engine, rng, card, steps=20):
    """Where a decode step's (or, with speculative decoding on, a verify
    round's) time goes, with every slot active at a context of half the
    longest prompt and up: host-clock ms per step (synchronised) against
    the device's busy ms per step (profiler), and the kernels that take
    it. A verify round feeds each slot its pending token and SPEC_K - 1
    copies of it as drafts and keeps one token (the rest rolled back), so
    every round reads the full window."""
    import torch
    vocab = engine.model.cfg.vocab_size
    prompt_len = engine.max_prompt_len // 2
    spec = engine.spec_enabled
    tables, tokens = [], []
    for _ in range(engine.slots):
        # three runs of ``steps`` (timed, then the profiler's two), a token
        # kept a step, and a verify round's window past the last
        t = engine.reserve_table(prompt_len, 3 * steps + engine.spec_k + 1)
        tokens.append(engine.prefill(
            [int(x) for x in rng.randint(0, vocab, prompt_len)], t))
        tables.append(t)

    def run():
        nonlocal tokens
        for _ in range(steps):
            if spec:
                bases = [t.context_len for t in tables]
                rows = engine.spec_step([[tok] * engine.spec_k
                                         for tok in tokens], tables)
                tokens = [int(x) for x in rows[:, 0].argmax(-1)]
                for t, b in zip(tables, bases):
                    t.context_len = b + 1
            else:
                tokens = [int(x) for x in engine.decode_step(tokens, tables)]
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof = profiled(run)
    for t in tables:
        engine.release_table(t)
    what = f'verify round (k={engine.spec_k})' if spec else 'decode step'
    busy_ms = device_us(prof) / 1e3 / steps
    if busy_ms <= 0:
        log(f'{what} [{card}]: {wall_ms:.3f} ms per step; device busy '
            f'share not measured (the profiler recorded no device time)')
        return {'host_ms': wall_ms, 'busy_ms': None, 'idle': None}
    k1 = [e for e in prof.key_averages() if 'paged_decode' in e.key]
    k1_ms = sum(getattr(e, 'self_device_time_total', 0.0)
                for e in k1) / 1e3 / steps
    log(f'{what} [{card}]: {engine.slots} active slots, '
        f'{engine.pool.kv_dtype} pool, context {prompt_len}-'
        f'{prompt_len + 3 * steps}: {wall_ms:.3f} ms per step on the '
        f'host clock, device busy {busy_ms:.3f} ms per step, idle share '
        f'{1 - busy_ms / wall_ms:.3f}; K1 {k1_ms:.4f} ms per step = '
        f'{k1_ms / busy_ms:.3f} of busy, '
        f'{sum(e.count for e in k1) // steps} kernel launches per step')
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, 'self_device_time_total', 0.0))[:8]
    for e in top:
        log(f'  {getattr(e, "self_device_time_total", 0.0) / 1e3 / steps:.4f}'
            f' ms/step  {e.count // steps} calls/step  {e.key[:90]}')
    return {'host_ms': wall_ms, 'busy_ms': busy_ms,
            'idle': 1 - busy_ms / wall_ms}


# Phase 16: the served variants. A quantized pool moves each cached K or V
# element by at most half a step of its storage: int8 absmax / 254 of its
# row, bf16 2**-9 of itself. Taken as a relative error QUANT_HALF_STEP of
# every cached row in each of the model's layers, a logit moves by at most
# that error times the layers times its row's largest magnitude, and a
# served token's teacher-forced gap by twice that (its own logit and the
# row's max): the limit below, derived from the storage and not fitted to a
# run, beside NEAR_TIE's rounding
QUANT_HALF_STEP = {'bf16': 2.0 ** -9, 'int8': 1 / 254}


def teacher_forced(model, prompt, tokens, pad_len):
    """(gaps, largest |logit| of each row) of ``tokens`` under the
    uncached f32 model: one forward over ``prompt + tokens``."""
    import torch
    n = len(prompt)
    buf = torch.zeros((1, pad_len), dtype=torch.long, device=model.device)
    buf[0, :n + len(tokens)] = torch.tensor(list(prompt) + list(tokens))
    with torch.no_grad():
        rows = model(buf)[0, n - 1:n - 1 + len(tokens)].cpu().numpy()
    picked = rows[np.arange(len(tokens)), np.asarray(tokens, np.int64)]
    return rows.max(axis=-1) - picked, np.abs(rows).max(axis=-1)


def serve_variants(model, reqs, f32_results, seed, card):
    """Phase 16: phase 4's seeded mix at full width through the replica
    stack four more times, (a) speculative decoding with the n-gram
    drafter, (b) speculative decoding with a ``DraftModelDrafter`` holding
    the target's own weights (acceptance near 1, the accept path), (c) a
    bf16 pool and (d) an int8 pool. Each: every request its full budget;
    K1 launched (decode steps + verify rounds) x layers, K2 prefills x
    layers; two streams under teacher forcing through the f32 model (the
    near-tie rule for (a) and (b), the quantization limit for (c) and
    (d)); tokens/s, decode-step p50, verify rounds, acceptance, the greedy
    match rate against phase 4's f32 streams, peak memory and the pool's
    bytes; one profiled window of verify rounds or decode steps. Returns
    each run's launch counts, by 'ngram', 'self', 'bf16' and 'int8'."""
    import torch
    from paddle_tpu_torch.serving.decode.drafter import DraftModelDrafter
    from paddle_tpu_torch.serving.tier.replica import (ENGINE_DEFAULTS,
                                                       build_replica_stack)
    from paddle_tpu_torch.ops import nn_ops
    layers = model.cfg.num_hidden_layers
    variants = [('ngram', '(a) spec_decode, n-gram drafter',
                 {'spec_decode': True}, 'ngram'),
                ('self', '(b) spec_decode, the target as its own draft model',
                 {'spec_decode': True}, 'self'),
                ('bf16', '(c) kv_dtype bf16', {'kv_dtype': 'bf16'}, None),
                ('int8', '(d) kv_dtype int8', {'kv_dtype': 'int8'}, None)]
    by_run = {}
    rng = np.random.RandomState(seed + 16)
    for key, label, kw, drafter in variants:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if drafter == 'self':
            geometry = {**ENGINE_DEFAULTS, **kw}
            bs = geometry['block_size']
            pad = -(-(geometry['max_prompt_len']
                      + geometry['max_new_tokens_cap']) // bs) * bs
            drafter = DraftModelDrafter(model, pad)
        engine, sched, _ = build_replica_stack(model, drafter=drafter,
                                               **kw)
        t0 = time.perf_counter()
        results, wall, launches, stats, peak = drive_mix(engine, sched, reqs)
        by_run[key] = launches
        pool = engine.pool
        kv = pool.kv_dtype
        for i in (0, 3):
            r, tokens = reqs[i], results[i][0]
            gaps, scale = teacher_forced(model, r['prompt'], tokens,
                                         engine.padded_context)
            limit = NEAR_TIE + (2 * QUANT_HALF_STEP[kv] * layers * scale
                                if kv != 'f32' else 0.0)
            worst = float((gaps - limit).max())
            log(f'{label} {r["request_id"]}: max teacher-forced gap '
                f'{gaps.max():.3e}, limit {NEAR_TIE}'
                + (f' + 2 x {QUANT_HALF_STEP[kv]:.3e} x {layers} x '
                   f'max|logit| (at most {limit.max():.3e})'
                   if kv != 'f32' else ''))
            if worst > 0:
                raise AssertionError(f'{label} {r["request_id"]}: a served '
                                     f'token beyond its limit by {worst}')
        matched = sum(sum(a == b for a, b in zip(t, f))
                      for (t, _), (f, _) in zip(results, f32_results))
        total_tokens = sum(len(f) for f, _ in f32_results)
        served_line(f'served {label}', card, reqs, results, wall, stats,
                    peak)
        acc = (stats['spec_accepted'] / stats['spec_drafted']
               if stats['spec_drafted'] else None)
        log(f'{label} [{card}]: verify rounds {stats["spec_rounds"]}, drafts '
            f'{stats["spec_drafted"]} of which accepted '
            f'{stats["spec_accepted"]} (acceptance '
            f'{"n/a" if acc is None else f"{acc:.3f}"}); greedy match rate '
            f'against phase 4\'s f32 streams {matched}/{total_tokens} = '
            f'{matched / total_tokens:.4f}; {kv} pool {pool.bytes_in_hbm()} '
            f'bytes in device memory; launches {launches}; '
            f'{time.perf_counter() - t0:.1f} s')
        profile_decode_steps(engine, rng, card)
        del engine, sched
    return by_run


# Phase 17: the serving tier (ROADMAP A.7a) on a shared-system-prompt mix:
# 16 greedy requests, one 192-token system prompt (12 whole blocks of 16)
# and distinct 16-64-token suffixes, budgets 32-64, the first request
# alone (it fills the cache), then the other 15 at once. Runs: (a) prefix
# cache off, (b) on, (c) on with speculative decoding (k SPEC_K, n-gram:
# the suffix fill rides verify rounds), (d) disaggregated prefill on a
# prefill engine on the same card, (e) on through its knobs with a host
# tier of SHARED_HOST_MB and a resident cap of SHARED_CAP blocks, which
# holds one system prompt with its suffix blocks but not two: the mix's
# requests alternate with two of a second system prompt, in waves (0),
# (B0), (1-7), (B1), (8-15): B0's publication spills the mix's idle
# blocks, the hits of (1-7) reinject them and their publications spill
# B0's, and B1's hit reinjects those (the reference's policy: a
# publication under the cap spills one idle block a new one, and a
# reinjection is not capped, so (8-15) find the mix's blocks resident),
# (f) two replica processes (cache on) behind a Router, one killed
# (SIGKILL) once a stream on it has started
SHARED_SYSTEM = 192
SHARED_CAP = 16
SHARED_HOST_MB = 64
# run (f)'s replica processes: their arguments beyond the port, seed and
# cache flags, and the device their ready line must name
REPLICA_ARGS = ()
REPLICA_DEVICE = 'cuda'


def shared_prefix_mix(seed, vocab):
    """Phase 17's seeded mix: one system prompt, 16 distinct suffixes of
    16-64 tokens, budgets of 32-64, every request streamed and greedy."""
    rng = np.random.RandomState(seed + 17)
    system = [int(t) for t in rng.randint(0, vocab, SHARED_SYSTEM)]
    reqs = []
    for i in range(16):
        suffix = [int(t) for t in rng.randint(0, vocab,
                                              int(rng.randint(16, 65)))]
        reqs.append({'prompt': system + suffix,
                     'max_new_tokens': int(rng.randint(32, 65)),
                     'stream': True, 'request_id': f'shared-{i}'})
    return reqs


def second_system_requests(seed, vocab):
    """Run (e)'s two requests of another system prompt (its length and the
    mix's suffix and budget ranges)."""
    rng = np.random.RandomState(seed + 18)
    system = [int(t) for t in rng.randint(0, vocab, SHARED_SYSTEM)]
    return [{'prompt': system + [int(t) for t in rng.randint(
                 0, vocab, int(rng.randint(16, 65)))],
             'max_new_tokens': int(rng.randint(32, 65)), 'stream': True,
             'request_id': f'second-{i}'} for i in range(2)]


def stream_events(events, t0):
    """Consume one generation's NDJSON events: (tokens, finish reason,
    seconds to the first token, error event or None)."""
    tokens, ttft, reason, error = [], None, None, None
    for event in events:
        if 'token' in event:
            if ttft is None:
                ttft = time.perf_counter() - t0
            tokens.append(event['token'])
        elif event.get('done'):
            reason = event['finish_reason']
            if event['tokens'] != tokens:
                raise AssertionError('streamed tokens differ from the '
                                     'final line')
        elif 'error' in event:
            error = event
    return tokens, reason, ttft, error


def post_stream(url, body, timeout=600):
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url + '/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return stream_events((json.loads(ln) for ln in r if ln.strip()),
                             t0)


def drive_waves(send, n, waves):
    """``send(i)`` for each wave of request indexes in turn, a wave's
    requests at once; returns (the n results, wall seconds of the waves
    after the first)."""
    results, wall = [None] * n, 0.0

    def client(i):
        results[i] = send(i)

    for w, wave in enumerate(waves):
        threads = [threading.Thread(target=client, args=(i,))
                   for i in wave]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        if w:
            wall += time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(
                results[i] is None for i in wave):
            raise AssertionError('a /generate request did not finish')
    return results, wall


def ttft_line(results, later):
    """Time to first token of the requests ``later`` (those after the
    first wave) and of the first request."""
    ms = sorted(1e3 * results[i][2] for i in later)
    return (f'time to first token of the {len(later)} p50 '
            f'{np.percentile(ms, 50):.3f} p90 {np.percentile(ms, 90):.3f} ms '
            f'(the first request {1e3 * results[0][2]:.3f} ms)'), ms


def equal_or_near_tie(model, reqs, got, want, pad_len, what):
    """Each stream of ``got`` equal to ``want``'s or, where it parts, every
    token of it within NEAR_TIE of its teacher-forced row's max."""
    parted, worst = 0, 0.0
    for r, g, w in zip(reqs, got, want):
        if g == w:
            continue
        parted += 1
        gaps, _ = teacher_forced(model, r['prompt'], g, pad_len)
        worst = max(worst, float(gaps.max()))
    log(f'{what}: {len(reqs) - parted}/{len(reqs)} streams equal token for '
        f'token, {parted} parted, their largest teacher-forced gap {worst:.3e} '
        f'(limit {NEAR_TIE})')
    if worst > NEAR_TIE:
        raise AssertionError(f'{what}: a token {worst} below its row max')


def tier_run(model, reqs, label, card, waves=None, env=None, **stack_kw):
    """One of phase 17's in-process runs (a)-(e) through the replica stack
    behind a ServingServer, warmed first: ``waves`` of request indexes
    (default the first request alone, then the others at once), the stack
    built under the environment variables ``env``. Checks every request's
    full budget and K1 = (decode steps + verify rounds) x layers, K2 =
    (the decode and prefill engines' prefills) x layers. Returns (results,
    launches, engine, prefill engine or None)."""
    import os
    import torch
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.tier.replica import build_replica_stack
    waves = waves or [[0], list(range(1, len(reqs)))]
    later = [i for wave in waves[1:] for i in wave]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        engine, sched, worker = build_replica_stack(model, **stack_kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    prefill_engine = worker.replica.engine if worker else None
    srv = ServingServer(None, port=0, generator=sched, warmup=True,
                        request_timeout=600).start()
    url = f'http://127.0.0.1:{srv.port}'
    try:
        if prefill_engine is not None:
            prefill_engine.warmup()
        pc = engine.prefix_cache
        torch.cuda.synchronize()
        nn_ops.reset_launch_counts()
        engine.reset_stats()
        if prefill_engine is not None:
            prefill_engine.reset_stats()
            worker.reset_stats()
        if pc is not None:
            pc.reset_stats()
        results, wall = drive_waves(lambda i: post_stream(url, reqs[i]),
                                    len(reqs), waves)
        torch.cuda.synchronize()
        launches = nn_ops.launch_counts()
    finally:
        srv.shutdown()
        if worker is not None:
            worker.close()
    layers = model.cfg.num_hidden_layers
    for r, (tokens, reason, _, error) in zip(reqs, results):
        if error is not None or len(tokens) != r['max_new_tokens'] \
                or reason != 'length':
            raise AssertionError(f'{label} {r["request_id"]}: {len(tokens)} '
                                 f'tokens ({reason}, {error})')
    stats = engine.stats
    prefills = stats['prefills'] + (prefill_engine.stats['prefills']
                                    if prefill_engine else 0)
    if launches['paged_attention'] != stats['decode_steps'] * layers:
        raise AssertionError(f'{label}: K1 launches {launches} != decode '
                             f'steps {stats["decode_steps"]} x {layers}')
    if launches['paged_prefill_attention'] != prefills * layers:
        raise AssertionError(f'{label}: K2 launches {launches} != prefills '
                             f'{prefills} x {layers}')
    generated = sum(len(results[i][0]) for i in later)
    steps_ms = sorted(1e3 * s for s in stats['step_seconds'])
    ttft, _ = ttft_line(results, later)
    log(f'{label} [{card}]: the {len(later)} after the first in '
        f'{len(waves) - 1} wave(s) {generated} tokens in {wall:.3f} s = '
        f'{generated / wall:.1f} tokens/s; {ttft}; {stats["decode_steps"]}'
        f' decode steps ({stats["spec_rounds"]} verify rounds), p50 '
        f'{statistics.median(steps_ms):.3f} ms; prefills: decode engine '
        f'{stats["prefills"]}, prefill engine '
        f'{prefill_engine.stats["prefills"] if prefill_engine else 0}; '
        f'K1 {launches["paged_attention"]} = {stats["decode_steps"]} x '
        f'{layers}, K2 {launches["paged_prefill_attention"]} = {prefills} x '
        f'{layers}')
    if pc is not None:
        s = pc.stats
        log(f'{label}: prefix cache hits {s["prefix_cache_hits"]}, misses '
            f'{s["prefix_cache_misses"]}, tokens saved '
            f'{s["prefix_cache_tokens_saved"]}, inserted blocks '
            f'{s["prefix_cache_inserted_blocks"]}, evictions '
            f'{s["prefix_cache_evictions"]}, spills '
            f'{s["kv_cache_spill_count"]} ({s["kv_cache_bytes_spilled"]} '
            f'bytes), reinjects {s["kv_cache_reinject_count"]} blocks in '
            f'{len(s["kv_cache_reinject_seconds"])} events, '
            f'{1e3 * sum(s["kv_cache_reinject_seconds"]):.3f} ms; resident '
            f'{pc.resident_blocks}, host {pc.spilled_blocks} blocks')
    if worker is not None:
        s = worker.stats
        secs = sorted(1e3 * x for x in s['disagg_handoff_seconds'])
        log(f'{label}: handoffs {s["disagg_handoffs"]} '
            f'({s["disagg_handoff_failures"]} failed), '
            f'{s["disagg_kv_bytes"]} bytes, submit to payload p50 '
            f'{np.percentile(secs, 50):.3f} p90 {np.percentile(secs, 90):.3f}'
            f' ms')
        if s['disagg_handoff_failures']:
            raise AssertionError(f'{label}: a handoff failed')
    return results, launches, engine, prefill_engine


def check_handoff_blocks(engine, prefill_engine, prompt, label):
    """The prefill engine's payload of ``prompt`` against the decode
    engine's own (colocated) prefill of it: every block bit for bit."""
    import torch
    from paddle_tpu_torch.serving.tier.disagg import PrefillReplica
    payload = PrefillReplica(prefill_engine).prefill_to_payload(prompt)
    table = engine.reserve_table(len(prompt), 1)
    try:
        first = engine.prefill(prompt, table)
        nb = payload.num_blocks
        for layer, (k, v) in enumerate(payload.layers):
            ck, cv = engine.pool.read_blocks(layer, table.blocks[:nb])
            if not (torch.equal(k, ck) and torch.equal(v, cv)):
                raise AssertionError(f'{label}: layer {layer}\'s handed-over '
                                     f'blocks differ from the colocated '
                                     f'prefill\'s')
    finally:
        engine.release_table(table)
    if first != payload.first_token:
        raise AssertionError(f'{label}: first token {payload.first_token} '
                             f'against the colocated {first}')
    log(f'{label}: the handoff of a {len(prompt)}-token prompt, '
        f'{payload.num_blocks} blocks x {len(payload.layers)} layers, '
        f'{payload.nbytes} bytes, bit for bit the colocated prefill\'s')


def spawn_replica(seed):
    """A replica process (full width on the card, the prefix cache on)."""
    import os
    return subprocess.Popen(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.tier.replica',
         '--port', '0', '--seed', str(seed), '--prefix-cache', '1',
         *REPLICA_ARGS], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def ready_url(proc, timeout=300):
    box = []
    reader = threading.Thread(target=lambda: box.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if not box or not box[0].strip():
        raise AssertionError(f'a replica process did not start (rc '
                             f'{proc.poll()})')
    ready = json.loads(box[0])
    if not (ready['ready'] and ready['prefix_cache']
            and ready['device'].startswith(REPLICA_DEVICE)):
        raise AssertionError(f'replica ready line {ready}')
    return f'http://127.0.0.1:{ready["port"]}'


def routed_kill_run(reqs, want, seed, card):
    """Run (f): two replica processes (prefix cache on, the smoke's weights)
    behind a Router. The first request goes to each replica (each fills its
    own cache), then the other 15 at once through the router; the replica
    whose stream shows a token first is killed with SIGKILL at once. The
    streams that had tokens from it end with an error event (in flight,
    lost); every other request completes with (b)'s tokens, rerouted
    where it had been sent to the killed replica; the lost ones, sent again
    through the router, complete with (b)'s tokens too."""
    import os
    import signal
    from paddle_tpu_torch.serving import Router
    procs = [spawn_replica(seed) for _ in range(2)]
    t_start = time.perf_counter()
    try:
        urls = [ready_url(p) for p in procs]
        log(f'(f) two replica processes ready in '
            f'{time.perf_counter() - t_start:.1f} s: {urls}')
        for url in urls:
            tokens, _, _, error = post_stream(url, reqs[0])
            if error is not None or tokens != want[0]:
                raise AssertionError(f'(f) {url}: the first request '
                                     f'{error} or other tokens than (b)')
        with Router(urls, health_poll_s=0.5, request_timeout=600) as router:
            first_token = threading.Event()
            gens, results = [None] * len(reqs), [None] * len(reqs)
            started = {}

            def client(i):
                gen = router.stream_generate(
                    reqs[i]['prompt'], max_new_tokens=reqs[i][
                        'max_new_tokens'])
                gens[i] = gen
                t0 = time.perf_counter()

                def events():
                    for event in gen.events():
                        if 'token' in event and i not in started:
                            started[i] = gen.replica
                            first_token.set()
                        yield event

                results[i] = stream_events(events(), t0)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(1, len(reqs))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            if not first_token.wait(300):
                raise AssertionError('(f): no stream started')
            victim_url = next(iter(started.values()))
            victim = procs[urls.index(victim_url)]
            os.kill(victim.pid, signal.SIGKILL)
            for t in threads:
                t.join(900)
            # a token can come only from a live replica: every stream with a
            # token from the killed one was in flight there
            in_flight = {i for i, u in started.items() if u == victim_url}
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise AssertionError('(f): a routed request did not finish')
            lost = [i for i in range(1, len(reqs))
                    if results[i][3] is not None]
            if not lost or not set(lost) <= in_flight:
                raise AssertionError(f'(f): lost {lost}, in flight on the '
                                     f'killed replica {sorted(in_flight)}')
            for i in range(1, len(reqs)):
                if i not in lost and results[i][0] != want[i]:
                    raise AssertionError(f'(f) {reqs[i]["request_id"]}: '
                                         f'other tokens than (b)')
            rerouted = sum(g.retries for g in gens[1:])
            for i in lost:                # the clients send them again
                fin = router.generate(reqs[i]['prompt'], max_new_tokens=reqs[
                    i]['max_new_tokens'])
                if fin['tokens'] != want[i]:
                    raise AssertionError(f'(f) {reqs[i]["request_id"]}: the '
                                         f'retry\'s tokens differ from (b)')
            stats = dict(router.stats)
            fleet_check(router, urls, victim_url, card)
        if victim.wait(timeout=60) != -signal.SIGKILL:
            raise AssertionError('(f): the killed replica did not die of '
                                 'SIGKILL')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    done = [r for i, r in enumerate(results[1:], 1) if i not in lost]
    generated = sum(len(r[0]) for r in done)
    ms = sorted(1e3 * r[2] for r in done)
    log(f'(f) two replicas behind the Router, one killed [{card}]: '
        f'{len(done)}/15 completed with (b)\'s tokens, {len(lost)} lost in '
        f'flight on the killed replica (of {len(in_flight)} started there '
        f'at the kill) and sent again with (b)\'s tokens, {rerouted} '
        f'rerouted before their first event; {generated} tokens in '
        f'{wall:.3f} s = {generated / wall:.1f} tokens/s; time to first '
        f'token p50 {np.percentile(ms, 50):.3f} p90 '
        f'{np.percentile(ms, 90):.3f} ms; router completed '
        f'{stats["router_requests_completed"]}, rerouted '
        f'{stats["router_requests_rerouted"]}, failed '
        f'{stats["router_requests_failed"]}; '
        f'{time.perf_counter() - t_start:.1f} s')
    return {'lost': len(lost), 'rerouted': rerouted, 'stats': stats}


def fleet_check(router, urls, victim_url, card):
    """Phase 19 (e), at the end of phase 17's run (f): the router's
    ``/metrics/fleet`` merge once, its decode_tokens_generated against the
    sum of the live replicas' own ``/metrics``; the killed replica's
    scrape is a counted failure, not a failed merge."""
    from paddle_tpu_torch.observability import distributed, registry
    failures = registry.counter('router_scrape_failures')
    before = sum(s['value'] for s in failures.to_dict()['samples'])
    fleet = distributed.parse_prometheus_text(router.fleet_metrics_text())
    after = sum(s['value'] for s in failures.to_dict()['samples'])
    live = [u for u in urls if u != victim_url]
    own = [metric_total(scrape_metrics(int(u.rsplit(':', 1)[1])),
                        'decode_tokens_generated') for u in live]
    merged = metric_total(fleet, 'decode_tokens_generated')
    if merged != sum(own) or after - before != 1:
        raise AssertionError(f'19 (e): merged tokens {merged} against the '
                             f'live replicas\' {own}; scrape failures '
                             f'{after - before}')
    log(f'19 (e) phase 17 (f)\'s router, GET /metrics/fleet once at its end '
        f'[{card}]: merged decode_tokens_generated {merged:.0f} = the live '
        f'replica\'s own {own}; the killed replica\'s scrape counted as one '
        f'router_scrape_failures')


def serve_shared_prefix(model, seed, card):
    """Phase 17: runs (a)-(f) (see SHARED_SYSTEM). Returns each in-process
    run's launch counts by 'off', 'cache', 'spec', 'disagg', 'spill'."""
    reqs = shared_prefix_mix(seed, model.cfg.vocab_size)
    t_start = time.perf_counter()
    log(f'shared-prefix mix: {len(reqs)} greedy requests, a '
        f'{SHARED_SYSTEM}-token system prompt, suffixes '
        f'{min(len(r["prompt"]) for r in reqs) - SHARED_SYSTEM}-'
        f'{max(len(r["prompt"]) for r in reqs) - SHARED_SYSTEM} tokens, '
        f'budgets {min(r["max_new_tokens"] for r in reqs)}-'
        f'{max(r["max_new_tokens"] for r in reqs)}')
    by_run, out = {}, {}
    from paddle_tpu_torch.serving.tier.knobs import (
        ENV_PREFIX_CACHE, ENV_PREFIX_CACHE_HOST_MB,
        ENV_PREFIX_CACHE_MAX_BLOCKS)
    n = len(reqs)
    alternating = reqs + second_system_requests(seed, model.cfg.vocab_size)
    spill_env = {ENV_PREFIX_CACHE: '1',
                 ENV_PREFIX_CACHE_MAX_BLOCKS: str(SHARED_CAP),
                 ENV_PREFIX_CACHE_HOST_MB: str(SHARED_HOST_MB)}
    runs = [('off', '(a) prefix cache off', reqs, {'prefix_cache': False}),
            ('cache', '(b) prefix cache on', reqs, {'prefix_cache': True}),
            ('spec', f'(c) prefix cache on, spec_decode k {SPEC_K} n-gram',
             reqs, {'prefix_cache': True, 'spec_decode': True,
                    'spec_k': SPEC_K, 'drafter': 'ngram'}),
            ('disagg', '(d) disaggregated prefill, colocated on the card',
             reqs, {'prefix_cache': False, 'disagg': True}),
            ('spill', f'(e) prefix cache from its knobs, cap {SHARED_CAP} '
             f'blocks, host tier {SHARED_HOST_MB} MB, two system prompts '
             f'alternating', alternating,
             {'env': spill_env, 'waves': [
                 [0], [n], list(range(1, 8)), [n + 1],
                 list(range(8, n))]})]
    for key, label, run_reqs, kw in runs:
        results, launches, engine, prefill_engine = tier_run(
            model, run_reqs, label, card, **kw)
        by_run[key] = launches
        out[key] = [r[0] for r in results[:n]]
        if key == 'disagg':
            check_handoff_blocks(engine, prefill_engine, reqs[1]['prompt'],
                                 label)
        if key == 'spill':
            # the cache's own policy: publications under the cap spill the
            # other prompt's idle blocks, and the hits of (1-7) and B1
            # reinject them
            pc = engine.prefix_cache
            s = pc.stats
            if not (pc.max_blocks == SHARED_CAP
                    and s['prefix_cache_evictions']['cap']
                    and s['kv_cache_spill_count']
                    and len(s['kv_cache_reinject_seconds']) >= 2
                    and s['prefix_cache_hits'] == len(alternating) - 2
                    and s['prefix_cache_misses'] == 2):
                raise AssertionError(f'{label}: the cap did not spill and '
                                     f'the hits did not reinject: {s}')
        del engine, prefill_engine
    from paddle_tpu_torch.serving.tier.replica import ENGINE_DEFAULTS
    bs = ENGINE_DEFAULTS['block_size']
    pad_len = -(-(ENGINE_DEFAULTS['max_prompt_len']
                  + ENGINE_DEFAULTS['max_new_tokens_cap']) // bs) * bs
    letter = {key: label[:3] for key, label, _, _ in runs}
    for key in ('cache', 'spec'):
        equal_or_near_tie(model, reqs, out[key], out['off'], pad_len,
                          f'{letter[key]} against (a)')
    for key, ref_key in (('disagg', 'off'), ('spill', 'cache')):
        same = sum(g == w for g, w in zip(out[key], out[ref_key]))
        log(f'{letter[key]} against {letter[ref_key]}: {same}/{len(reqs)} '
            f'streams bit for bit')
        if same != len(reqs):
            raise AssertionError(f'{letter[key]}: streams differ from '
                                 f'{letter[ref_key]}\'s')
    routed_kill_run(reqs, out['cache'], seed, card)
    log(f'phase 17 in {time.perf_counter() - t_start:.1f} s')
    return by_run


STATIC_STEP_GROUPS = {
    'kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
    'copies and fills': lambda key: key.startswith(('Memcpy', 'Memset')),
    'convolutions': lambda key: any(
        t in key.lower() for t in ('conv', 'xmma', 'cudnn', 'dgrad', 'wgrad',
                                   'implicit_gemm')),
    'gemm': lambda key: any(t in key.lower() for t in (
        'gemm', 'nvjet', 'sm90_', 'cutlass')),
    'elementwise': lambda key: 'elementwise' in key,
    'reductions': lambda key: 'reduce_kernel' in key,
    'batch-norm statistics': lambda key: 'welford' in key.lower()
    or 'var_mean' in key.lower(),
    'pooling': lambda key: 'pool' in key.lower(),
    'multi-tensor updates': lambda key: 'multi_tensor' in key.lower()
    or 'foreach' in key.lower()}


def four_step_runs(fluid, main, loss_name, host, feed, fetch):
    """One step of ``main`` through ``CompiledProgram`` from the values
    ``host`` (numpy, by name) four times: on the card and on
    ``Executor(CPUPlace())``, each in f32 and in float64
    (``as_float64``). Returns ({(place, type): fetched}, {(place, type):
    seconds})."""
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.tools.witness import as_float64
    main64 = as_float64(main)
    runs, secs = {}, {}
    for place in ('card', 'cpu'):
        exe = fluid.Executor(fluid.CUDAPlace(0) if place == 'card'
                             else fluid.CPUPlace())
        for prog, cast in ((main, np.float32), (main64, np.float64)):
            t0 = time.perf_counter()
            scope = fluid.Scope()
            scope_from_paddle(
                {n: a.astype(cast) if a.dtype == np.float32 else a
                 for n, a in host.items()}, scope, exe.place, program=prog)
            key = (place, cast.__name__)
            runs[key] = exe.run(
                fluid.CompiledProgram(prog).with_data_parallel(
                    loss_name=loss_name),
                feed=feed, fetch_list=fetch, scope=scope)
            secs[key] = time.perf_counter() - t0
    return runs, secs


def static_resnet_card_against_cpu(fluid, main, v, gscope, seed, card):
    """The first step at batch 8 from the card's startup values
    (``gscope``) four times: on the card and on ``Executor(CPUPlace())``,
    each in f32 and in float64 (``as_float64``); the CPU's f64 run is the
    witness the other three are held to."""
    from paddle_tpu_torch.tools.witness import rel_l2
    persist = [x.name for x in main.list_vars() if x.persistable]
    host = {n: gscope.find(n).cpu().numpy() for n in persist}
    rng = np.random.default_rng(seed + 11)
    feed = {'image': rng.standard_normal(
        (SRESNET_CHECK_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (SRESNET_CHECK_BATCH, 1))}
    params = [p.name for p in main.all_parameters()]
    fetch = [v['loss'].name, v['acc1'].name, v['acc5'].name] + [
        n + '@GRAD' for n in params]
    runs, secs = four_step_runs(fluid, main, v['loss'].name, host, feed,
                                fetch)
    got, want = runs['card', 'float32'], runs['cpu', 'float32']
    got64, wit = runs['card', 'float64'], runs['cpu', 'float64']
    if got64[3].dtype != np.float64 or wit[3].dtype != np.float64:
        raise AssertionError('the float64 runs computed in '
                             f'{got64[3].dtype}, {wit[3].dtype}')
    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    loss64 = abs(float(got64[0]) - float(wit[0])) / abs(float(wit[0]))
    f64 = {n: rel_l2(g, x) for n, g, x in zip(params, got64[3:], wit[3:])}
    f32 = {n: (rel_l2(g, x), 2 * rel_l2(w, x) + SRESNET_GRAD_FLOOR)
           for n, g, w, x in zip(params, got[3:], want[3:], wit[3:])}
    # a card whose gradients were 10% off, through both checks
    s64 = min(rel_l2(np.float64(0.9) * g, x) / SRESNET_F64_RTOL
              for g, x in zip(got64[3:], wit[3:]))
    s32 = min(rel_l2(np.float32(0.9) * g, x) / f32[n][1]
              for n, g, x in zip(params, got[3:], wit[3:]))
    w64 = max(f64, key=f64.get)
    w32 = max(f32, key=lambda n: f32[n][0] / f32[n][1])
    log(f'static ResNet-50, batch {SRESNET_CHECK_BATCH}, card against the '
        f'CPU executor, gradients as |x - witness| / |witness| (L2; the '
        f'witness the CPU\'s f64 run) [{card}]. float64: loss '
        f'{float(got64[0])!r} (witness {float(wit[0])!r}, relative '
        f'{loss64:.3e}), worst of {len(params)} gradients {w64} '
        f'{f64[w64]:.3e} (bound {SRESNET_F64_RTOL}). f32, TF32 off: loss '
        f'{float(got[0])!r} (cpu {float(want[0])!r}, relative '
        f'{loss_err:.3e}), top-1 {float(got[1])!r} ({float(want[1])!r}), '
        f'top-5 {float(got[2])!r} ({float(want[2])!r}); card / bound (2x '
        f'the f32 cpu\'s + {SRESNET_GRAD_FLOOR}): ' + ', '.join(
            f'{n} {f32[n][0]:.3e} / {f32[n][1]:.3e}' for n in SRESNET_GRADS)
        + f'; worst {w32} {f32[w32][0]:.3e} of {f32[w32][1]:.3e}. The '
        f'card\'s gradients scaled by 0.9 read at least {s64:.3e}x (f64) and '
        f'{s32:.2f}x (f32) their bounds. Steps took ' + ', '.join(
            f'{p} {c} {t:.1f} s' for (p, c), t in secs.items()))
    if s64 <= 1 or s32 <= 1:
        raise AssertionError('the gradient check passes a gradient scaled '
                             'by 0.9')
    if (loss64 > SRESNET_F64_LOSS_RTOL or f64[w64] > SRESNET_F64_RTOL
            or float(got64[1]) != float(wit[1])
            or float(got64[2]) != float(wit[2])):
        raise AssertionError('static ResNet-50 in float64 on the card '
                             'differs from the CPU beyond the stated '
                             'tolerance')
    if (loss_err > SRESNET_RTOL or float(got[1]) != float(want[1])
            or float(got[2]) != float(want[2])
            or any(e > b for e, b in f32.values())):
        raise AssertionError('static ResNet-50 on the card differs from the '
                             'CPU executor beyond the stated tolerance')


def train_static_resnet(seed, card):
    """Phase 11: PaddleCV's static ResNet-50 recipe through
    ``CompiledProgram`` on ``Executor(CUDAPlace(0))``: card against CPU,
    training, saving and serving the inference model. Returns the
    kernels' launch counts over the phase (none of the port's kernels is
    on this path) and the training's peak device memory."""
    import tempfile
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import static_resnet
    nn_ops.reset_launch_counts()
    fluid.seed(seed)
    t0 = time.perf_counter()
    with fluid.unique_name.guard():     # the names of a fresh script
        main, startup, test, v = static_resnet.build(fluid)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != SRESNET_PARAMS:
        raise AssertionError(f'static ResNet-50 has {n_params} parameters')
    log(f'static ResNet-50 (PaddleCV recipe): {n_params} parameters, '
        f'{len(main.global_block().ops)} ops in the train program, '
        f'{len(test.global_block().ops)} in the test program; built in '
        f'{time.perf_counter() - t0:.1f} s')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)

    # 1. the card against the CPU at batch 8
    static_resnet_card_against_cpu(fluid, main, v, gscope, seed, card)

    # 2. training through CompiledProgram, batch 128, the same batch
    rng = np.random.default_rng(seed)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    losses, rates, secs = [], [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = gpu.run(step, feed=feed, fetch_list=[v['loss'], v['lr']],
                      scope=gscope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
        rates.append(float(out[1][0]))
    peak = torch.cuda.max_memory_allocated()
    want_rates = [static_resnet.VALUES[int(np.searchsorted(
        static_resnet.BOUNDARIES, i, side='right'))]
        for i in range(len(rates))]
    log('static ResNet-50 losses: ' + ' '.join(repr(x) for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'static ResNet-50 losses {losses}: not '
                             f'finite or not falling')
    if not np.allclose(rates, want_rates, rtol=1e-7, atol=0):
        raise AssertionError(f'rates {rates} are not piecewise_decay\'s '
                             f'{want_rates}')
    lowered = gpu.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'train program lowered {lowered} times')
    counter = int(gscope.find('lr_decay_counter_0')[0])
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    images_s = RESNET_BATCH * TRAIN_STEPS / sum(timed_s)
    dispatch = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        gpu.run(step, feed=feed, fetch_list=[v['loss']], scope=gscope,
                return_numpy=False)
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    share = images_s * RESNET_GFLOP_PER_IMAGE * 1e9 / BF16_FLOPS_PER_S
    log(f'static ResNet-50 trained through CompiledProgram [{card}]: '
        f'{len(losses)} steps ({WARMUP_STEPS} warm-up, {TRAIN_STEPS} timed) '
        f'at batch {RESNET_BATCH}, f32 (TF32 off: matmul '
        f'{torch.backends.cuda.matmul.allow_tf32}, cuDNN '
        f'{torch.backends.cudnn.allow_tf32}): {images_s:.1f} images/s, '
        f'step p50 {p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); host dispatch p50 '
        f'{statistics.median(dispatch) * 1e3:.3f} ms (run returning device '
        f'tensors, before the sync); peak device memory {peak} bytes; '
        f'model-FLOP share {share:.4f} (bench.py\'s '
        f'{RESNET_GFLOP_PER_IMAGE} GFLOP an image over 989 TFLOP/s, of an '
        f'f32 step); rates {rates[0]!r}..{rates[-1]!r} = piecewise_decay\'s '
        f'(boundaries {static_resnet.BOUNDARIES}); step counter {counter}; '
        f'lowerings of the train program {lowered}')
    profile_train_step(
        lambda: gpu.run(step, feed=feed, fetch_list=[v['loss']],
                        scope=gscope),
        (), p50, card, STATIC_STEP_GROUPS, what='static ResNet-50 step')

    # 3. saving, and the persistables back into a fresh scope
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with fluid.scope_guard(gscope):
            fluid.io.save_persistables(gpu, tmp + '/persist', main)
            fluid.io.save_inference_model(tmp + '/model', ['image'],
                                          [v['prob']], gpu,
                                          main_program=main)
        save_s = time.perf_counter() - t0
        persist = [x.name for x in main.list_vars() if x.persistable]
        rscope = fluid.Scope()
        with fluid.scope_guard(rscope):
            fluid.io.load_persistables(gpu, tmp + '/persist', main)
        differ = [n for n in persist
                  if rscope.find(n).device != gscope.find(n).device
                  or not torch.equal(rscope.find(n), gscope.find(n))]
        if differ:
            raise AssertionError(f'load_persistables differs in {differ}')
        log(f'saved {len(persist)} persistables and the inference model in '
            f'{save_s:.1f} s; load_persistables into a fresh scope: every '
            f'persistable equal bit for bit, on '
            f'{gscope.find(persist[0]).device}')

        # 4. serving the saved model: the loaded program and the Predictor
        sexe, lscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(lscope):
            prog, feeds, fetches = fluid.io.load_inference_model(
                tmp + '/model', sexe)
        pred = inference.create_paddle_predictor(
            inference.Config(tmp + '/model'))
    erng = np.random.default_rng(seed + 1)
    batches = [erng.standard_normal((RESNET_BATCH, 3, RESNET_IMG,
                                     RESNET_IMG), dtype=np.float32)
               for _ in range(SRESNET_EVAL_BATCHES)]
    label = np.zeros((RESNET_BATCH, 1), np.int64)
    worst = 0.0
    run_s, pred_s = [], []
    for x in batches:
        t0 = time.perf_counter()
        got = sexe.run(prog, feed={'image': x}, fetch_list=fetches,
                       scope=lscope)[0]
        run_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        served = pred.run([x])[0]
        pred_s.append(time.perf_counter() - t0)
        want = gpu.run(test, feed={'image': x, 'label': label},
                       fetch_list=[v['prob']], scope=gscope)[0]
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
        if not np.array_equal(served, got):
            raise AssertionError('the Predictor differs from the loaded '
                                 'program on the same card')
    if worst > SRESNET_SERVE_RTOL:
        raise AssertionError(f'the loaded model is {worst:.3e} from the '
                             f'in-memory test program')
    lowerings = (sexe.lowering_count(prog),
                 pred.executor.lowering_count(pred.program))
    if lowerings != (1, 1):
        raise AssertionError(f'serving lowerings {lowerings}')
    eval_p50 = statistics.median(run_s[1:]) * 1e3
    log(f'static ResNet-50 served from its saved inference model [{card}]: '
        f'{SRESNET_EVAL_BATCHES} batches of {RESNET_BATCH}; Executor '
        f'{RESNET_BATCH * (len(run_s) - 1) / sum(run_s[1:]):.1f} images/s, '
        f'batch p50 {eval_p50:.3f} ms; Predictor '
        f'{RESNET_BATCH * (len(pred_s) - 1) / sum(pred_s[1:]):.1f} images/s, '
        f'batch p50 {statistics.median(pred_s[1:]) * 1e3:.3f} ms (after the '
        f'first batch, which lowers); against the in-memory test program '
        f'max|diff| {worst:.3e} of the largest entry; Predictor equal to the '
        f'loaded program bit for bit; lowerings (loaded, Predictor) '
        f'{lowerings}')
    profile_train_step(
        lambda: sexe.run(prog, feed={'image': batches[0]},
                         fetch_list=fetches, scope=lscope),
        (), eval_p50, card, STATIC_STEP_GROUPS,
        what='static ResNet-50 eval batch')
    return nn_ops.launch_counts(), peak



# PaddleNLP's PTB LSTM language model (tools/static_ptb_lm.py) at its
# `large` configuration (66,022,000 parameters, batch 20 x 35 steps = 700
# tokens a step): 3 warm-up and 20 timed steps a route, each feeding the
# fetched last states back; the model-FLOP count of a step is 3x the
# forward's 71.4 GFLOP (the LSTM products 2 x 20 x 3000 x 6000 x 35 x 2
# and the head 2 x 700 x 1500 x 10000). The card against the CPU at batch
# 4 with dropout off, every gradient in L2 norm against a float64 CPU run
# of the same step (the witness), as phase 11: the card's float64 run
# within 1e-6 of it (the loss within 1e-10), its f32 run within 2x the f32
# CPU run's own distance plus 1e-4; a gradient scaled by 0.9 must fail
# both. The `static` route runs with its boundaries moved to steps 8 and
# 16 (the recipe's values at epochs 13-15), so that the fetched rate
# crosses two of them.
PTB_PARAMS, PTB_TOKENS, PTB_CHECK_BATCH, PTB_WARMUP = 66022000, 700, 4, 3
# the recipe's SGD at rate 1.0 oscillates over its first tens of steps on
# seeded ids (the loss spikes to several times its start; on a new batch
# each step it may not settle within 150 steps: PERF.md, Findings), so the
# steps train on one batch, as phases 8 and 11 do, and the timed steps
# are followed by untimed ones up to PTB_STEPS: the loss must fall over
# them, from the first step to the last and from the first window of
# PTB_WINDOW steps to the last
PTB_STEPS, PTB_WINDOW = 150, 25
PTB_GFLOP_PER_STEP = 3 * (2 * 20 * 3000 * 6000 * 35 * 2
                          + 2 * 700 * 1500 * 10000) / 1e9
PTB_F64_RTOL, PTB_F64_LOSS_RTOL, PTB_GRAD_FLOOR = 1e-6, 1e-10, 1e-4
PTB_LOSS_RTOL = 1e-4            # the f32 loss against the f32 CPU run's
PTB_MOVED_BOUNDARIES = [8, 16]
CF_TOL = 1e-6                   # control flow, card against CPU, f32
PTB_STEP_GROUPS = {
    'kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
    'copies and fills': lambda key: key.startswith(('Memcpy', 'Memset')),
    'gemm': STATIC_STEP_GROUPS['gemm'],
    'elementwise': lambda key: 'elementwise' in key,
    'reductions': lambda key: 'reduce_kernel' in key,
    'dropout masks': lambda key: 'distribution' in key.lower(),
    'concat': lambda key: 'CatArray' in key,
    'embedding': lambda key: 'embedding' in key.lower()
    or 'index' in key.lower()}


def control_flow_programs(fluid):
    """Small programs of each control-flow construct and their feeds:
    {name: (main, startup, [feed], fetch)}."""
    L = fluid.layers
    rng = np.random.default_rng(5)
    progs = {}

    def data(name, shape, dtype='float32'):
        return L.data(name, shape=shape, dtype=dtype, append_batch_size=False)

    def program(name, feeds):
        def deco(build):
            main, start = fluid.Program(), fluid.Program()
            with fluid.unique_name.guard(), fluid.program_guard(main, start):
                progs[name] = (main, start, feeds, build())
        return deco

    sums = [{'x': np.array(v, np.float32)} for v in
            ([-3.0, -1.0, 0.5], [1.0, 2.0, 3.0], [20.0, 1.0, 0.0])]

    @program('cond', sums)
    def _():
        x = data('x', [3])
        return [L.cond(L.reduce_sum(x) > 1.0, lambda: L.tanh(x) * 2.0,
                       lambda: L.sigmoid(x) - 1.0)]

    @program('case', sums)
    def _():
        s = L.reduce_sum(data('x', [3]))
        return [L.case(
            [(s < 0.0, lambda: L.fill_constant([1], 'float32', -1.0)),
             (s < 10.0, lambda: s * 0.5)],
            default=lambda: s + 99.0)]

    @program('switch_case', [{'i': np.array([k], np.int32)}
                             for k in (1, 3, 7)])
    def _():
        return [L.switch_case(
            data('i', [1], 'int32'),
            {1: lambda: L.fill_constant([2], 'float32', 1.0),
             3: lambda: L.fill_constant([2], 'float32', 3.0)},
            default=lambda: L.fill_constant([2], 'float32', -1.0))]

    @program('Switch', sums)
    def _():
        x = data('x', [3])
        out = L.create_global_var([1], 0.0, 'float32', persistable=True)
        with L.Switch() as sw:
            with sw.case(L.reduce_sum(x) > 10.0):
                L.assign(L.reduce_sum(x, keep_dim=True) * 2.0, output=out)
            with sw.case(L.reduce_sum(x) > 5.0):
                L.assign(L.fill_constant([1], 'float32', 2.0), output=out)
            with sw.default():
                L.assign(L.fill_constant([1], 'float32', 3.0), output=out)
        return [out]

    @program('IfElse', [{'xb': rng.standard_normal((8, 1)).astype(
        np.float32)}])
    def _():
        x = data('xb', [8, 1])
        ie = L.IfElse(L.greater_than(x, L.fill_constant([1], 'float32',
                                                        0.0)))
        with ie.true_block():
            ie.output(ie.input(x) * 2.0)
        with ie.false_block():
            ie.output(L.tanh(ie.input(x)) - 1.0)
        return [ie()[0]]

    @program('While', [{}])
    def _():
        n = L.fill_constant([1], 'int64', 6)
        i = L.fill_constant([1], 'int64', 0)
        total = L.fill_constant([1], 'int64', 0)
        cond_var = L.less_than(i, n)
        w = L.While(cond_var)
        with w.block():
            L.assign(total + i * i, total)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond_var)
        return [total, i]

    @program('while_loop bounded, with its gradient',
             [{'xw': rng.standard_normal((1, 3)).astype(np.float32)}])
    def _():
        x = L.data('xw', [3], dtype='float32')
        i = L.fill_constant([1], 'int64', 0)
        n = L.fill_constant([1], 'int64', 4)
        _, out = L.while_loop(
            lambda i, v: L.less_than(i, n),
            lambda i, v: [L.increment(i, in_place=False),
                          L.tanh(v) * 1.5], [i, x], maximum_trip_count=8)
        loss = L.reduce_sum(out)
        return [loss, fluid.gradients([loss], [x])[0]]

    @program('while_loop unbounded', [{'n': np.array([k], np.int32)}
                                      for k in (0, 5)])
    def _():
        i = L.fill_constant([1], 'int32', 0)
        acc = L.fill_constant([1], 'float32', 1.0)
        limit = data('n', [1], 'int32')
        return L.while_loop(lambda i, a: L.less_than(i, limit),
                            lambda i, a: [i + 1, a * 1.5 + 0.25], [i, acc])

    @program('DynamicRNN with lengths',
             [{'xd': rng.standard_normal((3, 4, 2)).astype(np.float32),
               'lens': np.array([4, 1, 3], np.int64)}])
    def _():
        x = L.data('xd', shape=[4, 2], dtype='float32')
        lens = L.data('lens', shape=[1], dtype='int64')
        drnn = L.DynamicRNN()
        with drnn.block():
            step = drnn.step_input(x, sequence_length=lens)
            acc = drnn.memory(shape=[2], value=0.0)
            new = L.tanh(acc + step)
            drnn.update_memory(acc, new)
            drnn.output(new)
        return [drnn()]

    @program('tensor arrays', [{'xa': rng.standard_normal(3).astype(
        np.float32)}])
    def _():
        x = data('xa', [3])
        arr = L.create_array('float32')
        i0 = L.fill_constant([1], 'int64', 0)
        i1 = L.fill_constant([1], 'int64', 1)
        L.array_write(x, i0, arr)
        L.array_write(L.sigmoid(x), i1, arr)
        return [L.array_read(arr, i1), L.array_length(arr), L.is_empty(x)]

    return progs


def check_control_flow_on_card(card):
    """Each control-flow construct on ``Executor(CUDAPlace(0))`` against
    ``Executor(CPUPlace())``, every feed, within ``CF_TOL`` (integers and
    booleans equal)."""
    import paddle_tpu_torch as fluid
    progs = control_flow_programs(fluid)
    worst, runs = 0.0, 0
    for name, (main, start, feeds, fetch) in progs.items():
        outs = {}
        for place in ('card', 'cpu'):
            exe = fluid.Executor(fluid.CUDAPlace(0) if place == 'card'
                                 else fluid.CPUPlace())
            with fluid.scope_guard(fluid.Scope()):
                exe.run(start)
                outs[place] = [exe.run(main, feed=f, fetch_list=fetch)
                               for f in feeds]
        for got, want in zip(outs['card'], outs['cpu']):
            runs += 1
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f'{name}: card {g.shape} {g.dtype}'
                                         f', cpu {w.shape} {w.dtype}')
                err = float(np.max(np.abs(g.astype(np.float64)
                                          - w.astype(np.float64)),
                                   initial=0.0))
                worst = max(worst, err)
                if not np.allclose(g, w, atol=CF_TOL, rtol=CF_TOL):
                    raise AssertionError(f'{name} on the card differs from '
                                         f'the CPU: max|diff| {err:.3e}')
    log(f'static control flow on the card against the CPU executor '
        f'[{card}]: {len(progs)} constructs ({", ".join(progs)}), {runs} '
        f'runs, worst max|diff| {worst:.3e} (bound {CF_TOL})')


def ptb_card_against_cpu(fluid, static_ptb_lm, seed, card):
    """The first step at ``large``'s widths, batch 4, dropout off, from the
    card's startup values four times (``four_step_runs``); the CPU's f64
    run is the witness."""
    from paddle_tpu_torch.tools.witness import rel_l2
    with fluid.unique_name.guard():
        main, startup, _, v = static_ptb_lm.build(
            fluid, 'padding', batch_size=PTB_CHECK_BATCH, dropout=0.0)
    gexe, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gexe.run(startup, scope=gscope)
    persist = [x.name for x in main.list_vars() if x.persistable]
    host = {n: gscope.find(n).cpu().numpy() for n in persist}
    c = static_ptb_lm.LARGE
    rng = np.random.default_rng(seed + 12)
    state = (c['num_layers'], PTB_CHECK_BATCH, c['hidden_size'])
    feed = {'x': rng.integers(0, c['vocab_size'],
                              (PTB_CHECK_BATCH, c['num_steps'], 1)),
            'y': rng.integers(0, c['vocab_size'],
                              (PTB_CHECK_BATCH * c['num_steps'], 1)),
            'init_hidden': 0.1 * rng.standard_normal(state, np.float32),
            'init_cell': 0.1 * rng.standard_normal(state, np.float32)}
    params = [p.name for p in main.all_parameters()]
    # the gradients, then the parameters after the clipped SGD update
    fetch = [v['loss'].name] + [n + '@GRAD' for n in params] + params
    runs, secs = four_step_runs(fluid, main, v['loss'].name, host, feed,
                                fetch)
    k = len(params)
    for key, out in runs.items():
        runs[key] = out[:1 + k] + [
            after - host[n] for n, after in zip(params, out[1 + k:])]
    names = params + [n + ' update' for n in params]
    got, want = runs['card', 'float32'], runs['cpu', 'float32']
    got64, wit = runs['card', 'float64'], runs['cpu', 'float64']
    if got64[1].dtype != np.float64 or wit[1].dtype != np.float64:
        raise AssertionError('the float64 runs computed in '
                             f'{got64[1].dtype}, {wit[1].dtype}')
    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    loss64 = abs(float(got64[0]) - float(wit[0])) / abs(float(wit[0]))
    f64 = {n: rel_l2(g, x) for n, g, x in zip(names, got64[1:], wit[1:])}
    f32 = {n: (rel_l2(g, x), 2 * rel_l2(w, x) + PTB_GRAD_FLOOR)
           for n, g, w, x in zip(names, got[1:], want[1:], wit[1:])}
    s64 = min(rel_l2(np.float64(0.9) * g, x) / PTB_F64_RTOL
              for g, x in zip(got64[1:], wit[1:]))
    s32 = min(rel_l2(np.float32(0.9) * g, x) / f32[n][1]
              for n, g, x in zip(names, got[1:], wit[1:]))
    w64 = max(f64, key=f64.get)
    log(f'static PTB LM (padding), batch {PTB_CHECK_BATCH}, dropout off, '
        f'card against the CPU executor, the 7 gradients and the 7 '
        f'parameters\' clipped SGD updates as |x - witness| / |witness| (L2; '
        f'the witness the CPU\'s f64 run) [{card}]. float64: '
        f'loss {float(got64[0])!r} (witness {float(wit[0])!r}, relative '
        f'{loss64:.3e}); ' + ', '.join(f'{n} {e:.3e}' for n, e in f64.items())
        + f' (bound {PTB_F64_RTOL}). f32, TF32 off: loss {float(got[0])!r} '
        f'(cpu {float(want[0])!r}, relative {loss_err:.3e}); card / bound '
        f'(2x the f32 cpu\'s + {PTB_GRAD_FLOOR}): ' + ', '.join(
            f'{n} {e:.3e} / {b:.3e}' for n, (e, b) in f32.items())
        + f'. The card\'s gradients scaled by 0.9 read at least {s64:.3e}x '
        f'(f64) and {s32:.2f}x (f32) their bounds. Steps took ' + ', '.join(
            f'{p} {t} {x:.1f} s' for (p, t), x in secs.items()))
    if s64 <= 1 or s32 <= 1:
        raise AssertionError('the gradient check passes a gradient scaled '
                             'by 0.9')
    if loss64 > PTB_F64_LOSS_RTOL or f64[w64] > PTB_F64_RTOL:
        raise AssertionError('the static PTB LM in float64 on the card '
                             'differs from the CPU beyond the stated '
                             'tolerance')
    if loss_err > PTB_LOSS_RTOL or any(e > b for e, b in f32.values()):
        raise AssertionError('the static PTB LM on the card differs from '
                             'the CPU executor beyond the stated tolerance')


def ptb_batch(seed, c):
    """One batch of seeded token ids with a Zipf unigram skew (p(k)
    proportional to 1 / (k + 1), as word counts fall), as train.py's
    reader cuts PTB: each row reads ``num_steps`` ids of its own stream,
    and ``y`` is the ids one on."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, c['vocab_size'] + 1)
    n = c['num_steps']
    ids = rng.choice(c['vocab_size'], (c['batch_size'], n + 1),
                     p=p / p.sum())
    return {'x': ids[:, :n, None], 'y': ids[:, 1:].reshape(-1, 1)}


def ops_run(program, trips):
    """Ops a run of ``program`` executes: the global block's, and each
    scan's step block once a trip (``trips``: one count a scan, in
    program order)."""
    n = len(program.global_block().ops)
    scans = [op for op in program.global_block().ops if op.type == '__scan__']
    for op, k in zip(scans, trips):
        n += k * len(program.block(op.attrs['block']).ops)
    return n


def train_ptb_route(fluid, static_ptb_lm, route, seed, card):
    """One route of the PTB LM at ``large``, nothing cut, through
    ``CompiledProgram`` on ``Executor(CUDAPlace(0))``: trained, timed and
    profiled. Returns a summary for the phase's last line."""
    import torch
    saved = static_ptb_lm.BOUNDARIES, static_ptb_lm.VALUES
    if route == 'static':
        static_ptb_lm.BOUNDARIES = PTB_MOVED_BOUNDARIES
        static_ptb_lm.VALUES = saved[1][13:16]
    try:
        with fluid.unique_name.guard():
            main, startup, test, v = static_ptb_lm.build(fluid, route)
        bounds, values = static_ptb_lm.BOUNDARIES, static_ptb_lm.VALUES
    finally:
        static_ptb_lm.BOUNDARIES, static_ptb_lm.VALUES = saved
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != PTB_PARAMS:
        raise AssertionError(f'PTB LM ({route}) has {n_params} parameters')
    c = static_ptb_lm.LARGE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    batch = ptb_batch(seed, c)
    h = cell = np.zeros((c['num_layers'], c['batch_size'], c['hidden_size']),
                        np.float32)
    fetch = [v['loss'], v['last_hidden'], v['last_cell'], v['lr']]
    losses, rates, secs = [], [], []
    for _ in range(PTB_STEPS):
        t0 = time.perf_counter()
        loss, h, cell, lr = exe.run(
            step, feed={**batch, 'init_hidden': h, 'init_cell': cell},
            fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        rates.append(float(lr[0]))
    peak = torch.cuda.max_memory_allocated()
    want_rates = [values[int(np.searchsorted(bounds, i, side='right'))]
                  for i in range(len(rates))]
    windows = [statistics.median(losses[i:i + PTB_WINDOW])
               for i in range(0, len(losses), PTB_WINDOW)]
    log(f'static PTB LM ({route}) losses: '
        + ' '.join(repr(x) for x in losses))
    log(f'static PTB LM ({route}) loss medians over windows of '
        f'{PTB_WINDOW} steps: ' + ', '.join(f'{m:.1f}' for m in windows)
        + f'; the first {PTB_WARMUP + TRAIN_STEPS} steps: first '
        f'{losses[0]:.1f}, last {losses[PTB_WARMUP + TRAIN_STEPS - 1]:.1f}, '
        f'max {max(losses[:PTB_WARMUP + TRAIN_STEPS]):.1f}')
    if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or not windows[-1] < windows[0]):
        raise AssertionError(f'PTB LM ({route}) losses: not finite or not '
                             f'falling over {len(losses)} steps')
    if not np.allclose(rates, want_rates, rtol=1e-7, atol=0):
        raise AssertionError(f'rates {rates} are not piecewise_decay\'s '
                             f'{want_rates}')
    lowered = exe.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'train program lowered {lowered} times')
    timed_s = secs[PTB_WARMUP:PTB_WARMUP + TRAIN_STEPS]
    p50 = statistics.median(timed_s) * 1e3
    tokens_s = PTB_TOKENS * TRAIN_STEPS / sum(timed_s)
    feed = {**batch, 'init_hidden': h, 'init_cell': cell}
    dispatch, forward = [], []
    for prog, out in ((step, dispatch), (test, forward)):
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            exe.run(prog, feed=feed, fetch_list=[v['loss']], scope=scope,
                    return_numpy=False)
            out.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    n_ops = ops_run(main, itertools.repeat(c['num_steps']))
    ops_fwd = ops_run(test, itertools.repeat(c['num_steps']))
    d50, f50 = (statistics.median(dispatch) * 1e3,
                statistics.median(forward) * 1e3)
    share = tokens_s / PTB_TOKENS * PTB_GFLOP_PER_STEP * 1e9 \
        / BF16_FLOPS_PER_S
    log(f'static PTB LM ({route}) trained through CompiledProgram [{card}]: '
        f'{len(losses)} steps ({PTB_WARMUP} warm-up, {TRAIN_STEPS} timed, '
        f'{len(losses) - PTB_WARMUP - TRAIN_STEPS} more untimed) '
        f'at batch {c["batch_size"]} x {c["num_steps"]}, dropout '
        f'{c["dropout"]}, f32 (TF32 off), the fetched last states fed back: '
        f'{tokens_s:.1f} tokens/s over the timed steps, step p50 '
        f'{p50:.3f} ms (min '
        f'{min(timed_s) * 1e3:.3f}, max {max(timed_s) * 1e3:.3f}); host '
        f'dispatch p50 {d50:.3f} ms for {n_ops} ops '
        f'({d50 / n_ops * 1e3:.2f} us an op; run returning device '
        f'tensors, before the sync), '
        f'the forward alone (test program) {f50:.3f} ms for {ops_fwd} ops; '
        f'peak device memory {peak} bytes; model-FLOP share {share:.4f} '
        f'({PTB_GFLOP_PER_STEP:.1f} GFLOP a step over 989 TFLOP/s, of an '
        f'f32 step); rates {rates[0]!r}..{rates[-1]!r} = piecewise_decay\'s '
        f'(boundaries {bounds[:3]}...); lowerings of the train program '
        f'{lowered}')
    profile_train_step(
        lambda: exe.run(step, feed=feed, fetch_list=[v['loss']],
                        scope=scope),
        (), p50, card, PTB_STEP_GROUPS, what=f'static PTB LM ({route}) step')
    return f'{route} {tokens_s:.1f} tokens/s, p50 {p50:.3f} ms'


def train_static_ptb_lm(seed, card):
    """Phase 12: the static control flow on the card against the CPU, then
    PaddleNLP's PTB LSTM LM at ``large``: card against CPU, and both
    routes trained. Returns the kernels' launch counts over the phase
    (none of the port's kernels is on this path)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import static_ptb_lm
    nn_ops.reset_launch_counts()
    fluid.seed(seed)
    check_control_flow_on_card(card)
    ptb_card_against_cpu(fluid, static_ptb_lm, seed, card)
    summary = [train_ptb_route(fluid, static_ptb_lm, route, seed, card)
               for route in ('padding', 'static')]
    log(f'static PTB LM [{card}]: ' + '; '.join(summary))
    return nn_ops.launch_counts()



# Phase 13: PaddleNLP's attention seq2seq (tools/static_seq2seq.py) at the
# recipe's width (IWSLT'15 en-vi: vocabularies 17,191 and 7,709, hidden
# 512, 2 + 2 LSTM layers, 26,927,616 parameters), nothing cut. One batch
# of 128 seeded sentence pairs, lengths drawn in 10-50 with a Zipf skew of
# the token ids, padded with </s> as the recipe's reader pads them (to 50
# source and 49 target positions, the longest the lengths can be), trained
# through Executor(CUDAPlace(0)) with Adam(0.001) and the global-norm clip
# at 5: S2S_WARMUP warm-up and TRAIN_STEPS timed steps, each synchronised,
# then untimed ones to S2S_STEPS; the loss must stay finite and end below
# its start. The card against the CPU at batch S2S_CHECK_BATCH, dropout
# off, as phases 11 and 12 (four_step_runs): the loss and the 13 gradients
# in L2 norm against the CPU's float64 run. Then the beam search (beam 10,
# up to 100 steps, infer.py's program) over the trained parameters: the
# card's ids against the CPU's at batch S2S_BEAM_CHECK_BATCH (equal, or
# parted where the two runs' step scores first differ by no more than
# NEAR_TIE), then at batch 128, timed.
S2S_PARAMS, S2S_CHECK_BATCH, S2S_BEAM_CHECK_BATCH = 26927616, 8, 2
S2S_WARMUP, S2S_STEPS, S2S_DECODES = 3, 40, 3
S2S_LENGTHS = (10, 50)          # sentence lengths drawn, </s> counted
S2S_F64_RTOL, S2S_F64_LOSS_RTOL, S2S_GRAD_FLOOR = 1e-6, 1e-10, 1e-4
S2S_LOSS_RTOL = 1e-4            # the f32 loss against the f32 CPU run's
S2S_SCORE_RTOL = 1e-5           # beam step scores, card against CPU, f32
S2S_STEP_GROUPS = {
    'kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
    'copies and fills': lambda key: key.startswith(('Memcpy', 'Memset')),
    'gemm': STATIC_STEP_GROUPS['gemm'],
    'elementwise': lambda key: 'elementwise' in key,
    'reductions': lambda key: 'reduce_kernel' in key,
    'softmax': lambda key: 'softmax' in key.lower(),
    'top-k and sort': lambda key: any(t in key.lower()
                                      for t in ('topk', 'sort', 'radix')),
    'gather and index': lambda key: any(t in key.lower() for t in (
        'gather', 'index', 'embedding')),
    'concat': lambda key: 'CatArray' in key}


def s2s_batch(seed, batch, c):
    """The recipe's feeds for one batch of seeded sentence pairs: lengths
    (</s> counted) drawn in ``S2S_LENGTHS``, ids with a Zipf skew over the
    vocabulary past the three marks; the source ends with </s>, the
    target runs <s> ... </s>; both padded with </s> to the recipe's
    widths. ``tar`` is the target but its last position, ``label`` but
    its first, ``tar_sequence_length`` the target's length less one."""
    from paddle_tpu_torch.tools import static_seq2seq
    rng = np.random.default_rng(seed)
    end, start = static_seq2seq.END, static_seq2seq.START

    def rows(n_rows, width, vocab, bos):
        p = 1.0 / np.arange(1, vocab - 2)
        lens = rng.integers(S2S_LENGTHS[0], S2S_LENGTHS[1] + 1, n_rows)
        out = np.full((n_rows, width), end, np.int64)
        for i, k in enumerate(lens):
            body = 3 + rng.choice(vocab - 3, k - 1 - bos, p=p / p.sum())
            out[i, bos:k - 1] = body
            if bos:
                out[i, 0] = start
        return out, lens

    src, src_lens = rows(batch, c['src_len'], c['src_vocab_size'], 0)
    tar, tar_lens = rows(batch, c['tar_len'] + 1, c['tar_vocab_size'], 1)
    return {'src': src, 'src_sequence_length': src_lens.astype(np.int32),
            'tar': tar[:, :-1], 'label': tar[:, 1:, None],
            'tar_sequence_length': (tar_lens - 1).astype(np.int32)}


def s2s_card_against_cpu(fluid, static_seq2seq, seed, card):
    """The first training step at the recipe's width, batch
    ``S2S_CHECK_BATCH``, dropout off, from the card's startup values four
    times (``four_step_runs``); the CPU's f64 run is the witness."""
    from paddle_tpu_torch.tools.witness import rel_l2
    with fluid.unique_name.guard():
        main, startup, v = static_seq2seq.build(
            fluid, batch_size=S2S_CHECK_BATCH, dropout=0.0)
    gexe, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gexe.run(startup, scope=gscope)
    host = {x.name: gscope.find(x.name).cpu().numpy()
            for x in main.list_vars() if x.persistable}
    feed = s2s_batch(seed + 13, S2S_CHECK_BATCH, static_seq2seq.RECIPE)
    params = [p.name for p in main.all_parameters()]
    fetch = [v['loss'].name] + [n + '@GRAD' for n in params]
    runs, secs = four_step_runs(fluid, main, v['loss'].name, host, feed,
                                fetch)
    got, want = runs['card', 'float32'], runs['cpu', 'float32']
    got64, wit = runs['card', 'float64'], runs['cpu', 'float64']
    if got64[1].dtype != np.float64 or wit[1].dtype != np.float64:
        raise AssertionError('the float64 runs computed in '
                             f'{got64[1].dtype}, {wit[1].dtype}')
    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    loss64 = abs(float(got64[0]) - float(wit[0])) / abs(float(wit[0]))
    f64 = {n: rel_l2(g, x) for n, g, x in zip(params, got64[1:], wit[1:])}
    f32 = {n: (rel_l2(g, x), 2 * rel_l2(w, x) + S2S_GRAD_FLOOR)
           for n, g, w, x in zip(params, got[1:], want[1:], wit[1:])}
    s64 = min(rel_l2(np.float64(0.9) * g, x) / S2S_F64_RTOL
              for g, x in zip(got64[1:], wit[1:]))
    s32 = min(rel_l2(np.float32(0.9) * g, x) / f32[n][1]
              for n, g, x in zip(params, got[1:], wit[1:]))
    w64 = max(f64, key=f64.get)
    log(f'static seq2seq, batch {S2S_CHECK_BATCH}, dropout off, card '
        f'against the CPU executor, the {len(params)} gradients as |x - '
        f'witness| / |witness| (L2; the witness the CPU\'s f64 run) '
        f'[{card}]. float64: loss {float(got64[0])!r} (witness '
        f'{float(wit[0])!r}, relative {loss64:.3e}); ' + ', '.join(
            f'{n} {e:.3e}' for n, e in f64.items())
        + f' (bound {S2S_F64_RTOL}). f32, TF32 off: loss {float(got[0])!r} '
        f'(cpu {float(want[0])!r}, relative {loss_err:.3e}); card / bound '
        f'(2x the f32 cpu\'s + {S2S_GRAD_FLOOR}): ' + ', '.join(
            f'{n} {e:.3e} / {b:.3e}' for n, (e, b) in f32.items())
        + f'. The card\'s gradients scaled by 0.9 read at least {s64:.3e}x '
        f'(f64) and {s32:.2f}x (f32) their bounds. Steps took ' + ', '.join(
            f'{p} {t} {x:.1f} s' for (p, t), x in secs.items()))
    if s64 <= 1 or s32 <= 1:
        raise AssertionError('the gradient check passes a gradient scaled '
                             'by 0.9')
    if loss64 > S2S_F64_LOSS_RTOL or f64[w64] > S2S_F64_RTOL:
        raise AssertionError('the static seq2seq in float64 on the card '
                             'differs from the CPU beyond the stated '
                             'tolerance')
    if loss_err > S2S_LOSS_RTOL or any(e > b for e, b in f32.values()):
        raise AssertionError('the static seq2seq on the card differs from '
                             'the CPU executor beyond the stated tolerance')


def train_s2s(fluid, static_seq2seq, seed, card, amp=None):
    """The recipe's train program at full width and batch 128 on one
    seeded batch (under ``decorate(dtype=amp)`` where ``amp`` is given):
    ``S2S_STEPS`` steps trained, timed and profiled. Returns (the card's
    scope, the batch, a summary)."""
    import torch
    c = static_seq2seq.RECIPE
    with fluid.unique_name.guard():
        main, startup, v = static_seq2seq.build(fluid, amp=amp)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != S2S_PARAMS:
        raise AssertionError(f'seq2seq has {n_params} parameters')
    batch = s2s_batch(seed, c['batch_size'], c)
    tokens = int(batch['tar_sequence_length'].sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    losses, secs = [], []
    for _ in range(S2S_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=batch, fetch_list=[v['loss']],
                        scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    what = 'static seq2seq' + (f' under {amp} AMP' if amp else '')
    log(f'{what} losses: ' + ' '.join(repr(x) for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'seq2seq losses: not finite or not falling '
                             f'over {len(losses)} steps')
    lowered = exe.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'train program lowered {lowered} times')
    timed_s = secs[S2S_WARMUP:S2S_WARMUP + TRAIN_STEPS]
    p50 = statistics.median(timed_s) * 1e3
    tokens_s = tokens * TRAIN_STEPS / sum(timed_s)
    dispatch = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[v['loss']], scope=scope,
                return_numpy=False)
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    n_ops = ops_run(main, (c['src_len'], c['tar_len']))
    d50 = statistics.median(dispatch) * 1e3
    log(f'{what} trained [{card}]: {len(losses)} steps '
        f'({S2S_WARMUP} warm-up, {TRAIN_STEPS} timed, '
        f'{len(losses) - S2S_WARMUP - TRAIN_STEPS} more untimed) at batch '
        f'{c["batch_size"]} x {c["src_len"]} source, {c["tar_len"]} target '
        f'positions ({tokens} target tokens, the loss\'s), dropout '
        f'{c["dropout"]}, {amp or "f32"} (TF32 off), '
        f'Adam({static_seq2seq.LEARNING_RATE})'
        f' with the global-norm clip at {static_seq2seq.MAX_GRAD_NORM}: '
        f'{tokens_s:.1f} target tokens/s over the timed steps, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); host dispatch p50 {d50:.3f} ms for '
        f'{n_ops} ops ({d50 / n_ops * 1e3:.2f} us an op; run returning '
        f'device tensors, before the sync); peak device memory {peak} '
        f'bytes; loss {losses[0]!r} -> {losses[-1]!r}; lowerings of the '
        f'train program {lowered}')
    prof = profile_train_step(
        lambda: exe.run(main, feed=batch, fetch_list=[v['loss']],
                        scope=scope),
        (), p50, card, S2S_STEP_GROUPS, what=f'{what} train step')
    busy = '' if prof is None else (f', busy {prof[0]:.3f} ms, idle '
                                    f'{1 - prof[0] / p50:.3f}')
    return scope, batch, (f'train {tokens_s:.1f} target tokens/s, p50 '
                          f'{p50:.3f} ms{busy}, peak {peak} bytes')


def s2s_beam_program(fluid, static_seq2seq, batch_size, trained, place):
    """The recipe's beam-search program at ``batch_size`` and an executor
    and scope on ``place`` holding the ``trained`` parameters (numpy, by
    name)."""
    from paddle_tpu_torch.convert import scope_from_paddle
    with fluid.unique_name.guard():
        prog, _, v = static_seq2seq.build(fluid, 'beam_search',
                                          batch_size=batch_size)
    scope = fluid.Scope()
    scope_from_paddle(trained, scope, place, program=prog)
    return fluid.Executor(place), prog, scope, v


def s2s_beams_equal_or_near_tie(got, want, what):
    """The card's beam ids and step scores (B, T, W) against the CPU's:
    each row's ids equal, or the first step where the two runs' scores
    part beyond f32 round-off parts them by at most ``NEAR_TIE`` (a near
    tie chose another candidate there). Returns the rows that parted."""
    (gi, gs), (wi, ws) = got, want
    tol = S2S_SCORE_RTOL * np.maximum(np.abs(ws), 1.0)
    parted = []
    for r in range(gi.shape[0]):
        if np.array_equal(gi[r], wi[r]):
            continue
        off = np.nonzero((np.abs(gs[r] - ws[r]) > tol[r]).any(-1))[0]
        gap = (float(np.abs(gs[r, off[0]] - ws[r, off[0]]).max())
               if off.size else 0.0)
        log(f'{what}: row {r} differs; step scores first part at step '
            f'{int(off[0]) if off.size else None} by {gap:.3e} (near-tie '
            f'limit {NEAR_TIE})')
        if gap > NEAR_TIE:
            raise AssertionError(f'{what}: row {r} differs with a step score '
                                 f'gap of {gap}')
        parted.append(r)
    return parted


def beam_search_s2s(fluid, static_seq2seq, scope, batch, card):
    """infer.py's beam search over the trained parameters: the card against
    the CPU at a small batch, then batch 128 timed and profiled. Returns a
    summary."""
    import torch
    c = static_seq2seq.RECIPE
    with fluid.unique_name.guard():
        names = [p.name for p in static_seq2seq.build(
            fluid, 'beam_search')[0].all_parameters()]
    trained = {n: scope.find(n).cpu().numpy() for n in names}
    k = S2S_BEAM_CHECK_BATCH
    small = {n: batch[n][:k] for n in ('src', 'src_sequence_length')}
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        exe, prog, bscope, v = s2s_beam_program(fluid, static_seq2seq, k,
                                                trained, place)
        runs.append(exe.run(prog, feed=small,
                            fetch_list=[v['ids'], v['scores']],
                            scope=bscope))
    (gi, gs), (wi, ws) = runs
    parted = s2s_beams_equal_or_near_tie((gi, gs), (wi, ws),
                                         'seq2seq beam search')
    log(f'static seq2seq beam search, card against the CPU executor at '
        f'batch {k}, beam {c["beam_size"]}, {c["max_decode_steps"]} steps '
        f'[{card}]: ids {gi.shape} equal in {k - len(parted)} of {k} rows; '
        f'step scores max |diff| {float(np.abs(gs - ws).max()):.3e}; best '
        f'beam of row 0: {gi[0, :12, 0].tolist()}...')
    exe, prog, bscope, v = s2s_beam_program(
        fluid, static_seq2seq, c['batch_size'], trained, fluid.CUDAPlace(0))
    feed = {n: batch[n] for n in ('src', 'src_sequence_length')}
    secs = []
    for _ in range(1 + S2S_DECODES):
        t0 = time.perf_counter()
        ids, scores = exe.run(prog, feed=feed,
                              fetch_list=[v['ids'], v['scores']],
                              scope=bscope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    steps = c['max_decode_steps']
    want_shape = (c['batch_size'], steps, c['beam_size'])
    if ids.shape != want_shape or not np.isfinite(scores).all():
        raise AssertionError(f'beam ids {ids.shape} (want {want_shape}) or '
                             f'scores not finite')
    if not ((ids >= 0) & (ids < c['tar_vocab_size'])).all():
        raise AssertionError('beam ids outside the target vocabulary')
    if exe.lowering_count(prog) != 1:
        raise AssertionError('beam-search program lowered more than once')
    p50 = statistics.median(secs[1:]) * 1e3
    sentences_s = c['batch_size'] / (p50 / 1e3)
    finished = float((ids[:, -1, :] == static_seq2seq.END).mean())
    log(f'static seq2seq beam search [{card}]: batch {c["batch_size"]} x '
        f'beam {c["beam_size"]}, {steps} steps (the static decode runs all '
        f'of them), {S2S_DECODES} timed decodes after one warm-up, each '
        f'synchronised: p50 {p50:.3f} ms ({p50 / steps:.3f} ms a decode '
        f'step), {sentences_s:.1f} sentences/s; '
        f'{ops_run(prog, (c["src_len"], steps))} ops a decode; beams ending '
        f'in </s> {finished:.3f}')
    profile_train_step(
        lambda: exe.run(prog, feed=feed, fetch_list=[v['ids']],
                        scope=bscope),
        (), p50, card, S2S_STEP_GROUPS, what='static seq2seq beam search')
    return f'beam search {sentences_s:.1f} sentences/s, p50 {p50:.3f} ms'


def train_static_seq2seq(seed, card):
    """Phase 13: PaddleNLP's attention seq2seq at the recipe's width: card
    against CPU, trained, then beam-searched. Returns the kernels' launch
    counts over the phase (none of the port's kernels is on this path)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import static_seq2seq
    nn_ops.reset_launch_counts()
    fluid.seed(seed)
    s2s_card_against_cpu(fluid, static_seq2seq, seed, card)
    scope, batch, trained = train_s2s(fluid, static_seq2seq, seed, card)
    decoded = beam_search_s2s(fluid, static_seq2seq, scope, batch, card)
    log(f'static seq2seq [{card}]: {trained}; {decoded}')
    return nn_ops.launch_counts()


# PaddleCV's static ResNet-50 recipe (tools/static_resnet.py, as phase 11
# builds it: full width, batch 128 at 224^2, NCHW, through CompiledProgram)
# under static mixed precision and recompute, and PaddleNLP's seq2seq (as
# phase 13) under bf16. bf16's unit round-off u = 2**-8. The bf16 step at
# batch 8, card against the CPU executor from the same values, each held
# to a float64 witness (the program without casts, run on the CPU): the
# card's error at most 3x the CPU's plus 2u, for the loss (absolute, 2u of
# the witness's loss) and each of the head's two gradients (relative L2),
# and over all 161 gradients the root mean square of the per-gradient
# errors at most 2x the CPU's plus 2u and at least a third of it (both
# compute in bf16); below the head bf16 gradients of a batch-normalised
# net are mostly rounding noise (tests/test_torch_static_amp.py), so a
# 0.9x scale of the card's must fail at the head. fp16 is the recipe's
# --use_fp16 path with the flags of PaddleCV's ResNet50_fp16.sh:
# --scale_loss=128.0 --use_dynamic_loss_scaling=True (decorate's other
# arguments its defaults: decr_every_n_nan_or_inf 2, incr_every_n_steps
# 1000, ratios 0.8 and 2). Recompute: RecomputeOptimizer with the 16
# bottleneck outputs as checkpoints, f32; three steps, each from a plain
# run's state, against a second plain run from the same state: the loss
# within twice the two plain runs' distance plus 1e-6 of it, the root mean
# square over the gradients of their relative L2 distances within twice
# the plain runs' plus 1e-6 (one state a step: from the second step on,
# f32 runs of this net part chaotically, ROADMAP C.4 item 4, so three
# trajectories would compare noise). The bf16 eval clone's logits within
# 3u of their largest entry from the f32 eval program's on the same
# trained values (measured 4.873e-3, 1.25u, NVIDIA H100 80GB HBM3 at 700 W;
# the softmax is saturated, so its outputs would hide the body), and the
# clone with one bottleneck's last convolution (CLONE_FAULT) scaled by 0.9
# must fail that bound. The saved f32 model through
# Predictor(Config(dir).enable_bf16()): equal bit for bit to the f32
# Predictor fed the bf16-rounded images, and within 2**-5 of the largest
# entry of the f32 Predictor's output on the raw ones
AMP_U = 2.0 ** -8
AMP_CLONE_RTOL = 3 * AMP_U
CLONE_FAULT = 'res5c_branch2c_weights'
AMP_SERVE_RTOL = 2.0 ** -5
AMP_HEAD = ('fc_0.w_0', 'fc_0.b_0')
RECOMPUTE_STEPS, RECOMPUTE_FLOOR = 3, 1e-6
# the convolution kernels of a profiled step whose names say bf16
BF16_KERNEL = ('bf16', 'bfloat16')


def amp_resnet_card_against_cpu(fluid, main, v, gscope, seed, card):
    """The bf16 step at batch 8 from the card's startup values on the card
    and on the CPU executor, each held to the CPU's float64 run of the
    program without casts."""
    from paddle_tpu_torch.tools.witness import rel_l2
    persist = [x.name for x in main.list_vars() if x.persistable]
    host = {n: gscope.find(n).cpu().numpy() for n in persist}
    rng = np.random.default_rng(seed + 11)
    feed = {'image': rng.standard_normal(
        (SRESNET_CHECK_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (SRESNET_CHECK_BATCH, 1))}
    params = [p.name for p in main.all_parameters()]
    fetch = [v['loss'].name] + [n + '@GRAD' for n in params]
    runs, secs = four_step_runs(fluid, main, v['loss'].name, host, feed,
                                fetch)
    card_r, cpu_r, wit = (runs['card', 'float32'], runs['cpu', 'float32'],
                          runs['cpu', 'float64'])
    lc, lp, lw = float(card_r[0]), float(cpu_r[0]), float(wit[0])
    errs = {n: (rel_l2(g, w), rel_l2(c, w),
                rel_l2(np.float32(0.9) * g, w))
            for n, g, c, w in zip(params, card_r[1:], cpu_r[1:], wit[1:])}
    rms = np.sqrt(np.mean(np.square(list(errs.values())), axis=0))
    head = {n: (errs[n][0], 3 * errs[n][1] + 2 * AMP_U) for n in AMP_HEAD}
    log(f'static ResNet-50 bf16 AMP, batch {SRESNET_CHECK_BATCH}, card '
        f'against the CPU executor, each against the CPU\'s float64 run '
        f'without casts (the witness) [{card}]: loss card {lc!r}, cpu '
        f'{lp!r}, witness {lw!r}; the head\'s gradients card / bound (3x '
        f'the cpu\'s + 2u): ' + ', '.join(
            f'{n} {e:.4e} / {b:.4e} (0.9x {errs[n][2]:.4e})'
            for n, (e, b) in head.items())
        + f'; over all {len(params)} gradients (rms) card {rms[0]:.4f}, cpu '
        f'{rms[1]:.4f}; ' + ', '.join(
            f'{n} card {errs[n][0]:.3e} cpu {errs[n][1]:.3e}'
            for n in SRESNET_GRADS) + '. Steps took ' + ', '.join(
            f'{p} {c} {t:.1f} s' for (p, c), t in secs.items()))
    if abs(lc - lw) > 3 * abs(lp - lw) + 2 * AMP_U * abs(lw):
        raise AssertionError('the bf16 loss on the card is off the CPU\'s')
    if any(e > b for e, b in head.values()):
        raise AssertionError('a head gradient on the card is off the CPU\'s')
    if not rms[1] / 3 <= rms[0] <= 2 * rms[1] + 2 * AMP_U:
        raise AssertionError(f'bf16 gradient errors card {rms[0]}, cpu '
                             f'{rms[1]}')
    if not any(errs[n][2] > head[n][1] for n in AMP_HEAD):
        raise AssertionError('the check passes gradients scaled by 0.9')


def time_static_resnet(fluid, exe, main, v, scope, feed, what, card):
    """WARMUP_STEPS + TRAIN_STEPS steps of ``main`` through
    ``CompiledProgram``, each synchronised, then the host dispatch and a
    profiled step. Returns (losses, peak bytes, summary, profile)."""
    import torch
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(step, feed=feed, fetch_list=[v['loss']], scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    peak = torch.cuda.max_memory_allocated()
    log(f'{what} losses: ' + ' '.join(repr(x) for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'{what} losses {losses}: not finite or not '
                             f'falling')
    lowered = exe.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'{what}: lowered {lowered} times')
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    images_s = RESNET_BATCH * TRAIN_STEPS / sum(timed_s)
    dispatch = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        exe.run(step, feed=feed, fetch_list=[v['loss']], scope=scope,
                return_numpy=False)
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    log(f'{what} trained through CompiledProgram [{card}]: {len(losses)} '
        f'steps ({WARMUP_STEPS} warm-up, {TRAIN_STEPS} timed) at batch '
        f'{RESNET_BATCH}: {images_s:.1f} images/s, step p50 {p50:.3f} ms '
        f'(min {min(timed_s) * 1e3:.3f}, max {max(timed_s) * 1e3:.3f}); '
        f'host dispatch p50 {statistics.median(dispatch) * 1e3:.3f} ms (run '
        f'returning device tensors, before the sync); peak device memory '
        f'{peak} bytes; model-FLOP share '
        f'{images_s * RESNET_GFLOP_PER_IMAGE * 1e9 / BF16_FLOPS_PER_S:.4f}; '
        f'lowerings {lowered}')
    prof = profile_train_step(
        lambda: exe.run(step, feed=feed, fetch_list=[v['loss']],
                        scope=scope),
        (), p50, card, STATIC_STEP_GROUPS, what=f'{what} step')
    summary = f'{images_s:.1f} images/s, p50 {p50:.3f} ms'
    if prof is not None:
        summary += f', busy {prof[0]:.3f} ms, idle {1 - prof[0] / p50:.3f}'
    return losses, peak, summary, prof


def check_bf16_convolutions(prof, card):
    """The profiled bf16 step's convolution kernels: the share of their
    time in kernels whose names say bf16 (cuDNN's and CUTLASS's name the
    element type), which must be most of it."""
    if prof is None:
        raise AssertionError('the bf16 step\'s profile recorded no device '
                             'time, so its convolutions\' types are unseen')
    conv = [e for e in prof[1] if STATIC_STEP_GROUPS['convolutions'](e.key)]
    ms = {e.key: getattr(e, 'self_device_time_total', 0.0) / 1e3
          for e in conv}
    bf16 = {k: t for k, t in ms.items()
            if any(m in k.lower() for m in BF16_KERNEL)}
    share = sum(bf16.values()) / max(sum(ms.values()), 1e-9)
    log(f'bf16 convolution kernels [{card}]: {sum(bf16.values()):.3f} of '
        f'{sum(ms.values()):.3f} ms of convolution in {len(bf16)} of '
        f'{len(ms)} kernels whose names say bf16 (share {share:.3f}); ' +
        '; '.join(f'{k[:70]} {t:.3f} ms' for k, t in sorted(
            ms.items(), key=lambda kv: -kv[1])[:6]))
    if share < 0.5:
        raise AssertionError('the bf16 step\'s convolutions are not bf16 '
                             'kernels')


def amp_resnet_bf16(fluid, static_resnet, seed, card):
    """(a) and (d): the recipe under decorate(dtype='bfloat16'), card
    against CPU, trained, then its eval clone and the saved model through
    the bf16 Predictor. Returns a summary."""
    import tempfile
    import torch
    from paddle_tpu_torch import inference
    with fluid.unique_name.guard():
        main, startup, test, v = static_resnet.build(fluid, amp='bfloat16')
    with fluid.unique_name.guard():     # the f32 eval program, same names
        _, _, test32, v32 = static_resnet.build(fluid)
    if test._amp_config is not main._amp_config:
        raise AssertionError('the eval program lost the casts')
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    amp_resnet_card_against_cpu(fluid, main, v, gscope, seed, card)
    rng = np.random.default_rng(seed)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    masters = {p.name: gscope.find(p.name).dtype
               for p in main.all_parameters()}
    _, _, trained, prof = time_static_resnet(
        fluid, gpu, main, v, gscope, feed, 'static ResNet-50 bf16 AMP', card)
    check_bf16_convolutions(prof, card)
    if any(gscope.find(n).dtype != torch.float32 for n in masters):
        raise AssertionError('a master parameter is not f32')

    # (d) the eval clone, and the saved model through the Predictors
    erng = np.random.default_rng(seed + 1)
    batches = [erng.standard_normal((RESNET_BATCH, 3, RESNET_IMG,
                                     RESNET_IMG), dtype=np.float32)
               for _ in range(SRESNET_EVAL_BATCHES)]
    label = np.zeros((RESNET_BATCH, 1), np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        with fluid.scope_guard(gscope):
            fluid.io.save_inference_model(tmp, ['image'], [v['prob']], gpu,
                                          main_program=main)
        f32 = inference.create_paddle_predictor(inference.Config(tmp))
        bf16 = inference.create_paddle_predictor(
            inference.Config(tmp).enable_bf16())

    def logit_error(x, fault=1.0):
        """The eval clone's logits from the f32 eval program's on ``x``,
        relative to their largest entry, with CLONE_FAULT scaled by
        ``fault`` in the clone's run alone; the prob the clone fetched and
        the seconds its run took."""
        feed = {'image': x, 'label': label}
        logits32 = gpu.run(test32, feed=feed, fetch_list=[v32['logits']],
                           scope=gscope)[0]
        weight = gscope.find(CLONE_FAULT)
        kept = weight.clone()
        weight.mul_(fault)
        t0 = time.perf_counter()
        got, logits = gpu.run(test, feed=feed,
                              fetch_list=[v['prob'], v['logits']],
                              scope=gscope)
        secs = time.perf_counter() - t0
        weight.copy_(kept)
        return float(np.abs(logits - logits32).max()
                     / np.abs(logits32).max()), got, secs

    clone_s, pred_s, worst_clone, worst_pred = [], [], 0.0, 0.0
    worst_logits = 0.0
    for x in batches:
        err, got, secs = logit_error(x)
        clone_s.append(secs)
        worst_logits = max(worst_logits, err)
        t0 = time.perf_counter()
        served = bf16.run([x])[0]
        pred_s.append(time.perf_counter() - t0)
        want = f32.run([x])[0]
        rounded = f32.run([torch.from_numpy(x).to(torch.bfloat16).float()
                           .numpy()])[0]
        if not (np.isfinite(got).all() and np.isfinite(served).all()):
            raise AssertionError('a bf16 eval output is not finite')
        if not np.array_equal(served, rounded):
            raise AssertionError('the bf16 Predictor is not the f32 model '
                                 'on bf16-rounded images')
        scale = np.abs(want).max()
        worst_clone = max(worst_clone, float(np.abs(got - want).max() / scale))
        worst_pred = max(worst_pred, float(np.abs(served - want).max()
                                           / scale))
    planted = logit_error(batches[0], fault=0.9)[0]
    lowerings = (gpu.lowering_count(test), f32.executor.lowering_count(
        f32.program), bf16.executor.lowering_count(bf16.program))
    eval_p50 = statistics.median(clone_s[1:]) * 1e3
    log(f'static ResNet-50 bf16 eval [{card}]: {SRESNET_EVAL_BATCHES} '
        f'batches of {RESNET_BATCH}; the eval clone under the casts '
        f'{RESNET_BATCH * (len(clone_s) - 1) / sum(clone_s[1:]):.1f} '
        f'images/s, batch p50 {eval_p50:.3f} ms, max|diff| from the f32 '
        f'model {worst_clone:.3e} of its largest entry (the softmax), '
        f'{worst_logits:.3e} (the logits, bound {AMP_CLONE_RTOL:.4e}; with '
        f'{CLONE_FAULT} scaled by 0.9 {planted:.3e}); Predictor with '
        f'enable_bf16 {RESNET_BATCH * (len(pred_s) - 1) / sum(pred_s[1:]):.1f}'
        f' images/s, batch p50 {statistics.median(pred_s[1:]) * 1e3:.3f} ms, '
        f'equal bit for bit to the f32 Predictor on the rounded images, '
        f'{worst_pred:.3e} of the largest entry from it on the raw ones '
        f'(bound {AMP_SERVE_RTOL}); lowerings (clone, f32 Predictor, bf16 '
        f'Predictor) {lowerings}')
    if lowerings != (1, 1, 1) or worst_pred > AMP_SERVE_RTOL:
        raise AssertionError(f'bf16 serving: lowerings {lowerings}, '
                             f'Predictor {worst_pred:.3e} from f32')
    if worst_logits > AMP_CLONE_RTOL:
        raise AssertionError(f'the bf16 eval clone\'s logits are '
                             f'{worst_logits:.3e} from the f32 program\'s')
    if not planted > AMP_CLONE_RTOL:
        raise AssertionError(f'the eval check passes {CLONE_FAULT} scaled '
                             f'by 0.9 ({planted:.3e})')
    profile_train_step(
        lambda: gpu.run(test, feed={'image': batches[0], 'label': label},
                        fetch_list=[v['prob']], scope=gscope),
        (), eval_p50, card, STATIC_STEP_GROUPS,
        what='static ResNet-50 bf16 eval batch')
    return f'bf16 {trained}; eval clone p50 {eval_p50:.3f} ms'


def amp_resnet_fp16(fluid, static_resnet, seed, card):
    """(b): the recipe's --use_fp16 path with dynamic loss scaling,
    trained, then two steps fed an image of inf (skipped) and a finite
    one. Returns a summary."""
    import torch
    with fluid.unique_name.guard():
        main, startup, _, v = static_resnet.build(fluid, amp='float16')
    opt = v['optimizer']
    gpu, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    _, _, trained, _ = time_static_resnet(
        fluid, gpu, main, v, scope, feed, 'static ResNet-50 fp16 AMP', card)
    names = [opt._scale_var.name] + [
        x.name for x in main.list_vars()
        if x.name.startswith(('loss_scaling_good', 'loss_scaling_bad'))]

    def loss_state():
        return tuple(float(scope.find(n).reshape(()).item())
                     for n in names) + (opt.overflow_steps(scope),)

    kept = [p.name for p in main.all_parameters()] + [
        x.name for x in main.list_vars()
        if x.persistable and '_velocity_' in x.name]
    before = {n: scope.find(n).clone() for n in kept}
    state0 = loss_state()
    if state0[-1] != 0:
        raise AssertionError(f'fp16 training skipped steps: {state0}')
    inf = dict(feed, image=np.full_like(feed['image'], np.inf))
    states = []
    for _ in range(2):
        gpu.run(main, feed=inf, fetch_list=[v['loss']], scope=scope)
        states.append(loss_state())
        moved = [n for n in kept if not torch.equal(scope.find(n),
                                                    before[n])]
        if moved:
            raise AssertionError(f'the inf step moved {moved[:3]}')
    scale = state0[0]
    want = [(scale, 0.0, 1.0, 1),
            (float(max(np.float32(scale) * np.float32(0.8), 1.0)), 0.0, 0.0,
             2)]
    if states != want:
        raise AssertionError(f'loss scaling after the inf steps {states}, '
                             f'the rule gives {want}')
    gpu.run(main, feed=feed, fetch_list=[v['loss']], scope=scope)
    moved = sum(not torch.equal(scope.find(n), before[n]) for n in kept)
    if not moved:
        raise AssertionError('the finite step after the skips moved nothing')
    log(f'static ResNet-50 fp16 loss scaling [{card}]: init_loss_scaling '
        f'{static_resnet.SCALE_LOSS} (ResNet50_fp16.sh --scale_loss), '
        f'dynamic, decr_every_n_nan_or_inf 2, incr_every_n_steps 1000; '
        f'(scale, good, bad, overflow_steps()) after the timed loop '
        f'{state0}, after a step of inf images {states[0]}, after a second '
        f'{states[1]}; the '
        f'{len(kept)} parameters and velocities bit for bit through both; '
        f'a finite step then moved {moved} of them')
    return f'fp16 {trained}'


def recompute_resnet(fluid, static_resnet, seed, card, f32_peak):
    """(c): RecomputeOptimizer at the 16 bottleneck outputs, f32: three
    steps, each from plain run A's state, against a second plain run from
    the same state; then timed. Returns a summary."""
    import torch
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.tools.witness import rel_l2
    progs = {}
    for name, rc in (('plain', False), ('recompute', True)):
        with fluid.unique_name.guard():
            progs[name] = static_resnet.build(fluid, recompute=rc)
    main, startup, _, v = progs['plain']
    rmain, _, _, rv = progs['recompute']
    if len(rv['checkpoints']) != 16:
        raise AssertionError(f'{len(rv["checkpoints"])} checkpoints')
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    persist = [x.name for x in main.list_vars() if x.persistable]
    scopes = {k: fluid.Scope() for k in ('plain A', 'plain B', 'recompute')}
    gpu.run(startup, scope=scopes['plain A'])
    rng = np.random.default_rng(seed)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    params = [p.name for p in main.all_parameters()]
    fetch = [v['loss'].name] + [n + '@GRAD' for n in params]
    steps = {k: fluid.CompiledProgram(p).with_data_parallel(
        loss_name=v['loss'].name) for k, p in (
            ('plain A', main), ('plain B', main), ('recompute', rmain))}
    peaks = dict.fromkeys(steps, 0)

    def run(name, fetch_list):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = gpu.run(steps[name], feed=feed, fetch_list=fetch_list,
                      scope=scopes[name])
        torch.cuda.synchronize()
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        return out, time.perf_counter() - t0

    readings, losses = [], {k: [] for k in steps}
    for s in range(RECOMPUTE_STEPS):
        host = {n: scopes['plain A'].find(n).cpu().numpy() for n in persist}
        for k in ('plain B', 'recompute'):
            scope_from_paddle(host, scopes[k], fluid.CUDAPlace(0),
                              program=main)
        got = {k: run(k, fetch)[0] for k in steps}
        for k in steps:
            losses[k].append(float(got[k][0]))
        a, b, r = (got[k] for k in ('plain A', 'plain B', 'recompute'))
        loss_b, loss_r = abs(b[0] - a[0]).item(), abs(r[0] - a[0]).item()
        errs = np.array([(rel_l2(np.asarray(y, np.float64), x),
                          rel_l2(np.asarray(z, np.float64), x),
                          rel_l2(0.9 * np.asarray(z, np.float64), x))
                         for x, y, z in zip(a[1:], b[1:], r[1:])])
        rms = np.sqrt(np.mean(np.square(errs), axis=0))
        readings.append((loss_b, loss_r, *rms, errs[:, 0].max()))
    secs = {k: [run(k, [v['loss']])[1] for _ in range(TRAIN_STEPS)]
            for k in ('plain A', 'recompute')}
    p50 = {k: statistics.median(t) * 1e3 for k, t in secs.items()}
    log(f'static ResNet-50 with RecomputeOptimizer (16 checkpoints, the '
        f'bottleneck outputs), f32, batch {RESNET_BATCH} [{card}]: '
        f'{RECOMPUTE_STEPS} steps, each from plain run A\'s state, plain run '
        f'B and recompute against A: losses {losses}; per step (loss '
        f'|B - A|, |R - A|; over the {len(params)} gradients the rms of '
        f'rel L2 B, R, 0.9R; B\'s largest) ' + ', '.join(
            f'({lb:.3e}, {lr:.3e}; {gb:.3e}, {gr:.3e}, {g9:.3e}; {gm:.3e})'
            for lb, lr, gb, gr, g9, gm in readings)
        + f' (bounds twice B\'s + 1e-6 of the loss, + {RECOMPUTE_FLOOR} of '
        f'the rms); peak device memory recompute {peaks["recompute"]} bytes '
        f'against plain {peaks["plain A"]} in this phase and {f32_peak} in '
        f'phase 11 ({peaks["recompute"] / f32_peak:.3f}x); step p50 '
        f'recompute {p50["recompute"]:.3f} ms, plain {p50["plain A"]:.3f} ms '
        f'({TRAIN_STEPS} steps each, synchronised)')
    for s, (lb, lr, gb, gr, g9, _) in enumerate(readings):
        if lr > 2 * lb + 1e-6 * abs(losses['plain A'][s]) \
                or gr > 2 * gb + RECOMPUTE_FLOOR:
            raise AssertionError(f'recompute differs from the plain runs '
                                 f'beyond their spread at step {s + 1}')
        if g9 <= 2 * gb + RECOMPUTE_FLOOR:
            raise AssertionError('the check passes gradients scaled by 0.9')
    if not peaks['recompute'] < peaks['plain A']:
        raise AssertionError('recompute did not lower the peak memory')
    return (f'recompute p50 {p50["recompute"]:.3f} ms, peak '
            f'{peaks["recompute"]} bytes')


def train_static_amp(seed, card, f32_peak):
    """Phase 14: static mixed precision and recompute. Returns the
    kernels' launch counts over the phase (none of the port's kernels is
    on this path)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import static_resnet, static_seq2seq
    nn_ops.reset_launch_counts()
    fluid.seed(seed)
    done = [amp_resnet_bf16(fluid, static_resnet, seed, card)]
    torch.cuda.empty_cache()
    done.append(amp_resnet_fp16(fluid, static_resnet, seed, card))
    torch.cuda.empty_cache()
    done.append(recompute_resnet(fluid, static_resnet, seed, card, f32_peak))
    torch.cuda.empty_cache()
    _, _, s2s = train_s2s(fluid, static_seq2seq, seed, card, amp='bfloat16')
    done.append(f'seq2seq bf16 {s2s}')
    log(f'static mixed precision and recompute [{card}]: ' + '; '.join(done))
    return nn_ops.launch_counts()


# Phase 15: the IR passes (ROADMAP A.8d) and in-place state with early
# freeing (A.8f) on the static ResNet-50 recipe at full width, batch 128.
# 'fused' is CompiledProgram with fuse_elewise_add_act_ops,
# fuse_all_optimizer_ops and enable_inplace set (the default pipeline on);
# 'plain' is CompiledProgram with enable_inplace=False under
# PADDLE_TPU_PASSES=0, the executor as before both items but for early
# freeing, which has no switch; 'unfreed' is 'plain' with a plan that
# frees nothing (executor._free_lists patched), for the peak and the env
# high-water alone. With cuDNN's deterministic algorithms the two runs
# must give the same bits: every pass keeps each op's arithmetic
# (tests/test_torch_ir_passes.py holds them bitwise on the CPU) and an
# in-place write copies the value the fresh tensor would hold.
SRESNET_OPS = 675
FUSED_RUNS = ('plain', 'fused')
FUSED_BITWISE_STEPS = 3
LENET_ADAM_LAUNCHES = 469       # ROADMAP A.3(b), of which 185 elementwise


def fused_strategy(fluid, fused):
    """(BuildStrategy, PADDLE_TPU_PASSES) of a phase 15 run."""
    bs = fluid.compiler.BuildStrategy()
    if fused:
        bs.fuse_elewise_add_act_ops = bs.fuse_all_optimizer_ops = True
        bs.enable_inplace = True
        return bs, '1'
    bs.enable_inplace = False
    return bs, '0'


def launches_of(events):
    """(kernel launches, copies and fills) of a profiled step's events."""
    copies = sum(e.count for e in events
                 if e.key.startswith(('Memcpy', 'Memset')))
    return sum(e.count for e in events) - copies, copies


class FusedRuns:
    """One executor and a fresh scope for each phase 15 run of ``main``,
    from the numpy values ``host``."""

    def __init__(self, fluid, main, loss_name, host):
        self.fluid, self.main, self.loss_name = fluid, main, loss_name
        self.host = host

    def start(self, name, frees=True):
        """A fresh executor, scope and program for run ``name``."""
        import os
        from unittest import mock
        from paddle_tpu_torch import executor
        from paddle_tpu_torch.convert import scope_from_paddle
        fluid = self.fluid
        bs, passes = fused_strategy(fluid, name == 'fused')
        os.environ['PADDLE_TPU_PASSES'] = passes
        scope = fluid.Scope()
        scope_from_paddle(self.host, scope, fluid.CUDAPlace(0),
                          program=self.main)
        prog = fluid.CompiledProgram(self.main, build_strategy=bs)
        prog = prog.with_data_parallel(loss_name=self.loss_name)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        patch = (mock.patch.object(executor, '_free_lists',
                                   lambda touched, keep: [()] * len(touched))
                 if not frees else None)
        return exe, scope, prog, bs, patch


def fused_bitwise(runs, feed, fetch, steps, what, card):
    """``steps`` steps of 'plain' and 'fused' from the same values under
    cuDNN's deterministic algorithms: the fetches of every step and every
    persistable after them bit for bit."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    got = {}
    try:
        for name in FUSED_RUNS:
            exe, scope, prog, _, _ = runs.start(name)
            out = [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
                   for _ in range(steps)]
            state = {n: scope._find(n) for n in runs.host}
            got[name] = (out, state)
    finally:
        torch.backends.cudnn.deterministic = old
    (a, sa), (b, sb) = got['plain'], got['fused']
    differ = [n for n in sa if not torch.equal(sa[n], sb[n])]
    same_out = all(np.array_equal(x, y) for u, w in zip(a, b)
                   for x, y in zip(u, w))
    log(f'{what}: plain and fused, {steps} steps from the same values under '
        f'cuDNN\'s deterministic algorithms [{card}]: losses '
        f'{[float(u[0]) for u in a]} and {[float(u[0]) for u in b]}; '
        f'fetches bit for bit {same_out}; {len(sa) - len(differ)} of '
        f'{len(sa)} persistables bit for bit')
    if differ or not same_out:
        raise AssertionError(f'{what}: the fused run differs from the plain '
                             f'one in {differ[:5]} (of {len(differ)})')


def fused_timed(runs, name, feed, loss, card, what, frees=True, steps=None):
    """WARMUP_STEPS + ``steps`` (TRAIN_STEPS) synchronised steps of run
    ``name``, one more with the env high-water watched, and a profiled
    one; the losses must fall over TRAIN_STEPS. Returns a dict of its
    numbers."""
    import torch
    steps = TRAIN_STEPS if steps is None else steps
    exe, scope, prog, bs, patch = runs.start(name, frees)
    if patch is not None:
        patch.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for _ in range(WARMUP_STEPS + steps):
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
        peak = torch.cuda.max_memory_allocated()
        exe._watch_env = True
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        exe._watch_env = False
        env_hw = exe._env_high_water(runs.main, bs)
        timed_s = secs[WARMUP_STEPS:]
        p50 = statistics.median(timed_s) * 1e3
        prof = profile_train_step(
            lambda: exe.run(prog, feed=feed, fetch_list=[loss], scope=scope),
            (), p50, card, STATIC_STEP_GROUPS, what=f'{what} step ({name})')
    finally:
        if patch is not None:
            patch.stop()
    if not all(np.isfinite(losses)) or (steps == TRAIN_STEPS
                                        and not losses[-1] < losses[0]):
        raise AssertionError(f'{what} ({name}) losses {losses}: not finite '
                             f'or not falling')
    if exe.lowering_count(runs.main) != 1:
        raise AssertionError(f'{what} ({name}): lowered '
                             f'{exe.lowering_count(runs.main)} times')
    busy = None if prof is None else prof[0]
    kernels, copies = (None, None) if prof is None else launches_of(prof[1])
    return {'losses': losses, 'p50': p50, 'min': min(timed_s) * 1e3,
            'max': max(timed_s) * 1e3, 'peak': peak, 'env_hw': env_hw,
            'busy': busy, 'idle': None if busy is None else 1 - busy / p50,
            'kernels': kernels, 'copies': copies}


def fmt_run(r):
    idle = 'not measured' if r['idle'] is None else f'{r["idle"]:.3f}'
    busy = 'not measured' if r['busy'] is None else f'{r["busy"]:.3f} ms'
    return (f'step p50 {r["p50"]:.3f} ms (min {r["min"]:.3f}, max '
            f'{r["max"]:.3f}), busy {busy}, idle {idle}, launches a step '
            f'{r["kernels"]} kernels + {r["copies"]} copies and fills, peak '
            f'{r["peak"]} bytes, env high-water {r["env_hw"]} bytes')


def fused_resnet(fluid, static_resnet, seed, card):
    """Phase 15 (a)-(c) on the static ResNet-50 recipe. Returns a summary."""
    import torch
    from paddle_tpu_torch import ir
    with fluid.unique_name.guard():
        main, startup, _, v = static_resnet.build(fluid)
    loss = v['loss'].name
    before = len(main.global_block().ops)
    if before != SRESNET_OPS:
        raise AssertionError(f'the train program has {before} ops')
    opt, ctx = ir.apply_pipeline(main, [loss],
                                 build_strategy=fused_strategy(fluid, True)[0])
    after = len(opt.global_block().ops)
    log(f'static ResNet-50 through the IR passes: {before} ops a step '
        f'before, {after} after (the loss fetched); {ctx.stats}')
    gpu, s0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=s0)
    host = {x.name: s0.find(x.name).cpu().numpy() for x in main.list_vars()
            if x.persistable}
    del s0
    runs = FusedRuns(fluid, main, loss, host)
    rng = np.random.default_rng(seed)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    what = 'static ResNet-50 fused and in place'
    # (a) the same bits
    fused_bitwise(runs, feed, [loss], FUSED_BITWISE_STEPS, what, card)
    torch.cuda.empty_cache()
    # (b) timed, each run from the same values on the same batch
    got = {name: fused_timed(runs, name, feed, loss, card, what)
           for name in FUSED_RUNS}
    # (c) the plain run with a plan that frees nothing
    got['unfreed'] = fused_timed(runs, 'plain', feed, loss, card, what,
                                 frees=False, steps=1)
    a, b = got['plain']['losses'], got['fused']['losses']
    first = abs(a[0] - b[0]) / abs(a[0])
    worst = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    for name, r in got.items():
        log(f'{what}, {name} [{card}]: losses '
            + ' '.join(repr(x) for x in r['losses']))
    log(f'{what} [{card}]: batch {RESNET_BATCH}, {WARMUP_STEPS} + '
        f'{TRAIN_STEPS} steps each, default cuDNN algorithms; the first '
        f'step\'s loss relative |fused - plain| {first:.3e} (bound '
        f'{SRESNET_RTOL}, phase 11\'s card against the CPU), the largest '
        f'over the steps {worst:.3e} (the trajectories part as phase 14 '
        f'(c) saw); ' + '; '.join(f'{name}: {fmt_run(r)}'
                                  for name, r in got.items()))
    if first > SRESNET_RTOL:
        raise AssertionError(f'{what}: the first step\'s losses differ by '
                             f'{first:.3e}')
    return (f'ResNet-50 ops {before} -> {after}, launches '
            f'{got["plain"]["kernels"]} -> {got["fused"]["kernels"]}, p50 '
            f'{got["plain"]["p50"]:.3f} -> {got["fused"]["p50"]:.3f} ms, '
            f'peak {got["unfreed"]["peak"]} (frees nothing) / '
            f'{got["plain"]["peak"]} -> {got["fused"]["peak"]} bytes, env '
            f'high-water {got["unfreed"]["env_hw"]} / {got["plain"]["env_hw"]}'
            f' -> {got["fused"]["env_hw"]} bytes')


def fused_lenet(fluid, seed, card):
    """Phase 15 (d): the static LeNet with Adam, fuse_all_optimizer_ops
    and in-place state against the plain run: the same bits over
    FUSED_BITWISE_STEPS steps, and the launches a step. Returns a
    summary."""
    main, startup, loss, _ = lenet_programs()
    gpu, s0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=s0)
    host = {x.name: s0.find(x.name).cpu().numpy() for x in main.list_vars()
            if x.persistable}
    runs = FusedRuns(fluid, main, loss.name, host)
    rng = np.random.default_rng(seed)
    feed = {'img': rng.random((LENET_BATCH, 1, 28, 28), dtype=np.float32),
            'label': rng.integers(0, 10, (LENET_BATCH, 1))}
    what = 'LeNet with Adam fused and in place'
    fused_bitwise(runs, feed, [loss.name], FUSED_BITWISE_STEPS, what, card)
    got = {name: fused_timed(runs, name, feed, loss.name, card, what)
           for name in FUSED_RUNS}
    log(f'{what} [{card}]: batch {LENET_BATCH}; ' + '; '.join(
        f'{name}: {fmt_run(r)}' for name, r in got.items())
        + f' (ROADMAP A.3(b) counted {LENET_ADAM_LAUNCHES} launches a step)')
    return (f'LeNet Adam launches {got["plain"]["kernels"]} -> '
            f'{got["fused"]["kernels"]}, p50 {got["plain"]["p50"]:.3f} -> '
            f'{got["fused"]["p50"]:.3f} ms')


def train_fused_inplace(seed, card):
    """Phase 15: the IR passes and in-place state. Returns the kernels'
    launch counts over the phase (none of the port's kernels is on this
    path)."""
    import os
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import static_resnet
    nn_ops.reset_launch_counts()
    fluid.seed(seed)
    passes = os.environ.get('PADDLE_TPU_PASSES')
    try:
        done = [fused_resnet(fluid, static_resnet, seed, card)]
        torch.cuda.empty_cache()
        done.append(fused_lenet(fluid, seed, card))
    finally:
        if passes is None:
            os.environ.pop('PADDLE_TPU_PASSES', None)
        else:
            os.environ['PADDLE_TPU_PASSES'] = passes
    log(f'IR passes and in-place state [{card}]: ' + '; '.join(done))
    return nn_ops.launch_counts()


# PaddleBook's recognize_digits through the Fluid script surface (ROADMAP
# A.13, tools/recognize_digits.py): build_static_lenet's LeNet at its
# published width, batches of 64, Adam(1e-3), 200 Trainer steps on seeded
# synthetic digits of MNIST's row format (MNIST is not in the repository),
# checkpoints every 50 steps keeping 2, 10 test batches; the Inferencer
# against the test program on the same card within 1e-6 (the same program
# and parameters on one card: equal up to the run-to-run spread, which
# is none for these kernels); the metric's accumulated accuracy against
# the mean of the fetched ones within 1e-12 (the same numbers summed in
# another order, in float64), and WeightedAverage's loss within 200 f32
# unit round-offs of it (it sums the f32 losses in f32, as the JAX
# package's does)
FLUID_STEPS, FLUID_TEST_BATCHES = 200, 10
FLUID_CKPT_INTERVAL, FLUID_CKPT_KEEP = 50, 2
FLUID_INFER_TOL, FLUID_METRIC_TOL = 1e-6, 1e-12
FLUID_FEED_REPEATS = 50


def fluid_steps(run, steps):
    """p50 ms of ``steps`` calls of ``run`` (each synced), after
    WARMUP_STEPS more."""
    import torch
    secs = []
    for _ in range(WARMUP_STEPS + steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs[WARMUP_STEPS:]) * 1e3


def fluid_surface(seed, card):
    """Phase 18: PaddleBook's recognize_digits through
    ``fluid.install_check``, ``contrib.Trainer``, ``DataFeeder``,
    ``fluid.metrics``, ``fluid.average`` and ``contrib.Inferencer``, then
    the same LeNet through a plain ``Executor.run`` loop, the
    ``FLAGS_check_nan_inf`` scan and the introspection tools. Returns the
    kernels' launch counts over the phase (none of the port's kernels is
    on this path)."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.tools import recognize_digits as book
    t_start = time.perf_counter()
    nn_ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the install check, on the card by default
    t0 = time.perf_counter()
    fluid.install_check.run_check()
    log(f'(a) fluid.install_check.run_check() on the card in '
        f'{time.perf_counter() - t0:.3f} s [{card}]: '
        + fluid.debugging.device_report().replace('\n', '; '))

    # (b) the Trainer, its metrics and checkpoints, test, save, Inferencer
    fluid.seed(seed)
    accuracy = fluid.metrics.Accuracy()
    average = fluid.average.WeightedAverage()
    losses, accs, ends = [], [], []

    def handler(event):
        if isinstance(event, fluid.contrib.EndStepEvent):
            ends.append(time.perf_counter())
            loss, acc = event.metrics
            losses.append(float(loss))
            accs.append(float(acc))
            accuracy.update(acc, book.BATCH)
            average.add(loss, book.BATCH)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'checkpoints')
        os.makedirs(ckpt)
        trainer = fluid.contrib.Trainer(
            train_func=lambda: book.train_program(fluid),
            optimizer_func=lambda: book.optimizer_func(fluid),
            place=fluid.CUDAPlace(0),
            checkpoint_config=fluid.contrib.CheckpointConfig(
                checkpoint_dir=ckpt, step_interval=FLUID_CKPT_INTERVAL,
                max_num_checkpoints=FLUID_CKPT_KEEP))
        t0 = time.perf_counter()
        trainer.train(num_epochs=1, event_handler=handler,
                      reader=book.mnist_reader(seed, FLUID_STEPS),
                      feed_order=book.FEED_ORDER)
        train_s = time.perf_counter() - t0
        kept = sorted(os.listdir(ckpt))
        if len(losses) != FLUID_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f'Trainer: {len(losses)} steps, losses '
                                 f'{losses[:3]} ... {losses[-3:]}')
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        if not last < first:
            raise AssertionError(f'Trainer loss did not fall: mean of the '
                                 f'first 10 steps {first}, last 10 {last}')
        metric_gap = abs(accuracy.eval() - np.mean(accs))
        loss_gap = abs(average.eval() - np.mean(losses))
        if (metric_gap > FLUID_METRIC_TOL or loss_gap
                > FLUID_STEPS * 2.0 ** -24 * abs(np.mean(losses))):
            raise AssertionError(f'fluid.metrics.Accuracy {accuracy.eval()!r}'
                                 f' or WeightedAverage {average.eval()!r} '
                                 f'against the fetched means: gaps '
                                 f'{metric_gap:.3e}, {loss_gap:.3e}')
        if len(kept) != FLUID_CKPT_KEEP:
            raise AssertionError(f'checkpoints left: {kept}')
        gaps = np.diff(ends)[WARMUP_STEPS:] * 1e3
        trainer_p50 = float(np.median(gaps))
        log(f'(b) contrib.Trainer, recognize_digits conv net (LeNet, '
            f'431080 parameters), batch {book.BATCH}, Adam '
            f'{book.LEARNING_RATE}, {FLUID_STEPS} steps on the card in '
            f'{train_s:.3f} s [{card}]: loss {losses[0]!r} -> '
            f'{losses[-1]!r} (mean of the first 10 {first:.4f}, last 10 '
            f'{last:.4f}), train accuracy of the last 10 '
            f'{np.mean(accs[-10:]):.4f}; step p50 {trainer_p50:.3f} ms '
            f'(between EndStepEvents, after {WARMUP_STEPS}; max '
            f'{gaps.max():.3f} ms with a checkpoint); fluid.metrics.Accuracy '
            f'{accuracy.eval()!r} against the mean fetched accuracy '
            f'{np.mean(accs)!r} (|diff| {metric_gap:.3e}), '
            f'WeightedAverage loss {average.eval()!r} (|diff| '
            f'{loss_gap:.3e}); checkpoints every {FLUID_CKPT_INTERVAL} steps '
            f'and at the epoch\'s end, {kept} left of '
            f'{FLUID_STEPS // FLUID_CKPT_INTERVAL + 1}')
        trainer.checkpoint_cfg = None

        t0 = time.perf_counter()
        test = trainer.test(book.mnist_reader(seed + 1, FLUID_TEST_BATCHES),
                            book.FEED_ORDER)
        log(f'(b) Trainer.test over {FLUID_TEST_BATCHES} batches in '
            f'{time.perf_counter() - t0:.3f} s [{card}]: loss '
            f'{float(test[0])!r}, accuracy {float(test[1])!r}')
        params, model = os.path.join(tmp, 'params'), os.path.join(tmp,
                                                                  'model')
        trainer.save_params(params)
        trainer.save_inference_model(model, book.FEED_ORDER, [0, 1])
        rows = next(book.mnist_reader(seed + 2, 1)())
        block = trainer.train_program.global_block()
        feeder = fluid.DataFeeder([block.var(n) for n in book.FEED_ORDER],
                                  place=fluid.CUDAPlace(0))
        feed = feeder.feed(rows)
        inferencer = fluid.contrib.Inferencer(
            infer_func=lambda: book.inference_program(fluid),
            param_path=params, place=fluid.CUDAPlace(0))
        got, = inferencer.infer({'img': feed['img']})
        test_program = trainer.train_program.clone(for_test=True)
        softmax = [op for op in test_program.global_block().ops
                   if op.type == 'softmax'][0].output_names()[0]
        want, = trainer.exe.run(test_program, feed=feed,
                                fetch_list=[softmax], scope=trainer.scope)
        infer_err = float(np.abs(got - want).max())
        if got.shape != (book.BATCH, 10) or not infer_err <= FLUID_INFER_TOL:
            raise AssertionError(f'Inferencer {got.shape} against the test '
                                 f'program: max|diff| {infer_err:.3e}')
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(fluid.Scope()):
            program, feeds, fetches = fluid.load_inference_model(model, exe)
            saved = exe.run(program, feed=feed, fetch_list=fetches)
        direct = trainer.exe.run(test_program, feed=feed,
                                 fetch_list=trainer.train_func_outputs,
                                 scope=trainer.scope)
        saved_err = max(float(np.abs(a - b).max())
                        for a, b in zip(saved, direct))
        if feeds != book.FEED_ORDER or not saved_err <= FLUID_INFER_TOL:
            raise AssertionError(f'saved inference model {feeds}: max|diff| '
                                 f'{saved_err:.3e}')
        log(f'(b) contrib.Inferencer from save_params against the test '
            f'program on the same batch [{card}]: max|diff| '
            f'{infer_err:.3e} (limit {FLUID_INFER_TOL}); '
            f'save_inference_model reloaded: loss and accuracy max|diff| '
            f'{saved_err:.3e}; argmax agrees on '
            f'{int((got.argmax(1) == want.argmax(1)).sum())}/{book.BATCH}')

    # (c) the same LeNet through a plain Executor.run loop on one
    # pre-stacked batch, against the Trainer's loop over rows held in
    # memory, in turns (plain, Trainer, Trainer, plain); the reader's and
    # DataFeeder's host cost a batch
    main, startup, loss, acc = lenet_programs()
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    stacked = {k: np.ascontiguousarray(v) for k, v in feed.items()}

    def plain_step():
        return gpu.run(main, feed=stacked, fetch_list=[loss, acc],
                       scope=gscope)

    held = list(book.mnist_reader(seed + 3, WARMUP_STEPS + TRAIN_STEPS)())

    def trainer_loop():
        marks = []
        trainer.train(1, lambda e: marks.append(time.perf_counter())
                      if isinstance(e, fluid.contrib.EndStepEvent) else None,
                      reader=lambda: iter(held), feed_order=book.FEED_ORDER)
        return statistics.median(np.diff(marks)[WARMUP_STEPS - 1:]) * 1e3

    turns = {'plain': [], 'trainer': []}
    for what in ('plain', 'trainer', 'trainer', 'plain'):
        turns[what].append(fluid_steps(plain_step, TRAIN_STEPS)
                           if what == 'plain' else trainer_loop())
    plain_p50 = statistics.median(turns['plain'])
    loop_p50 = statistics.median(turns['trainer'])
    read_ms, feed_ms = [], []
    batches = book.mnist_reader(seed + 4, FLUID_FEED_REPEATS)()
    for _ in range(FLUID_FEED_REPEATS):
        t0 = time.perf_counter()
        batch_rows = next(batches)
        t1 = time.perf_counter()
        feeder.feed(batch_rows)
        read_ms.append((t1 - t0) * 1e3)
        feed_ms.append((time.perf_counter() - t1) * 1e3)
    log(f'(c) step p50 in turns (plain, Trainer, Trainer, plain), '
        f'{TRAIN_STEPS} steps each: plain Executor.run on pre-stacked numpy '
        f'feeds {turns["plain"][0]:.3f}, {turns["plain"][1]:.3f} ms; '
        f'contrib.Trainer over rows held in memory '
        f'{turns["trainer"][0]:.3f}, {turns["trainer"][1]:.3f} ms [{card}]; '
        f'on the host a batch of {book.BATCH} rows: the synthetic reader '
        f'p50 {statistics.median(read_ms):.3f} ms, DataFeeder.feed p50 '
        f'{statistics.median(feed_ms):.3f} ms')
    profile_train_step(plain_step, (), plain_p50, card, STATIC_STEP_GROUPS,
                       what='(c) plain Executor.run LeNet step')
    one_batch = held[:1]
    profile_train_step(
        lambda: trainer.train(1, lambda e: None,
                              reader=lambda: iter(one_batch),
                              feed_order=book.FEED_ORDER),
        (), loop_p50, card, STATIC_STEP_GROUPS,
        what='(c) contrib.Trainer step (train over one held batch)')

    # (d) FLAGS_check_nan_inf: the fetch scan's cost in turns (off, on,
    # on, off), then a NaN pixel
    scan = {False: [], True: []}
    try:
        for on in (False, True, True, False):
            fluid.debugging.enable_check_nan_inf(on)
            scan[on].append(fluid_steps(plain_step, TRAIN_STEPS))
        fluid.debugging.enable_check_nan_inf()
        bad = dict(stacked, img=stacked['img'].copy())
        bad['img'][0, 0, 0, 0] = np.nan
        try:
            gpu.run(main, feed=bad, fetch_list=[loss, acc], scope=gscope)
        except FloatingPointError as e:
            caught = str(e)
        else:
            raise AssertionError('a NaN pixel with FLAGS_check_nan_inf on '
                                 'did not raise')
    finally:
        fluid.debugging.enable_check_nan_inf(False)
    if repr(loss.name) not in caught:
        raise AssertionError(f'the NaN error does not name {loss.name}: '
                             f'{caught}')
    log(f'(d) FLAGS_check_nan_inf, plain step p50 in turns (off, on, on, '
        f'off): {scan[False][0]:.3f}, {scan[True][0]:.3f}, '
        f'{scan[True][1]:.3f}, {scan[False][1]:.3f} ms [{card}]; a NaN pixel '
        f'raised FloatingPointError: ' + caught.replace('\n', ' '))

    # (e) the introspection tools
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        _, n_params, flops = fluid.contrib.summary(trainer.train_program)
    log(f'(e) contrib.summary of the Trainer\'s program [{card}]:\n'
        + table.getvalue().rstrip())
    uni, adj = fluid.contrib.op_freq_statistic(trainer.train_program)
    lower, upper, unit = fluid.contrib.memory_usage(trainer.train_program,
                                                    book.BATCH)
    stats = fluid.contrib.device_memory_stats()
    peak = torch.cuda.max_memory_allocated()
    mine = stats[str(torch.device('cuda', torch.cuda.current_device()))]
    if mine['peak_bytes_in_use'] != peak:
        raise AssertionError(f'device_memory_stats peak '
                             f'{mine["peak_bytes_in_use"]} != '
                             f'max_memory_allocated {peak}')
    log(f'(e) contrib.summary: {n_params} parameters, {flops} FLOPs an '
        f'image (the ops it counts); op_freq_statistic top ops '
        f'{list(uni.items())[:5]}, pairs {list(adj.items())[:3]}; '
        f'memory_usage(program, {book.BATCH}) {lower:.3f}-{upper:.3f} '
        f'{unit}; device_memory_stats peak {mine["peak_bytes_in_use"]} '
        f'bytes = torch.cuda.max_memory_allocated() {peak} of '
        f'{mine["bytes_limit"]} [{card}]')
    log(f'phase 18 in {time.perf_counter() - t_start:.1f} s [{card}]')
    return nn_ops.launch_counts()


# Phase 19: the stateless serving path (ROADMAP A.7b) with the
# observability core (A.11): PaddleCV's ResNet-50 inference model as
# tools/static_resnet.py builds it (full width, 1000 classes, 224^2, NCHW,
# f32 weights from the seed, no training), saved with
# save_inference_model, behind InferenceEngine(max_batch_size=32) (ladder
# 1-32), MicroBatcher(batch_timeout_ms=2) and ServingServer on port 0. A
# row's output is its softmax over 1000 classes; a row served in any
# bucket is held to the same row run alone at STATELESS_ROW_TOL (f32: the
# same products summed in another order where cuDNN picks another
# algorithm for another batch size), and the result says whether it was
# bit for bit. (b) runs SERVE_REQUESTS one-row requests from SERVE_CLIENTS
# closed-loop client threads, rows drawn from a pool of SERVE_POOL seeded
# images; (c) sends HTTP_CLIENTS x HTTP_EACH of them as JSON.
STATELESS_MAX_BATCH, STATELESS_TIMEOUT_MS = 32, 2
STATELESS_ROW_TOL = 1e-5
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_POOL = 64, 2048, 256
SERVE_PROFILED = 256
HTTP_CLIENTS, HTTP_EACH = 8, 8
PREDICT_RUNS = 20


def stateless_model(seed, card):
    """The saved ResNet-50 inference model's directory (a temporary one,
    the caller removes it) and its parameter count."""
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import static_resnet
    fluid.seed(seed)
    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, _, v = static_resnet.build(fluid)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != SRESNET_PARAMS:
        raise AssertionError(f'ResNet-50 has {n_params} parameters')
    tmp = tempfile.mkdtemp(prefix='smoke-stateless-')
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(tmp, ['image'], [v['prob']], exe,
                                      main_program=main)
    log(f'19 (a) ResNet-50 inference model [{card}]: {n_params} parameters, '
        f'1000 classes, 224^2, weights from seed {seed}; built, initialised '
        f'on the card and saved in {time.perf_counter() - t0:.1f} s')
    return tmp


def counted(engine):
    """Wrap ``engine.run_batch`` to record each batch's rows (the batches
    the batcher ran); returns the list it appends to."""
    batches = []
    run = engine.run_batch

    def run_batch(feed, nrows=None):
        out = run(feed, nrows)
        batches.append(len(out[0]))
        return out

    engine.run_batch = run_batch
    return batches


def row_diffs(got, want):
    """(max |diff|, rows bit for bit) over paired output rows."""
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    same = sum(bool(np.array_equal(g, w)) for g, w in zip(got, want))
    return err, same


def stateless_engine_alone(engine, pred, rng, card, what):
    """(a): each rung's first-run seconds; at each rung (and two counts
    between rungs) a seeded batch against Predictor.run on the same rows
    and against each row run alone; Predictor.run at the top rung alone:
    images/s and its p50. Returns the largest row-alone |diff|."""
    import torch
    warm = engine.warmup()
    log(f'19 (a) {what} warmup, first-run seconds by rung [{card}]: '
        + ', '.join(f'{b}: {s:.3f}' for b, s in warm.items()))
    worst, all_same, lines = 0.0, True, []
    # two counts between rungs, padded: 3 and 20 (of 32)
    for n in engine.buckets + [3, STATELESS_MAX_BATCH * 5 // 8]:
        x = rng.standard_normal((n, 3, RESNET_IMG, RESNET_IMG),
                                dtype=np.float32)
        got = engine.run_batch({'image': x}, n)[0]
        if got.shape != (n, RESNET_CLASSES) or not np.isfinite(got).all():
            raise AssertionError(f'{what}: rung {n} output {got.shape}')
        p_err, p_same = row_diffs(got, pred.run([x])[0])
        alone = [engine.run_batch({'image': x[i:i + 1]}, 1)[0][0]
                 for i in range(n)]
        a_err, a_same = row_diffs(got, alone)
        worst = max(worst, a_err, p_err)
        all_same &= a_same == n and p_same == n
        lines.append(f'{n} rows (bucket {engine.bucket_for(n)}): '
                     f'Predictor {p_err:.3e} ({p_same}/{n} bitwise), '
                     f'alone {a_err:.3e} ({a_same}/{n} bitwise)')
        if max(a_err, p_err) > STATELESS_ROW_TOL:
            raise AssertionError(f'{what}: {lines[-1]} beyond '
                                 f'{STATELESS_ROW_TOL}')
    log(f'19 (a) {what} rows against Predictor.run on the same rows and '
        f'against each row alone, max |diff| [{card}]: ' + '; '.join(lines))
    agree = ('bit for bit equal to' if all_same
             else f'within {STATELESS_ROW_TOL} of')
    log(f'19 (a) {what}: every row {agree} its Predictor and single-row '
        f'values across the ladder')
    x = rng.standard_normal((STATELESS_MAX_BATCH, 3, RESNET_IMG,
                             RESNET_IMG), dtype=np.float32)
    secs = []
    for _ in range(WARMUP_STEPS + PREDICT_RUNS):
        t0 = time.perf_counter()
        pred.run([x])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    p50 = statistics.median(secs[WARMUP_STEPS:])
    log(f'19 (a) {what} Predictor.run at batch {STATELESS_MAX_BATCH} alone, '
        f'the engine\'s ceiling [{card}]: p50 {p50 * 1e3:.3f} ms = '
        f'{STATELESS_MAX_BATCH / p50:.1f} images/s')
    return {'worst': worst, 'bitwise': all_same, 'ceiling': (
        STATELESS_MAX_BATCH / p50), 'predict_p50_ms': p50 * 1e3}


def closed_loop(send, n_requests, n_clients, n_rows):
    """``n_clients`` threads, each sending one request after another until
    ``n_requests`` went out: request i is ``send(i, i % n_rows)``. Returns
    (wall seconds, each request's seconds, each request's output)."""
    lat, outs = [None] * n_requests, [None] * n_requests
    ticket = itertools.count()

    def client():
        while True:
            i = next(ticket)
            if i >= n_requests:
                return
            t0 = time.perf_counter()
            outs[i] = send(i, i % n_rows)
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or None in lat:
        raise AssertionError('a client did not finish')
    return wall, lat, outs


def stateless_batcher(engine, pool, ref, card, what, tol):
    """(b): the closed loop through a MicroBatcher, then a profiled window
    of SERVE_PROFILED requests. Every output row against its pool row run
    alone (``ref``) within ``tol``."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.serving import MicroBatcher
    observability.reset()
    batches = counted(engine)
    with MicroBatcher(engine, batch_timeout_ms=STATELESS_TIMEOUT_MS,
                      queue_depth=4 * SERVE_CLIENTS) as batcher:
        def send(i, r):
            return batcher.predict({'image': pool[r:r + 1]})[0][0]

        wall, lat, outs = closed_loop(send, SERVE_REQUESTS, SERVE_CLIENTS,
                                      len(pool))
        reg = observability.registry
        wait_p50 = reg.histogram('serving_queue_wait_seconds').percentile(50)
        runs = reg.counter('serving_bucket_runs').to_dict()['samples']
        n_batches = len(batches)
        walls = []

        def window():
            t0 = time.perf_counter()
            closed_loop(send, SERVE_PROFILED, SERVE_CLIENTS, len(pool))
            walls.append(time.perf_counter() - t0)

        prof = profiled(window)
    del engine.run_batch                  # the engine's own method again
    err, same = row_diffs(outs, [ref[i % len(pool)]
                                 for i in range(SERVE_REQUESTS)])
    if err > tol:
        raise AssertionError(f'{what}: a batched row is {err:.3e} from its '
                             f'row alone, beyond {tol}')
    if sum(s['value'] for s in runs) != n_batches:
        raise AssertionError(f'{what}: serving_bucket_runs {runs} against '
                             f'{n_batches} batches run')
    rows = collections.Counter(batches[:n_batches])
    padded = sum(engine.bucket_for(n) for n in batches[:n_batches])
    lat_ms = np.asarray(lat) * 1e3
    busy_ms = device_us(prof) / 1e3
    idle = (f'device busy {busy_ms:.3f} ms of {walls[-1] * 1e3:.3f} ms, '
            f'idle share {1 - busy_ms / (walls[-1] * 1e3):.3f}'
            if busy_ms > 0 else 'device busy not measured (the profiler '
            'recorded no device time)')
    log(f'19 (b) {what} MicroBatcher, {SERVE_CLIENTS} closed-loop clients, '
        f'{SERVE_REQUESTS} one-row requests [{card}]: {wall:.3f} s = '
        f'{SERVE_REQUESTS / wall:.1f} images/s; request latency p50 '
        f'{np.percentile(lat_ms, 50):.3f} p99 {np.percentile(lat_ms, 99):.3f}'
        f' ms; queue wait p50 {wait_p50 * 1e3:.3f} ms (last 512); '
        f'{n_batches} batches, rows: {dict(sorted(rows.items()))}; padding '
        f'waste {1 - SERVE_REQUESTS / padded:.4f}; rows against each row '
        f'alone {err:.3e} ({same}/{SERVE_REQUESTS} bit for bit); profiled '
        f'window of {SERVE_PROFILED} requests: {idle}')
    return {'images_per_s': SERVE_REQUESTS / wall, 'outs': outs}


def http_json(port, path, body=None, timeout=600):
    """(status, parsed body) of one request; ``body`` bytes are POSTed."""
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=body,
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        raw, code = e.read().decode(), e.code
    return code, (json.loads(raw) if raw.startswith('{') else raw)


def stateless_http(engine, pool, ref, batched, card, tol):
    """(c): HTTP_CLIENTS x HTTP_EACH one-row POST /predict requests (the
    outputs against (b)'s rows and each row alone), the parse time of the
    same bodies measured apart, one 400, 429 and 504 each on a second
    server with queue_depth=1, then GET /metrics against the client's own
    counts."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.observability import distributed
    from paddle_tpu_torch.serving import ServingServer
    n = HTTP_CLIENTS * HTTP_EACH
    t0 = time.perf_counter()
    bodies = [json.dumps({'inputs': {'image': pool[i:i + 1].tolist()}})
              .encode() for i in range(n)]
    log(f'19 (c) {n} JSON bodies of one 224^2 image, '
        f'{statistics.median(len(b) for b in bodies) / 1e6:.3f} MB each, '
        f'built by the client in {time.perf_counter() - t0:.1f} s')
    # the server's parse of the same bodies, timed apart: json.loads and
    # the engine's validate (np.asarray of the nested lists)
    parse, convert = [], []
    for b in bodies[:16]:
        t0 = time.perf_counter()
        payload = json.loads(b)
        t1 = time.perf_counter()
        engine.validate(payload['inputs'])
        parse.append(t1 - t0)
        convert.append(time.perf_counter() - t1)
    observability.reset()
    batches = counted(engine)
    srv = ServingServer(engine, port=0, max_batch_size=STATELESS_MAX_BATCH,
                        batch_timeout_ms=STATELESS_TIMEOUT_MS,
                        request_timeout=600).start()
    codes = collections.Counter()
    try:
        def send(i, r):
            code, reply = http_json(srv.port, '/predict', bodies[r])
            codes[code] += 1
            if code != 200:
                raise AssertionError(f'(c) request {i}: {code} {reply}')
            return np.asarray(reply['outputs'][engine.get_output_names()[0]],
                              np.float32)[0]

        wall, lat, outs = closed_loop(send, n, HTTP_CLIENTS, n)
        code, reply = http_json(srv.port, '/predict', json.dumps(
            {'inputs': {'image': pool[:1, :, :2, :2].tolist()}}).encode())
        codes[code] += 1
        if code != 400 or reply['error'] != 'InvalidRequest':
            raise AssertionError(f'(c) wrong shape: {code} {reply}')
        # 429 and 504: a second server with a queue of one; the engine is
        # held while request A runs, B (timeout 1 ms) waits in the queue
        # and C finds it full; B's deadline passes before the release
        srv2 = ServingServer(engine, port=0, batch_timeout_ms=0,
                             queue_depth=1, request_timeout=600).start()
        try:
            replies = {}

            def post2(key, body):
                replies[key] = http_json(srv2.port, '/predict', body)

            timed_out = json.dumps({'inputs': {'image': pool[1:2].tolist()},
                                    'timeout_ms': 1}).encode()
            with engine._lock:
                a = threading.Thread(target=post2, args=('A', bodies[0]))
                a.start()
                while srv2.batcher.pending() or not a.is_alive():
                    time.sleep(0.001)
                time.sleep(0.2)              # A's parse, then the worker
                b = threading.Thread(target=post2, args=('B', timed_out))
                b.start()
                deadline = time.monotonic() + 60
                while srv2.batcher.pending() != 1:
                    if time.monotonic() > deadline:
                        raise AssertionError('(c) B never queued')
                    time.sleep(0.001)
                post2('C', bodies[2])
                time.sleep(0.01)
            a.join(600)
            b.join(600)
        finally:
            srv2.shutdown()
        got = {k: replies[k][0] for k in 'ABC'}
        if got != {'A': 200, 'B': 504, 'C': 429}:
            raise AssertionError(f'(c) 429/504 sequence: {replies}')
        codes.update(got.values())
        with urllib.request.urlopen(
                f'http://127.0.0.1:{srv.port}/metrics', timeout=60) as r:
            fams = distributed.parse_prometheus_text(r.read().decode())
        n_batches = len(batches)
    finally:
        srv.shutdown()
        del engine.run_batch

    def count(name):
        fam = fams.get('paddle_tpu_' + name)
        return sum(v for _, _, v in fam['samples']) if fam else 0

    want = {'serving_requests_completed': codes[200],
            'serving_requests_rejected_invalid': codes[400],
            'serving_requests_rejected_overload': codes[429],
            'serving_requests_deadline_missed': codes[504],
            'serving_requests_failed': 0,
            'serving_bucket_runs': n_batches}
    seen = {k: count(k) for k in want}
    if seen != want:
        raise AssertionError(f'(c) /metrics {seen} against the client\'s '
                             f'{want}')
    err, same = row_diffs(outs, [ref[i] for i in range(n)])
    b_err, b_same = row_diffs(outs, batched[:n])
    if max(err, b_err) > tol:
        raise AssertionError(f'(c) HTTP rows {err:.3e} / {b_err:.3e} from '
                             f'the rows alone / (b), beyond {tol}')
    compute = fams['paddle_tpu_serving_compute_seconds']['samples']
    c_sum = sum(v for s, _, v in compute if s.endswith('_sum'))
    c_n = sum(v for s, _, v in compute if s.endswith('_count'))
    lat_ms = np.asarray(lat) * 1e3
    log(f'19 (c) HTTP POST /predict, {HTTP_CLIENTS} clients x {HTTP_EACH} '
        f'one-row requests [{card}]: {wall:.3f} s = {n / wall:.1f} '
        f'images/s; latency p50 {np.percentile(lat_ms, 50):.3f} p99 '
        f'{np.percentile(lat_ms, 99):.3f} ms; the server\'s parse of one '
        f'body, timed apart: json.loads p50 '
        f'{statistics.median(parse) * 1e3:.3f} ms + validate (np.asarray) '
        f'p50 {statistics.median(convert) * 1e3:.3f} ms, against the '
        f'engine\'s compute {c_sum / max(c_n, 1) * 1e3:.3f} ms a batch '
        f'(mean of {int(c_n)} batches); rows against each row alone '
        f'{err:.3e} ({same}/{n} bit for bit) and against (b) {b_err:.3e} '
        f'({b_same}/{n}); 400, 429 and 504 once each; /metrics: {seen}, '
        f'equal to the client\'s counts and the batches run')


def serve_stateless(seed, card):
    """Phase 19 (a)-(c). Returns the kernels' launch counts over it (none
    of the port's kernels is on this path)."""
    import shutil
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.serving import InferenceEngine
    t_start = time.perf_counter()
    nn_ops.reset_launch_counts()
    path = stateless_model(seed, card)
    try:
        rng = np.random.default_rng(seed + 19)
        pool = rng.standard_normal((SERVE_POOL, 3, RESNET_IMG, RESNET_IMG),
                                   dtype=np.float32)
        batched = None
        for what, cfg in (('f32', inference.Config(path)),
                          ('bf16', inference.Config(path).enable_bf16())):
            exe = fluid.Executor(fluid.CUDAPlace(0))
            engine = InferenceEngine(cfg, executor=exe,
                                     max_batch_size=STATELESS_MAX_BATCH)
            pred = inference.Predictor(cfg, fluid.Executor(
                fluid.CUDAPlace(0)))
            alone = stateless_engine_alone(engine, pred, rng, card, what)
            ref = [engine.run_batch({'image': pool[i:i + 1]}, 1)[0][0]
                   for i in range(SERVE_POOL)]
            tol = STATELESS_ROW_TOL
            out = stateless_batcher(engine, pool, ref, card, what, tol)
            log(f'19 (b) {what}: {out["images_per_s"]:.1f} images/s = '
                f'{out["images_per_s"] / alone["ceiling"]:.3f} of (a)\'s '
                f'ceiling {alone["ceiling"]:.1f} images/s')
            if what == 'f32':
                batched = [out['outs'][i] for i in range(SERVE_POOL)]
                stateless_http(engine, pool, ref, batched, card, tol)
            del engine, pred
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    launches = nn_ops.launch_counts()
    log(f'phase 19 (a)-(c) in {time.perf_counter() - t_start:.1f} s '
        f'[{card}]; kernel launches {launches}')
    return launches


# Phase 20, the optimizer surface (ROADMAP A.4b): BERT-base pretraining with
# LAMB (LayerNorm parameters and biases excluded from weight decay, as the
# LAMB paper trains BERT) at phase 5's configuration, with and without
# remat, a resume in the middle of a gradient merge, PaddleCV's static
# ResNet-50 with the LARS recipe fused and plain, and each other rule's
# multi-tensor update at BERT-base's parameter set against its
# per-parameter op. Tolerances: (b) the first step's gradients with remat
# against those without, each tensor's max |diff| within 1e-3 of its
# largest entry (the same kernels on the same inputs; bit for bit unless a
# kernel sums in a nondeterministic order); (d) the fused run's losses
# within phase 11's SRESNET_RTOL of the plain run's, step by step, and the
# fetched rate within 1e-6 of the warm-up's and the decay's; (e) each rule's
# multi-tensor form against its per-parameter op at atol 1e-6 + rtol 1e-5
# (the foreach norms sum in another order than torch.linalg.vector_norm)
LAMB_RATE, LAMB_DECAY, LAMB_EPS = 1e-3, 0.01, 1e-6
REMAT_STEPS, RESUME_CALLS, RESUME_AT, RESUME_ACCUM = 10, 6, 3, 2
REMAT_GRAD_RTOL = 1e-3
# (c): bit for bit where every kernel of the step sums in a fixed order;
# the bounds allow a step that does not (a loss at rtol 1e-4, parameters
# within a tenth of the rate)
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-4
LARS_STEPS_CHECKED, LARS_TIMED_STEPS = 3, 10
# the LARS schedule over a run of 20 steps, as examples/train_resnet_lars.py
# sets it from --steps: warm-up over 2, decay over 20
LARS_RUN_STEPS = 20
RULE_ATOL, RULE_RTOL, RULE_REPS = 1e-6, 1e-5, 5


def bert_base_config():
    """Phase 5's BERT-base: bench.py bench_bert's configuration with the
    fused attention."""
    from paddle_tpu_torch.models.bert import BertConfig
    return BertConfig(attention_probs_dropout_prob=0.0,
                      hidden_dropout_prob=0.0, max_position_embeddings=128,
                      use_fused_attention=True)


def lamb_excluded(model):
    """LAMB's exclusion for BERT: LayerNorm's parameters and the biases."""
    ids = {id(p) for n, p in model.named_parameters()
           if '_ln.' in n or n.endswith('bias')}
    return lambda p: id(p) in ids


def bert_lamb(sd, seed, dev, remat=False, accum_steps=1):
    """A BERT-base from ``sd`` and its LAMB TrainStep (bf16 AMP)."""
    import torch
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.bert import (BertForPretraining,
                                              pretrain_loss)
    from paddle_tpu_torch.optimizer import Lamb
    model = BertForPretraining(bert_base_config(), device=dev, seed=seed)
    model.load_state_dict(sd)
    opt = Lamb(LAMB_RATE, lamb_weight_decay=LAMB_DECAY, epsilon=LAMB_EPS,
               exclude_from_weight_decay_fn=lamb_excluded(model),
               parameter_list=list(model.parameters()))
    return model, TrainStep(model, pretrain_loss, opt,
                            amp_dtype=torch.bfloat16, remat=remat,
                            accum_steps=accum_steps)


def bert_batches(cfg, dev, n, seed, batch=128, seq=128):
    """``n`` batches bench.py's way: 15% MLM labels, the rest -1."""
    import torch
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
        tt = np.zeros((batch, seq), np.int64)
        mlm = np.where(rng.rand(batch, seq) < 0.15,
                       rng.randint(0, cfg.vocab_size, (batch, seq)),
                       -1).astype(np.int64)
        nsp = rng.randint(0, 2, (batch, 1)).astype(np.int64)
        out.append([torch.from_numpy(a).to(dev)
                    for a in (ids, tt, mlm, nsp)])
    return out


def first_step_grads(sd, seed, dev, feeds, remat):
    """The first call's loss and gradients (a merge of 2 keeps them on
    ``.grad`` without an update), and the flash kernels' launches."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    model, step = bert_lamb(sd, seed, dev, remat=remat, accum_steps=2)
    nn_ops.reset_launch_counts()
    loss = step(*feeds).item()
    torch.cuda.synchronize()
    launches = nn_ops.launch_counts()
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return loss, grads, launches


def timed_lamb(step, feeds, steps, card, what):
    """WARMUP_STEPS + ``steps`` synchronised calls of ``step``: losses,
    p50, seq/s, peak bytes, the flash launches and a profiled step."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nn_ops.reset_launch_counts()
    losses, secs = [], []
    for _ in range(WARMUP_STEPS + steps):
        t0 = time.perf_counter()
        loss = step(*feeds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = nn_ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    seq_s = feeds[0].shape[0] * steps / sum(timed_s)
    prof = profile_train_step(step, feeds, p50, card,
                              {'flash kernels': lambda key: 'flash_' in key,
                               'multi-tensor updates': lambda key:
                               'multi_tensor' in key.lower()}, what=what)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'{what}: losses not finite or not falling: '
                             f'{losses}')
    return {'losses': losses, 'p50': p50, 'seq_s': seq_s, 'peak': peak,
            'launches': launches, 'steps': WARMUP_STEPS + steps,
            'busy': None if prof is None else prof[0]}


def fmt_busy(r):
    if r.get('busy') is None:
        return 'busy not measured'
    idle = 1 - r['busy'] / r['p50']
    return f'busy {r["busy"]:.3f} ms, idle share {idle:.3f}'


def lamb_bert(seed, dev, card):
    """Phase 20 (a)-(c). Returns the flash kernels' launches over (a) and
    (b), as {wrapper: (a)'s, (b)'s}."""
    import torch
    from paddle_tpu_torch.convert import (bert_init_params,
                                          bert_state_dict_from_paddle)
    cfg = bert_base_config()
    layers = cfg.num_hidden_layers
    sd = bert_state_dict_from_paddle(bert_init_params(cfg, seed))
    feeds = bert_batches(cfg, dev, 1, seed)[0]
    # (b)'s gradient check: the first call's gradients from the same
    # weights, batch and generator state, without and with remat
    l0, g0, _ = first_step_grads(sd, seed, dev, feeds, remat=False)
    l1, g1, probe = first_step_grads(sd, seed, dev, feeds, remat=True)
    worst, differ = 0.0, []
    for n in g0:
        d = (g0[n].float() - g1[n].float()).abs().max().item()
        scale = g0[n].float().abs().max().item()
        worst = max(worst, d / scale if scale else d)
        if not torch.equal(g0[n], g1[n]):
            differ.append(n)
    del g0, g1
    torch.cuda.empty_cache()
    log(f'20 (b) the first call\'s loss without and with remat: {l0!r} '
        f'{l1!r}; gradients: {len(sd) - len(differ)}/{len(sd)} tensors bit '
        f'for bit (the others {differ[:4]}), the largest max |diff| '
        f'relative to its tensor\'s largest entry '
        f'{worst:.3e} (bound {REMAT_GRAD_RTOL}); the remat call\'s flash '
        f'launches {probe}')
    if l0 != l1 or worst > REMAT_GRAD_RTOL:
        raise AssertionError(f'(b) remat changes the first step: loss '
                             f'{l0!r} -> {l1!r}, gradients {worst:.3e}')
    # (a) LAMB, and (b) LAMB with remat, from the same weights
    runs = {}
    for name, remat, steps in (('LAMB', False, TRAIN_STEPS),
                               ('LAMB remat', True, REMAT_STEPS)):
        model, step = bert_lamb(sd, seed, dev, remat=remat)
        runs[name] = r = timed_lamb(step, feeds, steps, card,
                                    f'20 BERT-base {name} step')
        others = {k: v for k, v in r['launches'].items()
                  if k not in FLASH_STOCK and v}
        if others:
            raise AssertionError(f'{name}: other kernels launched: {others}')
        per_layer_fwd = 2 if remat else 1
        for kern, per in (('flash_attention_fwd', per_layer_fwd),
                          ('flash_attention_bwd_dkv', 1),
                          ('flash_attention_bwd_dq', 1)):
            want = per * layers * r['steps']
            if r['launches'][kern] != want:
                raise AssertionError(f'{name}: {kern} launched '
                                     f'{r["launches"][kern]} times, not '
                                     f'{per} x {layers} layers x '
                                     f'{r["steps"]} steps')
        log(f'20 ({"b" if remat else "a"}) BERT-base {name} [{card}]: '
            f'losses ' + ' '.join(repr(x) for x in r['losses']))
        del model, step
        torch.cuda.empty_cache()
    a, b = runs['LAMB'], runs['LAMB remat']
    adam = ADAM_RUN
    log(f'20 (a) BERT-base, batch 128 x 128, bf16 AMP, fused attention '
        f'[{card}]: LAMB step p50 {a["p50"]:.3f} ms, {a["seq_s"]:.1f} '
        f'seq/s, {fmt_busy(a)}, peak {a["peak"]} bytes; phase 5\'s Adam '
        f'in this call: p50 {adam["p50"]:.3f} ms, {adam["seq_s"]:.1f} '
        f'seq/s, {fmt_busy(adam)}, peak {adam["peak"]} bytes; flash '
        f'launches {a["launches"]}')
    log(f'20 (b) remat [{card}]: peak {b["peak"]} bytes against (a)\'s '
        f'{a["peak"]} ({b["peak"] / a["peak"]:.3f}x), step p50 '
        f'{b["p50"]:.3f} ms against {a["p50"]:.3f} '
        f'({b["p50"] / a["p50"]:.3f}x), {fmt_busy(b)}; flash launches '
        f'{b["launches"]} (the forward twice a layer a step)')
    if not b['peak'] < a['peak']:
        raise AssertionError(f'(b) remat peak {b["peak"]} not below '
                             f'{a["peak"]}')
    resume_bert(sd, seed, dev, cfg, card)
    return {k: (a['launches'][k], b['launches'][k]) for k in FLASH_STOCK}


def resume_bert(sd, seed, dev, cfg, card):
    """Phase 20 (c): RESUME_CALLS calls with accum_steps=2, snapshotted
    after call RESUME_AT (mid merge) and restored into a fresh model and
    step: calls RESUME_AT + 1 on against the run that never stopped."""
    import torch
    batches = bert_batches(cfg, dev, RESUME_CALLS, seed + 20)
    model, step = bert_lamb(sd, seed, dev, accum_steps=RESUME_ACCUM)
    losses, snap = [], None
    for i, feeds in enumerate(batches):
        losses.append(step(*feeds).item())
        if i + 1 == RESUME_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = step.snapshot()
            torch.cuda.synchronize()
            snap_ms = (time.perf_counter() - t0) * 1e3
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    # the same six calls again from the start: the step's own run-to-run
    # spread, against which the resume's is read
    model, step = bert_lamb(sd, seed, dev, accum_steps=RESUME_ACCUM)
    rerun = [step(*feeds).item() for feeds in batches]
    spread = max((p.detach() - want[n]).abs().max().item()
                 for n, p in model.named_parameters())
    spread_in = [n for n, p in model.named_parameters()
                 if not torch.equal(p.detach(), want[n])]
    del model, step
    torch.cuda.empty_cache()
    arrays, meta = snap
    n_arrays = len(arrays)
    model, step = bert_lamb(sd, seed, dev, accum_steps=RESUME_ACCUM)
    step.set_state(arrays, meta)
    del arrays, snap
    again = [step(*feeds).item() for feeds in batches[RESUME_AT:]]
    diff = max((p.detach() - want[n]).abs().max().item()
               for n, p in model.named_parameters())
    differ = [n for n, p in model.named_parameters()
              if not torch.equal(p.detach(), want[n])]
    bitwise = not differ
    loss_diff = max(abs(x - y) / abs(y)
                    for x, y in zip(again, losses[RESUME_AT:]))
    log(f'20 (c) resume [{card}]: {RESUME_CALLS} calls with accum_steps '
        f'{RESUME_ACCUM}, a snapshot of {n_arrays} tensors after call '
        f'{RESUME_AT} (meta {meta}, {snap_ms:.3f} ms) restored into a '
        f'fresh model; calls {RESUME_AT + 1}-{RESUME_CALLS}: losses '
        f'{again} against the uninterrupted {losses[RESUME_AT:]} '
        f'(relative {loss_diff:.3e}); parameters bit for bit {bitwise}, '
        f'max |diff| {diff:.3e} ({len(differ)} tensors differ: '
        f'{differ[:4]}); the six calls run again from the start: losses '
        f'equal {rerun == losses}, parameters max |diff| {spread:.3e} '
        f'({len(spread_in)} tensors: {spread_in[:4]}; the step\'s own '
        f'run-to-run spread)')
    if loss_diff > RESUME_RTOL or diff > RESUME_ATOL:
        raise AssertionError(f'(c) the resumed run differs: losses {again} '
                             f'against {losses[RESUME_AT:]}, parameters '
                             f'{diff:.3e}')
    del model, step, want
    torch.cuda.empty_cache()


def lars_resnet(seed, card):
    """Phase 20 (d): PaddleCV's static ResNet-50 with the LARS recipe
    (tools/static_resnet.py ``optimizer='lars'``, batch RESNET_BATCH),
    'plain' (a ``lars_momentum`` op a parameter) against 'fused' (the
    fuse passes: one ``fused_lars_momentum`` a group); the rate fetched
    against the warm-up."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import ir
    from paddle_tpu_torch.tools import static_resnet
    with fluid.unique_name.guard():
        main, startup, _, v = static_resnet.build(
            fluid, optimizer='lars', batch_size=RESNET_BATCH,
            lars_steps=LARS_RUN_STEPS)
    loss, lr = v['loss'].name, v['lr'].name
    base, warmup, decay = static_resnet.lars_schedule(RESNET_BATCH,
                                                      LARS_RUN_STEPS)
    n_ops = {}
    for name in FUSED_RUNS:
        opt, ctx = ir.apply_pipeline(
            main, [loss], build_strategy=fused_strategy(fluid,
                                                        name == 'fused')[0])
        ops = [op.type for op in opt.global_block().ops]
        n_ops[name] = (len(ops), ops.count('lars_momentum'),
                       ops.count('fused_lars_momentum'))
    gpu, s0 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=s0)
    host = {x.name: s0.find(x.name).cpu().numpy() for x in main.list_vars()
            if x.persistable}
    del s0
    runs = FusedRuns(fluid, main, loss, host)
    rng = np.random.default_rng(seed + 20)
    feed = {'image': rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_IMG, RESNET_IMG), dtype=np.float32),
        'label': rng.integers(0, RESNET_CLASSES, (RESNET_BATCH, 1))}
    first = {}
    for name in FUSED_RUNS:
        exe, scope, prog, _, _ = runs.start(name)
        out = [exe.run(prog, feed=feed, fetch_list=[loss, lr], scope=scope)
               for _ in range(LARS_STEPS_CHECKED)]
        first[name] = [float(o[0]) for o in out]
        rates = [float(np.asarray(o[1]).reshape(-1)[0]) for o in out]
        want = [base * k / warmup if k < warmup else
                (base - static_resnet.LARS_END_LR)
                * (1 - min(k, decay) / decay) ** static_resnet.LARS_POWER
                + static_resnet.LARS_END_LR
                for k in range(LARS_STEPS_CHECKED)]
        if not np.allclose(rates, want, rtol=1e-6, atol=1e-12):
            raise AssertionError(f'(d) {name}: the rate {rates} does not '
                                 f'follow the warm-up {want}')
        del exe, scope, prog
        torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(a)
                for a, b in zip(first['plain'], first['fused']))
    got = {name: fused_timed(runs, name, feed, loss, card,
                             '20 (d) static ResNet-50 LARS',
                             steps=LARS_TIMED_STEPS)
           for name in FUSED_RUNS}
    for name in FUSED_RUNS:
        r = got[name]
        log(f'20 (d) static ResNet-50 with LARS, {name} [{card}]: '
            f'{n_ops[name][0]} ops a step ({n_ops[name][1]} lars_momentum, '
            f'{n_ops[name][2]} fused_lars_momentum), first '
            f'{LARS_STEPS_CHECKED} losses {first[name]}, then '
            f'{RESNET_BATCH * 1e3 / r["p50"]:.1f} images/s; {fmt_run(r)}')
    log(f'20 (d) [{card}]: the rate fetched over {LARS_STEPS_CHECKED} '
        f'steps follows base {base} x step / {warmup} warm-up steps, then '
        f'the decay over {decay} steps (power '
        f'{static_resnet.LARS_POWER}) within 1e-6; '
        f'fused against plain, the first {LARS_STEPS_CHECKED} losses '
        f'relative {worst:.3e} (bound {SRESNET_RTOL})')
    if worst > SRESNET_RTOL:
        raise AssertionError(f'(d) fused and plain losses differ by '
                             f'{worst:.3e}')


def rule_cases():
    """(name, make optimizer(params), the rule's per-parameter plain
    update (params, grads, lr) -> new params and slots, bytes a
    parameter the update must move)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.extend_optimizer import \
        extend_with_decoupled_weight_decay
    from paddle_tpu_torch.core.random import default_generator
    from paddle_tpu_torch.ops import optimizer_ops as ops
    O = fluid.optimizer

    def op_rule(op, make):
        def plain(opt, params, grads):
            out = []
            for p, g in zip(params, grads):
                slots = opt._new_slots(p)
                args = [p, g] + [slots[s] for s in opt._slot_names]
                if opt._has_lr_input:
                    args.append(opt._learning_rate)
                kw = opt._hypers_for(p)
                if op == 'dpsgd':
                    kw['key'] = default_generator.generator(p.device)
                res = getattr(ops, op)(*args, **kw)
                out.append(res if isinstance(res, tuple) else (res,))
            return out
        return make, plain

    def adamw_plain(opt, params, grads):
        out = []
        coeff = opt._decoupled_wd * opt._learning_rate
        for p, g in zip(params, grads):
            s = opt._new_slots(p)
            out.append(ops._adam_out(p * (1.0 - coeff), g, s['moment1'],
                                     s['moment2'], s['beta1_pow'],
                                     s['beta2_pow'], opt._learning_rate,
                                     **opt._hypers()))
        return out

    def lookahead_plain(opt, params, grads):
        # two Adam steps on the same gradient, k=1: the first pull keeps
        # the weights, the second moves them halfway back
        out = []
        inner = opt.inner_optimizer
        for p, g in zip(params, grads):
            s = inner._new_slots(p)
            p1, m1, m2, b1, b2 = ops._adam_out(
                p, g, s['moment1'], s['moment2'], s['beta1_pow'],
                s['beta2_pow'], inner._learning_rate, **inner._hypers())
            p2 = ops._adam_out(p1, g, m1, m2, b1, b2, inner._learning_rate,
                               **inner._hypers())[0]
            out.append((p1 + opt.alpha * (p2 - p1),))
        return out

    def average_plain(opt, params, grads):
        # two accumulations or updates, the parameters moved by -1e-3 g
        # between them
        out = []
        for p, g in zip(params, grads):
            q = p - 1e-3 * g
            if isinstance(opt, O.ModelAverage):
                out.append((p + (q - p) / 2,))
            else:
                d1, d2 = (min(0.999, (1 + t) / (10 + t)) for t in (1, 2))
                e1 = d1 * p + (1 - d1) * p
                out.append((d2 * e1 + (1 - d2) * q,))
        return out

    def with_params(cls, *a, **kw):
        return lambda params: cls(*a, parameter_list=params, **kw)

    return [
        ('LAMB', *op_rule('lamb', with_params(O.Lamb, 1e-3)), 28),
        ('LARS', *op_rule('lars_momentum',
                          with_params(O.LarsMomentum, 0.1)), 20),
        ('Adamax', *op_rule('adamax', with_params(O.Adamax, 1e-3)), 28),
        ('Adagrad', *op_rule('adagrad', with_params(
            O.Adagrad, 1e-2, initial_accumulator_value=0.1)), 20),
        ('DecayedAdagrad', *op_rule('decayed_adagrad', with_params(
            O.DecayedAdagrad, 1e-2)), 20),
        ('RMSProp', *op_rule('rmsprop', with_params(O.RMSProp, 1e-3)), 28),
        ('RMSProp centered', *op_rule('rmsprop', with_params(
            O.RMSProp, 1e-3, centered=True, momentum=0.9)), 36),
        ('Adadelta', *op_rule('adadelta', with_params(O.Adadelta, 1.0)),
         28),
        ('Ftrl', *op_rule('ftrl', with_params(O.Ftrl, 1e-2, l1=1e-4,
                                              l2=1e-3)), 28),
        ('Dpsgd', *op_rule('dpsgd', with_params(O.Dpsgd, 1e-2, clip=10.0,
                                                batch_size=128.0)), 12),
        ('DGCMomentum', *op_rule('dgc_momentum', with_params(
            O.DGCMomentumOptimizer, 1e-2, sparsity=[0.999])), 28),
        ('AdamW', with_params(extend_with_decoupled_weight_decay(O.Adam),
                              0.01, learning_rate=1e-3), adamw_plain, 28),
        ('Lookahead(Adam)', lambda params: O.LookaheadOptimizer(
            O.Adam(1e-3, parameter_list=params), alpha=0.5, k=1),
         lookahead_plain, 36),
        ('ModelAverage', lambda params: O.ModelAverage(0.15),
         average_plain, 12),
        ('EMA', lambda params: O.ExponentialMovingAverage(0.999),
         average_plain, 12)]


def rule_update(opt, params, grads):
    """One update through the class, as a user calls it: ``minimize`` of
    the parameters with their gradients (for the averages,
    ``accumulate``/``update``, the parameters moved by -1e-3 g, and
    again). Lookahead takes two steps (k=1)."""
    import torch
    import paddle_tpu_torch as fluid
    O = fluid.optimizer
    if isinstance(opt, (O.ModelAverage, O.ExponentialMovingAverage)):
        fold = (opt.accumulate if isinstance(opt, O.ModelAverage)
                else opt.update)
        fold(params)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-3)
        fold(params)
        return
    for p, g in zip(params, grads):
        p.grad = g
    steps = 2 if isinstance(opt, O.LookaheadOptimizer) else 1
    for _ in range(steps):
        opt.minimize(torch.zeros(()), parameter_list=params)


def rule_state(opt, params):
    """What a rule's update wrote, in the plain update's order."""
    import paddle_tpu_torch as fluid
    O = fluid.optimizer
    if isinstance(opt, O.ModelAverage):
        return [(opt._avgs[id(p)],) for p in params]
    if isinstance(opt, O.ExponentialMovingAverage):
        return [(opt._ema[id(p)],) for p in params]
    if isinstance(opt, O.LookaheadOptimizer):
        return [(p.detach(),) for p in params]
    return [(p.detach(), *(opt.slots(p)[s] for s in opt._slot_names))
            for p in params]


def each_rule(seed, dev, card):
    """Phase 20 (e): each rule at BERT-base's parameter set, one seeded
    gradient: the class's update (its multi-tensor form) against the
    per-parameter plain update on the same values, max |diff|; the ms of
    one update of each beside its bound (the bytes it must move a
    parameter x the parameters, at HBM_BYTES_PER_S)."""
    import torch
    from paddle_tpu_torch.convert import bert_expected_shapes
    from paddle_tpu_torch.core.random import default_generator
    shapes = list(bert_expected_shapes(bert_base_config()).values())
    n = sum(int(np.prod(s)) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    start = [torch.randn(s, generator=gen, device=dev) * 0.02
             for s in shapes]
    grads = [torch.randn(s, generator=gen, device=dev) * 1e-3
             for s in shapes]
    log(f'20 (e) the rules at BERT-base\'s parameter set: {len(shapes)} '
        f'tensors, {n} parameters (f32), one seeded gradient')
    for name, make, plain, nbytes in rule_cases():
        params = [torch.nn.Parameter(t.clone()) for t in start]
        opt = make(params)
        rng_state = default_generator.generator(dev).get_state()
        want = plain(opt, [p.detach() for p in params], grads)
        default_generator.generator(dev).set_state(rng_state)
        rule_update(opt, params, grads)
        got = rule_state(opt, params)
        worst = 0.0
        for ws, gs in zip(want, got):
            for w, g in zip(ws, gs):
                d = (g - w).abs() - RULE_ATOL - RULE_RTOL * w.abs()
                worst = max(worst, (g - w).abs().max().item())
                if d.max().item() > 0:
                    raise AssertionError(f'(e) {name}: the multi-tensor '
                                         f'update differs from the plain '
                                         f'one by {worst:.3e}')
        del want, got
        # one update of each on the same values (the state moves): the
        # device's time from the profiler, the host clock's around
        # RULE_REPS synchronised updates
        steps = 2 if 'Lookahead' in name or name in ('ModelAverage',
                                                     'EMA') else 1
        dev_ms = device_us(profiled(
            lambda: rule_update(opt, params, grads))) / 1e3 / steps
        plain_dev_ms = device_us(profiled(
            lambda: plain(opt, [p.detach() for p in params], grads))) / 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RULE_REPS):
            rule_update(opt, params, grads)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / RULE_REPS / steps
        bound = nbytes * n / HBM_BYTES_PER_S * 1e3
        shown = (f'{dev_ms:.3f} ms on the device = {bound / dev_ms:.3f} of '
                 f'the bound' if dev_ms > 0 else 'device time not measured')
        log(f'20 (e) {name} [{card}]: multi-tensor against plain max |diff| '
            f'{worst:.3e}; one update {shown}, {ms:.3f} ms on the host '
            f'clock; the plain per-parameter update {plain_dev_ms:.3f} ms '
            f'on the device; bound {bound:.3f} ms ({nbytes} bytes a '
            f'parameter at {HBM_BYTES_PER_S / 1e12} TB/s)')
        del params, opt
        torch.cuda.empty_cache()


def optimizer_surface(seed, dev, card):
    """Phase 20: (a)-(c) BERT-base with LAMB, (d) static ResNet-50 with
    LARS, (e) each rule. Returns the flash kernels' launches over (a) and
    (b); none of the port's kernels may launch in (d) or (e)."""
    from paddle_tpu_torch.ops import nn_ops
    t_start = time.perf_counter()
    flash = lamb_bert(seed, dev, card)
    nn_ops.reset_launch_counts()
    lars_resnet(seed, card)
    each_rule(seed, dev, card)
    launches = nn_ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f'(d)/(e) launched kernels of the port: '
                             f'{launches}')
    log(f'phase 20 in {time.perf_counter() - t_start:.1f} s [{card}]; (d) '
        f'and (e) kernel launches {launches}')
    return flash


# Phase 21: the rest of the dygraph layers and the vision models (ROADMAP
# A.4c, models/vision.py). The models at full width: MobileNetV2 (scale
# 1.0, 1000 classes, 224^2, batch 128) in bf16 AMP and in f32 through
# PaddleCV's recipe (tools/vision_recipes.py), MobileNetV1 (batch 128) and
# VGG-16 with BatchNorm (batch 64) in bf16, TSM over ResNet-50 (Kinetics-
# 400, 16 clips of 8 frames) in bf16, and the DCGAN (z 100, base 64, batch
# 128 at 32x32) in f32. Each trains on one seeded batch, so its loss must
# fall. The layers and ops of A.4c run on the card against the same port
# code on the CPU, f32 with TF32 off: each element within 1e-5 of itself
# plus 2e-6 for the elementwise ops (the same formula, libraries a few ulps
# apart, cancellations such as GELU's x·(1 + erf) at large negative x a few
# ulps of the input; inputs N(0, 10) with each op's breakpoints placed, N(0,
# 1) for the exponential ones, sinh, cosh, softplus and soft_relu, whose
# outputs at 10 sigma would dwarf any bound), and within 1e-4 of the
# tensor's largest entry for the rest (sums of up to 100,352 f32 products
# in another order, whose small entries are cancellations of large terms),
# and the Conv3D pair on the CPU at the batch's first sample (its output and
# input gradient against the card's first sample, the weight gradient
# against a card run of that sample): the whole batch would take minutes
# on the host.
VISION_BATCH, VISION_IMG, VISION_CLASSES = 128, 224, 1000
VGG_BATCH = 64
MNV2_STEPS, VISION_STEPS = 20, 10
TSM_CLIPS, TSM_SEG, TSM_CLASSES = 16, 8, 400
DCGAN_BATCH, DCGAN_ITERS, DCGAN_Z, DCGAN_BASE = 128, 50, 100, 64
# (of each element, of the tensor's largest entry, absolute): |card - CPU|
# within their sum
A4C_EW_TOL, A4C_SUM_TOL = (1e-5, 0.0, 2e-6), (0.0, 1e-4, 0.0)
A4C_EXP_OPS = ('sinh', 'cosh', 'softplus', 'soft_relu')
CONV3D_SHAPE = (8, 64, 16, 56, 56)
VISION_GROUPS = {
    'depthwise conv': lambda key: 'depthwise' in key.lower(),
    'other conv': lambda key: 'depthwise' not in key.lower() and any(
        t in key.lower() for t in ('conv', 'xmma', 'cudnn', 'dgrad', 'wgrad',
                                   'implicit_gemm', 'nvjet')),
    # every elementwise kernel and every reduction of the step, whatever
    # op launched it: BatchNorm's, the activations', the residual adds',
    # AMP's casts, the loss's. What BatchNorm alone takes is
    # batch_norm_ms's replay
    'elementwise (all)': lambda key: 'elementwise' in key,
    'reductions (all)': lambda key: 'reduce_kernel' in key,
    'the update (_foreach)': lambda key: 'multi_tensor' in key}


def vision_batch(seed, n, classes, dev, frames=1):
    """(n * frames, 3, 224, 224) f32 images and (n, 1) int64 labels drawn
    on the card from ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n * frames, 3, VISION_IMG, VISION_IMG, device=dev,
                    generator=gen)
    y = torch.randint(0, classes, (n, 1), device=dev, generator=gen)
    return x, y


def batch_norm_ms(model, step, feeds):
    """Device ms a step of ``model``'s BatchNorm layers without their act:
    each layer's forward (statistics, normalisation, running averages) and
    backward (to its input, scale and bias), replayed through the
    ``batch_norm`` op on random inputs of the shapes and types that the
    layer saw in one call of ``step``, its running statistics copied."""
    import torch
    from paddle_tpu_torch.dygraph import BatchNorm
    from paddle_tpu_torch.ops.nn_ops import batch_norm
    seen = []

    def grab(layer, inputs):
        seen.append((layer, inputs[0].shape, inputs[0].dtype,
                     layer.weight.dtype))
    hooks = [m.register_forward_pre_hook(grab) for m in model.sublayers()
             if isinstance(m, BatchNorm)]
    step(*feeds)
    for h in hooks:
        h.remove()
    assert seen, 'no BatchNorm layer ran in the step'
    dev = feeds[0].device
    runs = []
    for layer, shape, x_dtype, w_dtype in seen:
        x = torch.randn(shape, device=dev, dtype=x_dtype, requires_grad=True)
        w = torch.ones(shape[1], device=dev, dtype=w_dtype,
                       requires_grad=True)
        b = torch.zeros(shape[1], device=dev, dtype=w_dtype,
                        requires_grad=True)
        runs.append((x, w, b, layer._mean_buf.clone(),
                     layer._variance_buf.clone(), layer._attrs))

    def replay():
        for x, w, b, mean, var, attrs in runs:
            y, new_mean, new_var = batch_norm(x, w, b, mean, var, **attrs)
            with torch.no_grad():
                mean.copy_(new_mean)
                var.copy_(new_var)
            y.backward(x.detach())
    ms = device_us(profiled(replay)) / 1e3
    del runs
    return ms, len(seen)


def train_vision(name, step, feeds, steps, card, rate_unit, per_rate,
                 model):
    """2 warm-up and ``steps`` timed calls of ``step``, each synchronised:
    losses finite and falling, p50/min/max, the rate, peak memory, a
    profiled step by kind and what ``model``'s BatchNorms take of it.
    Returns the summary."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(WARMUP_STEPS + steps):
        t0 = time.perf_counter()
        loss = step(*feeds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    rate = per_rate * steps / sum(timed_s)
    log(f'21 {name} losses: ' + ' '.join(repr(v) for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'{name}: losses not finite or not falling: '
                             f'{losses}')
    log(f'21 {name} [{card}]: {WARMUP_STEPS} + {steps} steps, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}), {rate:.1f} {rate_unit}; peak device '
        f'memory {peak} bytes')
    prof = profile_train_step(step, feeds, p50, card, VISION_GROUPS,
                              what=f'21 {name}')
    assert prof is not None, f'{name}: the profiler recorded no device time'
    bn_ms, n_bn = batch_norm_ms(model, step, feeds)
    log(f'21 {name} BatchNorm alone [{card}]: {bn_ms:.3f} ms of device time '
        f'a step = {bn_ms / prof[0]:.3f} of busy ({n_bn} layers\' forward '
        f'and backward without their act, replayed at the step\'s shapes '
        f'and types)')
    return {'p50': p50, 'rate': rate, 'peak': peak, 'losses': losses,
            'busy': prof[0], 'batch_norm_ms': bn_ms}


def vision_classifiers(seed, dev, card):
    """Phase 21 (a)-(c): MobileNetV2 in bf16 and f32, MobileNetV1 and
    VGG-16-BN in bf16, TSM in bf16."""
    import torch
    from paddle_tpu_torch.models import (TSM, VGG, MobileNetV1,
                                         MobileNetV2)
    from paddle_tpu_torch.ops.tensor_ops import temporal_shift
    from paddle_tpu_torch.tools import vision_recipes as vr
    x, y = vision_batch(seed, VISION_BATCH, VISION_CLASSES, dev)
    for amp in (torch.bfloat16, None):
        model = MobileNetV2(VISION_CLASSES, device=dev, seed=seed)
        if amp is torch.bfloat16:
            log(f'21 (a) MobileNetV2 scale 1.0: '
                f'{sum(p.numel() for p in model.parameters())} parameters')
        step = vr.mobilenet_v2_step(model, VISION_BATCH, amp_dtype=amp)
        train_vision(f'(a) MobileNetV2 {"bf16 AMP" if amp else "f32"}',
                     step, (x, y), MNV2_STEPS, card, 'images/s',
                     VISION_BATCH, model)
        del model, step
        torch.cuda.empty_cache()
    model = MobileNetV1(VISION_CLASSES, device=dev, seed=seed)
    train_vision('(b) MobileNetV1 bf16 AMP', vr.mobilenet_v2_step(
        model, VISION_BATCH, amp_dtype=torch.bfloat16), (x, y),
        VISION_STEPS, card, 'images/s', VISION_BATCH, model)
    del model
    model = VGG(16, VISION_CLASSES, input_size=VISION_IMG, device=dev,
                seed=seed)
    train_vision('(b) VGG-16-BN bf16 AMP', vr.classifier_step(
        model, 0.01, 4e-5, amp_dtype=torch.bfloat16),
        (x[:VGG_BATCH], y[:VGG_BATCH]), VISION_STEPS, card, 'images/s',
        VGG_BATCH, model)
    del model, x, y
    torch.cuda.empty_cache()

    model = TSM(TSM_CLASSES, TSM_SEG, 50, device=dev, seed=seed)
    x, y = vision_batch(seed + 1, TSM_CLIPS, TSM_CLASSES, dev, TSM_SEG)
    train_vision('(c) TSM ResNet-50 bf16 AMP', vr.tsm_step(
        model, amp_dtype=torch.bfloat16), (x, y), VISION_STEPS, card,
        'clips/s', TSM_CLIPS, model)
    # temporal_shift's device time a step: its forward and backward on the
    # 16 bottleneck inputs' shapes, in bf16 as the AMP step runs it
    shapes = []
    hooks = [b.register_forward_pre_hook(
        lambda layer, inputs: shapes.append(tuple(inputs[0].shape)))
        for b in model.backbone.blocks]
    with torch.no_grad():
        model(x[:TSM_SEG])
    for h in hooks:
        h.remove()
    acts = [torch.randn((TSM_CLIPS * TSM_SEG,) + s[1:], device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
            for s in shapes]
    grads = [torch.ones_like(a) for a in acts]

    def shifts():
        for a, g in zip(acts, grads):
            temporal_shift(a, seg_num=TSM_SEG).backward(g)
    shift_ms = device_us(profiled(shifts)) / 1e3
    shift_bytes = sum(4 * a.numel() * a.element_size() for a in acts)
    log(f'21 (c) temporal_shift [{card}]: {shift_ms:.3f} ms of device time '
        f'a step (forward and backward on the {len(acts)} bottleneck '
        f'inputs, bf16); {shift_bytes} bytes read and written, '
        f'{shift_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at '
        f'{HBM_BYTES_PER_S / 1e12} TB/s')
    del model, x, y, acts, grads
    torch.cuda.empty_cache()


def dcgan_loop(seed, dev, card):
    """Phase 21 (d): the DCGAN's alternating updates, D never updated
    with G's gradients."""
    import copy
    import torch
    from paddle_tpu_torch.models import DCDiscriminator, DCGenerator
    from paddle_tpu_torch.tools import vision_recipes as vr
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = DCGenerator(DCGAN_Z, DCGAN_BASE, 1, device=dev, seed=seed)
    d = DCDiscriminator(DCGAN_BASE, device=dev, seed=seed + 1)
    d_opt, g_opt = vr.dcgan_optimizers(g, d)
    real = torch.tanh(torch.randn(DCGAN_BATCH, 1, 32, 32, device=dev,
                                  generator=gen))
    zs = torch.randn(DCGAN_ITERS + 4, DCGAN_BATCH, DCGAN_Z, device=dev,
                     generator=gen)
    losses, secs = [], []
    for i in range(DCGAN_ITERS):
        t0 = time.perf_counter()
        d_loss, g_loss = vr.dcgan_iteration(g, d, d_opt, g_opt, real, zs[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if any(p.grad is not None for p in d.parameters()):
            raise AssertionError('a discriminator gradient outlived the '
                                 'generator\'s step')
        losses.append((d_loss.item(), g_loss.item()))
    if not np.isfinite(losses).all():
        raise AssertionError(f'DCGAN losses not finite: {losses}')
    p50 = statistics.median(secs[WARMUP_STEPS:]) * 1e3

    # D's next update from cleared gradients equals the loop's; with the
    # generator's loss's gradients left on D it differs (the check bites).
    # cuDNN's deterministic algorithms make the three runs comparable bit
    # for bit; the bound is a hundredth of what G's gradients move
    def forked(dirty):
        gc, dc = copy.deepcopy(g), copy.deepcopy(d)
        opt = vr.dcgan_optimizers(gc, dc)[0]
        opt.set_dict(d_opt.state_dict())
        if dirty:
            logits = dc(gc(zs[-1]))
            vr._bce(logits, torch.ones_like(logits)).backward()
            gc.clear_gradients()
        vr.dcgan_d_step(gc, dc, opt, real, zs[-2])
        return [p.detach().clone() for p in dc.parameters()]

    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        clean, dirty = forked(False), forked(True)
        vr.dcgan_d_step(g, d, d_opt, real, zs[-2])
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    apart = max((p.detach() - q).abs().max().item()
                for p, q in zip(d.parameters(), clean))
    moved = max((p - q).abs().max().item() for p, q in zip(clean, dirty))
    if not apart <= 0.01 * moved:
        raise AssertionError(f'D\'s update saw G\'s gradients: {apart} from '
                             f'the clean fork, the dirty fork {moved}')
    busy = device_us(profiled(lambda: vr.dcgan_iteration(
        g, d, d_opt, g_opt, real, zs[-3]))) / 1e3
    log(f'21 (d) DCGAN losses (D, G) every 10th iteration: '
        f'{losses[::10]} last {losses[-1]}')
    log(f'21 (d) DCGAN z {DCGAN_Z}, base {DCGAN_BASE}, batch {DCGAN_BATCH} '
        f'[{card}]: {DCGAN_ITERS} alternating iterations, iteration p50 '
        f'{p50:.3f} ms, device busy {busy:.3f} ms, idle share '
        f'{1 - busy / p50:.3f}; no D update saw G\'s gradients (D\'s next '
        f'update {apart:.3e} from the clean fork\'s, the dirty fork\'s '
        f'{moved:.3e} from it)')
    del g, d
    torch.cuda.empty_cache()


def a4c_cases(rng):
    """name -> (build() -> a layer on the CPU or a function, input arrays,
    indices of the inputs to differentiate, tolerance, CPU rows or
    None)."""
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.ops import extra_ops
    from paddle_tpu_torch.ops.registry import get_op

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape, np.float32) * scale)

    def layer(cls, *args, **kw):
        return lambda: cls(*args, device='cpu', **kw)

    def fn(f):
        return lambda: f

    neg = rng.integers(0, 100000, 10)
    c3 = CONV3D_SHAPE[1]
    cases = {
        'Conv3D': (layer(dygraph.Conv3D, c3, c3, 3, padding=1),
                   [f32(*CONV3D_SHAPE)], [0], A4C_SUM_TOL, 1),
        'Conv3DTranspose': (layer(dygraph.Conv3DTranspose, c3, c3, 3,
                                  padding=1),
                            [f32(*CONV3D_SHAPE)], [0], A4C_SUM_TOL, 1),
        'Conv2DTranspose': (layer(dygraph.Conv2DTranspose, 4 * DCGAN_BASE,
                                  2 * DCGAN_BASE, 4, stride=2, padding=1),
                            [f32(DCGAN_BATCH, 4 * DCGAN_BASE, 4, 4)], [0],
                            A4C_SUM_TOL, None),
        'GroupNorm': (layer(dygraph.GroupNorm, 256, 32),
                      [f32(32, 256, 56, 56)], [0], A4C_SUM_TOL, None),
        'SpectralNorm': (layer(dygraph.SpectralNorm, [512, 4608]),
                         [f32(512, 4608, scale=0.05)], [0], A4C_SUM_TOL,
                         None),
        'BilinearTensorProduct': (layer(dygraph.BilinearTensorProduct, 256,
                                        256, 128),
                                  [f32(128, 256), f32(128, 256)], [0, 1],
                                  A4C_SUM_TOL, None),
        'GRUUnit': (layer(dygraph.GRUUnit, 3 * 512),
                    [f32(128, 3 * 512), f32(128, 512)], [0, 1],
                    A4C_SUM_TOL, None),
        'NCE (given negatives)': (fn(lambda x, label, w, b: extra_ops.nce_loss(
            x, label, w, b, label.new_tensor(neg))),
            [f32(128, 128), rng.integers(0, 100000, (128, 1)),
             f32(100000, 128, scale=0.1), f32(100000, scale=0.1)],
            [0, 2, 3], A4C_SUM_TOL, None),
        'TreeConv': (layer(dygraph.TreeConv, 128, 64, num_filters=4),
                     [f32(32, 64, 128), np.zeros((32, 63, 2), np.float32)],
                     [0], A4C_SUM_TOL, None),
    }
    for mode, alpha in (('all', 1), ('channel', 64), ('element', 64 * 7 * 7)):
        x = f32(32, 64, 7, 7)
        x.reshape(-1)[:64] = 0.0
        cases[f'PRelu {mode}'] = (fn(lambda x, a, m=mode: get_op('prelu').fn(
            x, a, mode=m)), [x, f32(alpha)], [0, 1], A4C_SUM_TOL, None)
    acts = {'leaky_relu': [0.0], 'relu6': [0.0, 6.0], 'elu': [0.0],
            'selu': [0.0], 'brelu': [0.0, 24.0], 'soft_relu': [-40.0, 40.0],
            'stanh': [0.0], 'hard_sigmoid': [-2.5, 2.5],
            'hard_swish': [-3.0, 3.0], 'swish': [0.0],
            'hard_shrink': [-0.5, 0.5], 'softshrink': [-0.5, 0.5],
            'thresholded_relu': [1.0], 'gelu': [0.0], 'logsigmoid': [0.0],
            'atan': [0.0], 'tanh_shrink': [0.0], 'abs': [0.0],
            'sin': [0.0], 'cosh': [0.0], 'sinh': [0.0],
            'round': [0.5, 1.5, -0.5], 'softplus': [0.0], 'softsign': [0.0],
            'erf': [0.0], 'rsqrt': [1.0], 'reciprocal': [1.0],
            'acos': [0.0], 'asin': [0.0]}
    for op, breaks in acts.items():
        x = f32(4096, 256, scale=1.0 if op in A4C_EXP_OPS else 10.0)
        if op in ('rsqrt', 'reciprocal'):
            x = np.abs(x) + 0.5
        if op in ('acos', 'asin'):
            x = np.tanh(x) * 0.99
        x.reshape(-1)[:len(breaks)] = breaks
        cases[op] = (fn(get_op(op).fn), [x], [0], A4C_EW_TOL, None)
    x = f32(128, 256, 14, 14)
    x[0, :3] = 1.5                      # a three-way tie
    cases['maxout'] = (fn(lambda t: get_op('maxout').fn(t, groups=2)), [x],
                       [0], A4C_EW_TOL, None)
    return cases


def run_a4c_case(f, arrays, grad_of, dev, rows, cot_rng):
    """(outputs, input gradients, parameter gradients) of one case's layer
    (a copy of it on ``dev``) or function, on the first ``rows`` samples
    where given."""
    import copy
    import torch
    if isinstance(f, torch.nn.Module):
        f = copy.deepcopy(f).to(dev)
    ts = []
    for i, a in enumerate(arrays):
        a = a[:rows] if rows is not None and i == 0 else a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if i in grad_of:
            t.requires_grad_(True)
        ts.append(t)
    out = f(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [torch.from_numpy(cot_rng.standard_normal(tuple(o.shape),
                                                      np.float32)).to(dev)
            for o in outs]
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    params = (list(f.named_parameters()) if isinstance(f, torch.nn.Module)
              else [])
    return ([o.detach().cpu() for o in outs],
            [ts[i].grad.cpu() for i in grad_of],
            [p.grad.cpu() for _, p in params if p.grad is not None])


def a4c_on_card(seed, dev, card):
    """Phase 21 (e): every A.4c layer and new op on the card against the
    same port code on the CPU, forward and gradients."""
    import torch
    rng = np.random.default_rng(seed)
    checked = 0
    for name, (build, arrays, grad_of, (of_elem, of_max, atol), rows) in \
            a4c_cases(rng).items():
        t0 = time.perf_counter()
        f = build()
        cpu = run_a4c_case(f, arrays, grad_of, 'cpu', rows,
                           np.random.default_rng(seed + 1))
        card_run = run_a4c_case(f, arrays, grad_of, dev, rows,
                                np.random.default_rng(seed + 1))
        if rows is not None:
            # the whole batch on the card; its first samples against the
            # CPU's output and input gradient
            full = run_a4c_case(f, arrays, grad_of, dev, None,
                                np.random.default_rng(seed + 1))
            card_run = ([o[:rows] for o in full[0]],
                        [g[:rows] for g in full[1]], card_run[2])
        report = []
        for what, got, want in zip(('out', 'input grad', 'param grad'),
                                   card_run, cpu):
            for g, w in zip(got, want):
                diff = (g.double() - w.double()).abs()
                ref = w.double().abs()
                bound = of_elem * ref + of_max * ref.max() + atol
                if not bool((diff <= bound).all()):
                    raise AssertionError(
                        f'21 (e) {name}: {what} on the card off the CPU by '
                        f'{diff.max().item():.3e} ({of_elem} of the element '
                        f'+ {of_max} of the largest + {atol})')
                report.append(f'{what} {diff.max().item():.3e}')
        shape = tuple(arrays[0].shape)
        log(f'21 (e) {name} {shape} [{card}]: ' + ', '.join(report) +
            f' max|diff| ({of_elem} of the element + {of_max} of the '
            f'largest + {atol}'
            + (f'; CPU at {rows} sample' if rows else '') + f') in '
            f'{time.perf_counter() - t0:.1f} s')
        checked += 1
        torch.cuda.empty_cache()
    log(f'21 (e) {checked} layers and ops on the card match the CPU')


def vision_layers(seed, dev, card):
    """Phase 21: (a)-(c) the classifiers, (d) the DCGAN, (e) the A.4c layers
    and ops against the CPU, (f) no kernel of the port launched."""
    from paddle_tpu_torch.ops import nn_ops
    t_start = time.perf_counter()
    nn_ops.reset_launch_counts()
    vision_classifiers(seed, dev, card)
    dcgan_loop(seed, dev, card)
    a4c_on_card(seed, dev, card)
    launches = nn_ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f'phase 21 launched kernels of the port: '
                             f'{launches}')
    log(f'21 (f) kernel launches over phase 21: {launches}')
    log(f'phase 21 in {time.perf_counter() - t_start:.1f} s [{card}]')
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--k1-probe', type=int, default=None,
                    help='run one of phase 2b\'s K1 probes in this process')
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this script runs on the card')
    if args.k1_probe is not None:
        k1_probe(args.k1_probe, args.seed)
        return 0
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.ops import _build

    # 1. device
    dev = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f'device: {name}, count {count}, torch {torch.__version__} cuda '
        f'{torch.version.cuda}, tf32 matmul '
        f'{torch.backends.cuda.matmul.allow_tf32} cudnn '
        f'{torch.backends.cudnn.allow_tf32}')
    log(smi)

    # 2. build
    info = _build.build()
    for src, i in info.items():
        log(f'build {src}.cu: {i["seconds"]:.1f} s (cached {i["cached"]})')
        for line in i['ptxas']:
            log(f'  {line}')
    flash_build = report_flash_build()
    paged_build, k4_build = report_k2_k4_build()

    # 2b. K1's first launch in fresh processes (ROADMAP C.14)
    probe_k1_first_launches(args.seed, smi)

    # 3. kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    k1 = check_decode_kernel(rng, dev, DECODE_CONTEXTS)
    log(f'K1 [{smi}]: max|diff| {k1["max_abs_err"]:.3e} {fmt_times(k1)}')
    served = check_decode_kernel(rng, dev, SERVED_CONTEXTS)
    log(f'K1 at the served decode step [{smi}]: max|diff| '
        f'{served["max_abs_err"]:.3e} {fmt_times(served)}')
    k1['served_shape'] = {key: served[key] for key in (
        'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
        'bound_by', 'timing')}
    k2 = check_prefill_kernel(rng, dev)
    # the quantized pools' instantiations and the verify read, at the same
    # shapes (after the f32 checks, whose inputs phase 2b repeats)
    variants = []
    for payload in PAYLOADS[1:]:
        kern = check_decode_kernel(rng, dev, DECODE_CONTEXTS, payload)
        log(f'K1 {payload} [{smi}]: max|diff| {kern["max_abs_err"]:.3e} '
            f'{fmt_times(kern)}')
        at_served = check_decode_kernel(rng, dev, SERVED_CONTEXTS, payload)
        log(f'K1 {payload} at the served decode step [{smi}]: max|diff| '
            f'{at_served["max_abs_err"]:.3e} {fmt_times(at_served)}')
        kern['served_shape'] = {key: at_served[key] for key in (
            'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
            'bound_ms', 'bound_by', 'timing')}
        variants += [kern, check_prefill_kernel(rng, dev, payload)]
    verify = {}
    for payload in PAYLOADS:
        verify[payload] = check_verify_read(rng, dev, SERVED_CONTEXTS,
                                            payload)
        log(f'K1 verify read k={SPEC_K} {payload} at the served contexts '
            f'[{smi}]: max|diff| {verify[payload]["max_abs_err"]:.3e}, each '
            f'row bitwise the single-query launch at c + j; '
            f'{fmt_times(verify[payload])}; the wrapper (flattening '
            f'included) {verify[payload]["wrapper_ms"]:.5f} ms')
    # the quantized pools' verify reads are those instantiations' launches
    # at other shapes, off phase 16's runs: reported inside their entries
    for kern in variants:
        payload = kern['name'].split()[-1]
        if 'decode' in kern['name']:
            kern['verify'] = {key: verify[payload][key] for key in (
                'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
                'bound_ms', 'bound_by', 'timing', 'wrapper_ms')}
    variants.append(verify['f32'])

    # 3b. flash-attention kernels against their plain versions
    flash = check_flash_kernels(rng, dev, smi)

    # 4. served path
    launches, lm, lm_reqs, lm_results = serve(args.seed, smi)
    k1['launches'] = launches['paged_attention']
    k2['launches'] = launches['paged_prefill_attention']
    k1['build'] = paged_build['paged_decode_attention']['f32']
    k2['build'] = paged_build['paged_prefill_attention']['f32']

    # 5. training path
    launches = train(args.seed, dev, smi)
    for kern in flash:
        kern['launches'] = launches[kern['name']]
        kern['build'] = flash_build[kern['name']]

    # 6. ResNet-50 training
    model, x = train_resnet(args.seed, dev, smi)

    # 7. K4: its path (the trained model's 1x1 ConvBNLayers in eval), then
    # the kernel against its plain version at the path's shapes
    launches, shapes = check_k4_on_model(model, x, smi)
    del model, x
    torch.cuda.empty_cache()
    k4 = check_k4_kernel(shapes, dev, smi)
    k4['launches'] = launches['conv1x1_bn_act']
    k4['launches_wgmma'] = launches['conv1x1_bn_act wgmma']
    k4['build'] = k4_build[k4['body']]

    # 8. the static graph: MNIST LeNet on Executor(CUDAPlace(0)); no kernel
    # of the port is on this path, and none may launch
    static = train_static_lenet(args.seed, smi)
    if any(static.values()):
        raise AssertionError(f'kernels launched on the static-graph path: '
                             f'{static}')
    log(f'static-graph path kernel launches: {static}')

    # 9. the dygraph API: Transformer-big under guard(CUDAPlace(0)); no
    # kernel of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    nmt = train_dygraph_transformer(args.seed, smi)
    if any(nmt.values()):
        raise AssertionError(f'kernels launched on the dygraph path: {nmt}')
    log(f'dygraph path kernel launches: {nmt}')
    dygraph_host_costs(dev, smi)

    # 10. ERNIE-base finetuning under guard(CUDAPlace(0)): unfused (no
    # kernel of the port), then through the flash kernels
    torch.cuda.empty_cache()
    ernie = train_ernie(args.seed, smi)
    for kern in flash:
        kern['launches_ernie'] = ernie[kern['name']]

    # 11. the static graph at scale: PaddleCV's ResNet-50 recipe through
    # CompiledProgram on Executor(CUDAPlace(0)), saved and served; no
    # kernel of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    sresnet, sresnet_peak = train_static_resnet(args.seed, smi)
    if any(sresnet.values()):
        raise AssertionError(f'kernels launched on the static ResNet path: '
                             f'{sresnet}')
    log(f'static ResNet path kernel launches: {sresnet}')

    # 12. the static control flow and PaddleNLP's PTB LSTM LM through
    # CompiledProgram on Executor(CUDAPlace(0)); no kernel of the port is
    # on this path, and none may launch
    torch.cuda.empty_cache()
    ptb = train_static_ptb_lm(args.seed, smi)
    if any(ptb.values()):
        raise AssertionError(f'kernels launched on the static PTB LM path: '
                             f'{ptb}')
    log(f'static PTB LM path kernel launches: {ptb}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_ptb'] = ptb[wrapper]

    # 13. PaddleNLP's attention seq2seq trained and beam-searched through
    # Executor(CUDAPlace(0)); no kernel of the port is on this path, and
    # none may launch
    torch.cuda.empty_cache()
    s2s = train_static_seq2seq(args.seed, smi)
    if any(s2s.values()):
        raise AssertionError(f'kernels launched on the static seq2seq path: '
                             f'{s2s}')
    log(f'static seq2seq path kernel launches: {s2s}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_s2s'] = s2s[wrapper]

    # 14. static mixed precision and recompute: the static ResNet-50 recipe
    # in bf16, in fp16 with dynamic loss scaling and with
    # RecomputeOptimizer, its bf16 eval and Predictor, and the seq2seq in
    # bf16; no kernel of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    amp = train_static_amp(args.seed, smi, sresnet_peak)
    if any(amp.values()):
        raise AssertionError(f'kernels launched on the static AMP path: '
                             f'{amp}')
    log(f'static AMP and recompute path kernel launches: {amp}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_amp'] = amp[wrapper]

    # 15. the IR passes and in-place state with early freeing: the static
    # ResNet-50 recipe and LeNet, fused and in place against plain; no
    # kernel of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    fused = train_fused_inplace(args.seed, smi)
    if any(fused.values()):
        raise AssertionError(f'kernels launched on the fused static path: '
                             f'{fused}')
    log(f'fused static path kernel launches: {fused}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_fused'] = fused[wrapper]

    # 16. the served variants: speculative decoding (n-gram and draft-model
    # drafters) and bf16 / int8 pools, phase 4's mix through the replica
    # stack; the launches of each variant's kernels are counted from 0
    # just before its run and read just after
    torch.cuda.empty_cache()
    by_run = serve_variants(lm, lm_reqs, lm_results, args.seed, smi)
    for kern in variants:
        prefill = 'prefill' in kern['name']
        wrapper = 'paged_prefill_attention' if prefill else 'paged_attention'
        payload = kern['name'].split()[-1]
        if payload in ('bf16', 'int8'):
            # the bf16 and int8 pools' runs (c) and (d)
            kern['launches'] = by_run[payload][wrapper]
        else:
            # the f32 verify read: every K1 launch of runs (a) and (b)
            kern['launches'] = (by_run['ngram'][wrapper]
                                + by_run['self'][wrapper])
        kern['build'] = paged_build[
            'paged_prefill_attention' if prefill
            else 'paged_decode_attention'][
            'f32' if 'verify' in kern['name'] else payload]
    # the f32 instantiations' launches in phase 16, runs (a) and (b) (K1's
    # are the verify reads); none of the flash kernels or K4
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_served_variants'] = (by_run['ngram'][wrapper]
                                            + by_run['self'][wrapper])
    log(f'served variants kernel launches by run: {by_run}')

    # 17. the serving tier on a shared-system-prompt mix: the prefix cache,
    # speculative suffix fill, disaggregated prefill, the host tier, and
    # two replica processes behind the router; the launches of each
    # in-process run are counted from 0 just before it and read just after
    torch.cuda.empty_cache()
    tier = serve_shared_prefix(lm, args.seed, smi)
    del lm
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_shared_prefix'] = sum(run[wrapper]
                                             for run in tier.values())
    # the f32 verify read: run (c)'s K1 launches
    variants[-1]['launches_shared_prefix'] = tier['spec']['paged_attention']
    log(f'shared-prefix mix kernel launches by run: {tier}')

    # 18. the Fluid script surface: PaddleBook's recognize_digits through
    # install_check, contrib.Trainer, DataFeeder, metrics and Inferencer,
    # a plain Executor loop and the NaN/Inf scan; no kernel of the port is
    # on this path, and none may launch
    torch.cuda.empty_cache()
    surface = fluid_surface(args.seed, smi)
    if any(surface.values()):
        raise AssertionError(f'kernels launched on the Fluid script '
                             f'surface\'s path: {surface}')
    log(f'Fluid script surface path kernel launches: {surface}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_fluid_surface'] = surface[wrapper]

    # 19. the stateless serving path: ResNet-50's inference model through
    # InferenceEngine, the MicroBatcher and POST /predict, and /metrics
    # against the clients' counts; no kernel of the port is on this path,
    # and none may launch ((d) and (e) ran inside phases 4 and 17)
    torch.cuda.empty_cache()
    stateless = serve_stateless(args.seed, smi)
    if any(stateless.values()):
        raise AssertionError(f'kernels launched on the stateless serving '
                             f'path: {stateless}')
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_stateless_serving'] = stateless[wrapper]

    # 20. the optimizer surface: BERT-base with LAMB through the flash
    # kernels (with and without remat, and a resume mid merge), the static
    # ResNet-50 with LARS and each other rule; none of the port's kernels
    # launches in (d) and (e)
    torch.cuda.empty_cache()
    lamb = optimizer_surface(args.seed, dev, smi)
    for kern in flash:
        kern['launches_lamb'], kern['launches_lamb_remat'] = \
            lamb[kern['name']]

    # 21. the rest of the dygraph layers and the vision models: MobileNetV2,
    # MobileNetV1, VGG-16-BN, TSM and the DCGAN train at full width, and
    # every A.4c layer and op runs on the card against the CPU; no kernel
    # of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    vision = vision_layers(args.seed, dev, smi)
    for kern, wrapper in ((k1, 'paged_attention'),
                          (k2, 'paged_prefill_attention'),
                          *((kern, kern['name']) for kern in flash),
                          (k4, 'conv1x1_bn_act')):
        kern['launches_vision'] = vision[wrapper]

    # 22. result lines
    log(f'chip_smoke: phases 1-21 in {time.perf_counter() - t_start:.1f} s '
        f'[{smi}]')
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'timing',
            'shape')
    log(json.dumps({'kernels': [
        {k: kern[k] for k in keys + tuple(
            x for x in ('launches_ptb', 'launches_s2s', 'launches_amp',
                        'launches_fused', 'launches_served_variants',
                        'launches_shared_prefix', 'launches_fluid_surface',
                        'launches_stateless_serving', 'launches_lamb',
                        'launches_lamb_remat', 'launches_vision', 'body',
                        'launches_wgmma', 'launches_ernie', 'stock', 'build',
                        'served_shape', 'wrapper_ms', 'verify')
            if x in kern)}
        for kern in (k1, k2, *variants, *flash, k4)]}))
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
