#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card and check it.

Run from the repository root, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device   -- the card's name and power limit, as ``nvidia-smi`` gives them;
2. build    -- the CUDA kernels, compiled from ``paddle_tpu_torch/csrc`` by
               ``paddle_tpu_torch/native/build.py`` (one ``nvcc`` per source,
               all started together): registers and spills by kernel, and
               the tensor-core instructions (HMMA, HGMMA) in each
               tensor-core kernel's machine code;
3. kernels  -- each kernel against its plain PyTorch version on the same
               inputs: the max abs error beside its stated tolerance, and
               CUDA-event times (L2 flushed before each call) of the kernel,
               the plain version and one PyTorch library call computing the
               same function (a yardstick the port never calls), with the
               least time the card could take (bytes or operations over the
               data-sheet peak of the named card).  The paged decode and chunk
               kernels (B5, B6) at the serving path's shapes (S=8 slots, H=8
               heads, D=64, page 16, 64 pages a slot, shuffled page ids;
               ``paged_cases``: the decode burst in each pool, one slot,
               every slot full, 64 slots; a 16-row chunk, the whole-prompt
               buckets R=128..1024, a 128-row chunk at 512, verify 8x4,
               the ragged prefill's 64 one-row lanes, R=512 in each
               pool), against ``F.scaled_dot_product_attention`` on
               K/V gathered to dense, B6's bound the tensor cores' (the
               design's bfloat16 products) beside the float32 CUDA-core
               figure, and, untimed (``check_paged_edges``), zero-length
               rows (exactly 0) in split grids, page-boundary and clamped
               lengths; the biased flash-attention forward (B1) at BERT-base's
               shape (B=32, H=12, S=128, D=64, key mask) in bfloat16 and
               float32, with a full [B, H, S, S] bias, unbiased and causal
               (in both types), at S=512, at D=128 and at D=256 (all on the
               tensor-core kernel but float32 at D=256), against
               ``F.scaled_dot_product_attention`` with the bias as
               ``attn_mask``, its float32 bound the tensor cores' (the
               bfloat16 products of the split) beside the float32 CUDA-core
               figure, and, untimed, bfloat16 and float32 rows whose bias is
               -inf everywhere (out 0); the flash-attention training
               kernels (B2 forward with lse, B3 dq, B4 dk/dv) at the unfused
               path's shape (B=32, H=12, S=128, D=64, float32, key mask) and
               in bfloat16, with a full [B, H, S, S] mask, unmasked and
               causal, at S=512 and at D=128 (both in float32 and bfloat16)
               and at D=256 in float32: B2 against SDPA's forward, B3 and B4
               together against ``torch.autograd.grad`` through SDPA (one
               call gives dq, dk and dv), their bound in float32 (D <= 128)
               the tensor cores' beside the float32 CUDA-core figure; and,
               untimed, rows whose mask is -inf
               everywhere (denominator 0: out 0, lse -1e30, finite
               gradients); the dequant-fused matmul (B7) at the served
               BERT's shapes (FFN up and down and the q/k/v/output
               projections at batch 32, FFN up at batch 1, the pooler and
               the 2-way NSP head) and a ragged one, float32 x with int8
               and fp8 carriers and bfloat16 x, against ``torch.matmul`` on
               the weight dequantized beforehand (what the unquantized
               program runs), its bound the least work known to give the
               product on the tensor cores (three bfloat16 products for
               float32 x, one for bfloat16) beside the float32 CUDA-core
               figure; and, untimed, an all-zero output channel and rows of
               x holding +-inf and NaN (the plain version's IEEE results).
               Each row reports its error's share of the tolerance;
Every path runs its timed steps captured: the executor's compiled step
and the decode engine's step are CUDA graphs (``framework/graphs.py``), and
each path's timed steps are checked to be replays (``cuda_graph_replays``).
Beside each path's captured steps the same steps run through the eager
block (``Executor._run_block`` / ``DecodeEngine._decode_forward``, called
directly): step p50, device busy share and peak memory of both, and the
largest gap between a replay's outputs and an eager step's from one state,
held to the path's tolerance (serve 1e-3, training 1e-4 relative, infer
1e-3, ResNet 1e-4 relative).  Each path logs ``capture_reason`` (null: no
reason in its op list to run eagerly).  ``release`` lines give each phase's
peak memory once its executors and graphs are dropped.

4. dropout  -- a dropout program (p 0.1, 4M elements) through ``Executor.run``:
               the warm-up, the capture and 4 replays; the last two replays'
               masks differ and each keeps 1 - p of the elements within
               3 sigma (the program's generator is registered with the
               graph);
5. serve    -- the README's serving model at full width (vocab 32000,
               d_model 512, 8 layers, 8 heads, ffn 2048, max_seq_len 1024;
               random weights from a seed) behind ``DecodeServer`` on the
               card: 8 greedy requests of 100-600 prompt tokens, the second
               of two sharing a 256-token prefix submitted after the first
               finished (the prefix-hit suffix path), then a chunked-prefill
               engine (``prefill_chunk_pages=8``) on a 700-token prompt.  The
               paged kernels' launch counters are zeroed just before and read
               just after; streamed logits are held against
               ``recompute_logits``; every engine captured its decode step;
6. profile  -- 8 requests (300-token prompts, 24 new tokens) on fresh servers,
               captured and eager, each timed (decode step p50, peak memory,
               8 B5 launches a decode step) and under ``torch.profiler`` (the
               device's busy share of the window, its time by kernel, B5's,
               B6's and their merge's device time and share of busy); the two
               modes' streamed logits within 1e-3;
7. train    -- BERT-base pretraining at full width (vocab 30522, hidden 768,
               12 layers, 12 heads, ffn 3072, max_pos 512, seq 128, 20
               predictions a sequence; random weights from the program's
               seed) as ``bench.py``'s ``bench_bert`` drives it, through the
               port: ``bert_base_pretrain_program``, ``decorate(opt,
               use_bf16=True).minimize(loss)``, ``Executor()`` on the card,
               the startup program, the warm-up step and the capture, a
               ``run_steps(steps=2)``, then timed steps, each synced.  Batch
               32 (the benchmark's 256 is cut to the script's time limit),
               dropout 0.1, AdamW (lr 1e-4, weight decay 0.01),
               ``FLAGS_flash_attention=always`` so that the fused attention
               op runs B1.  B1's launch counter is zeroed just before the
               timed steps and read just after: 24 a step (12 attention
               layers, each run again by its generic gradient); then 5 eager
               steps;
8. train_profile -- one such step captured and one eager under
               ``torch.profiler``: the device's busy share and its time by
               kernel, B1's included, and, for the eager step, host and device
               time by op type (each op's lowering in a range of its own),
               which prices the forward that generic gradients run again;
9. train_oracle -- float32 (no AMP), dropout 0, batch 8, full width: one
               startup copied into two scopes, ``Executor.warmup`` and then 3
               replayed steps with B1 (``FLAGS_flash_attention=always``) and
               3 with the plain composition (``never``); the per-step losses
               agree within 1e-4 relative, B1 ran only in the first, and the
               loss fell (AdamW at lr 1e-5 here, where the steps do not
               overshoot);
10. train_unfused -- the same model built with the unfused attention chain
               (``use_fused_attention=False``: matmul, mask add, softmax,
               matmul per layer), float32, dropout 0, batch 32, as
               ``bench.py``'s ``bench_flash_attention`` builds it, under
               ``FLAGS_flash_attention=always``: the executor's graph-pass
               pipeline rewrites the 12 chains and their 12 grad chains to
               ``flash_attention`` / ``flash_attention_grad``, whose
               lowering runs B2 forward and B3 + B4 backward.  The three
               launch counters are zeroed just before the timed steps and
               read just after: 24 / 12 / 12 a step (the generic gradient
               replays the forward); then 5 eager steps;
11. train_unfused_profile -- one such step captured and one eager under
               ``torch.profiler``: device time of B2, B3 and B4 and, eager, of
               the ``flash_attention`` / ``flash_attention_grad`` op ranges,
               and their share of busy;
12. train_unfused_oracle -- float32, dropout 0, batch 8, lr 1e-5: one startup
               in three scopes, 3 replayed steps each after a warmup: the
               unfused program under ``never`` (the chain on
               ``torch.matmul``), under ``always`` (B2-B4), and the fused
               program of phase 7 under ``always`` (B1); losses pairwise
               within 1e-4 relative, no B2-B4 launch in the ``never`` and
               fused runs;
13. infer   -- BERT-base at full width as an encoder (vocab 30522, hidden 768,
               12 layers, 12 heads, ffn 3072, max_pos 512, seq 128, batch dim
               -1, dropout 0, fused attention) with the pretraining program's
               NSP head (pooler + 2-way classifier), random weights from the
               program's seed, float32: ``fluid.io.save_inference_model`` to
               a temporary directory, then ``inference.Predictor`` on the card
               under ``FLAGS_flash_attention=always``, in three modes of
               ``FLAGS_weight_quant``: '' (float32 weights on cuBLAS), int8
               and fp8_e4m3 (the weight-quant pass rewrites all 74 matmuls to
               ``dequant_matmul``, B7).  Requests of batch 1, 8 and 32, each
               batch warmed and captured first (one entry per batch and
               mode); the launch counters are zeroed just before each mode's
               timed runs and read just after: 74 B7 (0 under '') and 12 B1 a
               run; batch 32 beside 10 eager runs.  The int8 sequence output
               is held within 0.05 * max|float32| of the float32 run's (the
               JAX package's bound); fp8's delta is reported;
14. infer_profile -- one batch-32 int8 run captured and one eager under
               ``torch.profiler``: the device's busy share, its time by kernel
               and B7's share;
15. infer_oracle -- a ``Config().disable_gpu()`` Predictor over the same
               directory runs on the CPU (every kernel's plain version): at
               batch 2 (the card's run a replay after ``warmup``), in int8 and
               fp8, its carriers and scales equal the card's bit for bit, and
               in every mode its outputs agree with the card's within
               ``INFER_ORACLE_TOL``;
16. resnet  -- ResNet-50 training as ``bench.py``'s ``bench_resnet`` drives it,
               through the port at full width (224x224x3, the v1.5 trunk,
               1000 classes; random weights from the program's seed):
               ``vision.resnet50_train_program(lr=0.1, momentum=0.9)``,
               ``decorate(opt, use_bf16=True).minimize(loss)``,
               ``Executor()`` on the card, the startup program, the warm-up
               and the capture, a ``run_steps(steps=2)``, then 10 synced
               replays at batch 128 and 5 eager steps (the batch halved while
               it does not fit, logged as ``reduced``), the feed on the card
               beforehand.  Convolutions, pooling and batch norm run on cuDNN
               / ATen (``cudnn.benchmark`` off): no hand-written kernel is on
               this path, and the launch counters of B1-B7, zeroed just
               before, must read 0 just after.  Step p50, images/s, peak
               memory, the losses (finite);
17. resnet_profile -- one such step captured and one eager under
               ``torch.profiler``: the device's busy share, its 15 largest
               kernels by name, and, eager, host and device time by op type
               (``conv2d``, ``conv2d_grad``, ``batch_norm``,
               ``batch_norm_grad``, ``relu``, ``cast``, ``momentum``, ``sum``
               on their own; the generic gradients' replayed forwards:
               ``relu`` and ``pool2d``);
18. resnet_oracle -- float32 (no AMP), batch 4, full width, lr 1e-3: one
               startup on the card copied to a CPU scope, ``warmup`` on the
               card, one replayed step whose loss is held to the CPU's first
               within 1e-4 relative, then from the same state 3 steps on the
               card (the first op by op, the next two replays) and 3 through
               ``Executor(CPUPlace())`` (the path the tier-1 tests hold to the
               JAX package), TF32 off for cuBLAS and cuDNN (set below),
               ``cudnn.benchmark`` off: per-step losses within 1e-4 relative,
               the 106 running statistics and 161 parameters within 1e-4 of
               each tensor's largest magnitude, and the loss fell.
19. dygraph_resnet -- BASELINE config 2 at bench_resnet's shape through the
               2.0 API: ``set_device("gpu:0")``, ``vision.models.resnet50()``,
               ``optimizer.Momentum(0.1, 0.9)``, ``amp.auto_cast(bfloat16)``,
               ``F.cross_entropy``, ``loss.backward()``, ``opt.step()``,
               ``opt.clear_grad()``; batch 128 (halved while it does not fit,
               logged as ``reduced``), random data from a seed on the card;
               3 warm-up steps, then 10 synced steps: step p50, images/s,
               finite losses, the eager ops dispatched a step (by type), peak
               memory after step 3 and after the last (within 5 %: state that
               held autograd's graph would grow it), B1-B7 launching 0 times,
               then one step under ``torch.profiler``: the device's busy
               share, its 15 largest kernels, device and host ms of the top
               op types (each eager op in a range of its own; the backward
               runs on autograd's thread, outside them), beside the same
               call's static ResNet step (phase 16);
20. dygraph_resnet_oracle -- batch 4, full width: one set of weights on
               the card and on the CPU, one float32 forward and backward
               each: the loss within 1e-4 relative, the 106 running
               statistics within 1e-4 of each tensor's largest magnitude,
               the 161 gradients within DY_ORACLE_GRAD_TOL norm-wise; then
               both in float64 from the same weights: loss, running
               statistics and gradients within DY_ORACLE_F64_TOL;
21. capture_concurrency -- two decode replicas of the serving model (8
               layers) serve 8 requests (200-token prompts, 300 new tokens)
               while the executor captures a new step key (128 fc layers)
               on the main thread, all under ``torch.profiler``: every
               request completes, the capture succeeds in ``thread_local``
               mode and credits none of the replicas' launches (decode steps
               ran during it), the B5 / B6 wrapper counts over the window
               equal the layers times the decode steps / prefills the
               engines counted, and the ``paged_decode_kernel`` /
               ``paged_chunk_mma_kernel`` launches the profiler saw;
22. hapi_dygraph -- the 2.0 high-level API's loop at full width:
               ``Model(vision.models.mobilenet_v2(num_classes=1000))``
               (scale 1.0, 3x224x224, float32) prepared with
               ``Momentum(CosineAnnealingDecay(0.1, T_max=steps), 0.9,
               weight_decay=4e-5)``, ``CrossEntropyLoss`` and
               ``Accuracy(topk=(1, 5))``; ``fit`` for one epoch over
               ``io.DataLoader(FakeData(128 * 12, 1000 classes, random
               flip, ImageNet normalization), batch_size=128,
               shuffle=True, drop_last=True, num_workers=4,
               device_prefetch=True)`` (batch halved while it does not fit,
               logged as ``reduced``) with ``LRScheduler``,
               ``BenchmarkCallback`` (FLOPs of the static train program,
               the float32 peak) and ``EarlyStopping``, then ``evaluate``
               over 4 batches of 3x256x256 through ``CenterCrop(224)`` and
               ``predict`` over 2.  Step p50 (the first 2 steps and the
               profiled ones left out), images/s, the loader's wait per
               step (p50 and share), the loader alone at 0 and 4 workers
               (and at 4 with batches pickled through the queue instead
               of shared memory), its workers' start-up seconds, the busy share of a profiled
               3-step window (the union of kernels and copies on any
               stream, the profiler open 0.5 s after the last sync), peak
               memory after step 3 vs the last (within 5 %), finite
               losses, evaluate's top-1 / top-5, ``[256, 1000]`` finite
               predictions, B1-B7 at 0 launches;
23. hapi_static -- the same under ``enable_static()`` with image and label
               ``InputSpec``s: the train, eval and predict programs run
               through the executor, their steps after the first two
               CUDA-graph replays (``cuda_graph_replays`` grows by the
               fit's steps - 1 and the evaluate's batches - 1 unless
               ``capture_reason`` names why not); the same numbers, and
               the MFU of the executor's step timer;
24. hapi_oracle -- float32, batch 8, full width, one seeded set of weights
               carried by ``state_dict``, one batch: the dygraph
               ``train_batch`` on the card against the CPU (loss within
               1e-4 relative; Accuracy's rows equal but at top-k ties
               within 1e-5; the step's update within 5e-3 norm-wise, the
               CPU's own gap for a nudged image beside it), and the static
               adapter's step-1 loss against the dygraph one's on the
               card within 1e-4;
25. text_transformer -- Transformer-base NMT through ``Model.fit`` in
               dygraph, float32: ``nn.Transformer`` at its defaults (d_model
               512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1), a shared
               37,000-token vocabulary scaled by sqrt(d_model) plus
               sinusoidal positions, the output projection tied to the
               embedding; 64 synthetic pairs of 64 tokens a batch (the
               target the reversed source behind BOS, a causal decoder
               mask); ``CrossEntropyLoss(soft_label=True)`` on
               ``label_smooth(one_hot(label), 0.1)``; Adam(0.9, 0.98, 1e-9)
               under NoamDecay(512, 4000); a 0-worker loader; 20 steps.
               ``train_batch`` p50, target tokens/s, eager ops a step, the
               busy share of a profiled 5-step window, its top kernels, peak
               memory after step 3 vs the last (within 5 %), the first and
               last loss, B1-B7 at 0 launches;
26. text_decode -- ``text.decode.beam_search`` with the trained model: 8
               sentences, beam 4, length penalty 0.6, 64 steps, the decoder
               run over the whole prefix each step; ms a decode, tokens/s,
               B1-B7 at 0;
27. text_lstm -- the PTB language model (Zaremba et al. 2014 "large":
               vocabulary 10,000, embedding and 2 LSTM layers of 1,500,
               dropout 0.65 on the embedding, between the layers and on the
               output) through ``Model.fit`` in dygraph, float32, over
               ``text.datasets.Imikolov(NGRAM, window 36)`` windows of a
               synthetic ``simple-examples`` tarball (about 1M tokens, a
               10,000-word vocabulary at min_word_freq 50), 20 windows of
               35 steps, SGD at lr 1.0 under ClipGradByGlobalNorm(10); the
               numbers of phase 25, and whether cuDNN copies the layer's
               weights at each call, with the op's ms beside the same
               weights in cuDNN's flat buffer;
28. text_oracle -- the card against the port's CPU path from the same
               weights: both models' step-1 loss with dropout 0 within 1e-4
               relative; one float64 ``rnn`` op (LSTM and GRU, 2 layers,
               bidirectional) forward and backward within 1e-10; each beam
               hypothesis of phase 26 re-scored by a teacher-forced CPU pass
               within 1e-3 of the card's score, and the CPU's own beam
               search no better than the card's best beam by more than 1e-3;
29. nn_extras -- ``conv2d_transpose`` (512 -> 256, 4x4, stride 2, pad 1 on
               [64, 512, 8, 8]), ``group_norm`` (32 groups on [32, 256, 56,
               56]) and ``instance_norm`` ([16, 64, 128, 128]): the card
               against the CPU, forward and every gradient, within 1e-4 of
               the largest magnitude (float32, TF32 off), and the card's
               forward + backward ms.

Slice 21's phase runs after ``nn_extras``:

56. op_library -- the dense op library (``OPLIB``), each group one program
               through the Executor on the card, forward and input
               gradient, against the port's CPU path on the same inputs
               (``OPLIB_RTOL``; integer outputs and pure gathers equal;
               row-independent ops on the CPU for the first rows):
               ``warpctc`` at PaddleOCR CRNN's [80, 256, 6625], the
               resizes at DeepLabv3+'s x4, YOLOv3's neck, a bicubic pass
               and a 3-D volume, ``logsumexp`` / ``nll_loss`` /
               ``kldiv_loss`` at [4096, 32000], 64 ``beam_search`` steps
               over [128, 37000] (each step on the CPU from the card's
               inputs) and ``beam_search_decode``, ``lookup_table`` at
               ERNIE's [18000, 768], ``coalesce_tensor`` +
               ``squared_l2_norm`` over BERT-base's parameters,
               ``cholesky`` / ``inverse`` at [64, 256, 256], ``addmm``,
               ``segment_pool`` at [65536, 128] and the other lowerings at
               small shapes: each group's card ms (median of 5 CUDA-event
               timings of the captured step); 1e6 draws of each
               ``distribution`` by their statistics; ``utils.run_check()``
               on the card; B1-B7 at 0.

Slice 22's phase runs after ``op_library``:

57. vision_ops -- the vision and detection ops (``VISION``), each group one
               program through the Executor on the card, captured (its
               ``executor_eager_*`` counters unchanged; ``crop_tensor``
               with an ``Offsets`` tensor the one eager case), forward and
               input gradient, then on the card and the CPU from the same
               cut inputs (one image, one clip or the first RoIs at full
               width; ``OPLIB_RTOL``; NMS, proposals and pool masks by the
               margin rules, VISION_MARGIN): YOLOv3's three ``yolo_box``
               heads at 608 into ``multiclass_nms3`` and PP-YOLO's into
               ``matrix_nms`` (linear and gaussian), SSD300's priors,
               decode, NMS and matching, Faster R-CNN's RPN proposals and
               RoI head (``roi_align`` 14x14, ``roi_pool`` 7x7 over 1,024
               RoIs), R-FCN's ``psroi_pool`` and ``prroi_pool``, PP-YOLO's
               DCN res5, a flow warp and FlowNetC's correlation, C3D's
               conv3a with 3-D pools, TSM's shift, SegNet's pool with
               index, AlexNet's LRN, a x2 pixel shuffle, 37,000-way label
               smoothing and the other lowerings at small shapes: each
               group's card ms (median of 5 CUDA-event timings of the
               captured step); ``vision.ops``' four functions in dygraph
               on the card against the static path; B1-B7 at 0.

Slice 23's phase runs after ``vision_ops``:

58. sequence_misc_ops -- the sequence ops, the linear-chain CRF, the
               sampled losses and the rest of the op library (``SEQMISC``),
               each group one program through the Executor on the card,
               captured (``sequence_slice`` and ``affine_grid`` with an
               ``OutputShape`` tensor eager, ``executor_eager_shape_tensor``;
               the seeded ``nce`` / ``sample_logits`` eager,
               ``executor_eager_seeded_random``; no other eager counter
               moves), forward and input gradient, then on the card and
               the CPU from the same cut inputs (``OPLIB_RTOL``; Viterbi
               paths and pool masks by the margin rules, VISION_MARGIN):
               LAC's CRF tagger ([64, 128, 57]: ``linear_chain_crf`` with
               its gradient, ``crf_decoding`` with and without ``Label``),
               a text CNN's padded batch ([64, 128, 128]: pad / unpad /
               mask, six pools, softmax, ``sequence_conv`` 128 -> 128 over
               8,192 tokens, expand, reverse, concat, reshape, enumerate,
               scatter), DeepSpeech2's ``row_conv`` ([3000, 2048], 20
               ahead), word2vec's ``nce`` (4,096 x 300 against 100,000
               classes, samplers 0, 1, 2) and a 32,000-way
               ``sample_logits`` (the CPU reading the card's draw), SegNet's
               pool -> ``unpool``, ``affine_grid`` -> ``grid_sampler``,
               ``conv3d_transpose``, ``depthwise_conv2d_transpose``,
               ``fsp``, ``spectral_norm``, ``data_norm``, ``batch_fc``,
               ``center_loss`` over 10,575 classes twice with its centers
               as state, and the other lowerings at small shapes: each
               group's card ms (median of 5 CUDA-event timings of the
               captured step); 1e6 draws of each sampler by their
               statistics; ``shuffle_batch`` a permutation; B1-B7 at 0.

Slice 14's phases run after ``profile`` (the first three, on the serving
model, the launch counters zeroed before each timed window and read after
it) and after ``infer_oracle`` (the last two, on its saved directory).
Greedy tokens of two paths are compared up to the first position whose
top-2 logit margin is under MARGIN_TOL (the paths' logits agree to
summation order only); a divergence at a larger margin fails the phase.

30. spec    -- speculative decoding at the serving width: 8 slots, spec_k
               3 (verification is ``chunk_S8_R4``), 8 greedy requests of
               128-token prompts and 256 new tokens, without a draft, with
               the accurate draft (the target's layer 0 sharing its
               embeddings and head; the target's layers 1-7 with ``wo``
               and ``w2`` scaled by 0.05) and with a random 1-layer draft:
               tokens/s, acceptance, rounds, tokens a slot-round, the
               proposal burst's and the verification's p50 ms (replays),
               captures and replays; B5 launches (k + 1) x draft layers x
               rounds + 8 a normal step, B6 8 x rounds + the prefills';
               the emitted tokens are the verify logits' argmaxes and the
               streamed logits agree with ``recompute_logits``;
31. ragged  -- 16 requests (prompts of 100-600 tokens, 32 new tokens) on a
               seeded Poisson schedule (mean gap 5 ms), one-page chunks,
               padded and packed into 64 one-row lanes: the pad waste (it
               must drop), wall, ttft p50/p99, dispatches, B6 launches;
32. disagg  -- a 1 + 1 ``DisaggServer`` against a local engine (kv_quant
               off and on; greedy and seeded sampled requests): tokens,
               logits within LOGIT_TOL, migrated pages, bytes and install
               seconds; a prefill replica killed mid-prefill with zero
               drops; short chats among 900-token adversaries through the
               1 + 1 server and a 2-replica chunked ``DecodeServer`` (ttft
               p50/p99, the chats' TPOT p50/p99; both replicas share one
               card's SMs, so nothing is required of the comparison);
33. preflight -- ``preflight_device(attempts=1)`` on the card (a CUDA add in
               a child process): the verdict and its seconds;
34. oneshot_server -- the saved BERT-base + NSP model, int8 and
               ``FLAGS_flash_attention=always``, behind ``serving.Server``
               (batch buckets 1-32, a 2 ms window): warmup captures one
               graph per bucket, 8 client threads send 256 requests of 1-4
               rows, every batch a replay launching 74 B7 and 12 B1; rows/s
               beside the same requests one at a time through the bare
               warmed ``Predictor``, whose outputs each request's agree
               with within INFER_ORACLE_TOL.

Slice 15's phases run after ``train_profile`` (the first five, on phase
7's fused bf16 BERT-base at batch 32, built once; every timed step a
replay launching B1 24 times, checked around each run) and after
``nn_extras`` (the last).  ``max_inflight_steps`` is the default 2 but
where a phase sets it.

35. pipelined -- one startup state copied with ``snapshot_scope`` /
               ``restore_scope``; ``warmup``; 30 steps at
               ``max_inflight_steps`` 0, then 30 at 2 (four feeds cycled
               by step): losses and the final state (parameters, AdamW
               moments, the generator) bit-equal; step p50 of each,
               ``fetch_sync_seconds`` and the in-flight gauge's maximum
               (2); then 20 steps at each window with a feed that sleeps
               40 ms a batch (a loader's host time): ms a step;
36. ckpt_resume -- 200 steps at window 2 with ``CheckpointManager(keep_n=2,
               async_save=True)`` saving every 50: each save's blocking
               seconds, the writer's seconds (copy wait, serialize +
               write, fsync, SHA-256, commit), bytes, the coalesced saves,
               the step p50 of the 5 steps after each save against the
               run's; a second run whose commit of step 150 crashes
               (``set_fault_hook``): ``step_150.tmp`` on disk, 100 the
               newest intact step; a fresh ``Executor`` and ``Scope``
               restore it and run 101-200: losses and final state
               bit-equal to the first run; a byte flipped in the newest
               shard falls back to 50 (``ckpt_restore_fallbacks``); a
               bfloat16 var round-trips bit-equal and ``ml_dtypes`` was
               never imported;
37. nan_scan -- ``FLAGS_check_nan_inf=1``: still captured (replays
               counted), step p50 with the scan beside without; layer 0's
               query weight set to inf: the next run raises naming the
               first op that reads it (its type, build site and index in
               the compiled block), and ``snapshot_scope`` refuses the
               scope after it;
38. prune   -- ``run(main, fetch_list=[loss], use_prune=True)``: every
               parameter and moment bit-unchanged, the loss within 1e-6
               of an unpruned run's from the same state and generator
               state; the pruned step's ms;
39. auto_checkpoint -- ``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT``,
               a local checkpoint path, ``configure(every_n_steps=10)``:
               ``train_epoch_range("bert", 2)`` of 10 steps an epoch stops
               after epoch 1; a fresh executor and scope skip epoch 0,
               the executor's hook restores before their first fed run,
               and their epoch is bit-equal to the first run's
               continuation;
40. model_checkpoint -- MobileNetV2 through ``Model.fit`` in dygraph, 2
               epochs of 4 batches of 128 (FakeData, 0 workers), with
               ``ModelCheckpoint(keep_n=1, async_save=True)``:
               ``restore_latest`` into a fresh ``Model`` predicts
               bit-equal on one batch; only ``step_1`` survives.

Slice 16's phases run after ``model_checkpoint``: BASELINE config 5, an
ERNIE-1.0 sentence-classification finetune at ERNIE 1.0's published widths
(``ernie_config.json`` of PaddlePaddle/ERNIE: 12 layers, hidden 768, 12
heads, FFN 3072, vocab 18000, max_pos 513, two segment types) over
``text.static_models.bert_encoder`` with fused attention (gelu in the
FFN, where ERNIE 1.0 has relu: the repo's encoder layer fixes gelu), the
first token -> ``fc(768, tanh)`` -> dropout 0.1 -> ``fc(2)`` -> softmax
cross entropy -> mean, batch 32 at seq 128, dropout 0.1, AdamW (lr 5e-5,
weight decay 0.01), built through ``fleet.init(is_collective=True,
strategy=s)``, ``fleet.distributed_optimizer(opt)``,
``fleet.minimize(loss)``; synthetic ids, segments, key masks and labels
from a seed, one batch repeated.

41. ernie_fleet -- ``s.amp`` (bf16) + ``s.recompute`` checkpointed at every
               layer's ``_ln2`` output: the applied meta-optimizer chain,
               op counts (casts, recompute barriers, re-emitted forward
               ops), 30 steps (the eager warm-up, the capture, 28 replays
               with B1's launches counted: 36 a step), step p50 captured
               and eager, the peak memory over the warm-up and the
               capture and the graph pools' size; then the amp-only chain
               from the same startup values, the same numbers (24 B1
               launches a step).  Fails unless the chain holds casts and
               barriers, every loss is finite, the last loss is below the
               first, recompute's peak is below amp-only's, and the two
               trajectories are bit-equal or within 1e-3 relative;
42. ernie_gm -- the same model with ``s.amp`` + ``s.gradient_merge``
               (k_steps 4, avg), 8 steps captured and 8 through the eager
               block from one startup: every parameter bit-equal to its
               previous value on the steps that do not update, and the
               two runs bit-equal;
43. ernie_oracle -- step 1 of ``ernie_fleet``'s chain with dropout 0 (the
               card's and the CPU's generators draw other masks), run on
               the card and replayed on the CPU from the card's startup
               values and feed, at ERNIE_ORACLE_BATCH (the CPU's step,
               the phase's cost, grows with the batch): the loss within
               ERNIE_ORACLE_RTOL.

Slice 17's phases run after ``ernie_oracle``: the rest of ``slim`` on
ResNet-50 v1.5 at 224 (``build_resnet``'s program in float32: the AMP
lists name no fake-quant op; synthetic images and labels from a seed: no
labelled dataset is in the repository, so no accuracy is claimed) and
MoE serving and training.

44. qat_resnet -- the float32 network, then the same with
               ``slim.quant_aware`` applied before ``minimize`` (moving-
               average activation and channel-wise weight quant-dequant
               ops), each at RESNET_BATCH (halved while it runs out of
               memory, logged as ``reduced``): the warm-up, the capture,
               QAT_STEPS replays and QAT_EAGER_STEPS eager steps beside
               them; step p50, images/s, peak memory, qdq ops, the
               moving-average scales (all off their initial 1.0), B1-B7
               at 0;
45. qat_export -- the trained QAT program's ``clone(for_test=True)``
               (scales frozen) -> ``save_inference_model`` -> a captured
               ``Predictor`` at batch 32 against the frozen program run by
               the executor, within 1e-4 relative / 1e-5 absolute (the
               JAX package's bound); the scales unchanged by the frozen
               run; rows/s;
46. ptq_resnet -- ``PostTrainingQuantization`` of the float inference
               program over 4 seeded calibration batches of 32 (each
               activation's abs-max taken on the card), saved and served
               by a captured ``Predictor`` beside the float32 one: rows/s
               of both at batch 32, the logits' largest gap and top-1
               agreement (``quant_quality_delta``), B1-B7 at 0;
47. qat_oracle -- float32, batch 4: step 1 of the QAT network on the
               card replayed op by op on the CPU from the card's inputs:
               every fake quant-dequant output (and its straight-through
               gradient) bit-equal, every other output within
               RESNET_ORACLE_RTOL;
48. moe_serve -- the serve phase's model with 8 experts, top-2, dropless
               (537 MB of float32 experts), 6 prompts of 100-600 tokens, 32
               new tokens each, through ``DecodeServer`` (the decode step
               captured, prefill eager) beside the dense model in the same
               call, then with ``quantize_moe_weights(w, "int8")``: decode
               step p50, ttft, TPOT p50/p99, tokens/s, B5 8 a decode step
               and B6 8 a prefill (asserted), streamed logits within 1e-3
               of ``recompute_logits``, each layer's expert-balance
               gauges, and int8's ``quant_quality_delta`` against the float
               oracle teacher-forced on the int8 tokens;
49. moe_train -- ``bench.py``'s ``moe_local`` program at the serving
               widths (x -> ``moe_ffn`` (D 512, FFN 2048, 8 experts, top-2,
               capacity factor 1.25) -> fc head -> MSE + 0.01 aux,
               Momentum 0.05/0.9, 8192 tokens a batch) and its dense twin
               (fc 4096 gelu -> 512, matched activated FLOPs) through
               ``fleet`` at one process: captured step p50 and tokens/s of
               both, the balance and dropped-fraction gauges, step 1's
               loss within 1e-4 of the CPU's from the same startup;
50. jit_resnet -- dygraph ResNet-50 (eval, float32, batch 32) through
               ``jit.to_static``: traced, captured, 20 replays beside the
               eager forward's p50 (within 1e-4 relative of it), no
               ``executor_eager_*`` run, B1-B7 at 0, the ``trace_const``
               vars (every one a scalar or a batch-norm buffer: no
               activation escaped the recorder); ``jit.save`` at
               ``InputSpec([-1, 3, 224, 224])`` -> ``jit.load`` on the
               card at batch 32 (within 1e-4 of ``to_static``, rows/s);
               ``flops(net, [1, 3, 224, 224])`` beside the static ResNet
               program's ``program_flops``;
51. jit_bert_int8 -- a dygraph BERT-base-width encoder (the 2.0 layers:
               word and position embeddings, the pad mask from
               ``ids != 0``, 12 gelu layers, tanh pooler, 2-way
               classifier) at 32 x 128, ``jit.save`` on example tensors
               of that shape, ``jit.load`` in float32 (within 1e-4 of
               eager) and under ``FLAGS_weight_quant=int8`` (B7 74 a run,
               each ``matmul_v2`` of a weight rewritten): rows/s of both,
               the int8 logits' ``quant_quality_delta``, the peak memory;
52. dy2static -- the JAX package's VERDICT function (a branch on the
               mean, a loop on the sum) at [32, 768] through
               ``to_static`` -> ``jit.save`` -> ``jit.load``: fills
               taking both branches and 0, 1, 2 and 7 trips, each run
               within 1e-6 of eager and one ``executor_eager_control_flow``
               run; then the cond training program (x [4096, 1024], fc
               4096) 10 Momentum steps on the card with the flag
               alternating: losses within 1e-4 of a CPU run from the same
               initial scope, the branch-only parameter moved, step ms.

Slice 19's phases: the rest of observability.  ``observe_train`` and
``observe_profiler`` run after ``auto_checkpoint``, on its program
(``bert15``); ``observe_serve`` after ``oneshot_server``, on its saved
model.

53. observe_train -- fused bf16 BERT-base at batch 32 through the
               pipelined window with ``FLAGS_device_peak_tflops=989``:
               the warm-up under ``FLAGS_hbm_budget_fraction=0.9`` (the
               verdict ``pass``; ``on_compile``'s record: the pre-launch
               estimate beside the allocator's reading and the measured
               peak); 20 steps with phase attribution on and 20 off from
               one state (losses bit-equal, every step a replay with 24
               B1 launches, each drained step's four buckets summing to
               its wall within 1e-6 relative; the measured and predicted
               split, step p50 on and off); the split under a 40 ms host
               feed (input wait at least 0.9 of it a step); one step
               slowed 4x its p50 under ``FLAGS_prof_trigger_ratio=2``:
               exactly one capture, its Chrome trace holding
               ``flash_fwd_mma_kernel`` kernel events and its bundle
               ``phases.json``; a feed whose copy waits 4 s on a stalled
               stream under ``FLAGS_stall_timeout_s=2``: exactly one
               bundle, its ``stacks.txt`` naming the blocked thread, its
               ``memory.json`` the allocator's figures,
               ``tools/postmortem.py`` exiting 0 on it; a budget no
               program fits: ``MemoryBudgetError`` at the key's first run,
               no B1 launch, no capture, nothing cached;
54. observe_profiler -- ``profiler.profiler(profile_path=...)`` around 5
               replayed steps of the same program, then
               ``profiler.cuda_profiler()`` (``PADDLE_TPU_PROFILE_DIR``):
               each Chrome trace holds ``flash_fwd_mma_kernel`` kernel
               events;
55. observe_serve -- the serve model behind ``DecodeServer(http_port=0)``,
               16 greedy requests: ``/stats``, ``/health``, ``/metrics``,
               ``/debug/requests``, ``/debug/request/<id>``,
               ``/debug/slo`` and ``/metrics/cluster`` answer 200 with
               JSON or Prometheus text that parses, every ``/metrics``
               series has a rule in the port's catalog, a
               ``HealthReporter`` beat shows rank 0 alive, tokens equal a
               server's without HTTP, B5/B6 launched in multiples of 8;
               then the one-shot ``Server(http_port=0)`` over the int8
               ``Predictor`` (batch bucket 1, 8 requests: B7 74 and B1 12
               a batch) answers ``/stats`` and ``/health``.

Slice 24's phases run after ``dy2static``: scan-over-layers
(``FLAGS_layer_scan`` / ``recompute_configs`` scan stamps:
``LayerScanPass`` rewrites each run of isomorphic layer segments into one
``layer_scan`` op over ``@LAYER_STACK@`` carriers, its body lowering one
layer's ops once per layer) and the one-process CTR path.

59. layer_scan_train -- phase 7's BERT-base (bf16 AMP, batch 32, dropout
               0.1, B1) from one startup state, unrolled and then under
               ``FLAGS_layer_scan=1`` (min_layers 4): the pass's segments
               and layers, carriers, program ops before and after, the
               warm-up and capture seconds, peak memory, B1 24 a step in
               both, step p50, both 12-step loss trajectories (bit-equal,
               or within ERNIE_TRAJ_RTOL with the first step apart and
               the gap logged); then the scanned scope's
               ``snapshot_scope`` (per-layer names, no carrier) restored
               into an unrolled executor: its next step's loss equals the
               scanned run's next step;
60. layer_scan_recompute -- phase 41's ERNIE-1.0 finetune (amp +
               recompute) with ``recompute_configs`` ``scan_layers=12``,
               ERNIE_STEPS steps from ernie_fleet's initial state: the
               trajectory held to ernie_fleet's recompute run's (bit-equal
               or ERNIE_TRAJ_RTOL), B1 36 a step, the peak beside
               ernie_fleet's; then ``policy="dots_saveable"`` alone under
               ``FLAGS_layer_scan=1`` for LS_POLICY_STEPS steps, held the
               same way;
61. layer_scan_infer -- phase 30's BERT-base + NSP model saved and served
               through ``Predictor`` under ``FLAGS_weight_quant=int8`` at
               batch 32, unscanned and scanned: B7 74 and B1 12 a run in
               both (B7 reading slices of the stacked ``@WQ`` carriers,
               [12, K, N] int8, scales [12, N]), run p50 of both, outputs
               bit-equal or within LS_INFER_RTOL;
62. rec_data_feed -- ~100 MB of seeded MultiSlot text at Criteo's layout
               (13 dense, 26 ids, a label) parsed by
               ``io.MultiSlotDataFeed`` on the native parser (asserted:
               no fallback parse) and a 2 MB slice by the Python
               fallback (the same arrays): MB/s of both; then
               ``rec.wide_deep_program`` at bench.py's DLRM sizes (batch
               256, vocab 65,536, emb 32, hidden (128, 64), padding 0,
               sparse tables: the dense fallback lookup) 10 steps on the
               card, captured from step 2: step p50, examples/s,
               ``emb_sparse_fallback_dense``, step 1's loss within 1e-4
               of a CPU run of the port from the same state.

Slice 25's phases run after ``rec_data_feed``: data parallelism across
processes.  The script starts its ranks by running itself in a child
mode (``--fleet-rank <dir>``, ``--collective-capture <dir>``) through
the port's launcher (``distributed/launch.py``), every child on cuda:0
(``FLAGS_selected_gpus=0``) with the kernels this run built; each writes
a JSON that the parent reads and checks.

63. fleet_dp -- phase 7's BERT-base (bf16 AMP through ``fleet`` with
               ``strategy.amp``, dropout 0.1, B1) at two ranks of batch 16
               over gloo (the card is one device; NCCL refuses two ranks
               on it), ``GradAllReduce`` with bucketed ``c_allreduce_sum``:
               a warm-up and FLEET_STEPS eager steps (``host_collective``)
               on each rank; B1 24 a step on each, one loss scale, the
               buckets ``FuseAllReducePass`` planned and their bytes, the
               losses bit-identical across ranks, every parameter's digest
               equal across ranks after the startup and the last step;
               step p50, allreduce seconds a step, peak memory a rank;
64. fleet_dp_oracle -- float32, dropout 0, BERT-base width: the two
               ranks at batch 4 each (the children of phase 63, from this
               process's startup values) against this process at batch 8
               (``train_oracle``'s shape) over 3 steps: losses within
               ORACLE_RTOL, the parameters within it over the norm of all
               of them; fused and unfused allreduce bit-equal;
65. collective_capture -- one child, NCCL at world size 1, started with
               phase 63's ranks (its start-up beside theirs, its work
               after their timed steps): a program of
               ``c_allreduce_sum``, ``c_allgather``, ``c_broadcast`` and
               ``c_reducescatter`` through ``Executor.run``, captured
               (``capture_reason`` None, one capture, replays), outputs
               equal to the input, every collective calling NCCL inside
               the capture (``c_reducescatter``: one
               ``reduce_scatter_tensor``), the replay's device work under
               ``torch.profiler``, and what gloo accepts on a CUDA tensor
               in this torch (a report).

Slice 26's phases run inside phase 63's ranks, after their fleet_dp and
fleet_dp_oracle work, and are logged by this process in this order after
fleet_dp_oracle (collective_capture last):

66. fleet_ckpt -- the float32 ZeRO-1 ranks of phase 67 call
               ``save_sharded`` after step 3 through a ``KVBarrier`` on
               this process's KV server (``fleet.utils.KVServer``), each
               rank writing its blocks of the AdamW moments, rank 0 the
               rest; this process restores the checkpoint at one process
               (``load_sharded``) and runs step 4 on the full batch: the
               moments bit-equal to the ranks' blocks, the parameters to
               their digest, the loss within ORACLE_RTOL of the ranks'
               step 4; the save and restore seconds;
67. fleet_zero_oracle -- ``strategy.sharding`` (ZeRO-1) at two ranks,
               float32, dropout 0, phase 64's start and feeds: the
               parameters after 3 steps bit-equal to ``GradAllReduce``'s
               (else within ZERO_PARAM_RTOL norm-wise) and within
               FLEET_UPDATE_RTOL of one process by update, the control
               missing it;
68. fleet_zero -- phase 63's bf16 path with ZeRO-1: a warm-up and
               ZERO_STEPS timed eager steps on each rank; B1 24 a step,
               losses and parameter digests bit-identical across ranks,
               each rank holding half of every AdamW moment (half of
               phase 63's bytes); step p50, peak memory, the all-reduce
               (gloo's reduce-scatter) and all-gather bytes a step;
69. fleet_localsgd -- phase 63's bf16 path with ``strategy.localsgd``
               (``k_steps`` LOCALSGD_K), LOCALSGD_STEPS steps: the main
               step captured on both ranks (reason None, one capture),
               only the averages eager (timed), the ranks' parameter
               digests equal after each average and apart after a step
               in between; B1 24 a step.

Slice 27's phases: fleet_elastic runs inside phase 63's ranks as their
last work (each writes its ``rank<r>.json`` first) and is logged after
fleet_localsgd; spawn runs after collective_capture:

70. fleet_elastic -- each rank publishes a heartbeat (``HealthReporter``,
               every ELASTIC_HEARTBEAT_S) to this process's KV server,
               which serves ``/metrics/cluster`` at world size 2 and
               polls it; each runs phase 67's float32 ZeRO-1 program
               (dropout 0, its start and feeds) under an
               ``ElasticSupervisor`` (a synchronous checkpoint every
               ELASTIC_SAVE_EVERY steps through a ``KVBarrier`` that
               reads the health plane); rank 1 leaves by
               ``os._exit(ELASTIC_EXIT)`` at the start of step
               ELASTIC_KILL; rank 0 learns it from its failed collective
               and the dead-listed heartbeat, re-forms its world at one
               process, restores the step-2 checkpoint and runs step 3 on
               the full batch.  Checked: ``/metrics/cluster`` with both
               ranks alive (step times) before the death and
               ``dead_ranks == [1]`` after; ``recovered``, one re-shard,
               final world 1, at most 2 restarts, an
               ``elastic_topology_change`` bundle; the restored moments
               bit-equal to the two ranks' step-2 blocks; losses within
               ORACLE_RTOL and updates within FLEET_UPDATE_RTOL of phase
               64's one process, the control missing them; B1 24 a step
               at two ranks and at one.  Logged: the seconds from the
               death to the verdict and to the end of step 3, the save
               and restore seconds, the history;
71. spawn   -- ``distributed.spawn(spawn_rank, nprocs=2)``: two rank
               processes over gloo sharing cuda:0, each all-reducing a
               CUDA tensor; rank 0's result (rank, world, backend,
               device, the sum) comes back; ``spawn`` of a function that
               fails on rank 1 raises naming rank 1.

Every phase also logs ``{"phase": "phase_seconds", "name": ...,
"seconds": ...}``, its wall seconds, when it ends.  Then the kernels line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero without the last line; without a CUDA
device it exits 1 before doing anything.
"""
import contextlib
import faulthandler
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# The served model is float32 and every comparison below holds float32
# results to float32 tolerances: a matmul or convolution dropping to TF32
# (about three decimal digits) must fail them, not pass unnoticed.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.amp import decorate  # noqa: E402
from paddle_tpu_torch.framework import (flags, passes,  # noqa: E402
                                        unique_name)
from paddle_tpu_torch.framework import executor as executor_mod  # noqa: E402
from paddle_tpu_torch.framework.program import program_guard  # noqa: E402
from paddle_tpu_torch.native import build  # noqa: E402
from paddle_tpu_torch.monitor import stat_get, stat_reset  # noqa: E402
from paddle_tpu_torch.observe import tracer  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_bias as fab  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import quant_ops as qo  # noqa: E402
from paddle_tpu_torch.serving import (DecodeConfig, DecodeServer,  # noqa: E402
                                      TransformerLM)

SOURCES = {
    "paged_decode_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_chunk_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention_bias": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_fwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "dequant_matmul": "paddle_tpu_torch/csrc/dequant_matmul.cu",
}
REPLACES = {
    "paged_decode_attention": "paddle_tpu/ops/pallas_decode_attention.py:71",
    "paged_chunk_attention": "paddle_tpu/ops/pallas_decode_attention.py:232",
    "flash_attention_bias": "paddle_tpu/ops/pallas_attention.py:34",
    "flash_attention_fwd": "paddle_tpu/ops/flash_attention.py:121",
    "flash_attention_bwd_dq": "paddle_tpu/ops/flash_attention.py:215",
    "flash_attention_bwd_dkv": "paddle_tpu/ops/flash_attention.py:250",
    "dequant_matmul": "paddle_tpu/ops/quant_ops.py:325",
}
# Data-sheet peaks (dense): bytes/s of device memory, and operations/s by
# the input type the kernels compute from (float32 on the CUDA cores;
# bfloat16 and int8 on the tensor cores, the fastest the work could run).
CARDS = (  # (name substring, bytes/s, {dtype: ops/s}); first match wins
    ("H100 PCIe", 2.0e12, {"float32": 51e12, "bfloat16": 756e12,
                           "int8": 1513e12}),
    ("H100 NVL", 3.9e12, {"float32": 60e12, "bfloat16": 835e12,
                          "int8": 1670e12}),
    ("H100", 3.35e12, {"float32": 67e12, "bfloat16": 989e12,
                       "int8": 1979e12}),
)
# Tolerances of kernel vs plain version on the same inputs, per element:
# |kernel - plain| <= TOL + REL_TOL * |plain|.  float32 and int8 pools
# (dequantized exactly in float32 by both): the two differ only in summation
# order over at most 1024 positions.  bfloat16 pool and q: both compute in
# float32 from the same bfloat16 inputs and round the result to bfloat16,
# so they may also sit one bfloat16 step apart, and a step is at most 2**-7
# of the value (8 significant bits).
TOL = {"float32": 3e-5, "int8": 3e-5, "bfloat16": 3e-5}
REL_TOL = {"float32": 0.0, "int8": 0.0, "bfloat16": 2.0 ** -7}
# Streamed logits vs the recompute oracle at full width: the same float32
# model through different kernels and matmul shapes, i.e. summation order
# only, compounded over 8 layers.
LOGIT_TOL = 1e-3
S, H, D, PAGE, PPS = 8, 8, 64, 16, 64
# B1 (flash attention with a streamed bias) against its plain version: the
# same rule, TOL + REL_TOL * |plain| per element.  Both sum in float32 from
# the same inputs over at most 512 keys and round once to q's type, so
# float32 results differ by summation order only, and bfloat16 ones also by
# at most one bfloat16 step.
# (label, B, H, S, D, dtype, bias, causal); the first is the main path's call
FLASH_CASES = (
    ("bert_bf16", 32, 12, 128, 64, "bfloat16", "key", False),
    ("bert_f32", 32, 12, 128, 64, "float32", "key", False),
    ("full_bias_bf16", 32, 12, 128, 64, "bfloat16", "full", False),
    ("causal_no_bias_bf16", 32, 12, 128, 64, "bfloat16", "none", True),
    ("causal_no_bias_f32", 32, 12, 128, 64, "float32", "none", True),
    ("S512_bf16", 8, 12, 512, 64, "bfloat16", "key", False),
    ("D128_bf16", 32, 6, 128, 128, "bfloat16", "key", False),
    ("D256_bf16", 32, 3, 128, 256, "bfloat16", "key", False),
)
# B2-B4 (the flash-attention training kernels) against their plain versions,
# which take the same operands (B3 and B4: the kernel's lse and delta).  The
# forward's out and lse are held to B1's rule.  The gradients are sums over
# up to 512 rows or keys of products of O(1) terms, each carrying the few
# ulps of an exp: float32 within 1e-4 absolute, bfloat16 within that plus one
# bfloat16 step of the value.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-4}
# (label, B, H, S, D, dtype, mask, causal); the first is the main path's call
TRAIN_FLASH_CASES = (
    ("unfused_f32", 32, 12, 128, 64, "float32", "key", False),
    ("unfused_bf16", 32, 12, 128, 64, "bfloat16", "key", False),
    ("unfused_full_mask_f32", 32, 12, 128, 64, "float32", "full", False),
    ("unfused_causal_no_mask_bf16", 32, 12, 128, 64, "bfloat16", "none",
     True),
    ("unfused_S512_bf16", 8, 12, 512, 64, "bfloat16", "key", False),
    ("unfused_D128_bf16", 32, 6, 128, 128, "bfloat16", "key", False),
    # the float32 split at the longest sum and at the second head width
    ("unfused_S512_f32", 8, 12, 512, 64, "float32", "key", False),
    ("unfused_D128_f32", 32, 6, 128, 128, "float32", "key", False),
    # D = 256: B3 and B4 keep their CUDA-core design there
    ("unfused_D256_f32", 32, 3, 128, 256, "float32", "key", False),
)
UNFUSED_STEPS = 6
B2_PER_STEP, B3_PER_STEP, B4_PER_STEP = 24, 12, 12  # 12 layers; B2 replayed
# BERT-base pretraining (bench.py's bench_bert, BASELINE config 3) at full
# width; the batch is cut from the benchmark's 256 to the time limit.
BERT_PREDS, TRAIN_BATCH, ORACLE_BATCH = 20, 32, 8
TRAIN_STEPS = 10
# Eager steps timed beside the captured ones on each training path (the
# eager block, ``Executor._run_block``, called directly).
EAGER_STEPS = 5
HANG_S = 1140     # main's watchdog: stacks and exit 1 past this
B1_PER_STEP = 24   # 12 fused attention ops, each replayed by its gradient
# train oracle: the float32 losses of B1 and of the plain composition, per
# step, within this relative gap (summation order over 3 steps)
ORACLE_RTOL = 1e-4
# At the benchmark's lr (1e-4) the first AdamW steps on one batch overshoot
# (every weight moves by about lr at once) and the loss may rise before it
# falls; the oracle's "the loss fell" check runs at a fine-tuning rate.
ORACLE_LR = 1e-5
# B7 (the dequant-fused matmul) against its plain version (the weight
# dequantized in float32, then a float32 cuBLAS matmul): both multiply the
# same float32 products, the kernel dequantizing each weight element as the
# plain version does, so they differ in summation order over K terms only:
# per element within DEQUANT_TOL * sum_k |x[m, k] * w[k, n]| (about 2**-20,
# 16 float32 ulps of the largest partial sum), plus one bfloat16 step
# (2**-7 * |plain|) where the output is bfloat16.
DEQUANT_TOL = 2.0 ** -20
# (label, M, K, N, x dtype, carrier); the first is the main path's largest
# call (FFN up at batch 32)
DEQUANT_CASES = (
    ("ffn_up_b32_f32_int8", 4096, 768, 3072, "float32", "int8"),
    ("ffn_up_b32_f32_fp8", 4096, 768, 3072, "float32", "fp8_e4m3"),
    ("ffn_up_b32_bf16_int8", 4096, 768, 3072, "bfloat16", "int8"),
    ("ffn_down_b32_f32_int8", 4096, 3072, 768, "float32", "int8"),
    ("qkv_out_b32_f32_int8", 4096, 768, 768, "float32", "int8"),
    ("ffn_up_b1_f32_int8", 128, 768, 3072, "float32", "int8"),
    ("ragged_f32_int8", 100, 300, 70, "float32", "int8"),
    ("pooler_b32_f32_int8", 32, 768, 768, "float32", "int8"),
    ("nsp_b32_f32_fp8", 32, 768, 2, "float32", "fp8_e4m3"),
)
# ResNet-50 training (bench.py's bench_resnet, BASELINE configs 2/4) at full
# width: 224x224x3, the v1.5 trunk, 1000 classes, bf16 AMP, momentum 0.9,
# lr 0.1, the benchmark's batch; a batch whose captured graph and eager
# steps do not fit side by side is halved until they do (logged as reduced).
RESNET_BATCH, RESNET_STEPS, RESNET_IMG = 128, 10, (3, 224, 224)
# The op types the ResNet profile reports on their own.
RESNET_OP_TYPES = ("conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad",
                   "relu", "relu_grad", "cast", "momentum", "sum")
# ResNet oracle: float32 at batch 4, the card against the port's CPU path
# (the path the tier-1 tests hold to the JAX package): each op of a step on
# the card's inputs, and the first step's loss, within 1e-4 of the largest
# magnitude (float32 summation order on cuDNN and on the CPU's kernels; the
# largest seen on an H100, 2e-5, is cuDNN's float32 3x3 filter gradient).
# lr 1e-3, where 3 momentum steps on one batch do not overshoot.
RESNET_ORACLE_BATCH, RESNET_ORACLE_LR, RESNET_ORACLE_RTOL = 4, 1e-3, 1e-4
# The served model (infer phases): BERT-base's encoder and NSP head.
INFER_BATCHES, INFER_RUNS = (1, 8, 32), 10
INFER_MODES = ("", "int8", "fp8_e4m3")
B7_PER_RUN, B1_PER_RUN = 74, 12   # 6 matmuls x 12 layers + pooler + nsp_out
BERT_LAYERS = 12   # the served encoder's layers (layer_scan_infer's stack)
# int8 vs float32 sequence output: the JAX package's bound
# (tests/test_quant_inference.py), a fraction of the output's scale
INT8_QUALITY_BOUND = 0.05
# The card's outputs vs the CPU's plain versions on the same saved model
# and the same carriers: float32 summation order (cuBLAS and B7 against the
# CPU's kernels) compounded over 12 layers of post-LayerNorm values of O(1).
INFER_ORACLE_TOL = 1e-3


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name):
    for key, bw, ops in CARDS:
        if key in name:
            return bw, ops
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


# Cycles the card spins (torch.cuda._sleep, about 1 ms) before each timed
# call, while the host enqueues the call: without it a call whose host work
# (argument checks, allocation, the launch) outlasts the flush is timed at
# the host's pace, not the card's.
HOST_COVER_CYCLES = 2_000_000


def cuda_ms(fn, flush, reps=30, warmup=3):
    """Median milliseconds of ``fn`` on the card by CUDA events, with the
    L2 cache flushed before each timed call (in serving, the other layers'
    pools and the weights evict a layer's pages between its calls) and the
    card kept busy while the host enqueues it, so that the events bracket
    the card's work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def warm_card(dev, seconds=1.0):
    """Keep the card busy until its clocks have left idle: a case timed
    first after an idle spell otherwise runs partly at idle clocks."""
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def phase_device():
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kind=name,
        count=torch.cuda.device_count())
    return name


def phase_build():
    """Build every kernel library; report, from the compiler's own log,
    each library's kernel count, most registers a thread and spill stores,
    with the (mangled) names of the instances that spill."""
    t0 = time.monotonic()
    paths = build.build_all()
    secs = time.monotonic() - t0
    report = {}
    for name, p in paths.items():
        with open(p + ".log") as f:
            text = f.read()
        entries = re.findall(
            r"Compiling entry function '(\S+?)' for.*?(\d+) bytes spill "
            r"stores.*?Used (\d+) registers", text, flags=re.S)
        if not entries:
            raise RuntimeError(f"no kernel in the build log of {name}")
        report[name] = dict(
            kernels=len(entries),
            max_registers=max(int(r) for _n, _s, r in entries),
            spill_store_bytes=sum(int(s) for _n, s, _r in entries),
            spilling={re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                             n): int(s)
                      for n, s, _r in entries if int(s)})
    sass = tensor_core_instructions(paths)
    for name, counts in sass.items():
        report[name]["tensor_core_instructions"] = counts
    flash = {k: n for lib in ("flash_attention", "flash_attention_bwd",
                              "paged_attention")
             for k, n in sass.get(lib, {}).items() if "_mma_kernel" in k}
    bare = [k for k, n in flash.items() if not n]
    if bare:
        raise RuntimeError(f"tensor-core kernels without HMMA: {bare}")
    # B6: 2 q dtypes x 3 pools x D = 32, 64, 128 x 4 or 8 warps
    paged = [k for k in flash if k.startswith("paged_chunk_mma_kernel")]
    if sass and len(paged) != 36:
        raise RuntimeError(f"paged chunk instances on the tensor cores: "
                           f"{paged}, want 36")
    # float32 q at D = 64 and 128, both bias types, B1 and B2
    f32_fwd = [k for k in flash if k.startswith("flash_fwd_mma_kernelIf")]
    if sass and len(f32_fwd) != 8:
        raise RuntimeError(f"float32 forward instances on the tensor "
                           f"cores: {f32_fwd}, want 8")
    log("build", seconds=round(secs, 3), libraries=report,
        f32_forward_instances_with_hmma=len(f32_fwd),
        paged_chunk_instances_with_hmma=len(paged))


def tensor_core_instructions(paths):
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in each kernel whose
    name says it runs on the tensor cores, from ``cuobjdump -sass`` of the
    built libraries; {} where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = {}
    for name, p in paths.items():
        text = subprocess.run([tool, "-sass", p], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts = {}
        for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                   text, flags=re.S):
            short = re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                           fn)
            if "mma" in short:
                counts[short] = len(re.findall(r"\bH(?:G)?MMA\b", body))
        out[name] = counts
    return out


def make_case(gen, dev, rows_per_slot, row_lengths, q_dtype, kv,
              lanes_per_row=1):
    """Random q [S, R, H, D], pools of S/lanes_per_row*PPS+1 pages with
    shuffled ids; each page-table row is repeated over ``lanes_per_row``
    consecutive slots, as the ragged prefill gives each of a request's
    lanes its own copy of the request's row."""
    s = row_lengths.shape[0]
    n_pages = s // lanes_per_row * PPS + 1
    table = (torch.randperm(n_pages - 1, generator=gen) + 1) \
        .reshape(s // lanes_per_row, PPS) \
        .repeat_interleave(lanes_per_row, dim=0).to(torch.int32)
    q = torch.randn(s, rows_per_slot, H, D, generator=gen).to(q_dtype)
    kf = torch.randn(n_pages, PAGE, H, D, generator=gen)
    vf = torch.randn(n_pages, PAGE, H, D, generator=gen)
    ks = vs = None
    if kv == "int8":
        from paddle_tpu_torch.serving.kv_cache import quantize_kv

        kp, ks = quantize_kv(kf)
        vp, vs = quantize_kv(vf)
    else:
        dt = getattr(torch, kv)
        kp, vp = kf.to(dt), vf.to(dt)
    to = (lambda t: None if t is None else t.to(dev).contiguous())
    return dict(q=to(q), k_pages=to(kp), v_pages=to(vp), page_table=to(table),
                row_lengths=to(row_lengths.to(torch.int32)), k_scales=to(ks),
                v_scales=to(vs))


def piece_products(a, b):
    """bfloat16 products of one float32-exact product on the tensor cores
    (csrc/mma_common.cuh mma_pieces): the piece pairs (i, j) of a's ``a``
    and b's ``b`` pieces with i + j < max(a, b)."""
    return sum(1 for i in range(a) for j in range(b) if i + j < max(a, b))


def chunk_products(q_dtype, kv):
    """B6's bfloat16 products a (row, position) pair (paged_chunk_mma_kernel):
    S over q's pieces (3 float32, 1 bfloat16) and K's (3 for a float32
    pool, 1 for bfloat16 and int8), P V over P's two and V's."""
    pq = 3 if q_dtype == torch.float32 else 1
    pk = 3 if kv == "float32" else 1
    return piece_products(pq, pk) + piece_products(2, pk)


def case_bound(c, kv, peaks, chunk=False):
    """Least time for the work of one call: each input read once (q, the
    live K/V -- and scales -- of each distinct page, as far as the widest
    row that reads it, the live page-table entries, the lengths), the
    output written once; operations
    4*H*D per live (row, position) pair (QK and PV, multiply-add each) at
    the peak of the pool's type.  B6 (``chunk``) runs on the tensor cores:
    its operations are the design's bfloat16 products (chunk_products, 2*D
    each) at the bfloat16 peak, and the float32 CUDA-core figure (the
    larger of the bytes and 4*H*D a pair at the float32 peak) comes third.
    Returns (ms, "bytes" or "operations", the CUDA-core figure or None)."""
    bw, ops_rate = peaks
    q, lens = c["q"], c["row_lengths"].long().clamp(min=0, max=PAGE * PPS)
    widest = lens.max(dim=1).values
    # positions read from each page: slots that share a page (the ragged
    # lanes of one request) read it once
    used = (widest[:, None] - PAGE * torch.arange(
        PPS, device=widest.device)[None]).clamp(0, PAGE)
    page_pos = torch.zeros(c["k_pages"].shape[0], dtype=used.dtype,
                           device=used.device).scatter_reduce(
        0, c["page_table"].long().flatten(), used.flatten(), "amax")
    kv_elt = c["k_pages"].element_size()
    per_pos = 2 * H * D * kv_elt + (2 * H * 4 if kv == "int8" else 0)
    nbytes = (2 * q.numel() * q.element_size()
              + int(page_pos.sum()) * per_pos
              + int(((widest + PAGE - 1) // PAGE).sum()) * 4
              + lens.numel() * 4)
    pairs = H * int(lens.sum())
    t_bytes = nbytes / bw * 1e3
    t_ops = 4 * D * pairs / ops_rate[kv] * 1e3
    f32_cuda_core = None
    if chunk:
        f32_cuda_core = max(t_bytes, 4 * D * pairs / ops_rate["float32"] * 1e3)
        t_ops = chunk_products(q.dtype, kv) * 2 * D * pairs \
            / ops_rate["bfloat16"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (f32_cuda_core,)


def sdpa_inputs(c, kv):
    """The yardstick's inputs: K/V gathered to dense [S, H, T, D] (int8
    dequantized), q [S, H, R, D], a boolean mask [S, 1, R, T]."""
    k = pa._gather_dequant(c["k_pages"], c["k_scales"], c["page_table"])
    v = pa._gather_dequant(c["v_pages"], c["v_scales"], c["page_table"])
    dt = c["q"].dtype
    k, v = k.to(dt).transpose(1, 2).contiguous(), \
        v.to(dt).transpose(1, 2).contiguous()
    q = c["q"].transpose(1, 2).contiguous()
    t = torch.arange(k.shape[2], device=k.device)
    mask = (t[None, None, :] < c["row_lengths"].long()[:, :, None])[:, None]
    return q, k, v, mask


def check_close(label, out, ref, want_dtype, kind, tol=None):
    """Max abs error of a kernel's output against its plain version's;
    raises beyond ``tol + REL_TOL[kind] * |plain|`` per element (``tol``
    is ``TOL[kind]`` unless given)."""
    tol = TOL[kind] if tol is None else tol
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != want_dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype},"
                           f" want {tuple(ref.shape)} {want_dtype}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - REL_TOL[kind] * ref.float().abs()).max())
    if not math.isfinite(err) or excess > tol:
        raise RuntimeError(f"{label}: kernel vs plain differ by {err} (max "
                           f"abs), beyond {tol} + {REL_TOL[kind]}"
                           f"*|plain|")
    return err


def tolerance_share(out, ref, kind, tol=None):
    """The largest |kernel - plain| over its allowance TOL + REL_TOL *
    |plain| (``tol`` instead of TOL[kind] if given): 1 is the limit."""
    tol = TOL[kind] if tol is None else tol
    diff = (out.float() - ref.float()).abs()
    return float((diff / (tol + REL_TOL[kind] * ref.float().abs())).max())


def run_case(label, kernel, c, kv, peaks, flush):
    decode = kernel == "paged_decode_attention"
    args = dict(c)
    lens = args.pop("row_lengths")
    q = args.pop("q")
    if decode:
        q, lens = q[:, 0].contiguous(), lens[:, 0].contiguous()
        fn = pa.paged_decode_attention
        plain = pa.paged_decode_attention_reference
    else:
        fn = pa.paged_chunk_attention
        plain = pa.paged_chunk_attention_reference
    out = fn(q, args["k_pages"], args["v_pages"], args["page_table"], lens,
             k_scales=args["k_scales"], v_scales=args["v_scales"])
    ref = plain(q, args["k_pages"], args["v_pages"], args["page_table"], lens,
                k_scales=args["k_scales"], v_scales=args["v_scales"])
    err = check_close(label, out, ref, q.dtype, kv)
    share = tolerance_share(out, ref, kv)
    kw = dict(k_scales=args["k_scales"], v_scales=args["v_scales"])
    ms = cuda_ms(lambda: fn(q, args["k_pages"], args["v_pages"],
                            args["page_table"], lens, **kw), flush)
    plain_ms = cuda_ms(lambda: plain(q, args["k_pages"], args["v_pages"],
                                     args["page_table"], lens, **kw), flush)
    sq, sk, sv, mask = sdpa_inputs(c, kv)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush)
    bound_ms, bound_by, f32_bound_ms = case_bound(c, kv, peaks,
                                                  chunk=not decode)
    row = dict(case=label, kernel=kernel, pool=kv, q=str(q.dtype)[6:],
               shape=list(c["q"].shape), max_abs_err=err, tolerance=TOL[kv],
               rel_tolerance=REL_TOL[kv], err_share_of_tolerance=share,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if f32_bound_ms is not None:
        row["f32_cuda_core_bound_ms"] = f32_bound_ms
    log("kernels", **row)
    return row


def paged_cases(gen, dev):
    """B5's and B6's cases at the serving path's shapes, made in turn from
    ``gen``: (label, kernel, inputs, pool dtype).  Decode: the serve
    burst's 8 slots of mixed lengths in each pool, one request alone, every
    slot at the table's width, and 64 slots at the ragged lanes' lengths.
    Chunk: a 16-row chunk, the whole-prompt buckets (causal rows 1..R,
    R = 128 .. 1024; 512 in each pool), speculative verify (8 slots x 4
    rows), the ragged prefill's 64 one-row lanes (``chunk_S64_R1``), the
    chunked prefill's 128-row chunk at offset 512."""
    decode_lens = torch.tensor([1, 15, 16, 17, 500, 1024, 250, 777])
    for kv, qd in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                   ("int8", torch.float32)):
        yield (f"decode_{kv}", "paged_decode_attention",
               make_case(gen, dev, 1, decode_lens[:, None], qd, kv), kv)
    chunk16 = (496 + torch.arange(1, 17))[None]          # one chunk
    verify = decode_lens.clamp(max=1020)[:, None] + torch.arange(4)[None]

    def prefill(r):                                       # whole prompt
        return torch.arange(1, r + 1)[None]
    for label, lens, kv, qd in (
            ("chunk_S1_R16", chunk16, "float32", torch.float32),
            ("chunk_S1_R1024", prefill(1024), "float32", torch.float32),
            ("chunk_S8_R4", verify, "float32", torch.float32),
            ("chunk_S8_R4_int8", verify, "int8", torch.float32)):
        yield (label, "paged_chunk_attention",
               make_case(gen, dev, lens.shape[1], lens, qd, kv), kv)
    # the ragged prefill's 64 one-row lanes: 4 prompts' 16-lane shares,
    # each lane with its own copy of its request's page-table row
    lanes = (torch.tensor([0, 112, 256, 496]).repeat_interleave(16)
             + torch.arange(16).repeat(4) + 1)[:, None]
    for label, lens in (("decode_S1", torch.tensor([[777]])),
                        ("decode_all1024", torch.full((8, 1), 1024))):
        yield (label, "paged_decode_attention",
               make_case(gen, dev, 1, lens, torch.float32, "float32"),
               "float32")
    for label, kernel in (("decode_S64", "paged_decode_attention"),
                          ("chunk_S64_R1", "paged_chunk_attention")):
        yield (label, kernel, make_case(gen, dev, 1, lanes, torch.float32,
                                        "float32", lanes_per_row=16),
               "float32")
    for label, lens, kv, qd in (
            ("chunk_S1_R128", prefill(128), "float32", torch.float32),
            ("chunk_S1_R256", prefill(256), "float32", torch.float32),
            ("chunk_S1_R512", prefill(512), "float32", torch.float32),
            ("chunk_S1_R128_at512", 512 + prefill(128), "float32",
             torch.float32),
            ("chunk_S1_R512_bf16", prefill(512), "bfloat16", torch.bfloat16),
            ("chunk_S1_R512_int8", prefill(512), "int8", torch.float32)):
        yield (label, "paged_chunk_attention",
               make_case(gen, dev, lens.shape[1], lens, qd, kv), kv)


def check_paged_edges(gen, dev):
    """Untimed, in split grids: rows of length 0 give exactly 0 (a zero-
    length slot beside a 1024-length one, zero-length rows among live
    ones), lengths that end on a page boundary, and lengths past the
    table's width (clamped), in B5 and in B6 over each pool (B6 also
    with float32 q over a bfloat16 pool); each within its tolerance of
    the plain version."""
    width = PAGE * PPS
    dec = torch.tensor([0, width, PAGE, 2 * PAGE, width + 976, 0, 1, 512])
    rows_a = torch.tensor([0, width] * 8)                 # slot 0
    rows_b = torch.tensor([PAGE * (i + 1) for i in range(15)] +
                          [width + 500])                  # slot 1
    chunk = torch.stack([rows_a, rows_b])
    chunk[0, 3] = 0
    errs = {}
    for label, kernel, lens, kv, qd in (
            ("edges_decode_f32", "paged_decode_attention", dec[:, None],
             "float32", torch.float32),
            ("edges_decode_int8", "paged_decode_attention", dec[:, None],
             "int8", torch.float32),
            ("edges_chunk_f32", "paged_chunk_attention", chunk, "float32",
             torch.float32),
            ("edges_chunk_bf16", "paged_chunk_attention", chunk, "bfloat16",
             torch.bfloat16),
            ("edges_chunk_f32q_bf16", "paged_chunk_attention", chunk,
             "bfloat16", torch.float32),
            ("edges_chunk_int8", "paged_chunk_attention", chunk, "int8",
             torch.float32)):
        c = make_case(gen, dev, lens.shape[1], lens, qd, kv)
        q, lv = c["q"], c["row_lengths"]
        if kernel == "paged_decode_attention":
            q, lv = q[:, 0].contiguous(), lv[:, 0].contiguous()
            fn, plain = pa.paged_decode_attention, \
                pa.paged_decode_attention_reference
        else:
            fn, plain = pa.paged_chunk_attention, \
                pa.paged_chunk_attention_reference
        args = (q, c["k_pages"], c["v_pages"], c["page_table"], lv)
        kw = dict(k_scales=c["k_scales"], v_scales=c["v_scales"])
        out, ref = fn(*args, **kw), plain(*args, **kw)
        # float32 q over a bfloat16 pool: a float32 result from the same
        # bfloat16 K/V, held to the float32 rule
        kind = "float32" if qd == torch.float32 and kv == "bfloat16" else kv
        errs[label] = check_close(label, out, ref, q.dtype, kind)
        dead = lv == 0
        if not bool((out[dead] == 0).all()):
            raise RuntimeError(f"{label}: a row of length 0 is not 0")
    log("kernels", case="paged_edges", zero_rows_exactly_0=True,
        max_abs_err=errs)


def phase_kernels(name):
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    peaks = card_peaks(name)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    warm_card(dev)
    clocks = "clocks.sm,power.draw,temperature.gpu"
    log("clocks", at="kernels start", **{clocks: nvidia_smi(clocks)})
    rows = [run_case(label, kernel, c, kv, peaks, flush)
            for label, kernel, c, kv in paged_cases(gen, dev)]
    check_paged_edges(gen, dev)
    for case in FLASH_CASES:
        rows.append(run_flash_case(gen, dev, case, peaks, flush))
    for case in TRAIN_FLASH_CASES:
        rows += run_train_flash_case(gen, dev, case, peaks, flush)
    check_dead_rows(gen, dev)
    check_b1_dead_rows(gen, dev)
    for case in DEQUANT_CASES:
        rows.append(run_dequant_case(gen, dev, case, peaks, flush))
    check_zero_channel(gen, dev)
    check_non_finite_x(gen, dev)
    del l2
    log("clocks", at="kernels end", **{clocks: nvidia_smi(clocks)})
    return rows


def phase_serve():
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    model = TransformerLM(vocab_size=32000, d_model=512, num_layers=8,
                          num_heads=8, ffn_dim=2048, max_seq_len=1024,
                          device=dev)
    weights = model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    prefix = rng.randint(1, 32000, 256).tolist()
    prompts = [rng.randint(1, 32000, n).tolist()
               for n in (100, 180, 260, 340, 420, 600)]
    shared_a = prefix + rng.randint(1, 32000, 90).tolist()
    shared_b = prefix + rng.randint(1, 32000, 150).tolist()
    long_prompt = rng.randint(1, 32000, 700).tolist()
    kw = dict(max_new_tokens=32, record_logits=True)
    srv = DecodeServer(model, weights, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16)).start()
    try:
        # one short request first: the numbers below are of a warm
        # process (cuBLAS handles, the kernel library, allocator pools)
        srv.submit(rng.randint(1, 32000, 64).tolist(),
                   max_new_tokens=4).result(timeout=600)
        torch.cuda.synchronize()
        flags.set_flags({"enable_tracer": True})
        tracer.clear()
        pa.reset_launch_counts()    # the main path's counts start here
        t0 = time.monotonic()
        reqs = [srv.submit(p, **kw) for p in prompts]
        req_a = srv.submit(shared_a, **kw)
        req_a.result(timeout=600)   # registers the prefix pages
        req_b = srv.submit(shared_b, **kw)
        for r in reqs + [req_b]:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        spans = tracer.snapshot()
        stats = srv.stats()
    finally:
        srv.stop()
    chunked = DecodeServer(model, None, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16,
        prefill_chunk_pages=8)).start()
    try:
        req_long = chunked.submit(long_prompt, **kw)
        req_long.result(timeout=600)
        chunked_stats = chunked.stats()
    finally:
        chunked.stop()
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_chunk_attention": pa.paged_chunk_attention.launches}
    flags.set_flags({"enable_tracer": False})

    captured = [e._step is not None and e._step.graph is not None
                for e in srv.replicas + chunked.replicas]
    if not all(captured):
        raise RuntimeError(f"a serving engine did not capture its decode "
                           f"step: {captured}")
    if stats["cache_hit_rate"] <= 0 or chunked_stats["prefill_chunks"] < 2:
        raise RuntimeError(f"a path was not taken: prefix hit rate "
                           f"{stats['cache_hit_rate']}, prefill chunks "
                           f"{chunked_stats['prefill_chunks']}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was never launched on the main path")
    all_reqs = [(p, r) for p, r in zip(prompts + [shared_a, shared_b],
                                       reqs + [req_a, req_b])]
    all_reqs.append((long_prompt, req_long))
    oracle_err, logit_scale = 0.0, 0.0
    eng = chunked.replicas[0]
    for prompt, r in all_reqs:
        n = len(r.generated)
        if n != 32 or len(r.logits_trace) != n or \
                not all(0 <= t < 32000 for t in r.generated):
            raise RuntimeError(f"bad output: {n} tokens, "
                               f"{len(r.logits_trace)} logit rows")
        for i in sorted({0, n // 2, n - 1}):
            got = r.logits_trace[i]
            if got.shape != (32000,) or not np.isfinite(got).all() \
                    or np.ptp(got) == 0:
                raise RuntimeError(f"logits {got.shape} not finite, or "
                                   f"all equal")
            want = eng.recompute_logits(prompt + r.generated[:i])
            oracle_err = max(oracle_err, float(np.abs(got - want).max()))
            logit_scale = max(logit_scale, float(np.abs(want).max()))
    if oracle_err > LOGIT_TOL:
        raise RuntimeError(f"streamed logits vs recompute_logits: max abs "
                           f"{oracle_err} > {LOGIT_TOL}")
    step_ms = [1e3 * sp.duration for sp in spans
               if sp.name == "serving/decode_step"]
    prefill_ms = [1e3 * sp.duration for sp in spans
                  if sp.name == "serving/decode_prefill"]
    ttft_ms = [1e3 * (r.t_first_token - r.t_enqueue)
               for _p, r in all_reqs[:-1]]
    n_tokens = sum(len(r.generated) for _p, r in all_reqs[:-1])
    log("serve", requests=len(all_reqs), tokens=n_tokens,
        tokens_per_s=n_tokens / wall, wall_s=wall,
        decode_step_p50_ms=float(np.median(step_ms)),
        decode_steps=len(step_ms), ttft_p50_ms=float(np.median(ttft_ms)),
        prefill_p50_ms=float(np.median(prefill_ms)),
        prefills=len(prefill_ms),
        prefix_hit_rate=stats["cache_hit_rate"],
        prefill_chunks=chunked_stats["prefill_chunks"],
        logits_vs_oracle_max_abs=oracle_err, tolerance=LOGIT_TOL,
        oracle_logits_max_abs=logit_scale, decode_step_captured=captured,
        capture_reason=None, launches=launches)
    return launches, model


def device_time_by_kernel(prof):
    """Device microseconds by kernel (and copy) name from a profile; the
    card runs one stream here, so the intervals do not overlap.  A
    profiler range also shows on the device's timeline, spanning the
    kernels launched inside it: it is not a kernel, and is left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.replace("(anonymous namespace)::", "")
            key = re.sub(r"\(.*", "", name)[:80]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    return by_name


# (label, name part) of the paged kernels in a serving profile
PAGED_PROFILE_KERNELS = (("b5", "paged_decode_kernel"),
                         ("b6", "paged_chunk_mma_kernel"),
                         ("combine", "paged_combine_kernel"))


def serve_window(model, eager, profiled):
    """8 requests (300-token prompts, 24 new tokens, greedy) through a
    fresh ``DecodeServer`` on the card, after a short warm-up request
    (whose first two decode steps are the warm-up and the capture).
    ``eager``: the engine's step calls the eager block
    (``_decode_forward``) directly instead of replaying its graph.
    Returns the window's report, the requests, and with ``profiled`` the
    profile and the window's host microseconds."""
    from paddle_tpu_torch.framework import graphs

    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 32000, 300).tolist() for _ in range(8)]
    srv = DecodeServer(model, None, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16)).start()
    eng = srv.replicas[0]
    if eager:
        eng._decode_step = lambda *a: eng._decode_forward(
            eng.model, eng._cache.target, *eng._upload(*a))
    prof = wall_us = None
    try:
        _r, peak = peak_gb(lambda: srv.submit(
            prompts[0][:64], max_new_tokens=4).result(timeout=600))
        flags.set_flags({"enable_tracer": True})
        tracer.clear()
        before = graphs.launch_counts()

        def window():
            reqs = [srv.submit(p, max_new_tokens=24, record_logits=True)
                    for p in prompts]
            for r in reqs:
                r.result(timeout=600)
            return reqs
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                reqs = window()
                torch.cuda.synchronize()
                wall_us = (time.monotonic() - t0) * 1e6
        else:
            reqs, window_peak = peak_gb(window)
            peak = max(peak, window_peak)
        spans = tracer.snapshot()
        after = graphs.launch_counts()
    finally:
        flags.set_flags({"enable_tracer": False})
        srv.stop()
    steps = [1e3 * sp.duration for sp in spans
             if sp.name == "serving/decode_step"]
    b5 = after[4] - before[4]
    captured = eng._step is not None and eng._step.graph is not None
    if captured == eager or b5 != 8 * len(steps):
        raise RuntimeError(f"serve window (eager={eager}): captured "
                           f"{captured}, {b5} B5 launches in {len(steps)} "
                           f"decode steps, want 8 a step")
    report = dict(decode_step_p50_ms=float(np.median(steps)),
                  decode_steps=len(steps), b5_launches_per_step=b5 /
                  len(steps), peak_memory_gb=None if profiled else peak)
    return report, reqs, prof, wall_us


def logit_gap(a, b):
    """Largest |a - b| over two windows' streamed logits, each request up
    to its first token that differs."""
    gap = 0.0
    for ra, rb in zip(a, b):
        for i, (la, lb) in enumerate(zip(ra.logits_trace, rb.logits_trace)):
            gap = max(gap, float(np.abs(la - lb).max()))
            if ra.generated[i] != rb.generated[i]:
                break
    return gap


def phase_profile(model):
    """Where a decode-heavy window's time goes, captured and eager: the
    window of ``serve_window`` timed (decode step p50, peak memory) and
    under torch.profiler (the device's busy time, the sum of its kernel
    and copy intervals, against the host clock around the window; its
    time by kernel; B5's, B6's and their merge's device time and share of
    busy), and the two modes' streamed logits against each other."""
    out, reqs = {}, {}
    for mode in ("captured", "eager"):
        report, reqs[mode], _p, _w = serve_window(model, mode == "eager",
                                                  False)
        _r, _q, prof, wall_us = serve_window(model, mode == "eager", True)
        by_name = device_time_by_kernel(prof)
        busy_us = sum(by_name.values())
        ours, matched = kernel_share(by_name, PAGED_PROFILE_KERNELS,
                                     f"{mode} serving window")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[mode] = dict(
            report, window_ms=wall_us / 1e3,
            device_busy_ms=busy_us / 1e3,
            device_busy_share=busy_us / wall_us,
            **{f"{label}_device_ms": t / 1e3 for label, t in ours.items()},
            **{f"{label}_share_of_busy": t / busy_us
               for label, t in ours.items()},
            b5_b6_combine_device_ms=sum(ours.values()) / 1e3,
            kernels_matched=matched,
            top_device_ms={k: v / 1e3 for k, v in top})
    gap = logit_gap(reqs["captured"], reqs["eager"])
    log("profile", tokens=8 * 24, capture_reason=None,
        logits_captured_vs_eager_max_abs=gap, tolerance=LOGIT_TOL, **out)
    if not gap <= LOGIT_TOL:
        raise RuntimeError(f"captured vs eager decode logits apart by {gap}"
                           f" > {LOGIT_TOL}")


# ---- B1 and the static-graph training path ----------------------------------


def flash_case(gen, dev, b, h, s, d, dtype, bias):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dt).to(dev)
               for _ in range(3))
    if bias == "key":       # BERT's additive key mask: 0 keep, -1e4 pad
        keep = torch.rand(b, 1, 1, s, generator=gen) > 0.1
        bias_t = torch.where(keep, 0.0, -1e4)
    elif bias == "full":
        bias_t = torch.randn(b, h, s, s, generator=gen)
    else:
        bias_t = None
    return q, k, v, None if bias_t is None else bias_t.to(dt).to(dev)


# The float32 forward (B1, B2) on the tensor cores (D = 64 and 128; D = 256
# keeps the CUDA cores): q, k, v split into three bfloat16 pieces and P into
# two, the piece pairs with i + j <= 2 -- 6 products for S, 5 for P V
# (csrc/flash_attention.cu).
FWD_F32_PRODUCTS = 6 + 5


def flash_bound(q, bias, causal, peaks, extra_bytes=0):
    """Least time for one forward call (B1; B2 with its lse as
    ``extra_bytes``): q, k, v and the bias (in its natural shape) read
    once, the output written once; 4*D operations (QK and PV, multiply-add
    each) per (query, key) pair the mask leaves, at the peak of the
    inputs' type.  Float32 at D <= 128 runs on the tensor cores: its
    operations are the split's bfloat16 products (FWD_F32_PRODUCTS, 2*D
    each) at the bfloat16 peak.  Returns (ms, "bytes" or "operations", the
    float32 CUDA-core figure -- the larger of the bytes and 4*D a pair at
    the float32 peak -- or None)."""
    bw, ops_rate = peaks
    b, h, s, d = q.shape
    nbytes = 4 * q.numel() * q.element_size() + extra_bytes
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    dtype = str(q.dtype)[6:]
    t_bytes = nbytes / bw * 1e3
    t_ops = 4 * d * pairs / ops_rate[dtype] * 1e3
    f32_cuda_core = None
    if dtype == "float32" and d <= 128:
        f32_cuda_core = max(t_bytes, t_ops)
        t_ops = FWD_F32_PRODUCTS * 2 * d * pairs / ops_rate["bfloat16"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (f32_cuda_core,)


def run_flash_case(gen, dev, case, peaks, flush):
    label, b, h, s, d, dtype, bias_kind, causal = case
    q, k, v, bias = flash_case(gen, dev, b, h, s, d, dtype, bias_kind)
    kw = dict(sm_scale=1.0 / math.sqrt(d), causal=causal)
    out = fab.flash_attention_bias(q, k, v, bias, **kw)
    ref = fab.flash_attention_bias_reference(q, k, v, bias, **kw)
    err = check_close(label, out, ref, q.dtype, dtype)
    share = tolerance_share(out, ref, dtype)
    ms = cuda_ms(lambda: fab.flash_attention_bias(q, k, v, bias, **kw), flush)
    plain_ms = cuda_ms(lambda: fab.flash_attention_bias_reference(
        q, k, v, bias, **kw), flush)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, is_causal=causal, scale=kw["sm_scale"]),
        flush)
    bound_ms, bound_by, f32_bound_ms = flash_bound(q, bias, causal, peaks)
    row = dict(case=label, kernel="flash_attention_bias", q=dtype,
               shape=[b, h, s, d], bias=bias_kind, causal=causal,
               max_abs_err=err, tolerance=TOL[dtype],
               rel_tolerance=REL_TOL[dtype], err_share_of_tolerance=share,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if f32_bound_ms is not None:
        row["f32_cuda_core_bound_ms"] = f32_bound_ms
    log("kernels", **row)
    return row


# The float32 backward (B3, B4) on the tensor cores (D = 64 and 128; D = 256
# keeps the CUDA cores): each float32 product is taken as the bfloat16
# products of the operands' three pieces and of P's and dS's two with
# i + j <= 2 -- 6 for S and for dP, 5 for each second product
# (csrc/flash_attention_bwd.cu).
BWD_F32_PRODUCTS = {"flash_attention_bwd_dq": 6 + 6 + 5,
                    "flash_attention_bwd_dkv": 6 + 6 + 5 + 5}


def train_flash_bounds(q, mask, causal, peaks):
    """Least times for B2, B3 and B4 on one call's operands: name -> (ms,
    "bytes" or "operations", the float32 CUDA-core figure or None).
    Bytes: q, k, v (and do, lse, delta for the backward) and the mask in
    its natural shape read once, each output written once.  Operations per
    (query, key) pair the mask leaves, multiply-add each: 4*D in B2 (QK,
    PV), 6*D in B3 (S, dP, dQ), 8*D in B4 (S, dV, dP, dK), at the peak of
    the inputs' type.  Float32 B2, B3 and B4 at D <= 128 run on the tensor
    cores: their operations are the split's bfloat16 products
    (FWD_F32_PRODUCTS, BWD_F32_PRODUCTS, 2*D each) at the bfloat16 peak,
    with the float32 CUDA-core figure (the larger of the bytes and 4*D,
    6*D or 8*D at the float32 peak) beside it."""
    bw, ops_rate = peaks
    b, h, s, d = q.shape
    tensor = q.numel() * q.element_size()
    stat = b * h * s * 4                      # lse or delta, float32
    mask_b = 0 if mask is None else mask.numel() * mask.element_size()
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    dtype = str(q.dtype)[6:]
    out = {"flash_attention_fwd": flash_bound(q, mask, causal, peaks,
                                              extra_bytes=stat)}
    for name, nbytes, per_pair in (
            ("flash_attention_bwd_dq", 5 * tensor + 2 * stat + mask_b, 6 * d),
            ("flash_attention_bwd_dkv", 6 * tensor + 2 * stat + mask_b,
             8 * d)):
        t_bytes = nbytes / bw * 1e3
        t_ops = per_pair * pairs / ops_rate[dtype] * 1e3
        f32_cuda_core = None
        if dtype == "float32" and d <= 128:
            f32_cuda_core = max(t_bytes, t_ops)
            t_ops = BWD_F32_PRODUCTS[name] * 2 * d * pairs \
                / ops_rate["bfloat16"] * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations")) + (f32_cuda_core,)
    return out


def run_train_flash_case(gen, dev, case, peaks, flush):
    """B2, B3 and B4 on one set of operands: each against its plain
    version, timed beside it and beside the library's call."""
    label, b, h, s, d, dtype, mask_kind, causal = case
    q, k, v, mask = flash_case(gen, dev, b, h, s, d, dtype, mask_kind)
    do = torch.randn(b, h, s, d, generator=gen).to(q.dtype).to(dev)
    scale = 1.0 / math.sqrt(d)
    fwd_args = (q, k, v, mask, scale, causal)
    out, lse = fa.flash_attention_fwd(*fwd_args)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(*fwd_args)
    delta = (do.float() * out.float()).sum(-1)
    bwd_args = (q, k, v, mask, do, lse, delta, scale, causal)
    dq = fa.flash_attention_bwd_dq(*bwd_args)
    dk, dv = fa.flash_attention_bwd_dkv(*bwd_args)
    ref_dq = fa.flash_attention_bwd_dq_reference(*bwd_args)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(*bwd_args)
    tol = BWD_TOL[dtype]
    errs = {
        "flash_attention_fwd": max(
            check_close(label + " out", out, ref_out, q.dtype, dtype),
            check_close(label + " lse", lse, ref_lse, torch.float32,
                        "float32")),
        "flash_attention_bwd_dq": check_close(
            label + " dq", dq, ref_dq, q.dtype, dtype, tol),
        "flash_attention_bwd_dkv": max(
            check_close(label + " dk", dk, ref_dk, q.dtype, dtype, tol),
            check_close(label + " dv", dv, ref_dv, q.dtype, dtype, tol)),
    }
    shares = {
        "flash_attention_fwd": max(
            tolerance_share(out, ref_out, dtype),
            tolerance_share(lse, ref_lse, "float32")),
        "flash_attention_bwd_dq": tolerance_share(dq, ref_dq, dtype, tol),
        "flash_attention_bwd_dkv": max(
            tolerance_share(dk, ref_dk, dtype, tol),
            tolerance_share(dv, ref_dv, dtype, tol)),
    }
    fns = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(*fwd_args),
            lambda: fa.flash_attention_fwd_reference(*fwd_args)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*bwd_args),
            lambda: fa.flash_attention_bwd_dq_reference(*bwd_args)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*bwd_args),
            lambda: fa.flash_attention_bwd_dkv_reference(*bwd_args)),
    }
    # the yardsticks: SDPA's forward for B2; for B3 and B4 together, one
    # pull-back through SDPA's graph, which gives dq, dk and dv
    sdpa_kw = dict(attn_mask=mask, is_causal=causal, scale=scale)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa_kw), flush)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True), flush)
    del sdpa_out, leaves
    bounds = train_flash_bounds(q, mask, causal, peaks)
    rows = []
    for kernel, (fn, plain) in fns.items():
        bound_ms, bound_by, f32_bound_ms = bounds[kernel]
        backward = kernel != "flash_attention_fwd"
        row = dict(case=label, kernel=kernel, q=dtype, shape=[b, h, s, d],
                   mask=mask_kind, causal=causal, max_abs_err=errs[kernel],
                   tolerance=tol if backward else TOL[dtype],
                   rel_tolerance=REL_TOL[dtype],
                   err_share_of_tolerance=shares[kernel],
                   ms=cuda_ms(fn, flush),
                   plain_ms=cuda_ms(plain, flush),
                   library_ms=lib_bwd if backward else lib_fwd,
                   library="sdpa backward (dq, dk, dv in one call)"
                   if backward else "sdpa forward",
                   bound_ms=bound_ms, bound_by=bound_by)
        if f32_bound_ms is not None:
            row["f32_cuda_core_bound_ms"] = f32_bound_ms
        log("kernels", **row)
        rows.append(row)
    return rows


def check_dead_rows(gen, dev):
    """Rows whose mask is -inf everywhere (softmax denominator 0): B2 must
    give out 0 and lse -1e30 there, and B3/B4 finite gradients with dq 0 on
    those rows, each equal to its plain version within the float32
    tolerances above."""
    b, h, s, d, dead = 2, 2, 128, 64, [5, 77]
    q, k, v, _ = flash_case(gen, dev, b, h, s, d, "float32", "none")
    do = torch.randn(b, h, s, d, generator=gen).to(dev)
    mask = torch.zeros(b, 1, s, s, device=dev)
    mask[:, :, dead, :] = float("-inf")
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, scale, False)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, mask, scale,
                                                        False)
    delta = (do * out).sum(-1)
    args = (q, k, v, mask, do, lse, delta, scale, False)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    ref_dq = fa.flash_attention_bwd_dq_reference(*args)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(*args)
    errs = [check_close("dead_rows " + n, x, r, torch.float32, "float32", t)
            for n, x, r, t in (("out", out, ref_out, None),
                               ("lse", lse, ref_lse, None),
                               ("dq", dq, ref_dq, BWD_TOL["float32"]),
                               ("dk", dk, ref_dk, BWD_TOL["float32"]),
                               ("dv", dv, ref_dv, BWD_TOL["float32"]))]
    if not (bool((out[:, :, dead] == 0).all())
            and bool((lse[:, :, dead] == -1e30).all())
            and bool((dq[:, :, dead] == 0).all())):
        raise RuntimeError("dead rows: out, dq not 0 or lse not -1e30")
    log("kernels", case="dead_rows_f32", kernel="flash_attention_fwd+bwd",
        shape=[b, h, s, d], dead_rows=dead,
        max_abs_err_out_lse_dq_dk_dv=errs, out_is_0=True,
        lse_is_minus_1e30=True, dq_is_0=True)


def check_b1_dead_rows(gen, dev):
    """B1 (bfloat16 and float32, both on the tensor cores) on rows whose
    bias is -inf at every key (softmax denominator 0): out exactly 0
    there, as the TPU kernel's l == 0 guard gives, and elsewhere within
    B1's tolerance of B2's plain version, which computes the same function
    with that guard (B1's plain version, a softmax, gives NaN on such
    rows)."""
    b, h, s, d, dead = 2, 2, 128, 64, [5, 77]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v, _ = flash_case(gen, dev, b, h, s, d, dtype, "none")
        bias = torch.zeros(b, 1, s, s, device=dev, dtype=dt)
        bias[:, :, dead, :] = float("-inf")
        scale = 1.0 / math.sqrt(d)
        out = fab.flash_attention_bias(q, k, v, bias, sm_scale=scale)
        ref, _lse = fa.flash_attention_fwd_reference(q, k, v, bias, scale,
                                                     False)
        label = f"dead_rows_b1_{dtype}"
        err = check_close(label + " out", out, ref, dt, dtype)
        if not bool((out[:, :, dead] == 0).all()):
            raise RuntimeError(f"B1 {dtype} dead rows: out not 0")
        log("kernels", case=label, kernel="flash_attention_bias",
            shape=[b, h, s, d], dead_rows=dead, max_abs_err=err,
            err_share_of_tolerance=tolerance_share(out, ref, dtype),
            out_is_0=True)


# ---- B7 and the quantized inference path ------------------------------------


def dequant_case(gen, dev, m, k, n, dtype, mode):
    """x [M, K] and a weight [K, N] with a 30x outlier channel, quantized
    on the card as the weight-quant pass does."""
    x = torch.randn(m, k, generator=gen).to(getattr(torch, dtype)).to(dev)
    w = torch.randn(k, n, generator=gen)
    w[:, 0] *= 30.0
    q, scale = qo.quantize_weight(w.to(dev), 1, mode)
    return x, q, scale


def check_dequant(label, out, ref, x, q, scale):
    """Max abs error of B7 against its plain version; raises beyond
    DEQUANT_TOL * sum_k |x w| (+ one bfloat16 step) per element."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != x.dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype},"
                           f" want {tuple(ref.shape)} {x.dtype}")
    w = qo.dequantize_weight(q, scale, 1)
    size = x.float().abs() @ w.abs()
    diff = (out.float() - ref.float()).abs()
    rel = REL_TOL[str(x.dtype)[6:]]
    excess = diff - DEQUANT_TOL * size - rel * ref.float().abs()
    err = float(diff.max())
    if not math.isfinite(err) or float(excess.max()) > 0:
        raise RuntimeError(f"{label}: B7 vs plain differ by {err} (max abs),"
                           f" beyond {DEQUANT_TOL} * sum|x w| + {rel} "
                           f"* |plain|")
    return err, float((diff / (DEQUANT_TOL * size + rel * ref.float().abs()
                               + 1e-30)).max())


def dequant_bound(x, q, scale, peaks):
    """Least time for one call: x, the carrier and the scale read once, the
    output written once; the operations of the least work known to give
    the product on this card at the bfloat16 tensor-core peak.  The 8-bit
    carrier is exact in bfloat16; bfloat16 x needs one product (2*M*K*N
    operations); float32 x needs three (its three bfloat16 pieces carry its
    24 bits): 3*2*M*K*N.  Returns (ms, "bytes" or "operations", and beside
    them the float32 CUDA-core figure: the larger of the bytes and 2*M*K*N
    at the float32 peak)."""
    bw, ops_rate = peaks
    m, k = x.shape
    n = q.shape[1]
    nbytes = (x.numel() * x.element_size() + q.numel() * q.element_size()
              + scale.numel() * 4 + m * n * x.element_size())
    t_bytes = nbytes / bw * 1e3
    pieces = 3 if x.dtype == torch.float32 else 1
    t_ops = pieces * 2 * m * k * n / ops_rate["bfloat16"] * 1e3
    t_f32 = max(t_bytes, 2 * m * k * n / ops_rate[str(x.dtype)[6:]] * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (t_f32,)


def run_dequant_case(gen, dev, case, peaks, flush):
    label, m, k, n, dtype, mode = case
    x, q, scale = dequant_case(gen, dev, m, k, n, dtype, mode)
    out = qo.dequant_matmul(x, q, scale)
    ref = qo.dequant_matmul_reference(x, q, scale)
    err, share = check_dequant(label, out, ref, x, q, scale)
    w = qo.dequantize_weight(q, scale, 1, x.dtype)   # what '' mode holds
    bound_ms, bound_by, f32_bound_ms = dequant_bound(x, q, scale, peaks)
    row = dict(case=label, kernel="dequant_matmul", x=dtype, carrier=mode,
               shape=[m, k, n], max_abs_err=err,
               tolerance=f"{DEQUANT_TOL} * sum|x w| + {REL_TOL[dtype]} "
                         f"* |plain|", err_share_of_tolerance=share,
               ms=cuda_ms(lambda: qo.dequant_matmul(x, q, scale), flush),
               plain_ms=cuda_ms(lambda: qo.dequant_matmul_reference(
                   x, q, scale), flush),
               library_ms=cuda_ms(lambda: torch.matmul(x, w), flush),
               library="torch.matmul on the weight dequantized beforehand "
                       f"({dtype}, TF32 off)",
               bound_ms=bound_ms, bound_by=bound_by,
               f32_cuda_core_bound_ms=f32_bound_ms)
    row["tflops"] = 2 * m * k * n / row["ms"] / 1e9
    log("kernels", **row)
    return row


def check_zero_channel(gen, dev):
    """An all-zero output channel gets a clamped scale of its own and
    dequantizes to exact zeros: B7 writes 0.0 there, in int8 and fp8."""
    for mode in ("int8", "fp8_e4m3"):
        x = torch.randn(64, 96, generator=gen).to(dev)
        w = torch.randn(96, 40, generator=gen)
        w[:, 7] = 0.0
        q, scale = qo.quantize_weight(w.to(dev), 1, mode)
        out = qo.dequant_matmul(x, q, scale)
        ref = qo.dequant_matmul_reference(x, q, scale)
        err, _ = check_dequant("zero_channel_" + mode, out, ref, x, q, scale)
        if float(scale[7]) != float(np.float32(qo.SCALE_EPS)):
            raise RuntimeError(f"zero channel: scale {float(scale[7])}")
        if not bool((out[:, 7] == 0).all()):
            raise RuntimeError(f"zero channel ({mode}): B7 wrote "
                               f"{out[:, 7].abs().max()} where 0 is due")
        log("kernels", case="zero_channel_" + mode, kernel="dequant_matmul",
            shape=[64, 96, 40], max_abs_err=err, zero_channel_exact=True)


def check_non_finite_x(gen, dev):
    """B7 on float32 x holding +inf, -inf and NaN: the kernel splits x into
    bfloat16 pieces, and must give what the plain float32 product gives by
    IEEE rules -- +-inf and NaN in the same places -- and elsewhere agree
    within the tolerance.  The carrier rows that meet those values are +-1
    (no 0 to make inf * 0)."""
    m, k, n = 64, 96, 40
    x = torch.randn(m, k, generator=gen)
    x[0, 5], x[1, 9], x[2, 11] = float("inf"), float("-inf"), float("nan")
    q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    q[[5, 9, 11]] = torch.where(
        torch.rand(3, n, generator=gen) > 0.5, 1, -1).to(torch.int8)
    scale = torch.full((n,), 1e-3)
    x, q, scale = x.to(dev), q.to(dev), scale.to(dev)
    out = qo.dequant_matmul(x, q, scale)
    ref = qo.dequant_matmul_reference(x, q, scale)
    torch.cuda.synchronize()
    rows = [0, 1, 2]
    same_nan = torch.equal(out.isnan(), ref.isnan())
    same_inf = torch.equal(out.isinf(), ref.isinf()) and torch.equal(
        out[ref.isinf()], ref[ref.isinf()])
    kinds = [("inf" if bool(ref[r].isinf().all()) else "nan"
              if bool(ref[r].isnan().all()) else "finite") for r in rows]
    if not (same_nan and same_inf) or kinds != ["inf", "inf", "nan"]:
        raise RuntimeError(f"non-finite x: B7 vs plain differ where the "
                           f"plain version is not finite (rows {kinds})")
    keep = [r for r in range(m) if r not in rows]
    err, share = check_dequant("non_finite_x", out[keep], ref[keep],
                               x[keep], q, scale)
    log("kernels", case="non_finite_x", kernel="dequant_matmul",
        shape=[m, k, n], rows_inf_inf_nan=kinds,
        non_finite_match_plain=True, max_abs_err_finite_rows=err,
        err_share_of_tolerance=share)


def build_bert(batch, amp, dropout, lr=1e-4, fused=True):
    """BERT-base pretraining at full width, as bench.py builds it."""
    from paddle_tpu_torch.text import bert_base_pretrain_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = bert_base_pretrain_program(
            batch_size=batch, max_preds_per_seq=BERT_PREDS,
            dropout_prob=dropout, lr=lr, use_fused_attention=fused)
        main.random_seed = 1
        with program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


def bert_feed(batch, seed, padded_keys=0):
    """bench_bert's synthetic feeds; ``padded_keys`` masks the last keys
    of every other sequence."""
    seq, preds = 128, BERT_PREDS
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 30522, (batch, seq)).astype("int64")
    flat_pos = np.concatenate(
        [b * seq + rng.choice(seq - padded_keys, preds, replace=False)
         for b in range(batch)]).astype("int64")
    mask = np.zeros((batch, 1, 1, seq), "float32")
    if padded_keys:
        mask[::2, :, :, seq - padded_keys:] = -1e4
    return {"input_ids": ids,
            "token_type_ids": np.zeros((batch, seq), "int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "input_mask": mask, "masked_flat_pos": flat_pos,
            "masked_labels": ids.reshape(-1)[flat_pos].reshape(-1, 1),
            "masked_weights": np.ones((batch * preds, 1), "float32"),
            "nsp_labels": rng.randint(0, 2, (batch, 1)).astype("int64")}


def warm_and_capture(exe, main, feed, fetch_list, scope):
    """A key's first run (eager, the warm-up), then its capture and
    first replay; returns the capture's peak device memory in GB."""
    exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
    captures = stat_get("cuda_graph_captures")
    _out, gb = peak_gb(lambda: exe.run(main, feed=feed, fetch_list=fetch_list,
                                       scope=scope, return_numpy=False))
    if stat_get("cuda_graph_captures") != captures + 1:
        raise RuntimeError("the second run of a key did not capture it")
    return gb


def phase_train():
    flags.set_flags({"flash_attention": "always"})
    t0 = time.monotonic()
    main, startup, loss = build_bert(TRAIN_BATCH, amp=True, dropout=0.1)
    build_s = time.monotonic() - t0
    exe = pt.Executor()
    scope = pt.framework.Scope()
    t0 = time.monotonic()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = bert_feed(TRAIN_BATCH, seed=0)
    t0 = time.monotonic()
    captured_gb = warm_and_capture(exe, main, feed, [loss], scope)
    warm = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                         steps=2)[0]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    fab.reset_launch_count()    # the main path's count starts here
    replays = stat_get("cuda_graph_replays")
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    launches = fab.flash_attention_bias.launches
    replays = stat_get("cuda_graph_replays") - replays
    losses = [float(x) for x in warm.float().cpu().ravel()] + losses
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"BERT losses not finite: {losses}")
    if launches != B1_PER_STEP * TRAIN_STEPS or replays != TRAIN_STEPS:
        raise RuntimeError(f"B1 launched {launches} times in {TRAIN_STEPS} "
                           f"steps ({replays} replays), want {B1_PER_STEP} "
                           f"a step, each a replay")
    graph = eager_vs_captured("train", exe, main, feed, [loss], scope,
                              EAGER_STEPS, ORACLE_RTOL, True, step_ms,
                              captured_gb)
    p50 = float(np.median(step_ms))
    log("train", model="bert-base", batch=TRAIN_BATCH, seq=128,
        amp="bfloat16", dropout=0.1, steps=TRAIN_STEPS,
        step_ms_p50=p50, step_ms=step_ms,
        tokens_per_s=TRAIN_BATCH * 128 / (p50 / 1e3),
        program_ops=len(main.global_block.ops), build_s=build_s,
        startup_s=startup_s, warm_eager_capture_replay_s=warm_s,
        losses=losses, replays=replays,
        b1_launches=launches, b1_launches_per_step=launches / TRAIN_STEPS,
        **graph)
    return launches, (exe, main, feed, loss, scope)


def op_ranges():
    """Wrap every op's lowering, for one profiled step, in a profiler range
    named ``op/<type>``, so that host and device time add up by op type.
    Returns the undo.  (The ranges cost host time of their own.)"""
    from torch.profiler import record_function

    from paddle_tpu_torch.framework import executor

    real = executor.get_lowering

    def labelled(op_type):
        rule = real(op_type)

        def run(ctx, op):
            with record_function("op/" + op_type):
                rule(ctx, op)
        return run

    executor.get_lowering = labelled
    return lambda: setattr(executor, "get_lowering", real)


def profile_window(run):
    """``run()`` under torch.profiler: the profile and its host
    microseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    return prof, wall_us


def kernel_share(by_name, kernels, what):
    """Device microseconds of each (label, name part) in ``kernels``;
    fails when one matched nothing."""
    ours, matched = {}, {}
    for label, part in kernels:
        matched[label] = sorted(k for k in by_name if part in k)
        ours[label] = sum(by_name[k] for k in matched[label])
        if not matched[label] or not ours[label]:
            raise RuntimeError(f"the profiled {what} ran no {part}")
    return ours, matched


def phase_train_profile(eager, captured, phase="train_profile",
                        kernels=(("b1", "flash_fwd_mma_kernel"),),
                        op_types=(), top_kernels=10):
    """One BERT-base step or inference run, captured (``captured()``, a
    replay: the device's busy share of its host time, its time by kernel)
    and eager (``eager()``, the eager block: the same, plus host and
    device time by op type, each op's lowering in a range of its own).
    ``kernels``: (label, name part) of the hand-written kernels both must
    have run (none on a path without them); ``op_types``: types reported
    on their own.  A ``<type>_grad`` op without a lowering of its own
    takes the generic gradient, which runs ``<type>``'s forward again
    under autograd: the time of those forward types is what the replay
    repeats.  Kernels that ``torch.autograd.grad`` launches run on the
    autograd engine's thread, outside the op ranges: they count by kernel
    name only.  A replay has no op ranges."""
    from torch.autograd import DeviceType

    from paddle_tpu_torch.framework.lowering import LOWERINGS

    captured()   # a steady replay: the state rebound since, copied in
    prof, cap_us = profile_window(captured)
    cap_by_name = device_time_by_kernel(prof)
    cap_busy = sum(cap_by_name.values())
    cap_ours, _ = kernel_share(cap_by_name, kernels, "replay")
    cap_top = sorted(cap_by_name.items(), key=lambda kv: -kv[1])[:top_kernels]
    undo = op_ranges()
    try:
        prof, wall_us = profile_window(eager)
    finally:
        undo()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    ours, matched = kernel_share(by_name, kernels, "eager step")
    host, dev, count = {}, {}, {}
    for e in prof.events():   # the ranges on the host's timeline
        if e.device_type == DeviceType.CPU and e.name.startswith("op/"):
            t = e.name[3:]
            host[t] = host.get(t, 0.0) + e.cpu_time_total / 1e3
            dev[t] = dev.get(t, 0.0) + e.device_time_total / 1e3
            count[t] = count.get(t, 0) + 1
    replayed = {t[:-len("_grad")] for t in count
                if t.endswith("_grad") and t not in LOWERINGS}
    by_type = {t: [count[t], host[t], dev[t]]
               for t in sorted(host, key=lambda t: -host[t])}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_kernels]
    log(phase, captured_step_ms=cap_us / 1e3,
        captured_device_busy_ms=cap_busy / 1e3,
        captured_device_busy_share=cap_busy / cap_us,
        **{f"captured_{label}_device_ms": t / 1e3
           for label, t in cap_ours.items()},
        captured_kernels=len(cap_by_name),
        captured_top_device_ms={k: v / 1e3 for k, v in cap_top},
        step_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        **{f"{label}_device_ms": t / 1e3 for label, t in ours.items()},
        **{f"{label}_share_of_busy": t / busy_us
           for label, t in ours.items()},
        kernels_matched=matched,
        **{f"op_{t}_count_host_ms_device_ms": by_type.get(t)
           for t in op_types},
        **{f"op_{t}_share_of_busy": dev.get(t, 0.0) * 1e3 / busy_us
           for t in op_types},
        kernels=len(by_name),
        top_device_ms={k: v / 1e3 for k, v in top},
        ops_host_ms=sum(host.values()), ops_device_ms=sum(dev.values()),
        generic_grad_host_ms=sum(host[t + "_grad"] for t in replayed),
        generic_grad_device_ms=sum(dev[t + "_grad"] for t in replayed),
        replayed_forward_host_ms=sum(host[t] for t in replayed),
        replayed_forward_device_ms=sum(dev[t] for t in replayed),
        by_op_type_count_host_ms_device_ms=by_type)


def phase_train_oracle():
    main, startup, loss = build_bert(ORACLE_BATCH, amp=False, dropout=0.0,
                                     lr=ORACLE_LR)
    exe = pt.Executor()
    first = pt.framework.Scope()
    exe.run(startup, scope=first)
    second = copy_scope(first)
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    runs = {}
    try:
        for mode, scope in (("always", first), ("never", second)):
            flags.set_flags({"flash_attention": mode})
            exe.warmup(main, [feed], [loss], scope)    # the 3 are replays
            replays = stat_get("cuda_graph_replays")
            before = fab.flash_attention_bias.launches
            out = exe.run_steps(main, feed=feed, fetch_list=[loss],
                                scope=scope, steps=3, return_numpy=True)[0]
            if stat_get("cuda_graph_replays") - replays != 3:
                raise RuntimeError("the oracle's steps were not replays")
            runs[mode] = ([float(x) for x in out.ravel()],
                          fab.flash_attention_bias.launches - before)
    finally:
        flags.set_flags({"flash_attention": "auto"})
    (flash, n_flash), (plain, n_plain) = runs["always"], runs["never"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(flash, plain))
    log("train_oracle", batch=ORACLE_BATCH, dtype="float32", steps=3,
        losses_b1=flash, losses_plain=plain, max_rel_gap=gap,
        tolerance=ORACLE_RTOL, b1_launches=[n_flash, n_plain])
    if not all(math.isfinite(x) for x in flash + plain) or gap > ORACLE_RTOL:
        raise RuntimeError(f"B1 vs plain losses {flash} vs {plain}: "
                           f"relative gap {gap} > {ORACLE_RTOL}")
    if n_flash != 3 * B1_PER_STEP or n_plain != 0:
        raise RuntimeError(f"B1 launches {n_flash} (want {3 * B1_PER_STEP})"
                           f" with 'always', {n_plain} (want 0) with 'never'")
    if not (flash[2] < flash[0] and plain[2] < plain[0]):
        raise RuntimeError(f"the loss did not fall: {flash}, {plain}")


def exe_run(state):
    exe, main, feed, loss, scope = state
    return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def exe_eager(state):
    exe, main, feed, loss, scope = state
    return eager_run(exe, main, feed, [loss], scope)


def copy_scope(scope):
    out = pt.framework.Scope()
    for n in scope.local_var_names():
        v = scope.get_var(n)
        if isinstance(v, torch.Tensor):
            out.set_var(n, v.clone())
    return out


def unfused_launches():
    return [f.launches for f in fa.KERNEL_WRAPPERS]


# ---- the captured step against the eager block ------------------------------


def eager_run(exe, program, feed, fetch_list, scope):
    """One step of ``program`` as ``Executor.run`` keys it (the pass
    pipeline's rewrite), through the eager block: every lowering called
    op by op, each value freed after its last use.  The state it writes
    rebinds the scope's vars, which the next replay copies back into the
    graph's buffers."""
    from paddle_tpu_torch.framework.executor import _feed_tensors, _names

    feeds = _feed_tensors(program.global_block, feed, exe.device)
    names = _names(fetch_list)
    program = exe._apply_graph_passes(program, names, feeds, scope)
    return exe._run_block(program, feeds, names, scope)


def snapshot(scope):
    """Copies of a scope's tensors and its generators' states."""
    return {k: (v.clone() if isinstance(v, torch.Tensor) else
                v.get_state() if isinstance(v, torch.Generator) else v)
            for k, v in scope._vars.items()}


def restore(scope, snap):
    """Back to ``snap``: tensors rebound to fresh copies (the graph finds
    them by identity and copies them in), generators reset in place."""
    for k, v in snap.items():
        held = scope._vars.get(k)
        if isinstance(held, torch.Generator):
            held.set_state(v)
        else:
            scope._vars[k] = v.clone() if isinstance(v, torch.Tensor) else v


def synced_ms(fn, n):
    """Host milliseconds of ``n`` calls of ``fn``, each synced."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def peak_gb(fn):
    """``fn()``'s result and the most device memory allocated while it
    ran, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def max_gap(a, b, relative):
    """Largest |a - b| over two lists of arrays (over |b|'s largest
    magnitude when ``relative``), in float64."""
    gap = 0.0
    for x, y in zip(a, b):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        d = float(np.abs(x - y).max()) if x.size else 0.0
        if relative:
            d /= max(float(np.abs(y).max()), 1e-30)
        gap = max(gap, d)
    return gap


def to_host(vals):
    return [v.float().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float64) for v in vals]


def eager_vs_captured(path, exe, program, feed, fetch_list, scope, steps,
                      tol, relative, captured_ms, captured_peak_gb):
    """The path's step through the eager block beside its captured
    replays, in one process: from one state, a replay's and an eager
    step's fetches (their largest gap, held to the path's tolerance), then
    ``steps`` eager steps timed, and the eager block's peak memory.
    Fails unless the program has no reason to run eagerly and the timed
    captured steps were replays."""
    reason = executor_mod.capture_reason(program)
    if reason is not None:
        raise RuntimeError(f"{path}: runs eagerly: {reason[1]}")
    snap = snapshot(scope)
    replays = stat_get("cuda_graph_replays")
    captured = to_host(exe.run(program, feed=feed, fetch_list=fetch_list,
                               scope=scope, return_numpy=False))
    if stat_get("cuda_graph_replays") != replays + 1:
        raise RuntimeError(f"{path}: Executor.run did not replay a graph")
    restore(scope, snap)
    eager = to_host(eager_run(exe, program, feed, fetch_list, scope))
    restore(scope, snap)
    gap = max_gap(captured, eager, relative)
    ms, eager_peak = peak_gb(lambda: synced_ms(lambda: eager_run(
        exe, program, feed, fetch_list, scope), steps))
    restore(scope, snap)
    report = dict(capture_reason=None, eager_steps=steps,
                  step_ms_p50_captured=float(np.median(captured_ms)),
                  step_ms_p50_eager=float(np.median(ms)),
                  step_ms_eager=ms,
                  peak_memory_gb_captured=captured_peak_gb,
                  peak_memory_gb_eager=eager_peak,
                  captured_vs_eager_max_gap=gap,
                  gap_relative=relative, tolerance=tol)
    if not gap <= tol:
        raise RuntimeError(f"{path}: captured vs eager outputs apart by "
                           f"{gap} > {tol}")
    return report


def phase_train_unfused():
    """The main path of the unfused slice: float32, dropout 0, the unfused
    chain rewritten by the graph passes, B2-B4 in every layer."""
    flags.set_flags({"flash_attention": "always"})
    t0 = time.monotonic()
    main, startup, loss = build_bert(TRAIN_BATCH, amp=False, dropout=0.0,
                                     fused=False)
    build_s = time.monotonic() - t0
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    feed = bert_feed(TRAIN_BATCH, seed=0, padded_keys=16)
    for name in ("pass_flash_attention_fused",
                 "pass_flash_attention_grad_fused"):
        stat_reset(name)
    t0 = time.monotonic()
    captured_gb = warm_and_capture(exe, main, feed, [loss], scope)
    warm = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                         steps=2)[0]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    rewritten = [stat_get("pass_flash_attention_fused"),
                 stat_get("pass_flash_attention_grad_fused")]
    fa.reset_launch_counts()    # the main path's counts start here
    replays = stat_get("cuda_graph_replays")
    step_ms, losses = [], []
    for _ in range(UNFUSED_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    replays = stat_get("cuda_graph_replays") - replays
    launches = unfused_launches()
    losses = [float(x) for x in warm.float().cpu().ravel()] + losses
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"unfused BERT losses not finite: {losses}")
    if rewritten != [12, 12]:
        raise RuntimeError(f"the pass rewrote {rewritten} attention chains "
                           f"and grad chains, want [12, 12]")
    want = [n * UNFUSED_STEPS
            for n in (B2_PER_STEP, B3_PER_STEP, B4_PER_STEP)]
    if launches != want or replays != UNFUSED_STEPS:
        raise RuntimeError(f"B2/B3/B4 launched {launches} times in "
                           f"{UNFUSED_STEPS} steps ({replays} replays), "
                           f"want {want}, each step a replay")
    graph = eager_vs_captured("train_unfused", exe, main, feed, [loss],
                              scope, EAGER_STEPS, ORACLE_RTOL, True, step_ms,
                              captured_gb)
    rewritten_ops = len(passes.apply_passes(
        main, fetch_names=(loss.name,), feed_names=tuple(feed),
        scope=scope).global_block.ops)
    p50 = float(np.median(step_ms))
    log("train_unfused", model="bert-base", batch=TRAIN_BATCH, seq=128,
        dtype="float32", dropout=0.0, steps=UNFUSED_STEPS, step_ms_p50=p50,
        step_ms=step_ms, tokens_per_s=TRAIN_BATCH * 128 / (p50 / 1e3),
        program_ops=len(main.global_block.ops),
        program_ops_after_passes=rewritten_ops, chains_rewritten=rewritten,
        build_s=build_s, warm_eager_capture_replay_s=warm_s, losses=losses,
        replays=replays, launches_b2_b3_b4=launches,
        launches_per_step=[n / UNFUSED_STEPS for n in launches], **graph)
    return dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"), launches)), \
        (exe, main, feed, loss, scope)


def phase_train_unfused_oracle():
    """never (the chain as built) / always (B2-B4) / the fused program
    (B1): one startup, three scopes, 3 float32 steps each."""
    unfused, startup, u_loss = build_bert(ORACLE_BATCH, amp=False,
                                          dropout=0.0, lr=ORACLE_LR,
                                          fused=False)
    fused, _startup, f_loss = build_bert(ORACLE_BATCH, amp=False,
                                         dropout=0.0, lr=ORACLE_LR)
    exe = pt.Executor()
    first = pt.framework.Scope()
    exe.run(startup, scope=first)
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    runs = {}
    try:
        for label, mode, prog, loss, scope in (
                ("never", "never", unfused, u_loss, copy_scope(first)),
                ("always", "always", unfused, u_loss, copy_scope(first)),
                ("fused", "always", fused, f_loss, first)):
            flags.set_flags({"flash_attention": mode})
            exe.warmup(prog, [feed], [loss], scope)    # the 3 are replays
            fa.reset_launch_counts()
            replays = stat_get("cuda_graph_replays")
            b1_before = fab.flash_attention_bias.launches
            out = exe.run_steps(prog, feed=feed, fetch_list=[loss],
                                scope=scope, steps=3, return_numpy=True)[0]
            if stat_get("cuda_graph_replays") - replays != 3:
                raise RuntimeError("the oracle's steps were not replays")
            runs[label] = ([float(x) for x in out.ravel()],
                           unfused_launches(),
                           fab.flash_attention_bias.launches - b1_before)
    finally:
        flags.set_flags({"flash_attention": "auto"})
        fa.reset_launch_counts()
    losses = {k: v[0] for k, v in runs.items()}
    gaps = {f"{a}_vs_{b}": max(abs(x - y) / abs(y)
                               for x, y in zip(losses[a], losses[b]))
            for a, b in (("always", "never"), ("fused", "never"),
                         ("always", "fused"))}
    log("train_unfused_oracle", batch=ORACLE_BATCH, dtype="float32", steps=3,
        losses=losses, max_rel_gaps=gaps, tolerance=ORACLE_RTOL,
        launches_b2_b3_b4={k: v[1] for k, v in runs.items()},
        launches_b1={k: v[2] for k, v in runs.items()})
    flat = [x for v in losses.values() for x in v]
    if not all(math.isfinite(x) for x in flat) \
            or max(gaps.values()) > ORACLE_RTOL:
        raise RuntimeError(f"never / always / fused losses {losses}: "
                           f"relative gaps {gaps} > {ORACLE_RTOL}")
    want = {"never": ([0, 0, 0], 0),
            "always": ([3 * B2_PER_STEP, 3 * B3_PER_STEP, 3 * B4_PER_STEP],
                       0),
            "fused": ([0, 0, 0], 3 * B1_PER_STEP)}
    got = {k: (v[1], v[2]) for k, v in runs.items()}
    if got != want:
        raise RuntimeError(f"kernel launches {got}, want {want}")
    if not all(v[2] < v[0] for v in losses.values()):
        raise RuntimeError(f"the loss did not fall: {losses}")


def build_bert_inference():
    """The served model: BERT-base's encoder with a -1 batch dim, dropout 0
    and fused attention, plus the pretraining program's NSP head (pooler
    and 2-way classifier, as ``text/static_models.py`` builds them)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.text import static_models as sm

    seq = 128
    main, startup = Program(), Program()
    main.random_seed = 1
    with unique_name.guard(), program_guard(main, startup):
        ids, types, pos = (layers.data(n, [-1, seq], dtype="int64",
                                       append_batch_size=False)
                           for n in INFER_FEEDS[:3])
        mask = layers.data("input_mask", [-1, 1, 1, seq], dtype="float32",
                           append_batch_size=False)
        seq_out = sm.bert_encoder(ids, types, pos, mask, dropout_prob=0.0)
        cls = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [0, 768])
        pooled = sm._dense(cls, 768, act="tanh", name="pooler")
        nsp_logits = sm._dense(pooled, 2, name="nsp_out")
    return main, startup, seq_out, nsp_logits


INFER_FEEDS = ("input_ids", "token_type_ids", "pos_ids", "input_mask")


def infer_feed(batch, seed):
    """Random token ids, segment ids 0/1, positions, and a key mask that
    pads the last 16 keys of every other sequence."""
    seq = 128
    rng = np.random.RandomState(seed)
    mask = np.zeros((batch, 1, 1, seq), "float32")
    mask[::2, :, :, seq - 16:] = -1e4
    return {"input_ids": rng.randint(0, 30522, (batch, seq)).astype("int64"),
            "token_type_ids": (np.arange(seq)[None] >= seq // 2)
            .repeat(batch, 0).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "input_mask": mask}


def quant_state(scope):
    """The carriers and scales the weight-quant pass wrote into a scope,
    as host bytes by name."""
    return {n: scope.get_var(n).detach().cpu().view(torch.uint8).numpy()
            if scope.get_var(n).element_size() == 1
            else scope.get_var(n).detach().cpu().numpy()
            for n in scope.local_var_names() if "@WQ" in n}


def phase_infer(model_dir):
    """save_inference_model -> Predictor on the card, three modes."""
    from paddle_tpu_torch import inference

    flags.set_flags({"flash_attention": "always"})
    feeds = {b: infer_feed(b, seed=b) for b in INFER_BATCHES}
    results, outs, launches, preds, step_ms = {}, {}, {}, {}, {}
    try:
        for mode in INFER_MODES:
            flags.set_flags({"weight_quant": mode})
            torch.cuda.synchronize()
            held_gb = torch.cuda.memory_allocated() / 1e9
            t0 = time.monotonic()
            pred = inference.create_predictor(inference.Config(model_dir))
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            n0 = stat_get("pass_weight_quant_ops")
            t0 = time.monotonic()
            pred.run(feeds[INFER_BATCHES[0]])   # the pass, once per mode
            torch.cuda.synchronize()
            first_s = time.monotonic() - t0
            rewritten = stat_get("pass_weight_quant_ops") - n0
            for b in INFER_BATCHES[1:]:         # every batch's warm-up
                pred.run(feeds[b])
            _out, captured_gb = peak_gb(lambda: [pred.run(feeds[b])
                                                 for b in INFER_BATCHES])
            qo.reset_launch_count()     # the main path's counts start here
            fab.reset_launch_count()
            replays = stat_get("cuda_graph_replays")
            p50 = {}
            for b in INFER_BATCHES:
                ms = []
                for _ in range(INFER_RUNS):
                    t0 = time.perf_counter()
                    out = pred.run(feeds[b])
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                p50[b] = float(np.median(ms))
                outs[(mode, b)] = out
                step_ms[(mode, b)] = ms
            runs = INFER_RUNS * len(INFER_BATCHES)
            launches[mode] = (qo.dequant_matmul.launches,
                              fab.flash_attention_bias.launches)
            want = ((B7_PER_RUN if mode else 0) * runs, B1_PER_RUN * runs)
            replays = stat_get("cuda_graph_replays") - replays
            if launches[mode] != want or replays != runs:
                raise RuntimeError(f"mode {mode!r}: B7/B1 launched "
                                   f"{launches[mode]} times in {runs} runs "
                                   f"({replays} replays), want {want}, each "
                                   f"run a replay")
            graph = eager_vs_captured(
                f"infer {mode or 'float32'}", pred._exe, pred._program,
                feeds[32], pred._fetch_targets, pred._scope, INFER_RUNS,
                INFER_ORACLE_TOL, False, step_ms[(mode, 32)], captured_gb)
            if rewritten != (B7_PER_RUN if mode else 0):
                raise RuntimeError(f"mode {mode!r}: the pass rewrote "
                                   f"{rewritten} ops, want {B7_PER_RUN}")
            for b in INFER_BATCHES:
                seq, nsp = outs[(mode, b)]
                if seq.shape != (b, 128, 768) or nsp.shape != (b, 2) or \
                        not (np.isfinite(seq).all() and np.isfinite(nsp)
                             .all()):
                    raise RuntimeError(f"mode {mode!r} batch {b}: outputs "
                                       f"{seq.shape} {nsp.shape} not finite"
                                       f" or misshapen")
            results[mode] = dict(
                load_s=load_s, first_run_s=first_s, ops_rewritten=rewritten,
                p50_ms={str(b): p50[b] for b in INFER_BATCHES},
                sequences_per_s_b32=32 / (p50[32] / 1e3),
                launches_b7_b1=list(launches[mode]),
                launches_per_run=[n / runs for n in launches[mode]],
                memory_held_before_gb=held_gb, replays=replays,
                batch_32=graph)
            preds[mode] = pred
    finally:
        flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
    base = outs[("", 32)]
    for mode in INFER_MODES[1:]:
        seq, nsp = outs[(mode, 32)]
        delta = float(np.abs(seq - base[0]).max())
        scale = float(np.abs(base[0]).max())
        results[mode]["seq_max_abs_delta_vs_f32"] = delta
        results[mode]["seq_max_abs_f32"] = scale
        results[mode]["nsp_quality"] = qo.quant_quality_delta(nsp, base[1])
        if mode == "int8" and delta > INT8_QUALITY_BOUND * scale:
            raise RuntimeError(f"int8 sequence output moved {delta} from the"
                               f" float32 run's, beyond "
                               f"{INT8_QUALITY_BOUND} * {scale}")
    log("infer", model="bert-base encoder + nsp head", seq=128,
        dtype="float32", batches=list(INFER_BATCHES), runs=INFER_RUNS,
        int8_bound=INT8_QUALITY_BOUND, **{m or "float32": r
                                          for m, r in results.items()})
    return launches["int8"][0], preds


def phase_infer_oracle(model_dir, card_preds):
    """The same saved model on the CPU (the kernels' plain versions): equal
    carriers and scales, outputs within INFER_ORACLE_TOL, at batch 2."""
    from paddle_tpu_torch import inference

    feed = infer_feed(2, seed=11)
    report = {}
    try:
        for mode in INFER_MODES:
            flags.set_flags({"weight_quant": mode})
            cfg = inference.Config(model_dir)
            cfg.disable_gpu()
            cpu = inference.create_predictor(cfg)
            card = card_preds[mode]
            card._exe.warmup(card._program, [feed], card._fetch_targets,
                             card._scope)   # the card's run is a replay
            replays = stat_get("cuda_graph_replays")
            before = qo.dequant_matmul.launches
            got_cpu = cpu.run(feed)
            got_card = card.run(feed)
            if stat_get("cuda_graph_replays") != replays + 1:
                raise RuntimeError(f"mode {mode!r}: the card's run was not "
                                   f"a replay")
            if qo.dequant_matmul.launches - before != (B7_PER_RUN if mode
                                                        else 0):
                raise RuntimeError(f"mode {mode!r}: the CPU predictor "
                                   f"launched B7 or the card's did not")
            ours, theirs = quant_state(card_preds[mode]._scope), \
                quant_state(cpu._scope)
            differ = [n for n in ours
                      if n not in theirs or not np.array_equal(ours[n],
                                                               theirs[n])]
            if sorted(ours) != sorted(theirs) or differ or len(ours) != \
                    (2 * B7_PER_RUN if mode else 0):
                raise RuntimeError(f"mode {mode!r}: the card's carriers and "
                                   f"scales ({len(ours)}) differ from the "
                                   f"CPU's ({len(theirs)}): {differ[:4]}")
            errs = [float(np.abs(a - b).max())
                    for a, b in zip(got_card, got_cpu)]
            report[mode or "float32"] = dict(
                max_abs_err_seq_nsp=errs, carriers_and_scales=len(ours),
                carriers_bit_equal=True)
            if not max(errs) <= INFER_ORACLE_TOL:
                raise RuntimeError(f"mode {mode!r}: card vs CPU outputs "
                                   f"differ by {errs} > {INFER_ORACLE_TOL}")
            del cpu
    finally:
        flags.set_flags({"weight_quant": ""})
    log("infer_oracle", batch=2, tolerance=INFER_ORACLE_TOL, **report)


# ---- ResNet-50 static training (no hand-written kernel on its path) ---------


def build_resnet(amp, lr=0.1):
    """ResNet-50 training as bench.py's ``bench_resnet`` builds it."""
    from paddle_tpu_torch.vision import resnet50_train_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = resnet50_train_program(
            lr=lr, momentum=0.9, img_shape=RESNET_IMG)
        main.random_seed = 1
        with program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


def resnet_feed(batch, seed=0):
    """bench_resnet's synthetic batch: float32 images, int32 labels."""
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, *RESNET_IMG).astype("float32"),
            "label": rng.randint(0, 1000, (batch, 1)).astype("int32")}


# (label, wrapper) of every hand-written kernel
KERNEL_WRAPPERS = (("b1", fab.flash_attention_bias),
                   ("b2", fa.flash_attention_fwd),
                   ("b3", fa.flash_attention_bwd_dq),
                   ("b4", fa.flash_attention_bwd_dkv),
                   ("b5", pa.paged_decode_attention),
                   ("b6", pa.paged_chunk_attention),
                   ("b7", qo.dequant_matmul))


def kernel_launches():
    return {label: fn.launches for label, fn in KERNEL_WRAPPERS}


def zero_kernel_launches():
    fab.reset_launch_count()
    fa.reset_launch_counts()
    pa.reset_launch_counts()
    qo.dequant_matmul.launches = 0


def conv_flops(main, batch):
    """Multiply-adds x 2 of one training step's convolutions, from the
    program's shapes: each forward, its filter gradient and, where the
    program asks for one, its input gradient."""
    block = main.global_block
    wants_dx = {op.inputs["Input"][0] for op in block.ops
                if op.type == "conv2d_grad"
                and any(op.outputs.get("Input@GRAD", []))}
    cast_from = {op.outputs["Out"][0]: op.inputs["X"][0]
                 for op in block.ops if op.type == "cast"}   # AMP's casts
    total = 0
    for op in block.ops:
        if op.type != "conv2d":
            continue
        out = block.var(op.outputs["Output"][0]).shape
        w = op.inputs["Filter"][0]
        w = block.var(cast_from.get(w, w)).shape
        fwd = 2 * batch * math.prod(out[1:]) * math.prod(w[1:])
        total += fwd * (3 if op.inputs["Input"][0] in wants_dx else 2)
    return total


def resnet_train(batch):
    """Startup, the warm-up and capture, a ``run_steps(steps=2)`` of
    replays, then RESNET_STEPS synced replays at ``batch`` on the card
    (the feed on the card beforehand, as bench_resnet puts it there once),
    then the eager block beside them."""
    main, startup, loss = build_resnet(amp=True)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    t0 = time.monotonic()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_feed(batch).items()}
    zero_kernel_launches()      # the path's counts start here
    before = kernel_launches()
    t0 = time.monotonic()
    captured_gb = warm_and_capture(exe, main, feed, [loss], scope)
    warm = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                         steps=2)[0]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    replays = stat_get("cuda_graph_replays")
    step_ms, losses = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    replays = stat_get("cuda_graph_replays") - replays
    launches_after = kernel_launches()
    if replays != RESNET_STEPS:
        raise RuntimeError(f"{replays} of {RESNET_STEPS} ResNet steps were "
                           f"replays")
    graph = eager_vs_captured("resnet", exe, main, feed, [loss], scope,
                              EAGER_STEPS, RESNET_ORACLE_RTOL, True, step_ms,
                              captured_gb)
    losses = [float(x) for x in warm.float().cpu().ravel()] + losses
    report = dict(program_ops=len(main.global_block.ops),
                  startup_s=startup_s, warm_eager_capture_replay_s=warm_s,
                  step_ms=step_ms, losses=losses, replays=replays,
                  launches_before=before, launches_after=launches_after,
                  **graph)
    return report, (exe, main, feed, loss, scope)


def phase_resnet():
    """bench_resnet's configuration through the port, at the largest
    power-of-two batch up to RESNET_BATCH that fits."""
    batch, reduced = RESNET_BATCH, []
    while True:
        try:
            report, state = resnet_train(batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            reason = f"batch {batch} ran out of device memory: " \
                     f"{str(e).splitlines()[0][:300]}"
        gc.collect()
        torch.cuda.empty_cache()
        reduced.append(reason)
        batch //= 2
        if batch < 8:
            raise RuntimeError(f"ResNet-50 does not fit: {reduced}")
    losses = report["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"ResNet-50 losses not finite: {losses}")
    if any(report["launches_after"].values()):
        raise RuntimeError(f"the ResNet path launched hand-written kernels: "
                           f"{report['launches_after']}")
    p50 = float(np.median(report["step_ms"]))
    flops = conv_flops(state[1], batch)
    _bw, peaks = card_peaks(torch.cuda.get_device_name(0))
    STATIC_RESNET.update(batch=batch, captured_p50=p50,
                         eager_p50=report["step_ms_p50_eager"])
    log("resnet", model="resnet50_v1.5", batch=batch, image=RESNET_IMG,
        classes=1000, amp="bfloat16", optimizer="momentum 0.9, lr 0.1",
        steps=RESNET_STEPS, step_ms_p50=p50,
        images_per_s=batch / (p50 / 1e3), reduced=reduced,
        conv_tflop_per_step=flops / 1e12,
        conv_bf16_bound_ms=flops / peaks["bfloat16"] * 1e3,
        cudnn_benchmark=torch.backends.cudnn.benchmark, **report)
    return state


def rel_err(a, b):
    """Largest |a - b| over ``a``'s largest magnitude, in float64."""
    if not a.numel():
        return 0.0
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))


def replay_step(exe, main, feed, fetch, scope):
    """One step of ``main`` on the card, op by op as ``Executor.run`` runs
    it, with each op's lowering run again on the CPU from host copies of
    the same inputs; the step's state is written back to ``scope``.
    Returns the fetch's value and [(op type, output, rel_err)] of every
    floating output."""
    from paddle_tpu_torch.framework.executor import _feed_tensors
    from paddle_tpu_torch.framework.lowering import (LoweringContext,
                                                     PSEUDO_OPS, get_lowering)

    feeds = _feed_tensors(main.global_block, feed, exe.device)
    main = exe._apply_graph_passes(main, (fetch,), feeds, scope)
    block = main.global_block
    state_in, state_out = exe._analysis(main, set(feeds), scope)
    env = {n: scope.get_var(n) for n in state_in}
    env.update(feeds)
    ctx = LoweringContext(block, env, exe.device,
                          exe._generator(scope, main))
    cpu, errs = torch.device("cpu"), []
    with torch.no_grad():
        for op in block.ops:
            if op.type in PSEUDO_OPS:
                continue
            host = {n: env[n].cpu() for n in op.input_arg_names()}
            get_lowering(op.type)(ctx, op)
            get_lowering(op.type)(LoweringContext(block, host, cpu), op)
            for n in dict.fromkeys(op.output_arg_names()):
                if env[n].is_floating_point():
                    errs.append((op.type, n, rel_err(env[n], host[n])))
    for n in state_out:
        scope.set_var(n, env[n])
    return env[fetch], errs


def host_copy(scope):
    out = pt.framework.Scope()
    for n in scope.local_var_names():
        v = scope.get_var(n)
        if isinstance(v, torch.Tensor):
            out.set_var(n, v.cpu().clone())
    return out


def phase_resnet_oracle():
    """float32, batch 4, full width: one startup on the card, copied to
    CPU scopes.  Step 1 on the card is replayed op by op on the CPU (the
    kernels' plain versions and ATen's CPU convolutions, the path the
    tier-1 tests hold to the JAX package), from the card's inputs: every
    output within RESNET_ORACLE_RTOL, the 106 running statistics and the
    161 parameters among them.  Then steps 2-3 on the card, and 3 steps
    on the CPU from the startup's copy: the step-1 losses within the
    tolerance, the loss falls on both.  The later steps' gaps are
    reported beside the CPU's own gap when its image moves by one float32
    ulp: a ReLU network's float32 gradient is not continuous at that
    scale (ReLU masks flip near 0), so no two float32 runs follow one
    trajectory to 1e-4 (``tools/resnet_divergence.py`` measures how far
    one step's gradients part, card against CPU and CPU against itself)."""
    main, startup, loss = build_resnet(amp=False, lr=RESNET_ORACLE_LR)
    exe = pt.Executor()
    card = pt.framework.Scope()
    exe.run(startup, scope=card)
    host, host_ulp = host_copy(card), host_copy(card)
    feed = resnet_feed(RESNET_ORACLE_BATCH, seed=1)
    feed_ulp = dict(feed, image=np.nextafter(feed["image"],
                                             np.float32(np.inf)))
    exe.warmup(main, [feed], [loss], card)   # the card's steps replay
    snap = snapshot(card)
    captured_first = float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=card)[0].ravel()[0])
    restore(card, snap)
    del snap
    t0 = time.monotonic()
    first, errs = replay_step(exe, main, feed, loss.name, card)
    replay_s = time.monotonic() - t0
    replays = stat_get("cuda_graph_replays")
    later = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=card,
                          steps=2, return_numpy=True)[0]
    if stat_get("cuda_graph_replays") - replays != 2:
        raise RuntimeError("the oracle's card steps were not replays")
    card_l = [float(first.ravel()[0])] + [float(x) for x in later.ravel()]
    cpu_exe = pt.Executor(pt.CPUPlace())
    t0 = time.monotonic()
    cpu_l, ulp_l = ([float(x) for x in cpu_exe.run_steps(
        main, feed=fd, fetch_list=[loss], scope=sc, steps=3,
        return_numpy=True)[0].ravel()]
        for fd, sc in ((feed, host), (feed_ulp, host_ulp)))
    cpu_s = time.monotonic() - t0
    block = main.global_block
    stats = {n for op in block.ops if op.type == "batch_norm"
             for n in op.outputs["MeanOut"] + op.outputs["VarianceOut"]}
    params = {p.name for p in main.all_parameters()}
    by_type = {}
    for t, _n, e in errs:
        by_type[t] = max(by_type.get(t, 0.0), e)
    worst = max(errs, key=lambda r: r[2])
    stat_errs = [e for t, n, e in errs if t == "batch_norm" and n in stats]
    param_errs = [e for t, n, e in errs if t == "momentum" and n in params]

    def gaps(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    def state_gap(a, b, names):
        return max(rel_err(a.get_var(n), b.get_var(n)) for n in names)

    log("resnet_oracle", batch=RESNET_ORACLE_BATCH, dtype="float32",
        steps=3, lr=RESNET_ORACLE_LR, tf32=torch.backends.cuda.matmul.
        allow_tf32, cudnn_tf32=torch.backends.cudnn.allow_tf32,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        replayed_outputs=len(errs), replay_max_rel_err=list(worst),
        replay_max_rel_err_by_type=by_type,
        running_stats=len(stat_errs), running_stats_max_rel_err=max(
            stat_errs), parameters=len(param_errs),
        parameters_max_rel_err=max(param_errs), tolerance=RESNET_ORACLE_RTOL,
        losses_card=card_l, loss_step1_card_captured=captured_first,
        loss_step1_rel_gap_captured_cpu=gaps([captured_first], cpu_l)[0],
        losses_cpu=cpu_l, losses_cpu_image_ulp=ulp_l,
        loss_rel_gaps_card_cpu=gaps(card_l, cpu_l),
        loss_rel_gaps_cpu_ulp=gaps(ulp_l, cpu_l),
        step3_state_max_rel_gap_card_cpu=[
            state_gap(card, host, stats), state_gap(card, host, params)],
        step3_state_max_rel_gap_cpu_ulp=[
            state_gap(host_ulp, host, stats),
            state_gap(host_ulp, host, params)],
        replay_s=replay_s, cpu_trajectories_s=cpu_s)
    if (len(stat_errs), len(param_errs)) != (106, 161):
        raise RuntimeError(f"{len(stat_errs)} running statistics and "
                           f"{len(param_errs)} parameters replayed, want "
                           f"106 and 161")
    if worst[2] > RESNET_ORACLE_RTOL:
        raise RuntimeError(f"the card's {worst[0]} output {worst[1]} is "
                           f"{worst[2]} from the CPU's on the same inputs "
                           f"(> {RESNET_ORACLE_RTOL})")
    if not all(math.isfinite(x) for x in card_l + cpu_l) \
            or gaps(card_l, cpu_l)[0] > RESNET_ORACLE_RTOL \
            or gaps([captured_first], cpu_l)[0] > RESNET_ORACLE_RTOL:
        raise RuntimeError(f"card vs CPU losses {card_l} (captured step 1 "
                           f"{captured_first}) vs {cpu_l}: step 1 apart by "
                           f"more than {RESNET_ORACLE_RTOL}")
    if not (card_l[2] < card_l[0] and cpu_l[2] < cpu_l[0]):
        raise RuntimeError(f"the loss did not fall: {card_l}, {cpu_l}")


# -- dygraph (the 2.0 API) --------------------------------------------------

DY_BATCH, DY_WARM, DY_STEPS = 128, 3, 10
DY_PEAK_RTOL = 0.05            # peak memory after step 3 vs the last step
DY_ORACLE_BATCH, DY_ORACLE_LR, DY_ORACLE_RTOL = 4, 1e-3, 1e-4
# Norm-wise relative error of each parameter's gradient, card vs CPU
# after one step.  In float32 the gradient of this randomly initialized
# ResNet-50 at batch 4 is not stable to better than a few percent: the CPU
# against itself, its image moved by one float32 ulp, parts by about as
# much as the card parts from the CPU, and so does the CPU in float64 for
# the same one-ulp move of the image (the phase logs both gaps; PERF.md
# section 6 has the readings), so the gap is the gradient's own
# sensitivity to a float32-sized change, not one op's rounding.  A dropped
# term of batch norm's backward is off by order 1 and fails the float32
# bound (tools/dygraph_oracle_faults.py plants such faults on the card).
# Smaller errors show in float64, where the card parts from the CPU by
# about 1e-13 (PERF.md): there the loss, the running statistics and every
# gradient are held to DY_ORACLE_F64_TOL, a few hundred times that; a mean
# term of batch norm's backward divided by N - 1 for N reads 3.6e-2 there.
DY_ORACLE_GRAD_TOL = 0.1
DY_ORACLE_F64_TOL = 1e-10
STATIC_RESNET = {}             # the same call's static step, for beside


def dygraph_resnet50(batch, seed, lr, device="gpu:0"):
    """``vision.models.resnet50()`` on ``device`` with
    ``optimizer.Momentum(lr, 0.9)``, and one seeded batch on it."""
    pt.set_device(device)
    pt.seed(seed)
    model = pt.vision.models.resnet50()
    opt = pt.optimizer.Momentum(lr, 0.9, parameters=model.parameters())
    rng = np.random.RandomState(seed)
    x = pt.to_tensor(rng.randn(batch, *RESNET_IMG).astype("float32"))
    y = pt.to_tensor(rng.randint(0, 1000, (batch, 1)).astype("int64"))
    return model, opt, x, y


def dygraph_step(model, opt, x, y, amp=True):
    """One training step as a user writes it: auto_cast forward, loss,
    backward, the optimizer's step, clear_grad."""
    with pt.amp.auto_cast(enable=amp, dtype="bfloat16"):
        loss = pt.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def counted_ops(step):
    """``step()`` with every eager op it dispatches counted by type."""
    from paddle_tpu_torch.dygraph import eager

    real, counts = eager.run_op, {}

    def run_op(op_type, *a, **kw):
        counts[op_type] = counts.get(op_type, 0) + 1
        return real(op_type, *a, **kw)

    eager.run_op = run_op
    try:
        step()
    finally:
        eager.run_op = real
    return counts


def dygraph_op_ranges():
    """Every eager op in a profiler range ``op/<type>``; returns the undo."""
    from torch.profiler import record_function

    from paddle_tpu_torch.dygraph import eager

    real = eager.run_op

    def run_op(op_type, *a, **kw):
        with record_function("op/" + op_type):
            return real(op_type, *a, **kw)

    eager.run_op = run_op
    return lambda: setattr(eager, "run_op", real)


def dygraph_train(batch):
    model, opt, x, y = dygraph_resnet50(batch, seed=0, lr=0.1)
    torch.cuda.synchronize()
    zero_kernel_launches()      # the path's counts start here
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.monotonic()
    for _ in range(DY_WARM):
        losses.append(float(dygraph_step(model, opt, x, y)))
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    peak_step3 = torch.cuda.max_memory_allocated()
    step_ms = []
    for _ in range(DY_STEPS):
        t0 = time.perf_counter()
        loss = dygraph_step(model, opt, x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak_last = torch.cuda.max_memory_allocated()
    launches = kernel_launches()
    ops = counted_ops(lambda: dygraph_step(model, opt, x, y))
    return dict(step_ms=step_ms, losses=losses, warm_s=warm_s,
                peak_step3_gb=peak_step3 / 1e9, peak_last_gb=peak_last / 1e9,
                launches_after=launches, ops_per_step=sum(ops.values()),
                ops_by_type=dict(sorted(ops.items(), key=lambda kv: -kv[1]))
                ), (model, opt, x, y)


def phase_dygraph_resnet():
    """BASELINE config 2 at bench_resnet's shape through the 2.0 API:
    ``set_device("gpu:0")``, ``resnet50()``, ``Momentum(0.1, 0.9)``,
    ``auto_cast(bfloat16)``, ``F.cross_entropy``, ``backward``, ``step``,
    ``clear_grad``; batch 128 (halved while it does not fit, logged as
    ``reduced``).  Then one step profiled."""
    from torch.autograd import DeviceType

    batch, reduced = DY_BATCH, []
    while True:
        try:
            report, state = dygraph_train(batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            reason = f"batch {batch} ran out of device memory: " \
                     f"{str(e).splitlines()[0][:300]}"
        gc.collect()
        torch.cuda.empty_cache()
        reduced.append(reason)
        batch //= 2
        if batch < 8:
            raise RuntimeError(f"dygraph ResNet-50 does not fit: {reduced}")
    losses = report["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"dygraph ResNet-50 losses not finite: {losses}")
    if any(report["launches_after"].values()):
        raise RuntimeError(f"the dygraph ResNet path launched hand-written "
                           f"kernels: {report['launches_after']}")
    growth = report["peak_last_gb"] / report["peak_step3_gb"] - 1.0
    undo = dygraph_op_ranges()
    try:
        prof, wall_us = profile_window(lambda: dygraph_step(*state))
    finally:
        undo()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    dev, host, count = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("op/"):
            t = e.name[3:]
            dev[t] = dev.get(t, 0.0) + e.device_time_total / 1e3
            host[t] = host.get(t, 0.0) + e.cpu_time_total / 1e3
            count[t] = count.get(t, 0) + 1
    top_types = sorted(dev, key=lambda t: -dev[t])[:12]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    p50 = float(np.median(report["step_ms"]))
    log("dygraph_resnet", model="resnet50_v1.5", api="dygraph",
        batch=batch, image=RESNET_IMG, classes=1000, amp="bfloat16",
        optimizer="Momentum(0.1, 0.9)", steps=DY_STEPS, step_ms_p50=p50,
        images_per_s=batch / (p50 / 1e3), reduced=reduced,
        peak_memory_gb_step3=report["peak_step3_gb"],
        peak_memory_gb_last=report["peak_last_gb"],
        peak_memory_growth=growth, peak_memory_tolerance=DY_PEAK_RTOL,
        profiled_step_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        forward_and_step_ops_device_ms=sum(dev.values()),
        forward_and_step_ops_host_ms=sum(host.values()),
        backward_device_ms=busy_us / 1e3 - sum(dev.values()),
        top_op_types_count_host_ms_device_ms={
            t: [count[t], host[t], dev[t]] for t in top_types},
        top_kernels_device_ms={k: v / 1e3 for k, v in top},
        static_captured_step_ms_p50=STATIC_RESNET.get("captured_p50"),
        static_eager_step_ms_p50=STATIC_RESNET.get("eager_p50"),
        static_batch=STATIC_RESNET.get("batch"),
        cudnn_benchmark=torch.backends.cudnn.benchmark, **report)
    if abs(growth) > DY_PEAK_RTOL:
        raise RuntimeError(f"peak memory after step 3 "
                           f"{report['peak_step3_gb']} GB and after the "
                           f"last step {report['peak_last_gb']} GB differ by "
                           f"{growth:.3f} (> {DY_PEAK_RTOL}): state kept a "
                           f"graph alive")
    if not all(b._value.grad_fn is None for b in state[0].buffers()):
        raise RuntimeError("a running statistic holds an autograd graph")


def grad_rel_err(a, b):
    """Norm-wise relative error ||a - b|| / ||b|| in float64."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def one_step(model, x, y):
    """(loss, {parameter: gradient}, {buffer: value}) after one forward
    and backward; the gradients cleared again."""
    loss = pt.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    out = (float(loss), {n: p.grad._value.clone() for n, p in
                         model.named_parameters()},
           {n: b._value.clone() for n, b in model.named_buffers()})
    model.clear_gradients()
    return out


def in_float64(model, weights):
    """``weights`` loaded into ``model``, then every parameter and
    buffer made float64 (batch norm then accumulates in float64)."""
    pt.dygraph.state_dict_from_numpy(model, weights)
    for t in list(model.parameters()) + list(model.buffers()):
        t._set_raw(t._value.double())
    return model


def step_gaps(got, want):
    """(loss gap, {buffer: error}, {parameter: norm-wise gradient error})
    of one ``one_step`` result against another."""
    return (abs(got[0] - want[0]) / abs(want[0]),
            {n: rel_err(want[2][n], got[2][n]) for n in want[2]},
            {n: grad_rel_err(got[1][n], want[1][n]) for n in want[1]})


def worst(errs):
    name = max(errs, key=errs.get)
    return [name, errs[name]]


def median(errs):
    return float(np.median(list(errs.values())))


def phase_dygraph_resnet_oracle():
    """Batch 4, full width: one set of weights (the card's
    initialization, copied) on the card and on the CPU, one forward and
    backward each (the CPU runs every op's lowering on ATen's CPU kernels,
    the path the tier-1 tests hold to the JAX package), in float32 and
    again in float64.  float32: the loss within 1e-4 relative, the 106
    running statistics within 1e-4 of each tensor's largest magnitude,
    every parameter's gradient within DY_ORACLE_GRAD_TOL norm-wise,
    beside the CPU's own gradient gap when its image moves by one ulp.
    float64: the loss, the running statistics and every gradient within
    DY_ORACLE_F64_TOL, beside the CPU's float64 gradient gap for the
    float32 ulp."""
    card, _opt, c_x, c_y = dygraph_resnet50(DY_ORACLE_BATCH, seed=1,
                                            lr=DY_ORACLE_LR)
    weights = {k: v.numpy() for k, v in card.state_dict().items()}
    host, _opt, h_x, h_y = dygraph_resnet50(DY_ORACLE_BATCH, seed=1,
                                            lr=DY_ORACLE_LR, device="cpu")
    pt.dygraph.state_dict_from_numpy(host, weights)
    pt.set_device("gpu:0")
    t0 = time.monotonic()
    ulp = pt.to_tensor(np.nextafter(h_x.numpy(), np.float32(np.inf)),
                       place="cpu")
    cpu_ulp = one_step(host, ulp, h_y)
    cpu = one_step(pt.dygraph.state_dict_from_numpy(host, weights), h_x, h_y)
    f32, cpu_ulp = step_gaps(one_step(card, c_x, c_y), cpu), \
        step_gaps(cpu_ulp, cpu)[2]
    f64 = one_step(in_float64(host, weights), h_x.astype("float64"), h_y)
    cpu64_ulp = step_gaps(one_step(in_float64(host, weights),
                                   ulp.astype("float64"), h_y), f64)[2]
    f64 = step_gaps(one_step(in_float64(card, weights),
                             c_x.astype("float64"), c_y), f64)
    seconds = time.monotonic() - t0
    log("dygraph_resnet_oracle", batch=DY_ORACLE_BATCH,
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        loss_rel_gap=f32[0], loss_tolerance=DY_ORACLE_RTOL,
        running_stats=len(f32[1]), running_stats_max_rel_err=worst(f32[1]),
        gradients=len(f32[2]), grad_max_normwise_rel_err=worst(f32[2]),
        grad_median_normwise_rel_err=median(f32[2]),
        grad_tolerance=DY_ORACLE_GRAD_TOL,
        cpu_image_ulp_grad_max_normwise_rel_err=worst(cpu_ulp)[1],
        cpu_image_ulp_grad_median_normwise_rel_err=median(cpu_ulp),
        f64_loss_rel_gap=f64[0],
        f64_running_stats_max_rel_err=worst(f64[1]),
        f64_grad_max_normwise_rel_err=worst(f64[2]),
        f64_grad_median_normwise_rel_err=median(f64[2]),
        f64_tolerance=DY_ORACLE_F64_TOL,
        cpu_f64_image_f32_ulp_grad_max_normwise_rel_err=worst(cpu64_ulp)[1],
        cpu_f64_image_f32_ulp_grad_median_normwise_rel_err=median(cpu64_ulp),
        seconds=seconds)
    if (len(f32[1]), len(f32[2])) != (106, 161):
        raise RuntimeError(f"{len(f32[1])} running statistics and "
                           f"{len(f32[2])} gradients, want 106 and 161")
    if not f32[0] <= DY_ORACLE_RTOL or worst(f32[1])[1] > DY_ORACLE_RTOL \
            or worst(f32[2])[1] > DY_ORACLE_GRAD_TOL:
        raise RuntimeError(
            f"float32 card vs CPU after one step: loss gap {f32[0]}, "
            f"running statistic {worst(f32[1])}, gradient {worst(f32[2])}")
    if not f64[0] <= DY_ORACLE_F64_TOL \
            or worst(f64[1])[1] > DY_ORACLE_F64_TOL \
            or worst(f64[2])[1] > DY_ORACLE_F64_TOL:
        raise RuntimeError(
            f"float64 card vs CPU after one step: loss gap {f64[0]}, "
            f"running statistic {worst(f64[1])}, gradient {worst(f64[2])}")


# -- two decode replicas beside an executor's first capture --------------

# the serving model (phase_serve's 8 layers)
CONC_REQUESTS, CONC_PROMPT, CONC_NEW, CONC_LAYERS = 8, 200, 300, 8
# The profiler stays open this long after the card went idle.  Closed at
# once, 3 of 14 windows came back 1 to 16 B5 records short of the exact
# counts, and the card's last records can end milliseconds after the
# host's last sync on the profiler's clock; with the pause, 0 of 11
# (tools/profiler_tail.py, PERF.md).
PROFILER_TAIL_S = 0.5


def concurrency_program():
    """A new step key for the executor: 128 fc layers of width 512
    (forward only), long enough a capture to overlap decode steps."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program

    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        h = layers.data("x", [512])
        for _ in range(128):
            h = layers.fc(h, 512, act="relu")
        out = layers.mean(h)
    return main, startup, out


def phase_capture_concurrency():
    """Two decode replicas serve a burst while the executor captures a
    new key on the main thread, all under ``torch.profiler``: every
    request completes, the capture succeeds and credits none of the
    replicas' launches, and the B5 / B6 wrapper counts over the window
    equal both the layers times the decode steps / prefill dispatches the
    engines counted (one B5 a layer a step, one B6 a layer a prefill) and
    the ``paged_decode_kernel`` / ``paged_chunk_mma_kernel`` launches the
    profiler saw, so a record the profiler lost shows apart from a
    miscount."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    model = TransformerLM(vocab_size=32000, d_model=512,
                          num_layers=CONC_LAYERS, num_heads=8, ffn_dim=2048,
                          max_seq_len=1024, device=dev)
    weights = model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(6)
    srv = DecodeServer(model, weights, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16), replicas=2).start()
    main, startup, out = concurrency_program()
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": rng.randn(64, 512).astype("float32")}
    try:
        # each replica's decode step: its warm-up and its capture
        for eng in srv.replicas:
            eng.submit(rng.randint(1, 32000, 32).tolist(),
                       max_new_tokens=4).result(timeout=600)
        eager = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        torch.cuda.synchronize()
        prompts = [rng.randint(1, 32000, CONC_PROMPT).tolist()
                   for _ in range(CONC_REQUESTS)]
        captures = stat_get("cuda_graph_captures")
        engine_counts = ("decode_steps", "decode_prefills", "prefill_chunks")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            before = kernel_launches()
            engine_before = {k: stat_get(k) for k in engine_counts}
            reqs = [srv.submit(p, max_new_tokens=CONC_NEW) for p in prompts]
            t0 = time.monotonic()
            while pa.paged_decode_attention.launches - before["b5"] < 32:
                if time.monotonic() - t0 > 120:
                    raise RuntimeError("the burst did not start decoding")
                time.sleep(0.001)
            at_capture = kernel_launches()
            t_cap = time.monotonic()
            with record_function("executor_capture"):
                captured = exe.run(main, feed=feed, fetch_list=[out],
                                   scope=scope)[0]
            capture_s = time.monotonic() - t_cap
            after_capture = kernel_launches()
            for r in reqs:
                r.result(timeout=600)
            torch.cuda.synchronize()
            after = kernel_launches()
            engine = {k: stat_get(k) - engine_before[k]
                      for k in engine_counts}
            time.sleep(PROFILER_TAIL_S)
        in_flight = [r for r in reqs if len(r.generated) != CONC_NEW]
        entry = next(e for e in exe._cache.values()
                     if e.program is main)
        seen = {"b5": 0, "b6": 0}
        window = [(e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == "executor_capture"
                  and e.device_type == DeviceType.CPU]
        b5_starts = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kind = "b5" if "paged_decode_kernel" in e.name else \
                    "b6" if "paged_chunk_mma_kernel" in e.name else None
                if kind is None:
                    continue
                seen[kind] += 1
                if kind == "b5":
                    b5_starts.append(e.time_range.start)
        seen_in_capture = sum(window[0][0] <= t <= window[0][1]
                              for t in b5_starts) if window else None
        counted = {k: after[k] - before[k] for k in ("b5", "b6")}
        expected = {"b5": CONC_LAYERS * engine["decode_steps"],
                    "b6": CONC_LAYERS * engine["decode_prefills"]}
        during = {k: after_capture[k] - at_capture[k] for k in ("b5", "b6")}
        log("capture_concurrency", replicas=2, layers=CONC_LAYERS,
            requests=CONC_REQUESTS, prompt_tokens=CONC_PROMPT,
            new_tokens=CONC_NEW,
            capture_mode=entry.step.error_mode, capture_s=capture_s,
            executor_captures=stat_get("cuda_graph_captures") - captures,
            executor_capture_launches=list(entry.step.launches),
            launches_during_capture=during, engine_counts=engine,
            expected_counts=expected, wrapper_counts=counted,
            profiler_counts=seen, profiler_b5_in_capture=seen_in_capture,
            capture_window_us=window[0][1] - window[0][0] if window
            else None, requests_incomplete=len(in_flight),
            captured_vs_eager_max_abs=float(np.abs(captured - eager).max()))
        if in_flight:
            raise RuntimeError(f"{len(in_flight)} requests did not finish")
        if entry.graph is None or stat_get("cuda_graph_captures") \
                != captures + 1 or any(entry.step.launches):
            raise RuntimeError(f"the executor's capture: graph "
                               f"{entry.graph is not None}, launches "
                               f"{entry.step.launches}")
        if not during["b5"]:
            raise RuntimeError("no decode step ran during the capture: the "
                               "window proves nothing")
        if engine["prefill_chunks"] or counted != expected:
            raise RuntimeError(f"B5/B6 wrapper counts {counted} != "
                               f"{CONC_LAYERS} layers times the engines' "
                               f"steps and prefills {engine}")
        if counted != seen:
            raise RuntimeError(f"B5/B6 wrapper counts {counted} != the "
                               f"profiler's kernel counts {seen}")
        if not np.allclose(captured, eager, rtol=1e-5, atol=0):
            raise RuntimeError(f"captured {captured} vs eager {eager}")
    finally:
        srv.stop()
        exe.close()


# -- the 2.0 high-level API: Model.fit / evaluate / predict ----------------

# One epoch of FakeData(128 * 12) through MobileNetV2 at full width (the
# dataset's build and its pickling into each loader's workers, not the
# steps, set the phase's time: the epoch stays short); its
# first HAPI_SKIP steps (the warm-up, and in static mode the capture) are
# left out of the step p50, and so are the HAPI_PROFILE steps run under
# torch.profiler.
HAPI_BATCH, HAPI_STEPS, HAPI_SKIP, HAPI_WORKERS = 128, 12, 2, 4
HAPI_IMAGE, HAPI_EVAL_IMAGE = 224, 256   # train and eval images' sides
HAPI_PROFILE = (6, 3)              # (first step, steps) of the profiled window
HAPI_EVAL_BATCHES, HAPI_PREDICT_BATCHES = 4, 2
# The loader alone, nothing consuming: (workers, shared memory) and the
# batches timed after its first; the dygraph phase times each (the static
# phase's loader is the same, over the same data, and is not timed again).
HAPI_LOADERS = {(0, True): 3, (HAPI_WORKERS, True): 8,
                (HAPI_WORKERS, False): 4}
HAPI_PEAK_RTOL = 0.05              # peak memory after step 3 vs the last
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
# hapi_oracle: float32 MobileNetV2 at full width, batch 8, one step from
# one set of weights.  Losses within 1e-4 relative (card vs CPU, and the
# static adapter vs the dygraph one on the card); Accuracy's rows equal but
# where two logits at the top-k boundary lie within HAPI_TIE; the step's
# update (every parameter and running statistic together, norm-wise) within
# HAPI_UPDATE_TOL.  Measured (PERF.md, NVIDIA H100 80GB HBM3, 700 W): card
# vs CPU 5.8e-4, the CPU against itself for an image nudged by 1e-7
# relative 7.0e-4 (logged beside in every run), a batch-norm backward
# that drops a term 2.9e-2 (tools/hapi_oracle_faults.py).  5e-3 sits 8x
# above the first and 6x below the fault.
HAPI_ORACLE_BATCH, HAPI_ORACLE_RTOL, HAPI_TIE = 8, 1e-4, 1e-5
HAPI_UPDATE_TOL = 5e-3
HAPI_DATA = {}                     # the phases' datasets, built once
HAPI_FLOPS = {}                    # the static train program's FLOPs a step


def hapi_datasets():
    """(train, eval) FakeData: 1000 classes of 3x224x224 through a random
    flip and the ImageNet normalization; 3x256x256 through a center crop
    to 224 and the same normalization."""
    from paddle_tpu_torch.vision import datasets, transforms as tf

    if not HAPI_DATA:
        t0 = time.monotonic()
        HAPI_DATA["train"] = datasets.FakeData(
            num_samples=HAPI_BATCH * HAPI_STEPS,
            image_shape=(3, HAPI_IMAGE, HAPI_IMAGE),
            num_classes=1000, transform=tf.Compose([
                tf.RandomHorizontalFlip(),
                tf.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD,
                             data_format="CHW")]))
        HAPI_DATA["eval"] = datasets.FakeData(
            num_samples=HAPI_BATCH * HAPI_EVAL_BATCHES,
            image_shape=(3, HAPI_EVAL_IMAGE, HAPI_EVAL_IMAGE),
            num_classes=1000, seed=1, transform=tf.Compose([
                tf.CenterCrop(HAPI_IMAGE),
                tf.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD,
                             data_format="CHW")]))
        HAPI_DATA["build_s"] = time.monotonic() - t0
    return HAPI_DATA["train"], HAPI_DATA["eval"]


def hapi_model(static, steps, dropout=0.2, weights=None, device="gpu:0",
               lr=0.1):
    """``Model(mobilenet_v2(num_classes=1000))`` prepared as the 2.0 API's
    users write it: Momentum(CosineAnnealingDecay(lr, T_max=steps), 0.9,
    weight_decay=4e-5), CrossEntropyLoss, Accuracy(topk=(1, 5)); in
    static mode with image and label InputSpecs."""
    pt.set_device(device)
    pt.seed(0)
    net = pt.vision.models.mobilenet_v2(num_classes=1000)
    net.classifier._sub_layers["0"].p = dropout
    if weights is not None:
        pt.dygraph.state_dict_from_numpy(net, weights)
    if static:
        pt.enable_static()
    try:
        model = pt.Model(net, **(dict(
            inputs=[pt.InputSpec([None, 3, HAPI_IMAGE, HAPI_IMAGE],
                                 "float32", "image")],
            labels=[pt.InputSpec([None, 1], "int64", "label")])
            if static else {}))
        model.prepare(pt.optimizer.Momentum(
            learning_rate=pt.optimizer.lr.CosineAnnealingDecay(lr, T_max=steps),
            momentum=0.9, weight_decay=4e-5, parameters=model.parameters()),
            pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(topk=(1, 5)))
    finally:
        pt.disable_static()
    return model


def hapi_train_flops(batch):
    """FLOPs of one step of the static train program at ``batch``
    (``model_stat.program_flops``: convolutions and matmuls with their
    gradients, elementwise ops one a element)."""
    from paddle_tpu_torch.hapi.model_stat import program_flops

    if batch not in HAPI_FLOPS:
        model = hapi_model(True, HAPI_STEPS)
        HAPI_FLOPS[batch] = program_flops(model._st["train"]) * batch
        model._st["exe"].close()
    return HAPI_FLOPS[batch]


def device_busy_us(prof):
    """Microseconds in which the card ran a kernel or a copy, any stream:
    the union of their intervals (device prefetch copies on a side stream
    beside the step's kernels)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class HapiProbe(pt.hapi.callbacks.Callback):
    """Each train step's wall time from ``on_train_batch_begin`` to its end
    (``train_batch`` alone) and from the last step's end (the loader's
    wait included), its loss, the peak memory after step 3 and after the
    last, and one torch.profiler window over ``window``'s steps (their
    periods: from the first one's begin to the begin of the step after
    the last), kept open PROFILER_TAIL_S after its last sync.  First in
    the callback list: the profiler starts and stops in begin hooks, before
    ``BenchmarkCallback`` starts its clock."""

    def __init__(self, window=HAPI_PROFILE, skip=HAPI_SKIP):
        super().__init__()
        self.window, self.skip = window, skip
        self.step_ms, self.period_ms, self.losses = [], [], []
        self.prof = self.prof_wall_us = None
        self.peak_step3 = self.peak_last = None

    def on_train_begin(self, logs=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t_prev = time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        from torch.profiler import ProfilerActivity, profile

        if step == self.window[0]:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_prof = time.perf_counter()
        elif step == sum(self.window):
            torch.cuda.synchronize()
            self.prof_wall_us = (time.perf_counter() - self.t_prof) * 1e6
            time.sleep(PROFILER_TAIL_S)
            self.prof.__exit__(None, None, None)
        self.t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))   # the step's own sync
        t = time.perf_counter()
        self.step_ms.append((t - self.t0) * 1e3)
        self.period_ms.append((t - self.t_prev) * 1e3)
        if step == 2:
            self.peak_step3 = torch.cuda.max_memory_allocated()
        self.peak_last = torch.cuda.max_memory_allocated()
        self.t_prev = time.perf_counter()

    def timed(self, values):
        """The steps after ``skip`` but the profiled window's (and the
        step after it, whose period holds the profiler's stop)."""
        lo, n = self.window
        return [v for i, v in enumerate(values)
                if i >= self.skip and not lo <= i <= lo + n]


def loader_alone(dataset, workers, shared):
    """The training loader with nothing consuming: seconds to its first
    batch (the workers' start-up within it) and images/s over the next
    batches; the iterator is closed and its workers reaped."""
    from paddle_tpu_torch import io

    loader = io.DataLoader(dataset, batch_size=HAPI_BATCH, shuffle=True,
                           drop_last=True, num_workers=workers,
                           use_shared_memory=shared)
    t0 = time.perf_counter()
    it = iter(loader)
    next(it)
    t1 = time.perf_counter()
    n = HAPI_LOADERS[workers, shared]
    for _ in range(n):
        next(it)
    t2 = time.perf_counter()
    it.close()
    it._thread.join(timeout=60)
    if it._thread.is_alive():
        raise RuntimeError("the loader's fill thread did not stop")
    return {"workers": workers, "shared_memory": shared,
            "first_batch_s": t1 - t0,
            "worker_start_s": loader.worker_start_seconds,
            "images_per_s": n * HAPI_BATCH / (t2 - t1)}


def hapi_fit(static, batch):
    """The main path at ``batch``: ``fit`` over the 4-worker,
    device-prefetched loader with LRScheduler, BenchmarkCallback and
    EarlyStopping, then evaluate and predict; B1-B7's counts zeroed just
    before fit and read after predict."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi import callbacks as cb
    from paddle_tpu_torch.observe import step_stats
    from paddle_tpu_torch.observe.histogram import histogram

    train_ds, eval_ds = hapi_datasets()
    loader = io.DataLoader(train_ds, batch_size=batch, shuffle=True,
                           drop_last=True, num_workers=HAPI_WORKERS,
                           device_prefetch=True)
    flops = hapi_train_flops(batch)
    model = hapi_model(static, len(loader))
    peak = card_peaks(torch.cuda.get_device_name(0))[1]["float32"] / 1e12
    probe = HapiProbe()
    bench = cb.BenchmarkCallback(batch_size=batch, peak_tflops=peak,
                                 **({} if static else
                                    {"flops_per_step": flops}))
    histogram("input_wait_seconds").reset()
    step_stats.reset_step_stats()
    replays = stat_get("cuda_graph_replays")
    eager_seeded = stat_get("executor_eager_seeded_random")
    torch.cuda.synchronize()
    zero_kernel_launches()          # the path's counts start here
    t0 = time.monotonic()
    hist = model.fit(loader, epochs=1, verbose=0, callbacks=[
        probe, cb.LRScheduler(), bench, cb.EarlyStopping()])
    fit_s = time.monotonic() - t0
    fit_replays = stat_get("cuda_graph_replays") - replays
    wait = histogram("input_wait_seconds").summary()
    timer = step_stats.step_timer().summary(peak)
    replays = stat_get("cuda_graph_replays")
    t0 = time.monotonic()
    ev = model.evaluate(io.DataLoader(eval_ds, batch_size=batch,
                                      device_prefetch=True), verbose=0)
    eval_s = time.monotonic() - t0
    eval_replays = stat_get("cuda_graph_replays") - replays
    preds = model.predict(io.DataLoader(
        io.Subset(eval_ds, range(batch * HAPI_PREDICT_BATCHES)),
        batch_size=batch, device_prefetch=True), stack_outputs=True)[0]
    launches = kernel_launches()
    return dict(model=model, loader=loader, probe=probe, bench=bench,
                hist=hist, fit_s=fit_s, fit_replays=fit_replays, wait=wait,
                timer=timer, eval=ev, eval_s=eval_s,
                eval_replays=eval_replays, preds=preds, launches=launches,
                flops=flops, peak_tflops=peak, eager_seeded=stat_get(
                    "executor_eager_seeded_random") - eager_seeded)


def phase_hapi(static):
    """``hapi_dygraph`` / ``hapi_static``: the 2.0 high-level API's loop at
    full width (see the module docstring), batch 128 halved while it does
    not fit (logged as ``reduced``)."""
    phase = "hapi_static" if static else "hapi_dygraph"
    batch, reduced = HAPI_BATCH, []
    while True:
        try:
            r = hapi_fit(static, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            reason = f"batch {batch} ran out of device memory: " \
                     f"{str(e).splitlines()[0][:300]}"
        gc.collect()
        torch.cuda.empty_cache()
        reduced.append(reason)
        batch //= 2
        if batch < 8:
            raise RuntimeError(f"MobileNetV2 does not fit: {reduced}")
    probe, model = r["probe"], r["model"]
    steps = len(probe.losses)
    step = float(np.median(probe.timed(probe.step_ms)))
    periods = probe.timed(probe.period_ms)
    period = float(np.median(periods))
    waits = [p - s for p, s in zip(probe.period_ms, probe.step_ms)]
    wait = float(np.median(probe.timed(waits)))
    busy = device_busy_us(probe.prof)
    by_name = device_time_by_kernel(probe.prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    growth = probe.peak_last / probe.peak_step3 - 1.0
    loaders = [] if static else [loader_alone(HAPI_DATA["train"], w, shm)
                                 for w, shm in HAPI_LOADERS]
    reason = None
    if static:
        st = model._st
        reason = executor_mod.capture_reason(st["train"]) or \
            executor_mod.capture_reason(st["eval"])
    log(phase, model="mobilenet_v2", scale=1.0,
        image=[3, HAPI_IMAGE, HAPI_IMAGE],
        classes=1000, dtype="float32", api="static" if static else "dygraph",
        batch=batch, reduced=reduced, steps=steps,
        workers=HAPI_WORKERS, device_prefetch=True,
        optimizer="Momentum(CosineAnnealingDecay(0.1, T_max=steps), 0.9, "
                  "weight_decay=4e-5)",
        step_ms_p50=step, step_period_ms_p50=period,
        images_per_s=batch / (period / 1e3),
        images_per_s_mean=batch * len(periods) / (sum(periods) / 1e3),
        images_per_s_train_batch=batch / (step / 1e3),
        loader_wait_ms_p50=wait, loader_wait_share=wait / period,
        input_wait_seconds=r["wait"],
        loader_worker_start_s=r["loader"].worker_start_seconds,
        loader_alone=loaders, dataset_build_s=HAPI_DATA["build_s"],
        fit_s=r["fit_s"], profiled_steps=HAPI_PROFILE[1],
        profiled_window_ms=probe.prof_wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / probe.prof_wall_us,
        top_kernels_device_ms={k: v / 1e3 for k, v in top},
        peak_memory_gb_step3=probe.peak_step3 / 1e9,
        peak_memory_gb_last=probe.peak_last / 1e9,
        peak_memory_growth=growth, peak_memory_tolerance=HAPI_PEAK_RTOL,
        losses=probe.losses, step_ms=probe.step_ms,
        step_period_ms=probe.period_ms, flops_per_step=r["flops"],
        peak_tflops_float32=r["peak_tflops"],
        benchmark=r["bench"].last_summary, step_timer=r["timer"],
        cuda_graph_replays_fit=r["fit_replays"],
        cuda_graph_replays_eval=r["eval_replays"],
        capture_reason=reason,
        executor_eager_seeded_random=r["eager_seeded"],
        eval_batches=HAPI_EVAL_BATCHES, eval_s=r["eval_s"],
        eval_top1=r["eval"]["acc_top1"], eval_top5=r["eval"]["acc_top5"],
        eval_loss=r["eval"]["loss"], predict_shape=list(r["preds"].shape),
        launches_after=r["launches"])
    if not all(math.isfinite(v) for v in probe.losses):
        raise RuntimeError(f"{phase}: losses not finite: {probe.losses}")
    if any(r["launches"].values()):
        raise RuntimeError(f"{phase} launched hand-written kernels: "
                           f"{r['launches']}")
    if abs(growth) > HAPI_PEAK_RTOL:
        raise RuntimeError(f"{phase}: peak memory grew by {growth:.3f} "
                           f"from step 3 to the last")
    n_pred = batch * HAPI_PREDICT_BATCHES
    if r["preds"].shape != (n_pred, 1000) or \
            not np.isfinite(r["preds"]).all():
        raise RuntimeError(f"{phase}: predictions {r['preds'].shape}, "
                           f"finite {np.isfinite(r['preds']).all()}")
    if static and reason is None and (
            r["fit_replays"] != steps - 1
            or r["eval_replays"] != HAPI_EVAL_BATCHES - 1):
        raise RuntimeError(f"{phase}: {r['fit_replays']} replays in fit "
                           f"({steps} steps), {r['eval_replays']} in "
                           f"evaluate ({HAPI_EVAL_BATCHES} batches)")
    if static:
        model._st["exe"].close()


class RowsAccuracy(pt.metric.Accuracy):
    """Accuracy that keeps each batch's correct-rows and logits."""

    def compute(self, pred, label):
        self.logits = np.asarray(pred.numpy())
        self.rows = super().compute(pred, label)
        return self.rows


def hapi_oracle_step(model, x, y, device):
    """One ``train_batch`` on ``device`` (the place its inputs go to):
    (loss, Accuracy rows, logits, state after it)."""
    pt.set_device(device)
    acc = model._metrics[0] = RowsAccuracy(topk=(1, 5))
    loss = model.train_batch([x], [y])["loss"]
    state = {k: v.numpy() for k, v in model.network.state_dict().items()}
    pt.set_device("gpu:0")
    return float(loss), acc.rows, acc.logits, state


def update_gap(init, a, b):
    """||(a - init) - (b - init)|| / ||a - init||, every parameter and
    running statistic together, in float64."""
    da = np.concatenate([(a[k].astype("f8") - init[k]).ravel()
                         for k in init])
    db = np.concatenate([(b[k].astype("f8") - init[k]).ravel()
                         for k in init])
    return float(np.linalg.norm(da - db) / np.linalg.norm(da))


def tied_rows(rows_a, rows_b, logits, topk=(1, 5)):
    """Rows whose correctness differs, each with whether the logits at its
    top-k boundary lie within HAPI_TIE (the only case allowed)."""
    out = []
    for r in np.nonzero((rows_a != rows_b).any(axis=1))[0]:
        srt = np.sort(logits[r])[::-1]
        tie = any(srt[k - 1] - srt[k] <= HAPI_TIE for k in topk)
        out.append({"row": int(r), "tie": bool(tie)})
    return out


def phase_hapi_oracle():
    """float32, batch 8, full width, one seeded set of weights carried by
    ``state_dict``, one batch: the dygraph ``train_batch`` on the card
    against the CPU (loss, Accuracy rows, the step's update), and the
    static adapter against the dygraph one on the card (loss)."""
    pt.set_device("gpu:0")
    pt.seed(1)
    init = {k: v.numpy() for k, v in pt.vision.models.mobilenet_v2(
        num_classes=1000).state_dict().items()}
    rng = np.random.RandomState(7)
    x = rng.randn(HAPI_ORACLE_BATCH, 3, HAPI_IMAGE,
                  HAPI_IMAGE).astype("float32")
    y = rng.randint(0, 1000, (HAPI_ORACLE_BATCH, 1)).astype("int64")
    nudged = (x * (1 + 1e-7 * rng.randn(*x.shape))).astype("float32")
    t0 = time.monotonic()
    card = hapi_oracle_step(hapi_model(False, 1, 0.0, init), x, y, "gpu:0")
    cpu = hapi_oracle_step(hapi_model(False, 1, 0.0, init, "cpu"), x, y,
                           "cpu")
    cpu_nudged = hapi_oracle_step(hapi_model(False, 1, 0.0, init, "cpu"),
                                  nudged, y, "cpu")
    static = hapi_model(True, 1, 0.0, init)
    static_loss = float(static.train_batch([x], [y])["loss"])
    static._st["exe"].close()
    seconds = time.monotonic() - t0
    loss_gap = abs(card[0] - cpu[0]) / abs(cpu[0])
    static_gap = abs(static_loss - card[0]) / abs(card[0])
    rows = tied_rows(card[1], cpu[1], cpu[2])
    gap = update_gap(init, cpu[3], card[3])
    own = update_gap(init, cpu[3], cpu_nudged[3])
    log("hapi_oracle", batch=HAPI_ORACLE_BATCH, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        card_loss=card[0], cpu_loss=cpu[0], loss_rel_gap=loss_gap,
        static_loss=static_loss, static_vs_dygraph_rel_gap=static_gap,
        loss_tolerance=HAPI_ORACLE_RTOL, accuracy_rows_differing=rows,
        tie_tolerance=HAPI_TIE, update_normwise_rel_gap=gap,
        update_tolerance=HAPI_UPDATE_TOL,
        cpu_nudged_image_update_normwise_rel_gap=own, seconds=seconds)
    if not loss_gap <= HAPI_ORACLE_RTOL or \
            not static_gap <= HAPI_ORACLE_RTOL:
        raise RuntimeError(f"hapi step-1 loss: card {card[0]} vs CPU "
                           f"{cpu[0]}, static {static_loss}")
    if not all(r["tie"] for r in rows):
        raise RuntimeError(f"Accuracy rows differ without a tie: {rows}")
    if not gap <= HAPI_UPDATE_TOL:
        raise RuntimeError(f"the step's update, card vs CPU, parts by "
                           f"{gap} (> {HAPI_UPDATE_TOL}; the CPU against "
                           f"itself for a nudged image: {own})")


# ---------------------------------------------------------------------------
# text: Transformer-base NMT, beam search, the PTB LSTM language model
# ---------------------------------------------------------------------------

# Transformer-base NMT (Vaswani et al. 2017): ``nn.Transformer`` at its
# defaults (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1), a
# shared source / target vocabulary of 37,000 (the paper's EN-DE BPE size),
# 64 pairs of 64 tokens (4,096 target tokens, the token batch of Paddle's
# Transformer-base configuration), Adam(0.9, 0.98, 1e-9) under
# NoamDecay(512, 4000); float32.  The first NMT_SKIP steps and the profiled
# window are left out of the step p50.
NMT_VOCAB, NMT_D, NMT_BATCH, NMT_LEN, NMT_MAX_POS = 37000, 512, 64, 64, 256
NMT_HEADS, NMT_LAYERS, NMT_FFN = 8, 6, 2048     # nn.Transformer's defaults
NMT_BOS, NMT_EOS, NMT_WARMUP, NMT_SMOOTH = 1, 2, 4000, 0.1
NMT_STEPS, NMT_SKIP, NMT_PROFILE = 20, 2, (10, 5)
# Beam search with the trained model: 8 source sentences, beam 4, GNMT
# length penalty 0.6, 64 new tokens, the decoder run over the prefix at
# every step (the JAX package's decoder takes no cache).
DECODE_SENTENCES, DECODE_BEAM, DECODE_ALPHA, DECODE_MAX_LEN = 8, 4, 0.6, 64
# The PTB language model, Zaremba et al. 2014 "large": vocabulary 10,000,
# embedding and 2 LSTM layers of 1,500, dropout 0.65 on the embedding,
# between the layers and on the output, 20 windows of 35 steps, SGD at lr
# 1.0 under ClipGradByGlobalNorm(10); float32.  The corpus is a synthetic
# ``simple-examples`` tarball of about 1M tokens whose vocabulary after
# min_word_freq=50 is 9,999 words and ``<unk>``.
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_DROPOUT = 10000, 1500, 2, 0.65
PTB_BATCH, PTB_BPTT, PTB_MIN_FREQ, PTB_CLIP = 20, 35, 50, 10.0
PTB_STEPS, PTB_SKIP, PTB_PROFILE = 30, 2, (15, 5)
PTB_RARE_WORDS, PTB_RARE_COUNT, PTB_ZIPF_TOKENS = 4000, 25, 400_000
TEXT_PEAK_RTOL = 0.05              # peak memory after step 3 vs the last
# text_oracle: the card against the port's CPU path from the same weights.
# Step-1 losses (float32, dropout 0, through Model.eval_batch): summation
# order over 6 + 6 layers or 2 LSTM layers of 35 steps, and a 37,000- or
# 10,000-way log-softmax.  The rnn op in float64: 1e-10 of the largest
# magnitude (the ResNet oracle's float64 bound; a float64 op is exact to
# about 1e-16 an operation).  Beam scores: sums of 64 float32 log-probs
# after 6 + 6 layers, divided by the length penalty.
TEXT_ORACLE_BATCH, TEXT_ORACLE_RTOL = 4, 1e-4
RNN_ORACLE_TOL, BEAM_SCORE_TOL = 1e-10, 1e-3
RNN_ORACLE_SHAPE = (35, 8, 256, 256)    # T, B, input, hidden
# nn_extras: the new lowerings, card against CPU, forward and gradient,
# float32 with TF32 off: 1e-4 of the largest magnitude (sums over 64 x 16
# window terms, or over a group's 100,352 values).
NN_EXTRAS_RTOL = 1e-4
NN_EXTRAS_CASES = (   # (label, op, input shapes, attrs)
    ("conv2d_transpose_dcgan", "conv2d_transpose",
     dict(Input=(64, 512, 8, 8), Filter=(512, 256, 4, 4)),
     dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1], groups=1,
          data_format="NCHW", output_padding=[], output_size=[])),
    ("group_norm_32", "group_norm",
     dict(X=(32, 256, 56, 56), Scale=(256,), Bias=(256,)),
     dict(groups=32, epsilon=1e-5)),
    ("instance_norm", "instance_norm",
     dict(X=(16, 64, 128, 128), Scale=(64,), Bias=(64,)),
     dict(epsilon=1e-5)),
)
TEXT_STATE = {}                     # what the text phases hand on


def sinusoid_table(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    return np.where(i % 2 == 0, np.sin(angle), np.cos(angle)).astype("f4")


class Seq2Seq(pt.nn.Layer):
    """Transformer NMT: one embedding for source and target, scaled by
    sqrt(d_model), plus fixed sinusoidal positions (an embedding that does
    not train, as Paddle's Transformer example feeds them);
    ``nn.Transformer`` at its defaults with a causal decoder mask; the
    output projection tied to the embedding."""

    def __init__(self, dropout=0.1):
        super().__init__()
        self.emb = pt.nn.Embedding(NMT_VOCAB, NMT_D)
        self.pos = pt.nn.Embedding(NMT_MAX_POS, NMT_D, weight_attr=pt.ParamAttr(
            initializer=pt.initializer.NumpyArrayInitializer(
                sinusoid_table(NMT_MAX_POS, NMT_D)), trainable=False))
        self.transformer = pt.nn.Transformer(
            NMT_D, NMT_HEADS, NMT_LAYERS, NMT_LAYERS, NMT_FFN, dropout)

    def embed(self, ids):
        pos = self.pos(pt.arange(ids.shape[1], dtype="int64"))
        return self.emb(ids) * float(np.sqrt(NMT_D)) + pos

    def logits(self, h):
        return pt.matmul(h, self.emb.weight, transpose_y=True)

    def forward(self, src, tgt):
        mask = self.transformer.generate_square_subsequent_mask(tgt.shape[1])
        return self.logits(self.transformer(self.embed(src), self.embed(tgt),
                                            tgt_mask=mask))


class SmoothedCrossEntropy(pt.nn.Layer):
    """``CrossEntropyLoss(soft_label=True)`` on
    ``label_smooth(one_hot(label, vocabulary), epsilon)``, as Paddle's
    Transformer example computes its loss."""

    def __init__(self, vocab, epsilon):
        super().__init__()
        self.vocab, self.epsilon = vocab, epsilon
        self.ce = pt.nn.CrossEntropyLoss(soft_label=True)

    def forward(self, logits, label):
        return self.ce(logits, pt.nn.functional.label_smooth(
            pt.nn.functional.one_hot(label, self.vocab),
            epsilon=self.epsilon))


class LanguageModel(pt.nn.Layer):
    """The PTB LSTM language model: embedding, dropout, ``nn.LSTM`` with
    dropout between its layers, dropout, a vocabulary-wide ``Linear``."""

    def __init__(self, dropout=PTB_DROPOUT):
        super().__init__()
        self.emb = pt.nn.Embedding(PTB_VOCAB, PTB_HIDDEN)
        self.drop = pt.nn.Dropout(dropout)
        self.lstm = pt.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, num_layers=PTB_LAYERS,
                               dropout=dropout)
        self.out = pt.nn.Linear(PTB_HIDDEN, PTB_VOCAB)

    def forward(self, ids):
        h, _ = self.lstm(self.drop(self.emb(ids)))
        return self.out(self.drop(h))


class Windows(pt.io.Dataset):
    """``Imikolov`` NGRAM windows as (ids[:-1], ids[1:, None]): the input
    and its next-token labels."""

    def __init__(self, ngrams):
        self.ngrams = ngrams

    def __getitem__(self, i):
        w = self.ngrams[i]
        return w[:-1], w[1:, None]

    def __len__(self):
        return len(self.ngrams)


def nmt_pairs(n, seed):
    """(source, target input, label) [n, 64]: tokens above EOS, the label
    the reversed source, the target input the label behind BOS."""
    rs = np.random.RandomState(seed)
    src = rs.randint(NMT_EOS + 1, NMT_VOCAB, (n, NMT_LEN)).astype("int64")
    label = np.ascontiguousarray(src[:, ::-1])
    tgt = np.concatenate([np.full((n, 1), NMT_BOS, "int64"), label[:, :-1]],
                         axis=1)
    return src, tgt, label


def write_ptb(path, seed=0):
    """A ``simple-examples`` tarball: ptb.train.txt holds 9,999 words
    w0..w9998 seen 50 times each plus a Zipf share of PTB_ZIPF_TOKENS, and
    PTB_RARE_WORDS words seen PTB_RARE_COUNT times (below min_word_freq,
    so ``<unk>``), shuffled into lines of 36 to 70 words; ptb.valid.txt
    2,000 of the same tokens.  Returns the number of training tokens."""
    import io as _io
    import tarfile

    rs = np.random.RandomState(seed)
    n = PTB_VOCAB - 1
    zipf = 1.0 / np.arange(1, n + 1)
    counts = PTB_MIN_FREQ + np.floor(PTB_ZIPF_TOKENS * zipf / zipf.sum())
    words = np.array([f"w{i}" for i in range(n)]
                     + [f"r{i}" for i in range(PTB_RARE_WORDS)])
    reps = np.concatenate([counts.astype("int64"),
                           np.full(PTB_RARE_WORDS, PTB_RARE_COUNT)])
    tokens = words[rs.permutation(np.repeat(np.arange(len(words)), reps))]
    cuts = np.cumsum(rs.randint(36, 71, len(tokens) // 36))
    cuts = cuts[cuts < len(tokens)]
    lines = [" ".join(seg) for seg in np.split(tokens, cuts)]
    train = ("".join(" " + ln + " \n" for ln in lines)).encode()
    valid = ("".join(" " + ln + " \n" for ln in lines[:40])).encode()
    with tarfile.open(path, "w:gz", compresslevel=1) as tf:
        for split, data in (("train", train), ("valid", valid)):
            info = tarfile.TarInfo(f"./simple-examples/data/ptb.{split}.txt")
            info.size = len(data)
            tf.addfile(info, _io.BytesIO(data))
    return len(tokens)


def text_model(kind, device="gpu:0", dropout=None, weights=None):
    """The NMT or LM network on ``device`` (seeded), with ``weights``
    (a state dict of numpy arrays) when given."""
    pt.set_device(device)
    pt.seed(0)
    if kind == "nmt":
        net = Seq2Seq(0.1 if dropout is None else dropout)
    else:
        net = LanguageModel(PTB_DROPOUT if dropout is None else dropout)
    if weights is not None:
        pt.dygraph.state_dict_from_numpy(net, weights)
    return net


def text_prepare(kind, net):
    if kind == "nmt":
        opt = pt.optimizer.Adam(
            learning_rate=pt.optimizer.lr.NoamDecay(NMT_D, NMT_WARMUP),
            beta1=0.9, beta2=0.98, epsilon=1e-9,
            parameters=net.parameters())
        loss = SmoothedCrossEntropy(NMT_VOCAB, NMT_SMOOTH)
    else:
        opt = pt.optimizer.SGD(
            learning_rate=1.0, parameters=net.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(PTB_CLIP))
        loss = pt.nn.CrossEntropyLoss()
    model = pt.Model(net)
    model.prepare(opt, loss)
    return model


def text_fit(kind, dataset, batch, window, skip):
    """``Model.fit`` for one epoch over a 0-worker loader of ``dataset``
    with the LRScheduler callback; B1-B7's counts zeroed just before and
    read just after; then one more step with its ops counted."""
    from paddle_tpu_torch.hapi import callbacks as cb

    net = text_model(kind)
    model = text_prepare(kind, net)
    loader = pt.io.DataLoader(dataset, batch_size=batch, shuffle=True,
                              drop_last=True, num_workers=0)
    probe = HapiProbe(window, skip)
    torch.cuda.synchronize()
    zero_kernel_launches()          # the path's counts start here
    t0 = time.monotonic()
    model.fit(loader, epochs=1, verbose=0,
              callbacks=[probe, cb.LRScheduler()])
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = kernel_launches()
    xs, ys = model._split_batch(next(iter(loader)))
    ops = counted_ops(lambda: model.train_batch(xs, ys))
    return dict(net=net, model=model, probe=probe, fit_s=fit_s,
                launches=launches, ops=ops)


def log_text_fit(phase, r, tokens, card, **fields):
    """The fit's numbers (the HapiProbe ones) and its checks."""
    probe = r["probe"]
    step = float(np.median(probe.timed(probe.step_ms)))
    period = float(np.median(probe.timed(probe.period_ms)))
    busy = device_busy_us(probe.prof)
    top = sorted(device_time_by_kernel(probe.prof).items(),
                 key=lambda kv: -kv[1])[:12]
    growth = probe.peak_last / probe.peak_step3 - 1.0
    ops = r["ops"]
    log(phase, card=card, api="dygraph", dtype="float32",
        steps=len(probe.losses), step_ms_p50=step,
        step_period_ms_p50=period,
        target_tokens_per_s=tokens / (period / 1e3),
        target_tokens_per_s_train_batch=tokens / (step / 1e3),
        fit_s=r["fit_s"], ops_per_step=sum(ops.values()),
        ops_by_type=dict(sorted(ops.items(), key=lambda kv: -kv[1])[:15]),
        profiled_steps=probe.window[1],
        profiled_window_ms=probe.prof_wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / probe.prof_wall_us,
        top_kernels_device_ms={k: v / 1e3 for k, v in top},
        peak_memory_gb_step3=probe.peak_step3 / 1e9,
        peak_memory_gb_last=probe.peak_last / 1e9,
        peak_memory_growth=growth, peak_memory_tolerance=TEXT_PEAK_RTOL,
        loss_first=probe.losses[0], loss_last=probe.losses[-1],
        losses=probe.losses, step_ms=probe.step_ms,
        launches_after=r["launches"], **fields)
    if not all(math.isfinite(v) for v in probe.losses):
        raise RuntimeError(f"{phase}: losses not finite: {probe.losses}")
    if any(r["launches"].values()):
        raise RuntimeError(f"{phase} launched hand-written kernels: "
                           f"{r['launches']}")
    if abs(growth) > TEXT_PEAK_RTOL:
        raise RuntimeError(f"{phase}: peak memory grew by {growth:.3f} "
                           f"from step 3 to the last")


def phase_text_transformer():
    """Transformer-base NMT through ``Model.fit`` in dygraph (see the
    constants above)."""
    card = nvidia_smi("name,power.limit")
    t0 = time.monotonic()
    data = pt.io.TensorDataset(nmt_pairs(NMT_BATCH * NMT_STEPS, seed=0))
    data_s = time.monotonic() - t0
    r = text_fit("nmt", data, NMT_BATCH, NMT_PROFILE, NMT_SKIP)
    n_params = sum(p._value.numel() for p in r["net"].parameters())
    log_text_fit(
        "text_transformer", r, NMT_BATCH * NMT_LEN, card,
        model="transformer_base", vocab=NMT_VOCAB, d_model=NMT_D,
        heads=NMT_HEADS, layers=[NMT_LAYERS, NMT_LAYERS], ffn=NMT_FFN,
        dropout=0.1, batch=NMT_BATCH,
        seq_len=NMT_LEN, parameters=n_params, label_smooth=NMT_SMOOTH,
        optimizer=f"Adam(0.9, 0.98, 1e-9) under NoamDecay({NMT_D}, "
                  f"{NMT_WARMUP})", loader_workers=0, dataset_build_s=data_s)
    TEXT_STATE["nmt"] = r["net"]


def nmt_step_fn(net):
    """``beam_search``'s step: the decoder over the whole prefix (the
    state's second item, to which each step appends its token) and the
    encoder's memory; the logits of the last position."""
    def step(tok, state):
        memory, prefix = state
        prefix = torch.cat([prefix, tok[:, None]], dim=1)
        mask = net.transformer.generate_square_subsequent_mask(
            prefix.shape[1])
        h = net.transformer.decoder(net.embed(pt.Tensor(prefix)),
                                    pt.Tensor(memory), tgt_mask=mask)
        return net.logits(h[:, -1]), (memory, prefix)

    return step


def nmt_beam_search(net, src):
    """``text.decode.beam_search`` over ``src`` [B, S] (numpy) with the
    net in eval mode, on the net's device: (ids [B, K, T], scores [B, K])."""
    net.eval()
    dev = net.emb.weight._value.device
    with pt.no_grad():
        memory = net.transformer.encoder(net.embed(pt.Tensor(
            torch.from_numpy(src).to(dev))))._value
    b = src.shape[0]
    state = (memory, torch.zeros((b, 0), dtype=torch.long, device=dev))
    return pt.text.decode.beam_search(
        nmt_step_fn(net), state,
        torch.full((b,), NMT_BOS, dtype=torch.long, device=dev),
        DECODE_BEAM, DECODE_MAX_LEN, NMT_EOS, length_penalty=DECODE_ALPHA)


def phase_text_decode():
    """Beam search with the trained Transformer: one warm-up decode, then
    two timed, each synced; B1-B7 at 0 launches."""
    card = nvidia_smi("name,power.limit")
    net = TEXT_STATE["nmt"]
    src = nmt_pairs(DECODE_SENTENCES, seed=5)[0]
    nmt_beam_search(net, src)
    torch.cuda.synchronize()
    zero_kernel_launches()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        ids, scores = nmt_beam_search(net, src)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    decode_ms = float(np.median(ms))
    hyp_tokens = DECODE_SENTENCES * DECODE_BEAM * DECODE_MAX_LEN
    log("text_decode", card=card, sentences=DECODE_SENTENCES,
        beam=DECODE_BEAM, length_penalty=DECODE_ALPHA,
        max_len=DECODE_MAX_LEN, decode_ms=ms, decode_ms_p50=decode_ms,
        generated_tokens_per_s=DECODE_SENTENCES * DECODE_MAX_LEN
        / (decode_ms / 1e3),
        hypothesis_tokens_per_s=hyp_tokens / (decode_ms / 1e3),
        decoder_positions_per_decode=DECODE_SENTENCES * DECODE_BEAM
        * DECODE_MAX_LEN * (DECODE_MAX_LEN + 1) // 2,
        ids_shape=list(ids.shape), best_scores=scores[:, 0].tolist(),
        eos_emitted=int((ids == NMT_EOS).sum()), launches_after=launches)
    if ids.shape != (DECODE_SENTENCES, DECODE_BEAM, DECODE_MAX_LEN) or \
            not np.isfinite(scores).all() or \
            (np.diff(scores, axis=1) > 0).any():
        raise RuntimeError(f"beam search: ids {ids.shape}, scores {scores}")
    if any(launches.values()):
        raise RuntimeError(f"text_decode launched hand-written kernels: "
                           f"{launches}")
    TEXT_STATE["decode"] = (src, ids, scores)


def rnn_weight_copies(lstm, dev):
    """Whether the fused route copies the layer's weights on each call
    (cuDNN warns that they are not one contiguous chunk), and its forward
    and backward ms beside torch.nn.LSTM holding the same weights in
    cuDNN's flat buffer, at the path's shape of one layer's op (the path
    runs one op a layer: dropout between them)."""
    import warnings

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(PTB_BPTT, PTB_BATCH, PTB_HIDDEN, device=dev,
                    generator=gen)
    h0 = torch.zeros(1, PTB_BATCH, PTB_HIDDEN, device=dev)
    gout = torch.randn(PTB_BPTT, PTB_BATCH, PTB_HIDDEN, device=dev,
                       generator=gen)
    weights = [p._value for p in lstm._layer_weights(0)]   # the op's order
    ref = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN).to(dev)
    with torch.no_grad():
        for dst, src in zip(ref._flat_weights, weights):
            dst.copy_(src)
    ref.flatten_parameters()
    flat = ref._flat_weights

    def fwd(params):
        return lambda: torch._VF.lstm(x, (h0, h0), params, True, 1, 0.0,
                                      True, False, False)[0]

    def fwd_bwd(params):
        return lambda: torch.autograd.grad(fwd(params)(), params, gout)

    def copy_warnings(params):
        """(the op's output, cuDNN's warnings that it copies weights)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.no_grad():
                out = fwd(params)()
            torch.cuda.synchronize()
        return out, [str(w.message) for w in caught
                     if "contiguous" in str(w.message)]

    out_layer, layer_warned = copy_warnings(weights)
    out_flat, flat_warned = copy_warnings(flat)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        times = {"fwd_layer_params_ms": cuda_ms(fwd(weights), l2.zero_),
                 "fwd_flat_buffer_ms": cuda_ms(fwd(flat), l2.zero_),
                 "fwd_bwd_layer_params_ms": cuda_ms(fwd_bwd(weights),
                                                    l2.zero_),
                 "fwd_bwd_flat_buffer_ms": cuda_ms(fwd_bwd(flat), l2.zero_)}
    return dict(copies_each_call=bool(layer_warned),
                flat_buffer_copies=bool(flat_warned),
                warning=(layer_warned or [None])[0],
                layer_vs_flat_max_abs_gap=float(
                    (out_layer - out_flat).abs().max()),
                weight_mb=sum(w.numel() for w in weights) * 4 / 1e6,
                **times)


def phase_text_lstm():
    """The PTB language model through ``Model.fit`` in dygraph over
    ``text.datasets.Imikolov`` windows of a synthetic tarball (see the
    constants above)."""
    card = nvidia_smi("name,power.limit")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "simple-examples.tgz")
        t0 = time.monotonic()
        n_tokens = write_ptb(path)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        ngrams = pt.text.datasets.Imikolov(
            path, data_type="NGRAM", window_size=PTB_BPTT + 1,
            min_word_freq=PTB_MIN_FREQ)
        read_s = time.monotonic() - t0
    if len(ngrams.word_idx) != PTB_VOCAB:
        raise RuntimeError(f"the synthetic corpus's vocabulary is "
                           f"{len(ngrams.word_idx)}, not {PTB_VOCAB}")
    windows = Windows(ngrams)
    order = np.random.RandomState(1).permutation(len(windows))
    data = pt.io.Subset(windows, order[:PTB_BATCH * PTB_STEPS].tolist())
    r = text_fit("lm", data, PTB_BATCH, PTB_PROFILE, PTB_SKIP)
    copies = rnn_weight_copies(r["net"].lstm, torch.device("cuda", 0))
    log_text_fit(
        "text_lstm", r, PTB_BATCH * PTB_BPTT, card, model="ptb_lstm_large",
        vocab=PTB_VOCAB, embedding=PTB_HIDDEN, hidden=PTB_HIDDEN,
        layers=PTB_LAYERS, dropout=PTB_DROPOUT, batch=PTB_BATCH,
        bptt=PTB_BPTT, optimizer=f"SGD(1.0), ClipGradByGlobalNorm({PTB_CLIP})",
        corpus_tokens=n_tokens, windows=len(windows),
        corpus_write_s=write_s, imikolov_read_s=read_s, loader_workers=0,
        rnn_weight_copy=copies)
    TEXT_STATE["ptb_windows"] = windows


def text_loss(kind, weights, device, xs, ys):
    """Step 1's loss through ``Model.eval_batch`` with dropout 0."""
    model = text_prepare(kind, text_model(kind, device, 0.0, weights))
    loss = float(model.eval_batch(xs, ys)["loss"])
    pt.set_device("gpu:0")
    return loss


def rnn_op_pair(mode, card="cuda"):
    """One ``rnn`` op (2 layers, bidirectional) in float64, forward and
    backward on the card and on the CPU from the same inputs: the largest
    gap over the outputs and every input's gradient, each relative to the
    CPU value's largest magnitude."""
    from paddle_tpu_torch.dygraph.eager import run_op

    t, b, i, h = RNN_ORACLE_SHAPE
    g = {"LSTM": 4, "GRU": 3}[mode]
    rs = np.random.RandomState(4)
    arrays = [rs.randn(t, b, i)] + [rs.randn(4, b, h) * 0.5
                                    for _ in range(2 if mode == "LSTM"
                                                   else 1)]
    ws, bs = [], []
    for layer in range(2):
        for _ in range(2):
            in_sz = i if layer == 0 else 2 * h
            ws += [rs.randn(g * h, in_sz) / np.sqrt(h),
                   rs.randn(g * h, h) / np.sqrt(h)]
            bs += [rs.randn(g * h) * 0.1, rs.randn(g * h) * 0.1]
    arrays += ws + bs
    n_state = len(arrays) - len(ws) - len(bs) - 1
    results = []
    for dev in (card, "cpu"):
        vals = [torch.tensor(a, dtype=torch.float64, device=dev,
                             requires_grad=True) for a in arrays]
        res = run_op("rnn", {"Input": vals[0],
                             "PreState": vals[1:1 + n_state],
                             "WeightList": vals[1 + n_state:]},
                     {"mode": mode, "num_layers": 2, "is_bidirec": True,
                      "hidden_size": h},
                     out_slots=("Out", "State"),
                     out_counts={"State": n_state})
        outs = [res["Out"]._value] + [
            s._value for s in (res["State"] if n_state > 1
                               else [res["State"]])]
        cots = [torch.from_numpy(np.random.RandomState(9 + k).randn(
            *o.shape)).to(dev) for k, o in enumerate(outs)]
        grads = torch.autograd.grad(outs, vals, cots)
        results.append([o.detach().cpu() for o in outs]
                       + [gr.cpu() for gr in grads])
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for a, b in zip(*results))


def rescore(net, src, ids):
    """Each hypothesis of ``ids`` [B, K, T] scored by one teacher-forced
    pass of ``net`` (on its device) over [BOS] + hypothesis: the summed
    log-probs of its tokens up to and including the first EOS, divided by
    the GNMT length penalty, as ``beam_search`` scores it."""
    b, k, t = ids.shape
    dev = net.emb.weight._value.device
    hyp = torch.from_numpy(ids.reshape(b * k, t)).long().to(dev)
    tgt = torch.cat([torch.full((b * k, 1), NMT_BOS, dtype=torch.long,
                                device=dev), hyp[:, :-1]], dim=1)
    srcs = torch.from_numpy(np.repeat(src, k, axis=0)).to(dev)
    net.eval()
    with pt.no_grad():
        logits = net(pt.Tensor(srcs), pt.Tensor(tgt))._value
    lp = torch.log_softmax(logits.float(), dim=-1).gather(
        2, hyp[:, :, None])[:, :, 0]
    is_eos = hyp == NMT_EOS
    length = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1, t)
    keep = torch.arange(t, device=dev)[None, :] < length[:, None]
    score = (lp * keep).sum(1) / ((5.0 + length.float()) / 6.0) ** DECODE_ALPHA
    return score.reshape(b, k).cpu().numpy()


def phase_text_oracle():
    """The card against the port's CPU path from the same weights: both
    models' step-1 loss (dropout 0), one float64 ``rnn`` op (LSTM and
    GRU) forward and backward, and the card's beam hypotheses re-scored
    on the CPU, whose own beam search finds no better best beam."""
    card = nvidia_smi("name,power.limit")
    t0 = time.monotonic()
    nmt = {k: v.numpy() for k, v in TEXT_STATE["nmt"].state_dict().items()}
    src, tgt, label = nmt_pairs(TEXT_ORACLE_BATCH, seed=7)
    nmt_losses = [text_loss("nmt", nmt, dev, [src, tgt], [label])
                  for dev in ("gpu:0", "cpu")]
    lm = {k: v.numpy() for k, v in text_model(
        "lm", dropout=0.0).state_dict().items()}
    win = TEXT_STATE["ptb_windows"]
    items = [win[i] for i in range(TEXT_ORACLE_BATCH)]
    xs, ys = [np.stack([a for a, _ in items])], [np.stack([b for _, b in
                                                            items])]
    lm_losses = [text_loss("lm", lm, dev, xs, ys)
                 for dev in ("gpu:0", "cpu")]
    losses_s = time.monotonic() - t0
    t0 = time.monotonic()
    rnn_gaps = {mode: rnn_op_pair(mode) for mode in ("LSTM", "GRU")}
    rnn_s = time.monotonic() - t0
    src_d, ids, scores = TEXT_STATE["decode"]
    t0 = time.monotonic()
    cpu_net = text_model("nmt", "cpu", 0.1, nmt)
    rescored = rescore(cpu_net, src_d, ids)
    rescore_s = time.monotonic() - t0
    t0 = time.monotonic()
    cpu_ids, cpu_scores = nmt_beam_search(cpu_net, src_d)
    cpu_beam_s = time.monotonic() - t0
    pt.set_device("gpu:0")
    cpu_scores = cpu_scores.numpy()
    rescore_gap = float(np.abs(rescored - scores).max())
    best_gain = float((cpu_scores[:, 0] - scores[:, 0]).max())
    gaps = [abs(a - b) / abs(b) for a, b in (nmt_losses, lm_losses)]
    log("text_oracle", card=card, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        batch=TEXT_ORACLE_BATCH, nmt_card_cpu_loss=nmt_losses,
        lm_card_cpu_loss=lm_losses, loss_rel_gaps=gaps,
        loss_tolerance=TEXT_ORACLE_RTOL, rnn_op_shape=RNN_ORACLE_SHAPE,
        rnn_float64_rel_gap=rnn_gaps, rnn_tolerance=RNN_ORACLE_TOL,
        beam_rescore_max_gap=rescore_gap,
        cpu_best_minus_card_best_max=best_gain,
        same_best_ids=int((cpu_ids.numpy()[:, 0] == ids[:, 0]).all(1).sum()),
        beam_tolerance=BEAM_SCORE_TOL, losses_s=losses_s, rnn_s=rnn_s,
        rescore_s=rescore_s, cpu_beam_search_s=cpu_beam_s)
    if not max(gaps) <= TEXT_ORACLE_RTOL:
        raise RuntimeError(f"text step-1 losses, card vs CPU: NMT "
                           f"{nmt_losses}, LM {lm_losses}")
    if not max(rnn_gaps.values()) <= RNN_ORACLE_TOL:
        raise RuntimeError(f"float64 rnn op, card vs CPU: {rnn_gaps}")
    if not rescore_gap <= BEAM_SCORE_TOL:
        raise RuntimeError(f"the card's beam scores against a CPU "
                           f"teacher-forced pass: {rescore_gap}")
    if not best_gain <= BEAM_SCORE_TOL:
        raise RuntimeError(f"the CPU's beam search beat the card's best "
                           f"beam by {best_gain}")


def nn_extras_rows(dev, cases):
    """Each case's op on ``dev`` and on the CPU from the same inputs and
    cotangent: the gaps of its output and every input's gradient, each
    relative to the CPU value's largest magnitude, and ``dev``'s forward
    + backward ms."""
    from paddle_tpu_torch.dygraph.eager import run_op

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, op, shapes, attrs in cases:
        rs = np.random.RandomState(len(label))
        arrays = {k: rs.randn(*s).astype("f4") for k, s in shapes.items()}
        out_slot = "Output" if op == "conv2d_transpose" else "Y"
        results, fb = [], None
        for d in (dev, torch.device("cpu")):
            vals = {k: torch.from_numpy(a).to(d).requires_grad_(True)
                    for k, a in arrays.items()}

            def run(vals=vals):
                y = run_op(op, vals, attrs, out_slots=(out_slot,))[
                    out_slot]._value
                cot = torch.sin(0.37 * torch.arange(
                    y.numel(), dtype=y.dtype, device=y.device)).reshape(
                        y.shape)
                return [y] + list(torch.autograd.grad(
                    y, list(vals.values()), cot))

            results.append([r.detach().cpu() for r in run()])
            if fb is None:
                fb = cuda_ms(run, l2.zero_, reps=10)
        gaps = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(*results)]
        rows.append({"case": label, "op": op, "shapes": shapes,
                     "rel_gaps_out_then_grads": gaps,
                     "card_fwd_bwd_ms": fb})
    return rows


def phase_nn_extras():
    """``conv2d_transpose``, ``group_norm`` and ``instance_norm`` on the
    card against the CPU from the same inputs, forward and gradient
    (``NN_EXTRAS_CASES``), with the card's forward + backward ms."""
    card = nvidia_smi("name,power.limit")
    zero_kernel_launches()
    rows = nn_extras_rows(torch.device("cuda", 0), NN_EXTRAS_CASES)
    launches = kernel_launches()
    log("nn_extras", card=card, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        tolerance=NN_EXTRAS_RTOL, cases=rows, launches_after=launches)
    bad = [r for r in rows if max(r["rel_gaps_out_then_grads"])
           > NN_EXTRAS_RTOL]
    if bad:
        raise RuntimeError(f"nn_extras, card vs CPU: {bad}")
    if any(launches.values()):
        raise RuntimeError(f"nn_extras launched hand-written kernels: "
                           f"{launches}")


# ---- slice 21: the dense op library -------------------------------------------

# op_library: the lowerings ported from the JAX package's linalg, loss,
# interp and misc files, each group one program through the Executor on
# the card (forward and the input gradient, as append_backward's grad
# makers build it) and again on the CPU from the same inputs.  A float gap
# is relative to the CPU value's largest magnitude: 1e-4 leaves ~800
# float32 steps for one op's sums of up to 32,000 terms in another order,
# a chain of 80 log-sum-exps (CTC) or the factorization of a matrix whose
# condition number is at most 5 (TF32 off), and stays far under any wrong
# formula.  Integer outputs (ids, parents, counts) and pure gathers and
# copies (``exact``: nearest resizes, embedding rows, coalesce, the beam
# selection from bit-equal inputs) must be equal.  Row-independent ops
# (CTC's per-row loss, the resizes, beam rows) are checked on the CPU on
# the first ``cpu_rows`` of the batch at full width.
OPLIB_RTOL = 1e-4
OPLIB = dict(   # the shapes, at the widths of the programs that run them
    # PaddleOCR CRNN rec_chinese_lite: 3x32x320 -> 80 steps, 25 labels,
    # 6,623 characters + space + blank, 256 a card
    ctc=dict(T=80, B=256, C=6625, N=25, cpu_rows=8),
    # DeepLabv3+ logits, Cityscapes 1024x512 crop: the final x4
    bilinear=dict(x=(8, 19, 128, 256), out=(512, 1024), cpu_rows=1),
    # YOLOv3's neck at 608
    nearest=(dict(x=(8, 256, 19, 19), out=(38, 38)),
             dict(x=(8, 128, 38, 38), out=(76, 76))),
    bicubic=dict(x=(8, 3, 224, 224), out=(256, 256), cpu_rows=1),
    trilinear=dict(x=(2, 16, 16, 32, 32), out=(32, 64, 64), cpu_rows=1),
    # 8 x 512 tokens over SERVE_MODEL's 32,000-way vocab
    vocab=dict(rows=4096, classes=32000),
    # the text Transformer's 37,000-way vocab, batch 32, beam 4
    beam=dict(batch=32, beam=4, vocab=37000, steps=64, end_id=1,
              cpu_batches=1, cpu_every=4),
    # ERNIE-1.0's table as the fluid 1.x embedding emits it
    lookup=dict(rows=18000, width=768, ids=(32, 128, 1)),
    linalg=dict(batch=64, n=256),
    addmm=dict(m=4096, k=1024, n=4096),
    segment=dict(rows=65536, width=128, segments=16384),
    draws=1_000_000,
)


def oplib_program(ops, feeds, cots=None, no_grad=()):
    """A program of ``ops`` ((type, inputs, outputs, attrs), over the vars
    of ``feeds`` and earlier ops' outputs) and, given output cotangents,
    the gradients of the float feeds not in ``no_grad`` from
    ``calc_gradient``, each output seeded with its cotangent.  Returns
    the program, the fetch list (outputs, then gradients) and the
    cotangent feeds."""
    from paddle_tpu_torch.framework.backward import calc_gradient
    from paddle_tpu_torch.framework.program import Program

    prog = Program()
    blk = prog.global_block
    wrt = []
    for name, t in feeds.items():
        wants = t.is_floating_point() and name not in no_grad
        v = blk.create_var(name=name, shape=tuple(t.shape),
                           dtype=str(t.dtype).replace("torch.", ""),
                           stop_gradient=not wants)
        if wants:
            wrt.append(v)
    fetch = []
    for op_type, ins, outs, attrs in ops:
        for names in outs.values():
            for n in names:
                blk.create_var(name=n)
                fetch.append(n)
        blk.append_op(op_type, ins, outs, attrs)
    grad_feeds, targets, seeds = {}, [], []
    for name, cot in (cots or {}).items():
        targets.append(blk.var(name))
        seeds.append(blk.create_var(name=f"{name}@COT",
                                    shape=tuple(cot.shape), dtype="float32"))
        grad_feeds[seeds[-1].name] = cot
    if targets:
        fetch += [g.name for g in calc_gradient(targets, wrt, seeds)
                  if g is not None]
    return prog, fetch, grad_feeds


def oplib_run(exe, prog, feed, fetch):
    return exe.run(prog, feed=feed, fetch_list=fetch, return_numpy=False)


def oplib_gap(a, b):
    """``a``'s gap to ``b`` relative to ``b``'s largest finite magnitude;
    the non-finite entries must match exactly (inf where they do not)."""
    if a.shape != b.shape:
        return float("inf")
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
            torch.nan_to_num(a[~fin]), torch.nan_to_num(b[~fin])):
        return float("inf")
    if not fin.any():
        return 0.0
    return float((a[fin] - b[fin]).abs().max()
                 / b[fin].abs().max().clamp_min(1e-30))


def oplib_cot(t, dev):
    """A fixed cotangent of ``t``'s shape, every entry of its own."""
    i = torch.arange(t.numel(), dtype=torch.float32, device=dev)
    return torch.cos(0.37 * i + 0.2).reshape(t.shape)


def oplib_synced(fn):
    """``fn()``'s wall seconds, to the end of its work on the card."""
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def oplib_group(dev, flush, label, ops, feeds, grad=(), rows=None,
                axis=lambda name: 0, exact=(), no_grad=()):
    """``ops`` on ``dev`` through the Executor, forward and the gradients
    of ``grad``'s outputs (fixed cotangents) for every float feed not in
    ``no_grad``, against the CPU from the same inputs (each var cut to its
    first ``rows`` along ``axis(name)`` when given); ``dev``'s ms, the
    median of 5 CUDA-event timings after the eager run and the capture
    (the replays bind the feeds), and the seconds of the forward probe,
    the eager run and the capture."""
    t0 = time.monotonic()
    exe = pt.Executor(pt.CUDAPlace(0))
    try:
        prog, fetch, _ = oplib_program(ops, feeds)
        probe = dict(zip(fetch, oplib_run(exe, prog, feeds, fetch)))
        cots = {n: oplib_cot(probe[n], dev) for n in grad}
        del probe
        prog, fetch, grad_feeds = oplib_program(ops, feeds, cots, no_grad)
        feed = {**feeds, **grad_feeds}
        first = [time.monotonic() - t0] + [oplib_synced(
            lambda: oplib_run(exe, prog, feed, fetch)) for _ in range(2)]
        ms = cuda_ms(lambda: oplib_run(exe, prog, feed, fetch), flush,
                     reps=5, warmup=0)
        card = [v.clone() for v in oplib_run(exe, prog, feed, fetch)]
    finally:
        exe.close()
    t1 = time.monotonic()

    def cut(name, t):
        return t if rows is None else t.narrow(axis(name), 0, rows)

    cpu_exe = pt.Executor(pt.CPUPlace())
    try:
        cpu = oplib_run(cpu_exe, prog, {n: cut(n, t).cpu()
                                        for n, t in feed.items()}, fetch)
    finally:
        cpu_exe.close()
    t2 = time.monotonic()
    gaps = {}
    for n, a, b in zip(fetch, card, cpu):   # compared on ``dev``
        a, b = cut(n, a), b.to(dev)
        if a.is_floating_point() and n not in exact:
            gaps[n] = oplib_gap(a, b)
        else:
            gaps[n] = 0.0 if torch.equal(a, b) else float("inf")
    worst = max(gaps, key=gaps.get)
    return {"group": label, "ops": sorted({o[0] for o in ops}),
            "shapes": {n: list(t.shape) for n, t in feeds.items()
                       if len(feeds) <= 8},
            "card_ms": ms, "cpu_rows": rows, "max_rel_gap": gaps[worst],
            "worst": worst, "outputs_compared": len(gaps),
            "seconds_probe_eager_capture": first,
            "seconds_card_cpu_compare": [t1 - t0, t2 - t1,
                                         time.monotonic() - t2]}


def one_op(op_type, ins, outs, attrs=None):
    """(ops, feeds) of one op over ``ins`` {slot: tensor or [tensors]}:
    vars named ``<slot>_<i>``, outputs ``<slot>``."""
    feeds, slots = {}, {}
    for slot, ts in ins.items():
        ts = ts if isinstance(ts, (list, tuple)) else [ts]
        slots[slot] = []
        for i, t in enumerate(ts):
            feeds[f"{slot.lower()}_{i}"] = t
            slots[slot].append(f"{slot.lower()}_{i}")
    outs = {s: ([s.lower()] if isinstance(s, str) else None) for s in outs}
    return [(op_type, slots, outs, dict(attrs or {}))], feeds


def oplib_ctc(dev, gen, flush):
    c = OPLIB["ctc"]
    t, b, k, n = c["T"], c["B"], c["C"], c["N"]
    logits = torch.randn((t, b, k), generator=gen, device=dev)
    label = torch.randint(1, k, (b, n), generator=gen, device=dev,
                          dtype=torch.int32)
    label_len = torch.randint(1, n + 1, (b,), generator=gen, device=dev)
    ops, feeds = one_op("warpctc", dict(
        Logits=logits, Label=label,
        LogitsLength=torch.full((b,), t, dtype=torch.int64, device=dev),
        LabelLength=label_len), ["Loss", "WarpCTCGrad"],
        dict(blank=0, norm_by_times=False))
    row = oplib_group(
        dev, flush, "warpctc", ops, feeds, grad=("loss",),
        rows=c["cpu_rows"],
        axis=lambda name: 1 if name.startswith(("logits_0", "warpctcgrad"))
        else 0)
    # the library's CTC on the same inputs, log-softmax, forward and the
    # logits' gradient: timed beside the port's recursion, used nowhere
    # in the port (it gives inf, not optax's value, on an infeasible row)
    cot = oplib_cot(torch.empty(b), dev)
    lengths = feeds["logitslength_0"]

    def library():
        x = logits.detach().requires_grad_()
        loss = torch.nn.functional.ctc_loss(
            torch.log_softmax(x, dim=2), label, lengths, label_len, blank=0,
            reduction="none")
        return torch.autograd.grad(loss, x, cot)

    row["library"] = "F.ctc_loss(reduction='none'), forward + backward"
    row["library_ms"] = cuda_ms(library, flush, reps=5, warmup=1)
    return row


def oplib_resizes(dev, gen, flush):
    rows = []
    c = OPLIB["bilinear"]
    ops, feeds = one_op("bilinear_interp_v2", dict(
        X=torch.randn(c["x"], generator=gen, device=dev)), ["Out"], dict(
        out_h=c["out"][0], out_w=c["out"][1], align_corners=False,
        align_mode=0))
    rows.append(oplib_group(dev, flush, "bilinear_interp_v2", ops, feeds,
                            grad=("out",), rows=c["cpu_rows"]))
    for c in OPLIB["nearest"]:
        ops, feeds = one_op("nearest_interp_v2", dict(
            X=torch.randn(c["x"], generator=gen, device=dev)), ["Out"], dict(
            out_h=c["out"][0], out_w=c["out"][1], align_corners=False))
        rows.append(oplib_group(
            dev, flush, f"nearest_interp_v2_{c['out'][0]}", ops, feeds,
            grad=("out",), rows=2, exact=("out",)))
    c = OPLIB["bicubic"]
    ops, feeds = one_op("bicubic_interp_v2", dict(
        X=torch.randn(c["x"], generator=gen, device=dev)), ["Out"], dict(
        out_h=c["out"][0], out_w=c["out"][1], align_corners=False))
    rows.append(oplib_group(dev, flush, "bicubic_interp_v2", ops, feeds,
                            grad=("out",), rows=c["cpu_rows"]))
    c = OPLIB["trilinear"]
    ops, feeds = one_op("trilinear_interp_v2", dict(
        X=torch.randn(c["x"], generator=gen, device=dev)), ["Out"], dict(
        out_d=c["out"][0], out_h=c["out"][1], out_w=c["out"][2],
        align_corners=False, align_mode=0))
    rows.append(oplib_group(dev, flush, "trilinear_interp_v2", ops, feeds,
                            grad=("out",), rows=c["cpu_rows"]))
    return rows


def oplib_vocab(dev, gen, flush):
    c = OPLIB["vocab"]
    shape = (c["rows"], c["classes"])
    logits = torch.randn(shape, generator=gen, device=dev)
    logp = torch.log_softmax(logits, dim=1)
    target = torch.softmax(torch.randn(shape, generator=gen, device=dev),
                           dim=1)
    label = torch.randint(0, c["classes"], (c["rows"],), generator=gen,
                          device=dev)
    label[::7] = -100                       # ignored rows
    rows = []
    # logsumexp is row-independent; the two losses' means are over all rows
    # the distillation target is the teacher's output: no gradient
    for op_type, ins, outs, attrs, grad, cpu_rows in (
            ("logsumexp", dict(X=logits), ["Out"], dict(axis=[1]), ("out",),
             c["rows"] // 8),
            ("nll_loss", dict(X=logp, Label=label), ["Out", "Total_weight"],
             dict(ignore_index=-100, reduction="mean"), ("out",), None),
            ("kldiv_loss", dict(X=logp, Target=target), ["Loss"],
             dict(reduction="batchmean"), ("loss",), None)):
        ops, feeds = one_op(op_type, ins, outs, attrs)
        rows.append(oplib_group(dev, flush, op_type, ops, feeds, grad=grad,
                                rows=cpu_rows, no_grad=("target_0",)))
    return rows


def oplib_beam(dev, gen, flush):
    """``beam_search`` step by step (64 steps, accumulated scores, finished
    lanes frozen), every ``cpu_every``-th step's selection and gradient
    on the CPU from the card's inputs of that step for the first
    ``cpu_batches`` batches (equal ids, parents, scores and gradients),
    then ``beam_search_decode`` over the steps."""
    c = OPLIB["beam"]
    k, v, end = c["beam"], c["vocab"], c["end_id"]
    bk, cpu_rows = c["batch"] * k, c["cpu_batches"] * k
    pre_ids = torch.zeros((bk, 1), dtype=torch.int64, device=dev)
    # only lane 0 of each group live at first: k distinct expansions
    pre_scores = torch.full((bk, 1), -1e9, device=dev)
    pre_scores[::k] = 0.0
    scores = torch.zeros((bk, v), device=dev)
    ops, feeds = one_op("beam_search", dict(
        pre_ids=pre_ids, pre_scores=pre_scores, scores=scores),
        ["selected_ids", "selected_scores", "parent_idx"],
        dict(beam_size=k, end_id=end, is_accumulated=True))
    cot = oplib_cot(torch.empty(bk, 1), dev)
    prog, fetch, grad_feeds = oplib_program(ops, feeds,
                                            {"selected_scores": cot})
    exe, cpu_exe = pt.Executor(pt.CUDAPlace(0)), pt.Executor(pt.CPUPlace())
    ids, parents, step_scores, bad, finished = [], [], [], [], 0
    seconds = [0.0, 0.0]                     # card, CPU
    try:
        for step in range(c["steps"]):
            t0 = time.monotonic()
            logp = torch.log_softmax(torch.randn(
                (bk, v), generator=gen, device=dev), dim=1)
            logp[:, end] += 2.0             # some lanes finish early
            feed = {"pre_ids_0": pre_ids, "pre_scores_0": pre_scores,
                    "scores_0": pre_scores + logp, **grad_feeds}
            card = [t.clone() for t in oplib_run(exe, prog, feed, fetch)]
            t1 = time.monotonic()
            seconds[0] += t1 - t0
            if step % c["cpu_every"] == 0:
                cpu = oplib_run(cpu_exe, prog, {
                    n: t[:cpu_rows].cpu() for n, t in feed.items()}, fetch)
                bad += [(step, n) for n, a, b in zip(fetch, card, cpu)
                        if not torch.equal(a[:cpu_rows].cpu(), b)]
                seconds[1] += time.monotonic() - t1
            got = dict(zip(fetch, card))
            pre_ids = got["selected_ids"].long()
            pre_scores = got["selected_scores"]
            finished += int((pre_ids == end).sum())
            ids.append(pre_ids.reshape(bk))
            parents.append(got["parent_idx"].long())
            step_scores.append(pre_scores.reshape(bk))
        ms = cuda_ms(lambda: oplib_run(exe, prog, feed, fetch), flush,
                     reps=5, warmup=1)
    finally:
        exe.close()
        cpu_exe.close()
    rows = [{"group": "beam_search", "ops": ["beam_search"],
             "steps": c["steps"], "rows": bk, "vocab": v, "card_ms": ms,
             "cpu_rows": cpu_rows, "finished_lane_steps": finished,
             "max_rel_gap": float("inf") if bad else 0.0,
             "unequal": bad[:8], "seconds_card_cpu": seconds}]
    ops, feeds = one_op("beam_search_decode", dict(
        Ids=torch.stack(ids), ParentIdx=torch.stack(parents),
        Scores=torch.stack(step_scores)), ["SentenceIds", "SentenceScores"],
        dict(beam_size=k))
    rows.append(oplib_group(dev, flush, "beam_search_decode", ops, feeds,
                            grad=("sentencescores",),
                            exact=("sentencescores",)))
    return rows


def oplib_params(dev, gen, flush):
    """``coalesce_tensor`` over BERT-base's parameter list, then one
    ``squared_l2_norm`` for each (the global-norm clip's sums)."""
    from paddle_tpu_torch.text import bert_base_pretrain_program

    with unique_name.guard():
        main, _startup, _feeds, _loss, _opt = bert_base_pretrain_program(
            batch_size=2, seq_len=16)
    params = main.all_parameters()
    feeds = {f"p{i}": torch.randn(tuple(p.shape), generator=gen, device=dev)
             * 0.02 for i, p in enumerate(params)}
    names = list(feeds)
    ops = [("coalesce_tensor", {"Input": names},
            {"Output": [f"{n}_out" for n in names], "FusedOutput": ["fused"]},
            {"dtype": 5})]
    ops += [("squared_l2_norm", {"X": [n]}, {"Out": [f"{n}_sq"]}, {})
            for n in names]
    row = oplib_group(dev, flush, "coalesce_tensor+squared_l2_norm", ops,
                      feeds, grad=tuple(f"{n}_sq" for n in names),
                      exact=tuple(f"{n}_out" for n in names) + ("fused",))
    row["params"] = len(names)
    row["elements"] = sum(t.numel() for t in feeds.values())
    return [row]


def oplib_dense(dev, gen, flush):
    rows = []
    c = OPLIB["lookup"]
    ids = torch.randint(0, c["rows"], c["ids"], generator=gen, device=dev)
    ids[:, ::9] = 0                          # padding_idx rows
    ops, feeds = one_op("lookup_table", dict(
        W=torch.randn((c["rows"], c["width"]), generator=gen, device=dev),
        Ids=ids), ["Out"], dict(padding_idx=0, is_sparse=False))
    rows.append(oplib_group(dev, flush, "lookup_table", ops, feeds,
                            grad=("out",), exact=("out",)))
    c = OPLIB["linalg"]
    a = torch.randn((c["batch"], c["n"], c["n"]), generator=gen, device=dev)
    spd = a @ a.transpose(1, 2) / c["n"] + torch.eye(c["n"], device=dev)
    for op_type, slot, out in (("cholesky", "X", "Out"),
                               ("inverse", "Input", "Output")):
        ops, feeds = one_op(op_type, {slot: spd}, [out])
        rows.append(oplib_group(dev, flush, op_type, ops, feeds,
                                grad=(out.lower(),)))
    # a singular matrix: its inverse is not finite on the card either
    ops, feeds = one_op("inverse", dict(Input=torch.tensor(
        [[1.0, 2.0], [2.0, 4.0]], device=dev)), ["Output"])
    prog, fetch, _ = oplib_program(ops, feeds)
    exe = pt.Executor(pt.CUDAPlace(0))
    try:
        finite = int(torch.isfinite(oplib_run(exe, prog, feeds, fetch)[0])
                     .sum())
    finally:
        exe.close()
    rows.append({"group": "inverse_singular", "finite_entries": finite,
                 "max_rel_gap": 0.0 if finite < 4 else float("inf")})
    c = OPLIB["addmm"]
    ops, feeds = one_op("addmm", dict(
        Input=torch.randn((c["m"], c["n"]), generator=gen, device=dev),
        X=torch.randn((c["m"], c["k"]), generator=gen, device=dev),
        Y=torch.randn((c["k"], c["n"]), generator=gen, device=dev)),
        ["Out"], dict(Alpha=0.5, Beta=2.0))
    rows.append(oplib_group(dev, flush, "addmm", ops, feeds, grad=("out",)))
    c = OPLIB["segment"]
    x = torch.randn((c["rows"], c["width"]), generator=gen, device=dev)
    seg = torch.sort(torch.randint(0, c["segments"], (c["rows"],),
                                   generator=gen, device=dev)).values
    for pool in ("SUM", "MEAN", "MAX"):
        ops, feeds = one_op("segment_pool", dict(X=x, SegmentIds=seg),
                            ["Out", "SummedIds"], dict(pooltype=pool))
        rows.append(oplib_group(dev, flush, f"segment_pool_{pool.lower()}",
                                ops, feeds, grad=("out",)))
    return rows


def oplib_small(dev, gen, flush):
    """The other lowerings of the slice at small shapes."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def p(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.9 + 0.05

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    binary = (p(16, 1) > 0.5).float()
    a = r(64, 64)
    spd = a @ a.T / 64 + torch.eye(64, device=dev)
    cases = (
        ("cholesky", dict(X=spd), ["Out"], dict(upper=True)),
        # a matrix that is not positive definite: its factor and gradient
        # NaN on the card as on the CPU (the positive-definite one finite)
        ("cholesky", dict(X=torch.stack([spd, spd - 2 * torch.eye(
            64, device=dev)])), ["Out"], {}),
        ("mv", dict(X=r(64, 32), Vec=r(32)), ["Out"], {}),
        ("kron", dict(X=r(8, 6), Y=r(5, 7)), ["Out"], {}),
        ("cross", dict(X=r(16, 3, 8), Y=r(16, 3, 8)), ["Out"],
         dict(dim=-2147483648)),
        ("dist", dict(X=r(32, 16), Y=r(32, 16)), ["Out"], dict(p=3.0)),
        ("dist", dict(X=r(32, 16), Y=r(32, 16)), ["Out"],
         dict(p=float("inf"))),
        ("trace", dict(Input=r(4, 32, 40)), ["Out"],
         dict(offset=2, axis1=1, axis2=2)),
        ("norm", dict(X=r(16, 64, 8)), ["Out", "Norm"], dict(axis=1)),
        ("multiplex", dict(X=[r(32, 16) for _ in range(4)],
                           Ids=ints(4, 32, 1)), ["Out"], {}),
        ("unbind", dict(X=r(4, 3, 16)), [None], dict(axis=1)),
        ("minus", dict(X=r(16, 16), Y=r(16, 16)), ["Out"], {}),
        ("partial_sum", dict(X=[r(16, 32) for _ in range(3)]), ["Out"],
         dict(start_index=4, length=16)),
        ("partial_concat", dict(X=[r(16, 32) for _ in range(3)]), ["Out"],
         dict(start_index=4, length=8)),
        ("segment_pool", dict(X=r(64, 16), SegmentIds=torch.sort(
            ints(40, 64)).values), ["Out", "SummedIds"],
         dict(pooltype="MIN")),
        ("maximum", dict(X=r(32, 16), Y=r(16)), ["Out"], {}),
        ("minimum", dict(X=r(32, 16), Y=r(16)), ["Out"], {}),
        ("bce_loss", dict(X=p(16, 8), Label=(p(16, 8) > 0.5).float()),
         ["Out"], {}),
        ("log_loss", dict(Predicted=p(16, 1), Labels=binary), ["Loss"],
         dict(epsilon=1e-4)),
        ("hinge_loss", dict(Logits=r(16, 1), Labels=binary), ["Loss"], {}),
        ("rank_loss", dict(Label=binary, Left=r(16, 1), Right=r(16, 1)),
         ["Out"], {}),
        ("margin_rank_loss", dict(Label=binary * 2 - 1, X1=r(16, 1),
                                  X2=r(16, 1)), ["Out", "Activated"],
         dict(margin=0.1)),
        ("smooth_l1_loss", dict(X=r(16, 4, 8), Y=r(16, 4, 8),
                                InsideWeight=p(16, 4, 8),
                                OutsideWeight=p(16, 4, 8)),
         ["Diff", "Out"], dict(sigma=2.0)),
        ("sigmoid_focal_loss", dict(X=r(32, 10), Label=ints(11, 32, 1),
                                    FgNum=torch.tensor([20], device=dev)),
         ["Out"], dict(gamma=2.0, alpha=0.25)),
        ("bpr_loss", dict(X=r(32, 10), Label=ints(10, 32, 1)), ["Y"], {}),
        ("l1_norm", dict(X=r(16, 16)), ["Out"], {}),
        ("linear_interp_v2", dict(X=r(4, 8, 50)), ["Out"],
         dict(out_w=120, align_corners=False, align_mode=1)),
        ("bilinear_interp", dict(X=r(2, 4, 10, 12)), ["Out"],
         dict(out_h=7, out_w=30, align_corners=True)),
        ("squared_l2_norm", dict(X=r(64, 64)), ["Out"], {}),
        ("reshape2_grad", {"Out@GRAD": r(6, 40),
                           "XShape": torch.zeros((0, 2, 3, 40), device=dev)},
         ["X@GRAD"], {}),
    )
    rows = []
    for i, (op_type, ins, outs, attrs) in enumerate(cases):
        if outs == [None]:                  # unbind: one var per slice
            ops, feeds = one_op(op_type, ins, [], attrs)
            ops[0][2]["Out"] = [f"out{j}" for j in range(3)]
            grad = ("out0", "out1", "out2")
        else:
            ops, feeds = one_op(op_type, ins, outs, attrs)
            grad = () if op_type == "reshape2_grad" else \
                tuple(o.lower() for o in outs
                      if o not in ("SummedIds", "Activated"))
        rows.append(oplib_group(dev, flush, f"{i}_{op_type}", ops, feeds,
                                grad=grad))
    return rows


def oplib_distribution(dev, flush):
    """1e6 draws from each distribution on ``dev``, held to their
    statistics (5 standard errors; each category's share within 5
    binomial standard deviations), with the draw's ms."""
    from paddle_tpu_torch import distribution as D

    n = OPLIB["draws"]
    loc = torch.tensor([0.3, -1.2, 2.0], device=dev)
    scale = torch.tensor([0.5, 1.5, 2.5], device=dev)
    logits = torch.tensor([0.2, -1.0, 1.5, 0.0], device=dev)
    dists = {"normal": D.Normal(loc, scale),
             "uniform": D.Uniform(torch.tensor(-1.0, device=dev),
                                  torch.tensor(3.0, device=dev)),
             "categorical": D.Categorical(logits)}
    rows, bad = [], []
    for name, d in dists.items():
        x = d.sample([n], seed=21)._value
        if x.device != dev:
            bad.append((name, "device", str(x.device)))
        if name == "normal":
            mean, var = x.mean(0), x.var(0)
            se = 5 * scale / math.sqrt(n)
            if ((mean - loc).abs() > se).any() or \
                    ((var - scale ** 2).abs()
                     > 5 * scale ** 2 * math.sqrt(2 / n)).any():
                bad.append((name, mean.tolist(), var.tolist()))
        elif name == "uniform":
            if x.min() < -1.0 or x.max() >= 3.0 or \
                    abs(float(x.mean()) - 1.0) > 5 * (4 / math.sqrt(12)) \
                    / math.sqrt(n):
                bad.append((name, float(x.min()), float(x.max())))
        else:
            prob = torch.softmax(logits, 0)
            share = torch.bincount(x, minlength=4).float() / n
            if ((share - prob).abs()
                    > 5 * torch.sqrt(prob * (1 - prob) / n)).any():
                bad.append((name, share.tolist()))
        rows.append({"group": f"distribution_{name}", "draws": n,
                     "card_ms": cuda_ms(lambda d=d: d.sample([n], seed=21),
                                        flush, reps=5, warmup=1),
                     "max_rel_gap": 0.0})
    if bad:
        raise RuntimeError(f"op_library: distribution statistics {bad}")
    return rows


def phase_op_library():
    """The dense op library of slice 21 on the card at its users' widths
    (``OPLIB``), each group against the port's CPU path on the same
    inputs, forward and input gradient (``OPLIB_RTOL``); the draws of
    ``distribution`` by their statistics; ``utils.run_check()``; no
    hand-written kernel launched."""
    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    zero_kernel_launches()
    rows, seconds = [], {}
    for name, fn in (("ctc", oplib_ctc), ("resizes", oplib_resizes),
                     ("vocab", oplib_vocab), ("beam", oplib_beam),
                     ("params", oplib_params), ("dense", oplib_dense),
                     ("small", oplib_small),
                     ("distribution", lambda d, g, f: oplib_distribution(
                         d, f))):
        t1 = time.monotonic()
        got = fn(dev, gen, flush)
        rows += got if isinstance(got, list) else [got]
        seconds[name] = time.monotonic() - t1
    t1 = time.monotonic()
    pt.utils.run_check()
    seconds["run_check"] = time.monotonic() - t1
    launches = kernel_launches()
    bad = [r for r in rows if r["max_rel_gap"] > OPLIB_RTOL]
    log("op_library", card=card, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32, tolerance=OPLIB_RTOL,
        groups=rows, launches_after=launches, run_check=True,
        group_seconds=seconds, seconds=time.monotonic() - t0)
    if bad:
        raise RuntimeError(f"op_library, card vs CPU: {bad}")
    if any(launches.values()):
        raise RuntimeError(f"op_library launched hand-written kernels: "
                           f"{launches}")


# ---- slice 22: vision and detection ops -------------------------------------

# vision_ops: the lowerings ported from the JAX package's vision,
# detection, NMS, deformable and correlation files (ROADMAP item 5b), each
# group one program through the Executor on the card, captured (its
# executor_eager_* counters unchanged; crop_tensor with Offsets the one
# eager case), forward and, for the differentiable groups, the input
# gradient; then the same program on the card and on the CPU from the
# same cut inputs (``cut``: one image, one clip or the first RoIs, at full
# width).  Float gaps as OPLIB_RTOL (relative to the CPU value's largest
# magnitude; float32, TF32 off).  Integer outputs must be equal, but for
# the two kinds of decisions a last-bit difference between the card's and
# the CPU's float32 (exp, sigmoid, cuDNN's sums) may flip:
# - NMS and proposals (``vision_nms_check``): a kept row may differ only
#   where a deciding score or IoU lies within VISION_MARGIN of its
#   threshold, of a rank neighbour or of the top-k cut, or where it
#   follows from such a flip (suppressed by a flipped box, shifted past
#   the cut); the count of such rows is logged;
# - a pool's Mask (``mask_of``): a position may differ only where the
#   two candidates' input values are within VISION_MARGIN.
VISION_MARGIN = 1e-6
VISION = dict(   # the shapes, at the widths of the models that run them
    # PaddleDetection yolov3_darknet53_270e_coco, eval at 608: three heads
    # of 3 x (5 + 80) channels, the COCO anchors -> 22,743 boxes
    yolo=dict(batch=4, classes=80, img=608, grids=(19, 38, 76),
              downsample=(32, 16, 8),
              anchors=(10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                       116, 90, 156, 198, 373, 326),
              masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)), conf=0.005,
              nms=dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
                       nms_threshold=0.45, background_label=-1,
                       normalized=False)),
    # ppyolo_r50vd_dcn_1x_coco's head: scale_x_y 1.05, matrix NMS
    ppyolo=dict(scale_x_y=1.05, nms=dict(
        score_threshold=0.01, post_threshold=0.01, nms_top_k=1000,
        keep_top_k=100, background_label=-1, normalized=False)),
    # ssd_vgg16_300_240e_voc: 8,732 priors, 21 classes, batch 8, 40
    # ground-truth boxes an image
    ssd=dict(batch=8, classes=21, img=300, maps=(38, 19, 10, 5, 3, 1),
             min_sizes=(30, 60, 111, 162, 213, 264),
             max_sizes=(60, 111, 162, 213, 264, 315),
             ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)), gt=40,
             nms=dict(score_threshold=0.01, nms_top_k=400, keep_top_k=200,
                      nms_threshold=0.45, background_label=0,
                      normalized=True)),
    # faster_rcnn_r50_1x_coco (C4) at 800 x 1333, test: the RPN head
    rpn=dict(batch=2, h=50, w=84, img=(800, 1333),
             sizes=(32, 64, 128, 256, 512), ratios=(0.5, 1.0, 2.0),
             attrs=dict(pre_nms_topN=6000, post_nms_topN=1000,
                        nms_thresh=0.7, min_size=0.0, eta=1.0,
                        pixel_offset=True)),
    # the same model's RoI head, 512 sampled RoIs an image in training
    roi=dict(x=(2, 1024, 50, 84), per_image=512, align=14, pool=7,
             cpu_rois=8),
    # R-FCN's head on COCO (81 x 7 x 7 maps); PrRoI pooling (IoU-Net)
    psroi=dict(x=(1, 3969, 50, 84), rois=300, out_c=81, bins=7, cpu_rois=8),
    prroi=dict(x=(2, 256, 50, 84), per_image=512, bins=7, cpu_rois=8),
    # PP-YOLO's ResNet50-vd DCN res5 at 608
    deform=dict(x=(8, 512, 19, 19), filter=(512, 512, 3, 3)),
    # a flow warp; FlowNetC's correlation at 384 x 512
    grid=dict(x=(8, 64, 128, 256)),
    corr=dict(x=(4, 256, 48, 64), attrs=dict(
        pad_size=20, kernel_size=1, max_displacement=20, stride1=1,
        stride2=2)),
    # C3D's conv3a on 16 x 112 x 112 clips; TSM ResNet-50 (8 segments)
    c3d=dict(x=(8, 128, 8, 28, 28), filter=(256, 128, 3, 3, 3)),
    tsm=dict(x=(64, 256, 56, 56), seg_num=8, ratio=0.125),
    # SegNet on CamVid; AlexNet's conv1; a x2 super-resolution head; the
    # text Transformer's 37,000-way labels
    segnet=(8, 64, 360, 480), alexnet=(128, 96, 55, 55),
    sr=(16, 256, 64, 64), labels=(4096, 37000),
)


def vision_cut(rows):
    """A ``cut`` keeping the first ``rows(name)`` of each feed and output
    (a cotangent feed as its output); ``rows`` None keeps the whole
    tensor."""
    def cut(name, t):
        k = rows(name.split("@")[0])
        return t if k is None else t[:k]
    return cut


def vision_gap(a, b):
    if not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    return oplib_gap(a, b)


def vision_diff(a, b):
    """Where ``a`` and ``b`` differ most, for the log."""
    if a.shape != b.shape:
        return {"shapes": [list(a.shape), list(b.shape)]}
    d = (a.double() - b.double()).abs()
    i = int(d.reshape(-1).argmax())
    at = [int(v) for v in np.unravel_index(i, tuple(a.shape))]
    return {"differ": int((a != b).sum()), "of": a.numel(), "at": at,
            "card": float(a.reshape(-1)[i]), "cpu": float(b.reshape(-1)[i])}


def vision_group(dev, flush, label, ops, feeds, grad=(), no_grad=(),
                 cut=None, checks=None, cpu_context=None, nan_ok=()):
    """``ops`` on ``dev`` through the Executor at full width, forward and
    the gradients of ``grad``'s outputs for every float feed not in
    ``no_grad``: the captured step's ms (median of 5 CUDA-event timings
    after the eager run and the capture), whether it ran captured, its
    outputs finite; then the same program on ``dev`` and on the CPU from
    the ``cut`` inputs, every fetch compared (``checks``: {fetch: fn(card,
    cpu, card_fetches, cpu_fetches) -> (gap, margin_flips)} for the
    decisions), and the full run's outputs against the cut run's.
    ``cpu_context``, when given, is entered around the CPU run (the
    sampled losses' CPU reference reads the card's draw through it);
    the outputs in ``nan_ok`` hold NaN by design and are left out of the
    finite check (their NaNs must still sit where the CPU's do)."""
    t0 = time.monotonic()
    eager0 = eager_counts()
    exe = pt.Executor(pt.CUDAPlace(0))
    try:
        prog, fetch, _ = oplib_program(ops, feeds)
        outs = list(fetch)
        probe = dict(zip(fetch, oplib_run(exe, prog, feeds, fetch)))
        cots = {n: oplib_cot(probe[n], dev) for n in grad}
        del probe
        prog, fetch, grad_feeds = oplib_program(ops, feeds, cots, no_grad)
        feed = {**feeds, **grad_feeds}
        first = [time.monotonic() - t0] + [oplib_synced(
            lambda: oplib_run(exe, prog, feed, fetch)) for _ in range(2)]
        ms = cuda_ms(lambda: oplib_run(exe, prog, feed, fetch), flush,
                     reps=5, warmup=0)
        full = dict(zip(fetch, [v.clone() for v in
                                oplib_run(exe, prog, feed, fetch)]))
        full_outs = [full[n] for n in outs if n not in nan_ok]
        captured = eager_counts() == eager0
        cut = cut or (lambda name, t: t)
        small = {n: cut(n, t) for n, t in feed.items()}
        card = dict(zip(fetch, [v.clone() for v in
                                oplib_run(exe, prog, small, fetch)]))
    finally:
        exe.close()
    t1 = time.monotonic()
    cpu_exe = pt.Executor(pt.CPUPlace())
    try:
        with cpu_context() if cpu_context else contextlib.nullcontext():
            cpu = dict(zip(fetch, oplib_run(
                cpu_exe, prog, {n: t.cpu() for n, t in small.items()},
                fetch)))
    finally:
        cpu_exe.close()
    t2 = time.monotonic()
    gaps, flips = {}, {}
    card, cpu = {**small, **card}, {**small, **cpu}
    for n in fetch:
        a, b = card[n], cpu[n].to(dev)
        if checks and n in checks:
            gaps[n], flips[n] = checks[n](a, b, card, cpu)
        else:
            gaps[n] = vision_gap(a, b) if a.shape == b.shape \
                else float("inf")
    # the full-width outputs: finite where the cut run is, and their cut
    # rows the cut run's (decisions by the same checks)
    full = {**small, **{n: cut(n, full[n]) for n in outs}}
    for n in outs:
        a, b = full[n], card[n]
        if not a.numel():           # an XShape
            continue
        if checks and n in checks:
            g = checks[n](a, b, full, card)[0]
        else:
            g = vision_gap(a, b) if a.shape == b.shape else float("inf")
        gaps[f"{n}/full"] = g
    finite = all(torch.isfinite(t).all() for t in full_outs
                 if t.is_floating_point())
    worst = max(gaps, key=gaps.get)
    bad = {n: vision_diff(card[n], cpu[n].to(dev)) for n in fetch
           if gaps[n] > OPLIB_RTOL}
    return {"group": label, "ops": sorted({o[0] for o in ops}),
            "shapes": {n: list(t.shape) for n, t in feeds.items()},
            "card_ms": ms, "captured": captured, "finite": bool(finite),
            "over_tolerance": bad,
            "max_rel_gap": gaps[worst], "worst": worst,
            "outputs_compared": len(gaps), "margin_flips": flips,
            "seconds_probe_eager_capture": first,
            "seconds_card_cpu_compare": [t1 - t0, t2 - t1,
                                         time.monotonic() - t2]}


def nms_rows(rows, probs, index, num, b):
    """Image ``b``'s kept rows as [(label, index or None, score, box)]."""
    out = []
    for i in range(int(num[b])):
        if probs is None:                  # (label, score, x1, y1, x2, y2)
            out.append((int(rows[b, i, 0]),
                        None if index is None else int(index[b, i]),
                        float(rows[b, i, 1]), rows[b, i, 2:6].tolist()))
        else:                              # proposals: box + probability
            out.append((0, None, float(probs[b, i, 0]), rows[b, i].tolist()))
    return out


def nms_match(ra, rb, tol):
    """Pairs (i, j) of rows that are the same detection: the same label
    and index where the op gives one, else the same label and a box
    within ``tol``; and the rows of each side left unmatched."""
    pairs, free = [], set(range(len(rb)))
    for i, (lab, idx, _s, box) in enumerate(ra):
        for j in sorted(free):
            lb, jb, _sb, bb = rb[j]
            if lb == lab and (idx == jb if idx is not None else max(
                    abs(x - y) for x, y in zip(box, bb)) <= tol):
                pairs.append((i, j))
                free.discard(j)
                break
    left_a = sorted(set(range(len(ra))) - {i for i, _ in pairs})
    return pairs, left_a, sorted(free)


def box_iou(a, b, normalized):
    off = 0.0 if normalized else 1.0
    iw = max(min(a[2], b[2]) - max(a[0], b[0]) + off, 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]) + off, 0.0)
    inter = iw * ih
    union = (max(a[2] - a[0] + off, 0.0) * max(a[3] - a[1] + off, 0.0)
             + max(b[2] - b[0] + off, 0.0) * max(b[3] - b[1] + off, 0.0)
             - inter)
    return inter / union if union > 0 else 0.0


def vision_nms_check(kind, attrs, num, index=None, probs=None,
                     scores=None):
    """A ``checks`` entry for an NMS or proposal output (``kind``
    "greedy", "matrix" or "proposals"; with the
    count ``num``, the ``index`` and ``probs`` fetches where the op gives
    them, and ``scores`` its score input [B, C, M], for the top-k cut):
    (gap, flips).  The kept rows of each image are matched by key; a
    matched row's score and box within OPLIB_RTOL; a row kept on one side
    only must be a margin flip (see above), else the gap is inf."""
    thr = None if kind == "matrix" else attrs.get(
        "nms_threshold", attrs.get("nms_thresh"))
    top_k = attrs.get("nms_top_k", attrs.get("pre_nms_topN", -1))
    floor = attrs.get("post_threshold", attrs.get(
        "score_threshold", float("-inf")))
    normalized = attrs.get("normalized", not attrs.get("pixel_offset", True))
    off = 0.0 if normalized else 1.0
    min_size = max(attrs["min_size"], 1.0) if "min_size" in attrs else None

    def check(a, b, fa, fb):
        got = [None if n is None else fa[n].cpu()
               for n in (None, num, index, probs)]
        want = [None if n is None else fb[n].cpu()
                for n in (None, num, index, probs)]
        got[0], want[0] = a.cpu(), b.cpu()
        sc = fb[scores].cpu() if scores else None
        gap, flips = 0.0, 0
        scale = max(float(b.abs().max()), 1e-30)
        for img in range(a.shape[0]):
            ra = nms_rows(got[0], got[3], got[2], got[1], img)
            rb = nms_rows(want[0], want[3], want[2], want[1], img)
            pairs, left_a, left_b = nms_match(ra, rb, 1e-3 * scale)
            for i, j in pairs:
                gap = max(gap, max(abs(x - y) for x, y in zip(
                    [ra[i][2]] + ra[i][3], [rb[j][2]] + rb[j][3])) / scale)
            # rows kept on one side only, the higher scores first, each
            # with its position on its side and the other side's count
            diff = sorted([(ra[i], i, len(rb)) for i in left_a]
                          + [(rb[j], j, len(ra)) for j in left_b],
                          key=lambda d: -d[0][2])
            every = ra + rb
            cuts = []
            if sc is not None and 0 < top_k < sc[img].numel():
                flat = sc[img].reshape(1, -1) if kind == "proposals" \
                    else sc[img].reshape(-1, sc.shape[-1])
                top = torch.sort(flat, dim=-1, descending=True).values
                cuts = top[:, top_k - 1:top_k + 1]
            explained = []
            for (lab, _idx, s, box), pos, n_other in diff:
                near = [abs(s - floor)] + [abs(s - o[2]) for o in every
                                           if o[3] != box]
                if len(cuts):
                    near += [abs(s - float(c)) for c in cuts[max(lab, 0)]]
                if thr is not None:
                    near += [abs(box_iou(box, o[3], normalized) - thr)
                             for o in every if o[0] == lab and o[3] != box]
                if min_size is not None:   # the proposals' size filter
                    near += [abs(box[2] - box[0] + off - min_size),
                             abs(box[3] - box[1] + off - min_size)]
                # suppressed by a flipped box, or pushed past the cut by
                # one (a flip above it)
                follows = explained and pos >= n_other - len(
                    explained) or any(
                    e[2] > s and e[0] == lab and thr is not None
                    and box_iou(box, e[3], normalized) >= thr - VISION_MARGIN
                    for e in explained)
                if min(near) <= VISION_MARGIN or follows:
                    explained.append((lab, _idx, s, box))
                else:
                    gap = float("inf")
            flips += len(explained)
        return gap, flips
    return check


def mask_check(x_name):
    """A ``checks`` entry for a pool's int32 Mask over the feed
    ``x_name``: positions may differ only where the input values at the
    two indices are within VISION_MARGIN of the window's value (a tie
    the card's and the CPU's sums break apart)."""
    def check(a, b, fa, fb):
        if a.shape != b.shape:
            return float("inf"), 0
        bad = a != b
        n = int(bad.sum())
        if not n:
            return 0.0, 0
        x = fb[x_name].to(a.device).flatten(2)
        a, b, bad = a.flatten(2), b.flatten(2), bad.flatten(2)
        va = torch.gather(x, 2, a.long())[bad]
        vb = torch.gather(x, 2, b.long())[bad]
        scale = float(x.abs().max())
        ok = (va - vb).abs().max() <= VISION_MARGIN * max(scale, 1.0)
        return (0.0 if ok else float("inf")), n
    return check


def yolo_ops(c, scale_x_y, tail):
    """YOLOv3's post-process: a ``yolo_box`` a head, the boxes and scores
    concatenated, the scores transposed to [B, C, M], then ``tail``."""
    ops, boxes, scores = [], [], []
    for i, down in enumerate(c["downsample"]):
        anchors = [c["anchors"][2 * m + j] for m in c["masks"][i]
                   for j in (0, 1)]
        ops.append(("yolo_box", {"X": [f"head{i}"], "ImgSize": ["img_size"]},
                    {"Boxes": [f"boxes{i}"], "Scores": [f"scores{i}"]},
                    dict(anchors=anchors, class_num=c["classes"],
                         conf_thresh=c["conf"], downsample_ratio=down,
                         clip_bbox=True, scale_x_y=scale_x_y)))
        boxes.append(f"boxes{i}")
        scores.append(f"scores{i}")
    ops += [("concat", {"X": boxes}, {"Out": ["all_boxes"]}, {"axis": 1}),
            ("concat", {"X": scores}, {"Out": ["all_scores"]}, {"axis": 1}),
            ("transpose2", {"X": ["all_scores"]},
             {"Out": ["scores_t"], "XShape": ["scores_xshape"]},
             {"axis": [0, 2, 1]})]
    return ops + tail


def vision_yolo(dev, gen, flush):
    c = VISION["yolo"]
    feeds = {f"head{i}": torch.randn(
        (c["batch"], 3 * (5 + c["classes"]), g, g), generator=gen,
        device=dev) for i, g in enumerate(c["grids"])}
    feeds["img_size"] = torch.full((c["batch"], 2), c["img"],
                                   dtype=torch.int32, device=dev)
    one = vision_cut(lambda n: 1)
    nms = c["nms"]
    rows = [vision_group(
        dev, flush, "yolov3: yolo_box x3 + multiclass_nms3",
        yolo_ops(c, 1.0, [("multiclass_nms3", {
            "BBoxes": ["all_boxes"], "Scores": ["scores_t"]},
            {"Out": ["dets"], "Index": ["index"], "NmsRoisNum": ["num"]},
            nms)]), feeds, cut=one,
        checks={"dets": vision_nms_check("greedy", nms, "num", "index",
                                         scores="scores_t"),
                "index": lambda a, b, fa, fb: (0.0, 0),
                "num": lambda a, b, fa, fb: (0.0, 0)})]
    p = VISION["ppyolo"]
    tail, checks = [], {}
    for kind, gaussian in (("linear", False), ("gaussian", True)):
        attrs = dict(p["nms"], use_gaussian=gaussian, gaussian_sigma=2.0)
        tail.append(("matrix_nms", {"BBoxes": ["all_boxes"],
                                    "Scores": ["scores_t"]},
                     {"Out": [f"dets_{kind}"], "Index": [f"index_{kind}"],
                      "RoisNum": [f"num_{kind}"]}, attrs))
        checks[f"dets_{kind}"] = vision_nms_check(
            "matrix", attrs, f"num_{kind}", f"index_{kind}",
            scores="scores_t")
        checks[f"index_{kind}"] = checks[f"num_{kind}"] = \
            lambda a, b, fa, fb: (0.0, 0)
    rows.append(vision_group(dev, flush, "ppyolo: yolo_box x3 + matrix_nms",
                             yolo_ops(c, p["scale_x_y"], tail), feeds,
                             cut=one, checks=checks))
    return rows


def vision_ssd(dev, gen, flush):
    """SSD300's priors, its decode + ``multiclass_nms``, and its matching
    (``iou_similarity`` + ``bipartite_match`` + ``box_coder`` encode).
    ``prior_box`` reads its inputs' shapes only: 1-channel maps."""
    c = VISION["ssd"]
    b, img = c["batch"], c["img"]
    feeds = {f"map{i}": torch.zeros((1, 1, m, m), device=dev)
             for i, m in enumerate(c["maps"])}
    feeds["image"] = torch.zeros((1, 3, img, img), device=dev)
    ops, pri, var = [], [], []
    for i, m in enumerate(c["maps"]):
        ops.append(("prior_box", {"Input": [f"map{i}"], "Image": ["image"]},
                    {"Boxes": [f"pb{i}"], "Variances": [f"pv{i}"]},
                    dict(min_sizes=[float(c["min_sizes"][i])],
                         max_sizes=[float(c["max_sizes"][i])],
                         aspect_ratios=[float(r) for r in c["ratios"][i]],
                         flip=True, clip=True, offset=0.5,
                         min_max_aspect_ratios_order=True)))
        for src, dst in ((f"pb{i}", f"pbf{i}"), (f"pv{i}", f"pvf{i}")):
            ops.append(("reshape2", {"X": [src]},
                        {"Out": [dst], "XShape": [f"{dst}_xshape"]},
                        {"shape": [-1, 4]}))
        pri.append(f"pbf{i}")
        var.append(f"pvf{i}")
    ops += [("concat", {"X": pri}, {"Out": ["priors"]}, {"axis": 0}),
            ("concat", {"X": var}, {"Out": ["prior_var"]}, {"axis": 0})]
    n_priors = sum(m * m * (2 + 2 * len(r))
                   for m, r in zip(c["maps"], c["ratios"]))
    feeds["loc"] = torch.randn((b, n_priors, 4), generator=gen,
                               device=dev) * 0.5
    feeds["conf"] = torch.randn((b, n_priors, c["classes"]), generator=gen,
                                device=dev) * 2
    xy = torch.rand((b * c["gt"], 2), generator=gen, device=dev) * 0.7
    feeds["gt"] = torch.cat([xy, xy + 0.05 + torch.rand(
        (b * c["gt"], 2), generator=gen, device=dev) * 0.25], 1)
    ops += [
        ("box_coder", {"PriorBox": ["priors"], "PriorBoxVar": ["prior_var"],
                       "TargetBox": ["loc"]}, {"OutputBox": ["decoded"]},
         dict(code_type="decode_center_size", box_normalized=True)),
        ("softmax", {"X": ["conf"]}, {"Out": ["probs"]}, {"axis": -1}),
        ("transpose2", {"X": ["probs"]},
         {"Out": ["scores_t"], "XShape": ["scores_xshape"]},
         {"axis": [0, 2, 1]}),
        ("multiclass_nms", {"BBoxes": ["decoded"], "Scores": ["scores_t"]},
         {"Out": ["dets"], "NmsRoisNum": ["num"]}, c["nms"]),
        ("iou_similarity", {"X": ["gt"], "Y": ["priors"]}, {"Out": ["iou"]},
         dict(box_normalized=True)),
        ("reshape2", {"X": ["iou"]},
         {"Out": ["dist"], "XShape": ["dist_xshape"]},
         {"shape": [-1, c["gt"], n_priors]}),
        ("bipartite_match", {"DistMat": ["dist"]},
         {"ColToRowMatchIndices": ["match"],
          "ColToRowMatchDist": ["match_dist"]},
         dict(match_type="per_prediction", dist_threshold=0.5)),
        ("box_coder", {"PriorBox": ["priors"], "PriorBoxVar": ["prior_var"],
                       "TargetBox": ["gt"]}, {"OutputBox": ["encoded"]},
         dict(code_type="encode_center_size", box_normalized=True))]
    cut = vision_cut(lambda n: {"loc": 1, "conf": 1, "gt": c["gt"],
                                "decoded": 1, "probs": 1, "scores_t": 1,
                                "dets": 1, "num": 1, "iou": c["gt"],
                                "dist": 1, "match": 1, "match_dist": 1,
                                "encoded": c["gt"]}.get(n))
    return [vision_group(
        dev, flush, "ssd300: prior_box x6 + box_coder + multiclass_nms; "
        "iou_similarity + bipartite_match + box_coder encode", ops, feeds,
        cut=cut, checks={"dets": vision_nms_check("greedy", c["nms"], "num",
                                                  scores="scores_t"),
                         "num": lambda a, b, fa, fb: (0.0, 0)})]


def vision_rpn(dev, gen, flush):
    c = VISION["rpn"]
    b, h, w = c["batch"], c["h"], c["w"]
    a = len(c["sizes"]) * len(c["ratios"])
    feeds = {"feat": torch.zeros((1, 1, h, w), device=dev),
             "rpn_scores": torch.randn((b, a, h, w), generator=gen,
                                       device=dev),
             "rpn_deltas": torch.randn((b, 4 * a, h, w), generator=gen,
                                       device=dev) * 0.3,
             "im_shape": torch.tensor([c["img"]] * b, dtype=torch.float32,
                                      device=dev)}
    ops = [("anchor_generator", {"Input": ["feat"]},
            {"Anchors": ["anchors"], "Variances": ["variances"]},
            dict(anchor_sizes=[float(s) for s in c["sizes"]],
                 aspect_ratios=list(c["ratios"]), stride=[16.0, 16.0],
                 offset=0.5, variances=[1.0, 1.0, 1.0, 1.0])),
           ("generate_proposals_v2",
            {"Scores": ["rpn_scores"], "BboxDeltas": ["rpn_deltas"],
             "Anchors": ["anchors"], "Variances": ["variances"],
             "ImShape": ["im_shape"]},
            {"RpnRois": ["rois"], "RpnRoiProbs": ["probs"],
             "RpnRoisNum": ["num"]}, c["attrs"])]
    cut = vision_cut(lambda n: 1 if n in ("rpn_scores", "rpn_deltas",
                                          "im_shape", "rois", "probs",
                                          "num") else None)
    return [vision_group(
        dev, flush, "faster_rcnn c4: anchor_generator + "
        "generate_proposals_v2", ops, feeds, cut=cut,
        checks={"rois": vision_nms_check("proposals", c["attrs"], "num",
                                         probs="probs", scores="rpn_scores"),
                "probs": lambda a, b, fa, fb: (0.0, 0),
                "num": lambda a, b, fa, fb: (0.0, 0)})]


def random_rois(gen, dev, n, img=(800, 1333)):
    """``n`` boxes inside an ``img`` image, 16 to 600 pixels a side."""
    hw = torch.tensor([img[1], img[0]], dtype=torch.float32, device=dev)
    size = 16 + torch.rand((n, 2), generator=gen, device=dev) * 584
    lo = torch.rand((n, 2), generator=gen, device=dev) * (hw - size)
    return torch.cat([lo, lo + size], 1)


def vision_rois(dev, gen, flush):
    rows = []
    c = VISION["roi"]
    n = c["x"][0] * c["per_image"]
    feeds = {"x": torch.relu(torch.randn(c["x"], generator=gen,
                                         device=dev)),
             "rois": random_rois(gen, dev, n),
             "rois_num": torch.full((c["x"][0],), c["per_image"],
                                    dtype=torch.int32, device=dev)}
    ops = [("roi_align", {"X": ["x"], "ROIs": ["rois"],
                          "RoisNum": ["rois_num"]}, {"Out": ["aligned"]},
            dict(pooled_height=c["align"], pooled_width=c["align"],
                 spatial_scale=1 / 16, sampling_ratio=0, aligned=True)),
           ("roi_pool", {"X": ["x"], "ROIs": ["rois"],
                         "RoisNum": ["rois_num"]},
            {"Out": ["pooled"], "Argmax": ["argmax"]},
            dict(pooled_height=c["pool"], pooled_width=c["pool"],
                 spatial_scale=1 / 16))]
    first = vision_cut(lambda n: c["cpu_rois"] if n in (
        "rois", "aligned", "pooled", "argmax") else None)
    rows.append(vision_group(dev, flush, "roi_align 14x14 + roi_pool 7x7",
                             ops, feeds, grad=("aligned", "pooled"),
                             no_grad=("rois",), cut=first))
    p, q = VISION["psroi"], VISION["prroi"]
    n = q["x"][0] * q["per_image"]
    feeds = {"x_ps": torch.randn(p["x"], generator=gen, device=dev),
             "rois_ps": random_rois(gen, dev, p["rois"]),
             "x_pr": torch.randn(q["x"], generator=gen, device=dev),
             "rois_pr": random_rois(gen, dev, n),
             "batch_num": torch.full((q["x"][0],), q["per_image"],
                                     dtype=torch.int32, device=dev)}
    ops = [("psroi_pool", {"X": ["x_ps"], "ROIs": ["rois_ps"]},
            {"Out": ["ps"]}, dict(output_channels=p["out_c"],
                                  pooled_height=p["bins"],
                                  pooled_width=p["bins"],
                                  spatial_scale=1 / 16)),
           ("prroi_pool", {"X": ["x_pr"], "ROIs": ["rois_pr"],
                           "BatchRoINums": ["batch_num"]},
            {"Out": ["pr"]}, dict(pooled_height=q["bins"],
                                  pooled_width=q["bins"],
                                  spatial_scale=1 / 16))]
    first = vision_cut(lambda n: {"rois_ps": p["cpu_rois"],
                                  "ps": p["cpu_rois"],
                                  "rois_pr": q["cpu_rois"],
                                  "pr": q["cpu_rois"]}.get(n))
    rows.append(vision_group(dev, flush, "psroi_pool; prroi_pool", ops,
                             feeds, grad=("ps", "pr"),
                             no_grad=("rois_ps", "rois_pr"), cut=first))
    return rows


def vision_dense(dev, gen, flush):
    rows = []
    one = vision_cut(lambda n: 1)
    c = VISION["deform"]
    n, _ci, h, w = c["x"]
    kk = c["filter"][2] * c["filter"][3]
    feeds = {"x": torch.randn(c["x"], generator=gen, device=dev),
             "offset": torch.randn((n, 2 * kk, h, w), generator=gen,
                                   device=dev) * 2,
             "mask": torch.rand((n, kk, h, w), generator=gen, device=dev),
             "filter": torch.randn(c["filter"], generator=gen,
                                   device=dev) * 0.02}
    attrs = dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                 groups=1, deformable_groups=1)
    ops = [("deformable_conv", {"Input": ["x"], "Offset": ["offset"],
                                "Mask": ["mask"], "Filter": ["filter"]},
            {"Output": ["out_v2"]}, attrs),
           ("deformable_conv_v1", {"Input": ["x"], "Offset": ["offset"],
                                   "Filter": ["filter"]},
            {"Output": ["out_v1"]}, attrs)]
    rows.append(vision_group(
        dev, flush, "deformable_conv (v2) + deformable_conv_v1", ops, feeds,
        grad=("out_v2", "out_v1"),
        cut=vision_cut(lambda n: None if n == "filter" else 1)))
    g, k = VISION["grid"], VISION["corr"]
    gn, _gc, gh, gw = g["x"]
    feeds = {"img": torch.randn(g["x"], generator=gen, device=dev),
             "grid": torch.rand((gn, gh, gw, 2), generator=gen,
                                device=dev) * 2.2 - 1.1,
             "frame1": torch.randn(k["x"], generator=gen, device=dev),
             "frame2": torch.randn(k["x"], generator=gen, device=dev)}
    ops = [("grid_sampler", {"X": ["img"], "Grid": ["grid"]},
            {"Output": ["warped"]},
            dict(mode="bilinear", padding_mode="zeros", align_corners=False)),
           ("correlation", {"Input1": ["frame1"], "Input2": ["frame2"]},
            {"Output": ["cost"]}, k["attrs"])]
    rows.append(vision_group(dev, flush, "grid_sampler; correlation", ops,
                             feeds, grad=("warped", "cost"), cut=one))
    c, t = VISION["c3d"], VISION["tsm"]
    pooled_in = (c["x"][0], c["filter"][0]) + c["x"][2:]
    feeds = {"clip": torch.randn(c["x"], generator=gen, device=dev),
             "w3": torch.randn(c["filter"], generator=gen,
                               device=dev) * 0.03,
             # the pools take a feed of conv3a's output shape: after the
             # conv, last-bit differences between cuDNN and the CPU would
             # move a near-tied maximum, and its gradient with it
             "c3": torch.randn(pooled_in, generator=gen, device=dev),
             "segs": torch.randn(t["x"], generator=gen, device=dev)}
    ops = [("conv3d", {"Input": ["clip"], "Filter": ["w3"]},
            {"Output": ["conv"]}, dict(strides=[1, 1, 1],
                                       paddings=[1, 1, 1])),
           ("pool3d", {"X": ["c3"]}, {"Out": ["p3"]},
            dict(pooling_type="max", ksize=[2, 2, 2], strides=[2, 2, 2])),
           ("max_pool3d_with_index", {"X": ["c3"]},
            {"Out": ["p3i"], "Mask": ["mask3"]},
            dict(ksize=[2, 2, 2], strides=[2, 2, 2])),
           ("temporal_shift", {"X": ["segs"]}, {"Out": ["shifted"]},
            dict(seg_num=t["seg_num"], shift_ratio=t["ratio"]))]
    rows.append(vision_group(
        dev, flush, "conv3d + pool3d max + max_pool3d_with_index; "
        "temporal_shift", ops, feeds,
        grad=("conv", "p3", "p3i", "shifted"),
        cut=vision_cut(lambda n: {"w3": None, "segs": t["seg_num"],
                                  "shifted": t["seg_num"]}.get(n, 1)),
        checks={"mask3": mask_check("c3")}))
    feeds = {"seg": torch.randn(VISION["segnet"], generator=gen, device=dev),
             "alex": torch.randn(VISION["alexnet"], generator=gen,
                                 device=dev),
             "sr": torch.randn(VISION["sr"], generator=gen, device=dev)}
    rows_, classes = VISION["labels"]
    feeds["labels"] = F.one_hot(torch.randint(
        0, classes, (rows_,), generator=gen, device=dev), classes).float()
    ops = [("max_pool2d_with_index", {"X": ["seg"]},
            {"Out": ["seg_pooled"], "Mask": ["seg_mask"]},
            dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0])),
           ("lrn", {"X": ["alex"]}, {"Out": ["lrn"], "MidOut": ["lrn_mid"]},
            dict(n=5, alpha=1e-4, beta=0.75, k=2.0)),
           ("pixel_shuffle", {"X": ["sr"]}, {"Out": ["shuffled"]},
            dict(upscale_factor=2)),
           ("label_smooth", {"X": ["labels"]}, {"Out": ["smoothed"]},
            dict(epsilon=0.1))]
    rows.append(vision_group(
        dev, flush, "max_pool2d_with_index; lrn; pixel_shuffle; "
        "label_smooth", ops, feeds,
        grad=("seg_pooled", "lrn", "shuffled", "smoothed"),
        cut=vision_cut(lambda n: 64 if n in ("labels", "smoothed") else 1),
        checks={"seg_mask": mask_check("seg")}))
    return rows


def vision_small(dev, gen, flush):
    """The slice's other lowerings at small shapes, each its own program;
    ``crop_tensor`` with an ``Offsets`` tensor is the one that runs
    eagerly (``shape_tensor``)."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def boxes(n, scale=1.0):
        xy = torch.rand((n, 2), generator=gen, device=dev) * 0.6 * scale
        return torch.cat([xy, xy + (0.1 + torch.rand(
            (n, 2), generator=gen, device=dev) * 0.3) * scale], 1)

    tied = (torch.randint(0, 4, (4, 3, 12, 12), generator=gen,
                          device=dev) / 4.0)
    cases = (
        ("space_to_depth", dict(X=r(4, 8, 16, 16)), ["Out"],
         dict(blocksize=2)),
        ("shuffle_channel", dict(X=r(4, 12, 8, 8)), ["Out"], dict(group=3)),
        ("affine_channel", dict(X=r(4, 16, 8, 8), Scale=r(16), Bias=r(16)),
         ["Out"], {}),
        ("pad_constant_like", dict(X=r(6, 9, 9), Y=r(4, 7, 9)), ["Out"],
         dict(pad_value=0.5)),
        ("crop", dict(X=r(8, 16, 16)), ["Out"],
         dict(offsets=[2, 3, 1], shape=[4, 8, -1])),
        ("crop_tensor", dict(X=r(8, 16, 16), Offsets=torch.tensor(
            [1, 2, 3], dtype=torch.int32, device=dev)), ["Out"],
         dict(shape=[4, 8, 8])),
        ("reverse", dict(X=r(8, 16, 5)), ["Out"], dict(axis=[0, 2])),
        ("unfold", dict(X=r(2, 8, 16, 16)), ["Y"],
         dict(kernel_sizes=[3, 3], strides=[2, 2], paddings=[1, 1, 1, 1],
              dilations=[1, 1])),
        ("im2sequence", dict(X=r(2, 4, 12, 12)), ["Out"],
         dict(kernels=[3, 3], strides=[2, 2], paddings=[1, 1, 1, 1])),
        ("cvm", dict(X=torch.cat([torch.rand((64, 2), generator=gen,
                                             device=dev) * 5, r(64, 14)], 1)),
         ["Y"], dict(use_cvm=True)),
        ("iou_similarity", dict(X=boxes(32, 100.0), Y=boxes(48, 100.0)),
         ["Out"], dict(box_normalized=False)),
        ("box_clip", dict(Input=boxes(64, 900.0).reshape(2, 32, 4) - 50,
                          ImInfo=torch.tensor([[600.0, 800.0, 1.5],
                                               [500.0, 700.0, 1.0]],
                                              device=dev)), ["Output"], {}),
        ("box_coder", dict(PriorBox=boxes(64), TargetBox=r(8, 64, 4) * 0.3),
         ["OutputBox"], dict(code_type="decode_center_size", axis=0,
                             variance=[0.1, 0.1, 0.2, 0.2])),
        ("pool3d", dict(X=r(2, 4, 6, 9, 9)), ["Out"],
         dict(pooling_type="avg", ksize=[3, 3, 3], strides=[2, 2, 2],
              paddings=[1, 1, 1])),
        ("max_pool2d_with_index", dict(X=tied), ["Out", "Mask"],
         dict(ksize=[5, 5], adaptive=True)),
        ("grid_sampler", dict(X=r(2, 4, 16, 16), Grid=torch.rand(
            (2, 9, 11, 2), generator=gen, device=dev) * 3 - 1.5),
         ["Output"], dict(mode="nearest", padding_mode="reflection",
                          align_corners=True)),
        ("grid_sampler", dict(X=r(2, 4, 16, 16), Grid=torch.rand(
            (2, 9, 11, 2), generator=gen, device=dev) * 3 - 1.5),
         ["Output"], dict(mode="bilinear", padding_mode="border",
                          align_corners=False)),
        ("correlation", dict(Input1=r(1, 16, 24, 24), Input2=r(1, 16, 24, 24)),
         ["Output"], dict(pad_size=4, kernel_size=3, max_displacement=4,
                          stride1=2, stride2=2)),
        ("generate_proposals", dict(
            Scores=r(1, 3, 8, 10), BboxDeltas=r(1, 12, 8, 10) * 0.3,
            ImInfo=torch.tensor([[128.0, 160.0, 1.0]], device=dev),
            Anchors=torch.cat([boxes(240, 100.0)]).reshape(8, 10, 3, 4),
            Variances=torch.ones((8, 10, 3, 4), device=dev)),
         ["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
         dict(pre_nms_topN=120, post_nms_topN=40, nms_thresh=0.6,
              min_size=2.0)),
        ("multiclass_nms2", dict(BBoxes=boxes(64).reshape(1, 64, 4),
                                 Scores=torch.rand((1, 4, 64), generator=gen,
                                                   device=dev)),
         ["Out", "Index", "NmsRoisNum"],
         dict(score_threshold=0.2, nms_top_k=32, keep_top_k=40,
              nms_threshold=0.5, nms_eta=0.9, background_label=0)),
    )
    rows, eager = [], []
    for i, (op_type, ins, outs, attrs) in enumerate(cases):
        ops, feeds = one_op(op_type, ins, outs, attrs)
        float_outs = tuple(o.lower() for o in outs
                           if o not in ("Mask", "Index", "NmsRoisNum",
                                        "RpnRoisNum"))
        checks = None
        if op_type == "generate_proposals":
            checks = {"rpnrois": vision_nms_check(
                "proposals", attrs, "rpnroisnum", probs="rpnroiprobs",
                scores="scores_0"),
                "rpnroiprobs": lambda a, b, fa, fb: (0.0, 0),
                "rpnroisnum": lambda a, b, fa, fb: (0.0, 0)}
            float_outs = ()
        elif op_type == "multiclass_nms2":
            checks = {"out": vision_nms_check("greedy", attrs, "nmsroisnum",
                                              "index", scores="scores_0"),
                      "index": lambda a, b, fa, fb: (0.0, 0),
                      "nmsroisnum": lambda a, b, fa, fb: (0.0, 0)}
            float_outs = ()
        row = vision_group(dev, flush, f"{i}_{op_type}", ops, feeds,
                           grad=float_outs, checks=checks)
        rows.append(row)
        if "Offsets" in ins:
            eager.append(row)
    return rows, eager


def vision_dygraph(dev, gen):
    """``vision.ops``' four functions once in dygraph on the card, each
    against the same op through the Executor on the card: equal."""
    from paddle_tpu_torch.vision import ops as vops

    pt.set_device("gpu:0")
    c = VISION["yolo"]
    x = torch.randn((2, 3 * (5 + c["classes"]), 19, 19), generator=gen,
                    device=dev)
    img = torch.full((2, 2), c["img"], dtype=torch.int32, device=dev)
    roi_x = torch.randn((2, 256, 50, 84), generator=gen, device=dev)
    rois = random_rois(gen, dev, 128)
    num = torch.tensor([64, 64], dtype=torch.int32, device=dev)
    dx = torch.randn((2, 64, 19, 19), generator=gen, device=dev)
    off = torch.randn((2, 18, 19, 19), generator=gen, device=dev)
    mask = torch.rand((2, 9, 19, 19), generator=gen, device=dev)
    wt = torch.randn((64, 64, 3, 3), generator=gen, device=dev) * 0.05
    anchors = [116, 90, 156, 198, 373, 326]

    def t(v):
        return pt.to_tensor(v.cpu().numpy())

    calls = {
        "yolo_box": (lambda: vops.yolo_box(
            t(x), t(img), anchors, c["classes"], 0.005, 32)[0],
            ("yolo_box", dict(X=x, ImgSize=img), ["Boxes", "Scores"],
             dict(anchors=anchors, class_num=c["classes"],
                  conf_thresh=0.005, downsample_ratio=32, clip_bbox=True,
                  scale_x_y=1.0))),
        "deform_conv2d": (lambda: vops.deform_conv2d(
            t(dx), t(off), t(wt), padding=1, mask=t(mask)),
            ("deformable_conv", dict(Input=dx, Offset=off, Filter=wt,
                                     Mask=mask), ["Output"],
             dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                  groups=1, deformable_groups=1))),
        "roi_align": (lambda: vops.roi_align(
            t(roi_x), t(rois), t(num), 7, 1 / 16, 0, True),
            ("roi_align", dict(X=roi_x, ROIs=rois, RoisNum=num), ["Out"],
             dict(pooled_height=7, pooled_width=7, spatial_scale=1 / 16,
                  sampling_ratio=0, aligned=True))),
        "roi_pool": (lambda: vops.roi_pool(t(roi_x), t(rois), t(num), 7,
                                           1 / 16),
                     ("roi_pool", dict(X=roi_x, ROIs=rois, RoisNum=num),
                      ["Out", "Argmax"],
                      dict(pooled_height=7, pooled_width=7,
                           spatial_scale=1 / 16))),
    }
    gaps = {}
    exe = pt.Executor(pt.CUDAPlace(0))
    try:
        for name, (dy, (op_type, ins, outs, attrs)) in calls.items():
            got = dy()._value
            ops, feeds = one_op(op_type, ins, outs, attrs)
            prog, fetch, _ = oplib_program(ops, feeds)
            want = oplib_run(exe, prog, feeds, fetch)[0]
            gaps[name] = vision_gap(got, want) if got.device == want.device \
                else float("inf")
    finally:
        exe.close()
    return gaps


def phase_vision_ops():
    """The vision and detection ops of slice 22 on the card at their
    users' widths (``VISION``): each group one program through the
    Executor, captured (crop_tensor with Offsets eager), forward and input
    gradient, against the port's CPU path on the same (cut) inputs
    (``OPLIB_RTOL``; NMS and pool masks by the margin rules); the four
    ``vision.ops`` functions in dygraph against the static path; no
    hand-written kernel launched."""
    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    gen = torch.Generator(device=dev).manual_seed(22)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    zero_kernel_launches()
    eager0 = eager_counts()
    rows, seconds = [], {}
    for name, fn in (("yolo", vision_yolo), ("ssd", vision_ssd),
                     ("rpn", vision_rpn), ("rois", vision_rois),
                     ("dense", vision_dense)):
        t1 = time.monotonic()
        rows += fn(dev, gen, flush)
        seconds[name] = time.monotonic() - t1
    t1 = time.monotonic()
    small, eager_rows = vision_small(dev, gen, flush)
    rows += small
    seconds["small"] = time.monotonic() - t1
    t1 = time.monotonic()
    dygraph = vision_dygraph(dev, gen)
    seconds["dygraph"] = time.monotonic() - t1
    launches = kernel_launches()
    eager1 = eager_counts()
    moved = {k: eager1.get(k, 0) - eager0.get(k, 0)
             for k in set(eager0) | set(eager1)
             if eager1.get(k, 0) != eager0.get(k, 0)}
    bad = [r for r in rows if r["max_rel_gap"] > OPLIB_RTOL]
    uncaptured = [r["group"] for r in rows
                  if not r["captured"] and r not in eager_rows]
    flips = {r["group"]: r["margin_flips"] for r in rows
             if any(r["margin_flips"].values())}
    log("vision_ops", card=card, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32, tolerance=OPLIB_RTOL,
        margin=VISION_MARGIN, groups=rows, margin_flips=flips,
        dygraph_gaps=dygraph, eager_moved=moved, launches_after=launches,
        group_seconds=seconds, seconds=time.monotonic() - t0)
    if bad or any(g > OPLIB_RTOL for g in dygraph.values()):
        raise RuntimeError(f"vision_ops, card vs CPU: {bad} {dygraph}")
    if uncaptured or [r["captured"] for r in eager_rows] != [False] or \
            set(moved) != {"executor_eager_shape_tensor"}:
        raise RuntimeError(f"vision_ops capture: uncaptured {uncaptured}, "
                           f"eager counters moved {moved}")
    if not all(r["finite"] for r in rows):
        raise RuntimeError("vision_ops: non-finite outputs at full width: "
                           f"{[r['group'] for r in rows if not r['finite']]}")
    if any(launches.values()):
        raise RuntimeError(f"vision_ops launched hand-written kernels: "
                           f"{launches}")


# sequence_misc_ops: the sequence ops, the linear-chain CRF, the sampled
# losses and the rest of the op library (ROADMAP item 5c), each group one
# program through the Executor on the card, captured (its executor_eager_*
# counters unchanged) but for the named eager rows (``sequence_slice`` and
# ``affine_grid`` with an ``OutputShape`` tensor read on the host:
# ``shape_tensor``; the seeded sampled losses: ``seeded_random``), forward
# and input gradient, then on the card and the CPU from the same cut
# inputs (``vision_group``; OPLIB_RTOL).  A Viterbi path of the card may
# differ from the CPU's only in a row whose two paths score within
# VISION_MARGIN of each other (a near-tie that the card's and the CPU's
# float32 may break apart); such rows are counted.  The sampled losses'
# CPU reference reads the card's draw (``sampling_ops._draw_samples``
# replaced while the CPU runs); the draws themselves are held to their
# statistics on the card (SEQMISC_DRAWS draws a sampler, bins merged until
# each expects SEQMISC_MIN_EXPECTED, each within SEQMISC_SIGMAS standard
# deviations).
SEQMISC_DRAWS = 1_000_000
SEQMISC_MIN_EXPECTED = 100.0
SEQMISC_SIGMAS = 5.0
SEQMISC = dict(   # the shapes, at the widths of the models that run them
    # a BiGRU-CRF tagger as Baidu LAC: 57 tags, batch 64, up to 128 tokens
    tagger=dict(batch=64, steps=128, tags=57, min_len=16, cpu_rows=4),
    # a text CNN over padded batches: 64 x 128 tokens of 128-d embeddings,
    # a context-3 convolution 128 -> 128 over the 8,192 flattened tokens
    text_cnn=dict(batch=64, steps=128, width=128, context=3, start=-1,
                  window=3, scatter_rows=1024, scatter_ids=4096),
    # DeepSpeech2's lookahead: 3,000 frames of 2,048 units, 20 ahead
    speech=dict(frames=3000, width=2048, lookahead=20, cpu_cols=256),
    # word2vec's NCE at batch 4,096 over a 100,000 x 300 table, 5
    # negatives; a sampled softmax over a 32,000-way vocab, 128 samples
    sampled=dict(batch=4096, dim=300, classes=100000, negatives=5,
                 logits=(1024, 32000), samples=128, cpu_rows=64),
    # SegNet's pool / unpool on CamVid (VISION["segnet"]); a spatial
    # transformer's grid; a 3-D decoder's x2 transposed conv; a depthwise
    # x2 upsampler; FSP distillation over ResNet's 56 x 56 stage; a GAN
    # discriminator's 512 x 512 x 3 x 3 conv under spectral norm;
    # CASIA-WebFace center loss (10,575 identities, 512-d, batch 256); a
    # CTR model's data_norm and batch_fc
    stn=(32, 3, 128, 128), deconv3d=(2, 256, 16, 32, 32), deconv3d_out=128,
    depthwise=(8, 256, 64, 64), fsp=(32, 64, 56, 56), spectral=(512, 512, 3, 3),
    center=dict(batch=256, dim=512, classes=10575, rate=0.5),
    data_norm=(4096, 512), batch_fc=dict(slots=10, rows=2048, dim=64, out=32),
)


def seqmisc_viterbi_check(emission, transition, length):
    """A ``checks`` entry for a ``crf_decoding`` path (no Label): the rows
    where card and CPU differ must score, as float64 paths of the CPU's
    inputs, within VISION_MARGIN (relative) of each other; (gap, rows)."""
    def score(e, tr, path, n):
        start, stop, m = tr[0], tr[1], tr[2:]
        p = path[:n].long()
        s = start[p[0]] + e[torch.arange(n), p].sum() + stop[p[-1]]
        return s + m[p[:-1], p[1:]].sum()

    def check(a, b, fa, fb):
        if a.shape != b.shape:
            return float("inf"), 0
        rows = (a != b).any(1).nonzero().flatten().tolist()
        e = fb[emission].double().cpu()
        tr = fb[transition].double().cpu()
        lens = fb[length].cpu()
        for r in rows:
            n = int(lens[r])
            sa = score(e[r], tr, a[r].cpu(), n)
            sb = score(e[r], tr, b[r].cpu(), n)
            if abs(float(sa - sb)) > VISION_MARGIN * max(abs(float(sb)), 1.0):
                return float("inf"), len(rows)
        return 0.0, len(rows)
    return check


def seqmisc_tagger(dev, gen, flush):
    c = SEQMISC["tagger"]
    b, t, d = c["batch"], c["steps"], c["tags"]
    lens = torch.randint(c["min_len"], t + 1, (b,), generator=gen, device=dev)
    lens[0], lens[1] = t, c["min_len"]
    feeds = {"emission": torch.randn((b, t, d), generator=gen, device=dev),
             "transition": torch.randn((d + 2, d), generator=gen,
                                       device=dev) * 0.5,
             "label": torch.randint(0, d, (b, t), generator=gen, device=dev),
             "length": lens}
    ins = {"Emission": ["emission"], "Transition": ["transition"],
           "Length": ["length"]}
    ops = [("linear_chain_crf", {**ins, "Label": ["label"]},
            {"LogLikelihood": ["nll"], "Alpha": ["alpha"],
             "EmissionExps": ["emission_exps"],
             "TransitionExps": ["transition_exps"]}, {}),
           ("crf_decoding", ins, {"ViterbiPath": ["path"]}, {}),
           ("crf_decoding", {**ins, "Label": ["label"]},
            {"ViterbiPath": ["path_hits"]}, {})]
    path_check = seqmisc_viterbi_check("emission", "transition", "length")

    def hits_check(a, b, fa, fb):
        """The 0 / 1 hits may differ only in rows whose paths differ,
        which ``path_check`` holds to the margin rule."""
        if a.shape != b.shape:
            return float("inf"), 0
        rows = (a != b).any(1)
        paths = (fa["path"] != fb["path"].to(a.device)).any(1)
        return (0.0 if not (rows & ~paths).any() else float("inf")), \
            int(rows.sum())

    return [vision_group(
        dev, flush, "linear_chain_crf + crf_decoding", ops, feeds,
        grad=("nll",),
        cut=vision_cut(lambda n: None if n.startswith("transition")
                       else c["cpu_rows"]),
        checks={"path": path_check, "path_hits": hits_check})]


def seqmisc_text_cnn(dev, gen, flush):
    c = SEQMISC["text_cnn"]
    b, t, w = c["batch"], c["steps"], c["width"]
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[0], lens[1] = t, 0
    feeds = {"padded": torch.randn((b, t, w), generator=gen, device=dev),
             "flat": torch.randn((b * t, w), generator=gen, device=dev),
             "pad_value": torch.zeros((1,), device=dev),
             "length": lens,
             "filter": torch.randn((c["context"] * w, w), generator=gen,
                                   device=dev) * 0.05,
             "ids": torch.randint(0, 30000, (b * t,), generator=gen,
                                  device=dev),
             "pooled_rows": torch.randn((b, w), generator=gen, device=dev),
             "table": torch.randn((c["scatter_rows"], w), generator=gen,
                                  device=dev),
             "rows": torch.randint(-c["scatter_rows"], c["scatter_rows"] + 64,
                                   (c["scatter_ids"], 1), generator=gen,
                                   device=dev),
             "updates": torch.randn((c["scatter_ids"], w), generator=gen,
                                    device=dev)}
    ops = [("sequence_unpad", {"X": ["padded"], "Length": ["length"]},
            {"Out": ["unpadded"]}, {}),
           ("sequence_pad", {"X": ["flat"], "PadValue": ["pad_value"],
                             "Length": ["length"]}, {"Out": ["repadded"]},
            {"padded_length": t}),
           ("sequence_mask", {"X": ["length"]}, {"Y": ["mask"]},
            {"maxlen": t})]
    ops += [("sequence_pool", {"X": ["padded"]},
             {"Out": [f"pool_{p.lower()}"],
              **({"MaxIndex": ["pool_argmax"]} if p == "MAX" else {})},
             {"pooltype": p})
            for p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST")]
    ops += [("sequence_softmax", {"X": ["padded"]}, {"Out": ["softmax"]}, {}),
            ("sequence_conv", {"X": ["flat"], "Filter": ["filter"]},
             {"Out": ["conv"]}, {"contextLength": c["context"],
                                 "contextStart": c["start"]}),
            ("sequence_expand", {"X": ["pooled_rows"], "Y": ["flat"]},
             {"Out": ["expanded"]}, {}),
            ("sequence_expand_as", {"X": ["pooled_rows"], "Y": ["flat"]},
             {"Out": ["expanded_as"]}, {}),
            ("sequence_reverse", {"X": ["padded"]}, {"Y": ["reversed"]}, {}),
            ("sequence_concat", {"X": ["padded", "reversed"]},
             {"Out": ["joined"]}, {}),
            ("sequence_reshape", {"X": ["flat"]}, {"Out": ["reshaped"]},
             {"new_dim": 2 * w}),
            ("sequence_enumerate", {"X": ["ids"]}, {"Out": ["windows"]},
             {"win_size": c["window"], "pad_value": 0}),
            ("sequence_scatter", {"X": ["table"], "Ids": ["rows"],
                                  "Updates": ["updates"]},
             {"Out": ["scattered"]}, {})]
    grad = ("unpadded", "repadded", "pool_average", "pool_sum", "pool_sqrt",
            "pool_max", "pool_last", "pool_first", "softmax", "conv",
            "expanded", "expanded_as", "joined", "reshaped", "scattered")
    return [vision_group(dev, flush, "text_cnn sequence ops", ops, feeds,
                         grad=grad)]


def seqmisc_speech(dev, gen, flush):
    c = SEQMISC["speech"]
    feeds = {"frames": torch.randn((c["frames"], c["width"]), generator=gen,
                                   device=dev),
             "lookahead": torch.randn((c["lookahead"], c["width"]),
                                      generator=gen, device=dev) * 0.2}
    ops = [("row_conv", {"X": ["frames"], "Filter": ["lookahead"]},
            {"Out": ["ahead"]}, {})]
    cols = c["cpu_cols"]
    return [vision_group(dev, flush, "row_conv", ops, feeds, grad=("ahead",),
                         cut=lambda name, t: t[:, :cols])]


def seqmisc_fixed_draw(draws):
    """A context under which ``sampling_ops._draw_samples`` returns, for
    the op of each sampler, the card's draw ``draws[sampler]`` on the
    CPU (its probabilities from ``_sampler_prob``), as the CPU reference
    of the sampled losses reads it."""
    from paddle_tpu_torch.ops import sampling_ops as so

    def fixed(ctx, op, n_samples, n_classes):
        sampler = int(op.attr("sampler", 0))
        custom = None
        if sampler == 2:
            custom = ctx.in1(op, "CustomDistProbs").reshape(-1).float()
            custom = custom / custom.sum()
        s = draws[(op.type, sampler)].to(ctx.device)
        return s, so._sampler_prob(s, sampler, n_classes, custom), custom

    @contextlib.contextmanager
    def context():
        saved = so._draw_samples
        so._draw_samples = fixed
        try:
            yield
        finally:
            so._draw_samples = saved
    return context


def seqmisc_zipf(classes, dev):
    """A word-frequency-like custom distribution: 1 / (rank + 10), every
    seventh class 0."""
    p = 1.0 / (torch.arange(classes, device=dev, dtype=torch.float32) + 10)
    p[::7] = 0.0
    return p


def seqmisc_sampled(dev, gen, flush):
    c = SEQMISC["sampled"]
    b, d, k = c["batch"], c["dim"], c["classes"]
    lb, lc = c["logits"]
    feeds = {"words": torch.randn((b, d), generator=gen, device=dev),
             "targets": torch.randint(0, k, (b, 1), generator=gen,
                                      device=dev),
             "table": torch.randn((k, d), generator=gen, device=dev) * 0.1,
             "bias": torch.randn((k,), generator=gen, device=dev) * 0.1,
             "custom": seqmisc_zipf(k, dev),
             "logits": torch.randn((lb, lc), generator=gen, device=dev),
             "labels": torch.randint(0, lc, (lb, 1), generator=gen,
                                     device=dev)}
    ops = []
    for sampler in (0, 1, 2):
        ins = {"Input": ["words"], "Label": ["targets"], "Weight": ["table"],
               "Bias": ["bias"]}
        if sampler == 2:
            ins["CustomDistProbs"] = ["custom"]
        ops.append(("nce", ins, {"Cost": [f"cost{sampler}"],
                                 "SampleLogits": [f"nce_logits{sampler}"],
                                 "SampleLabels": [f"nce_labels{sampler}"]},
                    dict(num_total_classes=k, num_neg_samples=c["negatives"],
                         sampler=sampler, seed=23 + sampler)))
    ops.append(("sample_logits", {"Logits": ["logits"], "Labels": ["labels"]},
                {"SampledLogits": ["sampled"], "Samples": ["samples"],
                 "Probabilities": ["probs"], "SampledLabels": ["sampled_lbl"]},
                dict(num_samples=c["samples"], sampler=1, seed=29,
                     remove_accidental_hits=True)))
    # the card's draws, for the CPU reference (seeded: every run draws
    # the same classes)
    exe = pt.Executor(pt.CUDAPlace(0))
    try:
        prog, fetch, _ = oplib_program(ops, feeds)
        got = dict(zip(fetch, oplib_run(exe, prog, feeds, fetch)))
    finally:
        exe.close()
    n = c["negatives"]
    draws = {("nce", s): got[f"nce_labels{s}"][0, 1:1 + n].cpu()
             for s in (0, 1, 2)}
    draws[("sample_logits", 1)] = got["samples"][0, 1:].cpu()
    rows = c["cpu_rows"]
    return [vision_group(
        dev, flush, "nce (samplers 0, 1, 2) + sample_logits", ops, feeds,
        grad=("cost0", "cost1", "cost2", "sampled"),
        no_grad=("custom",),
        cut=vision_cut(lambda name: None if name in (
            "table", "bias", "custom") else rows),
        cpu_context=seqmisc_fixed_draw(draws))]


def seqmisc_draw_stats(dev):
    """SEQMISC_DRAWS draws of each sampler on the card, from a fresh
    generator, against the sampler's probabilities: bins merged in class
    order until each expects SEQMISC_MIN_EXPECTED; the largest |z| and
    the draws of classes of probability 0 (none allowed)."""
    from paddle_tpu_torch.ops import sampling_ops as so

    class Ctx:
        device = dev

        def __init__(self, probs):
            self.probs = probs
            self.gen = torch.Generator(device=dev).manual_seed(5)

        def in1(self, op, slot):
            return self.probs

        def next_generator(self):
            return self.gen

    class Op:
        type = "nce"

        def __init__(self, sampler):
            self.sampler = sampler

        def attr(self, name, default=None):
            return self.sampler if name == "sampler" else default

    k = SEQMISC["sampled"]["classes"]
    n = SEQMISC_DRAWS
    out = {}
    for sampler in (0, 1, 2):
        custom = seqmisc_zipf(k, dev) if sampler == 2 else None
        s, _p, norm = so._draw_samples(Ctx(custom), Op(sampler), n, k)
        probs = so._sampler_prob(torch.arange(k, device=dev), sampler, k,
                                 norm).double().cpu().numpy()
        counts = torch.zeros(k, dtype=torch.int64, device=dev).index_add_(
            0, s.long(), torch.ones_like(s, dtype=torch.int64)).cpu().numpy()
        # bins merged in class order until each expects enough draws (a
        # last bin short of it is left out)
        worst, bins, low, acc_c, acc_p = 0.0, 0, float("inf"), 0, 0.0
        for cnt, p in zip(counts.tolist(), probs.tolist()):
            acc_c, acc_p = acc_c + cnt, acc_p + p
            if n * acc_p >= SEQMISC_MIN_EXPECTED:
                z = abs(acc_c - n * acc_p) / math.sqrt(n * acc_p
                                                       * (1 - acc_p))
                worst, bins, low = max(worst, z), bins + 1, min(low,
                                                               n * acc_p)
                acc_c, acc_p = 0, 0.0
        out[sampler] = {"bins": bins, "max_abs_z": worst,
                        "min_expected": low, "probability_sum":
                        float(probs.sum()),
                        "zero_probability_draws": int(
                            counts[probs == 0].sum())}
    return out


def seqmisc_vision(dev, gen, flush):
    rows = []
    one = vision_cut(lambda n: 1)
    seg = torch.randn(VISION["segnet"], generator=gen, device=dev)
    ops = [("max_pool2d_with_index", {"X": ["seg"]},
            {"Out": ["seg_pooled"], "Mask": ["seg_mask"]},
            dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0])),
           ("unpool", {"X": ["seg_pooled"], "Indices": ["seg_mask"]},
            {"Out": ["seg_unpooled"]},
            dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0]))]
    rows.append(vision_group(dev, flush, "max_pool2d_with_index -> unpool",
                             ops, {"seg": seg}, grad=("seg_unpooled",),
                             cut=one, checks={"seg_mask": mask_check("seg")}))
    n, ch, h, w = SEQMISC["stn"]
    theta = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev) \
        + 0.2 * torch.randn((n, 2, 3), generator=gen, device=dev)
    ops = [("affine_grid", {"Theta": ["theta"]}, {"Output": ["grid"]},
            dict(output_shape=[n, ch, h, w], align_corners=False)),
           ("grid_sampler", {"X": ["img"], "Grid": ["grid"]},
            {"Output": ["warped"]},
            dict(mode="bilinear", padding_mode="zeros",
                 align_corners=False))]
    rows.append(vision_group(
        dev, flush, "affine_grid -> grid_sampler", ops,
        {"theta": theta, "img": torch.randn((n, ch, h, w), generator=gen,
                                            device=dev)},
        grad=("grid", "warped"), cut=one))
    x3, xd = SEQMISC["deconv3d"], SEQMISC["depthwise"]
    feeds = {"vol": torch.randn(x3, generator=gen, device=dev),
             "w3t": torch.randn((x3[1], SEQMISC["deconv3d_out"], 2, 2, 2),
                                generator=gen, device=dev) * 0.05,
             "maps": torch.randn(xd, generator=gen, device=dev),
             "wdt": torch.randn((xd[1], 1, 4, 4), generator=gen,
                                device=dev) * 0.2}
    ops = [("conv3d_transpose", {"Input": ["vol"], "Filter": ["w3t"]},
            {"Output": ["vol_up"]}, dict(strides=[2, 2, 2])),
           ("depthwise_conv2d_transpose", {"Input": ["maps"],
                                           "Filter": ["wdt"]},
            {"Output": ["maps_up"]},
            dict(strides=[2, 2], paddings=[1, 1], groups=xd[1]))]
    rows.append(vision_group(
        dev, flush, "conv3d_transpose; depthwise_conv2d_transpose", ops,
        feeds, grad=("vol_up", "maps_up"),
        cut=vision_cut(lambda n: None if n in ("w3t", "wdt") else 1)))
    f, sp = SEQMISC["fsp"], SEQMISC["spectral"]
    dn, bf = SEQMISC["data_norm"], SEQMISC["batch_fc"]
    width = sp[1] * sp[2] * sp[3]
    feeds = {"fa": torch.randn(f, generator=gen, device=dev),
             "fb": torch.randn(f, generator=gen, device=dev),
             "disc_w": torch.randn(sp, generator=gen, device=dev) * 0.02,
             "disc_u": torch.randn((sp[0],), generator=gen, device=dev),
             "disc_v": torch.randn((width,), generator=gen, device=dev),
             "ctr": torch.randn(dn, generator=gen, device=dev),
             "bsize": torch.full((dn[1],), 1e4, device=dev),
             "bsum": torch.randn((dn[1],), generator=gen, device=dev) * 100,
             "bsq": torch.rand((dn[1],), generator=gen, device=dev) * 1e4
             + 1e4,
             "slots": torch.randn((bf["slots"], bf["rows"], bf["dim"]),
                                  generator=gen, device=dev),
             "slot_w": torch.randn((bf["slots"], bf["dim"], bf["out"]),
                                   generator=gen, device=dev) * 0.1,
             "slot_b": torch.randn((bf["slots"], 1, bf["out"]),
                                   generator=gen, device=dev)}
    ops = [("fsp", {"X": ["fa"], "Y": ["fb"]}, {"Out": ["fsp"]}, {}),
           ("spectral_norm", {"Weight": ["disc_w"], "U": ["disc_u"],
                              "V": ["disc_v"]}, {"Out": ["disc_sn"]},
            dict(dim=0, power_iters=1, eps=1e-12)),
           ("data_norm", {"X": ["ctr"], "BatchSize": ["bsize"],
                          "BatchSum": ["bsum"], "BatchSquareSum": ["bsq"]},
            {"Y": ["ctr_norm"], "Means": ["ctr_means"],
             "Scales": ["ctr_scales"]}, dict(epsilon=1e-4)),
           ("batch_fc", {"Input": ["slots"], "W": ["slot_w"],
                         "Bias": ["slot_b"]}, {"Out": ["slot_out"]}, {})]
    rows.append(vision_group(
        dev, flush, "fsp; spectral_norm; data_norm; batch_fc", ops, feeds,
        grad=("fsp", "disc_sn", "ctr_norm", "slot_out"),
        cut=vision_cut(lambda n: {"fa": 1, "fb": 1, "fsp": 1,
                                  "ctr": 64, "ctr_norm": 64,
                                  "ctr_means": 64, "ctr_scales": 64}.get(n))))
    return rows


def seqmisc_center_loss(dev, gen):
    """``center_loss`` with ``CentersOut`` written to the persistable
    ``Centers``: two runs on the card and two on the CPU from the same
    centers; each run's loss and the centers after it within
    OPLIB_RTOL; the second run reads the centers the first wrote."""
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    c = SEQMISC["center"]
    values = {"feat": torch.randn((c["batch"], c["dim"]), generator=gen,
                                  device=dev),
              "ident": torch.randint(0, c["classes"], (c["batch"], 1),
                                     generator=gen, device=dev),
              "rate": torch.full((1,), c["rate"], device=dev)}
    centers0 = torch.randn((c["classes"], c["dim"]), generator=gen,
                           device=dev)
    prog = Program()
    blk = prog.global_block
    for name, t in values.items():
        blk.create_var(name=name, shape=tuple(t.shape),
                       dtype=str(t.dtype).replace("torch.", ""))
    blk.create_var(name="centers", shape=tuple(centers0.shape),
                   dtype="float32", persistable=True)
    for name in ("center_loss", "center_diff"):
        blk.create_var(name=name)
    blk.append_op("center_loss",
                  {"X": ["feat"], "Label": ["ident"], "Centers": ["centers"],
                   "CenterUpdateRate": ["rate"]},
                  {"Loss": ["center_loss"], "SampleCenterDiff":
                   ["center_diff"], "CentersOut": ["centers"]},
                  {"need_update": True})
    runs = {}
    for place, d in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        exe = pt.Executor(place)
        scope = scope_from_numpy({"centers": centers0.cpu().numpy()},
                                 device=d)
        feed = {n: t.to(d) for n, t in values.items()}
        try:
            runs[d if d == "cpu" else "card"] = [
                (exe.run(prog, feed=feed, fetch_list=["center_loss"],
                         scope=scope, return_numpy=False)[0].clone(),
                 scope.get_var("centers").clone()) for _ in range(2)]
        finally:
            exe.close()
    gaps = []
    for (la, ca), (lb, cb) in zip(runs["card"], runs["cpu"]):
        gaps += [oplib_gap(la, lb.to(dev)), oplib_gap(ca, cb.to(dev))]
    moved = [float((runs["card"][i][1] - (centers0 if i == 0 else
                                            runs["card"][0][1])).abs().max())
             for i in (0, 1)]
    return {"group": "center_loss, two runs", "gaps": gaps,
            "max_rel_gap": max(gaps), "centers_moved": moved}


def seqmisc_small(dev, gen, flush):
    """The slice's other lowerings at small shapes, in one captured
    program; ``sequence_slice`` and ``affine_grid`` with an
    ``OutputShape`` tensor each in their own, which run eagerly
    (``shape_tensor``); ``shuffle_batch`` held to being a permutation."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    feeds = {"x": r(64, 32), "y": r(64, 32), "mask": torch.rand(
        (64, 32), generator=gen, device=dev) < 0.3,
        "vals": torch.rand((4096,), generator=gen, device=dev) * 3 - 1,
        "ids": torch.randint(-3, 40, (4096,), generator=gen, device=dev),
        "weights": r(4096),
        "index": torch.randint(-40, 40, (64, 16), generator=gen,
                               device=dev),
        "put_index": torch.argsort(torch.rand((64, 32), generator=gen,
                                              device=dev), 1)[:, :8],
        "put_value": r(64, 8), "small": r(1, 32), "put_one": r(1, 1),
        "kernel": r(64, 5),
        "rows": r(16, 8)}
    ops = [("allclose", {"Input": ["x"], "Other": ["y"]}, {"Out": ["close"]},
            dict(rtol=1e-5, atol=1e-8)),
           ("allclose", {"Input": ["x"], "Other": ["x"]},
            {"Out": ["close_self"]}, {}),
           ("histogram", {"X": ["vals"]}, {"Out": ["hist"]},
            dict(bins=50, min=0, max=1)),
           ("bincount", {"X": ["ids"]}, {"Out": ["counts"]},
            dict(minlength=32)),
           ("bincount", {"X": ["ids"], "Weights": ["weights"]},
            {"Out": ["weighted"]}, dict(minlength=32)),
           ("masked_select", {"X": ["x"], "Mask": ["mask"]},
            {"Y": ["selected"], "Count": ["selected_n"]}, {}),
           ("index_sample", {"X": ["x"], "Index": ["index"]},
            {"Out": ["sampled"]}, {}),
           ("put_along_axis", {"Input": ["x"], "Index": ["put_index"],
                               "Value": ["put_value"]}, {"Result": ["put"]},
            dict(Axis=1, Reduce="assign")),
           ("put_along_axis", {"Input": ["x"], "Index": ["index"],
                               "Value": ["put_one"]}, {"Result": ["put_add"]},
            dict(Axis=1, Reduce="add")),
           ("put_along_axis", {"Input": ["x"], "Index": ["index"],
                               "Value": ["put_one"]}, {"Result": ["put_mul"]},
            dict(Axis=1, Reduce="mul")),
           ("broadcast_to", {"X": ["small"]}, {"Out": ["broadcast"]},
            dict(shape=[16, 64, 32])),
           ("full_like", {"X": ["x"]}, {"Out": ["full"]}, dict(value=0.25)),
           ("conv_shift", {"X": ["x"], "Y": ["kernel"]}, {"Out": ["shifted"]},
            {}),
           ("lod_reset", {"X": ["rows"]}, {"Out": ["lod"]}, {}),
           ("get_tensor_from_selected_rows", {"X": ["rows"]},
            {"Out": ["dense"]}, {}),
           ("merge_selected_rows", {"X": ["rows"]}, {"Out": ["merged"]}, {})]
    # index_sample fills NaN where an index is out of range, on the card
    # as on the CPU (compared entry by entry)
    rows = [vision_group(dev, flush, "small lowerings", ops, feeds,
                         grad=("selected", "sampled", "put", "put_add",
                               "broadcast", "shifted", "lod", "dense",
                               "merged", "weighted"), nan_ok=("sampled",))]
    eager = []
    ops, fd = one_op("sequence_slice", dict(
        X=r(64, 16), Offset=torch.tensor([5], device=dev),
        Length=torch.tensor([20], device=dev)), ["Out"])
    eager.append(vision_group(dev, flush, "sequence_slice (eager)", ops, fd,
                              grad=("out",)))
    ops, fd = one_op("affine_grid", dict(
        Theta=r(4, 2, 3), OutputShape=torch.tensor(
            [4, 3, 24, 32], dtype=torch.int32, device=dev)), ["Output"],
        dict(align_corners=True))
    eager.append(vision_group(dev, flush, "affine_grid OutputShape (eager)",
                              ops, fd, grad=("output",)))
    ops, fd = one_op("shuffle_batch", dict(X=r(4096, 16)),
                     ["Out", "ShuffleIdx"])
    exe = pt.Executor(pt.CUDAPlace(0))
    eager0 = eager_counts()
    try:
        prog, fetch, _ = oplib_program(ops, fd)
        outs = [[v.clone() for v in oplib_run(exe, prog, fd, fetch)]
                for _ in range(3)]
    finally:
        exe.close()
    x = fd["x_0"]
    perm_ok = all(torch.equal(torch.sort(idx.long()).values,
                              torch.arange(x.shape[0], device=dev))
                  and torch.equal(out, x[idx.long()]) for out, idx in outs)
    shuffle = {"permutation_and_gather": perm_ok,
               "captured": eager_counts() == eager0,
               "runs_differ": not torch.equal(outs[1][1], outs[2][1])}
    return rows + eager, eager, shuffle


def phase_sequence_misc_ops():
    """The sequence ops, the CRF, the sampled losses and the rest of the
    op library of slice 23 on the card at their users' widths
    (``SEQMISC``): each group one program through the Executor, captured
    (``sequence_slice`` and ``affine_grid`` with ``OutputShape`` eager,
    ``shape_tensor``; the seeded sampled losses eager, ``seeded_random``),
    forward and input gradient, against the port's CPU path on the same
    (cut) inputs (``OPLIB_RTOL``; Viterbi paths and pool masks by the
    margin rules); the draws by their statistics; no hand-written kernel
    launched."""
    t0 = time.monotonic()
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    gen = torch.Generator(device=dev).manual_seed(23)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    zero_kernel_launches()
    eager0 = eager_counts()
    rows, seconds = [], {}
    sampled_rows = []
    for name, fn in (("tagger", seqmisc_tagger),
                     ("text_cnn", seqmisc_text_cnn),
                     ("speech", seqmisc_speech),
                     ("sampled", seqmisc_sampled),
                     ("vision_misc", seqmisc_vision)):
        t1 = time.monotonic()
        got = fn(dev, gen, flush)
        rows += got
        if name == "sampled":
            sampled_rows = got
        seconds[name] = time.monotonic() - t1
    t1 = time.monotonic()
    draws = seqmisc_draw_stats(dev)
    seconds["draw_stats"] = time.monotonic() - t1
    t1 = time.monotonic()
    center = seqmisc_center_loss(dev, gen)
    seconds["center_loss"] = time.monotonic() - t1
    t1 = time.monotonic()
    small, shape_rows, shuffle = seqmisc_small(dev, gen, flush)
    rows += small
    seconds["small"] = time.monotonic() - t1
    launches = kernel_launches()
    eager1 = eager_counts()
    moved = {k: eager1.get(k, 0) - eager0.get(k, 0)
             for k in set(eager0) | set(eager1)
             if eager1.get(k, 0) != eager0.get(k, 0)}
    eager_rows = shape_rows + sampled_rows
    bad = [r for r in rows if r["max_rel_gap"] > OPLIB_RTOL]
    uncaptured = [r["group"] for r in rows
                  if not r["captured"] and r not in eager_rows]
    flips = {r["group"]: r["margin_flips"] for r in rows
             if any(r["margin_flips"].values())}
    draws_bad = {s: d for s, d in draws.items()
                 if d["max_abs_z"] > SEQMISC_SIGMAS
                 or d["zero_probability_draws"]
                 or d["min_expected"] < SEQMISC_MIN_EXPECTED}
    log("sequence_misc_ops", card=card, dtype="float32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32, tolerance=OPLIB_RTOL,
        margin=VISION_MARGIN, groups=rows, margin_flips=flips,
        center_loss=center, draws=draws, shuffle_batch=shuffle,
        eager_moved=moved, launches_after=launches, group_seconds=seconds,
        seconds=time.monotonic() - t0)
    if bad or center["max_rel_gap"] > OPLIB_RTOL:
        raise RuntimeError(f"sequence_misc_ops, card vs CPU: {bad} {center}")
    if uncaptured or any(r["captured"] for r in eager_rows) or \
            set(moved) != {"executor_eager_shape_tensor",
                           "executor_eager_seeded_random"}:
        raise RuntimeError(f"sequence_misc_ops capture: uncaptured "
                           f"{uncaptured}, eager counters moved {moved}")
    if not all(r["finite"] for r in rows):
        raise RuntimeError("sequence_misc_ops: non-finite outputs at full "
                           f"width: {[r['group'] for r in rows if not r['finite']]}")
    if draws_bad or not all(shuffle.values()):
        raise RuntimeError(f"sequence_misc_ops draws: {draws_bad} "
                           f"shuffle_batch {shuffle}")
    if any(launches.values()):
        raise RuntimeError(f"sequence_misc_ops launched hand-written "
                           f"kernels: {launches}")


# ---- slice 14: the rest of serving --------------------------------------------

# runs of the packed ragged schedule (phase_ragged): its pad waste
# depends on the arrivals' timing, so the median is compared
RAGGED_RUNS = 3
SERVE_MODEL = dict(vocab_size=32000, d_model=512, num_layers=8, num_heads=8,
                   ffn_dim=2048, max_seq_len=1024)
# Greedy tokens of two paths (speculative vs not, ragged vs padded,
# migrated vs local) are compared up to the first position whose top-2
# logit margin is under MARGIN_TOL: there the paths' logits, which agree
# only to summation order (B6 rows vs B5 rows), may rank the two tokens
# either way.  A divergence at a larger margin is a fault.
MARGIN_TOL = 1e-3
SPEC_K = 3
SPEC_STATS = ("decode_spec_rounds", "decode_spec_proposed",
              "decode_spec_accepted", "decode_steps", "decode_prefills",
              "cuda_graph_captures", "cuda_graph_replays")


def top2_margin(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def margin_rule(label, pairs, logits_at):
    """``pairs``: (got tokens, want tokens) per request; ``logits_at(i,
    pos)``: the reference logits of request i at position pos.  Returns
    the requests cut at a near-tie; raises on a divergence at a margin of
    MARGIN_TOL or more."""
    cut = []
    for i, (got, want) in enumerate(pairs):
        if len(got) != len(want):
            raise RuntimeError(f"{label}: request {i} gave {len(got)} "
                               f"tokens, the reference {len(want)}")
        pos = next((j for j, (a, b) in enumerate(zip(got, want))
                    if a != b), None)
        if pos is None:
            continue
        margin = top2_margin(logits_at(i, pos))
        if margin >= MARGIN_TOL:
            raise RuntimeError(f"{label}: request {i} diverges at token "
                               f"{pos} where the top-2 margin is {margin}"
                               f" >= {MARGIN_TOL}")
        cut.append({"request": i, "position": pos, "margin": margin})
    return cut


def recompute_at(eng, prompts, tokens, quantized=False):
    return lambda i, pos: eng.recompute_logits(
        prompts[i] + tokens[i][:pos], quantized=quantized)


def spec_weights(model):
    """bench.py's accurate-draft construction at the serving width: the
    draft is the target's layer 0 sharing its embeddings, final LayerNorm
    and head; the target's layers 1-7 write a small residual (``wo`` and
    ``w2`` scaled by 0.05), so the draft's proposals usually match."""
    w = model.init_weights(torch.Generator().manual_seed(0))
    for lw in w["layers"][1:]:
        lw["wo"], lw["w2"] = lw["wo"] * 0.05, lw["w2"] * 0.05
    dw = {k: w[k] for k in ("tok_emb", "pos_emb", "lm_head", "lnf_g",
                            "lnf_b")}
    dw["layers"] = [w["layers"][0]]
    return w, dw


def span_ms(spans, name):
    return [1e3 * sp.duration for sp in spans if sp.name == name]


def p50(xs):
    return float(np.median(xs)) if len(xs) else None


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def timed_window(run, stats=SPEC_STATS):
    """``run()`` with the tracer on and the kernel launch counters zeroed
    just before: its result, wall seconds, spans, launches and the deltas
    of ``stats``."""
    torch.cuda.synchronize()
    flags.set_flags({"enable_tracer": True})
    tracer.clear()
    zero_kernel_launches()
    s0 = {n: stat_get(n) for n in stats}
    t0 = time.monotonic()
    try:
        out = run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        spans = tracer.snapshot()
    finally:
        flags.set_flags({"enable_tracer": False})
    return (out, wall, spans, kernel_launches(),
            {n: stat_get(n) - s0[n] for n in stats})


def phase_spec(model):
    """Speculative decoding at the serving model's full width: 8 greedy
    requests (128-token prompts, 256 new tokens) through a ``DecodeServer``
    with 8 slots, without a draft, with the accurate 1-layer draft and
    with an independent random 1-layer draft (spec_k 3: verification is
    ``chunk_S8_R4``)."""
    dev = model.device
    # the servers below load the damped target into the shared model;
    # the later phases serve its own full-scale weights again
    own = {k: t.clone() for k, t in model.state_dict().items()}
    w, dw = spec_weights(model)
    one_layer = dict(SERVE_MODEL, num_layers=1)
    accurate = TransformerLM(**one_layer, device=dev)
    rand = TransformerLM(**one_layer, device=dev)
    rw = rand.init_weights(torch.Generator().manual_seed(5))
    rng = np.random.RandomState(14)
    prompts = [rng.randint(1, 32000, 128).tolist() for _ in range(8)]
    warm = rng.randint(1, 32000, 64).tolist()
    out, base_eng = {}, None
    for label, draft, dweights in (("baseline", None, None),
                                   ("accurate", accurate, dw),
                                   ("random", rand, rw)):
        srv = DecodeServer(model, w, DecodeConfig(
            slots=8, max_seq_len=1024, page_size=16, prefix_cache=False,
            spec_k=SPEC_K if draft is not None else 0),
            draft_model=draft, draft_weights=dweights).start()
        eng = srv.replicas[0]
        try:
            # warm-up: every step's eager run and capture (a speculative
            # request and one that opts out, for the normal step)
            ws = [srv.submit(warm, max_new_tokens=24),
                  srv.submit(warm[:40], max_new_tokens=6,
                             speculative=False)]
            for r in ws:
                r.result(timeout=600)

            def run():
                reqs = [srv.submit(p, max_new_tokens=256) for p in prompts]
                for r in reqs:
                    r.result(timeout=600)
                return reqs
            reqs, wall, spans, launches, d = timed_window(run)
            check = None
            if label == "accurate":
                # the contract on the card: every emitted token is the
                # target's argmax in the verify logits, and the streamed
                # logits agree with the recompute oracle
                cr = [srv.submit(p, max_new_tokens=64, record_logits=True)
                      for p in prompts[:2]]
                err, argmax_ok = 0.0, True
                for p, r in zip(prompts[:2], cr):
                    r.result(timeout=600)
                    for i, lg in enumerate(r.logits_trace):
                        argmax_ok &= int(np.argmax(lg)) == r.generated[i]
                    for i in (0, 31, 63):
                        want = eng.recompute_logits(p + r.generated[:i])
                        err = max(err, float(np.abs(
                            r.logits_trace[i] - want).max()))
                check = dict(logits_vs_oracle_max_abs=err,
                             emitted_are_verify_argmax=bool(argmax_ok))
                if err > LOGIT_TOL or not argmax_ok:
                    raise RuntimeError(f"spec: {check}")
        finally:
            srv.stop()
        tokens = [r.generated for r in reqs]
        n_tok = sum(len(t) for t in tokens)
        draft_layers = 1 if draft is not None else 0
        layers = model.num_layers
        want_b5 = (SPEC_K + 1) * draft_layers * d["decode_spec_rounds"] \
            + layers * d["decode_steps"]
        want_b6 = layers * d["decode_spec_rounds"] \
            + (layers + draft_layers) * d["decode_prefills"]
        got = (launches["b5"], launches["b6"])
        row = dict(tokens=n_tok, tokens_per_s=n_tok / wall, wall_s=wall,
                   rounds=d["decode_spec_rounds"],
                   normal_steps=d["decode_steps"],
                   prefills=d["decode_prefills"],
                   proposed=d["decode_spec_proposed"],
                   accepted=d["decode_spec_accepted"],
                   accept_rate=d["decode_spec_accepted"]
                   / max(d["decode_spec_proposed"], 1),
                   tokens_per_slot_round=1 + d["decode_spec_accepted"]
                   / max(d["decode_spec_proposed"] / SPEC_K, 1),
                   propose_p50_ms=p50(span_ms(spans,
                                              "serving/decode_propose")),
                   verify_p50_ms=p50(span_ms(spans,
                                             "serving/decode_verify")),
                   decode_step_p50_ms=p50(span_ms(spans,
                                                  "serving/decode_step")),
                   captures=d["cuda_graph_captures"],
                   replays=d["cuda_graph_replays"],
                   launches_b5_b6=list(got), want_b5_b6=[want_b5, want_b6],
                   graphs={k: g.graph is not None
                           for k, g in eng._graphs.items()})
        if check:
            row.update(check)
        if got != (want_b5, want_b6) or d["cuda_graph_captures"]:
            raise RuntimeError(f"spec {label}: B5/B6 launched {got}, want "
                               f"{(want_b5, want_b6)}; captures in the "
                               f"window {d['cuda_graph_captures']}")
        if draft is not None and not (d["decode_spec_rounds"] and all(
                row["graphs"].get(k) for k in ("propose", "verify"))):
            raise RuntimeError(f"spec {label}: no replayed speculative "
                               f"round: {row}")
        out[label] = (row, tokens)
        if label == "baseline":
            base_eng = eng
    base = out["baseline"][1]
    for label in ("accurate", "random"):
        out[label][0]["cut_at_near_tie"] = margin_rule(
            f"spec {label}", list(zip(out[label][1], base)),
            recompute_at(base_eng, prompts, base))
    log("spec", model="serving 8-layer", slots=8, spec_k=SPEC_K,
        prompt_tokens=128, new_tokens=256, margin_tol=MARGIN_TOL,
        **{k: v[0] for k, v in out.items()},
        speedup_accurate=out["accurate"][0]["tokens_per_s"]
        / out["baseline"][0]["tokens_per_s"],
        speedup_random=out["random"][0]["tokens_per_s"]
        / out["baseline"][0]["tokens_per_s"])
    model.load_state_dict(own)


def open_loop(submit, schedule):
    """Submit ``(prompt, new tokens, gap s)`` arrivals on their schedule;
    wait for all."""
    reqs = []
    for prompt, n_new, gap in schedule:
        time.sleep(gap)
        reqs.append(submit(prompt, max_new_tokens=n_new))
    for r in reqs:
        r.result(timeout=600)
    return reqs


def phase_ragged(model):
    """Ragged prefill packing at full width: 16 requests (prompts of
    100-600 tokens, 32 new tokens) on one seeded Poisson schedule (mean
    gap 5 ms), chunked prefill of one page (16 rows), padded
    (``ragged_prefill_rows`` 0) and packed into 64 one-row lanes.

    The padded path's pad waste is fixed by the prompts (each one's last
    chunk); the packed path's depends on how many prompts prefill at
    once, which the arrivals' timing against the engine's iterations
    decides: most runs pack 5,411 rows into 86 dispatches, some into 87
    (64 more dead lanes).  So the packed schedule runs RAGGED_RUNS times
    and the median of its waste is held below the padded waste; every
    run's waste, dispatches and tokens are reported and checked."""
    rng = np.random.RandomState(15)
    schedule = [(rng.randint(1, 32000, int(n)).tolist(), 32,
                 float(rng.exponential(0.005)))
                for n in rng.randint(100, 601, 16)]
    prompts = [p for p, _n, _g in schedule]
    stats = ("prefill_padded_tokens_total", "prefill_live_tokens_total",
             "decode_ragged_dispatches", "prefill_chunks",
             "cuda_graph_replays")
    runs, toks, eng0 = [], [], None
    for rows in (0,) + (64,) * RAGGED_RUNS:
        srv = DecodeServer(model, None, DecodeConfig(
            slots=8, max_seq_len=1024, page_size=16, prefix_cache=False,
            prefill_chunk_pages=1, ragged_prefill_rows=rows)).start()
        try:
            srv.submit(schedule[0][0][:40], max_new_tokens=4).result(
                timeout=600)
            reqs, wall, spans, launches, d = timed_window(
                lambda: open_loop(srv.submit, schedule), stats)
        finally:
            srv.stop()
        pad, live = d["prefill_padded_tokens_total"], \
            d["prefill_live_tokens_total"]
        ttft = [1e3 * (r.t_first_token - r.t_enqueue) for r in reqs]
        runs.append(dict(
            prefill_pad_waste=pad / (pad + live), padded_rows=pad,
            live_rows=live, wall_s=wall, ttft_p50_ms=p50(ttft),
            ttft_p99_ms=pct(ttft, 99), dispatches=d["prefill_chunks"],
            ragged_dispatches=d["decode_ragged_dispatches"],
            b6_launches=launches["b6"], b5_launches=launches["b5"],
            prefill_dispatch_p50_ms=p50(span_ms(
                spans, "serving/decode_prefill_ragged" if rows
                else "serving/decode_prefill_chunk"))))
        toks.append([r.generated for r in reqs])
        eng0 = eng0 or srv.replicas[0]
    padded, packed = runs[0], runs[1:]
    cut = [margin_rule(f"ragged run {i}", list(zip(t, toks[0])),
                       recompute_at(eng0, prompts, toks[0]))
           for i, t in enumerate(toks[1:])]
    waste = sorted(r["prefill_pad_waste"] for r in packed)
    median = waste[len(waste) // 2]
    log("ragged", requests=16, new_tokens=32, chunk_rows=16, lanes=64,
        mean_gap_ms=5, margin_tol=MARGIN_TOL, cut_at_near_tie=cut,
        padded=padded, ragged_64=packed[0], ragged_64_runs=packed,
        ragged_64_median_pad_waste=median,
        ragged_runs_above_padded=sum(
            w >= padded["prefill_pad_waste"] for w in waste))
    for r in packed:
        if not r["ragged_dispatches"] or \
                r["b6_launches"] != model.num_layers * r["dispatches"]:
            raise RuntimeError(f"ragged: the packed path did not run as "
                               f"counted: {r}")
    if not median < padded["prefill_pad_waste"]:
        raise RuntimeError(f"ragged packing did not lower the pad waste: "
                           f"median {median} of {waste}, padded "
                           f"{padded['prefill_pad_waste']}")


def disagg_oracle(model, kv_quant):
    """Migrated vs local, greedy and sampled: the requests' tokens and
    recorded logits, and the migration's pages, bytes and seconds."""
    from paddle_tpu_torch.observe.histogram import export_histograms
    from paddle_tpu_torch.serving import (DecodeEngine, DisaggConfig,
                                          DisaggServer)

    rng = np.random.RandomState(16)
    prompts = [rng.randint(1, 32000, n).tolist() for n in (100, 200, 333,
                                                           500)]
    cfg = DecodeConfig(slots=8, max_seq_len=1024, page_size=16,
                       prefix_cache=False, kv_quant=kv_quant)
    kws = [dict(temperature=t, seed=60 + i)
           for t in (0.0, 1.0) for i in range(len(prompts))]
    allp = prompts * 2
    s0 = {n: stat_get(n) for n in ("migrate_pages_total",
                                   "migrate_bytes_total",
                                   "migrate_device_copies_total")}
    h0 = export_histograms().get("migrate_seconds", {})
    srv = DisaggServer(model, None, config=cfg, disagg=DisaggConfig(
        prefill_replicas=1, decode_replicas=1))
    with srv:
        dreqs = [srv.submit(p, max_new_tokens=32, record_logits=True, **kw)
                 for p, kw in zip(allp, kws)]
        douts = [r.result(timeout=600) for r in dreqs]
    eng = DecodeEngine(model, None, cfg)
    with eng:
        lreqs = [eng.submit(p, max_new_tokens=32, record_logits=True, **kw)
                 for p, kw in zip(allp, kws)]
        louts = [r.result(timeout=600) for r in lreqs]
    hist = export_histograms().get("migrate_seconds", {})
    gaps, sampled_diffs = [], []
    for i, (dr, lr) in enumerate(zip(dreqs, lreqs)):
        dl = dr.decode_request.logits_trace
        first = next((j for j, (a, b) in enumerate(zip(douts[i], louts[i]))
                      if a != b), len(louts[i]))
        for j in range(min(first + 1, len(dl))):
            gaps.append(float(np.abs(dl[j] - lr.logits_trace[j]).max()))
        if first < len(louts[i]) and kws[i]["temperature"] > 0:
            sampled_diffs.append({"request": i, "position": first,
                                  "logit_gap": gaps[-1]})
    cut = margin_rule(f"disagg kv_quant={kv_quant}",
                      list(zip(douts[:4], louts[:4])),
                      lambda i, pos: lreqs[i].logits_trace[pos])
    report = dict(
        migrated_pages=stat_get("migrate_pages_total")
        - s0["migrate_pages_total"],
        migrated_bytes=stat_get("migrate_bytes_total")
        - s0["migrate_bytes_total"],
        device_copies=stat_get("migrate_device_copies_total")
        - s0["migrate_device_copies_total"],
        installs=hist.get("count", 0) - h0.get("count", 0),
        migrate_seconds_mean=(hist.get("sum", 0.0) - h0.get("sum", 0.0))
        / max(hist.get("count", 0) - h0.get("count", 0), 1),
        logits_max_abs_gap=max(gaps), tolerance=LOGIT_TOL,
        greedy_cut_at_near_tie=cut, sampled_divergences=sampled_diffs,
        sampled_equal=sum(d == l for d, l in zip(douts[4:], louts[4:])))
    if max(gaps) > LOGIT_TOL:
        raise RuntimeError(f"disagg kv_quant={kv_quant}: migrated vs local"
                           f" logits apart by {max(gaps)}: {report}")
    return report


def disagg_chaos(model):
    """A prefill replica killed mid-prefill (the fault armed before the
    requests, the victim's prefill held until the router's kill): zero
    requests dropped, the orphaned legs re-dispatched."""
    from paddle_tpu_torch.distributed.fleet.elastic import chaos
    from paddle_tpu_torch.serving import DisaggConfig, DisaggServer

    srv = DisaggServer(model, None, config=DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16, prefix_cache=False),
        disagg=DisaggConfig(prefill_replicas=2, decode_replicas=1))
    victim = srv.replicas[0]
    killed = threading.Event()
    kill, service = srv._kill_replica, victim.engine._service_prefills

    def kill_and_release(rep):
        killed.set()
        kill(rep)

    def held_prefill():
        killed.wait()
        if not victim.dead:
            service()
    srv._kill_replica = kill_and_release
    victim.engine._service_prefills = held_prefill
    d0, r0, x0 = stat_get("disagg_replica_deaths"), \
        stat_get("disagg_redispatches_total"), \
        stat_get("disagg_dropped_requests")
    rng = np.random.RandomState(17)
    chaos.clear()
    chaos.inject("kill_prefill_replica", count=1, replica=0)
    try:
        with srv:
            reqs = [srv.submit(rng.randint(1, 32000, 150).tolist(),
                               max_new_tokens=16, seed=i) for i in range(8)]
            outs = [r.result(timeout=600) for r in reqs]
    finally:
        chaos.clear()
    report = dict(requests=8, completed=sum(len(o) == 16 for o in outs),
                  dropped=stat_get("disagg_dropped_requests") - x0,
                  deaths=stat_get("disagg_replica_deaths") - d0,
                  redispatches=stat_get("disagg_redispatches_total") - r0,
                  dead=[r.dead for r in srv.replicas])
    if report["completed"] != 8 or report["deaths"] != 1 or \
            report["dropped"] or not report["redispatches"]:
        raise RuntimeError(f"disagg chaos: {report}")
    return report


def disagg_stream(model):
    """bench.py's ``bench_disagg`` leg 2 at the serving width: short chats
    (32-64-token prompts, 64 new tokens) among 900-token adversaries (8 new
    tokens) on one seeded Poisson schedule (mean gap 20 ms), through a 1 +
    1 ``DisaggServer`` and a 2-replica ``DecodeServer`` with chunked
    prefill (4 pages)."""
    from paddle_tpu_torch.serving import DisaggConfig, DisaggServer

    rng = np.random.RandomState(23)
    schedule = []
    for i in range(16):
        if i % 2 == 0:
            prompt, n_new = rng.randint(1, 32000, 900).tolist(), 8
        else:
            prompt, n_new = rng.randint(
                1, 32000, int(rng.randint(32, 65))).tolist(), 64
        schedule.append((prompt, n_new, float(rng.exponential(0.02))))

    def cfg(chunk):
        return DecodeConfig(slots=8, max_seq_len=1024, page_size=16,
                            prefix_cache=False, prefill_chunk_pages=chunk)

    def metrics(reqs):
        ttft = [1e3 * (r.t_first_token - r.t_enqueue) for r in reqs]
        tpot = []
        for (_p, n_new, _g), r in zip(schedule, reqs):
            dr = getattr(r, "decode_request", None) or r
            if n_new == 64:
                tpot.append(1e3 * (dr.t_last_token - dr.t_first_token)
                            / (len(dr.generated) - 1))
        return dict(ttft_p50_ms=p50(ttft), ttft_p99_ms=pct(ttft, 99),
                    short_tpot_p50_ms=p50(tpot),
                    short_tpot_p99_ms=pct(tpot, 99))

    out = {}
    usrv = DecodeServer(model, None, cfg(4), replicas=2).start()
    try:
        for e in usrv.replicas:
            e.generate(schedule[0][0], max_new_tokens=2)
            e.generate(schedule[1][0], max_new_tokens=4)
        reqs, wall, _s, _l, _d = timed_window(
            lambda: open_loop(usrv.submit, schedule), ())
        out["unified_2_chunked"] = dict(metrics(reqs), wall_s=wall)
    finally:
        usrv.stop()
    dsrv = DisaggServer(model, None, config=cfg(0), disagg=DisaggConfig(
        prefill_replicas=1, decode_replicas=1))
    with dsrv:
        dsrv.generate(schedule[0][0], max_new_tokens=2)
        dsrv.generate(schedule[1][0], max_new_tokens=4)
        reqs, wall, _s, _l, d = timed_window(
            lambda: open_loop(dsrv.submit, schedule),
            ("disagg_handoffs_total",))
        out["disagg_1p_1d"] = dict(metrics(reqs), wall_s=wall,
                                   handoffs=d["disagg_handoffs_total"])
    return out


def phase_disagg(model):
    report = {f"oracle_kv_quant_{q}": disagg_oracle(model, q)
              for q in (False, True)}
    report["chaos"] = disagg_chaos(model)
    report["mixed_stream"] = disagg_stream(model)
    log("disagg", model="serving 8-layer", margin_tol=MARGIN_TOL,
        note="both replicas share one card's SMs", **report)


def phase_preflight():
    from paddle_tpu_torch.distributed.fleet.elastic import preflight_device

    t0 = time.monotonic()
    v = preflight_device(attempts=1)
    log("preflight", seconds=time.monotonic() - t0, **v.to_dict())
    if not v.ok:
        raise RuntimeError(f"preflight on the card: {v}")


ONESHOT_BATCHES = (1, 2, 4, 8, 16, 32)
ONESHOT_REQUESTS, ONESHOT_CLIENTS = 256, 8


def phase_oneshot_server(model_dir):
    """The saved BERT-base + NSP model behind ``serving.Server`` on the card
    (int8 weight-quant, ``FLAGS_flash_attention=always``: B7 and B1
    float32): ``warmup`` captures one graph per batch bucket, 8 client
    threads send 256 requests of 1-4 rows (seq 128, every other row's last
    16 keys masked), every batch a replay; then the same requests one at a
    time through the bare, warmed ``Predictor``."""
    from paddle_tpu_torch import inference, serving

    rng = np.random.RandomState(18)
    feeds = [infer_feed(int(n), seed=1000 + i)
             for i, n in enumerate(rng.randint(1, 5, ONESHOT_REQUESTS))]
    flags.set_flags({"weight_quant": "int8", "flash_attention": "always"})
    try:
        cfg = inference.Config(model_dir)
        cfg.enable_tpu(0)
        srv = serving.Server(cfg, serving.ServingConfig(
            batch_sizes=ONESHOT_BATCHES, batch_window_ms=2,
            max_queue=ONESHOT_REQUESTS))
        c0 = stat_get("cuda_graph_captures")
        t0 = time.monotonic()
        n_warm = srv.warmup()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        captures = stat_get("cuda_graph_captures") - c0
        srv.start(warmup=False)
        results = [None] * len(feeds)

        def client(k):
            for i in range(k, len(feeds), ONESHOT_CLIENTS):
                results[i] = srv.infer(feeds[i])

        def run():
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(ONESHOT_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        stats = ("serving_batches", "serving_batched_rows",
                 "serving_padded_rows", "serving_batched_requests",
                 "cuda_graph_replays", "cuda_graph_captures")
        try:
            (_r, peak), wall, _s, launches, d = timed_window(
                lambda: peak_gb(run), stats)
        finally:
            srv.stop()
        pred = srv._predictor       # the bare, warmed Predictor
        pred._exe.warmup(pred._program, [infer_feed(3, seed=0)],
                         pred._fetch_targets, pred._scope)
        base, bwall, _s, _l, bd = timed_window(
            lambda: [pred.run(f) for f in feeds], stats)
    finally:
        flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
    rows = sum(f["input_ids"].shape[0] for f in feeds)
    if any(r is None for r in results):
        raise RuntimeError("oneshot_server: a request got no result")
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for got, want in zip(results, base) for a, b in zip(got, want))
    batches = d["serving_batches"]
    report = dict(
        model="bert-base encoder + nsp head, int8", seq=128,
        requests=len(feeds), rows=rows, clients=ONESHOT_CLIENTS,
        batch_buckets=list(ONESHOT_BATCHES), warmup_entries=n_warm,
        warmup_captures=captures, warmup_s=warm_s,
        server_rows_per_s=rows / wall, server_wall_s=wall,
        predictor_rows_per_s=rows / bwall, predictor_wall_s=bwall,
        batches=batches, replays=d["cuda_graph_replays"],
        captures_in_window=d["cuda_graph_captures"],
        batch_occupancy=d["serving_batched_requests"] / max(batches, 1),
        padding_fraction=d["serving_padded_rows"]
        / max(d["serving_padded_rows"] + d["serving_batched_rows"], 1),
        peak_memory_gb=peak, launches_b7_b1=[launches["b7"],
                                             launches["b1"]],
        want_b7_b1=[B7_PER_RUN * batches, B1_PER_RUN * batches],
        predictor_replays=bd["cuda_graph_replays"],
        outputs_vs_predictor_max_abs=err, tolerance=INFER_ORACLE_TOL)
    log("oneshot_server", **report)
    if d["cuda_graph_replays"] != batches or d["cuda_graph_captures"] or \
            [launches["b7"], launches["b1"]] != report["want_b7_b1"] or \
            captures != len(ONESHOT_BATCHES) or err > INFER_ORACLE_TOL:
        raise RuntimeError(f"oneshot_server: {report}")


def release(phase):
    """Drop a phase's executors and graphs (their ``close()`` ran, or
    they went with the phase's objects) and give the cached blocks back;
    log the phase's peak and what stays allocated."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("release", after=phase, peak_memory_gb_since_last_release=peak,
        allocated_gb=torch.cuda.memory_allocated() / 1e9,
        reserved_gb=torch.cuda.memory_reserved() / 1e9)
    torch.cuda.reset_peak_memory_stats()


# Dropout under capture: elements of the checked tensor, and its rate.
DROPOUT_N, DROPOUT_P = 1 << 22, 0.1


def phase_dropout():
    """A dropout program through ``Executor.run`` on the card: the
    warm-up, the capture and its replay, then two more replays.  The
    program's generator is registered with the graph, so every replay
    draws a fresh mask: the last two replays' masks differ, and each
    keeps a share of the elements within 3 sigma of 1 - p."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program

    main, startup = Program(), Program()
    main.random_seed = 3
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [DROPOUT_N], append_batch_size=False)
        y = layers.dropout(x, DROPOUT_P,
                           dropout_implementation="upscale_in_train")
    exe = pt.Executor()
    scope = pt.framework.Scope()
    feed = {"x": np.ones(DROPOUT_N, "float32")}
    replays = stat_get("cuda_graph_replays")
    masks = [exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                     return_numpy=False)[0] != 0 for _ in range(5)]
    replays = stat_get("cuda_graph_replays") - replays
    kept = [float(m.float().mean()) for m in masks]
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / DROPOUT_N)
    differ = bool((masks[-1] != masks[-2]).any())
    log("dropout", elements=DROPOUT_N, p=DROPOUT_P, replays=replays,
        kept_share=kept, three_sigma=3 * sigma, last_replays_differ=differ,
        capture_reason=executor_mod.capture_reason(main))
    exe.close()
    if replays != 4 or not differ or \
            any(abs(k - (1 - DROPOUT_P)) > 3 * sigma for k in kept[1:]):
        raise RuntimeError(f"dropout under capture: {replays} replays, "
                           f"kept shares {kept} (3 sigma {3 * sigma}), "
                           f"last two masks differ: {differ}")


# ---- slice 15: the pipelined window, checkpoints, the NaN scan, pruning --

# pipelined: steps a mode, and the slow feed's host seconds a batch and its
# steps a mode; ckpt_resume: the run's length, its save steps and the crash
# (short: the script runs near its time limit, and the phase checks the
# saves, the crash and the resume, not the steps between them)
CKPT_WINDOW_STEPS, SLOW_FEED_S, SLOW_FEED_STEPS = 30, 0.040, 20
CKPT_STEPS, CKPT_EVERY, CKPT_CRASH = 100, 25, 75
CKPT_AFTER_SAVE = 5            # steps timed after each save
NAN_STEPS, PRUNE_STEPS, PRUNE_RTOL = 10, 5, 1e-6
ACP_EPOCHS, ACP_STEPS = 2, 10  # auto_checkpoint: epochs of steps
BERT15 = {}                    # the slice's BERT-base program, built once
# model_checkpoint: MobileNetV2 through Model.fit, epochs of batches
MC_EPOCHS, MC_BATCHES = 2, 4


def bert15():
    """The fused bf16 BERT-base training program of phase 7, with four
    feeds that the slice's phases cycle through by step."""
    if not BERT15:
        flags.set_flags({"flash_attention": "always"})
        main, startup, loss = build_bert(TRAIN_BATCH, amp=True, dropout=0.1)
        BERT15.update(main=main, startup=startup, loss=loss,
                      feeds=[bert_feed(TRAIN_BATCH, seed=s) for s in range(4)])
    return BERT15


def bert15_scope(exe):
    """A scope after the startup program, on the card."""
    scope = pt.framework.Scope()
    exe.run(bert15()["startup"], scope=scope)
    return scope


def bert15_steps(exe, scope, first, last, window, handles=None, sleep=0.0,
                 save=None):
    """Steps ``first``..``last`` (1-based; step k reads feed k % 4) at
    ``window``: (losses, ms between dispatch returns).  ``save(k)`` runs
    after step k when given."""
    b = bert15()
    flags.set_flags({"max_inflight_steps": window})
    handles = [] if handles is None else handles
    ms, t_prev = [], time.perf_counter()
    for k in range(first, last + 1):
        if sleep:
            time.sleep(sleep)      # a loader's host time for the batch
        out = exe.run(b["main"], feed=b["feeds"][k % 4],
                      fetch_list=[b["loss"]], scope=scope)
        if window == 0:
            float(out[0].ravel()[0])
        handles.append(out)
        if save is not None:
            save(k)
        t = time.perf_counter()
        ms.append((t - t_prev) * 1e3)
        t_prev = t
    exe.drain()
    flags.set_flags({"max_inflight_steps": 2})
    return [float(h[0].ravel()[0]) for h in handles], ms


def device_state(scope):
    """Device copies of a scope's tensors and its generator's state."""
    return {n: (v.clone() if isinstance(v, torch.Tensor) else
                v.get_state().clone() if isinstance(v, torch.Generator)
                else None) for n, v in scope._vars.items()}


def state_diff(a, b):
    """Names whose values differ bit for bit (or are missing)."""
    return sorted(n for n in set(a) | set(b)
                  if n not in a or n not in b or (a[n] is None) !=
                  (b[n] is None) or (a[n] is not None and not torch.equal(
                      a[n], b[n].to(a[n].device))))


def check_replays_and_b1(label, fn, steps):
    """``fn()`` with the replay and B1 counters read around it: every
    step a replay, 24 B1 launches a step."""
    replays = stat_get("cuda_graph_replays")
    fab.reset_launch_count()
    out = fn()
    got = (stat_get("cuda_graph_replays") - replays,
           fab.flash_attention_bias.launches)
    if got != (steps, B1_PER_STEP * steps):
        raise RuntimeError(f"{label}: {got[0]} replays and {got[1]} B1 "
                           f"launches in {steps} steps, want {steps} and "
                           f"{B1_PER_STEP * steps}")
    return out


def phase_pipelined():
    """One startup state, copied with ``snapshot_scope``/``restore_scope``:
    CKPT_WINDOW_STEPS steps at ``max_inflight_steps`` 0, then at 2, every
    step a replay launching B1 24 times; losses and the final state
    (parameters, AdamW moments, the generator) bit-equal.  Then both with
    a feed that spends SLOW_FEED_S of host time a batch."""
    from paddle_tpu_torch.ckpt import restore_scope, snapshot_scope
    from paddle_tpu_torch.monitor import stat_set
    from paddle_tpu_torch.observe.histogram import histogram

    b = bert15()
    exe = pt.Executor()
    scope = bert15_scope(exe)
    t0 = time.perf_counter()
    start = snapshot_scope(scope)
    snapshot_s = time.perf_counter() - t0
    exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
    runs = {}
    for window in (0, 2):
        restore_scope(scope, start)
        histogram("fetch_sync_seconds").reset()
        stat_set("executor_inflight_steps_max", 0)
        losses, ms = check_replays_and_b1(
            f"pipelined window {window}",
            lambda w=window: bert15_steps(exe, scope, 1, CKPT_WINDOW_STEPS,
                                          w), CKPT_WINDOW_STEPS)
        runs[window] = dict(losses=losses, ms=ms, state=device_state(scope),
                            sync=histogram("fetch_sync_seconds").summary(),
                            inflight_max=stat_get(
                                "executor_inflight_steps_max"))
    diff = state_diff(runs[0]["state"], runs[2]["state"])
    slow = {}
    for window in (0, 2):
        restore_scope(scope, start)
        _l, ms = bert15_steps(exe, scope, 1, SLOW_FEED_STEPS, window,
                              sleep=SLOW_FEED_S)
        slow[window] = float(np.median(ms[2:]))
    report = dict(
        steps=CKPT_WINDOW_STEPS, state_vars=len(start),
        state_bytes=sum(v.numel() * v.element_size() for v in start.values()
                        if isinstance(v, torch.Tensor)),
        snapshot_s=snapshot_s, state_diff=diff[:5],
        losses_equal=runs[0]["losses"] == runs[2]["losses"],
        losses=runs[2]["losses"][:5],
        slow_feed_s=SLOW_FEED_S, slow_feed_steps=SLOW_FEED_STEPS,
        slow_feed_ms_a_step_window0=slow[0],
        slow_feed_ms_a_step_window2=slow[2])
    for window in (0, 2):
        r = runs[window]
        report[f"window{window}"] = dict(
            step_ms_p50=float(np.median(r["ms"][2:])),
            fetch_sync_seconds=r["sync"], inflight_max=r["inflight_max"])
    log("pipelined", **report)
    if diff or not report["losses_equal"] or runs[2]["inflight_max"] != 2:
        raise RuntimeError(f"pipelined: window 0 and 2 differ: {report}")
    exe.close()


def phase_ckpt_resume():
    """CKPT_STEPS pipelined steps saving asynchronously every CKPT_EVERY
    through ``CheckpointManager(keep_n=2)``; a second run whose commit of
    step CKPT_CRASH crashes; a fresh Executor and Scope restore the newest
    intact step (CKPT_CRASH - CKPT_EVERY) and run to CKPT_STEPS, bit-equal
    to the first run in losses and final state; then a corrupt shard falls back to the step before it, and a
    bfloat16 var round-trips without ``ml_dtypes``."""
    import shutil

    from paddle_tpu_torch.ckpt import CheckpointError, CheckpointManager

    b = bert15()
    root = tempfile.mkdtemp(prefix="ckpt_resume_")
    try:
        stat_reset("ckpt_saves_coalesced")
        exe = pt.Executor()
        scope = bert15_scope(exe)
        exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
        m = CheckpointManager(os.path.join(root, "full"), keep_n=2,
                              async_save=True)
        saves = lambda k: k % CKPT_EVERY == 0 and m.save(  # noqa: E731
            k, scope=scope)
        full, ms = check_replays_and_b1(
            "ckpt_resume", lambda: bert15_steps(
                exe, scope, 1, CKPT_STEPS, 2, save=saves), CKPT_STEPS)
        m.wait()
        final = device_state(scope)
        p50 = float(np.median(ms))
        after = {s["step"]: float(np.median(
            ms[s["step"]:s["step"] + CKPT_AFTER_SAVE]))
            for s in m.stats if s["step"] < CKPT_STEPS}
        stats, kept = m.stats, m.all_steps()
        m.close()
        exe.close()
        del scope

        crash_dir = os.path.join(root, "crash")
        exe = pt.Executor()
        scope = bert15_scope(exe)
        exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
        m = CheckpointManager(crash_dir, keep_n=2, async_save=True)

        def crash(phase, step):
            if phase == "pre_commit" and step == CKPT_CRASH:
                raise RuntimeError("injected crash in the commit")

        m.set_fault_hook(crash)

        def save_and_commit(k):
            if k % CKPT_EVERY == 0:
                m.save(k, scope=scope)
                if k < CKPT_CRASH:
                    m.wait()    # the steps before the crash are on disk

        bert15_steps(exe, scope, 1, CKPT_CRASH, 2, save=save_and_commit)
        try:
            m.wait()
            raise RuntimeError("the injected crash did not fail the save")
        except CheckpointError:
            pass
        m.close()
        exe.close()
        del scope
        torn = sorted(os.listdir(crash_dir))
        probe = CheckpointManager(crash_dir)
        intact = probe.latest_intact_step()

        exe = pt.Executor()
        scope = pt.framework.Scope()
        t0 = time.perf_counter()
        meta = probe.restore(scope=scope)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
        resumed, _ms = check_replays_and_b1(
            "ckpt_resume (resumed)", lambda: bert15_steps(
                exe, scope, meta["step"] + 1, CKPT_STEPS, 2),
            CKPT_STEPS - meta["step"])
        diff = state_diff(final, device_state(scope))
        exe.close()

        # a corrupt byte in the newest committed shard falls back
        newest = probe.all_steps()[-1]
        shard = os.path.join(crash_dir, f"step_{newest}", "shard_r0.npz")
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        fallbacks = stat_get("ckpt_restore_fallbacks")
        fell = probe.restore(scope=pt.framework.Scope())["step"]
        fallbacks = stat_get("ckpt_restore_fallbacks") - fallbacks
        probe.close()

        # bfloat16 through the manager with ml_dtypes out of the picture
        bf = pt.framework.Scope()
        bf.set_var("halfp", torch.randn(1024, 768, device="cuda").to(
            torch.bfloat16))
        bm = CheckpointManager(os.path.join(root, "bf16"), async_save=True)
        bm.save(0, scope=bf, wait=True)
        back = pt.framework.Scope()
        bm.restore(scope=back)
        bm.close()
        bf16_equal = torch.equal(back.get_var("halfp"), bf.get_var("halfp"))
        no_ml_dtypes = "ml_dtypes" not in sys.modules
        usage = shutil.disk_usage(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = [{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in s.items()} for s in stats]
    report = dict(
        steps=CKPT_STEPS, every=CKPT_EVERY, keep_n=2, saves=rows,
        kept=kept, saves_coalesced=stat_get("ckpt_saves_coalesced"),
        step_ms_p50=p50, step_ms_p50_after_save=after,
        crash_at=CKPT_CRASH, crash_dir=torn, latest_intact=intact,
        restore_s=restore_s, resumed_from=meta["step"],
        resumed_losses_equal=resumed == full[meta["step"]:],
        state_diff=diff[:5], corrupt_fell_back_to=fell,
        restore_fallbacks=fallbacks, bf16_bit_equal=bf16_equal,
        ml_dtypes_imported=not no_ml_dtypes,
        disk_free_gb=usage.free / 1e9)
    log("ckpt_resume", **report)
    want_torn = f"step_{CKPT_CRASH}.tmp"
    if intact != CKPT_CRASH - CKPT_EVERY or want_torn not in torn or \
            f"step_{CKPT_CRASH}" in torn or meta["step"] != intact or \
            not report["resumed_losses_equal"] or diff or \
            fell != newest - CKPT_EVERY or fallbacks < 1 or \
            not bf16_equal or not no_ml_dtypes:
        raise RuntimeError(f"ckpt_resume: {report}")


def phase_nan_scan():
    """``FLAGS_check_nan_inf=1``: the BERT step is still captured (every
    timed step a replay); step p50 with and without the scan; then one
    attention weight set to inf makes the next run raise naming the first
    op that reads it and its build site, and ``snapshot_scope`` refuses
    the scope after it."""
    from paddle_tpu_torch.ckpt import CheckpointError, snapshot_scope

    b = bert15()
    exe = pt.Executor()
    scope = bert15_scope(exe)
    feed = b["feeds"][0]
    ms = {}
    try:
        for scan in (False, True):
            flags.set_flags({"check_nan_inf": scan, "max_inflight_steps": 0})
            exe.warmup(b["main"], [feed], [b["loss"]], scope)
            ms[scan] = check_replays_and_b1(
                f"nan_scan {scan}", lambda: synced_ms(lambda: exe.run(
                    b["main"], feed=feed, fetch_list=[b["loss"]],
                    scope=scope), NAN_STEPS), NAN_STEPS)
        entry = next(e for e in exe._cache.values() if e.nan_scan)
        flags.set_flags({"max_inflight_steps": 2})
        # the compiled block: the pass pipeline's rewrite of the program
        prog = exe._apply_graph_passes(
            b["main"], (b["loss"].name,), executor_mod._feed_tensors(
                b["main"].global_block, feed, exe.device), scope)
        ops = [op for op in prog.global_block.ops
               if op.type not in executor_mod.PSEUDO_OPS]
        weight = next(p.name for p in b["main"].all_parameters()
                      if p.name.endswith("_attn_q.w_0"))
        first = next(i for i, op in enumerate(ops)
                     if weight in op.input_arg_names())
        w = scope.get_var(weight)
        scope.set_var(weight, torch.full_like(w, float("inf")))
        try:
            exe.run(b["main"], feed=feed, fetch_list=[b["loss"]],
                    scope=scope)
            raise RuntimeError("nan_scan: an inf weight did not raise")
        except RuntimeError as e:
            msg = str(e)
        try:
            snapshot_scope(scope)
            refused = False
        except CheckpointError:
            refused = True
    finally:
        flags.set_flags({"check_nan_inf": False, "max_inflight_steps": 2})
    want = f"op {ops[first].type!r} (built at {ops[first].callstack[-1]})"
    report = dict(steps=NAN_STEPS, scanned_outputs=len(entry.nan_ops),
                  step_ms_p50_without=float(np.median(ms[False])),
                  step_ms_p50_with=float(np.median(ms[True])),
                  step_ms_with=ms[True], weight=weight, message=msg,
                  expected=want, snapshot_refused=refused)
    log("nan_scan", **report)
    exe.close()
    if want not in msg or f"op #{first} " not in msg or not refused:
        raise RuntimeError(f"nan_scan: {report}")


def phase_prune():
    """``run(main, fetch_list=[loss], use_prune=True)`` on the training
    program leaves every parameter and AdamW moment bit-unchanged; its
    loss equals an unpruned run's from the same state (the generator's
    included) within PRUNE_RTOL; the pruned step's ms."""
    b = bert15()
    exe = pt.Executor()
    scope = bert15_scope(exe)
    feed = b["feeds"][1]
    exe.warmup(b["main"], [feed], [b["loss"]], scope)
    before = device_state(scope)
    gen = scope.get_var(executor_mod.RNG_VAR)
    prune = lambda: exe.run(b["main"], feed=feed,  # noqa: E731
                            fetch_list=[b["loss"]], scope=scope,
                            use_prune=True)
    prune(), prune()                     # the pruned key's warm-up, capture
    ms = synced_ms(prune, PRUNE_STEPS)
    changed = [n for n in state_diff(before, device_state(scope))
               if n != executor_mod.RNG_VAR]
    gen.set_state(before[executor_mod.RNG_VAR])
    pruned = float(prune()[0].ravel()[0])
    gen.set_state(before[executor_mod.RNG_VAR])
    whole = float(exe.run(b["main"], feed=feed, fetch_list=[b["loss"]],
                          scope=scope)[0].ravel()[0])
    rel = abs(pruned - whole) / abs(whole)
    kept = len(exe._pruned(b["main"], (b["loss"].name,)).global_block.ops)
    report = dict(ops=len(b["main"].global_block.ops), pruned_ops=kept,
                  state_changed=changed, loss_pruned=pruned,
                  loss_unpruned=whole, rel_gap=rel, tolerance=PRUNE_RTOL,
                  step_ms_p50_pruned=float(np.median(ms)), step_ms=ms)
    log("prune", **report)
    exe.close()
    if changed or not rel <= PRUNE_RTOL:
        raise RuntimeError(f"prune: {report}")


def phase_auto_checkpoint():
    """``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT`` with a local
    checkpoint path and ``configure(every_n_steps=ACP_STEPS)``:
    ``train_epoch_range("bert", 3)`` of ACP_STEPS steps an epoch stops
    after epoch 1; a fresh executor and scope resume (the executor's hook
    restores before the first fed run), skip epoch 0, and their next
    epoch is bit-equal to the first run's continuation."""
    import shutil

    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp

    b = bert15()
    root = tempfile.mkdtemp(prefix="auto_ckpt_")
    env = {"PADDLE_RUNNING_ENV": "PADDLE_EDL_AUTO_CHECKPOINT",
           "PADDLE_EDL_HDFS_CHECKPOINT_PATH": root}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    runs = {}
    try:
        for run in ("first", "second"):
            acp.configure(root, every_n_steps=ACP_STEPS, async_save=True)
            exe = pt.Executor()
            scope = bert15_scope(exe)
            exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
            epochs, losses = [], []
            for epoch in acp.train_epoch_range("bert", ACP_EPOCHS):
                epochs.append(epoch)
                losses.append(bert15_steps(exe, scope, 1, ACP_STEPS, 2)[0])
                if run == "first" and epoch == 1:
                    break       # the takeover after epoch 1
            step = acp._cfg.step
            acp.wait()
            acp.disable()
            if run == "first":
                # the first run's continuation from its last checkpoint
                os.environ.pop("PADDLE_RUNNING_ENV")
                losses.append(bert15_steps(exe, scope, 1, ACP_STEPS, 2)[0])
                os.environ.update(env)
            runs[run] = dict(epochs=epochs, losses=losses, step=step,
                             saved=sorted(os.listdir(
                                 os.path.join(root, "auto_ckpt"))))
            exe.close()
    finally:
        acp.disable()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    first, second = runs["first"], runs["second"]
    report = dict(epochs_first=first["epochs"], epochs_second=second["epochs"],
                  steps_first=first["step"], steps_second=second["step"],
                  saved=second["saved"],
                  resumed_epoch_bit_equal=second["losses"][0] ==
                  first["losses"][-1], losses=second["losses"][0][:3])
    log("auto_checkpoint", **report)
    if first["epochs"] != [0, 1] or second["epochs"] != [1] or \
            not report["resumed_epoch_bit_equal"]:
        raise RuntimeError(f"auto_checkpoint: {report}")


def phase_model_checkpoint():
    """MobileNetV2 through ``Model.fit`` in dygraph, MC_EPOCHS epochs of
    MC_BATCHES batches (FakeData, 0 workers, batch HAPI_BATCH), with
    ``ModelCheckpoint(keep_n=1, async_save=True)``; ``restore_latest``
    into a fresh ``Model`` predicts bit-equal on one batch, and only the
    newest epoch's step directory survives."""
    import shutil

    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint

    train_ds, eval_ds = hapi_datasets()
    root = tempfile.mkdtemp(prefix="model_ckpt_")
    try:
        loader = io.DataLoader(io.Subset(train_ds, range(
            HAPI_BATCH * MC_BATCHES)), batch_size=HAPI_BATCH, shuffle=True,
            drop_last=True, num_workers=0)
        model = hapi_model(False, MC_EPOCHS * MC_BATCHES)
        cb = ModelCheckpoint(save_dir=root, keep_n=1, async_save=True)
        t0 = time.monotonic()
        model.fit(loader, epochs=MC_EPOCHS, verbose=0, callbacks=[cb])
        fit_s = time.monotonic() - t0
        x = np.stack([eval_ds[i][0][:, :HAPI_IMAGE, :HAPI_IMAGE]
                      for i in range(8)]).astype("float32")
        want = model.predict_batch([x])[0]
        fresh = hapi_model(False, MC_EPOCHS * MC_BATCHES)
        epoch = cb.restore_latest(fresh)
        got = fresh.predict_batch([x])[0]
        kept = sorted(e for e in os.listdir(root) if e.startswith("step_"))
        stats = cb._manager.stats
        cb._manager.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report = dict(epochs=MC_EPOCHS, batches=MC_BATCHES, batch=HAPI_BATCH,
                  fit_s=fit_s, restored_epoch=epoch, kept=kept,
                  saves=[{k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in s.items()} for s in stats],
                  predictions_bit_equal=bool(np.array_equal(want, got)))
    log("model_checkpoint", **report)
    if epoch != MC_EPOCHS - 1 or kept != [f"step_{MC_EPOCHS - 1}"] or \
            not report["predictions_bit_equal"]:
        raise RuntimeError(f"model_checkpoint: {report}")



# ---- slice 16: fleet at one process, BASELINE config 5 (ERNIE-1.0) -------

# ERNIE 1.0's published widths (ernie_config.json of PaddlePaddle/ERNIE),
# the finetune's batch, sequence, dropout and AdamW settings
ERNIE = dict(batch=32, seq=128, vocab=18000, hidden=768, layers=12, heads=12,
             ffn=3072, max_pos=513, type_vocab=2, dropout=0.1, lr=5e-5,
             weight_decay=0.01)
ERNIE_STEPS, ERNIE_GM_STEPS, ERNIE_GM_K = 30, 8, 4
ERNIE_TRAJ_RTOL = 1e-3   # amp-only vs amp + recompute when not bit-equal
# step 1's loss, card against CPU, both in bf16 AMP: each side rounds
# ~100 bfloat16 values on the path to the loss (8-bit mantissas), in its
# own summation orders
ERNIE_ORACLE_RTOL = 1e-2
ERNIE_ORACLE_BATCH = 8   # the oracle's batch: its CPU step is the cost
B1_PER_RECOMPUTE_STEP = 36   # forward, recomputed forward, gradient replay
ERNIE_STATE = {}   # ernie_fleet's initial state and recompute run


def ernie_program(amp=True, recompute=True, gradient_merge=0,
                  dropout=ERNIE["dropout"], scan_layers=0, policy="",
                  batch=ERNIE["batch"]):
    """The finetune through ``fleet`` at ``batch``: main, startup, loss
    and the applied chain's class names.  ``scan_layers`` / ``policy``
    join recompute's configs (the scan-over-layers stamps)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import chain_names
    from paddle_tpu_torch.optimizer import AdamWOptimizer
    from paddle_tpu_torch.text.static_models import _dense, bert_encoder

    c = ERNIE
    b, s, h = batch, c["seq"], c["hidden"]
    main, startup = pt.framework.Program(), pt.framework.Program()
    main.random_seed = 7
    with unique_name.guard(), program_guard(main, startup):
        def data(name, shape, dtype="int64"):
            return layers.data(name, shape, dtype=dtype,
                               append_batch_size=False)
        seq_out = bert_encoder(
            data("src_ids", [b, s]), data("sent_ids", [b, s]),
            data("pos_ids", [b, s]),
            data("input_mask", [b, 1, 1, s], "float32"),
            vocab_size=c["vocab"], hidden=h, n_layers=c["layers"],
            n_heads=c["heads"], ffn_size=c["ffn"], max_pos=c["max_pos"],
            type_vocab=c["type_vocab"], dropout_prob=dropout,
            use_fused_attention=True)
        cls = layers.reshape(layers.slice(seq_out, axes=[1], starts=[0],
                                          ends=[1]), [0, h])
        pooled = _dense(cls, h, act="tanh", name="pooled_fc")
        if dropout:
            pooled = layers.dropout(pooled, dropout, name="cls_drop")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            _dense(pooled, 2, name="cls_out"), data("labels", [b, 1])))
        ckpts = [op.outputs["Y"][0] for op in main.global_block.ops
                 if op.type == "layer_norm"
                 and "_ln2" in op.outputs["Y"][0]]
        strategy = fleet.DistributedStrategy()
        strategy.amp = amp
        if recompute:
            strategy.recompute = True
            rc = {"checkpoints": ckpts}
            if scan_layers:
                rc["scan_layers"] = scan_layers
            if policy:
                rc["policy"] = policy
            strategy.recompute_configs = rc
        if gradient_merge:
            strategy.gradient_merge = True
            strategy.gradient_merge_configs = {"k_steps": gradient_merge,
                                               "avg": True}
        fleet.init(is_collective=True, strategy=strategy)
        fleet.distributed_optimizer(AdamWOptimizer(
            learning_rate=c["lr"], weight_decay=c["weight_decay"]))
        fleet.minimize(loss)
    chain = chain_names(fleet._fleet_singleton.applied_chain)
    return dict(main=main, startup=startup, loss=loss, chain=chain)


def ernie_feed(seed=0, batch=ERNIE["batch"]):
    """Token ids over the vocabulary, two segments, every other sequence
    with its last 32 keys padded, labels from the ids."""
    c = ERNIE
    b, s = batch, c["seq"]
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, c["vocab"], (b, s)).astype("int64")
    sent = np.zeros((b, s), "int64")
    sent[:, s // 2:] = 1
    mask = np.zeros((b, 1, 1, s), "float32")
    mask[::2, :, :, s - 32:] = -1e4
    return {"src_ids": ids, "sent_ids": sent,
            "pos_ids": np.tile(np.arange(s, dtype="int64"), (b, 1)),
            "input_mask": mask,
            "labels": (ids[:, :4].sum(1, keepdims=True) % 2).astype("int64")}


def ernie_op_counts(main):
    ops = main.global_block.ops
    return {"ops": len(ops),
            "cast": sum(op.type == "cast" for op in ops),
            "recompute_barrier": sum(op.type == "recompute_barrier"
                                     for op in ops),
            "re_emitted_forward": sum(
                any(n.endswith("@RECOMPUTE") for n in op.output_arg_names())
                for op in ops),
            "fused_multihead_attention": sum(
                op.type == "fused_multihead_attention" for op in ops)}


def graph_pools_gb():
    """The memory the allocator holds in CUDA graphs' private pools (the
    segments of every pool but the default one), in GB."""
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()[
        "segments"] if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
    ) / 1e9


def ernie_train(prog, init, feed, steps, b1_per_step, label, eager=True):
    """``steps`` steps of ``prog`` from the host state ``init``: the
    eager warm-up and the capture (peak memory over both, and the graph
    pools' size after the capture), then replays with B1's launches
    counted; the eager block's p50 beside unless ``eager`` is off."""
    main, loss = prog["main"], prog["loss"]
    exe = pt.Executor()
    scope = pt.framework.Scope()
    for n, v in init.items():
        scope.set_var(n, v.to(exe.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    captures = stat_get("cuda_graph_captures")
    t0 = time.perf_counter()
    second = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    pool = graph_pools_gb()
    if stat_get("cuda_graph_captures") != captures + 1:
        raise RuntimeError(f"{label}: the second run did not capture")
    losses = [float(first.ravel()[0]), float(second.ravel()[0])]
    replays = stat_get("cuda_graph_replays")
    fab.reset_launch_count()    # this path's count starts here
    step_ms = []
    for _ in range(steps - 2):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        losses.append(float(out.ravel()[0]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fab.flash_attention_bias.launches
    replays = stat_get("cuda_graph_replays") - replays
    if replays != steps - 2:
        raise RuntimeError(f"{label}: {replays} replays in {steps - 2} "
                           f"steps")
    if launches != b1_per_step * (steps - 2):
        raise RuntimeError(f"{label}: B1 launched {launches} times in "
                           f"{steps - 2} steps, want {b1_per_step} a step")
    graph = eager_vs_captured(label, exe, main, feed, [loss], scope,
                              EAGER_STEPS, ORACLE_RTOL, True, step_ms,
                              peak) if eager else {}
    exe.close()
    return dict(losses=losses, step_ms_p50=float(np.median(step_ms)),
                step_ms=step_ms, warm_ms=warm_ms, capture_ms=capture_ms,
                peak_memory_gb=peak, peak_memory_gb_eager_warmup=eager_peak,
                graph_pool_gb=pool, b1_launches=launches,
                b1_launches_per_step=launches / (steps - 2),
                replays=replays, **graph), launches


def phase_ernie_fleet():
    flags.set_flags({"flash_attention": "always"})
    feed = ernie_feed()
    t0 = time.monotonic()
    prog = ernie_program(amp=True, recompute=True)
    build_s = time.monotonic() - t0
    counts = ernie_op_counts(prog["main"])
    if not counts["cast"] or not counts["recompute_barrier"]:
        raise RuntimeError(f"ernie_fleet: the chain {prog['chain']} lacks "
                           f"the amp or the recompute rewrite: {counts}")
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(prog["startup"], scope=scope)
    init = {n: v.detach().cpu() for n, v in scope._vars.items()
            if isinstance(v, torch.Tensor)}
    exe.close()
    del exe, scope
    release("ernie_startup")
    rc, launches = ernie_train(prog, init, feed, ERNIE_STEPS,
                               B1_PER_RECOMPUTE_STEP, "ernie_fleet")
    # what layer_scan_recompute starts from and is held to
    ERNIE_STATE.update(init=init, recompute=rc)
    rc_chain = prog["chain"]
    del prog
    release("ernie_recompute")
    amp_prog = ernie_program(amp=True, recompute=False)
    amp_counts = ernie_op_counts(amp_prog["main"])
    amp, _ = ernie_train(amp_prog, init, feed, ERNIE_STEPS, B1_PER_STEP,
                         "ernie_amp_only")
    chain = amp_prog["chain"]
    del amp_prog
    a, b = rc["losses"], amp["losses"]
    bit_equal = a == b
    first_apart = next((i + 1 for i, (x, y) in enumerate(zip(a, b))
                        if x != y), None)
    gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    log("ernie_fleet", model="ernie-1.0 finetune", **{
        k: v for k, v in ERNIE.items()}, ffn_act="gelu",
        steps=ERNIE_STEPS, build_s=build_s,
        recompute=dict(chain=rc_chain, **rc),
        amp_only=dict(chain=chain, **amp), op_counts=counts,
        op_counts_amp_only=amp_counts, trajectories_bit_equal=bit_equal,
        first_step_apart=first_apart, max_rel_gap=gap,
        tolerance=ERNIE_TRAJ_RTOL,
        peak_fall_gb=amp["peak_memory_gb"] - rc["peak_memory_gb"])
    for label, r in (("recompute", rc), ("amp_only", amp)):
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"ernie_fleet {label}: a loss is not "
                               f"finite: {losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"ernie_fleet {label}: the loss did not "
                               f"fall on the repeated batch: {losses}")
    if not rc["peak_memory_gb"] < amp["peak_memory_gb"]:
        raise RuntimeError(f"ernie_fleet: recompute's peak "
                           f"{rc['peak_memory_gb']} GB is not below "
                           f"amp-only's {amp['peak_memory_gb']} GB")
    if not (bit_equal or gap <= ERNIE_TRAJ_RTOL):
        raise RuntimeError(f"ernie_fleet: amp + recompute and amp-only "
                           f"part by {gap} > {ERNIE_TRAJ_RTOL} (first "
                           f"at step {first_apart})")
    return launches


def phase_ernie_gm():
    """amp + gradient merge (k 4): 8 steps captured, 8 through the eager
    block, from one startup."""
    flags.set_flags({"flash_attention": "always"})
    feeds = [ernie_feed(seed=s) for s in range(4)]
    prog = ernie_program(amp=True, recompute=False,
                         gradient_merge=ERNIE_GM_K)
    main, loss = prog["main"], prog["loss"]
    params = [p.name for p in main.all_parameters()]
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(prog["startup"], scope=scope)
    init = {n: v.clone() for n, v in scope._vars.items()
            if isinstance(v, torch.Tensor)}
    del scope
    runs = {}
    for mode in ("captured", "eager"):
        exe._captures = mode == "captured"
        sc = pt.framework.Scope()
        for n, v in init.items():
            sc.set_var(n, v.clone())
        replays = stat_get("cuda_graph_replays")
        losses, states, frozen_ok = [], [], True
        prev = {n: sc.get_var(n).clone() for n in params}
        for k in range(ERNIE_GM_STEPS):
            out = exe.run(main, feed=feeds[k % 4], fetch_list=[loss],
                          scope=sc)[0]
            losses.append(float(out.ravel()[0]))
            now = {n: sc.get_var(n).clone() for n in params}
            update = (k + 1) % ERNIE_GM_K == 0
            same = all(torch.equal(now[n], prev[n]) for n in params)
            frozen_ok &= same != update
            states.append(now)
            prev = now
        runs[mode] = dict(losses=losses, states=states, frozen_ok=frozen_ok,
                          replays=stat_get("cuda_graph_replays") - replays)
        exe.drain()
    exe.close()
    cap, eag = runs["captured"], runs["eager"]
    apart = [k + 1 for k in range(ERNIE_GM_STEPS)
             if not all(torch.equal(cap["states"][k][n],
                                    eag["states"][k][n]) for n in params)]
    log("ernie_gm", k_steps=ERNIE_GM_K, steps=ERNIE_GM_STEPS,
        chain=prog["chain"], params=len(params),
        losses_captured=cap["losses"], losses_eager=eag["losses"],
        replays_captured=cap["replays"], replays_eager=eag["replays"],
        frozen_between_updates=[cap["frozen_ok"], eag["frozen_ok"]],
        steps_apart=apart)
    if not (cap["frozen_ok"] and eag["frozen_ok"]):
        raise RuntimeError("ernie_gm: parameters moved on a step that does "
                           "not update, or stayed on one that does")
    if apart or cap["losses"] != eag["losses"]:
        raise RuntimeError(f"ernie_gm: captured and eager part at steps "
                           f"{apart}: {cap['losses']} vs {eag['losses']}")
    if cap["replays"] != ERNIE_GM_STEPS - 1 or eag["replays"]:
        raise RuntimeError(f"ernie_gm: {cap['replays']} / {eag['replays']}"
                           f" replays captured / eager")


def phase_ernie_oracle():
    """Step 1 of the amp + recompute chain (dropout 0) on the card and on
    the CPU from the card's startup values and feed."""
    from paddle_tpu_torch.framework.scope import scope_from_numpy, to_numpy

    flags.set_flags({"flash_attention": "always"})
    prog = ernie_program(amp=True, recompute=True, dropout=0.0,
                         batch=ERNIE_ORACLE_BATCH)
    feed = ernie_feed(seed=1, batch=ERNIE_ORACLE_BATCH)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(prog["startup"], scope=scope)
    host = {n: to_numpy(v) for n, v in scope._vars.items()
            if isinstance(v, torch.Tensor)}
    card = float(exe.run(prog["main"], feed=feed, fetch_list=[prog["loss"]],
                         scope=scope)[0].ravel()[0])
    exe.close()
    t0 = time.monotonic()
    cpu_scope = scope_from_numpy(host, device="cpu")
    cpu = float(pt.Executor(pt.CPUPlace()).run(
        prog["main"], feed=feed, fetch_list=[prog["loss"]],
        scope=cpu_scope)[0].ravel()[0])
    cpu_s = time.monotonic() - t0
    gap = abs(card - cpu) / abs(cpu)
    log("ernie_oracle", dropout=0.0, batch=ERNIE_ORACLE_BATCH,
        loss_card=card, loss_cpu=cpu,
        rel_gap=gap, tolerance=ERNIE_ORACLE_RTOL, cpu_seconds=cpu_s,
        cpu_threads=torch.get_num_threads())
    if not (math.isfinite(card) and gap <= ERNIE_ORACLE_RTOL):
        raise RuntimeError(f"ernie_oracle: step 1's loss {card} on the card"
                           f" against {cpu} on the CPU: {gap} > "
                           f"{ERNIE_ORACLE_RTOL}")


# -- slice 17: QAT and activation PTQ on ResNet-50, MoE serving and training --

QAT_STEPS = 10          # timed replays of each ResNet network
QAT_EAGER_STEPS = 2     # eager steps beside them
QAT_ORACLE_BATCH = 4
PTQ_BATCH, PTQ_CALIB_BATCHES, PTQ_RUNS = 32, 4, 20
# the JAX package's bound for QAT -> save_inference_model -> Predictor
# (tests/test_quantization.py): the frozen program run by the executor
QAT_EXPORT_RTOL, QAT_EXPORT_ATOL = 1e-4, 1e-5
FAKE_QUANT_TYPES = ("fake_quantize_dequantize_moving_average_abs_max",
                    "fake_channel_wise_quantize_dequantize_abs_max")
SLIM_STATE = {}         # what qat_resnet hands to qat_export

MOE_SERVE = dict(SERVE_MODEL, moe_experts=8, moe_top_k=2)
MOE_PROMPTS = (100, 180, 260, 340, 420, 600)
MOE_NEW_TOKENS = 32
MOE_TRAIN = dict(d_model=512, ffn=2048, experts=8, top_k=2,
                 capacity_factor=1.25, tokens=8192, lr=0.05, momentum=0.9,
                 aux_coeff=0.01)
# the dense twin's rate: at 0.05 it diverges at these widths (NaN by step
# 9 on the card and on the CPU); the rate changes no step's work
MOE_DENSE_LR = 0.005
MOE_TRAIN_STEPS = 10
# bench.py's moe_loss_parity_vs_oracle bound (step 1, card against CPU)
MOE_LOSS_RTOL = 1e-4


def slim_resnet(qat, lr=0.1):
    """ResNet-50 v1.5 training in float32 (``build_resnet``'s program), with
    ``slim.quant_aware`` applied before ``minimize`` when ``qat``."""
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.vision import resnet50_train_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = resnet50_train_program(
            lr=lr, momentum=0.9, img_shape=RESNET_IMG)
        main.random_seed = 1
        with program_guard(main, startup):
            if qat:
                slim.quant_aware(main, startup)
            opt.minimize(loss)
    return main, startup, loss


def resnet_inference():
    """ResNet-50 v1.5's inference program (the image to the logits, batch
    norm in test mode), its startup and the logits' name."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.vision.static_models import resnet

    main, startup = pt.framework.Program(), pt.framework.Program()
    with unique_name.guard(), program_guard(main, startup):
        logits = resnet(layers.data("image", list(RESNET_IMG)), depth=50,
                        class_num=1000)
    return main.clone(for_test=True), startup, logits.name


def qdq_ops(main):
    return sum(op.type in FAKE_QUANT_TYPES for op in main.global_block.ops)


def quantizable_ops(main):
    """Ops whose weight gets a qdq op (each activation input gets one
    more, shared by the ops that read it)."""
    from paddle_tpu_torch.slim.quantization import _QUANT_SLOTS

    return sum(op.type in _QUANT_SLOTS for op in main.global_block.ops)


def ma_scales(main):
    return [op.outputs["OutScale"][0] for op in main.global_block.ops
            if op.type == FAKE_QUANT_TYPES[0]]


def slim_train(qat, batch):
    """Startup, the warm-up and capture, QAT_STEPS synced replays at
    ``batch``, then the eager block beside them; the scope is handed back
    with the program."""
    main, startup, loss = slim_resnet(qat)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in resnet_feed(batch).items()}
    captured_gb = warm_and_capture(exe, main, feed, [loss], scope)
    replays = stat_get("cuda_graph_replays")
    step_ms, losses = [], []
    for _ in range(QAT_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    replays = stat_get("cuda_graph_replays") - replays
    if replays != QAT_STEPS:
        raise RuntimeError(f"{replays} of {QAT_STEPS} ResNet steps were "
                           f"replays (qat={qat})")
    graph = eager_vs_captured("qat_resnet" if qat else "resnet_float32",
                              exe, main, feed, [loss], scope,
                              QAT_EAGER_STEPS, RESNET_ORACLE_RTOL, True,
                              step_ms, captured_gb)
    exe.close()
    p50 = float(np.median(step_ms))
    report = dict(step_ms_p50=p50, images_per_s=batch / (p50 / 1e3),
                  step_ms=step_ms, losses=losses, replays=replays, **graph)
    return report, main, loss, scope


def phase_qat_resnet():
    """ResNet-50 at 224 in float32 (the AMP lists name no fake-quant op),
    with and without ``quant_aware``, at the largest power-of-two batch up
    to RESNET_BATCH that fits both."""
    zero_kernel_launches()
    batch, reduced = RESNET_BATCH, []
    while True:
        try:
            plain, _m, _l, _s = slim_train(False, batch)
            del _m, _l, _s
            release("resnet_float32")
            qat, main, loss, scope = slim_train(True, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            reason = f"batch {batch} ran out of device memory: " \
                     f"{str(e).splitlines()[0][:300]}"
        gc.collect()
        torch.cuda.empty_cache()
        reduced.append(reason)
        batch //= 2
        if batch < 8:
            raise RuntimeError(f"QAT ResNet-50 does not fit: {reduced}")
    scales = {n: float(scope.get_var(n).ravel()[0]) for n in ma_scales(main)}
    moved = sum(v != 1.0 for v in scales.values())
    launches = kernel_launches()
    log("qat_resnet", model="resnet50_v1.5", batch=batch, image=RESNET_IMG,
        dtype="float32", optimizer="momentum 0.9, lr 0.1",
        steps=QAT_STEPS, reduced=reduced, qdq_ops=qdq_ops(main),
        quantizable_ops=quantizable_ops(main),
        moving_average_scales=len(scales), scales_moved_off_1=moved,
        scale_min=min(scales.values()), scale_max=max(scales.values()),
        qat=qat, float32=plain,
        qat_over_float32_step=qat["step_ms_p50"] / plain["step_ms_p50"],
        launches=launches)
    if any(launches.values()):
        raise RuntimeError(f"the QAT path launched hand-written kernels: "
                           f"{launches}")
    for label, r in (("qat", qat), ("float32", plain)):
        if not all(math.isfinite(x) for x in r["losses"]):
            raise RuntimeError(f"qat_resnet {label}: losses not finite: "
                               f"{r['losses']}")
    if qdq_ops(main) != len(scales) + quantizable_ops(main) \
            or moved != len(scales):
        raise RuntimeError(f"qat_resnet: {qdq_ops(main)} qdq ops for "
                           f"{quantizable_ops(main)} quantizable ops, "
                           f"{moved} of {len(scales)} moving-average "
                           f"scales moved off their initial 1.0")
    SLIM_STATE.update(main=main, loss=loss, scope=scope)


def logits_name(main):
    return next(op.inputs["Logits"][0] for op in main.global_block.ops
                if op.type == "softmax_with_cross_entropy")


def predictor_runs(pred, feed, runs):
    """A Predictor's warm-up and capture, then ``runs`` synced replays:
    (ms a run, the last outputs)."""
    pred.run(feed)
    pred.run(feed)
    replays = stat_get("cuda_graph_replays")
    ms = synced_ms(lambda: pred.run(feed), runs)
    if stat_get("cuda_graph_replays") - replays != runs:
        raise RuntimeError("a Predictor's timed runs were not replays")
    return ms, pred.run(feed)


def save_model(model_dir, program, logits, exe, scope):
    with pt.fluid.scope_guard(scope):
        pt.fluid.io.save_inference_model(
            model_dir, ["image"], [program.global_block.var(logits)], exe,
            main_program=program)


def phase_qat_export(tmp):
    """The trained QAT ResNet's ``clone(for_test=True)`` (scales frozen)
    -> ``save_inference_model`` -> a captured ``Predictor`` at batch 32,
    against the frozen program run by the executor."""
    from paddle_tpu_torch import inference

    main, scope = SLIM_STATE["main"], SLIM_STATE["scope"]
    test_prog = main.clone(for_test=True)
    logits = logits_name(test_prog)
    frozen = [op for op in test_prog.global_block.ops
              if op.type == FAKE_QUANT_TYPES[0]]
    if not frozen or not all(op.attr("is_test") for op in frozen):
        raise RuntimeError("qat_export: clone(for_test=True) left a "
                           "moving-average qdq op training")
    exe = pt.Executor()
    feed = {"image": resnet_feed(PTQ_BATCH, seed=3)["image"]}
    before = {n: scope.get_var(n).clone() for n in ma_scales(main)}
    ref = exe.run(test_prog, feed=feed, fetch_list=[logits], scope=scope,
                  use_prune=True)[0]
    model_dir = os.path.join(tmp, "qat_resnet")
    save_model(model_dir, test_prog, logits, exe, scope)
    exe.close()
    pred = inference.create_predictor(inference.Config(model_dir))
    ms, out = predictor_runs(pred, feed, PTQ_RUNS)
    got = np.asarray(out[0])
    gap = float(np.abs(got - ref).max())
    still = all(torch.equal(scope.get_var(n), v) for n, v in before.items())
    types = [op.type for op in pred._program.global_block.ops]
    log("qat_export", batch=PTQ_BATCH, frozen_scales=len(frozen),
        predictor_qdq_ops=sum(t in FAKE_QUANT_TYPES for t in types),
        predictor_ms_p50=float(np.median(ms)),
        rows_per_s=PTQ_BATCH / (float(np.median(ms)) / 1e3),
        max_abs_gap_vs_frozen_program=gap,
        logits_max_abs=float(np.abs(ref).max()), rtol=QAT_EXPORT_RTOL,
        atol=QAT_EXPORT_ATOL, scales_unchanged=still)
    pred._exe.close()
    if not np.allclose(got, ref, rtol=QAT_EXPORT_RTOL, atol=QAT_EXPORT_ATOL) \
            or not np.isfinite(got).all():
        raise RuntimeError(f"qat_export: the Predictor's logits are {gap} "
                           f"from the frozen program's")
    if not still:
        raise RuntimeError("qat_export: the frozen program moved a scale")
    SLIM_STATE.clear()


def phase_ptq_resnet(tmp):
    """``PostTrainingQuantization`` of the float ResNet-50 inference
    program over PTQ_CALIB_BATCHES seeded batches of 32, then a captured
    ``Predictor`` of the quantized program beside the float32 one."""
    from paddle_tpu_torch import inference, slim

    zero_kernel_launches()
    infer, startup, logits = resnet_inference()
    quantizable = quantizable_ops(infer)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    calib = [{"image": resnet_feed(PTQ_BATCH, seed=10 + i)["image"]}
             for i in range(PTQ_CALIB_BATCHES)]
    t0 = time.monotonic()
    with unique_name.guard():
        ptq = slim.PostTrainingQuantization(
            exe, infer, feed_list=["image"], fetch_list=[logits],
            data_loader=calib, scope=scope, batch_nums=PTQ_CALIB_BATCHES)
        qprog = ptq.quantize()
    torch.cuda.synchronize()
    calib_s = time.monotonic() - t0
    dirs = {"float32": os.path.join(tmp, "resnet_float32"),
            "ptq_int8": os.path.join(tmp, "resnet_ptq")}
    save_model(dirs["float32"], infer, logits, exe, scope)
    save_model(dirs["ptq_int8"], qprog, logits, exe, scope)
    exe.close()
    feed = {"image": resnet_feed(PTQ_BATCH, seed=4)["image"]}
    res = {}
    for label, d in dirs.items():
        pred = inference.create_predictor(inference.Config(d))
        ms, out = predictor_runs(pred, feed, PTQ_RUNS)
        p50 = float(np.median(ms))
        res[label] = dict(ms_p50=p50, rows_per_s=PTQ_BATCH / (p50 / 1e3),
                          qdq_ops=sum(op.type.startswith("fake_") for op in
                                      pred._program.global_block.ops))
        res[label + "_logits"] = np.asarray(out[0])
        pred._exe.close()
    q, f = res.pop("ptq_int8_logits"), res.pop("float32_logits")
    delta = qo.quant_quality_delta(q, f)
    launches = kernel_launches()
    scales = list(ptq._act_scales.values())
    log("ptq_resnet", batch=PTQ_BATCH, calibration_batches=PTQ_CALIB_BATCHES,
        calibrated_activations=len(scales), quantizable_ops=quantizable,
        scale_min=min(scales),
        scale_max=max(scales), calibration_s=calib_s,
        quant_quality_delta=delta,
        float32_logits_max_abs=float(np.abs(f).max()), launches=launches,
        **res)
    if any(launches.values()):
        raise RuntimeError(f"the PTQ path launched hand-written kernels: "
                           f"{launches}")
    if not (np.isfinite(q).all() and q.shape == f.shape == (PTQ_BATCH, 1000)
            and res["ptq_int8"]["qdq_ops"] == len(scales) + quantizable):
        raise RuntimeError(f"ptq_resnet: logits {q.shape}, "
                           f"{res['ptq_int8']['qdq_ops']} qdq ops for "
                           f"{len(scales)} activations and {quantizable} "
                           f"quantizable ops")


def phase_qat_oracle():
    """float32, batch 4: step 1 of the QAT ResNet-50 on the card replayed
    op by op on the CPU from the card's inputs (``replay_step``).  The
    fake quant-dequant ops (and their straight-through gradients) must be
    bit-equal -- division, round half to even and clamp are exact in IEEE
    arithmetic -- and every other output within RESNET_ORACLE_RTOL.  No
    trajectory is compared: a one-ulp difference before a rounding moves
    a value by a whole quantization step."""
    main, startup, loss = slim_resnet(True, lr=RESNET_ORACLE_LR)
    exe = pt.Executor()
    card = pt.framework.Scope()
    exe.run(startup, scope=card)
    feed = resnet_feed(QAT_ORACLE_BATCH, seed=1)
    exe.warmup(main, [feed], [loss], card)
    snap = snapshot(card)
    captured_first = float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=card)[0].ravel()[0])
    restore(card, snap)
    del snap
    t0 = time.monotonic()
    first, errs = replay_step(exe, main, feed, loss.name, card)
    replay_s = time.monotonic() - t0
    exe.close()
    qdq = [e for e in errs if e[0].startswith("fake_")]
    rest = [e for e in errs if not e[0].startswith("fake_")]
    worst_qdq = max(qdq, key=lambda r: r[2])
    worst = max(rest, key=lambda r: r[2])
    conv = max(e for t, _n, e in rest if t.startswith("conv2d"))
    by_type = {}
    for t, _n, e in errs:
        by_type[t] = max(by_type.get(t, 0.0), e)
    log("qat_oracle", batch=QAT_ORACLE_BATCH, dtype="float32",
        replayed_outputs=len(errs), qdq_outputs=len(qdq),
        qdq_max_rel_err=list(worst_qdq), conv_max_rel_err=conv,
        other_max_rel_err=list(worst), replay_max_rel_err_by_type=by_type,
        tolerance=RESNET_ORACLE_RTOL, loss_step1_card_captured=captured_first,
        loss_step1_card_replayed=float(first.ravel()[0]), replay_s=replay_s)
    if worst_qdq[2] != 0.0:
        raise RuntimeError(f"qat_oracle: the card's {worst_qdq[0]} output "
                           f"{worst_qdq[1]} is not bit-equal to the CPU's "
                           f"({worst_qdq[2]})")
    if worst[2] > RESNET_ORACLE_RTOL or not math.isfinite(captured_first):
        raise RuntimeError(f"qat_oracle: the card's {worst[0]} output "
                           f"{worst[1]} is {worst[2]} from the CPU's on the "
                           f"same inputs (> {RESNET_ORACLE_RTOL})")


def moe_layer_loads(model, tokens):
    """Each layer's kept-token counts by expert for one sequence (causal
    attention through SDPA, the router as the served layer runs it)."""
    from paddle_tpu_torch.ops.moe_ops import moe_route

    e, k = model.moe_experts, model.moe_top_k
    with torch.no_grad():
        tok = torch.as_tensor(tokens, device=model.device)
        pos = torch.arange(len(tokens), device=model.device)
        x = model._embed(tok, pos)
        loads = []
        for lw in model.layers:
            q, kk, v = (t.transpose(0, 1) for t in
                        model._qkv(lw, model._ln(x, lw.ln1_g, lw.ln1_b)))
            ctx = F.scaled_dot_product_attention(q, kk, v, is_causal=True)
            x = x + model._attn_out(lw, ctx.transpose(0, 1))
            h = model._ln(x, lw.ln2_g, lw.ln2_b)
            loads.append(moe_route(h, lw.gate, num_experts=e, top_k=k,
                                   capacity_factor=e / k)[3])
            x = x + model._mlp(lw, h)
    return loads


def decode_window(model, weights, prompts):
    """The prompts through a fresh ``DecodeServer`` (slots 8, pages of 16;
    decode step captured, prefill eager) after a short warm-up request:
    the serving numbers, the requests, and B5/B6's launches in the
    window."""
    srv = DecodeServer(model, weights, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16)).start()
    eng = srv.replicas[0]
    try:
        # a warm-up request that shares no page with the window's prompts
        srv.submit(list(range(1, 65)), max_new_tokens=4).result(timeout=600)
        torch.cuda.synchronize()
        flags.set_flags({"enable_tracer": True})
        tracer.clear()
        pa.reset_launch_counts()
        t0 = time.monotonic()
        reqs = [srv.submit(p, max_new_tokens=MOE_NEW_TOKENS,
                           record_logits=True) for p in prompts]
        for r in reqs:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = (pa.paged_decode_attention.launches,
                    pa.paged_chunk_attention.launches)
        spans = tracer.snapshot()
    finally:
        flags.set_flags({"enable_tracer": False})
        srv.stop()
    steps = [1e3 * sp.duration for sp in spans
             if sp.name == "serving/decode_step"]
    prefills = sum(sp.name == "serving/decode_prefill" for sp in spans)
    tpot = [1e3 * (r.t_last_token - r.t_first_token)
            / (len(r.generated) - 1) for r in reqs]
    n_tokens = sum(len(r.generated) for r in reqs)
    captured = eng._step is not None and eng._step.graph is not None
    want = (model.num_layers * len(steps), model.num_layers * prefills)
    report = dict(
        tokens=n_tokens, wall_s=wall, tokens_per_s=n_tokens / wall,
        decode_step_p50_ms=float(np.median(steps)), decode_steps=len(steps),
        ttft_p50_ms=float(np.median([1e3 * (r.t_first_token - r.t_enqueue)
                                     for r in reqs])),
        tpot_p50_ms=float(np.median(tpot)),
        tpot_p99_ms=float(np.percentile(tpot, 99)),
        prefills=prefills, b5_launches=launches[0],
        b6_launches=launches[1], decode_step_captured=captured)
    if not captured or launches != want:
        raise RuntimeError(f"decode window: captured {captured}, B5/B6 "
                           f"launched {launches} times in {len(steps)} "
                           f"decode steps and {prefills} prefills, want "
                           f"{want}")
    return report, reqs, eng


def phase_moe_serve():
    """The serve phase's model with 8 experts, top-2, dropless, through
    ``DecodeServer`` beside the dense model in the same call; then the same
    MoE weights quantized to int8 carriers."""
    from paddle_tpu_torch.ops.moe_ops import moe_balance_gauges
    from paddle_tpu_torch.serving import quantize_moe_weights

    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 32000, n).tolist() for n in MOE_PROMPTS]
    dense = TransformerLM(**SERVE_MODEL)
    dense_report, _r, _e = decode_window(
        dense, dense.init_weights(torch.Generator().manual_seed(0)), prompts)
    del dense, _r, _e
    model = TransformerLM(**MOE_SERVE)
    weights = model.init_weights(torch.Generator().manual_seed(1))
    expert_bytes = sum(t.numel() * t.element_size() for lw in
                       weights["layers"] for n, t in lw.items()
                       if n in ("moe_w1", "moe_w2"))
    moe_report, reqs, eng = decode_window(model, weights, prompts)
    oracle_err = 0.0
    for prompt, r in zip(prompts, reqs):
        n = len(r.generated)
        for i in sorted({0, n // 2, n - 1}):
            got = r.logits_trace[i]
            want = eng.recompute_logits(prompt + r.generated[:i])
            if got.shape != (32000,) or not np.isfinite(got).all():
                raise RuntimeError(f"moe_serve: logits {got.shape} not "
                                   f"finite")
            oracle_err = max(oracle_err, float(np.abs(got - want).max()))
    loads = moe_layer_loads(model, prompts[-1])
    gauges = [moe_balance_gauges(ld, len(prompts[-1]), model.moe_top_k,
                                 publish=False) for ld in loads]
    qweights = quantize_moe_weights(weights, "int8")
    carrier_bytes = sum(t.numel() * t.element_size() for lw in
                        qweights["layers"] for n, t in lw.items()
                        if n in ("moe_w1_q", "moe_w2_q"))
    int8_report, qreqs, _e = decode_window(model, qweights, prompts)
    model.load_weights(weights)         # the float oracle again
    got, ref = [], []
    for prompt, r in zip(prompts[:3], qreqs[:3]):
        got += r.logits_trace
        ref += [eng.recompute_logits(prompt + r.generated[:t])
                for t in range(len(r.generated))]
    delta = qo.quant_quality_delta(np.stack(got), np.stack(ref))
    log("moe_serve", model=MOE_SERVE, dropless=True,
        expert_weight_mb=expert_bytes / 1e6,
        int8_carrier_mb=carrier_bytes / 1e6, requests=len(prompts),
        new_tokens=MOE_NEW_TOKENS, moe=moe_report, dense=dense_report,
        moe_int8=int8_report,
        moe_over_dense_step=moe_report["decode_step_p50_ms"]
        / dense_report["decode_step_p50_ms"],
        logits_vs_oracle_max_abs=oracle_err, tolerance=LOGIT_TOL,
        balance_gauges_by_layer=gauges, int8_quant_quality_delta=delta,
        int8_teacher_forced_positions=len(got))
    if oracle_err > LOGIT_TOL:
        raise RuntimeError(f"moe_serve: streamed logits vs recompute_logits:"
                           f" max abs {oracle_err} > {LOGIT_TOL}")
    if not np.isfinite(np.stack(got)).all():
        raise RuntimeError("moe_serve: int8 logits not finite")


def moe_train_program(kind):
    """bench.py's ``moe_local`` program at the serving widths (x -> moe_ffn
    -> fc head -> MSE + 0.01 aux), or its ``dense`` twin at matched
    activated FLOPs (fc top_k * ffn gelu -> fc d_model -> head) through
    ``fleet`` at one process; Momentum 0.05/0.9 (the twin's rate
    MOE_DENSE_LR)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import MomentumOptimizer

    c = MOE_TRAIN
    main, startup = pt.framework.Program(), pt.framework.Program()
    main.random_seed = 1
    load = None
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [c["d_model"]])
        y = layers.data("y", [1])
        opt = MomentumOptimizer(MOE_DENSE_LR if kind == "dense" else c["lr"],
                                c["momentum"])
        if kind == "dense":
            h = layers.fc(x, c["top_k"] * c["ffn"], act="gelu",
                          name="dense_up")
            h = layers.fc(h, c["d_model"], name="dense_down")
            pred = layers.fc(h, 1, name="head")
            loss = layers.mean(layers.square_error_cost(pred, y))
            fleet.init(is_collective=True)
            fleet.distributed_optimizer(opt)
            fleet.minimize(loss)
        else:
            h, aux, load = layers.moe_ffn(
                x, num_experts=c["experts"], ffn_dim=c["ffn"],
                top_k=c["top_k"], capacity_factor=c["capacity_factor"],
                name="moe0")
            pred = layers.fc(h, 1, name="head")
            loss = layers.elementwise_add(
                layers.mean(layers.square_error_cost(pred, y)),
                layers.scale(aux, c["aux_coeff"]))
            opt.minimize(loss)
    return main, startup, loss, load


def moe_feed():
    c = MOE_TRAIN
    rs = np.random.RandomState(0)
    x = rs.randn(c["tokens"], c["d_model"]).astype("float32")
    return {"x": x, "y": (x.sum(axis=1, keepdims=True) * 0.3)
            .astype("float32")}


def phase_moe_train():
    """The MoE program and its dense twin captured on the card
    (MOE_TRAIN_STEPS replays each), and the MoE program's step 1 against
    the CPU from the same startup values."""
    from paddle_tpu_torch.framework.scope import scope_from_numpy, to_numpy
    from paddle_tpu_torch.ops.moe_ops import moe_balance_gauges

    c = MOE_TRAIN
    feed = moe_feed()
    res = {}
    for kind in ("moe", "dense"):
        main, startup, loss, load = moe_train_program(kind)
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        host = {n: to_numpy(v) for n, v in scope._vars.items()
                if isinstance(v, torch.Tensor)}
        fetch = [loss] + ([load] if load is not None else [])
        dfeed = {k: torch.from_numpy(v).to(exe.device)
                 for k, v in feed.items()}
        first = float(np.asarray(exe.run(main, feed=dfeed, fetch_list=fetch,
                                         scope=scope)[0]).ravel()[0])
        exe.run(main, feed=dfeed, fetch_list=fetch, scope=scope)
        replays = stat_get("cuda_graph_replays")
        step_ms, out = [], None
        for _ in range(MOE_TRAIN_STEPS):
            t0 = time.perf_counter()
            out = exe.run(main, feed=dfeed, fetch_list=fetch, scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if stat_get("cuda_graph_replays") - replays != MOE_TRAIN_STEPS:
            raise RuntimeError(f"moe_train {kind}: the timed steps were not "
                               f"replays")
        exe.close()
        p50 = float(np.median(step_ms))
        r = dict(step_ms_p50=p50, tokens_per_s=c["tokens"] / (p50 / 1e3),
                 step_ms=step_ms, loss_first=first,
                 loss_last=float(np.asarray(out[0]).ravel()[0]))
        if kind == "moe":
            r["gauges"] = moe_balance_gauges(np.asarray(out[1]),
                                             c["tokens"], c["top_k"])
            r["expert_load"] = np.asarray(out[1]).tolist()
            t0 = time.monotonic()
            r["loss_first_cpu"] = float(pt.Executor(pt.CPUPlace()).run(
                main, feed=feed, fetch_list=[loss], use_prune=True,
                scope=scope_from_numpy(host, device="cpu"))[0].ravel()[0])
            r["cpu_s"] = time.monotonic() - t0
            r["loss_parity_vs_cpu"] = abs(first - r["loss_first_cpu"]) \
                / abs(r["loss_first_cpu"])
        res[kind] = r
        del main, startup, scope, exe
        release(f"moe_train_{kind}")
    moe, dense = res["moe"], res["dense"]
    log("moe_train", **c, dense_lr=MOE_DENSE_LR, steps=MOE_TRAIN_STEPS,
        moe_tokens_per_sec=moe["tokens_per_s"],
        moe_dense_equiv_tokens_per_sec=dense["tokens_per_s"],
        moe_loss_parity_vs_oracle=moe["loss_parity_vs_cpu"],
        tolerance=MOE_LOSS_RTOL, moe=moe, dense=dense)
    for kind, r in res.items():
        if not (math.isfinite(r["loss_first"])
                and r["loss_last"] < r["loss_first"]):
            raise RuntimeError(f"moe_train {kind}: the loss did not fall: "
                               f"{r['loss_first']} -> {r['loss_last']}")
    if moe["loss_parity_vs_cpu"] > MOE_LOSS_RTOL:
        raise RuntimeError(f"moe_train: step 1's loss {moe['loss_first']} on"
                           f" the card against {moe['loss_first_cpu']} on "
                           f"the CPU: {moe['loss_parity_vs_cpu']} > "
                           f"{MOE_LOSS_RTOL}")



# -- slice 18: jit / dy2static -------------------------------------------

JIT_BATCH = 32          # jit_resnet's and jit_bert_int8's batch
JIT_RUNS = 20           # timed runs of each path (replays where captured)
JIT_RTOL = 1e-4         # traced or loaded against eager, relative
JIT_BERT = dict(vocab=30522, d_model=768, layers=12, heads=12, ffn=3072,
                positions=512)  # the repo's bert_base widths, dropout 0
JIT_SEQ = 128
# The VERDICT function's fills at [32, 768] (exact powers of two, so every
# run is exact): (fill, branch, while trips).
DY2S_SHAPE = (32, 768)
DY2S_FILLS = ((0.5, "x * 2", 0), (2.0 ** -10, "x * 2", 1),
              (2.0 ** -16, "x * 2", 7), (-2.0 ** -12, "x * -3", 2),
              (-1.0, "x * -3", 0))
DY2S_RTOL = 1e-6
# The JAX package's cond training program at width: x [4096, 1024], fc
# 4096 relu, the branch fc 4096 -> 1 (true) or the row mean (false).
COND_TRAIN = dict(batch=4096, width=1024, hidden=4096, steps=10, lr=0.001)
COND_RTOL = 1e-4        # float32 on cuBLAS against ATen's CPU kernels


def eager_counts():
    """Every ``executor_eager_<kind>`` counter the monitor holds."""
    from paddle_tpu_torch.monitor import export_stats

    return {n: v for n, v in export_stats()
            if n.startswith("executor_eager_")}


def timed_runs(fn, runs):
    """Milliseconds of each of ``runs`` calls of ``fn``, synced; the last
    output."""
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def trace_consts(traced, network):
    """The ``trace_const`` vars of a traced program: (count, bytes, the
    names of those that are neither a scalar nor a buffer of
    ``network``)."""
    consts = {n: v for n, v in traced._param_values.items()
              if n.startswith("trace_const")}
    buffers = [b._value for b in network.buffers()]
    stray = [n for n, v in consts.items() if v.numel() > 1 and not any(
        b.shape == v.shape and torch.equal(b, v) for b in buffers)]
    return (len(consts), sum(v.numel() * v.element_size()
                             for v in consts.values()), stray)


def phase_jit_resnet():
    """Dygraph ResNet-50 (``vision.models.resnet50``, eval, float32) at
    batch 32 through ``jit.to_static``: captured, then replayed; beside
    the eager forward (and both at batch 1), then ``jit.save`` ->
    ``jit.load`` on the card, and ``flops`` of the Layer beside the
    static program's."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.hapi.model_stat import program_flops

    pt.set_device("gpu:0")
    pt.seed(0)
    net = pt.vision.models.resnet50()
    net.eval()
    x = pt.to_tensor(np.random.RandomState(0).randn(
        JIT_BATCH, *RESNET_IMG).astype("float32"))
    eager0 = eager_counts()
    zero_kernel_launches()
    with pt.no_grad():
        timed_runs(lambda: net(x), 3)
        eager_ms, eager = timed_runs(lambda: net(x), JIT_RUNS)
        sf = jit.to_static(net)
        t0 = time.monotonic()
        first = sf(x)           # the trace, then the program's eager run
        torch.cuda.synchronize()
        trace_s = time.monotonic() - t0
        captures, replays = (stat_get("cuda_graph_captures"),
                             stat_get("cuda_graph_replays"))
        sf(x)                   # the capture
        static_ms, static = timed_runs(lambda: sf(x), JIT_RUNS)
        replays = stat_get("cuda_graph_replays") - replays
        captures = stat_get("cuda_graph_captures") - captures
        # at batch 1 the forward's ~320 dispatches outlast its card work
        x1 = pt.to_tensor(x.numpy()[:1])
        timed_runs(lambda: net(x1), 3)
        eager1_ms, _ = timed_runs(lambda: net(x1), JIT_RUNS)
        timed_runs(lambda: sf(x1), 3)       # trace, capture, replay
        static1_ms, _ = timed_runs(lambda: sf(x1), JIT_RUNS)
    launches = kernel_launches()
    eager1 = eager_counts()
    traced = sf.concrete_program
    n_const, const_bytes, stray = trace_consts(traced, net)
    gap = rel_gap(static.numpy(), eager.numpy())
    first_gap = rel_gap(first.numpy(), eager.numpy())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50")
        t0 = time.monotonic()
        jit.save(net, path, input_spec=[
            pt.hapi.model.InputSpec([-1, 3, *RESNET_IMG[1:]])])
        save_s = time.monotonic() - t0
        loaded = jit.load(path)
        timed_runs(lambda: loaded(x), 2)            # eager, then captured
        load_ms, load_out = timed_runs(lambda: loaded(x), JIT_RUNS)
        loaded._predictor._exe.close()
    load_gap = rel_gap(load_out.numpy(), static.numpy())
    flops = pt.flops(net, [1, *RESNET_IMG])
    static_flops = program_flops(resnet_inference()[0])
    p50 = {k: float(np.median(v)) for k, v in
           (("eager", eager_ms), ("to_static", static_ms),
            ("jit_load", load_ms))}
    log("jit_resnet", model="resnet50_v1.5", api="jit.to_static",
        batch=JIT_BATCH, image=RESNET_IMG, dtype="float32", runs=JIT_RUNS,
        eager_ms_p50=p50["eager"], to_static_ms_p50=p50["to_static"],
        jit_load_ms_p50=p50["jit_load"],
        capture_saves=1.0 - p50["to_static"] / p50["eager"],
        batch_1_eager_ms_p50=float(np.median(eager1_ms)),
        batch_1_to_static_ms_p50=float(np.median(static1_ms)),
        batch_1_capture_saves=1.0 - float(np.median(static1_ms))
        / float(np.median(eager1_ms)),
        rows_per_s={k: JIT_BATCH / (v / 1e3) for k, v in p50.items()},
        to_static_rel_gap=gap, first_run_rel_gap=first_gap,
        jit_load_rel_gap=load_gap, rel_tolerance=JIT_RTOL,
        trace_s=trace_s, save_s=save_s, captures=captures,
        replays=replays, ops=len(traced.program.global_block.ops),
        trace_const_vars=n_const, trace_const_bytes=const_bytes,
        trace_const_not_buffers=stray, executor_eager_before=eager0,
        executor_eager_after=eager1, launches=launches, flops_b1=flops,
        static_program_flops_b1=static_flops,
        flops_ratio=flops / static_flops,
        eager_ms=eager_ms, to_static_ms=static_ms)
    if any(launches.values()):
        raise RuntimeError(f"jit_resnet launched hand-written kernels: "
                           f"{launches}")
    if max(gap, first_gap, load_gap) > JIT_RTOL:
        raise RuntimeError(f"jit_resnet: to_static {gap}, its first run "
                           f"{first_gap}, jit.load {load_gap} from eager "
                           f"(> {JIT_RTOL})")
    if eager1 != eager0 or captures != 1 or replays < JIT_RUNS:
        raise RuntimeError(f"jit_resnet: eager counts {eager0} -> {eager1}, "
                           f"{captures} captures and {replays} replays "
                           f"(want 1 and >= {JIT_RUNS})")
    if stray:
        raise RuntimeError(f"jit_resnet: trace constants that are no "
                           f"buffer (an op escaped the recorder): {stray}")
    if static.shape != [JIT_BATCH, 1000] or not np.isfinite(
            static.numpy()).all():
        raise RuntimeError(f"jit_resnet: logits {static.shape} not finite")


class JitBert(pt.nn.Layer):
    """A BERT-base-width encoder written as a dygraph user writes one:
    word and position embeddings, the pad mask built from ``ids != 0``,
    12 post-norm encoder layers (gelu, dropout 0), a tanh pooler on
    [CLS] and a 2-way classifier."""

    def __init__(self, vocab, d_model, layers, heads, ffn, positions):
        super().__init__()
        self.word = pt.nn.Embedding(vocab, d_model)
        self.pos = pt.nn.Embedding(positions, d_model)
        layer = pt.nn.TransformerEncoderLayer(d_model, heads, ffn,
                                              dropout=0.0,
                                              activation="gelu")
        self.encoder = pt.nn.TransformerEncoder(layer, layers)
        self.pooler = pt.nn.Linear(d_model, d_model)
        self.classifier = pt.nn.Linear(d_model, 2)

    def forward(self, ids, pos):
        mask = pt.unsqueeze(ids != 0, [1, 2])
        h = self.encoder(self.word(ids) + self.pos(pos), mask)
        cls = pt.reshape(pt.slice(h, axes=[1], starts=[0], ends=[1]),
                         [0, -1])
        return self.classifier(pt.tanh(self.pooler(cls)))


def jit_bert_feed(batch, seq, vocab, seed):
    """Token ids with each row padded (id 0) after a random length in
    [seq / 2, seq], and the position ids."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (batch, seq)).astype("int64")
    for r, n in enumerate(rng.randint(seq // 2, seq + 1, batch)):
        ids[r, n:] = 0
    pos = np.tile(np.arange(seq, dtype="int64"), (batch, 1))
    return pt.to_tensor(ids), pt.to_tensor(pos)


def phase_jit_bert_int8():
    """The dygraph BERT-base-width encoder exported by ``jit.save`` at the
    serving shape (MultiHeadAttention bakes b and s into its reshapes),
    then served by ``jit.load`` in float32 and under
    ``FLAGS_weight_quant=int8`` (B7 74 a run)."""
    from paddle_tpu_torch import jit

    c = JIT_BERT
    pt.set_device("gpu:0")
    pt.seed(1)
    torch.cuda.reset_peak_memory_stats()
    net = JitBert(**c)
    net.eval()
    ids, pos = jit_bert_feed(JIT_BATCH, JIT_SEQ, c["vocab"], seed=2)
    with pt.no_grad():
        timed_runs(lambda: net(ids, pos), 2)
        eager_ms, eager = timed_runs(lambda: net(ids, pos), 5)
    eager = eager.numpy()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_jit")
        t0 = time.monotonic()
        with pt.no_grad():
            traced = jit.save(net, path, input_spec=[ids, pos])
        save_s = time.monotonic() - t0
        weight_mm = sum(
            op.type == "matmul_v2" and traced.program.global_block
            ._find_var_recursive(op.input("Y")[0]).persistable
            for op in traced.program.global_block.ops)
        for mode in ("", "int8"):
            flags.set_flags({"weight_quant": mode})
            try:
                loaded = jit.load(path)
                n0 = stat_get("pass_weight_quant_ops")
                timed_runs(lambda: loaded(ids, pos), 2)  # eager, captured
                rewritten = stat_get("pass_weight_quant_ops") - n0
                zero_kernel_launches()
                ms, out = timed_runs(lambda: loaded(ids, pos), JIT_RUNS)
                launches = kernel_launches()
                loaded._predictor._exe.close()
            finally:
                flags.set_flags({"weight_quant": ""})
            p50 = float(np.median(ms))
            res[mode or "float32"] = dict(
                ms_p50=p50, rows_per_s=JIT_BATCH / (p50 / 1e3),
                ops_rewritten=rewritten, launches=launches,
                rel_gap_vs_eager=rel_gap(out.numpy(), eager),
                logits=out.numpy(), ms=ms)
    f32, q8 = res["float32"], res["int8"]
    delta = qo.quant_quality_delta(q8.pop("logits"), f32.pop("logits"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log("jit_bert_int8", model="dygraph bert-base-width encoder + pooler "
        "+ 2-way classifier", batch=JIT_BATCH, seq=JIT_SEQ, **c,
        eager_ms_p50=float(np.median(eager_ms)), save_s=save_s,
        matmul_v2_of_a_weight=weight_mm,
        ops=len(traced.program.global_block.ops), float32=f32, int8=q8,
        quant_quality_delta=delta, logits_max_abs=float(np.abs(eager).max()),
        peak_memory_gb=peak, rel_tolerance=JIT_RTOL)
    others = {k: v for k, v in q8["launches"].items() if k != "b7"}
    if q8["launches"]["b7"] != B7_PER_RUN * JIT_RUNS or any(
            others.values()) or any(f32["launches"].values()):
        raise RuntimeError(f"jit_bert_int8: launches float32 "
                           f"{f32['launches']}, int8 {q8['launches']} in "
                           f"{JIT_RUNS} runs; want B7 {B7_PER_RUN} a run "
                           f"under int8 and nothing else")
    if weight_mm != B7_PER_RUN or q8["ops_rewritten"] != B7_PER_RUN:
        raise RuntimeError(f"jit_bert_int8: {weight_mm} matmuls of a weight,"
                           f" {q8['ops_rewritten']} rewritten; want "
                           f"{B7_PER_RUN}")
    if f32["rel_gap_vs_eager"] > JIT_RTOL:
        raise RuntimeError(f"jit_bert_int8: float32 {f32['rel_gap_vs_eager']}"
                           f" from eager (> {JIT_RTOL})")
    if q8["rel_gap_vs_eager"] > INT8_QUALITY_BOUND:
        raise RuntimeError(f"jit_bert_int8: int8 logits "
                           f"{q8['rel_gap_vs_eager']} of the float32 "
                           f"magnitude from eager (> {INT8_QUALITY_BOUND})")


def verdict(x):
    """The JAX package's VERDICT function (tests/test_dy2static.py): a
    branch on the mean, then a loop on the sum."""
    if x.mean() > 0:
        h = x * 2.0
    else:
        h = x * -3.0
    s = h
    while s.sum() < 64.0:
        s = s * 2.0
    return s


def cond_train_program(c):
    """The JAX package's cond training program (tests/test_control_flow.py)
    at width: the branch fc is read only inside the true branch."""
    from paddle_tpu_torch import layers

    main, startup = pt.framework.Program(), pt.framework.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [c["width"]])
        y = layers.data("y", [1])
        flag = layers.data("flag", [1])
        h = layers.fc(x, c["hidden"], act="relu")
        pred = layers.greater_than(layers.reduce_sum(flag),
                                   layers.fill_constant([1], "float32", 0.0))
        out = layers.cond(
            pred, lambda: layers.fc(h, 1, bias_attr=False),
            lambda: layers.reduce_mean(h, dim=1, keep_dim=True))
        loss = layers.mean(layers.square_error_cost(out, y))
        pt.optimizer.MomentumOptimizer(c["lr"], 0.9).minimize(loss)
    return main, startup, loss


def cond_train_run(place, main, init, feeds, loss):
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    exe = pt.Executor(place)
    scope = scope_from_numpy(init, device=place.torch_device())
    losses, ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out[0]).item()))
        ms.append((time.perf_counter() - t0) * 1e3)
    exe.close()
    return losses, ms, scope


def phase_dy2static():
    """The VERDICT function through ``to_static`` -> ``jit.save`` ->
    ``jit.load`` on the card, run on fills that take both branches and
    0, 1, 2 and 7 loop trips; then the cond training program, 10 Momentum
    steps on the card with the flag alternating, against a CPU run from
    the same initial scope."""
    from paddle_tpu_torch import jit

    pt.set_device("gpu:0")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "verdict")
        example = pt.to_tensor(np.full(DY2S_SHAPE, 0.5, "float32"))
        t0 = time.monotonic()
        traced = jit.save(jit.to_static(verdict), path,
                          input_spec=[example])
        save_s = time.monotonic() - t0
        types = [op.type for op in traced.program.global_block.ops]
        loaded = jit.load(path)
        for fill, branch, trips in DY2S_FILLS:
            x = pt.to_tensor(np.full(DY2S_SHAPE, fill, "float32"))
            want = verdict(x).numpy()
            n0 = stat_get("executor_eager_control_flow")
            ms, out = timed_runs(lambda: loaded(x), 3)
            runs.append(dict(
                fill=fill, branch=branch, trips=trips, ms=ms,
                eager_control_flow_runs=stat_get(
                    "executor_eager_control_flow") - n0,
                rel_gap=rel_gap(out.numpy(), want),
                out=float(out.numpy().flat[0])))
        loaded._predictor._exe.close()
    c = COND_TRAIN
    main, startup, loss = cond_train_program(c)
    exe = pt.Executor()
    init_scope = pt.framework.Scope()
    exe.run(startup, scope=init_scope)
    init = {n: init_scope.get_var(n).cpu().numpy()
            for n in init_scope.local_var_names()
            if isinstance(init_scope.get_var(n), torch.Tensor)}
    exe.close()
    rng = np.random.RandomState(5)
    x = rng.randn(c["batch"], c["width"]).astype("float32")
    y = (x[:, :8].sum(1, keepdims=True) * 0.5).astype("float32")
    feeds = [{"x": x, "y": y, "flag": np.full((1, 1), float(i % 2 == 0),
                                              "float32")}
             for i in range(c["steps"])]
    n0 = stat_get("executor_eager_control_flow")
    card, card_ms, scope = cond_train_run(pt.CUDAPlace(0), main, init,
                                          feeds, loss)
    card_eager = stat_get("executor_eager_control_flow") - n0
    t0 = time.monotonic()
    cpu, _, _ = cond_train_run(pt.CPUPlace(), main, init, feeds, loss)
    cpu_s = time.monotonic() - t0
    branch_w = [n for n in init if n.startswith("fc_1.w")][0]
    moved = float(np.abs(scope.get_var(branch_w).cpu().numpy()
                         - init[branch_w]).max())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log("dy2static", shape=DY2S_SHAPE, ops=types, save_s=save_s, runs=runs,
        rel_tolerance=DY2S_RTOL, cond_train=c, card_losses=card,
        cpu_losses=cpu, loss_rel_gap=loss_gap, loss_rtol=COND_RTOL,
        step_ms_p50=float(np.median(card_ms[1:])), step_ms=card_ms,
        card_eager_control_flow_runs=card_eager, cpu_s=cpu_s,
        branch_param=branch_w, branch_param_max_move=moved)
    if "cond_pair" not in types or "while" not in types:
        raise RuntimeError(f"dy2static: the export holds {types}")
    for r in runs:
        if r["rel_gap"] > DY2S_RTOL or r["eager_control_flow_runs"] != 3:
            raise RuntimeError(f"dy2static: fill {r['fill']}: gap "
                               f"{r['rel_gap']} (> {DY2S_RTOL}) or "
                               f"{r['eager_control_flow_runs']} eager runs "
                               f"for 3")
    if loss_gap > COND_RTOL or not all(map(math.isfinite, card)) or \
            card_eager != c["steps"] or moved == 0.0:
        raise RuntimeError(f"dy2static: cond training losses {card} vs the "
                           f"CPU's {cpu} (gap {loss_gap}), {card_eager} "
                           f"eager runs, branch parameter moved {moved}")


# ---- slice 19: observability around fused BERT-base and serving ----------

# observe_train: steps a mode; the injected slow step (x the step p50); the
# stall's device sleep; the relative bound on the four buckets' sum
OBSERVE_STEPS, OBSERVE_SPIKE_X, OBSERVE_STALL_S = 20, 4.0, 4.0
OBSERVE_SUM_RTOL = 1e-6
OBSERVE_CAPTURE_S = 0.25        # the triggered window (~40k kernel events)
OBSERVE_PEAK_TFLOPS = 989.0     # the H100's bf16 data-sheet peak (CARDS)
OBSERVE_PROFILE_STEPS = 5       # observe_profiler: steps a capture
# observe_serve: requests, new tokens a request, one-shot requests
OBSERVE_REQUESTS, OBSERVE_NEW_TOKENS, OBSERVE_ONESHOT = 16, 16, 8


def quench_slo_burn():
    """Zero the ``slo_burn_rate_*_ppm`` gauges earlier phases left: the
    capture engine's SLO trigger reads them."""
    from paddle_tpu_torch.monitor import StatRegistry, stat_set

    for name, _v in StatRegistry.instance().export():
        if name.startswith("slo_burn_rate_") and name.endswith("_ppm"):
            stat_set(name, 0)


def recorded_splits(fn):
    """``fn()`` with every split the phase engine makes recorded: its
    result and [(wall, split)]."""
    from paddle_tpu_torch.observe import phases

    eng, got = phases.phase_engine(), []
    orig = eng.on_step_drained

    def record(wall_s, sync_s, host_s, steps=1, plan=None, compiled=False):
        split = orig(wall_s, sync_s, host_s, steps=steps, plan=plan,
                     compiled=compiled)
        if split is not None:
            got.append((wall_s, split))
        return split

    eng.on_step_drained = record
    try:
        return fn(), got
    finally:
        del eng.on_step_drained


def trace_kernels(path, name):
    """(kernel events, those whose name holds ``name``, CPU op events) of
    a Chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return (len(kernels), sum(name in e.get("name", "") for e in kernels),
            sum(e.get("cat") == "cpu_op" for e in events))


def trace_files(directory):
    return [os.path.join(r, f) for r, _d, fs in os.walk(directory)
            for f in fs if f.endswith(".trace.json")]


def sleep_cycles_per_s(dev, cycles=200_000_000):
    """The card's ``torch.cuda._sleep`` cycles a second, timed with
    events."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) / 1e3)


def stalled_feed(feed, seconds, dev):
    """``feed`` on the card, its ``input_ids`` copied on a side stream
    behind ``seconds`` of device sleep that the current stream waits for
    (a prefetcher whose copy stream is stuck)."""
    cycles = int(seconds * sleep_cycles_per_s(dev))
    out = {n: torch.as_tensor(v).to(dev) for n, v in feed.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(cycles)
        ids = out["input_ids"].clone()
    torch.cuda.current_stream(dev).wait_stream(side)
    ids.record_stream(torch.cuda.current_stream(dev))
    out["input_ids"] = ids
    return out


def phase_observe_train():
    """Fused bf16 BERT-base (batch 32, ``bert15``) through the pipelined
    window with the observability plane on: the budget gate at 0.9 and
    ``on_compile``'s record (estimate against the allocator's reading);
    OBSERVE_STEPS steps with phase attribution on, then off, from one
    state (losses bit-equal, every step a replay launching B1 24 times,
    each drained step's four buckets summing to its wall); the split
    again under a SLOW_FEED_S host feed (input wait takes it); one
    injected slow step under ``FLAGS_prof_trigger_ratio=2`` (one
    capture, its trace holding ``flash_fwd_mma_kernel`` kernel events,
    its bundle ``phases.json``); a feed stalled on the card past
    ``FLAGS_stall_timeout_s=2`` (one bundle naming the blocked thread,
    the allocator's figures in ``memory.json``, rendered by
    ``tools/postmortem.py``); and a budget no program fits (raises
    before B1 launches)."""
    import shutil

    from paddle_tpu_torch.ckpt import restore_scope, snapshot_scope
    from paddle_tpu_torch.observe import (health, phases, profiler_capture,
                                          xla_stats)

    b = bert15()
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="observe_")
    quench_slo_burn()
    flags.set_flags({"device_peak_tflops": OBSERVE_PEAK_TFLOPS,
                     "hbm_budget_fraction": 0.9, "postmortem_dir": tmp})
    try:
        exe = pt.Executor()
        scope = bert15_scope(exe)
        start = snapshot_scope(scope)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats()
        xla_stats.clear_compile_records()
        exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
        torch.cuda.synchronize()
        rec = xla_stats.last_compile()
        memory = dict(
            estimated_bytes=rec["estimated_bytes"],
            allocator_total_bytes=rec["memory"]["total_bytes"],
            breakdown=rec["memory"], budget=rec["budget"],
            compile_seconds=rec["compile_seconds"],
            measured_peak_bytes=torch.cuda.max_memory_allocated(dev),
            measured_peak_above_start_bytes=(
                torch.cuda.max_memory_allocated(dev) - base))
        if rec["budget"]["verdict"] != "pass":
            raise RuntimeError(f"observe_train: budget 0.9: {rec}")

        runs = {}
        for on in (True, False):
            flags.set_flags({"phase_attribution": on})
            restore_scope(scope, start)
            phases.reset_phases()
            (losses, ms), splits = recorded_splits(
                lambda: check_replays_and_b1(
                    f"observe_train attribution {on}",
                    lambda: bert15_steps(exe, scope, 1, OBSERVE_STEPS, 2),
                    OBSERVE_STEPS))
            runs[on] = dict(losses=losses, ms=ms, splits=splits,
                            report=phases.phases_report())
        flags.set_flags({"phase_attribution": True})
        on = runs[True]
        sum_err = max(abs(sum(s.values()) - w) / w for w, s in on["splits"])
        report = on["report"]

        restore_scope(scope, start)
        phases.reset_phases()
        _l, slow_ms = bert15_steps(exe, scope, 1, SLOW_FEED_STEPS, 2,
                                   sleep=SLOW_FEED_S)
        slow = phases.phases_report()
        slow_wait_s = slow["measured_s"]["input_wait"] / slow["steps"]

        # one injected slow step: one capture of at most prof_capture_s
        profiler_capture.reset_capture()
        flags.set_flags({"prof_trigger_ratio": 2.0,
                         "prof_capture_s": OBSERVE_CAPTURE_S,
                         "prof_cooldown_s": 60.0})
        p50 = float(np.median(on["ms"][2:])) / 1e3
        eng = profiler_capture.capture_engine()
        b1 = fab.flash_attention_bias.launches
        k = 1

        def step(sleep=0.0):
            nonlocal k
            time.sleep(sleep)      # the loader's host time for the batch
            exe.run(b["main"], feed=b["feeds"][k % 4],
                    fetch_list=[b["loss"]], scope=scope)
            k += 1

        for _ in range(14):   # the baseline
            step()
        step(OBSERVE_SPIKE_X * p50)      # drained two dispatches later
        t_fire = time.monotonic()
        while (eng.captures == 0 or eng._capture_thread.is_alive()) and \
                time.monotonic() - t_fire < 60:
            step()
        exe.drain()
        finished = eng.wait(60)
        flags.set_flags({"prof_trigger_ratio": 0.0})
        if not finished or eng.captures != 1 or len(eng.bundles) != 1:
            raise RuntimeError(f"observe_train: {eng.captures} captures, "
                               f"bundles {eng.bundles}")
        bundle = eng.bundles[0]
        meta = json.load(open(os.path.join(bundle, "meta.json")))
        prof = meta["extra"]["profiler"]
        if "error" in prof or not prof.get("trace_events"):
            raise RuntimeError(f"observe_train: the capture traced "
                               f"nothing: {prof}")
        traces = trace_files(prof["dir"])
        n_kernels, n_flash, n_cpu = trace_kernels(traces[0],
                                                  "flash_fwd_mma_kernel")
        capture = dict(trigger=meta["extra"]["trigger"], profiler=prof,
                       kernel_events=n_kernels, flash_fwd_events=n_flash,
                       cpu_op_events=n_cpu,
                       b1_launches_in_window=fab.flash_attention_bias
                       .launches - b1, steps_after_spike=k - 16,
                       phases_json=os.path.isfile(
                           os.path.join(bundle, "phases.json")))
        if not n_flash or not capture["phases_json"]:
            raise RuntimeError(f"observe_train: capture {capture}")

        # a feed stalled on the card past the watchdog's timeout
        flags.set_flags({"stall_timeout_s": 2.0})
        wd = health.maybe_start_watchdog()
        err, t_stall = [], []

        def stall_loop():
            try:
                for step in range(1, 5):
                    feed = b["feeds"][step % 4]
                    if step == 2:
                        feed = stalled_feed(feed, OBSERVE_STALL_S, dev)
                        t_stall.append(time.time())
                    exe.run(b["main"], feed=feed, fetch_list=[b["loss"]],
                            scope=scope)
                exe.drain()
            except Exception as e:  # noqa: BLE001 - reported below
                err.append(e)

        loop = threading.Thread(target=stall_loop, name="observe-stall-loop")
        loop.start()
        loop.join(120)
        time.sleep(2 * wd.poll_s)
        health.stop_watchdog()
        flags.set_flags({"stall_timeout_s": 0.0})
        if err or loop.is_alive() or len(wd.bundles) != 1:
            raise RuntimeError(f"observe_train: stall: errors {err}, "
                               f"bundles {wd.bundles}")
        stall = wd.bundles[0]
        stacks = open(os.path.join(stall, "stacks.txt")).read()
        mem = json.load(open(os.path.join(stall, "memory.json")))
        render = subprocess.run(
            [sys.executable, "tools/postmortem.py", stall],
            capture_output=True, text=True, timeout=60)
        stall_report = dict(
            bundle_after_s=json.load(open(os.path.join(
                stall, "meta.json")))["ts"] - t_stall[0],
            names_thread="observe-stall-loop" in stacks,
            device_memory=mem["device_memory"],
            compiles_recorded=len(mem["compiles"]),
            postmortem_rc=render.returncode,
            postmortem_lines=len(render.stdout.splitlines()))
        if not stall_report["names_thread"] or not mem["device_memory"] \
                or render.returncode != 0:
            raise RuntimeError(f"observe_train: stall bundle "
                               f"{stall_report}: {render.stderr[-2000:]}")

        # a budget nothing fits: rejected at the key's first run
        flags.set_flags({"hbm_budget_fraction": 1e-6})
        fab.reset_launch_count()
        captures = stat_get("cuda_graph_captures")
        exe2 = pt.Executor()
        try:
            exe2.run(b["main"], feed=b["feeds"][0], fetch_list=[b["loss"]],
                     scope=scope)
            raise RuntimeError("observe_train: budget 1e-6 did not reject")
        except xla_stats.MemoryBudgetError as e:
            rejected = dict(required_bytes=e.required_bytes,
                            budget_bytes=e.budget_bytes,
                            capacity_bytes=e.capacity_bytes,
                            top=e.attribution[0]["name"],
                            b1_launches=fab.flash_attention_bias.launches,
                            captures=stat_get("cuda_graph_captures")
                            - captures, cached=len(exe2._cache))
        if rejected["b1_launches"] or rejected["captures"] or \
                rejected["cached"]:
            raise RuntimeError(f"observe_train: rejection {rejected}")
        exe2.close()
    finally:
        flags.set_flags({"device_peak_tflops": 0.0, "phase_attribution": True,
                         "hbm_budget_fraction": 0.0, "stall_timeout_s": 0.0,
                         "prof_trigger_ratio": 0.0,
                         "postmortem_dir": "postmortem"})
        health.stop_watchdog()
        shutil.rmtree(tmp, ignore_errors=True)
    on_p50 = float(np.median(on["ms"][2:]))
    off_p50 = float(np.median(runs[False]["ms"][2:]))
    log("observe_train", steps=OBSERVE_STEPS, memory=memory,
        attributed_steps=report["steps"],
        measured_fractions=report["measured_fractions"],
        measured_s=report["measured_s"],
        predicted=report["predicted"]["predicted_fractions"],
        predicted_compute_ms=report["predicted"]["compute_s"] * 1e3,
        flops_per_step=report["predicted"]["flops_per_step"],
        bucket_sum_max_rel_err=sum_err, tolerance=OBSERVE_SUM_RTOL,
        step_p50_ms_attribution_on=on_p50,
        step_p50_ms_attribution_off=off_p50,
        losses_equal=on["losses"] == runs[False]["losses"],
        slow_feed_s=SLOW_FEED_S,
        slow_feed_fractions=slow["measured_fractions"],
        slow_feed_input_wait_s_a_step=slow_wait_s,
        slow_feed_step_p50_ms=float(np.median(slow_ms[2:])),
        capture=capture, stall=stall_report, rejected=rejected)
    if sum_err > OBSERVE_SUM_RTOL or on["losses"] != runs[False]["losses"] \
            or report["steps"] != OBSERVE_STEPS \
            or runs[False]["report"]["steps"] != 0 \
            or slow_wait_s < 0.9 * SLOW_FEED_S:
        raise RuntimeError("observe_train: attribution checks failed")
    exe.close()


def phase_observe_profiler():
    """``profiler.profiler(profile_path=...)`` around OBSERVE_PROFILE_STEPS
    fused BERT-base steps, then ``profiler.cuda_profiler()`` (its
    default directory from ``PADDLE_TPU_PROFILE_DIR``) around as many:
    each writes a Chrome trace whose kernel events hold
    ``flash_fwd_mma_kernel``."""
    import shutil

    from paddle_tpu_torch import profiler

    exe = pt.Executor()
    scope = bert15_scope(exe)
    b = bert15()
    exe.warmup(b["main"], [b["feeds"][0]], [b["loss"]], scope)
    tmp = tempfile.mkdtemp(prefix="observe_profiler_")
    old = os.environ.get("PADDLE_TPU_PROFILE_DIR")
    os.environ["PADDLE_TPU_PROFILE_DIR"] = os.path.join(tmp, "cuda")
    out = {}
    try:
        with profiler.profiler(profile_path=os.path.join(tmp, "profiler")):
            bert15_steps(exe, scope, 1, OBSERVE_PROFILE_STEPS, 2)
        with profiler.cuda_profiler():
            bert15_steps(exe, scope, 1, OBSERVE_PROFILE_STEPS, 2)
        for kind in ("profiler", "cuda"):
            files = trace_files(os.path.join(tmp, kind))
            n, flash, cpu = trace_kernels(files[0], "flash_fwd_mma_kernel")
            out[kind] = dict(files=len(files), kernel_events=n,
                             flash_fwd_events=flash, cpu_op_events=cpu,
                             bytes=os.path.getsize(files[0]))
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_PROFILE_DIR", None)
        else:
            os.environ["PADDLE_TPU_PROFILE_DIR"] = old
        shutil.rmtree(tmp, ignore_errors=True)
        exe.close()
    log("observe_profiler", steps=OBSERVE_PROFILE_STEPS, **out)
    if any(r["flash_fwd_events"] < B1_PER_STEP * OBSERVE_PROFILE_STEPS // 2
           for r in out.values()):
        raise RuntimeError(f"observe_profiler: {out}")


def http_get(port, path):
    """(status, content type, body) of GET ``path`` on 127.0.0.1."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def prometheus_series(text):
    """The series names of a Prometheus text exposition (histogram
    suffixes folded into their family); raises on a malformed line."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        name = name.split("{", 1)[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and f"# TYPE {name[:-len(suffix)]} " \
                    f"histogram" in text:
                name = name[:-len(suffix)]
        names.add(name)
    return names


def phase_observe_serve(model_dir):
    """The README's serve model (B5/B6) behind ``DecodeServer(http_port=0)``:
    OBSERVE_REQUESTS greedy requests; every route answers 200 with JSON
    or Prometheus text that parses, every ``/metrics`` series has a rule
    in the port's catalog, a ``HealthReporter`` heartbeat to the server's
    KV shows rank 0 alive on ``/metrics/cluster``, and the tokens equal a
    server's without HTTP.  Then the one-shot ``Server(http_port=0)`` over
    the int8 BERT-base ``Predictor`` (B7 74 and B1 float32 12 a batch)
    answers ``/stats`` and ``/health``."""
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.observe import health, metrics_catalog

    dev = torch.device("cuda", 0)
    model = TransformerLM(**SERVE_MODEL, device=dev)
    weights = model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(19)
    prompts = [rng.randint(1, 32000, int(n)).tolist()
               for n in rng.randint(16, 400, OBSERVE_REQUESTS)]
    cfg = DecodeConfig(slots=8, max_seq_len=1024, page_size=16)
    tokens, routes = {}, {}
    for http in (True, False):
        srv = DecodeServer(model, weights, cfg,
                           http_port=0 if http else None).start()
        try:
            pa.reset_launch_counts()
            reqs = [srv.submit(p, max_new_tokens=OBSERVE_NEW_TOKENS)
                    for p in prompts]
            tokens[http] = [r.result(timeout=120) for r in reqs]
            if not http:
                continue
            launches = {"b5": pa.paged_decode_attention.launches,
                        "b6": pa.paged_chunk_attention.launches}
            port = srv.http_port
            health.serve_cluster_health(srv._kv, world_size=1)
            reporter = health.HealthReporter(f"127.0.0.1:{port}", rank=0,
                                             world_size=1)
            beat = reporter.publish_once()
            for path in ("/stats", "/health", "/metrics", "/debug/requests",
                         f"/debug/request/{reqs[0].trace.trace_id}",
                         "/debug/slo", "/metrics/cluster"):
                code, ctype, body = http_get(port, path)
                if path == "/metrics":
                    series = prometheus_series(body.decode())
                    undocumented = sorted(
                        n for n in series if metrics_catalog.lookup(
                            n[len("paddle_tpu_"):]) is None)
                    routes[path] = dict(code=code, type=ctype,
                                        series=len(series),
                                        undocumented=undocumented)
                else:
                    doc = json.loads(body)
                    routes[path] = dict(code=code, type=ctype,
                                        keys=len(doc))
            cluster = json.loads(http_get(port, "/metrics/cluster")[2])
        finally:
            srv.stop()
    del model, weights
    bad = [p for p, r in routes.items() if r["code"] != 200]
    if bad or routes["/metrics"]["undocumented"] or not beat or \
            cluster["alive_ranks"] != 1 or cluster["dead_ranks"] or \
            tokens[True] != tokens[False] or \
            not launches["b5"] or not launches["b6"] or \
            launches["b5"] % 8 or launches["b6"] % 8:
        raise RuntimeError(f"observe_serve: routes {routes}, beat {beat}, "
                           f"cluster {cluster}, launches {launches}, "
                           f"tokens equal {tokens[True] == tokens[False]}")

    flags.set_flags({"weight_quant": "int8", "flash_attention": "always"})
    try:
        icfg = inference.Config(model_dir)
        icfg.enable_tpu(0)
        one = serving.Server(icfg, serving.ServingConfig(
            batch_sizes=(1,), batch_window_ms=1, http_port=0))
        one.start()
        try:
            zero_kernel_launches()
            batches = stat_get("serving_batches")
            outs = [one.infer(infer_feed(1, seed=1900 + i))
                    for i in range(OBSERVE_ONESHOT)]
            batches = stat_get("serving_batches") - batches
            oneshot = dict(batches=batches, launches_b7_b1=[
                qo.dequant_matmul.launches,
                fab.flash_attention_bias.launches])
            for path in ("/stats", "/health"):
                code, ctype, body = http_get(one.http_port, path)
                oneshot[path] = dict(code=code, type=ctype,
                                     keys=len(json.loads(body)))
        finally:
            one.stop()
    finally:
        flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
    finite = all(np.isfinite(np.asarray(o)).all() for out in outs
                 for o in out)
    log("observe_serve", requests=OBSERVE_REQUESTS,
        new_tokens=OBSERVE_NEW_TOKENS, routes=routes, heartbeat=beat,
        cluster_alive_ranks=cluster["alive_ranks"],
        cluster_dead_ranks=cluster["dead_ranks"],
        tokens_equal_http_on_off=tokens[True] == tokens[False],
        launches=launches, oneshot=oneshot, oneshot_outputs_finite=finite)
    if oneshot["launches_b7_b1"] != [B7_PER_RUN * batches,
                                     B1_PER_RUN * batches] or not finite \
            or any(oneshot[p]["code"] != 200 for p in ("/stats", "/health")):
        raise RuntimeError(f"observe_serve: one-shot server {oneshot}")


# ---- slice 24: scan-over-layers and the one-process CTR path -------------

LS_STEPS = 10            # timed replays of each layer_scan_train run
LS_POLICY_STEPS = 6      # steps of the policy-only ERNIE run
LS_INFER_RUNS = 20       # timed runs of each layer_scan_infer predictor
LS_INFER_RTOL = 1e-3     # scanned vs unscanned int8 outputs, relative
SCAN_STATS = ("pass_layer_scan_segments", "pass_layer_scan_layers",
              "pass_layer_scan_skipped")
# bench.py's DLRM sizes (bench_dlrm) over Criteo's layout: 13 dense
# floats, 26 categorical ids, one click label
REC = dict(batch=256, vocab=65_536, emb=32, fields=26, dense=13,
           hidden=(128, 64), lr=1e-2, steps=10, mb=100, fallback_mb=2)
REC_ORACLE_TOL = 1e-4    # step 1's loss, card against CPU, float32
REC_SLOTS = (("dense", "f", 13), ("ids", "u", 26), ("label", "u", 1))


def reset_scan_stats():
    for k in SCAN_STATS:
        stat_reset(k)


def scan_stats():
    return {k[len("pass_layer_scan_"):]: stat_get(k) for k in SCAN_STATS}


def rewritten(exe, main):
    """The pass-rewritten program the executor runs for ``main``."""
    fp = main.fingerprint()
    return next(p for k, p in exe._pass_cache.items() if k[0] == fp)


def trajectory_gap(a, b):
    """(bit-equal, first step apart (1-based) or None, max relative gap)
    of two loss lists."""
    first = next((i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None)
    gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    return a == b, first, gap


def ls_bert_run(main, loss, init, feed, scan):
    """BERT-base from the device state ``init``: the eager warm-up, the
    capture, LS_STEPS timed replays (B1 counted); returns the executor,
    the scope and the run's figures."""
    flags.set_flags({"layer_scan": scan})
    exe = pt.Executor()
    scope = pt.framework.Scope()
    for n, v in init.items():
        scope.set_var(n, v.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].ravel()[0])]
    warm_s = time.perf_counter() - t0
    captures = stat_get("cuda_graph_captures")
    t0 = time.perf_counter()
    losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].ravel()[0]))
    capture_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if stat_get("cuda_graph_captures") != captures + 1:
        raise RuntimeError(f"layer_scan_train (scan={scan}): the second run "
                           f"did not capture")
    fab.reset_launch_count()    # this run's count starts here
    replays = stat_get("cuda_graph_replays")
    step_ms = []
    for _ in range(LS_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        losses.append(float(out.ravel()[0]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fab.flash_attention_bias.launches
    replays = stat_get("cuda_graph_replays") - replays
    if replays != LS_STEPS or launches != B1_PER_STEP * LS_STEPS:
        raise RuntimeError(f"layer_scan_train (scan={scan}): B1 launched "
                           f"{launches} times in {LS_STEPS} steps "
                           f"({replays} replays), want {B1_PER_STEP} a "
                           f"step, each a replay")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"layer_scan_train (scan={scan}): a loss is not "
                           f"finite: {losses}")
    prog = rewritten(exe, main)
    plan = getattr(prog, "_layer_plan", None)
    return exe, scope, dict(
        losses=losses, step_ms_p50=float(np.median(step_ms)),
        step_ms=step_ms, warm_s=warm_s, capture_s=capture_s,
        peak_memory_gb=peak, b1_launches=launches,
        b1_launches_per_step=launches / LS_STEPS, replays=replays,
        program_ops=len(prog.global_block.ops),
        layer_scan_ops=sum(op.type == "layer_scan"
                           for op in prog.global_block.ops),
        carriers=len(plan.stacks) if plan is not None else 0)


def phase_layer_scan_train():
    """BERT-base (bf16 AMP, batch 32, dropout 0.1, B1) unrolled, then
    scanned under FLAGS_layer_scan=1 from one startup state: both loss
    trajectories, B1 24 a step in both; the scanned scope's checkpoint,
    restored into an unrolled executor, continues as the scanned run."""
    from paddle_tpu_torch.ckpt import restore_scope, snapshot_scope

    flags.set_flags({"flash_attention": "always"})
    try:
        main, startup, loss = build_bert(TRAIN_BATCH, amp=True, dropout=0.1)
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        init = {n: v.detach().clone() for n, v in scope._vars.items()
                if isinstance(v, torch.Tensor)}
        exe.close()
        del exe, scope
        feed = bert_feed(TRAIN_BATCH, seed=0)
        exe, scope, unrolled = ls_bert_run(main, loss, init, feed, False)
        exe.close()
        del exe, scope
        release("layer_scan_unrolled")
        reset_scan_stats()
        exe, scope, scanned = ls_bert_run(main, loss, init, feed, True)
        stats = scan_stats()
        del init
        if not stats["segments"] or not scanned["carriers"]:
            raise RuntimeError(f"layer_scan_train: the pass scanned nothing: "
                               f"{stats}")
        # the checkpoint crosses from the scanned run to an unrolled one
        snap = snapshot_scope(scope)
        stacked = [k for k in snap
                   if k.startswith(passes.LAYER_STACK_PREFIX)]
        if stacked:
            raise RuntimeError(f"layer_scan_train: carriers in the "
                               f"checkpoint: {stacked[:3]}")
        next_scanned = float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0].ravel()[0])
        exe.close()
        del exe, scope
        flags.set_flags({"layer_scan": False})
        exe = pt.Executor()
        scope = pt.framework.Scope()
        restore_scope(scope, snap)
        del snap
        next_unrolled = float(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0].ravel()[0])
        exe.close()
        del exe, scope
    finally:
        flags.set_flags({"layer_scan": False, "flash_attention": "auto"})
    bit_equal, first_apart, gap = trajectory_gap(scanned["losses"],
                                                 unrolled["losses"])
    ckpt_gap = abs(next_unrolled - next_scanned) / abs(next_scanned)
    log("layer_scan_train", model="bert-base", batch=TRAIN_BATCH, seq=128,
        amp="bfloat16", dropout=0.1, steps=LS_STEPS,
        min_layers=flags.flag("layer_scan_min_layers"),
        pass_layer_scan=stats, user_program_ops=len(main.global_block.ops),
        unrolled=unrolled, scanned=scanned,
        trajectories_bit_equal=bit_equal, first_step_apart=first_apart,
        max_rel_gap=gap, tolerance=ERNIE_TRAJ_RTOL,
        ckpt_next_step_scanned=next_scanned,
        ckpt_next_step_unrolled=next_unrolled, ckpt_rel_gap=ckpt_gap)
    if not (bit_equal or gap <= ERNIE_TRAJ_RTOL):
        raise RuntimeError(f"layer_scan_train: scanned and unrolled part "
                           f"by {gap} > {ERNIE_TRAJ_RTOL} (first at step "
                           f"{first_apart})")
    if not (next_unrolled == next_scanned or ckpt_gap <= ERNIE_TRAJ_RTOL):
        raise RuntimeError(f"layer_scan_train: the restored unrolled step "
                           f"{next_unrolled} is not the scanned run's "
                           f"{next_scanned}")


def phase_layer_scan_recompute():
    """ERNIE-1.0 (amp + recompute, B1) with recompute_configs
    scan_layers=12 from ernie_fleet's initial state, held to its
    recompute run's trajectory; then policy only under
    FLAGS_layer_scan=1."""
    flags.set_flags({"flash_attention": "always"})
    init, ref = ERNIE_STATE["init"], ERNIE_STATE["recompute"]
    feed = ernie_feed()
    try:
        prog = ernie_program(amp=True, recompute=True,
                             scan_layers=ERNIE["layers"])
        stamped = sum(op.has_attr(passes.LAYER_SCAN_ATTR)
                      for op in prog["main"].global_block.ops)
        reset_scan_stats()
        rc, _ = ernie_train(prog, init, feed, ERNIE_STEPS,
                            B1_PER_RECOMPUTE_STEP, "layer_scan_recompute",
                            eager=False)
        stats = scan_stats()
        del prog
        release("layer_scan_scan_layers")
        flags.set_flags({"layer_scan": True})
        pprog = ernie_program(amp=True, recompute=True,
                              policy="dots_saveable")
        reset_scan_stats()
        pol, _ = ernie_train(pprog, init, feed, LS_POLICY_STEPS,
                             B1_PER_RECOMPUTE_STEP,
                             "layer_scan_recompute_policy", eager=False)
        pstats = scan_stats()
        del pprog
    finally:
        flags.set_flags({"layer_scan": False, "flash_attention": "auto"})
        ERNIE_STATE.clear()
    bit_equal, first_apart, gap = trajectory_gap(rc["losses"], ref["losses"])
    pbit, pfirst, pgap = trajectory_gap(
        pol["losses"], ref["losses"][:LS_POLICY_STEPS])
    log("layer_scan_recompute", model="ernie-1.0 finetune",
        steps=ERNIE_STEPS, scan_layers=ERNIE["layers"],
        optimizer_ops_stamped=stamped, pass_layer_scan=stats,
        scan_layers_run=rc, ernie_fleet_recompute_peak_gb=ref[
            "peak_memory_gb"], ernie_fleet_recompute_step_ms_p50=ref[
            "step_ms_p50"], trajectories_bit_equal=bit_equal,
        first_step_apart=first_apart, max_rel_gap=gap,
        policy_only=dict(policy="dots_saveable", steps=LS_POLICY_STEPS,
                         pass_layer_scan=pstats, bit_equal=pbit,
                         first_step_apart=pfirst, max_rel_gap=pgap, **pol),
        tolerance=ERNIE_TRAJ_RTOL)
    for label, st in (("scan_layers", stats), ("policy", pstats)):
        if not st["segments"]:
            raise RuntimeError(f"layer_scan_recompute ({label}): the pass "
                               f"scanned nothing: {st}")
    if not (bit_equal or gap <= ERNIE_TRAJ_RTOL):
        raise RuntimeError(f"layer_scan_recompute: scan_layers and "
                           f"ernie_fleet's recompute part by {gap} > "
                           f"{ERNIE_TRAJ_RTOL} (first at step {first_apart})")
    if not (pbit or pgap <= ERNIE_TRAJ_RTOL):
        raise RuntimeError(f"layer_scan_recompute: the policy-only run and "
                           f"ernie_fleet's recompute part by {pgap}")


def phase_layer_scan_infer():
    """The int8 BERT-base + NSP model through ``Predictor`` at batch 32,
    unscanned and under FLAGS_layer_scan=1: B7 74 and B1 12 a run in
    both, B7 reading the stacked int8 carriers; outputs compared."""
    from paddle_tpu_torch import inference

    feed = infer_feed(32, seed=32)
    res, outs = {}, {}
    flags.set_flags({"flash_attention": "always"})
    try:
        with tempfile.TemporaryDirectory() as tmp:
            model_dir = os.path.join(tmp, "bert_base")
            main_prog, startup, seq_out, nsp_logits = build_bert_inference()
            exe = pt.Executor()
            scope = pt.framework.Scope()
            exe.run(startup, scope=scope)
            with pt.fluid.scope_guard(scope):
                pt.fluid.io.save_inference_model(
                    model_dir, list(INFER_FEEDS), [seq_out, nsp_logits],
                    exe, main_prog)
            exe.close()
            del exe, scope
            flags.set_flags({"weight_quant": "int8"})
            for scan in (False, True):
                flags.set_flags({"layer_scan": scan})
                reset_scan_stats()
                pred = inference.create_predictor(
                    inference.Config(model_dir))
                t0 = time.perf_counter()
                pred.run(feed)
                pred.run(feed)            # the warm-up, then the capture
                torch.cuda.synchronize()
                warm_capture_s = time.perf_counter() - t0
                stats = scan_stats()
                qo.reset_launch_count()   # this run's counts start here
                fab.reset_launch_count()
                replays = stat_get("cuda_graph_replays")
                ms = []
                for _ in range(LS_INFER_RUNS):
                    t0 = time.perf_counter()
                    out = pred.run(feed)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                launches = (qo.dequant_matmul.launches,
                            fab.flash_attention_bias.launches)
                replays = stat_get("cuda_graph_replays") - replays
                want = (B7_PER_RUN * LS_INFER_RUNS,
                        B1_PER_RUN * LS_INFER_RUNS)
                if launches != want or replays != LS_INFER_RUNS:
                    raise RuntimeError(
                        f"layer_scan_infer (scan={scan}): B7/B1 launched "
                        f"{launches} times in {LS_INFER_RUNS} runs "
                        f"({replays} replays), want {want}")
                wq = {n: (tuple(v.shape), str(v.dtype)[6:])
                      for n, v in pred._scope._vars.items()
                      if n.startswith(passes.LAYER_STACK_PREFIX)
                      and "@WQ" in n}
                if scan and (not stats["segments"] or not wq or any(
                        s[0] != BERT_LAYERS for s, _ in wq.values())):
                    raise RuntimeError(f"layer_scan_infer: no stacked int8 "
                                       f"carriers of {BERT_LAYERS} layers: "
                                       f"{stats} {wq}")
                outs[scan] = [np.asarray(o) for o in out]
                res["scanned" if scan else "unscanned"] = dict(
                    run_ms_p50=float(np.median(ms)), run_ms=ms,
                    warm_capture_s=warm_capture_s,
                    launches_b7_b1=list(launches),
                    launches_per_run=[n / LS_INFER_RUNS for n in launches],
                    replays=replays, pass_layer_scan=stats,
                    stacked_wq_carriers=len(wq),
                    stacked_wq_shapes=sorted(set(wq.values()))[:4])
                pred._exe.close()
                del pred
    finally:
        flags.set_flags({"layer_scan": False, "weight_quant": "",
                         "flash_attention": "auto"})
    bit_equal = all(np.array_equal(a, b)
                    for a, b in zip(outs[True], outs[False]))
    gap = max_gap(outs[True], outs[False], True)
    for o in outs[True]:
        if not np.isfinite(o).all():
            raise RuntimeError("layer_scan_infer: outputs not finite")
    log("layer_scan_infer", model="bert-base encoder + nsp head, int8",
        batch=32, seq=128, runs=LS_INFER_RUNS, outputs_bit_equal=bit_equal,
        max_rel_gap=gap, tolerance=LS_INFER_RTOL, **res)
    if not (bit_equal or gap <= LS_INFER_RTOL):
        raise RuntimeError(f"layer_scan_infer: scanned vs unscanned outputs "
                           f"apart by {gap} > {LS_INFER_RTOL}")


def rec_text(path, mb, seed):
    """About ``mb`` MB of MultiSlot text at Criteo's layout, from a seed:
    a line is 13 dense features (``d.dddd``: log(1 + count), exponential
    with mean 1.5, capped below 10), 26 categorical ids hashed into the
    vocabulary (5 digits; 4 % missing, id 0, the padding row) and a
    click label (25 % positive).  Returns (lines, bytes)."""
    rng = np.random.RandomState(seed)
    d, f = REC["dense"], REC["fields"]
    line = 3 + d * 7 + 3 + f * 6 + 2 + 2
    per_block = 1 << 16
    lines = 0
    with open(path, "wb") as out:
        while lines * line < mb * 1e6:
            n = per_block
            buf = np.full((n, line), ord(" "), np.uint8)
            buf[:, 0:2] = np.frombuffer(b"13", np.uint8)
            dense = np.minimum(rng.exponential(1.5, (n, d)) * 1e4,
                               99_999).astype(np.int64)
            for j in range(d):
                o = 3 + 7 * j
                buf[:, o] = 48 + dense[:, j] // 10_000
                buf[:, o + 1] = ord(".")
                for k, div in enumerate((1_000, 100, 10, 1)):
                    buf[:, o + 2 + k] = 48 + dense[:, j] // div % 10
            o = 3 + d * 7
            buf[:, o:o + 2] = np.frombuffer(b"26", np.uint8)
            ids = rng.randint(1, REC["vocab"], (n, f))
            ids[rng.rand(n, f) < 0.04] = 0
            for j in range(f):
                p = o + 3 + 6 * j
                for k, div in enumerate((10_000, 1_000, 100, 10, 1)):
                    buf[:, p + k] = 48 + ids[:, j] // div % 10
            p = o + 3 + 6 * f
            buf[:, p] = ord("1")
            buf[:, p + 2] = 48 + (rng.rand(n) < 0.25)
            buf[:, -1] = ord("\n")
            out.write(buf.tobytes())
            lines += n
    return lines, lines * line


def wide_deep(place):
    from paddle_tpu_torch.rec import wide_deep_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = wide_deep_program(
            batch_size=REC["batch"], vocab_size=REC["vocab"],
            emb_dim=REC["emb"], n_fields=REC["fields"],
            n_dense=REC["dense"], hidden=REC["hidden"], padding_idx=0,
            sparse=True, lr=REC["lr"])
        with program_guard(main, startup):
            opt.minimize(loss)
    return main, startup, loss


def rec_feed(batch):
    return {"sparse_ids": batch["ids"][0].astype("int64"),
            "dense_x": batch["dense"][0],
            "labels": batch["label"][0].astype("int64")}


def phase_rec_data_feed():
    """Criteo-layout MultiSlot text through ``io.MultiSlotDataFeed`` (the
    native parser, and the Python fallback on a slice), then
    ``rec.wide_deep_program`` (sparse tables, padding 0) 10 steps at
    batch 256 on the card, captured; step 1 against the CPU."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch import native as tnative

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "part-00000")
        t0 = time.perf_counter()
        n_lines, n_bytes = rec_text(path, REC["mb"], seed=24)
        write_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = f.read()
    feed = tio.MultiSlotDataFeed(REC_SLOTS, REC["batch"])
    if not tnative.has_native():
        raise RuntimeError("rec_data_feed: the native MultiSlot parser did "
                           "not build")
    fallbacks = stat_get("data_feed_parse_fallback")
    t0 = time.perf_counter()
    n, parsed = feed.parse(data)
    native_s = time.perf_counter() - t0
    if stat_get("data_feed_parse_fallback") != fallbacks or n != n_lines:
        raise RuntimeError(f"rec_data_feed: the native parser did not run "
                           f"({n} of {n_lines} lines)")
    cut = data.index(b"\n", int(REC["fallback_mb"] * 1e6)) + 1
    t0 = time.perf_counter()
    m, py = tnative._parse_multislot_py(data[:cut], feed.types)
    fallback_s = time.perf_counter() - t0
    for (a, la), (b, lb) in zip(py, parsed):
        if not (np.array_equal(a, b[:len(a)]) and np.array_equal(
                la, lb[:m + 1])):
            raise RuntimeError("rec_data_feed: the Python fallback and the "
                               "native parser disagree")
    del data
    batches = []
    for b in feed._batches(n, parsed):
        batches.append(rec_feed(b))
        if len(batches) == REC["steps"]:
            break
    del parsed
    main, startup, loss = wide_deep(None)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    init = {k: v.detach().cpu().clone() for k, v in scope._vars.items()
            if isinstance(v, torch.Tensor)}
    sparse0 = stat_get("emb_sparse_fallback_dense")
    captures = stat_get("cuda_graph_captures")
    replays = stat_get("cuda_graph_replays")
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
        losses.append(float(out.ravel()[0]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    sparse = stat_get("emb_sparse_fallback_dense") - sparse0
    captures = stat_get("cuda_graph_captures") - captures
    replays = stat_get("cuda_graph_replays") - replays
    exe.close()
    if captures != 1 or replays != REC["steps"] - 1:
        raise RuntimeError(f"rec_data_feed: {captures} captures and "
                           f"{replays} replays in {REC['steps']} steps")
    cexe = pt.Executor(pt.CPUPlace())
    cscope = pt.framework.Scope()
    for k, v in init.items():
        cscope.set_var(k, v)
    cpu_loss = float(cexe.run(main, feed=batches[0], fetch_list=[loss],
                              scope=cscope)[0].ravel()[0])
    cexe.close()
    gap = abs(losses[0] - cpu_loss)
    p50 = float(np.median(step_ms[2:]))
    log("rec_data_feed", model="wide&deep (bench.py DLRM sizes)",
        batch=REC["batch"], vocab=REC["vocab"], emb=REC["emb"],
        fields=REC["fields"], dense=REC["dense"], hidden=list(REC["hidden"]),
        lines=n_lines, mb=n_bytes / 1e6, write_s=write_s,
        native_parse_s=native_s, native_parse_mb_s=n_bytes / 1e6 / native_s,
        fallback_parse_mb=cut / 1e6,
        fallback_parse_mb_s=cut / 1e6 / fallback_s,
        native_over_fallback=(n_bytes / native_s) / (cut / fallback_s),
        steps=REC["steps"], captures=captures, replays=replays,
        losses=losses, step_ms=step_ms, step_ms_p50_replays=p50,
        examples_per_s=REC["batch"] / (p50 / 1e3),
        emb_sparse_fallback_dense=sparse, step1_cpu_loss=cpu_loss,
        step1_gap=gap, tolerance=REC_ORACLE_TOL)
    if not all(math.isfinite(x) for x in losses) or not sparse:
        raise RuntimeError(f"rec_data_feed: losses {losses}, sparse "
                           f"lookups counted {sparse}")
    if not gap <= REC_ORACLE_TOL:
        raise RuntimeError(f"rec_data_feed: step 1 on the card {losses[0]} "
                           f"vs the CPU {cpu_loss}: {gap} > "
                           f"{REC_ORACLE_TOL}")


# ---- slice 25: fleet data parallel across processes --------------------------

# fleet_dp: BERT-base at two ranks, each on cuda:0 over gloo (the card is
# one device, and NCCL refuses two ranks on one device), a rank's batch
# 16 (32 global), FLEET_STEPS eager steps after the warm-up
FLEET_RANKS, FLEET_BATCH, FLEET_STEPS = 2, 16, 5
# fleet_dp_oracle: float32, dropout 0, 2 ranks x ORACLE_BATCH // 2 against
# one process at ORACLE_BATCH, 3 steps, held to ORACLE_RTOL
FLEET_ORACLE_STEPS = 3
# ... and their updates (p_3 - p_0) by parameter, each against one
# process's, within FLEET_UPDATE_RTOL norm-wise, leaving out the
# parameters whose step-1 gradient in one process is zero to rounding:
# its norm below FLEET_ZERO_GRAD of the largest parameter's (the
# attention key biases: a softmax is blind to a shift along its keys,
# and AdamW turns their rounding into an update of about lr).  A control
# run in one process on rank 0's half alone (the other rank's gradient
# left out) must miss the limit.  On an H100 (PERF.md §6): the
# sound runs' worst gap 1.7e-4, the control's least 0.10; the key biases'
# gradient shares <= 2.9e-10, the others' >= 2.0e-4.
FLEET_UPDATE_RTOL = 1e-3
FLEET_ZERO_GRAD = 1e-7
FLEET_CHILD_TIMEOUT_S = 300
# collective_capture: the ops of the hand-built program and its input
CAPTURE_OPS = ("c_allreduce_sum", "c_allgather", "c_broadcast",
               "c_reducescatter")
CAPTURE_SHAPE = (1024, 256)
FLEET_STATE = {}   # fleet_dp's ranks' results and the oracle's start
# fleet_zero: fleet_dp's bf16 path with strategy.sharding (ZeRO-1), a
# warm-up and ZERO_STEPS timed eager steps on each rank; fleet_localsgd:
# the same with strategy.localsgd at LOCALSGD_K, LOCALSGD_STEPS steps
ZERO_STEPS = 3
LOCALSGD_K, LOCALSGD_STEPS = 2, 4
# fleet_zero_oracle: ZeRO-1 against GradAllReduce at two ranks, bit for
# bit (the same gradient sums; AdamW is elementwise), else within this
# norm-wise
ZERO_PARAM_RTOL = 1e-6
ADAM_MOMENTS = ("Moment1", "Moment2")
# fleet_elastic: fleet_zero_oracle's float32 ZeRO-1 program under each
# rank's ElasticSupervisor for ELASTIC_STEPS steps, a checkpoint every
# ELASTIC_SAVE_EVERY; rank 1 leaves by os._exit(ELASTIC_EXIT) at the start
# of step ELASTIC_KILL.  Heartbeats every ELASTIC_HEARTBEAT_S (dead after
# three missed); the supervisor backs off ELASTIC_BACKOFF_S * 2^k.
ELASTIC_STEPS, ELASTIC_KILL, ELASTIC_SAVE_EVERY = 3, 3, 2
ELASTIC_EXIT = 86
ELASTIC_HEARTBEAT_S, ELASTIC_BACKOFF_S = 0.5, 0.5
# how long the ranks wait for each other's first heartbeat
ELASTIC_ALIVE_S = 60


def fleet_bert(batch, amp, dropout, lr, fuse=True, **on):
    """BERT-base pretraining at a rank's ``batch``, minimized through
    ``fleet`` (``strategy.amp``: bf16; ``on``: more strategy fields) as
    ``ernie_program`` builds its finetune: main, startup, loss and the
    applied chain's names."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import chain_names
    from paddle_tpu_torch.text import bert_base_pretrain_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = bert_base_pretrain_program(
            batch_size=batch, max_preds_per_seq=BERT_PREDS,
            dropout_prob=dropout, lr=lr, use_fused_attention=True)
        main.random_seed = 1
        strategy = fleet.DistributedStrategy()
        strategy.amp = amp
        strategy.fuse_all_reduce_ops = fuse
        for k, v in on.items():
            setattr(strategy, k, v)
        with program_guard(main, startup):
            fleet.init(is_collective=True, strategy=strategy)
            fleet.distributed_optimizer(opt, strategy)
            fleet.minimize(loss)
    return main, startup, loss, chain_names(
        fleet._fleet_singleton.applied_chain)


def bert_shard(feed, lo, hi):
    """Examples ``lo:hi`` of a ``bert_feed`` batch (their masked
    positions made local to the shard)."""
    seq, preds = feed["input_ids"].shape[1], BERT_PREDS
    flat = feed["masked_flat_pos"].reshape(-1, preds)[lo:hi] - lo * seq
    out = {k: feed[k][lo:hi] for k in ("input_ids", "token_type_ids",
                                       "pos_ids", "input_mask",
                                       "nsp_labels")}
    out.update(masked_flat_pos=flat.reshape(-1),
               masked_labels=feed["masked_labels"][lo * preds:hi * preds],
               masked_weights=feed["masked_weights"][lo * preds:hi * preds])
    return out


def param_names(main):
    return sorted(v.name for v in main.global_block.vars.values()
                  if getattr(v, "is_parameter", False))


def param_digest(scope, names):
    """A SHA-256 of every parameter's bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for n in names:
        h.update(scope.get_var(n).detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def tensors_digest(tensors):
    """A SHA-256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def rank_block_digests(scope, names):
    """For each of FLEET_RANKS starting ranks, the digest of its rows (a
    ZeRO-1 block) of every var in ``names``, in order."""
    out = []
    for r in range(FLEET_RANKS):
        blocks = []
        for n in names:
            v = scope.get_var(n)
            rows = v.shape[0] // FLEET_RANKS
            blocks.append(v[r * rows:(r + 1) * rows])
        out.append(tensors_digest(blocks))
    return out


def opt_state_bytes(main, scope):
    """The bytes of the AdamW moments ``scope`` holds for ``main``."""
    names = {n for op in main.global_block.ops if op.type in ("adam", "adamw")
             for slot in ADAM_MOMENTS for n in op.inputs.get(slot, ())}
    return sum(scope.get_var(n).numel() * scope.get_var(n).element_size()
               for n in names)


def comm_bytes():
    """The collectives' bytes so far, by ``torch.distributed`` call."""
    return {k: stat_get("comm_bytes_" + k)
            for k in ("all_reduce", "all_gather", "reduce_scatter")}


def timed_lowering(op_type):
    """Wrap ``op_type``'s lowering to add its synced seconds to the
    returned list's first item (calls to its second); returns it and the
    undo."""
    from paddle_tpu_torch.framework.lowering import LOWERINGS

    real, acc = LOWERINGS[op_type], [0.0, 0]

    def run(ctx, op):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(ctx, op)
        torch.cuda.synchronize()
        acc[0] += time.perf_counter() - t0
        acc[1] += 1

    LOWERINGS[op_type] = run
    return acc, lambda: LOWERINGS.__setitem__(op_type, real)


def wait_for_file(path):
    """Wait (FLEET_CHILD_TIMEOUT_S at most) for another process of this
    run to write ``path``."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > FLEET_CHILD_TIMEOUT_S:
            raise RuntimeError(f"{path} was not written in "
                               f"{FLEET_CHILD_TIMEOUT_S} s")
        time.sleep(0.1)


def fleet_rank_dp(tmp):
    """fleet_dp on this rank: the bf16 path's warm-up, FLEET_STEPS timed
    steps and one with its allreduces timed, B1's launches, the buckets,
    the digests."""
    from paddle_tpu_torch.distributed import parallel_env

    rank, world = parallel_env.get_rank(), parallel_env.get_world_size()
    flags.set_flags({"flash_attention": "always"})
    t0 = time.monotonic()
    main, startup, loss, chain = fleet_bert(FLEET_BATCH, amp=True,
                                            dropout=0.1, lr=1e-4)
    build_s = time.monotonic() - t0
    exe = pt.Executor()
    scope = pt.framework.Scope()
    torch.cuda.reset_peak_memory_stats()
    exe.run(startup, scope=scope)
    names = param_names(main)
    startup_digest = param_digest(scope, names)
    feed = bert_shard(bert_feed(FLEET_BATCH * world, seed=0),
                      rank * FLEET_BATCH, (rank + 1) * FLEET_BATCH)
    t0 = time.monotonic()
    warm = float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].ravel()[0])
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    eager0 = stat_get("executor_eager_host_collective")
    fab.reset_launch_count()    # this path's count starts here
    step_ms, losses = [], [warm]
    for _ in range(FLEET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    launches = fab.flash_attention_bias.launches
    eager = stat_get("executor_eager_host_collective") - eager0
    # one step more, not timed, with each allreduce synced and timed
    acc, undo = timed_lowering("c_allreduce_sum")
    try:
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        losses.append(float(out.ravel()[0]))
    finally:
        undo()
    if rank == 0:   # the timed steps are over: collective_capture may run
        open(os.path.join(tmp, "dp_done"), "w").close()
    prog = rewritten(exe, main)
    ops = prog.global_block.ops
    buckets = [op for op in ops if op.type == "c_allreduce_sum"
               and op.attr(passes.COMM_ID_ATTR)]
    result = dict(
        chain=chain, build_s=build_s, warm_s=warm_s, losses=losses,
        step_ms=step_ms, step_ms_p50=float(np.median(step_ms)),
        allreduce_s_per_step=acc[0], allreduce_calls_per_step=acc[1],
        b1_launches=launches, b1_launches_per_step=launches / FLEET_STEPS,
        eager_host_collective=eager,
        scale_ops=sum(op.type == "scale"
                      and bool(op.attr(passes.DP_LOSS_SCALE_ATTR))
                      for op in main.global_block.ops),
        buckets=len(buckets),
        buckets_planned=stat_get("pass_fused_allreduce_buckets"),
        bucket_bytes=[executor_mod._program_allreduce_bytes(
            prog.global_block, [op]) for op in buckets],
        allreduce_bytes_per_step=executor_mod._program_allreduce_bytes(
            prog.global_block, ops),
        allreduce_ops_before=stat_get("pass_allreduce_ops_before"),
        startup_digest=startup_digest,
        final_digest=param_digest(scope, names),
        opt_state_bytes=opt_state_bytes(main, scope),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    exe.close()
    return result


def fleet_rank_oracle(tmp):
    """fleet_dp_oracle's two-rank runs on this rank: float32 from the
    parent's startup values, with the fused allreduce and without."""
    from paddle_tpu_torch.distributed import parallel_env

    rank = parallel_env.get_rank()
    half = ORACLE_BATCH // FLEET_RANKS
    path = os.path.join(tmp, "oracle_init.npz")
    wait_for_file(path)   # the parent writes it beside fleet_dp
    init = dict(np.load(path))
    feed = bert_shard(bert_feed(ORACLE_BATCH, seed=1, padded_keys=16),
                      rank * half, (rank + 1) * half)
    flags.set_flags({"flash_attention": "always"})
    out = {}
    for fuse in (True, False):
        main, startup, loss, _ = fleet_bert(half, amp=False, dropout=0.0,
                                            lr=ORACLE_LR, fuse=fuse)
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        names = param_names(main)
        for n in names:
            scope.set_var(n, torch.from_numpy(init[n]).to(exe.device))
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].ravel()[0])
                  for _ in range(FLEET_ORACLE_STEPS)]
        if fuse and rank == 0:
            np.savez(os.path.join(tmp, "oracle_ranks.npz"), **{
                n: scope.get_var(n).detach().cpu().numpy() for n in names})
        out["fuse" if fuse else "nofuse"] = dict(
            losses=losses, digest=param_digest(scope, names))
        exe.close()
        del exe, scope
    return out


def fleet_rank_zero(tmp):
    """fleet_zero on this rank: fleet_dp's bf16 path with ZeRO-1
    (``strategy.sharding``), its warm-up and ZERO_STEPS timed eager steps;
    B1's launches, the moments this rank holds, its peak, the
    collectives' bytes a step, the digests."""
    from paddle_tpu_torch.distributed import parallel_env

    rank, world = parallel_env.get_rank(), parallel_env.get_world_size()
    flags.set_flags({"flash_attention": "always"})
    main, startup, loss, chain = fleet_bert(FLEET_BATCH, amp=True,
                                            dropout=0.1, lr=1e-4,
                                            sharding=True)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    torch.cuda.reset_peak_memory_stats()
    exe.run(startup, scope=scope)
    names = param_names(main)
    feed = bert_shard(bert_feed(FLEET_BATCH * world, seed=0),
                      rank * FLEET_BATCH, (rank + 1) * FLEET_BATCH)
    t0 = time.monotonic()
    warm = float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].ravel()[0])
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    accs = executor_mod.zero_accumulators(main)
    block = main.global_block
    eager0, comm0 = stat_get("executor_eager_host_collective"), comm_bytes()
    fab.reset_launch_count()
    step_ms, losses = [], [warm]
    for _ in range(ZERO_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    launches = fab.flash_attention_bias.launches
    comm = {k: (v - comm0[k]) / ZERO_STEPS for k, v in comm_bytes().items()}
    ops = [op.type for op in rewritten(exe, main).global_block.ops]
    result = dict(
        chain=chain, warm_s=warm_s, losses=losses, step_ms=step_ms,
        step_ms_p50=float(np.median(step_ms)), b1_launches=launches,
        b1_launches_per_step=launches / ZERO_STEPS,
        eager_host_collective=stat_get("executor_eager_host_collective")
        - eager0,
        sharded_accumulators=len(accs),
        rows_held=all(int(scope.get_var(n).shape[0]) * world
                      == int(block.var(n).shape[0]) for n in accs),
        opt_state_bytes=opt_state_bytes(main, scope),
        comm_bytes_per_step=comm,
        op_counts={t: ops.count(t) for t in (
            "c_reducescatter", "c_shard_slice", "c_allgather",
            "c_allreduce_sum")},
        final_digest=param_digest(scope, names),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    exe.close()
    return result


def fleet_rank_zero_oracle(tmp):
    """fleet_zero_oracle's ZeRO-1 run and fleet_ckpt's save on this rank:
    float32 from the parent's startup values on fleet_dp_oracle's feeds,
    FLEET_ORACLE_STEPS steps, ``save_sharded`` through a ``KVBarrier`` on
    the parent's KV server, then one step more."""
    from paddle_tpu_torch.ckpt import KVBarrier
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.distributed import parallel_env

    rank, world = parallel_env.get_rank(), parallel_env.get_world_size()
    half = ORACLE_BATCH // FLEET_RANKS
    init = dict(np.load(os.path.join(tmp, "oracle_init.npz")))
    feed = bert_shard(bert_feed(ORACLE_BATCH, seed=1, padded_keys=16),
                      rank * half, (rank + 1) * half)
    flags.set_flags({"flash_attention": "always"})
    main, startup, loss, chain = fleet_bert(half, amp=False, dropout=0.0,
                                            lr=ORACLE_LR, sharding=True)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    names = param_names(main)
    for n in names:
        scope.set_var(n, torch.from_numpy(init[n]).to(exe.device))
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].ravel()[0])
              for _ in range(FLEET_ORACLE_STEPS)]
    moments = sorted(executor_mod.zero_accumulators(main))
    digest = param_digest(scope, names)
    moments_digest = param_digest(scope, moments)
    with open(os.path.join(tmp, "kv_endpoint")) as f:
        endpoint = f.read().strip()
    ckpt = os.path.join(tmp, "zero_ckpt")
    t0 = time.monotonic()
    saved = dckpt.save_sharded(
        scope, ckpt, step=FLEET_ORACLE_STEPS,
        barrier=KVBarrier(endpoint, rank, world,
                          timeout=FLEET_CHILD_TIMEOUT_S))
    save_s = time.monotonic() - t0
    stats = dckpt._manager(ckpt).stats[-1]
    step4 = float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].ravel()[0])
    exe.close()
    return dict(chain=chain, losses=losses, digest=digest, moments=moments,
                moments_digest=moments_digest, saved_vars=len(saved),
                save_s=save_s, save_stats=stats, step4_loss=step4)


def fleet_rank_localsgd(tmp):
    """fleet_localsgd on this rank: fleet_dp's bf16 path with
    ``strategy.localsgd`` at LOCALSGD_K, LOCALSGD_STEPS steps: the main
    program captured, each average eager and timed, the parameters'
    digest after every step."""
    from paddle_tpu_torch.distributed import parallel_env

    rank, world = parallel_env.get_rank(), parallel_env.get_world_size()
    flags.set_flags({"flash_attention": "always"})
    main, startup, loss, chain = fleet_bert(
        FLEET_BATCH, amp=True, dropout=0.1, lr=1e-4, localsgd=True,
        localsgd_configs={"k_steps": LOCALSGD_K})
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    names = param_names(main)
    feed = bert_shard(bert_feed(FLEET_BATCH * world, seed=0),
                      rank * FLEET_BATCH, (rank + 1) * FLEET_BATCH)
    avg, average_s = main._localsgd, []
    real = avg.average_step

    def timed_average(exe_, scope=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        did = real(exe_, scope=scope)
        torch.cuda.synchronize()
        if did:
            average_s.append(time.perf_counter() - t0)
        return did

    avg.average_step = timed_average
    counts0 = {k: stat_get(k) for k in ("cuda_graph_captures",
                                        "cuda_graph_replays",
                                        "executor_eager_host_collective")}
    fab.reset_launch_count()
    step_ms, losses, digests = [], [], []
    for _ in range(LOCALSGD_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
        digests.append(param_digest(scope, names))
    result = dict(
        chain=chain, losses=losses, step_ms=step_ms,
        step_ms_p50=float(np.median(step_ms)), average_s=average_s,
        digests=digests,
        capture_reason=executor_mod.capture_reason(rewritten(exe, main)),
        b1_launches=fab.flash_attention_bias.launches,
        **{k: stat_get(k) - v for k, v in counts0.items()})
    exe.close()
    return result


class ElasticBert:
    """fleet_elastic's supervisor program at one topology: the group
    re-formed over its ranks (``parallel_env._join_survivors``, on the
    parent's KV server), fleet_zero_oracle's float32 program through
    ``fleet`` at the topology's world (ZeRO-1 above one rank), the
    parent's startup values, this rank's rows of each batch."""

    def __init__(self, topo, rank, kv, dead, init, first, tmp):
        from paddle_tpu_torch.distributed import fleet, parallel_env

        t0 = time.monotonic()
        parallel_env._join_survivors(topo.ranks, rank, kv,
                                     dead_ranks_fn=dead)
        self.join_s = time.monotonic() - t0
        self.rank, self.first, self.tmp = rank, first, tmp
        self.index, self.world = topo.ranks.index(rank), topo.world_size
        self.dies = first and rank == 1
        per = ORACLE_BATCH // self.world
        self.lo, self.hi = self.index * per, (self.index + 1) * per
        gc.collect()
        torch.cuda.empty_cache()
        self.main, startup, self.loss, self.chain = fleet_bert(
            per, amp=False, dropout=0.0, lr=ORACLE_LR,
            sharding=self.world > 1)
        self.worker_num = fleet.worker_num()
        self.exe = pt.Executor()
        self.scope = pt.framework.Scope()
        self.exe.run(startup, scope=self.scope)
        self.names = param_names(self.main)
        for n in self.names:
            self.scope.set_var(n, torch.from_numpy(init[n]).to(
                self.exe.device))
        self.build_s = time.monotonic() - t0 - self.join_s
        self.steps, self.step_s, self.b1, self.ends = 0, [], [], []
        self.restored = None

    def step(self, feed):
        from paddle_tpu_torch.framework.executor import zero_accumulators

        if self.steps == 0 and not self.first:
            # what the restore put in the scope, cut into each starting
            # rank's rows of every moment
            self.restored = rank_block_digests(self.scope,
                                               ELASTIC_STATE["moments"])
        self.steps += 1
        if self.dies and self.steps == ELASTIC_KILL:
            with open(os.path.join(self.tmp, "elastic_death.json"),
                      "w") as f:
                json.dump({"t": time.time()}, f)
            os._exit(ELASTIC_EXIT)
        b1 = fab.flash_attention_bias.launches
        t0 = time.perf_counter()
        out = self.exe.run(self.main, feed=bert_shard(feed, self.lo,
                                                      self.hi),
                           fetch_list=[self.loss], scope=self.scope)[0]
        torch.cuda.synchronize()
        self.step_s.append(time.perf_counter() - t0)
        self.ends.append(time.time())
        self.b1.append(fab.flash_attention_bias.launches - b1)
        if self.first and self.steps == ELASTIC_SAVE_EVERY:
            # this rank's rows of every moment after step 2: what the
            # step-2 checkpoint holds of it
            moments = sorted(zero_accumulators(self.main))
            ELASTIC_STATE["moments"] = moments
            with open(os.path.join(self.tmp, f"elastic_blocks{self.rank}"
                                   ".json"), "w") as f:
                json.dump({"moments": moments, "digest": tensors_digest(
                    [self.scope.get_var(n) for n in moments])}, f)
        return float(out.ravel()[0])

    def close(self):
        from paddle_tpu_torch.distributed import parallel_env

        self.exe.close()
        parallel_env.destroy_parallel_env()


ELASTIC_STATE = {}   # a rank's ZeRO moment names, from its first program


def wait_alive(dead):
    """Wait (ELASTIC_ALIVE_S at most) until the health plane has heard
    from every rank: one not heard from yet reads as dead, and a
    supervisor polling then would re-shard a live job."""
    t0 = time.monotonic()
    while dead():
        if time.monotonic() - t0 > ELASTIC_ALIVE_S:
            raise RuntimeError(f"fleet_elastic: ranks {dead()} sent no "
                               f"heartbeat in {ELASTIC_ALIVE_S} s")
        time.sleep(0.05)


def fleet_rank_elastic(tmp):
    """fleet_elastic on this rank: a heartbeat to the parent's KV server,
    then the float32 ZeRO-1 program under an ``ElasticSupervisor`` at two
    ranks (a checkpoint every 2 steps through a ``KVBarrier``); rank 1
    dies hard at step 3, rank 0 re-shards and finishes.  Rank 0 writes
    ``elastic0.json`` and its parameters."""
    from paddle_tpu_torch.ckpt import CheckpointManager, KVBarrier
    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.distributed.fleet import elastic
    from paddle_tpu_torch.observe import flight
    from paddle_tpu_torch.observe.health import HealthReporter

    rank, world = parallel_env.get_rank(), parallel_env.get_world_size()
    with open(os.path.join(tmp, "kv_endpoint")) as f:
        kv = f.read().strip()
    init = dict(np.load(os.path.join(tmp, "oracle_init.npz")))
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    flags.set_flags({"flash_attention": "always"})
    dead = elastic.dead_ranks_from_cluster(kv)
    progs, managers, restore_s = [], [], []

    def train_fn(topo):
        prog = ElasticBert(topo, rank, kv, dead, init, not progs, tmp)
        progs.append(prog)
        return prog

    def manager(topo):
        # the job ranks of the starting world are its indices
        index, n = topo.ranks.index(rank), topo.world_size
        m = CheckpointManager(
            os.path.join(tmp, "elastic_ckpt"), keep_n=0, async_save=False,
            rank=index, world_size=n, barrier=KVBarrier(
                kv, index, n, timeout=FLEET_CHILD_TIMEOUT_S,
                prefix=f"elastic-w{n}", dead_ranks_fn=dead))
        real = m.restore

        def timed_restore(*a, **kw):
            t0 = time.monotonic()
            try:
                return real(*a, **kw)
            finally:
                torch.cuda.synchronize()
                restore_s.append(time.monotonic() - t0)

        m.restore = timed_restore
        managers.append(m)
        return m

    reporter = HealthReporter(kv, rank, world_size=world,
                              interval_s=ELASTIC_HEARTBEAT_S).start()
    try:
        wait_alive(dead)
        sup = elastic.ElasticSupervisor(
            world_size=world, cluster_url=kv, save_every=ELASTIC_SAVE_EVERY,
            preflight=False, backoff_s=ELASTIC_BACKOFF_S,
            postmortem_dir=os.path.join(tmp, "elastic_postmortem"))
        t0 = time.monotonic()
        r = sup.run(train_fn, manager=manager,
                    loader=[feed] * ELASTIC_STEPS, total_steps=ELASTIC_STEPS)
        run_s = time.monotonic() - t0
    finally:
        reporter.stop()
    last = r.train
    verdicts = [e["ts"] for e in flight.tail()
                if e["event"] == "elastic/failure"
                and e.get("kind") == elastic.FAILURE_TOPOLOGY]
    np.savez(os.path.join(tmp, "elastic_params.npz"), **{
        n: last.scope.get_var(n).detach().cpu().numpy() for n in last.names})
    out = dict(
        result=r.to_dict(), losses=r.losses, run_s=run_s,
        worlds=[p.world for p in progs], chains=[p.chain for p in progs],
        worker_num=[p.worker_num for p in progs],
        join_s=[p.join_s for p in progs], build_s=[p.build_s for p in progs],
        step_s=[p.step_s for p in progs], step_end=[p.ends for p in progs],
        b1_per_step=[p.b1 for p in progs], restored=last.restored,
        save_s=[st["blocking_s"] for m in managers for st in m.stats],
        restore_s=restore_s, verdict_ts=verdicts,
        bundles=sorted(os.listdir(os.path.join(tmp, "elastic_postmortem"))),
        heartbeats=reporter.beats, heartbeat_failures=reporter.failures)
    last.close()
    with open(os.path.join(tmp, f"elastic{rank}.json"), "w") as f:
        json.dump(out, f)


def fleet_child(tmp):
    """One rank of fleet_dp, fleet_dp_oracle, fleet_zero,
    fleet_zero_oracle (with fleet_ckpt's save), fleet_localsgd and
    fleet_elastic, started by ``phase_fleet_dp`` through the port's
    launcher: checks that the parent's kernels are there (a rank must not
    build them), joins the gloo group, runs each, writes ``rank<r>.json``
    into ``tmp`` before fleet_elastic."""
    from paddle_tpu_torch.distributed import parallel_env

    if not torch.cuda.is_available():
        raise SystemExit("fleet rank: no CUDA device")
    built = {n: os.path.exists(build.library_path(n)) for n in build.SOURCES}
    if not all(built.values()):
        raise RuntimeError(f"a rank found kernels unbuilt: {built}")
    parallel_env.init_parallel_env()
    rank = parallel_env.get_rank()
    result = dict(rank=rank, world=parallel_env.get_world_size(),
                  backend=parallel_env.backend(),
                  device_count=torch.cuda.device_count(),
                  device=str(pt.Executor().device),
                  kind=torch.cuda.get_device_name(0), kernels_prebuilt=built,
                  dp=fleet_rank_dp(tmp))
    for name, run in (("oracle", fleet_rank_oracle),
                      ("zero", fleet_rank_zero),
                      ("zero_oracle", fleet_rank_zero_oracle),
                      ("localsgd", fleet_rank_localsgd)):
        gc.collect()
        torch.cuda.empty_cache()
        result[name] = run(tmp)
    # before fleet_elastic, which rank 1 does not survive
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_rank_elastic(tmp)
    parallel_env.destroy_parallel_env()
    return 0


def capture_child(tmp):
    """collective_capture's one rank: NCCL at world size 1 on cuda:0, a
    program of CAPTURE_OPS through ``Executor.run`` (warm-up, capture,
    replay), a profiled replay, and what gloo accepts on a CUDA tensor in
    this torch (a one-rank gloo group beside, each call tried once and
    its error kept: a report, no route of the port)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.framework.program import Program

    if not torch.cuda.is_available():
        raise SystemExit("capture rank: no CUDA device")
    parallel_env.init_parallel_env()
    # started with fleet_dp's ranks: its work waits for their timed steps
    wait_for_file(os.path.join(tmp, "dp_done"))
    main = Program()
    block = main.global_block
    block.create_var(name="x", shape=list(CAPTURE_SHAPE), dtype="float32")
    for t in CAPTURE_OPS:
        block.create_var(name=t + "_out", shape=list(CAPTURE_SHAPE),
                         dtype="float32")
        block.append_op(t, {"X": ["x"]}, {"Out": [t + "_out"]},
                        {"ring_id": 0, "root": 0})
    fetch = [t + "_out" for t in CAPTURE_OPS]
    x = np.random.RandomState(25).randn(*CAPTURE_SHAPE).astype("f4")
    in_capture = {}

    def counted(name):
        real = getattr(dist, name)

        def call(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                in_capture[name] = in_capture.get(name, 0) + 1
            return real(*a, **kw)
        return call

    for name in ("all_reduce", "all_gather", "broadcast",
                 "reduce_scatter_tensor"):
        setattr(dist, name, counted(name))
    exe = pt.Executor()
    scope = pt.framework.Scope()
    captures = stat_get("cuda_graph_captures")
    replays = stat_get("cuda_graph_replays")
    outs = [exe.run(main, feed={"x": x}, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed={"x": x}, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
    kernels = device_time_by_kernel(prof)
    result = dict(
        backend=parallel_env.backend(), world=parallel_env.get_world_size(),
        device_count=torch.cuda.device_count(), device=str(exe.device),
        capture_reason=executor_mod.capture_reason(main),
        captures=stat_get("cuda_graph_captures") - captures,
        replays=stat_get("cuda_graph_replays") - replays,
        identity=all(np.array_equal(np.asarray(o), x) for o in outs[-1]),
        shapes=[list(np.asarray(o).shape) for o in outs[-1]],
        nccl_calls_in_capture=in_capture,
        nccl_kernels={k: v for k, v in kernels.items()
                      if "nccl" in k.lower()},
        replay_device_us=kernels)
    exe.close()
    with open(os.path.join(tmp, "capture.json"), "w") as f:
        json.dump(result, f)
    parallel_env.destroy_parallel_env()
    return 0


CHILD_MODES = {"--fleet-rank": fleet_child,
               "--collective-capture": capture_child}


def start_ranks(tmp, mode, nproc, backend):
    """Start ``nproc`` children of this script in ``mode`` through the
    port's launcher, every one on cuda:0 (``FLAGS_selected_gpus``), over
    ``backend``; ``wait_ranks`` waits for them."""
    import socket

    from paddle_tpu_torch.distributed import launch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = os.path.join(tmp, mode.strip("-") + "_logs")
    env = {"PADDLE_DISTRI_BACKEND": backend, "GLOO_SOCKET_IFNAME": "lo"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:   # the children copy the environment when they start
        procs = launch.start_local_trainers(
            nproc, f"127.0.0.1:{port}", os.path.abspath(__file__),
            [mode, tmp], log_dir=logs, selected_gpus=[0] * nproc)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(procs=procs, logs=logs, mode=mode, t0=time.monotonic())


def stop_ranks(started):
    from paddle_tpu_torch.distributed import launch

    launch.terminate_local_procs(started["procs"])


def wait_ranks(started, exits=None):
    """Wait for ``start_ranks``' children (FLEET_CHILD_TIMEOUT_S from
    their start); a child that fails or outlives it fails the phase, and
    every child is stopped on the way out.  ``exits`` maps a child's
    index to the one nonzero exit code it may end with (fleet_elastic's
    rank 1, ``ELASTIC_EXIT``).  Keeps the codes in ``started["codes"]``;
    returns the children's seconds."""
    from paddle_tpu_torch.distributed import launch

    exits = exits or {}
    procs, t0, rc = started["procs"], started["t0"], None
    try:
        while rc is None and time.monotonic() - t0 < FLEET_CHILD_TIMEOUT_S:
            codes = [p.poll() for p in procs]
            bad = [c for i, c in enumerate(codes)
                   if c not in (None, 0, exits.get(i))]
            if bad:
                rc = bad[0]
            elif None not in codes:
                rc = 0
            else:
                time.sleep(0.2)
    finally:
        launch.terminate_local_procs(procs)
        started["codes"] = [p.poll() for p in procs]
    if rc != 0:
        logs = started["logs"]
        tails = "".join(f"\n----- {f} -----\n" + open(os.path.join(
            logs, f), errors="replace").read()[-4000:]
            for f in sorted(os.listdir(logs)))
        raise RuntimeError(f"{started['mode']}: children exited {rc} "
                           f"after {time.monotonic() - t0:.1f} s{tails}")
    return time.monotonic() - t0


def phase_fleet_dp(tmp):
    """BERT-base at two ranks over gloo on cuda:0 (fleet_child); while
    they start, this process writes the oracle's startup values for
    their fleet_dp_oracle and fleet_zero_oracle runs (read after their
    timed steps), and serves the port's KV server, whose ``KVBarrier``
    orders fleet_ckpt's commit, and whose ``/metrics/cluster`` (world size
    FLEET_RANKS) this process polls while the ranks run: fleet_elastic's
    heartbeats."""
    from paddle_tpu_torch.distributed.fleet.utils import KVServer
    from paddle_tpu_torch.observe.health import serve_cluster_health

    kv = KVServer(0)
    serve_cluster_health(kv, world_size=FLEET_RANKS)
    kv.start()
    endpoint = f"127.0.0.1:{kv.port}"
    with open(os.path.join(tmp, "kv_endpoint"), "w") as f:
        f.write(endpoint)
    stop, seen = threading.Event(), []
    poller = threading.Thread(target=poll_cluster,
                              args=(endpoint, stop, seen), daemon=True)
    poller.start()
    try:
        launch_s = fleet_dp_ranks(tmp)
    finally:
        stop.set()
        poller.join(timeout=10)
        kv.stop()
    FLEET_STATE["cluster"] = seen
    fleet_dp_check(launch_s)


def poll_cluster(endpoint, stop, seen):
    """GET ``/metrics/cluster`` every 0.2 s until ``stop``; keep each
    answer's time, live and dead ranks and each rank's step p50."""
    import urllib.request

    while not stop.wait(0.2):
        try:
            with urllib.request.urlopen(
                    f"http://{endpoint}/metrics/cluster", timeout=2) as r:
                doc = json.load(r)
        except OSError:
            continue
        seen.append({"t": time.time(), "alive": doc["alive_ranks"],
                     "dead": doc["dead_ranks"],
                     "world": doc["world_size"],
                     "p50": {k: v.get("step_time_p50_s")
                             for k, v in doc["ranks"].items()}})


def fleet_dp_ranks(tmp):
    """Start fleet_dp's ranks, write the oracle's startup values, wait for
    the ranks; returns their seconds."""
    started = start_ranks(tmp, "--fleet-rank", FLEET_RANKS, "gloo")
    try:
        main, startup, _loss, _ = fleet_bert(ORACLE_BATCH, amp=False,
                                             dropout=0.0, lr=ORACLE_LR)
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        init = {n: scope.get_var(n).detach().cpu().numpy()
                for n in param_names(main)}
        part = os.path.join(tmp, "oracle_init.part.npz")
        np.savez(part, **init)
        os.replace(part, os.path.join(tmp, "oracle_init.npz"))
        exe.close()
        del exe, scope
        release("fleet_dp_startup")
        FLEET_STATE["init"] = init
    except BaseException:
        stop_ranks(started)
        raise
    # rank 1 leaves fleet_elastic by os._exit(ELASTIC_EXIT)
    launch_s = wait_ranks(started, exits={1: ELASTIC_EXIT})
    FLEET_STATE["ranks"] = [json.load(open(os.path.join(
        tmp, f"rank{r}.json"))) for r in range(FLEET_RANKS)]
    FLEET_STATE["exit_codes"] = started["codes"]
    return launch_s


def fleet_dp_check(launch_s):
    """Log fleet_dp's ranks' results and check them."""
    ranks = FLEET_STATE["ranks"]
    dp = [r["dp"] for r in ranks]
    card = nvidia_smi("name,power.limit")
    log("fleet_dp", model="bert-base", ranks=FLEET_RANKS, backend="gloo",
        devices=[r["device"] for r in ranks],
        device_count=[r["device_count"] for r in ranks],
        kernels_prebuilt=[all(r["kernels_prebuilt"].values())
                          for r in ranks],
        batch_per_rank=FLEET_BATCH, global_batch=FLEET_BATCH * FLEET_RANKS,
        seq=128, amp="bfloat16", dropout=0.1, steps=FLEET_STEPS,
        chain=dp[0]["chain"], children_s=launch_s, card=card,
        **{k: [d[k] for d in dp] for k in (
            "step_ms_p50", "step_ms", "allreduce_s_per_step",
            "allreduce_calls_per_step", "peak_memory_gb", "build_s",
            "warm_s", "b1_launches_per_step", "eager_host_collective",
            "scale_ops", "buckets", "buckets_planned",
            "allreduce_bytes_per_step", "allreduce_ops_before",
            "opt_state_bytes")},
        bucket_bytes=dp[0]["bucket_bytes"], losses=dp[0]["losses"],
        losses_bit_identical=dp[0]["losses"] == dp[1]["losses"],
        startup_digests_equal=dp[0]["startup_digest"] == dp[1][
            "startup_digest"],
        final_digests_equal=dp[0]["final_digest"] == dp[1]["final_digest"])
    for r, d in zip(ranks, dp):
        if r["world"] != FLEET_RANKS or r["backend"] != "gloo" \
                or r["device"] != "cuda:0":
            raise RuntimeError(f"fleet_dp: rank {r['rank']} ran as "
                               f"{r['world']} ranks over {r['backend']} on "
                               f"{r['device']}")
        if d["b1_launches"] != B1_PER_STEP * FLEET_STEPS:
            raise RuntimeError(f"fleet_dp: rank {r['rank']} launched B1 "
                               f"{d['b1_launches']} times in {FLEET_STEPS} "
                               f"steps, want {B1_PER_STEP} a step")
        if d["scale_ops"] != 1 or not 1 <= d["buckets"] == \
                d["buckets_planned"]:
            raise RuntimeError(f"fleet_dp: rank {r['rank']}: "
                               f"{d['scale_ops']} loss scales, "
                               f"{d['buckets']} buckets of "
                               f"{d['buckets_planned']} planned")
        if d["eager_host_collective"] != FLEET_STEPS:
            raise RuntimeError(f"fleet_dp: rank {r['rank']} counted "
                               f"{d['eager_host_collective']} eager "
                               f"host-collective runs in {FLEET_STEPS}")
        if not all(math.isfinite(x) for x in d["losses"]):
            raise RuntimeError(f"fleet_dp: losses {d['losses']}")
    if dp[0]["losses"] != dp[1]["losses"]:
        raise RuntimeError(f"fleet_dp: the ranks fetched different losses "
                           f"{dp[0]['losses']} and {dp[1]['losses']}")
    if dp[0]["startup_digest"] != dp[1]["startup_digest"] or \
            dp[0]["final_digest"] != dp[1]["final_digest"]:
        raise RuntimeError("fleet_dp: the ranks' parameters differ")


def fleet_oracle_one(init, batch, feed, grads=False):
    """FLEET_ORACLE_STEPS float32 steps in this process at ``batch`` from
    the startup values ``init``: the losses, the parameters after them
    and, with ``grads``, each parameter's step-1 gradient norm."""
    main, startup, loss, _ = fleet_bert(batch, amp=False, dropout=0.0,
                                        lr=ORACLE_LR)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set_var(n, torch.from_numpy(v).to(exe.device))
    names = sorted(init)
    losses, norms = [], {}
    for step in range(FLEET_ORACLE_STEPS):
        extra = [n + "@GRAD" for n in names] if grads and step == 0 else []
        out = eager_run(exe, main, feed, [loss] + extra, scope)
        losses.append(float(out[0].ravel()[0]))
        norms.update({n: float(torch.as_tensor(g).double().norm())
                      for n, g in zip(names, out[1:])})
    after = {n: scope.get_var(n).double().cpu().numpy() for n in names}
    exe.close()
    return losses, after, norms


def update_gaps(init, after, ref):
    """By parameter, ||(after - init) - (ref - init)|| / ||ref - init||."""
    gaps = {}
    for n, p0 in init.items():
        p0 = p0.astype(np.float64)
        d_ref = ref[n] - p0
        gaps[n] = float(np.linalg.norm((after[n] - p0) - d_ref)
                        / max(float(np.linalg.norm(d_ref)), 1e-300))
    return gaps


def phase_fleet_dp_oracle(tmp):
    """One process at ORACLE_BATCH (float32, dropout 0) from the startup
    values the ranks started from, against the two ranks' runs; the
    control, one process on rank 0's half, against the same."""
    init, ranks = FLEET_STATE["init"], FLEET_STATE["ranks"]
    flags.set_flags({"flash_attention": "always"})
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    half = ORACLE_BATCH // FLEET_RANKS
    one, ours, gnorm = fleet_oracle_one(init, ORACLE_BATCH, feed, grads=True)
    _, ctl, _ = fleet_oracle_one(init, half, bert_shard(feed, 0, half))
    theirs = {n: v.astype(np.float64) for n, v in
              np.load(os.path.join(tmp, "oracle_ranks.npz")).items()}
    # the parameters over all of them as one vector
    diff2 = sum(float(np.sum((theirs[n] - ours[n]) ** 2)) for n in init)
    norm2 = sum(float(np.sum(ours[n] ** 2)) for n in init)
    param_gap = math.sqrt(diff2 / norm2)
    # their updates, by parameter, the zero-gradient ones left out
    top = max(gnorm.values())
    zero = sorted(n for n, g in gnorm.items() if g <= FLEET_ZERO_GRAD * top)
    kept = [n for n in init if n not in zero]
    gaps = update_gaps(init, theirs, ours)
    ctl_gaps = update_gaps(init, ctl, ours)
    worst = max(kept, key=gaps.get)
    ctl_worst = max(kept, key=ctl_gaps.get)
    FLEET_STATE.update(one=one, ours=ours, ctl_gaps=ctl_gaps, kept=kept,
                       dp_params=theirs)
    orc = [r["oracle"] for r in ranks]
    two = orc[0]["fuse"]["losses"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(two, one))
    fuse_equal = all(o["fuse"] == o["nofuse"] for o in orc)
    log("fleet_dp_oracle", batch=ORACLE_BATCH, ranks=FLEET_RANKS,
        batch_per_rank=half, dtype="float32",
        steps=FLEET_ORACLE_STEPS, losses_one_process=one,
        losses_two_ranks=two, max_rel_loss_gap=loss_gap,
        rel_param_norm_gap=param_gap, tolerance=ORACLE_RTOL,
        update_tolerance=FLEET_UPDATE_RTOL,
        zero_grad_shares={n: gnorm[n] / top for n in zero},
        kept_grad_smallest_share=min(gnorm[n] / top for n in kept),
        worst_update=worst, worst_update_gap=gaps[worst],
        zero_grad_update_gaps={n: gaps[n] for n in zero},
        control_worst_update=ctl_worst,
        control_worst_update_gap=ctl_gaps[ctl_worst],
        control_least_update_gap=min(ctl_gaps[n] for n in kept),
        ranks_agree=orc[0] == orc[1], fuse_on_off_bit_equal=fuse_equal)
    if not (loss_gap <= ORACLE_RTOL and param_gap <= ORACLE_RTOL):
        raise RuntimeError(f"fleet_dp_oracle: two ranks {two} vs one "
                           f"process {one}: loss gap {loss_gap}, parameter "
                           f"gap {param_gap} > {ORACLE_RTOL}")
    if gaps[worst] > FLEET_UPDATE_RTOL:
        raise RuntimeError(f"fleet_dp_oracle: the two ranks' update of "
                           f"{worst} is {gaps[worst]} off one process's "
                           f"(> {FLEET_UPDATE_RTOL})")
    if ctl_gaps[ctl_worst] <= FLEET_UPDATE_RTOL:
        raise RuntimeError(f"fleet_dp_oracle: the control (rank 0's half "
                           f"alone) is within {FLEET_UPDATE_RTOL} of one "
                           f"process: the check cannot see a lost gradient")
    if not fuse_equal or orc[0] != orc[1]:
        raise RuntimeError(f"fleet_dp_oracle: fused and unfused runs or the "
                           f"ranks differ: {orc}")


def phase_fleet_ckpt(tmp):
    """The checkpoint fleet_zero_oracle's ranks wrote after step 3 (each
    its blocks of the AdamW moments, rank 0 the rest, committed after the
    KVBarrier), restored here at one process: the moments are the ranks'
    blocks bit for bit, the parameters their digest, and step 4 on the
    full batch lies within ORACLE_RTOL of the ranks' step 4."""
    from paddle_tpu_torch.distributed import checkpoint as dckpt

    zo = [r["zero_oracle"] for r in FLEET_STATE["ranks"]]
    flags.set_flags({"flash_attention": "always"})
    main, startup, loss, _ = fleet_bert(ORACLE_BATCH, amp=False,
                                        dropout=0.0, lr=ORACLE_LR)
    exe = pt.Executor()
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    ckpt = os.path.join(tmp, "zero_ckpt")
    t0 = time.monotonic()
    restored = dckpt.load_sharded(scope, ckpt)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    names, moments = param_names(main), zo[0]["moments"]
    halves = rank_block_digests(scope, moments)
    params_digest = param_digest(scope, names)
    FLEET_STATE["zero_params"] = {n: scope.get_var(n).double().cpu().numpy()
                                  for n in names}
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    step4 = float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].ravel()[0])
    exe.close()
    want = zo[0]["step4_loss"]
    gap = abs(step4 - want) / abs(want)
    step_dir = os.path.join(ckpt, f"step_{FLEET_ORACLE_STEPS}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    files = {n: os.path.getsize(os.path.join(step_dir, n))
             for n in sorted(os.listdir(step_dir))}
    log("fleet_ckpt", ranks=FLEET_RANKS, step=FLEET_ORACLE_STEPS,
        manifest_world_size=manifest["world_size"], file_bytes=files,
        saved_vars=[z["saved_vars"] for z in zo],
        restored_vars=len(restored),
        save_s=[z["save_s"] for z in zo],
        save_stats=[z["save_stats"] for z in zo], restore_s=restore_s,
        moments=len(moments),
        moments_equal_rank_blocks=halves == [z["moments_digest"]
                                             for z in zo],
        params_equal=params_digest == zo[0]["digest"],
        step4_loss_ranks=want, step4_loss_one_process=step4,
        step4_rel_gap=gap, tolerance=ORACLE_RTOL,
        card=nvidia_smi("name,power.limit"))
    if manifest["world_size"] != FLEET_RANKS or not {
            "shard_r0.npz", "shard_r1.npz"} <= set(files):
        raise RuntimeError(f"fleet_ckpt: manifest of {manifest['world_size']}"
                           f" ranks, files {sorted(files)}")
    if halves != [z["moments_digest"] for z in zo] or \
            params_digest != zo[0]["digest"]:
        raise RuntimeError("fleet_ckpt: the restored moments or parameters "
                           "differ from the ranks'")
    if zo[0]["step4_loss"] != zo[1]["step4_loss"] or gap > ORACLE_RTOL:
        raise RuntimeError(f"fleet_ckpt: step 4 at one process {step4} vs "
                           f"the ranks' {[z['step4_loss'] for z in zo]}")


def phase_fleet_zero_oracle():
    """ZeRO-1 at two ranks (float32, dropout 0, fleet_dp_oracle's feeds
    and start) against GradAllReduce at two ranks, bit for bit, and
    against one process (fleet_dp_oracle's run) with the control missing
    the limit.  The ZeRO parameters after step 3 are the checkpoint's
    (fleet_ckpt: their digest is the ranks')."""
    ranks = FLEET_STATE["ranks"]
    zo = [r["zero_oracle"] for r in ranks]
    orc = [r["oracle"]["fuse"] for r in ranks]
    init, one, ours = (FLEET_STATE[k] for k in ("init", "one", "ours"))
    kept, ctl_gaps = FLEET_STATE["kept"], FLEET_STATE["ctl_gaps"]
    theirs, dp = FLEET_STATE["zero_params"], FLEET_STATE["dp_params"]
    bit_equal = all(z["digest"] == o["digest"] and z["losses"] == o["losses"]
                    for z, o in zip(zo, orc))
    dp_gap = math.sqrt(sum(float(np.sum((theirs[n] - dp[n]) ** 2))
                           for n in init)
                       / sum(float(np.sum(dp[n] ** 2)) for n in init))
    gaps = update_gaps(init, theirs, ours)
    worst = max(kept, key=gaps.get)
    ctl_worst = max(kept, key=ctl_gaps.get)
    two = zo[0]["losses"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(two, one))
    log("fleet_zero_oracle", ranks=FLEET_RANKS, dtype="float32",
        steps=FLEET_ORACLE_STEPS, chain=zo[0]["chain"],
        losses_zero=two, losses_allreduce=orc[0]["losses"],
        losses_one_process=one, bit_equal_to_allreduce=bit_equal,
        rel_param_norm_gap_to_allreduce=dp_gap,
        max_rel_loss_gap=loss_gap, tolerance=ORACLE_RTOL,
        worst_update=worst, worst_update_gap=gaps[worst],
        update_tolerance=FLEET_UPDATE_RTOL,
        control_worst_update_gap=ctl_gaps[ctl_worst],
        ranks_agree=zo[0]["losses"] == zo[1]["losses"]
        and zo[0]["digest"] == zo[1]["digest"])
    if not (bit_equal or dp_gap <= ZERO_PARAM_RTOL):
        raise RuntimeError(f"fleet_zero_oracle: ZeRO-1 is {dp_gap} off "
                           f"GradAllReduce norm-wise (> {ZERO_PARAM_RTOL})")
    if loss_gap > ORACLE_RTOL or gaps[worst] > FLEET_UPDATE_RTOL:
        raise RuntimeError(f"fleet_zero_oracle: loss gap {loss_gap}, the "
                           f"update of {worst} {gaps[worst]} off one "
                           f"process")
    if ctl_gaps[ctl_worst] <= FLEET_UPDATE_RTOL:
        raise RuntimeError("fleet_zero_oracle: the control is within the "
                           "update limit")
    if zo[0]["losses"] != zo[1]["losses"] or zo[0]["digest"] != zo[1][
            "digest"]:
        raise RuntimeError("fleet_zero_oracle: the ranks differ")


def phase_fleet_zero():
    """fleet_dp's bf16 path with ZeRO-1 on each rank (fleet_rank_zero):
    B1 24 a step, losses and parameters bit-identical across ranks, each
    rank holding half of every AdamW moment, half of fleet_dp's bytes."""
    ranks = FLEET_STATE["ranks"]
    zs, dp = [r["zero"] for r in ranks], [r["dp"] for r in ranks]
    ratio = [z["opt_state_bytes"] / d["opt_state_bytes"]
             for z, d in zip(zs, dp)]
    log("fleet_zero", model="bert-base", ranks=FLEET_RANKS, backend="gloo",
        batch_per_rank=FLEET_BATCH, amp="bfloat16", dropout=0.1,
        steps=ZERO_STEPS, chain=zs[0]["chain"],
        **{k: [z[k] for z in zs] for k in (
            "step_ms_p50", "step_ms", "warm_s", "b1_launches_per_step",
            "eager_host_collective", "sharded_accumulators", "rows_held",
            "opt_state_bytes", "peak_memory_gb", "comm_bytes_per_step")},
        op_counts=zs[0]["op_counts"],
        fleet_dp_opt_state_bytes=[d["opt_state_bytes"] for d in dp],
        opt_state_ratio_to_fleet_dp=ratio,
        fleet_dp_peak_memory_gb=[d["peak_memory_gb"] for d in dp],
        fleet_dp_step_ms_p50=[d["step_ms_p50"] for d in dp],
        losses=zs[0]["losses"],
        losses_bit_identical=zs[0]["losses"] == zs[1]["losses"],
        final_digests_equal=zs[0]["final_digest"] == zs[1]["final_digest"],
        card=nvidia_smi("name,power.limit"))
    for r, z in enumerate(zs):
        if z["b1_launches"] != B1_PER_STEP * ZERO_STEPS:
            raise RuntimeError(f"fleet_zero: rank {r} launched B1 "
                               f"{z['b1_launches']} times in {ZERO_STEPS} "
                               f"steps")
        if not z["rows_held"] or abs(ratio[r] - 0.5) > 0.01 \
                or not z["sharded_accumulators"]:
            raise RuntimeError(f"fleet_zero: rank {r} holds "
                               f"{z['opt_state_bytes']} bytes of moments, "
                               f"{ratio[r]} of fleet_dp's")
        if z["eager_host_collective"] != ZERO_STEPS or not all(
                math.isfinite(x) for x in z["losses"]):
            raise RuntimeError(f"fleet_zero: rank {r}: {z['losses']}, "
                               f"{z['eager_host_collective']} eager runs")
    if zs[0]["losses"] != zs[1]["losses"] or \
            zs[0]["final_digest"] != zs[1]["final_digest"]:
        raise RuntimeError("fleet_zero: the ranks' losses or parameters "
                           "differ")


def phase_fleet_localsgd():
    """fleet_dp's bf16 path with LocalSGD at LOCALSGD_K on each rank
    (fleet_rank_localsgd): the main step captured on both ranks and only
    the averages eager; the ranks' parameters equal after each average
    and apart after a step in between."""
    ls = [r["localsgd"] for r in FLEET_STATE["ranks"]]
    averaged = [(i + 1) % LOCALSGD_K == 0 for i in range(LOCALSGD_STEPS)]
    equal = [a == b for a, b in zip(ls[0]["digests"], ls[1]["digests"])]
    log("fleet_localsgd", model="bert-base", ranks=FLEET_RANKS,
        backend="gloo", batch_per_rank=FLEET_BATCH, amp="bfloat16",
        dropout=0.1, k_steps=LOCALSGD_K, steps=LOCALSGD_STEPS,
        chain=ls[0]["chain"],
        **{k: [x[k] for x in ls] for k in (
            "step_ms_p50", "step_ms", "average_s", "losses",
            "capture_reason", "cuda_graph_captures", "cuda_graph_replays",
            "executor_eager_host_collective", "b1_launches")},
        averaged_after_step=averaged, digests_equal_after_step=equal,
        card=nvidia_smi("name,power.limit"))
    for r, x in enumerate(ls):
        if x["capture_reason"] is not None or x["cuda_graph_captures"] != 1 \
                or x["executor_eager_host_collective"] != sum(averaged):
            raise RuntimeError(f"fleet_localsgd: rank {r}: reason "
                               f"{x['capture_reason']}, "
                               f"{x['cuda_graph_captures']} captures, "
                               f"{x['executor_eager_host_collective']} "
                               f"eager runs (want None, 1, {sum(averaged)})")
        if x["b1_launches"] != B1_PER_STEP * LOCALSGD_STEPS or not all(
                math.isfinite(v) for v in x["losses"]):
            raise RuntimeError(f"fleet_localsgd: rank {r}: B1 "
                               f"{x['b1_launches']}, losses {x['losses']}")
    if equal != averaged:
        raise RuntimeError(f"fleet_localsgd: the ranks' parameters equal "
                           f"after steps {equal}, averaged after {averaged}")


def phase_fleet_elastic(tmp):
    """fleet_elastic's ranks (fleet_rank_elastic), logged and checked:
    ``/metrics/cluster`` with both ranks alive and their step times
    before rank 1's death and ``dead_ranks == [1]`` after it; rank 0's
    supervisor recovered with one re-shard to one process and an
    ``elastic_topology_change`` bundle; the moments it restored are the
    two ranks' step-2 blocks bit for bit; its losses lie within
    ORACLE_RTOL of fleet_dp_oracle's one process (the same start, feeds
    and steps) and each parameter's update within FLEET_UPDATE_RTOL of
    one process's, the control missing it; B1 B1_PER_STEP a step at two
    ranks and at one."""
    e = json.load(open(os.path.join(tmp, "elastic0.json")))
    blocks = [json.load(open(os.path.join(tmp, f"elastic_blocks{r}.json")))
              for r in range(FLEET_RANKS)]
    with open(os.path.join(tmp, "elastic_death.json")) as f:
        death = json.load(f)["t"]
    init, one, ours = (FLEET_STATE[k] for k in ("init", "one", "ours"))
    kept, ctl_gaps = FLEET_STATE["kept"], FLEET_STATE["ctl_gaps"]
    theirs = {n: v.astype(np.float64) for n, v in
              np.load(os.path.join(tmp, "elastic_params.npz")).items()}
    gaps = update_gaps(init, theirs, ours)
    worst = max(kept, key=gaps.get)
    ctl_worst = max(kept, key=ctl_gaps.get)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(e["losses"], one))
    cluster = FLEET_STATE["cluster"]
    both = [c for c in cluster if c["t"] < death
            and c["alive"] == FLEET_RANKS
            and all((c["p50"].get(str(r)) or 0) > 0
                    for r in range(FLEET_RANKS))]
    dead1 = [c for c in cluster if c["t"] > death and c["dead"] == [1]]
    verdicts = [t for t in e["verdict_ts"] if t > death]
    r = e["result"]
    b1 = {w: sorted(set(b)) for w, b in zip(e["worlds"], e["b1_per_step"])
          if b}
    log("fleet_elastic", model="bert-base", dtype="float32",
        ranks=FLEET_RANKS,
        backend="gloo", steps=ELASTIC_STEPS, kill_step=ELASTIC_KILL,
        save_every=ELASTIC_SAVE_EVERY, heartbeat_s=ELASTIC_HEARTBEAT_S,
        backoff_s=ELASTIC_BACKOFF_S, exit_codes=FLEET_STATE["exit_codes"],
        status=r["status"], restarts=r["restarts"], reshards=r["reshards"],
        final_world_size=r["final_world_size"], history=r["history"],
        worlds=e["worlds"], chains=e["chains"], worker_num=e["worker_num"],
        join_s=e["join_s"], build_s=e["build_s"], step_s=e["step_s"],
        save_s=e["save_s"], restore_s=e["restore_s"], run_s=e["run_s"],
        death_to_verdict_s=(verdicts[0] - death) if verdicts else None,
        recovery_s=e["step_end"][-1][-1] - death,
        b1_per_step_by_world=b1, bundles=e["bundles"],
        heartbeats=e["heartbeats"],
        cluster_both_alive=len(both), cluster_dead_1=len(dead1),
        cluster_before_death=both[-1] if both else None,
        cluster_after_death=dead1[0] if dead1 else None,
        restored_equal_blocks=e["restored"] == [b["digest"] for b in blocks],
        losses=e["losses"], losses_one_process=one, max_rel_loss_gap=loss_gap,
        tolerance=ORACLE_RTOL, worst_update=worst,
        worst_update_gap=gaps[worst], update_tolerance=FLEET_UPDATE_RTOL,
        control_worst_update_gap=ctl_gaps[ctl_worst],
        card=nvidia_smi("name,power.limit"))
    if FLEET_STATE["exit_codes"] != [0, ELASTIC_EXIT]:
        raise RuntimeError(f"fleet_elastic: ranks exited "
                           f"{FLEET_STATE['exit_codes']}, want "
                           f"[0, {ELASTIC_EXIT}]")
    if not both or not dead1:
        raise RuntimeError(f"fleet_elastic: /metrics/cluster showed both "
                           f"ranks alive with step times {len(both)} times "
                           f"before the death, rank 1 dead {len(dead1)} "
                           f"times after it")
    if r["status"] != "recovered" or r["reshards"] != 1 or \
            r["final_world_size"] != 1 or r["restarts"] > 2 or not any(
            "elastic_topology_change" in b for b in e["bundles"]):
        raise RuntimeError(f"fleet_elastic: {r}, bundles {e['bundles']}")
    if e["restored"] != [b["digest"] for b in blocks] or \
            blocks[0]["moments"] != blocks[1]["moments"]:
        raise RuntimeError("fleet_elastic: the restored moments are not the "
                           "ranks' step-2 blocks")
    if len(e["losses"]) != ELASTIC_STEPS or loss_gap > ORACLE_RTOL or \
            gaps[worst] > FLEET_UPDATE_RTOL:
        raise RuntimeError(f"fleet_elastic: losses {e['losses']} vs one "
                           f"process {one} ({loss_gap}), the update of "
                           f"{worst} {gaps[worst]} off one process's")
    if ctl_gaps[ctl_worst] <= FLEET_UPDATE_RTOL:
        raise RuntimeError("fleet_elastic: the control is within the update "
                           "limit")
    if set(b1) != {1, FLEET_RANKS} or any(v != [B1_PER_STEP]
                                          for v in b1.values()):
        raise RuntimeError(f"fleet_elastic: B1 launches a step by world "
                           f"{b1}, want {B1_PER_STEP} at 2 and at 1")


def spawn_rank(scale):
    """phase_spawn's rank function (``spawn`` pickles it by name): an
    all-reduce over the rank's group of a CUDA tensor of ``scale`` times
    its rank + 1."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.framework.place import selected_gpu

    dev = torch.device("cuda", selected_gpu())
    x = torch.full((1024,), scale * (parallel_env.get_rank() + 1.0),
                    device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    return dict(rank=parallel_env.get_rank(),
                world=parallel_env.get_world_size(),
                backend=parallel_env.backend(), device=str(x.device),
                sums=sorted(set(x.cpu().tolist())))


def spawn_rank_fails():
    """phase_spawn's failing rank function: rank 1 raises before the
    all-reduce rank 0 waits in."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import parallel_env

    if parallel_env.get_rank() == 1:
        raise RuntimeError("phase_spawn: rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1, device="cuda:0"))
    return "unreachable"


def phase_spawn():
    """``distributed.spawn(nprocs=2)`` on the one card: two rank processes
    over gloo on cuda:0 (one card, fewer than the ranks), each all-reducing
    a CUDA tensor; rank 0's result comes back.  Then a function that
    fails on rank 1: spawn raises naming rank 1."""
    from paddle_tpu_torch.distributed import spawn

    env = {"GLOO_SOCKET_IFNAME": "lo", "PADDLE_DISTRI_BACKEND": None}
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        t0 = time.monotonic()
        got = spawn(spawn_rank, args=(2.0,), nprocs=2)
        ok_s = time.monotonic() - t0
        t0 = time.monotonic()
        try:
            spawn(spawn_rank_fails, nprocs=2)
            failed = None
        except RuntimeError as e:
            failed = str(e)
        fail_s = time.monotonic() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("spawn", nprocs=2, result=got, seconds=ok_s, failing_seconds=fail_s,
        failing_error=(failed or "")[:120] + " ... "
        + (failed or "")[-300:],
        card=nvidia_smi("name,power.limit"))
    want = dict(rank=0, world=2, backend="gloo", device="cuda:0",
                sums=[2.0 * (1 + 2)])
    if got != want:
        raise RuntimeError(f"spawn: rank 0 returned {got}, want {want}")
    if not failed or "rank 1 failed" not in failed or \
            "fails on purpose" not in failed:
        raise RuntimeError(f"spawn: the failing call raised {failed!r}")


def phase_collective_capture(tmp, started):
    """A program of CAPTURE_OPS captured at world size 1 over NCCL, in a
    child of its own (capture_child), started by ``main`` with fleet_dp's
    ranks: it starts up beside them and runs once their timed steps are
    over (neither its work nor their oracle runs are timed)."""
    launch_s = wait_ranks(started)
    r = json.load(open(os.path.join(tmp, "capture.json")))
    log("collective_capture", ops=list(CAPTURE_OPS), shape=CAPTURE_SHAPE,
        children_s=launch_s, **r)
    if r["backend"] != "nccl" or r["world"] != 1 or \
            r["device"] != "cuda:0":
        raise RuntimeError(f"collective_capture: ran over {r['backend']} "
                           f"at {r['world']} ranks on {r['device']}")
    if r["capture_reason"] is not None or r["captures"] != 1 \
            or r["replays"] != 3:
        raise RuntimeError(f"collective_capture: reason "
                           f"{r['capture_reason']}, {r['captures']} "
                           f"captures, {r['replays']} replays (want None, "
                           f"1, 3)")
    # every collective of the step called NCCL while the graph was being
    # captured: c_allreduce_sum's all-reduce, c_reducescatter's
    # reduce-scatter, c_allgather's gather and the fetch's of the varying
    # scattered output, c_broadcast's broadcast.  At one rank NCCL
    # launches no kernel of its own for them (its one-rank path copies,
    # or does nothing in place): the replay's device work is logged beside
    want = {"all_reduce": 1, "all_gather": 2, "broadcast": 1,
            "reduce_scatter_tensor": 1}
    if not r["identity"] or r["nccl_calls_in_capture"] != want:
        raise RuntimeError(f"collective_capture: identity {r['identity']}, "
                           f"NCCL calls inside the capture "
                           f"{r['nccl_calls_in_capture']} (want {want})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script measures "
              "the port on the card and has nothing to do here",
              file=sys.stderr)
        return 1
    t_start = time.monotonic()
    # a phase that hangs ends the run with every thread's stack on
    # stderr and exit code 1, inside the run's 1200 s limit
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    name = phase_device()
    phase_build()
    rows = phase_kernels(name)
    phase_dropout()
    launches, model = phase_serve()
    phase_profile(model)
    release("profile")
    phase_spec(model)
    release("spec")
    phase_ragged(model)
    release("ragged")
    phase_disagg(model)
    del model
    release("disagg")
    launches["flash_attention_bias"], state = phase_train()
    phase_train_profile(lambda: exe_eager(state), lambda: exe_run(state))
    del state
    release("train")
    phase_pipelined()
    release("pipelined")
    phase_ckpt_resume()
    release("ckpt_resume")
    phase_nan_scan()
    release("nan_scan")
    phase_prune()
    release("prune")
    phase_auto_checkpoint()
    release("auto_checkpoint")
    phase_observe_train()
    release("observe_train")
    phase_observe_profiler()
    BERT15.clear()
    release("observe_profiler")
    phase_train_oracle()
    release("train_oracle")
    unfused, state = phase_train_unfused()
    launches.update(unfused)
    phase_train_profile(
        lambda: exe_eager(state), lambda: exe_run(state),
        phase="train_unfused_profile",
        kernels=(("b2", "flash_fwd_mma_kernel"),
                 ("b3", "flash_bwd_dq_mma_kernel"),
                 ("b4", "flash_bwd_dkv_mma_kernel")),
        op_types=("flash_attention", "flash_attention_grad"))
    del state
    release("train_unfused")
    phase_train_unfused_oracle()
    release("train_unfused_oracle")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "bert_base")
        t0 = time.monotonic()
        main_prog, startup, seq_out, nsp_logits = build_bert_inference()
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        with pt.fluid.scope_guard(scope):
            pt.fluid.io.save_inference_model(
                model_dir, list(INFER_FEEDS), [seq_out, nsp_logits], exe,
                main_prog)
        log("infer_save", seconds=time.monotonic() - t0,
            files=len(os.listdir(model_dir)),
            bytes=sum(os.path.getsize(os.path.join(model_dir, f))
                      for f in os.listdir(model_dir)))
        del exe, scope
        launches["dequant_matmul"], preds = phase_infer(model_dir)
        pred = preds["int8"]
        feed32 = infer_feed(32, seed=32)
        flags.set_flags({"weight_quant": "int8",
                         "flash_attention": "always"})
        try:
            phase_train_profile(
                lambda: eager_run(pred._exe, pred._program, feed32,
                                  pred._fetch_targets, pred._scope),
                lambda: pred.run(feed32), phase="infer_profile",
                kernels=(("b7", "dequant_matmul_"),
                         ("b1", "flash_fwd_mma_kernel")),
                op_types=("dequant_matmul", "fused_multihead_attention"))
            phase_infer_oracle(model_dir, preds)
        finally:
            flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
        for p in preds.values():
            p._exe.close()
        del preds, pred
        release("infer")
        phase_preflight()
        phase_oneshot_server(model_dir)
        release("oneshot_server")
        phase_observe_serve(model_dir)
    release("observe_serve")
    state = phase_resnet()
    phase_train_profile(lambda: exe_eager(state), lambda: exe_run(state),
                        phase="resnet_profile", kernels=(),
                        op_types=RESNET_OP_TYPES, top_kernels=15)
    del state
    release("resnet")
    phase_resnet_oracle()
    release("resnet_oracle")
    phase_dygraph_resnet()
    release("dygraph_resnet")
    phase_dygraph_resnet_oracle()
    release("dygraph_resnet_oracle")
    phase_capture_concurrency()
    release("capture_concurrency")
    phase_hapi(static=False)
    release("hapi_dygraph")
    phase_hapi(static=True)
    release("hapi_static")
    phase_hapi_oracle()
    release("hapi_oracle")
    phase_text_transformer()
    release("text_transformer")
    phase_text_decode()
    release("text_decode")
    phase_text_lstm()
    release("text_lstm")
    phase_text_oracle()
    TEXT_STATE.clear()
    release("text_oracle")
    phase_nn_extras()
    release("nn_extras")
    phase_op_library()
    release("op_library")
    phase_vision_ops()
    release("vision_ops")
    phase_sequence_misc_ops()
    release("sequence_misc_ops")
    phase_model_checkpoint()
    release("model_checkpoint")
    phase_ernie_fleet()
    release("ernie_fleet")
    phase_ernie_gm()
    release("ernie_gm")
    phase_ernie_oracle()
    release("ernie_oracle")
    phase_qat_resnet()
    release("qat_resnet")
    with tempfile.TemporaryDirectory() as tmp:
        phase_qat_export(tmp)
        release("qat_export")
        phase_ptq_resnet(tmp)
    release("ptq_resnet")
    phase_qat_oracle()
    release("qat_oracle")
    phase_moe_serve()
    release("moe_serve")
    phase_moe_train()
    release("moe_train")
    phase_jit_resnet()
    release("jit_resnet")
    phase_jit_bert_int8()
    release("jit_bert_int8")
    phase_dy2static()
    release("dy2static")
    phase_layer_scan_train()
    release("layer_scan_train")
    phase_layer_scan_recompute()
    release("layer_scan_recompute")
    phase_layer_scan_infer()
    release("layer_scan_infer")
    phase_rec_data_feed()
    release("rec_data_feed")
    with tempfile.TemporaryDirectory() as tmp:
        capture = start_ranks(tmp, "--collective-capture", 1, "nccl")
        try:
            phase_fleet_dp(tmp)
            release("fleet_dp")
            phase_fleet_dp_oracle(tmp)
            release("fleet_dp_oracle")
            phase_fleet_ckpt(tmp)
            release("fleet_ckpt")
            phase_fleet_zero_oracle()
            phase_fleet_zero()
            phase_fleet_localsgd()
            phase_fleet_elastic(tmp)
        except BaseException:
            stop_ranks(capture)
            raise
        FLEET_STATE.clear()
        release("fleet_elastic")
        phase_collective_capture(tmp, capture)
    release("collective_capture")
    phase_spawn()
    release("spawn")
    kernels = []
    main_case = TRAIN_FLASH_CASES[0][0]
    for kernel, case in (("paged_decode_attention", "decode_float32"),
                         ("paged_chunk_attention", "chunk_S1_R1024"),
                         ("flash_attention_bias", FLASH_CASES[0][0]),
                         ("flash_attention_fwd", main_case),
                         ("flash_attention_bwd_dq", main_case),
                         ("flash_attention_bwd_dkv", main_case),
                         ("dequant_matmul", DEQUANT_CASES[0][0])):
        row = next(r for r in rows
                   if r["case"] == case and r["kernel"] == kernel)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches[kernel],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "f32_cuda_core_bound_ms": row.get("f32_cuda_core_bound_ms")})
    faulthandler.cancel_dump_traceback_later()
    log("done", seconds=round(time.monotonic() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _timed_phase(fn):
    """``fn`` logging its wall seconds when it ends, passed or not."""
    def run(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            log("phase_seconds", name=fn.__name__[len("phase_"):],
                seconds=time.monotonic() - t0)

    run.__name__ = run.__qualname__ = fn.__name__
    run.__doc__ = fn.__doc__
    return run


# every phase logs its own seconds, called from main or from any script
for _name, _fn in list(globals().items()):
    if _name.startswith("phase_") and callable(_fn):
        globals()[_name] = _timed_phase(_fn)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in CHILD_MODES:
        # a rank of fleet_dp or collective_capture, started by main's run
        sys.exit(CHILD_MODES[sys.argv[1]](sys.argv[2]))
    sys.exit(main())
