"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  device   requires CUDA; prints the card, its capability and the
           `nvidia-smi --query-gpu=name,power.limit` line; TF32 off
           (float32 matmuls in full float32, as the JAX package's
           matmul_precision='highest').
  build    compiles every kernel in paddle_tpu_torch/csrc with nvcc for
           sm_90a, one process per source, all started together, and
           prints the seconds and each kernel's ptxas registers, stack
           and spills; the longest build (LATE_LIBRARY, K4's) is waited
           for only after train kernels and infer kernels, which do not
           launch it, and before kernels.
  kernels  (after infer kernels) holds the paged-attention kernel (K4)
           against its plain
           PyTorch version on the card on seeded cases (max abs error
           <= 1e-4; dead slots and dead query lanes exactly 0; head_dim
           1 to 520), checks it bitwise (two launches; a slot alone; a
           decode slot at C=1 and C=64; head_dim 64, 264, 512, 520),
           then times kernel, plain version and one PyTorch library
           call at the serving phase's shapes and at decode and a C=64
           chunk at head_dim 264 and 512 (CUDA events, L2 flushed
           before each launch, median of 25; each within 1e-4 of the
           plain version).
  train kernels
           the same for the training kernels: layer norm (K1), flash
           forward (K2), flash dK/dV (K3a) and flash dQ (K3b) against
           their plain versions (max abs error <= 1e-4 at unit-scale
           inputs; causal and not, lengths that fit no tile, Sq != Sk
           both ways, head_dim 64, 16, 20 and 128), the backward's delta
           pass (flash_delta) within DELTA_RTOL of the largest |delta|;
           K1's bfloat16 form (y within BF16_FLASH_ULPS of the max, mean
           and rstd within 1e-4), and a Fluid program that casts to
           bfloat16 before layer_norm run on the card (one K1 bf16
           launch) and on the CPU, outputs agreeing; K2, K3a and K3b
           twice on the same inputs, bitwise equal, and above head_dim
           128 (tensor cores up to 512) held and launched twice at every
           WIDE_BWD_DIMS x WIDE_BWD_SHAPES case; K3a/K3b, the plain
           backward and SDPA's against float64, then K2, the plain
           forward and SDPA's forward (O and LSE) against float64, at
           the train shape, a 4x longer sequence and [BH=32, S=512, D]
           for D in WIDE_TIMED_DIMS (max abs error, recorded, not
           held); timed at the train phase's shapes beside
           F.layer_norm (float32 and bf16), torch.linalg.vecdot (the
           delta) and SDPA pinned to its memory-efficient backend
           (forward, and its backward alone for K3a + K3b); K2 and SDPA's
           forward, and the port's whole flash backward (delta + K3a +
           K3b) and SDPA's backward, in turns, with their ratios.
  infer kernels
           the same for the fused conv + folded-BN + relu kernel (K5)
           against its plain version (max abs error within 1e-4 of the
           output's max at unit-scale inputs: the JAX tests' four
           shapes with F and K that fit no tile, the 7x7/2 stem, a 1x1/2
           projection, a res5 3x3, relu on and off); an image's output
           bitwise the same alone and at batch 16, and two launches
           bitwise equal; K5, its plain version and F.conv2d (cuDNN,
           TF32 off) + the same epilogue against float64 at three
           batch-16 shapes; timed (K5 and F.conv2d + epilogue in turns,
           the plain version once) at those shapes and summed over the
           53 convolutions of one batch-16 forward, with the ratio.
           K5's bound_ms is its 3xTF32 tensor-core bound (bound_f32_ms
           the CUDA-core one).
  serve    the decode-serving main path at GPT-2-medium width (6 of
           its 24 layers, d_model 1024, 16 heads, vocab 50257, seeded
           weights):
           a ServingServer on the card, load_decoder, 8 concurrent
           generate requests, a repeated prompt (prefix-cache hit, same
           tokens), a streamed request (equals its buffered twin). The
           kernel counters are zeroed just before and read just after:
           every attention launch must have gone through the kernel
           (one a layer per engine step) and none through the plain
           version.
  spec serve
           speculative decoding at GPT-2-medium width over the RPC front
           door, spec_k 4: a spec-off engine, one with a GPT-2-small-width
           draft (vocab 50257, d768, 12 layers, 12 heads, its own seed)
           and one whose draft is the target's own spec. For each draft
           the kernel counts are zeroed just before its load and read
           after its 8 concurrent serve-phase prompts (32 new tokens
           each): K4 launches == 6 x target steps + (3 or 6) x draft
           steps, no plain call, every page back. Tokens are held against
           the serve phase's under the margin rule (MARGIN_REL); the
           target's own spec accepts >= 95% of proposals and, SPEC_ALONE
           of them sent one at a time, takes fewer target steps than
           spec-off (each rejection logged with its margin). Tokens/s,
           acceptance, target and draft steps, p50 verify and draft-step
           ms and peak memory in turns (off, small, self on the serve
           prompts, then self, small, off on fresh ones); the serve
           prompts once more under seeded sampling (temperature 1,
           top-k 40), held by the draw margin (DRAW_MARGIN); one
           profiled spec request.
  workloads
           a GPT-2-medium engine with the prefix cache and the embed lane
           over the workload RPC: a constrained request (a finite regex
           language, every token in it, finished by the automaton), an
           embed of a 512-token prompt (embedding and logprobs within
           1e-4 of max|.| of the same request on a CPU engine from the
           same parameters), live_slots 0 during an 8-request embed
           churn, a beam of k 4 over a 300-token prompt (shared prompt
           pages; each beam an independent greedy decode of prompt +
           [head] on a cacheless engine, margin rule). K4 launches == 24
           x (target + embed steps), no plain call.
  checkpoint
           save_decoder_checkpoint of that engine's parameters into a
           temporary directory (removed afterwards), load_decoder(
           checkpoint_dir=) over RPC: the loaded parameters, an all-lanes
           pass's logits and the greedy tokens on three prompts bitwise
           the spec-dict engine's, a flipped byte refused naming the
           tensor; save_s, load_s, bytes.
  train    the Fluid training main path: Transformer-base (6+6 layers,
           d_model 512, 8 heads, d_ff 2048, vocab 32000, max_len 512,
           dropout 0.1, seq_parallel attention), Adam(1e-4), batch 16,
           the startup program run on the card, 5 steps on one seeded
           batch (transformer_bench.py's copy task). Counters zeroed
           just before the steps and read just after: 30 layer-norm, 18
           flash-forward, 18 delta, 18 dK/dV and 18 dQ launches per step,
           no plain call; the loss finite and falling. The embedding gradient
           twice on the feed's ids, bitwise equal. Then one more step
           under torch.profiler for the device's busy share.
  check    the decoder step at full width (2 layers) on the card and on
           the CPU: logits agree, and a small engine decodes the same
           greedy tokens on both devices; then one Transformer training
           step at full width (2+2 layers, dropout 0, batch 2) on the
           card (kernels) and on the CPU (plain versions) from the same
           parameters: the loss and every parameter gradient agree.

  infer    the fused ResNet inference main path: ResNet-50 ImageNet
           (224x224x3, 1000 classes, [3, 4, 6, 3] bottlenecks, 25.6M
           parameters, float32; seeded weights, every conv's Scale/Shift
           from fold_bn of seeded statistics), save_inference_model, a
           ServingServer on the card, load_model with the [1, 2, 4, 8,
           16] ladder, 24 concurrent infer requests of 1-4 images over
           RPC. Counters zeroed just before the requests and read just
           after: 53 K5 launches per executed batch, no plain call; every
           answer equals a direct exe.run of its images. Then 10 bucket-16
           requests for images/s, per-bucket compute ms, the feed's
           host->device copy, and one profiled request.
  infer check
           ResNet-50 at batch 2 on the card (K5) and on the CPU (plain
           version) from the same parameters: logits agree within 1e-4
           of the largest |logit|.
  resnet train
           the Fluid training main path of the image-classification
           models: ResNet-50 ImageNet (as in infer, unfused: 53 conv2d on
           cuDNN + 53 batch_norm), resnet.build_train, Momentum(0.01,
           0.9), batch 32, the startup program run on the card, one
           seeded batch copied to the card once, 5 steps through
           Executor().run. Counters zeroed just before the steps and read
           just after: no plain version ran; the losses finite; every
           running mean and variance moved. The same step twice from the
           same state: bitwise equal loss and scope. Step ms p50,
           images/s, peak memory, the program's op census; steps with
           the deterministic and with cuDNN's default convolution
           algorithms in turns, and whether a default step repeats
           bitwise; one profiled step.
  resnet train check
           one ResNet-50 training step at batch 2 on the card, on the
           CPU and on the CPU in float64, from the same state and feed:
           card vs CPU, the loss within 1e-4 relative and every updated
           running statistic within 1e-4 of its tensor's largest
           |value|. The gradients are not continuous at a relu's kink or
           a max-pool tie, and float32 puts some values on the other
           side (the CPU's float32 gradients miss float64 by ~1-2%), so
           the card's gradients are held against float64: relative L2
           error over all parameters within 3x the CPU float32's, each
           tensor within 0.5 of its max; the largest errors recorded.
  resnet fold
           the trained network's conv filters and fold_bn of its
           batch-norm statistics set into the fused ResNet-50 (53 pairs
           onto 53 conv2d_bn_relu ops); a seeded batch of 16 through it
           (53 K5 launches, no plain call) and through the unfused
           test-mode network: logits within 1e-4 of the largest |logit|.
  amp kernels
           K5's bfloat16 form (conv_bn_relu_bf16, FLAGS['amp']) against
           its plain version (within one bfloat16 ulp of the output's
           largest |value|) at the JAX tests' four shapes, the stem, a
           projection and a res5 3x3 at batch 2, and every distinct
           convolution of a batch-16 ResNet-50 forward (each with its
           plan's body and split); an image's output bitwise the same
           alone and at batch 16, two launches bitwise equal, at res2 3x3
           and at every shape on a wgmma body or split; timed at the 20
           shapes in turns with F.conv2d in bf16 (cuDNN) + the affine and
           relu, summed over the 53 convs; the split combine
           (conv_split_combine_bf16) bitwise against its plain version
           and timed.
  infer amp
           the fused ResNet-50 artifact served over RPC at bucket 16
           under FLAGS['amp']: 53 conv_bn_relu_bf16 launches per batch,
           a conv_split_combine_bf16 launch per split convolution, no
           float32 K5 launch, no plain call; images/s; one profiled
           request (busy share, K5 bf16's device ms); the logits against
           the float32 fused forward of the same artifact.
  resnet train amp
           resnet train under FLAGS['amp'] (bf16 conv2d and fc, float32
           master weights): p50 step ms, images/s, peak memory, no plain
           version, every parameter float32, the same step twice
           bitwise equal, one profiled step; then the trained network
           folded into the fused form and run under amp (53
           conv_bn_relu_bf16 launches) against the unfused test-mode
           network under amp.
  resnet amp check
           one batch-2 ResNet-50 training step under FLAGS['amp'] on the
           card and on the CPU: the loss and every running statistic
           within AMP_CHECK_U bfloat16 steps.
  train amp
           train under FLAGS['amp']: Transformer-base, 5 Adam steps, the
           same launch counts as train (K1-K3b stay float32), the loss
           falling, every parameter float32; p50 step ms, tokens/s.

  bf16 kernels
           the bfloat16 forms of K2, K3a and K3b (flash_fwd_bf16,
           flash_bwd_dkdv_bf16, flash_bwd_dq_bf16: the TPU kernels'
           bfloat16 branch) against their plain bf16 versions: O, dQ, dK,
           dV within BF16_FLASH_ULPS ulp of the tensor's max and at most
           BF16_FLASH_SHARE of the elements differing, LSE within TOL;
           full and causal, Sq != Sk, Sk = 200 and 77, heads of 150 rows,
           head_dim 8, 64, 72, 128, 136, 256, 264 (K3a and K3b up to
           head_dim 64 are the wgmma + TMA kernels; their worst case is
           logged beside the earlier mma.sync kernels'); the delta kernel
           on every case's bf16 dO and O; two launches bitwise equal;
           timed at [BH=128, S=512,
           D=64] full and causal and [BH=8, S=2048 and 4096, D=64]
           causal beside their bounds (the delta too), K2 and the whole
           backward (delta + K3a + K3b) in turns with SDPA's flash
           backend in bf16; the backward wrappers' host time a call.
           Above head_dim 128: K2, K3a and K3b (wgmma + TMA up to 512,
           csrc/flash_wide_wgmma.cuh) held at every WIDE_BWD_DIMS x
           WIDE_BWD_SHAPES case (O, dK, dV, dQ as above, LSE within TOL,
           two launches bitwise equal); K2, K3a, K3b and the whole
           backward timed at [BH=32, S=512, D] full, D = 256, 264, 512,
           beside their bounds and in turns with SDPA (its flash backend
           at 256, its efficient backend above, where flash stops).
  flash bf16 bench
           the JAX flash benchmark's configuration through the port's
           flash_attention: bf16 [1, S, 8, 64], S 2048 and 4096, causal,
           forward + backward of sum(out), in turns with the float32
           kernels on the same values (one launch of each bf16 kernel).
  train bf16 attn
           the slice's Fluid path: Transformer-base's self-attention
           layer (x [16, 512, 512], three fc, cast to bf16, causal
           ring_attention, cast back, fc, squared error), Adam(1e-4), 5
           steps on the card: 5 launches of each bf16 kernel and of the
           delta, no f32 flash launch, no plain call; losses against the
           port's CPU route
           and against the same program without the casts.

  fit_a_line
           the data input stack's first path, the verify recipe:
           dataset.uci_housing.train() -> paddle_tpu_torch.batch(20) ->
           fluid.DataFeeder -> fc -> square_error_cost -> SGD(0.01), 5
           epochs on the card and, from the same initial parameters, on
           the CPU executor: losses within 1e-5 relative step by step,
           the last at most a tenth of the first; p50 step ms, steps/s.
  lstm train
           stacked_dynamic_lstm (models/stacked_lstm.py) at full width:
           emb 512, hid 512 (an LSTM of H 128), 3 stacked, imdb's
           5147-word dictionary, 2 classes, Adam(1e-3), batch 32 from
           dataset.imdb.train() through DataFeeder (T pads to 128), 8
           steps on the card and on the CPU from the same parameters:
           losses finite and within LSTM_LOSS_RTOL, the step-1 gradients
           of the LSTM weights within LSTM_GRAD_TOL of their max; p50
           step ms, real words/s, peak memory, one profiled step (busy
           share, largest entries, device launches).
  resnet recordio
           the resnet train phase's ResNet-50 fed by bench.py:583-628's
           in-graph pipeline (open_recordio_file -> multi_pass ->
           batch(32, drop_last) -> double_buffer(2) -> read_file) over a
           recordio file of uint8 images (bench.py:596-612) in the run's
           temporary directory: both passes (10 steps) in turns with
           the same batches fed as numpy dicts to a copy of the same
           state, losses and state bitwise equal; then EOFException,
           reset_reader rewinds; p50 step ms of each feed, and the
           host-to-device copy of a profiled step (its stream, time and
           overlap with kernels on the compute stream).
  dynamic rnn
           the reference suite's stacked_lstm as
           benchmarks/fluid_suite_bench.py:115-162 builds it
           (models/seq2seq.dynamic_rnn_lstm): embedding 512 over 5147
           words, fc 512 tanh, a DynamicRNN whose LSTM cell is four
           fc-gate pairs with hidden 512, softmax over 2, Adam(1e-3),
           batch 32 cropped to 100 words, 5 steps on the card and on
           the CPU from the same parameters (losses within
           LSTM_LOSS_RTOL, step-1 gradients within LSTM_GRAD_TOL of
           their max), then one ragged batch (lengths 20-100) held alike
           with the DynamicRNN's output 0 past each length; p50 step
           ms, real words/s, peak memory, one profiled step.
  seq2seq  the book's machine translation at width 512 (wmt14's
           30000 words, batch 16 through batch + DataFeeder): 5 Adam
           steps card vs CPU as above; the While beam decode (beam 3,
           MAX_LEN 32) on the trained scope, ids and parents against a
           CPU run under the margin rule, decode ms, loop iterations and
           host syncs; one step of seq_to_seq_net card vs CPU.
  No kernel of the port lies on these five paths: their counts are
  zeroed and read around each main path to show no plain version ran.
  train recipe
           Transformer-base (as train) trained with Adam on
           noam_decay(512, 4000), GradientClipByGlobalNorm(1.0) and
           L2Decay(1e-4): 5 steps without and 5 with recompute (each
           layer a Recompute region) from the same parameters — K1 30
           and 60, K2 18 and 36, K3a/K3b/delta 18 launches a step, no
           plain call; p50 step ms, tokens/s, peak memory (lower with
           recompute), one profiled step each, then RECIPE_TURNS steps
           of each in turns with the train phase's Adam-only program;
           the fetched rate on noam's float64 curve
           within RECIPE_LR_RTOL. The recipe at 2+2 layers, dropout 0,
           batch 2, with and without recompute: one step card vs CPU
           (as train check, on the clipped and decayed gradients the
           optimizer gets; the raw ones reported), 3 steps of each on
           the card, losses within RECIPE_RC_RTOL and step-1 gradients
           within RECIPE_RC_GRAD_TOL of their max (bitwise or not,
           printed). fit_a_line's
           program under SGD, Momentum, Adam, Adagrad, Adamax,
           DecayedAdagrad, Adadelta, RMSProp and Ftrl (the weight at
           ParamAttr(learning_rate=0.5)), 3 steps card vs CPU within
           RECIPE_OPT_RTOL of each parameter's max; ModelAverage's
           apply() against the CPU's and restore() bitwise. A resume:
           3 steps, save_checkpoint, load_checkpoint into a fresh
           scope, 2 steps, bitwise the straight 5 (losses, rates,
           every persistable); bytes, save_s, load_s.
  text book
           the book's text chapters, each built with the port's fluid
           layers, fed from the port's datasets through DataFeeder and
           trained TEXT_STEPS steps: label semantic roles (conll05;
           word_dim 32, mark_dim 5, hidden 512, depth 4 (of 8) alternating
           is_reverse, linear_chain_crf, SGD; batch 10), word2vec
           (imikolov; N 5, emb 32, hidden 256, one shared embedding;
           batch 32), sentiment conv (imdb; two sequence_conv_pools,
           emb 32, hid 32, sqrt pool; batch 32), the recommender system
           (movielens; the towers 200 wide joined by cos_sim; batch 32),
           and a CTC program (fc over [32, 100, 512] into 96 classes,
           warpctc, SGD; ctc_greedy_decoder + edit_distance). Each: p50
           step ms over steps 2-5, real tokens/s (the sum of the @LEN
           companions), peak memory, no plain version; one profiled
           step's device launches and busy share; then TEXT_CHECK_STEPS
           steps at batch TEXT_CHECK_BATCH from the trained state on the
           card and on the CPU (losses within LSTM_LOSS_RTOL) and the
           test program's Viterbi path or edit distances on both, equal
           up to near ties under MARGIN_REL. No kernel of the port lies
           on these paths.
  vision   the image and vision slice: AlexNet and GoogLeNet (224x224,
           1000 classes) and SmallNet (32x32, 10) at batch 128, the
           reference benchmark suite's configurations, VISION_STEPS
           Momentum steps on seeded images (p50 step ms over steps 2-5,
           images/s, peak memory, one profiled step's launches, busy
           share and largest device entries), then test-mode logits
           card vs CPU at batch 2 within VISION_LOGIT_TOL; SSD300 (VGG-16,
           8732 priors, 21 classes, batch 8, 8 seeded boxes an image,
           ssd_loss, Momentum) the same way, its inference program's
           detection_output (nms 0.45, top 400, keep 200) and
           detection_map on the trained state, the post-processing alone
           timed with its launches and held against the CPU on the same
           head outputs (detections under the margin rule, mAP on the
           card's detections bitwise); from the trained state at batch 2
           card vs CPU, the inference program's detections under the
           margin rule (mAP bitwise where no row was cut), then
           SSD_CHECK_STEPS steps (losses within LSTM_LOSS_RTOL); every op
           of the slice card vs CPU at its path's shapes, forward and gradient (VISION_OP_TOL,
           LSTM_GRAD_TOL; index outputs equal). No kernel of the port
           lies on these paths.
  mesh serve
           after parallel: (a) K4 on bf16 pages against its plain
           version (max abs <= BF16_PAGED_TOL, unit-scale inputs),
           bitwise across repeats, timed (decode B=8, prefill C=64,
           verify C=5 at head_dim 64; decode and prefill C=64 at 264,
           512 and 520) with its plain version and SDPA on the K/V
           gathered and widened to float32, in turns; bf16 q returns
           bf16 within a bf16 ulp; (b) the serve phase's GPT-2-medium
           decoder stepped through a bf16 PagedKvCache on the card and
           the CPU (logits within BF16_POOL_LOGIT_REL, tokens equal, K4
           bf16 6 launches a step); (c) load_decoder(mesh_axes="tp=1")
           beside the unsharded engine (MESH_SERVE), 8 concurrent
           requests to each in MESH_TURNS turns: tokens held equal,
           6 K4 launches a target step through local_map, p50 step
           ms, peak memory, K4 through local_map against the direct
           call in turns; (d) save_decoder_checkpoint(mesh_axes="tp=1",
           shard_axis="tp") of the sharded engine and a load that
           deploys sharded (save_s, load_s, bytes); (e) Transformer-base
           with seq_parallel under plan_sequence_parallel() on dp=1,sp=1,
           ring and Ulysses, against the plain Executor's losses
           (SP_LOSS_RTOL), SP_STEPS steps in turns; (f) a Pipeline
           region (PIPE) on pp=1, card vs CPU.
  pserver  after mesh serve, parameter-server training with the trainer
           and the pservers as threads of this process on the one card:
           (a) Transformer-base (dropout 0) transpiled onto two sync
           pservers whose Adam runs on the card, PSERVER_STEPS steps in
           turns with the plain Executor from the same state (losses
           within PSERVER_LOSS_RTOL; K1/K2/K3a/K3b 30/18/18/18 launches
           a trainer step; p50 step ms, tokens/s, RPC bytes a step
           against the parameter bytes, executor.send/recv ms, a
           profiled step's busy share); (b) the sparse phase's V
           1,000,000 program with its table is_distributed on one async
           pserver, on the card and on the CPU from the same state
           (losses within PSERVER_SPARSE_RTOL; bytes a step against the
           table's; p50 step ms beside the in-process sparse step in
           turns); (c) memory_optimize + release_memory on the fused
           ResNet-50 at a static batch of 16 (logits bitwise equal, peak
           memory of each in turns beside estimate_peak_bytes); (d) one
           Transformer-base step under fluid.profiler, whose exported
           trace must name K1-K3b's kernels.
  fleet    after pserver, the serving control plane (paddle_tpu_torch
           fleet, autotune, debug server, timeline) at the serve phase's
           width: (a) a seeded GPT-2-medium checkpoint rolled out by a
           RolloutDriver, canary r0, to two in-process ServingServers
           joined to a FleetController by FleetMembers; (b) the serve
           phase's 8 prompts (32 new tokens) through a FleetRouter at
           once: tokens bitwise the serve phase's, K4 6 launches a
           target step; tokens/s in turns (FLEET_TURNS) of a router at
           the default scrape TTLs, the TTL-0 router, direct
           ServingClient calls to r0, and direct calls split over r0 and
           r1, with each side's decode step spans; the default router's
           added p50 ms a request against direct calls, and the route
           ms of each router; (c) each replica alone while the other's
           pool is pinned full (6 K4 launches a target step each), both
           full: a shed; (e) a skewed ResNet-50 request-size stream and
           decode bursts through the static ladders,
           seed_cache_from_observed into a scoped cache, then
           slots="auto" and buckets="auto" versions fleet-wide: both
           replicas resolve the cached ladders; expected padding waste
           and images/s of the auto and static ladders in turns, 53 K5
           launches a batch; (d) r1 killed mid-FleetTokenStream, the
           stream resumed on r0 with the same tokens; (f) a
           ReplicaLauncher spawns `python -m paddle_tpu_torch.fleet
           --replica --device cuda` from a scale intent: it converges
           from the intent log to the same auto ladders, answers a routed
           request with the same tokens and leaves on SIGTERM (exit 0);
           (g) the debug server's /statusz (fleet, mesh, serving, device
           sections) and /metrics (fleet_*, autotune_*), and `timeline`
           merge of this process's and the replica's trace shards.
  elastic  after fleet, elastic cloud training at the train phase's
           widths: (a) a LeaseServer and two ElectedMaster candidates
           (threads of this process) over one snapshot serve
           ELASTIC_SHARDS recordio shards, each a seeded copy-task batch
           (one record a sequence), with an ELASTIC_LEASE task lease;
           (b) two trainer processes (`chip_smoke.py --elastic-trainer`)
           on the card, each with a WorkerRegistry slot, the master
           found by tcp_endpoint_resolver, Transformer-base in an
           ElasticTrainer: ELASTIC_STEPS steps a task, a checkpoint a
           task, K1/K2/K3a/K3b/delta 30/18/18/18/18 launches a step and
           no plain call (held in the trainer); (c) the victim is
           SIGKILLed holding its second lease, the task requeues when
           the lease expires, a replacement resumes from the victim's
           checkpoint and drains the pass: every record finished exactly
           once, the replacement's first-task losses bitwise an Executor
           here that loads the same checkpoint and runs the same batch,
           the registry lists it; (d) a Go producer reads a fresh pass
           through cloud_reader, stages each batch in BuddyAllocator
           arena views and sends it through a native Channel to
           ELASTIC_CHANNEL_STEPS Executor steps here: losses bitwise the
           same batches fed directly, the arena clean. Seconds of each
           part and the total.
  analysis after elastic, the static passes on the card's paths:
           (a) the train phase's Transformer-base program runs
           ANALYSIS_STEPS steps with FLAGS['verify_programs'] off, then
           a fresh build ANALYSIS_STEPS steps with it on: losses
           bitwise equal, K1/K2/K3a/K3b/delta 30/18/18/18/18 launches a
           step and no plain call, the verifier once per program-cache
           miss (its ms each); verify_program(check_shapes=True) over
           both Transformer programs here (torch on this machine) with
           no error; (b) one FLAGS['check_nan_inf'] step on a NaN feed
           raises FloatingPointError naming the var; (c) the serve
           phase's 8 requests on a GPT-2-medium decoder loaded with the
           guard sanitizer installed: tokens bitwise the serve phase's,
           6 K4 launches a target step, no violation; then (plain,
           sanitized, sanitized, plain) x ANALYSIS_TURNS batches of the
           same requests for the step ms of each side; (d) `python -m
           paddle_tpu_torch.analysis --json` and `--selftest` in
           subprocesses (started first, no device; waited for before
           (c)'s timed batches) exit 0 with no error and every code
           fired.
  v2       after analysis, the v2 API and the legacy config DSL (no
           kernel of the port on their path; every kernel count held at
           0 plain calls): (a) v2.networks.vgg_16_network (13 convs, two
           4096-wide fcs) on cifar train10's first batch through v2.batch
           at V2_VGG_BATCH, init(use_gpu=True), create, SGD with
           v2.optimizer.Momentum for V2_VGG_ITERS iterations of that
           batch through the event handler: costs finite, the last below
           the first; p50
           iteration ms, images/s, peak memory; from the card's initial
           parameters copied to a CPU Parameters, card vs CPU on that
           batch: SGD.test's cost within V2_TEST_RTOL, the logits
           through infer within V2_LOGITS_TOL of the max, and one SGD
           step with dropout off: the gradient of the first conv's filter
           and the last fc's weight (Momentum's velocity after it), on
           the card, on the CPU and between them, against a plain
           PyTorch float64 VGG-16 on the card within V2_STEP_RTOL of its
           norm, or V2_STEP_F32 times plain float32's own distance; (b) tests/test_v2_api.py's
           fit_a_line for V2_FIT_PASSES passes, the cost down 3x, infer
           on 8 test samples card vs CPU (the trained parameters copied)
           within V2_INFER_TOL of the max; (c) conv_operator in a
           mixed_layer at V2_CONV, forward and trans=True: the output and
           the gradients of the image and the computed filter, card vs
           CPU within V2_CONV_TOL of the max, conv2d_input_filter's
           forward timed on each; (d) V2_LEGACY_CONFIG (img_conv_layer
           -> img_pool_layer -> fc_layer -> classification_cost) exec'd
           through compat.trainer_config_helpers behind a `paddle`
           module, V2_LEGACY_STEPS SGD steps on the card, costs finite.

The kernels and train kernels phases also hold K4 and K2/K3a/K3b at
head_dim above 256 (257, 258, 264, 512) and time them at 264 and 512;
the kernels phase holds K4 at the speculative shapes (the verify chunk,
the draft's catch-up and single-token steps, an embed chunk) and times
the verify and draft-step shapes.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. Every line before the last two is also
written to smoke_out/chip_smoke.log.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, float32
# outside the tensor cores, and TF32 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TOL = 1e-4

# GPT-2-medium's widths (Radford et al. 2019, Table 2: d1024, 24 layers;
# 16 heads as in the released config) at 6 of its 24 layers: depth cut
# to keep the decode phases inside the script's time limit
GPT2_MEDIUM = dict(vocab=50257, d_model=1024, n_layers=6, n_heads=16,
                   n_kv_heads=16, seed=0)
SERVE = dict(slots=[1, 2, 4, 8], page_size=16, num_pages=513,
             max_seq_len=1024, prefill_chunk=64)


# every line the script prints also goes to this file (gitignored), whose
# whole text outlives a tail of the output
LOG_PATH = os.path.join(REPO, "smoke_out", "chip_smoke.log")


def log(*a):
    print(*a, flush=True)
    with open(LOG_PATH, "a") as f:
        print(*a, file=f)


_T0 = time.perf_counter()


def phase(name):
    """A phase's header, with the seconds since the script started."""
    log(f"== {name} (at {time.perf_counter() - _T0:.1f} s)")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# --- device --------------------------------------------------------------

def device_phase(torch):
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this "
                           "script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device {name} capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = smi_line()
    log(smi)
    return name, smi


# --- build ---------------------------------------------------------------

# the kernel library whose nvcc takes longest: it keeps compiling while
# the phases that do not launch it run
LATE_LIBRARY = "paged_attention"


def _log_ptxas(ptxas):
    for name, table in ptxas.items():
        for fn, row in table.items():
            log(f"  ptxas {name}: {fn} " + json.dumps(row))


def build_phase():
    """Start every kernel build at once and wait for all but
    LATE_LIBRARY. Returns the ptxas tables and a function that waits for
    LATE_LIBRARY and adds its table (call it before its first launch)."""
    phase("build")
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    late = {}

    def build_late():
        try:
            late["secs"] = _build.build_all([LATE_LIBRARY])
        except Exception as e:  # raised again by finish()
            late["error"] = e

    thread = threading.Thread(target=build_late)
    thread.start()
    secs = _build.build_all([n for n in _build.kernel_sources()
                             if n != LATE_LIBRARY])
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per source {secs}; {LATE_LIBRARY} still building)")
    ptxas = {name: ptxas_table(_build.ptxas_report(name)) for name in secs}
    _log_ptxas(ptxas)

    def finish():
        thread.join()
        if "error" in late:
            raise late["error"]
        log(f"  built {LATE_LIBRARY} {time.perf_counter() - t0:.2f} s "
            f"after the build began (its nvcc {late['secs']})")
        ptxas[LATE_LIBRARY] = ptxas_table(_build.ptxas_report(LATE_LIBRARY))
        _log_ptxas({LATE_LIBRARY: ptxas[LATE_LIBRARY]})
    return ptxas, finish


# template arguments of a mangled kernel name: an int or bool literal,
# float, or __nv_bfloat16
_TEMPLATE_ARG = r"L[ib](-?\d+)E|(f)|\d+(__nv_bfloat16)"


def _kernel_name(mangled):
    """``name<args>`` of a mangled ``..._kernel`` entry point: the
    length-prefixed name that ends in ``_kernel``, and the template
    arguments after it (``Li<n>E``, ``Lb<n>E``, ``f`` for float,
    ``13__nv_bfloat16``); the mangled name if there is none."""
    import re

    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            continue
        end = i + m.end()
        name = mangled[end:end + int(m.group())]
        if name.endswith("_kernel") and name[:1].isalpha():
            rest = mangled[end + len(name):]
            # the kernel's own literal arguments, or those of the first
            # class template among its arguments (a Cfg<...> shape)
            args = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", rest) or \
                re.match(rf"IN[^E]*?I((?:{_TEMPLATE_ARG})+)E", rest)
            if not args:
                return name
            vals = [n or ("float" if f else "bf16") for n, f, _ in
                    re.findall(_TEMPLATE_ARG, args.group(1))]
            return f"{name}<{','.join(vals)}>"
    return mangled


def ptxas_table(report):
    """{kernel<template args>: {registers, spill_stores, spill_loads,
    stack}} from what ``nvcc -Xptxas -v`` printed for one library."""
    import re

    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# --- kernels -------------------------------------------------------------

def _paged_case(torch, rng, *, B, C, Hq, Hkv, D, ps, W, P, kv_lens,
                q_lens):
    """Seeded inputs on the card: tables hold distinct live pages for
    each slot's visible keys and the garbage page 0 past them."""
    import numpy as np

    shape = (B, Hq, D) if C is None else (B, C, Hq, D)
    q = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    kp = torch.from_numpy(rng.randn(P, ps, Hkv, D).astype(np.float32)).cuda()
    vp = torch.from_numpy(rng.randn(P, ps, Hkv, D).astype(np.float32)).cuda()
    kv = np.asarray(kv_lens, np.int32)
    tables = np.zeros((B, W), np.int32)
    pages = rng.permutation(np.arange(1, P))
    used = 0
    for b in range(B):
        n = -(-int(kv[b]) // ps)
        tables[b, :n] = pages[used:used + n] if used + n <= len(pages) \
            else rng.randint(1, P, size=n)
        used += n
    ql = None if q_lens is None else \
        torch.from_numpy(np.asarray(q_lens, np.int32)).cuda()
    return (q, kp, vp, torch.from_numpy(tables).cuda(),
            torch.from_numpy(kv).cuda(), ql)


def _dead_rows(case, out):
    import numpy as np

    kv = np.asarray(case["kv_lens"])
    if case["q_lens"] is None:
        return out[kv == 0]
    ql = np.asarray(case["q_lens"])
    mask = np.arange(out.shape[1])[None, :] >= ql[:, None]
    return out[mask]


# cycles of torch.cuda._sleep queued after the L2 flush: ~1 ms at the
# H100's clocks, longer than any wrapper's host work before its launch
QUEUE_SLEEP_CYCLES = 2_000_000


def _time_ms(torch, fn, flush, n=25, warmup=3):
    """Median device ms of one call, L2 flushed before each (the serving
    step reads a layer's pool cold: 23 other layers ran in between). A
    spin kernel queued after the flush keeps the card busy while the
    host prepares the call, so the events time the call's kernels and
    the gaps between them on the card, not the host's Python work
    before its first launch (a wrapper's host time is read apart, see
    ``_host_us``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_us(torch, fn, n=200):
    """Host microseconds of one call of a wrapper: the wall time of n
    calls queued back to back, then one synchronize, over n (the host's
    Python and launch work where it is longer than the card's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


# what K4's bound_ms counts: its decode path runs on the CUDA cores, its
# chunk (prefill) path takes Q K^T and P V as 3xTF32 on the tensor cores
PAGED_PEAK = ("bytes over 3.35 TB/s against float32 operations over 67 "
              "TFLOP/s; bound_tf32x3_ms: the products as 3xTF32 (3 x 4D "
              "flops a pair over 495 TFLOP/s) + ~5 float32 flops a pair "
              "over 67 TFLOP/s")


def _bound(case, D):
    """Least time for the function on these inputs: bytes each input
    read once (visible K/V only) and each output written once over HBM
    bandwidth, against its float32 operations over the float32 peak
    (``bound_ms``, ``bound_by``); and the same bytes against the
    products as 3xTF32 on the tensor cores plus ~5 float32 flops a
    (query, key) pair (``bound_tf32x3_ms``, the chunk path's floor)."""
    import numpy as np

    B, Hq, Hkv = case["B"], case["Hq"], case["Hkv"]
    C = case["C"] or 1
    kv = np.asarray(case["kv_lens"], np.int64)
    ql = (np.asarray(case["q_lens"], np.int64) if case["q_lens"] is not None
          else (kv > 0).astype(np.int64))
    kv_bytes = 2 * int(kv.sum()) * Hkv * D * 4
    qo_bytes = 2 * B * C * Hq * D * 4
    idx_bytes = 4 * (B * case["W"] + 2 * B)
    pairs = Hq * sum(int(kv[b] - ql[b] + j + 1) for b in range(B)
                     for j in range(int(ql[b])))
    nbytes = kv_bytes + qo_bytes + idx_bytes
    ms, by = _bound_of(nbytes, 4 * D * pairs)
    t_tc = pairs * (3 * 4 * D / TF32_FLOP_PER_S + 5 / F32_FLOP_PER_S)
    return {"bound_ms": ms, "bound_by": by,
            "bound_tf32x3_ms": max(nbytes / HBM_BYTES_PER_S, t_tc) * 1e3,
            "bound_tf32x3_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= t_tc
                                else "operations"),
            "bound_peak": PAGED_PEAK}


def _bound_of(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over HBM bandwidth
    and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_call(torch, args, case):
    """scaled_dot_product_attention on K/V already gathered dense (the
    gather is outside the timed call): the yardstick, never used by the
    port."""
    import torch.nn.functional as F

    q, kp, vp, tables, kv_lens, q_lens = args
    B, W, ps = case["B"], case["W"], kp.shape[1]
    Hq, Hkv, D = case["Hq"], case["Hkv"], kp.shape[3]
    T = int(kv_lens.max().item())
    k = kp[tables.long()].reshape(B, W * ps, Hkv, D)[:, :T]
    v = vp[tables.long()].reshape(B, W * ps, Hkv, D)[:, :T]
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    q4 = q[:, None] if q.ndim == 3 else q
    C = q4.shape[1]
    ql = (kv_lens > 0).int() if q_lens is None else q_lens
    lane = torch.arange(C, device=q.device)[None, :]
    limit = kv_lens[:, None] - ql[:, None] + lane
    t = torch.arange(T, device=q.device)[None, None, :]
    mask = (t <= limit[:, :, None])[:, None]             # [B, 1, C, T]
    qh = q4.transpose(1, 2).contiguous()                 # [B, Hq, C, D]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def _paged_float64(torch, args, scale=None):
    """The paged-attention function in float64 (the plain version's
    formulas on double copies): the accuracy yardstick."""
    q, kp, vp, tables, kv_lens, q_lens = args
    if q.ndim == 3:
        q, q_lens = q[:, None], (kv_lens > 0).int()
    B, C, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    T = tables.shape[1] * ps
    k = kp.double()[tables.long()].reshape(B, T, Hkv, D)
    v = vp.double()[tables.long()].reshape(B, T, Hkv, D)
    k = k.repeat_interleave(Hq // Hkv, 2)
    v = v.repeat_interleave(Hq // Hkv, 2)
    s = torch.einsum("bchd,bthd->bcht", q.double() * (scale or D ** -0.5), k)
    lane = torch.arange(C, device=q.device)[None, :]
    limit = kv_lens.long()[:, None] - q_lens.long()[:, None] + lane
    t = torch.arange(T, device=q.device)[None, None, :]
    keep = ((t <= limit[:, :, None]) & (lane < q_lens.long()[:, None])
            [:, :, None])[:, :, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    o = torch.einsum("bcht,bthd->bchd", p, v)
    return o[:, 0] if args[0].ndim == 3 else o


def _paged_bitwise_checks(torch, pa, rng, base):
    """The kernels' determinism, each a hard check: two launches on the
    same inputs are bitwise equal; slot b launched alone equals slot b
    of the B=8 batch; a decode slot (q_len 1) gives the same bits in a
    C=1 launch and inside a C=64 launch beside prefilling slots (MHA and
    GQA: the per-block path follows the slot's own q_len * rep). At
    head_dim 64 (Hq 16, Hkv 16 and 4), then 264 (Hq 8, Hkv 8 and 2) and
    512 (Hq 8, Hkv 8, 2 and 4): a decode slot of 1, 4 or 2 rows takes the
    wide decode body (its 1-row instance in an MHA C=1 launch, the 4-row
    one beside prefill chunks), the prefilling slots the chunk body. At
    520 (Hq 8, Hkv 8 and 2; inputs from a stream of their own, so the
    rows after keep theirs): paged_wide_kernel."""
    import numpy as np

    kv8 = [1, 1024, 0, 517, 33, 800, 256, 999]
    d520_rng = np.random.RandomState(2041)
    checks = []
    for d, hq, hkv in ((64, 16, 16), (64, 16, 4), (264, 8, 8), (264, 8, 2),
                       (512, 8, 8), (512, 8, 2), (512, 8, 4), (520, 8, 8),
                       (520, 8, 2)):
        for C, ql in ((None, None), (64, [64, 1, 0, 17, 1, 64, 1, 5])):
            case = dict(base, D=d, B=8, C=C, Hq=hq, Hkv=hkv,
                        kv_lens=[max(k, q or 0) for k, q in
                                 zip(kv8, ql or [0] * 8)], q_lens=ql)
            args = _paged_case(torch, d520_rng if d > 512 else rng, **case)
            first = pa.paged_attention(*args[:5], q_lens=args[5])
            second = pa.paged_attention(*args[:5], q_lens=args[5])
            if not torch.equal(first, second):
                raise RuntimeError(f"K4 D={d} Hkv={hkv} C={C}: two "
                                   f"launches differ")
            for b in range(8):
                alone = pa.paged_attention(
                    args[0][b:b + 1], args[1], args[2], args[3][b:b + 1],
                    args[4][b:b + 1],
                    q_lens=None if args[5] is None else args[5][b:b + 1])
                if not torch.equal(alone[0], first[b]):
                    raise RuntimeError(f"K4 D={d} Hkv={hkv} C={C}: slot "
                                       f"{b} alone differs from the batch")
            checks.append(f"D={d} Hkv={hkv} C={C}: repeat and 8 slots "
                          "alone")
            if C is None:
                continue
            # the same slots as a C=1 decode step: q's lane 0, q_len 1
            ones = torch.ones_like(args[5])
            one = pa.paged_attention(args[0][:, :1].contiguous(),
                                     *args[1:5], q_lens=ones)
            dec = [b for b in range(8) if ql[b] == 1]
            for b in dec:
                if not torch.equal(one[b, 0], first[b, 0]):
                    raise RuntimeError(f"K4 D={d} Hkv={hkv}: decode slot "
                                       f"{b} differs between C=1 and C=64")
            checks.append(f"D={d} Hkv={hkv}: decode slots {dec} C=1 == "
                          "C=64")
    torch.cuda.synchronize()
    log("  K4 bitwise: " + "; ".join(checks))
    return checks


SPEC_K4_CASES = ("verify", "draft_catchup", "draft_single", "embed_chunk")


def kernels_phase(torch):
    """K4 against its plain version on seeded cases (max abs error <=
    TOL, dead rows exactly 0; head_dim 64, 18, 100, 256, 1 and 129, and
    264, 512, 257 and 520 above 256, page sizes 16, 5 and 3, MHA and GQA,
    decode and chunked), the bitwise determinism checks, then timed
    at the serving shapes (decode B=8, the one-slot request B=1, GQA
    decode, a C=64 prefill chunk, verify, the draft's decode) and at
    decode and a C=64 chunk at head_dim 264 and 512 (B=8, Hq=Hkv=4):
    the kernel and SDPA on gathered K/V in turns, the plain version
    once, both bounds, the kernel's error against the plain version
    (<= TOL), and the kernel's, the plain version's and SDPA's error
    against float64."""
    phase("kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa

    rng = np.random.RandomState(2024)
    base = dict(D=64, ps=16, W=64, P=600)
    kv8 = [1, 1024, 0, 517, 33, 800, 256, 999]
    cases = {
        "single_token": dict(base, B=8, C=None, Hq=16, Hkv=16,
                             kv_lens=kv8, q_lens=None),
        "chunked": dict(base, B=8, C=64, Hq=16, Hkv=16,
                        kv_lens=[64, 1024, 0, 517, 40, 800, 256, 999],
                        q_lens=[64, 64, 0, 17, 40, 1, 33, 5]),
        "gqa4_single": dict(base, B=8, C=None, Hq=16, Hkv=4,
                            kv_lens=kv8, q_lens=None),
        "gqa4_chunked": dict(base, B=4, C=64, Hq=16, Hkv=4,
                             kv_lens=[700, 64, 3, 0],
                             q_lens=[64, 50, 3, 0]),
        # GQA decode at 16 and 8 rows a group (the decode path's limits)
        "gqa16_single": dict(base, B=4, C=None, Hq=16, Hkv=1,
                             kv_lens=[700, 1, 0, 1024], q_lens=None),
        "d18_chunked": dict(base, D=18, B=4, C=8, Hq=4, Hkv=2,
                            kv_lens=[300, 8, 0, 129],
                            q_lens=[8, 3, 0, 1]),
        "d18_single": dict(base, D=18, B=4, C=None, Hq=8, Hkv=8,
                           kv_lens=[300, 8, 0, 1024], q_lens=None),
        "d100_chunked": dict(base, D=100, B=4, C=33, Hq=8, Hkv=4,
                             kv_lens=[500, 33, 0, 1000],
                             q_lens=[33, 20, 0, 1]),
        "d256_chunked": dict(base, D=256, B=3, C=16, Hq=8, Hkv=2,
                             kv_lens=[400, 16, 1024],
                             q_lens=[16, 2, 1]),
        "d256_gqa8_single": dict(base, D=256, B=3, C=None, Hq=8, Hkv=1,
                                 kv_lens=[400, 0, 1024], q_lens=None),
        # head_dim 1 and 129; page sizes that divide no split or tile
        "d1_ps3_chunked": dict(base, D=1, ps=3, W=100, B=3, C=20, Hq=4,
                               Hkv=2, kv_lens=[290, 20, 1],
                               q_lens=[20, 17, 1]),
        "d129_ps5_chunked": dict(base, D=129, ps=5, W=60, B=3, C=7, Hq=6,
                                 Hkv=3, kv_lens=[300, 7, 61],
                                 q_lens=[7, 2, 1]),
        # head_dim above 256: the wide bodies (paged_wide.cuh), decode
        # and chunked, MHA and GQA, a head_dim that is not a multiple
        # of 4
        "d264_chunked": dict(base, D=264, B=3, C=20, Hq=4, Hkv=2,
                             kv_lens=[600, 20, 0], q_lens=[20, 5, 0]),
        "d264_gqa4_single": dict(base, D=264, B=3, C=None, Hq=8, Hkv=2,
                                 kv_lens=[1024, 0, 77], q_lens=None),
        "d512_single": dict(base, D=512, B=4, C=None, Hq=4, Hkv=4,
                            kv_lens=[1, 700, 0, 300], q_lens=None),
        "d512_chunked": dict(base, D=512, B=2, C=9, Hq=2, Hkv=1,
                             kv_lens=[513, 9], q_lens=[9, 4]),
        "d257_ps3_chunked": dict(base, D=257, ps=3, W=100, B=2, C=5, Hq=2,
                                 Hkv=1, kv_lens=[290, 5],
                                 q_lens=[5, 1]),
        # above head_dim 512: PR 8's paged_wide_kernel (256-column
        # slices), GQA chunked and MHA decode
        "d520_chunked": dict(base, D=520, B=3, C=20, Hq=4, Hkv=2,
                             kv_lens=[600, 20, 0], q_lens=[20, 5, 0]),
        "d520_single": dict(base, D=520, B=4, C=None, Hq=4, Hkv=4,
                            kv_lens=[1, 700, 0, 300], q_lens=None),
        # the speculative serving shapes (drawn from their own
        # RandomState, so the cases above and the timed rows below keep
        # their inputs): the target's verify chunk (spec_k 4 + 1 lanes),
        # the GPT-2-small draft's catch-up chunk and single-token steps
        # on its 12-head pages, and an embed chunk of a 512-key prompt
        "verify": dict(base, B=8, C=5, Hq=16, Hkv=16,
                       kv_lens=[517, 1024, 0, 40, 5, 803, 256, 999],
                       q_lens=[5, 5, 0, 3, 5, 1, 5, 2]),
        "draft_catchup": dict(base, B=8, C=2, Hq=12, Hkv=12,
                              kv_lens=[517, 1024, 0, 40, 2, 803, 256, 1],
                              q_lens=[2, 1, 0, 2, 2, 1, 2, 1]),
        "draft_single": dict(base, B=8, C=None, Hq=12, Hkv=12,
                             kv_lens=[518, 1021, 0, 41, 3, 804, 257, 2],
                             q_lens=None),
        "embed_chunk": dict(base, B=3, C=64, Hq=16, Hkv=16,
                            kv_lens=[512, 64, 0], q_lens=[64, 64, 0]),
    }
    spec_rng = np.random.RandomState(2028)
    # the cases above head_dim 512 draw from their own stream too
    d520_rng = np.random.RandomState(2040)
    max_err = 0.0
    errors = {}
    for name, case in cases.items():
        args = _paged_case(torch, spec_rng if name in SPEC_K4_CASES
                           else d520_rng if case["D"] > 512 else rng,
                           **case)
        ref = pa.paged_attention_reference(*args[:5], q_lens=args[5])
        out = pa.paged_attention(*args[:5], q_lens=args[5])
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        out_np = out.cpu().numpy()
        dead = _dead_rows(case, out_np if out_np.ndim == 4
                          else out_np[:, None])
        if not np.isfinite(out_np).all():
            raise RuntimeError(f"kernel case {name}: non-finite output")
        if dead.size == 0 or np.any(dead != 0.0):
            raise RuntimeError(f"kernel case {name}: dead rows not exactly "
                               f"0 ({dead.size} dead values)")
        if err > TOL:
            raise RuntimeError(f"kernel case {name}: max abs err {err:.3g} "
                               f"> {TOL}")
        max_err = max(max_err, err)
        errors[name] = err
        log(f"  {name}: max abs err {err:.3g}, {dead.size} dead values "
            f"exactly 0")
    bitwise = _paged_bitwise_checks(torch, pa, rng, base)

    # timings at the serving phase's shapes: decode (C=1) at B=8, the
    # one-slot request (B=1, 1024 keys), GQA decode (Hkv=4) and a
    # prefill chunk (C=64); decode at head_dim 264 and 512; ragged
    # kv_lens 512..1024, all slots live.
    # The kernel and SDPA on gathered K/V in turns (the means of two
    # turns each), the plain version once.
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    shapes = {
        "decode": dict(base, B=8, C=None, Hq=16, Hkv=16, P=513,
                       kv_lens=lens, q_lens=None),
        "decode_b1": dict(base, B=1, C=None, Hq=16, Hkv=16, P=513,
                          kv_lens=[1024], q_lens=None),
        "decode_gqa4": dict(base, B=8, C=None, Hq=16, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
        "prefill": dict(base, B=8, C=64, Hq=16, Hkv=16, P=513,
                        kv_lens=lens, q_lens=[64] * 8),
        # head_dim above 256 (the wide decode body): decode B=8, 4 heads
        "decode_d264": dict(base, D=264, B=8, C=None, Hq=4, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
        "decode_d512": dict(base, D=512, B=8, C=None, Hq=4, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
        # speculative serving: the target's verify chunk (spec_k 4 + 1
        # lanes) and the GPT-2-small draft's single-token step
        "verify": dict(base, B=8, C=5, Hq=16, Hkv=16, P=513,
                       kv_lens=lens, q_lens=[5] * 8),
        "draft_decode": dict(base, B=8, C=None, Hq=12, Hkv=12, P=513,
                             kv_lens=lens, q_lens=None),
        # a C=64 prefill chunk above head_dim 256 (the wide chunk body)
        "prefill_d264": dict(base, D=264, B=8, C=64, Hq=4, Hkv=4, P=513,
                             kv_lens=lens, q_lens=[64] * 8),
        "prefill_d512": dict(base, D=512, B=8, C=64, Hq=4, Hkv=4, P=513,
                             kv_lens=lens, q_lens=[64] * 8),
    }
    timings = {}
    for name, case in shapes.items():
        args = _paged_case(torch, rng, **case)
        kw = dict(q_lens=args[5])
        kern = lambda: pa.paged_attention(*args[:5], **kw)  # noqa: E731
        lib = _library_call(torch, args, case)
        k_ms, l_ms, turns = _in_turns(torch, kern, lib, flush)
        row = {"kernel_ms": k_ms, "library_ms": l_ms,
               "ratio_kernel_over_sdpa": k_ms / l_ms,
               "turns_ms": {"kernel": turns[0], "sdpa": turns[1]},
               "plain_ms": _time_ms(torch, lambda: pa.paged_attention_reference(
                   *args[:5], **kw), flush)}
        row.update(_bound(case, case["D"]))
        row["host_us"] = _host_us(torch, kern)
        exact = _paged_float64(torch, args)
        row["vs_float64"] = {
            "kernel": (kern() - exact).abs().max().item(),
            "plain": (pa.paged_attention_reference(*args[:5], **kw)
                      - exact).abs().max().item(),
            "sdpa": (lib().transpose(1, 2).reshape(exact.shape)
                     - exact).abs().max().item()}
        row["vs_plain"] = (kern() - pa.paged_attention_reference(
            *args[:5], **kw)).abs().max().item()
        if row["vs_plain"] > TOL:
            raise RuntimeError(f"kernel shape {name}: max abs err "
                               f"{row['vs_plain']:.3g} > {TOL}")
        row["kv_lens"] = case["kv_lens"]
        row["shape"] = (f"B={case['B']} C={case['C'] or 1} Hq={case['Hq']} "
                        f"Hkv={case['Hkv']} D={case['D']} ps=16 W=64")
        row["q_lens"] = case["q_lens"]
        timings[name] = row
        log(f"  time {name}: " + json.dumps(row))
        del exact
    del flush
    timings["errors"] = errors
    timings["bitwise"] = bitwise
    return max_err, timings


# --- the training kernels (K1 layer norm, K2/K3a/K3b flash attention) ---

# the train phase's shapes: Transformer-base, batch 16, length 512
TRAIN_ROWS, D_MODEL, N_HEADS, SEQ = 16 * 512, 512, 8, 512


def _randn(torch, rng, *shape):
    import numpy as np

    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()


def _flash_case(torch, rng, bh, sq, sk, d, causal):
    """Seeded q/k/v/dO on the card, and the saved LSE and delta from the
    plain forward (the backward kernels' inputs)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v = (_randn(torch, rng, bh, s, d) for s in (sq, sk, sk))
    do = _randn(torch, rng, bh, sq, d)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    delta = (do * o).sum(-1)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                causal=causal, scale=scale)


def _flash_pairs(sq, sk, causal):
    """(query, key) pairs the function computes: all, or causal ones."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


# what the flash kernels' operations are timed against in ``bound_ms``
FLASH_PEAK = ("products as 3xTF32 on the tensor cores (3 x flops over "
              "495 TFLOP/s TF32 dense) + ~5 float32 flops a pair over "
              "67 TFLOP/s")


def _flash_bounds(bh, sq, sk, d, causal):
    """Least time per kernel: each input read once and each output
    written once over HBM bandwidth, against the flops each (query, key)
    pair needs — 2 per multiply-add of the products, plus ~5 for the
    scale, mask, exp and the softmax or ds arithmetic. The card computes
    float32-accurate products fastest as 3xTF32 on the tensor cores
    (three TF32 products each, over the TF32 peak), and the ~5 on the
    float32 ALUs: that is ``bound_ms``. ``bound_f32_ms`` counts every
    flop over the float32 peak (the CUDA-core floor of a scalar kernel,
    the bound before the backward ran on the tensor cores)."""
    pairs = bh * _flash_pairs(sq, sk, causal)
    qo = bh * sq * d * 4
    kv = bh * sk * d * 4
    rows = bh * sq * 4
    out = {}
    for name, nbytes, products in (
            ("flash_fwd_f32", 2 * qo + 2 * kv + rows, 4 * d),
            # reads q, k, v, dO, lse, delta; writes dK, dV
            ("flash_bwd_dkdv_f32", 2 * qo + 4 * kv + 2 * rows, 8 * d),
            # reads q, k, v, dO, lse, delta; writes dQ
            ("flash_bwd_dq_f32", 3 * qo + 2 * kv + 2 * rows, 6 * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (pairs * 3 * products / TF32_FLOP_PER_S
                 + pairs * 5 / F32_FLOP_PER_S)
        out[name] = {
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": FLASH_PEAK,
            "bound_f32_ms": _bound_of(nbytes, pairs * (products + 5))[0]}
    return out


# The yardstick of the flash kernels, pinned: SDPA's memory-efficient
# backend, the one PyTorch runs in float32 on this card (the flash and
# cuDNN backends take fp16/bf16 only). Its products are 3xTF32 mma.sync
# (gemm_kernel_utils.h: OpMultiplyAddFastF32), as K3a/K3b's.
SDPA_LIBRARY = "sdpa efficient (3xTF32 mma.sync)"


def _sdpa(torch, c, causal, heads=N_HEADS, backend="EFFICIENT_ATTENTION"):
    """(forward, backward) calls of SDPA, pinned to one backend (its
    memory-efficient one unless named), on [B, H, S, D] views of a case:
    the yardstick, never used by the port. The backward computes dQ, dK
    and dV from one retained graph."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s, d = c["q"].shape[1], c["q"].shape[-1]
    b = c["q"].shape[0] // heads
    q4, k4, v4 = (t.reshape(b, heads, s, d).detach().requires_grad_()
                  for t in (c["q"], c["k"], c["v"]))
    do4 = c["do"].reshape(b, heads, s, d)
    pinned = getattr(SDPBackend, backend)

    def fwd():
        with sdpa_kernel(pinned):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal)
    out4 = fwd()

    def bwd():
        with sdpa_kernel(pinned):
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)
    return fwd, bwd


def _in_turns(torch, first, second, flush):
    """Two calls timed in turns first, second, second, first (each time
    the median of 25): (first's mean, second's mean, the four times)."""
    times = ([], [])
    for i in (0, 1, 1, 0):
        times[i].append(_time_ms(torch, (first, second)[i], flush))
    return statistics.mean(times[0]), statistics.mean(times[1]), times


def _vs_sdpa_in_turns(torch, port, sdpa, flush, what):
    """The port's call and SDPA's in turns, logged with their ratio."""
    port_ms, sdpa_ms, (tp, ts) = _in_turns(torch, port, sdpa, flush)
    times = {"port": tp, "sdpa": ts}
    log(f"  {what}: port {port_ms:.4f} ms, SDPA efficient {sdpa_ms:.4f} ms, "
        f"ratio {port_ms / sdpa_ms:.3f} (turns {json.dumps(times)})")
    return {"port_ms": port_ms, "sdpa_ms": sdpa_ms,
            "ratio_port_over_sdpa": port_ms / sdpa_ms, "turns_ms": times,
            "library": SDPA_LIBRARY}


def _forward_vs_float64(torch, fa, rng):
    """Max abs error of O and LSE against a float64 forward at the train
    shape, at a 4x longer sequence and at [BH=32, S=SEQ] for each of
    WIDE_TIMED_DIMS, full and causal: K2, the plain version and SDPA's
    memory-efficient forward."""
    out = {}
    shapes = ((16 * N_HEADS, SEQ, D_MODEL // N_HEADS, N_HEADS),
              (2 * N_HEADS, 4 * SEQ, D_MODEL // N_HEADS, N_HEADS)) + tuple(
        (32, SEQ, d, 2) for d in WIDE_TIMED_DIMS)
    for bh, s, d, heads in shapes:
        for causal in (False, True):
            q, k, v = (_randn(torch, rng, bh, s, d) for _ in range(3))
            scale = d ** -0.5
            sc = q.double() @ k.double().transpose(1, 2) * scale
            if causal:
                keep = (torch.arange(s, device=q.device)[:, None]
                        >= torch.arange(s, device=q.device)[None, :])
                sc = sc.masked_fill(~keep, float("-inf"))
            lse = torch.logsumexp(sc, -1)
            o = torch.exp(sc - lse[..., None]) @ v.double()
            del sc
            got = {"kernel": fa._fwd_cuda(q, k, v, causal, scale),
                   "plain": fa.flash_attention_fwd_reference(q, k, v, causal,
                                                             scale)}
            q4, k4, v4 = (x.reshape(bh // heads, heads, s, d)
                          for x in (q, k, v))
            # the op behind SDPA's efficient backend, which returns LSE
            efficient = torch.ops.aten._scaled_dot_product_efficient_attention
            o4, l4 = efficient(q4, k4, v4, None, True, 0.0, causal,
                               scale=scale)[:2]
            got["sdpa_efficient"] = (o4.reshape(bh, s, d),
                                     l4.reshape(bh, -1)[:, :s])
            row = {"max_abs_o_lse": [o.abs().max().item(),
                                     lse.abs().max().item()]}
            for who, (go, gl) in got.items():
                row[who] = [(go.double() - o).abs().max().item(),
                            (gl.double() - lse).abs().max().item()]
            key = (f"BH={bh} S={s}"
                   f"{'' if d == D_MODEL // N_HEADS else f' D={d}'}"
                   f" {'causal' if causal else 'full'}")
            out[key] = row
            log(f"  forward vs float64, {key}: max abs err O/LSE "
                + json.dumps(row))
            del q, k, v, o, lse, got
    torch.cuda.empty_cache()
    return out


def _bwd_float64(torch, c, causal, lse=None, delta=None):
    """(dQ, dK, dV) of a case in float64 by the dense formulas: from
    q, k, v and dO alone, or from the given float32 LSE and delta (the
    kernels' own inputs), which leaves only the backward's arithmetic."""
    q, k, v, do = (c[n].double() for n in ("q", "k", "v", "do"))
    s = q @ k.transpose(1, 2) * c["scale"]
    if causal:
        keep = (torch.arange(q.shape[1], device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1) if lse is None else lse.double()
    p = torch.exp(s - lse[..., None])
    if delta is None:
        delta = (do * (p @ v)).sum(-1)
    ds = p * (do @ v.transpose(1, 2) - delta.double()[..., None])
    return (ds @ k * c["scale"], ds.transpose(1, 2) @ q * c["scale"],
            p.transpose(1, 2) @ do)


def _backward_vs_float64(torch, fa, rng, shapes):
    """Max abs error of dQ/dK/dV against float64 at each (BH, S, head_dim)
    of ``shapes``, full and causal: K3a/K3b and the plain version, each
    from scratch (float32 LSE and delta from the plain forward, as the
    kernels get them) and given the same LSE and delta; SDPA's
    memory-efficient forward + backward from scratch."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for bh, s, d in shapes:
        for causal in (False, True):
            c = _flash_case(torch, rng, bh, s, s, d, causal)
            bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                     causal, c["scale"])
            exact = _bwd_float64(torch, c, causal)
            given = _bwd_float64(torch, c, causal, c["lse"], c["delta"])
            dk, dv = fa._bwd_dkdv_cuda(*bargs)
            port = (fa._bwd_dq_cuda(*bargs), dk, dv)
            plain = fa.flash_attention_bwd_reference(*bargs)
            q4, k4, v4 = (c[n].reshape(bh // N_HEADS, N_HEADS, s, -1)
                          .detach().requires_grad_() for n in "qkv")
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=causal)
                sdpa = [g.reshape(bh, s, -1) for g in torch.autograd.grad(
                    o4, (q4, k4, v4), c["do"].reshape(o4.shape))]

            def err(got, want):
                return [(g.double() - w).abs().max().item()
                        for g, w in zip(got, want)]
            row = {"max_abs_dq_dk_dv": [w.abs().max().item() for w in exact],
                   "kernels": err(port, exact), "plain": err(plain, exact),
                   "sdpa_efficient": err(sdpa, exact),
                   "kernels_given_lse_delta": err(port, given),
                   "plain_given_lse_delta": err(plain, given)}
            key = (f"BH={bh} S={s}{'' if d == D_MODEL // N_HEADS else f' D={d}'}"
                   f" {'causal' if causal else 'full'}")
            out[key] = row
            log(f"  vs float64, {key}: max abs err dQ/dK/dV "
                + json.dumps(row))
            del c, exact, given, port, plain, sdpa, o4
    torch.cuda.empty_cache()
    return out


def _wide_flash_times(torch, fa, rng, dh, flush):
    """K2 and the whole flash backward at [BH=32, S=SEQ, D=dh], each in
    turns with SDPA's memory-efficient call (its time only where SDPA
    takes the head_dim), with the bounds."""
    c = _flash_case(torch, rng, 16 * 2, SEQ, SEQ, dh, False)
    args = (c["q"], c["k"], c["v"], False, c["scale"])
    row = {"shape": f"[BH=32, S={SEQ}, D={dh}] f32 causal=False",
           "bounds": _flash_bounds(32, SEQ, SEQ, dh, False)}

    def port_bwd():  # as _Flash.backward runs it
        delta = fa.flash_delta(c["do"], c["o"])
        return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                      c["lse"], delta, False, c["scale"])
    try:
        sdpa, sdpa_bwd = _sdpa(torch, c, False, heads=2)
        row["forward"] = _vs_sdpa_in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush,
            f"forward (K2) head_dim {dh}")
        row["whole_backward"] = _vs_sdpa_in_turns(
            torch, port_bwd, sdpa_bwd, flush,
            f"whole backward (delta + K3a + K3b) head_dim {dh}")
        del sdpa, sdpa_bwd
    except RuntimeError as e:  # a yardstick only: the port's times stand
        row["sdpa_error"] = f"{type(e).__name__}: {e}"[:300]
        row["forward"] = {"port_ms": _time_ms(
            torch, lambda: fa._fwd_cuda(*args), flush)}
        row["whole_backward"] = {"port_ms": _time_ms(torch, port_bwd,
                                                     flush)}
    # K3a and K3b alone, and the plain versions
    bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], False,
             c["scale"])
    row["dkdv_ms"] = _time_ms(torch, lambda: fa._bwd_dkdv_cuda(*bargs),
                              flush)
    row["dq_ms"] = _time_ms(torch, lambda: fa._bwd_dq_cuda(*bargs), flush)
    for key, name in (("dkdv", fa.BWD_DKDV), ("dq", fa.BWD_DQ)):
        row[f"{key}_share_of_bound"] = (row["bounds"][name]["bound_ms"]
                                        / row[f"{key}_ms"])
    row["plain_fwd_ms"] = _time_ms(
        torch, lambda: fa.flash_attention_fwd_reference(*args), flush)
    row["plain_bwd_ms"] = _time_ms(
        torch, lambda: fa.flash_attention_bwd_reference(*bargs), flush)
    log(f"  head_dim {dh}: " + json.dumps(row))
    return row


# K2, K3a/K3b above head_dim 128: the head_dims held against the plain
# version (520: above 512, flash_wide.cuh's slices) and the (BH, Sq, Sk,
# causal) of each; the head_dims timed and read against float64 at
# [BH=32, S=SEQ]
WIDE_BWD_DIMS = (132, 136, 200, 256, 260, 264, 384, 512, 520)
WIDE_BWD_SHAPES = ((1, 200, 130, True), (1, 130, 200, True),
                   (2, 200, 130, False), (2, 130, 200, False))
WIDE_TIMED_DIMS = (256, 264, 512)


# the delta kernel against its plain version: float32 products summed in
# another order, within DELTA_RTOL of the largest |delta|
DELTA_RTOL = 1e-6


def _hold_delta(torch, c, errs):
    """flash_delta on a case's dO and O against the plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    got = fa._delta_cuda(c["do"], c["o"])
    want = fa.flash_delta_reference(c["do"], c["o"])
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if got.dtype != torch.float32 or not torch.isfinite(got).all() or \
            rel > DELTA_RTOL:
        raise RuntimeError(f"{fa.DELTA} {tuple(c['do'].shape)} "
                           f"{c['do'].dtype}: max abs err {err:.3g} = "
                           f"{rel:.3g} of the max (> {DELTA_RTOL}?)")
    errs[fa.DELTA] = max(errs.get(fa.DELTA, 0.0), err)
    return rel


def _delta_row(torch, c, flush, what):
    """flash_delta timed beside the plain version (and, in float32, one
    library call of the same function), with its bound: dO and O read,
    delta written, one multiply-add an element."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    do, o = c["do"], c["o"]
    rows, d = do.numel() // do.shape[-1], do.shape[-1]
    row = {
        "ms": _time_ms(torch, lambda: fa._delta_cuda(do, o), flush),
        "plain_ms": _time_ms(
            torch, lambda: fa.flash_delta_reference(do, o), flush),
        "library_ms": None,
        "shape": f"dO, O {list(do.shape)} {what}",
        "host_us": _host_us(torch, lambda: fa._delta_cuda(do[:1], o[:1])),
    }
    if do.dtype == torch.float32:  # one call of the same function
        row["library_ms"] = _time_ms(
            torch, lambda: torch.linalg.vecdot(do, o), flush)
        row["library"] = "torch.linalg.vecdot (float32)"
    else:
        row["library_note"] = ("no single PyTorch call: a bf16 product "
                               "rounds to bf16 before a float32 sum")
    row["bound_ms"], row["bound_by"] = _bound_of(
        2 * rows * d * do.element_size() + 4 * rows, 2 * rows * d)
    return row


def _ln_bf16_program(torch):
    """A Fluid program that casts to bfloat16 before layer_norm (float32
    feed x [TRAIN_BATCH, SEQ, D_MODEL] -> cast -> layer_norm over the last
    axis, bf16 scale and bias -> cast back -> mean), run once on the card
    and once on the CPU from the same startup values: one K1 bf16 launch
    on the card and one plain call on the CPU; the output within
    BF16_FLASH_ULPS of its max with at most BF16_FLASH_SHARE differing,
    the mean within one bf16 ulp of the output's max."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.kernels import layer_norm as ln

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[SEQ, D_MODEL], dtype="float32")
        y = layers.layer_norm(layers.cast(x, "bfloat16"), begin_norm_axis=2)
        out = layers.cast(y, "float32")
        loss = layers.mean(out)
    feed = {"x": np.random.RandomState(6).randn(
        TRAIN_BATCH, SEQ, D_MODEL).astype(np.float32)}
    got, counts = {}, {}
    for dev in ("cuda", "cpu"):
        exe, scope = fluid.Executor(dev), fluid.Scope()
        exe.run(startup, scope=scope)
        _reset_kernel_counts()
        got[dev] = exe.run(main, feed=feed, fetch_list=[out, loss],
                           scope=scope)
        counts[dev] = (dict(ln.counts.kernel_launches),
                       dict(ln.counts.plain_calls))
    if counts["cuda"][0][ln.KERNEL_BF16] != 1 or \
            any(counts["cuda"][1].values()) or \
            counts["cpu"][1][ln.KERNEL_BF16] != 1:
        raise RuntimeError(f"layer norm bf16 program: counts (card, cpu) "
                           f"{counts}")
    (oc, lc), (op, lp) = got["cuda"], got["cpu"]
    err, ulps, share = _bf16_ulps(torch.from_numpy(oc), torch.from_numpy(op))
    ulp = err / ulps if ulps else 2.0 ** (math.floor(math.log2(
        float(np.abs(op).max()))) - 7)
    loss_err = abs(float(lc[0]) - float(lp[0]))
    if not np.isfinite(oc).all() or ulps > BF16_FLASH_ULPS or \
            share > BF16_FLASH_SHARE or loss_err > ulp:
        raise RuntimeError(f"layer norm bf16 program: card vs CPU output "
                           f"{ulps:.3g} ulps of max, {share:.3g} differing, "
                           f"mean {lc} vs {lp}")
    out = {"x": [TRAIN_BATCH, SEQ, D_MODEL], "ulps_vs_cpu": ulps,
           "differing_vs_cpu": share, "mean_card": float(lc[0]),
           "mean_cpu": float(lp[0]), "launches": counts["cuda"][0]}
    log("  layer norm bf16 program (cast -> layer_norm -> cast -> mean), "
        "card vs CPU: " + json.dumps(out))
    return out


def train_kernels_phase(torch):
    """K1, K2, K3a and K3b against their plain versions on the card
    (max abs error <= TOL at unit-scale inputs), K3a/K3b launched twice
    for bitwise-equal outputs and read against float64, then timed with
    their plain versions and one library call at the train phase's
    shapes, and the whole flash backward beside SDPA's in turns."""
    phase("train kernels")
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    rng = np.random.RandomState(2025)
    errs = {fa.FWD: 0.0, fa.BWD_DKDV: 0.0, fa.BWD_DQ: 0.0, ln.KERNEL: 0.0,
            ln.KERNEL_BF16: 0.0, fa.DELTA: 0.0}

    def hold(kernel, what, got, want):
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err > TOL:
            raise RuntimeError(f"{kernel} {what}: max abs err {err:.3g} > "
                               f"{TOL} (or not finite)")
        errs[kernel] = max(errs[kernel], err)
        return err

    # K1: the train shape, and rows/width that fit no tile
    for n, f in ((TRAIN_ROWS, D_MODEL), (37, 24), (5, 1000)):
        x = _randn(torch, rng, n, f)
        s, b = _randn(torch, rng, f), _randn(torch, rng, f)
        got = ln._layer_norm_cuda(x, s, b, 1e-5)
        want = ln.layer_norm_reference(x, s, b, 1e-5)
        torch.cuda.synchronize()
        e = [hold(ln.KERNEL, name, g, w)
             for name, g, w in zip(("y", "mean", "rstd"), got, want)]
        log(f"  layer_norm [{n}, {f}]: max abs err y/mean/rstd "
            + " / ".join(f"{x:.3g}" for x in e))

    # K1's bfloat16 form: y within BF16_FLASH_ULPS of the plain version's
    # max with at most BF16_FLASH_SHARE of it differing (both round the
    # same float32 value once, summed in other orders); mean and rstd
    # float32 within TOL
    for n, f in ((TRAIN_ROWS, D_MODEL), (37, 24), (5, 1000)):
        x = _randn(torch, rng, n, f).bfloat16()
        s, b = (_randn(torch, rng, f).bfloat16() for _ in range(2))
        got = ln._layer_norm_cuda(x, s, b, 1e-5)
        want = ln.layer_norm_reference(x, s, b, 1e-5)
        torch.cuda.synchronize()
        err, ulps, share = _bf16_ulps(got[0], want[0])
        if got[0].dtype != torch.bfloat16 or ulps > BF16_FLASH_ULPS or \
                share > BF16_FLASH_SHARE:
            raise RuntimeError(f"{ln.KERNEL_BF16} y [{n}, {f}]: "
                               f"{got[0].dtype}, {ulps:.3g} ulps of the "
                               f"max, {share:.3g} of elements differ")
        errs[ln.KERNEL_BF16] = max(errs[ln.KERNEL_BF16], err)
        e = [hold(ln.KERNEL_BF16, name, g, w) for name, g, w in
             zip(("mean", "rstd"), got[1:], want[1:])]
        log(f"  layer_norm bf16 [{n}, {f}]: y {ulps:.3g} ulps of max, "
            f"{share:.3g} differing; max abs err mean/rstd "
            + " / ".join(f"{x:.3g}" for x in e))
    ln_program = _ln_bf16_program(torch)

    # K2, K3a, K3b: causal and not; S not a multiple of the tiles;
    # Sq != Sk both ways (causal with Sq > Sk too); head_dim 64 (the
    # model's), 16, 20 (zero-padded k slice and head_dim tail), 128 (the
    # largest tensor-core bucket), 18 (zero-padded to 20 by the wrapper),
    # 100, 1, and 256, 132 and 129 (the CUDA-core bucket); above 256, the
    # column slices: 264 and 512, and 258 (padded to 260 by the wrapper)
    cases = [(128, SEQ, SEQ, 64, False), (128, SEQ, SEQ, 64, True),
             (6, 40, 40, 64, True), (6, 40, 72, 64, False),
             (6, 40, 72, 64, True), (6, 100, 33, 16, True),
             (6, 100, 33, 16, False), (6, 77, 50, 20, True),
             (6, 50, 77, 20, False), (4, 200, 130, 128, True),
             (4, 130, 200, 128, False), (8, 300, 170, 64, True),
             (6, 77, 50, 18, True), (6, 50, 77, 18, False),
             (4, 90, 90, 100, True), (4, 200, 130, 256, True),
             (4, 130, 200, 256, False), (3, 70, 70, 132, True),
             (4, 33, 45, 1, True), (3, 60, 60, 129, False),
             (4, 200, 130, 264, True), (3, 130, 200, 264, False),
             (3, 90, 70, 512, True), (2, 70, 90, 512, False),
             (2, 50, 50, 258, True)]
    for bh, sq, sk, d, causal in cases:
        c = _flash_case(torch, rng, bh, sq, sk, d, causal)
        args = (c["q"], c["k"], c["v"])
        o, lse = fa._fwd_cuda(*args, causal, c["scale"])
        bargs = args + (c["do"], c["lse"], c["delta"], causal, c["scale"])
        dk, dv = fa._bwd_dkdv_cuda(*bargs)
        dq = fa._bwd_dq_cuda(*bargs)
        rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
        _hold_delta(torch, c, errs)
        torch.cuda.synchronize()
        e = [hold(fa.FWD, "O", o, c["o"]), hold(fa.FWD, "LSE", lse, c["lse"]),
             hold(fa.BWD_DKDV, "dK", dk, rk), hold(fa.BWD_DKDV, "dV", dv, rv),
             hold(fa.BWD_DQ, "dQ", dq, rq)]
        log(f"  flash bh={bh} sq={sq} sk={sk} d={d} causal={causal}: max "
            f"abs err O/LSE/dK/dV/dQ " + " / ".join(f"{x:.3g}" for x in e))

    # K2 and K3a/K3b above the 128 bucket (csrc/flash_fwd_wide_mma.cuh and
    # flash_bwd_wide_mma.cuh up to 512, flash_wide.cuh above): full and
    # causal, Sq != Sk both ways, S not a multiple of the 64-row tiles,
    # BH = 1; each launched twice for bitwise-equal outputs
    for d in WIDE_BWD_DIMS:
        for bh, sq, sk, causal in WIDE_BWD_SHAPES:
            c = _flash_case(torch, rng, bh, sq, sk, d, causal)
            bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                     causal, c["scale"])
            first, second = ((*fa._fwd_cuda(c["q"], c["k"], c["v"], causal,
                                            c["scale"]),
                              *fa._bwd_dkdv_cuda(*bargs),
                              fa._bwd_dq_cuda(*bargs)) for _ in range(2))
            rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise RuntimeError(f"K2/K3a/K3b bh={bh} sq={sq} sk={sk} "
                                   f"d={d} causal={causal}: two launches "
                                   f"differ")
            o, lse, dk, dv, dq = first
            e = [hold(fa.FWD, "O", o, c["o"]),
                 hold(fa.FWD, "LSE", lse, c["lse"]),
                 hold(fa.BWD_DKDV, "dK", dk, rk),
                 hold(fa.BWD_DKDV, "dV", dv, rv), hold(fa.BWD_DQ, "dQ", dq, rq)]
            log(f"  wide flash bh={bh} sq={sq} sk={sk} d={d} "
                f"causal={causal}: max abs err O/LSE/dK/dV/dQ "
                + " / ".join(f"{x:.3g}" for x in e) + "; two launches "
                "bitwise equal")

    # no atomics: two launches on the training shape's inputs give
    # bitwise-equal O, LSE, dK, dV and dQ
    for causal in (False, True):
        c = _flash_case(torch, rng, 16 * N_HEADS, SEQ, SEQ, 64, causal)
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        first, second = (
            fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
            + fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
            for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise RuntimeError(f"K2/K3a/K3b causal={causal}: two launches "
                               f"on the same inputs differ")
    log("  flash forward and backward: two launches bitwise equal (full "
        "and causal)")
    vs_float64 = _backward_vs_float64(
        torch, fa, rng, ((16 * N_HEADS, SEQ, D_MODEL // N_HEADS),
                         (2 * N_HEADS, 4 * SEQ, D_MODEL // N_HEADS))
        + tuple((32, SEQ, d) for d in WIDE_TIMED_DIMS))
    fwd_vs_float64 = _forward_vs_float64(torch, fa, rng)

    # timings at the train phase's shapes
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rows = {}
    x = _randn(torch, rng, TRAIN_ROWS, D_MODEL)
    s, b = _randn(torch, rng, D_MODEL), _randn(torch, rng, D_MODEL)
    n, f = x.shape
    rows[ln.KERNEL] = {
        "ms": _time_ms(torch, lambda: ln._layer_norm_cuda(x, s, b, 1e-5),
                       flush),
        "plain_ms": _time_ms(torch, lambda: ln.layer_norm_reference(
            x, s, b, 1e-5), flush),
        "library_ms": _time_ms(torch, lambda: F.layer_norm(
            x, (f,), s, b, 1e-5), flush),
        "shape": f"x [{n}, {f}] f32",
    }
    # ~8 flops an element; x read and y written, scale/bias read, two
    # row statistics written
    rows[ln.KERNEL]["bound_ms"], rows[ln.KERNEL]["bound_by"] = _bound_of(
        (2 * n * f + 2 * f + 2 * n) * 4, 8 * n * f)
    xb, sb, bb = x.bfloat16(), s.bfloat16(), b.bfloat16()
    rows[ln.KERNEL_BF16] = {
        "ms": _time_ms(torch, lambda: ln._layer_norm_cuda(xb, sb, bb, 1e-5),
                       flush),
        "plain_ms": _time_ms(torch, lambda: ln.layer_norm_reference(
            xb, sb, bb, 1e-5), flush),
        "library_ms": _time_ms(torch, lambda: F.layer_norm(
            xb, (f,), sb, bb, 1e-5), flush),
        "library": "F.layer_norm on bf16 (y only)",
        "shape": f"x [{n}, {f}] bf16",
        "host_us": _host_us(torch, lambda: ln._layer_norm_cuda(
            xb[:4], sb, bb, 1e-5)),
        "program": ln_program,
    }
    rows[ln.KERNEL_BF16]["bound_ms"], rows[ln.KERNEL_BF16]["bound_by"] = \
        _bound_of((2 * n * f + 2 * f) * 2 + 2 * n * 4, 8 * n * f)

    bh, d = 16 * N_HEADS, D_MODEL // N_HEADS
    backward, forward = {}, {}
    for causal in (False, True):
        c = _flash_case(torch, rng, bh, SEQ, SEQ, d, causal)
        args = (c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        sdpa, sdpa_bwd = _sdpa(torch, c, causal)
        bounds = _flash_bounds(bh, SEQ, SEQ, d, causal)
        if not causal:
            rows[fa.DELTA] = _delta_row(torch, c, flush, "f32")
        timed = {
            fa.FWD: (lambda: fa._fwd_cuda(*args),
                     lambda: fa.flash_attention_fwd_reference(*args), sdpa),
            fa.BWD_DKDV: (lambda: fa._bwd_dkdv_cuda(*bargs),
                          lambda: fa.flash_attention_bwd_reference(*bargs),
                          sdpa_bwd),
            fa.BWD_DQ: (lambda: fa._bwd_dq_cuda(*bargs),
                        lambda: fa.flash_attention_bwd_reference(*bargs),
                        None),
        }
        for name, (kern, plain, lib) in timed.items():
            row = {
                "ms": _time_ms(torch, kern, flush),
                "plain_ms": _time_ms(torch, plain, flush),
                "library_ms": _time_ms(torch, lib, flush) if lib else None,
                **bounds[name],
                "shape": f"[BH={bh}, S={SEQ}, D={d}] f32 causal={causal}",
            }
            if lib:
                row["library"] = SDPA_LIBRARY
            if name == fa.BWD_DKDV:
                row["library_note"] = ("SDPA backward alone: computes dQ, "
                                       "dK and dV (K3a + K3b together)")
            if name == fa.BWD_DQ:
                row["library_note"] = "counted with flash_bwd_dkdv_f32"
                row["plain_note"] = ("the plain backward computes dQ, dK "
                                     "and dV (K3a + K3b together)")
            rows.setdefault(name, {})["causal" if causal else "full"] = row
        def port_bwd():  # as _Flash.backward runs it
            delta = fa.flash_delta(c["do"], c["o"])
            return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                          c["lse"], delta, causal,
                                          c["scale"])
        key = "causal" if causal else "full"
        backward[key] = _vs_sdpa_in_turns(
            torch, port_bwd, sdpa_bwd, flush,
            f"whole backward (delta + K3a + K3b) causal={causal}")
        forward[key] = _vs_sdpa_in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush,
            f"forward (K2) causal={causal}")
        del sdpa, sdpa_bwd
    # head_dim 256 (d_model 512 with 2 heads): the CUDA-core bucket; 264
    # and 512 above it, in 256-column slices: forward and whole backward
    # in turns with SDPA's
    for dh in WIDE_TIMED_DIMS:
        rows[fa.FWD][f"head_dim_{dh}"] = _wide_flash_times(torch, fa, rng,
                                                            dh, flush)
    del flush
    rows[fa.BWD_DKDV]["whole_backward"] = backward
    rows[fa.BWD_DKDV]["vs_float64"] = vs_float64
    rows[fa.FWD]["in_turns"] = forward
    rows[fa.FWD]["vs_float64"] = fwd_vs_float64
    for name, row in rows.items():
        log(f"  time {name}: " + json.dumps(row))
    return errs, rows


# --- serve ---------------------------------------------------------------

def serve_phase(torch):
    phase("serve")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics, tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    steps_c = metrics.counter("serving.decode.target_steps")
    torch.cuda.reset_peak_memory_stats()
    srv = ServingServer()
    addr = srv.serve()
    clients = [ServingClient(addr, timeout=900.0) for _ in range(8)]
    try:
        # the main path's window: counters to 0, load + warm + traffic
        pa.counts.reset()
        steps0 = steps_c.value()
        t0 = time.perf_counter()
        st = clients[0].load_decoder("gpt2m", GPT2_MEDIUM, **SERVE)
        load_s = time.perf_counter() - t0
        log(f"  load+warm {load_s:.2f} s; slots {st['slots']} widths "
            f"{st['table_widths']} chunks {st['chunk_ladder']}; "
            f"{len(st['compiled_shapes'])} step shapes")

        rng = np.random.RandomState(7)
        lens = [int(x) for x in rng.randint(32, 901, size=8)]
        prompts = [[int(t) for t in rng.randint(0, 50257, size=n)]
                   for n in lens]
        results = [None] * 8
        errors = []
        tracing.trace_reset()
        tracing.trace_enable()

        def one(i):
            try:
                results[i] = clients[i].generate("gpt2m", prompts[i],
                                                 max_new_tokens=32)
            except Exception as e:  # reported below, fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        tracing.trace_disable()
        if errors or any(r is None for r in results):
            raise RuntimeError(f"concurrent generate failed: {errors}")
        for r, n in zip(results, lens):
            toks = r["tokens"]
            if len(toks) != 32 or r["prompt_len"] != n or \
                    not all(0 <= t < 50257 for t in toks):
                raise RuntimeError(f"bad generate result {r}")
        gen = sum(len(r["tokens"]) for r in results)

        rep = clients[0].generate("gpt2m", prompts[3], max_new_tokens=32)
        if rep["tokens"] != results[3]["tokens"] or \
                rep["cached_tokens"] <= 0:
            raise RuntimeError(
                f"repeated prompt: tokens equal "
                f"{rep['tokens'] == results[3]['tokens']}, cached_tokens "
                f"{rep['cached_tokens']}")
        stream = clients[1].generate("gpt2m", prompts[5],
                                     max_new_tokens=32, stream=True)
        streamed = list(stream)
        if streamed != results[5]["tokens"]:
            raise RuntimeError("streamed tokens differ from the buffered "
                               "twin")
        models = clients[0].list_models()
        pages_used = models["gpt2m"]["kv"]["pages_used"]
        launches = pa.counts.kernel_launches[pa.KERNEL]
        plain = pa.counts.plain_calls[pa.KERNEL]
        steps = steps_c.value() - steps0
        # the window ends here: the counts belong to the main path
        if pages_used != 0:
            raise RuntimeError(f"pages_used {pages_used} != 0 after drain")
        layers = GPT2_MEDIUM["n_layers"]
        if launches != layers * steps or launches == 0:
            raise RuntimeError(f"kernel launches {launches} != {layers} x "
                               f"{steps} target steps")
        if plain != 0:
            raise RuntimeError(f"plain version ran {plain} times on the "
                               "card's main path")

        spans = [ev for ev in tracing.trace_events()
                 if ev.get("name") == "serving.decode.step"]
        dec = [ev["dur"] / 1e3 for ev in spans
               if ev["args"].get("prefill_tokens") == 0]
        mix = [ev["dur"] / 1e3 for ev in spans
               if ev["args"].get("prefill_tokens", 0) > 0]
        serve = {
            "load_warm_s": load_s,
            "prompt_lens": lens,
            "batch_wall_s": wall,
            "batch_tokens_per_s": gen / wall,
            "batch_steps": len(spans),
            "decode_steps": len(dec),
            "mixed_steps": len(mix),
            "p50_decode_step_ms": statistics.median(dec) if dec else None,
            "p50_mixed_step_ms": statistics.median(mix) if mix else None,
            "target_steps_total": steps,
            "kernel_launches": launches,
            "plain_calls": plain,
            "requests_answered": 10,
            "repeat_cached_tokens": rep["cached_tokens"],
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
        }
        log("  serve " + json.dumps(serve))
        serve["profile"] = profile_decode(torch, clients[2], rng)
        # the spec serve phase holds its tokens against these
        ref = {"prompts": prompts,
               "tokens": [r["tokens"] for r in results]}
        return launches, serve, ref
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


def profile_decode(torch, client, rng, model="gpt2m",
                   what="decode request"):
    """One more request (a 512-token prompt, 16 new tokens) under
    torch.profiler, after the main path's counts were read: device time
    by kernel, and the device's busy share of the request's wall time.
    Reporting only — a profiler that sees no device time says so."""
    from torch.profiler import ProfilerActivity, profile

    prompt = [int(t) for t in rng.randint(0, 50257, size=512)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = client.generate(model, prompt, max_new_tokens=16)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out = _device_summary(events, wall_ms, what)
    out["result"] = {k: res.get(k) for k in (
        "spec_proposed", "spec_accepted", "accept_rate",
        "steps_to_first_token")}
    # K4's share: its split and merge kernels
    k4 = [ev for ev in events
          if str(getattr(ev, "device_type", "")).endswith("CUDA")
          and ("paged_split_kernel" in ev.key
               or "paged_merge_kernel" in ev.key)]
    out["k4_device_ms"] = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0))
        for ev in k4) / 1e3
    out["k4_launches"] = sum(ev.count for ev in k4)
    log(f"  profile {what}: K4 {out['k4_device_ms']:.3f} ms of "
        f"{out['device_busy_ms']:.3f} ms device busy "
        f"({out['k4_launches']} kernel launches)")
    return out


def host_read_ms(torch):
    """The engine's one host read per step: [8, 50257] float32 logits."""
    x = torch.randn(8, 50257, device="cuda")
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --- spec serve, workloads, checkpoint: the rest of decode serving -------

# the draft: GPT-2-small widths (Radford et al. 2019, Table 2: d768, 12
# layers; 12 heads as in the released config) at 3 of its 12 layers (cut
# as the target is), seeded apart from the target
GPT2_SMALL = dict(vocab=50257, d_model=768, n_layers=3, n_heads=12,
                  n_kv_heads=12, seed=1)
SPEC_K = 4
SPEC_ALONE = 4  # the serve phase's prompts sent one at a time, in turns
# the margin rule: card-side greedy tokens are held equal up to the first
# position whose spec-off top-2 logit margin is below MARGIN_REL x the
# row's max |logit| (K4's chunked and single-token forms, and cuBLAS at
# M = B vs B x C, do not round alike: an argmax may flip at a near-tie)
MARGIN_REL = 1e-4
# its sampled counterpart: a seeded draw is held up to the first position
# whose uniform draw lies within DRAW_MARGIN of an edge of its token's
# interval of the spec-off cumulative distribution (a float32 logit
# error of ~1e-6 relative moves those edges by ~1e-6)
DRAW_MARGIN = 1e-5


def _concurrent(clients, model, prompts, max_new, seeds=None, **kw):
    """One generate per prompt, all at once over the RPC front door
    (``seeds``: one sampling seed a request): (results, wall seconds).
    Any failure fails the phase."""
    results = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            results[i] = clients[i % len(clients)].generate(
                model, prompts[i], max_new_tokens=max_new,
                **(kw if seeds is None else dict(kw, seed=seeds[i])))
        except Exception as e:  # reported below, fails the phase
            errors.append(f"{model} request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in results):
        raise RuntimeError(f"concurrent generate failed: {errors}")
    return results, wall


def _all_lanes(torch, engine, seq, chunk=64):
    """A chunked all-lanes pass of the engine's own decoder over ``seq``
    on its device, into a pool of its own (outside every counted
    window): yields (start, logits [c, vocab]) a chunk at a time."""
    from paddle_tpu_torch.serving import decode as td

    spec, params, dev = engine.spec, engine._params, engine.device
    n, ps = len(seq), 16
    pages = -(-n // ps)
    shape = (spec.n_layers, pages + 1, ps, spec.n_kv_heads, spec.head_dim)
    k = torch.zeros(shape, device=dev)
    v = torch.zeros(shape, device=dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32,
                         device=dev)[None]
    with torch.no_grad():
        for start in range(0, n, chunk):
            c = min(chunk, n - start)
            tok = torch.tensor([seq[start:start + c]], dtype=torch.int32,
                               device=dev)
            pos = torch.arange(start, start + c, dtype=torch.int32,
                               device=dev)[None]
            one = torch.tensor([c], dtype=torch.int32, device=dev)
            _, _, lg = td.decoder_step_chunked(
                params, spec, tok, pos, one, k, v, table,
                torch.tensor([start + c], dtype=torch.int32,
                             device=dev), all_lanes=True)
            yield start, lg[0]


def _margins(torch, engine, prompt, tokens, sampling=None):
    """The margin of the logits row behind each generated token, from
    ``_all_lanes`` over prompt + tokens: greedy, the relative top-2
    margin (top1 - top2) / max|logit|; with ``sampling`` (temperature,
    top_k, seed), the replayed draw's distance from its token's interval
    edges (0 where the replay picks another token)."""
    from paddle_tpu_torch.serving import decode as td

    seq = list(prompt) + list(tokens)
    n, P = len(seq), len(prompt)
    rel = []
    for start, lg in _all_lanes(torch, engine, seq[:-1]):
        lo = max(P - 1, start)
        hi = min(n - 1, start + lg.shape[0])
        if lo >= hi:
            continue
        rows = lg[lo - start:hi - start]
        if sampling is None:
            top2 = torch.topk(rows, 2, dim=-1).values
            m = (top2[:, 0] - top2[:, 1]) / rows.abs().amax(-1)
            rel += m.cpu().tolist()
            continue
        for j, row in enumerate(rows.cpu().numpy()):
            g = lo + j + 1 - P          # generated token index
            tok, m = td.sample_draw_margin(row, *sampling, lo + j + 1)
            if m < 0:
                raise RuntimeError(
                    f"sample_draw_margin's replay lies outside token "
                    f"{tok}'s interval (margin {m:.3g}): it no longer "
                    "matches sample_token")
            rel.append(m if tok == tokens[g] else 0.0)
    return rel


def _hold_tokens(what, ref, got, rel, cuts, threshold=MARGIN_REL):
    """The margin rule: ``got`` equals ``ref`` up to the first position
    whose spec-off margin is below ``threshold``; a difference before it
    fails. Cut comparisons are appended to ``cuts``."""
    cut = next((i for i, m in enumerate(rel) if m < threshold), len(ref))
    if got[:cut] != ref[:cut]:
        first = next(i for i in range(cut) if got[i] != ref[i])
        raise RuntimeError(
            f"{what}: token {first} differs ({got[first]} vs {ref[first]}) "
            f"before the first near-tie (position {cut}); margin there "
            f"{rel[first]:.3g}")
    if cut < len(ref):
        cuts.append({"what": what, "cut_at": cut, "margin": rel[cut],
                     "tokens_differ_after": got[cut:] != ref[cut:]})
    return cut


# the seeded decoders re-emit their input token (their own embedding
# outscores every other), so greedy tokens hardly depend on the rest of
# the weights: the speculative and beam paths are also held by the
# logits rows their target calls returned, each within LOGIT_REL x the
# row's max |logit| of a chunked all-lanes pass over the final sequence
LOGIT_REL = 1e-4


class _LogitTap:
    """Records every logits row an engine's target calls return (the
    newest lane of a plain or prefill step, every lane of a verify), with
    its position and the lane tokens that led to it. It keeps views of
    the returned tensors and launches nothing; ``close`` unhooks."""

    def __init__(self, engine):
        self.rows = []
        self._engine = engine
        for name, all_lanes in (("_run_step_arrays", False),
                                ("_run_verify_arrays", True)):
            setattr(engine, name, self._tap(getattr(engine, name),
                                            all_lanes))

    def _tap(self, orig, all_lanes):
        def tap(*arrays):
            lg = orig(*arrays)
            tokens, positions, q_lens = arrays[:3]
            for b, q in enumerate(int(x) for x in q_lens):
                if q == 0:        # a dead row
                    continue
                for j in (range(q) if all_lanes else range(q - 1, q)):
                    self.rows.append((
                        int(positions[b, 0]),
                        tuple(int(t) for t in tokens[b, :j + 1]),
                        lg[b, j] if all_lanes else lg[b]))
            return lg
        return tap

    def close(self):
        for name in ("_run_step_arrays", "_run_verify_arrays"):
            self._engine.__dict__.pop(name, None)


def _hold_logits(torch, what, rows, seqs, prompt_lens, refs,
                 rel=LOGIT_REL):
    """Every recorded row whose lane tokens lie on one of ``seqs`` (a
    lane after a rejected proposal lies on none) within ``rel`` x
    max|row| of that sequence's reference row ``refs[i][position]``, and
    every generated token's row compared."""
    covered = [set() for _ in seqs]
    compared, worst = 0, 0.0
    for p0, toks, row in rows:
        p = p0 + len(toks) - 1
        errs = [(((row - refs[i][p]).abs().max()
                  / refs[i][p].abs().max()).item(), i)
                for i, sq in enumerate(seqs)
                if p < len(sq) and tuple(sq[p0:p + 1]) == toks]
        if not errs:
            continue
        best = min(errs)[0]
        if best > rel:
            raise RuntimeError(
                f"{what}: the logits row at position {p} is {best:.3g} "
                f"x max|logit| from the reference (> {rel})")
        for err, i in errs:
            if err <= rel:
                covered[i].add(p)
        compared += 1
        worst = max(worst, best)
    for i, (sq, n) in enumerate(zip(seqs, prompt_lens)):
        missing = [p for p in range(n - 1, len(sq) - 1)
                   if p not in covered[i]]
        if missing:
            raise RuntimeError(f"{what}: sequence {i}: no logits row "
                               f"compared at positions {missing[:8]}")
    return {"rows_compared": compared, "worst_rel": worst}


def _references(torch, engine, seqs):
    """The all-lanes logits [len, vocab] of each sequence."""
    return [torch.cat([lg for _, lg in _all_lanes(torch, engine, sq)])
            for sq in seqs]


def _spans(model, name):
    from paddle_tpu_torch.observability import tracing

    return [ev["dur"] / 1e3 for ev in tracing.trace_events()
            if ev.get("name") == name
            and ev.get("args", {}).get("model") == model]


def _k4_window(pa, what, launches_per, counters_delta):
    """K4's launches in a counted window against the engines' own step
    counters: launches == sum(layers x steps), no plain call."""
    launches = pa.counts.kernel_launches[pa.KERNEL]
    plain = pa.counts.plain_calls[pa.KERNEL]
    want = sum(n * counters_delta[c] for c, n in launches_per.items())
    if launches != want or launches == 0:
        raise RuntimeError(f"{what}: K4 launches {launches} != {want} "
                           f"({launches_per} x {counters_delta})")
    if plain != 0:
        raise RuntimeError(f"{what}: the plain version ran {plain} times "
                           "on the card's main path")
    return {"kernel_launches": launches, "plain_calls": plain,
            "expected": want, "steps": counters_delta}


def spec_serve_phase(torch, ref):
    """Speculative decoding at GPT-2-medium width over the RPC front
    door: a GPT-2-small draft and the target's own spec as a draft,
    against spec-off, in turns."""
    phase("spec serve")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics, tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    ctr = {c: metrics.counter(c) for c in (
        "serving.decode.target_steps", "serving.decode.spec.draft_steps")}
    prompts_a, ref_tokens = ref["prompts"], ref["tokens"]
    rng = np.random.RandomState(8)
    prompts_b = [[int(t) for t in rng.randint(0, 50257, size=len(p))]
                 for p in prompts_a]
    models = {"off": None, "small": GPT2_SMALL, "self": GPT2_MEDIUM}
    srv = ServingServer()
    addr = srv.serve()
    clients = [ServingClient(addr, timeout=900.0) for _ in range(8)]
    cuts = []
    rejections = []
    runs = []
    sampled_runs = []
    windows = {}
    logits_held = {}
    # what the self draft's rejections are logged against
    cur = {"run": None}
    try:
        def snap():
            return {c: m.value() for c, m in ctr.items()}

        def delta(before):
            return {c: ctr[c].value() - before[c] for c in ctr}

        def run(model, prompts, rows=runs, **gen):
            tracing.trace_reset()
            tracing.trace_enable()
            torch.cuda.reset_peak_memory_stats()
            before = snap()
            cur["run"] = (f"{model} {'A' if prompts is prompts_a else 'B'}"
                          f"{' sampled' if gen else ''}")
            results, wall = _concurrent(clients, model, prompts, 32, **gen)
            tracing.trace_disable()
            d = delta(before)
            prop = sum(r["spec_proposed"] for r in results)
            acc = sum(r["spec_accepted"] for r in results)
            verify = _spans(model, "serving.decode.spec.verify")
            draft = _spans(model, "serving.decode.spec.draft")
            steps = _spans(model, "serving.decode.step")
            row = {"model": model, "prompts": "A" if prompts is prompts_a
                   else "B", "wall_s": wall,
                   "tokens_per_s": sum(len(r["tokens"]) for r in results)
                   / wall,
                   "target_steps": d["serving.decode.target_steps"],
                   "draft_steps": d["serving.decode.spec.draft_steps"],
                   "proposed": prop, "accepted": acc,
                   "accept_rate": acc / prop if prop else None,
                   "rounds": len(verify),
                   "p50_step_ms": statistics.median(steps),
                   "p50_verify_ms": (statistics.median(verify)
                                     if verify else None),
                   "p50_draft_round_ms": (statistics.median(draft)
                                          if draft else None),
                   "draft_steps_per_round": (
                       d["serving.decode.spec.draft_steps"] / len(draft)
                       if draft else None),
                   "peak_memory_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
            if row["p50_draft_round_ms"] is not None:
                row["p50_draft_step_ms"] = (row["p50_draft_round_ms"]
                                            / row["draft_steps_per_round"])
            if gen:
                row["sampling"] = dict(gen, seeds=f"{gen['seeds'][0]}..")
            rows.append(row)
            log(f"  run {model} ({row['prompts']}{', sampled' if gen else ''}"
                f"): " + json.dumps(row))
            return results

        def load(model):
            kw = dict(SERVE)
            if models[model] is not None:
                kw.update(draft_spec=models[model], spec_k=SPEC_K)
            t0 = time.perf_counter()
            st = clients[0].load_decoder(model, GPT2_MEDIUM, **kw)
            log(f"  load+warm {model} {time.perf_counter() - t0:.2f} s; "
                f"{len(st['compiled_shapes'])} step shapes, spec_k "
                f"{st['spec_k']}")
            return srv.registry.get(model)

        off = load("off")
        margins_a = [_margins(torch, off, p, t)
                     for p, t in zip(prompts_a, ref_tokens)]
        res_off_a = run("off", prompts_a)
        for i, r in enumerate(res_off_a):
            _hold_tokens(f"off A[{i}] vs serve", ref_tokens[i],
                         r["tokens"], margins_a[i], cuts)
        for model, draft_layers in (("small", GPT2_SMALL["n_layers"]),
                                    ("self", GPT2_MEDIUM["n_layers"])):
            # the counted window: load + warm + the first traffic
            pa.counts.reset()
            before = snap()
            eng = load(model)
            if model == "self":
                index = {tuple(p): i for ps in (prompts_a, prompts_b)
                         for i, p in enumerate(ps)}
                orig = eng._spec_substep

                def logged(slots, w, orig=orig):
                    out = orig(slots, w)
                    for s in slots:
                        committed, ke, acc = out[id(s)]
                        if acc < ke:
                            i = index.get(tuple(s.req.prompt))
                            g = s.pos + 1 + acc - len(s.req.prompt)
                            rejections.append({"run": cur["run"],
                                               "prompt": i, "token": g})
                    return out

                eng._spec_substep = logged
            tap = _LogitTap(eng)
            results = run(model, prompts_a)
            pages = clients[0].list_models()[model]["kv"]["pages_used"]
            if pages != 0:
                raise RuntimeError(f"{model}: pages_used {pages} != 0")
            windows[model] = _k4_window(
                pa, f"spec serve {model}",
                {"serving.decode.target_steps": GPT2_MEDIUM["n_layers"],
                 "serving.decode.spec.draft_steps": draft_layers},
                delta(before))
            tap.close()
            seqs = [p + r["tokens"] for p, r in zip(prompts_a, results)]
            logits_held[model] = _hold_logits(
                torch, f"spec serve {model}", tap.rows, seqs,
                [len(p) for p in prompts_a], _references(torch, off, seqs))
            del tap
            log(f"  logits {model}: " + json.dumps(logits_held[model]))
            for i, r in enumerate(results):
                _hold_tokens(f"{model} A[{i}] vs serve", ref_tokens[i],
                             r["tokens"], margins_a[i], cuts)
            log(f"  window {model}: " + json.dumps(windows[model]))
        self_a = runs[-1]
        # the trade, one request at a time as a lone user sends them (the
        # prompts are in each engine's prefix cache by now: mostly
        # decode), in turns: a verify round commits up to spec_k + 1
        # tokens for one target step (with 8 requests at once, a verify
        # beside a prefill chunk is a second target call of its round:
        # see the runs' counts); the first SPEC_ALONE prompts
        alone_runs = []
        for m in ("off", "small", "self", "self", "small", "off"):
            cur["run"] = f"{m} A alone"
            before = snap()
            t0 = time.perf_counter()
            for i, p in enumerate(prompts_a[:SPEC_ALONE]):
                r = clients[0].generate(m, p, max_new_tokens=32)
                _hold_tokens(f"{m} A[{i}] alone vs serve", ref_tokens[i],
                             r["tokens"], margins_a[i], cuts)
            wall = time.perf_counter() - t0
            d = delta(before)
            alone_runs.append({
                "model": m, "wall_s": wall,
                "tokens_per_s": 32 * SPEC_ALONE / wall,
                "target_steps": d["serving.decode.target_steps"],
                "draft_steps": d["serving.decode.spec.draft_steps"]})
            log(f"  alone {m}: " + json.dumps(alone_runs[-1]))
        alone = {m: {"tokens_per_s": statistics.mean(
                         r["tokens_per_s"] for r in alone_runs
                         if r["model"] == m),
                     "target_steps": next(r["target_steps"]
                                          for r in alone_runs
                                          if r["model"] == m)}
                 for m in models}
        log(f"  {SPEC_ALONE} requests one at a time: " + json.dumps(alone))
        if not alone["self"]["target_steps"] < alone["off"]["target_steps"]:
            raise RuntimeError(
                f"self draft: {alone['self']['target_steps']} target "
                f"steps for {SPEC_ALONE} requests alone, not fewer than "
                f"spec-off's {alone['off']['target_steps']}")
        if self_a["accept_rate"] < 0.95:
            raise RuntimeError(f"self draft accepted {self_a['accepted']} "
                               f"of {self_a['proposed']} (< 0.95)")
        # the second turn, on fresh prompts, in reverse order
        res_b = {m: run(m, prompts_b) for m in ("self", "small", "off")}
        margins_b = [_margins(torch, off, p, r["tokens"])
                     for p, r in zip(prompts_b, res_b["off"])]
        for m in ("self", "small"):
            for i, r in enumerate(res_b[m]):
                _hold_tokens(f"{m} B[{i}] vs off B", res_b["off"][i]["tokens"],
                             r["tokens"], margins_b[i], cuts)
        # seeded sampling (temperature 1, top-k 40, a seed a request): the
        # draft's proposals now meet the target's own draws, so rejection
        # and rollback run at full width; tokens held by the draw margin
        samp = dict(temperature=1.0, top_k=40,
                    seeds=[1000 + i for i in range(8)])
        res_s = {m: run(m, prompts_a, rows=sampled_runs, **samp)
                 for m in ("off", "small", "self")}
        margins_s = [_margins(torch, off, p, r["tokens"],
                              sampling=(1.0, 40, 1000 + i))
                     for i, (p, r) in enumerate(zip(prompts_a,
                                                    res_s["off"]))]
        held = [_hold_tokens(f"{m} A[{i}] sampled vs off",
                             res_s["off"][i]["tokens"], r["tokens"],
                             margins_s[i], cuts, threshold=DRAW_MARGIN)
                for m in ("small", "self") for i, r in enumerate(res_s[m])]
        # a replay that drifted from the engine's draw would cut early
        # and compare nothing
        total = 2 * sum(len(r["tokens"]) for r in res_s["off"])
        if min(held) == 0 or sum(held) < 0.75 * total:
            raise RuntimeError(f"sampled holds cut too early: {held}")
        if sampled_runs[2]["accept_rate"] < 0.95:
            raise RuntimeError(
                f"self draft, sampled: accepted {sampled_runs[2]['accepted']}"
                f" of {sampled_runs[2]['proposed']} (< 0.95)")
        margins = {"self A": margins_a, "self A alone": margins_a,
                   "self B": margins_b, "self A sampled": margins_s}
        for r in rejections:
            rel = margins.get(r["run"])
            i, g = r["prompt"], r["token"]
            r["margin"] = (rel[i][g] if rel is not None and i is not None
                           and 0 <= g < len(rel[i]) else None)
            log(f"  self-draft rejection: " + json.dumps(r))
        for c in cuts:
            log("  margin rule cut: " + json.dumps(c))
        summary = {}
        for m in models:
            rows = [r for r in runs if r["model"] == m]
            summary[m] = {
                "tokens_per_s_turns": [r["tokens_per_s"] for r in rows],
                "tokens_per_s": statistics.mean(r["tokens_per_s"]
                                                for r in rows),
                "accept_rate": [r["accept_rate"] for r in rows],
                "target_steps": [r["target_steps"] for r in rows],
                "draft_steps": [r["draft_steps"] for r in rows],
                "p50_step_ms": [r["p50_step_ms"] for r in rows],
                "p50_verify_ms": [r["p50_verify_ms"] for r in rows],
                "p50_draft_step_ms": [r.get("p50_draft_step_ms")
                                      for r in rows],
                "peak_memory_allocated_gb": max(
                    r["peak_memory_allocated_gb"] for r in rows),
                "kv_pool_gb": (srv.registry.get(m).cache.hbm_bytes + (
                    srv.registry.get(m)._draft_cache.hbm_bytes
                    if srv.registry.get(m)._draft_cache is not None
                    else 0)) / 1e9}
        log("  spec_off_vs_on " + json.dumps(summary))
        # what the seeded random decoders emit: the share of generated
        # tokens that repeat the prompt's last token (where both models
        # repeat it, any draft agrees with the target)
        gen = [t for r in ref_tokens for t in r]
        copies = sum(t == p[-1] for p, r in zip(prompts_a, ref_tokens)
                     for t in r) / len(gen)
        log(f"  spec-off tokens repeating the prompt's last token: "
            f"{copies:.4f} of {len(gen)}")
        profile = profile_decode(torch, clients[2], rng, model="small",
                                 what="spec request (GPT-2-small draft)")
        return {"spec_off_vs_on": summary, "runs": runs,
                "sampled_runs": sampled_runs,
                "alone": alone, "alone_runs": alone_runs,
                "share_repeating_last_prompt_token": copies,
                "windows": windows, "margin_cuts": cuts,
                "logits_held": logits_held,
                "self_draft_rejections": rejections, "profile": profile,
                "draft": GPT2_SMALL, "spec_k": SPEC_K}
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


# a finite language of four tokens (two choices at each of the first
# three positions): the automaton stops after the fourth
WORKLOAD_MASK = "( 464 | 318 ) ( 1049 | 11 | 257 ) [ 5 6 7 ] 13"


def workloads_phase(torch):
    """The typed workloads over the workload RPC on a GPT-2-medium
    engine with the prefix cache and the embed lane, then decoder
    checkpoints on the same server."""
    phase("workloads")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.serving import decode as td
    from paddle_tpu_torch.serving.workloads import TokenMaskSpec

    ctr = {c: metrics.counter(c) for c in (
        "serving.decode.target_steps", "serving.decode.embed.steps")}
    rng = np.random.RandomState(9)
    srv = ServingServer()
    addr = srv.serve()
    clients = [ServingClient(addr, timeout=900.0) for _ in range(4)]
    cli = clients[0]
    out = {}
    cuts = []
    try:
        pa.counts.reset()
        before = {c: m.value() for c, m in ctr.items()}
        t0 = time.perf_counter()
        cli.load_decoder("gpt2w", GPT2_MEDIUM, prefix_cache=True,
                         embeddings=True, **SERVE)
        out["load_warm_s"] = time.perf_counter() - t0
        eng = srv.registry.get("gpt2w")
        # constrained: every token in the language, finished by the
        # automaton before max_new
        mask = TokenMaskSpec.regex(WORKLOAD_MASK)
        t0 = time.perf_counter()
        con = cli.constrained("gpt2w", [int(t) for t in
                                        rng.randint(0, 50257, 100)],
                              mask, max_new_tokens=16)
        con_s = time.perf_counter() - t0
        auto = mask.compile()
        state = auto.start
        for t in con["tokens"]:
            if not auto.allowed(state, 50257)[t]:
                raise RuntimeError(f"constrained token {t} outside the "
                                   f"language: {con['tokens']}")
            state = auto.step(state, t)
        if len(con["tokens"]) != 4 or not auto.accepting(state) or \
                auto.allowed(state, 50257).any():
            raise RuntimeError(f"constrained decode did not finish with "
                               f"the automaton: {con['tokens']}")
        # embed of a 512-token prompt
        eprompt = [int(t) for t in rng.randint(0, 50257, 512)]
        t0 = time.perf_counter()
        emb = cli.embed("gpt2w", eprompt)
        embed_s = time.perf_counter() - t0
        # beam: k 4 over a 300-token prompt
        bprompt = [int(t) for t in rng.randint(0, 50257, 300)]
        tap = _LogitTap(eng)
        t0 = time.perf_counter()
        beam = cli.beam("gpt2w", bprompt, k=4, max_new_tokens=16)
        beam_s = time.perf_counter() - t0
        tap.close()
        # an embed churn, live_slots sampled during it
        live = metrics.gauge("serving.decode.live_slots.gpt2w.v1")
        seen, stop = [], threading.Event()

        def probe():
            while not stop.is_set():
                seen.append(live.value())
                time.sleep(0.001)

        th = threading.Thread(target=probe)
        th.start()
        churn_prompts = [[int(t) for t in rng.randint(0, 50257, 64 * i)]
                         for i in range(1, 9)]
        churn = [None] * 8

        def one(i):
            churn[i] = clients[i % 4].embed("gpt2w", churn_prompts[i])

        t0 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(900)
        churn_s = time.perf_counter() - t0
        stop.set()
        th.join(30)
        if any(c is None for c in churn):
            raise RuntimeError("embed churn: a request failed")
        if not seen or max(seen) != 0:
            raise RuntimeError(f"live_slots moved during the embed churn "
                               f"(max {max(seen) if seen else None})")
        pages = cli.list_models()["gpt2w"]["kv"]["pages_used"]
        if pages != 0:
            raise RuntimeError(f"workloads: pages_used {pages} != 0")
        out["window"] = _k4_window(
            pa, "workloads",
            {"serving.decode.target_steps": GPT2_MEDIUM["n_layers"],
             "serving.decode.embed.steps": GPT2_MEDIUM["n_layers"]},
            {c: ctr[c].value() - before[c] for c in ctr})
        log("  window workloads: " + json.dumps(out["window"]))

        # the embed against the same request on the CPU (the plain
        # version), from the same parameters
        cpu = td.DecodeEngine(eng.spec, name="gpt2w-cpu", slots=[1],
                              page_size=16, num_pages=40,
                              max_seq_len=1024, prefill_chunk=64,
                              embeddings=True, params=eng._params,
                              warm=False, device="cpu")
        try:
            t0 = time.perf_counter()
            emb_cpu = cpu.embed(eprompt)
            cpu_s = time.perf_counter() - t0
        finally:
            cpu.stop()
        errs = {}
        for key in ("embedding", "logprobs"):
            a = np.asarray(emb[key], np.float64)
            b = np.asarray(emb_cpu[key], np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                raise RuntimeError(f"embed {key}: shape {a.shape} vs "
                                   f"{b.shape} or not finite")
            errs[key] = float(np.abs(a - b).max() / np.abs(b).max())
            if errs[key] > 1e-4:
                raise RuntimeError(f"embed {key}: card vs CPU "
                                   f"{errs[key]:.3g} of max|.| > 1e-4")
        # beam: shared pages, and each beam an independent greedy decode
        # of prompt + [head] (the margin rule)
        if beam["shared_prompt_pages"] <= 0 or len(beam["beams"]) != 4:
            raise RuntimeError(f"beam: {len(beam['beams'])} beams, "
                               f"{beam['shared_prompt_pages']} shared "
                               "pages")
        seqs = [bprompt + b for b in beam["beams"]]
        beam_logits = _hold_logits(torch, "beam", tap.rows, seqs,
                                   [len(bprompt)] * 4,
                                   _references(torch, eng, seqs))
        del tap
        log("  logits beam: " + json.dumps(beam_logits))
        cli.load_decoder("gpt2-cold", GPT2_MEDIUM, prefix_cache=False,
                         **SERVE)
        cold = srv.registry.get("gpt2-cold")
        for i, b in enumerate(beam["beams"]):
            ind = cli.generate("gpt2-cold", bprompt + [b[0]],
                               max_new_tokens=15)["tokens"]
            _hold_tokens(f"beam {i} vs independent", ind, b[1:],
                         _margins(torch, cold, bprompt + [b[0]], ind),
                         cuts)
        out.update({
            "constrained": {"tokens": con["tokens"], "s": con_s,
                            "pattern": WORKLOAD_MASK},
            "embed": {"prompt_len": 512, "s": embed_s,
                      "tokens_per_s": 512 / embed_s,
                      "steps": emb["steps"], "cpu_s": cpu_s,
                      "card_vs_cpu_rel_err": errs},
            "embed_churn": {"requests": 8, "tokens": 64 * 36,
                            "s": churn_s,
                            "tokens_per_s": 64 * 36 / churn_s,
                            "live_slots_max": max(seen),
                            "samples": len(seen)},
            "beam": {"k": 4, "prompt_len": 300, "max_new_tokens": 16,
                     "s": beam_s, "tokens_per_s": 4 * 16 / beam_s,
                     "shared_prompt_pages": beam["shared_prompt_pages"],
                     "cached_tokens": beam["cached_tokens"],
                     "logits_held": beam_logits},
            "margin_cuts": cuts})
        log("  workloads " + json.dumps(out))
        out["checkpoint"] = checkpoint_phase(torch, srv, clients, eng, rng)
        return out
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


def _params_equal(torch, got, want, what, path=""):
    """Two parameter trees bitwise equal, tensor by tensor."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise RuntimeError(f"{what}: parameter keys differ at "
                               f"'{path}'")
        for k in want:
            _params_equal(torch, got[k], want[k], what, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        if len(got) != len(want):
            raise RuntimeError(f"{what}: '{path}' has {len(got)} parts, "
                               f"not {len(want)}")
        for n, (g, w) in enumerate(zip(got, want)):
            _params_equal(torch, g, w, what, f"{path}/{n}")
    elif not torch.equal(got, want):
        raise RuntimeError(f"{what}: tensor '{path}' not bitwise equal")


def checkpoint_phase(torch, srv, clients, eng, rng):
    """save_decoder_checkpoint of the workloads engine's GPT-2-medium
    parameters to a temporary directory (removed afterwards),
    load_decoder(checkpoint_dir=) over RPC: the loaded parameters and an
    all-lanes pass's logits bitwise those of the spec-dict engine, its
    tokens too; a flipped byte failing with the tensor named."""
    phase("checkpoint")
    import shutil
    import tempfile

    from paddle_tpu_torch.checkpoint import (CheckpointCorruptError,
                                             read_manifest,
                                             save_decoder_checkpoint)
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics

    cli = clients[0]
    ctr = {c: metrics.counter(c) for c in (
        "serving.decode.target_steps", "serving.decode.embed.steps")}
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        save_decoder_checkpoint(d, eng.spec, params=eng._params)
        save_s = time.perf_counter() - t0
        m = read_manifest(d)
        nbytes = sum(int(t["nbytes"]) for t in m["tensors"])
        pa.counts.reset()
        before = {c: m.value() for c, m in ctr.items()}
        t0 = time.perf_counter()
        cli.load_decoder("gpt2ck", checkpoint_dir=d, prefix_cache=True,
                         embeddings=True, **SERVE)
        load_s = time.perf_counter() - t0
        prompts = [[int(t) for t in rng.randint(0, 50257, n)]
                   for n in (37, 300, 700)]
        got = [cli.generate("gpt2ck", p, max_new_tokens=16) for p in prompts]
        window = _k4_window(
            pa, "checkpoint", dict.fromkeys(ctr, GPT2_MEDIUM["n_layers"]),
            {c: ctr[c].value() - before[c] for c in ctr})
        want = [cli.generate("gpt2w", p, max_new_tokens=16)
                for p in prompts]
        for g, w in zip(got, want):
            if g["tokens"] != w["tokens"] or g["cached_tokens"] or \
                    w["cached_tokens"]:
                raise RuntimeError(
                    f"checkpoint engine tokens {g['tokens']} != spec-dict "
                    f"engine's {w['tokens']} (cached {g['cached_tokens']}, "
                    f"{w['cached_tokens']})")
        # the weights on the card, and the numbers they give: the tokens
        # of the seed-built decoder hardly depend on them
        ck = srv.registry.get("gpt2ck")
        _params_equal(torch, ck._params, eng._params, "checkpoint engine")
        seq = prompts[1] + want[1]["tokens"]
        lg_ck = torch.cat([lg for _, lg in _all_lanes(torch, ck, seq)])
        lg_w = torch.cat([lg for _, lg in _all_lanes(torch, eng, seq)])
        if not torch.equal(lg_ck, lg_w):
            raise RuntimeError(
                "checkpoint engine: all-lanes logits not bitwise the "
                "spec-dict engine's (max abs diff "
                f"{(lg_ck - lg_w).abs().max().item():.3g})")
        del lg_ck, lg_w
        victim = f"layer{eng.spec.n_layers // 2}/w2"
        ent = next(t for t in m["tensors"] if t["name"] == victim)
        with open(os.path.join(d, m["payload"]), "r+b") as f:
            f.seek(ent["offset"] + 1000)
            b = f.read(1)
            f.seek(ent["offset"] + 1000)
            f.write(bytes([b[0] ^ 0x04]))
        try:
            cli.load_decoder("gpt2bad", checkpoint_dir=d, **SERVE)
        except CheckpointCorruptError as e:
            if victim not in str(e):
                raise RuntimeError(f"corruption error names no tensor: {e}")
            named = str(e)
        else:
            raise RuntimeError("a flipped byte loaded without an error")
        out = {"save_s": save_s, "load_warm_s": load_s,
               "tensor_bytes": nbytes, "tensors": len(m["tensors"]),
               "save_gb_per_s": nbytes / save_s / 1e9,
               "tokens_bitwise_equal": True, "params_bitwise_equal": True,
               "all_lanes_logits_bitwise_equal": len(seq),
               "window": window, "corrupt_error": named[:200]}
        log("  checkpoint " + json.dumps(out))
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --- check against the plain path ----------------------------------------

def check_phase(torch):
    phase("check")
    import numpy as np

    from paddle_tpu_torch.serving import decode as td

    # one mixed step at full width (2 layers): card (kernel) vs CPU
    # (plain version) on the same seeded parameters and inputs
    spec = td.DecoderSpec(**dict(GPT2_MEDIUM, n_layers=2))
    rng = np.random.RandomState(11)
    B, C, ps, W, P = 2, 16, 16, 4, 12
    tokens = rng.randint(0, spec.vocab, size=(B, C)).astype(np.int32)
    positions = np.stack([np.arange(20, 20 + C), np.arange(C)]).astype(
        np.int32)
    q_lens = np.array([C, 9], np.int32)
    kv_lens = np.array([20 + C, 9], np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 0, 0, 0]], np.int32)
    pool = (spec.n_layers, P, ps, spec.n_kv_heads, spec.head_dim)
    k0 = rng.randn(*pool).astype(np.float32)
    v0 = rng.randn(*pool).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = td.build_decoder_params(spec, device=dev)
        with torch.no_grad():
            _, _, logits = td.decoder_step_chunked(
                params, spec, *(torch.from_numpy(a).to(dev) for a in
                                (tokens, positions, q_lens)),
                torch.from_numpy(k0.copy()).to(dev),
                torch.from_numpy(v0.copy()).to(dev),
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(kv_lens).to(dev))
        out[dev] = logits.cpu().numpy()
    lg = out["cuda"]
    if lg.shape != (B, spec.vocab) or not np.isfinite(lg).all():
        raise RuntimeError(f"full-width step logits {lg.shape} not finite "
                           f"or of the wrong shape")
    err = float(np.abs(lg - out["cpu"]).max())
    if err > 1e-3 or not np.array_equal(lg.argmax(-1),
                                        out["cpu"].argmax(-1)):
        raise RuntimeError(f"full-width step: card vs CPU logits max abs "
                           f"err {err:.3g}")
    log(f"  full-width step (2 layers) card vs CPU logits max abs err "
        f"{err:.3g}")

    # a small engine: the same greedy tokens through the kernel and the
    # plain version
    small = td.DecoderSpec(vocab=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=2, seed=11)
    prompts = [[int(t) for t in rng.randint(0, 64, size=n)]
               for n in (5, 13, 20)]
    toks = {}
    for dev in ("cuda", "cpu"):
        eng = td.DecodeEngine(small, slots=[1, 2], page_size=4,
                              num_pages=40, max_seq_len=32,
                              prefill_chunk=8, device=dev)
        try:
            toks[dev] = [eng.generate(p, max_new_tokens=8)["tokens"]
                         for p in prompts]
        finally:
            eng.stop()
    if toks["cuda"] != toks["cpu"]:
        raise RuntimeError(f"small engine tokens differ: {toks}")
    log(f"  small engine: card and CPU tokens equal ({toks['cuda'][0]})")


# --- train: the Fluid training main path ---------------------------------

TRANSFORMER_BASE = dict(src_vocab=32000, trg_vocab=32000, max_len=SEQ,
                        d_model=D_MODEL, n_heads=N_HEADS, d_ff=2048,
                        n_layers=6, dropout=0.1, seq_parallel=True)
TRAIN_BATCH, TRAIN_STEPS = 16, 5


def build_transformer(cfg_kw, lr):
    """Main and startup programs of the Transformer with Adam(lr), built
    with the port's fluid layers (seeded)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        cfg = transformer.TransformerConfig(**cfg_kw)
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = transformer.build_train(cfg, src, trg, lbl)
        _, params_grads = fluid.optimizer.Adam(lr).minimize(cost)
    return main, startup, cost, params_grads


def copy_task_batch(batch, cfg_kw, seed=0):
    """transformer_bench.py's batch: seeded source ids, the target the
    source shifted right by one, the labels the source."""
    import numpy as np

    rng = np.random.RandomState(seed)
    s = rng.randint(3, cfg_kw["src_vocab"],
                    (batch, cfg_kw["max_len"])).astype(np.int64)
    t = np.concatenate([np.zeros((batch, 1), np.int64), s[:, :-1]], axis=1)
    return {"src": s, "trg": t, "lbl": s[:, :, None]}


def _kernel_counts():
    """(launches, plain calls) of every kernel of the port, by name."""
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    launches, plain = {}, {}
    for tally in (ln.counts, fa.counts, fa.counts_bf16, fa.counts_delta,
                  pa.counts, k5.counts):
        launches.update(tally.kernel_launches)
        plain.update(tally.plain_calls)
    return launches, plain


def _reset_kernel_counts():
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    for tally in (ln.counts, fa.counts, fa.counts_bf16, fa.counts_delta,
                  pa.counts, k5.counts):
        tally.reset()


def train_phase(torch):
    phase("train")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    main, startup, cost, pg = build_transformer(TRANSFORMER_BASE, 1e-4)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(main.global_block().ops)} ops in {build_s:.2f} s; "
        f"startup ({len(startup.global_block().ops)} ops) on the card in "
        f"{startup_s:.2f} s; {n_params} parameter values, "
        f"{len(pg)} trained")
    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    want = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
            "flash_delta": 18}
    for k, per_step in want.items():
        if launches[k] != per_step * TRAIN_STEPS:
            raise RuntimeError(f"{k}: {launches[k]} launches in "
                               f"{TRAIN_STEPS} steps, want {per_step} a "
                               f"step")
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite or not falling: {losses}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 "
                  "len512 dropout0.1 adam1e-4 f32",
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "build_s": build_s, "startup_s": startup_s,
        "kernel_launches": launches, "plain_calls": plain,
    }
    log("  train " + json.dumps(train))
    _embedding_grad_repeats(torch, feed)
    train["profile"] = profile_step(torch, exe, main, feed, cost, scope)
    return launches, train


def _embedding_grad_repeats(torch, feed):
    """The step's one scatter with repeated indices is the embedding
    gradient (every target sequence starts with id 0): two calls on the
    feed's target ids must give bitwise-equal tables, as run-to-run
    bitwise-equal losses need."""
    from paddle_tpu_torch.fluid.ops import tensor_ops

    ids = torch.from_numpy(feed["trg"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dy = torch.randn(*ids.shape, D_MODEL, device="cuda", generator=gen)
    w = torch.zeros(TRANSFORMER_BASE["trg_vocab"], D_MODEL, device="cuda")
    first, second = (tensor_ops._lookup_table_grad(
        None, {"W": [w], "Ids": [ids]}, None, {"Out": [dy]}, {})["GRAD@W"]
        for _ in range(2))
    if not torch.equal(first, second):
        raise RuntimeError("embedding gradient: two calls on the same ids "
                           "differ")
    log("  embedding gradient: two calls bitwise equal")


def profile_step(torch, exe, main, feed, cost, scope, what="train step"):
    """One more training step under torch.profiler, after the main
    path's counts were read: device time by kernel and the device's busy
    share of the step's wall time. Reporting only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_summary(prof.key_averages(), wall_ms, what)


def _device_summary(events, wall_ms, what, part=None):
    """Device time by entry of a profiler's ``key_averages()``; with
    ``part`` (name substrings), also the device ms of the entries whose
    name holds one of them (``part_ms``)."""
    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy/memset): an aten op's
    # device time would count its kernels a second time
    rows = [(ev.key, dev_us(ev), ev.count) for ev in events
            if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                   for k, us, n in rows[:12]]}
    if part:
        out["part"] = list(part)
        out["part_ms"] = sum(us for k, us, _ in rows
                             if any(p in k for p in part)) / 1e3
    if not rows:
        out["note"] = "profiler recorded no device time"
    log(f"  profile {what} " + json.dumps(out))
    return out


def train_check_phase(torch):
    """One training step of a 2+2-layer Transformer at full width, on the
    card (kernels) and on the CPU (plain versions), from the same
    parameters: loss within 1e-5 relative; each parameter gradient's max
    abs difference within 1e-3 of its own max abs value (float32; cuBLAS
    and the CPU sum in other orders, the kernels in another order than
    the dense plain versions)."""
    phase("train check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    kw = dict(TRANSFORMER_BASE, n_layers=2, dropout=0.0)
    main, startup, cost, pg = build_transformer(kw, 1e-4)
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    card_scope = fluid.Scope()
    for n in cpu_scope.var_names():
        card_scope.set_var(n, cpu_scope.find_var(n).cuda())
    feed = copy_task_batch(2, kw)
    fetch = [cost] + [g for _, g in pg]
    out, deltas = {}, {}
    for dev, scope in (("cuda", card_scope), ("cpu", cpu_scope)):
        _reset_kernel_counts()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        out[dev] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        deltas[dev] = _kernel_counts()
    per_step = {"layer_norm_f32": 10, "flash_fwd_f32": 6,
                "flash_bwd_dkdv_f32": 6, "flash_bwd_dq_f32": 6,
                "flash_delta": 6}
    zero = dict.fromkeys(deltas["cuda"][0], 0)
    if deltas["cuda"] != ({**zero, **per_step}, zero) or \
            deltas["cpu"] != (zero, {**zero, **per_step}):
        raise RuntimeError(f"kernel/plain counts (card, cpu): {deltas}")
    lc, lp = float(out["cuda"][0][0]), float(out["cpu"][0][0])
    if not np.isfinite(lc) or abs(lc - lp) > 1e-5 * abs(lp):
        raise RuntimeError(f"loss card {lc} vs cpu {lp}")
    worst = _worst_grad(pg, out["cuda"][1:], out["cpu"][1:], 1e-3,
                        "card vs cpu")["worst_rel_err"]
    log(f"  transformer 2+2L full width, batch 2: loss card {lc:.7f} cpu "
        f"{lp:.7f}; {len(pg)} gradients agree, worst max-diff/max "
        f"{worst:.3g}")
    return {"loss_card": lc, "loss_cpu": lp, "grads": len(pg),
            "worst_grad_rel_err": worst}


# --- resnet train: ResNet-50 training through the Fluid Executor --------

def logits_var(program):
    """The name of the logits of an image-classification program: the
    input of its softmax."""
    return [op for op in program.global_block().ops
            if op.type == "softmax"][-1].input("X")[0]


def fold_trained_network(trained, scope, fused, fused_scope):
    """Fill the fused inference program's parameters from a trained
    network of the same model function (resnet.py builds the two forms
    one to one): in program order, each conv2d + batch_norm pair gives one
    conv2d_bn_relu op its Filter, and fold_bn of the batch norm's scale,
    bias and running mean and variance its Scale/Shift; every other
    parameter (the fc's) copies by name. Returns the number of pairs."""
    from paddle_tpu_torch.kernels.conv_bn_relu import fold_bn

    ops = trained.global_block().ops
    bn_of = {op.input("X")[0]: op for op in ops if op.type == "batch_norm"}
    pairs = [(op, bn_of[op.output("Output")[0]]) for op in ops
             if op.type == "conv2d"]
    convs = [op for op in fused.global_block().ops
             if op.type == "conv2d_bn_relu"]
    if len(pairs) != len(convs):
        raise RuntimeError(f"{len(pairs)} conv2d + batch_norm pairs "
                           f"against {len(convs)} conv2d_bn_relu ops")

    def value(op, slot):
        return scope.find_var(op.input(slot)[0])

    def put(name, t):
        old = fused_scope.find_var(name)
        if tuple(old.shape) != tuple(t.shape):
            raise RuntimeError(f"{name}: {tuple(t.shape)} into "
                               f"{tuple(old.shape)}")
        fused_scope.set_var(name, t.to(old.device))

    folded = set()
    for (conv, bn), op in zip(pairs, convs):
        sc, sh = fold_bn(value(bn, "Scale"), value(bn, "Bias"),
                         value(bn, "Mean"), value(bn, "Variance"),
                         float(bn.attr("epsilon")))
        for slot, t in (("Filter", value(conv, "Filter")), ("Scale", sc),
                        ("Shift", sh)):
            put(op.input(slot)[0], t)
            folded.add(op.input(slot)[0])
    for p in fused.global_block().all_parameters():
        if p.name not in folded:
            put(p.name, scope.find_var(p.name))
    return len(pairs)


# the resnet train phase: ResNet-50 ImageNet as in the infer phase, with
# Momentum(0.01, 0.9) at batch 32 (bench.py:80, :625-636), 5 steps on one
# seeded batch as bench.py's --use_fake_data
RESNET_TRAIN_BATCH, RESNET_TRAIN_STEPS, RESNET_LR = 32, 5, 0.01
# resnet train check: the card's gradients against float64 may err this
# many times the CPU float32's (relative L2 over all parameters), and no
# tensor by more than GRAD_TENSOR_MAX of its max (see the phase)
GRAD_FACTOR, GRAD_TENSOR_MAX = 3, 0.5


def build_resnet50_train(seed):
    """The port's ResNet-50 training program, seeded: (main, startup,
    test, cost, acc, params_grads); ``test`` is the for_test clone taken
    before Momentum.minimize (the unfused inference network)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img",
                          shape=[3, RESNET_IMAGE, RESNET_IMAGE],
                          dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = resnet.build_train(img, label,
                                          class_dim=RESNET_CLASSES, depth=50)
        test = main.clone(for_test=True)
        _, pg = fluid.optimizer.Momentum(
            learning_rate=RESNET_LR, momentum=0.9).minimize(cost)
    return main, startup, test, cost, acc, pg


def _bn_stats(program):
    """[(running mean, running variance)] names, in program order."""
    return [(op.output("MeanOut")[0], op.output("VarianceOut")[0])
            for op in program.global_block().ops if op.type == "batch_norm"]


def _scope_copy(fluid, scope):
    out = fluid.Scope()
    for n in scope.var_names():
        out.set_var(n, scope.find_var(n).clone())
    return out


def _same_state(torch, a, b):
    """Names whose tensors differ in any bit between two scopes."""
    return [n for n in a.var_names()
            if not torch.equal(a.find_var(n), b.find_var(n))]


def _one_step(exe, main, feed, cost, scope):
    import numpy as np

    (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    return float(np.asarray(loss).reshape(-1)[0])


def resnet_train_phase(torch):
    """The Fluid training main path: ResNet-50 ImageNet at full width,
    Momentum(0.01, 0.9), batch 32, the startup program run on the card,
    one seeded batch copied to the card once, 5 steps. Counters zeroed
    just before the steps and read just after: no plain version of any
    kernel ran (this path runs none of K1-K5: its convolutions are
    cuDNN's, as the JAX package leaves them to XLA). The losses finite,
    every running mean and variance moved off its initial value. Then
    from the state after the steps: the same step twice, bitwise equal
    in loss and every scope tensor; steps with the convolutions' cuDNN
    algorithms restricted to the deterministic ones (the port's choice)
    and with cuDNN's default choice, 3 each in turns, timed, and whether
    a default step repeats bitwise (recorded, not held); one step under
    torch.profiler."""
    phase("resnet train")
    import contextlib

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.ops import nn_ops

    t0 = time.perf_counter()
    main, startup, test, cost, acc, pg = build_resnet50_train(seed=3)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    ops = [op.type for op in main.global_block().ops]
    census = {
        "ops": len(ops),
        "forward": sum(1 for t in ops[:ops.index("fill_constant")]
                       if t != "assign"),
        "grad": sum(1 for t in ops if t.endswith("_grad")),
        "grad_sums": ops.count("sum"),
        "momentum": ops.count("momentum"),
        "assign": ops.count("assign"),
        "conv2d": ops.count("conv2d"), "batch_norm": ops.count("batch_norm"),
    }
    if (census["conv2d"], census["batch_norm"], census["momentum"]) != \
            (CONVS_PER_FORWARD, CONVS_PER_FORWARD, len(pg)):
        raise RuntimeError(f"ResNet-50 train program census {census}")
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(ops)} ops in {build_s:.2f} s; startup "
        f"({len(startup.global_block().ops)} ops) on the card in "
        f"{startup_s:.2f} s; {n_params} parameter values, {len(pg)} "
        f"trained; census {json.dumps(census)}")
    stats = _bn_stats(main)
    initial = {n: scope.find_var(n).clone() for pair in stats for n in pair}

    rng = np.random.RandomState(0)
    x = rng.randn(RESNET_TRAIN_BATCH, 3, RESNET_IMAGE,
                  RESNET_IMAGE).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (RESNET_TRAIN_BATCH, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = {"img": torch.from_numpy(x).cuda(),
            "label": torch.from_numpy(y.astype(np.int64)).cuda()}
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, accs, step_ms = [], [], []
    for _ in range(RESNET_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, a = exe.run(main, feed=feed, fetch_list=[cost, acc],
                          scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        accs.append(float(np.asarray(a).reshape(-1)[0]))
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite: {losses}")
    still = [n for n, t in initial.items()
             if torch.equal(scope.find_var(n), t)]
    if still:
        raise RuntimeError(f"{len(still)} running statistics never moved, "
                           f"e.g. {still[:3]}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "resnet-50 imagenet 224x224x3 1000 classes f32, "
                  "momentum 0.01/0.9, fake data (one seeded batch)",
        "batch": RESNET_TRAIN_BATCH, "steps": RESNET_TRAIN_STEPS,
        "losses": losses, "accuracies": accs, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "images_per_s": RESNET_TRAIN_BATCH / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb, "feed_copy_ms": feed_ms,
        "build_s": build_s, "startup_s": startup_s, "census": census,
        "kernel_launches": launches, "plain_calls": plain,
        "running_stats_moved": 2 * len(stats),
    }
    log("  resnet train " + json.dumps(train))

    # the same step from the same state, twice: bitwise equal
    after = _scope_copy(fluid, scope)
    runs = []
    for _ in range(2):
        s = _scope_copy(fluid, after)
        runs.append((_one_step(exe, main, feed, cost, s), s))
    differ = _same_state(torch, runs[0][1], runs[1][1])
    if runs[0][0] != runs[1][0] or differ:
        raise RuntimeError(f"the same step twice: losses {runs[0][0]!r} "
                           f"{runs[1][0]!r}; {len(differ)} scope tensors "
                           f"differ, e.g. {differ[:3]}")
    log(f"  the same step twice from the same state: loss "
        f"{runs[0][0]!r}, {len(after.var_names())} scope tensors bitwise "
        f"equal")
    del runs

    # the convolutions with cuDNN's default algorithm choice against the
    # deterministic ones, in turns (3 steps each), and whether a default
    # step repeats bitwise (recorded)
    saved = nn_ops._conv_algorithms

    def default_choice(x):
        return contextlib.nullcontext()

    turns = {"deterministic": [], "default": []}
    s = _scope_copy(fluid, after)
    try:
        for order in (("deterministic", "default"),
                      ("default", "deterministic"),
                      ("deterministic", "default")):
            for mode in order:
                nn_ops._conv_algorithms = saved if mode == "deterministic" \
                    else default_choice
                t0 = time.perf_counter()
                _one_step(exe, main, feed, cost, s)
                turns[mode].append((time.perf_counter() - t0) * 1e3)
        nn_ops._conv_algorithms = default_choice
        again = [_scope_copy(fluid, after) for _ in range(2)]
        free_losses = [_one_step(exe, main, feed, cost, t) for t in again]
        free_differ = _same_state(torch, *again)
    finally:
        nn_ops._conv_algorithms = saved
    del s, again
    train["cudnn_algorithms_in_turns"] = {
        "step_ms": turns,
        "p50_step_ms": {k: statistics.median(v) for k, v in turns.items()},
        "default_repeats_bitwise": free_losses[0] == free_losses[1]
        and not free_differ,
        "default_tensors_differing": len(free_differ),
    }
    log("  cuDNN algorithms, in turns " +
        json.dumps(train["cudnn_algorithms_in_turns"]))
    train["profile"] = profile_step(torch, exe, main, feed, cost,
                                    _scope_copy(fluid, after))
    del after
    return train, (main, test, cost, pg, scope)


def resnet_train_check_phase(torch, trained):
    """One ResNet-50 training step at full width, batch 2, 224x224, from
    the same state (the trained scope copied as numpy arrays) and the
    same feed, on the card, on the CPU, and on the CPU in float64. Card
    against CPU: the loss within TOL relative, every updated running mean
    and variance within TOL of its tensor's largest |value|.

    The parameter gradients cannot be held to TOL: a forward value
    within float32 rounding of a relu's kink (or a max-pool tie) takes
    the other side in another summation order, and the gradient is not
    continuous there. The CPU's own float32 gradients miss float64 by
    ~1-2% (relative L2 over all parameters) and by up to ~25% of one
    tensor's max, the last stage's most (few positions a channel). So
    they are held against float64: the card's relative L2 error over all
    parameters within GRAD_FACTOR times the CPU float32's, each tensor
    within GRAD_TENSOR_MAX of its max (a wrong gradient errs by ~100%).
    The largest errors are recorded."""
    phase("resnet train check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, _, cost, pg, card_trained = trained
    arrays = {n: card_trained.find_var(n).cpu().numpy()
              for n in card_trained.var_names()}
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 3, RESNET_IMAGE,
                             RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (2, 1)).astype(np.int64)}
    stats = [n for pair in _bn_stats(main) for n in pair]
    out, secs, scopes = {}, {}, {}
    for run, dev, dtype in (("cuda", "cuda", np.float32),
                            ("cpu", "cpu", np.float32),
                            ("cpu64", "cpu", np.float64)):
        scopes[run] = fluid.Scope()
        fluid.params_from_jax(
            {n: a.astype(dtype) if a.dtype == np.float32 else a
             for n, a in arrays.items()}, scopes[run], device=dev)
        _reset_kernel_counts()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        t0 = time.perf_counter()
        out[run] = [np.asarray(v, np.float64) for v in exe.run(
            main, feed=dict(feed, img=feed["img"].astype(dtype)),
            fetch_list=[cost] + [g for _, g in pg], scope=scopes[run])]
        secs[run] = time.perf_counter() - t0
        if any(_kernel_counts()[1].values()):
            raise RuntimeError(f"a plain version ran on {run}")
    lc, lp, l64 = (float(out[r][0][0]) for r in ("cuda", "cpu", "cpu64"))
    if not np.isfinite(lc) or abs(lc - lp) > TOL * abs(lp):
        raise RuntimeError(f"loss card {lc} vs cpu {lp}")

    def rel(got, want):
        scale = float(np.abs(want).max())
        return float(np.abs(got - want).max()) / scale if scale else \
            float(np.abs(got).max())

    grads = {r: out[r][1:] for r in out}
    per = [(p.name, rel(gc, g64), rel(gp, g64), rel(gc, gp))
           for (p, _), gc, gp, g64 in zip(pg, grads["cuda"], grads["cpu"],
                                          grads["cpu64"])]

    def l2(run):
        num = sum(float(np.square(g - w).sum())
                  for g, w in zip(grads[run], grads["cpu64"]))
        den = sum(float(np.square(w).sum()) for w in grads["cpu64"])
        return (num / den) ** 0.5

    stat_err = [(n, rel(scopes["cuda"].find_var(n).cpu().numpy(),
                        scopes["cpu"].find_var(n).numpy())) for n in stats]
    worst = {key: max(((e[i], e[0]) for e in per), default=None)
             for i, key in ((1, "grad_card_vs_f64"), (2, "grad_cpu_vs_f64"),
                            (3, "grad_card_vs_cpu"))}
    worst["stat_card_vs_cpu"] = max((e, n) for n, e in stat_err)
    # the five gradients whose card error is the largest multiple of the
    # CPU float32's: (card vs f64, cpu vs f64, name)
    worst["grad_ratio_top5"] = sorted(
        ((e[1], e[2], e[0]) for e in per),
        key=lambda t: -t[0] / max(t[1], 1e-30))[:5]
    check = {"loss_card": lc, "loss_cpu": lp, "loss_cpu_f64": l64,
             "grads": len(pg), "stats": len(stats), "worst": worst,
             "grad_l2_rel_err_vs_f64": {"card": l2("cuda"), "cpu": l2("cpu")},
             "cpu_step_s": secs["cpu"], "cpu_f64_step_s": secs["cpu64"]}
    log("  resnet50 batch 2 card vs cpu " + json.dumps(check))
    l2_card, l2_cpu = (check["grad_l2_rel_err_vs_f64"][k]
                       for k in ("card", "cpu"))
    if not l2_card <= GRAD_FACTOR * l2_cpu + 1e-6:
        raise RuntimeError(f"gradients: card vs float64 {l2_card:.3g} "
                           f"(relative L2 over all parameters), more than "
                           f"{GRAD_FACTOR}x the CPU float32's {l2_cpu:.3g}")
    for name, e_card, _, _ in per:
        if not e_card <= GRAD_TENSOR_MAX:
            raise RuntimeError(f"gradient of {name}: card vs float64 "
                               f"{e_card:.3g} of max > {GRAD_TENSOR_MAX}")
    for n, r in stat_err:
        if r > TOL:
            raise RuntimeError(f"running statistic {n}: card vs cpu {r:.3g}"
                               f" of max > {TOL}")
    return check


def resnet_fold_phase(torch, trained):
    """The trained network served through K5: fold_bn of each conv2d +
    batch_norm pair's statistics into the fused program that
    resnet_imagenet(depth=50, is_test=True, fused=True) builds (53 pairs
    against 53 conv2d_bn_relu ops), then a seeded batch of 16 through the
    fused program (counters zeroed just before and read just after: 53
    K5 launches, no plain call) and through the unfused test-mode
    network (cuDNN conv + batch_norm is_test): logits within TOL of the
    largest |logit|."""
    phase("resnet fold")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    _, test, _, _, scope = trained
    fused, fstartup, flogits, _ = build_resnet50(seed=1)
    exe, fscope = fluid.Executor(), fluid.Scope()
    exe.run(fstartup, scope=fscope)
    pairs = fold_trained_network(test, scope, fused, fscope)
    if pairs != CONVS_PER_FORWARD:
        raise RuntimeError(f"{pairs} folded pairs, want {CONVS_PER_FORWARD}")
    rng = np.random.RandomState(10)
    x = _images(rng, INFER_BATCH)
    label = np.zeros((INFER_BATCH, 1), np.int64)
    _reset_kernel_counts()
    (got,) = exe.run(fused, feed={"img": x}, fetch_list=[flogits],
                     scope=fscope)
    launches, plain = _kernel_counts()
    if launches["conv_bn_relu_f32"] != CONVS_PER_FORWARD or \
            any(plain.values()):
        raise RuntimeError(f"fused forward: launches {launches}, plain "
                           f"{plain}")
    (want,) = exe.run(test, feed={"img": x, "label": label},
                      fetch_list=[logits_var(test)], scope=scope)
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if got.shape != (INFER_BATCH, RESNET_CLASSES) or \
            not np.isfinite(got).all() or rel > TOL:
        raise RuntimeError(f"fused vs unfused logits: {rel:.3g} of max "
                           f"|logit| > {TOL} (or not finite)")
    fold = {"pairs": pairs, "launches": launches["conv_bn_relu_f32"],
            "rel_err": rel, "max_abs_logit": scale,
            "argmax_equal": bool((got.argmax(-1) == want.argmax(-1)).all())}
    log("  resnet fold " + json.dumps(fold))
    return fold


# --- infer kernels: K5, the fused conv + folded-BN + relu ----------------

# the infer phase: ResNet-50 ImageNet (He et al. 2016, Table 1,
# "50-layer"; the repo's resnet_imagenet(depth=50)), 224x224x3, 1000
# classes, float32; batches padded up to this ladder
RESNET_IMAGE, RESNET_CLASSES = 224, 1000
INFER_BUCKETS = [1, 2, 4, 8, 16]
INFER_BATCH = INFER_BUCKETS[-1]
CONVS_PER_FORWARD = 53


def build_resnet50(seed, batch=None):
    """The port's fused ResNet-50 inference program (+ softmax), seeded:
    (main, startup, logits, prob). ``batch`` fixes the image feed's
    batch, so every activation has a static shape (memory_optimize
    reuses only those)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    shape = [3, RESNET_IMAGE, RESNET_IMAGE]
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img",
                          shape=shape if batch is None else [batch] + shape,
                          dtype="float32", append_batch_size=batch is None)
        logits = resnet.resnet_imagenet(img, class_dim=RESNET_CLASSES,
                                        depth=50, is_test=True, fused=True)
        prob = layers.softmax(logits)
    return main, startup, logits, prob


def conv_census(main, batch):
    """{(N, C, H, W, F, k, stride, padding, relu): count} over the
    program's conv2d_bn_relu ops at batch ``batch``."""
    blk = main.global_block()
    out = {}
    for op in blk.ops:
        if op.type != "conv2d_bn_relu":
            continue
        _, c, h, w = blk.var(op.input("X")[0]).shape
        f, _, k, _ = blk.var(op.input("Filter")[0]).shape
        key = (batch, c, h, w, f, k, int(op.attr("stride")),
               int(op.attr("padding")), bool(op.attr("relu")))
        out[key] = out.get(key, 0) + 1
    return out


def _conv_work(n, c, h, w, f, k, s, p, relu):
    """(bytes, product flops, epilogue flops) of one fused conv: x, w,
    scale and shift read once and y written once; 2*M*K*F flops of the
    product and 3 a value for the affine and relu."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, c * k * k
    return (4 * (n * c * h * w + f * kk + 2 * f + n * f * oh * ow),
            2 * m * kk * f, 3 * m * f)


# what K5's operations are timed against in ``bound_ms``: the same peak
# as the flash kernels' (FLASH_PEAK)
CONV_PEAK = ("product as 3xTF32 on the tensor cores (3 x 2MKF over 495 "
             "TFLOP/s TF32 dense) + 3MF epilogue flops over 67 TFLOP/s")


def _conv_bounds(*shape):
    """Least time for one fused conv: the bytes over HBM bandwidth
    against the product as 3xTF32 on the tensor cores (three TF32
    products over the TF32 peak, the card's fastest float32-accurate
    product) plus the epilogue over the float32 peak: ``bound_ms``.
    ``bound_f32_ms`` counts every flop over the float32 peak (the
    CUDA-core floor of a scalar kernel)."""
    nbytes, prod, epi = _conv_work(*shape)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * prod / TF32_FLOP_PER_S + epi / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": _bound_of(nbytes, prod + epi)[0]}


def _conv_case(torch, rng, n, c, h, w, f, k, s, p, relu):
    """Seeded unit-scale x, w, scale, shift on the card."""
    import numpy as np

    x = _randn(torch, rng, n, c, h, w)
    wt = torch.from_numpy((rng.randn(f, c, k, k) / np.sqrt(c * k * k))
                          .astype(np.float32)).cuda()
    sc = torch.from_numpy((rng.rand(f) + 0.5).astype(np.float32)).cuda()
    sh = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32)).cuda()
    return x, wt, sc, sh, s, p, relu


def _conv_library(torch, x, w, sc, sh, s, p, relu):
    """F.conv2d (cuDNN, TF32 off) and the same affine + relu: the
    yardstick, never used by the port."""
    import torch.nn.functional as F

    sc4, sh4 = sc[None, :, None, None], sh[None, :, None, None]

    def run():
        y = F.conv2d(x, w, stride=s, padding=p) * sc4 + sh4
        return torch.relu(y) if relu else y
    return run


def _conv_vs_float64(torch, k5, rng):
    """Max abs error of K5, its plain version and F.conv2d (cuDNN, TF32
    off) + the epilogue against the same function in float64, at three
    batch-16 shapes: the stem, a res2 3x3 and a res5 1x1."""
    import torch.nn.functional as F

    out = {}
    b = INFER_BATCH
    for name, shape in (("stem 7x7/2 3->64", (b, 3, 224, 224, 64, 7, 2, 3,
                                              True)),
                        ("res2 3x3 64->64", (b, 64, 56, 56, 64, 3, 1, 1,
                                             True)),
                        ("res5 1x1 512->2048", (b, 512, 7, 7, 2048, 1, 1, 0,
                                                False))):
        args = _conv_case(torch, rng, *shape)
        x, w, sc, sh, st, pd, relu = args
        exact = F.conv2d(x.double(), w.double(), stride=st, padding=pd) \
            * sc.double()[None, :, None, None] \
            + sh.double()[None, :, None, None]
        if relu:
            exact = torch.relu(exact)
        got = {"kernel": k5._conv_cuda(*args),
               "plain": k5.fused_conv_bn_relu_reference(*args),
               "cudnn_f32": _conv_library(torch, *args)()}
        row = {"max_abs_y": exact.abs().max().item()}
        row.update({who: (y.double() - exact).abs().max().item()
                    for who, y in got.items()})
        out[name] = row
        log(f"  conv vs float64, {name} batch {b}: max abs err "
            + json.dumps(row))
        del exact, got, args
    torch.cuda.empty_cache()
    return out


def infer_kernels_phase(torch):
    """K5 against its plain version on the card (max abs error within
    TOL of the output's max at unit-scale inputs: the JAX tests' four
    shapes, the stem, a 1x1/2 projection and a res5 3x3 at batch 2),
    then timed beside its plain version and F.conv2d + epilogue at three
    batch-16 shapes and summed over every convolution of one batch-16
    ResNet-50 forward."""
    phase("infer kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    rng = np.random.RandomState(2026)
    cases = {
        "jax 3x3": (2, 8, 10, 10, 16, 3, 1, 1, True),
        "jax 3x3/2 odd": (2, 8, 9, 9, 12, 3, 2, 0, True),
        "jax 1x1 no relu": (2, 16, 7, 7, 32, 1, 1, 0, False),
        "jax 5x5/2 F=7": (1, 3, 12, 12, 7, 5, 2, 2, True),
        "stem 7x7/2": (2, 3, 224, 224, 64, 7, 2, 3, True),
        "proj 1x1/2": (2, 256, 56, 56, 512, 1, 2, 0, False),
        "res5 3x3": (2, 512, 7, 7, 512, 3, 1, 1, True),
    }
    max_err = worst_rel = 0.0
    for name, shape in cases.items():
        args = _conv_case(torch, rng, *shape)
        got = k5._conv_cuda(*args)
        want = k5.fused_conv_bn_relu_reference(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if got.shape != want.shape or not torch.isfinite(got).all() or \
                rel > TOL:
            raise RuntimeError(f"K5 case {name}: max abs err {err:.3g}, "
                               f"{rel:.3g} of the output's max > {TOL}")
        max_err, worst_rel = max(max_err, err), max(worst_rel, rel)
        log(f"  conv {name} {shape}: max abs err {err:.3g} ({rel:.3g} of "
            f"max)")

    # each output sums its K products in one order whatever the batch:
    # an image's rows are bitwise the same alone and inside a batch of
    # 16; no atomics: two launches give bitwise-equal outputs
    args = _conv_case(torch, rng, INFER_BATCH, 64, 56, 56, 64, 3, 1, 1,
                      True)
    whole = k5._conv_cuda(*args)
    alone = k5._conv_cuda(args[0][5:6].contiguous(), *args[1:])
    if not torch.equal(whole[5:6], alone):
        raise RuntimeError("K5: an image's output differs between batch "
                           "16 and batch 1")
    if not torch.equal(whole, k5._conv_cuda(*args)):
        raise RuntimeError("K5: two launches on the same inputs differ")
    log("  conv res2 3x3: image 5 bitwise equal at batch 16 and alone; "
        "two launches bitwise equal")
    vs_float64 = _conv_vs_float64(torch, k5, rng)

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")

    def timed(shape):
        """Times K5 and the library call in turns (K5, library, library,
        K5) and the plain version once on one shape, after holding K5
        against the plain version there."""
        nonlocal max_err, worst_rel
        args = _conv_case(torch, rng, *shape)
        got = k5._conv_cuda(*args)
        want = k5.fused_conv_bn_relu_reference(*args)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not torch.isfinite(got).all() or rel > TOL:
            raise RuntimeError(f"K5 at {shape}: max abs err {err:.3g}, "
                               f"{rel:.3g} of the output's max > {TOL}")
        max_err, worst_rel = max(max_err, err), max(worst_rel, rel)
        del got, want
        row = dict(zip(("ms", "library_ms"), _in_turns(
            torch, lambda: k5._conv_cuda(*args),
            _conv_library(torch, *args), flush)))
        row["plain_ms"] = _time_ms(
            torch, lambda: k5.fused_conv_bn_relu_reference(*args), flush)
        row.update(_conv_bounds(*shape))
        return row

    b = INFER_BATCH
    rows = {}
    for name, shape in (("stem 7x7/2 3->64", (b, 3, 224, 224, 64, 7, 2, 3,
                                              True)),
                        ("res2 3x3 64->64", (b, 64, 56, 56, 64, 3, 1, 1,
                                             True)),
                        ("res5 1x1 512->2048", (b, 512, 7, 7, 2048, 1, 1, 0,
                                                False))):
        rows[name] = dict(timed(shape), shape=list(shape))
        log(f"  time {name}: " + json.dumps(rows[name]))

    # every convolution of one batch-16 forward, by distinct shape
    main, _, _, _ = build_resnet50(seed=1)
    census = conv_census(main, b)
    if sum(census.values()) != CONVS_PER_FORWARD:
        raise RuntimeError(f"ResNet-50 has {sum(census.values())} fused "
                           f"convs, want {CONVS_PER_FORWARD}")
    fwd = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_f32_ms"), 0.0)
    nbytes = prod = epi = 0
    by_shape = []
    for shape, n in census.items():
        row = timed(shape)
        for key in fwd:
            fwd[key] += n * row[key]
        by_shape.append({"shape": list(shape), "count": n,
                         **{k: row[k] for k in ("ms", "library_ms",
                                                "bound_ms")}})
        work = _conv_work(*shape)
        nbytes, prod, epi = (nbytes + n * work[0], prod + n * work[1],
                             epi + n * work[2])
    t_ops = 3 * prod / TF32_FLOP_PER_S + epi / F32_FLOP_PER_S
    fwd["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S >= t_ops
                       else "operations")
    fwd["bound_peak"] = CONV_PEAK
    fwd["ratio_port_over_cudnn"] = fwd["ms"] / fwd["library_ms"]
    fwd["library"] = ("F.conv2d (cuDNN, TF32 off) + the affine and relu; "
                      "each shape timed in turns K5, library, library, K5")
    fwd["vs_float64"] = vs_float64
    fwd["by_shape"] = by_shape
    fwd["distinct_shapes"] = len(census)
    fwd["convs"] = CONVS_PER_FORWARD
    fwd["gflop"] = (prod + epi) / 1e9
    log(f"  time one batch-{b} forward, {CONVS_PER_FORWARD} convs in "
        f"{len(census)} shapes: " + json.dumps(fwd))
    del flush
    return max_err, worst_rel, rows, fwd


# --- infer: ResNet-50 fused inference served on the card ----------------

def seeded_bn_fold(torch, main, scope, seed):
    """Set every conv's Scale/Shift to fold_bn of seeded numpy
    gamma/beta/mean/var, so the epilogue does real work. The last conv
    of each residual branch (a relu=False conv fed by another conv) gets
    gamma in [0.1, 0.3], the others in [0.5, 1.5] (the small-gamma
    initialisation of a residual branch, Goyal et al. 2017): without
    trained statistics the activations then stay near unit scale over
    the 16 blocks instead of growing ~2x a block."""
    import numpy as np

    from paddle_tpu_torch.kernels.conv_bn_relu import fold_bn

    rng = np.random.RandomState(seed)
    producer = {}
    n = 0
    for op in main.global_block().ops:
        for name in op.output("Out"):
            producer[name] = op.type
        if op.type != "conv2d_bn_relu":
            continue
        sname, bname = op.input("Scale")[0], op.input("Shift")[0]
        f = scope.find_var(sname).shape[0]
        branch_end = not op.attr("relu") and \
            producer.get(op.input("X")[0]) == "conv2d_bn_relu"
        gamma = (rng.rand(f) * 0.2 + 0.1 if branch_end
                 else rng.rand(f) + 0.5).astype(np.float32)
        beta = rng.randn(f).astype(np.float32) * 0.1
        mean = rng.randn(f).astype(np.float32) * 0.1
        var = rng.rand(f).astype(np.float32) + 0.5
        sc, sh = fold_bn(gamma, beta, mean, var, 1e-5)
        dev = scope.find_var(sname).device
        scope.set_var(sname, sc.to(dev))
        scope.set_var(bname, sh.to(dev))
        n += 1
    return n


def _images(rng, n):
    import numpy as np

    return rng.randn(n, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)


def infer_phase(torch):
    """The main path: save_inference_model, ServingServer (the card),
    load_model with the [1, 2, 4, 8, 16] ladder, 24 concurrent infer
    requests of 1-4 seeded images over RPC. Counters zeroed just before
    the requests and read just after: 53 K5 launches per executed batch,
    0 plain calls. Every answer equals a direct exe.run of its images:
    probabilities within TOL of their max (K5 sums each output in one
    order whatever the batch, but the fc's cuBLAS product may pick
    another kernel for another row count), argmax equal."""
    phase("infer")
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    t0 = time.perf_counter()
    main, startup, logits, prob = build_resnet50(seed=1)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    exe.run(startup, scope=scope)
    folded = seeded_bn_fold(torch, main, scope, seed=2)
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(main.global_block().ops)} ops in {build_s:.2f} s; "
        f"{n_params} parameter values; {folded} convs' Scale/Shift set "
        f"from fold_bn")
    tmp = tempfile.mkdtemp(prefix="resnet50_")
    srv = ServingServer()
    clients = [ServingClient(srv.serve(), timeout=900.0) for _ in range(8)]
    try:
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.save_inference_model(tmp, ["img"], [prob], exe, main)
        save_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = clients[0].load_model("resnet50", tmp, buckets=INFER_BUCKETS)
        load_s = time.perf_counter() - t0
        log(f"  saved in {save_s:.2f} s; load+warm {load_s:.2f} s, "
            f"buckets {st['buckets']}")

        rng = np.random.RandomState(8)
        sizes = [int(x) for x in rng.randint(1, 5, size=24)]
        feeds = [_images(rng, n) for n in sizes]
        results, errors = [None] * 24, []

        def one(i):
            try:
                results[i] = clients[i % 8].infer("resnet50",
                                                  {"img": feeds[i]})
            except Exception as e:  # reported below, fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        # the main path's window: counters to 0, the requests, counters
        # read
        batches0 = clients[0].list_models()["resnet50"]["batches"]
        tracing.trace_reset()
        tracing.trace_enable()
        k5.counts.reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        launches = k5.counts.kernel_launches[k5.KERNEL]
        plain = k5.counts.plain_calls[k5.KERNEL]
        batches = clients[0].list_models()["resnet50"]["batches"] - batches0
        # the window ends here
        if errors or any(r is None for r in results):
            raise RuntimeError(f"concurrent infer failed: {errors}")
        if launches != CONVS_PER_FORWARD * batches or batches == 0:
            raise RuntimeError(f"K5 launches {launches} != "
                               f"{CONVS_PER_FORWARD} x {batches} batches")
        if plain != 0:
            raise RuntimeError(f"plain version ran {plain} times on the "
                               "card's main path")

        # each answer against a direct run of the same images
        worst = 0.0
        for (out, ver), x in zip(results, feeds):
            (direct,) = exe.run(main, feed={"img": x}, fetch_list=[prob],
                                scope=scope)
            got = out[0]
            if got.shape != (x.shape[0], RESNET_CLASSES) or ver != 1 or \
                    not np.isfinite(got).all():
                raise RuntimeError(f"bad answer {got.shape} v{ver}")
            rel = float(np.abs(got - direct).max() / direct.max())
            if rel > TOL or not np.array_equal(got.argmax(-1),
                                                     direct.argmax(-1)):
                raise RuntimeError(f"served vs direct probabilities: "
                                   f"{rel:.3g} of max, argmax "
                                   f"{got.argmax(-1)} vs "
                                   f"{direct.argmax(-1)}")
            worst = max(worst, rel)
        log(f"  24 requests ({sum(sizes)} images, sizes {sizes}) in "
            f"{wall:.2f} s as {batches} batches: {launches} K5 launches, "
            f"{plain} plain calls; answers vs direct run: worst "
            f"{worst:.3g} of max, argmax equal")

        # steady state at bucket 16 (10 batches), and every bucket once
        # more so each has a compute-time sample
        x16 = _images(rng, INFER_BATCH)
        t0 = time.perf_counter()
        for _ in range(10):
            clients[0].infer("resnet50", {"img": x16})
        steady = time.perf_counter() - t0
        for b in INFER_BUCKETS:
            clients[0].infer("resnet50", {"img": x16[:b]})
        tracing.trace_disable()
        per_bucket = {}
        for ev in tracing.trace_events():
            if ev.get("name") == "serving.batch":
                per_bucket.setdefault(ev["args"]["bucket"], []).append(
                    ev["dur"] / 1e3)
        infer = {
            "config": "resnet50 imagenet fused (conv2d_bn_relu) 224x224x3 "
                      "1000 classes f32, seeded weights, fold_bn "
                      "Scale/Shift",
            "parameters": n_params,
            "build_s": build_s, "save_s": save_s, "load_warm_s": load_s,
            "requests": 24, "images": sum(sizes), "request_sizes": sizes,
            "batch_wall_s": wall, "batches": batches,
            "kernel_launches": launches, "plain_calls": plain,
            "worst_rel_vs_direct": worst,
            "images_per_s_bucket16": 10 * INFER_BATCH / steady,
            "p50_compute_ms_by_bucket": {
                str(b): statistics.median(v)
                for b, v in sorted(per_bucket.items())},
            "batches_by_bucket": {str(b): len(v)
                                  for b, v in sorted(per_bucket.items())},
            "feed_h2d_ms_bucket16": feed_copy_ms(torch, x16),
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
        }
        log("  infer " + json.dumps(infer))
        infer["profile"] = profile_infer(torch, clients[1], x16)
        return launches, infer, (main, logits, scope)
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def feed_copy_ms(torch, x):
    """The executor's host->device copy of one batch's feed (pageable
    numpy -> card), median of 25."""
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(x).to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_infer(torch, client, x16, model="resnet50", part=None,
                  what="bucket-16 infer request"):
    """One more bucket-16 request under torch.profiler, after the main
    path's counts were read: device time by kernel and the device's busy
    share of the request's wall time (and the device ms of the kernels
    named by ``part``). Reporting only. A first request runs as the
    profiler's warm-up step, so the tracer is already running when the
    measured request's feed copy and first K5 launch start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        client.infer(model, {"img": x16})
        prof.step()
        t0 = time.perf_counter()
        client.infer(model, {"img": x16})
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    if not kept:
        raise RuntimeError("profiler kept no trace of the measured request")
    return _device_summary(kept[0], wall_ms, what, part)


def infer_check_phase(torch, built):
    """ResNet-50 at batch 2, 224x224, on the card (K5) and on the CPU
    (plain version) from the same parameters: logits within TOL of the
    largest |logit|."""
    phase("infer check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    main, logits, card_scope = built
    cpu_scope = fluid.Scope()
    for n in card_scope.var_names():
        cpu_scope.set_var(n, card_scope.find_var(n).cpu())
    x = _images(np.random.RandomState(9), 2)
    out, counts = {}, {}
    for dev, scope in (("cuda", card_scope), ("cpu", cpu_scope)):
        k5.counts.reset()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        (out[dev],) = exe.run(main, feed={"img": x}, fetch_list=[logits],
                              scope=scope)
        counts[dev] = (k5.counts.kernel_launches[k5.KERNEL],
                       k5.counts.plain_calls[k5.KERNEL])
    if counts != {"cuda": (CONVS_PER_FORWARD, 0),
                  "cpu": (0, CONVS_PER_FORWARD)}:
        raise RuntimeError(f"K5 kernel/plain counts (card, cpu): {counts}")
    lc, lp = out["cuda"], out["cpu"]
    scale = float(np.abs(lp).max())
    rel = float(np.abs(lc - lp).max()) / scale
    if lc.shape != (2, RESNET_CLASSES) or not np.isfinite(lc).all() or \
            rel > TOL:
        raise RuntimeError(f"card vs CPU logits: {rel:.3g} of max |logit| "
                           f"> {TOL} (or not finite)")
    log(f"  resnet50 batch 2: card vs CPU logits max diff {rel:.3g} of "
        f"max |logit| {scale:.4g}; argmax card {lc.argmax(-1)} cpu "
        f"{lp.argmax(-1)}")
    return {"rel_err": rel, "max_abs_logit": scale}


# --- amp: mixed precision (FLAGS['amp']) --------------------------------

# H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
# what conv_bn_relu_bf16's operations are timed against in ``bound_ms``
AMP_CONV_PEAK = ("product in bf16 on the tensor cores (2MKF over 989 "
                 "TFLOP/s dense) + 3MF epilogue flops over 67 TFLOP/s; bf16 "
                 "x, w, y and float32 scale, shift over 3.35 TB/s")
# conv_bn_relu_bf16 against its plain version: both round one float32
# accumulator (summed in other orders) to bfloat16, so an output may land
# one bfloat16 step apart: at most one ulp of the output's largest value
AMP_ULPS = 1
# bfloat16 resolution (relative) and the limits in its units: the card
# against the CPU under amp (ResNet-50 batch 2: loss, running statistics)
U = 2.0 ** -8
AMP_CHECK_U = 8
# amp logits against float32 ones over a whole ResNet-50 (53 layers, each
# rounding its conv to bfloat16), of the largest |logit|
AMP_LOGIT_TOL = 0.1


@contextlib.contextmanager
def amp_flag():
    """FLAGS['amp'] on for the body, off again after."""
    from paddle_tpu_torch.flags import FLAGS

    saved = FLAGS["amp"]
    FLAGS["amp"] = True
    try:
        yield
    finally:
        FLAGS["amp"] = saved


def _amp_conv_work(n, c, h, w, f, k, s, p, relu):
    """(bytes, product flops, epilogue flops) of one bfloat16 fused conv:
    bfloat16 x and w read once and y written once, float32 scale and
    shift read once."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, c * k * k
    return (2 * (n * c * h * w + f * kk + m * f) + 4 * 2 * f,
            2 * m * kk * f, 3 * m * f)


def _amp_conv_bound(nbytes, prod, epi):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = prod / BF16_FLOP_PER_S + epi / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _amp_conv_case(torch, rng, *shape):
    """_conv_case's seeded inputs with x and w in bfloat16."""
    x, w, sc, sh, s, p, relu = _conv_case(torch, rng, *shape)
    return x.bfloat16(), w.bfloat16(), sc, sh, s, p, relu


# the seed of the amp kernels phase's batch-16 census inputs
# (amp_census_cases; k5_bf16_vs_old.py replays them)
AMP_CENSUS_SEED = 2031


def amp_census_cases(torch):
    """(shape, count, _amp_conv_case args) for every distinct fused
    convolution of a batch-16 ResNet-50 forward, in census order, drawn
    from one RandomState(AMP_CENSUS_SEED)."""
    import numpy as np

    main, _, _, _ = build_resnet50(seed=1)
    census = conv_census(main, INFER_BATCH)
    if sum(census.values()) != CONVS_PER_FORWARD:
        raise RuntimeError(f"ResNet-50 has {sum(census.values())} fused "
                           f"convs, want {CONVS_PER_FORWARD}")
    rng = np.random.RandomState(AMP_CENSUS_SEED)
    for shape, n in census.items():
        yield shape, n, _amp_conv_case(torch, rng, *shape)


def _amp_conv_library(torch, x, w, sc, sh, s, p, relu):
    """F.conv2d in bfloat16 (cuDNN) and the affine and relu in bfloat16:
    the yardstick, never used by the port (it rounds the convolution to
    bfloat16 before the affine, where K5 rounds once after it)."""
    import torch.nn.functional as F

    sc4 = sc.bfloat16()[None, :, None, None]
    sh4 = sh.bfloat16()[None, :, None, None]

    def run():
        y = torch.addcmul(sh4, F.conv2d(x, w, stride=s, padding=p), sc4)
        return torch.relu(y) if relu else y
    return run


def _bf16_ulps(got, want):
    """(max abs error, in bf16 ulps of want's largest |value|, share of
    elements that differ)."""
    vmax = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(vmax)) - 7) if vmax else 2.0 ** -133
    err = (got.float() - want.float()).abs().max().item()
    return err, err / ulp, (got != want).float().mean().item()


def _hold_bf16(torch, k5, args, what):
    """conv_bn_relu_bf16 against its plain version on ``args``: a
    bfloat16 output of the plain version's shape, finite, within
    AMP_ULPS ulps of the plain output's largest |value|. Returns (max abs
    error, ulps, share of outputs that differ at all)."""
    got = k5._conv_cuda(*args)
    want = k5.fused_conv_bn_relu_reference(*args)
    torch.cuda.synchronize()
    err, ulps, share = _bf16_ulps(got, want)
    if got.dtype != torch.bfloat16 or got.shape != want.shape or \
            not torch.isfinite(got).all() or ulps > AMP_ULPS:
        raise RuntimeError(f"K5 bf16 {what}: {got.dtype} {tuple(got.shape)},"
                           f" max abs err {err:.3g} = {ulps:.3g} ulps "
                           f"of the output's max > {AMP_ULPS}")
    return err, ulps, share


# the device-side names of K5 bf16's kernels in a profile: the wgmma
# bodies, the mma.sync body, the split combine
K5_BF16_PROFILE_NAMES = ("conv_kernel<", "conv_bn_relu_bf16_kernel",
                         "split_combine_kernel")


def _bitwise_bf16(torch, k5, args, what):
    """An image's output bitwise the same at the args' batch and alone,
    and two launches on the same inputs bitwise equal."""
    whole = k5._conv_cuda(*args)
    img = min(5, args[0].shape[0] - 1)
    alone = k5._conv_cuda(args[0][img:img + 1].contiguous(), *args[1:])
    if not torch.equal(whole[img:img + 1], alone):
        raise RuntimeError(f"K5 bf16 {what}: image {img}'s output differs "
                           f"between batch {args[0].shape[0]} and alone")
    if not torch.equal(whole, k5._conv_cuda(*args)):
        raise RuntimeError(f"K5 bf16 {what}: two launches on the same "
                           f"inputs differ")


def _combine_row(torch, k5, rng, flush, shape):
    """conv_split_combine_bf16 held against its plain version on seeded
    float32 partials of the plan of ``shape`` (the same sums in the same
    order: bitwise equal), then timed beside it; its bound: the partials
    read once and y written once over HBM bandwidth."""
    import numpy as np

    n, c, h, w, f, k, s, p, relu = shape
    plan = k5._plan(c, h, w, f, k, k, s, p)
    oh, ow = k5.conv_out_hw(h, w, k, k, s, p)
    m = n * oh * ow
    mpad = -(-m // 4) * 4
    ws = torch.from_numpy(rng.randn(plan.splits, f, mpad)
                          .astype(np.float32)).cuda()
    sc = torch.from_numpy((rng.rand(f) + 0.5).astype(np.float32)).cuda()
    sh = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32)).cuda()
    got = k5._combine_cuda(ws, sc, sh, n, oh, ow, relu)
    want = k5.split_combine_reference(ws, sc, sh, n, oh, ow, relu)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"split combine at {shape}: max abs err {err:.3g}"
                           f" against its plain version (want bitwise)")
    nbytes = 4 * plan.splits * f * mpad + 2 * m * f + 8 * f
    row = {"shape": list(shape), "splits": plan.splits,
           "partials": [plan.splits, f, mpad], "max_abs_err": err,
           "ms": _time_ms(torch, lambda: k5._combine_cuda(ws, sc, sh, n, oh,
                                                          ow, relu), flush),
           "plain_ms": _time_ms(torch, lambda: k5.split_combine_reference(
               ws, sc, sh, n, oh, ow, relu), flush),
           "library_ms": None,
           "library_note": "no one PyTorch call sums the partials in order "
                           "and applies the epilogue"}
    row["bound_ms"], row["bound_by"] = _bound_of(nbytes,
                                                 (plan.splits + 2) * m * f)
    row["host_us"] = _host_us(torch, lambda: k5._combine_cuda(
        ws, sc, sh, n, oh, ow, relu))
    log("  split combine " + json.dumps(row))
    return row


def amp_kernels_phase(torch):
    """conv_bn_relu_bf16 (K5's bfloat16 form) against its plain version
    on the card (within AMP_ULPS bfloat16 ulps of the output's largest
    |value|): the JAX tests' four shapes, the stem (2-byte weight loads:
    K = 147), a 1x1/2 projection and a res5 3x3 at batch 2, then every
    distinct convolution of a batch-16 ResNet-50 forward (20 shapes, each
    with its plan's body and split); an image's output bitwise the same
    alone and at batch 16, and two launches bitwise equal, at res2 3x3
    and at every shape whose plan takes a wgmma body or splits K; timed
    at the 20 shapes in turns with F.conv2d in bfloat16 (cuDNN) + the
    affine and relu, the plain version once, and summed over the 53
    convolutions of the forward. The split combine
    (conv_split_combine_bf16) held bitwise against its plain version and
    timed at res5 3x3."""
    phase("amp kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    rng = np.random.RandomState(2027)
    worst = {"max_abs_err": 0.0, "ulps": 0.0, "differing": 0.0}

    def hold(args, what):
        err, ulps, share = _hold_bf16(torch, k5, args, what)
        for key, v in (("max_abs_err", err), ("ulps", ulps),
                       ("differing", share)):
            worst[key] = max(worst[key], v)
        log(f"  conv bf16 {what}: max abs err {err:.3g} ({ulps:.3g} ulps "
            f"of max), {share:.3g} of outputs differ")

    for name, shape in (("jax 3x3", (2, 8, 10, 10, 16, 3, 1, 1, True)),
                        ("jax 3x3/2 odd", (2, 8, 9, 9, 12, 3, 2, 0, True)),
                        ("jax 1x1 no relu", (2, 16, 7, 7, 32, 1, 1, 0,
                                             False)),
                        ("jax 5x5/2 F=7", (1, 3, 12, 12, 7, 5, 2, 2, True)),
                        ("stem 7x7/2", (2, 3, 224, 224, 64, 7, 2, 3, True)),
                        ("proj 1x1/2", (2, 256, 56, 56, 512, 1, 2, 0,
                                        False)),
                        ("res5 3x3", (2, 512, 7, 7, 512, 3, 1, 1, True))):
        hold(_amp_conv_case(torch, rng, *shape), f"{name} {shape}")

    args = _amp_conv_case(torch, rng, INFER_BATCH, 64, 56, 56, 64, 3, 1, 1,
                          True)
    _bitwise_bf16(torch, k5, args, "res2 3x3")
    log("  conv bf16 res2 3x3: image 5 bitwise equal at batch 16 and alone; "
        "two launches bitwise equal")
    del args

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    fwd = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    work = [0, 0, 0]
    by_shape, bitwise = [], []
    census = {}
    for shape, n, args in amp_census_cases(torch):
        census[shape] = n
        plan = k5.plan_for(args[0].shape, args[1].shape, args[4], args[5])
        hold(args, f"{shape} {tuple(plan)}")
        if plan.body != "mma" or plan.splits > 1:
            _bitwise_bf16(torch, k5, args, f"{shape}")
            bitwise.append(list(shape))
        row = dict(zip(("ms", "library_ms"), _in_turns(
            torch, lambda: k5._conv_cuda(*args),
            _amp_conv_library(torch, *args), flush)))
        row["plain_ms"] = _time_ms(
            torch, lambda: k5.fused_conv_bn_relu_reference(*args), flush)
        w1 = _amp_conv_work(*shape)
        row.update(_amp_conv_bound(*w1))
        for key in fwd:
            fwd[key] += n * row[key]
        work = [a + n * b for a, b in zip(work, w1)]
        by_shape.append({"shape": list(shape), "count": n,
                         "body": plan.body, "splits": plan.splits,
                         "tile": [64, plan.bn],
                         **{k: row[k] for k in ("ms", "library_ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")}})
        del args
    log(f"  conv bf16: an image bitwise equal at batch {INFER_BATCH} and "
        f"alone, two launches bitwise equal, at the {len(bitwise)} shapes "
        f"on a wgmma body or split: {json.dumps(bitwise)}")
    fwd["bound_by"] = _amp_conv_bound(*work)["bound_by"]
    fwd.update({
        "bound_peak": AMP_CONV_PEAK,
        "ratio_port_over_cudnn": fwd["ms"] / fwd["library_ms"],
        "library": ("F.conv2d in bf16 (cuDNN) + the affine and relu in "
                    "bf16; each shape timed in turns K5, library, library, "
                    "K5"),
        "by_shape": by_shape, "distinct_shapes": len(census),
        "convs": CONVS_PER_FORWARD, "gflop": (work[1] + work[2]) / 1e9,
        "max_err_bf16_ulps": worst["ulps"],
        "max_share_differing": worst["differing"],
        "bitwise_shapes": bitwise,
        "split_convs_per_forward": sum(
            n for shape, n in census.items()
            if k5._plan(*shape[1:6], shape[5], *shape[6:8]).splits > 1),
    })
    log(f"  time one batch-{INFER_BATCH} forward in bf16, "
        f"{CONVS_PER_FORWARD} convs in {len(census)} shapes: "
        + json.dumps(fwd))
    combine = _combine_row(torch, k5, rng, flush,
                           (INFER_BATCH, 512, 7, 7, 512, 3, 1, 1, True))
    del flush
    return worst["max_abs_err"], fwd, combine


def infer_amp_phase(torch, split_convs):
    """The fused ResNet-50 artifact (as in infer, its logits the fetch
    target) served over RPC under FLAGS['amp'] at bucket 16: the model
    loaded and warmed under the flag, 10 requests of 16 seeded images.
    Counters zeroed just before the requests and read just after: 53
    conv_bn_relu_bf16 launches per executed batch and ``split_convs``
    conv_split_combine_bf16 launches (the convolutions whose plan splits
    K), no float32 K5 launch, no plain call. Then one more request
    profiled (reporting only: the device's busy share and K5 bf16's
    device ms). The amp logits against the float32 fused forward of the
    same artifact on the same images: finite, within AMP_LOGIT_TOL of the
    largest |logit|; argmax agreement recorded."""
    phase("infer amp")
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    main, startup, logits, _ = build_resnet50(seed=1)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    seeded_bn_fold(torch, main, scope, seed=2)
    tmp = tempfile.mkdtemp(prefix="resnet50_amp_")
    srv = ServingServer()
    cli = ServingClient(srv.serve(), timeout=900.0)
    try:
        with fluid.scope_guard(scope):
            fluid.save_inference_model(tmp, ["img"], [logits], exe, main)
        x16 = _images(np.random.RandomState(11), INFER_BATCH)
        with amp_flag():
            t0 = time.perf_counter()
            cli.load_model("resnet50_amp", tmp, buckets=[INFER_BATCH])
            load_s = time.perf_counter() - t0
            batches0 = cli.list_models()["resnet50_amp"]["batches"]
            # the main path's window: counters to 0, the requests,
            # counters read
            _reset_kernel_counts()
            t0 = time.perf_counter()
            for _ in range(10):
                out, ver = cli.infer("resnet50_amp", {"img": x16})
            steady = time.perf_counter() - t0
            launches, plain = _kernel_counts()
            batches = cli.list_models()["resnet50_amp"]["batches"] - batches0
            # the window ends here
            profile = profile_infer(torch, cli, x16, model="resnet50_amp",
                                    part=K5_BF16_PROFILE_NAMES,
                                    what="bucket-16 amp infer request")
    finally:
        cli.close()
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if batches == 0 or launches["conv_bn_relu_bf16"] != \
            CONVS_PER_FORWARD * batches or \
            launches["conv_split_combine_bf16"] != split_convs * batches or \
            launches["conv_bn_relu_f32"] or any(plain.values()):
        raise RuntimeError(f"amp serving: {batches} batches, launches "
                           f"{launches}, plain {plain}")
    (want,) = exe.run(main, feed={"img": x16}, fetch_list=[logits],
                      scope=scope)
    got = out[0]
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if got.shape != (INFER_BATCH, RESNET_CLASSES) or ver != 1 or \
            not np.isfinite(got).all() or rel > AMP_LOGIT_TOL:
        raise RuntimeError(f"amp logits vs float32: {rel:.3g} of max "
                           f"|logit| > {AMP_LOGIT_TOL} (or not finite)")
    infer = {
        "config": "resnet50 imagenet fused 224x224x3 1000 classes, "
                  "FLAGS['amp'] (K5 bf16), seeded weights, fold_bn "
                  "Scale/Shift",
        "load_warm_s": load_s, "batches": batches,
        "kernel_launches": launches, "plain_calls": plain,
        "images_per_s_bucket16": 10 * INFER_BATCH / steady,
        "logits_rel_err_vs_f32": rel, "max_abs_logit": scale,
        "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                  .mean()),
        "profile": profile,
    }
    log("  infer amp " + json.dumps(infer))
    return infer


def resnet_train_amp_phase(torch):
    """The resnet train main path under FLAGS['amp']: ResNet-50 ImageNet,
    Momentum(0.01, 0.9), batch 32, 5 steps (conv2d and the fc in bf16,
    float32 master weights). Counters zeroed just before the steps and
    read just after: no plain version ran. The losses finite, every
    running statistic moved, every parameter float32; the same step twice
    from the same state bitwise equal in loss and scope; one profiled
    step. Then the trained network's statistics folded into the fused
    form and a seeded batch of 16 through it under amp: 53
    conv_bn_relu_bf16 launches, no float32 K5 launch, no plain call; its
    logits against the unfused test-mode network's under amp within
    AMP_LOGIT_TOL of the largest |logit| (the two round to bfloat16 at
    other places: the fused form after the folded affine, the unfused one
    before its batch norm)."""
    phase("resnet train amp")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, startup, test, cost, acc, pg = build_resnet50_train(seed=3)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    stats = _bn_stats(main)
    initial = {n: scope.find_var(n).clone() for pair in stats for n in pair}
    rng = np.random.RandomState(0)
    feed = {"img": torch.from_numpy(rng.randn(
                RESNET_TRAIN_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE)
                .astype(np.float32)).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, RESNET_CLASSES, (RESNET_TRAIN_BATCH, 1))
                .astype(np.int64)).cuda()}
    with amp_flag():
        # the main path's window: counters to 0, the steps, counters read
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        losses, step_ms = [], []
        for _ in range(RESNET_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(_one_step(exe, main, feed, cost, scope))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, plain = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the window ends here
        after = _scope_copy(fluid, scope)
        runs = []
        for _ in range(2):
            s = _scope_copy(fluid, after)
            runs.append((_one_step(exe, main, feed, cost, s), s))
        differ = _same_state(torch, runs[0][1], runs[1][1])
        profile = profile_step(torch, exe, main, feed, cost,
                               _scope_copy(fluid, after))
    if any(plain.values()) or not all(np.isfinite(losses)):
        raise RuntimeError(f"amp steps: plain {plain}, losses {losses}")
    still = [n for n, t in initial.items()
             if torch.equal(scope.find_var(n), t)]
    dtypes = {str(scope.find_var(p.name).dtype) for p, _ in pg}
    if still or dtypes != {"torch.float32"}:
        raise RuntimeError(f"amp steps: {len(still)} running statistics "
                           f"never moved; parameter dtypes {dtypes}")
    if runs[0][0] != runs[1][0] or differ:
        raise RuntimeError(f"amp: the same step twice: losses {runs[0][0]!r}"
                           f" {runs[1][0]!r}; {len(differ)} scope tensors "
                           f"differ, e.g. {differ[:3]}")
    del runs, after
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "resnet-50 imagenet 224x224x3 1000 classes, FLAGS['amp'] "
                  "(bf16 conv2d and fc, float32 master weights), momentum "
                  "0.01/0.9, fake data (one seeded batch)",
        "batch": RESNET_TRAIN_BATCH, "steps": RESNET_TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "images_per_s": RESNET_TRAIN_BATCH / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "same_step_twice_bitwise": True, "profile": profile,
    }
    log("  resnet train amp " + json.dumps(train))

    fused, fstartup, flogits, _ = build_resnet50(seed=1)
    fscope = fluid.Scope()
    exe.run(fstartup, scope=fscope)
    if fold_trained_network(test, scope, fused, fscope) != CONVS_PER_FORWARD:
        raise RuntimeError("amp fold: pairs != 53")
    x = _images(np.random.RandomState(10), INFER_BATCH)
    with amp_flag():
        _reset_kernel_counts()
        (got,) = exe.run(fused, feed={"img": x}, fetch_list=[flogits],
                         scope=fscope)
        launches, plain = _kernel_counts()
        (want,) = exe.run(test, feed={"img": x, "label": np.zeros(
            (INFER_BATCH, 1), np.int64)}, fetch_list=[logits_var(test)],
            scope=scope)
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if launches["conv_bn_relu_bf16"] != CONVS_PER_FORWARD or \
            launches["conv_bn_relu_f32"] or any(plain.values()) or \
            not np.isfinite(got).all() or rel > AMP_LOGIT_TOL:
        raise RuntimeError(f"amp fold: launches {launches}, plain {plain}, "
                           f"fused vs unfused {rel:.3g} of max |logit|")
    train["fold"] = {
        "launches": launches["conv_bn_relu_bf16"], "rel_err": rel,
        "max_abs_logit": scale,
        "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                  .mean())}
    log("  resnet fold amp " + json.dumps(train["fold"]))
    return train, (main, test, cost, pg, scope)


def resnet_amp_check_phase(torch, trained):
    """One ResNet-50 training step under FLAGS['amp'] at batch 2, 224x224,
    on the card and on the CPU from the same state and feed: the loss
    within AMP_CHECK_U bfloat16 steps (relative), every updated running
    mean and variance within AMP_CHECK_U steps of its tensor's largest
    |value| (cuDNN and the CPU sum the bfloat16 products in other
    orders, and a rounding that lands one step apart spreads through
    each batch norm)."""
    phase("resnet amp check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, _, cost, _, card_trained = trained
    arrays = {n: card_trained.find_var(n).cpu().numpy()
              for n in card_trained.var_names()}
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 3, RESNET_IMAGE,
                             RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (2, 1)).astype(np.int64)}
    stats = [n for pair in _bn_stats(main) for n in pair]
    loss, scopes, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        scopes[dev] = fluid.Scope()
        fluid.params_from_jax(arrays, scopes[dev], device=dev)
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        t0 = time.perf_counter()
        with amp_flag():
            loss[dev] = _one_step(exe, main, feed, cost, scopes[dev])
        secs[dev] = time.perf_counter() - t0
    lc, lp = loss["cuda"], loss["cpu"]
    loss_u = abs(lc - lp) / abs(lp) / U
    stat_u = max((float(np.abs(scopes["cuda"].find_var(n).cpu().numpy()
                              - scopes["cpu"].find_var(n).numpy()).max())
                  / float(np.abs(scopes["cpu"].find_var(n).numpy()).max())
                  / U, n) for n in stats)
    check = {"loss_card": lc, "loss_cpu": lp, "loss_units": loss_u,
             "worst_stat_units": stat_u, "stats": len(stats),
             "cpu_step_s": secs["cpu"]}
    log("  resnet50 amp batch 2 card vs cpu " + json.dumps(check))
    if not np.isfinite(lc) or loss_u > AMP_CHECK_U or \
            stat_u[0] > AMP_CHECK_U:
        raise RuntimeError(f"amp card vs cpu: loss {loss_u:.3g} U, worst "
                           f"statistic {stat_u[0]:.3g} U > {AMP_CHECK_U}")
    return check


def train_amp_phase(torch):
    """The train main path under FLAGS['amp']: Transformer-base, Adam(1e-4),
    batch 16, 5 steps on the card; the fc and attention projections in
    bf16, K1, K2, K3a and K3b float32, as in the JAX package. Counters
    zeroed just before the steps and read just after: 30 layer-norm and
    18 each flash launches (the delta's too) a step, no plain call; the loss finite and
    falling; every parameter float32."""
    phase("train amp")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, startup, cost, pg = build_transformer(TRANSFORMER_BASE, 1e-4)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)
    with amp_flag():
        # the main path's window: counters to 0, the steps, counters read
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(_one_step(exe, main, feed, cost, scope))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, plain = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the window ends here
        profile = profile_step(torch, exe, main, feed, cost, scope)
    want = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
            "flash_delta": 18}
    bad = {k: launches[k] for k, n in want.items()
           if launches[k] != n * TRAIN_STEPS}
    dtypes = {str(scope.find_var(p.name).dtype) for p, _ in pg}
    if bad or any(plain.values()) or dtypes != {"torch.float32"}:
        raise RuntimeError(f"train amp: launches {bad}, plain {plain}, "
                           f"parameter dtypes {dtypes}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train amp: losses not finite or not falling: "
                           f"{losses}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 len512 "
                  "dropout0.1 adam1e-4, FLAGS['amp']",
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
        "step_ms": step_ms, "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "profile": profile,
    }
    log("  train amp " + json.dumps(train))
    return train


# --- bf16 attention: the bfloat16 forms of K2, K3a, K3b ----------------

# bfloat16 kernels against their plain versions on the card: both round
# the same float32 values to bfloat16 and their float32 sums run in other
# orders, so an element may land one bfloat16 step apart near a rounding
# boundary: at most BF16_FLASH_ULPS ulps of the tensor's largest |value|,
# and at most BF16_FLASH_SHARE of the elements differing at all
BF16_FLASH_ULPS = 1
BF16_FLASH_SHARE = 0.01
FLASH_BF16_PEAK = ("products in bf16 on the tensor cores (flops over 989 "
                   "TFLOP/s dense) + ~5 float32 flops a pair over 67 "
                   "TFLOP/s; bf16 q/k/v/dO/outputs and float32 lse/delta "
                   "over 3.35 TB/s")
SDPA_FLASH_LIBRARY = "sdpa flash backend, bf16"
# the ptxas name of K2 bf16's wgmma body (csrc/flash_fwd_wgmma.cuh)
WGMMA_FWD_KERNEL = "fwd_kernel<2>"
# ... and the ptxas names of K2's, K3a's and K3b's bodies at head_dim
# 129-512 (csrc/flash_wide_wgmma.cuh)
WGMMA_WIDE_KERNELS = {"flash_fwd_bf16": "wgmma_wide_fwd_kernel",
                      "flash_bwd_dkdv_bf16": "wgmma_wide_dkdv_kernel",
                      "flash_bwd_dq_bf16": "wgmma_wide_dq_kernel"}
# what the earlier mma.sync forms of K3a/K3b bf16 reached against the
# plain versions at the first 13 cases: recorded beside each backward
# kernel's worst case (not a gate)
MMA_SYNC_BF16_ULPS, MMA_SYNC_BF16_SHARE = 0.5, 0.0036
# benchmarks/flash_attention_bench.py: B=1, H=8, D=64, causal, bf16
FLASH_BENCH_HEADS, FLASH_BENCH_D, FLASH_BENCH_SEQS = 8, 64, (2048, 4096)
# train bf16 attn: bf16 against the same program in float32, of the f32
# loss (q, k, v and the attention output rounded to bfloat16)
BF16_ATTN_LOSS_U = 8
# ... and the card against the port's CPU route (the same function;
# float32 sums in other orders, a bfloat16 element may round the other way)
BF16_ATTN_CPU_RTOL = 1e-4


# the bf16 kernels phase's cases (BH, Sq, Sk, head_dim, causal), drawn in
# this order from one RandomState(BF16_FLASH_SEED) by _flash_bf16_case
# (flash_bf16_bwd_vs_old.py replays them)
BF16_FLASH_SEED = 2029
BF16_FLASH_CASES = [
    (4, 256, 256, 64, False), (4, 256, 256, 64, True),
    (4, 200, 136, 8, True), (4, 136, 200, 72, False),
    (4, 256, 200, 72, True), (2, 300, 200, 128, True),
    (2, 200, 300, 128, False), (2, 200, 300, 136, False),
    (2, 150, 200, 256, True), (2, 200, 150, 264, False),
    (2, 256, 200, 264, True), (128, SEQ, SEQ, 64, False),
    (128, SEQ, SEQ, 64, True),
    # a key length that fits no tile; heads of 150 rows, the last ending
    # inside a 64-row tile (the TMA maps' edges)
    (3, 256, 77, 64, False), (5, 150, 150, 64, True)]
# the timed shapes (BH, S, causal) at head_dim 64: Transformer-base's
# attention and the flash benchmark's
BF16_FLASH_TIMED = ((128, SEQ, False), (128, SEQ, True), (8, 2048, True),
                    (8, 4096, True))


def _flash_bf16_bounds(bh, sq, sk, d, causal):
    """``_flash_bounds``' count with bf16 q, k, v, dO and outputs (2 bytes)
    and float32 lse and delta, the products over the bf16 tensor-core
    peak and ~5 float32 flops a pair over the float32 peak."""
    pairs = bh * _flash_pairs(sq, sk, causal)
    qo, kv, rows = bh * sq * d * 2, bh * sk * d * 2, bh * sq * 4
    out = {}
    for name, nbytes, products in (
            ("flash_fwd_bf16", 2 * qo + 2 * kv + rows, 4 * d),
            ("flash_bwd_dkdv_bf16", 2 * qo + 4 * kv + 2 * rows, 8 * d),
            ("flash_bwd_dq_bf16", 3 * qo + 2 * kv + 2 * rows, 6 * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (pairs * products / BF16_FLOP_PER_S
                 + pairs * 5 / F32_FLOP_PER_S)
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bound_peak": FLASH_BF16_PEAK}
    return out


def _flash_bf16_case(torch, rng, bh, sq, sk, d, causal):
    """_flash_case in bfloat16: seeded q/k/v/dO, the plain bf16 forward's
    O and LSE, delta from the bf16 O as _Flash.backward computes it."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v = (_randn(torch, rng, bh, s, d).bfloat16() for s in (sq, sk, sk))
    do = _randn(torch, rng, bh, sq, d).bfloat16()
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                causal=causal, scale=scale)


def bf16_kernels_phase(torch):
    """flash_fwd_bf16 (K2), flash_bwd_dkdv_bf16 (K3a) and flash_bwd_dq_bf16
    (K3b) against their plain bf16 versions on the card: O, dQ, dK, dV
    bfloat16 within BF16_FLASH_ULPS ulps of the tensor's max with at most
    BF16_FLASH_SHARE of the elements differing, LSE float32 within TOL;
    full and causal, Sq != Sk both ways, Sk = 200 (a partial 128-key
    softmax block), head_dim 8, 64, 72, 128 (tensor cores), 136, 256, 264
    (CUDA cores; 264 in 256-column slices); two launches bitwise equal.
    Timed at Transformer-base's attention ([BH=128, S=512, D=64], full and
    causal) and the flash benchmark's ([BH=8, S=2048, 4096, D=64],
    causal): each kernel and the plain versions, K2 and SDPA's flash
    forward in turns, the whole backward (delta + K3a + K3b) and SDPA's
    flash backward in turns, beside the bounds."""
    phase("bf16 kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    rng = np.random.RandomState(BF16_FLASH_SEED)
    names = (fa.FWD_BF16, fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16)
    worst = {n: {"max_abs_err": 0.0, "ulps": 0.0, "differing": 0.0}
             for n in names}
    delta_errs = {}

    def hold(kernel, what, got, want):
        err, ulps, share = _bf16_ulps(got, want)
        if got.dtype != torch.bfloat16 or got.shape != want.shape or \
                not torch.isfinite(got.float()).all() or \
                ulps > BF16_FLASH_ULPS or share > BF16_FLASH_SHARE:
            raise RuntimeError(
                f"{kernel} {what}: {got.dtype} {tuple(got.shape)}, max abs "
                f"err {err:.3g} = {ulps:.3g} ulps of the max (> "
                f"{BF16_FLASH_ULPS}?), {share:.3g} of elements differ (> "
                f"{BF16_FLASH_SHARE}?)")
        w = worst[kernel]
        for key, x in (("max_abs_err", err), ("ulps", ulps),
                       ("differing", share)):
            w[key] = max(w[key], x)
        return ulps, share

    for bh, sq, sk, d, causal in BF16_FLASH_CASES:
        c = _flash_bf16_case(torch, rng, bh, sq, sk, d, causal)
        _hold_delta(torch, c, delta_errs)
        o, lse = fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        dk, dv = fa._bwd_dkdv_cuda(*bargs)
        dq = fa._bwd_dq_cuda(*bargs)
        rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
        torch.cuda.synchronize()
        lse_err = (lse - c["lse"]).abs().max().item()
        if lse.dtype != torch.float32 or lse_err > TOL:
            raise RuntimeError(f"{fa.FWD_BF16} LSE: max abs err "
                               f"{lse_err:.3g} > {TOL}")
        got = [hold(fa.FWD_BF16, "O", o, c["o"]),
               hold(fa.BWD_DQ_BF16, "dQ", dq, rq),
               hold(fa.BWD_DKDV_BF16, "dK", dk, rk),
               hold(fa.BWD_DKDV_BF16, "dV", dv, rv)]
        log(f"  flash bf16 bh={bh} sq={sq} sk={sk} d={d} causal={causal}: "
            f"LSE max abs err {lse_err:.3g}; O/dQ/dK/dV ulps of max, share "
            f"differing " + " / ".join(f"{u:.3g} {s:.3g}" for u, s in got))

    for causal in (False, True):
        c = _flash_bf16_case(torch, rng, 128, SEQ, SEQ, 64, causal)
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        first, second = (
            fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
            + fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
            for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise RuntimeError(f"bf16 K2/K3a/K3b causal={causal}: two "
                               f"launches on the same inputs differ")
    log("  flash bf16 forward and backward: two launches bitwise equal "
        "(full and causal)")

    # K2, K3a and K3b above head_dim 128 (flash_wide_wgmma.cuh up to 512,
    # flash_wide.cuh above): full and causal, Sq != Sk both ways, S not a
    # multiple of the tiles; each launched twice for bitwise-equal outputs
    for d in WIDE_BWD_DIMS:
        for bh, sq, sk, causal in WIDE_BWD_SHAPES:
            c = _flash_bf16_case(torch, rng, bh, sq, sk, d, causal)
            bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                     causal, c["scale"])
            first, second = (
                fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
                + fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
                for _ in range(2))
            rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise RuntimeError(f"bf16 K2/K3a/K3b bh={bh} sq={sq} sk={sk} "
                                   f"d={d} causal={causal}: two launches "
                                   f"differ")
            o, lse, dk, dv, dq = first
            lse_err = (lse - c["lse"]).abs().max().item()
            if lse_err > TOL:
                raise RuntimeError(f"{fa.FWD_BF16} d={d} LSE: max abs err "
                                   f"{lse_err:.3g} > {TOL}")
            got = [hold(fa.FWD_BF16, "O", o, c["o"]),
                   hold(fa.BWD_DKDV_BF16, "dK", dk, rk),
                   hold(fa.BWD_DKDV_BF16, "dV", dv, rv),
                   hold(fa.BWD_DQ_BF16, "dQ", dq, rq)]
            log(f"  wide bf16 bh={bh} sq={sq} sk={sk} d={d} causal={causal}"
                f": LSE max abs err {lse_err:.3g}; O/dK/dV/dQ ulps of max, "
                f"share differing " + " / ".join(f"{u:.3g} {s:.3g}"
                                                  for u, s in got)
                + "; two launches bitwise equal")
    for n in (fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16):
        w = worst[n]
        w["within_mma_sync_marks"] = (w["ulps"] <= MMA_SYNC_BF16_ULPS and
                                      w["differing"] <= MMA_SYNC_BF16_SHARE)
        log(f"  {n}: worst {w['ulps']:.3g} ulps of the max, "
            f"{w['differing']:.3g} of elements differing (the mma.sync "
            f"kernels': {MMA_SYNC_BF16_ULPS}, {MMA_SYNC_BF16_SHARE}); "
            f"within: {w['within_mma_sync_marks']}")

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rows = {n: {} for n in names + (fa.DELTA,)}
    # the wrappers' host time a call (encoding the TMA maps included), at
    # a shape whose kernels take less
    c = _flash_bf16_case(torch, rng, 1, 64, 64, 64, False)
    bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], False,
             c["scale"])
    host_us = {fa.FWD_BF16: _host_us(
        torch, lambda: fa._fwd_cuda(c["q"], c["k"], c["v"], False,
                                    c["scale"])),
               fa.BWD_DKDV_BF16: _host_us(
        torch, lambda: fa._bwd_dkdv_cuda(*bargs)), fa.BWD_DQ_BF16: _host_us(
        torch, lambda: fa._bwd_dq_cuda(*bargs))}
    for bh, s, causal in BF16_FLASH_TIMED:
        d = 64
        c = _flash_bf16_case(torch, rng, bh, s, s, d, causal)
        args = (c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        bounds = _flash_bf16_bounds(bh, s, s, d, causal)
        sdpa, sdpa_bwd = _sdpa(torch, c, causal, backend="FLASH_ATTENTION")

        def port_bwd():  # as _Flash.backward runs it
            delta = fa.flash_delta(c["do"], c["o"])
            return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                          c["lse"], delta, causal,
                                          c["scale"])
        key = f"bh{bh}_s{s}_{'causal' if causal else 'full'}"
        shape = f"[BH={bh}, S={s}, D={d}] bf16 causal={causal}"
        fwd_ms, sdpa_ms, fwd_turns = _in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush)
        bwd_ms, sdpa_bwd_ms, bwd_turns = _in_turns(torch, port_bwd,
                                                   sdpa_bwd, flush)
        plain_bwd = _time_ms(
            torch, lambda: fa.flash_attention_bwd_reference(*bargs), flush)
        timed = {
            fa.FWD_BF16: (fwd_ms, _time_ms(
                torch, lambda: fa.flash_attention_fwd_reference(*args),
                flush), sdpa_ms),
            fa.BWD_DKDV_BF16: (_time_ms(
                torch, lambda: fa._bwd_dkdv_cuda(*bargs), flush),
                plain_bwd, sdpa_bwd_ms),
            fa.BWD_DQ_BF16: (_time_ms(
                torch, lambda: fa._bwd_dq_cuda(*bargs), flush), plain_bwd,
                sdpa_bwd_ms),
        }
        for name, (ms, plain_ms, lib_ms) in timed.items():
            rows[name][key] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library": SDPA_FLASH_LIBRARY, **bounds[name],
                "shape": shape}
        rows[fa.FWD_BF16][key]["in_turns"] = {
            "port_ms": fwd_ms, "sdpa_ms": sdpa_ms,
            "ratio_port_over_sdpa": fwd_ms / sdpa_ms, "turns_ms": fwd_turns}
        rows[fa.FWD_BF16][key]["host_us"] = host_us[fa.FWD_BF16]
        rows[fa.BWD_DKDV_BF16][key]["whole_backward"] = {
            "port_ms": bwd_ms, "sdpa_ms": sdpa_bwd_ms,
            "ratio_port_over_sdpa": bwd_ms / sdpa_bwd_ms,
            "turns_ms": bwd_turns,
            "note": "delta + K3a + K3b against SDPA's flash backward "
                    "(dQ, dK, dV), in turns"}
        rows[fa.BWD_DKDV_BF16][key]["library_note"] = \
            "SDPA backward: computes dQ, dK and dV (K3a + K3b together)"
        rows[fa.BWD_DQ_BF16][key]["library_note"] = \
            "counted with flash_bwd_dkdv_bf16"
        for name in (fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16):
            rows[name][key]["plain_note"] = ("the plain backward computes "
                                             "dQ, dK and dV together")
            rows[name][key]["host_us"] = host_us[name]
        rows[fa.DELTA][key] = _delta_row(torch, c, flush, "bf16")
        log(f"  time {shape}: K2 {fwd_ms:.4f} ms vs SDPA flash "
            f"{sdpa_ms:.4f} (ratio {fwd_ms / sdpa_ms:.3f}); whole backward "
            f"{bwd_ms:.4f} vs {sdpa_bwd_ms:.4f} (ratio "
            f"{bwd_ms / sdpa_bwd_ms:.3f}); K3a "
            f"{timed[fa.BWD_DKDV_BF16][0]:.4f}, K3b "
            f"{timed[fa.BWD_DQ_BF16][0]:.4f}, delta "
            f"{rows[fa.DELTA][key]['ms']:.4f}; bounds "
            + " / ".join(f"{bounds[n]['bound_ms']:.4f}" for n in names)
            + f" / {rows[fa.DELTA][key]['bound_ms']:.4f}")
        del sdpa, sdpa_bwd, c
    # above head_dim 128: K2, K3a, K3b and the whole backward at [BH=32,
    # S=SEQ, D] full, in turns with SDPA: its flash backend takes head_dim
    # up to 256, its memory-efficient backend above
    for d in WIDE_TIMED_DIMS:
        c = _flash_bf16_case(torch, rng, 32, SEQ, SEQ, d, False)
        args = (c["q"], c["k"], c["v"], False, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 False, c["scale"])
        bounds = _flash_bf16_bounds(32, SEQ, SEQ, d, False)
        backend = "FLASH_ATTENTION" if d <= 256 else "EFFICIENT_ATTENTION"
        library = (SDPA_FLASH_LIBRARY if d <= 256 else
                   "sdpa efficient backend, bf16 (flash stops at 256)")
        sdpa, sdpa_bwd = _sdpa(torch, c, False, heads=2, backend=backend)

        def wide_bwd(c=c):  # as _Flash.backward runs it
            delta = fa.flash_delta(c["do"], c["o"])
            return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                          c["lse"], delta, False,
                                          c["scale"])
        key = f"bh32_s{SEQ}_d{d}_full"
        fwd_ms, sdpa_ms, fwd_turns = _in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush)
        bwd_ms, sdpa_bwd_ms, bwd_turns = _in_turns(torch, wide_bwd,
                                                   sdpa_bwd, flush)
        plain_bwd = _time_ms(
            torch, lambda: fa.flash_attention_bwd_reference(*bargs), flush)
        for name, ms, plain_ms, lib_ms in (
                (fa.FWD_BF16, fwd_ms, _time_ms(
                    torch, lambda: fa.flash_attention_fwd_reference(*args),
                    flush), sdpa_ms),
                (fa.BWD_DKDV_BF16, _time_ms(
                    torch, lambda: fa._bwd_dkdv_cuda(*bargs), flush),
                 plain_bwd, sdpa_bwd_ms),
                (fa.BWD_DQ_BF16, _time_ms(
                    torch, lambda: fa._bwd_dq_cuda(*bargs), flush),
                 plain_bwd, sdpa_bwd_ms)):
            rows[name][key] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library": library, **bounds[name],
                "share_of_bound": bounds[name]["bound_ms"] / ms,
                "shape": f"[BH=32, S={SEQ}, D={d}] bf16 causal=False",
                "source": "paddle_tpu_torch/csrc/flash_wide_wgmma.cuh "
                          f"({WGMMA_WIDE_KERNELS[name]}: wgmma + TMA)"}
        rows[fa.FWD_BF16][key]["in_turns"] = {
            "port_ms": fwd_ms, "sdpa_ms": sdpa_ms, "sdpa_backend": backend,
            "ratio_port_over_sdpa": fwd_ms / sdpa_ms, "turns_ms": fwd_turns}
        rows[fa.BWD_DKDV_BF16][key]["whole_backward"] = {
            "port_ms": bwd_ms, "sdpa_ms": sdpa_bwd_ms, "sdpa_backend": backend,
            "ratio_port_over_sdpa": bwd_ms / sdpa_bwd_ms,
            "turns_ms": bwd_turns,
            "note": "delta + K3a + K3b against SDPA's backward (dQ, dK, "
                    "dV), in turns"}
        log(f"  time bf16 head_dim {d}: K2 {fwd_ms:.4f} ms vs SDPA "
            f"{backend} {sdpa_ms:.4f} (ratio {fwd_ms / sdpa_ms:.3f}); whole "
            f"backward {bwd_ms:.4f} vs {sdpa_bwd_ms:.4f} (ratio "
            f"{bwd_ms / sdpa_bwd_ms:.3f}); K3a "
            f"{rows[fa.BWD_DKDV_BF16][key]['ms']:.4f}, K3b "
            f"{rows[fa.BWD_DQ_BF16][key]['ms']:.4f}; bounds "
            + " / ".join(f"{bounds[n]['bound_ms']:.4f}" for n in names)
            + "; shares of bound " + " / ".join(
                f"{rows[n][key]['share_of_bound']:.3f}" for n in names))
        del sdpa, sdpa_bwd, c
    del flush
    for name in names:
        rows[name]["worst_vs_plain"] = worst[name]
    for name in rows:
        log(f"  time {name}: " + json.dumps(rows[name]))
    errs = {n: worst[n]["max_abs_err"] for n in names}
    errs[fa.DELTA] = delta_errs[fa.DELTA]
    return errs, rows


def flash_bf16_bench_phase(torch):
    """The JAX flash benchmark's configuration (flash_attention_bench.py:
    B=1, H=8, D=64, causal, bf16, q = k = v from seed 0) through the
    port's entry point flash_attention: forward + backward of
    sum(out.float()), timed with CUDA events (L2 flushed), in turns with
    the float32 kernels on the same values widened. The bf16 kernels'
    launch counts show the entry point went through them."""
    phase("flash bf16 bench")
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    out = {}
    for s in FLASH_BENCH_SEQS:
        x = np.random.RandomState(0).randn(1, s, FLASH_BENCH_HEADS,
                                           FLASH_BENCH_D)
        base = torch.from_numpy(x.astype(np.float32)).cuda()
        by_dtype = {}
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (base.to(dt).requires_grad_() for _ in range(3))

            def step(q=q, k=k, v=v):
                o = fa.flash_attention(q, k, v, causal=True)
                return torch.autograd.grad(o.float().sum(), (q, k, v))
            by_dtype[dt] = step
        _reset_kernel_counts()
        grads = by_dtype[torch.bfloat16]()
        torch.cuda.synchronize()
        launches, plain = _kernel_counts()
        want = {fa.FWD_BF16: 1, fa.BWD_DKDV_BF16: 1, fa.BWD_DQ_BF16: 1,
                fa.DELTA: 1}
        if {n: launches[n] for n in want} != want or any(plain.values()) \
                or any(launches[n] for n in (fa.FWD, fa.BWD_DKDV,
                                              fa.BWD_DQ)):
            raise RuntimeError(f"flash bf16 bench S={s}: launches "
                               f"{launches}, plain {plain}")
        if not all(g.dtype == torch.bfloat16 and torch.isfinite(
                g.float()).all() for g in grads):
            raise RuntimeError(f"flash bf16 bench S={s}: gradients not "
                               f"finite bf16")
        bf_ms, f32_ms, turns = _in_turns(torch, by_dtype[torch.bfloat16],
                                         by_dtype[torch.float32], flush)
        out[s] = {"shape": f"[1, {s}, {FLASH_BENCH_HEADS}, "
                           f"{FLASH_BENCH_D}] causal",
                  "fwd_bwd_ms_bf16": bf_ms, "fwd_bwd_ms_f32": f32_ms,
                  "ratio_bf16_over_f32": bf_ms / f32_ms, "turns_ms": turns}
        log(f"  flash bf16 bench S={s}: forward + backward bf16 "
            f"{bf_ms:.4f} ms, f32 kernels {f32_ms:.4f} ms (in turns)")
    del flush
    return out


def build_bf16_attention(heads, seq, dh, bf16, lr):
    """Transformer-base's self-attention layer as a Fluid program
    (models/transformer.py _mha, seq_parallel form): q, k, v fc
    projections without bias (num_flatten_dims=2) reshaped to [B, S, H,
    dh], cast to bfloat16 (unless ``bf16`` is False), causal
    ring_attention, cast back, reshape, the output fc, a squared-error
    loss against a target, Adam(lr). Returns (main, startup, cost)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    d = heads * dh
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[seq, d], dtype="float32")
        y = layers.data(name="y", shape=[seq, d], dtype="float32")

        def proj(inp, pname):
            return layers.fc(input=inp, size=d, num_flatten_dims=2,
                             bias_attr=False, param_attr=fluid.ParamAttr(
                                 name=f"attn.{pname}.w"))
        qkv = [layers.reshape(proj(x, n), shape=[0, 0, heads, dh])
               for n in "qkv"]
        if bf16:
            qkv = [layers.cast(t, "bfloat16") for t in qkv]
        ctx = layers.ring_attention(*qkv, causal=True)
        if bf16:
            ctx = layers.cast(ctx, "float32")
        out = proj(layers.reshape(ctx, shape=[0, 0, d]), "out")
        cost = layers.mean(layers.square_error_cost(input=out, label=y))
        fluid.optimizer.Adam(lr).minimize(cost)
    return main, startup, cost


def train_bf16_attn_phase(torch):
    """The slice's Fluid path: Transformer-base's self-attention layer at
    full width (x [16, 512, 512], 8 heads of 64, causal) with its
    attention core cast to bfloat16, Adam(1e-4), 5 steps on the card on
    one seeded batch. Counters zeroed just before the steps and read just
    after: 5 launches of each bf16 flash kernel, no float32 flash launch,
    no plain call; one more step profiled. Then the same 5 steps from the
    same state on the port's CPU route (losses within BF16_ATTN_CPU_RTOL) and of the same
    program without the casts on the card (float32 attention; losses
    within BF16_ATTN_LOSS_U bf16 steps, U = 2^-8, relative)."""
    phase("train bf16 attn")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa

    heads, dh = N_HEADS, D_MODEL // N_HEADS
    main, startup, cost = build_bf16_attention(heads, SEQ, dh, True, 1e-4)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope, f32_scope = fluid.Scope(), _scope_copy(fluid, scope)
    for n in scope.var_names():
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    rng = np.random.RandomState(4)
    feed = {k: rng.randn(TRAIN_BATCH, SEQ, D_MODEL).astype(np.float32)
            for k in ("x", "y")}
    dfeed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(_one_step(exe, main, dfeed, cost, scope))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    want = {fa.FWD_BF16: TRAIN_STEPS, fa.BWD_DKDV_BF16: TRAIN_STEPS,
            fa.BWD_DQ_BF16: TRAIN_STEPS, fa.DELTA: TRAIN_STEPS, fa.FWD: 0,
            fa.BWD_DKDV: 0, fa.BWD_DQ: 0}
    if {n: launches[n] for n in want} != want or any(plain.values()):
        raise RuntimeError(f"train bf16 attn: launches {launches}, plain "
                           f"{plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train bf16 attn: losses not finite or not "
                           f"falling: {losses}")
    profile = profile_step(torch, exe, main, dfeed, cost, scope)

    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_losses = [_one_step(cpu_exe, main, feed, cost, cpu_scope)
                  for _ in range(TRAIN_STEPS)]
    cpu_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    main32, _, cost32 = build_bf16_attention(heads, SEQ, dh, False, 1e-4)
    f32_losses = [_one_step(exe, main32, dfeed, cost32, f32_scope)
                  for _ in range(TRAIN_STEPS)]
    f32_u = max(abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)) / U
    if cpu_rel > BF16_ATTN_CPU_RTOL or f32_u > BF16_ATTN_LOSS_U:
        raise RuntimeError(
            f"train bf16 attn: losses {losses}; CPU route {cpu_losses} "
            f"(max rel {cpu_rel:.3g} > {BF16_ATTN_CPU_RTOL}?); f32 program "
            f"{f32_losses} ({f32_u:.3g} U > {BF16_ATTN_LOSS_U}?)")
    p50 = statistics.median(step_ms[1:])
    out = {
        "config": "transformer-base self-attention layer (d512 h8 dh64 "
                  "causal), q/k/v cast to bf16 around ring_attention, "
                  "fc out, squared error, adam1e-4",
        "batch": TRAIN_BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "losses_cpu_route": cpu_losses, "max_rel_vs_cpu": cpu_rel,
        "losses_f32_program": f32_losses, "max_u_vs_f32": f32_u,
        "profile": profile,
    }
    log("  train bf16 attn " + json.dumps(out))
    return out


# --- the data input stack and the padded-sequence path -------------------

# fit_a_line: the verify recipe (uci_housing -> batch 20 -> DataFeeder ->
# SGD(0.01), 5 epochs); card vs CPU losses within FIT_RTOL, the last loss
# at most FIT_DROP of the first
FIT_BATCH, FIT_EPOCHS, FIT_LR, FIT_RTOL, FIT_DROP = 20, 5, 0.01, 1e-5, 0.1
# the stacked LSTM at paddle_tpu/models/stacked_lstm.py's full width (emb
# 512, hid 512: an LSTM of H = 128 on a 512-wide projection, 3 stacked),
# imdb's dictionary, batch 32 (benchmarks/fluid_suite_bench.py:12-14),
# Adam(1e-3), 8 steps. Tolerance, card vs CPU (float32, TF32 off): cuBLAS
# and the CPU sum each product in another order (~1e-7 relative), the
# recurrence carries the difference through 128 steps and 3 layers, and
# Adam's first steps move every weight by about lr whatever its
# gradient's size, so a near-zero gradient of the other sign moves its
# weight by 2 lr. The one-step Transformer check holds 1e-5 on the loss
# and 1e-3 of each gradient's max; over 8 steps the losses get 1e-4.
LSTM = dict(emb_dim=512, hid_dim=512, stacked_num=3, class_dim=2)
LSTM_BATCH, LSTM_STEPS, LSTM_LR = 32, 8, 1e-3
LSTM_LOSS_RTOL, LSTM_GRAD_TOL = 1e-4, 1e-3
# resnet recordio: bench.py:583-628's pipeline over a file of uint8
# images (bench.py:596-612), 5 batches of 32 a pass, 2 passes
RIO_BATCHES, RIO_PASSES = 5, 2


def _cpu_scope(fluid, scope):
    """A CPU copy of every tensor in ``scope``."""
    out = fluid.Scope()
    for n in scope.var_names():
        v = scope.find_var(n)
        if hasattr(v, "detach"):
            out.set_var(n, v.detach().cpu().clone())
    return out


def _card_executor(fluid):
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    return exe


def _held_window(run):
    """The main path's window: every kernel count to 0, ``run()``, the
    counts read. No plain version may run on the card."""
    _reset_kernel_counts()
    out = run()
    launches, plain = _kernel_counts()
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    return out, {k: v for k, v in launches.items() if v}


def _run_steps(exe, program, feeds, fetch, scope):
    """One run a feed: the fetches of every step as numpy arrays, and
    each step's host ms."""
    import numpy as np

    out, ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append([np.asarray(v) for v in got])
    return out, ms


def _timed_steps(exe, program, feeds, fetch, scope):
    """(the first fetch of each step as a float, each step's ms)."""
    out, ms = _run_steps(exe, program, feeds, fetch, scope)
    return [float(o[0].reshape(-1)[0]) for o in out], ms


def _rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def fit_a_line_phase(torch):
    """The verify recipe on the card: uci_housing.train() ->
    paddle_tpu_torch.batch(..., 20) -> fluid.DataFeeder -> fc ->
    square_error_cost -> mean -> SGD(0.01), 5 epochs; the same feeds
    through the CPU executor from the same initial parameters. Held: the
    losses step by step within FIT_RTOL relative, the last loss at most
    FIT_DROP of the first."""
    phase("fit_a_line")
    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=FIT_LR).minimize(cost)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    reader = paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.uci_housing.train(), batch_size=FIT_BATCH)
    feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0), feed_list=[x, y],
                              program=main)
    feeds = [feeder.feed(data) for _ in range(FIT_EPOCHS)
             for data in reader()]

    def run():
        return _timed_steps(exe, main, feeds, [cost], scope)

    (losses, ms), launches = _held_window(run)
    cpu_losses, _ = _timed_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    feeds, [cost], cpu_scope)
    err = _rel_err(losses, cpu_losses)
    if err > FIT_RTOL:
        raise RuntimeError(f"fit_a_line card vs CPU losses differ by {err} "
                           f"relative (> {FIT_RTOL})")
    if not losses[-1] <= FIT_DROP * losses[0]:
        raise RuntimeError(f"fit_a_line loss {losses[0]} -> {losses[-1]}: "
                           f"not below {FIT_DROP} of the first")
    p50 = statistics.median(ms[1:])
    out = {"config": "fit_a_line: uci_housing (synthetic, 404 rows) fc 13->1"
                     f" SGD({FIT_LR}) batch {FIT_BATCH}, {FIT_EPOCHS} epochs",
           "steps": len(feeds), "loss_first": losses[0],
           "loss_last": losses[-1], "max_rel_err_vs_cpu": err,
           "p50_step_ms": p50, "steps_per_s": 1e3 / p50,
           "kernel_launches": launches}
    log("  fit_a_line " + json.dumps(out))
    return out


def _build_stacked_lstm(seed, dict_dim):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import stacked_lstm

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = stacked_lstm.build(words, label, dict_dim=dict_dim,
                                          **LSTM)
        fluid.optimizer.Adam(LSTM_LR).minimize(cost)
    weights = [op.input("Weight")[0] for op in main.global_block().ops
               if op.type == "lstm"]
    return main, startup, cost, [words, label], weights


def _device_launches(events):
    """Kernel launches (and copies) in a profile: the count of its
    device-side entries."""
    return sum(ev.count for ev in events
               if str(getattr(ev, "device_type", "")).endswith("CUDA"))


def lstm_train_phase(torch):
    """stacked_dynamic_lstm at full width on the card: models/
    stacked_lstm.build (emb 512, hid 512 -> H 128, 3 stacked, imdb's
    5147-word dictionary, 2 classes), Adam(1e-3), batch 32 from
    paddle_tpu_torch.batch(dataset.imdb.train(), 32) through DataFeeder
    (lengths 8-119: T pads to 128), 8 steps; the same feeds on the CPU
    executor from the card's initial parameters. Held: losses finite and
    within LSTM_LOSS_RTOL relative, the step-1 gradients of the three
    LSTM weights within LSTM_GRAD_TOL of each one's largest |value|.
    Logged: p50 step ms (steps 2-8), words/s (real tokens: the sum of
    @LEN), one profiled step's busy share, largest entries and launches,
    peak memory."""
    phase("lstm train")
    import numpy as np

    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid

    imdb = paddle_tpu_torch.dataset.imdb
    main, startup, cost, feed_vars, weights = _build_stacked_lstm(
        11, imdb.VOCAB_SIZE)
    grads = [w + "@GRAD" for w in weights]
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0), feed_list=feed_vars,
                              program=main)
    reader = paddle_tpu_torch.batch(imdb.train(), LSTM_BATCH)
    feeds = []
    for data in reader():
        feeds.append(feeder.feed(data))
        if len(feeds) == LSTM_STEPS + 1:
            break
    T = {f["words"].shape[1] for f in feeds}
    if T != {128}:
        raise RuntimeError(f"imdb batches padded to T = {T}, want 128")
    words = [int(f["words@LEN"].sum()) for f in feeds]

    def steps(ex, sc):
        losses, ms, step1 = [], [], None
        for i, feed in enumerate(feeds[:LSTM_STEPS]):
            t0 = time.perf_counter()
            out = ex.run(main, feed=feed, scope=sc,
                         fetch_list=[cost] + (grads if i == 0 else []))
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                step1 = [np.asarray(g) for g in out[1:]]
        return losses, ms, step1

    torch.cuda.reset_peak_memory_stats()
    (losses, ms, g_card), launches = _held_window(lambda: steps(exe, scope))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    cpu_losses, _, g_cpu = steps(fluid.Executor(fluid.CPUPlace()), cpu_scope)
    cpu_s = time.perf_counter() - t0
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"lstm losses not finite: {losses}")
    err = _rel_err(losses, cpu_losses)
    if err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"lstm card vs CPU losses differ by {err} "
                           f"relative (> {LSTM_LOSS_RTOL}): {losses} vs "
                           f"{cpu_losses}")
    grad_err = {}
    for name, a, b in zip(grads, g_card, g_cpu):
        grad_err[name] = float(np.abs(a - b).max() / np.abs(b).max())
        if not grad_err[name] <= LSTM_GRAD_TOL:
            raise RuntimeError(f"{name}: card vs CPU differ by "
                               f"{grad_err[name]} of its max")
    p50 = statistics.median(ms[1:])
    mean_words = statistics.mean(words[1:LSTM_STEPS])
    out = {"config": "stacked_dynamic_lstm imdb dict 5147 emb 512 hid 512 "
                     "(H 128) x3, 2 classes, Adam(1e-3), batch 32, T 128",
           "steps": LSTM_STEPS, "losses": losses, "cpu_losses": cpu_losses,
           "max_rel_err_vs_cpu": err, "step1_grad_err_of_max": grad_err,
           "step_ms": ms, "p50_step_ms_after_first": p50,
           "real_tokens_a_step": words[:LSTM_STEPS],
           "words_per_s": mean_words / (p50 / 1e3),
           "peak_memory_allocated_gb": peak_gb,
           "cpu_8_steps_s": cpu_s, "kernel_launches": launches}
    log("  lstm train " + json.dumps(out))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feeds[LSTM_STEPS], fetch_list=[cost], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out["profile"] = _device_summary(events, wall_ms, "lstm train step")
    out["profile"]["device_launches_a_step"] = _device_launches(events)
    log(f"  lstm train step: {out['profile']['device_launches_a_step']} "
        "device launches (kernels and copies)")
    return out


def _write_image_records(path, n):
    """n samples of a uint8 [3*224*224] image and an int64 [1] label, from
    RandomState(0), into a recordio file: bench.py:596-612's file."""
    import numpy as np

    from paddle_tpu_torch.fluid.recordio_writer import (
        convert_reader_to_recordio_file)

    rng0 = np.random.RandomState(0)

    def samples():
        for _ in range(n):
            yield (rng0.randint(0, 256, size=(3 * RESNET_IMAGE
                                              * RESNET_IMAGE,)).astype(
                       np.uint8),
                   rng0.randint(0, RESNET_CLASSES, size=(1,)).astype(
                       np.int64))

    return convert_reader_to_recordio_file(path, samples)


def _build_resnet50_reader(seed, path):
    """resnet.build_train fed by bench.py:583-628's in-graph pipeline, or
    (``path`` None) by data vars; the same parameter names either way."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    reader = None
    with unique_name.guard(), fluid.program_guard(main, startup):
        if path:
            reader = layers.open_recordio_file(
                path, shapes=[[3, RESNET_IMAGE, RESNET_IMAGE], [1]],
                dtypes=["float32", "int64"])
            reader = layers.multi_pass(reader, pass_num=RIO_PASSES)
            reader = layers.batch(reader, batch_size=RESNET_TRAIN_BATCH,
                                  drop_last=True)
            reader = layers.double_buffer(reader, capacity=2)
            img, label = layers.read_file(reader)
        else:
            img = layers.data(name="img",
                              shape=[3, RESNET_IMAGE, RESNET_IMAGE],
                              dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64")
        cost, _, _ = resnet.build_train(img, label, class_dim=RESNET_CLASSES,
                                        depth=50)
        fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost, reader, img


def _trace_streams(path):
    """From a chrome trace: the host-to-device copies and the kernels,
    each as (start us, end us, stream)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    copies, kernels = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                (ev.get("args") or {}).get("stream"))
        if ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            copies.append(span)
        elif ev.get("cat") == "kernel":
            kernels.append(span)
    return copies, kernels


def _copy_overlap(copies, kernels):
    """Each copy's time, and how much of it some kernel on another stream
    ran beside."""
    total = overlap = 0.0
    for a, b, s in copies:
        total += b - a
        cuts = sorted((max(a, ka), min(b, kb)) for ka, kb, ks in kernels
                      if ks != s and kb > a and ka < b)
        end = a
        for x, y in cuts:
            x = max(x, end)
            if y > x:
                overlap += y - x
                end = y
    return {"copies": len(copies), "copy_ms": total / 1e3,
            "copy_streams": sorted({str(s) for _, _, s in copies}),
            "kernel_streams": sorted({str(s) for _, _, s in kernels}),
            "overlap_ms": overlap / 1e3,
            "overlap_share": overlap / total if total else None}


def resnet_recordio_phase(torch):
    """The resnet train phase's ResNet-50 (batch 32, Momentum(0.01, 0.9),
    deterministic cuDNN algorithms) fed by bench.py:583-628's in-graph
    pipeline: open_recordio_file(shapes [[3,224,224],[1]], float32/int64)
    -> multi_pass(2) -> batch(32, drop_last) -> double_buffer(2) ->
    read_file, over a recordio file of 5 x 32 uint8 images written as
    bench.py:596-612 does (under the run's temporary directory, removed
    at exit). Held: the same 5 batches, decoded on the host and fed as
    numpy dicts to a copy of the same initial state, in turns with the
    pipeline's steps through both passes: bitwise-equal losses, and every
    parameter, running statistic and velocity bitwise equal after them;
    then EOFException; reset_reader rewinds (the next batch is the first
    batch again). Logged: p50 step ms of each feed (steps 2-10), two
    profiled pipeline steps' host-to-device copies and how far kernels
    on another stream overlap them."""
    phase("resnet recordio")
    import pickle
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import core, layers
    from paddle_tpu_torch.native.recordio import read_all

    tmp = tempfile.mkdtemp(prefix="resnet_recordio_")
    scope = fluid.Scope()
    try:
        path = os.path.join(tmp, "imgs.recordio")
        n = RIO_BATCHES * RESNET_TRAIN_BATCH
        t0 = time.perf_counter()
        _write_image_records(path, n)
        write_s = time.perf_counter() - t0
        main, startup, cost, reader, img = _build_resnet50_reader(5, path)
        dmain, _, dcost, _, _ = _build_resnet50_reader(5, None)
        exe = _card_executor(fluid)
        exe.run(startup, scope=scope)
        dscope = fluid.Scope()
        for name in scope.var_names():
            v = scope.find_var(name)
            if isinstance(v, torch.Tensor):
                dscope.set_var(name, v.clone())
        state = [name for name in dscope.var_names()]
        samples = [pickle.loads(r) for r in read_all(path)]
        batches = []
        for b in range(RIO_BATCHES):
            part = samples[b * RESNET_TRAIN_BATCH:(b + 1) * RESNET_TRAIN_BATCH]
            batches.append({
                "img": np.stack([s[0] for s in part]).reshape(
                    -1, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32),
                "label": np.stack([s[1] for s in part])})
        del samples

        def in_turns():
            """Every pass of the file, each pipeline step beside the
            dict step of the same batch, which of the two goes first
            alternating: rows of ((pipeline ms, loss), (dict ms,
            loss))."""
            rows = []
            for i, feed in enumerate(batches * RIO_PASSES):
                pair = [(main, cost, scope, None),
                        (dmain, dcost, dscope, feed)]
                row = {}
                for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                    prog, c, sc, fd = pair[k]
                    t0 = time.perf_counter()
                    (loss,) = exe.run(prog, feed=fd, fetch_list=[c],
                                      scope=sc)
                    row[k] = ((time.perf_counter() - t0) * 1e3,
                              float(np.asarray(loss).reshape(-1)[0]))
                rows.append((row[0], row[1]))
            return rows

        rows, launches = _held_window(in_turns)
        losses = [r[0][1] for r in rows]
        if [r[1][1] for r in rows] != losses:
            raise RuntimeError(f"pipeline vs dict losses differ: {rows}")
        differ = [nm for nm in state if not torch.equal(
            scope.find_var(nm), dscope.find_var(nm))]
        if differ:
            raise RuntimeError(f"after {len(rows)} steps {len(differ)} "
                               f"state tensors differ, e.g. {differ[:3]}")
        log(f"  {len(rows)} steps in turns ({RIO_PASSES} passes of "
            f"{RIO_BATCHES} batches): losses bitwise equal {losses}; "
            f"{len(state)} state tensors bitwise equal")
        try:
            exe.run(main, fetch_list=[cost], scope=scope)
        except core.EOFException:
            pass
        else:
            raise RuntimeError("the reader did not end after "
                               f"{RIO_PASSES} passes")
        layers.reset_reader(reader, scope)
        (again,) = exe.run(main, fetch_list=[img], scope=scope)
        if not np.array_equal(again, batches[0]["img"]):
            raise RuntimeError("reset_reader: the next batch is not the "
                               "first")
        log(f"  the file's {RIO_PASSES} passes read, then EOFException; "
            "after reset_reader the first batch again")
        from torch.profiler import ProfilerActivity, profile

        # the double buffer's threads finish their prefetch first; then
        # each of the two profiled steps' pops starts one transfer (the
        # profiler may drop a copy issued before the first step's
        # kernels: the second step's falls well inside the window)
        time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                exe.run(main, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(os.path.dirname(LOG_PATH),
                             "resnet_recordio_trace.json")
        prof.export_chrome_trace(trace)
        overlap = _copy_overlap(*_trace_streams(trace))
        prof_sum = _device_summary(prof.key_averages(), wall_ms,
                                   "resnet recordio, two steps")
    finally:
        for name in scope.var_names():  # the double buffer's threads
            if isinstance(scope.find_var(name), fluid.readers.HostReader):
                scope.find_var(name).close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"config": "resnet-50 imagenet f32 momentum 0.01/0.9 batch 32, "
                     "recordio of uint8 images -> multi_pass(2) -> batch(32)"
                     " -> double_buffer(2) -> read_file",
           "records": n, "write_s": write_s, "losses": losses,
           "pipeline_step_ms": [r[0][0] for r in rows],
           "dict_step_ms": [r[1][0] for r in rows],
           # p50 of steps 2-5 (the first picks cuDNN's algorithms)
           "p50_pipeline_ms": statistics.median(r[0][0] for r in rows[1:]),
           "p50_dict_ms": statistics.median(r[1][0] for r in rows[1:]),
           "pipeline_faster_in_pairs": sum(r[0][0] < r[1][0]
                                           for r in rows[1:]),
           "h2d_in_two_profiled_steps": overlap, "profile": prof_sum,
           "kernel_launches": launches}
    log("  resnet recordio " + json.dumps(out))
    return out


# dynamic rnn: benchmarks/fluid_suite_bench.py:115-162's stacked_lstm at
# full width (embedding 512 over imdb's 5147 words, fc 512 tanh, the
# DynamicRNN LSTM cell of four fc-gate pairs with hidden 512, softmax over
# 2), Adam(1e-3), batch 32 cropped to 100 words; 5 steps on the card and
# on the CPU, then one ragged batch (lengths 20-100). Held as lstm train:
# losses within LSTM_LOSS_RTOL, step-1 gradients within LSTM_GRAD_TOL of
# each one's largest |value|.
DRNN = dict(vocab=5147, emb_dim=512, hidden=512)
DRNN_BATCH, DRNN_CROP, DRNN_STEPS, DRNN_LR = 32, 100, 5, 1e-3
DRNN_RAGGED = (20, 100)  # the ragged batch's shortest and longest
# seq2seq: the book's machine-translation programs at width 512
# (WORD_DIM 512, HIDDEN 512, wmt14's 30000-word dictionary), batch 16 from
# dataset.wmt14.train through batch + DataFeeder, Adam(1e-3), 5 steps;
# the While beam decode (beam 3, MAX_LEN 32) on the trained scope, card
# against CPU under the margin rule (MARGIN_REL x max|score|); one step
# of seq_to_seq_net at the same widths.
S2S = dict(dict_size=30000, word_dim=512, hidden=512)
S2S_BATCH, S2S_STEPS, S2S_LR, S2S_BEAM, S2S_MAX_LEN = 16, 5, 1e-3, 3, 32


def _param_grads(program):
    return [p.name + "@GRAD" for p in program.global_block().all_parameters()
            if program.global_block().has_var(p.name + "@GRAD")]


def _grad_errs(names, card, cpu):
    """Each gradient's max |card - cpu| over its own max |cpu|; raises
    past LSTM_GRAD_TOL."""
    import numpy as np

    errs = {}
    for name, a, b in zip(names, card, cpu):
        errs[name] = float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                     1e-30))
        if not errs[name] <= LSTM_GRAD_TOL:
            raise RuntimeError(f"{name}: card vs CPU differ by "
                               f"{errs[name]} of its max")
    return errs


def _steps_card_cpu(torch, exe, main, feeds, fetch, grads, scope,
                    cpu_scope):
    """``feeds`` on the card (kernel counts held, timed) and then on the
    CPU from ``cpu_scope``: losses within LSTM_LOSS_RTOL, step-1
    gradients within LSTM_GRAD_TOL of their max. Returns (card losses,
    step ms, CPU losses, gradient errors, launches, peak GB)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    def steps(ex, sc):
        losses, ms, step1 = [], [], None
        for i, feed in enumerate(feeds):
            t0 = time.perf_counter()
            out = ex.run(main, feed=feed, scope=sc,
                         fetch_list=[fetch] + (grads if i == 0 else []))
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                step1 = [np.asarray(g) for g in out[1:]]
        return losses, ms, step1

    torch.cuda.reset_peak_memory_stats()
    (losses, ms, g_card), launches = _held_window(lambda: steps(exe, scope))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cpu_losses, _, g_cpu = steps(fluid.Executor(fluid.CPUPlace()), cpu_scope)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite: {losses}")
    err = _rel_err(losses, cpu_losses)
    if err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"card vs CPU losses differ by {err} relative "
                           f"(> {LSTM_LOSS_RTOL}): {losses} vs {cpu_losses}")
    return (losses, ms, cpu_losses, err, _grad_errs(grads, g_card, g_cpu),
            launches, peak_gb)


def _profiled(torch, exe, main, feed, fetch, scope, what):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out = _device_summary(events, wall_ms, what)
    out["device_launches"] = _device_launches(events)
    return out


def dynamic_rnn_phase(torch):
    """benchmarks/fluid_suite_bench.py:115-162's program through
    models/seq2seq.dynamic_rnn_lstm at full width (embedding 512 over
    5147 words, fc 512 tanh, a DynamicRNN whose LSTM cell is four pairs
    of fc gates with hidden 512, sequence_last_step, softmax over 2,
    cross_entropy), Adam(1e-3), batch 32 cropped to 100 words (the
    suite's fixed-length feed), 5 steps on the card and on the CPU from
    the same parameters: losses within LSTM_LOSS_RTOL relative, the
    step-1 gradient of every parameter within LSTM_GRAD_TOL of its max.
    Then one ragged batch (lengths 20-100) from a copy of the trained
    state on both: loss and gradients held alike, the DynamicRNN's
    output exactly 0 past each length. Logged: p50 step ms (steps 2-5),
    real words/s (the sum of @LEN), one profiled step's busy share and
    device launches, peak memory."""
    phase("dynamic rnn")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import seq2seq

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with unique_name.guard(), fluid.program_guard(main, startup):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost = seq2seq.dynamic_rnn_lstm(layers, words, label, **DRNN)
        fluid.optimizer.Adam(DRNN_LR).minimize(cost)
    rnn_out = [op.output("Out")[0] for op in main.global_block().ops
               if op.type == "dynamic_recurrent"][0]
    grads = _param_grads(main)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    rng = np.random.RandomState(2029)

    def batch(lengths):
        return {"words": rng.randint(0, DRNN["vocab"], (
                    DRNN_BATCH, DRNN_CROP, 1)).astype(np.int64),
                "words@LEN": np.asarray(lengths, np.int32),
                "label": rng.randint(0, 2, (DRNN_BATCH, 1)).astype(
                    np.int64)}

    feeds = [batch([DRNN_CROP] * DRNN_BATCH) for _ in range(DRNN_STEPS + 1)]
    (losses, ms, cpu_losses, err, grad_err, launches,
     peak_gb) = _steps_card_cpu(torch, exe, main, feeds[:DRNN_STEPS], cost,
                                grads, scope, cpu_scope)
    p50 = statistics.median(ms[1:])
    words = DRNN_BATCH * DRNN_CROP
    out = {"config": "suite stacked_lstm: DynamicRNN LSTM cell (4 fc-gate "
                     "pairs), emb 512 over 5147 words, hidden 512, 2 "
                     "classes, Adam(1e-3), batch 32, crop 100",
           "steps": DRNN_STEPS, "losses": losses, "cpu_losses": cpu_losses,
           "max_rel_err_vs_cpu": err,
           "step1_grad_err_of_max_worst": max(grad_err.values()),
           "step1_grads_held": len(grad_err), "step_ms": ms,
           "p50_step_ms_after_first": p50,
           "words_per_s": words / (p50 / 1e3),
           "peak_memory_allocated_gb": peak_gb,
           "kernel_launches": launches}
    # the ragged batch, card and CPU from the same trained state
    lo, hi = DRNN_RAGGED
    ragged = batch(np.concatenate([[lo, hi], rng.randint(
        lo, hi + 1, DRNN_BATCH - 2)]))
    cpu_scope = _cpu_scope(fluid, scope)
    fetch = [cost, rnn_out] + grads
    card = exe.run(main, feed=ragged, fetch_list=fetch, scope=scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=ragged, fetch_list=fetch, scope=cpu_scope)
    r_err = _rel_err(card[0], cpu[0])
    if r_err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"ragged batch: card vs CPU loss {card[0]} vs "
                           f"{cpu[0]} ({r_err} relative)")
    r_grad = _grad_errs(grads, card[2:], cpu[2:])
    pad = np.arange(DRNN_CROP)[None, :] >= ragged["words@LEN"][:, None]
    if np.asarray(card[1])[pad].any():
        raise RuntimeError("DynamicRNN output is not 0 past a length")
    out["ragged"] = {"lengths_min_max": [int(ragged["words@LEN"].min()),
                                         int(ragged["words@LEN"].max())],
                     "loss": float(np.asarray(card[0]).reshape(-1)[0]),
                     "rel_err_vs_cpu": r_err,
                     "grad_err_of_max_worst": max(r_grad.values())}
    log("  dynamic rnn " + json.dumps(out))
    out["profile"] = _profiled(torch, exe, main, feeds[DRNN_STEPS], cost,
                               scope, "dynamic rnn step")
    log(f"  dynamic rnn step: {out['profile']['device_launches']} device "
        "launches (kernels and copies)")
    return out


def _decode_held(card, cpu):
    """Card against CPU beam decode under the margin rule. For each batch
    row, steps are compared from the first on: ids and parents bitwise
    until the first step where they differ; there the card's and the
    CPU's selected scores must agree within MARGIN_REL x max|score| (a
    near tie reordered, not a wrong score), the position is named, and
    the row's later steps (a different path) are not compared. Final
    sentences of rows never cut must be bitwise equal; scores within
    MARGIN_REL x max|score| everywhere compared."""
    import numpy as np

    (c_ids, c_sc, c_par, c_sent), (p_ids, p_sc, p_par, p_sent) = card, cpu
    # step 0 holds the fed start scores (-1e9 lanes): not a decode score
    tol = MARGIN_REL * float(np.abs(p_sc[1:]).max())
    T, B = c_ids.shape[0], c_ids.shape[1]
    cuts, compared = [], 0
    for b in range(B):
        for t in range(1, T):
            same = (np.array_equal(c_ids[t, b], p_ids[t, b])
                    and np.array_equal(c_par[t, b], p_par[t, b]))
            gap = float(np.abs(c_sc[t, b] - p_sc[t, b]).max())
            if same:
                if gap > tol:
                    raise RuntimeError(f"decode row {b} step {t}: scores "
                                       f"differ by {gap} (> {tol})")
                compared += 1
                continue
            if gap > tol:
                raise RuntimeError(
                    f"decode row {b} step {t}: ids {c_ids[t, b]} vs "
                    f"{p_ids[t, b]}, parents {c_par[t, b]} vs "
                    f"{p_par[t, b]}, and scores differ by {gap} (> {tol}): "
                    "not a near tie")
            cuts.append({"row": b, "step": t, "score_gap": gap})
            break
    cut_rows = {c["row"] for c in cuts}
    for b in range(B):
        if b not in cut_rows and not np.array_equal(c_sent[b], p_sent[b]):
            raise RuntimeError(f"decode row {b}: sentences differ")
    return {"positions_compared": compared, "cuts": cuts, "tol": tol}


def seq2seq_phase(torch):
    """The book's machine-translation programs through models/seq2seq at
    width 512 (WORD_DIM 512, HIDDEN 512, wmt14's 30000-word dictionary).
    Train: mt_train (dynamic_lstm encoder, DynamicRNN decoder, masked
    cross-entropy), Adam(1e-3), batch 16 from dataset.wmt14.train
    through paddle_tpu_torch.batch and DataFeeder, 5 steps on the card
    and on the CPU from the same parameters, held as dynamic rnn.
    Decode: mt_decode (an unbounded While over tensor arrays, beam 3,
    MAX_LEN 32) on the card's trained scope and on a CPU copy of it: ids
    and parents under the margin rule (_decode_held); decode ms, loop
    iterations and host syncs (the fluid.* counters). seq_to_seq_net
    (tests/test_rnn_encoder_decoder.py:65-105) at the same widths: one
    step on the card and on the CPU, loss and gradients held alike."""
    phase("seq2seq")
    import numpy as np

    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.observability import metrics

    def build(fn, lr=S2S_LR):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 17
        with unique_name.guard(), fluid.program_guard(main, startup):
            out = fn()
            if lr:
                fluid.optimizer.Adam(lr).minimize(out)
        return main, startup, out

    reader = paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.wmt14.train(S2S["dict_size"]), S2S_BATCH)

    def wmt_feeds(main, names, n, slots=None):
        """The reader's first ``n`` batches through a DataFeeder of
        ``names`` (fed from the sample ``slots``, all by default)."""
        feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0), feed_list=names,
                                  program=main)
        feeds = []
        for data in reader():
            if slots is not None:
                data = [tuple(d[k] for k in slots) for d in data]
            feeds.append(feeder.feed(data))
            if len(feeds) == n:
                return feeds

    out = {"config": "machine translation: wmt14 dict 30000, word 512, "
                     "hidden 512, batch 16, Adam(1e-3); beam 3, MAX_LEN 32"}
    main, startup, cost = build(lambda: seq2seq.mt_train(
        layers, batch=S2S_BATCH, **S2S))
    grads = _param_grads(main)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    names = ["src_word_id", "target_language_word",
             "target_language_next_word"]
    feeds = wmt_feeds(main, names, S2S_STEPS + 1)
    (losses, ms, cpu_losses, err, grad_err, launches,
     peak_gb) = _steps_card_cpu(torch, exe, main, feeds[:S2S_STEPS], cost,
                                grads, scope, cpu_scope)
    p50 = statistics.median(ms[1:])
    words = [int(f["target_language_word@LEN"].sum()) for f in feeds]
    out["train"] = {
        "steps": S2S_STEPS, "losses": losses, "cpu_losses": cpu_losses,
        "max_rel_err_vs_cpu": err,
        "step1_grad_err_of_max_worst": max(grad_err.values()),
        "step1_grads_held": len(grad_err), "step_ms": ms,
        "p50_step_ms_after_first": p50,
        "T": int(feeds[0]["target_language_word"].shape[1]),
        "target_words_per_s": statistics.mean(words[1:S2S_STEPS])
        / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb, "kernel_launches": launches}
    out["train"]["profile"] = _profiled(torch, exe, main, feeds[S2S_STEPS],
                                        cost, scope, "seq2seq train step")
    log("  seq2seq train " + json.dumps(out["train"]))

    # the beam decode on the trained scope, card and a CPU copy of it
    dmain, dstartup, (ids, scores, arrays) = build(lambda: seq2seq.mt_decode(
        layers, batch=S2S_BATCH, beam=S2S_BEAM, max_len=S2S_MAX_LEN, **S2S),
        lr=0)
    for v in dmain.global_block().vars.values():
        if v.persistable and not scope.has_var(v.name):
            raise RuntimeError(f"decode reads {v.name}, not trained")
    (dfeed,) = wmt_feeds(dmain, ["src_word_id"], 1, slots=[0])
    dfeed.update(seq2seq.decode_init(S2S_BATCH, S2S_BEAM))
    fetch = list(arrays) + [ids, scores]
    iters = metrics.counter("fluid.while.iterations")
    syncs = metrics.counter("fluid.control_flow.host_syncs")
    cpu_scope = _cpu_scope(fluid, scope)
    exe.run(dmain, feed=dfeed, fetch_list=fetch, scope=scope)  # warm

    def decode():
        i0, s0 = iters.value(), syncs.value()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(dmain, feed=dfeed, fetch_list=fetch, scope=scope)
        return ((time.perf_counter() - t0) * 1e3, got,
                iters.value() - i0, syncs.value() - s0)

    (dec_ms, card, n_iter, n_sync), d_launches = _held_window(decode)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        dmain, feed=dfeed, fetch_list=fetch, scope=cpu_scope)
    card = [np.asarray(v) for v in card]
    cpu = [np.asarray(v) for v in cpu]
    if card[3].shape != (S2S_BATCH, S2S_BEAM, S2S_MAX_LEN + 1):
        raise RuntimeError(f"decode ids shape {card[3].shape}")
    if not np.isfinite(card[4]).all() or \
            (np.diff(card[4], axis=1) > 0).any():
        raise RuntimeError("decode scores not finite or not best first")
    held = _decode_held(card[:3] + [card[3]], cpu[:3] + [cpu[3]])
    out["decode"] = {"ms": dec_ms, "loop_iterations": n_iter,
                     "host_syncs": n_sync, "kernel_launches": d_launches,
                     "held": held,
                     "best_scores_row0": card[4][0].tolist()}
    out["decode"]["profile"] = _profiled(torch, exe, dmain, dfeed, ids,
                                         scope, "seq2seq decode")
    log("  seq2seq decode " + json.dumps(out["decode"]))

    # seq_to_seq_net, one step on the card and on the CPU
    smain, sstartup, scost = build(lambda: seq2seq.seq_to_seq_net(
        layers, batch=S2S_BATCH, **S2S))
    sgrads = _param_grads(smain)
    sscope = fluid.Scope()
    exe.run(sstartup, scope=sscope)
    s_cpu = _cpu_scope(fluid, sscope)
    sfeeds = wmt_feeds(smain, ["source_sequence", "target_sequence",
                               "label_sequence"], 1)
    (s_losses, s_ms, s_cpu_losses, s_err, s_grad, s_launches,
     _) = _steps_card_cpu(torch, exe, smain, sfeeds, scost, sgrads, sscope,
                          s_cpu)
    out["seq_to_seq_net"] = {
        "loss": s_losses[0], "cpu_loss": s_cpu_losses[0],
        "rel_err_vs_cpu": s_err, "grads_held": len(s_grad),
        "grad_err_of_max_worst": max(s_grad.values()), "step_ms": s_ms[0],
        "kernel_launches": s_launches}
    log("  seq_to_seq_net " + json.dumps(out["seq_to_seq_net"]))
    return out


# train recipe: Transformer-base trained with the whole training recipe —
# noam_decay(512, 4000), global-norm clipping at 1.0, L2 decay 1e-4, Adam
# — with recompute (each encoder and decoder layer one Recompute region)
# and without; fit_a_line's program under each optimizer; a resume from
# save_checkpoint.
RECIPE_NOAM, RECIPE_CLIP, RECIPE_L2 = (D_MODEL, 4000), 1.0, 1e-4
RECIPE_STEPS, RECIPE_CHECK_STEPS, RECIPE_RESUME_AT = 5, 3, 3
RECIPE_TURNS = 3           # in-turns steps of each program (each first once)
RECIPE_LR_RTOL = 1e-6      # fetched rate against noam's closed form
RECIPE_RC_RTOL = 1e-6      # recompute vs plain losses on the card
RECIPE_RC_GRAD_TOL = 1e-5  # ... and step-1 gradients, of their max
RECIPE_OPT_RTOL = 1e-6     # card vs CPU parameters, of their max
RECIPE_OPTIMIZERS = {
    "SGD": {}, "Momentum": {"momentum": 0.9}, "Adam": {}, "Adagrad": {},
    "Adamax": {}, "DecayedAdagrad": {}, "Adadelta": {},
    "RMSProp": {"momentum": 0.5}, "Ftrl": {"l1": 0.01, "l2": 0.01}}
# per step of Transformer-base (6+6 layers): 30 layer norms and 18
# attentions; with recompute each region's forward runs again in backward
RECIPE_LAUNCHES = {
    False: {"layer_norm_f32": 30, "flash_fwd_f32": 18,
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
            "flash_delta": 18},
    True: {"layer_norm_f32": 60, "flash_fwd_f32": 36,
           "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
           "flash_delta": 18}}


def build_recipe(cfg_kw, recompute):
    """The Transformer with the recipe: set_gradient_clip(
    GradientClipByGlobalNorm), Adam(noam_decay, regularization=L2Decay).
    Returns (main, startup, cost, params_grads, learning-rate var)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        cfg = transformer.TransformerConfig(recompute=recompute, **cfg_kw)
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = transformer.build_train(cfg, src, trg, lbl)
        fluid.set_gradient_clip(
            fluid.GradientClipByGlobalNorm(RECIPE_CLIP))
        lr = layers.noam_decay(*RECIPE_NOAM)
        _, pg = fluid.optimizer.Adam(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(RECIPE_L2)).minimize(cost)
    return main, startup, cost, pg, lr


def noam_rate(step):
    """noam_decay's rate at 1-based ``step``, in float64."""
    d, warm = RECIPE_NOAM
    return d ** -0.5 * min(step ** -0.5, step * warm ** -1.5)


def _recipe_timing(torch, fluid, feed):
    """Part 1: five steps of Transformer-base without recompute, then
    five with, from the same parameters, each window with only its own
    model's state on the card (launches, p50, peak memory, one profiled
    step); then RECIPE_TURNS steps of each in turns, beside the train
    phase's program (Adam at a constant rate, no clip, no decay), each
    form first in its turn, every state on the card, for step times
    taken side by side."""
    import numpy as np

    out, params, models = {}, None, {}
    for recompute in (False, True):
        key = "recompute" if recompute else "plain"
        t0 = time.perf_counter()
        main, startup, cost, pg, lr = build_recipe(TRANSFORMER_BASE,
                                                   recompute)
        build_s = time.perf_counter() - t0
        exe, scope = _card_executor(fluid), fluid.Scope()
        exe.run(startup, scope=scope)
        if params is None:
            params = {p.name: scope.find_var(p.name).clone()
                      for p in main.global_block().all_parameters()}
        for n, v in params.items():
            scope.set_var(n, v.clone())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (steps, ms), launches = _held_window(lambda: _run_steps(
            exe, main, [feed] * RECIPE_STEPS, [cost, lr], scope))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {k: v * RECIPE_STEPS for k, v in
                RECIPE_LAUNCHES[recompute].items()}
        if launches != want:
            raise RuntimeError(f"recompute={recompute}: launches {launches}"
                               f" in {RECIPE_STEPS} steps, want {want}")
        losses = [float(s[0].reshape(-1)[0]) for s in steps]
        rates = [float(s[1].reshape(-1)[0]) for s in steps]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"recipe losses not finite: {losses}")
        rate_err = max(abs(r - noam_rate(i + 1)) / noam_rate(i + 1)
                       for i, r in enumerate(rates))
        if rate_err > RECIPE_LR_RTOL:
            raise RuntimeError(f"learning rate {rates} off noam's curve by "
                               f"{rate_err} relative")
        p50 = statistics.median(ms[1:])
        out[key] = {
            "losses": losses, "rates": rates,
            "rate_max_rel_err_vs_noam": rate_err, "step_ms": ms,
            "p50_step_ms_after_first": p50,
            "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
            "peak_memory_allocated_gb": peak_gb, "build_s": build_s,
            "ops": len(main.global_block().ops),
            "launches_per_step": {k: v // RECIPE_STEPS
                                  for k, v in launches.items()}}
        log(f"  recipe {key} " + json.dumps(out[key]))
        out[key]["profile"] = profile_step(torch, exe, main, feed, cost,
                                           scope, f"recipe {key} step")
        models[key] = [main, startup, cost, exe, scope]
        if not recompute:
            models[key][4] = None  # the next window holds one model
            del scope
    if not out["recompute"]["peak_memory_allocated_gb"] < \
            out["plain"]["peak_memory_allocated_gb"]:
        raise RuntimeError("recompute did not lower peak memory: "
                           f"{out['recompute']['peak_memory_allocated_gb']}"
                           f" vs {out['plain']['peak_memory_allocated_gb']}"
                           " GB")
    # in turns: the two recipe forms and the train phase's program (Adam
    # at a constant rate, no clip, no decay) from the same parameters
    main, startup, cost, _ = build_transformer(TRANSFORMER_BASE, 1e-4)
    models["adam_only"] = [main, startup, cost, models["plain"][3], None]
    for key in ("plain", "adam_only"):
        m = models[key]
        m[4] = fluid.Scope()
        m[3].run(m[1], scope=m[4])
        for n, v in params.items():
            m[4].set_var(n, v.clone())
    # the Adam-only program's first run (untimed, as each window's first)
    _run_steps(models["plain"][3], main, [feed], [cost],
               models["adam_only"][4])
    order = ["plain", "recompute", "adam_only"]
    turns = {k: [] for k in order}
    for i in range(RECIPE_TURNS):
        for key in order[i % 3:] + order[:i % 3]:
            main, _, cost, exe, scope = models[key]
            _, ms = _run_steps(exe, main, [feed], [cost], scope)
            turns[key] += ms
    med = {k: statistics.median(v) for k, v in turns.items()}
    out["in_turns"] = {
        "step_ms": turns, "median_ms": med,
        "ratio_recompute_over_plain": med["recompute"] / med["plain"],
        "ratio_plain_over_adam_only": med["plain"] / med["adam_only"],
        "ops": {"adam_only": len(models["adam_only"][0].global_block().ops),
                "plain": out["plain"]["ops"],
                "recompute": out["recompute"]["ops"]}}
    log("  recipe in turns " + json.dumps(out["in_turns"]))
    return out


def _recipe_check(torch, fluid):
    """Part 2: the recipe at 2+2 layers, full width, dropout 0, batch 2,
    with recompute and without: one step on the card and on the CPU
    from the same state, held as train check (the loss within 1e-5
    relative; each gradient the optimizer gets, clipped and decayed,
    within 1e-3 of its max; the raw gradients reported beside them);
    then RECIPE_CHECK_STEPS steps on the card with recompute on and off:
    losses within RECIPE_RC_RTOL, step-1 gradients within
    RECIPE_RC_GRAD_TOL of their max."""
    import numpy as np

    kw = dict(TRANSFORMER_BASE, n_layers=2, dropout=0.0)
    feed = copy_task_batch(2, kw)
    per_step = {
        True: {"layer_norm_f32": 20, "flash_fwd_f32": 12,
               "flash_bwd_dkdv_f32": 6, "flash_bwd_dq_f32": 6,
               "flash_delta": 6},
        False: {"layer_norm_f32": 10, "flash_fwd_f32": 6,
                "flash_bwd_dkdv_f32": 6, "flash_bwd_dq_f32": 6,
                "flash_delta": 6}}
    start, out, runs, grads = None, {}, {}, {}
    for recompute in (True, False):
        key = "recompute" if recompute else "plain"
        main, startup, cost, pg, lr = build_recipe(kw, recompute)
        if start is None:
            cpu0 = fluid.Scope()
            fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu0)
            start = fluid.Scope()
            for n in cpu0.var_names():
                start.set_var(n, cpu0.find_var(n).cuda())
        fetch = ([cost] + [g for _, g in pg]
                 + [p.name + "@GRAD" for p, _ in pg])
        (card,), launches = _held_window(lambda: _run_steps(
            _card_executor(fluid), main, [feed], fetch,
            _scope_copy(fluid, start))[0])
        if launches != per_step[recompute]:
            raise RuntimeError(f"2+2 recipe step, recompute={recompute}: "
                               f"launches {launches}, want "
                               f"{per_step[recompute]}")
        (cpu,), _ = _run_steps(fluid.Executor(fluid.CPUPlace()), main,
                               [feed], fetch, _cpu_scope(fluid, start))
        lc, lp = float(card[0][0]), float(cpu[0][0])
        if not np.isfinite(lc) or abs(lc - lp) > 1e-5 * abs(lp):
            raise RuntimeError(f"recipe loss card {lc} vs cpu {lp}")
        n = len(pg)
        out[key] = {
            "loss_card": lc, "loss_cpu": lp, "grads": n,
            "optimizer_grads_card_vs_cpu": _worst_grad(
                pg, card[1:1 + n], cpu[1:1 + n], 1e-3, "card vs cpu"),
            "raw_grads_card_vs_cpu": _worst_grad(
                pg, card[1 + n:], cpu[1 + n:], 1e-3, "raw, card vs cpu"),
            "launches_per_step": launches}
        scope = _scope_copy(fluid, start)
        steps, _ = _run_steps(
            _card_executor(fluid), main, [feed] * RECIPE_CHECK_STEPS,
            [cost] + [g for _, g in pg], scope)
        runs[recompute] = [float(st[0][0]) for st in steps]
        grads[recompute] = steps[0][1:]
    rc_err = _rel_err(runs[True], runs[False])
    if rc_err > RECIPE_RC_RTOL:
        raise RuntimeError(f"recompute vs plain losses on the card differ by"
                           f" {rc_err} relative: {runs}")
    out.update({
        "recompute_losses": runs[True], "plain_losses": runs[False],
        "recompute_vs_plain_max_rel_err": rc_err,
        "recompute_vs_plain_bitwise": runs[True] == runs[False],
        "recompute_vs_plain_step1_grads": _worst_grad(
            pg, grads[True], grads[False], RECIPE_RC_GRAD_TOL,
            "recompute vs plain")})
    log("  recipe check " + json.dumps(out))
    return out


def _worst_grad(pg, got, want, tol, what):
    """The largest max|got - want| / max|want| over the gradients (and its
    parameter), raising past ``tol``; whether every one is bitwise."""
    import numpy as np

    worst, name = 0.0, None
    for (p, _), a, b in zip(pg, got, want):
        scale = float(np.abs(b).max())
        ratio = (float(np.abs(a - b).max()) / scale if scale
                 else float(np.abs(a).max()))
        if not np.isfinite(a).all() or ratio > tol:
            raise RuntimeError(f"gradient of {p.name}, {what}: max abs diff "
                               f"/ max abs {ratio:.3g} > {tol}")
        if ratio >= worst:
            worst, name = ratio, p.name
    return {"worst_rel_err": worst, "param": name,
            "bitwise": all(np.array_equal(a, b) for a, b in zip(got, want))}


def _fit_a_line_program(fluid, layers, unique_name, optimizer, kw,
                        average=False):
    """fit_a_line's program, its weight at ParamAttr(learning_rate=0.5);
    with ``average``, ModelAverage over it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(
            name="fit.w", learning_rate=0.5), bias_attr="fit.b")
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        getattr(fluid.optimizer, optimizer)(learning_rate=FIT_LR,
                                            **kw).minimize(cost)
        avg = (fluid.optimizer.ModelAverage(0.5, min_average_window=2,
                                            max_average_window=10)
               if average else None)
    return main, startup, cost, avg


def _recipe_optimizers(torch, fluid):
    """Part 3: each optimizer, three steps of fit_a_line's program on the
    card and on the CPU from the same state (the weight at a per-parameter
    rate of 0.5): every parameter within RECIPE_OPT_RTOL of its max; then
    ModelAverage's apply() and restore() on the card."""
    import numpy as np

    import paddle_tpu_torch
    from paddle_tpu_torch.fluid import layers, unique_name

    batches = list(paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.uci_housing.train(),
        batch_size=FIT_BATCH)())[:RECIPE_CHECK_STEPS]
    feeds = [{"x": np.array([r[0] for r in b], np.float32),
              "y": np.array([r[1] for r in b], np.float32).reshape(-1, 1)}
             for b in batches]
    out = {}
    for name, kw in list(RECIPE_OPTIMIZERS.items()) + [("ModelAverage",
                                                       None)]:
        main, startup, cost, avg = _fit_a_line_program(
            fluid, layers, unique_name, "SGD" if kw is None else name,
            kw or {}, average=kw is None)
        exe, scope = _card_executor(fluid), fluid.Scope()
        exe.run(startup, scope=scope)
        cpu_scope = _cpu_scope(fluid, scope)
        (card, _), _ = _held_window(lambda: _run_steps(
            exe, main, feeds, [cost], scope))
        _run_steps(fluid.Executor(fluid.CPUPlace()), main, feeds,
                      [cost], cpu_scope)
        errs = {}
        for n in ("fit.w", "fit.b"):
            a, b = scope.find_var(n).cpu(), cpu_scope.find_var(n)
            errs[n] = float((a - b).abs().max() / b.abs().max())
            if not errs[n] <= RECIPE_OPT_RTOL:
                raise RuntimeError(f"{name}: {n} card vs CPU differ by "
                                   f"{errs[n]} of its max")
        row = {"param_max_rel_err": errs,
               "losses": [float(s[0][0]) for s in card]}
        if avg is not None:
            live = {n: scope.find_var(n).clone() for n in ("fit.w", "fit.b")}
            with fluid.scope_guard(cpu_scope):
                with avg.apply(fluid.Executor(fluid.CPUPlace())):
                    cpu_avg = cpu_scope.find_var("fit.w").clone()
            with fluid.scope_guard(scope), avg.apply(exe):
                card_avg = scope.find_var("fit.w").cpu()
            err = float((card_avg - cpu_avg).abs().max()
                        / cpu_avg.abs().max())
            if err > RECIPE_OPT_RTOL or torch.equal(card_avg,
                                                     live["fit.w"].cpu()):
                raise RuntimeError(f"ModelAverage.apply on the card: "
                                   f"{err} vs CPU, or no average")
            for n, v in live.items():
                if not torch.equal(scope.find_var(n), v):
                    raise RuntimeError(f"ModelAverage.restore: {n} is not "
                                       "bitwise the live value")
            row.update(averaged_max_rel_err_vs_cpu=err,
                       restored_bitwise=True)
        out[name] = row
    log("  recipe optimizers " + json.dumps(out))
    return out


def _recipe_resume(torch, fluid):
    """Part 4: the 2+2 recipe at dropout 0: three steps, save_checkpoint,
    a fresh scope, load_checkpoint, two more steps; losses, rates and
    every persistable bitwise the uninterrupted five steps."""
    import shutil
    import tempfile

    import numpy as np

    kw = dict(TRANSFORMER_BASE, n_layers=2, dropout=0.0)
    feeds = [copy_task_batch(2, kw)] * RECIPE_STEPS
    main, startup, cost, _, lr = build_recipe(kw, True)
    exe, start = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=start)
    straight_scope = _scope_copy(fluid, start)
    straight, _ = _run_steps(exe, main, feeds, [cost, lr], straight_scope)
    first = _scope_copy(fluid, start)
    resumed, _ = _run_steps(exe, main, feeds[:RECIPE_RESUME_AT],
                               [cost, lr], first)
    d = tempfile.mkdtemp(prefix="recipe_ck_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = fluid.io.save_checkpoint(d, main, step=RECIPE_RESUME_AT,
                                        scope=first)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        del first
        second = fluid.Scope()
        t0 = time.perf_counter()
        step = fluid.io.load_checkpoint(d, main, scope=second)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if step != RECIPE_RESUME_AT:
        raise RuntimeError(f"load_checkpoint gave step {step}")
    more, _ = _run_steps(exe, main, feeds[RECIPE_RESUME_AT:], [cost, lr],
                            second)
    resumed += more
    for i, (a, b) in enumerate(zip(straight, resumed)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"resumed step {i + 1} differs: {a} vs {b}")
    names = [n for n, v in main.global_block().vars.items()
             if v.persistable and straight_scope.find_var(n) is not None]
    differ = [n for n in names
              if not torch.equal(straight_scope.find_var(n),
                                 second.find_var(n))]
    if differ:
        raise RuntimeError(f"resumed state differs in {differ[:5]}")
    out = {"steps": RECIPE_STEPS, "saved_at": RECIPE_RESUME_AT,
           "losses": [float(s[0][0]) for s in straight],
           "rates": [float(s[1].reshape(-1)[0]) for s in straight],
           "persistables_bitwise": len(names), "bytes": nbytes,
           "save_s": save_s, "load_s": load_s}
    log("  recipe resume " + json.dumps(out))
    return out


def train_recipe_phase(torch):
    """Transformer-base (TRANSFORMER_BASE, batch TRAIN_BATCH) trained
    with noam_decay, global-norm clipping, L2 decay and Adam, with and
    without recompute; the recipe card vs CPU; fit_a_line under every
    optimizer and ModelAverage; a resume from save_checkpoint."""
    phase("train recipe")
    import paddle_tpu_torch.fluid as fluid

    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)
    out = {"config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 "
                     "len512 dropout0.1 batch16, Adam(noam_decay(512, "
                     "4000)), GradientClipByGlobalNorm(1.0), L2Decay(1e-4)"}
    out["timing"] = _recipe_timing(torch, fluid, feed)
    out["check"] = _recipe_check(torch, fluid)
    out["optimizers"] = _recipe_optimizers(torch, fluid)
    out["resume"] = _recipe_resume(torch, fluid)
    return out


# text book: the book's four text chapters and a CTC program, each
# trained TEXT_STEPS steps from its dataset through DataFeeder, then
# TEXT_CHECK_STEPS steps at batch TEXT_CHECK_BATCH card vs CPU from the
# trained state (losses within LSTM_LOSS_RTOL; the Viterbi path and the
# CTC edit distances equal up to near ties under MARGIN_REL)
TEXT_STEPS, TEXT_CHECK_STEPS, TEXT_CHECK_BATCH = 5, 2, 4
# label semantic roles at the reference chapter's widths in the repo's
# program (tests/test_book_more.py:206): its LSTMs take fc(hidden * 4);
# 4 of the chapter's 8 stacked LSTMs (depth cut for the time limit)
SRL = dict(word_dim=32, mark_dim=5, hidden=512, depth=4, lr=1e-2)
SRL_BATCH = 10
W2V = dict(emb=32, hidden=256, n=5, lr=5e-3)    # reference chapter's widths
SENTIMENT = dict(emb=32, hid=32, lr=2e-3)
RECOMMENDER = dict(combined=200, lr=0.2)        # the book chapter's towers
TEXT_BATCH = 32
# an OCR line recogniser's shape: [32, 100, 512] column features into 95
# symbols and the blank 0, labels of 1-24 symbols
CTC = dict(feat=512, classes=96, lr=1e-3)
CTC_T, CTC_LABELS = 100, (1, 25)


def port_pkg():
    """The port's modules, as the chapter build functions take them."""
    import types

    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, nets, unique_name

    return types.SimpleNamespace(paddle=paddle_tpu_torch, fluid=fluid,
                                 layers=layers, nets=nets,
                                 unique_name=unique_name)


def _chapter(pkg, seed, body):
    """main, startup and the test clone (taken before ``minimize``) of
    the program ``body(layers)`` builds; body returns (cost, feed vars,
    extras, optimizer)."""
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        cost, feeds, extra, opt = body(pkg.layers)
        test = main.clone(for_test=True)
        opt.minimize(cost)
    return dict(main=main, startup=startup, test=test, cost=cost,
                feeds=feeds, **extra)


def build_word2vec(pkg, emb, hidden, n, lr):
    """tests/test_book.py:76: N-1 words through one shared embedding
    (``shared_w``), concat, fc(hidden, sigmoid), fc over the imikolov
    dictionary, softmax cross-entropy, Adam(lr). Dense embeddings."""
    dict_size = len(pkg.paddle.dataset.imikolov.build_dict())

    def body(layers):
        words = [layers.data(name=f"word_{i}", shape=[1], dtype="int64")
                 for i in range(n - 1)]
        nxt = layers.data(name="next_word", shape=[1], dtype="int64")
        embeds = [layers.embedding(
            input=w, size=[dict_size, emb],
            param_attr=pkg.fluid.ParamAttr(name="shared_w")) for w in words]
        h = layers.fc(input=layers.concat(input=embeds, axis=1),
                      size=hidden, act="sigmoid")
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=layers.fc(input=h, size=dict_size), label=nxt))
        return (cost, words + [nxt], {"shared": "shared_w"},
                pkg.fluid.optimizer.Adam(learning_rate=lr))

    return _chapter(pkg, 13, body)


def build_sentiment_conv(pkg, emb, hid, lr):
    """tests/test_book.py:124: imdb words, an embedding, two
    sequence_conv_pools (filter 3 and 4, tanh, sqrt pool), fc over 2
    classes, Adam(lr)."""
    dict_dim = len(pkg.paddle.dataset.imdb.word_dict())

    def body(layers):
        data = layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        e = layers.embedding(input=data, size=[dict_dim, emb])
        convs = [pkg.nets.sequence_conv_pool(
            input=e, num_filters=hid, filter_size=k, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
        logits = layers.fc(input=layers.concat(input=convs, axis=1), size=2)
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        return (cost, [data, label], {},
                pkg.fluid.optimizer.Adam(learning_rate=lr))

    return _chapter(pkg, 17, body)


def build_recommender(pkg, combined, lr):
    """tests/test_book_more.py:122: the user tower (id 32, gender, age,
    job 16 each, fc(combined, tanh)) and the movie tower (id 32, the
    category embeddings' sum pool, the title's sequence_conv_pool, fc(
    combined, tanh)) joined by cos_sim, scaled by 5, square error on the
    score, SGD(lr)."""
    ml = pkg.paddle.dataset.movielens

    def body(layers):
        def tower_id(name, size, width, table):
            v = layers.data(name=name, shape=[1], dtype="int64")
            e = layers.embedding(input=v, size=[size, width],
                                 param_attr=pkg.fluid.ParamAttr(name=table))
            return v, layers.fc(input=e, size=width)

        def seq(name):
            return layers.data(name=name, shape=[1], dtype="int64",
                               lod_level=1)

        uid, usr_fc = tower_id("user_id", ml.max_user_id() + 1, 32,
                               "user_table")
        gender, gender_fc = tower_id("gender_id", 2, 16, "gender_table")
        age, age_fc = tower_id("age_id", len(ml.age_table()), 16,
                               "age_table")
        job, job_fc = tower_id("job_id", ml.max_job_id() + 1, 16,
                               "job_table")
        usr = layers.fc(input=layers.concat(
            input=[usr_fc, gender_fc, age_fc, job_fc], axis=1),
            size=combined, act="tanh")
        mov_id, mov_fc = tower_id("movie_id", ml.max_movie_id() + 1, 32,
                                  "movie_table")
        category, title = seq("category_id"), seq("movie_title")
        cat_pool = layers.sequence_pool(input=layers.embedding(
            input=category, size=[len(ml.movie_categories()), 32]),
            pool_type="sum")
        title_conv = pkg.nets.sequence_conv_pool(
            input=layers.embedding(input=title, size=[
                len(ml.get_movie_title_dict()), 32]),
            num_filters=32, filter_size=3, act="tanh", pool_type="sum")
        mov = layers.fc(input=layers.concat(
            input=[mov_fc, cat_pool, title_conv], axis=1), size=combined,
            act="tanh")
        score = layers.data(name="score", shape=[1], dtype="float32")
        cost = layers.mean(layers.square_error_cost(
            input=layers.scale(x=layers.cos_sim(X=usr, Y=mov), scale=5.0),
            label=score))
        return (cost, [uid, gender, age, job, mov_id, category, title,
                       score], {}, pkg.fluid.optimizer.SGD(learning_rate=lr))

    return _chapter(pkg, 47, body)


SRL_SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data")


def build_srl(pkg, word_dim, mark_dim, hidden, depth, lr):
    """tests/test_book_more.py:206: 8 feature slots (the six word slots
    share the embedding ``emb``) summed through fcs into ``depth`` stacked
    dynamic_lstms of H ``hidden`` (alternating is_reverse), a
    linear_chain_crf over conll05's labels (transition ``crfw``), SGD(lr);
    crf_decoding reads ``crfw``."""
    c5 = pkg.paddle.dataset.conll05

    def body(layers):
        def seq(name):
            return layers.data(name=name, shape=[1], dtype="int64",
                               lod_level=1)

        def fc(x, size):
            return layers.fc(input=x, size=size, num_flatten_dims=2)

        word_slots = [seq(s) for s in SRL_SLOTS]
        predicate, mark, target = (seq("verb_data"), seq("mark_data"),
                                   seq("target"))
        embs = [layers.embedding(input=w, size=[c5.WORD_DICT_LEN, word_dim],
                                 param_attr=pkg.fluid.ParamAttr(name="emb"))
                for w in word_slots]
        embs.append(layers.embedding(input=predicate,
                                     size=[c5.PRED_DICT_LEN, word_dim]))
        embs.append(layers.embedding(input=mark, size=[2, mark_dim]))
        mix = layers.sums(input=[fc(e, hidden) for e in embs])
        lstm, _ = layers.dynamic_lstm(input=fc(mix, hidden * 4),
                                      size=hidden * 4)
        for i in range(1, depth):
            mix = layers.sums(input=[fc(mix, hidden), fc(lstm, hidden)])
            lstm, _ = layers.dynamic_lstm(input=fc(mix, hidden * 4),
                                          size=hidden * 4,
                                          is_reverse=(i % 2 == 1))
        feature = layers.sums(input=[fc(mix, c5.LABEL_DICT_LEN),
                                     fc(lstm, c5.LABEL_DICT_LEN)])
        cost = layers.mean(layers.linear_chain_crf(
            input=feature, label=target,
            param_attr=pkg.fluid.ParamAttr(name="crfw")))
        decode = layers.crf_decoding(
            input=feature, param_attr=pkg.fluid.ParamAttr(name="crfw"))
        return (cost, word_slots + [predicate, mark, target],
                {"shared": "emb", "decode": decode, "emission": feature,
                 "transition": "crfw"},
                pkg.fluid.optimizer.SGD(learning_rate=lr))

    return _chapter(pkg, 53, body)


def build_ctc(pkg, feat, classes, lr):
    """fc over a [N, T, feat] sequence into ``classes`` (blank 0), the
    warpctc loss, SGD(lr); ctc_greedy_decoder and edit_distance against
    the labels (their 0 padding ignored)."""
    def body(layers):
        x = layers.data(name="feat", shape=[feat], dtype="float32",
                        lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64",
                            lod_level=1)
        logits = layers.fc(input=x, size=classes, num_flatten_dims=2)
        cost = layers.mean(layers.warpctc(input=logits, label=label,
                                          blank=0))
        dist, _ = layers.edit_distance(
            input=layers.ctc_greedy_decoder(input=logits, blank=0),
            label=label, ignored_tokens=[0])
        return (cost, [x, label], {"decode": dist, "logits": logits},
                pkg.fluid.optimizer.SGD(learning_rate=lr))

    return _chapter(pkg, 61, body)


def ctc_samples(seed, n, t_range, l_range, feat, classes):
    """Seeded (features [T, feat], labels [[l], ...]) pairs: each label a
    run of symbols 1..classes-1 that the frames hint at, T drawn from
    ``t_range`` and the label's length from ``l_range``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    proj = rng.randn(classes, feat).astype(np.float32)
    out = []
    for _ in range(n):
        T = int(rng.randint(*t_range))
        lab = rng.randint(1, classes, int(rng.randint(*l_range)))
        frames = np.repeat(lab, int(np.ceil(T / len(lab))))[:T]
        x = proj[frames] + rng.randn(T, feat).astype(np.float32)
        out.append((x.astype(np.float32), [[int(v)] for v in lab]))
    return out


def ctc_feed(samples, T):
    """A feed dict of ``samples`` padded to exactly T frames."""
    import numpy as np

    feat = np.zeros((len(samples), T, samples[0][0].shape[1]), np.float32)
    L = max(len(s[1]) for s in samples)
    label = np.zeros((len(samples), L, 1), np.int64)
    for i, (x, lab) in enumerate(samples):
        feat[i, :len(x)] = x
        label[i, :len(lab)] = lab
    return {"feat": feat,
            "feat@LEN": np.array([len(s[0]) for s in samples], np.int32),
            "label": label,
            "label@LEN": np.array([len(s[1]) for s in samples], np.int32)}


def _seq_tokens(feed, keys):
    """Real tokens of a feed: the sum of the @LEN companions ``keys``;
    with none (word2vec), one token an id slot."""
    import numpy as np

    if keys:
        return sum(int(np.asarray(feed[k]).sum()) for k in keys)
    return sum(int(np.prod(v.shape)) for v in feed.values())


def _viterbi_score(em, trans, path):
    """The CRF score of ``path`` [T] over em [T, D], transition [D+2, D]."""
    s = trans[0, path[0]] + em[0, path[0]] + trans[1, path[-1]]
    for t in range(1, len(path)):
        s += trans[2 + path[t - 1], path[t]] + em[t, path[t]]
    return float(s)


def _hold_viterbi(card, cpu, lengths):
    """Card vs CPU Viterbi paths: equal, or the card's path scores within
    MARGIN_REL x |best| of the CPU's best under the CPU's emission and
    transition (a near tie, logged)."""
    import numpy as np

    (c_path,), (p_path, em, trans) = card, cpu
    trans = trans.astype(np.float64)
    ties = []
    for i, ln in enumerate(np.asarray(lengths)):
        a, b = c_path[i, :ln], p_path[i, :ln]
        if np.array_equal(a, b) and not c_path[i, ln:].any():
            continue
        best = _viterbi_score(em[i].astype(np.float64), trans, b)
        alt = _viterbi_score(em[i].astype(np.float64), trans, a)
        gap = best - alt
        if not 0 <= gap <= MARGIN_REL * abs(best):
            raise RuntimeError(f"viterbi row {i}: card path {a.tolist()} "
                               f"vs CPU {b.tolist()}, score gap {gap}: not "
                               "a near tie")
        ties.append({"row": i, "score_gap": gap})
    return {"rows_compared": len(c_path), "near_ties": ties}


def _hold_ctc_decode(card, cpu, lengths):
    """Card vs CPU edit distances: equal on every row whose frames' argmax
    agree; where a frame's argmax differs, the CPU's top-two logit gap
    there must be within MARGIN_REL x max|logit| (a near tie, logged)."""
    import numpy as np

    (c_dist, c_logits), (p_dist, p_logits) = card, cpu
    tol = MARGIN_REL * float(np.abs(p_logits).max())
    ties = []
    for i, ln in enumerate(np.asarray(lengths)):
        flips = np.nonzero(c_logits[i, :ln].argmax(-1)
                           != p_logits[i, :ln].argmax(-1))[0]
        if len(flips) == 0:
            if c_dist[i, 0] != p_dist[i, 0]:
                raise RuntimeError(f"ctc row {i}: edit distance "
                                   f"{c_dist[i, 0]} vs {p_dist[i, 0]} with "
                                   "the same frame argmax")
            continue
        top2 = np.sort(p_logits[i, flips], axis=-1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).max())
        if gap > tol:
            raise RuntimeError(f"ctc row {i}: frame argmax differs at "
                               f"{flips.tolist()} with a logit gap {gap} "
                               f"(> {tol})")
        ties.append({"row": i, "frames": flips.tolist(), "gap": gap})
    return {"rows_compared": len(c_dist), "near_ties": ties, "tol": tol}


def _text_chapter(torch, name, built, feeds, check_feeds, config,
                  token_keys):
    """One chapter on the card: TEXT_STEPS steps in the held window
    (p50 of steps 2-5, real tokens/s over ``token_keys``, peak memory),
    one profiled step,
    then TEXT_CHECK_STEPS small-batch steps from the trained state on
    the card and on the CPU (losses within LSTM_LOSS_RTOL), and the test
    program's decode (Viterbi path or CTC edit distances) on both."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    main, cost = built["main"], built["cost"]
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(built["startup"], scope=scope)
    torch.cuda.reset_peak_memory_stats()
    (losses, ms), launches = _held_window(
        lambda: _timed_steps(exe, main, feeds[:TEXT_STEPS], [cost], scope))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: losses not finite: {losses}")
    p50 = statistics.median(ms[1:])
    tokens = [_seq_tokens(f, token_keys) for f in feeds[:TEXT_STEPS]]
    batch = len(next(iter(feeds[0].values())))
    out = {"config": config, "steps": TEXT_STEPS, "losses": losses,
           "step_ms": ms, "p50_step_ms_after_first": p50,
           "tokens": list(token_keys) or "one an id slot",
           "tokens_a_step": tokens,
           "tokens_per_s": statistics.mean(tokens[1:]) / (p50 / 1e3),
           "samples_per_s": batch / (p50 / 1e3),
           "peak_memory_allocated_gb": peak_gb, "kernel_launches": launches}
    prof = _profiled(torch, exe, main, feeds[TEXT_STEPS], cost, scope,
                     f"{name} step")
    out["device_launches_a_step"] = prof["device_launches"]
    out["busy_share"] = prof["busy_share"]
    out["profile"] = prof

    # card vs CPU from the trained state, at a small batch
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = _cpu_scope(fluid, scope)
    card_l, _ = _timed_steps(exe, main, check_feeds[:-1], [cost], scope)
    cpu_l, _ = _timed_steps(cpu_exe, main, check_feeds[:-1], [cost],
                            cpu_scope)
    err = _rel_err(card_l, cpu_l)
    if err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"{name}: card vs CPU losses {card_l} vs "
                           f"{cpu_l} ({err} relative)")
    out["check"] = {"batch": TEXT_CHECK_BATCH, "card_losses": card_l,
                    "cpu_losses": cpu_l, "max_rel_err": err}
    if "decode" in built:
        feed, test = check_feeds[-1], built["test"]
        if "transition" in built:  # the Viterbi path
            fetch = [built["decode"], built["emission"], built["transition"]]
            lens = feed[SRL_SLOTS[0] + "@LEN"]
            hold, card_fetch = _hold_viterbi, fetch[:1]
        else:  # the CTC edit distances
            fetch = [built["decode"], built["logits"]]
            lens = feed["feat@LEN"]
            hold, card_fetch = _hold_ctc_decode, fetch
        card = exe.run(test, feed=feed, fetch_list=card_fetch, scope=scope)
        cpu = cpu_exe.run(test, feed=feed, fetch_list=fetch, scope=cpu_scope)
        out["check"]["decode"] = hold([np.asarray(v) for v in card],
                                      [np.asarray(v) for v in cpu], lens)
        out["check"]["decoded"] = np.asarray(card[0]).reshape(
            len(lens), -1)[:, :8].tolist()
    out["seconds"] = time.perf_counter() - t0
    log(f"  text book {name} " + json.dumps(out))
    return out


def _reader_feeds(fluid, built, reader, n):
    """The first ``n`` batches of ``reader`` through a DataFeeder onto
    the card."""
    feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0),
                              feed_list=built["feeds"],
                              program=built["main"])
    feeds = []
    for data in reader():
        feeds.append(feeder.feed(data))
        if len(feeds) == n:
            return feeds
    raise RuntimeError(f"reader gave {len(feeds)} batches, want {n}")


def text_book_phase(torch):
    """The book's text chapters on the card at their widths: label
    semantic roles (SRL, batch SRL_BATCH), word2vec (W2V), sentiment conv
    (SENTIMENT) and the recommender system (RECOMMENDER), each fed by its
    dataset through DataFeeder, and the CTC program (CTC) on seeded
    [32, 100, 512] batches; see _text_chapter for what each holds."""
    phase("text book")
    import paddle_tpu_torch.fluid as fluid

    pkg = port_pkg()
    ds, batch = pkg.paddle.dataset, pkg.paddle.batch
    n, k = TEXT_STEPS + 1, TEXT_CHECK_STEPS + 1
    w2v_dict = ds.imikolov.build_dict()
    out = {}
    for name, built, reader, check_reader, config, token_keys in (
            ("srl", build_srl(pkg, **SRL),
             batch(ds.conll05.train(), SRL_BATCH),
             batch(ds.conll05.test(), TEXT_CHECK_BATCH),
             f"label semantic roles: conll05, {SRL} (LSTM H = hidden), "
             f"CRF over 67 labels, batch {SRL_BATCH}",
             [SRL_SLOTS[0] + "@LEN"]),
            ("word2vec", build_word2vec(pkg, **W2V),
             batch(ds.imikolov.train(w2v_dict, W2V["n"]), TEXT_BATCH),
             batch(ds.imikolov.test(w2v_dict, W2V["n"]), TEXT_CHECK_BATCH),
             f"word2vec: imikolov dict {len(w2v_dict)}, {W2V}, Adam, "
             f"batch {TEXT_BATCH}", []),
            ("sentiment_conv", build_sentiment_conv(pkg, **SENTIMENT),
             batch(ds.imdb.train(), TEXT_BATCH),
             batch(ds.imdb.test(), TEXT_CHECK_BATCH),
             f"sentiment conv: imdb, two sequence_conv_pool (filter 3, 4; "
             f"sqrt), {SENTIMENT}, Adam, batch {TEXT_BATCH}",
             ["words@LEN"]),
            ("recommender", build_recommender(pkg, **RECOMMENDER),
             batch(ds.movielens.train(), TEXT_BATCH),
             batch(ds.movielens.test(), TEXT_CHECK_BATCH),
             f"recommender: movielens towers joined by cos_sim, "
             f"{RECOMMENDER}, SGD, batch {TEXT_BATCH}",
             ["category_id@LEN", "movie_title@LEN"])):
        out[name] = _text_chapter(
            torch, name, built, _reader_feeds(fluid, built, reader, n),
            _reader_feeds(fluid, built, check_reader, k), config,
            token_keys)
    samples = ctc_samples(2031, TEXT_BATCH * n + TEXT_CHECK_BATCH * k,
                          (CTC_T * 3 // 5, CTC_T + 1), CTC_LABELS,
                          CTC["feat"], CTC["classes"])
    feeds = [ctc_feed(samples[i * TEXT_BATCH:(i + 1) * TEXT_BATCH], CTC_T)
             for i in range(n)]
    rest = samples[TEXT_BATCH * n:]
    check = [ctc_feed(rest[i * TEXT_CHECK_BATCH:(i + 1) * TEXT_CHECK_BATCH],
                      CTC_T) for i in range(k)]
    out["ctc"] = _text_chapter(
        torch, "ctc", build_ctc(pkg, **CTC), feeds, check,
        f"ctc: fc over [{TEXT_BATCH}, {CTC_T}, {CTC['feat']}] into "
        f"{CTC['classes']} classes (blank 0), labels of {CTC_LABELS[0]}-"
        f"{CTC_LABELS[1] - 1} symbols, warpctc, SGD({CTC['lr']}); "
        "ctc_greedy_decoder + edit_distance", ["feat@LEN"])
    log("  text book " + json.dumps({
        key: {m: v[m] for m in ("p50_step_ms_after_first", "tokens_per_s",
                                "device_launches_a_step", "busy_share",
                                "peak_memory_allocated_gb", "seconds")}
        for key, v in out.items()}))
    return out


# vision: the legacy benchmark suite's image models at the reference's
# published configurations (BASELINE.md:9-12, from its
# benchmark/README.md:33-61: batch 128; AlexNet and GoogLeNet at 224x224
# into 1000 classes, SmallNet at 32x32 into 10), Momentum(0.01, 0.9) as
# tests/test_models.py trains them; VISION_STEPS steps on seeded images,
# then the test-mode logits card vs CPU at VISION_CHECK_BATCH
VISION_MODELS = {"alexnet": (224, 1000), "googlenet": (224, 1000),
                 "smallnet": (32, 10)}
VISION_BATCH, VISION_STEPS, VISION_CHECK_BATCH = 128, 5, 2
VISION_LOGIT_TOL = 1e-4   # card vs CPU logits, of the largest |logit|
# SSD300 (Liu et al. 2016, Fig. 2 and Sec. 3: VGG-16 through conv5_3,
# pool5 3x3/1, conv6 3x3 dilation 6 and conv7 1x1 at 1024, the extras
# conv8-conv11; maps 38, 19, 10, 5, 3, 1; conv4_3 L2-normalized with a
# learned scale from 20), VOC's 21 classes, 8 seeded boxes an image,
# Momentum(1e-3, 0.9); detection_output at nms 0.45, top 400, keep 200
SSD = dict(size=300, classes=21, gt=8, batch=8, lr=1e-3)
SSD_PRIORS = 8732
SSD_CHECK_BATCH, SSD_CHECK_STEPS = 2, 2
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200)
# card vs CPU of each new op on the same inputs: float outputs within
# VISION_OP_TOL of the tensor's largest |value| (cuDNN and the CPU's
# convolutions sum in other orders), input gradients within
# LSTM_GRAD_TOL of theirs; index outputs (Mask, Argmax, matches, the
# NMS rows' labels, mined indices) exactly equal
VISION_OP_TOL = 1e-4
# detections card vs CPU: labels equal row by row and boxes within
# DET_BOX_TOL (normalised coordinates) up to the first row where the
# two differ; there the scores must agree within MARGIN_REL x the
# largest score (a near tie reordered), and that image's later rows are
# not compared
DET_BOX_TOL = 1e-4
# the device the vision phase's feeds and op cases go to (a CPU
# rehearsal sets "cpu")
CARD = "cuda"


def _vision_image_model(pkg, name, hw, classes):
    from paddle_tpu_torch.models import alexnet, googlenet, smallnet

    model = {"alexnet": alexnet, "googlenet": googlenet,
             "smallnet": smallnet}[name]

    def body(layers):
        img = layers.data(name="img", shape=[3, hw, hw], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, _, _ = model.build_train(img, label, class_dim=classes)
        return cost, [img, label], {}, pkg.fluid.optimizer.Momentum(
            learning_rate=0.01, momentum=0.9)

    return _chapter(pkg, 2031, body)


def _vision_feed(torch, rng, batch, hw, classes, device):
    """Seeded images and labels, as tensors on ``device``."""
    return {"img": torch.from_numpy(rng.randn(batch, 3, hw, hw).astype(
                "float32")).to(device),
            "label": torch.from_numpy(rng.randint(
                0, classes, (batch, 1)).astype("int64")).to(device)}


def _train_window(torch, exe, main, feeds, cost, scope, batch):
    """The held window over ``feeds``: losses finite, p50 of steps 2-5,
    images/s and peak memory."""
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    (losses, ms), launches = _held_window(
        lambda: _timed_steps(exe, main, feeds, [cost], scope))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite: {losses}")
    p50 = statistics.median(ms[1:])
    return {"losses": losses, "step_ms": ms,
            "p50_step_ms_after_first": p50, "images_per_s": batch / (p50 / 1e3),
            "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kernel_launches": launches}


def _vision_model_run(torch, name):
    """One image model: VISION_STEPS training steps on the card, one
    profiled step, then the test clone's logits on the card and on the
    CPU from the trained state."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    hw, classes = VISION_MODELS[name]
    built = _vision_image_model(port_pkg(), name, hw, classes)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(built["startup"], scope=scope)
    rng = np.random.RandomState(7)
    feeds = [_vision_feed(torch, rng, VISION_BATCH, hw, classes, CARD)
             for _ in range(VISION_STEPS + 1)]
    out = {"config": f"{name}: {hw}x{hw}, {classes} classes, batch "
                     f"{VISION_BATCH}, Momentum(0.01, 0.9)"}
    out.update(_train_window(torch, exe, built["main"], feeds[:-1],
                             built["cost"], scope, VISION_BATCH))
    prof = _profiled(torch, exe, built["main"], feeds[-1], built["cost"],
                     scope, f"vision {name} step")
    out["device_launches_a_step"] = prof["device_launches"]
    out["busy_share"] = prof["busy_share"]
    out["profile"] = prof
    check = _vision_feed(torch, rng, VISION_CHECK_BATCH, hw, classes, "cpu")
    logits = logits_var(built["test"])
    card = np.asarray(exe.run(built["test"], feed=check, fetch_list=[logits],
                              scope=scope)[0])
    cpu = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        built["test"], feed=check, fetch_list=[logits],
        scope=_cpu_scope(fluid, scope))[0])
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    if not err <= VISION_LOGIT_TOL:
        raise RuntimeError(f"{name}: card vs CPU test logits differ by "
                           f"{err} of the max (> {VISION_LOGIT_TOL})")
    out["check"] = {"batch": VISION_CHECK_BATCH, "logits_rel_err": err,
                    "shape": list(card.shape)}
    out["seconds"] = time.perf_counter() - t0
    log(f"  vision {name} " + json.dumps(out))
    return out


def build_ssd300(pkg, seed=2031):
    """SSD300 from the port's fluid layers (see SSD): the training
    program (mean ssd_loss, Momentum); the inference program, a test
    clone of the forward with ``detection_output`` and ``detection_map``
    appended, and the forward's clone alone; the post-processing alone as two programs that take
    their inputs as data (``det``: the heads' outputs to detections,
    ``amap``: detections to mAP)."""
    fluid, layers = pkg.fluid, pkg.layers
    size, classes, g = SSD["size"], SSD["classes"], SSD["gt"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed

    def conv(x, ch, k=3, s=1, p=1, d=1):
        return layers.conv2d(x, num_filters=ch, filter_size=k, stride=s,
                             padding=p, dilation=d, act="relu")

    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, size, size], dtype="float32")
        x = img
        for n, ch in ((2, 64), (2, 128), (3, 256), (3, 512)):
            for _ in range(n):
                x = conv(x, ch)
            if ch == 512:
                conv4_3 = x
            x = layers.pool2d(x, pool_size=2, pool_stride=2,
                              ceil_mode=(ch == 256))      # 75 -> 38
        for _ in range(3):
            x = conv(x, 512)
        x = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1)
        x = conv(x, 1024, p=6, d=6)
        conv7 = conv(x, 1024, k=1, p=0)
        scale = layers.create_parameter(
            [512], "float32", name="conv4_3_norm_scale",
            default_initializer=fluid.initializer.ConstantInitializer(20.0))
        maps = [layers.elementwise_mul(layers.l2_normalize(conv4_3, axis=1),
                                       scale, axis=1), conv7]
        x = conv7
        for mid, ch, s, p in ((256, 512, 2, 1), (128, 256, 2, 1),
                              (128, 256, 1, 0), (128, 256, 1, 0)):
            x = conv(conv(x, mid, k=1, p=0), ch, s=s, p=p)
            maps.append(x)
        loc, conf, box, var = layers.multi_box_head(
            maps, img, base_size=size, num_classes=classes,
            aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2.], [2.]],
            min_ratio=20, max_ratio=90, flip=True, kernel_size=3, pad=1)
        infer = main.clone(for_test=True)
        forward = main.clone(for_test=True)
        gt_box = layers.data(name="gt_box", shape=[g, 4], dtype="float32")
        gt_label = layers.data(name="gt_label", shape=[g], dtype="int64")
        cost = layers.mean(layers.ssd_loss(loc, conf, gt_box, gt_label, box,
                                           var))
        fluid.optimizer.Momentum(learning_rate=SSD["lr"],
                                 momentum=0.9).minimize(cost)
    with pkg.unique_name.guard(), fluid.program_guard(infer, startup):
        gt = layers.data(name="gt", shape=[g, 6], dtype="float32")
        dets = layers.detection_output(loc, conf, box, var, **SSD_NMS)
        m_ap = layers.detection_map(dets, gt, class_num=classes)
    det = fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(det, fluid.Program()):
        d_in = [layers.data(name=n, shape=[SSD_PRIORS, w], dtype="float32",
                            append_batch_size=(n in ("loc", "conf")))
                for n, w in (("loc", 4), ("conf", classes), ("box", 4),
                             ("var", 4))]
        d_out = layers.detection_output(*d_in, **SSD_NMS)
    amap = fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(amap, fluid.Program()):
        m_out = layers.detection_map(
            layers.data(name="dets", shape=[SSD_NMS["keep_top_k"], 6],
                        dtype="float32"),
            layers.data(name="gt", shape=[g, 6], dtype="float32"),
            class_num=classes)
    return dict(main=main, startup=startup, infer=infer, forward=forward,
                cost=cost, loc=loc,
                conf=conf, box=box, var=var, dets=dets, map=m_ap, det=det,
                det_out=d_out, amap=amap, map_out=m_out,
                priors=int(box.shape[0]))


def ssd_feed(torch, rng, batch, device):
    """Seeded images and ground truth: SSD["gt"] boxes an image (sides
    0.05-0.5 of the image), labels 1-20; ``gt`` is the detection_map
    label (label, box, difficult 0)."""
    import numpy as np

    g = SSD["gt"]
    lo = rng.uniform(0.0, 0.5, (batch, g, 2)).astype(np.float32)
    wh = rng.uniform(0.05, 0.5, (batch, g, 2)).astype(np.float32)
    box = np.concatenate([lo, lo + wh], axis=-1)
    label = rng.randint(1, SSD["classes"], (batch, g)).astype(np.int64)
    gt = np.concatenate([label[..., None].astype(np.float32), box,
                         np.zeros((batch, g, 1), np.float32)], axis=-1)
    img = rng.randn(batch, 3, SSD["size"], SSD["size"]).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in (
        ("img", img), ("gt_box", box), ("gt_label", label), ("gt", gt))}


def _hold_detections(card, cpu):
    """Detections [B, K, 6] card against CPU under the margin rule (see
    DET_BOX_TOL). Returns the rows compared, where rows were cut, and
    the largest score and box differences over the rows compared."""
    import numpy as np

    tol = MARGIN_REL * float(np.abs(cpu[..., 1]).max())
    cuts, compared, score_err, box_err = [], 0, 0.0, 0.0
    for b in range(cpu.shape[0]):
        for r in range(cpu.shape[1]):
            gap = float(abs(card[b, r, 1] - cpu[b, r, 1]))
            boxes = float(np.abs(card[b, r, 2:] - cpu[b, r, 2:]).max())
            if card[b, r, 0] == cpu[b, r, 0] and boxes <= DET_BOX_TOL \
                    and gap <= tol:
                compared += 1
                score_err, box_err = max(score_err, gap), max(box_err, boxes)
                continue
            if gap > tol:
                raise RuntimeError(
                    f"detections image {b} row {r}: card {card[b, r]} vs "
                    f"CPU {cpu[b, r]}, scores {gap} apart (> {tol}): not "
                    "a near tie")
            cuts.append({"image": b, "row": r, "score_gap": gap,
                         "card": card[b, r].tolist(),
                         "cpu": cpu[b, r].tolist()})
            break
    return {"rows_compared": compared, "cuts": cuts, "tol": tol,
            "max_score_diff": score_err, "max_box_diff": box_err,
            "kept_rows": int((cpu[..., 0] >= 0).sum())}


def _ssd_post(torch, exe, built, heads, gt, scope):
    """The post-processing alone on the card: detection_output on the
    heads' outputs and detection_map on its detections, each its own
    program, host ms of a second run (it ends in a fetch) and device
    launches of a profiled one; then the same two on the CPU on the same
    inputs. detection_output's softmax and decode (exp) round apart on
    the two devices, so its detections are held under the margin rule;
    detection_map on the card's detections is bitwise the CPU's."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    out, results = {}, {}
    for key, program, fetch in (("detection_output", built["det"],
                                 built["det_out"]),
                                ("detection_map", built["amap"],
                                 built["map_out"])):
        feed = heads if key == "detection_output" else {
            "dets": results["detection_output"], "gt": gt}
        card = np.asarray(exe.run(program, feed=feed, fetch_list=[fetch],
                                  scope=scope)[0])
        t0 = time.perf_counter()  # the second run: the program prepared
        exe.run(program, feed=feed, fetch_list=[fetch], scope=scope)
        out[key + "_ms"] = (time.perf_counter() - t0) * 1e3
        prof = _profiled(torch, exe, program, feed, fetch, scope,
                         f"vision ssd300 {key}")
        out[key + "_launches"] = prof["device_launches"]
        cpu = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
            program, feed=feed, fetch_list=[fetch], scope=fluid.Scope())[0])
        if key == "detection_output":
            out["same_inputs_held"] = _hold_detections(card, cpu)
        elif not np.array_equal(card, cpu):
            raise RuntimeError(f"ssd300 detection_map on the same "
                               f"detections: card {card} vs CPU {cpu}")
        results[key] = card
    out["post_ms"] = out["detection_output_ms"] + out["detection_map_ms"]
    return out, results["detection_output"], results["detection_map"]


def _ssd_run(torch):
    """SSD300 on the card: VISION_STEPS training steps in the held
    window, one profiled step, the inference program (detection_output,
    detection_map) on the trained state, the post-processing alone
    timed and held against the CPU on the same inputs (_ssd_post), then
    from the trained state at SSD_CHECK_BATCH, card vs CPU: the
    inference program's detections under the margin rule (DET_BOX_TOL)
    and its mAP bitwise where no row was cut, then SSD_CHECK_STEPS
    training steps (losses within LSTM_LOSS_RTOL)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    built = build_ssd300(port_pkg())
    if built["priors"] != SSD_PRIORS:
        raise RuntimeError(f"SSD300 has {built['priors']} priors, not "
                           f"{SSD_PRIORS}")
    log(f"  vision ssd300 priors {built['priors']}")
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(built["startup"], scope=scope)
    rng = np.random.RandomState(11)
    batch = SSD["batch"]
    feeds = [ssd_feed(torch, rng, batch, CARD)
             for _ in range(VISION_STEPS + 1)]
    out = {"config": f"SSD300 (VGG-16, 6 maps, {SSD_PRIORS} priors), "
                     f"{SSD['classes']} classes, {SSD['gt']} boxes an "
                     f"image, batch {batch}, Momentum({SSD['lr']}, 0.9); "
                     f"detection_output {SSD_NMS}", "priors": SSD_PRIORS}
    train_feeds = [{k: f[k] for k in ("img", "gt_box", "gt_label")}
                   for f in feeds]
    out.update(_train_window(torch, exe, built["main"], train_feeds[:-1],
                             built["cost"], scope, batch))
    prof = _profiled(torch, exe, built["main"], train_feeds[-1],
                     built["cost"], scope, "vision ssd300 step")
    out["device_launches_a_step"] = prof["device_launches"]
    out["busy_share"] = prof["busy_share"]
    out["profile"] = prof

    # the inference program on the trained state, then its heads'
    # outputs through the post-processing alone, card and CPU
    infer_feed = {"img": feeds[-1]["img"], "gt": feeds[-1]["gt"]}
    fetch = [built[k] for k in ("loc", "conf", "box", "var", "dets", "map")]
    loc, conf, box, var, dets, m_ap = exe.run(built["infer"],
                                              feed=infer_feed, scope=scope,
                                              fetch_list=fetch)
    t1 = time.perf_counter()  # the second run: the program prepared
    exe.run(built["infer"], feed=infer_feed, scope=scope,
            fetch_list=[built["map"]])
    infer_ms = (time.perf_counter() - t1) * 1e3
    exe.run(built["forward"], feed={"img": infer_feed["img"]}, scope=scope,
            fetch_list=[built["conf"]])
    t1 = time.perf_counter()
    exe.run(built["forward"], feed={"img": infer_feed["img"]}, scope=scope,
            fetch_list=[built["conf"]])
    forward_ms = (time.perf_counter() - t1) * 1e3
    prof = _profiled(torch, exe, built["infer"], infer_feed, built["map"],
                     scope, "vision ssd300 inference")
    post, card_dets, card_map = _ssd_post(
        torch, exe, built, {"loc": loc, "conf": conf, "box": box,
                            "var": var}, feeds[-1]["gt"].cpu().numpy(), scope)
    if not (np.array_equal(card_dets, np.asarray(dets))
            and np.array_equal(card_map, np.asarray(m_ap))):
        raise RuntimeError("ssd300: the post-processing alone and inside "
                           "the inference program differ")
    post.update({"inference_ms": infer_ms, "forward_ms": forward_ms,
                 "inference_launches": prof["device_launches"],
                 "inference_busy_share": prof["busy_share"],
                 "post_share": post["post_ms"] / (post["post_ms"]
                                                  + forward_ms),
                 "kept_detections": int((card_dets[..., 0] >= 0).sum()),
                 "map": float(np.asarray(m_ap).reshape(-1)[0])})
    out["post"] = post

    # card vs CPU from the trained state at a small batch: the inference
    # program's detections and mAP from the same parameters, then
    # SSD_CHECK_STEPS training steps
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), _cpu_scope(
        fluid, scope)
    check = [ssd_feed(torch, rng, SSD_CHECK_BATCH, "cpu")
             for _ in range(SSD_CHECK_STEPS + 1)]
    check_infer = {"img": check[-1]["img"], "gt": check[-1]["gt"]}
    fetch = [built["dets"], built["map"]]
    card_out = exe.run(built["infer"], feed=check_infer, fetch_list=fetch,
                       scope=scope)
    t1 = time.perf_counter()
    cpu_out = cpu_exe.run(built["infer"], feed=check_infer, fetch_list=fetch,
                          scope=cpu_scope)
    held = _hold_detections(np.asarray(card_out[0]), np.asarray(cpu_out[0]))
    maps = [float(np.asarray(v).reshape(-1)[0])
            for v in (card_out[1], cpu_out[1])]
    if not held["cuts"] and maps[0] != maps[1]:
        raise RuntimeError(f"ssd300: equal detections but mAP {maps[0]} "
                           f"(card) vs {maps[1]} (CPU)")
    check_train = [{k: f[k] for k in ("img", "gt_box", "gt_label")}
                   for f in check[:-1]]
    card_l, _ = _timed_steps(exe, built["main"], check_train,
                             [built["cost"]], scope)
    cpu_l, _ = _timed_steps(cpu_exe, built["main"], check_train,
                            [built["cost"]], cpu_scope)
    cpu_s = time.perf_counter() - t1
    err = _rel_err(card_l, cpu_l)
    if err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"ssd300: card vs CPU losses {card_l} vs {cpu_l} "
                           f"({err} relative)")
    out["check"] = {"batch": SSD_CHECK_BATCH, "card_losses": card_l,
                    "cpu_losses": cpu_l, "max_rel_err": err,
                    "detections": held, "map_card": maps[0],
                    "map_cpu": maps[1], "map_held": not held["cuts"],
                    "cpu_seconds": cpu_s}
    out["seconds"] = time.perf_counter() - t0
    log("  vision ssd300 " + json.dumps(out))
    return out


def _card_value(torch, v, device):
    """An op input on ``device``: a numpy array, a list of them (a
    multi-tensor slot) or ("selected_rows", rows, value, height)."""
    from paddle_tpu_torch.fluid.selected_rows import SelectedRows

    if isinstance(v, list):
        return [_card_value(torch, a, device)[0] for a in v]
    if isinstance(v, tuple) and v[0] == "selected_rows":
        return [SelectedRows(torch.from_numpy(v[1]).to(device),
                             torch.from_numpy(v[2]).to(device), v[3])]
    return [torch.from_numpy(v).to(device)]


def _flat_outs(outs):
    """An op's outputs as {name: numpy}: a slot of several tensors as
    name[i], a SelectedRows as its .rows and .value."""
    flat = {}
    for s, vals in outs.items():
        for i, v in enumerate(vals):
            key = s if len(vals) == 1 else f"{s}[{i}]"
            if hasattr(v, "rows"):
                flat[key + ".rows"] = v.rows.detach().cpu().numpy()
                flat[key + ".value"] = v.value.detach().cpu().numpy()
            else:
                flat[key] = v.detach().cpu().numpy()
    return flat


def _op_card_cpu(torch, op, ins, attrs, diff, index_outs=(),
                 tol=VISION_OP_TOL, grad_tol=LSTM_GRAD_TOL):
    """One op on the card and on the CPU on the same inputs: float
    outputs within ``tol`` of their max, ``index_outs`` equal, the
    gradients of ``diff`` for seeded cotangents within ``grad_tol`` of
    their max. Returns the worst errors and the card's forward ms (host
    clock, synchronised; the median of 5 after the checked call)."""
    import numpy as np

    from paddle_tpu_torch.fluid.registry import (
        FWD_META_ATTR, EmitCtx, forward_with_grad, run_forward, run_grad)

    def run(device):
        ctx = EmitCtx(device=device, root_seed=1)
        tins = {s: _card_value(torch, v, device) for s, v in ins.items()}
        if not diff:
            return _flat_outs(run_forward(ctx, op, tins, attrs)), {}
        outs, record = forward_with_grad(ctx, op, tins, attrs)
        rng = np.random.RandomState(3)
        dys = {s: rng.randn(*v[0].shape).astype(np.float32)
               for s, v in outs.items() if v[0].is_floating_point()
               and s not in index_outs}
        meta = {FWD_META_ATTR: {"type": op, "attrs": attrs,
                                "in_slots": list(ins),
                                "out_slots": list(outs)}}
        gins = dict(tins)
        gins.update({"Out@" + s: v for s, v in outs.items()})
        gins.update({"GRAD@" + s: [torch.from_numpy(d).to(device)]
                     for s, d in dys.items()})
        grads = run_grad(ctx, gins, meta, record)
        return (_flat_outs(outs),
                {s[5:]: v[0].cpu().numpy() for s, v in grads.items()
                 if s[5:] in diff and v and v[0] is not None})

    def forward_ms():
        ctx = EmitCtx(device=CARD, root_seed=1)
        tins = {s: _card_value(torch, v, CARD) for s, v in ins.items()}
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_forward(ctx, op, tins, attrs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    card, card_g = run(CARD)
    cpu, cpu_g = run("cpu")
    errs = {}
    for s, want in cpu.items():
        got = card[s]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{op} {s}: card {got.shape} {got.dtype} vs "
                               f"CPU {want.shape} {want.dtype}")
        if s in index_outs or want.dtype.kind in "iub":
            if not np.array_equal(got, want):
                raise RuntimeError(f"{op} {s}: card and CPU differ")
            continue
        fin = np.isfinite(want)
        if not np.array_equal(fin, np.isfinite(got)) or not np.array_equal(
                got[~fin], want[~fin]):
            raise RuntimeError(f"{op} {s}: card and CPU differ off the "
                               "finite values")
        scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
        errs[s] = float(np.abs(got[fin] - want[fin]).max()) / (scale or 1.0)
        if not errs[s] <= tol:
            raise RuntimeError(f"{op} {s}: card vs CPU {errs[s]} of the max "
                               f"(> {tol})")
    for s in diff:
        want, got = cpu_g[s], card_g[s]
        err = float(np.abs(got - want).max()) / (
            float(np.abs(want).max()) or 1.0)
        errs["grad " + s] = err
        if not err <= grad_tol:
            raise RuntimeError(f"{op} grad {s}: card vs CPU {err} of the max "
                               f"(> {grad_tol})")
    return {"errs": errs, "card_forward_ms": forward_ms()}


def _boxes_np(rng, *lead, hi=1.0):
    import numpy as np

    lo = rng.uniform(0.0, hi, lead + (2,)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, lead + (2,)).astype(np.float32)
    return np.concatenate([lo, lo + wh], axis=-1)


def vision_op_cases(rng):
    """(name, op, inputs, attrs, differentiable slots, index outputs) at
    the shapes the image and SSD paths give the ops."""
    import numpy as np

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    vol = randn(2, 64, 16, 56, 56)
    pool_in = randn(32, 64, 112, 112)
    pooled = np.asarray(rng.randn(32, 64, 56, 56), np.float32)
    # the positions a 2x2/2 indexed pool of [112, 112] records: one per
    # window, so no two values land on one cell
    wins = rng.randint(0, 2, (2, 32, 64, 56, 56))
    rows = np.arange(56)[:, None] * 2 + wins[0]
    cols = np.arange(56)[None, :] * 2 + wins[1]
    positions = (rows * 112 + cols).astype(np.int32)
    rois = np.concatenate([rng.randint(0, 2, (128, 1)).astype(np.float32),
                           _boxes_np(rng, 128, hi=0.6) * 300], axis=1)
    prior = _boxes_np(rng, SSD_PRIORS)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                   (SSD_PRIORS, 1))
    gtb = _boxes_np(rng, 8, 8, hi=0.5)
    iou = np.asarray(rng.rand(8, 8, SSD_PRIORS) * 0.8, np.float32)
    match = np.where(rng.rand(8, SSD_PRIORS) < 0.02,
                     rng.randint(0, 8, (8, SSD_PRIORS)), -1).astype(np.int32)
    det = np.full((8, 200, 6), -1.0, np.float32)
    det[:, :150, 0] = rng.randint(1, 21, (8, 150))
    det[:, :150, 1] = rng.rand(8, 150)
    det[:, :150, 2:] = _boxes_np(rng, 8, 150, hi=0.6)
    gt = np.concatenate([rng.randint(1, 21, (8, 8, 1)).astype(np.float32),
                         gtb, np.zeros((8, 8, 1), np.float32)], axis=-1)
    return [
        ("conv2d_transpose [8,256,32,32] -> 128, k4 s2 p1",
         "conv2d_transpose", {"Input": randn(8, 256, 32, 32),
                              "Filter": randn(256, 128, 4, 4) * 0.05},
         {"strides": [2, 2], "paddings": [1, 1]}, ["Input", "Filter"], ()),
        ("conv3d [2,64,16,56,56] -> 64, k3 p1", "conv3d",
         {"Input": vol, "Filter": randn(64, 64, 3, 3, 3) * 0.05},
         {"paddings": [1, 1, 1]}, ["Input", "Filter"], ()),
        ("conv3d_transpose [2,64,16,56,56] -> 32, k3 p1",
         "conv3d_transpose", {"Input": vol,
                              "Filter": randn(64, 32, 3, 3, 3) * 0.05},
         {"paddings": [1, 1, 1]}, ["Input", "Filter"], ()),
        ("depthwise_conv2d [32,256,56,56] k3 p1", "depthwise_conv2d",
         {"Input": randn(32, 256, 56, 56), "Filter": randn(256, 1, 3, 3)},
         {"paddings": [1, 1]}, ["Input", "Filter"], ()),
        ("lrn [128,96,54,54] n5 (AlexNet's norm1)", "lrn",
         {"X": randn(128, 96, 54, 54)},
         {"n": 5, "k": 1.0, "alpha": 1e-4, "beta": 0.75}, ["X"], ()),
        ("l2_normalize [8,512,38,38] axis 1 (SSD's conv4_3)",
         "l2_normalize", {"X": randn(8, 512, 38, 38)}, {"axis": 1}, ["X"],
         ()),
        ("pad [8,64,56,56] by 1", "pad", {"X": pooled[:8]},
         {"paddings": [0, 0, 0, 0, 1, 1, 1, 1], "pad_value": 0.0}, ["X"],
         ()),
        ("crop [8,64,56,56] -> 54x54 at 1,1", "crop", {"X": pooled[:8]},
         {"offsets": [0, 0, 1, 1], "shape": [-1, 64, 54, 54]}, ["X"], ()),
        ("maxout [32,256,28,28] groups 2", "maxout",
         {"X": randn(32, 256, 28, 28)}, {"groups": 2}, ["X"], ()),
        ("pool3d max [2,64,16,56,56] k2 s2", "pool3d", {"X": vol},
         {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2]},
         ["X"], ()),
        ("pool3d avg exclusive [2,64,16,56,56] k3 s2 p1 ceil", "pool3d",
         {"X": vol}, {"pooling_type": "avg", "ksize": [3, 3, 3],
                      "strides": [2, 2, 2], "paddings": [1, 1, 1],
                      "ceil_mode": True}, ["X"], ()),
        ("max_pool2d_with_index [32,64,112,112] k3 s2 p1",
         "max_pool2d_with_index", {"X": pool_in},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, ["X"],
         ("Mask",)),
        ("max_pool3d_with_index [2,64,16,56,56] k2 s2",
         "max_pool3d_with_index", {"X": vol},
         {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, ["X"], ("Mask",)),
        ("unpool [32,64,56,56] -> 112x112", "unpool",
         {"X": pooled, "Indices": positions},
         {"ksize": [2, 2], "strides": [2, 2]}, ["X"], ()),
        ("spp [8,256,13,13] height 3 max", "spp",
         {"X": randn(8, 256, 13, 13)},
         {"pyramid_height": 3, "pooling_type": "max"}, ["X"], ()),
        ("roi_pool 128 ROIs on [2,512,38,38], 7x7, scale 38/300",
         "roi_pool", {"X": randn(2, 512, 38, 38), "ROIs": rois},
         {"pooled_height": 7, "pooled_width": 7,
          "spatial_scale": 38.0 / 300}, ["X"], ("Argmax",)),
        ("bilinear_interp [8,256,32,32] -> 64x64", "bilinear_interp",
         {"X": randn(8, 256, 32, 32)}, {"out_h": 64, "out_w": 64}, ["X"],
         ()),
        ("nearest_interp [8,256,32,32] -> 64x64", "nearest_interp",
         {"X": randn(8, 256, 32, 32)}, {"out_h": 64, "out_w": 64}, ["X"],
         ()),
        ("smooth_l1_loss [8,8732,4]", "smooth_l1_loss",
         {"X": randn(8, SSD_PRIORS, 4), "Y": randn(8, SSD_PRIORS, 4)}, {},
         ["X", "Y"], ()),
        ("huber_loss [8,8732,4]", "huber_loss",
         {"X": randn(8, SSD_PRIORS, 4), "Y": randn(8, SSD_PRIORS, 4)}, {},
         ["X", "Y"], ()),
        ("iou_similarity [8,8,4] x [8732,4]", "iou_similarity",
         {"X": gtb, "Y": prior}, {}, [], ()),
        ("prior_box 38x38 map of a 300 image", "prior_box",
         {"Input": np.zeros((1, 1, 38, 38), np.float32),
          "Image": np.zeros((1, 1, 300, 300), np.float32)},
         {"min_sizes": [30.0], "max_sizes": [60.0], "aspect_ratios": [2.0],
          "flip": True, "clip": False}, [], ()),
        ("box_coder encode [8,8732,4] paired", "box_coder",
         {"PriorBox": prior, "PriorBoxVar": pvar,
          "TargetBox": _boxes_np(rng, 8, SSD_PRIORS)},
         {"code_type": "encode_center_size"}, [], ()),
        ("box_coder decode [8,8732,4]", "box_coder",
         {"PriorBox": prior, "PriorBoxVar": pvar,
          "TargetBox": randn(8, SSD_PRIORS, 4)},
         {"code_type": "decode_center_size"}, [], ()),
        ("bipartite_match [8,8,8732] per_prediction", "bipartite_match",
         {"DistMat": iou}, {"match_type": "per_prediction",
                            "dist_threshold": 0.5}, [],
         ("ColToRowMatchIndices", "ColToRowMatchDist")),
        ("target_assign [8,8,4] by [8,8732]", "target_assign",
         {"X": gtb, "MatchIndices": match}, {"mismatch_value": 0}, [],
         ("Out", "OutWeight")),
        ("mine_hard_examples [8,8732]", "mine_hard_examples",
         {"ClsLoss": np.asarray(rng.rand(8, SSD_PRIORS), np.float32),
          "MatchIndices": match,
          "MatchDist": np.asarray(rng.rand(8, SSD_PRIORS), np.float32)},
         {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5}, [],
         ("NegIndices", "UpdatedMatchIndices")),
        ("multiclass_nms [8,8732] x 21 classes, top 400, keep 200",
         "multiclass_nms",
         {"BBoxes": _boxes_np(rng, 8, SSD_PRIORS),
          "Scores": np.asarray(rng.rand(8, 21, SSD_PRIORS) ** 4,
                               np.float32)},
         dict(SSD_NMS, score_threshold=0.01), [], ("Out",)),
        ("detection_map [8,200,6] vs [8,8,6]", "detection_map",
         {"DetectRes": det, "Label": gt}, {"class_num": 21}, [],
         ("MAP",)),
    ]


def vision_ops_phase(torch):
    """Every op of the slice, card against CPU (see VISION_OP_TOL), each
    at a shape its path gives it; the card's forward ms beside it."""
    import numpy as np

    rng = np.random.RandomState(2031)
    out = {}
    for name, op, ins, attrs, diff, index_outs in vision_op_cases(rng):
        out[name] = _op_card_cpu(torch, op, ins, attrs, diff, index_outs)
        out[name]["op"] = op
    ops = {v["op"] for v in out.values()}
    log("  vision ops " + json.dumps(out))
    return {"cases": len(out), "op_types": len(ops),
            "worst": max(e for v in out.values() for e in v["errs"].values()
                         ) if out else None, "by_case": out}


def vision_phase(torch):
    """The image and vision slice on the card: AlexNet, GoogLeNet and
    SmallNet at the reference's benchmark configurations, SSD300 with
    its post-processing, and every new op card against CPU."""
    phase("vision")
    t0 = time.perf_counter()
    out = {name: _vision_model_run(torch, name) for name in VISION_MODELS}
    out["ssd300"] = _ssd_run(torch)
    out["ops"] = vision_ops_phase(torch)
    out["seconds"] = time.perf_counter() - t0
    log("  vision " + json.dumps({
        k: {m: v[m] for m in ("p50_step_ms_after_first", "images_per_s",
                              "device_launches_a_step", "busy_share",
                              "peak_memory_allocated_gb", "seconds")}
        for k, v in out.items() if k in VISION_MODELS or k == "ssd300"}))
    log("  vision ssd300 post " + json.dumps(out["ssd300"]["post"]))
    return out


# sparse: the JAX package's large-vocabulary program
# (tests/test_selected_rows.py:121-156): embedding(is_sparse=True) of D
# 64, batch 64, fc 32 relu, fc 16, softmax cross-entropy, Adam(0.01), at V
# 100,000 as there and at 1,000,000 (a 256 MB table) sparse and dense in
# turns; SGD, Momentum, Adam and Adagrad at 100,000. Ids from a seeded
# Zipf law (s = SPARSE_ZIPF_S) over V, so rows repeat within a batch as
# words do; labels id % 16
SPARSE = dict(dim=64, batch=64, fc=32, classes=16, lr=0.01)
SPARSE_VOCABS = (100_000, 1_000_000)
SPARSE_OPTIMIZERS = ("sgd", "momentum", "adam", "adagrad")
SPARSE_STEPS = 6          # held steps a program (p50 over steps 2-6)
SPARSE_TURNS = 5          # sparse/dense step pairs at V 1,000,000
SPARSE_ZIPF_S = 1.0
# word2vec at a real vocabulary: the book's N-gram model at the text book
# phase's widths (W2V: N 5, emb 32, hidden 256, Adam), one shared sparse
# embedding over 100,000 words, batch 32, three heads
W2V_BIG = dict(vocab=100_000, batch=32)
W2V_HEADS = ("softmax", "nce", "hsigmoid")
# held on the card: each new op and its gradient against the CPU within
# SPARSE_OP_TOL of the tensor's max; a sparse SGD step's parameters
# against the dense step's within SPARSE_SGD_TOL of their max (SGD is
# linear in the gradient); nce's Cost against the plain formula on the
# card's own SampleLabels within SPARSE_OP_TOL relative; the random ops'
# statistics over RANDOM_DRAWS draws within RANDOM_TOL
SPARSE_OP_TOL = 1e-5
SPARSE_SGD_TOL = 1e-5
RANDOM_DRAWS = 1_000_000
RANDOM_TOL = 3e-3


def _zipf_ids(rng, vocab, shape):
    """Ids in [0, vocab) with P(k) proportional to 1 / (k + 1)^s."""
    import numpy as np

    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1) ** SPARSE_ZIPF_S)
    u = rng.rand(*shape) * cdf[-1]
    return np.minimum(np.searchsorted(cdf, u), vocab - 1).astype(np.int64)


def _optimizer(fluid, name, lr):
    opt = fluid.optimizer
    return {"sgd": lambda: opt.SGD(learning_rate=lr),
            "momentum": lambda: opt.Momentum(learning_rate=lr, momentum=0.9),
            "adam": lambda: opt.Adam(learning_rate=lr),
            "adagrad": lambda: opt.Adagrad(learning_rate=lr)}[name]()


def build_sparse_embedding(pkg, vocab, is_sparse, optimizer, dim, batch, fc,
                           classes, lr, is_distributed=False):
    """tests/test_selected_rows.py:121's program: ids -> embedding
    ``sparse_emb`` [vocab, dim] -> fc(fc, relu) -> fc(classes) ->
    softmax cross-entropy -> mean. ``is_distributed`` marks the table
    for a pserver's row-granular prefetch."""
    def body(layers):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        label = layers.data(name="label", shape=[1], dtype="int64")
        emb = layers.embedding(input=ids, size=[vocab, dim],
                               is_sparse=is_sparse, param_attr="sparse_emb",
                               is_distributed=is_distributed)
        h = layers.fc(input=emb, size=fc, act="relu")
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=layers.fc(input=h, size=classes), label=label))
        return cost, [ids, label], {"table": "sparse_emb"}, _optimizer(
            pkg.fluid, optimizer, lr)

    return _chapter(pkg, 11, body)


def build_word2vec_head(pkg, vocab, head, emb, hidden, n, lr):
    """The book's N-gram model (tests/test_book.py:76) over ``vocab``
    words: N-1 words through one shared sparse embedding, concat,
    fc(hidden, sigmoid), then the ``head``: a softmax fc over the
    vocabulary, ``nce`` (its default 10 uniform negatives) or
    ``hsigmoid``; Adam(lr)."""
    def body(layers):
        words = [layers.data(name=f"word_{i}", shape=[1], dtype="int64")
                 for i in range(n - 1)]
        nxt = layers.data(name="next_word", shape=[1], dtype="int64")
        embeds = [layers.embedding(
            input=w, size=[vocab, emb], is_sparse=True,
            param_attr=pkg.fluid.ParamAttr(name="shared_w")) for w in words]
        h = layers.fc(input=layers.concat(input=embeds, axis=1),
                      size=hidden, act="sigmoid")
        if head == "softmax":
            cost = layers.softmax_with_cross_entropy(
                logits=layers.fc(input=h, size=vocab), label=nxt)
        elif head == "nce":
            cost = layers.nce(input=h, label=nxt, num_total_classes=vocab)
        else:
            cost = layers.hsigmoid(input=h, label=nxt, num_classes=vocab)
        return (layers.mean(cost), words + [nxt], {"table": "shared_w"},
                pkg.fluid.optimizer.Adam(learning_rate=lr))

    return _chapter(pkg, 13, body)


def _sparse_feed(torch, rng, vocab, keys, label_key, batch):
    """A feed on the card: Zipf ids for each of ``keys``; the label slot
    ``label_key`` the first id % 16 (SPARSE) when it is not a key. The
    held windows repeat one batch, as tests/test_selected_rows.py:146
    does, so the loss must fall."""
    f = {k: _zipf_ids(rng, vocab, (batch, 1)) for k in keys}
    if label_key not in f:
        f[label_key] = f[keys[0]] % SPARSE["classes"]
    return {k: torch.from_numpy(v).to(CARD) for k, v in f.items()}


def _grad_shape(exe, built, feed, scope):
    """One step fetching the table's gradient: its shape ([N, D] for a
    SelectedRows, [V, D] dense) and whether it came back SelectedRows."""
    from paddle_tpu_torch.fluid.selected_rows import is_selected_rows

    (g,) = exe.run(built["main"], feed=feed,
                   fetch_list=[built["table"] + "@GRAD"], scope=scope)
    v = g.value if is_selected_rows(g) else g
    return list(v.shape), is_selected_rows(g)


def _sparse_program_run(torch, name, built, feeds, config, grad_shape):
    """SPARSE_STEPS held steps (p50 over steps 2-N, peak memory, and the
    peak above the memory held before the window), one profiled step,
    one step fetching the table's gradient: a SelectedRows of
    ``grad_shape``, or dense where that is None. The loss must fall."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(built["startup"], scope=scope)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (losses, ms), launches = _held_window(lambda: _timed_steps(
        exe, built["main"], feeds[:SPARSE_STEPS], [built["cost"]], scope))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: losses not finite and falling: "
                           f"{losses}")
    p50 = statistics.median(ms[1:])
    batch = len(feeds[0][next(iter(feeds[0]))])
    out = {"config": config, "losses": losses, "step_ms": ms,
           "p50_step_ms_after_first": p50,
           "samples_per_s": batch / (p50 / 1e3),
           "peak_memory_allocated_gb": peak / 1e9,
           "peak_above_state_gb": (peak - before) / 1e9,
           "kernel_launches": launches}
    prof = _profiled(torch, exe, built["main"], feeds[SPARSE_STEPS],
                     built["cost"], scope, f"sparse {name} step")
    out["device_launches_a_step"] = prof["device_launches"]
    out["busy_share"] = prof["busy_share"]
    out["profile"] = prof
    shape, is_sr = _grad_shape(exe, built, feeds[SPARSE_STEPS + 1], scope)
    if (is_sr, shape if is_sr else None) != (grad_shape is not None,
                                             grad_shape):
        raise RuntimeError(f"{name}: the table's gradient is "
                           f"{'SelectedRows' if is_sr else 'dense'} "
                           f"{shape}, want {grad_shape or 'dense'}")
    out["table_grad"] = {"selected_rows": is_sr, "shape": shape}
    out["seconds"] = time.perf_counter() - t0
    log(f"  sparse {name} " + json.dumps(out))
    return out, exe, scope


def _sparse_vs_dense_1m(torch):
    """V 1,000,000 with Adam: the sparse and the dense program, each in
    its own window (peak memory above the state held before it), then
    SPARSE_TURNS steps of each in turns."""
    import numpy as np

    vocab = SPARSE_VOCABS[1]
    pkg, rng = port_pkg(), np.random.RandomState(1)
    feeds = [_sparse_feed(torch, rng, vocab, ["ids"], "label",
                          SPARSE["batch"])] * (SPARSE_STEPS + 2 + SPARSE_TURNS)
    out, runs = {}, {}
    for sparse in (True, False):
        key = "sparse" if sparse else "dense"
        built = build_sparse_embedding(pkg, vocab, sparse, "adam", **SPARSE)
        out[key], exe, scope = _sparse_program_run(
            torch, f"v{vocab}_{key}", built, feeds,
            f"V {vocab}, is_sparse={sparse}, Adam, {SPARSE}",
            [SPARSE["batch"], SPARSE["dim"]] if sparse else None)
        runs[key] = (exe, built, scope)
    turns = {"sparse": [], "dense": []}
    for feed in feeds[SPARSE_STEPS + 2:]:
        for key in ("sparse", "dense"):
            exe, built, scope = runs[key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(built["main"], feed=feed, fetch_list=[built["cost"]],
                    scope=scope)
            turns[key].append((time.perf_counter() - t0) * 1e3)
    out["in_turns_ms"] = turns
    out["in_turns_median_ms"] = {k: statistics.median(v)
                                 for k, v in turns.items()}
    out["dense_over_sparse"] = (out["in_turns_median_ms"]["dense"]
                                / out["in_turns_median_ms"]["sparse"])
    log("  sparse v1m in turns " + json.dumps(
        {k: out[k] for k in ("in_turns_median_ms", "dense_over_sparse")}))
    return out


def _sparse_sgd_held(torch):
    """From one start at V 100,000: one sparse and one dense SGD step on
    the same Zipf batch; every parameter within SPARSE_SGD_TOL of its
    max. Then a sparse Adam step repeated from one state: bitwise."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    vocab, pkg = SPARSE_VOCABS[0], port_pkg()
    feed = _sparse_feed(torch, np.random.RandomState(2), vocab, ["ids"],
                        "label", SPARSE["batch"])
    params = {}
    for sparse in (True, False):
        built = build_sparse_embedding(pkg, vocab, sparse, "sgd", **SPARSE)
        exe, scope = _card_executor(fluid), fluid.Scope()
        exe.run(built["startup"], scope=scope)
        exe.run(built["main"], feed=feed, fetch_list=[built["cost"]],
                scope=scope)
        params[sparse] = {p.name: scope.find_var(p.name).cpu().numpy()
                          for p in built["main"].global_block()
                          .all_parameters()}
    errs = {n: float(np.abs(params[True][n] - params[False][n]).max()
                     / (np.abs(params[False][n]).max() or 1.0))
            for n in params[True]}
    if not max(errs.values()) <= SPARSE_SGD_TOL:
        raise RuntimeError(f"sparse vs dense SGD step: {errs} (> "
                           f"{SPARSE_SGD_TOL} of the max)")
    built = build_sparse_embedding(pkg, vocab, True, "adam", **SPARSE)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(built["startup"], scope=scope)
    start = _scope_copy(fluid, scope)
    after = []
    for _ in range(2):
        scope = _scope_copy(fluid, start)
        exe.run(built["main"], feed=feed, fetch_list=[built["cost"]],
                scope=scope)
        after.append(scope)
    differ = _same_state(torch, after[0], after[1])
    if differ:
        raise RuntimeError(f"a sparse Adam step repeated from one state "
                           f"differs in {differ}")
    ids = feed["ids"].cpu().numpy().reshape(-1)
    return {"sgd_sparse_vs_dense_rel_err": errs,
            "adam_repeat_bitwise": True,
            "batch_ids": int(ids.size),
            "batch_unique_ids": int(np.unique(ids).size)}


def sparse_op_cases(rng):
    """(case, op, ins, attrs, diff slots, index outputs) of every op of
    the slice that is not a random draw, at a small size."""
    import numpy as np

    f32 = np.float32

    def randn(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(f32)

    def ids(*v):
        return np.array(v, np.int64)

    sr = ("selected_rows", ids(7, 0, 3, 9, 3, 5), randn(6, 4), 10)
    k = 1000
    return [
        ("gather", "gather", {"X": randn(64, 8), "Index": ids(
            *rng.randint(0, 64, 32))}, {}, ["X"], ()),
        ("scatter", "scatter", {"X": randn(64, 8), "Ids": ids(
            *rng.permutation(64)[:16]), "Updates": randn(16, 8)}, {},
         ["X", "Updates"], ()),
        ("one_hot", "one_hot", {"X": ids(*rng.randint(-1, 12, 40))[:, None]},
         {"depth": 10}, [], ()),
        ("multiplex", "multiplex", {"X": [randn(32, 8) for _ in range(3)],
                                    "Ids": ids(*rng.randint(0, 3, 32))[
                                        :, None]}, {}, [], ()),
        ("label_smooth", "label_smooth", {"X": np.eye(16, dtype=f32)[
            rng.randint(0, 16, 32)]}, {"epsilon": 0.1}, ["X"], ()),
        ("is_empty", "is_empty", {"X": np.zeros((4, 0), f32)}, {}, [], ()),
        ("arg_min", "arg_min", {"X": rng.randint(-3, 4, (16, 12)).astype(
            f32)}, {"axis": 1}, [], ()),
        ("reverse", "reverse", {"X": randn(4, 6, 5)}, {"axis": [0, 2]},
         ["X"], ()),
        ("split_ids", "split_ids", {"Ids": ids(*rng.randint(0, 100, 40))[
            :, None]}, {"num_shards": 4}, [], ()),
        ("split_selected_rows", "split_selected_rows", {"X": sr},
         {"height_sections": [3, 4, 3]}, [], ()),
        ("l1_norm", "l1_norm", {"X": randn(32, 16)}, {}, ["X"], ()),
        ("minus", "minus", {"X": randn(32, 16), "Y": randn(32, 16)}, {},
         ["X", "Y"], ()),
        ("sigmoid_cross_entropy_with_logits",
         "sigmoid_cross_entropy_with_logits",
         {"X": randn(32, 16, scale=3.0), "Label": rng.rand(32, 16).astype(
             f32)}, {}, ["X"], ()),
        ("log_loss", "log_loss", {"Predicted": rng.uniform(
            0.05, 0.95, (32, 1)).astype(f32), "Labels": rng.randint(
            0, 2, (32, 1)).astype(f32)}, {"epsilon": 1e-4}, ["Predicted"],
         ()),
        ("hinge_loss", "hinge_loss", {"Logits": randn(32, 1, scale=2.0),
                                      "Labels": rng.randint(0, 2, (32, 1))
                                      .astype(f32)}, {}, ["Logits"], ()),
        ("rank_loss", "rank_loss", {"Label": rng.randint(0, 2, (32, 1))
                                    .astype(f32), "Left": randn(32, 1),
                                    "Right": randn(32, 1)}, {},
         ["Left", "Right"], ()),
        ("margin_rank_loss", "margin_rank_loss", {
            "Label": np.where(rng.rand(32, 1) > 0.5, 1, -1).astype(f32),
            "X1": randn(32, 1), "X2": randn(32, 1)}, {"margin": 0.1},
         ["X1", "X2"], ()),
        ("squared_l2_distance", "squared_l2_distance", {
            "X": randn(32, 16), "Y": randn(32, 16)}, {}, ["X", "Y"], ()),
        ("modified_huber_loss", "modified_huber_loss", {
            "X": randn(32, 1, scale=2.0), "Y": rng.randint(0, 2, (32, 1))
            .astype(f32)}, {}, ["X"], ()),
        ("hierarchical_sigmoid", "hierarchical_sigmoid", {
            "X": randn(32, 64), "W": randn(k - 1, 64, scale=0.1),
            "Label": ids(*rng.randint(0, k, 32))[:, None],
            "Bias": randn(k - 1, scale=0.1)}, {"num_classes": k},
         ["X", "W", "Bias"], ()),
        ("lambda_cost", "lambda_cost", {
            "X": randn(8, 12), "Score": rng.randint(0, 4, (8, 12)).astype(
                f32), "Lengths": rng.randint(2, 13, 8).astype(np.int32)},
         {"NDCG_num": 5}, ["X"], ()),
        ("scale_sub_region", "scale_sub_region", {
            "X": randn(2, 3, 8, 8), "Indices": np.array(
                [[1, 2, 2, 6, 3, 8], [2, 3, 1, 4, 1, 1]], np.int32)},
         {"value": 2.0}, ["X"], ()),
        ("norm", "norm", {"X": randn(2, 16, 8, 8), "Scale": rng.uniform(
            0.5, 2, 16).astype(f32)}, {"epsilon": 1e-10}, ["X", "Scale"],
         ()),
        ("conv_shift", "conv_shift", {"X": randn(16, 32), "Y": randn(16, 5)},
         {}, ["X", "Y"], ()),
        ("bilinear_tensor_product", "bilinear_tensor_product", {
            "X": randn(16, 8), "Y": randn(16, 6), "Weight": randn(4, 8, 6),
            "Bias": randn(1, 4)}, {}, ["X", "Y", "Weight", "Bias"], ()),
        ("auc", "auc", {"Out": np.stack([1 - (u := rng.rand(256).astype(
            f32)), u], 1), "Label": rng.randint(0, 2, (256, 1)).astype(
            np.int64)}, {"num_thresholds": 200}, [], ()),
        ("precision_recall", "precision_recall", {
            "MaxProbs": rng.rand(64, 1).astype(f32),
            "Indices": ids(*rng.randint(0, 5, 64))[:, None],
            "Labels": ids(*rng.randint(0, 5, 64))[:, None],
            "StatesInfo": rng.randint(0, 5, (5, 4)).astype(f32)},
         {"class_number": 5}, [], ()),
        ("positive_negative_pair", "positive_negative_pair", {
            "Score": rng.randint(0, 5, (64, 1)).astype(f32),
            "Label": rng.randint(0, 3, (64, 1)).astype(f32),
            "QueryID": ids(*rng.randint(0, 4, 64))[:, None]}, {}, [], ()),
    ]


def _nce_held(torch):
    """``nce`` on the card (V 100,000, 10 negatives, [32, 256] inputs):
    Cost against the plain formula in float64 on the card's own
    SampleLabels, and the draws in range."""
    import numpy as np

    from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward

    rng = np.random.RandomState(5)
    v, d, n, k = W2V_BIG["vocab"], W2V["hidden"], W2V_BIG["batch"], 10
    x = (rng.randn(n, d) * 0.1).astype(np.float32)
    w = (rng.randn(v, d) * 0.1).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    label = rng.randint(0, v, (n, 1)).astype(np.int64)
    outs = run_forward(EmitCtx(device=CARD, root_seed=7), "nce", {
        "Input": [torch.from_numpy(x).to(CARD)],
        "Weight": [torch.from_numpy(w).to(CARD)],
        "Bias": [torch.from_numpy(b).to(CARD)],
        "Label": [torch.from_numpy(label).to(CARD)]},
        {"num_total_classes": v, "num_neg_samples": k, "__rng_seed__": 1})
    samples = outs["SampleLabels"][0].cpu().numpy()
    cost = outs["Cost"][0].cpu().numpy()
    if samples.min() < 0 or samples.max() >= v or not np.array_equal(
            samples[:, :1], label):
        raise RuntimeError("nce: SampleLabels out of range or without the "
                           "true class first")
    logits = np.einsum("nd,nsd->ns", x.astype(np.float64),
                       w[samples].astype(np.float64)) + b[samples]
    adj = logits - np.log(k / v)
    t = np.zeros_like(adj)
    t[:, 0] = 1.0
    want = np.sum(np.logaddexp(adj, 0) - t * adj, axis=1, keepdims=True)
    err = _rel_err(cost, want)
    if not err <= SPARSE_OP_TOL:
        raise RuntimeError(f"nce: Cost vs the formula on its own samples "
                           f"{err} relative (> {SPARSE_OP_TOL})")
    return {"cost_rel_err": err, "distinct_negatives": int(
        np.unique(samples[:, 1:]).size), "negatives": int(samples[:, 1:].size)}


def _random_held(torch):
    """The card's draws by their distribution over RANDOM_DRAWS samples:
    the batch-size-like uniform and gaussian (mean, standard deviation,
    range), sampling_id (each category's frequency, none on a zero)."""
    import numpy as np

    from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward

    ctx = EmitCtx(device=CARD, root_seed=9)
    like = torch.zeros(RANDOM_DRAWS // 1000, 3, device=CARD)
    out = {}
    for op, attrs, mean, std in (
            ("uniform_random_batch_size_like",
             {"shape": [-1, 1000], "min": -2.0, "max": 4.0}, 1.0,
             6 / math.sqrt(12)),
            ("gaussian_random_batch_size_like",
             {"shape": [-1, 1000], "mean": 0.5, "std": 2.0}, 0.5, 2.0)):
        x = run_forward(ctx, op, {"Input": [like]}, {
            **attrs, "__rng_seed__": 1})["Out"][0]
        got = {"mean": float(x.mean()), "std": float(x.std()),
               "min": float(x.min()), "max": float(x.max()),
               "shape": list(x.shape)}
        if (abs(got["mean"] - mean) > RANDOM_TOL * std
                or abs(got["std"] - std) > RANDOM_TOL * std
                or got["shape"] != [RANDOM_DRAWS // 1000, 1000]
                or ("min" in attrs and not (
                    attrs["min"] <= got["min"] and got["max"] < attrs["max"]))):
            raise RuntimeError(f"{op}: {got} against mean {mean} std {std}")
        out[op] = got
    probs = np.array([[0.1, 0.2, 0.0, 0.7], [2.0, 1.0, 1.0, 0.0]],
                     np.float32)
    half = RANDOM_DRAWS // 2
    x = torch.from_numpy(np.repeat(probs, half, axis=0)).to(CARD)
    ids = run_forward(ctx, "sampling_id", {"X": [x]}, {
        "__rng_seed__": 2})["Out"][0].cpu().numpy()
    freqs = []
    for r, row in enumerate(probs):
        freq = np.bincount(ids[r * half:(r + 1) * half], minlength=4) / half
        if np.abs(freq - row / row.sum()).max() > RANDOM_TOL or \
                freq[row == 0].sum() != 0:
            raise RuntimeError(f"sampling_id: row {r} frequencies {freq} "
                               f"against {row / row.sum()}")
        freqs.append(freq.tolist())
    out["sampling_id"] = {"frequencies": freqs,
                          "want": (probs / probs.sum(1, keepdims=True))
                          .tolist()}
    return out


def _metrics_held(torch):
    """fluid.evaluator.Accuracy over three batches on the card and on the
    CPU (equal), and fluid.metrics' Auc and ChunkEvaluator fed from a
    program's softmax and chunk_eval on each (within SPARSE_OP_TOL; the
    chunk counts equal)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, metrics, unique_name

    rng = np.random.RandomState(6)
    feeds = [{"scores": rng.randn(64, 2).astype(np.float32),
              "label": rng.randint(0, 2, (64, 1)).astype(np.int64),
              "inf": rng.randint(0, 5, (16, 12)).astype(np.int64),
              "lab": rng.randint(0, 5, (16, 12)).astype(np.int64)}
             for _ in range(3)]
    results = {}
    for device in (CARD, "cpu"):
        main, startup, scope = fluid.Program(), fluid.Program(), \
            fluid.Scope()
        with fluid.scope_guard(scope), unique_name.guard():
            with fluid.program_guard(main, startup):
                scores = layers.data(name="scores", shape=[2],
                                     dtype="float32")
                label = layers.data(name="label", shape=[1], dtype="int64")
                inf = layers.data(name="inf", shape=[12], dtype="int64")
                lab = layers.data(name="lab", shape=[12], dtype="int64")
                probs = layers.softmax(scores)
                ev = fluid.evaluator.Accuracy(input=scores, label=label)
                chunks = layers.chunk_eval(input=inf, label=lab,
                                           chunk_scheme="IOB",
                                           num_chunk_types=2)
            exe = fluid.Executor(device)
            exe.run(startup)
            ev.reset(exe)
            auc, chunk = metrics.Auc(), metrics.ChunkEvaluator()
            for feed in feeds:
                got = exe.run(main, feed=feed,
                              fetch_list=[probs] + list(chunks[3:]))
                auc.update(np.asarray(got[0]), feed["label"])
                chunk.update(*[int(np.asarray(v).reshape(-1)[0])
                               for v in got[1:]])
            results[device] = {
                "accuracy": float(np.asarray(ev.eval(exe)).reshape(-1)[0]),
                "auc": float(auc.eval()),
                "chunk": [float(v) for v in chunk.eval()],
                "chunk_counts": [chunk.num_infer_chunks,
                                 chunk.num_label_chunks,
                                 chunk.num_correct_chunks]}
    card, cpu = results[CARD], results["cpu"]
    if card["accuracy"] != cpu["accuracy"] or \
            card["chunk_counts"] != cpu["chunk_counts"] or \
            _rel_err([card["auc"]] + card["chunk"],
                     [cpu["auc"]] + cpu["chunk"]) > SPARSE_OP_TOL:
        raise RuntimeError(f"evaluator/metrics: card {card} vs CPU {cpu}")
    return results


def sparse_phase(torch):
    """The sixteenth slice on the card: sparse embeddings at 100,000 and
    1,000,000 rows (SPARSE), word2vec over 100,000 words with a softmax,
    an nce and an hsigmoid head (W2V_BIG), and the held checks: every
    new op card vs CPU, the evaluator and metrics, a sparse SGD step
    against the dense one, a repeated sparse step bitwise, nce's Cost on
    its own samples, the random ops by distribution."""
    phase("sparse")
    import numpy as np

    t0 = time.perf_counter()
    pkg, out = port_pkg(), {}
    vocab = SPARSE_VOCABS[0]
    feeds = [_sparse_feed(torch, np.random.RandomState(0), vocab, ["ids"],
                          "label", SPARSE["batch"])] * (SPARSE_STEPS + 2)
    for opt in SPARSE_OPTIMIZERS:
        built = build_sparse_embedding(pkg, vocab, True, opt, **SPARSE)
        out[f"v{vocab}_{opt}"] = _sparse_program_run(
            torch, f"v{vocab}_{opt}", built, feeds,
            f"V {vocab}, is_sparse=True, {opt}, {SPARSE}",
            [SPARSE["batch"], SPARSE["dim"]])[0]
    out["v1m"] = _sparse_vs_dense_1m(torch)
    rng = np.random.RandomState(4)
    keys = [f"word_{i}" for i in range(W2V["n"] - 1)] + ["next_word"]
    w2v_feeds = [_sparse_feed(torch, rng, W2V_BIG["vocab"], keys,
                              "next_word", W2V_BIG["batch"])] * (
        SPARSE_STEPS + 2)
    for head in W2V_HEADS:
        built = build_word2vec_head(pkg, W2V_BIG["vocab"], head, **W2V)
        run = _sparse_program_run(
            torch, f"word2vec_{head}", built, w2v_feeds,
            f"word2vec N-gram over {W2V_BIG['vocab']} words, {W2V}, "
            f"sparse shared embedding, {head} head, batch "
            f"{W2V_BIG['batch']}",
            # the N-1 lookups' rows, concatenated by the gradient's sum
            [W2V_BIG["batch"] * (W2V["n"] - 1), W2V["emb"]])[0]
        run["words_per_s"] = run["samples_per_s"]  # one predicted word each
        out[f"word2vec_{head}"] = run
    held = {"sgd_and_repeat": _sparse_sgd_held(torch),
            "nce": _nce_held(torch), "random": _random_held(torch),
            "metrics": _metrics_held(torch)}
    rng = np.random.RandomState(2031)
    ops = {}
    for name, op, ins, attrs, diff, index_outs in sparse_op_cases(rng):
        ops[name] = _op_card_cpu(torch, op, ins, attrs, diff, index_outs,
                                 tol=SPARSE_OP_TOL, grad_tol=SPARSE_OP_TOL)
    held["ops"] = {"cases": len(ops), "worst": max(
        e for v in ops.values() for e in v["errs"].values()), "by_case": ops}
    log("  sparse held " + json.dumps(held))
    out["held"] = held
    out["seconds"] = time.perf_counter() - t0
    log("  sparse " + json.dumps({
        k: {m: v.get(m) for m in (
            "p50_step_ms_after_first", "samples_per_s",
            "device_launches_a_step", "busy_share",
            "peak_memory_allocated_gb", "peak_above_state_gb",
            "table_grad")}
        for k, v in out.items()
        if isinstance(v, dict) and "p50_step_ms_after_first" in v}))
    return out


# --- parallel: ParallelExecutor on a DTensor mesh --------------------------

PARALLEL_STEPS = 3
PARALLEL_LOSS_RTOL = 1e-5   # each ParallelExecutor loss against the plain's
PARALLEL_SMALL_RTOL = 1e-4  # small programs: card vs CPU, relative
PARALLEL_LAUNCHES = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
                     "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
                     "flash_delta": 18}
# layers.moe at the Transformer's widths: 16 sequences of 512 tokens
MOE = dict(d_model=512, experts=8, d_ff=2048, batch=16, seq=512, lr=1e-3,
           aux=0.01)
PDO = dict(width=512, batch=256, lr=1e-3)        # the ParallelDo MLP
DIST_EMB = dict(vocab=100_000, dim=64, batch=256, lr=0.1)  # transpiler
SMALL_STEPS = 3


def _pe(fluid, scope, main, cost, mesh, plan, device=None):
    """A ParallelExecutor over ``scope`` (the scope it runs on is the
    one active when it is built)."""
    with fluid.scope_guard(scope):
        return fluid.ParallelExecutor(loss_name=cost.name,
                                      main_program=main, mesh=mesh,
                                      sharding_plan=plan, device=device)


def _collective_counts():
    from paddle_tpu_torch.observability import metrics

    snap = metrics.snapshot("mesh.")
    return {k[len("mesh.collectives."):]: v for k, v in snap.items()
            if k.startswith("mesh.collectives.")}


def _profiled_call(torch, run, what):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out = _device_summary(events, wall_ms, what)
    out["device_launches"] = _device_launches(events)
    return out


def _transformer_ways(torch):
    """Transformer-base (TRANSFORMER_BASE, batch TRAIN_BATCH, Adam) three
    ways in turns from one startup state and one step seed: the plain
    Executor, a ParallelExecutor under plan_data_parallel() on dp=1, and
    one under transformer_rules() on dp=1,tp=1,fsdp=1. Each run is the
    main path's window (counts to 0 before, read after)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.mesh import transformer_rules
    from paddle_tpu_torch.parallel import plan_data_parallel

    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)
    # one program each: each run advances its own program's step seed,
    # so step i draws the same dropout masks on every way
    built = {w: build_transformer(TRANSFORMER_BASE, 1e-4)
             for w in ("plain", "pe_dp", "pe_rules")}
    exe = _card_executor(fluid)
    base = fluid.Scope()
    exe.run(built["plain"][1], scope=base)
    scopes = {}
    for w in built:
        scopes[w] = fluid.Scope()
        for n in base.var_names():
            scopes[w].set_var(n, base.find_var(n).detach().clone())
    del base
    state_gb = torch.cuda.memory_allocated() / 1e9
    runners = {"plain": lambda: exe.run(built["plain"][0], feed=feed,
                                        fetch_list=[built["plain"][2]],
                                        scope=scopes["plain"])}
    pes = {
        "pe_dp": _pe(fluid, scopes["pe_dp"], built["pe_dp"][0],
                     built["pe_dp"][2], "dp=1", plan_data_parallel()),
        "pe_rules": _pe(fluid, scopes["pe_rules"], built["pe_rules"][0],
                        built["pe_rules"][2], "dp=1,tp=1,fsdp=1",
                        transformer_rules()),
    }
    for w, pe in pes.items():
        if pe.device.type != CARD:
            raise RuntimeError(f"ParallelExecutor() chose {pe.device}, "
                               "not the card")
        runners[w] = (lambda pe=pe, w=w: pe.run(
            fetch_list=[built[w][2]], feed=feed))
    coll0 = _collective_counts()
    res = {w: {"losses": [], "step_ms": [], "launches": [], "peak_gb": 0.0}
           for w in runners}
    for _ in range(PARALLEL_STEPS):
        for w, run in runners.items():
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (loss,), launches = _held_window(run)
            res[w]["step_ms"].append((time.perf_counter() - t0) * 1e3)
            res[w]["losses"].append(float(np.asarray(loss).reshape(-1)[0]))
            res[w]["launches"].append(launches)
            res[w]["peak_gb"] = max(res[w]["peak_gb"],
                                    torch.cuda.max_memory_allocated() / 1e9)
    collectives = {k: v - coll0.get(k, 0)
                   for k, v in _collective_counts().items()}
    plain = res["plain"]
    for w, r in res.items():
        for i, launches in enumerate(r["launches"]):
            for k, per_step in PARALLEL_LAUNCHES.items():
                if launches.get(k, 0) != per_step:
                    raise RuntimeError(
                        f"{w} step {i + 1}: {k} launched "
                        f"{launches.get(k, 0)} times, want {per_step} (the "
                        "plain step's)")
        r["p50_step_ms_after_first"] = statistics.median(r["step_ms"][1:])
        r["tokens_per_s"] = TRAIN_BATCH * SEQ / (
            r["p50_step_ms_after_first"] / 1e3)
        r["launches_per_step"] = r.pop("launches")[-1]
        if not all(np.isfinite(r["losses"])):
            raise RuntimeError(f"{w}: losses not finite: {r['losses']}")
        if w == "plain":
            continue
        r["loss_rel_err"] = _rel_err(r["losses"], plain["losses"])
        r["bitwise"] = r["losses"] == plain["losses"]
        if r["loss_rel_err"] > PARALLEL_LOSS_RTOL:
            raise RuntimeError(
                f"{w}: losses {r['losses']} vs the plain step's "
                f"{plain['losses']}: {r['loss_rel_err']} relative "
                f"(> {PARALLEL_LOSS_RTOL})")
        r["step_ratio_p50"] = (r["p50_step_ms_after_first"]
                               / plain["p50_step_ms_after_first"])
        r["step_ratio_in_turns"] = statistics.median(
            a / b for a, b in zip(r["step_ms"][1:], plain["step_ms"][1:]))
        r["first_step_ms"] = r["step_ms"][0]
    w = scopes["pe_rules"].find_var("enc0.self.q.w")
    m = next(scopes["pe_rules"].find_var(n)
             for n in scopes["pe_rules"].var_names()
             if n.startswith("enc0.self.q.w_moment1"))
    placements = {"enc0.self.q.w": str(tuple(w.placements)),
                  "enc0.self.q.w_moment1": str(tuple(m.placements))}
    for w_ in res:
        res[w_]["profile"] = _profiled_call(torch, runners[w_],
                                            f"parallel {w_} step")
    return {"ways": res, "collectives": collectives,
            "placements": placements, "state_gb": state_gb,
            "config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 "
                      "len512 dropout0.1 adam1e-4 f32, batch "
                      f"{TRAIN_BATCH}"}


def _card_vs_cpu(torch, fluid, built, feeds, mesh, plan, what):
    """SMALL_STEPS steps of a program under a card ParallelExecutor and
    under the CPU's plain Executor from the same startup state: the
    fetched losses (relative) and the card's p50 step ms."""
    import numpy as np

    main, startup, cost = built[:3]
    card = fluid.Scope()
    _card_executor(fluid).run(startup, scope=card)
    cpu = _cpu_scope(fluid, card)
    pe = _pe(fluid, card, main, cost, mesh, plan)
    got, ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        (loss,), launches = _held_window(
            lambda: pe.run(fetch_list=[cost], feed=feed))
        ms.append((time.perf_counter() - t0) * 1e3)
        got.append(float(np.asarray(loss).reshape(-1)[0]))
    exe = fluid.Executor(fluid.CPUPlace())
    want = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[cost],
                                     scope=cpu)[0]).reshape(-1)[0])
            for feed in feeds]
    err = _rel_err(got, want)
    if not all(np.isfinite(got)) or err > PARALLEL_SMALL_RTOL:
        raise RuntimeError(f"{what}: card {got} vs CPU {want}: {err} "
                           f"relative (> {PARALLEL_SMALL_RTOL})")
    return {"losses": got, "cpu_losses": want, "rel_err": err,
            "step_ms": ms, "p50_step_ms_after_first":
                statistics.median(ms[1:]), "kernel_launches": launches,
            "scope": card}


def _build_moe(pkg, d_model, experts, d_ff, batch, seq, lr, aux):
    fluid, layers, unique_name = pkg.fluid, pkg.layers, pkg.unique_name
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[seq, d_model], dtype="float32")
        y = layers.data(name="y", shape=[seq, d_model], dtype="float32")
        out, aux_loss = layers.moe(x, num_experts=experts, d_ff=d_ff,
                                   name="moe0")
        cost = layers.elementwise_add(
            layers.mean(layers.square_error_cost(input=out, label=y)),
            layers.scale(aux_loss, scale=aux))
        fluid.optimizer.Adam(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _build_parallel_do(pkg, width, batch, lr):
    fluid, layers, unique_name = pkg.fluid, pkg.layers, pkg.unique_name
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 19
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[width], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        places = layers.get_places()
        pd = layers.ParallelDo(places)
        with pd.do():
            x_, y_ = pd.read_input(x), pd.read_input(y)
            h = layers.fc(input=x_, size=width, act="relu")
            p = layers.fc(input=h, size=1)
            pd.write_output(layers.square_error_cost(input=p, label=y_))
        cost = layers.mean(pd())
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _build_dist_embedding(pkg, vocab, dim, batch, lr):
    fluid, layers, unique_name = pkg.fluid, pkg.layers, pkg.unique_name
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        lbl = layers.data(name="lbl", shape=[1], dtype="int64")
        emb = layers.embedding(ids, size=[vocab, dim], is_distributed=True,
                               param_attr=fluid.ParamAttr(name="table"))
        logits = layers.fc(input=emb, size=16)
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=logits, label=lbl))
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _parallel_small(torch):
    """layers.moe under plan_moe_ep() on dp=1,ep=1, a ParallelDo program,
    and a DistributeTranspiler -> mesh()/sharding_plan() run: each on the
    card under a ParallelExecutor against the CPU's plain Executor."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import plan_data_parallel, plan_moe_ep

    pkg = port_pkg()
    out = {}
    rng = np.random.RandomState(5)
    shape = (MOE["batch"], MOE["seq"], MOE["d_model"])
    moe_feeds = [{"x": rng.randn(*shape).astype(np.float32),
                  "y": rng.randn(*shape).astype(np.float32)}
                 for _ in range(SMALL_STEPS)]
    r = _card_vs_cpu(torch, fluid, _build_moe(pkg, **MOE), moe_feeds,
                     "dp=1,ep=1", plan_moe_ep(), "moe")
    w1 = r.pop("scope").find_var("moe0.experts.w1")
    r["experts_w1_placements"] = str(tuple(w1.placements))
    r["config"] = f"layers.moe {MOE}, plan_moe_ep() on dp=1,ep=1"
    out["moe"] = r
    pdo_feeds = []
    for _ in range(SMALL_STEPS):
        x = rng.randn(PDO["batch"], PDO["width"]).astype(np.float32)
        pdo_feeds.append({"x": x, "y": x[:, :1] * 0.5})
    r = _card_vs_cpu(torch, fluid, _build_parallel_do(pkg, **PDO),
                     pdo_feeds, "dp=1", plan_data_parallel(), "parallel_do")
    r.pop("scope")
    r["config"] = f"ParallelDo MLP {PDO}, plan_data_parallel() on dp=1"
    out["parallel_do"] = r
    built = _build_dist_embedding(pkg, **DIST_EMB)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=built[0], startup_program=built[1],
                trainers=1)
    emb_feeds = [{"ids": rng.randint(0, DIST_EMB["vocab"],
                                     (DIST_EMB["batch"], 1)).astype(np.int64),
                  "lbl": rng.randint(0, 16, (DIST_EMB["batch"], 1)).astype(
                      np.int64)} for _ in range(SMALL_STEPS)]
    r = _card_vs_cpu(torch, fluid, built, emb_feeds, t.mesh(devices=CARD),
                     t.sharding_plan(), "transpiler")
    table = r.pop("scope").find_var("table")
    r["table_placements"] = str(tuple(table.placements))
    r["config"] = (f"is_distributed embedding {DIST_EMB} -> "
                   "DistributeTranspiler.mesh()/sharding_plan()")
    out["transpiler"] = r
    return out


def parallel_phase(torch):
    """The seventeenth slice on the card: the Transformer NMT under
    ParallelExecutor (one card: a mesh of one device, the whole DTensor
    path), against the plain Executor in turns; then layers.moe,
    ParallelDo and the DistributeTranspiler handles, card vs CPU."""
    phase("parallel")
    t0 = time.perf_counter()
    out = {"transformer": _transformer_ways(torch)}
    log("  parallel transformer " + json.dumps({
        "ways": {w: {m: r.get(m) for m in (
            "p50_step_ms_after_first", "tokens_per_s", "step_ratio_p50",
            "step_ratio_in_turns", "first_step_ms", "loss_rel_err",
            "bitwise", "peak_gb", "launches_per_step")}
            | {"profile": {m: r["profile"].get(m) for m in (
                "wall_ms", "device_busy_ms", "busy_share",
                "device_launches")}}
            for w, r in out["transformer"]["ways"].items()},
        "collectives": out["transformer"]["collectives"],
        "placements": out["transformer"]["placements"]}))
    out["small"] = _parallel_small(torch)
    log("  parallel small " + json.dumps(out["small"]))
    out["seconds"] = time.perf_counter() - t0
    log(f"  parallel phase {out['seconds']:.1f} s")
    return out


# --- mesh serve: K4 on bf16 pages, the mesh-sharded decode engine, ---
# --- sharded checkpoints, sequence parallelism and GPipe regions     ---

# the sharded engine and its unsharded twin: the serve phase's geometry
# on the slot ladder's ends (the warm runs every shape of both)
MESH_SERVE = dict(slots=[1, 8], page_size=16, num_pages=513,
                  max_seq_len=1024, prefill_chunk=64)
MESH_NEW = 32            # new tokens a request
MESH_TURNS = 2           # turns of (sharded, unsharded) request batches
BF16_PAGED_TOL = 5e-6    # K4 bf16 against its plain version (unit-scale)
# card vs CPU logits through a bf16 pool, of the row's max |logit|: a K/V
# row computed on the card and on the CPU may round to neighbouring bf16
# values (one ulp, 2^-8 relative, in a few of 64 columns)
BF16_POOL_LOGIT_REL = 1e-3
BF16_POOL_STEPS = 4      # a 64-token prefill chunk, then 3 decode steps
SP_STEPS = 3             # Transformer-base steps a way (the parallel
# phase's); its losses against the plain step's: float32 attention math
# against K2/K3's 3xTF32, 1.3e-6 apart in a probe (dropout 0: a program
# with another `impl` attr draws other dropout masks, its step seed
# folding in the program)
SP_LOSS_RTOL = 1e-5
SP_DROPOUT = 0.0         # tests/test_sequence_parallel.py:191's
PIPE = dict(width=512, stages=4, batch=64, micro=4, lr=0.05, steps=3)
PIPE_RTOL = 1e-4         # the region's losses, card vs CPU (relative)
PAGED_BF16_PEAK = ("bf16 K/V page bytes + float32 Q/O over 3.35 TB/s "
                   "against float32 operations over 67 TFLOP/s")


def _bf16_cases():
    """K4 bf16's timed shapes (the kernel table's): decode B=8
    Hq=Hkv=16 D=64, a C=64 prefill chunk, the verify chunk B=8 C=5; then
    decode and a C=64 chunk at head_dim 264 and 512 (B=8, Hq=Hkv=4: the
    f32 wide rows' shapes), and at 520 (paged_wide_kernel)."""
    import numpy as np

    rng = np.random.RandomState(2031)
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    base = dict(D=64, ps=16, W=64, P=513, Hq=16, Hkv=16, B=8)
    wide = dict(base, Hq=4, Hkv=4)
    return {"decode": dict(base, C=None, kv_lens=lens, q_lens=None),
            "prefill": dict(base, C=64, kv_lens=lens, q_lens=[64] * 8),
            "verify": dict(base, C=5, kv_lens=lens, q_lens=[5] * 8),
            "decode_d264": dict(wide, D=264, C=None, kv_lens=lens,
                                q_lens=None),
            "decode_d512": dict(wide, D=512, C=None, kv_lens=lens,
                                q_lens=None),
            "prefill_d264": dict(wide, D=264, C=64, kv_lens=lens,
                                 q_lens=[64] * 8),
            "prefill_d512": dict(wide, D=512, C=64, kv_lens=lens,
                                 q_lens=[64] * 8),
            "decode_d520": dict(wide, D=520, C=None, kv_lens=lens,
                                q_lens=None),
            "prefill_d520": dict(wide, D=520, C=64, kv_lens=lens,
                                 q_lens=[64] * 8)}


def _paged_bf16_kernel(torch, pa):
    """(a) K4 on bf16 pages against its plain version on the card (max
    abs within BF16_PAGED_TOL; dead rows 0), bitwise across repeats, at
    the table's shapes; timed with its plain version and with SDPA on
    the K/V gathered and widened to float32 (the gather untimed), in
    turns; bound: the bf16 page bytes plus float32 Q/O."""
    import numpy as np

    rng = np.random.RandomState(2032)
    # the cases above head_dim 256 draw from their own stream, so the
    # earlier cases and the bf16-q check below keep their inputs
    wide_rng = np.random.RandomState(2034)
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rows, max_err = {}, 0.0
    for name, case in _bf16_cases().items():
        args = list(_paged_case(torch, wide_rng if case["D"] > 256 else rng,
                                **case))
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
        kw = dict(q_lens=args[5])
        kern = lambda: pa.paged_attention(*args[:5], **kw)  # noqa: E731
        ref = pa.paged_attention_reference(*args[:5], **kw)
        out = kern()
        again = kern()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if out.dtype != torch.float32 or not torch.isfinite(out).all():
            raise RuntimeError(f"K4 bf16 {name}: {out.dtype} output, "
                               "finite " f"{bool(torch.isfinite(out).all())}")
        if err > BF16_PAGED_TOL:
            raise RuntimeError(f"K4 bf16 {name}: max abs err {err:.3g} > "
                               f"{BF16_PAGED_TOL}")
        if not torch.equal(out, again):
            raise RuntimeError(f"K4 bf16 {name}: two launches differ")
        max_err = max(max_err, err)
        wide = (args[0], args[1].float(), args[2].float(), *args[3:])
        lib = _library_call(torch, wide, case)
        k_ms, l_ms, turns = _in_turns(torch, kern, lib, flush)
        row = {"ms": k_ms, "library_ms": l_ms,
               "ratio_kernel_over_sdpa": k_ms / l_ms,
               "turns_ms": {"kernel": turns[0], "sdpa": turns[1]},
               "plain_ms": _time_ms(torch, lambda: pa.paged_attention_reference(
                   *args[:5], **kw), flush),
               "max_abs_err": err, "bitwise_repeat": True,
               "host_us": _host_us(torch, kern)}
        bound = _bound(case, case["D"])
        # the pages move as bf16: half the K/V bytes of the f32 bound (K
        # and V, 2 bytes a value)
        kv = np.asarray(case["kv_lens"], np.int64)
        kv_bytes = 2 * 2 * int(kv.sum()) * case["Hkv"] * case["D"]
        C = case["C"] or 1
        nbytes = kv_bytes + 2 * case["B"] * C * case["Hq"] * case["D"] * 4 \
            + 4 * (case["B"] * case["W"] + 2 * case["B"])
        flops = 4 * case["D"] * case["Hq"] * sum(
            int(kv[b] - (case["q_lens"] or [1] * 8)[b] + j + 1)
            for b in range(case["B"])
            for j in range((case["q_lens"] or [1] * 8)[b]))
        row["bound_ms"], row["bound_by"] = _bound_of(nbytes, flops)
        row["bound_f32_pages_ms"] = bound["bound_ms"]
        row["bound_peak"] = PAGED_BF16_PEAK
        row["shape"] = (f"B={case['B']} C={C} Hq={case['Hq']} "
                        f"Hkv={case['Hkv']} D={case['D']} ps=16 W=64, bf16 "
                        "pages, f32 q")
        row["split_keys"] = pa.split_keys(case["D"])
        row["kv_lens"] = case["kv_lens"]
        rows[name] = row
        log(f"  K4 bf16 {name}: " + json.dumps(row))
    # bf16 q too: the output takes q's dtype
    case = _bf16_cases()["decode"]
    args = list(_paged_case(torch, rng, **case))
    args[0], args[1], args[2] = (args[0].bfloat16(), args[1].bfloat16(),
                                 args[2].bfloat16())
    out = pa.paged_attention(*args[:5])
    ref = pa.paged_attention_reference(*args[:5])
    if out.dtype != torch.bfloat16:
        raise RuntimeError(f"K4 bf16 q: output {out.dtype}, not bf16")
    ulp = (out.float() - ref.float()).abs().max().item() / \
        ref.float().abs().max().item() * 256
    if ulp > 1.0:
        raise RuntimeError(f"K4 bf16 q: {ulp:.2f} bf16 ulps of max|O| from "
                           "the plain version")
    rows["bf16_q_ulps_of_max"] = ulp
    del flush
    return max_err, rows


def _bf16_pool_steps(torch, pa):
    """(b) The serve phase's GPT-2-medium decoder stepped through a
    bfloat16 ``PagedKvCache`` by ``decoder_step_chunked`` (a 64-token
    prefill chunk beside a 40-token one, then greedy decode steps) on
    the card and on the CPU: logits within BF16_POOL_LOGIT_REL of the
    row's max, the same greedy tokens; K4 bf16 launched 24 times a step,
    the plain version never."""
    import numpy as np

    from paddle_tpu_torch.serving import decode as td
    from paddle_tpu_torch.serving.kv_cache import PagedKvCache

    spec = td.DecoderSpec(**GPT2_MEDIUM)
    rng = np.random.RandomState(2033)
    prompts = [[int(t) for t in rng.randint(0, spec.vocab, n)]
               for n in (64, 40)]
    out = {}
    for dev in ("cuda", "cpu"):
        params = td.build_decoder_params(spec, device=dev)
        cache = PagedKvCache(spec.n_layers, spec.n_kv_heads, spec.head_dim,
                             page_size=16, num_pages=16,
                             dtype=torch.bfloat16, device=dev)
        tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
        tokens = np.zeros((2, 64), np.int32)
        positions = np.zeros((2, 64), np.int32)
        for b, p in enumerate(prompts):
            tokens[b, :len(p)] = p
            positions[b, :len(p)] = np.arange(len(p))
        q_lens = np.array([len(p) for p in prompts], np.int32)
        kv_lens = q_lens.copy()
        logits, toks = [], []
        pa.counts.reset()
        t0 = time.perf_counter()
        for _ in range(BF16_POOL_STEPS):
            with torch.no_grad():
                k, v, lg = td.decoder_step_chunked(
                    params, spec, *(torch.from_numpy(a).to(dev) for a in (
                        tokens, positions, q_lens)), cache.k, cache.v,
                    torch.from_numpy(tables).to(dev),
                    torch.from_numpy(kv_lens).to(dev))
            cache.rebind(k, v)
            lg = lg.float().cpu()
            logits.append(lg)
            nxt = lg.argmax(-1).numpy()
            toks.append([int(x) for x in nxt])
            tokens = nxt[:, None].astype(np.int32)
            positions = kv_lens[:, None].astype(np.int32)
            q_lens = np.ones(2, np.int32)
            kv_lens = kv_lens + 1
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"logits": logits, "tokens": toks,
                    "s": time.perf_counter() - t0,
                    "launches": pa.counts.kernel_launches[pa.KERNEL_BF16],
                    "plain": pa.counts.plain_calls[pa.KERNEL_BF16]}
        del params, cache
    card, cpu = out["cuda"], out["cpu"]
    if card["launches"] != spec.n_layers * BF16_POOL_STEPS or \
            card["plain"]:
        raise RuntimeError(f"bf16 pool: K4 bf16 launches {card['launches']} "
                           f"!= {spec.n_layers} x {BF16_POOL_STEPS}, plain "
                           f"{card['plain']}")
    worst = max(((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()
                for a, b in zip(card["logits"], cpu["logits"]))
    if worst > BF16_POOL_LOGIT_REL:
        raise RuntimeError(f"bf16 pool: card logits {worst:.3g} x max|logit|"
                           f" from the CPU's (> {BF16_POOL_LOGIT_REL})")
    if card["tokens"] != cpu["tokens"]:
        raise RuntimeError(f"bf16 pool: card tokens {card['tokens']} != "
                           f"CPU {cpu['tokens']}")
    res = {"steps": BF16_POOL_STEPS, "worst_logit_rel": worst,
           "tokens": card["tokens"], "k4_bf16_launches": card["launches"],
           "launches_per_step": card["launches"] / BF16_POOL_STEPS,
           "card_s": card["s"], "cpu_s": cpu["s"],
           "pool": f"bf16 [{spec.n_layers}, 16, 16, 16, 64]"}
    log("  bf16 pool " + json.dumps(res))
    return res


def _local_map_k4_us(torch, mesh_engine, plain_engine):
    """K4 at the decode shape (B=8, 16 heads, 1024 keys) through the
    sharded engine's ``mesh_ops.paged_attention`` (the pool write and K4
    inside ``local_map``) and through the unsharded step's
    ``write_and_attend``, wall microseconds a call (n calls queued, one
    synchronize), in turns."""
    import numpy as np

    from paddle_tpu_torch.fluid.ops import mesh_ops
    from paddle_tpu_torch.serving.decode import write_and_attend
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rng = np.random.RandomState(2034)
    mesh = mesh_engine.cache.mesh
    B, H, D = 8, 16, 64
    tables = torch.arange(1, 65, dtype=torch.int32,
                          device="cuda").repeat(B, 1)
    kv = torch.full((B,), 1024, dtype=torch.int32, device="cuda")
    ql = torch.ones(B, dtype=torch.int32, device="cuda")
    # the writes land on the garbage page, as a dead lane's do
    page = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    off = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    q, k, v = (torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32))
               .cuda() for _ in range(3))
    pl = [Shard(2) if isinstance(p, Shard) else Replicate()
          for p in mesh_engine.cache.placements]
    qd, kd, vd = (DTensor.from_local(t, mesh, pl, run_check=False)
                  for t in (q, k, v))
    mk, mv = mesh_engine.cache.k, mesh_engine.cache.v
    pk, pv = plain_engine.cache.k, plain_engine.cache.v

    def sharded():
        return mesh_ops.paged_attention(mesh, qd, kd, vd, mk, mv, 0, page,
                                        off, tables, kv, ql)

    def plain():
        return write_and_attend(q, k, v, pk, pv, 0, page, off, tables, kv,
                                ql)

    turns = {"local_map": [], "direct": []}
    with torch.no_grad():
        for name in ("local_map", "direct", "direct", "local_map"):
            turns[name].append(_host_us(
                torch, sharded if name == "local_map" else plain))
    return {"local_map_us": statistics.mean(turns["local_map"]),
            "direct_us": statistics.mean(turns["direct"]),
            "turns_us": turns,
            "shape": "decode B=8 H=16 D=64, 1024 keys, the pool write "
                     "and K4 of one layer"}


def _mesh_engines(torch, pa):
    """(c) ``load_decoder(mesh_axes="tp=1")`` at GPT-2-medium beside the
    unsharded engine on one server: 8 concurrent requests to each, in
    turns; tokens held equal (the margin rule; bitwise reported), K4
    launches a target step through local_map (one a layer), p50 decode
    step ms
    of both, peak memory of the sharded one; and (d) its parameters
    saved with ``save_decoder_checkpoint(mesh_axes="tp=1",
    shard_axis="tp")`` and deployed back sharded from the recorded
    mesh."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.checkpoint import (read_manifest,
                                             save_decoder_checkpoint)
    from paddle_tpu_torch.observability import metrics, tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    steps_c = metrics.counter("serving.decode.target_steps")
    srv = ServingServer()
    addr = srv.serve()
    clients = [ServingClient(addr, timeout=900.0) for _ in range(8)]
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        pa.counts.reset()
        t0 = time.perf_counter()
        st = clients[0].load_decoder("gpt2tp", GPT2_MEDIUM,
                                     mesh_axes="tp=1", **MESH_SERVE)
        load_s = time.perf_counter() - t0
        peak_load = torch.cuda.max_memory_allocated() / 1e9
        if st["mesh"] != {"tp": 1}:
            raise RuntimeError(f"mesh engine stats mesh {st['mesh']}")
        clients[0].load_decoder("gpt2one", GPT2_MEDIUM, mesh_axes="",
                                **MESH_SERVE)
        rng = np.random.RandomState(2035)
        lens = [int(x) for x in rng.randint(32, 901, size=8)]
        prompts = [[int(t) for t in rng.randint(0, 50257, n)]
                   for n in lens]
        tracing.trace_reset()
        tracing.trace_enable()
        got = {"gpt2tp": [], "gpt2one": []}
        windows = {"gpt2tp": [], "gpt2one": []}
        walls = {"gpt2tp": [], "gpt2one": []}
        for turn in range(MESH_TURNS):
            for model in (("gpt2tp", "gpt2one") if turn % 2 == 0
                          else ("gpt2one", "gpt2tp")):
                pa.counts.reset()
                s0 = steps_c.value()
                torch.cuda.reset_peak_memory_stats()
                res, wall = _concurrent(clients, model, prompts, MESH_NEW)
                windows[model].append({
                    "steps": steps_c.value() - s0,
                    "launches": pa.counts.kernel_launches[pa.KERNEL],
                    "plain": pa.counts.plain_calls[pa.KERNEL],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
                walls[model].append(wall)
                got[model].append([r["tokens"] for r in res])
        tracing.trace_disable()
        for model, ws in windows.items():
            for w in ws:
                layers = GPT2_MEDIUM["n_layers"]
                if w["launches"] != layers * w["steps"] or w["plain"] or \
                        not w["steps"]:
                    raise RuntimeError(
                        f"{model}: K4 launches {w['launches']} != {layers} x "
                        f"{w['steps']} target steps (plain {w['plain']})")
        eng = srv.registry.get("gpt2tp")
        ref_eng = srv.registry.get("gpt2one")
        ref = got["gpt2one"][0]
        cuts = []
        bitwise = True
        for tokens in got["gpt2tp"] + got["gpt2one"][1:]:
            for i, (p, r, g) in enumerate(zip(prompts, ref, tokens)):
                if g != r:
                    bitwise = False
                    _hold_tokens(f"mesh engine request {i}", r, g,
                                 _margins(torch, ref_eng, p, r), cuts)
        dec = {m: [ms for ms in _spans(m, "serving.decode.step")]
               for m in got}
        mesh_rec = {
            "load_warm_s": load_s,
            "warm_shapes": len(st["compiled_shapes"]),
            "tokens_bitwise": bitwise, "margin_cuts": cuts,
            "k4_launches_per_target_step": windows["gpt2tp"][0]["launches"]
            / windows["gpt2tp"][0]["steps"],
            "windows": windows, "walls_s": walls,
            "p50_step_ms": {m: statistics.median(v) for m, v in dec.items()},
            "step_ratio_p50": statistics.median(dec["gpt2tp"])
            / statistics.median(dec["gpt2one"]),
            "tokens_per_s": {m: len(prompts) * MESH_NEW
                             / statistics.median(w)
                             for m, w in walls.items()},
            "peak_gb_load": peak_load,
            "kv_bytes": eng.cache.hbm_bytes,
            "kv_device_bytes": eng.cache.device_bytes,
            "pool_placements": [repr(p) for p in eng.cache.placements],
            "wq_placements": [repr(p) for p in
                              eng._params["layer0"]["wq"].placements]}
        mesh_rec["k4_local_map"] = _local_map_k4_us(torch, eng, ref_eng)
        log("  mesh engine " + json.dumps(mesh_rec))

        # (d) the sharded engine's parameters saved sharded, deployed back
        t0 = time.perf_counter()
        save_decoder_checkpoint(d, eng.spec, params=eng._params,
                                mesh_axes="tp=1", shard_axis="tp")
        save_s = time.perf_counter() - t0
        m = read_manifest(d)
        nbytes = sum(int(s["nbytes"]) for t in m["tensors"]
                     for s in t["segments"])
        t0 = time.perf_counter()
        st2 = clients[0].load_decoder("gpt2ck", checkpoint_dir=d,
                                      **MESH_SERVE)
        ck_load_s = time.perf_counter() - t0
        if st2["mesh"] != {"tp": 1}:
            raise RuntimeError(f"the recorded mesh deployed as {st2['mesh']}")
        again = clients[0].generate("gpt2ck", prompts[0],
                                    max_new_tokens=MESH_NEW)["tokens"]
        if again != ref[0]:
            _hold_tokens("checkpoint engine", ref[0], again,
                         _margins(torch, ref_eng, prompts[0], ref[0]), cuts)
        ck = {"save_s": save_s, "load_warm_s": ck_load_s, "bytes": nbytes,
              "shards": m["shards"], "payloads": len(m["payloads"]),
              "deployed_mesh": st2["mesh"],
              "tokens_equal": again == ref[0]}
        log("  mesh checkpoint " + json.dumps(ck))
        for model in ("gpt2tp", "gpt2one", "gpt2ck"):
            clients[0].unload_model(model)
        return mesh_rec, ck
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
        shutil.rmtree(d, ignore_errors=True)


def _sp_transformer(torch):
    """(e) Transformer-base (the parallel phase's program, seq_parallel)
    under ParallelExecutor on dp=1,sp=1 with plan_sequence_parallel(),
    ring and Ulysses, against the plain Executor from one state, SP_STEPS
    steps in turns: losses, p50 step ms and ratios. On one card the
    sequence axis holds one rank: ring_attention runs the ring's float32
    math (no kernel, as the JAX package's sequence path), no P2P."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import plan_sequence_parallel

    cfg = dict(TRANSFORMER_BASE, dropout=SP_DROPOUT)
    feed = copy_task_batch(TRAIN_BATCH, cfg)
    built = {"plain": build_transformer(cfg, 1e-4),
             "ring": build_transformer(cfg, 1e-4),
             "ulysses": build_transformer(dict(cfg, sp_impl="ulysses"),
                                          1e-4)}
    exe = _card_executor(fluid)
    base = fluid.Scope()
    exe.run(built["plain"][1], scope=base)
    scopes = {}
    for w in built:
        scopes[w] = fluid.Scope()
        for n in base.var_names():
            scopes[w].set_var(n, base.find_var(n).detach().clone())
    del base
    runners = {"plain": lambda: exe.run(built["plain"][0], feed=feed,
                                        fetch_list=[built["plain"][2]],
                                        scope=scopes["plain"])}
    for w in ("ring", "ulysses"):
        pe = _pe(fluid, scopes[w], built[w][0], built[w][2], "dp=1,sp=1",
                 plan_sequence_parallel())
        runners[w] = (lambda pe=pe, w=w: pe.run(fetch_list=[built[w][2]],
                                                feed=feed))
    res = {w: {"losses": [], "step_ms": []} for w in runners}
    for _ in range(SP_STEPS):
        for w, run in runners.items():
            t0 = time.perf_counter()
            (loss,), launches = _held_window(run)
            res[w]["step_ms"].append((time.perf_counter() - t0) * 1e3)
            res[w]["losses"].append(float(np.asarray(loss).reshape(-1)[0]))
            res[w]["launches"] = launches
    for w, r in res.items():
        r["p50_step_ms_after_first"] = statistics.median(r["step_ms"][1:])
        if not np.isfinite(r["losses"]).all():
            raise RuntimeError(f"sp {w}: losses {r['losses']}")
        if w == "plain":
            continue
        r["loss_rel_err"] = _rel_err(r["losses"], res["plain"]["losses"])
        if r["loss_rel_err"] > SP_LOSS_RTOL:
            raise RuntimeError(
                f"sp {w}: losses {r['losses']} vs the plain step's "
                f"{res['plain']['losses']} ({r['loss_rel_err']:.3g} > "
                f"{SP_LOSS_RTOL})")
        r["step_ratio_in_turns"] = statistics.median(
            a / b for a, b in zip(r["step_ms"][1:],
                                  res["plain"]["step_ms"][1:]))
        r["first_step_ms"] = r["step_ms"][0]
    res["attention_vs_k2"] = _ring_vs_k2(torch)
    log("  sp transformer " + json.dumps(res))
    return res


def _ring_vs_k2(torch):
    """The ring's float32 math (one rank, no collective) and K2 on the
    same [16, 512, 8, 64] causal Q/K/V: max abs difference, and each
    against float64."""
    import numpy as np

    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.parallel.sequence_parallel import (
        ring_attention_shard)

    rng = np.random.RandomState(2037)
    q, k, v = (torch.from_numpy(rng.randn(TRAIN_BATCH, SEQ, N_HEADS,
                                          D_MODEL // N_HEADS)
                                .astype(np.float32)).cuda()
               for _ in range(3))
    with torch.no_grad():
        ring = ring_attention_shard(q, k, v, None, True)
        k2 = flash_attention(q, k, v, causal=True)
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * \
            (q.shape[-1] ** -0.5)
        s = s.masked_fill(~torch.ones(SEQ, SEQ, dtype=torch.bool,
                                      device="cuda").tril(), float("-inf"))
        exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                             v.double())
    return {"ring_vs_k2": (ring - k2).abs().max().item(),
            "ring_vs_float64": (ring - exact).abs().max().item(),
            "k2_vs_float64": (k2 - exact).abs().max().item()}


def _build_pipe(pkg, width, stages, micro, lr):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 37
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[width], dtype="float32")
        y = layers.data(name="y", shape=[width], dtype="float32")
        pipe = layers.Pipeline(x, n_microbatches=micro)
        with pipe.block():
            h = pipe.input
            for s in range(stages):
                h = layers.fc(input=h, size=width, act="tanh")
                if s < stages - 1:
                    h = pipe.cut(h)
        out = pipe.output(h)
        cost = layers.mean(layers.square_error_cost(input=out, label=y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _pipeline_region(torch):
    """(f) A ``layers.Pipeline`` region (PIPE: 512 wide, 4 stages of fc +
    tanh, 4 microbatches, SGD) under a ParallelExecutor on pp=1 (the
    stages in sequence) on the card, against the CPU's plain Executor
    from the same state: losses within PIPE_RTOL."""
    import numpy as np

    feeds = []
    rng = np.random.RandomState(2036)
    for _ in range(PIPE["steps"]):
        x = rng.rand(PIPE["batch"], PIPE["width"]).astype(np.float32)
        feeds.append({"x": x, "y": np.tanh(x[:, ::-1].copy())})
    built = _build_pipe(port_pkg(), PIPE["width"], PIPE["stages"],
                        PIPE["micro"], PIPE["lr"])
    out = _card_vs_cpu(torch, port_pkg().fluid, built, feeds, "pp=1", None,
                       "pipeline region")
    del out["scope"]
    if out["rel_err"] > PIPE_RTOL:
        raise RuntimeError(f"pipeline region: card vs CPU losses "
                           f"{out['rel_err']:.3g} > {PIPE_RTOL}")
    log("  pipeline region " + json.dumps(out))
    return out


def mesh_serve_phase(torch):
    """The eighteenth slice on the card: K4 on bf16 pages (a), a
    GPT-2-medium decoder through a bf16 pool (b), the mesh-sharded
    decode engine on tp=1 beside the unsharded one (c) and its sharded
    checkpoint (d), the seq_parallel Transformer on dp=1,sp=1 (e), a
    GPipe region on pp=1 (f). One card: every mesh is a mesh of one
    device; the CPU tests hold the multi-rank behaviour."""
    phase("mesh serve")
    from paddle_tpu_torch.kernels import paged_attention as pa

    t0 = time.perf_counter()
    out = {}
    out["k4_bf16_err"], out["k4_bf16"] = _paged_bf16_kernel(torch, pa)
    out["bf16_pool"] = _bf16_pool_steps(torch, pa)
    out["engine"], out["checkpoint"] = _mesh_engines(torch, pa)
    out["sp_transformer"] = _sp_transformer(torch)
    out["pipeline"] = _pipeline_region(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"  mesh serve phase {out['seconds']:.1f} s")
    return out


# --- pserver: parameter-server training --------------------------------------

# (a) Transformer-base through two pservers: the train phase's config with
# dropout 0 (the trainer program's bytes differ from the plain program's,
# and so would its dropout masks), batch TRAIN_BATCH, Adam(1e-4), sync,
# one trainer; PSERVER_STEPS steps of the plain Executor and of the
# trainer in turns from the same state. The losses are held within
# PSERVER_LOSS_RTOL: the same forward and backward kernels on the same
# parameters, and the same Adam op on the same card, applied on the
# pserver to the gradient that went to the host and back unchanged.
PSERVER_STEPS = 3
PSERVER_LOSS_RTOL = 1e-6
PSERVER_LAUNCHES = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
                    "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18}
# (b) the sparse phase's program at V 1,000,000 (SPARSE, Adam) with the
# table is_distributed on one async pserver; the card's losses against
# the port's on the CPU from the same state within PSERVER_SPARSE_RTOL
PSERVER_SPARSE_STEPS = 6
PSERVER_SPARSE_RTOL = 1e-5
# (c) memory_optimize + release_memory on the fused ResNet-50 at a static
# batch of INFER_BATCH, plain and rewritten in PSERVER_MEM_TURNS turns
PSERVER_MEM_TURNS = 3
# (d) the kernels the profiler's exported trace must name
PSERVER_TRACE_KERNELS = ("layer_norm_kernel", "flash_fwd_kernel",
                         "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rpc_bytes():
    """(bytes sent, bytes received) by this process's RPC clients."""
    from paddle_tpu_torch.observability import metrics

    snap = metrics.snapshot("rpc.client.bytes_")
    return snap["rpc.client.bytes_out"], snap["rpc.client.bytes_in"]


def _span_ms(names):
    """Host ms of the buffered trace spans of each name."""
    from paddle_tpu_torch.observability import tracing

    out = {n: 0.0 for n in names}
    for ev in tracing.trace_events():
        if ev.get("ph") == "X" and ev["name"] in out:
            out[ev["name"]] += ev["dur"] / 1e3
    return out


def _pservers(fluid, main, startup, n, sync, device, init=None):
    """Transpile (trainer 0 of 1) onto ``n`` loopback endpoints and start
    their pservers on ``device``; with ``init``, every var of a pserver's
    scope that ``init`` names is set to that value."""
    import torch

    eps = [f"127.0.0.1:{_free_port()}" for _ in range(n)]
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, startup_program=startup,
                pservers=",".join(eps), trainers=1, sync_mode=sync)
    servers = []
    try:
        for ep in eps:
            servers.append(t.start_pserver(
                ep, port=int(ep.rsplit(":", 1)[1]), device=device))
        for ps in servers:
            for name in ps._scope.var_names():
                if init is not None and name in init:
                    ps._scope.set_var(name, torch.as_tensor(
                        init[name]).to(device).clone())
    except Exception:
        for ps in servers:
            ps.shutdown()
        raise
    return t, servers


def _pserver_transformer(torch):
    """(a): the step, its bytes, its transport ms and its launches."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.observability import tracing

    cfg = dict(TRANSFORMER_BASE, dropout=0.0)
    main, startup, cost, pg = build_transformer(cfg, 1e-4)
    feed = copy_task_batch(TRAIN_BATCH, cfg)
    exe, plain_scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=plain_scope)
    init = {n: plain_scope.find_var(n).clone()
            for n in plain_scope.var_names()
            if isinstance(plain_scope.find_var(n), torch.Tensor)}
    param_bytes = sum(init[p.name].numel() * init[p.name].element_size()
                      for p, _ in pg)
    t0 = time.perf_counter()
    t, servers = _pservers(fluid, main, startup, 2, True, CARD, init)
    start_s = time.perf_counter() - t0
    try:
        owned = {ep: ps.owned_params() for ep, ps in
                 zip(t.pserver_endpoints, servers)}
        if not all(owned.values()) or any(
                ps.device.type != CARD for ps in servers):
            raise RuntimeError(f"pservers: {owned}")
        trainer = t.get_trainer_program(send_recv=True)
        kinds = [op.type for op in trainer.global_block().ops]
        if kinds[0] != "recv" or kinds[-1] != "send" or "adam" in kinds:
            raise RuntimeError(f"trainer program ops {kinds[:3]} ... "
                               f"{kinds[-3:]}")
        tscope = fluid.Scope()
        exe.run(startup, scope=tscope)
        losses = {"plain": [], "pserver": []}
        ms = {"plain": [], "pserver": []}
        sent, recvd, launches, spans = [], [], [], []
        tracing.trace_enable()
        for _ in range(PSERVER_STEPS):
            for way, prog, scope in (("plain", main, plain_scope),
                                     ("pserver", trainer, tscope)):
                if way == "pserver":
                    _reset_kernel_counts()
                    b0 = _rpc_bytes()
                    tracing.trace_reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (loss,) = exe.run(prog, feed=feed, fetch_list=[cost],
                                  scope=scope)
                ms[way].append((time.perf_counter() - t0) * 1e3)
                losses[way].append(float(np.asarray(loss).reshape(-1)[0]))
                if way == "pserver":
                    b1 = _rpc_bytes()
                    sent.append(b1[0] - b0[0])
                    recvd.append(b1[1] - b0[1])
                    spans.append(_span_ms(("executor.recv",
                                           "executor.send")))
                    got, plain = _kernel_counts()
                    if any(plain.values()):
                        raise RuntimeError(f"plain versions ran on the "
                                           f"card's main path: {plain}")
                    launches.append({k: got.get(k, 0)
                                     for k in PSERVER_LAUNCHES})
        tracing.trace_disable()
        for step in launches:
            if step != PSERVER_LAUNCHES:
                raise RuntimeError(f"pserver trainer step launches {step}, "
                                   f"want {PSERVER_LAUNCHES}")
        err = _rel_err(losses["pserver"], losses["plain"])
        if not err <= PSERVER_LOSS_RTOL or not all(
                np.isfinite(losses["pserver"])):
            raise RuntimeError(f"pserver losses {losses['pserver']} against "
                               f"the plain {losses['plain']}: rel err {err}")
        stats = [ps.stats() for ps in servers]
        if sum(st["steps"] for st in stats) != PSERVER_STEPS * len(pg):
            raise RuntimeError(f"pserver applies {stats}, want "
                               f"{len(pg)} a step")
        p50 = statistics.median(ms["pserver"][1:])
        out = {
            "config": "transformer-base (the train phase's, dropout 0), "
                      f"batch {TRAIN_BATCH}, Adam(1e-4), 2 pservers on the "
                      "card in this process, sync, 1 trainer",
            "pservers_start_s": start_s,
            "owned_params": {ep: len(v) for ep, v in owned.items()},
            "losses": losses, "loss_max_rel_err": err,
            "step_ms": ms, "p50_step_ms_after_first": p50,
            "plain_p50_step_ms_after_first": statistics.median(
                ms["plain"][1:]),
            "pserver_over_plain_p50": p50 / statistics.median(
                ms["plain"][1:]),
            "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
            "param_bytes": param_bytes,
            "rpc_bytes_sent_a_step": sent, "rpc_bytes_received_a_step": recvd,
            "sent_over_param_bytes": statistics.median(sent) / param_bytes,
            "received_over_param_bytes": statistics.median(recvd)
            / param_bytes,
            "transport_ms_a_step": spans,
            "launches_per_step": launches[-1], "pserver_stats": stats,
        }
        out["profile"] = profile_step(torch, exe, trainer, feed, cost, tscope,
                                      "pserver trainer step")
        out["fluid_profiler"] = _fluid_profiled_step(
            torch, exe, main, feed, cost, plain_scope)
    finally:
        for ps in servers:
            ps.shutdown()
    log("  pserver transformer " + json.dumps(
        {k: v for k, v in out.items() if k not in ("profile",)}))
    return out


def _fluid_profiled_step(torch, exe, main, feed, cost, scope):
    """(d): one plain Transformer-base step under fluid.profiler; the
    exported trace must name K1, K2, K3a and K3b."""
    import paddle_tpu_torch.fluid as fluid

    path = os.path.join(REPO, "smoke_out", "pserver_profile.json")
    t0 = time.perf_counter()
    with fluid.profiler.profiler("All", profile_path=path):
        with fluid.profiler.RecordEvent("transformer_step"):
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    named = {k: sum(1 for ev in events if k in str(ev.get("name", ""))
                    and ev.get("cat") == "kernel")
             for k in PSERVER_TRACE_KERNELS}
    spans = {k: sum(1 for ev in events if ev.get("name") == k)
             for k in ("transformer_step", "executor.step")}
    if not all(named.values()) or not all(spans.values()):
        raise RuntimeError(f"fluid.profiler trace names {named} {spans}")
    out = {"path": os.path.relpath(path, REPO), "events": len(events),
           "kernel_events": named, "spans": spans, "wall_ms": wall_ms,
           "bytes": os.path.getsize(path)}
    log("  pserver fluid.profiler " + json.dumps(out))
    return out


def _pserver_sparse(torch):
    """(b): the V 1,000,000 table on one async pserver, card and CPU from
    the same state, and the in-process sparse step in turns."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    pkg, vocab = port_pkg(), SPARSE_VOCABS[1]
    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(PSERVER_SPARSE_STEPS):
        ids = _zipf_ids(rng, vocab, (SPARSE["batch"], 1))
        feeds.append({"ids": ids, "label": ids % SPARSE["classes"]})
    runs, init = {}, None
    for device in ("cpu", CARD):
        built = build_sparse_embedding(pkg, vocab, True, "adam",
                                       is_distributed=True, **SPARSE)
        t, (ps,) = _pservers(fluid, built["main"], built["startup"], 1,
                             False, device, init)
        try:
            if init is None:
                init = {n: ps._scope.find_var(n).clone()
                        for n in ps._scope.var_names()
                        if isinstance(ps._scope.find_var(n), torch.Tensor)}
            prog = t.get_trainer_program(send_recv=True)
            kinds = [op.type for op in prog.global_block().ops]
            if kinds[0] != "prefetch" or kinds[-1] != "send":
                raise RuntimeError(f"sparse trainer ops {kinds}")
            exe, scope = fluid.Executor(device), fluid.Scope()
            exe.run(t.get_trainer_startup_program(), scope=scope)
            if scope.find_var("sparse_emb") is not None:
                raise RuntimeError("the trainer holds the table")
            run = {"losses": [], "step_ms": [], "bytes_a_step": []}
            inproc = None
            if device == CARD:
                inproc = build_sparse_embedding(pkg, vocab, True, "adam",
                                                **SPARSE)
                iscope = fluid.Scope()
                exe.run(inproc["startup"], scope=iscope)
                for n, v in init.items():
                    if iscope.find_var(n) is not None:
                        iscope.set_var(n, v.to(device).clone())
                run["inproc_losses"], run["inproc_step_ms"] = [], []
            for feed in feeds:
                b0 = _rpc_bytes()
                if device == CARD:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                (loss,) = exe.run(prog, feed=feed, fetch_list=[
                    built["cost"]], scope=scope)
                run["step_ms"].append((time.perf_counter() - t0) * 1e3)
                b1 = _rpc_bytes()
                run["bytes_a_step"].append(b1[0] - b0[0] + b1[1] - b0[1])
                run["losses"].append(float(np.asarray(loss).reshape(-1)[0]))
                if inproc is not None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (loss,) = exe.run(inproc["main"], feed=feed, fetch_list=[
                        inproc["cost"]], scope=iscope)
                    run["inproc_step_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
                    run["inproc_losses"].append(
                        float(np.asarray(loss).reshape(-1)[0]))
            run["stats"] = ps.stats()
            runs[device] = run
        finally:
            ps.shutdown()
    card, cpu = runs[CARD], runs["cpu"]
    err = _rel_err(card["losses"], cpu["losses"])
    if not err <= PSERVER_SPARSE_RTOL or not all(np.isfinite(card["losses"])):
        raise RuntimeError(f"sparse pserver losses card {card['losses']} vs "
                           f"cpu {cpu['losses']}: rel err {err}")
    rows = [int(np.unique(f["ids"]).size) for f in feeds]
    table_bytes = vocab * SPARSE["dim"] * 4
    st = card["stats"]
    if st["prefetch_rows"] != PSERVER_SPARSE_STEPS * SPARSE["batch"] or \
            st["full_pull_rows"] >= vocab // 50:
        raise RuntimeError(f"sparse pserver traffic {st}")
    p50 = statistics.median(card["step_ms"][1:])
    out = {"config": f"V {vocab} x {SPARSE['dim']}, is_distributed, Adam, "
                     f"{SPARSE}, 1 async pserver in this process",
           "losses_card": card["losses"], "losses_cpu": cpu["losses"],
           "card_vs_cpu_max_rel_err": err,
           "inproc_losses": card["inproc_losses"],
           "pserver_vs_inproc_max_rel_err": _rel_err(
               card["losses"], card["inproc_losses"]),
           "step_ms": card["step_ms"], "p50_step_ms_after_first": p50,
           "inproc_step_ms": card["inproc_step_ms"],
           "inproc_p50_step_ms_after_first": statistics.median(
               card["inproc_step_ms"][1:]),
           "cpu_p50_step_ms_after_first": statistics.median(
               cpu["step_ms"][1:]),
           "bytes_a_step": card["bytes_a_step"], "table_bytes": table_bytes,
           "bytes_over_table": statistics.median(card["bytes_a_step"])
           / table_bytes,
           "unique_ids_a_step": rows, "ids_a_step": SPARSE["batch"],
           "pserver_stats": st}
    log("  pserver sparse " + json.dumps(out))
    return out


def _pserver_memory(torch):
    """(c): memory_optimize + release_memory on the fused ResNet-50 at a
    static batch: logits equal, peak device memory of each program in
    turns beside estimate_peak_bytes."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import memory_optimization_transpiler as mot

    plain, startup, logits, prob = build_resnet50(1, INFER_BATCH)
    opt, _, ologits, oprob = build_resnet50(1, INFER_BATCH)
    skip = {ologits.name, oprob.name}
    merged = fluid.memory_optimize(opt, skip_opt_set=skip)
    deleted = fluid.release_memory(opt, skip_opt_set=skip)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    seeded_bn_fold(torch, plain, scope, seed=2)
    feed = {"img": torch.from_numpy(_images(np.random.RandomState(3),
                                            INFER_BATCH)).to(CARD)}
    peaks = {"plain": [], "rewritten": []}
    got, launches = {}, {}
    for _ in range(PSERVER_MEM_TURNS):
        for way, prog, var in (("plain", plain, logits),
                               ("rewritten", opt, ologits)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (out, run_launches) = _held_window(lambda: exe.run(
                prog, feed=feed, fetch_list=[var], scope=scope))
            torch.cuda.synchronize()
            peaks[way].append((torch.cuda.max_memory_allocated() - base)
                              / 1e9)
            got[way], launches[way] = out[0], run_launches
    diff = float(np.abs(got["rewritten"] - got["plain"]).max())
    if diff != 0.0 or launches["rewritten"] != launches["plain"]:
        raise RuntimeError(f"memory_optimize changed the logits (max abs "
                           f"{diff}) or the launches {launches}")
    out = {"batch": INFER_BATCH, "merged_vars": merged,
           "delete_var_ops": deleted,
           "estimate_peak_gb": {"plain": mot.estimate_peak_bytes(plain) / 1e9,
                                "rewritten": mot.estimate_peak_bytes(opt)
                                / 1e9},
           "peak_above_state_gb": peaks,
           "median_peak_above_state_gb": {
               k: statistics.median(v) for k, v in peaks.items()},
           "logits_max_abs_diff": diff, "launches": launches["plain"]}
    log("  pserver memory_optimize " + json.dumps(out))
    return out


def pserver_phase(torch):
    """The nineteenth slice on the card: parameter-server training, with
    the trainer and the pservers as threads of this process on the one
    card. (a) Transformer-base through two sync pservers against the
    plain Executor in turns; (b) a V 1,000,000 distributed table on an
    async pserver, card against the CPU, beside the in-process sparse
    step; (c) memory_optimize + release_memory on ResNet-50 inference;
    (d) one Transformer-base step under fluid.profiler, its trace naming
    K1-K3b."""
    phase("pserver")
    t0 = time.perf_counter()
    out = {"transformer": _pserver_transformer(torch),
           "sparse": _pserver_sparse(torch),
           "memory_optimize": _pserver_memory(torch)}
    out["seconds"] = time.perf_counter() - t0
    log(f"  pserver phase {out['seconds']:.1f} s")
    return out


# --- the serving fleet ---------------------------------------------------

FLEET_LEASE = 10.0       # replica lease (s); in-process members beat 0.5 s
FLEET_NEW = 32           # new tokens a routed request (the serve phase's)
FLEET_TURNS = 2          # turns of each side / of (static, auto)
FLEET_LATENCY = 40       # sequential 4-token requests a side (p50)
FLEET_SHORT = 16         # prompt tokens of the turns' and bursts' requests
# a ResNet-50 request-size stream (images a request) constructed to
# exercise the ladder DP, not drawn from users' traffic: lumpy, so the
# geometric 1/2/4/8/16 ladder pads most requests
FLEET_SIZES = (1, 3, 3, 5, 5, 5, 6, 6, 6, 6, 12, 12)
FLEET_STREAM = 40        # requests of that stream (>= 32: enough to derive)
# concurrent decode requests a burst: the slot demand slots="auto" learns
FLEET_BURSTS = (3, 3, 6, 3, 6, 3, 3, 6, 3, 6)
FLEET_AUTO_BUCKETS = 3   # entries a derived ladder may have
FLEET_PIN = 990001       # sequence id that pins a replica's KV pool


def _fleet_counts(mod):
    """(kernel launches, plain calls) of K4 (``pa``) or K5 (``k5``)."""
    return (mod.counts.kernel_launches[mod.KERNEL],
            mod.counts.plain_calls[mod.KERNEL])


def _fleet_engines(servers, model):
    return [srv.registry.get(model) for srv in servers]


def _logged(cmd, path):
    """A replica command whose output is appended to ``path``."""
    return ["bash", "-c", 'exec "$@" >> "$0" 2>&1', path] + list(cmd)


def _get_json(addr, path):
    import urllib.request

    host, port = addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=60) as r:
        body = r.read().decode()
    return json.loads(body) if path != "/metrics" else body


def fleet_phase(torch, serve_ref):
    """The serving control plane on the card: a FleetController, two
    in-process ServingServers joined by FleetMembers, a FleetRouter, a
    RolloutDriver, the autotune layer, a ReplicaLauncher's replica
    process, the debug server and the timeline tool, at the serve
    phase's width (GPT-2-medium, page 16, 513 pages, chunk 64) and the
    infer phase's fused ResNet-50."""
    phase("fleet")
    import contextlib
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import autotune
    from paddle_tpu_torch.checkpoint import save_decoder_checkpoint
    from paddle_tpu_torch.fleet import (FleetController, FleetMember,
                                        FleetRouter, ReplicaLauncher,
                                        RolloutDriver, decoder_artifact,
                                        model_artifact)
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import (debug_server, metrics,
                                                timeline, tracing)
    from paddle_tpu_torch.serving import (ServerOverloaded, ServingClient,
                                          ServingServer)
    from paddle_tpu_torch.serving.decode import DecoderSpec

    t_phase = time.perf_counter()
    layers = GPT2_MEDIUM["n_layers"]  # K4 launches a target step
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    prompts, ref = serve_ref["prompts"], serve_ref["tokens"]
    rng = np.random.RandomState(23)
    out = {}

    def fresh(n):
        return [[int(t) for t in rng.randint(0, GPT2_MEDIUM["vocab"],
                                             FLEET_SHORT)]
                for _ in range(n)]

    def counter(name):
        return metrics.counter(name).value()

    stack = contextlib.ExitStack()
    try:
        # the debug server first: every server and the controller below
        # registers its /statusz section when it serves
        dbg = debug_server.ensure_shared(device=CARD)
        stack.callback(debug_server.stop_shared)
        tracing.trace_reset()
        tracing.trace_enable()
        stack.callback(tracing.trace_disable)

        # (a) rollout: checkpoint -> canary r0 -> gate -> intent -> r1
        ck = os.path.join(tmp, "gpt2m")
        t0 = time.perf_counter()
        save_decoder_checkpoint(ck, DecoderSpec(**GPT2_MEDIUM))
        out["checkpoint_save_s"] = time.perf_counter() - t0
        ctl = FleetController(lease_ttl=FLEET_LEASE)
        addr = ctl.serve()
        stack.callback(ctl.shutdown)
        servers, members = [], []
        for i in range(2):
            srv = ServingServer(device=CARD)
            srv.serve()
            stack.callback(srv.shutdown, drain=False)
            servers.append(srv)
            m = FleetMember(srv, addr, replica_id=f"r{i}",
                            beat_interval=0.5)
            stack.callback(m.stop, deregister=False)
            members.append(m)
        tracing.set_process_label("chip_smoke fleet")
        if not all(m.wait_registered(60.0) for m in members):
            raise RuntimeError("replicas did not register")
        # scrape TTL 0: every routing reads the replicas' load reports
        # anew, which the pinned-pool, shed, failover and spawn steps need
        router = FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0,
                             timeout=900.0)
        stack.callback(router.close)
        # the router a deployment runs: FLAGS' scrape TTL, the default
        # replica TTL
        router_default = FleetRouter(addr, timeout=900.0)
        stack.callback(router_default.close)
        drv = RolloutDriver(addr, timeout=900.0)
        t0 = time.perf_counter()
        s1 = drv.rollout(
            "gpt2m", decoder_artifact(checkpoint_dir=ck, **SERVE),
            canary="r0", converge_timeout=600.0,
            probe=lambda cli: cli.generate("gpt2m", prompts[0][:16],
                                           max_new_tokens=2))
        out["rollout_s"] = time.perf_counter() - t0
        if sorted(s1["converged"]) != ["r0", "r1"] or s1["skipped"]:
            raise RuntimeError(f"rollout did not converge: {s1}")
        log(f"  rollout gpt2m v{s1['version']} canary {s1['canary']} -> "
            f"{s1['converged']} in {out['rollout_s']:.2f} s (checkpoint "
            f"saved in {out['checkpoint_save_s']:.2f} s)")

        def steps():
            return [e.stats()["steps"]
                    for e in _fleet_engines(servers, "gpt2m")]

        def routed():
            return [counter(f"fleet.routed.r{i}") for i in range(2)]

        # (b) the serve phase's 8 prompts through the router at once
        s0, rt0 = steps(), routed()
        pa.counts.reset()
        results, wall = _concurrent([router], "gpt2m", prompts, FLEET_NEW)
        launches, plain = _fleet_counts(pa)
        d_steps = [b - a for a, b in zip(s0, steps())]
        d_routed = [b - a for a, b in zip(rt0, routed())]
        # the window ends here
        got = [r["tokens"] for r in results]
        if got != ref:
            bad = [i for i, (g, w) in enumerate(zip(got, ref)) if g != w]
            raise RuntimeError(f"router tokens differ from the serve "
                               f"phase's on prompts {bad}")
        if launches != layers * sum(d_steps) or launches == 0 or plain:
            raise RuntimeError(f"K4 launches {launches} != {layers} x "
                               f"{d_steps} target steps (plain {plain})")
        out["routing"] = {"wall_s": wall,
                          "tokens_per_s": 8 * FLEET_NEW / wall,
                          "routed": d_routed, "target_steps": d_steps,
                          "k4_launches": launches,
                          "tokens_bitwise_serve_phase": True}
        log(f"  8 routed requests: {d_routed} to r0/r1, tokens bitwise "
            f"the serve phase's, {launches} K4 launches = {layers} x "
            f"{sum(d_steps)} target steps, {wall:.2f} s")

        # the routers against direct ServingClient calls, in turns: to
        # r0 alone, and split over r0 and r1 (the TTL-0 router's split)
        direct = [ServingClient(servers[0].address, timeout=900.0)
                  for _ in range(8)]
        direct_r1 = [ServingClient(servers[1].address, timeout=900.0)
                     for _ in range(4)]
        for c in direct + direct_r1:
            stack.callback(c.close)
        sides = {"router": [router_default], "router_ttl0": [router],
                 "direct": direct,
                 "direct_split": [c for pair in zip(direct[:4], direct_r1)
                                  for c in pair]}
        turns = {k: {"tokens_per_s": [], "target_steps_r0_r1": [],
                     "routed_r0_r1": [], "step_ms_p50": [],
                     "steps_by_engine_thread": []} for k in sides}

        def last_ts():
            return max((e["ts"] for e in tracing.trace_events()),
                       default=0.0)

        for t in range(FLEET_TURNS):
            order = list(sides) if t % 2 == 0 else list(sides)[::-1]
            for side in order:
                s0, rt0, ts0 = steps(), routed(), last_ts()
                _r, w = _concurrent(sides[side], "gpt2m", fresh(8),
                                    FLEET_NEW)
                # the window's decode steps, by scheduler thread (one a
                # busy engine)
                by_tid = {}
                for ev in tracing.trace_events():
                    if ev["ts"] > ts0 and \
                            ev.get("name") == "serving.decode.step" and \
                            ev["args"].get("model") == "gpt2m":
                        by_tid.setdefault(ev["tid"], []).append(
                            ev["dur"] / 1e3)
                rec = turns[side]
                rec["tokens_per_s"].append(8 * FLEET_NEW / w)
                rec["target_steps_r0_r1"].append(
                    [b - a for a, b in zip(s0, steps())])
                rec["routed_r0_r1"].append(
                    [b - a for a, b in zip(rt0, routed())])
                rec["step_ms_p50"].append(statistics.median(
                    [d for v in by_tid.values() for d in v]))
                rec["steps_by_engine_thread"].append(
                    sorted((len(v) for v in by_tid.values()), reverse=True))
        # sequential 4-token requests: each router's route ms (the
        # ranking alone, from fleet.route_ms's exact sum) and the
        # default router's added p50 against direct calls to r0
        lat = {"router": [], "router_ttl0": [], "direct": []}
        route = {"router": [], "router_ttl0": []}
        hist = metrics.histogram("fleet.route_ms")
        for i in range(FLEET_LATENCY):
            for side in (list(lat) if i % 2 == 0 else list(lat)[::-1]):
                cli = sides[side][0]
                (p,) = fresh(1)
                h0 = hist.value()["sum"]
                t0 = time.perf_counter()
                cli.generate("gpt2m", p, max_new_tokens=4)
                lat[side].append((time.perf_counter() - t0) * 1e3)
                if side in route:
                    route[side].append(hist.value()["sum"] - h0)

        def pct(v, q):
            v = sorted(v)
            return v[min(len(v) - 1, int(q * len(v)))]

        out["router_vs_direct"] = {
            "turns": turns,
            "p50_request_ms": {k: statistics.median(v)
                               for k, v in lat.items()},
            "p25_p75_request_ms": {k: [pct(v, 0.25), pct(v, 0.75)]
                                   for k, v in lat.items()},
            "added_p50_ms": {k: statistics.median(lat[k])
                             - statistics.median(lat["direct"])
                             for k in route},
            "route_ms_p50": {k: statistics.median(v)
                             for k, v in route.items()},
            "route_ms_p95": {k: pct(v, 0.95) for k, v in route.items()},
            "requests_a_side": FLEET_LATENCY,
        }
        log("  routers vs direct (in turns) " +
            json.dumps(out["router_vs_direct"]))

        # (c) decode-aware routing: each replica alone takes the traffic
        # while the other's pool is pinned full; both full -> shed
        allocs = [e.cache.allocator for e in _fleet_engines(servers,
                                                            "gpt2m")]

        def pin(i):
            a = allocs[i]
            a.alloc(FLEET_PIN + i, a.pages_free * a.page_size)

        def unpin(i):
            allocs[i].free(FLEET_PIN + i)

        per_replica = {}
        for full, free in ((0, 1), (1, 0)):
            pin(full)
            try:
                s0, rt0 = steps(), routed()
                pa.counts.reset()
                res, _w = _concurrent([router], "gpt2m", prompts[:4], 8)
                launches, plain = _fleet_counts(pa)
                d_steps = [b - a for a, b in zip(s0, steps())]
                d_routed = [b - a for a, b in zip(rt0, routed())]
            finally:
                unpin(full)
            if d_routed[full] or d_routed[free] != 4 or d_steps[full]:
                raise RuntimeError(f"pinned r{full} still took work: "
                                   f"routed {d_routed}, steps {d_steps}")
            if launches != layers * d_steps[free] or launches == 0 or plain:
                raise RuntimeError(f"r{free}: K4 launches {launches} != "
                                   f"{layers} x {d_steps[free]} (plain "
                                   f"{plain})")
            if [r["tokens"] for r in res] != [t[:8] for t in ref[:4]]:
                raise RuntimeError(f"r{free}'s tokens differ")
            per_replica[f"r{free}"] = {
                "k4_launches": launches, "target_steps": d_steps[free],
                "k4_per_target_step": launches / d_steps[free]}
        pin(0)
        pin(1)
        sheds = counter("fleet.sheds")
        try:
            router.generate("gpt2m", prompts[0], max_new_tokens=8)
        except ServerOverloaded:
            pass
        else:
            raise RuntimeError("both pools full and the router did not "
                               "shed")
        finally:
            unpin(0)
            unpin(1)
        if counter("fleet.sheds") != sheds + 1:
            raise RuntimeError("the shed was not counted")
        out["per_replica"] = per_replica
        log("  pinned-pool routing " + json.dumps(per_replica) +
            "; both pinned: shed (fleet.sheds +1)")

        # (e) auto ladders: a skewed stream through the static ladders,
        # seed_cache_from_observed, then "auto" versions fleet-wide
        main, startup, _logits, prob = build_resnet50(seed=1)
        exe, scope = fluid.Executor(CARD), fluid.Scope()
        exe.run(startup, scope=scope)
        seeded_bn_fold(torch, main, scope, seed=2)
        rdir = os.path.join(tmp, "resnet50")
        with fluid.scope_guard(scope):
            fluid.save_inference_model(rdir, ["img"], [prob], exe, main)
        del exe, scope
        autotune.reset_histograms()
        cache_dir = os.path.join(tmp, "autotune")
        cache = stack.enter_context(autotune.scoped(cache_dir))
        drv.rollout("resnet50s", model_artifact(
            rdir, buckets=INFER_BUCKETS, max_wait_ms=0.0),
            converge_timeout=600.0)
        srng = np.random.RandomState(29)
        sizes = [int(x) for x in srng.choice(FLEET_SIZES, FLEET_STREAM)]
        images = [_images(srng, n) for n in sizes]
        for x in images:
            router.infer("resnet50s", {"img": x})
        for n in FLEET_BURSTS:
            _concurrent([router], "gpt2m", fresh(n), 4)
        seeded = autotune.seed_cache_from_observed(
            max_buckets=FLEET_AUTO_BUCKETS)
        hist = autotune.histogram("serving_buckets")
        t0 = time.perf_counter()
        s2 = drv.rollout(
            "gpt2m", decoder_artifact(checkpoint_dir=ck,
                                      **dict(SERVE, slots="auto")),
            canary="r1", converge_timeout=600.0)
        out["rollout_auto_s"] = time.perf_counter() - t0
        drv.rollout("resnet50", model_artifact(rdir, buckets="auto",
                                               max_wait_ms=0.0),
                    converge_timeout=600.0)
        slots = [e.stats()["slots"]
                 for e in _fleet_engines(servers, "gpt2m")]
        buckets = [e.stats()["buckets"]
                   for e in _fleet_engines(servers, "resnet50")]
        if slots[0] != slots[1] or slots[0] != seeded["decode_slots"] or \
                buckets[0] != buckets[1] or \
                buckets[0] != seeded["serving_buckets"]:
            raise RuntimeError(f"replicas resolved different ladders: "
                               f"slots {slots}, buckets {buckets}, cache "
                               f"{seeded}")
        waste = {"static": autotune.expected_padding_waste(hist,
                                                           INFER_BUCKETS),
                 "auto": autotune.expected_padding_waste(hist, buckets[0])}
        ips = {"static": [], "auto": []}
        engines = (_fleet_engines(servers, "resnet50s")
                   + _fleet_engines(servers, "resnet50"))
        b0 = sum(e.stats()["batches"] for e in engines)
        k5.counts.reset()
        for t in range(FLEET_TURNS):
            for side in (("static", "auto") if t % 2 == 0
                         else ("auto", "static")):
                model = "resnet50s" if side == "static" else "resnet50"
                t0 = time.perf_counter()
                for x in images:
                    router.infer(model, {"img": x})
                ips[side].append(sum(sizes) / (time.perf_counter() - t0))
        k5_launches, k5_plain = _fleet_counts(k5)
        batches = sum(e.stats()["batches"] for e in engines) - b0
        # each batch's compute (feeds to the card, the op loop, fetches)
        # by model and bucket, from the engines' serving.batch spans
        batch_ms = {}
        for ev in tracing.trace_events():
            if ev.get("name") == "serving.batch" and \
                    ev["args"].get("model") in ("resnet50s", "resnet50"):
                batch_ms.setdefault(f"{ev['args']['model']}:"
                                    f"{ev['args']['bucket']}", []).append(
                    ev["dur"] / 1e3)
        if k5_launches != CONVS_PER_FORWARD * batches or k5_plain:
            raise RuntimeError(f"K5 launches {k5_launches} != "
                               f"{CONVS_PER_FORWARD} x {batches} batches "
                               f"(plain {k5_plain})")
        out["auto"] = {
            "decode_slots": slots[0], "resnet_buckets": buckets[0],
            "static_buckets": INFER_BUCKETS, "seeded": seeded,
            "request_sizes": sizes, "expected_padding_waste": waste,
            "images_per_s": ips,
            "p50_batch_ms": {k: statistics.median(v)
                             for k, v in sorted(batch_ms.items())},
            "batches_by_bucket": {k: len(v)
                                  for k, v in sorted(batch_ms.items())},
            "k5_launches": k5_launches,
            "batches": batches, "k5_per_batch": k5_launches / batches,
            "rollout_auto_s": out["rollout_auto_s"],
            "cache_path": os.path.basename(cache.path)}
        log("  auto ladders " + json.dumps(out["auto"]))

        # (d) failover: r1 dies mid-stream, the stream resumes on r0
        p = prompts[1]
        want = router.generate("gpt2m", p, max_new_tokens=FLEET_NEW)[
            "tokens"]
        allocs = [e.cache.allocator for e in _fleet_engines(servers,
                                                            "gpt2m")]
        fo, rs = counter("fleet.failovers"), counter("fleet.stream.resumes")
        pin(0)
        try:
            st = router.generate("gpt2m", p, max_new_tokens=FLEET_NEW,
                                 stream=True)
        finally:
            unpin(0)
        if st.replica != "r1":
            raise RuntimeError(f"the stream started on {st.replica}")
        head = [next(st) for _ in range(4)]
        servers[1].kill()
        members[1].stop(deregister=False)
        toks = head + list(st)
        servers[1].shutdown(drain=False)
        ctl._evict("r1")  # the operator's cleanup of the dead replica
        if toks != want or counter("fleet.failovers") != fo + 1 or \
                counter("fleet.stream.resumes") != rs + 1:
            raise RuntimeError(f"failover stream: tokens equal "
                               f"{toks == want}, failovers "
                               f"{counter('fleet.failovers') - fo}, "
                               f"resumes "
                               f"{counter('fleet.stream.resumes') - rs}")
        out["failover"] = {"tokens_equal": True, "killed_after": 4,
                           "failovers": 1, "stream_resumes": 1}
        log(f"  r1 killed after 4 streamed tokens: resumed on r0, "
            f"{FLEET_NEW} tokens equal the buffered request's")

        # (f) a replica process from a scale intent
        trace_dir = os.path.join(tmp, "traces")
        os.makedirs(trace_dir)
        child_log = os.path.join(REPO, "smoke_out", "fleet_replica.log")
        open(child_log, "w").close()
        ln = ReplicaLauncher(
            addr, grace=60.0, backoff=0.5, start=False, device=CARD,
            command_factory=lambda rid: _logged(ln._default_command(rid),
                                                child_log),
            env={"PADDLE_TPU_AUTOTUNE_DIR": cache_dir,
                 "PADDLE_TPU_TRACE": "1", "PADDLE_TPU_TRACE_DIR": trace_dir})
        stack.callback(ln.stop)
        t0 = time.perf_counter()
        ctl._add_scale_intent("scale_up", {"replica_id": "r2"})
        ln.poll_once()
        child = {}
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline:
            if ln.stats()["replicas"]["r2"]["crashes"]:
                raise RuntimeError("the replica process crashed; see "
                                   "smoke_out/fleet_replica.log")
            rep = ctl._list_replicas().get("r2")
            if rep is not None:
                cli = ServingClient(tuple(rep["endpoint"]), retries=0)
                try:
                    child = cli.list_models()
                except (ConnectionError, OSError, RuntimeError):
                    child = {}
                finally:
                    cli.close()
                if {"gpt2m", "resnet50", "resnet50s"} <= set(child):
                    break
            time.sleep(0.2)
        else:
            raise RuntimeError(f"the replica process did not converge "
                               f"(models {sorted(child)})")
        spawn_s = time.perf_counter() - t0
        if child["gpt2m"]["slots"] != slots[0] or \
                child["resnet50"]["buckets"] != buckets[0] or \
                child["gpt2m"]["version"] != s2["version"]:
            raise RuntimeError(f"the replica process resolved "
                               f"{child['gpt2m']['slots']} / "
                               f"{child['resnet50']['buckets']}")
        allocs = [e.cache.allocator for e in _fleet_engines(servers[:1],
                                                            "gpt2m")]
        r2 = counter("fleet.routed.r2")
        pin(0)
        try:
            got = router.generate("gpt2m", p, max_new_tokens=FLEET_NEW)
        finally:
            unpin(0)
        if got["tokens"] != want or counter("fleet.routed.r2") != r2 + 1:
            raise RuntimeError("the replica process answered other tokens")
        proc = ln._procs["r2"]["proc"]
        ctl._add_scale_intent("scale_down", {"replica_id": "r2"})
        ln.poll_once()
        rc = proc.wait(120)
        if rc != 0 or "r2" in ctl._list_replicas():
            raise RuntimeError(f"the replica process left with {rc}")
        out["spawned"] = {"spawn_to_serving_s": spawn_s,
                          "models": sorted(child), "exit_code": rc,
                          "slots": child["gpt2m"]["slots"],
                          "tokens_equal": True}
        log(f"  replica process r2: spawn to serving {spawn_s:.2f} s "
            f"(converged {sorted(child)} from the intent log, slots "
            f"{child['gpt2m']['slots']}), answered a routed request with "
            f"the same tokens, SIGTERM -> exit {rc}, deregistered")

        # (g) the debug server and the merged timeline
        st = _get_json(dbg.address, "/statusz")
        text = _get_json(dbg.address, "/metrics")
        need = [f"fleet:{addr[1]}", "mesh", "device",
                f"serving:{servers[0].address[1]}"]
        if not all(k in st for k in need) or \
                st["device"]["device"] != CARD or \
                "fleet_routed_r0" not in text or \
                "autotune_cache_hits" not in text:
            raise RuntimeError(f"/statusz keys {sorted(st)}; /metrics "
                               "lacks fleet_ or autotune_ names")
        parent = tracing.trace_export(os.path.join(tmp, "parent.json"))
        shards = [parent] + sorted(
            os.path.join(trace_dir, f) for f in os.listdir(trace_dir))
        merged = timeline.merge_shards(shards)
        names = sorted({e["args"]["name"] for e in merged["traceEvents"]
                        if e.get("ph") == "M"
                        and e.get("name") == "process_name"})
        if len(shards) != 2 or len(names) != 2 or \
                "chip_smoke fleet" not in names:
            raise RuntimeError(f"merged timeline names {names} from "
                               f"{len(shards)} shards")
        out["debug"] = {
            "statusz_sections": sorted(st),
            "fleet_replicas": sorted(st[f"fleet:{addr[1]}"]["replicas"]),
            "metrics_lines": len(text.splitlines()),
            "timeline_processes": names,
            "timeline_spans": sum(1 for e in merged["traceEvents"]
                                  if e.get("ph") == "X")}
        log("  debug server and timeline " + json.dumps(out["debug"]))
        out["peak_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        out["seconds"] = time.perf_counter() - t_phase
        log(f"  fleet phase {out['seconds']:.1f} s, peak memory "
            f"{out['peak_memory_allocated_gb']:.2f} GB")
        return out
    finally:
        stack.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --- elastic: the elastic cloud training path -------------------------------

ELASTIC_SHARDS = 6       # recordio shards, one copy-task batch each
ELASTIC_BATCH = TRAIN_BATCH  # 512-token sequences (records) a shard
ELASTIC_STEPS = 2        # Executor steps a leased task
ELASTIC_LEASE = 20.0     # the master's task lease (s); the phase logs a
                         # healthy trainer's longest hold against it
ELASTIC_T0_TASKS = 3     # tasks the first trainer takes before it leaves
ELASTIC_HOLD_AT = 2      # the victim is killed holding its 2nd task
ELASTIC_CHANNEL_STEPS = 4
ELASTIC_LAUNCHES = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
                    "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
                    "flash_delta": 18}


def _elastic_rows(path):
    """A shard's records (record id, src, trg, lbl rows): the record ids
    and the Transformer feed they make."""
    import pickle

    import numpy as np

    from paddle_tpu_torch.native.recordio import read_all

    rows = [pickle.loads(r) for r in read_all(path)]
    return [int(r[0]) for r in rows], _rows_feed(rows)


def _rows_feed(rows):
    import numpy as np

    return {"src": np.stack([r[1] for r in rows]),
            "trg": np.stack([r[2] for r in rows]),
            "lbl": np.stack([r[3] for r in rows])[:, :, None]}


def _write_elastic_shards(work):
    """ELASTIC_SHARDS recordio files; shard i holds copy_task_batch's
    rows under seed 100 + i, one record a sequence."""
    import pickle

    from paddle_tpu_torch.native.recordio import RecordIOWriter

    paths = []
    for i in range(ELASTIC_SHARDS):
        b = copy_task_batch(ELASTIC_BATCH, TRANSFORMER_BASE, seed=100 + i)
        p = os.path.join(work, f"shard-{i}.recordio")
        w = RecordIOWriter(p)
        for j in range(ELASTIC_BATCH):
            w.write(pickle.dumps((i * ELASTIC_BATCH + j, b["src"][j],
                                  b["trg"][j], b["lbl"][j, :, 0])))
        w.close()
        paths.append(p)
    return paths


def elastic_trainer_main(cfg):
    """One trainer process of the elastic phase (``chip_smoke.py
    --elastic-trainer <json>``): register, lease tasks from the elected
    master (found through the lease server), train each task's batch for
    ELASTIC_STEPS Executor steps on ``cfg['device']`` (the card) inside
    an ElasticTrainer that checkpoints every task. Each step's kernel
    launches are held to ELASTIC_LAUNCHES with no plain call (on the CPU,
    where a rehearsal runs, the plain calls instead with no launch).
    Events go to ``cfg['log']`` as ``TAG {json}`` lines."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.distributed import (ElasticTrainer, MasterClient,
                                              WorkerRegistry)
    from paddle_tpu_torch.distributed.tcp_lease import tcp_endpoint_resolver

    events = open(cfg["log"], "a", buffering=1)

    def emit(tag, **kw):
        events.write(f"{tag} {json.dumps(dict(kw, t=time.time()))}\n")

    rids, trained = {}, []

    class Client(MasterClient):
        def task_finished(self, task_id, epoch=None):
            ok = super().task_finished(task_id, epoch)
            emit("FINISHED", task=task_id, epoch=epoch, ok=ok,
                 rids=rids[task_id])
            return ok

    client = Client(addr_resolver=tcp_endpoint_resolver(
        tuple(cfg["lease_addr"]), "master"), timeout=300,
        reconnect_retries=30, reconnect_backoff=0.2)
    reg = WorkerRegistry(cfg["registry"], cfg["id"], ttl=120)
    main, startup, cost, _ = build_transformer(cfg["model"], 1e-4)
    exe, scope = fluid.Executor(cfg["device"]), fluid.Scope()
    on_card = exe.device.type == "cuda"
    exe.run(startup, scope=scope)
    trainer = ElasticTrainer(client, cfg["ckpt"], main_program=main,
                             scope=scope, registry=reg, max_to_keep=2,
                             device=exe.device, idle_timeout=300)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resumed = trainer.maybe_resume()
    emit("READY", resumed=resumed, resume_s=time.perf_counter() - t0,
         since_spawn_s=time.time() - cfg["spawn_t"])

    def train(task):
        ids, feed = _elastic_rows(task.paths[0])
        rids[task.id] = ids
        emit("LEASED", task=task.id, epoch=task.epoch)
        if len(trained) + 1 == cfg.get("hold_at"):
            emit("HOLDING", task=task.id, epoch=task.epoch, rids=ids)
            time.sleep(3600)  # the phase SIGKILLs this process here
        losses, step_ms = [], []
        _reset_kernel_counts()
        for _ in range(ELASTIC_STEPS):
            t0 = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[cost],
                              scope=scope)
            losses.append(float(np.asarray(loss).reshape(-1)[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, plain = _kernel_counts()
        if not on_card:
            launches, plain = plain, launches
        launches = {k: v for k, v in launches.items() if v}
        want = {k: n * ELASTIC_STEPS for k, n in cfg["launches"].items()}
        if launches != want or any(plain.values()):
            raise RuntimeError(f"trainer {cfg['id']} on {exe.device}: "
                               f"{launches} (want {want}), the other "
                               f"route {plain}")
        trained.append(task.id)
        emit("TASK", task=task.id, epoch=task.epoch, losses=losses,
             step_ms=step_ms, launches=launches,
             plain=sum(plain.values()),
             since_spawn_s=time.time() - cfg["spawn_t"])

    stats = trainer.run_pass(train, should_stop=lambda: bool(
        cfg.get("max_tasks")) and len(trained) >= cfg["max_tasks"])
    emit("EXIT", stats=stats, peak_gb=(
        torch.cuda.max_memory_allocated() / 1e9 if on_card else None))
    return 0


def _events(path, tag):
    """The ``tag`` events of a trainer's log, in order."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln[len(tag) + 1:]) for ln in f
                if ln.startswith(tag + " ")]


def _wait_event(path, tag, procs, deadline_s=300):
    """The first ``tag`` event of a log; fails as soon as a trainer
    process exits non-zero."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        got = _events(path, tag)
        if got:
            return got[0]
        for w, p in procs.items():
            if p.poll() not in (None, 0):
                raise RuntimeError(f"trainer {w} exited {p.returncode} "
                                   f"(smoke_out/elastic-{w}.log)")
        time.sleep(0.05)
    raise RuntimeError(f"no {tag} event in {path} within {deadline_s} s")


def _elastic_reference(fluid, ckpt_dir, path):
    """A fresh Transformer-base program in this process: startup on the
    card, the checkpoint loaded, ELASTIC_STEPS steps on one shard."""
    import numpy as np

    main, startup, cost, _ = build_transformer(TRANSFORMER_BASE, 1e-4)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    step = fluid.io.load_checkpoint(ckpt_dir, main, scope=scope,
                                    device=exe.device)
    _, feed = _elastic_rows(path)
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[cost],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(ELASTIC_STEPS)]
    return step, losses


def _elastic_channel(fluid, paths, master_ep):
    """(d): a Go producer reads the shards through cloud_reader from a
    fresh pass, stages each batch in BuddyAllocator arena views and
    sends it through a native Channel; this thread runs
    ELASTIC_CHANNEL_STEPS Executor steps on the card from what it
    receives. The same batches read from their shards and fed directly
    to a twin program from the same state: losses bitwise equal."""
    import numpy as np

    from paddle_tpu_torch.fluid import concurrency as cc
    from paddle_tpu_torch.native import BuddyAllocator
    from paddle_tpu_torch.reader.creator import cloud_reader

    L = TRANSFORMER_BASE["max_len"]
    # three staged arrays a batch, each bumped a block level by the guard
    arena = BuddyAllocator(8 * ELASTIC_BATCH * L * 8, guard="always")
    ch = cc.make_channel(capacity=0)
    staged = []

    def producer():
        gen = cloud_reader(paths, master_ep)()
        rows, sent = [], 0
        try:
            for rec in gen:
                rows.append(rec)
                if len(rows) < ELASTIC_BATCH:
                    continue
                views = {k: arena.alloc(ELASTIC_BATCH * L, "int64")
                         for k in ("src", "trg", "lbl")}
                for i, k in enumerate(("src", "trg", "lbl")):
                    views[k][:] = np.stack([r[i + 1] for r in rows]
                                           ).reshape(-1)
                staged.append(arena.memory_usage())
                ok = cc.channel_send(ch, {
                    "rids": [int(r[0]) for r in rows],
                    **{k: v.reshape(ELASTIC_BATCH, L)
                       for k, v in views.items()}})
                for v in views.values():
                    arena.free(v)
                rows, sent = [], sent + 1
                if not ok or sent == ELASTIC_CHANNEL_STEPS:
                    break
        finally:
            gen.close()  # the pass is abandoned: its lease goes back
            cc.channel_close(ch)

    main_a, startup, cost_a, _ = build_transformer(TRANSFORMER_BASE, 1e-4)
    main_b, _, cost_b, _ = build_transformer(TRANSFORMER_BASE, 1e-4)
    exe, scope_a, scope_b = _card_executor(fluid), fluid.Scope(), \
        fluid.Scope()
    exe.run(startup, scope=scope_a)
    for n in scope_a.var_names():
        v = scope_a.find_var(n)
        if hasattr(v, "clone"):
            scope_b.set_var(n, v.clone())
    t0 = time.perf_counter()
    go = cc.Go()
    go.spawn(producer)
    fed, got = [], []
    while True:
        batch, ok = cc.channel_recv(ch)
        if not ok:
            break
        fed.append(batch)
        got.append(float(np.asarray(exe.run(
            main_a, feed={"src": batch["src"], "trg": batch["trg"],
                          "lbl": batch["lbl"][:, :, None]},
            fetch_list=[cost_a], scope=scope_a)[0]).reshape(-1)[0]))
    go.join(120)
    channel_s = time.perf_counter() - t0
    if len(got) != ELASTIC_CHANNEL_STEPS:
        raise RuntimeError(f"the channel fed {len(got)} batches, want "
                           f"{ELASTIC_CHANNEL_STEPS}")
    direct = []
    for batch in fed:
        shard = batch["rids"][0] // ELASTIC_BATCH
        ids, feed = _elastic_rows(paths[shard])
        if ids != batch["rids"] or not all(
                np.array_equal(feed[k].reshape(ELASTIC_BATCH, L),
                               batch[k]) for k in ("src", "trg", "lbl")):
            raise RuntimeError(f"the channel's batch of shard {shard} "
                               "differs from the shard's records")
        direct.append(float(np.asarray(exe.run(
            main_b, feed=feed, fetch_list=[cost_b],
            scope=scope_b)[0]).reshape(-1)[0]))
    if got != direct:
        raise RuntimeError(f"channel-fed losses {got} != direct {direct}")
    if arena.check() != 0 or arena.memory_usage() != 0:
        raise RuntimeError(f"arena: check {arena.check()}, "
                           f"{arena.memory_usage()} bytes still held")
    out = {"losses": got, "shards": [b["rids"][0] // ELASTIC_BATCH
                                     for b in fed],
           "bitwise_direct": True, "channel_s": channel_s,
           "arena_staged_bytes": max(staged), "arena_total": arena.total}
    arena.close()
    return out


def elastic_phase(torch):
    """The elastic cloud training path on the card: (a) a LeaseServer and
    two ElectedMaster candidates (threads) over one snapshot serving
    ELASTIC_SHARDS recordio shards; (b) two trainer processes
    (WorkerRegistry, tcp_endpoint_resolver, ElasticTrainer on the card);
    (c) one SIGKILLed holding a lease, its task requeued, a replacement
    resumed from its checkpoint; (d) a Go producer feeding an Executor
    loop through a native Channel."""
    phase("elastic")
    import shutil
    import signal
    import tempfile

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.distributed import (ElectedMaster, MasterClient,
                                              WorkerRegistry)
    from paddle_tpu_torch.distributed.tcp_lease import (LeaseServer,
                                                         TcpLease,
                                                         tcp_endpoint_resolver)
    from paddle_tpu_torch.native import load_native

    t_phase = time.perf_counter()
    secs = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    lease_srv, masters, procs = LeaseServer(), [], {}
    try:
        # (a) master and data
        t0 = time.perf_counter()
        load_native()  # the host library (channel, buddy) for (d)
        host_build_s = time.perf_counter() - t0
        lease_addr = lease_srv.serve()
        snap = os.path.join(work, "master.snap")
        for i in range(2):
            em = ElectedMaster(None, snap, ttl=5.0, lease=TcpLease(
                lease_addr, "master", f"m{i}", ttl=5.0),
                chunks_per_task=1, lease_timeout=ELASTIC_LEASE,
                failure_max=3)
            em.start()
            masters.append(em)
        deadline = time.monotonic() + 60
        while not any(em.is_leader.is_set() for em in masters):
            if time.monotonic() > deadline:
                raise RuntimeError("no master elected: "
                                   f"{[em.last_error for em in masters]}")
            time.sleep(0.05)
        elected = next(em for em in masters if em.is_leader.is_set())
        resolve = tcp_endpoint_resolver(lease_addr, "master")
        paths = _write_elastic_shards(work)
        client = MasterClient(addr_resolver=resolve, timeout=120)
        client.set_dataset(paths)
        leader = elected.service
        secs["a"] = time.perf_counter() - t0
        log(f"  (a) lease server {lease_addr[1]}, master "
            f"{elected.lease.holder} elected (the other candidate standing "
            f"by) at {elected.addr[1]}, {ELASTIC_SHARDS} shards "
            f"of {ELASTIC_BATCH} sequences, task lease {ELASTIC_LEASE} s; "
            f"host library {host_build_s:.2f} s; {secs['a']:.2f} s")

        # (b) trainers
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"  card memory before the trainers: {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free, this process holds "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

        def spawn(wid, ckpt, **extra):
            cfg = dict(id=wid, ckpt=os.path.join(work, ckpt),
                       log=os.path.join(work, f"events-{wid}.log"),
                       device=CARD, model=TRANSFORMER_BASE,
                       launches=ELASTIC_LAUNCHES,
                       lease_addr=list(lease_addr),
                       registry=os.path.join(work, "members"),
                       spawn_t=time.time(), **extra)
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--elastic-trainer", json.dumps(cfg)]
            procs[wid] = subprocess.Popen(_logged(cmd, os.path.join(
                REPO, "smoke_out", f"elastic-{wid}.log")), cwd=REPO)
            return cfg["log"]

        logs = {"t0": spawn("t0", "ckpt-t0", max_tasks=ELASTIC_T0_TASKS),
                "victim": spawn("victim", "ckpt-victim",
                                hold_at=ELASTIC_HOLD_AT)}
        held = _wait_event(logs["victim"], "HOLDING", procs)
        secs["b"] = time.perf_counter() - t0

        # (c) death and rejoin
        t0 = time.perf_counter()
        procs["victim"].send_signal(signal.SIGKILL)
        procs["victim"].wait(60)
        kill_t = time.time()
        ref_dir = os.path.join(work, "ckpt-ref")
        os.makedirs(ref_dir)
        vdir = os.path.join(work, "ckpt-victim")
        shutil.copy(os.path.join(vdir, "META"), ref_dir)
        for f in os.listdir(vdir):  # the payload, without a copy
            if f.endswith(".npz"):
                os.link(os.path.join(vdir, f), os.path.join(ref_dir, f))
        logs["t2"] = spawn("t2", "ckpt-victim")
        requeue_t = None
        while procs["t0"].poll() is None or procs["t2"].poll() is None:
            p = leader._pending.get(held["task"])
            if requeue_t is None and (p is None
                                      or p.epoch != held["epoch"]):
                requeue_t = time.time()
            for w in ("t0", "t2"):
                if procs[w].poll() not in (None, 0):
                    raise RuntimeError(
                        f"trainer {w} exited {procs[w].returncode} "
                        f"(smoke_out/elastic-{w}.log)")
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("the trainers did not finish the pass "
                                   "in 600 s")
            time.sleep(0.05)
        stats = client.stats()
        if stats != {"todo": 0, "pending": 0, "done": ELASTIC_SHARDS,
                     "dropped": 0, "pass": 0}:
            raise RuntimeError(f"master stats after the pass: {stats}")
        finished = {}
        for w in ("t0", "victim", "t2"):
            for ev in _events(logs[w], "FINISHED"):
                if ev["ok"]:
                    for r in ev["rids"]:
                        finished.setdefault(r, []).append(w)
        twice = {r: ws for r, ws in finished.items() if len(ws) != 1}
        if sorted(finished) != list(range(ELASTIC_SHARDS * ELASTIC_BATCH)) \
                or twice:
            raise RuntimeError(f"records not finished exactly once: "
                               f"{len(finished)} finished, more than once "
                               f"{twice}")
        if any(finished[r] != ["t2"] for r in held["rids"]):
            raise RuntimeError("the victim's held task was not finished "
                               "by the replacement")
        tasks = {w: _events(logs[w], "TASK") for w in logs}
        ready = {w: _events(logs[w], "READY")[0] for w in logs}
        exits = {w: _events(logs[w], "EXIT")[0] for w in ("t0", "t2")}
        if ready["t2"]["resumed"] != 1 or not tasks["t2"]:
            raise RuntimeError(f"the replacement resumed from "
                               f"{ready['t2']['resumed']}, trained "
                               f"{len(tasks['t2'])} tasks")
        members = WorkerRegistry(os.path.join(work, "members"),
                                 "probe").members()
        if "t2" not in members.values():
            raise RuntimeError(f"the registry lists {members}")
        first = tasks["t2"][0]
        ref_step, ref_losses = _elastic_reference(
            fluid, ref_dir, paths[first["task"]])
        if ref_step != 1 or ref_losses != first["losses"]:
            raise RuntimeError(f"the replacement's first task losses "
                               f"{first['losses']} != the in-process "
                               f"reference's {ref_losses} (step {ref_step})")
        secs["c"] = time.perf_counter() - t0
        leased = {w: {(e["task"], e["epoch"]): e["t"]
                      for e in _events(logs[w], "LEASED")} for w in logs}
        holds = [e["t"] - leased[w][(e["task"], e["epoch"])]
                 for w in ("t0", "victim", "t2")
                 for e in _events(logs[w], "FINISHED")]
        # a task's last step to its finish: the checkpoint and the RPC
        trained_t = {(w, e["task"], e["epoch"]): e["t"]
                     for w in tasks for e in tasks[w]}
        ckpt_s = [e["t"] - trained_t[(w, e["task"], e["epoch"])]
                  for w in ("t0", "victim", "t2")
                  for e in _events(logs[w], "FINISHED")]
        later = [ms for w in tasks for i, e in enumerate(tasks[w])
                 for j, ms in enumerate(e["step_ms"]) if i or j]
        out = {
            "trainers": {w: {"tasks": [e["task"] for e in tasks[w]],
                             "losses": [e["losses"] for e in tasks[w]],
                             "ready_s": ready[w]["since_spawn_s"],
                             "first_step_s": (tasks[w][0]["since_spawn_s"]
                                              if tasks[w] else None),
                             "peak_gb": exits.get(w, {}).get("peak_gb")}
                         for w in logs},
            "launches_per_step": {k: v // ELASTIC_STEPS for k, v in
                                  tasks["t0"][0]["launches"].items()},
            "plain_calls": sum(e["plain"] for w in tasks
                               for e in tasks[w]),
            "task_step_p50_ms": statistics.median(later),
            "longest_hold_s": max(holds), "lease_s": ELASTIC_LEASE,
            "checkpoint_and_finish_p50_s": statistics.median(ckpt_s),
            "requeue_after_kill_s": requeue_t - kill_t,
            "replacement_resume_s": ready["t2"]["resume_s"],
            "replacement_first_task": first["task"],
            "replacement_losses_bitwise": True,
            "records_finished_once": len(finished),
            "registry": sorted(members.values()),
        }
        log("  (b, c) elastic trainers " + json.dumps(out))
        if out["longest_hold_s"] >= ELASTIC_LEASE:
            raise RuntimeError(f"a healthy trainer held a task "
                               f"{out['longest_hold_s']:.1f} s, past the "
                               f"{ELASTIC_LEASE} s lease")

        # (d) concurrency
        t0 = time.perf_counter()
        ep = resolve()
        out["channel"] = _elastic_channel(fluid, paths,
                                          f"{ep[0]}:{ep[1]}")
        secs["d"] = time.perf_counter() - t0
        log("  (d) channel-fed steps " + json.dumps(out["channel"]))
        out["seconds"] = dict(secs, total=time.perf_counter() - t_phase)
        log(f"  elastic phase: (a) {secs['a']:.1f} s, (b) {secs['b']:.1f} "
            f"s, (c) {secs['c']:.1f} s, (d) {secs['d']:.1f} s, total "
            f"{out['seconds']['total']:.1f} s")
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(60)
        for em in masters:
            em.stop()
        lease_srv.shutdown()
        shutil.rmtree(work, ignore_errors=True)


# --- analysis: the verifier hook and the guard sanitizer on the card ----

ANALYSIS_STEPS = 3       # Transformer-base steps a side (hook off, on)
ANALYSIS_LAUNCHES = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
                     "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
                     "flash_delta": 18}
ANALYSIS_NEW = 32        # new tokens a request (the serve phase's)
ANALYSIS_TURNS = 2       # (plain, sanitized, sanitized, plain) rounds
K4_PER_STEP = GPT2_MEDIUM["n_layers"]  # K4 launches a target step: one a layer


def _analysis_cli(*args):
    """``python -m paddle_tpu_torch.analysis <args>``, started now."""
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _cli_result(proc, what):
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"analysis {what} exited {proc.returncode}: "
                           f"{out[-2000:]} {err[-2000:]}")
    return json.loads(out)


def _verified_training(torch):
    """(a): Transformer-base with FLAGS['verify_programs'] off, then on."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.analysis import errors, verify
    from paddle_tpu_torch.flags import FLAGS

    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)
    real, miss_ms = verify.assert_valid, []

    def timed(program, **kw):
        t0 = time.perf_counter()
        try:
            return real(program, **kw)
        finally:
            miss_ms.append((time.perf_counter() - t0) * 1e3)

    out = {}
    verify.assert_valid = timed
    try:
        for side in ("off", "on"):
            FLAGS["verify_programs"] = side == "on"
            main, startup, cost, _ = build_transformer(TRANSFORMER_BASE,
                                                       1e-4)
            exe, scope = _card_executor(fluid), fluid.Scope()
            exe.run(startup, scope=scope)
            (losses, ms), launches = _held_window(lambda: _timed_steps(
                exe, main, [feed] * ANALYSIS_STEPS, [cost], scope))
            for k, per in ANALYSIS_LAUNCHES.items():
                if launches.get(k, 0) != per * ANALYSIS_STEPS:
                    raise RuntimeError(
                        f"verify_programs {side}: {k} {launches.get(k, 0)} "
                        f"launches in {ANALYSIS_STEPS} steps, want {per} "
                        "a step")
            out[side] = {"losses": losses, "step_ms": ms,
                         "launches_per_step": {
                             k: v // ANALYSIS_STEPS
                             for k, v in launches.items()}}
            del exe, scope
            torch.cuda.empty_cache()
    finally:
        verify.assert_valid = real
        FLAGS["verify_programs"] = False
    if out["on"]["losses"] != out["off"]["losses"] or \
            not all(np.isfinite(out["on"]["losses"])):
        raise RuntimeError(f"losses with the verifier on "
                           f"{out['on']['losses']} != off "
                           f"{out['off']['losses']}")
    # startup and main miss once each (the feed names do not change)
    if len(miss_ms) != 2:
        raise RuntimeError(f"the verifier ran {len(miss_ms)} times, want "
                           "one per program-cache miss (2)")
    out["verifier_ms_per_miss"] = {"startup": miss_ms[0],
                                   "main": miss_ms[1]}
    # the meta-tensor shape re-check over both programs, with this
    # machine's torch
    shapes = {}
    for kind, prog in (("main", main), ("startup", startup)):
        t0 = time.perf_counter()
        diags = verify.verify_program(prog, check_shapes=True)
        bad = errors(diags)
        if bad:
            raise RuntimeError(f"verify_program({kind}) errors: "
                               f"{[d.format() for d in bad[:5]]}")
        codes = {}
        for d in diags:
            codes[d.code] = codes.get(d.code, 0) + 1
        shapes[kind] = {"ops": len(prog.global_block().ops),
                        "warnings": codes,
                        "ms": (time.perf_counter() - t0) * 1e3}
    out["verify_check_shapes"] = shapes
    out["losses_bitwise"] = True
    return out


def _nan_step(torch):
    """(b): one FLAGS['check_nan_inf'] step on a NaN-seeded feed."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.flags import FLAGS

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[D_MODEL], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        cost = layers.mean(layers.square_error_cost(
            input=layers.fc(input=x, size=1), label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    xs = rng.randn(TRAIN_BATCH, D_MODEL).astype(np.float32)
    xs[3, 7] = np.nan
    feed = {"x": xs, "y": np.ones((TRAIN_BATCH, 1), np.float32)}
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)  # flag off
    FLAGS["check_nan_inf"] = True
    try:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    except FloatingPointError as e:
        msg, ms = str(e), (time.perf_counter() - t0) * 1e3
    else:
        raise RuntimeError("check_nan_inf: a NaN feed raised nothing")
    finally:
        FLAGS["check_nan_inf"] = False
    if msg != "var 'fc_0.w_0' contains NaN/Inf":
        raise RuntimeError(f"check_nan_inf raised {msg!r}")
    return {"raised": msg, "step_ms": ms}


def _sanitized_serving(torch, serve_ref, before_turns):
    """(c): the serve phase's requests under the guard sanitizer;
    ``before_turns()`` runs between the decoder's load and the first
    batch."""
    from paddle_tpu_torch.analysis import sanitize
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics, tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    steps_c = metrics.counter("serving.decode.target_steps")
    sanitize.clear_violations()
    installed = sanitize.install()
    # created while installed: the server, its registry, the engine and
    # its KV cache and the clients are armed
    srv = ServingServer()
    clients = [ServingClient(srv.serve(), timeout=900.0) for _ in range(8)]
    try:
        t0 = time.perf_counter()
        clients[0].load_decoder("gpt2m", GPT2_MEDIUM, **SERVE)
        load_s = time.perf_counter() - t0
        before_turns()

        def batch(side):
            (sanitize.install if side == "sanitized" else
             sanitize.uninstall)()
            pa.counts.reset()
            steps0 = steps_c.value()
            tracing.trace_reset()
            tracing.trace_enable()
            results, wall = _concurrent(clients, "gpt2m",
                                        serve_ref["prompts"], ANALYSIS_NEW)
            tracing.trace_disable()
            steps = steps_c.value() - steps0
            launches = pa.counts.kernel_launches[pa.KERNEL]
            plain = pa.counts.plain_calls[pa.KERNEL]
            if [r["tokens"] for r in results] != serve_ref["tokens"]:
                raise RuntimeError(f"{side} batch: tokens differ from the "
                                   "serve phase's")
            if launches != K4_PER_STEP * steps or not steps or plain:
                raise RuntimeError(f"{side} batch: {launches} K4 launches, "
                                   f"{plain} plain calls, {steps} target "
                                   "steps")
            if sanitize.violations():
                raise RuntimeError(f"guard violations: "
                                   f"{sanitize.violations()[:5]}")
            ms = [ev["dur"] / 1e3 for ev in tracing.trace_events()
                  if ev.get("name") == "serving.decode.step"]
            return {"steps": steps, "launches": launches, "wall_s": wall,
                    "p50_step_ms": statistics.median(ms)}

        # the main path's window: the first batch, sanitized, prefill
        # from nothing
        main_window = batch("sanitized")
        turns = {"sanitized": [], "plain": []}
        for _ in range(ANALYSIS_TURNS):
            for side in ("plain", "sanitized", "sanitized", "plain"):
                turns[side].append(batch(side))
        p50 = {k: statistics.median(t["p50_step_ms"] for t in v)
               for k, v in turns.items()}
        return {"classes_installed": len(installed), "load_warm_s": load_s,
                "window": main_window, "tokens_bitwise": True,
                "k4_launches_per_target_step":
                    main_window["launches"] / main_window["steps"],
                "violations": 0, "turns": turns,
                "p50_step_ms": p50,
                "step_ratio_sanitized_over_plain":
                    p50["sanitized"] / p50["plain"]}
    finally:
        sanitize.uninstall()
        for c in clients:
            c.close()
        srv.shutdown()


def analysis_phase(torch, serve_ref):
    """The static-analysis passes on the card's paths (see the module
    docstring)."""
    phase("analysis")
    t_phase = time.perf_counter()
    # (d) first: the CLI touches no device and overlaps the rest
    cli = {"json": _analysis_cli("--json"),
           "selftest": _analysis_cli("--selftest", "--json")}
    try:
        out = {"train": _verified_training(torch)}
        log("  (a) verified training " + json.dumps(out["train"]))
        out["nan"] = _nan_step(torch)
        log("  (b) check_nan_inf " + json.dumps(out["nan"]))

        def cli_results():
            # the CLI ends before the timed batches share the host
            t0 = time.perf_counter()
            doc = _cli_result(cli["json"], "--json")
            if doc["errors"]:
                raise RuntimeError(f"analysis --json: {doc['errors']} "
                                   "errors")
            st = _cli_result(cli["selftest"], "--selftest")
            if not st["ok"]:
                raise RuntimeError(f"analysis --selftest: {st['selftest']}")
            out["cli"] = {"passes": doc["passes"], "errors": doc["errors"],
                          "warnings": doc["warnings"],
                          "selftest_codes_fired": sum(
                              r["fired"] for r in st["selftest"]),
                          "waited_s": time.perf_counter() - t0}
            log("  (d) cli " + json.dumps(out["cli"]))

        out["serve"] = _sanitized_serving(torch, serve_ref, cli_results)
        log("  (c) sanitized serving " + json.dumps(out["serve"]))
    finally:
        for p in cli.values():
            if p.poll() is None:
                p.kill()
                p.wait(60)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  analysis phase: {out['seconds']:.1f} s")
    return out


V2_VGG_BATCH = 128       # cifar images an iteration (the issue's batch)
V2_VGG_ITERS = 10        # SGD iterations through the event handler
V2_VGG_LR = 0.01         # Momentum(momentum=0.9, learning_rate=V2_VGG_LR)
V2_TEST_RTOL = 1e-4      # SGD.test cost, card vs CPU, relative
V2_LOGITS_TOL = 1e-4     # VGG-16's logits, card vs CPU, of the largest |logit|
V2_STEP_RTOL = 1e-4      # one step's gradient of the exact one, of its norm,
V2_STEP_F32 = 2.0        # or this many times plain float32's own distance
V2_FIT_PASSES = 3        # fit_a_line passes (tests/test_v2_api.py's)
V2_INFER_TOL = 1e-5      # infer, card vs CPU, of the largest |output|
V2_CONV = dict(batch=64, channels=3, hw=32, filters=16, k=3, padding=1)
V2_CONV_TOL = 1e-4       # conv_operator card vs CPU, of the largest |value|
V2_LEGACY_STEPS = 2
V2_LEGACY_CONFIG = """
from paddle.trainer_config_helpers import *

settings(batch_size=64, learning_rate=0.001)
img = data_layer(name='pixel', size=3 * 32 * 32, height=32, width=32)
conv = img_conv_layer(input=img, filter_size=3, num_filters=32,
                      num_channels=3, padding=1, act=ReluActivation())
pool = img_pool_layer(input=conv, pool_size=2, stride=2,
                      pool_type=MaxPooling())
prob = fc_layer(input=pool, size=10, act=SoftmaxActivation())
label = data_layer(name='label', size=10)
outputs(classification_cost(input=prob, label=label))
"""


@contextlib.contextmanager
def _v2_world():
    """Fresh default programs, scope and name counters for one v2
    topology."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with fluid.scope_guard(fluid.Scope()), \
            fluid.program_guard(main, startup), unique_name.guard():
        yield main, startup


def _v2_vgg(v2):
    """v2.networks.vgg_16_network on 3x32x32 cifar images, 10 classes."""
    img = v2.layer.data(name="image",
                        type=v2.data_type.dense_vector(3 * 32 * 32))
    label = v2.layer.data(name="label", type=v2.data_type.integer_value(10))
    import paddle_tpu_torch.fluid as fluid

    x4 = fluid.layers.reshape(img, shape=[-1, 3, 32, 32])
    out = v2.networks.vgg_16_network(x4, num_channels=3, num_classes=10)
    return v2.layer.classification_cost(input=out, label=label)


def _v2_copy(dst, src):
    for n in src.names():
        dst.set(n, src.get(n))


def _v2_vgg_plain_grads(torch, params, batch, names, dtype):
    """The gradients of ``names`` for vgg_16_network with dropout off, in
    plain PyTorch at ``dtype`` on the card: 13 3x3 convs (padding 1,
    relu) in groups of 2, 2, 3, 3, 3 each closed by a 2x2 max pool, fc
    4096 relu, fc 4096 relu, fc 10, softmax cross-entropy's mean.
    ``params`` are numpy arrays under the port's names."""
    import numpy as np
    import torch.nn.functional as F

    p = {n: torch.tensor(v, dtype=dtype, device=CARD, requires_grad=True)
         for n, v in params.items()}
    x = torch.tensor(np.stack([img for img, _ in batch]), dtype=dtype,
                     device=CARD).reshape(-1, 3, 32, 32)
    y = torch.tensor([label for _, label in batch], device=CARD)
    k = 0
    for n_convs in (2, 2, 3, 3, 3):
        for _ in range(n_convs):
            x = F.relu(F.conv2d(x, p[f"conv2d_{k}.w_0"], padding=1)
                       + p[f"conv2d_{k}.w_1"].reshape(1, -1, 1, 1))
            k += 1
        x = F.max_pool2d(x, 2, 2)
    x = x.flatten(1)
    for j in range(3):
        x = x @ p[f"fc_{j}.w_0"] + p[f"fc_{j}.w_1"]
        x = F.relu(x) if j < 2 else x
    F.cross_entropy(x, y).backward()
    return {n: p[n].grad.double().cpu().numpy() for n in names}


def _v2_step_grad(trainer, main, batch, feeding):
    """One SGD step on ``batch`` with dropout off (its masks come from
    per-device generators): the gradient of the first conv's filter and
    of the last fc's weight, by name, read as Momentum's velocity, which
    the first step sets to the gradient. (The change of a float32
    parameter rounds to the parameter's ulp, a large share of a change
    this small.)"""
    import numpy as np

    ops = main.global_block().ops
    names = ([op.input("Filter")[0] for op in ops if op.type == "conv2d"][0],
             [op.input("Y")[0] for op in ops if op.type == "mul"][-1])
    velocity = {op.input("Param")[0]: op.input("Velocity")[0]
                for op in ops if op.type == "momentum"}
    drops = [op for op in ops if op.type == "dropout"]
    probs = [op.attr("dropout_prob") for op in drops]
    for op in drops:
        op.set_attr("dropout_prob", 0.0)
    if any(np.any(trainer.parameters.get(velocity[n])) for n in names):
        raise RuntimeError("v2 VGG-16: Momentum's velocity before the "
                           "first step is not zero")
    trainer.train(reader=lambda: iter([batch]), num_passes=1,
                  feeding=feeding)
    for op, p in zip(drops, probs):
        op.set_attr("dropout_prob", p)
    return {n: trainer.parameters.get(velocity[n]) for n in names}


def _v2_vgg_run(torch, v2):
    """(a): VGG-16 trained through SGD's event loop on the card. From the
    card's initial parameters copied to a CPU twin: SGD.test's cost, the
    logits through infer, and one step's gradient of the first conv and
    the last fc (dropout off), card and CPU against plain float64."""
    import itertools

    import numpy as np

    feeding = {"image": 0, "label": 1}
    first = next(iter(v2.batch(v2.dataset.cifar.train10(),
                               V2_VGG_BATCH)()))
    images = [(img,) for img, _ in first]
    with _v2_world() as (main, _):
        cost = _v2_vgg(v2)
        logits = main.global_block().var(logits_var(main))
        params = v2.create(cost)
        trainer = v2.SGD(cost=cost, parameters=params,
                         update_equation=v2.optimizer.Momentum(
                             momentum=0.9, learning_rate=V2_VGG_LR))
        convs = sum(op.type == "conv2d" for op in main.global_block().ops)
        t0 = time.perf_counter()
        with _v2_world() as (cpu_main, _):
            cpu_cost = _v2_vgg(v2)
            cpu_logits = cpu_main.global_block().var(logits_var(cpu_main))
            cpu_params = v2.create(cpu_cost, device="cpu")
            _v2_copy(cpu_params, params)
            cpu_trainer = v2.SGD(cost=cpu_cost, parameters=cpu_params,
                                 update_equation=v2.optimizer.Momentum(
                                     momentum=0.9, learning_rate=V2_VGG_LR),
                                 device="cpu")
            cpu_test = cpu_trainer.test(reader=lambda: iter([first]),
                                        feeding=feeding).cost
            cpu_out = v2.infer(output_layer=cpu_logits,
                               parameters=cpu_params, input=images,
                               feeding={"image": 0}, device="cpu")
            cpu_grad = _v2_step_grad(cpu_trainer, cpu_main, first, feeding)
        card_test = trainer.test(reader=lambda: iter([first]),
                                 feeding=feeding).cost
        card_out = v2.infer(output_layer=logits, parameters=params,
                            input=images, feeding={"image": 0})
        init = {n: params.get(n) for n in params.names()}
        card_grad = _v2_step_grad(trainer, main, first, feeding)
        test_err = abs(card_test - cpu_test) / abs(cpu_test)
        if not test_err <= V2_TEST_RTOL:
            raise RuntimeError(f"v2 VGG-16 SGD.test card {card_test} vs CPU "
                               f"{cpu_test}: {test_err} relative "
                               f"(> {V2_TEST_RTOL})")
        if card_out.shape != (V2_VGG_BATCH, 10):
            raise RuntimeError(f"v2 VGG-16 logits of shape {card_out.shape}")
        logits_err = float(np.abs(card_out - cpu_out).max()
                           / np.abs(cpu_out).max())
        if not logits_err <= V2_LOGITS_TOL:
            raise RuntimeError(f"v2 VGG-16 logits card vs CPU: {logits_err} "
                               f"of the max (> {V2_LOGITS_TOL})")
        # the exact gradient (float64), and float32's own distance from
        # it: on this untrained net a float32 rounding that moves a
        # near-tie of a max pool or a relu reaches the first convs'
        # gradients magnified (their terms largely cancel)
        exact = _v2_vgg_plain_grads(torch, init, first, card_grad,
                                    torch.float64)
        plain32 = _v2_vgg_plain_grads(torch, init, first, card_grad,
                                      torch.float32)
        grads = {}
        for n, g in exact.items():
            norm = float(np.linalg.norm(g))
            f32 = float(np.linalg.norm(plain32[n] - g) / norm)
            errs = {"card": float(np.linalg.norm(card_grad[n] - g) / norm),
                    "cpu": float(np.linalg.norm(cpu_grad[n] - g) / norm),
                    "card_vs_cpu": float(np.linalg.norm(
                        card_grad[n] - cpu_grad[n]) / norm)}
            bound = max(V2_STEP_RTOL, V2_STEP_F32 * f32)
            grads[n] = {"norm": norm, "plain_f32": f32, "bound": bound,
                        **errs}
            if not norm or not max(errs.values()) <= bound:
                raise RuntimeError(f"v2 VGG-16 one step's gradient of {n} "
                                   f"against float64: {grads[n]}")
        check_s = time.perf_counter() - t0
        costs, ms, begun = [], [], []

        def handler(e):
            if isinstance(e, v2.event.BeginIteration):
                begun.append(time.perf_counter())
            elif isinstance(e, v2.event.EndIteration):
                ms.append((time.perf_counter() - begun[-1]) * 1e3)
                costs.append(e.cost)

        def reader():
            # the same batch each iteration: on the synthetic cifar the
            # cost sits at chance and moves more from batch to batch
            # than 10 steps of learning move it, so first and last see
            # the same images
            return itertools.repeat(first, V2_VGG_ITERS)

        torch.cuda.reset_peak_memory_stats()
        _, launches = _held_window(lambda: trainer.train(
            reader=reader, num_passes=1, event_handler=handler,
            feeding=feeding))
    if len(costs) != V2_VGG_ITERS or not all(np.isfinite(costs)):
        raise RuntimeError(f"v2 VGG-16 costs: {costs}")
    if not costs[-1] < costs[0]:
        raise RuntimeError(f"v2 VGG-16 cost {costs[0]} -> {costs[-1]}: the "
                           "last not below the first")
    p50 = statistics.median(ms[1:])
    return {"config": f"v2 vgg_16_network: cifar train10 3x32x32, 10 "
                      f"classes, {convs} convs, its first batch of "
                      f"{V2_VGG_BATCH} {V2_VGG_ITERS} times, "
                      f"Momentum({V2_VGG_LR}, 0.9)",
            "costs": costs, "iteration_ms": ms, "p50_iteration_ms": p50,
            "images_per_s": V2_VGG_BATCH / (p50 / 1e3),
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "test_cost_card": card_test, "test_cost_cpu": cpu_test,
            "test_rel_err": test_err, "logits_err_of_max": logits_err,
            "step_grad_of_norm": grads,
            "check_s": check_s,
            "kernel_launches": launches, "card": smi_line()}


def _v2_fit_a_line(v2, device=None):
    """tests/test_v2_api.py::test_v2_fit_a_line_event_loop's topology in
    the current world: (pred, cost, parameters)."""
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
    y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
    pred = v2.layer.fc_layer(input=x, size=1)
    cost = v2.layer.square_error_cost(input=pred, label=y)
    return pred, cost, v2.create(cost, device=device)


def _v2_fit_run(torch, v2):
    """(b): fit_a_line for V2_FIT_PASSES passes on the card; infer on 8
    test samples on the card and on the CPU from the trained
    parameters."""
    import numpy as np

    samples = [(s[0],) for _, s in zip(range(8),
                                       v2.dataset.uci_housing.test()())]
    with _v2_world():
        pred, cost, params = _v2_fit_a_line(v2)
        trainer = v2.SGD(cost=cost, parameters=params,
                         update_equation=v2.optimizer.Momentum(
                             momentum=0.9, learning_rate=1e-2))
        costs, passes, ms = [], [], []

        def handler(e):
            if isinstance(e, v2.event.EndIteration):
                costs.append(e.cost)
            elif isinstance(e, v2.event.EndPass):
                passes.append(e.pass_id)

        t0 = time.perf_counter()
        trainer.train(reader=v2.batch(v2.dataset.uci_housing.train(), 32),
                      num_passes=V2_FIT_PASSES, event_handler=handler,
                      feeding={"x": 0, "y": 1})
        train_s = time.perf_counter() - t0
        card = v2.infer(output_layer=pred, parameters=params,
                        input=samples, feeding={"x": 0})
        with _v2_world():
            cpu_pred, _, cpu_params = _v2_fit_a_line(v2, device="cpu")
            _v2_copy(cpu_params, params)
            cpu = v2.infer(output_layer=cpu_pred, parameters=cpu_params,
                           input=samples, feeding={"x": 0}, device="cpu")
    if passes != list(range(V2_FIT_PASSES)) or not all(np.isfinite(costs)):
        raise RuntimeError(f"v2 fit_a_line passes {passes} costs {costs}")
    if not costs[-1] < costs[0] / 3:
        raise RuntimeError(f"v2 fit_a_line cost {costs[0]} -> {costs[-1]}: "
                           "not 3x lower")
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    if card.shape != (8, 1) or not err <= V2_INFER_TOL:
        raise RuntimeError(f"v2 infer card vs CPU: shape {card.shape}, "
                           f"{err} of the max (> {V2_INFER_TOL})")
    return {"iterations": len(costs), "cost_first": costs[0],
            "cost_last": costs[-1], "train_s": train_s,
            "infer_rel_err": err}


def _v2_conv_operator(v2, trans):
    """test_round4_detection_and_conv_operator_execute's conv_operator at
    V2_CONV's size: (img, filt, out, [img@GRAD, filt@GRAD]) for a
    weighted sum of the output."""
    import paddle_tpu_torch.fluid as fluid

    c, hw, nf, k = (V2_CONV[n] for n in ("channels", "hw", "filters", "k"))
    img = v2.layer.data(name="img", type=v2.data_type.dense_vector(
        c * hw * hw))
    filt = v2.layer.data(name="filt", type=v2.data_type.dense_vector(
        nf * c * k * k))
    img.stop_gradient = filt.stop_gradient = False
    x4 = fluid.layers.reshape(img, shape=[-1, c, hw, hw])
    out = v2.layer.mixed_layer(input=[v2.layer.conv_operator(
        x4, filt, filter_size=k, num_filters=nf,
        padding=V2_CONV["padding"], trans=trans)])
    dy = v2.layer.data(name="dy", type=v2.data_type.dense_vector(
        int(out.shape[-1])))
    loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, dy))
    return [out] + list(fluid.calc_gradient(loss, [img, filt]))


def _v2_op_ms(torch, fn, device, n=20):
    """Median ms of ``fn()``: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if device == "cpu":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _v2_conv_run(torch, v2):
    """(c): conv_operator forward and both gradients, card vs CPU, in
    both forms; conv2d_input_filter's forward timed on each."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward

    b, c, hw, nf, k = (V2_CONV[n] for n in ("batch", "channels", "hw",
                                            "filters", "k"))
    rng = np.random.RandomState(2031)
    out = {}
    for trans in (False, True):
        with _v2_world() as (main, startup):
            fetch = _v2_conv_operator(v2, trans)
            width = int(fetch[0].shape[-1])
            feed = {"img": rng.rand(b, c * hw * hw).astype(np.float32),
                    "filt": rng.randn(b, nf * c * k * k).astype(np.float32),
                    "dy": rng.randn(b, width).astype(np.float32)}
            vals = {}
            for dev in (CARD, "cpu"):
                exe, scope = fluid.Executor(dev), fluid.Scope()
                exe.run(startup, scope=scope)
                vals[dev] = [np.asarray(v) for v in exe.run(
                    main, feed=feed, fetch_list=fetch, scope=scope)]
        errs = {}
        for name, g, w in zip(("out", "img_grad", "filter_grad"),
                              vals[CARD], vals["cpu"]):
            errs[name] = float(np.abs(g - w).max() / np.abs(w).max())
            if not errs[name] <= V2_CONV_TOL:
                raise RuntimeError(
                    f"conv_operator trans={trans} {name}: card vs CPU "
                    f"{errs[name]} of the max (> {V2_CONV_TOL})")
        op_ms = {}
        x = feed["img"].reshape(b, c, hw, hw)
        f = feed["filt"].reshape(b, nf, c, k, k)
        for dev in (CARD, "cpu"):
            ctx = EmitCtx(device=dev)
            ins = {"X": [torch.from_numpy(x).to(dev)],
                   "Filter": [torch.from_numpy(f).to(dev)]}
            attrs = {"stride": 1, "padding": V2_CONV["padding"],
                     "trans": trans}
            op_ms[dev] = _v2_op_ms(torch, lambda: run_forward(
                ctx, "conv2d_input_filter", ins, attrs), dev)
        out["trans" if trans else "forward"] = {
            "out_shape": list(vals[CARD][0].shape), "errs": errs,
            "op_ms_card": op_ms[CARD], "op_ms_cpu": op_ms["cpu"]}
    out["config"] = (f"conv_operator: img {c}x{hw}x{hw}, {nf} filters "
                     f"{k}x{k}, padding {V2_CONV['padding']}, batch {b}")
    return out


def _v2_legacy_run(torch):
    """(d): V2_LEGACY_CONFIG through compat.trainer_config_helpers behind
    a ``paddle`` module, V2_LEGACY_STEPS SGD steps on the card."""
    import types

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.compat import trainer_config_helpers as tch

    keys = ("paddle", "paddle.trainer_config_helpers")
    saved = {k: sys.modules.get(k) for k in keys}
    pkg = types.ModuleType("paddle")
    pkg.trainer_config_helpers, pkg.__path__ = tch, []
    sys.modules.update(dict(zip(keys, (pkg, tch))))
    tch.reset()
    try:
        with _v2_world() as (main, startup):
            tch.declare_input_types({"label": "int"})
            exec(compile(V2_LEGACY_CONFIG, "<legacy config>", "exec"),
                 {"__name__": "legacy_config"})
            cfg = tch.get_config()
            (loss,) = cfg["outputs"]
            fluid.optimizer.SGD(learning_rate=float(
                cfg["settings"]["learning_rate"])).minimize(loss)
    finally:
        tch.reset()
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    rng = np.random.RandomState(7)
    n = cfg["settings"]["batch_size"]
    feed = {"pixel": rng.rand(n, 3 * 32 * 32).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    (costs, ms), launches = _held_window(lambda: _timed_steps(
        exe, main, [feed] * V2_LEGACY_STEPS, [loss], scope))
    if not all(np.isfinite(costs)):
        raise RuntimeError(f"legacy config costs not finite: {costs}")
    return {"config": "img_conv_layer(32 3x3) -> img_pool_layer(2) -> "
                      f"fc_layer(10) -> classification_cost, batch {n}",
            "ops": len(main.global_block().ops), "costs": costs,
            "step_ms": ms, "kernel_launches": launches}


def v2_phase(torch):
    """The v2 API and the legacy config DSL on the card (see the module
    docstring)."""
    phase("v2")
    import paddle_tpu_torch.v2 as v2

    t_phase = time.perf_counter()
    v2.init(use_gpu=CARD == "cuda")
    out = {"vgg16": _v2_vgg_run(torch, v2)}
    log("  (a) v2 VGG-16 " + json.dumps(out["vgg16"]))
    out["fit_a_line"] = _v2_fit_run(torch, v2)
    log("  (b) v2 fit_a_line " + json.dumps(out["fit_a_line"]))
    out["conv_operator"] = _v2_conv_run(torch, v2)
    log("  (c) conv_operator " + json.dumps(out["conv_operator"]))
    out["legacy"] = _v2_legacy_run(torch)
    log("  (d) legacy config " + json.dumps(out["legacy"]))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  v2 phase: {out['seconds']:.1f} s")
    return out


def _parallel_launches(parallel, kname):
    """A kernel's launches a step on each way of the parallel phase."""
    return {w: r["launches_per_step"].get(kname, 0)
            for w, r in parallel["transformer"]["ways"].items()}


def _k4_bf16_row(mesh_serve):
    """K4 on bf16 pages: timed at decode B=8 (its prefill and verify
    rows beside), launches from the bf16 pool's window (mesh serve
    phase)."""
    k4b = mesh_serve["k4_bf16"]
    dec = k4b["decode"]
    pool = mesh_serve["bf16_pool"]
    return _kernel_row(
        "paged_attention_bf16", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/fluid/ops/pallas_kernels/paged_attention.py:268 (bf16 "
        "pages, widened to float32 on load at :188-190)",
        pool["k4_bf16_launches"], mesh_serve["k4_bf16_err"], dec,
        launches_from=f"a GPT-2-medium decoder stepped {pool['steps']} "
                      "times through a bf16 PagedKvCache",
        library="sdpa on K/V gathered and widened to float32 (the gather "
                "untimed), in turns with the kernel",
        shape=dec["shape"], bound_peak=dec["bound_peak"],
        prefill=k4b["prefill"], verify=k4b["verify"],
        **{k: k4b[k] for k in ("decode_d264", "decode_d512", "prefill_d264",
                               "prefill_d512")},
        bf16_q_ulps_of_max=k4b["bf16_q_ulps_of_max"], bf16_pool=pool,
        mesh_serve={k: mesh_serve[k] for k in (
            "engine", "checkpoint", "sp_transformer", "pipeline",
            "seconds")})


def _kernel_row(name, source, replaces, launches, err, row, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra}


def main():
    import torch

    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    open(LOG_PATH, "w").close()
    name, smi = device_phase(torch)
    ptxas, finish_build = build_phase()
    train_errs, train_rows = train_kernels_phase(torch)
    k5_err, k5_rel, k5_rows, k5_fwd = infer_kernels_phase(torch)
    finish_build()
    max_err, timings = kernels_phase(torch)
    launches, serve, serve_ref = serve_phase(torch)
    read_ms = host_read_ms(torch)
    log(f"  host logits read [8, 50257] f32: {read_ms:.4f} ms (median)")
    spec = spec_serve_phase(torch, serve_ref)
    workloads = workloads_phase(torch)
    train_launches, train = train_phase(torch)
    check_phase(torch)
    train["check"] = train_check_phase(torch)
    infer_launches, infer, built = infer_phase(torch)
    infer["check"] = infer_check_phase(torch, built)
    del built
    resnet_train, trained = resnet_train_phase(torch)
    resnet_train["check"] = resnet_train_check_phase(torch, trained)
    fold = resnet_fold_phase(torch, trained)
    del trained
    amp_err, amp_fwd, amp_combine = amp_kernels_phase(torch)
    infer_amp = infer_amp_phase(torch, amp_fwd["split_convs_per_forward"])
    resnet_amp, trained = resnet_train_amp_phase(torch)
    resnet_amp["check"] = resnet_amp_check_phase(torch, trained)
    del trained
    train_amp = train_amp_phase(torch)
    bf16_errs, bf16_rows = bf16_kernels_phase(torch)
    bench_bf16 = flash_bf16_bench_phase(torch)
    train_bf16 = train_bf16_attn_phase(torch)
    data_paths = {"fit_a_line": fit_a_line_phase(torch),
                  "lstm_train": lstm_train_phase(torch),
                  "resnet_recordio": resnet_recordio_phase(torch)}
    control_flow = {"dynamic_rnn": dynamic_rnn_phase(torch),
                    "seq2seq": seq2seq_phase(torch)}
    recipe = train_recipe_phase(torch)
    text_book = text_book_phase(torch)
    vision = vision_phase(torch)
    sparse = sparse_phase(torch)
    parallel = parallel_phase(torch)
    mesh_serve = mesh_serve_phase(torch)
    pserver = pserver_phase(torch)
    fleet = fleet_phase(torch, serve_ref)
    elastic = elastic_phase(torch)
    analysis = analysis_phase(torch, serve_ref)
    v2_paths = v2_phase(torch)
    log("  data input paths (no kernel of the port on them) " +
        json.dumps({k: {m: v[m] for m in v if m in (
            "p50_step_ms", "steps_per_s", "p50_step_ms_after_first",
            "words_per_s", "p50_pipeline_ms", "p50_dict_ms")}
            for k, v in data_paths.items()}))
    log("  control-flow paths (no kernel of the port on them) " +
        json.dumps({
            "dynamic_rnn": {m: control_flow["dynamic_rnn"][m] for m in (
                "p50_step_ms_after_first", "words_per_s")},
            "seq2seq_train": {m: control_flow["seq2seq"]["train"][m] for m
                              in ("p50_step_ms_after_first",
                                  "target_words_per_s")},
            "seq2seq_decode": {m: control_flow["seq2seq"]["decode"][m]
                               for m in ("ms", "loop_iterations",
                                         "host_syncs")}}))
    log("  train recipe " + json.dumps({
        **{key: {m: recipe["timing"][key][m] for m in (
            "p50_step_ms_after_first", "tokens_per_s",
            "peak_memory_allocated_gb")}
           for key in ("plain", "recompute")},
        "in_turns": recipe["timing"]["in_turns"]["median_ms"]}))
    log("  text book paths (no kernel of the port on them) " + json.dumps({
        k: {m: v[m] for m in ("p50_step_ms_after_first", "tokens_per_s",
                              "device_launches_a_step", "busy_share")}
        for k, v in text_book.items()}))
    log("  vision paths (no kernel of the port on them) " + json.dumps({
        k: {m: v[m] for m in ("p50_step_ms_after_first", "images_per_s",
                              "device_launches_a_step", "busy_share")}
        for k, v in vision.items() if k in VISION_MODELS or k == "ssd300"}))
    log("  sparse paths (no kernel of the port on them) " + json.dumps({
        **{k: {m: v[m] for m in ("p50_step_ms_after_first",
                                 "device_launches_a_step", "busy_share",
                                 "peak_memory_allocated_gb")}
           for k, v in sparse.items()
           if isinstance(v, dict) and "p50_step_ms_after_first" in v},
        "v1m": {k: {m: sparse["v1m"][k][m] for m in (
            "p50_step_ms_after_first", "peak_above_state_gb")}
            for k in ("sparse", "dense")},
        "v1m_in_turns_ms": sparse["v1m"]["in_turns_median_ms"]}))
    log("  v2 paths (no kernel of the port on them) " + json.dumps({
        "vgg16": {m: v2_paths["vgg16"][m] for m in (
            "p50_iteration_ms", "images_per_s", "peak_memory_allocated_gb",
            "test_rel_err", "logits_err_of_max")},
        "vgg16_step_grad_of_norm": {
            n: {m: g[m] for m in ("card", "cpu", "plain_f32", "bound")}
            for n, g in v2_paths["vgg16"]["step_grad_of_norm"].items()},
        "fit_a_line_infer_rel_err": v2_paths["fit_a_line"]["infer_rel_err"],
        "conv_operator_op_ms": {
            form: [v2_paths["conv_operator"][form][m]
                   for m in ("op_ms_card", "op_ms_cpu")]
            for form in ("forward", "trans")},
        "legacy_costs": v2_paths["legacy"]["costs"],
        "seconds": v2_paths["seconds"]}))
    from paddle_tpu_torch.kernels import paged_attention as pa

    dec = timings["decode"]
    per_target = serve["kernel_launches"] / serve["target_steps_total"]
    small = spec["windows"]["small"]
    per_draft = ((small["kernel_launches"] - per_target
                  * small["steps"]["serving.decode.target_steps"])
                 / small["steps"]["serving.decode.spec.draft_steps"])
    fa_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fa_py = "paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py"
    ln_bf16 = train_rows["layer_norm_bf16"]
    # launches a step of Transformer-base under the recipe, with and
    # without recompute (train recipe phase)
    recipe_launches = {
        k: {"plain": recipe["timing"]["plain"]["launches_per_step"][k],
            "recompute": recipe["timing"]["recompute"][
                "launches_per_step"][k]}
        for k in RECIPE_LAUNCHES[True]}
    train_kernels = [
        _kernel_row("layer_norm_f32", "paddle_tpu_torch/csrc/layer_norm.cu",
                    "paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:42",
                    train_launches["layer_norm_f32"],
                    train_errs["layer_norm_f32"],
                    train_rows["layer_norm_f32"], train=train,
                    recipe_launches_per_step=recipe_launches[
                        "layer_norm_f32"], train_recipe=recipe,
                    parallel_launches_per_step=_parallel_launches(
                        parallel, "layer_norm_f32"), parallel=parallel,
                    pserver_launches_per_step=pserver["transformer"][
                        "launches_per_step"]["layer_norm_f32"],
                    pserver=pserver,
                    elastic_launches_per_step=elastic[
                        "launches_per_step"]["layer_norm_f32"],
                    elastic=elastic,
                    analysis_launches_per_step=analysis["train"]["on"][
                        "launches_per_step"]["layer_norm_f32"],
                    analysis=analysis),
        _kernel_row("layer_norm_bf16", "paddle_tpu_torch/csrc/layer_norm.cu",
                    "paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:42 "
                    "(bf16 x, widened on load at :17)",
                    ln_bf16["program"]["launches"]["layer_norm_bf16"],
                    train_errs["layer_norm_bf16"], ln_bf16,
                    launches_from="the cast -> layer_norm program",
                    shape=ln_bf16["shape"], library=ln_bf16["library"],
                    host_us=ln_bf16["host_us"], program=ln_bf16["program"]),
    ]
    for kname, line in (("flash_fwd_f32", 111), ("flash_bwd_dkdv_f32", 295),
                        ("flash_bwd_dq_f32", 320)):
        rows = train_rows[kname]
        row = dict(rows["full"])
        if kname == "flash_bwd_dq_f32":
            # one library call computes dQ, dK and dV: the K3a row's
            row["library_ms"] = train_rows["flash_bwd_dkdv_f32"]["full"][
                "library_ms"]
            row["library"] = SDPA_LIBRARY
        extra = {key: row[key] for key in ("bound_f32_ms", "bound_peak",
                                           "library")
                 if key in row}
        for key in ("whole_backward", "vs_float64", "in_turns",
                    "head_dim_256", "head_dim_264", "head_dim_512"):
            if key in rows:
                extra[key] = rows[key]
        if kname == "flash_fwd_f32":  # the library's three kernels
            extra["ptxas"] = ptxas.get("flash_attention")
        train_kernels.append(_kernel_row(
            kname, fa_src, f"{fa_py}:{line}", train_launches[kname],
            train_errs[kname], row, shape=row["shape"],
            causal=rows["causal"],
            recipe_launches_per_step=recipe_launches[kname],
            parallel_launches_per_step=_parallel_launches(parallel, kname),
            pserver_launches_per_step=pserver["transformer"][
                "launches_per_step"][kname],
            elastic_launches_per_step=elastic["launches_per_step"][kname],
            analysis_launches_per_step=analysis["train"]["on"][
                "launches_per_step"][kname],
            **extra))
    infer_kernels = [_kernel_row(
        "conv_bn_relu_f32", "paddle_tpu_torch/csrc/conv_bn_relu.cu",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69",
        infer_launches, k5_err, k5_fwd,
        timed_as=f"sum over the {CONVS_PER_FORWARD} convolutions of one "
                 f"batch-{INFER_BATCH} ResNet-50 forward",
        bound_f32_ms=k5_fwd["bound_f32_ms"], bound_peak=CONV_PEAK,
        forward=k5_fwd, max_rel_err=k5_rel, shapes=k5_rows,
        ptxas=ptxas.get("conv_bn_relu"), infer=infer, resnet_fold=fold,
        resnet_train=resnet_train, fleet_launches=fleet["auto"][
            "k5_launches"], fleet_batches=fleet["auto"]["batches"]),
        _kernel_row(
        "conv_bn_relu_bf16", "paddle_tpu_torch/csrc/conv_bn_relu.cu",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69",
        infer_amp["kernel_launches"]["conv_bn_relu_bf16"], amp_err, amp_fwd,
        timed_as=f"sum over the {CONVS_PER_FORWARD} convolutions of one "
                 f"batch-{INFER_BATCH} ResNet-50 forward, FLAGS['amp']",
        bound_peak=AMP_CONV_PEAK, forward=amp_fwd, infer_amp=infer_amp,
        resnet_train_amp=resnet_amp, train_amp=train_amp,
        ptxas=ptxas.get("conv_bn_relu")), _kernel_row(
        "conv_split_combine_bf16", "paddle_tpu_torch/csrc/conv_wgmma.cuh",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69 (the "
        "epilogue of a conv_bn_relu_bf16 launch whose plan splits K)",
        infer_amp["kernel_launches"]["conv_split_combine_bf16"],
        amp_combine["max_abs_err"], amp_combine,
        shape=amp_combine["shape"], partials=amp_combine["partials"],
        library_note=amp_combine["library_note"],
        host_us=amp_combine["host_us"])]
    for kname, line in (("flash_fwd_bf16", 111), ("flash_bwd_dkdv_bf16", 295),
                        ("flash_bwd_dq_bf16", 320)):
        rows = bf16_rows[kname]
        row = dict(rows["bh128_s512_full"])
        if kname == "flash_bwd_dq_bf16":
            # one library call computes dQ, dK and dV: the K3a row's
            row["library_ms"] = bf16_rows["flash_bwd_dkdv_bf16"][
                "bh128_s512_full"]["library_ms"]
        extra = {key: rows[key] for key in rows if key != "bh128_s512_full"}
        if kname in WGMMA_WIDE_KERNELS:
            # the wgmma body that head_dim 129-512 runs
            extra["ptxas_wide_body"] = ptxas.get(
                "flash_attention", {}).get(WGMMA_WIDE_KERNELS[kname])
        if kname == "flash_fwd_bf16":
            extra["ptxas"] = ptxas.get("flash_attention")
            # the wgmma body that head_dim <= 64 runs
            extra["ptxas_wgmma_body"] = ptxas.get(
                "flash_attention", {}).get(WGMMA_FWD_KERNEL)
            extra["flash_bf16_bench"] = bench_bf16
            extra["train_bf16_attn"] = train_bf16
        src = ("paddle_tpu_torch/csrc/" + (
            "flash_fwd_wgmma.cuh" if kname == "flash_fwd_bf16" else
            "flash_bwd_wgmma.cuh") + " (head_dim <= 64; 65-128 "
            "flash_attention_bf16.cuh; 129-512 flash_wide_wgmma.cuh "
            f"{WGMMA_WIDE_KERNELS[kname]}; above flash_wide.cuh)")
        train_kernels.append(_kernel_row(
            kname, src, f"{fa_py}:{line} (the bf16 branch)",
            train_bf16["kernel_launches"][kname], bf16_errs[kname], row,
            shape=row["shape"], library=row["library"],
            bound_peak=row["bound_peak"], **extra))
    delta = bf16_rows["flash_delta"]
    train_kernels.append(_kernel_row(
        "flash_delta", "paddle_tpu_torch/csrc/flash_delta.cuh",
        f"{fa_py}:280 (the jnp delta of _flash_bwd; no pallas_call)",
        train_bf16["kernel_launches"]["flash_delta"],
        max(bf16_errs["flash_delta"], train_errs["flash_delta"]),
        delta["bh128_s512_full"], shape=delta["bh128_s512_full"]["shape"],
        library_note=delta["bh128_s512_full"]["library_note"],
        launches_train_f32=train_launches["flash_delta"],
        recipe_launches_per_step=recipe_launches["flash_delta"],
        f32=train_rows["flash_delta"],
        **{k: v for k, v in delta.items() if k != "bh128_s512_full"}))
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "src": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/fluid/ops/pallas_kernels/"
                    "paged_attention.py:268",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": dec["kernel_ms"],
        "kernel_ms": dec["kernel_ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "library": "sdpa on K/V gathered dense (the gather untimed), in "
                   "turns with the kernel",
        "shape": "decode B=8 C=1 Hq=Hkv=16 D=64 ps=16 kv_lens "
                 + ",".join(str(x) for x in dec["kv_lens"]),
        "split_keys": pa.SPLIT_KEYS,
        "split_keys_wide": pa.SPLIT_KEYS_WIDE,
        "prefill": timings["prefill"],
        "decode_b1": timings["decode_b1"],
        "decode_gqa4": timings["decode_gqa4"],
        "decode_d264": timings["decode_d264"],
        "decode_d512": timings["decode_d512"],
        "prefill_d264": timings["prefill_d264"],
        "prefill_d512": timings["prefill_d512"],
        "verify": timings["verify"],
        "draft_decode": timings["draft_decode"],
        "launches_per_target_step": per_target,
        "launches_per_draft_step": per_draft,
        "launches_per_step_from": "the serve window's launches over its "
                                  "target steps; the small-draft window's "
                                  "launches less that x its target steps, "
                                  "over its draft steps",
        "spec_serve": spec,
        "workloads": workloads,
        "decode_row": dec,
        "case_errors": timings["errors"],
        "bitwise": timings["bitwise"],
        "ptxas": ptxas.get("paged_attention"),
        "serve": serve,
        "host_logits_read_ms": read_ms,
        "mesh_engine": {k: mesh_serve["engine"][k] for k in (
            "k4_launches_per_target_step", "p50_step_ms", "step_ratio_p50",
            "tokens_bitwise", "k4_local_map")},
        "fleet": fleet,
        "analysis_serve": analysis["serve"],
    }, _k4_bf16_row(mesh_serve)] + train_kernels + infer_kernels}
    phase("done")
    log(json.dumps(kernels))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-trainer"]:
        # a trainer process of the elastic phase
        sys.exit(elastic_trainer_main(json.loads(sys.argv[2])))
    try:
        main()
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(1)
