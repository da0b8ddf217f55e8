#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) end to end on one GPU.

    python3 chip_smoke.py            # every phase, exit 0 only if all pass
    python3 chip_smoke.py --kernels  # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --profile  # also profile serving, train, vision
    python3 chip_smoke.py --phases ernie,static  # these after 1-2, no result
    python3 chip_smoke.py --phases dist          # phase 15 alone
    python3 chip_smoke.py --phases ps            # phase 16 alone
    python3 chip_smoke.py --phases onnx          # phase 10b alone
    python3 chip_smoke.py --phases store         # phase 10c alone

Phases:
 1. card      name and power limit from nvidia-smi, torch/CUDA versions,
              the matmul settings (no TF32; 16-bit GEMMs reduce in fp32)
 2. build     nvcc builds every kernel from paddle_tpu_torch/csrc, timed;
              ptxas' registers and spills of every instantiation
 3. kernels   each kernel's wrapper against its plain PyTorch version on
              the card at the main paths' shapes (max abs error, kernel
              ms, plain ms, the least time the card could take, and one
              PyTorch library call where one computes the same function;
              CUDA-event time per call, and for K1, K2, K2's library
              call and K5 the device time per call beside it, see
              _time_ms):
              K1 paged decode (phase 3's 8 slots of random lengths, the
              decode profile's 8 x 230 tokens, 2 x 1024 tokens, and phase
              3's slots at head dims 80, 96, 256, 36 and 264; fp32, bf16
              and fp16;
              the split count per row), K2 flash forward (serving
              shape, fp32, bf16 and fp16, and the training shape with
              dropout), K3 flash dQ and K4 flash
              dK/dV (training shape, dropout 0 and 0.1, fp32, bf16 and
              fp16; head dims 128 and 32 at the train width, fp32 and
              bf16; Sq 1024 != Sk 1536; head dims 80, 96 and 256, which
              run at padded widths, in fp32, bf16 and fp16), with the
              achieved TFLOP/s;
              FlashAttention's gradients against autograd through the
              plain forward; gradients reaching q/k/v through K2 (C4)
 4. model     GPT-2 small (GPTConfig() defaults, fp32, seed 0): a [2,1024]
              full forward through the flash kernel against the plain path
 5. serving   GenerationEngine (8 slots, page 16, buckets 16/64/256/1024)
              serving 16 greedy streamed requests, some joining while
              others decode; every output token-identical to the port's
              own generate(); kernel launch counts read off this run;
              the observability gates (check_observability): the step
              ring read from /steps sums to stats() and the requests,
              its goodput buckets tile each iteration's wall exactly,
              /metrics over 127.0.0.1 shows STAT_kv_cache_hbm_bytes equal
              to the live caches' bytes, the device-memory gauge and one
              ttft_ms / tpot_ms count a request, /healthz 200;
              then a GPT with head dim 96 (hidden 768, 8 heads, 2 layers)
              serving 4 requests through K1, token-identical to generate(),
              its 300-token prompt prefilled through K2 at head dim 96
 5b. features GPT-2 small served with the JAX engine's three scheduling
              features, each against generate() and the engine with it
              off: a prefix arm (8 requests sharing a 192-token system
              prompt + a full-prompt repeat, cache on / off at equal
              pages: hits, one CoW split, K1 once a layer a step, no
              page leaked; TTFT p50), a spec arm (spec_k 4: the
              NGramProposer on motif prompts, spec off, an oracle
              proposer with acceptance 1.0 in <= ceil(64/5)+1 steps, a
              reject proposer and a later owner of its pages; no K1
              launch; tokens/s) and a chunk arm (a 900-token prompt
              joining 4 live streams with prefill_chunk 128, then 0:
              8 chunks and no K2 launch, then K2; the live streams'
              TPOT p50 and p99)
 5c. quant    GPT-2 small quantized on phase 5's engine settings and 16
              requests (int4 and fp16 arms: the first 8): weight-only
              int8 and int4 weights over fp32 pools
              (each token-identical to generate() on the same quantized
              model; K1 once a layer a step; K2 for the long prompts;
              resident weight bytes), fp32 weights over int8 pools twice
              (first token exact against fp32 pools, bit-stable, no K1;
              agreement, flip margins and can_admit capacity at equal pool
              bytes recorded), int8 pools with the prefix cache on 5b's
              prefix requests (the miss identical to the cache off, every
              other output up to a near-tie flip; one CoW split, freed
              pages' scale rows 0) and an fp16 GPT-2 small over fp16
              pools (first tokens exact, identical to its generate() up
              to near-tie flips, K1 in fp16); with --profile, the
              quantized decode steps' device time
 5d. tier    GPT-2 small with the prefix cache (80 pages) and the host
              KV tier on: four 592-token system prompts served one at a
              time, then again with new tails, so each revisit promotes
              its demoted chain; fp32 and int8 pools and the two tier
              failpoints (promote_upload@2, demote_gather@1); every output
              identical to a never-evicting engine (fp32: and to
              generate()), the audit counts each arm implies, no page
              leaked on either tier, K1 = steps x 12 (fp32), K2 = 12 x the
              cold prefills, the observability gates; TTFT of promoted
              against cold against device hits, the revisit's admission
              iteration by part, promotion ms a page, its H2D rate and
              host ms by part, demotion ms (host and stream), garbage
              collections, tokens/s with the step log, audit ring and
              spans on against off, and the host time of each
              observability call an iteration
 5e. fleet   GPT-2 small at phase 5's engine settings under the
              supervisor and the router. (a) Phase 5's 16 streamed
              requests (8 joining while 8 decode) through one
              EngineSupervisor (backoff 5 ms): decode_step_raise@12 (8
              live, 8 queued at the death), prefill_raise@1, and a
              spec_k 4 engine whose poison storm turns speculation off
              before decode_step_raise@1; each identical to generate(),
              every stream exactly once, one ENGINE_RESTART, REPLAY_ADMIT
              = the manifest's entries = the STAT_gen_replayed_requests
              delta, incarnation 1, no ledger key, no nvcc and the same
              loaded libraries, K1 = 12 x (decode steps of both
              incarnations + the rebuild's warmup step), K2 = 12 x the
              prefills in the 1024 bucket, no page leaked, the residency
              gauge back to one cache, the dead pools released, and the
              restart's peak allocated bytes under the death step's +
              half a pool set; the breaker arm (every step dies, retry
              limit 2, threshold 3): every request typed
              UnavailableError, BREAKER_OPEN once, /readyz 503 with the
              reason. (b) A Router over two supervised replicas (prefix
              cache on): four agent sessions of three turns with
              affinity on (turns 2-3 on turn 1's replica, 8
              ROUTE_AFFINITY) and off, identical to generate(); phase 5's
              requests with decode_step_raise@6 killing one replica
              (every request served through its replay, no
              ROUTE_REROUTE, the router's /readyz 200 throughout); two
              replicas against one engine, tokens/s. Printed: recovery
              ms, death to the first replayed token, steady and peak
              allocated bytes, prefix-hit tokens and TTFT with affinity
              on and off
 6. train     GPT-2 small (dropout 0.1, fp32) trained through
              hapi.Model.fit: AdamW under LinearWarmup, global-norm clip,
              cross-entropy, batch 8 x 1024, 20 steps over a seeded
              learnable token set; the loss falls and stays finite, every
              flash kernel launched 12 times a step; then one train_batch
              through the kernels against one through the plain path
              (dropout 0, [2, 1024]): loss and every gradient agree.
              Then the same fit under amp_configs="O1" (bf16; K2-K4
              launched 12 times a step, all counted in bf16), and the
              fp16 AMP loop of the same 20 steps (auto_cast(dtype=
              "float16") + GradScaler; K2-K4 counted in fp16), and the
              AMP step parities at [2, 1024], kernels against
              FLAGS_use_flash_attention=False under the same AMP: one
              bf16 train_batch, one hand-written amp.auto_cast(dtype=
              "float16") step with GradScaler (K2-K4 counted in fp16)
 7. packing   the packed LM of bench.py --mode packing at its full size
              (T 1024, hidden 256, 4 heads, vocab 8192, 2048 sequences of
              clipped-lognormal lengths, 64 a pack) trained through
              hapi.Model.fit with io.PackingCollator: one epoch packed
              (first-fit), one padded (one sequence a row, 16 rows);
              effective tokens/s, fill, step wall, K5-K7 launches a step;
              the loss falls; then one packed epoch under
              amp_configs="O1" (K5-K7 counted in bf16, the loss falls)
              and one written out under auto_cast(dtype="float16") +
              GradScaler (K5-K7 counted in fp16); then packed-vs-padded loss parity on 8 sequences and one
              train_batch through K5-K7 against one through the dense
              segment-masked path
 8. ernie     the ERNIE/BERT encoder family through hapi.Model. (a)
              bench.py's headline configuration (bench.py:164-233):
              ERNIE-base (ErnieConfig.base(), seed 0),
              ErnieForSequenceClassification(2), AdamW 5e-5,
              CrossEntropyLoss, metric.Accuracy, amp_configs="O1" (bf16),
              batch 32 x seq 128, 40 fit steps over a seeded learnable
              set: the loss finite and falling, the fit's acc equal to
              Accuracy over its steps' logits, evaluate's acc equal to
              Accuracy over predict's logits, K2-K4 launched 0 times (seq
              128 is below the flash minimum); samples/s (the samples of
              steps 3-40 over their time on the device timeline, as
              bench.py counts a window) printed under the JAX bench's
              metric name, with the step p50 beside it. (b) ERNIE-base at batch 8 x seq
              512 with an attention_mask of seeded lengths 128-512,
              dropout 0.1, 12 fit steps in fp32 and then under O1 bf16:
              the loss falls, K2, K3 and K4 launched exactly 12 times a
              step in the path's type; real tokens/s. (c) one train_batch
              through K2-K4 against FLAGS_use_flash_attention=False at
              [2, 512] with a padding mask, dropout 0, for the classifier
              and ErnieForPretraining (MLM + NSP), in fp32 (phase 6's
              limits) and bf16 O1 (its AMP gradient limits; the loss to
              ERNIE_AMP_LOSS_TOL), with readings against a float64 step
              (fp32) and the fp32 step (bf16) printed beside them for
              the record. (d) BERT-large
              (BertConfig.large(): 24 layers, 16 heads of 64), one O1
              train_batch at [8, 512] with a padding mask: K2-K4 launched
              24 times each in bf16. Then, informational, (a)'s step at
              FLAGS_flash_attention_min_seq 512 and 128: wall a step,
              K2-K4 launches a step (0 and 12), and each step profiled
              (device ms, kernel table, GEMM share)
 9. vision    convolution, pooling and BatchNorm: vision.models ResNet-50
              through hapi.Model. (a) bench.py's second configuration
              (bench.py:236-291): resnet50(num_classes=1000), seed 0, not
              cut, Momentum(0.1), CrossEntropyLoss, Accuracy(topk=(1, 5)),
              amp_configs="O1" (bf16), NCHW, batch 32 x 3 x 224 x 224, 40
              fit steps on one seeded batch fed every step: the loss finite
              and falling, fit's acc_top1/top5 equal to Accuracy over its
              steps' logits, evaluate's equal to Accuracy over predict's
              logits (eval mode, the running buffers), every Conv2D's
              output bf16 and every BatchNorm2D's fp32 (forward hooks),
              K1-K7 launched 0 times; images/s printed under the JAX bench's
              metric name (the images of steps 3-40 over their window on the
              device timeline), with the step p50 and the peak allocated
              bytes. (b) one step at batch 2 x 224^2 from one set of
              weights: fp32 on the card against the port's CPU step and
              against a float64 card step, O1 bf16 against the fp32 step:
              loss, every gradient, the running buffers (limits from a CPU
              rehearsal, VISION_FP32 / VISION_AMP). (c) one O1 step each of
              mobilenet_v2, resnet18, vgg16(batch_norm=True) and
              ImperativeQuantAware().quantize(resnet50) (its 53
              QuantizedConv2D run): the loss finite. With --profile, (a)'s
              step profiled: device and wall ms, busy share, kernels, the
              conv, BatchNorm, elementwise and layout-transpose shares (the
              transposes named), the share of the bf16 dense peak
 9b. detect   YOLOv3 at DarkNet width in PaddleDetection's
              yolov3_darknet53_270e_coco settings (DETECT): (a)
              yolov3(num_classes=80, width=64), seed 0, 10 Momentum steps
              (0.9, lr 0.001, L2 5e-4) on one seeded batch of 8 x 3 x 608
              x 608 with 1-20 gt boxes an image in 50 slots, ignore_thresh
              0.7: every loss finite, the mean of the last 3 under the
              first 3, K1-K7 launched 0 times; ms a step (CUDA events),
              images/s, peak allocated; --profile adds a device table.
              (b) predict (yolo_box, three scales) and multiclass_nms
              (score 0.01, nms_top_k 1000, keep_top_k 100, nms 0.45,
              background -1) in eval mode on 2 of those images, with the
              weights as built (every box a candidate): the card's
              kept rows equal the port's CPU NMS of the same card-made
              boxes and scores (labels, scores and order exactly, boxes
              within 1e-5); predict and NMS ms. (c) a narrow YOLOv3 (width
              8, 3 classes, 2 x 3 x 128^2): one step on the card against
              the CPU, loss rtol 1e-5, every gradient within phase 6's
              rule. (d) incubate on (c)'s net, 4 steps card against CPU
              at lr 1e-5, the updates within phase 7's rule:
              LookAhead(Momentum, k 2), ModelAverage (apply / restore),
              GradientMergeOptimizer(Momentum, k_steps 2)
10. export    models saved on the CPU through jit.save (a torch.export
              program, symbolic batch) and served on the card through
              inference.Predictor and serving.InferenceEngine (one lane,
              its own CUDA stream). (a) bench.py --mode serving's model
              and traffic (bench.py:428-593): the MLP 256 -> 1024 -> tanh
              -> 1024 -> tanh -> 256, seed 0; a serial Predictor.run loop
              of 200 rows; an engine over devices="all", buckets 1/4/16/64,
              batch delay 2 ms, queue depth 512, 64 submitters x 40
              requests with 4 outstanding (three phases, the best qps as
              bench.py), then the same with FLAGS_serving_spans off:
              every result bit-identical to its row served alone through
              a bucket and within 1e-5 of eager on the card,
              STAT_predictor_compiles (first runs of an input shape: an
              exported program compiles nothing, so this checks the
              warmup's coverage, not compilation) = lanes x buckets at
              warmup and 0 under load, the queue-depth gauge back to 0,
              the latency
              count = the requests; qps, p50/p99, serial qps, speedup,
              occupancy, spans-off qps. (b) ERNIE-base classifier (seed
              0, eval) with InputSpec([None, 512], "int64") for the ids
              and the attention_mask, in fp32 and in bf16 after O2
              amp.decorate: 64 one-row requests of lengths 128-512 from 16
              submitters through an engine over a Predictor (they
              coalesce into one bucket-64 batch), a load window of 10 x
              64 requests of the same rows with 8 outstanding a
              submitter, then two rows through the Predictor: logits
              against eager on the card (EXPORT_TOL), 12 flash_fwd nodes
              and no softmax in the program, K2 = 12 x the batches
              dispatched all in the path's type, the plain version never
              run, one warm per bucket; the load window's samples/s and
              p50/p99. (c) ResNet-50 (eval, running buffers
              from a seeded draw) through a Predictor at batch 32 x 224^2
              against eager; the int8 MLP (quantize_weights) served,
              against its eager model, STAT_quant_weight_hbm_bytes = its
              integer and scale bytes, STAT_quant_exports +1; a lane
              restart (FLAGS_serving_lane_restarts=1, a runner that dies
              once): only the dying batch's request fails, restarts 1,
              no new warm
10b. onnx     ONNX export from the port's own trace and the port's C
              inference API. (a) ErnieForSequenceClassification(
              ErnieConfig.base(), 2), seed 0, eval, fp32, on the card, in
              export_ernie's wrapper, exported by onnx.export at [4, 512]
              (int64 ids and attention_mask, export_ernie's seeded 128-512
              lengths): the trace holds 12 flash_fwd nodes, the ONNX graph
              none and no op tests/torch_onnx_eval.py does not know;
              every state_dict tensor is the initializer of its name bit
              for bit; the numpy evaluation of the graph equals the
              card's eager logits within EXPORT_TOL["float32"] x max(1,
              max |logit|), and that eager forward launches K2 12 times
              and the plain version 0 times. (b) resnet50(num_classes=
              1000), eval, export_resnet's seeded running buffers, at 1 x
              224^2: 53 Conv and 53 BatchNormalization nodes, initializers
              bit-equal, the evaluation within the same limit of eager.
              (c) the C API: an nn.TransformerEncoder at ERNIE-base width
              (12 x TransformerEncoderLayer(768, 12, 3072), seed 0, eval)
              saved by jit.save with InputSpec([None, 512, 768]) (its
              program holds K2), before (a); libpd_infer_capi built by
              g++ from paddle_tpu_torch/csrc (inference.capi.build()), and
              a C program built by gcc started, which makes its predictor
              through PD_NewPredictor (card 0) while (a) and (b) run;
              after them, the in-process create_predictor run of 4 rows
              launches K2 12 times and the plain version 0 times, and the
              C program runs the same rows through PD_PredictorRun (1 + 5
              runs, timed alone): its output within the same
              limit of the in-process run (bit-equality printed), and
              PD_NewPredictorWithDevice(prefix, 7) fails with a message
              while the program goes on. Printed: trace + write ms, file
              bytes, numpy eval s; the C process's predictor creation,
              first-run and steady ms a batch
10c. store    the serving program store, the kernel build cache and
              utils.cpp_extension, on GPT-2 small's widths (hidden 768,
              12 heads, vocabulary 50257, seed 0) cut to 4 layers,
              buckets 64 and 1024, 8 slots, page 16 (STORE). (a) phase
              2's libraries copied to a fresh directory; process A of (b)
              (`--store-worker a`) runs with FLAGS_xla_compilation_cache_dir
              there and nvcc made to raise: 0 nvcc runs, every library it
              loads from that directory. (b) 8 greedy
              requests filling both buckets through an in-process
              store-off engine, then through fresh processes A (empty
              store: it exports and writes every covered program, its
              ledger = the manifest's entries) and B (the same key:
              compiles {}, loaded = A's compiles): tokens identical to
              store off; in B K1 = 4 x steps and K2 = 4 x the 1024-bucket
              prefills, the store-off counts; over one idle decode step of
              B and of the store-off engine the pools keep their storage,
              the step's write lands in place, and B's peak allocation
              rise stays under store off's + half a pool set; no artifact
              as large as one weight matrix. (c) the decode entry's
              recorded in-place spec edited in the manifest: an engine in
              this process counts one STAT_pack_selfcheck_failures, dumps
              one flight record, exports decode again and stays
              token-identical. (d) the reference test's double_op built
              with g++ by cpp_extension.load and a load_op_from_callable
              square on 1M floats on the card: outputs on the card,
              exactly 2x and x^2, gradients 2 and 2x. Printed: warmup ms
              of store off, a miss and a hit, each artifact's bytes, B's
              pack_load_ms, the decode steps' allocation rise, the g++
              build s and ms a call
11. api       the top-level API (`import paddle_tpu_torch as paddle`).
              (a) every name of ops.{creation, manipulation, logic,
              reduction, search, linalg, legacy}, the 38 of extra_ops
              phase 12 does not hold, and the 12 of vision.ops, run on
              CUDA tensors (the default device) against the same call on
              CPU tensors, inputs from one numpy seed: exact (tensordot and
              the float formulae linspace / logspace / vander within
              API_TOL; extra_ops and vision.ops within 1e-5), reductions
              within 1e-5, linalg within 1e-4 on what is unique
              (reconstructions, singular / eigen values, residuals); the
              random ops on shape, type, range and replay (seed twice,
              set_rng_state(get_rng_state()), a flash dropout seed too);
              one line a family. (b) the 8-expert MoE GPT at GPT-2 small
              width (paddle.seed(0), GPTConfig(hidden 768, 12 layers, 12
              heads, intermediate 3072, use_moe=True, num_experts=8)),
              paddle.Model with AdamW and cross-entropy, batches of
              paddle.to_tensor token ids at 8 x 1024: MOE["STEPS"] fit
              steps in fp32, then from the same weights under
              amp_configs="O1": the loss finite and falling, K2-K4
              launched 12 times a step (all in the path's type), the plain
              attention 0 times; step wall and p50, device ms a step
              (torch.profiler), peak allocated; then one train_batch
              through K2-K4 against FLAGS_use_flash_attention=False at
              [2, 1024], dropout 0, phase 6's limits, on a batch that
              routes every token alike (every routing flip a near-tie).
              (c) paddle.save(net.state_dict()), a fresh model,
              set_state_dict(paddle.load(...)): the eval loss equal bit
              for bit
12. seq2seq   the rest of nn. (a) every name this slice adds to nn,
              nn.functional, nn.utils and optimizer (groups functional,
              loss, layers, rnn, clip_utils, optimizer; a name of a
              group's modules with no case fails) on CUDA tensors
              against the same call on the CPU, inputs from one numpy
              seed, modules built on the CPU from one seed and moved:
              exact (one_hot, sequence_mask, gather_tree, the pads,
              shuffles, unpool, beam ids), 1e-5 x max(1, |CPU|) (losses,
              interpolate, grid_sample, fold, the clips, nn.utils, three
              steps of each new optimizer with its states), 1e-4 for the
              recurrent layers in every mode with their gradients; the
              dropouts on statistics on the card. (b) the attention LSTM
              seq2seq of PaddleNLP's examples/machine_translation/seq2seq
              at IWSLT'15 width (models.seq2seq, SEQ2SEQ) built by the
              port alone, paddle.Model with Adam under
              ClipGradByGlobalNorm(5.0): SEQ2SEQ["STEPS"] fit steps at
              batch 128 on the reversal task (lengths 5-50): the loss
              finite and the mean of the last 3 steps under the first
              3's; step p50 on the device timeline, target tokens/s, peak
              allocated, the step profiled (device ms, kernels a step);
              then beam search (10) of 16 held-out sources to twice the
              longest: every beam's scores sorted, every sequence ends
              in EOS or at the step limit, the ids equal the port's CPU
              decode of the same weights up to near-ties (each first
              difference a pick between totals within NEAR_TIE); decode
              steps, ms a step, sentences/s. K1-K7 and the plain
              attention 0 times on the path. (c) one train_batch at
              batch 4 (dropout 0) on the card against the port's CPU step
              on the same weights: the loss to rtol 1e-5, every gradient
              within phase 6's fp32 limits
13. input     the input pipeline, with W = min(8, os.cpu_count() - 2)
              loader workers. (a) ResNet-50 in phase 9 (a)'s configuration
              (seed 0, O1, Momentum(0.1), CrossEntropyLoss,
              Accuracy(topk=(1, 5)), batch 32) trained one fit epoch from
              1,000 seeded uint8 HWC images of 256 x 256 x 3 (an
              io.Dataset, shared copy-on-write with the workers) through
              the ImageNet training transform (RandomResizedCrop(224),
              RandomHorizontalFlip, ToTensor, Normalize), shuffled,
              drop_last False (31 full batches and a tail of 8):
              DataLoader(num_workers=W) + DeviceFeeder with EarlyStopping
              and VisualDL, then num_workers=0 without a feeder. Gates:
              the loss finite; STAT_tail_pad_batches 1 each; every
              forward sees 32 rows; Accuracy counts 1,000 samples;
              STAT_dataloader_batches 32; the ring's segments at most its
              2W slots and STAT_shm_slots_reused 32 minus them; a counter
              the dataset bumps in the workers reads 1,000 in the parent;
              every leaf the feeder hands out on the card; VisualDL's
              train/loss records equal the logged losses, one a step, and
              add no STAT_train_host_syncs; no ring name left in /dev/shm;
              K1-K7 0 times. A byte check: with Resize(256) +
              CenterCrop(224) + ToTensor + Normalize, unshuffled, every
              worker + feeder batch equals the in-process loader's on the
              card. Printed: images/s of both fits (the real images of
              steps 3-32 over their window on the device timeline), step
              p50, the share of the fit's wall spent waiting on the feed,
              the feeder's overlap count, peak allocated, and phase 9
              (a)'s images/s of the same run; summary and flops of
              ResNet-50 at [1, 3, 224, 224]; utils.run_check(). (b)
              ERNIE-base in phase 8 (b)'s configuration (8 x 512, lengths
              from 128, dropout 0.1) on 99 rows, the last batch a tail of
              3, from DataLoader(num_workers=2) + DeviceFeeder, fp32 and
              O1: K2, K3 and K4 12 times a step each, the padded tail's
              step included, all in the path's type; the plain attention
              0 times; the loss finite and the mean of the last 3 steps
              under the first 3's; STAT_tail_pad_batches 1; each fit then
              again in process without a feeder, the same gates, for the
              step p50 beside it. (a) also runs W // 3 workers, printed
              and held to the common gates, and prints the feeder
              thread's fetch and stage spans
14. static    ERNIE-base cut to STATIC["LAYERS"] (4) encoder layers as a
              static Program (`static.program_guard`, the recorder's
              named ops: an `sdpa` op a layer on the flash kernels). (a)
              phase 8 (b)'s configuration (8 x 512,
              lengths 128-512, dropout 0.1, AdamW(1e-4).minimize, feeds
              input_ids / attention_mask / labels), STATIC["STEPS"]
              Executor.run steps in fp32, then after static.amp.decorate
              in bf16: the loss finite and falling (last 3 under the
              first 3), K2, K3 and K4 once a layer a step each, all in
              the arm's type, the plain attention 0 times; printed real
              tokens/s over steps 3 on, the step p50 and the device busy
              share of 3 more profiled steps. (b) at ERNIE_PARITY (dropout
              0, fp32) one Executor.run step against one dygraph
              Model.train_batch of the same weights: the loss to rtol
              1e-5, every update within phase 6's fp32 limits. (c) each
              arm's pruned eval Program through save_inference_model /
              load_inference_model: the loaded Program's logits and
              inference.Predictor's on the .pdmodel equal (a)'s within
              EXPORT_TOL, a flash_fwd node a layer in the .pdmodel; (b)'s
              Program loaded from its .ptprog trains one step with (b)'s
              update, K3/K4 through the flash_fwd op's autograd. (d)
              dy2static: jit.save of a to_static layer with a tensor
              `if` and a tensor `while`, loaded on the card, equal to
              eager in both branches. (e) the quantization passes on a
              static MLP (frozen Program card vs CPU),
              save_quantized_model -> Predictor, and the committed legacy
              ProgramDesc encoder (tests/data) through Predictor, card vs
              CPU. (f) ops.legacy's static pieces: a Program holding a
              create_parameter and a Print trains 3 SGD steps on the card
              equal to the same Program on the CPU, Print silent while the
              Program is built and printing at run time up to first_n
15. dist    multi-GPU, one process a rank. (a) World size 1 over NCCL in
              this process (distributed.init_parallel_env()): a packed
              LM at GPT-2 small's widths (12 heads at hidden 768,
              vocabulary 50304) and 4 layers (phase 7's packed
              sequences, 8 x 1024)
              trained 3 steps through parallel.make_sharded_train_step
              (dp 1, ZeRO-1) with K5-K7 through
              parallel.sharded_splash_attention, against the same steps
              of one process through the optimizer's own step (loss rtol
              1e-5, each update within phase 7's gradient rule); one AMP
              bf16 GPT-2 small step through DataParallel (its bucketed
              all-reduce over the 1-rank NCCL world) against the step
              without it, phase 6's AMP limits, K2-K4 12 times in bf16;
              phase 5's 16 greedy requests through a tp = 1 engine with
              the group live, identical to generate(). (b) Two ranks on
              this one card over gloo with CUDA tensors, spawned by
              distributed.spawn (a correctness arm: no time it prints is a
              multi-card number): which collectives gloo carries on CUDA
              tensors (the arms need all_reduce and all_gather); tp = 2
              serving of phase 5's 16 requests in fp32 and int8 pools (rank 0
              schedules; K1 on 6 local heads in each rank), identical to
              (a)'s tp = 1 up to near-ties (first tokens exact, a first
              flip only at a top-2 gap < NEAR_TIE); dp = 2 packed training
              of (a)'s model on the same global batch, ZeRO-1, 3 steps
              with dropout off (losses within rtol 2e-4 / atol 2e-5 of
              (a)'s) and on (the two ranks' keep shares on identical rows
              differ), each rank's optimizer bytes half of (a)'s. Printed:
              each arm's wall, peak allocated bytes and K1/K5-K7 launches.
              The strategies (the train steps fleet picks) on GPT-2
              small's widths at 4 layers (dropout 0, fp32, TF32 off, 8 x
              1024, SGD 0.1):
              (a) fleet.init + hapi Model.fit, 3 steps, bit-equal to
              make_sharded_train_step on the same batches, K2-K4 4 a
              step; the same fit under O1, K2-K4 all bf16. (b) two gloo
              ranks on the card (distributed.spawn; correctness only):
              the port's send / recv of a CUDA tensor and a ppermute hop
              bit for bit (ROADMAP C35; the probe's send_recv now goes
              through them); pp 2 (2 blocks a stage, 4 microbatches)
              GPipe with and without recompute and 1F1B, 2 steps each;
              sp 2 ring and Ulysses attention at S 1024 (512 a rank),
              causal, fp32 1e-5 and bf16 2e-2 x max(1, |ref|) against
              whole-sequence attention, and one sp step of the GPT with
              use_ring=True (K2-K4 never launched there); LocalSGD
              k_steps 1 (2 steps) and 4 (4 steps: the replicas equal
              right after the sync only); DGC at sparsity 0.999, 3 steps
              (k entries a tensor, more only at ties; emitted, u and v
              equal to dgc_compress on the CPU); hapi Model.fit under
              fleet.init + distributed_optimizer, routed through the
              strategy's step: a pipeline strategy (pp 2, 4
              microbatches) 2 epochs of the batch, and the default
              strategy (dp 2) over 12 rows at batch 8, whose padded tail
              folds its row mask over the global count, held to a
              world-1 fit of the same rows. Losses within rtol 2e-4
              / atol 2e-5 of the world-1 steps, updates within phase 7's
              rule widened by the weights' fp32 resolution; K2-K4
              launches as each arm implies, all fp32. The hybrid arms, on
              two gloo ranks of the card against world-1 references of
              (a) (3 steps each; losses within rtol 2e-4 / atol 2e-5,
              updates within phase 7's rule, each rank's blocks against
              the same blocks of world 1's): (c) ERNIE-base through
              models.tp_annotate at mp 2 on phase 8 (b)'s padded 8 x 512
              batch, AdamW 1e-4, dropout 0 and 0.1 (the attention's keep
              masks keyed on the global head; each parameter within PARAM
              but for the few elements AdamW moves on gradient noise,
              `_adam_worst`), and one O1 SGD step (its update within
              phase 6's AMP limits), K2-K4 12 a step on 6 heads a rank;
              (d) the
              8-expert MoE GPT at GPT-2 small's widths and 4 layers, ep 2
              (4 experts a rank, half the expert bytes); (e) (a)'s packed
              LM at dp 2 under ClipGradByGlobalNorm(1.0) at ZeRO-2
              and ZeRO-3 (half the parameter bytes a rank between steps),
              Lamb at ZeRO-1 against ZeRO-0, DGC at ZeRO-2 against ZeRO-0
              (the same entries kept each step); (f) GPipe at pp 2 of the
              strategies' GPT under the clip, fp32 and O1. Then launch
              --elastic of two ranks of the card, rank 1 hung before its
              first beat: the launcher names it and kills the job.
              (g) Serving lanes beyond one lane a world, four gloo ranks
              of the card (distributed.spawn; correctness only): (g1)
              phase 5d's traffic and tier settings at tp 2 (8 new
              tokens a request), fp32 pools on ranks 0-1 and int8 on a
              tp_mesh(2, devices=[2, 3]) lane at once, each beside a
              lane on the same ranks that never evicts: identical to
              it; against a tp 1 tier engine here, first tokens exact
              and first flips at gaps < NEAR_TIE, 4 KV_PROMOTE and its
              KV_DEMOTE / KV_TIER_EVICT and host bytes, a rank's slab
              half of its; K1 = both lanes' steps x 12 a rank (int8 0),
              K2 = 12 x their cold prefills a rank, nothing leaked.
              (g2) a supervised tp 2 lane under decode_step_raise@12 and
              prefill_raise@1, phase 5's 16 streamed requests (16 new
              tokens each): identical to (b)'s tp 2 lane, streams
              exactly once, one ENGINE_RESTART, REPLAY_ADMIT = the
              manifest's entries, incarnation 1 on both ranks, no group
              made by the rebuild, K1 = 12 x (both incarnations' steps +
              the rebuild's warmup) a rank. (g3)
              GenerationEngine(mesh=create_mesh({"dp": 2, "tp": 2})), a
              tp_mesh(2, devices=[2, 3]) lane beside an idle pair, the
              Router over two tp 2 replicas on ranks 0-1 (placements
              printed): each leader's outputs equal to (b)'s tp 2 lane's
              on 4 of its requests (16 new tokens at most); a follower
              raising inside a program ends its lane on both ranks
              within the 5 s bound with a LaneFault naming rank 1.
              Printed: each arm's wall
16. ps      the parameter server at PaddleRec's CTR-DNN widths (26 sparse
              slots, one Zipf-skewed id each hashed into 1,000,001, dim
              9; 13 dense features; 512-256-128-32 ReLU, 2 classes;
              batch 512), on seeded Criteo-shaped data with a planted
              logistic label. Eight server processes (two an arm) and two
              trainer processes are spawned at the start and killed with
              the phase. (a) DownpourWorker with synchronous push over two
              PsServer processes, SGD 0.05 on the table and the head, TF32
              off, 20 steps: losses within rtol 2e-4 / atol 2e-5 of a dense
              baseline on the card (nn.Embedding over the table's initial
              rows + the same head and batches), the touched rows within
              1e-5 x max |row| of the baseline's. (b) fleet.init with a PS
              role, init_server / run_server in the two server processes,
              fleet.init + init_worker here, DownpourWorker.
              train_from_dataset over an InMemoryDataset of 64 x 512
              records written by MultiSlotDataGenerator, Adam 1e-3 on both
              sides, async push: loss finite, the last 3 steps under the
              first 3, stop_worker leaves no server process; printed:
              samples/s, AUC on 4 held-out batches, the step's pull / H2D /
              device / D2H / push ms and the device busy share of 3
              profiled steps, the dataset's write / load / batching s. (c)
              the two trainer processes on the card against two servers
              each, async then geo (the head synced every 4 steps through
              a dense 'sum' table): losses finite and falling, each
              server's table rows summing to the distinct ids pulled,
              save -> load into fresh tables bit-exact. (d) the CTR-DNN's
              dense tower as a static Program, SGD 0.05, transpiled over
              two pservers for one trainer on the card, 4 steps, within
              rtol 2e-4 / atol 2e-5 of the local Executor.run on the card.
              (e) bench.py's bench_host_embedding configuration (dim 64,
              8192 ids, vocabulary 100,000): host_embedding_train_ids_per_
              sec_dim64, recorded. (f) apply_selected_rows on a CUDA
              parameter of 1,000,001 x 9 for SGD, Momentum, Adam and
              Adagrad: touched rows within 1e-6 x max(1, |ref|) of the CPU's
              update, untouched rows and accumulators bit-unchanged. No
              K1-K7 launch on the path
Phase 3 also holds the splash kernels to their plain versions: K5 splash
forward, K6 splash dQ and K7 splash dK/dV at GPT-2 small's attention
width (B 8, H 12, S 1024, D 64) and at the packing phase's shape, with
segment ids from io.PackingCollator over the bench's lengths (causal, p
0 and 0.1, fp32, bf16 and fp16, and a non-causal case whose absent
segment gives exact zero rows; the packing phase's shape in fp32, bf16
and fp16, and at head dims 80, 96 and 256 in the three types), with
the share of K5's (warp band, key tile) pairs that take its mask-free
path, the share of the 16x8 sub-tiles of K6's and K7's tiles that can
hold an allowed pair and, where the library call runs, K5 against the
library's forward and K6 + K7 against its whole backward;
SplashAttention's gradients against autograd through the plain forward.
Phase 3 also holds phase 15's dispatches (check_dist_kernels): K1 through
sharded_paged_attention at a tp rank's 6 and 3 local heads (D 64, page
16, fp32 and fp16) and its int8 pool path, and K5-K7 on dp rank 1's 4
rows of GPT-2 small's packed attention at the rank-folded dropout seed
(fp32, bf16), each against its plain version.
Phase 3 also holds K2, K3 and K4 at every shape and type at which a
phase 8 path launches them, non-causal, p 0.1: (b)'s and (c)'s [8, 12,
512, 64] on ERNIE's key-padding bias ((1 - m) * -1e4 over seeded
lengths) in fp32 and bf16; (a)'s step at flash minimum 128, [32, 12,
128, 64] bf16 with no bias (the whole sequence one key tile); and (d)'s
BERT-large, [8, 16, 512, 64] bf16 on the bias. The library's SDPA on the
same [B,1,1,S] float mask and p is the yardstick (K3 + K4 against its
whole backward). And K2 at phase 10 (b)'s inference shapes, [16, 12,
512, 64] and [64, 12, 512, 64], non-causal, p 0, on ERNIE's bias, fp32
and bf16, with SDPA on the same mask (K2_INFERENCE_BATCHES).
--profile's profiler sessions come after serving, so that run's train
and packing walls carry them; each train path (fp32, AMP) is profiled
over 3 steps with its GEMM share (phase 8 profiles its ERNIE-base step in
every run).
Then one JSON line describing the kernels (K1 also as a
"paged_attention.float16" row, K2-K4 as "flash_fwd.bfloat16"/".float16"
rows and K5-K7 as ".bfloat16" and ".float16" rows, their launches
counted in that type), and as the last line
{"ok": true, "device": {...}}. Any failed phase exits 1 with no result;
no CUDA device, or no paddle_tpu_torch next to this file, exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
# The fp32 bound is the fp32-accurate tensor-core rate, 3xTF32 (three TF32
# products a product): 495 / 3 TFLOP/s, the least time the card could take
# for fp32 products; the CUDA cores' 67 TFLOP/s is printed beside it.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12,
              "float16": 989e12}
CUDA_CORE_FP32 = 67e12

# kernel-vs-plain limits of K2-K4, x max(1, max |ref|) at the train shape
# (absolute at the serving shape): fp32 summation order (3xTF32); one
# rounding of P (K2) or dS / Pd (K3, K4) and of the output in the 16-bit
# types, float16 keeping 10 mantissa bits to bfloat16's 7
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
# K1 in fp16 (ROADMAP C10) against the plain version in fp32 on the same
# fp16 values, rounded to fp16: one rounding of an output below 4 in
# magnitude (ulp <= 2^-9) over fp32 sums
K1_FP16_TOL = 2e-3
K1_SHAPE = dict(B=8, H=12, D=64, P=16, PP=64)
K2_SHAPE = dict(B=2, H=12, S=1024, D=64)
TRAIN_SHAPE = dict(B=8, H=12, S=1024, D=64)   # the train phase's attention
TRAIN_STEPS = 20
DROPOUT = 0.1
# bench.py --mode packing, full size (bench.py:2348-2349, 2428, 2468)
PACK = dict(T=1024, DIM=256, HEADS=4, VOCAB=8192, NSEQ=2048, BS=64,
            HEADROOM=1.15, PAD_ROWS=16)
SPLASH_SHAPE = dict(B=8, H=12, S=1024, D=64)   # GPT-2 small's attention
# ROADMAP C11: head dims K2-K7 run at padded widths, each with the heads
# that keep about GPT-2 small's width (768) at the train and pack shapes
HEAD_DIM_CASES = ((80, 10), (96, 8), (256, 3))
# phase 5b's engines: phase 5's slots, page and buckets; spec_k of its
# spec arm
FEAT = dict(slots=8, page=16, buckets=(16, 64, 256, 1024), spec_k=4)
# phase 5c: a top-2 logit gap below which a token flip between two paths
# that round differently (an int8 prefix-cache hit against a miss; the
# fp16 engine's K1 against generate()'s dense fp16 attention) counts as a
# near-tie. Int8 pages move GPT-2 small's logits (std 0.55) by about 1e-3,
# and fp16 logits resolve 2^-9 = 1.95e-3 near its top logits; on an NVIDIA
# H100 80GB HBM3 at 700 W the flips sat at gaps of 2.9e-4 to 2.9e-3
# (PERF.md §2)
NEAR_TIE = 1e-2
# AMP step parity (kernels vs plain path under one AMP): loss rtol, a
# gradient's share of its own max, and the floor's share of the model's
# largest gradient (see Smoke.amp_step_parity)
AMP_LOSS_RTOL = {"bfloat16": 1e-3, "float16": 1e-3}
AMP_GRAD_SHARE = {"bfloat16": 2.5e-2, "float16": 1e-2}
AMP_GRAD_FLOOR = 1e-3
# phase 8 (c)'s bf16 loss: within 2e-2 x max(1, |loss|) (tests/
# test_torch_amp.py's bf16 limit on an op's output), not AMP_LOSS_RTOL.
# The classifier's loss comes from 2 rows, not from phase 6's 2048
# tokens, and the plain path rounds S, P and O to bf16 where the kernels
# keep them in fp32: on an NVIDIA H100 80GB HBM3 at 700 W the plain bf16
# loss sat 7.5e-3 (relative) from the fp32 step and the kernels' 7e-5,
# so AMP_LOSS_RTOL would read the plain path's rounding (PERF.md §2)
ERNIE_AMP_LOSS_TOL = 2e-2
# kernel names of the GEMMs in a profile (cuBLAS, cuBLASLt, CUTLASS)
_GEMM = r"gemm|nvjet|xmma|cutlass|splitKreduce"
# phase 8: ERNIE-base fine-tuning in bench.py's headline configuration
# (bench.py:164-233: ErnieForSequenceClassification, batch 32 x seq 128,
# AdamW 5e-5, CrossEntropyLoss, bf16 AMP O1), printed under its metric
# name; (b) long padded batches at seq 512 (lengths 128-512, dropout 0.1),
# whose attention reaches the flash kernels; (c) kernel-vs-plain step
# parity at [2, 512]; (d) BERT-large at [8, 512]
ERNIE_METRIC = "ernie_base_train_samples_per_sec_bs32_seq128_bf16"
ERNIE_A = dict(B=32, S=128, STEPS=40, LR=5e-5)
ERNIE_LONG = dict(B=8, S=512, STEPS=12, LR=1e-4, MIN_LEN=128)
ERNIE_PARITY = dict(B=2, S=512)
# phase 3's ERNIE rows: each shape and type at which a phase 8 path
# launches K2-K4, non-causal, p 0.1: (b)'s and (c)'s padded batches,
# (a)'s step at FLAGS_flash_attention_min_seq=128 (one 128-key tile, no
# padding, as bench.py feeds it) and (d)'s BERT-large
ERNIE_KERNEL_CASES = (
    dict(B=8, H=12, S=512, D=64, padded="ernie",
         dtypes=("float32", "bfloat16")),
    dict(B=32, H=12, S=128, D=64, padded=False, dtypes=("bfloat16",)),
    dict(B=8, H=16, S=512, D=64, padded="ernie", dtypes=("bfloat16",)),
)
# the informational arm of (a): the same step at these flash minimums
ERNIE_MIN_SEQS = (512, 128)
# phase 9: ResNet-50 in bench.py's second configuration (bench.py:236-291:
# resnet50(num_classes=1000), Momentum(0.1), CrossEntropyLoss, O1 bf16,
# batch 32 x 3 x 224 x 224, one batch every step), printed under its metric
# name (bench.py:3093-3094), through hapi.Model with Accuracy(topk=(1, 5));
# (b) the step parities at batch 2
RESNET_METRIC = "resnet50_train_images_per_sec_bs32_bf16"
RESNET_A = dict(B=32, SIDE=224, STEPS=40, LR=0.1)
RESNET_PARITY = dict(B=2, SIDE=224)
RESNET_FLOP_PER_IMAGE = 3 * 4.09e9   # bench.py:288-289: 3 x the forward
# (b)'s limits, set from a CPU rehearsal of the same step (PERF.md §2):
# fp32 against float64 there read a loss 1.4e-6 apart, gradients 1.8e-2
# (relative L2, worst tensor; 1.55e-2 the model), buffers 9.5e-6 of their
# max; two fp32 paths may sit twice that apart. O1 against fp32: loss
# 1.8e-2, the fc's gradient cosine 0.9959, every gradient's norm ratio
# 0.73-1.23, buffers 6.9e-2 of their max (the early layers' gradients are
# uncorrelated, cosine 0.16 median: no per-element limit holds there)
VISION_FP32 = dict(loss_rtol=1e-5, grad_rel_l2=0.1, model_rel_l2=0.05,
                   buffer_share=1e-4)
VISION_AMP = dict(loss_rtol=5e-2, fc_cos=0.98, norm_ratio=(0.5, 2.0),
                  buffer_share=0.2)
# phase 9b: PaddleDetection's configs/yolov3/yolov3_darknet53_270e_coco on
# one card: 608 x 608 inputs, batch 8, 50 gt slots an image, ignore_thresh
# 0.7, Momentum 0.9 at lr 0.001 with L2 5e-4; predict with yolo_box on
# the three scales and multiclass_nms (score 0.01, nms_top_k 1000,
# keep_top_k 100, nms 0.45, background_label -1). Width 64 is DarkNet's
# (the reference model's docstring). Cut: STEPS steps on one seeded batch
# (1-MAX_GT gt boxes an image), no warmup, random weights (no COCO and no
# pretrained backbone in the repository); (b) on PREDICT of its images
DETECT = dict(B=8, SIDE=608, CLASSES=80, WIDTH=64, SLOTS=50, MAX_GT=20,
              STEPS=10, LR=1e-3, MOMENTUM=0.9, L2=5e-4, IGNORE=0.7,
              PREDICT=2, SCORE=0.01, NMS_TOP_K=1000, KEEP_TOP_K=100,
              NMS=0.45)
# (c), (d): a narrow YOLOv3 card against CPU; the gradients held by phase
# 6's rule (a CPU rehearsal of fp32 against float64 read 0.0034 of it,
# the worst tensor 3.0e-6 in relative L2); (d)'s updates by phase 7's
# rule (_update_worst) at a rate that keeps 4 steps near-linear: at lr
# 1e-3 the first step takes the loss from 916 to 165, and the card's and
# the CPU's parameters parted by 3e-3 of their size in 4 steps (an H100
# 80GB HBM3 at 700 W)
DETECT_PARITY = dict(B=2, SIDE=128, WIDTH=8, CLASSES=3, STEPS=4, LR=1e-5)
# phase 10: bench.py --mode serving's model and traffic (bench.py:445-451:
# 256 -> 1024 -> 1024 -> 256, 64 submitters x 40 requests, 4 outstanding,
# a serial loop of 200, buckets 1/4/16/64; batch delay 2 ms; queue depth
# 2 x 64 x 4)
SERVE_MLP = dict(DIM=256, HID=1024, SUBMITTERS=64, PER=40, PIPELINE=4,
                 SERIAL=200, BUCKETS=(1, 4, 16, 64), DELAY_MS=2.0,
                 QUEUE=512)
# (b): ERNIE-base served at seq 512, 64 requests from 16 submitters of
# lengths ERNIE_LONG["MIN_LEN"]..512; its logits against eager on the card
# within EXPORT_TOL x max(1, max |logit|) (fp32: the flash kernels' fp32
# limit, FLASH_TOL; bf16: test_torch_amp.py's limit on an op's output)
# the 64 requests coalesce into one bucket-64 batch, so samples/s and
# p50/p99 come from a load window after them: LOAD_ROUNDS x 64 requests of
# the same rows from the same submitters, each with LOAD_OUTSTANDING
# outstanding (128 in all: two bucket-64 batches can be in flight)
ERNIE_SERVE = dict(S=512, REQUESTS=64, SUBMITTERS=16, BUCKETS=(1, 4, 16, 64),
                   LOAD_ROUNDS=10, LOAD_OUTSTANDING=8)
EXPORT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# phase onnx: ERNIE-base exported at export_ernie's seq 512 with a batch of
# B, ResNet-50 at RESNET_B x 224^2, the C API's encoder (ERNIE-base width)
# on CAPI_ROWS rows, CAPI_RUNS steady runs after the first
ONNX = dict(B=4, RESNET_B=1, CAPI_ROWS=4, CAPI_RUNS=5)
# phase onnx (c): a C program over the port's C inference API. argv:
# model_prefix in_file out_file runs go_file ndim dims...; makes its
# predictors, prints "DEVICE7 ...", waits for go_file, then times 1 +
# runs runs, prints "CAPI new_ms=... first_ms=... steady_ms=..." and
# writes the last output (ndim, dims, float32 values) to out_file
CAPI_DRIVER = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "pd_c_api.h"

static double now_ms(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e3 + t.tv_nsec / 1e6;
}

int main(int argc, char** argv) {
  const char* prefix = argv[1];
  int runs = atoi(argv[4]);
  int ndim = atoi(argv[6]);
  int64_t shape[8];
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) {
    shape[i] = atoll(argv[7 + i]);
    n *= shape[i];
  }
  float* in = (float*)malloc(n * sizeof(float));
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in, sizeof(float), n, f) != (size_t)n) return 10;
  fclose(f);
  double t0 = now_ms();
  PD_Predictor* p = PD_NewPredictor(prefix);  /* card 0, the default */
  double new_ms = now_ms() - t0;
  if (!p) {
    fprintf(stderr, "PD_NewPredictor: %s\n", PD_GetLastError());
    return 11;
  }
  PD_Predictor* bad = PD_NewPredictorWithDevice(prefix, 7);
  printf("DEVICE7 %s %s\n", bad ? "ok" : "failed",
         bad ? "" : PD_GetLastError());
  fflush(stdout);
  if (bad) PD_DeletePredictor(bad);
  /* the timed runs wait until go_file exists (the parent's other work is
     done), at most 20 minutes */
  for (int i = 0; i < 60000; ++i) {
    FILE* g = fopen(argv[5], "r");
    if (g) {
      fclose(g);
      break;
    }
    struct timespec nap = {0, 20000000};
    nanosleep(&nap, NULL);
  }
  float* out = NULL;
  int64_t oshape[8];
  int ondim = 0;
  double first_ms = 0, steady_ms = 0;
  for (int r = 0; r <= runs; ++r) {
    if (out) PD_FreeBuffer(out);
    out = NULL;
    double a = now_ms();
    if (PD_PredictorRun(p, in, shape, ndim, &out, oshape, &ondim) != 0) {
      fprintf(stderr, "PD_PredictorRun: %s\n", PD_GetLastError());
      return 12;
    }
    double ms = now_ms() - a;
    if (r == 0) first_ms = ms; else steady_ms += ms / runs;
  }
  printf("CAPI new_ms=%.3f first_ms=%.3f steady_ms=%.3f\n", new_ms,
         first_ms, steady_ms);
  int64_t total = 1;
  for (int i = 0; i < ondim; ++i) total *= oshape[i];
  f = fopen(argv[3], "wb");
  fwrite(&ondim, sizeof(int), 1, f);
  fwrite(oshape, sizeof(int64_t), ondim, f);
  fwrite(out, sizeof(float), total, f);
  fclose(f);
  PD_FreeBuffer(out);
  PD_DeletePredictor(p);
  free(in);
  return 0;
}
"""
# phase 3's inference rows of K2: (b)'s batches at the largest buckets,
# non-causal, p 0, on ERNIE's key bias
K2_INFERENCE_BATCHES = (16, 64)
# phase 11: the 8-expert MoE GPT at GPT-2 small width (the train phase's
# batch and sequence, so K2-K4 run at [8, 12, 1024, 64]); fit steps an
# arm, AdamW's rate, dropout, the fall its loss must show (the mean of the
# last 2 steps under the first by FALL); the step-parity batch seeds
# phase 13: bench.py's ResNet-50 batch over N host images of SIDE^2 (a);
# ERNIE_LONG's batches over ERNIE_ROWS rows, the last batch a tail (b)
INPUT = dict(N=1000, B=32, SIDE=256, ERNIE_ROWS=8 * 12 + 3)
# phase 14: Executor.run steps of each arm of (a), on ERNIE_LONG's shape,
# and the encoder layers of its ERNIE-base (cut from 12 for the default
# run's time: the exports of (c) take time in proportion)
STATIC = dict(STEPS=12, LAYERS=4)
MOE = dict(E=8, B=8, S=1024, STEPS=8, LR=1e-3, DROPOUT=0.1, FALL=0.25,
           PARITY_SEEDS=(1, 2, 3))
# phase 11 (a): the limits of a card call against the same call on the
# CPU, as a share of max(1, max |CPU result|); creation, manipulation,
# logic and search are exact, but for the float formulae the two
# libraries evaluate their own way (linspace, logspace, vander) and
# tensordot, a product; ops.legacy's floats (pow, the sequence softmax
# and pools) the same way
API_TOL = {"reduction": 1e-5, "linalg": 1e-4, "formula": 1e-6,
           "product": 1e-5, "legacy": 1e-6, "extra_ops": 1e-5,
           "vision_ops": 1e-5}
# phase 12: the attention LSTM seq2seq of PaddleNLP's
# examples/machine_translation/seq2seq at its IWSLT'15 width (vocabularies
# 17191 / 7709, 2 layers of 512, batch 128, dropout 0.2, Uniform(-0.1,
# 0.1), Adam 1e-3 under ClipGradByGlobalNorm(5.0), beam 10); source
# lengths uniform in 5-50; fit steps; held-out sources decoded; the
# step-parity batch
SEQ2SEQ = dict(SRC=17191, TRG=7709, HIDDEN=512, LAYERS=2, B=128,
               DROPOUT=0.2, INIT=0.1, LR=1e-3, CLIP=5.0, BEAM=10,
               MIN_LEN=5, MAX_LEN=50, STEPS=20, DECODE_ROWS=16, PARITY_B=4)
# phase 12 (a): card against CPU, as a share of max(1, max |CPU result|);
# None is exact, "stat" a statistics check on the card
S2S_TOL = {"float": 1e-5, "rnn": 1e-4}
# --profile's kernel classes for (a)'s step, first match wins
_VISION_KERNELS = {
    "layout": r"[Nn]chwToNhwc|[Nn]hwcToNchw|[Tt]ranspose|permute",
    "batch_norm": r"batch_norm|[Bb]atch[Nn]orm|bn_fw|bn_bw",
    "conv": r"[Cc]onv|xmma|implicit|fprop|dgrad|wgrad|cudnn|sm90|cutlass|"
            r"gemm|nvjet|winograd",
    "pool": r"pool",
    "elementwise": r"elementwise|vectorized|unrolled|[Rr]educe|copy|fill|"
                   r"foreach|softmax|cross_entropy|nll",
}


def _bench_lengths(np):
    """The bench's sequence lengths: clipped lognormal, mean ~235 of
    1024 (bench.py:2351-2353)."""
    T = PACK["T"]
    rng = np.random.RandomState(7)
    return np.clip(np.round(np.exp(rng.normal(
        np.log(T / 6.0), 0.9, PACK["NSEQ"]))).astype(int), 4, T)


def _motif_seqs(np, lengths):
    """(tokens, labels) per length: one of 64 seeded motifs (3-8 ids) run
    along the sequence, each label the next token, so the loss can
    fall."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(0, PACK["VOCAB"], size=rng.randint(3, 9))
              for _ in range(64)]
    out = []
    for n in lengths:
        s = np.resize(motifs[rng.randint(64)], n + 1).astype(np.int64)
        out.append((s[:-1], s[1:]))
    return out


def _ernie_lengths(np, rows, S, seed):
    """Seeded row lengths ERNIE_LONG["MIN_LEN"]..S, the first row S."""
    lens = np.random.RandomState(seed).randint(ERNIE_LONG["MIN_LEN"], S + 1,
                                               size=rows)
    lens[0] = S
    return lens


def _ernie_cls_set(np, n, S, vocab, batch, seed, lengths=None):
    """A learnable two-class set of n rows, every `batch` consecutive
    rows half of each class: random ids, of which half (at seeded
    positions) are the label's token, 2000 or 3000. A randomly
    initialised ERNIE-base maps the [CLS] position of any two rows to
    nearly one vector (pooled outputs at cosine 0.99 on a CPU check,
    whatever one token says), so a label one token carries is not
    learnable in a few steps; half the row carrying it keeps the two
    classes' pooled outputs apart (cosine 0.87). With
    `lengths`, ids past a row's length are the pad id 0 and the 1/0
    mask [n, S] marks the real tokens (else all ones). Returns (ids,
    labels, mask)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, size=(n, S)).astype(np.int64)
    labels = np.concatenate([rng.permutation(np.arange(batch) % 2)
                             for _ in range(n // batch)]).astype(np.int64)
    marked = rng.rand(n, S) < 0.5
    ids = np.where(marked, np.where(labels[:, None] == 1, 3000, 2000), ids)
    mask = np.ones((n, S), np.float32)
    if lengths is not None:
        mask = (np.arange(S)[None] < lengths[:, None]).astype(np.float32)
        ids[mask == 0] = 0
    return ids, labels, mask


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _grad_worst(ga, gb, share, floor_share):
    """(the worst over parameters of max |ga - gb| / (share x max |gb| +
    floor_share x the largest |gb| of the model), that parameter), in
    float64, gradients by name."""
    floor = floor_share * max(g.abs().max().item() for g in gb.values())
    return max(((ga[n].double() - gb[n].double()).abs().max().item()
                / (share * gb[n].abs().max().item() + floor), n)
               for n in gb)


def _rates(flops, ms, dtype):
    """Achieved TFLOP/s of `flops` in `ms`, and for fp32 the time the
    same work takes at the CUDA cores' peak (67 TFLOP/s): (dict, text)."""
    r = dict(tflops=flops / ms / 1e9)
    text = f"achieved {r['tflops']:.1f} TFLOP/s"
    if dtype == "float32":
        r["cuda_core_bound_ms"] = flops / CUDA_CORE_FP32 * 1e3
        text += (f", fp32 CUDA-core bound {r['cuda_core_bound_ms']:.4f} ms "
                 f"(67 TFLOP/s)")
    return r, text


# cycles the card spins (torch.cuda._sleep; ~1 ms at the H100's 1.98
# GHz) before a device-timed call, while the host enqueues the call
_AHEAD_CYCLES = 2_000_000


def _time_ms(torch, fn, iters, flush=None, device=False):
    """Mean ms of `fn` over `iters` calls, CUDA events around each call;
    `flush` (untimed) runs before each call to evict the L2. Event time
    counts the wrapper's host time whenever the card waits for it. With
    `device`, the card first spins for _AHEAD_CYCLES while the host
    enqueues the events and the call, so the events time only the call's
    kernels on the card: device time per call. A call whose start event
    the card had passed before the host finished enqueuing it may still
    hold host time; such calls are counted and printed."""
    fn()
    torch.cuda.synchronize()
    total, late = 0.0, 0
    for _ in range(iters):
        if flush is not None:
            flush()
        if device:
            torch.cuda._sleep(_AHEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        late += device and s.query()
        e.synchronize()
        total += s.elapsed_time(e)
    if late:
        print(f"  {late} of {iters} device-timed calls were still being "
              f"enqueued when the card reached them")
    return total / iters


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.failures = []
        self.kernel_rows = {}
        self.path_launches = {}   # main path -> kernel -> launches
        self.path_dtype_launches = {}   # ... -> kernel -> dtype -> launches
        self.details = {}
        # fp32 products in full fp32, as the JAX package pins
        # jax_default_matmul_precision="highest"; 16-bit GEMMs (the AMP
        # phases) reduce in fp32 too, not in the 16-bit type, as XLA
        # accumulates bf16 products in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
        self.l2 = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def flush(self):
        self.l2.zero_()

    def time_ms(self, fn, iters, flush=None):
        """(device ms, CUDA-event ms) per call of `fn` (`_time_ms`)."""
        return (_time_ms(self.torch, fn, iters, flush, device=True),
                _time_ms(self.torch, fn, iters, flush))

    def _wrappers(self):
        from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
        from paddle_tpu_torch.ops import splash_ops as so
        return {"paged_attention": po.paged_attention,
                "flash_fwd": fo.flash_attention_fwd,
                "flash_bwd_dq": fo.flash_attention_dq,
                "flash_bwd_dkv": fo.flash_attention_dkv,
                "splash_fwd": so.splash_attention_fwd,
                "splash_bwd_dq": so.splash_attention_dq,
                "splash_bwd_dkv": so.splash_attention_dkv}

    def zero_launches(self):
        for w in self._wrappers().values():
            w.launches = 0
            if hasattr(w, "launches_by_dtype"):
                w.launches_by_dtype.clear()

    def read_launches(self):
        return {n: w.launches for n, w in self._wrappers().items()}

    def record_path(self, name):
        """Keep the launch counts of the main path `name` just driven (in
        all and by type); returns the counts in all."""
        self.path_launches[name] = self.read_launches()
        self.path_dtype_launches[name] = self.read_launches_by_dtype()
        return self.path_launches[name]

    def read_launches_by_dtype(self):
        """{kernel: {dtype: launches}} of the wrappers that count by type
        (K2-K7)."""
        return {n: dict(w.launches_by_dtype)
                for n, w in self._wrappers().items()
                if hasattr(w, "launches_by_dtype")}

    def phase(self, name, fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            secs = time.perf_counter() - t0
            self.details.setdefault("phase_s", {})[name] = secs
            print(f"== phase {name} ok ({secs:.1f} s)", flush=True)
            return True
        except Exception:  # noqa: BLE001 — recorded, the run exits 1
            traceback.print_exc()
            self.failures.append(name)
            print(f"== phase {name} FAILED", flush=True)
            return False

    # -- 1. card --------------------------------------------------------------

    def card(self):
        torch = self.torch
        self.smi = _smi()
        print(f"card: {self.smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices "
              f"{torch.cuda.device_count()}")
        m = torch.backends.cuda.matmul
        print(f"matmul: allow_tf32 {m.allow_tf32}, "
              f"allow_bf16_reduced_precision_reduction "
              f"{m.allow_bf16_reduced_precision_reduction}, "
              f"allow_fp16_reduced_precision_reduction "
              f"{m.allow_fp16_reduced_precision_reduction}")

    # -- 2. build -------------------------------------------------------------

    def build(self):
        from paddle_tpu_torch.ops import _build
        secs = _build.build()
        print(f"build: {len(_build.SOURCES)} sources in {secs:.1f} s "
              f"({_build.build_dir()})")
        ptxas = {}
        for src in _build.SOURCES:
            kernels = _ptxas_kernels(_build.ptxas_log(src))
            ptxas[src] = kernels
            for name, regs, spill in kernels:
                print(f"  ptxas {src}: {name}: {regs} registers, spill "
                      f"stores/loads {spill[0]}/{spill[1]} bytes")
        spilled = [f"{src}: {n}" for src, ks in ptxas.items()
                   for n, _, sp in ks if sp != (0, 0)]
        print(f"ptxas: {sum(map(len, ptxas.values()))} kernels, spills in "
              f"{spilled if spilled else 'none'}")
        self.details["build_s"] = secs
        self.details["ptxas"] = ptxas

    # -- 3. kernels against their plain versions --------------------------------

    def k1_inputs(self, dtype, B, lens=None, seed=0, D=None, H=None):
        """q, pools, page table and pos for B slots of K1_SHAPE's heads
        (H, K1_SHAPE's by default), pages and table width (head dim D,
        K1_SHAPE's by default): random
        lengths 1..PP*P (seeded) unless `lens` gives them. Page 0 is the
        scratch page, full of junk."""
        torch = self.torch
        H = H or K1_SHAPE["H"]
        P, PP = K1_SHAPE["P"], K1_SHAPE["PP"]
        D = D or K1_SHAPE["D"]
        g = torch.Generator(device="cuda").manual_seed(seed)
        N = B * PP + 1
        if lens is None:
            lens = torch.randint(1, PP * P + 1, (B,), generator=g,
                                 device="cuda")
        else:
            lens = torch.tensor(lens, device="cuda")
        kp = torch.randn(H, N, P, D, generator=g, device="cuda").to(dtype)
        vp = torch.randn(H, N, P, D, generator=g, device="cuda").to(dtype)
        kp[:, 0] = 1e4   # scratch-page junk: must never reach the result
        vp[:, 0] = 1e4
        perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
        pt = torch.zeros(B, PP, dtype=torch.int32, device="cuda")
        for b in range(B):
            n = -(-int(lens[b]) // P)
            pt[b, :n] = perm[b * PP:b * PP + n].int()
        q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
        pos = (lens - 1).int()
        return q, kp, vp, pt, pos, lens

    def check_k1(self):
        """K1 against its plain version at three shapes, fp32, bf16 and
        fp16 (ROADMAP C10):
        phase 3's (8 slots of random lengths up to 1024), the decode
        profile's (8 slots of 230 tokens) and a long context (2 slots of
        1024); and phase 3's slots at head dims 80, 96 and 256 (ROADMAP
        C7: rows of 20/10, 24/12 and 64/32 16-byte chunks in fp32/bf16),
        36 and 264 (D % 8 != 0 and D > 256: the padded widths 64 and 512,
        one-value loads masked at D).
        ms: device time per call (`time_ms`; both kernels of the split),
        the event time beside it; the L2 is flushed before each call, as a
        decode step finds it cold; no library call computes K1's
        function."""
        torch = self.torch
        from paddle_tpu_torch.ops import paged_ops as po
        H, P, PP = (K1_SHAPE[k] for k in ("H", "P", "PP"))
        pps = po._pages_per_split(P)
        nsplit = -(-PP // pps)
        shapes = [("phase3", K1_SHAPE["B"], None, K1_SHAPE["D"]),
                  ("decode_profile", 8, [230] * 8, K1_SHAPE["D"]),
                  ("long", 2, [PP * P] * 2, K1_SHAPE["D"])]
        shapes += [(f"phase3_d{D}", K1_SHAPE["B"], None, D)
                   for D in (80, 96, 256, 36, 264)]
        rows = []
        for shape, B, lens_in, D in shapes:
            scale = 1.0 / D ** 0.5
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2),
                               (torch.float16, K1_FP16_TOL)):
                q, kp, vp, pt, pos, lens = self.k1_inputs(dtype, B, lens_in,
                                                          D=D)
                out = po.paged_attention(q, kp, vp, pt, pos, scale)
                # the plain version in float32 on the same inputs, then
                # rounded to the kernel's output type
                ref = po.paged_attention_plain(q.float(), kp.float(),
                                               vp.float(), pt, pos,
                                               scale).to(dtype)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()

                def call():
                    po.paged_attention(q, kp, vp, pt, pos, scale)
                ms, event_ms = self.time_ms(call, 50, self.flush)
                plain_ms = _time_ms(torch, lambda: po.paged_attention_plain(
                    q, kp, vp, pt, pos, scale), 10, self.flush)
                item = q.element_size()
                toks = int(lens.sum())
                live = sum(-(-int(n) // (pps * P)) for n in lens.tolist())
                nbytes = (2 * toks * H * D * item + 2 * q.numel() * item
                          + pt.numel() * 4 + pos.numel() * 4)
                flops = 4 * toks * H * D
                name = str(dtype).replace("torch.", "")
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[name] * 1e3
                rates, rtext = _rates(flops, ms, name)
                row = dict(shape=shape, D=D, dtype=name, max_abs_err=err,
                           tol=tol, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else
                           "operations", library_ms=None, tokens=toks,
                           splits=nsplit, live_splits=live / B,
                           gbytes_per_s=nbytes / ms / 1e6, **rates)
                rows.append(row)
                print(f"K1 paged_attention {name} {shape} B={B} H={H} D={D} "
                      f"P={P} PP={PP} len sum {toks}: max_abs_err {err:.3e} "
                      f"(tol {tol}); splits per (b, h) {nsplit} of "
                      f"{pps * P} tokens, {live / B:.2f} live on average; "
                      f"device {ms:.4f} ms/call (event "
                      f"{event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{row['bound_ms'] / ms:.3f} of it), "
                      f"{row['gbytes_per_s']:.0f} GB/s; {rtext}")
                assert err <= tol, \
                    f"K1 {name} {shape} disagrees with its plain version"
        self.details["k1"] = rows
        self.kernel_rows["paged_attention"] = rows[0]
        # the fp16 serving path's row (phase 5c's fp16 arm): phase 3's slots
        self.kernel_rows["paged_attention.float16"] = next(
            r for r in rows if r["shape"] == "phase3"
            and r["dtype"] == "float16")

    def k2_inputs(self, dtype, causal, padded, seed=1):
        torch = self.torch
        B, H, S, D = (K2_SHAPE[k] for k in ("B", "H", "S", "D"))
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        bias = None
        if padded:
            bias = torch.zeros(B, S, device="cuda")
            bias[0, 700:] = -1e30
            # non-causal: a fully masked batch row (uniform output rows);
            # causal: key 0 stays visible to every query
            bias[1, 300 if causal else 0:] = -1e30
        return q, k, v, bias

    def check_k2(self):
        """K2 at the serving shape, p 0, fp32, bf16 and fp16, causal or
        not, with and without a key-padding bias. ms and library ms: device
        time per call (`time_ms`), the event time beside each."""
        torch = self.torch
        import torch.nn.functional as TF
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H, S, D = (K2_SHAPE[k] for k in ("B", "H", "S", "D"))
        scale = 1.0 / D ** 0.5
        rows = []
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 1e-2),
                           (torch.float16, FLASH_TOL["float16"])):
            for causal in (True, False):
                for padded in (False, True):
                    q, k, v, bias = self.k2_inputs(dtype, causal, padded)
                    out, lse = fo.flash_attention_fwd(q, k, v, bias, causal,
                                                      scale)
                    ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias,
                                                           causal, scale)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lse_err = (lse - ref_lse).abs().max().item()

                    def call():
                        fo.flash_attention_fwd(q, k, v, bias, causal, scale)
                    ms, event_ms = self.time_ms(call, 20)
                    plain_ms = _time_ms(torch, lambda: fo._flash_fwd_reference(
                        q, k, v, bias, causal, scale), 5)
                    mask = None
                    if padded or causal:
                        mask = torch.zeros(B, 1, S, S, device="cuda")
                        if padded:
                            mask = mask + bias[:, None, None, :]
                        if causal:
                            mask = mask.masked_fill(torch.ones(
                                S, S, dtype=torch.bool,
                                device="cuda").triu(1), -1e30)
                        mask = mask.to(dtype)

                    def lib():
                        TF.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask)
                    lib_ms, lib_event_ms = self.time_ms(lib, 20)
                    item = q.element_size()
                    nbytes = (4 * B * H * S * D * item + B * H * S * 4
                              + (bias.numel() * 4 if padded else 0))
                    pairs = S * (S + 1) // 2 if causal else S * S
                    flops = 4 * B * H * pairs * D
                    name = str(dtype).replace("torch.", "")
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / PEAK_FLOPS[name] * 1e3
                    rates, rtext = _rates(flops, ms, name)
                    row = dict(dtype=name, causal=causal, padded=padded,
                               max_abs_err=err, lse_err=lse_err, tol=tol,
                               ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops
                               else "operations", library_ms=lib_ms,
                               library_event_ms=lib_event_ms, **rates)
                    rows.append(row)
                    print(f"K2 flash_fwd {name} causal={causal} "
                          f"padded={padded} B=2 H=12 S=1024 D=64: max_abs_err "
                          f"{err:.3e} lse_err {lse_err:.3e} (tol {tol}) "
                          f"device {ms:.4f} ms (event {event_ms:.4f}) plain "
                          f"{plain_ms:.4f} ms library device {lib_ms:.4f} ms "
                          f"(event {lib_event_ms:.4f}), "
                          f"{ms / lib_ms:.3f} x the library; bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                          f"{row['bound_ms'] / ms:.3f} of it); {rtext}")
                    assert torch.isfinite(out.float()).all(), "K2 non-finite"
                    assert err <= tol and lse_err <= tol, \
                        f"K2 {name} causal={causal} padded={padded} " \
                        f"disagrees with its plain version"
        self.details["k2"] = rows

    def check_k2_inference(self):
        """K2 at phase 10 (b)'s shapes: ERNIE-base served at seq 512,
        [B, 12, 512, 64] for B in K2_INFERENCE_BATCHES, non-causal, p 0, on
        ERNIE's key-padding bias, fp32 and bf16, against its plain version
        (FLASH_TOL x max(1, max |ref|)). ms and library ms (SDPA on the same
        [B,1,1,S] float mask in the operands' type): device time per call,
        the event time beside each."""
        torch = self.torch
        import torch.nn.functional as TF
        from paddle_tpu_torch.ops import flash_ops as fo
        H, S, D = 12, ERNIE_SERVE["S"], 64
        scale = 1.0 / D ** 0.5
        rows = []
        for B in K2_INFERENCE_BATCHES:
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                q, k, v, _, bias = self.train_inputs(dtype, False, "ernie",
                                                     seed=11, H=H, D=D,
                                                     Sq=S, B=B)
                out, lse = fo.flash_attention_fwd(q, k, v, bias, False,
                                                  scale)
                ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias, False,
                                                       scale)
                torch.cuda.synchronize()
                err = max((out.float() - ref.float()).abs().max().item(),
                          (lse - ref_lse).abs().max().item())
                ms, event_ms = self.time_ms(
                    lambda: fo.flash_attention_fwd(q, k, v, bias, False,
                                                   scale), 10)
                plain_ms = _time_ms(torch, lambda: fo._flash_fwd_reference(
                    q, k, v, bias, False, scale), 3)
                mask = bias[:, None, None, :].to(dtype)
                lib_ms, lib_event_ms = self.time_ms(
                    lambda: TF.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), 10)
                item = q.element_size()
                nbytes = 4 * B * H * S * D * item + B * H * S * 4 + B * S * 4
                rows.append(self._row(
                    "K2 flash_fwd inference", name, err,
                    ref.float().abs().max().item(), FLASH_TOL[name], ms,
                    plain_ms, 4 * B * H * S * S * D, nbytes, lib_ms,
                    shape=f"{B}x{H}x{S}x{D}", event_ms=round(event_ms, 4),
                    library_event_ms=round(lib_event_ms, 4)))
                print(f"K2 inference {name} [{B},{H},{S},{D}]: device "
                      f"{ms:.4f} ms = {ms / lib_ms:.3f} x SDPA (device "
                      f"{lib_ms:.4f} ms)")
                del q, k, v, bias, out, lse, ref, ref_lse, mask
                torch.cuda.empty_cache()
        self.details["k2_inference"] = rows

    def ernie_bias(self, B, S, seed=0):
        """ERNIE's key-padding bias as the flash kernels take it: float32
        [B, S] on the card, (1 - m) * -1e4 (models/ernie.py) over seeded
        row lengths ERNIE_LONG["MIN_LEN"]..S, the first row unpadded."""
        import numpy as np
        lens = _ernie_lengths(np, B, S, seed)
        m = np.arange(S)[None] < lens[:, None]
        return self.torch.from_numpy(
            ((1.0 - m) * -1e4).astype(np.float32)).cuda()

    def train_inputs(self, dtype, causal, padded, seed=2, H=None, D=None,
                     Sq=None, Sk=None, B=None):
        """q, dO [B, H, Sq, D] and k, v [B, H, Sk, D] (by default the
        train phase's attention shape), and a key bias whose masked tails
        leave every row some visible key: `padded` True masks tails of
        two rows with -1e30, "ernie" is `ernie_bias`."""
        torch = self.torch
        B = B or TRAIN_SHAPE["B"]
        H = H or TRAIN_SHAPE["H"]
        D = D or TRAIN_SHAPE["D"]
        Sq = Sq or TRAIN_SHAPE["S"]
        Sk = Sk or Sq
        g = torch.Generator(device="cuda").manual_seed(seed + 2 * causal)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       .to(dtype) for S in (Sq, Sk, Sk, Sq))
        bias = None
        if padded == "ernie":
            bias = self.ernie_bias(B, Sk)
        elif padded:
            bias = torch.zeros(B, Sk, device="cuda")
            bias[0, 700:] = -1e30
            bias[1, 300:] = -1e30
        return q, k, v, do, bias

    def _row(self, name, dtype, err, ref_max, tol, ms, plain_ms, flops,
             nbytes, lib_ms, **extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        rates, rtext = _rates(flops, ms, dtype)
        row = dict(dtype=dtype, max_abs_err=err, ref_max=ref_max, tol=tol,
                   ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib_ms, **rates, **extra)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"{name} {dtype} " + " ".join(f"{k}={v}" for k, v in
                                             extra.items())
              + f": max_abs_err {err:.3e} (max |ref| {ref_max:.3e}, tol "
              f"{tol} x max(1, max |ref|)) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms library {lib} bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / ms:.3f} of it); {rtext}")
        assert err <= tol * max(1.0, ref_max), \
            f"{name} {dtype} {extra} disagrees with its plain version"
        return row

    def check_train_kernels(self):
        """K2 with dropout, K3 and K4 against their plain versions on the
        same inputs and seed. At the train phase's attention shape: fp32
        bf16 and fp16, causal or not, p 0 and 0.1, and a padded bias (fp32).
        At each of ERNIE_KERNEL_CASES (every shape and type at which a
        phase 8 path launches the kernels): non-causal, p 0.1, on ERNIE's
        key-padding bias where the path pads, with the library's SDPA on
        the same [B,1,1,S] float mask and p.
        At the train width with other head dims (D 128 with H 6, D 32 with H 24),
        causal, p 0.1, fp32 and bf16; and non-causal with Sq 1024 != Sk
        1536, p 0.1, fp32 and bf16. The backward pair is fed the plain
        forward's O, LSE and delta, so only the kernels' arithmetic
        differs. Tolerances, relative to max(1, max |ref|): FLASH_TOL."""
        torch = self.torch
        import torch.nn.functional as TF
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H0, S0, D0 = (TRAIN_SHAPE[k] for k in ("B", "H", "S", "D"))
        seed = 1234
        rows = {"fwd": [], "dq": [], "dkv": []}
        train = dict(H=H0, D=D0, Sq=S0, Sk=S0)
        cases = [dict(train, dtype=dt, causal=c, p=p, padded=False)
                 for dt in ("float32", "bfloat16", "float16")
                 for c in (True, False) for p in (0.0, DROPOUT)]
        cases += [dict(train, dtype="float32", causal=c, p=DROPOUT,
                       padded=True) for c in (True, False)]
        for dt in ("float32", "bfloat16"):
            cases += [dict(H=6, D=128, Sq=S0, Sk=S0, dtype=dt, causal=True,
                           p=DROPOUT, padded=False),
                      dict(H=24, D=32, Sq=S0, Sk=S0, dtype=dt, causal=True,
                           p=DROPOUT, padded=False),
                      dict(H=H0, D=D0, Sq=S0, Sk=1536, dtype=dt,
                           causal=False, p=DROPOUT, padded=False)]
        # ROADMAP C11: head dims at padded widths, in every type
        cases += [dict(H=H, D=D, Sq=S0, Sk=S0, dtype=dt, causal=True,
                       p=DROPOUT, padded=False)
                  for D, H in HEAD_DIM_CASES
                  for dt in ("float32", "bfloat16", "float16")]
        cases = [dict(c, B=B) for c in cases]
        # phase 8's paths through the kernels
        ernie = [dict(B=e["B"], H=e["H"], D=e["D"], Sq=e["S"], Sk=e["S"],
                      dtype=dt, causal=False, p=DROPOUT, padded=e["padded"],
                      ernie=True)
                 for e in ERNIE_KERNEL_CASES for dt in e["dtypes"]]
        lib = {}
        for case in cases + ernie:
            name, causal, p, padded = (case[k] for k in
                                       ("dtype", "causal", "p", "padded"))
            B, H, D, Sq, Sk = (case[k] for k in ("B", "H", "D", "Sq", "Sk"))
            dtype = getattr(torch, name)
            scale = 1.0 / D ** 0.5
            tol = FLASH_TOL[name]
            q, k, v, do, bias = self.train_inputs(dtype, causal, padded,
                                                  H=H, D=D, Sq=Sq, Sk=Sk, B=B)
            tag = dict(shape=f"{B}x{H}x{Sq}x{Sk}x{D}", causal=causal, p=p,
                       padded=padded, **({"ernie": True} if case.get("ernie")
                                         else {}))
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
            # bytes each kernel must move: its [B,H,S,D] operands read or
            # written once, the [B*H,Sq] f32 statistics, the [B,Sk] bias
            q_b = B * H * Sq * D * q.element_size()
            k_b = B * H * Sk * D * q.element_size()
            row_b = B * H * Sq * 4
            bias_b = B * Sk * 4 if padded else 0
            key = (name, causal, tag["shape"], padded)
            if key not in lib and padded is not True:
                # the library yardsticks: SDPA forward (device time, its
                # event time beside it), and its backward under autograd
                # timed as one call (event time); p = 0, or on ERNIE's
                # rows the same [B,1,1,S] float mask and p as the kernels
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                lkw = dict(is_causal=causal)
                if case.get("ernie"):
                    lkw = dict(dropout_p=p)
                if padded == "ernie":
                    lkw["attn_mask"] = bias[:, None, None, :].to(dtype)

                def lib_call():
                    TF.scaled_dot_product_attention(ql, kl, vl, **lkw)
                fwd_ms, fwd_event_ms = self.time_ms(lib_call, 10)
                ol = TF.scaled_dot_product_attention(ql, kl, vl, **lkw)
                bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
                    ol, (ql, kl, vl), do, retain_graph=True), 10)
                lib[key] = (fwd_ms, bwd_ms, fwd_event_ms)
                del ql, kl, vl, ol
            lib_fwd, lib_bwd, lib_fwd_event = lib.get(key, (None, None, None))
            # K2 (ms: device time, the event time beside it)
            out, lse = fo.flash_attention_fwd(q, k, v, bias, causal, scale,
                                              p, seed)
            ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias, causal,
                                                   scale, p, seed)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            assert torch.isfinite(out.float()).all(), "K2 non-finite"

            def k2_call():
                fo.flash_attention_fwd(q, k, v, bias, causal, scale, p, seed)
            k2_ms, k2_event_ms = self.time_ms(k2_call, 10)
            rows["fwd"].append(self._row(
                "K2 flash_fwd", name, err, ref.float().abs().max().item(),
                tol, k2_ms,
                _time_ms(torch, lambda: fo._flash_fwd_reference(
                    q, k, v, bias, causal, scale, p, seed), 3),
                4 * B * H * pairs * D, 2 * q_b + 2 * k_b + row_b + bias_b,
                lib_fwd, event_ms=round(k2_event_ms, 4),
                library_event_ms=None if lib_fwd_event is None
                else round(lib_fwd_event, 4), **tag))
            if lib_fwd is not None:
                print(f"K2 {name} {tag}: device {k2_ms:.4f} ms = "
                      f"{k2_ms / lib_fwd:.3f} x the library's forward "
                      f"(device {lib_fwd:.4f} ms)")
            del out, lse
            delta = fo._delta(ref, do)
            # K3
            dq = fo.flash_attention_dq(q, k, v, bias, do, ref_lse, delta,
                                       causal, scale, p, seed)
            dq_ref = fo._dq_reference(q, k, v, bias, do, ref_lse, delta,
                                      causal, scale, p, seed)
            torch.cuda.synchronize()
            assert torch.isfinite(dq.float()).all(), "K3 non-finite"
            rows["dq"].append(self._row(
                "K3 flash_dq", name, (dq.float() - dq_ref.float()).abs()
                .max().item(), dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: fo.flash_attention_dq(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 10),
                _time_ms(torch, lambda: fo._dq_reference(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 3),
                3 * 2 * B * H * pairs * D,
                3 * q_b + 2 * k_b + 2 * row_b + bias_b, lib_bwd, **tag))
            del dq, dq_ref
            # K4
            dk, dv = fo.flash_attention_dkv(q, k, v, bias, do, ref_lse,
                                            delta, causal, scale, p, seed)
            dk_ref, dv_ref = fo._dkv_reference(q, k, v, bias, do, ref_lse,
                                               delta, causal, scale, p, seed)
            torch.cuda.synchronize()
            assert torch.isfinite(dk.float()).all() and \
                torch.isfinite(dv.float()).all(), "K4 non-finite"
            rows["dkv"].append(self._row(
                "K4 flash_dkv", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: fo.flash_attention_dkv(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 10),
                _time_ms(torch, lambda: fo._dkv_reference(
                    q, k, v, bias, do, ref_lse, delta, causal, scale, p,
                    seed), 3),
                4 * 2 * B * H * pairs * D,
                2 * q_b + 4 * k_b + 2 * row_b + bias_b, lib_bwd, **tag))
            pair_ms = rows["dq"][-1]["ms"] + rows["dkv"][-1]["ms"]
            if lib_bwd is not None:
                print(f"K3 + K4 {name} {tag}: {pair_ms:.4f} ms = "
                      f"{pair_ms / lib_bwd:.3f} x the library's whole "
                      f"backward ({lib_bwd:.4f} ms)")
            del dk, dv, dk_ref, dv_ref, ref, ref_lse, delta
            torch.cuda.empty_cache()
        self.details["train_kernels"] = rows
        self.details["ernie_kernel_rows"] = {
            k: [r for r in rs if r.get("ernie")] for k, rs in rows.items()}
        B = TRAIN_SHAPE["B"]

        def pick(rs, dtype):   # the train phase's case: causal, p 0.1
            return next(r for r in rs if r["dtype"] == dtype
                        and r["causal"] and r["p"] == DROPOUT
                        and not r["padded"]
                        and r["shape"] == f"{B}x{H0}x{S0}x{S0}x{D0}")
        for dt in ("float32", "bfloat16", "float16"):
            sfx = "" if dt == "float32" else f".{dt}"
            self.kernel_rows["flash_fwd" + sfx] = pick(rows["fwd"], dt)
            self.kernel_rows["flash_bwd_dq" + sfx] = pick(rows["dq"], dt)
            self.kernel_rows["flash_bwd_dkv" + sfx] = pick(rows["dkv"], dt)

    def check_autograd(self):
        """FlashAttention's gradients on the card (K2 forward, K3 + K4
        backward) against autograd through the plain forward with the
        same keep mask; then the C4 check: through
        F.scaled_dot_product_attention with p = 0, gradients reach q, k
        and v through K2 and match autograd through `_sdpa_ref`. fp32,
        [2, 12, 1024, 64], causal; atol 1e-4 x max(1, max |grad|)."""
        torch = self.torch
        from paddle_tpu_torch.nn.functional import attention as attn
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H, S, D = 2, 12, 1024, 64
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda")
                       for _ in range(4))
        scale = 1.0 / D ** 0.5

        def grads(fn):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*ins), ins, do)

        def compare(what, got, want):
            for n, a, b in zip("qkv", got, want):
                err = (a - b).abs().max().item()
                mx = b.abs().max().item()
                print(f"{what}: d{n} max_abs_err {err:.3e} (max |grad| "
                      f"{mx:.3e}, tol 1e-4 x max(1, max |grad|))")
                assert err <= 1e-4 * max(1.0, mx), f"{what} d{n} disagrees"

        n3, n4 = fo.flash_attention_dq.launches, fo.flash_attention_dkv.launches
        compare("FlashAttention p=0.1 vs autograd of the plain forward",
                grads(lambda a, b, c: fo.FlashAttention.apply(
                    a, b, c, None, 99, True, scale, DROPOUT)),
                grads(lambda a, b, c: fo._flash_fwd_reference(
                    a, b, c, None, True, scale, DROPOUT, 99)[0]))
        assert fo.flash_attention_dq.launches == n3 + 1
        assert fo.flash_attention_dkv.launches == n4 + 1
        n2 = fo.flash_attention_fwd.launches
        compare("C4: F.sdpa p=0 through K2 vs autograd of _sdpa_ref",
                grads(lambda a, b, c: attn.scaled_dot_product_attention(
                    a, b, c, is_causal=True, training=True)),
                grads(lambda a, b, c: attn._sdpa_ref(
                    a, b, c, None, scale, True)))
        assert fo.flash_attention_fwd.launches == n2 + 1, \
            "F.scaled_dot_product_attention did not launch K2"

    def splash_ids(self, rows, n=None):
        """Segment ids [rows, 1024] int32 on the card: io.PackingCollator
        (first-fit) over the bench's first `n` sequences, or, by default,
        as many as fill `rows` rows to about 93 %."""
        import numpy as np
        import warnings
        from paddle_tpu_torch import io
        T = PACK["T"]
        lengths = _bench_lengths(np)
        if n is None:
            n = int(np.searchsorted(np.cumsum(lengths), 0.93 * rows * T))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a sequence may not fit
            pack = io.PackingCollator(T, rows)(
                [np.zeros(L, np.int64) for L in lengths[:n]])
        return self.torch.from_numpy(pack[1]).cuda()

    def check_splash_kernels(self):
        """K5, K6 and K7 against their plain versions on the same inputs,
        ids and seed, as check_train_kernels holds K2-K4 (same
        tolerances, FLASH_TOL): at GPT-2 small's attention width, causal,
        fp32, bf16 and fp16, p 0 and 0.1, plus a non-causal fp32 case
        whose kv lacks one query segment (those rows must be exactly 0);
        and at the packing phase's shape, causal p 0, bf16, fp16 and fp32
        (the kernels line's rows).
        The bound counts the allowed (query, key) pairs of these ids; the
        library call is SDPA with the boolean segment-within-causal mask
        (no row of these packs is fully masked, so it computes the same
        function), its backward under autograd timed as one call."""
        torch = self.torch
        import numpy as np
        import torch.nn.functional as TF
        from paddle_tpu_torch import io
        from paddle_tpu_torch.ops import flash_ops as fo, splash_ops as so
        B, H, S, D = (SPLASH_SHAPE[k] for k in ("B", "H", "S", "D"))
        scale = 1.0 / D ** 0.5
        seed = 4321
        ids = self.splash_ids(B)
        absent = ids.clone()
        absent[0][absent[0] == 2] = 1          # kv holds no segment 2
        prow = io.suggest_rows(_bench_lengths(np), PACK["BS"], PACK["T"],
                               headroom=PACK["HEADROOM"])
        ph = PACK["HEADS"]
        cases = [("gpt2", dt, True, p, ids, ids, H, D)
                 for dt in ("float32", "bfloat16", "float16")
                 for p in (0.0, DROPOUT)]
        packs = self.splash_ids(prow, PACK["BS"])
        cases += [("gpt2", "float32", False, 0.0, ids, absent, H, D)]
        cases += [("packed_lm", dt, True, 0.0, packs, None, ph, D)
                  for dt in ("bfloat16", "float16", "float32")]
        # ROADMAP C11: the pack at head dims of padded widths, every type
        cases += [("packed_lm", dt, True, 0.0, packs, None, hh, dd)
                  for dd, hh in HEAD_DIM_CASES
                  for dt in ("float32", "bfloat16", "float16")]
        rows = {"fwd": [], "dq": [], "dkv": []}
        for shape, name, causal, p, qs, ks, Hc, Dc in cases:
            ks = qs if ks is None else ks
            Bc = B if shape == "gpt2" else qs.shape[0]
            dtype = getattr(torch, name)
            tol = FLASH_TOL[name]
            sc = 1.0 / Dc ** 0.5
            g = torch.Generator(device="cuda").manual_seed(11 + causal)
            q, k, v, do = (torch.randn(Bc, Hc, S, Dc, generator=g,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            kv_lo, kv_hi, q_lo, q_hi = so._block_bounds(qs, ks, 64, 64,
                                                        causal)
            allowed = so._allowed(qs, ks, causal)
            pairs = int(allowed.sum()) * Hc        # allowed pairs, all heads
            nt = S // 64
            sweep = Bc * (nt * (nt + 1) // 2 if causal else nt * nt)
            tiles = int((kv_hi - kv_lo).sum()) / sweep
            tiles_t = int((q_hi - q_lo).sum()) / sweep
            full = Bc * Hc * (S * (S + 1) // 2 if causal else S * S)
            tag = dict(shape=f"{Bc}x{Hc}x{S}x{Dc}", causal=causal, p=p,
                       absent=ks is not qs, tiles_visited=tiles,
                       pair_share=pairs / full)
            # K5's (warp band, key tile) pairs that take the mask-free path
            # (`_uniform_tiles`), of those its spans visit
            vis, uni = so._uniform_tiles(qs, ks, causal,
                                         so._k5_key_tile(Dc, dtype))
            k5_uniform = int(uni.sum()) / int(vis.sum())
            # the 16x8 sub-tiles of K6's and K7's visited tiles that can
            # hold an allowed pair (`_subtile_mask`): what a sub-tile skip
            # could keep of their product work
            sub = {}
            for kname, tr in (("dq", False), ("dkv", True)):
                vis, live = so._subtile_mask(qs, ks, causal, tr)
                sub[kname] = dict(
                    subtiles_live=int(live.sum()) / int(vis.sum()))
            bh_sd = Bc * Hc * S * Dc * q.element_size()
            row_b = Bc * Hc * S * 4
            ids_b = 2 * Bc * S * 4 + 2 * Bc * nt * 4
            lib_fwd = lib_bwd = lib_fwd_dev = None
            if p == 0.0:
                mask = allowed.expand(Bc, 1, S, S)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                lib_fwd_dev, lib_fwd = self.time_ms(
                    lambda: TF.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=mask), 10)
                ol = TF.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
                lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
                    ol, (ql, kl, vl), do, retain_graph=True), 10)
                del ql, kl, vl, ol, mask
            fargs = (q, k, v, qs, ks, causal, sc, p, seed)
            out, lse = so.splash_attention_fwd(*fargs, bounds=(kv_lo, kv_hi))
            ref, ref_lse = so._splash_fwd_reference(*fargs)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            assert torch.isfinite(out.float()).all(), "K5 non-finite"
            if tag["absent"]:
                gone = (qs[0] == 2)
                assert bool(gone.any()) and \
                    (out[0][:, gone] == 0).all(), "K5 absent rows not 0"
            # event time is the row's ms (as in earlier runs); device time
            # beside it, the wrapper's host time left out
            k5_dev, k5_ev = self.time_ms(lambda: so.splash_attention_fwd(
                *fargs, bounds=(kv_lo, kv_hi)), 10)
            rows["fwd"].append(self._row(
                "K5 splash_fwd", name, err, ref.float().abs().max().item(),
                tol, k5_ev,
                _time_ms(torch, lambda: so._splash_fwd_reference(*fargs), 3),
                4 * pairs * Dc, 4 * bh_sd + row_b + ids_b, lib_fwd,
                device_ms=k5_dev, library_device_ms=lib_fwd_dev,
                uniform_tiles=k5_uniform, **tag))
            del out, lse
            delta = fo._delta(ref, do)
            bargs = (q, k, v, qs, ks, do, ref_lse, delta, causal, sc, p,
                     seed)
            dq = so.splash_attention_dq(*bargs, bounds=(kv_lo, kv_hi))
            dq_ref = so._splash_dq_reference(*bargs)
            torch.cuda.synchronize()
            assert torch.isfinite(dq.float()).all(), "K6 non-finite"
            if tag["absent"]:
                assert (dq[0][:, qs[0] == 2] == 0).all(), \
                    "K6 absent rows not 0"
            rows["dq"].append(self._row(
                "K6 splash_dq", name, (dq.float() - dq_ref.float()).abs()
                .max().item(), dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: so.splash_attention_dq(
                    *bargs, bounds=(kv_lo, kv_hi)), 10),
                _time_ms(torch, lambda: so._splash_dq_reference(*bargs), 3),
                6 * pairs * Dc, 5 * bh_sd + 2 * row_b + ids_b, lib_bwd,
                **sub["dq"], **tag))
            del dq, dq_ref
            dk, dv = so.splash_attention_dkv(*bargs, bounds=(q_lo, q_hi))
            dk_ref, dv_ref = so._splash_dkv_reference(*bargs)
            torch.cuda.synchronize()
            assert torch.isfinite(dk.float()).all() and \
                torch.isfinite(dv.float()).all(), "K7 non-finite"
            rows["dkv"].append(self._row(
                "K7 splash_dkv", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: so.splash_attention_dkv(
                    *bargs, bounds=(q_lo, q_hi)), 10),
                _time_ms(torch, lambda: so._splash_dkv_reference(*bargs), 3),
                8 * pairs * Dc, 6 * bh_sd + 2 * row_b + ids_b, lib_bwd,
                tiles_visited_t=tiles_t, **sub["dkv"], **tag))
            if lib_bwd is not None:
                pair_ms = rows["dq"][-1]["ms"] + rows["dkv"][-1]["ms"]
                print(f"K6 + K7 {name} {tag['shape']} causal={causal}: "
                      f"{pair_ms:.4f} ms = {pair_ms / lib_bwd:.3f} x the "
                      f"library's whole backward ({lib_bwd:.4f} ms); K5 "
                      f"{rows['fwd'][-1]['ms'] / lib_fwd:.3f} x its forward "
                      f"({lib_fwd:.4f} ms), device time "
                      f"{k5_dev / lib_fwd_dev:.3f} x ({lib_fwd_dev:.4f} ms)")
            del dk, dv, dk_ref, dv_ref, ref, ref_lse, delta, allowed
            torch.cuda.empty_cache()
        self.details["splash_kernels"] = rows
        pack_shape = f"{packs.shape[0]}x{ph}x{S}x{D}"
        for key, name in (("fwd", "splash_fwd"), ("dq", "splash_bwd_dq"),
                          ("dkv", "splash_bwd_dkv")):
            # the packing phase's cases at the pack shape: fp32, bf16 (its
            # AMP epoch) and fp16 (its fp16 AMP steps)
            for dt, sfx in (("float32", ""), ("bfloat16", ".bfloat16"),
                            ("float16", ".float16")):
                self.kernel_rows[name + sfx] = next(
                    r for r in rows[key] if r["shape"] == pack_shape
                    and r["dtype"] == dt)

        # SplashAttention (K5, then K6 + K7) against autograd through the
        # plain forward with the same keep mask: fp32, [2, 12, 1024, 64],
        # causal, p 0.1, atol 1e-4 x max(1, max |grad|)
        g = torch.Generator(device="cuda").manual_seed(8)
        q, k, v, do = (torch.randn(2, H, S, D, generator=g, device="cuda")
                       for _ in range(4))
        qs = ids[:2].contiguous()

        def grads(fn):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*ins), ins, do)
        got = grads(lambda a, b, c: so.SplashAttention.apply(
            a, b, c, qs, qs, 99, True, scale, DROPOUT))
        want = grads(lambda a, b, c: so._splash_fwd_reference(
            a, b, c, qs, qs, True, scale, DROPOUT, 99)[0])
        for n, a, b in zip("qkv", got, want):
            err = (a - b).abs().max().item()
            mx = b.abs().max().item()
            print(f"SplashAttention p=0.1 vs autograd of the plain forward: "
                  f"d{n} max_abs_err {err:.3e} (max |grad| {mx:.3e}, tol "
                  f"1e-4 x max(1, max |grad|))")
            assert err <= 1e-4 * max(1.0, mx), f"SplashAttention d{n}"

    def kernels(self):
        self.check_k1()
        self.check_k2()
        self.check_k2_inference()
        self.check_train_kernels()
        self.check_autograd()
        self.check_splash_kernels()
        self.check_dist_kernels()
        self.check_head_offset_kernels()

    # -- 4. model --------------------------------------------------------------

    def model(self):
        torch = self.torch
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.ops import flash_ops
        cfg = GPTConfig()
        self.gpt = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
        nparams = sum(p.numel() for p in self.gpt.parameters())
        print(f"GPT: vocab {cfg.vocab_size} hidden {cfg.hidden_size} layers "
              f"{cfg.num_layers} heads {cfg.num_heads} ffn "
              f"{cfg.intermediate_size} positions "
              f"{cfg.max_position_embeddings}: {nparams} parameters fp32")
        g = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                            device="cuda")
        with torch.inference_mode():
            flash_ops.flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            lf = self.gpt(ids)
            torch.cuda.synchronize()
            t_flash = time.perf_counter() - t0
            launches = flash_ops.flash_attention_fwd.launches
            set_flags({"FLAGS_use_flash_attention": False})
            try:
                t0 = time.perf_counter()
                lp = self.gpt(ids)
                torch.cuda.synchronize()
                t_plain = time.perf_counter() - t0
            finally:
                set_flags({"FLAGS_use_flash_attention": True})
        err = (lf - lp).abs().max().item()
        tol = 1e-3
        print(f"model [2,1024] forward: logits max_abs_err flash vs plain "
              f"{err:.3e} (tol {tol}), logit std {lp.std().item():.3f}, "
              f"flash launches {launches}, wall {t_flash * 1e3:.1f} ms "
              f"flash / {t_plain * 1e3:.1f} ms plain (first calls)")
        assert tuple(lf.shape) == (2, 1024, cfg.vocab_size)
        assert torch.isfinite(lf).all(), "non-finite logits"
        assert launches == cfg.num_layers, \
            f"flash kernel launched {launches} times, expected " \
            f"{cfg.num_layers}"
        assert err <= tol, "flash forward disagrees with the plain path"
        self.details["model"] = dict(err=err, launches=launches)

    # -- 5. serving ------------------------------------------------------------

    def serving(self):
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.ops import flash_ops, paged_ops
        from paddle_tpu_torch.serving import GenerationEngine
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        cfg = self.gpt.gpt.config
        prompts, new = self.serving_requests(cfg.vocab_size)
        lens = [len(p) for p in prompts]
        n_req = len(prompts)
        page, slots = 16, 8
        num_pages = 1 + sum(-(-(s + m) // page)
                            for s, m in zip(lens, new))
        t0 = time.perf_counter()
        eng = GenerationEngine(
            self.gpt, device="cuda", name="chip_smoke", max_slots=slots,
            page_size=page, num_pages=num_pages,
            prefill_buckets=(16, 64, 256, 1024), max_new_tokens=64,
            request_timeout_ms=0, metrics_port=0)
        before = self.scrape(eng)
        print(f"engine: {slots} slots, page {page}, {num_pages} pages "
              f"({eng.stats()['pages']['hbm_bytes'] / 1e9:.2f} GB pools), "
              f"built + warmed in {time.perf_counter() - t0:.1f} s")
        # the main path starts here: every launch count from 0
        self.zero_launches()
        arrivals = [[] for _ in range(n_req)]
        submit_t = [0.0] * n_req
        results = [None] * n_req
        consumers = []

        def consume(i, stream):
            for _ in stream:
                arrivals[i].append(time.perf_counter())
            results[i] = stream.result()

        def submit(i):
            submit_t[i] = time.perf_counter()
            st = eng.submit_stream(prompts[i], max_new_tokens=new[i])
            th = threading.Thread(target=consume, args=(i, st), daemon=True)
            th.start()
            consumers.append(th)

        t_start = time.perf_counter()
        for i in range(slots):
            submit(i)
        joined_at = None
        for i in range(slots, n_req):
            # later requests join while the first batch decodes
            while eng.stats()["steps"] < 4 * (i - slots + 1):
                time.sleep(0.001)
            if joined_at is None:
                joined_at = eng.stats()["steps"]
            submit(i)
        for th in consumers:
            th.join(600)
        t_end = time.perf_counter()
        stats = eng.stats()
        self.check_observability("serving", eng, before, n_req)
        eng.shutdown(drain=True, timeout_s=60)
        k1 = paged_ops.paged_attention.launches
        k2 = flash_ops.flash_attention_fwd.launches
        gen_tokens = sum(len(a) for a in arrivals)
        ttfts = [(a[0] - s) * 1e3 for a, s in zip(arrivals, submit_t)]
        ttft = sorted(ttfts)
        first, joined = sorted(ttfts[:slots]), sorted(ttfts[slots:])
        tpot = sorted((a[-1] - a[0]) * 1e3 / (len(a) - 1)
                      for a in arrivals if len(a) > 1)
        wall = t_end - t_start
        print(f"serving on {self.smi}: {n_req} requests, {gen_tokens} "
              f"generated tokens in {wall:.3f} s = "
              f"{gen_tokens / wall:.1f} tokens/s; TTFT p50 "
              f"{ttft[len(ttft) // 2]:.2f} ms max {ttft[-1]:.2f} ms; TPOT "
              f"p50 {tpot[len(tpot) // 2]:.3f} ms max {tpot[-1]:.3f} ms; "
              f"{stats['steps']} decode steps, {stats['prefills']} "
              f"prefills, first join at step {joined_at}; compiles "
              f"{stats['compiles']}")
        print(f"TTFT p50 of the first {slots} requests "
              f"{first[len(first) // 2]:.2f} ms (their prefills run back to "
              f"back), of the {len(joined)} that queued for a slot "
              f"{joined[len(joined) // 2]:.2f} ms")
        print(f"launches on the serving path: paged_attention {k1}, "
              f"flash_fwd {k2}")
        self.details["serving"] = dict(
            tokens=gen_tokens, wall_s=wall, tokens_per_s=gen_tokens / wall,
            ttft_ms=ttft, ttft_first_wave_ms=first, ttft_queued_ms=joined,
            tpot_ms=tpot, steps=stats["steps"],
            compiles=stats["compiles"])
        self.record_path("serving")
        # checks: outputs, identity to generate(), launch counts, pages
        # kept for phase 5c, whose int8-KV arm serves the same requests
        self.serving_refs = self.assert_identical("serving", prompts, new,
                                                  results)
        assert k1 == stats["steps"] * cfg.num_layers, \
            f"paged_attention launches {k1} != steps {stats['steps']} x " \
            f"{cfg.num_layers} layers"
        assert k2 > 0, "flash kernel never launched on the serving path"
        assert eng.stats()["pages"]["pages_in_use"] == 0, "pages leaked"
        assert joined_at is not None and joined_at > 0
        self.serving_d96()

    @staticmethod
    def serving_requests(vocab, seed=0):
        """Phase 5's 16 greedy requests (seeded): prompts of 16-900
        tokens and 32-64 new tokens each; another `seed` gives other
        tokens at the same lengths."""
        import numpy as np
        rng = np.random.RandomState(seed)
        lens = [16, 900, 40, 700, 130, 300, 17, 520, 64, 800, 250, 33,
                610, 90, 400, 880]
        prompts = [rng.randint(0, vocab, size=(n,)) for n in lens]
        new = [int(x) for x in rng.randint(32, 65, size=len(lens))]
        return prompts, new

    def generate_refs(self, prompts, new, gpt=None):
        """The port's generate() of each prompt (one call a prompt) on
        `gpt` (phase 5's model by default), host arrays."""
        gpt = self.gpt if gpt is None else gpt
        return [gpt.generate(p[None], max_new_tokens=n)[0]
                .cpu().numpy() for p, n in zip(prompts, new)]

    def first_flips(self, prompts, new, outs, refs, gpt=None):
        """For each output that differs from its reference: (request,
        first differing step, top-2 logit gap of `gpt`'s full forward on
        the reference's context there)."""
        torch = self.torch
        import numpy as np
        gpt = self.gpt if gpt is None else gpt
        flips = []
        for i, (p, out, ref) in enumerate(zip(prompts, outs, refs)):
            if np.array_equal(out, ref):
                continue
            S = len(p)
            step = int(np.nonzero(out != ref)[0][0]) - S
            with torch.inference_mode():
                ctx = torch.as_tensor(ref[:S + step][None], device="cuda")
                top2 = torch.topk(gpt(ctx)[0, -1].float(), 2).values
            flips.append((i, step, (top2[0] - top2[1]).item()))
        return flips

    def assert_identical(self, label, prompts, new, outs, refs=None,
                         gpt=None):
        """Every output token-identical to generate() (of `gpt`, phase
        5's model by default); for each one that differs, print the first
        differing step and the top-2 logit margin of the full forward
        there (`first_flips`). Returns the references."""
        gpt = self.gpt if gpt is None else gpt
        refs = self.generate_refs(prompts, new, gpt) if refs is None \
            else refs
        for i, (p, out) in enumerate(zip(prompts, outs)):
            assert out is not None, f"{label}: request {i} produced no result"
            assert out.shape == (len(p) + new[i],), \
                f"{label}: request {i} shape {out.shape}"
        flips = self.first_flips(prompts, new, outs, refs, gpt)
        for i, step, gap in flips:
            S = len(prompts[i])
            print(f"{label}: request {i} (prompt {S}): first differing "
                  f"step {step}, engine token {outs[i][S + step]} vs "
                  f"generate {refs[i][S + step]}, top-2 logit margin "
                  f"{gap:.3e}")
        assert not flips, \
            f"{label}: {len(flips)} requests differ from generate()"
        return refs

    def serving_d96(self):
        """ROADMAP C7 on the card: a GPT with head dim 96 (hidden 768, 8
        heads, 2 layers; GPT-2 small's vocab, FFN and positions; fp32,
        seed 0) served by GenerationEngine: 4 greedy requests, 8 new
        tokens each, token-identical to the port's generate(), its decode
        attention through K1 (launches counted on this path, one a layer
        a step). The 300-token prompt prefills in bucket 512, at
        FLAGS_flash_attention_min_seq, through K2 at head dim 96 (ROADMAP
        C11: K2 runs at the padded width 128 there); its launches are
        counted on this path."""
        import numpy as np
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.serving import GenerationEngine
        cfg = GPTConfig(hidden_size=768, num_heads=8, num_layers=2)
        gpt = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
        rng = np.random.RandomState(1)
        lens, new = [24, 130, 300, 61], 8
        prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in lens]
        eng = GenerationEngine(
            gpt, device="cuda", name="chip_smoke_d96", max_slots=4,
            page_size=16, num_pages=1 + sum(-(-(n + new) // 16)
                                            for n in lens),
            prefill_buckets=(64, 256, 512), max_new_tokens=new,
            request_timeout_ms=0)
        # this path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        stats = eng.stats()
        eng.shutdown(drain=True, timeout_s=60)
        launches = self.record_path("serving_d96")
        k1 = launches["paged_attention"]
        k2 = launches["flash_fwd"]
        same = [np.array_equal(o, gpt.generate(p[None], max_new_tokens=new)
                               [0].cpu().numpy())
                for o, p in zip(outs, prompts)]
        print(f"serving head dim 96 (hidden 768, 8 heads, 2 layers): "
              f"{len(prompts)} requests, {len(prompts) * new} tokens in "
              f"{wall:.3f} s, {stats['steps']} decode steps; identical to "
              f"generate(): {sum(same)} of {len(same)}; K1 launches {k1}, "
              f"K2 launches {k2} (head dim 96, bucket 512 >= min-seq "
              f"{flag('FLAGS_flash_attention_min_seq')})")
        self.details["serving_d96"] = dict(steps=stats["steps"], k1=k1,
                                           k2=k2, identical=sum(same),
                                           wall_s=wall)
        assert all(same), "the D 96 engine differs from generate()"
        assert k1 > 0 and k1 == stats["steps"] * cfg.num_layers, \
            f"K1 launched {k1} times in {stats['steps']} steps"
        assert k2 == cfg.num_layers, \
            f"K2 launched {k2} times for one bucket-512 prefill of " \
            f"{cfg.num_layers} layers"
        del eng, gpt
        self.torch.cuda.empty_cache()

    # -- 5b. prefix cache, speculative decoding, chunked prefill ----------------

    def feature_engine(self, name, num_pages, gpt=None, **kw):
        """GenerationEngine over GPT-2 small (phase 5's model unless
        `gpt` is given) at phase 5's settings (8 slots, page 16, buckets
        16/64/256/1024), built and warmed."""
        from paddle_tpu_torch.serving import GenerationEngine
        return GenerationEngine(
            self.gpt if gpt is None else gpt, device="cuda", name=name,
            max_slots=FEAT["slots"],
            page_size=FEAT["page"], num_pages=num_pages,
            prefill_buckets=FEAT["buckets"], max_new_tokens=64,
            request_timeout_ms=0, **kw)

    def stream_run(self, eng, prompts, new, first=None, join_steps=0):
        """Submit prompts as streams: all at once while holding the
        engine's lock (admitted in one pass), or `first` of them, then
        the rest once the engine has taken `join_steps` steps. Returns
        (results, per-request token arrival times, submit times, wall
        seconds)."""
        n = len(prompts)
        arrivals = [[] for _ in range(n)]
        submit_t = [0.0] * n
        results = [None] * n
        threads = []

        def consume(i, stream):
            for _ in stream:
                arrivals[i].append(time.perf_counter())
            results[i] = stream.result()

        def submit(i):
            submit_t[i] = time.perf_counter()
            st = eng.submit_stream(prompts[i], max_new_tokens=new[i])
            th = threading.Thread(target=consume, args=(i, st), daemon=True)
            th.start()
            threads.append(th)

        t0 = time.perf_counter()
        if first is None:
            with eng._cv:
                for i in range(n):
                    submit(i)
        else:
            for i in range(first):
                submit(i)
            while eng.stats()["steps"] < join_steps:
                time.sleep(0.0005)
            for i in range(first, n):
                submit(i)
        for th in threads:
            th.join(600)
        return results, arrivals, submit_t, time.perf_counter() - t0

    def features(self):
        """Phase 5b: the JAX engine's three scheduling features on the
        port's engine, GPT-2 small (fp32, seed 0), each arm against the
        port's generate() and the same engine with the feature off."""
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        self.feature_prefix()
        self.feature_spec()
        self.feature_chunk()

    def feature_prefix(self):
        """Prefix arm: 8 greedy requests share one 192-token system
        prompt (12 pages) plus a distinct 16-token tail, 32 new tokens
        each; request 0 first, requests 1-7 and a repeat of request 0's
        whole prompt (a full-prompt match: one CoW split) once it
        decodes. Cache on and cache off at equal num_pages: outputs
        identical to each other and to generate(); with the cache on,
        prefix tokens > 0, prefill_tail[b=..] and cow_copy in the ledger,
        K1 launched once a layer a decode step, and no page held after
        the drain but the cached chains (evicting them all empties the
        pool). TTFT p50 of both arms."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        cfg = self.gpt.gpt.config
        L, P = cfg.num_layers, FEAT["page"]
        rng = np.random.RandomState(10)
        system = rng.randint(0, cfg.vocab_size, size=(192,))
        prompts = [np.concatenate([system, rng.randint(
            0, cfg.vocab_size, size=(16,))]) for _ in range(8)]
        prompts.append(prompts[0].copy())           # the full-prompt repeat
        new = [32] * len(prompts)
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        refs = self.generate_refs(prompts, new)
        out = {}
        for arm, on in (("prefix_on", True), ("prefix_off", False)):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      prefix_cache=on)
            cow0 = monitor.stat_get("STAT_cow_splits")
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, prompts, new, first=1,
                                                  join_steps=1)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            ttft = sorted((a[0] - s) * 1e3 for a, s in zip(arr, sub))
            toks = sum(len(a) for a in arr)
            out[arm] = dict(ttft_ms=ttft, ttft_p50_ms=ttft[len(ttft) // 2],
                            wall_s=wall, tokens_per_s=toks / wall,
                            steps=stats["steps"], compiles=stats["compiles"],
                            prefix=stats["kv"]["prefix"],
                            cow_splits=monitor.stat_get("STAT_cow_splits")
                            - cow0, launches=launches)
            print(f"prefix arm {arm} on {self.smi}: {len(prompts)} requests "
                  f"(192-token system prompt + 16), {toks} tokens in "
                  f"{wall:.3f} s = {toks / wall:.1f} tokens/s; TTFT p50 "
                  f"{out[arm]['ttft_p50_ms']:.2f} ms max {ttft[-1]:.2f} ms; "
                  f"{stats['steps']} steps; K1 launches "
                  f"{launches['paged_attention']}; prefix "
                  f"{stats['kv']['prefix']}; CoW splits "
                  f"{out[arm]['cow_splits']}; compiles {stats['compiles']}")
            self.assert_identical(arm, prompts, new, res, refs)
            assert launches["paged_attention"] == stats["steps"] * L, \
                f"{arm}: K1 launched {launches['paged_attention']} times " \
                f"in {stats['steps']} steps"
            cache = eng._cache
            assert cache.owners() == {}, f"{arm}: pages still owned"
            if on:
                p = stats["kv"]["prefix"]
                assert p["hit_tokens"] > 0 and p["hits"] >= 8, p
                assert out[arm]["cow_splits"] >= 1, "no CoW split"
                assert "cow_copy" in stats["compiles"]
                assert any(k.startswith("prefill_tail[b=")
                           for k in stats["compiles"]), stats["compiles"]
                refs_held = cache.refcounts()
                assert set(refs_held) == set(cache.cached_pages())
                assert set(refs_held.values()) <= {1}
                freed = eng._prefix.evict(cache.usable_pages)
                assert sorted(freed) == sorted(refs_held), "chain leaked"
            assert cache.pages_in_use == 0, f"{arm}: pages leaked"
            del eng
            torch.cuda.empty_cache()
        print(f"prefix arm on {self.smi}: TTFT p50 cache on "
              f"{out['prefix_on']['ttft_p50_ms']:.2f} ms, cache off "
              f"{out['prefix_off']['ttft_p50_ms']:.2f} ms "
              f"({out['prefix_off']['ttft_p50_ms'] / out['prefix_on']['ttft_p50_ms']:.2f}x)")
        self.details["feature_prefix"] = out

    def feature_spec(self):
        """Spec arm: spec_k=4, spec_ngram=3, 8 prompts each a 16-token
        motif repeated to 256 tokens, 64 new tokens, submitted together:
        the engine's NGramProposer (acceptance rate recorded, not
        gated), speculation off (the tokens/s it is held against), an
        oracle proposer drafting generate()'s own continuation
        (acceptance rate 1.0, accepted > 0, steps <= ceil(64 / 5) + 1),
        and a reject proposer (every draft wrong; then a later request
        reuses the freed pages). Every output identical to generate(),
        verify[k=4] in the ledger, K1 never launched."""
        torch = self.torch
        import numpy as np
        cfg = self.gpt.gpt.config
        K, P = FEAT["spec_k"], FEAT["page"]
        rng = np.random.RandomState(11)
        prompts = [np.resize(rng.randint(0, cfg.vocab_size, size=(16,)), 256)
                   for _ in range(8)]
        new = [64] * len(prompts)
        refs = self.generate_refs(prompts, new)
        later, later_new = prompts[0], 96
        later_ref = self.generate_refs([later], [later_new])
        num_pages = 1 + len(prompts) * -(-(256 + later_new) // P)

        class Oracle:
            def propose(self, tokens, k):
                toks = np.asarray(tokens, np.int32)
                for full in refs:
                    if np.array_equal(full[:toks.size], toks):
                        return full[toks.size:toks.size + k].astype(np.int32)
                return np.zeros((0,), np.int32)

        class Reject:
            def propose(self, tokens, k):
                t = np.asarray(tokens, np.int32)
                return ((np.repeat(t[-1:], k) + 7)
                        % cfg.vocab_size).astype(np.int32)

        out = {}
        for arm, k, proposer in (("spec_ngram", K, None),
                                 ("spec_off", 0, None),
                                 ("spec_oracle", K, Oracle()),
                                 ("spec_reject", K, Reject())):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      spec_k=k, spec_ngram=3)
            if proposer is not None:
                eng._proposer = proposer
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, _, wall = self.stream_run(eng, prompts, new)
            if arm == "spec_reject":
                # a later owner of the rejection-heavy run's freed pages
                res.append(eng.generate(later, max_new_tokens=later_new))
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            toks = sum(len(a) for a in arr)
            sp = stats["spec"]
            out[arm] = dict(wall_s=wall, tokens_per_s=toks / wall,
                            steps=stats["steps"], spec=sp,
                            compiles=stats["compiles"], launches=launches)
            print(f"spec arm {arm} on {self.smi}: {toks} tokens in "
                  f"{wall:.3f} s = {toks / wall:.1f} tokens/s, "
                  f"{stats['steps']} steps; spec {sp}; compiles "
                  f"{stats['compiles']}; K1 launches "
                  f"{launches['paged_attention']}")
            if arm == "spec_reject":
                self.assert_identical(arm, prompts + [later],
                                      new + [later_new], res,
                                      refs + later_ref)
            else:
                self.assert_identical(arm, prompts, new, res, refs)
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            if k:
                assert stats["compiles"].get(f"verify[k={K}]") == 1, \
                    stats["compiles"]
                assert launches["paged_attention"] == 0, \
                    f"{arm}: K1 launched under speculation"
            if arm == "spec_oracle":
                assert sp["accepted"] > 0 and sp["acceptance_rate"] == 1.0, sp
                assert stats["steps"] <= -(-new[0] // (K + 1)) + 1, \
                    f"oracle run took {stats['steps']} steps"
            if arm == "spec_reject":
                assert sp["drafted"] > 0 and sp["accepted"] == 0, sp
            del eng
            torch.cuda.empty_cache()
        print(f"spec arm on {self.smi}: tokens/s NGramProposer "
              f"{out['spec_ngram']['tokens_per_s']:.1f} (acceptance rate "
              f"{out['spec_ngram']['spec']['acceptance_rate']}) vs spec off "
              f"{out['spec_off']['tokens_per_s']:.1f} = "
              f"{out['spec_ngram']['tokens_per_s'] / out['spec_off']['tokens_per_s']:.2f}x; "
              f"oracle {out['spec_oracle']['tokens_per_s']:.1f} = "
              f"{out['spec_oracle']['tokens_per_s'] / out['spec_off']['tokens_per_s']:.2f}x")
        self.details["feature_spec"] = out

    def feature_chunk(self):
        """Chunk arm: 4 live streams (64-token prompts, 48 new tokens);
        a 900-token prompt (32 new) joins once they decode, with
        prefill_chunk=128, then with 0 (whole-prompt prefill, bucket
        1024). Identity to generate(); prefill_chunks == ceil(900/128);
        K2 launched 0 times in the chunked run and > 0 in the whole-
        prompt run; the live streams' TPOT p50 and p99 in both runs."""
        torch = self.torch
        import numpy as np
        cfg = self.gpt.gpt.config
        P, chunk = FEAT["page"], 128
        rng = np.random.RandomState(12)
        prompts = [rng.randint(0, cfg.vocab_size, size=(64,))
                   for _ in range(4)]
        prompts.append(rng.randint(0, cfg.vocab_size, size=(900,)))
        new = [48] * 4 + [32]
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        refs = self.generate_refs(prompts, new)
        out = {}
        for arm, c in (("chunk_128", chunk), ("chunk_0", 0)):
            eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                      prefill_chunk=c)
            torch.cuda.synchronize()
            # this path starts here: every launch count from 0
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, prompts, new, first=4,
                                                  join_steps=4)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            gaps = sorted((b - a) * 1e3 for a_ in arr[:4]
                          for a, b in zip(a_, a_[1:]))
            p50, p99 = gaps[len(gaps) // 2], gaps[int(0.99 * (len(gaps) - 1))]
            ttft_long = (arr[4][0] - sub[4]) * 1e3
            out[arm] = dict(tpot_p50_ms=p50, tpot_p99_ms=p99,
                            tpot_max_ms=gaps[-1], ttft_long_ms=ttft_long,
                            wall_s=wall, prefill_chunks=stats["prefill_chunks"],
                            steps=stats["steps"], compiles=stats["compiles"],
                            launches=launches)
            print(f"chunk arm {arm} on {self.smi}: live streams' TPOT p50 "
                  f"{p50:.3f} ms p99 {p99:.3f} ms max {gaps[-1]:.3f} ms; the "
                  f"900-token prompt's TTFT {ttft_long:.2f} ms; "
                  f"{stats['prefill_chunks']} chunks, {stats['steps']} steps; "
                  f"K2 launches {launches['flash_fwd']}, K1 "
                  f"{launches['paged_attention']}; compiles "
                  f"{stats['compiles']}")
            self.assert_identical(arm, prompts, new, res, refs)
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            if c:
                assert stats["prefill_chunks"] == -(-900 // chunk), stats
                assert launches["flash_fwd"] == 0, \
                    "K2 launched for a chunked prompt"
            else:
                assert stats["prefill_chunks"] == 0
                assert launches["flash_fwd"] > 0, \
                    "K2 never launched for the 900-token prefill"
            del eng
            torch.cuda.empty_cache()
        self.details["feature_chunk"] = out

    # -- 5c. quantized serving --------------------------------------------------

    def quant_serve(self, gpt, arm, num_pages, prompts, new, **kw):
        """Serve phase 5's way (8 requests, then the rest once the engine
        has taken 4 steps) on `gpt` with engine options `kw`; launches
        counted from 0 for this path. Returns (engine, results, row)."""
        torch = self.torch
        eng = self.feature_engine(f"chip_smoke_{arm}", num_pages, gpt=gpt,
                                  **kw)
        torch.cuda.synchronize()
        # this path starts here: every launch count from 0
        self.zero_launches()
        res, arr, sub, wall = self.stream_run(eng, prompts, new, first=8,
                                              join_steps=4)
        launches = self.record_path(arm)
        stats = eng.stats()
        eng.shutdown(drain=True, timeout_s=60)
        toks = sum(len(a) for a in arr)
        tpot = sorted((a[-1] - a[0]) * 1e3 / (len(a) - 1)
                      for a in arr if len(a) > 1)
        ttft = sorted((a[0] - s0) * 1e3 for a, s0 in zip(arr, sub))
        row = dict(tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
                   tpot_p50_ms=tpot[len(tpot) // 2],
                   ttft_p50_ms=ttft[len(ttft) // 2], steps=stats["steps"],
                   compiles=stats["compiles"], launches=launches,
                   launches_by_dtype=self.path_dtype_launches[arm],
                   pages=stats["pages"])
        print(f"quant arm {arm} on {self.smi}: {len(prompts)} requests, "
              f"{toks} tokens in {wall:.3f} s = {toks / wall:.1f} tokens/s; "
              f"TPOT p50 {row['tpot_p50_ms']:.3f} ms; TTFT p50 "
              f"{row['ttft_p50_ms']:.2f} ms; {stats['steps']} steps; pools "
              f"{stats['pages']['dtype']} {stats['pages']['hbm_bytes']} "
              f"bytes; launches {launches}")
        return eng, res, row

    @staticmethod
    def resident_bytes(model):
        """Device bytes of a model's parameters and buffers (each tensor
        once)."""
        seen, n = set(), 0
        for t in list(model.parameters()) + list(model.buffers()):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
        return n

    def quant(self):
        """Phase 5c: quantized serving of GPT-2 small (GPTConfig(), seed
        0) at phase 5's engine settings on phase 5's 16 requests ((b)
        and (e) on its first 8): (a) weight-only int8 and (b) int4
        weights over float32 pools, each
        token-identical to generate() on the same quantized model, K1 once
        a layer a decode step, K2 for every prompt in a bucket at or above
        FLAGS_flash_attention_min_seq; (c) float32 weights over int8 pools
        (two runs): first generated token exact against float32 pools,
        output bit-stable, no K1 launch, no page in use after the drain
        (token agreement, the top-2 logit gap at each first flip and
        can_admit capacity at equal pool bytes recorded); (d) int8 pools
        with the prefix cache on phase 5b's prefix-arm requests against
        the same engine with the cache off: the miss identical, every
        other output identical up to a first flip at a near-tie (top-2
        logit gap < NEAR_TIE), one CoW split, every freed page's scale
        rows 0 (agreement and TTFT p50 recorded); (e) a
        float16 GPT-2 small over float16 pools against its generate():
        first tokens exact, every output identical up to a first flip at
        a near-tie, K1 counted in float16. With --profile, the decode
        step of (a), (b) and (c) under torch.profiler, after all arms."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import quantization
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.serving import PagedKVCache
        cfg = GPTConfig()
        L, P = cfg.num_layers, FEAT["page"]
        prompts, new = self.serving_requests(cfg.vocab_size)
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))

        def flash_prefills(ps):
            # prompts whose bucket reaches FLAGS_flash_attention_min_seq
            return sum(next(b for b in FEAT["buckets"] if b >= len(p_))
                       >= flag("FLAGS_flash_attention_min_seq") for p_ in ps)
        # (b) and (e) serve the first 8 requests (prompts 16-900 tokens,
        # the 900-token one included), to keep the phase near the time of
        # phases 5 and 5b
        short = (prompts[:8], new[:8])
        out, profiled = {}, {}

        def fresh():
            return GPTForCausalLM(cfg, device="cuda", seed=0).eval()

        # (a), (b): weight-only int8 / int4 weights, float32 pools
        arm_s = {}   # wall seconds of each arm, references included
        for arm, bits, (ps, ns) in (("quant_w8", 8, (prompts, new)),
                                    ("quant_w4", 4, short)):
            t_arm = time.perf_counter()
            gpt = fresh()
            fp32_bytes = self.resident_bytes(gpt)
            quantization.quantize_weights(gpt, bits=bits)
            refs = self.generate_refs(ps, ns, gpt)
            eng, res, row = self.quant_serve(gpt, arm, num_pages, ps, ns)
            row.update(weight_bytes=self.resident_bytes(gpt),
                       fp32_weight_bytes=fp32_bytes)
            print(f"quant arm {arm}: resident weights {row['weight_bytes']} "
                  f"bytes against {fp32_bytes} in fp32 "
                  f"({fp32_bytes / row['weight_bytes']:.2f}x smaller)")
            out[arm] = row
            self.assert_identical(arm, ps, ns, res, refs, gpt)
            n = row["launches"]
            assert n["paged_attention"] == row["steps"] * L, \
                f"{arm}: K1 launched {n['paged_attention']} times in " \
                f"{row['steps']} steps"
            assert n["flash_fwd"] == flash_prefills(ps) * L, \
                f"{arm}: K2 launched {n['flash_fwd']} times for " \
                f"{flash_prefills(ps)} long prefills"
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            profiled[arm] = (gpt, {})
            del eng
            arm_s[arm] = time.perf_counter() - t_arm

        # (c): float32 weights, int8 pools, twice
        t_arm = time.perf_counter()
        gpt = self.gpt if getattr(self, "gpt", None) is not None else fresh()
        refs = getattr(self, "serving_refs", None) or \
            self.generate_refs(prompts, new, gpt)
        runs = []
        for arm in ("quant_kv8", "quant_kv8_repeat"):
            eng, res, row = self.quant_serve(gpt, arm, num_pages, prompts,
                                             new, kv_cache_dtype="int8")
            runs.append(res)
            out[arm] = row
            assert row["pages"]["dtype"] == "int8" and \
                row["pages"]["quantized"]
            assert row["launches"]["paged_attention"] == 0, \
                f"{arm}: K1 launched on int8 pools"
            assert eng._cache.pages_in_use == 0, f"{arm}: pages leaked"
            del eng
        row = out["quant_kv8"]
        for i, (a, b) in enumerate(zip(*runs)):
            assert np.array_equal(a, b), f"int8 KV request {i} not stable"
        S = [len(p_) for p_ in prompts]
        first = [int(r[s_] == f[s_]) for r, f, s_ in zip(runs[0], refs, S)]
        agree = float(np.mean([np.mean(r[s_:] == f[s_:])
                               for r, f, s_ in zip(runs[0], refs, S)]))
        flips = self.first_flips(prompts, new, runs[0], refs, gpt)
        dims = dict(num_layers=L, num_heads=cfg.num_heads,
                    head_dim=cfg.hidden_size // cfg.num_heads, page_size=P)
        budget = num_pages * PagedKVCache.page_hbm_bytes(dtype="float32",
                                                         **dims)
        cap = {}
        for dt in ("float32", "int8"):
            c = PagedKVCache(num_pages=PagedKVCache.pages_for_budget(
                budget, dtype=dt, **dims), pages_per_seq=64, dtype=dt,
                device="cuda", **dims)
            while c.can_admit(320):           # a 256-token prompt + 64
                c.alloc(cap.setdefault(dt, 0), 320)
                cap[dt] += 1
            del c
        row.update(first_token_exact=sum(first), token_agreement=agree,
                   flips=flips, capacity_at_equal_bytes=cap,
                   pool_budget_bytes=budget)
        print(f"quant arm quant_kv8 on {self.smi}: first token exact "
              f"{sum(first)} of {len(first)}; token agreement with fp32 "
              f"pools {agree:.4f}; first flips (request, step, top-2 logit "
              f"gap) {flips}; can_admit capacity at {budget} pool bytes: "
              f"fp32 {cap['float32']}, int8 {cap['int8']} requests of 320 "
              f"tokens ({cap['int8'] / cap['float32']:.2f}x)")
        assert all(first), "int8 KV changed a first generated token"
        profiled["quant_kv8"] = (gpt, dict(kv_cache_dtype="int8"))
        arm_s["quant_kv8"] = time.perf_counter() - t_arm
        t_arm = time.perf_counter()

        # (d): int8 pools with the prefix cache, phase 5b's prefix arm
        rng = np.random.RandomState(10)
        system = rng.randint(0, cfg.vocab_size, size=(192,))
        pprompts = [np.concatenate([system, rng.randint(
            0, cfg.vocab_size, size=(16,))]) for _ in range(8)]
        pprompts.append(pprompts[0].copy())     # the full-prompt repeat
        pnew = [32] * len(pprompts)
        pnum = 1 + sum(-(-(len(p_) + n_) // P)
                       for p_, n_ in zip(pprompts, pnew))
        res_on = None
        for arm, on in (("quant_kv8_prefix_on", True),
                        ("quant_kv8_prefix_off", False)):
            eng = self.feature_engine(f"chip_smoke_{arm}", pnum, gpt=gpt,
                                      kv_cache_dtype="int8",
                                      prefix_cache=on)
            cow0 = monitor.stat_get("STAT_cow_splits")
            torch.cuda.synchronize()
            self.zero_launches()
            res, arr, sub, wall = self.stream_run(eng, pprompts, pnew,
                                                  first=1, join_steps=1)
            launches = self.record_path(arm)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            ttft = sorted((a[0] - s0) * 1e3 for a, s0 in zip(arr, sub))
            cows = monitor.stat_get("STAT_cow_splits") - cow0
            out[arm] = dict(ttft_p50_ms=ttft[len(ttft) // 2], wall_s=wall,
                            steps=stats["steps"], cow_splits=cows,
                            prefix=stats["kv"]["prefix"],
                            compiles=stats["compiles"], launches=launches)
            print(f"quant arm {arm} on {self.smi}: TTFT p50 "
                  f"{out[arm]['ttft_p50_ms']:.2f} ms; {stats['steps']} "
                  f"steps; prefix {stats['kv']['prefix']}; CoW splits "
                  f"{cows}; K1 launches {launches['paged_attention']}")
            cache = eng._cache
            assert cache.owners() == {}, f"{arm}: pages still owned"
            assert launches["paged_attention"] == 0
            # every page the sequences freed has scale rows 0; the cached
            # chains keep theirs until their eviction zeroes them
            held = set(cache.cached_pages())
            freed = [pg for pg in range(1, cache.num_pages)
                     if pg not in held]
            for sc in (cache.k_scales, cache.v_scales):
                assert bool((sc[:, :, freed] == 0).all()), \
                    f"{arm}: a freed page kept its scale row"
            if on:
                res_on = res
                assert cows == 1, f"{arm}: {cows} CoW splits"
                assert stats["kv"]["prefix"]["hits"] >= 8
                assert held and bool((cache.k_scales[:, :, sorted(held)]
                                      > 0).any())
                # the engine's own eviction path: evict, then zero
                eng._zero_pages(eng._prefix.evict(cache.usable_pages))
            else:
                # a hit's tail attends its prefix dequantized from the int8
                # pages where the cache-off prefill computes it fresh, as
                # in the JAX engine: a near-tie may flip there, and the two
                # sequences part from that token on. The miss (request 0)
                # is exact, and every output equals the cache-off one up
                # to a first flip at a near-tie (agreement recorded)
                flips_d = self.first_flips(pprompts, pnew, res_on, res, gpt)
                S = len(pprompts[0])
                agree_d = float(np.mean([np.mean(a[S:] == b[S:])
                                         for a, b in zip(res_on, res)]))
                out[arm].update(flips_against_cache_on=flips_d,
                                agreement_with_cache_on=agree_d)
                print(f"quant arm int8 prefix cache on vs off on "
                      f"{self.smi}: token agreement {agree_d:.4f}; first "
                      f"flips (request, step, top-2 logit gap) {flips_d}")
                assert np.array_equal(res_on[0], res[0]), \
                    "the int8 prefix-cache miss differs from the cache off"
                assert all(gap < NEAR_TIE for _, _, gap in flips_d), \
                    f"a flip at a gap of {NEAR_TIE} or more: {flips_d}"
            assert cache.pages_in_use == 0, f"{arm}: pages leaked"
            for sc in (cache.k_scales, cache.v_scales):
                assert bool((sc[:, :, 1:] == 0).all()), \
                    f"{arm}: an evicted page kept its scale row"
            del eng

        arm_s["quant_kv8_prefix"] = time.perf_counter() - t_arm
        # (e): float16 GPT-2 small, float16 pools (ROADMAP C10)
        t_arm = time.perf_counter()
        gpt16 = fresh().half()
        ps, ns = short
        refs16 = self.generate_refs(ps, ns, gpt16)
        eng, res, row = self.quant_serve(gpt16, "fp16", num_pages, ps, ns)
        out["fp16"] = row
        by = row["launches_by_dtype"]["paged_attention"]
        assert row["pages"]["dtype"] == "float16"
        # K1 sums in fp32 where generate()'s dense attention rounds P to
        # fp16, and fp16 logits resolve 2^-9 near GPT-2 small's top
        # logits: a tie at one fp16 step may flip. The first token
        # (prefill, the same program) is exact, and every output equals
        # generate()'s up to a first flip at a near-tie
        flips16 = self.first_flips(ps, ns, res, refs16, gpt16)
        same16 = len(ps) - len(flips16)
        first16 = sum(int(r[len(p_)] == f[len(p_)])
                      for r, f, p_ in zip(res, refs16, ps))
        row.update(identical=same16, first_token_exact=first16,
                   flips=flips16)
        print(f"quant arm fp16 on {self.smi}: identical to generate() "
              f"{same16} of {len(ps)}; first token exact {first16}; "
              f"first flips (request, step, top-2 logit gap) {flips16}")
        assert first16 == len(ps), "fp16: a first token differs"
        assert all(gap < NEAR_TIE for _, _, gap in flips16), \
            f"fp16: a flip at a gap of {NEAR_TIE} or more: {flips16}"
        assert by.get("float16", 0) == row["launches"]["paged_attention"] \
            == row["steps"] * L, f"fp16: K1 launches {by} in " \
            f"{row['steps']} steps"
        assert row["launches_by_dtype"]["flash_fwd"].get("float16", 0) == \
            flash_prefills(ps) * L
        del eng, gpt16
        arm_s["fp16"] = time.perf_counter() - t_arm
        print(f"phase 5c arms' wall seconds: "
              f"{ {k: round(v, 1) for k, v in arm_s.items()} }")
        out["arm_s"] = arm_s

        if self.args.profile:
            for arm, (g, kw) in profiled.items():
                out[arm]["decode_profile"] = self.profile_decode(
                    g, f"profile_{arm}", **kw)
        self.details["quant"] = out
        del profiled
        torch.cuda.empty_cache()

    # -- observability: exporter scrapes and the step ring ----------------------

    def scrape(self, eng):
        """{metric: value} of the engine's `/metrics` page over 127.0.0.1
        (histograms by their _count and _sum lines)."""
        import urllib.request
        url = eng.metrics_server.url
        assert url.startswith("http://127.0.0.1:"), url
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        vals = {}
        for line in text.splitlines():
            if line and not line.startswith("#") and "_bucket{" not in line:
                k, v = line.rsplit(" ", 1)
                vals[k] = float(v)
        return vals

    def check_observability(self, label, eng, before, n_req):
        """The observability gates on a drained engine still running:
        the step ring (read from `/steps`) sums to stats() (tokens) and
        to the requests (admitted, completed), every record's six attr_*
        buckets sum exactly to its attr_wall_ms; `/metrics` shows
        STAT_kv_cache_hbm_bytes equal to the sum of every live cache's
        hbm_bytes(), STAT_device0_hbm_bytes_in_use > 0 and one
        ttft_ms / tpot_ms count per request since `before`; `/healthz`
        is 200. Returns the ring's records."""
        import gc
        import urllib.request
        from paddle_tpu_torch.serving import PagedKVCache
        url = eng.metrics_server.url
        st = eng.stats()
        with urllib.request.urlopen(url + "/steps", timeout=30) as r:
            steps = json.loads(r.read().decode())
        ring = steps["engines"][eng.name]
        recs = ring["records"]
        assert ring["recorded_total"] == len(recs), \
            f"{label}: the step ring overflowed ({ring['recorded_total']})"
        sums = {k: sum(r[k] for r in recs)
                for k in ("tokens", "admitted", "completed")}
        assert sums["tokens"] == st["tokens"], (label, sums, st["tokens"])
        assert sums["admitted"] == sums["completed"] == n_req, (label, sums)
        parts = ("attr_admit_ms", "prefill_ms", "attr_promote_ms",
                 "decode_ms", "attr_bookkeep_ms", "attr_idle_ms")
        off = [r for r in recs if r["attr_wall_ms"] > 0
               and abs(sum(r[p] for p in parts) - r["attr_wall_ms"]) > 1e-9]
        assert not off, f"{label}: attribution off in {len(off)} records"
        gc.collect()
        live = sum(o.hbm_bytes() for o in gc.get_objects()
                   if isinstance(o, PagedKVCache))
        after = self.scrape(eng)
        gauge = after["paddle_tpu_stat_kv_cache_hbm_bytes"]
        dev = after.get("paddle_tpu_stat_device0_hbm_bytes_in_use", 0)
        counts = {h: after[f"paddle_tpu_{h}_count"]
                  - before.get(f"paddle_tpu_{h}_count", 0)
                  for h in ("ttft_ms", "tpot_ms")}
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = r.status
        attr = {p: round(sum(r[p] for r in recs), 3) for p in parts}
        print(f"observability {label}: {len(recs)} step records, ring sums "
              f"{sums}, attribution ms {attr}; /metrics "
              f"STAT_kv_cache_hbm_bytes {gauge:.0f} (live caches {live}), "
              f"STAT_device0_hbm_bytes_in_use {dev:.0f}, ttft/tpot counts "
              f"{counts}; /healthz {health}")
        assert gauge == live, f"{label}: gauge {gauge} != live {live}"
        assert dev > 0, f"{label}: no device memory gauge"
        assert counts == {"ttft_ms": n_req, "tpot_ms": n_req}, counts
        assert health == 200
        self.details.setdefault("observability", {})[label] = dict(
            records=len(recs), sums=sums, attr_ms=attr, kv_gauge=gauge,
            device0_in_use=dev)
        return recs

    # -- 5d. the host KV tier and the engine's observability --------------------

    def tier_traffic(self, vocab):
        """Phase 5d's requests: four distinct 592-token system prompts
        (37 pages of 16) A-D, each with a 16-48-token user tail; wave 2
        the same system prompts with new tails. 32 new tokens each."""
        import numpy as np
        rng = np.random.RandomState(20)
        systems = [rng.randint(0, vocab, size=(592,)) for _ in range(4)]
        waves = [[np.concatenate([s, rng.randint(
            0, vocab, size=(int(rng.randint(16, 49)),))]) for s in systems]
            for _ in range(2)]
        return waves[0] + waves[1], [32] * 8

    def tier_serve(self, arm, prompts, new, num_pages, **kw):
        """Serve `prompts` one at a time (each drained before the next)
        on a GPT-2-small engine at phase 5's settings with the prefix
        cache on and `kw`; launches counted from 0 for this path. Per
        request: TTFT on the client clock. The promotion's device time
        (CUDA events on the engine's stream around `_promote_upload`),
        each demotion's slot reservation (host time), and each eviction
        pass's batched gather (`_tier_gather_flush`: host time, pages, and
        the stream time between CUDA events around it, its copies being
        queued, not waited for) are recorded. Returns (engine, outputs,
        row)."""
        torch = self.torch
        eng = self.feature_engine(f"chip_smoke_{arm}", num_pages,
                                  prefix_cache=True, metrics_port=0, **kw)
        promote, demote, reserve = [], [], []
        if eng._tier is not None:
            orig_promote, orig_gather, orig_flush = eng._promote_upload, \
                eng._prefix._gather, eng._prefix._flush

            # host ms of a promotion's parts, summed per promotion (a
            # stall shows in the part that holds it)
            parts = {}

            def timed_part(name, fn):
                def wrapper(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        parts[name] = parts.get(name, 0.0) + (
                            time.perf_counter() - t0) * 1e3
                return wrapper
            eng._tier_upload_call = timed_part(
                "upload", eng._tier_upload_call)
            eng._tier_write_call = timed_part("write", eng._tier_write_call)
            eng._zero_pages = timed_part("zero", eng._zero_pages)
            eng._prefix.consume_promoted = timed_part(
                "consume", eng._prefix.consume_promoted)

            def timed_promote(req, host_digests, matched_hbm):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                parts.clear()
                s.record()
                ok = orig_promote(req, host_digests, matched_hbm)
                e.record()
                promote.append((s, e, len(host_digests), ok,
                                {k: round(v, 3) for k, v in parts.items()}))
                return ok

            def timed_gather(page):
                t0 = time.perf_counter()
                out = orig_gather(page)
                reserve.append((time.perf_counter() - t0) * 1e3)
                return out

            def timed_flush():
                n = len(eng._gather_q)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                s.record()
                orig_flush()
                e.record()
                if n:
                    demote.append(((time.perf_counter() - t0) * 1e3, n,
                                   s, e))
            eng._promote_upload = timed_promote
            eng._prefix._gather = timed_gather
            eng._prefix._flush = timed_flush
        before = self.scrape(eng)
        torch.cuda.synchronize()
        # the interpreter's garbage collections during the run (a pause
        # of one shows as a stall of whatever the thread was doing)
        import gc
        gc_open, gc_pauses = [], []

        def on_gc(phase, info):
            if phase == "start":
                gc_open.append(time.perf_counter())
            elif gc_open:
                gc_pauses.append(((time.perf_counter() - gc_open.pop())
                                  * 1e3, info["generation"]))
        gc.callbacks.append(on_gc)
        # this path starts here: every launch count from 0
        self.zero_launches()
        outs, ttft = [], []
        t0 = time.perf_counter()
        try:
            for p, n in zip(prompts, new):
                t_sub = time.perf_counter()
                st = eng.submit_stream(p, max_new_tokens=n)
                first = None
                for _ in st:
                    if first is None:
                        first = time.perf_counter()
                outs.append(st.result())
                ttft.append((first - t_sub) * 1e3)
        finally:
            gc.callbacks.remove(on_gc)
        wall = time.perf_counter() - t0
        launches = self.record_path(arm)
        stats = eng.stats()
        torch.cuda.synchronize()
        prom = [(s.elapsed_time(e), n, ok) for s, e, n, ok, _p in promote]
        prom_parts = [p for _s, _e, _n, _ok, p in promote]
        row = dict(wall_s=wall, ttft_ms=ttft, steps=stats["steps"],
                   launches=launches, compiles=stats["compiles"],
                   prefix=stats["kv"]["prefix"], promote=prom,
                   promote_parts_ms=prom_parts,
                   demote_passes=[(h, n, s.elapsed_time(e))
                                  for h, n, s, e in demote],
                   demote_reserve_ms=reserve,
                   pages=stats["pages"], gc_pauses_ms=gc_pauses,
                   audit=[e["reason"] for e in eng._audit.tail(2048)],
                   audit_events=eng._audit.tail(2048))
        recs = self.check_observability(arm, eng, before, len(prompts))
        row["step_records"] = len(recs)
        # the iteration that admitted each request (one at a time): its
        # first token is delivered at that iteration's end
        row["admit_iters"] = [
            {k: r[k] for k in ("attr_admit_ms", "prefill_ms",
                               "attr_promote_ms", "decode_ms",
                               "attr_bookkeep_ms", "attr_idle_ms",
                               "attr_wall_ms")}
            for r in recs if r["admitted"]]
        print(f"tier arm {arm} on {self.smi}: {len(prompts)} requests in "
              f"{wall:.3f} s; TTFT ms {[round(x, 2) for x in ttft]}; "
              f"{stats['steps']} steps; launches {launches}; prefix "
              f"{stats['kv']['prefix']}")
        return eng, outs, row

    @staticmethod
    def tier_leak_free(eng):
        """After the drain no page leaks on either tier: the host tier's
        byte ledger equals its entries' bytes and the host slab's held
        slots its entries, and every allocated pool page is held once,
        by the prefix cache alone."""
        tier, cache = eng._tier, eng._cache
        refs = cache.refcounts()
        cached = set(cache.cached_pages())
        host_ok = tier is None or (
            tier.host_bytes == sum(e.nbytes for e in tier._entries.values())
            and eng._slab.held == len(tier))
        return (host_ok and cache.owners() == {} and set(refs) == cached
                and sum(refs.values()) == len(cached)
                and cache.pages_in_use == len(cached))

    def tier(self):
        """Phase 5d: GPT-2 small (fp32, seed 0) at phase 5's engine
        settings with the prefix cache (at most 80 pages: two of the
        ~40-page chains) and the host KV tier on (256 MB, chunks of 4
        pages). Wave 1 serves A-D one at a time; the budget demotes the
        least recently used chains to the host, so wave 2 (A-D with new
        tails) finds each system prompt there and promotes it. Arms:
        fp32 pools, int8 pools, `kv_tier.promote_upload@2` and
        `kv_tier.demote_gather@1`. Gates: every output token-identical
        to a tier-off engine whose prefix cache is unbounded (chains
        never evicted; fp32 also to generate()); 4 KV_PROMOTE in the
        fp32 and int8 arms and no host-budget eviction; the upload
        failpoint's arm exactly 1 KV_PROMOTE_ABANDON, that request a
        cold prefill; the gather failpoint's arm one demotion fewer than
        the fp32 arm, its first eviction plain; no page leaked on either
        tier; K1 = steps x 12 on fp32 pools (0 on int8), K2 = 12 x the
        cold prefills (every prompt is in the 1024 bucket); the
        observability gates (`check_observability`). Printed: TTFT p50 of
        wave 2 against wave 1 and the never-evicted engine's device
        hits, wave 2's admission iterations by part, promotion ms per
        page, the H2D rate and each promotion's host ms by part,
        demotion ms per chain (host) and per page (stream), the
        collections during each arm; then tokens/s and wall per step
        with the step log, audit ring and spans on against off (phase
        5's first 8 requests, on, off, off, on) and the observability
        calls' host time (`observability_host_cost`)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.serving import failpoints
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        L, P = self.gpt.gpt.config.num_layers, FEAT["page"]
        prompts, new = self.tier_traffic(self.gpt.gpt.config.vocab_size)
        need = max(-(-(len(p) + n) // P) for p, n in zip(prompts, new))
        budget = 80
        tier_pages = 1 + budget + need + 2
        ref_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        tier_kw = dict(prefix_cache_max_pages=budget, kv_tier=True,
                       kv_tier_host_bytes=256 << 20, kv_tier_chunk_pages=4)
        gen_refs = self.generate_refs(prompts, new)
        out = {}

        def p50(xs):
            return sorted(xs)[len(xs) // 2]

        for dtype in ("float32", "int8"):
            eng, ref_outs, row = self.tier_serve(
                f"tier_ref_{dtype}", prompts, new, ref_pages,
                kv_cache_dtype=dtype)
            eng.shutdown(drain=True, timeout_s=60)
            assert row["prefix"]["evictions"] == 0, "a chain was evicted"
            if dtype == "float32":
                self.assert_identical("tier_ref_float32", prompts, new,
                                      ref_outs, gen_refs)
            out[f"ref_{dtype}"] = dict(outs=ref_outs, row=row)
            del eng
            torch.cuda.empty_cache()

        arms = (("tier_fp32", "float32", ""), ("tier_int8", "int8", ""),
                ("tier_abandon", "float32", "kv_tier.promote_upload@2"),
                ("tier_nogather", "float32", "kv_tier.demote_gather@1"))
        for arm, dtype, fp in arms:
            failpoints.reset()
            set_flags({"FLAGS_failpoints": fp})
            try:
                eng, outs, row = self.tier_serve(
                    arm, prompts, new, tier_pages, kv_cache_dtype=dtype,
                    **tier_kw)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            ref = out[f"ref_{dtype}"]["outs"]
            same = [np.array_equal(a, b) for a, b in zip(outs, ref)]
            reasons = row["audit"]
            n = {c: reasons.count(c) for c in (
                "KV_PROMOTE", "KV_PROMOTE_ABANDON", "KV_DEMOTE",
                "KV_TIER_EVICT", "ADMIT", "ADMIT_PREFIX_HIT")}
            budget_evicts = [e for e in row["audit_events"]
                             if e["reason"] == "KV_TIER_EVICT"
                             and e["rid"] is None]
            leak_free = self.tier_leak_free(eng)
            tier_stats = eng._tier.stats()
            cold = n["ADMIT"]
            pr = [(ms, pages) for ms, pages, ok in row["promote"] if ok]
            page_bytes = eng._cache.page_host_bytes()
            prom_host = [e["ms"] for e in row["audit_events"]
                         if e["reason"] == "KV_PROMOTE"]
            row.update(identical=sum(same), audit_counts=n,
                       tier=tier_stats, leak_free=leak_free,
                       promote_host_ms=prom_host)
            del row["audit"], row["audit_events"]
            print(f"tier arm {arm}: identical to the never-evicted "
                  f"{dtype} engine {sum(same)} of {len(same)}; audit "
                  f"{n}; tier {tier_stats}; leak-free {leak_free}")
            if pr:
                ms = sum(m for m, _ in pr)
                pages = sum(p for _, p in pr)
                row["promote_ms_per_page"] = ms / pages
                row["promote_h2d_gb_s"] = pages * page_bytes / ms / 1e6
                print(f"tier arm {arm} on {self.smi}: promotion "
                      f"{ms / pages:.4f} ms a page ({page_bytes} bytes), "
                      f"{pages * page_bytes / ms / 1e6:.2f} GB/s implied, "
                      f"over {len(pr)} promotions of {pages} pages")
            if row["demote_passes"]:
                passes = row["demote_passes"]
                pages = sum(n for _h, n, _s in passes)
                host = sum(row["demote_reserve_ms"]) + sum(
                    h for h, _n, _s in passes)
                stream = sum(st for _h, _n, st in passes)
                row["demote_ms_per_page"] = host / pages
                row["demote_stream_ms_per_page"] = stream / pages
                print(f"tier arm {arm} on {self.smi}: demotion "
                      f"{host / pages:.4f} ms a page on the step thread "
                      f"(slot reservations and batched gathers), "
                      f"{host / pages * 37:.3f} ms a 37-page system "
                      f"prompt ({pages} pages in {len(passes)} passes, "
                      f"the longest pass {max(h for h, _n, _s in passes):.3f}"
                      f" ms); stream time {stream / pages:.4f} ms a page "
                      f"({pages * page_bytes / stream / 1e6:.2f} GB/s "
                      f"D2H); host slab {eng._slab.segments} segments, "
                      f"{eng._slab.reserved_bytes} bytes")
            prom_ms = [round(m, 3) for m, _p, _ok in row["promote"]]
            gcs = row["gc_pauses_ms"]
            print(f"tier arm {arm}: promotions in order, stream ms "
                  f"{prom_ms}, host ms {prom_host}, host ms by part "
                  f"{row['promote_parts_ms']}; {len(gcs)} garbage "
                  f"collections, the longest "
                  f"{max(gcs, default=(0.0, None))[0]:.3f} ms (generation "
                  f"{max(gcs, default=(0.0, None))[1]})")
            ttft = row["ttft_ms"]
            row["ttft_p50_wave1_ms"] = p50(ttft[:4])
            row["ttft_p50_wave2_ms"] = p50(ttft[4:])
            out[arm] = row
            assert all(same), f"{arm}: outputs differ from the " \
                f"never-evicted engine"
            if dtype == "float32":
                self.assert_identical(arm, prompts, new, outs, gen_refs)
            assert leak_free, f"{arm}: a page leaked"
            eng.shutdown(drain=True, timeout_s=60)
            assert not budget_evicts, f"{arm}: host-budget evictions"
            k1, k2 = row["launches"]["paged_attention"], \
                row["launches"]["flash_fwd"]
            assert k1 == (row["steps"] * L if dtype == "float32" else 0), \
                f"{arm}: K1 launched {k1} in {row['steps']} steps"
            assert k2 == L * cold, f"{arm}: K2 {k2} for {cold} cold prefills"
            if arm in ("tier_fp32", "tier_int8"):
                assert n["KV_PROMOTE"] == 4 and n["KV_PROMOTE_ABANDON"] == 0 \
                    and cold == 4, n
            elif arm == "tier_abandon":
                assert n["KV_PROMOTE_ABANDON"] == 1 and \
                    n["KV_PROMOTE"] == 3 and cold == 5, n
                assert tier_stats["abandons"] == 1
            else:
                assert tier_stats["demotions"] == \
                    out["tier_fp32"]["tier"]["demotions"] - 1, tier_stats
                assert row["prefix"]["evictions"] == \
                    out["tier_fp32"]["prefix"]["evictions"]
            del eng
            torch.cuda.empty_cache()
        hits = out["ref_float32"]["row"]["ttft_ms"][4:]
        print(f"tier TTFT p50 on {self.smi}: wave 1 cold "
              f"{out['tier_fp32']['ttft_p50_wave1_ms']:.2f} ms, wave 2 "
              f"promoted {out['tier_fp32']['ttft_p50_wave2_ms']:.2f} ms, "
              f"never-evicted device hits {p50(hits):.2f} ms (fp32); int8 "
              f"{out['tier_int8']['ttft_p50_wave1_ms']:.2f} / "
              f"{out['tier_int8']['ttft_p50_wave2_ms']:.2f} / "
              f"{p50(out['ref_int8']['row']['ttft_ms'][4:]):.2f} ms")

        def admit_parts(row):   # wave 2's admission iterations, mean ms
            its = row["admit_iters"][4:]
            return {k: round(sum(i[k] for i in its) / len(its), 3)
                    for k in its[0]}
        print(f"tier wave-2 admission iteration on {self.smi} (mean ms a "
              f"part): promoted {admit_parts(out['tier_fp32'])}, "
              f"never-evicted {admit_parts(out['ref_float32']['row'])}")
        for r in out.values():
            r.pop("outs", None)
        out["overhead"] = self.observability_overhead()
        self.details["tier"] = out

    def observability_overhead(self):
        """Tokens/s and wall per decode step of phase 5's engine on its
        first 8 requests with the step log, the audit ring and the spans
        on (the defaults) against off, in turns on, off, off, on. Off:
        FLAGS_gen_step_log and FLAGS_serving_spans false at construction,
        and the engine's audit ring replaced by a no-op on that engine
        (the ring has no flag; this patch is the measurement's only)."""
        from paddle_tpu_torch.framework.flags import set_flags
        prompts, new = self.serving_requests(self.gpt.gpt.config.vocab_size)
        prompts, new = prompts[:8], new[:8]
        num_pages = 1 + sum(-(-(len(p) + n) // FEAT["page"])
                            for p, n in zip(prompts, new))
        rows = []
        for on in (True, False, False, True):
            set_flags({"FLAGS_gen_step_log": on, "FLAGS_serving_spans": on})
            try:
                eng = self.feature_engine(f"chip_smoke_obs_{on}", num_pages)
            finally:
                set_flags({"FLAGS_gen_step_log": True,
                           "FLAGS_serving_spans": True})
            if not on:
                eng._audit.audit = lambda *a, **k: None
            res, arr, sub, wall = self.stream_run(eng, prompts, new)
            stats = eng.stats()
            eng.shutdown(drain=True, timeout_s=60)
            toks = sum(len(a) for a in arr)
            rows.append(dict(on=on, tokens_per_s=toks / wall,
                             ms_per_step=wall * 1e3 / stats["steps"],
                             steps=stats["steps"]))
            del eng
        for r in rows:
            print(f"observability {'on' if r['on'] else 'off'} on "
                  f"{self.smi}: {r['tokens_per_s']:.1f} tokens/s, "
                  f"{r['ms_per_step']:.3f} ms wall a step "
                  f"({r['steps']} steps)")
        on = [r["tokens_per_s"] for r in rows if r["on"]]
        off = [r["tokens_per_s"] for r in rows if not r["on"]]
        print(f"observability on / off tokens/s (same call): "
              f"{sum(on) / sum(off):.3f}")
        return dict(runs=rows, host_cost=self.observability_host_cost(
            prompts, new, num_pages))

    def observability_host_cost(self, prompts, new, num_pages):
        """The host time of the engine's observability calls, measured
        around each call (perf_counter) and summed over one run of phase
        5's first 8 requests with everything on: RecordEvent's begin and
        end (ring append and NVTX push / pop), the iteration's StepRecord
        (`_record_iteration`, which also republishes `pressure()`), the
        audit ring's calls and sink flushes, and the spans' stamps and
        finish. Per iteration, and as a share of the run's wall an
        iteration. Then one RecordEvent scope in a tight loop of 20000,
        NVTX on and off. The patches are this measurement's only."""
        import collections
        from paddle_tpu_torch import profiler
        from paddle_tpu_torch.profiler import spans
        acc, calls = collections.Counter(), collections.Counter()

        def timed(key, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    acc[key] += time.perf_counter() - t0
                    calls[key] += 1
            return wrapper
        saved = [(cls, name, cls.__dict__[name])
                 for cls, name in ((profiler.RecordEvent, "begin"),
                                   (profiler.RecordEvent, "end"),
                                   (spans.GenSpan, "stamp"),
                                   (spans.GenSpan, "finish"))]
        groups = {"RecordEvent.begin": "record_event",
                  "RecordEvent.end": "record_event",
                  "GenSpan.stamp": "spans", "GenSpan.finish": "spans",
                  "_record_iteration": "step_record", "audit": "audit",
                  "flush_sink": "audit"}
        for cls, name, fn in saved:
            setattr(cls, name, timed(f"{cls.__name__}.{name}", fn))
        try:
            eng = self.feature_engine("chip_smoke_obs_cost", num_pages)
            eng._record_iteration = timed("_record_iteration",
                                          eng._record_iteration)
            eng._audit.audit = timed("audit", eng._audit.audit)
            eng._audit.flush_sink = timed("flush_sink",
                                          eng._audit.flush_sink)
            acc.clear()
            calls.clear()
            it0 = eng._iters
            _res, _arr, _sub, wall = self.stream_run(eng, prompts, new)
            iters = eng._iters - it0
            steps = eng.stats()["steps"]
            eng.shutdown(drain=True, timeout_s=60)
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)
        us = collections.Counter()
        for k, v in acc.items():
            us[groups[k]] += v * 1e6 / iters
        total = sum(us.values())
        wall_it_ms = wall * 1e3 / iters
        # one scope in a tight loop, NVTX as the card has it, then off
        ev = profiler.RecordEvent("chip_smoke::scope")
        nvtx = list(profiler._nvtx)
        tight = {}
        try:
            for label, on in (("nvtx_on", True), ("nvtx_off", False)):
                profiler._nvtx[:] = [on]
                t0 = time.perf_counter()
                for _ in range(20000):
                    with ev:
                        pass
                tight[label] = (time.perf_counter() - t0) * 1e6 / 20000
        finally:
            profiler._nvtx[:] = nvtx
        row = dict(iters=iters, steps=steps, wall_ms_per_iter=wall_it_ms,
                   us_per_iter=dict(us), total_us_per_iter=total,
                   share_of_wall=total / (wall_it_ms * 1e3),
                   calls_per_iter={k: v / iters for k, v in calls.items()},
                   record_event_us=tight)
        print(f"observability host cost on {self.smi}: {total:.1f} us an "
              f"iteration = {100 * row['share_of_wall']:.2f} % of "
              f"{wall_it_ms:.3f} ms wall an iteration ({iters} iterations, "
              f"{steps} decode steps); by part (us an iteration): "
              f"{ {k: round(v, 2) for k, v in us.items()} }; calls an "
              f"iteration: "
              f"{ {k: round(v, 2) for k, v in row['calls_per_iter'].items()} }"
              f"; one RecordEvent scope in a tight loop: "
              f"{tight['nvtx_on']:.3f} us with NVTX, "
              f"{tight['nvtx_off']:.3f} us without")
        return row

    # -- optional: where the serving time goes ---------------------------------

    # -- 5e. supervised restart and the prefix-affinity router ------------------

    def fleet_kw(self, num_pages, **kw):
        """Phase 5's engine settings for a supervisor or a router."""
        return dict(device="cuda", max_slots=FEAT["slots"],
                    page_size=FEAT["page"], num_pages=num_pages,
                    prefill_buckets=FEAT["buckets"], max_new_tokens=64,
                    request_timeout_ms=0, **kw)

    @staticmethod
    def http_get(url):
        """(status, body) of a GET on 127.0.0.1, 5xx answers included."""
        import urllib.error
        import urllib.request
        assert url.startswith("http://127.0.0.1:"), url
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    @staticmethod
    def fleet_streams(front, prompts, new, join=None, lock=None,
                      handles=None):
        """Stream `prompts` through `front` (a supervisor or a router).
        With `join`, the first 8 go in at once, then, once `join()` says
        so, the rest at once (8 joining while 8 decode); else all at
        once. `lock()` gives the lock to hold while a group is submitted
        (the engine's, so its step thread admits the group in one pass),
        or None; `handles`, a list, receives the streams. Returns
        (results: the sequence or the exception, collected tokens,
        arrival times, submit times, wall s)."""
        n = len(prompts)
        results, collected = [None] * n, [[] for _ in range(n)]
        arrivals, submit_t = [[] for _ in range(n)], [0.0] * n
        threads = []
        if handles is not None:
            handles[:] = [None] * n

        def consume(i, stream):
            try:
                for tok in stream:
                    arrivals[i].append(time.perf_counter())
                    collected[i].append(tok)
                results[i] = stream.result()
            except Exception as e:  # noqa: BLE001 — the gates read it
                results[i] = e

        def submit(idx):
            lk = lock() if lock is not None else None
            if lk is not None:
                lk.acquire()
            try:
                for i in idx:
                    submit_t[i] = time.perf_counter()
                    st = front.submit_stream(prompts[i],
                                             max_new_tokens=new[i])
                    if handles is not None:
                        handles[i] = st
                    th = threading.Thread(target=consume, args=(i, st),
                                          daemon=True)
                    th.start()
                    threads.append(th)
            finally:
                if lk is not None:
                    lk.release()

        t0 = time.perf_counter()
        if join is None:
            submit(range(n))
        else:
            submit(range(min(8, n)))
            while not join():
                time.sleep(0.0005)
            submit(range(8, n))
        for th in threads:
            th.join(600)
        return results, collected, arrivals, submit_t, \
            time.perf_counter() - t0

    def death_probe(self, sup, n_death):
        """Instrument incarnation 0 of `sup`. Its pre-step hook counts
        steps; at step `n_death` (the step `decode_step_raise@n_death`
        kills) it records the time, the allocated bytes (the steady
        state) and resets the allocator's peak. Its death callback
        records the handover time, the manifest's entries and the dead
        pools' bytes, then runs the supervisor's and records the peak
        allocated bytes once the rebuilt engine is built and warmed, and
        once it has taken the replays."""
        torch = self.torch
        eng = sup.engine
        probe = {"steps": 0}

        def hook(e):
            probe["steps"] += 1
            if probe["steps"] == n_death:
                probe["t_death"] = time.perf_counter()
                probe["steady"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()

        def on_death(manifest, orig=eng._on_death):
            probe.setdefault("t_death", time.perf_counter())
            probe["t_handover"] = time.perf_counter()
            probe["live"] = sum(not e.queued for e in manifest.entries)
            probe["queued"] = sum(e.queued for e in manifest.entries)
            probe["replay_lens"] = [int(e.prompt.size) + len(e.toks)
                                    for e in manifest.entries]
            # tokens each stream had received before the death: its
            # next one is the first the new incarnation delivers
            probe["delivered"] = [(e.stream, e.delivered)
                                  for e in manifest.entries
                                  if e.stream is not None]
            probe["dead_hbm"] = eng._cache.hbm_bytes()
            orig(manifest)
            probe["t_rebuilt"] = time.perf_counter()
            probe["peak_rebuilt"] = torch.cuda.max_memory_allocated()

        def build(incarnation, carry, orig=sup._build_engine):
            new = orig(incarnation, carry)
            # the rebuilt engine allocated and warmed, no replay yet
            probe["peak_built"] = torch.cuda.max_memory_allocated()
            return new

        eng._pre_step_hook = hook
        eng._on_death = on_death
        sup._build_engine = build
        return probe

    @staticmethod
    def count_long_prefills():
        """Patch GenerationEngine._prefill_call to count the prefills (a
        rebuild's warmup included) whose bucket reaches
        FLAGS_flash_attention_min_seq, the ones that run K2. Returns
        (counter, undo)."""
        from paddle_tpu_torch.framework.flags import flag
        from paddle_tpu_torch.serving import generation
        orig = generation.GenerationEngine._prefill_call
        box = {"n": 0}

        def counted(eng, pt_row, ids, length):
            if ids.shape[1] >= int(flag("FLAGS_flash_attention_min_seq")):
                box["n"] += 1
            return orig(eng, pt_row, ids, length)

        generation.GenerationEngine._prefill_call = counted

        def undo():
            generation.GenerationEngine._prefill_call = orig
        return box, undo

    def fleet_restart_arm(self, arm, fp, prompts, new, refs, num_pages,
                          n_death=None, join=None, sup=None, **kw):
        """One supervised-restart arm: phase 5's streamed requests
        through an EngineSupervisor (built here with `kw` unless `sup`
        is given) with failpoint `fp` armed, launch counts from 0. The
        exact gates: outputs identical to generate(), each stream its
        generated tokens exactly once, one ENGINE_RESTART, REPLAY_ADMIT
        = the manifest's entries = the STAT_gen_replayed_requests delta,
        incarnation 1, the ledger, the loaded kernel libraries and nvcc
        untouched, K1 = 12 x (decode steps of both incarnations + the
        rebuild's warmup step), K2 = 12 x the prefills in buckets >= the
        min-seq flag, no page leaked, STAT_kv_cache_hbm_bytes back to
        before + the live cache's bytes, the dead pools released. Returns
        (supervisor, row)."""
        torch = self.torch
        import gc
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.serving import EngineSupervisor, failpoints
        L = self.gpt.gpt.config.num_layers
        gc.collect()
        # the residency gauge without this arm's caches
        gauge0 = monitor.stat_get("STAT_kv_cache_hbm_bytes") - (
            sup.engine._cache.hbm_bytes() if sup is not None else 0)
        if sup is None:
            sup = EngineSupervisor(self.gpt, name=f"chip_smoke_{arm}",
                                   **self.fleet_kw(num_pages, **kw))
        eng0 = sup.engine
        ledger0, libs0 = dict(eng0._ledger), dict(_build._libs)
        pool_bytes = eng0._cache.hbm_bytes()
        probe = self.death_probe(sup, n_death)
        nvcc_calls = []
        orig_nvcc = _build._nvcc
        _build._nvcc = lambda: nvcc_calls.append(1) or orig_nvcc()
        prefills, undo = self.count_long_prefills()
        replayed0 = monitor.stat_get("STAT_gen_replayed_requests")
        steps0 = eng0.stats()["steps"]
        failpoints.reset()
        set_flags({"FLAGS_failpoints": fp})
        # this path starts here: every launch count from 0
        self.zero_launches()
        streams = []
        try:
            res, collected, arrivals, _s, wall = self.fleet_streams(
                sup, prompts, new, join=join and (lambda: join(sup)),
                lock=lambda: sup.engine._cv, handles=streams)
        finally:
            set_flags({"FLAGS_failpoints": ""})
            undo()
            _build._nvcc = orig_nvcc
        launches = self.record_path(arm)
        eng1 = sup.engine
        st1 = eng1.stats()
        steps = eng0.stats()["steps"] - steps0 + st1["steps"]
        reasons = [e["reason"] for e in eng1._audit.tail(4096)]
        restarts = [e for e in eng1._audit.tail(4096)
                    if e["reason"] == "ENGINE_RESTART"]
        sstats = sup.supervisor_stats()
        replayed = monitor.stat_get("STAT_gen_replayed_requests") - replayed0
        peak_end = torch.cuda.max_memory_allocated()
        gen_tokens = sum(len(c) for c in collected)
        t_death = probe.get("t_death")
        index = {id(st): i for i, st in enumerate(streams)}
        first_replayed = min(
            (arrivals[index[id(st)]][d] for st, d in probe.get(
                "delivered", []) if id(st) in index
             and len(arrivals[index[id(st)]]) > d), default=None)
        row = dict(
            wall_s=wall, tokens=gen_tokens, tokens_per_s=gen_tokens / wall,
            steps=steps, launches=launches, long_prefills=prefills["n"],
            live_at_death=probe.get("live"),
            queued_at_death=probe.get("queued"),
            entries=sum(e["entries"] for e in restarts),
            replay_admit=reasons.count("REPLAY_ADMIT"),
            replayed_stat=replayed, supervisor=sstats,
            handover_ms=(probe["t_handover"] - t_death) * 1e3
            if "t_handover" in probe else None,
            rebuilt_ms=(probe["t_rebuilt"] - t_death) * 1e3
            if "t_rebuilt" in probe else None,
            first_replayed_token_ms=(first_replayed - t_death) * 1e3
            if first_replayed is not None else None,
            steady_bytes=probe.get("steady"),
            peak_built_bytes=probe.get("peak_built"),
            peak_rebuilt_bytes=probe.get("peak_rebuilt"),
            peak_end_bytes=peak_end, pool_bytes=pool_bytes)
        print(f"fleet arm {arm} on {self.smi}: {len(prompts)} requests, "
              f"{gen_tokens} tokens in {wall:.3f} s "
              f"({gen_tokens / wall:.1f} tokens/s); {sstats['restarts']} "
              f"restart(s), {row['live_at_death']} live + "
              f"{row['queued_at_death']} queued at the death, "
              f"{row['replay_admit']} REPLAY_ADMIT; recovery "
              f"{sstats['last_recovery_ms']} ms in the supervisor "
              f"(rebuild, warmup, replay), death -> rebuilt "
              f"{row['rebuilt_ms']} ms, death -> first replayed token "
              f"{row['first_replayed_token_ms']} ms; {steps} decode steps, "
              f"launches {launches}, {prefills['n']} prefills in buckets "
              f">= the min-seq flag")
        if row["steady_bytes"] is not None:
            print(f"fleet arm {arm} on {self.smi}: allocated bytes steady "
                  f"(at the death step) {row['steady_bytes']}, peak to "
                  f"the rebuild's warmup {row['peak_built_bytes']} "
                  f"(+{row['peak_built_bytes'] - row['steady_bytes']}), "
                  f"to the replays taken {row['peak_rebuilt_bytes']} "
                  f"(+{row['peak_rebuilt_bytes'] - row['steady_bytes']}), "
                  f"peak to the arm's end {peak_end} "
                  f"(+{peak_end - row['steady_bytes']}); one pool set "
                  f"{pool_bytes}")
        # gates
        outs = [r if isinstance(r, np.ndarray) else None for r in res]
        bad = [(i, repr(r)) for i, r in enumerate(res)
               if not isinstance(r, np.ndarray)]
        assert not bad, f"{arm}: requests failed: {bad}"
        self.assert_identical(arm, prompts, new, outs, refs)
        once = [i for i, (p, o) in enumerate(zip(prompts, outs))
                if collected[i] != o[len(p):].tolist()]
        assert not once, f"{arm}: streams {once} not exactly once"
        assert sstats["restarts"] == len(restarts) == 1, (sstats, restarts)
        assert st1["incarnation"] == sstats["incarnation"] == 1, st1
        assert row["replay_admit"] == row["entries"] == replayed, row
        assert dict(eng1._ledger) == ledger0, \
            f"{arm}: the rebuild added ledger keys"
        assert dict(_build._libs) == libs0 and not nvcc_calls, \
            f"{arm}: a kernel was built during the arm"
        assert launches["paged_attention"] == (steps + 1) * L, \
            f"{arm}: K1 {launches['paged_attention']} for {steps} steps " \
            f"+ the rebuild's warmup step"
        assert launches["flash_fwd"] == prefills["n"] * L, \
            f"{arm}: K2 {launches['flash_fwd']} for {prefills['n']} " \
            f"long prefills"
        long_replays = sum(n > 256 for n in probe.get("replay_lens", []))
        assert prefills["n"] >= 1 + long_replays, (prefills, long_replays)
        assert probe.get("dead_hbm") == 0, "the dead pools were not released"
        sup.shutdown(drain=True, timeout_s=60)
        assert st1["pages"]["pages_in_use"] == 0 == \
            eng1.stats()["pages"]["pages_in_use"], f"{arm}: pages leaked"
        gc.collect()
        gauge = monitor.stat_get("STAT_kv_cache_hbm_bytes")
        assert gauge == gauge0 + eng1._cache.hbm_bytes(), \
            f"{arm}: STAT_kv_cache_hbm_bytes {gauge} != {gauge0} + " \
            f"{eng1._cache.hbm_bytes()}"
        if row["steady_bytes"] is not None:
            for k in ("peak_built_bytes", "peak_rebuilt_bytes",
                      "peak_end_bytes"):
                assert row[k] - row["steady_bytes"] < pool_bytes / 2, \
                    f"{arm}: {k} {row[k]} exceeds steady " \
                    f"{row['steady_bytes']} by half a pool set or more"
        row["reasons"] = {c: reasons.count(c) for c in set(reasons)}
        return sup, row

    def fleet_sessions(self, vocab, seed):
        """Four agent sessions: each its own 192-token system prompt; a
        turn's user message 16-32 tokens (seeded)."""
        import numpy as np
        rng = np.random.RandomState(seed)
        systems = [rng.randint(0, vocab, size=(192,)) for _ in range(4)]
        users = [[rng.randint(0, vocab, size=(int(rng.randint(16, 33)),))
                  for _ in range(3)] for _ in range(4)]
        return systems, users

    def fleet_session_run(self, router, systems, users, new=32):
        """Serve the four sessions turn by turn through `router`: turn
        t's prompt is turn t-1's prompt and output plus the next user
        message; turn t submits the sessions in an order rotated by t
        (agents answer at different times). Returns (prompts
        [turn][session], outputs, TTFT ms, the replica each request was
        placed on [turn][session], read off the router's audit ring)."""
        import numpy as np
        S = len(systems)
        prompts, outs, ttft, placed = [], [], [], []
        prev = [None] * S
        for t in range(3):
            order = [(i + t) % S for i in range(S)]
            ps = [np.concatenate([systems[s] if prev[s] is None
                                  else prev[s], users[s][t]])
                  for s in order]
            n0 = len(router.stats()["router"]["audit_tail"])
            res, _c, arr, sub, _w = self.fleet_streams(
                router, ps, [new] * S)
            for s, r in zip(order, res):
                assert isinstance(r, np.ndarray), \
                    f"session {s} turn {t}: {r!r}"
            where = [e["replica"] for e in router.stats()["router"][
                "audit_tail"][n0:] if e["reason"] in (
                    "ROUTE_AFFINITY", "ROUTE_LEAST_PRESSURE")]
            back = {s: i for i, s in enumerate(order)}
            prompts.append([ps[back[s]] for s in range(S)])
            outs.append([res[back[s]] for s in range(S)])
            ttft.append([(arr[back[s]][0] - sub[back[s]]) * 1e3
                         for s in range(S)])
            placed.append([where[back[s]] for s in range(S)])
            prev = outs[-1]
        return prompts, outs, ttft, placed

    def fleet_router_arms(self, prompts5, new5, refs5, num_pages):
        """Phase 5e (b): two replicas (EngineSupervisors with the prefix
        cache on) over the one GPT-2 small behind a Router. Four agent
        sessions of three turns with affinity on, then off (outputs
        identical to generate(); with affinity, turns 2-3 on turn 1's
        replica: 8 ROUTE_AFFINITY); then, on the affinity router, the
        kill arm (phase 5's 16 requests, decode_step_raise@6: every
        request served through its replica's replay, identical to
        generate() and exactly once, no ROUTE_REROUTE, the router's
        /readyz 200 throughout); then 16 requests at phase 5's lengths
        through the two replicas and through one engine (tokens/s, the
        same outputs). No page leaked on either replica."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.serving import (EngineSupervisor, Router,
                                              failpoints)
        L = self.gpt.gpt.config.num_layers
        out = {}

        def p50(xs):
            return sorted(xs)[len(xs) // 2]

        def hit_tokens(r):
            return sum(rep.sup.stats()["kv"]["prefix"]["hit_tokens"]
                       for rep in r._replicas)

        def leak_free(r):
            return all(rep.sup.engine._cache.owners() == {}
                       and rep.sup.engine._cache.pages_in_use
                       == len(rep.sup.engine._cache.cached_pages())
                       for rep in r._replicas)

        # sessions through the affinity router and the round-robin one,
        # in the order on, off, off, on (two session sets; each router
        # meets a set once), so the two are compared in turns
        routers = {aff: Router(
            self.gpt, num_replicas=2,
            name=f"chip_smoke_fleet_{'affinity' if aff else 'rr'}",
            affinity=aff, prefix_cache=True,
            metrics_port=0 if aff else None, **self.fleet_kw(num_pages))
            for aff in (True, False)}
        by_seed = {}
        for n, (aff, seed) in enumerate(((True, 5), (False, 5), (False, 6),
                                         (True, 6))):
            r = routers[aff]
            arm = f"fleet_sessions_{'on' if aff else 'off'}_{n // 2 + 1}"
            systems, users = self.fleet_sessions(
                self.gpt.gpt.config.vocab_size, seed)
            audit0 = len(r.stats()["router"]["audit_tail"])
            hits0 = hit_tokens(r)
            self.zero_launches()
            t0 = time.perf_counter()
            prompts, outs, ttft, placed = self.fleet_session_run(
                r, systems, users)
            wall = time.perf_counter() - t0
            launches = self.record_path(arm)
            reasons = [e["reason"] for e in
                       r.stats()["router"]["audit_tail"][audit0:]]
            flat_p = [p for turn in prompts for p in turn]
            flat_o = [o for turn in outs for o in turn]
            if seed not in by_seed:
                by_seed[seed] = (flat_p, self.generate_refs(
                    flat_p, [32] * len(flat_p)))
            same_p = all(np.array_equal(a, b)
                         for a, b in zip(flat_p, by_seed[seed][0]))
            assert same_p, f"{arm}: prompts differ between the routers"
            self.assert_identical(arm, flat_p, [32] * len(flat_p), flat_o,
                                  by_seed[seed][1])
            row = dict(wall_s=wall, placed=placed, launches=launches,
                       affinity_routes=reasons.count("ROUTE_AFFINITY"),
                       hit_tokens=hit_tokens(r) - hits0, ttft_ms=ttft,
                       ttft_p50_turns23_ms=p50(ttft[1] + ttft[2]),
                       ttft_p50_turn1_ms=p50(ttft[0]))
            out[arm] = row
            print(f"fleet arm {arm} on {self.smi}: 4 sessions x 3 turns "
                  f"in {wall:.3f} s; replicas by turn {placed}; "
                  f"ROUTE_AFFINITY {row['affinity_routes']}; prefix-hit "
                  f"tokens {row['hit_tokens']}; TTFT p50 turns 2-3 "
                  f"{row['ttft_p50_turns23_ms']:.2f} ms, turn 1 "
                  f"{row['ttft_p50_turn1_ms']:.2f} ms; launches "
                  f"{launches}")
            assert leak_free(r), f"{arm}: a page leaked"
            if aff:
                assert placed[1] == placed[0] == placed[2], \
                    f"{arm}: turns 2-3 left their session's replica " \
                    f"{placed}"
                assert row["affinity_routes"] == 8, reasons
        routers[False].shutdown(drain=True, timeout_s=60)
        assert leak_free(routers[False]), "fleet_sessions_off: a page leaked"
        del routers[False]
        r = routers[True]

        # the kill arm: decode_step_raise@6 kills one replica mid-load
        arm = "fleet_kill"
        engines0 = [rep.sup.engine for rep in r._replicas]
        steps0 = [e.stats()["steps"] for e in engines0]
        ledgers0 = [dict(e._ledger) for e in engines0]
        reroutes0 = monitor.stat_get("STAT_router_reroutes")
        audit0 = len(r.stats()["router"]["audit_tail"])
        url = r.metrics_server.url if r.metrics_server is not None else None
        statuses, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                code, body = self.http_get(url + "/readyz")
                statuses.append((code, json.loads(body)["engines"].get(
                    r.name, {}).get("ready")))
                time.sleep(0.01)

        poller = threading.Thread(target=poll, daemon=True)
        failpoints.reset()
        set_flags({"FLAGS_failpoints": "decode_step_raise@6"})
        self.zero_launches()
        poller.start()
        try:
            res, collected, _a, _s, wall = self.fleet_streams(
                r, prompts5, new5)
        finally:
            set_flags({"FLAGS_failpoints": ""})
            stop.set()
            poller.join(30)
        launches = self.record_path(arm)
        restarts = sum(rep.sup.restarts for rep in r._replicas)
        steps = sum(e.stats()["steps"] - s0
                    for e, s0 in zip(engines0, steps0))
        steps += sum(rep.sup.engine.stats()["steps"]
                     for rep, e in zip(r._replicas, engines0)
                     if rep.sup.engine is not e)
        route = [e["reason"] for e in
                 r.stats()["router"]["audit_tail"][audit0:]]
        reroutes = monitor.stat_get("STAT_router_reroutes") - reroutes0
        row = dict(wall_s=wall, restarts=restarts, steps=steps,
                   launches=launches, reroutes=reroutes,
                   route={c: route.count(c) for c in set(route)},
                   readyz=sorted({s for s in statuses}, key=str),
                   readyz_polls=len(statuses),
                   recovery_ms=[rep.sup.supervisor_stats()[
                       "last_recovery_ms"] for rep in r._replicas],
                   # which replica died, and so how many requests replay
                   # (each with its prefill, K2 where a prompt reaches
                   # the flash minimum), depends on timing
                   replayed=[rep.sup.supervisor_stats()[
                       "replayed_requests"] for rep in r._replicas])
        out[arm] = row
        print(f"fleet arm {arm} on {self.smi}: {len(prompts5)} requests in "
              f"{wall:.3f} s; {restarts} restart(s), recovery ms "
              f"{row['recovery_ms']}, replayed requests by replica "
              f"{row['replayed']}; router audit {row['route']}; "
              f"/readyz (status, router ready) seen {row['readyz']} over "
              f"{len(statuses)} polls; {steps} decode steps, launches "
              f"{launches}")
        bad = [(i, repr(x)) for i, x in enumerate(res)
               if not isinstance(x, np.ndarray)]
        assert not bad, f"{arm}: requests failed: {bad}"
        self.assert_identical(arm, prompts5, new5, res, refs5)
        once = [i for i, (p, o) in enumerate(zip(prompts5, res))
                if collected[i] != o[len(p):].tolist()]
        assert not once, f"{arm}: streams {once} not exactly once"
        assert restarts == 1, f"{arm}: {restarts} restarts"
        assert reroutes == 0 and "ROUTE_REROUTE" not in route, \
            f"{arm}: re-routes without a placement-time failure"
        assert statuses and all(s == (200, True) for s in statuses), \
            f"{arm}: the router's /readyz left 200: {row['readyz']}"
        assert [dict(rep.sup.engine._ledger) for rep in r._replicas] == \
            ledgers0, f"{arm}: a rebuild added ledger keys"
        assert launches["paged_attention"] == (steps + restarts) * L, \
            f"{arm}: K1 {launches['paged_attention']} for {steps} steps " \
            f"+ {restarts} rebuild warmup step(s)"
        assert leak_free(r), f"{arm}: a page leaked"
        # aggregate tokens/s: phase 5's lengths with other tokens (no
        # prefix a replica holds) through the two replicas and through one
        # engine with the same settings, in the order two, one, one, two
        # (two token sets; each front meets a set once); the two fronts
        # give the same outputs
        one = EngineSupervisor(self.gpt, name="chip_smoke_fleet_one",
                               prefix_cache=True, **self.fleet_kw(num_pages))
        thr, outs_t = {"fleet_two": [], "fleet_one": []}, {}
        for arm, seed in (("fleet_two", 1), ("fleet_one", 1),
                          ("fleet_one", 2), ("fleet_two", 2)):
            front = r if arm == "fleet_two" else one
            prompts_t, new_t = self.serving_requests(
                self.gpt.gpt.config.vocab_size, seed=seed)
            self.zero_launches()
            res, _c, _a, _s, wall = self.fleet_streams(front, prompts_t,
                                                       new_t)
            self.record_path(f"{arm}_{seed}")
            bad = [(i, repr(x)) for i, x in enumerate(res)
                   if not isinstance(x, np.ndarray)]
            assert not bad, f"{arm}: requests failed: {bad}"
            thr[arm].append(sum(len(o) - len(p)
                                for o, p in zip(res, prompts_t)) / wall)
            if seed in outs_t:
                same = [np.array_equal(a, b)
                        for a, b in zip(outs_t[seed], res)]
                assert all(same), \
                    f"two replicas and one engine differ: {same}"
            outs_t[seed] = res
        one.shutdown(drain=True, timeout_s=60)
        del one
        out["tokens_per_s"] = thr
        two, single = sum(thr["fleet_two"]) / 2, sum(thr["fleet_one"]) / 2
        print(f"fleet throughput on {self.smi}: 16 requests at phase 5's "
              f"lengths, two replicas {[round(x, 1) for x in thr['fleet_two']]}"
              f" tokens/s, one engine "
              f"{[round(x, 1) for x in thr['fleet_one']]} tokens/s (two, "
              f"one, one, two: {two / single:.2f}x on the means)")
        r.shutdown(drain=True, timeout_s=60)
        assert leak_free(r), "fleet_two: a page leaked"
        del r
        torch.cuda.empty_cache()
        return out

    def fleet(self):
        """Phase 5e: GPT-2 small (fp32, seed 0) at phase 5's engine
        settings under EngineSupervisor and Router. (a) Phase 5's 16
        streamed requests (8 joining while 8 decode) through one
        supervisor with FLAGS_gen_restart_backoff_ms 5: arms
        decode_step_raise@12 (8 live and 8 queued at the death),
        prefill_raise@1, and a spec_k 4 engine with
        FLAGS_gen_poison_degrade_k 2 (decode_poison_nan@every:1 on two
        requests, then decode_step_raise@1); the exact gates of
        `fleet_restart_arm`; the restart's peak allocated bytes over the
        death step's by less than half a pool set; then the breaker arm
        (decode_step_raise@every:1, retry limit 2, threshold 3): every
        request fails typed, BREAKER_OPEN once, /readyz 503 with the
        reason. (b) `fleet_router_arms`."""
        torch = self.torch
        from paddle_tpu_torch.framework.errors import UnavailableError
        from paddle_tpu_torch.framework.flags import get_flags, set_flags
        from paddle_tpu_torch.serving import EngineSupervisor, failpoints
        if not hasattr(self, "gpt"):
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        prompts, new = self.serving_requests(self.gpt.gpt.config.vocab_size)
        refs = getattr(self, "serving_refs", None) or \
            self.generate_refs(prompts, new)
        P = FEAT["page"]
        num_pages = 1 + sum(-(-(len(p) + n) // P)
                            for p, n in zip(prompts, new))
        saved = get_flags(["FLAGS_gen_restart_backoff_ms",
                           "FLAGS_gen_poison_degrade_k"])
        set_flags({"FLAGS_gen_restart_backoff_ms": 5.0})
        out = {}
        try:
            def steps_at(k, after_restart=False):
                return lambda sup: (sup.engine.stats()["steps"] >= k
                                    and (sup.restarts >= 1
                                         or not after_restart))

            _, out["fleet_restart"] = self.fleet_restart_arm(
                "fleet_restart", "decode_step_raise@12", prompts, new, refs,
                num_pages, n_death=12, join=steps_at(2))
            r = out["fleet_restart"]
            assert (r["live_at_death"], r["queued_at_death"]) == (8, 8), r
            assert r["steady_bytes"] is not None
            torch.cuda.empty_cache()
            _, out["fleet_prefill"] = self.fleet_restart_arm(
                "fleet_prefill", "prefill_raise@1", prompts, new, refs,
                num_pages, join=steps_at(2, after_restart=True))
            torch.cuda.empty_cache()

            # degraded: speculation off after two poison events, then a
            # death; incarnation 1 starts with speculation off
            set_flags({"FLAGS_gen_poison_degrade_k": 2})
            sup = EngineSupervisor(self.gpt, name="chip_smoke_fleet_spec",
                                   spec_k=FEAT["spec_k"],
                                   **self.fleet_kw(num_pages))
            failpoints.reset()
            set_flags({"FLAGS_failpoints": "decode_poison_nan@every:1"})
            self.zero_launches()
            try:
                for i in (0, 2):
                    try:
                        sup.submit(prompts[i],
                                   max_new_tokens=new[i]).result(60)
                        raise AssertionError("a poisoned request succeeded")
                    except AssertionError:
                        raise
                    except Exception as e:  # noqa: BLE001 — checked here
                        assert "non-finite" in str(e), repr(e)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            poison = self.record_path("fleet_spec_poison")
            reasons = [e["reason"] for e in sup.engine._audit.tail(4096)]
            assert reasons.count("DEGRADED_SPEC_OFF") == 1, reasons
            assert sup.stats()["degraded"]["spec_off"]
            assert poison["paged_attention"] == 0, \
                f"the verify program launched K1: {poison}"
            _, row = self.fleet_restart_arm(
                "fleet_degraded", "decode_step_raise@1", prompts, new, refs,
                num_pages, join=steps_at(2, after_restart=True), sup=sup)
            assert row["reasons"]["DEGRADED_SPEC_OFF"] == 1, row["reasons"]
            assert row["launches"]["paged_attention"] > 0
            out["fleet_degraded"] = row
            degraded = sup.engine.stats()
            assert degraded["degraded"]["spec_off"] and \
                degraded["incarnation"] == 1, degraded["degraded"]
            del sup
            set_flags({"FLAGS_gen_poison_degrade_k": 0})
            torch.cuda.empty_cache()

            # the breaker: every step dies
            sup = EngineSupervisor(self.gpt, name="chip_smoke_fleet_breaker",
                                   retry_limit=2, breaker_threshold=3,
                                   metrics_port=0,
                                   **self.fleet_kw(num_pages))
            few = [0, 2, 6, 11]
            failpoints.reset()
            set_flags({"FLAGS_failpoints": "decode_step_raise@every:1"})
            self.zero_launches()
            try:
                res, _c, _a, _s, wall = self.fleet_streams(
                    sup, [prompts[i] for i in few], [new[i] for i in few],
                    lock=lambda: sup.engine._cv)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            self.record_path("fleet_breaker")
            code, body = self.http_get(sup.metrics_server.url + "/readyz")
            entry = json.loads(body)["engines"][sup.name]
            reasons = [e["reason"] for e in sup.engine._audit.tail(4096)]
            ss = sup.supervisor_stats()
            print(f"fleet arm fleet_breaker on {self.smi}: "
                  f"{[type(x).__name__ for x in res]} in {wall:.3f} s; "
                  f"{ss['incarnation']} incarnations, breaker "
                  f"{ss['breaker']}; /readyz {code} {entry['reason']!r}")
            out["fleet_breaker"] = dict(
                errors=[type(x).__name__ for x in res], readyz=code,
                reason=entry["reason"], supervisor=ss,
                reasons={c: reasons.count(c) for c in set(reasons)})
            assert all(isinstance(x, UnavailableError) for x in res), res
            assert reasons.count("BREAKER_OPEN") == 1, reasons
            assert code == 503 and not entry["ready"] and \
                "breaker open" in entry["reason"], (code, entry)
            sup.shutdown(drain=True, timeout_s=60)
            del sup
            torch.cuda.empty_cache()
            out.update(self.fleet_router_arms(prompts, new, refs, num_pages))
        finally:
            set_flags(saved)
            set_flags({"FLAGS_failpoints": ""})
        self.details["fleet"] = out

    def profile(self):
        """Prefill wall time per bucket, then torch.profiler over 20
        decode steps of 8 live sequences: wall per step, device busy
        share, device time by kernel."""
        torch = self.torch
        from paddle_tpu_torch.models.gpt import gpt_prefill
        cfg = self.gpt.gpt.config
        W = self.gpt.decode_weights()
        H = cfg.num_heads
        scale = 1.0 / (cfg.hidden_size // H) ** 0.5
        with torch.inference_mode():
            for b in (16, 64, 256, 1024):
                ids = torch.zeros(1, b, dtype=torch.long, device="cuda")
                gpt_prefill(W, ids, num_heads=H, scale=scale)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    gpt_prefill(W, ids, num_heads=H, scale=scale)
                torch.cuda.synchronize()
                print(f"prefill[b={b}] wall "
                      f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
        self.details["profile"] = self.profile_decode(self.gpt, "profile")

    def profile_decode(self, gpt, name, **engine_kw):
        """torch.profiler over 20 decode steps of 8 live slots at 230
        cached tokens each, on `gpt`'s engine (engine_kw: e.g. the pools'
        type): wall per step, device busy share, device time by kernel."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        import numpy as np
        from paddle_tpu_torch.serving import GenerationEngine
        # the decode step of 8 live slots at ~230 cached tokens each,
        # called on this thread (the profiler sees this thread's launches)
        eng = GenerationEngine(gpt, device="cuda", name=name,
                               max_slots=8, page_size=16, num_pages=8 * 20 + 1,
                               prefill_buckets=(256,), max_new_tokens=64,
                               request_timeout_ms=0, **engine_kw)
        eng.shutdown()
        M, PP = 8, eng._cfg.pages_per_seq
        pt = np.zeros((M, PP), np.int32)
        for i in range(M):
            pt[i] = eng._cache.alloc(1000 + i, 300)
        args = (pt, np.arange(M, dtype=np.int64), np.full((M,), 230, np.int32),
                np.ones((M,), bool), np.ones((M,), np.float32),
                np.zeros((M,), bool))
        steps = 20
        with torch.inference_mode():
            for _ in range(3):
                eng._decode_call(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    eng._decode_call(*args)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for _ in range(steps):
                eng._decode_call(*args)
            torch.cuda.synchronize()
            bare_ms = (time.perf_counter() - t0) * 1e3
        dev, top = _device_table(torch, prof, steps, bare_ms)
        print(f"decode step ({name}), 8 live slots at 230 cached tokens on "
              f"{self.smi}: wall {bare_ms / steps:.3f} ms/step unprofiled, "
              f"{wall_ms / steps:.3f} ms/step profiled; device busy "
              f"{dev:.3f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% "
              f"of the unprofiled wall")
        return dict(steps=steps, wall_ms_per_step=bare_ms / steps,
                    device_ms_per_step=dev, top=top[:12])

    # -- 6. train ----------------------------------------------------------------

    def train(self):
        """GPT-2 small trained through hapi.Model.fit in fp32, then the
        step-parity check; then the same fit under amp_configs="O1" and
        the AMP step parities in bf16 and fp16 (see the module
        docstring)."""
        self.gpt = None   # the serving model's memory back to the pool
        self.torch.cuda.empty_cache()
        self.fit_gpt(None)
        self.step_parity()
        self.fit_gpt("O1")
        self.train_fp16()
        self.amp_step_parity("bfloat16")
        self.amp_step_parity("float16")

    def _gpt_train_setup(self):
        """GPT-2 small (dropout 0.1, seed 0) on the card, the train data
        (64 motifs of 3-8 ids out of 4096, each sequence one motif
        repeated, so the loss must fall; [B * steps, S + 1] int64) and
        AdamW under LinearWarmup with the global-norm clip."""
        import numpy as np
        from paddle_tpu_torch import nn, optimizer
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
        cfg = GPTConfig()
        assert cfg.dropout == DROPOUT
        frandom.seed(0)
        net = GPTForCausalLM(cfg, device="cuda", seed=0)
        rng = np.random.RandomState(0)
        motifs = [rng.randint(0, 4096, size=rng.randint(3, 9))
                  for _ in range(64)]
        ids = np.stack([np.resize(motifs[rng.randint(64)], S + 1)
                        for _ in range(B * TRAIN_STEPS)]).astype(np.int64)
        sched = optimizer.lr.LinearWarmup(6e-4, 5, 6e-5, 6e-4)
        opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return net, ids, opt

    def fit_gpt(self, amp_level):
        """TRAIN_STEPS steps of GPT-2 small (dropout 0.1) through
        hapi.Model.fit, in fp32 (`amp_level` None, the path "train") or
        under `amp_configs=amp_level` (bf16, the path "train_amp"): the
        loss is finite and falls, K2-K4 launch 12 times a step, all in
        the path's type."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn
        from paddle_tpu_torch.framework import monitor
        B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
        steps = TRAIN_STEPS
        path = "train" if amp_level is None else "train_amp"
        dtype = "float32" if amp_level is None else "bfloat16"
        net, ids, opt = self._gpt_train_setup()
        cfg = net.gpt.config
        data = io.TensorDataset([ids[:, :-1], ids[:, 1:]])
        model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss(),
                                        amp_configs=amp_level)

        class Steps(hapi.callbacks.Callback):
            """Loss handles and a CUDA event at every step's end: the
            device timeline of the steps, with no host wait in the loop."""
            def __init__(self):
                super().__init__()
                self.losses, self.events = [], []

            def on_train_batch_end(self, step, logs=None):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.losses.append(logs["loss"])

        rec = Steps()
        log_freq = 10
        syncs0 = monitor.stat_get("STAT_train_host_syncs")
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit(data, batch_size=B, epochs=1, shuffle=True,
                  log_freq=log_freq, verbose=0, num_iters=steps,
                  callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path(path)
        by_dtype = self.path_dtype_launches[path]
        syncs = monitor.stat_get("STAT_train_host_syncs") - syncs0
        losses = [float(x) for x in rec.losses]
        step_ms = [a.elapsed_time(b) for a, b in zip(rec.events,
                                                     rec.events[1:])]
        steady = sorted(step_ms[1:])   # the steps after the first two
        p50 = steady[len(steady) // 2]
        label = "fp32" if amp_level is None else f"AMP {amp_level} bf16"
        print(f"{path} on {self.smi}: GPT-2 small {label} dropout "
              f"{DROPOUT}, batch {B} x {S}, {steps} steps in {wall:.2f} s "
              f"wall (first step included)")
        print("per-step loss: " + " ".join(f"{x:.4f}" for x in losses))
        print(f"loss first {losses[0]:.4f} last {losses[-1]:.4f}; step wall "
              f"p50 {p50:.2f} ms (device timeline, steps 3-{steps}), "
              f"{B * S / p50 * 1e3:.0f} tokens/s; host syncs {syncs}; "
              f"launches fwd {launches['flash_fwd']} dq "
              f"{launches['flash_bwd_dq']} dkv {launches['flash_bwd_dkv']}; "
              f"by type {by_dtype['flash_fwd']}")
        self.details[path] = dict(
            losses=losses, step_ms=step_ms, step_ms_p50=p50,
            tokens_per_s=B * S / p50 * 1e3, wall_s=wall, host_syncs=syncs,
            launches=launches, launches_by_dtype=by_dtype)
        assert all(np.isfinite(losses)), "non-finite training loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, "the loss did not fall"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == cfg.num_layers * steps, \
                f"{name} launched {launches[name]} times, expected " \
                f"{cfg.num_layers} x {steps}"
            assert by_dtype[name] == {dtype: cfg.num_layers * steps}, \
                f"{name} launched {by_dtype[name]}, all {dtype} expected"
        assert launches["paged_attention"] == 0
        assert syncs <= -(-steps // log_freq) + 1, f"{syncs} host syncs"
        if self.args.profile:
            self.profile_train_step(model, [ids[:B, :-1]], [ids[:B, 1:]],
                                    path)
        del model, net, opt
        torch.cuda.empty_cache()

    def step_parity(self):
        """One train_batch (update=False: gradients kept) through the
        flash kernels against one through FLAGS_use_flash_attention=False
        from the same weights, dropout 0, [2, 1024], fp32. Tolerances:
        loss rtol 1e-5; each parameter's gradient max abs difference
        <= 1e-3 x its largest |gradient| + 1e-6 x the largest |gradient|
        of the model (summation order only; the floor is for the key
        biases, whose exact gradient is 0 — a key bias shifts every score
        of a row alike — so what both paths give there is rounding)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        net = GPTForCausalLM(GPTConfig(dropout=0.0), device="cuda", seed=0)
        opt = optimizer.AdamW(1e-4)
        model = hapi.Model(net).prepare(opt, nn.CrossEntropyLoss())
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))

        def one():
            self.zero_launches()
            (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]],
                                         update=False)
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            opt.clear_grad()
            return float(lv), grads, self.read_launches()

        lf, gf, nf = one()
        set_flags({"FLAGS_use_flash_attention": False})
        try:
            lp, gp, np_ = one()
        finally:
            set_flags({"FLAGS_use_flash_attention": True})
        floor = 1e-6 * max(g.abs().max().item() for g in gp.values())
        worst = max(((gf[n] - gp[n]).abs().max().item()
                     / (1e-3 * gp[n].abs().max().item() + floor), n)
                    for n in gp)
        print(f"step parity [2,1024] dropout 0: loss flash {lf:.6f} plain "
              f"{lp:.6f}; worst gradient max_abs_err / its tolerance "
              f"{worst[0]:.3e} ({worst[1]}); launches flash "
              f"{nf['flash_fwd']}/{nf['flash_bwd_dq']}/"
              f"{nf['flash_bwd_dkv']}, plain {np_['flash_fwd']}/"
              f"{np_['flash_bwd_dq']}/{np_['flash_bwd_dkv']}")
        self.details["step_parity"] = dict(loss_flash=lf, loss_plain=lp,
                                           worst_grad_over_tol=worst[0],
                                           worst_param=worst[1])
        assert abs(lf - lp) <= 1e-5 * abs(lp), "step-parity loss differs"
        assert worst[0] <= 1.0, f"step-parity gradient {worst[1]} differs"
        L = net.gpt.config.num_layers
        assert (nf["flash_fwd"], nf["flash_bwd_dq"], nf["flash_bwd_dkv"]) \
            == (L, L, L), nf
        assert (np_["flash_fwd"], np_["flash_bwd_dq"],
                np_["flash_bwd_dkv"]) == (0, 0, 0), np_

    def train_fp16(self):
        """GPT-2 small trained TRAIN_STEPS steps in float16 AMP (the path
        "train_fp16"): hapi's AMP is bfloat16, as the JAX package's, so
        the loop is written out: forward and loss under
        amp.auto_cast(dtype="float16"), GradScaler scale / step inside
        the block (C9), the LR stepped each step; _gpt_train_setup's
        model, data and optimizer, batches in order. The loss is finite
        and falls, K2-K4 launch 12 times a step, all in fp16; steps the
        scaler skips on a non-finite gradient are counted."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, nn
        B, steps = TRAIN_SHAPE["B"], TRAIN_STEPS
        net, ids, opt = self._gpt_train_setup()
        opt._set_parameters(net.named_parameters())
        L = net.gpt.config.num_layers
        loss_fn = nn.CrossEntropyLoss()
        scaler = amp.GradScaler()
        batches = torch.from_numpy(ids).cuda().split(B)
        net.train()
        losses, events, skipped = [], [], 0
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        for xy in batches:
            with amp.auto_cast(dtype="float16"):
                lv = loss_fn(net(xy[:, :-1]), xy[:, 1:]).float().mean()
                scaler.scale(lv).backward()
                n = opt._global_step
                scaler.step(opt)
                skipped += opt._global_step == n
            opt.clear_grad()
            opt._lr.step()
            losses.append(lv.detach())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("train_fp16")
        by_dtype = self.path_dtype_launches["train_fp16"]
        losses = [float(x) for x in losses]
        step_ms = sorted(a.elapsed_time(b) for a, b in zip(events[1:],
                                                            events[2:]))
        p50 = step_ms[len(step_ms) // 2]
        print(f"train_fp16 on {self.smi}: GPT-2 small AMP float16 dropout "
              f"{DROPOUT}, batch {B} x {TRAIN_SHAPE['S']}, {steps} steps "
              f"in {wall:.2f} s wall; loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; step wall p50 {p50:.2f} ms (device "
              f"timeline, steps 3-{steps}); scale {scaler.get_scale():g}, "
              f"{skipped} steps skipped; launches by type "
              f"{by_dtype['flash_fwd']}")
        print("per-step loss: " + " ".join(f"{x:.4f}" for x in losses))
        self.details["train_fp16"] = dict(
            losses=losses, step_ms_p50=p50, wall_s=wall, skipped=skipped,
            scale=scaler.get_scale(), launches_by_dtype=by_dtype)
        assert all(np.isfinite(losses)), "non-finite fp16 training loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, \
            "the fp16 loss did not fall"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == L * steps, (name, launches[name])
            assert by_dtype[name] == {"float16": L * steps}, by_dtype[name]
        del net, opt
        torch.cuda.empty_cache()

    def amp_step_parity(self, dtype):
        """One AMP step of GPT-2 small at [2, 1024], dropout 0, through
        K2-K4 against one with FLAGS_use_flash_attention=False under the
        same AMP, from the same weights. bfloat16: hapi's train_batch
        (update=False) under amp_configs="O1". float16: hapi's AMP is
        bfloat16, as the JAX package's, so the step is written out:
        forward and loss under amp.auto_cast(dtype="float16"),
        GradScaler.scale(loss).backward() and GradScaler.unscale_ (no
        gradient may overflow). Both paths round at other places in the
        16-bit type (the kernels keep S and P's sums in fp32, the plain
        path rounds S, P and O), so the limits are the type's: loss rtol
        AMP_LOSS_RTOL; each parameter's gradient within AMP_GRAD_SHARE x
        its largest |gradient| + AMP_GRAD_FLOOR x the model's largest (the
        floor is for the key biases, whose exact gradient is 0)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        net = GPTForCausalLM(GPTConfig(dropout=0.0), device="cuda", seed=0)
        opt = optimizer.AdamW(1e-4)
        loss_fn = nn.CrossEntropyLoss()
        model = hapi.Model(net).prepare(opt, loss_fn, amp_configs="O1")
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))
        x, y = ids[:, :-1].cuda(), ids[:, 1:].cuda()
        scaler = amp.GradScaler()

        def one():
            self.zero_launches()
            if dtype == "bfloat16":
                (lv,), _ = model.train_batch([x], [y], update=False)
            else:
                net.train()
                with amp.auto_cast(dtype="float16"):
                    lv = loss_fn(net(x), y).float().mean()
                    scaler.scale(lv).backward()
                    scaler.unscale_(opt)
                assert not scaler._found_inf, "fp16 gradients overflowed"
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            opt.clear_grad()
            return float(lv.detach()), grads, self.read_launches_by_dtype()

        lf, gf, nf = one()
        set_flags({"FLAGS_use_flash_attention": False})
        try:
            lp, gp, np_ = one()
        finally:
            set_flags({"FLAGS_use_flash_attention": True})
        worst = _grad_worst(gf, gp, AMP_GRAD_SHARE[dtype], AMP_GRAD_FLOOR)
        kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        print(f"AMP {dtype} step parity [2,1024] dropout 0: loss flash "
              f"{lf:.6f} plain {lp:.6f} (rtol {AMP_LOSS_RTOL[dtype]}); "
              f"worst gradient max_abs_err / its tolerance {worst[0]:.3e} "
              f"({worst[1]}); launches by type flash "
              f"{[nf[k] for k in kernels]}, plain {[np_[k] for k in kernels]}")
        self.details[f"amp_step_parity_{dtype}"] = dict(
            loss_flash=lf, loss_plain=lp, worst_grad_over_tol=worst[0],
            worst_param=worst[1], launches=nf)
        assert abs(lf - lp) <= AMP_LOSS_RTOL[dtype] * abs(lp), \
            f"AMP {dtype} step-parity loss differs"
        assert worst[0] <= 1.0, \
            f"AMP {dtype} step-parity gradient {worst[1]} differs"
        L = net.gpt.config.num_layers
        assert all(nf[k] == {dtype: L} for k in kernels), nf
        assert all(np_[k] == {} for k in kernels), np_
        del model, net, opt
        torch.cuda.empty_cache()

    def profile_train_step(self, model, x, y, path):
        """torch.profiler over 3 train steps of `model` on inputs `x` and
        labels `y`: wall per step, device busy share, device time by
        kernel, and the flash kernels' and the GEMMs' shares (GEMM:
        cuBLAS/CUTLASS kernel names, _GEMM)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        model.train_batch(x, y)
        torch.cuda.synchronize()
        steps = 3
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch(x, y)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.train_batch(x, y)
            torch.cuda.synchronize()
        dev, top = _device_table(torch, prof, steps, bare_ms)
        import re
        flash = sum(ms for key, ms, _ in top if "flash_" in key)
        gemm = sum(ms for key, ms, _ in top if re.search(_GEMM, key))
        print(f"{path} step, batch {' x '.join(map(str, x[0].shape))}: "
              f"wall {bare_ms / steps:.2f} ms/step unprofiled; device busy "
              f"{dev:.2f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% of "
              f"it; flash kernels {flash:.2f} ms/step = "
              f"{flash / dev * 100:.1f}%, GEMMs {gemm:.2f} ms/step = "
              f"{gemm / dev * 100:.1f}% of the device time")
        self.details[f"profile_{path}"] = dict(
            steps=steps, wall_ms_per_step=bare_ms / steps,
            device_ms_per_step=dev, flash_ms_per_step=flash,
            gemm_ms_per_step=gemm, top=top[:12],
            kernels_per_step=sum(calls for _, _, calls in top))

    # -- 7. packing ---------------------------------------------------------------

    def packing(self):
        """The bench's packed LM trained through hapi.Model.fit, packed and
        padded; then the loss parity and the splash-vs-dense step parity
        (see the module docstring)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn, optimizer
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.static import InputSpec
        T, DIM, HEADS, VOCAB, BS = (PACK[k] for k in
                                    ("T", "DIM", "HEADS", "VOCAB", "BS"))
        torch.cuda.empty_cache()
        lengths = _bench_lengths(np)
        seqs = _motif_seqs(np, lengths)
        rows = io.suggest_rows(lengths, BS, T, headroom=PACK["HEADROOM"])

        class SeqData(io.Dataset):
            def __init__(self, items):
                self.items = items

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return self.items[i]

        class PackedLM(torch.nn.Module):
            """bench.py:2365-2387: embedding + position embedding, one
            causal-within-segment attention block, LM head; the port's nn
            layers, so AMP casts its projections."""

            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(VOCAB, DIM)
                self.pos = nn.Embedding(T, DIM)
                self.qkv = nn.Linear(DIM, 3 * DIM)
                self.proj = nn.Linear(DIM, DIM)
                self.head = nn.Linear(DIM, VOCAB)

            def forward(self, toks, seg, pos):
                x = self.emb(toks) + self.pos(pos)
                B, S = toks.shape
                qkv = self.qkv(x).reshape(B, S, 3, HEADS, DIM // HEADS) \
                    .permute(2, 0, 3, 1, 4)
                o = F.scaled_dot_product_attention(
                    qkv[0], qkv[1], qkv[2], is_causal=True, segment_ids=seg)
                return self.head(x + self.proj(
                    o.transpose(1, 2).reshape(B, S, DIM)))

        def make_model(seed, amp_level=None):
            torch.manual_seed(seed)
            net = PackedLM().cuda()
            spec = [InputSpec([None, T], "int64", "toks"),
                    InputSpec([None, T], "int32", "seg"),
                    InputSpec([None, T], "int32", "pos")]
            return net, hapi.Model(
                net, inputs=spec,
                labels=[InputSpec([None, T], "int64", "labels")]).prepare(
                    optimizer.Adam(1e-3), nn.CrossEntropyLoss(),
                    amp_configs=amp_level)

        class Steps(hapi.callbacks.Callback):
            """Loss handles, the real tokens of each step's pack (the
            collator's last pack is the one just trained: the loader
            collates in this process) and a CUDA event at each step's
            end."""
            def __init__(self, coll):
                super().__init__()
                self.coll = coll
                self.losses, self.tokens, self.events = [], [], []

            def on_train_batch_end(self, step, logs=None):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.losses.append(logs["loss"])
                self.tokens.append(self.coll.last_fill_ratio
                                   * self.coll.rows * T)

        def arm(name, policy, pack_rows, batch, amp_level=None):
            coll = io.PackingCollator(T, pack_rows, policy=policy)
            loader = io.DataLoader(SeqData(seqs), batch_size=batch,
                                   shuffle=False, collate_fn=coll)
            net, model = make_model(0, amp_level)
            rec = Steps(coll)
            c0 = {c: monitor.stat_get(c) for c in (
                "STAT_packing_tokens", "STAT_packing_slots",
                "STAT_packing_dropped_seqs", "STAT_tail_pad_batches")}
            torch.cuda.synchronize()
            # the main path starts here: every launch count from 0
            self.zero_launches()
            t0 = time.perf_counter()
            model.fit(loader, epochs=1, shuffle=False, log_freq=10,
                      verbose=0, callbacks=[rec])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = self.record_path(name)
            d = {c: monitor.stat_get(c) - v for c, v in c0.items()}
            losses = [float(x) for x in rec.losses]
            steps = len(losses)
            step_ms = [a.elapsed_time(b) for a, b in zip(rec.events,
                                                         rec.events[1:])]
            p50 = sorted(step_ms)[len(step_ms) // 2]
            tokens = d["STAT_packing_tokens"]
            steady = sum(rec.tokens[1:]) / sum(step_ms) * 1e3
            r = dict(rows=pack_rows, steps=steps, wall_s=wall,
                     real_tokens=tokens, fill=tokens / d["STAT_packing_slots"],
                     dropped=d["STAT_packing_dropped_seqs"],
                     effective_tokens_per_s=tokens / wall,
                     steady_effective_tokens_per_s=steady,
                     step_ms_p50=p50, losses=losses, launches=launches)
            print(f"packing {name} on {self.smi}: [{pack_rows}, {T}] x "
                  f"{steps} steps, {tokens} real tokens, fill "
                  f"{r['fill']:.4f}, dropped {r['dropped']}; epoch wall "
                  f"{wall:.3f} s = {tokens / wall:.0f} effective tokens/s "
                  f"(steps 2-{steps} on the device timeline: {steady:.0f}); "
                  f"step wall p50 {p50:.3f} ms; launches per step K5 "
                  f"{launches['splash_fwd'] / steps:g} K6 "
                  f"{launches['splash_bwd_dq'] / steps:g} K7 "
                  f"{launches['splash_bwd_dkv'] / steps:g}")
            print(f"  loss first {losses[0]:.4f} last {losses[-1]:.4f}: "
                  + " ".join(f"{x:.3f}" for x in losses[::max(1,
                                                             steps // 16)]))
            assert all(np.isfinite(losses)), f"{name}: non-finite loss"
            assert np.mean(losses[-3:]) < losses[0] - 1.0, \
                f"{name}: the loss did not fall"
            dtype = "float32" if amp_level is None else "bfloat16"
            by_dtype = self.path_dtype_launches[name]
            r["launches_by_dtype"] = by_dtype
            for k in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
                assert launches[k] == steps, \
                    f"{name}: {k} launched {launches[k]} times in {steps} steps"
                assert by_dtype[k] == {dtype: steps}, \
                    f"{name}: {k} launched {by_dtype[k]}, all {dtype} expected"
            assert launches["flash_fwd"] == launches["paged_attention"] == 0
            assert d["STAT_tail_pad_batches"] == 0, "a batch was row-padded"
            del model, net
            torch.cuda.empty_cache()
            return r

        packed = arm("packing", "first_fit", rows, BS)
        padded = arm("padded", "pad", PACK["PAD_ROWS"], PACK["PAD_ROWS"])
        # one packed epoch under AMP O1: bf16 projections, K5-K7 in bf16
        packed_amp = arm("packing_amp", "first_fit", rows, BS, "O1")
        # the same packs under auto_cast(dtype="float16") + GradScaler
        packed_fp16 = self.packing_fp16(make_model, seqs, rows)
        print(f"packed AMP O1 / fp32 effective tokens/s: "
              f"{packed_amp['effective_tokens_per_s'] / packed['effective_tokens_per_s']:.3f} "
              f"(epoch wall)")
        gain = packed["effective_tokens_per_s"] / \
            padded["effective_tokens_per_s"]
        print(f"packed / padded effective tokens/s: {gain:.3f} (epoch wall), "
              f"{packed['steady_effective_tokens_per_s'] / padded['steady_effective_tokens_per_s']:.3f} "
              f"(device timeline); fill {packed['fill']:.4f} vs "
              f"{padded['fill']:.4f}")

        # parity (bench.py:2444-2466): the same 8 sequences packed and
        # padded, fresh identical models, token-normalised losses
        sample = seqs[:8]
        pk = io.PackingCollator(T, io.suggest_rows(
            [len(x[0]) for x in sample], 8, T, headroom=1.5))(sample)
        pd = io.PackingCollator(T, 8, policy="pad")(sample)
        assert pk[4].sum() == pd[4].sum(), "the parity pack dropped a sequence"

        def loss_of(batch):
            _, model = make_model(1)
            return float(model.eval_batch(list(batch[:3]), [batch[3]],
                                          loss_mask=batch[4])[0])
        la, lb = loss_of(pk), loss_of(pd)
        print(f"packed vs padded loss, 8 sequences: {la:.6f} vs {lb:.6f}, "
              f"|diff| {abs(la - lb):.3e} (tol 1e-3)")
        assert abs(la - lb) < 1e-3, "packed and padded losses differ"
        self.details["packing"] = dict(packed=packed, padded=padded,
                                       packed_amp=packed_amp,
                                       packed_fp16=packed_fp16, gain=gain,
                                       parity=(la, lb))
        self.splash_step_parity(make_model, seqs[:BS], rows)
        if self.args.profile:
            for amp_level in (None, "O1"):
                self.profile_packed_step(make_model, seqs[:BS], rows,
                                         amp_level)

    def packing_fp16(self, make_model, seqs, rows):
        """The packed LM trained one epoch of packs in float16 AMP (the
        path "packing_fp16"): hapi's AMP is bfloat16, as the JAX
        package's, so the step is written out as train_fp16's is: the
        forward and the token-masked loss under
        amp.auto_cast(dtype="float16"), GradScaler scale / step inside
        the block (C9). The loss is finite and falls (the mean of the
        last 3 below the first by more than 1), K5-K7 launch once a step
        each, all counted in float16; fewer than half the steps may be
        skipped by the scaler."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, io
        coll = io.PackingCollator(PACK["T"], rows)
        BS = PACK["BS"]
        packs = [coll(seqs[i:i + BS]) for i in range(0, len(seqs), BS)]
        net, model = make_model(0)
        opt = model._optimizer
        scaler = amp.GradScaler()
        net.train()
        losses, skipped = [], 0
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        for b in packs:
            ins = model._place(list(b[:3]))
            lbs = model._place([b[3]])
            with amp.auto_cast(dtype="float16"):
                lv = model._step_loss(net(*ins), lbs, b[4])
                scaler.scale(lv).backward()
                n = opt._global_step
                scaler.step(opt)
                skipped += opt._global_step == n
            opt.clear_grad()
            losses.append(lv.detach())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("packing_fp16")
        by_dtype = self.path_dtype_launches["packing_fp16"]
        losses = [float(x) for x in losses]
        steps = len(losses)
        print(f"packing_fp16 on {self.smi}: [{rows}, {PACK['T']}] x {steps} "
              f"steps in {wall:.3f} s wall; loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; scale {scaler.get_scale():g}, {skipped} "
              f"steps skipped; K5-K7 launches by type "
              f"{by_dtype['splash_fwd']}/{by_dtype['splash_bwd_dq']}/"
              f"{by_dtype['splash_bwd_dkv']}")
        assert all(np.isfinite(losses)), "non-finite fp16 packed loss"
        assert np.mean(losses[-3:]) < losses[0] - 1.0, \
            "the fp16 packed loss did not fall"
        assert skipped < steps // 2, f"{skipped} of {steps} steps skipped"
        for k in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
            assert launches[k] == steps, (k, launches[k], steps)
            assert by_dtype[k] == {"float16": steps}, (k, by_dtype[k])
        del model, net
        torch.cuda.empty_cache()
        return dict(steps=steps, wall_s=wall, losses=losses,
                    skipped=skipped, scale=scaler.get_scale(),
                    launches_by_dtype=by_dtype)

    def profile_packed_step(self, make_model, sample, rows, amp_level):
        """torch.profiler over 5 packed train steps (collate included, as
        fit runs it; fp32, or under amp_configs=`amp_level`): wall per
        step, device busy share, device time by kernel, and the splash
        kernels' share."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from paddle_tpu_torch import io
        coll = io.PackingCollator(PACK["T"], rows)
        _, model = make_model(3, amp_level)

        def step():
            b = coll(sample)
            model.train_batch(list(b[:3]), [b[3]], loss_mask=b[4])
        step()
        torch.cuda.synchronize()
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        dev, top = _device_table(torch, prof, steps, bare_ms)
        splash = sum(ms for key, ms, _ in top if "splash_" in key)
        label = "fp32" if amp_level is None else f"AMP {amp_level}"
        print(f"packed train step {label} [{rows}, {PACK['T']}]: wall "
              f"{bare_ms / steps:.2f} ms/step unprofiled; device busy "
              f"{dev:.2f} ms/step = {dev / (bare_ms / steps) * 100:.1f}% of "
              f"it; splash kernels {splash:.3f} ms/step = "
              f"{splash / dev * 100:.1f}% of the device time")
        self.details[f"profile_packed_{label}"] = dict(
            steps=steps, wall_ms_per_step=bare_ms / steps,
            device_ms_per_step=dev, splash_ms_per_step=splash, top=top[:12])

    def splash_step_parity(self, make_model, sample, rows):
        """One train_batch (update=False) on a pack through K5-K7 against
        one with FLAGS_use_splash_attention off (the dense segment-masked
        attention), same weights, with step_parity's rule: loss rtol 1e-5
        and each gradient within 1e-3 x its max + 1e-6 x the model's
        max."""
        from paddle_tpu_torch import io
        from paddle_tpu_torch.framework.flags import set_flags
        pack = io.PackingCollator(PACK["T"], rows)(sample)
        net, model = make_model(2)

        def one():
            self.zero_launches()
            (lv,), _ = model.train_batch(list(pack[:3]), [pack[3]],
                                         update=False, loss_mask=pack[4])
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            model._optimizer.clear_grad()
            return float(lv), grads, self.read_launches()

        ls, gs, ns = one()
        set_flags({"FLAGS_use_splash_attention": False})
        try:
            ld, gd, nd = one()
        finally:
            set_flags({"FLAGS_use_splash_attention": True})
        floor = 1e-6 * max(g.abs().max().item() for g in gd.values())
        worst = max(((gs[n] - gd[n]).abs().max().item()
                     / (1e-3 * gd[n].abs().max().item() + floor), n)
                    for n in gd)
        print(f"splash step parity [{rows}, {PACK['T']}]: loss splash "
              f"{ls:.6f} dense {ld:.6f}; worst gradient max_abs_err / its "
              f"tolerance {worst[0]:.3e} ({worst[1]}); launches splash "
              f"{ns['splash_fwd']}/{ns['splash_bwd_dq']}/"
              f"{ns['splash_bwd_dkv']}, dense {nd['splash_fwd']}/"
              f"{nd['splash_bwd_dq']}/{nd['splash_bwd_dkv']}")
        self.details["splash_step_parity"] = dict(
            loss_splash=ls, loss_dense=ld, worst_grad_over_tol=worst[0],
            worst_param=worst[1])
        assert abs(ls - ld) <= 1e-5 * abs(ld), "step-parity loss differs"
        assert worst[0] <= 1.0, f"step-parity gradient {worst[1]} differs"
        assert (ns["splash_fwd"], ns["splash_bwd_dq"],
                ns["splash_bwd_dkv"]) == (1, 1, 1), ns
        assert (nd["splash_fwd"], nd["splash_bwd_dq"],
                nd["splash_bwd_dkv"]) == (0, 0, 0), nd

    # -- 8. ernie -----------------------------------------------------------------

    def ernie(self):
        """ERNIE-base fine-tuned through hapi.Model (a), long padded
        batches through the flash kernels in fp32 and bf16 (b), the
        kernel-vs-plain step parities (c), BERT-large (d), then (a)'s
        step at each flash minimum (see the module docstring)."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        net, x, y = self.ernie_headline()
        self.ernie_long(None)
        self.ernie_long("O1")
        for head in ("cls", "pretrain"):
            self.ernie_step_parity(head, "float32")
            self.ernie_step_parity(head, "bfloat16")
        self.bert_large()
        self.ernie_min_seq(net, x, y)

    def _step_recorder(self):
        """A callback keeping each step's loss handle, a CUDA event at each
        step's end (the device timeline, no host wait) and the epoch's
        last logs."""
        torch = self.torch
        from paddle_tpu_torch import hapi

        class Steps(hapi.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.losses, self.events, self.epoch_logs = [], [], {}

            def on_train_batch_end(self, step, logs=None):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.losses.append(logs["loss"])

            def on_epoch_end(self, epoch, logs=None):
                self.epoch_logs = dict(logs)
        return Steps()

    @staticmethod
    def _step_times(rec):
        """Steps 3 on (the first two warm up): their count, the window's
        ms on the device timeline from step 2's end to the last step's
        end (stalls included), and the p50 of the per-step gaps."""
        gaps = sorted(a.elapsed_time(b) for a, b in zip(rec.events[1:],
                                                        rec.events[2:]))
        window = rec.events[1].elapsed_time(rec.events[-1])
        return len(gaps), window, gaps[len(gaps) // 2], gaps

    def ernie_headline(self):
        """(a) ERNIE-base (seed 0), ErnieForSequenceClassification(2),
        AdamW 5e-5, CrossEntropyLoss, metric.Accuracy, amp_configs="O1",
        batch 32 x seq 128 (no padding, as bench.py feeds it), 40 fit steps
        over the seeded learnable set, no shuffle. Gates: the loss is
        finite and the mean of its last 3 steps is below the mean of its
        first 3; the fit's `acc` equals Accuracy recomputed from the
        logits its steps produced (a forward hook); `evaluate`'s `acc`
        equals Accuracy over `predict`'s logits of the same data in eval
        mode; K2-K4 launch 0 times (seq 128 is below the flash minimum,
        512, in the port as in the JAX package). Returns (net, x, y) for
        ernie_min_seq."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, metric, nn, optimizer
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        B, S, steps = (ERNIE_A[k] for k in ("B", "S", "STEPS"))
        cfg = ErnieConfig.base()
        frandom.seed(0)
        net = ErnieForSequenceClassification(cfg, num_classes=2,
                                             device="cuda", seed=0)
        nparams = sum(p.numel() for p in net.parameters())
        print(f"ERNIE-base: vocab {cfg.vocab_size} hidden "
              f"{cfg.hidden_size} layers {cfg.num_hidden_layers} heads "
              f"{cfg.num_attention_heads} ffn {cfg.intermediate_size} "
              f"positions {cfg.max_position_embeddings}: {nparams} "
              f"parameters fp32 (classifier head included)")
        ids, labels, _ = _ernie_cls_set(np, B * steps, S, cfg.vocab_size, B,
                                        seed=0)
        data = io.TensorDataset([ids, labels])
        model = hapi.Model(net).prepare(
            optimizer.AdamW(ERNIE_A["LR"]), nn.CrossEntropyLoss(),
            metric.Accuracy(), amp_configs="O1")
        seen = []
        hook = net.register_forward_hook(
            lambda m, i, o: seen.append(o.detach()) if m.training else None)
        rec = self._step_recorder()
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit(data, batch_size=B, epochs=1, shuffle=False, log_freq=10,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("ernie_headline")
        hook.remove()
        losses = [float(v) for v in rec.losses]
        n, window, p50, gaps = self._step_times(rec)
        fit_acc = rec.epoch_logs["acc"]
        check = metric.Accuracy()
        for out, lab in zip(seen, np.split(labels, steps)):
            check.update(check.compute(out, lab))
        recomputed = check.accumulate()
        ev = model.evaluate(data, batch_size=B, verbose=0)
        logits = model.predict(data, batch_size=B, stack_outputs=True)
        pacc = metric.Accuracy()
        pacc.update(pacc.compute(logits, labels))
        # bench.py:220-227's statistic: every sample of the measured
        # steps over the window's time
        sps = B * n / window * 1e3
        print(f"{ERNIE_METRIC}: {sps:.2f} samples/s on {self.smi} "
              f"(hapi.Model.fit with Accuracy, AMP O1 bf16; {B} x {n} "
              f"samples of steps 3-{steps} over their {window:.2f} ms on "
              f"the device timeline; step p50 {p50:.2f} ms; {steps} steps "
              f"in {wall:.2f} s wall, first step included)")
        print("per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        print(f"fit acc {fit_acc:.4f}, recomputed from the steps' logits "
              f"{recomputed:.4f}; evaluate loss {ev['loss']:.4f} acc "
              f"{ev['acc']:.4f}, Accuracy over predict's logits "
              f"{pacc.accumulate():.4f}; launches {launches}")
        self.details["ernie_headline"] = dict(
            metric=ERNIE_METRIC, samples_per_s=sps, window_ms=window,
            measured_steps=n, step_ms_p50=p50, step_ms=gaps, wall_s=wall, losses=losses, fit_acc=float(fit_acc),
            recomputed_acc=float(recomputed),
            evaluate={k: float(v) for k, v in ev.items()},
            predict_acc=float(pacc.accumulate()), launches=launches)
        assert all(np.isfinite(losses)), "non-finite ERNIE loss"
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            "the ERNIE loss did not fall"
        assert len(seen) == steps and fit_acc == recomputed, \
            "fit's acc is not Accuracy over its steps' logits"
        assert ev["acc"] == pacc.accumulate(), \
            "evaluate's acc is not Accuracy over predict's logits"
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == 0, (name, launches[name])
        return net, [ids[:B]], [labels[:B]]

    def ernie_long(self, amp_level):
        """(b) ERNIE-base (dropout 0.1, seed 0) at batch 8 x seq 512, the
        `attention_mask` of seeded lengths 128-512, 12 fit steps (AdamW
        1e-4, no shuffle) in fp32 (`amp_level` None, the path
        "ernie_long") or under amp_configs="O1" (bf16, "ernie_long_amp").
        Gates: the loss is finite and falls (mean of the last 3 steps
        below the mean of the first 3); K2, K3 and K4 launch 12 times a
        step, all in the path's type. Printed: real tokens/s over steps
        3 on (padding not counted), the fill and the step p50."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn, optimizer
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        from paddle_tpu_torch.static import InputSpec
        B, S, steps = (ERNIE_LONG[k] for k in ("B", "S", "STEPS"))
        path = "ernie_long" if amp_level is None else "ernie_long_amp"
        dtype = "float32" if amp_level is None else "bfloat16"
        cfg = ErnieConfig.base()
        frandom.seed(1)
        net = ErnieForSequenceClassification(cfg, device="cuda", seed=0)
        lens = _ernie_lengths(np, B * steps, S, seed=1)
        ids, labels, mask = _ernie_cls_set(np, B * steps, S, cfg.vocab_size,
                                           B, seed=1, lengths=lens)
        rows = [ids, np.zeros_like(ids), np.tile(np.arange(S), (len(ids), 1)),
                mask, labels]
        specs = [InputSpec([None, S], "int64", n) for n in
                 ("input_ids", "token_type_ids", "position_ids")] + [
            InputSpec([None, S], "float32", "attention_mask")]
        model = hapi.Model(net, inputs=specs).prepare(
            optimizer.AdamW(ERNIE_LONG["LR"]), nn.CrossEntropyLoss(),
            amp_configs=amp_level)
        rec = self._step_recorder()
        torch.cuda.synchronize()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit(io.TensorDataset(rows), batch_size=B, epochs=1,
                  shuffle=False, log_freq=10, verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path(path)
        by_dtype = self.path_dtype_launches[path]
        losses = [float(v) for v in rec.losses]
        n, window, p50, gaps = self._step_times(rec)
        real = float(mask.sum()) / steps
        # real tokens of the measured steps over the window's time
        tps = float(mask[-n * B:].sum()) / window * 1e3
        label = "fp32" if amp_level is None else "AMP O1 bf16"
        print(f"{path} on {self.smi}: ERNIE-base {label} dropout "
              f"{cfg.hidden_dropout_prob}, batch {B} x {S}, lengths "
              f"{ERNIE_LONG['MIN_LEN']}-{S} (fill {real / (B * S):.3f}), "
              f"{steps} steps in {wall:.2f} s wall; {tps:.0f} real "
              f"tokens/s (steps 3-{steps} over their {window:.2f} ms on the "
              f"device timeline); step p50 {p50:.2f} ms; launches "
              f"{launches}; by type "
              f"{by_dtype['flash_fwd']}")
        print("per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        self.details[path] = dict(
            losses=losses, step_ms_p50=p50, step_ms=gaps, wall_s=wall,
            window_ms=window, measured_steps=n,
            real_tokens_per_step=real, real_tokens_per_s=tps,
            fill=real / (B * S), launches=launches,
            launches_by_dtype=by_dtype)
        assert all(np.isfinite(losses)), f"non-finite {path} loss"
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            f"the {path} loss did not fall"
        L = cfg.num_hidden_layers
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == L * steps, (name, launches[name])
            assert by_dtype[name] == {dtype: L * steps}, \
                f"{name} launched {by_dtype[name]}, all {dtype} expected"
        del model, net
        torch.cuda.empty_cache()

    def ernie_step_parity(self, head, dtype):
        """(c) One train_batch (update=False) of ERNIE-base, dropout 0, at
        [2, 512] with a padding mask (lengths 512 and 300) through K2-K4
        against one with FLAGS_use_flash_attention=False, from the same
        weights: the classifier ("cls", CrossEntropyLoss) or
        ErnieForPretraining ("pretrain": MLM cross entropy over 15 % of
        the real tokens + NSP cross entropy). float32: phase 6's limits
        (loss rtol 1e-5; each gradient within 1e-3 x its max + 1e-6 x the
        model's max); bfloat16 under amp_configs="O1": each gradient
        within phase 6's AMP limits (AMP_GRAD_SHARE, AMP_GRAD_FLOOR), the
        loss within ERNIE_AMP_LOSS_TOL (see there). The kernel step
        launches K2-K4 12 times each, all in `dtype`; the plain one
        none. Both rows carry one label (class 0, and NSP 0): the two
        rows' pooled outputs of a random ERNIE-base agree to cosine
        0.996, so with two labels a head's gradient would be a difference
        of two nearly equal rows, and its relative error in bf16 that of
        the difference, not of the paths.
        For the record only (no gate): in float32 both paths against the
        plain step in float64 (its loss is reduced in fp32), under the
        fp32 limits; in bfloat16 both paths against the fp32 step through
        the kernels, and each pair under phase 6's AMP limits, on this
        input and, for "cls", on labels 0 and 1."""
        torch = self.torch
        import copy
        import numpy as np
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                             ErnieForSequenceClassification)
        B, S = ERNIE_PARITY["B"], ERNIE_PARITY["S"]
        cfg = ErnieConfig(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        rng = np.random.RandomState(2)
        ids = rng.randint(5, cfg.vocab_size, size=(B, S)).astype(np.int64)
        mask = np.ones((B, S), np.float32)
        mask[1, 300:] = 0
        ids[mask == 0] = 0
        x = [ids, np.zeros_like(ids), np.tile(np.arange(S), (B, 1)), mask]
        if head == "cls":
            build = ErnieForSequenceClassification
            loss = nn.CrossEntropyLoss()
            ys = {"one label": [np.array([0, 0], np.int64)],
                  "labels 0/1": [np.array([0, 1], np.int64)]}
        else:
            build = ErnieForPretraining
            ce = nn.CrossEntropyLoss()

            def loss(mlm, nsp, mlm_labels, nsp_labels):
                return ce(mlm, mlm_labels) + ce(nsp, nsp_labels)
            pick = (rng.rand(B, S) < 0.15) & (mask > 0)
            ys = {"one label": [np.where(pick, ids, -100).astype(np.int64),
                                np.array([0, 0], np.int64)]}
        net = build(cfg, device="cuda", seed=0)
        amp_level = None if dtype == "float32" else "O1"
        opt = optimizer.AdamW(1e-4)
        model = hapi.Model(net, inputs=[None] * 4).prepare(
            opt, loss, amp_configs=amp_level)

        def one(y, level=amp_level, flash=True, m=model):
            m._amp_level = level
            self.zero_launches()
            set_flags({"FLAGS_use_flash_attention": flash})
            try:
                lv, _ = m.train_batch(x, y, update=False)
            finally:
                set_flags({"FLAGS_use_flash_attention": True})
            grads = {n: p.grad.clone() for n, p in m.network.named_parameters()}
            m._optimizer.clear_grad()
            return float(lv[0]), grads, self.read_launches_by_dtype()

        if dtype == "float32":
            loss_rtol, share, floor_share = 1e-5, 1e-3, 1e-6
        else:
            loss_rtol, share, floor_share = (
                AMP_LOSS_RTOL[dtype], AMP_GRAD_SHARE[dtype], AMP_GRAD_FLOOR)

        def reading(a, b):
            """(|loss a - loss b| / (loss_rtol x |loss b|), the worst
            gradient error of a against b over its limit, that
            parameter)"""
            worst = _grad_worst(a[1], b[1], share, floor_share)
            return dict(loss_over_rtol=abs(a[0] - b[0]) / (loss_rtol
                                                           * abs(b[0])),
                        grad_over_limit=worst[0], grad_param=worst[1])

        y = ys["one label"]
        flash = one(y)
        plain = one(y, flash=False)
        (lf, gf, nf), (lp, gp, np_) = flash, plain
        record = {}
        if dtype == "float32":
            net64 = copy.deepcopy(net).double()
            m64 = hapi.Model(net64, inputs=[None] * 4).prepare(
                optimizer.AdamW(1e-4), loss)
            ref = one(y, flash=False, m=m64)
            record["one label"] = {
                f"{path} vs float64": reading(r, ref)
                for path, r in (("kernels", flash), ("plain", plain))}
            del m64, net64, ref
        else:
            for label, yy in ys.items():
                pair = (flash, plain) if yy is y else (one(yy),
                                                       one(yy, flash=False))
                ref = one(yy, level=None)
                record[label] = {
                    "kernels vs plain": reading(*pair),
                    "kernels vs fp32": reading(pair[0], ref),
                    "plain vs fp32": reading(pair[1], ref)}
                del pair, ref
        loss_tol = (1e-5 * abs(lp) if dtype == "float32"
                    else ERNIE_AMP_LOSS_TOL * max(1.0, abs(lp)))
        worst = _grad_worst(gf, gp, share, floor_share)
        kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        print(f"ERNIE-base {head} step parity [{B},{S}] padded, dropout 0, "
              f"{dtype}: loss flash {lf:.6f} plain {lp:.6f} (tol "
              f"{loss_tol:.3e}); "
              f"worst gradient max_abs_err / its tolerance {worst[0]:.3e} "
              f"({worst[1]}); launches by type flash "
              f"{[nf[k] for k in kernels]}, plain {[np_[k] for k in kernels]}")
        for label, pairs in record.items():
            for what, r in pairs.items():
                print(f"  record, {label}, {what}: loss "
                      f"{r['loss_over_rtol']:.3e} x rtol {loss_rtol}, "
                      f"worst gradient {r['grad_over_limit']:.3e} x its "
                      f"limit ({r['grad_param']})")
        self.details[f"ernie_parity_{head}_{dtype}"] = dict(
            loss_flash=lf, loss_plain=lp, worst_grad_over_tol=worst[0],
            worst_param=worst[1], launches=nf, record=record)
        assert abs(lf - lp) <= loss_tol, \
            f"ERNIE {head} {dtype} step-parity loss differs"
        assert worst[0] <= 1.0, \
            f"ERNIE {head} {dtype} step-parity gradient {worst[1]} differs"
        L = cfg.num_hidden_layers
        assert all(nf[k] == {dtype: L} for k in kernels), nf
        assert all(np_[k] == {} for k in kernels), np_
        del model, net, opt, flash, plain, gf, gp
        torch.cuda.empty_cache()

    def bert_large(self):
        """(d) BertForSequenceClassification(BertConfig.large()): 24
        layers, 16 heads of 64, seed 0, one train_batch under
        amp_configs="O1" at [8, 512] with a padding mask (lengths
        128-512). Gates: the loss is finite; K2, K3 and K4 launch 24
        times each, all in bf16."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.models import (BertConfig,
                                             BertForSequenceClassification)
        B, S = ERNIE_LONG["B"], ERNIE_LONG["S"]
        cfg = BertConfig.large()
        net = BertForSequenceClassification(cfg, device="cuda", seed=0)
        ids, labels, mask = _ernie_cls_set(
            np, B, S, cfg.vocab_size, B, seed=3,
            lengths=_ernie_lengths(np, B, S, seed=3))
        x = [ids, np.zeros_like(ids), np.tile(np.arange(S), (B, 1)), mask]
        model = hapi.Model(net, inputs=[None] * 4).prepare(
            optimizer.AdamW(1e-4), nn.CrossEntropyLoss(), amp_configs="O1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        (lv,), _ = model.train_batch(x, [labels])
        loss = float(lv)
        wall = time.perf_counter() - t0
        launches = self.record_path("bert_large")
        by_dtype = self.path_dtype_launches["bert_large"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        nparams = sum(p.numel() for p in net.parameters())
        print(f"BERT-large on {self.smi}: {nparams} parameters, one AMP O1 "
              f"bf16 train_batch at [{B},{S}] (fill {mask.mean():.3f}): "
              f"loss {loss:.4f}, {wall:.2f} s wall (first step: AdamW "
              f"state and allocations included), peak allocated "
              f"{peak:.2f} GB over the step; launches by type "
              f"{by_dtype['flash_fwd']} / {by_dtype['flash_bwd_dq']} / "
              f"{by_dtype['flash_bwd_dkv']}")
        self.details["bert_large"] = dict(loss=loss, wall_s=wall,
                                          peak_gb=peak, launches=launches,
                                          launches_by_dtype=by_dtype)
        assert np.isfinite(loss), "non-finite BERT-large loss"
        L = cfg.num_hidden_layers
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert by_dtype[name] == {"bfloat16": L}, (name, by_dtype[name])
        del model, net
        torch.cuda.empty_cache()

    def ernie_min_seq(self, net, x, y):
        """(a), informational: (a)'s train step (AMP O1, batch 32 x 128,
        train_batch without metrics) at each flash minimum of
        ERNIE_MIN_SEQS, no default changed: host wall a step over 10
        steps and K2-K4 launches a step (0 at the default 512, 12 at
        128), then `profile_train_step`'s device ms, kernel table and
        GEMM share (the ERNIE step `--profile` asks for, run by
        default)."""
        torch = self.torch
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.framework.flags import get_flags, set_flags
        model = hapi.Model(net).prepare(
            optimizer.AdamW(ERNIE_A["LR"]), nn.CrossEntropyLoss(),
            amp_configs="O1")
        L = net.ernie.config.num_hidden_layers
        old = get_flags("FLAGS_flash_attention_min_seq")
        arms = {}
        try:
            for min_seq in ERNIE_MIN_SEQS:
                set_flags({"FLAGS_flash_attention_min_seq": min_seq})
                for _ in range(2):
                    model.train_batch(x, y)
                torch.cuda.synchronize()
                # the main path starts here: every launch count from 0
                self.zero_launches()
                steps = 10
                t0 = time.perf_counter()
                for _ in range(steps):
                    model.train_batch(x, y)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / steps
                path = f"ernie_min_seq_{min_seq}"
                launches = self.record_path(path)
                per = {k: launches[k] / steps for k in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                print(f"ERNIE-base (a)'s step at FLAGS_flash_attention_min_"
                      f"seq={min_seq} on {self.smi}: wall {wall:.2f} "
                      f"ms/step, {ERNIE_A['B'] / wall * 1e3:.1f} "
                      f"samples/s; K2-K4 launches a step {per}")
                self.profile_train_step(model, x, y, path)
                arms[min_seq] = dict(wall_ms=wall, launches_per_step=per)
                want = L if min_seq <= ERNIE_A["S"] else 0
                assert all(v == want for v in per.values()), per
        finally:
            set_flags(old)
        self.details["ernie_min_seq"] = arms
        del model
        torch.cuda.empty_cache()

    # -- 9. vision ------------------------------------------------------------

    def vision(self):
        """ResNet-50 in bench.py's configuration through hapi.Model (a),
        the step parities at batch 2 x 224^2 (b), one O1 step of each other
        family member (c); with --profile, (a)'s step profiled (see the
        module docstring)."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        net, model, x, y = self.resnet_headline()
        if self.args.profile:
            self.profile_vision_step(model, x, y)
        del net, model
        self.torch.cuda.empty_cache()
        self.vision_step_parity()
        self.vision_family(x, y)

    def resnet_headline(self):
        """(a) resnet50(num_classes=1000), seed 0, not cut, through
        hapi.Model: Momentum(0.1), CrossEntropyLoss, Accuracy(topk=(1, 5)),
        amp_configs="O1" (bf16), NCHW, 40 fit steps on one seeded batch of
        32 x 3 x 224 x 224 standard-normal images and labels in 0..999,
        placed on the card once and fed at every step, as bench.py:276-286
        feeds one batch. Gates: the loss is finite and the mean of its last
        3 steps below the mean of its first 3; the fit's acc_top1 and
        acc_top5 equal Accuracy over the logits its steps produced (a
        forward hook on the network); after the fit, evaluate's acc_top1
        and acc_top5 equal Accuracy over predict's logits (eval mode, the
        running buffers); every Conv2D's output is bfloat16 and every
        BatchNorm2D's float32 in the fit (forward hooks on each, a set add
        a call); K1-K7 launch 0 times (no TPU kernel lies on this path).
        Printed: images/s as bench.py's metric (the images of steps 3-40
        over their window on the device timeline), the step p50 and the
        peak allocated bytes of the fit. Returns (net, model, x, y)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, metric, nn, optimizer
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.vision.models import resnet50
        B, side, steps = (RESNET_A[k] for k in ("B", "SIDE", "STEPS"))
        frandom.seed(0)
        net = resnet50(num_classes=1000, device="cuda", seed=0)
        nparams = sum(p.numel() for p in net.parameters())
        count = {c.__name__: sum(1 for m in net.modules() if isinstance(m, c))
                 for c in (nn.Conv2D, nn.BatchNorm2D)}
        print(f"ResNet-50: {nparams} parameters fp32, {count}")
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.standard_normal(
            (B, 3, side, side)).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, size=(B,)).astype(
            np.int64)).cuda()
        model = hapi.Model(net).prepare(
            optimizer.Momentum(RESNET_A["LR"]), nn.CrossEntropyLoss(),
            metric.Accuracy(topk=(1, 5)), amp_configs="O1")
        seen, types = [], set()
        hooks = [net.register_forward_hook(
            lambda m, i, o: seen.append(o.detach()) if m.training else None)]
        for m in net.modules():
            kind = ("conv" if isinstance(m, nn.Conv2D) else "batch_norm"
                    if isinstance(m, nn.BatchNorm2D) else None)
            if kind:
                hooks.append(m.register_forward_hook(
                    lambda mod, i, o, k=kind: types.add((k, o.dtype))))
        rec = self._step_recorder()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit([[x, y]] * steps, epochs=1, log_freq=10, verbose=0,
                  callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("vision_resnet50")
        peak = torch.cuda.max_memory_allocated()
        for h in hooks:
            h.remove()
        losses = [float(v) for v in rec.losses]
        n, window, p50, gaps = self._step_times(rec)
        fit_acc = [float(rec.epoch_logs[k]) for k in ("acc_top1", "acc_top5")]
        check = metric.Accuracy(topk=(1, 5))
        for out in seen:
            check.update(check.compute(out, y))
        recomputed = [float(v) for v in check.accumulate()]
        ev = {k: float(v) for k, v in
              model.evaluate([[x, y]], verbose=0).items()}
        logits = model.predict([[x]], stack_outputs=True)
        pacc = metric.Accuracy(topk=(1, 5))
        pacc.update(pacc.compute(logits, y))
        predict_acc = [float(v) for v in pacc.accumulate()]
        # bench.py:282-287's statistic: every image of the measured steps
        # over the window's time
        ips = B * n / window * 1e3
        flops = RESNET_FLOP_PER_IMAGE * B
        print(f"{RESNET_METRIC}: {ips:.2f} images/s on {self.smi} "
              f"(hapi.Model.fit with Accuracy(topk=(1, 5)), AMP O1 bf16, "
              f"NCHW; {B} x {n} images of steps 3-{steps} over their "
              f"{window:.2f} ms on the device timeline; step p50 {p50:.2f} "
              f"ms; {steps} steps in {wall:.2f} s wall, first step "
              f"included; peak allocated {peak / 2**30:.2f} GiB; "
              f"{flops / (p50 * 1e-3) / PEAK_FLOPS['bfloat16'] * 100:.1f}% "
              f"of the bf16 dense peak at bench.py's 3 x 4.09 GFLOP an image "
              f"by the p50)")
        print("per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        print(f"fit acc_top1/top5 {fit_acc}, recomputed from the steps' "
              f"logits {recomputed}; evaluate loss {ev['loss']:.4f} "
              f"acc_top1/top5 {[ev['acc_top1'], ev['acc_top5']]}, Accuracy "
              f"over predict's logits {predict_acc}; output types "
              f"{sorted((k, str(t)) for k, t in types)}; launches "
              f"{launches}")
        self.details["vision_resnet50"] = dict(
            metric=RESNET_METRIC, images_per_s=ips, window_ms=window,
            measured_steps=n, step_ms_p50=p50, step_ms=gaps, wall_s=wall,
            peak_allocated_bytes=peak, losses=losses, fit_acc=fit_acc,
            recomputed_acc=recomputed, evaluate=ev,
            predict_acc=predict_acc, launches=launches,
            output_types=sorted((k, str(t)) for k, t in types))
        assert all(np.isfinite(losses)), "non-finite ResNet-50 loss"
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            "the ResNet-50 loss did not fall"
        assert len(seen) == steps and fit_acc == recomputed, \
            "fit's acc is not Accuracy over its steps' logits"
        assert [ev["acc_top1"], ev["acc_top5"]] == predict_acc, \
            "evaluate's acc is not Accuracy over predict's logits"
        assert types == {("conv", torch.bfloat16),
                         ("batch_norm", torch.float32)}, types
        assert all(v == 0 for v in launches.values()), launches
        return net, model, x, y

    def profile_vision_step(self, model, x, y):
        """--profile: torch.profiler over 3 of (a)'s train steps: wall and
        device ms a step, the busy share, kernels a step, the shares of the
        convolutions, of BatchNorm + elementwise kernels and of layout
        transposes (each transpose kernel named), and the share of the bf16
        dense peak at bench.py's 3 x 4.09 GFLOP an image, by device and by
        wall time."""
        torch = self.torch
        import re
        from torch.profiler import ProfilerActivity, profile
        model.train_batch([x], [y])
        torch.cuda.synchronize()
        steps = 3
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch([x], [y])
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.train_batch([x], [y])
            torch.cuda.synchronize()
        dev, rows = _device_table(torch, prof, steps, bare_ms)
        parts = {k: 0.0 for k in _VISION_KERNELS}
        parts["other"] = 0.0
        layout = []
        for key, ms, calls in rows:
            kind = next((k for k, pat in _VISION_KERNELS.items()
                         if re.search(pat, key)), "other")
            parts[kind] += ms
            if kind == "layout":
                layout.append((key[:90], ms, calls))
        wall = bare_ms / steps
        kernels = sum(c for _, _, c in rows)
        flops = RESNET_FLOP_PER_IMAGE * x.shape[0]
        print(f"ResNet-50 (a) step profiled on {self.smi}: wall {wall:.2f} "
              f"ms/step unprofiled, device {dev:.2f} ms/step = "
              f"{dev / wall * 100:.1f}% busy, {kernels:.0f} kernels/step; "
              + ", ".join(f"{k} {v:.2f} ms ({v / dev * 100:.1f}%)"
                          for k, v in parts.items())
              + f"; {flops / (dev * 1e-3) / 1e12:.1f} TFLOP/s on the device "
              f"= {flops / (dev * 1e-3) / PEAK_FLOPS['bfloat16'] * 100:.1f}%"
              f" of the bf16 dense peak "
              f"({flops / (wall * 1e-3) / PEAK_FLOPS['bfloat16'] * 100:.1f}%"
              f" by the wall)")
        for key, ms, calls in layout:
            print(f"  layout transpose: {ms:.4f} ms/step {calls:.1f} "
                  f"calls/step  {key}")
        self.details["profile_vision"] = dict(
            steps=steps, wall_ms_per_step=wall, device_ms_per_step=dev,
            kernels_per_step=kernels, parts_ms=parts, layout=layout,
            top=rows[:20])

    def vision_step_parity(self):
        """(b) One ResNet-50 train_batch (update=False) at batch 2 x 3 x 224
        x 224, every path from the same weights (seed 0; copies of one
        model): fp32 on the card against the port's same step on the CPU
        (the path the CPU tests tie to the JAX package) and against a
        float64 step on the card (the error cuDNN's algorithms bring), at
        VISION_FP32_* limits; O1 bf16 against the fp32 step at VISION_AMP_*
        limits. Each compares the loss, every gradient and the running
        buffers after the step. The limits come from a CPU rehearsal
        (PERF.md §2): a random ResNet-50's training-mode gradient is
        piecewise smooth (ReLU and max-pool gates), and fp32 rounding flips
        a few gates in layer4's 98 positions a channel, so fp32 against
        float64 already differs by 1.5 % (relative L2) a tensor, and a
        bf16 forward leaves the early layers' gradients uncorrelated with
        fp32's (cosine 0.16-0.24 in the port and in the JAX package alike);
        phase 6's max-abs limits read 130x (fp32) and 55x (AMP) there, and
        are printed for the record only. cuDNN's weight-gradient
        algorithms are not deterministic (torch.backends.cudnn.deterministic
        stays off), so no gate asks two runs for bit equality."""
        torch = self.torch
        import copy
        import numpy as np
        from paddle_tpu_torch import hapi, nn, optimizer
        from paddle_tpu_torch.vision.models import resnet50
        B, side = RESNET_PARITY["B"], RESNET_PARITY["SIDE"]
        net0 = resnet50(num_classes=1000, device="cuda", seed=0)
        rng = np.random.RandomState(1)
        x = rng.standard_normal((B, 3, side, side)).astype(np.float32)
        y = rng.randint(0, 1000, size=(B,)).astype(np.int64)

        def step(device, dtype=torch.float32, level=None):
            net = copy.deepcopy(net0).to(device=device, dtype=dtype)
            model = hapi.Model(net).prepare(
                optimizer.Momentum(0.1), nn.CrossEntropyLoss(),
                amp_configs=level)
            t0 = time.perf_counter()
            lv, _ = model.train_batch([torch.from_numpy(x).to(dtype)], [y],
                                      update=False)
            out = (float(lv[0]),
                   {n: p.grad.detach().double().cpu()
                    for n, p in net.named_parameters()},
                   {n: b.detach().double().cpu()
                    for n, b in net.named_buffers()},
                   time.perf_counter() - t0)
            del model, net
            return out

        f32 = step("cuda")
        cpu = step("cpu")
        f64 = step("cuda", torch.float64)
        bf = step("cuda", level="O1")
        del net0
        torch.cuda.empty_cache()

        def reading(a, b, amp):
            """The gated and recorded numbers of path a against path b."""
            ga, gb = a[1], b[1]
            top = max(g.norm().item() for g in gb.values())
            rel = {n: (ga[n] - gb[n]).norm().item()
                   / (gb[n].norm().item() + 1e-6 * top) for n in gb}
            cos = {n: ((ga[n] * gb[n]).sum()
                       / (ga[n].norm() * gb[n].norm() + 1e-300)).item()
                   for n in gb}
            ratio = {n: ga[n].norm().item() / max(gb[n].norm().item(),
                                                  1e-300) for n in gb}
            model_rel = (sum((ga[n] - gb[n]).norm() ** 2 for n in gb)
                         / sum(gb[n].norm() ** 2 for n in gb)).sqrt().item()
            buf = {n: (a[2][n] - b[2][n]).abs().max().item()
                   / max(b[2][n].abs().max().item(), 1e-30) for n in b[2]}
            share, floor = ((AMP_GRAD_SHARE["bfloat16"], AMP_GRAD_FLOOR)
                            if amp else (1e-3, 1e-6))
            return dict(
                loss_rel=abs(a[0] - b[0]) / abs(b[0]),
                worst_rel_l2=max((v, n) for n, v in rel.items()),
                median_rel_l2=sorted(rel.values())[len(rel) // 2],
                model_rel_l2=model_rel,
                worst_cos=min((v, n) for n, v in cos.items()),
                median_cos=sorted(cos.values())[len(cos) // 2],
                fc_cos=min(cos["fc.weight"], cos["fc.bias"]),
                norm_ratio=(min(ratio.values()), max(ratio.values())),
                worst_buffer_share=max((v, n) for n, v in buf.items()),
                phase6_max_abs=_grad_worst(ga, gb, share, floor))

        pairs = {"fp32 card vs fp32 CPU": reading(f32, cpu, False),
                 "fp32 card vs float64 card": reading(f32, f64, False),
                 "O1 bf16 card vs fp32 card": reading(bf, f32, True)}
        print(f"ResNet-50 step parity [{B}, 3, {side}, {side}] on "
              f"{self.smi}: loss fp32 {f32[0]:.6f} CPU {cpu[0]:.6f} float64 "
              f"{f64[0]:.6f} O1 {bf[0]:.6f}; step wall fp32 {f32[3]:.2f} s, "
              f"CPU {cpu[3]:.2f} s, float64 {f64[3]:.2f} s, O1 {bf[3]:.2f} s "
              f"(first steps: cuDNN's heuristics included)")
        for what, r in pairs.items():
            print(f"  {what}: loss {r['loss_rel']:.3e} rel; gradient rel L2 "
                  f"worst {r['worst_rel_l2'][0]:.3e} "
                  f"({r['worst_rel_l2'][1]}), median {r['median_rel_l2']:.3e},"
                  f" model {r['model_rel_l2']:.3e}; cosine worst "
                  f"{r['worst_cos'][0]:.4f} ({r['worst_cos'][1]}), median "
                  f"{r['median_cos']:.4f}, fc {r['fc_cos']:.6f}; norm ratio "
                  f"{r['norm_ratio'][0]:.3f}-{r['norm_ratio'][1]:.3f}; "
                  f"buffers worst {r['worst_buffer_share'][0]:.3e} of their "
                  f"max ({r['worst_buffer_share'][1]}); record, phase 6's "
                  f"max-abs limits {r['phase6_max_abs'][0]:.3e}x "
                  f"({r['phase6_max_abs'][1]})")
        self.details["vision_parity"] = dict(
            losses=dict(fp32=f32[0], cpu=cpu[0], float64=f64[0], o1=bf[0]),
            pairs=pairs)
        for what in ("fp32 card vs fp32 CPU", "fp32 card vs float64 card"):
            r = pairs[what]
            assert r["loss_rel"] <= VISION_FP32["loss_rtol"], (what, r)
            assert r["worst_rel_l2"][0] <= VISION_FP32["grad_rel_l2"], \
                (what, r["worst_rel_l2"])
            assert r["model_rel_l2"] <= VISION_FP32["model_rel_l2"], \
                (what, r["model_rel_l2"])
            assert r["worst_buffer_share"][0] <= VISION_FP32["buffer_share"], \
                (what, r["worst_buffer_share"])
        r = pairs["O1 bf16 card vs fp32 card"]
        lo, hi = VISION_AMP["norm_ratio"]
        assert r["loss_rel"] <= VISION_AMP["loss_rtol"], r["loss_rel"]
        assert r["fc_cos"] >= VISION_AMP["fc_cos"], r["fc_cos"]
        assert lo <= r["norm_ratio"][0] and r["norm_ratio"][1] <= hi, \
            r["norm_ratio"]
        assert r["worst_buffer_share"][0] <= VISION_AMP["buffer_share"], \
            r["worst_buffer_share"]

    def vision_family(self, x, y):
        """(c) One O1 train_batch each, on (a)'s batch, of mobilenet_v2
        (depthwise convs, ReLU6), resnet18, vgg16(batch_norm=True) and
        ImperativeQuantAware().quantize(resnet50) (every Conv2D a
        QuantizedConv2D and the fc a QuantizedLinear): the loss finite;
        every QuantizedConv2D of the last one ran in the step (a forward
        hook each). Printed: each step's wall (the first, cuDNN's
        heuristics included) and peak allocated bytes."""
        torch = self.torch
        import math
        from paddle_tpu_torch import hapi, nn, optimizer, quantization
        from paddle_tpu_torch.vision import models as vm
        builds = {
            "mobilenet_v2": lambda: vm.mobilenet_v2(device="cuda"),
            "resnet18": lambda: vm.resnet18(device="cuda"),
            "vgg16_bn": lambda: vm.vgg16(batch_norm=True, device="cuda"),
            "resnet50_quant_aware": lambda: quantization.ImperativeQuantAware(
            ).quantize(vm.resnet50(device="cuda"))}
        out = {}
        for name, build in builds.items():
            net = build()
            quantized = [m for m in net.modules()
                         if isinstance(m, quantization.QuantizedConv2D)]
            ran = []
            hooks = [m.register_forward_hook(lambda mod, i, o: ran.append(1))
                     for m in quantized]
            model = hapi.Model(net).prepare(
                optimizer.Momentum(RESNET_A["LR"]), nn.CrossEntropyLoss(),
                amp_configs="O1")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lv, _ = model.train_batch([x], [y])
            loss = float(lv[0])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            for h in hooks:
                h.remove()
            out[name] = dict(loss=loss, wall_s=wall, peak_bytes=peak,
                             params=sum(p.numel() for p in net.parameters()),
                             quantized_convs=len(quantized),
                             quantized_calls=len(ran))
            print(f"{name} O1 step [{x.shape[0]}, 3, {x.shape[2]}, "
                  f"{x.shape[3]}] on {self.smi}: loss {loss:.4f}, "
                  f"{out[name]['params']} parameters, first step "
                  f"{wall:.2f} s wall, peak allocated {peak / 2**30:.2f} GiB"
                  + (f", {len(ran)} QuantizedConv2D calls of "
                     f"{len(quantized)}" if quantized else ""))
            del model, net
            torch.cuda.empty_cache()
            assert math.isfinite(loss), (name, loss)
        q = out["resnet50_quant_aware"]
        assert q["quantized_convs"] == 53 == q["quantized_calls"], q
        self.details["vision_family"] = out

    # -- 9b. detect ---------------------------------------------------------------

    def detect(self):
        """YOLOv3 at DarkNet width: (a) training, (b) predict + NMS, (c)
        the narrow step parity, (d) incubate's optimizers (see the module
        docstring)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.vision.models import yolov3
        self.gpt = None
        torch.cuda.empty_cache()
        D = DETECT
        net = yolov3(num_classes=D["CLASSES"], width=D["WIDTH"],
                     device="cuda", seed=0)
        built = {k: v.clone() for k, v in net.state_dict().items()}
        batch = [torch.from_numpy(a).cuda() for a in _detect_batch(
            np, D["B"], D["SIDE"], D["CLASSES"], D["SLOTS"], D["MAX_GT"],
            seed=0)]
        self.detect_train(net, *batch)
        net.load_state_dict(built)
        self.detect_predict(net, batch[0])
        del net, built, batch
        torch.cuda.empty_cache()
        self.detect_step_parity()
        self.detect_incubate()

    def detect_train(self, net, x, gt, lab):
        """(a) `net`, yolov3(num_classes=80, width=64) built with seed 0,
        as a user trains it: its forward and `loss` (yolov3_loss on each
        scale, the images' mean), backward, Momentum(0.001, momentum 0.9,
        weight_decay 5e-4), DETECT["STEPS"] steps on one seeded batch
        (_detect_batch) put on the card once. Gates: every loss finite,
        the mean of the last 3 under the mean of the first 3, K1-K7
        launched 0 times (no TPU kernel lies on this path). Printed: each
        step's ms (CUDA events), the p50 of steps 3 on and images/s by
        it, the peak allocated bytes; with --profile, 3 more steps'
        device table."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import optimizer
        D = DETECT
        nparams = sum(p.numel() for p in net.parameters())
        opt = optimizer.Momentum(D["LR"], momentum=D["MOMENTUM"],
                                 parameters=net.parameters(),
                                 weight_decay=D["L2"])
        net.train()

        def step():
            loss = net.loss(net(x), gt, lab, ignore_thresh=D["IGNORE"]
                            ).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(D["STEPS"])]
        t0 = time.perf_counter()
        losses = []
        for e0, e1 in ev:
            e0.record()
            losses.append(step())
            e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("detect_yolov3")
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        ms = [e0.elapsed_time(e1) for e0, e1 in ev]
        p50 = float(np.median(ms[2:]))
        ips = D["B"] / p50 * 1e3
        print(f"detect (a) YOLOv3 width {D['WIDTH']}, {D['CLASSES']} "
              f"classes, {nparams} parameters fp32, [{D['B']}, 3, "
              f"{D['SIDE']}, {D['SIDE']}] on {self.smi}: step p50 "
              f"{p50:.2f} ms (steps 3-{D['STEPS']}, CUDA events), "
              f"{ips:.2f} images/s; first step {ms[0]:.2f} ms (cuDNN's "
              f"heuristics); {D['STEPS']} steps in {wall:.2f} s wall; peak "
              f"allocated {peak / 2**30:.2f} GiB; gt boxes an image "
              f"{(gt[:, :, 2] > 0).sum(1).tolist()}; launches {launches}")
        print("per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        print("per-step ms: " + " ".join(f"{v:.2f}" for v in ms))
        self.details["detect_train"] = dict(
            params=nparams, step_ms=ms, step_ms_p50=p50, images_per_s=ips,
            wall_s=wall, peak_allocated_bytes=peak, losses=losses,
            launches=launches)
        if self.args.profile:
            from torch.profiler import ProfilerActivity, profile
            steps = 3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
                pwall = (time.perf_counter() - t1) * 1e3
            dev, rows = _device_table(torch, prof, steps, pwall)
            self.details["profile_detect"] = dict(
                steps=steps, device_ms_per_step=dev,
                wall_ms_per_step=pwall / steps, top=rows[:20])
        assert all(np.isfinite(losses)), losses
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            "the YOLOv3 loss did not fall"
        assert all(v == 0 for v in launches.values()), launches

    def detect_predict(self, net, x):
        """(b) In eval mode, predict (yolo_box on the three scales) and
        multiclass_nms on DETECT["PREDICT"] of (a)'s images, at DETECT's
        thresholds, the NMS on the card; then the port's NMS on the CPU
        over copies of the same card-made boxes and scores. `net` holds
        the weights as built: with random weights nearly every box passes
        the score threshold in every class, the NMS's heaviest case,
        where the candidates of (a)'s trained weights swing with the
        objectness its steps leave (0 to 698,421 in four runs on an
        H100). Gates: the boxes and scores finite; candidates above the
        threshold; the kept rows a image equal; each row's label and
        score exactly, its box within 1e-5 x max(1, |CPU|). Printed:
        predict ms and NMS ms (CUDA events; the NMS also by the host
        clock, its scan running there), the candidates, the CPU NMS
        ms."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.vision.ops import multiclass_nms
        D = DETECT
        n = D["PREDICT"]
        kw = dict(score_threshold=D["SCORE"], nms_top_k=D["NMS_TOP_K"],
                  keep_top_k=D["KEEP_TOP_K"], nms_threshold=D["NMS"],
                  background_label=-1)
        net.eval()
        img = torch.full((n, 2), D["SIDE"], dtype=torch.int32,
                         device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.no_grad():
            torch.cuda.synchronize()
            ev[0].record()
            boxes, scores = net.predict(net(x[:n]), img,
                                        conf_thresh=D["SCORE"])
            scores = scores.transpose(1, 2).contiguous()
            ev[1].record()
            t0 = time.perf_counter()
            out, num = multiclass_nms(boxes, scores, **kw)
            ev[2].record()
            torch.cuda.synchronize()
            nms_host = (time.perf_counter() - t0) * 1e3
            cand = int((scores > D["SCORE"]).sum())
            t1 = time.perf_counter()
            ref, ref_num = multiclass_nms(boxes.cpu(), scores.cpu(), **kw)
            cpu_ms = (time.perf_counter() - t1) * 1e3
        pred_ms, nms_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(
            ev[2])
        got = out.cpu()
        scale = max(1.0, float(ref[:, 2:].abs().max())) if ref.numel() \
            else 1.0
        err = float("inf") if got.shape != ref.shape else float(
            (got[:, 2:] - ref[:, 2:]).abs().max()) if ref.numel() else 0.0
        print(f"detect (b) predict + multiclass_nms on {n} images of "
              f"{D['SIDE']}^2 on {self.smi}: predict {pred_ms:.2f} ms, NMS "
              f"{nms_ms:.2f} ms (host clock {nms_host:.2f} ms) over {cand} "
              f"(box, class) candidates above {D['SCORE']} of "
              f"{scores.numel()}; kept {num.tolist()} (CPU "
              f"{ref_num.tolist()}, {cpu_ms:.2f} ms); box err {err:.2e}")
        self.details["detect_predict"] = dict(
            predict_ms=pred_ms, nms_ms=nms_ms, nms_host_ms=nms_host,
            cpu_nms_ms=cpu_ms, candidates=cand, kept=num.tolist(),
            box_err=err)
        net.train()
        assert bool(torch.isfinite(boxes).all()) and \
            bool(torch.isfinite(scores).all())
        assert cand > 0, "no candidate above the score threshold"
        assert out.device.type == "cuda" and num.device.type == "cuda"
        assert torch.equal(num.cpu(), ref_num), (num, ref_num)
        assert torch.equal(got[:, :2], ref[:, :2]), "labels / scores differ"
        assert err <= 1e-5 * scale, err

    def _detect_parity_setup(self):
        """(c)'s narrow net on the card and its seeded batch (numpy)."""
        import numpy as np
        from paddle_tpu_torch.vision.models import yolov3
        P = DETECT_PARITY
        net = yolov3(num_classes=P["CLASSES"], width=P["WIDTH"],
                     device="cuda", seed=1)
        return net, _detect_batch(np, P["B"], P["SIDE"], P["CLASSES"],
                                  DETECT["SLOTS"], DETECT["MAX_GT"], seed=4)

    def detect_step_parity(self):
        """(c) One training step (forward, the images' mean loss,
        backward) of a narrow YOLOv3 (DETECT_PARITY) from one set of
        weights, fp32 on the card against the port's CPU step: the loss
        within rtol 1e-5, every gradient within phase 6's rule (1e-3 x
        its max + 1e-6 x the model's max), the running buffers within
        1e-4 x their max."""
        torch = self.torch
        import copy
        net0, batch = self._detect_parity_setup()

        def step(device):
            net = copy.deepcopy(net0).to(device)
            net.train()
            x, gt, lab = (torch.from_numpy(a).to(device) for a in batch)
            loss = net.loss(net(x), gt, lab).mean()
            loss.backward()
            return (float(loss.detach()),
                    {n: p.grad.detach().double().cpu()
                     for n, p in net.named_parameters()},
                    {n: b.detach().double().cpu()
                     for n, b in net.named_buffers()})
        card, cpu = step("cuda"), step("cpu")
        loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        worst = _grad_worst(card[1], cpu[1], 1e-3, 1e-6)
        rel = max(((card[1][n] - cpu[1][n]).norm().item()
                   / max(cpu[1][n].norm().item(), 1e-30), n)
                  for n in cpu[1])
        buf = max((card[2][n] - cpu[2][n]).abs().max().item()
                  / max(cpu[2][n].abs().max().item(), 1e-30)
                  for n in cpu[2])
        P = DETECT_PARITY
        print(f"detect (c) YOLOv3 width {P['WIDTH']} step parity [{P['B']},"
              f" 3, {P['SIDE']}, {P['SIDE']}] on {self.smi}: loss card "
              f"{card[0]:.6f} CPU {cpu[0]:.6f} ({loss_rel:.2e} rel); "
              f"gradients {worst[0]:.3e}x phase 6's rule ({worst[1]}), "
              f"worst relative L2 {rel[0]:.2e} ({rel[1]}); buffers "
              f"{buf:.2e} of their max")
        self.details["detect_parity"] = dict(
            loss_card=card[0], loss_cpu=cpu[0], loss_rel=loss_rel,
            grad_rule=worst, worst_rel_l2=rel, buffer_share=buf)
        assert loss_rel <= 1e-5, loss_rel
        assert worst[0] <= 1.0, worst
        assert buf <= 1e-4, buf

    def detect_incubate(self):
        """(d) incubate's optimizers on (c)'s net and batch, DETECT_PARITY
        ["STEPS"] steps each, card against the port's CPU run from the
        same weights: LookAhead(Momentum, alpha 0.5, k 2), GradientMerge
        Optimizer(Momentum, k_steps 2), and ModelAverage beside SGD, held
        inside apply() (the average) and after it (restored). Each
        parameter's update from the shared start within phase 7's rule
        (_update_worst) of the CPU's, the average's floor STEPS times the
        weights' resolution."""
        torch = self.torch
        import copy
        from paddle_tpu_torch import incubate, optimizer
        P = DETECT_PARITY
        net0, batch = self._detect_parity_setup()
        arms = {
            "LookAhead": lambda ps: incubate.LookAhead(
                optimizer.Momentum(P["LR"], parameters=ps), alpha=0.5, k=2),
            "GradientMerge": lambda ps: incubate.GradientMergeOptimizer(
                optimizer.Momentum(P["LR"], parameters=ps), k_steps=2),
            "ModelAverage": lambda ps: optimizer.SGD(P["LR"], parameters=ps),
        }

        def run(arm, device):
            net = copy.deepcopy(net0).to(device)
            net.train()
            x, gt, lab = (torch.from_numpy(a).to(device) for a in batch)
            opt = arms[arm](list(net.parameters()))
            avg = incubate.ModelAverage(parameters=list(net.parameters())) \
                if arm == "ModelAverage" else None
            losses = []
            for _ in range(P["STEPS"]):
                loss = net.loss(net(x), gt, lab).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                if avg is not None:
                    avg.step()
                losses.append(float(loss))
            states = {"trained": {n: p.detach().cpu().clone()
                                  for n, p in net.named_parameters()}}
            if avg is not None:
                with avg.apply():
                    states["averaged"] = {n: p.detach().cpu().clone()
                                          for n, p in net.named_parameters()}
                states["restored"] = {n: p.detach().cpu().clone()
                                      for n, p in net.named_parameters()}
            return losses, states
        init = {n: p.detach().cpu() for n, p in net0.named_parameters()}
        # the average sums STEPS weights near their start, so it carries
        # STEPS times their fp32 resolution (the rule's floor); an H100
        # read 0.567 of the plain floor on a BatchNorm weight near 1
        resolution = {"trained": init, "restored": init,
                      "averaged": {n: v * P["STEPS"]
                                   for n, v in init.items()}}
        res = {}
        for arm in arms:
            (lc, sc), (lr, sr) = run(arm, "cuda"), run(arm, "cpu")
            worst = max(_update_worst(
                {n: v - init[n] for n, v in sc[k].items()},
                {n: v - init[n] for n, v in sr[k].items()},
                resolution[k]) + (k,) for k in sr)
            res[arm] = dict(losses_card=lc, losses_cpu=lr, worst=worst)
            print(f"detect (d) incubate {arm} {P['STEPS']} steps on "
                  f"{self.smi}: losses card {[round(v, 4) for v in lc]} CPU "
                  f"{[round(v, 4) for v in lr]}; worst update "
                  f"{worst[0]:.3e}x phase 7's rule ({worst[2]}, "
                  f"{worst[1]})")
            if "restored" in sc:
                assert all(torch.equal(sc["restored"][n], sc["trained"][n])
                           for n in sc["trained"]), "restore"
                assert any(not torch.equal(sc["averaged"][n],
                                           sc["trained"][n])
                           for n in sc["trained"]), "apply"
        self.details["detect_incubate"] = res
        for arm, r in res.items():
            assert r["worst"][0] <= 1.0, (arm, r["worst"])

    # -- 10. export and inference ------------------------------------------------

    def export(self):
        """Models saved on the CPU through jit.save, served on the card
        through inference.Predictor and serving.InferenceEngine: (a)
        bench.py --mode serving's MLP and traffic, (b) ERNIE-base at seq
        512 in fp32 and O2 bf16 through K2, (c) ResNet-50 through a
        Predictor, the int8 MLP, a lane restart (see the module
        docstring)."""
        import shutil
        import tempfile
        self.gpt = None
        self.torch.cuda.empty_cache()
        self.export_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")
        try:
            self.export_mlp()
            self.export_ernie("float32")
            self.export_ernie("bfloat16")
            self.export_resnet()
            self.export_quant()
            self.export_lane_restart()
        finally:
            shutil.rmtree(self.export_dir, ignore_errors=True)

    def _serve_mlp_net(self):
        """bench.py's serving model (bench.py:453-462) on the CPU, seed 0:
        Linear(256, 1024) -> tanh -> Linear(1024, 1024) -> tanh ->
        Linear(1024, 256)."""
        torch = self.torch
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import nn
        from paddle_tpu_torch.framework import random as frandom
        DIM, HID = SERVE_MLP["DIM"], SERVE_MLP["HID"]
        frandom.seed(0)
        torch.manual_seed(0)

        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(DIM, HID, device="cpu")
                self.fc2 = nn.Linear(HID, HID, device="cpu")
                self.fc3 = nn.Linear(HID, DIM, device="cpu")

            def forward(self, x):
                h = ptt.tanh(self.fc1(x))
                return self.fc3(ptt.tanh(self.fc2(h)))
        return Net().eval()

    def _concurrent(self, eng, xs):
        """bench.py's concurrent phase: SERVE_MLP["SUBMITTERS"] threads,
        each submitting its own row PER times with PIPELINE outstanding.
        Returns (qps, {submitter: [results]})."""
        from collections import deque
        n, per, pipe = (SERVE_MLP[k] for k in ("SUBMITTERS", "PER",
                                                "PIPELINE"))
        start = threading.Barrier(n + 1)
        errors, results = [], {}

        def client(i):
            try:
                start.wait()
                out, got = deque(), []
                for _ in range(per):
                    out.append(eng.submit(xs[i], timeout_ms=0))
                    if len(out) >= pipe:
                        got.append(out.popleft().result()[0])
                got.extend(f.result()[0] for f in out)
                results[i] = got
            except Exception as e:  # noqa: BLE001 — counted, then raised
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"{len(errors)}/{n} serving clients failed: "
                               f"{errors[0]!r}")
        return n * per / wall, results

    def export_mlp(self):
        """(a) bench.py --mode serving (bench.py:428-593) on the card: the
        MLP saved on the CPU with InputSpec([None, 256]); a serial
        Predictor.run loop of SERIAL single rows (median of two windows
        before the engine and one after); an InferenceEngine over
        devices="all" (one lane on one card), buckets (1, 4, 16, 64),
        batch delay 2 ms, queue depth 512, driven by 64 submitters x 40
        requests with 4 outstanding, three phases (qps: the best, as
        bench.py); then the same engine with FLAGS_serving_spans off.
        Gates: every result is bit-identical to its row served alone
        through one of the buckets and within 1e-5 x max(1, max |ref|) of
        eager net(x) on the card; STAT_predictor_compiles moved by lanes x
        buckets at warmup and 0 under load; STAT_serving_queue_depth is
        back to 0; the latency count equals the requests."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import inference, jit, serving
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.static import InputSpec
        DIM, buckets = SERVE_MLP["DIM"], SERVE_MLP["BUCKETS"]
        net = self._serve_mlp_net()
        prefix = os.path.join(self.export_dir, "serving_mlp")
        t0 = time.perf_counter()
        jit.save(net, prefix, input_spec=[InputSpec([None, DIM], "float32")])
        save_s = time.perf_counter() - t0
        gpu = net.to("cuda")
        n = SERVE_MLP["SUBMITTERS"]
        xs = [np.random.RandomState(i).standard_normal((1, DIM)).astype(
            np.float32) for i in range(n)]
        pred = inference.create_predictor(inference.Config(prefix))
        assert pred.device.type == "cuda", pred.device
        x1 = xs[0]
        for _ in range(3):
            pred.run([x1])
        windows = []

        def serial_window():
            t = time.perf_counter()
            for _ in range(SERVE_MLP["SERIAL"]):
                pred.run([x1])
            windows.append(SERVE_MLP["SERIAL"] / (time.perf_counter() - t))
        serial_window()
        serial_window()
        # oracles: each submitter's row alone through every bucket, and
        # eager on the card
        alone = {i: [pred.run([np.concatenate(
            [xs[i], np.zeros((b - 1, DIM), np.float32)])])[0][:1]
            for b in buckets] for i in range(n)}
        with torch.no_grad():
            eager = {i: gpu(torch.from_numpy(xs[i]).cuda()).cpu().numpy()
                     for i in range(n)}

        def measure(name, phases):
            monitor.histogram(f"{name}_request_ms").reset()
            c0 = monitor.stat_get("STAT_predictor_compiles")
            eng = serving.InferenceEngine(
                inference.Config(prefix), devices="all",
                batch_buckets=buckets, max_batch_size=buckets[-1],
                max_batch_delay_ms=SERVE_MLP["DELAY_MS"],
                max_queue_depth=SERVE_MLP["QUEUE"], name=name)
            try:
                warm = monitor.stat_get("STAT_predictor_compiles") - c0
                runs = [self._concurrent(eng, xs) for _ in range(phases)]
                live = monitor.stat_get("STAT_predictor_compiles") - c0 - warm
                return warm, live, runs, eng.stats()
            finally:
                eng.shutdown()

        warm, live, runs, s = measure("chip_serving", 3)
        serial_window()
        serial = sorted(windows)[len(windows) // 2]
        qps = max(q for q, _ in runs)
        lanes = len(s["lanes"])
        requests = 3 * n * SERVE_MLP["PER"]
        worst = 0.0
        for _, results in runs:
            for i, outs in results.items():
                for o in outs:
                    assert any(np.array_equal(o, a) for a in alone[i]), \
                        f"submitter {i}: a result is not its row served " \
                        f"alone through any bucket"
                    ref = eager[i]
                    worst = max(worst, float(np.abs(o - ref).max())
                                / max(1.0, float(np.abs(ref).max())))
        set_flags({"FLAGS_serving_spans": False})
        try:
            _, _, off_runs, _ = measure("chip_serving_nospans", 3)
        finally:
            set_flags({"FLAGS_serving_spans": True})
        qps_off = max(q for q, _ in off_runs)
        lat = s["latency_ms"]
        print(f"export (a) on {self.smi}: bench.py serving MLP "
              f"({DIM}->{SERVE_MLP['HID']}->{SERVE_MLP['HID']}->{DIM}, "
              f"saved on the CPU in {save_s:.2f} s), {lanes} lane(s), "
              f"buckets {buckets}: {qps:.1f} qps (phases "
              f"{[round(q, 1) for q, _ in runs]}), p50 {lat['p50']:.3f} ms "
              f"p99 {lat['p99']:.3f} ms over {lat['count']} requests; "
              f"serial Predictor.run {serial:.1f} qps (windows "
              f"{[round(w, 1) for w in windows]}), speedup "
              f"{qps / serial:.2f}x; mean occupancy {s['mean_occupancy']}; "
              f"spans off {qps_off:.1f} qps (phases "
              f"{[round(q, 1) for q, _ in off_runs]}), span overhead "
              f"{100.0 * (1.0 - qps / qps_off):.2f} %; warm compiles {warm}, "
              f"live {live}; worst |served - eager| / max(1, |eager|) "
              f"{worst:.3e}; bucket batches "
              f"{ {b: v['batches'] for b, v in s['buckets'].items()} }; "
              f"phases (ms p50) "
              f"{ {k: round(v['p50'], 4) for k, v in s['phases'].items()} }")
        self.details["export_mlp"] = dict(
            qps=qps, qps_phases=[q for q, _ in runs], serial_qps=serial,
            serial_windows=windows, speedup=qps / serial,
            p50_ms=lat["p50"], p99_ms=lat["p99"], requests=lat["count"],
            mean_occupancy=s["mean_occupancy"], spans_off_qps=qps_off,
            spans_off_phases=[q for q, _ in off_runs], lanes=lanes,
            warm=warm, live=live, worst_rel_err=worst, save_s=save_s,
            buckets={str(b): v for b, v in s["buckets"].items()},
            phases=s["phases"], inflight=s["inflight_depth"])
        assert worst <= 1e-5, f"served rows differ from eager: {worst}"
        assert warm == lanes * len(buckets) and live == 0, (warm, live)
        assert s["queue_depth"] == 0 and \
            monitor.stat_get("STAT_serving_queue_depth") == 0
        assert lat["count"] == requests, (lat["count"], requests)
        assert all(c == 1 for lane in s["lanes"]
                   for c in lane["bucket_compiles"].values())
        del pred, gpu
        torch.cuda.empty_cache()

    def export_ernie(self, dtype):
        """(b) ErnieForSequenceClassification(ErnieConfig.base(), 2), seed
        0, eval, saved on the CPU with InputSpec([None, 512], "int64") for
        the ids and the attention_mask, in fp32 or (dtype "bfloat16") after
        O2 amp.decorate; served on the card through create_predictor and an
        InferenceEngine over it, buckets (1, 4, 16, 64): 64 requests of one
        row from 16 submitters, lengths seeded in 128-512 padded to 512;
        a load window of LOAD_ROUNDS x 64 requests of the same rows, each
        submitter keeping LOAD_OUTSTANDING outstanding (samples/s and
        p50/p99 are this window's); then two rows through the predictor
        alone. The path ("export_ernie" / "export_ernie_bf16"):
        every launch count from 0 before the predictor is built, read
        after the traffic. Gates: the exported graph holds 12 flash_fwd
        nodes and no softmax; the logits equal eager on the card (the
        same weights, each row alone) within EXPORT_TOL[dtype] x max(1,
        max |logit|), the load window's too; K2 launches = 12 x the
        batches dispatched (warmup, the engine's batches of both
        windows, the predictor's runs), all in the path's
        type, and STAT_flash_attention_fwd moved as much; the plain
        version ran 0 times and STAT_attention_wide_head_fallback did not
        move; one warm per bucket and no live one."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, inference, jit, serving
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        from paddle_tpu_torch.ops import flash_ops as fo
        from paddle_tpu_torch.static import InputSpec
        S, R, subs, buckets, rounds, pipe = (
            ERNIE_SERVE[k] for k in ("S", "REQUESTS", "SUBMITTERS",
                                     "BUCKETS", "LOAD_ROUNDS",
                                     "LOAD_OUTSTANDING"))
        from collections import deque
        path = "export_ernie" if dtype == "float32" else "export_ernie_bf16"
        cfg = ErnieConfig.base()

        class Cls(torch.nn.Module):
            def __init__(self, net):
                super().__init__()
                self.net = net

            def forward(self, ids, mask):
                return self.net(ids, attention_mask=mask)
        net = Cls(ErnieForSequenceClassification(cfg, device="cpu",
                                                 seed=0)).eval()
        if dtype == "bfloat16":
            amp.decorate(net, level="O2")
        prefix = os.path.join(self.export_dir, path)
        t0 = time.perf_counter()
        jit.save(net, prefix, input_spec=[InputSpec([None, S], "int64"),
                                          InputSpec([None, S], "int64")])
        save_s = time.perf_counter() - t0
        lens = _ernie_lengths(np, R, S, seed=5)
        rng = np.random.RandomState(5)
        ids = rng.randint(5, cfg.vocab_size, size=(R, S)).astype(np.int64)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
        ids[mask == 0] = 0
        L = cfg.num_hidden_layers
        torch.cuda.synchronize()
        plain = [0]
        ref_fn = fo._flash_fwd_reference

        def counted(*a, **k):
            plain[0] += 1
            return ref_fn(*a, **k)
        # the main path starts here: every launch count from 0
        self.zero_launches()
        fb0 = monitor.stat_get("STAT_attention_wide_head_fallback")
        st0 = monitor.stat_get("STAT_flash_attention_fwd")
        c0 = monitor.stat_get("STAT_predictor_compiles")
        fo._flash_fwd_reference = counted
        try:
            t0 = time.perf_counter()
            pred = inference.create_predictor(inference.Config(prefix))
            load_s = time.perf_counter() - t0
            eng = serving.InferenceEngine(
                pred, batch_buckets=buckets, max_batch_size=buckets[-1],
                max_batch_delay_ms=SERVE_MLP["DELAY_MS"],
                max_queue_depth=SERVE_MLP["QUEUE"], name=f"chip_{path}")
            try:
                warm = monitor.stat_get("STAT_predictor_compiles") - c0
                futs = [None] * R
                start = threading.Barrier(subs + 1)

                def client(k):
                    start.wait()
                    for i in range(k, R, subs):
                        futs[i] = eng.submit([ids[i:i + 1], mask[i:i + 1]],
                                             timeout_ms=0)
                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(subs)]
                for t in threads:
                    t.start()
                start.wait()
                t0 = time.perf_counter()
                for t in threads:
                    t.join()
                served = [f.result()[0] for f in futs]
                wall = time.perf_counter() - t0
                s = eng.stats()
                # the load window: its own latency histogram
                monitor.histogram(f"chip_{path}_request_ms").reset()
                monitor.histogram(f"chip_{path}_inflight_depth").reset()
                loaded = [None] * (R * rounds)
                start = threading.Barrier(subs + 1)
                errors = []

                def loader(k):
                    try:
                        start.wait()
                        out = deque()
                        for j in range(k, R * rounds, subs):
                            i = j % R
                            out.append((j, eng.submit(
                                [ids[i:i + 1], mask[i:i + 1]],
                                timeout_ms=0)))
                            if len(out) >= pipe:
                                j0, f = out.popleft()
                                loaded[j0] = f.result()[0]
                        for j0, f in out:
                            loaded[j0] = f.result()[0]
                    except Exception as e:  # noqa: BLE001 — raised below
                        errors.append(e)
                threads = [threading.Thread(target=loader, args=(k,))
                           for k in range(subs)]
                for t in threads:
                    t.start()
                start.wait()
                t0 = time.perf_counter()
                for t in threads:
                    t.join()
                load_wall = time.perf_counter() - t0
                if errors:
                    raise RuntimeError(f"{len(errors)}/{subs} load "
                                       f"submitters failed: {errors[0]!r}")
                sl = eng.stats()
            finally:
                eng.shutdown()
            # two rows through the predictor alone (bucket 1's shape)
            single = [pred.run([ids[i:i + 1], mask[i:i + 1]])[0]
                      for i in range(2)]
        finally:
            fo._flash_fwd_reference = ref_fn
        torch.cuda.synchronize()
        launches = self.record_path(path)
        by_dtype = self.path_dtype_launches[path]
        stat = monitor.stat_get("STAT_flash_attention_fwd") - st0
        live = monitor.stat_get("STAT_predictor_compiles") - c0 - warm
        batches = sum(lane["batches"] for lane in s["lanes"])
        load_batches = sum(lane["batches"] for lane in sl["lanes"]) - batches
        dispatched = len(buckets) + batches + load_batches + len(single)
        graph = [str(nd.target) for nd in
                 pred._translated._exported.graph.nodes
                 if nd.op == "call_function"]
        nodes = sum(t == "paddle_tpu_torch.flash_fwd.default" for t in graph)
        softmax = sum("softmax" in t for t in graph)
        # eager on the card, each row alone
        gnet = net.to("cuda")
        with torch.no_grad():
            eager = np.concatenate([gnet(
                torch.from_numpy(ids[i:i + 1]).cuda(),
                torch.from_numpy(mask[i:i + 1]).cuda()).float().cpu().numpy()
                for i in range(R)])
        got = np.concatenate(served)
        scale = max(1.0, float(np.abs(eager).max()))
        err = float(np.abs(got - eager).max())
        err_single = float(np.abs(np.concatenate(single) - eager[:2]).max())
        err_load = float(np.abs(np.concatenate(loaded)
                                - np.tile(eager, (rounds, 1))).max())
        lat, llat = s["latency_ms"], sl["latency_ms"]
        n_load = R * rounds
        load_buckets = {b: v["batches"] - s["buckets"][b]["batches"]
                        for b, v in sl["buckets"].items()}
        print(f"export (b) {path} on {self.smi}: ERNIE-base {dtype} saved "
              f"on the CPU in {save_s:.2f} s, loaded onto the card in "
              f"{load_s:.2f} s; {R} requests (lengths "
              f"{ERNIE_LONG['MIN_LEN']}-{S}) from {subs} submitters in "
              f"{wall * 1e3:.1f} ms, bucket batches "
              f"{ {b: v['batches'] for b, v in s['buckets'].items()} } "
              f"(latency p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms); "
              f"load window {n_load} requests ({pipe} outstanding a "
              f"submitter) in {load_wall * 1e3:.1f} ms: "
              f"{n_load / load_wall:.1f} samples/s, p50 {llat['p50']:.3f} ms "
              f"p99 {llat['p99']:.3f} ms, bucket batches {load_buckets}, "
              f"in-flight depth {sl['inflight_depth']}; "
              f"max |served - eager| {err:.3e}, load {err_load:.3e}, "
              f"predictor rows "
              f"{err_single:.3e} (max |logit| {scale:.3f}, tol "
              f"{EXPORT_TOL[dtype]} x max(1, it)); K2 launches "
              f"{launches['flash_fwd']} = {L} x {dispatched} dispatched "
              f"({len(buckets)} warm + {batches} + {load_batches} engine + "
              f"{len(single)} predictor)? by type {by_dtype['flash_fwd']}; "
              f"graph flash_fwd nodes {nodes}, softmax {softmax}; plain "
              f"calls {plain[0]}; warm {warm} live {live}")
        self.details[path] = dict(
            samples_per_s=n_load / load_wall, load_wall_ms=load_wall * 1e3,
            load_requests=n_load, p50_ms=llat["p50"], p99_ms=llat["p99"],
            load_buckets={str(b): v for b, v in load_buckets.items()},
            inflight=sl["inflight_depth"], first_wall_ms=wall * 1e3,
            first_p50_ms=lat["p50"], first_p99_ms=lat["p99"],
            max_abs_err=err, load_err=err_load, predictor_err=err_single,
            max_logit=scale, launches=launches, launches_by_dtype=by_dtype,
            dispatched=dispatched, engine_batches=batches,
            load_batches=load_batches, warm=warm,
            live=live, save_s=save_s, load_s=load_s,
            buckets={str(b): v for b, v in s["buckets"].items()},
            phases=sl["phases"])
        tol = EXPORT_TOL[dtype] * scale
        assert nodes == L and softmax == 0, (nodes, softmax)
        assert max(err, err_single, err_load) <= tol, \
            (err, err_single, err_load, tol)
        assert launches["flash_fwd"] == L * dispatched, \
            (launches["flash_fwd"], dispatched)
        assert by_dtype["flash_fwd"] == {dtype: L * dispatched}, \
            by_dtype["flash_fwd"]
        assert stat == L * dispatched, (stat, dispatched)
        assert plain[0] == 0, f"the plain forward ran {plain[0]} times"
        assert monitor.stat_get("STAT_attention_wide_head_fallback") == fb0
        assert warm == len(buckets) and live == 0, (warm, live)
        assert lat["count"] == R and llat["count"] == n_load, \
            (lat["count"], llat["count"])
        assert all(c == 1 for lane in sl["lanes"]
                   for c in lane["bucket_compiles"].values())
        assert all(k == 0 for n_, k in launches.items() if n_ != "flash_fwd")
        del pred, gnet, net
        torch.cuda.empty_cache()

    def export_resnet(self):
        """(c) resnet50(num_classes=1000), seed 0, eval, its BatchNorm
        running buffers set from a seeded draw (so carrying them shows),
        saved on the CPU with InputSpec([None, 3, 224, 224]) and run
        through a Predictor on the card at bench.py's batch 32 x 224^2.
        Gates: the program's buffers equal the model's exactly; the
        logits within 1e-4 x max(1, max |ref|) of eager on the card (the
        same cuDNN convolutions, TF32 off); no K1-K7 launch."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import inference, jit, nn
        from paddle_tpu_torch.static import InputSpec
        from paddle_tpu_torch.vision.models import resnet50
        B, side = RESNET_A["B"], RESNET_A["SIDE"]
        net = resnet50(num_classes=1000, device="cpu", seed=0).eval()
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, nn.BatchNorm2D):
                    m._mean.copy_(torch.randn(m._mean.shape, generator=g)
                                  * 0.1)
                    m._variance.copy_(torch.rand(m._variance.shape,
                                                 generator=g) + 0.5)
        prefix = os.path.join(self.export_dir, "resnet50")
        t0 = time.perf_counter()
        jit.save(net, prefix, input_spec=[InputSpec([None, 3, side, side],
                                                    "float32")])
        save_s = time.perf_counter() - t0
        self.zero_launches()
        pred = inference.create_predictor(inference.Config(prefix))
        held = pred._translated._exported.state_dict
        bufs = {n: b for n, b in net.named_buffers()
                if n.endswith(("_mean", "_variance"))}
        assert all(torch.equal(held[n], b) for n, b in bufs.items()), \
            "the program's running buffers differ from the model's"
        x = np.random.RandomState(0).standard_normal(
            (B, 3, side, side)).astype(np.float32)
        pred.run([x])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pred.run([x])[0]
        run_ms = (time.perf_counter() - t0) * 1e3
        gnet = net.to("cuda")
        with torch.no_grad():
            want = gnet(torch.from_numpy(x).cuda()).cpu().numpy()
        err = float(np.abs(got - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        launches = self.read_launches()
        print(f"export (c) ResNet-50 on {self.smi}: saved on the CPU in "
              f"{save_s:.2f} s, {len(bufs)} running buffers carried; "
              f"Predictor batch {B} x {side}^2: {run_ms:.2f} ms a run "
              f"(host clock, to the host), max |served - eager| {err:.3e} "
              f"(max |logit| {scale:.3f}); launches {launches}")
        self.details["export_resnet"] = dict(max_abs_err=err, scale=scale,
                                             run_ms=run_ms, save_s=save_s,
                                             buffers=len(bufs))
        assert err <= 1e-4 * scale, err
        assert not any(launches.values()), launches
        del pred, gnet, net
        torch.cuda.empty_cache()

    def export_quant(self):
        """(c) The serving MLP with quantization.quantize_weights (int8),
        saved on the CPU and served on the card through a Predictor and an
        InferenceEngine over it. Gates: STAT_quant_exports moved by 1;
        STAT_quant_weight_hbm_bytes moved by the integer and scale bytes
        while the predictor lives; the predictor's output at batch 16
        equals the eager quantized model's on the card exactly; every
        served row within 1e-5 x max(1, max |ref|) of it."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import inference, jit, quantization, serving
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.static import InputSpec
        DIM, buckets = SERVE_MLP["DIM"], SERVE_MLP["BUCKETS"]
        net = quantization.quantize_weights(self._serve_mlp_net(), bits=8)
        q0 = monitor.stat_get("STAT_quant_exports")
        prefix = os.path.join(self.export_dir, "serving_mlp_int8")
        jit.save(net, prefix, input_spec=[InputSpec([None, DIM], "float32")])
        exports = monitor.stat_get("STAT_quant_exports") - q0
        meta = jit.load_meta(prefix)["quant"]
        state = net.state_dict()
        qbytes = sum(state[n].numel() * state[n].element_size()
                     for n in meta["args"])
        g0 = monitor.stat_get("STAT_quant_weight_hbm_bytes")
        pred = inference.create_predictor(inference.Config(prefix))
        gauge = monitor.stat_get("STAT_quant_weight_hbm_bytes") - g0
        gnet = net.to("cuda")
        x = np.random.RandomState(1).standard_normal((16, DIM)).astype(
            np.float32)
        got = pred.run([x])[0]
        with torch.no_grad():
            want = gnet(torch.from_numpy(x).cuda()).cpu().numpy()
        eng = serving.InferenceEngine(pred, batch_buckets=buckets,
                                      max_batch_size=buckets[-1],
                                      max_batch_delay_ms=1.0,
                                      name="chip_quant")
        try:
            futs = [eng.submit(x[i:i + 1]) for i in range(16)]
            served = np.concatenate([f.result()[0] for f in futs])
            qinfo = eng.stats()["quantized_weights"]
        finally:
            eng.shutdown()
        err = float(np.abs(served - want).max())
        print(f"export (c) int8 MLP on {self.smi}: STAT_quant_exports +"
              f"{exports}, STAT_quant_weight_hbm_bytes +{gauge} (integer "
              f"and scale bytes {qbytes}); predictor vs eager exact: "
              f"{np.array_equal(got, want)}; served max err {err:.3e}; "
              f"stats()['quantized_weights'] {qinfo}")
        self.details["export_quant"] = dict(exports=exports, gauge=gauge,
                                            qbytes=qbytes, served_err=err,
                                            quantized_weights=qinfo)
        assert exports == 1 and gauge == qbytes, (exports, gauge, qbytes)
        assert np.array_equal(got, want), "int8 program differs from eager"
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
        del pred, gnet
        torch.cuda.empty_cache()

    def export_lane_restart(self):
        """(c) A lane restart on the card (tests/test_engine_resurrection.py
        :459-487): an engine over a Predictor of the serving MLP whose
        run_device raises a BaseException on its third dispatch after the
        warmup, FLAGS_serving_lane_restarts=1, 8 requests run one after
        another. Gates: only the dying batch's request fails
        (UnavailableError); the lane is alive again with restarts 1 and
        serves the rest, each equal to the predictor's own run; no new
        warm (STAT_predictor_compiles does not move after the warmup)."""
        import numpy as np
        from paddle_tpu_torch import inference, jit, serving
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.errors import UnavailableError
        from paddle_tpu_torch.framework.flags import set_flags
        from paddle_tpu_torch.static import InputSpec
        DIM, buckets = SERVE_MLP["DIM"], SERVE_MLP["BUCKETS"]
        prefix = os.path.join(self.export_dir, "serving_mlp")
        pred = inference.create_predictor(inference.Config(prefix))
        ref = inference.create_predictor(inference.Config(prefix))
        run = pred.run_device
        calls = [0]

        class LaneKiller(BaseException):
            pass

        def flaky(arrays):
            calls[0] += 1
            if calls[0] == len(buckets) + 3:
                raise LaneKiller("lane fault")
            return run(arrays)
        pred.run_device = flaky
        xs = [np.random.RandomState(10 + i).standard_normal(
            (1, DIM)).astype(np.float32) for i in range(8)]
        want = [ref.run([x])[0] for x in xs]
        set_flags({"FLAGS_serving_lane_restarts": 1,
                   "FLAGS_gen_restart_backoff_ms": 5.0})
        c0 = monitor.stat_get("STAT_predictor_compiles")
        eng = serving.InferenceEngine(pred, batch_buckets=buckets,
                                      max_batch_size=buckets[-1],
                                      max_batch_delay_ms=0.5,
                                      request_timeout_ms=0,
                                      name="chip_lane_restart")
        try:
            warm = monitor.stat_get("STAT_predictor_compiles") - c0
            failed, ok = [], []
            for i, x in enumerate(xs):
                try:
                    out = eng.run([x], timeout_ms=10000)[0]
                    ok.append(np.array_equal(out, want[i]))
                except UnavailableError:
                    failed.append(i)
            lane = eng.stats()["lanes"][0]
            live = monitor.stat_get("STAT_predictor_compiles") - c0 - warm
        finally:
            eng.shutdown()
            set_flags({"FLAGS_serving_lane_restarts": 0,
                       "FLAGS_gen_restart_backoff_ms": 100.0})
        print(f"export (c) lane restart on {self.smi}: failed requests "
              f"{failed}, served {len(ok)} (all equal to the predictor: "
              f"{all(ok)}), lane alive {lane['alive']} restarts "
              f"{lane['restarts']}, warm {warm} live {live}")
        self.details["export_lane_restart"] = dict(
            failed=failed, served=len(ok), restarts=lane["restarts"],
            warm=warm, live=live)
        assert failed == [2], failed
        assert len(ok) == 7 and all(ok)
        assert lane["alive"] and lane["restarts"] == 1
        assert warm == len(buckets) and live == 0, (warm, live)

    # -- 11. the top-level API, the dense ops and the MoE GPT --------------------

    # -- 10b. onnx: ONNX export and the C inference API ---------------------

    def onnx(self):
        """ERNIE-base and ResNet-50 exported to ONNX from traces on the
        card and evaluated in numpy (tests/torch_onnx_eval.py), and the
        port's C inference API serving a saved encoder on the card (see
        the module docstring)."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        wd = tempfile.mkdtemp(prefix="chip_smoke_onnx_")
        proc = None
        try:
            # (c)'s C process makes its predictor while (a) and (b) run,
            # and times its runs after them
            proc = self.onnx_capi_start(wd)
            self.onnx_ernie(wd)
            self.onnx_resnet(wd)
            self.onnx_capi(wd, proc)
        finally:
            if proc is not None and proc["proc"].poll() is None:
                proc["proc"].kill()
                proc["proc"].wait()
            shutil.rmtree(wd, ignore_errors=True)

    def _onnx_export(self, net, specs, path):
        """(decomposed program, written path, ms): the exporter's trace of
        `net` on its device, then its ONNX file (`onnx.export` in two
        steps, so that the trace can be read)."""
        import importlib
        oexp = importlib.import_module("paddle_tpu_torch.onnx.export")
        t0 = time.perf_counter()
        ep, names = oexp.trace(net, specs)
        path = oexp.write(ep, names, path)
        return ep, path, (time.perf_counter() - t0) * 1e3

    def _onnx_model(self, path, state):
        """The ONNX file loaded by the numpy evaluator, with the gates of
        its graph: every op one the evaluator knows (no custom op), and
        every `state` tensor the initializer of its name, bit for bit."""
        import numpy as np
        sys.path.insert(0, str(REPO / "tests"))
        import torch_onnx_eval as ev
        model = ev.load(path)
        ops = model.op_types()
        unknown = sorted({o for o in ops if o not in ev._OPS})
        assert not unknown, f"ops the evaluator does not know: {unknown}"
        torch = self.torch
        differ = []
        for n, t in state.items():
            want = t.detach().cpu()
            want = (want.float() if want.dtype == torch.bfloat16
                    else want).numpy()
            got = model.initializers.get(n)
            if got is None or got.dtype != want.dtype or \
                    got.shape != want.shape or \
                    got.tobytes() != want.tobytes():
                differ.append(n)
        assert not differ, f"initializers not bit-equal to the card's " \
            f"state_dict: {differ[:5]} ({len(differ)})"
        return model, ops

    def _onnx_gate(self, name, got, want):
        import numpy as np
        err = float(np.abs(got - want).max())
        lim = EXPORT_TOL["float32"] * max(1.0, float(np.abs(want).max()))
        assert got.shape == want.shape and np.isfinite(got).all(), \
            (name, got.shape, want.shape)
        assert err <= lim, (name, err, lim)
        return err, lim

    def onnx_ernie(self, wd):
        """(a) ErnieForSequenceClassification(ErnieConfig.base(), 2), seed
        0, eval, fp32, on the card, wrapped as export_ernie wraps it,
        exported at [ONNX["B"], 512] (int64 ids and attention_mask, the
        seeded 128-512 lengths of export_ernie). Gates: the trace holds
        12 flash_fwd nodes, the graph none and no op the evaluator does
        not know; every state_dict tensor is its initializer bit for bit;
        the numpy evaluation equals the card's eager logits within
        EXPORT_TOL["float32"] x max(1, max |logit|); the eager forward (the
        path "onnx_ernie", counts from 0) launches K2 12 times and the
        plain version 0 times."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        from paddle_tpu_torch.ops import flash_ops as fo
        from paddle_tpu_torch.static import InputSpec
        B, S = ONNX["B"], ERNIE_SERVE["S"]
        cfg = ErnieConfig.base()
        L = cfg.num_hidden_layers

        class Cls(torch.nn.Module):
            def __init__(self, net):
                super().__init__()
                self.net = net

            def forward(self, ids, mask):
                return self.net(ids, attention_mask=mask)
        net = Cls(ErnieForSequenceClassification(cfg, device="cuda",
                                                 seed=0)).eval()
        lens = _ernie_lengths(np, B, S, seed=5)
        rng = np.random.RandomState(5)
        ids = rng.randint(5, cfg.vocab_size, size=(B, S)).astype(np.int64)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
        ids[mask == 0] = 0
        ep, path, export_ms = self._onnx_export(
            net, [InputSpec([B, S], "int64", "ids"),
                  InputSpec([B, S], "int64", "mask")],
            os.path.join(wd, "ernie_base"))
        flash = sum(1 for n in ep.graph.nodes if n.op == "call_function"
                    and "flash_fwd" in str(n.target))
        del ep
        size = os.path.getsize(path)
        model, ops = self._onnx_model(path, net.state_dict())
        t0 = time.perf_counter()
        got = model.run({"ids": ids, "mask": mask})[0]
        eval_s = time.perf_counter() - t0
        plain = [0]
        ref_fn = fo._flash_fwd_reference

        def counted(*a, **k):
            plain[0] += 1
            return ref_fn(*a, **k)
        # the main path: the eager forward, every launch count from 0
        self.zero_launches()
        fo._flash_fwd_reference = counted
        try:
            with torch.no_grad():
                want = net(torch.from_numpy(ids).cuda(),
                           torch.from_numpy(mask).cuda())
            torch.cuda.synchronize()
        finally:
            fo._flash_fwd_reference = ref_fn
        launches = self.record_path("onnx_ernie")
        want = want.float().cpu().numpy()
        err, lim = self._onnx_gate("onnx_ernie", got, want)
        print(f"onnx (a) ERNIE-base [{B}, {S}] on {self.smi}: trace + write "
              f"{export_ms:.1f} ms, {size} bytes, {len(ops)} nodes "
              f"({ops.count('Softmax')} Softmax, {ops.count('Gemm')} Gemm, "
              f"{ops.count('MatMul')} MatMul), {flash} flash_fwd in the "
              f"trace; numpy eval {eval_s:.2f} s; logits max err {err:.3e} "
              f"(limit {lim:.3e}); eager K2 launches "
              f"{launches['flash_fwd']}, plain {plain[0]}")
        self.details["onnx_ernie"] = dict(
            export_ms=export_ms, bytes=size, nodes=len(ops),
            flash_nodes=flash, eval_s=eval_s, err=err, limit=lim,
            k2=launches["flash_fwd"], plain=plain[0])
        assert flash == L, (flash, L)
        assert not [o for o in ops if "flash" in o.lower()], ops
        assert launches["flash_fwd"] == L and plain[0] == 0, (
            launches, plain[0])
        del net, model
        torch.cuda.empty_cache()

    def onnx_resnet(self, wd):
        """(b) resnet50(num_classes=1000), seed 0, eval, its BatchNorm
        running buffers from export_resnet's seeded draw, on the card,
        exported at [ONNX["RESNET_B"], 3, 224, 224]. Gates: 53 Conv and
        53 BatchNormalization nodes, every state_dict tensor its
        initializer bit for bit, the numpy evaluation within
        EXPORT_TOL["float32"] x max(1, max |logit|) of eager on the card
        (the path "onnx_resnet": no kernel launched)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import nn
        from paddle_tpu_torch.static import InputSpec
        from paddle_tpu_torch.vision.models import resnet50
        B, side = ONNX["RESNET_B"], RESNET_A["SIDE"]
        net = resnet50(num_classes=1000, device="cuda", seed=0).eval()
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, nn.BatchNorm2D):
                    m._mean.copy_(torch.randn(m._mean.shape, generator=g)
                                  * 0.1)
                    m._variance.copy_(torch.rand(m._variance.shape,
                                                 generator=g) + 0.5)
        _, path, export_ms = self._onnx_export(
            net, [InputSpec([B, 3, side, side], "float32", "img")],
            os.path.join(wd, "resnet50"))
        size = os.path.getsize(path)
        model, ops = self._onnx_model(path, net.state_dict())
        x = np.random.RandomState(0).standard_normal(
            (B, 3, side, side)).astype(np.float32)
        t0 = time.perf_counter()
        got = model.run({"img": x})[0]
        eval_s = time.perf_counter() - t0
        self.zero_launches()
        with torch.no_grad():
            want = net(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        launches = self.record_path("onnx_resnet")
        want = want.cpu().numpy()
        err, lim = self._onnx_gate("onnx_resnet", got, want)
        print(f"onnx (b) ResNet-50 [{B}, 3, {side}, {side}] on {self.smi}: "
              f"trace + write {export_ms:.1f} ms, {size} bytes, "
              f"{len(ops)} nodes ({ops.count('Conv')} Conv, "
              f"{ops.count('BatchNormalization')} BatchNormalization); "
              f"numpy eval {eval_s:.2f} s; logits max err {err:.3e} "
              f"(limit {lim:.3e}); launches {launches}")
        self.details["onnx_resnet"] = dict(
            export_ms=export_ms, bytes=size, nodes=len(ops), eval_s=eval_s,
            err=err, limit=lim)
        assert ops.count("Conv") == 53 and \
            ops.count("BatchNormalization") == 53, ops
        assert not any(launches.values()), launches
        del net, model
        torch.cuda.empty_cache()

    def onnx_capi_start(self, wd):
        """(c), its first half: nn.TransformerEncoder at ERNIE-base width
        (12 layers of TransformerEncoderLayer(768, 12, 3072, dropout 0)),
        seed 0, eval, on the card, saved by jit.save with
        InputSpec([None, 512, 768]) (the program holds K2); the port's C
        library built by g++ (inference.capi.build()), a C program built
        by gcc and started: it makes its predictor through
        PD_NewPredictor (card 0) and tries PD_NewPredictorWithDevice(
        prefix, 7), then waits for the go file. Returns its state."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import jit, nn
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.inference import capi
        from paddle_tpu_torch.static import InputSpec
        S, H, rows, runs = ERNIE_SERVE["S"], 768, ONNX["CAPI_ROWS"], \
            ONNX["CAPI_RUNS"]
        frandom.seed(0)
        torch.manual_seed(0)
        layer = nn.TransformerEncoderLayer(H, 12, 3072, dropout=0.0,
                                           device="cuda")
        net = nn.TransformerEncoder(layer, 12).eval()
        st = dict(prefix=os.path.join(wd, "encoder"),
                  go=os.path.join(wd, "go"),
                  out_file=os.path.join(wd, "out.bin"))
        t0 = time.perf_counter()
        jit.save(net, st["prefix"], input_spec=[InputSpec([None, S, H],
                                                          "float32")])
        st["save_s"] = time.perf_counter() - t0
        del net, layer
        torch.cuda.empty_cache()
        st["x"] = np.random.RandomState(1).standard_normal(
            (rows, S, H)).astype(np.float32)
        t0 = time.perf_counter()
        lib = capi.build()
        st["build_s"] = time.perf_counter() - t0
        src = os.path.join(wd, "capi_driver.c")
        with open(src, "w") as f:
            f.write(CAPI_DRIVER)
        exe = os.path.join(wd, "capi_driver")
        t0 = time.perf_counter()
        subprocess.run(["gcc", "-O2", src, "-o", exe, f"-I{capi.CSRC}",
                        f"-L{lib.parent}", "-lpd_infer_capi",
                        f"-Wl,-rpath,{lib.parent}"], check=True)
        st["link_s"] = time.perf_counter() - t0
        in_file = os.path.join(wd, "in.bin")
        st["x"].tofile(in_file)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        st["t0"] = time.perf_counter()
        st["proc"] = subprocess.Popen(
            [exe, st["prefix"], in_file, st["out_file"], str(runs),
             st["go"], "3", *map(str, st["x"].shape)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return st

    def onnx_capi(self, wd, st):
        """(c), its second half: the in-process create_predictor run of
        the same rows is the path "onnx_capi" (K2 12 times, the plain
        version 0 times); then the go file, and the C program's ONNX[
        "CAPI_RUNS"] + 1 runs: its output equals the in-process run
        within EXPORT_TOL["float32"] x max(1, max |ref|) (bit-equality
        printed), and its PD_NewPredictorWithDevice(prefix, 7) failed
        with a message while it went on. Printed: save, build and link
        s, the C process's predictor creation (made while (a) and (b)
        ran), first-run and steady ms a batch."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import inference
        from paddle_tpu_torch.ops import flash_ops as fo
        rows, S = st["x"].shape[:2]
        plain = [0]
        ref_fn = fo._flash_fwd_reference

        def counted(*a, **k):
            plain[0] += 1
            return ref_fn(*a, **k)
        self.zero_launches()
        fo._flash_fwd_reference = counted
        try:
            pred = inference.create_predictor(inference.Config(st["prefix"]))
            ref = pred.run([st["x"]])[0]
        finally:
            fo._flash_fwd_reference = ref_fn
        launches = self.record_path("onnx_capi")
        del pred
        torch.cuda.empty_cache()
        open(st["go"], "w").close()
        out, err_text = st["proc"].communicate(timeout=600)
        proc_s = time.perf_counter() - st["t0"]
        print(out, end="")
        assert st["proc"].returncode == 0, (st["proc"].returncode,
                                            err_text[-3000:])
        timing = dict(kv.split("=") for line in out.splitlines()
                      if line.startswith("CAPI ") for kv in line.split()[1:])
        with open(st["out_file"], "rb") as f:
            ondim = int(np.fromfile(f, dtype=np.int32, count=1)[0])
            oshape = np.fromfile(f, dtype=np.int64, count=ondim)
            got = np.fromfile(f, dtype=np.float32).reshape(oshape)
        err, lim = self._onnx_gate("onnx_capi", got, ref)
        bit_equal = bool(np.array_equal(got, ref))
        device7 = [ln for ln in out.splitlines() if ln.startswith("DEVICE7 ")]
        print(f"onnx (c) C API, TransformerEncoder 12 x 768 at [{rows}, "
              f"{S}, 768] on {self.smi}: jit.save {st['save_s']:.1f} s, "
              f"library build {st['build_s']:.1f} s, driver link "
              f"{st['link_s']:.2f} s, the C process {proc_s:.1f} s "
              f"(PD_NewPredictor {timing.get('new_ms')} ms, first run "
              f"{timing.get('first_ms')} ms, steady "
              f"{timing.get('steady_ms')} ms a batch of {rows}); output "
              f"max err {err:.3e} (limit {lim:.3e}), bit-equal "
              f"{bit_equal}; in-process K2 launches "
              f"{launches['flash_fwd']}, plain {plain[0]}; {device7}")
        self.details["onnx_capi"] = dict(
            save_s=st["save_s"], build_s=st["build_s"], link_s=st["link_s"],
            proc_s=proc_s, err=err, limit=lim, bit_equal=bit_equal,
            k2=launches["flash_fwd"], plain=plain[0],
            **{k: float(v) for k, v in timing.items()})
        assert launches["flash_fwd"] == 12 and plain[0] == 0, (
            launches, plain[0])
        assert len(device7) == 1 and device7[0].startswith(
            "DEVICE7 failed UnavailableError:"), device7

    # -- phase store: the program store, the build cache, cpp_extension -------

    def store(self):
        """The serving program store across processes, the kernel build
        cache and `utils.cpp_extension` on the card (see the module
        docstring): (b) processes A (empty store; also (a): a seeded
        build cache, no nvcc) and B (warm) against an in-process
        store-off engine; (c) a tampered manifest; (d) host ops."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch.ops import _build, flash_ops, paged_ops
        from paddle_tpu_torch.serving import GenerationEngine
        self.gpt = None
        torch.cuda.empty_cache()
        wd = tempfile.mkdtemp(prefix="chip_smoke_store_")
        try:
            # (b) the store-off reference in this process
            gpt = _store_gpt(torch)
            prompts, new = _store_requests(np, gpt.gpt.config.vocab_size)
            t0 = time.perf_counter()
            eng = GenerationEngine(gpt, device="cuda", name="store_off",
                                   **_store_engine_kw(prompts, new))
            torch.cuda.synchronize()
            off_warm = (time.perf_counter() - t0) * 1e3
            self.zero_launches()
            off = [f.result(600).tolist() for f in
                   [eng.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, new)]]
            off_k1 = paged_ops.paged_attention.launches
            off_k2 = flash_ops.flash_attention_fwd.launches
            off_st = eng.stats()
            off_step = _store_decode_step(torch, eng)
            eng.shutdown()

            # (a) the build cache: phase 2's libraries copied into a fresh
            # directory, which process A takes through the flag
            cc = os.path.join(wd, "cc")
            os.makedirs(cc)
            libs = sorted(_build.build_dir().glob("*.so"))
            for p in libs:
                shutil.copy2(p, cc)
            ka = self.store_worker(wd, "a", FLAGS_xla_compilation_cache_dir=cc)
            print(f"store (a) build cache on {self.smi}: {len(libs)} "
                  f"libraries copied to a fresh directory; process A served "
                  f"{len(prompts)} requests with {ka['nvcc']} nvcc runs, "
                  f"loading {ka['libs']}; cache dir {ka['cache_dir']}")
            assert ka["nvcc"] == 0 and ka["cache_dir"] == cc, ka
            assert ka["libs"] and all(p.startswith(cc + os.sep)
                                      for p in ka["libs"]), ka["libs"]
            assert ka["weights"] == _store_checksum(gpt), "weights differ"
            kb = self.store_worker(wd, "b")
            # the main path of this phase is B's serving, in its process
            self.path_launches["store"] = dict(
                {n: 0 for n in self._wrappers()}, paged_attention=kb["k1"],
                flash_fwd=kb["k2"])
            self.path_dtype_launches["store"] = {
                "paged_attention": {"float32": kb["k1"]},
                "flash_fwd": {"float32": kb["k2"]}}
            long_prefills = sum(1 for p in prompts if len(p) > 64)
            entries = ka["entries"]
            weight_bytes = min(t.numel() * t.element_size()
                               for t in gpt.parameters() if t.dim() == 2)
            print(f"store (b) on {self.smi}: warmup ms store off "
                  f"{off_warm:.1f} (this process), miss {ka['warm_ms']:.1f} "
                  f"(A, a fresh process), hit {kb['warm_ms']:.1f} (B, a "
                  f"fresh process); processes A {ka['proc_s']:.1f} s, B "
                  f"{kb['proc_s']:.1f} s; A compiles {ka['compiles']}, B "
                  f"compiles {kb['compiles']} loaded {kb['loaded']}; "
                  f"artifact bytes "
                  f"{ {n: e['bytes'] for n, e in entries.items()} }; B "
                  f"pack_load_ms {kb['pack_load_ms']}; K1 launches off "
                  f"{off_k1} / B {kb['k1']} ({kb['steps']} steps x 4), K2 "
                  f"off {off_k2} / B {kb['k2']} ({long_prefills} prefills "
                  f"in the 1024 bucket x 4); decode step off "
                  f"{off_step}, hit {kb['step']}")
            self.details["store"] = dict(
                off_warm_ms=off_warm, miss_warm_ms=ka["warm_ms"],
                hit_warm_ms=kb["warm_ms"], a_proc_s=ka["proc_s"],
                b_proc_s=kb["proc_s"],
                artifact_bytes={n: e["bytes"] for n, e in entries.items()},
                pack_load_ms=kb["pack_load_ms"], off_step=off_step,
                hit_step=kb["step"], k1=kb["k1"], k2=kb["k2"])
            assert ka["outputs"] == off and kb["outputs"] == off, \
                "store on and off disagree"
            assert set(ka["compiles"]) == set(off_st["compiles"]) \
                == set(entries), (ka["compiles"], entries)
            assert ka["loaded"] == {} and kb["compiles"] == {}
            assert set(kb["loaded"]) == set(ka["compiles"])
            assert all(v == "loaded" for v in kb["programs"].values())
            assert kb["key"] == ka["key"]
            assert kb["k1"] == 4 * kb["steps"] == off_k1, (kb, off_k1)
            assert kb["k2"] == 4 * long_prefills == off_k2, (kb, off_k2)
            assert all(e["bytes"] < weight_bytes for e in entries.values())
            for step in (off_step, kb["step"]):
                assert step["same_ptrs"] and step["wrote_in_place"], step
            assert kb["step"]["rise"] < off_step["rise"] + \
                off_step["pool_bytes"] / 2, (kb["step"], off_step)
            self.store_tamper(gpt, prompts, new, off, ka["key_dir"])
            self.store_cpp_extension(wd)
        finally:
            shutil.rmtree(wd, ignore_errors=True)

    def store_worker(self, wd, mode, **env):
        """One fresh process of phase store (`--store-worker`): its JSON
        report."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "--store-worker",
             mode, "--store-wd", wd],
            env=dict(os.environ, **env), capture_output=True, text=True,
            timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"store worker {mode} failed:\n"
                               f"{proc.stdout[-3000:]}{proc.stderr[-6000:]}")
        with open(os.path.join(wd, "report.json")) as f:
            rep = json.load(f)
        rep["proc_s"] = time.perf_counter() - t0
        return rep

    def store_tamper(self, gpt, prompts, new, off, key_dir):
        """(c) the decode entry's recorded in-place spec edited in the
        warm store's manifest: an engine in this process fails the
        self-check once, dumps one flight record, exports decode again
        and stays token-identical."""
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.profiler import flight_recorder
        from paddle_tpu_torch.serving import GenerationEngine
        from paddle_tpu_torch.serving.program_store import read_manifest
        mf = read_manifest(key_dir)
        name = f"decode[m={STORE['SLOTS']}]"
        mf["programs"][name]["alias"] = "99:args_9"
        with open(os.path.join(key_dir, "manifest.json"), "w") as f:
            json.dump(mf, f)
        fails = monitor.stat_get("STAT_pack_selfcheck_failures")
        dumps = len(flight_recorder.dump_records())
        t0 = time.perf_counter()
        eng = GenerationEngine(gpt, device="cuda", name="store_tamper",
                               program_store=os.path.dirname(key_dir),
                               **_store_engine_kw(prompts, new))
        warm = (time.perf_counter() - t0) * 1e3
        outs = [f.result(600).tolist() for f in
                [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, new)]]
        st = eng.stats()
        eng.shutdown()
        recs = [r["reason"] for r in flight_recorder.dump_records()[dumps:]]
        fails = monitor.stat_get("STAT_pack_selfcheck_failures") - fails
        print(f"store (c) tampered {name}: self-check failures {fails}, "
              f"flight records {recs}, compiles {st['compiles']}, loaded "
              f"{st['loaded']}, warmup {warm:.1f} ms on {self.smi}")
        assert fails == 1 and recs.count("program_store_selfcheck") == 1
        assert st["compiles"] == {name: 1}, st["compiles"]
        assert outs == off, "the fallback changed the tokens"

    def store_cpp_extension(self, wd):
        """(d) `utils.cpp_extension` on CUDA tensors: the reference test's
        double_op built with g++ (its gradient symbol too) and a
        load_op_from_callable square, 1M floats, outputs on the card."""
        torch = self.torch
        from paddle_tpu_torch.utils import cpp_extension
        src = os.path.join(wd, "double_op.cc")
        with open(src, "w") as f:
            f.write(CPP_DOUBLE_OP)
        t0 = time.perf_counter()
        op = cpp_extension.load("double_op", [src],
                                grad_symbol="double_op_grad",
                                build_directory=os.path.join(wd, "ext"))
        build_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(1 << 20, device="cuda", generator=g,
                        requires_grad=True)
        y = op(x)
        y.sum().backward()
        sq = cpp_extension.load_op_from_callable(
            "sq", lambda a: a ** 2, lambda s: s,
            bwd=lambda gr, a: (2 * a * gr,))
        x2 = x.detach().clone().requires_grad_(True)
        y2 = sq(x2)
        y2.sum().backward()
        with torch.no_grad():
            op(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                op(x)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 10
        print(f"store (d) cpp_extension on {self.smi}: g++ build "
              f"{build_s:.2f} s; double_op on 1M floats {ms:.2f} ms a call "
              f"(host round trip included); output on {y.device}, exact "
              f"2x {bool(torch.equal(y, x.detach() * 2))}, grad 2 "
              f"{bool((x.grad == 2).all())}; square's grad 2x "
              f"{bool(torch.equal(x2.grad, 2 * x2.detach()))}")
        self.details["store_cpp_extension"] = dict(build_s=build_s, ms=ms)
        assert y.is_cuda and y2.is_cuda and x.grad.is_cuda
        assert torch.equal(y, x.detach() * 2)
        assert bool((x.grad == 2).all())
        assert torch.equal(x2.grad, 2 * x2.detach())
        assert torch.equal(y2, x2.detach() ** 2)

    def api(self):
        """(a) every dense op family of the top-level API on the card
        against the same call on the CPU; (b) the 8-expert MoE GPT at
        GPT-2 small width trained through paddle_tpu_torch.Model in fp32
        and O1, with its flash-vs-plain step parity; (c) paddle.save /
        load of its state on the card (see the module docstring)."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        self.api_ops()
        self.api_moe()

    def api_ops(self):
        """(a) Each family's every name: exact for creation, manipulation
        (tensordot, a product, within API_TOL["product"]), logic and
        search; reductions within API_TOL["reduction"] x max(1, |ref|);
        linalg within API_TOL["linalg"] on invariants (reconstructions,
        singular and eigen values, residuals: cuSOLVER and LAPACK may
        pick other signs); ops.legacy within API_TOL["legacy"];
        extra_ops and vision.ops within 1e-5 (the NMS family's indices,
        labels and counts exactly); random ops on shape, type, range and
        replay (seed twice, set_rng_state(get_rng_state())). A family
        with a name of its module's __all__ and no case fails."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        cases = _api_cases()
        tols = _api_tols()
        results = {}
        for fam, table in cases.items():
            mod = paddle.vision.ops if fam == "vision_ops" else \
                getattr(paddle.ops, fam)
            names = {n.split("#")[0] for n in table}
            own = set(mod.__all__) - _api_not_own(paddle, fam)
            missing = sorted(own - names)
            misses, worst = [], 0.0
            for name, fn in table.items():
                try:
                    err = _api_compare(torch, np, paddle, fam, name, fn,
                                       tols)
                    worst = max(worst, err)
                except Exception as e:  # noqa: BLE001 — listed, then fail
                    misses.append(f"{name}: {type(e).__name__}: {e}")
            held = len(table) - len(misses)
            results[fam] = dict(names=len(names), cases=len(table),
                                held=held, misses=misses + missing,
                                worst=worst)
            print(f"api (a) {fam} on {self.smi}: {len(names)} names of "
                  f"{len(own)} (without a case: {missing}), "
                  f"{len(table)} cases, held {held}, worst err/limit "
                  f"{worst:.3e}, misses {misses}")
        self.details["api_ops"] = results
        bad = {f: r["misses"] for f, r in results.items() if r["misses"]}
        assert not bad, bad
        self.api_random()

    def api_random(self):
        """(a) The random ops on the card: shape, type and range of each,
        and its replay after seed(s) twice and after
        set_rng_state(get_rng_state()); a flash dropout seed replays
        too."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.framework import random as frandom
        paddle.set_device("gpu")
        d = _api_inputs(np, paddle, "cuda")
        held, misses = 0, []
        for name, (fn, lo, hi, dtype) in _api_random_cases(d).items():
            try:
                out = fn(paddle)
                assert out.device.type == "cuda", out.device
                assert str(out.dtype) == f"torch.{dtype}", out.dtype
                v = out.float()
                assert float(v.min()) >= lo and float(v.max()) <= hi, (
                    float(v.min()), float(v.max()))
                paddle.seed(11)
                a = fn(paddle)
                paddle.seed(11)
                b = fn(paddle)
                assert torch.equal(a, b), "seed replay"
                st = paddle.get_rng_state()
                a = fn(paddle)
                paddle.set_rng_state(st)
                assert torch.equal(a, fn(paddle)), "state replay"
                held += 1
            except Exception as e:  # noqa: BLE001 — listed, then fail
                misses.append(f"{name}: {type(e).__name__}: {e}")
        st = paddle.get_rng_state()
        s1 = frandom.next_seed("cuda")
        paddle.set_rng_state(st)
        if frandom.next_seed("cuda") != s1:
            misses.append("flash dropout seed does not replay")
        names = {n.split("#")[0] for n in _api_random_cases(d)}
        missing = sorted(set(paddle.ops.random_ops.__all__) - names)
        print(f"api (a) random_ops on {self.smi}: "
              f"{len(names)} names of "
              f"{len(paddle.ops.random_ops.__all__)}, held {held}, misses "
              f"{misses + missing}")
        self.details["api_random"] = dict(held=held,
                                          misses=misses + missing)
        assert not misses and not missing, misses + missing

    def _moe_model(self, dropout):
        """The 8-expert MoE GPT at GPT-2 small width, written as a user
        writes it (seed 0, the default device: the card)."""
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models import GPTForCausalLM
        paddle.set_device("gpu")
        paddle.seed(0)
        return GPTForCausalLM(_moe_config(dropout))

    def api_moe(self):
        """(b) The MoE GPT through paddle_tpu_torch.Model: MOE["STEPS"]
        fit steps in fp32, then the same from the same weights under
        prepare(amp_configs="O1") (bf16): the loss finite and falling, K2,
        K3 and K4 launched 12 times a step, the plain attention 0 times;
        wall and device ms a step (torch.profiler), peak allocated bytes.
        Then the flash-vs-plain step parity and (c) save / load."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.nn.functional import attention
        B, S, steps = MOE["B"], MOE["S"], MOE["STEPS"]
        rng = np.random.RandomState(0)
        motifs = [rng.randint(0, 4096, size=rng.randint(3, 9))
                  for _ in range(64)]
        ids = np.stack([np.resize(motifs[rng.randint(64)], S + 1)
                        for _ in range(B * steps)]).astype(np.int64)
        paddle.set_device("gpu")
        batches = [[paddle.to_tensor(ids[i:i + B, :-1]),
                    paddle.to_tensor(ids[i:i + B, 1:])]
                   for i in range(0, B * steps, B)]
        assert batches[0][0].dtype == torch.int32 and \
            batches[0][0].device.type == "cuda"
        plain = [0]
        ref = attention._sdpa_ref

        def counted(*a, **k):
            plain[0] += 1
            return ref(*a, **k)
        for level in (None, "O1"):
            path = "api_moe" if level is None else "api_moe_amp"
            net = self._moe_model(MOE["DROPOUT"])
            n_params = sum(p.numel() for p in net.parameters())
            n_expert = sum(p.numel() for n, p in net.named_parameters()
                           if n.endswith(("w_up", "w_down")))
            opt = paddle.optimizer.AdamW(learning_rate=MOE["LR"],
                                         weight_decay=0.01)
            model = paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss(),
                                              amp_configs=level)

            class Steps(paddle.hapi.callbacks.Callback):
                def __init__(self):
                    super().__init__()
                    self.losses, self.events = [], []

                def on_train_batch_end(self, step, logs=None):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.events.append(ev)
                    self.losses.append(logs["loss"])
            rec = Steps()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path starts here: every launch count from 0
            self.zero_launches()
            plain[0] = 0
            attention._sdpa_ref = counted
            try:
                t0 = time.perf_counter()
                model.fit(batches, epochs=1, log_freq=steps, verbose=0,
                          callbacks=[rec])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                attention._sdpa_ref = ref
            launches = self.record_path(path)
            by_dtype = self.path_dtype_launches[path]
            peak = torch.cuda.max_memory_allocated()
            losses = [float(x) for x in rec.losses]
            step_ms = [a.elapsed_time(b) for a, b in zip(rec.events,
                                                         rec.events[1:])]
            p50 = sorted(step_ms)[len(step_ms) // 2]
            label = "fp32" if level is None else "O1 bf16"
            cfg = net.gpt.config
            print(f"{path} on {self.smi}: MoE GPT ({cfg.num_experts} "
                  f"experts, hidden {cfg.hidden_size}, {cfg.num_layers} "
                  f"layers, {n_params / 1e6:.1f} M "
                  f"parameters, {n_expert / 1e6:.1f} M in experts) {label}"
                  f", batch {B} x {S}, {steps} steps in {wall:.2f} s wall "
                  f"(first step included); step p50 {p50:.1f} ms (device "
                  f"timeline, steps 2-{steps}); peak allocated "
                  f"{peak / 2**30:.2f} GiB; plain attention calls "
                  f"{plain[0]}; launches fwd {launches['flash_fwd']} dq "
                  f"{launches['flash_bwd_dq']} dkv "
                  f"{launches['flash_bwd_dkv']}, by type "
                  f"{by_dtype['flash_fwd']}")
            print(f"{path} per-step loss: " + " ".join(f"{x:.4f}"
                                                       for x in losses))
            self.details[path] = dict(
                losses=losses, step_ms=step_ms, step_ms_p50=p50,
                wall_s=wall, peak_bytes=peak, params=n_params,
                expert_params=n_expert, launches=launches,
                launches_by_dtype=by_dtype, plain_calls=plain[0])
            assert all(np.isfinite(losses)), "non-finite MoE loss"
            assert np.mean(losses[-2:]) < losses[0] - MOE["FALL"], \
                "the MoE loss did not fall"
            dtype = "float32" if level is None else "bfloat16"
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                assert launches[name] == 12 * steps, \
                    f"{name} launched {launches[name]} times, expected " \
                    f"12 x {steps}"
                assert by_dtype[name] == {dtype: 12 * steps}, by_dtype[name]
            assert plain[0] == 0, f"plain attention ran {plain[0]} times"
            self.profile_train_step(model, batches[0][:1], batches[0][1:],
                                    path)
            del model, net, opt
            torch.cuda.empty_cache()
        self.api_moe_parity()

    def api_moe_parity(self):
        """(b) One train_batch (update=False) of the MoE GPT (dropout 0)
        through the flash kernels against one through
        FLAGS_use_flash_attention=False, fp32, [2, 1024], phase 6's
        limits. A hard top-1 gate may route a token differently where the
        two paths round differently: every such flip must be a near-tie
        (top-2 gate probability gap < NEAR_TIE), and the gradients are
        held on the first of MOE["PARITY_SEEDS"]' batches that routes
        every token alike (the flips of the others printed). Then (c):
        paddle.save(net.state_dict()), a fresh model (another seed) and
        set_state_dict(paddle.load(...)): the eval loss on one batch
        equals the first model's bit for bit."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.framework.flags import set_flags
        net = self._moe_model(0.0)
        opt = paddle.optimizer.AdamW(1e-4)
        model = paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss())
        routes = []
        hooks = [blk.mlp.register_forward_hook(
            lambda m, i, o: routes.append(torch.softmax(
                torch.nn.functional.linear(i[0], m.gate.weight,
                                           m.gate.bias), -1).detach()))
                 for blk in net.gpt.blocks]

        def one(ids):
            routes.clear()
            self.zero_launches()
            (lv,), _ = model.train_batch([ids[:, :-1]], [ids[:, 1:]],
                                         update=False)
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            opt.clear_grad()
            return float(lv), grads, self.read_launches(), list(routes)

        held, flips_seen = None, []
        try:
            for seed in MOE["PARITY_SEEDS"]:
                ids = paddle.to_tensor(np.random.RandomState(seed).randint(
                    0, net.gpt.config.vocab_size, size=(2, 1025)))
                lf, gf, nf, rf = one(ids)
                set_flags({"FLAGS_use_flash_attention": False})
                try:
                    lp, gp, np_, rp = one(ids)
                finally:
                    set_flags({"FLAGS_use_flash_attention": True})
                flips, gaps = 0, []
                for a, b in zip(rf, rp):
                    ea, eb = a.argmax(-1), b.argmax(-1)
                    top2 = b.topk(2, -1).values
                    gap = (top2[..., 0] - top2[..., 1])[ea != eb]
                    flips += int((ea != eb).sum())
                    gaps += gap.tolist()
                flips_seen.append((seed, flips, max(gaps, default=0.0)))
                assert all(g < NEAR_TIE for g in gaps), (seed, gaps)
                L = 12
                assert (nf["flash_fwd"], nf["flash_bwd_dq"],
                        nf["flash_bwd_dkv"]) == (L, L, L), nf
                assert (np_["flash_fwd"], np_["flash_bwd_dq"],
                        np_["flash_bwd_dkv"]) == (0, 0, 0), np_
                if flips == 0:
                    held = (seed, lf, lp, gf, gp)
                    break
        finally:
            for h in hooks:
                h.remove()
        print(f"api (b) MoE step parity [2,1024] dropout 0: routing flips "
              f"(seed, flips, largest gap) {flips_seen}")
        assert held is not None, f"every parity batch flipped: {flips_seen}"
        seed, lf, lp, gf, gp = held
        floor = 1e-6 * max(g.abs().max().item() for g in gp.values())
        worst = max(((gf[n] - gp[n]).abs().max().item()
                     / (1e-3 * gp[n].abs().max().item() + floor), n)
                    for n in gp)
        print(f"api (b) MoE step parity, batch seed {seed}: loss flash "
              f"{lf:.6f} plain {lp:.6f}; worst gradient max_abs_err / its "
              f"tolerance {worst[0]:.3e} ({worst[1]})")
        self.details["api_moe_parity"] = dict(
            loss_flash=lf, loss_plain=lp, worst_grad_over_tol=worst[0],
            worst_param=worst[1], flips=flips_seen)
        assert abs(lf - lp) <= 1e-5 * abs(lp), "MoE step-parity loss"
        assert worst[0] <= 1.0, f"MoE step-parity gradient {worst[1]}"
        self.api_save_load(model, net)

    def api_save_load(self, model, net):
        """(c) paddle.save / paddle.load on the card (see api_moe_parity)."""
        torch = self.torch
        import shutil
        import tempfile
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.framework import io_state
        from paddle_tpu_torch.models import GPTForCausalLM
        ids = paddle.to_tensor(np.random.RandomState(9).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))
        with torch.no_grad():
            want, _ = model.eval_batch([ids[:, :-1]], [ids[:, 1:]])
        d = tempfile.mkdtemp(prefix="chip_smoke_api_")
        try:
            path = os.path.join(d, "moe.pdparams")
            t0 = time.perf_counter()
            paddle.save(net.state_dict(), path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            fresh = GPTForCausalLM(_moe_config(0.0), seed=5)
            t0 = time.perf_counter()
            io_state.set_state_dict(fresh, paddle.load(path))
            load_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        m2 = paddle.Model(fresh).prepare(loss=paddle.nn.CrossEntropyLoss())
        with torch.no_grad():
            got, _ = m2.eval_batch([ids[:, :-1]], [ids[:, 1:]])
        want, got = float(want), float(got)
        print(f"api (c) paddle.save / load on {self.smi}: "
              f"{size / 2**30:.2f} GiB in {save_s:.2f} s, loaded onto a "
              f"fresh model in {load_s:.2f} s; eval loss {want!r} before, "
              f"{got!r} after")
        self.details["api_save_load"] = dict(bytes=size, save_s=save_s,
                                             load_s=load_s, loss=want,
                                             loss_loaded=got)
        assert got == want, (got, want)
        del fresh, m2, model, net
        torch.cuda.empty_cache()

    # -- 12. seq2seq ------------------------------------------------------------

    def seq2seq(self):
        """(a) every name this slice adds on the card against the CPU; (b)
        the attention LSTM seq2seq at IWSLT'15 width trained through
        paddle_tpu_torch.Model and beam-decoded; (c) its step parity (see
        the module docstring)."""
        self.torch.cuda.empty_cache()
        self.seq2seq_ops()
        net = self.seq2seq_fit()
        self.seq2seq_decode(net)
        del net
        self.torch.cuda.empty_cache()
        self.seq2seq_parity()

    def seq2seq_ops(self):
        """(a) Each group's cases (`_s2s_cases`) on the card against the
        CPU (`_card_vs_cpu`), the "stat" ones on the card alone; a name
        of a group's modules with no case fails, as in phase 11 (a)."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        groups = _s2s_groups(paddle)
        results = {}
        for group, table in _s2s_cases().items():
            names = {n.split("#")[0] for n in table}
            missing = sorted(set(groups[group]) - names)
            misses, worst = [], 0.0
            for name, (fn, tol) in table.items():
                try:
                    if tol == "stat":
                        paddle.set_device("gpu")
                        fn(paddle, _s2s_inputs(np, paddle, "cuda"))
                        continue
                    worst = max(worst, _card_vs_cpu(
                        torch, np, paddle, fn, S2S_TOL.get(tol),
                        _s2s_inputs))
                except Exception as e:  # noqa: BLE001 — listed, then fail
                    misses.append(f"{name}: {type(e).__name__}: {e}")
            paddle.set_device("gpu")
            held = len(table) - len(misses)
            results[group] = dict(names=len(names), cases=len(table),
                                  held=held, misses=misses + missing,
                                  worst=worst)
            print(f"seq2seq (a) {group} on {self.smi}: {len(names)} names "
                  f"of {len(groups[group])} (without a case: {missing}), "
                  f"{len(table)} cases, held {held}, worst err/limit "
                  f"{worst:.3e}, misses {misses}")
        self.details["seq2seq_ops"] = results
        bad = {g: r["misses"] for g, r in results.items() if r["misses"]}
        assert not bad, bad

    def _seq2seq_model(self, dropout):
        """The seq2seq at SEQ2SEQ's width, written as a user writes it
        (seed 0, the default device: the card)."""
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models.seq2seq import seq2seq_attn
        c = SEQ2SEQ
        paddle.set_device("gpu")
        paddle.seed(0)
        return seq2seq_attn(src_vocab=c["SRC"], trg_vocab=c["TRG"],
                            hidden=c["HIDDEN"], num_layers=c["LAYERS"],
                            dropout=dropout, init_scale=c["INIT"])

    def _seq2seq_prepared(self, net):
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models.seq2seq import seq2seq_criterion
        spec = paddle.static.InputSpec
        model = paddle.Model(net, inputs=[spec([None, None], "int32")] * 3,
                             labels=[spec([None, None], "int32")] * 2)
        opt = paddle.optimizer.Adam(
            SEQ2SEQ["LR"],
            grad_clip=paddle.nn.ClipGradByGlobalNorm(SEQ2SEQ["CLIP"]))
        return model.prepare(opt, seq2seq_criterion())

    def seq2seq_fit(self):
        """(b) SEQ2SEQ["STEPS"] fit steps at batch 128 of seeded reversal
        batches (lengths 5-50): the loss finite and falling, K1-K7 and
        the plain attention never run; step p50 on the device timeline,
        target tokens/s, peak allocated bytes, one step profiled."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models.seq2seq import reversal_batch
        from paddle_tpu_torch.nn.functional import attention
        c = SEQ2SEQ
        net = self._seq2seq_model(c["DROPOUT"])
        n_params = sum(p.numel() for p in net.parameters())
        rng = np.random.RandomState(0)
        batches, tokens = [], []
        for _ in range(c["STEPS"]):
            arrays = reversal_batch(rng, c["B"], c["SRC"], c["TRG"],
                                    c["MIN_LEN"], c["MAX_LEN"])
            batches.append([paddle.to_tensor(a) for a in arrays])
            tokens.append(int(arrays[4].sum()))
        assert batches[0][0].device.type == "cuda"
        model = self._seq2seq_prepared(net)
        rec = self._step_recorder()
        plain = [0]
        ref = attention._sdpa_ref

        def counted(*a, **k):
            plain[0] += 1
            return ref(*a, **k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        attention._sdpa_ref = counted
        try:
            t0 = time.perf_counter()
            model.fit(batches, epochs=1, log_freq=c["STEPS"], verbose=0,
                      callbacks=[rec])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            attention._sdpa_ref = ref
        launches = self.record_path("seq2seq")
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in rec.losses]
        n, window, p50, gaps = self._step_times(rec)
        tok_s = sum(tokens[2:]) / (window / 1e3)
        print(f"seq2seq (b) on {self.smi}: attention LSTM seq2seq "
              f"(vocab {c['SRC']}/{c['TRG']}, {c['LAYERS']} x "
              f"{c['HIDDEN']}, {n_params / 1e6:.2f} M parameters), batch "
              f"{c['B']}, {c['STEPS']} steps in {wall:.2f} s wall (first "
              f"step included); step p50 {p50:.2f} ms (device timeline, "
              f"steps 3-{c['STEPS']}); {tok_s:.1f} target tokens/s over "
              f"the window ({sum(tokens[2:])} tokens in {window:.1f} ms); "
              f"peak allocated {peak / 2**30:.3f} GiB; plain attention "
              f"calls {plain[0]}; launches {launches}")
        print("seq2seq per-step loss: " + " ".join(f"{x:.4f}"
                                                   for x in losses))
        self.details["seq2seq_fit"] = dict(
            losses=losses, step_ms=gaps, step_ms_p50=p50, wall_s=wall,
            window_ms=window, target_tokens=tokens,
            target_tokens_per_s=tok_s, peak_bytes=peak, params=n_params,
            launches=launches, plain_calls=plain[0])
        assert all(np.isfinite(losses)), "non-finite seq2seq loss"
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            "the seq2seq loss did not fall"
        assert not any(launches.values()), launches
        assert plain[0] == 0, f"plain attention ran {plain[0]} times"
        self.profile_train_step(model, batches[0][:3], batches[0][3:],
                                "seq2seq")
        return net

    def seq2seq_decode(self, net):
        """(b) Beam search of DECODE_ROWS held-out sources on the card and
        on the CPU (the same weights): scores sorted, every sequence ends
        in EOS or at the step limit, ids equal up to near-ties (each row's
        first differing pick between totals within NEAR_TIE)."""
        torch = self.torch
        import copy
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.models.seq2seq import EOS, reversal_batch
        from paddle_tpu_torch.nn import decode
        c = SEQ2SEQ
        src, sl = reversal_batch(np.random.RandomState(1), c["DECODE_ROWS"],
                                 c["SRC"], c["TRG"], c["MIN_LEN"],
                                 c["MAX_LEN"])[:2]
        limit = 2 * src.shape[1]
        seen = []
        finalize = decode.BeamSearchDecoder.finalize

        def recording(dec, outputs, states, lengths):
            seen.append([tuple(t.cpu() for t in o) for o in outputs])
            return finalize(dec, outputs, states, lengths)

        def run(model, device):
            paddle.set_device(device)
            args = [paddle.to_tensor(a) for a in (src, sl)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, scores = model.beam_search(*args, beam_size=c["BEAM"],
                                            max_step_num=limit)
            torch.cuda.synchronize()
            return ids.cpu(), scores.cpu(), time.perf_counter() - t0
        net.eval()
        cpu = copy.deepcopy(net).to("cpu")
        decode.BeamSearchDecoder.finalize = recording
        try:
            ids, scores, wall = run(net, "gpu")
            cids, cscores, cwall = run(cpu, "cpu")
        finally:
            decode.BeamSearchDecoder.finalize = finalize
            paddle.set_device("gpu")
        steps = ids.shape[0]
        assert ids.shape[1:] == (c["DECODE_ROWS"], c["BEAM"]), ids.shape
        assert bool((scores[:, :-1] >= scores[:, 1:]).all()), "unsorted"
        ended = (ids == EOS).any(0)
        assert steps == limit or bool(ended.all()), "a beam never ended"
        flips, same_rows = [], 0
        gsteps, csteps = seen
        for b in range(c["DECODE_ROWS"]):
            first = None
            for t in range(min(len(gsteps), len(csteps))):
                gt, gp, gv = (x[b] for x in gsteps[t])
                ct, cp, cv = (x[b] for x in csteps[t])
                diff = ((gt != ct) | (gp != cp)).nonzero()
                if len(diff):
                    k = int(diff[0])
                    first = (t, k, abs(float(gv[k]) - float(cv[k])))
                    break
            if first is None:
                same_rows += 1
                assert torch.equal(ids[:, b], cids[:, b]), b
                continue
            flips.append((b,) + first)
        ms_step = wall * 1e3 / steps
        print(f"seq2seq (b) beam search on {self.smi}: {c['DECODE_ROWS']} "
              f"sources (lengths {int(sl.min())}-{int(sl.max())}), beam "
              f"{c['BEAM']}, limit {limit}: {steps} steps in "
              f"{wall * 1e3:.1f} ms ({ms_step:.2f} ms a step, "
              f"{c['DECODE_ROWS'] / wall:.1f} sentences/s; the CPU decode "
              f"{cwall * 1e3:.1f} ms); beams ended in EOS "
              f"{int(ended.sum())} of {ended.numel()}; rows identical to "
              f"the CPU decode {same_rows}, first flips (row, step, rank, "
              f"score gap) {flips}")
        self.details["seq2seq_decode"] = dict(
            steps=steps, limit=limit, wall_ms=wall * 1e3, ms_per_step=ms_step,
            sentences_per_s=c["DECODE_ROWS"] / wall, cpu_wall_ms=cwall * 1e3,
            ended=int(ended.sum()), same_rows=same_rows, flips=flips)
        assert all(gap < NEAR_TIE for _, _, _, gap in flips), flips

    def seq2seq_parity(self):
        """(c) One train_batch (update=False) at batch PARITY_B, dropout 0,
        on the card against the port's CPU step on the same weights: the
        loss to rtol 1e-5, every gradient within phase 6's fp32 limits
        (1e-3 x its largest + 1e-6 x the model's largest)."""
        torch = self.torch
        import copy
        import numpy as np
        from paddle_tpu_torch.models.seq2seq import reversal_batch
        c = SEQ2SEQ
        net = self._seq2seq_model(0.0)
        cpu = copy.deepcopy(net).to("cpu")
        arrays = reversal_batch(np.random.RandomState(2), c["PARITY_B"],
                                c["SRC"], c["TRG"], c["MIN_LEN"],
                                c["MAX_LEN"])
        out = []
        for m in (net, cpu):
            model = self._seq2seq_prepared(m)
            (lv,), _ = model.train_batch(
                [torch.from_numpy(a) for a in arrays[:3]],
                [torch.from_numpy(a) for a in arrays[3:]], update=False)
            out.append((float(lv), {n: p.grad.detach().cpu()
                                    for n, p in m.named_parameters()}))
        (lg, gg), (lc, gc) = out
        floor = 1e-6 * max(g.abs().max().item() for g in gc.values())
        worst = max(((gg[n] - gc[n]).abs().max().item()
                     / (1e-3 * gc[n].abs().max().item() + floor), n)
                    for n in gc)
        print(f"seq2seq (c) step parity on {self.smi}, batch "
              f"{c['PARITY_B']}: loss card {lg!r} CPU {lc!r}; worst "
              f"gradient max_abs_err / its tolerance {worst[0]:.3e} "
              f"({worst[1]})")
        self.details["seq2seq_parity"] = dict(
            loss_card=lg, loss_cpu=lc, worst_grad_over_tol=worst[0],
            worst_param=worst[1])
        assert abs(lg - lc) <= 1e-5 * abs(lc), "seq2seq step-parity loss"
        assert worst[0] <= 1.0, f"seq2seq step-parity gradient {worst[1]}"
        del net, cpu

    # -- 13. input ------------------------------------------------------------

    def input(self):
        """ResNet-50 trained from host-prepared images through worker
        processes and the DeviceFeeder (a), ERNIE-base on padded seq-512
        batches from worker processes (b); see the module docstring."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        ncpu = os.cpu_count()
        workers = max(1, min(8, ncpu - 2))
        print(f"input: os.cpu_count() {ncpu}, {workers} loader workers")
        self.details["input"] = dict(cpu_count=ncpu, workers=workers)
        self.input_resnet(workers)
        self.input_ernie()

    @staticmethod
    def _ring_names():
        """The /dev/shm names of the loaders' shared-memory rings."""
        return {n for n in os.listdir("/dev/shm") if n.startswith("ptt")}

    def _input_fit(self, arm, ds, workers, buffered, callbacks=()):
        """One `fit` epoch of a fresh ResNet-50 (seed 0, INPUT["B"], O1,
        Momentum, CrossEntropyLoss, Accuracy(topk=(1, 5))) over `ds`,
        shuffled, drop_last False, through DataLoader(num_workers=
        `workers`, use_buffer_reader=`buffered`), recording what the
        gates of `input_resnet` read. Returns the record."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, metric, nn, optimizer
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.profiler import tracer
        from paddle_tpu_torch.vision.models import resnet50
        B = INPUT["B"]
        frandom.seed(0)
        net = resnet50(num_classes=1000, device="cuda", seed=0)
        model = hapi.Model(net).prepare(
            optimizer.Momentum(RESNET_A["LR"]), nn.CrossEntropyLoss(),
            metric.Accuracy(topk=(1, 5)), amp_configs="O1")
        loader = io.DataLoader(ds, batch_size=B, shuffle=True,
                               drop_last=False, num_workers=workers,
                               use_buffer_reader=buffered)
        rows, feed = [], dict(wait=0.0, off_card=0, leaves=0)
        hook = net.register_forward_pre_hook(
            lambda m, i: rows.append(int(i[0].shape[0])))
        orig = model._buffered

        def watched(ld):
            src = orig(ld)

            class Watched:
                def __len__(self):
                    return len(src)

                def __iter__(self):
                    it = iter(src)
                    while True:
                        t0 = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        feed["wait"] += time.perf_counter() - t0
                        for x in batch:
                            feed["leaves"] += 1
                            feed["off_card"] += int(x.device.type != "cuda")
                        yield batch
            return Watched()
        model._buffered = watched
        rec = self._step_recorder()
        sizes = []

        class Sizes(hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                sizes.append(int(logs["batch_size"]))
        names = ("STAT_tail_pad_batches", "STAT_dataloader_batches",
                 "STAT_shm_slot_segments", "STAT_shm_slots_reused",
                 "STAT_smoke_input_samples", "STAT_device_feeder_batches",
                 "STAT_device_feeder_overlap", "STAT_train_host_syncs")
        before = {n: monitor.stat_get(n) for n in names}
        hist = monitor.histogram("smoke_input_sample_ms")
        h0 = (hist.count, hist.sum)
        rings = self._ring_names()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, log_freq=10, verbose=0,
                  callbacks=[rec, Sizes(), *callbacks])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path(arm)
        hook.remove()
        d = {n: monitor.stat_get(n) - before[n] for n in names}
        # where the host time went: the spans of the fit loop and the
        # feeder's thread, and the samples' transform time in whichever
        # process ran them (relayed from the workers)
        durs = {}
        for name, a, b in tracer.events(since=t0):
            if name in ("fit::train_step", "feeder::fetch",
                        "feeder::stage"):
                durs.setdefault(name, []).append((b - a) * 1e3)
        spans = {k: (len(v), sum(v), sorted(v)[len(v) // 2])
                 for k, v in durs.items()}
        n_samples = hist.count - h0[0]
        sample_ms = (hist.sum - h0[1]) / max(n_samples, 1)
        n, window, p50, gaps = self._step_times(rec)
        out = dict(
            losses=[float(v) for v in rec.losses], sizes=sizes, rows=rows,
            stats=d, launches=launches, wall_s=wall, window_ms=window,
            step_ms_p50=p50, step_ms=gaps, spans=spans,
            sample_ms=sample_ms, samples_timed=n_samples,
            images_per_s=sum(sizes[-n:]) / window * 1e3,
            feed_wait_share=feed["wait"] / wall, feed=feed,
            peak_allocated_bytes=torch.cuda.max_memory_allocated(),
            acc_count=list(model._metrics[0].count),
            rings_left=sorted(self._ring_names() - rings),
            epoch_logs={k: (float(v) if np.ndim(v) == 0 else
                            [float(x) for x in v])
                        for k, v in rec.epoch_logs.items()})
        del model, net
        torch.cuda.empty_cache()
        return out

    def input_resnet(self, workers):
        """(a) ResNet-50 from host-prepared images (see the module
        docstring): the worker fit with EarlyStopping and VisualDL, the
        in-process fit, the byte check on a deterministic transform, and
        ResNet-50's summary and flops and utils.run_check()."""
        torch = self.torch
        import contextlib
        import io as pyio
        import json
        import shutil
        import tempfile
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import hapi, io
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.vision import transforms as T
        from paddle_tpu_torch.vision.models import resnet50
        N, B, side = INPUT["N"], INPUT["B"], INPUT["SIDE"]
        t0 = time.perf_counter()
        rng = np.random.RandomState(0)
        images = rng.randint(0, 256, (N, side, side, 3), dtype=np.uint8)
        labels = rng.randint(0, 1000, N).astype(np.int64)
        print(f"input (a): {N} seeded uint8 images {side} x {side} x 3 "
              f"({images.nbytes / 1e6:.1f} MB) made in "
              f"{time.perf_counter() - t0:.2f} s")
        norm = T.Normalize(mean=[0.485, 0.456, 0.406],
                           std=[0.229, 0.224, 0.225])
        train_t = T.Compose([T.RandomResizedCrop(224),
                             T.RandomHorizontalFlip(), T.ToTensor(), norm])
        fixed_t = T.Compose([T.Resize(256), T.CenterCrop(224), T.ToTensor(),
                             norm])

        class Images(io.Dataset):
            """The images through a transform; each fetch bumps a counter
            in the process that runs it (the relay brings a worker's to
            the parent)."""

            def __init__(self, transform):
                self.transform = transform

            def __getitem__(self, i):
                t = time.perf_counter()
                monitor.stat_add("STAT_smoke_input_samples")
                out = self.transform(images[i]), labels[i]
                monitor.histogram("smoke_input_sample_ms").observe(
                    (time.perf_counter() - t) * 1e3)
                return out

            def __len__(self):
                return N

        log_dir = tempfile.mkdtemp(prefix="smoke_visualdl_")
        try:
            vdl = hapi.callbacks.VisualDL(log_dir=log_dir)
            stop = hapi.callbacks.EarlyStopping(monitor="loss", patience=1)
            w = self._input_fit("input_resnet50_workers", Images(train_t),
                                workers, True, callbacks=(stop, vdl))
            with open(os.path.join(log_dir, "scalars.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        vdl_loss = [(r["step"], r["value"]) for r in recs
                    if r["tag"] == "train/loss"]
        s = self._input_fit("input_resnet50_inprocess", Images(train_t), 0,
                            False)
        few = max(1, workers // 3)
        f = self._input_fit("input_resnet50_few_workers", Images(train_t),
                            few, True)
        steps = -(-N // B)
        ring = workers * 2
        phase9 = self.details.get("vision_resnet50", {}).get("images_per_s")
        for label, r in (("workers + DeviceFeeder", w),
                         ("in process, no feeder", s),
                         (f"{few} workers + DeviceFeeder", f)):
            st = r["stats"]
            print(f"input (a) {label} on {self.smi}: ResNet-50 O1, batch "
                  f"{B}, {N} images ({steps} steps, tail "
                  f"{r['sizes'][-1]}): {r['images_per_s']:.2f} images/s "
                  f"(the real images of steps 3-{steps} over their "
                  f"{r['window_ms']:.2f} ms on the device timeline); step "
                  f"p50 {r['step_ms_p50']:.2f} ms; fit wall "
                  f"{r['wall_s']:.2f} s, {r['feed_wait_share'] * 100:.1f}% "
                  f"of it waiting on the feed; feeder overlap "
                  f"{st['STAT_device_feeder_overlap']} / "
                  f"{st['STAT_device_feeder_batches']}; peak allocated "
                  f"{r['peak_allocated_bytes'] / 2**30:.2f} GiB; a "
                  f"sample's transform {r['sample_ms']:.3f} ms mean over "
                  f"{r['samples_timed']}; host spans (count, total ms, "
                  f"p50 ms) { {k: (c, round(v, 1), round(m, 2)) for k, (c, v, m) in r['spans'].items()} }"
                  f"; counters {st}; launches {r['launches']}")
            print(f"input (a) {label} per-step loss: " + " ".join(
                f"{v:.4f}" for v in r["losses"]))
        print(f"input (a): phase 9 (a) in this run (one batch on the card "
              f"every step): "
              + (f"{phase9:.2f} images/s" if phase9 else "not run"))
        self.details["input_resnet50"] = dict(workers=w, inprocess=s,
                                              few_workers=f,
                                              phase9_images_per_s=phase9,
                                              visualdl_loss=vdl_loss)
        for label, r in (("workers", w), ("in-process", s),
                         ("few workers", f)):
            st = r["stats"]
            assert all(np.isfinite(r["losses"])), f"{label}: non-finite loss"
            assert st["STAT_tail_pad_batches"] == 1, (label, st)
            assert r["rows"] == [B] * steps, (label, r["rows"])
            assert r["sizes"][-1] == N - (steps - 1) * B, r["sizes"]
            assert r["acc_count"] == [N, N], (label, r["acc_count"])
            assert st["STAT_dataloader_batches"] == steps, (label, st)
            assert st["STAT_smoke_input_samples"] == N, (label, st)
            assert all(v == 0 for v in r["launches"].values()), r["launches"]
        st = w["stats"]
        assert st["STAT_shm_slot_segments"] <= ring, st
        assert st["STAT_shm_slots_reused"] == \
            steps - st["STAT_shm_slot_segments"], st
        assert st["STAT_device_feeder_batches"] == steps, st
        assert w["feed"]["off_card"] == 0 and w["feed"]["leaves"] == \
            2 * steps, w["feed"]
        assert w["rings_left"] == [], w["rings_left"]
        assert [v for _, v in vdl_loss] == w["losses"], \
            "VisualDL's train/loss records are not the logged losses"
        assert [k for k, _ in vdl_loss] == list(range(1, steps + 1))
        assert st["STAT_train_host_syncs"] == \
            s["stats"]["STAT_train_host_syncs"], \
            "VisualDL added host syncs"
        assert s["stats"]["STAT_device_feeder_batches"] == 0, s["stats"]
        # the byte check: a deterministic transform, worker loader +
        # feeder against the in-process loader, on the card
        rings = self._ring_names()
        t0 = time.perf_counter()
        fed = io.DeviceFeeder(io.DataLoader(Images(fixed_t), batch_size=B,
                                            num_workers=workers))
        ref = iter(io.DataLoader(Images(fixed_t), batch_size=B))
        n_equal = 0
        for x, y in fed:
            rx, ry = next(ref)
            assert x.device.type == "cuda" and y.device.type == "cuda"
            n_equal += int(torch.equal(x, rx.cuda()) and
                           torch.equal(y, ry.cuda()))
        print(f"input (a) byte check: {n_equal} of {steps} worker + feeder "
              f"batches equal the in-process loader's on the card "
              f"({time.perf_counter() - t0:.2f} s)")
        assert n_equal == steps, f"{steps - n_equal} batches differ"
        assert self._ring_names() == rings
        net = resnet50(num_classes=1000, device="cuda", seed=0)
        buf = pyio.StringIO()
        with contextlib.redirect_stdout(buf):
            summ = paddle.summary(net)
        fl = paddle.flops(net, [1, 3, 224, 224])
        print(f"input (a) summary: {summ} ({len(buf.getvalue().splitlines())}"
              f" table lines); flops at [1, 3, 224, 224]: {fl:,} "
              f"({fl / 1e9:.3f} G)")
        self.details["input_resnet50"].update(summary=summ, flops=fl)
        name = paddle.utils.run_check()
        assert name == torch.cuda.get_device_name(0), name
        del net
        torch.cuda.empty_cache()

    def input_ernie(self):
        """(b) ERNIE-base (dropout 0.1, seed 0) in phase 8 (b)'s
        configuration on INPUT["ERNIE_ROWS"] padded seq-512 rows, the last
        batch a tail, through DataLoader(num_workers=2) + DeviceFeeder, in
        fp32 and under O1, each followed by the same fit in process
        without a feeder (for the step time beside it; the same gates).
        Gates: K2, K3 and K4 launch 12 times a step,
        the padded tail's step included, all in the path's type; the
        plain attention 0 times; the loss finite and the mean of its last
        3 steps below the first 3's; STAT_tail_pad_batches 1."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import hapi, io, nn, optimizer
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        from paddle_tpu_torch.nn.functional import attention
        from paddle_tpu_torch.static import InputSpec
        B, S = ERNIE_LONG["B"], ERNIE_LONG["S"]
        n = INPUT["ERNIE_ROWS"]
        steps = -(-n // B)
        cfg = ErnieConfig.base()
        full = steps * B
        lens = _ernie_lengths(np, full, S, seed=1)
        ids, labels, mask = _ernie_cls_set(np, full, S, cfg.vocab_size, B,
                                           seed=1, lengths=lens)
        rows = [a[:n] for a in (ids, np.zeros_like(ids),
                                np.tile(np.arange(S), (full, 1)), mask,
                                labels)]
        specs = [InputSpec([None, S], "int64", k) for k in
                 ("input_ids", "token_type_ids", "position_ids")] + [
            InputSpec([None, S], "float32", "attention_mask")]
        plain = [0]
        ref = attention._sdpa_ref

        def counted(*a, **k):
            plain[0] += 1
            return ref(*a, **k)
        for level, fed in ((None, True), (None, False), ("O1", True),
                           ("O1", False)):
            path = "input_ernie" + ("_amp" if level else "") + \
                ("" if fed else "_inprocess")
            dtype = "float32" if level is None else "bfloat16"
            frandom.seed(1)
            net = ErnieForSequenceClassification(cfg, device="cuda", seed=0)
            model = hapi.Model(net, inputs=specs).prepare(
                optimizer.AdamW(ERNIE_LONG["LR"]), nn.CrossEntropyLoss(),
                amp_configs=level)
            loader = io.DataLoader(io.TensorDataset(rows), batch_size=B,
                                   shuffle=False, num_workers=2 if fed else 0,
                                   use_buffer_reader=fed)
            rec = self._step_recorder()
            pads = monitor.stat_get("STAT_tail_pad_batches")
            torch.cuda.synchronize()
            # the main path starts here: every launch count from 0
            self.zero_launches()
            plain[0] = 0
            attention._sdpa_ref = counted
            try:
                t0 = time.perf_counter()
                model.fit(loader, epochs=1, log_freq=10, verbose=0,
                          callbacks=[rec])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                attention._sdpa_ref = ref
            launches = self.record_path(path)
            by_dtype = self.path_dtype_launches[path]
            pads = monitor.stat_get("STAT_tail_pad_batches") - pads
            losses = [float(v) for v in rec.losses]
            m, window, p50, gaps = self._step_times(rec)
            source = ("from 2 worker processes through the DeviceFeeder"
                      if fed else "in process, no feeder")
            print(f"{path} on {self.smi}: ERNIE-base "
                  f"{'fp32' if level is None else 'AMP O1 bf16'}, {n} rows "
                  f"of batch {B} x {S} ({steps} steps, the last a tail of "
                  f"{n - (steps - 1) * B}) {source}: {steps} steps in "
                  f"{wall:.2f} s wall; step p50 {p50:.2f} ms; tail pads "
                  f"{pads}; plain attention calls {plain[0]}; launches "
                  f"{launches}; by type {by_dtype['flash_fwd']}")
            print(f"{path} per-step loss: " + " ".join(f"{v:.4f}"
                                                       for v in losses))
            self.details[path] = dict(
                losses=losses, step_ms_p50=p50, step_ms=gaps, wall_s=wall,
                launches=launches, launches_by_dtype=by_dtype,
                plain_calls=plain[0], tail_pads=pads)
            assert all(np.isfinite(losses)), f"non-finite {path} loss"
            assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
                f"the {path} loss did not fall"
            assert pads == 1, pads
            assert plain[0] == 0, f"plain attention ran {plain[0]} times"
            L = cfg.num_hidden_layers
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                assert launches[name] == L * steps, (name, launches[name])
                assert by_dtype[name] == {dtype: L * steps}, \
                    f"{name} launched {by_dtype[name]}, all {dtype} expected"
            del model, net
            torch.cuda.empty_cache()

    # -- 14. static -----------------------------------------------------------

    def static(self):
        """ERNIE-base as a static Program: trained through Executor.run in
        fp32 and after static.amp.decorate in bf16 (a), its step against
        the dygraph step (b), exported and reloaded (c), dy2static (d),
        the Program passes (e) and ops.legacy's static pieces (f); see the
        module docstring."""
        self.gpt = None
        self.torch.cuda.empty_cache()
        # the phase's artifacts (≈ 3 GB of .pdmodel / .ptprog files)
        self.static_dir = tempfile.mkdtemp(prefix="chip_smoke_static_")
        try:
            evals = {dtype: self.static_train(dtype)
                     for dtype in ("float32", "bfloat16")}
            ptprog = self.static_parity()
            self.static_export(evals, ptprog)
            del evals
            self.torch.cuda.empty_cache()
            self.static_dy2static()
            self.static_passes()
            self.static_legacy()
        finally:
            shutil.rmtree(self.static_dir, ignore_errors=True)

    def static_legacy(self):
        """(f) ops.legacy's static-mode pieces: a Program with a
        create_parameter (Assign initializer, [32, 8]) through Print and
        a squared error, SGD(0.1).minimize, trained 3 Executor.run steps
        on the card and, the same Program, on the CPU. Gates: Print is
        silent while the Program is built and is one recorded op that
        prints at run time up to first_n (2 of 3 runs); the parameter
        lives on the card; the losses equal the CPU's to rtol 1e-5 and
        fall, the trained weight within 1e-5 x max(1, max |w|)."""
        import contextlib
        import io

        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import static
        rng = np.random.RandomState(0)
        xs = rng.standard_normal((64, 32)).astype(np.float32)
        ts = rng.standard_normal((64, 8)).astype(np.float32)
        w0 = (rng.standard_normal((32, 8)) * 0.1).astype(np.float32)
        out = {}
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            paddle.enable_static()
            try:
                main, startup = static.Program(), static.Program()
                build = io.StringIO()
                with static.program_guard(main, startup), \
                        contextlib.redirect_stdout(build):
                    x = static.data("x", [64, 32], "float32")
                    t = static.data("t", [64, 8], "float32")
                    w = paddle.create_parameter(
                        [32, 8], "float32",
                        default_initializer=paddle.nn.initializer.Assign(w0))
                    y = paddle.Print(paddle.matmul(x, w), message="y",
                                     first_n=2, summarize=4)
                    loss = paddle.mean((y - t) ** 2)
                    paddle.optimizer.SGD(learning_rate=0.1).minimize(loss)
                exe = static.Executor(None if dev == "gpu"
                                      else paddle.CPUPlace())
                exe.run(startup)
                ran = io.StringIO()
                with contextlib.redirect_stdout(ran):
                    losses = [float(exe.run(main, feed={"x": xs, "t": ts},
                                            fetch_list=[loss])[0])
                              for _ in range(3)]
                (name,) = main.param_vars
                wv = static.global_scope()[name]
                out[dev] = dict(build=build.getvalue(),
                                run=ran.getvalue().splitlines(),
                                losses=losses, device=wv.device.type,
                                w=wv.detach().cpu().numpy(),
                                ops=[op.name for op in main.ops])
            finally:
                paddle.disable_static()
                paddle.set_device("gpu")
        g, c = out["gpu"], out["cpu"]
        werr = float(np.abs(g["w"] - c["w"]).max())
        wlim = 1e-5 * max(1.0, float(np.abs(c["w"]).max()))
        print(f"static (f) legacy on {self.smi}: ops {g['ops']}, printed "
              f"while built {g['build']!r}, at run {len(g['run'])} lines "
              f"({g['run'][:1]}), losses card {g['losses']} cpu "
              f"{c['losses']}, weight max err {werr:.3e} (limit "
              f"{wlim:.3e}), parameter on {g['device']}")
        self.details["static_legacy"] = dict(
            losses=g["losses"], cpu_losses=c["losses"], w_err=werr)
        assert g["build"] == "" and c["build"] == "", (g["build"],
                                                       c["build"])
        assert g["ops"].count("print") == 1 and len(g["run"]) == 2, g
        assert g["device"] == "cuda", g["device"]
        np.testing.assert_allclose(g["losses"], c["losses"], rtol=1e-5)
        assert werr <= wlim, (werr, wlim)
        assert g["losses"][2] < g["losses"][0], g["losses"]

    def _static_tmp(self, prefix):
        return tempfile.mkdtemp(prefix=prefix,
                                dir=getattr(self, "static_dir", None))

    def _static_feed(self, ids, mask, labels, sl):
        feed = {"input_ids": ids[sl], "attention_mask": mask[sl]}
        if labels is not None:
            feed["labels"] = labels[sl]
        return feed

    def static_train(self, dtype):
        """(a) ERNIE-base (seed 0, dropout 0.1) recorded under
        static.program_guard at batch 8 x seq 512 (feeds input_ids,
        attention_mask and labels), CrossEntropyLoss and
        AdamW(1e-4).minimize, on phase 8 (b)'s seeded lengths 128-512;
        STATIC["STEPS"] Executor.run steps in fp32 ("static") or after
        static.amp.decorate in bf16 ("static_amp"). Gates: the loss is
        finite and falls (the mean of the last 3 steps below the mean of
        the first 3); K2, K3 and K4 launch once a layer a step
        (STATIC["LAYERS"]: ERNIE-base cut to 4 layers), all in the
        arm's type; the plain attention 0 times. Printed: real tokens/s
        over steps 3 on, the step p50 on the device timeline, the device
        busy share of 3 more profiled steps. Returns the eval Program
        (dropout off, rewritten to bf16 in the bf16 arm), its scope, feed
        and fetch Variables, a batch and the Program's logits on it, for
        (c)."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import nn, optimizer, static
        from paddle_tpu_torch.framework import random as frandom
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        from paddle_tpu_torch.nn.functional import attention
        B, S = ERNIE_LONG["B"], ERNIE_LONG["S"]
        steps = STATIC["STEPS"]
        path = "static" if dtype == "float32" else "static_amp"
        cfg = ErnieConfig.base()
        cfg.num_hidden_layers = STATIC["LAYERS"]
        frandom.seed(1)
        net = ErnieForSequenceClassification(cfg, device="cuda", seed=0)
        lens = _ernie_lengths(np, B * steps, S, seed=1)
        ids, labels, mask = _ernie_cls_set(np, B * steps, S, cfg.vocab_size,
                                           B, seed=1, lengths=lens)
        scope = {}
        plain = [0]
        ref_attn = attention._sdpa_ref

        def counted(*a, **k):
            plain[0] += 1
            return ref_attn(*a, **k)
        ptt.enable_static()
        try:
            with static.scope_guard(scope):
                main = static.Program()
                t0 = time.perf_counter()
                with static.program_guard(main, static.Program()):
                    x = static.data("input_ids", [B, S], "int64")
                    m = static.data("attention_mask", [B, S], "float32")
                    y = static.data("labels", [B], "int64")
                    loss = nn.CrossEntropyLoss()(net(x, attention_mask=m), y)
                    opt = optimizer.AdamW(ERNIE_LONG["LR"])
                    if dtype == "bfloat16":
                        opt = static.amp.decorate(opt)
                    opt.minimize(loss)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                names = [op.name for op in main.ops]
                exe = static.Executor()
                events, handles = [], []
                torch.cuda.synchronize()
                # the main path starts here: every launch count from 0
                self.zero_launches()
                attention._sdpa_ref = counted
                try:
                    t0 = time.perf_counter()
                    for i in range(steps):
                        lv, = exe.run(main, feed=self._static_feed(
                            ids, mask, labels, slice(i * B, (i + 1) * B)),
                            fetch_list=[loss], return_numpy=False)
                        ev = torch.cuda.Event(enable_timing=True)
                        ev.record()
                        events.append(ev)
                        handles.append(lv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    attention._sdpa_ref = ref_attn
                launches = self.record_path(path)
                by_dtype = self.path_dtype_launches[path]
                losses = [float(v) for v in handles]
                busy = self._static_busy(exe, main, loss, self._static_feed(
                    ids, mask, labels, slice(0, B)))
                del main, loss, opt, handles
                # the eval Program: dropout off, the same parameters
                net.eval()
                ev_prog = static.Program()
                with static.program_guard(ev_prog, static.Program()):
                    ex = static.data("input_ids", [B, S], "int64")
                    em = static.data("attention_mask", [B, S], "float32")
                    elog = net(ex, attention_mask=em)
                if dtype == "bfloat16":
                    static.amp.rewrite_program(ev_prog)
                efeed = self._static_feed(ids, mask, None, slice(0, B))
                ref = exe.run(ev_prog, feed=efeed, fetch_list=[elog])[0]
        finally:
            ptt.disable_static()

        n, window, p50, gaps = self._step_times(
            types.SimpleNamespace(events=events))
        real = float(mask.sum()) / steps
        tps = float(mask[-n * B:].sum()) / window * 1e3
        label = "fp32" if dtype == "float32" else "static.amp bf16"
        counts = {k: names.count(k) for k in ("linear", "sdpa", "layer_norm",
                                              "embedding", "dropout",
                                              "cross_entropy")}
        print(f"{path} on {self.smi}: ERNIE-base {label} Program of "
              f"{len(names)} ops (named {counts}) built in {build_s:.2f} s; "
              f"batch {B} x {S}, lengths {ERNIE_LONG['MIN_LEN']}-{S} (fill "
              f"{real / (B * S):.3f}), {steps} Executor.run steps in "
              f"{wall:.2f} s wall; {tps:.0f} real tokens/s (steps "
              f"3-{steps} over their {window:.2f} ms on the device "
              f"timeline); step p50 {p50:.2f} ms; device busy "
              f"{busy['busy_share'] * 100:.1f}% of 3 profiled steps; "
              f"launches {launches}; by type {by_dtype['flash_fwd']}; "
              f"plain attention calls {plain[0]}")
        print("per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        self.details[path] = dict(
            losses=losses, step_ms_p50=p50, step_ms=gaps, wall_s=wall,
            window_ms=window, measured_steps=n, build_s=build_s,
            real_tokens_per_step=real, real_tokens_per_s=tps,
            fill=real / (B * S), launches=launches,
            launches_by_dtype=by_dtype, ops=len(names), named_ops=counts,
            plain_attention=plain[0], **busy)
        assert all(np.isfinite(losses)), f"non-finite {path} loss"
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            f"the {path} loss did not fall"
        L = cfg.num_hidden_layers
        assert counts["sdpa"] == L, counts
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == L * steps, (name, launches[name])
            assert by_dtype[name] == {dtype: L * steps}, \
                f"{name} launched {by_dtype[name]}, all {dtype} expected"
        assert plain[0] == 0, f"plain attention ran {plain[0]} times"
        del net
        torch.cuda.empty_cache()
        return dict(scope=scope, prog=ev_prog, feeds=[ex, em], fetch=elog,
                    feed=efeed, ref=ref)

    def _static_busy(self, exe, main, loss, feed):
        """Device busy share of 3 profiled Executor.run steps: the
        kernels' device ms over the wall ms of the same steps."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        steps = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                exe.run(main, feed=feed, fetch_list=[loss],
                        return_numpy=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev, _ = _device_table(torch, prof, steps, wall_ms)
        return dict(busy_device_ms=dev, busy_wall_ms=wall_ms / steps,
                    busy_share=dev / (wall_ms / steps))

    def static_parity(self):
        """(b) At ERNIE_PARITY ([2, 512], row 1 padded from 300, dropout 0,
        fp32), one Executor.run training step (AdamW 1e-4) of the static
        Program against one dygraph hapi Model.train_batch of the same
        weights: the loss to rtol 1e-5 and every parameter's update
        within phase 6's fp32 limits (1e-3 x its max + 1e-6 x the
        model's max). Returns the Program saved as a `.ptprog` document
        before its step, with the step's feed and scope after, for
        (c)."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import hapi, nn, optimizer, static
        from paddle_tpu_torch.models import (ErnieConfig,
                                             ErnieForSequenceClassification)
        B, S = ERNIE_PARITY["B"], ERNIE_PARITY["S"]
        cfg = ErnieConfig(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0,
                          num_hidden_layers=STATIC["LAYERS"])
        net = ErnieForSequenceClassification(cfg, device="cuda", seed=0)
        rng = np.random.RandomState(2)
        ids = rng.randint(5, cfg.vocab_size, size=(B, S)).astype(np.int64)
        mask = np.ones((B, S), np.float32)
        mask[1, 300:] = 0
        ids[mask == 0] = 0
        labels = np.array([0, 1], np.int64)
        feed = {"input_ids": ids, "attention_mask": mask, "labels": labels}
        scope = {}
        ptt.enable_static()
        try:
            with static.scope_guard(scope):
                main = static.Program()
                with static.program_guard(main, static.Program()):
                    x = static.data("input_ids", [B, S], "int64")
                    m = static.data("attention_mask", [B, S], "float32")
                    y = static.data("labels", [B], "int64")
                    loss = nn.CrossEntropyLoss()(net(x, attention_mask=m), y)
                    optimizer.AdamW(1e-4).minimize(loss)
                before = {n: scope[n].clone() for n in main.param_vars}
                path = os.path.join(self._static_tmp("static_"),
                                    "ernie_train.ptprog")
                t0 = time.perf_counter()
                main.save(path)
                save_s = time.perf_counter() - t0
                self.zero_launches()
                ls = static.Executor().run(main, feed=feed,
                                           fetch_list=[loss])[0]
                launches = self.read_launches()
        finally:
            ptt.disable_static()
        # the dygraph step from the same weights
        model = hapi.Model(net, inputs=[None] * 4).prepare(
            optimizer.AdamW(1e-4), nn.CrossEntropyLoss())
        x4 = [ids, np.zeros_like(ids), np.tile(np.arange(S), (B, 1)), mask]
        lvs, _ = model.train_batch(x4, [labels])
        ld = float(lvs[0])
        by_name = {getattr(p, "_pt_name", None): p
                   for p in net.parameters()}
        upd_s = {n: scope[n] - before[n] for n in before}
        upd_d = {n: by_name[n].detach() - before[n] for n in before}
        worst = _grad_worst(upd_s, upd_d, 1e-3, 1e-6)
        print(f"static step parity [{B},{S}] padded, dropout 0, fp32: loss "
              f"static {float(ls):.6f} dygraph {ld:.6f} (rtol 1e-5); worst "
              f"update max_abs_err / its limit {worst[0]:.3e} ({worst[1]}); "
              f"launches {launches}; the Program's .ptprog "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) written in "
              f"{save_s:.1f} s")
        self.details["static_parity"] = dict(
            loss_static=float(ls), loss_dygraph=ld,
            worst_update_over_limit=worst[0], worst_param=worst[1],
            launches=launches, ptprog_bytes=os.path.getsize(path),
            ptprog_save_s=save_s)
        assert abs(float(ls) - ld) <= 1e-5 * abs(ld), (float(ls), ld)
        assert worst[0] <= 1.0, f"static step update {worst[1]} differs"
        L = cfg.num_hidden_layers
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[k] == L, (k, launches[k])
        del model, net, main
        torch.cuda.empty_cache()
        return dict(path=path, feed=feed, before=before, after=upd_s,
                    loss=float(ls))

    def static_export(self, evals, ptprog):
        """(c) For each arm of (a): save_inference_model of its pruned
        eval Program, then load_inference_model in the same process; the
        loaded Program's Executor logits and inference.Predictor's on the
        `.pdmodel` both equal (a)'s eval logits within EXPORT_TOL x
        max(1, max |logit|) (fp32 1e-4, bf16 2e-2, phase 10 (b)); the
        `.pdmodel` holds a flash_fwd node a layer. Then (b)'s Program loaded
        from its `.ptprog` trains one Executor.run step from the same
        weights: the loss to rtol 1e-5 and every update within phase 6's
        fp32 limits of the built Program's; K2, K3 and K4 launch once a layer
        each in that step, K3 and K4 through the flash_fwd op's autograd
        registration."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import inference, optimizer, static
        tmp = self._static_tmp("static_export_")
        for dtype, ev in evals.items():
            prefix = os.path.join(tmp, f"ernie_{dtype}")
            ptt.enable_static()
            try:
                with static.scope_guard(ev["scope"]):
                    exe = static.Executor()
                    t0 = time.perf_counter()
                    static.save_inference_model(prefix, ev["feeds"],
                                                [ev["fetch"]], exe,
                                                program=ev["prog"])
                    save_s = time.perf_counter() - t0
                    with static.scope_guard({}):
                        prog, feeds, fetches = static.load_inference_model(
                            prefix, exe)
                        out = exe.run(prog, feed=ev["feed"], fetch_list=[
                            prog.vars[prog._fetch_slots[0]]])[0]
            finally:
                ptt.disable_static()
            pred = inference.create_predictor(inference.Config(prefix))
            # the Predictor's inputs follow the sorted feed names
            pout = pred.run([ev["feed"][n] for n in sorted(ev["feed"])])[0]
            graph = [str(nd.target) for nd in
                     pred._translated._exported.graph.nodes
                     if nd.op == "call_function"]
            nodes = sum(t == "paddle_tpu_torch.flash_fwd.default"
                        for t in graph)
            ref = ev["ref"].astype(np.float32)
            scale = max(1.0, float(np.abs(ref).max()))
            tol = EXPORT_TOL[dtype] * scale
            e_prog = float(np.abs(out.astype(np.float32) - ref).max())
            e_pred = float(np.abs(pout.astype(np.float32) - ref).max())
            print(f"static export {dtype} on {self.smi}: save_inference_model "
                  f"{save_s:.1f} s (.pdmodel "
                  f"{os.path.getsize(prefix + '.pdmodel') / 2**20:.1f} MiB, "
                  f".ptprog {os.path.getsize(prefix + '.ptprog') / 2**20:.1f}"
                  f" MiB, {len(prog.ops)} ops); loaded Program logits "
                  f"max_abs_err {e_prog:.3e}, Predictor {e_pred:.3e} (tol "
                  f"{tol:.3e}); .pdmodel flash_fwd nodes {nodes}; feeds "
                  f"{feeds}")
            self.details[f"static_export_{dtype}"] = dict(
                save_s=save_s, err_program=e_prog, err_predictor=e_pred,
                tol=tol, flash_fwd_nodes=nodes, ops=len(prog.ops))
            assert e_prog <= tol and e_pred <= tol, (e_prog, e_pred, tol)
            assert nodes == STATIC["LAYERS"], nodes
            del prog, pred
        # the loaded training Program's step against the built one's
        t0 = time.perf_counter()
        prog, params = static.load_program(ptprog["path"], "cuda")
        load_s = time.perf_counter() - t0
        prog._opt_hooks.append(optimizer.AdamW(1e-4))
        scope = {n: params[n].clone() for n in params}
        before = {n: scope[n].clone() for n in scope}
        exe = static.Executor()
        self.zero_launches()
        with static.scope_guard(scope):
            ll = exe.run(prog, feed=ptprog["feed"],
                         fetch_list=[prog.vars[prog._loss_slot]])[0]
        torch.cuda.synchronize()
        launches = self.read_launches()
        upd = {n: scope[n] - before[n] for n in before}
        worst = _grad_worst(upd, ptprog["after"], 1e-3, 1e-6)
        kinds = sorted({op.name for op in prog.ops})
        print(f"static loaded .ptprog ({len(prog.ops)} ops, loaded in "
              f"{load_s:.1f} s) one training step on {self.smi}: loss "
              f"{float(ll):.6f} built {ptprog['loss']:.6f}; worst update "
              f"max_abs_err / its limit {worst[0]:.3e} ({worst[1]}); "
              f"launches {launches}; op kinds {kinds}")
        self.details["static_loaded_step"] = dict(
            loss=float(ll), loss_built=ptprog["loss"], load_s=load_s,
            worst_update_over_limit=worst[0], worst_param=worst[1],
            launches=launches)
        assert abs(float(ll) - ptprog["loss"]) <= 1e-5 * abs(ptprog["loss"])
        assert worst[0] <= 1.0, f"loaded step update {worst[1]} differs"
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[k] == STATIC["LAYERS"], (k, launches[k])
        del prog, params, scope
        torch.cuda.empty_cache()

    def static_dy2static(self):
        """(d) jit.save of a to_static layer whose forward branches on a
        tensor value (`if h.mean() > 0`) and loops while a tensor
        condition holds (`while h.abs().sum() < ...`), exported on the
        card (torch.cond and while_loop in the program); jit.load on the
        card equals eager on inputs that take each branch (fp32, 1e-5 x
        max(1, max |out|))."""
        torch = self.torch
        from paddle_tpu_torch import jit, nn
        from paddle_tpu_torch.static import InputSpec

        class Gate(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(64, 64)

            def forward(self, x):
                h = self.fc(x)
                if h.mean() > 0:
                    h = h * 2.0
                else:
                    h = h - 1.0
                while h.abs().sum() < 1e5:
                    h = h * 1.5
                return h

        torch.manual_seed(0)
        layer = Gate().to("cuda")
        xs = [torch.full((4, 64), s, device="cuda") for s in (-3.0, 3.0)]
        with torch.no_grad():
            eager = [layer(x) for x in xs]
            taken = [bool(layer.fc(x).mean() > 0) for x in xs]
        assert sorted(taken) == [False, True], taken
        layer = jit.to_static(layer)
        prefix = os.path.join(self._static_tmp("dy2static_"), "gate")
        jit.save(layer, prefix, input_spec=[InputSpec([4, 64], "float32")])
        loaded = jit.load(prefix)
        hops = sorted({getattr(nd.target, "__name__", str(nd.target))
                       for nd in loaded._exported.graph.nodes
                       if nd.op == "call_function"
                       and "higher_order" in repr(nd.target)})
        errs = []
        for x, e in zip(xs, eager):
            got = loaded(x)
            errs.append(float((got - e).abs().max())
                        / max(1.0, float(e.abs().max())))
        print(f"dy2static on {self.smi}: branches taken {taken}; program "
              f"control flow {hops}; loaded vs eager relative errors "
              f"{errs}")
        self.details["static_dy2static"] = dict(taken=taken, hops=hops,
                                                errs=errs)
        assert any("cond" in h for h in hops) and \
            any("while_loop" in h for h in hops), hops
        assert max(errs) <= 1e-5, errs

    def static_passes(self):
        """(e) QuantizationTransformPass + QuantizationFreezePass on a
        static MLP (784-512-512-10 at batch 64): the frozen Program's
        outputs on the card equal its CPU outputs (1e-5 x max(1, max
        |out|)); ImperativeQuantAware.save_quantized_model of a dygraph
        MLP, then inference.Predictor on the card equals the quantized
        layer eagerly (1e-5 x max(1, ...)); the committed legacy
        ProgramDesc transformer encoder (tests/data/pd_encoder.pdmodel)
        through inference.Predictor on the card equals the port's CPU run
        of it (1e-5 x max(1, ...))."""
        torch = self.torch
        import numpy as np
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import inference, nn, quantization, static
        from paddle_tpu_torch.inference.pd_import import \
            load_legacy_inference_model
        from paddle_tpu_torch.static import InputSpec
        rng = np.random.RandomState(4)
        xv = rng.rand(64, 784).astype(np.float32)
        scope = {}
        ptt.enable_static()
        try:
            with static.scope_guard(scope):
                main = static.Program()
                with static.program_guard(main, static.Program()):
                    x = static.data("x", [64, 784], "float32")
                    h = static.nn.fc(x, 512, activation="relu")
                    h = static.nn.fc(h, 512, activation="relu")
                    out = static.nn.fc(h, 10)
                quantization.QuantizationTransformPass().apply(main)
                quantization.QuantizationFreezePass().apply(main)
                frozen = [op.name for op in main.ops
                          if op.attrs.get("frozen")]
                card = static.Executor().run(main, feed={"x": xv},
                                             fetch_list=[out])[0]
                cpu = static.Executor(ptt.CPUPlace()).run(
                    main, feed={"x": xv}, fetch_list=[out])[0]
        finally:
            ptt.disable_static()
        e_q = float(np.abs(card - cpu).max()) / max(1.0, float(
            np.abs(cpu).max()))
        # save_quantized_model -> Predictor
        torch.manual_seed(0)
        mlp = nn.Sequential(nn.Linear(784, 512), nn.ReLU(),
                            nn.Linear(512, 10)).to("cuda")
        quantization.ImperativeQuantAware().quantize(mlp)
        prefix = os.path.join(self._static_tmp("quant_"), "mlp")
        quantization.ImperativeQuantAware().save_quantized_model(
            mlp, prefix, input_spec=[InputSpec([None, 784], "float32")])
        pred = inference.create_predictor(inference.Config(prefix))
        got = pred.run([xv])[0]
        with torch.no_grad():
            want = mlp.eval()(torch.from_numpy(xv).cuda()).cpu().numpy()
        e_s = float(np.abs(got - want).max()) / max(1.0, float(
            np.abs(want).max()))
        # the legacy ProgramDesc fixture
        fx = REPO / "tests" / "data" / "pd_encoder"
        ids = np.random.RandomState(5).randint(0, 50, (3, 8)).astype(
            np.int64)
        pos = np.tile(np.arange(8, dtype=np.int64), (3, 1))
        lp = inference.create_predictor(inference.Config(
            str(fx) + ".pdmodel", str(fx) + ".pdiparams"))
        lcard = lp.run([ids, pos])[0]
        lcpu = load_legacy_inference_model(
            str(fx) + ".pdmodel", str(fx) + ".pdiparams",
            device="cpu").run({"ids": ids, "pos": pos})[0]
        e_l = float(np.abs(lcard - lcpu).max()) / max(1.0, float(
            np.abs(lcpu).max()))
        print(f"static passes on {self.smi}: frozen ops {frozen}, card vs "
              f"CPU {e_q:.3e}; save_quantized_model -> Predictor vs eager "
              f"{e_s:.3e}; legacy encoder ({len(lp._legacy._steps)} ops, "
              f"feeds {lp.get_input_names()}) card vs CPU {e_l:.3e} "
              f"(limit 1e-5 x max(1, max |out|) each)")
        self.details["static_passes"] = dict(
            frozen=frozen, quant_card_vs_cpu=e_q, saved_quant_vs_eager=e_s,
            legacy_card_vs_cpu=e_l)
        assert len(frozen) == 3, frozen
        assert e_q <= 1e-5 and e_s <= 1e-5 and e_l <= 1e-5, (e_q, e_s, e_l)

    # -- 3. the sharded dispatches' kernels (phase 15's shapes) -----------------

    def check_head_offset_kernels(self):
        """K2-K4 on a tensor-parallel rank's heads: ERNIE-base at mp 2
        (rank 1's heads 6-11 of 12: [8, 6, 512, 64], its key-padding bias,
        non-causal, p 0.1, fp32 and bf16), the dropout keyed on the global
        head (`flash_ops.head_keyed_seed(seed, 6, 12)`), against their
        plain versions at the same keyed seed (FLASH_TOL); and the plain
        keep mask of that seed equal to heads 6-11 of the 12-head mask.
        Rows in details["head_offset_kernels"]."""
        torch = self.torch
        from paddle_tpu_torch.ops import flash_ops as fo
        B, H, S, D, p = 8, 6, 512, 64, DROPOUT
        seed = fo.head_keyed_seed(1234, H, 2 * H)
        scale = 1.0 / D ** 0.5
        whole = fo._keep_mask(1234, B, 2 * H, S, S, p, "cuda")
        mine = fo._keep_mask(seed, B, H, S, S, p, "cuda")
        same = bool(torch.equal(mine, whole[:, H:]))
        print(f"head offset: the keep mask of heads 6-11 keyed on the "
              f"global head equals those heads of the 12-head mask: {same}")
        assert same, "the head-keyed mask is not the whole model's"
        del whole, mine
        rows = []
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            tol = FLASH_TOL[name]
            q, k, v, do, bias = self.train_inputs(dtype, False, "ernie", H=H,
                                                  D=D, Sq=S, B=B)
            tag = dict(shape=f"{B}x{H}x{S}x{S}x{D}", p=p, head_offset=H,
                       heads=2 * H)
            pairs = S * S
            q_b = B * H * S * D * q.element_size()
            row_b, bias_b = B * H * S * 4, B * S * 4
            out, lse = fo.flash_attention_fwd(q, k, v, bias, False, scale, p,
                                              seed)
            ref, ref_lse = fo._flash_fwd_reference(q, k, v, bias, False,
                                                   scale, p, seed)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K2 flash_fwd head offset", name,
                max((out.float() - ref.float()).abs().max().item(),
                    (lse - ref_lse).abs().max().item()),
                ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: fo.flash_attention_fwd(
                    q, k, v, bias, False, scale, p, seed), 10),
                _time_ms(torch, lambda: fo._flash_fwd_reference(
                    q, k, v, bias, False, scale, p, seed), 3),
                4 * B * H * pairs * D, 4 * q_b + row_b + bias_b, None,
                kernel="flash_fwd", **tag))
            delta = fo._delta(ref, do)
            bw = (q, k, v, bias, do, ref_lse, delta, False, scale, p, seed)
            dq = fo.flash_attention_dq(*bw)
            dq_ref = fo._dq_reference(*bw)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K3 flash_dq head offset", name,
                (dq.float() - dq_ref.float()).abs().max().item(),
                dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: fo.flash_attention_dq(*bw), 10),
                _time_ms(torch, lambda: fo._dq_reference(*bw), 3),
                6 * B * H * pairs * D, 5 * q_b + 2 * row_b + bias_b, None,
                kernel="flash_bwd_dq", **tag))
            dk, dv = fo.flash_attention_dkv(*bw)
            dk_ref, dv_ref = fo._dkv_reference(*bw)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K4 flash_dkv head offset", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: fo.flash_attention_dkv(*bw), 10),
                _time_ms(torch, lambda: fo._dkv_reference(*bw), 3),
                8 * B * H * pairs * D, 6 * q_b + 2 * row_b + bias_b, None,
                kernel="flash_bwd_dkv", **tag))
            del q, k, v, do, bias, out, lse, ref, ref_lse, delta, bw, dq
            del dq_ref, dk, dv, dk_ref, dv_ref
            torch.cuda.empty_cache()
        self.details["head_offset_kernels"] = rows

    def check_dist_kernels(self):
        """Phase 15's dispatches of K1 and K5-K7 against their plain
        versions; rows in details["dist_kernels"] (the kernels line keeps
        phase 3's rows). K1 through ops.paged_ops.sharded_paged_attention
        at a tp rank's local heads (GPT-2 small's 12 over tp 2 and 4: H 6
        and 3, D 64, page 16, phase 3's 8 slots of random lengths), fp32
        and fp16, and its int8 pool path as phase 5c runs it (the
        dequantizing gather, no K1 launch) against the plain version on
        the dequantized pools. K5-K7 on a dp rank's rows of GPT-2 small's
        packed attention (rank 1's 4 of 8 packed rows, H 12, S 1024, D 64,
        causal, p 0.1, fp32 and bf16) with the dropout seed folded by the
        rank as parallel.spmd.sharded_splash_attention folds it, against
        their plain versions at the folded seed."""
        torch = self.torch
        from paddle_tpu_torch.ops import flash_ops as fo
        from paddle_tpu_torch.ops import paged_ops as po, splash_ops as so
        rows = []
        B, D, P = K1_SHAPE["B"], K1_SHAPE["D"], K1_SHAPE["P"]
        scale = 1.0 / D ** 0.5
        for Hl in (6, 3):
            for dtype, tol in ((torch.float32, 2e-5),
                               (torch.float16, K1_FP16_TOL)):
                q, kp, vp, pt, pos, lens = self.k1_inputs(dtype, B, H=Hl)
                f = po.sharded_paged_attention(None, scale)
                out = f(q, kp, vp, pt, pos)
                ref = po.paged_attention_plain(q.float(), kp.float(),
                                               vp.float(), pt, pos,
                                               scale).to(dtype)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ms, event_ms = self.time_ms(lambda: f(q, kp, vp, pt, pos),
                                            50, self.flush)
                plain_ms = _time_ms(torch, lambda: po.paged_attention_plain(
                    q, kp, vp, pt, pos, scale), 10, self.flush)
                item = q.element_size()
                toks = int(lens.sum())
                name = str(dtype).replace("torch.", "")
                row = self._row(
                    f"K1 sharded_paged_attention H={Hl}", name, err, 1.0,
                    tol, ms, plain_ms, 4 * toks * Hl * D,
                    2 * toks * Hl * D * item + 2 * q.numel() * item
                    + pt.numel() * 4 + pos.numel() * 4, None,
                    kernel="paged_attention", heads=Hl, event_ms=event_ms)
                rows.append(row)
        # the int8 pool path: the dequantizing gather + dense attention
        g = torch.Generator(device="cuda").manual_seed(5)
        q, kp, vp, pt, pos, lens = self.k1_inputs(torch.float32, B, H=6)
        kq = torch.randint(-127, 128, kp.shape, generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        vq = torch.randint(-127, 128, vp.shape, generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        ks, vs = (torch.rand(kp.shape[:2], generator=g, device="cuda") * 0.02
                  for _ in range(2))
        fq = po.sharded_paged_attention(None, scale, quantized=True)
        n0 = po.paged_attention.launches
        out = fq(q, kq, vq, ks, vs, pt, pos)
        assert po.paged_attention.launches == n0, "int8 pools launched K1"
        ref = po.paged_attention_plain(q, kq.float() * ks[..., None, None],
                                       vq.float() * vs[..., None, None], pt,
                                       pos, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = _time_ms(torch, lambda: fq(q, kq, vq, ks, vs, pt, pos), 10,
                      self.flush)
        toks = int(lens.sum())
        rows.append(self._row(
            "K1 path, int8 pools H=6 (dequantizing gather, no K1)",
            "float32", err, ref.abs().max().item(), 1e-5, ms, ms,
            4 * toks * 6 * D, 2 * toks * 6 * (D + 4) + 2 * q.numel() * 4,
            None, kernel="paged_attention_int8_path", heads=6))
        # K5-K7 on dp rank 1's rows at the folded seed
        ids = self.splash_ids(SPLASH_SHAPE["B"])
        qs = ids[4:].contiguous()
        H, S, D = (SPLASH_SHAPE[k] for k in ("H", "S", "D"))
        sc = 1.0 / D ** 0.5
        seed = 4321 + 1               # the drawn seed + dp rank 1
        allowed = so._allowed(qs, qs, True)
        pairs = int(allowed.sum()) * H
        Bl, nt = qs.shape[0], S // 64
        # the tile bounds once, as SplashAttention computes them a call
        kv_lo, kv_hi, q_lo, q_hi = so._block_bounds(qs, qs, 64, 64, True)
        fb, bb = dict(bounds=(kv_lo, kv_hi)), dict(bounds=(q_lo, q_hi))
        for name in ("float32", "bfloat16"):
            dtype, tol = getattr(torch, name), FLASH_TOL[name]
            gg = torch.Generator(device="cuda").manual_seed(17)
            q, k, v, do = (torch.randn(Bl, H, S, D, generator=gg,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            bh_sd = Bl * H * S * D * q.element_size()
            row_b, ids_b = Bl * H * S * 4, 2 * Bl * S * 4 + 2 * Bl * nt * 4
            fargs = (q, k, v, qs, qs, True, sc, DROPOUT, seed)
            out, lse = so.splash_attention_fwd(*fargs, **fb)
            ref, ref_lse = so._splash_fwd_reference(*fargs)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K5 splash_fwd dp-local rank 1", name,
                max((out.float() - ref.float()).abs().max().item(),
                    (lse - ref_lse).abs().max().item()),
                ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: so.splash_attention_fwd(*fargs, **fb),
                         10),
                _time_ms(torch, lambda: so._splash_fwd_reference(*fargs), 3),
                4 * pairs * D, 4 * bh_sd + row_b + ids_b, None,
                kernel="splash_fwd", shape=f"{Bl}x{H}x{S}x{D}", seed=seed))
            delta = fo._delta(ref, do)
            bargs = (q, k, v, qs, qs, do, ref_lse, delta, True, sc, DROPOUT,
                     seed)
            dq = so.splash_attention_dq(*bargs, **fb)
            dq_ref = so._splash_dq_reference(*bargs)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K6 splash_dq dp-local rank 1", name,
                (dq.float() - dq_ref.float()).abs().max().item(),
                dq_ref.float().abs().max().item(), tol,
                _time_ms(torch, lambda: so.splash_attention_dq(*bargs, **fb),
                         10),
                _time_ms(torch, lambda: so._splash_dq_reference(*bargs), 3),
                6 * pairs * D, 5 * bh_sd + 2 * row_b + ids_b, None,
                kernel="splash_bwd_dq", shape=f"{Bl}x{H}x{S}x{D}", seed=seed))
            dk, dv = so.splash_attention_dkv(*bargs, **bb)
            dk_ref, dv_ref = so._splash_dkv_reference(*bargs)
            torch.cuda.synchronize()
            rows.append(self._row(
                "K7 splash_dkv dp-local rank 1", name, max(
                    (dk.float() - dk_ref.float()).abs().max().item(),
                    (dv.float() - dv_ref.float()).abs().max().item()),
                max(dk_ref.float().abs().max().item(),
                    dv_ref.float().abs().max().item()), tol,
                _time_ms(torch, lambda: so.splash_attention_dkv(*bargs, **bb),
                         10),
                _time_ms(torch, lambda: so._splash_dkv_reference(*bargs), 3),
                8 * pairs * D, 6 * bh_sd + 2 * row_b + ids_b, None,
                kernel="splash_bwd_dkv", shape=f"{Bl}x{H}x{S}x{D}",
                seed=seed))
            del q, k, v, do, out, lse, ref, ref_lse, dq, dq_ref, dk, dv
            del dk_ref, dv_ref, delta
        # the folded seed changes the mask: rank 0's seed gives another
        # output on the same rows
        q, k, v = (torch.randn(Bl, H, S, D, device="cuda") for _ in range(3))
        o0, _ = so.splash_attention_fwd(q, k, v, qs, qs, True, sc, DROPOUT,
                                        seed - 1)
        o1, _ = so.splash_attention_fwd(q, k, v, qs, qs, True, sc, DROPOUT,
                                        seed)
        assert not torch.equal(o0, o1), "rank-folded seeds gave one mask"
        del q, k, v, o0, o1, allowed, kv_lo, kv_hi, q_lo, q_hi
        torch.cuda.empty_cache()
        self.details["dist_kernels"] = rows

    # -- 15. dist ---------------------------------------------------------------

    def dist(self):
        """Phase 15 (see the module docstring): (a) world 1 over NCCL in
        this process, at GPT-2 small width; (b) two ranks on this one card
        over gloo with CUDA tensors, spawned by distributed.spawn, a
        correctness arm only (two processes share one card: no time it
        prints is a multi-card number)."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import distributed as D
        from paddle_tpu_torch.distributed import env as denv
        wd = tempfile.mkdtemp(prefix="chip_smoke_dist_")
        try:
            t0 = time.perf_counter()
            penv = D.init_parallel_env()
            print(f"dist (a): init_parallel_env -> backend "
                  f"{denv.backend()}, world {penv.world_size}, rank "
                  f"{penv.rank}, device {denv.local_device()}, "
                  f"{time.perf_counter() - t0:.2f} s")
            assert denv.backend() == "nccl" and penv.world_size == 1
            batch = self.dist_batch()
            state = self.dist_packed_a(batch, wd)
            self.dist_data_parallel_a()
            refs = self.dist_serving_a(wd)
            lanes_a = self.dist_lanes_a(wd)
            w1, w1_fit = self.dist_fleet_a(wd)
            hybrid = self.dist_hybrid_a(wd, batch)
            D.destroy_process_group()
            self.dist_b(wd, batch, state, refs)
            self.dist_strategies_b(wd, w1, w1_fit)
            self.dist_hybrid_b(wd, hybrid)
            self.dist_elastic_b(wd)
            self.dist_lanes_g(wd, refs, lanes_a)
        finally:
            from paddle_tpu_torch.distributed.env import destroy_process_group
            destroy_process_group()
            shutil.rmtree(wd, ignore_errors=True)

    def dist_batch(self):
        """Phase 15's global packed batch: DIST["ROWS"] rows of 1024 packed
        first-fit from the bench's sequences (phase 7's motif tokens)."""
        import numpy as np
        from paddle_tpu_torch import io
        lengths = _bench_lengths(np)
        n = int(np.searchsorted(np.cumsum(lengths),
                                0.93 * DIST["ROWS"] * PACK["T"]))
        return io.PackingCollator(PACK["T"], DIST["ROWS"])(
            _motif_seqs(np, lengths[:n]))

    def dist_packed_a(self, batch, wd):
        """(a) the packed LM's step (`_packed_gpt`, attention through
        sharded_splash_attention) through make_sharded_train_step at dp 1,
        ZeRO-1, DIST["STEPS"] steps, dropout 0, against the same model
        trained the same steps in one process by the optimizer's own step
        (phase 7's single-process path): losses to rtol 1e-5, each
        parameter's update within 1e-3 x its largest + 1e-6 x the model's
        largest (phase 7's gradient rule). Saves the weights and (a)'s
        losses for (b). Returns (a)'s record."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.parallel import make_sharded_train_step
        model = _packed_gpt(torch, sharded=True, dropout=0.0).cuda()
        torch.save(model.state_dict(), os.path.join(wd, "packed.pt"))
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        ref = _packed_gpt(torch, sharded=False, dropout=0.0).cuda()
        ref.load_state_dict(model.state_dict())
        ins = [torch.as_tensor(x).cuda() for x in batch[:3]]
        lbs = [torch.as_tensor(x).cuda() for x in batch[3:5]]
        # the single-process step
        opt = optimizer.Adam(DIST["LR"], parameters=ref.parameters())
        ref.train()
        ref_losses = []
        for _ in range(DIST["STEPS"]):
            lv = _packed_loss(torch, ref(*ins), lbs)
            lv.backward()
            opt.step()
            opt.clear_grad()
            ref_losses.append(float(lv))
        del opt
        # the sharded step
        opt = optimizer.Adam(DIST["LR"], parameters=model.parameters())
        step, st = make_sharded_train_step(
            model, opt, lambda o, lb: _packed_loss(torch, o, lb),
            zero_stage=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path starts here: every launch count from 0
        self.zero_launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DIST["STEPS"]):
            st, lv = step(st, ins, lbs)
            losses.append(float(lv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.record_path("dist_packed_dp1")
        peak = torch.cuda.max_memory_allocated()
        opt_bytes = sum(t.numel() * t.element_size()
                        for v in st["opt_state"].values()
                        for t in v.values())
        deltas_ref = {n: p.detach() - init[n]
                      for n, p in ref.named_parameters()}
        deltas = {n: p.detach() - init[n] for n, p in model.named_parameters()}
        worst = _grad_worst(deltas, deltas_ref, 1e-3, 1e-6)
        print(f"dist (a) packed LM ({DIST['LAYERS']} layers at GPT-2 small's "
              f"widths) [{DIST['ROWS']}, {PACK['T']}] "
              f"x {DIST['STEPS']} steps, dp 1 over nccl, ZeRO-1: losses "
              f"{[round(x, 6) for x in losses]} vs the single-process step "
              f"{[round(x, 6) for x in ref_losses]}; worst update max_abs_err "
              f"/ its tolerance {worst[0]:.3e} ({worst[1]}); wall "
              f"{wall:.3f} s, peak allocated {peak / 2**30:.2f} GiB, "
              f"optimizer state {opt_bytes / 2**20:.1f} MiB; launches K5 "
              f"{launches['splash_fwd']} K6 {launches['splash_bwd_dq']} K7 "
              f"{launches['splash_bwd_dkv']}")
        for a, b in zip(losses, ref_losses):
            assert abs(a - b) <= 1e-5 * abs(b), "dist (a) loss differs"
        assert worst[0] <= 1.0, f"dist (a) update of {worst[1]} differs"
        L = DIST["LAYERS"]
        for k in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
            assert launches[k] == L * DIST["STEPS"], (k, launches[k])
        rec = dict(losses=losses, ref_losses=ref_losses, wall_s=wall,
                   peak_bytes=peak, opt_bytes=opt_bytes, launches=launches,
                   worst_update_over_tol=worst[0])
        self.details["dist_packed_a"] = rec
        del model, ref, st, step, opt, init, deltas, deltas_ref
        torch.cuda.empty_cache()
        return rec

    def dist_data_parallel_a(self):
        """(a) one AMP bf16 step of GPT-2 small at [2, 1024], dropout 0,
        through DataParallel (world 1 over NCCL: the bucketed reducer's
        all-reduce runs) against the same step without it, from the same
        weights: phase 6's AMP limits (loss AMP_LOSS_RTOL, gradients
        AMP_GRAD_SHARE x their max + AMP_GRAD_FLOOR x the model's), K2-K4
        12 launches each in bf16."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import amp, nn
        from paddle_tpu_torch.distributed import DataParallel
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
        net = GPTForCausalLM(GPTConfig(dropout=0.0), device="cuda", seed=0)
        loss_fn = nn.CrossEntropyLoss()
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, net.gpt.config.vocab_size, size=(2, 1025)))
        x, y = ids[:, :-1].cuda(), ids[:, 1:].cuda()

        def one(module):
            net.train()
            self.zero_launches()
            t0 = time.perf_counter()
            with amp.auto_cast(dtype="bfloat16"):
                lv = loss_fn(module(x), y).float().mean()
            lv.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
            for p in net.parameters():
                p.grad = None
            return float(lv.detach()), grads, wall

        lp, gp, _ = one(net)
        dp = DataParallel(net)
        torch.cuda.reset_peak_memory_stats()
        ld, gd, wall = one(dp)
        launches = self.record_path("dist_data_parallel")
        by = self.path_dtype_launches["dist_data_parallel"]
        peak = torch.cuda.max_memory_allocated()
        worst = _grad_worst(gd, gp, AMP_GRAD_SHARE["bfloat16"],
                            AMP_GRAD_FLOOR)
        print(f"dist (a) DataParallel AMP bf16 GPT-2 small step [2, 1024] "
              f"over nccl (world 1, {len(dp._buckets)} buckets): loss "
              f"{ld:.6f} vs {lp:.6f} without it; worst gradient max_abs_err "
              f"/ its tolerance {worst[0]:.3e} ({worst[1]}); wall "
              f"{wall:.3f} s, peak allocated {peak / 2**30:.2f} GiB; "
              f"launches by type K2 {by['flash_fwd']} K3 "
              f"{by['flash_bwd_dq']} K4 {by['flash_bwd_dkv']}")
        assert abs(ld - lp) <= AMP_LOSS_RTOL["bfloat16"] * abs(lp)
        assert worst[0] <= 1.0, f"DataParallel gradient {worst[1]} differs"
        L = net.gpt.config.num_layers
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert by[k] == {"bfloat16": L}, (k, by[k])
        self.details["dist_data_parallel"] = dict(
            loss=ld, loss_plain=lp, worst_grad_over_tol=worst[0],
            wall_s=wall, peak_bytes=peak, launches=launches)
        del net, dp, gp, gd
        torch.cuda.empty_cache()

    def dist_serve(self, kv, prompts, new, num_pages, record):
        """Phase 5's requests through a GenerationEngine at tp 1 (with the
        process group live) on pools of `kv`: outputs, launches."""
        torch = self.torch
        from paddle_tpu_torch.serving import GenerationEngine
        eng = GenerationEngine(
            self.gpt, device="cuda", name=f"dist_tp1_{kv}", tp=1,
            kv_cache_dtype=kv, **_dist_engine_kw(num_pages))
        self.zero_launches()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        outs = [f.result(600) for f in futs]
        wall = time.perf_counter() - t0
        steps = eng.stats()["steps"]
        eng.shutdown()
        launches = (self.record_path(record) if record
                    else self.read_launches())
        return outs, steps, wall, launches

    def dist_serving_a(self, wd):
        """(a) phase 5's 16 greedy requests through a tp = 1 engine built
        with the process group live: token-identical to generate(); the
        int8-page engine's outputs kept as (b)'s int8 reference."""
        torch = self.torch
        if getattr(self, "gpt", None) is None:
            # phase 5's model (seed 0), released by a later phase
            from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
            self.gpt = GPTForCausalLM(GPTConfig(), device="cuda",
                                      seed=0).eval()
        torch.save(self.gpt.state_dict(), os.path.join(wd, "gpt.pt"))
        with open(os.path.join(wd, "gpt.json"), "w") as f:
            json.dump(vars(self.gpt.gpt.config), f)
        prompts, new = self.serving_requests(self.gpt.gpt.config.vocab_size)
        num_pages = 1 + sum(-(-(len(p) + m) // 16)
                            for p, m in zip(prompts, new))
        outs, steps, wall, launches = self.dist_serve(
            "auto", prompts, new, num_pages, "dist_serving_tp1")
        refs = getattr(self, "serving_refs", None)
        refs = self.assert_identical("dist (a) tp 1", prompts, new, outs,
                                     refs)
        L = self.gpt.gpt.config.num_layers
        assert launches["paged_attention"] == steps * L, launches
        q8, _, _, _ = self.dist_serve("int8", prompts, new, num_pages, None)
        print(f"dist (a) tp 1 engine over the live process group: 16 "
              f"requests token-identical to generate() in {wall:.3f} s, "
              f"{steps} steps, K1 {launches['paged_attention']} K2 "
              f"{launches['flash_fwd']}; the int8-page engine's outputs "
              f"kept for (b)")
        self.details["dist_serving_a"] = dict(wall_s=wall, steps=steps,
                                              launches=launches)
        return dict(prompts=prompts, new=new, num_pages=num_pages,
                    fp32=refs, int8=q8)

    def dist_b(self, wd, batch, state_a, refs):
        """(b) two ranks on this card over gloo with CUDA tensors (see
        `_dist_rank`), spawned by distributed.spawn; their records are
        checked here: tp 2 serving identical to tp 1 up to near-ties (C2:
        first tokens exact, a first flip only at a top-2 gap < NEAR_TIE),
        K1 on 6 local heads in each rank; dp 2 losses with dropout off
        within rtol 2e-4 / atol 2e-5 of (a)'s; with dropout on the ranks'
        keep shares on identical rows differ; ZeRO-1 optimizer bytes a
        rank about half of (a)'s."""
        import numpy as np
        from paddle_tpu_torch import distributed as D
        np.savez(os.path.join(wd, "batch.npz"), *batch)
        with open(os.path.join(wd, "requests.json"), "w") as f:
            json.dump({"prompts": [p.tolist() for p in refs["prompts"]],
                       "new": refs["new"], "num_pages": refs["num_pages"]},
                      f)
        print("dist (b): a correctness arm — two ranks share this one "
              "card over gloo; no time below is a multi-card number")
        try:
            D.spawn(_dist_probe, args=(wd,), nprocs=2, timeout=120)
        except RuntimeError as e:
            # a collective that ends the process is recorded as missing;
            # the arms below must not need it (DIST["NEEDS"])
            print(f"dist (b) probe: {e}")
        collectives = _probe_outcomes(wd)
        t0 = time.perf_counter()
        D.spawn(_dist_rank, args=(wd,), nprocs=2, timeout=DIST["TIMEOUT"])
        spawn_s = time.perf_counter() - t0
        recs = []
        for r in range(2):
            with open(os.path.join(wd, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        r0, r1 = recs
        print(f"dist (b): 2 ranks spawned and joined in {spawn_s:.1f} s; "
              f"backend {[x['backend'] for x in recs]}, devices "
              f"{[x['device'] for x in recs]}")
        missing = sorted(k for k, v in collectives.items() if v != "ok")
        print(f"dist (b): gloo on CUDA tensors: "
              + ", ".join(f"{k} {v}" for k, v in collectives.items()))
        print(f"dist (b): collectives gloo refused on CUDA tensors: "
              f"{missing if missing else 'none'}; the arms need "
              f"{sorted(DIST['NEEDS'])}")
        assert not set(missing) & set(DIST["NEEDS"]), missing
        # serving
        L = self.gpt.gpt.config.num_layers
        prompts, new = refs["prompts"], refs["new"]
        for kv in ("fp32", "int8"):
            s0, s1 = r0["serve"][kv], r1["serve"][kv]
            outs = [np.asarray(o) for o in s0["outs"]]
            ref = refs[kv]
            first = [(o[len(p)], rf[len(p)]) for o, rf, p in
                     zip(outs, ref, prompts)]
            flips = self.first_flips(prompts, new, outs,
                                     [np.asarray(x) for x in ref])
            for i, step, gap in flips:
                print(f"dist (b) tp 2 {kv}: request {i} first differs at "
                      f"step {step}, top-2 logit gap {gap:.3e}")
            print(f"dist (b) tp 2 GPT-2 small {kv} pools: 16 requests in "
                  f"{s0['wall_s']:.3f} s, {s0['steps']} steps, "
                  f"{len(flips)} outputs differ from tp 1 (all at gaps < "
                  f"{NEAR_TIE}); local heads {s0['local_heads']} / "
                  f"{s1['local_heads']}; K1 launches rank 0 "
                  f"{s0['launches']['paged_attention']} rank 1 "
                  f"{s1['launches']['paged_attention']}, K2 "
                  f"{s0['launches']['flash_fwd']} / "
                  f"{s1['launches']['flash_fwd']}; peak allocated "
                  f"{s0['peak_bytes'] / 2**30:.2f} / "
                  f"{s1['peak_bytes'] / 2**30:.2f} GiB")
            assert all(a == b for a, b in first), f"{kv}: first tokens"
            assert all(gap < NEAR_TIE for _, _, gap in flips), flips
            # the tp 2 lane's outputs: (g)'s lanes are held to them
            refs[f"tp2_{kv}"] = outs
            assert s0["local_heads"] == s1["local_heads"] == 6
            if kv == "fp32":
                # rank 0's warmup decode and every step, 12 layers each
                want = (s0["steps"] + 1) * L
                assert s0["launches"]["paged_attention"] == want, s0
                assert s1["launches"]["paged_attention"] == want, s1
            else:
                assert s0["launches"]["paged_attention"] == 0
            for r, rec in enumerate(recs):
                self.path_launches[f"dist_serve_tp2_{kv}_r{r}"] = \
                    rec["serve"][kv]["launches"]
                self.path_dtype_launches[f"dist_serve_tp2_{kv}_r{r}"] = \
                    rec["serve"][kv]["launches_by_dtype"]
        # training
        a = state_a["losses"]
        for r, rec in enumerate(recs):
            t = rec["train"]
            print(f"dist (b) dp 2 rank {r} packed LM, ZeRO-1: "
                  f"dropout off losses {[round(x, 6) for x in t['losses']]} "
                  f"vs (a) {[round(x, 6) for x in a]}; dropout {DROPOUT} "
                  f"losses {[round(x, 6) for x in t['losses_dropout']]}; "
                  f"keep share on identical rows {t['keep_share']:.6f}; "
                  f"optimizer state {t['opt_bytes'] / 2**20:.1f} MiB = "
                  f"{t['opt_bytes'] / state_a['opt_bytes']:.4f} of (a)'s; "
                  f"wall {t['wall_s']:.3f} s (dropout off) "
                  f"{t['wall_dropout_s']:.3f} s (on), peak allocated "
                  f"{t['peak_bytes'] / 2**30:.2f} GiB; launches K5 "
                  f"{t['launches']['splash_fwd']} K6 "
                  f"{t['launches']['splash_bwd_dq']} K7 "
                  f"{t['launches']['splash_bwd_dkv']}")
            np.testing.assert_allclose(t["losses"], a, rtol=2e-4, atol=2e-5)
            assert all(np.isfinite(t["losses_dropout"]))
            assert abs(t["opt_bytes"] / state_a["opt_bytes"] - 0.5) < 0.01
            n = DIST["LAYERS"] * (2 * DIST["STEPS"])
            assert t["launches"]["splash_fwd"] == n + 1, t["launches"]
            assert t["launches"]["splash_bwd_dq"] == n
            self.path_launches[f"dist_packed_dp2_r{r}"] = t["launches"]
            self.path_dtype_launches[f"dist_packed_dp2_r{r}"] = \
                t["launches_by_dtype"]
        assert r0["train"]["keep_share"] != r1["train"]["keep_share"], \
            "the two dp ranks drew one keep mask"
        self.details["dist_b"] = dict(spawn_s=spawn_s, ranks=recs,
                                      collectives=collectives)

    def dist_fleet_a(self, wd):
        """(a) fleet.init + hapi Model.fit under a default strategy (world
        1 over NCCL, so fit takes the single-process step) on 3 batches of
        STRAT["ROWS"] x STRAT["S"] of GPT-2 small, fp32, SGD: per-step
        losses and the final parameters bit-equal to the same 3 steps of
        make_sharded_train_step (dp 1, ZeRO-1); K2-K4 12 launches a step
        each in fp32; the same fit under O1, K2-K4 all bf16. Then the
        world-1 reference of (b)'s strategy arms: 2 steps of
        make_sharded_train_step on the first batch, its losses and its
        updates after 1 and 2 steps saved for the ranks; and of (b)'s
        fleet fit over a padded tail: Model.fit of R + R/2 rows at batch
        R, its update saved. Returns both references' losses."""
        torch = self.torch
        import numpy as np
        from paddle_tpu_torch import Model, callbacks, io, nn, optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.models import GPTForCausalLM
        from paddle_tpu_torch.parallel import make_sharded_train_step
        cfg = _strat_config()
        R, S, lr = STRAT["ROWS"], STRAT["S"], STRAT["LR"]
        ids = np.random.RandomState(3).randint(
            0, cfg.vocab_size, size=(3 * R, S + 1))
        X, Y = ids[:, :-1], ids[:, 1:]
        ce = nn.CrossEntropyLoss()
        fleet.init(is_collective=True)
        try:
            # make_sharded_train_step on the fit's batches
            net = GPTForCausalLM(cfg, device="cuda", seed=0)
            step, st = make_sharded_train_step(
                net, optimizer.SGD(lr, parameters=net.parameters()),
                lambda o, lb: ce(o, lb[0]), zero_stage=1)
            ref = []
            for i in range(3):
                st, lv = step(st, (X[i * R:(i + 1) * R],),
                              (Y[i * R:(i + 1) * R],))
                ref.append(float(lv))
            ref_p = {n: p.detach().clone()
                     for n, p in net.named_parameters()}
            del net, step, st

            class Rows(io.Dataset):
                def __init__(self, n=len(X)):
                    self.n = n

                def __len__(self):
                    return self.n

                def __getitem__(self, i):
                    return X[i], Y[i]

            for level in (None, "O1"):
                net = GPTForCausalLM(cfg, device="cuda", seed=0)
                model = Model(net)
                model.prepare(optimizer.SGD(lr, parameters=net.parameters()),
                              ce, amp_configs=level)
                got, walls = [], []

                class Rec(callbacks.Callback):
                    def on_train_batch_begin(self, step, logs=None):
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter())

                    def on_train_batch_end(self, step, logs=None):
                        got.append(float(logs["loss"]))
                        walls[-1] = time.perf_counter() - walls[-1]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                tag = "dist_fleet_fit_" + ("o1" if level else "fp32")
                self.zero_launches()
                model.fit(Rows(), batch_size=R, epochs=1, shuffle=False,
                          verbose=0, log_freq=1, callbacks=[Rec()])
                torch.cuda.synchronize()
                self.record_path(tag)
                by = self.path_dtype_launches[tag]
                peak = torch.cuda.max_memory_allocated()
                dt = "bfloat16" if level else "float32"
                routed = model._dist_ctx is not None
                line = (f"dist (a) fleet.init + Model.fit{' O1' if level else ''}"
                        f" GPT-2 small [{R}, {S}] x 3 steps (world 1: "
                        f"routed through fleet: {routed}): losses "
                        f"{[round(x, 6) for x in got]}; step wall "
                        f"{[round(w, 4) for w in walls]} s, peak allocated "
                        f"{peak / 2**30:.2f} GiB; launches by type K2 "
                        f"{by['flash_fwd']} K3 {by['flash_bwd_dq']} K4 "
                        f"{by['flash_bwd_dkv']}; {self.smi}")
                if level is None:
                    same = all(torch.equal(p.detach(), ref_p[n])
                               for n, p in net.named_parameters())
                    line += (f"; vs make_sharded_train_step "
                             f"{[round(x, 6) for x in ref]}: losses "
                             f"bit-equal {got == ref}, parameters bit-equal "
                             f"{same}")
                print(line)
                assert len(got) == 3 and all(np.isfinite(got)), got
                if level is None:
                    assert got == ref and same, "fleet fit != sharded step"
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    assert by[k] == {dt: 3 * cfg.num_layers}, (k, by[k])
                self.details[tag] = dict(losses=got, step_wall_s=walls,
                                         peak_bytes=peak, launches=by)
                del net, model
                torch.cuda.empty_cache()
            # (b)'s world-1 reference
            net = GPTForCausalLM(cfg, device="cuda", seed=0)
            init = {n: p.detach().clone() for n, p in net.state_dict().items()}
            torch.save(init, os.path.join(wd, "s_init.pt"))
            step, st = make_sharded_train_step(
                net, optimizer.SGD(lr, parameters=net.parameters()),
                lambda o, lb: ce(o, lb[0]), zero_stage=1)
            losses, deltas = [], {}
            for i in range(2):
                st, lv = step(st, (X[:R],), (Y[:R],))
                losses.append(float(lv))
                deltas[f"d{i + 1}"] = {n: p.detach() - init[n]
                                       for n, p in net.named_parameters()}
            torch.save(deltas, os.path.join(wd, "s_ref.pt"))
            np.savez(os.path.join(wd, "s_batch.npz"), x=X[:R], y=Y[:R])
            with open(os.path.join(wd, "s_cfg.json"), "w") as f:
                json.dump(vars(cfg), f)
            print(f"dist (a) world-1 reference of (b)'s strategy arms: "
                  f"GPT-2 small [{R}, {S}], SGD {lr}, losses "
                  f"{[round(x, 6) for x in losses]}")
            del net, step, st, deltas
            torch.cuda.empty_cache()
            # (b)'s fleet fit over a padded tail: the world-1 Model.fit of
            # R + R/2 rows at batch R (a full batch, then R/2 real rows
            # padded to R under a row mask)
            n_fit = R + R // 2
            net = GPTForCausalLM(cfg, device="cuda", seed=0)
            model = Model(net)
            model.prepare(optimizer.SGD(lr, parameters=net.parameters()), ce)
            fit_losses = []

            class Loss(callbacks.Callback):
                def on_train_batch_end(self, step, logs=None):
                    fit_losses.append(float(logs["loss"]))
            model.fit(Rows(n_fit), batch_size=R, epochs=1, shuffle=False,
                      verbose=0, log_freq=1, callbacks=[Loss()])
            torch.save({n: p.detach() - init[n]
                        for n, p in net.named_parameters()},
                       os.path.join(wd, "s_fit_ref.pt"))
            np.savez(os.path.join(wd, "s_fit_batch.npz"), x=X[:n_fit],
                     y=Y[:n_fit])
            print(f"dist (a) world-1 reference of (b)'s fleet fit: Model.fit "
                  f"GPT-2 small {n_fit} rows at batch {R} (the tail padded "
                  f"under a row mask), losses "
                  f"{[round(x, 6) for x in fit_losses]}")
            assert len(fit_losses) == 2 and np.all(np.isfinite(fit_losses))
            del net, model, init
            torch.cuda.empty_cache()
            return losses, fit_losses
        finally:
            from paddle_tpu_torch.parallel import set_mesh
            fleet.fleet._inited = False
            set_mesh(None)

    def dist_strategies_b(self, wd, w1, w1_fit):
        """(b) the strategies on two gloo ranks of this card (see
        `_dist_rank_strategies`), spawned by distributed.spawn; a
        correctness cell: no time it prints is a multi-card number. Each
        arm's losses within rtol 2e-4 / atol 2e-5 of (a)'s world-1 steps
        (the fleet fits: of (a)'s world-1 fit, `w1_fit`, for the padded
        tail) and each update within phase 7's gradient rule (1e-3 x its
        max + 1e-6 x the largest) widened by the fp32 weights' own
        resolution (`_update_worst`); launches each arm implies, all
        fp32."""
        import numpy as np
        from paddle_tpu_torch import distributed as D
        t0 = time.perf_counter()
        D.spawn(_dist_rank_strategies, args=(wd, "cuda"), nprocs=2,
                timeout=STRAT["TIMEOUT"])
        spawn_s = time.perf_counter() - t0
        recs = []
        for r in range(2):
            with open(os.path.join(wd, f"strat{r}.json")) as f:
                recs.append(json.load(f))
        print(f"dist (b) strategies: 2 ranks spawned and joined in "
              f"{spawn_s:.1f} s (one card, gloo; {self.smi})")
        self.details["dist_strategies_b"] = dict(spawn_s=spawn_s, ranks=recs)
        L, M = _strat_config().num_layers, STRAT["N_MICRO"]
        k = L // 2
        fails = []

        def check(ok, what):
            if not ok:
                fails.append(what)

        def keep(arm, r, rec):
            self.path_launches[f"dist_{arm}_r{r}"] = rec["launches"]
            self.path_dtype_launches[f"dist_{arm}_r{r}"] = \
                rec["launches_by_dtype"]

        def kernels(rec, k2, k34):
            by = rec["launches_by_dtype"]
            return (by["flash_fwd"] == ({"float32": k2} if k2 else {})
                    and by["flash_bwd_dq"] == ({"float32": k34} if k34
                                               else {})
                    and by["flash_bwd_dkv"] == ({"float32": k34} if k34
                                                else {}))

        def close(a, b):
            return bool(np.allclose(a, b, rtol=2e-4, atol=2e-5))
        for r, rec in enumerate(recs):
            c = rec["c35"]
            print(f"dist (b) C35 rank {r}: send/recv of a CUDA tensor over "
                  f"gloo bit-exact {c['send_recv']}, ppermute hop "
                  f"{c['hop']}, its gradient {c['grad']}")
            check(c["send_recv"] and c["hop"] and c["grad"], f"c35 r{r}")
        for arm, k2 in (("pp_gpipe", k * M), ("pp_gpipe_recompute",
                                              2 * k * M),
                        ("pp_1f1b", 2 * k * M)):
            for r, rec in enumerate(recs):
                a = rec[arm]
                print(f"dist (b) {arm} rank {r} (pp 2, stage {a['stage']}, "
                      f"{a['held']} parameters held, n_micro {M}): losses "
                      f"{[round(x, 6) for x in a['losses']]} vs world 1 "
                      f"{[round(x, 6) for x in w1]}; worst update / its "
                      f"tolerance {a['worst'][0]:.3e} ({a['worst'][1]}); "
                      f"step wall {[round(x, 3) for x in a['step_s']]} s, "
                      f"peak allocated {a['peak_bytes'] / 2**30:.2f} GiB; "
                      f"launches by type K2 "
                      f"{a['launches_by_dtype']['flash_fwd']} K3 "
                      f"{a['launches_by_dtype']['flash_bwd_dq']} K4 "
                      f"{a['launches_by_dtype']['flash_bwd_dkv']}; {self.smi}")
                check(close(a["losses"], w1[:len(a["losses"])]),
                      f"{arm} r{r} losses")
                check(a["worst"][0] <= 1.0, f"{arm} r{r} update")
                n = len(a["losses"])
                check(kernels(a, k2 * n, k * M * n), f"{arm} r{r} launches")
                keep(arm, r, a)
        for r, rec in enumerate(recs):
            a = rec["sp"]
            for name, e in sorted(a["attn"].items()):
                print(f"dist (b) sp 2 {name} causal at S {STRAT['S']} "
                      f"({STRAT['S'] // 2} a rank) rank {r}: output and "
                      f"q/k/v gradients vs whole-sequence attention, max err "
                      f"/ max(1, |ref|) {e:.3e}")
                lim = 1e-5 if name.endswith("float32") else 2e-2
                check(e <= lim, f"sp {name} r{r}")
            print(f"dist (b) sp 2 make_sharded_train_step(sp_axis='sp') of "
                  f"the GPT with use_ring=True rank {r}: loss "
                  f"{a['loss']:.6f} vs world 1 {w1[0]:.6f}; worst update / "
                  f"its tolerance {a['worst'][0]:.3e} ({a['worst'][1]}); "
                  f"step wall {a['step_s']:.3f} s, peak allocated "
                  f"{a['peak_bytes'] / 2**30:.2f} GiB; launches K2 "
                  f"{a['launches']['flash_fwd']} K3 "
                  f"{a['launches']['flash_bwd_dq']} K4 "
                  f"{a['launches']['flash_bwd_dkv']}; {self.smi}")
            check(close([a["loss"]], [w1[0]]), f"sp r{r} loss")
            check(a["worst"][0] <= 1.0, f"sp r{r} update")
            check(kernels(a, 0, 0), f"sp r{r} launched K2-K4")
            keep("sp", r, a)
        for r, rec in enumerate(recs):
            a = rec["local1"]
            print(f"dist (b) LocalSGD k_steps=1 dp 2 rank {r}: losses "
                  f"{[round(x, 6) for x in a['losses']]} vs synchronous dp "
                  f"(world 1) {[round(x, 6) for x in w1]}; worst update / "
                  f"its tolerance {a['worst'][0]:.3e} ({a['worst'][1]}); "
                  f"step wall {[round(x, 3) for x in a['step_s']]} s, peak "
                  f"allocated {a['peak_bytes'] / 2**30:.2f} GiB; launches "
                  f"by type K2 {a['launches_by_dtype']['flash_fwd']}; "
                  f"{self.smi}")
            check(close(a["losses"], w1), f"local1 r{r} losses")
            check(a["worst"][0] <= 1.0, f"local1 r{r} update")
            check(kernels(a, L * 2, L * 2), f"local1 r{r} launches")
            keep("localsgd_k1", r, a)
        f0, f1 = (rec["local4"]["prints"] for rec in recs)
        kk = STRAT["LOCAL_K4"]
        same = [a == b for a, b in zip(f0, f1)]
        print(f"dist (b) LocalSGD k_steps={kk} over {len(same)} steps: the "
              f"ranks' parameters equal after each step {same} (a sync "
              f"after step {kk}); step wall "
              f"{[round(x, 3) for x in recs[0]['local4']['step_s']]} s, "
              f"peak allocated "
              f"{recs[0]['local4']['peak_bytes'] / 2**30:.2f} GiB; "
              f"{self.smi}")
        check(same == [(i + 1) % kk == 0 for i in range(len(same))],
              "local4 sync pattern")
        for r, rec in enumerate(recs):
            keep("localsgd_k4", r, rec["local4"])
        for r, rec in enumerate(recs):
            a = rec["dgc"]
            print(f"dist (b) DGC sparsity {STRAT['DGC_SPARSITY']} dp 2 rank "
                  f"{r}: losses {[round(x, 6) for x in a['losses']]}; kept "
                  f"{a['kept']} of {a['size']} entries a step ({a['ties']} "
                  f"tensor-steps over k, all at ties: {a['ties_ok']}); "
                  f"emitted, u, v vs dgc_compress on the CPU, max abs diff "
                  f"{a['cpu_diff']}; step wall "
                  f"{[round(x, 3) for x in a['step_s']]} s, peak allocated "
                  f"{a['peak_bytes'] / 2**30:.2f} GiB; {self.smi}")
            check(all(np.isfinite(a["losses"])), f"dgc r{r} loss")
            check(a["k_ok"] and a["ties_ok"], f"dgc r{r} kept")
            check(max(a["cpu_diff"]) == 0.0, f"dgc r{r} vs cpu")
            check(kernels(a, L * STRAT["DGC_STEPS"], L * STRAT["DGC_STEPS"]),
                  f"dgc r{r} launches")
            keep("dgc", r, a)
        for arm, ref, k2 in (("fit_pp", w1, k * M), ("fit_dp_tail", w1_fit,
                                                     L)):
            for r, rec in enumerate(recs):
                a = rec[arm]
                print(f"dist (b) fleet.init + distributed_optimizer + "
                      f"Model.fit, {arm} rank {r} (mesh {a['mesh']}, routed "
                      f"through the strategy's step {a['routed']}): losses "
                      f"{[round(x, 6) for x in a['losses']]} vs world 1 "
                      f"{[round(x, 6) for x in ref]}; worst update / its "
                      f"tolerance {a['worst'][0]:.3e} ({a['worst'][1]}); "
                      f"step wall {[round(x, 3) for x in a['step_s']]} s, "
                      f"peak allocated {a['peak_bytes'] / 2**30:.2f} GiB; "
                      f"launches by type K2 "
                      f"{a['launches_by_dtype']['flash_fwd']} K3 "
                      f"{a['launches_by_dtype']['flash_bwd_dq']} K4 "
                      f"{a['launches_by_dtype']['flash_bwd_dkv']}; {self.smi}")
                check(a["routed"] and a["mesh_ok"], f"{arm} r{r} routing")
                check(len(a["losses"]) == len(ref)
                      and close(a["losses"], ref), f"{arm} r{r} losses")
                check(a["worst"][0] <= 1.0, f"{arm} r{r} update")
                n = len(a["losses"])
                check(kernels(a, k2 * n, k2 * n), f"{arm} r{r} launches")
                keep(arm, r, a)
        assert not fails, fails

    def dist_hybrid_a(self, wd, batch):
        """(a) the world-1 references of (b)'s hybrid arms (see
        `_hybrid_arms`), each saved as its updates (on the host) for
        the ranks, through make_sharded_train_step at world 1 over NCCL,
        ZeRO-1, HYBRID["STEPS"] steps: ERNIE-base at dropout 0 and
        DROPOUT, and one SGD step under O1 and in fp32; the MoE GPT; the
        packed LM at dp 1 under the clip; the strategies' GPT under the clip
        in fp32 and O1. Returns their losses and the MoE's expert
        bytes."""
        torch = self.torch
        import contextlib
        import numpy as np
        from paddle_tpu_torch import amp, nn, optimizer
        from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                             GPTConfig, GPTForCausalLM)
        from paddle_tpu_torch.parallel import (create_mesh,
                                               make_sharded_train_step,
                                               set_mesh)
        ce = nn.CrossEntropyLoss()
        refs = {}
        n = HYBRID["STEPS"]

        def run(tag, m, opt_fn, ins, lbs, steps=n, level=None,
                loss=lambda o, lb: ce(o, lb[0]), batches=None, **kw):
            init = {k: q.detach().clone() for k, q in m.named_parameters()}
            step, st = make_sharded_train_step(m, opt_fn(m), loss,
                                               zero_stage=1)
            losses = []
            for i in range(steps):
                if batches is not None:
                    ins, lbs = batches[i]
                with (amp.auto_cast(level=level) if level
                      else contextlib.nullcontext()):
                    st, lv = step(st, ins, lbs, **kw)
                losses.append(float(lv))
            torch.save({k: (q.detach() - init[k]).cpu()
                        for k, q in m.named_parameters()},
                       os.path.join(wd, f"h_{tag}.pt"))
            refs[tag] = losses
            print(f"dist (a) world-1 reference {tag}: losses "
                  f"{[round(x, 6) for x in losses]}")
            del init, step, st
            torch.cuda.empty_cache()
        for tag, p in (("p0", 0.0), ("p1", DROPOUT), ("o1", 0.0),
                       ("o1_fp32", 0.0)):
            cfg, batches = _hybrid_ernie(np, p)
            m = ErnieForSequenceClassification(cfg, device="cuda", seed=0)
            run(f"ernie_{tag}", m,
                lambda m, tag=tag: _hybrid_ernie_opt(optimizer, tag, m),
                None, None, n if tag in ("p0", "p1") else 1,
                "O1" if tag == "o1" else None, batches=batches, rng=7)
            del m
        x, y = _hybrid_moe_batch(np)
        m = GPTForCausalLM(_hybrid_moe_config(), device="cuda", seed=0)
        refs["moe_expert_bytes"] = sum(
            q.numel() * q.element_size() for k, q in m.named_parameters()
            if k.endswith(("w_up", "w_down")))
        run("moe", m, lambda m: optimizer.SGD(
            STRAT["LR"], parameters=m.parameters()), (x,), (y,))
        del m
        create_mesh({"dp": 1})
        try:
            m = _packed_gpt(torch, sharded=True, dropout=0.0).cuda()
            m.load_state_dict(torch.load(os.path.join(wd, "packed.pt"),
                                         map_location="cuda"))
            run("packed_clip", m, lambda m: optimizer.SGD(
                STRAT["LR"], parameters=m.parameters(),
                grad_clip=nn.ClipGradByGlobalNorm(HYBRID["CLIP"])),
                [torch.as_tensor(v).cuda() for v in batch[:3]],
                [torch.as_tensor(v).cuda() for v in batch[3:5]],
                loss=lambda o, lb: _packed_loss(torch, o, lb))
            del m
        finally:
            set_mesh(None)
        with open(os.path.join(wd, "s_cfg.json")) as f:
            scfg = GPTConfig(**json.load(f))
        zs = np.load(os.path.join(wd, "s_batch.npz"))
        init_s = torch.load(os.path.join(wd, "s_init.pt"), map_location="cuda")
        for tag, level in (("fp32", None), ("o1", "O1")):
            m = GPTForCausalLM(scfg, device="cuda", seed=0)
            m.load_state_dict(init_s)
            run(f"pp_{tag}", m, lambda m: optimizer.SGD(
                STRAT["LR"], parameters=m.parameters(),
                grad_clip=nn.ClipGradByGlobalNorm(HYBRID["CLIP"])),
                (zs["x"],), (zs["y"],), level=level)
            del m
        del init_s
        torch.cuda.empty_cache()
        return refs

    def dist_hybrid_b(self, wd, refs):
        """(b) the hybrid arms on two gloo ranks of this card (see
        `_hybrid_arms`), run by the strategy arms' ranks; a correctness
        cell: no time it prints is a multi-card number. Gates: losses
        within rtol 2e-4 / atol 2e-5 of their reference (the pipeline's
        O1: AMP_LOSS_RTOL; ERNIE's O1 step: phase 8 (c)'s
        ERNIE_AMP_LOSS_TOL),
        each update within phase 7's rule (the pipeline's O1: phase 6's
        AMP rule; ERNIE's O1 SGD step: `_bf16_worst`, phase 6's AMP
        allowance plus twice the distance bf16 puts world 1's update from
        its fp32 update; ERNIE's AdamW steps: `_adam_worst`,
        every element within PARAM plus the most two AdamW runs can part,
        at most ADAM_SHARE of each parameter's elements outside PARAM,
        and the fault it reads above ADAM_SHARE), the keys' bias
        left out of Adam-family updates (`_without_key_bias`); the
        ERNIE rank attends 6 heads, K2-K4 12 launches a step in the path's
        type; the MoE rank holds 4 experts, half of world 1's expert
        bytes; ZeRO-3 holds half the parameter bytes a rank between steps,
        its allocated bytes at least 0.9 x that half below ZeRO-2's (the
        same step; ZeRO-1's recorded by the Lamb arm); DGC at ZeRO-2 keeps
        the entries ZeRO-0 keeps; K5-K7 and the pipeline's K2-K4 the
        launches each arm implies."""
        import numpy as np
        recs = []
        for r in range(2):
            with open(os.path.join(wd, f"hybrid{r}.json")) as f:
                recs.append(json.load(f))
        print(f"dist (b) hybrid: run by the strategy arms' 2 ranks (one "
              f"card, gloo; {self.smi})")
        self.details["dist_hybrid_b"] = dict(ranks=recs, refs=refs)
        n, fails = HYBRID["STEPS"], []

        def check(ok, what):
            if not ok:
                fails.append(what)

        def close(a, b, amp_level=False):
            if amp_level == "ernie":
                # phase 8 (c)'s bf16 limit on a classifier's loss: the
                # row-parallel sums add a bf16 rounding a layer
                return all(abs(x - y)
                           <= ERNIE_AMP_LOSS_TOL * max(1.0, abs(y))
                           for x, y in zip(a, b))
            if amp_level:
                return bool(np.allclose(a, b, rtol=AMP_LOSS_RTOL["bfloat16"],
                                        atol=0))
            return bool(np.allclose(a, b, rtol=2e-4, atol=2e-5))

        def by(a, k):
            return a["launches_by_dtype"][k]

        def line(arm, r, a, ref, extra=""):
            print(f"dist (b) {arm} rank {r}: losses "
                  f"{[round(x, 6) for x in a['losses']]} vs "
                  f"{[round(x, 6) for x in ref]}; worst {a['worst'][1]} "
                  f"/ its tolerance {a['worst'][0]:.3e}; step "
                  f"wall {[round(x, 3) for x in a['step_s']]} s, peak "
                  f"allocated {a['peak_bytes'] / 2**30:.2f} GiB; launches "
                  f"by type K2 {by(a, 'flash_fwd')} K3 {by(a, 'flash_bwd_dq')}"
                  f" K4 {by(a, 'flash_bwd_dkv')} K5 {by(a, 'splash_fwd')} K6 "
                  f"{by(a, 'splash_bwd_dq')} K7 {by(a, 'splash_bwd_dkv')}"
                  f"{extra}; {self.smi}")
            self.path_launches[f"dist_hybrid_{arm}_r{r}"] = a["launches"]
            self.path_dtype_launches[f"dist_hybrid_{arm}_r{r}"] = \
                a["launches_by_dtype"]

        def flash(a, dt, k):
            return all(by(a, key) == {dt: k} for key in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))

        def splash(a, k):
            return all(by(a, key) == {"float32": k} for key in (
                "splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"))
        ecfg = _hybrid_ernie(np, 0.0)[0]
        L, heads = ecfg.num_hidden_layers, ecfg.num_attention_heads // 2
        for r, rec in enumerate(recs):
            for tag in ("p0", "p1", "o1"):
                a, o1 = rec[f"ernie_{tag}"], tag == "o1"
                w = a["worst"]
                line(f"ernie_{tag} (ERNIE-base mp 2, tp_annotate)", r, a,
                     refs[f"ernie_{tag}"], f"; local heads {a['heads']}" + (
                         f"; phase 6's AMP rule against the fp32 update: "
                         f"world 1's bf16 {w[2]:.3e}, this rank's "
                         f"{w[3]:.3e}" if o1 else
                         f"; largest share outside PARAM {w[2]:.3e} "
                         f"({w[3]}), limit {ADAM_SHARE}; the rule's "
                         f"reading of a wrong-rank linear1.bias slice "
                         f"{w[4]:.3e}"))
                check(close(a["losses"], refs[f"ernie_{tag}"],
                            o1 and "ernie"), f"ernie_{tag} r{r} losses")
                check(w[0] <= 1.0, f"ernie_{tag} r{r} update")
                if not o1:
                    check(w[2] <= ADAM_SHARE < w[4],
                          f"ernie_{tag} r{r} share outside PARAM")
                check(a["heads"] == heads, f"ernie_{tag} r{r} heads")
                check(flash(a, "bfloat16" if o1 else "float32",
                            L * (1 if o1 else n)),
                      f"ernie_{tag} r{r} launches")
            a = rec["moe"]
            line("moe (MoE GPT ep 2)", r, a, refs["moe"],
                 f"; {a['experts']} experts, expert bytes "
                 f"{a['expert_bytes'] / 2**20:.1f} MiB = "
                 f"{a['expert_bytes'] / refs['moe_expert_bytes']:.4f} of "
                 f"world 1's")
            check(close(a["losses"], refs["moe"]), f"moe r{r} losses")
            check(a["worst"][0] <= 1.0, f"moe r{r} update")
            check(a["experts"] == MOE["E"] // 2
                  and 2 * a["expert_bytes"] == refs["moe_expert_bytes"],
                  f"moe r{r} experts")
            check(flash(a, "float32", HYBRID["MOE_LAYERS"] * n),
                  f"moe r{r} launches")
            for stage in (2, 3):
                a = rec[f"zero{stage}_clip"]
                share = a["param_bytes"] / a["full_param_bytes"]
                line(f"zero{stage}_clip (packed LM dp 2, "
                     f"ClipGradByGlobalNorm({HYBRID['CLIP']}))", r, a,
                     refs["packed_clip"],
                     f"; between steps parameter bytes held "
                     f"{a['param_bytes'] / 2**20:.1f} MiB = {share:.4f} of "
                     f"the model's, allocated {a['allocated'] / 2**30:.3f} "
                     f"GiB")
                check(close(a["losses"], refs["packed_clip"]),
                      f"zero{stage}_clip r{r} losses")
                check(a["worst"][0] <= 1.0, f"zero{stage}_clip r{r} update")
                check(splash(a, DIST["LAYERS"] * n),
                      f"zero{stage}_clip r{r} launches")
                if stage == 3:
                    # the same step at ZeRO-2 holds the whole parameters
                    freed = rec["zero2_clip"]["allocated"] - a["allocated"]
                    print(f"dist (b) zero3 rank {r}: allocated between "
                          f"steps {freed / 2**20:.1f} MiB below ZeRO-2's "
                          f"(half the parameters: "
                          f"{a['full_param_bytes'] / 2**21:.1f} MiB)")
                    check(abs(share - 0.5) < 0.01,
                          f"zero3 r{r} parameter bytes")
                    check(freed >= 0.9 * a["full_param_bytes"] / 2,
                          f"zero3 r{r} allocated vs ZeRO-2")
            a, b = rec["lamb1"], rec["lamb0"]
            line("lamb1 (Lamb ZeRO-1 vs ZeRO-0, dp 2)", r, a, b["losses"],
                 f"; allocated between steps ZeRO-1 "
                 f"{a['allocated'] / 2**30:.3f} GiB, ZeRO-0 "
                 f"{b['allocated'] / 2**30:.3f} GiB (with ZeRO-0's update "
                 f"kept)")
            self.path_launches[f"dist_hybrid_lamb0_r{r}"] = b["launches"]
            self.path_dtype_launches[f"dist_hybrid_lamb0_r{r}"] = \
                b["launches_by_dtype"]
            check(close(a["losses"], b["losses"]), f"lamb1 r{r} losses")
            check(a["worst"][0] <= 1.0, f"lamb1 r{r} update")
            check(splash(a, DIST["LAYERS"] * n) and splash(
                b, DIST["LAYERS"] * n), f"lamb r{r} launches")
            a, b = rec["dgc2"], rec["dgc0"]
            line("dgc2 (DGC ZeRO-2 vs ZeRO-0, dp 2)", r, a, b["losses"],
                 f"; kept a step {a['kept']} vs ZeRO-0 {b['kept']}")
            self.path_launches[f"dist_hybrid_dgc0_r{r}"] = b["launches"]
            self.path_dtype_launches[f"dist_hybrid_dgc0_r{r}"] = \
                b["launches_by_dtype"]
            check(a["kept"] == b["kept"], f"dgc2 r{r} kept")
            check(close(a["losses"], b["losses"]), f"dgc2 r{r} losses")
            check(a["worst"][0] <= 1.0, f"dgc2 r{r} update")
            check(splash(a, DIST["LAYERS"] * n) and splash(
                b, DIST["LAYERS"] * n), f"dgc r{r} launches")
            k = _strat_config().num_layers // 2 * STRAT["N_MICRO"] * n
            for tag in ("fp32", "o1"):
                a, o1 = rec[f"pp_{tag}"], tag == "o1"
                line(f"pp_{tag} (GPipe pp 2, stage {a['stage']}, "
                     f"ClipGradByGlobalNorm({HYBRID['CLIP']}))", r, a,
                     refs[f"pp_{tag}"], f"; {a['held']} parameters held")
                check(close(a["losses"], refs[f"pp_{tag}"], o1),
                      f"pp_{tag} r{r} losses")
                check(a["worst"][0] <= 1.0, f"pp_{tag} r{r} update")
                check(flash(a, "bfloat16" if o1 else "float32", k),
                      f"pp_{tag} r{r} launches")
        assert not fails, fails

    def dist_lanes_a(self, wd):
        """(g1)'s tp 1 side, in this process: phase 5d's traffic (four
        592-token system prompts served one at a time, then again with
        new tails; LANES["TIER_NEW"] tokens each) through a GPT-2-small
        engine at phase 5d's tier settings (`_lanes_tier_kw`), fp32 and
        int8 pools; the traffic and page
        counts go to lanes.json for the ranks. Returns the traffic and
        each pool type's outputs, audit counts, steps, slab and
        launches."""
        torch = self.torch
        from paddle_tpu_torch.serving import GenerationEngine
        prompts, _ = self.tier_traffic(self.gpt.gpt.config.vocab_size)
        new = [LANES["TIER_NEW"]] * len(prompts)
        P = FEAT["page"]
        need = max(-(-(len(p) + n) // P) for p, n in zip(prompts, new))
        req = dict(prompts=[p.tolist() for p in prompts], new=new,
                   tier_pages=1 + LANES["DEVICE_PAGES"] + need + 2,
                   ref_pages=1 + sum(-(-(len(p) + n) // P)
                                     for p, n in zip(prompts, new)))
        with open(os.path.join(wd, "lanes.json"), "w") as f:
            json.dump(req, f)
        out = dict(prompts=prompts, new=new)
        for dtype in ("float32", "int8"):
            eng = GenerationEngine(
                self.gpt, device="cuda", name=f"g1_tp1_{dtype}", tp=1,
                **_lanes_tier_kw(dtype, req["tier_pages"]))
            self.zero_launches()
            row = _lanes_serve_one_by_one(eng, prompts, new)
            row["launches"] = self.record_path(f"dist_lanes_tier_tp1_"
                                               f"{dtype}")
            row["slab"] = dict(slots=eng._slab.slots,
                               slot_bytes=eng._slab.slot_bytes,
                               reserved=eng._slab.reserved_bytes)
            row["host_bytes"] = eng._tier.host_bytes
            eng.shutdown(drain=True, timeout_s=60)
            del eng
            torch.cuda.empty_cache()
            print(f"dist (g1) tp 1 tier {dtype} on {self.smi}: 8 requests "
                  f"one at a time in {row['wall_s']:.3f} s, {row['steps']} "
                  f"steps, audit {row['counts']}, slab {row['slab']}, "
                  f"leak-free {row['leak_free']}")
            out[dtype] = row
        return out

    def dist_lanes_g(self, wd, refs, lanes_a):
        """(g) four ranks on this card over gloo (`_lanes_rank`), a
        correctness arm: no time it prints is a multi-card number.
        (g1) the host tier at tp 2, fp32 pools on ranks 0-1 and int8 on
        a tp_mesh(2, devices=[2, 3]) lane at once, each beside a lane that
        never evicts on the same ranks: token-identical to it; against tp 1 (`dist_lanes_a`)
        first tokens exact and each first flip at a top-2 gap under
        NEAR_TIE (C2); KV_PROMOTE (4, a chain a revisit), KV_DEMOTE and
        KV_TIER_EVICT as tp 1's, the host bytes (whole pages) as tp 1's;
        a rank's slab half of tp 1's; K1 = both lanes' steps x 12 a rank
        (fp32; int8 0), K2 = 12 x their cold prefills a rank; no page or
        slot leaked, no staged chunk left.
        (g2) a supervised tp 2 lane under phase 5e (a)'s decode and
        prefill failpoints: phase 5's 16 streamed requests
        token-identical to (b)'s unsupervised tp 2 lane, each stream
        exactly once, one ENGINE_RESTART, REPLAY_ADMIT = the manifest's
        entries, incarnation 1 on both ranks, the rebuilt engines on the
        lane and groups of incarnation 0 and no group made (the ranks
        count torch's registered groups around the rebuild), K1 = 12 x
        (both incarnations' steps + the rebuild's warmup step) a rank.
        (g3) a dp 2 x tp 2 mesh, a tp_mesh(2, devices=[2, 3]) lane and
        the router over two tp 2 replicas on ranks 0-1: every leader's
        outputs equal to (b)'s tp 2 lane's on the same requests; a
        follower's fault inside a program ends its lane on both ranks
        within FAULT_TIMEOUT_S with a LaneFault naming rank 1."""
        import numpy as np
        from paddle_tpu_torch import distributed as D
        L = self.gpt.gpt.config.num_layers
        print("dist (g): four ranks share this one card over gloo; a "
              "correctness arm, no time below is a multi-card number")
        t0 = time.perf_counter()
        D.spawn(_lanes_rank, args=(wd,), nprocs=4,
                timeout=LANES["TIMEOUT"])
        spawn_s = time.perf_counter() - t0
        recs = []
        for r in range(4):
            with open(os.path.join(wd, f"lanes{r}.json")) as f:
                recs.append(json.load(f))
        print(f"dist (g) on {self.smi}: 4 ranks spawned and joined in "
              f"{spawn_s:.1f} s; (g1) {recs[0]['tier_s']:.1f} s, (g2) "
              f"{recs[0]['sup_s']:.1f} s, (g3) {recs[0]['four_s']:.1f} s "
              f"(rank 0)")
        # (g1): fp32 on ranks 0-1, int8 on ranks 2-3
        prompts, new = lanes_a["prompts"], lanes_a["new"]
        for pair in ((0, 1), (2, 3)):
            lead, follow = (recs[r]["tier"] for r in pair)
            dtype = lead["dtype"]
            one, ref, t = lanes_a[dtype], lead["ref"], lead["tier"]
            assert "error" not in ref and "error" not in t, (ref, t)
            outs = [np.asarray(o) for o in t["outs"]]
            flips = self.first_flips(prompts, new, outs,
                                     [np.asarray(o) for o in one["outs"]])
            first = [(o[len(p)], rf[len(p)]) for o, rf, p in
                     zip(t["outs"], one["outs"], prompts)]
            slab = [x["tier"]["slab"] for x in (lead, follow)]
            launches = [x["launches"] for x in (lead, follow)]
            print(f"dist (g1) tp 2 tier {dtype} on ranks {list(pair)} on "
                  f"{self.smi}: 8 requests one at a time in "
                  f"{t['wall_s']:.3f} s, beside the never-evicting lane on "
                  f"the same ranks ({ref['wall_s']:.3f} s; lanes "
                  f"{lead['lanes']}), {t['steps']} steps; identical to it "
                  f"{t['outs'] == ref['outs']}; {len(flips)} outputs "
                  f"differ from tp 1 (gaps "
                  f"{[round(g, 6) for _i, _s, g in flips]}); audit "
                  f"{t['counts']} (tp 1 {one['counts']}); host bytes "
                  f"{t['host_bytes']} (tp 1 {one['host_bytes']}); slab a "
                  f"rank {[x['slots'] * x['slot_bytes'] for x in slab]} "
                  f"(reserved {[x['reserved'] for x in slab]}), tp 1 "
                  f"{one['slab']['slots'] * one['slab']['slot_bytes']} "
                  f"(reserved {one['slab']['reserved']}); K1 "
                  f"{[x['paged_attention'] for x in launches]} K2 "
                  f"{[x['flash_fwd'] for x in launches]} a rank, both "
                  f"lanes; leak-free {t['leak_free']} / {ref['leak_free']}")
            assert t["outs"] == ref["outs"], \
                f"(g1) {dtype}: the tier lane differs from the never-" \
                f"evicting lane"
            assert all(a == b for a, b in first), f"(g1) {dtype}: first"
            assert all(g < NEAR_TIE for _i, _s, g in flips), flips
            for c in ("KV_PROMOTE", "KV_DEMOTE", "KV_TIER_EVICT",
                      "ADMIT", "ADMIT_PREFIX_HIT"):
                assert t["counts"][c] == one["counts"][c], (c, t, one)
            assert t["counts"]["KV_PROMOTE"] == 4, t["counts"]
            assert t["host_bytes"] == one["host_bytes"]
            for x in slab:
                assert x["slots"] == one["slab"]["slots"] and \
                    2 * x["slot_bytes"] == one["slab"]["slot_bytes"], x
            assert t["leak_free"], f"(g1) {dtype}: a page or slot leaked"
            steps = t["steps"] + ref["steps"]
            cold = t["counts"]["ADMIT"] + ref["counts"]["ADMIT"]
            for r, x in zip(pair, (lead, follow)):
                k1 = x["launches"]["paged_attention"]
                assert k1 == (steps * L if dtype == "float32" else 0), \
                    (r, k1, steps)
                assert x["launches"]["flash_fwd"] == L * cold, (r, x)
                assert x["ref"]["staged_left"] == 0 == \
                    x["tier"]["staged_left"], (r, x)
                self.path_launches[f"dist_lanes_tier_{dtype}_r{r}"] = \
                    x["launches"]
        # (g2)
        rprompts = [np.asarray(p) for p in refs["prompts"]]
        # (b)'s tp 2 outputs cut to the same new tokens (greedy decode
        # of a row is independent of the rest of the batch)
        rnew = [min(m, LANES["NEW"]) for m in refs["new"]]
        tp2 = [o[:len(p) + m] for o, p, m in
               zip(refs["tp2_fp32"], rprompts, rnew)]
        for arm, fp in LANES["FAULTS"]:
            r0, r1 = (rec["sup"][arm] for rec in recs[:2])
            bad = [o for o in r0["outs"] if not isinstance(o, list)]
            assert not bad, f"(g2) {arm}: requests failed: {bad}"
            outs = [np.asarray(o) for o in r0["outs"]]
            print(f"dist (g2) supervised tp 2 lane under {fp} on "
                  f"{self.smi}: 16 streamed requests in "
                  f"{r0['wall_s']:.3f} s, {r0['steps']} steps over both "
                  f"incarnations, restarts {r0['restarts']} / "
                  f"{r1['restarts']}, incarnation {r0['incarnation']} / "
                  f"{r1['incarnation']}, ENGINE_RESTART "
                  f"{r0['restarts_audit']}, REPLAY_ADMIT "
                  f"{r0['replay_admit']} of {r0['entries']} entries; the "
                  f"same lane {r0['same_lane']} / {r1['same_lane']}, groups "
                  f"made by the lane {r0['lane_groups']}, by the rebuild "
                  f"{r0['rebuild_groups']} / {r1['rebuild_groups']}; K1 "
                  f"{r0['launches']['paged_attention']} / "
                  f"{r1['launches']['paged_attention']}")
            self.assert_identical(f"(g2) {arm}", rprompts, rnew, outs,
                                  refs=tp2)
            once = [i for i, (p, o) in enumerate(zip(rprompts, outs))
                    if r0["collected"][i] != o[len(p):].tolist()]
            assert not once, f"(g2) {arm}: streams {once} not exactly once"
            assert r0["restarts_audit"] == 1 == r0["restarts"] \
                == r1["restarts"], (r0, r1)
            assert r0["replay_admit"] == r0["entries"] >= 1, r0
            assert r0["incarnation"] == r1["incarnation"] == 1
            assert r0["pages_in_use"] == 0
            for r, x in enumerate((r0, r1)):
                assert x["same_lane"] and x["rebuild_groups"] == 0, (r, x)
                assert x["launches"]["paged_attention"] == \
                    (r0["steps"] + 1) * L, (r, x["launches"], r0["steps"])
                self.path_launches[f"dist_lanes_sup_{arm}_r{r}"] = \
                    x["launches"]
        # (g3)
        n = LANES["G3_REQUESTS"]
        want = [o.tolist() for o in tp2[:n]]
        four = [rec["four"] for rec in recs]
        faults = [(f["fault"]["error"], f["fault"]["rank"],
                   round(f["fault"]["ended_s"], 3)) for f in four[:2]]
        arms = [round(four[0][k]["arm_s"], 2)
                for k in ("mesh", "sub", "router")]
        print(f"dist (g3) on {self.smi}: mesh dp 2 x tp 2 lanes "
              f"{[f['mesh']['lane'] for f in four]}, leaders' walls "
              f"{four[0]['mesh']['wall_s']:.3f} / "
              f"{four[2]['mesh']['wall_s']:.3f} s for {n} requests each; "
              f"tp_mesh(2, devices=[2, 3]) lane {four[2]['sub']['lane']} "
              f"{four[2]['sub']['wall_s']:.3f} s, ranks 0-1 refused: "
              f"{four[0]['sub']['refused']!r}; router over two tp 2 "
              f"replicas on ranks 0-1 {four[0]['router']['wall_s']:.3f} s, "
              f"placements {four[0]['router']['placements']}; the fault "
              f"arm {faults} (bound {LANES['FAULT_TIMEOUT_S']} s); arms "
              f"{arms} s")
        assert [f["mesh"]["lane"] for f in four] == [[0, 1], [0, 1],
                                                     [2, 3], [2, 3]]
        assert four[0]["mesh"]["outs"] == four[2]["mesh"]["outs"] == want
        assert four[2]["sub"]["lane"] == four[3]["sub"]["lane"] == [2, 3]
        assert four[2]["sub"]["outs"] == want
        for f in four[:2]:
            assert "is in no lane of" in f["sub"]["refused"], f["sub"]
        assert four[0]["router"]["outs"] == want
        assert sum(four[0]["router"]["placements"].values()) == n
        for r, f in enumerate(four[:2]):
            fl = f["fault"]
            assert fl["error"] == "LaneFault" and fl["rank"] == 1, (r, fl)
            assert fl["ended_s"] < LANES["FAULT_TIMEOUT_S"] + 10, (r, fl)
        self.details["dist_lanes"] = dict(
            spawn_s=spawn_s, ranks=recs,
            tp1={k: lanes_a[k] for k in ("float32", "int8")})

    def dist_elastic_b(self, wd):
        """(b) `launch --elastic` of two ranks on this card: rank 1 hangs
        before it ever beats (`_elastic_hang_rank`), rank 0 joins over
        gloo and waits for it; the launcher must name rank 1 ("stopped
        heartbeating"), terminate the job and exit non-zero."""
        import socket
        e = STRAT["ELASTIC"]
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        for key in list(env):
            if key.startswith("PADDLE_"):
                env.pop(key)
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", "2", "--started_port", str(port),
               "--log_dir", os.path.join(wd, "elastic_log"), "--elastic",
               "--elastic_timeout", str(e["TIMEOUT"]), "--elastic_grace",
               str(e["GRACE"]), str(REPO / "chip_smoke.py"),
               "--elastic-hang"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=str(REPO), capture_output=True,
                           text=True, timeout=e["LIMIT"])
        wall = time.perf_counter() - t0
        said = [ln for ln in r.stderr.splitlines() if "heartbeat" in ln]
        print(f"dist (b) launch --elastic, 2 ranks on the card, rank 1 hung "
              f"before its first beat: launcher exit {r.returncode} after "
              f"{wall:.1f} s (grace {e['GRACE']} s); {said}; {self.smi}")
        self.details["dist_elastic"] = dict(rc=r.returncode, wall_s=wall,
                                            said=said)
        assert r.returncode != 0 and any(
            "rank(s) [1] stopped heartbeating" in ln for ln in said), \
            r.stderr[-2000:]

    # -- 16. the parameter server ----------------------------------------------

    def ps(self):
        """Phase 16 (see the module docstring): PaddleRec's CTR-DNN over the
        port's parameter server, its dense step on the card; server and
        trainer processes spawned and killed with the phase."""
        wd = tempfile.mkdtemp(prefix="chip_smoke_ps_")
        kids = _Children()
        try:
            self.zero_launches()
            # every server process of the phase starts now, together:
            # (a) sync sgd, (b) fleet's PS role, (c) async and geo
            cfg_sgd = [dict(table_id=0, kind="sparse", dim=PS["DIM"],
                            rule="sgd", lr=PS["SYNC_LR"])]
            cfg_adam = [dict(table_id=0, kind="sparse", dim=PS["DIM"],
                             rule="adam", lr=PS["LR"])]
            cfg_geo = cfg_adam + [dict(table_id=1, kind="dense",
                                       size=_ctr_dense_size(),
                                       rule="sum")]
            fleet_env = {"TRAINING_ROLE": "PSERVER",
                         "PADDLE_PSERVERS_IP_PORT_LIST":
                         "127.0.0.1:0,127.0.0.1:0",
                         "PADDLE_TRAINERS_NUM": "1"}
            for arm, cfg, n, env in (("a", cfg_sgd, 1, None),
                                     ("b", cfg_adam, 1, fleet_env),
                                     ("c_async", cfg_adam, 2, None),
                                     ("c_geo", cfg_geo, 2, None)):
                for i in range(2):
                    kids.server(arm, i, cfg, n,
                                None if env is None else
                                dict(env, PADDLE_PSERVER_ID=str(i)))
            eps = kids.endpoints(("a", "b", "c_async", "c_geo"))
            kids.trainers(wd, eps["c_async"], eps["c_geo"])
            self.ps_sync_a(eps["a"])
            self.ps_fleet_b(wd, eps["b"], kids)
            self.ps_trainers_c(wd, eps["c_async"], eps["c_geo"], kids)
            self.ps_transpiler_d()
            self.ps_bench_e()
            self.ps_selected_rows_f()
            got = self.record_path("ps")
            print(f"ps: K1-K7 launches on the path {got} (the CTR-DNN runs "
                  f"no attention)")
            assert not any(got.values()), got
        finally:
            kids.stop()
            shutil.rmtree(wd, ignore_errors=True)

    def ps_model(self, seed):
        """The port's CTR-DNN on the card from `seed`."""
        from paddle_tpu_torch.framework import random as prandom
        prandom.seed(seed)
        return _ctr_dnn()().to(PS_DEV)

    def ps_sync_a(self, eps):
        """(a) Two PsServer processes and this trainer: DownpourWorker with
        synchronous push, SGD 0.05 on the table and on the head, 20 steps
        of 512, against nn.Embedding over the table's initial rows + the
        same head and batches on the card."""
        import copy
        import numpy as np
        torch = self.torch
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.distributed.fleet import (DownpourWorker,
                                                        FleetWrapper)
        P = PS
        batches = _ctr_batches(np, 100, P["SYNC_STEPS"], P["B"])
        fw = FleetWrapper()
        fw.init_worker(eps, sparse_dims={0: P["DIM"]})
        try:
            model = self.ps_model(0)
            base = copy.deepcopy(model)
            uniq = np.unique(np.concatenate([b[0].reshape(-1)
                                             for b in batches]))
            init = fw.pull_sparse_vars_sync(0, uniq)
            worker = DownpourWorker(
                fw, 0, P["DIM"], model,
                popt.SGD(P["SYNC_LR"], parameters=model.parameters()),
                _ctr_loss, async_push=False, device=PS_DEV)
            t0 = time.perf_counter()
            got = [worker.train_one_batch(*b) for b in batches]
            wall = time.perf_counter() - t0
            emb = torch.nn.Embedding(uniq.size, P["DIM"]).to(PS_DEV)
            with torch.no_grad():
                emb.weight.copy_(torch.from_numpy(init))
            bopt = popt.SGD(P["SYNC_LR"], parameters=[emb.weight]
                            + list(base.parameters()))
            want = []
            for ids, dense, label in batches:
                idx = torch.from_numpy(np.searchsorted(uniq, ids)).to(PS_DEV)
                d = [torch.from_numpy(dense).to(PS_DEV),
                     torch.from_numpy(label).to(PS_DEV)]
                out = base(emb(idx).reshape(-1, P["DIM"]), *d)
                lv = _ctr_loss(out, d).float().mean()
                bopt.clear_grad()
                lv.backward()
                bopt.step()
                want.append(float(lv.detach()))
            rows = fw.pull_sparse_vars_sync(0, uniq)
        finally:
            fw.stop_server()
        ref = emb.weight.detach().cpu().numpy()
        row_err = float(np.abs(rows - ref).max() / np.abs(ref).max())
        loss_err = float(np.max(np.abs(np.array(got) - np.array(want))
                                / np.maximum(np.abs(want), 1e-30)))
        t = list(worker.timings)
        print(f"ps (a) sync push, 2 servers, SGD {P['SYNC_LR']}, "
              f"{len(batches)} steps of {P['B']}: losses {got[0]:.6f} -> "
              f"{got[-1]:.6f}, dense baseline {want[0]:.6f} -> "
              f"{want[-1]:.6f}, worst relative {loss_err:.3e}; touched "
              f"rows {uniq.size}, worst |row - baseline| / max|row| "
              f"{row_err:.3e}; {wall / len(batches) * 1e3:.2f} ms a step "
              f"(device {np.mean([r['device'] for r in t[3:]]):.2f} ms)")
        self.details["ps_a"] = dict(losses=got, baseline=want,
                                    loss_rel=loss_err, row_rel=row_err,
                                    rows=int(uniq.size),
                                    step_ms=wall / len(batches) * 1e3)
        assert worker._step.device.type == PS_DEV
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        assert row_err <= 1e-5, row_err

    def ps_fleet_b(self, wd, eps, kids):
        """(b) PaddleRec's configuration: fleet.init with a PS role in the
        two server processes (init_server / run_server), fleet.init +
        init_worker here, DownpourWorker.train_from_dataset over an
        InMemoryDataset of seeded slot files written through
        MultiSlotDataGenerator, Adam 1e-3 both sides, async push."""
        import numpy as np
        torch = self.torch
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.fleet import (DownpourWorker,
                                                        FleetWrapper)
        from paddle_tpu_torch.distributed.ps import runtime as prt
        P = PS
        t0 = time.perf_counter()
        files = _ctr_slot_files(np, wd, P["BATCHES"], P["B"])
        t_gen = time.perf_counter() - t0
        ds = fleet.InMemoryDataset()
        ds.init(batch_size=P["B"], use_var=_ctr_slots())
        ds.set_filelist(files)
        t0 = time.perf_counter()
        ds.load_into_memory()
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        feed = [_ctr_from_slots(np, b) for b in ds]
        t_iter = time.perf_counter() - t0
        assert len(feed) == P["BATCHES"] and \
            ds.get_memory_data_size() == P["BATCHES"] * P["B"]
        env = {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "0",
               "PADDLE_TRAINERS_NUM": "1",
               "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(eps)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        prt._runtime = None
        fw = FleetWrapper()
        try:
            fleet.init(is_collective=False)
            assert not fleet.is_server()
            fleet.init_worker()
            fw.init_worker(eps, sparse_dims={0: P["DIM"]})
            model = self.ps_model(1)
            opt = popt.Adam(P["LR"], parameters=model.parameters())
            worker = DownpourWorker(fw, 0, P["DIM"], model, opt, _ctr_loss,
                                    async_push=True, device=PS_DEV)
            t0 = time.perf_counter()
            losses = worker.train_from_dataset(feed)
            wall = time.perf_counter() - t0
            steps = list(worker.timings)
            auc = self.ps_auc(model, fw, _ctr_batches(np, 900, 4, P["B"]))
            # the wire alone: the last batch's rows again (all exist now)
            uniq = np.unique(feed[-1][0])
            net = []
            for _ in range(5):
                tn = time.perf_counter()
                fw.pull_sparse_vars_sync(0, uniq)
                net.append((time.perf_counter() - tn) * 1e3)
            # the device's busy share over 3 more (profiled) steps
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                for b in feed[:3]:
                    worker.train_one_batch(*b)
                torch.cuda.synchronize()
                wall_p = (time.perf_counter() - tp) * 1e3
            dev_ms, _ = _device_table(torch, prof, 3, wall_p)
            fw.client_flush()
            fleet.stop_worker()
        finally:
            fw.stop_server()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            prt._runtime = None
        left = kids.wait_arm("b", 30)
        split = {k: float(np.mean([r[k] for r in steps[3:]]))
                 for k in ("pull", "h2d", "device", "d2h", "push", "wall")}
        rate = P["B"] * (len(steps) - 3) / (sum(r["wall"]
                                               for r in steps[3:]) / 1e3)
        busy = dev_ms / (wall_p / 3)
        print(f"ps (b) fleet PS role, 2 server processes, InMemoryDataset "
              f"{P['BATCHES']} x {P['B']} (write {t_gen:.2f} s, "
              f"load_into_memory {t_load:.2f} s, batching {t_iter:.2f} s), "
              f"Adam {P['LR']}, async push: loss {np.mean(losses[:3]):.4f} "
              f"(first 3) -> {np.mean(losses[-3:]):.4f} (last 3); AUC "
              f"{auc:.4f}; {rate:.1f} samples/s over steps 3-"
              f"{len(steps) - 1} ({wall:.2f} s in all); ms a step: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; device busy {busy * 100:.1f}% of 3 profiled steps "
              f"({dev_ms:.3f} of {wall_p / 3:.3f} ms); a pull of "
              f"{uniq.size} existing rows over the wire {np.median(net):.3f}"
              f" ms (median of 5); server processes left {left}; "
              f"{self.smi}")
        self.details["ps_b"] = dict(losses=losses, auc=auc,
                                    samples_per_s=rate, split_ms=split,
                                    busy_share=busy, gen_s=t_gen,
                                    load_s=t_load, iter_s=t_iter,
                                    wall_s=wall, wire_pull_ms=net)
        assert all(np.isfinite(losses)), losses
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
        if PS_DEV == "cuda":   # staged to the card through one copy
            assert min(r["h2d"] for r in steps) > 0
        assert left == 0, left

    def ps_auc(self, model, fw, batches):
        """AUC of the trained CTR-DNN on held-out batches (the rows pulled
        from the servers, the head's forward on the card)."""
        import numpy as np
        torch = self.torch
        scores, labels = [], []
        with torch.no_grad():
            for ids, dense, label in batches:
                rows = fw.pull_sparse_vars_sync(0, ids.reshape(-1))
                out = model(torch.from_numpy(rows).to(PS_DEV),
                            torch.from_numpy(dense).to(PS_DEV), None)
                scores.append(torch.softmax(out.float(), -1)[:, 1]
                              .cpu().numpy())
                labels.append(label)
        return _auc(np, np.concatenate(scores), np.concatenate(labels))

    def ps_trainers_c(self, wd, eps_async, eps_geo, kids):
        """(c) Two trainer processes on the one card (started with the
        servers) against two servers each, async then geo with k 4:
        losses finite and falling, each server table's size = the
        distinct ids pulled, save -> load into fresh tables bit-exact."""
        import numpy as np
        from paddle_tpu_torch.distributed.ps import PsClient, SparseTable
        P = PS
        open(os.path.join(wd, "go"), "w").close()
        kids.wait_trainers(P["TIMEOUT"])
        recs = [json.load(open(os.path.join(wd, f"trainer{r}.json")))
                for r in range(2)]
        out = {}
        for mode, eps in (("async", eps_async), ("geo", eps_geo)):
            ids = np.unique(np.concatenate([np.load(os.path.join(
                wd, f"trainer{r}_{mode}_ids.npy")) for r in range(2)]))
            client = PsClient(eps)
            try:
                ckpt = os.path.join(wd, f"ckpt_{mode}")
                client.save(ckpt)
                exact = True
                for i in range(2):
                    mine = ids[np.abs(ids) % 2 == i]
                    fresh = SparseTable(P["DIM"], rule="adam", lr=P["LR"])
                    n = fresh.load(f"{ckpt}.server{i}.table0")
                    exact &= n == mine.size and np.array_equal(
                        fresh.pull(mine), client.pull_sparse(0, mine,
                                                             P["DIM"]))
                client.stop_server()
            finally:
                client.close()
            sizes = kids.wait_arm("c_" + mode, 30, sizes=True)
            out[mode] = dict(ids=int(ids.size), table=sizes, exact=exact)
        for r, rec in enumerate(recs):
            for mode in ("async", "geo"):
                ls = rec[mode]["losses"]
                print(f"ps (c) trainer {r} {mode}: {len(ls)} steps, loss "
                      f"{np.mean(ls[:3]):.4f} -> {np.mean(ls[-3:]):.4f}, "
                      f"{rec[mode]['step_ms']:.2f} ms a step")
        for mode, o in out.items():
            print(f"ps (c) {mode}: distinct ids pulled {o['ids']}, rows in "
                  f"the two servers' tables {o['table']} (sum "
                  f"{sum(o['table'])}), save -> load bit-exact {o['exact']}")
        self.details["ps_c"] = dict(trainers=recs, tables=out)
        for rec in recs:
            for mode in ("async", "geo"):
                ls = rec[mode]["losses"]
                assert all(np.isfinite(ls)), (mode, ls)
                assert np.mean(ls[-3:]) < np.mean(ls[:3]), (mode, ls)
            assert rec["device"] == PS_DEV, rec["device"]
        for mode, o in out.items():
            assert sum(o["table"]) == o["ids"], (mode, o)
            assert o["exact"], mode

    def ps_transpiler_d(self):
        """(d) The CTR-DNN's dense tower (13 dense features -> 512-256-
        128-32 -> 2, cross-entropy) as a static Program, SGD 0.05,
        transpiled over two in-process pservers for one trainer on the
        card, 4 steps, against the local Executor.run on the card."""
        import numpy as np
        torch = self.torch
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import static
        from paddle_tpu_torch.distributed import DistributeTranspiler
        from paddle_tpu_torch.distributed.ps import PsServer
        P = PS
        _, dense, label = _ctr_batches(np, 300, 1, P["B"])[0]
        feed = {"dense": dense, "label": label.reshape(-1, 1)}
        paddle.enable_static()
        servers = []
        try:
            scope = {}
            with static.scope_guard(scope):
                paddle.seed(3)
                main, startup = static.Program(), static.Program()
                with static.program_guard(main, startup):
                    x = static.data("dense", [P["B"], P["DENSE"]],
                                    "float32")
                    y = static.data("label", [P["B"], 1], "int64")
                    h = x
                    for w in P["HIDDEN"]:
                        h = static.nn.fc(h, w, activation="relu")
                    logits = static.nn.fc(h, 2)
                    loss = paddle.mean(paddle.nn.functional.cross_entropy(
                        logits, y))
                    paddle.optimizer.SGD(P["SYNC_LR"]).minimize(loss)
            init = {k: v.clone() for k, v in scope.items()}
            local_scope = {k: v.clone() for k, v in init.items()}
            with static.scope_guard(local_scope):
                exe = static.Executor(paddle.CUDAPlace(0) if PS_DEV == "cuda"
                                      else paddle.CPUPlace())
                local = [float(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0])
                         for _ in range(4)]
            with static.scope_guard(init):
                servers = [PsServer("127.0.0.1:0", []).start()
                           for _ in range(2)]
                eps = [s.endpoint for s in servers]
                t = DistributeTranspiler().transpile(
                    0, program=main, pservers=",".join(eps), trainers=1)
                for s, ep in zip(servers, eps):
                    s.add_tables(t.get_pserver_program(ep))
                trainer = t.get_trainer_program(device=PS_DEV)
                for i, ep in enumerate(eps):
                    for tid, v in t.get_startup_program(ep).items():
                        trainer.client.set_dense(tid, v, server=i)
                t0 = time.perf_counter()
                dist = [float(trainer.run(feed)) for _ in range(4)]
                wall = (time.perf_counter() - t0) / 4
                trainer.close()
        finally:
            paddle.disable_static()
            for s in servers:
                s.stop()
        print(f"ps (d) transpiler, CTR-DNN dense tower, 2 pservers, 1 "
              f"trainer on the card: losses {[f'{v:.6f}' for v in dist]}, "
              f"local Executor.run {[f'{v:.6f}' for v in local]}; "
              f"{wall * 1e3:.2f} ms a transpiled step; tables "
              f"{len(t._placement)} over {len(eps)} servers")
        self.details["ps_d"] = dict(losses=dist, local=local,
                                    step_ms=wall * 1e3)
        assert trainer.device.type == PS_DEV
        np.testing.assert_allclose(dist, local, rtol=2e-4, atol=2e-5)

    def ps_bench_e(self):
        """(e) bench.py's bench_host_embedding configuration on the card:
        dim 64, 8192 ids a batch, vocabulary 100,000, Adam 1e-3 on the
        table, AdamW 1e-3 on a Linear(64, 1) head, MSE; 3 warm steps, 15
        timed. Recorded, not gated."""
        import numpy as np
        torch = self.torch
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.distributed.ps import (HostEmbedding,
                                                     make_host_embedding_step)
        E = PS["BENCH"]
        from paddle_tpu_torch.framework import random as prandom
        prandom.seed(0)
        head = _bench_head(E["DIM"])
        host = HostEmbedding(E["DIM"], rule="adam", lr=1e-3)
        step = make_host_embedding_step(
            head, popt.AdamW(1e-3, parameters=head.parameters()),
            lambda out, data: ((out.squeeze(-1) - data[0]) ** 2).mean(),
            host, device=PS_DEV)
        rng = np.random.RandomState(0)

        def batch():
            return (rng.randint(0, E["VOCAB"], size=(E["IDS"],))
                    .astype("int64"),
                    rng.standard_normal((E["IDS"],)).astype("float32"))
        for _ in range(E["WARM"]):
            step(*batch())
        bs = [batch() for _ in range(E["ITERS"])]
        t0 = time.perf_counter()
        for b in bs:
            step(*b)
        dt = time.perf_counter() - t0
        rate = E["IDS"] * E["ITERS"] / dt
        rows = len(host)
        # the table alone: rows made on a miss against rows that exist
        fresh = np.arange(E["VOCAB"], E["VOCAB"] + E["IDS"])
        tt = time.perf_counter()
        host.table.pull(fresh)
        t_miss = (time.perf_counter() - tt) * 1e3
        tt = time.perf_counter()
        host.table.pull(fresh)
        t_hit = (time.perf_counter() - tt) * 1e3
        t = list(step.timings)[E["WARM"]:]
        split = {k: float(np.mean([r[k] for r in t]))
                 for k in ("pull", "h2d", "device", "d2h", "push", "wall")}
        print(f"ps (e) bench_host_embedding on the card (dim {E['DIM']}, "
              f"{E['IDS']} ids a batch, vocabulary {E['VOCAB']}): "
              f"host_embedding_train_ids_per_sec_dim64 {rate:.1f}; ms a "
              f"step: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    split.items())
              + f"; table rows {rows}; a table pull of {E['IDS']} "
              f"new ids {t_miss:.3f} ms, the same ids again {t_hit:.3f} "
              f"ms; {self.smi}")
        self.details["ps_e"] = dict(
            host_embedding_train_ids_per_sec_dim64=rate, split_ms=split,
            pull_miss_ms=t_miss, pull_hit_ms=t_hit)

    def ps_selected_rows_f(self):
        """(f) apply_selected_rows on a CUDA parameter of 1,000,001 x 9 for
        SGD, Momentum, Adam and Adagrad (two sparse updates from CTR
        batches' ids): the touched rows within 1e-6 x max(1, |ref|) of the
        same updates on the CPU, the untouched rows and accumulator rows
        bit-unchanged."""
        import numpy as np
        torch = self.torch
        from paddle_tpu_torch import optimizer as popt
        from paddle_tpu_torch.framework.selected_rows import SelectedRows
        P = PS
        g = torch.Generator().manual_seed(5)
        w0 = torch.randn(P["VOCAB"], P["DIM"], generator=g)
        rs = np.random.RandomState(6)
        ups = []
        for ids, _, _ in _ctr_batches(np, 500, 2, P["B"]):
            ids = ids.reshape(-1)
            ups.append((ids, rs.standard_normal(
                (ids.size, P["DIM"])).astype(np.float32)))
        touched = np.zeros(P["VOCAB"], bool)
        for ids, _ in ups:
            touched[ids] = True
        mask = torch.from_numpy(touched)
        res = {}
        for name in ("SGD", "Momentum", "Adam", "Adagrad"):
            out = {}
            for dev in (PS_DEV, "cpu"):
                p = torch.nn.Parameter(w0.to(dev).clone())
                opt = getattr(popt, name)(0.1, parameters=[p])
                init = {k: v.clone() for k, v in opt._init_state(p).items()}
                ms = []
                for ids, vals in ups:
                    sr = SelectedRows(torch.from_numpy(ids).to(dev),
                                      torch.from_numpy(vals).to(dev),
                                      P["VOCAB"])
                    if dev != "cpu" or PS_DEV == "cpu":
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        opt.apply_selected_rows(p, sr)
                        e1.record()
                        e1.synchronize()
                        ms.append(e0.elapsed_time(e1))
                    else:
                        opt.apply_selected_rows(p, sr)
                st = opt._accumulators[id(p)]
                out[dev] = (p.detach().cpu(), {k: v.cpu()
                                               for k, v in st.items()},
                            {k: v.cpu() for k, v in init.items()}, ms)
            (cw, cst, cinit, ms), (rw, rst, _, _) = out[PS_DEV], out["cpu"]
            scale = max(1.0, float(rw[mask].abs().max()))
            err = float((cw[mask] - rw[mask]).abs().max()) / scale
            same = bool(torch.equal(cw[~mask], w0[~mask]))
            st_err, st_same = 0.0, True
            for k in cst:
                sc = max(1.0, float(rst[k][mask].abs().max()))
                st_err = max(st_err, float((cst[k][mask] - rst[k][mask])
                                           .abs().max()) / sc)
                st_same &= bool(torch.equal(cst[k][~mask], cinit[k][~mask]))
            res[name] = dict(err=err, state_err=st_err, untouched=same,
                             state_untouched=st_same, ms=ms)
            print(f"ps (f) apply_selected_rows {name} on the card, "
                  f"{P['VOCAB']} x {P['DIM']}, {int(touched.sum())} rows "
                  f"touched in 2 updates: worst touched-row error "
                  f"{err:.2e}, accumulators {st_err:.2e} (x max(1, |ref|)); "
                  f"untouched rows unchanged {same}, accumulators {st_same}; "
                  f"{ms[0]:.3f} / {ms[1]:.3f} ms an update")
        self.details["ps_f"] = res
        for name, r in res.items():
            assert r["err"] <= 1e-6 and r["state_err"] <= 1e-6, (name, r)
            assert r["untouched"] and r["state_untouched"], (name, r)

    def kernels_line(self):
        srcs = {"paged_attention": (
                    "paddle_tpu_torch/csrc/paged_attention.cu",
                    "jax/experimental/pallas/ops/tpu/paged_attention/"
                    "paged_attention_kernel.py:376 (dispatched at "
                    "paddle_tpu/ops/paged_ops.py:239)"),
                "flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                              "paddle_tpu/ops/pallas_ops.py:143"),
                "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                                 "paddle_tpu/ops/pallas_ops.py:207"),
                "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                                  "paddle_tpu/ops/pallas_ops.py:251"),
                "splash_fwd": ("paddle_tpu_torch/csrc/splash_fwd.cu",
                               "paddle_tpu/ops/splash_ops.py:139"),
                "splash_bwd_dq": ("paddle_tpu_torch/csrc/splash_bwd_dq.cu",
                                  "paddle_tpu/ops/splash_ops.py:201"),
                "splash_bwd_dkv": ("paddle_tpu_torch/csrc/splash_bwd_dkv.cu",
                                   "paddle_tpu/ops/splash_ops.py:242")}
        out = []
        for name, (src, rep) in srcs.items():
            # the kernel in all (its fp32 row), then one entry per 16-bit
            # type a row was kept for ("flash_fwd.bfloat16"), launches
            # counted in that type
            for key in [name] + sorted(k for k in self.kernel_rows
                                       if k.startswith(name + ".")):
                r = self.kernel_rows.get(key, {})
                if key == name:
                    n = sum(p.get(name, 0)
                            for p in self.path_launches.values())
                else:
                    dt = key.split(".", 1)[1]
                    n = sum(p.get(name, {}).get(dt, 0)
                            for p in self.path_dtype_launches.values())
                out.append({"name": key, "route": "cuda", "source": src,
                            "replaces": rep, "launches": n,
                            "max_abs_err": r.get("max_abs_err"),
                            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                            "bound_ms": r.get("bound_ms"),
                            "bound_by": r.get("bound_by"),
                            "library_ms": r.get("library_ms")})
        return {"kernels": out}


# phase 15: the packed LM at GPT-2 small's widths (12 heads at hidden 768,
# vocabulary 50304, 1024 positions) cut to LAYERS layers, its global batch
# and step count, the spawned ranks' time limit, and the collectives the
# (b) arms run on CUDA tensors (ZeRO-1: all_reduce and all_gather; the tp
# lane: all_reduce)
DIST = dict(LAYERS=4, HIDDEN=768, HEADS=12, VOCAB=50304, ROWS=8, STEPS=3,
            LR=1e-4, TIMEOUT=600, NEEDS=("all_reduce", "all_gather",
                                          "send_recv"))

# phase 15's strategy arms: GPT-2 small's widths (12 heads at hidden 768,
# vocabulary 50304, 1024 positions) cut to LAYERS layers, at dropout 0,
# fp32, TF32 off, on a global batch of ROWS x S, SGD at LR (a rate whose
# two-step updates stand well above fp32 rounding of the weights); the
# pipeline's microbatches, each arm's steps, the DGC sparsity, the
# elastic launcher's limits
STRAT = dict(LAYERS=4, ROWS=8, S=1024, LR=0.1, N_MICRO=4, PP_STEPS=2,
             LOCAL_K4=4, DGC_STEPS=3, DGC_SPARSITY=0.999, TIMEOUT=900,
             ELASTIC=dict(TIMEOUT=5, GRACE=15, LIMIT=120))


def _strat_config():
    from paddle_tpu_torch.models import GPTConfig
    return GPTConfig(num_layers=STRAT["LAYERS"], dropout=0.0)


def _packed_gpt(torch, sharded, dropout):
    """Phase 15's packed LM at GPT-2 small's widths: token + position
    embeddings, DIST["LAYERS"] pre-LN blocks (fused QKV, causal attention
    within segments, GELU MLP), the tied LM head; the port's nn layers,
    seed 0. With `sharded` the attention is parallel.spmd.
    sharded_splash_attention (K5-K7 on the rank's rows, the dp rank in
    the dropout seed), else F.scaled_dot_product_attention(segment_ids=)
    as phase 7's LM runs it."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.parallel import sharded_splash_attention
    E, H, V, L = (DIST[k] for k in ("HIDDEN", "HEADS", "VOCAB", "LAYERS"))
    T = PACK["T"]

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1, self.ln2 = nn.LayerNorm(E), nn.LayerNorm(E)
            self.qkv, self.proj = nn.Linear(E, 3 * E), nn.Linear(E, E)
            self.fc1, self.fc2 = nn.Linear(E, 4 * E), nn.Linear(4 * E, E)

        def forward(self, x, seg):
            B, S, _ = x.shape
            qkv = self.qkv(self.ln1(x)).reshape(B, S, 3, H, E // H) \
                .permute(2, 0, 3, 1, 4)
            if sharded:
                o = sharded_splash_attention(
                    causal=True, dropout_p=dropout if self.training
                    else 0.0)(qkv[0], qkv[1], qkv[2], seg, seg)
            else:
                o = F.scaled_dot_product_attention(
                    qkv[0], qkv[1], qkv[2], is_causal=True, segment_ids=seg,
                    dropout_p=dropout, training=self.training)
            x = x + self.proj(o.transpose(1, 2).reshape(B, S, E))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class PackedGPT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wte, self.wpe = nn.Embedding(V, E), nn.Embedding(T, E)
            self.blocks = torch.nn.ModuleList(Block() for _ in range(L))
            self.ln_f = nn.LayerNorm(E)
            for emb in (self.wte, self.wpe):
                torch.nn.init.normal_(emb.weight, std=0.02)

        def forward(self, toks, seg, pos):
            x = self.wte(toks) + self.wpe(pos)
            for blk in self.blocks:
                x = blk(x, seg)
            return F.linear(self.ln_f(x), self.wte.weight.t())

    torch.manual_seed(0)
    return PackedGPT()


def _packed_loss(torch, logits, labels):
    """Token cross-entropy summed over the pack's real tokens and divided
    by its slots (rows x T), so the dp ranks' losses average to the global
    batch's."""
    y, mask = labels
    ce = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), y.reshape(-1),
        reduction="none")
    return (ce * mask.reshape(-1).float()).sum() / mask.numel()


def _dist_engine_kw(num_pages):
    return dict(max_slots=8, page_size=16, num_pages=num_pages,
                prefill_buckets=(16, 64, 256, 1024), max_new_tokens=64,
                request_timeout_ms=0)


def _dist_launches(po, fo, so):
    ws = {"paged_attention": po.paged_attention,
          "flash_fwd": fo.flash_attention_fwd,
          "flash_bwd_dq": fo.flash_attention_dq,
          "flash_bwd_dkv": fo.flash_attention_dkv,
          "splash_fwd": so.splash_attention_fwd,
          "splash_bwd_dq": so.splash_attention_dq,
          "splash_bwd_dkv": so.splash_attention_dkv}
    return ({n: w.launches for n, w in ws.items()},
            {n: dict(getattr(w, "launches_by_dtype", {}))
             for n, w in ws.items()}, ws)


def _zero(ws):
    for w in ws.values():
        w.launches = 0
        if hasattr(w, "launches_by_dtype"):
            w.launches_by_dtype.clear()


_PROBES = ("all_reduce", "all_gather", "broadcast", "reduce_scatter",
           "all_to_all_single", "send_recv")


def _dist_probe(wd):
    """A rank of phase 15 (b)'s probe, started by distributed.spawn: each
    collective of `_PROBES` once on CUDA tensors over gloo, the ranks in
    step (a barrier before each), `start` and the outcome appended to
    probe{r}.txt as they happen. A collective gloo refuses raises and is
    recorded; one that gloo hands the device pointer as host memory ends
    the process (gloo's IoException aborts), so the file's last `start`
    names it."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import env as denv
    penv = D.init_parallel_env(backend="gloo")
    r, dev = penv.rank, denv.local_device()
    calls = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "all_gather": lambda t: dist.all_gather(
            [torch.empty_like(t) for _ in range(2)], t),
        "broadcast": lambda t: dist.broadcast(t, 0),
        "reduce_scatter": lambda t: dist.reduce_scatter(
            torch.empty_like(t[:4]), list(t.chunk(2))),
        "all_to_all_single": lambda t: dist.all_to_all_single(
            torch.empty_like(t), t),
        # the port's send / recv, which stage a CUDA tensor through the
        # host on a gloo group (C35); gloo's own abort on it
        "send_recv": lambda t: (D.send(t, 1) if r == 0
                                else D.recv(t, 0)),
    }
    with open(os.path.join(wd, f"probe{r}.txt"), "w", buffering=1) as f:
        for name in _PROBES:
            dist.barrier()
            f.write(f"start {name}\n")
            try:
                calls[name](torch.arange(8, dtype=torch.float32,
                                         device=dev))
                torch.cuda.synchronize()
                f.write(f"ok {name}\n")
            except Exception as e:  # noqa: BLE001 — recorded for the parent
                f.write(f"refused {name} {type(e).__name__}\n")
    D.destroy_process_group()


def _probe_outcomes(wd):
    """{collective: outcome} read from the probe ranks' files: "ok" where
    both ranks completed it, else each rank's: refused (it raised),
    aborts the process (its `start` is that rank's last line), or not
    probed (after an abort)."""
    per = []
    for r in range(2):
        path = os.path.join(wd, f"probe{r}.txt")
        got = {}
        for line in (open(path).read().split("\n")
                     if os.path.exists(path) else []):
            if line:
                kind, name = line.split()[:2]
                got[name] = ("aborts the process" if kind == "start" else
                             "ok" if kind == "ok" else
                             "refused: " + line.split()[2])
        per.append(got)
    out = {}
    for n in _PROBES:
        each = [g.get(n, "not probed") for g in per]
        out[n] = "ok" if each == ["ok", "ok"] else \
            "; ".join(f"rank {r} {o}" for r, o in enumerate(each))
    return out


def _dist_rank(wd):
    """A rank of phase 15 (b), started by distributed.spawn: joins the
    world over gloo on the card (both ranks on cuda:0), then serves phase 5's
    requests at tp 2 (fp32 pools, then int8; rank 0 schedules) and trains
    the packed LM at dp 2 with ZeRO-1 (dropout 0, then
    DROPOUT), writing its record to rank{r}.json. Launch counts start
    at 0 in this fresh process and are read after each arm."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer, serving
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
    from paddle_tpu_torch.ops import splash_ops as so
    from paddle_tpu_torch.parallel import make_sharded_train_step
    import torch.distributed as dist
    penv = D.init_parallel_env(backend="gloo")
    r = penv.rank
    dev = denv.local_device()
    rec = {"rank": r, "backend": denv.backend(), "device": str(dev)}
    _, _, ws = _dist_launches(po, fo, so)
    # tp 2 serving of phase 5's requests
    with open(os.path.join(wd, "requests.json")) as f:
        req = json.load(f)
    with open(os.path.join(wd, "gpt.json")) as f:
        gpt = GPTForCausalLM(GPTConfig(**json.load(f)), device=dev).eval()
    gpt.load_state_dict(torch.load(os.path.join(wd, "gpt.pt"),
                                   map_location=dev))
    rec["serve"] = {}
    for kv, dtype in (("fp32", "auto"), ("int8", "int8")):
        _zero(ws)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = serving.GenerationEngine(
            gpt, device=dev, name=f"dist_tp2_{kv}", tp=2,
            kv_cache_dtype=dtype, **_dist_engine_kw(req["num_pages"]))
        out = {"local_heads": eng._cache.local_heads}
        if r == 0:
            futs = [eng.submit(np.asarray(p), max_new_tokens=n)
                    for p, n in zip(req["prompts"], req["new"])]
            out["outs"] = [fut.result(600).tolist() for fut in futs]
            out["steps"] = eng.stats()["steps"]
        eng.shutdown()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["launches"], out["launches_by_dtype"], _ = _dist_launches(
            po, fo, so)
        rec["serve"][kv] = out
        del eng
        dist.barrier()
    del gpt
    torch.cuda.empty_cache()
    # dp 2 packed training, ZeRO-1, on the global batch
    z = np.load(os.path.join(wd, "batch.npz"))
    batch = [z[f"arr_{i}"] for i in range(5)]
    ins = [torch.as_tensor(x) for x in batch[:3]]
    lbs = [torch.as_tensor(x) for x in batch[3:5]]
    _zero(ws)
    t = {}
    for tag, p in (("", 0.0), ("_dropout", DROPOUT)):
        model = _packed_gpt(torch, sharded=True, dropout=p).to(dev)
        model.load_state_dict(torch.load(os.path.join(wd, "packed.pt"),
                                         map_location=dev))
        opt = optimizer.Adam(DIST["LR"], parameters=model.parameters())
        step, st = make_sharded_train_step(
            model, opt, lambda o, lb: _packed_loss(torch, o, lb),
            zero_stage=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(DIST["STEPS"]):
            st, lv = step(st, ins, lbs, rng=11)
            losses.append(float(lv))
        torch.cuda.synchronize()
        t[f"wall{tag}_s"] = time.perf_counter() - t0
        t[f"losses{tag}"] = losses
        if not tag:
            t["peak_bytes"] = torch.cuda.max_memory_allocated()
            t["opt_bytes"] = sum(x.numel() * x.element_size()
                                 for v in st["opt_state"].values()
                                 for x in v.values())
        del model, opt, step, st
        torch.cuda.empty_cache()
    # the keep mask on identical rows: q = k = 0 and v = 1 make each
    # output the kept share of a row's allowed keys / (1 - p)
    seg = torch.as_tensor(batch[1][:DIST["ROWS"] // 2]).to(dev)
    q = torch.zeros(seg.shape[0], DIST["HEADS"], PACK["T"],
                    DIST["HIDDEN"] // DIST["HEADS"], device=dev)
    o = F.scaled_dot_product_attention(q, q, torch.ones_like(q),
                                       is_causal=True, segment_ids=seg,
                                       dropout_p=DROPOUT, training=True)
    t["keep_share"] = float(o[..., 0].double().mean()) * (1 - DROPOUT)
    t["launches"], t["launches_by_dtype"], _ = _dist_launches(po, fo, so)
    rec["train"] = t
    with open(os.path.join(wd, f"rank{r}.json"), "w") as f:
        json.dump(rec, f)
    D.destroy_process_group()


# phase 15 (g): the lanes beyond "the whole world is one lane", on four
# gloo ranks of the card. (g1) phase 5d's traffic and tier settings at
# tp 2 (the prefix cache holds DEVICE_PAGES pages, the host HOST_BYTES,
# chunks of CHUNK pages: whole chains demote and promote, so a promoted
# chain's bytes are the never-evicted chain's), TIER_NEW new tokens a
# request (phase 5d's 32 cut); (g2) phase 5e (a)'s failpoints under a
# supervised tp 2 lane and (g3) on each lane the first G3_REQUESTS of
# phase 5's requests, each cut to at most NEW new tokens (phase 5's
# 32-64). The cuts are for time: a gloo lane on one card decodes ~8x
# slower than tp 1 (50 ms a step), and the slice may add 120 s; a follower fault under a bound of
# FAULT_TIMEOUT_S; the ranks' time limit
LANES = dict(DEVICE_PAGES=80, HOST_BYTES=256 << 20, CHUNK=4, TIER_NEW=8,
             NEW=16, G3_REQUESTS=4, FAULT_TIMEOUT_S=5.0, TIMEOUT=600,
             FAULTS=(("decode", "decode_step_raise@12"),
                     ("prefill", "prefill_raise@1")))


def _lanes_tier_kw(dtype, num_pages):
    """(g1)'s tier engine settings at phase 5's engine settings."""
    return dict(_dist_engine_kw(num_pages), kv_cache_dtype=dtype,
                prefix_cache=True,
                prefix_cache_max_pages=LANES["DEVICE_PAGES"],
                kv_tier=True, kv_tier_host_bytes=LANES["HOST_BYTES"],
                kv_tier_chunk_pages=LANES["CHUNK"])


def _lanes_serve_one_by_one(eng, prompts, new):
    """Each request drained before the next (phase 5d's order): outputs,
    decode steps, the tier's audit counts, whether a page or slot
    leaked, wall s."""
    import numpy as np
    t0 = time.perf_counter()
    outs = [np.asarray(eng.submit(np.asarray(p), max_new_tokens=n)
                       .result(600)).tolist()
            for p, n in zip(prompts, new)]
    wall = time.perf_counter() - t0
    reasons = [e["reason"] for e in eng._audit.tail(4096)]
    counts = {c: reasons.count(c) for c in (
        "KV_PROMOTE", "KV_DEMOTE", "KV_TIER_EVICT", "KV_PROMOTE_ABANDON",
        "ADMIT", "ADMIT_PREFIX_HIT")}
    return dict(outs=outs, steps=eng.stats()["steps"], counts=counts,
                leak_free=Smoke.tier_leak_free(eng), wall_s=wall)


def _lanes_sync(sync, fn=None):
    """Two barriers on the pair's own group around `fn`: the leader's
    warmup has reached every rank before, and every rank has run `fn`
    (zeroing its launch counts) after."""
    import torch.distributed as dist
    dist.barrier(group=sync)
    if fn is not None:
        fn()
    dist.barrier(group=sync)


def _lanes_tier(gpt, dev, r, wd, ws, sync, po, fo, so):
    """(g1), on all four ranks at once: ranks 0-1 take the fp32 pools,
    ranks 2-3 (a tp_mesh(2, devices=[2, 3]) lane) the int8 pools. Each
    pair serves phase 5d's traffic through two lanes on its ranks at once
    (the requests one at a time in each): one with an unbounded prefix
    cache, which never evicts, and one through the host tier. Launches
    count from the end of the warmups; a rank's are both lanes'."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.parallel import tp_mesh
    with open(os.path.join(wd, "lanes.json")) as f:
        req = json.load(f)
    pair = [0, 1] if r < 2 else [2, 3]
    dtype = "float32" if r < 2 else "int8"
    mesh = tp_mesh(2, devices=pair)
    kws = {"ref": dict(_dist_engine_kw(req["ref_pages"]),
                       kv_cache_dtype=dtype, prefix_cache=True),
           "tier": _lanes_tier_kw(dtype, req["tier_pages"])}
    engs = {arm: serving.GenerationEngine(gpt, device=dev, mesh=mesh,
                                          name=f"g1_{arm}_{dtype}", **kw)
            for arm, kw in kws.items()}
    _lanes_sync(sync, lambda: _zero(ws))
    rows = {arm: {} for arm in engs}

    def run(arm):
        try:
            rows[arm] = _lanes_serve_one_by_one(engs[arm], req["prompts"],
                                                req["new"])
        except Exception as e:  # noqa: BLE001 — the parent's gates fail
            rows[arm] = {"error": repr(e)}
    if mesh.axis_rank("tp") == 0:
        threads = [threading.Thread(target=run, args=(arm,))
                   for arm in engs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    for eng in engs.values():
        eng.shutdown()
    tier = engs["tier"]
    for arm, eng in engs.items():
        rows[arm]["staged_left"] = len(eng._staged)
    rows["tier"].update(
        slab=dict(slots=tier._slab.slots, slot_bytes=tier._slab.slot_bytes,
                  reserved=tier._slab.reserved_bytes),
        host_bytes=tier._tier.host_bytes)
    return dict(dtype=dtype, pair=pair, lanes=[e._lane.name
                                               for e in engs.values()],
                launches=_dist_launches(po, fo, so)[0], **rows)


def _lanes_supervised(gpt, dev, r, wd, ws, sync, po, fo, so):
    """(g2) on ranks 0-1: phase 5's 16 streamed requests through a
    supervised tp 2 lane under each of LANES["FAULTS"]."""
    import numpy as np
    import torch.distributed as dist
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.serving import failpoints
    with open(os.path.join(wd, "requests.json")) as f:
        req = json.load(f)
    out = {}
    for arm, fp in LANES["FAULTS"]:
        set_flags({"FLAGS_gen_restart_backoff_ms": 5.0})
        groups0 = len(dist.distributed_c10d._world.pg_names)
        sup = serving.EngineSupervisor(
            gpt, device=dev, name=f"g2_{arm}", tp=2,
            **_dist_engine_kw(req["num_pages"]))
        lane = sup.engine._lane
        groups1 = len(dist.distributed_c10d._world.pg_names)
        _lanes_sync(sync, lambda: _zero(ws))
        row = {}
        if sup.leads:
            eng0 = sup.engine
            steps0 = eng0.stats()["steps"]
            failpoints.reset()
            set_flags({"FLAGS_failpoints": fp})
            try:
                res, collected, _a, _s, wall = Smoke.fleet_streams(
                    sup, [np.asarray(p) for p in req["prompts"]],
                    [min(m, LANES["NEW"]) for m in req["new"]],
                    lock=lambda: sup.engine._cv)
            finally:
                set_flags({"FLAGS_failpoints": ""})
            eng1 = sup.engine
            events = eng1._audit.tail(4096)
            reasons = [e["reason"] for e in events]
            row.update(
                outs=[x.tolist() if isinstance(x, np.ndarray) else repr(x)
                      for x in res],
                collected=[[int(t) for t in c] for c in collected],
                wall_s=wall,
                steps=eng0.stats()["steps"] - steps0
                + eng1.stats()["steps"],
                restarts_audit=reasons.count("ENGINE_RESTART"),
                entries=sum(e["entries"] for e in events
                            if e["reason"] == "ENGINE_RESTART"),
                replay_admit=reasons.count("REPLAY_ADMIT"),
                pages_in_use=eng1.stats()["pages"]["pages_in_use"])
        sup.shutdown()
        row.update(launches=_dist_launches(po, fo, so)[0],
                   incarnation=sup.incarnation, restarts=sup.restarts,
                   same_lane=sup.engine._lane is lane,
                   lane_groups=groups1 - groups0,
                   rebuild_groups=len(dist.distributed_c10d._world.pg_names)
                   - groups1)
        out[arm] = row
    return out


def _lanes_four(gpt, dev, r, wd):
    """(g3) on all four ranks: a dp 2 x tp 2 mesh (ranks 0 and 2 lead);
    a tp_mesh(2, devices=[2, 3]) lane while ranks 0-1 stay idle (and
    refuse to join it); the router over two tp 2 replicas on ranks 0-1
    while ranks 2-3 stay idle; a lane on ranks 0-1 whose follower raises
    inside its first decode program after warmup."""
    import numpy as np
    import torch.distributed as dist
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.parallel import create_mesh, set_mesh, tp_mesh
    from paddle_tpu_torch.serving.tp_lane import LaneFault
    with open(os.path.join(wd, "requests.json")) as f:
        req = json.load(f)
    n = LANES["G3_REQUESTS"]
    prompts = [np.asarray(p) for p in req["prompts"][:n]]
    new = [min(m, LANES["NEW"]) for m in req["new"][:n]]
    kw = _dist_engine_kw(req["num_pages"])

    def serve(front):
        t0 = time.perf_counter()
        futs = [front.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, new)]
        outs = [np.asarray(f.result(600)).tolist() for f in futs]
        return outs, time.perf_counter() - t0

    out = {}
    t0 = time.perf_counter()
    mesh = create_mesh({"dp": 2, "tp": 2})
    eng = serving.GenerationEngine(gpt, device=dev, mesh=mesh,
                                   name="g3_mesh", **kw)
    out["mesh"] = dict(lane=eng._lane.ranks, leader=eng._lane.leader)
    if eng._lane.leader:
        out["mesh"]["outs"], out["mesh"]["wall_s"] = serve(eng)
    eng.shutdown()
    set_mesh(None)
    dist.barrier()
    out["mesh"]["arm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sub = tp_mesh(2, devices=[2, 3])
    if r >= 2:
        eng = serving.GenerationEngine(gpt, device=dev, mesh=sub,
                                       name="g3_sub", **kw)
        out["sub"] = dict(lane=eng._lane.ranks)
        if eng._lane.leader:
            out["sub"]["outs"], out["sub"]["wall_s"] = serve(eng)
        eng.shutdown()
    else:
        try:
            serving.GenerationEngine(gpt, device=dev, mesh=sub,
                                     name="g3_sub", **kw)
            out["sub"] = dict(refused=None)
        except InvalidArgumentError as e:
            out["sub"] = dict(refused=str(e))
    dist.barrier()
    out["sub"]["arm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if r < 2:
        router = serving.Router(gpt, tp=2, num_replicas=2, device=dev,
                                name="g3_router", pressure_ttl_ms=0.0,
                                **kw)
        out["router"] = {}
        if r == 0:
            out["router"]["outs"], out["router"]["wall_s"] = serve(router)
            out["router"]["placements"] = {
                k: v["placements"] for k, v in
                router.stats()["router"]["replicas"].items()}
        router.shutdown()
    dist.barrier()
    out.setdefault("router", {})["arm_s"] = time.perf_counter() - t0
    if r < 2:
        set_flags({"FLAGS_gen_tp_timeout_s": LANES["FAULT_TIMEOUT_S"]})
        cls = serving.GenerationEngine
        orig, calls, t_fault = cls._decode_call, [0], []

        def faulty(self, *a, **k):
            calls[0] += 1
            if calls[0] == 2:     # the first decode after the warmup's
                t_fault.append(time.perf_counter())
                raise RuntimeError("injected fault inside the decode "
                                   "program")
            return orig(self, *a, **k)
        if r == 1:
            cls._decode_call = faulty
        f = dict(error=None)
        try:
            eng = cls(gpt, device=dev, tp=2, name="g3_fault", **kw)
            t0 = time.perf_counter()
            if r == 0:
                eng.generate(prompts[0], max_new_tokens=new[0])
            else:
                eng.shutdown()
        except LaneFault as e:
            f.update(error=type(e).__name__, rank=e.rank, msg=str(e))
        finally:
            cls._decode_call = orig
            set_flags({"FLAGS_gen_tp_timeout_s": 300.0})
        f["ended_s"] = time.perf_counter() - (t_fault[0] if t_fault
                                              else t0)
        if r == 0:
            eng.shutdown()
        out["fault"] = f
    dist.barrier()
    return out


def _lanes_rank(wd):
    """A rank of phase 15 (g), started by distributed.spawn: four ranks
    over gloo on the card, (g1) on all four, (g2) on ranks 0-1 (ranks 2-3
    wait), then (g3) on all four. Writes its record to lanes{r}.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
    from paddle_tpu_torch.ops import splash_ops as so
    from paddle_tpu_torch.parallel.mesh import local_group
    penv = D.init_parallel_env(backend="gloo")
    r = penv.rank
    dev = denv.local_device()
    _, _, ws = _dist_launches(po, fo, so)
    with open(os.path.join(wd, "gpt.json")) as f:
        gpt = GPTForCausalLM(GPTConfig(**json.load(f)), device=dev).eval()
    gpt.load_state_dict(torch.load(os.path.join(wd, "gpt.pt"),
                                   map_location=dev))
    rec = {"rank": r, "device": str(dev)}
    sync = local_group([0, 1] if r < 2 else [2, 3])
    t0 = time.perf_counter()
    rec["tier"] = _lanes_tier(gpt, dev, r, wd, ws, sync, po, fo, so)
    rec["tier_s"] = time.perf_counter() - t0
    dist.barrier()
    if r < 2:
        t0 = time.perf_counter()
        rec["sup"] = _lanes_supervised(gpt, dev, r, wd, ws, sync, po, fo,
                                       so)
        rec["sup_s"] = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    rec["four"] = _lanes_four(gpt, dev, r, wd)
    rec["four_s"] = time.perf_counter() - t0
    with open(os.path.join(wd, f"lanes{r}.json"), "w") as f:
        json.dump(rec, f)
    D.destroy_process_group()


def _update_worst(got, ref, init):
    """(the worst over parameters of max |got - ref| / (1e-3 x max |ref|
    + 1e-6 x the model's largest |ref| + 3 fp32 eps x max |init|), that
    parameter), updates by name, in float64: phase 7's gradient rule on
    updates, plus the resolution of the fp32 weights themselves (a weight
    near 1, a LayerNorm's, moves by less than its own ulps in a step at
    this rate, and LocalSGD rounds each replica and then their mean)."""
    import torch
    eps = torch.finfo(torch.float32).eps
    floor = 1e-6 * max(d.abs().max().item() for d in ref.values())
    return max(((got[n].double() - ref[n].double()).abs().max().item()
                / (1e-3 * ref[n].abs().max().item() + floor
                   + 3 * eps * init[n].abs().max().item()), n)
               for n in ref)


def _fingerprint(t):
    """A digest of a tensor's bytes (exact equality across ranks)."""
    import hashlib
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()


def _dist_rank_strategies(wd, device):
    """A rank of phase 15 (b)'s strategy arms, started by
    distributed.spawn: joins the world over gloo on `device` (both ranks
    on cuda:0), runs the arms below on the strategies' GPT (`_strat_config`)
    from (a)'s saved weights and batch, and writes its record to
    strat{r}.json. Each arm starts with the launch counts at 0 and reads
    them at its end:
    - c35: the port's send / recv of a CUDA tensor, a ppermute hop and
      its gradient, bit for bit;
    - pp 2 (STRAT["LAYERS"] / 2 blocks a stage, STRAT["N_MICRO"]
      microbatches): GPipe,
      GPipe with recompute, 1F1B, 2 steps each;
    - sp 2: ring and Ulysses attention of [8, 12, 1024, 64] causal (512
      rows a rank), fp32 and bf16, output and q/k/v gradients against
      whole-sequence attention on the card; one sp step of the GPT with
      use_ring=True;
    - LocalSGD: k_steps=1, 2 steps; k_steps=4, 4 steps with a digest of
      the replica after each;
    - DGC: 3 steps at STRAT["DGC_SPARSITY"], each tensor's kept entries,
      and at the last step the emitted gradient and (u, v) against
      dgc_compress on the CPU on the same gradients and state;
    - hapi Model.fit under fleet.init and fleet.distributed_optimizer,
      routed through the strategy's step: a pipeline strategy (pp 2,
      accumulate_steps STRAT["N_MICRO"]) over the batch for
      STRAT["PP_STEPS"] epochs (the stages written back at each epoch's
      end), and the default strategy (dp 2) over (a)'s R + R/2 rows, whose
      padded tail folds its row mask over the global count.
    Then the hybrid arms in the same world (`_hybrid_arms`)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
    from paddle_tpu_torch.ops import splash_ops as so
    from paddle_tpu_torch.parallel import (compression, create_mesh,
                                           local_write_back,
                                           make_local_train_step,
                                           make_pipeline_train_step,
                                           make_sharded_train_step,
                                           shard_map_ring_attention)
    penv = D.init_parallel_env(backend="gloo", device=device)
    r = penv.rank
    dev = denv.local_device()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    _, _, ws = _dist_launches(po, fo, so)
    with open(os.path.join(wd, "s_cfg.json")) as f:
        cfg = GPTConfig(**json.load(f))
    z = np.load(os.path.join(wd, "s_batch.npz"))
    X, Y = z["x"], z["y"]
    init = torch.load(os.path.join(wd, "s_init.pt"), map_location=dev)
    ref = torch.load(os.path.join(wd, "s_ref.pt"), map_location=dev)
    ce = nn.CrossEntropyLoss()

    def lossf(o, lb):
        return ce(o, lb[0])
    lr = STRAT["LR"]

    def fresh():
        m = GPTForCausalLM(cfg, device=dev, seed=0)
        m.load_state_dict(init)
        return m

    def worst(m, d, names=None):
        got = {n: p.detach() - init[n] for n, p in m.named_parameters()
               if names is None or n in names}
        return list(_update_worst(got, {n: d[n] for n in got}, init))
    rec = {"rank": r}

    def arm(name, fn):
        _zero(ws)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out = fn()
        sync()
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                             else 0)
        out["launches"], out["launches_by_dtype"], _ = _dist_launches(
            po, fo, so)
        rec[name] = out
        dist.barrier()
        if cuda:
            torch.cuda.empty_cache()

    def timed(step, st, *a, **k):
        sync()
        t0 = time.perf_counter()
        st, lv = step(st, *a, **k)
        lv = float(lv)
        return st, lv, time.perf_counter() - t0

    # C35: point-to-point of CUDA tensors over gloo
    x = torch.arange(1024, dtype=torch.float32, device=dev) * (r + 1.5)
    t = x.clone()
    if r == 0:
        D.send(t, dst=1)
    else:
        D.recv(t, src=0)
    want = torch.arange(1024, dtype=torch.float32, device=dev) * 1.5
    y = D.ppermute(x.clone().requires_grad_(), [(0, 1), (1, 0)])
    xg = x.clone().requires_grad_()
    D.ppermute(xg, [(0, 1), (1, 0)]).mul(r + 1).sum().backward()
    rec["c35"] = dict(
        send_recv=bool(torch.equal(t, want)),
        hop=bool(torch.equal(y.detach(), torch.arange(
            1024, dtype=torch.float32, device=dev) * (2 - r + 0.5))),
        grad=bool(torch.equal(xg.grad, torch.full_like(x, 2 - r))))
    # pp = 2
    create_mesh({"dp": 1, "pp": 2})
    for tag, sched, rc in (("pp_gpipe", "gpipe", False),
                           ("pp_gpipe_recompute", "gpipe", True),
                           ("pp_1f1b", "1f1b", False)):
        def run():
            m = fresh()
            step, st = make_pipeline_train_step(
                m, optimizer.SGD(lr, parameters=m.parameters()), lossf,
                n_micro=STRAT["N_MICRO"], schedule=sched, recompute=rc)
            losses, walls = [], []
            for _ in range(STRAT["PP_STEPS"]):
                st, lv, w = timed(step, st, (X,), (Y,))
                losses.append(lv)
                walls.append(w)
            held = set(st["params"])
            return dict(losses=losses, step_s=walls, stage=step.stage,
                        held=len(held), worst=worst(m, ref[
                            f"d{STRAT['PP_STEPS']}"], held))
        arm(tag, run)
    # sp = 2
    mesh = create_mesh({"sp": 2})

    def sp():
        errs = {}
        B, H, S = 8, cfg.num_heads, STRAT["S"]
        Dh = cfg.hidden_size // H
        g = torch.Generator(device=dev).manual_seed(9)
        base = [torch.randn(B, H, S, Dh, generator=g, device=dev)
                for _ in range(4)]
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        for impl in ("ring", "ulysses"):
            for dt in ("float32", "bfloat16"):
                qkv = [b.to(getattr(torch, dt)).requires_grad_()
                       for b in base[:3]]
                o = shard_map_ring_attention(*qkv, mesh, causal=True,
                                             impl=impl)
                gs = torch.autograd.grad((o.float() * base[3]).sum(), qkv)
                rq = [b.detach().to(getattr(torch, dt)).float()
                      .requires_grad_() for b in base[:3]]
                sc = torch.matmul(rq[0], rq[1].transpose(-1, -2)) \
                    / Dh ** 0.5
                sc = torch.where(mask, sc, torch.full((), -1e30,
                                                      device=dev))
                ro = torch.matmul(torch.softmax(sc, -1), rq[2])
                rg = torch.autograd.grad((ro * base[3]).sum(), rq)
                errs[f"{impl} {dt}"] = max(
                    (a.float() - b).abs().max().item()
                    / max(1.0, b.abs().max().item())
                    for a, b in [(o, ro)] + list(zip(gs, rg)))
                del qkv, o, gs, rq, sc, ro, rg
        m = fresh()

        class Ring(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.m = m

            def forward(self, ids):
                return self.m(ids, use_ring=True)
        step, st = make_sharded_train_step(
            Ring(), optimizer.SGD(lr, parameters=m.parameters()), lossf,
            sp_axis="sp", zero_stage=0)
        st, lv, w = timed(step, st, (X,), (Y,))
        return dict(attn=errs, loss=lv, step_s=w, worst=worst(m, ref["d1"]))
    arm("sp", sp)
    # LocalSGD
    create_mesh({"dp": 2})

    def local1():
        m = fresh()
        step, st = make_local_train_step(
            m, optimizer.SGD(lr, parameters=m.parameters()), lossf,
            k_steps=1, begin_step=0)
        losses, walls = [], []
        for _ in range(2):
            st, lv, w = timed(step, st, (X,), (Y,))
            losses.append(lv)
            walls.append(w)
        local_write_back(m, st)
        return dict(losses=losses, step_s=walls, worst=worst(m, ref["d2"]))
    arm("local1", local1)

    def local4():
        m = fresh()
        step, st = make_local_train_step(
            m, optimizer.SGD(lr, parameters=m.parameters()), lossf,
            k_steps=STRAT["LOCAL_K4"])
        prints, walls = [], []
        for _ in range(STRAT["LOCAL_K4"]):
            st, lv, w = timed(step, st, (X,), (Y,))
            walls.append(w)
            prints.append(_fingerprint(torch.cat(
                [p.reshape(-1) for p in st["params"].values()])))
        return dict(prints=prints, step_s=walls)
    arm("local4", local4)

    # DGC
    def dgc():
        m = fresh()
        sparsity = STRAT["DGC_SPARSITY"]
        seen = {"kept": [], "k_ok": True, "ties": 0, "ties_ok": True}
        real = compression.dgc_compress
        last = STRAT["DGC_STEPS"]

        def spy(grads, state, momentum, sp_, **kw):
            seen["n"] = seen.get("n", 0) + 1
            if seen["n"] == last:
                seen["cpu_in"] = ({k: v.detach().cpu() for k, v in
                                   grads.items()},
                                  {k: {a: b.detach().cpu() for a, b in
                                       v.items()} for k, v in state.items()})
            out, new = real(grads, state, momentum, sp_, **kw)
            kept = 0
            for k, v in out.items():
                # |v| before the split (emitted + left behind), the k-th
                # largest of it, and the entries at or above it
                a = (new[k]["v"] + v).abs().reshape(-1)
                kk = max(1, int(round(a.numel() * (1.0 - sp_))))
                top = torch.topk(a, kk).values
                n_kept = int((a >= top[-1]).sum())
                kept += n_kept
                outside = int(((v.reshape(-1) != 0) & (a < top[-1])).sum())
                seen["k_ok"] &= n_kept >= kk and outside == 0
                if n_kept > kk:
                    # more than k only where |v| ties the k-th largest
                    seen["ties"] += 1
                    seen["ties_ok"] &= bool(
                        torch.topk(a, n_kept).values[-1] == top[-1])
            seen["kept"].append(kept)
            if seen["n"] == last:
                seen["card_out"] = (
                    {k: v.detach().cpu() for k, v in out.items()},
                    {k: {a: b.detach().cpu() for a, b in v.items()}
                     for k, v in new.items()})
            return out, new
        compression.dgc_compress = spy
        try:
            step, st = make_sharded_train_step(
                m, optimizer.SGD(lr, parameters=m.parameters()), lossf,
                zero_stage=0, dgc=True, dgc_sparsity=sparsity)
            losses, walls = [], []
            for _ in range(last):
                st, lv, w = timed(step, st, (X,), (Y,))
                losses.append(lv)
                walls.append(w)
        finally:
            compression.dgc_compress = real
        g_in, s_in = seen["cpu_in"]
        c_out, c_new = real(g_in, s_in, 0.9, sparsity)
        d_out, d_new = seen["card_out"]
        diff = [max((c_out[k] - d_out[k]).abs().max().item()
                    for k in c_out)]
        for leaf in ("u", "v"):
            diff.append(max((c_new[k][leaf] - d_new[k][leaf]).abs().max()
                            .item() for k in c_new))
        return dict(losses=losses, step_s=walls, kept=seen["kept"],
                    size=sum(p.numel() for p in m.parameters()),
                    k_ok=seen["k_ok"], ties=seen["ties"],
                    ties_ok=seen["ties_ok"], cpu_diff=diff)
    arm("dgc", dgc)

    # hapi Model.fit under fleet.init, routed through the strategy's step
    from paddle_tpu_torch import Model, callbacks, io
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel import get_mesh, set_mesh

    class Rows(io.Dataset):
        def __init__(self, x, y):
            self.x, self.y = x, y

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    def fit(strategy, x, y, epochs, d, want_mesh):
        fleet.init(is_collective=True, strategy=strategy)
        try:
            m = fresh()
            model = Model(m)
            model.prepare(fleet.distributed_optimizer(
                optimizer.SGD(lr, parameters=m.parameters())), ce)
            losses, walls = [], []

            class Rec(callbacks.Callback):
                def on_train_batch_begin(self, step, logs=None):
                    sync()
                    walls.append(time.perf_counter())

                def on_train_batch_end(self, step, logs=None):
                    losses.append(float(logs["loss"]))
                    walls[-1] = time.perf_counter() - walls[-1]
            model.fit(Rows(x, y), batch_size=len(X), epochs=epochs,
                      shuffle=False, verbose=0, log_freq=1,
                      callbacks=[Rec()])
            mesh = dict(get_mesh().shape)
            return dict(losses=losses, step_s=walls,
                        routed=model._dist_ctx is not None
                        and model._sharded_step is not None,
                        mesh=mesh, mesh_ok=mesh == want_mesh,
                        worst=worst(m, d))
        finally:
            fleet.fleet._inited = False
            set_mesh(None)
    s_pp = fleet.DistributedStrategy()
    s_pp.pipeline = True
    s_pp.pipeline_configs["accumulate_steps"] = STRAT["N_MICRO"]
    arm("fit_pp", lambda: fit(s_pp, X, Y, STRAT["PP_STEPS"],
                              ref[f"d{STRAT['PP_STEPS']}"],
                              {"dp": 1, "pp": 2}))
    zf = np.load(os.path.join(wd, "s_fit_batch.npz"))
    fit_ref = torch.load(os.path.join(wd, "s_fit_ref.pt"), map_location=dev)
    arm("fit_dp_tail", lambda: fit(fleet.DistributedStrategy(), zf["x"],
                                   zf["y"], 1, fit_ref, {"dp": 2}))
    with open(os.path.join(wd, f"strat{r}.json"), "w") as f:
        json.dump(rec, f)
    del ref, init, fit_ref
    _hybrid_arms(wd)
    D.destroy_process_group()


# phase 15 (c)-(f): the hybrid arms on two gloo ranks of the card. ERNIE-base
# (12 layers of 12 heads at hidden 768) at mp 2 on phase 8 (b)'s first
# padded 8 x 512 batches, AdamW LR (the O1 step: SGD at O1_LR); the
# 8-expert MoE GPT at GPT-2-small
# widths and MOE_LAYERS layers at ep 2 on phase 11's 8 x 1024 batch; the
# packed LM at dp 2 under ClipGradByGlobalNorm(CLIP), Lamb at
# LAMB_LR, DGC at DGC_SPARSITY; GPipe at pp 2 of the strategies' GPT under
# the clip (SGD at STRAT LR but where named); STEPS steps an arm
HYBRID = dict(STEPS=3, LR=1e-4, MOE_LAYERS=4, CLIP=1.0, LAMB_LR=1e-3,
              DGC_SPARSITY=0.999, O1_LR=1.0)
# ERNIE's AdamW arms (`_adam_worst`): the share of a parameter's elements
# that may lie outside rtol 1e-4 / atol 1e-5 of the reference (an element
# whose gradient is summation-order noise moves by up to lr either way),
# and the most an AdamW step moves an element, over lr: |m^| / (sqrt(v^) +
# eps) <= sqrt(sum_i w_i^2 / u_i) (Cauchy-Schwarz over the steps' moment
# weights w_i, u_i), 1.0035 for 3 steps at betas (0.9, 0.999)
ADAM_SHARE = 2e-2
ADAM_STEP_MAX = 1.01


def _hybrid_ernie(np, dropout):
    """(c)'s ERNIE-base config at `dropout` (hidden and attention) and
    phase 8 (b)'s first HYBRID["STEPS"] batches: [(inputs, labels)] as
    numpy."""
    from paddle_tpu_torch.models import ErnieConfig
    cfg = ErnieConfig.base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    B, S, n = ERNIE_LONG["B"], ERNIE_LONG["S"], HYBRID["STEPS"]
    lens = _ernie_lengths(np, B * n, S, seed=1)
    ids, labels, mask = _ernie_cls_set(np, B * n, S, cfg.vocab_size, B,
                                       seed=1, lengths=lens)
    out = []
    for i in range(n):
        rows = slice(i * B, (i + 1) * B)
        out.append(((ids[rows], np.zeros_like(ids[rows]),
                     np.tile(np.arange(S), (B, 1)), mask[rows]),
                    (labels[rows],)))
    return cfg, out


def _hybrid_ernie_opt(optimizer, tag, m):
    """(c)'s optimizer: AdamW at HYBRID["LR"]; for the O1 step (and its
    fp32 reference, "o1_fp32") SGD at HYBRID["O1_LR"], so its update is
    the gradient (`_bf16_worst`)."""
    if tag.startswith("o1"):
        return optimizer.SGD(HYBRID["O1_LR"], parameters=m.parameters())
    return optimizer.AdamW(HYBRID["LR"], parameters=m.parameters())


def _hybrid_moe_batch(np):
    """(d)'s batch: phase 11's motif rows, MOE["B"] x MOE["S"] (+1)."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(0, 4096, size=rng.randint(3, 9))
              for _ in range(64)]
    ids = np.stack([np.resize(motifs[rng.randint(64)], MOE["S"] + 1)
                    for _ in range(MOE["B"])]).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


def _hybrid_moe_config():
    cfg = _moe_config(0.0)
    cfg.num_layers = HYBRID["MOE_LAYERS"]
    return cfg


def _without_key_bias(deltas):
    """Updates without the attention keys' bias: its true gradient is
    exactly zero (a row's softmax ignores a constant added to all its
    scores), so an Adam-family update of it is rounding noise that two
    summation orders draw differently. A fused qkv bias keeps its q and v
    thirds."""
    out = {}
    for n, d in deltas.items():
        if n.endswith("k_proj.bias"):
            continue
        if n.endswith("qkv.bias"):
            e = d.shape[0] // 3
            d = d.clone()
            d[e:2 * e] = 0
        out[n] = d
    return out


def _sliced_worst(m, ref, init, rule="update", base=None):
    """The worst parameter of a model whose parameters may be a rank's
    blocks (their `partition_spec` on the live mesh) against the whole
    model's updates `ref` (on the host), each cut to the rank's block,
    the keys' bias left out (`_without_key_bias`): as (its error over its
    tolerance, its name) by `rule`: "update", `_update_worst` (phase 7's
    rule on updates); "amp", `_grad_worst` at phase 6's AMP limits on
    updates; "adam", `_adam_worst` (for HYBRID["STEPS"] AdamW steps at
    HYBRID["LR"]); "bf16", `_bf16_worst` (an O1 update against world 1's
    O1 update `ref` and its fp32 update `base`)."""
    from paddle_tpu_torch.distributed.tensor_parallel import shard_tensor
    got, want, fp32 = {}, {}, {}
    for n, p in m.named_parameters():
        spec = getattr(p, "partition_spec", None)
        for whole, into in ((ref, want), (base, fp32)):
            if whole is None:
                continue
            d = whole[n]
            if spec is not None and tuple(d.shape) != tuple(p.shape):
                d = shard_tensor(d, spec)
            into[n] = d.to(p.device)
        got[n] = p.detach() - init[n]
    got, want = _without_key_bias(got), _without_key_bias(want)
    if rule == "bf16":
        return _bf16_worst(got, want, _without_key_bias(fp32))
    if rule == "amp":
        return list(_grad_worst(got, want, AMP_GRAD_SHARE["bfloat16"],
                                AMP_GRAD_FLOOR))
    if rule == "adam":
        return _adam_worst(got, want, init, ref)
    return list(_update_worst(got, want, init))


def _bf16_worst(got, want, fp32):
    """An O1 update `got` against world 1's O1 update `want`, both bf16
    gradients (SGD), each carrying its own bf16 rounding: [the worst over
    parameters of max |got - want| / (phase 6's AMP allowance + 2 x max
    |want - fp32|, the distance bf16 puts world 1's from its fp32 update
    `fp32`), that parameter, and phase 6's AMP rule read on world 1's
    bf16 update against fp32 and on this one's, for the record]."""
    share, fl = AMP_GRAD_SHARE["bfloat16"], AMP_GRAD_FLOOR
    floor = fl * max(g.abs().max().item() for g in fp32.values())
    worst = max((((got[n] - want[n]).double().abs().max().item()
                  / (share * want[n].abs().max().item() + floor
                     + 2 * (want[n] - fp32[n]).double().abs().max().item())),
                 n) for n in want)
    return [worst[0], worst[1], _grad_worst(want, fp32, share, fl)[0],
            _grad_worst(got, fp32, share, fl)[0]]


def _adam_worst(got, want, init, ref):
    """ERNIE's AdamW arms: [the worst error over (PARAM's tolerance + the
    most two AdamW runs can part, 2 x ADAM_STEP_MAX x lr a step), its
    parameter, the largest share of a parameter's elements outside PARAM
    (rtol 1e-4 / atol 1e-5 on the parameter), that parameter, and the
    share the same rule reads for a fault: the first column-parallel bias
    given another mp rank's slice of its reference update]. An AdamW step
    moves an element whose gradient is summation-order noise by up to lr
    either way, so an element may leave PARAM; only a few of a
    parameter's may."""
    from paddle_tpu_torch.distributed.tensor_parallel import _axis
    bound = 2 * ADAM_STEP_MAX * HYBRID["LR"] * HYBRID["STEPS"]

    def outside(n, g):
        tol = 1e-5 + 1e-4 * (init[n] + want[n]).double().abs()
        return (g - want[n]).double().abs(), tol
    worst, share = (0.0, ""), (0.0, "")
    for n in want:
        err, tol = outside(n, got[n])
        worst = max(worst, ((err / (tol + bound)).max().item(), n))
        share = max(share, ((err > tol).double().mean().item(), n))
    _, size, r = _axis()
    n = next(k for k in want if k.endswith("linear1.bias"))
    rows = want[n].shape[0]
    other = (r + 1) % size
    wrong = ref[n][other * rows:(other + 1) * rows].to(want[n].device)
    err, tol = outside(n, wrong)
    return [worst[0], worst[1], share[0], share[1],
            (err > tol).double().mean().item()]


def _hybrid_arms(wd):
    """Phase 15's hybrid arms (c)-(f) in a rank of the strategy arms'
    world (`_dist_rank_strategies`: gloo, both ranks on cuda:0): runs
    the arms below and writes its record to hybrid{r}.json. Each arm
    starts with the launch counts at 0 and reads
    them at its end; updates are compared by `_update_worst` (phase 7's
    rule) against (a)'s world-1 references, cut to the rank's blocks.
    - ernie_p0 / ernie_p1: ERNIE-base through models.tp_annotate at mp 2
      (6 of 12 heads a rank), ZeRO-1, HYBRID["STEPS"] steps at dropout 0
      and at DROPOUT (the keep masks keyed on the global head);
      ernie_o1: one SGD step under amp.auto_cast(level="O1");
    - moe: the MoE GPT at ep 2 (4 of 8 experts a rank), and the rank's
      expert bytes;
    - zero2_clip / zero3_clip: the packed LM at dp 2 under
      ClipGradByGlobalNorm at ZeRO-2 and ZeRO-3, and at ZeRO-3 the
      parameter bytes a rank holds and its allocated bytes between steps;
      lamb0 / lamb1: Lamb at ZeRO-0 and ZeRO-1 (and ZeRO-1's allocated
      bytes), lamb1 held to lamb0; dgc0 / dgc2: DGC at ZeRO-0 and ZeRO-2,
      the entries kept each step (ZeRO-2's summed over the ranks), dgc2
      held to dgc0 (both pairs at dp 2: the same reduced gradients, so
      Lamb's normalised update and DGC's top-k see the same bits);
    - pp_fp32 / pp_o1: GPipe at pp 2 of the strategies' GPT under the
      clip, in fp32 and under O1."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         GPTConfig, GPTForCausalLM,
                                         tp_annotate)
    from paddle_tpu_torch.ops import flash_ops as fo, paged_ops as po
    from paddle_tpu_torch.ops import splash_ops as so
    from paddle_tpu_torch.parallel import (compression, create_mesh,
                                           make_pipeline_train_step,
                                           make_sharded_train_step,
                                           pipeline_write_back, set_mesh,
                                           write_back)
    r = dist.get_rank()
    dev = denv.local_device()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def allocated():
        return torch.cuda.memory_allocated() if cuda else 0
    _, _, ws = _dist_launches(po, fo, so)
    ce = nn.CrossEntropyLoss()

    def lossf(o, lb):
        return ce(o, lb[0])
    steps = HYBRID["STEPS"]
    rec = {"rank": r}

    def arm(name, fn):
        set_mesh(None)
        _zero(ws)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out = fn()
        sync()
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                             else 0)
        out["launches"], out["launches_by_dtype"], _ = _dist_launches(
            po, fo, so)
        rec[name] = out
        dist.barrier()
        if cuda:
            torch.cuda.empty_cache()

    def train(step, st, ins, lbs, n, amp_level=None, after=None,
              batches=None, **kw):
        losses, walls = [], []
        for i in range(n):
            if batches is not None:
                ins, lbs = batches[i]
            sync()
            t0 = time.perf_counter()
            if amp_level:
                with amp.auto_cast(level=amp_level):
                    st, lv = step(st, ins, lbs, **kw)
            else:
                st, lv = step(st, ins, lbs, **kw)
            losses.append(float(lv))
            walls.append(time.perf_counter() - t0)
            if after is not None:
                after(st)
        return st, losses, walls

    def ref(name):
        return torch.load(os.path.join(wd, name), map_location="cpu",
                          mmap=True)

    # (c) ERNIE-base at mp 2
    for tag, p in (("p0", 0.0), ("p1", DROPOUT), ("o1", 0.0)):
        def ernie(tag=tag, p=p):
            create_mesh({"mp": 2})
            cfg, batches = _hybrid_ernie(np, p)
            m = ErnieForSequenceClassification(cfg, device=dev, seed=0)
            tp_annotate(m)
            init = {n: q.detach().clone() for n, q in m.named_parameters()}
            step, st = make_sharded_train_step(
                m, _hybrid_ernie_opt(optimizer, tag, m), lossf, zero_stage=1)
            n = 1 if tag == "o1" else steps
            st, losses, walls = train(step, st, None, None, n,
                                      "O1" if tag == "o1" else None,
                                      batches=batches, rng=7)
            out = dict(losses=losses, step_s=walls,
                       heads=m.ernie.encoder.layers[0].self_attn.local_heads,
                       worst=_sliced_worst(
                           m, ref(f"h_ernie_{tag}.pt"), init,
                           "adam" if tag != "o1" else "bf16",
                           ref("h_ernie_o1_fp32.pt") if tag == "o1"
                           else None))
            del m, init, step, st
            return out
        arm(f"ernie_{tag}", ernie)

    # (d) the MoE GPT at ep 2
    def moe():
        create_mesh({"ep": 2})
        x, y = _hybrid_moe_batch(np)
        m = GPTForCausalLM(_hybrid_moe_config(), device=dev, seed=0)
        init = {n: q.detach().clone() for n, q in m.named_parameters()}
        experts = sum(q.numel() * q.element_size()
                      for n, q in m.named_parameters()
                      if n.endswith(("w_up", "w_down")))
        step, st = make_sharded_train_step(
            m, optimizer.SGD(STRAT["LR"], parameters=m.parameters()), lossf)
        st, losses, walls = train(step, st, (x,), (y,), steps)
        out = dict(losses=losses, step_s=walls, expert_bytes=experts,
                   experts=m.gpt.blocks[0].mlp.w_up.shape[0],
                   worst=_sliced_worst(m, ref("h_moe.pt"), init))
        del m, init, step, st
        return out
    arm("moe", moe)

    # (e) the packed LM at dp 2
    z = np.load(os.path.join(wd, "batch.npz"))
    batch = [z[f"arr_{i}"] for i in range(5)]
    pins = [torch.as_tensor(x) for x in batch[:3]]
    plbs = [torch.as_tensor(x) for x in batch[3:5]]
    packed = torch.load(os.path.join(wd, "packed.pt"), map_location=dev)

    def packed_model():
        m = _packed_gpt(torch, sharded=True, dropout=0.0).to(dev)
        m.load_state_dict(packed)
        return m, {n: q.detach().clone() for n, q in m.named_parameters()}

    def ploss(o, lb):
        return _packed_loss(torch, o, lb)

    def packed_arm(opt_fn, stage, compare=None, keep=None, **kw):
        create_mesh({"dp": 2})
        m, init = packed_model()
        step, st = make_sharded_train_step(m, opt_fn(m), ploss,
                                           zero_stage=stage, **kw)
        held = []

        def after(st):
            sync()
            held.append((allocated(), sum(
                q.untyped_storage().nbytes() for q in m.parameters())
                + sum(v.numel() * v.element_size()
                      for v in st["params"].values()
                      if getattr(v, "_zero_gather", None) is not None)))
        st, losses, walls = train(step, st, pins, plbs, steps, after=after)
        write_back(m, st)
        deltas = {n: q.detach() - init[n] for n, q in m.named_parameters()}
        out = dict(losses=losses, step_s=walls, allocated=held[-1][0],
                   param_bytes=held[-1][1],
                   full_param_bytes=sum(q.numel() * q.element_size()
                                        for q in init.values()))
        if compare is not None:
            out["worst"] = list(_update_worst(
                _without_key_bias(deltas), _without_key_bias(compare),
                init))
        if keep is not None:
            keep.update(deltas)
        del m, init, step, st
        return out
    clip_ref = ref("h_packed_clip.pt")
    for stage in (2, 3):
        arm(f"zero{stage}_clip", lambda stage=stage: packed_arm(
            lambda m: optimizer.SGD(STRAT["LR"], parameters=m.parameters(),
                                    grad_clip=nn.ClipGradByGlobalNorm(
                                        HYBRID["CLIP"])),
            stage, {n: d.to(dev) for n, d in clip_ref.items()}))
    lamb0 = {}
    arm("lamb0", lambda: packed_arm(
        lambda m: optimizer.Lamb(HYBRID["LAMB_LR"], parameters=m.parameters()),
        0, keep=lamb0))
    arm("lamb1", lambda: packed_arm(
        lambda m: optimizer.Lamb(HYBRID["LAMB_LR"], parameters=m.parameters()),
        1, compare=lamb0))
    del lamb0
    real = compression.dgc_compress
    dgc0 = {}
    for stage in (0, 2):
        kept = []

        def spy(grads, state, *a, kept=kept, **k):
            out, new = real(grads, state, *a, **k)
            kept.append(sum(int((v != 0).sum()) for v in out.values()))
            return out, new

        def dgc(stage=stage, kept=kept, spy=spy):
            compression.dgc_compress = spy
            try:
                out = packed_arm(
                    lambda m: optimizer.SGD(STRAT["LR"],
                                            parameters=m.parameters()),
                    stage, compare=dgc0 if stage else None,
                    keep=None if stage else dgc0, dgc=True,
                    dgc_sparsity=HYBRID["DGC_SPARSITY"])
            finally:
                compression.dgc_compress = real
            if stage >= 2:   # a rank's blocks: the whole gradient's count
                t = torch.tensor(kept, dtype=torch.int64)
                dist.all_reduce(t)
                kept = t.tolist()
            out["kept"] = kept
            return out
        arm(f"dgc{stage}", dgc)
    del dgc0, packed

    # (f) GPipe at pp 2 under the clip, fp32 and O1
    with open(os.path.join(wd, "s_cfg.json")) as f:
        scfg = GPTConfig(**json.load(f))
    zs = np.load(os.path.join(wd, "s_batch.npz"))
    init_s = torch.load(os.path.join(wd, "s_init.pt"), map_location=dev)
    for tag, level in (("fp32", None), ("o1", "O1")):
        def pp(tag=tag, level=level):
            create_mesh({"dp": 1, "pp": 2})
            m = GPTForCausalLM(scfg, device=dev, seed=0)
            m.load_state_dict(init_s)
            step, st = make_pipeline_train_step(
                m, optimizer.SGD(STRAT["LR"], parameters=m.parameters(),
                                 grad_clip=nn.ClipGradByGlobalNorm(
                                     HYBRID["CLIP"])), lossf,
                n_micro=STRAT["N_MICRO"], recompute=False)
            st, losses, walls = train(step, st, (zs["x"],), (zs["y"],),
                                      steps, level)
            held = set(st["params"])
            d = ref(f"h_pp_{tag}.pt")
            got = {n: q.detach() - init_s[n] for n, q in m.named_parameters()
                   if n in held}
            want = {n: d[n].to(dev) for n in got}
            if level is None:
                worst = list(_update_worst(got, want, init_s))
            else:
                worst = list(_grad_worst(got, want,
                                         AMP_GRAD_SHARE["bfloat16"],
                                         AMP_GRAD_FLOOR))
            out = dict(losses=losses, step_s=walls, stage=step.stage,
                       held=len(held), worst=worst)
            del m, step, st, got, want
            return out
        arm(f"pp_{tag}", pp)
    with open(os.path.join(wd, f"hybrid{r}.json"), "w") as f:
        json.dump(rec, f)


def _elastic_hang_rank():
    """`chip_smoke.py --elastic-hang`, the script of phase 15 (b)'s
    elastic arm under `launch --elastic`: rank 1 sleeps before it joins
    (it never beats); rank 0 joins over gloo on the card, beating, and
    waits for it."""
    if os.environ.get("PADDLE_TRAINER_ID") == "1":
        time.sleep(300)
        return 0
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch import distributed as D
    D.init_parallel_env(backend="gloo")
    return 0


# phase store: GPT-2 small's widths (hidden 768, 12 heads, head dim 64,
# GPT-2's vocabulary) cut to LAYERS layers, seed-0 weights; 8 greedy
# requests whose prompts fill both prefill buckets, NEW new tokens each,
# on phase 5's slots and page size
STORE = dict(LAYERS=4, VOCAB=50257, BUCKETS=(64, 1024), SLOTS=8, PAGE=16,
             LENS=(20, 900, 40, 700, 60, 1000, 33, 530), NEW=16)
# phase store (d): the reference test's op (tests/test_static_and_
# extensions.py:80-97), its gradient symbol given [g, x] yields 2 g
CPP_DOUBLE_OP = r"""
extern "C" void double_op(const float** ins, const long long** shapes,
                          const int* ndims, int n_in, float* out,
                          const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i) out[i] = ins[0][i] * 2.0f;
}
extern "C" void double_op_grad(const float** ins, const long long** shapes,
                               const int* ndims, int n_in, float* out,
                               const long long* out_shape, int out_ndim) {
  long long total = 1;
  for (int i = 0; i < out_ndim; ++i) total *= out_shape[i];
  for (long long i = 0; i < total; ++i) out[i] = ins[0][i] * 2.0f;
}
"""


def _store_gpt(torch):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=STORE["VOCAB"], num_layers=STORE["LAYERS"])
    return GPTForCausalLM(cfg, device="cuda", seed=0).eval()


def _store_checksum(gpt):
    return float(sum(p.double().sum().item() for p in gpt.parameters()))


def _store_requests(np, vocab):
    rng = np.random.RandomState(7)
    return ([rng.randint(0, vocab, size=(n,)) for n in STORE["LENS"]],
            [STORE["NEW"]] * len(STORE["LENS"]))


def _store_engine_kw(prompts, new):
    page = STORE["PAGE"]
    return dict(max_slots=STORE["SLOTS"], page_size=page,
                num_pages=1 + sum(-(-(len(p) + n) // page)
                                  for p, n in zip(prompts, new)),
                prefill_buckets=STORE["BUCKETS"], max_new_tokens=STORE["NEW"],
                request_timeout_ms=0)


def _store_decode_step(torch, eng):
    """One decode step of an idle engine (every slot parked on the
    scratch page), called from this thread: whether the pools kept their
    storage, whether the step's K write landed in place (the scratch
    page, zeroed first, holds it after), and the peak allocated bytes it
    added above what was allocated before it."""
    from paddle_tpu_torch.serving.kv_cache import TRASH_PAGE
    with torch.inference_mode():
        pools = eng._pools()
        ptrs = [p.data_ptr() for p in pools]
        pools[0][:, :, TRASH_PAGE].zero_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng._decode_call(*eng._step_arrays())
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        return dict(
            same_ptrs=[p.data_ptr() for p in eng._pools()] == ptrs,
            wrote_in_place=bool(pools[0][:, :, TRASH_PAGE].abs().sum() > 0),
            rise=int(rise), pool_bytes=int(eng._cache.hbm_bytes()))


def _store_worker(mode, wd):
    """`chip_smoke.py --store-worker MODE --store-wd WD`, one fresh
    process of phase store: it serves the 8 requests with the program
    store under WD/store. Mode "a" (process A) also makes nvcc raise: its
    build cache comes from FLAGS_xla_compilation_cache_dir, which the
    parent set to a seeded directory. Writes WD/report.json."""
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops import _build, flash_ops, paged_ops
    from paddle_tpu_torch.serving import GenerationEngine
    nvcc = []

    def no_nvcc():
        nvcc.append(1)
        raise RuntimeError("phase store (a): nvcc must not run")
    if mode == "a":
        _build._nvcc = no_nvcc
    gpt = _store_gpt(torch)
    prompts, new = _store_requests(np, gpt.gpt.config.vocab_size)
    t0 = time.perf_counter()
    eng = GenerationEngine(gpt, device="cuda", name=f"store_{mode}",
                           program_store=os.path.join(wd, "store"),
                           **_store_engine_kw(prompts, new))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    paged_ops.paged_attention.launches = 0
    flash_ops.flash_attention_fwd.launches = 0
    outs = [f.result(600).tolist() for f in
            [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]]
    k1 = paged_ops.paged_attention.launches
    k2 = flash_ops.flash_attention_fwd.launches
    st = eng.stats()
    step = _store_decode_step(torch, eng)
    eng.shutdown()
    ps = st["program_store"]
    rep = dict(outputs=outs, warm_ms=warm_ms, k1=k1, k2=k2,
               steps=st["steps"], compiles=st["compiles"],
               loaded=st["loaded"], programs=st["programs"],
               key=ps["key"], key_dir=ps["dir"], step=step,
               weights=_store_checksum(gpt), nvcc=len(nvcc),
               libs=sorted(lib._name for lib in _build._libs.values()),
               cache_dir=pdevice.compilation_cache_dir(),
               pack_load_ms=monitor.histogram("pack_load_ms").snapshot(),
               entries=eng._store.entries())
    with open(os.path.join(wd, "report.json"), "w") as f:
        json.dump(rep, f)
    return 0



# phase 16: PaddleRec's CTR-DNN (`models/rank/dnn/config.yaml`: 26 sparse
# slots hashed into 1,000,001 ids, embedding dim 9 sum-pooled a slot, 13
# dense features, fully connected 512-256-128-32 with ReLU, 2 classes,
# Adam 1e-3 asynchronous, batch 512) on Criteo-shaped seeded data; (a)'s
# sync steps at SGD 0.05; (c)'s trainers cycle a pool of batches; (e) is
# bench.py's bench_host_embedding configuration
PS = dict(SLOTS=26, DENSE=13, VOCAB=1_000_001, DIM=9,
          HIDDEN=(512, 256, 128, 32), B=512, LR=1e-3, SYNC_LR=0.05,
          SYNC_STEPS=20, BATCHES=64, POOL=6, TRAINER_STEPS=18, GEO_K=4,
          TIMEOUT=240,
          BENCH=dict(DIM=64, IDS=8192, VOCAB=100_000, WARM=3, ITERS=15))
PS_DEV = "cuda"   # phase 16's device (a CPU rehearsal sets "cpu")
_CTR = {}


def _ctr_dnn():
    """The port's CTR-DNN class: forward(emb_flat [B x 26, 9], dense [B,
    13], label) -> logits [B, 2]. Each slot holds one id (Criteo), so a
    slot's sum pool is its row."""
    if "cls" not in _CTR:
        import torch
        from paddle_tpu_torch import nn

        class CtrDnn(nn.Layer):
            def __init__(self):
                super().__init__()
                widths = (PS["SLOTS"] * PS["DIM"] + PS["DENSE"],) \
                    + PS["HIDDEN"]
                self.fcs = nn.LayerList([nn.Linear(a, b) for a, b in
                                         zip(widths[:-1], widths[1:])])
                self.out = nn.Linear(PS["HIDDEN"][-1], 2)

            def forward(self, emb_flat, dense, label):
                e = emb_flat.reshape(dense.shape[0], PS["SLOTS"], -1,
                                     PS["DIM"]).sum(2)
                x = torch.cat([e.reshape(e.shape[0], -1), dense], 1)
                for fc in self.fcs:
                    x = torch.relu(fc(x))
                return self.out(x)
        _CTR["cls"] = CtrDnn
    return _CTR["cls"]


def _ctr_dense_size():
    widths = (PS["SLOTS"] * PS["DIM"] + PS["DENSE"],) + PS["HIDDEN"] + (2,)
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def _ctr_loss(out, data):
    import torch.nn.functional as F
    return F.cross_entropy(out.float(), data[1])


def _ctr_batches(np, seed, n, B):
    """n Criteo-shaped batches: ids [B, 26] (a Zipf rank within each slot's
    cardinality, hashed with the slot into 1,000,001), dense [B, 13]
    float32 in [0, 1) (PaddleRec min-max scales them), label [B] int64
    drawn from a planted logistic function of slots 0-3 and the dense
    features, so the loss can fall."""
    rs = np.random.RandomState(seed)
    card = np.random.RandomState(1234).randint(10, 50_000, PS["SLOTS"])
    v = np.random.RandomState(4321).standard_normal(PS["DENSE"]) * 0.8
    out = []
    for _ in range(n):
        rank = (rs.zipf(1.3, size=(B, PS["SLOTS"])) - 1) % card
        slot = np.arange(PS["SLOTS"])
        ids = ((rank * 2654435761 + slot * 1_000_003 + 17)
               % PS["VOCAB"]).astype(np.int64)
        dense = rs.rand(B, PS["DENSE"]).astype(np.float32)
        w = ((rank[:, :4] * 40503 + slot[:4]) % 997) / 997.0 - 0.5
        z = 3.0 * w.sum(1) + (dense - 0.5) @ v
        label = (rs.rand(B) < 1.0 / (1.0 + np.exp(-z))).astype(np.int64)
        out.append((ids, dense, label))
    return out


def _ctr_slots():
    """InMemoryDataset's use_var: label, the dense slot, C1..C26."""
    return ([("label", "int64"), ("dense", "float32")]
            + [(f"C{i + 1}", "int64") for i in range(PS["SLOTS"])])


def _ctr_slot_files(np, wd, n_batches, B):
    """n_batches x B seeded records in the slot text format, written
    through the port's MultiSlotDataGenerator into two files."""
    from paddle_tpu_torch.distributed.fleet import MultiSlotDataGenerator
    files = []
    for part in range(2):
        batches = _ctr_batches(np, 40 + part, n_batches // 2, B)
        recs = [(ids[i], dense[i], label[i]) for ids, dense, label
                in batches for i in range(B)]

        class Gen(MultiSlotDataGenerator):
            def generate_sample(self, line):
                ids, dense, label = recs[int(line)]

                def it():
                    yield ([("label", [int(label)]),
                            ("dense", [float(x) for x in dense])]
                           + [(f"C{s + 1}", [int(ids[s])])
                              for s in range(PS["SLOTS"])])
                return it
        idx = os.path.join(wd, f"part{part}.idx")
        with open(idx, "w") as f:
            f.write("".join(f"{i}\n" for i in range(len(recs))))
        out = os.path.join(wd, f"part{part}.txt")
        Gen().run_from_files([idx], out)
        files.append(out)
    return files


def _ctr_from_slots(np, batch):
    """InMemoryDataset's padded per-slot batch -> (ids [B, 26], dense,
    label [B])."""
    return (np.concatenate(batch[2:], 1), batch[1], batch[0].reshape(-1))


def _auc(np, scores, labels):
    """Area under the ROC curve by ranks (ties averaged)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    s = scores[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2 + 1
        i = j + 1
    pos = labels == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _bench_head(dim):
    """bench_host_embedding's head: Linear(dim, 1) over each row."""
    from paddle_tpu_torch import nn

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(dim, 1)

        def forward(self, emb_flat, labels):
            return self.fc(emb_flat)
    return Head()


def _ps_server_proc(q, arm, idx, cfgs, n_workers, env):
    """A server of phase 16, started by _Children: PsServer on
    127.0.0.1:0 (or, with `env`, fleet.init with a PS role then
    init_server / run_server); reports its port, serves until a client
    stops it, then reports its sparse tables' sizes."""
    if env:
        os.environ.update(env)
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.ps import the_one_ps
        fleet.init(is_collective=False)
        assert fleet.is_server()
        rt = the_one_ps()
        for c in cfgs:
            rt.register_sparse_table(c["dim"], rule=c["rule"], lr=c["lr"])
        fleet.init_server()
        server = rt.server
        q.put((arm, idx, "port", server.port))
        fleet.run_server()
    else:
        from paddle_tpu_torch.distributed.ps import PsServer, TableConfig
        server = PsServer("127.0.0.1:0", [TableConfig(**c) for c in cfgs],
                          n_workers).start()
        q.put((arm, idx, "port", server.port))
        server._thread.join()
    from paddle_tpu_torch.distributed.ps import SparseTable
    q.put((arm, idx, "sizes", {tid: len(t) for tid, t in
                               server._tables.items()
                               if isinstance(t, SparseTable)}))


def _ps_trainer_proc(wd, rank, eps_async, eps_geo, device):
    """A trainer of phase 16 (c), started by _Children: builds the CTR-DNN
    on `device`, waits for the parent's go, then trains
    PS["TRAINER_STEPS"] steps (a pool of its own seeded batches, cycled)
    through DownpourWorker with async push against `eps_async`, then the
    same against `eps_geo` with the head synced by GeoCommunicator every
    k steps; writes its losses, step ms and the distinct ids it pulled."""
    import numpy as np
    import torch
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed.fleet import (DownpourWorker,
                                                    FleetWrapper)
    from paddle_tpu_torch.distributed.ps import GeoCommunicator, PsClient
    from paddle_tpu_torch.framework import random as prandom
    from torch.nn.utils import parameters_to_vector, vector_to_parameters
    torch.backends.cuda.matmul.allow_tf32 = False
    pool = _ctr_batches(np, 200 + rank, PS["POOL"], PS["B"])
    data = [pool[i % len(pool)] for i in range(PS["TRAINER_STEPS"])]

    def build():
        prandom.seed(7)
        model = _ctr_dnn()().to(device)
        return model, popt.Adam(PS["LR"], parameters=model.parameters())
    build()
    go = os.path.join(wd, "go")
    deadline = time.monotonic() + PS["TIMEOUT"]
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("no go from the parent")
        time.sleep(0.05)
    rec = {"device": device}
    for mode, eps in (("async", eps_async), ("geo", eps_geo)):
        fw = FleetWrapper()
        fw.init_worker(eps, sparse_dims={0: PS["DIM"]})
        model, opt = build()
        worker = DownpourWorker(fw, 0, PS["DIM"], model, opt, _ctr_loss,
                                async_push=True, device=device)
        params = list(model.parameters())
        if mode == "geo":
            client = PsClient(eps)
            geo = GeoCommunicator(client, k_steps=PS["GEO_K"])
            geo.register_dense(1, parameters_to_vector(params).detach()
                               .cpu().numpy())
            fw.barrier()   # both trainers' initial values are in
        losses, syncs = [], 0
        t0 = time.perf_counter()
        for b in data:
            losses.append(worker.train_one_batch(*b))
            if mode == "geo":
                local = parameters_to_vector(params).detach().cpu().numpy()
                fresh = geo.maybe_sync_dense(1, local)
                if fresh is not local:
                    syncs += 1
                    with torch.no_grad():
                        vector_to_parameters(torch.from_numpy(fresh).to(
                            device), params)
        fw.client_flush()
        wall = time.perf_counter() - t0
        fw.barrier()   # both trainers' pushes are in
        ids = np.unique(np.concatenate([b[0].reshape(-1) for b in data]))
        np.save(os.path.join(wd, f"trainer{rank}_{mode}_ids.npy"), ids)
        rec[mode] = dict(losses=losses, step_ms=wall / len(data) * 1e3,
                         syncs=syncs)
        fw._q.put(None)
        fw._client.close()
        if mode == "geo":
            client.close()
    with open(os.path.join(wd, f"trainer{rank}.json"), "w") as f:
        json.dump(rec, f)


class _Children:
    """Phase 16's server and trainer processes (spawned, never forked):
    ports and table sizes come back on one queue; every wait has a time
    limit, and `stop()` kills whatever is still alive."""

    def __init__(self):
        import multiprocessing as mp
        self.ctx = mp.get_context("spawn")
        self.q = self.ctx.Queue()
        self.servers = {}
        self.ports = {}
        self.sizes = {}
        self.trainer_procs = []

    def server(self, arm, idx, cfgs, n_workers, env):
        p = self.ctx.Process(target=_ps_server_proc, daemon=True,
                             args=(self.q, arm, idx, cfgs, n_workers, env))
        p.start()
        self.servers[(arm, idx)] = p

    def _read(self, timeout):
        import queue
        try:
            arm, idx, kind, val = self.q.get(timeout=timeout)
        except queue.Empty:
            return
        (self.ports if kind == "port" else self.sizes)[(arm, idx)] = val

    def endpoints(self, arms, timeout=120):
        deadline = time.monotonic() + timeout
        keys = [(a, i) for a in arms for i in range(2)]
        while any(k not in self.ports for k in keys):
            dead = [k for k in keys if k not in self.ports
                    and self.servers[k].exitcode is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"servers {dead or 'late'}: no port")
            self._read(0.2)
        return {a: [f"127.0.0.1:{self.ports[(a, i)]}" for i in range(2)]
                for a in arms}

    def trainers(self, wd, eps_async, eps_geo):
        for r in range(2):
            p = self.ctx.Process(target=_ps_trainer_proc, daemon=True,
                                 args=(wd, r, eps_async, eps_geo, PS_DEV))
            p.start()
            self.trainer_procs.append(p)

    def wait_trainers(self, timeout):
        deadline = time.monotonic() + timeout
        for p in self.trainer_procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode is None:
                raise TimeoutError(f"trainer {p.pid} still running after "
                                   f"{timeout} s")
            if p.exitcode != 0:
                raise RuntimeError(f"trainer {p.pid} exited {p.exitcode}")

    def wait_arm(self, arm, timeout, sizes=False):
        """Join the arm's two servers; the count still alive, or (sizes)
        their sparse table 0's rows."""
        deadline = time.monotonic() + timeout
        procs = [self.servers[(arm, i)] for i in range(2)]
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        while any((arm, i) not in self.sizes for i in range(2)) and \
                time.monotonic() < deadline:
            self._read(0.2)
        if sizes:
            return [self.sizes[(arm, i)][0] for i in range(2)]
        return sum(p.exitcode is None for p in procs)

    def stop(self):
        procs = list(self.servers.values()) + self.trainer_procs
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(5)
            if p.exitcode is None:
                p.kill()
                p.join()


def _moe_config(dropout):
    """Phase 11's MoE GPT: GPT-2 small's widths (hidden 768, 12 layers
    of 12 heads, intermediate 3072, 1024 positions) with MOE["E"]
    experts in every block."""
    from paddle_tpu_torch.models import GPTConfig
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072, max_position_embeddings=1024,
                     use_moe=True, num_experts=MOE["E"], dropout=dropout)


def _detect_batch(np, B, side, classes, slots, max_gt, seed):
    """Phase 9b's batch from one numpy seed: standard-normal images
    [B, 3, side, side], and 1-max_gt gt boxes an image (cx, cy, w, h
    normalised, w and h in [0.02, 0.6), inside the image) with labels in
    0..classes-1, in `slots` rows padded with zeros (float32 / int32)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, 3, side, side)).astype(np.float32)
    gt = np.zeros((B, slots, 4), np.float32)
    lab = np.zeros((B, slots), np.int32)
    for b in range(B):
        n = rng.randint(1, max_gt + 1)
        wh = rng.uniform(0.02, 0.6, (n, 2))
        gt[b, :n, :2] = rng.uniform(0, 1, (n, 2)) * (1 - wh) + wh / 2
        gt[b, :n, 2:] = wh
        lab[b, :n] = rng.randint(0, classes, n)
    return x, gt, lab


# the extra_ops names phase 12 (a) holds (nn.functional's re-exports of
# the slice before the detection slice)
_S2S_EXTRA = ("pixel_unshuffle", "channel_shuffle", "max_unpool2d",
              "affine_grid", "gather_tree")


def _det_inputs(np, paddle, device):
    """Phase 11 (a)'s inputs of the extra_ops and vision_ops families,
    made from one numpy seed, on `device` (the same values as the CPU
    parity tests' shapes)."""
    rng = np.random.RandomState(0)

    def f(*shape, lo=None, hi=None):
        if lo is None:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def boxes(n, side=64.0):
        wh = rng.uniform(4.0, 24.0, (n, 2))
        xy = rng.uniform(0, side - 24.0, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    def clustered(n):
        c = rng.uniform(10, 54, (4, 2))[rng.randint(0, 4, n)] + \
            rng.normal(0, 3, (n, 2))
        wh = rng.uniform(6, 14, (n, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(
            np.float32)

    def unique(*shape):
        k = int(np.prod(shape))
        return ((rng.permutation(k) + 0.5) / k).reshape(shape).astype(
            np.float32)
    a = dict(X4=f(4, 8, 3, 3), X63=f(6, 3), X23=f(2, 3, 4, 4),
             X24=f(2, 4, 3, 3), C4=f(4), B4=f(4), X253=f(2, 5, 3),
             W33=f(3, 3), X37=f(3, 7), Y33=f(3, 3), POS45=f(4, 5, lo=0, hi=3),
             X42=f(4, 2), X43=f(4, 3), N3=np.full(3, 10.0, np.float32),
             S3=f(3), SQ3=f(3, lo=20, hi=30), X45=f(4, 5), X23s=f(2, 3),
             P1=f(3, 5), P2=f(3, 5), P3=f(3, 5), L41=f(4, 1), R41=f(4, 1),
             Y41=(f(4, 1, lo=0, hi=1) > 0.5).astype(np.float32),
             C33=f(3, 3), X2255=f(2, 2, 5, 5), EM=f(2, 5, 3), TR=f(5, 3),
             FEAT=f(2, 3, 8, 8), F8=f(2, 8, 8, 8), A1=f(1, 3, 5, 5),
             B1=f(1, 3, 5, 5), DX=f(1, 2, 5, 5), DOFF=f(1, 18, 5, 5),
             DW=f(3, 2, 3, 3), DM=f(1, 9, 5, 5, lo=0, hi=1),
             BX=f(2, 3, 4), BW=f(2, 4, 5), BB=f(2, 5),
             LG=f(4, 7), NW=f(7, 3), NB=f(7), TX=f(2, 5, 3),
             TF=f(3, 4, 3), BS=f(1, 2, 4, 4), G=f(1, 4, 4, lo=0, hi=1),
             GRID=f(1, 9, 2, 3, 3), RX=f(4, 3), RP=f(27, 2),
             VFLAT=f(28), VW=f(2, 1, 3, 3), INS=np.arange(
                 8, dtype=np.float32).reshape(4, 2),
             YOLO=f(2, 27, 4, 4), HEAD8=f(2, 24, 8, 8), HEAD4=f(2, 24, 4, 4),
             GS=f(2, 4, lo=0.5, hi=1.0), PRIOR=boxes(6),
             PVAR=f(6, 4, lo=0.1, hi=0.3), DELTA=f(3, 6, 4), TGT=boxes(6),
             BX1=boxes(5), BX2=boxes(3), NMSB=clustered(40),
             NMSS=unique(40), MB=np.stack([clustered(40), clustered(40)]),
             MS=unique(2, 4, 40), RPNS=unique(2, 3, 4, 4),
             RPND=f(2, 12, 4, 4) * np.float32(0.5),
             FPN=np.concatenate([boxes(30, 600.0), boxes(30, 600.0)
                                 * np.float32(0.3)]))
    a["PROB"] = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    a["SEG"] = np.array([0, 0, 1, 3, 3, 3], np.int32)
    a["SEGI"] = rng.randint(0, 10, (6, 3)).astype(np.int32)
    a["ROIS"] = np.array([[1.0, 2.0, 9.0, 13.0], [0.0, 0.0, 15.0, 15.0],
                          [4.5, 3.0, 7.5, 11.0], [2.0, 6.0, 14.0, 9.0]],
                         np.float32)
    a["ROIS_NUM"] = np.array([3, 1], np.int32)
    a["LAB41"] = rng.randint(0, 5, (4, 1)).astype(np.int32)
    a["LAB3"] = np.array([[0], [2], [0], [1]], np.int32)
    a["CEL"] = np.array([[1], [4], [-100], [0]], np.int32)
    a["CRFY"] = rng.randint(0, 3, (2, 5)).astype(np.int32)
    a["CRFL"] = np.array([5, 3], np.int32)
    a["EDGES"] = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [0, 0]],
                           [[2, 0], [2, 1], [0, 3], [0, 0], [0, 0]]],
                          np.int32)
    a["ROFF"] = np.array([[1, 1, 0, 2, 1, 0, 0], [2, 1, 0, 3, 2, 0, 0],
                          [0, 1, 1, 0, 0, 0, 0], [3, 3, 3, 2, 1, 1, 2]],
                         np.int32)
    a["LAB47"] = rng.randint(0, 7, (4, 1)).astype(np.int32)
    a["TAGS"] = np.array([1, 2, 3, 2, 9, 4], np.int32)
    a["WANT"] = np.array([2], np.int32)
    a["IMG"] = np.array([[64, 48], [32, 64]], np.int32)
    a["IMG64"] = np.array([[64, 64], [60, 50]], np.int32)
    a["GT"] = np.array([[[0.05, 0.05, 10 / 64, 13 / 64],
                         [0.6, 0.4, 0.3, 0.45], [0.0, 0.0, 0.0, 0.0],
                         [0.3, 0.8, 0.2, 0.1]],
                        [[0.5, 0.5, 0.9, 0.95], [0.2, 0.7, 0.25, 0.4],
                         [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]],
                       np.float32)
    a["GTL"] = np.array([[1, 2, 0, 0], [0, 2, 0, 0]], np.int32)
    a["CAT"] = rng.randint(0, 3, 40).astype(np.int32)
    a["ROWS"] = np.array([4, 6], np.int32)
    a["COLS"] = np.array([4, 2], np.int32)
    d = {k: paddle.to_tensor(v, place=device) for k, v in a.items()}
    d["np"] = a
    return d


def _api_extra_cases():
    """Phase 11 (a)'s extra_ops family: every name of extra_ops.__all__
    but phase 12's (_S2S_EXTRA), on _det_inputs. The ops that draw take a
    seed, so that the card and the CPU draw alike (the draw is made on
    the host)."""
    def lod(P, d, key, offs):
        return P.legacy.LoDTensor(d[key], [list(offs)])

    def with_lod(P, t):
        import numpy as np
        return [t, P.to_tensor(np.asarray(t.lod()[0], np.int32))]
    return {
        "temporal_shift": lambda P, d: P.temporal_shift(d["X4"], 2),
        "segment_sum": lambda P, d: P.incubate.segment_sum(d["X63"],
                                                           d["SEG"]),
        "segment_mean": lambda P, d: P.incubate.segment_mean(d["X63"],
                                                             d["SEG"]),
        "segment_max": lambda P, d: P.incubate.segment_max(d["X63"],
                                                           d["SEG"]),
        "segment_min": lambda P, d: P.incubate.segment_min(
            d["X63"], d["SEG"], num_segments=5),
        "segment_sum#int": lambda P, d: P.incubate.segment_sum(
            d["SEGI"], d["SEG"], num_segments=5),
        "affine_channel": lambda P, d: P.affine_channel(d["X24"], d["C4"],
                                                        d["B4"]),
        "row_conv": lambda P, d: P.row_conv(d["X253"], d["W33"]),
        "conv_shift": lambda P, d: P.conv_shift(d["X37"], d["Y33"]),
        "cvm": lambda P, d: P.cvm(d["POS45"], d["X42"]),
        "cvm#strip": lambda P, d: P.cvm(d["POS45"], d["X42"],
                                        use_cvm=False),
        "data_norm": lambda P, d: P.data_norm(d["X43"], d["N3"], d["S3"],
                                              d["SQ3"]),
        "space_to_depth": lambda P, d: P.space_to_depth(d["X23"], 2),
        "pad_constant_like": lambda P, d: P.pad_constant_like(
            d["X45"], d["X23s"], pad_value=1.5),
        "partial_concat": lambda P, d: P.partial_concat(
            [d["P1"], d["P2"]], start_index=1, length=2),
        "partial_sum": lambda P, d: P.partial_sum(
            [d["P1"], d["P2"], d["P3"]], start_index=2),
        "l1_norm": lambda P, d: P.l1_norm(d["X43"]),
        "squared_l2_norm": lambda P, d: P.squared_l2_norm(d["X43"]),
        "rank_loss": lambda P, d: P.rank_loss(d["Y41"], d["L41"],
                                              d["R41"]),
        "bpr_loss": lambda P, d: P.bpr_loss(d["X45"], d["LAB41"]),
        "center_loss": lambda P, d: P.center_loss(d["X43"], d["LAB3"],
                                                  d["C33"], alpha=0.2),
        "hinge_loss": lambda P, d: P.hinge_loss(d["L41"], d["Y41"]),
        "im2sequence": lambda P, d: P.im2sequence(
            d["X2255"], filter_size=3, stride=2, padding=1),
        "linear_chain_crf": lambda P, d: P.linear_chain_crf(
            d["EM"], d["TR"], d["CRFY"], d["CRFL"]),
        "roi_pool": lambda P, d: P.ops.extra_ops.roi_pool(
            d["FEAT"], d["ROIS"], d["ROIS_NUM"], 2, spatial_scale=0.5),
        "fsp": lambda P, d: P.fsp(d["X23"], d["X23"][:, :2]),
        "cross_entropy2": lambda P, d: P.cross_entropy2(d["PROB"],
                                                        d["CEL"]),
        "psroi_pool": lambda P, d: P.psroi_pool(
            d["F8"], d["ROIS"], d["ROIS_NUM"], 2, 0.5, 2, 2),
        "prroi_pool": lambda P, d: P.prroi_pool(
            d["FEAT"], d["ROIS"], d["ROIS_NUM"], 2, spatial_scale=0.5),
        "correlation": lambda P, d: P.correlation(d["A1"], d["B1"], 1, 1,
                                                  1),
        "nce": lambda P, d: P.nce(d["RX"], d["LAB47"], 7,
                                  nid_weight=d["NW"], bias=d["NB"],
                                  num_neg_samples=4, seed=1),
        "deformable_conv": lambda P, d: P.deformable_conv(
            d["DX"], d["DOFF"], d["DW"], mask=d["DM"], padding=1),
        "batch_fc": lambda P, d: P.batch_fc(d["BX"], d["BW"], d["BB"]),
        "sample_logits": lambda P, d: P.sample_logits(d["LG"], d["LAB47"],
                                                      5, seed=2),
        "shuffle_batch": lambda P, d: P.shuffle_batch(d["X63"], seed=3),
        "filter_by_instag": lambda P, d: P.filter_by_instag(
            d["INS"], lod(P, d, "TAGS", (0, 2, 3, 5, 6)), d["WANT"]),
        "var_conv_2d": lambda P, d: with_lod(P, P.var_conv_2d(
            lod(P, d, "VFLAT", (0, 16, 28)), d["ROWS"], d["COLS"], 1, 2, 3,
            w=d["VW"])),
        "tree_conv": lambda P, d: P.tree_conv(d["TX"], d["EDGES"], d["TF"]),
        "bilateral_slice": lambda P, d: P.bilateral_slice(d["BS"], d["G"],
                                                          d["GRID"]),
        "rank_attention": lambda P, d: P.rank_attention(d["RX"], d["ROFF"],
                                                        d["RP"]),
    }


def _api_vision_cases():
    """Phase 11 (a)'s vision_ops family: the 12 functions of vision.ops
    on _det_inputs; the NMS family index-exact (its IoU is float32 op for
    op on both devices, and its scores have no ties)."""
    def V(P):
        return P.vision.ops

    def anchors(P, d):
        return V(P).anchor_generator(d["RPNS"], [16.0], [0.5, 1.0, 2.0],
                                     stride=[16.0, 16.0])
    return {
        "box_iou": lambda P, d: V(P).box_iou(d["BX1"], d["BX2"]),
        "nms": lambda P, d: V(P).nms(d["NMSB"], 0.5, scores=d["NMSS"],
                                     category_idxs=d["CAT"], top_k=12),
        "nms#eta": lambda P, d: V(P).nms(d["NMSB"], 0.7, scores=d["NMSS"],
                                         offset=1.0, eta=0.9),
        "roi_align": lambda P, d: V(P).roi_align(
            d["FEAT"], d["ROIS"], d["ROIS_NUM"], 2, spatial_scale=0.5),
        "roi_pool": lambda P, d: V(P).roi_pool(
            d["FEAT"], d["ROIS"], d["ROIS_NUM"], (3, 2), spatial_scale=0.5),
        "yolo_box": lambda P, d: V(P).yolo_box(
            d["YOLO"], d["IMG"], [10, 13, 16, 30, 33, 23], 4,
            conf_thresh=0.3, downsample_ratio=16),
        "box_coder": lambda P, d: V(P).box_coder(
            d["PRIOR"], d["PVAR"], d["DELTA"],
            code_type="decode_center_size"),
        "box_coder#encode": lambda P, d: V(P).box_coder(
            d["PRIOR"], d["PVAR"], d["TGT"]),
        "distribute_fpn_proposals": lambda P, d:
            V(P).distribute_fpn_proposals(d["FPN"], 2, 5, 4, 224),
        "yolov3_loss": lambda P, d: V(P).yolov3_loss(
            d["HEAD8"], d["GT"], d["GTL"], YOLO_ANCHORS, [0, 1, 2], 3, 0.7,
            8),
        "yolov3_loss#score": lambda P, d: V(P).yolov3_loss(
            d["HEAD4"], d["GT"], d["GTL"], YOLO_ANCHORS, [3, 4, 5], 3, 0.7,
            16, gt_score=d["GS"], use_label_smooth=False),
        "anchor_generator": anchors,
        "prior_box": lambda P, d: V(P).prior_box(
            d["FEAT"], d["X2255"], [8.0, 16.0], max_sizes=[16.0, 24.0],
            aspect_ratios=[2.0, 3.0], clip=True),
        "generate_proposals": lambda P, d: V(P).generate_proposals(
            d["RPNS"], d["RPND"], d["IMG64"], *anchors(P, d),
            pre_nms_top_n=30, post_nms_top_n=10, nms_thresh=0.6,
            min_size=2.0),
        "multiclass_nms": lambda P, d: V(P).multiclass_nms(
            d["MB"], d["MS"], score_threshold=0.3, nms_top_k=15,
            keep_top_k=20, nms_threshold=0.4),
        "multiclass_nms#eta": lambda P, d: V(P).multiclass_nms(
            d["MB"], d["MS"], score_threshold=0.1, nms_top_k=-1,
            keep_top_k=-1, nms_threshold=0.6, normalized=False,
            nms_eta=0.8, background_label=-1),
    }


# COCO's anchors, as vision.models.yolov3 uses them
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                116, 90, 156, 198, 373, 326]


def _api_tols():
    """{(family, case): limit} of the phase 11 (a) cases that are not
    exact."""
    fam = {k: API_TOL[k] for k in ("reduction", "linalg", "legacy",
                                   "extra_ops", "vision_ops")}
    one = {("creation", n): API_TOL["formula"]
           for n in ("linspace", "logspace", "vander", "arange#float")}
    one.update({("manipulation", n): API_TOL["product"]
                for n in ("tensordot", "tensordot#pairs")})
    return fam, one


def _api_inputs(np, paddle, device):
    """Phase 11 (a)'s inputs, made from one numpy seed, on `device`."""
    rng = np.random.RandomState(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    a = dict(X=f(3, 4), Y=f(3, 4) + 0.1, COL=f(3, 1, 4), X3=f(2, 3, 4),
             V=f(4), V2=f(3), SQ=f(4, 4) + 4 * np.eye(4, dtype=np.float32),
             V3=f(5, 3), W3=f(5, 3), B42=f(4, 2), TALL=f(6, 3),
             TALLB=f(6, 2), HIST=f(50), U=f(3, 4) * 0.5)
    a["POS"] = np.abs(a["X"]) + 0.2
    a["AWAY"] = np.sign(a["Y"] + 1e-3) * (np.abs(a["Y"]) + 0.5)
    a["SPD"] = a["SQ"] @ a["SQ"].T
    a["TRI"] = np.triu(a["SQ"])
    a["I"] = rng.randint(-6, 7, (3, 4)).astype(np.int32)
    a["I2"] = rng.randint(1, 7, (3, 4)).astype(np.int32)
    a["B"], a["B2"] = a["X"] > 0, a["Y"] > 0.3
    a["NANS"] = a["X3"].copy()
    a["NANS"][0, 1, 2] = np.nan
    a["IDX"] = np.array([2, 0], np.int32)
    a["IDX2"] = np.array([[1], [0], [3]], np.int32)
    a["ND"] = np.array([[0, 1], [1, 2]], np.int32)
    a["MODES"] = np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.int32)
    a["SEQ"] = np.array([-1.0, 0.0, 0.5, 2.0, 3.0], np.float32)
    a["BINS"] = rng.randint(0, 6, 20).astype(np.int32)
    a["PROB"] = rng.uniform(0.05, 0.95, (4, 6)).astype(np.float32)
    d = {k: paddle.to_tensor(v, place=device) for k, v in a.items()}
    d["np"] = a
    return d


def _api_cases():
    """Phase 11 (a): {family: {case: fn(P, d)}} over every name of each
    family's `__all__` (the random ops: _api_random_cases). A case "op"
    or "op#variant" calls op; linalg cases return what is unique of a
    factorization (reconstructions, values, residuals)."""
    creation = {
        "to_tensor": lambda P, d: P.to_tensor(d["np"]["X"]),
        "to_tensor#ints": lambda P, d: P.to_tensor([1, 2, 3]),
        "ones": lambda P, d: P.ones([2, 3]),
        "zeros": lambda P, d: P.zeros([4], dtype="int32"),
        "full": lambda P, d: P.full([2, 2], 1.5),
        "ones_like": lambda P, d: P.ones_like(d["X"]),
        "zeros_like": lambda P, d: P.zeros_like(d["I"]),
        "full_like": lambda P, d: P.full_like(d["X"], 0.25),
        "arange": lambda P, d: P.arange(2, 11, 3),
        "arange#float": lambda P, d: P.arange(0.0, 1.0, 0.25),
        "linspace": lambda P, d: P.linspace(0.0, 1.0, 7),
        "logspace": lambda P, d: P.logspace(0.0, 2.0, 5),
        "eye": lambda P, d: P.eye(2, 4),
        "empty": lambda P, d: P.empty([2, 3]),
        "empty_like": lambda P, d: P.empty_like(d["X"]),
        "meshgrid": lambda P, d: P.meshgrid(d["V"], d["V2"]),
        "diag": lambda P, d: P.diag(d["V"], 1, 7.0),
        "diag#matrix": lambda P, d: P.diag(d["SQ"], -1),
        "diagflat": lambda P, d: P.diagflat(d["V"], 1),
        "tril": lambda P, d: P.tril(d["SQ"]),
        "triu": lambda P, d: P.triu(d["SQ"], 1),
        "assign": lambda P, d: P.assign(d["X"]),
        "clone": lambda P, d: P.clone(d["X"]),
        "numel": lambda P, d: P.numel(d["X"]),
        "tril_indices": lambda P, d: P.tril_indices(4, 3, 0),
        "triu_indices": lambda P, d: P.triu_indices(3, 4, 1),
        "vander": lambda P, d: P.vander(d["V"], 3, True),
    }
    manipulation = {
        "reshape": lambda P, d: P.reshape(d["X3"], [6, -1]),
        "flatten": lambda P, d: P.flatten(d["X3"], 1),
        "transpose": lambda P, d: P.transpose(d["X3"], [2, 0, 1]),
        "squeeze": lambda P, d: P.squeeze(d["COL"], [0, 1]),
        "unsqueeze": lambda P, d: P.unsqueeze(d["X"], [0, 2]),
        "concat": lambda P, d: P.concat([d["X"], d["Y"]], 1),
        "stack": lambda P, d: P.stack([d["X"], d["Y"]]),
        "split": lambda P, d: P.split(d["X3"], [1, -1], 2),
        "chunk": lambda P, d: P.chunk(d["X3"], 3, 1),
        "tile": lambda P, d: P.tile(d["X"], [2, 1]),
        "expand": lambda P, d: P.expand(d["COL"], [2, 3, 5, -1]),
        "expand_as": lambda P, d: P.expand_as(d["COL"], P.zeros([3, 6, 4])),
        "broadcast_to": lambda P, d: P.broadcast_to(d["COL"], [3, 2, 4]),
        "gather": lambda P, d: P.gather(d["X"], d["IDX"], 1),
        "gather_nd": lambda P, d: P.gather_nd(d["X3"], d["ND"]),
        "scatter": lambda P, d: P.scatter(d["X"], d["IDX"], d["U"][:2]),
        "scatter#add": lambda P, d: P.scatter(d["X"], d["IDX"], d["U"][:2],
                                              overwrite=False),
        "scatter_nd_add": lambda P, d: P.scatter_nd_add(
            d["X"], d["IDX"].reshape(1, 2), d["V2"][:1]),
        "index_select": lambda P, d: P.index_select(d["X"], d["IDX"], 1),
        "masked_select": lambda P, d: P.masked_select(d["X"], d["B"]),
        "where": lambda P, d: P.where(d["B"], d["X"], d["Y"]),
        "where#nonzero": lambda P, d: P.where(d["B"]),
        "roll": lambda P, d: P.roll(d["X"], 1, 1),
        "flip": lambda P, d: P.flip(d["X3"], [0, 2]),
        "cast": lambda P, d: P.cast(d["X"], "int64"),
        "t": lambda P, d: P.t(d["X3"]),
        "moveaxis": lambda P, d: P.moveaxis(d["X3"], 0, 2),
        "unbind": lambda P, d: P.unbind(d["X"], 1),
        "repeat_interleave": lambda P, d: P.repeat_interleave(d["X"], 2, 0),
        "take_along_axis": lambda P, d: P.take_along_axis(d["X"],
                                                          d["IDX2"], 1),
        "put_along_axis": lambda P, d: P.put_along_axis(d["X"], d["IDX2"],
                                                        9.0, 1),
        "put_along_axis#add": lambda P, d: P.put_along_axis(
            d["X"], d["IDX2"], d["U"][:, :1], 1, "add"),
        "slice": lambda P, d: P.slice(d["X3"], [1, 2], [1, 0], [3, -1]),
        "strided_slice": lambda P, d: P.strided_slice(
            d["X3"], [1, 2], [2, 3], [-4, 0], [-1, -2]),
        "unique": lambda P, d: P.unique(d["I"], return_index=True,
                                        return_inverse=True,
                                        return_counts=True),
        "nonzero": lambda P, d: P.nonzero(d["B"], as_tuple=True),
        "pad": lambda P, d: P.pad(d["X3"], [1, 2], value=0.5),
        "pad#reflect": lambda P, d: P.pad(d["X3"], [2, 1], mode="reflect"),
        "pad#replicate": lambda P, d: P.pad(d["X3"], [1, 2, 2, 1],
                                            mode="replicate"),
        "pad#circular": lambda P, d: P.pad(d["X3"], [3, 1],
                                           mode="circular"),
        "rot90": lambda P, d: P.rot90(d["X3"], 3, (1, 2)),
        "unstack": lambda P, d: P.unstack(d["X"]),
        "crop": lambda P, d: P.crop(d["X3"], [1, 2, 2], [1, 1, 1]),
        "shard_index": lambda P, d: P.shard_index(d["I2"] * 3, 20, 4, 1),
        "broadcast_tensors": lambda P, d: P.broadcast_tensors(
            [d["COL"], d["X"][None]]),
        "atleast_1d": lambda P, d: P.atleast_1d(d["X"][0, 0]),
        "as_real": lambda P, d: P.as_real(P.as_complex(d["X3"][..., :2])),
        "as_complex": lambda P, d: P.as_complex(d["X3"][..., :2]),
        "tensordot": lambda P, d: P.tensordot(d["X3"], d["X"].T, 1),
        "tensordot#pairs": lambda P, d: P.tensordot(
            d["X3"], d["X3"], [[0, 1], [0, 1]]),
        "masked_fill": lambda P, d: P.masked_fill(d["X"], d["B"], -1.0),
        "index_put": lambda P, d: P.index_put(
            d["X"], [d["IDX"], d["IDX"]], d["V"][:2]),
        "index_add": lambda P, d: P.index_add(d["X"], d["IDX"], 1,
                                              d["U"][:, :2]),
        "diagonal": lambda P, d: P.diagonal(d["X3"], 1, 1, 2),
        "one_hot": lambda P, d: P.one_hot(d["I"], 5),
        "index_fill": lambda P, d: P.index_fill(d["X"], d["IDX"], 1, 0.5),
        "diagonal_scatter": lambda P, d: P.diagonal_scatter(
            d["X"], d["V2"]),
    }
    logic = {n: (lambda op: lambda P, d: getattr(P, op)(d["X"], d["Y"]))(n)
             for n in ("equal", "not_equal", "less_than", "less_equal",
                       "greater_than", "greater_equal", "isclose")}
    logic.update({n: (lambda op: lambda P, d: getattr(P, op)(
        d["B"], d["B2"]))(n) for n in ("logical_and", "logical_or",
                                       "logical_xor")})
    logic.update({n: (lambda op: lambda P, d: getattr(P, op)(
        d["I"], d["I2"]))(n) for n in ("bitwise_and", "bitwise_or",
                                       "bitwise_xor")})
    logic.update({
        "equal#scalar": lambda P, d: P.equal(d["I"], 2),
        "logical_not": lambda P, d: P.logical_not(d["B"]),
        "bitwise_not": lambda P, d: P.bitwise_not(d["I"]),
        "equal_all": lambda P, d: P.equal_all(d["X"], d["X"] + 0),
        "allclose": lambda P, d: P.allclose(d["X"], d["X"] + 1e-7),
        "is_empty": lambda P, d: P.is_empty(d["X"][:0]),
        "is_tensor": lambda P, d: P.to_tensor(P.is_tensor(d["X"])),
    })
    reduction = {}
    for n in ("sum", "mean", "max", "min", "prod", "logsumexp", "std",
              "var", "amax", "amin", "nansum", "nanmean", "median",
              "nanmedian"):
        src = "NANS" if n.startswith("nan") else "X3"
        reduction[n] = (lambda op, s: lambda P, d: getattr(P, op)(d[s]))(
            n, src)
        reduction[n + "#axes"] = (lambda op, s: lambda P, d: getattr(P, op)(
            d[s], axis=[0, 2], keepdim=True))(n, src)
    reduction.update({
        "sum#int": lambda P, d: P.sum(d["I"], axis=0),
        "all": lambda P, d: P.all(d["B"], axis=1),
        "any": lambda P, d: P.any(d["B"]),
        "count_nonzero": lambda P, d: P.count_nonzero(d["I"], axis=1),
        "quantile": lambda P, d: P.quantile(d["X3"], 0.3, axis=2),
    })
    search = {
        "argmax": lambda P, d: P.argmax(d["X3"], axis=1, keepdim=True),
        "argmin": lambda P, d: P.argmin(d["X3"]),
        "argsort": lambda P, d: P.argsort(d["X"], descending=True),
        "sort": lambda P, d: P.sort(d["X3"], axis=0),
        "topk": lambda P, d: P.topk(d["X"], 2),
        "searchsorted": lambda P, d: P.searchsorted(d["SEQ"], d["X"]),
        "kthvalue": lambda P, d: P.kthvalue(d["X"], 2),
        "mode": lambda P, d: P.mode(d["MODES"]),
        "index_sample": lambda P, d: P.index_sample(d["X"], d["IDX2"]),
        "bucketize": lambda P, d: P.bucketize(d["X"], d["SEQ"], right=True),
    }

    def recon_svd(P, d):
        u, s, vh = P.linalg.svd(d["X"])
        return s, (u * s) @ vh

    def recon_qr(P, d):
        q, r = P.linalg.qr(d["X"])
        return q @ r, r.diagonal().abs()

    def recon_eigh(P, d):
        w, v = P.linalg.eigh(d["SPD"])
        return w, (v * w) @ v.T

    def eig_sorted(P, d):
        # by real part, then imaginary (a conjugate pair shares its real
        # part, and the two libraries may list it in either order)
        w, v = P.linalg.eig(d["SQ"])
        a = d["SQ"].to(w.dtype)
        order = w.imag.argsort(stable=True)
        order = order[w.real[order].argsort(stable=True)]
        return w[order], (a @ v - v * w).abs()

    def recon_lu(P, d):
        lu, piv = P.linalg.lu(d["SQ"])
        p, lo, up = P.linalg.lu_unpack(lu, piv)
        return p @ lo @ up, lo @ up

    linalg = {
        "matmul": lambda P, d: P.matmul(d["X"], d["Y"], transpose_y=True),
        "mm": lambda P, d: P.mm(d["X"], d["X"].T),
        "bmm": lambda P, d: P.bmm(d["X3"], d["X3"].transpose(1, 2)),
        "dot": lambda P, d: P.dot(d["X"], d["Y"]),
        "mv": lambda P, d: P.mv(d["X"], d["V"]),
        "norm": lambda P, d: P.linalg.norm(d["X"]),
        "norm#axis": lambda P, d: P.linalg.norm(d["X"], 3, axis=1),
        "norm#nuc": lambda P, d: P.linalg.norm(d["SQ"], "nuc", [0, 1]),
        "dist": lambda P, d: P.dist(d["X"], d["Y"], 3),
        "cross": lambda P, d: P.cross(d["V3"], d["W3"]),
        "cholesky": lambda P, d: P.cholesky(d["SPD"]),
        "inverse": lambda P, d: P.inverse(d["SQ"]),
        "det": lambda P, d: P.det(d["SQ"]),
        "slogdet": lambda P, d: P.slogdet(d["SQ"]),
        "matrix_power": lambda P, d: P.matrix_power(d["SQ"], -2),
        "svd": recon_svd,
        "qr": recon_qr,
        "eigh": recon_eigh,
        "eigvalsh": lambda P, d: P.eigvalsh(d["SPD"]),
        "solve": lambda P, d: P.solve(d["SQ"], d["B42"]),
        "triangular_solve": lambda P, d: P.triangular_solve(
            d["TRI"], d["B42"], transpose=True),
        "pinv": lambda P, d: P.pinv(d["X"]),
        "lstsq": lambda P, d: P.lstsq(d["TALL"], d["TALLB"]),
        "einsum": lambda P, d: P.einsum("ij,kj->ik", d["X"], d["Y"]),
        "multi_dot": lambda P, d: P.multi_dot([d["X"], d["Y"].T, d["SQ"]
                                                [:3, :3]]),
        "matrix_rank": lambda P, d: P.matrix_rank(d["X"]),
        "histogram": lambda P, d: P.histogram(d["HIST"], bins=7),
        "bincount": lambda P, d: P.bincount(d["BINS"], minlength=8),
        "cov": lambda P, d: P.cov(d["X"]),
        "corrcoef": lambda P, d: P.corrcoef(d["X"], rowvar=False),
        "cdist": lambda P, d: P.cdist(d["X"], d["Y"]),
        "lu": recon_lu,
        "lu_unpack": recon_lu,
        "eig": eig_sorted,
        "eigvals": lambda P, d: P.eigvals(d["SQ"]).abs().sort().values,
    }
    return {"creation": creation, "manipulation": manipulation,
            "logic": logic, "reduction": reduction, "search": search,
            "linalg": linalg, "legacy": _api_legacy_cases(),
            "extra_ops": _api_extra_cases(),
            "vision_ops": _api_vision_cases()}


def _api_legacy_cases():
    """Phase 11 (a)'s ops.legacy family: {case: fn(P, d)} over every name
    of `legacy.__all__` but the ones it re-exports from elsewhere
    (_api_not_own). A LoD result also returns its offsets as a tensor;
    a Python value comes back through P.to_tensor; Print's printed line
    comes back as its bytes."""
    import contextlib
    import io

    import numpy as np
    import torch

    def seq(P, d, key="TALL", offs=(0, 2, 2, 6)):
        return P.legacy.LoDTensor(d[key], [list(offs)])

    def with_lod(P, t):
        return [t, P.to_tensor(np.asarray(t.lod()[0], np.int32))]

    def arr(P, d):
        return P.legacy.array_write(
            d["Y"], 2, P.legacy.create_array("float32", [d["X"]]))

    def rows(P, d):
        return P.framework.selected_rows.SelectedRows(
            np.array([3, 1, 3]), d["X"], 6)

    def printed(P, d):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = P.legacy.Print(d["X"], message="x", summarize=-1)
        return [out, P.to_tensor(np.frombuffer(buf.getvalue().encode(),
                                               np.uint8).copy())]

    def precision(P, d):
        before = torch._tensor_str.PRINT_OPTS.precision
        P.legacy.set_printoptions(precision=3)
        now = torch._tensor_str.PRINT_OPTS.precision
        torch.set_printoptions(precision=before)
        return P.to_tensor(np.asarray(now, np.int32))

    def hashed(name):
        def fn(P, d):
            ids = P.legacy.LoDTensor(d["I2"].reshape(-1, 1), [[0, 5, 12]])
            return with_lod(P, getattr(P.legacy, name)(
                ids, num_emb=16, space_len=40, pyramid_layer=3, rand_len=8,
                weights=d["HIST"]))
        return fn

    cases = {
        "elementwise_add": lambda P, d: P.legacy.elementwise_add(
            d["X"], d["Y"]),
        "elementwise_add#axis": lambda P, d: P.legacy.elementwise_add(
            d["X3"], d["X"], axis=1),
        "elementwise_sub": lambda P, d: P.legacy.elementwise_sub(
            d["X"], d["Y"]),
        "elementwise_mul#act": lambda P, d: P.legacy.elementwise_mul(
            d["X"], d["Y"], act="relu"),
        "elementwise_div": lambda P, d: P.legacy.elementwise_div(
            d["X"], d["AWAY"]),
        "elementwise_floordiv": lambda P, d: P.legacy.elementwise_floordiv(
            d["X"], d["AWAY"]),
        "elementwise_floordiv#int": lambda P, d:
            P.legacy.elementwise_floordiv(d["I"], d["I2"]),
        "elementwise_mod": lambda P, d: P.legacy.elementwise_mod(
            d["X"], d["AWAY"]),
        "elementwise_pow": lambda P, d: P.legacy.elementwise_pow(
            d["POS"], d["Y"]),
        "elementwise_max": lambda P, d: P.legacy.elementwise_max(
            d["X"], d["Y"]),
        "elementwise_min": lambda P, d: P.legacy.elementwise_min(
            d["X"], d["Y"], axis=0),
        "add_n": lambda P, d: P.legacy.add_n([d["X"], d["Y"], d["U"]]),
        "broadcast_shape": lambda P, d: P.to_tensor(
            P.legacy.broadcast_shape([2, 1, 3], [4, 3])),
        "crop_tensor": lambda P, d: P.legacy.crop_tensor(
            d["X3"], [1, 2, -1], [1, 0, 0]),
        "fill_constant": lambda P, d: P.legacy.fill_constant(
            [2, 3], "float32", 1.5),
        "has_inf": lambda P, d: [P.legacy.has_inf(d["X"]),
                                 P.legacy.has_inf(d["X"] / 0.0)],
        "has_nan": lambda P, d: P.legacy.has_nan(d["NANS"]),
        "rank": lambda P, d: P.legacy.rank(d["X3"]),
        "shape": lambda P, d: P.legacy.shape(d["X3"]),
        "reverse": lambda P, d: P.legacy.reverse(d["X3"], [0, 2]),
        "scatter_nd": lambda P, d: P.legacy.scatter_nd(d["IDX2"], d["X"],
                                                       [5, 4]),
        "get_tensor_from_selected_rows": lambda P, d:
            P.legacy.get_tensor_from_selected_rows(rows(P, d)),
        "merge_selected_rows": lambda P, d: [
            (lambda m: [m.rows, m.value])(P.legacy.merge_selected_rows(
                rows(P, d)))],
        "create_array": lambda P, d: P.legacy.create_array(
            "float32", [d["X"]])[0],
        "array_write": lambda P, d: [arr(P, d)[0], arr(P, d)[2]],
        "array_read": lambda P, d: P.legacy.array_read(arr(P, d), 2),
        "array_length": lambda P, d: P.legacy.array_length(arr(P, d)),
        "tensor_array_to_tensor": lambda P, d:
            P.legacy.tensor_array_to_tensor([d["X3"], d["X3"]], axis=1),
        "LoDTensorArray": lambda P, d: P.to_tensor(np.asarray(isinstance(
            P.legacy.create_array(), P.legacy.LoDTensorArray))),
        "LoDTensor": lambda P, d: with_lod(P, seq(P, d)),
        "sequence_pad": lambda P, d: P.legacy.sequence_pad(
            seq(P, d), pad_value=-1.0),
        "sequence_unpad": lambda P, d: with_lod(P, P.legacy.sequence_unpad(
            d["X3"], P.to_tensor(np.array([2, 3], np.int32)))),
        "sequence_softmax": lambda P, d: with_lod(
            P, P.legacy.sequence_softmax(P.legacy.LoDTensor(
                d["TALL"][:, :1], [[0, 2, 2, 6]]))),
        "sequence_reverse": lambda P, d: with_lod(
            P, P.legacy.sequence_reverse(seq(P, d))),
        "sequence_concat": lambda P, d: with_lod(
            P, P.legacy.sequence_concat([seq(P, d),
                                         seq(P, d, offs=(0, 1, 3, 6))])),
        "sequence_expand": lambda P, d: with_lod(
            P, P.legacy.sequence_expand(seq(P, d, "V3", (0, 1, 3, 5)),
                                        seq(P, d))),
        "sequence_reshape": lambda P, d: with_lod(
            P, P.legacy.sequence_reshape(seq(P, d, offs=(0, 2, 6)), 2)),
        "sequence_slice": lambda P, d: with_lod(
            P, P.legacy.sequence_slice(
                seq(P, d), P.to_tensor(np.array([0, 0, 1], np.int32)),
                P.to_tensor(np.array([2, 0, 3], np.int32)))),
        "sequence_scatter": lambda P, d: P.legacy.sequence_scatter(
            d["X"], P.legacy.LoDTensor(
                P.to_tensor(np.array([[0], [2], [2], [3], [1]], np.int32)),
                [[0, 3, 3, 5]]),
            P.legacy.LoDTensor(d["V3"][:, :1], [[0, 3, 3, 5]])),
        "lod_reset": lambda P, d: with_lod(P, P.legacy.lod_reset(
            d["TALL"], target_lod=[0, 3, 6])),
        "lod_reset#y": lambda P, d: with_lod(P, P.legacy.lod_reset(
            d["TALL"], seq(P, d))),
        "create_parameter": lambda P, d: P.legacy.create_parameter(
            [3, 4], "float32",
            default_initializer=P.nn.initializer.Assign(d["np"]["X"]))
        * 1.0,
        "create_parameter#bias": lambda P, d: P.legacy.create_parameter(
            [4], "float32", is_bias=True) * 1.0,
        "create_global_var": lambda P, d: P.legacy.create_global_var(
            [2, 3], 0.5, "float32", persistable=True),
        "set_printoptions": precision,
        "Print": printed,
        "search_pyramid_hash": hashed("search_pyramid_hash"),
        "pyramid_hash": hashed("pyramid_hash"),
    }
    for p in ("sum", "average", "sqrt", "max", "min", "last", "first"):
        cases[f"sequence_pool#{p}"] = (
            lambda P, d, p=p: P.legacy.sequence_pool(seq(P, d),
                                                     pool_type=p))
    for r in ("sum", "mean", "max", "min", "prod"):
        cases[f"reduce_{r}"] = (
            lambda P, d, r=r: getattr(P.legacy, f"reduce_{r}")(
                d["X"], dim=1, keep_dim=True))
    for r in ("all", "any"):
        cases[f"reduce_{r}"] = (
            lambda P, d, r=r: getattr(P.legacy, f"reduce_{r}")(d["B"],
                                                               dim=0))
    return cases


def _api_not_own(P, fam):
    """The names of a family's module that other families or phases
    hold: legacy's dtype defaults (phase 11's top level) and its
    re-exports of extra_ops (the extra_ops family); extra_ops' names of
    phase 12 (_S2S_EXTRA)."""
    if fam == "legacy":
        return {"get_default_dtype", "set_default_dtype"} | set(
            P.ops.extra_ops.__all__)
    return set(_S2S_EXTRA) if fam == "extra_ops" else set()


def _api_random_cases(d):
    """Phase 11 (a)'s random ops: {case: (fn(P), min, max, dtype)}."""
    return {
        "rand": (lambda P: P.rand([64, 8]), 0.0, 1.0, "float32"),
        "randn": (lambda P: P.randn([64, 8]), -10.0, 10.0, "float32"),
        "standard_normal": (lambda P: P.standard_normal([16]), -10.0, 10.0,
                            "float32"),
        "randint": (lambda P: P.randint(2, 9, [50]), 2, 8, "int32"),
        "randint_like": (lambda P: P.randint_like(d["I"], 3, 7), 3, 6,
                         "int32"),
        "uniform": (lambda P: P.uniform([40], min=-2.0, max=3.0), -2.0, 3.0,
                    "float32"),
        "uniform#seeded": (lambda P: P.uniform([40], seed=11), -1.0, 1.0,
                           "float32"),
        "normal": (lambda P: P.normal(1.0, 0.1, [200]), 0.0, 2.0,
                   "float32"),
        "normal#tensor": (lambda P: P.normal(d["X"], d["POS"]), -20.0, 20.0,
                          "float32"),
        "bernoulli": (lambda P: P.bernoulli(d["PROB"]), 0.0, 1.0,
                      "float32"),
        "poisson": (lambda P: P.poisson(d["POS"]), 0.0, 60.0, "float32"),
        "multinomial": (lambda P: P.multinomial(d["PROB"], 3), 0, 5,
                        "int32"),
        "randperm": (lambda P: P.randperm(10), 0, 9, "int32"),
        "shuffle": (lambda P: P.shuffle(d["X"]), -10.0, 10.0, "float32"),
        "uniform_": (lambda P: P.uniform_(d["X"].clone(), 0.5, 0.75), 0.5,
                     0.75, "float32"),
        "normal_": (lambda P: P.normal_(d["X"].clone(), 5.0, 0.5), 2.0, 8.0,
                    "float32"),
    }


def _api_compare(torch, np, paddle, fam, name, fn, tols):
    """Case `name` of family `fam` (phase 11 (a)) on the card against the
    CPU (`_card_vs_cpu`)."""
    fam_tol, one_tol = tols
    tol = one_tol.get((fam, name), fam_tol.get(fam))
    inputs = _det_inputs if fam in ("extra_ops", "vision_ops") else \
        _api_inputs
    return _card_vs_cpu(torch, np, paddle, fn, tol, inputs)


def _card_vs_cpu(torch, np, paddle, fn, tol, inputs):
    """fn(paddle, inputs(np, paddle, device)) on the card against the
    CPU: the same types and shapes, every card result on the card, the
    values exact (tol None) or within tol x max(1, max |CPU result|);
    returns the worst error over its limit (0 when exact)."""
    paddle.set_device("gpu")
    got = fn(paddle, inputs(np, paddle, "cuda"))
    paddle.set_device("cpu")
    try:
        want = fn(paddle, inputs(np, paddle, "cpu"))
    finally:
        paddle.set_device("gpu")

    def flat(o):
        if isinstance(o, (tuple, list)):
            return [y for x in o for y in flat(x)]
        return [o]
    g, w = flat(got), flat(want)
    assert len(g) == len(w), (len(g), len(w))
    worst = 0.0
    for a, b in zip(g, w):
        assert torch.is_tensor(a) and a.device.type == "cuda", type(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            a.dtype, b.dtype, tuple(a.shape), tuple(b.shape))
        a, b = a.detach().cpu(), b.detach()
        if tol is None or not (a.is_floating_point() or a.is_complex()):
            assert torch.equal(a, b) or (
                a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num())), \
                "not exact"
            continue
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        scale = max(1.0, float(b[fin].abs().max()) if fin.any() else 0.0)
        err = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
        worst = max(worst, err / (tol * scale))
        assert err <= tol * scale, (err, tol * scale)
    return worst


def _s2s_inputs(np, paddle, device):
    """Phase 12 (a)'s inputs, made from one numpy seed, on `device`."""
    rng = np.random.RandomState(0)

    def f(*shape, lo=None, hi=None):
        if lo is None:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)
    a = dict(X4=f(2, 4, 6, 8), GRID=f(2, 5, 7, 2, lo=-1.2, hi=1.2),
             THETA=f(2, 2, 3, lo=-1.0, hi=1.0), COLS=f(2, 36, 24),
             A=f(6, 5), B=f(6, 5), PROB=f(6, 5, lo=0.05, hi=0.95),
             U=f(6, 4), V=f(6, 4), W=f(6, 4), B1=f(6, 3), B2=f(6, 4),
             SEQ=f(3, 9, 5), XS=f(3, 5), H=f(3, 6), C=f(3, 6),
             P0=f(4, 3), P1=f(5), G=f(3, 4, 3) * 1.5, G1=f(3, 5) * 1.5,
             TABLE=np.full(8, -5.0, np.float32), SP=f(3, 4),
             VOL=f(1, 2, 4, 6, 5), SIG=f(3, 2, 8), BW=f(5, 3, 4),
             BB=f(5))
    a["TABLE"][[1, 3]] = (1.0, 2.0)
    a["Y01"] = (f(6, 5, lo=0, hi=1) > 0.5).astype(np.float32)
    a["PM1"] = np.where(f(6) > 0, 1.0, -1.0).astype(np.float32)
    a["LOGP"] = (a["A"] - np.log(np.exp(a["A"]).sum(1, keepdims=True))
                 ).astype(np.float32)
    a["LAB"] = rng.randint(0, 5, 6).astype(np.int32)
    a["LAB1"] = rng.randint(0, 5, (6, 1)).astype(np.int32)
    a["IDS"] = rng.randint(-1, 6, (3, 4)).astype(np.int32)
    a["LENS"] = np.array([2, 0, 5], np.int32)
    a["TREE_IDS"] = rng.randint(0, 9, (5, 2, 3)).astype(np.int32)
    a["TREE_PAR"] = rng.randint(0, 3, (5, 2, 3)).astype(np.int32)
    a["CTC"] = np.log(rng.dirichlet(np.ones(5), (7, 3))).astype(np.float32)
    a["CTC_LAB"] = np.array([[1, 2, 2], [3, 1, 0], [4, 4, 4]], np.int32)
    a["CTC_IL"] = np.array([7, 5, 6], np.int32)
    a["CTC_LL"] = np.array([3, 2, 1], np.int32)
    x = f(2, 3, 8, 8)
    win = x.reshape(2, 3, 4, 2, 4, 2).transpose(0, 1, 2, 4, 3, 5)
    arg = win.reshape(2, 3, 4, 4, 4).argmax(-1)
    a["UNPOOL_IDX"] = ((np.arange(4)[:, None] * 2 + arg // 2) * 8
                       + np.arange(4)[None, :] * 2 + arg % 2
                       ).astype(np.int32)
    a["UNPOOL"] = np.take_along_axis(win.reshape(2, 3, 4, 4, 4),
                                     arg[..., None], -1)[..., 0]
    d = {k: paddle.to_tensor(v, place=device) for k, v in a.items()}
    d["np"], d["device"] = a, device
    return d


def _s2s_built(P, d, make):
    """`make()` built on the CPU after P.seed(0), moved to d's device (so
    the card and the CPU runs hold the same weights)."""
    prev = P.get_device()
    P.set_device("cpu")
    try:
        P.seed(0)
        module = make()
    finally:
        P.set_device(prev)
    return module.to(d["device"])


def _s2s_grads(P, d, out, leaves):
    """The gradients of sum(out * w) (w from a fixed seed) for `leaves`,
    zeros where a leaf has no path to `out`."""
    import numpy as np
    import torch
    w = np.random.RandomState(7).standard_normal(tuple(out.shape))
    (out * P.to_tensor(w.astype(np.float32), place=d["device"])).sum(
        ).backward()
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in leaves]


def _s2s_groups(P):
    """{group: the names this slice adds, from the modules' __all__}."""
    old = {"linear", "dropout", "embedding", "cross_entropy", "Linear",
           "Dropout", "Embedding", "CrossEntropyLoss", "SGD", "Momentum",
           "Adam", "AdamW"}
    nn, F = P.nn, P.nn.functional

    def new(*mods):
        return [n for m in mods for n in m.__all__ if n not in old]
    return {"functional": new(F.common) + list(_S2S_EXTRA),
            "loss": new(F.loss),
            "layers": ["Layer"] + new(nn.layer.common, nn.layer.loss),
            "rnn": new(nn.layer.rnn, nn.decode),
            "clip_utils": new(nn.clip, nn.utils),
            "optimizer": new(P.optimizer.optimizers)}


def _s2s_cases():
    """Phase 12 (a): {group: {case: (fn(P, d), tol)}}; tol None is exact,
    "float" / "rnn" index S2S_TOL, "stat" runs on the card only and
    asserts statistics."""
    import numpy as np
    import torch

    def F(P):
        return P.nn.functional

    def fn_case(name, *keys, **kw):
        def fn(P, d):
            return getattr(F(P), name)(*[d[k] if isinstance(k, str) else k
                                         for k in keys], **kw)
        return fn

    def layer_case(name, cargs, keys, **kw):
        def fn(P, d):
            layer = _s2s_built(P, d, lambda: getattr(P.nn, name)(*cargs,
                                                                 **kw))
            assert isinstance(layer, P.nn.Layer)
            return layer(*[d[k] for k in keys])
        return fn

    def dropout_stats(P, d):
        dev = d["device"]
        P.seed(3)
        x = torch.ones(64, 32, 4, 4, device=dev)
        for y in (F(P).dropout2d(x, 0.25), P.nn.Dropout2D(0.25)(x)):
            per = y.reshape(64, 32, -1)
            assert bool(((per == 0).all(-1) | (per == 1 / 0.75).all(-1))
                        .all()), "dropout2d: a channel half dropped"
            share = float((per[..., 0] == 0).float().mean())
            assert abs(share - 0.25) < 0.04, share
        z = torch.ones(64, 64, 2, 3, 3, device=dev)
        for y in (F(P).dropout3d(z, 0.5), P.nn.Dropout3D(0.5)(z)):
            y = y.reshape(64, 64, -1)
            assert bool(((y == 0).all(-1) | (y == 2).all(-1)).all()), \
                "dropout3d: a channel half dropped"
            share = float((y[..., 0] == 0).float().mean())
            assert abs(share - 0.5) < 0.04, share
        n = torch.randn(400_000, device=dev)
        for y in (F(P).alpha_dropout(n, 0.2), P.nn.AlphaDropout(0.2)(n)):
            assert abs(float(y.mean())) < 0.01, float(y.mean())
            assert abs(float(y.std()) - 1) < 0.01, float(y.std())
        for layer in (P.nn.Dropout2D(0.5), P.nn.Dropout3D(0.5),
                      P.nn.AlphaDropout(0.5)):
            layer.eval()
            assert layer(x) is x
        assert F(P).dropout2d(x, 0.0) is x
        return []

    def interp(size, mode, key="X4", df="NCHW"):
        return fn_case("interpolate", key, size=size, mode=mode,
                       data_format=df)

    functional = {
        "dropout2d": (dropout_stats, "stat"),
        "dropout3d": (dropout_stats, "stat"),
        "alpha_dropout": (dropout_stats, "stat"),
        "one_hot": (fn_case("one_hot", "IDS", 5), None),
        "label_smooth": (fn_case("label_smooth", "PROB", epsilon=0.2),
                         "float"),
        "pad": (fn_case("pad", "X4", [1, 2, 0, 3], mode="reflect"), None),
        "interpolate": (interp([9, 13], "bilinear"), "float"),
        "interpolate#bicubic_down": (interp([3, 5], "bicubic"), "float"),
        "interpolate#nearest": (interp([13, 5], "nearest"), None),
        "interpolate#area": (interp([2, 5], "area"), "float"),
        "interpolate#linear": (interp([17], "linear", "SIG", "NCL"),
                               "float"),
        "interpolate#trilinear": (interp([5, 3, 9], "trilinear", "VOL",
                                         "NCDHW"), "float"),
        "upsample": (fn_case("upsample", "X4", scale_factor=2), None),
        "cosine_similarity": (fn_case("cosine_similarity", "U", "V"),
                              "float"),
        "pairwise_distance": (fn_case("pairwise_distance", "U", "V",
                                      p=3.0), "float"),
        "normalize": (fn_case("normalize", "U", axis=-1), "float"),
        "pixel_shuffle": (fn_case("pixel_shuffle", "X4", 2), None),
        "unfold": (fn_case("unfold", "X4", [3, 2], strides=[1, 2],
                           paddings=[1, 0, 2, 1], dilations=[2, 1]), None),
        "fold": (fn_case("fold", "COLS", [6, 7], 3, strides=[1, 2],
                         paddings=[1, 1]), "float"),
        "bilinear": (fn_case("bilinear", "B1", "B2", "BW", "BB"), "float"),
        "sequence_mask": (fn_case("sequence_mask", "LENS", maxlen=6,
                                  dtype="float32"), None),
        "sequence_mask#none": (fn_case("sequence_mask", "LENS"), None),
        "grid_sample": (fn_case("grid_sample", "X4", "GRID",
                                align_corners=False), "float"),
        "grid_sample#nearest": (fn_case("grid_sample", "X4", "GRID",
                                        mode="nearest"), "float"),
        "grid_sample#reflection": (fn_case("grid_sample", "X4", "GRID",
                                           padding_mode="reflection"),
                                   "float"),
        "affine_grid": (fn_case("affine_grid", "THETA", [2, 3, 5, 4]),
                        "float"),
        "channel_shuffle": (fn_case("channel_shuffle", "X4", 2), None),
        "pixel_unshuffle": (fn_case("pixel_unshuffle", "X4", 2), None),
        "max_unpool2d": (fn_case("max_unpool2d", "UNPOOL", "UNPOOL_IDX", 2),
                         None),
        "gather_tree": (fn_case("gather_tree", "TREE_IDS", "TREE_PAR"),
                        None),
    }
    ctc = ("CTC", "CTC_LAB", "CTC_IL", "CTC_LL")
    loss = {
        "softmax_with_cross_entropy": (fn_case(
            "softmax_with_cross_entropy", "A", "LAB1", return_softmax=True),
            "float"),
        "mse_loss": (fn_case("mse_loss", "A", "B"), "float"),
        "l1_loss": (fn_case("l1_loss", "A", "B", reduction="none"),
                    "float"),
        "nll_loss": (fn_case("nll_loss", "LOGP", "LAB"), "float"),
        "kl_div": (fn_case("kl_div", "LOGP", "PROB"), "float"),
        "smooth_l1_loss": (fn_case("smooth_l1_loss", "A", "B", delta=0.7),
                           "float"),
        "binary_cross_entropy": (fn_case("binary_cross_entropy", "PROB",
                                         "Y01"), "float"),
        "binary_cross_entropy_with_logits": (fn_case(
            "binary_cross_entropy_with_logits", "A", "Y01"), "float"),
        "margin_ranking_loss": (lambda P, d: F(P).margin_ranking_loss(
            d["A"][:, 0], d["B"][:, 0], d["PM1"], 0.3), "float"),
        "hinge_embedding_loss": (lambda P, d: F(P).hinge_embedding_loss(
            d["A"][:, 0], d["PM1"]), "float"),
        "cosine_embedding_loss": (fn_case("cosine_embedding_loss", "U", "V",
                                          "PM1", margin=0.1), "float"),
        "triplet_margin_loss": (fn_case("triplet_margin_loss", "U", "V",
                                        "W", swap=True), "float"),
        "log_loss": (fn_case("log_loss", "PROB", "Y01"), "float"),
        "square_error_cost": (fn_case("square_error_cost", "A", "B"),
                              "float"),
        "sigmoid_focal_loss": (fn_case("sigmoid_focal_loss", "A", "Y01"),
                               "float"),
        "dice_loss": (fn_case("dice_loss", "PROB", "LAB1"), "float"),
        "npair_loss": (lambda P, d: F(P).npair_loss(
            d["U"], d["V"], d["LAB"] % 3), "float"),
        "ctc_loss": (fn_case("ctc_loss", *ctc), "float"),
    }

    def custom_layer(P, d):
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter([5, 4])
                self.b = self.create_parameter([4], is_bias=True)

            def forward(self, x):
                return x @ self.w + self.b
        net = _s2s_built(P, d, Net)
        out = net(d["XS"])
        return [out] + _s2s_grads(P, d, out, list(net.parameters()))

    layers = {
        "Layer": (custom_layer, "float"),
        "Dropout2D": (dropout_stats, "stat"),
        "Dropout3D": (dropout_stats, "stat"),
        "AlphaDropout": (dropout_stats, "stat"),
        "Flatten": (layer_case("Flatten", (), ["X4"]), None),
        "Identity": (layer_case("Identity", (), ["X4"]), None),
        "Upsample": (layer_case("Upsample", (), ["X4"], scale_factor=2,
                                mode="bicubic"), "float"),
        "UpsamplingNearest2D": (layer_case("UpsamplingNearest2D", (),
                                           ["X4"], size=[5, 11]), None),
        "UpsamplingBilinear2D": (layer_case("UpsamplingBilinear2D", (),
                                            ["X4"], size=[3, 12]), "float"),
        "Pad1D": (layer_case("Pad1D", ([1, 2],), ["SIG"],
                             mode="replicate"), None),
        "Pad2D": (layer_case("Pad2D", ([1, 0, 2, 1],), ["X4"], value=0.5),
                  None),
        "Pad3D": (layer_case("Pad3D", ([1, 0, 2, 1, 0, 1],), ["VOL"],
                             mode="circular"), None),
        "Bilinear": (layer_case("Bilinear", (3, 4, 5), ["B1", "B2"]),
                     "float"),
        "CosineSimilarity": (layer_case("CosineSimilarity", (), ["U", "V"]),
                             "float"),
        "PairwiseDistance": (layer_case("PairwiseDistance", (), ["U", "V"]),
                             "float"),
        "PixelShuffle": (layer_case("PixelShuffle", (2,), ["X4"]), None),
        "Unfold": (layer_case("Unfold", ([2, 3],), ["X4"], strides=2),
                   None),
        "MSELoss": (layer_case("MSELoss", (), ["A", "B"]), "float"),
        "L1Loss": (layer_case("L1Loss", (), ["A", "B"]), "float"),
        "NLLLoss": (layer_case("NLLLoss", (), ["LOGP", "LAB"]), "float"),
        "KLDivLoss": (layer_case("KLDivLoss", (), ["LOGP", "PROB"],
                                 reduction="batchmean"), "float"),
        "SmoothL1Loss": (layer_case("SmoothL1Loss", (), ["A", "B"]),
                         "float"),
        "BCELoss": (layer_case("BCELoss", (), ["PROB", "Y01"]), "float"),
        "BCEWithLogitsLoss": (layer_case("BCEWithLogitsLoss", (),
                                         ["A", "Y01"]), "float"),
        "MarginRankingLoss": (layer_case("MarginRankingLoss", (),
                                         ["U", "V", "W"]), "float"),
        "HingeEmbeddingLoss": (layer_case("HingeEmbeddingLoss", (),
                                          ["U", "W"]), "float"),
        "CosineEmbeddingLoss": (layer_case("CosineEmbeddingLoss", (),
                                           ["U", "V", "PM1"]), "float"),
        "TripletMarginLoss": (layer_case("TripletMarginLoss", (),
                                         ["U", "V", "W"]), "float"),
        "CTCLoss": (layer_case("CTCLoss", (), list(ctc)), "float"),
    }

    def rnn_case(cls, *cargs, time_major=False, **kw):
        def fn(P, d):
            layer = _s2s_built(P, d, lambda: getattr(P.nn, cls)(
                *cargs, time_major=time_major, **kw))
            x = d["SEQ"].transpose(0, 1) if time_major else d["SEQ"]
            x = x.contiguous().requires_grad_()
            out, st = layer(x)
            return [out, st] + _s2s_grads(P, d, out,
                                          [x] + list(layer.parameters()))
        return fn

    def cell_case(cls, **kw):
        def fn(P, d):
            cell = _s2s_built(P, d, lambda: getattr(P.nn, cls)(5, 6, **kw))
            x = d["XS"].clone().requires_grad_()
            st = (d["H"], d["C"]) if cls == "LSTMCell" else d["H"]
            out, new = cell(x, st)
            return [out, new] + _s2s_grads(P, d, out,
                                           [x] + list(cell.parameters()))
        return fn

    def loop_case(bidirectional):
        def fn(P, d):
            def make():
                if bidirectional:
                    return P.nn.BiRNN(P.nn.LSTMCell(5, 6),
                                      P.nn.LSTMCell(5, 6))
                return P.nn.RNN(P.nn.GRUCell(5, 6), is_reverse=True)
            rnn = _s2s_built(P, d, make)
            x = d["SEQ"].clone().requires_grad_()
            out, st = rnn(x)
            return [out, st] + _s2s_grads(P, d, out,
                                          [x] + list(rnn.parameters()))
        return fn

    class _FixedCell:
        def __init__(self, table):
            self.table = table

        def __call__(self, inputs, states):
            return self.table.expand(inputs.shape[0], -1), states

    def beam(P, d):
        dec = P.nn.BeamSearchDecoder(_FixedCell(d["TABLE"]), 0, 1, 3)
        (seqs, scores), _ = P.nn.dynamic_decode(dec, inits=d["H"],
                                                max_step_num=4)
        return [seqs, scores]

    def beam_real(P, d):
        def make():
            return P.nn.LayerList([P.nn.Embedding(8, 6),
                                   P.nn.LSTMCell(6, 6), P.nn.Linear(6, 8)])
        emb, cell, proj = _s2s_built(P, d, make)
        dec = P.nn.BeamSearchDecoder(cell, 0, 1, 3, embedding_fn=emb,
                                     output_fn=proj)
        with torch.no_grad():
            (seqs, scores), _ = P.nn.dynamic_decode(
                dec, inits=(d["H"], d["C"]), max_step_num=5)
        return [seqs, scores]

    def decoder(P, d):
        class Count(P.nn.Decoder):
            def initialize(self, inits):
                return inits, inits, inits > 100

            def step(self, time, inputs, states, **kwargs):
                new = states + 1
                return new, new, new, new > 3
        outs, final = P.nn.dynamic_decode(Count(), inits=d["LENS"],
                                          max_step_num=10)
        return list(outs) + [final]

    rnn = {
        "SimpleRNNCell": (cell_case("SimpleRNNCell", activation="relu"),
                          "rnn"),
        "LSTMCell": (cell_case("LSTMCell"), "rnn"),
        "GRUCell": (cell_case("GRUCell"), "rnn"),
        "RNN": (loop_case(False), "rnn"),
        "BiRNN": (loop_case(True), "rnn"),
        "SimpleRNN": (rnn_case("SimpleRNN", 5, 6), "rnn"),
        "SimpleRNN#relu": (rnn_case("SimpleRNN", 5, 6, activation="relu"),
                           "rnn"),
        "LSTM": (rnn_case("LSTM", 5, 6), "rnn"),
        "LSTM#bidirect_2layers": (rnn_case("LSTM", 5, 6, num_layers=2,
                                           direction="bidirect"), "rnn"),
        "GRU": (rnn_case("GRU", 5, 6), "rnn"),
        "GRU#2layers_time_major": (rnn_case("GRU", 5, 6, num_layers=2,
                                            time_major=True), "rnn"),
        "Decoder": (decoder, None),
        "BeamSearchDecoder": (beam, "float"),
        "BeamSearchDecoder#real_cell": (beam_real, "float"),
        "dynamic_decode": (beam, "float"),
    }

    def two_linear(P, d):
        def make():
            return P.nn.Sequential(
                P.nn.Linear(4, 5, weight_attr=P.ParamAttr(need_clip=False)),
                P.nn.Linear(5, 3))
        net = _s2s_built(P, d, make)
        return [(p, p.detach() * 7.0) for p in net.parameters()]

    def clip_case(cls, arg):
        def fn(P, d):
            pairs = two_linear(P, d)
            return [g for _, g in getattr(P.nn, cls)(arg)(pairs)]
        return fn

    def wn_case(P, d):
        lin = _s2s_built(P, d, lambda: P.nn.utils.weight_norm(
            P.nn.Linear(5, 4), dim=1))
        out = lin(d["XS"])
        grads = _s2s_grads(P, d, out, [lin.weight_g, lin.weight_v])
        P.nn.utils.remove_weight_norm(lin)
        return [out] + grads + [lin(d["XS"])]

    def sn_case(P, d):
        lin = _s2s_built(P, d, lambda: P.nn.utils.spectral_norm(
            P.nn.Linear(5, 4), n_power_iterations=2))
        return lin(d["XS"])

    def vec_case(P, d):
        cell = _s2s_built(P, d, lambda: P.nn.GRUCell(3, 4))
        v = P.nn.utils.parameters_to_vector(cell.parameters()).detach()
        P.nn.utils.vector_to_parameters(v * 2, cell.parameters())
        return [v] + [p.detach() for p in cell.parameters()]

    def pytree_case(P, d):
        out = P.nn.clip.clip_by_global_norm_pytree(
            {"b": [d["A"], d["U"]], "a": (d["XS"],)}, 0.5)
        return list(out["a"]) + out["b"]

    clip_utils = {
        "ClipGradByValue": (clip_case("ClipGradByValue", 0.5), "float"),
        "ClipGradByNorm": (clip_case("ClipGradByNorm", 0.1), "float"),
        "ClipGradByGlobalNorm": (clip_case("ClipGradByGlobalNorm", 0.1),
                                 "float"),
        "clip_by_global_norm_pytree": (pytree_case, "float"),
        "weight_norm": (wn_case, "float"),
        "remove_weight_norm": (wn_case, "float"),
        "spectral_norm": (sn_case, "float"),
        "parameters_to_vector": (vec_case, None),
        "vector_to_parameters": (vec_case, None),
    }

    def opt_case(cls, **kw):
        def fn(P, d):
            ps = [torch.nn.Parameter(d["P0"].clone()),
                  torch.nn.Parameter(d["P1"].clone())]
            opt = getattr(P.optimizer, cls)(
                parameters=ps, grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                **kw)
            for i in range(3):
                ps[0].grad, ps[1].grad = d["G"][i], d["G1"][i]
                opt.step()
                opt.clear_grad()
            return ps + [v for p in ps for _, v in
                         sorted(opt._accumulators[id(p)].items())]
        return fn

    optimizer = {
        "Adamax": (opt_case("Adamax", learning_rate=0.02,
                            weight_decay=0.01), "float"),
        "Adagrad": (opt_case("Adagrad", learning_rate=0.05,
                             initial_accumulator_value=0.1), "float"),
        "Adadelta": (opt_case("Adadelta", learning_rate=0.5), "float"),
        "RMSProp": (opt_case("RMSProp", learning_rate=0.01, momentum=0.9,
                             centered=True), "float"),
        "Lamb": (opt_case("Lamb", learning_rate=0.01), "float"),
        "LarsMomentum": (opt_case("LarsMomentum", learning_rate=0.1),
                         "float"),
    }
    return {"functional": functional, "loss": loss, "layers": layers,
            "rnn": rnn, "clip_utils": clip_utils, "optimizer": optimizer}


def _ptxas_kernels(log):
    """(name, registers, (spill store bytes, spill load bytes)) of every
    kernel in an `nvcc -Xptxas -v` log, the name demangled as far as
    `kernel<type, D>`."""
    import re
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def _kernel_name(mangled):
    """`paged_split_kernel<float, 80>` from its Itanium-mangled name (a
    kernel in an anonymous namespace, templated on a type and an int:
    `_ZN<n><namespace><m><name>I<type>Li<D>E...`); K2-K7's padded
    instantiations (a third, bool argument `Lb1E`) read
    `flash_fwd_kernel<float, 96, pad>`."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    base = rest[m.end():m.end() + int(m.group(1))]
    t = re.match(r"I(f|13__nv_bfloat16|6__half)Li(\d+)E(Lb([01])E)?",
                 rest[m.end() + int(m.group(1)):])
    if not t:
        return base
    ty = {"f": "float", "13__nv_bfloat16": "bfloat16",
          "6__half": "float16"}[t.group(1)]
    pad = ", pad" if t.group(4) == "1" else ""
    return f"{base}<{ty}, {t.group(2)}{pad}>"


def _device_table(torch, prof, steps, wall_ms):
    """Device ms per step over a profiled window of `steps`, and the top
    kernels as (name, ms per step, calls per step), printed."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None)
          == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    dev = sum(dev_us(e) for e in ev) / 1e3 / steps
    print(f"  device {dev:.3f} ms/step over {wall_ms / steps:.3f} ms/step "
          f"wall; {sum(e.count for e in ev) / steps:.0f} kernels/step")
    top = sorted(ev, key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"  {dev_us(e) / 1e3 / steps:8.4f} ms/step "
              f"{e.count / steps:6.1f} calls/step  {e.key[:90]}")
    return dev, [(e.key, dev_us(e) / 1e3 / steps, e.count / steps)
                 for e in sorted(ev, key=dev_us, reverse=True)]


# the phases after card and build, in the order they run
PHASES = ("kernels", "model", "serving", "features", "quant", "tier", "fleet",
          "profile", "train", "packing", "ernie", "vision", "detect",
          "export", "onnx", "store", "api", "seq2seq", "input", "static",
          "dist",
          "ps")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (phases 1-3)")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, profile prefill and decode steps; "
                    "after training, one train step; after packing, one "
                    "packed train step; in vision, one ResNet-50 step")
    ap.add_argument("--details", default="",
                    help="also write every measurement as JSON to this path")
    ap.add_argument("--phases", default="",
                    help="comma-separated names of the phases to run after "
                    "card and build (e.g. ernie,static), in their usual "
                    "order, for an A/B of one path; prints no result line")
    ap.add_argument("--elastic-hang", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--store-worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--store-wd", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.elastic_hang:
        return _elastic_hang_rank()
    if args.store_worker:
        return _store_worker(args.store_worker, args.store_wd)
    only = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "paddle_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: paddle_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sm = Smoke(args)
    sm.phase("card", sm.card)
    built = sm.phase("build", sm.build)
    if built:
        for name in PHASES:
            if only:
                if name not in only:
                    continue
            elif args.kernels and name != "kernels" or \
                    name == "profile" and not args.profile:
                continue
            sm.phase(name, getattr(sm, name))
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"card": sm.smi, "details": sm.details,
                       "path_launches": sm.path_launches}, f, indent=1)
    if sm.failures or args.kernels or only:
        print(f"chip_smoke: failed phases {sm.failures}" if sm.failures
              else "chip_smoke: some phases only, no result")
        return 1 if sm.failures else 0
    print(json.dumps(sm.kernels_line()))
    print(sm.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
