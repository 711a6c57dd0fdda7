#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one
NVIDIA H100.  Run from the repository root::

    python3 chip_smoke.py [--record PATH]

It imports nothing of JAX and nothing of the JAX package.  Phases, each of
which must pass or the script exits non-zero without a result line:

1. build every kernel (``deeplearning4j_tpu_torch/csrc/*.cu``: the flash
   forward B1, the flash backward's dq and dk/dv passes B2, B3, and the
   matrix product with the BatchNorm statistics B4) with nvcc for sm_90a,
   all sources in parallel, timed as set-up; print ptxas's registers,
   spills and wgmma notes, and, where ``cuobjdump`` is present, each
   kernel's count of HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA load),
   UTMASTG (TMA store) and local-memory (STL/LDL) instructions.  Every
   instantiation of B1, B2 and B3 and every GEMM instantiation of B4 (its
   column-sum and wᵀ-split passes are excluded by name) must show HGMMA
   and UTMALDG, no STL/LDL and no ptxas spill (the tensor-core design; no
   ``cuobjdump`` fails it);
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, a ragged shape and small shapes (tolerances below),
   and the flash gradient (``FlashAttention``: B1 forward, B2 and B3
   backward) against autograd through dense attention; the auto dispatch
   at shapes the flash kernels refuse (head size 256, float16, and a
   ``SelfAttentionLayer(nHeads=1, nOut=256)`` at t 1024) must run dense
   without a launch, and an explicit ``impl="flash"`` there must raise;
3. serving path, through the entry points a user calls:
   ``TransformerLM.generate`` at GPT-2 small widths (768 = 12 heads x 64,
   12 layers, FFN 3072, vocab 50257; ``maxLen`` 2048 so a 1024-token
   prompt plus its generation fits) on 4 unpadded 1024-token prompts for
   32 new tokens, with seeded random weights.  The kernel counters are set
   to 0 just before and read just after: prefill must launch the flash
   kernel once per layer and no backward kernel.  Then one left-padded
   request (``lengths=``) must take the dense masked path (no launch);
4. check the serving outputs: prefill logits against the same model with
   dense attention forced, the padded request against unpadded prefills
   of its rows, and one KV-cached decode step against a prefill of the
   extended prompt;
5. time B1 at the serving shape, float32 and bfloat16, beside its bound,
   its plain version and ``torch.nn.functional.scaled_dot_product_attention``
   (a yardstick only: the port never calls it), each with CUDA events
   around back-to-back calls and, for B1 and SDPA, as profiler device time
   (the host's time between launches left out); the model's prefill and
   decode rates;
   profile one prefill and four decode steps for device time by kernel
   and the device's idle share;
6. training path: the repo's long-context attention net (``bench.py``
   ``bench_long_context``: two ``SelfAttentionLayer(nHeads=8,
   headSize=16, nOut=128)`` and an ``RnnOutputLayer("mse", nOut=8,
   identity)`` over ``InputType.recurrent(128, 2048)``, ``Adam(1e-3)``,
   ``dataType("BFLOAT16")``, seed 5) built with the config DSL and
   trained by ``MultiLayerNetwork.fit`` on a ``ListDataSetIterator`` of
   two seeded batches of 4 for 2 epochs.  Counters set to 0 just before
   and read just after: every step must launch B1, B2 and B3 twice each
   (once per attention layer); the loss must be finite;
7. check the training step: the same net in FLOAT from the same copied
   parameters, one step with the flash kernels against one step with
   dense attention forced (loss and updated parameters);
8. time B1, B2 and B3 at the training shape, bfloat16 and float32, beside
   their bounds, their plain versions and SDPA's forward and backward (CUDA
   events and profiler device time, as in 5), and the training rate
   (tokens/s as ``bench.py`` counts them: b·t·steps / wall); profile one
   training step;
9. hold B4 (``csrc/matmul_bn_stats.cu``, the matrix product with the
   BatchNorm statistics in its epilogue) against its plain version at
   every 1x1 stride-1 GEMM of ResNet-50 at batch 64, the reference test's
   shape and ragged shapes (among them K and N rows that the wrapper pads
   to 16 bytes), in float32 and bfloat16; two calls on the same inputs
   must give the same bits at the stage-0 shape and a padded ragged one;
10. ResNet-50 training path, ``bench.py``'s configuration
   (``ResNet50(numClasses=1000, inputShape=(3, 224, 224),
   dataType="BFLOAT16")``, its zoo updater ``Nesterovs(0.1, 0.9)``, seeded
   ``RandomState(0)`` normal images with one-hot labels) at batch 64 (cut
   from bench.py's 256), trained by ``ComputationGraph.fit`` on a
   ``ListDataSetIterator`` of two batches for 2 epochs.  Counters set to 0
   just before and read just after: no kernel launches (the graph
   dispatches no B4, as in the reference, and has no attention); the loss
   must be finite;
11. check one FLOAT step of ResNet-50 at batch 2 from the same copied
   parameters on the card and on the CPU (loss, parameters, BN running
   statistics);
12. B4 on the model's own activations: after a FLOAT forward in train mode
   on the card, the input of one 1x1 stride-1 conv per stage through
   ``conv1x1_bn_stats``, held against the graph's conv output and the
   following BN layer's batch mean and biased variance.  Counters set to 0
   just before and read just after: four B4 launches;
13. time B4 at each ResNet-50 shape, bfloat16 and float32, beside its
   bound, its plain version, ``torch.matmul`` (the product only, no
   statistics: ``library_ms``) and the unfused sequence (``torch.matmul``
   then the two f32 column sums, which re-read y: ``unfused_ms``), with CUDA
   events and, for B4 and ``torch.matmul``, profiler device time; and the
   ResNet-50 step (ms/step, images/s as ``bench.py`` counts them); profile
   one step;
14. recurrent path (``rnn_train``): BASELINE config 4, the GravesLSTM
   char-RNN at the widths of dl4j-examples' ``LSTMCharModellingExample``
   (two ``GravesLSTM(200, tanh)``, ``RnnOutputLayer("mcxent", softmax)``,
   ``Adam(5e-3)``, l2 1e-4, XAVIER, truncated BPTT 50; minibatch 32,
   ``exampleLength`` 1000, FLOAT) built with the config DSL and trained by
   ``MultiLayerNetwork.fit(CharacterIterator, epochs=1)`` over
   ``examples/lstm_charmodelling.py``'s text repeated to fill two
   minibatches (2 batches x 20 chunks).  Counters set to 0 just before and
   read just after: no kernel launches (the recurrence is torch ops, as the
   reference's is a ``lax.scan``); the loss must be finite and the
   iteration count 2 (one per batch, whatever its chunks);
15. check one FLOAT TBPTT batch (4 x 200 steps, 4 chunks) from the same
   copied parameters on the card and on the CPU (loss, parameters);
16. ``rnnTimeStep`` on the card: 120 single steps equal ``output`` of the
   whole sequence step by step, ``rnnClearPreviousState`` resets, and the
   example's 120-character sampling loop runs and prints its sample;
17. ``ComputationGraph`` recurrence (``rnn_graph``): the merge-vertex
   char-RNN of ``tests/test_graph_recurrence.py`` at width 200 through
   ``fit`` with TBPTT and ``rnnTimeStep``, and a GravesLSTM stack as a
   graph against the same stack as a ``MultiLayerNetwork`` (the
   reference's ``test_tbptt_matches_mln_path``); no kernel launches;
18. time the char-RNN (``rnn_timing``): ms per TBPTT batch and chunk,
   characters/s (batch x t / wall), peak memory, and one profiled chunk
   (device time, idle share, device ops), each line beside the card's name
   and power limit;
19. BERT path (``bert_train``): BASELINE config 3, ``BertBase("mlm")`` at
   its published widths (12 layers, 768 = 12 heads x 64, FFN 3072, vocab
   30522, 128 positions; 109,182,522 parameters) built on SameDiff, with
   ``setTrainingConfig(updater=Adam(2e-5), dataType="BFLOAT16")``, trained
   by ``SameDiff.fit`` on ``bench.py`` ``bench_bert``'s two seeded
   ``MultiDataSet``s of 256 x 128: ``fit(pool, epochs=1)`` warms up, then
   ``fit(pool, epochs=2)``.  Counters set to 0 just before and read just
   after: no kernel launches (attention is the graph's einsum-chain op, as
   in the reference); ``iterationCount`` must be 6 and every loss finite;
20. time the BERT step (``bert_timing``): ms per step and tokens/s as
   ``bench.py`` counts them (batch x seq x steps / wall, synchronised) over
   8 steps, peak memory, the step's FLOPs by ``FlopCounterMode`` and their
   share of the dense bf16 peak (a record, not a limit), and one profiled
   step (device time, idle share, top kernels, device ops);
21. ``bert_output``: ``Bert.output`` (encoder_out) and the
   ``"classification"`` head's logits at full widths on the card against
   the same models on the CPU, from bit-identical seeded initial variables,
   at batch 4 x 128 with the last 40 positions of half the rows masked
   (atol 1e-4); ``save`` on the card then ``load(device="cuda")`` gives the
   same encoder_out bit for bit;
22. ``bert_step``: one FLOAT step of those MLM models, batch 4 x 128, on the
   card and on the CPU: the loss within 1e-4 relative, 99.9 % of the
   parameters within 1e-6 and every one within 2 lr + 1e-6;
23. ``bert_iterator``: ``examples/bert_finetune.py``'s flow on the card
   (``make_vocab`` over its corpus, ``BertIterator`` MLM batches of 8 x 32,
   ``Bert(BertConfig(hiddenSize=64, numLayers=2, numHeads=4,
   intermediateSize=128))``, Adam(1e-3), BFLOAT16, ``Bert.fit(it,
   epochs=2)``): the loss finite, its second epoch's mean below its
   first's.  The BERT phases 19-23 launch no kernel (counters read zero
   across each), and print each number beside the card's name and power
   limit;
24. ``lenet_mnist``: BASELINE config 1, ``examples/lenet_mnist.py``'s flow
   with the port's classes at the example's settings (conv 5x5/20, max
   pool, conv 5x5/50, max pool, dense 500, softmax 10; Adam(1e-3), XAVIER,
   seed 123): ``setListeners(ScoreIterationListener(10))``,
   ``fit(MnistDataSetIterator(128, True, 123, numExamples=4096),
   epochs=8)``, ``evaluate(MnistDataSetIterator(256, False, 123,
   numExamples=1024))``, ``ev.stats()``; ms per step, images/s and peak
   memory.  ``iterationCount`` must be 256, every score finite and the
   accuracy above 0.90 (the reference's bar on the synthetic set);
25. ``listeners``: two steps of a ``clone`` of that net with the
   score-collecting, performance and checkpoint listeners: each collected
   score equals ``score()``, and the last checkpoint restores onto the
   card with the same parameters and updater state bit for bit;
26. ``serializer``: ``ModelSerializer`` writes the trained LeNet with its
   updater state and a ``NormalizerStandardize`` and restores it on the
   card (parameters, updater state, counters and ``output`` bit-identical,
   the normalizer equal), then writes and restores the BFLOAT16 ResNet-50
   of phase 10 with its Nesterovs state (parameters, BN state, updater
   state bit-identical; one more ``fit`` step of each gives the same loss
   to 1e-6 relative); the zips' sizes and write and read seconds;
27. ``early_stopping``: ``EarlyStoppingTrainer`` on the LeNet configuration
   with ``MaxEpochsTerminationCondition(4)``,
   ``ScoreImprovementEpochTerminationCondition(2)``, a
   ``DataSetLossCalculator`` on the test iterator and a
   ``LocalFileModelSaver`` in a temporary directory: the best epoch and
   score are those of ``scoreVsEpoch``, and ``getBestModel()`` restores on
   the card and scores the best score to 1e-6 relative;
28. ``solvers_transfer``: a small MLP trained on the card by each
   line-search solver (``LBFGS``, ``CONJUGATE_GRADIENT``,
   ``LINE_GRADIENT_DESCENT``), 5 full-batch steps: every score finite, the
   last below the first; ``TransferLearning`` on the trained LeNet (frozen
   through the dense layer, a new 5-class head) keeps the frozen
   parameters bit for bit over a ``fit`` step and moves the head; and
   ``ComputationGraph.evaluate`` on ResNet-50's two batches counts 128
   examples.  Phases 24-28 launch no kernel (counters read zero across
   each);
29. ``tf_decode``: BASELINE config 3's named route,
   ``examples/bert_tf_import_finetune.py``, at BERT-base width.  The
   committed skeleton of HF ``TFBertModel(BertConfig())`` frozen at 32 x
   128 (``tests/fixtures/tf_bert_base_b32_t128_skeleton.pb``: every node,
   the 88 Consts over 4,096 bytes without their content) is read by the
   port's GraphDef decoder and held to its manifest: 1,647 nodes, each
   stripped Const's dtype and shape;
30. ``tf_import_bert``: the stripped Consts refilled from
   ``RandomState(0)`` with N(0, 0.02) (``_fill_stripped_consts``);
   ``TFGraphMapper.importGraph`` onto the card must give the reference's
   1,061 SameDiff ops of 19 kinds; ``outputSingle`` of
   ``last_hidden_state`` at 32 x 128 in FLOAT against the same graph
   imported with ``device="cpu"`` (atol below); import seconds, forward
   ms and peak memory;
31. ``tf_finetune``: the example's flow on the card: a ``cls/W`` head (768
   x 2) on the mean over the sequence, ``softmaxCrossEntropy`` against a
   ``labels`` placeholder [32, 2], ``TrainingConfig(Adam(3e-4))`` and
   ``fit(MultiDataSet)`` for 16 steps on one seeded batch: the loss must
   fall.  Its first step is also run on the CPU from the same variables
   and held as ``bert_step`` holds its step.  ms per step, tokens/s (32 x
   128 a step), peak memory and a profiled step (device time, idle share);
32. ``tf_graphrunner``: ``GraphRunner(..., backend="samediff")`` on the
   refilled graph gives phase 30's card output bit for bit.  Phases 29-32
   launch no kernel (counters read zero across each): the imported
   attention is the graph's ``BatchMatMulV2`` / ``Softmax`` chain, as in
   the reference;
33. ``serve_start``: the serving tier.  An ``InferenceServer`` on
   127.0.0.1 (an ephemeral port) with three routes: ``"lm"``, a
   ``ContinuousBatcher`` over ``TransformerLM`` at openai-community/gpt2's
   published widths (12 layers, 12 heads x 64, FFN 3072, vocab 50257,
   ``maxLen`` 1024 = n_positions; seeded random weights) with a
   speculative draft at distilbert/distilgpt2's widths (6 layers: the
   target's embeddings and its layers 0, 2, 4, 7, 9, 11), ``draftK`` 4,
   ``pageSize`` 16, ``maxSlots`` 8 (521 pages: 614,596,608 bytes of K and
   V, half that for the draft); ``"lm_group"``, ``GenerativeServing`` over
   the same LM, batch buckets 1-8 and prompt buckets 64-512; and
   ``"classifier"``, ``ForwardServing`` over ``examples/lenet_mnist.py``'s
   LeNet, batch buckets 1-32.  Prints each route's warm-up seconds, the
   pool bytes and the peak memory;
34. ``serve_requests``: 16 client threads send ``"lm"`` requests (seeded
   ragged prompts of 16-512 tokens, 32-64 new tokens, half streamed as
   NDJSON), 8 go to ``"lm_group"`` and 8 to ``"classifier"`` (1-32 rows),
   all at once: every answer must be a 200; ``/metrics`` must show as many
   ``"lm"`` sequences retired as admitted, decode tokens and no shed; one
   request's ``/v1/requests/<X-Trace-Id>`` must hold its enqueue, admit,
   first-token and retire events; ``/healthz`` must answer;
35. ``serve_check``: every ``"lm"`` (speculative) and ``"lm_group"`` answer
   against ``TransformerLM.generate`` (target-only greedy) of its prompt
   alone, equal up to the first position whose top-two logits lie within
   1e-4 (at least half the tokens must be compared); the classifier's rows
   against ``net.output`` (1e-5); one ``JsonModelServer`` round trip
   through ``JsonRemoteInference`` on the LeNet and one
   ``SameDiffJsonModelServer`` round trip on a small SameDiff graph; 8 of
   the ``"lm"`` prompts through ``"lm_self"``, a speculative route whose
   draft is the target itself, against ``generate`` by the same rule, and
   at least one draft proposal must be accepted (the random-weight draft
   of ``"lm"`` agrees with its target on none, so only this route runs
   the multi-token accept branch);
36. ``serve_replicas``: a ``ReplicaSet`` of two such batchers behind
   ``"lm"`` on the one card; ``arm_replica_crash("lm/0")`` while 8 streams
   are in flight: every stream must finish (on ``lm/1``, the only
   survivor) with ``generate``'s tokens, each token once; the failover
   counter and ``lm/0``'s health gauge must show it; then
   ``armAutoscale``'s firing edge (a backlog of 16 requests) must add a
   replica and its resolved edge take one away;
37. ``serve_timing``: 8 slots, 16 streaming clients, on the speculative
   route, on the self-drafted one and on a target-only batcher: time to first token (p50, p99),
   inter-token latency, decode tokens/s and goodput (tokens of 200 answers
   over the wall), slot occupancy, pages in use, the draft's acceptance
   rate; then 4 profiled decode steps with every slot decoding, the
   profiler started and stopped on the batcher's stepping thread
   (device time, device ops and idle share a decode step).  Phases 33-37 launch no kernel (counters
   read zero across each): the tier always masks its prefill (ROADMAP
   C2) and its decode attention is ``paged_attention``'s torch ops.  Each
   number is printed beside the card's name and power limit;
38. ``onnx_fixtures``: BASELINE config 3's model through the ONNX route
   begins with the torch-exported fixtures of ``tests/test_onnx_oracle.py``
   (``tests/fixtures/torch_{tiny_cnn,tiny_mlp,tiny_rnn,bert_mini}.onnx``)
   and the narrow BERT export ``onnx_bert_narrow_b2_t16.onnx``, each
   imported onto the card by ``OnnxImporter.importModel`` and held to
   torch's own output (the oracle's tolerances, below);
39. ``onnx_decode``: the committed skeleton of HF
   ``BertModel(BertConfig(), add_pooling_layer=False)`` exported at 32 x
   128 (``tests/fixtures/onnx_bert_base_b32_t128_skeleton.onnx``: every
   node, the raw data of the 76 initializers over 4,096 bytes dropped) is
   read by the port's ModelProto reader and held to its manifest: 639
   nodes, their op histogram, each stripped initializer's dtype and shape;
40. ``onnx_import_bert``: the stripped initializers refilled from
   ``RandomState(0)`` with N(0, 0.02) (``_fill_stripped_initializers``, the
   complete ModelProto re-encoded into a temporary file inside the
   checkout), imported by ``OnnxImporter.importModel(path)`` onto the card
   and with ``device="cpu"``: the reference's 419 SameDiff ops of 13 kinds,
   78 variables; ``outputSingle`` of ``last_hidden_state`` at 32 x 128 in
   FLOAT (int64 ids, the TF route's mask, token types 0 then 1) against
   the CPU's (atol below); import seconds, forward ms and peak memory;
41. ``onnx_finetune``: a 768 x 2 head on the CLS row,
   ``softmaxCrossEntropy``, ``TrainingConfig(Adam(3e-4))`` and
   ``fit(MultiDataSet)`` for 16 steps on one seeded batch: the loss must
   fall; its first step is also run on the CPU from the same variables
   and held as ``tf_finetune`` holds its step; ms per step, tokens/s, peak
   memory and a profiled step.  Phases 38-41 launch no kernel (counters
   read zero across each): the exported attention is the graph's
   MatMul / Softmax chain;
42. ``yolo2_train``: the zoo's main path, ``YOLO2().init()`` as the
   reference builds it (80 classes, (3, 416, 416), the five COCO priors;
   50,962,889 parameters) on the card in FLOAT, trained by
   ``ComputationGraph.fit(ListDataSetIterator, epochs=1)`` on 4 seeded
   batches of 16 synthetic images with labels in ``Yolo2OutputLayer``'s
   DL4J format (1-4 boxes an image): ``iterationCount`` 4 and finite
   scores, then one batch refit 8 times: the score must fall;
43. ``yolo2_step``: one FLOAT step at batch 2 from the same initial
   parameters on the card and on the CPU (loss and BN running statistics
   at the ResNet-50 step's tolerances, parameters at Adam's, below);
44. ``yolo2_transfer``: dl4j-examples' HouseNumberDetection flow.  The
   trained net saved by ``ModelSerializer`` as
   ``pretrained/YOLO2_IMAGENET.zip`` under a ``DL4J_TPU_DATA_DIR`` in a
   temporary directory inside the checkout, ``YOLO2().initPretrained()``
   restores it onto the card bit for bit and scores (ROADMAP C16: the
   reference's restore cannot); ``TransferLearning.GraphBuilder`` with
   ``Adam(1e-4)``, the backbone frozen through ``c21_bn``, ``pred`` and
   ``yolo`` replaced for 10 classes and the example's priors, 8 steps at
   batch 10: the frozen parameters bit-unchanged, the head moved, the
   loss finite and falling;
45. ``yolo2_timing``: ms a step and images/s at batch 16, peak memory,
   the convolutions' FLOPs and their share of the FP32 peak, one
   profiled step (device time, idle share, device ops, top kernels);
46. ``zoo_sweep``: every other ported zoo model (``SimpleCNN``,
   ``AlexNet``, ``VGG16``, ``VGG19``, ``SqueezeNet``, ``Darknet19``,
   ``TinyYOLO``, ``UNet``, ``Xception``, ``InceptionResNetV1``,
   ``NASNet``, ``FaceNetNN4Small2``, ``TextGenerationLSTM``, ``C3D``) at
   its default input shape and classes, built on the card: the output
   shape the configuration gives, one fit step at batch 2 with a finite
   score, FaceNet's embeddings of unit norm (1e-4); parameters, step ms
   and peak memory each.  Phases 42-46 launch no kernel (counters read
   zero across each): no TPU kernel is on the zoo's path.

47. ``keras_hdf5``: the port's HDF5 reader (``imports/hdf5.py``; the
   card's machine has no h5py) decodes each committed Keras fixture
   (``tests/fixtures/make_keras_fixtures.py``): the ResNet-50 skeleton, the
   transformer ``.h5`` and the ``.keras`` archive's ``model.weights.h5``;
   groups, datasets (shape, dtype, allocated) and attribute names against
   the h5py manifest the generator wrote, every dataset read;
48. ``keras_attention``: the long-context Keras transformer (``KERAS``)
   through ``KerasModelImport.importKerasModelAndWeights`` onto the card
   (a ``ComputationGraph`` with two ``KerasMultiHeadAttention``).
   Counters set to 0 just before and read just after each run: one
   inference forward on the 4 x 2048 seeded inputs launches B1 twice (once
   per block) and no backward kernel, and its pooled features and
   probabilities match keras's committed outputs (``KERAS_OUT_TOL``);
   ``fit`` on two seeded batches for 2 epochs (Adam 1e-3) launches B1, B2
   and B3 twice a step; one FLOAT step against the same step with dense
   attention forced; ms a step, tokens/s, peak memory;
49. ``keras_resnet50``: keras's ResNet-50 (25,636,712 numbers) from the
   weight-stripped skeleton, refilled by ``_keras_refill`` from its seed
   and imported by ``_build_net`` (what the entry points call) on the
   card: the forward at batch 2 against keras's committed ``avg_pool``
   features and probabilities and against the same net on the CPU
   (``KERAS_RESNET_TOL``; the refilled net's features reach ~3e4, so the
   features are held relative to their largest), ``fit`` 4 steps at batch
   32; decode s, import s, forward ms, ms a step, images/s, peak memory;
   no kernel launch (nothing dispatches B4);
50. ``keras_v3``: the narrow ``.keras`` archive onto the card against
   keras's committed outputs; its compile state gives Adam; no launch;
51. ``vae_pretrain``: dl4j-examples' ``VaeMNISTAnomaly`` (``VAE``) on
   60,000 synthetic MNIST-shaped images: ``MultiLayerNetwork.pretrain``
   one epoch (the negative ELBO of the test images, at fixed ε, must
   fall), ``reconstructionLogProbability(numSamples=16)`` of the 10,000
   test images; a stacked denoising ``AutoEncoder`` (784 -> 250 -> 10,
   corruption 0.3, xent) pretrains 20 batches a layer (its reconstruction
   error must fall), and one pretrain step of it on the card equals the
   CPU's (parameters 1e-5, the summed loss 1e-6 relative) with each
   layer's corruption mask drawn on the CPU and passed in; no launch;
52. ``attention_layers``: the other A7 layers at small widths
   (``ATTENTION_LAYERS``), card against CPU from the same parameters:
   ``SelfAttentionLayer.initCache`` / ``decodeStep`` chained against the
   causal forward, ``LearnedSelfAttentionLayer``,
   ``RecurrentAttentionLayer``; at t 1024 the recurrent layer's ``_mha``
   launches B1 once (counted).
53. ``nd4j``: the tensor layer (``NDArray``, ``Nd4j``, ROADMAP A2) on the
   card and on the CPU from the same numpy inputs: creation defaults to
   cuda; additions, products by one operand, max/min, comparisons and the
   shape ops give the same bits, ``mmul``, reductions and transcendental
   ops hold to ``ND4J_TOL``; writes through ``getRow`` /
   ``get(NDArrayIndex...)`` / ``getColumn`` views reach the parent; DOUBLE
   stays float64 through ``mmul`` and the reductions, FLOAT is the
   default; a card array's ``.npy`` bytes are the CPU array's;
   ``Nd4j.getRandom().setSeed`` repeats the card's draws; no launch;
54. ``etl_csv``: dl4j-examples' CSV route (``ETL_CSV``): a seeded
   150,000-row file parsed by ``CSVRecordReader`` (the native ``loadAll``
   and the record parse), a ``TransformProcess`` through
   ``LocalTransformExecutor`` and ``SparkTransformExecutor`` on the native
   thread pool (they must agree), the result streamed by a
   ``CSVRecordReader`` through ``RecordReaderDataSetIterator`` and
   ``NormalizerStandardize`` into ``MultiLayerNetwork.fit`` of a small
   MLP for one epoch: the native library must be loaded, ``fit`` must
   engage the producer pool (a pool batch a step, bytes staged) and the
   loss be finite; rows/s of each stage; no launch;
55. ``etl_images_resnet50``: the slice's main path (``ETL_IMAGES``): 640
   seeded 224 x 224 PNGs in label folders, ``ImageRecordReader`` (random
   flip, crop) -> ``RecordReaderDataSetIterator(64, 1000 classes)`` ->
   ``ImagePreProcessingScaler`` -> ``PrefetchingDataSetIterator`` (4
   workers, the pinned H2D ring onto cuda) -> ``ComputationGraph.fit`` of
   ResNet-50 (BFLOAT16, ``Nesterovs(0.1, 0.9)``) for one epoch.  Counters
   zeroed before and read after: no launch.  Every file is delivered once
   (count and label histogram), each batch reaches ``fit`` on cuda, the
   H2D counter grows by the epoch's bytes, the first pooled batch equals
   the first batch of one worker's shard drained inline on the CPU bit
   for bit, the loss is finite, and a step from the staged batch equals
   the step from the same batch in memory from the same parameters
   (``ETL_STEP_TOL``); decode images/s a worker, streamed and in-memory
   images/s, the ring's MB/s, a batch's pinned and pageable copy, a
   profiled streamed step's idle share, peak memory;
56. ``etl_sequences``: the long-context net (``LONG_CONTEXT``, nOut 1)
   fed 16 seeded sequence CSVs through ``CSVSequenceRecordReader`` ->
   ``SequenceRecordReaderDataSetIterator(4, regression)`` ->
   ``MultiLayerNetwork.fit`` (the pool it engages).  Counters zeroed
   before and read after must read zero: the iterator attaches a features
   mask and masked attention is dense, in both packages (ROADMAP C23);
   ms a step;
57. ``datavec_formats``: the five format readers with neither PIL nor
   pyarrow loaded: an xlsx, a sqlite table, a columnar ``.npz``, Feather
   and IPC-stream files the port wrote, and 8-, 16- and 32-bit WAVs (one
   stereo) read back; the committed fixtures (``tests/fixtures/
   arrow_lz4.feather``, pyarrow's LZ4_FRAME Feather, against its JSON
   records; ``gif_composited.gif`` against PIL's frames); then
   ``DATAVEC_FORMATS``' Speech-Commands-shaped stream (512 seeded
   one-second 16 kHz clips in 12 folders, ``AudioFeatureRecordReader
   ("mfcc", 40, frameLength 480, hop 160)`` with the folder as label,
   ``RecordReaderDataSetIterator``, the producer pool onto cuda, an MLP's
   ``fit`` for one epoch) and its clip stream (64 seeded 16-frame 64 x 64
   GIFs the port's writer wrote, ``CodecRecordReader(outputHW=(32, 32),
   ravel=True)``, ``SequenceRecordReaderDataSetIterator``, the pool, a
   ``GravesLSTM`` fit): every clip delivered on cuda, losses finite,
   clips/s decoded a worker; no launch;
58. ``dlrm_train``: ``DLRM(numFields=26, embeddingDim=128, denseUnits=
   (1024, 1024, 512, 256), numClasses=2, numEmbeddings=10_000_000)``
   (``DLRM_RUN``: MLPerf Training's DLRM widths that the zoo model
   expresses, rows cut to 10M) trained for 8 batches of 2048 seeded
   ragged records (26 bags of 1-16 Zipf ids over 1e9 values) through
   ``RaggedFeatureReader(bagBuckets=(16,))`` -> the producer pool onto
   cuda -> ``fit``: every batch on cuda, the loss finite, the collision
   counter grown (one batch read inline: the workers report nothing, as
   the reference's do); one step at 65,536 rows on the card against the
   CPU's from the same params (``DLRM_STEP_TOL``); ms a step from the
   card, examples/s, peak memory, a profiled step; no launch;
59. ``retrieval_serve``: ``TwoTowerRecommender(numEmbeddings=1_048_576,
   embeddingDim=64, bagSize=16)`` trained 4 batches from a two-field
   ragged stream, served by ``RetrievalLM.from_two_tower`` under a
   ``ContinuousBatcher``: ``topk_retrieve`` for 256 users (k 10, one
   client thread each) equals the float64 flat ranking of u · itemsᵀ
   up to near ties (``RETRIEVAL_NEAR_TIE``); k = 1 requests run no
   decode step and pass a page-deficit admission rule that sheds k = 10;
   ``recsys_hash_collision_rule`` fires on a colliding stream;
   requests/s and latency p50/p99; no launch;
60. ``samediff_ops``: every case of ``autodiff/op_cases.py`` (the 240 ops
   SameDiff gained with its control flow, at the CPU tests' shapes) on the
   card against the same graph on the CPU, held as the case says (the
   random ops by moments, and to the same draw on two card runs); the
   count that holds and the slowest five; no launch;
61. ``samediff_control_flow`` (``SD_CHAR``): BASELINE config 4's char
   model as a SameDiff graph (two ``rnn().lstmLayer(200)``, a dense
   softmax, batch 32 x 50, Adam 5e-3) trained 8 iterations by
   ``SameDiff.fit``; one step on the card against the CPU (the loss
   within 1e-4 relative, every variable within rtol 1e-4 + atol 1e-5);
   ``forLoop``
   over ``lstmCell`` against ``lstmLayer`` and a step through it;
   ``RNN_SAMPLE`` characters sampled by ``whileLoop`` (an ``ifCond`` in
   its body) equal to the CPU's up to a near tie; the sampler's zip
   restored bit for bit; ms an iteration, characters/s; no launch;
62. ``srgan_train`` (``SRGAN_RUN``): ``SRGAN`` at SRResNet's widths (16
   blocks, 24 -> 96, batch 16, Adam 1e-4) trained 8 steps by
   ``ComputationGraph.fit`` and its discriminator 8 steps by
   ``MultiLayerNetwork.fit``; ms a step, images/s, peak memory, two
   profiled steps; one generator step on the card against the CPU (the
   same limits); the
   ``ModelSerializer`` zip bit for bit; no launch;
63. ``samediff_debug``: ``execDebug`` fires its listener once per op in
   the staged order; ``stepCostAnalysis`` of the char model's step against
   its products' count; ``check_gradients`` in float64 on the card through
   ``forLoop`` and ``ifCond``; no launch;
64. ``fault_tolerance`` (``FAULT_RUN``): the long-context net of phase 6
   (BFLOAT16, t 2048, batch 4) under ``FaultTolerantTrainer
   (checkpointEveryN=2)`` for 2 epochs of 4 seeded batches, four runs,
   each with the counters at 0 before and read after: uninterrupted;
   ``PreemptAtStep(5)``, then a fresh net and trainer on the same
   directory resume from step 4; ``NaNAtStep(3)`` rolls back to step 2
   (``getLrScale()`` 0.5, the loss finite after); ``CorruptCheckpointAtStep
   (6)`` with ``PreemptAtStep(7)``, and the resume falls back to step 4.
   Both resumed runs' params and updater state must equal the
   uninterrupted run's bit for bit (else the gap is printed and held to
   ``FAULT_RESUME_ATOL``); B1, B2 and B3 must launch exactly twice for
   every step run, replays included; the checkpoint's save and restore ms
   and its MB;
65. ``fault_oom`` (``FAULT_OOM``): ResNet-50 (BFLOAT16) under the
   supervisor takes a step at batch 512, which the card cannot hold: the
   real ``torch.OutOfMemoryError`` is retried as micro-batches until a
   half fits, ``iterationCount`` rises by one,
   ``dl4j_tpu_fault_oom_retries_total`` equals the splits and the loss is
   finite; then a batch-64 step runs with no OOM and the allocated memory
   is back within 1 GB of its level before the failed step; the split
   depth, seconds, peak memory and the checkpoint's MB, save and restore
   ms; no launch;
66. ``trainobs`` (``TRAINOBS``): phases 64-65 ran under one ``run_scope``
   with a federation directory, this process's ``SnapshotWriter`` and a
   second host's snapshot.  A ``HealthMonitor(default_rules())`` given to
   the supervisor fires ``TrainingStallRule`` on a ``StallAtStep``; an
   ``InferenceServer`` started with ``DL4J_TPU_OTLP_ENDPOINT`` pointing at
   a collector the script runs on 127.0.0.1 serves ``/v1/runs/<id>/
   timeline`` (the runs' checkpoint, preemption, resume, rollback and OOM
   retry events, in hybrid-logical-clock order) and ``/metrics/federated``
   (the two hosts' step counters summed), and the collector must hold
   OTLP JSON spans on the run's trace id and the supervisor's metrics.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  With ``--record PATH`` it also
writes the full record (every check, timing and profile row) as JSON.
"""
from __future__ import annotations

import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): HBM bandwidth, bf16 and TF32 on
# the tensor cores.  Float32-accurate products run fastest as split TF32
# (x = hi + lo, hi·hi + hi·lo + lo·hi: three TF32 products each, 495/3
# TFLOP/s), above FP32 FMA on the CUDA cores (67 TFLOP/s).  Exponentials
# run on the special-function units: 16 results per clock per SM (4 per SM
# sub-partition), 132 SMs, 1.98 GHz boost clock (Hopper architecture white
# paper).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_EXPS = 16 * 132 * 1.98e9

# Main path of this slice: GPT-2 small widths (openai-community/gpt2
# config.json), cache capacity raised to 2048.
GPT2_SMALL = dict(vocabSize=50257, nLayers=12, nHeads=12, headSize=64,
                  ffnMult=4, maxLen=2048, seed=0)
BATCH, PROMPT, NEW_TOKENS = 4, 1024, 32

# Kernel checks: f32 against f32 differs only by summation order.  bf16
# outputs are the same f32 values rounded to bf16 (8 bits of mantissa), so
# a value near a rounding boundary may land one bf16 ulp apart; lse stays
# f32 in both dtypes.
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# Model checks: 12 float32 layers, flash against dense attention (or a
# KV-cached step against a full prefill), differ by summation order only.
LOGIT_ATOL = 1e-3

# Training path: bench.py bench_long_context at its widths.
LONG_CONTEXT = dict(nIn=128, nHeads=8, headSize=16, nOut=8, t=2048, batch=4,
                    seed=5, lr=1e-3)
TRAIN_EPOCHS, TRAIN_TIMED_STEPS = 2, 6
TRAIN_SHAPE = (LONG_CONTEXT["batch"], LONG_CONTEXT["nHeads"],
               LONG_CONTEXT["t"], LONG_CONTEXT["t"], LONG_CONTEXT["headSize"])
# Training-step check, FLOAT net: flash against dense attention differ by
# float32 summation order (gradients ~1e-6 apart on the card).  The loss
# holds to 1e-5.  One Adam step amplifies a gradient difference by up to
# lr / (eps / sqrt(1 - beta2)) ~ 3e3, so the updated parameters hold to
# 1e-4, a tenth of the step size lr.
TRAIN_LOSS_ATOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4

# ResNet-50 path: bench.py's configuration, batch cut from 256 to 64.
RESNET = dict(numClasses=1000, inputShape=(3, 224, 224), batch=64)
RESNET_EPOCHS, RESNET_TIMED_STEPS, RESNET_CHECK_BATCH = 2, 6, 2
# ResNet-50's 1x1 stride-1 GEMMs at batch 64, 224x224: (M, K, N) with M =
# 64·H·W of the stage, K = Cin, N = Cout.  The first is the kernels line's.
B4_RESNET_SHAPES = [
    (200704, 256, 64), (200704, 64, 64), (200704, 64, 256),
    (50176, 512, 128), (50176, 128, 512),
    (12544, 1024, 256), (12544, 256, 1024),
    (3136, 2048, 512), (3136, 512, 2048)]
B4_SHAPES = [*B4_RESNET_SHAPES, (1024, 192, 256),   # tests/test_pallas_fused
             (1000, 72, 40), (7, 16, 8),            # ragged
             (12544, 8, 3), (33, 1, 1),             # padded K and N
             (300, 36, 130)]                        # padded K and N, 2 tiles
# Two calls on the same inputs give the same bits (no atomics) here.
B4_REPEAT_SHAPES = [B4_RESNET_SHAPES[0], (300, 36, 130)]
# B4 checks: y in its own dtype — float32 by summation order, bfloat16 to
# one bf16 ulp (the same f32 value rounded once; spacing <= 2**-7 of it).
# The sums add M values in another order than the plain version's (the
# kernel: 64-row tiles, then a strided fixed tree), so they hold to a
# relative 1e-5 of Σ|y| and of Σy².
B4_Y_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
            "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}
B4_SUM_RTOL = 1e-5
# B4 on the model's activations (float32): y against cuDNN's conv (TF32
# off), summation order; the moments against BN's f32 means.
B4_ACT_TOL = dict(atol=1e-4, rtol=1e-5)
B4_MOMENT_TOL = dict(atol=1e-5, rtol=1e-4)
B4_ACT_CONVS = ["res0_1_c_conv", "res1_1_a_conv", "res2_1_c_conv",
                "res3_1_a_conv"]
# FLOAT ResNet-50 step, card against CPU: the convolutions run other
# algorithms (cuDNN with TF32 off against the CPU's), which differ by
# float32 summation order, ~1e-6 relative per layer: the loss and the BN
# running statistics (forward quantities) hold to 1e-4 relative.  The
# gradient at a batch of 2 flows back through 53 BatchNorm layers whose
# backward subtracts batch means, and that cancellation leaves the float32
# gradient of the first layers only a few percent accurate; a Nesterovs step
# at lr 0.1 then moves a parameter by 0.19 of it.  So the updated
# parameters hold to RESNET_STEP_PARAM_SHARE of the step's largest update.
RESNET_STEP_TOL = dict(atol=1e-4, rtol=1e-4)
RESNET_STEP_PARAM_SHARE = 0.1

# Recurrent path: BASELINE config 4 at the widths of dl4j-examples'
# LSTMCharModellingExample (lstmLayerSize 200, miniBatchSize 32,
# exampleLength 1000, tbpttLength 50, Adam 5e-3, l2 1e-4, XAVIER), FLOAT.
# The example reads Shakespeare's works from the network; the repo never
# fetches, so the corpus is examples/lstm_charmodelling.py's text, repeated
# to 65,000 characters: (65,000 - 1) // 1000 = 64 examples, two minibatches.
CHAR_RNN = dict(hidden=200, batch=32, length=1000, tbptt=50, lr=5e-3,
                l2=1e-4, seed=12345)
CHAR_TEXT = ("to be or not to be that is the question "
             "whether tis nobler in the mind to suffer "
             "the slings and arrows of outrageous fortune ") * 520
RNN_SAMPLE = 120            # characters of the example's sampling loop
# Card against CPU, one FLOAT TBPTT batch of 4 x 200 (4 chunks): the loss
# (mcxent summed over a chunk's 50 steps, ~200) differs by float32
# summation order, 1e-5 relative.  Adam at iteration 0 moves a parameter by
# about lr whatever its gradient's size (more over a batch's 4 chunks, which
# share the iteration), so a gradient within rounding of zero whose sign
# differs moves that parameter the other way: 99.9 % of the parameters hold
# to 1e-5, and none farther than the batch's largest update.
RNN_STEP = dict(batch=4, length=200)
RNN_LOSS_RTOL = 1e-5
RNN_PARAM_ATOL, RNN_PARAM_SHARE = 1e-5, 0.999
# rnnTimeStep against output on the card: the same ops, the input
# projection at t 1 against t 120 (other product shapes, other summation
# order): the probabilities hold to 1e-5.  The graph as against the MLN:
# the same ops in the same order, 1e-6 (the reference test's tolerance).
RNN_STEPWISE_ATOL, RNN_GRAPH_ATOL = 1e-5, 1e-6

# BASELINE config 3: BERT-base MLM through SameDiff (zoo/bert.py BertBase at
# its published widths: 12 layers, 768 = 12 heads x 64, FFN 3072, vocab
# 30522, 128 positions) on bench.py bench_bert's two seeded batches of
# 256 x 128, Adam(2e-5), BFLOAT16 compute over f32 masters.
BERT = dict(batch=256, seq=128, vocab=30522, lr=2e-5, timed_epochs=4)
# Card against CPU, one FLOAT step at batch 4: the loss (a mean over the
# masked tokens, ~10.3) differs by float32 summation order, 1e-4
# relative.  Adam's first step moves every parameter by about lr whatever
# its gradient's size, so a gradient within rounding of zero can move a
# parameter by up to lr the other way: 99.9 % of the parameters hold to
# 1e-6 and every one to 2 lr + 1e-6.  Outputs (12 float32 layers, summation
# order only) hold to 1e-4; the last 40 positions of half the rows are
# masked out of attention.
BERT_STEP_BATCH = 4
BERT_LOSS_RTOL = 1e-4
BERT_PARAM_ATOL, BERT_PARAM_SHARE = 1e-6, 0.999
BERT_OUT_ATOL, BERT_PAD = 1e-4, 40
# examples/bert_finetune.py: its corpus, vocab, iterator and model widths
BERT_EXAMPLE = dict(batch=8, seq=32, vocab=200, hidden=64, layers=2,
                    heads=4, ffn=128, lr=1e-3, epochs=2)
BERT_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a deep learning framework compiles graphs for the tpu",
    "attention layers weigh tokens by learned similarity",
    "masked language modelling predicts hidden words",
] * 16

# BASELINE config 1: examples/lenet_mnist.py at its own settings (batch 128
# over 4096 training images, 8 epochs; 1024 test images in batches of 256;
# the synthetic digit set: no MNIST files are in the repository).  The bar
# is the reference's for this network on that set
# (tests/test_multilayer.py).
LENET = dict(batch=128, n_train=4096, test_batch=256, n_test=1024,
             epochs=8, seed=123, lr=1e-3, score_every=10)
LENET_ACCURACY = 0.90
# one more step of the restored ResNet-50 against the source's: the same
# parameters, state and batch on one card give the same loss
SERDE_LOSS_RTOL = 1e-6
# early stopping on the LeNet configuration; the restored best model must
# score the recorded best score on the test iterator
ES_MAX_EPOCHS, ES_PATIENCE, ES_SCORE_RTOL = 4, 2, 1e-6
SOLVER_ALGOS = ("LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT")
SOLVER_STEPS = 5
TRANSFER_NOUT = 5

# BASELINE config 3's named route (examples/bert_tf_import_finetune.py):
# BERT-base imported from a frozen TF GraphDef.  HF TFBertModel(BertConfig())
# (the published bert-base-uncased widths) frozen at batch 32 x 128, the
# usual fine-tuning batch, with the content of its Consts over 4,096 bytes
# stripped (tests/fixtures/make_tf_bert_skeleton.py); the stripped weights
# are refilled from RandomState(seed) with N(0, 0.02), BERT's
# initializer_range.  The example's head and updater: cls/W 768 x 2,
# Adam(3e-4), 16 steps on one batch.
TF_BERT = dict(stem=os.path.join(ROOT, "tests", "fixtures",
                                 "tf_bert_base_b32_t128_skeleton"),
               nodes=1647, stripped=88, batch=32, seq=128, vocab=30522,
               hidden=768, classes=2, seed=0, std=0.02, lr=3e-4, steps=16)
# what the reference's TFGraphMapper makes of that graph
TF_BERT_OPS = {"add": 172, "all": 1, "cast": 1, "div": 12, "erfc": 12,
               "expandDims": 1, "gather": 3, "identity": 259, "lt": 1,
               "mean": 50, "mmul": 96, "mul": 112, "neg": 12, "permute": 48,
               "reshape": 193, "rsqrt": 25, "softmax": 12,
               "squaredDifference": 25, "sub": 26}
# The imported forward, card against CPU, FLOAT with TF32 off: 12 float32
# layers whose products sum in another order on each (cuBLAS against the
# CPU's BLAS), ~1e-6 relative per layer; LayerNorm keeps the hidden states
# O(1), so they hold to 1e-4, as BERT_OUT_ATOL holds the native build's.
TF_BERT_OUT_ATOL = 1e-4
# One FLOAT fine-tune step, card against CPU: as bert_step, the loss to
# 1e-4 relative; Adam's first step moves each variable by about lr
# whatever its gradient's size, so 99.9 % of the variables hold to 1e-6 and
# every one to 2 lr + 1e-6.
TF_BERT_LOSS_RTOL = 1e-4
TF_BERT_PARAM_ATOL, TF_BERT_PARAM_SHARE = 1e-6, 0.999

# BASELINE config 3's model through the ONNX route (phases 38-41): HF
# BertModel(BertConfig(), add_pooling_layer=False) with eager attention
# (the published bert-base-uncased widths), exported by torch's TorchScript
# exporter at opset 17 through a wrapper that builds the additive mask by
# broadcasting, at batch 32 x 128 (int64 input_ids, attention_mask,
# token_type_ids), with the raw data of its 76 initializers over 4,096
# bytes stripped (tests/fixtures/make_onnx_bert_skeleton.py); refilled from
# RandomState(seed) with N(0, 0.02), BERT's initializer_range.  The TF
# route's head and updater (a 768 x 2 head, Adam(3e-4), 16 steps on one
# batch), on the CLS row.
ONNX_BERT = dict(stem=os.path.join(ROOT, "tests", "fixtures",
                                   "onnx_bert_base_b32_t128_skeleton"),
                 nodes=639, stripped=76, batch=32, seq=128, vocab=30522,
                 hidden=768, classes=2, seed=0, std=0.02, lr=3e-4,
                 steps=16)
# what the reference's OnnxImporter makes of that graph
ONNX_BERT_OPS = {"add": 122, "cast": 1, "div": 24, "erf": 12,
                 "expandDims": 2, "gather": 3, "layerNorm": 25, "mmul": 96,
                 "mul": 25, "permute": 48, "reshape": 48, "softmax": 12,
                 "sub": 1}
# The torch-exported fixtures and their goldens (torch's eval forward):
# the tolerances of tests/test_onnx_oracle.py, and the narrow BERT export
# of the same generator at the CNN's
ONNX_FIXTURES = {"torch_tiny_cnn": 1e-4, "torch_tiny_mlp": 1e-4,
                 "torch_tiny_rnn": 1e-4, "torch_bert_mini": 2e-4,
                 "onnx_bert_narrow_b2_t16": 1e-4}

# The zoo (phases 42-46): YOLO2 as the reference's zoo builds it
# (zoo/models4.py YOLO2(): 80 classes, (3, 416, 416), the five COCO priors;
# 23 convolutions, the 26x26 passthrough reorganised by SpaceToDepthLayer(2))
# in FLOAT, on seeded synthetic images with DL4J-format labels: 4 batches
# of 16 through fit, a batch refit 8 times, then timed.
YOLO2_RUN = dict(batch=16, batches=4, refit=8, check_batch=2, warm=2,
                 timed=5, boxes=(1, 4), seed=0, refit_lr=1e-5)
# The zoo's own updater, Adam(1e-3), does not train YOLO2 from random
# weights: Adam's first steps move every parameter by ~lr whatever its
# gradient, the backbone's features shift along the head's weights, the
# head's wh grows and exp(wh) with it, and the loss rises until it
# overflows (the reference's does the same on the same batches;
# tests/test_torch_zoo.py holds one step of each to the other).  So the
# 4-batch fit checks finite scores only, and the descent check refits a
# copy of the initial net at Adam(1e-5), where the first steps do not
# overshoot (at 1e-4 the first step still does); that net is the one
# timed.
YOLO2_PARAMS = 50_962_889          # the reference's numParams() of YOLO2()
# The fine-tune of dl4j-examples' HouseNumberDetection: the backbone
# through c21_bn frozen, pred and yolo replaced for 10 classes and its
# priors, Adam 1e-4, 8 steps at batch 10 on one seeded batch.
YOLO2_TRANSFER = dict(numClasses=10, batch=10, steps=8, lr=1e-4,
                      frozen_through="c21_bn", seed=3,
                      priors=((2, 5), (2.5, 6), (3, 7), (3.5, 8), (4, 9)))
# The FLOAT step at batch 2, card against CPU: the loss and the BN running
# statistics at the ResNet-50 step's tolerances (RESNET_STEP_TOL).  The
# parameters: Adam's first step moves each by lr·g/(|g| + eps), lr·sign(g)
# wherever |g| is well above eps, and the backbone's float32 gradient
# carries the BatchNorm backward's cancellation noise (under 2 % relative
# L2 against float64, tests/test_torch_zoo_numerics.py), so a gradient
# inside that noise may take the other sign on the other device and move
# its parameter 2·lr away.  Every parameter within 2·lr + 1e-6, and
# YOLO2_STEP_SHARE of them within 1e-5 (the CPU test's bar).
YOLO2_STEP_SHARE = 0.98
# The rest of the zoo at each model's default inputShape and numClasses,
# built on the card and stepped once at batch 2.
ZOO_SWEEP = ("SimpleCNN", "AlexNet", "VGG16", "VGG19", "SqueezeNet",
             "Darknet19", "TinyYOLO", "UNet", "Xception", "InceptionResNetV1",
             "NASNet", "FaceNetNN4Small2", "TextGenerationLSTM", "C3D")
ZOO_SWEEP_T = 100                  # TextGenerationLSTM's sequence length
# Peak of one H100 for float32 products outside the tensor cores (TF32
# off): the convolutions' yardstick.
PEAK_FP32_CUDA_CORES = 67e12

# The serving tier (phases 33-37): an InferenceServer on 127.0.0.1 serving
# GPT-2 small at openai-community/gpt2's published widths (maxLen 1024 =
# n_positions) through a ContinuousBatcher with a speculative draft at
# distilbert/distilgpt2's widths (6 layers), a GenerativeServing group
# route over the same LM, and examples/lenet_mnist.py's LeNet as a
# classifier.  Seeded random weights; the draft copies the target's
# embeddings and layers 0, 2, 4, 7, 9, 11.
SERVE = dict(lm=dict(vocabSize=50257, nLayers=12, nHeads=12, headSize=64,
                     ffnMult=4, maxLen=1024, seed=0),
             draft_layers=(0, 2, 4, 7, 9, 11), draftK=4, pageSize=16,
             maxSlots=8, group_batch=(1, 2, 4, 8),
             group_seq=(64, 128, 256, 512), cls_batch=(1, 2, 4, 8, 16, 32),
             clients=16, prompt=(16, 512), new=(32, 64), group_requests=8,
             cls_requests=8, cls_rows=(1, 32), replica_streams=8,
             replica_slowdown=0.02, autoscale_rows=4, backlog_new=8,
             self_draft_requests=8, timing_clients=16, profile_steps=4,
             device="cuda", seed=7)
# Tokens are held to generate's up to the first position whose top-two
# logits lie within SERVE_NEAR_TIE (float32 summation order may decide a
# closer tie either way); served outputs of one model on one card to 1e-5.
SERVE_NEAR_TIE = 1e-4
SERVE_OUT_ATOL = 1e-5

# Keras import (phases 47-52).  The committed fixtures, written by
# tests/fixtures/make_keras_fixtures.py with keras and h5py (neither is on
# the card's machine; the port reads them with its own HDF5 reader):
# - keras.applications.ResNet50(weights=None) (224 x 224 x 3, 1000 classes,
#   25,636,712 parameters) saved as .h5 with every dataset left
#   unallocated, refilled here by _keras_refill from resnet_seed, and
#   keras's avg_pool features and probabilities for that refill on
#   RandomState(resnet_input_seed) normal images of batch 2;
# - the long-context Keras transformer: keras.io's "Text classification
#   with Transformer" block (MultiHeadAttention, Dropout 0.1, Add,
#   LayerNormalization 1e-6, Dense ff relu, Dense d, Dropout 0.1, Add,
#   LayerNormalization 1e-6) at the widths of bench.py's long-context net
#   (input (2048, 128), 2 blocks, 8 heads of key_dim 16, ff 256), then
#   GlobalAveragePooling1D and Dense(10, softmax); keras's own random
#   weights from keras_seed, with keras's probabilities and pooled
#   features on RandomState(transformer_input_seed) normal inputs of 4;
# - a narrow .keras archive (Conv1D, MultiHeadAttention, LayerNormalization,
#   Bidirectional LSTM, pooling, Dense softmax) with keras's outputs;
# - an h5py manifest of each HDF5 file (groups, datasets, attributes).
KERAS = dict(fixtures=os.path.join(ROOT, "tests", "fixtures"),
             resnet="keras_resnet50_skeleton.h5",
             transformer="keras_transformer_t2048.h5",
             v3="keras_narrow_v3.keras", io="keras_fixtures_io.npz",
             manifest="keras_fixtures_manifest.json",
             resnet_params=25_636_712, resnet_seed=0, resnet_input_seed=1,
             resnet_batch=2, resnet_train_batch=32, resnet_train_steps=4,
             t=2048, d=128, heads=8, key_dim=16, ff=256, blocks=2,
             classes=10, batch=4, keras_seed=5, transformer_input_seed=2,
             train_seed=3, train_epochs=2, v3_input_seed=4,
             v3_shape=(2, 16, 8))
# The ResNet-50 forward against keras's: the avg_pool features and the
# probabilities, each |ours - keras| <= atol + rtol·|keras| (float32
# through 53 convolutions in a different order, and the card's float32
# products with TF32 off); the transformer's and the narrow archive's
# outputs the same way.
KERAS_RESNET_TOL = dict(atol=1e-4, rtol=1e-3)
KERAS_OUT_TOL = dict(atol=2e-5, rtol=1e-4)
# dl4j-examples' VaeMNISTAnomaly: VariationalAutoencoder(784 -> 32,
# encoder and decoder (256, 256), leakyrelu, bernoulli reconstruction),
# Adam(1e-3), XAVIER, l2 1e-4, batch 128, one pretrain epoch over 60,000
# MNIST-shaped images, then reconstructionLogProbability(numSamples=16)
# over the 10,000 test images; the stacked denoising AutoEncoder of
# dl4j-examples' deep autoencoder family, 784 -> 250 -> 10, corruption
# 0.3, xent.
VAE = dict(nIn=784, nOut=32, hidden=(256, 256), lr=1e-3, l2=1e-4,
           batch=128, n_train=60_000, n_test=10_000, samples=16, seed=12345,
           ae_sizes=(250, 10), ae_corruption=0.3, ae_steps=20)
# The other A7 layers at small widths, card against CPU; the recurrent
# attention layer at t 1024 reaches B1 through its _mha.
ATTENTION_LAYERS = dict(nIn=32, nHeads=4, headSize=8, nOut=32, t=64,
                        batch=3, nQueries=5, long_t=1024, seed=9)
ATTENTION_TOL = dict(atol=1e-4, rtol=1e-4)
# The tensor layer on the card (ROADMAP A2): NDArray / Nd4j on seeded numpy
# inputs, card against CPU.  Additions, products by one operand, max/min,
# comparisons and the shape ops give the same bits; a transcendental
# function, a float32 product (TF32 off: cuBLAS against the CPU's BLAS)
# and a reduction hold to ND4J_TOL, rtol relative to the result's largest
# magnitude (another rounding or summation order).
ND4J = dict(m=256, k=384, n=192, seed=17)
ND4J_TOL = dict(atol=1e-5, rtol=1e-5)
# dl4j-examples' CSV route at 150,000 rows: four doubles, an integer-coded
# category of three states and a label of three classes, through a
# TransformProcess (the category one-hot, a filter, a math op), written
# out and read back by a streaming CSVRecordReader into a small MLP.
ETL_CSV = dict(rows=150_000, batch=500, hidden=32, lr=1e-2, seed=21)
# The image pipeline at ResNet-50's width: 640 seeded 224 x 224 RGB PNGs in
# 10 label folders (written by the port's own PNG writer), decoded by 4
# producer workers with a random flip and a crop of up to 16 pixels an
# edge, scaled to [0, 1], staged onto the card through the pinned ring,
# into bench.py's ResNet-50 (BFLOAT16, its zoo updater Nesterovs(0.1, 0.9))
# for one epoch.  Record sharding gives each worker 160 files, batched
# 64 + 64 + 32: 12 steps.
ETL_IMAGES = dict(n=640, classes=10, hw=224, batch=64, workers=4, crop=16,
                  seed=23, shm_mb=64)
# A step from a staged batch against the same step from the same batch as
# an in-memory DataSet, from the same copied parameters (BFLOAT16 compute):
# the inputs are the same bits, so only cuDNN's choice among kernels
# (benchmark mode off) can part them; the loss holds to 1e-2 relative and
# every parameter to 1e-2 (a bf16 step at lr 0.1).
ETL_STEP_TOL = dict(loss_rtol=1e-2, param_atol=1e-2)
# The long-context attention net (LONG_CONTEXT, BFLOAT16) fed by DataVec:
# 16 seeded sequence CSV files of 2048 steps x (128 features + 1 label),
# CSVSequenceRecordReader -> SequenceRecordReaderDataSetIterator(batch 4,
# regression) -> MultiLayerNetwork.fit (the pool that fit engages, C22);
# the regression head has nOut 1 (the iterator's one label column).
ETL_SEQ = dict(files=16, batch=4, seed=29)

# Item 57: DataVec's format readers on the card's machine (no PIL, no
# pyarrow).  The audio stream has Speech Commands' shape (one-second 16 kHz
# 16-bit clips in 12 label folders; 40 MFCCs over 30 ms windows every
# 10 ms: 98 x 40 features a clip); the clip stream 64 GIFs of 16 frames at
# 64 x 64, resized to 32 x 32 and raveled.  Neither dataset is in the
# repository: the clips are seeded synthetic ones at those shapes.
DATAVEC_FORMATS = dict(
    seed=31,
    speech=dict(n=512, classes=12, rate=16000, seed=37, mfcc=40, frame=480,
                hop=160, batch=32, hidden=256, workers=4),
    clips=dict(n=64, classes=8, frames=16, hw=64, seed=41,
               outputHW=(32, 32), batch=8, hidden=64, workers=4))
# Item 58: DLRM at the widths of MLPerf Training's DLRM (Criteo 1TB) that
# the zoo model expresses: 26 categorical fields, embedding 128, top MLP
# 1024-1024-512-256, 2 classes (the zoo model has no bottom MLP and no
# dense features).  Rows cut from MLPerf's 40M to 10M: ids ride as float32
# features, exact only to 2**24, and the table with its dense gradient and
# Adam moments is ~20.5 GB.  Records: 1-16 raw ids a bag, Zipf(1.2) over
# 1e9 values (Criteo's skew; the data is seeded, not Criteo's).
DLRM_RUN = dict(fields=26, dim=128, dense=(1024, 1024, 512, 256),
                rows=10_000_000, batch=2048, batches=8, max_bag=16,
                zipf=1.2, raw_values=10 ** 9, seed=43, workers=4, shm_mb=64,
                check_rows=65_536, lr=1e-3)
# A DLRM step on the card against the CPU's from the same params, one
# ragged batch at 65,536 rows: the loss to 1e-4 relative.  Adam's first
# step moves a parameter by lr g / (|g| + 1e-8), about lr times the sign
# of g, which flips or shrinks where the float32 gradient is noise near
# eps (on the H100, 3.6 % of the parameters land past 1e-6 with the loss
# equal): every parameter within 2 lr, 98 % within 1e-5, as YOLO2's
# step.  The gradient's difference is printed beside them.
DLRM_STEP_TOL = dict(loss_rtol=1e-4, share=0.98)
# Item 59: two-tower retrieval served through the batcher.
RETRIEVAL = dict(rows=1_048_576, dim=64, bag=16, batch=1024, batches=4,
                 seed=47, maxLen=64, page=16, slots=32, users=256, k=10,
                 single=32)
# Ranks whose float64 score gap to the next is under this share of the top
# score are near ties (the card's float32 sums may order them either way):
# the comparison of a user stops there.
RETRIEVAL_NEAR_TIE = 1e-6

# SameDiff finished (phases 60-63).  ``samediff_ops``: every case of
# autodiff/op_cases.py (the 240 ops of the control-flow slice at the CPU
# tests' small shapes) on the card against the same graph on the CPU, held
# as each case says (float32 with TF32 off at rtol 1e-4 / atol 1e-5, the
# linear algebra at rtol 1e-3 or by its identities, integers exactly; the
# random ops draw on the card's generator: held by shape, dtype and moments
# against the CPU's draw, and to the same draw on each of their two runs).
# ``samediff_control_flow``: BASELINE config 4's character model written as
# a SameDiff graph at CHAR_RNN's widths (two rnn().lstmLayer of 200,
# time-major as the reference's op takes it, a dense softmax over the
# vocabulary), batch 32 x 50 characters (config 4's TBPTT length: SameDiff
# has no TBPTT), Adam 5e-3, FLOAT, trained for 8 iterations by
# SameDiff.fit; the same forward by forLoop over lstmCell (one step trained
# through it); RNN_SAMPLE characters sampled greedily by whileLoop for
# SD_CHAR["rows"] primers (its body: two lstmCells, the softmax, the
# argmax, an ifCond that feeds the primer or the sample); the zip of the
# sampler, regions and all, restored.
SD_CHAR = dict(hidden=200, batch=32, length=50, lr=5e-3, seed=12345,
               iters=8, rows=4, primer=6)
SD_STEP_RTOL = 1e-4         # every variable after a step, card vs CPU,
SD_STEP_ATOL = 1e-5         # within atol + rtol·|CPU's|
SD_FORLOOP_ATOL = 1e-5
SD_SAMPLE_NEAR_TIE = 1e-4
# ``srgan_train``: SRGAN at SRResNet's published widths (Ledig et al. 2017:
# 16 residual blocks of 64 channels, 256 before each of the two x2 pixel
# shuffles, 24 x 24 LR patches to 96 x 96 HR), batch 16, Adam(1e-4), FLOAT;
# the reference zoo's default depth is 4.  No DIV2K or ImageNet in the
# repo: seeded smooth HR images, LR their 4 x 4 average pool, both in
# [-1, 1].  The generator trains 8 steps by ComputationGraph.fit, the
# discriminator 8 by MultiLayerNetwork.fit on HR (1) and the generator's
# outputs (0); one generator step on the card against the CPU.
SRGAN_RUN = dict(inputShape=(3, 24, 24), blocks=16, upscale=4, batch=16,
                 steps=8, seed=7, profiled=2)
SRGAN_STEP_RTOL = 1e-4      # the loss, and every parameter after a step
SRGAN_STEP_ATOL = 1e-5      # within atol + rtol·|CPU's|

# Training fault tolerance (FaultTolerantTrainer) on the long-context net
# (LONG_CONTEXT, BFLOAT16): 2 epochs of 4 seeded batches, a sealed
# checkpoint every 2 steps.  The runs: uninterrupted; preempted before
# step 5 and resumed; NaN features at step 3 (rolled back); the newest
# checkpoint (step 6) corrupted, then preempted before step 7 and resumed
# from step 4.  A resumed run's params are held bit for bit against the
# uninterrupted run's; should they differ, within FAULT_RESUME_ATOL.
FAULT_RUN = dict(epochs=2, batches=4, every=2, preempt=5, nan=3,
                 corrupt=6, corrupt_preempt=7)
FAULT_RESUME_ATOL = 1e-6
# A real CUDA OOM: ResNet-50 (BFLOAT16) peaks at 18.72 GB at batch 64
# (PERF.md §6), ~0.29 GB an example, so batch 512 asks ~150 GB of the
# 80 GB card; the supervisor halves it until a half fits (at most 3
# times), then a batch-64 step must run with no OOM and leave the
# allocated memory within 1 GB of its level before the failed step.
FAULT_OOM = dict(batch=512, after=64, splits=3, mem_slack=1 << 30)
# trainobs: the watchdog's stall rule (default_rules' TrainingStallRule
# with a 0.5 s timeout, evaluated every 0.1 s) against StallAtStep's 1.5 s
# freeze; a second host's snapshot adds 5 steps to the federated sum.
TRAINOBS = dict(stall_step=2, stall_s=1.5, stall_timeout=0.5,
                monitor_interval=0.1, peer_steps=5)


def _keras_refill(name, shape, rng):
    """The seeded value of an unallocated keras weight, by its last path
    component: kernels N(0, sqrt(2 / fan_in)) (fan_in the product of all
    but the last dimension), biases 0.01·N, BatchNormalization gamma
    1 + 0.1·N, beta 0.1·N, moving mean 0.1·N and moving variance
    U(0.5, 1.5); float32."""
    import numpy as np
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    elif leaf == "bias":
        v = 0.01 * rng.standard_normal(shape)
    elif leaf == "gamma":
        v = 1.0 + 0.1 * rng.standard_normal(shape)
    elif leaf in ("beta", "moving_mean"):
        v = 0.1 * rng.standard_normal(shape)
    elif leaf == "moving_variance":
        v = rng.uniform(0.5, 1.5, shape)
    else:
        raise ValueError(f"no refill rule for the keras weight {name!r}")
    return v.astype(np.float32)


def _keras_refill_all(datasets, seed):
    """``{path: array}`` for ``(path, shape)`` pairs in the file's visit
    order, drawn from one ``RandomState(seed)`` in that order."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return {path: _keras_refill(path, tuple(shape), rng)
            for path, shape in datasets}


def _keras_path(key):
    return os.path.join(KERAS["fixtures"], KERAS[key])


class _RefilledStore:
    """A keras ``.h5``'s weights by layer (``model_weights/<layer>``, in
    ``weight_names`` order), each unallocated dataset's from ``filled``."""

    def __init__(self, f, filled):
        self.root, self.filled = f["model_weights"], filled

    def get(self, layer_name):
        import numpy as np
        if layer_name not in self.root:
            return []
        g = self.root[layer_name]
        out = []
        for n in g.attrs.get("weight_names"):
            ds = g[n.decode() if isinstance(n, bytes) else n]
            path = ds.name.lstrip("/")
            out.append(self.filled[path] if path in self.filled
                       else np.asarray(ds))
        return out


def _keras_resnet_import(device=None, timing=None):
    """The committed ResNet-50 skeleton decoded by the port's reader, its
    unallocated datasets refilled (``_keras_refill_all``, visit order,
    ``resnet_seed``), and the importer's ``_build_net`` (the function the
    public entry points call) on ``device``: ``(file, filled, net)``.
    ``timing``, a dict, gets the decode and import seconds."""
    from deeplearning4j_tpu_torch.imports import hdf5
    from deeplearning4j_tpu_torch.imports.keras_import import _build_net
    t0 = time.perf_counter()
    f = hdf5.File(_keras_path("resnet"))
    stripped = []
    f.visititems(lambda n, o: stripped.append((n, o.shape))
                 if isinstance(o, hdf5.Dataset) and not o.allocated
                 else None)
    filled = _keras_refill_all(stripped, KERAS["resnet_seed"])
    cfg = json.loads(f.attrs["model_config"])
    t1 = time.perf_counter()
    net = _build_net(cfg["class_name"], cfg["config"],
                     cfg["config"]["layers"], _RefilledStore(f, filled),
                     None, device=device)
    if timing is not None:
        timing["decode_s"] = t1 - t0
        timing["import_s"] = time.perf_counter() - t1
    return f, filled, net


SERVE_SHAPE = (BATCH, GPT2_SMALL["nHeads"], PROMPT, PROMPT,
               GPT2_SMALL["headSize"])
SMALL_SHAPES = [  # (b, h, tq, tk, d)
    (2, 3, 1000, 1000, 64),     # ragged q and k tiles
    (1, 2, 333, 515, 128),      # tq != tk, widest head
    (1, 2, 16, 16, 8),          # smaller than one tile
    (1, 3, 300, 200, 12),       # bf16 rows of 24 bytes: the padded layout
    (2, 2, 257, 513, 32),       # tq != tk, 64-byte rows
]
KERNEL_SHAPES = [SERVE_SHAPE, TRAIN_SHAPE, *SMALL_SHAPES]
BWD_SHAPES = [TRAIN_SHAPE, *SMALL_SHAPES]
# Gradient check: FlashAttention's dq, dk, dv against autograd through
# dense attention, float32 (summation order only).
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


class PhaseFailed(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def _max_err(a, b, atol, rtol):
    """(max |a-b|, whether every |a-b| <= atol + rtol*|b|)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all()) and \
        bool(a.isfinite().all())
    return float(diff.max()), ok


def _time_ms(torch, fn, iters=40, warmup=3):
    """Median device time of one call: CUDA events around each of four runs
    of iters/4 back-to-back calls, over the count (the host's latency to
    the first launch of a run is paid once a run, not once a call; warm:
    inputs are left in the 50 MB L2 as the producing layer would leave
    them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n, times = max(1, iters // 4), []
    for _ in range(4):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def _device_ms(torch, fn, n=20, tries=3):
    """Device time of one call: the device busy time of n calls of ``fn``
    under the profiler (``_device_breakdown``), over the count.  Unlike
    ``_time_ms`` it leaves out the host's time between launches, so a short
    kernel behind a Python wrapper is timed alone.  A trace that comes back
    without device time is taken again, up to ``tries`` times; None if
    none has any."""
    fn()
    for _ in range(tries):
        busy = _device_breakdown(
            torch, lambda: [fn() for _ in range(n)])["device_busy_ms"]
        if busy:
            return busy / n
    return None


def _bound(flops, exps, nbytes, dtype_name):
    """Least time for work of ``flops`` matrix-product FLOPs in
    ``dtype_name`` and ``exps`` exponentials that must move ``nbytes``:
    the larger of the bytes over HBM bandwidth and the operations over
    their units' peak rates (products and exponentials run on different
    units, so the slower of the two).  Returns (ms, "bytes"|"operations")."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS[dtype_name], exps / PEAK_EXPS)
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem > t_ops else "operations")


def _pairs(tq, tk, causal):
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def _attention_bound(b, h, tq, tk, d, causal, dtype_name, elem):
    """Least time for one attention forward (B1): q, k, v read once, O and
    the f32 lse written once; 2 FLOPs per multiply-add in QKᵀ and in PV and
    one exponential per score, visible pairs only when causal.  Returns
    (ms, "bytes"|"operations", flops, bytes)."""
    pairs = _pairs(tq, tk, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * elem + b * h * tq * 4
    return (*_bound(flops, b * h * pairs, nbytes, dtype_name), flops,
            nbytes)


def _bwd_bound(kernel, b, h, tq, tk, d, causal, dtype_name, elem):
    """Least time for one flash-backward pass: q, dO (b·h·tq·d), k, v
    (b·h·tk·d) and the f32 lse and delta rows read once, the pass's outputs
    (dq, or dk and dv) written once; 2 FLOPs per multiply-add in each of
    the pass's products (3 for dq: QKᵀ, dO·Vᵀ, dS·K; 4 for dk/dv: QKᵀ,
    dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) and one exponential per score, visible pairs
    only when causal.  Returns (ms, "bytes"|"operations", flops, bytes)."""
    pairs = _pairs(tq, tk, causal)
    products, out_elems = {"dq": (3, b * h * tq * d),
                           "dkv": (4, 2 * b * h * tk * d)}[kernel]
    flops = 2.0 * products * b * h * d * pairs
    nbytes = ((2 * b * h * tq * d + 2 * b * h * tk * d + out_elems) * elem
              + 2 * b * h * tq * 4)
    return (*_bound(flops, b * h * pairs, nbytes, dtype_name), flops,
            nbytes)


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "STL", "LDL")


def _cuobjdump():
    """cuobjdump from the CUDA toolkit, or the copy in Triton's package;
    None where neither is present."""
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands = [shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.path.isfile(c)), None)


def _sass_counts(tool, lib):
    """{kernel: {op: count}} of a library's SASS for the ops in SASS_OPS:
    HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA load), UTMASTG (TMA
    store), STL/LDL (local memory: spills or local arrays)."""
    import re
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300).stdout
    pat = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            m = pat.search(line)
            if m:
                counts[fn][m.group(1)] += 1
    return {_readable(n): c for n, c in counts.items()}


def _readable(mangled):
    """``flash_fwd_kernel<float, 64>`` for a mangled kernel name, through
    c++filt where it is present; the mangled name otherwise."""
    import shutil
    tool = shutil.which("c++filt")
    if tool is None:
        return mangled
    name = subprocess.run([tool, mangled], capture_output=True, text=True,
                          timeout=60).stdout.strip() or mangled
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ")


def phase_build(rec):
    import re
    from deeplearning4j_tpu_torch import kernels
    t0 = time.perf_counter()
    built = kernels.build()
    rec["build_s"] = time.perf_counter() - t0
    print(f"build: {sorted(built)} in {rec['build_s']:.1f} s")
    # Every source's compiler output, this run's or the one kept beside an
    # earlier build's library.
    libs = {src.stem: kernels._target(src)
            for src in sorted(kernels.CSRC.glob("*.cu"))}
    logs = {name: built.get(name) or lib.with_suffix(".log").read_text()
            for name, lib in libs.items()}
    rec["ptxas"] = {name: [ln.strip()[:160] for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "GMMA" in ln.upper()]
                    for name, log in logs.items()}
    rec["spills"] = {name: [int(n) for ln in log.splitlines()
                            if "spill" in ln
                            for n in re.findall(r"(\d+) bytes spill", ln)]
                     for name, log in logs.items()}
    for name, lines in rec["ptxas"].items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}")
    # Instruction evidence: which kernels run on the tensor cores and TMA.
    tool = _cuobjdump()
    rec["sass"] = {}
    for name, lib in libs.items():
        if tool is None:
            print(f"  sass {name}: not measured (no cuobjdump)")
            continue
        rec["sass"][name] = counts = _sass_counts(tool, str(lib))
        for fn, c in counts.items():
            print(f"  sass {name} {fn}: " + ", ".join(
                f"{op} {n}" for op, n in c.items()))


# The tensor-core kernels' instantiations that the sass gate holds: the
# name part that marks them and how many each source has.  B1-B3: {float,
# bfloat16} x head dims {16, 32, 64, 128}; B4's GEMM: {float, bfloat16} x
# tile widths {64, 128} (its column_sum_kernel and split_transpose_kernel
# run no product and are left out by name).
GATED = {**{name: ("kernel", 8) for name in ("flash_attn_fwd",
                                             "flash_attn_bwd_dq",
                                             "flash_attn_bwd_dkv")},
         "matmul_bn_stats": ("mm_bn_tile_kernel", 4)}


def phase_sass(rec):
    """The tensor-core kernels' build evidence: every instantiation of B1,
    B2 and B3 and of B4's GEMM issues wgmma (HGMMA) and TMA loads (UTMALDG)
    and touches no local memory (STL/LDL), and ptxas reports no spill in
    their sources."""
    bad = []
    for name, (mark, expected) in GATED.items():
        counts = rec["sass"].get(name)
        if not counts:
            bad.append(f"{name}: no SASS counts (no cuobjdump)")
            continue
        kern = {fn: c for fn, c in counts.items() if mark in fn}
        if len(kern) != expected:
            bad.append(f"{name}: {len(kern)} {mark} instantiations, "
                       f"expected {expected}")
        for fn, c in kern.items():
            if not (c["HGMMA"] > 0 and c["UTMALDG"] > 0
                    and c["STL"] == c["LDL"] == 0):
                bad.append(f"{fn}: {c}")
        spills = rec["spills"][name]
        if not spills:
            bad.append(f"{name}: no ptxas spill report")
        elif any(spills):
            bad.append(f"{name}: ptxas spills (stores, loads) {spills}")
    rec["sass_ok"] = not bad
    print(f"sass/ptxas gate over {', '.join(GATED)}: "
          f"{'ok' if not bad else bad}")
    _require(not bad, f"a tensor-core kernel is not on wgmma + TMA without "
                      f"spills: {bad}")


def phase_c6(torch, rec):
    """The auto dispatch at shapes the flash kernels refuse (ROADMAP C6):
    head size 256 and float16 at t 1024 run dense, bit for bit the dense
    result, with no kernel launch; an explicit impl="flash" raises there.
    Then a user's layer at such a shape: SelfAttentionLayer(nHeads=1,
    nOut=256) forward at t 1024 on the card, against dense forced."""
    import deeplearning4j_tpu_torch.nn.conf.attention as amod
    from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    for name, shape, dtype in (("d256", (1, 2, 1024, 256), torch.float32),
                               ("float16", (1, 2, 1024, 64), torch.float16)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        _reset_counters()
        out = dot_product_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        counts = _counters()
        ref = dot_product_attention(q, k, v, causal=True, impl="dense")
        try:
            dot_product_attention(q, k, v, causal=True, impl="flash")
            raised = None
        except (TypeError, ValueError) as e:
            raised = type(e).__name__
        res[name] = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                         equal_dense=bool(torch.equal(out, ref)),
                         launches=counts, flash_raised=raised)
        print(f"C6 auto {name} {list(shape)}: equal to dense "
              f"{res[name]['equal_dense']}, launches {counts}, "
              f"impl='flash' raised {raised}")
        _require(res[name]["equal_dense"] and not any(counts.values())
                 and raised, f"C6 {name}: {res[name]}")
    layer = amod.SelfAttentionLayer(nIn=64, nHeads=1, headSize=256,
                                    nOut=256)
    params = layer.initParams(torch.Generator().manual_seed(8), None,
                              device="cuda")
    x = torch.randn((2, 64, 1024), generator=gen, device="cuda")
    _reset_counters()
    out, _ = layer.forward(params, x, False, None, {})
    torch.cuda.synchronize()
    counts = _counters()
    orig = amod.dot_product_attention
    amod.dot_product_attention = _forced_dense(orig)
    try:
        ref, _ = layer.forward(params, x, False, None, {})
    finally:
        amod.dot_product_attention = orig
    res["layer_nOut256"] = dict(equal_dense=bool(torch.equal(out, ref)),
                                launches=counts,
                                shape=list(out.shape))
    print(f"C6 SelfAttentionLayer(nHeads=1, nOut=256) at t 1024: output "
          f"{list(out.shape)}, equal to dense {res['layer_nOut256']}")
    rec["c6"] = res
    _require(res["layer_nOut256"]["equal_dense"] and not any(counts.values())
             and tuple(out.shape) == (2, 256, 1024),
             f"C6 layer: {res['layer_nOut256']}")


def phase_kernels(torch, rec):
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, failed = [], []
    for (b, h, tq, tk, d) in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q = torch.randn((b, h, tq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype)
            for causal in (False, True):
                out, lse = flash_forward(q, k, v, causal)
                ref_out, ref_lse = flash_attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                e_o, ok_o = _max_err(out, ref_out, **TOL[dn])
                e_l, ok_l = _max_err(lse, ref_lse, **LSE_TOL)
                c = dict(shape=[b, h, tq, tk, d], dtype=dn, causal=causal,
                         out_err=e_o, lse_err=e_l, ok=ok_o and ok_l)
                checks.append(c)
                print(f"flash {c['shape']} {dn:8s} causal={causal!s:5s} "
                      f"|dO|max={e_o:.3g} |dlse|max={e_l:.3g} "
                      f"{'ok' if c['ok'] else 'MISMATCH'}")
                if not c["ok"]:
                    failed.append(c)
    print(f"tolerances: float32 O {TOL['float32']}, bfloat16 O "
          f"{TOL['bfloat16']} (both round one f32 value to bf16; a "
          f"rounding-boundary flip is one bf16 ulp), lse {LSE_TOL}")
    rec["kernel_checks"] = checks
    _require(not failed, f"flash kernel disagrees with its plain version: "
                         f"{failed}")


def phase_bwd_kernels(torch, rec):
    """B2 (dq) and B3 (dk/dv) against their plain versions on the same
    inputs, lse from B1 and delta = rowsum(dO⊙O) as the backward computes
    it.  Tolerances as B1's: float32 differs by summation order only; in
    bf16 p and ds are rounded at the same points in both, and the outputs
    are f32 sums rounded to bf16 (a rounding-boundary flip is one ulp)."""
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference, flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks, failed = [], []
    for (b, h, tq, tk, d) in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, do = (torch.randn((b, h, tq, d), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((b, h, tk, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            for causal in (False, True):
                out, lse = flash_forward(q, k, v, causal)
                delta = (do.float() * out.float()).sum(-1).reshape(
                    b * h, tq)
                args = (q, k, v, do, lse, delta, causal)
                got = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
                ref = (flash_bwd_dq_reference(*args),
                       *flash_bwd_dkv_reference(*args))
                torch.cuda.synchronize()
                errs = [_max_err(g, r, **TOL[dn]) for g, r in zip(got, ref)]
                c = dict(shape=[b, h, tq, tk, d], dtype=dn, causal=causal,
                         dq_err=errs[0][0], dk_err=errs[1][0],
                         dv_err=errs[2][0], ok=all(ok for _, ok in errs))
                checks.append(c)
                print(f"flash bwd {c['shape']} {dn:8s} causal={causal!s:5s}"
                      f" |ddq|max={c['dq_err']:.3g} |ddk|max="
                      f"{c['dk_err']:.3g} |ddv|max={c['dv_err']:.3g} "
                      f"{'ok' if c['ok'] else 'MISMATCH'}")
                if not c["ok"]:
                    failed.append(c)
    print(f"tolerances: float32 {TOL['float32']}, bfloat16 "
          f"{TOL['bfloat16']}")
    rec["bwd_kernel_checks"] = checks
    _require(not failed, f"a flash backward kernel disagrees with its plain"
                         f" version: {failed}")


def phase_grad(torch, rec):
    """FlashAttention's gradients (B1 forward, B2 and B3 backward) against
    torch.autograd through dense attention, float32."""
    from deeplearning4j_tpu_torch.parallel.ring import (
        dot_product_attention, flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, ok = {}, True
    for (b, h, tq, tk, d), causal in ((TRAIN_SHAPE, False),
                                      (SMALL_SHAPES[0], True)):
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda")
                for _ in range(2))
        g = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        qkv = [x.requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*qkv, causal=causal), qkv,
                                  g)
        ref = torch.autograd.grad(dot_product_attention(
            *qkv, causal=causal, impl="dense"), qkv, g)
        res = [_max_err(x, y, **GRAD_TOL) for x, y in zip(got, ref)]
        key = f"{[b, h, tq, tk, d]} causal={causal}"
        errs[key] = [e for e, _ in res]
        ok = ok and all(o for _, o in res)
        print(f"flash grad vs dense {key}: |d(dq,dk,dv)|max = "
              f"{', '.join(f'{e:.3g}' for e, _ in res)} ({GRAD_TOL}, "
              f"float32 summation order)")
    rec["grad_vs_dense"] = errs
    _require(ok, f"flash gradients disagree with dense autograd: {errs}")


def _gpt2_model(torch):
    from deeplearning4j_tpu_torch.nlp.transformer import (
        TransformerLM, TransformerLMConfig)
    import numpy as np
    lm = TransformerLM(TransformerLMConfig(**GPT2_SMALL))
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, GPT2_SMALL["vocabSize"],
                          (BATCH, PROMPT)).astype(np.int32)
    return lm, prompts


FLASH = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def _counters():
    from deeplearning4j_tpu_torch.ops.fused import matmul_bn_stats
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    return {"flash_attn_fwd": flash_attention.launches,
            "flash_attn_bwd_dq": flash_bwd_dq.launches,
            "flash_attn_bwd_dkv": flash_bwd_dkv.launches,
            "matmul_bn_stats": matmul_bn_stats.launches}


def _reset_counters():
    from deeplearning4j_tpu_torch.ops.fused import matmul_bn_stats
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    flash_attention.launches = flash_bwd_dq.launches = \
        flash_bwd_dkv.launches = matmul_bn_stats.launches = 0


def phase_main_path(torch, rec, lm, prompts):
    from deeplearning4j_tpu_torch.parallel.ring import flash_attention
    import numpy as np
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    out = lm.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    rec["generate_s"] = time.perf_counter() - t0
    rec["launches"] = counts = _counters()
    launches = counts["flash_attn_fwd"]
    print(f"generate {BATCH}x{PROMPT} -> {out.shape} in "
          f"{rec['generate_s']:.3f} s; launches {counts}")
    _require(out.shape == (BATCH, NEW_TOKENS),
             f"generate returned shape {out.shape}")
    _require(bool(((out >= 0) & (out < GPT2_SMALL["vocabSize"])).all()),
             "generated token ids out of range")
    _require(launches == GPT2_SMALL["nLayers"],
             f"prefill launched the flash kernel {launches} times, expected "
             f"{GPT2_SMALL['nLayers']} (one per layer)")
    _require(counts["flash_attn_bwd_dq"] == counts["flash_attn_bwd_dkv"]
             == counts["matmul_bn_stats"] == 0,
             f"serving launched a backward kernel or B4: {counts}")

    lengths = np.array([PROMPT, 1000, 900, 512])
    padded = prompts.copy()
    for i, n in enumerate(lengths):
        padded[i, :PROMPT - n] = 0                  # left padding
    before = flash_attention.launches
    out_p = lm.generate(padded, 8, lengths=lengths)
    torch.cuda.synchronize()
    _require(flash_attention.launches == before,
             "a padded (masked) request reached the flash kernel")
    _require(out_p.shape == (BATCH, 8), f"padded generate shape "
                                        f"{out_p.shape}")
    n = min(8, NEW_TOKENS)
    rec["padded_row0_tokens_match_unpadded"] = bool(
        (out_p[0, :n] == out[0, :n]).all())
    print(f"padded request lengths={lengths.tolist()}: dense path "
          f"(flash launches unchanged at {before})")
    return padded, lengths


def _forced_dense(dpa):
    """``dot_product_attention`` with ``impl="dense"`` whatever the caller
    passes (a caller's explicit ``impl="auto"`` would override a partial)."""
    return lambda *a, **kw: dpa(*a, **{**kw, "impl": "dense"})


def phase_outputs(torch, rec, lm, prompts, padded, lengths):
    import deeplearning4j_tpu_torch.nlp.transformer as tmod
    import numpy as np
    errs = {}
    logits, caches = lm.prefill(prompts)
    _require(tuple(logits.shape) == (BATCH, GPT2_SMALL["vocabSize"]) and
             bool(logits.isfinite().all()), "prefill logits not finite or "
                                            "of the wrong shape")
    orig = tmod.dot_product_attention
    tmod.dot_product_attention = _forced_dense(orig)
    try:
        dense_logits, _ = lm.prefill(prompts)
    finally:
        tmod.dot_product_attention = orig
    errs["prefill_flash_vs_dense"] = float((logits - dense_logits).abs().max())

    # the padded request's rows against unpadded prefills of their tokens
    plog, _ = lm.prefill(padded, lengths)
    e = 0.0
    for i, n in enumerate(lengths):
        row, _ = lm.prefill(prompts[i:i + 1, PROMPT - n:])
        e = max(e, float((plog[i] - row[0]).abs().max()))
    errs["padded_vs_unpadded_rows"] = e

    # one KV-cached decode step against a prefill of the extended prompt
    tok = torch.argmax(logits, dim=-1)
    step_logits, _ = lm.decodeStep(tok, caches)
    ext = np.concatenate([prompts, tok.cpu().numpy()[:, None]], axis=1)
    ext_logits, _ = lm.prefill(ext)
    errs["decode_vs_prefill"] = float((step_logits - ext_logits).abs().max())
    rec["logit_errors"] = errs
    for name, err in errs.items():
        print(f"logits {name}: max |d| = {err:.3g} (atol {LOGIT_ATOL}, "
              f"float32 summation order)")
    _require(all(e <= LOGIT_ATOL for e in errs.values()),
             f"model outputs disagree: {errs}")


def phase_timing(torch, rec, lm, prompts):
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_forward)
    b, h, tq, tk, d = KERNEL_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               for t in (tq, tk, tk))
    ms = _time_ms(torch, lambda: flash_forward(q, k, v, True))
    plain_ms = _time_ms(torch, lambda: flash_attention_reference(
        q, k, v, True))
    lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = _attention_bound(
        b, h, tq, tk, d, True, "float32", 4)
    out, _ = flash_forward(q, k, v, True)
    ref, _ = flash_attention_reference(q, k, v, True)
    err = float((out - ref).abs().max())
    rec["flash_timing"] = t = dict(
        shape=[b, h, tq, tk, d], dtype="float32", causal=True, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
        bound_by=bound_by, flops=flops, bytes=nbytes, max_abs_err=err,
        achieved_tflops=flops / ms / 1e9,
        device_ms=_device_ms(torch, lambda: flash_forward(q, k, v, True)),
        library_device_ms=_device_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)))
    print(f"flash f32 causal {[b, h, tq, tk, d]}: {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; "
          f"device time {t['device_ms']} ms, SDPA {t['library_device_ms']}"
          f" ms")

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bound_b, by_b, _, _ = _attention_bound(b, h, tq, tk, d, True, "bfloat16",
                                           2)
    rec["flash_timing_bf16"] = t = dict(
        shape=[b, h, tq, tk, d], dtype="bfloat16", causal=True,
        ms=_time_ms(torch, lambda: flash_forward(qb, kb, vb, True)),
        plain_ms=_time_ms(torch, lambda: flash_attention_reference(
            qb, kb, vb, True), iters=5, warmup=1),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True)),
        bound_ms=bound_b, bound_by=by_b,
        device_ms=_device_ms(torch, lambda: flash_forward(qb, kb, vb, True)),
        library_device_ms=_device_ms(
            torch, lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                          is_causal=True)))
    print(f"flash bf16 causal {[b, h, tq, tk, d]}: {t['ms']:.4f} ms, bound "
          f"{bound_b:.4f} ms ({by_b}), plain {t['plain_ms']:.4f} ms, SDPA "
          f"{t['library_ms']:.4f} ms; device time {t['device_ms']} ms, SDPA "
          f"{t['library_device_ms']} ms")

    def prefill():
        lm.prefill(prompts)
    t_prefill = _time_ms(torch, prefill, iters=5, warmup=1)
    _, caches = lm.prefill(prompts)
    tok = torch.zeros((BATCH,), dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, caches = lm.decodeStep(tok, caches)
        tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    rec["prefill_ms"] = t_prefill
    rec["prefill_tokens_per_s"] = BATCH * PROMPT / (t_prefill / 1e3)
    rec["decode_tokens_per_s"] = BATCH * NEW_TOKENS / t_decode
    print(f"prefill {BATCH}x{PROMPT}: {t_prefill:.2f} ms, "
          f"{rec['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{NEW_TOKENS} steps x {BATCH}: "
          f"{rec['decode_tokens_per_s']:.1f} tokens/s")


def _device_breakdown(torch, fn, top=8):
    """One call of ``fn`` under torch.profiler: wall ms (host clock to a
    synchronise), device busy ms (the sum of kernel and copy self times),
    the number of device kernels and copies, and the ``top`` kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in dev),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    return {"wall_ms": wall, "device_busy_ms": busy if rows else None,
            "idle_share": 1 - busy / wall if rows else None,
            "device_ops": sum(e.count for e in dev) if rows else None,
            "top": [[name[:200], ms] for name, ms in rows[:top]]}


def phase_profile(torch, rec, lm, prompts):
    _, caches = lm.prefill(prompts)
    tok = torch.zeros((BATCH,), dtype=torch.long, device="cuda")

    def decode4():
        c = caches
        for _ in range(4):
            _, c = lm.decodeStep(tok, c)
    rec["profile"] = {"prefill": _device_breakdown(
        torch, lambda: lm.prefill(prompts)),
        "decode_4_steps": _device_breakdown(torch, decode4)}
    for name, p in rec["profile"].items():
        if p["device_busy_ms"] is None:
            print(f"profile {name}: no device time in the trace "
                  f"(not measured)")
            continue
        print(f"profile {name}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f}")
        for kname, ms in p["top"]:
            print(f"  {ms:9.3f} ms  {kname}")


def _long_context_conf(data_type, n_out=None):
    """bench.py bench_long_context's configuration, built with the port's
    config DSL (``n_out`` replaces the head's width)."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.attention import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
    c = LONG_CONTEXT
    return (NeuralNetConfiguration.builder().seed(c["seed"])
            .updater(Adam(c["lr"])).dataType(data_type).list()
            .layer(SelfAttentionLayer(nHeads=c["nHeads"],
                                      headSize=c["headSize"], nOut=c["nIn"]))
            .layer(SelfAttentionLayer(nHeads=c["nHeads"],
                                      headSize=c["headSize"], nOut=c["nIn"]))
            .layer(RnnOutputLayer.builder("mse").nOut(n_out or c["nOut"])
                   .activation("identity").build())
            .setInputType(InputType.recurrent(c["nIn"], c["t"])).build())


def _train_model(torch):
    """The BFLOAT16 net on the card (the entry point's default device), a
    copy of its initial parameters, and bench.py's two seeded batches."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    c = LONG_CONTEXT
    net = MultiLayerNetwork(_long_context_conf("BFLOAT16")).init()
    _require(net.device.type == "cuda", f"the net runs on {net.device}")
    params0 = {li: {k: v.clone() for k, v in lp.items()}
               for li, lp in net.params_.items()}
    rng = np.random.RandomState(1)
    pool = [DataSet(rng.randn(c["batch"], c["nIn"], c["t"]).astype(
        np.float32), rng.randn(c["batch"], c["nOut"], c["t"]).astype(
        np.float32)) for _ in range(2)]
    print(f"long-context net: {net.numParams()} params, "
          f"{TRAIN_SHAPE[0]}x{c['nIn']}x{c['t']} batches, BFLOAT16 compute "
          f"over float32 masters")
    return net, params0, pool


def phase_train(torch, rec, net, params0, pool):
    import math
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    it = ListDataSetIterator(pool)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(it, epochs=TRAIN_EPOCHS)
    loss = net.score()
    rec["train_fit_s"] = time.perf_counter() - t0
    rec["launches_train"] = counts = _counters()
    steps = net.getIterationCount()
    rec["train_steps"], rec["train_loss"] = steps, loss
    print(f"fit {TRAIN_EPOCHS} epochs x {len(pool)} batches: {steps} steps "
          f"in {rec['train_fit_s']:.3f} s, last loss {loss:.6g}, "
          f"launches {counts}")
    _require(steps == TRAIN_EPOCHS * len(pool) and
             net.getEpochCount() == TRAIN_EPOCHS,
             f"{steps} steps, {net.getEpochCount()} epochs")
    want = 2 * steps    # two attention layers, one launch each per step
    _require(all(counts[k] == want for k in FLASH)
             and counts["matmul_bn_stats"] == 0,
             f"expected {want} launches of each flash kernel (B1, B2, B3 "
             f"twice per step) and no B4, got {counts}")
    _require(math.isfinite(loss), f"training loss {loss}")
    out = net.output(pool[0].features).torch
    _require(tuple(out.shape) == (TRAIN_SHAPE[0], LONG_CONTEXT["nOut"],
                                  LONG_CONTEXT["t"])
             and bool(out.isfinite().all()),
             f"output of shape {tuple(out.shape)} or not finite")


def phase_train_outputs(torch, rec, params0, pool):
    """One FLOAT step from the same copied parameters, flash kernels
    against dense attention forced in the attention layers."""
    import deeplearning4j_tpu_torch.nn.conf.attention as amod
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    def one_step():
        net = MultiLayerNetwork(_long_context_conf("FLOAT")).init(
            params=params0)
        net.fit(pool[0])
        return net.score(), net.params().torch

    _reset_counters()
    loss_f, p_f = one_step()
    counts = _counters()
    orig = amod.dot_product_attention
    amod.dot_product_attention = _forced_dense(orig)
    try:
        _reset_counters()
        loss_d, p_d = one_step()
        dense_counts = _counters()
    finally:
        amod.dot_product_attention = orig
    errs = {"loss": abs(loss_f - loss_d),
            "params": float((p_f - p_d).abs().max())}
    rec["train_step_flash_vs_dense"] = dict(errs, loss_flash=loss_f,
                                           loss_dense=loss_d,
                                           launches=counts)
    print(f"FLOAT step flash vs dense: loss {loss_f:.7g} vs {loss_d:.7g} "
          f"(|d| {errs['loss']:.3g}, atol {TRAIN_LOSS_ATOL}), params "
          f"|d|max {errs['params']:.3g} (atol {TRAIN_PARAM_ATOL}); flash "
          f"launches {counts}")
    _require(all(counts[k] == 2 for k in FLASH),
             f"the FLOAT step launched {counts}, expected 2 of each flash "
             f"kernel")
    _require(not any(dense_counts.values()),
             f"the dense step launched a flash kernel: {dense_counts}")
    _require(errs["loss"] <= TRAIN_LOSS_ATOL and
             errs["params"] <= TRAIN_PARAM_ATOL,
             f"flash and dense training steps disagree: {errs}")


def phase_train_timing(torch, rec, net, pool):
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dkv_reference,
        flash_bwd_dq, flash_bwd_dq_reference, flash_forward)
    b, h, tq, tk, d = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn, elem = str(dtype).split(".")[-1], dtype.itemsize
        q, do = (torch.randn((b, h, tq, d), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        out, lse = flash_forward(q, k, v)
        delta = (do.float() * out.float()).sum(-1).reshape(b * h, tq)
        args = (q, k, v, do, lse, delta, False)
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*qkv)
        def sdpa_grad():
            torch.autograd.grad(sdpa_out, qkv, do, retain_graph=True)
        sdpa_bwd, sdpa_bwd_dev = (_time_ms(torch, sdpa_grad),
                                  _device_ms(torch, sdpa_grad))
        rows = {
            "flash_attn_fwd": (
                lambda: flash_forward(q, k, v),
                lambda: flash_attention_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v),
                _attention_bound(b, h, tq, tk, d, False, dn, elem),
                float((out - flash_attention_reference(q, k, v)[0])
                      .abs().max())),
            "flash_attn_bwd_dq": (
                lambda: flash_bwd_dq(*args),
                lambda: flash_bwd_dq_reference(*args), None,
                _bwd_bound("dq", b, h, tq, tk, d, False, dn, elem),
                float((flash_bwd_dq(*args).float()
                       - flash_bwd_dq_reference(*args).float()).abs().max())),
            "flash_attn_bwd_dkv": (
                lambda: flash_bwd_dkv(*args),
                lambda: flash_bwd_dkv_reference(*args), None,
                _bwd_bound("dkv", b, h, tq, tk, d, False, dn, elem),
                max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(flash_bwd_dkv(*args),
                                    flash_bwd_dkv_reference(*args)))),
        }
        for name, (fn, plain, lib, (bound_ms, bound_by, flops, nbytes),
                   err) in rows.items():
            ms = _time_ms(torch, fn)
            r = dict(shape=list(TRAIN_SHAPE), dtype=dn, causal=False, ms=ms,
                     plain_ms=_time_ms(torch, plain, iters=5, warmup=1),
                     library_ms=_time_ms(torch, lib) if lib else sdpa_bwd,
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                     bytes=nbytes, max_abs_err=err,
                     achieved_tflops=flops / ms / 1e9,
                     device_ms=_device_ms(torch, fn),
                     library_device_ms=_device_ms(torch, lib) if lib
                     else sdpa_bwd_dev)
            timing.setdefault(name, {})[dn] = r
            print(f"{name} {dn} {list(TRAIN_SHAPE)}: {ms:.4f} ms "
                  f"({r['achieved_tflops']:.2f} TFLOP/s), bound "
                  f"{bound_ms:.4f} ms ({bound_by}), plain "
                  f"{r['plain_ms']:.4f} ms, SDPA "
                  f"{'forward' if lib else 'backward (dq, dk, dv)'} "
                  f"{r['library_ms']:.4f} ms, max |d| {err:.3g}; device "
                  f"time {r['device_ms']} ms, SDPA {r['library_device_ms']}"
                  f" ms")
    rec["train_kernel_timing"] = timing

    for i in range(2):          # warm, as bench.py does
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec["train_ms_per_step"] = wall / TRAIN_TIMED_STEPS * 1e3
    rec["train_tokens_per_s"] = (TRAIN_SHAPE[0] * LONG_CONTEXT["t"]
                                 * TRAIN_TIMED_STEPS / wall)
    print(f"training: {rec['train_ms_per_step']:.3f} ms/step, "
          f"{rec['train_tokens_per_s']:.0f} tokens/s "
          f"({TRAIN_TIMED_STEPS} steps after 2 warm)")


def phase_train_profile(torch, rec, net, pool):
    p = rec.setdefault("profile", {})["train_step"] = _device_breakdown(
        torch, lambda: (net.fit(pool[0]), net.score()), top=10)
    if p["device_busy_ms"] is None:
        print("profile train_step: no device time in the trace "
              "(not measured)")
        return
    print(f"profile train_step: wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}, "
          f"{p['device_ops']} device kernels and copies")
    for kname, ms in p["top"]:
        print(f"  {ms:9.3f} ms  {kname}")


def _b4_bound(m, k, n, dtype_name, elem):
    """Least time for B4: x (M, K) and w (K, N) read once, y (M, N) and
    the two f32 sums written once; 2·M·K·N FLOPs of product.  Returns (ms,
    "bytes"|"operations", flops, bytes)."""
    flops = 2.0 * m * k * n
    nbytes = (m * k + k * n + m * n) * elem + 2 * n * 4
    return (*_bound(flops, 0, nbytes, dtype_name), flops, nbytes)


def _b4_errors(got, ref, y_tol):
    """Max errors of B4's (y, s, ss) against a reference (y, s, ss): y in
    its dtype to ``y_tol``, the sums to B4_SUM_RTOL of Σ|y| and Σy²."""
    y32 = ref[0].float()
    scale_s = y32.abs().sum(0)
    scale_ss = (y32 * y32).sum(0)
    e_y, ok_y = _max_err(got[0], ref[0], **y_tol)
    d_s = (got[1] - ref[1]).abs()
    d_ss = (got[2] - ref[2]).abs()
    ok = ok_y and bool((d_s <= B4_SUM_RTOL * scale_s + 1e-6).all()) and \
        bool((d_ss <= B4_SUM_RTOL * scale_ss + 1e-6).all()) and \
        bool(got[1].isfinite().all() and got[2].isfinite().all())
    return dict(y_err=e_y, s_err=float(d_s.max()), ss_err=float(d_ss.max()),
                s_rel=float((d_s / (scale_s + 1e-30)).max()),
                ss_rel=float((d_ss / (scale_ss + 1e-30)).max()), ok=ok)


def phase_b4_kernels(torch, rec):
    """B4 against its plain version on the same inputs: every ResNet-50
    1x1 stride-1 shape at batch 64, the reference test's shape and ragged
    shapes, float32 and bfloat16; at B4_REPEAT_SHAPES a second call on the
    same inputs must give the same bits (one writer per output, no
    atomics)."""
    from deeplearning4j_tpu_torch.ops.fused import (matmul_bn_stats,
                                                    matmul_bn_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    checks, failed = [], []
    for (m, k, n) in B4_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 * k ** -0.5).to(dtype)
            got = matmul_bn_stats(x, w)
            ref = matmul_bn_stats_plain(x, w)
            torch.cuda.synchronize()
            c = dict(shape=[m, k, n], dtype=dn,
                     **_b4_errors(got, ref, B4_Y_TOL[dn]))
            if (m, k, n) in B4_REPEAT_SHAPES:
                again = matmul_bn_stats(x, w)
                c["same_bits"] = all(torch.equal(a, b)
                                     for a, b in zip(got, again))
                c["ok"] = c["ok"] and c["same_bits"]
            checks.append(c)
            print(f"B4 {c['shape']} {dn:8s} |dy|max={c['y_err']:.3g} "
                  f"|ds|/Σ|y| max={c['s_rel']:.3g} |dss|/Σy² max="
                  f"{c['ss_rel']:.3g}"
                  + (f" same bits twice: {c['same_bits']}"
                     if "same_bits" in c else "")
                  + f" {'ok' if c['ok'] else 'MISMATCH'}")
            if not c["ok"]:
                failed.append(c)
    print(f"tolerances: y {B4_Y_TOL} (bf16: one ulp), s and ss "
          f"{B4_SUM_RTOL} of Σ|y| and Σy² (summation order)")
    rec["b4_checks"] = checks
    _require(not failed, f"B4 disagrees with its plain version: {failed}")


def _resnet_model(torch):
    """bench.py's ResNet-50 (BFLOAT16) on the card (the entry point's
    default device), a copy of its initial parameters, and two seeded
    batches of 64 as bench.py makes them."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import ResNet50
    c, b = RESNET, RESNET["batch"]
    t0 = time.perf_counter()
    net = ResNet50(numClasses=c["numClasses"], inputShape=c["inputShape"],
                   dataType="BFLOAT16").init()
    torch.cuda.synchronize()
    _require(net.device.type == "cuda", f"the graph runs on {net.device}")
    params0 = {v: {k: t.clone() for k, t in lp.items()}
               for v, lp in net.params_.items()}
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(2):
        x = rng.randn(b, *c["inputShape"]).astype(np.float32)
        y = np.eye(c["numClasses"], dtype=np.float32)[
            rng.randint(0, c["numClasses"], b)]
        pool.append(DataSet(x, y))
    print(f"ResNet-50: {net.numParams()} params, init "
          f"{time.perf_counter() - t0:.1f} s, batches of {b}x3x224x224, "
          f"BFLOAT16 compute over float32 masters")
    return net, params0, pool


def phase_resnet_train(torch, rec, net, params0, pool):
    import math
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    it = ListDataSetIterator(pool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(it, epochs=RESNET_EPOCHS)
    loss = net.score()
    rec["resnet_fit_s"] = time.perf_counter() - t0
    rec["launches_resnet"] = counts = _counters()
    rec["resnet_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    steps = net.iterationCount
    rec["resnet_steps"], rec["resnet_loss"] = steps, loss
    print(f"ResNet-50 fit {RESNET_EPOCHS} epochs x {len(pool)} batches: "
          f"{steps} steps in {rec['resnet_fit_s']:.3f} s, last loss "
          f"{loss:.6g}, peak {rec['resnet_peak_gb']:.2f} GB, launches "
          f"{counts}")
    _require(steps == RESNET_EPOCHS * len(pool) and
             net.getEpochCount() == RESNET_EPOCHS,
             f"{steps} steps, {net.getEpochCount()} epochs")
    _require(not any(counts.values()),
             f"ResNet-50 training launched a kernel: {counts} (the graph "
             f"dispatches no B4, as in the reference)")
    _require(math.isfinite(loss), f"ResNet-50 training loss {loss}")
    out = net.output(pool[0].features[:4]).torch
    _require(tuple(out.shape) == (4, RESNET["numClasses"])
             and bool(out.isfinite().all())
             and bool(((out.sum(1) - 1).abs() < 1e-2).all()),
             f"output of shape {tuple(out.shape)}, not finite or not a "
             f"distribution")


def _resnet_float(params0, device=None):
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50
    c = RESNET
    conf = ResNet50(numClasses=c["numClasses"], inputShape=c["inputShape"],
                    dataType="FLOAT").graphBuilder().build()
    return ComputationGraph(conf, device=device).init(params=params0)


def phase_resnet_step(torch, rec, params0, pool):
    """One FLOAT step at batch 2 from the same copied parameters, on the
    card and on the CPU."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    b = RESNET_CHECK_BATCH
    ds = DataSet(pool[0].features[:b], pool[0].labels[:b])
    nets = {}
    for dev in ("cuda", "cpu"):
        net = _resnet_float(params0, dev)
        net.fit(ds)
        nets[dev] = net
    gpu, cpu = nets["cuda"], nets["cpu"]
    loss_g, loss_c = gpu.score(), cpu.score()
    e_l, ok_l = _max_err(torch.tensor([loss_g]), torch.tensor([loss_c]),
                         **RESNET_STEP_TOL)
    p_cpu = cpu.params().torch
    update = float((p_cpu - _resnet_float(params0, "cpu").params().torch)
                   .abs().max())
    e_p = float((gpu.params().torch.cpu() - p_cpu).abs().max())
    ok_p = e_p <= RESNET_STEP_PARAM_SHARE * update
    e_s, ok_s = 0.0, True
    for v, st in gpu.state_.items():
        for k in ("mean", "var"):
            e, ok = _max_err(st[k].cpu(), cpu.state_[v][k], **RESNET_STEP_TOL)
            e_s, ok_s = max(e_s, e), ok_s and ok
    rec["resnet_step_card_vs_cpu"] = dict(loss_card=loss_g, loss_cpu=loss_c,
                                          loss_err=e_l, params_err=e_p,
                                          largest_update=update,
                                          state_err=e_s)
    print(f"ResNet-50 FLOAT step, batch {b}, card vs CPU: loss {loss_g:.7g} "
          f"vs {loss_c:.7g} (|d| {e_l:.3g}), BN running stats |d|max "
          f"{e_s:.3g} ({RESNET_STEP_TOL}); params |d|max {e_p:.3g} = "
          f"{e_p / update:.3g} of the largest update {update:.3g} (at most "
          f"{RESNET_STEP_PARAM_SHARE})")
    _require(ok_l and ok_p and ok_s,
             f"the card's ResNet-50 step disagrees with the CPU's: "
             f"{rec['resnet_step_card_vs_cpu']}")
    return gpu


def phase_b4_activations(torch, rec, gnet, pool):
    """B4 on ResNet-50's own activations (FLOAT, train mode, batch 64): the
    input of one 1x1 stride-1 conv per stage through conv1x1_bn_stats,
    against the graph's conv output and the following BN layer's batch
    moments (its formulas: f32 mean, E[x²] − mean² clamped at 0)."""
    from deeplearning4j_tpu_torch.ops.fused import conv1x1_bn_stats
    x = pool[0].features.torch.to("cuda")
    with torch.no_grad():
        acts = gnet._forward(gnet.params_, gnet.state_, (x,), True,
                             None)[0]
    torch.cuda.synchronize()
    res, ok_all = {}, True
    _reset_counters()
    for v in B4_ACT_CONVS:
        node, ins = gnet.conf.nodes[v]
        _require(node.kernelSize == (1, 1) and node.stride == (1, 1),
                 f"{v} is not a 1x1 stride-1 conv")
        inp = acts[ins[0]].permute(0, 2, 3, 1).contiguous()
        w = gnet.params_[v]["W"][:, :, 0, 0].t().contiguous()
        y, s, ss = conv1x1_bn_stats(inp, w)
        conv = acts[v].permute(0, 2, 3, 1)
        m = y.shape[0] * y.shape[1] * y.shape[2]
        mean, var = s / m, ss / m - (s / m) ** 2
        cf = acts[v].float()
        bn_mean = cf.mean(dim=(0, 2, 3))
        bn_var = torch.clamp((cf * cf).mean(dim=(0, 2, 3)) - bn_mean ** 2,
                             min=0.0)
        e_y, ok_y = _max_err(y, conv, **B4_ACT_TOL)
        e_m, ok_m = _max_err(mean, bn_mean, **B4_MOMENT_TOL)
        e_v, ok_v = _max_err(var, bn_var, **B4_MOMENT_TOL)
        res[v] = dict(shape=[m, w.shape[0], w.shape[1]], y_err=e_y,
                      mean_err=e_m, var_err=e_v, ok=ok_y and ok_m and ok_v)
        ok_all = ok_all and res[v]["ok"]
        print(f"B4 on {v} input {list(inp.shape)} (M, K, N = "
              f"{res[v]['shape']}): |dy|max {e_y:.3g} vs the graph's conv, "
              f"|dmean|max {e_m:.3g}, |dvar|max {e_v:.3g} vs BN "
              f"{'ok' if res[v]['ok'] else 'MISMATCH'}")
    torch.cuda.synchronize()
    rec["launches_b4"] = counts = _counters()
    rec["b4_on_activations"] = res
    print(f"tolerances: y {B4_ACT_TOL}, moments {B4_MOMENT_TOL}; launches "
          f"{counts}")
    _require(ok_all, f"B4 disagrees with the graph's conv or BN: {res}")
    _require(counts["matmul_bn_stats"] == len(B4_ACT_CONVS)
             and not any(counts[k] for k in FLASH),
             f"expected {len(B4_ACT_CONVS)} B4 launches, got {counts}")


def phase_resnet_timing(torch, rec, net, pool):
    from deeplearning4j_tpu_torch.ops.fused import (
        matmul_bn_stats, matmul_bn_stats_plain, matmul_bn_stats_reference)
    gen = torch.Generator(device="cuda").manual_seed(6)
    timing = {}
    for (m, k, n) in B4_RESNET_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn, elem = str(dtype).split(".")[-1], dtype.itemsize
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 * k ** -0.5).to(dtype)
            bound_ms, bound_by, flops, nbytes = _b4_bound(m, k, n, dn, elem)
            ms = _time_ms(torch, lambda: matmul_bn_stats(x, w))
            got, ref = matmul_bn_stats(x, w), matmul_bn_stats_plain(x, w)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
            r = dict(shape=[m, k, n], dtype=dn, ms=ms,
                     plain_ms=_time_ms(torch, lambda: matmul_bn_stats_plain(
                         x, w), iters=5, warmup=1),
                     library_ms=_time_ms(torch, lambda: torch.matmul(x, w)),
                     unfused_ms=_time_ms(
                         torch, lambda: matmul_bn_stats_reference(x, w)),
                     device_ms=_device_ms(torch,
                                          lambda: matmul_bn_stats(x, w)),
                     library_device_ms=_device_ms(
                         torch, lambda: torch.matmul(x, w)),
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                     bytes=nbytes, max_abs_err=err,
                     achieved_tflops=flops / ms / 1e9)
            timing[f"{m}x{k}x{n} {dn}"] = r
            print(f"B4 {dn} {[m, k, n]}: {ms:.4f} ms "
                  f"({r['achieved_tflops']:.2f} TFLOP/s; device "
                  f"{r['device_ms']} ms), bound {bound_ms:.4f} ms "
                  f"({bound_by}), plain {r['plain_ms']:.4f} ms, "
                  f"torch.matmul (product only, no statistics) "
                  f"{r['library_ms']:.4f} ms (device "
                  f"{r['library_device_ms']} ms), unfused (torch.matmul "
                  f"then the two f32 column sums) {r['unfused_ms']:.4f} ms, "
                  f"max |d| {err:.3g}")
    rec["b4_timing"] = timing

    for i in range(2):          # warm, as bench.py does
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RESNET_TIMED_STEPS):
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec["resnet_ms_per_step"] = wall / RESNET_TIMED_STEPS * 1e3
    rec["resnet_images_per_s"] = (RESNET["batch"] * RESNET_TIMED_STEPS
                                  / wall)
    print(f"ResNet-50 training: {rec['resnet_ms_per_step']:.3f} ms/step, "
          f"{rec['resnet_images_per_s']:.1f} images/s "
          f"({RESNET_TIMED_STEPS} steps of {RESNET['batch']} after 2 warm)")
    p = rec.setdefault("profile", {})["resnet_step"] = _device_breakdown(
        torch, lambda: (net.fit(pool[0]), net.score()), top=10)
    if p["device_busy_ms"] is None:
        print("profile resnet_step: no device time in the trace "
              "(not measured)")
        return
    print(f"profile resnet_step: wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}, "
          f"{p['device_ops']} device kernels and copies")
    for kname, ms in p["top"]:
        print(f"  {ms:9.3f} ms  {kname}")


def _card():
    """The card's name and power limit as nvidia-smi prints them, or None."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else None


def _char_rnn_conf(n_chars):
    """The example's net at LSTMCharModellingExample's widths, built with
    the port's config DSL."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (BackpropType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (GravesLSTM,
                                                            RnnOutputLayer)
    c = CHAR_RNN
    return (NeuralNetConfiguration.builder().seed(c["seed"])
            .updater(Adam(c["lr"])).l2(c["l2"]).weightInit("XAVIER").list()
            .layer(GravesLSTM.builder().nIn(n_chars).nOut(c["hidden"])
                   .activation("tanh").build())
            .layer(GravesLSTM.builder().nIn(c["hidden"]).nOut(c["hidden"])
                   .activation("tanh").build())
            .layer(RnnOutputLayer.builder("mcxent").nIn(c["hidden"])
                   .nOut(n_chars).activation("softmax").build())
            .backpropType(BackpropType.TruncatedBPTT)
            .tBPTTForwardLength(c["tbptt"]).tBPTTBackwardLength(c["tbptt"])
            .build())


def _char_rnn_model(torch):
    """The char-RNN on the card (the entry point's default device), a copy
    of its initial parameters, and the CharacterIterator."""
    from deeplearning4j_tpu_torch.datasets import CharacterIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    c = CHAR_RNN
    it = CharacterIterator(CHAR_TEXT, c["batch"], c["length"],
                           seed=c["seed"])
    net = MultiLayerNetwork(_char_rnn_conf(it.inputColumns())).init()
    _require(net.device.type == "cuda", f"the net runs on {net.device}")
    params0 = {li: {k: v.clone() for k, v in lp.items()}
               for li, lp in net.params_.items()}
    print(f"char-RNN: {net.numParams()} params, {it.inputColumns()} "
          f"characters, {len(CHAR_TEXT)}-character corpus, batches of "
          f"{c['batch']} x {c['length']}, TBPTT {c['tbptt']}, FLOAT")
    return net, params0, it


def _no_launches(rec, name, counts):
    """Record the kernel launches of a phase whose path has no hand kernel
    (the recurrent and BERT phases); none is allowed."""
    rec.setdefault("launches_no_kernel_phases", {})[name] = counts
    _require(not any(counts.values()),
             f"{name} launched a kernel: {counts} (no hand kernel is on "
             f"this path)")


def phase_rnn_train(torch, rec, net, params0, it):
    import math
    c = CHAR_RNN
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(it, epochs=1)
    loss = net.score()
    torch.cuda.synchronize()
    rec["rnn_fit_s"] = time.perf_counter() - t0
    counts = _counters()
    chunks = 2 * c["length"] // c["tbptt"]
    rec["rnn_train"] = dict(loss=loss, iterations=net.getIterationCount(),
                            epochs=net.getEpochCount(), chunks=chunks,
                            launches=counts)
    print(f"char-RNN fit 1 epoch: {net.getIterationCount()} iterations "
          f"({chunks} TBPTT chunks) in {rec['rnn_fit_s']:.3f} s, last loss "
          f"{loss:.6g}, launches {counts}")
    _no_launches(rec, "rnn_train", counts)
    _require(net.getIterationCount() == 2 and net.getEpochCount() == 1,
             f"{net.getIterationCount()} iterations, {net.getEpochCount()} "
             f"epochs; expected 2 and 1 (one iteration per batch)")
    _require(math.isfinite(loss), f"char-RNN loss {loss}")
    it.reset()
    out = net.output(it.next().features[:2]).torch
    _require(tuple(out.shape) == (2, it.inputColumns(), c["length"])
             and bool(out.isfinite().all())
             and bool(((out.sum(1) - 1).abs() < 1e-4).all()),
             f"output of shape {tuple(out.shape)}, not finite or not a "
             f"distribution over the characters")


def _rnn_step_batch(it):
    from deeplearning4j_tpu_torch.datasets import DataSet
    it.reset()
    ds = it.next(RNN_STEP["batch"])
    t = RNN_STEP["length"]
    return DataSet(ds.features[:, :, :t], ds.labels[:, :, :t])


def phase_rnn_step(torch, rec, params0, it):
    """One FLOAT TBPTT batch from the same copied parameters on the card
    and on the CPU."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    ds = _rnn_step_batch(it)
    n = it.inputColumns()
    nets = {}
    _reset_counters()
    for dev in ("cuda", "cpu"):
        net = MultiLayerNetwork(_char_rnn_conf(n), device=dev).init(
            params=params0)
        net.fit(ds)
        nets[dev] = net
    torch.cuda.synchronize()
    counts = _counters()
    gpu, cpu = nets["cuda"], nets["cpu"]
    loss_g, loss_c = gpu.score(), cpu.score()
    e_l = abs(loss_g - loss_c)
    p_cpu = cpu.params().torch
    update = float((p_cpu - MultiLayerNetwork(
        _char_rnn_conf(n), device="cpu").init(params=params0).params().torch)
        .abs().max())
    d = (gpu.params().torch.cpu() - p_cpu).abs()
    e_p = float(d.max())
    share = float((d <= RNN_PARAM_ATOL).float().mean())
    rec["rnn_step_card_vs_cpu"] = dict(
        loss_card=loss_g, loss_cpu=loss_c, loss_err=e_l, params_err=e_p,
        params_within_atol=share, largest_update=update,
        iterations=(gpu.getIterationCount(), cpu.getIterationCount()))
    print(f"char-RNN FLOAT TBPTT batch {RNN_STEP['batch']}x"
          f"{RNN_STEP['length']}, card vs CPU: loss {loss_g:.7g} vs "
          f"{loss_c:.7g} (|d| {e_l:.3g}, rtol {RNN_LOSS_RTOL}); params "
          f"|d|max {e_p:.3g} (largest update {update:.3g}), {share:.6f} of "
          f"them within {RNN_PARAM_ATOL} (at least {RNN_PARAM_SHARE})")
    _no_launches(rec, "rnn_step", counts)
    _require(gpu.getIterationCount() == cpu.getIterationCount() == 1,
             "one TBPTT batch is one iteration")
    _require(e_l <= RNN_LOSS_RTOL * abs(loss_c)
             and share >= RNN_PARAM_SHARE and e_p <= update,
             f"the card's TBPTT batch disagrees with the CPU's: "
             f"{rec['rnn_step_card_vs_cpu']}")


def _one_hot(torch, idx, n):
    x = torch.zeros((1, n, len(idx)))
    x[0, idx, torch.arange(len(idx))] = 1.0
    return x


def phase_rnn_timestep(torch, rec, net, it):
    """Stepping against the whole sequence, then the example's sampling
    loop."""
    import numpy as np
    n = it.inputColumns()
    x = _one_hot(torch, [it.convertCharacterToIndex(ch)
                         for ch in CHAR_TEXT[:RNN_SAMPLE]], n)
    _reset_counters()
    net.rnnClearPreviousState()
    full = net.output(x).torch
    steps = torch.stack([net.rnnTimeStep(x[:, :, k]).torch
                         for k in range(RNN_SAMPLE)], dim=2)
    err = float((steps - full).abs().max())
    net.rnnClearPreviousState()
    err0 = float((net.rnnTimeStep(x[:, :, 0]).torch - full[:, :, 0])
                 .abs().max())
    # the example's sampling loop (examples/lstm_charmodelling.py)
    rng = np.random.RandomState(7)
    net.rnnClearPreviousState()
    idx = rng.randint(n)
    out = [it.convertIndexToCharacter(idx)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RNN_SAMPLE):
        xs = np.zeros((1, n, 1), np.float32)
        xs[0, idx, 0] = 1.0
        probs = net.rnnTimeStep(xs).numpy().reshape(-1)
        idx = int(rng.choice(n, p=probs / probs.sum()))
        out.append(it.convertIndexToCharacter(idx))
    wall = time.perf_counter() - t0
    counts = _counters()
    sample = "".join(out)
    rec["rnn_timestep"] = dict(stepwise_err=err, first_step_after_clear=err0,
                               sample=sample,
                               ms_per_sampled_char=wall / RNN_SAMPLE * 1e3)
    print(f"rnnTimeStep x{RNN_SAMPLE} vs output: |d|max {err:.3g}; after "
          f"rnnClearPreviousState |d| {err0:.3g} (atol "
          f"{RNN_STEPWISE_ATOL}); sampling {wall / RNN_SAMPLE * 1e3:.3f} "
          f"ms a character")
    print(f"sample: {sample!r}")
    _no_launches(rec, "rnn_timestep", counts)
    _require(err <= RNN_STEPWISE_ATOL and err0 <= RNN_STEPWISE_ATOL,
             f"rnnTimeStep disagrees with output: {err}, {err0}")
    _require(len(sample) == RNN_SAMPLE + 1, "sampling loop")


def _char_graph_conf(n_chars, merge):
    """With ``merge``: tests/test_graph_recurrence.py's char-RNN graph
    (LSTM, then its features merged with the raw input before the output
    layer) at width 200; without: the char-RNN's GravesLSTM stack as a
    graph.  Both with the char-RNN's updater, l2 and TBPTT."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models.graph_conf import MergeVertex
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (GravesLSTM, LSTM,
                                                            RnnOutputLayer)
    c = CHAR_RNN
    gb = (NeuralNetConfiguration.builder().seed(c["seed"])
          .updater(Adam(c["lr"])).l2(c["l2"]).weightInit("XAVIER")
          .graphBuilder().addInputs("in"))
    if merge:
        gb.addLayer("lstm", LSTM.builder().nOut(c["hidden"]).build(), "in")
        gb.addVertex("merge", MergeVertex(), "lstm", "in")
        last = "merge"
    else:
        gb.addLayer("g0", GravesLSTM.builder().nOut(c["hidden"])
                    .activation("tanh").build(), "in")
        gb.addLayer("g1", GravesLSTM.builder().nOut(c["hidden"])
                    .activation("tanh").build(), "g0")
        last = "g1"
    gb.addLayer("out", RnnOutputLayer.builder("mcxent").nOut(n_chars)
                .activation("softmax").build(), last)
    return (gb.setOutputs("out")
            .setInputTypes(InputType.recurrent(n_chars, RNN_STEP["length"]))
            .backpropType("TruncatedBPTT").tBPTTLength(c["tbptt"]).build())


def phase_rnn_graph(torch, rec, params0, it):
    import math
    from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                                 MultiLayerNetwork)
    n = it.inputColumns()
    ds = _rnn_step_batch(it)
    _reset_counters()
    g = ComputationGraph(_char_graph_conf(n, merge=True)).init()
    _require(g.device.type == "cuda", f"the graph runs on {g.device}")
    for _ in range(2):
        g.fit(ds)
    loss = g.score()
    x = ds.features[:1, :, :20]
    full = g.output(x).torch
    g.rnnClearPreviousState()
    steps = torch.stack([g.rnnTimeStep(x[:, :, k]).torch
                         for k in range(20)], 2)
    err_step = float((steps - full).abs().max())
    # the GravesLSTM stack as a graph against the same stack as an MLN
    mln = MultiLayerNetwork(_char_rnn_conf(n)).init(params=params0)
    cg = ComputationGraph(_char_graph_conf(n, merge=False)).init(
        params={"g0": params0["0"], "g1": params0["1"],
                "out": params0["2"]})
    for _ in range(2):
        mln.fit(ds)
        cg.fit(ds)
    err_mln = max(float((cg.params_[v][k] - mln.params_[li][k]).abs().max())
                  for v, li in (("g0", "0"), ("g1", "1"), ("out", "2"))
                  for k in mln.params_[li])
    err_out = float((cg.output(x).torch - mln.output(x).torch).abs().max())
    torch.cuda.synchronize()
    counts = _counters()
    rec["rnn_graph"] = dict(loss=loss, iterations=g.iterationCount,
                            stepwise_err=err_step, graph_vs_mln_params=err_mln,
                            graph_vs_mln_output=err_out, launches=counts)
    print(f"char-RNN graph (merge vertex, LSTM {CHAR_RNN['hidden']}): "
          f"{g.iterationCount} TBPTT batches, loss {loss:.6g}; rnnTimeStep "
          f"x20 vs output |d|max {err_step:.3g}; GravesLSTM stack as graph "
          f"vs MLN after 2 batches: params |d|max {err_mln:.3g}, outputs "
          f"{err_out:.3g} (atol {RNN_GRAPH_ATOL}); launches {counts}")
    _no_launches(rec, "rnn_graph", counts)
    _require(g.iterationCount == 2 and math.isfinite(loss),
             f"graph TBPTT: {g.iterationCount} iterations, loss {loss}")
    _require(err_step <= RNN_STEPWISE_ATOL,
             f"graph rnnTimeStep disagrees with output: {err_step}")
    _require(err_mln <= RNN_GRAPH_ATOL and err_out <= RNN_GRAPH_ATOL,
             f"the graph's TBPTT disagrees with the MLN's: {err_mln}, "
             f"{err_out}")


def phase_rnn_timing(torch, rec, net, it, card):
    from deeplearning4j_tpu_torch.datasets import DataSet
    c = CHAR_RNN
    it.reset()
    ds = it.next()
    chunks = c["length"] // c["tbptt"]
    _reset_counters()
    net.fit(ds)                 # warm
    net.score()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(ds)
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    chunk = DataSet(ds.features[:, :, :c["tbptt"]],
                    ds.labels[:, :, :c["tbptt"]])
    p = _device_breakdown(torch, lambda: (net.fit(chunk), net.score()),
                          top=10)
    counts = _counters()
    r = dict(ms_per_batch=wall * 1e3, ms_per_chunk=wall * 1e3 / chunks,
             chars_per_s=c["batch"] * c["length"] / wall, peak_gb=peak,
             chunk_profile=p, card=card)
    rec["rnn_timing"] = r
    print(f"char-RNN TBPTT batch {c['batch']}x{c['length']} ({chunks} "
          f"chunks of {c['tbptt']}): {r['ms_per_batch']:.1f} ms, "
          f"{r['ms_per_chunk']:.2f} ms a chunk, {r['chars_per_s']:.0f} "
          f"characters/s; {card}")
    print(f"char-RNN peak memory {peak:.3f} GB; {card}")
    if p["device_busy_ms"] is None:
        print(f"profile rnn_chunk: no device time in the trace (not "
              f"measured); {card}")
    else:
        # the profiler slows the host's dispatch: the idle share of an
        # unprofiled chunk is 1 - device busy / ms_per_chunk
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / \
            r["ms_per_chunk"]
        print(f"profile rnn_chunk: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f} ({r['idle_share_unprofiled']:.3f} of "
              f"an unprofiled chunk), {p['device_ops']} device kernels and "
              f"copies; {card}")
        for kname, ms in p["top"]:
            print(f"  {ms:9.3f} ms  {kname}")
    _no_launches(rec, "rnn_timing", counts)


def _bert_pool(n, batch, seq, vocab):
    """bench.py bench_bert's batches: token ids and labels from
    RandomState(0), zero segments, an all-ones feature mask, a 15 % label
    mask."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(n):
        toks = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        segs = np.zeros((batch, seq), np.int32)
        mask = np.ones((batch, seq), np.float32)
        labels = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        lmask = (rng.rand(batch, seq) < 0.15).astype(np.float32)
        pool.append(MultiDataSet(features=[toks, segs, mask],
                                 labels=[labels, lmask]))
    return pool


def _bert_model(torch):
    """BertBase("mlm") on the card (the entry point's default device) with
    bench.py's training config, and its pool of two batches."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.zoo import BertBase
    b = BERT
    bert = BertBase("mlm")
    _require(bert.sd.device.type == "cuda", f"BERT runs on {bert.sd.device}")
    bert.setTrainingConfig(updater=Adam(b["lr"]), dataType="BFLOAT16")
    n = sum(v.numel() for v in bert.sd._var_values().values())
    print(f"BERT-base MLM: {n} parameters, batches of {b['batch']} x "
          f"{b['seq']}, Adam({b['lr']}), BFLOAT16")
    return bert, _bert_pool(2, b["batch"], b["seq"], b["vocab"])


def phase_bert_train(torch, rec, bert, pool, card):
    import math
    sd = bert.sd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    warm = sd.fit(pool, epochs=1)
    t1 = time.perf_counter()
    hist = sd.fit(pool, epochs=2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counters()
    losses = warm.lossCurve() + hist.lossCurve()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec["bert_train"] = dict(losses=losses, iterations=sd.iterationCount,
                             warm_s=t1 - t0, fit_s=t2 - t1, peak_gb=peak,
                             launches=counts, card=card)
    print(f"BERT-base fit: warm-up epoch (2 steps) {t1 - t0:.2f} s, 2 "
          f"epochs (4 steps) {t2 - t1:.2f} s, iterationCount "
          f"{sd.iterationCount}, losses {[round(v, 4) for v in losses]}, "
          f"peak {peak:.2f} GB, launches {counts}; {card}")
    _no_launches(rec, "bert_train", counts)
    _require(sd.iterationCount == 6,
             f"iterationCount {sd.iterationCount}, expected 6")
    _require(all(math.isfinite(v) for v in losses), f"losses {losses}")


def phase_bert_timing(torch, rec, bert, pool, card):
    from torch.utils.flop_counter import FlopCounterMode
    b, sd = BERT, bert.sd
    steps = b["timed_epochs"] * len(pool)
    _reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd.fit(pool, epochs=b["timed_epochs"])   # ends in one stacked fetch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    with FlopCounterMode(display=False) as fc:
        sd.fit(pool[0])
    flops = fc.get_total_flops()
    p = _device_breakdown(torch, lambda: sd.fit(pool[1]), top=25)
    counts = _counters()
    ms = wall * 1e3 / steps
    r = dict(ms_per_step=ms, tokens_per_s=b["batch"] * b["seq"] * steps
             / wall, peak_gb=peak, step_flops=flops,
             flop_share_bf16_peak=flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
             step_profile=p, card=card)
    rec["bert_timing"] = r
    print(f"BERT-base step (batch {b['batch']} x {b['seq']}, BFLOAT16): "
          f"{ms:.2f} ms, {r['tokens_per_s']:.0f} tokens/s over {steps} "
          f"steps; {card}")
    print(f"BERT-base peak memory {peak:.2f} GB; {card}")
    print(f"BERT-base step FLOPs (FlopCounterMode) {flops:.4g}, "
          f"{r['flop_share_bf16_peak']:.3f} of the dense bf16 peak; {card}")
    if p["device_busy_ms"] is None:
        print(f"profile bert_step: no device time in the trace (not "
              f"measured); {card}")
    else:
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / ms
        print(f"profile bert_step: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f} ({r['idle_share_unprofiled']:.3f} of "
              f"an unprofiled step), {p['device_ops']} device kernels and "
              f"copies; {card}")
        for kname, kms in p["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "bert_timing", counts)


def _bert_inputs(batch, seq, vocab, seed):
    """Token ids, random segments and a feature mask that pads the last
    BERT_PAD positions of every other row."""
    import numpy as np
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    segs = rng.randint(0, 2, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[::2, seq - BERT_PAD:] = 0.0
    return toks, segs, mask


def phase_bert_output(torch, rec, card):
    """Bert.output and the classification head's logits on the card
    against the CPU's, from the same seeded initial variables; save on the
    card and load onto it again.  Returns the (card, CPU) MLM models for
    bert_step."""
    import tempfile
    from deeplearning4j_tpu_torch.zoo.bert import Bert, BertConfig
    b = BERT
    toks, segs, mask = _bert_inputs(BERT_STEP_BATCH, b["seq"], b["vocab"], 1)
    _reset_counters()
    res, models = {}, {}
    for task in ("mlm", "classification"):
        gpu = Bert(BertConfig(task=task))
        cpu = Bert(BertConfig(task=task), device="cpu")
        same = all(torch.equal(gpu.sd._arrays[n].cpu(), a)
                   for n, a in cpu.sd._arrays.items())
        _require(same, f"{task}: the card's initial variables differ from "
                 f"the CPU's")
        out = "encoder_out" if task == "mlm" else "logits"
        g = gpu.output(toks, segs, mask, out)
        c = cpu.output(toks, segs, mask, out)
        res[task] = float((g.cpu() - c).abs().max())
        _require(bool(g.isfinite().all()) and res[task] <= BERT_OUT_ATOL,
                 f"{task} {out}: card vs CPU |d|max {res[task]}")
        models[task] = (gpu, cpu)
    gpu = models["mlm"][0]
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        path = os.path.join(d, "bert.sdz")
        t0 = time.perf_counter()
        gpu.save(path)
        size = os.path.getsize(path) / 1e6
        back = Bert.load(path, device="cuda")
        serde_s = time.perf_counter() - t0
    same = torch.equal(back.output(toks, segs, mask),
                       gpu.output(toks, segs, mask))
    torch.cuda.synchronize()
    counts = _counters()
    rec["bert_output"] = dict(encoder_out_err=res["mlm"],
                              logits_err=res["classification"],
                              reload_bit_identical=same, zip_mb=size,
                              save_load_s=serde_s, launches=counts,
                              card=card)
    print(f"BERT-base output, batch {BERT_STEP_BATCH} x {b['seq']} (last "
          f"{BERT_PAD} positions of half the rows masked), card vs CPU: "
          f"encoder_out |d|max {res['mlm']:.3g}, classification logits "
          f"{res['classification']:.3g} (atol {BERT_OUT_ATOL}); save + "
          f"load on the card ({size:.0f} MB zip, {serde_s:.1f} s) "
          f"bit-identical: {same}; {card}")
    _no_launches(rec, "bert_output", counts)
    _require(same, "the reloaded model's encoder_out differs")
    return models["mlm"]


def phase_bert_step(torch, rec, gpu, cpu, card):
    """One FLOAT step of BERT-base at batch 4 on the card and on the CPU
    from the same initial variables."""
    from deeplearning4j_tpu_torch.learning import Adam
    b = BERT
    lr = b["lr"]
    pool = _bert_pool(1, BERT_STEP_BATCH, b["seq"], b["vocab"])
    _reset_counters()
    losses = {}
    for dev, bert in (("cuda", gpu), ("cpu", cpu)):
        bert.setTrainingConfig(updater=Adam(lr))
        t0 = time.perf_counter()
        losses[dev] = bert.sd.fit(pool[0]).finalTrainingLoss()
        rec.setdefault("bert_step_s", {})[dev] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _counters()
    e_l = abs(losses["cuda"] - losses["cpu"])
    n_total = n_in = 0
    e_p = 0.0
    for n, c in cpu.sd._var_values().items():
        d = (gpu.sd._arrays[n].cpu() - c).abs()
        n_total += d.numel()
        n_in += int((d <= BERT_PARAM_ATOL).sum())
        e_p = max(e_p, float(d.max()))
    share = n_in / n_total
    rec["bert_step"] = dict(loss_card=losses["cuda"], loss_cpu=losses["cpu"],
                            loss_err=e_l, params_err=e_p,
                            params_within_atol=share, launches=counts,
                            card=card)
    print(f"BERT-base FLOAT step, batch {BERT_STEP_BATCH} x {b['seq']}, card "
          f"vs CPU: loss {losses['cuda']:.7g} vs {losses['cpu']:.7g} (|d| "
          f"{e_l:.3g}, rtol {BERT_LOSS_RTOL}); params |d|max {e_p:.3g} "
          f"(bound 2 lr + 1e-6 = {2 * lr + 1e-6:.3g}), {share:.6f} of them "
          f"within {BERT_PARAM_ATOL} (at least {BERT_PARAM_SHARE}); {card}")
    _no_launches(rec, "bert_step", counts)
    _require(e_l <= BERT_LOSS_RTOL * abs(losses["cpu"])
             and share >= BERT_PARAM_SHARE and e_p <= 2 * lr + 1e-6,
             f"the card's BERT step disagrees with the CPU's: "
             f"{rec['bert_step']}")


def phase_bert_iterator(torch, rec, card):
    """examples/bert_finetune.py's flow on the card: WordPiece over the
    example's corpus, BertIterator MLM batches, Bert.fit."""
    import math
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                              BertMaskedLMMasker,
                                              BertWordPieceTokenizerFactory,
                                              make_vocab)
    from deeplearning4j_tpu_torch.zoo.bert import Bert, BertConfig
    e = BERT_EXAMPLE
    vocab = make_vocab(BERT_CORPUS, size=e["vocab"])
    it = (BertIterator.builder()
          .tokenizer(BertWordPieceTokenizerFactory(vocab))
          .lengthHandling("FIXED_LENGTH", e["seq"]).minibatchSize(e["batch"])
          .sentenceProvider(BERT_CORPUS)
          .task(BertIterator.Task.UNSUPERVISED)
          .masker(BertMaskedLMMasker(0.15)).build())
    _reset_counters()
    bert = Bert(BertConfig(task="mlm", maxSeqLength=e["seq"],
                           vocabSize=len(vocab), hiddenSize=e["hidden"],
                           numLayers=e["layers"], numHeads=e["heads"],
                           intermediateSize=e["ffn"]))
    _require(bert.sd.device.type == "cuda", f"BERT runs on {bert.sd.device}")
    bert.setTrainingConfig(updater=Adam(e["lr"]), dataType="BFLOAT16")
    losses = bert.fit(it, epochs=e["epochs"]).lossCurve()
    torch.cuda.synchronize()
    counts = _counters()
    half = len(losses) // 2
    first, last = (sum(losses[:half]) / half,
                   sum(losses[half:]) / (len(losses) - half))
    rec["bert_iterator"] = dict(losses=losses, vocab=len(vocab),
                                launches=counts, card=card)
    print(f"examples/bert_finetune.py flow on the card: vocab {len(vocab)}, "
          f"{len(losses)} steps of {e['batch']} x {e['seq']}, mean loss "
          f"{first:.4f} (epoch 1) -> {last:.4f} (epoch 2); {card}")
    _no_launches(rec, "bert_iterator", counts)
    _require(len(losses) == e["epochs"] * len(BERT_CORPUS) // e["batch"]
             and all(math.isfinite(v) for v in losses) and last < first,
             f"the example's loss is not finite or does not fall: {losses}")


# ---------------------------------------------------------------------------
# the training user's loop around fit (BASELINE config 1, LeNet-MNIST)
# ---------------------------------------------------------------------------

def _lenet_conf(n_out=10):
    """examples/lenet_mnist.py's configuration, built with the port's
    classes: conv 5x5/20, max-pool 2/2, conv 5x5/50, max-pool 2/2, dense
    500, softmax output; Adam(1e-3), XAVIER, seed 123, flat 28x28 input."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
    c = LENET
    return (NeuralNetConfiguration.builder().seed(c["seed"])
            .updater(Adam(c["lr"])).weightInit("XAVIER").list()
            .layer(ConvolutionLayer.builder().nIn(1).nOut(20)
                   .kernelSize(5, 5).stride(1, 1).activation("relu").build())
            .layer(SubsamplingLayer.builder().poolingType("MAX")
                   .kernelSize(2, 2).stride(2, 2).build())
            .layer(ConvolutionLayer.builder().nOut(50).kernelSize(5, 5)
                   .activation("relu").build())
            .layer(SubsamplingLayer.builder().poolingType("MAX")
                   .kernelSize(2, 2).stride(2, 2).build())
            .layer(DenseLayer.builder().nOut(500).activation("relu").build())
            .layer(OutputLayer.builder("negativeloglikelihood").nOut(n_out)
                   .activation("softmax").build())
            .setInputType(InputType.convolutionalFlat(28, 28, 1)).build())


def _lenet_iterators():
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    c = LENET
    return (MnistDataSetIterator(c["batch"], True, c["seed"],
                                 numExamples=c["n_train"]),
            MnistDataSetIterator(c["test_batch"], False, c["seed"],
                                 numExamples=c["n_test"]))


def phase_lenet_mnist(torch, rec, card):
    """examples/lenet_mnist.py's flow on the card: conf, listeners, fit,
    evaluate, stats.  Returns (net, train iterator, test iterator)."""
    import math
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener, ScoreIterationListener)
    c = LENET
    train, test = _lenet_iterators()
    net = MultiLayerNetwork(_lenet_conf()).init()
    _require(net.device.type == "cuda", f"the net runs on {net.device}")
    scores = CollectScoresIterationListener(c["score_every"])
    net.setListeners(ScoreIterationListener(c["score_every"]), scores)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the ResNet-50 that later phases reuse stays allocated: the run's own
    # peak is the peak less what was allocated before it
    base = torch.cuda.memory_allocated() / 1e9
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(train, epochs=c["epochs"])
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = net.evaluate(test)
    peak = torch.cuda.max_memory_allocated() / 1e9 - base
    steps = net.iterationCount
    print(ev.stats())
    r = dict(steps=steps, ms_per_step=wall * 1e3 / steps,
             images_per_s=c["batch"] * steps / wall, fit_s=wall,
             peak_gb=peak, allocated_before_gb=base,
             accuracy=ev.accuracy(),
             is_synthetic=train.isSynthetic, scores=scores.getScores(),
             card=card)
    rec["lenet_mnist"] = r
    print(f"LeNet-MNIST (examples/lenet_mnist.py settings; isSynthetic "
          f"{train.isSynthetic}): {steps} steps of {c['batch']} in "
          f"{wall:.2f} s, {r['ms_per_step']:.3f} ms/step, "
          f"{r['images_per_s']:.0f} images/s, peak {peak:.3f} GB above "
          f"the {base:.3f} GB allocated before, "
          f"accuracy {ev.accuracy():.4f} on {ev.getNumRowCounter()} test "
          f"images; {card}")
    # one profiled step, on a clone so the trained net stays as it is
    train.reset()
    ds, twin = train.next(), net.clone()
    twin.fit(ds)
    p = r["step_profile"] = _device_breakdown(
        torch, lambda: (twin.fit(ds), twin.score()), top=6)
    counts = _counters()
    if p["device_busy_ms"] is None:
        print(f"profile lenet_step: no device time in the trace (not "
              f"measured); {card}")
    else:
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / \
            r["ms_per_step"]
        print(f"profile lenet_step: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.3f} ms, idle share "
              f"{p['idle_share']:.3f} ({r['idle_share_unprofiled']:.3f} of "
              f"an unprofiled step), {p['device_ops']} device kernels and "
              f"copies; {card}")
        for kname, kms in p["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "lenet_mnist", counts)
    want = c["epochs"] * c["n_train"] // c["batch"]
    _require(steps == want, f"iterationCount {steps}, expected {want}")
    _require(scores.getScores() and all(math.isfinite(s) for _, s in
                                        scores.getScores()),
             f"scores not finite: {scores.getScores()}")
    _require(ev.accuracy() > LENET_ACCURACY,
             f"accuracy {ev.accuracy()} <= {LENET_ACCURACY}")
    return net, train, test


def _park(gnet, device):
    """Move a graph's parameters, layer state and updater state to
    ``device``, bit for bit; returns the graph."""
    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    gnet.params_, gnet.state_ = move(gnet.params_), move(gnet.state_)
    gnet.optState_ = move(gnet.optState_)
    return gnet


def _trees_equal(torch, a, b):
    """Two nested dicts of tensors hold the same keys and the same bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _trees_equal(torch, a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def phase_listeners(torch, rec, net, train, card):
    """Two steps of a clone of the trained LeNet on the card with the
    score-collecting, performance and checkpoint listeners."""
    import tempfile
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener, CollectScoresIterationListener,
        PerformanceListener)
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    c = net.clone()
    train.reset()
    batches = [train.next() for _ in range(2)]
    _reset_counters()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        col = CollectScoresIterationListener(1)
        perf = PerformanceListener(frequency=1)
        ckpt = CheckpointListener(d, saveEveryNIterations=1, keepLast=1)
        c.setListeners(col, perf, ckpt)
        same_scores = True
        for ds in batches:
            c.fit(ds)
            same_scores &= col.getScores()[-1] == (c.iterationCount,
                                                   c.score())
        path = os.path.join(d, f"checkpoint_iter_{c.iterationCount}.zip")
        back = ModelSerializer.restoreMultiLayerNetwork(path)
        restored = _trees_equal(torch, back.params_, c.params_) and \
            _trees_equal(torch, back.optState_, c.optState_)
        files = sorted(os.listdir(d))
    counts = _counters()
    rec["listeners"] = dict(scores=col.getScores(),
                            samples_per_s=perf.samplesPerSecond,
                            checkpoints=files, launches=counts, card=card)
    print(f"listeners on the card: scores {col.getScores()} equal score() "
          f"after each step: {same_scores}; PerformanceListener "
          f"{perf.samplesPerSecond:.0f} samples/s (synchronised); "
          f"checkpoint {files} restores bit for bit: {restored}; {card}")
    _no_launches(rec, "listeners", counts)
    _require(same_scores, "collected scores differ from score()")
    _require(back.device.type == "cuda",
             f"the checkpoint restored on {back.device}, not cuda")
    _require(restored, "the checkpoint does not restore bit for bit")


def phase_serializer(torch, rec, net, train, test, resnet, card):
    """ModelSerializer on the card: the trained LeNet with its updater
    state and a NormalizerStandardize, then the full-width BFLOAT16
    ResNet-50 of the resnet phases with its Nesterovs state."""
    import tempfile
    from deeplearning4j_tpu_torch.datasets import NormalizerStandardize
    from deeplearning4j_tpu_torch.utils import ModelSerializer as MS
    norm = NormalizerStandardize()
    norm.fit(train)
    test.reset()
    x = test.next().features
    _reset_counters()
    res = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        path = os.path.join(d, "lenet.zip")
        t0 = time.perf_counter()
        MS.writeModel(net, path, saveUpdater=True, normalizer=norm)
        t1 = time.perf_counter()
        back = MS.restoreMultiLayerNetwork(path)
        nback = MS.restoreNormalizer(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res["lenet"] = dict(
            zip_mb=os.path.getsize(path) / 1e6, write_s=t1 - t0,
            read_s=t2 - t1, on_card=back.device.type == "cuda",
            params=_trees_equal(torch, back.params_, net.params_),
            updater=_trees_equal(torch, back.optState_, net.optState_),
            counters=(back.iterationCount, back.epochCount) ==
            (net.iterationCount, net.epochCount),
            output=bool(torch.equal(back.output(x).torch,
                                    net.output(x).torch)),
            normalizer=bool((nback.mean == norm.mean).all()
                            and (nback.std == norm.std).all()))
        gnet, pool = resnet
        path = os.path.join(d, "resnet50.zip")
        t0 = time.perf_counter()
        MS.writeModel(gnet, path, saveUpdater=True)
        t1 = time.perf_counter()
        gback = MS.restoreComputationGraph(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r = dict(zip_mb=os.path.getsize(path) / 1e6, write_s=t1 - t0,
                 read_s=t2 - t1, on_card=gback.device.type == "cuda",
                 params=_trees_equal(torch, gback.params_, gnet.params_),
                 state=_trees_equal(torch, gback.state_, gnet.state_),
                 updater=_trees_equal(torch, gback.optState_,
                                      gnet.optState_))
    gnet.fit(pool[0])
    gback.fit(pool[0])
    a, b = gnet.score(), gback.score()
    r.update(loss=a, restored_loss=b, loss_rel=abs(a - b) / abs(a))
    res["resnet50"] = r
    counts = _counters()
    rec["serializer"] = dict(res, launches=counts, card=card)
    for name, v in res.items():
        checks = {k: x for k, x in v.items() if isinstance(x, bool)}
        print(f"ModelSerializer {name}: {v['zip_mb']:.1f} MB zip, write "
              f"{v['write_s']:.2f} s, read {v['read_s']:.2f} s; "
              f"{checks}; {card}")
    print(f"ResNet-50 one more step: loss {a:.7g}, restored {b:.7g} "
          f"(rel {r['loss_rel']:.3g}, bound {SERDE_LOSS_RTOL}); {card}")
    _no_launches(rec, "serializer", counts)
    off = [n for n, v in res.items() if not v["on_card"]]
    _require(not off, f"{off} not restored on cuda")
    bad = [f"{n}.{k}" for n, v in res.items() for k, x in v.items()
           if isinstance(x, bool) and not x and k != "on_card"]
    _require(not bad, f"not restored bit for bit: {bad}")
    _require(r["loss_rel"] <= SERDE_LOSS_RTOL,
             f"the restored ResNet-50's step loss differs: {a} vs {b}")


def phase_early_stopping(torch, rec, train, test, card):
    """EarlyStoppingTrainer on the LeNet configuration, on the card."""
    import tempfile
    from deeplearning4j_tpu_torch.optimize import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    _reset_counters()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        es = (EarlyStoppingConfiguration.builder()
              .epochTerminationConditions(
                  MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                  ScoreImprovementEpochTerminationCondition(ES_PATIENCE))
              .scoreCalculator(DataSetLossCalculator(test))
              .modelSaver(LocalFileModelSaver(d)).build())
        result = EarlyStoppingTrainer(es, _lenet_conf(), train).fit()
        best = result.getBestModel()
        best_score = DataSetLossCalculator(test).calculateScore(best)
    wall = time.perf_counter() - t0
    counts = _counters()
    sve = result.scoreVsEpoch
    want_epoch = min(sve, key=sve.get)
    rel = abs(best_score - result.bestModelScore) / abs(result.bestModelScore)
    rec["early_stopping"] = dict(
        reason=result.terminationReason, details=result.terminationDetails,
        score_vs_epoch=sve, best_epoch=result.bestModelEpoch,
        best_score=result.bestModelScore, restored_score=best_score,
        score_rel=rel, total_epochs=result.totalEpochs, seconds=wall,
        launches=counts, card=card)
    print(f"early stopping on the card: {result}; scoreVsEpoch {sve}; the "
          f"best model restored on {best.device} scores {best_score:.7g} "
          f"(rel {rel:.3g}); {wall:.1f} s; {card}")
    _no_launches(rec, "early_stopping", counts)
    _require(result.bestModelEpoch == want_epoch and
             result.bestModelScore == sve[want_epoch],
             f"best epoch {result.bestModelEpoch} / score "
             f"{result.bestModelScore} do not match scoreVsEpoch {sve}")
    _require(best.device.type == "cuda", f"best model on {best.device}")
    _require(rel <= ES_SCORE_RTOL,
             f"restored best model scores {best_score}, recorded "
             f"{result.bestModelScore}")


def _solver_mlp(algo):
    from deeplearning4j_tpu_torch.learning import Sgd
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    return (NeuralNetConfiguration.builder().seed(11).optimizationAlgo(algo)
            .updater(Sgd(0.1)).list()
            .layer(DenseLayer.builder().nIn(3).nOut(32).activation("tanh")
                   .build())
            .layer(OutputLayer.builder("mse").nIn(32).nOut(2)
                   .activation("identity").build()).build())


def phase_solvers_transfer(torch, rec, net, train, resnet, card):
    """The line-search solvers, transfer learning on the trained LeNet
    and ComputationGraph.evaluate on ResNet-50, on the card."""
    import math
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import (MultiLayerNetwork,
                                                 TransferLearning)
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    rng = np.random.RandomState(0)
    x = rng.randn(256, 3).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], x[:, 2] * x[:, 0]], 1) \
        .astype(np.float32)
    _reset_counters()
    solvers = {}
    for algo in SOLVER_ALGOS:
        m = MultiLayerNetwork(_solver_mlp(algo)).init()
        scores = []
        for _ in range(SOLVER_STEPS):
            m.fit(DataSet(x, y))
            scores.append(m.score())
        solvers[algo] = scores
    # transfer: freeze through the dense layer, a new 5-class head
    t2 = (TransferLearning.Builder(net).setFeatureExtractor(4)
          .removeOutputLayer()
          .addLayer(OutputLayer.builder("negativeloglikelihood").nIn(500)
                    .nOut(TRANSFER_NOUT).activation("softmax").build())
          .build())
    frozen0 = {k: v.torch.clone() for k, v in t2.paramTable().items()
               if int(k.split("_")[0]) <= 4}
    head0 = t2.getParam("5_W").torch.clone()
    train.reset()
    ds = train.next()
    cls = ds.labels.torch.argmax(1) % TRANSFER_NOUT
    t2.fit(DataSet(ds.features, torch.eye(TRANSFER_NOUT)[cls]))
    table = t2.paramTable()
    frozen_same = all(torch.equal(table[k].torch, v)
                      for k, v in frozen0.items())
    head_moved = not torch.equal(t2.getParam("5_W").torch, head0)
    # ComputationGraph.evaluate on the ResNet-50 of the resnet phases
    gnet, pool = resnet
    ev = gnet.evaluate(ListDataSetIterator(pool))
    counts = _counters()
    rec["solvers_transfer"] = dict(
        solver_scores=solvers, transfer_frozen_unchanged=frozen_same,
        transfer_head_changed=head_moved, transfer_on=str(t2.device),
        resnet_eval_count=ev.getNumRowCounter(), launches=counts, card=card)
    for algo, s in solvers.items():
        print(f"{algo} on the card, {SOLVER_STEPS} full-batch steps: "
              f"scores {[round(v, 6) for v in s]}; {card}")
    print(f"TransferLearning on the trained LeNet ({t2.device}): frozen "
          f"layers 0-4 bit-unchanged {frozen_same}, new {TRANSFER_NOUT}-"
          f"class head changed {head_moved}; ComputationGraph.evaluate on "
          f"ResNet-50: {ev.getNumRowCounter()} examples, accuracy "
          f"{ev.accuracy():.4f} (random labels); {card}")
    _no_launches(rec, "solvers_transfer", counts)
    bad = [a for a, s in solvers.items()
           if not all(math.isfinite(v) for v in s) or not s[-1] < s[0]]
    _require(not bad, f"solvers not finite or not decreasing: {bad}")
    _require(t2.device.type == "cuda",
             f"the transferred net runs on {t2.device}, not cuda")
    _require(frozen_same and head_moved,
             "transfer learning: frozen params moved or the head did not")
    want = sum(d.numExamples() for d in pool)
    _require(ev.getNumRowCounter() == want,
             f"evaluate counted {ev.getNumRowCounter()}, expected {want}")


def _fill_stripped_consts(gd, manifest, seed=TF_BERT["seed"],
                          std=TF_BERT["std"]):
    """Refill, in place, the content of the Consts the skeleton's
    generator stripped: in the manifest's order, each from one
    ``np.random.RandomState(seed)`` as N(0, std) in the Const's dtype.
    ``gd`` is the port's decoded GraphDef or a tensorflow one (the tests
    refill both).  Returns ``gd``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    nodes = {n.name: n for n in gd.node}
    for e in manifest["stripped"]:
        arr = rng.normal(0.0, std, e["shape"]).astype(e["dtype"])
        nodes[e["name"]].attr["value"].tensor.tensor_content = arr.tobytes()
    return gd


def _tf_bert_io(gd):
    """The frozen graph's input placeholders (ids, mask) and its output
    (the last Identity: ``last_hidden_state``), as the example finds
    them."""
    phs = [n.name for n in gd.node if n.op == "Placeholder"]
    out = [n.name for n in gd.node if n.op == "Identity"][-1]
    return ([p for p in phs if "input_ids" in p][0],
            [p for p in phs if "attention_mask" in p][0], out)


def _tf_bert_batch(c=TF_BERT):
    """A seeded batch: token ids, an attention mask that pads the last
    BERT_PAD positions of every other row, one-hot labels."""
    import numpy as np
    b, t = c["batch"], c["seq"]
    rng = np.random.RandomState(c["seed"])
    ids = rng.randint(0, c["vocab"], (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[::2, t - BERT_PAD:] = 0
    y = np.eye(c["classes"], dtype=np.float32)[
        rng.randint(0, c["classes"], b)]
    return ids, mask, y


def phase_tf_decode(torch, rec, card, c=TF_BERT):
    """Decode the committed skeleton with the port's decoder and hold it to
    its manifest.  Returns (GraphDef, manifest)."""
    from deeplearning4j_tpu_torch.imports.graphdef import (decode_graphdef,
                                                           dtype_name)
    _reset_counters()
    with open(c["stem"] + ".json") as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    gd = decode_graphdef(c["stem"] + ".pb")
    decode_s = time.perf_counter() - t0
    nodes = {n.name: n for n in gd.node}
    bad = []
    for e in manifest["stripped"]:
        n = nodes.get(e["name"])
        t = n.attr["value"].tensor if n is not None else None
        if t is None or n.op != "Const" or t.tensor_content \
                or dtype_name(t.dtype) != e["dtype"] \
                or [d.size for d in t.tensor_shape.dim] != e["shape"]:
            bad.append(e["name"])
    counts = _counters()
    size = os.path.getsize(c["stem"] + ".pb")
    rec["tf_decode"] = dict(nodes=len(gd.node),
                            stripped=len(manifest["stripped"]),
                            pb_bytes=size, decode_s=decode_s,
                            mismatched=bad, launches=counts, card=card)
    print(f"TF skeleton: {size} bytes, {len(gd.node)} nodes decoded in "
          f"{decode_s:.3f} s, {len(manifest['stripped'])} stripped Consts, "
          f"{len(bad)} unlike the manifest; {card}")
    _no_launches(rec, "tf_decode", counts)
    _require(len(gd.node) == c["nodes"] == manifest["nodes"],
             f"{len(gd.node)} nodes, manifest {manifest['nodes']}, "
             f"expected {c['nodes']}")
    _require(len(manifest["stripped"]) == c["stripped"] and not bad,
             f"stripped Consts unlike the manifest: {bad}")
    return gd, manifest


def phase_tf_import_bert(torch, rec, gd, manifest, card, c=TF_BERT):
    """Refill the skeleton, import it onto the card and run its FLOAT
    forward against the same graph imported on the CPU.  Returns (the card
    graph, the CPU graph, the card's output on the host)."""
    from collections import Counter
    from deeplearning4j_tpu_torch.imports import TFGraphMapper
    _reset_counters()
    t0 = time.perf_counter()
    _fill_stripped_consts(gd, manifest, c["seed"], c["std"])
    fill_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = TFGraphMapper.importGraph(gd)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    _require(sd.device.type == "cuda", f"the graph lives on {sd.device}")
    hist = dict(Counter(n.op for n in sd._ops))
    n_vars = sum(v.numel() for v in sd._var_values().values())
    ids_ph, mask_ph, out = _tf_bert_io(gd)
    ids, mask, _ = _tf_bert_batch(c)
    feed = {ids_ph: ids, mask_ph: mask}
    g = sd.outputSingle(feed, out)                      # warm-up
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        g = sd.outputSingle(feed, out)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 1e9
    cpu = TFGraphMapper.importGraph(gd, device="cpu")
    t0 = time.perf_counter()
    h = cpu.outputSingle(feed, out)
    cpu_s = time.perf_counter() - t0
    g = g.cpu()
    err = float((g - h).abs().max())
    counts = _counters()
    rec["tf_import_bert"] = dict(
        fill_s=fill_s, import_s=import_s, forward_ms=fwd_ms, peak_gb=peak,
        ops=sum(hist.values()), op_kinds=len(hist), histogram=hist,
        variables=len(sd._var_values()), parameters=n_vars,
        out_err_vs_cpu=err, cpu_forward_s=cpu_s, launches=counts,
        card=card)
    print(f"TF import of BERT-base: refill {fill_s:.2f} s, import onto the "
          f"card {import_s:.2f} s, {sum(hist.values())} ops of {len(hist)} "
          f"kinds, {len(sd._var_values())} variables ({n_vars} "
          f"parameters); {card}")
    print(f"TF BERT-base FLOAT forward {c['batch']} x {c['seq']} (last "
          f"{BERT_PAD} positions of half the rows masked): {fwd_ms:.2f} ms, "
          f"peak {peak:.2f} GB; card vs CPU |d|max {err:.3g} (atol "
          f"{TF_BERT_OUT_ATOL}; CPU forward {cpu_s:.1f} s); {card}")
    _no_launches(rec, "tf_import_bert", counts)
    _require(hist == TF_BERT_OPS,
             f"op histogram {hist}, the reference's {TF_BERT_OPS}")
    _require(tuple(g.shape) == (c["batch"], c["seq"], c["hidden"])
             and bool(g.isfinite().all()) and err <= TF_BERT_OUT_ATOL,
             f"output {tuple(g.shape)}, card vs CPU |d|max {err}")
    return sd, cpu, g.numpy()


def _tf_head(sd, gd, c=TF_BERT):
    """The example's classification head and training config."""
    import numpy as np
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.learning import Adam
    ids_ph, mask_ph, out = _tf_bert_io(gd)
    rng = np.random.RandomState(c["seed"] + 1)
    w = sd.var("cls/W", (rng.randn(c["hidden"], c["classes"]) * 0.05)
               .astype(np.float32))
    labels = sd.placeholder("labels", shape=[c["batch"], c["classes"]])
    logits = sd.getVariable(out).mean(1).mmul(w)
    loss = sd.loss().softmaxCrossEntropy(labels, logits, name="loss")
    sd.setLossVariables(loss)
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(c["lr"]), dataSetFeatureMapping=[ids_ph, mask_ph],
        dataSetLabelMapping=["labels"]))


def phase_tf_finetune(torch, rec, gd, gpu, cpu, card, c=TF_BERT):
    """The example's fine-tune on the card; its first step held against
    the same step on the CPU."""
    import math
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    ids_ph, mask_ph, _ = _tf_bert_io(gd)
    for sd in (gpu, cpu):
        _tf_head(sd, gd, c)
    ids, mask, y = _tf_bert_batch(c)
    mds = MultiDataSet(features=[ids, mask], labels=[y])
    feed = {ids_ph: ids, mask_ph: mask, "labels": y}
    _reset_counters()
    l0 = float(gpu.outputSingle(feed, "loss"))
    first = {}
    for dev, sd in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        first[dev] = sd.fit(mds).finalTrainingLoss()
        rec.setdefault("tf_step_s", {})[dev] = time.perf_counter() - t0
    e_l = abs(first["cuda"] - first["cpu"])
    n_total = n_in = 0
    e_p = 0.0
    for n, v in cpu._var_values().items():
        d = (gpu._arrays[n].cpu() - v).abs()
        n_total += d.numel()
        n_in += int((d <= TF_BERT_PARAM_ATOL).sum())
        e_p = max(e_p, float(d.max()))
    share = n_in / n_total
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = gpu.fit(mds, epochs=c["steps"] - 1)   # ends in one loss fetch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    l1 = float(gpu.outputSingle(feed, "loss"))
    curve = [first["cuda"]] + hist.lossCurve()
    p = _device_breakdown(torch, lambda: gpu.fit(mds), top=10)
    counts = _counters()
    ms = wall * 1e3 / (c["steps"] - 1)
    r = dict(loss_before=l0, loss_after=l1, losses=curve,
             iterations=gpu.iterationCount, ms_per_step=ms,
             tokens_per_s=c["batch"] * c["seq"] * 1e3 / ms, peak_gb=peak,
             step_loss_card=first["cuda"], step_loss_cpu=first["cpu"],
             step_loss_err=e_l, step_params_err=e_p,
             step_params_within_atol=share, step_profile=p,
             launches=counts, card=card)
    rec["tf_finetune"] = r
    lr = c["lr"]
    print(f"TF BERT-base FLOAT fine-tune step, {c['batch']} x {c['seq']}, "
          f"card vs CPU: loss {first['cuda']:.7g} vs {first['cpu']:.7g} "
          f"(|d| {e_l:.3g}, rtol {TF_BERT_LOSS_RTOL}); variables |d|max "
          f"{e_p:.3g} (bound 2 lr + 1e-6 = {2 * lr + 1e-6:.3g}), "
          f"{share:.6f} of them within {TF_BERT_PARAM_ATOL} (at least "
          f"{TF_BERT_PARAM_SHARE}); {card}")
    print(f"TF BERT-base fine-tune, Adam({lr}), {c['steps']} steps on one "
          f"batch: loss {l0:.4f} -> {l1:.4f}; {ms:.2f} ms a step, "
          f"{r['tokens_per_s']:.0f} tokens/s over {c['steps'] - 1} steps, "
          f"peak {peak:.2f} GB; {card}")
    if p["device_busy_ms"] is None:
        print(f"profile tf_finetune step: no device time in the trace (not "
              f"measured); {card}")
    else:
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / ms
        print(f"profile tf_finetune step: wall {p['wall_ms']:.2f} ms, device "
              f"busy {p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f} ({r['idle_share_unprofiled']:.3f} of "
              f"an unprofiled step), {p['device_ops']} device kernels and "
              f"copies; {card}")
        for kname, kms in p["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "tf_finetune", counts)
    _require(e_l <= TF_BERT_LOSS_RTOL * abs(first["cpu"])
             and share >= TF_BERT_PARAM_SHARE and e_p <= 2 * lr + 1e-6,
             f"the card's fine-tune step disagrees with the CPU's: "
             f"loss {e_l}, variables {e_p}, share {share}")
    _require(all(math.isfinite(v) for v in curve) and l1 < l0,
             f"the fine-tune loss did not fall: {l0} -> {l1}, {curve}")


def phase_tf_graphrunner(torch, rec, gd, out_ref, card, c=TF_BERT):
    """GraphRunner(backend="samediff") on the refilled graph against the
    importer's own output on the card."""
    import numpy as np
    from deeplearning4j_tpu_torch.imports import GraphRunner
    ids_ph, mask_ph, out = _tf_bert_io(gd)
    ids, mask, _ = _tf_bert_batch(c)
    _reset_counters()
    t0 = time.perf_counter()
    gr = GraphRunner(gd, [ids_ph, mask_ph], [out], backend="samediff")
    res = gr.run({ids_ph: ids, mask_ph: mask})[out]
    run_s = time.perf_counter() - t0
    counts = _counters()
    same = bool(np.array_equal(res, out_ref))
    rec["tf_graphrunner"] = dict(bit_identical=same, run_s=run_s,
                                 device=str(gr._sd.device),
                                 launches=counts, card=card)
    gr.close()
    print(f"GraphRunner(backend='samediff') on {rec['tf_graphrunner']['device']}"
          f": import and run {run_s:.2f} s, output bit-identical to the "
          f"importer's: {same}; {card}")
    _no_launches(rec, "tf_graphrunner", counts)
    _require(rec["tf_graphrunner"]["device"].startswith("cuda") and same,
             f"GraphRunner's output differs or ran on "
             f"{rec['tf_graphrunner']['device']}")


# ---------------------------------------------------------------------------
# BERT-base through ONNX import (phases 38-41)
# ---------------------------------------------------------------------------

def _skeleton_writer():
    """The skeleton generator's wire-level writer
    (``tests/fixtures/make_onnx_bert_skeleton.py``; importing it needs
    neither torch nor transformers)."""
    import importlib.util
    path = os.path.join(ROOT, "tests", "fixtures",
                        "make_onnx_bert_skeleton.py")
    spec = importlib.util.spec_from_file_location("make_onnx_bert_skeleton",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fill_stripped_initializers(skeleton, manifest, seed=ONNX_BERT["seed"],
                                std=ONNX_BERT["std"]):
    """The complete ModelProto's bytes: the skeleton with the raw_data of
    each initializer its generator stripped put back, in the manifest's
    order each drawn from one ``np.random.RandomState(seed)`` as N(0, std)
    in the initializer's dtype.  Every other byte is the skeleton's."""
    import numpy as np
    gen = _skeleton_writer()
    rng = np.random.RandomState(seed)
    raw = {e["name"]: rng.normal(0.0, std, e["shape"]).astype(e["dtype"])
           .tobytes() for e in manifest["stripped"]}

    def fill(tensor):                                 # TensorProto.raw_data
        name = gen.tensor_header(tensor)[0]
        return tensor + gen.field(9, raw.pop(name)) if name in raw \
            else tensor

    out = gen.rewrite_initializers(skeleton, fill)
    if raw:
        raise ValueError(f"initializers of the manifest not in the "
                         f"skeleton: {sorted(raw)[:5]}")
    return out


def phase_onnx_fixtures(torch, rec, card):
    """The torch-exported ONNX fixtures imported onto the card, each held
    to torch's own output."""
    import numpy as np
    from deeplearning4j_tpu_torch.imports import OnnxImporter
    fix = os.path.join(ROOT, "tests", "fixtures")
    _reset_counters()
    res, bad = {}, []
    for stem, tol in ONNX_FIXTURES.items():
        io = np.load(os.path.join(fix, f"{stem}_io.npz"))
        t0 = time.perf_counter()
        sd, ins, outs = OnnxImporter.importModel(
            os.path.join(fix, f"{stem}.onnx"))
        feed = {n: io[n if n in io else "x"] for n in ins}
        got = sd.outputSingle(feed, outs[0]).cpu().numpy()
        err = float(np.abs(got - io["y"]).max()) \
            if got.shape == io["y"].shape else float("inf")
        res[stem] = dict(device=str(sd.device), max_abs_err=err, atol=tol,
                         ops=len(sd._ops), s=time.perf_counter() - t0)
        if err > tol or sd.device.type != "cuda":
            bad.append(stem)
        print(f"ONNX {stem}: {len(sd._ops)} ops on {sd.device}, |d|max "
              f"{err:.3g} against torch's output (atol {tol}); {card}")
    counts = _counters()
    rec["onnx_fixtures"] = dict(fixtures=res, launches=counts, card=card)
    _no_launches(rec, "onnx_fixtures", counts)
    _require(not bad, f"ONNX fixtures unlike torch's output: {bad}")


def _onnx_skeleton(c=ONNX_BERT):
    with open(c["stem"] + ".json") as f:
        manifest = json.load(f)
    with open(c["stem"] + ".onnx", "rb") as f:
        return f.read(), manifest


def phase_onnx_decode(torch, rec, card, c=ONNX_BERT):
    """Decode the committed skeleton with the port's ModelProto reader and
    hold it to its manifest.  Returns (skeleton bytes, manifest)."""
    from collections import Counter
    from deeplearning4j_tpu_torch.imports.onnx_import import (
        _DTYPES, _Node, _collect, _unpack_varints)
    _reset_counters()
    skeleton, manifest = _onnx_skeleton(c)
    t0 = time.perf_counter()
    graph = _collect(_collect(skeleton)[7][0])
    nodes = [_Node(b) for b in graph.get(1, [])]
    inits = {}
    for b in graph.get(5, []):
        f = _collect(b)
        inits[f[8][0].decode()] = (
            _DTYPES[f.get(2, [1])[0]].__name__, _unpack_varints(f.get(1, [])),
            9 in f)
    decode_s = time.perf_counter() - t0
    hist = dict(Counter(n.op_type for n in nodes))
    bad = [e["name"] for e in manifest["stripped"]
           if inits.get(e["name"]) != (e["dtype"], e["shape"], False)]
    counts = _counters()
    rec["onnx_decode"] = dict(nodes=len(nodes), initializers=len(inits),
                              stripped=len(manifest["stripped"]),
                              onnx_bytes=len(skeleton), decode_s=decode_s,
                              histogram=hist, mismatched=bad,
                              launches=counts, card=card)
    print(f"ONNX skeleton: {len(skeleton)} bytes, {len(nodes)} nodes and "
          f"{len(inits)} initializers decoded in {decode_s:.3f} s, "
          f"{len(manifest['stripped'])} stripped, {len(bad)} unlike the "
          f"manifest; {card}")
    _no_launches(rec, "onnx_decode", counts)
    _require(len(nodes) == c["nodes"] == manifest["nodes"]
             and hist == manifest["ops"],
             f"{len(nodes)} nodes {hist}, manifest {manifest['nodes']} "
             f"{manifest['ops']}")
    _require(len(manifest["stripped"]) == c["stripped"] and not bad,
             f"stripped initializers unlike the manifest: {bad}")
    return skeleton, manifest


def _onnx_bert_batch(c=ONNX_BERT):
    """The TF route's seeded batch as the export's int64 inputs, with
    token types 0 then 1."""
    import numpy as np
    ids, mask, y = _tf_bert_batch(c)
    tt = np.zeros_like(ids)
    tt[:, c["seq"] // 2:] = 1
    return {"input_ids": ids.astype(np.int64),
            "attention_mask": mask.astype(np.int64),
            "token_type_ids": tt.astype(np.int64)}, y


def phase_onnx_import_bert(torch, rec, skeleton, manifest, card,
                           c=ONNX_BERT):
    """Refill the skeleton, import it onto the card through
    ``OnnxImporter.importModel(path)`` and run its FLOAT forward against
    the same file imported on the CPU.  Returns (the card graph, the CPU
    graph, the graph's input and output names)."""
    import tempfile
    from collections import Counter
    from deeplearning4j_tpu_torch.imports import OnnxImporter
    _reset_counters()
    t0 = time.perf_counter()
    model = _fill_stripped_initializers(skeleton, manifest, c["seed"],
                                        c["std"])
    fill_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "bert_base.onnx")
        with open(path, "wb") as f:
            f.write(model)
        del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        sd, ins, outs = OnnxImporter.importModel(path)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, cins, couts = OnnxImporter.importModel(path, device="cpu")
        cpu_import_s = time.perf_counter() - t0
    _require(sd.device.type == "cuda" and (ins, outs) == (cins, couts),
             f"the graph lives on {sd.device}; inputs {ins} {cins}")
    hist = dict(Counter(n.op for n in sd._ops))
    n_vars = sum(v.numel() for v in sd._var_values().values())
    feed, _ = _onnx_bert_batch(c)
    out = outs[0]
    g = sd.outputSingle(feed, out)                      # warm-up
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        g = sd.outputSingle(feed, out)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    h = cpu.outputSingle(feed, out)
    cpu_s = time.perf_counter() - t0
    g = g.cpu()
    err = float((g - h).abs().max())
    counts = _counters()
    rec["onnx_import_bert"] = dict(
        fill_s=fill_s, import_s=import_s, cpu_import_s=cpu_import_s,
        forward_ms=fwd_ms, peak_gb=peak, held_before_gb=held,
        ops=sum(hist.values()),
        op_kinds=len(hist), histogram=hist,
        variables=len(sd._var_values()), parameters=n_vars,
        out_err_vs_cpu=err, cpu_forward_s=cpu_s, launches=counts,
        card=card)
    print(f"ONNX import of BERT-base: refill {fill_s:.2f} s, import onto "
          f"the card {import_s:.2f} s (CPU {cpu_import_s:.2f} s), "
          f"{sum(hist.values())} ops of {len(hist)} kinds, "
          f"{len(sd._var_values())} variables ({n_vars} parameters); {card}")
    print(f"ONNX BERT-base FLOAT forward {c['batch']} x {c['seq']} (last "
          f"{BERT_PAD} positions of half the rows masked): {fwd_ms:.2f} ms, "
          f"peak {peak:.2f} GB ({held:.2f} GB of it held before the "
          f"phase); card vs CPU |d|max {err:.3g} (atol {TF_BERT_OUT_ATOL}; "
          f"CPU forward {cpu_s:.1f} s); {card}")
    _no_launches(rec, "onnx_import_bert", counts)
    _require(hist == ONNX_BERT_OPS,
             f"op histogram {hist}, the reference's {ONNX_BERT_OPS}")
    _require(tuple(g.shape) == (c["batch"], c["seq"], c["hidden"])
             and bool(g.isfinite().all()) and err <= TF_BERT_OUT_ATOL,
             f"output {tuple(g.shape)}, card vs CPU |d|max {err}")
    return sd, cpu, ins, out


def _onnx_head(sd, ins, out, c=ONNX_BERT):
    """A two-class head on the CLS row and the TF route's training
    config."""
    import numpy as np
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.learning import Adam
    rng = np.random.RandomState(c["seed"] + 1)
    w = sd.var("cls/W", (rng.randn(c["hidden"], c["classes"]) * 0.05)
               .astype(np.float32))
    labels = sd.placeholder("labels", shape=[c["batch"], c["classes"]])
    cls = sd.getVariable(out).get(slice(None), 0).reshape(c["batch"],
                                                          c["hidden"])
    loss = sd.loss().softmaxCrossEntropy(labels, cls.mmul(w), name="loss")
    sd.setLossVariables(loss)
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(c["lr"]), dataSetFeatureMapping=list(ins),
        dataSetLabelMapping=["labels"]))


def phase_onnx_finetune(torch, rec, gpu, cpu, ins, out, card, c=ONNX_BERT):
    """Fine-tune the imported BERT-base on the card; its first step held
    against the same step on the CPU."""
    import math
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    for sd in (gpu, cpu):
        _onnx_head(sd, ins, out, c)
    feed, y = _onnx_bert_batch(c)
    mds = MultiDataSet(features=[feed[n] for n in ins], labels=[y])
    feed = {**feed, "labels": y}
    _reset_counters()
    l0 = float(gpu.outputSingle(feed, "loss"))
    first = {}
    for dev, sd in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        first[dev] = sd.fit(mds).finalTrainingLoss()
        rec.setdefault("onnx_step_s", {})[dev] = time.perf_counter() - t0
    e_l = abs(first["cuda"] - first["cpu"])
    n_total = n_in = 0
    e_p = 0.0
    for n, v in cpu._var_values().items():
        d = (gpu._arrays[n].cpu() - v).abs()
        n_total += d.numel()
        n_in += int((d <= TF_BERT_PARAM_ATOL).sum())
        e_p = max(e_p, float(d.max()))
    share = n_in / n_total
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    hist = gpu.fit(mds, epochs=c["steps"] - 1)   # ends in one loss fetch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    l1 = float(gpu.outputSingle(feed, "loss"))
    curve = [first["cuda"]] + hist.lossCurve()
    p = _device_breakdown(torch, lambda: gpu.fit(mds), top=10)
    counts = _counters()
    ms = wall * 1e3 / (c["steps"] - 1)
    r = dict(loss_before=l0, loss_after=l1, losses=curve,
             iterations=gpu.iterationCount, ms_per_step=ms,
             tokens_per_s=c["batch"] * c["seq"] * 1e3 / ms, peak_gb=peak,
             held_before_gb=held,
             step_loss_card=first["cuda"], step_loss_cpu=first["cpu"],
             step_loss_err=e_l, step_params_err=e_p,
             step_params_within_atol=share, step_profile=p,
             launches=counts, card=card)
    rec["onnx_finetune"] = r
    lr = c["lr"]
    print(f"ONNX BERT-base FLOAT fine-tune step, {c['batch']} x {c['seq']},"
          f" card vs CPU: loss {first['cuda']:.7g} vs {first['cpu']:.7g} "
          f"(|d| {e_l:.3g}, rtol {TF_BERT_LOSS_RTOL}); variables |d|max "
          f"{e_p:.3g} (bound 2 lr + 1e-6 = {2 * lr + 1e-6:.3g}), "
          f"{share:.6f} of them within {TF_BERT_PARAM_ATOL} (at least "
          f"{TF_BERT_PARAM_SHARE}); CPU step {rec['onnx_step_s']['cpu']:.1f}"
          f" s; {card}")
    print(f"ONNX BERT-base fine-tune, Adam({lr}), {c['steps']} steps on one"
          f" batch: loss {l0:.4f} -> {l1:.4f}; {ms:.2f} ms a step, "
          f"{r['tokens_per_s']:.0f} tokens/s over {c['steps'] - 1} steps, "
          f"peak {peak:.2f} GB ({held:.2f} GB of it held before the "
          f"steps); {card}")
    if p["device_busy_ms"] is None:
        print(f"profile onnx_finetune step: no device time in the trace "
              f"(not measured); {card}")
    else:
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / ms
        print(f"profile onnx_finetune step: wall {p['wall_ms']:.2f} ms, "
              f"device busy {p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f} ({r['idle_share_unprofiled']:.3f} of "
              f"an unprofiled step), {p['device_ops']} device kernels and "
              f"copies; {card}")
        for kname, kms in p["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "onnx_finetune", counts)
    _require(e_l <= TF_BERT_LOSS_RTOL * abs(first["cpu"])
             and share >= TF_BERT_PARAM_SHARE and e_p <= 2 * lr + 1e-6,
             f"the card's fine-tune step disagrees with the CPU's: "
             f"loss {e_l}, variables {e_p}, share {share}")
    _require(all(math.isfinite(v) for v in curve) and l1 < l0,
             f"the fine-tune loss did not fall: {l0} -> {l1}, {curve}")


# ---------------------------------------------------------------------------
# the serving tier (phases 33-37)
# ---------------------------------------------------------------------------

def _serve_dev(torch, c):
    return torch.device(c["device"])


def _serve_sync(torch, c):
    if _serve_dev(torch, c).type == "cuda":
        torch.cuda.synchronize()


def _serve_models(torch, c):
    """GPT-2 small (seeded random weights) and its draft: DistilGPT2's
    widths, its embeddings and layers copied from the target's layers
    ``draft_layers``, the way the DistilGPT2 student was initialised from
    GPT-2."""
    from deeplearning4j_tpu_torch.nlp.transformer import (
        TransformerLM, TransformerLMConfig)
    lm = TransformerLM(TransformerLMConfig(**c["lm"]), device=c["device"])
    draft = TransformerLM(TransformerLMConfig(
        **dict(c["lm"], nLayers=len(c["draft_layers"]))),
        device=c["device"])
    with torch.no_grad():
        for name in ("emb", "pos", "lnf_g", "lnf_b"):
            getattr(draft, name).copy_(getattr(lm, name))
        for dst, li in zip(draft.layers, c["draft_layers"]):
            for name, p in lm.layers[li].named_parameters():
                getattr(dst, name).copy_(p)
    return lm, draft


def _batcher(lm, draft, name, c):
    from deeplearning4j_tpu_torch.remote import (AdmissionControl,
                                                 ContinuousBatcher)
    return ContinuousBatcher(lm, name=name, draft=draft, draftK=c["draftK"],
                             pageSize=c["pageSize"], maxSlots=c["maxSlots"],
                             admission=AdmissionControl(maxQueueRows=1024))


def _http(port, route, payload, stream=False, timeout=600):
    """One POST to the serving tier: (status, body or [tokens], headers,
    seconds to each streamed token).  A streamed reply is read line by
    line as it arrives (NDJSON, keep-alive lines skipped); an error line
    fails the phase."""
    import urllib.error
    import urllib.request
    body = dict(payload, stream=True) if stream else payload
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            headers = dict(resp.headers)
            if not stream:
                return resp.status, json.loads(resp.read()), headers, []
            toks, times, done = [], [], False
            for line in resp:
                if not line.startswith(b"{"):
                    continue
                obj = json.loads(line)
                if "token" in obj:
                    toks.append(obj["token"])
                    times.append(time.perf_counter() - t0)
                elif "error" in obj:
                    raise PhaseFailed(f"stream error: {obj['error']}")
                done = done or obj.get("done", False)
            _require(done, "a stream ended without its done line")
            return resp.status, toks, headers, times
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers), []


def _get(port, path, timeout=60):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return resp.status, resp.read()


def _exposed(text, name, **labels):
    """A sample's value in Prometheus text (labels in declared order), or
    None when the series is absent."""
    key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels.items())
                  + "}" if labels else "")
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def _parallel(fn, items):
    """fn(item) on one client thread per item; results in order (an
    exception is re-raised once every thread is joined)."""
    import threading
    out, errs = [None] * len(items), []

    def run(i):
        try:
            out[i] = fn(items[i])
        except BaseException as e:       # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(900)
    _require(not any(th.is_alive() for th in threads),
             "a client thread did not finish")
    if errs:
        raise errs[0]
    return out


def _serve_requests_spec(c, seed, n, lo, hi):
    """n seeded (prompt, maxNewTokens) pairs: prompts of lo..hi tokens,
    maxNewTokens over c["new"]."""
    import numpy as np
    rng = np.random.RandomState(seed)
    vocab = c["lm"]["vocabSize"]
    return [(rng.randint(0, vocab, int(rng.randint(lo, hi + 1))
                         ).astype(np.int32),
             int(rng.randint(c["new"][0], c["new"][1] + 1)))
            for _ in range(n)]


def _near_tie_check(torch, lm, pairs, answers, eps=SERVE_NEAR_TIE,
                    refs=None):
    """Each answer against ``generate`` of its prompt alone: tokens equal
    up to the first position whose top-two logits (of ``generate``'s own
    run, recomputed by one forward) lie within ``eps``.  ``refs`` (a dict)
    keeps each prompt's reference and cut for a later check of the same
    prompts.  Returns (tokens compared, tokens in all)."""
    import numpy as np
    refs = {} if refs is None else refs
    compared = total = 0
    for (prompt, n), got in zip(pairs, answers):
        key = (prompt.tobytes(), n)
        if key not in refs:
            ref = lm.generate(prompt[None], n)[0]
            seq = np.concatenate([prompt, ref[:-1]])[None]
            top2 = torch.topk(lm.forward(seq)[0, len(prompt) - 1:], 2,
                              dim=-1).values
            close = torch.nonzero(top2[:, 0] - top2[:, 1] < eps)
            refs[key] = (ref, int(close[0]) if len(close) else n)
        ref, cut = refs[key]
        got = np.asarray(got).ravel()
        _require(got.shape == ref.shape,
                 f"an answer of {got.shape[0]} tokens, expected {n}")
        _require(bool((got[:cut] == ref[:cut]).all()),
                 f"tokens part from generate before the first near tie "
                 f"({cut}): {got[:cut].tolist()} vs {ref[:cut].tolist()}")
        compared += cut
        total += n
    return compared, total


def phase_serve_start(torch, rec, card, c=SERVE):
    """Start an InferenceServer with the three routes; warm each.
    Returns the serving state for the later phases."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.remote import (BucketLadder,
                                                 ForwardServing,
                                                 GenerativeServing,
                                                 InferenceServer,
                                                 ModelRegistry)
    from deeplearning4j_tpu_torch.telemetry import get_registry
    dev = _serve_dev(torch, c)
    _serve_sync(torch, c)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda" \
        else 0.0
    _reset_counters()
    t0 = time.perf_counter()
    lm, draft = _serve_models(torch, c)
    net = MultiLayerNetwork(_lenet_conf(), device=c["device"]).init()
    init_s = time.perf_counter() - t0
    reg = ModelRegistry()
    cb = reg.register("lm", _batcher(lm, draft, "lm", c))
    reg.register("lm_group", GenerativeServing(lm, BucketLadder(
        batchSizes=c["group_batch"], seqLens=c["group_seq"])))
    reg.register("classifier", ForwardServing(
        net, BucketLadder(batchSizes=c["cls_batch"], seqLens=()),
        inputShape=(784,)))
    t0 = time.perf_counter()
    server = InferenceServer(reg, port=0).start()
    start_s = time.perf_counter() - t0
    _serve_sync(torch, c)
    hist = get_registry().get("dl4j_tpu_serving_warmup_seconds")
    warm = {r: hist.sum(model=r) for r in ("lm", "lm_group", "classifier")}
    pool_bytes = cb.pool.k.nbytes + cb.pool.v.nbytes
    draft_bytes = cb.draftPool.k.nbytes + cb.draftPool.v.nbytes
    lc = c["lm"]
    pages = 1 + c["maxSlots"] * -(-(lc["maxLen"] + c["draftK"])
                                  // c["pageSize"])
    want = 2 * lc["nLayers"] * pages * lc["nHeads"] * c["pageSize"] * \
        lc["headSize"] * 4
    peak = torch.cuda.max_memory_allocated() / 1e9 - base \
        if dev.type == "cuda" else None
    counts = _counters()
    r = rec["serve_start"] = dict(
        port=server.port, init_s=init_s, start_s=start_s, warmup_s=warm,
        pages=cb.pool.numPages, pool_bytes=pool_bytes,
        draft_pool_bytes=draft_bytes, expected_pool_bytes=want,
        ladder=list(cb.ladder.seqLens), peak_gb=peak, launches=counts,
        card=card)
    print(f"serve_start: InferenceServer on 127.0.0.1:{server.port}, "
          f"routes {reg.names()}; models built in {init_s:.2f} s, started "
          f"(warmed) in {start_s:.2f} s; warm-up s per route "
          f"{ {k: round(v, 3) for k, v in warm.items()} }; lm ladder "
          f"{r['ladder']}, {cb.pool.numPages} pages of {c['pageSize']}; "
          f"pool {pool_bytes} B target + {draft_bytes} B draft; peak "
          f"{peak if peak is None else round(peak, 3)} GB; {card}")
    _no_launches(rec, "serve_start", counts)
    _require(pool_bytes == want and draft_bytes * lc["nLayers"] ==
             want * len(c["draft_layers"]),
             f"pool bytes {pool_bytes} / {draft_bytes}, expected {want}")
    _require(cb.pool.k.device.type == dev.type,
             f"the pool lives on {cb.pool.k.device}")
    return dict(server=server, reg=reg, lm=lm, draft=draft, net=net, cb=cb)


def phase_serve_requests(torch, rec, st, card, c=SERVE):
    """16 lm clients (half streaming), 8 lm_group and 8 classifier
    requests at once; every answer 200; /metrics, the timeline and
    /healthz.  Returns the requests and answers."""
    import numpy as np
    port = st["server"].port
    _reset_counters()
    lm_pairs = _serve_requests_spec(c, c["seed"], c["clients"],
                                    *c["prompt"])
    grp_pairs = _serve_requests_spec(c, c["seed"] + 1,
                                     c["group_requests"], *c["prompt"])
    rng = np.random.RandomState(c["seed"] + 2)
    cls_x = [rng.rand(int(rng.randint(c["cls_rows"][0],
                                      c["cls_rows"][1] + 1)), 784
                      ).astype(np.float32) for _ in range(c["cls_requests"])]
    jobs = [("lm", i) for i in range(len(lm_pairs))] + \
        [("lm_group", i) for i in range(len(grp_pairs))] + \
        [("classifier", i) for i in range(len(cls_x))]

    def send(job):
        route, i = job
        if route == "classifier":
            return _http(port, "/v1/serving/classifier",
                         {"features": cls_x[i].tolist()})
        prompt, n = (lm_pairs if route == "lm" else grp_pairs)[i]
        return _http(port, f"/v1/serving/{route}",
                     {"tokens": prompt.tolist(), "maxNewTokens": n},
                     stream=route == "lm" and i % 2 == 0)

    _serve_sync(torch, c)
    t0 = time.perf_counter()
    res = _parallel(send, jobs)
    wall = time.perf_counter() - t0
    statuses = [r[0] for r in res]
    answers = {"lm": [], "lm_group": [], "classifier": []}
    for (route, i), (status, body, headers, _) in zip(jobs, res):
        if route == "classifier":
            answers[route].append(np.asarray(body.get("output")))
        elif route == "lm" and i % 2 == 0:
            answers[route].append(body)
        else:
            answers[route].append(body.get("tokens", [[]])[0])
    text = _get(port, "/metrics")[1].decode()
    admitted = _exposed(text, "dl4j_tpu_serving_sequences_admitted_total",
                        model="lm")
    retired = _exposed(text, "dl4j_tpu_serving_sequences_retired_total",
                       model="lm")
    decoded = _exposed(text, "dl4j_tpu_serving_decode_tokens_total",
                       model="lm")
    sheds = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                if ln.startswith("dl4j_tpu_serving_shed_total{"))
    tid = res[0][2].get("X-Trace-Id")
    tl = json.loads(_get(port, f"/v1/requests/{tid}")[1])
    events = sorted({e["event"] for e in tl["events"]})
    health = _get(port, "/healthz")
    counts = _counters()
    r = rec["serve_requests"] = dict(
        requests=len(jobs), statuses=statuses, wall_s=wall,
        lm_admitted=admitted, lm_retired=retired, lm_decode_tokens=decoded,
        shed=sheds, trace_events=events, healthz=health[0],
        launches=counts, card=card)
    print(f"serve_requests: {len(jobs)} requests ({c['clients']} lm, half "
          f"streamed; {len(grp_pairs)} lm_group; {len(cls_x)} classifier) in "
          f"{wall:.2f} s, statuses {sorted(set(statuses))}; lm admitted "
          f"{admitted}, retired {retired}, decode tokens {decoded}, sheds "
          f"{sheds}; timeline of {tid}: {events}; /healthz {health[0]}; "
          f"{card}")
    _no_launches(rec, "serve_requests", counts)
    _require(all(s == 200 for s in statuses),
             f"requests answered {statuses}")
    _require(admitted == retired == len(lm_pairs),
             f"lm admitted {admitted}, retired {retired}")
    _require(decoded and decoded > 0 and sheds == 0,
             f"decode tokens {decoded}, sheds {sheds}")
    _require({"serving.enqueue", "serving.admit", "serving.first_token",
              "serving.retire"} <= set(events),
             f"the timeline lacks events: {events}")
    _require(health[0] == 200, f"/healthz answered {health[0]}")
    return dict(lm_pairs=lm_pairs, grp_pairs=grp_pairs, cls_x=cls_x,
                answers=answers)


def _sd_graph(torch, c):
    """A small SameDiff classifier on the card: softmax(x W + b)."""
    import numpy as np
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    sd = SameDiff.create(device=c["device"])
    rng = np.random.RandomState(3)
    x = sd.placeholder("x", shape=(-1, 16))
    w = sd.var("w", rng.randn(16, 4).astype(np.float32))
    b = sd.var("b", rng.randn(4).astype(np.float32))
    sd.nn().softmax(x.mmul(w) + b, name="probs")
    return sd


def phase_serve_check(torch, rec, st, req, card, c=SERVE):
    """Hold every answer of serve_requests against its model alone, and
    one JsonModelServer and one SameDiffJsonModelServer round trip; serve
    some of the lm prompts through a speculative route whose draft is the
    target itself, hold them to generate and require accepted proposals."""
    import numpy as np
    from deeplearning4j_tpu_torch.remote import (InferenceServer,
                                                 JsonModelServer,
                                                 JsonRemoteInference,
                                                 ModelRegistry,
                                                 SameDiffJsonModelServer)
    from deeplearning4j_tpu_torch.telemetry import serving_metrics
    lm, net = st["lm"], st["net"]
    _reset_counters()
    t0 = time.perf_counter()
    refs = {}
    cmp_lm = _near_tie_check(torch, lm, req["lm_pairs"],
                             req["answers"]["lm"], refs=refs)
    cmp_grp = _near_tie_check(torch, lm, req["grp_pairs"],
                              req["answers"]["lm_group"])
    cls_err = max(float(np.abs(a - net.output(x).numpy()).max())
                  for a, x in zip(req["answers"]["classifier"],
                                  req["cls_x"]))
    x = req["cls_x"][0][:4]
    srv = JsonModelServer(net).start()
    try:
        pred = JsonRemoteInference(port=srv.port).predict(x)
    finally:
        srv.stop()
    json_err = float(np.abs(pred - net.output(x).numpy()).max())
    sd = _sd_graph(torch, c)
    xs = np.random.RandomState(4).randn(5, 16).astype(np.float32)
    srv = SameDiffJsonModelServer(sd, outputNames=["probs"]).start()
    try:
        sd_pred = JsonRemoteInference(port=srv.port).predict(xs)
    finally:
        srv.stop()
    sd_err = float(np.abs(sd_pred - sd.output({"x": xs}, "probs")[
        "probs"].cpu().numpy()).max())
    # the accept branch: with random weights the "lm" route's draft never
    # agrees with its target, so a route whose draft is the target itself
    # takes several tokens a step
    sm = serving_metrics()
    reg = ModelRegistry()
    reg.register("lm_self", _batcher(lm, lm, "lm_self", c))
    self_pairs = req["lm_pairs"][:c["self_draft_requests"]]
    server = InferenceServer(reg, port=0).start()
    try:
        res = _parallel(lambda i: _http(
            server.port, "/v1/serving/lm_self",
            {"tokens": self_pairs[i][0].tolist(),
             "maxNewTokens": self_pairs[i][1]}, stream=i % 2 == 0),
            list(range(len(self_pairs))))
    finally:
        server.stop()
    _require(all(x[0] == 200 for x in res),
             f"lm_self: statuses {[x[0] for x in res]}")
    cmp_self = _near_tie_check(
        torch, lm, self_pairs,
        [x[1] if i % 2 == 0 else x[1]["tokens"][0]
         for i, x in enumerate(res)], refs=refs)
    proposed = sm.draft_proposed().value(model="lm_self")
    accepted = sm.draft_accepted().value(model="lm_self")
    counts = _counters()
    r = rec["serve_check"] = dict(
        lm_tokens_compared=cmp_lm, group_tokens_compared=cmp_grp,
        self_draft_tokens_compared=cmp_self,
        self_draft_accept_rate=accepted / proposed if proposed else None,
        classifier_max_abs_err=cls_err, json_server_max_abs_err=json_err,
        samediff_server_max_abs_err=sd_err,
        check_s=time.perf_counter() - t0, launches=counts, card=card)
    print(f"serve_check: lm (speculative) tokens equal to generate's "
          f"(target-only greedy) on {cmp_lm[0]} of {cmp_lm[1]} before the "
          f"first near tie, lm_group on {cmp_grp[0]} of {cmp_grp[1]}, "
          f"lm_self (the target as its own draft) on {cmp_self[0]} of "
          f"{cmp_self[1]} with {accepted:g} of {proposed:g} proposals "
          f"accepted; classifier max |d| {cls_err:.3g} (atol "
          f"{SERVE_OUT_ATOL}); JsonModelServer {json_err:.3g}, "
          f"SameDiffJsonModelServer {sd_err:.3g}; {r['check_s']:.2f} s; "
          f"{card}")
    _no_launches(rec, "serve_check", counts)
    _require(min(cmp[0] - 0.5 * cmp[1] for cmp in (cmp_lm, cmp_grp,
                                                    cmp_self)) >= 0,
             "the near-tie rule left fewer than half the tokens compared")
    _require(accepted > 0, f"lm_self accepted {accepted:g} of "
             f"{proposed:g} proposals: the accept branch did not run")
    _require(max(cls_err, json_err, sd_err) <= SERVE_OUT_ATOL,
             f"served outputs disagree: {cls_err}, {json_err}, {sd_err}")


def phase_serve_replicas(torch, rec, st, card, c=SERVE):
    """A ReplicaSet of two batchers behind "lm": crash lm/0 under 8
    streams, every stream finishes on lm/1 exactly once; then the
    autoscale edges."""
    import numpy as np
    from deeplearning4j_tpu_torch.fault import injection as inj
    from deeplearning4j_tpu_torch.remote import (InferenceServer,
                                                 ModelRegistry, ReplicaSet)
    from deeplearning4j_tpu_torch.telemetry import (HealthMonitor,
                                                    get_registry,
                                                    serving_metrics)
    lm, draft = st["lm"], st["draft"]
    st["server"].stop()                # the single batcher leaves "lm"
    _reset_counters()
    sm = serving_metrics()
    before = sm.failovers().value(model="lm")
    rs = ReplicaSet(lambda idx: _batcher(lm, draft, f"lm/{idx}", c),
                    name="lm", replicas=2, maxReplicas=3,
                    probeInterval=0.05, probeTimeout=5.0,
                    probeFailThreshold=1, seed=0)
    reg = ModelRegistry()
    reg.register("lm", rs)
    t0 = time.perf_counter()
    server = InferenceServer(reg, port=0).start()
    up_s = time.perf_counter() - t0
    pairs = _serve_requests_spec(c, c["seed"] + 3, c["replica_streams"],
                                 *c["prompt"])
    import threading
    first = threading.Barrier(len(pairs) + 1, timeout=120)
    try:
        for name in ("lm/0", "lm/1"):
            inj.set_replica_slowdown(name, c["replica_slowdown"])

        def stream(pair):
            import urllib.request
            prompt, n = pair
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/serving/lm",
                data=json.dumps({"tokens": prompt.tolist(),
                                 "maxNewTokens": n,
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            toks, waited = [], False
            with urllib.request.urlopen(req, timeout=600) as resp:
                tid = resp.headers.get("X-Trace-Id")
                for line in resp:
                    if not line.startswith(b"{"):
                        continue
                    obj = json.loads(line)
                    _require("error" not in obj, f"stream error {obj}")
                    if "token" in obj:
                        toks.append(obj["token"])
                        if not waited:
                            waited = True
                            first.wait()     # every stream is in flight
            return toks, tid

        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(len(pairs)) as pool:
            futs = [pool.submit(stream, p) for p in pairs]
            first.wait()
            with rs._lock:
                busy = {ex.name: ex.busy() for ex in rs._replicas}
            inj.arm_replica_crash("lm/0")
            inj.set_replica_slowdown("lm/1", 0)
            got = [f.result(timeout=300) for f in futs]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and rs.replicaCount() != 1:
            time.sleep(0.05)
        with rs._lock:
            survivors = [ex.name for ex in rs._replicas]
        failovers = sm.failovers().value(model="lm") - before
        health0 = sm.replica_health().value(model="lm", replica="lm/0")
        hops = json.loads(_get(server.port,
                               f"/v1/requests/{got[0][1]}")[1])["events"]
        cmp = _near_tie_check(torch, lm, pairs, [g[0] for g in got])
        # the autoscale edges: a backlog fires the queue-depth rule (one
        # replica up), its draining resolves it (one down)
        mon = HealthMonitor(rules=[])
        rs.armAutoscale(mon, highQueueRows=c["autoscale_rows"])
        inj.set_replica_slowdown("lm/1", c["replica_slowdown"])
        backlog = [(p, c["backlog_new"]) for p, _ in _serve_requests_spec(
            c, c["seed"] + 4, 2 * c["maxSlots"], 16, 64)]
        with concurrent.futures.ThreadPoolExecutor(len(backlog)) as pool:
            futs = [pool.submit(_http, server.port, "/v1/serving/lm",
                                {"tokens": p.tolist(), "maxNewTokens": n})
                    for p, n in backlog]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and \
                    rs.queuedRows() < c["autoscale_rows"]:
                time.sleep(0.01)
            queued = rs.queuedRows()
            t0 = time.perf_counter()
            mon.evaluate_once(now=100.0)
            scale_up_s = time.perf_counter() - t0
            up = rs.replicaCount()
            inj.set_replica_slowdown("lm/1", 0)
            backlog_status = [f.result(timeout=300)[0] for f in futs]
        mon.evaluate_once(now=200.0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and rs.replicaCount() != 1:
            time.sleep(0.05)
        down = rs.replicaCount()
        acted = get_registry().get("dl4j_tpu_health_actions_total")
        actions = dict((tuple(k), v) for k, v in acted.data()["cells"])
    finally:
        inj.clear_serving_faults()
        server.stop()
    counts = _counters()
    r = rec["serve_replicas"] = dict(
        start_s=up_s, busy_at_crash=busy, survivors=survivors,
        failovers=failovers, replica_health_lm0=health0,
        stream_tokens=[len(g[0]) for g in got], tokens_compared=cmp,
        first_stream_events=[e["event"] for e in hops],
        backlog_queued=queued, replicas_after_up=up,
        scale_up_s=scale_up_s, replicas_after_down=down,
        backlog_statuses=backlog_status,
        actions={"/".join(k): v for k, v in actions.items()},
        launches=counts, card=card)
    print(f"serve_replicas: 2 replicas up in {up_s:.2f} s; busy when lm/0 "
          f"was armed to crash {busy}; survivors {survivors}; "
          f"{failovers:g} sequences failed over; lm/0 health {health0:g}; "
          f"{len(got)} streams of {r['stream_tokens']} tokens equal to "
          f"generate on {cmp[0]} of {cmp[1]} before the first near tie; "
          f"autoscale: {queued} rows queued -> {up} replicas (warmed in "
          f"{scale_up_s:.2f} s) -> {down} after the backlog drained; "
          f"actions {r['actions']}; {card}")
    _no_launches(rec, "serve_replicas", counts)
    _require(busy.get("lm/0"), f"lm/0 held no stream when armed: {busy}")
    _require(survivors == ["lm/1"], f"survivors {survivors}")
    _require(failovers >= 1 and health0 == 0,
             f"failovers {failovers}, lm/0 health {health0}")
    _require([len(g[0]) for g in got] == [n for _, n in pairs],
             "a stream delivered a token twice or dropped one")
    _require(cmp[0] >= 0.5 * cmp[1], "too few tokens compared")
    _require(up == 2 and down == 1 and all(s == 200 for s in backlog_status),
             f"autoscale {up} -> {down}, statuses {backlog_status}")
    _require(actions.get(("serving_queue_depth_high", "ok"), 0) >= 2,
             f"health actions {actions}")


def _profile_steps(torch, cb, n, top):
    """Arm a profile of ``n`` consecutive decode steps of the batcher
    ``cb``, taken on its own stepping thread at the first step that finds
    every slot busy.  The profiler starts and stops on the thread that
    runs the device work while no other thread runs a torch op: stopping
    it from another thread while the stepping thread is inside torch ops
    faults the process (SIGSEGV in the profiler's stop, seen on the H100
    with torch 2.11).  Returns a dict that gets ``prof`` (as
    ``_device_breakdown``'s) and ``steps`` (decode steps counted in the
    window); its ``done`` event is set when the window closed."""
    import threading
    from deeplearning4j_tpu_torch.telemetry import serving_metrics
    sm, orig = serving_metrics(), cb._stepOnce
    out = {"done": threading.Event()}

    def stepOnce():
        if cb._slotSeq.count(None) > 0:
            return orig()
        del cb._stepOnce                 # one window: back to the class's
        try:
            steps0 = sm.decode_steps().value(model=cb.name)
            out["prof"] = _device_breakdown(
                torch, lambda: [orig() for _ in range(n)], top=top)
            out["steps"] = sm.decode_steps().value(model=cb.name) - steps0
        finally:
            out["done"].set()

    cb._stepOnce = stepOnce
    return out


def phase_serve_timing(torch, rec, st, card, c=SERVE):
    """8 slots, 16 streaming clients: TTFT, inter-token latency, decode
    tokens/s and goodput, slot occupancy, pages in use, the draft's
    acceptance rate, speculative (the DistilGPT2-width draft, and the
    target as its own draft) against target-only tokens/s; then profiled
    decode steps (``_profile_steps``)."""
    import threading

    import numpy as np
    from deeplearning4j_tpu_torch.remote import InferenceServer, ModelRegistry
    from deeplearning4j_tpu_torch.telemetry import serving_metrics
    lm, draft = st["lm"], st["draft"]
    sm = serving_metrics()
    _reset_counters()
    reg = ModelRegistry()
    spec = reg.register("spec", _batcher(lm, draft, "spec", c))
    greedy = reg.register("greedy", _batcher(lm, None, "greedy", c))
    spec_self = reg.register("spec_self", _batcher(lm, lm, "spec_self", c))
    server = InferenceServer(reg, port=0).start()
    pairs = _serve_requests_spec(c, c["seed"] + 5, c["timing_clients"],
                                 *c["prompt"])
    out = {}
    try:
        for route, cb in (("spec", spec), ("greedy", greedy),
                          ("spec_self", spec_self)):
            pages, stop = [], threading.Event()

            def sample(cb=cb, pages=pages, stop=stop):
                while not stop.wait(0.005):
                    pages.append(cb.pool.usedPages())

            sampler = threading.Thread(target=sample)
            steps0 = sm.decode_steps().value(model=route)
            prop0 = sm.draft_proposed().value(model=route)
            acc0 = sm.draft_accepted().value(model=route)
            tok0 = sm.decode_tokens().value(model=route)
            busy0, n0 = cb._busySteps, cb._steps
            sampler.start()
            try:
                t0 = time.perf_counter()
                res = _parallel(lambda p: _http(
                    server.port, f"/v1/serving/{route}",
                    {"tokens": p[0].tolist(), "maxNewTokens": p[1]},
                    stream=True), pairs)
                wall = time.perf_counter() - t0
            finally:
                stop.set()
                sampler.join(30)
            _require(all(x[0] == 200 for x in res),
                     f"{route}: statuses {[x[0] for x in res]}")
            times = [x[3] for x in res]
            ttft = [t[0] for t in times]
            itl = [b - a for t in times for a, b in zip(t, t[1:])]
            delivered = sum(len(x[1]) for x in res)
            steps = sm.decode_steps().value(model=route) - steps0
            proposed = sm.draft_proposed().value(model=route) - prop0
            accepted = sm.draft_accepted().value(model=route) - acc0
            out[route] = dict(
                wall_s=wall, requests=len(pairs), tokens=delivered,
                ttft_p50_s=float(np.percentile(ttft, 50)),
                ttft_p99_s=float(np.percentile(ttft, 99)),
                itl_p50_s=float(np.percentile(itl, 50)),
                itl_p99_s=float(np.percentile(itl, 99)),
                itl_mean_s=float(np.mean(itl)),
                decode_tokens_per_s=(sm.decode_tokens().value(model=route)
                                     - tok0) / wall,
                goodput_tokens_per_s=delivered / wall,
                decode_steps=steps, ms_per_step=wall * 1e3 / max(steps, 1),
                slot_occupancy=(cb._busySteps - busy0) / max(
                    cb._steps - n0, 1),
                pages_in_use_max=max(pages) if pages else None,
                pages_in_use_mean=float(np.mean(pages)) if pages else None,
                pages=cb.pool.numPages - 1,
                accept_rate=accepted / proposed if proposed else None)
            _require(out[route]["tokens"] == sum(n for _, n in pairs),
                     f"{route}: {delivered} tokens delivered")
        # profiled decode steps: every slot of the speculative route busy
        # (admitted, past its prefill), no request arriving
        import concurrent.futures
        window = _profile_steps(torch, spec, c["profile_steps"], top=6)
        with concurrent.futures.ThreadPoolExecutor(c["maxSlots"]) as pool:
            futs = [pool.submit(_http, server.port, "/v1/serving/spec",
                                {"tokens": p.tolist(),
                                 "maxNewTokens": c["new"][1]})
                    for p, _ in pairs[:c["maxSlots"]]]
            _require(all(f.result(timeout=300)[0] == 200 for f in futs),
                     "a profiled request failed")
        _require(window["done"].wait(60) and "prof" in window,
                 "the profiled steps did not run")
        prof, psteps = window["prof"], window["steps"]
    finally:
        server.stop()
    counts = _counters()
    s, g, ss = out["spec"], out["greedy"], out["spec_self"]
    r = rec["serve_timing"] = dict(spec=s, greedy=g, spec_self=ss,
                                   profile=prof, profiled_steps=psteps,
                                   speedup=s["goodput_tokens_per_s"] /
                                   g["goodput_tokens_per_s"],
                                   self_speedup=ss["goodput_tokens_per_s"] /
                                   g["goodput_tokens_per_s"],
                                   launches=counts, card=card)
    for route, t in out.items():
        print(f"serve_timing {route} ({c['maxSlots']} slots, "
              f"{len(pairs)} streaming clients): TTFT p50 "
              f"{t['ttft_p50_s'] * 1e3:.1f} ms, p99 "
              f"{t['ttft_p99_s'] * 1e3:.1f} ms; inter-token p50 "
              f"{t['itl_p50_s'] * 1e3:.2f} ms, p99 "
              f"{t['itl_p99_s'] * 1e3:.2f} ms, mean "
              f"{t['itl_mean_s'] * 1e3:.2f} ms; decode "
              f"{t['decode_tokens_per_s']:.1f} tokens/s, goodput "
              f"{t['goodput_tokens_per_s']:.1f} tokens/s; "
              f"{t['decode_steps']:g} steps, {t['ms_per_step']:.2f} ms "
              f"each; slot occupancy {t['slot_occupancy']:.3f}; pages in "
              f"use max {t['pages_in_use_max']} mean "
              f"{t['pages_in_use_mean']} of {t['pages']}; accept rate "
              f"{t['accept_rate']}; {card}")
    print(f"serve_timing: speculative / target-only goodput "
          f"{r['speedup']:.3f}, self-drafted / target-only "
          f"{r['self_speedup']:.3f}; {card}")
    if prof["device_busy_ms"] is None:
        print(f"profile serve_decode: no device time in the trace (not "
              f"measured); {card}")
    else:
        r["device_ms_per_step"] = prof["device_busy_ms"] / max(psteps, 1)
        r["device_ops_per_step"] = prof["device_ops"] / max(psteps, 1)
        # the profiler slows the stepping thread's dispatch: the idle
        # share of an unprofiled step is against the timed route's step
        r["idle_share_unprofiled"] = 1 - r["device_ms_per_step"] / \
            s["ms_per_step"]
        print(f"profile serve_decode: {psteps:g} speculative steps in "
              f"{prof['wall_ms']:.1f} ms wall, device busy "
              f"{prof['device_busy_ms']:.2f} ms (idle share "
              f"{prof['idle_share']:.3f}, "
              f"{r['idle_share_unprofiled']:.3f} of an unprofiled step); "
              f"{r['device_ms_per_step']:.3f} ms and "
              f"{r['device_ops_per_step']:.0f} device ops a step; {card}")
        for kname, kms in prof["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "serve_timing", counts)


def _yolo2_batch(rng, b, nC, grid=13, boxes=YOLO2_RUN["boxes"]):
    """Seeded synthetic images (b, 3, 416, 416) and labels in the layer's
    DL4J format (b, 4 + nC, grid, grid): 1-4 boxes an image, [x1, y1, x2,
    y2] in grid units and a one-hot class in the cell of the box's centre,
    zero elsewhere."""
    import numpy as np
    x = rng.randn(b, 3, grid * 32, grid * 32).astype(np.float32)
    y = np.zeros((b, 4 + nC, grid, grid), np.float32)
    for e in range(b):
        for _ in range(rng.randint(boxes[0], boxes[1] + 1)):
            i, j = rng.randint(0, grid, 2)
            cx, cy = j + rng.rand(), i + rng.rand()
            w, h = 0.5 + 3.5 * rng.rand(), 0.5 + 3.5 * rng.rand()
            y[e, :, i, j] = 0.0
            y[e, 0:4, i, j] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
            y[e, 4 + rng.randint(0, nC), i, j] = 1.0
    return x, y


def _yolo2_model(torch):
    """``YOLO2().init()`` on the card (the entry point's default device), a
    copy of its initial parameters, and the seeded batches."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import YOLO2
    c = YOLO2_RUN
    t0 = time.perf_counter()
    net = YOLO2().init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _require(net.device.type == "cuda", f"YOLO2 runs on {net.device}")
    _require(net.numParams() == YOLO2_PARAMS,
             f"YOLO2 has {net.numParams()} parameters, not {YOLO2_PARAMS}")
    params0 = {v: {k: t.clone() for k, t in lp.items()}
               for v, lp in net.params_.items()}
    rng = np.random.RandomState(c["seed"])
    pool = [DataSet(*_yolo2_batch(rng, c["batch"], 80))
            for _ in range(c["batches"])]
    print(f"YOLO2: {net.numParams()} params, init {init_s:.1f} s, batches "
          f"of {c['batch']}x3x416x416, labels {tuple(pool[0].labels.shape)}"
          f", FLOAT")
    return net, params0, pool


def _conv_flops(conf, batch):
    """Multiply-add FLOPs (2 a MAC) of a graph's convolutions for one
    forward of ``batch`` images, from their shapes."""
    total = 0
    for name in conf.topoOrder:
        node = conf.nodes[name][0]
        if type(node).__name__ == "ConvolutionLayer":
            it = conf.vertexInputTypes[name]
            ot = conf.vertexOutputTypes[name]
            kh, kw = node.kernelSize
            total += 2 * it.channels * kh * kw * ot.channels * ot.height \
                * ot.width
    return total * batch


def phase_yolo2_train(torch, rec, net, params0, pool, card):
    """``fit(ListDataSetIterator, epochs=1)`` over the 4 batches with the
    zoo's configuration: 4 iterations, finite scores.  Then a copy of the
    initial net at Adam(1e-5) refits one batch 8 times: the score must
    fall.  Returns that net."""
    import math
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.optimize import \
        CollectScoresIterationListener
    c = YOLO2_RUN
    col = CollectScoresIterationListener(1)
    net.setListeners(col)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(pool), epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    scores = [s for _i, s in col.getScores()]
    net.setListeners()
    peak = torch.cuda.max_memory_allocated() / 1e9
    tuned = _yolo2_float(params0, "cuda", Adam(c["refit_lr"]))
    refit = []
    for _ in range(c["refit"]):
        tuned.fit(pool[0])
        refit.append(tuned.score())
    counts = _counters()
    rec["yolo2_train"] = dict(fit_s=fit_s, scores=scores, refit=refit,
                              iterations=net.iterationCount, peak_gb=peak,
                              held_gb=held)
    print(f"YOLO2 fit 1 epoch x {len(pool)} batches of {c['batch']} (the "
          f"zoo's Adam(1e-3)): {net.iterationCount} iterations in "
          f"{fit_s:.2f} s, scores {[round(v, 4) for v in scores]}, peak "
          f"{peak:.2f} GB ({held:.2f} GB of it held before the fit); refit "
          f"of batch 0 from the initial parameters "
          f"with Adam({c['refit_lr']}): {[round(v, 4) for v in refit]}; "
          f"{card}")
    _require(len(scores) == c["batches"] == net.iterationCount,
             f"{net.iterationCount} iterations, {len(scores)} scores")
    _require(all(math.isfinite(v) for v in scores + refit),
             f"YOLO2 scores not finite: {scores} {refit}")
    _require(refit[-1] < refit[0], f"YOLO2 refit did not fall: {refit}")
    _no_launches(rec, "yolo2_train", counts)
    return tuned


def _yolo2_float(params0, device, updater=None):
    """YOLO2's graph from ``params0`` on ``device``; ``updater`` in place
    of the zoo's global Adam(1e-3) (set on the builder before ``build``
    resolves each layer's)."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import YOLO2
    gb = YOLO2().graphBuilder()
    if updater is not None:
        gb._g["updater"] = updater
    return ComputationGraph(gb.build(), device=device).init(params=params0)


def phase_yolo2_step(torch, rec, params0, pool):
    """One FLOAT step at batch 2 from the same parameters, on the card and
    on the CPU."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    b, lr = YOLO2_RUN["check_batch"], 1e-3      # YOLO2's Adam(1e-3)
    ds = DataSet(pool[1].features[:b], pool[1].labels[:b])
    _reset_counters()
    nets = {}
    for dev in ("cuda", "cpu"):
        net = _yolo2_float(params0, dev)
        net.fit(ds)
        nets[dev] = net
    counts = _counters()
    gpu, cpu = nets["cuda"], nets["cpu"]
    loss_g, loss_c = gpu.score(), cpu.score()
    e_l, ok_l = _max_err(torch.tensor([loss_g]), torch.tensor([loss_c]),
                         **RESNET_STEP_TOL)
    d = (gpu.params().torch.cpu() - cpu.params().torch).abs()
    share = float((d <= 1e-5).float().mean())
    ok_p = float(d.max()) <= 2 * lr + 1e-6 and share >= YOLO2_STEP_SHARE
    e_s, ok_s = 0.0, True
    for v, st in gpu.state_.items():
        for k in ("mean", "var"):
            e, ok = _max_err(st[k].cpu(), cpu.state_[v][k],
                             **RESNET_STEP_TOL)
            e_s, ok_s = max(e_s, e), ok_s and ok
    rec["yolo2_step_card_vs_cpu"] = dict(
        loss_card=loss_g, loss_cpu=loss_c, loss_err=e_l,
        params_err=float(d.max()), share_within_1e5=share, state_err=e_s)
    print(f"YOLO2 FLOAT step, batch {b}, card vs CPU: loss {loss_g:.7g} vs "
          f"{loss_c:.7g} (|d| {e_l:.3g}), BN running stats |d|max {e_s:.3g} "
          f"({RESNET_STEP_TOL}); params |d|max {float(d.max()):.3g} (at "
          f"most 2 lr + 1e-6), {share:.5f} of them within 1e-5 (at least "
          f"{YOLO2_STEP_SHARE})")
    _require(ok_l and ok_p and ok_s,
             f"the card's YOLO2 step disagrees with the CPU's: "
             f"{rec['yolo2_step_card_vs_cpu']}")
    _no_launches(rec, "yolo2_step", counts)


def phase_yolo2_transfer(torch, rec, net, pool, card):
    """dl4j-examples' HouseNumberDetection flow: the trained net saved to
    the local weight repository, restored by ``initPretrained`` bit for
    bit, scored (ROADMAP C16: the reference's restore cannot), then
    fine-tuned with the backbone frozen."""
    import math
    import tempfile
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import (FineTuneConfiguration,
                                                 TransferLearning)
    from deeplearning4j_tpu_torch.nn.conf.convolutional import \
        Yolo2OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import YOLO2
    c = YOLO2_TRANSFER
    _reset_counters()
    old = os.environ.get("DL4J_TPU_DATA_DIR")
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        os.environ["DL4J_TPU_DATA_DIR"] = d
        try:
            os.makedirs(os.path.join(d, "pretrained"))
            path = os.path.join(d, "pretrained", "YOLO2_IMAGENET.zip")
            t0 = time.perf_counter()
            ModelSerializer.writeModel(net, path, saveUpdater=False)
            write_s = time.perf_counter() - t0
            size_mb = os.path.getsize(path) / 1e6
            t0 = time.perf_counter()
            restored = YOLO2().initPretrained()
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("DL4J_TPU_DATA_DIR", None)
            else:
                os.environ["DL4J_TPU_DATA_DIR"] = old
    _require(restored.device.type == "cuda",
             f"initPretrained placed YOLO2 on {restored.device}")
    same = _trees_equal(torch, restored.params_, net.params_) and \
        _trees_equal(torch, restored.state_, net.state_)
    s_net, s_back = net.score(pool[0]), restored.score(pool[0])
    print(f"YOLO2 pretrained zip: {size_mb:.1f} MB written in {write_s:.2f} "
          f"s, initPretrained {read_s:.2f} s onto {restored.device}; params "
          f"and BN state bit-identical {same}; the restored 80-class net "
          f"scores {s_back:.6g} (saved net {s_net:.6g}; the reference's "
          f"restore raises here, ROADMAP C16)")
    _require(same, "initPretrained did not restore YOLO2 bit for bit")
    # inference mode: a NaN here (running statistics a few EMA steps from
    # their start under a diverging loss) must be the saved net's NaN
    _require(s_back == s_net or (math.isnan(s_back) and math.isnan(s_net)),
             f"restored YOLO2 scores {s_back}, saved {s_net}")

    ft = FineTuneConfiguration.builder().updater(Adam(c["lr"])).build()
    nB = len(c["priors"])
    tl = (TransferLearning.GraphBuilder(restored).fineTuneConfiguration(ft)
          .setFeatureExtractor(c["frozen_through"])
          .removeVertexKeepConnections("pred")
          .removeVertexKeepConnections("yolo")
          .addLayer("pred", ConvolutionLayer.builder()
                    .nOut(nB * (5 + c["numClasses"])).kernelSize(1, 1)
                    .build(), c["frozen_through"])
          .addLayer("yolo", Yolo2OutputLayer.builder()
                    .boundingBoxes(np.asarray(c["priors"])).build(), "pred")
          .setOutputs("yolo").build())
    _require(tl.device.type == "cuda", f"the fine-tune net is on {tl.device}")
    frozen = [n for n, (node, _) in tl.conf.nodes.items()
              if getattr(node, "frozen", False)]
    p0 = {n: {k: v.clone() for k, v in tl.params_[n].items()}
          for n in frozen if n in tl.params_}
    s0 = {n: {k: v.clone() for k, v in tl.state_[n].items()}
          for n in frozen if n in tl.state_}
    head0 = tl.params_["pred"]["W"].clone()
    ds = DataSet(*_yolo2_batch(np.random.RandomState(c["seed"]), c["batch"],
                               c["numClasses"]))
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        tl.fit(ds)
        losses.append(tl.score())
    ft_s = time.perf_counter() - t0
    counts = _counters()
    frozen_same = _trees_equal(torch, {n: tl.params_[n] for n in p0}, p0)
    # a frozen layer runs in training mode, as in the reference, so its
    # BatchNormalization moves its running statistics (ROADMAP C17)
    bn_moved = max(float((tl.state_[n][k] - s0[n][k]).abs().max())
                   for n in s0 for k in s0[n])
    head_moved = not torch.equal(tl.params_["pred"]["W"], head0)
    rec["yolo2_transfer"] = dict(
        zip_mb=size_mb, write_s=write_s, init_pretrained_s=read_s,
        restored_score=s_back, frozen_vertices=len(frozen),
        frozen_unchanged=frozen_same, frozen_bn_state_moved=bn_moved,
        head_moved=head_moved, losses=losses,
        ms_per_step=ft_s / c["steps"] * 1e3)
    print(f"fine-tune (Adam {c['lr']}, {len(frozen)} vertices frozen "
          f"through {c['frozen_through']}, {nB} x (5 + {c['numClasses']}) "
          f"head): {c['steps']} steps at batch {c['batch']}, "
          f"{ft_s / c['steps'] * 1e3:.1f} ms a step, loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; frozen params bit-unchanged "
          f"{frozen_same}, frozen BN running statistics moved by up to "
          f"{bn_moved:.3g} (training mode, as the reference: C17), head "
          f"moved {head_moved}; {card}")
    _require(frozen_same and head_moved,
             "fine-tune: frozen params moved, or the head did not")
    _require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             f"fine-tune loss not finite or not falling: {losses}")
    _no_launches(rec, "yolo2_transfer", counts)


def phase_yolo2_timing(torch, rec, net, pool, card):
    """ms a step and images/s at batch 16 (FLOAT), peak memory, the
    convolutions' FLOPs and their share of the FP32 peak, one profiled
    step."""
    c = YOLO2_RUN
    _reset_counters()
    for i in range(c["warm"]):
        net.fit(pool[i % len(pool)])
    net.score()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    for i in range(c["timed"]):
        net.fit(pool[i % len(pool)])
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = wall / c["timed"] * 1e3
    flops = 3 * _conv_flops(net.conf, c["batch"])   # forward + 2 backward
    r = dict(ms_per_step=ms, images_per_s=c["batch"] * c["timed"] / wall,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9, held_gb=held,
             conv_tflop_per_step=flops / 1e12,
             conv_share_of_fp32_peak=flops / (ms / 1e3)
             / PEAK_FP32_CUDA_CORES)
    p = _device_breakdown(torch, lambda: (net.fit(pool[0]), net.score()),
                          top=8)
    r["profile"] = p
    if p["device_busy_ms"] is not None:
        r["idle_share_unprofiled"] = 1 - p["device_busy_ms"] / ms
    rec["yolo2_timing"] = r
    counts = _counters()
    print(f"YOLO2 training (FLOAT, batch {c['batch']}): {ms:.2f} ms/step, "
          f"{r['images_per_s']:.1f} images/s ({c['timed']} steps after "
          f"{c['warm']} warm), peak {r['peak_gb']:.2f} GB ({held:.2f} GB "
          f"of it held before the steps), "
          f"{r['conv_tflop_per_step']:.3f} TFLOP of convolution a step = "
          f"{r['conv_share_of_fp32_peak']:.3f} of the FP32 peak; {card}")
    if p["device_busy_ms"] is None:
        print("profile yolo2_step: no device time in the trace "
              "(not measured)")
    else:
        print(f"profile yolo2_step: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}"
              f" profiled, {r['idle_share_unprofiled']:.3f} unprofiled, "
              f"{p['device_ops']} device kernels and copies")
        for kname, kms in p["top"]:
            print(f"  {kms:9.3f} ms  {kname}")
    _no_launches(rec, "yolo2_timing", counts)


def _zoo_sweep_batch(name, model, b):
    """Seeded features and labels of ``b`` examples for a zoo model."""
    import numpy as np
    rng = np.random.RandomState(11)
    if name == "TextGenerationLSTM":
        n, t = model.numClasses, ZOO_SWEEP_T
        idx = rng.randint(0, n, (b, t + 1))
        x = np.eye(n, dtype=np.float32)[idx[:, :-1]].transpose(0, 2, 1)
        y = np.eye(n, dtype=np.float32)[idx[:, 1:]].transpose(0, 2, 1)
        return x.copy(), y.copy()
    if name == "C3D":
        x = rng.randn(b, *model.inputShape3d).astype(np.float32)
    else:
        x = rng.randn(b, *model.inputShape).astype(np.float32)
    if name == "TinyYOLO":
        return _yolo2_batch(rng, b, model.numClasses)
    if name == "UNet":
        return x, (rng.rand(b, model.numClasses, *model.inputShape[1:])
                   > 0.5).astype(np.float32)
    if name == "FaceNetNN4Small2":
        return x, np.zeros((b, model.numClasses), np.float32)
    return x, np.eye(model.numClasses, dtype=np.float32)[
        rng.randint(0, model.numClasses, b)]


def _expected_shape(net, b):
    """The output shape the configuration's output type gives for ``b``
    examples (-1 where it leaves a length open)."""
    conf = net.conf
    if hasattr(conf, "topoOrder"):
        return tuple(conf.vertexOutputTypes[conf.outputs[0]].getShape(b))
    last = conf.layers[-1]
    return tuple(last.getOutputType(conf.layerInputTypes[-1]).getShape(b))


def phase_zoo_sweep(torch, rec, card):
    """Every other ported zoo model at its default inputShape and
    numClasses: built on the card, its output shape against the
    configuration's, one fit step at batch 2 with a finite score."""
    import math
    import deeplearning4j_tpu_torch.zoo as zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    b, res = 2, {}
    _reset_counters()
    for name in ZOO_SWEEP:
        model = getattr(zoo, name)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net = model.init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        x, y = _zoo_sweep_batch(name, model, b)
        out = net.output(x)
        out = (out[0] if isinstance(out, list) else out).torch
        want = _expected_shape(net, b)
        shape_ok = len(want) == out.dim() and all(
            w in (-1, g) for w, g in zip(want, out.shape))
        norm_err = float((out.norm(dim=1) - 1).abs().max()) \
            if name == "FaceNetNN4Small2" else None
        net.fit(DataSet(x, y))          # first step: cuDNN's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(DataSet(x, y))
        score = net.score()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        res[name] = dict(params=net.numParams(), init_s=init_s,
                         out_shape=list(out.shape), expected=list(want),
                         step_ms=step_ms, score=score,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         embedding_norm_err=norm_err)
        print(f"zoo {name}: {net.numParams()} params on {net.device}, "
              f"output {tuple(out.shape)} (conf {want}), step "
              f"{step_ms:.1f} ms at batch {b}, score {score:.5g}, peak "
              f"{res[name]['peak_gb']:.2f} GB"
              + (f", |norm - 1| max {norm_err:.2g}" if norm_err is not None
                 else ""))
        _require(net.device.type == "cuda", f"{name} runs on {net.device}")
        _require(shape_ok, f"{name}: output {tuple(out.shape)}, conf {want}")
        _require(math.isfinite(score), f"{name}: score {score}")
        if norm_err is not None:
            _require(norm_err <= 1e-4, f"{name}: embeddings' norm off by "
                     f"{norm_err}")
        del net, out
    rec["zoo_sweep"] = res
    print(card)
    _no_launches(rec, "zoo_sweep", _counters())


# ---------------------------------------------------------------------------
# Keras import (phases 47-52)
# ---------------------------------------------------------------------------

def _manifest_of(f):
    """Groups, datasets (shape, dtype, allocated) and attribute names of a
    file read by the port's HDF5 reader, in the fixture manifest's form."""
    from deeplearning4j_tpu_torch.imports import hdf5
    groups, datasets, attrs = [], {}, {"/": list(f.attrs.keys())}

    def visit(name, obj):
        attrs[name] = list(obj.attrs.keys())
        if isinstance(obj, hdf5.Dataset):
            datasets[name] = [list(obj.shape), obj.dtype.str, obj.allocated]
        else:
            groups.append(name)
    f.visititems(visit)
    return {"groups": groups, "datasets": datasets, "attrs": attrs}


def phase_keras_hdf5(torch, rec, card):
    """The port's HDF5 reader on every committed Keras fixture (the card's
    machine has no h5py): groups, datasets and attribute names against the
    h5py manifest the fixture generator wrote, and every dataset read."""
    import io
    import zipfile
    import numpy as np
    from deeplearning4j_tpu_torch.imports import hdf5
    with open(_keras_path("manifest")) as fh:
        man = json.load(fh)
    _reset_counters()
    res = {}
    for key in ("resnet", "transformer", "v3"):
        path = _keras_path(key)
        t0 = time.perf_counter()
        if key == "v3":
            with zipfile.ZipFile(path) as z:
                f = hdf5.File(io.BytesIO(z.read("model.weights.h5")))
            name = KERAS[key] + ":model.weights.h5"
        else:
            f = hdf5.File(path)
            name = KERAS[key]
        got = _manifest_of(f)
        n_bytes = sum(np.asarray(f[d]).nbytes for d in got["datasets"])
        decode_s = time.perf_counter() - t0
        want = man[name]
        same = {part: got[part] == want[part]
                for part in ("groups", "datasets", "attrs")}
        res[name] = dict(decode_s=decode_s, groups=len(got["groups"]),
                         datasets=len(got["datasets"]), bytes=n_bytes,
                         same=same)
        print(f"keras_hdf5 {name}: {len(got['groups'])} groups, "
              f"{len(got['datasets'])} datasets ({n_bytes} bytes read), "
              f"decoded in {decode_s:.3f} s; against the h5py manifest "
              f"{same}")
        _require(all(same.values()), f"{name} differs from its manifest: "
                 f"{same}")
    rec["keras_hdf5"] = res
    print(card)
    _no_launches(rec, "keras_hdf5", _counters())


def _keras_transformer_batches():
    """The seeded inputs of the transformer's committed outputs (keras
    layout (b, t, d), and ours (b, d, t)), and two seeded training batches
    with one-hot labels."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    c = KERAS
    x = np.random.RandomState(c["transformer_input_seed"]).standard_normal(
        (c["batch"], c["t"], c["d"])).astype(np.float32)
    rng = np.random.RandomState(c["train_seed"])
    pool = [DataSet(rng.standard_normal((c["batch"], c["d"], c["t"]))
                    .astype(np.float32),
                    np.eye(c["classes"], dtype=np.float32)[
                        rng.randint(0, c["classes"], c["batch"])])
            for _ in range(2)]
    return np.ascontiguousarray(x.transpose(0, 2, 1)), pool


def _keras_transformer(updater=True):
    """The long-context Keras transformer imported onto the card by the
    public entry point, with ``Adam(1e-3)`` for its fit (the file carries
    no compile state)."""
    from deeplearning4j_tpu_torch.imports import KerasModelImport
    from deeplearning4j_tpu_torch.learning import Adam
    net = KerasModelImport.importKerasModelAndWeights(
        _keras_path("transformer"))
    if updater:
        net.conf.globalConf["updater"] = Adam(1e-3)
        net._initOptState()
    return net


def _tol_err(got, want, atol, rtol):
    """max |got - want| and whether every element is within atol +
    rtol·|want|."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(d.max()), bool((d <= atol + rtol * np.abs(want)).all())


def phase_keras_attention(torch, rec, card):
    """Model 1: the long-context Keras transformer through
    ``KerasModelImport.importKerasModelAndWeights`` on the card.  Counters
    zeroed before and read after each run: an inference forward launches
    B1 once per block and no backward kernel; ``fit`` two seeded batches
    for 2 epochs launches B1, B2 and B3 once per block a step.  The
    forward against keras's committed outputs; one FLOAT step against the
    same step with dense attention forced."""
    import math
    import numpy as np
    import deeplearning4j_tpu_torch.nn.conf.attention as amod
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    c = KERAS
    io_ref = np.load(_keras_path("io"))
    x, pool = _keras_transformer_batches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = _keras_transformer()
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    _require(net.device.type == "cuda", f"the net runs on {net.device}")
    kinds = [type(n[0]).__name__ for n in net.conf.nodes.values()]
    _require(kinds.count("KerasMultiHeadAttention") == c["blocks"],
             f"{kinds.count('KerasMultiHeadAttention')} attention layers")
    _reset_counters()
    probs = net.output(x).torch
    torch.cuda.synchronize()
    fwd_counts = _counters()
    with torch.no_grad():
        acts, _, _ = net._forward(net.params_, net.state_,
                                  (net._on_device(x),), False, None)
    pool_err, pool_ok = _tol_err(acts["pool"].cpu().numpy(),
                                 io_ref["transformer_pool"],
                                 **KERAS_OUT_TOL)
    prob_err, prob_ok = _tol_err(probs.cpu().numpy(),
                                 io_ref["transformer_probs"],
                                 **KERAS_OUT_TOL)
    fwd_ms = _time_ms(torch, lambda: net.output(x), iters=5, warmup=1)
    # one FLOAT step, flash against dense attention forced (it also
    # warms the card up for the timed fit)
    def one_step():
        n = _keras_transformer()
        n.fit(pool[0])
        return n.score(), n.params().torch

    _reset_counters()
    loss_f, p_f = one_step()
    step_counts = _counters()
    orig = amod.dot_product_attention
    amod.dot_product_attention = _forced_dense(orig)
    try:
        _reset_counters()
        loss_d, p_d = one_step()
        dense_counts = _counters()
    finally:
        amod.dot_product_attention = orig

    # fit: counters across the whole run
    it = ListDataSetIterator(pool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(it, epochs=c["train_epochs"])
    loss = net.score()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = _counters()
    steps = net.iterationCount
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = fit_s / steps * 1e3
    rec["launches_keras"] = {k: fwd_counts[k] + fit_counts[k]
                             for k in fwd_counts}
    prof = _device_breakdown(torch, lambda: net.fit(pool[0]), top=6)
    step_err = {"loss": abs(loss_f - loss_d),
                "params": float((p_f - p_d).abs().max())}
    rec["keras_attention"] = dict(
        import_s=import_s, forward_ms=fwd_ms, pool_max_abs_err=pool_err,
        probs_max_abs_err=prob_err, fit_steps=steps, fit_s=fit_s,
        ms_per_step=step_ms,
        tokens_per_s=c["batch"] * c["t"] * steps / fit_s, peak_gb=peak,
        loss=loss, forward_launches=fwd_counts, fit_launches=fit_counts,
        step_flash_vs_dense=dict(step_err, launches=step_counts),
        profiled_step=prof)
    print(f"keras_attention: {net.numParams()} params imported in "
          f"{import_s:.3f} s; forward {fwd_ms:.2f} ms at {c['batch']} x "
          f"{c['t']}, launches {fwd_counts}; against keras: pool |d|max "
          f"{pool_err:.3g}, probabilities |d|max {prob_err:.3g} "
          f"({KERAS_OUT_TOL}); fit {steps} steps in {fit_s:.3f} s "
          f"({step_ms:.2f} ms a step, "
          f"{rec['keras_attention']['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak:.2f} GB), loss {loss:.6g}, launches {fit_counts}; FLOAT "
          f"step flash vs dense: loss |d| {step_err['loss']:.3g}, params "
          f"|d|max {step_err['params']:.3g}; a profiled step "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']} "
          f"ms in {prof['device_ops']} ops, idle share "
          f"{prof['idle_share']}, top {prof['top'][:3]}")
    print(card)
    _require(fwd_counts["flash_attn_fwd"] == c["blocks"]
             and fwd_counts["flash_attn_bwd_dq"] == 0
             and fwd_counts["flash_attn_bwd_dkv"] == 0
             and fwd_counts["matmul_bn_stats"] == 0,
             f"the forward launched {fwd_counts}, expected {c['blocks']} B1 "
             f"and nothing else")
    _require(pool_ok and prob_ok, f"the imported transformer disagrees "
             f"with keras: pool {pool_err}, probabilities {prob_err}")
    want = c["blocks"] * steps
    _require(steps == c["train_epochs"] * len(pool)
             and all(fit_counts[k] == want for k in FLASH)
             and fit_counts["matmul_bn_stats"] == 0,
             f"{steps} steps launched {fit_counts}, expected {want} of each "
             f"flash kernel")
    _require(math.isfinite(loss), f"training loss {loss}")
    _require(all(step_counts[k] == c["blocks"] for k in FLASH)
             and not any(dense_counts.values()),
             f"flash step {step_counts}, dense step {dense_counts}")
    _require(step_err["loss"] <= TRAIN_LOSS_ATOL
             and step_err["params"] <= TRAIN_PARAM_ATOL,
             f"flash and dense steps disagree: {step_err}")


def phase_keras_resnet50(torch, rec, card):
    """Model 2: keras's ResNet-50 at full width from the committed
    skeleton, refilled from the seed, imported by ``_build_net`` on the
    card; the forward at batch 2 against keras's committed outputs and
    the same net on the CPU; ``fit`` at batch 32, FLOAT.  No kernel: the
    graph dispatches no B4, as in the reference."""
    import math
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    c = KERAS
    _reset_counters()
    timing = {}
    torch.cuda.synchronize()
    _, filled, net = _keras_resnet_import(timing=timing)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for lp in net.params_.values()
                   for v in lp.values())
    n_state = sum(v.numel() for st in net.state_.values()
                  for v in st.values())
    io_ref = np.load(_keras_path("io"))
    x = np.random.RandomState(c["resnet_input_seed"]).standard_normal(
        (c["resnet_batch"], 224, 224, 3)).astype(np.float32)
    xin = np.ascontiguousarray(x.transpose(0, 3, 1, 2))

    def features(n):
        with torch.no_grad():
            acts, _, _ = n._forward(n.params_, n.state_,
                                    (n._on_device(xin),), False, None)
        return acts["avg_pool"].cpu().numpy(), n.output(xin).numpy()

    feats, probs = features(net)
    scale = float(np.abs(io_ref["resnet_avg_pool"]).max())
    feat_err = float(np.abs(feats - io_ref["resnet_avg_pool"]).max())
    prob_err = float(np.abs(probs - io_ref["resnet_probs"]).max())
    fwd_ms = _time_ms(torch, lambda: net.output(xin), iters=10, warmup=2)
    _, _, cpu = _keras_resnet_import(device="cpu")
    cfeats, cprobs = features(cpu)
    del cpu
    card_cpu = float(np.abs(feats - cfeats).max())
    # fit at batch 32: seeded images and one-hot labels, 2 batches x 2
    rng = np.random.RandomState(c["train_seed"])
    b = c["resnet_train_batch"]
    pool = [DataSet(rng.standard_normal((b, 3, 224, 224)).astype(
        np.float32), np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, b)])
        for _ in range(2)]
    net.fit(pool[0])                    # cuDNN's set-up, not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(pool), epochs=c["resnet_train_steps"] // 2)
    loss = net.score()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = c["resnet_train_steps"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _device_breakdown(torch, lambda: net.fit(pool[0]), top=6)
    rec["keras_resnet50"] = dict(
        timing, refilled=len(filled), params=n_params, state=n_state,
        forward_ms=fwd_ms, avg_pool_max_abs_err=feat_err,
        avg_pool_scale=scale, probs_max_abs_err=prob_err,
        card_vs_cpu_avg_pool=card_cpu, ms_per_step=fit_s / steps * 1e3,
        images_per_s=b * steps / fit_s, peak_gb=peak, loss=loss,
        profiled_step=prof)
    print(f"keras_resnet50: {len(filled)} datasets refilled, decode "
          f"{timing['decode_s']:.3f} s, import {timing['import_s']:.3f} s, "
          f"{n_params} params + {n_state} BN statistics; forward "
          f"{fwd_ms:.2f} ms at batch {c['resnet_batch']}; against keras: "
          f"avg_pool |d|max {feat_err:.4g} of max {scale:.4g}, "
          f"probabilities |d|max {prob_err:.3g}; card vs CPU avg_pool "
          f"|d|max {card_cpu:.4g}; fit {steps} steps at batch {b}: "
          f"{fit_s / steps * 1e3:.2f} ms a step, {b * steps / fit_s:.1f} "
          f"images/s, peak {peak:.2f} GB, loss {loss:.6g}; a profiled "
          f"step {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']} ms in {prof['device_ops']} ops, idle "
          f"share {prof['idle_share']}, top {prof['top'][:3]}")
    print(card)
    _require(n_params + n_state == c["resnet_params"],
             f"{n_params} + {n_state} numbers, keras has "
             f"{c['resnet_params']}")
    rtol = KERAS_RESNET_TOL["rtol"]
    _require(feat_err <= rtol * scale and card_cpu <= rtol * scale
             and prob_err <= KERAS_RESNET_TOL["atol"],
             f"ResNet-50 disagrees: keras {feat_err}, CPU {card_cpu} "
             f"(scale {scale}), probabilities {prob_err}")
    _require(math.isfinite(loss), f"training loss {loss}")
    _no_launches(rec, "keras_resnet50", _counters())


def phase_keras_v3(torch, rec, card):
    """The narrow ``.keras`` archive (keras 3's native format: config.json
    and model.weights.h5 in a zip) imported onto the card, against
    keras's committed outputs; its compile state gives Adam."""
    import numpy as np
    from deeplearning4j_tpu_torch.imports import KerasModelImport
    c = KERAS
    _reset_counters()
    t0 = time.perf_counter()
    net = KerasModelImport.importKerasModelAndWeights(_keras_path("v3"))
    import_s = time.perf_counter() - t0
    x = np.random.RandomState(c["v3_input_seed"]).standard_normal(
        c["v3_shape"]).astype(np.float32)
    out = net.output(np.ascontiguousarray(x.transpose(0, 2, 1)))
    err, ok = _tol_err(out.numpy(), np.load(_keras_path("io"))[
        "v3_probs"], **KERAS_OUT_TOL)
    up = type(net.conf.globalConf["updater"]).__name__
    rec["keras_v3"] = dict(import_s=import_s, max_abs_err=err, updater=up)
    print(f"keras_v3: {type(net).__name__} of {net.numParams()} params on "
          f"{net.device} in {import_s:.3f} s, updater {up}; against keras "
          f"|d|max {err:.3g} ({KERAS_OUT_TOL})")
    print(card)
    _require(net.device.type == "cuda" and ok and up == "Adam",
             f"the .keras import: {net.device}, |d| {err}, updater {up}")
    _no_launches(rec, "keras_v3", _counters())


def _vae_conf():
    """dl4j-examples' VaeMNISTAnomaly configuration."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (NeuralNetConfiguration,
                                                  VariationalAutoencoder)
    c = VAE
    return (NeuralNetConfiguration.builder().seed(c["seed"])
            .updater(Adam(c["lr"])).weightInit("XAVIER").l2(c["l2"]).list()
            .layer(VariationalAutoencoder(
                nIn=c["nIn"], nOut=c["nOut"], encoderLayerSizes=c["hidden"],
                decoderLayerSizes=c["hidden"], activation="leakyrelu",
                reconstructionDistribution="bernoulli"))
            .build())


def _ae_conf():
    """A stacked denoising autoencoder, 784 -> 250 -> 10, xent, and a
    softmax head."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (AutoEncoder, InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    c = VAE
    b = (NeuralNetConfiguration.builder().seed(c["seed"])
         .updater(Adam(c["lr"])).weightInit("XAVIER").list())
    for n in c["ae_sizes"]:
        b = b.layer(AutoEncoder(nOut=n, corruptionLevel=c["ae_corruption"],
                                lossFunction="xent", activation="sigmoid"))
    return (b.layer(OutputLayer.builder("mcxent").nOut(10)
                    .activation("softmax").build())
            .setInputType(InputType.feedForward(c["nIn"])).build())


def phase_vae_pretrain(torch, rec, card):
    """Model 3: ``VaeMNISTAnomaly`` at its widths on 60,000 MNIST-shaped
    images: ``pretrain`` one epoch (the ELBO must fall), then
    ``reconstructionLogProbability(numSamples=16)`` over the 10,000 test
    images; a stacked denoising autoencoder pretrains, and one of its
    pretrain steps on the card is held against the CPU's with the
    corruption drawn on the CPU and passed in.  No kernel."""
    import math
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ListDataSetIterator,
                                                   MnistDataSetIterator)
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    c = VAE
    _reset_counters()
    t0 = time.perf_counter()
    train = MnistDataSetIterator(c["batch"], True, c["seed"],
                                 numExamples=c["n_train"])
    test = MnistDataSetIterator(c["n_test"], False, c["seed"],
                                numExamples=c["n_test"])
    data_s = time.perf_counter() - t0
    net = MultiLayerNetwork(_vae_conf()).init()
    layer = net.conf.layers[0]
    xt = net._on_device(test.next().features)
    eps = torch.randn((1, xt.shape[0], c["nOut"]), device=net.device,
                      generator=torch.Generator(net.device).manual_seed(1))
    with torch.no_grad():
        elbo0 = layer.pretrainLossGivenNoise(net.params_["0"], xt, eps)\
            .item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.pretrain(train, epochs=1)
    loss = net.score()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    steps = math.ceil(c["n_train"] / c["batch"])
    with torch.no_grad():
        elbo1 = layer.pretrainLossGivenNoise(net.params_["0"], xt, eps)\
            .item()
        t1 = time.perf_counter()
        scores = layer.reconstructionLogProbability(
            net.params_["0"], xt, numSamples=c["samples"])
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the stacked denoising autoencoder
    ae = MultiLayerNetwork(_ae_conf()).init()
    train.reset()
    batches = [train.next() for _ in range(c["ae_steps"])]
    x0 = net._on_device(batches[0].features)
    err0 = ae.conf.layers[0].reconstructionError(ae.params_["0"], x0)\
        .mean().item()
    t0 = time.perf_counter()
    ae.pretrain(ListDataSetIterator(batches), epochs=1)
    torch.cuda.synchronize()
    ae_s = time.perf_counter() - t0
    err1 = ae.conf.layers[0].reconstructionError(ae.params_["0"], x0)\
        .mean().item()
    step = _ae_step_card_vs_cpu(torch, batches[0])
    rec["vae_pretrain"] = dict(
        data_s=data_s, steps=steps, pretrain_s=pre_s,
        ms_per_step=pre_s / steps * 1e3, examples_per_s=c["n_train"] / pre_s,
        elbo_before=elbo0, elbo_after=elbo1, loss=loss, score_s=score_s,
        score_mean=float(scores.mean()), peak_gb=peak,
        ae=dict(pretrain_s=ae_s, steps=2 * c["ae_steps"],
                reconstruction_before=err0, reconstruction_after=err1,
                step_card_vs_cpu=step))
    print(f"vae_pretrain: {c['n_train']} + {c['n_test']} synthetic MNIST "
          f"images in {data_s:.2f} s; pretrain 1 epoch, {steps} steps in "
          f"{pre_s:.2f} s ({pre_s / steps * 1e3:.2f} ms a step, "
          f"{c['n_train'] / pre_s:.0f} images/s, peak {peak:.2f} GB): "
          f"negative ELBO on the test images {elbo0:.5g} -> {elbo1:.5g}; "
          f"reconstructionLogProbability x{c['samples']} of "
          f"{c['n_test']} images in {score_s * 1e3:.1f} ms, mean "
          f"{float(scores.mean()):.5g}; autoencoder {c['ae_sizes']}: "
          f"{2 * c['ae_steps']} steps in {ae_s:.2f} s, reconstruction "
          f"{err0:.5g} -> {err1:.5g}; one step card vs CPU (loss relative "
          f"1e-6) {step}")
    print(card)
    _require(elbo1 < elbo0 and math.isfinite(loss),
             f"the ELBO did not improve: {elbo0} -> {elbo1}, loss {loss}")
    _require(tuple(scores.shape) == (c["n_test"],)
             and bool(scores.isfinite().all()), "scores not finite")
    _require(err1 < err0, f"autoencoder reconstruction {err0} -> {err1}")
    _require(step["params"] <= 1e-5 and step["loss"] <= 1e-6 * step["of"],
             f"the autoencoder step differs card vs CPU: {step}")
    _no_launches(rec, "vae_pretrain", _counters())


def _ae_step_card_vs_cpu(torch, ds):
    """One pretrain step of each autoencoder layer from the same
    parameters on the card and on the CPU, each layer's corruption mask
    drawn once on the CPU and passed in: the largest parameter and loss
    differences."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    nets = {}
    gen = torch.Generator().manual_seed(VAE["seed"])
    params0 = None
    for dev in ("cuda", "cpu"):
        net = MultiLayerNetwork(_ae_conf(), device=dev).init(params=params0)
        params0 = params0 or {k: {n: v.cpu() for n, v in lp.items()}
                              for k, lp in net.params_.items()}
        nets[dev] = net
    masks = {}
    for i, layer in enumerate(nets["cpu"].conf.layers[:2]):
        n_in = VAE["nIn"] if i == 0 else VAE["ae_sizes"][0]
        masks[i] = torch.rand((ds.features.shape[0], n_in),
                              generator=gen) < 1 - layer.corruptionLevel
    for dev, net in nets.items():
        for i, layer in enumerate(net.conf.layers[:2]):
            layer.corruptionMask = (lambda x, g, m=masks[i]:
                                    m.to(x.device))
        net.pretrain(ListDataSetIterator([ds]), epochs=1)
    dp = max(float((nets["cuda"].params_[k][n].cpu() - v).abs().max())
             for k, lp in nets["cpu"].params_.items() for n, v in lp.items())
    return {"params": dp, "loss": abs(nets["cuda"].score()
                                      - nets["cpu"].score()),
            "of": abs(nets["cpu"].score())}


def phase_attention_layers(torch, rec, card):
    """Item 4: the other A7 layers at small widths, card against CPU from
    the same parameters: ``SelfAttentionLayer``'s chained ``decodeStep``
    against its causal forward, ``LearnedSelfAttentionLayer``,
    ``RecurrentAttentionLayer``; the recurrent layer at t 1024 reaches B1
    through its ``_mha`` (counted: one launch)."""
    from deeplearning4j_tpu_torch.nn.conf.attention import (
        LearnedSelfAttentionLayer, RecurrentAttentionLayer,
        SelfAttentionLayer)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    c = ATTENTION_LAYERS
    gen = torch.Generator().manual_seed(c["seed"])
    kw = dict(nIn=c["nIn"], nHeads=c["nHeads"], headSize=c["headSize"],
              nOut=c["nOut"])
    res = {}

    def pair(layer, t):
        layer.inferNIn(InputType.recurrent(c["nIn"], t))
        p = layer.initParams(gen, InputType.recurrent(c["nIn"], t),
                             device="cpu")
        x = torch.randn((c["batch"], c["nIn"], t), generator=gen)
        return p, {k: v.cuda() for k, v in p.items()}, x

    def card_vs_cpu(name, layer, t):
        p, pc, x = pair(layer, t)
        with torch.no_grad():
            _reset_counters()
            y = layer.forward(pc, x.cuda(), False, None, {})[0]
            torch.cuda.synchronize()
            counts = _counters()
            ref = layer.forward(p, x, False, None, {})[0]
        err = float((y.cpu() - ref).abs().max())
        res[name] = dict(max_abs_err=err, launches=counts,
                         shape=list(y.shape))
        return err, counts

    _reset_counters()
    sa = SelfAttentionLayer(causal=True, **kw)
    p, pc, x = pair(sa, c["t"])
    with torch.no_grad():
        full = sa.forward(pc, x.cuda(), False, None, {})[0]
        cache = sa.initCache(c["batch"], c["t"])
        pieces, pos = [], 0
        for n in (1, 7, 16, c["t"] - 24):
            y, cache = sa.decodeStep(pc, x[:, :, pos:pos + n].cuda(), cache)
            pieces.append(y)
            pos += n
        chained = torch.cat(pieces, dim=2)
        cpu_full = sa.forward(p, x, False, None, {})[0]
    res["decode_vs_forward"] = float((chained - full).abs().max())
    res["self_attention_card_vs_cpu"] = float((full.cpu() - cpu_full)
                                              .abs().max())
    short = _counters()
    card_vs_cpu("learned", LearnedSelfAttentionLayer(
        nQueries=c["nQueries"], **kw), c["t"])
    card_vs_cpu("recurrent", RecurrentAttentionLayer(**kw), c["t"])
    short = {k: short[k] + res["learned"]["launches"][k]
             + res["recurrent"]["launches"][k] for k in short}
    _, long_counts = card_vs_cpu("recurrent_t1024",
                                 RecurrentAttentionLayer(**kw), c["long_t"])
    rec["attention_layers"] = res
    rec["launches_attention_layers"] = long_counts
    print(f"attention_layers: decodeStep chained vs causal forward |d|max "
          f"{res['decode_vs_forward']:.3g}; self-attention card vs CPU "
          f"{res['self_attention_card_vs_cpu']:.3g}; learned "
          f"{res['learned']['max_abs_err']:.3g}; recurrent "
          f"{res['recurrent']['max_abs_err']:.3g} at t {c['t']} (launches "
          f"{short}); recurrent at t {c['long_t']} "
          f"{res['recurrent_t1024']['max_abs_err']:.3g}, launches "
          f"{long_counts} ({ATTENTION_TOL})")
    print(card)
    tol = ATTENTION_TOL["atol"]
    _require(max(res["decode_vs_forward"], res["self_attention_card_vs_cpu"],
                 res["learned"]["max_abs_err"],
                 res["recurrent"]["max_abs_err"],
                 res["recurrent_t1024"]["max_abs_err"]) <= tol,
             f"an attention layer disagrees: {res}")
    _require(not any(short.values()), f"t {c['t']} launched {short}")
    _require(long_counts["flash_attn_fwd"] == 1
             and sum(long_counts.values()) == 1,
             f"the recurrent layer at t {c['long_t']} launched "
             f"{long_counts}, expected one B1")


def _etl_metric(name):
    """The ETL series ``name`` of the current registry (None before its
    first use)."""
    from deeplearning4j_tpu_torch.telemetry import get_registry
    return get_registry().get(name)


def _fresh_telemetry():
    """A fresh metrics registry (the ETL counters start at 0) and the
    previous one, to put back."""
    from deeplearning4j_tpu_torch import telemetry
    return telemetry.set_registry(telemetry.MetricsRegistry())


def phase_nd4j(torch, rec, card):
    """Item 53: the tensor layer on the card, the same calls on the card
    and on the CPU from the same numpy inputs."""
    import io

    import numpy as np
    from deeplearning4j_tpu_torch.ops import (DataType, Nd4j, NDArrayIndex,
                                              serde)
    c = ND4J
    rng = np.random.RandomState(c["seed"])
    a = rng.randn(c["m"], c["k"]).astype(np.float32)
    b = rng.randn(c["k"], c["n"]).astype(np.float32)
    v = rng.randn(c["k"]).astype(np.float32)
    _reset_counters()
    z = Nd4j.zeros(3, 4)
    r = Nd4j.rand(5, 5)
    _require(z.torch.device.type == "cuda" and r.torch.device.type == "cuda",
             f"Nd4j creation landed on {z.torch.device} / {r.torch.device}")
    ga, ca = Nd4j.create(a), Nd4j.create(a, device="cpu")
    gb, cb = Nd4j.create(b), Nd4j.create(b, device="cpu")
    gv, cv = Nd4j.create(v), Nd4j.create(v, device="cpu")
    _require(ga.torch.device.type == "cuda" and
             ca.torch.device.type == "cpu", "create placed arrays wrongly")
    exact = {
        "add": lambda x, y, w: x.add(2.5), "sub_row": lambda x, y, w:
        x.subRowVector(w), "mul": lambda x, y, w: x.mul(x),
        "neg": lambda x, y, w: x.neg(), "abs": lambda x, y, w: abs(x),
        "relu": lambda x, y, w: Nd4j.relu(x),
        "max": lambda x, y, w: x.max(1), "argMax": lambda x, y, w:
        x.argMax(0), "gt": lambda x, y, w: x.gt(0.1),
        "clip": lambda x, y, w: Nd4j.clip(x, -0.5, 0.5),
        "transpose": lambda x, y, w: x.transpose(),
        "concat": lambda x, y, w: Nd4j.concat(0, x, x),
        "gather": lambda x, y, w: Nd4j.gather(x, Nd4j.create(
            np.array([3, 1, 4], np.int64), device=str(x.torch.device))),
    }
    approx = {
        "mmul": lambda x, y, w: x.mmul(y), "exp": lambda x, y, w:
        Nd4j.exp(x), "tanh": lambda x, y, w: Nd4j.tanh(x),
        "sigmoid": lambda x, y, w: Nd4j.sigmoid(x),
        "softmax": lambda x, y, w: Nd4j.softmax(x), "log": lambda x, y, w:
        Nd4j.log(abs(x).add(1.0)), "sum": lambda x, y, w: x.sum(0),
        "mean": lambda x, y, w: x.mean(1), "std": lambda x, y, w: x.std(0),
        "norm2": lambda x, y, w: x.norm2(1),
        "gemm": lambda x, y, w: Nd4j.gemm(x, x, transposeB=True),
    }
    errs, bad = {}, []
    for name, fn in {**exact, **approx}.items():
        g, cpu = fn(ga, gb, gv), fn(ca, cb, cv)
        _require(g.torch.device.type == "cuda", f"{name} left the card")
        gn, cn = g.numpy(), cpu.numpy()
        if name in exact:
            ok = gn.shape == cn.shape and np.array_equal(gn, cn)
            errs[name] = 0.0 if ok else float("inf")
        else:
            d = np.abs(gn.astype(np.float64) - cn)
            errs[name] = float(d.max())
            ok = errs[name] <= ND4J_TOL["atol"] + ND4J_TOL["rtol"] * \
                float(np.abs(cn).max())
        if not ok:
            bad.append(name)
    # a write through a view reaches the parent, on the card
    views = {}
    for dev in ("cuda", "cpu"):
        p = Nd4j.create(a[:8, :6], device=dev)
        p.getRow(2).assign(7.0)
        p.get(NDArrayIndex.interval(4, 6), NDArrayIndex.all()).addi(1.0)
        p.get(NDArrayIndex.indices(0, 7), NDArrayIndex.point(1)).assign(-3.0)
        p.getColumn(5).muli(2.0)
        views[dev] = p.numpy()
    views_ok = np.array_equal(views["cuda"], views["cpu"])
    # DOUBLE end to end; FLOAT the default
    d64 = Nd4j.rand(64, 64, dtype=DataType.DOUBLE)
    dbl = [d64.mmul(d64).dataType(), d64.sum(0).dataType(),
           d64.mean().dataType()]
    dbl_ok = d64.torch.dtype == torch.float64 and all(
        t is DataType.DOUBLE for t in dbl) and \
        Nd4j.ones(2).torch.dtype == torch.float32
    # .npy of a card array: the CPU array's bytes
    npy_ok = serde.to_npy_bytes(ga) == serde.to_npy_bytes(ca)
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    npy_ok = npy_ok and serde.to_npy_bytes(ga) == buf.getvalue()
    back = serde.from_npy_bytes(serde.to_npy_bytes(ga))
    npy_ok = npy_ok and np.array_equal(back.numpy(), a)
    # the seeded RNG repeats on the card
    rng_nd = Nd4j.getRandom()
    rng_nd.setSeed(1234)
    d1 = Nd4j.rand(1000)
    rng_nd.setSeed(1234)
    d2 = Nd4j.rand(1000)
    d3 = Nd4j.rand(1000)
    rng_ok = bool(torch.equal(d1.torch, d2.torch)) and \
        not bool(torch.equal(d2.torch, d3.torch)) and \
        d1.torch.device.type == "cuda"
    mm_ms = _time_ms(torch, lambda: ga.mmul(gb), iters=40)
    torch.cuda.synchronize()
    counts = _counters()
    _no_launches(rec, "nd4j", counts)
    rec["nd4j"] = dict(errors=errs, failed=bad, views=views_ok,
                       double=dbl_ok, npy=npy_ok, rng=rng_ok,
                       mmul_ms=mm_ms)
    print(f"nd4j: {len(exact)} exact ops card == CPU, {len(approx)} within "
          f"{ND4J_TOL} (largest |d| "
          f"{max(errs[k] for k in approx):.3g}, mmul "
          f"{c['m']}x{c['k']}x{c['n']} {mm_ms:.4f} ms); view writes "
          f"{views_ok}, DOUBLE end to end {dbl_ok}, .npy bytes {npy_ok}, "
          f"seeded draws repeat {rng_ok}")
    print(card)
    _require(not bad, f"card and CPU differ in {bad}: {errs}")
    _require(views_ok, "a write through a view did not reach the parent "
             "on the card as it does on the CPU")
    _require(dbl_ok, f"DOUBLE did not stay float64 ({dbl}) or the default "
             f"is not float32")
    _require(npy_ok, ".npy of a card array is not the CPU array's bytes")
    _require(rng_ok, "setSeed does not repeat the card's draws")
    del ga, gb, gv, d64, d1, d2, d3, z, r


def _etl_csv_files(d):
    """The seeded 150,000-row CSV (header + rows) and its schema."""
    import numpy as np
    c = ETL_CSV
    rng = np.random.RandomState(c["seed"])
    n = c["rows"]
    cols = rng.randn(n, 4)
    cat = rng.randint(0, 3, n)
    label = (cols[:, 0] + 0.5 * cols[:, 1] + cat > 0.8).astype(int) + \
        (cols[:, 2] > 1.0).astype(int)
    path = os.path.join(d, "raw.csv")
    with open(path, "w") as f:
        f.write("f0,f1,f2,f3,cat,label\n")
        np.savetxt(f, np.column_stack([cols, cat, label]),
                   fmt=["%.6f"] * 4 + ["%d", "%d"], delimiter=",")
    return path


def phase_etl_csv(torch, rec, card):
    """Item 54: dl4j-examples' CSV route on the card: CSVRecordReader (the
    native bulk parse and the record parse), a Schema and TransformProcess
    run by LocalTransformExecutor and by SparkTransformExecutor on the
    native pool (they must agree), the result written out and streamed by
    a CSVRecordReader through RecordReaderDataSetIterator and
    NormalizerStandardize into MultiLayerNetwork.fit, which engages the
    producer pool (C22)."""
    import math
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import NormalizerStandardize
    from deeplearning4j_tpu_torch.datavec import (
        ColumnCondition, ConditionOp, CSVRecordReader, FileSplit,
        LocalTransformExecutor, RecordReaderDataSetIterator, Schema,
        SparkTransformExecutor, TransformProcess)
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    c = ETL_CSV
    _require(native.available(), "the port's native library did not build")
    prev = _fresh_telemetry()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            t0 = time.perf_counter()
            raw = _etl_csv_files(d)
            write_s = time.perf_counter() - t0
            rr = CSVRecordReader(skipNumLines=1)
            rr.initialize(FileSplit(raw))
            t0 = time.perf_counter()
            mat = rr.loadAll()
            native_s = time.perf_counter() - t0
            _require(mat.shape == (c["rows"], 6), f"loadAll {mat.shape}")
            t0 = time.perf_counter()
            records = [rr.next() for _ in range(c["rows"])]
            parse_s = time.perf_counter() - t0
            schema = (Schema.Builder().addColumnDouble("f0", "f1", "f2", "f3")
                      .addColumnInteger("cat", "label").build())
            tp = (TransformProcess.Builder(schema)
                  .integerToCategorical("cat", ["a", "b", "c"])
                  .categoricalToOneHot("cat")
                  .filter(ColumnCondition("f3", ConditionOp.LessThan, -2.5))
                  .doubleMathOp("f1", "Multiply", 2.0)
                  .build())
            t0 = time.perf_counter()
            local = LocalTransformExecutor.execute(records, tp)
            local_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            spark = SparkTransformExecutor.execute(records, tp,
                                                   numPartitions=16)
            spark_s = time.perf_counter() - t0
            same = len(local) == len(spark) and all(
                [w.value for w in x] == [w.value for w in y]
                for x, y in zip(local, spark))
            final = tp.getFinalSchema()
            n_out = len(final.getColumnNames())
            proc = os.path.join(d, "processed.csv")
            with open(proc, "w") as f:
                for r in local:
                    f.write(",".join(str(w.value) for w in r) + "\n")
            rr2 = CSVRecordReader()
            rr2.initialize(FileSplit(proc))
            it = RecordReaderDataSetIterator(
                rr2, c["batch"], labelIndex=final.getIndexOfColumn("label"),
                numPossibleLabels=3)
            norm = NormalizerStandardize()
            norm.fit(it)
            it.setPreProcessor(norm)
            conf = (NeuralNetConfiguration.builder().seed(c["seed"])
                    .updater(Adam(c["lr"])).list()
                    .layer(DenseLayer.builder().nOut(c["hidden"])
                           .activation("relu").build())
                    .layer(OutputLayer.builder("mcxent").nOut(3)
                           .activation("softmax").build())
                    .setInputType(InputType.feedForward(n_out - 1)).build())
            net = MultiLayerNetwork(conf).init()
            _require(net.device.type == "cuda", f"net on {net.device}")
            _reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(it, epochs=1)
            loss = net.score()
            fit_s = time.perf_counter() - t0
            counts = _counters()
            steps = net.getIterationCount()
            pool_batches = _etl_metric("dl4j_tpu_etl_pool_batches_total")
            h2d = _etl_metric("dl4j_tpu_etl_h2d_bytes_total")
            pooled = pool_batches.value() if pool_batches else 0
            h2d_bytes = h2d.value() if h2d else 0
    finally:
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    _no_launches(rec, "etl_csv", counts)
    n = c["rows"]
    rec["etl_csv"] = dict(
        rows=n, kept=len(local), write_s=write_s,
        native_parse_rows_per_s=n / native_s, parse_rows_per_s=n / parse_s,
        local_transform_rows_per_s=n / local_s,
        spark_transform_rows_per_s=n / spark_s, executors_agree=same,
        steps=steps, pool_batches=pooled, h2d_bytes=h2d_bytes, loss=loss,
        fit_s=fit_s, rows_per_s_fit=len(local) / fit_s,
        native_threads=native.num_threads())
    print(f"etl_csv: {n} rows (write {write_s:.2f} s); native loadAll "
          f"{n / native_s:,.0f} rows/s, record parse {n / parse_s:,.0f} "
          f"rows/s; transform local {n / local_s:,.0f} rows/s, Spark on the "
          f"native pool ({native.num_threads()} threads) "
          f"{n / spark_s:,.0f} rows/s, agree {same}, {len(local)} rows "
          f"kept; fit {steps} steps through the pool ({pooled:.0f} pool "
          f"batches, {h2d_bytes / 1e6:.2f} MB staged) in {fit_s:.2f} s "
          f"({len(local) / fit_s:,.0f} rows/s), loss {loss:.5g}")
    print(card)
    _require(same, "LocalTransformExecutor and SparkTransformExecutor "
             "disagree")
    _require(0 < len(local) < n, f"the filter kept {len(local)} of {n}")
    workers = int(os.environ.get("DL4J_TPU_ETL_WORKERS", "2"))
    want_steps = sum(math.ceil(len(range(w, len(local), workers))
                               / c["batch"]) for w in range(workers))
    _require(steps == want_steps, f"{steps} steps, expected {want_steps} "
             f"({workers} workers' record shards in batches of "
             f"{c['batch']})")
    _require(pooled == steps and h2d_bytes > 0,
             f"fit did not engage the pool: {pooled} pool batches for "
             f"{steps} steps, {h2d_bytes} bytes staged")
    _require(math.isfinite(loss), f"loss {loss}")


def _write_png_folders(root, c):
    """``c["n"]`` seeded RGB PNGs in ``c["classes"]`` label folders: a
    gradient of the image's own slope and colour offset with noise (so the
    files compress as photographs do, ~120 KB each), written on a thread
    pool (zlib releases the GIL)."""
    import concurrent.futures

    import numpy as np
    from deeplearning4j_tpu_torch.datavec.png import write_png
    hw = c["hw"]
    yy, xx = np.mgrid[0:hw, 0:hw]
    labels = []

    def one(i):
        rng = np.random.RandomState(c["seed"] * 1000 + i)
        lab = rng.randint(c["classes"])
        base = (yy * rng.randint(1, 4) + xx * rng.randint(1, 4))[:, :, None] \
            + rng.randint(0, 256, 3)
        img = ((base + rng.randint(0, 40, (hw, hw, 3))) % 256).astype(
            np.uint8)
        folder = os.path.join(root, f"class{lab:02d}")
        os.makedirs(folder, exist_ok=True)
        write_png(os.path.join(folder, f"img{i:04d}.png"), img, level=1)
        return lab

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        labels = list(ex.map(one, range(c["n"])))
    return labels


def _tap(inner):
    """``inner`` (the pool) wrapped for ``ComputationGraph.fit``: records
    each batch's size, device and labels, the first batch (cloned), and
    the host time the loop spent in the pool's calls (``wait_s``; the
    first ``hasNext``, which starts the pool and waits for its first
    batch, apart as ``first_s``)."""
    from deeplearning4j_tpu_torch.datasets import DataSetIterator

    class Tap(DataSetIterator):
        def __init__(self):
            self.sizes, self.devices, self.labels = [], [], []
            self.first, self.first_s, self.wait_s = None, None, 0.0

        def reset(self):
            inner.reset()

        def hasNext(self):
            t0 = time.perf_counter()
            out = inner.hasNext()
            dt = time.perf_counter() - t0
            if self.first_s is None:
                self.first_s = dt
            else:
                self.wait_s += dt
            return out

        def next(self, num=0):
            t0 = time.perf_counter()
            ds = inner.next()
            self.wait_s += time.perf_counter() - t0
            f = ds.features.torch
            self.sizes.append(int(f.shape[0]))
            self.devices.append(f.device.type)
            self.labels.append(ds.labels.torch.argmax(1))
            if self.first is None:
                self.first = (f.clone(), ds.labels.torch.clone())
            return ds

    return Tap()


def phase_etl_images_resnet50(torch, rec, card):
    """Item 55: the slice's main path.  640 PNGs at 224 x 224 through
    ImageRecordReader (flip + crop) -> RecordReaderDataSetIterator(64,
    1000 classes) -> ImagePreProcessingScaler -> PrefetchingDataSetIterator
    (4 workers, the pinned ring onto cuda) -> ComputationGraph.fit of
    ResNet-50 (BFLOAT16) for one epoch.  Checks exactly-once delivery, the
    first pooled batch against the same worker's shard drained inline,
    batches on the card, the H2D bytes, a staged step against an
    in-memory step, no kernel launch; times decode, the streamed and the
    in-memory fit, the H2D rate, a profiled streamed step."""
    import math
    import pickle
    import tempfile
    import threading

    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ImagePreProcessingScaler,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.datavec import (
        CropImageTransform, FileSplit, FlipImageTransform, ImageRecordReader,
        ParentPathLabelGenerator, PipelineImageTransform,
        PrefetchingDataSetIterator, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.telemetry import tracer
    from deeplearning4j_tpu_torch.zoo import ResNet50
    c = ETL_IMAGES
    prev = _fresh_telemetry()
    res = {}
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            t0 = time.perf_counter()
            labels = _write_png_folders(d, c)
            res["write_s"] = time.perf_counter() - t0
            rr = ImageRecordReader(c["hw"], c["hw"], 3,
                                   ParentPathLabelGenerator(),
                                   PipelineImageTransform(
                                       FlipImageTransform(None),
                                       CropImageTransform(c["crop"])),
                                   seed=c["seed"])
            rr.initialize(FileSplit(d))
            it = RecordReaderDataSetIterator(rr, c["batch"], labelIndex=1,
                                             numPossibleLabels=RESNET[
                                                 "numClasses"])
            it.setPreProcessor(ImagePreProcessingScaler())
            names = rr.getLabels()
            want_hist = np.bincount([names.index(f"class{lab:02d}")
                                     for lab in labels],
                                    minlength=RESNET["numClasses"])
            # each worker's shard drained inline on the CPU, as a worker
            # of the pool's first generation (epoch 0) makes it: the
            # in-memory pool, the first-batch candidates, the decode rate
            src = pickle.loads(pickle.dumps(it))
            src.setEpoch(0)
            inline = []
            t0 = time.perf_counter()
            for w in range(c["workers"]):
                sh = src.shard(w, c["workers"])
                while sh.hasNext():
                    inline.append(sh.next())
            decode_s = time.perf_counter() - t0
            res["decode_images_per_s_per_worker"] = c["n"] / decode_s
            net = ResNet50(numClasses=RESNET["numClasses"],
                           inputShape=RESNET["inputShape"],
                           dataType="BFLOAT16").init()
            params0 = {v: {k: t.clone() for k, t in lp.items()}
                       for v, lp in net.params_.items()}
            pit = PrefetchingDataSetIterator(
                it, numWorkers=c["workers"], device="cuda",
                shmBytes=c["shm_mb"] << 20)
            tap = _tap(pit)
            h2d = _etl_metric("dl4j_tpu_etl_h2d_bytes_total")
            h2d0 = h2d.value() if h2d else 0.0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            t0 = time.perf_counter()
            net.fit(tap, epochs=1)
            loss = net.score()
            fit_s = time.perf_counter() - t0
            counts = _counters()
            ev = [e for e in tracer().events()
                  if e["ts"] >= (t0 - tracer()._t0) * 1e6]
            res["pool_start_s"] = sum(e["dur"] for e in ev
                                      if e["name"] == "etl_pool_start") / 1e6
            res["staging_s"] = sum(e["dur"] for e in ev
                                   if e["name"] == "etl_assemble") / 1e6
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            h2d_bytes = _etl_metric("dl4j_tpu_etl_h2d_bytes_total").value() \
                - h2d0
            # a profiled streamed step: a second epoch's pool, two batches
            # warm, then one fetch + step under the profiler
            pit.reset()
            for _ in range(2):
                net.fit(pit.next())
            prof = _device_breakdown(torch, lambda: (net.fit(pit.next()),
                                                     net.score()), top=6)
            pit.close()                 # every staged copy now timed
            hist = _etl_metric("dl4j_tpu_etl_h2d_seconds")
            h2d_s, h2d_n = hist.sum(), hist.count()
            h2d_all = _etl_metric(
                "dl4j_tpu_etl_h2d_bytes_total").value() - h2d0
            # the copy engine alone, one full batch: pinned against
            # pageable host memory (what a ListDataSetIterator's batch
            # crosses from)
            nb = c["batch"] * 3 * c["hw"] * c["hw"]
            pinned = torch.empty(nb, dtype=torch.float32, pin_memory=True)
            pageable = torch.empty(nb, dtype=torch.float32)
            dst = torch.empty(nb, dtype=torch.float32, device="cuda")
            copy_ms = {
                "pinned": _time_ms(torch, lambda: dst.copy_(
                    pinned, non_blocking=True), iters=20),
                "pageable": _time_ms(torch, lambda: dst.copy_(pageable),
                                     iters=20)}
            del pinned, pageable, dst
            # the same fit from the in-memory pool of decoded batches
            mem = ListDataSetIterator(inline)
            net.fit(mem.next())                 # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(mem, epochs=1)
            net.score()
            mem_s = time.perf_counter() - t0
            # and again while 4 workers decode (a host-target pool drained
            # by a thread): what the decoding costs the step's host side
            bg = PrefetchingDataSetIterator(it, numWorkers=c["workers"],
                                            shmBytes=c["shm_mb"] << 20)
            busy = threading.Event()

            def drain():
                while not busy.is_set():
                    bg.reset()
                    while bg.hasNext() and not busy.is_set():
                        bg.next()

            th = threading.Thread(target=drain, daemon=True)
            th.start()
            time.sleep(1.0)                     # the workers are decoding
            t0 = time.perf_counter()
            net.fit(mem, epochs=1)
            net.score()
            mem_busy_s = time.perf_counter() - t0
            busy.set()
            th.join()
            bg.close()
    finally:
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    got_hist = np.bincount(torch.cat(tap.labels).cpu().numpy(),
                           minlength=RESNET["numClasses"])
    n_seen = sum(tap.sizes)
    # the first pooled batch against the first batch of each worker's
    # inline shard: exactly one must match, bit for bit
    f0, l0 = (t.cpu() for t in tap.first)
    firsts = [inline[i] for i in range(len(inline)) if i == 0 or
              inline[i - 1].features.shape[0] < c["batch"]]
    matches = [k for k, ds in enumerate(firsts)
               if torch.equal(ds.features.torch, f0)
               and torch.equal(ds.labels.torch, l0)]
    # a step from the staged batch against the same batch in memory
    staged = DataSet(tap.first[0], tap.first[1])
    mem_ds = firsts[matches[0]] if matches else firsts[0]
    steps = {}
    conf = ResNet50(numClasses=RESNET["numClasses"],
                    inputShape=RESNET["inputShape"],
                    dataType="BFLOAT16").graphBuilder().build()
    for name, ds in (("staged", staged), ("in_memory", mem_ds)):
        g = ComputationGraph(conf).init(params=params0)
        g.fit(ds)
        steps[name] = (g.score(), g.params().torch)
        del g
    loss_d = abs(steps["staged"][0] - steps["in_memory"][0])
    param_d = float((steps["staged"][1] - steps["in_memory"][1]).abs().max())
    epoch_bytes = c["n"] * (3 * c["hw"] * c["hw"] + RESNET["numClasses"]) * 4
    _no_launches(rec, "etl_images_resnet50", counts)
    res.update(
        images=n_seen, steps=len(tap.sizes), batch_sizes=tap.sizes,
        on_card=all(dv == "cuda" for dv in tap.devices),
        labels_exact=bool((got_hist == want_hist).all()),
        first_batch_matches=matches, loss=loss, fit_s=fit_s,
        streamed_images_per_s=c["n"] / fit_s,
        first_batch_s=tap.first_s, data_wait_s=tap.wait_s,
        after_first_images_per_s=(c["n"] - tap.sizes[0])
        / (fit_s - tap.first_s),
        in_memory_images_per_s=c["n"] / mem_s, in_memory_fit_s=mem_s,
        in_memory_while_decoding_images_per_s=c["n"] / mem_busy_s,
        h2d_bytes=h2d_bytes, epoch_bytes=epoch_bytes,
        h2d_mb_per_s=h2d_all / 1e6 / h2d_s if h2d_s else None,
        h2d_batches_timed=h2d_n, h2d_seconds=h2d_s, h2d_bytes_timed=h2d_all,
        batch_copy_ms=copy_ms,
        batch_copy_gb_per_s={k: nb * 4 / v / 1e6 for k, v in copy_ms.items()},
        staged_vs_memory=dict(loss_diff=loss_d, param_diff=param_d,
                              loss=steps["staged"][0]),
        profile=prof)
    rec["etl_images_resnet50"] = res
    print(f"etl_images_resnet50: {c['n']} PNGs written in "
          f"{res['write_s']:.2f} s; decode+augment inline "
          f"{res['decode_images_per_s_per_worker']:.1f} images/s a worker; "
          f"streamed fit {len(tap.sizes)} steps {tap.sizes} in {fit_s:.2f} s "
          f"= {res['streamed_images_per_s']:.1f} images/s (4 workers, "
          f"pinned ring); in-memory fit {mem_s:.2f} s = "
          f"{res['in_memory_images_per_s']:.1f} images/s, "
          f"{res['in_memory_while_decoding_images_per_s']:.1f} images/s "
          f"while 4 workers decode; streamed: pool "
          f"start (4 forks) {res['pool_start_s']:.3f} s, first batch after "
          f"{tap.first_s:.3f} s, then {res['after_first_images_per_s']:.1f} "
          f"images/s with {tap.wait_s:.3f} s in the pool's calls "
          f"({res['staging_s']:.3f} s copying slots to pinned memory and "
          f"issuing the copies); H2D "
          f"{h2d_bytes / 1e6:.1f} MB (epoch {epoch_bytes / 1e6:.1f} MB), "
          f"{h2d_n} batches timed, "
          + (f"{res['h2d_mb_per_s']:.0f} MB/s (slot to pinned memcpy + "
             f"copy)" if res["h2d_mb_per_s"] else "rate not measured")
          + f"; one batch's copy pinned {copy_ms['pinned']:.3f} ms, "
          f"pageable {copy_ms['pageable']:.3f} ms"
          + f"; loss {loss:.5g}; peak {res['peak_gb']:.2f} GB; first "
          f"batch matches worker shard {matches}; staged vs in-memory step "
          f"loss |d| {loss_d:.3g}, params |d|max {param_d:.3g} "
          f"({ETL_STEP_TOL}); launches {counts}")
    if prof["device_busy_ms"] is not None:
        print(f"  profiled streamed step: wall {prof['wall_ms']:.2f} ms, "
              f"device busy {prof['device_busy_ms']:.2f} ms, idle share "
              f"{prof['idle_share']:.3f}, {prof['device_ops']} device ops")
        for kname, ms in prof["top"]:
            print(f"    {ms:9.3f} ms  {kname}")
    else:
        print("  profiled streamed step: no device time in the trace "
              "(not measured)")
    print(card)
    _require(n_seen == c["n"] and res["labels_exact"],
             f"{n_seen} images delivered, label histogram exact "
             f"{res['labels_exact']}")
    _require(res["on_card"], f"batches arrived on {set(tap.devices)}")
    _require(h2d_bytes == epoch_bytes,
             f"the staging ring moved {h2d_bytes} bytes, the epoch is "
             f"{epoch_bytes}")
    _require(len(matches) == 1, f"the first pooled batch matches inline "
             f"shards {matches}")
    _require(math.isfinite(loss), f"loss {loss}")
    _require(loss_d <= ETL_STEP_TOL["loss_rtol"] * abs(steps["staged"][0])
             and param_d <= ETL_STEP_TOL["param_atol"],
             f"a staged step differs from the in-memory step: loss "
             f"{loss_d}, params {param_d}")


def phase_etl_sequences(torch, rec, card):
    """Item 56: the long-context attention net (LONG_CONTEXT, BFLOAT16,
    nOut 1) fed by DataVec: 16 sequence CSV files through
    CSVSequenceRecordReader -> SequenceRecordReaderDataSetIterator(4,
    regression) -> MultiLayerNetwork.fit, which engages the pool (C22).
    The iterator attaches a features mask and masked attention runs dense
    in both packages, so the counters, zeroed before and read after, must
    read zero."""
    import math
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.datavec import (
        CSVSequenceRecordReader, FileSplit,
        SequenceRecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    c, lc = ETL_SEQ, LONG_CONTEXT
    prev = _fresh_telemetry()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            rng = np.random.RandomState(c["seed"])
            t0 = time.perf_counter()
            for i in range(c["files"]):
                x = rng.randn(lc["t"], lc["nIn"] + 1)
                np.savetxt(os.path.join(d, f"seq_{i:02d}.csv"), x,
                           fmt="%.4f", delimiter=",")
            write_s = time.perf_counter() - t0
            rr = CSVSequenceRecordReader()
            rr.initialize(FileSplit(d))
            it = SequenceRecordReaderDataSetIterator(
                rr, c["batch"], numPossibleLabels=-1, labelIndex=lc["nIn"],
                regression=True)
            net = MultiLayerNetwork(_long_context_conf("BFLOAT16",
                                                       n_out=1)).init()
            _require(net.device.type == "cuda", f"net on {net.device}")
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            net.fit(it, epochs=1)
            loss = net.score()
            fit_s = time.perf_counter() - t0
            counts = _counters()
            steps = net.getIterationCount()
            pooled = _etl_metric("dl4j_tpu_etl_pool_batches_total")
            pooled = pooled.value() if pooled else 0
    finally:
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    _no_launches(rec, "etl_sequences", counts)
    rec["etl_sequences"] = dict(files=c["files"], steps=steps, loss=loss,
                                fit_s=fit_s, ms_per_step=fit_s / steps * 1e3
                                if steps else None, write_s=write_s,
                                pool_batches=pooled, launches=counts)
    print(f"etl_sequences: {c['files']} files of {lc['t']} x "
          f"{lc['nIn'] + 1} (written in {write_s:.2f} s); fit {steps} steps "
          f"through the pool ({pooled:.0f} pool batches) in {fit_s:.2f} s, "
          f"{fit_s / max(steps, 1) * 1e3:.1f} ms a step with the parse, "
          f"loss {loss:.5g}; launches {counts} (masked: dense attention)")
    print(card)
    _require(steps == c["files"] // c["batch"] and pooled == steps,
             f"{steps} steps, {pooled} pool batches")
    _require(math.isfinite(loss), f"loss {loss}")


# ----------------------------------------------------------------------
# DataVec's format readers and the recommender tier (phases 57-59)
# ----------------------------------------------------------------------

class _FolderLabelled:
    """A file record reader of the port (``AudioFeatureRecordReader`` or
    ``CodecRecordReader``) over ``files``, each record (or each step of a
    sequence) followed by its parent folder's index in ``names`` — the
    label DL4J's ``ParentPathLabelGenerator`` gives images — and sharded
    by file for the producer pool's workers.  Built by ``make`` (a
    picklable factory), in this file so a forked worker finds it."""

    def __init__(self, make, files, names, sequence=False):
        self.make, self.files, self.names = make, list(files), names
        self.sequence = sequence
        self.inner = make()
        self.inner.initialize(_FileList(self.files))
        self._i = 0

    def _label(self):
        from deeplearning4j_tpu_torch.datavec import IntWritable
        path = self.files[self._i]
        self._i += 1
        return IntWritable(self.names.index(
            os.path.basename(os.path.dirname(path))))

    def hasNext(self):
        return self.inner.hasNext()

    def next(self):
        rec = self.inner.next()
        lab = self._label()
        if self.sequence:
            return [step + [lab] for step in rec]
        return rec + [lab]

    nextSequence = next

    def reset(self):
        self.inner.reset()
        self._i = 0

    def streaming(self):
        return True

    def shard(self, index, count):
        return _FolderLabelled(self.make, self.files[index::count],
                               self.names, self.sequence)


class _FileList:
    """An input split over a list of paths, in order."""

    def __init__(self, files):
        self.files = list(files)

    def locations(self):
        return list(self.files)


def _write_wav(path, x, rate, width=2, channels=1):
    """int samples ``x`` (frames x channels, or frames) as PCM."""
    import wave

    import numpy as np
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(np.asarray(x, dt).tobytes())


def _speech_folders(root, c):
    """``c["n"]`` seeded one-second 16 kHz 16-bit mono clips in
    ``c["classes"]`` label folders (Speech Commands' layout and clip
    shape): a tone whose pitch band is the label's, noise, a fade."""
    import numpy as np
    t = np.arange(c["rate"]) / c["rate"]
    names = [f"word{k:02d}" for k in range(c["classes"])]
    for n in names:
        os.makedirs(os.path.join(root, n), exist_ok=True)
    files = []
    for i in range(c["n"]):
        rng = np.random.RandomState(c["seed"] * 1000 + i)
        k = i % c["classes"]
        f0 = 200.0 + 150.0 * k + rng.rand() * 40
        x = np.sin(2 * np.pi * f0 * t) * np.hanning(len(t)) * 0.5 \
            + rng.randn(len(t)) * 0.05
        path = os.path.join(root, names[k], f"clip{i:04d}.wav")
        _write_wav(path, np.clip(x * 32767, -32768, 32767), c["rate"])
        files.append(path)
    return sorted(files), names


def _clip_folders(root, c):
    """``c["n"]`` seeded animated GIFs (``c["frames"]`` frames of
    ``c["hw"]`` square, one 64-colour global palette) in label folders,
    written with the port's GIF writer: a square moving across a noisy
    field, its direction the label."""
    import numpy as np
    from deeplearning4j_tpu_torch.datavec.gif import write_gif
    hw, T = c["hw"], c["frames"]
    names = [f"motion{k}" for k in range(c["classes"])]
    for n in names:
        os.makedirs(os.path.join(root, n), exist_ok=True)
    pal = np.random.RandomState(c["seed"]).randint(0, 256, (64, 3))
    files = []
    dirs = [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1), (1, -1),
            (-1, 1)]
    for i in range(c["n"]):
        rng = np.random.RandomState(c["seed"] * 1000 + i)
        k = i % c["classes"]
        dy, dx = dirs[k % len(dirs)]
        idx = rng.randint(0, 32, (T, hw, hw)).astype(np.uint8)
        y, x = rng.randint(16, hw - 16, 2)
        for f in range(T):
            yy, xx = (y + dy * 2 * f) % (hw - 8), (x + dx * 2 * f) % (hw - 8)
            idx[f, yy:yy + 8, xx:xx + 8] = 32 + k
        path = os.path.join(root, names[k], f"clip{i:03d}.gif")
        write_gif(path, idx, pal, disposal=1)
        files.append(path)
    return sorted(files), names


def phase_datavec_formats(torch, rec, card):
    """Item 57: the five format readers on the card's machine (no PIL, no
    pyarrow): each reads a seeded file the port wrote and the committed
    fixtures; then a Speech-Commands-shaped stream (MFCC 40 x 98 a clip)
    through the producer pool into an MLP's fit, and a clip stream (GIFs
    resized to 32 x 32, raveled) into a GravesLSTM's fit.  No launch."""
    import functools
    import json as _json
    import math
    import sqlite3
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.datavec import (
        ArrowConverter, ArrowRecordReader, AudioFeatureRecordReader,
        CodecRecordReader, ColumnarConverter, DoubleWritable,
        ExcelRecordReader,
        FileSplit, IntWritable, JDBCRecordReader, PrefetchingDataSetIterator,
        RecordReaderDataSetIterator, Schema,
        SequenceRecordReaderDataSetIterator, Text, WavFileRecordReader,
        read_wav, writeXlsx)
    from deeplearning4j_tpu_torch.datavec.arrowipc import read_ipc_file
    from deeplearning4j_tpu_torch.datavec.gif import read_gif
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.recurrent import (GravesLSTM,
                                                            RnnOutputLayer)
    c, res = DATAVEC_FORMATS, {}
    fx = os.path.join(ROOT, "tests", "fixtures")
    prev = _fresh_telemetry()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            # -- each reader on a seeded file the port wrote ------------
            t0 = time.perf_counter()
            rng = np.random.RandomState(c["seed"])
            rows = [["name", "count", "score"]] + [
                [f"r{i}", int(rng.randint(-99, 99)),
                 float(np.round(rng.rand(), 3))] for i in range(50)]
            writeXlsx(os.path.join(d, "t.xlsx"), rows)
            xr = ExcelRecordReader(skipNumLines=1).initialize(
                os.path.join(d, "t.xlsx"))
            got = [[w.value for w in r] for r in xr]
            _require(got == [r for r in rows[1:]], "xlsx records")
            db = os.path.join(d, "t.db")
            with sqlite3.connect(db) as conn:
                conn.execute("CREATE TABLE t (a INTEGER, b REAL, s TEXT)")
                conn.executemany("INSERT INTO t VALUES (?, ?, ?)",
                                 [(r[1], r[2], r[0]) for r in rows[1:]])
            jr = JDBCRecordReader("SELECT a, b, s FROM t ORDER BY rowid")
            jr.initialize(FileSplit(db))
            jrec = [[w.value for w in r] for r in jr]
            _require(jrec == [[r[1], r[2], r[0]] for r in rows[1:]],
                     "sqlite records")
            schema = (Schema.Builder().addColumnInteger("a")
                      .addColumnDouble("b").addColumnString("s").build())
            recs = [[IntWritable(r[1]), DoubleWritable(r[2]), Text(r[0])]
                    for r in rows[1:]]
            cols = ColumnarConverter.toColumnar(recs, schema)
            ColumnarConverter.save(os.path.join(d, "t.npz"), cols, schema)
            cols2, schema2 = ColumnarConverter.load(os.path.join(d, "t.npz"))
            back = ColumnarConverter.fromColumnar(cols2, schema2)
            _require([[w.value for w in r] for r in back]
                     == [[w.value for w in r] for r in recs], "columnar")
            for kind, path in (("feather", "t.feather"), ("ipc", "t.arrows")):
                p = os.path.join(d, path)
                if kind == "feather":
                    ArrowConverter.writeFeather(recs, schema, p)
                else:
                    ArrowConverter.writeIpcStream(recs, schema, p)
                ar = ArrowRecordReader().initialize(p)
                _require([[w.value for w in r] for r in ar]
                         == [[w.value for w in r] for r in recs],
                         f"arrow {kind} records")
            want = _json.load(open(os.path.join(fx, "arrow_lz4_records.json")))
            tab = read_ipc_file(os.path.join(fx, "arrow_lz4.feather"))
            _require(all(tab.column(col["name"]).to_pylist() == col["values"]
                         and str(tab.column(col["name"]).type) == col["type"]
                         for col in want), "the LZ4 feather fixture")
            frames = read_gif(os.path.join(fx, "gif_composited.gif"))
            _require(np.array_equal(frames, np.load(os.path.join(
                fx, "gif_composited_frames.npz"))["frames"]),
                "the composited GIF fixture against PIL's frames")
            x = (np.sin(np.arange(800) / 7.0) * 30000).astype(np.int64)
            for width, ch in ((1, 1), (2, 2), (4, 1)):
                scale = {1: 127, 2: 1, 4: 65536}[width]
                samples = x // (30000 // 127) + 128 if width == 1 \
                    else x * scale
                if ch == 2:
                    samples = np.repeat(samples, 2)
                _write_wav(os.path.join(d, f"w{width}{ch}.wav"), samples,
                           8000, width, ch)
                y, rate = read_wav(os.path.join(d, f"w{width}{ch}.wav"))
                _require(rate == 8000 and y.shape == (800,)
                         and np.abs(y).max() <= 1.0, f"wav {width} B")
            wr = WavFileRecordReader()
            wr.initialize(FileSplit(d))
            _require(sum(1 for _ in wr) == 3, "wav records")
            res["readers_s"] = time.perf_counter() - t0
            loaded = [m for m in ("PIL", "pyarrow") if m in sys.modules]
            _require(not loaded, f"the readers loaded {loaded}")

            # -- the Speech-Commands-shaped stream into an MLP ---------
            sc = c["speech"]
            t0 = time.perf_counter()
            files, names = _speech_folders(os.path.join(d, "speech"), sc)
            res["speech_write_s"] = time.perf_counter() - t0
            make = functools.partial(AudioFeatureRecordReader, "mfcc",
                                     numCoefficients=sc["mfcc"],
                                     frameLength=sc["frame"], hop=sc["hop"])
            rr = _FolderLabelled(make, files, names)
            t0 = time.perf_counter()
            probe = rr.shard(0, sc["workers"])
            n0 = 0
            while probe.hasNext():
                probe.next()
                n0 += 1
            res["speech_decode_clips_per_s_per_worker"] = \
                n0 / (time.perf_counter() - t0)
            feat = int(np.prod(probe.inner.featureShape))
            it = RecordReaderDataSetIterator(rr, sc["batch"], labelIndex=feat,
                                             numPossibleLabels=sc["classes"])
            conf = (NeuralNetConfiguration.builder().seed(c["seed"])
                    .updater(Adam(1e-3)).list()
                    .layer(DenseLayer.builder().nOut(sc["hidden"])
                           .activation("relu").build())
                    .layer(OutputLayer.builder("mcxent")
                           .nOut(sc["classes"]).activation("softmax")
                           .build())
                    .setInputType(InputType.feedForward(feat)).build())
            net = MultiLayerNetwork(conf).init()
            pit = PrefetchingDataSetIterator(it, numWorkers=sc["workers"],
                                             device="cuda")
            tap = _tap(pit)
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            net.fit(tap, epochs=1)
            loss = net.score()
            fit_s = time.perf_counter() - t0
            counts = _counters()
            pit.close()
            _no_launches(rec, "datavec_formats_speech", counts)
            res["speech"] = dict(clips=len(files), feature=list(
                probe.inner.featureShape), steps=net.getIterationCount(),
                loss=loss, fit_s=fit_s, clips_per_s=len(files) / fit_s,
                devices=sorted(set(tap.devices)), launches=counts)
            _require(sum(tap.sizes) == sc["n"] and set(tap.devices)
                     == {"cuda"}, f"speech batches {tap.sizes} "
                     f"{set(tap.devices)}")
            _require(math.isfinite(loss), f"speech loss {loss}")

            # -- the clip stream into a GravesLSTM ----------------------
            cc = c["clips"]
            t0 = time.perf_counter()
            files, names = _clip_folders(os.path.join(d, "clips"), cc)
            res["clips_write_s"] = time.perf_counter() - t0
            make = functools.partial(CodecRecordReader, ravel=True,
                                     outputHW=cc["outputHW"])
            rr = _FolderLabelled(make, files, names, sequence=True)
            t0 = time.perf_counter()
            probe = rr.shard(0, cc["workers"])
            n0 = 0
            while probe.hasNext():
                seq = probe.next()
                n0 += 1
            res["clips_decoded_per_s_per_worker"] = \
                n0 / (time.perf_counter() - t0)
            h, w = cc["outputHW"]
            _require(len(seq) == cc["frames"] and len(seq[0]) == h * w * 3
                     + 1, f"clip record {len(seq)} x {len(seq[0])}")
            it = SequenceRecordReaderDataSetIterator(
                rr, cc["batch"], numPossibleLabels=cc["classes"],
                labelIndex=h * w * 3)
            conf = (NeuralNetConfiguration.builder().seed(c["seed"])
                    .updater(Adam(1e-3)).list()
                    .layer(GravesLSTM.builder().nOut(cc["hidden"])
                           .activation("tanh").build())
                    .layer(RnnOutputLayer.builder("mcxent")
                           .nOut(cc["classes"]).activation("softmax")
                           .build())
                    .setInputType(InputType.recurrent(h * w * 3,
                                                      cc["frames"]))
                    .build())
            net = MultiLayerNetwork(conf).init()
            pit = PrefetchingDataSetIterator(it, numWorkers=cc["workers"],
                                             device="cuda")
            tap = _tap(pit)
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            net.fit(tap, epochs=1)
            loss = net.score()
            fit_s = time.perf_counter() - t0
            counts = _counters()
            pit.close()
            _no_launches(rec, "datavec_formats_clips", counts)
            res["clips"] = dict(clips=len(files), steps=net.getIterationCount(),
                                loss=loss, fit_s=fit_s,
                                clips_per_s=len(files) / fit_s,
                                launches=counts)
            _require(sum(tap.sizes) == cc["n"] and set(tap.devices)
                     == {"cuda"}, f"clip batches {tap.sizes}")
            _require(math.isfinite(loss), f"clip loss {loss}")
    finally:
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    rec["datavec_formats"] = res
    sp, cl = res["speech"], res["clips"]
    print(f"datavec_formats: xlsx, sqlite, columnar, feather/IPC (port "
          f"written + the LZ4 fixture), GIF fixture, 8/16/32-bit WAVs read "
          f"in {res['readers_s']:.2f} s with no PIL / pyarrow; speech "
          f"{sp['clips']} clips MFCC {sp['feature']}: decode "
          f"{res['speech_decode_clips_per_s_per_worker']:.1f} clips/s a "
          f"worker, fit {sp['steps']} steps in {sp['fit_s']:.2f} s "
          f"({sp['clips_per_s']:.1f} clips/s), loss {sp['loss']:.4g}; GIF "
          f"clips {cl['clips']} x {c['clips']['frames']} frames: decode "
          f"{res['clips_decoded_per_s_per_worker']:.1f} clips/s a worker, "
          f"fit {cl['steps']} steps in {cl['fit_s']:.2f} s, loss "
          f"{cl['loss']:.4g}; launches {sp['launches']} {cl['launches']}")
    print(card)


def _dlrm_records(c, n, seed):
    """``n`` seeded ragged records of ``c["fields"]`` bags, 1-16 raw ids a
    bag, Zipf-skewed over ``c["raw_values"]``, and a click label."""
    import numpy as np
    rng = np.random.RandomState(seed)
    F = c["fields"]
    lens = rng.randint(1, c["max_bag"] + 1, n * F)
    raw = rng.zipf(c["zipf"], int(lens.sum())) % c["raw_values"]
    raw = ((raw * 7919) % c["raw_values"]).tolist()   # spread the heavy ids
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    bags = [raw[a:b] for a, b in zip(starts, ends)]
    labels = rng.randint(0, 2, n).tolist()
    return [(tuple(bags[i * F:(i + 1) * F]), labels[i]) for i in range(n)]


def _dlrm_reader(c, records, rows):
    from deeplearning4j_tpu_torch.datavec.pipeline import RaggedFeatureReader
    return RaggedFeatureReader(records, c["batch"], rows, 2,
                               bagBuckets=(c["max_bag"],),
                               numFields=c["fields"])


def phase_dlrm_train(torch, rec, card):
    """Item 58: DLRM at MLPerf Training's DLRM widths that the zoo model
    expresses (26 fields x 128, head 1024-1024-512-256, 2 classes, Adam
    1e-3), 10M rows, trained for 8 batches of 2048 from seeded ragged
    records through RaggedFeatureReader -> the producer pool -> fit on
    cuda; the collision counter from an inline pass; one step at 65,536
    rows on the card against the CPU from the same params; ms a step,
    examples/s, peak memory and a profiled step.  No launch."""
    import math

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datavec import PrefetchingDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import DLRM
    c, res = DLRM_RUN, {}
    prev = _fresh_telemetry()
    try:
        t0 = time.perf_counter()
        records = _dlrm_records(c, c["batch"] * c["batches"], c["seed"])
        res["records_s"] = time.perf_counter() - t0
        # the collision estimator counts in the process that runs the
        # reader; the pool's workers run host-only and report nothing (as
        # the reference's do), so one batch is read inline here: the
        # ingest rate and the counter
        inline = _dlrm_reader(c, records[:c["batch"]], c["rows"])
        coll = _etl_metric("dl4j_tpu_recsys_hash_collisions_total")
        t0 = time.perf_counter()
        first = inline.next()
        res["ingest_ms_per_batch_inline"] = (time.perf_counter() - t0) * 1e3
        coll = _etl_metric("dl4j_tpu_recsys_hash_collisions_total")
        res["hash_collisions"] = coll.value() if coll else 0.0
        raw = _etl_metric("dl4j_tpu_recsys_lookup_rows_total")
        res["ids_raw"] = raw.value(phase="raw") if raw else 0.0
        res["ids_stored"] = raw.value(phase="stored") if raw else 0.0
        _require(res["hash_collisions"] > 0,
                 "the collision counter did not grow on Zipf ids over 1e9 "
                 "values into 10M rows")
        # the full-width net
        t0 = time.perf_counter()
        net = DLRM(numFields=c["fields"], embeddingDim=c["dim"],
                   denseUnits=c["dense"], numClasses=2,
                   numEmbeddings=c["rows"]).init()
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["params"] = sum(p.numel() for lp in net.params_.values()
                            for p in lp.values())
        _require(net.device.type == "cuda", f"net on {net.device}")
        pit = PrefetchingDataSetIterator(
            _dlrm_reader(c, records, c["rows"]), numWorkers=c["workers"],
            device="cuda", shmBytes=c["shm_mb"] << 20)
        tap = _tap(pit)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        net.fit(tap, epochs=1)
        loss = net.score()
        fit_s = time.perf_counter() - t0
        counts = _counters()
        pit.close()
        res.update(steps=net.getIterationCount(), loss=loss, fit_s=fit_s,
                   streamed_examples_per_s=sum(tap.sizes) / fit_s,
                   pool_wait_s=tap.wait_s, pool_first_s=tap.first_s,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=counts)
        _no_launches(rec, "dlrm_train", counts)
        _require(net.getIterationCount() == c["batches"]
                 and sum(tap.sizes) == c["batch"] * c["batches"]
                 and set(tap.devices) == {"cuda"},
                 f"{net.getIterationCount()} steps, batches {tap.sizes} on "
                 f"{set(tap.devices)}")
        _require(math.isfinite(loss), f"loss {loss}")
        # the step alone, from a batch already on the card
        ds = DataSet(first.features.torch.cuda(), first.labels.torch.cuda(),
                     featuresMask=first.featuresMask.torch.cuda())
        step_ms = _time_ms(torch, lambda: net.fit(ds), iters=8, warmup=1)
        res["ms_per_step"] = step_ms
        res["examples_per_s"] = c["batch"] / step_ms * 1e3
        res["profile"] = _device_breakdown(torch, lambda: net.fit(ds),
                                           top=8)
        del net, tap, pit
        torch.cuda.empty_cache()
        # one step at the same widths, 65,536 rows: card against CPU
        small = _dlrm_reader(c, records[:c["batch"]], c["check_rows"]).next()
        cpu = DLRM(numFields=c["fields"], embeddingDim=c["dim"],
                   denseUnits=c["dense"], numClasses=2,
                   numEmbeddings=c["check_rows"]).init(device="cpu")
        gpu = MultiLayerNetwork(cpu.conf).init(params={
            k: {n: t.clone() for n, t in lp.items()}
            for k, lp in cpu.params_.items()})
        cpu.fit(small)
        gpu.fit(DataSet(small.features.torch.cuda(),
                        small.labels.torch.cuda(),
                        featuresMask=small.featuresMask.torch.cuda()))
        lc, lg = cpu.score(), gpu.score()
        diffs = [(gp.cpu() - cpu.params_[k][n]).abs().reshape(-1)
                 for k, lp in gpu.params_.items() for n, gp in lp.items()]
        d = torch.cat(diffs)
        # the gradient itself, through Adam's first moment (0.1 g after
        # one step): each tensor's largest difference over its largest
        # entry (reported, not gated: a ReLU whose pre-activation lies
        # within float32 rounding of 0 passes one example's gradient on
        # one device and not on the other)
        grad_rel = {f"{k}/{n}": float((gs["m"].cpu() - cpu.optState_[k][n][
            "m"]).abs().max() / cpu.optState_[k][n]["m"].abs().max())
            for k, lp in gpu.optState_.items() for n, gs in lp.items()}
        res["card_vs_cpu"] = dict(
            loss_rel=abs(lc - lg) / abs(lc), param_max=float(d.max()),
            share_1e6=float((d <= 1e-6).float().mean()),
            share_1e5=float((d <= 1e-5).float().mean()),
            grad_rel=max(grad_rel.values()), grad_rel_by_param=grad_rel)
        del cpu, gpu, d, diffs
    finally:
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    rec["dlrm_train"] = res
    cv = res["card_vs_cpu"]
    print(f"dlrm_train: DLRM {c['fields']} x {c['dim']}, head {c['dense']}, "
          f"{c['rows']:,} rows ({res['params']:,} params, init "
          f"{res['init_s']:.1f} s); {res['steps']} batches of {c['batch']} "
          f"from {len(records)} ragged records through the pool in "
          f"{res['fit_s']:.2f} s ({res['streamed_examples_per_s']:.0f} "
          f"examples/s streamed), loss {res['loss']:.5g}; {res['ms_per_step']:.1f} "
          f"ms a step from the card ({res['examples_per_s']:.0f} examples/s), "
          f"peak {res['peak_gb']:.1f} GB; inline ingest "
          f"{res['ingest_ms_per_batch_inline']:.0f} ms a batch, "
          f"{res['ids_raw']:.0f} ids -> {res['ids_stored']:.0f} stored, "
          f"{res['hash_collisions']:.0f} collisions witnessed; profiled step "
          f"idle {res['profile']['idle_share']}; card vs CPU at "
          f"{c['check_rows']} rows: loss {cv['loss_rel']:.2e} rel, gradient "
          f"{cv['grad_rel']:.2e} of its largest ("
          + ", ".join(f"{k} {v:.1e}" for k, v in
                      cv["grad_rel_by_param"].items()) + "), params max "
          f"{cv['param_max']:.2e} ({cv['share_1e5']:.4f} within 1e-5, "
          f"{cv['share_1e6']:.4f} within 1e-6); "
          f"launches {res['launches']}")
    for name, ms in res["profile"]["top"]:
        print(f"    {ms:9.3f} ms  {name[:90]}")
    print(card)
    _require(cv["loss_rel"] <= DLRM_STEP_TOL["loss_rtol"]
             and cv["param_max"] <= 2 * DLRM_RUN["lr"] + 1e-6
             and cv["share_1e5"] >= DLRM_STEP_TOL["share"],
             f"the card's step departs from the CPU's: {cv}")


def phase_retrieval_serve(torch, rec, card):
    """Item 59: a two-tower net (1,048,576 rows x 64, bags of 16) trained
    for a few batches from a two-field ragged stream, served as
    ``RetrievalLM.from_two_tower`` under ``ContinuousBatcher``:
    ``topk_retrieve`` for 256 users against the flat ranking, k = 1
    requests retire at admission (no decode step; no shed under a
    page-deficit admission rule), the collision rule fires on a colliding
    stream; requests/s and top-k latency p50/p99.  No launch."""
    import math

    import numpy as np
    from deeplearning4j_tpu_torch.datavec import PrefetchingDataSetIterator
    from deeplearning4j_tpu_torch.datavec.pipeline import (RaggedFeatureReader,
                                                          hash_feature)
    from deeplearning4j_tpu_torch.models.recsys import (RetrievalLM,
                                                        topk_retrieve)
    from deeplearning4j_tpu_torch.remote import (AdmissionControl,
                                                 BucketLadder,
                                                 ContinuousBatcher,
                                                 ServiceOverloaded)
    from deeplearning4j_tpu_torch.telemetry import (HealthMonitor,
                                                    recsys_hash_collision_rule)
    from deeplearning4j_tpu_torch.zoo import TwoTowerRecommender
    c, res = RETRIEVAL, {}
    prev = _fresh_telemetry()
    cbs = []
    try:
        rng = np.random.RandomState(c["seed"])
        n = c["batch"] * c["batches"]
        recs = []
        for i in range(n):
            u = rng.randint(0, 10 ** 9, rng.randint(1, c["bag"] + 1))
            v = rng.randint(0, 10 ** 9, rng.randint(1, c["bag"] + 1))
            recs.append(((u.tolist(), v.tolist()), 0))     # clicks
        net = TwoTowerRecommender(numEmbeddings=c["rows"],
                                  embeddingDim=c["dim"],
                                  bagSize=c["bag"]).init()
        pit = PrefetchingDataSetIterator(
            RaggedFeatureReader(recs, c["batch"], c["rows"], 1,
                                bagBuckets=(c["bag"],), numFields=2),
            numWorkers=2, device="cuda")
        _reset_counters()
        t0 = time.perf_counter()
        net.fit(pit, epochs=1)
        pit.close()
        res["train_s"] = time.perf_counter() - t0
        res["train_loss"] = net.score()
        _require(math.isfinite(res["train_loss"]) and
                 net.getIterationCount() == c["batches"],
                 f"two-tower fit: {net.getIterationCount()} steps, loss "
                 f"{res['train_loss']}")
        lm = RetrievalLM.from_two_tower(net, maxLen=c["maxLen"])
        cb = ContinuousBatcher(lm, name="recsys", pageSize=c["page"],
                               maxSlots=c["slots"],
                               ladder=BucketLadder(batchSizes=(c["slots"],),
                                                   seqLens=(c["bag"],)))
        cbs.append(cb)
        res["warm_s"] = cb.warm()
        cb.start()
        users = [hash_feature(rng.randint(0, 10 ** 9, rng.randint(
            1, c["bag"] + 1)), c["rows"]).astype(np.int32)
            for _ in range(c["users"])]
        lat = [None] * len(users)
        outs = [None] * len(users)

        def one(i):
            t1 = time.perf_counter()
            outs[i] = topk_retrieve(cb, users[i][None, :], c["k"],
                                    timeout=600)[0]
            lat[i] = time.perf_counter() - t1

        t0 = time.perf_counter()
        _parallel(one, list(range(len(users))))
        wall = time.perf_counter() - t0
        counts = _counters()
        res.update(requests=len(users), wall_s=wall,
                   requests_per_s=len(users) / wall,
                   p50_ms=float(np.percentile(lat, 50)) * 1e3,
                   p99_ms=float(np.percentile(lat, 99)) * 1e3)
        # the flat ranking in float64 on the host, from the served table
        W = lm.params["items"].double().cpu().numpy()
        compared = mismatched = 0
        for u, got in zip(users, outs):
            q = W[u].mean(0)
            s = W @ q
            top = np.argpartition(-s, c["k"] + 1)[:c["k"] + 1]
            order = top[np.lexsort((top, -s[top]))]
            for r in range(c["k"]):
                if s[order[r]] - s[order[r + 1]] < \
                        RETRIEVAL_NEAR_TIE * abs(s[order[0]]):
                    break                   # a near tie: order is noise
                compared += 1
                if int(got[r]) != int(order[r]):
                    mismatched += 1
                    break
        res.update(ranks_compared=compared, mismatched=mismatched)
        # k = 1: emitted at admission, no decode step
        steps0 = cb._steps
        one_out = [topk_retrieve(cb, u[None, :], 1, timeout=600)[0, 0]
                   for u in users[:c["single"]]]
        res["k1_decode_steps"] = cb._steps - steps0
        res["k1_equal_rank1"] = all(int(a) == int(o[0]) for a, o in
                                    zip(one_out, outs))
        shed = ContinuousBatcher(
            lm, name="recsys_shed", pageSize=c["page"], maxSlots=2,
            ladder=BucketLadder(batchSizes=(2,), seqLens=(c["bag"],)),
            admission=AdmissionControl(minFreePages=10 ** 9,
                                       retryAfter=0.1))
        cbs.append(shed)
        shed.start()
        try:
            shed.submit({"tokens": users[0].tolist(),
                         "maxNewTokens": c["k"]}, timeout=600)
            res["k_shed"] = False
        except ServiceOverloaded:
            res["k_shed"] = True
        res["k1_admitted_under_deficit"] = int(shed.submit(
            {"tokens": users[0].tolist(), "maxNewTokens": 1},
            timeout=600)[0, 0]) == int(outs[0][0])
        counts2 = _counters()
        _no_launches(rec, "retrieval_serve", {k: counts[k] + counts2[k]
                                               for k in counts})
        # the hash-collision alert on a colliding stream
        r = RaggedFeatureReader([([i], 0) for i in range(64)], 16, 3, 1,
                                collisionSampleEvery=1)
        while r.hasNext():
            r.next()
        mon = HealthMonitor(rules=[recsys_hash_collision_rule()],
                            interval=3600)
        res["collision_rule_fired"] = \
            "recsys_hash_collision" in mon.evaluate_once(now=0.0)
        hist = _etl_metric("dl4j_tpu_recsys_topk_latency_seconds")
        res["latency_observed"] = hist.count() if hist else 0
    finally:
        for b in cbs:
            b.shutdown()
        from deeplearning4j_tpu_torch import telemetry
        telemetry.set_registry(prev)
    rec["retrieval_serve"] = res
    print(f"retrieval_serve: two-tower {c['rows']:,} x {c['dim']} trained "
          f"{c['batches']} batches in {res['train_s']:.2f} s (loss "
          f"{res['train_loss']:.4g}); {res['requests']} top-{c['k']} "
          f"requests through the batcher ({c['slots']} slots) in "
          f"{res['wall_s']:.2f} s: {res['requests_per_s']:.1f} requests/s, "
          f"p50 {res['p50_ms']:.1f} ms, p99 {res['p99_ms']:.1f} ms; "
          f"{res['ranks_compared']} ranks against the flat ranking, "
          f"{res['mismatched']} apart; k=1: {res['k1_decode_steps']} decode "
          f"steps, admitted under a page deficit "
          f"{res['k1_admitted_under_deficit']} (k={c['k']} shed "
          f"{res['k_shed']}); collision rule fired "
          f"{res['collision_rule_fired']}")
    print(card)
    _require(res["mismatched"] == 0 and res["ranks_compared"] >=
             0.99 * c["users"] * c["k"],
             f"top-k against the flat ranking: {res['ranks_compared']} "
             f"compared, {res['mismatched']} apart")
    _require(res["k1_decode_steps"] == 0 and res["k1_equal_rank1"],
             f"k=1 requests ran {res['k1_decode_steps']} decode steps")
    _require(res["k_shed"] and res["k1_admitted_under_deficit"],
             "single-step retrieval under a page deficit")
    _require(res["collision_rule_fired"], "the collision rule did not fire")
    _require(res["latency_observed"] >= c["users"] + c["single"],
             f"top-k latency observed {res['latency_observed']} times")


def _sd_char_vars(n_chars, hidden, seed):
    """The SameDiff char model's variables as seeded numpy: XAVIER-scaled
    weights, zero biases (lstmLayer packs the gates i, f, g, o)."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def w(a, b):
        return (rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(np.float32)
    h = hidden
    return {"W1": w(n_chars + h, 4 * h), "b1": np.zeros(4 * h, np.float32),
            "W2": w(2 * h, 4 * h), "b2": np.zeros(4 * h, np.float32),
            "Wo": w(h, n_chars), "bo": np.zeros(n_chars, np.float32)}


def _sd_char_start(sd, v, n_chars, hidden):
    """Placeholders ``x`` / ``y`` (t, b, nChars, time-major), the
    variables, and zero initial states shaped from x's batch."""
    import numpy as np
    x, y = sd.placeholder("x"), sd.placeholder("y")
    w = {k: sd.var(k, a) for k, a in v.items()}
    z = sd.constant(np.zeros((n_chars, hidden), np.float32), name="z")
    h0 = sd._op("readList", [x], {"index": 0}) @ z
    return x, y, w, h0


def _sd_char_head(sd, y, w, hs):
    logits = sd._op("add", [hs @ w["Wo"], w["bo"]], name="logits")
    sd.loss().softmaxCrossEntropy(y, logits, name="loss")
    return logits


def _sd_char_graph(sd, v, n_chars, hidden):
    """The char model on ``sd`` (either package's SameDiff): two
    ``rnn().lstmLayer`` and a dense softmax, the loss marked.  Returns the
    output names (loss, logits, second layer's states)."""
    x, y, w, h0 = _sd_char_start(sd, v, n_chars, hidden)
    hs1 = sd.rnn().lstmLayer(x, h0, h0, w["W1"], w["b1"], name="hs1")
    hs2 = sd.rnn().lstmLayer(hs1, h0, h0, w["W2"], w["b2"], name="hs2")
    _sd_char_head(sd, y, w, hs2)
    return ["loss", "logits", "hs2"]


def _sd_char_forloop(sd, v, n_chars, hidden, t):
    """The same forward by ``forLoop`` over two ``lstmCell``s: each step
    reads x[i] by ``gather`` and writes h2 into row i of a (t, b, hidden)
    buffer through a one-hot; the weights ride along as loop variables
    (a region sees only its inputs)."""
    import numpy as np
    x, y, w, h0 = _sd_char_start(sd, v, n_chars, hidden)
    buf0 = sd._op("zerosLike", [sd._op("stack", [h0] * t, {"axis": 0})])
    i0 = sd.constant(np.float32(0.0), name="i0")

    def body(s, lv):
        i, h1, c1, h2, c2, buf, xs, W1, b1, W2, b2 = lv
        ii = i.castTo("int32")
        xt = s.gather(xs, ii, axis=0)
        h1n, c1n = s.rnn().lstmCell(xt, h1, c1, W1, b1)
        h2n, c2n = s.rnn().lstmCell(h1n, h2, c2, W2, b2)
        # the reference's one-hot is float64 (x64): cast, or the loop's
        # carry would change dtype
        row = s._op("reshape", [s.oneHot(ii, t).castTo("float32")],
                    {"shape": (t, 1, 1)})
        buf = buf + row * s._op("expandDims", [h2n], {"axis": 0})
        return [i + 1.0, h1n, c1n, h2n, c2n, buf, xs, W1, b1, W2, b2]
    out = sd.forLoop(t, [i0, h0, h0, h0, h0, buf0, x, w["W1"], w["b1"],
                         w["W2"], w["b2"]], body, name="steps")
    hs = sd._op("identity", [out[5]], name="hs2")
    _sd_char_head(sd, y, w, hs)
    return ["loss", "logits", "hs2"]


def _sd_char_sampler(sd, v, n_chars, hidden, n, primer):
    """Greedy sampling of ``n`` characters for each row of ``primer`` (a
    (P, rows, nChars) one-hot) by ``whileLoop``: the body runs the two
    ``lstmCell``s, the softmax and the argmax, records each step's
    character and its top-two logit gap, and an ``ifCond`` feeds the next
    primer character while the primer lasts, else the sample.  Returns the
    names of the (n, rows) characters and gaps."""
    import numpy as np
    w = {k: sd.var(k, a) for k, a in v.items()}
    pr = sd.constant(primer, name="primer")
    rows, p_len = primer.shape[1], primer.shape[0]
    zero = sd.constant(np.zeros((rows, hidden), np.float32), name="zero")
    chars0 = sd.constant(np.zeros((n, rows), np.float32), name="chars0")
    x0 = sd._op("readList", [pr], {"index": 0})
    i0 = sd.constant(np.float32(0.0), name="i0")

    def cond(s, lv):
        return lv[0].lt(float(n))

    def body(s, lv):
        (i, h1, c1, h2, c2, xc, chars, gaps, prm, W1, b1, W2, b2, Wo,
         bo) = lv
        h1n, c1n = s.rnn().lstmCell(xc, h1, c1, W1, b1)
        h2n, c2n = s.rnn().lstmCell(h1n, h2, c2, W2, b2)
        logits = s._op("add", [h2n @ Wo, bo])
        prob = s.nn().softmax(logits)
        nxt = prob.argmax(1)
        top = s._op("topK", [logits], {"k": 2}, n_out=2)[0]
        gap = s._op("sub", [s._op("readList", [s._op("permute", [top],
                                                      {"dims": (1, 0)})],
                                  {"index": 0}),
                            s._op("readList", [s._op("permute", [top],
                                                      {"dims": (1, 0)})],
                                  {"index": 1})])
        ii = i.castTo("int32")
        row = s._op("reshape", [s.oneHot(ii, n).castTo("float32")],
                    {"shape": (n, 1)})
        chars = chars + row * s._op("reshape", [nxt.castTo("float32")],
                                    {"shape": (1, rows)})
        gaps = gaps + row * s._op("reshape", [gap], {"shape": (1, rows)})
        sample = s.oneHot(nxt, n_chars).castTo("float32")
        xn = s.ifCond(
            [i, sample, prm], lambda t, u: u[0].lt(float(p_len - 1)),
            lambda t, u: [t.gather(u[2], (u[0] + 1.0).castTo("int32"),
                                   axis=0)],
            lambda t, u: [u[1]])[0]
        return [i + 1.0, h1n, c1n, h2n, c2n, xn, chars, gaps, prm, W1, b1,
                W2, b2, Wo, bo]
    out = sd.whileLoop([i0, zero, zero, zero, zero, x0, chars0, chars0, pr,
                        w["W1"], w["b1"], w["W2"], w["b2"], w["Wo"],
                        w["bo"]], cond, body, name="sample")
    sd._op("identity", [out[6]], name="chars")
    sd._op("identity", [out[7]], name="gaps")
    return ["chars", "gaps"]


def _sd_char_data(n_chars_text, c, seed):
    """One-hot (t, b, nChars) input and next-character labels from
    CHAR_TEXT at seeded offsets, the vocabulary, and the primers'
    one-hot (P, rows, nChars)."""
    import numpy as np
    text = n_chars_text
    vocab = sorted(set(text))
    idx = {ch: i for i, ch in enumerate(vocab)}
    codes = np.array([idx[ch] for ch in text], np.int64)
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, len(codes) - c["length"] - 1, c["batch"])
    seq = np.stack([codes[s:s + c["length"] + 1] for s in starts], 1)
    eye = np.eye(len(vocab), dtype=np.float32)
    x, y = eye[seq[:-1]], eye[seq[1:]]
    prim = np.stack([codes[s:s + c["primer"]] for s in starts[:c["rows"]]],
                    1)
    return x, y, vocab, eye[prim]


def _share_close(torch, a, b, rtol, atol):
    """(share of elements of tensor dicts ``a`` / ``b`` within
    atol + rtol·|b|, their largest absolute difference)."""
    d = torch.cat([(a[k].float().cpu() - b[k].float().cpu()).abs()
                   .reshape(-1) for k in a])
    ref = torch.cat([b[k].float().cpu().abs().reshape(-1) for k in a])
    return float((d <= atol + rtol * ref).float().mean()), float(d.max())


def phase_samediff_ops(torch, rec, card):
    """Item 60: every case of autodiff/op_cases.py (the 240 ops of the
    control-flow slice) on the card against the same one-op graph on the
    CPU, held as each case says.  No launch."""
    import numpy as np

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.autodiff.op_cases import (CASES,
                                                            build_case,
                                                            compare)

    def run(case, device):
        sd = SameDiff.create(device)
        names = build_case(sd, case)
        out = sd.output(case.feeds(), *names)
        return [o.detach().cpu().numpy() for o in (out[n] for n in names)]
    _reset_counters()
    times, bad, ops = {}, [], set()
    for case in CASES:
        want = run(case, "cpu")
        first = run(case, "cuda")   # warm (a first launch loads its module)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(case, "cuda")
        torch.cuda.synchronize()
        times[case.id] = (time.perf_counter() - t0) * 1e3
        err = compare(case, got, want)
        if err is None and case.check in ("random", "shuffle", "crop"):
            # seeded per node on the card's generator: each run draws the
            # same values (its moments were held against the CPU's draw)
            err = None if all(np.array_equal(g, w) for g, w in
                              zip(got, first)) else "draw not repeated"
        if err:
            bad.append((case.id, err))
        ops.add(case.op)
    counts = _counters()
    slow = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    rec["samediff_ops"] = dict(cases=len(CASES), ops=len(ops),
                               passed=len(CASES) - len(bad), failed=bad,
                               slowest_ms=slow, launches=counts)
    print(f"samediff_ops: {len(CASES) - len(bad)} of {len(CASES)} cases "
          f"({len(ops)} ops) on the card hold to the CPU; slowest graphs "
          f"(build + run, ms): " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in slow)
          + f"; {card}")
    _no_launches(rec, "samediff_ops", counts)
    _require(len(ops) == 240 and not bad, f"the card departs: {bad}")


def _sd_char_sets(c, n):
    """``n`` seeded (x, y) batches of the char model and the vocabulary,
    primers from the first."""
    sets = [_sd_char_data(CHAR_TEXT, c, c["seed"] + i) for i in range(n)]
    return [(x, y) for x, y, _, _ in sets], sets[0][2], sets[0][3]


def phase_samediff_control_flow(torch, rec, card):
    """Item 61 (Path 2): the char model as a SameDiff graph at CHAR_RNN's
    widths, 8 iterations of SameDiff.fit; one step on the card against the
    CPU; forLoop's states against lstmLayer's and a step through it;
    RNN_SAMPLE characters sampled by whileLoop (card = CPU, or a near tie
    where they part); the sampler's zip restored bit for bit.  No
    launch."""
    import math
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Adam
    c = SD_CHAR
    h = c["hidden"]
    batches, vocab, primer = _sd_char_sets(c, c["iters"])
    nc = len(vocab)
    v = _sd_char_vars(nc, h, c["seed"])
    cfg = lambda: TrainingConfig(updater=Adam(c["lr"]),  # noqa: E731
                                 dataSetFeatureMapping=["x"],
                                 dataSetLabelMapping=["y"])
    res = {}
    _reset_counters()
    sd = SameDiff.create()
    _sd_char_graph(sd, v, nc, h)
    _require(sd.device.type == "cuda", f"graph on {sd.device}")
    sd.setTrainingConfig(cfg())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = sd.fit([DataSet(x, y) for x, y in batches], epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    curve = hist.lossCurve()
    _require(sd.iterationCount == c["iters"] and
             all(math.isfinite(l) for l in curve),
             f"{sd.iterationCount} iterations, losses {curve}")
    res["iterations"] = sd.iterationCount
    x0, y0 = batches[0]
    ds = DataSet(torch.tensor(x0).cuda(), torch.tensor(y0).cuda())
    ms = _time_ms(torch, lambda: sd.fit(ds), iters=5, warmup=1)
    res.update(loss_first=curve[0], loss_last=curve[-1], fit_s=fit_s,
               ms_per_iteration=ms,
               chars_per_s=c["batch"] * c["length"] / ms * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    cost = sd.stepCostAnalysis(ds)
    res["step_cost"] = cost
    del sd
    # one step on the card against the CPU from the same variables
    steps = {}
    for dev in ("cuda", "cpu"):
        g = SameDiff.create(dev)
        _sd_char_graph(g, v, nc, h)
        g.setTrainingConfig(cfg())
        loss = g.fit(DataSet(x0, y0)).lossCurve()[0]
        steps[dev] = (loss, {k: g._arrays[k] for k in v})
    (lg, vg), (lc, vc) = steps["cuda"], steps["cpu"]
    share, dmax = _share_close(torch, vg, vc, SD_STEP_RTOL, SD_STEP_ATOL)
    res["card_vs_cpu"] = dict(loss_rel=abs(lg - lc) / abs(lc), share=share,
                              max_abs=dmax)
    # forLoop over lstmCell: the same states; one step through it
    fl = SameDiff.create()
    _sd_char_forloop(fl, v, nc, h, c["length"])
    ly = SameDiff.create()
    _sd_char_graph(ly, v, nc, h)
    hs_for = fl.output({"x": x0, "y": y0}, "hs2")["hs2"]
    hs_layer = ly.output({"x": x0, "y": y0}, "hs2")["hs2"]
    res["forloop_max_abs"] = float((hs_for - hs_layer).abs().max())
    fl.setTrainingConfig(cfg())
    ly.setTrainingConfig(cfg())
    lf = fl.fit(DataSet(x0, y0)).lossCurve()[0]
    ll = ly.fit(DataSet(x0, y0)).lossCurve()[0]
    fshare, fmax = _share_close(torch, {k: fl._arrays[k] for k in v},
                                {k: ly._arrays[k] for k in v}, SD_STEP_RTOL,
                                SD_STEP_ATOL)
    res["forloop_step"] = dict(loss_rel=abs(lf - ll) / abs(ll),
                               share=fshare, max_abs=fmax)
    del fl, ly
    # greedy sampling by whileLoop: the card against the CPU
    samples = {}
    for dev in ("cuda", "cpu"):
        s = SameDiff.create(dev)
        names = _sd_char_sampler(s, v, nc, h, RNN_SAMPLE, primer)
        if dev == "cuda":
            s.output({}, *names)            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = s.output({}, *names)
        if dev == "cuda":
            torch.cuda.synchronize()
            res["sample_s"] = time.perf_counter() - t0
            sampler = s
        samples[dev] = {k: out[k].cpu() for k in names}
    cg, cc = samples["cuda"]["chars"], samples["cpu"]["chars"]
    parted = (cg != cc).nonzero()
    if len(parted):
        step = int(parted[:, 0].min())
        rows = parted[parted[:, 0] == step][:, 1]
        gap = float(samples["cpu"]["gaps"][step, rows].max())
        res["sample_parting"] = dict(step=step, top_two_gap=gap)
    res["sample_chars_per_s"] = RNN_SAMPLE * c["rows"] / res["sample_s"]
    res["sample_text"] = ["".join(vocab[int(i)] for i in cg[:, r])
                          for r in range(c["rows"])]
    # the sampler's zip (two levels of regions) restored on the card
    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".chip_sd_")
    try:
        path = os.path.join(tmp, "sampler.sdz")
        sampler.save(path)
        back = SameDiff.load(path)
        out = back.output({}, "chars", "gaps")
        res["zip_bit_identical"] = bool(
            torch.equal(out["chars"].cpu(), cg)
            and torch.equal(out["gaps"].cpu(), samples["cuda"]["gaps"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _counters()
    res["launches"] = counts
    rec["samediff_control_flow"] = res
    cv, fs = res["card_vs_cpu"], res["forloop_step"]
    print(f"samediff_control_flow: char model as a SameDiff graph "
          f"(2 x lstmLayer({h}), {nc} characters, batch {c['batch']} x "
          f"{c['length']}, Adam {c['lr']}), {res['iterations']} "
          f"iterations in {fit_s:.2f} s, loss {curve[0]:.4f} -> "
          f"{curve[-1]:.4f}; {ms:.1f} ms an iteration "
          f"({res['chars_per_s']:.0f} characters/s), peak "
          f"{res['peak_gb']:.3f} GB; step cost {cost['flops']:.4g} FLOPs, "
          f"{cost['bytes']:.4g} bytes unfused; card vs CPU: loss "
          f"{cv['loss_rel']:.2e} rel, {cv['share']:.5f} of variables within "
          f"rtol {SD_STEP_RTOL} + atol {SD_STEP_ATOL} (max "
          f"{cv['max_abs']:.2e}); forLoop states "
          f"{res['forloop_max_abs']:.2e} from lstmLayer's, its step loss "
          f"{fs['loss_rel']:.2e} rel, {fs['share']:.5f} within rtol; "
          f"whileLoop sampling {RNN_SAMPLE} x {c['rows']} characters in "
          f"{res['sample_s']:.3f} s ({res['sample_chars_per_s']:.0f} "
          f"characters/s), parting {res.get('sample_parting')}; zip "
          f"bit-identical {res['zip_bit_identical']}; {card}")
    for t in res["sample_text"]:
        print(f"    sample: {t!r}")
    _no_launches(rec, "samediff_control_flow", counts)
    _require(cv["loss_rel"] <= SD_STEP_RTOL and cv["share"] == 1.0,
             f"the card's step departs from the CPU's: {cv}")
    _require(res["forloop_max_abs"] <= SD_FORLOOP_ATOL
             and fs["loss_rel"] <= SD_STEP_RTOL and fs["share"] == 1.0,
             f"forLoop departs from lstmLayer: {res['forloop_max_abs']}, "
             f"{fs}")
    _require(res["zip_bit_identical"], "the restored sampler differs")
    if "sample_parting" in res:
        _require(res["sample_parting"]["top_two_gap"] <= SD_SAMPLE_NEAR_TIE,
                 f"the card's sample parts from the CPU's without a near "
                 f"tie: {res['sample_parting']}")


def _srgan_images(c, n, seed):
    """``n`` seeded smooth HR images (a few low-frequency sinusoids a
    channel) and their 4 x 4 average-pooled LR, both in [-1, 1]."""
    import numpy as np
    _, lh, lw = c["inputShape"]
    r = c["upscale"]
    hh, ww = lh * r, lw * r
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hh), np.linspace(0, 1, ww),
                         indexing="ij")
    hr = np.zeros((n, 3, hh, ww), np.float32)
    for i in range(n):
        for ch in range(3):
            f = rng.uniform(0.5, 4.0, (4, 2))
            ph = rng.uniform(0, 2 * np.pi, 4)
            hr[i, ch] = sum(np.sin(2 * np.pi * (a * xx + b * yy) + p)
                            for (a, b), p in zip(f, ph))
    hr /= np.abs(hr).max(axis=(2, 3), keepdims=True)
    lr = hr.reshape(n, 3, lh, r, lw, r).mean(axis=(3, 5))
    return lr.astype(np.float32), hr


def phase_srgan_train(torch, rec, card):
    """Item 62 (Path 1): SRGAN at SRResNet's widths (16 blocks, 24 -> 96,
    batch 16, Adam 1e-4) trained 8 steps by ComputationGraph.fit, its
    discriminator 8 steps by MultiLayerNetwork.fit on HR (1) and the
    generator's outputs (0); ms a step, images/s, peak, 2 profiled steps;
    one generator step on the card against the CPU; the generator's
    ModelSerializer zip restored bit for bit.  No launch."""
    import json
    import math
    import shutil
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import SRGAN
    c = SRGAN_RUN
    b, res = c["batch"], {}
    lr_img, hr_img = _srgan_images(c, b * c["steps"], c["seed"])
    zoo = SRGAN(inputShape=c["inputShape"],
                numResidualBlocks=c["blocks"], upscaleFactor=c["upscale"])
    _reset_counters()
    g = zoo.init()
    _require(g.device.type == "cuda", f"generator on {g.device}")
    res["params"] = g.numParams()
    it = ListDataSetIterator([DataSet(lr_img[i * b:(i + 1) * b],
                                      hr_img[i * b:(i + 1) * b])
                              for i in range(c["steps"])], batch=b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g.fit(it, epochs=1)
    loss = g.score()
    torch.cuda.synchronize()
    res["fit_s"] = time.perf_counter() - t0
    _require(g.iterationCount == c["steps"] and math.isfinite(loss),
             f"{g.iterationCount} steps, loss {loss}")
    res["loss"] = loss
    ds = DataSet(torch.tensor(lr_img[:b]).cuda(),
                 torch.tensor(hr_img[:b]).cuda())
    ms = _time_ms(torch, lambda: (g.fit(ds), g.score()), iters=5, warmup=1)
    res.update(ms_per_step=ms, images_per_s=b / ms * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = _device_breakdown(torch, lambda: [(g.fit(ds), g.score())
                                             for _ in range(c["profiled"])],
                             top=10)
    res["profile"] = prof
    # the discriminator: HR labelled 1, the generator's outputs 0
    d = zoo.initDiscriminator()
    ones = np.ones((b, 1), np.float32)
    t0 = time.perf_counter()
    for i in range(c["steps"]):
        sr = g.output(lr_img[i * b:(i + 1) * b]).torch
        x = torch.cat([torch.tensor(hr_img[i * b:(i + 1) * b]).cuda(), sr])
        y = torch.tensor(np.concatenate([ones, 0 * ones])).cuda()
        d.fit(DataSet(x, y))
    dloss = d.score()
    torch.cuda.synchronize()
    res.update(disc_s=time.perf_counter() - t0, disc_loss=dloss,
               disc_steps=d.iterationCount)
    _require(d.iterationCount == c["steps"] and math.isfinite(dloss),
             f"discriminator: {d.iterationCount} steps, loss {dloss}")
    # the generator's zip, PixelShuffleLayer in its JSON, bit for bit
    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".chip_srgan_")
    try:
        path = os.path.join(tmp, "srgan.zip")
        ModelSerializer.writeModel(g, path, saveUpdater=True)
        back = ModelSerializer.restoreComputationGraph(path)
        res["zip_bit_identical"] = bool(torch.equal(
            back.output(lr_img[:2]).torch, g.output(lr_img[:2]).torch))
        res["json_has_pixel_shuffle"] = "PixelShuffleLayer" in \
            json.dumps(json.loads(back.conf.toJson()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = _counters()
    del g, d, back
    torch.cuda.empty_cache()
    # one generator step, card against CPU, at full width and batch 2
    cpu = zoo.init(device="cpu")
    gpu = ComputationGraph(cpu.conf).init(params={
        k: {n: t.clone() for n, t in lp.items()}
        for k, lp in cpu.params_.items()})
    small = DataSet(lr_img[:2], hr_img[:2])
    cpu.fit(small)
    gpu.fit(small)
    lc, lg = cpu.score(), gpu.score()
    share, dmax = _share_close(
        torch, {f"{k}/{n}": gp for k, lp in gpu.params_.items()
                for n, gp in lp.items()},
        {f"{k}/{n}": cpu.params_[k][n] for k, lp in gpu.params_.items()
         for n in lp}, SRGAN_STEP_RTOL, SRGAN_STEP_ATOL)
    res["card_vs_cpu"] = dict(loss_rel=abs(lg - lc) / abs(lc),
                              max_abs=dmax, share=share)
    del cpu, gpu
    res["launches"] = counts
    rec["srgan_train"] = res
    cv = res["card_vs_cpu"]
    print(f"srgan_train: SRGAN {c['blocks']} blocks, {c['inputShape'][1]} "
          f"-> {c['inputShape'][1] * c['upscale']} ({res['params']:,} "
          f"params), {c['steps']} steps of batch {b} in {res['fit_s']:.2f} "
          f"s, loss {loss:.5f}; {ms:.1f} ms a step ({res['images_per_s']:.1f}"
          f" images/s), peak {res['peak_gb']:.2f} GB; discriminator "
          f"{res['disc_steps']} steps in {res['disc_s']:.2f} s, loss "
          f"{dloss:.3g}; zip bit-identical {res['zip_bit_identical']}, "
          f"PixelShuffleLayer in its JSON {res['json_has_pixel_shuffle']}; "
          f"card vs CPU at batch 2: loss {cv['loss_rel']:.2e} rel, params "
          f"max {cv['max_abs']:.2e} ({cv['share']:.4f} within rtol "
          f"{SRGAN_STEP_RTOL} + atol {SRGAN_STEP_ATOL}); "
          f"{card}")
    if prof["device_busy_ms"] is None:
        print(f"profile srgan_steps: no device time in the trace (not "
              f"measured); {card}")
    else:
        res["idle_share_unprofiled"] = 1 - prof["device_busy_ms"] / (
            c["profiled"] * ms)
        print(f"profile srgan_steps ({c['profiled']} steps): wall "
              f"{prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle share "
              f"{prof['idle_share']:.3f} "
              f"({res['idle_share_unprofiled']:.3f} unprofiled), "
              f"{prof['device_ops']} device kernels and copies; {card}")
        for kname, kms in prof["top"]:
            print(f"  {kms:9.3f} ms  {kname[:100]}")
    _no_launches(rec, "srgan_train", counts)
    _require(res["zip_bit_identical"] and res["json_has_pixel_shuffle"],
             "the generator's zip does not restore bit for bit")
    _require(cv["loss_rel"] <= SRGAN_STEP_RTOL and cv["share"] == 1.0,
             f"the card's step departs from the CPU's: {cv}")


class _OpRecorder:
    """A listener recording execDebug's per-op hooks."""

    def __init__(self):
        self.pre, self.post, self.passes = [], [], 0

    def preOpExecution(self, sd, at, op):
        self.pre.append(op.name)

    def opExecution(self, sd, at, op, outputs):
        self.post.append(op.name)

    def execDebugPassDone(self, sd, at):
        self.passes += 1


def phase_samediff_debug(torch, rec, card):
    """Item 63: execDebug on the card fires its listener once per op, in
    the staged (the reference's) order, and gives output()'s values;
    stepCostAnalysis of the char model's step; gradient checking in
    float64 on the card through forLoop and ifCond.  No launch."""
    import numpy as np

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.autodiff.gradcheck import check_gradients
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Adam
    c = SD_CHAR
    h = c["hidden"]
    sets, vocab, _ = _sd_char_sets(c, 1)
    x0, y0 = sets[0]
    nc = len(vocab)
    v = _sd_char_vars(nc, h, c["seed"])
    res = {}
    _reset_counters()
    sd = SameDiff.create()
    _sd_char_graph(sd, v, nc, h)
    recd = _OpRecorder()
    sd.setListeners(recd)
    feeds = {"x": x0, "y": y0}
    dbg = sd.execDebug(feeds, "loss")["loss"]
    order = [n.name for n in sd._needed_nodes(("loss",))]
    out = sd.output(feeds, "loss")["loss"]
    res["exec_debug"] = dict(ops=len(recd.pre), passes=recd.passes,
                             in_order=recd.pre == order == recd.post,
                             loss_diff=float((dbg - out).abs()))
    sd.setTrainingConfig(TrainingConfig(updater=Adam(c["lr"]),
                                        dataSetFeatureMapping=["x"],
                                        dataSetLabelMapping=["y"]))
    cost = sd.stepCostAnalysis(DataSet(x0, y0))
    t, b = c["length"], c["batch"]
    # three products (forward, the input's and the weight's gradients) of
    # each matmul: the two lstmLayers' gate products at every step and
    # the head
    products = 3 * 2 * t * b * (4 * h * (nc + h) + 4 * h * 2 * h + h * nc)
    res["step_cost"] = dict(cost, matmul_estimate=products)
    # gradient check in float64 on the card: a forLoop whose body
    # branches by ifCond
    g = SameDiff.create()
    xs, ws = g.placeholder("x"), g.placeholder("w")

    def step(s, lv):
        br = s.ifCond([lv[0], lv[1]], lambda q, u: u[0].mean().gt(0.0),
                      lambda q, u: [q.math().tanh(u[0] @ u[1])],
                      lambda q, u: [q.math().sin(u[0] @ u[1]) * 0.5])[0]
        return [br, lv[1]]
    name = g.forLoop(3, [xs, ws], step)[0].name()
    fn = g._build_fn((name,), compute_dtype=torch.float64)
    rng = np.random.RandomState(4)
    params = {"x": torch.tensor(rng.randn(3, 4), device=g.device),
              "w": torch.tensor(rng.randn(4, 4) * 0.5, device=g.device)}
    gc = check_gradients(lambda p: fn(p, {}, 0)[name].sum(), params)
    res["gradcheck"] = dict(passed=gc.passed, coords=gc.totalParams,
                            max_rel_error=gc.maxRelError)
    counts = _counters()
    res["launches"] = counts
    rec["samediff_debug"] = res
    ed = res["exec_debug"]
    print(f"samediff_debug: execDebug fired {ed['ops']} ops, "
          f"{ed['passes']} pass, in the staged order {ed['in_order']}, "
          f"loss {ed['loss_diff']:.1e} from output(); stepCostAnalysis of "
          f"the char model's step: {cost['flops']:.6g} FLOPs (the products' "
          f"count {products:.6g}), {cost['bytes']:.6g} bytes unfused; "
          f"gradcheck float64 on the card through forLoop + ifCond: "
          f"passed {gc.passed}, {gc.totalParams} coordinates, max rel "
          f"error {gc.maxRelError:.2e}; {card}")
    _no_launches(rec, "samediff_debug", counts)
    _require(ed["in_order"] and ed["passes"] == 1
             and ed["ops"] == len(order) and ed["loss_diff"] <= 1e-6,
             f"execDebug: {ed}")
    _require(abs(cost["flops"] - products) <= 0.05 * products,
             f"stepCostAnalysis: {cost['flops']} against {products}")
    _require(gc.passed, f"gradient check failed: {gc.failures[:3]}")


# ---------------------------------------------------------------------------
# training fault tolerance, its telemetry
# ---------------------------------------------------------------------------

def _fault_pool():
    """FAULT_RUN's seeded batches for the long-context net."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    c = LONG_CONTEXT
    rng = np.random.RandomState(1)
    return [DataSet(rng.randn(c["batch"], c["nIn"], c["t"]).astype(
        np.float32), rng.randn(c["batch"], c["nOut"], c["t"]).astype(
        np.float32)) for _ in range(FAULT_RUN["batches"])]


def _tree_gap(torch, a, b):
    """The largest |a - b| over two nested dicts of tensors."""
    if isinstance(a, dict):
        return max((_tree_gap(torch, a[k], b[k]) for k in a), default=0.0)
    return float((a.float() - b.float()).abs().max())


def phase_trainobs_start(torch, rec):
    """The telemetry the supervised runs report into: a federation run
    directory inside the checkout (fleet timelines, snapshots, the health
    event log), this process's SnapshotWriter beside a second host's, and
    one RunContext for every supervised run that follows."""
    import tempfile
    from deeplearning4j_tpu_torch.telemetry import (
        MetricsRegistry, RunContext, SnapshotWriter, set_federation_dir)
    d = tempfile.mkdtemp(dir=ROOT, prefix=".trainobs_")
    prev = set_federation_dir(d)
    local = SnapshotWriter(d, interval=0.5).start()
    peer_reg = MetricsRegistry()
    peer_reg.counter("dl4j_tpu_train_steps_total",
                     "Logical train steps dispatched").inc(
                         TRAINOBS["peer_steps"])
    peer = SnapshotWriter(d, hostId="peer-host", registry=peer_reg)
    peer.write_now()
    rc = RunContext.new()
    print(f"trainobs: federation dir {os.path.basename(d)}, run "
          f"{rc.runId}, host snapshots {local.hostId} and {peer.hostId}")
    return {"dir": d, "prev": prev, "local": local, "peer": peer,
            "run": rc}


def _trainobs_stop(obs):
    """Stop the snapshot writer, restore the federation setting and remove
    the run directory."""
    import shutil
    from deeplearning4j_tpu_torch.telemetry import set_federation_dir
    obs["local"].stop(finalWrite=False)
    set_federation_dir(obs["prev"])
    shutil.rmtree(obs["dir"], ignore_errors=True)


def phase_fault_tolerance(torch, rec, obs, card):
    """The four supervised runs of FAULT_RUN on the long-context net, each
    with the counters at 0 before and read after: B1, B2 and B3 must
    launch exactly twice for every step run (replays included, the step
    counter's delta giving the steps run)."""
    import math
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import (
        CorruptCheckpointAtStep, FaultTolerantTrainer, NaNAtStep,
        PreemptAtStep, SimulatedPreemption, inject)
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.telemetry import get_registry, run_scope
    f = FAULT_RUN
    pool = _fault_pool()
    root = os.path.join(obs["dir"], "ckpt")
    reg = get_registry()

    def steps_total():
        c = reg.get("dl4j_tpu_train_steps_total")
        return 0 if c is None else c.value()

    def hist(name):
        h = reg.get(name)
        return (0.0, 0) if h is None else (h.sum(), h.count())

    def trainer(net, name):
        return FaultTolerantTrainer(net, os.path.join(root, name),
                                    checkpointEveryN=f["every"],
                                    keepLast=10, durableExport=False)

    def run(name, want_steps, *legs):
        """Each leg: (faults, preempted?) on a fresh net and trainer over
        the same directory.  Returns the last net and trainer."""
        torch.cuda.synchronize()
        _reset_counters()
        s0 = steps_total()
        for faults, preempted in legs:
            net = MultiLayerNetwork(_long_context_conf("BFLOAT16")).init()
            _require(net.device.type == "cuda", f"net on {net.device}")
            t = trainer(net, name)
            with inject(*faults):
                try:
                    t.fit(ListDataSetIterator(pool), epochs=f["epochs"])
                    _require(not preempted, f"{name}: no preemption")
                except SimulatedPreemption:
                    _require(preempted, f"{name}: preempted unexpectedly")
        torch.cuda.synchronize()
        counts, ran = _counters(), int(steps_total() - s0)
        _require(ran == want_steps,
                 f"{name}: {ran} steps run, expected {want_steps}")
        _require(all(counts[k] == 2 * ran for k in FLASH)
                 and counts["matmul_bn_stats"] == 0,
                 f"{name}: expected {2 * ran} launches of B1, B2 and B3 "
                 f"({ran} steps run) and no B4, got {counts}")
        runs[name] = {"steps_run": ran, "launches": counts,
                      "stats": dict(t.stats), "loss": t.lastLoss,
                      "iteration": net.iterationCount}
        return net, t

    runs = {}
    t0 = time.perf_counter()
    with run_scope(obs["run"]):
        n_steps = f["epochs"] * f["batches"]
        base, tb = run("uninterrupted", n_steps, ((), False))
        _require(base.iterationCount == n_steps and
                 math.isfinite(tb.lastLoss), "uninterrupted run")
        # preempted before step 5: steps 0-4 ran; the resume restores the
        # step-4 checkpoint and runs 4-7
        res, tr = run("preempt_resume", f["preempt"] + n_steps - 4,
                      ((PreemptAtStep(f["preempt"]),), True), ((), False))
        _require(tr.stats["resumedFromStep"] == 4, f"resumed from "
                 f"{tr.stats['resumedFromStep']}, not 4")
        # NaN at step 3: steps 0-3 ran, 3 again after the rollback to
        # step 2, then epoch 1's 4
        nan, tn = run("nan_rollback", f["nan"] + 2 + f["batches"],
                      ((NaNAtStep(f["nan"]),), False))
        _require(tn.stats["rollbacks"] == 1 and
                 abs(nan.getLrScale() - 0.5) < 1e-12 and
                 math.isfinite(tn.lastLoss),
                 f"rollback: {tn.stats}, lrScale {nan.getLrScale()}, "
                 f"loss {tn.lastLoss}")
        # step 6's checkpoint corrupted, preempted before step 7: steps
        # 0-6 ran; the resume skips step 6 and runs 4-7 from step 4
        cor, tc = run("corrupt_fallback", f["corrupt_preempt"] + 4,
                      ((CorruptCheckpointAtStep(f["corrupt"]),
                        PreemptAtStep(f["corrupt_preempt"])), True),
                      ((), False))
        _require(tc.stats["resumedFromStep"] == 4,
                 f"corrupt fallback resumed from "
                 f"{tc.stats['resumedFromStep']}, not 4")
    wall = time.perf_counter() - t0
    equal = {}
    for name, net in (("preempt_resume", res), ("corrupt_fallback", cor)):
        same = _trees_equal(torch, net.params_, base.params_) and \
            _trees_equal(torch, net.optState_, base.optState_)
        gap = 0.0 if same else max(
            _tree_gap(torch, net.params_, base.params_),
            _tree_gap(torch, net.optState_, base.optState_))
        equal[name] = {"bit_equal": same, "max_gap": gap}
        if not same:
            print(f"fault_tolerance: {name}'s params differ from the "
                  f"uninterrupted run's by up to {gap:.3g}")
        _require(same or gap <= FAULT_RESUME_ATOL,
                 f"{name}: params {gap:.3g} from the uninterrupted run's")
    save_s, saves = hist("dl4j_tpu_step_checkpoint_seconds")
    rest_s, restores = hist("dl4j_tpu_fault_restore_seconds")
    step_dir = os.path.join(root, "uninterrupted",
                            str(f["epochs"] * f["batches"]))
    mb = sum(os.path.getsize(os.path.join(step_dir, n))
             for n in os.listdir(step_dir)) / 1e6
    rec["fault_tolerance"] = out = {
        "runs": runs, "resume_equal": equal, "wall_s": wall,
        "save_ms": 1e3 * save_s / max(saves, 1), "saves": saves,
        "restore_ms": 1e3 * rest_s / max(restores, 1),
        "restores": restores, "checkpoint_mb": mb, "card": card}
    rec["launches_fault"] = {k: sum(r["launches"][k] for r in runs.values())
                             for k in runs["uninterrupted"]["launches"]}
    print(f"fault_tolerance: {sum(r['steps_run'] for r in runs.values())} "
          f"supervised steps in {wall:.2f} s; resume bit-equal "
          f"{ {k: v['bit_equal'] for k, v in equal.items()} }; checkpoint "
          f"{mb:.3f} MB, save {out['save_ms']:.2f} ms ({saves}), restore "
          f"{out['restore_ms']:.2f} ms ({restores}); rollback lrScale "
          f"{nan.getLrScale()}; launches {rec['launches_fault']}; {card}")


def phase_fault_oom(torch, rec, obs, card):
    """ResNet-50 under the supervisor at a batch the card cannot hold: a
    real CUDA OOM, retried as micro-batches, then a batch-64 step."""
    import math
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import FaultTolerantTrainer
    from deeplearning4j_tpu_torch.telemetry import get_registry, run_scope
    from deeplearning4j_tpu_torch.zoo import ResNet50
    c, o = RESNET, FAULT_OOM
    net = ResNet50(numClasses=c["numClasses"], inputShape=c["inputShape"],
                   dataType="BFLOAT16").init()
    rng = np.random.RandomState(3)

    def batch(n):
        x = rng.randn(n, *c["inputShape"]).astype(np.float32)
        y = np.eye(c["numClasses"], dtype=np.float32)[
            rng.randint(0, c["numClasses"], n)]
        return DataSet(x, y)

    big, small = batch(o["batch"]), batch(o["after"])
    reg = get_registry()

    def retries():
        m = reg.get("dl4j_tpu_fault_oom_retries_total")
        return 0 if m is None else m.value()

    def hist(name):
        h = reg.get(name)
        return (0.0, 0) if h is None else (h.sum(), h.count())

    save0, rest0 = hist("dl4j_tpu_step_checkpoint_seconds"), \
        hist("dl4j_tpu_fault_restore_seconds")

    t = FaultTolerantTrainer(net, os.path.join(obs["dir"], "oom"),
                             checkpointEveryN=1000, keepLast=2,
                             maxMicroBatchSplits=o["splits"],
                             durableExport=False)
    torch.cuda.synchronize()
    _reset_counters()
    r0 = retries()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with run_scope(obs["run"]):
        t.fit(ListDataSetIterator([big]), epochs=1)
        torch.cuda.synchronize()
        oom_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        splits, micro = t.stats["oomSplits"], net.lastBatchSize
        it1, loss1 = net.iterationCount, t.lastLoss
        counted = retries() - r0
        t.fit(ListDataSetIterator([small]), epochs=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated()
    counts = _counters()
    depth = int(round(math.log2(o["batch"] / micro)))
    save1, rest1 = hist("dl4j_tpu_step_checkpoint_seconds"), \
        hist("dl4j_tpu_fault_restore_seconds")
    step_dir = t.ckpt.stepPath(t.ckpt.latestStep())
    mb = sum(os.path.getsize(os.path.join(step_dir, n))
             for n in os.listdir(step_dir)) / 1e6
    save_ms = 1e3 * (save1[0] - save0[0]) / max(save1[1] - save0[1], 1)
    rest_ms = 1e3 * (rest1[0] - rest0[0]) / max(rest1[1] - rest0[1], 1)
    rec["fault_oom"] = {"batch": o["batch"], "splits": splits,
                        "depth": depth, "micro_batch": micro,
                        "oom_step_s": oom_s, "wall_s": wall,
                        "peak_bytes": peak, "mem_before": mem0,
                        "mem_after": mem1, "loss": loss1,
                        "checkpoint_mb": mb, "save_ms": save_ms,
                        "restore_ms": rest_ms, "card": card}
    print(f"fault_oom: batch {o['batch']} -> {splits} OOM split(s), depth "
          f"{depth} (micro-batches of {micro}), the step {oom_s:.2f} s, "
          f"peak {peak / 1e9:.2f} GB, loss {loss1:.6g}; then batch "
          f"{o['after']}: {t.stats['oomSplits'] - splits} more splits; "
          f"allocated {mem0 / 1e9:.3f} -> {mem1 / 1e9:.3f} GB; checkpoint "
          f"{mb:.1f} MB, save {save_ms:.1f} ms, restore {rest_ms:.1f} ms; "
          f"phase {wall:.2f} s; {card}")
    _no_launches(rec, "fault_oom", counts)
    _require(splits >= 1, "batch 512 did not run out of memory")
    _require(counted == splits, f"dl4j_tpu_fault_oom_retries_total rose "
             f"{counted}, the supervisor split {splits} times")
    _require(it1 == 1, f"iterationCount {it1} after the split step")
    _require(loss1 is not None and math.isfinite(loss1), f"loss {loss1}")
    _require(net.iterationCount == 2 and t.stats["oomSplits"] == splits,
             f"the batch-{o['after']} step: iteration "
             f"{net.iterationCount}, splits {t.stats['oomSplits']}")
    _require(math.isfinite(t.lastLoss), f"batch-{o['after']} loss "
             f"{t.lastLoss}")
    _require(abs(mem1 - mem0) <= o["mem_slack"],
             f"allocated memory {mem0} before the failed step, {mem1} after")


def _otlp_collector():
    """An OTLP/HTTP JSON collector on 127.0.0.1 (an ephemeral port) that
    keeps every POST body by path."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    got = {}

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.setdefault(self.path, []).append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, got


def phase_trainobs(torch, rec, obs, card):
    """The runs' telemetry: the watchdog's stall rule on a stalled
    supervised run, the timeline and federated metrics served by an
    InferenceServer, and OTLP spans and metrics at a local collector."""
    import urllib.error
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import (FaultTolerantTrainer,
                                                StallAtStep, inject)
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.remote import (BucketLadder,
                                                 ForwardServing,
                                                 InferenceServer,
                                                 ModelRegistry)
    from deeplearning4j_tpu_torch.telemetry import (
        HealthMonitor, default_rules, get_registry, otlp_exporter,
        run_scope, set_otlp_exporter)
    o, rc = TRAINOBS, obs["run"]
    reg = get_registry()
    # the watchdog: default_rules with a short stall timeout, through the
    # supervisor (which starts and stops the monitor it is given)
    mon = HealthMonitor(default_rules(stallTimeout=o["stall_timeout"]),
                        interval=o["monitor_interval"])
    net = MultiLayerNetwork(_long_context_conf("BFLOAT16")).init()
    torch.cuda.synchronize()
    _reset_counters()
    with run_scope(rc), inject(StallAtStep(o["stall_step"], o["stall_s"])):
        FaultTolerantTrainer(net, os.path.join(obs["dir"], "stall"),
                             checkpointEveryN=FAULT_RUN["every"],
                             healthMonitor=mon, durableExport=False).fit(
            ListDataSetIterator(_fault_pool()), epochs=1)
    torch.cuda.synchronize()
    counts = _counters()
    steps = FAULT_RUN["batches"]
    _require(all(counts[k] == 2 * steps for k in FLASH),
             f"the stalled run: {counts}, expected {2 * steps} each")
    for k in FLASH:
        rec["launches_fault"][k] += counts[k]
    fired = reg.get("dl4j_tpu_health_alert_transitions_total")
    fired = 0 if fired is None else fired.value(rule="training_stall",
                                                state="firing")
    with open(mon.eventLogPath) as fh:
        lines = [json.loads(line) for line in fh]
    stall = [e for e in lines if e["rule"] == "training_stall"
             and e["state"] == "firing"]
    _require(fired >= 1 and stall,
             f"TrainingStallRule did not fire on a {o['stall_s']} s stall "
             f"(transitions {fired}, event lines {stall})")
    obs["local"].write_now()
    # the collector, and a server whose start brings up the exporter
    httpd, th, got = _otlp_collector()
    os.environ["DL4J_TPU_OTLP_ENDPOINT"] = \
        f"http://127.0.0.1:{httpd.server_address[1]}"
    os.environ["DL4J_TPU_OTLP_INTERVAL"] = "0.5"
    lenet = MultiLayerNetwork(_lenet_conf()).init()
    registry = ModelRegistry()
    registry.register("classifier", ForwardServing(
        lenet, BucketLadder(batchSizes=(1,), seqLens=()),
        inputShape=(784,)))
    server = InferenceServer(registry, port=0).start()
    try:
        exp = otlp_exporter()
        _require(exp is not None and exp.endpoint.endswith(
            str(httpd.server_address[1])), "no OTLP exporter started")
        exp.export_now()
        status, body = _get(server.port, f"/v1/runs/{rc.runId}/timeline")
        doc = json.loads(body)
        events = doc["events"]
        kinds = [e["kind"] for e in events]
        hlc = [tuple(e["hlc"]) for e in events]
        fed_status, fed = _get(server.port, "/metrics/federated")
        fed = fed.decode()
        try:
            _get(server.port, "/v1/runs/no-such-run/timeline")
            unknown = 200
        except urllib.error.HTTPError as e:
            unknown = e.code
    finally:
        server.stop()
        exp = set_otlp_exporter(None)
        if exp is not None:
            exp.stop()
        os.environ.pop("DL4J_TPU_OTLP_ENDPOINT", None)
        os.environ.pop("DL4J_TPU_OTLP_INTERVAL", None)
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=5)
    # the timeline: every run's events in hybrid-logical-clock order
    _require(status == 200 and doc["count"] == len(events) and
             hlc == sorted(hlc), f"timeline {status}, HLC order "
             f"{hlc == sorted(hlc)}")
    want = {"checkpoint": "ckpt.seal" in kinds and "ckpt.save" in kinds,
            "preempt": any(e["kind"] == "run.end" and
                           e.get("reason") == "SimulatedPreemption"
                           for e in events),
            "resume": "ckpt.restore" in kinds,
            "rollback": "ckpt.rollback" in kinds,
            "oom_retry": any(e["kind"] == "train.step" and
                             e.get("oom_split") for e in events)}
    _require(all(want.values()), f"timeline lacks {want}")
    _require(unknown == 404, f"an unknown run id answered {unknown}")
    # federated: this host's live registry plus the peer's snapshot
    local_steps = reg.get("dl4j_tpu_train_steps_total").value()
    fed_steps = _exposed(fed, "dl4j_tpu_train_steps_total")
    _require(fed_status == 200 and fed_steps is not None and
             abs(fed_steps - (local_steps + o["peer_steps"])) < 1e-9,
             f"/metrics/federated steps {fed_steps}, local {local_steps} "
             f"+ peer {o['peer_steps']}")
    # OTLP: spans of the run's trace, metrics with the supervisor's series
    spans = [sp for p in got.get("/v1/traces", [])
             for rs in p["resourceSpans"] for ss in rs["scopeSpans"]
             for sp in ss["spans"]]
    names = {m["name"] for p in got.get("/v1/metrics", [])
             for rm in p["resourceMetrics"] for sm in rm["scopeMetrics"]
             for m in sm["metrics"]}
    run_spans = sorted({sp["name"] for sp in spans
                        if sp["traceId"] == rc.runId})
    _require({"step", "checkpoint", "checkpoint_restore",
              "recovery"} <= set(run_spans),
             f"OTLP spans of run {rc.runId}: {run_spans}")
    _require({"dl4j_tpu_fault_checkpoints_total",
              "dl4j_tpu_fault_nan_rollbacks_total",
              "dl4j_tpu_fault_oom_retries_total",
              "dl4j_tpu_train_steps_total"} <= names,
             f"OTLP metrics lack the supervisor's series: {sorted(names)}")
    rec["trainobs"] = {"timeline_events": len(events),
                       "timeline_kinds": sorted(set(kinds)),
                       "federated_steps": fed_steps,
                       "otlp_spans": len(spans),
                       "otlp_run_spans": run_spans,
                       "otlp_metrics": len(names),
                       "stall_firings": fired, "card": card}
    print(f"trainobs: timeline of run {rc.runId}: {len(events)} events "
          f"({', '.join(sorted(set(kinds)))}) in HLC order; federated "
          f"steps {fed_steps:g} = {local_steps:g} + {o['peer_steps']}; "
          f"OTLP {len(spans)} spans ({len(run_spans)} names on the run's "
          f"trace), {len(names)} metrics; training_stall fired "
          f"{fired:g}x on a {o['stall_s']} s stall; {card}")


def _kernel_entry(name, replaces, launches, t):
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main(argv) -> int:
    record = argv[argv.index("--record") + 1] if "--record" in argv \
        else None
    # a fatal signal (a fault in native code on any thread) prints every
    # thread's Python stack to stderr before the process dies
    faulthandler.enable(all_threads=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{card}")

    rec, failed = {}, []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            rec.setdefault("phase_s", {})[name] = time.perf_counter() - t0
            return out
        except Exception:           # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            return None

    run("build", phase_build, rec)
    if not failed:
        run("sass", phase_sass, rec)
        run("kernels", phase_kernels, torch, rec)
        run("bwd_kernels", phase_bwd_kernels, torch, rec)
        run("grad", phase_grad, torch, rec)
        run("c6", phase_c6, torch, rec)
        model = run("model_init", _gpt2_model, torch)
        if model is not None:
            res = run("main_path", phase_main_path, torch, rec, *model)
            if res is not None:
                run("outputs", phase_outputs, torch, rec, *model, *res)
            run("timing", phase_timing, torch, rec, *model)
            run("profile", phase_profile, torch, rec, *model)
        del model
        train = run("train_init", _train_model, torch)
        if train is not None:
            net, params0, pool = train
            run("train_path", phase_train, torch, rec, *train)
            run("train_outputs", phase_train_outputs, torch, rec, params0,
                pool)
            run("train_timing", phase_train_timing, torch, rec, net, pool)
            run("train_profile", phase_train_profile, torch, rec, net, pool)
        del train
        run("b4_kernels", phase_b4_kernels, torch, rec)
        resnet = run("resnet_init", _resnet_model, torch)
        if resnet is not None:
            net, params0, pool = resnet
            run("resnet_train", phase_resnet_train, torch, rec, *resnet)
            gnet = run("resnet_step", phase_resnet_step, torch, rec, params0,
                       pool)
            if gnet is not None:
                run("b4_activations", phase_b4_activations, torch, rec, gnet,
                    pool)
            del gnet
            run("resnet_timing", phase_resnet_timing, torch, rec, net, pool)
            # phases 26 and 28 reuse this net: it waits on the host, so
            # the memory peaks of phases 14-23 read as before
            resnet = (_park(net, "cpu"), pool)
        rnn = run("rnn_init", _char_rnn_model, torch)
        if rnn is not None:
            net, params0, it = rnn
            run("rnn_train", phase_rnn_train, torch, rec, *rnn)
            run("rnn_step", phase_rnn_step, torch, rec, params0, it)
            run("rnn_timestep", phase_rnn_timestep, torch, rec, net, it)
            run("rnn_graph", phase_rnn_graph, torch, rec, params0, it)
            run("rnn_timing", phase_rnn_timing, torch, rec, net, it, card)
        del rnn
        bert = run("bert_init", _bert_model, torch)
        if bert is not None:
            run("bert_train", phase_bert_train, torch, rec, *bert, card)
            run("bert_timing", phase_bert_timing, torch, rec, *bert, card)
        del bert
        pair = run("bert_output", phase_bert_output, torch, rec, card)
        if pair is not None:
            run("bert_step", phase_bert_step, torch, rec, *pair, card)
        del pair
        run("bert_iterator", phase_bert_iterator, torch, rec, card)
        # the training user's loop around fit; the serializer and
        # evaluate phases reuse the ResNet-50 the resnet phases trained
        lenet = run("lenet_mnist", phase_lenet_mnist, torch, rec, card)
        if resnet is not None:
            _park(resnet[0], "cuda")
        if lenet is not None:
            net, train, test = lenet
            run("listeners", phase_listeners, torch, rec, net, train, card)
            if resnet is not None:
                run("serializer", phase_serializer, torch, rec, net, train,
                    test, resnet, card)
            run("early_stopping", phase_early_stopping, torch, rec, train,
                test, card)
            if resnet is not None:
                run("solvers_transfer", phase_solvers_transfer, torch, rec,
                    net, train, resnet, card)
        del lenet, resnet
        # BASELINE config 3's named route: BERT-base through TF import
        dec = run("tf_decode", phase_tf_decode, torch, rec, card)
        if dec is not None:
            gd, manifest = dec
            imp = run("tf_import_bert", phase_tf_import_bert, torch, rec,
                      gd, manifest, card)
            if imp is not None:
                gpu, cpu, out_ref = imp
                imp = None
                run("tf_finetune", phase_tf_finetune, torch, rec, gd, gpu,
                    cpu, card)
                del gpu, cpu
                run("tf_graphrunner", phase_tf_graphrunner, torch, rec, gd,
                    out_ref, card)
        del dec
        # the serving tier: one server, three routes, then a replica set
        serve = run("serve_start", phase_serve_start, torch, rec, card)
        if serve is not None:
            try:
                req = run("serve_requests", phase_serve_requests, torch, rec,
                          serve, card)
                if req is not None:
                    run("serve_check", phase_serve_check, torch, rec, serve,
                        req, card)
                run("serve_replicas", phase_serve_replicas, torch, rec,
                    serve, card)
                run("serve_timing", phase_serve_timing, torch, rec, serve,
                    card)
            finally:
                serve["server"].stop()
        del serve
        # BASELINE config 3's model through the ONNX route
        run("onnx_fixtures", phase_onnx_fixtures, torch, rec, card)
        dec = run("onnx_decode", phase_onnx_decode, torch, rec, card)
        if dec is not None:
            imp = run("onnx_import_bert", phase_onnx_import_bert, torch, rec,
                      *dec, card)
            if imp is not None:
                gpu, cpu, ins, out = imp
                imp = None
                run("onnx_finetune", phase_onnx_finetune, torch, rec, gpu,
                    cpu, ins, out, card)
                del gpu, cpu
        del dec
        # the zoo: YOLO2 trains, restores through initPretrained and
        # fine-tunes; every other zoo model steps once
        yolo = run("yolo2_init", _yolo2_model, torch)
        if yolo is not None:
            net, params0, pool = yolo
            tuned = run("yolo2_train", phase_yolo2_train, torch, rec, net,
                        params0, pool, card)
            run("yolo2_step", phase_yolo2_step, torch, rec, params0, pool)
            run("yolo2_transfer", phase_yolo2_transfer, torch, rec, net,
                pool, card)
            if tuned is not None:
                run("yolo2_timing", phase_yolo2_timing, torch, rec, tuned,
                    pool, card)
            del net, tuned
        del yolo
        run("zoo_sweep", phase_zoo_sweep, torch, rec, card)
        # Keras import: the reader, the long-context transformer (B1-B3),
        # ResNet-50 at full width, a .keras archive; then pretrain and the
        # other A7 layers
        run("keras_hdf5", phase_keras_hdf5, torch, rec, card)
        run("keras_attention", phase_keras_attention, torch, rec, card)
        run("keras_resnet50", phase_keras_resnet50, torch, rec, card)
        run("keras_v3", phase_keras_v3, torch, rec, card)
        run("vae_pretrain", phase_vae_pretrain, torch, rec, card)
        run("attention_layers", phase_attention_layers, torch, rec, card)
        # DataVec: the tensor layer, the CSV route, the image pipeline into
        # ResNet-50 through the pool and the pinned ring, sequences into
        # the long-context net
        run("nd4j", phase_nd4j, torch, rec, card)
        run("etl_csv", phase_etl_csv, torch, rec, card)
        run("etl_images_resnet50", phase_etl_images_resnet50, torch, rec,
            card)
        run("etl_sequences", phase_etl_sequences, torch, rec, card)
        # DataVec's format readers, then the recommender tier: DLRM trains
        # from a ragged stream, two-tower top-k is served by the batcher
        run("datavec_formats", phase_datavec_formats, torch, rec, card)
        run("dlrm_train", phase_dlrm_train, torch, rec, card)
        run("retrieval_serve", phase_retrieval_serve, torch, rec, card)
        # SameDiff finished: the 240 ops on the card, the char model with
        # control flow (Path 2), SRGAN at SRResNet's widths (Path 1), then
        # execDebug, stepCostAnalysis and gradient checking
        run("samediff_ops", phase_samediff_ops, torch, rec, card)
        run("samediff_control_flow", phase_samediff_control_flow, torch,
            rec, card)
        run("srgan_train", phase_srgan_train, torch, rec, card)
        run("samediff_debug", phase_samediff_debug, torch, rec, card)
        # training fault tolerance on the long-context net (B1-B3) and a
        # real OOM on ResNet-50, reported through the run log, federation
        # and OTLP
        obs = run("trainobs_start", phase_trainobs_start, torch, rec)
        if obs is not None:
            try:
                run("fault_tolerance", phase_fault_tolerance, torch, rec,
                    obs, card)
                run("fault_oom", phase_fault_oom, torch, rec, obs, card)
                if "launches_fault" in rec:
                    run("trainobs", phase_trainobs, torch, rec, obs, card)
                else:
                    failed.append("trainobs")
            finally:
                _trainobs_stop(obs)

    rec["card"] = card
    rec["failed"] = failed
    if record:
        os.makedirs(os.path.dirname(os.path.abspath(record)), exist_ok=True)
        with open(record, "w") as f:
            json.dump(rec, f, indent=1)
    if card is None:
        failed.append("nvidia-smi")
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1

    # launches: the serving run's and the training run's counts together
    # (B1 runs on both paths; B2 and B3 on the training path only), the
    # imported Keras transformer's forward and fit (B1-B3) and the
    # recurrent attention layer's at t 1024 (B1), and B4's from its run on
    # ResNet-50's activations (the model dispatches none); the phases
    # without a hand kernel on their path (recurrent, BERT, the loop around
    # fit, TF import, serving tier, ONNX import, the zoo, the HDF5 reader,
    # the imported ResNet-50 and .keras archive, pretrain, DataVec, the
    # recommender tier) add none (each checked zero).
    # B1's times are at the serving shape (f32, causal), B2's and B3's at
    # the training shape in its dtype (bf16, not causal), B4's at ResNet-50's
    # stage-0 shape in bf16; the record holds the other shapes too.
    serve, train_t = rec["launches"], rec["train_kernel_timing"]
    launches = {k: serve[k] + rec["launches_train"][k]
                + rec["launches_resnet"][k] + rec["launches_b4"][k]
                + rec["launches_keras"][k]
                + rec["launches_attention_layers"][k]
                + rec["launches_fault"][k]
                + sum(c[k] for c in rec["launches_no_kernel_phases"].values())
                for k in serve}
    m, k, n = B4_RESNET_SHAPES[0]
    kernels_line = {"kernels": [
        _kernel_entry("flash_attn_fwd",
                      "deeplearning4j_tpu/parallel/ring.py:127",
                      launches["flash_attn_fwd"], rec["flash_timing"]),
        _kernel_entry("flash_attn_bwd_dq",
                      "deeplearning4j_tpu/parallel/ring.py:188",
                      launches["flash_attn_bwd_dq"],
                      train_t["flash_attn_bwd_dq"]["bfloat16"]),
        _kernel_entry("flash_attn_bwd_dkv",
                      "deeplearning4j_tpu/parallel/ring.py:228",
                      launches["flash_attn_bwd_dkv"],
                      train_t["flash_attn_bwd_dkv"]["bfloat16"]),
        _kernel_entry("matmul_bn_stats",
                      "deeplearning4j_tpu/ops/pallas_fused.py:61",
                      launches["matmul_bn_stats"],
                      rec["b4_timing"][f"{m}x{k}x{n} bfloat16"])]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
